"""Sketch operators: hashing, Count-Min, top-k, HyperLogLog, entropy, conntrack state."""
