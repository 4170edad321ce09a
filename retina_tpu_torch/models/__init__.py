"""The fused per-batch pipeline and the identity join."""
