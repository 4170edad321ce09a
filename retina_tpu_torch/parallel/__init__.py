"""Single-card telemetry (step, window close, snapshot) and the feed path's
host side: combining, partitioning, the flow dictionary and the wire."""
