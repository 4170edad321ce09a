"""Single-card telemetry: step, window close and the scrape snapshot."""
