"""Flow-event schema and synthetic traffic."""
