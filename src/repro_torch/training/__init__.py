"""Training step of the port."""
