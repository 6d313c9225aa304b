"""Training runtime of the port (one device)."""
