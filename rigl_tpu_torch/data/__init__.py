"""Dataset loaders of the port (numpy only)."""
