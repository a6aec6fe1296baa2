"""Filter windows (host-side NumPy)."""
