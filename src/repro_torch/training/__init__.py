"""Training-side state of the port (init only in this slice)."""
