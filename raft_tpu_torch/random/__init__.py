"""Random state."""
