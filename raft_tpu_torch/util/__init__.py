"""Small host-side helpers."""
