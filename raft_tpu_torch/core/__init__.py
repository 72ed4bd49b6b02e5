"""Core utilities: errors, sentinels and the device handle."""
