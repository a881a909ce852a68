"""Synthetic token pipeline of the port (numpy only)."""
