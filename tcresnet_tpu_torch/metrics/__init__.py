"""Metrics of the port (numpy only)."""
