"""Utilities of the port: device-side metrics."""
