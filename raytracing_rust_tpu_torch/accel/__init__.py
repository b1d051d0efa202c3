"""Acceleration structures of the general tier."""
