"""Utilities of the port: test images (``images``)."""
