"""Serving on the port."""
