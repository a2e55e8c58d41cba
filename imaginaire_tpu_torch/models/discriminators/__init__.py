"""Discriminators of the port."""
