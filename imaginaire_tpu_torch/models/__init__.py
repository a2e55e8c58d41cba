"""Generators and (later) discriminators of the port."""
