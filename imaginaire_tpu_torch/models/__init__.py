"""Generators and discriminators of the port."""
