"""Trainers of the port (serving halves in this slice)."""
