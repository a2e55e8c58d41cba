"""Optimizers, lr policies and rematerialization of the port."""
