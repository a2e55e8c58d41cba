"""Model utilities of the port."""
