"""Config-driven helpers of the port."""
