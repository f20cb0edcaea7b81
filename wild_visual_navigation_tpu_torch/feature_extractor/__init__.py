"""Dense-feature interfaces of the port."""
