"""Per-frame inference of the port."""
