"""Configuration dataclasses of the port."""
