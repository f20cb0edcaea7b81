"""Confidence, parameter bridge and operation modes of the port."""
