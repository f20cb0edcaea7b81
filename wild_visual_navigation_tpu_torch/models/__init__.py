"""Backbone and head modules of the port."""
