"""Serving launcher of the port."""
