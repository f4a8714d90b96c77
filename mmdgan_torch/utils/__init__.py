"""Helpers around the port: the JAX parameter bridge."""
