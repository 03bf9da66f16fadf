"""Configs and the JAX-parameter converter."""
