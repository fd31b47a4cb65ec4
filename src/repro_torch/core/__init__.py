"""Copies of the reference's JAX-free tree format (core/tree.py)."""
