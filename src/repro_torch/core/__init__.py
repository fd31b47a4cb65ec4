"""Copies of the reference's JAX-free tree format (core/tree.py) and
packed-row packing (core/packing.py)."""
