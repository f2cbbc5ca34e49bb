"""Sequence-parallel attention of the port."""
