"""Serving entry points."""
