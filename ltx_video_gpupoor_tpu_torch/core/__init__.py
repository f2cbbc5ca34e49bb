"""Shared foundations: dtype policy and the JAX weight converter."""
