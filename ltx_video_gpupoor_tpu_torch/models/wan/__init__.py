"""Wan 2.1 models: the DiT and the VAE decoder."""
