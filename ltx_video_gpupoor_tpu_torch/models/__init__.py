"""Models: the LTX DiT and VAE, the T5 text encoder."""
