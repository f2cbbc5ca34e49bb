"""LTX-Video: patchifier, Transformer3D, causal VAE decoder."""
