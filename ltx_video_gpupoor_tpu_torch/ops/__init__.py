"""Tensor ops: norms, RoPE, attention (kernel K1), dynamic int8 (kernel K2)."""
