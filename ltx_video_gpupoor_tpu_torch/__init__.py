"""PyTorch / CUDA port of ``ltx_video_gpupoor_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here names
its JAX counterpart by file and function, and ``tests/test_torch_*.py``
hold each one against it on the CPU. This package never imports ``jax``.

Kernels written by hand for ``sm_90a`` live in ``csrc/``; they are built at
first use (``ops/_lib.py``) and reached only through wrappers that take the
plain PyTorch version for CPU tensors and launch the kernel (or raise) for
CUDA tensors.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
