"""PyTorch/CUDA port of the communication-efficient training runtime.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``models``, ``core``, ``kernels``, ``train``, ...) and
never imports it or ``jax``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.  The kernels of the slice (``kernels/csrc``) are
CUDA C++ for Hopper, built with ``nvcc`` at first use.
"""
