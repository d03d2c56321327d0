"""PyTorch/CUDA port of diff_unet_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths and class names. It imports torch
and numpy only (never jax, flax, optax or diff_unet_tpu); the CUDA kernels
in ``csrc/`` are built at their first CUDA call (``ops/_native.py``).
"""
