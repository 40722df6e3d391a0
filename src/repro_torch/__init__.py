"""PyTorch/CUDA port of the count-sketch optimizer system, for one H100.

Mirrors the module layout of the JAX package ``repro`` (the reference),
imports neither it nor ``jax``, and runs its hot path through CUDA kernels
written for Hopper (``repro_torch/kernels/csrc``).  Entry points take
``device=`` and default to ``"cuda"``; the CPU runs only when a caller
asks for it.
"""
