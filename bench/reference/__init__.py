"""Plain PyTorch references that decide ``correct``.

They import neither ``jax``, nor the JAX package ``repro``, nor the port
``repro_torch``: where they need the port's hash arithmetic they use the
frozen copy in ``reference.hashing``.  They run in float32 with TF32 off
(``f32_matmuls``), on whatever device their inputs are on.
"""
import contextlib

import torch


@contextlib.contextmanager
def f32_matmuls():
    """Float32 products in full float32: TF32 off for matmul and cuDNN,
    restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])
