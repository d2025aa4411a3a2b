"""Device selection and float32 precision for the port's entry points."""

from __future__ import annotations

from contextlib import contextmanager

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and absent.

    Entry points default to ``"cuda"``.  A caller that wants the CPU (the
    tests do) says ``device="cpu"``: the port never drops to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@contextmanager
def precision_scope(compute_dtype: torch.dtype):
    """No TF32 inside the block when ``compute_dtype`` is float32.

    The JAX package runs its float32 model at ``precision="highest"``; torch
    lets cuDNN convolutions (and, where enabled, matmuls) round their inputs
    to TF32 on a card.  For float32 this turns
    ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` off and restores both on exit;
    other dtypes leave them as they are.
    """
    if compute_dtype != torch.float32:
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
