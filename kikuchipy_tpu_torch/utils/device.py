"""Where the port's entry points run.

Entry points take ``device=None``, which means the card
(``torch.device("cuda")``). Without a card they raise unless the caller
asked for the CPU explicitly; there is no silent fallback.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "matmul_precision"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kikuchipy_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU"
        )
    return dev


def as_tensor(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` (array-like or tensor) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    arr = np.asarray(x)
    if not arr.flags.writeable:  # torch shares memory and may write
        arr = arr.copy()
    return torch.as_tensor(arr, device=device, dtype=dtype)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Run float32 matrix products and convolutions on the card in TF32
    (``tf32=True``) or IEEE float32 inside the block, and restore the
    global flags after it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

