"""Where the port's entry points run.

Entry points take ``device=None``, which means the card
(``torch.device("cuda")``). Without a card they raise unless the caller
asked for the CPU explicitly; there is no silent fallback.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "constant_tensor", "host_array", "matmul_precision"]


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


def host_array(x) -> np.ndarray:
    """``x`` (tensor or array-like) as a NumPy array on the host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# constant_tensor's copies: (id, shape, dtype, device, dtype) -> (the array's
# bytes when copied, the copy), the most recent last.
_CONSTANTS: OrderedDict = OrderedDict()
_CONSTANTS_KEPT = 16


def constant_tensor(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` as a tensor on ``device`` for an operation to read (never to
    write): a NumPy array is copied once and the copy reused while the
    array's bytes stay the same (they are compared on every call, so an
    array changed in place is copied again); a tensor is
    :func:`as_tensor`'s. Spares the per-call host-to-device copy of a
    background or filter operator, which waits for the stream."""
    if isinstance(x, torch.Tensor):
        return as_tensor(x, device, dtype)
    arr = np.asarray(x)
    key = (id(x), arr.shape, arr.dtype.str, str(device), dtype)
    data = arr.tobytes()
    hit = _CONSTANTS.get(key)
    if hit is not None and hit[0] == data:
        _CONSTANTS.move_to_end(key)
        return hit[1]
    copy = torch.as_tensor(arr.copy(), device=device, dtype=dtype)
    _CONSTANTS[key] = (data, copy)
    _CONSTANTS.move_to_end(key)
    while len(_CONSTANTS) > _CONSTANTS_KEPT:
        _CONSTANTS.popitem(last=False)
    return copy


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

