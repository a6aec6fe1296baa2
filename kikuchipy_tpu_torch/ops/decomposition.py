"""Pattern decomposition (PCA) and model reconstruction.

PyTorch counterpart of ``kikuchipy_tpu/ops/decomposition.py``: PCA by the
economy SVD of the centered pattern matrix on the device (cuSOLVER on the
card, LAPACK on the CPU), low-rank reconstruction as one IEEE float32
product, and a per-pattern rescale to an integer storage dtype. Both
functions return NumPy arrays, as JAX's do.

Singular vectors are unique only up to the sign of each pair, so the
factors and loadings may differ from another implementation's by one sign
a component; the reconstruction does not.
"""

from __future__ import annotations

import numpy as np
import torch

from kikuchipy_tpu_torch.utils.device import as_tensor, matmul_precision, resolve_device
from kikuchipy_tpu_torch.utils.dtypes import get_dtype_range, torch_dtype

__all__ = ["pca", "pca_reconstruct"]

# cuSOLVER's method for the SVD on the card (``torch.linalg.svd``'s
# ``driver``), chosen by its time on the main path's 16,384 x 3600 float32
# matrix and its agreement with a float64 SVD there (chip_smoke.py
# ``[decomposition]``, PERF.md): gesvda 108.5 ms, its ratios 2.2e-09 off
# float64's; gesvd 1,135.6 ms, 1.2e-07; gesvdj 944.6 ms, factors orthonormal
# only to 1.1e-03. The CPU takes LAPACK's, which has no choice.
SVD_DRIVER = "gesvda"


def _svd(x: torch.Tensor):
    """Economy SVD ``(u, s, vt)`` of ``x``, by :data:`SVD_DRIVER` on the
    card."""
    if x.is_cuda:
        return torch.linalg.svd(x, full_matrices=False, driver=SVD_DRIVER)
    return torch.linalg.svd(x, full_matrices=False)


def _pca(patterns, components: int, device=None):
    """Tensors ``(factors, loadings, mean, singular_values)`` on the
    device of a pattern batch ``(..., sy, sx)``."""
    p = as_tensor(patterns, resolve_device(device)).to(torch.float32)
    lead = p.shape[:-2]
    n = int(np.prod(lead)) if lead else 1
    x = p.reshape(n, -1)
    mean = x.mean(dim=0)
    # Economy SVD; n is usually << d for EBSD scans of small patterns.
    u, s, vt = _svd(x - mean)
    k = min(components, s.shape[0])
    return vt[:k], u[:, :k] * s[:k], mean, s


def pca(patterns, components: int, return_variance: bool = False, device=None):
    """PCA of a pattern batch.

    Returns ``(factors, loadings, mean)`` as NumPy arrays: ``factors
    (components, d)`` are the principal pattern components, ``loadings (n,
    components)`` the per-pattern weights, and ``mean (d,)`` the mean
    pattern. With ``return_variance``, appends ``(explained_variance,
    explained_variance_ratio)`` over the kept components (HyperSpy's
    learning-results fields: singular values squared over ``n - 1``, the
    ratio over the total variance). ``device=None`` is the card.
    """
    factors, loadings, mean, s = _pca(patterns, components, device)
    out = (factors.cpu().numpy(), loadings.cpu().numpy(), mean.cpu().numpy())
    if return_variance:
        n = loadings.shape[0]
        k = factors.shape[0]
        s_np = s.cpu().numpy()
        var = s_np**2 / max(n - 1, 1)
        total = float(var.sum())
        ratio = var / total if total > 0 else np.zeros_like(var)
        out = out + (var[:k], ratio[:k])
    return out


def _rescale(recon: torch.Tensor, dtype_out: np.dtype) -> torch.Tensor:
    """Rescale each pattern (last axis) to an integer dtype's range, in
    float32 as NumPy's ``(x - min) / (max - min) * (omax - omin) + omin``;
    other dtypes are returned as they are."""
    if not np.issubdtype(dtype_out, np.integer):
        return recon
    omin, omax = get_dtype_range(dtype_out)
    imin = recon.amin(dim=-1, keepdim=True)
    imax = recon.amax(dim=-1, keepdim=True)
    return (recon - imin) / (imax - imin) * (omax - omin) + omin


def pca_reconstruct(patterns, components: int | list[int] | None, dtype_out=None, device=None) -> np.ndarray:
    """Low-rank PCA reconstruction of the patterns, rescaled per pattern
    to the output dtype's range for integer dtypes and cast as NumPy's
    ``astype`` casts (truncating).

    ``components`` follows kikuchipy's ``get_decomposition_model``
    convention: an int keeps components ``0..components``, a list keeps
    exactly those components, and None keeps all of them. The
    reconstruction runs on ``device`` (``None`` is the card) and comes back
    as a NumPy array.
    """
    dev = resolve_device(device)
    patterns = as_tensor(patterns, dev)
    shape = tuple(patterns.shape)
    if components is None:
        n = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        k_fit: int = min(n, int(shape[-2] * shape[-1]))
        select = None
    elif isinstance(components, (list, tuple, np.ndarray)):
        select = np.asarray(components, dtype=int)
        k_fit = int(select.max()) + 1
    else:
        k_fit = int(components)
        select = None
    factors, loadings, mean, _ = _pca(patterns, k_fit, dev)
    if select is not None:
        index = torch.as_tensor(select, device=dev)
        factors = factors[index]
        loadings = loadings[:, index]
    with matmul_precision(False):
        recon = loadings @ factors + mean
    if dtype_out is None:
        return recon.reshape(shape).cpu().numpy()
    dtype_out = np.dtype(dtype_out)
    recon = _rescale(recon, dtype_out)
    return recon.to(torch_dtype(dtype_out)).reshape(shape).cpu().numpy()
