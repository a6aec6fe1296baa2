"""Device-mesh parallelism for dictionary indexing
(``kikuchipy_tpu/parallel/mesh.py``).

The problem is sharded over a 2D ``("scan", "dict")`` grid of devices:

- ``"scan"`` axis: experimental patterns, pure data parallelism over
  beam positions;
- ``"dict"`` axis: dictionary entries, with a cross-shard top-k merge.

Each (scan, dict) block is matched on its own device by the single-device
path (:func:`~kikuchipy_tpu_torch.indexing.di._index_resident`) and keeps
its local top-k. JAX matches a block as one tile. The port does so with
``approx_topk``, whose group compression depends on the tile; otherwise it
takes tiles of at most ``_default_tile(n_local)`` columns, as the
single-device call does: the stable merge of the tiles' top-k is the
block's top-k, and the block's scores and their sort (about 40 bytes an
entry) stay within the single-device call's memory. Every block is
launched before any result is read, so the blocks on several cards run at
once. The merge concatenates a scan row's candidates in dict-shard order
on the row's first device and takes a stable top-k: JAX's
``all_gather(tiled=True)`` and ``lax.top_k``, ties included.

A grid may name one device more than once (``[torch.device("cpu")] * 8``,
or ``cuda:0`` four times): the blocks then run one after another on it,
with the same shapes and results as on separate devices.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "Mesh",
    "make_mesh",
    "sharded_match_topk",
    "sharded_dictionary_index",
    "sharded_fused_dictionary_index",
]


class Mesh:
    """A ``("scan", "dict")`` grid of ``torch.device``\\ s.

    ``devices`` is this process's grid, ``(scan rows, dict columns)``;
    ``processes`` is the number of processes whose grids stack along
    ``"scan"`` (:func:`~kikuchipy_tpu_torch.parallel.multihost.
    multihost_mesh`), so :attr:`shape` is the global one, as JAX's.
    """

    def __init__(self, devices: np.ndarray, axis_names=("scan", "dict"), processes: int = 1):
        if devices.ndim != 2:
            raise ValueError(f"a mesh needs a 2D grid of devices, got shape {devices.shape}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.processes = int(processes)

    @property
    def shape(self) -> dict[str, int]:
        rows, cols = self.devices.shape
        return {self.axis_names[0]: rows * self.processes, self.axis_names[1]: cols}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def _device_grid(devices, rows: int, cols: int) -> np.ndarray:
    """``devices`` (default: every CUDA device of this process; raises
    without a card) as a ``(rows, cols)`` object array of ``torch.device``."""
    if devices is None:
        from kikuchipy_tpu_torch.utils.device import resolve_device

        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return np.array([torch.device(d) for d in devices], dtype=object).reshape(rows, cols)


def make_mesh(
    n_scan: int | None = None,
    n_dict: int | None = None,
    devices=None,
) -> Mesh:
    """Build a ``("scan", "dict")`` mesh over ``devices`` (default: every
    CUDA device; a list may repeat a device).

    With no sizes, every device is on the ``scan`` axis (the dictionary
    replicated, the scan data-parallel).
    """
    if devices is None:
        devices = _device_grid(None, -1, 1).ravel()
    n = len(devices)
    if n_scan is None and n_dict is None:
        n_scan, n_dict = n, 1
    elif n_scan is None:
        n_scan = n // n_dict
    elif n_dict is None:
        n_dict = n // n_scan
    if n_scan * n_dict != n:
        raise ValueError(f"mesh {n_scan}x{n_dict} does not match {n} devices")
    return Mesh(_device_grid(devices, n_scan, n_dict), axis_names=("scan", "dict"))


def _merge_row(parts, k_out: int, device: torch.device):
    """Stable top-k of a scan row's per-shard candidates, concatenated in
    dict-shard order on ``device``."""
    from kikuchipy_tpu_torch.indexing.di import topk_stable

    s_all = torch.cat([s.to(device) for s, _ in parts], dim=1)
    i_all = torch.cat([i.to(device) for _, i in parts], dim=1)
    s_out, pos = topk_stable(s_all, k_out)
    return s_out, torch.gather(i_all, 1, pos)


def sharded_match_topk(
    exp_prepared: torch.Tensor,
    dict_prepared: torch.Tensor,
    keep_n: int,
    mesh: Mesh,
    precision: str = "highest",
    approx: bool = False,
    dict_q: torch.Tensor | None = None,
    dict_scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Match prepared experimental rows against a prepared dictionary on a
    ``("scan", "dict")`` mesh and return the global top-k.

    ``exp_prepared (n, d)`` is split over the mesh's scan rows,
    ``dict_prepared (m, d)`` over its dict columns (``n`` and ``m`` must
    divide them). Each block runs :func:`~kikuchipy_tpu_torch.indexing.di.
    _index_resident` (tiles as the module says) with
    ``k_local = min(keep_n, m_local)``; tiers that rescore (``"mixed"``,
    ``"int8"``) rescore within the shard, so the merge sees final scores.
    For ``"int8"`` pass the quantized ``dict_q (m, d)`` / ``dict_scale
    (m,)`` of :meth:`PreparedDictionary.quantized_int8`. Returns
    ``(scores, indices)`` of shape ``(n, min(keep_n, m))`` on the mesh's
    first device.
    """
    from kikuchipy_tpu_torch.indexing.di import _check_resident_precision, _default_tile, _index_resident

    _check_resident_precision(precision, "sharded dictionary indexing")
    rows, cols = mesh.devices.shape
    n, m = exp_prepared.shape[0], dict_prepared.shape[0]
    if n % rows or m % cols:
        raise ValueError(f"n={n} and m={m} must divide the mesh's local grid {rows}x{cols}")
    n_local, m_local = n // rows, m // cols
    k_local = min(keep_n, m_local)
    k_out = min(keep_n, m)
    tile = m_local if approx else min(m_local, _default_tile(n_local))

    # Launch every block, then merge each scan row.
    blocks = []
    for i in range(rows):
        row = []
        for j in range(cols):
            dev = mesh.devices[i, j]
            rs, ms = slice(i * n_local, (i + 1) * n_local), slice(j * m_local, (j + 1) * m_local)
            q = (None, None) if dict_q is None else (dict_q[ms].to(dev), dict_scale[ms].to(dev))
            s, idx = _index_resident(
                exp_prepared[rs].to(dev), dict_prepared[ms].to(dev), k_local, tile, precision, approx, *q
            )
            row.append((s, (idx + j * m_local).to(torch.int32)))
        blocks.append(row)
    out = [_merge_row(row, k_out, mesh.devices[i, 0]) for i, row in enumerate(blocks)]
    first = mesh.devices[0, 0]
    return torch.cat([s.to(first) for s, _ in out]), torch.cat([i.to(first) for _, i in out])


def sharded_fused_dictionary_index(
    experimental,
    rotations,
    master,
    dc,
    npx: int,
    npy: int,
    scale: float,
    keep_n: int = 20,
    mesh: Mesh | None = None,
):
    """Multi-device DI with the dictionary projected on the devices: the
    device of each (scan, dict) block projects that dict shard's rotations
    from the master pattern (one launch of the projection kernel on the
    card), prepares them and matches its scan shard in IEEE float32; the
    per-shard top-k merge as in :func:`sharded_match_topk`. The whole
    dictionary never exists on any device.

    ``experimental`` ``(n, d)`` or ``(n, sy, sx)`` raw patterns (prepared
    here with NCC); ``rotations (m, 4)``; ``master``, ``dc``, ``npx``,
    ``npy``, ``scale`` as for :func:`~kikuchipy_tpu_torch.projection.
    master_pattern.project_patterns`. ``n`` and ``m`` must divide the mesh
    axes. Returns ``(scores, indices)`` as NumPy arrays.
    """
    from kikuchipy_tpu_torch.indexing.di import _default_tile, _index_resident
    from kikuchipy_tpu_torch.indexing.metrics import ncc
    from kikuchipy_tpu_torch.projection.master_pattern import project_patterns, quad_texture
    from kikuchipy_tpu_torch.utils.device import as_tensor

    if mesh is None:
        mesh = make_mesh()
    rows, cols = mesh.devices.shape
    first = mesh.devices[0, 0]
    experimental = as_tensor(experimental, first)
    if experimental.ndim > 2:
        experimental = experimental.reshape(-1, experimental.shape[-2] * experimental.shape[-1])
    rotations = as_tensor(rotations, first, torch.float32)
    n, m = experimental.shape[0], rotations.shape[0]
    if n % rows or m % cols:
        raise ValueError(f"n={n} and m={m} must divide the mesh axes {mesh.shape}")
    n_local, m_local = n // rows, m // cols
    keep_n_eff = min(keep_n, m_local)
    tile = min(m_local, _default_tile(n_local))

    # The master's bilinear table and the direction cosines once a device.
    inputs = {}
    for dev in dict.fromkeys(mesh.devices.ravel()):
        inputs[dev] = (quad_texture(as_tensor(master, dev, torch.float32)), as_tensor(dc, dev, torch.float32))
    blocks = []
    for i in range(rows):
        row = []
        for j in range(cols):
            dev = mesh.devices[i, j]
            quad, dc_d = inputs[dev]
            sim_patterns = project_patterns(
                rotations[j * m_local : (j + 1) * m_local].to(dev), dc_d, None, npx, npy, scale, quad=quad
            )
            dict_prepared = ncc.prepare(sim_patterns, None)
            exp_prepared = ncc.prepare(experimental[i * n_local : (i + 1) * n_local].to(dev), None)
            s, idx = _index_resident(exp_prepared, dict_prepared, keep_n_eff, tile, "highest")
            row.append((s, (idx + j * m_local).to(torch.int32)))
        blocks.append(row)
    out = [_merge_row(row, min(keep_n, m), mesh.devices[i, 0]) for i, row in enumerate(blocks)]
    scores = torch.cat([s.cpu() for s, _ in out]).numpy()
    idx = torch.cat([i.cpu() for _, i in out]).numpy()
    return scores, idx


def _pad_rows(arr: torch.Tensor, n_rows: int) -> torch.Tensor:
    # Padding rows repeat the first row (already valid and normalized), so
    # scores stay finite; padded entries are dropped by index.
    return torch.cat([arr, arr[:1].expand((n_rows,) + tuple(arr.shape[1:]))], dim=0)


def _drop_padded_entries(scores: np.ndarray, idx: np.ndarray, m: int, keep_n: int):
    """Each row's first ``keep_n`` entries with an index below ``m`` (the
    query kept enough of them), in order."""
    pos = np.argsort(idx >= m, axis=1, kind="stable")[:, :keep_n]
    return np.take_along_axis(scores, pos, axis=1), np.take_along_axis(idx, pos, axis=1)


def sharded_dictionary_index(
    experimental,
    dictionary,
    keep_n: int = 20,
    metric="ncc",
    mesh: Mesh | None = None,
    signal_mask: np.ndarray | None = None,
    precision: str = "highest",
    approx_topk: bool = False,
):
    """Dictionary indexing over a device mesh.

    Prepares the patterns (and for ``precision="int8"`` quantizes the
    dictionary), pads the scan axis (zero rows) and the dictionary axis
    (copies of prepared row 0) to multiples of the mesh axes, matches with
    :func:`sharded_match_topk`, and strips the padding. ``dictionary`` may
    be a :class:`~kikuchipy_tpu_torch.indexing.di.PreparedDictionary`: its
    prepared (and for ``"int8"`` quantized) rows are split over the dict
    axis and reused. Returns ``(scores, indices)`` as NumPy arrays.
    """
    from kikuchipy_tpu_torch.indexing.di import _check_resident_precision, _resident_dictionary
    from kikuchipy_tpu_torch.indexing.metrics import get_metric
    from kikuchipy_tpu_torch.utils.device import as_tensor

    _check_resident_precision(precision, "sharded dictionary indexing")
    metric = get_metric(metric)
    if mesh is None:
        mesh = make_mesh()
    first = mesh.devices[0, 0]
    rows, cols = mesh.devices.shape

    experimental = as_tensor(experimental, first)
    if experimental.ndim > 2:
        experimental = experimental.reshape(-1, experimental.shape[-2] * experimental.shape[-1])
    n, d = experimental.shape
    dict_prepared, dict_q, dict_scale, keep_idx = _resident_dictionary(dictionary, metric, signal_mask, precision,
                                                                       first, n_pixels=d)
    m = dict_prepared.shape[0]

    n_pad = (-n) % rows
    m_pad = (-m) % cols
    if n_pad:
        experimental = torch.cat([experimental, experimental.new_zeros((n_pad, d))], dim=0)
    exp_prepared = metric.prepare(experimental, keep_idx)
    if m_pad:
        dict_prepared = _pad_rows(dict_prepared, m_pad)
        if dict_q is not None:
            dict_q, dict_scale = _pad_rows(dict_q, m_pad), _pad_rows(dict_scale, m_pad)

    if dict_prepared.shape[1] != exp_prepared.shape[1]:
        raise ValueError(
            f"dictionary feature size {dict_prepared.shape[1]} != "
            f"experimental feature size {exp_prepared.shape[1]} — the "
            f"signal_mask here must match the one used at "
            f"prepare_dictionary time"
        )
    keep_n_eff = min(keep_n, m)
    k_query = min(keep_n_eff + m_pad, m + m_pad) if m_pad else keep_n_eff
    scores, idx = sharded_match_topk(
        exp_prepared, dict_prepared, k_query, mesh, precision, approx_topk, dict_q, dict_scale
    )
    scores = scores[:n].cpu().numpy()
    idx = idx[:n].cpu().numpy()
    if m_pad:
        scores, idx = _drop_padded_entries(scores, idx, m, keep_n_eff)
    return scores, idx
