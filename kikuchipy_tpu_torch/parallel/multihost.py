"""Multi-process dictionary indexing and refinement on
``torch.distributed`` (``kikuchipy_tpu/parallel/multihost.py``).

- The **scan axis is host-major data parallelism**: each process reads
  only its own contiguous slice of the navigation grid
  (:func:`host_navigation_slice`) and indexes or refines it on its own
  devices, with no collective in the hot path.
- The **dict axis stays within a process**: the dictionary is replicated
  per process and split over its local devices
  (:func:`~kikuchipy_tpu_torch.parallel.mesh.sharded_match_topk`).
- Results come back per process, or, with ``gather_results``, on every
  process through one ``dist.all_gather`` of each process's compact block
  (zero-padded to equal length and stripped per block). On a gloo group
  the gathered tensors are on the CPU, on an NCCL group on the process's
  CUDA device: the group decides, with no fallback between backends.

The process index and count are ``dist.get_rank()`` and
``dist.get_world_size()`` when a process group is initialized, and 0 and 1
otherwise: a single process degenerates to the whole scan and a mesh like
:func:`~kikuchipy_tpu_torch.parallel.mesh.make_mesh`'s.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from kikuchipy_tpu_torch.parallel.mesh import Mesh, _device_grid, _drop_padded_entries, sharded_match_topk

__all__ = [
    "host_navigation_slice",
    "multihost_mesh",
    "multihost_dictionary_index",
    "multihost_refine_orientation",
]


def _process() -> tuple[int, int]:
    """``(index, count)`` of this process in the default group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_navigation_slice(
    n_total: int,
    process_index: int | None = None,
    process_count: int | None = None,
) -> slice:
    """This process's contiguous slice of the flattened navigation axis.

    Patterns are distributed host-major in equal contiguous blocks (the
    last processes take what remains), so each process can read its block
    straight from the scan file without coordination.
    """
    index, count = _process()
    if process_index is None:
        process_index = index
    if process_count is None:
        process_count = count
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} outside [0, {process_count})")
    per_host = -(-n_total // process_count)  # ceil
    start = min(process_index * per_host, n_total)
    stop = min(start + per_host, n_total)
    return slice(start, stop)


def multihost_mesh(n_dict_local: int | None = None, devices=None) -> Mesh:
    """A ``("scan", "dict")`` mesh laid out host-major on ``scan``.

    ``devices`` are this process's devices (default: every CUDA device it
    sees; a list may repeat a device). ``n_dict_local`` of them (default 1)
    form the ``dict`` axis, which stays within the process; the global
    ``scan`` axis is ``process count x`` the local one.
    """
    grid = _device_grid(devices, -1, 1)
    n_local = grid.size
    if n_dict_local is None:
        n_dict_local = 1
    if n_local % n_dict_local:
        raise ValueError(f"n_dict_local {n_dict_local} must divide the local device count {n_local}")
    return Mesh(grid.reshape(n_local // n_dict_local, n_dict_local), axis_names=("scan", "dict"),
                processes=_process()[1])


def _all_gather(arrays: list[np.ndarray]) -> list[list[np.ndarray]]:
    """Each array of this process gathered from every process, in process
    order; the tensors go on the CPU for gloo, on this process's CUDA
    device for NCCL."""
    count = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        parts = [torch.empty_like(t) for _ in range(count)]
        dist.all_gather(parts, t)
        out.append([p.cpu().numpy() for p in parts])
    return out


def _strip_host_padding(blocks: list[np.ndarray], n_total: int) -> np.ndarray:
    """Each process's real rows of its padded block, in process order."""
    count = len(blocks)
    parts = []
    for p, block in enumerate(blocks):
        sl = host_navigation_slice(n_total, p, count)
        parts.append(block[: sl.stop - sl.start])
    return np.concatenate(parts, axis=0)


def multihost_refine_orientation(
    local_signal,
    xmap=None,
    detector=None,
    master_pattern=None,
    energy: float | None = None,
    n_total: int | None = None,
    gather_results: bool = False,
    mode: str = "orientation",
    devices=None,
    **kwargs,
):
    """Refine a host-distributed scan: each process refines only its own
    :func:`host_navigation_slice` block, split over its local devices
    (``devices``, default every CUDA device it sees) by
    :mod:`kikuchipy_tpu_torch.parallel.refine`, with no communication in
    the optimization.

    ``mode`` is ``"orientation"`` (default), ``"pc"`` or ``"joint"``;
    ``kwargs`` go to the refinement (method, projector, trust_region, ...).
    ``n_total`` is the global number of map points (needed with
    ``gather_results`` when the blocks are unequal).

    Returns this block's :class:`RefinementResult`, or with
    ``gather_results`` the tuple ``(result, rotations (n_total, 4), scores
    (n_total,), pcs)``, ``pcs`` the ``(n_total, 3)`` per-point PCs of the
    ``"pc"`` and ``"joint"`` modes and None in ``"orientation"`` mode: the
    same arity whatever the process count.
    """
    from kikuchipy_tpu_torch.parallel import refine as _refine

    refine_fn = {
        "orientation": _refine.sharded_refine_orientation,
        "pc": _refine.sharded_refine_projection_center,
        "joint": _refine.sharded_refine_orientation_projection_center,
    }[mode]

    res = refine_fn(
        local_signal,
        xmap=xmap,
        detector=detector,
        master_pattern=master_pattern,
        energy=energy,
        mesh=Mesh(_device_grid(devices, -1, 1), axis_names=("scan", "dict")),
        **kwargs,
    )
    if not gather_results:
        return res

    n_local = local_signal.navigation_size
    rot = np.asarray(res.xmap.best_rotations).reshape(-1, 4)
    scores = np.asarray(res.xmap.prop["scores"]).reshape(-1)
    det_res = res.detector
    pcs = (
        np.asarray(det_res.pc).reshape(-1, 3)
        if det_res is not None and det_res.navigation_size == n_local
        else None
    )

    n_proc = _process()[1]
    if n_proc == 1:
        return res, rot, scores, pcs

    if n_total is None:
        n_total = n_local * n_proc
    per_host = -(-n_total // n_proc)
    pad = per_host - rot.shape[0]

    def _pad(a):
        if not pad:
            return a
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    # The per-point PC field is gathered too: in the "pc" and "joint" modes
    # it is the primary output.
    payload = [_pad(rot), _pad(scores)]
    if pcs is not None:
        payload.append(_pad(pcs))
    gathered = [_strip_host_padding(blocks, n_total) for blocks in _all_gather(payload)]
    return res, gathered[0], gathered[1], gathered[2] if pcs is not None else None


def multihost_dictionary_index(
    local_patterns,
    dictionary,
    keep_n: int = 20,
    metric="ncc",
    mesh: Mesh | None = None,
    signal_mask: np.ndarray | None = None,
    n_total: int | None = None,
    gather_results: bool = False,
    precision: str = "highest",
    approx_topk: bool = False,
):
    """Index a scan distributed across processes against a dictionary that
    every process holds whole.

    ``local_patterns``: this process's :func:`host_navigation_slice` block,
    ``(n_local, sy, sx)`` or ``(n_local, d)``; ``dictionary`` ``(m, sy,
    sx)``, ``(m, d)`` or a :class:`~kikuchipy_tpu_torch.indexing.di.
    PreparedDictionary` (whose prepared rows are prepared again, as in the
    JAX package); ``mesh`` from :func:`multihost_mesh`; ``n_total`` the
    global number of patterns (default ``n_local x`` the process count;
    pass it when the last blocks are shorter); ``gather_results``: every
    process returns the full ``(n_total, keep_n)`` arrays (one gather of
    ``8 x keep_n`` bytes a pattern), else its own block.

    ``precision`` and ``approx_topk`` are taken and not used: the JAX
    package's function matches at ``"highest"`` whatever they say
    (``kikuchipy_tpu/parallel/multihost.py:388``), and so does this one.

    Returns ``(scores, indices)`` as NumPy arrays.
    """
    from kikuchipy_tpu_torch.indexing.di import PreparedDictionary, _check_prepared_metric, _resident_dictionary
    from kikuchipy_tpu_torch.indexing.metrics import get_metric
    from kikuchipy_tpu_torch.parallel.mesh import _pad_rows
    from kikuchipy_tpu_torch.utils.device import as_tensor

    metric = get_metric(metric)
    if mesh is None:
        mesh = multihost_mesh()
    n_scan, n_dict = mesh.shape["scan"], mesh.shape["dict"]
    n_proc = _process()[1]
    first = mesh.devices[0, 0]

    local_patterns = as_tensor(local_patterns, first)
    if local_patterns.ndim > 2:
        local_patterns = local_patterns.reshape(local_patterns.shape[0], -1)
    n_local, d = local_patterns.shape
    if isinstance(dictionary, PreparedDictionary):
        _check_prepared_metric(dictionary, metric)
        dictionary = dictionary.prepared  # prepared once more, as the JAX package does
    dict_prepared, _, _, keep_idx = _resident_dictionary(dictionary, metric, signal_mask, "highest", first,
                                                         n_pixels=d)
    m = dict_prepared.shape[0]
    if n_total is None:
        n_total = n_local * n_proc

    # Every process pads its block to the same length, a multiple of its
    # scan rows.
    if n_scan % n_proc:
        raise ValueError(f"scan mesh axis ({n_scan}) must be a multiple of the process count ({n_proc})")
    shard_rows = n_scan // n_proc
    per_host = -(-n_total // n_proc)
    per_host += (-per_host) % shard_rows
    pad_local = per_host - n_local
    if pad_local:
        local_patterns = torch.cat([local_patterns, local_patterns.new_zeros((pad_local, d))], dim=0)
    m_pad = (-m) % n_dict
    if m_pad:
        dict_prepared = _pad_rows(dict_prepared, m_pad)
    exp_prepared = metric.prepare(local_patterns, keep_idx)

    keep_n_eff = min(keep_n, m)
    k_query = min(keep_n_eff + m_pad, m + m_pad) if m_pad else keep_n_eff
    scores, idx = sharded_match_topk(exp_prepared, dict_prepared, k_query, mesh)
    scores, idx = scores.cpu().numpy(), idx.cpu().numpy()

    if gather_results and n_proc > 1:
        # Pad rows sit at the end of each process's block, not at the
        # global end: strip them block by block.
        blocks_s, blocks_i = _all_gather([scores, idx])
        scores = _strip_host_padding(blocks_s, n_total)
        idx = _strip_host_padding(blocks_i, n_total)
    else:
        scores, idx = scores[:n_local], idx[:n_local]
    if m_pad:
        scores, idx = _drop_padded_entries(scores, idx, m, keep_n_eff)
    return scores, idx
