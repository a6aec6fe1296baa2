"""Triplet voting of Hough indexing on kernel H (``csrc/hough_vote.cu``).

The port of ``kikuchipy_tpu/indexing/hough.py`` ``_vote_orientations``.
:func:`vote_orientations` is kernel H's wrapper: for a CPU tensor it
returns its plain version (:func:`vote_orientations_plain`, JAX's einsums in
PyTorch, in chunks of ``chunk`` patterns); for a CUDA tensor it launches
kernel H once for all patterns or raises, and counts the launch in its
``.launches``.

For each pattern and each detected-band pair, the first ``n_pairs_max``
entries of the interplanar-angle LUT within ``angle_tol`` of the pair's
angle are tried with 8 orderings and signs of their two poles; each
candidate rotation is the symmetric-triad alignment of the two (normal,
pole) pairs, scored by its inlier bands (those within ``angle_tol`` of any
pole) and their mean angular error. The best candidate's rotation, error
and inlier count come back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kikuchipy_tpu_torch.indexing.di import topk_stable
from kikuchipy_tpu_torch.ops.pattern_io import SMEM_BUDGET

__all__ = ["MAX_BANDS", "MIN_BANDS", "TILE_POLES", "TILE_WARPS", "block_shape", "candidate_scores",
           "candidate_threshold", "pole_route", "smem_bytes", "vote_disagreements", "vote_orientations",
           "vote_orientations_plain"]

# Pair angles at or below this (radians) give unstable frames: their
# candidates are invalid.
MIN_PAIR_ANGLE = 0.05
# Kernel H and its plain version compute each candidate's R in float32 in
# another order: their rotations agree within 2e-7 an element, so a band's
# cosine within COS_DELTA. A band at angle t then moves by up to
# min(delta / sin t, sqrt(2 delta)) (an arccos near 1): err's limit is 1e-6
# rad plus the mean of that over the inliers, a score's (n_in - err / 10) a
# tenth of it, and scores apart by more than twice that pick the same
# candidate; a band whose cosine lies within delta of cos(tol) may be an
# inlier in one version and not in the other. R_TOL: two R that are one
# candidate's.
COS_DELTA = 1e-6
R_TOL = 1e-5


def candidate_threshold(angle_tol: float) -> tuple[float, float]:
    """``angle_tol`` and its cosine as the float32 values both versions
    compare with (the cosine taken in float64, then rounded)."""
    return float(np.float32(angle_tol)), float(np.float32(np.cos(np.float64(angle_tol))))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def _triad(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Symmetric orthonormal frame (columns) from two unit vectors:
    ``e1 = (v1 + v2) / |.|``, ``e2 = (v1 - v2) / |.|``, ``e3 = e1 x e2``
    (JAX's ``_triad``)."""
    e1 = _unit(v1 + v2)
    e2 = _unit(v1 - v2)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def candidate_scores(normals, g_unit, lut_angles, lut_pairs, pair_idx, angle_tol: float, n_pairs_max: int = 8):
    """Every candidate of every pattern, flattened in (pair, slot, variant)
    order: ``(R (n, C, 3, 3), err (n, C), n_in (n, C), score (n, C))`` with
    ``C = P x K x 8`` (JAX's einsums; the vote takes the argmax of
    ``score``)."""
    tol32, cos32 = candidate_threshold(angle_tol)
    n = normals.shape[0]
    n1 = normals[:, pair_idx[:, 0]]  # (n, P, 3)
    n2 = normals[:, pair_idx[:, 1]]
    ang = torch.arccos(torch.clamp(torch.abs(torch.sum(n1 * n2, dim=-1)), 0.0, 1.0))  # (n, P)

    # The first K LUT entries within tolerance, in LUT order, then the
    # entries out of tolerance in ascending order.
    L = lut_angles.shape[0]
    k = min(n_pairs_max, L)
    delta = torch.abs(lut_angles[None, None, :] - ang[..., None])  # (n, P, L)
    in_tol = delta < tol32
    rank = -torch.arange(L, dtype=torch.float32, device=normals.device)
    sel_score = torch.where(in_tol, rank, -torch.inf)
    neg_rank, lut_idx = topk_stable(sel_score, k)  # (n, P, K), jax.lax.top_k's order
    lut_ok = torch.isfinite(neg_rank) & (ang[..., None] > MIN_PAIR_ANGLE)

    ga = g_unit[lut_pairs[lut_idx, 0]]  # (n, P, K, 3)
    gb = g_unit[lut_pairs[lut_idx, 1]]
    g1 = torch.stack([ga, ga, -ga, -ga, gb, gb, -gb, -gb], dim=-2)
    g2 = torch.stack([gb, -gb, gb, -gb, ga, -ga, ga, -ga], dim=-2)  # (n, P, K, 8, 3)

    f_n = _triad(n1, n2)  # (n, P, 3, 3)
    f_g = _triad(g1, g2)  # (n, P, K, 8, 3, 3)
    R = torch.einsum("npkvab,npcb->npkvac", f_g, f_n)

    mapped = torch.einsum("npkvab,nqb->npkvqa", R, normals)
    cosang = torch.amax(torch.abs(torch.einsum("npkvqa,ga->npkvqg", mapped, g_unit)), dim=-1)
    cosang = torch.clamp(cosang, 0.0, 1.0)
    inlier = cosang > cos32
    n_in = torch.sum(inlier, dim=-1, dtype=torch.int32)  # (n, P, K, 8)
    err = torch.sum(torch.arccos(cosang) * inlier, dim=-1) / torch.clamp(n_in, min=1)
    valid = lut_ok[..., None]
    n_in = torch.where(valid, n_in, 0)
    err = torch.where(valid & (n_in > 0), err, torch.inf)

    # Lexicographic (n_in descending, err ascending): err < pi / 2.
    score = n_in.to(torch.float32) - torch.where(torch.isfinite(err), err, 10.0) / 10.0
    return R.reshape(n, -1, 3, 3), err.reshape(n, -1), n_in.reshape(n, -1), score.reshape(n, -1)


def _vote_chunk(normals, g_unit, lut_angles, lut_pairs, pair_idx, angle_tol, n_pairs_max):
    R, err, n_in, score = candidate_scores(normals, g_unit, lut_angles, lut_pairs, pair_idx, angle_tol, n_pairs_max)
    best = torch.argmax(score, dim=1)  # the first of equal scores
    R_best = torch.take_along_dim(R, best[:, None, None, None], dim=1)[:, 0]
    return R_best, torch.take_along_dim(err, best[:, None], dim=1)[:, 0], torch.take_along_dim(n_in, best[:, None], dim=1)[:, 0]


def vote_orientations_plain(
    normals: torch.Tensor,
    g_unit: torch.Tensor,
    lut_angles: torch.Tensor,
    lut_pairs: torch.Tensor,
    pair_idx: torch.Tensor,
    angle_tol: float,
    n_pairs_max: int = 8,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel H's function in PyTorch operations, JAX's
    ``_vote_orientations`` on ``chunk`` patterns at a time (its
    intermediate holds ``chunk x P x K x 8 x n_bands x n_poles`` floats).
    Returns ``(R (n, 3, 3), err (n,), n_in (n,) int32)``."""
    if normals.shape[0] == 0:
        return (normals.new_zeros((0, 3, 3)), normals.new_zeros((0,)),
                torch.zeros((0,), dtype=torch.int32, device=normals.device))
    parts = [_vote_chunk(normals[s:s + chunk], g_unit, lut_angles, lut_pairs, pair_idx, angle_tol, n_pairs_max)
             for s in range(0, normals.shape[0], max(int(chunk), 1))]
    return tuple(torch.cat(p) for p in zip(*parts))


def vote_disagreements(got, ref, normals, g_unit, lut_angles, lut_pairs, pair_idx, angle_tol: float,
                       n_pairs_max: int = 8, chunk: int = 1024) -> tuple[list[str], dict]:
    """How kernel H's ``got = (R, err, n_in)`` departs from its plain
    version's ``ref`` on the same inputs beyond what their float32 orders
    allow (an empty list when it does not), and what the comparison saw.

    A *boundary* pattern has a band whose cosine under the kernel's R lies
    within COS_DELTA of cos(tol): the inlier test can go either way, and the
    kernel's R must be a candidate's. Elsewhere n_in is equal and err within
    its limit (1e-6 rad plus the mean over the inliers of min(delta / sin t,
    sqrt(2 delta))). A *clear* pattern's best score beats the runner-up by
    more than twice a tenth of that limit: R within R_TOL of the plain R.
    On a *near tie* (symmetric equivalents of one rotation score alike) the
    kernel's R and err are a candidate's within that gap of the best. Where
    no candidate is valid (every score -1), R is the plain version's,
    candidate 0's.

    The stats count each kind (``n``, ``boundary``, ``clear``,
    ``near_ties``, ``none_valid``, and ``boundary_n_in_equal``) and give the
    largest |R - R'| (``max_r_diff``) and finite |err - err'|
    (``max_err_diff``) to what the kernel's result is held against: the
    plain version's on clear patterns and those without a valid candidate,
    the nearest matching candidate's on near ties, and (R alone) the nearest
    candidate's on boundary patterns; ``max_err_limit`` is the largest err
    limit in use. Candidates are scored ``chunk`` patterns at a time on the
    inputs' device."""
    R, err, n_in = got
    R_p, err_p, n_p = ref
    cos_tol = candidate_threshold(angle_tol)[1]
    n = normals.shape[0]
    problems = []
    counts = dict(n=n, boundary=0, clear=0, near_ties=0, none_valid=0, boundary_n_in_equal=0)
    max_r = max_e = max_lim = 0.0

    def largest(x, mask):
        return float(x[mask].max()) if bool(mask.any()) else 0.0

    def err_diff(a, b):
        both_inf = torch.isinf(a) & torch.isinf(b)
        return torch.where(both_inf, 0.0, (a.double() - b.double()).abs())

    for s0 in range(0, n, max(int(chunk), 1)):
        sl = slice(s0, s0 + max(int(chunk), 1))
        Rk, ek = R[sl], err[sl]
        Rc, errc, _, scores = candidate_scores(normals[sl], g_unit, lut_angles, lut_pairs, pair_idx, angle_tol,
                                               n_pairs_max)
        c = torch.einsum("nab,nqb,ga->nqg", Rk.double(), normals[sl].double(),
                         g_unit.double()).abs().amax(dim=-1).clamp(max=1.0)
        boundary = ((c - cos_tol).abs() < COS_DELTA).any(dim=1)
        inlier = c > cos_tol
        move = torch.minimum(COS_DELTA / torch.sqrt(torch.clamp(1 - c * c, min=1e-30)),
                             torch.full_like(c, (2 * COS_DELTA) ** 0.5))
        limit = 1e-6 + (move * inlier).sum(dim=1) / inlier.sum(dim=1).clamp(min=1)
        gap = (0.2 * limit).to(scores.dtype)
        r_diff = (Rc - Rk[:, None]).abs().amax(dim=(-2, -1))  # (m, C)
        is_cand = r_diff <= R_TOL
        top2 = torch.topk(scores, 2, dim=1).values  # C = P x K x 8 >= 8
        clear = ((top2[:, 0] - top2[:, 1]) > gap) & ~boundary
        none_valid = (scores == -1.0).all(dim=1)
        near = ~clear & ~none_valid & ~boundary
        e_plain = err_diff(ek, err_p[sl])
        r_plain = (Rk - R_p[sl]).abs().amax(dim=(-2, -1))
        tied = scores >= top2[:, :1] - gap[:, None]
        e_cand = err_diff(errc, ek[:, None])
        match = is_cand & (e_cand <= limit[:, None]) & tied

        for bad, what in (
            (boundary & ~is_cand.any(dim=1), "at an inlier boundary R is no candidate's"),
            (~boundary & (n_in[sl] != n_p[sl]), "n_in differs from the plain version's without a band at the "
                                                "inlier boundary"),
            (clear & (e_plain > limit), "err is off the plain version's past its limit on a clear best"),
            ((clear | none_valid) & (r_plain > R_TOL), f"R is off the plain version's past {R_TOL} on a clear best "
                                                       "or without a valid candidate"),
            (near & ~match.any(dim=1), "R and err are no candidate's within the gap of the best"),
        ):
            if bool(bad.any()):
                problems.append(f"{what}: {int(bad.sum())} patterns from {s0}")

        # The nearest matching candidate of each near tie.
        nearest = torch.where(match, r_diff, torch.inf).argmin(dim=1, keepdim=True)
        matched = near & match.any(dim=1)
        r_tie = torch.take_along_dim(r_diff, nearest, dim=1)[:, 0]
        e_tie = torch.take_along_dim(e_cand, nearest, dim=1)[:, 0]
        max_r = max(max_r, largest(r_plain, clear | none_valid), largest(r_tie, matched),
                    largest(r_diff.amin(dim=1), boundary))
        max_e = max(max_e, largest(e_plain, clear & torch.isfinite(err_p[sl])),
                    largest(e_tie, matched & torch.isfinite(ek)))
        max_lim = max(max_lim, largest(limit, clear | matched))
        for key, mask in (("boundary", boundary), ("clear", clear), ("near_ties", near), ("none_valid", none_valid),
                          ("boundary_n_in_equal", boundary & (n_in[sl] == n_p[sl]))):
            counts[key] += int(mask.sum())
        del Rc, errc, scores, r_diff, e_cand, match
    return problems, {**counts, "max_r_diff": max_r, "max_err_diff": max_e, "max_err_limit": max_lim}


# Kernel H's pole routes (csrc/hough_vote.cu kTile): up to TILE_POLES poles
# sit in shared memory, loaded once a block, and a warp takes a pattern;
# past that they stream through it in tiles, and a block of TILE_WARPS warps
# takes a pattern. Band counts from MIN_BANDS to MAX_BANDS have a scoring
# loop of their own (the bands' R n in registers, the poles outside); others
# take a loop over the bands.
TILE_POLES = 1024
TILE_WARPS = 8
MIN_BANDS, MAX_BANDS = 3, 12
# Patterns a block of kernel H on the shared route, a warp each (chosen by
# hough_variants.py's timings at [hough]'s scan), fewer where the tables
# pass the shared-memory budget.
PATTERNS_PER_BLOCK = 4


def pole_route(n_poles: int) -> str:
    """Where kernel H keeps ``n_poles`` poles: "shared" (one tile a block,
    a warp a pattern) or "tiles" (streamed, a block a pattern)."""
    return "shared" if n_poles <= TILE_POLES else "tiles"


def block_shape(n_bands: int, n_poles: int, n_pairs: int, k: int, block_bytes=None) -> tuple[int, int]:
    """Kernel H's ``(patterns a block, warps a pattern)``: on the shared
    route PATTERNS_PER_BLOCK patterns of a warp, halved while a block's
    shared memory passes the budget; on the tile route one pattern of
    TILE_WARPS warps. ``block_bytes(groups)`` gives a block's shared memory
    (by default the source's, :func:`smem_bytes`, which builds the kernel).
    Raises ``ValueError`` where one pattern's tables alone pass the
    budget."""
    if block_bytes is None:
        def block_bytes(groups):
            return smem_bytes(n_bands, n_poles, n_pairs, k, groups)
    if pole_route(n_poles) == "tiles":
        groups, warps = 1, TILE_WARPS
    else:
        groups, warps = PATTERNS_PER_BLOCK, 1
    while groups > 1 and block_bytes(groups) > SMEM_BUDGET:
        groups //= 2
    smem = block_bytes(groups)
    if smem > SMEM_BUDGET:
        raise ValueError(f"kernel H keeps {n_pairs} pairs x {k} LUT slots and its tables in {smem} bytes of "
                         f"shared memory a block, more than its budget of {SMEM_BUDGET}")
    return groups, warps


def _library():
    from kikuchipy_tpu_torch.ops._build import library

    lib = library("hough_vote")
    fn = lib.hough_vote_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.hough_vote_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.hough_vote_smem_bytes.restype = ctypes.c_longlong
        for name, want in (("hough_vote_tile_poles", TILE_POLES), ("hough_vote_tile_warps", TILE_WARPS),
                           ("hough_vote_min_bands", MIN_BANDS), ("hough_vote_max_bands", MAX_BANDS)):
            getattr(lib, name).restype = ctypes.c_int
            if getattr(lib, name)() != want:
                raise RuntimeError(f"csrc/hough_vote.cu {name} is {getattr(lib, name)()}, the wrapper's {want}")
    return lib


def smem_bytes(n_bands: int, n_poles: int, n_pairs: int, k: int, groups: int = 1) -> int:
    """Dynamic shared memory of a block of kernel H of ``groups`` patterns
    (``csrc/hough_vote.cu`` ``hough_vote_smem_bytes``): for each pattern the
    normals, the pairs' frames and angles, the ``P x K`` slot tables and
    each slot's unit vectors, then a tile of poles. Builds the kernel."""
    return int(_library().hough_vote_smem_bytes(n_bands, n_poles, n_pairs, k, groups))


# Kernel H's queue a (device, stream): two int32, the next pattern and the
# groups done. Zeroed once when made; each launch leaves them zero again.
_QUEUES: dict = {}


def _queue(dev: torch.device) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _QUEUES:
        _QUEUES[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _QUEUES[key]


def _check(normals, g_unit, lut_angles, lut_pairs, pair_idx) -> None:
    if normals.ndim != 3 or normals.shape[-1] != 3:
        raise ValueError(f"normals must be (n, n_bands, 3), got {tuple(normals.shape)}")
    if g_unit.ndim != 2 or g_unit.shape[-1] != 3 or g_unit.shape[0] < 1:
        raise ValueError(f"g_unit must be (n_poles, 3) with a pole, got {tuple(g_unit.shape)}")
    if lut_angles.ndim != 1 or lut_pairs.shape != (lut_angles.shape[0], 2) or lut_angles.shape[0] < 1:
        raise ValueError(f"lut_angles (L,) and lut_pairs (L, 2) with L >= 1, got {tuple(lut_angles.shape)} and "
                         f"{tuple(lut_pairs.shape)}")
    if pair_idx.ndim != 2 or pair_idx.shape[1] != 2 or pair_idx.shape[0] < 1:
        raise ValueError(f"pair_idx must be (P, 2) with P >= 1, got {tuple(pair_idx.shape)}")


def vote_orientations(
    normals: torch.Tensor,
    g_unit: torch.Tensor,
    lut_angles: torch.Tensor,
    lut_pairs: torch.Tensor,
    pair_idx: torch.Tensor,
    angle_tol: float,
    n_pairs_max: int = 8,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vote each pattern's orientation from its band normals
    ``(n, n_bands, 3)`` against the unit poles ``g_unit (n_poles, 3)`` and
    the LUT of their interplanar angles ``lut_angles (L,)`` and pole pairs
    ``lut_pairs (L, 2)``, over the band pairs ``pair_idx (P, 2)``. Returns
    ``(R (n, 3, 3), err (n,) radians, n_in (n,) int32)``. On the card one
    launch of kernel H for all patterns and nothing else (the first call on
    a stream also zeroes that stream's two queue words; ``chunk`` only
    bounds the plain version's intermediate)."""
    _check(normals, g_unit, lut_angles, lut_pairs, pair_idx)
    if int(n_pairs_max) < 1:
        raise ValueError(f"n_pairs_max must be positive, got {n_pairs_max}")
    if normals.device.type == "cpu":
        return vote_orientations_plain(normals, g_unit, lut_angles, lut_pairs, pair_idx, angle_tol, n_pairs_max, chunk)
    dev = normals.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t, dtype in (("normals", normals, torch.float32), ("g_unit", g_unit, torch.float32),
                           ("lut_angles", lut_angles, torch.float32), ("lut_pairs", lut_pairs, torch.int32),
                           ("pair_idx", pair_idx, torch.int32)):
        if t.device != dev:
            raise ValueError(f"kernel H takes its operands on one device: {name} is on {t.device}, normals on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"kernel H takes {name} as {dtype}, got {t.dtype}")
    n, nb, _ = normals.shape
    if int(pair_idx.min()) < 0 or int(pair_idx.max()) >= nb:
        raise ValueError(f"pair_idx must index the {nb} bands")
    if int(lut_pairs.min()) < 0 or int(lut_pairs.max()) >= g_unit.shape[0]:
        raise ValueError(f"lut_pairs must index the {g_unit.shape[0]} poles")
    k = min(int(n_pairs_max), lut_angles.shape[0])
    groups, _ = block_shape(nb, g_unit.shape[0], pair_idx.shape[0], k)
    R = torch.empty((n, 3, 3), dtype=torch.float32, device=dev)
    err = torch.empty((n,), dtype=torch.float32, device=dev)
    n_in = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return R, err, n_in
    tol32, cos32 = candidate_threshold(angle_tol)
    src = [t.contiguous() for t in (normals, g_unit, lut_angles, lut_pairs, pair_idx)]
    with torch.cuda.device(dev):
        rc = _library().hough_vote_launch(
            *(t.data_ptr() for t in src), R.data_ptr(), err.data_ptr(), n_in.data_ptr(), _queue(dev).data_ptr(),
            n, nb, g_unit.shape[0], lut_angles.shape[0], pair_idx.shape[0], k, tol32, cos32, groups,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc:
        raise RuntimeError(f"hough_vote launch failed: cudaError_t {rc}")
    vote_orientations.launches += 1
    return R, err, n_in


vote_orientations.launches = 0
