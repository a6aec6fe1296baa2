"""Hough/Radon-transform band detection and indexing.

The port of ``kikuchipy_tpu/indexing/hough.py``:

1. :func:`radon_transform`, :func:`detect_bands`,
   :func:`detect_bands_refined` and :func:`detect_bands_fused`: the dense
   Radon operator (and the Radon operator with the butterfly enhancement
   folded in) built on the host once per shape, its device copy kept once
   per device, one IEEE float32 product, 3 x 3 non-maximum suppression,
   stable top-k peak picking, sub-bin refinement and FWHM band widths, in
   PyTorch on the patterns' device;
2. :func:`bands_to_normals`: the band-plane normals on the host (NumPy
   float64);
3. :func:`hough_indexing`: triplet voting on kernel H
   (:func:`kikuchipy_tpu_torch.ops.hough_vote.vote_orientations`), three
   rounds of assignment and weighted Kabsch polish, the fundamental-zone
   reduction and the crystal map;
4. :func:`optimize_pc_batched`: one PC a pattern by batched Nelder-Mead on
   the band-to-pole misfit, and :class:`HoughIndexer`.

Entry points take their device from the patterns (an :class:`EBSD`'s
``device``) or ``device=None``, the card.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from itertools import combinations

import numpy as np
import torch
import torch.nn.functional as F

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
from kikuchipy_tpu_torch.crystallography.sampling import reduce_to_fundamental_zone
from kikuchipy_tpu_torch.geometry import quaternion as quat
from kikuchipy_tpu_torch.indexing.di import topk_stable
from kikuchipy_tpu_torch.ops.hough_vote import candidate_threshold, vote_orientations
from kikuchipy_tpu_torch.utils.device import as_tensor, matmul_precision, resolve_device

__all__ = [
    "HoughIndexer",
    "radon_transform",
    "detect_bands",
    "detect_bands_refined",
    "detect_bands_fused",
    "hough_indexing",
    "bands_to_normals",
    "optimize_pc_batched",
]


@lru_cache(maxsize=8)
def _radon_matrix(sy: int, sx: int, n_theta: int, n_rho: int) -> np.ndarray:
    """Dense Radon operator ``(n_rho * n_theta, sy * sx)`` float32: each
    ray's bilinear sample weights accumulated into its row, divided by the
    ray's count of valid samples (JAX's, bit for bit)."""
    cy, cx = (sy - 1) / 2, (sx - 1) / 2
    radius = min(cy, cx)
    thetas = np.arange(n_theta) * (np.pi / n_theta)
    rhos = np.linspace(-radius, radius, n_rho)
    t = np.linspace(-radius, radius, n_rho)  # positions along the ray
    cos_t = np.cos(thetas)[None, :, None]
    sin_t = np.sin(thetas)[None, :, None]
    rho = rhos[:, None, None]
    s = t[None, None, :]
    # Ray direction (-sin t, cos t), normal (cos t, sin t).
    x = cx + rho * cos_t - s * sin_t  # (n_rho, n_theta, n_s)
    y = cy + rho * sin_t + s * cos_t

    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = x - x0
    fy = y - y0
    valid = (x0 >= 0) & (x0 < sx - 1) & (y0 >= 0) & (y0 < sy - 1)
    x0c = np.clip(x0, 0, sx - 2)
    y0c = np.clip(y0, 0, sy - 2)

    n_rays = n_rho * n_theta
    ray = np.broadcast_to(np.arange(n_rays).reshape(n_rho, n_theta, 1), x.shape)
    count = np.maximum(valid.sum(axis=-1), 1).reshape(-1)

    w = np.zeros((n_rays, sy * sx), dtype=np.float64)
    base = (y0c * sx + x0c).reshape(-1)
    rayf = ray.reshape(-1)
    vf = valid.reshape(-1)
    for off, wgt in (
        (0, ((1 - fy) * (1 - fx)).reshape(-1)),
        (1, ((1 - fy) * fx).reshape(-1)),
        (sx, (fy * (1 - fx)).reshape(-1)),
        (sx + 1, (fy * fx).reshape(-1)),
    ):
        np.add.at(w, (rayf[vf], base[vf] + off), wgt[vf])
    w /= count[:, None]
    return w.astype(np.float32)


def _butterfly_kernel() -> np.ndarray:
    """9 x 9 band-enhancing "butterfly" kernel: a positive core along
    constant rho, negative lobes above and below."""
    k = np.zeros((9, 9))
    k[3:6, :] = 1.0
    k[4, :] = 2.0
    k[0:2, :] = -1.0
    k[7:9, :] = -1.0
    return k / np.abs(k).sum()


@lru_cache(maxsize=8)
def _radon_butterfly_matrix(sy: int, sx: int, n_theta: int, n_rho: int) -> np.ndarray:
    """The butterfly enhancement (its rho edge padding and theta wrap with
    the rho axis mirrored, :func:`_enhance`) folded into the Radon operator:
    ``pattern -> enhanced Radon space`` as one ``(n_rho * n_theta, sy *
    sx)`` operator, built on the host by accumulating each of the 81 taps
    over reindexed rows of :func:`_radon_matrix` (JAX's, bit for bit)."""
    R3 = _radon_matrix(sy, sx, n_theta, n_rho).reshape(n_rho, n_theta, -1)
    k = _butterfly_kernel()
    out = np.zeros_like(R3)
    r_out = np.arange(n_rho)[:, None]
    t_out = np.arange(n_theta)[None, :]
    for i in range(9):
        for j in range(9):
            wgt = k[i, j]
            if wgt == 0.0:
                continue
            tt = t_out + j - 4
            wrapped = (tt < 0) | (tt >= n_theta)
            t_src = tt % n_theta
            rp = r_out + i  # padded-rho coordinate of this tap
            rp_eff = np.where(wrapped, n_rho + 7 - rp, rp)
            r_src = np.clip(rp_eff - 4, 0, n_rho - 1)
            out += wgt * R3[r_src, t_src]
    return out.reshape(n_rho * n_theta, -1)


@lru_cache(maxsize=4)
def _device_operator(fused: bool, sy: int, sx: int, n_theta: int, n_rho: int, device: str) -> torch.Tensor:
    """The device copy of the Radon operator (``fused``: with the butterfly
    folded in), uploaded once per shape and device."""
    host = (_radon_butterfly_matrix if fused else _radon_matrix)(sy, sx, n_theta, n_rho)
    return torch.as_tensor(host, device=device)


def _patterns(patterns, device) -> torch.Tensor:
    if isinstance(patterns, torch.Tensor) and device is None:
        return patterns.to(torch.float32)
    return as_tensor(patterns, resolve_device(device), torch.float32)


def _operator_product(flat: torch.Tensor, op: torch.Tensor) -> torch.Tensor:
    """``flat @ op.T`` in IEEE float32 (JAX's ``Precision.HIGHEST``)."""
    with matmul_precision(False):
        return torch.matmul(flat, op.T)


def radon_transform(patterns, n_theta: int = 90, n_rho: int = 96, device=None) -> torch.Tensor:
    """Discrete Radon transform of a pattern batch ``(..., sy, sx)``: one
    float32 product with the ray-weight operator. Returns sinograms ``(...,
    n_rho, n_theta)`` float32, each ray normalized by its valid samples.
    A tensor runs on its own device unless ``device`` is given; an array on
    ``device`` (``None``: the card)."""
    p = _patterns(patterns, device)
    sy, sx = p.shape[-2:]
    lead = tuple(p.shape[:-2])
    w = _device_operator(False, sy, sx, n_theta, n_rho, str(p.device))
    out = _operator_product(p.reshape(-1, sy * sx), w)
    return out.reshape(lead + (n_rho, n_theta))


def _enhance(flat: torch.Tensor) -> torch.Tensor:
    """Butterfly-enhance sinograms ``(b, 1, n_rho, n_theta)`` -> ``(b,
    n_rho, n_theta)``: rho edge-padded by 4, then theta wrapped by 4 columns
    a side with the padded rho axis mirrored (the line at theta + pi is the
    line at theta with rho -> -rho), then the 9 x 9 cross-correlation in
    IEEE float32."""
    kernel = torch.as_tensor(_butterfly_kernel(), dtype=torch.float32, device=flat.device)[None, None]
    padded = F.pad(flat, (0, 0, 4, 4), mode="replicate")
    left = torch.flip(padded, dims=[2])[..., -4:]
    right = torch.flip(padded, dims=[2])[..., :4]
    padded = torch.cat([left, padded, right], dim=-1)
    with matmul_precision(False):
        return F.conv2d(padded, kernel)[:, 0]


def _peak_pick(enhanced: torch.Tensor, n_bands: int):
    """3 x 3 non-maximum suppression (``-inf`` padding, theta not wrapped)
    and the top ``n_bands`` peaks of ``(b, n_rho, n_theta)``, equal scores
    in index order (``jax.lax.top_k``'s)."""
    n_theta = enhanced.shape[-1]
    nms = F.max_pool2d(enhanced[:, None], kernel_size=3, stride=1, padding=1)[:, 0]
    is_peak = (enhanced >= nms) & (enhanced > 0)
    scores = torch.where(is_peak, enhanced, -torch.inf).reshape(enhanced.shape[0], -1)
    top_scores, top_idx = topk_stable(scores, n_bands)
    top_idx = top_idx.to(torch.int32)
    return top_idx // n_theta, top_idx % n_theta, top_scores


def detect_bands(sinograms, n_bands: int = 9, device=None):
    """Band peaks in Radon space after butterfly enhancement and 3 x 3
    non-maximum suppression: ``(rho_idx, theta_idx, intensity)``, each
    ``(..., n_bands)``."""
    s = _patterns(sinograms, device)
    lead = tuple(s.shape[:-2])
    n_rho, n_theta = s.shape[-2:]
    enhanced = _enhance(s.reshape(-1, 1, n_rho, n_theta))
    rho_idx, theta_idx, top_scores = _peak_pick(enhanced, n_bands)
    shape = lead + (n_bands,)
    return rho_idx.reshape(shape), theta_idx.reshape(shape), top_scores.reshape(shape)


def detect_bands_refined(sinograms, n_bands: int = 9, device=None):
    """:func:`detect_bands` with each peak refined to sub-bin precision (a
    parabola through the response at the peak and its neighbours along rho
    and along theta, which wraps) and the band's width (the FWHM of the
    response along rho, in rho bins). Returns ``(rho, theta, intensity,
    width)``, each ``(..., n_bands)`` float32."""
    s = _patterns(sinograms, device)
    lead = tuple(s.shape[:-2])
    n_rho, n_theta = s.shape[-2:]
    enhanced = _enhance(s.reshape(-1, 1, n_rho, n_theta))
    rho, theta, top_scores, width, _, _ = _refine_from_enhanced(enhanced, n_bands)
    shape = lead + (n_bands,)
    return rho.reshape(shape), theta.reshape(shape), top_scores.reshape(shape), width.reshape(shape)


def _refine_from_enhanced(enhanced: torch.Tensor, n_bands: int):
    """Peak pick, sub-bin refinement and FWHM widths from an enhanced Radon
    space ``(b, n_rho, n_theta)``: ``(rho, theta, intensity, width, rho_idx,
    theta_idx)``."""
    n_rho, n_theta = enhanced.shape[-2:]
    rho_idx, theta_idx, top_scores = _peak_pick(enhanced, n_bands)
    b = enhanced.shape[0]
    batch = torch.arange(b, device=enhanced.device)[:, None]

    def at(dr, dt):
        # The theta wrap carries the rho mirror (theta + pi <=> rho -> -rho).
        t_raw = theta_idx + dt
        wrapped = (t_raw < 0) | (t_raw >= n_theta)
        t = t_raw % n_theta
        r_raw = rho_idx + dr
        r = torch.where(wrapped, n_rho - 1 - r_raw, r_raw)
        r = torch.clamp(r, 0, n_rho - 1)
        return enhanced[batch, r.long(), t.long()]

    c = at(0, 0)

    def subpix(fm, f0, fp):
        # x0 = (f(-1) - f(+1)) / (2 (f(-1) - 2 f(0) + f(+1))), clamped to +-0.5.
        denom = fm - 2 * f0 + fp
        off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (fm - fp) / denom, 0.0)
        return torch.clamp(off, -0.5, 0.5)

    rho_off = subpix(at(-1, 0), c, at(1, 0))
    theta_off = subpix(at(0, -1), c, at(0, 1))
    # Peaks at the rho border have a clipped neighbour; they stay integer.
    rho_off = torch.where((rho_idx == 0) | (rho_idx == n_rho - 1), 0.0, rho_off)
    rho = rho_idx.to(torch.float32) + rho_off
    theta = theta_idx.to(torch.float32) + theta_off

    # FWHM along rho of the response at the peak's theta column: the
    # interpolated half-maximum crossing nearest the peak on each side.
    prof = enhanced.transpose(1, 2)[batch, theta_idx.long()]  # (b, k, n_rho)
    half = 0.5 * c[..., None]
    rr = torch.arange(n_rho, device=enhanced.device)[None, None, :]
    peak_r = rho_idx[..., None]
    below = prof < half
    left = torch.amax(torch.where(below & (rr <= peak_r), rr, -1), dim=-1)
    right = torch.amin(torch.where(below & (rr >= peak_r), rr, n_rho), dim=-1)

    def frac(idx_below, step):
        # Linear interpolation between the below-half bin and its inward neighbour.
        i0 = torch.clamp(idx_below, 0, n_rho - 1)
        i1 = torch.clamp(idx_below + step, 0, n_rho - 1)
        f0 = torch.take_along_dim(prof, i0[..., None].long(), dim=-1)[..., 0]
        f1 = torch.take_along_dim(prof, i1[..., None].long(), dim=-1)[..., 0]
        h = half[..., 0]
        return torch.where(torch.abs(f1 - f0) > 1e-12, (h - f0) / (f1 - f0), 0.5)

    left_edge = torch.where(left < 0, 0.0, left.to(torch.float32) + frac(left, 1))
    right_edge = torch.where(right > n_rho - 1, float(n_rho - 1), right.to(torch.float32) - frac(right, -1))
    width = torch.clamp(right_edge - left_edge, min=1.0)
    return rho, theta, top_scores, width, rho_idx, theta_idx


def detect_bands_fused(patterns, n_theta: int = 180, n_rho: int = 96, n_bands: int = 9, device=None):
    """Bands straight from patterns ``(..., sy, sx)`` through the fused
    Radon-butterfly operator (:func:`_radon_butterfly_matrix`): ``(rho,
    theta, intensity, width, rho_idx, theta_idx)``, the sub-bin refined
    coordinates and the integer peak bins, each ``(..., n_bands)``."""
    p = _patterns(patterns, device)
    sy, sx = p.shape[-2:]
    lead = tuple(p.shape[:-2])
    rb = _device_operator(True, sy, sx, n_theta, n_rho, str(p.device))
    enhanced = _operator_product(p.reshape(-1, sy * sx), rb).reshape(-1, n_rho, n_theta)
    out = _refine_from_enhanced(enhanced, n_bands)
    return tuple(a.reshape(lead + (n_bands,)) for a in out)


def bands_to_normals(
    rho_idx: np.ndarray,
    theta_idx: np.ndarray,
    detector,
    n_theta: int = 90,
    n_rho: int = 96,
    return_rho_g: bool = False,
) -> np.ndarray:
    """Unit band-plane normals in the sample frame ``(..., n_bands, 3)``
    (NumPy float64) from Radon peaks (integer or sub-bin). A band at (rho,
    theta) about the pattern center lies in the plane through the beam
    source and the detector line; its normal in the gnomonic frame is ``(cos
    t, -sin t, -rho_g)`` with ``rho_g`` the line's gnomonic offset from the
    PC. With ``return_rho_g`` also the offsets ``(..., n_bands)``."""
    sy, sx = detector.shape
    cy, cx = (sy - 1) / 2, (sx - 1) / 2
    radius = min(cy, cx)
    pcx, pcy, pcz = detector.pc_average

    thetas = np.asarray(theta_idx) * (np.pi / n_theta)
    rhos = np.asarray(rho_idx) / (n_rho - 1) * 2 * radius - radius
    # The PC in pixel-center coordinates: the projector puts pixel (row, col)
    # at gnomonic x = x0 + (col + 0.5) * x_scale.
    pc_px = np.array([pcx * sx - 0.5, pcy * sy - 0.5])
    d_px = rhos - ((pc_px[0] - cx) * np.cos(thetas) + (pc_px[1] - cy) * np.sin(thetas))
    # Gnomonic y points up, pixel y down: the sine component flips.
    rho_g = d_px / (pcz * sy)
    n_det = np.stack([np.cos(thetas), -np.sin(thetas), -rho_g], axis=-1)
    n_det /= np.linalg.norm(n_det, axis=-1, keepdims=True)
    normals = n_det @ np.asarray(detector.detector_to_sample).T
    if return_rho_g:
        return normals, rho_g
    return normals


def _refit_orientations(R: torch.Tensor, normals: torch.Tensor, g_unit: torch.Tensor, tol: float):
    """Polish voted orientations with (sub-bin refined) band normals: each
    band takes the pole nearest its mapping ``R n`` with that pole's sign,
    and the inlier pairs are solved by weighted Kabsch (``U diag(1, 1, s)
    V^T``, ``s`` the sign of ``det U det V^T``); fewer than 2 inliers keep
    the voted R. Returns ``(R, mean_err, n_inliers)``."""
    _, cos32 = candidate_threshold(tol)
    mapped = torch.einsum("nab,nqb->nqa", R, normals)
    dots = torch.einsum("nqa,ga->nqg", mapped, g_unit)
    j = torch.argmax(torch.abs(dots), dim=-1)  # (n, nb), the first on a tie
    d_best = torch.take_along_dim(dots, j[..., None], dim=-1)[..., 0]
    sign = torch.where(d_best >= 0, 1.0, -1.0)
    target = sign[..., None] * g_unit[j]
    w = (torch.abs(d_best) > cos32).to(torch.float32)

    M = torch.einsum("nq,nqa,nqb->nab", w, target, normals)
    U, _, Vt = torch.linalg.svd(M)
    s = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.stack([torch.ones_like(s), torch.ones_like(s), s], dim=-1)
    R_ref = torch.einsum("nab,nb,nbc->nac", U, D, Vt)
    enough = torch.sum(w, dim=-1) >= 2
    R_out = torch.where(enough[:, None, None], R_ref, R)

    mapped2 = torch.einsum("nab,nqb->nqa", R_out, normals)
    cosang = torch.clamp(torch.amax(torch.abs(torch.einsum("nqa,ga->nqg", mapped2, g_unit)), dim=-1), 0.0, 1.0)
    inlier = cosang > cos32
    n_in = torch.sum(inlier, dim=-1, dtype=torch.int32)
    err = torch.sum(torch.arccos(cosang) * inlier, dim=-1) / torch.clamp(n_in, min=1)
    err = torch.where(n_in > 0, err, torch.inf)
    return R_out, err, n_in


def _poles_and_lut(phase, reflectors, min_dspacing: float, voltage_kv: float):
    """Unique unit reciprocal-lattice poles (``+-g`` collapsed) and the
    interplanar-angle LUT of triplet voting, ``(g_unit, lut_angles,
    lut_pairs)`` (NumPy), from the phase's lattice unless ``reflectors`` is
    given."""
    from kikuchipy_tpu_torch.crystallography.reciprocal import Lattice, ReciprocalLatticeVectors

    if reflectors is None:
        lattice = phase.lattice
        if hasattr(lattice, "a"):  # a Lattice, not a 6-tuple
            lattice = (lattice.a, lattice.b, lattice.c, lattice.alpha, lattice.beta, lattice.gamma)
        abc = [float(v) for v in lattice[:3]]
        angles = [float(v) for v in lattice[3:6]]
        # EMsoft stores lattice parameters in nm; no real crystal has a < 2 A.
        if max(abc) < 2.0:
            abc = [v * 10 for v in abc]
        lat = Lattice(*abc, *angles)
        rlv = ReciprocalLatticeVectors.from_min_dspacing(lat, min_dspacing)
        if phase.atoms:
            # EMsoft phases carry asymmetric-unit atoms: expanded by the space
            # group, so screw and glide extinctions hold too.
            rlv.calculate_structure_factor(phase.atoms, space_group=phase.space_group)
            rlv = rlv.allowed()
        rlv.calculate_theta(voltage_kv)
        reflectors = rlv
    g_unit = reflectors.unit
    canon = np.where((g_unit[:, 2:3] < 0) | ((g_unit[:, 2:3] == 0) & (g_unit[:, 1:2] < 0)), -g_unit, g_unit)
    g_unit = np.unique(np.round(canon, 6), axis=0)

    pairs = list(combinations(range(len(g_unit)), 2))
    lut_pairs = np.asarray(pairs)
    lut_angles = np.array([np.arccos(np.clip(abs(g_unit[a] @ g_unit[b]), 0, 1)) for a, b in pairs])
    return g_unit, lut_angles, lut_pairs


def _pair_index(n_bands: int) -> np.ndarray:
    """The detected-band pairs the vote tries: those of the first
    ``min(n_bands, 6)`` bands."""
    return np.asarray(list(combinations(range(min(n_bands, 6)), 2)), dtype=np.int32)


def _vote_and_polish(normals, normals_ref, g_unit, lut_angles, lut_pairs, pair_idx, tol, chunk, device):
    """Triplet voting over the integer-peak normals (one launch of kernel H
    on the card; ``chunk`` bounds the plain version's intermediate) and three
    rounds of assignment and weighted Kabsch on the sub-bin refined normals.
    Returns ``(R (n, 3, 3), err, n_in)``."""
    g = torch.as_tensor(np.asarray(g_unit), dtype=torch.float32, device=device)
    R_all, _, _ = vote_orientations(
        torch.as_tensor(np.asarray(normals), dtype=torch.float32, device=device), g,
        torch.as_tensor(np.asarray(lut_angles), dtype=torch.float32, device=device),
        torch.as_tensor(np.asarray(lut_pairs), dtype=torch.int32, device=device),
        torch.as_tensor(np.asarray(pair_idx), dtype=torch.int32, device=device),
        tol, chunk=chunk,
    )
    normals_ref = torch.as_tensor(np.asarray(normals_ref), dtype=torch.float32, device=device)
    err = nin = None
    for _ in range(3):
        R_all, err, nin = _refit_orientations(R_all, normals_ref, g, tol)
    return R_all, err, nin


def _phase_of(signal, phase_list, what: str) -> Phase:
    if isinstance(phase_list, Phase):
        phase = phase_list
    elif isinstance(phase_list, PhaseList):
        phase = phase_list[phase_list.ids[0]]
    else:
        phase = signal.xmap.phases[0] if signal.xmap else None
    if phase is None or phase.lattice is None:
        raise ValueError(f"{what} requires a phase with lattice parameters")
    return phase


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def hough_indexing(
    signal,
    phase_list: PhaseList | Phase | None = None,
    reflectors=None,
    n_bands: int = 9,
    n_theta: int = 180,
    n_rho: int = 96,
    angle_tol_deg: float = 2.0,
    min_dspacing: float = 1.0,
    voltage_kv: float = 20.0,
    chunk: int = 1024,
) -> CrystalMap:
    """Index a scan by Hough band detection and triplet voting.

    Parameters
    ----------
    signal
        :class:`~kikuchipy_tpu_torch.signals.ebsd.EBSD` signal (preprocessed
        patterns work best); the work runs on its device.
    phase_list
        Phase (with lattice and space or point group) to index against.
    reflectors
        Optional :class:`~kikuchipy_tpu_torch.crystallography.reciprocal.
        ReciprocalLatticeVectors`; from the phase's lattice when not given.
    chunk
        Patterns a chunk of the plain vote (the CPU's); the card votes all
        patterns in one launch of kernel H.

    Returns
    -------
    CrystalMap with rotations, ``fit`` (mean inlier angle error, degrees),
    ``nbands`` (inlier bands), ``band_intensity``, ``band_width`` (mean band
    FWHM in gnomonic units) and ``band_theta`` (each band's first-order Bragg
    angle estimate, radians).
    """
    phase = _phase_of(signal, phase_list, "Hough indexing")
    device = signal.data.device
    g_unit, lut_angles, lut_pairs = _poles_and_lut(phase, reflectors, min_dspacing, voltage_kv)

    # Integer peaks drive the vote; sub-bin refined peaks the polish and the
    # widths.
    rho_ref, theta_ref, intensity, width, rho_idx, theta_idx = (
        _numpy(a).reshape(-1, n_bands)
        for a in detect_bands_fused(signal.data, n_theta=n_theta, n_rho=n_rho, n_bands=n_bands)
    )
    normals = bands_to_normals(rho_idx, theta_idx, signal.detector, n_theta=n_theta, n_rho=n_rho)
    normals_ref, rho_g = bands_to_normals(rho_ref, theta_ref, signal.detector, n_theta=n_theta, n_rho=n_rho,
                                          return_rho_g=True)
    # Band width: rho bins -> pixels -> gnomonic units; first-order Bragg
    # angle tan(theta_B) ~ w_g / (2 (1 + rho_g^2)).
    sy, sx = signal.detector.shape
    radius = min((sy - 1) / 2, (sx - 1) / 2)
    pcz = signal.detector.pc_average[2]
    width_g = width / (n_rho - 1) * 2 * radius / (pcz * sy)
    band_theta = np.arctan(width_g / (2.0 * (1.0 + rho_g**2)))

    n = normals.shape[0]
    tol = np.deg2rad(angle_tol_deg)
    R_all, err_ref, nin_ref = _vote_and_polish(normals, normals_ref, g_unit, lut_angles, lut_pairs,
                                               _pair_index(n_bands), tol, chunk, device)
    quats = quat.from_matrix(R_all)
    err = _numpy(err_ref)
    fit = np.where(np.isfinite(err), np.rad2deg(err), np.nan)
    nbands = _numpy(nin_ref).astype(np.int32)
    quats = reduce_to_fundamental_zone(quats, phase.get_point_group().proper_name, device=device)

    nav_shape = signal.navigation_shape
    return CrystalMap(
        rotations=quats,
        shape=nav_shape if len(nav_shape) == 2 else (n,),
        prop={
            "fit": fit,
            "nbands": nbands,
            "band_intensity": intensity.mean(axis=1),
            "band_width": width_g.mean(axis=1),
            "band_theta": band_theta,
        },
        phases=PhaseList(phase),
    )


def _pc_band_misfit(pc_b, cos_t, sin_t, rho_px, targets, w, d2s, sy, sx):
    """Each pattern's weighted mean angular misfit (radians) between the
    band normals its PC ``pc_b (n, 3)`` implies and its fixed pole
    directions (sample frame): :func:`bands_to_normals` in PyTorch with the
    PC an operand."""
    cy, cx = (sy - 1) / 2.0, (sx - 1) / 2.0
    px = pc_b[:, 0:1] * sx - 0.5
    py = pc_b[:, 1:2] * sy - 0.5
    d_px = rho_px - ((px - cx) * cos_t + (py - cy) * sin_t)
    rho_g = d_px / (pc_b[:, 2:3] * sy)
    n_det = torch.stack([cos_t, -sin_t, -rho_g], dim=-1)  # (n, nb, 3)
    n_det = n_det / torch.linalg.norm(n_det, dim=-1, keepdim=True)
    normals = n_det @ d2s.T
    c = torch.clamp(torch.abs(torch.sum(normals * targets, dim=-1)), 0.0, 1.0)
    ang = torch.arccos(c)
    return torch.sum(ang * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1e-9)


def _normals_at_pcs(rho_ref, theta_ref, pc_b, detector, n_theta: int, n_rho: int) -> np.ndarray:
    """:func:`bands_to_normals` with one PC a pattern (``pc_b (n, 3)``)."""
    sy, sx = detector.shape
    cy, cx = (sy - 1) / 2.0, (sx - 1) / 2.0
    radius = min(cy, cx)
    thetas = np.asarray(theta_ref) * (np.pi / n_theta)
    rhos = np.asarray(rho_ref) / (n_rho - 1) * 2 * radius - radius
    pc_b = np.asarray(pc_b, dtype=np.float64)
    px = pc_b[:, 0:1] * sx - 0.5
    py = pc_b[:, 1:2] * sy - 0.5
    d_px = rhos - ((px - cx) * np.cos(thetas) + (py - cy) * np.sin(thetas))
    rho_g = d_px / (pc_b[:, 2:3] * sy)
    n_det = np.stack([np.cos(thetas), -np.sin(thetas), -rho_g], axis=-1)
    n_det /= np.linalg.norm(n_det, axis=-1, keepdims=True)
    return n_det @ np.asarray(detector.detector_to_sample).T


def _optimize_pc_from_bands(
    rho_ref: np.ndarray,
    theta_ref: np.ndarray,
    R: np.ndarray,
    g_unit: np.ndarray,
    detector,
    pc0: np.ndarray,
    n_theta: int = 180,
    n_rho: int = 96,
    angle_tol_deg: float = 2.0,
    trust_region=(0.05, 0.05, 0.05),
    max_iters: int = 80,
    bounds: tuple[np.ndarray, np.ndarray] | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Freeze each band's pole assignment under the orientations ``R`` at
    ``pc0``, then one batched Nelder-Mead over all patterns' PCs on the
    band-to-pole misfit, on ``device`` (``None``: the card). ``bounds``
    (``(lo, hi)``) fixes the box apart from the start. Returns ``(pc (n, 3),
    misfit (n,) radians)``."""
    from kikuchipy_tpu_torch.utils.optimize import nelder_mead_batched

    dev = resolve_device(device)
    sy, sx = detector.shape
    cy, cx = (sy - 1) / 2.0, (sx - 1) / 2.0
    radius = min(cy, cx)
    tol = np.deg2rad(angle_tol_deg)
    pc0 = np.broadcast_to(np.asarray(pc0, dtype=np.float64).reshape(-1, 3), (rho_ref.shape[0], 3))

    # The band lines in pixel coordinates do not depend on the PC.
    thetas = np.asarray(theta_ref) * (np.pi / n_theta)
    rho_px = np.asarray(rho_ref) / (n_rho - 1) * 2 * radius - radius

    # Band i of pattern j maps to the pole argmax |g . (R n_i(pc0))| with its
    # sign; bands outside the voting tolerance weigh 0.
    normals0 = _normals_at_pcs(rho_ref, theta_ref, pc0, detector, n_theta, n_rho)
    mapped = np.einsum("nab,nqb->nqa", R, normals0)
    dots = np.einsum("nqa,ga->nqg", mapped, g_unit)
    j = np.argmax(np.abs(dots), axis=-1)
    d_best = np.take_along_axis(dots, j[..., None], axis=-1)[..., 0]
    sign = np.where(d_best >= 0, 1.0, -1.0)
    w = (np.abs(d_best) > np.cos(tol)).astype(np.float32)
    # Fixed sample-frame targets s_i = R^T (sign g[j]).
    targets = np.einsum("nba,nqb->nqa", R, sign[..., None] * g_unit[j])

    tr = np.asarray(trust_region, dtype=np.float64)
    lo, hi = bounds if bounds is not None else (pc0 - tr, pc0 + tr)

    def f32(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=dev)

    res = nelder_mead_batched(
        _pc_band_misfit,
        f32(pc0),
        initial_step=f32(np.minimum(tr / 4.0, 0.01)),
        max_iters=max_iters,
        fatol=1e-7,
        xatol=1e-5,
        lower_bounds=f32(lo),
        upper_bounds=f32(hi),
        args=(f32(np.cos(thetas)), f32(np.sin(thetas)), f32(rho_px), f32(targets), f32(w),
              f32(detector.detector_to_sample)),
        static_args=(sy, sx),
    )
    return _numpy(res.x).astype(np.float64), _numpy(res.fun)


def optimize_pc_batched(
    signal,
    pc0=None,
    phase_list=None,
    reflectors=None,
    trust_region=(0.05, 0.05, 0.05),
    max_iters: int = 80,
    n_bands: int = 9,
    n_theta: int = 180,
    n_rho: int = 96,
    angle_tol_deg: float = 2.0,
    min_dspacing: float = 1.0,
    voltage_kv: float = 20.0,
    chunk: int = 1024,
) -> np.ndarray:
    """One projection center a pattern from Hough bands (kikuchipy's
    ``hough_indexing_optimize_pc(batch=True)``): bands detected once (their
    pixel positions do not depend on the PC), orientations voted and
    polished at ``pc0``, then four rounds of a batched Nelder-Mead over all
    patterns' ``(PCx, PCy, PCz)`` on the band-to-pole misfit at frozen
    assignments, each followed by two Kabsch refits at the new PCs. Runs on
    the signal's device. Returns ``(n_patterns, 3)`` PCs."""
    phase = _phase_of(signal, phase_list, "Per-pattern PC optimization")
    device = signal.data.device
    detector = signal.detector
    if pc0 is None:
        pc0 = detector.pc_average
    pc0 = np.asarray(pc0, dtype=np.float64)
    det0 = dataclasses.replace(detector, pc=pc0.reshape(-1, 3)[:1])

    g_unit, lut_angles, lut_pairs = _poles_and_lut(phase, reflectors, min_dspacing, voltage_kv)
    rho_ref, theta_ref, _, _, rho_idx, theta_idx = (
        _numpy(a).reshape(-1, n_bands)
        for a in detect_bands_fused(signal.data, n_theta=n_theta, n_rho=n_rho, n_bands=n_bands)
    )
    n = rho_ref.shape[0]

    normals = bands_to_normals(rho_idx, theta_idx, det0, n_theta=n_theta, n_rho=n_rho)
    normals_ref = bands_to_normals(rho_ref, theta_ref, det0, n_theta=n_theta, n_rho=n_rho)
    tol = np.deg2rad(angle_tol_deg)
    g = torch.as_tensor(g_unit, dtype=torch.float32, device=device)
    R_all, _, _ = _vote_and_polish(normals, normals_ref, g_unit, lut_angles, lut_pairs, _pair_index(n_bands), tol,
                                   chunk, device)

    # Alternating descent: PC by Nelder-Mead at fixed orientations and
    # assignments, then the orientations by Kabsch at the new PCs.
    tr = np.asarray(trust_region, dtype=np.float64)
    pc_flat = np.broadcast_to(pc0.reshape(-1, 3), (n, 3))
    box = (pc_flat - tr, pc_flat + tr)
    pc = pc_flat
    for _ in range(4):
        pc, _ = _optimize_pc_from_bands(
            rho_ref, theta_ref, _numpy(R_all), g_unit, det0, pc,
            n_theta=n_theta, n_rho=n_rho, angle_tol_deg=angle_tol_deg,
            trust_region=trust_region, max_iters=max_iters, bounds=box, device=device,
        )
        normals_pc = torch.as_tensor(_normals_at_pcs(rho_ref, theta_ref, pc, det0, n_theta, n_rho),
                                     dtype=torch.float32, device=device)
        for _ in range(2):
            R_all, _, _ = _refit_orientations(R_all, normals_pc, g, tol)
    return pc


@dataclasses.dataclass
class HoughIndexer:
    """A configured Hough indexer: detector geometry, phases and band
    detection settings bundled for reuse (the role of the PyEBSDIndex
    ``EBSDIndexer`` that kikuchipy's ``EBSDDetector.get_indexer`` returns).
    Obtain one with ``detector.get_indexer(phase_list)``; call :meth:`index`
    or pass it to ``EBSD.hough_indexing(indexer=...)``."""

    detector: object
    phase_list: object
    reflectors: object = None
    kwargs: dict = dataclasses.field(default_factory=dict)

    def __init__(self, detector, phase_list, reflectors=None, **kwargs):
        self.detector = detector
        self.phase_list = phase_list
        self.reflectors = reflectors
        self.kwargs = kwargs

    def index(self, signal, **overrides) -> CrystalMap:
        """Hough-index an :class:`EBSD` signal (or a raw pattern tensor, on
        its device, or array, on the card) with this indexer's
        configuration."""
        from kikuchipy_tpu_torch.signals.ebsd import EBSD

        if isinstance(signal, torch.Tensor):
            signal = EBSD(data=signal, device=signal.device)
        elif not isinstance(signal, EBSD):
            signal = EBSD(data=np.asarray(signal))
        if self.detector is not None:
            signal = dataclasses.replace(signal, detector=self.detector)
        kw = dict(self.kwargs)
        kw.update(overrides)
        phase_list = kw.pop("phase_list", self.phase_list)
        reflectors = kw.pop("reflectors", self.reflectors)
        return hough_indexing(signal, phase_list=phase_list, reflectors=reflectors, **kw)
