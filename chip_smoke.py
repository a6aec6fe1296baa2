"""Drive kikuchipy_tpu_torch's main path once on a CUDA card and check it.

    python3 chip_smoke.py [--seed 0]

Phases, one output line each (the last two lines are the kernel table
and the device check):

1. device: ``nvidia-smi`` name and power limit, and torch's device name;
2. build: every kernel under ``kikuchipy_tpu_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version on the card, on small
   cases with planted ties and on a slab at the main-path shape: scores
   and indices must agree bit for bit;
4. the main path at full size, from a seed: a synthetic m-3m master
   pattern (401 x 401 per hemisphere), a 60 x 60 detector, a 2-degree
   fundamental-zone dictionary (107,129 orientations), a 128 x 128 uint8
   scan at known orientations -> static and dynamic background removal
   -> dictionary projection -> ``EBSD.dictionary_indexing(precision=
   "pallas-int8", keep_n=20)`` -> ``CrystalMap``. Checks: the kernel ran,
   top-1 equals the exact ``"highest"`` tier wherever the exact top-1/
   top-2 gap exceeds 1e-4, and the orientations are recovered (median
   disorientation < 3 degrees, > 90% under 8 degrees);
5. times from CUDA events after a warm-up, beside the card's name and
   power limit.

Exits non-zero without a CUDA device, when run outside a checkout of the
repository, or when any check fails. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# Card peaks for the bound (H100 SXM data sheet, dense): int8 tensor-core
# operations per second and device-memory bytes per second.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

SCAN_SIDE = 128
DETECTOR_SHAPE = (60, 60)
PC = (0.42, 0.28, 0.5)
MASTER_SIDE = 401
RESOLUTION_DEG = 2.0
KEEP_N = 20
# (hkl family, relative intensity); band profile sigma is the full Bragg
# width 2*theta_B of Ni at 20 kV (a = 3.52 A, lambda = 0.0859 A).
BAND_FAMILIES = (((1, 1, 1), 1.0), ((2, 0, 0), 0.8), ((2, 2, 0), 0.5), ((3, 1, 1), 0.35))
LATTICE_A = 3.52
WAVELENGTH = 0.0859


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------ inputs ------------------------------ #


def plane_normals(hkl) -> np.ndarray:
    """Unit normals of the {hkl} family under m-3m, one per +-pair."""
    import itertools

    seen, out = set(), []
    for perm in set(itertools.permutations(hkl)):
        for signs in itertools.product((1, -1), repeat=3):
            v = np.array(perm, dtype=np.float64) * signs
            if not v.any():
                continue
            key = tuple(v) if tuple(v) > tuple(-v) else tuple(-v)
            if key not in seen:
                seen.add(key)
                out.append(np.array(key) / np.linalg.norm(key))
    return np.array(out)


def master_pattern_data(side: int = MASTER_SIDE) -> np.ndarray:
    """Packed Lambert hemispheres ``(2, side, side)`` of a Gaussian band
    sum over full m-3m plane families: symmetric by construction."""
    import torch

    from kikuchipy_tpu_torch.geometry.lambert import lambert_to_vector

    lin = np.linspace(-1, 1, side)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    xy = torch.as_tensor(np.stack([xx, yy], axis=-1))
    v = lambert_to_vector(xy).numpy()
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    hemis = []
    for zsign in (1.0, -1.0):
        w = v * np.array([1.0, 1.0, zsign])
        img = np.zeros(w.shape[:-1])
        for hkl, weight in BAND_FAMILIES:
            d = LATTICE_A / np.sqrt(np.sum(np.square(hkl)))
            sigma = 2 * np.arcsin(WAVELENGTH / (2 * d))
            for n in plane_normals(hkl):
                img += weight * np.exp(-0.5 * (w @ n / sigma) ** 2)
        hemis.append(img)
    return np.stack(hemis).astype(np.float32)


def scan_data(mp, det, truth: np.ndarray, seed: int, chunk_size: int):
    """uint8 patterns at ``truth`` with a static background gradient and
    noise (the recipe of tests/test_system_synthetic.py)."""
    sim = mp.get_patterns(truth, det, dtype_out=np.float32, chunk_size=chunk_size).data
    lo = sim.amin(dim=(-2, -1), keepdim=True)
    hi = sim.amax(dim=(-2, -1), keepdim=True)
    pats = ((sim - lo) / (hi - lo)).cpu().numpy()
    sy, sx = det.shape
    yy, xx = np.indices((sy, sx))
    bg = 60 + 40 * np.exp(-((xx - sx / 2) ** 2 + (yy - sy / 2.4) ** 2) / (700 * (sy / 48) ** 2))
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(pats.shape, dtype=np.float32) * 6.0
    noisy = np.clip(pats * 120 + bg + noise, 0, 255).astype(np.uint8)
    return noisy, bg.astype(np.uint8)


# ------------------------ kernel vs plain ------------------------- #


def kernel_cases(device, seed: int, m_main: int, d: int, k: int):
    """Kernel-vs-plain cases: small ones with planted ties (group 1 and
    8) and a 1024-row slab at the main-path shape. Returns the slab's
    max |score difference|."""
    import torch

    from kikuchipy_tpu_torch.ops.ncc_topk import ncc_match_topk_int8, ncc_match_topk_int8_plain

    g = torch.Generator(device="cpu").manual_seed(seed)

    def operands(n, m, dd):
        e = torch.randint(-127, 128, (n, dd), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (m, dd), generator=g, dtype=torch.int8)
        sc = torch.rand(m, generator=g) * 0.01 + 1e-3
        # Planted ties: duplicated dictionary rows, and an all-zero row
        # whose scores are all equal.
        for j in (5, 40, m - 1):
            w[j], sc[j] = w[3], sc[3]
        e[1] = 0
        return e.to(device), w.to(device), sc.to(device)

    cases = [
        (64, 256, 128, 5, 8, 32, 1),
        (64, 256, 128, 5, 8, 32, 8),
        (100, 640, 3600, k, 4, 128, 1),
        (128, 1024, 200, k, 8, 512, 8),
        (72, 96, 48, 70, 8, 32, 4),
    ]
    for n, m, dd, kk, tile_n, tile_m, group in cases:
        e, w, sc = operands(n, m, dd)
        s1, i1 = ncc_match_topk_int8(e, w, sc, kk, tile_n, tile_m, group)
        torch.cuda.synchronize()
        s2, i2 = ncc_match_topk_int8_plain(e, w, sc, kk, tile_m, group)
        torch.cuda.synchronize()
        if not (torch.equal(s1, s2) and torch.equal(i1, i2)):
            raise AssertionError(f"kernel != plain at n={n} m={m} d={dd} k={kk} group={group}")
    slab = operands(1024, m_main, d)
    s1, i1 = ncc_match_topk_int8(*slab, k, 512, 512, 1)
    torch.cuda.synchronize()
    s2, i2 = ncc_match_topk_int8_plain(*slab, k, 512, 1)
    torch.cuda.synchronize()
    if not (torch.equal(s1, s2) and torch.equal(i1, i2)):
        raise AssertionError(f"kernel != plain on the 1024 x {m_main} x {d} slab")
    return float((s1 - s2).abs().max()), len(cases) + 1


# ----------------------------- timing ----------------------------- #


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    import kikuchipy_tpu_torch as kt

    here = Path(__file__).resolve().parent
    if Path(kt.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: kikuchipy_tpu_torch is not the checkout's ({kt.__file__})", file=sys.stderr)
        return 2
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.crystallography.sampling import (
        disorientation_angle,
        reduce_to_fundamental_zone,
        sample_fundamental_zone,
        super_fibonacci,
    )
    from kikuchipy_tpu_torch.indexing.di import _quantize_rows_int8, _rescore_candidates, topk_stable
    from kikuchipy_tpu_torch.indexing.metrics import get_metric
    from kikuchipy_tpu_torch.ops import _build
    from kikuchipy_tpu_torch.ops.ncc_topk import ncc_match_topk_int8, ncc_match_topk_int8_plain
    from kikuchipy_tpu_torch.projection.master_pattern import (
        direction_cosines_from_detector,
        project_patterns,
        quad_texture,
    )

    dev = torch.device("cuda")
    smi = smi_line()
    log("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build_all()
    regs = {n: [ln.split(":", 1)[1].strip() for ln in log_.splitlines() if "registers" in ln][:1]
            for n, log_ in _build.BUILD_LOG.items()}
    log("build", f"{sorted(built)} in {time.perf_counter() - t0:.1f} s; ptxas {regs}")

    # ---- inputs (seeded) ----
    t0 = time.perf_counter()
    mp = kt.EBSDMasterPattern(master_pattern_data(), phase=Phase(name="ni", point_group="m-3m"), device=dev)
    det = kt.EBSDDetector(shape=DETECTOR_SHAPE, pc=PC, sample_tilt=70)
    dict_rot = sample_fundamental_zone(RESOLUTION_DEG, "m-3m")
    n_scan = SCAN_SIDE * SCAN_SIDE
    truth = reduce_to_fundamental_zone(super_fibonacci(n_scan * 7)[::7][:n_scan], "m-3m")
    scan_u8, static_bg = scan_data(mp, det, truth, args.seed, chunk_size=8192)
    scan = kt.EBSD(
        scan_u8.reshape(SCAN_SIDE, SCAN_SIDE, *DETECTOR_SHAPE), detector=det,
        static_background=static_bg, device=dev,
    )
    torch.cuda.synchronize()
    m = dict_rot.shape[0]
    d = DETECTOR_SHAPE[0] * DETECTOR_SHAPE[1]
    m_main = (m // 512) * 512
    k_carry = max(2 * KEEP_N, KEEP_N + 8)
    log("inputs", f"scan {tuple(scan.data.shape)} uint8, dictionary {m} orientations (m_main {m_main}), "
        f"master {mp.data.shape}, seed {args.seed}, {time.perf_counter() - t0:.1f} s")

    # ---- kernel vs plain on the card ----
    max_err, n_cases = kernel_cases(dev, args.seed, m_main, d, k_carry)
    log("kernel-check", f"ncc_topk_int8 == plain bit for bit on {n_cases} cases "
        f"(1024 x {m_main} x {d} slab, k={k_carry}); max |score diff| {max_err}")

    # ---- main path ----
    ncc_match_topk_int8.launches = 0
    t0 = time.perf_counter()
    pre = scan.remove_static_background().remove_dynamic_background()
    dictionary = mp.get_patterns(dict_rot, det, chunk_size=8192)
    xmap = pre.dictionary_indexing(dictionary, keep_n=KEEP_N, precision="pallas-int8")
    torch.cuda.synchronize()
    launches = ncc_match_topk_int8.launches
    t_main = time.perf_counter() - t0
    if launches < 1:
        raise AssertionError("the main path did not launch ncc_topk_int8")
    scores = xmap.prop["scores"]
    idx = xmap.prop["simulation_indices"]
    if scores.shape != (n_scan, KEEP_N) or not np.isfinite(scores).all() or (idx < 0).any():
        raise AssertionError(f"bad indexing output: {scores.shape}, finite {np.isfinite(scores).all()}")

    exact = pre.dictionary_indexing(dictionary, keep_n=2, precision="highest")
    ex_s = exact.prop["scores"]
    ex_i = exact.prop["simulation_indices"]
    clear = (ex_s[:, 0] - ex_s[:, 1]) > 1e-4
    agree = idx[:, 0] == ex_i[:, 0]
    if not agree[clear].all():
        raise AssertionError(f"pallas-int8 top-1 differs from highest on {int((~agree[clear]).sum())} clear patterns")
    ang = np.degrees(disorientation_angle(truth, dict_rot[idx[:, 0]], "m-3m"))
    med, frac8 = float(np.median(ang)), float((ang < 8).mean())
    if not (med < 3.0 and frac8 > 0.9):
        raise AssertionError(f"orientations not recovered: median {med:.3f} deg, <8 deg {frac8:.4f}")
    log("main-path", f"{n_scan} patterns x {m} dictionary, pallas-int8 keep_n={KEEP_N}: kernel launches {launches}; "
        f"top-1 == highest on {int(clear.sum())}/{n_scan} clear-gap patterns (overall agreement "
        f"{agree.mean():.6f}); disorientation median {med:.4f} deg, <8 deg {frac8:.4f}; "
        f"first run {t_main:.2f} s")

    # ---- times ----
    ms_pre = cuda_ms(lambda: scan.remove_static_background().remove_dynamic_background(), 5)
    ms_proj = cuda_ms(lambda: mp.get_patterns(dict_rot, det, chunk_size=8192), 2)
    metric = get_metric("ncc")
    exp_q, _ = _quantize_rows_int8(metric.prepare(pre.data))
    dict_q, dict_scale = _quantize_rows_int8(metric.prepare(dictionary.data))
    kq, ks = dict_q[:m_main].contiguous(), dict_scale[:m_main].contiguous()
    ms_kernel = cuda_ms(lambda: ncc_match_topk_int8(exp_q, kq, ks, k_carry, 512, 512), 5)
    ms_plain = cuda_ms(lambda: ncc_match_topk_int8_plain(exp_q, kq, ks, k_carry, 512), 1)
    ms_lib = cuda_ms(lambda: torch._int_mm(exp_q, kq.T), 5)
    s_k, i_k = ncc_match_topk_int8(exp_q, kq, ks, k_carry, 512, 512)
    s_p, i_p = ncc_match_topk_int8_plain(exp_q, kq, ks, k_carry, 512)
    if not (torch.equal(s_k, s_p) and torch.equal(i_k, i_p)):
        raise AssertionError("kernel != plain on the main path's own operands")
    full_err = float((s_k - s_p).abs().max())
    ms_di = cuda_ms(lambda: pre.dictionary_indexing(dictionary, keep_n=KEEP_N, precision="pallas-int8"), 2)
    n_ops = 2.0 * n_scan * m_main * d
    n_bytes = n_scan * d + m_main * d + 4 * m_main + n_scan * k_carry * 8
    t_ops, t_bytes = n_ops / PEAK_INT8_OPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    mb = scan.data.numel() / 1e6
    log("times", f"{smi}: preprocess {ms_pre:.3f} ms ({mb / ms_pre * 1e3:.1f} MB/s uint8 in); "
        f"dictionary projection {ms_proj:.3f} ms ({m} patterns); "
        f"ncc_topk_int8 {ms_kernel:.3f} ms at n={n_scan} m={m_main} d={d} k={k_carry} "
        f"(bound {bound_ms:.3f} ms by operations, {bound_ms / ms_kernel:.2%} of it); "
        f"plain {ms_plain:.3f} ms; library yardstick torch._int_mm (product only, no top-k, "
        f"never called by the port) {ms_lib:.3f} ms; dictionary_indexing {ms_di:.3f} ms "
        f"= {n_scan / ms_di * 1e3:.1f} patterns/s")

    # ---- where the time of one indexing call and one projection chunk goes ----
    exp_prep = metric.prepare(pre.data)
    dict_prep = metric.prepare(dictionary.data)
    cand = i_k[:, :k_carry]
    quad = quad_texture(torch.as_tensor(mp._hemispheres_at_energy(), device=dev))
    dc = direction_cosines_from_detector(det, device=dev)
    rot_chunk = torch.as_tensor(dict_rot[:8192], dtype=torch.float32, device=dev)
    parts = {
        "prepare scan": lambda: metric.prepare(pre.data),
        "prepare dictionary": lambda: metric.prepare(dictionary.data),
        "quantize scan": lambda: _quantize_rows_int8(exp_prep),
        "quantize dictionary": lambda: _quantize_rows_int8(dict_prep),
        "remainder (exact)": lambda: topk_stable(exp_prep @ dict_prep[m_main:].T, k_carry),
        "rescore (exact)": lambda: _rescore_candidates(exp_prep, dict_prep, cand, KEEP_N),
        "project 8192 patterns": lambda: project_patterns(
            rot_chunk, dc, None, MASTER_SIDE, MASTER_SIDE, (MASTER_SIDE - 1) / 2, quad=quad
        ),
    }
    spent = {name: cuda_ms(fn, 3) for name, fn in parts.items()}
    log("breakdown", f"{smi}: kernel {ms_kernel:.3f} ms; " + "; ".join(f"{k} {v:.3f} ms" for k, v in spent.items()))

    if "jax" in sys.modules or "kikuchipy_tpu" in sys.modules:
        raise AssertionError("chip_smoke imported JAX or the JAX package")
    print(json.dumps({"kernels": [{
        "name": "ncc_topk_int8",
        "route": "cuda",
        "source": "kikuchipy_tpu_torch/csrc/ncc_topk_int8.cu",
        "replaces": "kikuchipy_tpu/ops/pallas_di.py:600",
        "launches": launches,
        "max_abs_err": full_err,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": ms_lib,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
