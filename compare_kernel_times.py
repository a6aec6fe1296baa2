"""Time the fused int8, bf16 and f32 NCC + top-k kernels and the projection
kernel (kernel A) of one checkout at the main-path shape, or with
``--preprocess`` its preprocessing kernels and calls, ``--neighbours``
kernel G, ``--hough`` kernel H, to compare two commits on one card.

    python3 compare_kernel_times.py --tree DIR [--reps 10]
        [--preprocess | --neighbours | --hough [--inputs PATH | --poles N]
         | --refine [--save PATH] [--against PATH] | --lm [--save PATH] [--against PATH]
         | --population [--save PATH] [--against PATH]]

``DIR`` is the root of a checkout (this one: ``.``). The script imports
``kikuchipy_tpu_torch`` and ``chip_smoke.py`` from ``DIR``, builds the
main path's operands from ``chip_smoke``'s seeded inputs (16,384 patterns
of 60 x 60, the 107,008 dictionary rows of whole 512-column tiles),
quantizes them, and times ``ncc_match_topk_int8``,
``ncc_match_topk_bf16`` and ``ncc_match_topk_f32`` at k=40 with CUDA
events after a warm-up (the f32 entry point's time holds whatever it does
to its operands on every call: the split into TF32 planes, where the
tree's kernel multiplies on the tensor cores), each beside the library's
product of the same operands (``torch._int_mm``, ``torch.matmul`` in bf16
and in f32 with TF32 off) and the card's clock, power and temperature
right after the kernel; first of all ``lambert_project`` on the whole
107,129 x 3600 dictionary and the ``get_patterns`` call that makes it (no
library call computes either). It prints one JSON line per kernel, with checksums of the results
(int8: equal between two commits that compute the same function; the
float kernels': equal up to near-ties and the order of their f32 sums).

With ``--preprocess`` the package still comes from ``DIR`` but the inputs
and timers from the ``chip_smoke.py`` beside this script, so an older
checkout is timed as this one is. One JSON line: kernel D's static mode on
the main path's scan (16,384 x 60 x 60 uint8 with its static background,
seed 0) and on it tiled 4x (65,536 patterns), its dynamic mode and kernel E
on the scan, each with launches back to back behind 2 ms of device sleep
(``ms``) and alone after the L2 is flushed (``ms_cold``), as
``chip_smoke.py`` ``[preprocess-times]`` times them;
``EBSD.remove_static_background()``'s call on the host clock, synchronized,
and under ``torch.profiler`` (``chip_smoke.call_breakdown``); the main
path's two removals as ``chip_smoke.py`` ``[times]`` takes them
(``ms_pre``); the tutorial chain's steps at both sizes (the median of three
timed runs); SHA-256 hashes of the three kernels' outputs on the scan,
equal between two commits that compute the same bytes; and the kernel each
chooser the tree has (``static_path``, ``dynamic_path``, ``clahe_path``)
picks at the main path's shape (null where the tree has none).

With ``--neighbours`` (kernel G) or ``--hough`` (kernel H) the package
comes from ``DIR`` and the inputs and timers from this script's
``chip_smoke.py``, as with ``--preprocess``. One JSON line each.
``--neighbours``: ``average_neighbours`` on the main path's scan (uint8,
seed 0) with the circular 3 x 3 window (5 taps: the main path), the
Gaussian 3 x 3 (9 taps, std 2), and the 13 x 13 rectangle (169 taps: the
device table), and on a 16 x 16 map of seeded 480 x 480 uint8 patterns (5
taps: the scratch past the shared-memory budget), each warm (``ms``) and
after the L2 is flushed (``ms_cold``), with SHA-256 hashes of the outputs
(equal between two commits that give the same bytes), and the
``EBSD.average_neighbour_patterns`` call on the host clock.
``--hough``: ``vote_orientations`` at ``[hough]``'s inputs (the scan after
both removals, its 9 bands' normals, nickel's 25 poles, the LUT and the 15
pairs) warm and cold, with the results' checksums; ``--inputs PATH`` keeps
those inputs in a file (made by the first run that finds none: the band
detection builds its operator on the host, about 30 s a process).
``--poles N`` times it instead on ``pole_set_inputs``' seeded set of N
random unit poles (past 1,024 the kernel streams them through shared
memory in tiles) with 16,384 patterns of 9 bands.

With ``--refine`` the package comes from ``DIR`` and the inputs from
``refine_variants.py``'s ``problem`` beside this script (16,384 points, a
60 x 60 detector, ``chip_smoke.py``'s seeded 401 x 401 master; patterns
projected at known orientations with noise, refined from 1.5 degrees off,
and in the PC modes from the PC off by (0.01, -0.01, 0.01)). One JSON line:
the Nelder-Mead kernel's three modes on the whole map, kernel B at 2,048
points (shared direction cosines) and kernel F at one DE generation of the
map in each mode (M = 24, 16, 16), each with CUDA events after a warm-up
and the card's clock right after it. ``--save PATH`` writes the outputs;
``--against PATH`` compares them with another tree's saved outputs: each
mode's share of points within 0.05 degrees and 1e-5 in PC, its mean score
against theirs, whether the two are bit for bit equal, and B's and F's
largest differences. ``--float64`` adds, on the first 2,048 points of each
mode, the tree's kernel, the host loop over the float32 plain twin and the
host loop over the float64 twin, each pair compared as ``chip_smoke.py``
``[refine-float64]`` compares the first two.

With ``--lm`` the package comes from ``DIR`` and the inputs from
``lm_variants.py``'s ``problem`` beside this script (the same map, starts
and PCs as ``--refine``'s, at ``refine_*``'s LM settings). One JSON line:
kernel C (one launch at the map's starts, ``x = 0``) and the
Levenberg-Marquardt loop kernel (one ``method="lm"`` launch for the map) in
each mode, with CUDA events after a warm-up and the card's clock right
after each, the loop's evaluations, and kernel C's outputs on the first
2,048 points against the plain version run on float64 operands where the
tree's plain version takes them (``|dg| / |g|``, ``|dJtJ| / |JtJ|``).
``--save PATH`` writes the outputs; ``--against PATH`` compares them with
another tree's: kernel C's largest differences, each loop's share of
points with 0.5 ||r||^2 within 1e-5, rotations within 0.05 degrees and PCs
within 1e-4, equal iterations, its mean 0.5 ||r||^2 against theirs, and
the other tree's kernel C against this tree's float64 plain version.

With ``--population`` the package comes from ``DIR`` and the inputs from
``refine_variants.py``'s ``problem`` and this script's ``chip_smoke.py``.
One JSON line: kernel F at one DE generation of the map (16,384 points, M =
24 / 16 / 16) in each mode at each spread of ``chip_smoke.POP_SPREADS``
(sigma 0.1 and 0.5 degrees, uniform in the trust region), and at M = 1 (a
DA step), each with CUDA events after a warm-up and the card's clock; then
the three DE calls as ``chip_smoke.py`` ``[refine-global*]`` makes them
(``EBSD.refine_*(method="de")`` on the static-corrected main-path scan,
trust regions of 3 degrees and 0.02, from the truth 1.5 degrees off and, in
the PC modes, the PC off by (0.01, -0.01, 0.01)), each call's DE results
recorded (``chip_smoke.recording_de``): its generations, the live share by
generation (from each point's ``n_iter``: a point runs until it converges),
kernel F's launches and summed ms under ``torch.profiler``, and the call's
ms. Where the tree's plan takes a forced group (``population_plan(...,
group=G)``), every kernel F evaluation of a mode's DE calls (each
generation's population with its live mask) is replayed at each group:
kernel F's summed device ms, so the groups are weighed on the DE call's
own generations at their live shares. ``--save`` / ``--against`` hold
every kernel F output and every DE call's ``x``, ``fun``, ``n_iter`` and
``converged`` bit for bit against another tree's.

Run it once per checkout, alternating (parent, change, change, parent), on
one card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path


def operands(tree: Path):
    """Import ``kikuchipy_tpu_torch`` and ``chip_smoke.py`` from ``tree`` and
    build the main path's prepared rows on the card: float32 ``exp``
    (16,384 x 3600) and ``dict`` (107,008 x 3600), their int8 quantization
    (``exp_q``, ``dict_q``, ``dict_scale``) and bf16 roundings. Returns
    them in a dict with ``smoke`` (the tree's ``chip_smoke`` module) and
    ``nt`` (its ``ops.ncc_topk``)."""
    tree = tree.resolve()
    sys.path.insert(0, str(tree))

    import torch

    spec = importlib.util.spec_from_file_location("tree_chip_smoke", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.crystallography.sampling import (
        reduce_to_fundamental_zone,
        sample_fundamental_zone,
        super_fibonacci,
    )
    from kikuchipy_tpu_torch.indexing.di import _quantize_rows_int8
    from kikuchipy_tpu_torch.indexing.metrics import get_metric
    from kikuchipy_tpu_torch.ops import ncc_topk as nt

    if Path(kt.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {kt.__file__}, not the tree's")
    dev = torch.device("cuda")
    mp = kt.EBSDMasterPattern(smoke.master_pattern_data(), phase=Phase(name="ni", point_group="m-3m"), device=dev)
    det = kt.EBSDDetector(shape=smoke.DETECTOR_SHAPE, pc=smoke.PC, sample_tilt=70)
    dict_rot = sample_fundamental_zone(smoke.RESOLUTION_DEG, "m-3m")
    n_scan = smoke.SCAN_SIDE**2
    truth = reduce_to_fundamental_zone(super_fibonacci(n_scan * 7)[::7][:n_scan], "m-3m")
    scan_u8, static_bg = smoke.scan_data(mp, det, truth, 0, chunk_size=8192)
    scan = kt.EBSD(scan_u8, detector=det, static_background=static_bg, device=dev)
    pre = scan.remove_static_background().remove_dynamic_background()
    dictionary = mp.get_patterns(dict_rot, det, chunk_size=8192)
    metric = get_metric("ncc")
    m_main = (dict_rot.shape[0] // 512) * 512
    exp_prep = metric.prepare(pre.data)
    dict_prep = metric.prepare(dictionary.data)[:m_main].contiguous()
    exp_q, _ = _quantize_rows_int8(exp_prep)
    dict_q, dict_scale = _quantize_rows_int8(dict_prep)
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector, quad_texture

    side = smoke.MASTER_SIDE
    projection = (torch.as_tensor(dict_rot, dtype=torch.float32, device=dev),
                  direction_cosines_from_detector(det, device=dev),
                  quad_texture(torch.as_tensor(mp._hemispheres_at_energy(), device=dev)), side, side, (side - 1) / 2)
    return {
        "lp": lp, "projection": projection, "get_patterns": lambda: mp.get_patterns(dict_rot, det, chunk_size=8192),
        "smoke": smoke, "nt": nt, "exp": exp_prep, "dict": dict_prep, "exp_q": exp_q, "dict_q": dict_q,
        "dict_scale": dict_scale, "exp_bf16": exp_prep.to(torch.bfloat16), "dict_bf16": dict_prep.to(torch.bfloat16),
    }


def preprocess(tree: Path, reps: int) -> None:
    """The ``--preprocess`` line of ``tree``'s package, on this script's
    ``chip_smoke.py`` inputs and timers (the module docstring)."""
    tree = tree.resolve()
    sys.path.insert(0, str(tree))

    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("preprocess_chip_smoke", Path(__file__).resolve().parent
                                                  / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.crystallography.sampling import reduce_to_fundamental_zone, super_fibonacci
    from kikuchipy_tpu_torch.filters import Window
    from kikuchipy_tpu_torch.ops import ahe
    from kikuchipy_tpu_torch.ops import background as bgk
    from kikuchipy_tpu_torch.ops import pattern as tops

    if Path(kt.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {kt.__file__}, not the tree's")
    dev = torch.device("cuda")
    mp = kt.EBSDMasterPattern(smoke.master_pattern_data(), phase=Phase(name="ni", point_group="m-3m"), device=dev)
    det = kt.EBSDDetector(shape=smoke.DETECTOR_SHAPE, pc=smoke.PC, sample_tilt=70)
    side = smoke.SCAN_SIDE
    n = side * side
    truth = reduce_to_fundamental_zone(super_fibonacci(n * 7)[::7][:n], "m-3m")
    scan_u8, static_bg = smoke.scan_data(mp, det, truth, 0, chunk_size=8192)
    scan = kt.EBSD(scan_u8.reshape(side, side, *smoke.DETECTOR_SHAPE), detector=det, static_background=static_bg,
                   device=dev)
    del mp
    flat = scan.data.reshape(-1, *smoke.DETECTOR_SHAPE)
    big = flat.repeat(smoke.PREPROCESS_TILES, 1, 1)
    bg = torch.as_tensor(static_bg, dtype=torch.float32, device=dev)
    plan = tops.dynamic_background_separable_plan(smoke.DETECTOR_SHAPE, smoke.DETECTOR_SHAPE[1] / 8)
    r_op, c_op = torch.as_tensor(plan.row_op, device=dev), torch.as_tensor(plan.col_op, device=dev)
    static_u8 = bgk.remove_background(flat, "subtract", 0, 255, np.uint8, static_bg=bg)
    dyn_u8 = bgk.remove_background(static_u8, "subtract", 0, 255, np.uint8, row_op=r_op, col_op=c_op)
    clahe_u8 = ahe.clahe(dyn_u8, 15, 15, 128, 0.0, np.uint8)
    hashes = {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
              for name, t in (("static", static_u8), ("dynamic", dyn_u8), ("clahe", clahe_u8))}
    runs = {
        "static": lambda: bgk.remove_background(flat, "subtract", 0, 255, np.uint8, static_bg=bg),
        f"static {big.shape[0]}": lambda: bgk.remove_background(big, "subtract", 0, 255, np.uint8, static_bg=bg),
        "dynamic": lambda: bgk.remove_background(static_u8, "subtract", 0, 255, np.uint8, row_op=r_op, col_op=c_op),
        "clahe": lambda: ahe.clahe(dyn_u8, 15, 15, 128, 0.0, np.uint8),
    }
    flush = torch.empty(smoke.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    kernels = {name: {"ms": smoke.cuda_ms(fn, reps, lead_ms=2.0),
                      "ms_cold": smoke.cuda_ms_cold(fn, reps, flush)}
               for name, fn in runs.items()}
    del flush, big
    call = smoke.call_breakdown(scan.remove_static_background, reps,
                                launches=lambda: bgk.remove_background.launches)
    ms_pre = smoke.cuda_ms(lambda: scan.remove_static_background().remove_dynamic_background(), 5)
    chain = {}
    for tiles in (1, smoke.PREPROCESS_TILES):
        data = scan.data if tiles == 1 else scan.data.repeat(tiles, 1, 1, 1)
        sig = kt.EBSD(data, static_background=static_bg, device=dev)
        smoke.tutorial_chain(sig, Window)
        torch.cuda.synchronize()
        runs_ms, steps = [], []
        for _ in range(3):
            timings = {}
            t0 = time.perf_counter()
            smoke.tutorial_chain(sig, Window, timings)
            torch.cuda.synchronize()
            runs_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(timings)
        chain[data.numel() // 3600] = {"chain_ms": float(np.median(runs_ms)),
                                        "steps": {k: float(np.median([t[k] for t in steps])) for k in steps[0]}}
        del sig, data
        torch.cuda.empty_cache()
    paths = {name: getattr(mod, name, None) for mod, name in ((bgk, "static_path"), (bgk, "dynamic_path"),
                                                               (ahe, "clahe_path"))}
    print(json.dumps({
        "tree": str(tree), "card": smoke.smi_line(), "kernels": kernels, "static_call": call, "ms_pre": ms_pre,
        "chain": chain, "hashes": hashes,
        **{name: None if fn is None else fn(60, 60, *((15, 15, 128) if name == "clahe_path" else ()), flat.dtype,
                                            np.uint8)
           for name, fn in paths.items()},
    }), flush=True)


def _tree_and_smoke(tree: Path, name: str):
    """Put ``tree``'s package first on the path and load this script's
    ``chip_smoke.py`` (the inputs and timers) as ``name``."""
    tree = tree.resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import kikuchipy_tpu_torch as kt

    if Path(kt.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {kt.__file__}, not the tree's")
    return tree, smoke, kt


def _scan(smoke, kt):
    """The main path's seeded 128 x 128 scan of 60 x 60 uint8 patterns on
    the card, with its static background."""
    import torch

    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.crystallography.sampling import reduce_to_fundamental_zone, super_fibonacci

    dev = torch.device("cuda")
    mp = kt.EBSDMasterPattern(smoke.master_pattern_data(), phase=Phase(name="ni", point_group="m-3m"), device=dev)
    det = kt.EBSDDetector(shape=smoke.DETECTOR_SHAPE, pc=smoke.PC, sample_tilt=70)
    side = smoke.SCAN_SIDE
    n = side * side
    truth = reduce_to_fundamental_zone(super_fibonacci(n * 7)[::7][:n], "m-3m")
    scan_u8, static_bg = smoke.scan_data(mp, det, truth, 0, chunk_size=8192)
    return kt.EBSD(scan_u8.reshape(side, side, *smoke.DETECTOR_SHAPE), detector=det, static_background=static_bg,
                   device=dev)


def _sha(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def neighbours(tree: Path, reps: int) -> None:
    """The ``--neighbours`` line of ``tree``'s kernel G (the module
    docstring)."""
    import numpy as np
    import torch

    tree, smoke, kt = _tree_and_smoke(tree, "neighbours_chip_smoke")
    from kikuchipy_tpu_torch.ops import neighbours as ng

    scan = _scan(smoke, kt)
    p = scan.data
    big = torch.as_tensor(np.random.default_rng(11).integers(0, 256, size=smoke.NEIGHBOUR_BIG_MAP
                                                             + smoke.NEIGHBOUR_BIG_PATTERN, dtype=np.uint8),
                          device=p.device)
    flush = torch.empty(smoke.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=p.device)
    runs = {}
    for label, data, window, shape, kw, n_reps in (
            ("circular 3x3", p, "circular", (3, 3), {}, reps), ("gaussian 3x3 std 2", p, "gaussian", (3, 3),
                                                                 {"std": 2}, reps),
            ("13x13 rectangular", p, "rectangular", (13, 13), {}, max(1, reps // 5)),
            ("480x480 circular 3x3", big, "circular", (3, 3), {}, reps)):
        offsets, weights = ng.window_taps(ng._resolve_window(window, shape, **kw))
        fn = lambda: ng.average_neighbours(data, offsets, weights, torch.uint8)  # noqa: E731
        runs[label] = {"taps": len(weights), "ms": smoke.cuda_ms(fn, n_reps, lead_ms=2.0),
                       "ms_cold": smoke.cuda_ms_cold(fn, n_reps, flush), "sha": _sha(fn())}
    del flush
    call = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan.average_neighbour_patterns()
        torch.cuda.synchronize()
        call.append((time.perf_counter() - t0) * 1e3)
    plan = getattr(ng, "neighbours_plan", None)
    print(json.dumps({
        "tree": str(tree), "card": smoke.smi_line(), "kernel": "average_neighbours", "runs": runs,
        "call_ms": call, "plan": None if plan is None else str(plan(p.dtype, torch.uint8, 3600, [1.0] * 5, 16, 16)),
    }), flush=True)


def hough(tree: Path, reps: int, inputs: Path | None, poles: int | None = None) -> None:
    """The ``--hough`` line of ``tree``'s kernel H (the module docstring)."""
    import torch

    tree, smoke, kt = _tree_and_smoke(tree, "hough_chip_smoke")
    from kikuchipy_tpu_torch.ops import hough_vote as hv

    if poles is not None:
        args, tol = pole_set_inputs(16384, poles)
    elif inputs is not None and inputs.exists():
        saved = torch.load(inputs)
        args, tol = tuple(t.cuda() for t in saved["args"]), saved["tol"]
    else:
        pre = _scan(smoke, kt).remove_static_background().remove_dynamic_background()
        args, tol = smoke.hough_vote_inputs(pre)
        if inputs is not None:
            inputs.parent.mkdir(parents=True, exist_ok=True)
            torch.save({"args": [t.cpu() for t in args], "tol": tol}, inputs)
    fn = lambda: hv.vote_orientations(*args, tol)  # noqa: E731
    flush = torch.empty(smoke.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=args[0].device)
    ms = smoke.cuda_ms(fn, reps, lead_ms=2.0)
    ms_cold = smoke.cuda_ms_cold(fn, reps, flush)
    R, err, n_in = fn()
    fin = torch.isfinite(err)
    print(json.dumps({
        "tree": str(tree), "card": smoke.smi_line(), "kernel": "vote_orientations", "n": int(args[0].shape[0]),
        "ms": ms, "ms_cold": ms_cold, "R_checksum": float(R.double().sum()),
        "err_checksum": float(err[fin].double().sum()), "n_in_sum": int(n_in.sum()),
        "poles": int(args[1].shape[0]),
        "shape": (list(hv.block_shape(args[0].shape[1], args[1].shape[0], args[4].shape[0], min(8, args[2].shape[0])))
                  if hasattr(hv, "block_shape") else None),
    }), flush=True)


def _refine_problem(smoke_dir: Path, seed: int = 0):
    """``refine_variants.py``'s ``problem`` (the file beside this script)."""
    spec = importlib.util.spec_from_file_location("refine_variants_inputs", smoke_dir / "refine_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.problem(smoke_dir, seed)


def refine_runs(smoke, modes):
    """name -> (the call, what its outputs are): each mode's Nelder-Mead
    kernel on the whole map, kernel B at 2,048 points, kernel F at a DE
    generation in each mode."""
    import torch

    from kikuchipy_tpu_torch.ops import lambert_project as lp

    euler0, exp, sq, dc, quad, npx, npy, scale = modes["orientation"][1]
    pc0, _, _, q_truth, _, om = modes["pc"][1][:6]
    geo = (npx, npy, scale)
    runs = {mode: (lambda fn=fn, a=a, kw=kw: fn(*a, **kw)) for mode, (fn, a, kw) in modes.items()}
    c = smoke.NAV_CHUNK
    rot_c = q_truth[:c].contiguous()
    runs["lambert_project_ncc"] = lambda: lp.lambert_project_ncc(rot_c, dc, quad, *geo, exp[:c], sq[:c])
    for mode, x0 in (("orientation", euler0), ("pc", pc0), ("joint", torch.cat([euler0, pc0], dim=1))):
        M = smoke.POP_M[mode]
        wrapper, _, _, x, args = smoke.population_problem(mode, x0, exp, sq, q_truth, quad, om, dc, geo,
                                                          smoke.DETECTOR_SHAPE, M, 80 + M)
        runs[f"population_{mode}"] = lambda wrapper=wrapper, x=x, args=args: wrapper(x, *args)
    return runs


def refine_agreement(mine: dict, theirs: dict) -> dict:
    """Each mode's agreement with another tree's outputs, and B's and F's
    largest differences."""
    import numpy as np
    import torch

    from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle
    from kikuchipy_tpu_torch.geometry import quaternion as tq

    out = {}
    for name, got in mine.items():
        ref = theirs[name]
        if not isinstance(got, dict):
            out[name] = {"max_abs_diff": float((got - ref).abs().max()), "bit_for_bit": bool(torch.equal(got, ref))}
            continue
        row = {"bit_for_bit": all(torch.equal(got[k], ref[k]) for k in ("x", "fun", "n_iter")),
               "n_iter_equal": float((got["n_iter"] == ref["n_iter"]).float().mean()),
               "max_abs_dfun": float((got["fun"] - ref["fun"]).abs().max()),
               "mean_score_gap": float((1 - got["fun"].double()).mean() - (1 - ref["fun"].double()).mean()),
               "evaluations": [int(got["n_evals"].sum()), int(ref["n_evals"].sum())]}
        if name != "pc":
            ang = np.degrees(disorientation_angle(tq.from_euler(got["x"][:, :3].double()).numpy(),
                                                  tq.from_euler(ref["x"][:, :3].double()).numpy(), "m-3m"))
            row.update(within_005_deg=float((ang <= 0.05).mean()), max_deg=float(ang.max()))
        if name != "orientation":
            dpc = (got["x"][:, -3:] - ref["x"][:, -3:]).abs().amax(dim=1)
            row.update(pc_within_1e5=float((dpc <= 1e-5).float().mean()), max_dpc=float(dpc.max()))
        out[name] = row
    return out


def refine_float64(smoke, modes, n: int = 2048) -> dict:
    """On the first ``n`` points in each mode: the tree's kernel, the host
    loop over the float32 plain twin and the host loop over the float64
    twin, each pair compared by ``chip_smoke.py`` ``float64_agreement`` (the
    share within 0.05 degrees and 1e-5 in PC, the mean float64 1 - NCC)."""
    import torch

    out = {}
    for mode, (fn, margs, mkw) in modes.items():
        if mode == "orientation":
            x0, (exp, sq, dc, quad), q0, om = margs[0][:n], margs[1:5], None, None
            exp, sq = exp[:n], sq[:n]
            geo, shape = margs[5:8], smoke.DETECTOR_SHAPE
            wrap = lambda x, fn=fn, margs=margs, mkw=mkw: fn(x, exp, sq, *margs[3:], **mkw)  # noqa: E731
        else:
            pc = mode == "pc"
            x0, exp, sq = margs[0][:n], margs[1][:n], margs[2][:n]
            q0 = margs[3][:n] if pc else None
            rest = margs[4:] if pc else margs[3:]
            quad, om, geo, shape, dc = rest[0], rest[1], rest[3:6], rest[6:8], None
            head = (exp, sq, q0) if pc else (exp, sq)
            wrap = lambda x, fn=fn, head=head, rest=rest, mkw=mkw: fn(x, *head, *rest, **mkw)  # noqa: E731
        ok, _, got, twin = smoke.float64_check(mode, wrap, x0, mkw, exp, sq, dc, q0, quad, om, None, geo, shape)
        f64 = smoke.float64_loop(mode, x0, mkw, exp, sq, dc, q0, quad, om, None, geo, shape)
        torch.cuda.synchronize()
        scores = {k: smoke.float64_scores(mode, r.x, exp, sq, dc, q0, quad, om, None, geo, shape)
                  for k, r in (("kernel", got), ("twin", twin), ("float64", f64))}
        res = {"kernel": got, "twin": twin, "float64": f64}
        out[mode] = {f"{a} against {b}": smoke.float64_agreement(mode, res[a], res[b], scores[a], scores[b])[1]
                     for a, b in (("kernel", "twin"), ("kernel", "float64"), ("twin", "float64"))}
        out[mode]["criterion holds"] = ok
    return out


def refine(tree: Path, reps: int, save: Path | None, against: Path | None, float64: bool = False) -> None:
    """The ``--refine`` line of ``tree``'s Nelder-Mead kernel, kernel B and
    kernel F (the module docstring)."""
    import torch

    tree, smoke, kt = _tree_and_smoke(tree, "refine_chip_smoke")
    smoke, modes = _refine_problem(Path(__file__).resolve().parent)
    times, outputs = {}, {}
    for name, fn in refine_runs(smoke, modes).items():
        res = fn()
        torch.cuda.synchronize()
        n_reps = max(1, reps // 3) if name in modes else reps
        times[name] = {"ms": smoke.cuda_ms(fn, n_reps), "card": card()}
        outputs[name] = ({k: getattr(res, k).cpu() for k in ("x", "fun", "n_iter", "n_evals")} if name in modes
                         else res.cpu())
    if save is not None:
        save.parent.mkdir(parents=True, exist_ok=True)
        torch.save(outputs, save)
    agreement = None
    if against is not None and against.exists():
        agreement = refine_agreement(outputs, torch.load(against))
    print(json.dumps({"tree": str(tree), "card": smoke.smi_line(), "times": times,
                      "evaluations": {m: int(outputs[m]["n_evals"].sum()) for m in modes},
                      "against": None if against is None else str(against), "agreement": agreement,
                      "float64": refine_float64(smoke, modes) if float64 else None}), flush=True)


LM_CHECK_POINTS = 2048


def _normal_errors(got, ref) -> dict:
    """max |f - f_ref|, and max |g - g_ref| / |g_ref| and |H - H_ref| / |H_ref|."""
    import torch

    (f, g, h), (rf, rg, rh) = [[t.double() for t in x] for x in (got, ref)]
    return {"df": float((f - rf).abs().max()),
            "dg_rel": float((torch.linalg.vector_norm(g - rg, dim=1) / torch.linalg.vector_norm(rg, dim=1)).max()),
            "djtj_rel": float((torch.linalg.matrix_norm(h - rh) / torch.linalg.matrix_norm(rh)).max())}


def lm_agreement(mine: dict, theirs: dict, float64: dict | None) -> dict:
    """Each kernel's agreement with another tree's outputs (module docstring)."""
    import torch

    out = {}
    for name, got in mine.items():
        ref = theirs[name]
        if name.startswith("tangent_"):
            out[name] = _normal_errors(got, ref)
            if float64 is not None:
                out[name]["theirs_against_float64"] = _normal_errors(ref, float64[name])
            continue
        row = {"bit_for_bit": all(torch.equal(got[k], ref[k]) for k in got),
               "fun_within_1e5": float(((got["fun"] - ref["fun"]).abs() <= 1e-5).float().mean()),
               "n_iter_equal": float((got["n_iter"] == ref["n_iter"]).float().mean()),
               "mean_fun": [float(got["fun"].double().mean()), float(ref["fun"].double().mean())],
               "evaluations": [int(got["n_evals"].sum()), int(ref["n_evals"].sum())]}
        if not name.endswith("_pc"):
            from kikuchipy_tpu_torch.ops.refine_lm import exp_map

            a, b = exp_map(got["x"][:, :3].double()), exp_map(ref["x"][:, :3].double())
            deg = torch.rad2deg(2 * torch.acos((a * b).sum(1).abs().clamp(max=1.0)))
            row.update(rotation_within_005_deg=float((deg <= 0.05).float().mean()), max_deg=float(deg.max()))
        if not name.endswith("_orientation"):
            dpc = (got["x"][:, -3:] - ref["x"][:, -3:]).abs().amax(dim=1)
            row.update(pc_within_1e4=float((dpc <= 1e-4).float().mean()), max_dpc=float(dpc.max()))
        out[name] = row
    return out


def lm(tree: Path, reps: int, save: Path | None, against: Path | None) -> None:
    """The ``--lm`` line of ``tree``'s kernel C and LM loop kernel (the
    module docstring)."""
    import torch

    tree, smoke, kt = _tree_and_smoke(tree, "lm_chip_smoke")
    here = Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("lm_variants_inputs", here / "lm_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    smoke, modes = module.problem(here, 0)
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    c = LM_CHECK_POINTS
    times, outputs, float64 = {}, {}, {}
    for mode, run in modes.items():
        fn, targs = run["tangent"]
        out = fn(*targs)
        torch.cuda.synchronize()
        times[f"tangent_{mode}"] = {"ms": smoke.cuda_ms(lambda: fn(*targs), reps), "card": card()}
        outputs[f"tangent_{mode}"] = [t[:c].cpu() for t in out]
        n = targs[0].shape[0]
        head = [a[:c] if torch.is_tensor(a) and a.ndim and a.shape[0] == n else a for a in targs]
        if float64 is not None:
            try:
                ref64 = getattr(rl, smoke.LM_WRAPPER[mode] + "_plain")(*smoke.float64_args(head))
                float64[f"tangent_{mode}"] = [t.cpu() for t in ref64]
            except TypeError:  # a tree whose plain version takes float32 alone
                float64 = None
        fn, largs, kw = run["loop"]
        res = fn(*largs, **kw)
        torch.cuda.synchronize()
        times[f"loop_{mode}"] = {"ms": smoke.cuda_ms(lambda: fn(*largs, **kw), max(1, reps // 3)), "card": card()}
        outputs[f"loop_{mode}"] = {k: getattr(res, k).cpu() for k in ("x", "fun", "n_iter", "n_evals")}
    own64 = None if float64 is None else {k: _normal_errors(outputs[k], v) for k, v in float64.items()}
    if save is not None:
        save.parent.mkdir(parents=True, exist_ok=True)
        torch.save(outputs, save)
    agreement = None
    if against is not None and against.exists():
        agreement = lm_agreement(outputs, torch.load(against), float64)
    print(json.dumps({"tree": str(tree), "card": smoke.smi_line(), "times": times,
                      "evaluations": {m: int(outputs[f"loop_{m}"]["n_evals"].sum()) for m in modes},
                      "against_float64": own64, "against": None if against is None else str(against),
                      "agreement": agreement}), flush=True)


def _de_scan(smoke, kt, seed: int = 0):
    """The main path's static-corrected scan on the card, its master pattern
    and detector, the truth, and starts 1.5 degrees off it."""
    import numpy as np
    import torch

    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.crystallography.sampling import reduce_to_fundamental_zone, super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq

    dev = torch.device("cuda")
    mp = kt.EBSDMasterPattern(smoke.master_pattern_data(), phase=Phase(name="ni", point_group="m-3m"), device=dev)
    det = kt.EBSDDetector(shape=smoke.DETECTOR_SHAPE, pc=smoke.PC, sample_tilt=70)
    n = smoke.SCAN_SIDE**2
    truth = reduce_to_fundamental_zone(super_fibonacci(n * 7)[::7][:n], "m-3m")
    scan_u8, static_bg = smoke.scan_data(mp, det, truth, 0, chunk_size=8192)
    scan = kt.EBSD(scan_u8, detector=det, static_background=static_bg, device=dev)
    static = kt.EBSD(scan.remove_static_background().data, detector=det, device=dev)
    axes = torch.randn((n, 3), generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), torch.as_tensor(np.asarray(truth))).numpy()
    return static, mp, det, np.asarray(truth), start


def _replay_by_group(smoke, rp, record, profile, activity) -> dict:
    """Every kernel F evaluation of a mode's recorded DE calls (each
    generation's population with its live mask), replayed at each group
    forced: kernel F's summed device ms under ``torch.profiler``, the
    replay's ms from CUDA events, and whether every value equals the plan's
    own."""
    import torch

    def replay() -> list:
        return [ev(x) if live is None else ev(x, live=live) for ev, calls, _ in record for x, live in calls]

    own = replay()
    torch.cuda.synchronize()
    by_group = {}
    for group in rp.GROUPS:
        with smoke.forced_group(group):
            got = replay()
            torch.cuda.synchronize()
            with profile(activities=[activity.CPU, activity.CUDA]) as prof:
                replay()
                torch.cuda.synchronize()
            _, events = smoke.device_busy(prof)
            by_group[group] = {
                "kernel_f_ms": sum(t for k, _, t in events if "refine_population_" in k),
                "kernel_f_launches": sum(cnt for k, cnt, _ in events if "refine_population_" in k),
                "replay_ms": smoke.cuda_ms(replay, 1),
                "bit_for_bit": all(torch.equal(a, b) for a, b in zip(got, own)), "card": card()}
    return by_group


def population(tree: Path, reps: int, save: Path | None, against: Path | None) -> None:
    """The ``--population`` line of ``tree``'s kernel F (the module
    docstring)."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    tree, smoke, kt = _tree_and_smoke(tree, "population_chip_smoke")
    smoke, modes = _refine_problem(Path(__file__).resolve().parent)
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.indexing import refinement as tr
    from kikuchipy_tpu_torch.ops import refine_population as rp

    euler0, exp, sq, dc, quad, npx, npy, scale = modes["orientation"][1]
    pc0, _, _, q_truth, _, om = modes["pc"][1][:6]
    geo = (npx, npy, scale)
    plan = getattr(rp, "population_plan", None)
    times, outputs = {}, {}
    for mode, x0 in (("orientation", euler0), ("pc", pc0), ("joint", torch.cat([euler0, pc0], dim=1))):
        for spread in smoke.POP_SPREADS:
            for M in (smoke.POP_M[mode], 1) if spread == "sigma 0.5 deg" else (smoke.POP_M[mode],):
                wrapper, _, _, x, args = smoke.population_problem(mode, x0, exp, sq, q_truth, quad, om, dc, geo,
                                                                  smoke.DETECTOR_SHAPE, M, 80 + M, spread)
                name = f"{mode} {spread} M={M}"
                outputs[name] = wrapper(x, *args).cpu()
                times[name] = {"ms": smoke.cuda_ms(lambda: wrapper(x, *args), reps), "card": card(),
                               "plan": list(plan(exp.shape[1], M, mode)) if plan else None}
    del modes, exp, sq, dc
    torch.cuda.empty_cache()

    static, mp, det, truth, start = _de_scan(smoke, kt)
    n = truth.shape[0]
    bad = dataclasses.replace(det, pc=np.asarray(smoke.PC) + np.asarray(smoke.PC_OFFSET))
    calls = {"orientation": ("refine_orientation", dict(xmap=CrystalMap(rotations=start, shape=(n,)))),
             "pc": ("refine_projection_center", dict(xmap=CrystalMap(rotations=truth, shape=(n,)), detector=bad)),
             "joint": ("refine_orientation_projection_center",
                       dict(xmap=CrystalMap(rotations=start, shape=(n,)), detector=bad))}
    de = {}
    for mode, (fn, kw) in calls.items():
        call = getattr(static, fn)
        kw = dict(kw, master_pattern=mp, trust_region=smoke.GLOBAL_TRUST[mode], method="de")
        record, run = [], tr._differential_evolution
        tr._differential_evolution = smoke.recording_de(record)
        try:
            call(**kw)
            torch.cuda.synchronize()
        finally:
            tr._differential_evolution = run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(**kw)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call(**kw)
            torch.cuda.synchronize()
        _, events = smoke.device_busy(prof)
        f_n = sum(cnt for k, cnt, _ in events if "refine_population_" in k)
        f_ms = sum(t for k, _, t in events if "refine_population_" in k)
        gens = [int(res.n_iter.max()) for _, _, res in record]
        # A point runs until it converges: at generation t (1, 2, ...) the
        # points with n_iter >= t run.
        shares = [[float((res.n_iter >= t).float().mean()) for t in range(1, g + 1)]
                  for (_, _, res), g in zip(record, gens)]
        points = [int(res.n_iter.shape[0]) for _, _, res in record]
        live_pg = sum(sum(sh) * k for sh, k in zip(shares, points))
        all_pg = sum(len(sh) * k for sh, k in zip(shares, points))
        de[mode] = {"calls": len(record), "generations": gens, "live_share_first_call": [round(v, 4) for v in shares[0]],
                    "live_point_generations": live_pg, "point_generations": all_pg,
                    "live_share": live_pg / max(all_pg, 1), "kernel_f_launches": f_n, "kernel_f_ms": f_ms,
                    "kernel_f_ms_a_launch": f_ms / max(f_n, 1), "call_ms": call_ms, "card": card()}
        if hasattr(rp, "GROUPS"):
            de[mode]["replay_by_group"] = _replay_by_group(smoke, rp, record, profile, ProfilerActivity)
        for i, (_, _, res) in enumerate(record):
            outputs[f"de {mode} {i}"] = {k: getattr(res, k).cpu() for k in ("x", "fun", "n_iter", "converged")}
    if save is not None:
        save.parent.mkdir(parents=True, exist_ok=True)
        torch.save(outputs, save)
    agreement = None
    if against is not None and against.exists():
        theirs = torch.load(against)
        agreement = {}
        for name, got in outputs.items():
            ref = theirs.get(name)
            if ref is None:
                agreement[name] = None
            elif isinstance(got, dict):
                agreement[name] = {k: bool(torch.equal(got[k], ref[k])) for k in got}
            else:
                agreement[name] = {"bit_for_bit": bool(torch.equal(got, ref)),
                                   "max_abs_diff": float((got - ref).abs().max())}
        agreement["all_bit_for_bit"] = all(all(v.values()) if "bit_for_bit" not in v else v["bit_for_bit"]
                                           for v in agreement.values() if isinstance(v, dict))
    print(json.dumps({"tree": str(tree), "card": smoke.smi_line(), "times": times, "de": de,
                      "against": None if against is None else str(against), "agreement": agreement}), flush=True)


def pole_set_inputs(n: int, n_poles: int, seed: int = 0):
    """Kernel H's inputs for a set of ``n_poles`` random unit poles, on the
    card: ``n`` patterns of 9 band normals (9 poles, drawn with replacement,
    under a random rotation with about half a degree of noise, 3 in 10 of
    them replaced by random directions), a LUT of the interplanar angles of every pair among
    80 of the poles, and the pairs of the first 6 bands (``hough_indexing``'s);
    and the tolerance, 2 degrees."""
    from itertools import combinations

    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n_poles, 3))
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    sub = rng.choice(n_poles, min(n_poles, 80), replace=False)
    lut_pairs = np.array(list(combinations(sub, 2)))
    lut_angles = np.arccos(np.clip(np.abs(np.sum(g[lut_pairs[:, 0]] * g[lut_pairs[:, 1]], axis=1)), 0, 1))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a, b, c, d = q.T
    R = np.stack([a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c),
                  2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b),
                  2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d], axis=1).reshape(n, 3, 3)
    pick = rng.integers(0, n_poles, size=(n, 9))
    v = np.einsum("nbi,nij->nbj", g[pick], R) + rng.normal(scale=0.008, size=(n, 9, 3))
    swap = rng.random((n, 9)) < 0.3
    v[swap] = rng.normal(size=(int(swap.sum()), 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pair_idx = np.array(list(combinations(range(6), 2)))
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa: E731
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device="cuda")  # noqa: E731
    return (f32(v), f32(g), f32(lut_angles), i32(lut_pairs), i32(pair_idx)), float(np.deg2rad(2.0))


def card() -> str:
    """The card's name, power limit, SM clock, power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, required=True)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--preprocess", action="store_true")
    parser.add_argument("--neighbours", action="store_true")
    parser.add_argument("--hough", action="store_true")
    parser.add_argument("--inputs", type=Path, default=None)
    parser.add_argument("--poles", type=int, default=None)
    parser.add_argument("--refine", action="store_true")
    parser.add_argument("--save", type=Path, default=None)
    parser.add_argument("--against", type=Path, default=None)
    parser.add_argument("--float64", action="store_true")
    parser.add_argument("--lm", action="store_true")
    parser.add_argument("--population", action="store_true")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    if args.preprocess:
        preprocess(args.tree, args.reps)
        return 0
    if args.neighbours:
        neighbours(args.tree, args.reps)
        return 0
    if args.hough:
        hough(args.tree, args.reps, args.inputs, args.poles)
        return 0
    if args.refine:
        refine(args.tree, args.reps, args.save, args.against, args.float64)
        return 0
    if args.lm:
        lm(args.tree, args.reps, args.save, args.against)
        return 0
    if args.population:
        population(args.tree, args.reps, args.save, args.against)
        return 0
    ops = operands(args.tree)
    smoke, nt = ops["smoke"], ops["nt"]
    exp_q, kq, ks = ops["exp_q"], ops["dict_q"], ops["dict_scale"]
    exp_bf16, dict_bf16 = ops["exp_bf16"], ops["dict_bf16"]
    m_main = kq.shape[0]
    k = 40

    # The projection first, before the f32 kernel draws the card's whole power.
    lp, projection = ops["lp"], ops["projection"]
    for name, fn in (("lambert_project", lambda: lp.lambert_project(*projection)),
                     ("get_patterns", ops["get_patterns"])):
        ms = smoke.cuda_ms(fn, args.reps)
        after = card()
        out = fn()
        out = out if name == "lambert_project" else out.data
        print(json.dumps({
            "tree": str(args.tree), "kernel": name, "B": int(projection[0].shape[0]), "P": int(projection[1].shape[0]),
            "ms": ms, "library_product_ms": None, "card": after, "checksum": float(out.double().sum().item()),
        }), flush=True)
    runs = {
        "ncc_match_topk_int8": (lambda: nt.ncc_match_topk_int8(exp_q, kq, ks, k, 512, 512),
                                lambda: torch._int_mm(exp_q, kq.T), args.reps),
        "ncc_match_topk_bf16": (lambda: nt.ncc_match_topk_bf16(exp_bf16, dict_bf16, k, 512, 512),
                                lambda: exp_bf16 @ dict_bf16.T, args.reps),
        "ncc_match_topk_f32": (lambda: nt.ncc_match_topk_f32(ops["exp"], ops["dict"], k, 256, 512),
                               lambda: ops["exp"] @ ops["dict"].T, max(1, args.reps // 4)),
    }
    for name, (kernel, product, reps) in runs.items():
        ms = smoke.cuda_ms(kernel, reps)
        after = card()
        ms_lib = smoke.cuda_ms(product, reps)
        s, i = kernel()
        print(json.dumps({
            "tree": str(args.tree), "kernel": name, "n": int(exp_q.shape[0]), "m": m_main,
            "d": int(exp_q.shape[1]), "k": k, "ms": ms, "library_product_ms": ms_lib, "card": after,
            "checksum": float(np.float64(s.double().sum().item())), "idx_checksum": int(i.long().sum().item()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
