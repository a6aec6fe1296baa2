"""Measure what the Nelder-Mead kernel's design rests on, on one card.

    python3 refine_variants.py [--reps 3] [--seed 0]

At the main-path shape of refinement (16,384 points, a 60 x 60 detector,
``chip_smoke.py``'s seeded 401 x 401 master pattern; patterns projected at
known orientations and the detector's PC with noise, refined from 1.5
degrees off, and in the PC modes from the PC off by (0.01, -0.01, 0.01))
it prints one JSON line per measurement, each with the card's name, power
limit, clock, power and temperature right after it:

- ``build``: each mode as built (``nelder_mead_plan``'s shape: the tap
  cache of the first pixels of ``CACHE_SHAPE[mode]``, or none);
- ``route``: each mode with the tap cache of ``CACHE_SHAPES`` (blocks an
  SM and the shared memory they may take: ``cache_plan``; two blocks in
  228 KB cache every pixel) and without it (the resident route), and
  orientation mode on the two-pass branch (the row in device memory, every
  pixel projected twice), at the same P: the wrapper's plan replaced for
  the call; each bit for bit against the kernel as built (the shapes
  round alike);
- ``build`` with a label: the kernel rebuilt with other pixels a thread
  projects together (``-DREFINE_NM_CACHE_GROUP=2``, 1 as built;
  ``-DREFINE_NM_GROUP=1``, 2 as built), each mode timed, with ``ptxas``'s
  registers and stack of each build;
- ``reuse``: the kernel rebuilt with ``-DREFINE_NM_PROBE``, each mode run
  once as built and once with every pixel cached: the share of the cached
  pixels after a point's first evaluation whose tap is the one the same
  pixel read in the point's previous evaluation (the tap cache's hits),
  and their share of all its cached pixels.

Needs a CUDA device and ``nvcc``. The port calls nothing of this script.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from compare_kernel_times import card

# Builds beside the shipped one: a label, its macros and the route timed.
VARIANTS = [("cache_group=2", ["-DREFINE_NM_CACHE_GROUP=2"]), ("group=1", ["-DREFINE_NM_GROUP=1"])]
PROBE = ("probe", ["-DREFINE_NM_PROBE=1"])
# The tap cache's shapes of the ``route`` measurements: (blocks an SM, KB of
# shared memory they may take), each mode's own (ops/refine_nm.py
# CACHE_SHAPE) and None, the resident route, in every mode.
KB = 1024
CACHE_SHAPES = {"orientation": [(4, 164 * KB), (4, 196 * KB), (4, 228 * KB), (3, 196 * KB), (3, 228 * KB),
                                (2, 228 * KB)],
                "pc": [(4, 196 * KB)], "joint": [(4, 196 * KB)]}


def problem(here: Path, seed: int, n: int = 16384):
    """``chip_smoke.py`` as a module, and each mode's wrapper, arguments and
    keywords at the main-path shape."""
    import importlib.util

    import torch

    from kikuchipy_tpu_torch.crystallography.sampling import reduce_to_fundamental_zone, super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_nm as rn
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector, quad_texture

    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    side = smoke.MASTER_SIDE
    quad = quad_texture(torch.as_tensor(smoke.master_pattern_data(side), device=dev))
    geo = (side, side, (side - 1) / 2)
    det = EBSDDetector(shape=smoke.DETECTOR_SHAPE, pc=smoke.PC, sample_tilt=70)
    dc = direction_cosines_from_detector(det, device=dev)
    truth = reduce_to_fundamental_zone(super_fibonacci(n * 7)[::7][:n], "m-3m")
    q_truth = torch.as_tensor(truth, dtype=torch.float32, device=dev)
    rows = lp.lambert_project(q_truth, dc, quad, *geo)
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = rows + 0.05 * torch.randn(rows.shape, generator=g).to(dev)
    exp, sq = _prepare_experimental(rows, None)
    axes = torch.randn((n, 3), generator=g, dtype=torch.float64)
    start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), torch.as_tensor(truth))
    euler0 = tq.to_euler(start).to(torch.float32).to(dev)
    om = torch.as_tensor(np.ascontiguousarray(det.sample_to_detector.T), dtype=torch.float32, device=dev)
    pc0 = torch.as_tensor(np.tile(np.asarray(smoke.PC) + np.asarray(smoke.PC_OFFSET), (n, 1)), dtype=torch.float32,
                          device=dev)
    pc_geo = (*geo, *smoke.DETECTOR_SHAPE)
    modes = {
        "orientation": (rn.nelder_mead_orientation, (euler0, exp, sq, dc, quad, *geo),
                        dict(initial_step=np.deg2rad(1.0), max_iters=150, fatol=1e-4, xatol=1e-4)),
        "pc": (rn.nelder_mead_projection_center, (pc0, exp, sq, q_truth, quad, om, None, *pc_geo),
               dict(initial_step=0.01, max_iters=150, fatol=1e-4, xatol=1e-5)),
        "joint": (rn.nelder_mead_orientation_projection_center,
                  (torch.cat([euler0, pc0], dim=1), exp, sq, quad, om, None, *pc_geo),
                  dict(initial_step=torch.tensor([np.deg2rad(1.0)] * 3 + [0.01] * 3, device=dev), max_iters=200,
                       fatol=1e-4, xatol=1e-5)),
    }
    return smoke, modes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("refine_variants: needs a CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    from kikuchipy_tpu_torch.ops import _build
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    # The variants compile while the inputs are made.
    out_dir = here / "kikuchipy_tpu_torch" / "_kernels_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = here / "kikuchipy_tpu_torch" / "csrc" / "refine_nm.cu"
    procs = []
    for i, (label, macros) in enumerate(VARIANTS + [PROBE]):
        lib = out_dir / f"refine_variant_{i}.so"
        procs.append((label, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *macros, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    smoke, modes = problem(here, args.seed)
    refs, built_ms = {}, {}
    for mode, (fn, margs, kw) in modes.items():
        refs[mode] = fn(*margs, **kw)
        torch.cuda.synchronize()
        built_ms[mode] = smoke.cuda_ms(lambda: fn(*margs, **kw), args.reps)

    def emit(kind: str, mode: str, **fields) -> None:
        n, P = modes[mode][1][1].shape
        print(json.dumps({"measurement": kind, "mode": mode, "n": n, "P": P,
                          "evaluations": int(refs[mode].n_evals.sum()), **fields, "card": card()}), flush=True)

    def same(mode, res) -> bool:
        ref = refs[mode]
        return bool(torch.equal(res.x, ref.x) and torch.equal(res.fun, ref.fun) and torch.equal(res.n_iter, ref.n_iter))

    for mode, ms in built_ms.items():
        emit("build", mode, label="as built", ms=ms, patterns_per_s=refs[mode].fun.shape[0] / ms * 1e3,
             plan=list(rn.nelder_mead_plan(modes[mode][1][1].shape[1], mode)),
             ptxas=_build.BUILD_LOG.get("refine_nm", "").splitlines())

    # The other shapes at the same P: the wrapper's plan replaced for the call.
    plan = rn.nelder_mead_plan
    two_pass = rn.NelderMeadPlan("two-pass", rn.THREADS, rn.REGISTER_BLOCKS, 0, 0)
    shapes = [(f"cache for {b} blocks in {kb // KB} KB" if b else "resident", m,
               rn.cache_plan(modes[m][1][1].shape[1], b, kb))
              for m in modes for b, kb in CACHE_SHAPES[m] + [(None, 0)]] + [("two-pass", "orientation", two_pass)]
    try:
        for label, mode, shape in shapes:
            rn.nelder_mead_plan = lambda P, mode="orientation", shape=shape: shape
            fn, margs, mkw = modes[mode]
            ms = smoke.cuda_ms(lambda: fn(*margs, **mkw), args.reps)
            emit("route", mode, label=label, plan=list(shape), ms=ms, ms_as_built=built_ms[mode],
                 patterns_per_s=refs[mode].fun.shape[0] / ms * 1e3, bit_for_bit=same(mode, fn(*margs, **mkw)))
    finally:
        rn.nelder_mead_plan = plan

    built = _build.library("refine_nm")
    try:
        for label, lib_path, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {label}:\n{log}")
            ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "stack frame" in ln]
            if label == PROBE[0]:
                # As built (the cached pixels' hits), then with every pixel
                # cached (the share of all of a point's taps that repeat).
                for shape in (None, rn.cache_plan(modes["orientation"][1][1].shape[1], 2)):
                    if shape is not None:
                        rn.nelder_mead_plan = lambda P, mode="orientation", shape=shape: shape
                    calls = {mode: (lambda fn=fn, margs=margs, mkw=mkw: fn(*margs, **mkw))
                             for mode, (fn, margs, mkw) in modes.items()}
                    try:
                        for mode, counts in smoke.tap_reuse(lib_path, calls).items():
                            emit("reuse", mode, cached="as built" if shape is None else "every pixel", **counts,
                                 ptxas=ptxas)
                    finally:
                        rn.nelder_mead_plan = plan
                lib_path.unlink()
                continue
            _build._LOADED["refine_nm"] = ctypes.CDLL(str(lib_path))
            for mode, (fn, margs, mkw) in modes.items():
                ms = smoke.cuda_ms(lambda: fn(*margs, **mkw), args.reps)
                res = fn(*margs, **mkw)
                emit("build", mode, label=label, ms=ms, ms_as_built=built_ms[mode],
                     patterns_per_s=refs[mode].fun.shape[0] / ms * 1e3, bit_for_bit=same(mode, res),
                     max_abs_dfun=float((res.fun - refs[mode].fun).abs().max()), ptxas=ptxas)
            lib_path.unlink()
    finally:
        _build._LOADED["refine_nm"] = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
