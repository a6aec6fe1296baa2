"""Measure what the Nelder-Mead kernel's design rests on, on one card.

    python3 refine_variants.py [--reps 3] [--seed 0]

At the main-path shape of refinement (16,384 points, a 60 x 60 detector,
``chip_smoke.py``'s seeded 401 x 401 master pattern; patterns projected at
known orientations with noise, refined from 1.5 degrees off) it prints one
JSON line per measurement, each with the card's name, power limit, clock,
power and temperature right after it:

- ``branch``: the kernel as built, with the row and pattern in shared
  memory (one projection an evaluation), and its two-pass branch at the
  same P (the row in device memory, every pixel projected twice, as kernel
  B does), which the wrapper takes only past ``RESIDENT_SMEM_BYTES``;
- ``min_blocks``: the kernel rebuilt with ``-DREFINE_NM_MIN_BLOCKS`` of 1,
  2, 3 and 4 (as built): the compiler caps its registers so that that many
  256-thread blocks fit an SM; time, ``ptxas``'s registers and stack, and
  whether the result equals the kernel's bit for bit.

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

MIN_BLOCKS = (1, 2, 3, 4)


def problem(here: Path, seed: int, n: int = 16384):
    """``chip_smoke.py`` as a module, the kernel's arguments at the
    main-path shape, and its keywords."""
    import importlib.util

    import torch

    from kikuchipy_tpu_torch.crystallography.sampling import reduce_to_fundamental_zone, super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import lambert_project as lp
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
    rows = lp.lambert_project(torch.as_tensor(truth, dtype=torch.float32, device=dev), dc, quad, *geo)
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = rows + 0.05 * torch.randn(rows.shape, generator=g).to(dev)
    exp, sq = _prepare_experimental(rows, None)
    axes = torch.randn((n, 3), generator=g, dtype=torch.float64)
    start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), torch.as_tensor(truth))
    euler0 = tq.to_euler(start).to(torch.float32).to(dev)
    kw = dict(initial_step=np.deg2rad(1.0), max_iters=150, fatol=1e-4, xatol=1e-4)
    return smoke, (euler0, exp, sq, dc, quad, *geo), kw


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
    from kikuchipy_tpu_torch.utils.optimize import initial_step_per_element

    # The variants compile while the inputs are made.
    out_dir = here / "kikuchipy_tpu_torch" / "_kernels_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = here / "kikuchipy_tpu_torch" / "csrc" / "refine_nm.cu"
    builds = []
    for blocks in MIN_BLOCKS:
        lib = out_dir / f"refine_variant_{blocks}.so"
        builds.append((blocks, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DREFINE_NM_MIN_BLOCKS={blocks}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    smoke, pargs, kw = problem(here, args.seed)
    euler0, exp, sq, dc, quad, npx, npy, scale = pargs
    n, P = exp.shape
    dev = exp.device
    ref = rn.nelder_mead_orientation(*pargs, **kw)
    torch.cuda.synchronize()
    evals = int(ref.n_evals.sum())
    step = initial_step_per_element(euler0, kw["initial_step"]).contiguous()

    def emit(kind: str, **fields) -> None:
        print(json.dumps({"measurement": kind, "n": n, "P": P, "evaluations": evals, **fields, "card": card()}),
              flush=True)

    def runner(fn, resident: bool):
        def run():
            outs = (torch.empty((n, 3), device=dev), torch.empty(n, device=dev),
                    torch.empty(n, dtype=torch.int32, device=dev), torch.empty(n, dtype=torch.bool, device=dev),
                    torch.empty(n, dtype=torch.int32, device=dev), torch.zeros(1, dtype=torch.int32, device=dev))
            err = fn(euler0.data_ptr(), step.data_ptr(), 0, 0, exp.data_ptr(), sq.data_ptr(), dc.data_ptr(),
                     quad.data_ptr(), *[t.data_ptr() for t in outs], n, P, 0, npx, npy, float(scale),
                     rn._INV_SQRT_PI_HALF, kw["max_iters"], kw["fatol"], kw["xatol"], int(resident),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"refine_nm launch failed: cudaError_t {err}")
            return outs
        return run

    def same(outs) -> bool:
        x, fun, n_iter = outs[:3]
        return bool(torch.equal(x, ref.x) and torch.equal(fun, ref.fun) and torch.equal(n_iter, ref.n_iter))

    kernel = rn._function()
    for resident in (True, False):
        run = runner(kernel, resident)
        ms = smoke.cuda_ms(run, args.reps)
        emit("branch", resident=resident, ms=ms, patterns_per_s=n / ms * 1e3, bit_for_bit=same(run()))

    for blocks, lib_path, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for REFINE_NM_MIN_BLOCKS={blocks}:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "stack frame" in ln]
        fn = getattr(ctypes.CDLL(str(lib_path)), "refine_nm_launch")
        fn.argtypes, fn.restype = rn._ARGTYPES, ctypes.c_int
        run = runner(fn, True)
        ms = smoke.cuda_ms(run, args.reps)
        emit("min_blocks", min_blocks=blocks, ms=ms, patterns_per_s=n / ms * 1e3, bit_for_bit=same(run()),
             ptxas=ptxas)
        lib_path.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
