"""Measure what the Nelder-Mead kernel's design rests on, on one card.

    python3 refine_variants.py [--reps 3] [--seed 0]

At the main-path shape of refinement (16,384 points, a 60 x 60 detector,
``chip_smoke.py``'s seeded 401 x 401 master pattern; patterns projected at
known orientations and the detector's PC with noise, refined from 1.5
degrees off, and in the PC modes from the PC off by (0.01, -0.01, 0.01))
it prints one JSON line per measurement, each with the card's name, power
limit, clock, power and temperature right after it:

- ``branch``: orientation mode as built, with the row and pattern in shared
  memory (one projection an evaluation), and its two-pass branch at the
  same P (the row in device memory, every pixel projected twice, as kernel
  B does), which the wrapper takes only past ``RESIDENT_SMEM_BYTES``;
- ``build``: each mode as built, then the kernel rebuilt with
  ``-DREFINE_NM_MIN_BLOCKS`` of 1, 2 and 3 (4 as built): the compiler caps
  the registers so that that many 256-thread blocks fit an SM; each mode
  timed and checked bit for bit against the kernel as built, with
  ``ptxas``'s registers and stack of each build.

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

MIN_BLOCKS = (1, 2, 3)


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
    from kikuchipy_tpu_torch.utils.optimize import initial_step_per_element

    # The variants compile while the inputs are made.
    out_dir = here / "kikuchipy_tpu_torch" / "_kernels_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = here / "kikuchipy_tpu_torch" / "csrc" / "refine_nm.cu"
    procs = []
    for blocks in MIN_BLOCKS:
        lib = out_dir / f"refine_variant_{blocks}.so"
        procs.append((blocks, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DREFINE_NM_MIN_BLOCKS={blocks}", "-o", str(lib), str(src)],
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
             ptxas=_build.BUILD_LOG.get("refine_nm", "").splitlines())

    # Orientation mode's two-pass branch at the same P.
    euler0, exp, sq, dc, quad, npx, npy, scale = modes["orientation"][1]
    kw = modes["orientation"][2]
    n, P = exp.shape
    step = initial_step_per_element(euler0, kw["initial_step"]).contiguous()

    def two_pass():
        outs = rn._outputs(n, 3, exp.device)
        err = rn._function()(euler0.data_ptr(), step.data_ptr(), 0, 0, exp.data_ptr(), sq.data_ptr(), dc.data_ptr(),
                             quad.data_ptr(), *[t.data_ptr() for t in outs], n, P, 0, npx, npy, float(scale),
                             rn._INV_SQRT_PI_HALF, kw["max_iters"], kw["fatol"], kw["xatol"], 0,
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"refine_nm launch failed: cudaError_t {err}")
        return rn.NelderMeadKernelResult(*outs[:5])

    ms = smoke.cuda_ms(two_pass, args.reps)
    emit("branch", "orientation", resident=False, ms=ms, ms_resident=built_ms["orientation"],
         patterns_per_s=n / ms * 1e3, bit_for_bit=same("orientation", two_pass()))

    built = _build.library("refine_nm")
    try:
        for blocks, lib_path, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for REFINE_NM_MIN_BLOCKS={blocks}:\n{log}")
            ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "stack frame" in ln]
            _build._LOADED["refine_nm"] = ctypes.CDLL(str(lib_path))
            for mode, (fn, margs, mkw) in modes.items():
                ms = smoke.cuda_ms(lambda: fn(*margs, **mkw), args.reps)
                emit("build", mode, label=f"min_blocks={blocks}", ms=ms, ms_as_built=built_ms[mode],
                     patterns_per_s=refs[mode].fun.shape[0] / ms * 1e3, bit_for_bit=same(mode, fn(*margs, **mkw)),
                     ptxas=ptxas)
            lib_path.unlink()
    finally:
        _build._LOADED["refine_nm"] = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
