"""Measure a design choice of the Levenberg-Marquardt loop kernel on one card.

    python3 lm_variants.py [--reps 3] [--seed 0]

At the main-path shape of refinement (16,384 points, a 60 x 60 detector,
``chip_smoke.py``'s seeded 401 x 401 master pattern; patterns projected at
known orientations and the detector's PC with noise, refined from 1.5
degrees off, and in PC mode from the PC off by (0.01, -0.01, 0.01); at
``refine_*``'s settings) it times the loop kernel of
``csrc/refine_lm.cu`` in its two d = 3 modes as built (each point's
experimental row copied to shared memory by cp.async at the point's start,
``ops/refine_lm.py`` ``loop_residency`` 2) and with the row left in device
memory (``loop_residency`` 1, what joint mode takes), in turns (built,
device memory, device memory, built), each checked bit for bit against the
kernel as built. It prints one JSON line per timing with the card's name,
power limit, clock, power and temperature right after it.

Needs a CUDA device. The port calls nothing of this script.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from compare_kernel_times import card


def problem(here: Path, seed: int, n: int = 16384):
    """``chip_smoke.py`` as a module, and the orientation and PC modes'
    loop wrapper, starts, arguments and keywords at the main-path shape."""
    import importlib.util

    import torch

    from kikuchipy_tpu_torch.crystallography.sampling import reduce_to_fundamental_zone, super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_lm as rl
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
    unit = rl.unit_rows(_prepare_experimental(rows, None)[0])
    axes = torch.randn((n, 3), generator=g, dtype=torch.float64)
    start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), torch.as_tensor(truth)).to(torch.float32).to(dev)
    om = torch.as_tensor(np.ascontiguousarray(det.sample_to_detector.T), dtype=torch.float32, device=dev)
    pc0 = torch.as_tensor(np.tile(np.asarray(smoke.PC) + np.asarray(smoke.PC_OFFSET), (n, 1)), dtype=torch.float32,
                          device=dev)
    x0 = torch.zeros((n, 3), device=dev)
    kw = dict(max_iters=30, ftol=1e-6)
    modes = {
        "orientation": (rl.levenberg_marquardt_orientation, (x0, start, unit, dc, quad, *geo),
                        dict(kw, blocks=smoke.LM_BLOCKS["orientation"])),
        "pc": (rl.levenberg_marquardt_projection_center,
               (x0, pc0, unit, q_truth, quad, om, None, *geo, *smoke.DETECTOR_SHAPE),
               dict(kw, blocks=smoke.LM_BLOCKS["pc"])),
    }
    return smoke, modes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lm_variants: needs a CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    smoke, modes = problem(here, args.seed)
    built = rl.loop_residency
    refs = {}
    for mode, (fn, margs, kw) in modes.items():
        refs[mode] = fn(*margs, **kw)
    torch.cuda.synchronize()
    try:
        for mode, (fn, margs, kw) in modes.items():
            n, P = margs[2].shape
            evals = int(refs[mode].n_evals.sum())
            for label, residency in (("row in shared memory (as built)", built),
                                     ("row in device memory", lambda P, d: 1),
                                     ("row in device memory", lambda P, d: 1),
                                     ("row in shared memory (as built)", built)):
                rl.loop_residency = residency
                res = fn(*margs, **kw)
                torch.cuda.synchronize()
                same = all(torch.equal(getattr(res, f), getattr(refs[mode], f)) for f in res._fields)
                ms = smoke.cuda_ms(lambda: fn(*margs, **kw), args.reps)
                print(json.dumps({"measurement": "row", "mode": mode, "label": label, "residency": residency(P, 3),
                                  "n": n, "P": P, "evaluations": evals, "ms": ms, "bit_for_bit": same,
                                  "card": card()}), flush=True)
    finally:
        rl.loop_residency = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
