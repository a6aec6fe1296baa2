"""Measure the shared-memory plan of kernel C and the Levenberg-Marquardt loop
kernel on one card.

    python3 lm_variants.py [--reps 3] [--seed 0] [--modes orientation,pc,joint]

At the main-path shape of refinement (16,384 points, a 60 x 60 detector,
``chip_smoke.py``'s seeded 401 x 401 master pattern; patterns projected at
known orientations and the detector's PC with noise, refined from 1.5
degrees off, and in the PC modes from the PC off by (0.01, -0.01, 0.01); at
``refine_*``'s settings) it times, in each mode, every shared-memory plan of
``csrc/refine_lm.cu``:

- kernel C (one launch at the map's starts): the pattern and its tangents
  in shared memory (``ops/refine_lm.py`` ``resident``) or projected again
  in each of the three passes;
- the loop kernel (one ``method="lm"`` launch for the map): ``loop_residency``
  2 (the pattern, its tangents and the point's experimental row in shared
  memory), 1 (the pattern and tangents) and 0 (nothing: every pass projects).

Each plan is timed in turns (the plan as built, each other plan, each other
plan again, the plan as built) and checked bit for bit against the plan as
built (every plan computes the same arithmetic). With each plan: its
registers and spilled bytes a thread, static and dynamic shared memory a
block and blocks an SM, as the library that launches it reports them
(``ops/refine_lm.py`` ``kernel_attributes``). It prints one JSON line per
timing with the card's name, power limit, clock, power and temperature right
after it.

Needs a CUDA device. The port calls nothing of this script.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from compare_kernel_times import card

MODES = ("orientation", "pc", "joint")


def problem(here: Path, seed: int, n: int = 16384):
    """``chip_smoke.py`` as a module, and for each mode: the tangent wrapper,
    its starts and arguments, the loop wrapper, its starts, arguments and
    keywords, at the main-path shape."""
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
    shape = smoke.DETECTOR_SHAPE
    kw = dict(max_iters=30, ftol=1e-6)
    args = {
        "orientation": (start, unit, dc, quad, *geo),
        "pc": (pc0, unit, q_truth, quad, om, None, *geo, *shape),
        "joint": (start, pc0, unit, quad, om, None, *geo, *shape),
    }
    modes = {}
    for mode in MODES:
        d = smoke.LM_DIMS[mode]
        x0 = torch.zeros((n, d), device=dev)
        modes[mode] = {"tangent": (getattr(rl, smoke.LM_WRAPPER[mode]), (x0, *args[mode])),
                       "loop": (getattr(rl, smoke.LM_LOOP[mode]), (x0, *args[mode]),
                                dict(kw, blocks=smoke.LM_BLOCKS[mode]))}
    return smoke, modes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--modes", default=",".join(MODES))
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lm_variants: needs a CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    smoke, modes = problem(here, args.seed)
    built_resident, built_loop = rl.resident, rl.loop_residency
    try:
        for mode in args.modes.split(","):
            run = modes[mode]
            fn, targs = run["tangent"]
            n, P = targs[3 if mode == "joint" else 2].shape  # after x0 and the start rotations or PCs
            d = smoke.LM_DIMS[mode]
            plans = {"tangent": {int(built_resident(P, d)): built_resident,
                                 1 - int(built_resident(P, d)): (lambda P, d, r=not built_resident(P, d): r)},
                     "loop": {r: (lambda P, d, r=r: r) for r in (2, 1, 0)}}
            plans["loop"][built_loop(P, d)] = built_loop
            for kind, table in plans.items():
                built = int(built_resident(P, d)) if kind == "tangent" else built_loop(P, d)
                others = [r for r in table if r != built]
                fn, fargs, *kw = run[kind]
                kw = kw[0] if kw else {}
                ref = fn(*fargs, **kw)
                torch.cuda.synchronize()
                for plan in [built, *others, *others, built]:
                    if kind == "tangent":
                        rl.resident = table[plan]
                    else:
                        rl.loop_residency = table[plan]
                    try:
                        res = fn(*fargs, **kw)
                        torch.cuda.synchronize()
                    except RuntimeError as err:  # a plan the card refuses (too much shared memory)
                        print(json.dumps({"measurement": "plan", "kind": kind, "mode": mode, "plan": plan,
                                          "refused": str(err), "card": card()}), flush=True)
                        continue
                    same = all(torch.equal(a, b) for a, b in zip(res, ref))
                    ms = smoke.cuda_ms(lambda: fn(*fargs, **kw), args.reps)
                    print(json.dumps({"measurement": "plan", "kind": kind, "mode": mode, "plan": plan,
                                      "as_built": plan == built, "n": n, "P": P,
                                      **rl.kernel_attributes(kind, mode, plan, P),
                                      "evaluations": int(ref.n_evals.sum()) if kind == "loop" else n, "ms": ms,
                                      "bit_for_bit": same, "card": card()}), flush=True)
                rl.resident, rl.loop_residency = built_resident, built_loop
    finally:
        rl.resident, rl.loop_residency = built_resident, built_loop
    return 0


if __name__ == "__main__":
    sys.exit(main())
