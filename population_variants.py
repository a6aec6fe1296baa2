"""Measure what kernel F's design rests on, on one card.

    python3 population_variants.py [--reps 5] [--seed 0]

At the global solvers' shape (``refine_variants.py``'s ``problem``: 16,384
points, a 60 x 60 detector, ``chip_smoke.py``'s seeded 401 x 401 master;
patterns projected at known orientations with noise, starts 1.5 degrees
off, in the PC modes the PC off by (0.01, -0.01, 0.01)) it prints one JSON
line per measurement, each with the card's name, power limit, clock, power
and temperature right after it:

- ``sectors``: the 32-byte sectors a member-pixel reads when G members of
  a point load the same pixel together (``chip_smoke.sectors_per_member_pixel``
  on the plain twin's taps of 64 points; 1.0 is one member a block), at G =
  1, 2, 4, 8 and 24, in each mode at each spread of
  ``chip_smoke.POP_SPREADS``;
- ``group``: kernel F at one DE generation of the map (M = 24 / 16 / 16) in
  each mode at each spread, with its group forced to G = 1, 2, 4 and 8
  (``population_plan(..., group=G)``), and at M = 1 (a DA step): ms, the
  plan, ``ptxas``'s registers of the build, and whether the values are bit
  for bit those at G = 1 (the Nelder-Mead kernel's evaluation: they must
  be).

Needs a CUDA device and ``nvcc``. The port calls nothing of this script.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

from compare_kernel_times import card

GROUPS = (1, 2, 4, 8)
SECTOR_GROUPS = (1, 2, 4, 8, 24)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("population_variants: needs a CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    from kikuchipy_tpu_torch.ops import _build
    from kikuchipy_tpu_torch.ops import refine_population as rp

    spec = importlib.util.spec_from_file_location("refine_variants_inputs", here / "refine_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    smoke, modes = module.problem(here, args.seed)
    euler0, exp, sq, dc, quad, npx, npy, scale = modes["orientation"][1]
    pc0, _, _, q_truth, _, om = modes["pc"][1][:6]
    geo = (npx, npy, scale)
    starts = {"orientation": euler0, "pc": pc0, "joint": torch.cat([euler0, pc0], dim=1)}
    P = exp.shape[1]
    problems = {}
    for mode, x0 in starts.items():
        for spread in smoke.POP_SPREADS:
            for M in (smoke.POP_M[mode], 1) if spread == "sigma 0.5 deg" else (smoke.POP_M[mode],):
                problems[(mode, spread, M)] = smoke.population_problem(mode, x0, exp, sq, q_truth, quad, om, dc, geo,
                                                                       smoke.DETECTOR_SHAPE, M, 80 + M, spread)

    def emit(kind: str, **fields) -> None:
        print(json.dumps({"measurement": kind, **fields, "card": card()}), flush=True)

    for (mode, spread, M), (wrapper, _, _, x, pargs) in problems.items():
        if M == 1:
            continue
        taps = smoke.population_taps(mode, x[:smoke.SECTOR_POINTS], pargs)
        emit("sectors", mode=mode, spread=spread, M=M, points=smoke.SECTOR_POINTS,
             sectors_per_member_pixel={g: smoke.sectors_per_member_pixel(taps, g) for g in SECTOR_GROUPS})

    # The reference values: G = 1.
    refs = {}
    with smoke.forced_group(1):
        for key, (wrapper, _, _, x, pargs) in problems.items():
            refs[key] = wrapper(x, *pargs)
    torch.cuda.synchronize()

    ptxas = _build.BUILD_LOG.get("refine_population", "").splitlines()
    for (mode, spread, M), (wrapper, _, _, x, pargs) in problems.items():
        for group in GROUPS if M > 1 else (1,):
            with smoke.forced_group(group):
                got = wrapper(x, *pargs)
                ms = smoke.cuda_ms(lambda: wrapper(x, *pargs), args.reps)
                emit("group", mode=mode, spread=spread, n=int(x.shape[0]), M=M, P=P, group=group,
                     plan=list(rp.population_plan(P, M, mode)), ms=ms,
                     bit_for_bit=bool(torch.equal(got, refs[(mode, spread, M)])), ptxas=ptxas)
    return 0


if __name__ == "__main__":
    sys.exit(main())
