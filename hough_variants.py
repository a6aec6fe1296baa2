"""Time what each part of kernel H's design costs, on one card.

    python3 hough_variants.py [--reps 10] [--inputs FILE | --poles N]

At ``[hough]``'s inputs (``chip_smoke.py``'s seeded 16,384-pattern scan
after both background removals, its 9 bands' normals, nickel's 25 poles,
the LUT and the 15 pairs; ``--inputs`` keeps them in a file as
``compare_kernel_times.py --hough`` does), it times kernel H
(``csrc/hough_vote.cu``) as the port builds it, through
``ops/hough_vote.py`` ``vote_orientations``, at 1, 2, 4 and 8 patterns a
block (``PATTERNS_PER_BLOCK``; no rebuild), and rebuilt with the source's
probe macros (its header lists them) as built:

- ``HOUGH_MIN_BLOCKS`` 2, 3 and 4 (at most 128, 85 and 64 registers a
  thread) and ``HOUGH_POLE_UNROLL`` 1 and 4: these keep the kernel's
  results;
- ``HOUGH_PROBE=1``, no arccos (another function): what the err sums cost.

With ``--poles N`` (past 1,024: the tile route, a block a pattern) it
times it instead on ``compare_kernel_times.pole_set_inputs``' 16,384
patterns against N random poles, as built (``TILE_WARPS`` warps a
pattern) and rebuilt with ``HOUGH_TILE_WARPS`` 1, 2 and 4 and
``HOUGH_MIN_BLOCKS`` 2, 3 and 4: these keep the kernel's results,
and each is held equal to the kernel as built, bit for bit (the card
tests hold that one to its plain version).

Each timing is a JSON line: the variant, the block shape, ``ms`` (launches
back to back behind 2 ms of device sleep, ``chip_smoke.cuda_ms``), whether
it agrees (``vote_disagreements`` finds no departure from
``vote_orientations_plain``, or with ``--poles`` the kernel as built's
results are equal) and the largest R and err differences, then the card's
name, power limit, clock, power and temperature.

Needs a CUDA device and ``nvcc``. The port calls nothing of this script.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

from compare_kernel_times import _scan, card, pole_set_inputs

# (label, extra nvcc flags, whether it keeps kernel H's results)
VARIANTS = [
    ("128 registers a thread", ["-DHOUGH_MIN_BLOCKS=2"], True),
    ("85 registers a thread", ["-DHOUGH_MIN_BLOCKS=3"], True),
    ("64 registers a thread", ["-DHOUGH_MIN_BLOCKS=4"], True),
    ("a pole a step", ["-DHOUGH_POLE_UNROLL=1"], True),
    ("four poles a step", ["-DHOUGH_POLE_UNROLL=4"], True),
    ("no arccos", ["-DHOUGH_PROBE=1"], False),
]
TILE_VARIANTS = ([(f"{w} warps a pattern on the tile route", [f"-DHOUGH_TILE_WARPS={w}"], True) for w in (1, 2, 4)]
                 + [(f"{r} registers a thread on the tile route", [f"-DHOUGH_MIN_BLOCKS={b}"], True)
                    for b, r in ((2, 128), (3, 85), (4, 64))])
PATTERNS = [1, 2, 4, 8]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--inputs", type=Path, default=None)
    parser.add_argument("--poles", type=int, default=None)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("hough_variants: needs a CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from kikuchipy_tpu_torch.ops import _build

    # The variants compile while the inputs are made.
    out_dir = here / "kikuchipy_tpu_torch" / "_kernels_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = here / "kikuchipy_tpu_torch" / "csrc" / "hough_vote.cu"
    builds = []
    for i, (label, flags, exact) in enumerate(TILE_VARIANTS if args.poles else VARIANTS):
        lib = out_dir / f"hough_vote_variant_{i}.so"
        builds.append((label, exact, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.ops import hough_vote as hv

    spec = importlib.util.spec_from_file_location("variants_chip_smoke", here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if args.poles is not None:
        vote_args, tol = pole_set_inputs(16384, args.poles)
    elif args.inputs is not None and args.inputs.exists():
        saved = torch.load(args.inputs)
        vote_args, tol = tuple(t.cuda() for t in saved["args"]), saved["tol"]
    else:
        pre = _scan(smoke, kt).remove_static_background().remove_dynamic_background()
        vote_args, tol = smoke.hough_vote_inputs(pre)
    nb, ng, n_pairs = vote_args[0].shape[1], vote_args[1].shape[0], vote_args[4].shape[0]
    k = min(8, vote_args[2].shape[0])
    fn = lambda: hv.vote_orientations(*vote_args, tol)  # noqa: E731
    # With --poles the kernel as built is the reference; else the plain version.
    ref = fn() if args.poles else hv.vote_orientations_plain(*vote_args, tol)
    torch.cuda.synchronize()
    default_patterns = hv.PATTERNS_PER_BLOCK

    def emit(label: str, exact: bool, shape) -> None:
        got = fn()
        torch.cuda.synchronize()
        if args.poles:
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            bad = [] if same else ["results differ from the kernel as built"]
            r_diff, e_diff = float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).nan_to_num(0.0).abs().max())
        else:
            bad, stats = hv.vote_disagreements(got, ref, *vote_args, tol)
            r_diff, e_diff = stats["max_r_diff"], stats["max_err_diff"]
        if exact and bad:
            raise AssertionError(f"kernel H {label!r} departs from its reference: {bad}")
        print(json.dumps({
            "variant": label, "poles": ng, "shape": list(shape), "ms": smoke.cuda_ms(fn, args.reps, lead_ms=2.0),
            "agrees": not bad, "max_r_diff": r_diff, "max_err_diff": e_diff, "card": card(),
        }), flush=True)

    as_built = hv.block_shape(nb, ng, n_pairs, k)
    emit("as built", True, as_built)
    if not args.poles:
        for patterns in PATTERNS:
            hv.PATTERNS_PER_BLOCK = patterns
            emit("as built", True, hv.block_shape(nb, ng, n_pairs, k))
        hv.PATTERNS_PER_BLOCK = default_patterns
    shipped = hv._library
    built = shipped()
    for label, exact, lib_path, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the kernel H variant {label!r}:\n{log}")
        import ctypes

        lib = ctypes.CDLL(str(lib_path))
        lib.hough_vote_launch.argtypes, lib.hough_vote_launch.restype = built.hough_vote_launch.argtypes, ctypes.c_int
        lib.hough_vote_smem_bytes.argtypes = built.hough_vote_smem_bytes.argtypes
        lib.hough_vote_smem_bytes.restype = ctypes.c_longlong
        lib.hough_vote_tile_warps.restype = ctypes.c_int
        hv._library = lambda lib=lib: lib  # noqa: E731
        try:
            emit(label, exact, (as_built[0], lib.hough_vote_tile_warps() if args.poles else as_built[1]))
        finally:
            hv._library = shipped
        lib_path.unlink()
    emit("as built, again", True, as_built)
    return 0


if __name__ == "__main__":
    sys.exit(main())
