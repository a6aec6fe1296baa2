"""Time what each part of kernel G's design costs, on one card.

    python3 neighbours_variants.py [--reps 20]

At the main path's scan (``chip_smoke.py``'s seeded 16,384 patterns of
60 x 60 uint8 on a 128 x 128 map, made as ``compare_kernel_times.py
--preprocess`` makes it) with the default circular 3 x 3 window (5 taps of
weight 1), it times kernel G (``csrc/neighbours.cu``) as the port builds it,
through ``ops/neighbours.py`` ``average_neighbours``:

- with windows of 1, 9 (rectangular 3 x 3: the integer route at 9 taps),
  9 (the Gaussian: the float64 route) and 25 (rectangular 5 x 5: any tap
  count) taps;
- on the general kernel (the scan a byte past a 16-byte boundary, so the
  vector kernel's loads do not take it): keeps the bits;

and rebuilt with the source's probe macros (its header lists them):

- ``NEIGHBOURS_POINTS`` 2, 3 and 4, map points a block of the vector
  kernel (as built: 1): these keep the bits;
- ``NEIGHBOURS_INT_MIN_BLOCKS=1``, the integer route allowed 64 registers a
  thread (as built: 32): keeps the bits;
- ``NEIGHBOURS_PROBE=1``, the float64 route where the integer route holds:
  keeps the bits;
- ``NEIGHBOURS_PROBE=2``, the float64 route without the rescale (the
  averages stored as they are, no min/max): another function; beside 1,
  what the rescale costs;
- ``NEIGHBOURS_PROBE=3``, the integer route's loads, sums and stores alone
  (each sum's low byte stored): another function; the floor of its memory
  traffic.

The kernel as built is timed first and again last. Each timing is a JSON
line: the variant, ``ms`` (launches back to back behind 2 ms of device
sleep, ``chip_smoke.cuda_ms``), ``ms_cold`` (the L2 flushed before each,
``chip_smoke.cuda_ms_cold``), the blocks an SM holds at once of the main
path's instantiation (the occupancy calculator), whether it keeps the
bits of ``average_neighbours_plain`` and the largest ``|variant - plain|``,
the device-memory rate the bytes bound counts (a byte in and a byte out a
pixel, over ``ms``) and the rate at which the SMs load pattern bytes (a
byte a tap a pixel), then the card's name, power limit, clock, power and
temperature.

Needs a CUDA device and ``nvcc``. The port calls nothing of this script.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

from compare_kernel_times import card

# (label, extra nvcc flags, whether it keeps kernel G's bits)
VARIANTS = [
    *((f"{n} points a block", [f"-DNEIGHBOURS_POINTS={n}"], True) for n in (2, 3, 4)),
    ("the integer route at up to 64 registers a thread", ["-DNEIGHBOURS_INT_MIN_BLOCKS=1"], True),
    ("the float64 route where the integer route holds", ["-DNEIGHBOURS_PROBE=1"], True),
    ("the float64 route without the rescale", ["-DNEIGHBOURS_PROBE=2"], False),
    ("the integer route's loads, sums and stores alone", ["-DNEIGHBOURS_PROBE=3"], False),
]
WINDOWS = {
    "1 tap": ("rectangular", (1, 1), {}),
    "5 taps (circular 3x3)": ("circular", (3, 3), {}),
    "9 taps (rectangular 3x3)": ("rectangular", (3, 3), {}),
    "9 taps (gaussian 3x3 std 2)": ("gaussian", (3, 3), {"std": 2}),
    "25 taps (rectangular 5x5)": ("rectangular", (5, 5), {}),
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a kernel G library's entry points (as
    ``ops/neighbours.py`` ``_library`` does)."""
    lib.neighbours_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_double)] + [ctypes.POINTER(ctypes.c_int)] * 2
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.neighbours_launch.restype = ctypes.c_int
    lib.neighbours_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.neighbours_blocks_per_sm.restype = ctypes.c_int
    return lib


def launcher(lib: ctypes.CDLL, p, offsets, weights):
    """A call of ``lib``'s kernel on the uint8 scan ``p`` that returns its
    uint8 output, on the route ``ops/neighbours.py`` ``neighbours_plan``
    chooses, as ``average_neighbours`` launches it."""
    import torch

    from kikuchipy_tpu_torch.ops import neighbours as ng
    from kikuchipy_tpu_torch.ops.pattern_io import CODES, SMEM_BUDGET

    ny, nx, sy, sx = p.shape
    n = len(weights)
    plan = ng.neighbours_plan(p.dtype, p.dtype, sy * sx, weights, 16, 16)
    w = (ctypes.c_double * n)(*weights)
    dy = (ctypes.c_int * n)(*(int(o[0]) for o in offsets))
    dx = (ctypes.c_int * n)(*(int(o[1]) for o in offsets))

    def run():
        out = torch.empty_like(p)
        err = lib.neighbours_launch(p.data_ptr(), CODES[p.dtype], out.data_ptr(), CODES[p.dtype], ny, nx, sy * sx, n,
                                    w, dy, dx, None, None, None, 0, None, int(plan.route == "vector"), plan.taps,
                                    int(plan.integer), plan.warps, 0.0, 255.0, SMEM_BUDGET,
                                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kernel G variant: cudaError_t {err}")
        return out

    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("neighbours_variants: needs a CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from kikuchipy_tpu_torch.ops import _build

    # The variants compile while the scan is made.
    out_dir = here / "kikuchipy_tpu_torch" / "_kernels_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = here / "kikuchipy_tpu_torch" / "csrc" / "neighbours.cu"
    builds = []
    for i, (label, flags, exact) in enumerate(VARIANTS):
        lib = out_dir / f"neighbours_variant_{i}.so"
        builds.append((label, exact, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.crystallography.sampling import reduce_to_fundamental_zone, super_fibonacci
    from kikuchipy_tpu_torch.ops import neighbours as ng

    spec = importlib.util.spec_from_file_location("variants_chip_smoke", here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    mp = kt.EBSDMasterPattern(smoke.master_pattern_data(), phase=Phase(name="ni", point_group="m-3m"), device=dev)
    det = kt.EBSDDetector(shape=smoke.DETECTOR_SHAPE, pc=smoke.PC, sample_tilt=70)
    side = smoke.SCAN_SIDE
    n = side * side
    truth = reduce_to_fundamental_zone(super_fibonacci(n * 7)[::7][:n], "m-3m")
    scan_u8, _ = smoke.scan_data(mp, det, truth, 0, chunk_size=8192)
    del mp
    p = torch.as_tensor(scan_u8.reshape(side, side, *smoke.DETECTOR_SHAPE), device=dev)
    npix = p.shape[2] * p.shape[3]
    flat = torch.empty(p.numel() + 16, dtype=torch.uint8, device=dev)
    shifted = flat[1:1 + p.numel()].view(p.shape)
    shifted.copy_(p)
    flush = torch.empty(smoke.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    built = bind(_build.library("neighbours"))

    def taps(name: str):
        window, shape, kw = WINDOWS[name]
        return ng.window_taps(ng._resolve_window(window, shape, **kw))

    def emit(label: str, fn, lib, window: str, exact: bool | None, data=p) -> None:
        offsets, weights = taps(window)
        ref = ng.average_neighbours_plain(data, offsets, weights, torch.uint8)
        got = fn()
        err = float((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
        if exact and err:
            raise AssertionError(f"kernel G {label!r} differs from its plain version by {err}")
        ms = smoke.cuda_ms(fn, args.reps, lead_ms=2.0)
        ms_cold = smoke.cuda_ms_cold(fn, args.reps, flush)
        plan = ng.neighbours_plan(data.dtype, torch.uint8, npix, weights, ng._alignment(data.data_ptr()), 16)
        print(json.dumps({
            "variant": label, "window": window, "taps": len(weights), "route": str(plan), "ms": ms, "ms_cold": ms_cold,
            "blocks_per_sm": lib.neighbours_blocks_per_sm(plan.warps or 8), "bit_for_bit": err == 0,
            "max_abs_err": err, "dram_bytes_tb_per_s": 2 * n * npix / ms / 1e9,
            "sm_load_bytes_tb_per_s": len(weights) * n * npix / ms / 1e9, "card": card(),
        }), flush=True)

    def as_built(label: str, window: str, data=p) -> None:
        offsets, weights = taps(window)
        emit(label, lambda: ng.average_neighbours(data, offsets, weights, torch.uint8), built, window, True, data)

    main_window = "5 taps (circular 3x3)"
    as_built("as built", main_window)
    for window in WINDOWS:
        if window != main_window:
            as_built("as built", window)
    as_built("the general kernel (data a byte past a 16-byte boundary)", main_window, shifted)
    for label, exact, lib_path, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the kernel G variant {label!r}:\n{log}")
        lib = bind(ctypes.CDLL(str(lib_path)))
        emit(label, launcher(lib, p, *taps(main_window)), lib, main_window, exact)
        lib_path.unlink()
    as_built("as built, again", main_window)
    return 0


if __name__ == "__main__":
    sys.exit(main())
