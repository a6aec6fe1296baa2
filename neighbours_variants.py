"""Time what each part of kernel G's design costs, on one card.

    python3 neighbours_variants.py [--reps 20]

At the main path's scan (``chip_smoke.py``'s seeded 16,384 patterns of
60 x 60 uint8 on a 128 x 128 map, made as ``compare_kernel_times.py
--preprocess`` makes it) with the default circular 3 x 3 window (5 taps),
it times kernel G (``csrc/neighbours.cu``) as the port builds it, through
``ops/neighbours.py`` ``average_neighbours``, and rebuilt with the source's
probe macros (its header lists them):

- ``NEIGHBOURS_THREADS`` 128, 512 and 1024 threads a block (the kernel's
  256), and ``NEIGHBOURS_FIXED_TAPS=5`` (the tap loop unrolled): these keep
  the kernel's bits;
- ``NEIGHBOURS_PROBE=4``, two passes that each compute the averages and no
  shared scratch (the design without a cap on the pattern size): keeps
  the bits;
- ``NEIGHBOURS_PROBE=1`` (float32 sums), ``=3`` (integer sums of the
  uint8 values) and ``=2`` (no rescale): each computes another function,
  and takes away one part of the work (the float64 work; every conversion
  a tap; the block min/max with the second pass).

It also times the kernel as built with windows of 1, 9 (rectangular
3 x 3) and 25 (rectangular 5 x 5) taps. The kernel as built is timed first
and again last. Each timing is a JSON line: the variant, ``ms`` (launches
back to back behind 2 ms of device sleep, ``chip_smoke.cuda_ms``),
``ms_cold`` (the L2 flushed before each, ``chip_smoke.cuda_ms_cold``), the
blocks an SM holds at once (the occupancy calculator), the largest
``|variant - plain|`` against ``average_neighbours_plain`` of the kernel's
function, the device-memory rate the bytes bound counts (a byte in and a
byte out a pixel, over ``ms``) and the rate at which the SMs load pattern
bytes (a byte a tap a pixel), then the card's name, power limit, clock,
power and temperature.

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
    ("128 threads a block", ["-DNEIGHBOURS_THREADS=128"], True),
    ("512 threads a block", ["-DNEIGHBOURS_THREADS=512"], True),
    ("1024 threads a block", ["-DNEIGHBOURS_THREADS=1024"], True),
    ("5 taps fixed at compile time", ["-DNEIGHBOURS_FIXED_TAPS=5"], True),
    ("two passes, no shared scratch", ["-DNEIGHBOURS_PROBE=4"], True),
    ("float32 sums", ["-DNEIGHBOURS_PROBE=1"], False),
    ("integer sums of the uint8 values", ["-DNEIGHBOURS_PROBE=3"], False),
    ("no rescale", ["-DNEIGHBOURS_PROBE=2"], False),
]
WINDOWS = {
    1: ("rectangular", (1, 1)),
    5: ("circular", (3, 3)),
    9: ("rectangular", (3, 3)),
    25: ("rectangular", (5, 5)),
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a kernel G library's entry points."""
    lib.neighbours_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.neighbours_launch.restype = ctypes.c_int
    lib.neighbours_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.neighbours_blocks_per_sm.restype = ctypes.c_int
    return lib


def launcher(lib: ctypes.CDLL, p, offsets, weights):
    """A call of ``lib``'s kernel on the uint8 scan ``p`` that returns its
    uint8 output, as ``ops/neighbours.py`` ``average_neighbours`` launches
    it."""
    import torch

    from kikuchipy_tpu_torch.ops.pattern_io import CODES, SMEM_BUDGET

    ny, nx, sy, sx = p.shape
    n = len(weights)
    w = (ctypes.c_double * n)(*weights)
    dy = (ctypes.c_int * n)(*(int(o[0]) for o in offsets))
    dx = (ctypes.c_int * n)(*(int(o[1]) for o in offsets))

    def run():
        out = torch.empty_like(p)
        err = lib.neighbours_launch(p.data_ptr(), CODES[p.dtype], out.data_ptr(), CODES[p.dtype], ny, nx, sy * sx, n,
                                    w, dy, dx, None, None, None, 0, 0.0, 255.0, SMEM_BUDGET,
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
    flush = torch.empty(smoke.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    built = bind(_build.library("neighbours"))

    def taps(n_taps: int):
        window, shape = WINDOWS[n_taps]
        offsets, weights = ng.window_taps(ng._resolve_window(window, shape))
        assert len(weights) == n_taps, (window, shape, len(weights))
        return offsets, weights

    def emit(label: str, fn, lib, n_taps: int, exact: bool | None) -> None:
        offsets, weights = taps(n_taps)
        ref = ng.average_neighbours_plain(p, offsets, weights, torch.uint8)
        got = fn()
        err = float((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
        if exact and err:
            raise AssertionError(f"kernel G {label!r} differs from its plain version by {err}")
        ms = smoke.cuda_ms(fn, args.reps, lead_ms=2.0)
        ms_cold = smoke.cuda_ms_cold(fn, args.reps, flush)
        print(json.dumps({
            "variant": label, "taps": n_taps, "ms": ms, "ms_cold": ms_cold,
            "blocks_per_sm": lib.neighbours_blocks_per_sm(npix), "bit_for_bit": err == 0, "max_abs_err": err,
            "dram_bytes_tb_per_s": 2 * n * npix / ms / 1e9, "sm_load_bytes_tb_per_s": n_taps * n * npix / ms / 1e9,
            "card": card(),
        }), flush=True)

    def as_built(label: str, n_taps: int) -> None:
        offsets, weights = taps(n_taps)
        emit(label, lambda: ng.average_neighbours(p, offsets, weights, torch.uint8), built, n_taps, True)

    as_built("as built", 5)
    for n_taps in (1, 9, 25):
        as_built("as built", n_taps)
    for label, exact, lib_path, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the kernel G variant {label!r}:\n{log}")
        lib = bind(ctypes.CDLL(str(lib_path)))
        emit(label, launcher(lib, p, *taps(5)), lib, 5, exact)
        lib_path.unlink()
    as_built("as built, again", 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
