"""Time what each part of kernel D's dynamic pair kernel and kernel E's pair
kernel costs, on one card.

    python3 preprocess_variants.py [--reps 20]

At the main path's scan (``chip_smoke.py``'s seeded 16,384 patterns of
60 x 60 uint8, made as ``compare_kernel_times.py --preprocess`` makes it)
it times, each through the port's wrappers or the same C entry points:

- kernel D's dynamic mode on the static-corrected scan: the pair kernel as
  built (``ops/background.py`` ``dynamic_path``: 8 pairs a block), with 2,
  4 and 6 pairs a block, and the block kernel it replaces on the main path;
- kernel E on the dynamic-corrected scan: the pair kernel as built
  (``ops/ahe.py`` ``clahe_path``), with 2 and 4 pairs a block, rebuilt with
  ``-DCLAHE_CDF_TILES`` 1, 2 and 4 (tiles a warp maps in lockstep; 8 as
  built) and with ``-DCLAHE_HIST_MATCH`` (the histogram by warp-aggregated
  atomics: ``__match_any_sync`` on the (tile, bin) key, one add of the
  count a key), and the block kernel it replaces.

The kernels as built are timed first and again last. Each timing is a JSON
line: the kernel, the variant, ``ms`` (launches back to back behind 2 ms of
device sleep, ``chip_smoke.cuda_ms``), ``ms_cold`` (the L2 flushed before
each, ``chip_smoke.cuda_ms_cold``), ``same_bytes`` (every variant's bytes
are the kernel's as built, or the script stops), then the card's name,
power limit, clock, power and temperature.

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

# (kernel, label, extra nvcc flags); each keeps the kernel's bytes.
VARIANTS = [
    ("E", "one tile a warp at a time in the mapping", ["-DCLAHE_CDF_TILES=1"]),
    ("E", "two tiles a warp at a time in the mapping", ["-DCLAHE_CDF_TILES=2"]),
    ("E", "four tiles a warp at a time in the mapping", ["-DCLAHE_CDF_TILES=4"]),
    ("E", "the histogram by warp-aggregated atomics", ["-DCLAHE_HIST_MATCH"]),
]
SOURCES = {"D": "background", "E": "clahe"}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of the pair kernels' entry points."""
    if hasattr(lib, "background_dynamic_launch"):
        lib.background_dynamic_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                                  + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_void_p])
        lib.background_blocks.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.background_dynamic_launch.restype = lib.background_blocks.restype = ctypes.c_int
    else:
        lib.clahe_pair_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4
                                          + [ctypes.c_int, ctypes.c_void_p])
        lib.clahe_pair_launch.restype = ctypes.c_int
    return lib


def d_launcher(lib, p, row, col, pairs: int):
    """kernel D's dynamic pair kernel of ``lib`` on ``p`` (subtract, uint8),
    as ``ops/background.py`` ``remove_background`` launches it."""
    import torch

    from kikuchipy_tpu_torch.ops import background as bgk

    n, sy, sx = p.shape
    smem = bgk.dynamic_smem_bytes(sy, sx, pairs)
    blocks = ctypes.c_int(0)
    if lib.background_blocks(-1, 0, 0, 64 * pairs, smem, bgk.SMEM_BUDGET, ctypes.byref(blocks)):
        raise RuntimeError("background_blocks failed")
    grid = min(blocks.value, -(-n // pairs))

    def run():
        out = torch.empty_like(p)
        err = lib.background_dynamic_launch(p.data_ptr(), out.data_ptr(), row.data_ptr(), col.data_ptr(), n, sy, sx,
                                            0, 0.0, 255.0, pairs, grid, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kernel D variant: cudaError_t {err}")
        return out

    return run


def e_launcher(lib, p, pairs: int):
    """kernel E's pair kernel of ``lib`` on ``p`` at the defaults (uint8,
    15 x 15 tiles, 128 bins, no clipping), as ``ops/ahe.py`` ``clahe``
    launches it."""
    import numpy as np
    import torch

    n, sy, sx = p.shape
    inv_nbins = float(np.float32(1.0) / np.float32(128))

    def run():
        out = torch.empty_like(p)
        err = lib.clahe_pair_launch(p.data_ptr(), out.data_ptr(), n, sy, sx, sy // 4, sx // 4, 0.0, inv_nbins, 0.0,
                                    255.0, pairs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kernel E variant: cudaError_t {err}")
        return out

    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("preprocess_variants: needs a CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from kikuchipy_tpu_torch.ops import _build

    # The variants compile while the scan is made.
    out_dir = here / "kikuchipy_tpu_torch" / "_kernels_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = []
    for i, (kernel, label, flags) in enumerate(VARIANTS):
        src = here / "kikuchipy_tpu_torch" / "csrc" / f"{SOURCES[kernel]}.cu"
        lib = out_dir / f"preprocess_variant_{i}.so"
        builds.append((kernel, label, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.crystallography.sampling import reduce_to_fundamental_zone, super_fibonacci
    from kikuchipy_tpu_torch.ops import ahe
    from kikuchipy_tpu_torch.ops import background as bgk
    from kikuchipy_tpu_torch.ops import pattern as tops

    spec = importlib.util.spec_from_file_location("variants_chip_smoke", here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    mp = kt.EBSDMasterPattern(smoke.master_pattern_data(), phase=Phase(name="ni", point_group="m-3m"), device=dev)
    det = kt.EBSDDetector(shape=smoke.DETECTOR_SHAPE, pc=smoke.PC, sample_tilt=70)
    n = smoke.SCAN_SIDE**2
    truth = reduce_to_fundamental_zone(super_fibonacci(n * 7)[::7][:n], "m-3m")
    scan_u8, static_bg = smoke.scan_data(mp, det, truth, 0, chunk_size=8192)
    del mp
    flat = torch.as_tensor(scan_u8, device=dev).reshape(-1, *smoke.DETECTOR_SHAPE)
    bg = torch.as_tensor(static_bg, dtype=torch.float32, device=dev)
    plan = tops.dynamic_background_separable_plan(smoke.DETECTOR_SHAPE, smoke.DETECTOR_SHAPE[1] / 8)
    row, col = torch.as_tensor(plan.row_op, device=dev), torch.as_tensor(plan.col_op, device=dev)
    static_u8 = bgk.remove_background(flat, "subtract", 0, 255, np.uint8, static_bg=bg)
    dyn_u8 = bgk.remove_background(static_u8, "subtract", 0, 255, np.uint8, row_op=row, col_op=col)
    sy, sx = smoke.DETECTOR_SHAPE
    d_path, e_path = bgk.dynamic_path(sy, sx, np.uint8, np.uint8), ahe.clahe_path(sy, sx, sy // 4, sx // 4, 128,
                                                                                    np.uint8, np.uint8)
    if d_path[0] != "pair" or e_path[0] != "pair":
        raise RuntimeError(f"the main path's shape takes {d_path}, {e_path}")
    flush = torch.empty(smoke.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    built = {"D": bind(_build.library("background")), "E": bind(_build.library("clahe"))}
    as_built = {
        "D": lambda: bgk.remove_background(static_u8, "subtract", 0, 255, np.uint8, row_op=row, col_op=col),
        "E": lambda: ahe.clahe(dyn_u8, 15, 15, 128, 0.0, np.uint8),
    }
    ref = {key: fn() for key, fn in as_built.items()}

    def emit(kernel: str, label: str, fn) -> None:
        if not torch.equal(fn(), ref[kernel]):
            raise AssertionError(f"kernel {kernel} {label!r} changed the kernel's bytes")
        print(json.dumps({
            "kernel": kernel, "variant": label, "ms": smoke.cuda_ms(fn, args.reps, lead_ms=2.0),
            "ms_cold": smoke.cuda_ms_cold(fn, args.reps, flush), "same_bytes": True, "card": card(),
        }), flush=True)

    def block_kernel(kernel: str):
        """The block kernel through the wrapper, as every other call takes it."""
        chooser = (bgk, "dynamic_path") if kernel == "D" else (ahe, "clahe_path")

        def run():
            with smoke.forced_block(*chooser):
                return as_built[kernel]()

        return run

    for kernel in ("D", "E"):
        emit(kernel, f"as built ({(d_path if kernel == 'D' else e_path)[1]} pairs a block)", as_built[kernel])
    for pairs in (2, 4, 6):
        emit("D", f"{pairs} pairs a block", d_launcher(built["D"], static_u8, row, col, pairs))
    for pairs in (2, 4):
        emit("E", f"{pairs} pairs a block", e_launcher(built["E"], dyn_u8, pairs))
    for kernel in ("D", "E"):
        emit(kernel, "the block kernel (one block a pattern)", block_kernel(kernel))
    for kernel, label, lib_path, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the kernel {kernel} variant {label!r}:\n{log}")
        lib = bind(ctypes.CDLL(str(lib_path)))
        fn = (d_launcher(lib, static_u8, row, col, d_path[1]) if kernel == "D"
              else e_launcher(lib, dyn_u8, e_path[1]))
        emit(kernel, label, fn)
        lib_path.unlink()
    for kernel in ("D", "E"):
        emit(kernel, "as built, again", as_built[kernel])
    return 0


if __name__ == "__main__":
    sys.exit(main())
