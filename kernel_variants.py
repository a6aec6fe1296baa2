"""Measure what the design notes of the wgmma kernels rest on, on one card.

    python3 kernel_variants.py [--reps 5]

At the main-path shape (16,384 x 107,008 x 3600, ``chip_smoke.py``'s seeded
inputs, built by ``compare_kernel_times.operands``) it prints one JSON line
per measurement, each with the card's name, power limit, clock, power and
temperature right after it:

- ``l2_read``: the rate at which the SMs read a buffer of 8 to 32 MiB that
  sits in L2, and one of 256 MiB that does not (device memory), from the
  read probe built with the int8 kernel;
- ``phases``: each wgmma kernel at k = 40 and k = 130 with the stable
  top-k, and with ``extraction="none"`` (f32: the launcher's mode 1, on
  operands already split), which runs the whole product and selects only
  the last tile's slices: the difference is what the selection costs; for
  f32 also the split of both operands into TF32 planes;
- ``half_rows``: the product-only run of each kernel on the first 1792 of
  the 3600 columns, where all experimental rows together (29 MB int8,
  59 MB bf16, 235 MB f32 as two planes) are half as large against the
  card's 50 MB L2: a time well under half of the full product's says the
  full product waits for the rows' re-reads from device memory;
- ``bf16_partial``: the bf16 kernel rebuilt with other lengths of the
  promoted partial (``-DNCC_BF16_PSTAGES``: 1, 4 and 8 stages of 64
  values) and without promotion (``-DNCC_BF16_PROMOTE=0``: all of d in the
  tensor cores' accumulator): time, and the largest difference between a
  kept score and the plain version's float64 sum over all rows;
- ``f32_partial``: the same for the f32 kernel's three TF32 products
  (``-DNCC_F32_PSTAGES``: 1, 2, 4 and 8 stages of 32 values;
  ``-DNCC_F32_PROMOTE=0``);
- ``f32_tile``: the f32 kernel rebuilt with a 128-candidate chunk
  (``-DNCC_F32_NW=128``; the kernel's is 160) and with a ring of two
  stages instead of three (``-DNCC_F32_STAGES=2``);
- ``cluster``: each kernel rebuilt with clusters of 1, 2 (the kernels')
  and 4 blocks sharing each dictionary tile (``-DNCC_CLUSTER``): time, and
  the same difference (int8: 0, bit for bit).

Needs a CUDA device and ``nvcc``. The port calls nothing of this script.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

from compare_kernel_times import card, operands

# (measurement, source stem, label, extra nvcc flags)
VARIANTS = [
    ("bf16_partial", "ncc_topk_bf16", "1 stage (64 values)", ["-DNCC_BF16_PSTAGES=1"]),
    ("bf16_partial", "ncc_topk_bf16", "4 stages (256 values), the kernel's", ["-DNCC_BF16_PSTAGES=4"]),
    ("bf16_partial", "ncc_topk_bf16", "8 stages (512 values)", ["-DNCC_BF16_PSTAGES=8"]),
    ("bf16_partial", "ncc_topk_bf16", "no promotion", ["-DNCC_BF16_PROMOTE=0"]),
    ("f32_partial", "ncc_topk_f32", "1 stage (32 values)", ["-DNCC_F32_PSTAGES=1"]),
    ("f32_partial", "ncc_topk_f32", "2 stages (64 values)", ["-DNCC_F32_PSTAGES=2"]),
    ("f32_partial", "ncc_topk_f32", "4 stages (128 values), the kernel's", ["-DNCC_F32_PSTAGES=4"]),
    ("f32_partial", "ncc_topk_f32", "8 stages (256 values)", ["-DNCC_F32_PSTAGES=8"]),
    ("f32_partial", "ncc_topk_f32", "no promotion", ["-DNCC_F32_PROMOTE=0"]),
    ("f32_tile", "ncc_topk_f32", "128 x 128, 3 stages", ["-DNCC_F32_NW=128"]),
    ("f32_tile", "ncc_topk_f32", "128 x 128, 2 stages", ["-DNCC_F32_NW=128", "-DNCC_F32_STAGES=2"]),
    ("f32_tile", "ncc_topk_f32", "128 x 160, 2 stages", ["-DNCC_F32_STAGES=2"]),
    *[("cluster", stem, label, [f"-DNCC_CLUSTER={c}"])
      for stem in ("ncc_topk_int8", "ncc_topk_bf16", "ncc_topk_f32")
      for c, label in ((1, "1 block"), (2, "2 blocks, the kernel's"), (4, "4 blocks"))],
]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    from kikuchipy_tpu_torch.ops import _build

    # The variants compile while the inputs are made.
    out_dir = here / "kikuchipy_tpu_torch" / "_kernels_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = []
    for i, (kind, stem, label, flags) in enumerate(VARIANTS):
        lib = out_dir / f"variant_{i}.so"
        src = here / "kikuchipy_tpu_torch" / "csrc" / f"{stem}.cu"
        builds.append((kind, stem, label, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    ops = operands(here)
    smoke, nt = ops["smoke"], ops["nt"]
    dev = ops["exp"].device
    n, m = ops["exp"].shape[0], ops["dict"].shape[0]

    def emit(kind: str, **fields) -> None:
        print(json.dumps({"measurement": kind, **fields, "card": card()}), flush=True)

    # ---- L2 and device-memory read rates ----
    for mib in (8, 16, 24, 32, 256):
        emit("l2_read", buffer_mib=mib, tb_per_s=smoke.l2_read_rate(dev, mib) / 1e12)

    # ---- product and selection ----
    calls = {
        "ncc_match_topk_int8": lambda k, ex: nt.ncc_match_topk_int8(
            ops["exp_q"], ops["dict_q"], ops["dict_scale"], k, 512, 512, 1, ex),
        "ncc_match_topk_bf16": lambda k, ex: nt.ncc_match_topk_bf16(ops["exp_bf16"], ops["dict_bf16"], k, 512, 512, ex),
    }
    # The f32 entry points have no extraction: the launcher on split operands.
    split = lambda: [nt.tf32_rows(ops["exp"]), nt.tf32_rows(ops["dict"])]
    e_f, w_f = split()

    def f32_call(k, ex, e=None, w=None):
        e, w = (e_f, w_f) if e is None else (e, w)
        mode = nt.wgmma_plan(torch.float32, 1, ex)["mode"]
        nt._launch("ncc_topk_f32", [e, w, *nt._outputs(n, k, dev)], [n, m, e.shape[1] // 2, k, 512, mode], dev)

    calls["ncc_match_topk_f32"] = f32_call
    emit("phases", kernel="ncc_match_topk_f32", split_ms=smoke.cuda_ms(split, args.reps))
    for name, call in calls.items():
        none_ms = smoke.cuda_ms(lambda: call(40, "none"), args.reps)
        for k in (40, 130):
            ms = smoke.cuda_ms(lambda: call(k, "stream"), args.reps)
            emit("phases", kernel=name, k=k, ms=ms, product_only_ms=none_ms, selection_ms=ms - none_ms)

    # ---- the product alone with all rows inside L2: half of each row ----
    half = 1792  # columns: 14 whole 128-byte stages of int8, 28 of bf16, 56 of f32
    exp_q_half, dict_q_half = ops["exp_q"][:, :half].contiguous(), ops["dict_q"][:, :half].contiguous()
    exp_b_half, dict_b_half = ops["exp_bf16"][:, :half].contiguous(), ops["dict_bf16"][:, :half].contiguous()
    halves = {
        "ncc_match_topk_int8": (lambda: nt.ncc_match_topk_int8(
            exp_q_half, dict_q_half, ops["dict_scale"], 40, 512, 512, 1, "none"), 1),
        "ncc_match_topk_bf16": (lambda: nt.ncc_match_topk_bf16(exp_b_half, dict_b_half, 40, 512, 512, "none"), 2),
    }
    e_f_half, w_f_half = nt.tf32_rows(ops["exp"][:, :half]), nt.tf32_rows(ops["dict"][:, :half])
    halves["ncc_match_topk_f32"] = (lambda: f32_call(40, "none", e_f_half, w_f_half), 8)
    for name, (call, itemsize) in halves.items():
        emit("half_rows", kernel=name, d=half, all_rows_mb=n * half * itemsize / 1e6,
             product_only_ms=smoke.cuda_ms(call, args.reps))

    # ---- rebuilt variants: bf16's promoted partial, and the cluster size of both kernels ----
    k = 40
    e_b, w_b = nt._kernel_rows(ops["exp_bf16"], "exp"), nt._kernel_rows(ops["dict_bf16"], "dict")
    e_q, w_q = nt._kernel_rows(ops["exp_q"], "exp_q"), nt._kernel_rows(ops["dict_q"], "dict_q")
    launch_args = {  # tensors, then the launcher's integers (mode 0; int8: group 1)
        "ncc_topk_bf16": ([e_b, w_b], [n, m, e_b.shape[1], k, 512, 0]),
        "ncc_topk_int8": ([e_q, w_q, ops["dict_scale"]], [n, m, e_q.shape[1], k, 512, 1, 0]),
        "ncc_topk_f32": ([e_f, w_f], [n, m, e_f.shape[1] // 2, k, 512, 0]),
    }
    ref = {
        "ncc_topk_bf16": nt.ncc_match_topk_bf16_plain(ops["exp"], ops["dict"], k, 512)[0],
        "ncc_topk_int8": nt.ncc_match_topk_int8_plain(ops["exp_q"], ops["dict_q"], ops["dict_scale"], k, 512)[0],
        "ncc_topk_f32": nt.ncc_match_topk_f32_plain(ops["exp"], ops["dict"], k)[0],
    }
    for kind, stem, label, lib_path, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {stem} variant {label!r}:\n{log}")
        launch = getattr(ctypes.CDLL(str(lib_path)), f"{stem}_launch")
        launch.argtypes = nt._LAUNCH_ARGTYPES[stem]
        launch.restype = ctypes.c_int
        tensors, ints = launch_args[stem]

        def run():
            out_s, out_i = nt._outputs(n, k, dev)
            err = launch(*[t.data_ptr() for t in tensors], out_s.data_ptr(), out_i.data_ptr(), *ints,
                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{stem} variant {label!r}: cudaError_t {err}")
            return out_s, out_i

        ms = smoke.cuda_ms(run, args.reps)
        s, _ = run()
        emit(kind, kernel=stem, variant=label, ms=ms, max_abs_err=float((s - ref[stem]).abs().max()))
        lib_path.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
