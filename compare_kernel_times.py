"""Time the fused int8, bf16 and f32 NCC + top-k kernels and the projection
kernel (kernel A) of one checkout at the main-path shape, to compare two
commits on one card.

    python3 compare_kernel_times.py --tree DIR [--reps 10]

``DIR`` is the root of a checkout (this one: ``.``). The script imports
``kikuchipy_tpu_torch`` and ``chip_smoke.py`` from ``DIR``, builds the
main path's operands from ``chip_smoke``'s seeded inputs (16,384 patterns
of 60 x 60, the 107,008 dictionary rows of whole 512-column tiles),
quantizes them, and times ``ncc_match_topk_int8``,
``ncc_match_topk_bf16`` and ``ncc_match_topk_f32`` at k=40 with CUDA
events after a warm-up (the f32 entry point's time holds whatever it does
to its operands on every call: the split into TF32 planes, where the
tree's kernel multiplies on the tensor cores), each beside the library's
product of the same operands (``torch._int_mm``, ``torch.matmul`` in bf16
and in f32 with TF32 off) and the card's clock, power and temperature
right after the kernel; first of all ``lambert_project`` on the whole
107,129 x 3600 dictionary and the ``get_patterns`` call that makes it (no
library call computes either). It prints one JSON line per kernel, with checksums of the results
(int8: equal between two commits that compute the same function; the
float kernels': equal up to near-ties and the order of their f32 sums).
Run it once per checkout, alternating (parent, change, change, parent),
on one card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def operands(tree: Path):
    """Import ``kikuchipy_tpu_torch`` and ``chip_smoke.py`` from ``tree`` and
    build the main path's prepared rows on the card: float32 ``exp``
    (16,384 x 3600) and ``dict`` (107,008 x 3600), their int8 quantization
    (``exp_q``, ``dict_q``, ``dict_scale``) and bf16 roundings. Returns
    them in a dict with ``smoke`` (the tree's ``chip_smoke`` module) and
    ``nt`` (its ``ops.ncc_topk``)."""
    tree = tree.resolve()
    sys.path.insert(0, str(tree))

    import torch

    spec = importlib.util.spec_from_file_location("tree_chip_smoke", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.crystallography.sampling import (
        reduce_to_fundamental_zone,
        sample_fundamental_zone,
        super_fibonacci,
    )
    from kikuchipy_tpu_torch.indexing.di import _quantize_rows_int8
    from kikuchipy_tpu_torch.indexing.metrics import get_metric
    from kikuchipy_tpu_torch.ops import ncc_topk as nt

    if Path(kt.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {kt.__file__}, not the tree's")
    dev = torch.device("cuda")
    mp = kt.EBSDMasterPattern(smoke.master_pattern_data(), phase=Phase(name="ni", point_group="m-3m"), device=dev)
    det = kt.EBSDDetector(shape=smoke.DETECTOR_SHAPE, pc=smoke.PC, sample_tilt=70)
    dict_rot = sample_fundamental_zone(smoke.RESOLUTION_DEG, "m-3m")
    n_scan = smoke.SCAN_SIDE**2
    truth = reduce_to_fundamental_zone(super_fibonacci(n_scan * 7)[::7][:n_scan], "m-3m")
    scan_u8, static_bg = smoke.scan_data(mp, det, truth, 0, chunk_size=8192)
    scan = kt.EBSD(scan_u8, detector=det, static_background=static_bg, device=dev)
    pre = scan.remove_static_background().remove_dynamic_background()
    dictionary = mp.get_patterns(dict_rot, det, chunk_size=8192)
    metric = get_metric("ncc")
    m_main = (dict_rot.shape[0] // 512) * 512
    exp_prep = metric.prepare(pre.data)
    dict_prep = metric.prepare(dictionary.data)[:m_main].contiguous()
    exp_q, _ = _quantize_rows_int8(exp_prep)
    dict_q, dict_scale = _quantize_rows_int8(dict_prep)
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector, quad_texture

    side = smoke.MASTER_SIDE
    projection = (torch.as_tensor(dict_rot, dtype=torch.float32, device=dev),
                  direction_cosines_from_detector(det, device=dev),
                  quad_texture(torch.as_tensor(mp._hemispheres_at_energy(), device=dev)), side, side, (side - 1) / 2)
    return {
        "lp": lp, "projection": projection, "get_patterns": lambda: mp.get_patterns(dict_rot, det, chunk_size=8192),
        "smoke": smoke, "nt": nt, "exp": exp_prep, "dict": dict_prep, "exp_q": exp_q, "dict_q": dict_q,
        "dict_scale": dict_scale, "exp_bf16": exp_prep.to(torch.bfloat16), "dict_bf16": dict_prep.to(torch.bfloat16),
    }


def card() -> str:
    """The card's name, power limit, SM clock, power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, required=True)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    ops = operands(args.tree)
    smoke, nt = ops["smoke"], ops["nt"]
    exp_q, kq, ks = ops["exp_q"], ops["dict_q"], ops["dict_scale"]
    exp_bf16, dict_bf16 = ops["exp_bf16"], ops["dict_bf16"]
    m_main = kq.shape[0]
    k = 40

    # The projection first, before the f32 kernel draws the card's whole power.
    lp, projection = ops["lp"], ops["projection"]
    for name, fn in (("lambert_project", lambda: lp.lambert_project(*projection)),
                     ("get_patterns", ops["get_patterns"])):
        ms = smoke.cuda_ms(fn, args.reps)
        after = card()
        out = fn()
        out = out if name == "lambert_project" else out.data
        print(json.dumps({
            "tree": str(args.tree), "kernel": name, "B": int(projection[0].shape[0]), "P": int(projection[1].shape[0]),
            "ms": ms, "library_product_ms": None, "card": after, "checksum": float(out.double().sum().item()),
        }), flush=True)
    runs = {
        "ncc_match_topk_int8": (lambda: nt.ncc_match_topk_int8(exp_q, kq, ks, k, 512, 512),
                                lambda: torch._int_mm(exp_q, kq.T), args.reps),
        "ncc_match_topk_bf16": (lambda: nt.ncc_match_topk_bf16(exp_bf16, dict_bf16, k, 512, 512),
                                lambda: exp_bf16 @ dict_bf16.T, args.reps),
        "ncc_match_topk_f32": (lambda: nt.ncc_match_topk_f32(ops["exp"], ops["dict"], k, 256, 512),
                               lambda: ops["exp"] @ ops["dict"].T, max(1, args.reps // 4)),
    }
    for name, (kernel, product, reps) in runs.items():
        ms = smoke.cuda_ms(kernel, reps)
        after = card()
        ms_lib = smoke.cuda_ms(product, reps)
        s, i = kernel()
        print(json.dumps({
            "tree": str(args.tree), "kernel": name, "n": int(exp_q.shape[0]), "m": m_main,
            "d": int(exp_q.shape[1]), "k": k, "ms": ms, "library_product_ms": ms_lib, "card": after,
            "checksum": float(np.float64(s.double().sum().item())), "idx_checksum": int(i.long().sum().item()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
