"""Time the fused int8 NCC + top-k kernel of one checkout at the main-path
shape, to compare two commits on one card.

    python3 compare_kernel_times.py --tree DIR [--reps 10]

``DIR`` is the root of a checkout (this one: ``.``). The script imports
``kikuchipy_tpu_torch`` and ``chip_smoke.py`` from ``DIR``, builds the
main path's operands from ``chip_smoke``'s seeded inputs (16,384 patterns
of 60 x 60, the 107,008 dictionary rows of whole 512-column tiles),
quantizes them, and times ``ncc_match_topk_int8`` at k=40 with CUDA
events after a warm-up, beside ``torch._int_mm`` on the same operands
and the card's clock and power. It prints one JSON line. Run it once per
checkout, alternating (parent, change, change, parent), in one call on
one card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, required=True)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
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
    from kikuchipy_tpu_torch.ops.ncc_topk import ncc_match_topk_int8

    if Path(kt.__file__).resolve().parents[1] != tree:
        print(f"compare_kernel_times: imported {kt.__file__}, not the tree's", file=sys.stderr)
        return 2
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
    exp_q, _ = _quantize_rows_int8(metric.prepare(pre.data))
    dict_q, dict_scale = _quantize_rows_int8(metric.prepare(dictionary.data))
    kq, ks = dict_q[:m_main].contiguous(), dict_scale[:m_main].contiguous()
    k = 40

    ms = smoke.cuda_ms(lambda: ncc_match_topk_int8(exp_q, kq, ks, k, 512, 512), args.reps)
    ms_lib = smoke.cuda_ms(lambda: torch._int_mm(exp_q, kq.T), args.reps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    s, i = ncc_match_topk_int8(exp_q, kq, ks, k, 512, 512)
    print(json.dumps({
        "tree": str(args.tree), "kernel": "ncc_match_topk_int8", "n": int(exp_q.shape[0]), "m": m_main,
        "d": int(exp_q.shape[1]), "k": k, "ms": ms, "int_mm_ms": ms_lib, "card": card,
        "checksum": float(np.float64(s.double().sum().item())), "idx_checksum": int(i.long().sum().item()),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
