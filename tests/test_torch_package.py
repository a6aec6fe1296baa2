"""Rules of the port: it imports neither JAX nor the JAX package, its
entry points run on the card unless told otherwise, and the kernel
wrapper counts only launches of the kernel."""

import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kikuchipy_tpu_torch
from kikuchipy_tpu_torch.ops import _build
from kikuchipy_tpu_torch.ops.ncc_topk import ncc_match_topk_int8

PKG = Path(kikuchipy_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="kikuchipy_tpu_torch.")
    )


def test_imports_leave_no_jax_in_sys_modules():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'kikuchipy_tpu' or m.startswith('kikuchipy_tpu.')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_import_statement_names_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|kikuchipy_tpu)(\s|\.|$)", re.M)
    for path in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


@pytest.mark.parametrize(
    "call",
    [
        lambda: kikuchipy_tpu_torch.dictionary_index(np.ones((2, 4, 4)), np.ones((3, 4, 4))),
        lambda: kikuchipy_tpu_torch.prepare_dictionary(np.ones((3, 4, 4))),
        lambda: kikuchipy_tpu_torch.EBSD(np.ones((2, 4, 4), np.uint8)),
        lambda: kikuchipy_tpu_torch.EBSDMasterPattern(np.ones((2, 5, 5), np.float32)),
        lambda: importlib.import_module("kikuchipy_tpu_torch.ops.pattern").remove_dynamic_background(
            np.ones((1, 8, 8), np.uint8)
        ),
    ],
)
def test_entry_points_default_to_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_wrapper_on_cpu_does_not_count_launches():
    rng = np.random.default_rng(0)
    e = torch.from_numpy(rng.integers(-127, 128, (8, 32), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (32, 32), dtype=np.int8))
    sc = torch.ones(32)
    before = ncc_match_topk_int8.launches
    ncc_match_topk_int8(e, w, sc, k=4, tile_n=8, tile_m=32)
    assert ncc_match_topk_int8.launches == before


def test_kernel_sources_and_build_directory():
    srcs = _build.sources()
    assert "ncc_topk_int8" in srcs
    text = srcs["ncc_topk_int8"].read_text()
    assert "mma.sync.aligned.m16n8k32" in text and "ncc_match_topk_pallas_v5" in text
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "kikuchipy_tpu_torch/_kernels_build/" in ignored


def test_chip_smoke_refuses_without_a_card(tmp_path):
    # Alone in a directory (no checkout beside it) it must fail, and print
    # no result; here there is no card either.
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
