"""The whole slice at a small size, both packages on the same state
(carried across by kikuchipy_tpu_torch.interop): a 101x101 band-sum
master pattern, a 32x32 detector, an 8x8 uint8 scan and a 385-entry
dictionary; static + dynamic background removal, dictionary projection
and precision="pallas-int8" indexing. Top-1 indices and the crystal
maps' rotations must be equal."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from kikuchipy_tpu.crystallography.sampling import (
    disorientation_angle,
    reduce_to_fundamental_zone,
    sample_fundamental_zone,
    super_fibonacci,
)
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.ops.ncc_topk import ncc_match_topk_int8
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def state():
    master = _chip_smoke().master_pattern_data(side=101)
    jdet = JDetector(shape=(32, 32), pc=(0.42, 0.28, 0.5), sample_tilt=70)
    rot = np.asarray(sample_fundamental_zone(14.0, "m-3m"))
    truth = np.asarray(reduce_to_fundamental_zone(super_fibonacci(64 * 7)[::7][:64], "m-3m"))
    jmp = JMP(data=master)
    sim = np.asarray(jmp.get_patterns(truth, jdet, dtype_out=np.float32).data, dtype=np.float64)
    lo = sim.min(axis=(1, 2), keepdims=True)
    hi = sim.max(axis=(1, 2), keepdims=True)
    yy, xx = np.indices((32, 32))
    bg = 60 + 40 * np.exp(-((xx - 16) ** 2 + (yy - 13) ** 2) / 300)
    rng = np.random.default_rng(11)
    scan = np.clip((sim - lo) / (hi - lo) * 120 + bg + rng.normal(scale=6.0, size=sim.shape), 0, 255)
    return master, jdet, rot, truth, scan.astype(np.uint8).reshape(8, 8, 32, 32), bg.astype(np.uint8)


def test_slice_pallas_int8_matches_jax(state):
    master, jdet, rot, truth, scan, bg = state
    # JAX package
    jpre = JEBSD(data=scan, detector=jdet, static_background=bg)
    jpre = jpre.remove_static_background().remove_dynamic_background()
    jdict = JMP(data=master).get_patterns(rot, jdet)
    jx = jpre.dictionary_indexing(jdict, keep_n=5, precision="pallas-int8")
    # the port, on the same state
    tmp = interop.master_pattern_from_state(master, point_group="m-3m", device="cpu")
    tdet = interop.detector_from_state(jdet.shape, jdet.pc, jdet.sample_tilt, jdet.tilt, jdet.px_size, jdet.binning)
    tpre = TEBSD(data=scan, detector=tdet, static_background=bg, device="cpu")
    tpre = tpre.remove_static_background().remove_dynamic_background()
    tdict = tmp.get_patterns(rot, tdet)
    launches = ncc_match_topk_int8.launches
    tx = tpre.dictionary_indexing(tdict, keep_n=5, precision="pallas-int8")
    assert ncc_match_topk_int8.launches == launches  # the CPU runs the plain version

    assert tx.shape == jx.shape == (8, 8)
    np.testing.assert_array_equal(tx.prop["simulation_indices"][:, 0], jx.prop["simulation_indices"][:, 0])
    np.testing.assert_array_equal(tx.best_rotations, jx.best_rotations)
    # Preprocessing may differ by one gray level on a few pixels (float
    # round-off at integer boundaries), which moves scores by < 1e-4.
    np.testing.assert_allclose(tx.prop["scores"][:, 0], jx.prop["scores"][:, 0], atol=1e-4)
    # and the answer is right: a 14-degree dictionary recovers the truth
    ang = np.degrees(disorientation_angle(truth, tx.best_rotations, "m-3m"))
    assert np.median(ang) < 10.0, np.median(ang)
