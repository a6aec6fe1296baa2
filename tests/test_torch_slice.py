"""The whole slice at a small size, both packages on the same state
(carried across by kikuchipy_tpu_torch.interop): a 101x101 band-sum
master pattern, a 32x32 detector, an 8x8 uint8 scan and a 385-entry
dictionary; static + dynamic background removal, dictionary projection
and precision="pallas-int8" indexing. Top-1 indices and the crystal
maps' rotations must be equal."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _prepared_rows(state):
    """The JAX package's prepared scan (64 rows) and dictionary (the 384
    rows of three 128-column tiles), unit-norm float32."""
    from kikuchipy_tpu.indexing.metrics import get_metric

    master, jdet, rot, truth, scan, bg = state
    jpre = JEBSD(data=scan, detector=jdet, static_background=bg)
    jpre = jpre.remove_static_background().remove_dynamic_background()
    jdict = JMP(data=master).get_patterns(rot, jdet)
    metric = get_metric("ncc")
    exp = np.array(metric.prepare(jnp.asarray(jpre.data)), dtype=np.float32)
    dic = np.array(metric.prepare(jnp.asarray(jdict.data)), dtype=np.float32)[:384]
    return exp, dic


@pytest.mark.parametrize("kernel", ["v1", "v3", "v4", "v5"])
def test_slice_kernel_entry_points_match_jax(state, kernel):
    # This slice's path: prepared scan + prepared dictionary -> each of
    # the four fused-kernel entry points, k = 10, against the TPU kernels
    # in interpret mode on the same rows.
    from kikuchipy_tpu.indexing.di import _quantize_rows_int8
    from kikuchipy_tpu.ops import pallas_di as pd
    from kikuchipy_tpu_torch.ops import ncc_topk as nt

    exp, dic = _prepared_rows(state)
    tiles = dict(tile_n=64, tile_m=128)
    if kernel == "v5":
        eq, _ = _quantize_rows_int8(jnp.asarray(exp))
        dq, ds = _quantize_rows_int8(jnp.asarray(dic))
        ref = pd.ncc_match_topk_pallas_v5(eq, dq, ds, 10, interpret=True, **tiles)
        got = nt.ncc_match_topk_int8(*(torch.from_numpy(np.array(x)) for x in (eq, dq, ds)), 10, **tiles)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        return
    jax_fn, port_fn, kw = {
        "v1": (pd.ncc_match_topk_pallas, nt.ncc_match_topk_f32, {}),
        "v3": (pd.ncc_match_topk_pallas_v3, nt.ncc_match_topk_f32_blocked, {"tile_d": 256}),
        "v4": (pd.ncc_match_topk_pallas_v4, nt.ncc_match_topk_bf16, {}),
    }[kernel]
    ref = jax_fn(jnp.asarray(exp), jnp.asarray(dic), 10, interpret=True, **tiles, **kw)
    got = port_fn(torch.from_numpy(exp), torch.from_numpy(dic), 10, **tiles, **kw)
    ref_s = np.asarray(ref[0])
    np.testing.assert_allclose(got[0].numpy(), ref_s, atol=1e-5)
    gap_prev = np.full(ref_s.shape, np.inf)
    gap_prev[:, 1:] = ref_s[:, :-1] - ref_s[:, 1:]
    gap_next = np.full(ref_s.shape, -np.inf)
    gap_next[:, :-1] = ref_s[:, :-1] - ref_s[:, 1:]
    clear = (gap_prev > 2e-5) & (gap_next > 2e-5)
    assert clear[:, 0].mean() > 0.9
    np.testing.assert_array_equal(got[1].numpy()[clear], np.asarray(ref[1])[clear])


def test_slice_fused_projector_f16_approx_matches_jax(state):
    from kikuchipy_tpu.indexing import di as jdi
    from kikuchipy_tpu_torch.indexing import di as tdi

    master, jdet, rot, truth, scan, bg = state
    jpre = JEBSD(data=scan, detector=jdet, static_background=bg)
    jpre = jpre.remove_static_background().remove_dynamic_background()
    tdet = interop.detector_from_state(jdet.shape, jdet.pc, jdet.sample_tilt, jdet.tilt, jdet.px_size, jdet.binning)
    tpre = TEBSD(data=scan, detector=tdet, static_background=bg, device="cpu")
    tpre = tpre.remove_static_background().remove_dynamic_background()
    jproj = JMP(data=master).projector(jdet)
    tproj = interop.master_pattern_from_state(master, point_group="m-3m", device="cpu").projector(tdet)
    # f32 trigonometry differs in the last bits between the frameworks; on
    # this band-sum master's steep edges that moves a pattern by < 1e-4.
    np.testing.assert_allclose(tproj(rot[:16]).numpy(), np.asarray(jproj(jnp.asarray(rot[:16]))), atol=1e-4)

    kw = dict(keep_n=5, precision="f16", approx_topk=True, n_per_iteration=128)
    ref = jdi.dictionary_index(jpre.data, project_fn=jproj, rotations=rot, **kw)
    got = tdi.dictionary_index(tpre.data, project_fn=tproj, rotations=rot, device="cpu", **kw)
    # Preprocessing may differ by one gray level on a few pixels (< 1e-4
    # in a score), and f16 rounding adds up to one f16 step (2**-11).
    np.testing.assert_allclose(got.scores, ref.scores, atol=1e-4 + 2.0**-11)
    gap = ref.scores[:, 0] - ref.scores[:, 1]
    clear = gap > 2 * (1e-4 + 2.0**-11)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.simulation_indices[clear, 0], ref.simulation_indices[clear, 0])
    ang = np.degrees(disorientation_angle(truth, rot[got.simulation_indices[:, 0]], "m-3m"))
    assert np.median(ang) < 10.0, np.median(ang)


def test_projector_requires_a_single_pc():
    det = interop.detector_from_state((8, 8), np.full((2, 3), 0.5))
    mp = interop.master_pattern_from_state(np.ones((2, 11, 11), np.float32), device="cpu")
    with pytest.raises(ValueError, match="single-PC"):
        mp.projector(det)
