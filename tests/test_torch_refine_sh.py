"""Refinement through the spherical-harmonic projector (``projector=
"spherical"``), the port against the JAX package on the CPU: orientation
mode with each method, in navigation chunks (on every device), with a
navigation mask and with pseudo-symmetry variants, and JAX's refusals in all
three modes (``tests/test_torch_refine_sh_pc.py`` has the PC and joint
modes).

State: a 49 x 49 band-sum master pattern (``chip_smoke.py``'s recipe), a
20 x 20 detector, a 3 x 3 scan projected at known orientations with seeded
noise, refined from starts 2 degrees off at band limit 20. Both packages
synthesize from the same coefficients (the JAX projector's, carried across
by ``kikuchipy_tpu_torch.interop.spherical_projector_from_state``).

Tolerances, those of the bilinear tests (``tests/test_torch_refinement.py``):
rotations within 0.05 degrees and scores within 1e-4; iteration counts may
differ where float32 rounding turns a step. Rotations are compared in float64
after scaling to unit length (a float32 quaternion is unit only to about
1e-7, which an arccos turns into up to 0.05 degrees).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.crystallography.crystal_map import CrystalMap as JXMap
from kikuchipy_tpu.crystallography.sampling import disorientation_angle, reduce_to_fundamental_zone, super_fibonacci
from kikuchipy_tpu.geometry import quaternion as jq
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
PC = (0.42, 0.28, 0.5)
OFF = (0.01, -0.01, 0.01)
SHAPE = (20, 20)
L = 20
MAX_ITERS = 40
ROT_TOL, SCORE_TOL = 0.05, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The objectives are small: PyTorch's thread pool beside JAX's costs
    # more than it gives.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sh_state():
    """Both packages' master pattern (sharing one expansion at band limit
    ``L``), detectors at the PC and off it, the scan and start maps."""
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    master = mod.master_pattern_data(side=49)
    n = 9
    truth = np.asarray(reduce_to_fundamental_zone(super_fibonacci(n * 7)[::7][:n], "m-3m"))
    jdet = JDetector(shape=SHAPE, pc=PC, sample_tilt=70)
    jmp = JMP(data=master)
    sim = np.asarray(jmp.get_patterns(truth, jdet, dtype_out=np.float32).data, dtype=np.float64)
    noise = np.random.default_rng(5).normal(scale=0.02 * sim.std(), size=sim.shape)
    scan = (sim + noise).astype(np.float32).reshape(3, 3, *SHAPE)
    axes = np.random.default_rng(3).normal(size=(n, 3))
    start = np.asarray(jq.multiply(jq.from_axis_angle(jnp.asarray(axes), np.deg2rad(2.0)), jnp.asarray(truth)))
    tmp = interop.master_pattern_from_state(master, point_group="m-3m", device="cpu")
    tmp._sh_cache[(None, L)] = interop.spherical_projector_from_state(
        np.asarray(jmp.spherical_projector(L=L).coeffs), L, device="cpu")
    off = np.add(PC, OFF)
    tdet = interop.detector_from_state(SHAPE, PC, 70.0)
    return dict(
        truth=truth, start=start,
        j=dict(mp=jmp, det=jdet, det_off=JDetector(shape=SHAPE, pc=off, sample_tilt=70),
               s=JEBSD(data=scan, detector=jdet), x=JXMap(rotations=start, shape=(3, 3)),
               xt=JXMap(rotations=truth, shape=(3, 3))),
        t=dict(mp=tmp, det=tdet, det_off=interop.detector_from_state(SHAPE, off, 70.0),
               s=TEBSD(data=scan, detector=tdet, device="cpu"), x=interop.crystal_map_from_state(start, shape=(3, 3)),
               xt=interop.crystal_map_from_state(truth, shape=(3, 3))),
    )


@pytest.fixture(scope="module")
def state():
    return sh_state()


def unit(q):
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def angles(a, b):
    return np.degrees(disorientation_angle(unit(a), unit(b), "m-3m"))


def call(state, side, fn, off=False, start="x", **kw):
    """``EBSD.<fn>`` of one package (``side`` "j" or "t") through the
    spherical projector, from the detector at the PC or ``off`` it and the
    ``start`` map ("x" 2 degrees off, "xt" the truth)."""
    p = state[side]
    kw = dict(projector="spherical", sh_L=L, max_iters=MAX_ITERS) | kw
    return getattr(p["s"], fn)(xmap=p[start], detector=p["det_off" if off else "det"], master_pattern=p["mp"], **kw)


def both(state, fn, off=False, start="x", **kw):
    """The JAX and the port's results on the same inputs."""
    return call(state, "j", fn, off, start, **kw), call(state, "t", fn, off, start, **kw)


def assert_same_result(jres, tres, pc_tol=None):
    ja, ta = np.asarray(jres.xmap.best_rotations), np.asarray(tres.xmap.best_rotations)
    assert ta.shape == ja.shape
    assert angles(ja, ta).max() < ROT_TOL
    js_, ts_ = np.asarray(jres.xmap.prop["scores"]), np.asarray(tres.xmap.prop["scores"])
    np.testing.assert_array_equal(np.isnan(ts_), np.isnan(js_))
    np.testing.assert_allclose(ts_, js_, atol=SCORE_TOL)
    if pc_tol is not None:
        np.testing.assert_allclose(np.asarray(tres.detector.pc), np.asarray(jres.detector.pc), atol=pc_tol)


@pytest.mark.parametrize("method", ["lm", "nm", "gradient"])
def test_orientation_matches_jax(state, method):
    jres, tres = both(state, "refine_orientation", method=method)
    assert_same_result(jres, tres)
    # Closer to the truth than the 2-degree starts, and bilinear scores.
    assert angles(state["truth"], tres.xmap.best_rotations).max() < 1.0
    assert tres.xmap.prop["scores"].min() > 0.5
    assert_similar_iterations(jres, tres, method)


def assert_similar_iterations(jres, tres, method):
    # LM: within one iteration on three points in four; gradient: all its
    # iterations; Nelder-Mead: a float32 rounding turns a simplex step, so
    # only within its bound (as the bilinear tests hold it).
    got = tres.xmap.prop["num_evals"]
    if method == "lm":
        diff = np.abs(got - np.asarray(jres.xmap.prop["num_evals"]))
        assert np.mean(diff <= 1) >= 0.75, diff
    elif method == "gradient":
        np.testing.assert_array_equal(got, np.full(got.shape, MAX_ITERS))
    else:
        assert (got > 0).all() and (got <= MAX_ITERS).all(), got


def test_orientation_in_navigation_chunks(state):
    # Adam's stop is a test over its batch, so the chunks (4, 4 and 1 padded
    # with the chunk's first point) must be JAX's.
    jres, tres = both(state, "refine_orientation", method="gradient", nav_chunk=4)
    assert_same_result(jres, tres)
    whole = both(state, "refine_orientation", method="gradient")[1]
    assert not np.array_equal(whole.xmap.best_rotations, tres.xmap.best_rotations)


def test_spherical_orientation_batches_are_bounded_on_every_device(state, monkeypatch):
    # The tier's memory grows with its batch (coefficient stacks and
    # tangents): on the CPU it keeps JAX's nav_chunk batches, and on the card
    # it takes as many whole chunks as half the free memory holds, where the
    # bilinear Nelder-Mead and LM take the whole map.
    from kikuchipy_tpu_torch.indexing import refinement as tr
    from kikuchipy_tpu_torch.projection import spherical as sp

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for method in ("lm", "nm", "gradient"):
        for projector in ("bilinear", "spherical"):
            assert tr._batch_points(cpu, 4, False, method, projector, L, 400) == 4
    assert tr._batch_points(cuda, 2048, False, "lm", "bilinear", 88, 3600) is None
    assert tr._batch_points(cuda, 2048, False, "nm", "bilinear", 88, 3600) is None
    assert tr._batch_points(cuda, 2048, False, "gradient", "spherical", 88, 3600) == 2048
    assert tr._batch_points(cuda, 2048, True, "lm", "spherical", 88, 3600) == 2048
    assert tr._batch_points(cuda, None, False, "lm", "spherical", 88, 3600) is None
    # At sh_L=88 (7,928 wide columns) and 3600 pixels a point may take
    # 4 * (48 * 7928 + 16 * 3600) = 1,752,576 bytes: 70 GiB free hold 10
    # chunks of 2048, and one chunk is the least.
    assert sp._width(88) == 7928
    assert tr._sh_batch(2048, 70 * 2**30, 88, 3600) == 20480
    assert tr._sh_batch(2048, 2 * 2048 * 1752576, 88, 3600) == 2048
    assert tr._sh_batch(2048, 2**20, 88, 3600) == 2048
    chunks = []
    chunked = tr._refine_orientation_chunked

    def spy(*args, **kw):
        chunks.append(args[10])
        return chunked(*args, **kw)

    monkeypatch.setattr(tr, "_refine_orientation_chunked", spy)
    jres, tres = both(state, "refine_orientation", method="lm", nav_chunk=4)
    assert chunks == [4]
    assert_same_result(jres, tres)


def test_orientation_with_a_navigation_mask(state):
    mask = np.zeros((3, 3), bool)
    mask[0, 1] = mask[2, 2] = True
    jres, tres = both(state, "refine_orientation", method="nm", navigation_mask=mask)
    assert_same_result(jres, tres)
    assert np.isnan(tres.xmap.prop["scores"][mask.ravel()]).all()
    np.testing.assert_array_equal(tres.xmap.best_rotations[mask.ravel()], state["start"][mask.ravel()])


def test_orientation_with_pseudo_symmetry(state):
    ops = np.asarray(jq.from_axis_angle(jnp.asarray([[0.0, 0.0, 1.0]]), np.deg2rad(30.0)))
    jres, tres = both(state, "refine_orientation", method="lm", pseudo_symmetry_ops=ops)
    assert_same_result(jres, tres)
    np.testing.assert_array_equal(tres.xmap.prop["pseudo_symmetry_index"],
                                  np.asarray(jres.xmap.prop["pseudo_symmetry_index"]))


@pytest.mark.parametrize("fn", ["refine_orientation", "refine_projection_center",
                                "refine_orientation_projection_center"])
def test_jax_refusals(state, fn):
    # JAX's ValueErrors, raised by both packages: a global solver under the
    # spherical projector (the bilinear one runs it), and in the rotating
    # modes a trust region past 10
    # degrees; an unknown sh_precision is a KeyError in both.
    tr = {"refine_orientation": [12.0] * 3, "refine_projection_center": None,
          "refine_orientation_projection_center": [12.0] * 3 + [0.01] * 3}[fn]
    cases = [(ValueError, "supports method", dict(method="de", trust_region=[1.0] * 6 if "proj" in fn else [1.0] * 3))]
    if tr is not None:
        cases.append((ValueError, "up to 10", dict(method="lm", trust_region=tr)))
    cases.append((KeyError, "fast", dict(method="lm", sh_precision="fast", max_iters=2)))
    for err, match, kw in cases:
        for side in ("j", "t"):
            with pytest.raises(err, match=match):
                call(state, side, fn, **kw)


def test_orientation_needs_a_single_pc(state):
    j, t = state["j"], state["t"]
    pcs = np.tile(PC, (9, 1))
    jdet = JDetector(shape=SHAPE, pc=pcs.reshape(3, 3, 3), sample_tilt=70)
    tdet = interop.detector_from_state(SHAPE, pcs.reshape(3, 3, 3), 70.0)
    with pytest.raises(ValueError, match="single-PC"):
        j["s"].refine_orientation(xmap=j["x"], detector=jdet, master_pattern=j["mp"], projector="spherical", sh_L=L)
    with pytest.raises(ValueError, match="single-PC"):
        t["s"].refine_orientation(xmap=t["x"], detector=tdet, master_pattern=t["mp"], projector="spherical", sh_L=L)


def test_default_precision_leaves_the_tf32_flag_as_it_was(state):
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            call(state, "t", "refine_orientation", method="lm", max_iters=2, sh_precision="default")
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
