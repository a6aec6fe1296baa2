"""Device-mesh DI and refinement (``kikuchipy_tpu_torch/parallel/mesh.py``
and ``refine.py``) on the CPU: the port on ``[cpu] * 8`` against the JAX
package on the 8 virtual devices of ``tests/conftest.py`` and against the
port's single-device calls. Indices are equal; scores agree within 1e-5
(the shards' products have other shapes, so the last bits may move);
sharded refinement equals the single-device call bit for bit."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.indexing.di import prepare_dictionary as j_prepare
from kikuchipy_tpu.parallel import mesh as jm
from kikuchipy_tpu_torch.indexing.di import dictionary_index, prepare_dictionary
from kikuchipy_tpu_torch.parallel import mesh as tm
from kikuchipy_tpu_torch.parallel import refine as tr

CPU = dict(device="cpu")
TESTS = Path(__file__).resolve().parent
CPU8 = ["cpu"] * 8
MESHES = [(8, 1), (1, 8), (2, 4), (4, 2)]


@pytest.fixture(scope="module")
def devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    return jax.devices()


@pytest.fixture
def problem():
    rng = np.random.default_rng(0)
    exp = rng.normal(size=(24, 60, 60)).astype(np.float32)
    dictionary = rng.normal(size=(160, 60, 60)).astype(np.float32)
    # Planted exact matches make the top-1 unambiguous.
    dictionary[7] = exp[0]
    dictionary[100] = exp[5]
    return exp, dictionary


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mesh(shape):
    return tm.make_mesh(*shape, devices=CPU8)


def _same(got, want, atol=1e-5):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=atol)


# ------------------------------ meshes ------------------------------ #


def test_mesh_shapes_are_jaxs(devices):
    assert tm.make_mesh(devices=CPU8).shape == jm.make_mesh().shape == {"scan": 8, "dict": 1}
    assert tm.make_mesh(n_scan=2, n_dict=4, devices=CPU8).shape == jm.make_mesh(n_scan=2, n_dict=4).shape
    assert tm.make_mesh(n_dict=2, devices=CPU8).shape == jm.make_mesh(n_dict=2).shape == {"scan": 4, "dict": 2}
    mesh = tm.make_mesh(2, 4, devices=[torch.device("cpu")] * 8)
    assert mesh.axis_names == ("scan", "dict") and mesh.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())


def test_mesh_mismatch_raises(devices):
    with pytest.raises(ValueError, match="does not match"):
        tm.make_mesh(n_scan=3, n_dict=3, devices=CPU8)
    with pytest.raises(ValueError, match="does not match"):
        jm.make_mesh(n_scan=3, n_dict=3)


# --------------------------- sharded DI --------------------------- #


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_di_matches_jax_and_single_device(devices, problem, mesh_shape):
    exp, dictionary = problem
    got = tm.sharded_dictionary_index(exp, dictionary, keep_n=5, mesh=_mesh(mesh_shape))
    _same(got, jm.sharded_dictionary_index(exp, dictionary, keep_n=5, mesh=jm.make_mesh(*mesh_shape)))
    ref = dictionary_index(exp, dictionary=dictionary, keep_n=5, **CPU)
    _same(got, (ref.scores, ref.simulation_indices))


@pytest.mark.parametrize("mesh_shape", [(8, 1), (2, 4)])
def test_mixed_precision_matches_jax(devices, problem, mesh_shape):
    exp, dictionary = problem
    got = tm.sharded_dictionary_index(exp, dictionary, keep_n=5, mesh=_mesh(mesh_shape), precision="mixed")
    want = jm.sharded_dictionary_index(exp, dictionary, keep_n=5, mesh=jm.make_mesh(*mesh_shape), precision="mixed")
    _same(got, want)
    highest = tm.sharded_dictionary_index(exp, dictionary, keep_n=5, mesh=_mesh(mesh_shape))
    np.testing.assert_array_equal(got[1][:, 0], highest[1][:, 0])


@pytest.mark.parametrize("mesh_shape", [(8, 1), (1, 8), (2, 4)])
def test_f16_approx_matches_jax(devices, problem, mesh_shape):
    exp, dictionary = problem
    kw = dict(keep_n=5, precision="f16", approx_topk=True)
    got = tm.sharded_dictionary_index(exp, dictionary, mesh=_mesh(mesh_shape), **kw)
    _same(got, jm.sharded_dictionary_index(exp, dictionary, mesh=jm.make_mesh(*mesh_shape), **kw), atol=5e-4)
    if mesh_shape[1] == 1:
        # No dict shards: each block's group compression is the single
        # device's.
        ref = dictionary_index(exp, dictionary=dictionary, **kw, **CPU)
        _same(got, (ref.scores, ref.simulation_indices), atol=1e-6)


@pytest.mark.parametrize("precision", ["f16", "int8"])
def test_prepared_dictionary_sharded(devices, problem, precision):
    exp, dictionary = problem
    prep = prepare_dictionary(dictionary, quantize=precision == "int8", **CPU)
    got = tm.sharded_dictionary_index(exp, prep, keep_n=5, mesh=_mesh((2, 4)), precision=precision)
    _same(got, tm.sharded_dictionary_index(exp, dictionary, keep_n=5, mesh=_mesh((2, 4)), precision=precision))
    want = jm.sharded_dictionary_index(exp, j_prepare(dictionary, quantize=precision == "int8"), keep_n=5,
                                       mesh=jm.make_mesh(2, 4), precision=precision)
    _same(got, want, atol=1e-5 if precision == "int8" else 5e-4)


def test_prepared_dictionary_mask_mismatch_raises(devices, problem):
    exp, dictionary = problem
    mask = np.zeros((60, 60), dtype=bool)
    mask[:10] = True  # excluded at prepare time only
    prep = prepare_dictionary(dictionary, signal_mask=mask, **CPU)
    with pytest.raises(ValueError, match="signal_mask"):
        tm.sharded_dictionary_index(exp, prep, keep_n=5, mesh=_mesh((2, 4)))


@pytest.mark.parametrize("mesh_shape, n, m", [((4, 2), 23, 157), ((8, 1), 23, 160), ((1, 8), 24, 157),
                                              ((2, 4), 24, 157), ((4, 2), 21, 155)])
@pytest.mark.parametrize("source", ["array", "int8"])
def test_padding_paths(devices, problem, mesh_shape, n, m, source):
    # The scan, the dictionary or both padded. Entry 0 is pattern 3's exact
    # match, so the dictionary's padding rows (copies of entry 0) tie with
    # it and must drop out in JAX's order.
    exp, dictionary = problem
    exp, dictionary = exp[:n], dictionary[:m].copy()
    dictionary[0] = exp[3]
    kw = dict(keep_n=4)
    if source == "int8":
        d_t, d_j, kw = prepare_dictionary(dictionary, quantize=True, **CPU), j_prepare(dictionary, quantize=True), dict(
            kw, precision="int8")
    else:
        d_t = d_j = dictionary
    got = tm.sharded_dictionary_index(exp, d_t, mesh=_mesh(mesh_shape), **kw)
    _same(got, jm.sharded_dictionary_index(exp, d_j, mesh=jm.make_mesh(*mesh_shape), **kw))
    ref = dictionary_index(exp, dictionary=d_t, **kw, **CPU)
    _same(got, (ref.scores, ref.simulation_indices))
    assert got[1].shape == (n, 4) and got[1][3, 0] == 0 and (got[1] < m).all()


@pytest.mark.parametrize("keep_n", [1, 20, 40])
def test_keep_n_past_a_shard(devices, keep_n):
    # keep_n beyond a shard's 20 entries (and the dictionary's 40, padded).
    rng = np.random.default_rng(3)
    exp = rng.normal(size=(8, 12, 12)).astype(np.float32)
    dictionary = rng.normal(size=(38, 12, 12)).astype(np.float32)
    got = tm.sharded_dictionary_index(exp, dictionary, keep_n=keep_n, mesh=_mesh((4, 2)))
    _same(got, jm.sharded_dictionary_index(exp, dictionary, keep_n=keep_n, mesh=jm.make_mesh(4, 2)))
    assert got[1].shape == (8, min(keep_n, 38))


@pytest.mark.parametrize("precision", ["highest", "int8", "mixed"])
def test_tiles_within_a_block_change_nothing(devices, problem, monkeypatch, precision):
    # A block's columns in tiles of 7 (the port bounds the tile by memory;
    # JAX takes the block whole): the stable merge of the tiles' top-k.
    from kikuchipy_tpu_torch.indexing import di

    exp, dictionary = problem
    monkeypatch.setattr(di, "_default_tile", lambda n: 7)
    got = tm.sharded_dictionary_index(exp, dictionary, keep_n=5, mesh=_mesh((2, 4)), precision=precision)
    _same(got, jm.sharded_dictionary_index(exp, dictionary, keep_n=5, mesh=jm.make_mesh(2, 4), precision=precision))


def test_signal_mask(devices, problem):
    exp, dictionary = problem
    mask = np.zeros((60, 60), dtype=bool)
    mask[:10] = True
    got = tm.sharded_dictionary_index(exp, dictionary, keep_n=3, mesh=_mesh((2, 4)), signal_mask=mask)
    _same(got, jm.sharded_dictionary_index(exp, dictionary, keep_n=3, mesh=jm.make_mesh(2, 4), signal_mask=mask))
    ref = dictionary_index(exp, dictionary=dictionary, keep_n=3, signal_mask=mask, **CPU)
    _same(got, (ref.scores, ref.simulation_indices))


@pytest.mark.parametrize("precision", ["pallas-int8", "fast"])
def test_tiers_without_a_resident_path_raise(problem, precision):
    # JAX's sharded path hands these to _index_resident, which has no such tier.
    exp, dictionary = problem
    with pytest.raises(ValueError, match="sharded dictionary indexing"):
        tm.sharded_dictionary_index(exp, dictionary, mesh=_mesh((2, 4)), precision=precision)


def test_match_topk_needs_divisible_shards(problem):
    exp = torch.zeros((6, 4))
    with pytest.raises(ValueError, match="must divide"):
        tm.sharded_match_topk(exp, torch.zeros((10, 4)), 3, _mesh((4, 2)))


def test_two_phase_sharded_merge(devices):
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu_torch.indexing.merge import merge_crystal_maps

    rng = np.random.default_rng(11)
    n, m = 24, 96
    exp = rng.normal(size=(n, 16, 16)).astype(np.float32)
    dict_a = rng.normal(size=(m, 16, 16)).astype(np.float32)
    dict_b = rng.normal(size=(m, 16, 16)).astype(np.float32)
    dict_a[:12] = exp[:12] + 0.05 * dict_a[:12]
    dict_b[:12] = exp[12:] + 0.05 * dict_b[:12]
    rot = super_fibonacci(m)

    def index_phase(dic, name, sg):
        scores, idx = tm.sharded_dictionary_index(exp, dic, keep_n=4, mesh=_mesh((2, 4)))
        _same((scores, idx), jm.sharded_dictionary_index(exp, dic, keep_n=4, mesh=jm.make_mesh(2, 4)))
        return CrystalMap(rotations=rot[idx], shape=(n,), prop={"scores": scores, "simulation_indices": idx},
                          phases=PhaseList(Phase(name, space_group=sg)))

    merged = merge_crystal_maps([index_phase(dict_a, "a", 225), index_phase(dict_b, "b", 194)])
    assert (merged.phase_id[:12] == 0).all() and (merged.phase_id[12:] == 1).all()
    assert merged.phases.names == ["a", "b"]


# ---------------------------- fused DI ---------------------------- #


@pytest.fixture(scope="module")
def fused_problem():
    """A small synthetic master, a 20 x 20 detector, 64 rotations and 16
    noisy patterns projected at 16 of them (JAX's projection)."""
    from kikuchipy_tpu.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu.geometry.detector import EBSDDetector
    from kikuchipy_tpu.projection.master_pattern import direction_cosines_from_detector, project_patterns

    master = _module("chip_smoke_inputs", TESTS.parent / "chip_smoke.py").master_pattern_data(side=81)
    det = EBSDDetector(shape=(20, 20), pc=(0.42, 0.28, 0.5), sample_tilt=70)
    dc = np.asarray(direction_cosines_from_detector(det), dtype=np.float32)
    rot = np.asarray(super_fibonacci(64), dtype=np.float32)
    npy, npx = master.shape[-2:]
    scale = (npx - 1) / 2
    sim = np.asarray(project_patterns(jnp.asarray(rot[::4]), jnp.asarray(dc), jnp.asarray(master), npx, npy, scale))
    exp = (sim + np.random.default_rng(2).normal(scale=0.05 * sim.std(), size=sim.shape)).astype(np.float32)
    return exp, rot, master, dc, npx, npy, scale


@pytest.mark.parametrize("mesh_shape", [(2, 4), (8, 1), (1, 8)])
def test_fused_matches_jax_and_the_project_fn_source(devices, fused_problem, mesh_shape):
    from kikuchipy_tpu_torch.projection.master_pattern import project_patterns

    exp, rot, master, dc, npx, npy, scale = fused_problem
    got = tm.sharded_fused_dictionary_index(exp, rot, master, dc, npx, npy, scale, keep_n=5, mesh=_mesh(mesh_shape))
    want = jm.sharded_fused_dictionary_index(exp, rot, master, dc, npx, npy, scale, keep_n=5,
                                             mesh=jm.make_mesh(*mesh_shape))
    _same(got, want)
    np.testing.assert_array_equal(got[1][:, 0], np.arange(0, 64, 4))
    master_t, dc_t = torch.as_tensor(master), torch.as_tensor(dc)
    ref = dictionary_index(exp, project_fn=lambda r: project_patterns(r.to(torch.float32), dc_t, master_t, npx, npy,
                                                                      scale), rotations=rot, keep_n=5, **CPU)
    _same(got, (ref.scores, ref.simulation_indices))


def test_fused_in_tiles_of_a_block(devices, fused_problem, monkeypatch):
    from kikuchipy_tpu_torch.indexing import di

    exp, rot, master, dc, npx, npy, scale = fused_problem
    monkeypatch.setattr(di, "_default_tile", lambda n: 5)
    got = tm.sharded_fused_dictionary_index(exp, rot, master, dc, npx, npy, scale, keep_n=5, mesh=_mesh((2, 4)))
    _same(got, jm.sharded_fused_dictionary_index(exp, rot, master, dc, npx, npy, scale, keep_n=5,
                                                 mesh=jm.make_mesh(2, 4)))


def test_fused_needs_divisible_axes(fused_problem):
    exp, rot, master, dc, npx, npy, scale = fused_problem
    with pytest.raises(ValueError, match="must divide the mesh axes"):
        tm.sharded_fused_dictionary_index(exp[:15], rot, master, dc, npx, npy, scale, mesh=_mesh((2, 4)))


# ------------------------ sharded refinement ------------------------ #

# The port against JAX's sharded refinement at the tolerances of
# tests/test_torch_refinement.py: both refine with float32 objectives summed
# in another order, which can turn a simplex step the other way, so rotations
# agree to 0.05 degrees and scores and PCs to 1e-4 (the joint mode's PCs to
# 5e-4 a point and 1e-4 over the map: both crawl along the valley where a PC
# shift trades against a rotation). Those tolerances hold for refinements run
# as long as there (60 iterations; at 30 the port's and JAX's single-device
# PCs already differ by 1.6e-4). Against the port's single-device call the
# results are equal bit for bit.
NAMES = {"orientation": ("refine_orientation", "sharded_refine_orientation"),
         "pc": ("refine_projection_center", "sharded_refine_projection_center"),
         "joint": ("refine_orientation_projection_center", "sharded_refine_orientation_projection_center")}
PC_OFF = np.array([0.004, -0.004, 0.004])


@pytest.fixture(scope="module")
def refinement():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _module("torch_multihost_worker", TESTS / "_torch_multihost_worker.py").refinement_problem(n=9)
    torch.set_num_threads(torch_threads)


@pytest.fixture(scope="module")
def jax_refinement():
    """The JAX package's master pattern and detector of the same problem."""
    from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
    from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP

    worker = _module("torch_multihost_worker", TESTS / "_torch_multihost_worker.py")
    master = _module("chip_smoke_inputs", TESTS.parent / "chip_smoke.py").master_pattern_data(side=101)
    return JMP(data=master), JDetector(shape=(32, 32), pc=worker.PC, sample_tilt=70)


def _equal_results(got, want):
    np.testing.assert_array_equal(got.xmap.rotations, want.xmap.rotations)
    assert got.xmap.prop.keys() == want.xmap.prop.keys()
    for key in want.xmap.prop:
        np.testing.assert_array_equal(got.xmap.prop[key], want.xmap.prop[key])
    np.testing.assert_array_equal(np.asarray(got.detector.pc), np.asarray(want.detector.pc))
    assert got.xmap.shape == want.xmap.shape


def _rot_deg(a, b) -> np.ndarray:
    """Rotation angle in degrees between nearby unit quaternions, in float64
    (a disorientation through float32's arccos is no finer than ~0.05
    degrees): twice their angle in four dimensions."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.where(np.sum(a * b, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    return np.degrees(4 * np.arctan2(np.linalg.norm(a - s * b, axis=-1), np.linalg.norm(a + s * b, axis=-1)))


def _close_to_jax(got, want, mode):
    assert got.xmap.shape == want.xmap.shape
    assert set(got.xmap.prop) == set(want.xmap.prop)
    assert _rot_deg(got.xmap.best_rotations, want.xmap.best_rotations).max() < 0.05
    np.testing.assert_allclose(got.xmap.prop["scores"], np.asarray(want.xmap.prop["scores"]), atol=1e-4)
    got_pc, want_pc = np.asarray(got.detector.pc), np.asarray(want.detector.pc)
    assert got_pc.shape == want_pc.shape
    if mode == "joint":
        np.testing.assert_allclose(got_pc, want_pc, atol=5e-4)
        np.testing.assert_allclose(got_pc.reshape(-1, 3).mean(0), want_pc.reshape(-1, 3).mean(0), atol=1e-4)
    else:
        np.testing.assert_allclose(got_pc, want_pc, atol=1e-4)


def _signals(refinement, jax_refinement, nav_shape, mode, pcs=None):
    """The port's and JAX's signal, start map and detector (the PC moved
    off in the PC and joint modes, or ``pcs`` a point)."""
    from kikuchipy_tpu.crystallography.crystal_map import CrystalMap as JXMap
    from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.signals.ebsd import EBSD

    mp, det, scan, start = refinement
    jmp, jdet = jax_refinement
    if pcs is None and mode != "orientation":
        pcs = np.asarray(det.pc).reshape(-1, 3)[0] + PC_OFF
    if pcs is not None:
        det, jdet = dataclasses.replace(det, pc=pcs), dataclasses.replace(jdet, pc=pcs)
    data = scan.reshape(nav_shape + scan.shape[1:])
    port = (EBSD(data=data, detector=det, **CPU), CrystalMap(rotations=start, shape=nav_shape), det, mp)
    jax_side = (JEBSD(data=data, detector=jdet), JXMap(rotations=start, shape=nav_shape), jdet, jmp)
    return port, jax_side


@pytest.mark.parametrize("mode, method", [("orientation", "nm"), ("pc", "nm"), ("joint", "nm"), ("orientation", "lm")])
def test_sharded_refinement_is_the_single_device_call(devices, refinement, jax_refinement, mode, method):
    # 9 points of a 3 x 3 map pad to 12 over 4 shards; PC and joint modes
    # return one PC a point in the map's shape.
    from kikuchipy_tpu.parallel import refine as jpr

    (sig, xmap, det, mp), (jsig, jxmap, jdet, jmp) = _signals(refinement, jax_refinement, (3, 3), mode)
    single, sharded = NAMES[mode]
    kw = dict(max_iters=60, method=method)
    want = getattr(sig, single)(xmap=xmap, detector=det, master_pattern=mp, **kw)
    got = getattr(tr, sharded)(sig, xmap=xmap, detector=det, master_pattern=mp, mesh=tm.make_mesh(devices=CPU8[:4]),
                               **kw)
    _equal_results(got, want)
    jgot = getattr(jpr, sharded)(jsig, xmap=jxmap, detector=jdet, master_pattern=jmp,
                                 mesh=jm.make_mesh(devices=jax.devices()[:4]), **kw)
    _close_to_jax(got, jgot, mode)
    if mode != "orientation":
        assert np.asarray(got.detector.pc).shape == (3, 3, 3)


def test_sharded_refinement_pads_per_point_pcs(devices, refinement, jax_refinement):
    from kikuchipy_tpu.parallel import refine as jpr

    mp, det, _, _ = refinement
    pcs = np.asarray(det.pc).reshape(1, 3) + np.random.default_rng(4).uniform(-2e-3, 2e-3, (9, 3))
    (sig, xmap, det, mp), (jsig, jxmap, jdet, jmp) = _signals(refinement, jax_refinement, (9,), "orientation", pcs)
    kw = dict(xmap=xmap, detector=det, master_pattern=mp, max_iters=20)
    got = tr.sharded_refine_orientation(sig, mesh=tm.make_mesh(devices=CPU8[:4]), **kw)
    _equal_results(got, sig.refine_orientation(**kw))
    assert np.asarray(got.detector.pc).shape == (9, 3)
    jkw = dict(xmap=jxmap, detector=jdet, master_pattern=jmp, max_iters=20)
    _close_to_jax(got, jpr.sharded_refine_orientation(jsig, mesh=jm.make_mesh(devices=jax.devices()[:4]), **jkw),
                  "orientation")
    with pytest.raises(ValueError, match="PCs for 9 map points"):
        tr.sharded_refine_orientation(sig, mesh=tm.make_mesh(devices=CPU8[:4]),
                                      **dict(kw, detector=dataclasses.replace(det, pc=pcs[:5])))
    with pytest.raises(ValueError, match="PCs for 9 map points"):
        jpr.sharded_refine_orientation(jsig, mesh=jm.make_mesh(devices=jax.devices()[:4]),
                                       **dict(jkw, detector=dataclasses.replace(jdet, pc=pcs[:5])))


@pytest.mark.parametrize("mode", ["orientation", "pc"])
def test_sharded_refinement_of_one_point(devices, refinement, jax_refinement, mode):
    # One point on one shard: nothing to pad, and the PC field's shape is
    # JAX's whether the detector has one PC or one a point.
    from kikuchipy_tpu.parallel import refine as jpr

    mp, det, scan, start = refinement
    one = (mp, det, scan[:1], start[:1])
    (sig, xmap, det, mp), (jsig, jxmap, jdet, jmp) = _signals(one, jax_refinement, (1,), mode)
    single, sharded = NAMES[mode]
    kw = dict(max_iters=20)
    got = getattr(tr, sharded)(sig, xmap=xmap, detector=det, master_pattern=mp, mesh=tm.make_mesh(devices=CPU8[:1]),
                               **kw)
    _equal_results(got, getattr(sig, single)(xmap=xmap, detector=det, master_pattern=mp, **kw))
    jgot = getattr(jpr, sharded)(jsig, xmap=jxmap, detector=jdet, master_pattern=jmp,
                                 mesh=jm.make_mesh(devices=jax.devices()[:1]), **kw)
    _close_to_jax(got, jgot, mode)
