"""``LazyEBSD`` on the CPU, after ``tests/test_lazy.py``: every chainable
operation gives the port's eager bytes a chunk at a time (chunk sizes that
split map rows), the halo chain with neighbour averaging at several chunk
sizes, chains after a neighbourhood operation, the probe's attributes, the
sources (a tensor, a NumPy array, the binary readers' memory maps, an HDF5
dataset), the chunk-streamed ``save``, and streamed dictionary indexing and
refinement against the eager calls (indices equal, scores within 1e-6,
rotations within 1e-5). The port's lazy results are also held against JAX's
``LazyEBSD`` on the same scan, to the tolerances of the eager parity tests
(the CPU's preprocessing is JAX's within one gray level)."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import kikuchipy_tpu as kp
import kikuchipy_tpu_torch as kt
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD
from kikuchipy_tpu_torch.signals.lazy import ArraySource, H5Source, LazyEBSD

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def data():
    rng = np.random.default_rng(7)
    return rng.integers(10, 250, size=(6, 5, 12, 14), dtype=np.uint8), rng.integers(20, 200, (12, 14), np.uint8)


@pytest.fixture()
def scan(data):
    return TEBSD(data=data[0], static_background=data[1], device="cpu")


def _jax(data):
    return JEBSD(data=data[0], static_background=data[1])


OPS = [
    ("rescale_intensity", {}),
    ("rescale_intensity", {"dtype_out": np.float32}),
    ("normalize_intensity", {}),
    ("remove_static_background", {"operation": "subtract"}),
    ("remove_static_background", {"operation": "divide"}),
    ("remove_dynamic_background", {"operation": "subtract"}),
    ("remove_dynamic_background", {"filter_domain": "spatial"}),
    ("get_dynamic_background", {}),
    ("adaptive_histogram_equalization", {"kernel_size": (6, 7)}),
    ("downsample", {"factor": 2}),
    ("rebin", {"scale": (1, 1, 2, 2)}),
    ("change_dtype", {"dtype": np.float32}),
    ("fft_filter", {"transfer_function": np.ones((12, 14)), "shift": True}),
    ("average_neighbour_patterns", {}),
    ("average_neighbour_patterns", {"window": "gaussian", "window_shape": (3, 3), "std": 1.0}),
]


def _close_to_jax(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind in "iu":
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.05
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class TestLazyEagerParity:
    @pytest.mark.parametrize("op,kwargs", OPS, ids=lambda p: str(p)[:40])
    @pytest.mark.parametrize("chunk_size", [7, 30, 1024])
    def test_single_op(self, scan, data, op, kwargs, chunk_size):
        eager = getattr(scan, op)(**kwargs)
        lazy = getattr(scan.as_lazy(chunk_size=chunk_size), op)(**kwargs).compute()
        assert lazy.data.dtype == eager.data.dtype and lazy.signal_shape == eager.signal_shape
        assert torch.equal(lazy.data, eager.data)
        # normalize_intensity to an integer dtype wraps where XLA saturates
        # (ROADMAP.md, queue C, kept on purpose): held to the port alone.
        if chunk_size == 7 and not (op == "normalize_intensity" and lazy.data.dtype == torch.uint8):
            j_lazy = getattr(_jax(data).as_lazy(chunk_size=chunk_size), op)
            if kwargs.get("window") == "gaussian":
                # JAX's LazyEBSD builds the window for its halo without the
                # window's parameters and raises; held to JAX's eager method.
                with pytest.raises(ValueError, match="must have parameters"):
                    j_lazy(**kwargs)
                want = getattr(_jax(data), op)(**kwargs)
            else:
                want = j_lazy(**kwargs).compute()
            _close_to_jax(lazy.data.numpy(), np.asarray(want.data))

    @pytest.mark.parametrize("chunk_size", [5, 7, 12, 16, 1024])
    def test_halo_chain(self, scan, data, chunk_size):
        # Rows per chunk 1, 1, 2, 3 and the whole map: halo rows on both sides.
        def chain(s):
            return (s.remove_static_background().remove_dynamic_background().average_neighbour_patterns()
                    .rescale_intensity())

        eager = chain(scan)
        lazy = chain(scan.as_lazy(chunk_size=chunk_size)).compute()
        assert torch.equal(lazy.data, eager.data)
        _close_to_jax(lazy.data.numpy(), np.asarray(chain(_jax(data).as_lazy(chunk_size=chunk_size)).compute().data))

    @pytest.mark.parametrize("chunk_size", [5, 10, 15])
    def test_two_halo_ops_and_a_wide_window(self, scan, chunk_size):
        w = np.ones((5, 3))
        eager = scan.average_neighbour_patterns(window=w).average_neighbour_patterns()
        lazy = scan.as_lazy(chunk_size=chunk_size).average_neighbour_patterns(window=w).average_neighbour_patterns()
        assert sum(h for _, _, h in lazy.ops) == 3
        assert torch.equal(lazy.compute().data, eager.data)

    @pytest.mark.parametrize("chunk_size", [5, 10, 15])
    def test_halo_of_a_tall_window_shape(self, scan, chunk_size):
        # The halo follows window_shape (JAX's LazyEBSD reads `shape` and
        # builds the window without its parameters).
        kw = dict(window="gaussian", window_shape=(5, 3), std=2.0)
        lazy = scan.as_lazy(chunk_size=chunk_size).average_neighbour_patterns(**kw)
        assert lazy.ops[-1][2] == 2
        assert torch.equal(lazy.compute().data, scan.average_neighbour_patterns(**kw).data)

    def test_ops_after_nav_op(self, scan):
        eager = scan.average_neighbour_patterns().downsample(2)
        lazy = scan.as_lazy(10).average_neighbour_patterns().downsample(2).compute()
        assert torch.equal(lazy.data, eager.data)

    def test_downsample_updates_probe_attributes(self, scan):
        lazy = scan.as_lazy(8).downsample(2)
        assert lazy.signal_shape == (6, 7) and lazy.dtype == np.uint8
        eager = lazy.compute()
        assert eager.detector.shape == (6, 7) and eager.detector.binning == 2
        assert eager.static_background.shape == (6, 7)

    def test_lazy_is_deferred(self, scan, data):
        calls = []
        src = ArraySource(data[0], scan.navigation_shape)
        orig = src.read
        src.read = lambda a, b: calls.append((a, b)) or orig(a, b)
        lazy = LazyEBSD(source=src, static_background=data[1], device="cpu").remove_static_background()
        assert calls == []
        lazy.compute()
        assert calls
        assert torch.equal(lazy.compute().data, scan.remove_static_background().data)

    def test_no_ops_and_repr(self, scan):
        out = scan.as_lazy().compute()
        assert torch.equal(out.data, scan.data)
        lazy = scan.as_lazy().rescale_intensity().normalize_intensity()
        assert "2 pending ops" in repr(lazy) and lazy.as_lazy() is lazy

    def test_compute_is_cached_and_data_computes(self, scan):
        lazy = scan.as_lazy(4).rescale_intensity()
        assert lazy.compute() is lazy.compute()
        assert torch.equal(lazy.data, scan.rescale_intensity().data)
        assert lazy.compute().xmap is scan.xmap and lazy.compute().metadata == scan.metadata

    def test_fallback_computes_once(self, scan):
        lazy = scan.as_lazy().rescale_intensity()
        iq = lazy.get_image_quality()
        np.testing.assert_array_equal(iq, scan.rescale_intensity().get_image_quality())
        assert lazy._computed is not None
        with pytest.raises(AttributeError):
            lazy.no_such_method
        with pytest.raises(AttributeError):
            lazy._private

    def test_errors(self, data):
        lazy = TEBSD(data=data[0], device="cpu").as_lazy()
        with pytest.raises(ValueError, match="static_bg"):
            lazy.remove_static_background()
        flat = TEBSD(data=data[0].reshape(30, 12, 14), device="cpu").as_lazy(7)
        with pytest.raises(ValueError, match="2D navigation"):
            flat.average_neighbour_patterns().compute()

    def test_the_lazy_view_defaults_to_the_card(self, data, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            LazyEBSD(source=ArraySource(data[0], (6, 5))).compute()


class TestSources:
    def test_numpy_and_cpu_tensor_sources(self, scan, data):
        for array in (data[0], torch.from_numpy(data[0].copy())):
            lazy = LazyEBSD(source=ArraySource(array, (6, 5)), static_background=data[1], chunk_size=4,
                            device="cpu")
            assert torch.equal(lazy.remove_static_background().compute().data,
                               scan.remove_static_background().data)

    def test_h5_source_reads_and_chunked_save(self, scan, tmp_path):
        path = tmp_path / "scan.h5"
        scan.save(path)
        src = H5Source(path, "Scan 1/EBSD/Data/patterns", nav_shape=(6, 5))
        flat = scan.data.numpy().reshape(-1, 12, 14)
        np.testing.assert_array_equal(src.read(3, 11), flat[3:11])
        np.testing.assert_array_equal(src.read(0, 30), flat)
        lazy = kt.load(path, lazy=True, device="cpu")
        assert isinstance(lazy, LazyEBSD) and lazy.navigation_shape == (6, 5)
        out = tmp_path / "processed.h5"
        lazy.remove_static_background().average_neighbour_patterns().save(out)
        want = scan.remove_static_background().average_neighbour_patterns()
        back = kt.load(out, device="cpu")
        assert torch.equal(back.data, want.data)
        # The JAX package reads the port's chunk-streamed file to the same bytes.
        np.testing.assert_array_equal(np.asarray(kp.load(out).data), want.data.numpy())

    def test_save_to_nordif_computes(self, scan, tmp_path):
        out = tmp_path / "Pattern.dat"
        scan.as_lazy(7).rescale_intensity().save(out)
        assert out.read_bytes() == scan.rescale_intensity().data.numpy().tobytes()

    def test_nordif_lazy_reads_a_memory_map(self, tmp_path):
        rng = np.random.default_rng(3)
        data = rng.integers(0, 255, size=(2, 3, 4, 5), dtype=np.uint8)
        raw = tmp_path / "Pattern.dat"
        data.tofile(raw)
        with pytest.warns(UserWarning, match="static background"):
            lazy = kt.load(raw, scan_size=(3, 2), pattern_size=(5, 4), lazy=True, device="cpu")
        assert isinstance(lazy, LazyEBSD) and isinstance(lazy.source._array.base, np.memmap)
        np.testing.assert_array_equal(lazy.compute().data.numpy(), data)
        with pytest.warns(UserWarning, match="static background"):
            jl = kp.load(raw, scan_size=(3, 2), pattern_size=(5, 4), lazy=True)
        np.testing.assert_array_equal(np.asarray(jl.compute().data), data)

    def test_edax_and_oxford_lazy_equal_their_eager_loads(self, tmp_path):
        rng = np.random.default_rng(4)
        sx, sy, n = 6, 4, 5
        pats = rng.integers(0, 255, size=(n, sy, sx), dtype=np.uint8)
        up1 = tmp_path / "scan.up1"
        with open(up1, "wb") as f:
            np.array([1, sx, sy, 16], dtype=np.uint32).tofile(f)
            pats.tofile(f)
        from tests.test_torch_io import _ebsp_v5, _write_dummy_ebsp

        ebsp = tmp_path / "v5.ebsp"
        _ebsp_v5(ebsp)
        ebsp2 = tmp_path / "v2.ebsp"
        _write_dummy_ebsp(ebsp2, version=2, dtype=np.uint16)
        for path in (up1, ebsp, ebsp2):
            lazy = kt.load(path, lazy=True, device="cpu")
            eager = kt.load(path, device="cpu")
            assert isinstance(lazy, LazyEBSD)
            small = dataclasses.replace(lazy, chunk_size=2)
            assert torch.equal(small.compute().data, eager.data), path
            np.testing.assert_array_equal(np.asarray(kp.load(path, lazy=True).compute().data), eager.data.numpy())


# ------------------------ streamed DI and refinement ------------------------ #


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def indexing_state():
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.crystallography.sampling import (
        reduce_to_fundamental_zone,
        sample_fundamental_zone,
        super_fibonacci,
    )

    master = _chip_smoke().master_pattern_data(side=61)
    mp = kt.EBSDMasterPattern(master, phase=Phase(name="ni", point_group="m-3m"), device="cpu")
    det = kt.EBSDDetector(shape=(16, 16), pc=(0.42, 0.28, 0.5), sample_tilt=70)
    rot = sample_fundamental_zone(12.0, "m-3m", device="cpu")
    dictionary = mp.get_patterns(rot, det, dtype_out=np.float32)
    truth = reduce_to_fundamental_zone(super_fibonacci(20 * 7)[::7][:20], "m-3m", device="cpu")
    sim = mp.get_patterns(truth, det, dtype_out=np.float32).data.numpy()
    noisy = sim + np.random.default_rng(9).normal(scale=0.05 * sim.std(), size=sim.shape)
    scan = kt.EBSD(noisy.astype(np.float32).reshape(4, 5, 16, 16), detector=det, device="cpu")
    return mp, det, dictionary, scan, rot


@pytest.mark.parametrize("kw", [
    {},
    {"precision": "int8"},
    {"precision": "f16"},
    {"precision": "mixed", "approx_topk": True},
    {"keep_n": 1},
    {"n_per_iteration": 50},
])
@pytest.mark.parametrize("chunk_size", [3, 8, 1024])
def test_streamed_dictionary_indexing_matches_eager(indexing_state, kw, chunk_size):
    _, _, dictionary, scan, _ = indexing_state
    kw = {"keep_n": 5, **kw}
    eager = scan.dictionary_indexing(dictionary, **kw)
    lazy = scan.as_lazy(chunk_size=chunk_size).dictionary_indexing(dictionary, **kw)
    np.testing.assert_array_equal(lazy.prop["simulation_indices"], eager.prop["simulation_indices"])
    np.testing.assert_allclose(lazy.prop["scores"], eager.prop["scores"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(lazy.rotations, eager.rotations, rtol=0, atol=0)
    assert lazy.shape == eager.shape == (4, 5)


def test_streamed_dictionary_indexing_with_a_mask_and_a_chain(indexing_state):
    _, _, dictionary, scan, _ = indexing_state
    mask = np.zeros((16, 16), bool)
    mask[:3] = True
    nav = np.zeros((4, 5), bool)
    nav[1, 2] = True
    kw = dict(keep_n=3, signal_mask=mask)
    chained = scan.rescale_intensity()
    eager = chained.dictionary_indexing(dictionary, **kw)
    lazy = scan.as_lazy(6).rescale_intensity().dictionary_indexing(dictionary, **kw)
    np.testing.assert_array_equal(lazy.prop["simulation_indices"], eager.prop["simulation_indices"])
    masked = scan.as_lazy(6).dictionary_indexing(dictionary, navigation_mask=nav, **kw)
    np.testing.assert_array_equal(masked.prop["simulation_indices"],
                                  scan.dictionary_indexing(dictionary, navigation_mask=nav, **kw)
                                  .prop["simulation_indices"])


@pytest.mark.parametrize("precision", ["pallas-int8", "bogus"])
def test_streamed_dictionary_indexing_raises_where_jax_has_no_tier(indexing_state, precision):
    _, _, dictionary, scan, _ = indexing_state
    with pytest.raises(ValueError, match="streamed dictionary indexing"):
        scan.as_lazy(8).dictionary_indexing(dictionary, precision=precision)
    # JAX's streamed path has no such tier either: it raises (a KeyError).
    from kikuchipy_tpu.crystallography.crystal_map import CrystalMap as JXMap

    jdict = JEBSD(data=dictionary.data.numpy(), xmap=JXMap(rotations=dictionary.xmap.rotations))
    with pytest.raises(KeyError):
        JEBSD(data=scan.data.numpy()).as_lazy(8).dictionary_indexing(jdict, precision=precision)


def test_streamed_dictionary_indexing_matches_jax(indexing_state):
    from kikuchipy_tpu.crystallography.crystal_map import CrystalMap as JXMap

    _, _, dictionary, scan, _ = indexing_state
    jdict = JEBSD(data=dictionary.data.numpy(), xmap=JXMap(rotations=dictionary.xmap.rotations))
    want = JEBSD(data=scan.data.numpy().astype(np.float32)).as_lazy(7).dictionary_indexing(jdict, keep_n=3)
    got = scan.as_lazy(7).dictionary_indexing(dictionary, keep_n=3)
    clear = (want.prop["scores"][:, 0] - want.prop["scores"][:, 1]) > 1e-5
    np.testing.assert_array_equal(got.prop["simulation_indices"][clear, 0], want.prop["simulation_indices"][clear, 0])
    np.testing.assert_allclose(got.prop["scores"], want.prop["scores"], rtol=0, atol=2e-6)


@pytest.mark.parametrize("chunk_size", [3, 8, 1024])
def test_streamed_refinement_matches_eager(indexing_state, chunk_size):
    mp, det, dictionary, scan, _ = indexing_state
    xmap = scan.dictionary_indexing(dictionary, keep_n=1)
    s = dataclasses.replace(scan, xmap=xmap)
    kw = dict(master_pattern=mp, max_iters=20)
    eager = s.refine_orientation(**kw)
    lazy = s.as_lazy(chunk_size=chunk_size).refine_orientation(**kw)
    np.testing.assert_allclose(lazy.xmap.best_rotations, eager.xmap.best_rotations, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lazy.xmap.prop["scores"], eager.xmap.prop["scores"], rtol=0, atol=1e-6)
    assert lazy.xmap.shape == eager.xmap.shape and lazy.detector is det


def test_streamed_refinement_with_a_pc_a_point(indexing_state):
    mp, det, dictionary, scan, _ = indexing_state
    xmap = scan.dictionary_indexing(dictionary, keep_n=1)
    pcs = np.tile(np.asarray(det.pc_average), (4, 5, 1)) + np.random.default_rng(2).normal(scale=1e-3, size=(4, 5, 3))
    s = dataclasses.replace(scan, xmap=xmap, detector=dataclasses.replace(det, pc=pcs))
    eager = s.refine_orientation(master_pattern=mp, max_iters=10)
    lazy = s.as_lazy(chunk_size=6).refine_orientation(master_pattern=mp, max_iters=10)
    np.testing.assert_allclose(lazy.xmap.best_rotations, eager.xmap.best_rotations, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="xmap"):
        scan.as_lazy().refine_orientation(master_pattern=mp)


def test_interop_carries_a_jax_crystal_map_into_a_lazy_refinement(indexing_state):
    mp, _, dictionary, scan, _ = indexing_state
    xmap = scan.dictionary_indexing(dictionary, keep_n=1)
    carried = interop.crystal_map_from_state(xmap.rotations, shape=xmap.shape)
    lazy = dataclasses.replace(scan.as_lazy(5), xmap=carried)
    res = lazy.refine_orientation(master_pattern=mp, max_iters=5)
    assert res.xmap.size == 20 and np.isfinite(res.xmap.prop["scores"]).all()


def test_streamed_refinement_matches_jax_lazy(indexing_state):
    # JAX's LazyEBSD on the same scan, crystal map and master pattern, run to
    # the default iterations: the refinement tests' tolerance (float32
    # objectives summed in another order can turn a simplex step; at 20
    # iterations one point stopped 0.06 degrees apart): 0.05 degrees, scores
    # within 1e-4.
    from kikuchipy_tpu.crystallography.crystal_map import CrystalMap as JXMap
    from kikuchipy_tpu.crystallography.sampling import disorientation_angle
    from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
    from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP

    mp, det, dictionary, scan, _ = indexing_state
    xmap = scan.dictionary_indexing(dictionary, keep_n=1)
    jdet = JDetector(shape=det.shape, pc=det.pc, sample_tilt=det.sample_tilt)
    jlazy = dataclasses.replace(JEBSD(data=scan.data.numpy(), detector=jdet).as_lazy(chunk_size=6),
                                xmap=JXMap(rotations=xmap.rotations, shape=xmap.shape))
    want = jlazy.refine_orientation(master_pattern=JMP(data=mp.data))
    got = dataclasses.replace(scan, xmap=xmap).as_lazy(chunk_size=6).refine_orientation(master_pattern=mp)
    ang = np.degrees(disorientation_angle(np.asarray(got.xmap.best_rotations),
                                          np.asarray(want.xmap.best_rotations), "m-3m"))
    assert ang.max() < 0.05
    np.testing.assert_allclose(got.xmap.prop["scores"], np.asarray(want.xmap.prop["scores"]), rtol=0, atol=1e-4)
