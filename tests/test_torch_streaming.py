"""Out-of-core streaming (``kikuchipy_tpu_torch/io/streaming.py``) against
the port's in-memory calls and the JAX package's ``io/streaming.py`` on the
CPU: the chunks, ``map_streamed`` (collecting, preallocated, to an HDF5
file with and without the input's metadata), streamed DI (indices equal,
scores within 1e-5), checkpoints written by either package resumed by the
other, and preprocessing on the device against preprocessing on the
host."""

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from kikuchipy_tpu.indexing.di import prepare_dictionary as j_prepare  # noqa: E402
from kikuchipy_tpu.io import streaming as js  # noqa: E402
from kikuchipy_tpu_torch.indexing.di import dictionary_index, prepare_dictionary  # noqa: E402
from kikuchipy_tpu_torch.io import streaming as ts  # noqa: E402
from kikuchipy_tpu_torch.io.streaming import dictionary_index_streamed, map_streamed, stream_patterns  # noqa: E402

CPU = dict(device="cpu")
DATASET = "Scan 1/EBSD/Data/patterns"


@pytest.fixture
def big_scan(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 255, size=(100, 16, 16), dtype=np.uint8)
    f = tmp_path / "scan.h5"
    with h5py.File(f, "w") as h:
        h.create_dataset(DATASET, data=data)
    return f, data


def _dictionary(seed, m=64):
    return np.random.default_rng(seed).normal(size=(m, 16, 16)).astype(np.float32)


def _same(a, b, atol=1e-5):
    np.testing.assert_array_equal(a.simulation_indices, b.simulation_indices)
    np.testing.assert_allclose(a.scores, b.scores, atol=atol)


def test_public_names_are_jax():
    assert ts.__all__ == js.__all__


def test_chunks_cover_scan(big_scan):
    f, data = big_scan
    chunks = list(stream_patterns(f, chunk_size=17))
    assert [s for s, _ in chunks] == list(range(0, 100, 17))
    np.testing.assert_array_equal(np.concatenate([c for _, c in chunks]), data)
    for (s_t, c_t), (s_j, c_j) in zip(chunks, js.stream_patterns(f, chunk_size=17)):
        assert s_t == s_j
        np.testing.assert_array_equal(c_t, c_j)


@pytest.mark.parametrize("returns", ["numpy", "tensor"])
def test_map_streamed_collects(big_scan, returns):
    f, data = big_scan
    fn = (lambda c: c.astype(np.float32) * 2) if returns == "numpy" else (
        lambda c: torch.from_numpy(c).to(torch.float32) * 2)
    out = map_streamed(f, fn, chunk_size=32)
    np.testing.assert_allclose(out, data.astype(np.float32) * 2)


def test_map_streamed_preallocated(big_scan):
    f, data = big_scan
    out = np.zeros((100, 16, 16), np.float32)
    assert map_streamed(f, lambda c: c.astype(np.float32), out=out, chunk_size=30) is out
    np.testing.assert_allclose(out, data)


@pytest.mark.parametrize("copy_metadata", [True, False])
def test_map_streamed_to_file(big_scan, tmp_path, copy_metadata):
    f, data = big_scan
    with h5py.File(f, "a") as h:
        h["Scan 1/EBSD/Header/pattern_height"] = 16
        h["Scan 1"].attrs["note"] = "kept"
    out_path = tmp_path / "out.h5"
    assert map_streamed(f, lambda c: c.astype(np.float32) + 1, out_path=out_path, chunk_size=40,
                        copy_metadata=copy_metadata) is None
    with h5py.File(out_path) as h:
        np.testing.assert_allclose(h[DATASET][()], data.astype(np.float32) + 1)
        assert ("Scan 1/EBSD/Header/pattern_height" in h) == copy_metadata
        assert (h["Scan 1"].attrs.get("note") == "kept") == copy_metadata


def test_map_streamed_h5ebsd_round_trip_loads_in_both_packages(tmp_path):
    # A kikuchipy h5ebsd scan streamed through the port's static-background
    # removal is a loadable scan with its header, PCs and crystal map.
    import kikuchipy_tpu as kp
    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.ops.pattern import remove_static_background

    rng = np.random.default_rng(7)
    nav, sig = (3, 4), (12, 10)
    q = rng.normal(size=(12, 4))
    det = kt.EBSDDetector(shape=sig, pc=rng.uniform(0.4, 0.6, nav + (3,)), sample_tilt=70)
    src = tmp_path / "scan.h5"
    kt.EBSD(rng.integers(0, 256, nav + sig, dtype=np.uint8), detector=det,
            static_background=rng.integers(1, 256, sig, dtype=np.uint8),
            xmap=CrystalMap(rotations=q / np.linalg.norm(q, axis=1, keepdims=True), shape=nav), **CPU).save(src)
    raw = kt.load(src, **CPU)
    bg = raw.static_background
    out_path = tmp_path / "preprocessed.h5"
    map_streamed(src, lambda c: remove_static_background(c, bg, **CPU), out_path=out_path, chunk_size=5)

    s2 = kt.load(out_path, **CPU)
    assert tuple(s2.data.shape) == tuple(raw.data.shape)
    np.testing.assert_allclose(np.asarray(s2.detector.pc), np.asarray(raw.detector.pc))
    np.testing.assert_allclose(s2.xmap.best_rotations, raw.xmap.best_rotations)
    np.testing.assert_array_equal(s2.data.numpy(), raw.remove_static_background().data.numpy())
    np.testing.assert_array_equal(np.asarray(kp.load(out_path).data), s2.data.numpy())


def test_streamed_di_matches_in_memory_and_jax(big_scan):
    f, data = big_scan
    dictionary = _dictionary(1)
    streamed = dictionary_index_streamed(f, dictionary, chunk_size=23, keep_n=5, **CPU)
    _same(streamed, dictionary_index(data.astype(np.float32), dictionary=dictionary, keep_n=5, **CPU))
    _same(streamed, js.dictionary_index_streamed(f, dictionary, chunk_size=23, keep_n=5))
    assert streamed.patterns_per_second > 0


@pytest.mark.parametrize("precision, approx", [("int8", False), ("mixed", False), ("f16", True)])
def test_streamed_di_tiers_match_jax(big_scan, precision, approx):
    # A PreparedDictionary on both sides: int8 reuses its quantization.
    f, _ = big_scan
    dictionary = _dictionary(5, m=96)
    kw = dict(chunk_size=40, keep_n=4, precision=precision, approx_topk=approx)
    got = dictionary_index_streamed(f, prepare_dictionary(dictionary, quantize=precision == "int8", **CPU), **kw, **CPU)
    want = js.dictionary_index_streamed(f, j_prepare(dictionary, quantize=precision == "int8"), **kw)
    _same(got, want, atol=1e-5 if precision != "f16" else 5e-4)


def test_streamed_di_signal_mask_matches_jax(big_scan):
    f, _ = big_scan
    dictionary = _dictionary(6)
    mask = np.zeros((16, 16), bool)
    mask[:4] = True
    got = dictionary_index_streamed(f, dictionary, chunk_size=30, keep_n=3, signal_mask=mask, **CPU)
    _same(got, js.dictionary_index_streamed(f, dictionary, chunk_size=30, keep_n=3, signal_mask=mask))


@pytest.mark.parametrize("kw, error", [(dict(precision="pallas-int8"), ValueError), (dict(precision="fast"), ValueError),
                                       (dict(tile=4), TypeError)])
def test_streamed_di_refuses_what_jax_cannot_run(big_scan, kw, error):
    f, _ = big_scan
    with pytest.raises(error):
        dictionary_index_streamed(f, _dictionary(1), **kw, **CPU)


def _crash_after(n):
    calls = {"n": 0}

    def preprocess(c):
        calls["n"] += 1
        if calls["n"] > n:
            raise RuntimeError("simulated crash")
        return c

    return preprocess


def _counting(seen):
    def preprocess(c):
        seen.append(c.shape[0])
        return c

    return preprocess


@pytest.mark.parametrize("writer, reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_resume_from_checkpoint(big_scan, tmp_path, writer, reader):
    f, data = big_scan
    dictionary = _dictionary(2, m=32)
    ckpt = tmp_path / "di.npz"
    run = {"port": lambda **kw: dictionary_index_streamed(f, dictionary, chunk_size=30, keep_n=3,
                                                          checkpoint_path=ckpt, **CPU, **kw),
           "jax": lambda **kw: js.dictionary_index_streamed(f, dictionary, chunk_size=30, keep_n=3,
                                                            checkpoint_path=ckpt, **kw)}

    with pytest.raises(RuntimeError, match="simulated crash"):
        run[writer](preprocess_fn=_crash_after(2))
    assert ckpt.exists()
    with np.load(ckpt) as z:
        assert sorted(z.files) == ["idx_0", "scores_0"]

    # Results are read one chunk late, so of the two chunks done before the
    # crash the first was checkpointed and is not processed again.
    seen = []
    res = run[reader](preprocess_fn=_counting(seen))
    assert seen == [30, 30, 10]
    _same(res, dictionary_index(data.astype(np.float32), dictionary=dictionary, keep_n=3, **CPU))
    with np.load(ckpt) as z:
        assert sorted(z.files) == sorted(f"{k}_{s}" for k in ("idx", "scores") for s in (0, 30, 60, 90))


def test_device_preprocess_matches_host(big_scan):
    f, _ = big_scan
    dictionary = _dictionary(4, m=32)
    host = dictionary_index_streamed(f, dictionary, preprocess_fn=lambda c: c.astype(np.float32) / 255,
                                     chunk_size=40, keep_n=3, **CPU)
    seen = []

    def on_device(c):
        seen.append((type(c), c.dtype, c.device.type))
        return c.to(torch.float32) / 255

    dev = dictionary_index_streamed(f, dictionary, preprocess_fn=on_device, preprocess_on_device=True,
                                    chunk_size=40, keep_n=3, **CPU)
    assert seen == [(torch.Tensor, torch.uint8, "cpu")] * 3
    _same(host, dev, atol=1e-6)


def test_index_chunks_takes_any_iterator_of_chunks(big_scan):
    # The on-device loop alone, fed from a memory of the scan's rows.
    f, data = big_scan
    dictionary = _dictionary(3)
    chunks = ((s, data[s:s + 25]) for s in range(0, 100, 25))
    got = ts._index_chunks(chunks, dictionary, chunk_size=25, keep_n=4, **CPU)
    _same(got, dictionary_index_streamed(f, dictionary, chunk_size=25, keep_n=4, **CPU), atol=0)


def test_pipelined_forwards_the_producers_error():
    def items():
        yield 1
        raise KeyError("producer")

    got = []
    with pytest.raises(KeyError, match="producer"):
        for x in ts._pipelined(items()):
            got.append(x)
    assert got == [1]
