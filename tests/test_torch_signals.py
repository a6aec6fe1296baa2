"""The port's signal surface against the JAX package's on the CPU: the rest
of ``EBSD`` (HyperSpy-order ``inav``/``isig`` with per-point PCs and the
crystal map, NumPy's reducers and their dtypes, ``change_dtype``, the
calibrations, ``extract_grid``, ``crop``, ``deepcopy``, ``as_lazy``), the
master patterns (``KikuchiMasterPattern``'s intensity operations,
``set_signal_type`` and float64 ``as_lambert``; ``ECPMasterPattern``),
``VirtualBSEImage``, the IPF color key, the signal utilities, the logging
control and the exports. Inputs come from seeded NumPy; both packages start
from the same arrays."""

import dataclasses
import inspect
import logging
import sys

import numpy as np
import pytest

import kikuchipy_tpu as kp
import kikuchipy_tpu_torch as kt
from kikuchipy_tpu.crystallography import ipf as j_ipf
from kikuchipy_tpu.crystallography.crystal_map import CrystalMap as JCrystalMap
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu.signals import master_pattern as j_mp
from kikuchipy_tpu.signals import util as j_util
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu.signals.virtual_bse_image import VirtualBSEImage as JVBSE
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.crystallography import ipf as t_ipf
from kikuchipy_tpu_torch.signals import master_pattern as t_mp
from kikuchipy_tpu_torch.signals import util as t_util
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD

NY, NX, SY, SX = 4, 5, 6, 7


def _rotations(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q * np.sign(q[:, :1])


def _pair(dtype=np.uint8, per_point_pc=True, with_xmap=True, seed=0):
    """The same scan in both packages: patterns, static background, a PC a
    point and a crystal map with a property."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        data = rng.normal(size=(NY, NX, SY, SX)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        data = rng.integers(max(info.min, -300), min(info.max, 3000), (NY, NX, SY, SX)).astype(dtype)
    bg = rng.integers(0, 200, (SY, SX)).astype(np.uint8)
    pc = rng.uniform(0.4, 0.6, (NY, NX, 3)) if per_point_pc else np.array([0.45, 0.55, 0.6])
    rot = _rotations(NY * NX, seed + 1)
    scores = rng.random(NY * NX)
    j = JEBSD(data=data, static_background=bg, detector=JDetector(shape=(SY, SX), pc=pc),
              xmap=JCrystalMap(rotations=rot, shape=(NY, NX), prop={"scores": scores}) if with_xmap else None)
    t = TEBSD(data=data, static_background=bg, detector=kt.EBSDDetector(shape=(SY, SX), pc=pc),
              xmap=interop.crystal_map_from_state(rot, shape=(NY, NX), prop={"scores": scores}) if with_xmap
              else None, device="cpu")
    return j, t


def _assert_same_signal(j, t, exact=True):
    jd, td = np.asarray(j.data), t.data.numpy()
    assert td.dtype == jd.dtype and td.shape == jd.shape
    if exact:
        np.testing.assert_array_equal(td, jd)
    assert t.navigation_shape == tuple(j.navigation_shape) and t.signal_shape == tuple(j.signal_shape)
    np.testing.assert_array_equal(t.detector.pc, j.detector.pc)
    assert t.detector.shape == j.detector.shape
    if j.static_background is None:
        assert t.static_background is None
    else:
        np.testing.assert_array_equal(np.asarray(t.static_background), np.asarray(j.static_background))
    if j.xmap is None:
        assert t.xmap is None
    else:
        assert t.xmap.shape == j.xmap.shape
        np.testing.assert_allclose(t.xmap.rotations, j.xmap.rotations, rtol=0, atol=1e-12)
        for key, value in j.xmap.prop.items():
            np.testing.assert_array_equal(t.xmap.prop[key], value)


# ------------------------------ inav / isig ------------------------------ #

NAV_KEYS = [
    (1, 2),
    (slice(None), 0),
    (slice(None), slice(None, None, -1)),
    (slice(None, None, -1),),
    (slice(None, None, -2), slice(3, 0, -1)),
    (slice(1, None), slice(None, 2)),
    ([0, 4, 2],),
    (-1,),
    (slice(-3, -1), -2),
]


@pytest.mark.parametrize("key", NAV_KEYS, ids=str)
def test_inav_matches_jax(key):
    j, t = _pair()
    _assert_same_signal(j.inav[key], t.inav[key])


@pytest.mark.parametrize("key", NAV_KEYS[:4], ids=str)
def test_inav_of_a_1d_scan_and_a_shared_pc_match_jax(key):
    j, t = _pair(per_point_pc=False)
    _assert_same_signal(j.inav[key], t.inav[key])
    flat_j = JEBSD(data=np.asarray(j.data).reshape(NY * NX, SY, SX))
    flat_t = TEBSD(data=t.data.reshape(NY * NX, SY, SX), device="cpu")
    k = key[0]
    _assert_same_signal(flat_j.inav[k], flat_t.inav[k])


def test_inav_too_many_keys_raises():
    _, t = _pair()
    with pytest.raises(IndexError, match="Too many navigation indices"):
        t.inav[0, 0, 0]


SIG_KEYS = [
    (slice(None), slice(None, -1)),
    (slice(1, None),),
    (slice(None, None, -1), slice(None, None, -1)),
    (slice(6, 1, -2), slice(1, 5)),
    ([0, 3, 6], slice(None)),
]


@pytest.mark.parametrize("key", SIG_KEYS, ids=str)
def test_isig_matches_jax(key):
    j, t = _pair()
    _assert_same_signal(j.isig[key], t.isig[key])


# ------------------------------- reducers ------------------------------- #


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32, np.float64])
@pytest.mark.parametrize("name", ["mean", "max", "min", "sum", "std"])
@pytest.mark.parametrize("axis", [None, (0, 1), 2, (-1, -2), (0, 2, 3)])
def test_reducers_match_numpy_dtypes_and_values(dtype, name, axis):
    j, t = _pair(dtype=dtype)
    want = np.asarray(getattr(j, name)(axis=axis).data)
    got = getattr(t, name)(axis=axis).data.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
    else:
        rtol = 1e-12 if got.dtype == np.float64 else 2e-6
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0 if got.dtype == np.float64 else 1e-6)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
@pytest.mark.parametrize("name", ["mean", "max", "min", "sum", "std"])
def test_reducers_of_one_pattern_reduce_no_axis_as_numpy(dtype, name):
    # inav[x, y] leaves no navigation axis: the default reduces over none.
    j, t = _pair(dtype=dtype)
    want = np.asarray(getattr(j.inav[1, 2], name)().data)
    got = getattr(t.inav[1, 2], name)().data.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_std_is_numpy_ddof_0_and_sum_of_uint8_is_uint64():
    j, t = _pair()
    got = t.std().data.numpy()
    np.testing.assert_allclose(got, np.asarray(j.data).std(axis=(0, 1)), rtol=1e-12)
    assert not np.allclose(got, np.asarray(j.data).std(axis=(0, 1), ddof=1))
    assert t.sum().data.numpy().dtype == np.uint64 and t.mean().data.numpy().dtype == np.float64


# ----------------------- the other EBSD methods ------------------------ #


@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.int8, np.float64])
def test_change_dtype_matches_jax(dtype):
    j, t = _pair()
    out_j, out_t = j.change_dtype(dtype), t.change_dtype(dtype)
    np.testing.assert_array_equal(out_t.data.numpy(), np.asarray(out_j.data))
    assert t.data.numpy().dtype == np.uint8  # the original is unchanged


def test_calibrations_match_jax():
    j, t = _pair()
    for s in (j, t):
        s.set_scan_calibration(step_x=1.5, step_y=2.0)
        s.set_detector_calibration(70.0)
    assert t.metadata == j.metadata
    assert t.detector.px_size == j.detector.px_size == 70.0


@pytest.mark.parametrize("grid", [(2, 3), (3, 2), (5, 4), (1, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("per_point_pc", [True, False])
def test_extract_grid_matches_jax(grid, per_point_pc):
    j, t = _pair(per_point_pc=per_point_pc)
    try:
        out_j, idx_j = j.extract_grid(grid, return_indices=True)
    except IndexError:  # a grid whose centred indices leave the map
        with pytest.raises(IndexError):
            t.extract_grid(grid, return_indices=True)
        return
    out_t, idx_t = t.extract_grid(grid, return_indices=True)
    np.testing.assert_array_equal(idx_t, idx_j)
    assert out_t.xmap.size == out_j.xmap.size
    out_j = dataclasses.replace(out_j, xmap=None)
    out_t = dataclasses.replace(out_t, xmap=None)
    _assert_same_signal(out_j, out_t)


def test_extract_grid_of_a_1d_scan_matches_jax():
    data = np.random.default_rng(3).integers(0, 255, (9, SY, SX), dtype=np.uint8)
    j, t = JEBSD(data=data), TEBSD(data=data, device="cpu")
    np.testing.assert_array_equal(t.extract_grid(3).data.numpy(), np.asarray(j.extract_grid(3).data))


@pytest.mark.parametrize("extent", [(0, 3, 1, 5), (1, 6, 0, 7), (2, 4, 2, 3)])
def test_crop_matches_jax(extent):
    j, t = _pair()
    _assert_same_signal(j.crop(extent), t.crop(extent))


def test_deepcopy_is_independent():
    j, t = _pair()
    c = t.deepcopy()
    _assert_same_signal(j, c)
    c.data[0, 0, 0, 0] += 1
    c.detector.pc[0, 0, 0] = 9.0
    c.xmap.rotations[0] = 0.0
    c.static_background[0, 0] += 1
    c.metadata["x"] = 1
    _assert_same_signal(j, t)
    assert "x" not in t.metadata


def test_eager_as_lazy_and_compute():
    _, t = _pair()
    assert t.compute() is t
    lazy = t.as_lazy(chunk_size=7)
    assert isinstance(lazy, kt.LazyEBSD) and lazy.chunk_size == 7 and lazy.device == t.device
    np.testing.assert_array_equal(lazy.compute().data.numpy(), t.data.numpy())


# --------------------------- master patterns --------------------------- #


def _master(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.random(shape).astype(dtype)
    return rng.integers(0, 255, shape).astype(dtype)


MP_OPS = [
    ("rescale_intensity", {}),
    ("rescale_intensity", {"dtype_out": np.float32}),
    ("normalize_intensity", {"dtype_out": np.float32}),
    ("adaptive_histogram_equalization", {}),
    ("adaptive_histogram_equalization", {"kernel_size": (8, 8), "clip_limit": 0.02}),
]


@pytest.mark.parametrize("op,kwargs", MP_OPS, ids=str)
@pytest.mark.parametrize("cls", ["EBSDMasterPattern", "ECPMasterPattern", "KikuchiMasterPattern"])
def test_master_pattern_operations_match_jax(op, kwargs, cls):
    data = _master(np.uint8, (2, 33, 33))
    j = getattr(j_mp, cls)(data=data, hemisphere="both")
    t = getattr(t_mp, cls)(data=data, hemisphere="both", device="cpu")
    want = np.asarray(getattr(j, op)(**kwargs).data)
    got = getattr(t, op)(**kwargs).data
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert (got != want).mean() <= 0.01
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_master_pattern_change_dtype_deepcopy_and_lazy():
    data = _master(np.uint8, (2, 9, 9))
    t = t_mp.EBSDMasterPattern(data=data, device="cpu")
    j = j_mp.EBSDMasterPattern(data=data)
    np.testing.assert_array_equal(t.change_dtype(np.float32).data, np.asarray(j.change_dtype(np.float32).data))
    c = t.deepcopy()
    c.data[0, 0, 0] += 1
    assert t.data[0, 0, 0] == data[0, 0, 0]
    assert t.as_lazy() is t and t.compute() is t


@pytest.mark.parametrize("target", ["EBSDMasterPattern", "ECPMasterPattern", "EBSD", "ebsd master pattern"])
def test_set_signal_type_matches_jax(target):
    data = _master(np.float32, (2, 9, 9))
    j = j_mp.ECPMasterPattern(data=data, hemisphere="both", energies=np.array([20.0]))
    t = t_mp.ECPMasterPattern(data=data, hemisphere="both", energies=np.array([20.0]), device="cpu")
    out_j, out_t = j.set_signal_type(target), t.set_signal_type(target)
    assert type(out_t).__name__ == type(out_j).__name__
    got = out_t.data.numpy() if target == "EBSD" else out_t.data
    np.testing.assert_array_equal(got, np.asarray(out_j.data))
    if target != "EBSD":
        assert out_t.hemisphere == "both" and out_t.device == t.device
        np.testing.assert_array_equal(out_t.energies, [20.0])
    with pytest.raises(ValueError, match="Unknown signal type"):
        t.set_signal_type("TKDMasterPattern")


@pytest.mark.parametrize(
    "dtype,shape,hemisphere",
    [
        (np.uint8, (41, 41), "upper"),
        (np.uint8, (41, 41), "lower"),
        (np.float32, (2, 41, 41), "both"),
        (np.float64, (2, 31, 37), "both"),
        (np.uint16, (3, 25, 25), "upper"),  # an energy axis
        (np.float32, (3, 2, 25, 25), "both"),
    ],
)
def test_as_lambert_matches_jax_within_1e_12(dtype, shape, hemisphere):
    data = _master(dtype, shape, seed=4)
    j = j_mp.EBSDMasterPattern(data=data, hemisphere=hemisphere, projection="stereographic")
    t = t_mp.EBSDMasterPattern(data=data, hemisphere=hemisphere, projection="stereographic", device="cpu")
    want, got = j.as_lambert(), t.as_lambert()
    assert got.projection == "lambert" and got.data.dtype == np.asarray(want.data).dtype
    assert got.data.dtype == (np.dtype(dtype) if np.dtype(dtype).kind == "f" else np.float32)
    np.testing.assert_allclose(got.data, np.asarray(want.data), rtol=0, atol=1e-12 * max(1.0, float(data.max())))
    assert t.as_lambert().projection == "lambert" and got.as_lambert() is got


def test_as_lambert_in_float64_before_the_cast():
    # The float64 grid is JAX's to 1e-12 before the output dtype is applied.
    data = _master(np.float64, (2, 21, 21), seed=5)
    j = j_mp.EBSDMasterPattern(data=data, projection="stereographic")
    t = t_mp.EBSDMasterPattern(data=data, projection="stereographic", device="cpu")
    np.testing.assert_allclose(t.as_lambert().data, np.asarray(j.as_lambert().data), rtol=0, atol=1e-12)


def test_spherical_projector_after_as_lambert():
    t = t_mp.EBSDMasterPattern(data=_master(np.float32, (2, 21, 21)), projection="stereographic", device="cpu")
    with pytest.raises(ValueError, match="as_lambert"):
        t.spherical_projector(L=2)
    assert t.as_lambert().spherical_projector(L=2).L == 2


# ---------------------------- virtual BSE ---------------------------- #


@pytest.mark.parametrize("op,kwargs", [
    ("rescale_intensity", {}),
    ("rescale_intensity", {"dtype_out": np.float32}),
    ("normalize_intensity", {"dtype_out": np.float32}),
    ("adaptive_histogram_equalization", {"kernel_size": (16, 16)}),
], ids=str)
def test_virtual_bse_image_matches_jax(op, kwargs):
    data = _master(np.uint8, (32, 40), seed=6)
    j = JVBSE(data=data, metadata={"roi": (0, 1, 0, 1)})
    t = interop.virtual_bse_image_from_state(data, metadata={"roi": (0, 1, 0, 1)}, device="cpu")
    want, got = getattr(j, op)(**kwargs), getattr(t, op)(**kwargs)
    assert got.shape == want.shape and got.data.dtype == np.asarray(want.data).dtype and got.metadata == want.metadata
    if got.data.dtype == np.uint8:
        assert np.abs(got.data.astype(int) - np.asarray(want.data).astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got.data, np.asarray(want.data), rtol=1e-5, atol=1e-5)


def test_virtual_bse_image_dtype_copy_lazy():
    data = _master(np.uint8, (8, 8))
    t = kt.VirtualBSEImage(data=data, device="cpu")
    assert t.change_dtype(np.float32).data.dtype == np.float32 and t.data.dtype == np.uint8
    c = t.deepcopy()
    c.data[0, 0] += 1
    assert t.data[0, 0] == data[0, 0]
    assert t.as_lazy() is t and t.compute() is t


def test_interop_master_patterns_from_state():
    data = _master(np.float32, (2, 9, 9))
    assert type(interop.ecp_master_pattern_from_state(data, device="cpu")) is t_mp.ECPMasterPattern
    k = interop.kikuchi_master_pattern_from_state(data, projection="stereographic", phase_name="ni", device="cpu")
    assert type(k) is t_mp.KikuchiMasterPattern and k.phase.name == "ni" and k.projection == "stereographic"
    np.testing.assert_array_equal(k.data, data)


# ------------------------------ IPF colors ------------------------------ #


@pytest.mark.parametrize("pg", ["m-3m", "432", "6/mmm", "4/mmm", "-3m", "mmm", "2/m", "-1", "4/m", "6/m", "-3"])
@pytest.mark.parametrize("direction", [(0, 0, 1), (1, 0, 0), (1, 1, 1)])
def test_ipf_color_matches_jax(pg, direction):
    rot = _rotations(50, 7).reshape(5, 10, 4)
    np.testing.assert_allclose(t_ipf.ipf_color(rot, pg, direction), j_ipf.ipf_color(rot, pg, direction),
                               rtol=0, atol=1e-12)
    key_t, key_j = t_ipf.IPFColorKeyTSL(pg, direction), j_ipf.IPFColorKeyTSL(pg, direction)
    xmap = interop.crystal_map_from_state(rot.reshape(-1, 4))
    np.testing.assert_allclose(key_t.orientation2color(xmap), key_j.orientation2color(rot.reshape(-1, 4)),
                               rtol=0, atol=1e-12)
    assert repr(key_t) == repr(key_j)


# ---------------------- utilities, logging, exports ---------------------- #


@pytest.mark.parametrize("grid,nav", [((4, 5), (55, 75)), (3, 10), ((1, 1), (3, 3)), ((2, 7), (5, 7))])
def test_grid_indices_match_jax(grid, nav):
    for spacing in (False, True):
        got = t_util.grid_indices(grid, nav, return_spacing=spacing)
        want = j_util.grid_indices(grid, nav, return_spacing=spacing)
        for g, w in zip(got if spacing else (got,), want if spacing else (want,)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="compatible"):
        t_util.grid_indices((9, 9), (3, 3))


@pytest.mark.parametrize("kw", [
    {},
    {"chunk_shape": 2},
    {"chunk_bytes": "2 KiB"},
    {"chunk_bytes": 500},
    {"chunk_bytes": "1MB"},
])
def test_get_chunking_matches_jax(kw):
    data = np.zeros((40, 30, 6, 7), np.uint16)
    assert t_util.get_chunking(TEBSD(data=data, device="cpu"), **kw) == j_util.get_chunking(JEBSD(data=data), **kw)
    args = dict(data_shape=(40, 30, 6, 7), nav_dim=2, sig_dim=2, dtype=np.uint8)
    assert t_util.get_chunking(**args, **kw) == j_util.get_chunking(**args, **kw)


def test_get_chunking_errors_match_jax():
    for kw in ({}, {"data_shape": (2, 3), "nav_dim": 1, "sig_dim": 1}, {"data_shape": (2, 3), "nav_dim": 1,
                                                                          "sig_dim": 2, "dtype": np.uint8}):
        with pytest.raises(ValueError):
            t_util.get_chunking(**kw)
    with pytest.raises(ValueError, match="byte unit"):
        t_util.get_chunking(data_shape=(2, 3, 3), nav_dim=1, sig_dim=2, dtype=np.uint8, chunk_bytes="3 XB")


def test_get_dask_array_raises_without_dask(monkeypatch):
    monkeypatch.setitem(sys.modules, "dask", None)
    monkeypatch.setitem(sys.modules, "dask.array", None)
    _, t = _pair()
    with pytest.raises(ImportError, match="optional dependency dask"):
        t_util.get_dask_array(t)


def test_set_log_level():
    logger = logging.getLogger("kikuchipy_tpu_torch")
    before = logger.level
    try:
        kt.set_log_level("DEBUG")
        assert logger.level == logging.DEBUG
        kt.set_log_level(logging.WARNING)
        assert logger.level == logging.WARNING
    finally:
        logger.setLevel(before)


def test_top_level_and_signals_exports():
    for name in ("load", "save", "set_log_level", "__version__", "signals", "io", "indexing", "detectors",
                 "filters", "ops"):
        assert name in kt.__all__ and hasattr(kt, name), name
    assert kt.__version__ == kp.__version__
    from kikuchipy_tpu import signals as js
    from kikuchipy_tpu_torch import signals as ts

    assert ts.__all__ == js.__all__
    assert ts.LazyEBSDMasterPattern is ts.EBSDMasterPattern and ts.LazyVirtualBSEImage is ts.VirtualBSEImage
    assert ts.LazyECPMasterPattern is ts.ECPMasterPattern and ts.util is t_util
    # The port has every name of the JAX package's top level, the last six
    # (data, draw, imaging, pattern, simulation, simulations) since they were
    # ported.
    assert [n for n in kp.__all__ if n not in kt.__all__] == []
    for name in ("data", "draw", "imaging", "pattern", "simulation", "simulations"):
        assert getattr(kt, name).__name__ == f"kikuchipy_tpu_torch.{name}", name


# ------------------------------ signatures ------------------------------ #


def _params(obj):
    params = [(p.name, p.kind, p.default) for p in inspect.signature(obj).parameters.values()]
    return [p for p in params if not (p[0] == "device" and p[2] is None)]


@pytest.mark.parametrize("cls,names", [
    ("EBSD", ["mean", "max", "min", "sum", "std", "change_dtype", "set_scan_calibration", "set_detector_calibration",
              "extract_grid", "crop", "deepcopy", "save", "as_lazy", "compute", "get_virtual_bse_intensity",
              "plot_virtual_bse_intensity", "decomposition", "get_decomposition_model",
              "get_decomposition_model_write", "plot"]),
    ("KikuchiMasterPattern", ["rescale_intensity", "normalize_intensity", "adaptive_histogram_equalization",
                              "change_dtype", "deepcopy", "as_lazy", "compute", "set_signal_type", "as_lambert",
                              "plot_spherical", "plot"]),
    ("VirtualBSEImage", ["rescale_intensity", "normalize_intensity", "adaptive_histogram_equalization",
                         "change_dtype", "deepcopy", "as_lazy", "compute", "plot"]),
    ("LazyEBSD", ["rescale_intensity", "normalize_intensity", "remove_static_background",
                  "remove_dynamic_background", "get_dynamic_background", "fft_filter",
                  "adaptive_histogram_equalization", "downsample", "rebin", "change_dtype",
                  "average_neighbour_patterns", "as_lazy", "compute", "dictionary_indexing", "refine_orientation",
                  "save"]),
])
def test_methods_have_jax_signatures(cls, names):
    import kikuchipy_tpu.signals as js

    from kikuchipy_tpu_torch import signals as ts

    jcls = getattr(js, cls, None) or getattr(j_mp, cls)
    tcls = getattr(ts, cls, None) or getattr(t_mp, cls)
    for name in names:
        assert _params(getattr(tcls, name)) == _params(getattr(jcls, name)), name
    # The dataclasses' fields: JAX's, and the port's device last.
    jf = [f.name for f in dataclasses.fields(jcls)]
    tf = [f.name for f in dataclasses.fields(tcls) if f.name != "_sh_cache"]
    assert tf == jf + ["device"], (tf, jf)
