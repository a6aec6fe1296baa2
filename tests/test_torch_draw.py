"""Plots, example data, profiling and the ``pattern`` shims of the port
against the JAX package, on the CPU.

Plots are compared through their artists, on matplotlib's Agg backend: each
axes' lines (``get_xydata``, or the 3D data), images (``get_array``),
collections (offsets, segments, paths, arrays, face colors), patches,
texts, limits and labels. Host NumPy plots equal JAX's within 1e-12; a plot
of a pattern the port projected (the detector plotter) within the plain
projection's float32 tolerance, 1e-5 of the range, as is a plot of the
image quality (each package's float32 FFT metric). The shims' float32
results match within 1e-5 of the range (the FFTs sum in another order) and
their uint8 results within one gray level on at most 1% of the pixels.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import kikuchipy_tpu as jkp  # noqa: E402
import kikuchipy_tpu.data as jdata  # noqa: E402
import kikuchipy_tpu.draw as jdraw  # noqa: E402
import kikuchipy_tpu_torch as kt  # noqa: E402
from kikuchipy_tpu.crystallography.crystal_map import CrystalMap as JCrystalMap  # noqa: E402
from kikuchipy_tpu.crystallography.crystal_map import Phase as JPhase  # noqa: E402
from kikuchipy_tpu.crystallography.crystal_map import PhaseList as JPhaseList  # noqa: E402
from kikuchipy_tpu.crystallography.reciprocal import Lattice as JLattice  # noqa: E402
from kikuchipy_tpu.crystallography.reciprocal import ReciprocalLatticeVectors as JRLV  # noqa: E402
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector  # noqa: E402
from kikuchipy_tpu.imaging.vbse import VirtualBSEImager as JImager  # noqa: E402
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD  # noqa: E402
from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMaster  # noqa: E402
from kikuchipy_tpu.signals.virtual_bse_image import VirtualBSEImage as JVBSE  # noqa: E402
from kikuchipy_tpu.simulation import KikuchiPatternSimulator as JSimulator  # noqa: E402
from kikuchipy_tpu_torch import draw as tdraw  # noqa: E402
from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap as TCrystalMap  # noqa: E402
from kikuchipy_tpu_torch.crystallography.crystal_map import Phase as TPhase  # noqa: E402
from kikuchipy_tpu_torch.crystallography.crystal_map import PhaseList as TPhaseList  # noqa: E402
from kikuchipy_tpu_torch.crystallography.reciprocal import Lattice as TLattice  # noqa: E402
from kikuchipy_tpu_torch.crystallography.reciprocal import ReciprocalLatticeVectors as TRLV  # noqa: E402
from kikuchipy_tpu_torch.imaging.vbse import VirtualBSEImager as TImager  # noqa: E402
from kikuchipy_tpu_torch.simulation import KikuchiPatternSimulator as TSimulator  # noqa: E402

CPU = "cpu"
ROOT = Path(__file__).resolve().parent.parent
PLOT_TOL = 1e-12
ATOMS = [("ni", 0, 0, 0), ("ni", 0.5, 0.5, 0), ("ni", 0.5, 0, 0.5), ("ni", 0, 0.5, 0.5)]


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


# ------------------------------ artists ------------------------------ #


def _artists(fig) -> list:
    """Every axes' drawn data as nested lists of arrays and strings."""
    out = []
    for ax in fig.axes:
        entry = [type(ax).__name__, ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                 np.array(ax.get_xlim()), np.array(ax.get_ylim())]
        for line in ax.get_lines():
            data = line.get_data_3d() if hasattr(line, "get_data_3d") else line.get_xydata()
            entry.append(("line", np.asarray(data, dtype=float), line.get_color(), line.get_alpha()))
        for im in ax.get_images():
            entry.append(("image", np.asarray(im.get_array(), dtype=float), im.get_extent()))
        for coll in ax.collections:
            item = [type(coll).__name__, np.asarray(coll.get_offsets(), dtype=float),
                    np.asarray(coll.get_facecolor(), dtype=float)]
            if hasattr(coll, "get_segments"):
                item.append([np.asarray(s, dtype=float) for s in coll.get_segments()])
            else:
                item.append([np.asarray(p.vertices, dtype=float) for p in coll.get_paths()])
            arr = coll.get_array()
            item.append(None if arr is None else np.asarray(arr, dtype=float))
            entry.append(tuple(item))
        for patch in ax.patches:
            entry.append(("patch", type(patch).__name__,
                          np.asarray(patch.get_path().transformed(patch.get_patch_transform()).vertices, dtype=float)))
        for text in ax.texts:
            entry.append(("text", text.get_text(), np.asarray(text.get_position(), dtype=float)))
        out.append(entry)
    return out


def _same(a, b, tol=PLOT_TOL):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y, tol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
        assert a.shape == b.shape, (a.shape, b.shape)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        scale = max(1.0, float(np.nanmax(np.abs(b))) if b.size and not np.isnan(b).all() else 1.0)
        assert np.allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0, atol=tol * scale)
    else:
        assert a == b, (a, b)


def _same_figures(t, j, tol=PLOT_TOL):
    _same(_artists(t), _artists(j), tol)


def _fig(result):
    """The figure of a plot call's return value (a figure, axes or tuple)."""
    if isinstance(result, tuple):
        result = result[0]
    return result if isinstance(result, matplotlib.figure.Figure) else result.figure


# ------------------------------ inputs ------------------------------- #


def _reflectors(rlv, lattice):
    ref = rlv.from_min_dspacing(lattice(3.5236, 3.5236, 3.5236, 90, 90, 90), 1.5)
    ref.calculate_structure_factor(ATOMS)
    ref.calculate_theta(20.0)
    return ref.allowed()


def _masters(side=21, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.random((2, side, side)).astype(np.float32)
    kw = dict(hemisphere="both", projection="stereographic")
    return (JMaster(data, phase=JPhase("ni", point_group="m-3m"), **kw),
            kt.EBSDMasterPattern(data, phase=TPhase("ni", point_group="m-3m"), device=CPU, **kw))


def _detectors(nav=(3, 4), seed=1):
    rng = np.random.default_rng(seed)
    pc = np.array([0.42, 0.21, 0.5]) + rng.uniform(-0.02, 0.02, nav + (3,))
    kw = dict(shape=(30, 40), sample_tilt=70, tilt=5, azimuthal=2)
    return JDetector(pc=pc, **kw), kt.EBSDDetector(pc=pc, **kw)


def _scans(seed=2):
    data = np.random.default_rng(seed).integers(0, 256, (4, 5, 20, 25), dtype=np.uint8)
    return JEBSD(data), kt.EBSD(data, device=CPU)


def _crystal_maps(seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(20, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    phase_id = np.where(rng.random(20) < 0.2, -1, 0)
    prop = {"scores": rng.random((20, 2)), "iq": rng.random(20)}
    return tuple(cls(rotations=q, phase_id=phase_id, prop=dict(prop), shape=(4, 5),
                     phases=plist({0: phase("ni", point_group="m-3m")}))
                 for cls, plist, phase in ((JCrystalMap, JPhaseList, JPhase), (TCrystalMap, TPhaseList, TPhase)))


# ------------------------------- draw -------------------------------- #


def test_markers_and_navigators_equal_jax():
    rng = np.random.default_rng(4)
    lines = rng.random((6, 4)) * 30
    lines[2, 1] = np.nan
    t = tdraw.get_line_segment_list(lines, colors="b")
    j = jdraw.get_line_segment_list(lines, colors="b")
    _same([np.asarray(s) for s in t.get_segments()], [np.asarray(s) for s in j.get_segments()])
    _same(np.asarray(t.get_color()), np.asarray(j.get_color()))
    points = rng.random((5, 2))
    points[0, 0] = np.nan
    t, j = tdraw.get_point_list(points, s=10), jdraw.get_point_list(points, s=10)
    assert t.keys() == j.keys()
    for key in t:
        _same(np.asarray(t[key]) if key in ("x", "y") else t[key], np.asarray(j[key]) if key in ("x", "y") else j[key])
    image = rng.random((4, 5, 3))
    for dtype in (np.uint8, np.uint16):
        assert tdraw.get_rgb_navigator(image, dtype).tobytes() == jdraw.get_rgb_navigator(image, dtype).tobytes()


@pytest.mark.parametrize("area", [False, True])
def test_pattern_positions_in_map_equal_jax(area):
    rc = np.array([[1, 2], [3, 4], [5, 1]])
    kw = dict(roi_shape=(8, 9), return_figure=True, color="r")
    if area:
        kw.update(roi_origin=(2, 3), area_shape=(15, 16), area_image=np.arange(240.0).reshape(15, 16))
    else:
        kw.update(roi_image=np.arange(72.0).reshape(8, 9))
    _same_figures(tdraw.plot_pattern_positions_in_map(rc, **kw), jdraw.plot_pattern_positions_in_map(rc, **kw))
    with pytest.raises(ValueError, match="rc must have shape"):
        tdraw.plot_pattern_positions_in_map(np.ones((2, 3)), (4, 4))


@pytest.mark.parametrize("style", ["surface", "points"])
def test_master_pattern_sphere_equals_jax(style):
    from kikuchipy_tpu.draw import sphere as jsphere
    from kikuchipy_tpu_torch.draw import sphere as tsphere

    rng = np.random.default_rng(5)
    up, low = rng.random((2, 31, 31))
    for a, b in zip(tsphere.sample_sphere(up, low, 19, 37), jsphere.sample_sphere(up, low, 19, 37)):
        _same(a, b)
    t = tsphere.plot_master_pattern_sphere(up, low, style=style, n_polar=19, n_azimuth=37)
    j = jsphere.plot_master_pattern_sphere(up, low, style=style, n_polar=19, n_azimuth=37)
    _same_figures(t, j)
    with pytest.raises(ValueError, match="style"):
        tsphere.plot_master_pattern_sphere(up, low, style="mesh")


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(coordinates="gnomonic", draw_gnomonic_circles=True, zoom=1.5),
        dict(pattern=np.arange(1200.0).reshape(30, 40), draw_gnomonic_circles=True,
             gnomonic_angles=[20, 40], pc_kwargs={"s": 30}, show_pc=True),
        dict(show_pc=False, pattern=np.ones((30, 40)), coordinates="gnomonic"),
    ],
)
def test_detector_plots_equal_jax(kw):
    jd, td = _detectors()
    _same_figures(tdraw.plot_detector(td, return_figure=True, **kw), jdraw.plot_detector(jd, return_figure=True, **kw))
    _same_figures(td.plot(return_figure=True, **kw), jd.plot(return_figure=True, **kw))
    for mode in ("side", "top"):
        _same_figures(tdraw.plot_detector_sample_geometry(td, mode, return_figure=True),
                      jdraw.plot_detector_sample_geometry(jd, mode, return_figure=True))
    _same_figures(td.plot_side_view(return_figure=True), jd.plot_side_view(return_figure=True))
    _same_figures(td.plot_top_view(return_figure=True), jd.plot_top_view(return_figure=True))
    with pytest.raises(ValueError, match="mode"):
        tdraw.plot_detector_sample_geometry(td, "front")


@pytest.mark.parametrize("mode, kw", [("map", dict(annotate=True)), ("scatter", dict(orientation="vertical")),
                                      ("scatter", dict()), ("3d", dict(annotate=True))])
def test_plot_pc_equals_jax(mode, kw):
    jd, td = _detectors()
    _same_figures(td.plot_pc(mode, return_figure=True, **kw), jd.plot_pc(mode, return_figure=True, **kw))


def test_plot_pc_errors_match_jax():
    jd, td = _detectors()
    for bad in (dict(mode="line"), dict(mode="scatter", orientation="diagonal")):
        with pytest.raises(ValueError) as je:
            jd.plot_pc(**bad)
        with pytest.raises(ValueError) as te:
            td.plot_pc(**bad)
        assert str(te.value) == str(je.value)


def test_detector_plotter_equals_jax():
    jmp, tmp = _masters(side=41)
    jmp, tmp = jmp.as_lambert(), tmp.as_lambert()
    jd, td = _detectors(nav=())
    q = np.array([0.9, 0.1, 0.3, 0.2])
    q /= np.linalg.norm(q)
    t_plotter = tdraw.EBSDDetectorPlotter(td, q, master_pattern=tmp)
    j_plotter = jdraw.EBSDDetectorPlotter(jd, q, master_pattern=jmp)
    assert t_plotter.detector.pc.shape == (1, 3)
    _same_figures(t_plotter.plot(return_figure=True), j_plotter.plot(return_figure=True), tol=1e-5)
    _same_figures(tdraw.EBSDDetectorPlotter(td).plot(return_figure=True),
                  jdraw.EBSDDetectorPlotter(jd).plot(return_figure=True))
    t_fig, t_sliders = tdraw.plot_detector_interactive(td, q, master_pattern=tmp)
    j_fig, j_sliders = jdraw.plot_detector_interactive(jd, q, master_pattern=jmp)
    assert list(t_sliders) == list(j_sliders)
    for name, value in (("pcz", 0.6), ("detector_tilt", 10.0)):
        t_sliders[name].set_val(value)
        j_sliders[name].set_val(value)
    _same_figures(t_fig, j_fig, tol=1e-5)
    assert t_plotter.detector.pc[0, 2] != 0.6 and np.isclose(t_sliders["pcz"].val, 0.6)


# ------------------------- plotting methods -------------------------- #


@pytest.mark.parametrize("kw", [dict(), dict(navigator="mean", pattern_idx=(1, 2)), dict(navigator=np.ones((4, 5)))])
def test_ebsd_plot_equals_jax(kw):
    # The image-quality navigator is each package's float32 FFT metric: within
    # 1e-5, as tests/test_torch_preprocess.py holds it.
    js, ts = _scans()
    tol = 1e-5 if not kw else PLOT_TOL
    _same_figures(ts.plot(return_figure=True, **kw), js.plot(return_figure=True, **kw), tol=tol)
    with pytest.raises(ValueError, match="navigator"):
        ts.plot(navigator="max")


def test_ebsd_virtual_bse_plot_equals_jax():
    js, ts = _scans()
    roi = (2, 12, 5, 20)
    _same_figures(_fig(ts.plot_virtual_bse_intensity(roi, cmap="viridis")),
                  _fig(js.plot_virtual_bse_intensity(roi, cmap="viridis")))
    image = ts.get_virtual_bse_intensity(roi)
    _same_figures(_fig(kt.VirtualBSEImage(image, device=CPU).plot()), _fig(JVBSE(image).plot()))


@pytest.mark.parametrize("kw", [dict(), dict(pattern_idx=(1, 1), rgb_channels=[(0, 0), [(1, 1), (2, 2)], None],
                                             visible_indices=False),
                                dict(rgb_channels={"r": (0, 1), "b": (4, 4)})])
def test_vbse_grid_plot_equals_jax(kw):
    js, ts = _scans()
    _same_figures(TImager(ts).plot_grid(return_figure=True, **kw), JImager(js).plot_grid(return_figure=True, **kw))


def test_master_pattern_plots_equal_jax():
    jmp, tmp = _masters()
    _same_figures(tmp.plot_spherical(return_figure=True, n_polar=13, n_azimuth=25),
                  jmp.plot_spherical(return_figure=True, n_polar=13, n_azimuth=25))
    _same_figures(_fig(tmp.plot()), _fig(jmp.plot()))
    lam = tmp.as_lambert()
    with pytest.raises(ValueError, match="stereographic"):
        lam.plot_spherical()
    upper = kt.EBSDMasterPattern(tmp.data[0], hemisphere="upper", projection="stereographic", device=CPU)
    with pytest.raises(ValueError, match="both hemispheres"):
        upper.plot_spherical()


@pytest.mark.parametrize("kw", [dict(), dict(value="iq", colorbar=True), dict(value="scores", overlay="iq"),
                                dict(overlay="scores", direction=(1.0, 0.0, 0.0)),
                                dict(value=np.arange(20.0), colorbar=True, colorbar_label="n")])
def test_crystal_map_plot_equals_jax(kw):
    jm, tm = _crystal_maps()
    _same_figures(tm.plot(return_figure=True, **kw), jm.plot(return_figure=True, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(mode="bands", scaling="square", hemisphere="both", color="phase"),
                                dict(projection="spherical", scaling=None),
                                dict(projection="spherical", mode="bands", hemisphere="lower")])
def test_simulator_plot_equals_jax(kw):
    t = TSimulator(_reflectors(TRLV, TLattice), phase=TPhase("ni", point_group="m-3m"))
    j = JSimulator(_reflectors(JRLV, JLattice), phase=JPhase("ni", point_group="m-3m"))
    _same_figures(t.plot(return_figure=True, **kw), j.plot(return_figure=True, **kw))


def test_simulator_plot_errors_match_jax():
    t = TSimulator(_reflectors(TRLV, TLattice))
    j = JSimulator(_reflectors(JRLV, JLattice))
    for bad in (dict(mode="dots"), dict(projection="gnomonic"), dict(hemisphere="east")):
        with pytest.raises(ValueError) as je:
            j.plot(**bad)
        with pytest.raises(ValueError) as te:
            t.plot(**bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ImportError, match="pyvista"):
        t.plot(backend="pyvista")


@pytest.mark.parametrize("kw", [dict(), dict(coordinates="gnomonic", pattern=np.ones((30, 40))),
                                dict(index=(1, 2), pc=False, zone_axes_labels=False,
                                     lines_kwargs={"color": "b"}, zone_axes_kwargs={"fc": "r"})])
def test_geometrical_simulation_plot_equals_jax(kw):
    jd, td = _detectors()
    rng = np.random.default_rng(9)
    q = rng.normal(size=(3, 4, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tg = TSimulator(_reflectors(TRLV, TLattice)).on_detector(td, q)
    jg = JSimulator(_reflectors(JRLV, JLattice)).on_detector(jd, q)
    _same_figures(tg.plot(return_figure=True, **kw), jg.plot(return_figure=True, **kw))
    coll_kw = {k: v for k, v in kw.items() if k in ("index", "coordinates")}
    t_colls = tg.as_collections(zone_axes=True, zone_axes_labels=True, **coll_kw)
    j_colls = jg.as_collections(zone_axes=True, zone_axes_labels=True, **coll_kw)
    _same([np.asarray(s) for s in t_colls[0].get_segments()], [np.asarray(s) for s in j_colls[0].get_segments()])
    _same([p.vertices for p in t_colls[1].get_paths()], [p.vertices for p in j_colls[1].get_paths()])
    _same([(x.get_text(), np.asarray(x.get_position())) for x in t_colls[2]],
          [(x.get_text(), np.asarray(x.get_position())) for x in j_colls[2]])


# ------------------------------- data -------------------------------- #


def test_data_registry_equals_jax():
    from kikuchipy_tpu.data import _registry as jreg
    from kikuchipy_tpu_torch.data import _registry as treg

    assert treg.REGISTRY_HASHES == jreg.REGISTRY_HASHES and treg.REGISTRY_URLS == jreg.REGISTRY_URLS
    assert sorted(kt.data.__all__) == sorted(jdata.__all__)


def test_data_accessors_read_the_ports_file(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    from kikuchipy_tpu_torch.data import _registry as treg

    data = np.random.default_rng(10).integers(0, 256, (3, 3, 12, 14), dtype=np.uint8)
    det = kt.EBSDDetector(shape=(12, 14), pc=(0.4, 0.3, 0.6))
    path = tmp_path / "kikuchipy_h5ebsd" / "patterns.h5"
    path.parent.mkdir()
    kt.EBSD(data, detector=det, static_background=data[0, 0], device=CPU).save(path)
    monkeypatch.setenv("KP_TPU_DATA_DIR", str(tmp_path))
    assert kt.data.data_path() == tmp_path == jdata.data_path()
    t = kt.data.nickel_ebsd_small(device=CPU)
    j = jdata.nickel_ebsd_small()
    assert t.device.type == CPU and np.array_equal(t.data.numpy(), np.asarray(j.data))
    assert np.array_equal(t.data.numpy(), data)
    np.testing.assert_allclose(t.detector.pc, j.detector.pc, rtol=0, atol=1e-12)
    # The registered hash is the upstream file's, so a check of this one fails.
    with pytest.raises(ValueError, match="MD5 mismatch"):
        kt.data.nickel_ebsd_small(check_hash=True, device=CPU)
    assert treg.verify(path, "not/registered.h5")


@pytest.mark.parametrize(
    "call, error",
    [
        (lambda d: d.nickel_ebsd_large(), FileNotFoundError),
        (lambda d: d.si_wafer(), FileNotFoundError),
        (lambda d: d.ni_gain(3), FileNotFoundError),
        (lambda d: d.ni_gain_calibration(2), FileNotFoundError),
        (lambda d: d.si_ebsd_moving_screen(5), FileNotFoundError),
        (lambda d: d.ebsd_master_pattern("al"), FileNotFoundError),
        (lambda d: d.nickel_ebsd_master_pattern_small(), FileNotFoundError),
        (lambda d: d.ni_gain(11), ValueError),
        (lambda d: d.ni_gain_calibration(0), ValueError),
        (lambda d: d.si_ebsd_moving_screen(3), ValueError),
        (lambda d: d.ebsd_master_pattern("kryptonite"), ValueError),
    ],
)
def test_absent_files_and_bad_arguments_raise_as_jax(tmp_path, monkeypatch, call, error):
    # Never a download: an absent file raises with the way to get it.
    monkeypatch.setenv("KP_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jdata, "_REFERENCE_DATA", tmp_path / "none")
    monkeypatch.setattr(kt.data, "_reference_data", lambda: None)
    with pytest.raises(error) as je:
        call(jdata)
    with pytest.raises(error) as te:
        call(kt.data)
    assert str(te.value).replace("kikuchipy_tpu_torch", "kikuchipy_tpu") == str(je.value)
    if error is FileNotFoundError:
        assert "KP_TPU_DATA_DIR" in str(te.value)


def test_clear_cache_removes_only_the_data_directory(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    (cache / "x").mkdir(parents=True)
    monkeypatch.setenv("KP_TPU_DATA_DIR", str(cache))
    kt.data.clear_cache()
    assert not cache.exists() and tmp_path.exists()
    monkeypatch.delenv("KP_TPU_DATA_DIR")
    kt.data.clear_cache()  # nothing to clear


# ----------------------------- profiling ----------------------------- #


def test_stage_timer_reports_as_jax():
    from kikuchipy_tpu.utils.profiling import StageTimer as JTimer
    from kikuchipy_tpu_torch.utils.profiling import StageTimer as TTimer

    reports = []
    for timer in (TTimer(), JTimer()):
        for name, items in (("preprocess", 1024), ("index", 512), ("preprocess", 1024), ("idle", 0)):
            with timer.stage(name, items=items):
                torch.ones(8).sum()
        reports.append(timer.report())
        assert repr(timer).startswith("StageTimer(preprocess: ") and "items/s" in repr(timer)
    t, j = reports
    assert list(t) == list(j) == ["preprocess", "index", "idle"]
    for name in t:
        assert t[name]["items"] == j[name]["items"]
        assert t[name]["seconds"] > 0
        assert t[name]["items_per_second"] == pytest.approx(t[name]["items"] / t[name]["seconds"])
    assert t["idle"]["items_per_second"] == 0.0


def test_trace_writes_a_trace_file(tmp_path):
    from kikuchipy_tpu_torch.utils.profiling import trace

    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as prof:
        (torch.arange(64, dtype=torch.float32) * 2).sum()
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "aten::sum" in files[0].read_text()
    assert prof is not None


# ------------------------------- shims ------------------------------- #


def test_pattern_namespace_equals_jax():
    import kikuchipy_tpu.pattern as jpattern
    from kikuchipy_tpu_torch.ops import pattern as tops

    assert kt.pattern.__all__ == jpattern.__all__
    for name in kt.pattern.__all__:
        if name != "chunk":
            assert getattr(kt.pattern, name) is getattr(tops, name)
    assert kt.pattern.chunk.__all__ == jpattern.chunk.__all__


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_chunk_dynamic_background_matches_jax(dtype):
    import kikuchipy_tpu.pattern_chunk as jchunk

    rng = np.random.default_rng(11)
    p = (rng.random((3, 2, 24, 30)) * 200).astype(dtype)
    for kw in (dict(), dict(std=2.5, truncate=3.0), dict(dtype_out=np.float32)):
        t = kt.pattern.chunk.get_dynamic_background(p, device=CPU, **kw)
        j = np.asarray(jchunk.get_dynamic_background(p, **kw))
        assert isinstance(t, np.ndarray) and t.dtype == j.dtype and t.shape == j.shape
        if t.dtype == np.uint8:
            diff = np.abs(t.astype(int) - j.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * 200)


@pytest.mark.parametrize("shift", [False, True])
def test_chunk_fft_filter_matches_jax(shift):
    import kikuchipy_tpu.pattern_chunk as jchunk

    rng = np.random.default_rng(12)
    p = (rng.random((2, 3, 16, 20)) * 100).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(16) - 8, np.arange(20) - 10, indexing="ij")
    tf = np.exp(-(xx**2 + yy**2) / 20.0)
    if not shift:
        tf = np.fft.ifftshift(tf)
    for kw in (dict(transfer_function=tf, shift=shift), dict(transfer_function=tf, shift=shift, dtype_out=np.float64)):
        t = kt.pattern.chunk.fft_filter(p, device=CPU, **kw)
        j = np.asarray(jchunk.fft_filter(p, **kw))
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * 100)


# -------------------- machines without matplotlib --------------------- #


def test_new_subpackages_import_and_run_without_matplotlib_and_h5py(tmp_path):
    code = textwrap.dedent("""
        import sys
        for name in ("matplotlib", "matplotlib.pyplot", "h5py"):
            sys.modules[name] = None
        import numpy as np
        import kikuchipy_tpu_torch as kt
        import kikuchipy_tpu_torch.draw, kikuchipy_tpu_torch.simulation, kikuchipy_tpu_torch.imaging
        import kikuchipy_tpu_torch.data, kikuchipy_tpu_torch.pattern, kikuchipy_tpu_torch.simulations
        from kikuchipy_tpu_torch.crystallography.reciprocal import Lattice, ReciprocalLatticeVectors
        from kikuchipy_tpu_torch.imaging import VirtualBSEImager
        from kikuchipy_tpu_torch.ops.decomposition import pca

        ref = ReciprocalLatticeVectors.from_min_dspacing(Lattice(3.5236, 3.5236, 3.5236, 90, 90, 90), 1.5)
        ref.calculate_structure_factor([("ni", 0, 0, 0), ("ni", 0.5, 0.5, 0), ("ni", 0.5, 0, 0.5), ("ni", 0, 0.5, 0.5)])
        ref.calculate_theta(20.0)
        sim = kt.simulation.KikuchiPatternSimulator(ref.allowed())
        mp = sim.calculate_master_pattern(half_size=8, hemisphere="both", device="cpu")
        assert mp.data.shape == (2, 17, 17) and np.isfinite(mp.data).all()
        s = kt.EBSD(np.random.default_rng(0).integers(0, 256, (4, 5, 10, 10), dtype=np.uint8), device="cpu")
        assert VirtualBSEImager(s).get_images_from_grid().shape == (5, 5, 4, 5)
        assert pca(s.data, 3, device="cpu")[0].shape == (3, 100)
        s.decomposition(output_dimension=3)
        for call in (lambda: s.plot(), lambda: mp.plot(), lambda: s.get_decomposition_model_write("x.h5")):
            try:
                call()
            except ImportError:
                pass
            else:
                raise AssertionError("no ImportError")
        bad = [m for m in ("matplotlib", "h5py", "jax", "kikuchipy_tpu") if sys.modules.get(m) is not None]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "MPLBACKEND": "Agg"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stdout + out.stderr
    assert not (ROOT / "x.h5").exists()


def test_top_level_names_include_jax_subpackages():
    for name in ("data", "draw", "imaging", "pattern", "simulation", "simulations"):
        assert name in kt.__all__ and name in jkp.__all__
        assert getattr(kt, name).__name__ == f"kikuchipy_tpu_torch.{name}"


def _params(obj):
    import inspect

    params = [(p.name, p.kind, p.default) for p in inspect.signature(obj).parameters.values()]
    return [p for p in params if not (p[0] == "device" and p[2] is None)]


@pytest.mark.parametrize("path", [
    "simulation.KikuchiPatternSimulator.__init__", "simulation.KikuchiPatternSimulator.calculate_master_pattern",
    "simulation.KikuchiPatternSimulator.on_detector", "simulation.KikuchiPatternSimulator.plot",
    "simulation.GeometricalKikuchiPatternSimulation.__init__",
    *(f"simulation.GeometricalKikuchiPatternSimulation.{m}" for m in (
        "as_markers", "lines_coordinates", "zone_axes_coordinates", "as_collections", "plot")),
    "simulation.KikuchiPatternLine.__init__", "simulation.KikuchiPatternZoneAxis.__init__",
    "ops.decomposition.pca", "ops.decomposition.pca_reconstruct",
    "imaging.vbse.normalize_image", "imaging.vbse.get_rgb_image", "imaging.VirtualBSEImager.__init__",
    *(f"imaging.VirtualBSEImager.{m}" for m in (
        "roi_from_grid", "get_virtual_bse_intensity", "get_images_from_grid", "get_rgb_image", "plot_grid")),
    "utils.profiling.trace", "utils.profiling.StageTimer.stage", "utils.profiling.StageTimer.report",
    "pattern_chunk.get_dynamic_background", "pattern_chunk.fft_filter",
    *(f"data.{name}" for name in jdata.__all__),
    *(f"draw.{name}" for name in jdraw.__all__ if callable(getattr(jdraw, name))),
    "draw.sphere.sample_sphere", "draw.sphere.plot_master_pattern_sphere",
    "draw.EBSDDetectorPlotter.plot", "draw.EBSDDetectorPlotter.interactive",
    "crystallography.crystal_map.CrystalMap.plot",
    *(f"geometry.detector.EBSDDetector.{m}" for m in ("plot", "plot_pc", "plot_side_view", "plot_top_view")),
])
def test_new_entry_points_have_jax_signatures(path):
    # JAX's arguments in JAX's order; the port may add device=None (before
    # a **kwargs, else at the end).
    import importlib

    def resolve(package):
        parts = path.split(".")
        for i in range(len(parts), 0, -1):
            try:
                obj = importlib.import_module(".".join([package, *parts[:i]]))
            except ImportError:
                continue
            for attr in parts[i:]:
                obj = getattr(obj, attr)
            return obj
        raise ImportError(path)

    assert _params(resolve("kikuchipy_tpu_torch")) == _params(resolve("kikuchipy_tpu")), path
