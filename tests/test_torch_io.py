"""The port's ``load`` and ``save`` against the JAX package's on the CPU.

Every one of the thirteen plugins reads a synthetic file (made from seeded
NumPy, after the file makers of ``tests/test_io.py``) through both
packages: the patterns must be the same bytes, the detector and the float64
metadata within 1e-12, the crystal map's rotations within 1e-12. The two
writers (kikuchipy h5ebsd, NORDIF ``.dat``) and the ``.ang`` writer are held
by round trips across the packages: a file written by one loads in the
other. The binary formats and ``LazyEBSD`` are also loaded with ``h5py``,
``PIL``, ``matplotlib`` and ``dask`` hidden, as on a machine without them.
"""

import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import h5py
import numpy as np
import pytest
from PIL import Image

import kikuchipy_tpu as kp
import kikuchipy_tpu_torch as kt
from kikuchipy_tpu.io._io import _sniff_hdf5_plugin as j_sniff
from kikuchipy_tpu.io.plugins import ang as j_ang
from kikuchipy_tpu.io.plugins.oxford_binary import _EbspReader as JReader
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.io._io import _sniff_hdf5_plugin as t_sniff
from kikuchipy_tpu_torch.io._io import plugins as t_plugins
from kikuchipy_tpu_torch.io.plugins import ang as t_ang
from kikuchipy_tpu_torch.io.plugins.oxford_binary import _EbspReader as TReader

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=0, atol=1e-12)


def _load(path, **kw):
    return kp.load(path, **kw), kt.load(path, device="cpu", **kw)


def _host(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(x, np.ndarray) else np.asarray(x)


def _same_metadata(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, (float, np.floating, np.ndarray)) and np.asarray(va).dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(vb, dtype=float), np.asarray(va, dtype=float), **TOL)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(vb, va)
        else:
            assert vb == va, k


def _same_scan(j, t):
    jd, td = np.asarray(j.data), _host(t.data)
    assert td.dtype == jd.dtype and td.shape == jd.shape
    np.testing.assert_array_equal(td, jd)
    if j.detector is not None:
        for f in ("shape", "binning", "px_size", "tilt", "azimuthal", "sample_tilt"):
            np.testing.assert_allclose(getattr(t.detector, f), getattr(j.detector, f), **TOL)
        np.testing.assert_allclose(t.detector.pc, j.detector.pc, **TOL)
    if j.static_background is None:
        assert t.static_background is None
    else:
        np.testing.assert_array_equal(_host(t.static_background), np.asarray(j.static_background))
    _same_metadata(j.metadata, t.metadata)
    if j.xmap is None:
        assert t.xmap is None
    else:
        assert t.xmap.shape == j.xmap.shape
        np.testing.assert_allclose(t.xmap.rotations, j.xmap.rotations, **TOL)
        np.testing.assert_array_equal(t.xmap.phase_id, j.xmap.phase_id)
        np.testing.assert_array_equal(t.xmap.is_in_data, j.xmap.is_in_data)
        np.testing.assert_allclose(t.xmap.x, j.xmap.x, **TOL)
        np.testing.assert_allclose(t.xmap.y, j.xmap.y, **TOL)
        assert set(t.xmap.prop) == set(j.xmap.prop)
        for key, value in j.xmap.prop.items():
            np.testing.assert_array_equal(t.xmap.prop[key], value)
        assert t.xmap.phases.names == j.xmap.phases.names
        assert [t.xmap.phases[i].space_group for i in t.xmap.phases.ids] == [
            j.xmap.phases[i].space_group for i in j.xmap.phases.ids]


def _same_master(j, t):
    assert type(t).__name__ == type(j).__name__
    np.testing.assert_array_equal(t.data, np.asarray(j.data))
    assert t.data.dtype == np.asarray(j.data).dtype
    assert (t.hemisphere, t.projection) == (j.hemisphere, j.projection)
    np.testing.assert_allclose(t.energies, j.energies, **TOL)
    assert (t.phase.name, t.phase.space_group) == (j.phase.name, j.phase.space_group)
    if j.phase.lattice is None:
        assert t.phase.lattice is None
    else:
        np.testing.assert_allclose(t.phase.lattice, j.phase.lattice, **TOL)
    assert t.phase.atoms == j.phase.atoms
    assert t.metadata == j.metadata


def _patterns(shape, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)


def _rotations(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q * np.sign(q[:, :1])


# ------------------------------ registry ------------------------------ #


def test_plugins_registry_is_jax_and_every_module_exists():
    from kikuchipy_tpu.io._io import plugins as j_plugins

    assert t_plugins() == j_plugins() and len(t_plugins()) == 13
    for name in t_plugins():
        assert (ROOT / "kikuchipy_tpu_torch" / "io" / "plugins" / f"{name}.py").is_file(), name


def test_load_errors_match_jax(tmp_path):
    for call in (kp.load, lambda p: kt.load(p, device="cpu")):
        with pytest.raises(FileNotFoundError):
            call(tmp_path / "none.h5")
    f = tmp_path / "x.xyz"
    f.write_text("")
    for call in (kp.load, lambda p: kt.load(p, device="cpu")):
        with pytest.raises(IOError, match="Could not read"):
            call(f)
    with pytest.raises(IOError, match="does not correspond"):
        kt.save(tmp_path / "x.png", kt.EBSD(np.zeros((1, 2, 2), np.uint8), device="cpu"))


def test_hdf5_sniffing_matches_jax(tmp_path):
    cases = [("Manufacturer", b"kikuchipy"), ("Manufacturer", b"EDAX"), ("Manufacturer", b"Bruker Nano"),
             (" Manufacturer", np.array([b"EDAX"])), ("group", "EMData/EBSDmaster"), ("group", "EMData/ECPmaster"),
             ("group", "EMData/TKDmaster"), ("group", "EMData/EBSD"), ("Format Version", b"7.0"),
             ("group", "nothing")]
    for i, (key, value) in enumerate(cases):
        p = tmp_path / f"{i}.h5"
        with h5py.File(p, "w") as f:
            if key == "group":
                f.create_group(value)
            else:
                f.create_dataset(key, data=value)
        try:
            want = j_sniff(p)
        except IOError:
            with pytest.raises(IOError, match="flavor"):
                t_sniff(p)
            continue
        assert t_sniff(p) == want


# ------------------------- kikuchipy h5ebsd ------------------------- #


def _jax_scan(seed=0, nav=(3, 4), sig=(6, 5), per_point_pc=True, xmap=True):
    from kikuchipy_tpu.crystallography.crystal_map import CrystalMap, Phase, PhaseList
    from kikuchipy_tpu.geometry.detector import EBSDDetector
    from kikuchipy_tpu.signals.ebsd import EBSD

    rng = np.random.default_rng(seed)
    n = int(np.prod(nav))
    pc = rng.uniform(0.4, 0.6, nav + (3,)) if per_point_pc else np.array([0.41, 0.52, 0.63])
    det = EBSDDetector(shape=sig, pc=pc, tilt=3.5, azimuthal=1.25, sample_tilt=69.5, binning=2, px_size=21.5)
    cm = None
    if xmap:
        cm = CrystalMap(rotations=_rotations(n, seed + 1), shape=nav, phase_id=rng.integers(0, 2, n),
                        prop={"scores": rng.random(n).astype(np.float32),
                              "simulation_indices": rng.integers(0, 99, n)},
                        phases=PhaseList({0: Phase(name="ni", space_group=225), 1: Phase(name="al")}))
    s = EBSD(data=_patterns(nav + sig, seed=seed), detector=det, static_background=_patterns(sig, seed=seed + 2),
             xmap=cm, metadata={"step_x": 1.5, "step_y": 2.25})
    return s


@pytest.mark.parametrize("per_point_pc", [True, False])
@pytest.mark.parametrize("xmap", [True, False])
def test_kikuchipy_h5ebsd_written_by_jax_reads_in_the_port(tmp_path, per_point_pc, xmap):
    p = tmp_path / "scan.h5"
    _jax_scan(per_point_pc=per_point_pc, xmap=xmap).save(p)
    j, t = _load(p)
    _same_scan(j, t)


def test_kikuchipy_h5ebsd_written_by_the_port_reads_in_jax(tmp_path):
    j0 = _jax_scan(seed=3)
    p_j, p_t = tmp_path / "j.h5", tmp_path / "t.h5"
    j0.save(p_j)
    t0 = kt.load(p_j, device="cpu")
    t0.save(p_t)
    _same_scan(kp.load(p_t), kt.load(p_t, device="cpu"))
    _same_scan(kp.load(p_j), kt.load(p_t, device="cpu"))
    # The port's file holds the JAX file's datasets, to the same values.
    with h5py.File(p_j) as fj, h5py.File(p_t) as ft:
        names_j, names_t = [], []
        fj.visit(names_j.append)
        ft.visit(names_t.append)
        assert sorted(names_t) == sorted(names_j)
        for name in names_j:
            if isinstance(fj[name], h5py.Dataset) and name not in ("manufacturer", "version"):
                a, b = fj[name][()], ft[name][()]
                if np.asarray(a).dtype.kind == "f":
                    np.testing.assert_allclose(b, a, **TOL)
                else:
                    np.testing.assert_array_equal(b, a)


def test_kikuchipy_h5ebsd_scans_and_add_scan(tmp_path):
    p = tmp_path / "two.h5"
    t0 = kt.load(_save_jax(tmp_path / "src.h5", _jax_scan(seed=5)), device="cpu")
    t0.save(p)
    kt.save(p, t0.inav[::-1], scan_number=2, add_scan=True)
    with pytest.raises(IOError, match="already exists"):
        kt.save(p, t0, scan_number=1, add_scan=True)
    js = kp.load(p, scan_group_names=["Scan 1", "Scan 2"])
    ts = kt.load(p, scan_group_names=["Scan 1", "Scan 2"], device="cpu")
    assert len(ts) == 2
    for j, t in zip(js, ts):
        _same_scan(j, t)
    _same_scan(kp.load(p, scan_group_names="Scan 2"), kt.load(p, scan_group_names="Scan 2", device="cpu"))
    with pytest.raises(IOError, match="not in"):
        kt.load(p, scan_group_names="Scan 9", device="cpu")


def _save_jax(path, s):
    s.save(path)
    return path


def test_save_overwrite_semantics_match_jax(tmp_path):
    s = kt.EBSD(data=np.arange(81, dtype=np.uint8).reshape(1, 1, 9, 9), device="cpu")
    p = tmp_path / "scan.h5"
    s.save(p)
    with pytest.raises(FileExistsError, match="overwrite=True"):
        s.save(p)
    before = p.stat().st_mtime_ns
    s.save(p, overwrite=False)
    assert p.stat().st_mtime_ns == before
    kt.EBSD(data=np.full((1, 1, 9, 9), 7, dtype=np.uint8), device="cpu").save(p, overwrite=True)
    assert np.all(np.asarray(kp.load(p).data) == 7)


# ------------------------ vendor HDF5 readers ------------------------ #


def _bruker(path, roi=False, per_point_pc=False):
    rng = np.random.default_rng(8)
    with h5py.File(path, "w") as h:
        h["Manufacturer"] = np.array([b"Bruker Nano"])
        g = h.create_group("Scan 0/EBSD")
        hdr = g.create_group("Header")
        hdr["NROWS"] = np.array([3])
        hdr["NCOLS"] = np.array([4])
        hdr["PatternHeight"] = np.array([5])
        hdr["PatternWidth"] = np.array([6])
        n = 12
        hdr["PCX"] = rng.uniform(0.4, 0.6, n) if per_point_pc else np.array([0.45])
        hdr["PCY"] = rng.uniform(0.4, 0.6, n) if per_point_pc else np.array([0.6])
        hdr["DD"] = rng.uniform(0.4, 0.6, n) if per_point_pc else np.array([0.5])
        hdr["CameraTilt"] = np.array([2.5])
        hdr["Sample Tilt"] = np.array([69.0])
        hdr["XSTEP"] = np.array([1.5])
        hdr["YSTEP"] = np.array([1.75])
        hdr["StaticBackground"] = _patterns((5, 6), seed=9)
        pats = _patterns((n, 5, 6), seed=10)
        if roi:
            yy, xx = np.divmod(np.arange(n), 4)
            order = rng.permutation(n)
            g["Data/RawPatterns"] = pats[order]
            g["Data/X BEAM"] = xx[order] + 7
            g["Data/Y BEAM"] = yy[order] + 2
        else:
            g["Data/RawPatterns"] = pats
        sem = g.create_group("SEM")
        sem["KV"] = np.array([20.0])
        sem["Magnification"] = np.array([500.0])
        sem["WD"] = np.array([15.5])
    return path


@pytest.mark.parametrize("roi", [False, True])
@pytest.mark.parametrize("per_point_pc", [False, True])
def test_bruker_h5ebsd_matches_jax(tmp_path, roi, per_point_pc):
    j, t = _load(_bruker(tmp_path / "bruker.h5", roi=roi, per_point_pc=per_point_pc))
    _same_scan(j, t)


def _edax_h5(path, with_xmap=True, with_pc=True):
    rng = np.random.default_rng(11)
    with h5py.File(path, "w") as h:
        h[" Manufacturer"] = np.array([b"EDAX"])
        g = h.create_group("Scan 1/EBSD")
        hdr = g.create_group("Header")
        hdr["nRows"] = np.array([3])
        hdr["nColumns"] = np.array([2])
        hdr["Pattern Height"] = np.array([4])
        hdr["Pattern Width"] = np.array([5])
        hdr["Camera Elevation Angle"] = np.array([4.5])
        hdr["Camera Azimuthal Angle"] = np.array([1.0])
        hdr["Sample Tilt"] = np.array([70.0])
        hdr["Step X"] = np.array([0.25])
        hdr["Step Y"] = np.array([0.5])
        hdr["Working Distance"] = np.array([12.5])
        if with_pc:
            pcg = hdr.create_group("Pattern Center Calibration")
            pcg["x-star"] = np.array([0.51])
            pcg["y-star"] = np.array([0.72])
            pcg["z-star"] = np.array([0.63])
        g["Data/Pattern"] = _patterns((6, 4, 5), seed=12)
        if with_xmap:
            for k in ("Phi1", "Phi", "Phi2"):
                g[f"Data/{k}"] = rng.uniform(0, 3, 6).astype(np.float32)
            g["Data/CI"] = rng.random(6).astype(np.float32)
            g["Data/IQ"] = rng.random(6).astype(np.float32)
            g["Data/Phase"] = np.ones(6, np.int32)
            ph = hdr.create_group("Phase/1")
            ph["MaterialName"] = np.array([b"Nickel"])
    return path


@pytest.mark.parametrize("with_xmap,with_pc", [(True, True), (False, False)])
def test_edax_h5ebsd_matches_jax(tmp_path, with_xmap, with_pc):
    j, t = _load(_edax_h5(tmp_path / "edax.h5", with_xmap, with_pc))
    _same_scan(j, t)


def _h5oina(path, processed=True):
    with h5py.File(path, "w") as h:
        h["Format Version"] = np.array([b"5.0"])
        g = h.create_group("1/EBSD")
        hdr = g.create_group("Header")
        hdr["Y Cells"] = np.array([3])
        hdr["X Cells"] = np.array([2])
        hdr["Pattern Height"] = np.array([4])
        hdr["Pattern Width"] = np.array([3])
        hdr["X Step"] = np.array([0.5])
        hdr["Y Step"] = np.array([0.75])
        hdr["Tilt Angle"] = np.array([np.deg2rad(3.0)])
        hdr["Beam Voltage"] = np.array([20.0])
        hdr["Magnification"] = np.array([1000.0])
        hdr["Processed Static Background"] = _patterns((4, 3), seed=13)
        g["Data/Processed Patterns"] = _patterns((6, 4, 3), seed=14)
        g["Data/Unprocessed Patterns"] = _patterns((6, 4, 3), np.uint16, seed=15)
        rng = np.random.default_rng(16)
        g["Data/Pattern Center X"] = rng.uniform(0.4, 0.6, 6)
        g["Data/Pattern Center Y"] = rng.uniform(0.4, 0.6, 6)
        g["Data/Detector Distance"] = rng.uniform(0.5, 0.7, 6)
    return path


@pytest.mark.parametrize("processed", [True, False])
def test_oxford_h5ebsd_matches_jax(tmp_path, processed):
    j, t = _load(_h5oina(tmp_path / "scan.h5oina"), processed=processed)
    _same_scan(j, t)


def _emsoft_ebsd(path):
    rng = np.random.default_rng(17)
    with h5py.File(path, "w") as h:
        h["EMData/EBSD/EBSDPatterns"] = _patterns((6, 7, 8), seed=18)
        h["EMData/EBSD/EulerAngles"] = rng.uniform(0, 3, (6, 3)).astype(np.float32)
        h["EMData/EBSD/xtalname"] = np.array([b"ni.xtal"])
        h["EMheader/EBSD/ProgramName"] = np.array([b"EMEBSD.f90"])
        nml = h.create_group("NMLparameters/EBSDNameList")
        for k, v in (("binning", 2), ("delta", 50.5), ("xpc", 1.5), ("ypc", -2.0), ("L", 15000.0),
                     ("thetac", 10.0), ("sig", 70.0)):
            nml[k] = np.array([v])
        cd = h.create_group("CrystalData")
        cd["SpaceGroupNumber"] = np.array([225])
        cd["LatticeParameters"] = np.array([0.352, 0.352, 0.352, 90.0, 90.0, 90.0])
    return path


@pytest.mark.parametrize("scan_size", [None, 6, (2, 3)])
def test_emsoft_ebsd_matches_jax(tmp_path, scan_size):
    j, t = _load(_emsoft_ebsd(tmp_path / "sim.h5"), scan_size=scan_size)
    _same_scan(j, t)
    assert (t.xmap.phases[0].name, t.xmap.phases[0].space_group) == ("ni", 225)
    np.testing.assert_allclose(t.xmap.phases[0].lattice, j.xmap.phases[0].lattice, **TOL)


def _emsoft_master(path, group="EBSDmaster", energies=(10.0, 15.0, 20.0), numset=1, side=21, dtype=np.float32):
    rng = np.random.default_rng(19)
    ne = len(energies)
    with h5py.File(path, "w") as h:
        g = h.create_group(f"EMData/{group}")
        g["EkeVs" if group != "ECPmaster" else "EkeV"] = np.array(energies)
        g["mLPNH"] = rng.integers(0, 255, (numset, ne, side, side)).astype(dtype)
        g["mLPSH"] = rng.integers(0, 255, (numset, ne, side, side)).astype(dtype)
        g["masterSPNH"] = rng.integers(0, 255, (ne, side, side)).astype(dtype)
        g["masterSPSH"] = rng.integers(0, 255, (ne, side, side)).astype(dtype)
        g["xtalname"] = np.array([b"ni.xtal"])
        cd = h.create_group("CrystalData")
        cd["SpaceGroupNumber"] = np.array([225])
        cd["LatticeParameters"] = np.array([0.352, 0.352, 0.352, 90.0, 90.0, 90.0])
        cd["AtomData"] = np.array([[0.0, 0.5], [0.0, 0.5], [0.0, 0.0], [1.0, 1.0], [0.005, 0.005]])
        cd["Atomtypes"] = np.array([28, 28])
    return path


@pytest.mark.parametrize("kw", [
    {},
    {"projection": "lambert", "hemisphere": "both"},
    {"projection": "lambert", "hemisphere": "lower", "energy": 15},
    {"projection": "stereographic", "hemisphere": "both", "energy": (12, 25)},
])
@pytest.mark.parametrize("numset", [1, 2])
def test_emsoft_ebsd_master_pattern_matches_jax(tmp_path, kw, numset):
    j, t = _load(_emsoft_master(tmp_path / "mp.h5", numset=numset), **kw)
    _same_master(j, t)


def test_emsoft_master_pattern_errors_match_jax(tmp_path):
    p = _emsoft_master(tmp_path / "mp.h5")
    for bad in ({"projection": "gnomonic"}, {"hemisphere": "east"}):
        with pytest.raises(ValueError):
            kp.load(p, **bad)
        with pytest.raises(ValueError):
            kt.load(p, device="cpu", **bad)


@pytest.mark.parametrize("group,kw", [
    ("ECPmaster", {"projection": "lambert", "hemisphere": "both"}),
    ("ECPmaster", {}),
    ("TKDmaster", {"projection": "lambert", "hemisphere": "both", "energy": 20}),
    ("TKDmaster", {"hemisphere": "upper"}),
])
def test_emsoft_ecp_and_tkd_master_patterns_match_jax(tmp_path, group, kw):
    energies = (20.0,) if group == "ECPmaster" else (10.0, 20.0)
    j, t = _load(_emsoft_master(tmp_path / "mp.h5", group=group, energies=energies, side=15), **kw)
    _same_master(j, t)


# ------------------------------ NORDIF ------------------------------ #


def _setting_txt(path, ny, nx, sy, sx, pattern_type="Acquisition", calibration=()):
    lines = [
        "[NORDIF]", "Software version\t3.1.2\t",
        "[Microscope]", "Manufacturer\tHitachi\t", "Model\tSU-6600\t", "Magnification\t200\t#",
        "Scan direction\tDirect\t", "Accelerating voltage\t20\tkV", "Working distance\t24.7\tmm",
        "Tilt angle\t70\t°",
        "[Detector angles]", "Euler 1\t0\t°", "Euler 2\t0\t°", "Euler 3\t0\t°", "Azimuthal\t1.5\t°",
        "Elevation\t-3.25\t°",
        f"[{pattern_type} settings]", "Frame rate\t202\tfps", f"Resolution\t{sx}x{sy}\tpx",
        "[Area]", "Top\t0\t#", "Left\t0\t#", "Width\t1\t#", "Height\t1\t#", "Step size\t1.5\tµm",
        f"Number of samples\t{ny}x{nx}\t#",
    ]
    if calibration:
        lines.append("[Calibration patterns]")
        lines += [f"Calibration ({x},{y})\t\t" for x, y in calibration]
        lines.append("[Other]")
    path.write_text("\n".join(lines) + "\n", encoding="latin-1")
    return path


def _nordif_folder(folder, ny=3, nx=4, sy=6, sx=5, background=True, extra=0):
    folder.mkdir(parents=True, exist_ok=True)
    _setting_txt(folder / "Setting.txt", ny, nx, sy, sx)
    data = _patterns((ny, nx, sy, sx), seed=20)
    with open(folder / "Pattern.dat", "wb") as f:
        f.write(data.tobytes() + bytes(extra))
    if background:
        Image.fromarray(_patterns((sy, sx), seed=21), mode="L").save(folder / "Background acquisition pattern.bmp")
    return folder / "Pattern.dat", data


@pytest.mark.parametrize("background", [True, False])
def test_nordif_reader_matches_jax(tmp_path, background):
    path, _ = _nordif_folder(tmp_path, background=background)
    with pytest.warns() if not background else _no_warning():
        j, t = _load(path)
    _same_scan(j, t)
    assert t.metadata["microscope"] == "Hitachi SU-6600" and t.detector.tilt == 3.25


class _no_warning:
    def __enter__(self):
        import warnings

        self._w = warnings.catch_warnings()
        self._w.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        self._w.__exit__(*exc)


@pytest.mark.parametrize("extra", [7, -13])
def test_nordif_reader_of_a_file_of_another_size_matches_jax(tmp_path, extra):
    path, data = _nordif_folder(tmp_path, extra=max(extra, 0))
    if extra < 0:
        path.write_bytes(path.read_bytes()[:extra])
    with pytest.warns(UserWarning, match="larger than file size"):
        j = kp.load(path)
    with pytest.warns(UserWarning, match="larger than file size"):
        t = kt.load(path, device="cpu")
    _same_scan(j, t)


def test_nordif_reader_without_settings(tmp_path):
    p = tmp_path / "naked.dat"
    data = _patterns((2, 3, 4, 5), seed=22)
    data.tofile(p)
    for load in (kp.load, lambda *a, **k: kt.load(*a, device="cpu", **k)):
        with pytest.raises(ValueError, match="No setting file"):
            load(p)
    with pytest.warns(UserWarning, match="static background"):
        j = kp.load(p, scan_size=(3, 2), pattern_size=(5, 4))
    with pytest.warns(UserWarning, match="static background"):
        t = kt.load(p, scan_size=(3, 2), pattern_size=(5, 4), device="cpu")
    _same_scan(j, t)
    np.testing.assert_array_equal(t.data.numpy(), data)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_nordif_writers_cross_the_packages(tmp_path, writer, dtype):
    src, data = _nordif_folder(tmp_path / "src")
    j0, t0 = _load(src)
    if dtype != np.uint8:
        j0, t0 = j0.change_dtype(dtype), t0.change_dtype(dtype)
    out = tmp_path / "out" / "Pattern.dat"
    out.parent.mkdir()
    (j0 if writer == "jax" else t0).save(out)
    kw = dict(setting_file=tmp_path / "src" / "Setting.txt")
    j, t = _load(out, **kw)
    _same_scan(j, t)
    if dtype == np.uint8:
        np.testing.assert_array_equal(t.data.numpy(), data)
    assert (out.parent / "Background acquisition pattern.bmp").is_file()
    # The other package's writer gives the same bytes.
    other = tmp_path / "other" / "Pattern.dat"
    other.parent.mkdir()
    (t0 if writer == "jax" else j0).save(other)
    assert other.read_bytes() == out.read_bytes()
    assert ((other.parent / "Background acquisition pattern.bmp").read_bytes()
            == (out.parent / "Background acquisition pattern.bmp").read_bytes())


def test_nordif_writer_without_background_needs_no_pil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    data = _patterns((2, 3, 4, 5), seed=23)
    p = tmp_path / "Pattern.dat"
    kt.EBSD(data, device="cpu").save(p)
    assert p.read_bytes() == data.tobytes()


def test_nordif_calibration_patterns_match_jax(tmp_path):
    from kikuchipy_tpu.io.plugins.nordif_calibration_patterns import file_reader as j_reader

    from kikuchipy_tpu_torch.io.plugins.nordif_calibration_patterns import file_reader as t_reader

    coords = [(3, 7), (10, 2), (5, 5)]
    p = _setting_txt(tmp_path / "Setting.txt", 9, 9, 6, 5, pattern_type="Calibration", calibration=coords)
    for i, (x, y) in enumerate(coords[:2]):
        Image.fromarray(_patterns((6, 5), seed=30 + i), mode="L").save(tmp_path / f"Calibration ({x},{y}).bmp")
    with pytest.warns(UserWarning, match="calibration pattern"):
        j = j_reader(p)
    with pytest.warns(UserWarning, match="calibration pattern"):
        t = t_reader(p, device="cpu")
    _same_scan(j, t)
    assert t.data.shape == (2, 6, 5)


# ------------------------------ EDAX binary ------------------------------ #


def _up(path, version, dtype, nav=(3, 4), sig=(5, 6), hexagonal=False):
    data = _patterns(nav + sig, dtype, seed=40)
    ny, nx = nav
    sy, sx = sig
    with open(path, "wb") as f:
        if version == 1:
            np.array([1, sx, sy, 16], np.uint32).tofile(f)
        else:
            offset = 16 + 1 + 8 + 1 + 16
            np.array([version, sx, sy, offset], np.uint32).tofile(f)
            f.write(b"\x00")
            np.array([nx, ny], np.uint32).tofile(f)
            np.array([int(hexagonal)], np.uint8).tofile(f)
            np.array([0.25, 0.5], np.float64).tofile(f)
        data.tofile(f)
    return path, data


@pytest.mark.parametrize("ext,dtype", [("up1", np.uint8), ("up2", np.uint16)])
@pytest.mark.parametrize("version,hexagonal", [(1, False), (3, False), (4, True)])
def test_edax_binary_matches_jax(tmp_path, ext, dtype, version, hexagonal):
    path, data = _up(tmp_path / f"scan.{ext}", version, dtype, hexagonal=hexagonal)
    if hexagonal:
        with pytest.warns(UserWarning, match="hexagonal"):
            j = kp.load(path)
        with pytest.warns(UserWarning, match="hexagonal"):
            t = kt.load(path, device="cpu")
    else:
        j, t = _load(path)
    _same_scan(j, t)
    np.testing.assert_array_equal(t.data.numpy().reshape(-1), data.reshape(-1))


def test_edax_binary_version_2_raises_as_jax(tmp_path):
    path, _ = _up(tmp_path / "scan.up1", 3, np.uint8)
    raw = bytearray(path.read_bytes())
    raw[:4] = np.array([2], np.uint32).tobytes()
    path.write_bytes(bytes(raw))
    for load in (kp.load, lambda p: kt.load(p, device="cpu")):
        with pytest.raises(ValueError, match="version"):
            load(path)


# ----------------------------- Oxford binary ----------------------------- #


def _write_dummy_ebsp(path, nav_shape=(2, 3), sig_shape=(60, 60), dtype=np.uint8, version=2, all_present=True):
    """tests/test_io.py's dummy .ebsp writer (kikuchipy's conftest): the
    version (negated, absent in v0), the byte-position table rolled by one
    (zero marks a missing pattern), the records rolled by -1."""
    nr, nc = nav_shape
    sr, sc = sig_shape
    n_patterns = nr * nc
    n_pixels = sr * sc
    n_bytes = n_pixels * np.dtype(dtype).itemsize
    footer = 0 if version == 0 else (16 if version == 1 else 18)
    with open(path, "wb") as f:
        if version > 0:
            np.array(-version, dtype=np.int64).tofile(f)
        starts = np.arange(n_patterns, dtype=np.int64) * (16 + n_bytes + footer) + n_patterns * 8
        if version in (1, 2, 3):
            starts += 8
        elif version > 3:
            np.array(0, dtype=np.uint8).tofile(f)
            starts += 9
        starts = np.roll(starts, shift=1)
        if not all_present:
            starts[0] = 0
        starts.tofile(f)
        order = np.roll(np.arange(n_patterns), shift=-1)
        if not all_present:
            order = order[1:]
        header = np.array([0, sr, sc, n_bytes], dtype=np.int32)
        data = np.arange(n_patterns * n_pixels, dtype=dtype).reshape((nr, nc, sr, sc))
        for i in order:
            r, c = np.unravel_index(i, (nr, nc))
            header.tofile(f)
            data[r, c].tofile(f)
            if version > 1:
                np.array(1, dtype=bool).tofile(f)
            if version > 0:
                np.array(c, dtype=np.float64).tofile(f)
            if version > 1:
                np.array(1, dtype=bool).tofile(f)
            if version > 0:
                np.array(r, dtype=np.float64).tofile(f)
    return data


def _ebsp_v5(path, seed=42):
    """tests/test_io.py's version-5 file: map_x/map_y header fields, one
    byte before the position table, the records out of map order."""
    rng = np.random.default_rng(seed)
    ny, nx, sy, sx = 3, 3, 60, 60
    n = ny * nx
    patterns = rng.integers(0, 255, (n, sy, sx), dtype=np.uint8)
    stored_order = [0, 4, 2, 8, 1, 7, 3, 5, 6]
    bytes_per = 6 * 4 + sy * sx + 1 + 8 + 1 + 8
    first_pos = 9 + n * 8
    starts = np.zeros(n, np.int64)
    for slot, map_idx in enumerate(stored_order):
        starts[map_idx] = first_pos + slot * bytes_per
    with open(path, "wb") as fh:
        fh.write(struct.pack("<q", -5))
        fh.write(b"\x00")
        starts.tofile(fh)
        for map_idx in stored_order:
            my, mx = divmod(map_idx, nx)
            np.array([mx, my, 0, sy, sx, sy * sx], np.int32).tofile(fh)
            patterns[map_idx].tofile(fh)
            fh.write(struct.pack("<?", True))
            fh.write(struct.pack("<d", mx * 2.0))
            fh.write(struct.pack("<?", True))
            fh.write(struct.pack("<d", my * 2.0))
    return patterns.reshape(ny, nx, sy, sx)


@pytest.mark.parametrize("version,dtype", [(0, np.uint8), (1, np.uint16), (2, np.uint8), (3, np.uint16),
                                           (4, np.uint8)])
def test_oxford_binary_versions_match_jax(tmp_path, version, dtype):
    p = tmp_path / "dummy.ebsp"
    data = _write_dummy_ebsp(p, version=version, dtype=dtype)
    j, t = _load(p)
    _same_scan(j, t)
    if version > 0:
        np.testing.assert_array_equal(t.data.numpy(), data)


def test_oxford_binary_version_5_out_of_order_matches_jax(tmp_path):
    p = tmp_path / "v5.ebsp"
    expected = _ebsp_v5(p)
    j, t = _load(p)
    _same_scan(j, t)
    np.testing.assert_array_equal(t.data.numpy(), expected)
    assert t.metadata["version"] == 5 and t.metadata["step_x"] == 2.0


def test_oxford_binary_missing_patterns_match_jax(tmp_path):
    p = tmp_path / "dummy.ebsp"
    _write_dummy_ebsp(p, version=2, all_present=False)
    j, t = _load(p)
    _same_scan(j, t)
    assert t.navigation_shape == (5,)


@pytest.mark.parametrize("nav_shape,sig_shape", [((2, 3), (60, 60)), ((3, 4), (62, 73))])
def test_oxford_binary_pattern_count_matches_jax(tmp_path, nav_shape, sig_shape):
    p = tmp_path / "dummy.ebsp"
    _write_dummy_ebsp(p, nav_shape=nav_shape, sig_shape=sig_shape)
    readers = JReader(p), TReader(p)
    try:
        assert readers[0].n_patterns == readers[1].n_patterns == int(np.prod(nav_shape))
    finally:
        for r in readers:
            r.close()


# ---------------------------- image directory ---------------------------- #


def test_ebsd_directory_grid_matches_jax(tmp_path):
    data = _patterns((3, 4, 5, 6), seed=50)
    for y in range(3):
        for x in range(4):
            Image.fromarray(data[y, x]).save(tmp_path / f"pattern_x{x}y{y}.tif")
    j, t = _load(tmp_path)
    _same_scan(j, t)
    np.testing.assert_array_equal(t.data.numpy(), data)


@pytest.mark.parametrize("names", [[f"pat{i:03d}.png" for i in range(5)], ["a_x0y0.bmp", "a_x3y1.bmp"]])
def test_ebsd_directory_flat_matches_jax(tmp_path, names):
    for i, name in enumerate(names):
        Image.fromarray(_patterns((5, 6), seed=60 + i)).save(tmp_path / name)
    with pytest.warns(UserWarning, match="one navigation dimension"):
        j = kp.load(tmp_path)
    with pytest.warns(UserWarning, match="one navigation dimension"):
        t = kt.load(tmp_path, device="cpu")
    _same_scan(j, t)


# ------------------------------ .ang writer ------------------------------ #


@pytest.mark.parametrize("shape", [(3, 4), (12,)])
def test_ang_writer_matches_jax(tmp_path, shape):
    from kikuchipy_tpu.crystallography.crystal_map import CrystalMap, Phase, PhaseList

    n = int(np.prod(shape))
    rng = np.random.default_rng(70)
    rot = _rotations(n, 71)
    scores = rng.random((n, 3))
    phase_id = rng.integers(0, 2, n)
    phases = {0: ("ni", 225, (3.52, 3.52, 3.52, 90, 90, 90)), 1: ("al", None, None)}
    j = CrystalMap(rotations=rot, shape=shape, phase_id=phase_id, prop={"scores": scores, "iq": rng.random(n)},
                   phases=PhaseList({i: Phase(name=a, space_group=b, lattice=c) for i, (a, b, c) in phases.items()}))
    t = interop.crystal_map_from_state(rot, shape=shape, phase_id=phase_id, prop={"scores": scores, "iq": j.prop["iq"]})
    t.phases = j.phases
    kw = dict(iq_prop="iq", ci_prop="scores", step_sizes=(0.5, 1.5))
    j_ang.file_writer(tmp_path / "j.ang", j, **kw)
    t_ang.file_writer(tmp_path / "t.ang", t, **kw)
    assert (tmp_path / "t.ang").read_text() == (tmp_path / "j.ang").read_text()


# ------------------------ machines without extras ------------------------ #


def test_binary_formats_and_lazy_load_without_h5py_pil_matplotlib_dask(tmp_path):
    dat, dat_data = _nordif_folder(tmp_path / "nordif", background=False)
    up1, up1_data = _up(tmp_path / "scan.up1", 1, np.uint8)
    ebsp = tmp_path / "v5.ebsp"
    ebsp_data = _ebsp_v5(ebsp)
    np.save(tmp_path / "dat.npy", dat_data)
    code = textwrap.dedent(f"""
        import sys, warnings
        for name in ("h5py", "PIL", "PIL.Image", "matplotlib", "matplotlib.pyplot", "dask", "dask.array"):
            sys.modules[name] = None
        import numpy as np
        import kikuchipy_tpu_torch as kt
        from kikuchipy_tpu_torch.signals.lazy import LazyEBSD
        warnings.simplefilter("ignore")
        want = np.load({str(tmp_path / "dat.npy")!r})
        s = kt.load({str(dat)!r}, device="cpu")
        assert np.array_equal(s.data.numpy(), want)
        lazy = kt.load({str(dat)!r}, lazy=True, device="cpu", )
        assert isinstance(lazy, LazyEBSD)
        chain = lazy.rescale_intensity(dtype_out=np.float32).compute()
        assert np.array_equal(chain.data.numpy(), s.rescale_intensity(dtype_out=np.float32).data.numpy())
        u = kt.load({str(up1)!r}, device="cpu")
        assert u.data.numpy().tobytes() == {up1_data.tobytes()!r}
        assert kt.load({str(up1)!r}, lazy=True, device="cpu").compute().data.numpy().tobytes() == u.data.numpy().tobytes()
        assert kt.load({str(ebsp)!r}, device="cpu").data.shape == (3, 3, 60, 60)
        s.save({str(tmp_path / "copy" / "Pattern.dat")!r})
        bad = [m for m in ("h5py", "PIL", "matplotlib", "dask", "jax", "kikuchipy_tpu")
               if sys.modules.get(m) is not None]
        assert not bad, bad
        print("ok")
    """)
    (tmp_path / "copy").mkdir()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stdout + out.stderr
    assert (tmp_path / "copy" / "Pattern.dat").read_bytes() == dat_data.tobytes()
