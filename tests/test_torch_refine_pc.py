"""The PC and joint refinement modes of the port on the CPU: the direction
cosines from a candidate PC in their stated order, the Nelder-Mead wrappers
of ``kikuchipy_tpu_torch.ops.refine_nm`` against their host loops and their
refusals, the modes against the JAX package with signal masks and trust
regions (PC mode), and a dynamic-corrected scan refined by both packages.

State: a 101 x 101 band-sum master pattern, a 32 x 32 detector, a 4 x 4
scan at known orientations (the recipe of ``tests/test_torch_refinement.py``
and, for the dynamic-corrected scan, of ``tests/test_torch_slice.py``).

Tolerances: the direction cosines agree with JAX's to 1e-6 (float32 values
of unit vectors; JAX divides where the port multiplies by the float32
reciprocal, and XLA orders the 3 x 3 product its own way), and bit for bit
with a float32 numpy evaluation of the stated order (the square root
PyTorch's); on the CPU each
wrapper is its host loop bit for bit; refined PCs and scores agree with
JAX's to 1e-4, rotations to 0.05 degrees, as in
``tests/test_torch_refinement.py``.
"""

import dataclasses
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
from kikuchipy_tpu.indexing import refinement as jr
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.indexing import refinement as tr
from kikuchipy_tpu_torch.ops import lambert_project as lp
from kikuchipy_tpu_torch.ops import refine_nm as rn
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD
from kikuchipy_tpu_torch.utils.optimize import _nelder_mead_counted, nelder_mead_batched

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
PC = (0.42, 0.28, 0.5)
OFF = (0.01, -0.01, 0.01)
MAX_ITERS = 60


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The objectives are small: PyTorch's thread pool beside JAX's costs
    # more than it gives.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _master():
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.master_pattern_data(side=101)


def _angles(a, b):
    return np.degrees(disorientation_angle(np.asarray(a), np.asarray(b), "m-3m"))


@pytest.fixture(scope="module")
def state():
    master = _master()
    jdet = JDetector(shape=(32, 32), pc=PC, sample_tilt=70)
    truth = np.asarray(reduce_to_fundamental_zone(super_fibonacci(16 * 7)[::7][:16], "m-3m"))
    jmp = JMP(data=master)
    sim = np.asarray(jmp.get_patterns(truth, jdet, dtype_out=np.float32).data, dtype=np.float64)
    noisy = (sim + np.random.default_rng(5).normal(scale=0.02 * sim.std(), size=sim.shape)).astype(np.float32)
    axes = np.random.default_rng(3).normal(size=(16, 3))
    start = np.asarray(jq.multiply(jq.from_axis_angle(jnp.asarray(axes), np.deg2rad(2.0)), jnp.asarray(truth)))
    tdet = interop.detector_from_state(jdet.shape, jdet.pc, jdet.sample_tilt, jdet.tilt, jdet.px_size, jdet.binning)
    tmp = interop.master_pattern_from_state(master, point_group="m-3m", device="cpu")
    # uint8 patterns with a static background and noise, for the dynamic case.
    lo, hi = sim.min(axis=(1, 2), keepdims=True), sim.max(axis=(1, 2), keepdims=True)
    yy, xx = np.indices((32, 32))
    bg = 60 + 40 * np.exp(-((xx - 16) ** 2 + (yy - 13) ** 2) / 300)
    raw = (sim - lo) / (hi - lo) * 120 + bg + np.random.default_rng(11).normal(scale=6.0, size=sim.shape)
    return dict(
        master=master, truth=truth, start=start, scan=noisy.reshape(4, 4, 32, 32),
        raw=np.clip(raw, 0, 255).astype(np.uint8).reshape(4, 4, 32, 32), bg=bg.astype(np.uint8),
        jdet=jdet, jmp=jmp, tdet=tdet, tmp=tmp,
    )


def _om(det) -> np.ndarray:
    return np.ascontiguousarray(det.sample_to_detector.T).astype(np.float32)


# ----------------------- direction cosines from a PC ----------------------- #


def _stated_order(pc, nrows, ncols, om, idx):
    """The order ``pc_direction_cosines`` states, in float32 numpy: every
    operation correctly rounded, one at a time, but the square root, which
    is ``torch.sqrt``'s (correctly rounded on the card; on the CPU
    PyTorch's vectorized one can be an ulp off)."""
    f = np.float32
    aspect = f(ncols / nrows)
    pcx, pcy, pcz = pc[:, 0:1], pc[:, 1:2], pc[:, 2:3]
    gb0 = (pcx * -aspect) / pcz
    gb1 = ((f(1) - pcx) * aspect) / pcz
    gb2 = -(f(1) - pcy) / pcz
    gb3 = pcy / pcz
    x_scale = (gb1 - gb0) * (f(1) / f(ncols))
    y_scale = (gb3 - gb2) * (f(1) / f(nrows))
    col = (idx % ncols).astype(f)[None, :]
    row = (idx // ncols).astype(f)[None, :]
    x = ((gb0 + col * x_scale) + x_scale * f(0.5)) * pcz
    y = ((gb3 - row * y_scale) - y_scale * f(0.5)) * pcz
    z = np.broadcast_to(pcz, x.shape)
    r = [(x * om[k, 0] + y * om[k, 1]) + z * om[k, 2] for k in range(3)]
    norm = torch.sqrt(torch.from_numpy((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2])).numpy()
    return np.stack([r[k] / norm for k in range(3)], axis=-1)


@pytest.mark.parametrize("shape", [(32, 32), (24, 40)], ids=["square", "24x40"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_pc_direction_cosines_match_jax_and_their_stated_order(shape, masked):
    nrows, ncols = shape
    det = JDetector(shape=shape, pc=PC, sample_tilt=70)
    om = _om(det)
    rng = np.random.default_rng(21)
    pcs = (np.asarray(PC) + rng.normal(scale=0.02, size=(9, 3))).astype(np.float32)
    take = np.sort(rng.choice(nrows * ncols, size=nrows * ncols // 3, replace=False)) if masked else None
    ttake = None if take is None else torch.as_tensor(take)
    got = rn.pc_direction_cosines(torch.as_tensor(pcs), nrows, ncols, torch.as_tensor(om), ttake)
    assert got.dtype == torch.float32 and got.shape == (9, nrows * ncols if take is None else take.size, 3)
    if take is None:
        want = jr._dc_for_pc(jnp.asarray(pcs), nrows, ncols, jnp.asarray(om), None)
    else:
        want = jr._masked_dc_for_pc(jnp.asarray(pcs), jnp.asarray(om), jnp.asarray(take), nrows, ncols)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    idx = np.arange(nrows * ncols) if take is None else take
    np.testing.assert_array_equal(got.numpy(), _stated_order(pcs, nrows, ncols, om, idx))
    # The kernel computes only the kept pixels; JAX takes them from all:
    # per pixel the same rounding.
    every = rn.pc_direction_cosines(torch.as_tensor(pcs), nrows, ncols, torch.as_tensor(om))
    assert torch.equal(got, every if take is None else every[:, ttake])
    # refinement's _dc_for_pc keeps the boolean-mask signature of JAX's.
    keep = None
    if take is not None:
        keep = np.zeros(nrows * ncols, dtype=bool)
        keep[take] = True
    assert torch.equal(tr._dc_for_pc(torch.as_tensor(pcs), nrows, ncols, torch.as_tensor(om), keep), got)


def test_pixel_table_is_column_then_row():
    take = torch.tensor([0, 5, 31, 32, 1023])
    pix = rn.pixel_table(take, 32, 32, "cpu")
    assert pix.dtype == torch.float32 and pix.tolist() == [[0, 0], [5, 0], [31, 0], [0, 1], [31, 31]]
    assert rn.pixel_table(None, 2, 3, "cpu").tolist() == [[0, 0], [1, 0], [2, 0], [0, 1], [1, 1], [2, 1]]


# ------------------------- the wrappers on the CPU ------------------------- #


def _inputs(state, mode: str, mask: bool = False, box: bool = False):
    """(wrapper, plain host loop's objective, x0, positional arguments,
    keywords) of the PC or joint mode on the 16 points."""
    take = None
    if mask:
        keep = np.ones(1024, dtype=bool)
        keep[:160] = False
        take = torch.as_tensor(np.nonzero(keep)[0])
    exp, sq = tr._prepare_experimental(torch.as_tensor(state["scan"]).reshape(16, 32, 32), take)
    quad, npx, npy, scale = tr._master_arrays(state["tmp"], None, "cpu")
    om = torch.as_tensor(_om(state["tdet"]))
    pc0 = torch.as_tensor(np.tile(np.asarray(PC) + OFF, (16, 1)), dtype=torch.float32)
    if mode == "pc":
        q0 = torch.tensor(state["truth"], dtype=torch.float32)
        x0, args = pc0, (exp, sq, q0, quad, om, take, npx, npy, scale, 32, 32)
        kw = dict(initial_step=0.01, max_iters=MAX_ITERS, fatol=1e-4, xatol=1e-5)
        half = torch.full((3,), 0.004)
        fns = (rn.nelder_mead_projection_center, rn.pc_objective)
    else:
        euler0 = torch.tensor(np.asarray(jq.to_euler(jnp.asarray(state["start"]))), dtype=torch.float32)
        x0, args = torch.cat([euler0, pc0], dim=1), (exp, sq, quad, om, take, npx, npy, scale, 32, 32)
        kw = dict(initial_step=torch.tensor([np.deg2rad(1.0)] * 3 + [0.01] * 3, dtype=torch.float32),
                  max_iters=MAX_ITERS, fatol=1e-4, xatol=1e-5)
        half = torch.tensor([np.deg2rad(0.5)] * 3 + [0.004] * 3, dtype=torch.float32)
        fns = (rn.nelder_mead_orientation_projection_center, rn.joint_objective)
    if box:
        kw.update(lower_bounds=x0 - half, upper_bounds=x0 + half)
    return fns[0], fns[1], x0, args, kw


@pytest.mark.parametrize("mode", ["pc", "joint"])
@pytest.mark.parametrize("mask, box", [(False, False), (True, True)], ids=["plain", "mask_and_box"])
def test_pc_wrappers_on_the_cpu_are_the_host_loop(state, mode, mask, box):
    wrapper, objective, x0, args, kw = _inputs(state, mode, mask, box)
    counters = (rn.nelder_mead_projection_center, rn.nelder_mead_orientation_projection_center,
                rn.nelder_mead_orientation, lp.lambert_project_ncc)
    before = [c.launches for c in counters]
    got = wrapper(x0, *args, **kw)
    assert [c.launches for c in counters] == before
    ref = nelder_mead_batched(objective, x0, args=args, **kw)
    for name in ("x", "fun", "n_iter", "converged"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    counted = _nelder_mead_counted(objective, x0, kw.get("initial_step"), kw["max_iters"], kw["fatol"], kw["xatol"],
                                   kw.get("lower_bounds"), kw.get("upper_bounds"), args)[1]
    assert torch.equal(got.n_evals, counted)
    plain = getattr(rn, wrapper.__name__ + "_plain")(x0, *args, **kw)
    assert torch.equal(plain.x, got.x) and torch.equal(plain.fun, got.fun)
    if box:
        assert (got.x >= kw["lower_bounds"]).all() and (got.x <= kw["upper_bounds"]).all()


def _bad_pc_calls():
    # (mode, description, edit of (x0, args as a list, kw), error)
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731

    def arg(i, fn):
        def edit(x0, a, kw):
            a = list(a)
            a[i] = fn(a[i])
            return x0, a, kw
        return edit

    def x(fn):
        return lambda x0, a, kw: (fn(x0), a, kw)

    def k(**more):
        return lambda x0, a, kw: (x0, a, dict(kw, **more))

    cases = []
    for mode, d in (("pc", 3), ("joint", 6)):
        om_i = 4 if mode == "pc" else 3
        cases += [
            (mode, "float64 start", x(lambda t: t.double()), TypeError),
            (mode, "float64 rows", arg(0, lambda t: t.double()), TypeError),
            (mode, "float64 om", arg(om_i, lambda t: t.double()), TypeError),
            (mode, "float64 bounds", k(lower_bounds=torch.zeros(d, dtype=torch.float64)), TypeError),
            (mode, f"start (n, {d + 1})", x(lambda t: torch.zeros(t.shape[0], d + 1)), ValueError),
            (mode, "rows of another length", arg(0, lambda t: t[:, :-1]), ValueError),
            (mode, "norms of another length", arg(1, lambda t: t[:-1]), ValueError),
            (mode, "om (3, 4)", arg(om_i, lambda t: torch.zeros(3, 4)), ValueError),
            (mode, "a float mask", arg(om_i + 1, lambda t: torch.arange(1024.0)), ValueError),
            (mode, "a mask past the detector", arg(om_i + 1, lambda t: torch.arange(1, 1025)), ValueError),
            (mode, "quad of another master", arg(om_i - 1, lambda t: t[:-1]), ValueError),
            (mode, f"bounds ({d + 1},)", k(upper_bounds=torch.zeros(d + 1)), ValueError),
            (mode, "bounds as a list", k(upper_bounds=[0.0] * d), ValueError),
            (mode, "negative max_iters", k(max_iters=-1), ValueError),
            (mode, "no detector rows", arg(-2, lambda v: 0), ValueError),
            (mode, "rows on another device", arg(0, meta), ValueError),
            (mode, "all on an unsupported device", lambda x0, a, kw: (
                meta(x0), [meta(t) if isinstance(t, torch.Tensor) else t for t in a], kw), ValueError),
        ]
    cases += [
        ("pc", "rotations (n, 3)", arg(2, lambda t: t[:, :3]), ValueError),
        ("pc", "float64 rotations", arg(2, lambda t: t.double()), TypeError),
    ]
    return cases


@pytest.mark.parametrize("mode, what, edit, error", _bad_pc_calls(), ids=[f"{c[0]}-{c[1]}" for c in _bad_pc_calls()])
def test_pc_wrappers_reject(state, mode, what, edit, error):
    wrapper, _, x0, args, kw = _inputs(state, mode)
    x0, args, kw = edit(x0, args, dict(kw, max_iters=2))
    with pytest.raises(error):
        wrapper(x0, *args, **kw)


# ---------------------- the modes against the JAX package ---------------------- #


def test_pc_mode_with_a_signal_mask_and_trust_region_matches_jax(state):
    # (The joint mode with a mask and a box is held to its host loop above;
    # against JAX its six-parameter simplex crawls along the valley where a
    # PC shift trades against a rotation and two runs part by tenths of a
    # degree within 200 iterations: ROADMAP queue C, kept on purpose.)
    sig_mask = np.zeros((32, 32), dtype=bool)
    sig_mask[:5] = True
    jdet = dataclasses.replace(state["jdet"], pc=np.asarray(PC) + OFF)
    tdet = dataclasses.replace(state["tdet"], pc=np.asarray(PC) + OFF)
    js = JEBSD(data=state["scan"], detector=jdet)
    ts = TEBSD(data=state["scan"], detector=tdet, device="cpu")
    truth_j = JXMap(rotations=state["truth"], shape=(4, 4))
    truth_t = interop.crystal_map_from_state(state["truth"], shape=(4, 4))
    kw = dict(signal_mask=sig_mask, max_iters=MAX_ITERS)
    jres = js.refine_projection_center(xmap=truth_j, master_pattern=state["jmp"], trust_region=[0.02] * 3, **kw)
    tres = ts.refine_projection_center(xmap=truth_t, master_pattern=state["tmp"], trust_region=[0.02] * 3, **kw)
    np.testing.assert_allclose(tres.detector.pc, jres.detector.pc, atol=1e-4)
    np.testing.assert_allclose(tres.xmap.prop["scores"], jres.xmap.prop["scores"], atol=1e-4)
    assert np.abs(tres.detector.pc.reshape(-1, 3).mean(0) - PC).max() < 2e-3
    assert np.abs(tres.detector.pc.reshape(-1, 3) - (np.asarray(PC) + OFF)).max() <= 0.02 + 1e-6


def test_dynamic_corrected_scan_refines_to_jax_off_truth_optimum(state):
    # The open check of the dynamic-corrected scan: the dynamic background
    # removal (a Gaussian high-pass the simulation does not share) moves the
    # NCC optimum off the truth. JAX's Nelder-Mead reaches the same optimum
    # as the port's on the same patterns: the refined 1 - NCC, the
    # rotations and the PCs agree, and both lie below 1 - NCC at the truth.
    raw, bg = state["raw"], state["bg"]
    jpre = JEBSD(data=raw, detector=state["jdet"], static_background=bg)
    jpre = jpre.remove_static_background().remove_dynamic_background()
    tpre = TEBSD(data=raw, detector=state["tdet"], static_background=bg, device="cpu")
    tpre = tpre.remove_static_background().remove_dynamic_background()
    data = np.asarray(jpre.data)
    # Preprocessing may differ by one gray level (ROADMAP queue C); the
    # refinements below take the same patterns.
    assert np.abs(data.astype(int) - tpre.data.numpy().astype(int)).max() <= 1
    js = JEBSD(data=data, detector=state["jdet"])
    ts = TEBSD(data=data, detector=state["tdet"], device="cpu")
    jres = js.refine_orientation(xmap=JXMap(rotations=state["start"], shape=(4, 4)), master_pattern=state["jmp"])
    tres = ts.refine_orientation(xmap=interop.crystal_map_from_state(state["start"], shape=(4, 4)),
                                 master_pattern=state["tmp"])
    assert _angles(tres.xmap.best_rotations, jres.xmap.best_rotations).max() < 0.05
    np.testing.assert_allclose(tres.xmap.prop["scores"], jres.xmap.prop["scores"], atol=1e-4)

    # 1 - NCC at the truth, each package's objective on the same rows.
    exp, sq = jr._prepare_experimental(jnp.asarray(data.reshape(16, 32, 32)), None)
    master, npx, npy, scale = jr._master_arrays(state["jmp"], None)
    dc = jr.direction_cosines_from_detector(state["jdet"])
    euler = np.asarray(jq.to_euler(jnp.asarray(state["truth"]))).astype(np.float32)
    at_truth_j = np.asarray(jr._objective_orientation(jnp.asarray(euler), exp, sq, dc, master, npx, npy, scale))
    texp, tsq = tr._prepare_experimental(torch.tensor(data.reshape(16, 32, 32)), None)
    quad, *_ = tr._master_arrays(state["tmp"], None, "cpu")
    at_truth_t = tr._objective_orientation(torch.as_tensor(euler), texp, tsq, torch.tensor(np.asarray(dc)), quad,
                                           npx, npy, scale).numpy()
    np.testing.assert_allclose(at_truth_t, at_truth_j, atol=2e-6)
    refined_j, refined_t = 1 - jres.xmap.prop["scores"], 1 - tres.xmap.prop["scores"]
    print(f"1 - NCC mean: at the truth {at_truth_j.mean():.6f} (JAX) {at_truth_t.mean():.6f} (port); refined "
          f"{refined_j.mean():.6f} (JAX) {refined_t.mean():.6f} (port); refined to truth median "
          f"{np.median(_angles(state['truth'], jres.xmap.best_rotations)):.3f} deg (JAX) "
          f"{np.median(_angles(state['truth'], tres.xmap.best_rotations)):.3f} deg (port)")
    assert refined_j.mean() < at_truth_j.mean() and refined_t.mean() < at_truth_t.mean()
    assert np.median(_angles(state["truth"], tres.xmap.best_rotations)) > 0.1

    # PC mode on the same patterns from the offset PC: both stop at the
    # same PC, off the truth.
    bad = np.asarray(PC) + OFF
    jp = js.refine_projection_center(xmap=JXMap(rotations=state["truth"], shape=(4, 4)),
                                     detector=dataclasses.replace(state["jdet"], pc=bad), master_pattern=state["jmp"])
    tp = ts.refine_projection_center(xmap=interop.crystal_map_from_state(state["truth"], shape=(4, 4)),
                                     detector=dataclasses.replace(state["tdet"], pc=bad), master_pattern=state["tmp"])
    np.testing.assert_allclose(tp.detector.pc, np.asarray(jp.detector.pc), atol=1e-4)
    np.testing.assert_allclose(tp.xmap.prop["scores"], np.asarray(jp.xmap.prop["scores"]), atol=1e-4)
    print(f"PC mode: mean PC {tp.detector.pc.reshape(-1, 3).mean(0)} (port), "
          f"{np.asarray(jp.detector.pc).reshape(-1, 3).mean(0)} (JAX), truth {PC}")
