"""Hough indexing of the port against the JAX package on the same seeded
inputs, on the CPU (where kernel H's wrapper takes its plain version).

Tolerances, from the arithmetic:

- the Radon operators are the same NumPy code: bit for bit;
- the enhanced Radon space is a float32 product (or a 9 x 9 correlation)
  summed in another order than XLA's: within 1e-5 of its range; the peak
  bins equal wherever the ``n_bands``-th score beats the next by more than
  that; refined rho and theta within 1e-4 bins and widths within 1e-3 bins
  (a parabola and a linear interpolation through those values), each plus
  what its parabola or interpolation makes of the range tolerance where the
  response is flat (``_refine_tolerances``);
- band normals are the same NumPy float64 code: equal;
- the vote scores the same candidates in float32: ``n_in`` equal, R within
  1e-5 where the best score beats the runner-up by more than 1e-4 (else a
  candidate within that gap of the best; a score is ``n_in - err / 10``,
  and ``err`` moves as below, so two scores by up to 1e-4), ``err`` within
  1e-6 rad plus the
  float32 floor of an arccos near 1: a cosine one or two float32 steps
  (6e-8) off moves its arccos by up to sqrt(2 x 1.2e-7) = 5e-4 rad at a
  zero angle, and ``err`` is a mean over ``n_in`` bands: within 1e-6 +
  5e-4 / n_in;
- the Kabsch polish takes a float32 SVD (LAPACK's here, XLA's there),
  whose rotations agree within 1e-6 (R is held within 1e-5): a cosine
  moved by 1e-6 moves its arccos by up to sqrt(2e-6) = 1.4e-3 rad, so
  ``err`` after it within 1e-6 + 1.4e-3 / n_in and ``fit`` within the same
  in degrees;
- orientations are compared after scaling the float32 quaternions to unit
  length in float64 (else 2 acos |q . q| reads 0.05 degrees between a
  float32 rotation and itself): within 0.01 degrees.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kikuchipy_tpu.crystallography.crystal_map import Phase as JPhase
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu.indexing import hough as jh
from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu_torch.crystallography.crystal_map import Phase as TPhase
from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle, reduce_to_fundamental_zone
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector as TDetector
from kikuchipy_tpu_torch.indexing import hough as th
from kikuchipy_tpu_torch.ops import hough_vote as hv
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD

CPU = "cpu"
ATOMS = [("ni", 0, 0, 0), ("ni", 0.5, 0.5, 0), ("ni", 0.5, 0, 0.5), ("ni", 0, 0.5, 0.5)]
NI = dict(name="ni", space_group=225, lattice=(3.5236,) * 3 + (90.0,) * 3, atoms=ATOMS)
RANGE_TOL = 1e-5
BIN_TOL = 1e-4
WIDTH_TOL = 1e-3
ERR_TOL = 1e-6
ACOS_STEP = 5e-4
POLISH_STEP = 1.4e-3
R_TOL = 1e-5
SCORE_GAP = 1e-4
ANGLE_TOL_DEG = 0.01
PC = (0.42, 0.28, 0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    # PyTorch's pool beside XLA's makes the small CPU operations slow.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def band_patterns(n, shape, seed, noise=8.0):
    """uint8 patterns of Gaussian bands through the pattern (a Hough test
    image): each a few lines at random angles and offsets, plus noise."""
    rng = np.random.default_rng(seed)
    sy, sx = shape
    yy, xx = np.mgrid[0:sy, 0:sx]
    out = np.zeros((n, sy, sx))
    for i in range(n):
        for _ in range(rng.integers(3, 7)):
            a = rng.uniform(0, np.pi)
            d = (xx - (sx - 1) / 2) * np.cos(a) + (yy - (sy - 1) / 2) * np.sin(a) - rng.uniform(-0.3, 0.3) * sx
            out[i] += rng.uniform(40, 90) * np.exp(-0.5 * (d / rng.uniform(1.0, 2.5)) ** 2)
    out += rng.normal(scale=noise, size=out.shape) + 40
    return np.clip(out, 0, 255).astype(np.uint8)


def master_pattern(side=151):
    """Packed Lambert hemispheres of Gaussian bands over nickel's {111},
    {200}, {220} and {311} planes (the families ``min_dspacing=1`` keeps)."""
    import itertools

    from kikuchipy_tpu_torch.geometry.lambert import lambert_to_vector

    lin = np.linspace(-1, 1, side)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    v = lambert_to_vector(torch.as_tensor(np.stack([xx, yy], axis=-1))).numpy()
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    hemis = []
    for zsign in (1.0, -1.0):
        w = v * np.array([1.0, 1.0, zsign])
        img = np.zeros(w.shape[:-1])
        for hkl, weight in (((1, 1, 1), 1.0), ((2, 0, 0), 0.8), ((2, 2, 0), 0.5), ((3, 1, 1), 0.35)):
            sigma = 2 * np.arcsin(0.0859 / (2 * 3.52 / np.sqrt(np.sum(np.square(hkl)))))
            normals = {tuple(np.array(p) * s) for p in itertools.permutations(hkl)
                       for s in itertools.product((1, -1), repeat=3)}
            normals = {max(n, tuple(-c for c in n)) for n in normals}
            for n in normals:
                n = np.array(n, float) / np.linalg.norm(n)
                img += weight * np.exp(-0.5 * (w @ n / sigma) ** 2)
        hemis.append(img)
    return np.stack(hemis).astype(np.float32)


@pytest.fixture(scope="module")
def simulated():
    """16 uint8 40 x 40 patterns of the synthetic nickel master at known
    orientations, and the orientations."""
    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci

    mp = kt.EBSDMasterPattern(master_pattern(), phase=TPhase(name="ni", point_group="m-3m"), device=CPU)
    det = TDetector(shape=(40, 40), pc=PC, sample_tilt=70)
    truth = reduce_to_fundamental_zone(super_fibonacci(16 * 7)[::7][:16], "m-3m", device=CPU)
    return mp.get_patterns(truth, det, dtype_out=np.uint8).data.numpy(), truth


def unit64(q):
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def gap_deg(q1, q2):
    return np.degrees(disorientation_angle(unit64(q1), unit64(q2), "m-3m", device=CPU))


# ------------------------------ detection ------------------------------ #


@pytest.mark.parametrize("shape, n_theta, n_rho", [((32, 32), 60, 32), ((24, 24), 30, 32), ((40, 44), 60, 48),
                                                   ((31, 27), 45, 40)])
def test_operators_are_jax_bit_for_bit(shape, n_theta, n_rho):
    a = th._radon_matrix(*shape, n_theta, n_rho)
    assert a.dtype == np.float32 and np.array_equal(a, jh._radon_matrix(*shape, n_theta, n_rho))
    b = th._radon_butterfly_matrix(*shape, n_theta, n_rho)
    assert b.dtype == np.float32 and np.array_equal(b, jh._radon_butterfly_matrix(*shape, n_theta, n_rho))


def test_default_radon_operator_is_jax_bit_for_bit():
    assert np.array_equal(th._radon_matrix(60, 60, 180, 96), jh._radon_matrix(60, 60, 180, 96))


def _close_in_range(got, want, tol=RANGE_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    finite = want[np.isfinite(want)]
    span = float(finite.max() - finite.min()) if finite.size else 1.0
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * (span or 1.0))


def _clear(deeper, span):
    """Patterns whose top ``n_bands + 1`` peak scores (``deeper``) are each
    apart by more than the range tolerance; runs of ``-inf`` (no peak) are
    in index order in both packages."""
    d = deeper[:, :-1] - deeper[:, 1:]
    d = np.where(np.isneginf(deeper[:, :-1]) & np.isneginf(deeper[:, 1:]), np.inf, d)
    return (d > RANGE_TOL * span).all(axis=1)


def _refine_tolerances(enhanced, rho_idx, theta_idx):
    """Per-peak tolerances of the refined rho, theta and width: BIN_TOL and
    WIDTH_TOL plus how far each moves when the enhanced values it reads move
    by the range tolerance (a parabola's vertex moves by df (1 / |d| +
    2 |f- - f+| / d^2) for d = f- - 2 f0 + f+; an interpolated crossing by
    df (2 / |f1 - f0| + |h - f0| / (f1 - f0)^2)), read from JAX's enhanced
    space with JAX's wrap rules."""
    enh = np.asarray(enhanced, np.float64)
    b, n_rho, n_theta = enh.shape
    df = RANGE_TOL * float(enh.max() - enh.min())
    r0, t0 = np.asarray(rho_idx).reshape(b, -1), np.asarray(theta_idx).reshape(b, -1)
    bi = np.arange(b)[:, None]

    def at(dr, dt):
        t_raw = t0 + dt
        wrapped = (t_raw < 0) | (t_raw >= n_theta)
        r = np.clip(np.where(wrapped, n_rho - 1 - (r0 + dr), r0 + dr), 0, n_rho - 1)
        return enh[bi, r, t_raw % n_theta]

    def vertex(fm, f0, fp):
        d = np.abs(fm - 2 * f0 + fp)
        with np.errstate(divide="ignore", invalid="ignore"):
            sens = np.where(d > 1e-12, df * (1 / d + 2 * np.abs(fm - fp) / d**2), 0.0)
        return BIN_TOL + np.minimum(sens, 1.0)

    c = at(0, 0)
    tol_rho, tol_theta = vertex(at(-1, 0), c, at(1, 0)), vertex(at(0, -1), c, at(0, 1))
    prof = enh.transpose(0, 2, 1)[bi, t0]  # (b, k, n_rho)
    half = 0.5 * c
    rr = np.arange(n_rho)
    below = prof < half[..., None]
    tol_w = np.full(c.shape, WIDTH_TOL)
    for i in range(b):
        for k in range(c.shape[1]):
            for side, step in ((below[i, k] & (rr <= r0[i, k]), 1), (below[i, k] & (rr >= r0[i, k]), -1)):
                idx = rr[side]
                if not idx.size:
                    continue
                j = idx.max() if step == 1 else idx.min()
                f0, f1 = prof[i, k, j], prof[i, k, int(np.clip(j + step, 0, n_rho - 1))]
                if abs(f1 - f0) > 1e-12:
                    tol_w[i, k] += min(df * (2 / abs(f1 - f0) + abs(half[i, k] - f0) / (f1 - f0) ** 2), 1.0)
    return tol_rho, tol_theta, tol_w


def _check_refined(got, want, enhanced, clear, n_bands):
    """rho, theta and width (the first, second and fourth of ``got``) within
    their per-peak tolerances on clear patterns; intensity within the range
    tolerance."""
    ri, ti, _ = jh._peak_pick(jnp.asarray(enhanced), n_bands)
    tols = _refine_tolerances(enhanced, ri, ti)
    for g, w, tol in zip([got[0], got[1], got[3]], [want[0], want[1], want[3]], tols):
        g, w = np.asarray(g).reshape(-1, n_bands)[clear], np.asarray(w).reshape(-1, n_bands)[clear]
        assert (np.abs(g - w) <= tol[clear]).all(), float(np.abs(g - w).max())
    _close_in_range(np.asarray(got[2]).reshape(-1, n_bands)[clear], np.asarray(want[2]).reshape(-1, n_bands)[clear])


def _check_bands(got, want, enhanced, n_bands):
    """Peaks equal on clear patterns; refined coordinates and widths within
    their bin tolerances there; -inf and NaN where JAX has them."""
    got = [np.asarray(a) for a in got]
    want = [np.asarray(a) for a in want]
    flat = np.asarray(enhanced).reshape(len(enhanced), -1)
    span = float(flat.max() - flat.min())
    # The top n_bands + 1 peak scores: JAX's own peak picking one deeper.
    deeper = np.asarray(jh._peak_pick(jnp.asarray(enhanced), n_bands + 1)[2])
    clear = _clear(deeper, span)
    assert clear.sum() >= len(clear) // 2
    lead = want[0].shape[:-1]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        g, w = g.reshape(-1, n_bands), w.reshape(-1, n_bands)
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    return clear, lead


@pytest.mark.parametrize("shape, n_theta, n_rho, n_bands", [((32, 32), 60, 32, 5), ((32, 32), 60, 32, 9),
                                                            ((40, 44), 60, 48, 7)])
def test_detection_matches_jax(shape, n_theta, n_rho, n_bands):
    pats = band_patterns(6, shape, seed=shape[1] + n_bands).astype(np.float32)
    pats[5] = 0.0  # blank: no peak, every score -inf
    pats = pats.reshape(2, 3, *shape)

    sino_t = th.radon_transform(pats, n_theta=n_theta, n_rho=n_rho, device=CPU)
    sino_j = np.asarray(jh.radon_transform(pats, n_theta=n_theta, n_rho=n_rho))
    assert sino_t.shape == sino_j.shape == (2, 3, n_rho, n_theta) and sino_t.dtype == torch.float32
    _close_in_range(sino_t.numpy(), sino_j)

    enh_t = th._enhance(torch.as_tensor(sino_j).reshape(-1, 1, n_rho, n_theta))
    enh_j = np.asarray(jh._enhance(jnp.asarray(sino_j).reshape(-1, 1, n_rho, n_theta)))
    _close_in_range(enh_t.numpy(), enh_j)

    # From JAX's sinograms, so only the enhancement and the pick differ.
    got = th.detect_bands(torch.as_tensor(sino_j), n_bands=n_bands)
    want = jh.detect_bands(sino_j, n_bands=n_bands)
    clear, _ = _check_bands(got, want, enh_j, n_bands)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy().reshape(-1, n_bands)[clear],
                                      np.asarray(w).reshape(-1, n_bands)[clear])
    assert np.isneginf(got[2].numpy()[1, 2]).all()

    got = th.detect_bands_refined(torch.as_tensor(sino_j), n_bands=n_bands)
    want = jh.detect_bands_refined(sino_j, n_bands=n_bands)
    clear, _ = _check_bands(got, want, enh_j, n_bands)
    _check_refined(got, want, enh_j, clear, n_bands)

    got = th.detect_bands_fused(pats, n_theta=n_theta, n_rho=n_rho, n_bands=n_bands, device=CPU)
    want = jh.detect_bands_fused(pats, n_theta=n_theta, n_rho=n_rho, n_bands=n_bands)
    enh_f = pats.reshape(6, -1) @ jh._radon_butterfly_matrix(*shape, n_theta, n_rho).T
    enh_f = enh_f.reshape(6, n_rho, n_theta)
    clear, _ = _check_bands([got[4], got[5], got[2]], [want[4], want[5], want[2]], enh_f, n_bands)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape == (2, 3, n_bands)
    for g, w in zip(got[4:], want[4:]):
        np.testing.assert_array_equal(g.numpy().reshape(-1, n_bands)[clear], np.asarray(w).reshape(-1, n_bands)[clear])
    _check_refined(got, want, enh_f, clear, n_bands)
    # The blank pattern: JAX's -inf scores, its integer bins and widths.
    blank = [a.numpy()[1, 2] for a in got]
    assert np.isneginf(blank[2]).all()
    for g, w in zip(blank, (np.asarray(a)[1, 2] for a in want)):
        np.testing.assert_array_equal(g, w)


def test_detection_at_jaxs_defaults_matches_jax(monkeypatch):
    # 60 x 60 patterns, 180 angles, 96 radii, 9 bands. The Radon transform
    # and the refined detection from its sinograms take the real operator;
    # the fused path's code at these shapes takes the plain Radon operator
    # in both packages in place of the folded one (whose build is JAX's bit
    # for bit, pinned at the smaller sizes, and takes half a minute).
    pats = band_patterns(8, (60, 60), seed=5)
    sino = th.radon_transform(pats, n_theta=180, n_rho=96, device=CPU)
    # JAX's radon_transform body outside its jit (which takes 20 s to fold
    # the 249 MB operator into the program); the jitted function is held at
    # the smaller sizes.
    w = jnp.asarray(jh._radon_matrix(60, 60, 180, 96))
    flat = jnp.asarray(pats, dtype=jnp.float32).reshape(8, -1)
    sino_j = np.asarray(jnp.matmul(flat, w.T, precision=jax.lax.Precision.HIGHEST)).reshape(8, 96, 180)
    _close_in_range(sino.numpy(), sino_j)
    enh_j = np.asarray(jh._enhance(jnp.asarray(sino_j).reshape(-1, 1, 96, 180)))
    got = th.detect_bands_refined(torch.as_tensor(sino_j))
    want = jh.detect_bands_refined(sino_j)
    clear, _ = _check_bands(got, want, enh_j, 9)
    _check_refined(got, want, enh_j, clear, 9)

    monkeypatch.setattr(jh, "_radon_butterfly_matrix", th._radon_matrix)
    monkeypatch.setattr(th, "_radon_butterfly_matrix", th._radon_matrix)
    th._device_operator.cache_clear()
    got = th.detect_bands_fused(pats, device=CPU)
    want = jh.detect_bands_fused(pats)
    th._device_operator.cache_clear()
    enh_f = sino_j.reshape(8, 96, 180)
    clear, _ = _check_bands([got[4], got[5], got[2]], [want[4], want[5], want[2]], enh_f, 9)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape == (8, 9)
    for g, w in zip(got[4:], want[4:]):
        np.testing.assert_array_equal(g.numpy()[clear], np.asarray(w)[clear])
    _check_refined(got, want, enh_f, clear, 9)


# ------------------------------ geometry ------------------------------ #


def test_bands_to_normals_are_jax():
    rng = np.random.default_rng(2)
    rho = rng.uniform(0, 95, (5, 9))
    theta = rng.uniform(0, 180, (5, 9))
    for shape, pc in (((60, 60), (0.42, 0.22, 0.5)), ((48, 64), (0.5, 0.3, 0.6))):
        tdet, jdet = TDetector(shape=shape, pc=pc, sample_tilt=70), JDetector(shape=shape, pc=pc, sample_tilt=70)
        for r, t in ((rho, theta), (np.round(rho), np.round(theta))):
            got, rho_g = th.bands_to_normals(r, t, tdet, n_theta=180, n_rho=96, return_rho_g=True)
            want, want_g = jh.bands_to_normals(r, t, jdet, n_theta=180, n_rho=96, return_rho_g=True)
            assert np.array_equal(got, want) and np.array_equal(rho_g, want_g)
            assert np.array_equal(th.bands_to_normals(r, t, tdet), jh.bands_to_normals(r, t, jdet))


def test_poles_and_lut_are_jax():
    for kw in (dict(NI), dict(NI, atoms=None), dict(NI, lattice=(0.35236,) * 3 + (90.0,) * 3)):
        got = th._poles_and_lut(TPhase(**kw), None, 1.0, 20.0)
        want = jh._poles_and_lut(JPhase(**kw), None, 1.0, 20.0)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert len(got[0]) == 25 and len(got[1]) == 300


# ------------------------------ voting ------------------------------ #


def _vote_inputs(n, n_bands, seed, parallel=0, fewer=0):
    """Normals of ``n`` patterns from rotated nickel poles with noise and
    outliers; the first ``parallel`` patterns' bands all near one direction
    (every pair at or below 0.05 rad), the next ``fewer`` with a pair whose
    angle few LUT entries match."""
    g, la, lp = th._poles_and_lut(TPhase(**NI), None, 1.0, 20.0)
    rng = np.random.default_rng(seed)
    out = np.empty((n, n_bands, 3))
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = np.asarray(jh.quat.to_matrix(jnp.asarray(q[None])))[0]
        v = g[rng.choice(len(g), n_bands, replace=False)] @ R.T + rng.normal(scale=0.006, size=(n_bands, 3))
        swap = rng.random(n_bands) < 0.25
        v[swap] = rng.normal(size=(int(swap.sum()), 3))
        out[i] = v
    out[:parallel] = out[:parallel, :1] + 1e-3 * rng.normal(size=(parallel, n_bands, 3))
    for i in range(parallel, parallel + fewer):
        # Bands 0 and 1 at 10 degrees: no pole pair of nickel lies within 2 degrees of that.
        out[i, 1] = np.cos(np.radians(10)) * out[i, 0] / np.linalg.norm(out[i, 0]) + np.sin(np.radians(10)) * (
            np.cross(out[i, 0], [0.3, 0.5, 0.8]) / np.linalg.norm(np.cross(out[i, 0], [0.3, 0.5, 0.8])))
    out /= np.linalg.norm(out, axis=-1, keepdims=True)
    return out, g, la, lp


def _err_close(err, err_j, n_in, step):
    """``err`` within ERR_TOL + step / n_in of JAX's (both inf where JAX's
    is)."""
    both_inf = np.isinf(err) & np.isinf(err_j)
    with np.errstate(invalid="ignore"):
        return both_inf | (np.abs(err - err_j) <= ERR_TOL + step / np.maximum(n_in, 1))


def _jax_vote(normals, g, la, lp, pair_idx, tol, n_pairs_max=8):
    return [np.asarray(a) for a in jh._vote_orientations(
        jnp.asarray(normals, jnp.float32), jnp.asarray(g, jnp.float32), jnp.asarray(la, jnp.float32),
        jnp.asarray(lp, jnp.int32), jnp.asarray(pair_idx), tol, n_pairs_max=n_pairs_max)]


def _tensors(normals, g, la, lp, pair_idx):
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    return f32(normals), f32(g), f32(la), torch.as_tensor(lp, dtype=torch.int32), torch.as_tensor(pair_idx)


@pytest.mark.parametrize("n_bands", [3, 6, 9])
@pytest.mark.parametrize("n_pairs_max", [1, 8])
def test_plain_vote_matches_jax(n_bands, n_pairs_max):
    normals, g, la, lp = _vote_inputs(24, n_bands, seed=n_bands, parallel=3, fewer=3)
    pair_idx = th._pair_index(n_bands)
    tol = float(np.deg2rad(2.0))
    R_j, err_j, nin_j = _jax_vote(normals, g, la, lp, pair_idx, tol, n_pairs_max)
    args = _tensors(normals, g, la, lp, pair_idx)
    before = hv.vote_orientations.launches
    R, err, nin = hv.vote_orientations(*args, tol, n_pairs_max=n_pairs_max)
    assert hv.vote_orientations.launches == before
    assert nin.dtype == torch.int32 and R.shape == (24, 3, 3) and err.shape == (24,)
    np.testing.assert_array_equal(nin.numpy(), nin_j)
    R_all, err_all, _, scores = hv.candidate_scores(*args, tol, n_pairs_max)
    top2 = torch.topk(scores, min(2, scores.shape[1]), dim=1).values
    clear = ((top2[:, 0] - top2[:, -1]) > SCORE_GAP).numpy() if scores.shape[1] > 1 else np.ones(24, bool)
    none_valid = (scores == -1).all(dim=1).numpy()
    assert none_valid[:3].all() and not none_valid[6:].all()
    assert _err_close(err.numpy(), err_j, nin_j, ACOS_STEP)[clear].all()
    keep = clear | none_valid
    np.testing.assert_allclose(R.numpy()[keep], R_j[keep], rtol=0, atol=R_TOL)
    # Elsewhere (symmetric equivalents score alike): JAX's R is a candidate
    # within the gap of the best.
    tied = (scores >= top2[:, :1] - SCORE_GAP).numpy()
    match = (np.abs(R_all.numpy() - R_j[:, None]).max(axis=(-2, -1)) <= R_TOL) & tied
    assert match.any(axis=1).all()


def test_vote_chunks_and_empty_input():
    normals, g, la, lp = _vote_inputs(10, 9, seed=1)
    args = _tensors(normals, g, la, lp, th._pair_index(9))
    one = hv.vote_orientations(*args, 0.035, chunk=1024)
    for chunk in (1, 3, 4):
        for a, b in zip(hv.vote_orientations(*args, 0.035, chunk=chunk), one):
            assert torch.equal(a, b)
    empty = hv.vote_orientations(args[0][:0], *args[1:], 0.035)
    assert [tuple(t.shape) for t in empty] == [(0, 3, 3), (0,), (0,)]
    with pytest.raises(ValueError, match="normals"):
        hv.vote_orientations(args[0][0], *args[1:], 0.035)
    with pytest.raises(ValueError, match="n_pairs_max"):
        hv.vote_orientations(*args, 0.035, n_pairs_max=0)


def test_vote_disagreements_passes_the_plain_vote_and_names_departures():
    # Kernel H's criterion (ops/hough_vote.vote_disagreements) on the CPU:
    # the plain vote against itself agrees; a moved R, n_in or err does not;
    # a near tie's other candidate agrees. Nickel's symmetric equivalents
    # make every voted pattern a near tie.
    normals, g, la, lp = _vote_inputs(24, 9, seed=5, parallel=3, fewer=3)
    args = _tensors(normals, g, la, lp, th._pair_index(9))
    tol = float(np.deg2rad(2.0))
    ref = hv.vote_orientations_plain(*args, tol)
    bad, stats = hv.vote_disagreements(ref, ref, *args, tol, chunk=7)
    assert bad == []
    assert stats["n"] == 24 and stats["none_valid"] == 3 and stats["near_ties"] > 0
    assert stats["clear"] + stats["near_ties"] + stats["none_valid"] + stats["boundary"] == 24
    assert stats["max_r_diff"] == stats["max_err_diff"] == 0.0 and stats["max_err_limit"] >= 1e-6
    R, err, n_in = ref
    moved = hv.vote_disagreements((R + 1e-3, err, n_in), ref, *args, tol)[0]
    assert any("R is off" in b for b in moved) and any("no candidate's" in b for b in moved)
    assert any("n_in differs" in b for b in hv.vote_disagreements((R, err, n_in + 1), ref, *args, tol)[0])
    # A near tie answered by its runner-up candidate.
    R_all, err_all, nin_all, scores = hv.candidate_scores(*args, tol)
    best = scores.amax(dim=1, keepdim=True)
    apart = (R_all - R[:, None]).abs().amax(dim=(-2, -1)) > 1e-2
    tie, j = (int(i) for i in torch.nonzero((scores >= best - 1e-7) & (best > 0) & apart)[0])
    other = [t.clone() for t in ref]
    other[0][tie], other[1][tie], other[2][tie] = R_all[tie, j], err_all[tie, j], nin_all[tie, j]
    assert not torch.equal(other[0][tie], R[tie])
    bad, stats = hv.vote_disagreements(other, ref, *args, tol)
    assert bad == [] and stats["max_r_diff"] == 0.0
    # Random poles (no symmetry) and 0.9 degrees of noise: a few clear bests,
    # whose err is held to the plain one.
    rng = np.random.default_rng(8)
    g = rng.normal(size=(12, 3))
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    lp = np.array([(a, b) for a in range(12) for b in range(a + 1, 12)])
    la = np.arccos(np.clip(np.abs(np.sum(g[lp[:, 0]] * g[lp[:, 1]], axis=1)), 0, 1))
    Rq = np.asarray(jh.quat.to_matrix(jnp.asarray(rng.normal(size=(16, 4)))))
    normals = np.einsum("nab,qb->nqa", Rq, g[:6]) + rng.normal(scale=0.015, size=(16, 6, 3))
    args = _tensors(normals / np.linalg.norm(normals, axis=-1, keepdims=True), g, la, lp, th._pair_index(6))
    ref = hv.vote_orientations_plain(*args, tol)
    bad, stats = hv.vote_disagreements(ref, ref, *args, tol)
    assert bad == [] and stats["clear"] > 0
    assert any("err is off" in b for b in hv.vote_disagreements((ref[0], ref[1] + 1e-3, ref[2]), ref, *args, tol)[0])


@pytest.mark.parametrize("n_bands", [3, 9])
def test_refit_matches_jax(n_bands):
    normals, g, la, lp = _vote_inputs(20, n_bands, seed=10 + n_bands)
    tol = float(np.deg2rad(2.0))
    R0 = _jax_vote(normals, g, la, lp, th._pair_index(n_bands), tol)[0]
    rng = np.random.default_rng(3)
    noisy = normals + rng.normal(scale=0.002, size=normals.shape)
    # Pattern 0: two bands on poles under the voted R, the rest random (a
    # rank-2 system); pattern 1: every band random (fewer than 2 inliers,
    # the voted R stays).
    noisy[0, :2] = g[[0, 5]] @ R0[0]
    noisy[0, 2:] = rng.normal(size=(n_bands - 2, 3))
    noisy[1] = rng.normal(size=(n_bands, 3))
    noisy /= np.linalg.norm(noisy, axis=-1, keepdims=True)
    R_j, err_j, nin_j = (np.asarray(a) for a in jh._refit_orientations(
        jnp.asarray(R0), jnp.asarray(noisy, jnp.float32), jnp.asarray(g, jnp.float32), tol))
    R, err, nin = th._refit_orientations(torch.as_tensor(R0), torch.as_tensor(noisy, dtype=torch.float32),
                                         torch.as_tensor(g, dtype=torch.float32), tol)
    np.testing.assert_array_equal(nin.numpy(), nin_j)
    np.testing.assert_allclose(R.numpy(), R_j, rtol=0, atol=R_TOL)
    np.testing.assert_array_equal(np.isfinite(err.numpy()), np.isfinite(err_j))
    assert _err_close(err.numpy(), err_j, nin_j, POLISH_STEP).all()
    assert nin_j[0] == 2 and nin_j[1] < 2
    assert np.array_equal(R.numpy()[1], R0[1])
    # err from JAX's own R: the arithmetic after the SVD.
    _, err_same, nin_same = th._refit_orientations(torch.as_tensor(R_j), torch.as_tensor(noisy, dtype=torch.float32),
                                                   torch.as_tensor(g, dtype=torch.float32), tol)
    _, err_same_j, nin_same_j = (np.asarray(a) for a in jh._refit_orientations(
        jnp.asarray(R_j), jnp.asarray(noisy, jnp.float32), jnp.asarray(g, jnp.float32), tol))
    np.testing.assert_array_equal(nin_same.numpy(), nin_same_j)
    assert _err_close(err_same.numpy(), err_same_j, nin_same_j, POLISH_STEP).all()


# ------------------------------ the whole call ------------------------------ #


def _jax_signal(pats, pc=PC, shape=(40, 40)):
    return JEBSD(data=pats, detector=JDetector(shape=shape, pc=pc, sample_tilt=70))


def _torch_signal(pats, pc=PC, shape=(40, 40)):
    return TEBSD(pats, detector=TDetector(shape=shape, pc=pc, sample_tilt=70), device=CPU)


HOUGH_KW = dict(n_theta=90, n_rho=48)


def _same_maps(got, want, conditioned=None):
    """The two maps agree; rotations where ``conditioned`` (default: all)."""
    np.testing.assert_array_equal(got.prop["nbands"], np.asarray(want.prop["nbands"]))
    assert got.prop["nbands"].dtype == np.int32
    keep = slice(None) if conditioned is None else conditioned
    assert gap_deg(got.rotations[keep], np.asarray(want.rotations)[keep]).max() < ANGLE_TOL_DEG
    fit, fit_j = got.prop["fit"], np.asarray(want.prop["fit"], np.float64)
    np.testing.assert_array_equal(np.isnan(fit), np.isnan(fit_j))
    nb = np.maximum(np.asarray(want.prop["nbands"]), 1)
    keep = ~np.isnan(fit_j)
    assert (np.abs(fit - fit_j)[keep] <= np.degrees(ERR_TOL + POLISH_STEP / nb)[keep]).all()
    for key in ("band_intensity", "band_width", "band_theta"):
        np.testing.assert_allclose(got.prop[key], np.asarray(want.prop[key]), rtol=0, atol=1e-5, equal_nan=True)
    assert got.shape == tuple(want.shape)


def test_hough_indexing_matches_jax_and_finds_the_orientations(simulated):
    pats, truth = simulated
    got = th.hough_indexing(_torch_signal(pats), phase_list=TPhase(**NI), **HOUGH_KW)
    want = jh.hough_indexing(_jax_signal(pats), phase_list=JPhase(**NI), **HOUGH_KW)
    _same_maps(got, want)
    assert gap_deg(truth, got.rotations).max() < 1.0 and (got.prop["nbands"] >= 3).all()
    assert got.rotations.shape == (16, 4) and set(got.prop) == set(want.prop)


def test_hough_indexing_of_a_map_and_a_blank_pattern_matches_jax(simulated):
    pats = simulated[0].copy()
    pats[5] = 0
    grid = pats.reshape(4, 4, 40, 40)
    got = TEBSD(grid, detector=TDetector(shape=(40, 40), pc=PC, sample_tilt=70), device=CPU).hough_indexing(
        phase_list=TPhase(**NI), **HOUGH_KW)
    want = JEBSD(data=grid, detector=JDetector(shape=(40, 40), pc=PC, sample_tilt=70)).hough_indexing(
        phase_list=JPhase(**NI), **HOUGH_KW)
    assert got.shape == (4, 4)
    # The blank pattern's nine -inf peaks sit at rho bin 0 and theta bins 0-8:
    # nearly parallel bands, whose rotation the Kabsch solve leaves
    # ill-conditioned (the two packages' float32 SVDs part by tens of
    # degrees); its other outputs agree.
    _same_maps(got, want, conditioned=np.arange(16) != 5)
    assert np.isneginf(got.prop["band_intensity"][5]) and np.isneginf(np.asarray(want.prop["band_intensity"])[5])


@pytest.mark.parametrize("chunk", [4, 7])
def test_chunked_voting_matches_single_batch(chunk):
    # JAX's TestVotingChunking: random patterns, chunks against one batch.
    data = np.random.default_rng(3).integers(0, 255, (9, 40, 40), dtype=np.uint8)
    s = TEBSD(data.reshape(3, 3, 40, 40), detector=TDetector(shape=(40, 40), pc=(0.5, 0.5, 0.5), sample_tilt=70),
              device=CPU)
    a = s.hough_indexing(phase_list=TPhase(**NI), chunk=chunk, **HOUGH_KW)
    b = s.hough_indexing(phase_list=TPhase(**NI), chunk=256, **HOUGH_KW)
    np.testing.assert_allclose(a.rotations, b.rotations, atol=1e-5)
    np.testing.assert_array_equal(a.prop["nbands"], b.prop["nbands"])


def test_return_forms_match_jax(simulated, capsys):
    pats = simulated[0]
    tsig, jsig = _torch_signal(pats), _jax_signal(pats)
    kw = dict(phase_list=None, chunksize=3, verbose=1, return_index_data=True, return_band_data=True, **HOUGH_KW)
    got = tsig.hough_indexing(**dict(kw, phase_list=TPhase(**NI)))
    out_t = capsys.readouterr().out
    want = jsig.hough_indexing(**dict(kw, phase_list=JPhase(**NI)))
    out_j = capsys.readouterr().out
    assert len(got) == len(want) == 3
    assert out_t.startswith("Hough indexing of 16 patterns") and out_t.split(":")[0] == out_j.split(":")[0]
    _same_maps(got[0], want[0])
    index, index_j = got[1], want[1]
    assert index.dtype == index_j.dtype and index.shape == index_j.shape == (2, 16)
    for name in ("phase", "nmatch"):
        np.testing.assert_array_equal(index[name], index_j[name])
    np.testing.assert_allclose(index["fit"], index_j["fit"], rtol=0, atol=np.degrees(POLISH_STEP), equal_nan=True)
    for name in ("cm", "pq"):
        _close_in_range(index[name], index_j[name])
    assert gap_deg(index["quat"][0], index_j["quat"][0]).max() < ANGLE_TOL_DEG
    bands, bands_j = got[2], want[2]
    assert set(bands) == set(bands_j) == {"rho", "theta", "intensity", "width"}
    for name in bands:
        assert bands[name].shape == np.asarray(bands_j[name]).shape == (16, 9)
    from kikuchipy_tpu_torch.indexing import xmap_from_hough_indexing_data

    from kikuchipy_tpu_torch.crystallography.crystal_map import PhaseList

    back = xmap_from_hough_indexing_data(index, phase_list=PhaseList(TPhase(**NI)), data_index=-1)
    np.testing.assert_allclose(np.asarray(back.rotations), got[0].best_rotations)
    # One extra at a time: the map and just that.
    assert len(tsig.hough_indexing(phase_list=TPhase(**NI), return_index_data=True, **HOUGH_KW)) == 2


def test_indexer_matches_jax_and_reaches_the_same_call(simulated):
    pats = simulated[0]
    tdet, jdet = TDetector(shape=(40, 40), pc=PC, sample_tilt=70), JDetector(shape=(40, 40), pc=PC, sample_tilt=70)
    indexer = tdet.get_indexer(TPhase(**NI), **HOUGH_KW)
    assert isinstance(indexer, th.HoughIndexer) and indexer.detector is tdet
    got = indexer.index(torch.as_tensor(pats))
    want = jdet.get_indexer(JPhase(**NI), **HOUGH_KW).index(pats)
    _same_maps(got, want)
    # Through EBSD.hough_indexing, the signal's own detector replaced.
    other = TEBSD(pats, detector=TDetector(shape=(40, 40), pc=(0.5, 0.5, 0.6)), device=CPU)
    via = other.hough_indexing(indexer=indexer)
    _same_maps(via, want)


def test_hough_indexing_requires_a_lattice(dummy_patterns):
    s = TEBSD(dummy_patterns, device=CPU)
    with pytest.raises(ValueError, match="lattice"):
        s.hough_indexing(phase_list=TPhase("x"))
    with pytest.raises(ValueError, match="lattice"):
        th.optimize_pc_batched(s, phase_list=TPhase("x"))


def test_the_signal_keeps_its_device_and_the_operator_is_kept_once():
    th._device_operator.cache_clear()
    pats = band_patterns(3, (24, 24), seed=1)
    a = th.detect_bands_fused(torch.as_tensor(pats), n_theta=30, n_rho=32)
    b = th.detect_bands_fused(torch.as_tensor(pats), n_theta=30, n_rho=32)
    assert th._device_operator.cache_info().misses == 1 and th._device_operator.cache_info().hits == 1
    assert all(x.device.type == "cpu" for x in a) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert dataclasses.is_dataclass(th.HoughIndexer)


def test_public_signatures_are_jax():
    # JAX's arguments in JAX's order; the port adds ``device`` last where an
    # array input needs one.
    import inspect

    from kikuchipy_tpu.geometry.detector import EBSDDetector as JDet

    pairs = [(getattr(th, name), getattr(jh, name)) for name in jh.__all__ if name != "HoughIndexer"]
    pairs += [(th.optimize_pc_batched, jh.optimize_pc_batched), (th._optimize_pc_from_bands, jh._optimize_pc_from_bands),
              (th._refit_orientations, jh._refit_orientations), (th._normals_at_pcs, jh._normals_at_pcs),
              (hv.vote_orientations, jh._vote_orientations), (TEBSD.hough_indexing, JEBSD.hough_indexing),
              (TEBSD.hough_indexing_optimize_pc, JEBSD.hough_indexing_optimize_pc),
              (TDetector.get_indexer, JDet.get_indexer), (th.HoughIndexer.index, jh.HoughIndexer.index)]
    for got, want in pairs:
        names = [p for p in inspect.signature(got).parameters if p not in ("device", "chunk")]
        want_names = [p for p in inspect.signature(want).parameters if p != "chunk"]
        assert names == want_names, got.__name__
        for p in want_names:
            assert inspect.signature(got).parameters[p].default == inspect.signature(want).parameters[p].default, p


# ------------------- kernel H's choices on the host ------------------- #


def test_vote_pole_routes_and_limits_are_the_sources():
    text = (Path(th.__file__).resolve().parents[1] / "csrc" / "hough_vote.cu").read_text()
    assert f"constexpr int kTile = {hv.TILE_POLES};" in text
    assert f"#define HOUGH_TILE_WARPS {hv.TILE_WARPS}" in text
    assert f"constexpr int kMinBands = {hv.MIN_BANDS};" in text and f"constexpr int kMaxBands = {hv.MAX_BANDS};" in text
    assert [hv.pole_route(n) for n in (1, 25, 1024, 1025, 3000)] == ["shared", "shared", "shared", "tiles", "tiles"]


def test_vote_block_shape_and_shared_memory(monkeypatch):
    # block_shape over a stand-in for the source's hough_vote_smem_bytes (a
    # block's groups' tables, then its pole tile); the card tests hold the
    # source's own bytes and the shapes it gives.
    def block_bytes(tables, tile):
        return lambda groups: tables * groups + tile

    assert hv.block_shape(9, 25, 15, 8, block_bytes(8000, 400)) == (hv.PATTERNS_PER_BLOCK, 1)
    monkeypatch.setattr(hv, "PATTERNS_PER_BLOCK", 8)
    assert hv.block_shape(9, 25, 15, 8, block_bytes(8000, 400)) == (8, 1)
    # Streamed tiles: a pattern a block of TILE_WARPS warps.
    assert hv.block_shape(9, 3000, 15, 8, block_bytes(8000, 16 * 1024)) == (1, hv.TILE_WARPS)
    # Fewer patterns a block where the tables pass the budget; a pattern's
    # own tables past it refuse.
    third = hv.SMEM_BUDGET // 3
    assert hv.block_shape(9, 25, 15, 80, block_bytes(third, 400)) == (2, 1)
    assert hv.block_shape(9, 25, 15, 80, block_bytes(hv.SMEM_BUDGET - 400, 400)) == (1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        hv.block_shape(9, 25, 15, 5000, block_bytes(hv.SMEM_BUDGET, 400))
    with pytest.raises(ValueError, match="shared memory"):
        hv.block_shape(9, 3000, 15, 5000, block_bytes(hv.SMEM_BUDGET, 16 * 1024))


def test_planted_twins_tie_bit_for_bit_in_the_plain_version():
    # The card test's planted ties (tests/test_torch_gpu.py
    # _symmetric_hough_inputs): on the CPU too, the two best candidates of
    # most patterns score alike bit for bit, are two rotations, and
    # argmax takes the lower index.
    from tests.test_torch_gpu import PLANTED_GAP, _symmetric_hough_inputs

    normals, g, la, lp = _symmetric_hough_inputs(48, seed=9)
    args = _tensors(normals, g, la, lp, th._pair_index(9))
    tol = float(np.deg2rad(2.0))
    R_all, _, _, scores = hv.candidate_scores(*args, tol)
    top = torch.topk(scores, 3, dim=1).values
    assert bool((top[:, 0] == top[:, 1]).all())
    planted = top[:, 1] - top[:, 2] > PLANTED_GAP
    assert int(planted.sum()) >= 6
    order = torch.argsort(-scores, dim=1, stable=True)[:, :2]
    R = hv.vote_orientations_plain(*args, tol)[0]
    first = torch.take_along_dim(R_all, order[:, :1, None, None], dim=1)[:, 0]
    second = torch.take_along_dim(R_all, order[:, 1:, None, None], dim=1)[:, 0]
    assert torch.equal(R[planted], first[planted])
    assert float((first - second).abs().amax(dim=(1, 2))[planted].min()) > 0.1
