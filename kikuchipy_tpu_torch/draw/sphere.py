"""3D master-pattern sphere rendering (matplotlib).

A copy of ``kikuchipy_tpu/draw/sphere.py``, in place of kikuchipy's
pyvista-based ``KikuchiMasterPattern.plot_spherical``
(``signals/_kikuchi_master_pattern.py:215``): the stereographic hemisphere
images are sampled onto a latitude/longitude sphere mesh on the host and
rendered with mpl_toolkits 3D.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sample_sphere", "plot_master_pattern_sphere"]


def sample_sphere(
    upper: np.ndarray,
    lower: np.ndarray,
    n_polar: int = 181,
    n_azimuth: int = 361,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sample stereographic hemisphere images on a sphere grid.

    Parameters
    ----------
    upper, lower
        ``(npy, npx)`` stereographic projections of the upper (+z) and
        lower (-z) hemispheres, projected from the opposite pole with
        ``(X, Y) = (x, y) / (1 + |z|)`` spanning ``[-1, 1]`` (the
        master-pattern file convention; see
        ``KikuchiMasterPattern.as_lambert``).
    n_polar, n_azimuth
        Sphere mesh resolution.

    Returns
    -------
    (x, y, z, values)
        Mesh coordinates and sampled intensities, each
        ``(n_polar, n_azimuth)``.
    """
    upper = np.asarray(upper, dtype=np.float64)
    lower = np.asarray(lower, dtype=np.float64)
    npy, npx = upper.shape

    polar = np.linspace(0.0, np.pi, n_polar)
    azim = np.linspace(0.0, 2 * np.pi, n_azimuth)
    pp, aa = np.meshgrid(polar, azim, indexing="ij")
    x = np.sin(pp) * np.cos(aa)
    y = np.sin(pp) * np.sin(aa)
    z = np.cos(pp)

    denom = 1.0 + np.abs(z)
    px = (x / denom + 1) / 2 * (npx - 1)
    py = (y / denom + 1) / 2 * (npy - 1)
    x0 = np.clip(np.floor(px).astype(int), 0, npx - 2)
    y0 = np.clip(np.floor(py).astype(int), 0, npy - 2)
    fx = px - x0
    fy = py - y0

    def _bilinear(img):
        return (
            img[y0, x0] * (1 - fy) * (1 - fx)
            + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx)
            + img[y0 + 1, x0 + 1] * fy * fx
        )

    vals = np.where(z >= 0, _bilinear(upper), _bilinear(lower))
    return x, y, z, vals


def plot_master_pattern_sphere(
    upper: np.ndarray,
    lower: np.ndarray,
    style: str = "surface",
    n_polar: int = 181,
    n_azimuth: int = 361,
    cmap: str = "gray",
    ax=None,
):
    """Render the master-pattern sphere with matplotlib 3D.

    ``style``: "surface" (default) or "points" (scatter; faster for
    interactive rotation, mirroring the reference's pyvista styles).
    Returns the matplotlib figure.
    """
    import matplotlib.pyplot as plt

    if style not in ("surface", "points"):
        raise ValueError(
            f"style must be 'surface' or 'points', got {style!r}"
        )

    x, y, z, vals = sample_sphere(
        upper, lower, n_polar=n_polar, n_azimuth=n_azimuth
    )
    vmin, vmax = np.percentile(vals, [0.5, 99.5])
    norm = np.clip((vals - vmin) / max(vmax - vmin, 1e-12), 0, 1)

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    else:
        fig = ax.figure
    colormap = plt.get_cmap(cmap)
    if style == "surface":
        ax.plot_surface(
            x,
            y,
            z,
            facecolors=colormap(norm),
            rstride=1,
            cstride=1,
            linewidth=0,
            antialiased=False,
            shade=False,
        )
    else:
        ax.scatter(
            x.ravel(),
            y.ravel(),
            z.ravel(),
            c=norm.ravel(),
            cmap=cmap,
            s=1,
            linewidths=0,
        )
    ax.set_box_aspect((1, 1, 1))
    ax.set_axis_off()
    return fig
