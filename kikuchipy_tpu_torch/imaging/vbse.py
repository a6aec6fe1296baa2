"""Virtual backscatter electron (VBSE) imaging.

PyTorch counterpart of ``kikuchipy_tpu/imaging/vbse.py``: the detector is
divided into a grid of tiles; summing pattern intensities inside a tile
(or any rectangular ROI) at each beam position gives one virtual image per
tile, and three ROI selections give an RGB image. The ROI sums run in
float32 on the signal's device (all tiles in one pass for
:meth:`VirtualBSEImager.get_images_from_grid`); the images' normalization
and colors are host NumPy, as in JAX (``np.median`` averages the two middle
values and ``np.std`` has no Bessel correction, where ``torch.median`` and
``torch.std`` differ).
"""

from __future__ import annotations

import numpy as np
import torch

from kikuchipy_tpu_torch.utils.device import as_tensor, host_array, resolve_device

__all__ = ["VirtualBSEImager", "normalize_image", "get_rgb_image"]


def normalize_image(
    image: np.ndarray,
    add_bright: float = 0,
    contrast: float = 1.0,
    dtype_out=np.uint8,
) -> np.ndarray:
    """Median/std-based channel normalization with brightness/contrast,
    clipped to the dtype range (reference ``imaging/vbse.py:416-455``,
    adapted from aloe/xcdskd)."""
    dtype_out = np.dtype(dtype_out)
    dtype_max = np.iinfo(dtype_out).max
    offset = (dtype_max // 2) + add_bright
    contrast = contrast * dtype_max * 0.3125
    median = np.median(image)
    std = np.std(image)
    out = offset + (contrast * (image - median)) / std
    return np.clip(out, 0, dtype_max)


def get_rgb_image(
    channels: list[np.ndarray],
    percentiles: tuple | None = None,
    normalize: bool = True,
    alpha: np.ndarray | None = None,
    dtype_out=np.uint8,
    add_bright: float = 0,
    contrast: float = 1.0,
) -> np.ndarray:
    """Combine three channel images into an RGB image
    (reference ``imaging/vbse.py:458-520``)."""
    dtype_out = np.dtype(dtype_out)
    rgb = np.zeros(channels[0].shape + (3,), np.float32)
    for i, channel in enumerate(channels):
        if normalize:
            channel = normalize_image(
                channel.astype(np.float32),
                add_bright=add_bright,
                contrast=contrast,
                dtype_out=dtype_out,
            )
        rgb[..., i] = channel
    if alpha is not None:
        a = np.asarray(alpha, dtype=np.float32)
        a = (a - np.nanmin(a)) / (np.nanmax(a) - np.nanmin(a))
        rgb *= a[..., None]
    # The reference always min-max rescales the combined RGB stack to
    # the dtype range at the end, from the percentile range if given
    # (``imaging/vbse.py:518-522``).
    if percentiles is not None:
        lo, hi = np.percentile(rgb, q=percentiles)
    else:
        lo, hi = rgb.min(), rgb.max()
    rgb = np.clip(rgb, lo, hi)
    rgb = (rgb - lo) / (hi - lo) * np.iinfo(dtype_out).max
    return rgb.astype(dtype_out)


class VirtualBSEImager:
    """Generate virtual BSE images from an EBSD signal.

    Parameters
    ----------
    signal
        :class:`~kikuchipy_tpu_torch.signals.ebsd.EBSD` signal.
    """

    def __init__(self, signal) -> None:
        self._signal = signal
        self._grid_shape = (5, 5)

    @property
    def signal(self):
        return self._signal

    def _data(self) -> torch.Tensor:
        """The signal's patterns as a tensor on its device."""
        return as_tensor(self._signal.data, resolve_device(getattr(self._signal, "device", None)))

    @property
    def grid_shape(self) -> tuple[int, int]:
        """Detector tile grid shape (rows, cols); default (5, 5)."""
        return self._grid_shape

    @grid_shape.setter
    def grid_shape(self, shape: tuple[int, int]) -> None:
        self._grid_shape = (int(shape[0]), int(shape[1]))

    @property
    def grid_rows(self) -> np.ndarray:
        gy = self._grid_shape[0]
        sy = self._signal.signal_shape[0]
        return np.linspace(0, sy, gy + 1)[:-1]

    @property
    def grid_cols(self) -> np.ndarray:
        gx = self._grid_shape[1]
        sx = self._signal.signal_shape[1]
        return np.linspace(0, sx, gx + 1)[:-1]

    def roi_from_grid(self, index: tuple[int, int]) -> tuple[int, int, int, int]:
        """Rectangular detector ROI ``(row0, row1, col0, col1)`` for a
        tile grid index ``(row, col)``."""
        gy, gx = self._grid_shape
        sy, sx = self._signal.signal_shape
        ty, tx = sy // gy, sx // gx
        r, c = index
        return (r * ty, (r + 1) * ty, c * tx, (c + 1) * tx)

    def get_virtual_bse_intensity(self, roi) -> np.ndarray:
        """Virtual BSE image: per-pattern sum inside the ROI
        ``(row0, row1, col0, col1)`` (reference
        ``EBSD.get_virtual_bse_intensity``, ``signals/ebsd.py:1555``), in
        float32 on the signal's device, returned as a NumPy array. Sums of
        integer patterns below 2^24 are exact."""
        r0, r1, c0, c1 = roi
        data = self._data()
        return data[..., r0:r1, c0:c1].sum(dim=(-2, -1), dtype=torch.float32).cpu().numpy()

    def get_images_from_grid(self, dtype_out=np.float32) -> np.ndarray:
        """One VBSE image per grid tile, shape
        ``grid_shape + navigation_shape`` (reference
        ``imaging/vbse.py:239``): every tile's float32 sums in one pass
        over the scan on its device, cast to ``dtype_out`` as NumPy casts."""
        gy, gx = self._grid_shape
        sy, sx = self._signal.signal_shape
        ty, tx = sy // gy, sx // gx
        data = self._data()[..., : gy * ty, : gx * tx]
        nav_shape = tuple(data.shape[:-2])
        # Along the rows first (contiguous), then down the tiles' rows.
        sums = data.reshape(nav_shape + (gy, ty, gx, tx)).sum(dim=-1, dtype=torch.float32).sum(dim=-2)
        sums = sums.movedim((-2, -1), (0, 1)).cpu().numpy()
        return sums.astype(np.dtype(dtype_out))

    def get_rgb_image(
        self,
        r,
        g,
        b,
        percentiles: tuple | None = None,
        normalize: bool = True,
        alpha: np.ndarray | None = None,
        dtype_out=np.uint8,
        add_bright: float = 0,
        contrast: float = 1.0,
    ) -> np.ndarray:
        """RGB image from three grid indices / ROIs (or lists of them)
        (reference ``imaging/vbse.py:135``)."""
        channels = []
        for rois in (r, g, b):
            if isinstance(rois, tuple) and len(rois) in (2, 4) and not isinstance(
                rois[0], (tuple, list)
            ):
                rois = [rois]
            image = np.zeros(self._signal.navigation_shape, dtype=np.float64)
            for roi in rois:
                if len(roi) == 2:
                    roi = self.roi_from_grid(roi)
                image += self.get_virtual_bse_intensity(roi)
            channels.append(image)
        return get_rgb_image(
            channels,
            percentiles=percentiles,
            normalize=normalize,
            alpha=alpha,
            dtype_out=dtype_out,
            add_bright=add_bright,
            contrast=contrast,
        )

    def plot_grid(
        self,
        pattern_idx: tuple[int, ...] | None = None,
        rgb_channels: list | dict | None = None,
        visible_indices: bool = True,
        return_figure: bool = False,
    ):
        """Plot a pattern with the tile grid overlaid (reference
        ``imaging/vbse.py:320``); tiles used for R/G/B channels can be
        highlighted. ``rgb_channels`` takes the reference's ordered
        list form ``[r_tile, g_tile, b_tile]`` (each a ``(row, col)``
        tuple, a list of tuples, or None) or a ``{"r": (0, 0), ...}``
        mapping. ``visible_indices`` labels each tile with its
        (row, column) grid index (reference default True)."""
        import matplotlib.pyplot as plt

        data = self._data()
        if pattern_idx is None:
            pattern_idx = (0,) * (data.ndim - 2)
        pattern = host_array(data[pattern_idx])
        fig, ax = plt.subplots()
        ax.imshow(pattern, cmap="gray")
        gy, gx = self._grid_shape
        sy, sx = self._signal.signal_shape
        for r in self.grid_rows[1:]:
            ax.axhline(r - 0.5, color="w", lw=0.5)
        for c in self.grid_cols[1:]:
            ax.axvline(c - 0.5, color="w", lw=0.5)
        if visible_indices:
            for ti in range(gy):
                for tj in range(gx):
                    r0, _, c0, _ = self.roi_from_grid((ti, tj))
                    ax.text(
                        c0 + 1, r0 + 1, f"{ti},{tj}", color="r",
                        ha="left", va="top", fontsize=7,
                    )
        colors = {"r": "red", "g": "green", "b": "blue"}
        if isinstance(rgb_channels, dict):
            chan_tiles = list(rgb_channels.items())
        else:
            chan_tiles = []
            for chan, idx in zip("rgb", rgb_channels or []):
                if idx is None:
                    continue
                tiles = idx if isinstance(idx, list) else [idx]
                chan_tiles.extend((chan, t) for t in tiles)
        for chan, idx in chan_tiles:
            r0, r1, c0, c1 = self.roi_from_grid(idx)
            ax.add_patch(
                plt.Rectangle(
                    (c0 - 0.5, r0 - 0.5),
                    c1 - c0,
                    r1 - r0,
                    fill=False,
                    edgecolor=colors.get(chan, "y"),
                    lw=1.5,
                )
            )
        if return_figure:
            return fig
        return ax

    def __repr__(self) -> str:
        return (
            f"VirtualBSEImager(grid_shape={self._grid_shape}, "
            f"signal={self._signal!r})"
        )
