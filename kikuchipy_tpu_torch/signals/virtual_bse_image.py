"""Virtual BSE image signal (``kikuchipy_tpu/signals/virtual_bse_image.py``):
a 2D (or RGB) image array, held on the host, with the intensity operations
users chain after a virtual BSE imager, run on the device, and a plot
(``matplotlib`` imported only when it runs)."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from kikuchipy_tpu_torch.utils.device import resolve_device

__all__ = ["VirtualBSEImage"]


@dataclasses.dataclass
class VirtualBSEImage:
    """A virtual backscatter electron image.

    Attributes
    ----------
    data
        Image array ``(ny, nx)`` or ``(ny, nx, 3)`` for RGB.
    metadata
        Free-form metadata (e.g. the ROI it was integrated over).
    device
        Where the operations run; ``None`` is the card.
    """

    data: np.ndarray
    metadata: dict = dataclasses.field(default_factory=dict)
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.data = np.asarray(self.data)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    def _apply(self, fn) -> "VirtualBSEImage":
        out = fn(torch.as_tensor(self.data[None], device=self.device))[0]
        return dataclasses.replace(self, data=out.cpu().numpy())

    def rescale_intensity(self, **kwargs) -> "VirtualBSEImage":
        from kikuchipy_tpu_torch.ops import pattern as _ops

        return self._apply(lambda d: _ops.rescale_intensity(d, device=self.device, **kwargs))

    def normalize_intensity(self, **kwargs) -> "VirtualBSEImage":
        from kikuchipy_tpu_torch.ops import pattern as _ops

        return self._apply(lambda d: _ops.normalize_intensity(d, device=self.device, **kwargs))

    def adaptive_histogram_equalization(self, **kwargs) -> "VirtualBSEImage":
        from kikuchipy_tpu_torch.ops.ahe import adaptive_histogram_equalization

        return self._apply(lambda d: adaptive_histogram_equalization(d, device=self.device, **kwargs))

    def change_dtype(self, dtype) -> "VirtualBSEImage":
        """The image cast to ``dtype`` (a new signal)."""
        return dataclasses.replace(self, data=self.data.astype(np.dtype(dtype)))

    def deepcopy(self) -> "VirtualBSEImage":
        import copy

        return copy.deepcopy(self)

    def as_lazy(self) -> "VirtualBSEImage":
        """This signal: images are small and stay in memory."""
        return self

    def compute(self) -> "VirtualBSEImage":
        """This signal (its data is in memory already)."""
        return self

    def plot(self, ax=None, **imshow_kwargs):
        """Show the image; returns the matplotlib axes."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        ax.imshow(np.asarray(self.data), cmap=imshow_kwargs.pop("cmap", "gray"), **imshow_kwargs)
        ax.axis("off")
        return ax
