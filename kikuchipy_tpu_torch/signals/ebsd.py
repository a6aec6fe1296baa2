"""User-facing EBSD scan object.

PyTorch counterpart of ``kikuchipy_tpu/signals/ebsd.py``: a dataclass
over a pattern tensor ``(ny, nx, sy, sx)`` (or ``(n, sy, sx)``) on one
device, with the attributes the reference kikuchipy carries through
operations (``detector``, ``xmap``, ``static_background``). Ported so
far: static and dynamic (frequency-domain) background removal,
dictionary indexing and Nelder-Mead refinement of orientations and/or
projection centers; the other methods wait (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
from kikuchipy_tpu_torch.indexing.di import dictionary_index
from kikuchipy_tpu_torch.indexing.metrics import get_metric
from kikuchipy_tpu_torch.ops import pattern as _ops
from kikuchipy_tpu_torch.utils.device import as_tensor, resolve_device

__all__ = ["EBSD"]


@dataclasses.dataclass
class EBSD:
    """A scan: a navigation grid of detector patterns.

    Attributes
    ----------
    data
        Pattern tensor ``(ny, nx, sy, sx)`` or ``(n, sy, sx)``; array-like
        input is moved to ``device``.
    detector
        :class:`~kikuchipy_tpu_torch.geometry.detector.EBSDDetector`.
    static_background
        Optional ``(sy, sx)`` static background.
    xmap
        Optional :class:`~kikuchipy_tpu_torch.crystallography.crystal_map.
        CrystalMap`.
    metadata
        Free-form metadata.
    device
        Where the data lives and the operations run; ``None`` is the card.
    """

    data: Any
    detector: EBSDDetector | None = None
    static_background: np.ndarray | None = None
    xmap: CrystalMap | None = None
    metadata: dict = dataclasses.field(default_factory=dict)
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.data = as_tensor(self.data, self.device)
        if self.detector is None:
            self.detector = EBSDDetector(shape=self.signal_shape)

    @property
    def signal_shape(self) -> tuple[int, int]:
        return tuple(self.data.shape[-2:])

    @property
    def navigation_shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape[:-2])

    @property
    def navigation_size(self) -> int:
        return int(np.prod(self.navigation_shape)) if self.navigation_shape else 1

    def _replace_data(self, data) -> "EBSD":
        return dataclasses.replace(self, data=data)

    # Each operation returns a NEW EBSD; semantics in ops.pattern.

    def remove_static_background(
        self,
        operation: str = "subtract",
        static_bg: np.ndarray | None = None,
        scale_bg: bool = False,
        **kwargs,
    ) -> "EBSD":
        """Remove the static background (given, or the signal's own)."""
        if static_bg is None:
            static_bg = self.static_background
        if static_bg is None:
            raise ValueError(
                "`static_bg` is not a valid NumPy array: none was passed and "
                "the signal has no static_background attribute"
            )
        bg = static_bg if isinstance(static_bg, torch.Tensor) else np.asarray(static_bg)
        if tuple(bg.shape) != self.signal_shape:
            raise ValueError(
                f"Signal {self.signal_shape} and static background {tuple(bg.shape)} "
                "shapes are not identical"
            )
        out = _ops.remove_static_background(
            self.data, bg, operation=operation, scale_bg=scale_bg, device=self.device, **kwargs
        )
        return self._replace_data(out)

    def remove_dynamic_background(
        self,
        operation: str = "subtract",
        filter_domain: str = "frequency",
        std: float | None = None,
        truncate: float = 4.0,
        **kwargs,
    ) -> "EBSD":
        """Remove the dynamic background (frequency domain)."""
        out = _ops.remove_dynamic_background(
            self.data,
            operation=operation,
            filter_domain=filter_domain,
            std=std,
            truncate=truncate,
            device=self.device,
            **kwargs,
        )
        return self._replace_data(out)

    def dictionary_indexing(
        self,
        dictionary: "EBSD",
        metric: str = "ncc",
        keep_n: int = 20,
        n_per_iteration: int | None = None,
        signal_mask: np.ndarray | None = None,
        navigation_mask: np.ndarray | None = None,
        rechunk: bool = False,
        dtype=None,
        **kwargs,
    ) -> CrystalMap:
        """Match the patterns against a dictionary signal (one with an
        ``xmap`` of rotations) and return a crystal map of the top
        ``keep_n`` matches. Extra keyword arguments (``precision``, ...)
        pass to :func:`kikuchipy_tpu_torch.indexing.di.dictionary_index`;
        ``rechunk`` is accepted and ignored."""
        del rechunk
        if isinstance(metric, str) and dtype is not None:
            metric = dataclasses.replace(get_metric(metric), dtype=np.dtype(dtype))
        result = dictionary_index(
            self.data,
            dictionary=dictionary.data,
            keep_n=keep_n,
            n_per_iteration=n_per_iteration,
            metric=metric,
            signal_mask=signal_mask,
            navigation_mask=navigation_mask,
            device=self.device,
            **kwargs,
        )
        dict_xmap = dictionary.xmap
        if dict_xmap is None:
            raise ValueError("dictionary has no xmap with rotations")
        idx = result.simulation_indices
        safe_idx = np.where(idx < 0, 0, idx)
        rot = dict_xmap.best_rotations[safe_idx]
        if idx.shape[1] == 1:
            rot = rot[:, 0]
        phases = dict_xmap.phases if len(dict_xmap.phases) else PhaseList(Phase())
        nav_shape = self.navigation_shape
        return CrystalMap(
            rotations=rot,
            shape=nav_shape if len(nav_shape) == 2 else (self.navigation_size,),
            prop={
                "scores": result.scores,
                "simulation_indices": result.simulation_indices,
            },
            phases=phases,
            is_in_data=(
                ~np.asarray(navigation_mask).ravel() if navigation_mask is not None else None
            ),
        )

    def refine_orientation(self, *args, **kwargs):
        """:func:`kikuchipy_tpu_torch.indexing.refinement.refine_orientation`
        of this signal."""
        from kikuchipy_tpu_torch.indexing.refinement import refine_orientation

        return refine_orientation(self, *args, **kwargs)

    def refine_projection_center(self, *args, **kwargs):
        """:func:`kikuchipy_tpu_torch.indexing.refinement.
        refine_projection_center` of this signal."""
        from kikuchipy_tpu_torch.indexing.refinement import refine_projection_center

        return refine_projection_center(self, *args, **kwargs)

    def refine_orientation_projection_center(self, *args, **kwargs):
        """:func:`kikuchipy_tpu_torch.indexing.refinement.
        refine_orientation_projection_center` of this signal."""
        from kikuchipy_tpu_torch.indexing.refinement import refine_orientation_projection_center

        return refine_orientation_projection_center(self, *args, **kwargs)

    def __repr__(self) -> str:
        return (
            f"EBSD(nav={self.navigation_shape}, sig={self.signal_shape}, "
            f"dtype={self.data.dtype}, device={self.device})"
        )
