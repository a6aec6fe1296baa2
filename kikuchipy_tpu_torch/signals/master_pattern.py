"""Master pattern signals and dictionary generation.

PyTorch counterpart of ``kikuchipy_tpu/signals/master_pattern.py``:
:class:`KikuchiMasterPattern` holds the hemispheres (on the host) and their
intensity operations (run on the device) and re-projects a stereographic
pattern onto the square Lambert grid (:meth:`~KikuchiMasterPattern.
as_lambert`); :class:`EBSDMasterPattern` projects square-Lambert
hemispheres onto a detector in batches on the device, and
:meth:`EBSDMasterPattern.spherical_projector` gives their spherical-harmonic
expansion; :class:`ECPMasterPattern` is the electron channeling pattern's.
The plots (:meth:`KikuchiMasterPattern.plot`, ``plot_spherical``) import
``matplotlib`` only when they run.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
from kikuchipy_tpu_torch.geometry.lambert import lambert_to_vector
from kikuchipy_tpu_torch.projection.master_pattern import (
    direction_cosines_from_detector,
    project_patterns,
    quad_texture,
)
from kikuchipy_tpu_torch.projection.spherical import SphericalProjector, _outside_transforms
from kikuchipy_tpu_torch.signals.ebsd import EBSD
from kikuchipy_tpu_torch.utils.device import resolve_device
from kikuchipy_tpu_torch.utils.dtypes import get_dtype_range, torch_dtype

__all__ = ["EBSDMasterPattern", "ECPMasterPattern", "KikuchiMasterPattern"]


@dataclasses.dataclass(repr=False)
class KikuchiMasterPattern:
    """Base master-pattern signal.

    Attributes
    ----------
    data
        ``(npy, npx)`` for one hemisphere or ``(2, npy, npx)`` for both
        (upper first); an extra leading energy axis is allowed.
    phase
        The crystal :class:`Phase`.
    hemisphere
        "upper", "lower" or "both".
    projection
        "lambert" (square Lambert) or "stereographic".
    energies
        Optional accelerating voltages (kV), one per energy bin.
    device
        Where the operations run and patterns are projected; ``None`` is
        the card.
    """

    data: np.ndarray
    phase: Phase = dataclasses.field(default_factory=Phase)
    hemisphere: str = "both"
    projection: str = "lambert"
    energies: np.ndarray | None = None
    metadata: dict = dataclasses.field(default_factory=dict)
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.data = np.asarray(self.data)

    @property
    def signal_shape(self) -> tuple[int, int]:
        return tuple(self.data.shape[-2:])

    # Each intensity operation returns a new signal with the operation
    # applied to every 2D image over the leading axes.

    def _apply_op(self, fn) -> "KikuchiMasterPattern":
        flat = torch.as_tensor(self.data.reshape((-1,) + self.data.shape[-2:]), device=self.device)
        out = fn(flat).cpu().numpy().reshape(self.data.shape)
        return dataclasses.replace(self, data=out)

    def rescale_intensity(self, **kwargs) -> "KikuchiMasterPattern":
        from kikuchipy_tpu_torch.ops import pattern as _ops

        return self._apply_op(lambda d: _ops.rescale_intensity(d, device=self.device, **kwargs))

    def normalize_intensity(self, **kwargs) -> "KikuchiMasterPattern":
        from kikuchipy_tpu_torch.ops import pattern as _ops

        return self._apply_op(lambda d: _ops.normalize_intensity(d, device=self.device, **kwargs))

    def adaptive_histogram_equalization(self, **kwargs) -> "KikuchiMasterPattern":
        from kikuchipy_tpu_torch.ops.ahe import adaptive_histogram_equalization

        return self._apply_op(lambda d: adaptive_histogram_equalization(d, device=self.device, **kwargs))

    def change_dtype(self, dtype) -> "KikuchiMasterPattern":
        """The master pattern with its data cast to ``dtype`` (a new
        signal)."""
        return dataclasses.replace(self, data=self.data.astype(np.dtype(dtype)))

    def deepcopy(self) -> "KikuchiMasterPattern":
        import copy

        return copy.deepcopy(self)

    def as_lazy(self) -> "KikuchiMasterPattern":
        """This signal: master patterns are small and stay in memory."""
        return self

    def compute(self) -> "KikuchiMasterPattern":
        """This signal (its data is in memory already)."""
        return self

    def set_signal_type(self, signal_type: str):
        """This signal as another class: ``"EBSDMasterPattern"``,
        ``"ECPMasterPattern"`` or ``"EBSD"`` (HyperSpy's signal types)."""
        name = signal_type.replace(" ", "").lower()
        if name == "ebsd":
            return EBSD(data=self.data, device=self.device)
        cls = {"ebsdmasterpattern": EBSDMasterPattern, "ecpmasterpattern": ECPMasterPattern}.get(name)
        if cls is None:
            raise ValueError(f"Unknown signal type {signal_type!r}")
        return cls(**{f.name: getattr(self, f.name) for f in dataclasses.fields(cls) if f.init})

    def _hemispheres_at_energy(self, energy: float | None = None) -> np.ndarray:
        """Packed hemispheres ``(2, npy, npx)`` at ``energy`` (the highest
        if not given)."""
        data = self.data
        if data.ndim == 2:
            data = data[None, None]
        elif data.ndim == 3:
            data = data[None] if self.hemisphere == "both" else data[:, None]
        elif data.ndim != 4:
            raise ValueError(f"Cannot interpret master pattern shape {data.shape}")
        if self.energies is not None and energy is not None:
            i = int(np.abs(np.asarray(self.energies) - energy).argmin())
        else:
            i = data.shape[0] - 1
        sel = data[i]
        if sel.shape[0] == 1:
            sel = np.concatenate([sel, sel], axis=0)
        return sel

    def as_lambert(self, show_progressbar=None) -> "KikuchiMasterPattern":
        """Re-project a stereographic master pattern onto the square Lambert
        grid: each grid point maps to the sphere and is sampled bilinearly
        from the stereographic image, in float64 on this signal's device.
        Floating data keeps its dtype, other data becomes float32;
        ``show_progressbar`` is accepted and ignored."""
        del show_progressbar
        if self.projection == "lambert":
            return self
        dev = self.device
        data = torch.as_tensor(np.asarray(self.data, dtype=np.float64), device=dev)
        npy, npx = data.shape[-2:]
        flat = data.reshape((-1, npy, npx))
        yy, xx = torch.meshgrid(
            torch.linspace(-1, 1, npy, dtype=torch.float64, device=dev),
            torch.linspace(-1, 1, npx, dtype=torch.float64, device=dev),
            indexing="ij",
        )
        v = lambert_to_vector(torch.stack([xx, yy], dim=-1))
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        out = torch.empty_like(flat)
        for idx in range(flat.shape[0]):
            # The second image of a pair of hemispheres is the lower one.
            lower = self.hemisphere == "lower" or (self.hemisphere == "both" and flat.shape[0] == 2 and idx == 1)
            vz = -v[..., 2] if lower else v[..., 2]
            # Stereographic projection from the opposite pole onto [-1, 1].
            denom = 1.0 + torch.abs(vz)
            px = (v[..., 0] / denom + 1) / 2 * (npx - 1)
            py = (v[..., 1] / denom + 1) / 2 * (npy - 1)
            x0 = torch.clamp(torch.floor(px).long(), 0, npx - 2)
            y0 = torch.clamp(torch.floor(py).long(), 0, npy - 2)
            fx = px - x0
            fy = py - y0
            img = flat[idx]
            out[idx] = (
                img[y0, x0] * (1 - fy) * (1 - fx)
                + img[y0, x0 + 1] * (1 - fy) * fx
                + img[y0 + 1, x0] * fy * (1 - fx)
                + img[y0 + 1, x0 + 1] * fy * fx
            )
        dtype = self.data.dtype if np.issubdtype(self.data.dtype, np.floating) else np.float32
        return dataclasses.replace(
            self, data=out.reshape(self.data.shape).cpu().numpy().astype(dtype), projection="lambert"
        )

    def plot_spherical(
        self,
        energy: float | None = None,
        style: str = "surface",
        return_figure: bool = False,
        **kwargs,
    ):
        """Plot the master pattern on the sphere with matplotlib 3D (in place
        of kikuchipy's pyvista plot; see
        :func:`kikuchipy_tpu_torch.draw.sphere.plot_master_pattern_sphere`).
        Requires the stereographic projection with both hemispheres."""
        if self.projection != "stereographic":
            raise ValueError(
                "plot_spherical requires the stereographic projection "
                f"(signal is {self.projection!r}); load with "
                "projection='stereographic'"
            )
        if self.hemisphere != "both":
            raise ValueError(
                "plot_spherical requires both hemispheres (signal has "
                f"{self.hemisphere!r})"
            )
        from kikuchipy_tpu_torch.draw.sphere import plot_master_pattern_sphere

        hemis = self._hemispheres_at_energy(energy)
        fig = plot_master_pattern_sphere(hemis[0], hemis[1], style=style, **kwargs)
        if return_figure:
            return fig

    def plot(self, energy: float | None = None, ax=None):
        """Show the (upper-hemisphere) master pattern."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        img = self._hemispheres_at_energy(energy)[0]
        ax.imshow(np.asarray(img), cmap="gray")
        ax.set_title(f"{self.phase.name} ({self.projection})")
        return ax

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(shape={self.data.shape}, "
            f"phase={self.phase.name!r}, hemisphere={self.hemisphere!r}, "
            f"projection={self.projection!r})"
        )


@dataclasses.dataclass(repr=False)
class EBSDMasterPattern(KikuchiMasterPattern):
    """EBSD master pattern with dictionary generation."""

    # spherical_projector's projectors, by (energy, L)
    _sh_cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def get_patterns(
        self,
        rotations: np.ndarray,
        detector: EBSDDetector,
        energy: float | None = None,
        dtype_out=np.float32,
        chunk_size: int = 1024,
        signal_mask: np.ndarray | None = None,
        compute: bool = True,
        show_progressbar=None,
    ) -> EBSD:
        """Project simulated patterns for unit quaternions ``(n, 4)`` (or
        ``(ny, nx, 4)``) onto ``detector`` (one PC, or one per rotation).

        Integer ``dtype_out`` (any dtype other than the master's) rescales
        each pattern to the dtype range, as in the reference kikuchipy. On
        the card one kernel launch projects all rotations; ``chunk_size``
        sets the rotations per step of the plain version on the CPU.
        ``signal_mask`` selects the detector pixels to project; the patterns
        are reshaped to the detector, so a mask that drops a pixel raises
        ``ValueError``, as JAX's reshape does. ``compute`` and
        ``show_progressbar`` are accepted and have no effect, as in JAX.
        Returns an :class:`EBSD` on this pattern's device with an ``xmap``
        holding the rotations.
        """
        del compute, show_progressbar
        if self.projection != "lambert":
            raise ValueError("Master pattern must be in the square Lambert projection")
        rotations = np.asarray(rotations)
        nav_shape = rotations.shape[:-1]
        rot_flat = rotations.reshape(-1, 4)
        n = rot_flat.shape[0]
        if detector.navigation_size not in (1, n):
            raise ValueError(
                "detector must have exactly one projection center, or as "
                f"many as there are rotations ({n}); it has "
                f"{detector.navigation_size}"
            )

        dev = self.device
        master = self._hemispheres_at_energy(energy)
        dtype_out = np.dtype(dtype_out)
        rescale = dtype_out != master.dtype
        out_min, out_max = get_dtype_range(dtype_out) if rescale else (0.0, 1.0)

        npy, npx = master.shape[-2:]
        scale = (npx - 1) / 2
        master_dev = torch.as_tensor(master, dtype=torch.float32, device=dev)
        quad = quad_texture(master_dev)
        dc = direction_cosines_from_detector(detector, signal_mask=signal_mask, device=dev)
        rot_dev = torch.as_tensor(rot_flat, dtype=torch.float32, device=dev)

        sig_shape = detector.shape
        per_pc = dc.ndim == 3
        n_pixels = dc.shape[-2]
        if n and n_pixels != detector.size:
            # JAX's reshape of its first chunk to the detector.
            first = min(chunk_size, n)
            shape = ",".join(str(v) for v in (first, *sig_shape))
            raise ValueError(f"cannot reshape array of size {first * n_pixels} into shape ({shape})")

        def project(start: int, end: int) -> torch.Tensor:
            block = project_patterns(
                rot_dev[start:end],
                dc[start:end] if per_pc else dc,
                master_dev,
                npx,
                npy,
                scale,
                rescale=rescale,
                out_min=float(out_min),
                out_max=float(out_max),
                quad=quad,
            )
            return block.reshape((end - start,) + sig_shape).to(torch_dtype(dtype_out))

        if dev.type == "cuda" and n:
            # One launch of the projection kernel for every rotation.
            out = project(0, n)
        else:
            # chunk_size bounds the plain version's intermediates (about
            # ten times the patterns).
            out = torch.empty((n,) + sig_shape, dtype=torch_dtype(dtype_out), device=dev)
            for start in range(0, n, chunk_size):
                end = min(start + chunk_size, n)
                out[start:end] = project(start, end)

        xmap = CrystalMap(
            rotations=rot_flat,
            shape=nav_shape if nav_shape else (1,),
            phases=PhaseList(self.phase),
        )
        return EBSD(
            data=out.reshape(nav_shape + sig_shape),
            detector=detector,
            xmap=xmap,
            device=dev,
        )

    def projector(
        self,
        detector: EBSDDetector,
        energy: float | None = None,
        signal_mask: np.ndarray | None = None,
    ):
        """Return ``project_fn(rotations) -> (n, n_pixels)`` float32 patterns
        on this pattern's device, for fused dictionary generation and
        matching (``dictionary_index(project_fn=..., rotations=...)``).
        ``rotations`` are unit quaternions ``(n, 4)``, array or tensor.
        The master pattern, its quad texture and the detector's direction
        cosines are moved to the device once, here."""
        if detector.navigation_size != 1:
            raise ValueError("projector requires a single-PC detector")
        dev = self.device
        master = self._hemispheres_at_energy(energy)
        npy, npx = master.shape[-2:]
        scale = (npx - 1) / 2
        master_dev = torch.as_tensor(master, dtype=torch.float32, device=dev)
        quad = quad_texture(master_dev)
        dc = direction_cosines_from_detector(detector, signal_mask=signal_mask, device=dev)

        def project_fn(rot_block) -> torch.Tensor:
            rot = torch.as_tensor(rot_block, dtype=torch.float32, device=dev)
            return project_patterns(rot, dc, master_dev, npx, npy, scale, quad=quad)

        return project_fn

    def spherical_projector(self, energy: float | None = None, L: int = 88):
        """Spherical-harmonic projector of this master pattern
        (:class:`~kikuchipy_tpu_torch.projection.spherical.SphericalProjector`)
        on this pattern's device: a one-time harmonic analysis, cached per
        ``(energy, L)``, after which patterns at fixed detector directions
        are products (``EBSD.refine_*(..., projector="spherical")``).

        ``L`` is the band limit: features of about 180/L degrees are
        resolved, so band-limited patterns are a smoothed version of the
        bilinear projector's. Raises ``ValueError`` unless the master is in
        the square Lambert projection.
        """
        if self.projection != "lambert":
            raise ValueError(
                "spherical_projector requires a square-Lambert master pattern (use as_lambert() first)"
            )
        key = (energy, L)
        if key not in self._sh_cache:
            master = np.asarray(self._hemispheres_at_energy(energy), dtype=np.float32)
            with _outside_transforms():
                self._sh_cache[key] = SphericalProjector.from_master(master, L=L, device=self.device)
        return self._sh_cache[key]


@dataclasses.dataclass(repr=False)
class ECPMasterPattern(KikuchiMasterPattern):
    """Electron channeling pattern master pattern."""
