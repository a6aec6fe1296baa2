"""User-facing EBSD scan object.

PyTorch counterpart of ``kikuchipy_tpu/signals/ebsd.py``: a dataclass
over a pattern tensor ``(ny, nx, sy, sx)`` (or ``(n, sy, sx)``) on one
device, with the attributes the reference kikuchipy carries through
operations (``detector``, ``xmap``, ``static_background``): preprocessing
(intensity rescaling and normalization, static and dynamic background
removal in both filter domains, the dynamic background itself, frequency-
and spatial-domain FFT filtering, downsampling and rebinning, image
quality, adaptive histogram equalization), neighbour averaging and the
neighbour dot-product maps, dictionary indexing, Hough indexing and its PC
optimization, refinement of orientations and/or projection centers,
HyperSpy-order indexing (``inav``, ``isig``), NumPy's reducers, cropping,
grid extraction, copies, ``save``, the lazy view (``as_lazy``), virtual BSE
intensities, PCA decomposition and its models, and plotting (``matplotlib``
imported only when a plot is made).
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
from kikuchipy_tpu_torch.utils.device import as_tensor, host_array, resolve_device
from kikuchipy_tpu_torch.utils.dtypes import numpy_dtype, torch_dtype

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

    @property
    def inav(self) -> "_NavIndexer":
        """Navigation indexer in HyperSpy's axis order: keys are (x, y), so
        ``s.inav[x, y]`` selects map column x, row y. NumPy's keys (negative
        steps, lists) work; per-point detector PCs and the crystal map's
        points are sliced along."""
        return _NavIndexer(self)

    @property
    def isig(self) -> "_SigIndexer":
        """Signal indexer in HyperSpy's axis order: keys are (x, y) detector
        columns and rows, so ``s.isig[:, :-5]`` drops the bottom five rows.
        The static background is sliced along; the detector is kept."""
        return _SigIndexer(self)

    # Each operation returns a NEW EBSD; semantics in ops.pattern.

    def rescale_intensity(self, **kwargs) -> "EBSD":
        return self._replace_data(_ops.rescale_intensity(self.data, device=self.device, **kwargs))

    def normalize_intensity(self, **kwargs) -> "EBSD":
        return self._replace_data(_ops.normalize_intensity(self.data, device=self.device, **kwargs))

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
        """Remove the dynamic background (frequency or spatial domain)."""
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

    def get_dynamic_background(self, **kwargs) -> "EBSD":
        return self._replace_data(_ops.get_dynamic_background(self.data, device=self.device, **kwargs))

    def fft_filter(
        self,
        transfer_function,
        function_domain: str = "frequency",
        shift: bool = False,
        show_progressbar=None,
    ) -> "EBSD":
        """Filter each pattern and rescale it to the data's dtype. With
        ``function_domain="frequency"`` the transfer function multiplies the
        (optionally fft-shifted) spectrum; with ``"spatial"`` it is a kernel
        convolved by the Barnes rFFT filter. ``show_progressbar`` is accepted
        and ignored."""
        del show_progressbar
        dtype = self.data.dtype
        if function_domain == "frequency":
            out = _ops.fft_filter(self.data.to(torch.float32), transfer_function, shift=shift, device=self.device)
        elif function_domain == "spatial":
            from kikuchipy_tpu_torch.ops.fft_barnes import FFTFilterPlan, barnes_fft_filter

            plan = FFTFilterPlan(self.signal_shape, np.asarray(transfer_function))
            out = barnes_fft_filter(self.data.to(torch.float32), plan, device=self.device)
        else:
            raise ValueError(
                f"function_domain must be 'frequency' or 'spatial', got "
                f"{function_domain!r}"
            )
        return self._replace_data(_ops.rescale_intensity(out, dtype_out=dtype, device=self.device))

    def downsample(self, factor: int, **kwargs) -> "EBSD":
        """Integer-factor binning and rescale; the detector's shape, binning
        and PC and the static background follow."""
        factor = int(factor)
        sy, sx = self.signal_shape
        if factor <= 1:
            raise ValueError(f"Binning factor {factor} must be an integer > 1")
        if sy % factor or sx % factor:
            raise ValueError(
                f"Binning factor {factor} must be a divisor of the signal "
                f"shape {self.signal_shape}"
            )
        out = _ops.downsample(self.data, factor, device=self.device, **kwargs)
        new = self._replace_data(out)
        if self.detector is not None:
            det = self.detector
            new.detector = dataclasses.replace(
                det,
                shape=tuple(out.shape[-2:]),
                binning=det.binning * factor,
                pc=det.pc.copy(),
            )
        if self.static_background is not None:
            bg = _ops.downsample(self.static_background, factor, device=self.device, **kwargs)
            new.static_background = bg.cpu().numpy()
        return new

    def get_image_quality(self, normalize: bool = True, show_progressbar=None) -> np.ndarray:
        """Image-quality map (NumPy, the navigation shape);
        ``show_progressbar`` is accepted and ignored."""
        del show_progressbar
        return _ops.get_image_quality(self.data, normalize=normalize, device=self.device).cpu().numpy()

    def adaptive_histogram_equalization(
        self,
        kernel_size=None,
        clip_limit: float = 0.0,
        nbins: int = 128,
        show_progressbar=None,
    ) -> "EBSD":
        """CLAHE of every pattern (one launch of kernel E on the card);
        ``show_progressbar`` is accepted and ignored."""
        del show_progressbar
        from kikuchipy_tpu_torch.ops.ahe import adaptive_histogram_equalization

        return self._replace_data(
            adaptive_histogram_equalization(
                self.data, kernel_size=kernel_size, clip_limit=clip_limit, nbins=nbins, device=self.device,
            )
        )

    def average_neighbour_patterns(self, window=None, **kwargs) -> "EBSD":
        """Average each pattern with its map neighbours, weighted by
        ``window`` (one launch of kernel G on the card); ``kwargs`` as
        :func:`~kikuchipy_tpu_torch.ops.neighbours.average_neighbour_patterns`."""
        from kikuchipy_tpu_torch.ops.neighbours import average_neighbour_patterns

        return self._replace_data(average_neighbour_patterns(self.data, window=window, device=self.device, **kwargs))

    def get_neighbour_dot_product_matrices(self, window=None, **kwargs) -> np.ndarray:
        """Dot-product matrices with the window neighbours, ``(ny, nx, wy,
        wx)`` (NumPy)."""
        from kikuchipy_tpu_torch.ops.neighbours import neighbour_dot_product_matrices

        return neighbour_dot_product_matrices(self.data, window=window, device=self.device, **kwargs)

    def get_average_neighbour_dot_product_map(self, window=None, **kwargs) -> np.ndarray:
        """Average neighbour dot-product (ADP) map (NumPy)."""
        from kikuchipy_tpu_torch.ops.neighbours import average_dot_product_map

        return average_dot_product_map(self.data, window=window, device=self.device, **kwargs)

    def rebin(self, scale: tuple[int, ...] | None = None, **kwargs) -> "EBSD":
        """Integer-factor rebin of the signal axes: ``scale`` is ``(...,
        sy_factor, sx_factor)`` with equal signal factors and navigation
        factors of 1; the same as :meth:`downsample`."""
        if scale is None:
            raise ValueError("Pass scale, e.g. (1, 1, 2, 2)")
        fy, fx = int(scale[-2]), int(scale[-1])
        if fy != fx:
            raise ValueError(
                f"Only equal signal-axis factors are supported, got {scale}"
            )
        if any(int(s) != 1 for s in scale[:-2]):
            raise ValueError("Navigation-axis rebinning is not supported")
        return self.downsample(fy, **kwargs)

    def _reduce(self, name: str, axis) -> "EBSD":
        if axis is None:
            axis = tuple(range(len(self.navigation_shape)))
        return self._replace_data(_numpy_reduce(name, self.data, axis))

    def mean(self, axis=None) -> "EBSD":
        """Mean over ``axis`` (default: the navigation axes, giving the mean
        pattern), in NumPy's dtype: float64 for integer patterns."""
        return self._reduce("mean", axis)

    def max(self, axis=None) -> "EBSD":
        return self._reduce("max", axis)

    def min(self, axis=None) -> "EBSD":
        return self._reduce("min", axis)

    def sum(self, axis=None) -> "EBSD":
        """Sum over ``axis`` in NumPy's dtype (uint64 for unsigned, int64 for
        signed integer patterns)."""
        return self._reduce("sum", axis)

    def std(self, axis=None) -> "EBSD":
        """Standard deviation over ``axis`` with NumPy's ``ddof=0``."""
        return self._reduce("std", axis)

    def change_dtype(self, dtype) -> "EBSD":
        """The scan with patterns cast to ``dtype`` (a new signal)."""
        return self._replace_data(self.data.to(torch_dtype(dtype)))

    def set_scan_calibration(self, step_x: float = 1.0, step_y: float = 1.0) -> None:
        """Set the navigation step sizes in microns (``metadata["scan_step"]``
        as (y, x), unit "um")."""
        self.metadata["scan_step"] = (float(step_y), float(step_x))
        self.metadata["scan_unit"] = "um"

    def set_detector_calibration(self, delta: float) -> None:
        """Set the detector pixel size in microns: the detector's
        ``px_size`` and ``metadata["detector_pixel_size"]``."""
        self.metadata["detector_pixel_size"] = float(delta)
        if self.detector is not None:
            self.detector = dataclasses.replace(self.detector, px_size=float(delta))

    def get_virtual_bse_intensity(self, roi, out_signal_axes=None) -> np.ndarray:
        """Sum pattern intensities inside a detector ROI ``(row0, row1, col0,
        col1)``, in float32 on this signal's device (NumPy, the navigation
        shape). ``out_signal_axes`` (HyperSpy's output axes in kikuchipy) is
        accepted and ignored."""
        from kikuchipy_tpu_torch.imaging.vbse import VirtualBSEImager

        del out_signal_axes
        return VirtualBSEImager(self).get_virtual_bse_intensity(roi)

    def plot_virtual_bse_intensity(self, roi, out_signal_axes=None, ax=None, **imshow_kwargs):
        """Plot the virtual BSE image for a detector ROI ``(row0, row1, col0,
        col1)`` (a static counterpart of kikuchipy's interactive plot);
        returns the matplotlib axes."""
        del out_signal_axes
        import matplotlib.pyplot as plt

        img = self.get_virtual_bse_intensity(roi)
        if ax is None:
            _, ax = plt.subplots()
        ax.imshow(img, cmap=imshow_kwargs.pop("cmap", "gray"), **imshow_kwargs)
        ax.set_title(f"Virtual BSE, ROI rows {roi[0]}:{roi[1]} cols {roi[2]}:{roi[3]}")
        ax.axis("off")
        return ax

    def decomposition(
        self,
        algorithm: str = "SVD",
        output_dimension: int | None = None,
        **kwargs,
    ) -> None:
        """PCA of the patterns on this signal's device, stored on
        :attr:`learning_results` (``factors``, ``loadings``, ``mean``,
        ``output_dimension``, ``explained_variance``,
        ``explained_variance_ratio``; NumPy arrays), as JAX stores it.

        Parameters
        ----------
        algorithm
            Only "SVD"/"PCA" (economy SVD of the centered pattern matrix).
        output_dimension
            Number of components kept (default: the navigation size, at most
            64).
        **kwargs
            HyperSpy's options (``centre``, ``normalize``, ...), accepted and
            ignored.
        """
        del kwargs
        if algorithm.upper() not in ("SVD", "PCA"):
            raise ValueError(f"Only SVD/PCA decomposition is supported, got {algorithm!r}")
        from types import SimpleNamespace

        from kikuchipy_tpu_torch.ops.decomposition import pca

        if output_dimension is None:
            output_dimension = min(self.navigation_size, 64)
        factors, loadings, mean, var, ratio = pca(
            self.data, int(output_dimension), return_variance=True, device=self.device
        )
        self.learning_results = SimpleNamespace(
            factors=factors,
            loadings=loadings,
            mean=mean,
            output_dimension=int(output_dimension),
            explained_variance=var,
            explained_variance_ratio=ratio,
        )

    def get_decomposition_model(self, components: int | list[int] | None = 10, dtype_out=None) -> "EBSD":
        """The scan rebuilt from principal components (a denoising PCA model):
        ``components`` an int (the first n), a list of component indices, or
        None (all); ``dtype_out`` the model's data type, by default the
        storage dtype (integer dtypes are rescaled per pattern; pass
        ``"float32"`` for the raw reconstruction)."""
        from kikuchipy_tpu_torch.ops.decomposition import pca_reconstruct

        if dtype_out is None:
            dtype_out = numpy_dtype(self.data.dtype)
        return self._replace_data(pca_reconstruct(self.data, components, dtype_out=dtype_out, device=self.device))

    def get_decomposition_model_write(
        self,
        out_path,
        components: int = 10,
        chunk_size: int = 1024,
    ) -> None:
        """Write the PCA model of the scan to a kikuchipy h5ebsd file
        ``chunk_size`` patterns at a time, so the float32 model of the whole
        scan is never held (kikuchipy's
        ``LazyEBSD.get_decomposition_model_write``). The factors, loadings
        and mean are computed once on this signal's device; each chunk is
        rebuilt there, rescaled to the storage dtype and written. Needs
        ``h5py``."""
        import h5py

        from kikuchipy_tpu_torch.io.plugins.kikuchipy_h5ebsd import file_writer
        from kikuchipy_tpu_torch.ops.decomposition import _pca, _rescale
        from kikuchipy_tpu_torch.utils.device import matmul_precision

        dtype = numpy_dtype(self.data.dtype)
        sy, sx = self.signal_shape
        factors, loadings, mean, _ = _pca(self.data, components, self.device)

        file_writer(str(out_path), self)
        with h5py.File(out_path, "r+") as f:
            ds = f["Scan 1/EBSD/Data/patterns"]
            for start in range(0, loadings.shape[0], chunk_size):
                w = loadings[start : start + chunk_size]
                with matmul_precision(False):
                    recon = w @ factors + mean
                recon = _rescale(recon, dtype).to(torch_dtype(dtype))
                ds[start : start + w.shape[0]] = recon.reshape(-1, sy, sx).cpu().numpy()

    def extract_grid(
        self,
        grid_shape: tuple[int, int] | int,
        return_indices: bool = False,
    ) -> "EBSD | tuple[EBSD, np.ndarray]":
        """A sub-scan of patterns on an evenly spaced grid.

        Parameters
        ----------
        grid_shape
            ``(n_cols, n_rows)`` (signal-axes order) or an integer for 1D
            scans.
        return_indices
            Also return the ``(ndim,) + grid`` indices of the extracted
            patterns into the navigation grid.
        """
        from kikuchipy_tpu_torch.utils.grid import grid_indices

        nav_shape = self.navigation_shape
        grid_np = (grid_shape,) if isinstance(grid_shape, int) else tuple(grid_shape)[::-1]
        idx = grid_indices(grid_np, nav_shape)
        idx_tuple = tuple(idx)
        flat = np.arange(self.navigation_size).reshape(nav_shape)[idx_tuple]
        xmap_new = None
        if self.xmap is not None:
            try:
                mask = np.zeros(nav_shape, dtype=bool)
                mask[idx_tuple] = True
                xmap_new = self.xmap[mask.ravel()]
            except (TypeError, IndexError):
                xmap_new = None
        new = dataclasses.replace(self, data=_take_points(self.data, flat, self.signal_shape), xmap=xmap_new)
        if self.detector is not None and self.detector.navigation_shape == nav_shape:
            new.detector = dataclasses.replace(self.detector, pc=self.detector.pc[idx_tuple])
        if return_indices:
            return new, idx
        return new

    def crop(self, extent: tuple[int, int, int, int]) -> "EBSD":
        """Crop the detector to ``(row0, row1, col0, col1)``, end-exclusive;
        the detector's geometry and the static background follow."""
        r0, r1, c0, c1 = extent
        new = dataclasses.replace(self, data=self.data[..., r0:r1, c0:c1])
        if self.detector is not None:
            new.detector = self.detector.crop(extent)
        if self.static_background is not None:
            new.static_background = host_array(self.static_background)[r0:r1, c0:c1]
        return new

    def deepcopy(self) -> "EBSD":
        """A copy of the data, detector, crystal map, static background and
        metadata; changing it leaves this signal as it is."""
        import copy

        new = dataclasses.replace(self, data=self.data.clone())
        new.detector = copy.deepcopy(self.detector)
        new.xmap = copy.deepcopy(self.xmap)
        if self.static_background is not None:
            new.static_background = np.array(host_array(self.static_background))
        new.metadata = copy.deepcopy(self.metadata)
        return new

    def save(self, filename, **kwargs) -> None:
        """:func:`kikuchipy_tpu_torch.io.save` of this signal."""
        from kikuchipy_tpu_torch.io import save

        save(filename, self, **kwargs)

    def as_lazy(self, chunk_size: int = 1024):
        """A :class:`~kikuchipy_tpu_torch.signals.lazy.LazyEBSD` over this
        scan's tensor on its device: the operations called on it are
        recorded and run ``chunk_size`` patterns at a time."""
        from kikuchipy_tpu_torch.signals.lazy import ArraySource, LazyEBSD

        return LazyEBSD(
            source=ArraySource(self.data, self.navigation_shape),
            detector=self.detector,
            static_background=self.static_background,
            xmap=self.xmap,
            metadata=dict(self.metadata),
            chunk_size=chunk_size,
            device=self.device,
        )

    def compute(self) -> "EBSD":
        """This signal (its data is in memory already)."""
        return self

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

    def hough_indexing(
        self,
        phase_list=None,
        indexer=None,
        chunksize: int | None = None,
        verbose: int = 0,
        return_index_data: bool = False,
        return_band_data: bool = False,
        **kwargs,
    ):
        """Hough indexing (:func:`kikuchipy_tpu_torch.indexing.hough.
        hough_indexing`; one launch of kernel H on the card).

        ``indexer``: a configured :class:`~kikuchipy_tpu_torch.indexing.hough.
        HoughIndexer` (from :meth:`EBSDDetector.get_indexer`); its phase list
        is used when ``phase_list`` is not given. ``chunksize`` is the plain
        vote's pattern chunk. With ``return_index_data`` and
        ``return_band_data`` the extra returns mirror kikuchipy's PyEBSDIndex
        data: a ``(2, n)`` structured index-data array and the per-pattern
        refined band parameters (a Radon transform of 90 angles and 96 radii,
        9 bands)."""
        from kikuchipy_tpu_torch.indexing.hough import detect_bands_refined, hough_indexing, radon_transform

        if chunksize is not None:
            kwargs.setdefault("chunk", int(chunksize))
        if indexer is not None:
            if phase_list is not None:
                kwargs["phase_list"] = phase_list
            xmap = indexer.index(self, **kwargs)
        else:
            xmap = hough_indexing(self, phase_list=phase_list, **kwargs)
        if verbose:
            fit = np.asarray(xmap.prop["fit"])
            print(
                f"Hough indexing of {xmap.size} patterns: mean fit "
                f"{np.nanmean(fit):.3f} deg, mean bands "
                f"{np.asarray(xmap.prop['nbands']).mean():.1f}"
            )
        out = (xmap,)
        if return_index_data:
            n = xmap.size
            dt = np.dtype([("quat", "f8", (4,)), ("phase", "i8"), ("fit", "f8"), ("cm", "f8"), ("pq", "f8"),
                           ("nmatch", "i8")])
            index_data = np.zeros((2, n), dtype=dt)
            fit = np.asarray(xmap.prop["fit"], dtype=np.float64)
            for row in range(2):
                index_data[row]["quat"] = np.asarray(xmap.best_rotations)
                index_data[row]["phase"] = np.where(np.isfinite(fit), 0, -1)
                index_data[row]["fit"] = fit
                index_data[row]["pq"] = np.asarray(xmap.prop["band_intensity"], dtype=np.float64)
                pq = index_data[row]["pq"]
                rng = np.nanmax(pq) - np.nanmin(pq)
                index_data[row]["cm"] = (pq - np.nanmin(pq)) / rng if rng > 0 else np.ones(n)
                index_data[row]["nmatch"] = np.asarray(xmap.prop["nbands"])
            out += (index_data,)
        if return_band_data:
            rho, theta, intensity, width = detect_bands_refined(radon_transform(self.data))
            out += ({"rho": rho.cpu().numpy(), "theta": theta.cpu().numpy(),
                     "intensity": intensity.cpu().numpy(), "width": width.cpu().numpy()},)
        return out[0] if len(out) == 1 else out

    def hough_indexing_optimize_pc(
        self,
        pc0=None,
        indexer=None,
        batch: bool = False,
        method: str = "Nelder-Mead",
        phase_list=None,
        trust_region=(0.05, 0.05, 0.05),
        max_iters: int = 80,
        **hough_kwargs,
    ):
        """Optimize the projection center on the Hough band fit: search
        (PCx, PCy, PCz) for the smallest mean angular misfit of the detected
        bands to their lattice planes.

        Parameters
        ----------
        pc0
            Initial PC (default: the detector's average PC).
        indexer
            A configured :class:`~kikuchipy_tpu_torch.indexing.hough.
            HoughIndexer`; its phase list, reflectors, detector and settings
            are used when given.
        batch
            With ``True`` one PC a pattern
            (:func:`kikuchipy_tpu_torch.indexing.hough.optimize_pc_batched`:
            bands detected once, orientations at ``pc0``, every pattern's
            search one lockstep batched Nelder-Mead); the returned
            detector's ``pc`` then has the navigation shape. Else one PC for
            the scan by a host search, each misfit one whole
            :func:`hough_indexing` call.
        method
            The host search (``batch=False``): "Nelder-Mead" (SciPy) or "PSO"
            (particle swarm).

        Returns a new :class:`EBSDDetector` with the optimized PC.
        """
        from kikuchipy_tpu_torch.indexing import hough as _hough

        det0 = self.detector
        reflectors = None
        if indexer is not None:
            if phase_list is None:
                phase_list = getattr(indexer, "phase_list", None)
            if batch:
                reflectors = getattr(indexer, "reflectors", None)
            for key, value in getattr(indexer, "kwargs", {}).items():
                hough_kwargs.setdefault(key, value)
            det0 = getattr(indexer, "detector", None) or det0
        if pc0 is None:
            pc0 = det0.pc_average
        if batch:
            sig = dataclasses.replace(self, detector=det0)
            pc = _hough.optimize_pc_batched(
                sig, pc0=pc0, phase_list=phase_list, reflectors=reflectors, trust_region=trust_region,
                max_iters=max_iters, **hough_kwargs,
            )
            nav_shape = self.navigation_shape
            if len(nav_shape) == 2:
                pc = pc.reshape(nav_shape + (3,))
            return dataclasses.replace(det0, pc=pc)
        supported = ("nelder-mead", "pso")
        method = method.lower()
        if method not in supported:
            raise ValueError(f"`method` '{method}' must be one of the supported methods {list(supported)}")
        from scipy.optimize import minimize

        pc0 = np.asarray(pc0, dtype=float)

        def misfit(pc):
            det = dataclasses.replace(det0, pc=np.asarray(pc))
            sig = dataclasses.replace(self, detector=det)
            xmap = _hough.hough_indexing(sig, phase_list=phase_list, **hough_kwargs)
            # Lost band inliers cost; a small fit error pays.
            return float(np.nanmean(xmap.prop["fit"]) - 0.5 * xmap.prop["nbands"].mean())

        tr = np.asarray(trust_region, dtype=float)
        lo, hi = pc0 - tr, pc0 + tr
        if method == "nelder-mead":
            res = minimize(misfit, pc0, method="Nelder-Mead", bounds=list(zip(lo, hi)),
                           options={"maxiter": max_iters, "xatol": 1e-4, "fatol": 1e-4})
            best = res.x
        else:
            # Global-best particle swarm with the usual inertia, cognitive
            # and social weights, from a fixed seed.
            rng = np.random.default_rng(0)
            n_particles = 12
            pos = rng.uniform(lo, hi, size=(n_particles, 3))
            pos[0] = pc0
            vel = rng.uniform(-tr, tr, size=(n_particles, 3)) * 0.1
            pbest = pos.copy()
            pbest_val = np.array([misfit(p) for p in pos])
            g = int(np.argmin(pbest_val))
            gbest, gbest_val = pbest[g].copy(), pbest_val[g]
            w, c1, c2 = 0.6, 1.5, 1.5
            for _ in range(max(1, max_iters // n_particles)):
                r1 = rng.random((n_particles, 3))
                r2 = rng.random((n_particles, 3))
                vel = w * vel + c1 * r1 * (pbest - pos) + c2 * r2 * (gbest - pos)
                pos = np.clip(pos + vel, lo, hi)
                vals = np.array([misfit(p) for p in pos])
                improved = vals < pbest_val
                pbest[improved] = pos[improved]
                pbest_val[improved] = vals[improved]
                g = int(np.argmin(pbest_val))
                if pbest_val[g] < gbest_val:
                    gbest, gbest_val = pbest[g].copy(), pbest_val[g]
            best = gbest
        return dataclasses.replace(det0, pc=best)

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

    def plot(
        self,
        navigator: str | np.ndarray = "iq",
        pattern_idx: tuple[int, ...] | None = None,
        return_figure: bool = False,
    ):
        """Plot a navigator map (image quality, mean intensity or an array)
        beside one pattern (in place of HyperSpy's interactive plot). Only
        the shown pattern and the navigator come to the host."""
        import matplotlib.pyplot as plt

        if pattern_idx is None:
            pattern_idx = tuple(v // 2 for v in self.navigation_shape)
        if isinstance(navigator, str):
            if navigator == "iq":
                nav = self.get_image_quality()
            elif navigator == "mean":
                nav = self.data.to(torch.float64).mean(dim=(-2, -1)).cpu().numpy()
            else:
                raise ValueError(f"navigator must be 'iq', 'mean' or an array, got {navigator!r}")
        else:
            nav = np.asarray(navigator)
        fig, (ax0, ax1) = plt.subplots(ncols=2, figsize=(9, 4))
        im = ax0.imshow(np.atleast_2d(nav), cmap="gray")
        fig.colorbar(im, ax=ax0)
        yx = pattern_idx if len(pattern_idx) == 2 else (0, pattern_idx[0])
        ax0.scatter([yx[1]], [yx[0]], marker="s", s=80, facecolor="none", edgecolor="r")
        ax0.set_title("navigator")
        ax1.imshow(host_array(self.data[pattern_idx]), cmap="gray")
        ax1.set_title(f"pattern {pattern_idx}")
        if return_figure:
            return fig
        return ax0, ax1

    def __repr__(self) -> str:
        return (
            f"EBSD(nav={self.navigation_shape}, sig={self.signal_shape}, "
            f"dtype={self.data.dtype}, device={self.device})"
        )


def _take_points(data: torch.Tensor, flat: np.ndarray, sig_shape) -> torch.Tensor:
    """The patterns at flat navigation indices ``flat`` (any shape, the
    result's navigation shape)."""
    rows = data.reshape((-1,) + tuple(sig_shape))
    index = torch.as_tensor(np.asarray(flat).ravel(), dtype=torch.long, device=data.device)
    return rows[index].reshape(np.shape(flat) + tuple(sig_shape))


def _numpy_reduce(name: str, data: torch.Tensor, axis) -> torch.Tensor:
    """``np.<name>(data, axis=axis)`` in NumPy's result dtype: ``sum`` of
    integers in (u)int64, ``mean`` and ``std`` (``ddof=0``) of integers in
    float64, ``max`` and ``min`` in the data's dtype."""
    dims = tuple(int(a) % data.ndim for a in ((axis,) if np.isscalar(axis) else axis))
    kind = numpy_dtype(data.dtype).kind
    if not dims:  # NumPy reduces over no axis: each value alone
        if name == "std":
            return torch.zeros(data.shape, dtype=torch.float64 if kind in "biu" else data.dtype, device=data.device)
        if name in ("sum", "mean") and kind in "biu":
            return data.to(torch.float64 if name == "mean" else torch.uint64 if kind == "u" else torch.int64)
        return data.clone()
    if name in ("max", "min"):
        # PyTorch has few kernels for uint16 and wider: those reduce in int64.
        x = data.to(torch.int64) if kind == "u" and data.dtype != torch.uint8 else data
        return (x.amax(dim=dims) if name == "max" else x.amin(dim=dims)).to(data.dtype)
    if name == "sum":
        if kind in "biu":
            out = data.to(torch.int64).sum(dim=dims)
            return out.to(torch.uint64) if kind == "u" else out
        return data.sum(dim=dims)
    x = data.to(torch.float64) if kind in "biu" else data
    count = int(np.prod([data.shape[d] for d in dims]))
    mean = x.sum(dim=dims, keepdim=True) / count
    if name == "mean":
        return mean.squeeze(dims)
    dev = x - mean
    return torch.sqrt((dev * dev).sum(dim=dims) / count)


class _NavIndexer:
    """``EBSD.inav``: keys in HyperSpy's x-first order, NumPy's semantics."""

    def __init__(self, signal: EBSD):
        self._signal = signal

    def __getitem__(self, key) -> EBSD:
        s = self._signal
        nav_shape = s.navigation_shape
        nav_dim = len(nav_shape)
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) > nav_dim:
            raise IndexError(f"Too many navigation indices {key} for navigation shape {nav_shape}")
        key = key + (slice(None),) * (nav_dim - len(key))
        # The first key is x, the fastest (last) navigation axis.
        array_key = tuple(reversed(key))
        flat = np.arange(s.navigation_size).reshape(nav_shape)[array_key]
        new = dataclasses.replace(s, data=_take_points(s.data, flat, s.signal_shape))

        det = s.detector
        if det is not None and det.pc.ndim > 2 and det.pc.shape[:-1] == nav_shape:
            new.detector = dataclasses.replace(det, pc=np.atleast_2d(det.pc[array_key]))
        if s.xmap is not None and s.xmap.size == int(np.prod(nav_shape)):
            mask = np.zeros(nav_shape, dtype=bool)
            mask[array_key] = True
            sub = s.xmap[mask.ravel()]
            new_nav = np.shape(flat)
            if new_nav and int(np.prod(new_nav)) == sub.size:
                sub = dataclasses.replace(sub, shape=tuple(new_nav))
            new.xmap = sub
        return new


class _SigIndexer:
    """``EBSD.isig``: keys in HyperSpy's x-first order, NumPy's semantics."""

    def __init__(self, signal: EBSD):
        self._signal = signal

    def __getitem__(self, key) -> EBSD:
        s = self._signal
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) > 2:
            raise IndexError(f"Too many signal indices {key}")
        key = key + (slice(None),) * (2 - len(key))
        kx, ky = key
        sy, sx = s.signal_shape
        flat = np.arange(sy * sx).reshape(sy, sx)[ky, kx]
        index = torch.as_tensor(np.asarray(flat).ravel(), dtype=torch.long, device=s.data.device)
        rows = s.data.reshape(s.navigation_shape + (sy * sx,))
        new = dataclasses.replace(s, data=rows[..., index].reshape(s.navigation_shape + np.shape(flat)))
        if s.static_background is not None:
            new.static_background = host_array(s.static_background)[ky, kx]
        return new
