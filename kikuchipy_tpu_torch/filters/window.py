"""Filter and correlation windows (host-side NumPy).

The port's own copy of ``kikuchipy_tpu/filters/window.py``: named windows
("circular" by default, "rectangular", "gaussian" and any SciPy
``get_window`` name, "modified_hann", and the "lowpass" / "highpass" FFT
transfer functions), custom arrays, circular masking, and the validity and
compatibility checks. Windows are small constants that parameterize the
device operations, so plain NumPy is the tool here.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import get_window

__all__ = [
    "Window",
    "distance_to_origin",
    "gaussian_window_2d",
    "modified_hann",
    "lowpass_fft_filter",
    "highpass_fft_filter",
]


def distance_to_origin(
    shape: tuple[int, ...], origin: tuple[int, ...] | None = None
) -> np.ndarray:
    """Distance in pixels from each element to the window origin
    (default: ``shape // 2`` per axis)."""
    if origin is None:
        origin = tuple(i // 2 for i in shape)
    grids = np.ogrid[tuple(slice(None, i) for i in shape)]
    if len(shape) == 2:
        return np.sqrt(
            (grids[0] - origin[0]) ** 2 + (grids[1] - origin[1]) ** 2
        )
    return np.abs(grids[0] - origin[0])


def modified_hann(Nx: int) -> np.ndarray:
    """1D modified Hann window, ``cos(pi * x / Nx)`` with ``x`` relative
    to the window center (Wilkinson 2006)."""
    return np.cos(np.pi * (np.arange(Nx) - (Nx / 2) + 0.5) / Nx)


def lowpass_fft_filter(
    shape: tuple[int, int],
    cutoff: float,
    cutoff_width: float | None = None,
) -> np.ndarray:
    """2D low-pass FFT transfer function with a Gaussian roll-off between
    ``cutoff`` and ``cutoff + 2 * cutoff_width``."""
    r = distance_to_origin(shape)
    if cutoff_width is None:
        cutoff_width = cutoff / 2
    window = np.exp(-(((r - cutoff) / (np.sqrt(2) * cutoff_width / 2)) ** 2))
    window[r > (cutoff + 2 * cutoff_width)] = 0
    window[r < cutoff] = 1
    return window


def highpass_fft_filter(
    shape: tuple[int, int],
    cutoff: float,
    cutoff_width: float | None = None,
) -> np.ndarray:
    """2D high-pass FFT transfer function with a Gaussian roll-on between
    ``cutoff - 2 * cutoff_width`` and ``cutoff``."""
    r = distance_to_origin(shape)
    if cutoff_width is None:
        cutoff_width = cutoff / 2
    window = np.exp(-(((cutoff - r) / (np.sqrt(2) * cutoff_width / 2)) ** 2))
    window[r < (cutoff - 2 * cutoff_width)] = 0
    window[r > cutoff] = 1
    return window


class Window(np.ndarray):
    """A named 2D (or 1D) filter/correlation window.

    Examples
    --------
    >>> Window("gaussian", std=2, shape=(5, 5))  # doctest: +SKIP
    >>> Window()  # circular (3, 3)  # doctest: +SKIP
    """

    _name: str = "custom"
    _circular: bool = False

    def __new__(
        cls,
        window: str | np.ndarray | None = None,
        shape: tuple[int, ...] | None = None,
        **kwargs,
    ) -> "Window":
        if window is None:
            window = "circular"

        if shape is None and "Nx" not in kwargs:
            shape = (3, 3)
        elif "Nx" in kwargs:
            shape = (kwargs.pop("Nx"),)
        else:
            shape = tuple(int(i) for i in shape)
            if any(i < 1 for i in shape):
                raise ValueError(f"All window axes {shape} must be > 0.")

        exclude_corners = False
        if isinstance(window, np.ndarray):
            name = "custom"
            data = np.asarray(window)
        elif isinstance(window, str):
            if window == "modified_hann":
                name = window
                data = modified_hann(shape[0])
                if len(shape) == 2:
                    data = np.outer(data, modified_hann(shape[1]))
            elif window in ("lowpass", "highpass"):
                name = window
                func = lowpass_fft_filter if window == "lowpass" else highpass_fft_filter
                data = func(
                    shape=shape,
                    cutoff=kwargs["cutoff"],
                    cutoff_width=kwargs.pop("cutoff_width", None),
                )
            else:
                if window == "circular":
                    exclude_corners = True
                    window = "rectangular"
                name = window
                fftbins = kwargs.pop("fftbins", False)
                win_arg = (window, *kwargs.values()) if kwargs else window
                data = get_window(win_arg, shape[0], fftbins=fftbins)
                if len(shape) == 2:
                    data = np.outer(data, get_window(win_arg, shape[1], fftbins=fftbins))
        else:
            raise ValueError(
                f"Window {type(window)} must be a numpy.ndarray or a valid string"
            )

        obj = np.asarray(data).view(cls)
        obj._name = name
        obj._circular = False
        if exclude_corners:
            obj.make_circular()
        return obj

    def __array_finalize__(self, obj) -> None:
        if obj is None:
            return
        self._name = getattr(obj, "_name", "custom")
        self._circular = getattr(obj, "_circular", False)

    @property
    def name(self) -> str:
        return self._name

    @property
    def circular(self) -> bool:
        return self._circular

    @property
    def origin(self) -> tuple[int, ...]:
        return tuple(i // 2 for i in self.shape)

    @property
    def distance_to_origin(self) -> np.ndarray:
        return distance_to_origin(self.shape, self.origin)

    @property
    def n_neighbours(self) -> tuple[int, ...]:
        """Maximum number of nearest neighbours to the origin per axis."""
        return tuple(np.subtract(self.shape, self.origin) - 1)

    @property
    def is_valid(self) -> bool:
        return isinstance(self._name, str) and self.ndim < 3

    def make_circular(self) -> None:
        """Zero out elements farther from the origin than the half width
        of the window's longest axis."""
        if self.ndim == 1:
            return
        mask = self.distance_to_origin > max(self.origin)
        self[mask] = 0
        self._circular = True
        if self._name in ("rectangular", "boxcar"):
            self._name = "circular"

    def shape_compatible(self, shape: tuple[int, ...]) -> bool:
        """Whether this window fits within data of ``shape``."""
        if len(self.shape) > len(shape):
            return False
        return all(w <= s for w, s in zip(self.shape, shape))

    def plot(
        self,
        grid: bool = True,
        show_values: bool = True,
        textcolors: tuple[str, str] | None = None,
        cmap: str = "viridis",
        cmap_label: str = "Value",
        colorbar: bool = True,
        return_figure: bool = False,
    ):
        """Plot window coefficients as an annotated heatmap (matplotlib,
        imported here).

        Parameters
        ----------
        grid
            Draw minor grid lines between coefficients (default True).
        show_values
            Annotate each coefficient with its value (default True).
        textcolors
            (below-threshold, above-threshold) annotation colors;
            default ("white", "black").
        cmap, cmap_label, colorbar
            Colormap, its colorbar label, and whether to draw the
            colorbar.
        """
        import matplotlib.pyplot as plt

        if textcolors is None:
            textcolors = ("white", "black")
        fig, ax = plt.subplots()
        arr = np.atleast_2d(np.asarray(self))
        im = ax.imshow(arr, cmap=cmap)
        if colorbar:
            cbar = fig.colorbar(im, ax=ax)
            cbar.ax.set_ylabel(cmap_label)
        if grid:
            ax.set_xticks(np.arange(arr.shape[1] + 1) - 0.5, minor=True)
            ax.set_yticks(np.arange(arr.shape[0] + 1) - 0.5, minor=True)
            ax.grid(which="minor", color="w", linestyle="-", linewidth=0.8)
            ax.tick_params(which="minor", bottom=False, left=False)
        if show_values:
            threshold = arr.max() / 2
            for (r, c), v in np.ndenumerate(arr):
                ax.text(
                    c,
                    r,
                    f"{v:.4g}",
                    ha="center",
                    va="center",
                    color=textcolors[int(v > threshold)],
                    fontsize=8,
                )
        ax.set_title(f"{self.name} {self.shape}")
        if return_figure:
            return fig
        return ax

    def __repr__(self) -> str:
        data = np.array_str(self, precision=4, suppress_small=True)
        return f"Window {self.shape} {self.name}\n{data}"


def gaussian_window_2d(std: float, truncate: float = 4.0) -> np.ndarray:
    """Normalized 2D Gaussian window of shape ``(int(truncate * std),) * 2``,
    as used for frequency-domain dynamic background estimation
    (``kikuchipy_tpu/filters/window.py:gaussian_window_2d``)."""
    n = int(truncate * std)
    w1 = get_window(("gaussian", std), n, fftbins=False)
    w = np.outer(w1, w1)
    w = w / (2 * np.pi * std**2)
    return w / np.sum(w)
