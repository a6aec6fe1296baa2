"""Signal utilities (``kikuchipy_tpu/signals/util``): the sub-grid
indices, the navigation chunking policy, and a Dask array of a signal
where Dask is installed."""

from kikuchipy_tpu_torch.signals.util._chunking import get_chunking, get_dask_array
from kikuchipy_tpu_torch.utils.grid import grid_indices

__all__ = ["get_chunking", "get_dask_array", "grid_indices"]
