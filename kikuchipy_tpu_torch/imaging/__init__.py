"""Imaging tools (the JAX package's ``imaging``, kikuchipy's
``kikuchipy.imaging``)."""

from kikuchipy_tpu_torch.imaging.vbse import VirtualBSEImager

__all__ = ["VirtualBSEImager"]
