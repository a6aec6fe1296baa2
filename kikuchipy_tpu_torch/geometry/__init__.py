"""Detector geometry, quaternions and the Lambert projection."""
