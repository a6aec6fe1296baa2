"""Hough indexing of clean patterns from the main path's synthetic master,
the port against the JAX package on the CPU.

``chip_smoke.py`` indexes 1,024 clean 60 x 60 patterns of its master
(bands of sigma 2 theta_B) and gates that run on the share under 1 degree,
not on the largest disorientation: on that master the vote misindexes a few
patterns whatever the package. This test holds that reason on a subsample
of the same orientations, at the same pattern size and Radon grid: every
pattern the port misindexes, JAX misindexes too, and JAX's own largest
disorientation passes 1 degree.

Both packages take one build of the folded Radon operator (the same NumPy
code, held bit for bit at smaller sizes in ``test_torch_hough.py``): the
build takes half a minute on the CPU.
"""

import numpy as np
import pytest
import torch

from kikuchipy_tpu.crystallography.crystal_map import Phase as JPhase
from kikuchipy_tpu.indexing import hough as jh
from kikuchipy_tpu_torch.crystallography.crystal_map import Phase as TPhase
from kikuchipy_tpu_torch.crystallography.sampling import (disorientation_angle, reduce_to_fundamental_zone,
                                                          super_fibonacci)
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector as TDetector
from kikuchipy_tpu_torch.indexing import hough as th
from tests.test_torch_hough import NI, PC, _jax_signal, _torch_signal, master_pattern, unit64

CPU = "cpu"
# chip_smoke.py's main path: 16,384 orientations, its clean run every 16th
# (1,024); here every 64th (256), through its master (side 401).
N_SCAN, STEP, MASTER_SIDE = 16384, 64, 401
SHAPE = (60, 60)
MAX_DEG = 1.0
# chip_smoke.py HOUGH_WIDE_SHARE: its gate on the share under 1 degree.
WIDE_SHARE = 0.95


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_port_misindexes_no_main_master_pattern_that_jax_indexes(monkeypatch):
    import kikuchipy_tpu_torch as kt

    mp = kt.EBSDMasterPattern(master_pattern(MASTER_SIDE), phase=TPhase(name="ni", point_group="m-3m"), device=CPU)
    truth = reduce_to_fundamental_zone(super_fibonacci(N_SCAN * 7)[::7][:N_SCAN], "m-3m", device=CPU)
    rot = np.asarray(truth)[::STEP]
    pats = mp.get_patterns(rot, TDetector(shape=SHAPE, pc=PC, sample_tilt=70), dtype_out=np.uint8).data.numpy()
    monkeypatch.setattr(jh, "_radon_butterfly_matrix", th._radon_butterfly_matrix)
    got = th.hough_indexing(_torch_signal(pats, shape=SHAPE), phase_list=TPhase(**NI))
    want = jh.hough_indexing(_jax_signal(pats, shape=SHAPE), phase_list=JPhase(**NI))
    ang = np.degrees(disorientation_angle(rot, unit64(got.rotations), "m-3m", device=CPU))
    ang_j = np.degrees(disorientation_angle(rot, unit64(np.asarray(want.rotations)), "m-3m", device=CPU))
    wrong, wrong_j = np.nonzero(ang >= MAX_DEG)[0], np.nonzero(ang_j >= MAX_DEG)[0]
    assert set(wrong) <= set(wrong_j), (wrong, wrong_j)
    assert ang_j.max() >= MAX_DEG
    assert (ang < MAX_DEG).mean() >= WIDE_SHARE and np.median(ang) < MAX_DEG
