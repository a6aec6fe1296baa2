"""The worker of the two-process runs of ``kikuchipy_tpu_torch.parallel``:
``tests/test_torch_multihost.py`` starts it on the CPU and ``chip_smoke.py``'s
``[multihost]`` phase on the card.

    python tests/_torch_multihost_worker.py RANK WORLD PORT FOLDER

:func:`launch` starts the workers and waits for them. Each worker joins a gloo group on ``tcp://127.0.0.1:PORT`` and reads
``FOLDER/inputs.npz`` (written by :func:`write_inputs`). It takes only its
:func:`host_navigation_slice` of the scans and runs, on the inputs' device:

- ``multihost_dictionary_index`` of its block, then again with
  ``gather_results`` (the whole map);
- ``multihost_refine_orientation`` of its block with ``gather_results``
  (its own block is the result's crystal map).

It writes the results, its times, its peak device memory and the launches of
the Levenberg-Marquardt loop kernel and of kernel C to
``FOLDER/out_RANK.npz``; the caller compares them with one process's calls.
It imports the port only. :func:`di_problem` and :func:`refinement_problem`
are the CPU test's inputs (37 patterns for indexing, 13 for refinement: the
blocks of two processes are uneven and padded), and also serve the tests that
run in one process.
"""

import datetime
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N_DI, M_DI, D_DI = 37, 120, 64
N_REFINE = 13
PC = (0.42, 0.28, 0.5)
GROUP_TIMEOUT_S = 300


def di_problem():
    """The indexing scan (37, 64) and a dictionary (120, 64) that holds
    every pattern, so each pattern's match is clear."""
    rng = np.random.default_rng(0)
    exp = rng.normal(size=(N_DI, D_DI)).astype(np.float32)
    dic = np.concatenate([rng.normal(size=(M_DI - N_DI, D_DI)).astype(np.float32), exp])
    return exp, dic


def master_data(side: int = 101) -> np.ndarray:
    """``chip_smoke.py``'s synthetic master pattern, ``side`` pixels a
    hemisphere."""
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.master_pattern_data(side=side)


def _master_pattern(master: np.ndarray, device):
    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase

    return kt.EBSDMasterPattern(master, phase=Phase(name="ni", point_group="m-3m"), device=device)


def refinement_problem(n: int = N_REFINE, device="cpu"):
    """A synthetic master pattern (101 x 101 a hemisphere), a 32 x 32
    detector, ``n`` noisy float32 patterns (NumPy) at known orientations
    and starts 2 degrees off, all from seeds; the master on ``device``."""
    import torch

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.sampling import reduce_to_fundamental_zone, super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq

    mp = _master_pattern(master_data(), device)
    det = kt.EBSDDetector(shape=(32, 32), pc=PC, sample_tilt=70)
    pool = max(n, 16)
    truth = reduce_to_fundamental_zone(super_fibonacci(pool * 7)[::7][:pool], "m-3m", device="cpu")[:n]
    sim = mp.get_patterns(truth, det, dtype_out=np.float32).data.cpu().numpy().astype(np.float64)
    noise = np.random.default_rng(5).normal(scale=0.02 * sim.std(), size=sim.shape)
    scan = (sim + noise).astype(np.float32)
    axes = torch.as_tensor(np.random.default_rng(3).normal(size=(n, 3)))
    dq = tq.from_axis_angle(axes / torch.linalg.norm(axes, dim=1, keepdim=True), np.deg2rad(2.0))
    start = tq.multiply(dq, torch.as_tensor(truth)).numpy()
    return mp, det, scan, start


def write_inputs(folder: Path, *, device: str, n_devices: int, n_dict_local: int, keep_n: int, di_patterns,
                 master, detector_shape, pc, refine_scan, start, refine_kwargs: dict, dictionary=None,
                 dict_rot=None, sample_tilt: float = 70.0) -> None:
    """Write the workers' ``inputs.npz``: the scan to index ``di_patterns
    (n, ...)`` and either its ``dictionary (m, ...)`` or the ``dict_rot (m,
    4)`` to project it from ``master`` on each worker's device; the scan to
    refine ``refine_scan (n_r, sy, sx)`` from ``start (n_r, 4)``; the
    detector; the mesh (``n_devices`` positions of ``device`` a process,
    ``n_dict_local`` of them on the dict axis); ``refine_kwargs`` (JSON)
    for ``multihost_refine_orientation``."""
    if (dictionary is None) == (dict_rot is None):
        raise ValueError("give the dictionary or the rotations to project it from")
    source = {"dictionary": dictionary} if dictionary is not None else {"dict_rot": dict_rot}
    np.savez(Path(folder) / "inputs.npz", device=device, n_devices=n_devices, n_dict_local=n_dict_local,
             keep_n=keep_n, di_patterns=di_patterns, master=master, detector_shape=np.asarray(detector_shape),
             pc=np.asarray(pc), sample_tilt=sample_tilt, refine_scan=refine_scan, start=start,
             refine_kwargs=json.dumps(refine_kwargs), **source)


def _launches() -> dict[str, int]:
    from kikuchipy_tpu_torch.ops import refine_lm

    return {"lm_loop": refine_lm.levenberg_marquardt_orientation.launches,
            "tangent": refine_lm.tangent_orientation.launches}


def run(rank: int, world: int, folder: Path) -> None:
    """Index and refine this process's block of ``folder/inputs.npz``; write
    ``folder/out_RANK.npz``."""
    import torch

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.parallel import (
        host_navigation_slice,
        multihost_dictionary_index,
        multihost_mesh,
        multihost_refine_orientation,
    )

    z = np.load(folder / "inputs.npz")
    dev = torch.device(str(z["device"]))
    devices = [dev] * int(z["n_devices"])
    keep_n = int(z["keep_n"])
    mp = _master_pattern(z["master"], dev)
    det = kt.EBSDDetector(shape=tuple(int(v) for v in z["detector_shape"]), pc=tuple(z["pc"]),
                          sample_tilt=float(z["sample_tilt"]))
    if "dictionary" in z.files:
        dictionary = z["dictionary"]
    else:
        dictionary = mp.get_patterns(z["dict_rot"], det, chunk_size=8192).data

    n_di = z["di_patterns"].shape[0]
    sl = host_navigation_slice(n_di)
    mesh = multihost_mesh(n_dict_local=int(z["n_dict_local"]), devices=devices)
    assert mesh.shape == {"scan": world * len(devices) // int(z["n_dict_local"]), "dict": int(z["n_dict_local"])}
    patterns = z["di_patterns"][sl]
    scores, idx = multihost_dictionary_index(patterns, dictionary, keep_n=keep_n, mesh=mesh, n_total=n_di)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    t0 = time.perf_counter()
    s_all, i_all = multihost_dictionary_index(patterns, dictionary, keep_n=keep_n, mesh=mesh, n_total=n_di,
                                              gather_results=True)
    t_di = time.perf_counter() - t0

    n_r = z["refine_scan"].shape[0]
    sl_r = host_navigation_slice(n_r)
    sig = kt.EBSD(data=z["refine_scan"][sl_r], detector=det, device=dev)
    xmap = CrystalMap(rotations=z["start"][sl_r], shape=(sl_r.stop - sl_r.start,))
    t0 = time.perf_counter()
    res, rot_all, scores_all, pcs_all = multihost_refine_orientation(
        sig, xmap=xmap, detector=det, master_pattern=mp, n_total=n_r, gather_results=True, devices=devices,
        **json.loads(str(z["refine_kwargs"])))
    t_refine = time.perf_counter() - t0
    after = _launches()
    assert pcs_all is None  # orientation mode with one PC
    peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6 if dev.type == "cuda" else 0.0
    np.savez(folder / f"out_{rank}.npz", start=sl.start, stop=sl.stop, scores=scores, idx=idx, scores_all=s_all,
             idx_all=i_all, refine_start=sl_r.start, refine_stop=sl_r.stop, rot=res.xmap.best_rotations,
             refine_scores=res.xmap.prop["scores"], rot_all=rot_all, refine_scores_all=scores_all, t_di=t_di,
             t_refine=t_refine, peak_mb=peak_mb, **{k: after[k] - before[k] for k in after})


def launch(folder: Path, world: int = 2, timeout: float = GROUP_TIMEOUT_S) -> list[tuple[int, str]]:
    """Start ``world`` workers on ``folder`` in a gloo group on a free
    loopback port and wait for each up to ``timeout`` seconds, killing any
    that overrun; returns each worker's exit code (None if killed) and its
    output."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(rank), str(world), str(port),
                               str(folder)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    logs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out = p.communicate()[0] + f"\n(killed after {timeout} s)"
                p.returncode = None
            logs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return logs


def main() -> None:
    rank, world, port, folder = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        run(rank, world, folder)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
