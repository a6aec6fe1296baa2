"""Time the host side of reading a pattern file onto the card, in turns.

    python3 staging_variants.py [--mb 236] [--pairs 5]

Writes a file of ``--mb`` MB of uint8 patterns (60 x 60) in a temporary
directory, reads it once so its pages are warm, then times copying it into a
page-locked buffer a chunk at a time (chunks of 1024 and 8192 patterns, as
``LazyEBSD`` at those chunk sizes) four ways, alternating which runs first:
``np.copyto`` out of an ``np.memmap`` on one thread and split over four
(``kikuchipy_tpu_torch.utils.staging.copy_rows``'s two cases), and
``os.preadv`` straight into the buffer on one thread and on four. Then
``staging.to_device`` of the whole file. Prints medians and the spreads
(min-max) in ms and MB/s beside the card's name and power limit. Needs a
CUDA card (page-locked memory); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

PATTERN = 60 * 60


def _split(n: int, parts: int):
    bounds = np.linspace(0, n, parts + 1).astype(int)
    return list(zip(bounds[:-1], bounds[1:]))


def memmap_copy(mm, pinned, chunk: int, threads: int) -> None:
    n = mm.shape[0]
    with ThreadPoolExecutor(max_workers=threads) as pool:
        for a in range(0, n, chunk):
            dst, src = pinned[: min(chunk, n - a)], mm[a : a + chunk]
            list(pool.map(lambda ab: np.copyto(dst[ab[0]:ab[1]], src[ab[0]:ab[1]]), _split(dst.shape[0], threads)))


def pread_copy(fd: int, pinned, n: int, chunk: int, threads: int) -> None:
    with ThreadPoolExecutor(max_workers=threads) as pool:
        for a in range(0, n, chunk):
            m = min(chunk, n - a)
            flat = pinned[:m].reshape(-1)

            def read(ab, a=a, flat=flat):
                view = memoryview(flat[ab[0] * PATTERN: ab[1] * PATTERN])
                done = 0
                while done < len(view):
                    done += os.preadv(fd, [view[done:]], (a + ab[0]) * PATTERN + done)

            list(pool.map(read, _split(m, threads)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mb", type=float, default=236.0)
    parser.add_argument("--pairs", type=int, default=5)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("staging_variants: no CUDA device", file=sys.stderr)
        return 2
    from kikuchipy_tpu_torch.utils.staging import to_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    n = int(args.mb * 1e6) // PATTERN
    mb = n * PATTERN / 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "Pattern.dat"
        np.random.default_rng(0).integers(0, 256, (n, 60, 60), dtype=np.uint8).tofile(path)
        path.read_bytes()  # warm the page cache
        mm = np.memmap(path, dtype=np.uint8, mode="r", shape=(n, 60, 60))
        fd = os.open(path, os.O_RDONLY)
        try:
            for chunk in (1024, 8192):
                pinned = torch.empty((chunk, 60, 60), dtype=torch.uint8, pin_memory=True).numpy()
                ways = {
                    "memmap copyto, 1 thread": lambda: memmap_copy(mm, pinned, chunk, 1),
                    "memmap copyto, 4 threads": lambda: memmap_copy(mm, pinned, chunk, 4),
                    "preadv, 1 thread": lambda: pread_copy(fd, pinned, n, chunk, 1),
                    "preadv, 4 threads": lambda: pread_copy(fd, pinned, n, chunk, 4),
                }
                times = {k: [] for k in ways}
                for i in range(args.pairs):
                    order = list(ways) if i % 2 == 0 else list(ways)[::-1]
                    for k in order:
                        t0 = time.perf_counter()
                        ways[k]()
                        times[k].append((time.perf_counter() - t0) * 1e3)
                print(f"[staging] {smi}: {n} patterns ({mb:.1f} MB), chunks of {chunk}, warm pages, {args.pairs} "
                      "runs each in turns: " + "; ".join(
                          f"{k} {np.median(v):.3f} ms ({mb / np.median(v) * 1e3:.1f} MB/s; {min(v):.3f}-{max(v):.3f})"
                          for k, v in times.items()), flush=True)
            dev = torch.device("cuda")
            t = []
            for _ in range(args.pairs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = to_device(mm, dev)
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
                del out
            print(f"[staging] {smi}: staging.to_device of the file {np.median(t):.3f} ms "
                  f"({mb / np.median(t) * 1e3:.1f} MB/s; {min(t):.3f}-{max(t):.3f})", flush=True)
        finally:
            os.close(fd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
