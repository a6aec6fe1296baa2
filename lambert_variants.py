"""Measure the choices of kernel A's design (``csrc/lambert_project.cu``,
master-pattern projection) on one card.

    python3 lambert_variants.py [--reps 5]

Rebuilds the kernel with ``-DLAMBERT_ROTATIONS`` and
``-DLAMBERT_RESCALE_ROTATIONS`` both of 1, 2, 4 and 8 (the rotations a lane
projects from one load of its direction cosine, without and with rescale)
and ``-DLAMBERT_STREAM_STORES`` of 0 and 1 (plain or streaming stores of
the patterns that are not rescaled), all with ``nvcc`` in parallel, and for each variant on the main
path's dictionary (``chip_smoke.py``'s seeded 401 x 401 master, the 60 x 60
detector and the 107,129 rotations of a 2-degree m-3m fundamental zone):

- the time of one launch on the whole dictionary, in two rounds (the
  variants in order, then in reverse), and with rescale to [0, 255]
  (the second pass reads back what the lane wrote);
- ``chip_smoke.py``'s float64 criterion (``Float64Yardstick``) on the whole
  dictionary and on a rescaled slab of 8192 rotations;
- ``ptxas``'s registers and stack of each build.

Then the gathers alone, at the same count (``GATHER_PROBE``): one float4
of the quad texture a (pattern, pixel), at the row kernel A read (its taps,
an int32 read a pixel more) or at a hashed row anywhere in the texture,
summed and written with streaming stores as kernel A writes its patterns.
The first is the floor that kernel A's own addresses set, with nothing of
the projection computed.

Prints one JSON line a variant and one a probe with the card's name, power limit, clock,
power and temperature. Needs a CUDA device and ``nvcc``. The port calls
nothing of this script.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

from compare_kernel_times import card

ROTATIONS = (1, 2, 4, 8)
STREAM_STORES = (0, 1)
SLAB = 8192

GATHER_PROBE = r'''
#include <cuda_runtime.h>

__global__ void gather_taps(const float4* __restrict__ quad, const int* __restrict__ taps, float* __restrict__ out,
                            long long n) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
        const float4 q = __ldg(quad + taps[i]);
        __stcs(out + i, (q.x + q.y) + (q.z + q.w));
    }
}

__global__ void gather_hashed(const float4* __restrict__ quad, unsigned rows, float* __restrict__ out, long long n) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
        unsigned h = (unsigned)i * 2654435761u;
        h ^= h >> 15;
        h *= 2246822519u;
        h ^= h >> 13;
        const float4 q = __ldg(quad + h % rows);
        __stcs(out + i, (q.x + q.y) + (q.z + q.w));
    }
}

extern "C" int gather_launch(const void* quad, const void* taps, unsigned rows, void* out, long long n, int blocks,
                             void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (taps)
        gather_taps<<<blocks, 256, 0, s>>>(static_cast<const float4*>(quad), static_cast<const int*>(taps),
                                           static_cast<float*>(out), n);
    else
        gather_hashed<<<blocks, 256, 0, s>>>(static_cast<const float4*>(quad), rows, static_cast<float*>(out), n);
    return (int)cudaGetLastError();
}
'''


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lambert_variants: needs a CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    from kikuchipy_tpu_torch.crystallography.sampling import sample_fundamental_zone
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.ops import _build
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector, quad_texture

    # The variants compile while the inputs and references are made.
    out_dir = here / "kikuchipy_tpu_torch" / "_kernels_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = here / "kikuchipy_tpu_torch" / "csrc" / "lambert_project.cu"
    probe_src = out_dir / "gather_probe.cu"
    probe_src.write_text(GATHER_PROBE)
    probe_lib = out_dir / "libgather_probe.so"
    probe_proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(probe_lib), str(probe_src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = []
    for rotations in ROTATIONS:
        for stream in STREAM_STORES:
            lib = out_dir / f"lambert_variant_{rotations}_{stream}.so"
            procs.append(((rotations, stream), lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, f"-DLAMBERT_ROTATIONS={rotations}",
                 f"-DLAMBERT_RESCALE_ROTATIONS={rotations}", f"-DLAMBERT_STREAM_STORES={stream}", "-o", str(lib),
                 str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    side = smoke.MASTER_SIDE
    master = smoke.master_pattern_data(side)
    value_range = float(master.max() - master.min())
    quad = quad_texture(torch.as_tensor(master, device=dev))
    quad64 = quad.double()
    geo = (side, side, (side - 1) / 2)
    dc = direction_cosines_from_detector(EBSDDetector(shape=smoke.DETECTOR_SHAPE, pc=smoke.PC, sample_tilt=70),
                                         device=dev)
    rot = torch.as_tensor(sample_fundamental_zone(smoke.RESOLUTION_DEG, "m-3m"), dtype=torch.float32, device=dev)
    B, P = rot.shape[0], dc.shape[0]
    rescale_kw = dict(rescale=True, out_min=0.0, out_max=255.0)
    slabs = [(s, min(s + SLAB, B)) for s in range(0, B, SLAB)]
    refs = [(lp.lambert_project_plain(rot[s:e], dc, quad, *geo, taps=True),
             lp.lambert_project_plain(rot[s:e].double(), dc.double(), quad64, *geo, taps=True)) for s, e in slabs]
    ref_rescaled = (lp.lambert_project_plain(rot[:SLAB], dc, quad, *geo, taps=True, **rescale_kw),
                    lp.lambert_project_plain(rot[:SLAB].double(), dc.double(), quad64, *geo, taps=True, **rescale_kw))

    # One output and one tap buffer for every launch.
    out_all = torch.empty((B, P), dtype=torch.float32, device=dev)
    tap_all = torch.empty((B, P), dtype=torch.int32, device=dev)

    def launcher(lib, r, rescale: bool, taps: bool):
        fn = lib.lambert_project_launch
        fn.argtypes = lp._ARGTYPES["lambert_project"]
        fn.restype = ctypes.c_int
        n = r.shape[0]
        out = out_all[:n]
        tap = tap_all[:n] if taps else None

        def run():
            err = fn(r.data_ptr(), dc.data_ptr(), quad.data_ptr(), out.data_ptr(), 0 if tap is None else tap.data_ptr(),
                     n, P, 0, side, side, float(geo[2]), int(rescale), 0.0, 255.0 if rescale else 1.0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"lambert_project launch failed: cudaError_t {err}")
            return out, tap

        return run

    variants = {}
    for key, lib_path, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for LAMBERT_ROTATIONS={key[0]} LAMBERT_STREAM_STORES={key[1]}:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        yard = smoke.Float64Yardstick()
        got, tap = launcher(lib, rot, False, True)()
        for (s, e), ((p32, t32), (p64, t64)) in zip(slabs, refs):
            yard.add("dictionary", got[s:e], tap[s:e], p32, t32, p64, t64, value_range)
        got, tap = launcher(lib, rot[:SLAB], True, True)()
        (p32, t32), (p64, t64) = ref_rescaled
        yard.add("rescaled", got, tap, p32, t32, p64, t64, 255.0)
        variants[key] = dict(lib=lib, yard=yard, run=launcher(lib, rot, False, False),
                             run_rescale=launcher(lib, rot, True, False),
                             ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "stack frame" in ln])
        lib_path.unlink()

    times = {key: [] for key in variants}
    for order in (list(variants), list(variants)[::-1]):
        for key in order:
            times[key].append(smoke.cuda_ms(variants[key]["run"], args.reps))
    for key, v in variants.items():
        bad = v["yard"].failures()
        print(json.dumps({
            "measurement": "kernel A variant", "rotations": key[0], "stream_stores": bool(key[1]), "B": B, "P": P,
            "ms": times[key], "ms_rescale": smoke.cuda_ms(v["run_rescale"], args.reps),
            "float64_criterion": "met" if not bad else bad,
            "dictionary": v["yard"].summary(v["yard"].cases["dictionary"]),
            "rescaled": v["yard"].summary(v["yard"].cases["rescaled"]),
            "ptxas": v["ptxas"], "card": card(),
        }), flush=True)

    # The gathers alone, at kernel A's own taps (as built) and at hashed rows.
    log, _ = probe_proc.communicate()
    if probe_proc.returncode:
        raise RuntimeError(f"nvcc failed for the gather probe:\n{log}")
    fn = ctypes.CDLL(str(probe_lib)).gather_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _, taps = lp.lambert_project(rot, dc, quad, *geo, taps=True)
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    for label, tap_ptr in (("kernel A's taps", taps.data_ptr()), ("hashed rows", 0)):
        def probe():
            err = fn(quad.data_ptr(), tap_ptr, quad.shape[0], out_all.data_ptr(), B * P, blocks,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"gather probe launch failed: cudaError_t {err}")

        ms = smoke.cuda_ms(probe, args.reps)
        print(json.dumps({"measurement": "gathers alone", "rows": label, "taps": B * P, "ms": ms,
                          "taps_per_s": B * P / ms * 1e3, "sector_bytes_per_s": B * P * 32 / ms * 1e3,
                          "card": card()}), flush=True)
    probe_lib.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
