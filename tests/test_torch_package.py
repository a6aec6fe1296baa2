"""Rules of the port: it imports neither JAX nor the JAX package, its
entry points run on the card unless told otherwise, and the kernel
wrappers count only launches of their kernels."""

import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kikuchipy_tpu_torch
from kikuchipy_tpu_torch.ops import _build
from kikuchipy_tpu_torch.ops import ncc_topk as nt

PKG = Path(kikuchipy_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="kikuchipy_tpu_torch.")
    )


def test_imports_leave_no_jax_in_sys_modules():
    # The walk reaches every subpackage and module, the last slice's too.
    walked = set(_modules())
    for name in ("simulation", "simulation.kikuchi_pattern_simulator", "simulations", "imaging.vbse", "draw.sphere",
                 "draw.detector_plotter", "data", "data._registry", "pattern", "pattern_chunk",
                 "ops.decomposition", "utils.profiling", "parallel", "parallel.mesh", "parallel.multihost",
                 "parallel.refine", "io.streaming", "native"):
        assert f"kikuchipy_tpu_torch.{name}" in walked, name
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'kikuchipy_tpu' or m.startswith('kikuchipy_tpu.')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_import_statement_names_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|kikuchipy_tpu)(\s|\.|$)", re.M)
    scripts = ("chip_smoke.py", "compare_kernel_times.py", "kernel_variants.py", "refine_variants.py",
               "lambert_variants.py", "lm_variants.py", "neighbours_variants.py", "preprocess_variants.py",
               "sass_count.py", "staging_variants.py", "tests/_torch_multihost_worker.py")
    for path in list(PKG.rglob("*.py")) + [ROOT / name for name in scripts]:
        assert not pattern.search(path.read_text()), path


@pytest.mark.parametrize(
    "call",
    [
        lambda: kikuchipy_tpu_torch.dictionary_index(np.ones((2, 4, 4)), np.ones((3, 4, 4))),
        lambda: kikuchipy_tpu_torch.prepare_dictionary(np.ones((3, 4, 4))),
        lambda: kikuchipy_tpu_torch.EBSD(np.ones((2, 4, 4), np.uint8)),
        lambda: kikuchipy_tpu_torch.EBSDMasterPattern(np.ones((2, 5, 5), np.float32)),
        lambda: importlib.import_module("kikuchipy_tpu_torch.ops.pattern").remove_dynamic_background(
            np.ones((1, 8, 8), np.uint8)
        ),
        lambda: kikuchipy_tpu_torch.dictionary_index(
            np.ones((2, 4, 4)), project_fn=lambda r: r, rotations=np.ones((3, 16))
        ),
        lambda: kikuchipy_tpu_torch.EBSDMasterPattern(np.ones((2, 5, 5), np.float32)).projector(
            kikuchipy_tpu_torch.EBSDDetector(shape=(4, 4))
        ),
        lambda: importlib.import_module("kikuchipy_tpu_torch.projection.master_pattern").direction_cosines_from_detector(
            kikuchipy_tpu_torch.EBSDDetector(shape=(4, 4))
        ),
        lambda: importlib.import_module("kikuchipy_tpu_torch.projection.spherical").sh_basis(np.eye(3), 2),
        lambda: importlib.import_module("kikuchipy_tpu_torch.projection.spherical").SphericalProjector.from_master(
            np.ones((2, 5, 5), np.float32), L=2
        ),
        lambda: kikuchipy_tpu_torch.EBSDMasterPattern(np.ones((2, 5, 5), np.float32)).spherical_projector(L=2),
        # The global solvers with NumPy bounds and starts, as JAX's take them.
        lambda: importlib.import_module("kikuchipy_tpu_torch.utils.optimize").differential_evolution_batched(
            _sphere, -np.ones((2, 3)), np.ones((2, 3)), max_iters=1
        ),
        lambda: importlib.import_module("kikuchipy_tpu_torch.utils.optimize").dual_annealing_batched(
            _sphere, -np.ones((2, 3)), np.ones((2, 3)), max_iters=1
        ),
        lambda: importlib.import_module("kikuchipy_tpu_torch.utils.optimize").basinhopping_batched(
            _sphere, np.zeros((2, 3)), niter=1, local_max_iters=1
        ),
        lambda: importlib.import_module("kikuchipy_tpu_torch.utils.optimize").shgo_batched(
            _sphere, -np.ones((2, 3)), np.ones((2, 3)), n_samples=4, n_starts=1, local_max_iters=1
        ),
        # Orientation sampling and the fundamental-zone tools.
        *(
            (lambda name=name, args=args: getattr(importlib.import_module("kikuchipy_tpu_torch.crystallography.sampling"),
                                                  name)(*args))
            for name, args in [
                ("in_fundamental_zone", (np.eye(4)[:1], "m-3m")),
                ("reduce_to_fundamental_zone", (np.eye(4)[:1], "m-3m")),
                ("disorientation_angle", (np.eye(4)[:1], np.eye(4)[:1], "m-3m")),
                ("sample_fundamental_zone", (20.0,)),
                ("cu2ho", (np.zeros(3),)),
                ("ho2qu", (np.zeros(3),)),
                ("cubochoric_sampling", (2,)),
                ("get_sample_fundamental", (20.0,)),
            ]
        ),
        # Hough detection on arrays.
        *(
            (lambda name=name: getattr(importlib.import_module("kikuchipy_tpu_torch.indexing.hough"), name)(
                np.ones((2, 8, 8), np.float32), n_theta=6, n_rho=4))
            for name in ("radon_transform", "detect_bands_fused")
        ),
        lambda: importlib.import_module("kikuchipy_tpu_torch.indexing.hough").HoughIndexer(
            kikuchipy_tpu_torch.EBSDDetector(shape=(8, 8)), None).index(np.ones((2, 8, 8), np.uint8)),
        # Reading files, the lazy scan and the master patterns' re-projection.
        lambda: kikuchipy_tpu_torch.load("scan.dat"),
        lambda: importlib.import_module("kikuchipy_tpu_torch.io.plugins.edax_binary").file_reader("scan.up1"),
        lambda: kikuchipy_tpu_torch.LazyEBSD(
            source=importlib.import_module("kikuchipy_tpu_torch.signals.lazy").ArraySource(
                np.ones((2, 4, 4), np.uint8), (2,))).compute(),
        lambda: kikuchipy_tpu_torch.EBSDMasterPattern(np.ones((2, 5, 5), np.float32),
                                                      projection="stereographic").as_lambert(),
        lambda: kikuchipy_tpu_torch.ECPMasterPattern(np.ones((2, 5, 5), np.float32)),
        lambda: kikuchipy_tpu_torch.VirtualBSEImage(np.ones((5, 5), np.uint8)),
        # Kinematical simulation, PCA, the pattern shims and the example data.
        lambda: _ni_simulator().calculate_master_pattern(half_size=2),
        lambda: importlib.import_module("kikuchipy_tpu_torch.ops.decomposition").pca(np.ones((3, 4, 4)), 2),
        lambda: importlib.import_module("kikuchipy_tpu_torch.ops.decomposition").pca_reconstruct(np.ones((3, 4, 4)), 2),
        lambda: kikuchipy_tpu_torch.pattern.chunk.get_dynamic_background(np.ones((2, 8, 8), np.uint8)),
        lambda: _data_accessor_in_a_temporary_directory(),
        # The meshes take every CUDA device, and the paths that make one.
        lambda: importlib.import_module("kikuchipy_tpu_torch.parallel").make_mesh(),
        lambda: importlib.import_module("kikuchipy_tpu_torch.parallel").multihost_mesh(),
        lambda: importlib.import_module("kikuchipy_tpu_torch.parallel").sharded_dictionary_index(
            np.ones((2, 4, 4)), np.ones((3, 4, 4))),
        lambda: importlib.import_module("kikuchipy_tpu_torch.parallel").multihost_dictionary_index(
            np.ones((2, 4, 4)), np.ones((3, 4, 4))),
        lambda: importlib.import_module("kikuchipy_tpu_torch.parallel").sharded_refine_orientation(
            kikuchipy_tpu_torch.EBSD(np.ones((2, 4, 4), np.uint8), device="cpu")),
        lambda: importlib.import_module("kikuchipy_tpu_torch.parallel").multihost_refine_orientation(
            kikuchipy_tpu_torch.EBSD(np.ones((2, 4, 4), np.uint8), device="cpu")),
        # Streamed indexing (the device is resolved before the file is read).
        lambda: importlib.import_module("kikuchipy_tpu_torch.io.streaming").dictionary_index_streamed(
            "scan.h5", np.ones((3, 4, 4))),
        # Neighbour averaging and the dot-product maps.
        *(
            (lambda name=name: getattr(importlib.import_module("kikuchipy_tpu_torch.ops.neighbours"), name)(
                np.ones((2, 2, 3, 3), np.uint8)))
            for name in ("average_neighbour_patterns", "neighbour_dot_product_matrices", "average_dot_product_map")
        ),
    ],
)
def test_entry_points_default_to_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def _ni_simulator():
    from kikuchipy_tpu_torch.crystallography.reciprocal import Lattice, ReciprocalLatticeVectors
    from kikuchipy_tpu_torch.simulation import KikuchiPatternSimulator

    ref = ReciprocalLatticeVectors.from_min_dspacing(Lattice(3.5236, 3.5236, 3.5236, 90, 90, 90), 1.5)
    ref.calculate_structure_factor([("ni", 0, 0, 0), ("ni", 0.5, 0.5, 0), ("ni", 0.5, 0, 0.5), ("ni", 0, 0.5, 0.5)])
    ref.calculate_theta(20.0)
    return KikuchiPatternSimulator(ref.allowed())


def _data_accessor_in_a_temporary_directory():
    # The small nickel scan's file, written by the port's save (on the CPU)
    # into KP_TPU_DATA_DIR; the accessor's load defaults to the card.
    import os
    import tempfile
    from unittest import mock

    pytest.importorskip("h5py")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "kikuchipy_h5ebsd" / "patterns.h5"
        path.parent.mkdir()
        kikuchipy_tpu_torch.EBSD(np.ones((2, 2, 4, 4), np.uint8), device="cpu").save(path)
        with mock.patch.dict(os.environ, {"KP_TPU_DATA_DIR": tmp}):
            kikuchipy_tpu_torch.data.nickel_ebsd_small()


def _sphere(x, *args):
    return (x * x).sum(dim=1) + sum(a.sum() for a in args)


@pytest.mark.parametrize("solver", ["differential_evolution_batched", "dual_annealing_batched",
                                    "basinhopping_batched", "shgo_batched"])
def test_global_solvers_run_where_their_tensors_are(monkeypatch, solver):
    # NumPy bounds and starts: the device of the objective's tensors.
    from kikuchipy_tpu_torch.utils import optimize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    box = dict(lower_bounds=-np.ones((2, 3)), upper_bounds=np.ones((2, 3)))
    kw = {"differential_evolution_batched": dict(box, max_iters=1), "dual_annealing_batched": dict(box, max_iters=1),
          "basinhopping_batched": dict(x0=np.full((2, 3), 0.5), niter=1, local_max_iters=2),
          "shgo_batched": dict(box, n_samples=4, n_starts=1, local_max_iters=2)}[solver]
    res = getattr(optimize, solver)(_sphere, args=(torch.zeros(1),), **kw)
    assert res.x.device.type == "cpu" and res.x.shape == (2, 3) and bool(torch.isfinite(res.fun).all())


def test_direction_cosines_default_to_the_ports_device():
    # Its default is the port's (utils/device.py: None, the card), as every
    # entry point's; on the CPU only when asked.
    import inspect

    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector

    assert inspect.signature(direction_cosines_from_detector).parameters["device"].default is None
    dc = direction_cosines_from_detector(kikuchipy_tpu_torch.EBSDDetector(shape=(4, 5)), device="cpu")
    assert dc.shape == (20, 3) and dc.device.type == "cpu"


def _jax_all(subpackage: str) -> list[str]:
    """``__all__`` of a JAX subpackage or top-level module, read from its
    source (no import)."""
    import ast

    names = []
    module = ROOT / "kikuchipy_tpu" / f"{subpackage.replace('.', '/')}.py"
    path = module if module.exists() else ROOT / "kikuchipy_tpu" / subpackage / "__init__.py"
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        target = node.targets[0] if isinstance(node, ast.Assign) else getattr(node, "target", None)
        if getattr(target, "id", None) == "__all__":
            names += [e.value for e in node.value.elts]
    return names


def _port_defines() -> set[str]:
    """Every public name a module of the port defines or exports."""
    names = set()
    for m in _modules():
        mod = importlib.import_module(m)
        names.update(getattr(mod, "__all__", ()))
        names.update(k for k, v in vars(mod).items() if getattr(v, "__module__", None) == m and not k.startswith("_"))
    return names


@pytest.mark.parametrize("subpackage", sorted(p.parent.name for p in (ROOT / "kikuchipy_tpu").glob("*/__init__.py"))
                         + ["pattern", "pattern_chunk", "simulations", "io.streaming", "parallel.mesh",
                            "parallel.multihost", "parallel.refine"])
def test_ported_names_are_in_the_same_subpackage(subpackage):
    # The port keeps the JAX package's public names where it has them: a
    # name of a JAX subpackage's (or top-level module's) __all__ that the
    # port defines anywhere is importable from the port's subpackage or
    # module of the same name.
    ported = [name for name in _jax_all(subpackage) if name in _port_defines()]
    if not ported:
        return
    mod = importlib.import_module(f"kikuchipy_tpu_torch.{subpackage}")
    missing = [name for name in ported if not hasattr(mod, name)]
    assert not missing, (subpackage, missing)
    assert set(ported) <= set(getattr(mod, "__all__", ())), subpackage


@pytest.mark.parametrize("module", ["parallel", "parallel.mesh", "parallel.multihost", "parallel.refine",
                                    "io.streaming", "native"])
def test_scale_out_modules_keep_jax_signatures(module):
    # JAX's arguments in JAX's order for every name both define; the port
    # adds only `devices=None` (or `device=None`), at the end or before a
    # **kwargs.
    import inspect

    jax_mod = importlib.import_module(f"kikuchipy_tpu.{module}")
    port = importlib.import_module(f"kikuchipy_tpu_torch.{module}")
    assert set(jax_mod.__all__) <= set(port.__all__), module

    def params(obj):
        out = [(p.name, p.kind, p.default) for p in inspect.signature(obj).parameters.values()]
        return [p for p in out if not (p[0] in ("device", "devices") and p[2] is None)]

    for name in jax_mod.__all__:
        assert params(getattr(port, name)) == params(getattr(jax_mod, name)), (module, name)
    added = {name: [p for p in inspect.signature(getattr(port, name)).parameters
                    if p in ("device", "devices") and p not in inspect.signature(getattr(jax_mod, name)).parameters]
             for name in jax_mod.__all__}
    assert {k: v for k, v in added.items() if v} == {
        "parallel": {"multihost_mesh": ["devices"], "multihost_refine_orientation": ["devices"]},
        "parallel.multihost": {"multihost_mesh": ["devices"], "multihost_refine_orientation": ["devices"]},
        "io.streaming": {"dictionary_index_streamed": ["device"]},
    }.get(module, {}), module


@pytest.mark.parametrize(
    "wrapper, args, kw",
    [
        (nt.ncc_match_topk_int8, lambda e, w: (e.to(torch.int8), w.to(torch.int8), torch.ones(32)), {}),
        (nt.ncc_match_topk_f32, lambda e, w: (e, w), {}),
        # v3's default tile_d = 1200 is no multiple of 128: the TPU
        # function raises for its own default, and so does the port.
        (nt.ncc_match_topk_f32_blocked, lambda e, w: (e, w), {"tile_d": 128}),
        (nt.ncc_match_topk_bf16, lambda e, w: (e, w), {}),
    ],
)
def test_wrappers_on_cpu_do_not_count_launches(wrapper, args, kw):
    rng = np.random.default_rng(0)
    e = torch.from_numpy(rng.integers(-127, 128, (8, 128)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (32, 128)).astype(np.float32))
    before = wrapper.launches
    wrapper(*args(e, w), k=4, tile_n=8, tile_m=32, **kw)
    assert wrapper.launches == before


def test_vote_wrapper_on_cpu_is_plain_and_does_not_count_launches():
    from kikuchipy_tpu_torch.ops import hough_vote as hv

    rng = np.random.default_rng(2)
    normals = torch.as_tensor(rng.normal(size=(5, 6, 3)), dtype=torch.float32)
    normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True)
    g = torch.eye(3)
    args = (normals, g, torch.tensor([np.pi / 2] * 3, dtype=torch.float32),
            torch.tensor([[0, 1], [0, 2], [1, 2]], dtype=torch.int32),
            torch.tensor([[0, 1], [0, 2], [1, 2]], dtype=torch.int32), 0.05)
    before = hv.vote_orientations.launches
    got = hv.vote_orientations(*args)
    assert hv.vote_orientations.launches == before
    for a, b in zip(got, hv.vote_orientations_plain(*args)):
        assert torch.equal(a, b)


def test_split_pass_on_cpu_is_plain_and_does_not_count_launches():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 70)).astype(np.float32))
    before = nt.tf32_rows.launches
    assert torch.equal(nt.tf32_rows(x), nt.tf32_rows_plain(x))
    assert nt.tf32_rows.launches == before
    with pytest.raises(TypeError):
        nt.tf32_rows(x.double())
    assert "tf32_split_kernel" in _build.sources()["ncc_topk_f32"].read_text()


def test_kernel_sources_and_build_directory():
    srcs = _build.sources()
    assert set(srcs) == {"ncc_topk_int8", "ncc_topk_bf16", "ncc_topk_f32", "lambert_project", "refine_nm", "refine_lm",
                         "background", "clahe", "refine_population", "neighbours", "hough_vote"}
    text = {name: path.read_text() for name, path in srcs.items()}
    # Kernel D replaces _remove_background and the separable blur, kernel E
    # _clahe_batch with its blend weights; both without fast math.
    for what in ("background_kernel", "_remove_background", "separable_filter", "__fdiv_rn"):
        assert what in text["background"], what
    for what in ("clahe_kernel", "_clahe_batch", "_blend_weights", "atomicAdd"):
        assert what in text["clahe"], what
    # Kernel G replaces _average_impl of neighbour averaging, without fast
    # math, on the preprocessing kernels' typed loads and stores.
    for what in ("neighbours_kernel", "_average_impl", "__dadd_rn", "__fdiv_rn", "kMaxTaps", "table_w", "work_blocks"):
        assert what in text["neighbours"], what
    # Kernel H replaces the vote's einsums (XLA code, no TPU kernel) with the
    # triads, the LUT scan by ballots and a block argmax.
    for what in ("hough_vote_kernel", "_vote_orientations", "_triad", "__ballot_sync", "kTile", "acosf"):
        assert what in text["hough_vote"], what
    # The wrappers' limits are the sources': taps passed as launch arguments;
    # kernel H's shared memory read from the source's own layout.
    from kikuchipy_tpu_torch.ops import neighbours as ng

    assert f"constexpr int kMaxTaps = {ng.MAX_TAPS};" in text["neighbours"]
    assert 'extern "C" long long hough_vote_smem_bytes(' in text["hough_vote"]
    assert "hough_vote_smem_bytes" in (PKG / "ops" / "hough_vote.py").read_text()
    for name in ("background", "clahe", "neighbours"):
        assert '#include "pattern_io.cuh"' in text[name], name
    # The projection kernels replace XLA code: project_patterns, and
    # _project_at + _ncc_centered of the refinement objectives; the
    # Nelder-Mead kernel the while_loop of nelder_mead_batched over
    # _objective_orientation; the tangent kernel jac_and_res over the
    # residuals' _project_at. All four share one projection.
    for what in ("lambert_project_kernel", "lambert_project_ncc_kernel", "project_patterns", "_ncc_centered"):
        assert what in text["lambert_project"], what
    for what in ("refine_nm_kernel", "nelder_mead_batched", "_objective_orientation", "atomicAdd", "cp.async"):
        assert what in text["refine_nm"], what
    for what in ("refine_lm_kernel", "jac_and_res", "_project_at", "pc_direction"):
        assert what in text["refine_lm"], what
    # Kernel F replaces the global solvers' population evaluations over the
    # same objectives, and evaluates with the Nelder-Mead kernel's own code.
    for what in ("refine_population_kernel", "eval_pop", "_objective_orientation", "_objective_pc", "_objective_joint"):
        assert what in text["refine_population"], what
    objective = (PKG / "csrc" / "refine_objective.cuh").read_text()
    assert '#include "lambert_common.cuh"' in objective and "float evaluate(" in objective and "cp.async" in objective
    for name in ("refine_nm", "refine_population"):
        assert '#include "refine_objective.cuh"' in text[name] and "float evaluate(" not in text[name], name
    for name in ("lambert_project", "refine_lm"):
        assert '#include "lambert_common.cuh"' in text[name], name
    # One pixel for kernels A, B, C, F, the Nelder-Mead kernel and the LM
    # loop kernel, in the shared header; kernel C's with its gradient.
    for name in ("lambert_project", "refine_nm", "refine_lm", "refine_population"):
        assert "float lambert_pixel(" not in text[name] and "Tap lambert_tap(" not in text[name], name
    lambert = (PKG / "csrc" / "lambert_common.cuh").read_text()
    assert "float lambert_pixel(" in lambert and "Tap lambert_tap(" in lambert
    assert "float lambert_pixel_grad(" in lambert and "lambert_pixel_grad(" in text["refine_lm"]
    assert "float project_pixel(" not in lambert and "project_pixel_a(" not in lambert
    assert "project_pixel_grad" not in text["refine_lm"] + lambert and "struct Rot " not in lambert
    assert "--use_fast_math" not in " ".join(_build.NVCC_FLAGS)
    assert "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8" in text["ncc_topk_int8"]
    assert "ncc_match_topk_pallas_v5" in text["ncc_topk_int8"]
    assert "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16" in text["ncc_topk_bf16"]
    assert "ncc_match_topk_pallas_v4" in text["ncc_topk_bf16"]
    assert "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32" in text["ncc_topk_f32"]
    assert "ncc_match_topk_pallas (v1" in text["ncc_topk_f32"] and "ncc_match_topk_pallas_v3" in text["ncc_topk_f32"]
    # All three kernels share the wgmma frame and, through it, the one
    # selection. No mma.sync product, no SIMT product and no cp.async ring
    # is left.
    frame = (PKG / "csrc" / "ncc_wgmma.cuh").read_text()
    assert '#include "topk_select.cuh"' in frame and "cp.async.bulk.tensor.2d" in frame and "mbarrier" in frame
    common = (PKG / "csrc" / "ncc_common.cuh").read_text()
    for name in ("ncc_topk_int8", "ncc_topk_bf16", "ncc_topk_f32"):
        assert '#include "ncc_wgmma.cuh"' in text[name], name
        for gone in ("mma.sync.aligned", "fmaf(", "cp.async.cg"):
            assert gone not in text[name] + frame + common, (name, gone)
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "kikuchipy_tpu_torch/_kernels_build/" in ignored


def test_no_kernel_source_calls_a_library():
    csrc = PKG / "csrc"
    for path in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        t = path.read_text().lower()
        for name in ("cublas", "cutlass", "cudnn", "torch/"):
            assert name not in t, (path.name, name)


def test_python_k_limit_is_the_kernels():
    header = (PKG / "csrc" / "topk_select.cuh").read_text()
    assert f"constexpr int MAX_K = {nt.MAX_K};" in header


def test_a_changed_header_rebuilds(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// kernel")
    (tmp_path / "h.cuh").write_text("// header")
    monkeypatch.setattr(_build, "_SRC_DIR", tmp_path)
    before = _build._target(src)
    (tmp_path / "h.cuh").write_text("// header, changed")
    assert _build._target(src) != before


def test_chip_smoke_refuses_without_a_card(tmp_path):
    # Alone in a directory (no checkout beside it) it must fail, and print
    # no result; here there is no card either.
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
