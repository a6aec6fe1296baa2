"""Drive kikuchipy_tpu_torch's paths once on a CUDA card and check them.

    python3 chip_smoke.py [--seed 0]

Phases, one output line each (the last three lines are the kernel table,
the card's name and power limit, and the device check):

1. device: ``nvidia-smi`` name and power limit, and torch's device name;
2. build: every kernel under ``kikuchipy_tpu_torch/csrc`` with ``nvcc``,
   one process per source, all started together;
3. int8 kernel against its plain version, bit for bit: small cases with
   planted ties, k of 1, 40, 130 and 512, groups of 1, 3, 16, 256 and 512,
   fewer candidates than k ending in float32-min slots, the "fori" and
   "none" extractions, the shapes that are ragged against the wgmma
   kernels' 128-row x 256-candidate block (n of 8, 72 and 136, m a
   multiple of 32 only, row bytes no multiple of 128, duplicate rows on
   both sides of a slice, each kernel's chunk and a warpgroup), and a
   slab at the main-path shape;
4. f32 and bf16 kernels against their plain versions (float64 sums)
   modulo near-ties (``ncc_topk.near_tie_disagreements``, tol 1e-5 on
   unit-norm rows): planted duplicate rows in column order, the same
   ragged shapes, k of 1 to 512, every extraction, for f32 (three TF32
   products on split operands) rows that differ only below TF32's 10
   mantissa bits and the split of the main path's rows itself, then a
   1024-row slab of the main path's own prepared rows;
5. the main path at full size, from a seed: a synthetic m-3m master
   pattern (401 x 401 per hemisphere), a 60 x 60 detector, a 2-degree
   fundamental-zone dictionary (107,129 orientations), a 128 x 128 uint8
   scan at known orientations -> static and dynamic background removal
   -> dictionary projection (one launch of the projection kernel
   ``lambert_project``) -> ``EBSD.dictionary_indexing(precision=
   "pallas-int8", keep_n=20)`` -> ``CrystalMap``. Checks: the kernels ran,
   top-1 equals the exact ``"highest"`` tier wherever the exact top-1/
   top-2 gap exceeds 1e-4, and the orientations are recovered (median
   disorientation < 3 degrees, > 90% under 8 degrees); then keep_n=65,
   which carries k=130 candidates through the kernel. The two removals
   are one launch each of kernel D (``csrc/background.cu``, through
   ``ops/background.py`` ``remove_background``);
5a. preprocessing (``[preprocess-check]``, ``[preprocess]``,
   ``[preprocess-times]``): kernel D in both modes against its plain
   version on the whole scan (uint8 and float32 outputs, division,
   ``scale_bg``, a ragged 57 x 61 crop; static bit for bit, dynamic within
   one gray level on at most 1% of the pixels) and kernel E (CLAHE,
   ``csrc/clahe.cu`` through ``ops/ahe.py`` ``clahe``) against its plain
   version (the defaults, ``clip_limit=0.02``, 7 x 7 tiles with the reflect
   pad, uint16 input; one gray level on at most 1%); then BASELINE config
   3's chain, kikuchipy's tutorial settings (static and dynamic removal, a
   lowpass x highpass band-pass in the frequency domain, a spatial
   Gaussian, CLAHE, normalization to float32) through ``EBSD`` on the
   16,384-pattern scan and on it tiled 4x (65,536 patterns, 236 MB): MB/s
   of uint8 in for each step and the chain, kernel D's and E's launches,
   the device busy share under ``torch.profiler``, and the output's check
   (float32, finite, zero mean and unit deviation); then D's two modes and E
   at the main path's shape, warm and with the L2 flushed, with their
   bounds (each one's issue slots from ``sass_count.py``'s ``clahe_pixel``,
   ``static_pixel`` and ``dynamic_steps``, counted on the kernels
   themselves), each one's kernel (D static's warp kernel, D dynamic's and
   E's pair kernels, each held byte for byte to the block kernel and timed
   beside it), D static's time on 65,536 patterns, and the plain versions;
5b. the projection kernels against their plain twins: ``lambert_project``
   against the twin run in float64 on the whole dictionary, a rescaled
   slab, one PC per rotation, a ragged pixel count, one rotation and pixels
   within 1e-3 rad of a Lambert pole, no further from it than the float32
   twin is (``Float64Yardstick``: pooled max, RMS and taps off float64's;
   each case within 1e-4 of the range); ``lambert_project_ncc``
   (1 - NCC within 2e-6) on a 2048-point chunk of the main path's patterns
   with shared, masked and per-point direction cosines, P=1000, and B=1;
5c. refinement of the main path's crystal map: ``EBSD.refine_orientation``
   at its defaults (Nelder-Mead, bilinear, max_iters=150) from the
   pallas-int8 top-1 on all 16,384 patterns, static background removed
   (the synthetic scan has no dynamic one, and the dynamic removal moves
   the optimum off the truth: that run is printed, unchecked); checks that
   it ran as launches of the Nelder-Mead kernel (``nelder_mead_orientation``,
   ``csrc/refine_nm.cu``) and none of kernel B, that the median
   disorientation to the truth fell, and that it is under 0.8 degrees at
   every point DI put within 3 degrees. Then the kernel against the host
   loop on kernel B (``nelder_mead_batched`` over ``_objective_orientation``,
   chunks of 2048) on the same inputs: on at least 99% of the points equal
   iterations, 1 - NCC within 1e-5 and results within 0.05 degrees, the
   mean score no lower by more than 1e-6; the same on a chunk with a trust
   region, a signal mask, P=1000 and one PC a point, on one point, and on
   48 points of a 240 x 240 detector (past the shared-memory budget).
   Times: the kernel on the whole map (CUDA events), the host loop's run,
   patterns/s of both, the evaluations, the bound (operations, L2 taps and
   instruction slots), a ``torch.profiler`` trace of the call (device busy share),
   and kernel B's time a launch (now only the host loops' engine); then
   ``refine_projection_center`` (from the refined orientations) and
   ``refine_orientation_projection_center`` (from the DI top-1) on all
   16,384 static-corrected patterns from a PC off by (0.01, -0.01, 0.01):
   each one launch of its mode of the Nelder-Mead kernel and none of kernel
   B, the mean refined PC within 2e-3 of the truth, the joint mode's
   disorientation beside the orientation mode's; each mode's kernel against
   its host loop on kernel B on one 2,048-point chunk and on the edge cases
   (a trust region, a signal mask, P=1000, one point, 48 points of a 240 x
   240 detector) with the same criteria and PC within 1e-5; times of both
   modes on the whole map (kernel, evaluations, bounds, patterns/s of the
   call, busy share under ``torch.profiler``, the host loop on its chunk);
5d. Levenberg-Marquardt and gradient refinement of the same map in every
   mode (``[refine-lm]``, ``[refine-grad]``): each ``EBSD.refine_*`` call
   with ``method="lm"`` from Nelder-Mead's starts is one launch of the LM
   loop kernel (``csrc/refine_lm.cu`` ``refine_lm_loop_kernel``, through
   ``ops/refine_lm.py``'s ``levenberg_marquardt_*`` wrapper of the mode) and
   no launch of kernel C or any other kernel; with ``"gradient"`` it is
   launches of kernel C (the tangent kernel, through the mode's
   ``tangent_*`` wrapper) alone; every call passes Nelder-Mead's gates;
   patterns/s of the call, launches, ms a launch, the device busy share
   under ``torch.profiler`` and, for "lm", the evaluations and the loop
   kernel's ms against its issue-slot and L2-taps bounds. ``[lm-check]``:
   kernel C against its plain version at the same points on one 2,048-point
   chunk in every mode (all pixels, a signal mask, P=1000; orientation mode
   also one PC a point and pole rotations): kernel C's projected pattern
   equal to kernel A's ``lambert_project`` bit for bit (the PC modes on
   ``pc_direction_cosines``' rows); f, ``J^T r`` and ``J^T J`` no further
   from the plain version run in float64 than twice the float32 one (or
   2e-6, 1e-4 of the norms); against the float32 one f within 2e-6 (in the
   pole case, where the float32 one is itself more than 2e-6 off float64,
   printed as not met and held to float64 instead) and the distances of
   ``J^T r``, ``J^T J`` printed; the pole case on a line of its own; then
   whole LM runs on both over the chunk, their mean
   float64 0.5 ||r||^2 within 1e-6. ``[lm-loop-check]``: the LM loop kernel
   against the host loop on kernel C at the whole map in every mode, at
   refine_*'s settings: 0.5 ||r||^2 within 1e-5, rotations within 0.05
   degrees and PCs within 1e-4 on at least 99% of the points, iterations
   equal on at least 90%, all finite; the times of both, the evaluations,
   the share bit for bit, and the share of the first step's systems that the
   kernel solves as ``torch.linalg.solve_ex`` bit for bit. ``[lm-times]``:
   one launch of kernel C at the whole map, its bounds, and the plain
   version on a chunk;
5e. the spherical-harmonic tier (``[refine-sh]``, ``[refine-sh-times]``,
   ``[refine-sh-pc]``, ``[refine-sh-joint]``): each ``EBSD.refine_*`` mode
   with ``projector="spherical"``, ``sh_L=88``, ``sh_precision="default"``
   and ``method="lm"`` on the whole static-corrected map, from the DI top-1
   (orientation, joint) or Nelder-Mead's orientations (PC) and a PC off by
   (0.01, -0.01, 0.01): the one-time costs (the analysis, one launch of
   kernel A; the synthesis basis; the PC bases), the call's ms and
   patterns/s beside the bilinear LM call's, its busy share under
   ``torch.profiler``, its peak memory, and the launches (kernel B for the
   scores, the LM loop kernel in the PC and joint polish, nothing else).
   Kernel A at the analysis's shape (one rotation, 401 x 802 quadrature
   directions) against the plain twin in float64: the samples within its
   per-case limit of 1e-4 of the master's range, and the coefficients
   within the bound that limit gives them. Kernel B at the PC modes' shape
   (the whole map, one PC a point) against its plain twin within 2e-6 on
   the phases' own solutions, whose scores it gives again. Orientation
   mode takes as many whole 2,048-point chunks a batch as half the free
   memory holds, and each point's share of the peak must stay within the
   bytes that cap allows it. Gates: orientation under 0.8 degrees where DI
   came within 3, also at ``sh_precision="highest"`` and with ``"nm"`` and
   ``"gradient"`` on the first 2,048 points; mean PC within 2e-3 of the
   truth; the joint mode's mean score no lower than the bilinear joint LM's
   less 5e-3. At one batch of the orientation call: an LM evaluation, the
   residual, the zyz rotation, a Z and a T stage, and the
   synthesis product in TF32 and float32 against its FLOP bounds, and one
   evaluation's device time by kind of kernel beside the host's; the PC
   modes' product with the PC-linearized basis;
5f. the global solvers on kernel F (``csrc/refine_population.cu``, through
   ``ops/refine_population.py``) and the Nelder-Mead kernel:
   ``[population-check]`` holds kernel F at the shapes the global phases
   give it (one 2,048-point chunk at M = 1 and 24 in each mode, orientation
   mode also with one set of direction cosines a point; the whole map at
   M = 1 and 16 in the PC modes and at SHGO's M = 65 in every mode, a
   partial last group), on a chunk at every group the plan can choose
   (forced), at the three spreads of ``POP_SPREADS`` and with ``live``
   masks (alternate points, none), bit for bit against the objectives of
   ``ops/refine_nm.py`` (``+inf`` where ``live`` is false) and within 2e-6
   of its plain version (kernel B's criterion);
   ``[refine-global]``, ``[refine-global-pc]`` and ``[refine-global-joint]``
   run each ``EBSD.refine_*`` with ``method`` "de", "da", "bh" and "shgo" on
   the whole static-corrected map (trust regions of 3 degrees and 0.02; the
   PC modes from the PC off by (0.01, -0.01, 0.01)): launches of kernel F and
   the Nelder-Mead kernel alone (kernel F none for "bh"), no point below its
   start's score (exact: kernel F's value at the start), orientation under
   0.8 degrees where DI came within 3 and the box of Euler angles about the
   start holds the truth (at small Phi such a box can leave out a rotation 3
   degrees away; the log gives the starts' Phi and the boxed Nelder-Mead's
   results on the box's edge on both sides), PC inside the trust region and
   its mean within 2e-3 of the truth (PC mode), the joint mean score no
   lower than the joint Nelder-Mead's in the same box less 1e-3, and DE's
   than Nelder-Mead's from the same starts less 1e-3; each call's time,
   patterns/s, busy share,
   generations or iterations and kernel F's launches and ms a launch; each
   DE call also its live share by generation (the points it still runs,
   kernel F's ``live``), kernel F's summed ms and the call's ms;
   ``[population-times]`` times kernel F at one DE generation of the whole
   map at each spread of ``POP_SPREADS`` against its bounds (issue slots,
   scattered taps) and plain version, beside the 32-byte sectors a
   member-pixel reads at the plan's group and at one member a block (the
   plain twin's taps on 64 points), and at populations recorded from the DE
   call (generation 0, a middle one, the last, with their live masks), and
   holds each as ``[population-check]`` does;
5g. the workflow around the main path: ``[sampling]`` runs
   ``sample_fundamental_zone`` and ``get_sample_fundamental`` at the main
   path's 2 degrees on the card (three calls each, the counts 107,129 and
   95,655, the device busy share, the kept rows equal to the CPU's at 6
   degrees); ``[neighbours]`` runs ``EBSD.average_neighbour_patterns`` on
   the 16,384-pattern scan (one launch of kernel G, ``csrc/neighbours.cu``
   through ``ops/neighbours.py`` ``average_neighbours``, and nothing else:
   its vector kernel's 5-tap integer route) and holds kernel G bit for bit
   against its plain version with seven windows there (negative weights
   among them), on maps of 1 x 1, 1 x 128, 128 x 1, 3 x 3 and 9 x 11 with
   60 x 60, 1 x 16 and 7 x 9 patterns (no whole 16-byte vectors: the
   general kernel), on data a byte past a 16-byte boundary, and from and
   to uint16 and float32, each call on the route ``neighbours_plan``
   names; also with 13 x 13 rectangular and Gaussian windows on the scan
   (169 taps, past the 128 passed as launch arguments: the device table)
   and on a 16 x 16 map of 480 x 480 uint8 patterns (59 MB; float32
   averages past the shared-memory budget: the general kernel's
   device-memory scratch); ``[neighbours-times]`` times it warm and with
   L2 flushed against its bytes and issue-slot bounds (and beside the
   0.5445-0.5634 ms of the block-a-point kernel before the redesign), its
   plain version and a depthwise ``conv2d`` that computes the same weighted
   mean (timed only), the float64 route at 9 taps, and the wide windows
   and the large patterns; ``[calibration]``
   takes the PC mode's refined PCs through ``extrapolate_pc`` and
   ``fit_pc`` (the fitted plane within the refined PCs' scatter of the
   extrapolated one, the sample tilt within a degree), projects the map
   with the fitted PCs (one launch of kernel A; its first 256 patterns
   within one gray on at most 1% of the pixels of the CPU's), merges the
   main path's map with a DI map against a 4-degree cubochoric dictionary
   tagged as a second phase (the merged phase the per-point best mean of
   three scores) and holds the OSM of the main path's map and of a map of
   8 x 8-point grains made from its lists against a direct count at 64
   points (the grains' insides at ``keep_n``);
5h. Hough indexing (``[hough-check]``, ``[hough]``, ``[hough-pc]``):
   ``EBSD.hough_indexing`` with nickel (space group 225, a = 3.5236, the four
   fcc atoms) at n_bands=9 on JAX's four-pattern case (gated on its
   criterion: every disorientation under 1 degree, at least 3 inlier bands),
   on 1,024 clean simulated patterns of a master whose bands have Kikuchi
   width (the same gate) and of the main path's master (at least 95% under 1
   degree), and on the main path's 16,384 noisy patterns after static and
   dynamic removal (median disorientation under 1 degree; the share under 2
   printed): one launch of kernel H (``csrc/hough_vote.cu`` through
   ``ops/hough_vote.py`` ``vote_orientations``) a call and no plain vote; the
   first call (the host's operator build) and warm calls, the call's stages,
   its ``torch.profiler`` trace, device busy share and peak memory;
   ``[hough-check]`` holds kernel H against ``vote_orientations_plain`` on
   the scan's normals (``hough_check`` through
   ``hough_vote.vote_disagreements``: the clear, near-tie and
   inlier-boundary patterns counted, and the largest R and err differences
   to what each is held against); kernel H's time warm and cold against its operations
   and issue-slot bounds, with its block shape and pole route; ``[hough-pc]`` runs
   ``hough_indexing_optimize_pc(batch=True)`` on JAX's four-pattern case
   (largest PC error under 1.2e-2) and on the scan from the PC off by (0.01,
   -0.01, 0.01) (the mean error below the start's);
6. the fused-kernel entry points at full size: the main path's prepared
   scan (16,384 x 3600) and its ``PreparedDictionary`` rows [:107,008]
   through each of the four wrappers at k=40, every launch counter > 0,
   top-1 (int8: after an exact rescore of its k candidates) equal to the
   exact tier's on clear-gap patterns, recovery, and every row against
   the plain versions (f32/bf16 modulo near-ties, int8 bit for bit);
7. ``dictionary_indexing`` at every tier (high, default, f16, mixed,
   int8; approx_topk False and True) and one fused
   ``dictionary_index(project_fn=mp.projector(det), precision="f16",
   approx_topk=True)`` call: top-1 against the exact tier, recovery, ms;
8. times from CUDA events after a warm-up, beside the card's name and
   power limit: each kernel at the main-path shape with its bound, its
   plain version and two library yardsticks (the product alone, and the
   same function from library calls: per 32,768-column tile a product,
   ``torch.topk`` and a merge), the bytes its tile moves from L2 to shared
   memory and the time that takes at the L2 read rate measured here; for
   f32 the split of the operands (a hand-written pass of its own, listed
   as ``tf32_rows``) and the kernel on split operands apart (the entry
   point's time holds both); the two projection kernels with their bounds
   (bytes, float32 operations, and the taps' bytes from L2) and plain
   twins, the Nelder-Mead kernel's three rows from 5c, each with its
   instruction-slot bound (``sass_count.py``'s SASS instructions a pixel at the
   card's largest clock); then a breakdown of
   one pallas-int8 indexing call and a
   ``torch.profiler`` trace of it, and a trace of one ``get_patterns`` call
   (the dictionary's generation: device busy time, kernels and host time);
9. reading and writing scans (``[io]``, ``[lazy]``, in a temporary
   directory): the main path's scan tiled 2 x 2 on the map (256 x 256
   patterns, 236 MB) ``save``d to a NORDIF .dat and ``load``ed to the card
   (bytes equal, host seconds and MB/s, the file's pages warm), a
   synthesized EDAX .up2 (uint16) and Oxford .ebsp (version 5, out of map
   order) to the card byte for byte, a kikuchipy h5ebsd round trip where
   ``h5py`` imports; then ``load(..., lazy=True)`` of the .dat through both
   removals and ``compute`` at chunk sizes 1024 and 8192, byte for byte the
   eager chain on kernel D, with ms, MB/s and peak device memory beside the
   eager chain's; static removal and neighbour averaging lazily (halo rows,
   kernel G) byte for byte the eager chain; streamed ``int8``
   ``dictionary_indexing`` of the main path's 16,384 patterns from their own
   .dat (indices equal to the eager call's, scores within 1e-6; the
   streamed path has no ``pallas-int8``, as in JAX); streamed
   ``refine_orientation`` of 2,048 of them against the eager call (within
   1e-5 and bit for bit, the Nelder-Mead kernel refining each point alone);
   and the lazy chain's host copy and host-to-device copies timed apart;
10. the kinematical simulation, decomposition, virtual BSE imaging and
   profiling: ``[simulation]`` builds nickel's reflectors to 0.5 A at 20 kV,
   runs ``KikuchiPatternSimulator.calculate_master_pattern(half_size=500,
   hemisphere="both")`` on the card (ms, peak memory, the band
   accumulation's product, ``acos`` and a copy pass at one block's shape
   against its bytes), holds 64 rows of each hemisphere against a float64
   recomputation on the host (the band-edge rule: equal within float32's
   summation bound except where a reflector's angle lies within 1e-6 rad of
   a band edge, those pixels under 0.5%), re-projects it (``as_lambert``),
   holds kernel A on it against the float64 twin (the same yardstick as
   5b), makes the 2-degree dictionary (one launch of kernel A) and 4,096
   noisy uint8 patterns at seeded orientations, indexes them with
   ``pallas-int8`` (median disorientation under 3 degrees, more than 90%
   under 8) and runs ``on_detector`` for the 4,096 orientations on the
   host; ``[decomposition]`` times ``torch.linalg.svd`` with each of
   cuSOLVER's drivers on the main path's 16,384 x 3600 float32 matrix and
   holds each against a float64 host reference (the Gram matrix's
   eigendecomposition), then runs ``EBSD.decomposition(output_dimension=10)``
   and ``get_decomposition_model(10)`` on the driver kept
   (``ops/decomposition.py`` ``SVD_DRIVER``): factors orthonormal within
   1e-4, explained-variance ratios within 1e-4 of float64's, the float32
   residual within 1e-3 (relative) of the float64 rank-10 residual, the
   uint8 model within one gray level on at most 1% of the pixels of the
   float64 model rescaled the same way; ``[vbse]`` sums the 128 x 128 scan's
   5 x 5 tiles on the card (``VirtualBSEImager.get_images_from_grid``), bit
   for bit a host NumPy sum, and an RGB image of three tiles equal to the
   host's; ``[profiling]`` wraps one ``pallas-int8`` indexing call in
   ``utils/profiling.py`` ``trace``, in a process of its own
   (``--profiling-trace DIR``), and finds the int8 kernel in the trace
   file;
11. the scale-out modules, on the one card: ``[parallel]`` runs
   ``sharded_dictionary_index`` of the 16,384 corrected patterns against the
   main path's ``PreparedDictionary`` at "int8" on meshes (1, 1), (2, 2) and
   (1, 4) of ``cuda:0`` (the last pads the dictionary by 3) and at "highest"
   on (2, 2) for 4,096 patterns, each against the single-device
   ``dictionary_index`` of the same tier (at "int8" all 20 indices equal
   and scores within 1e-6; at "highest" top-1 equal wherever its top-1/
   top-2 gap exceeds 1e-5, the rows below it counted, and scores within
   1e-5), ``sharded_fused_dictionary_index`` over 107,008 rotations on
   (2, 2) and (1, 1) (kernel A once a block) against each other and against
   ``dictionary_index(project_fn=...)`` at "highest" (the "highest" gate),
   and the three sharded Nelder-Mead refinements on (4, 1) against the
   single-device calls, bit for bit, one launch a shard; ``[multihost]``
   starts the CPU test's worker (``tests/_torch_multihost_worker.py``) twice
   in a gloo group on loopback, both ranks on the card (NCCL takes no two
   ranks on one card), each indexing its host slice of 16,383 patterns (its
   block, then gathered) and refining it (LM, gathered) against the
   single-process calls (the "highest" gate; refinement bit for bit); a
   worker that fails or overruns fails the run; ``[streaming]`` runs
   ``io/streaming.py`` ``_index_chunks`` over a memory map of the scan tiled
   4x (65,536 raw patterns) at chunks of 4,096, "int8", against the eager
   call and ``LazyEBSD.dictionary_indexing`` (indices equal), a run cut
   after 4 chunks and resumed from its checkpoint, and kernel D's static
   removal a chunk on the card against the same removal on the host (the
   HDF5 reader in front of the loop needs ``h5py``, which the card's
   machine lacks, and is not run); ``[native]`` builds ``native/loader.cpp``
   with g++, holds ``preprocess_u8`` within 2e-6 of kernel D's float32
   output on the 16,384 patterns and times its loops beside NumPy's.

Each path is driven with every launch counter set to 0 just before it
and read just after; a kernel's ``launches`` in the table is the count
of the path its row names (the main path's where it runs there), and
``launches_by_path`` gives each path's own count beside it. Exits non-zero without a CUDA device, when run
outside a checkout of the repository, or when any check fails. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# Card peaks for the bound (H100 SXM data sheet, dense): int8, bf16 and
# TF32 tensor-core operations per second, and device-memory bytes per
# second. The f32 kernel does three TF32 products for one f32 product.
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# float32 outside the tensor cores (the projection kernels' arithmetic).
PEAK_F32_FLOPS = 67e12
# Floating-point operations of one projected pixel as lambert_pixel in
# csrc/lambert_common.cuh does them (kernels A, B, F and the Nelder-Mead
# kernel), an FMA counted as two: rotation 15, the coordinate's magnitude 14
# (two reciprocal square roots), the major component and the ratio 5 (one
# reciprocal), atan 19, the two coordinates 4, indices and weights 10, the
# tap address 4, the blend 9; the NCC adds 4 a pixel (centre, two products
# summed, the mean's sum).
OPS_PER_PIXEL = 80
NCC_OPS_PER_PIXEL = 4
# ... and kernel C's value (lambert_pixel's, through lambert_pixel_grad of
# csrc/lambert_common.cuh), and its gradient with respect to the rotated
# direction: the slopes along the two texel coordinates 5, u's factor 9, the
# minor coordinate's along t 7 (one reciprocal), their sum along o 9.
LM_VALUE_OPS_PER_PIXEL = OPS_PER_PIXEL
LM_GRAD_OPS_PER_PIXEL = 30
# ... and of one pixel's direction cosine from a candidate PC, as
# pc_direction in csrc/lambert_common.cuh does them (the PC and joint
# modes): the pixel's x and y 4 each, the rotation into the sample frame 15,
# the squared norm 5, its square root 1 and three divides.
DC_OPS_PER_PIXEL = 32
# SASS instructions of one pixel on the main path of its code (sass_count.py
# on sm_90a; the IEEE slow paths not counted): lambert_pixel (kernels A, B,
# F and the Nelder-Mead kernel), and the direction cosine from a PC before
# it (pc_direction); one pixel of a Nelder-Mead evaluation (nm_eval_pixel:
# the pixel, with the tap cache or without, the pattern's store, both
# passes' sums) in orientation and PC mode (joint mode's pixel is PC
# mode's). The run recounts them where the toolkit has cuobjdump and uses
# its count.
SASS_PER_PIXEL = 78
SASS_DC_PER_PIXEL = 92
SASS_NM_EVAL_PER_PIXEL = {"orientation_cache": 115, "orientation": 97, "pc_cache": 207, "pc": 188}
# ... and one member-pixel of kernel F's member groups in each mode
# (sass_count.py population_pixel: the pixel, the pattern's store, both
# passes' sums; joint mode's code is PC mode's).
SASS_POP_PER_PIXEL = {"orientation": 97, "pc": 188, "joint": 188}
# ... and kernel C's pixel in each mode (csrc/refine_lm.cu Pixel: the value
# and its gradient with respect to the rotated direction, lambert_pixel_grad,
# then the d tangents; in the PC modes after the direction cosine), without
# its passes' sums.
SASS_LM_PER_PIXEL = {"orientation": 161, "pc": 251, "joint": 270}
# ... and one pixel of a whole evaluation (kernel C's and the LM loop
# kernel's tangent_point): that pixel and its three passes' sums
# (sass_count.py lm_eval_pixel).
SASS_LM_EVAL_PER_PIXEL = {"orientation": 225, "pc": 315, "joint": 377}
# Instruction slots of an SM: four warp schedulers, one warp instruction each a
# clock (the Hopper architecture white paper), at the card's largest SM
# clock (nvidia-smi clocks.max.sm in the run).
WARP_INSTR_PER_SM_CLOCK = 4
# SASS instructions of one pixel of kernel E on uint8 input at 60 x 60,
# counted on its pair kernel itself (sass_count.py ``clahe_pixel``: a
# pixel's histogram step, its blend, its output and its share of the 16
# tiles' mappings); the block kernel's own pixel (``clahe_block_pixel``:
# its bin from the input, the blend of four tables, the rescale and the
# store, on a probe) was 102.
SASS_CLAHE_PER_PIXEL = 80.71583333333334
# ... and kernel D's dynamic pair kernel, counted on the kernel itself
# (sass_count.py ``dynamic_steps``): a step of the row product (a pattern
# row's two bytes, eight operator values, sixteen FMAs) and of the column
# product (two floats), and the rest of a warp's pass over a pattern (the
# removal, the min and max, the rescale, the copies); a run's issue slots a
# pattern are 2 rest + the steps its operators' bands need
# (sass_count.dynamic_slots).
SASS_D_DYNAMIC_STEPS = {"row_step": 24.125, "col_step": 19.03125, "rest": 2275.0}
# ... and of one pixel of kernel D's static warp kernel on uint8 input,
# counted on the shipped kernel (sass_count.py ``static_pixel``: one
# vector's two passes, the division, the truncation and the packing, less
# its loads and stores).
SASS_D_STATIC_PER_PIXEL = 24.71875
# float32 operations a pixel: kernel D's static mode (subtract or divide, the
# running min and max, the rescale's four), its dynamic mode (the same and
# the two products' nonzero terms, counted from the run's operators below),
# and kernel E (normalize and bin 3, one blend of four products and three
# sums, the running min and max, the rescale's four).
D_OPS_PER_PIXEL = 7
E_OPS_PER_PIXEL = 16
# The tutorial chain runs on the main path's scan and on it tiled this many
# times (65,536 patterns, 236 MB).
PREPROCESS_TILES = 4
# ... and on the CPU through the plain versions on this many of the scan's
# patterns, against which the card's chain is held.
CHAIN_CHECK_PATTERNS = 512
# Kernel D's dynamic mode and kernel E against their plain versions: pixels
# one gray level apart, at most this share.
GRAY_SHARE = 0.01
# One float4 of the quad texture a pixel.
TAP_BYTES = 16
# Scattered taps, one 32-byte L2 sector each, at the rates kernel A's
# gathers alone reached on an H100 at 700 W (lambert_variants.py; PERF.md):
# the floor of a kernel whose pixels each read one tap.
SCATTERED_TAPS_PER_S = (1.21e11, 1.30e11)
# Largest f32 summation-order difference between a float kernel and its
# float64-sum plain version on unit-norm rows.
NEAR_TIE_TOL = 1e-5
DI_TIERS = ("high", "default", "f16", "mixed", "int8")
# Clear-gap thresholds for top-1 against the exact tier: the selection
# rounding each tier can make.
TOP1_GAP = {"f32": 1e-4, "int8": 1e-4, "mixed": 1e-4, "bf16": 4e-3, "f16": 5e-4,
            "high": 2e-3, "default": 2e-3}

SCAN_SIDE = 128
# Refinement: the JAX package's nav_chunk, and the criterion of the
# reference's refinement benchmark (BASELINE.md rows 3-4): under 0.8 degrees
# wherever dictionary indexing came within 3 degrees.
NAV_CHUNK = 2048
# The spherical-harmonic tier at the JAX package's default band limit.
SH_L = 88
REFINE_MAX_DEG = 0.8
REFINE_START_DEG = 3.0
PC_OFFSET = (0.01, -0.01, 0.01)
PC_TOL = 2e-3
DETECTOR_SHAPE = (60, 60)
PC = (0.42, 0.28, 0.5)
MASTER_SIDE = 401
RESOLUTION_DEG = 2.0
KEEP_N = 20
# (hkl family, relative intensity); band profile sigma is the full Bragg
# width 2*theta_B of Ni at 20 kV (a = 3.52 A, lambda = 0.0859 A).
BAND_FAMILIES = (((1, 1, 1), 1.0), ((2, 0, 0), 0.8), ((2, 2, 0), 0.5), ((3, 1, 1), 0.35))
LATTICE_A = 3.52
WAVELENGTH = 0.0859


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------ inputs ------------------------------ #


def plane_normals(hkl) -> np.ndarray:
    """Unit normals of the {hkl} family under m-3m, one per +-pair."""
    import itertools

    seen, out = set(), []
    for perm in set(itertools.permutations(hkl)):
        for signs in itertools.product((1, -1), repeat=3):
            v = np.array(perm, dtype=np.float64) * signs
            if not v.any():
                continue
            key = tuple(v) if tuple(v) > tuple(-v) else tuple(-v)
            if key not in seen:
                seen.add(key)
                out.append(np.array(key) / np.linalg.norm(key))
    return np.array(out)


def master_pattern_data(side: int = MASTER_SIDE, width: float = 1.0) -> np.ndarray:
    """Packed Lambert hemispheres ``(2, side, side)`` of a Gaussian band
    sum over full m-3m plane families: symmetric by construction. Each band's
    sigma is ``width`` times its full Bragg width 2 theta_B."""
    import torch

    from kikuchipy_tpu_torch.geometry.lambert import lambert_to_vector

    lin = np.linspace(-1, 1, side)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    xy = torch.as_tensor(np.stack([xx, yy], axis=-1))
    v = lambert_to_vector(xy).numpy()
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    hemis = []
    for zsign in (1.0, -1.0):
        w = v * np.array([1.0, 1.0, zsign])
        img = np.zeros(w.shape[:-1])
        for hkl, weight in BAND_FAMILIES:
            d = LATTICE_A / np.sqrt(np.sum(np.square(hkl)))
            sigma = width * 2 * np.arcsin(WAVELENGTH / (2 * d))
            for n in plane_normals(hkl):
                img += weight * np.exp(-0.5 * (w @ n / sigma) ** 2)
        hemis.append(img)
    return np.stack(hemis).astype(np.float32)


def scan_data(mp, det, truth: np.ndarray, seed: int, chunk_size: int):
    """uint8 patterns at ``truth`` with a static background gradient and
    noise (the recipe of tests/test_system_synthetic.py)."""
    sim = mp.get_patterns(truth, det, dtype_out=np.float32, chunk_size=chunk_size).data
    lo = sim.amin(dim=(-2, -1), keepdim=True)
    hi = sim.amax(dim=(-2, -1), keepdim=True)
    pats = ((sim - lo) / (hi - lo)).cpu().numpy()
    sy, sx = det.shape
    yy, xx = np.indices((sy, sx))
    bg = 60 + 40 * np.exp(-((xx - sx / 2) ** 2 + (yy - sy / 2.4) ** 2) / (700 * (sy / 48) ** 2))
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(pats.shape, dtype=np.float32) * 6.0
    noisy = np.clip(pats * 120 + bg + noise, 0, 255).astype(np.uint8)
    return noisy, bg.astype(np.uint8)


# ------------------------ kernel vs plain ------------------------- #


# Dictionary rows on both sides of the wgmma kernels' boundaries: a
# 32-candidate selection slice and the bf16 and f32 (160) and int8 (256)
# chunks.
STRADDLE = (31, 32, 127, 128, 159, 160, 255, 256)


def kernel_cases(device, seed: int, m_main: int, d: int, k: int):
    """int8 kernel-vs-plain cases, bit for bit: small ones with planted
    ties, the repairs of k > 128, of groups that do not divide a
    128-candidate chunk and of short candidate lists, the "fori" and
    "none" extractions, and a 1024-row slab at the main-path shape.
    Returns the slab's max |score difference| and the number of cases."""
    import torch

    from kikuchipy_tpu_torch.ops.ncc_topk import EMPTY_SCORE, ncc_match_topk_int8, ncc_match_topk_int8_plain

    g = torch.Generator(device="cpu").manual_seed(seed)

    def operands(n, m, dd):
        e = torch.randint(-127, 128, (n, dd), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (m, dd), generator=g, dtype=torch.int8)
        sc = torch.rand(m, generator=g) * 0.01 + 1e-3
        # Planted ties: duplicated dictionary rows (also on both sides of a
        # 32-candidate slice and of the bf16 kernel's 160- and the int8
        # kernel's 256-candidate chunk), an all-zero row whose scores are
        # all equal, and one pattern in both consumer warpgroups (rows 63
        # and 64).
        for j in (5, 40, m - 1) + STRADDLE:
            if j < m:
                w[j], sc[j] = w[3], sc[3]
        e[1] = 0
        if n > 64:
            e[64] = e[63].clone()
        return e.to(device), w.to(device), sc.to(device)

    cases = [
        (64, 256, 128, 5, 8, 32, 1, "stream"),
        (64, 256, 128, 5, 8, 32, 8, "stream"),
        (100, 640, 3600, k, 4, 128, 1, "stream"),
        (128, 1024, 200, k, 8, 512, 8, "stream"),
        (72, 96, 48, 70, 8, 32, 4, "stream"),
        # repairs: k above 128 (keep_n=65 carries 130), groups of 3, 256
        # and 512, and lists shorter than k (float32-min slots)
        (256, 2048, 3600, 130, 8, 512, 1, "stream"),
        (128, 2048, 300, 512, 8, 512, 4, "stream"),
        (128, 192, 100, 70, 8, 96, 3, "stream"),
        (128, 1024, 100, 5, 8, 512, 256, "stream"),
        (128, 1024, 100, 3, 8, 512, 512, "stream"),
        (128, 256, 64, 20, 128, 128, 16, "stream"),
        # the other extractions
        (128, 1024, 200, k, 8, 512, 8, "fori"),
        (128, 1024, 200, k, 8, 512, 1, "none"),
        # ragged against the 128 x 256 block: n of 8, 72 and 136, m a
        # multiple of tile_m = 32 only, row bytes no multiple of 128
        (8, 288, 200, 1, 8, 32, 1, "stream"),
        (72, 288, 200, k, 8, 32, 1, "stream"),
        (136, 544, 100, 130, 8, 32, 1, "stream"),
        (136, 544, 72, 512, 8, 32, 1, "stream"),
        (72, 96, 72, 130, 8, 32, 1, "stream"),
        (72, 288, 100, k, 8, 96, 3, "stream"),
        (136, 544, 100, k, 8, 32, 16, "stream"),
        (8, 1024, 72, 5, 8, 512, 256, "stream"),
        (136, 1024, 72, 3, 8, 512, 512, "stream"),
        (136, 544, 72, k, 8, 32, 1, "none"),
    ]
    short_lists = 0
    for n, m, dd, kk, tile_n, tile_m, group, extraction in cases:
        e, w, sc = operands(n, m, dd)
        s1, i1 = ncc_match_topk_int8(e, w, sc, kk, tile_n, tile_m, group, extraction)
        torch.cuda.synchronize()
        s2, i2 = ncc_match_topk_int8_plain(e, w, sc, kk, tile_m, group, extraction)
        torch.cuda.synchronize()
        if not (torch.equal(s1, s2) and torch.equal(i1, i2)):
            raise AssertionError(f"kernel != plain at n={n} m={m} d={dd} k={kk} group={group} {extraction}")
        if n > 64 and not (torch.equal(s1[63], s1[64]) and torch.equal(i1[63], i1[64])):
            raise AssertionError(f"one pattern in both warpgroups, two results (n={n} m={m})")
        n_cand = m // group if extraction == "stream" else m
        if extraction != "none" and n_cand < kk:
            if not ((s1[:, n_cand:] == EMPTY_SCORE).all() and (i1[:, n_cand:] == 0).all()):
                raise AssertionError(f"slots past {n_cand} candidates are not (float32-min, 0)")
            short_lists += 1
    if short_lists < 5:
        raise AssertionError("the short-list cases did not run")
    slab = operands(1024, m_main, d)
    s1, i1 = ncc_match_topk_int8(*slab, k, 512, 512, 1)
    torch.cuda.synchronize()
    s2, i2 = ncc_match_topk_int8_plain(*slab, k, 512, 1)
    torch.cuda.synchronize()
    if not (torch.equal(s1, s2) and torch.equal(i1, i2)):
        raise AssertionError(f"kernel != plain on the 1024 x {m_main} x {d} slab")
    return float((s1 - s2).abs().max()), len(cases) + 1


def float_kernel_cases(device, seed: int, exp_rows, dict_rows, k: int):
    """f32 (v1, v3) and bf16 (v4) kernels against their float64-sum plain
    versions modulo near-ties: small unit-norm cases with planted
    duplicate dictionary rows (exact ties in column order), ragged n, m
    and d, k of 1 to 512 and every extraction; for f32 the split of
    ``exp_rows`` into TF32 planes and rows that differ only below TF32's
    10 mantissa bits; then a 1024-row slab of the main path's own prepared
    rows. Returns the number of cases and the slab's max |slot score
    difference| per kernel."""
    import torch

    from kikuchipy_tpu_torch.ops import ncc_topk as nt

    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    all_planted = (3, 5, 40) + STRADDLE

    def operands(n, m, dd):
        e = torch.randn((n, dd), generator=g)
        w = torch.randn((m, dd), generator=g)
        planted = tuple(j for j in all_planted if j < m)
        w[list(planted[1:])] = w[planted[0]].clone()
        e, w = e / e.norm(dim=1, keepdim=True), w / w.norm(dim=1, keepdim=True)
        if n > 64:
            e[64] = e[63].clone()  # one pattern in both consumer warpgroups
        return e.to(device), w.to(device), planted

    kernels = {
        "f32": (lambda e, w, kk, tm: nt.ncc_match_topk_f32(e, w, kk, 8, tm), torch.float32),
        "f32_blocked": (lambda e, w, kk, tm: nt.ncc_match_topk_f32_blocked(e, w, kk, 8, tm, 128), torch.float32),
        "bf16_fori": (lambda e, w, kk, tm: nt.ncc_match_topk_bf16(e, w, kk, 8, tm, "fori"), torch.bfloat16),
        "bf16_stream": (lambda e, w, kk, tm: nt.ncc_match_topk_bf16(e, w, kk, 8, tm, "stream"), torch.bfloat16),
    }

    def plain(rounding, e, w, kk, tm):
        if rounding == torch.bfloat16:
            return nt.ncc_match_topk_bf16_plain(e, w, kk, tm)
        return nt.ncc_match_topk_f32_plain(e, w, kk)

    def check(name, e, w, kk, tm, rows_planted):
        fn, rounding = kernels[name]
        s, i = fn(e, w, kk, tm)
        torch.cuda.synchronize()
        ref_s, ref_i = plain(rounding, e, w, kk + 1, tm)
        bad = nt.near_tie_disagreements(s, i, ref_s, ref_i, e, w, NEAR_TIE_TOL, rows_planted, rounding)
        if bad:
            raise AssertionError(f"{name} kernel != plain at n={e.shape[0]} m={w.shape[0]} d={e.shape[1]} k={kk}: {bad}")
        if e.shape[0] > 64 and rows_planted and not (torch.equal(s[63], s[64]) and torch.equal(i[63], i[64])):
            raise AssertionError(f"{name}: one pattern in both warpgroups, two results")
        return float((s - ref_s[:, :kk]).abs().max())

    n_cases = 0
    for n, m, dd, kk, tm in [
        (64, 512, 100, 5, 128), (128, 2048, 3600, 40, 512), (64, 1024, 301, 130, 512),
        # ragged against the wgmma kernels' 128 x 256 block
        (8, 288, 100, 1, 32), (72, 288, 301, 40, 32), (136, 544, 72, 130, 32), (136, 544, 200, 512, 32),
    ]:
        e, w, planted = operands(n, m, dd)
        for name in kernels:
            check(name, e, w, kk, tm, planted)
            n_cases += 1
    # The f32 kernels' split. On the card the planes are exact in TF32 and
    # sum to the value within 2**-21 of it.
    hi, lo = nt.split_tf32(exp_rows)
    low_bits = (hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF
    off = ((hi.double() + lo.double() - exp_rows.double()).abs() - 2.0**-21 * exp_rows.double().abs()).max()
    if low_bits.any() or off > 0:
        raise AssertionError(f"split_tf32 on the card: low bits set {bool(low_bits.any())}, hi + lo off by {float(off)}")
    del hi, lo, low_bits
    # The hand-written split pass against the plain split, bit for bit:
    # the main path's rows, a ragged d, and the values that must stay finite.
    odd = torch.randn((77, 301), generator=g).to(device)
    odd[0, :6] = torch.tensor([0.0, -0.0, 1e-42, torch.finfo(torch.float32).max, -torch.finfo(torch.float32).max, 1e-39])
    for x in (exp_rows, odd, odd[:, :1].contiguous()):
        got, ref = nt.tf32_rows(x), nt.tf32_rows_plain(x)
        if not (torch.equal(got.view(torch.int32), ref.view(torch.int32)) and torch.isfinite(got).all()):
            raise AssertionError(f"tf32_rows kernel != plain on {tuple(x.shape)}")
        n_cases += 1
    # A positive pattern v and its copy cut to TF32 differ only below TF32's
    # 10 mantissa bits, by about 2**-11 of the score: v and the cut copy as
    # patterns, and both as dictionary rows on either side of a chunk. The
    # low planes alone tell them apart, and equal rows still tie exactly.
    e, w, _ = operands(72, 544, 200)
    v = e[0].abs() / e[0].norm()
    cut = (v.view(torch.int32) & -0x2000).view(torch.float32)
    e[0], e[1] = v, cut
    w[[10, 159]], w[[11, 160]] = v, cut
    for name in ("f32", "f32_blocked"):
        s, i = kernels[name][0](e, w, 4, 32)
        check(name, e, w, 4, 32, ())
        for r in (0, 1):
            if not (i[r].tolist() == [10, 159, 11, 160] and s[r, 0] == s[r, 1] > s[r, 2] == s[r, 3]):
                raise AssertionError(f"{name}: rows that differ below TF32's bits: {i[r].tolist()} {s[r].tolist()}")
        n_cases += 1
    # Fewer candidates than k: the plain list, then (float32-min, 0) slots.
    e, w, _ = operands(72, 96, 72)
    for name, (fn, rounding) in kernels.items():
        s, i = fn(e, w, 130, 32)
        ref_s, ref_i = plain(rounding, e, w, 96, 32)
        if not ((s[:, :96] - ref_s).abs().max() <= NEAR_TIE_TOL and (s[:, 96:] == nt.EMPTY_SCORE).all()
                and (i[:, 96:] == 0).all()):
            raise AssertionError(f"{name}: 96 candidates for k=130 do not end in (float32-min, 0) slots")
        n_cases += 1
    # "none": slot 0 is the last tile's row maximum, the rest empty.
    for n, m, dd, tm in ((64, 1024, 300, 512), (136, 544, 72, 32)):
        e, w, _ = operands(n, m, dd)
        s, i = nt.ncc_match_topk_bf16(e, w, 5, 8, tm, "none")
        ref, _ = nt.ncc_match_topk_bf16_plain(e, w, 5, tm, "none")
        if not ((s[:, 0] - ref[:, 0]).abs().max() <= NEAR_TIE_TOL and torch.equal(s[:, 1:], ref[:, 1:])
                and (i == 0).all()):
            raise AssertionError("bf16 'none' differs from its plain version")
        n_cases += 1
    slab_err = {name: check(name, exp_rows[:1024], dict_rows, k, 512, ()) for name in kernels}
    return n_cases + len(kernels), slab_err


# ------------------------- launch counters ------------------------- #

WRAPPERS = {
    "ncc_topk": ("ncc_match_topk_f32", "ncc_match_topk_f32_blocked", "ncc_match_topk_bf16", "ncc_match_topk_int8",
                 "tf32_rows"),
    "lambert_project": ("lambert_project", "lambert_project_ncc"),
    "refine_nm": ("nelder_mead_orientation", "nelder_mead_projection_center",
                  "nelder_mead_orientation_projection_center"),
    "refine_lm": ("tangent_orientation", "tangent_projection_center", "tangent_orientation_projection_center",
                  "levenberg_marquardt_orientation", "levenberg_marquardt_projection_center",
                  "levenberg_marquardt_orientation_projection_center"),
    "background": ("remove_background",),
    "ahe": ("clahe",),
    "refine_population": ("population_orientation", "population_projection_center",
                          "population_orientation_projection_center"),
    "neighbours": ("average_neighbours",),
    "hough_vote": ("vote_orientations",),
}


def _wrappers():
    import importlib

    for module, names in WRAPPERS.items():
        mod = importlib.import_module(f"kikuchipy_tpu_torch.ops.{module}")
        for name in names:
            yield name, getattr(mod, name)


def reset_launches() -> None:
    for _, fn in _wrappers():
        fn.launches = 0
        if hasattr(fn, "mode_launches"):
            fn.mode_launches = dict.fromkeys(fn.mode_launches, 0)


def read_launches() -> dict[str, int]:
    counts = {name: fn.launches for name, fn in _wrappers()}
    for name, fn in _wrappers():
        for mode, n in getattr(fn, "mode_launches", {}).items():
            counts[f"{name}[{mode}]"] = n
    return counts


# ----------------------------- timing ----------------------------- #


def cuda_ms(fn, reps: int, lead_ms: float = 0.0) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up. With
    ``lead_ms`` the card first idles that long (``torch.cuda._sleep``) while
    the host queues the calls, so a call shorter than its own host work is
    timed on the card, not on the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if lead_ms:
        device_sleep(lead_ms)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.lru_cache(maxsize=1)
def max_clock_mhz() -> float:
    """The card's largest SM clock (``nvidia-smi`` clocks.max.sm)."""
    return float(smi_line("clocks.max.sm").split()[0])


def device_sleep(ms: float) -> None:
    """Keep the card busy for about ``ms`` milliseconds without touching
    memory (at the card's largest SM clock)."""
    import torch

    torch.cuda._sleep(int(ms * 1e-3 * max_clock_mhz() * 1e6))


# Bytes written between two launches to push their data out of the 50 MB L2.
L2_FLUSH_BYTES = 128 * 2**20


def cuda_ms_cold(fn, reps: int, flush) -> float:
    """Mean milliseconds per call from CUDA events around each call alone,
    with ``flush`` (a device tensor of L2_FLUSH_BYTES) written before each:
    the call finds none of its data in L2. The card idles 0.5 ms after each
    flush, so the host's work for the call is done before its start event.
    One warm-up first."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        device_sleep(0.5)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def call_breakdown(fn, reps: int, traced: int = 5, launches=None) -> dict:
    """One entry point's call on the host clock, synchronized after each
    (median and mean ms of ``reps`` calls after a warm-up), and ``traced``
    calls under ``torch.profiler``, each synchronized: the device's busy ms
    and its kernels, and the host's self time by operation (the profiler's
    own buffer requests left out), a call each, largest first.
    ``launches``, a count the call's kernel wrappers raise at each launch,
    is read around the traced calls: where the trace holds fewer kernels
    than were launched, the device's ms is None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    before = launches() if launches else 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / traced
    launched = launches() - before if launches else None
    busy, kernels = device_busy(prof)
    caught = sum(c for k, c, _ in kernels if not k.startswith(("Memcpy", "Memset")))
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0 and "Activity Buffer" not in e.key),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"median_ms": float(np.median(times)), "mean_ms": float(np.mean(times)), "traced_ms": wall,
            "device_ms": None if launched is not None and caught < launched else busy / traced,
            "kernels_traced": caught, "kernels_launched": launched,
            "kernels": [(k, c / traced, t / traced) for k, c, t in kernels[:6]],
            "host": [(e.key, e.count / traced, e.self_cpu_time_total / 1e3 / traced) for e in host[:10]]}


def breakdown_text(b: dict) -> str:
    if b["device_ms"] is None:
        device = (f"device busy not measured (the trace holds {b['kernels_traced']} of the "
                  f"{b['kernels_launched']} kernels launched)")
    else:
        device = f"device busy {b['device_ms']:.4f} ms: " + "; ".join(
            f"{k[:50]} x{c:g} {t:.4f} ms" for k, c, t in b["kernels"])
    return (f"median {b['median_ms']:.4f} ms, mean {b['mean_ms']:.4f} ms (host clock, synchronized); a call under "
            f"torch.profiler {b['traced_ms']:.3f} ms, {device}"
            + " | host self time a call: " + "; ".join(f"{k[:40]} x{c:g} {t:.4f} ms" for k, c, t in b["host"]))


def l2_read_rate(device, mib: int = 32, reps: int = 50) -> float:
    """Bytes per second at which the SMs read a buffer that sits in L2: the
    read probe built with the int8 kernel (``csrc/ncc_topk_int8.cu``), timed
    with CUDA events."""
    import ctypes

    import torch

    from kikuchipy_tpu_torch.ops._build import library

    fn = library("ncc_topk_int8").ncc_l2_read_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = torch.ones(mib * 2**20 // 4, dtype=torch.int32, device=device)
    out = torch.zeros(1, dtype=torch.int32, device=device)

    def probe():
        err = fn(buf.data_ptr(), buf.numel() * 4, reps, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"L2 read probe launch failed: cudaError_t {err}")

    return buf.numel() * 4 * reps / (cuda_ms(probe, 3) * 1e-3)


def library_same_function(product, m: int, k: int, tile: int = 32768):
    """The kernels' function from library calls, never called by the port:
    per ``tile`` columns a product (``product(c0, c1)`` -> f32 scores),
    ``torch.topk`` and a merge with the running top-k."""
    import torch

    best_s = best_i = None
    for c0 in range(0, m, tile):
        s, i = torch.topk(product(c0, min(c0 + tile, m)), k, dim=1)
        i = i + c0
        if best_s is not None:
            s, pos = torch.topk(torch.cat([best_s, s], dim=1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], dim=1), 1, pos)
        best_s, best_i = s, i
    return best_s, best_i


def split_table_row(operands, planes, ms: float, launches: int) -> dict:
    """The kernels-line entry of the f32 kernel's split pass (``tf32_rows``
    on both operands of the main-path shape): bound by device memory, each
    value read once and its two planes written once; no library call does
    the same."""
    from kikuchipy_tpu_torch.ops import ncc_topk as nt

    plain = [nt.tf32_rows_plain(x) for x in operands]
    err = max(float((a - b).abs().max()) for a, b in zip(planes, plain))
    del plain
    moved = sum(x.numel() * 4 for x in operands) + sum(p.numel() * 4 for p in planes)
    return {
        "name": "tf32_rows", "route": "cuda", "source": "kikuchipy_tpu_torch/csrc/ncc_topk_f32.cu",
        "replaces": "kikuchipy_tpu/ops/pallas_di.py:413", "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": cuda_ms(lambda: [nt.tf32_rows_plain(x) for x in operands], 2),
        "bound_ms": moved / PEAK_BYTES * 1e3, "bound_by": "bytes", "library_ms": None,
        "library_same_function_ms": None, "l2_bound_ms": None, "split_ms": None, "kernel_only_ms": None,
    }


# --------------------- projection kernels vs plain --------------------- #


# Kernel A against the plain twin run on float64 operands (the yardstick),
# beside the float32 twin's own distance from it. E_k = |kernel - plain64|
# and E_t = |plain32 - plain64|, as shares of the value range (the master's,
# or 255 when rescaled). Over the pixels of all cases together: max E_k <=
# max E_t, RMS E_k <= A_RMS_FACTOR x RMS E_t, and the pixels whose tap index
# differs from plain64's at most A_TAP_FACTOR x the float32 twin's and under
# A_TAP_SHARE of all pixels. In each case: max E_k <= A_CASE_MAX.
A_RMS_FACTOR = 1.5
A_TAP_FACTOR = 1.5
A_TAP_SHARE = 1e-4
A_CASE_MAX = 1e-4


class Float64Yardstick:
    """E_k and E_t of kernel A, per case and pooled over the cases."""

    def __init__(self):
        self.cases: dict[str, dict] = {}

    def add(self, case: str, got, tap, plain32, tap32, plain64, tap64, value_range: float) -> None:
        """Add the pixels of one slab of ``case`` (several slabs may make
        one case)."""
        e_k = (got.double() - plain64).abs() / value_range
        e_t = (plain32.double() - plain64).abs() / value_range
        c = self.cases.setdefault(case, dict(pixels=0, max_k=0.0, sq_k=0.0, taps_k=0, max_t=0.0, sq_t=0.0,
                                             taps_t=0, max_k32=0.0, finite=True))
        c["pixels"] += e_k.numel()
        c["max_k"] = max(c["max_k"], float(e_k.max()))
        c["sq_k"] += float((e_k * e_k).sum())
        c["taps_k"] += int((tap != tap64).sum())
        c["max_t"] = max(c["max_t"], float(e_t.max()))
        c["sq_t"] += float((e_t * e_t).sum())
        c["taps_t"] += int((tap32 != tap64).sum())
        c["max_k32"] = max(c["max_k32"], float((got - plain32).abs().max()) / value_range)
        c["finite"] = c["finite"] and bool(got.isfinite().all())

    def pooled(self) -> dict:
        out = dict(pixels=0, max_k=0.0, sq_k=0.0, taps_k=0, max_t=0.0, sq_t=0.0, taps_t=0, max_k32=0.0, finite=True)
        for c in self.cases.values():
            for key in ("pixels", "sq_k", "taps_k", "sq_t", "taps_t"):
                out[key] += c[key]
            for key in ("max_k", "max_t", "max_k32"):
                out[key] = max(out[key], c[key])
            out["finite"] = out["finite"] and c["finite"]
        return out

    @staticmethod
    def summary(c: dict) -> str:
        n = c["pixels"]
        return (f"E_k max {c['max_k']:.3e} RMS {(c['sq_k'] / n) ** 0.5:.3e} taps {c['taps_k']}; E_t max "
                f"{c['max_t']:.3e} RMS {(c['sq_t'] / n) ** 0.5:.3e} taps {c['taps_t']}; of {n} pixels; "
                f"max |kernel - plain32| {c['max_k32']:.3e}")

    def failures(self) -> list[str]:
        bad = [f"{name}: not finite" for name, c in self.cases.items() if not c["finite"]]
        bad += [f"{name}: max E_k {c['max_k']:.3e} > {A_CASE_MAX:g}" for name, c in self.cases.items()
                if not c["max_k"] <= A_CASE_MAX]
        c = self.pooled()
        rms_k, rms_t = (c["sq_k"] / c["pixels"]) ** 0.5, (c["sq_t"] / c["pixels"]) ** 0.5
        if not c["max_k"] <= c["max_t"]:
            bad.append(f"pooled max E_k {c['max_k']:.3e} > max E_t {c['max_t']:.3e}")
        if not rms_k <= A_RMS_FACTOR * rms_t:
            bad.append(f"pooled RMS E_k {rms_k:.3e} > {A_RMS_FACTOR} x RMS E_t {rms_t:.3e}")
        if not (c["taps_k"] <= A_TAP_FACTOR * c["taps_t"] and c["taps_k"] < A_TAP_SHARE * c["pixels"]):
            bad.append(f"pooled taps off float64's {c['taps_k']} (float32 twin {c['taps_t']}, limit "
                       f"{A_TAP_FACTOR} x that and < {A_TAP_SHARE:g} of {c['pixels']})")
        return bad


def pole_rotations(dc, n: int, seed: int, max_angle: float = 1e-3) -> np.ndarray:
    """Unit quaternions ``(n, 4)`` float32, each turning one pixel's
    direction ``dc[k]`` (``k`` at random) to within ``max_angle`` radians of
    a Lambert pole (+z for even rows, -z for odd; the first of each exactly
    onto it)."""
    rng = np.random.default_rng(seed)
    v = np.asarray(dc, dtype=np.float64)[rng.integers(0, dc.shape[0], n)]
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    angle = rng.uniform(0.0, max_angle, n)
    angle[:2] = 0.0
    phi = rng.uniform(0.0, 2 * np.pi, n)
    pole = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    target = np.stack([np.sin(angle) * np.cos(phi), np.sin(angle) * np.sin(phi), pole * np.cos(angle)], axis=1)
    axis = np.cross(v, target)
    norm = np.linalg.norm(axis, axis=1, keepdims=True)
    axis = np.where(norm > 1e-12, axis / np.maximum(norm, 1e-300), np.array([1.0, 0.0, 0.0]))
    half = 0.5 * np.arccos(np.clip(np.sum(v * target, axis=1), -1.0, 1.0))
    q = np.concatenate([np.cos(half)[:, None], np.sin(half)[:, None] * axis], axis=1)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def projection_checks(device, dictionary_rows, rot, dc, quad, side: int, master_range: float, om, seed: int):
    """Kernel A (``lambert_project``) against the plain twin in float64
    (``Float64Yardstick``): the main path's whole dictionary in slabs of
    8192 rows (the rows the main path made, and the taps of a second
    launch), then a rescaled slab, one PC per rotation, a ragged pixel count
    (P = 515), one rotation, and 64 rotations that put a pixel within 1e-3
    rad of a Lambert pole. Raises if the criterion fails; returns the
    yardstick."""
    import torch

    from kikuchipy_tpu_torch.indexing.refinement import _dc_for_pc
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    geo = (side, side, (side - 1) / 2)
    g = torch.Generator(device="cpu").manual_seed(seed + 2)
    quad64 = quad.double()
    yard = Float64Yardstick()

    def compare(case, got, r, d, **kw):
        _, tap = lp.lambert_project(r, d, quad, *geo, taps=True, **kw)
        if got is None:
            got = lp.lambert_project(r, d, quad, *geo, **kw)
        p32, t32 = lp.lambert_project_plain(r, d, quad, *geo, taps=True, **kw)
        p64, t64 = lp.lambert_project_plain(r.double(), d.double(), quad64, *geo, taps=True, **kw)
        yard.add(case, got, tap, p32, t32, p64, t64, 255.0 if kw.get("rescale") else master_range)

    n = rot.shape[0]
    for start in range(0, n, 8192):
        end = min(start + 8192, n)
        compare("dictionary", dictionary_rows[start:end], rot[start:end], dc)
    compare("rescaled", None, rot[:8192], dc, rescale=True, out_min=0.0, out_max=255.0)
    few = min(4096, n)
    pcs = torch.tensor(PC) + (torch.rand((few, 3), generator=g) - 0.5) * 0.04
    compare("per-PC", None, rot[:few], _dc_for_pc(pcs.to(device), *DETECTOR_SHAPE, om, None).contiguous())
    compare("P=515", None, rot[:few], dc[::7].contiguous())
    compare("B=1", None, rot[:1], dc)
    compare("pole", None, torch.as_tensor(pole_rotations(dc.cpu().numpy(), 64, seed + 5), device=device), dc)
    bad = yard.failures()
    if bad:
        raise AssertionError("lambert_project against the float64 twin: " + "; ".join(bad) + " | " + "; ".join(
            f"{name}: {yard.summary(c)}" for name, c in yard.cases.items()))
    return yard


# Kernel B against the plain twin in float64 (1 - NCC a pattern), as kernel
# A is held: in each case of many patterns E_k = |kernel - plain64| no
# larger than E_t = |plain32 - plain64| at its largest; over all cases
# together that too, and an RMS within A_RMS_FACTOR x E_t's; in every case
# (one pattern too: there E_k and E_t are each one float32 rounding of the
# sums, about 1e-7, and either may be the larger) the kernel within
# B_TWIN_TOL of the float32 twin.
B_TWIN_TOL = 2e-6


def ncc_yardstick(got, plain32, plain64) -> dict:
    """Kernel B's 1 - NCC ``got`` beside the float32 twin's and the float64
    twin's: E_k and E_t, largest and RMS, and |kernel - plain32|."""
    e_k = (got.double() - plain64).abs()
    e_t = (plain32.double() - plain64).abs()
    return dict(n=e_k.numel(), max_k=float(e_k.max()), rms_k=float(e_k.square().mean().sqrt()),
                max_t=float(e_t.max()), rms_t=float(e_t.square().mean().sqrt()),
                max_k32=float((got - plain32).abs().max()), finite=bool(got.isfinite().all()))


def ncc_yardstick_text(y: dict) -> str:
    return (f"E_k max {y['max_k']:.3e} RMS {y['rms_k']:.3e}; E_t max {y['max_t']:.3e} RMS {y['rms_t']:.3e} of "
            f"{y['n']} patterns; |kernel - plain32| max {y['max_k32']:.3e}")


def ncc_yardstick_failures(case: str, y: dict) -> list[str]:
    bad = [] if y["finite"] else [f"{case}: not finite"]
    if y["n"] > 1 and not y["max_k"] <= y["max_t"]:
        bad.append(f"{case}: max E_k {y['max_k']:.3e} > max E_t {y['max_t']:.3e}")
    if not y["max_k32"] <= B_TWIN_TOL:
        bad.append(f"{case}: |kernel - plain32| {y['max_k32']:.3e} > {B_TWIN_TOL:g}")
    return bad


def ncc_pooled(yards: dict) -> dict:
    """The cases' yardsticks together."""
    n = sum(y["n"] for y in yards.values())
    return dict(n=n, max_k=max(y["max_k"] for y in yards.values()), max_t=max(y["max_t"] for y in yards.values()),
                rms_k=(sum(y["n"] * y["rms_k"] ** 2 for y in yards.values()) / n) ** 0.5,
                rms_t=(sum(y["n"] * y["rms_t"] ** 2 for y in yards.values()) / n) ** 0.5,
                max_k32=max(y["max_k32"] for y in yards.values()), finite=all(y["finite"] for y in yards.values()))


def ncc_pooled_failures(yards: dict) -> list[str]:
    c = ncc_pooled(yards)
    bad = [f for case, y in yards.items() for f in ncc_yardstick_failures(case, y)]
    if not c["max_k"] <= c["max_t"]:
        bad.append(f"pooled max E_k {c['max_k']:.3e} > max E_t {c['max_t']:.3e}")
    if not c["rms_k"] <= A_RMS_FACTOR * c["rms_t"]:
        bad.append(f"pooled RMS E_k {c['rms_k']:.3e} > {A_RMS_FACTOR} x RMS E_t {c['rms_t']:.3e}")
    return bad


def ncc_kernel_checks(device, pre_rows, rot, dc, quad, side: int, om, seed: int):
    """Kernel B (``lambert_project_ncc``) against the plain twin in float64
    and in float32 (``ncc_yardstick``): one navigation chunk of the main
    path's own patterns at their DI orientations with the shared detector,
    a masked detector (a P that is no multiple of the 256-thread block), a
    P of 1000, one PC per point, and one point. Returns the max |kernel -
    plain32| and each case's yardstick."""
    import torch

    from kikuchipy_tpu_torch.indexing.refinement import _dc_for_pc, _prepare_experimental
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    geo = (side, side, (side - 1) / 2)
    g = torch.Generator(device="cpu").manual_seed(seed + 3)
    mask_idx = torch.nonzero(torch.rand(pre_rows.shape[1], generator=g) > 0.3)[:, 0].to(device)
    pcs = torch.tensor(PC) + (torch.rand((rot.shape[0], 3), generator=g) - 0.5) * 0.04
    exp, sq = _prepare_experimental(pre_rows, None)
    exp_m, sq_m = _prepare_experimental(pre_rows, mask_idx)
    exp_1k, sq_1k = _prepare_experimental(pre_rows[:, :1000], None)
    cases = {
        "shared": (rot, dc, exp, sq),
        f"masked (P={mask_idx.numel()})": (rot, dc[mask_idx].contiguous(), exp_m, sq_m),
        "P=1000": (rot, dc[:1000].contiguous(), exp_1k, sq_1k),
        "one PC a point": (rot, _dc_for_pc(pcs.to(device), *DETECTOR_SHAPE, om, None).contiguous(), exp, sq),
        "B=1": (rot[:1], dc, exp[:1], sq[:1]),
    }
    quad64 = quad.double()
    yards = {}
    for case, (r, d, e, q) in cases.items():
        got = lp.lambert_project_ncc(r, d, quad, *geo, e, q)
        ref = lp.lambert_project_ncc_plain(r, d, quad, *geo, e, q)
        ref64 = lp.lambert_project_ncc_plain(r.double(), d.double(), quad64, *geo, e.double(), q.double())
        yards[case] = ncc_yardstick(got, ref, ref64)
    bad = ncc_pooled_failures(yards)
    if bad:
        raise AssertionError("lambert_project_ncc against the float64 twin: " + "; ".join(bad) + " | " + "; ".join(
            f"{case}: {ncc_yardstick_text(y)}" for case, y in yards.items()))
    return max(y["max_k32"] for y in yards.values()), yards


# ------------------ Nelder-Mead kernel vs the host loop ------------------ #

# Agreement of the Nelder-Mead kernel with the host loop on kernel B: bit for
# bit, and (what the tolerances below print) on at least NM_AGREE of the
# points equal iterations, 1 - NCC within NM_FUN_TOL, results within NM_DEG
# of each other (Euler angles) and NM_PC_TOL (PC); the mean score no lower
# by more than NM_MEAN_TOL. float64_check holds the kernel against the host
# loop over the float32 twin by the same NM_AGREE, NM_DEG and NM_MEAN_TOL.
NM_AGREE = 0.99
NM_FUN_TOL = 1e-5
NM_DEG = 0.05
NM_PC_TOL = 1e-5
NM_MEAN_TOL = 1e-6
# Each mode's parameters: the Euler angles and the PC, as columns of x.
NM_COLUMNS = {"orientation": (slice(0, 3), None), "pc": (None, slice(0, 3)), "joint": (slice(0, 3), slice(3, 6))}


def host_loop(euler0, exp, sq_norm, dc, quad, geo, nm_kw, chunk: int = NAV_CHUNK, lower=None, upper=None):
    """``nelder_mead_batched`` over ``_objective_orientation`` (kernel B a
    launch) in navigation chunks, as ``refine_orientation`` ran it before
    the kernel; the chunks' results concatenated."""
    import torch

    from kikuchipy_tpu_torch.indexing.refinement import _objective_orientation
    from kikuchipy_tpu_torch.ops.refine_nm import NelderMeadKernelResult
    from kikuchipy_tpu_torch.utils.optimize import _nelder_mead_counted

    parts = []
    for s in range(0, euler0.shape[0], chunk):
        e = slice(s, s + chunk)
        res, n_evals = _nelder_mead_counted(
            _objective_orientation, euler0[e], nm_kw.get("initial_step"), nm_kw["max_iters"], nm_kw["fatol"],
            nm_kw["xatol"], None if lower is None else lower[e], None if upper is None else upper[e],
            (exp[e], sq_norm[e], dc if dc.ndim == 2 else dc[e], quad, *geo))
        parts.append(NelderMeadKernelResult(*res, n_evals=n_evals))
    return NelderMeadKernelResult(*(torch.cat([getattr(p, f) for p in parts])
                                    for f in NelderMeadKernelResult._fields))


def nm_agreement(label: str, got, ref, mode: str = "orientation") -> tuple[float, str]:
    """Check the kernel's result against the host loop's over kernel B in
    one of the three modes: bit for bit (points, values, iterations,
    convergence; kernel B and the kernel share lambert_pixel and the block
    reduction), and by the tolerances above; return the max |1 - NCC
    difference| and a summary."""
    import torch

    from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle
    from kikuchipy_tpu_torch.geometry import quaternion as tq

    euler, pc = NM_COLUMNS[mode]
    same_iter = (got.n_iter == ref.n_iter).float().mean().item()
    dfun = (got.fun - ref.fun).abs()
    fun_ok = (dfun <= NM_FUN_TOL).float().mean().item()
    ok = [same_iter, fun_ok]
    msg = (f"{label} (n={got.fun.shape[0]}): n_iter equal {same_iter:.4f}, |d(1 - NCC)| <= {NM_FUN_TOL:g} "
           f"{fun_ok:.4f} (max {float(dfun.max()):.2e})")
    if euler is not None:
        qa = tq.from_euler(got.x[:, euler].double().cpu()).numpy()
        qb = tq.from_euler(ref.x[:, euler].double().cpu()).numpy()
        ang = np.degrees(disorientation_angle(qa, qb, "m-3m"))
        ok.append(float((ang <= NM_DEG).mean()))
        msg += f", within {NM_DEG} deg {ok[-1]:.4f} (max {ang.max():.2e} deg)"
    if pc is not None:
        dpc = (got.x[:, pc] - ref.x[:, pc]).abs().amax(dim=1)
        ok.append(float((dpc <= NM_PC_TOL).float().mean()))
        msg += f", PC within {NM_PC_TOL:g} {ok[-1]:.4f} (max {float(dpc.max()):.2e})"
    mean_gap = float((1 - got.fun.double()).mean() - (1 - ref.fun.double()).mean())
    bitwise = (torch.equal(got.x, ref.x) and torch.equal(got.fun, ref.fun) and torch.equal(got.n_iter, ref.n_iter)
               and torch.equal(got.converged, ref.converged))
    msg += (f", mean score kernel - loop {mean_gap:.2e}, bit for bit {bitwise}, evaluations "
            f"{int(got.n_evals.sum())} vs the loop's {int(ref.n_evals.sum())}")
    if not bitwise or min(ok) < NM_AGREE or mean_gap < -NM_MEAN_TOL or not torch.isfinite(got.fun).all():
        raise AssertionError(f"the Nelder-Mead kernel ({mode} mode) disagrees with the host loop: {msg}")
    return float(dfun.max()), msg


# ---------- the tap cache's hits (csrc/refine_nm.cu built with its probe) ---------- #


def start_probe_build(here: Path):
    """Start ``nvcc`` on ``csrc/refine_nm.cu`` with ``-DREFINE_NM_PROBE``
    (the kernel counting its tap cache's hits); returns the process and the
    library it writes."""
    from kikuchipy_tpu_torch.ops import _build

    lib = here / "kikuchipy_tpu_torch" / "_kernels_build" / "refine_nm_probe.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    src = here / "kikuchipy_tpu_torch" / "csrc" / "refine_nm.cu"
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-DREFINE_NM_PROBE=1", "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def finish_probe_build(probe) -> Path:
    """Wait for ``start_probe_build``'s ``nvcc``; returns the library."""
    proc, lib_path = probe
    log_text, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the tap-reuse probe:\n{log_text}")
    return lib_path


def tap_reuse(lib_path: Path, calls: dict) -> dict:
    """Each of ``calls`` (name -> a call of a Nelder-Mead wrapper) once on
    the probe build at ``lib_path`` (``csrc/refine_nm.cu`` with
    ``-DREFINE_NM_PROBE``): the cached pixels of the points' first
    evaluations and of later ones, the later ones whose tap the cache held,
    and that share (of later, and of all pixels)."""
    import ctypes

    import torch

    from kikuchipy_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(lib_path))
    built = _build.library("refine_nm")
    out = {}
    try:
        _build._LOADED["refine_nm"] = lib
        for name, call in calls.items():
            counts = (ctypes.c_ulonglong * 3)()
            lib.refine_nm_probe_read(counts)  # zero them
            call()
            torch.cuda.synchronize()
            if lib.refine_nm_probe_read(counts):
                raise RuntimeError("refine_nm_probe_read failed")
            first, later, hits = (int(c) for c in counts)
            out[name] = dict(first_evaluation_pixels=first, later_pixels=later, hits=hits,
                             share_of_later=hits / max(later, 1), share_of_all=hits / max(first + later, 1))
    finally:
        _build._LOADED["refine_nm"] = built
    return out


# ---------- the Nelder-Mead kernel against a loop over the float32 twin ---------- #
#
# The kernel and kernel B share lambert_pixel, which is not the plain twin's
# float32 rounding. Their refined points are held against the host loop
# over the float32 plain twin (lambert_project_ncc_plain: the arithmetic
# JAX's objective rounds like) on a navigation chunk: the mean of the
# float64 twin's 1 - NCC at the kernel's points no higher than at the
# loop's by more than NM_MEAN_TOL, and in orientation mode at least
# NM_AGREE of the points within NM_DEG of the loop's. Where the PC is
# refined, two float32 roundings of the objective end apart by about the
# simplex's xatol (1e-5) in PC, and in joint mode a tenth of the points
# more than NM_DEG apart along the PC-rotation valley: the loop over the
# float32 twin lands no closer to the loop over the float64 twin, nor does
# the IEEE-rounded kernel this one replaced (compare_kernel_times.py
# --refine --float64). There the shares within NM_DEG and NM_PC_TOL are
# printed, and the float64 score is held.


def float64_pc_direction_cosines(pc, nrows: int, ncols: int, om, take=None):
    """``ops/refine_nm.py`` ``pc_direction_cosines``' formula in float64:
    unit direction cosines ``(n, P, 3)`` of the detector's pixels (all, or
    ``take``) for PCs ``pc (n, 3)``."""
    import torch

    pc, om = pc.double(), om.double()
    aspect = ncols / nrows
    pcx, pcy, pcz = pc[:, 0:1], pc[:, 1:2], pc[:, 2:3]
    gb0, gb1 = -pcx * aspect / pcz, (1.0 - pcx) * aspect / pcz
    gb2, gb3 = -(1.0 - pcy) / pcz, pcy / pcz
    x_scale, y_scale = (gb1 - gb0) / ncols, (gb3 - gb2) / nrows
    idx = torch.arange(nrows * ncols, device=pc.device) if take is None else take.to(pc.device).long()
    col, row = (idx % ncols).double()[None, :], (idx // ncols).double()[None, :]
    x = (gb0 + col * x_scale + 0.5 * x_scale) * pcz
    y = (gb3 - row * y_scale - 0.5 * y_scale) * pcz
    z = torch.broadcast_to(pcz, x.shape)
    r = torch.stack([x * om[k, 0] + y * om[k, 1] + z * om[k, 2] for k in range(3)], dim=-1)
    return r / torch.linalg.norm(r, dim=-1, keepdim=True)


def twin_objective(mode: str, exp, sq, dc, q0, quad, om, take, geo, shape):
    """``1 - NCC`` at a batch of candidates ``(n, d)`` of ``mode`` on the
    float32 plain twin (no kernel): the objectives of ``ops/refine_nm.py``
    with ``lambert_project_ncc_plain`` in place of kernel B."""
    import torch

    from kikuchipy_tpu_torch.geometry.quaternion import from_euler
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops.refine_nm import pc_direction_cosines

    def objective(x):
        q = q0 if mode == "pc" else from_euler(x[:, :3]).to(torch.float32)
        d = dc if mode == "orientation" else pc_direction_cosines(x[:, -3:], *shape, om, take)
        return lp.lambert_project_ncc_plain(q, d, quad, *geo, exp, sq)

    return objective


def float64_scores(mode: str, x, exp, sq, dc, q0, quad, om, take, geo, shape):
    """The float64 twin's ``1 - NCC`` ``(n,)`` at each point's result ``x``."""
    from kikuchipy_tpu_torch.geometry.quaternion import from_euler
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    q = q0.double() if mode == "pc" else from_euler(x[:, :3].double())
    d = dc.double() if mode == "orientation" else float64_pc_direction_cosines(x[:, -3:], *shape, om, take)
    return lp.lambert_project_ncc_plain(q, d, quad.double(), *geo, exp.double(), sq.double())


def float64_agreement(mode: str, got, ref, s_got, s_ref) -> tuple[bool, str]:
    """The kernel's points ``got`` against the float32-twin loop's ``ref``
    and their float64 scores (1 - NCC): whether the criterion holds, and a
    summary."""
    from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle
    from kikuchipy_tpu_torch.geometry import quaternion as tq

    euler, pc = NM_COLUMNS[mode]
    ok, msg = [], []
    if euler is not None:
        ang = np.degrees(disorientation_angle(tq.from_euler(got.x[:, euler].double().cpu()).numpy(),
                                              tq.from_euler(ref.x[:, euler].double().cpu()).numpy(), "m-3m"))
        ok.append(float((ang <= NM_DEG).mean()))
        msg.append(f"within {NM_DEG} deg {ok[-1]:.4f} (max {ang.max():.2e} deg)")
    if pc is not None:
        dpc = (got.x[:, pc] - ref.x[:, pc]).abs().amax(dim=1)
        ok.append(float((dpc <= NM_PC_TOL).float().mean()))
        msg.append(f"PC within {NM_PC_TOL:g} {ok[-1]:.4f} (max {float(dpc.max()):.2e}, median "
                   f"{float(dpc.median()):.2e})")
    gap = float(s_got.mean() - s_ref.mean())
    msg.append(f"mean float64 1 - NCC kernel {float(s_got.mean()):.8f} against the loop's {float(s_ref.mean()):.8f} "
               f"(kernel - loop {gap:.2e}, limit {NM_MEAN_TOL:g}); the float32 scores' mean gap "
               f"{float(got.fun.double().mean() - ref.fun.double().mean()):.2e}")
    held = ok[0] >= NM_AGREE if mode == "orientation" else True
    return held and gap <= NM_MEAN_TOL and bool(s_got.isfinite().all()), ", ".join(msg)


def float64_loop(mode: str, x0, nm_kw, exp, sq, dc, q0, quad, om, take, geo, shape):
    """The host loop over the float64 twin (the float64 objective) from
    ``x0``, in float64 throughout."""
    from kikuchipy_tpu_torch.utils.optimize import _nelder_mead_counted

    step, lo, hi = (None if v is None else torch_double(v) for v in
                    (nm_kw.get("initial_step"), nm_kw.get("lower_bounds"), nm_kw.get("upper_bounds")))
    res, _ = _nelder_mead_counted(
        lambda x: float64_scores(mode, x, exp, sq, dc, q0, quad, om, take, geo, shape), x0.double(), step,
        nm_kw["max_iters"], nm_kw["fatol"], nm_kw["xatol"], lo, hi, ())
    return res


def torch_double(v):
    """``v`` (a scalar or a tensor) as float64, a tensor staying on its device."""
    return v.double() if hasattr(v, "double") else float(v)


def float64_check(mode: str, wrapper, x0, nm_kw, exp, sq, dc, q0, quad, om, take, geo, shape):
    """The kernel (``wrapper``'s call from ``x0``) against the loop over the
    float32 twin in ``mode``: ``float64_agreement``'s verdict and summary,
    and both results."""
    import torch

    from kikuchipy_tpu_torch.utils.optimize import _nelder_mead_counted

    got = wrapper(x0)
    res, _ = _nelder_mead_counted(twin_objective(mode, exp, sq, dc, q0, quad, om, take, geo, shape), x0,
                                  nm_kw.get("initial_step"), nm_kw["max_iters"], nm_kw["fatol"], nm_kw["xatol"],
                                  nm_kw.get("lower_bounds"), nm_kw.get("upper_bounds"), ())
    torch.cuda.synchronize()
    scores = [float64_scores(mode, r.x, exp, sq, dc, q0, quad, om, take, geo, shape) for r in (got, res)]
    ok, msg = float64_agreement(mode, got, res, *scores)
    return ok, msg, got, res


def nm_edge_cases(device, rows, euler0, dc, quad, geo, om, nm_kw, top1_rot, seed: int, big: int = 48,
                  big_side: int = 240) -> list[str]:
    """The kernel against the host loop on a navigation chunk of the main
    path with a trust region, a signal mask, P=1000 and one PC a point, on
    one point, and on a 240 x 240 detector (past the shared-memory budget:
    the two-pass branch) over 48 points."""
    import torch

    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.indexing.refinement import _dc_for_pc, _prepare_experimental
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_nm as rn
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector

    g = torch.Generator(device="cpu").manual_seed(seed + 4)
    c = NAV_CHUNK
    e0 = euler0[:c]
    exp, sq = _prepare_experimental(rows[:c], None)
    tr = torch.tensor(np.deg2rad([1.0, 1.0, 1.0]), dtype=torch.float32, device=device)
    mask_idx = torch.nonzero(torch.rand(rows.shape[1], generator=g) > 0.3)[:, 0].to(device)
    exp_m, sq_m = _prepare_experimental(rows[:c], mask_idx)
    exp_1k, sq_1k = _prepare_experimental(rows[:c, :1000], None)
    pcs = torch.tensor(PC) + (torch.rand((c, 3), generator=g) - 0.5) * 0.04
    dc_pc = _dc_for_pc(pcs.to(device), *DETECTOR_SHAPE, om, None).contiguous()
    det_big = EBSDDetector(shape=(big_side, big_side), pc=PC, sample_tilt=70)
    dc_big = direction_cosines_from_detector(det_big, device=device)
    rot_big = torch.as_tensor(top1_rot[:big], dtype=torch.float32, device=device)
    rows_big = lp.lambert_project(rot_big, dc_big, quad, *geo)
    rows_big = rows_big + 0.05 * torch.randn(rows_big.shape, generator=g).to(device)
    exp_big, sq_big = _prepare_experimental(rows_big, None)
    axes = torch.randn((big, 3), generator=g, dtype=torch.float64)
    start_big = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), rot_big.double().cpu())
    e_big = tq.to_euler(start_big).to(torch.float32).to(device)
    cases = [
        ("trust region of 1 deg", (e0, exp, sq, dc, quad), dict(lower=e0 - tr, upper=e0 + tr)),
        (f"signal mask (P={mask_idx.numel()})", (e0, exp_m, sq_m, dc[mask_idx].contiguous(), quad), {}),
        ("P=1000", (e0, exp_1k, sq_1k, dc[:1000].contiguous(), quad), {}),
        ("one PC a point", (e0, exp, sq, dc_pc, quad), {}),
        ("B=1", (e0[:1], exp[:1], sq[:1], dc, quad), {}),
        (f"{big_side} x {big_side} detector (P={dc_big.shape[0]}, resident {rn.resident(dc_big.shape[0])})",
         (e_big, exp_big, sq_big, dc_big, quad), {}),
    ]
    msgs = []
    for label, (e, x, q, dcc, qd), bounds in cases:
        ref = host_loop(e, x, q, dcc, qd, geo, nm_kw, **bounds)
        kw = dict(nm_kw) if not bounds else dict(nm_kw, lower_bounds=bounds["lower"], upper_bounds=bounds["upper"])
        got = rn.nelder_mead_orientation(e, x, q, dcc, qd, *geo, **kw)
        torch.cuda.synchronize()
        msgs.append(nm_agreement(label, got, ref)[1])
    return msgs


def pc_problem(mode: str, pc0, exp, sq_norm, rot_q, euler0, quad, om, take, geo, shape, box=None):
    """The PC (``mode`` "pc") or joint wrapper, its host loop, and their
    arguments and keywords as ``refine_projection_center`` and
    ``refine_orientation_projection_center`` pass them at their defaults;
    ``box`` the trust region's half-widths."""
    import torch

    from kikuchipy_tpu_torch.ops import refine_nm as rn

    if mode == "pc":
        fns = (rn.nelder_mead_projection_center, rn.nelder_mead_projection_center_plain)
        args = (pc0, exp, sq_norm, rot_q, quad, om, take, *geo, *shape)
        kw = dict(initial_step=0.01, max_iters=150, fatol=1e-4, xatol=1e-5)
    else:
        fns = (rn.nelder_mead_orientation_projection_center, rn.nelder_mead_orientation_projection_center_plain)
        args = (torch.cat([euler0, pc0], dim=1), exp, sq_norm, quad, om, take, *geo, *shape)
        kw = dict(initial_step=torch.tensor([np.deg2rad(1.0)] * 3 + [0.01] * 3, dtype=torch.float32,
                                            device=pc0.device), max_iters=200, fatol=1e-4, xatol=1e-5)
    if box is not None:
        kw.update(lower_bounds=args[0] - box, upper_bounds=args[0] + box)
    return fns, args, kw


def pc_edge_cases(device, mode: str, rows, rot_q, euler0, quad, geo, top1_rot, seed: int, big: int = 48,
                  big_side: int = 240) -> list[str]:
    """The PC or joint kernel against its host loop on a navigation chunk of
    the main path with a trust region, a signal mask and P=1000, on one
    point, and on a 240 x 240 detector (past the shared-memory budget: the
    two-pass branch) over 48 points; starts from the PC off by PC_OFFSET."""
    import torch

    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector

    g = torch.Generator(device="cpu").manual_seed(seed + 5)
    c = NAV_CHUNK
    start_pc = np.asarray(PC) + np.asarray(PC_OFFSET)

    def pc0(n):
        return torch.as_tensor(np.tile(start_pc, (n, 1)), dtype=torch.float32, device=device)

    det = EBSDDetector(shape=DETECTOR_SHAPE, pc=PC, sample_tilt=70)
    om = torch.as_tensor(np.ascontiguousarray(det.sample_to_detector.T), dtype=torch.float32, device=device)
    exp, sq = _prepare_experimental(rows[:c], None)
    keep = torch.nonzero(torch.rand(rows.shape[1], generator=g) > 0.3)[:, 0].to(device)
    exp_m, sq_m = _prepare_experimental(rows[:c], keep)
    first = torch.arange(1000, device=device)
    exp_1k, sq_1k = _prepare_experimental(rows[:c], first)
    box = torch.tensor(([np.deg2rad(1.0)] * 3 if mode == "joint" else []) + [0.006] * 3, dtype=torch.float32,
                       device=device)
    det_big = EBSDDetector(shape=(big_side, big_side), pc=PC, sample_tilt=70)
    om_big = torch.as_tensor(np.ascontiguousarray(det_big.sample_to_detector.T), dtype=torch.float32, device=device)
    rot_big = torch.as_tensor(top1_rot[:big], dtype=torch.float32, device=device)
    rows_big = lp.lambert_project(rot_big, direction_cosines_from_detector(det_big, device=device), quad, *geo)
    rows_big = rows_big + 0.05 * torch.randn(rows_big.shape, generator=g).to(device)
    exp_big, sq_big = _prepare_experimental(rows_big, None)
    axes = torch.randn((big, 3), generator=g, dtype=torch.float64)
    start_big = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), rot_big.double().cpu())
    e_big = tq.to_euler(start_big).to(torch.float32).to(device)
    q, e = rot_q[:c], euler0[:c]
    cases = [
        ("trust region", (pc0(c), exp, sq, q, e, quad, om, None, geo, DETECTOR_SHAPE, box)),
        (f"signal mask (P={keep.numel()})", (pc0(c), exp_m, sq_m, q, e, quad, om, keep, geo, DETECTOR_SHAPE)),
        ("P=1000", (pc0(c), exp_1k, sq_1k, q, e, quad, om, first, geo, DETECTOR_SHAPE)),
        ("B=1", (pc0(1), exp[:1], sq[:1], q[:1], e[:1], quad, om, None, geo, DETECTOR_SHAPE)),
        (f"{big_side} x {big_side} detector (P={big_side * big_side})",
         (pc0(big), exp_big, sq_big, rot_big, e_big, quad, om_big, None, geo, (big_side, big_side))),
    ]
    msgs = []
    for label, case in cases:
        (wrapper, plain), args, kw = pc_problem(mode, *case)
        ref = plain(*args, **kw)
        got = wrapper(*args, **kw)
        torch.cuda.synchronize()
        msgs.append(nm_agreement(label, got, ref, mode)[1])
    return msgs


# ------------------ kernel C (the tangent kernel) vs plain ------------------ #

# Each refinement mode's refine_* call, its tangent wrapper and its d.
LM_CALL = {"orientation": "refine_orientation", "pc": "refine_projection_center",
           "joint": "refine_orientation_projection_center"}
LM_WRAPPER = {"orientation": "tangent_orientation", "pc": "tangent_projection_center",
              "joint": "tangent_orientation_projection_center"}
# ... its Levenberg-Marquardt wrapper (the loop kernel, one launch a call)
# and refine_*'s trust regions: 3 degrees of rotation vector, 0.05 of PC.
LM_LOOP = {"orientation": "levenberg_marquardt_orientation", "pc": "levenberg_marquardt_projection_center",
           "joint": "levenberg_marquardt_orientation_projection_center"}
LM_BLOCKS = {"orientation": ((3, float(np.deg2rad(3.0))),), "pc": ((3, 0.05),),
             "joint": ((3, float(np.deg2rad(3.0))), (3, 0.05))}
LM_DIMS = {"orientation": 3, "pc": 3, "joint": 6}
# Kernel C against its plain version at the same points. Its pixel is kernel
# A's (its sim equals lambert_project's bit for bit), so its yardstick is the
# plain version run on float64 operands: J^T r and J^T J no further from it
# than LM_FACTOR x the float32 plain version, or LM_REL of their norms, and
# f = 0.5 ||r||^2 no further than LM_FACTOR x the float32 one's, or
# LM_F_TOL, in every mode and case. Against the float32 plain version f
# within LM_F_TOL (float32 sums of 3600 squares in other orders) in every
# case; the distances of J^T r and J^T J are printed, with whether they
# meet LM_REL (on the main path's rows at 2,048 points the float32 plain
# version is 3.5e-3 to 2.4e-2 of the norm off the float64 one in J^T r and
# 2.1e-3 to 1.4e-2 in J^T J, the kernel 7e-4 to 7e-3 and 1.1e-3 to 3.4e-3,
# so none does; PERF.md names them). At the pole rotations the float32 plain
# version's 1 - |wz| cancels and its f is about 4e-6 off the float64 one's,
# the kernel's 3e-7: there |df| against it is printed as not met, and f is
# held to LM_F_TOL of the float64 one instead, only while the float32 one
# is itself more than LM_F_TOL off it.
LM_F_TOL = 2e-6
LM_REL = 1e-4
LM_FACTOR = 2.0
LM_POLE_CASE = "pole rotations"
# A whole LM run on the kernel against one on the plain version: on at least
# NM_AGREE of the points 0.5 ||r||^2 within NM_FUN_TOL, rotations within
# NM_DEG and PCs within LM_PC_TOL; iteration counts are printed (at the
# optimum a step changes f by less than its rounding, and the two may stop
# one step or six rejections apart).
LM_PC_TOL = 1e-4
# The LM loop kernel against the host loop on kernel C: the same criteria,
# and on at least LM_ITER_AGREE of the points the same iterations (91-94%
# were measured between LM runs on kernel C and on its plain version, which
# round apart; PERF.md).
LM_ITER_AGREE = 0.9


def unit_quats(q) -> np.ndarray:
    """Rows of ``q`` in float64 scaled to unit length: float32 quaternions
    are unit only to about 1e-7, which a disorientation through arccos turns
    into up to 0.05 degrees between a rotation and itself."""
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def lm_ops_per_pixel(mode: str) -> int:
    """float32 operations of one pixel of kernel C, an FMA counted as two:
    the value (LM_VALUE_OPS_PER_PIXEL), in the PC modes after its direction
    cosine (DC_OPS_PER_PIXEL); its gradient with respect to the rotated
    direction (LM_GRAD_OPS_PER_PIXEL); the tangents (the three rotation-vector
    components 24 together: o x G 9, three dot products 15; the three PC
    components 19: a reciprocal and N^T G / |w|); the three passes' sums: the
    means 1 + d, the centred sums 2 + 2 d + d (d + 1), the residual's 3 + 2
    (d + 2). (The pixel it replaced, the float32 twin's rounding with its
    gradient through the normalisation: 218 / 248 / 347.)"""
    d = LM_DIMS[mode]
    tangents = (24 if mode != "pc" else 0) + (19 if mode != "orientation" else 0)
    sums = (1 + d) + (2 + 2 * d + d * (d + 1)) + (3 + 2 * (d + 2))
    return (LM_VALUE_OPS_PER_PIXEL + (DC_OPS_PER_PIXEL if mode != "orientation" else 0) + LM_GRAD_OPS_PER_PIXEL
            + tangents + sums)


def lm_problem(mode: str, rows, x, q0, pc0, take, quad, om, dc, geo, shape):
    """(kernel wrapper, plain version, x, arguments) of kernel C in ``mode``
    on the rows ``rows`` (their pixels ``take`` or all)."""
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    exp, _ = _prepare_experimental(rows, take)
    unit = rl.unit_rows(exp)
    if mode == "orientation":
        return rl.tangent_orientation, rl.tangent_orientation_plain, x, (q0, unit, dc, quad, *geo)
    if mode == "pc":
        return (rl.tangent_projection_center, rl.tangent_projection_center_plain, x,
                (pc0, unit, q0, quad, om, take, *geo, *shape))
    return (rl.tangent_orientation_projection_center, rl.tangent_orientation_projection_center_plain, x,
            (q0, pc0, unit, quad, om, take, *geo, *shape))


def lm_errors(got, ref) -> tuple[float, float, float]:
    """max |f - f_ref|, and max |g - g_ref| / |g_ref| and |H - H_ref| /
    |H_ref| over the points."""
    import torch

    (f, g, h), (rf, rg, rh) = got, ref
    return (float((f.double() - rf.double()).abs().max()),
            float((torch.linalg.vector_norm((g.double() - rg.double()), dim=1)
                   / torch.linalg.vector_norm(rg.double(), dim=1)).max()),
            float((torch.linalg.matrix_norm(h.double() - rh.double()) / torch.linalg.matrix_norm(rh.double())).max()))


def float64_args(args) -> tuple:
    """A plain version's arguments with every floating-point tensor in
    float64 (the float64 twin's)."""
    import torch

    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args)


def lm_float64(plain, x, args):
    """(f, g, J^T J) of the plain version ``plain`` with every operand and
    operation in float64."""
    return plain(x.double(), *float64_args(args))


def lm_checks(device, rows, rot_q, quad, geo, om, dc, seed: int) -> tuple[dict, list[str]]:
    """Kernel C against its plain version at the same points on one
    navigation chunk of the main path's rows: every mode, all pixels, a
    signal mask and P=1000; orientation mode also one PC a point and pole
    rotations (one pixel of each within 1e-3 rad of a Lambert pole, the
    first two on it). Each case: the kernel's sim equal to kernel A's
    lambert_project bit for bit (the PC modes on pc_direction_cosines'
    rows), the float64 criterion, and f within LM_F_TOL of the float32
    plain version (in the pole case, f within LM_F_TOL of the float64 one
    while the float32 one is not). Returns each mode's largest errors
    against the float32 plain version and the messages."""
    import torch

    from kikuchipy_tpu_torch.indexing.refinement import _dc_for_pc
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_lm as rl
    from kikuchipy_tpu_torch.ops.refine_nm import pc_direction_cosines

    g = torch.Generator(device="cpu").manual_seed(seed + 6)
    c = NAV_CHUNK
    rows = rows[:c]
    q0 = rot_q[:c].contiguous()
    keep = torch.nonzero(torch.rand(rows.shape[1], generator=g) > 0.3)[:, 0].to(device)
    first = torch.arange(1000, device=device)
    delta = (torch.randn((c, 3), generator=g) * 0.01).to(device)
    dpc = (torch.randn((c, 3), generator=g) * 0.004).to(device)
    pc0 = torch.as_tensor(np.tile(np.asarray(PC) + np.asarray(PC_OFFSET), (c, 1)), dtype=torch.float32, device=device)
    pcs = torch.tensor(PC) + (torch.rand((c, 3), generator=g) - 0.5) * 0.04
    dc_pc = _dc_for_pc(pcs.to(device), *DETECTOR_SHAPE, om, None).contiguous()
    poles = torch.as_tensor(pole_rotations(dc.cpu().numpy(), c, seed + 7), device=device)
    cases = {
        "orientation": [("all pixels", delta, q0, None, dc), (f"signal mask (P={keep.numel()})", delta, q0, keep,
                        dc[keep].contiguous()), ("one PC a point", delta, q0, None, dc_pc),
                        ("P=1000", delta, q0, first, dc[:1000].contiguous()),
                        (LM_POLE_CASE, torch.zeros_like(delta), poles, None, dc)],
        "pc": [("all pixels", dpc, q0, None, None), (f"signal mask (P={keep.numel()})", dpc, q0, keep, None),
               ("P=1000", dpc, q0, first, None)],
        "joint": [("all pixels", torch.cat([delta, dpc], 1), q0, None, None),
                  (f"signal mask (P={keep.numel()})", torch.cat([delta, dpc], 1), q0, keep, None),
                  ("P=1000", torch.cat([delta, dpc], 1), q0, first, None)],
    }
    worst, msgs, bad = {}, [], []
    for mode, mode_cases in cases.items():
        worst[mode] = [0.0, 0.0, 0.0]
        for label, x, q, take, dcc in mode_cases:
            wrapper, plain, x, args = lm_problem(mode, rows, x, q, pc0, take, quad, om, dcc, geo, DETECTOR_SHAPE)
            sim = torch.empty((x.shape[0], args[2 if mode == "joint" else 1].shape[1]), device=device)
            got = wrapper(x, *args, sim=sim)
            torch.cuda.synchronize()
            ref = plain(x, *args)
            err = lm_errors(got, ref)
            worst[mode] = [max(a, b) for a, b in zip(worst[mode], err)]
            # Kernel A at the same rotation and direction cosines.
            rot = q if mode == "pc" else rl._rotation(q, x[:, :3].contiguous())
            dca = dcc if mode == "orientation" else pc_direction_cosines(
                pc0 + x[:, -3:], *DETECTOR_SHAPE, om, take).contiguous()
            same_a = bool(torch.equal(sim, lp.lambert_project(rot.contiguous(), dca, quad, *geo)))
            ref64 = lm_float64(plain, x, args)
            ek, et = lm_errors(got, ref64), lm_errors(ref, ref64)
            f_ok = err[0] <= LM_F_TOL
            # Only at the pole, and only while the float32 plain version is
            # the one off float64, does f answer to float64 alone.
            f_pole = label == LM_POLE_CASE and ek[0] <= LM_F_TOL < et[0]
            rel_ok = err[1] <= LM_REL and err[2] <= LM_REL
            msg = (f"{mode} {label}: sim equal to kernel A's {same_a}; against the float32 plain version |df| "
                   f"{err[0]:.2e}{'' if f_ok else ' (NOT MET: over ' + format(LM_F_TOL, 'g') + ')'}, |dg|/|g| "
                   f"{err[1]:.2e}, |dJtJ|/|JtJ| {err[2]:.2e} ({'within' if rel_ok else 'over'} {LM_REL:g}); against "
                   f"float64 kernel |df| {ek[0]:.2e}, {ek[1]:.2e}, {ek[2]:.2e}, the float32 plain version {et[0]:.2e}, "
                   f"{et[1]:.2e}, {et[2]:.2e}")
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            ok = (finite and same_a and (f_ok or f_pole) and ek[0] <= max(LM_F_TOL, LM_FACTOR * et[0])
                  and all(ek[i] <= max(LM_REL, LM_FACTOR * et[i]) for i in (1, 2)))
            msgs.append(msg)
            if not ok:
                bad.append(msg)
            del got, ref, ref64, sim
    if bad:
        raise AssertionError("kernel C disagrees with its plain version: " + "; ".join(bad))
    return worst, msgs


def lm_run_agreement(device, rows, rot_q, quad, geo, om, dc) -> list[str]:
    """A whole LM run (refine_*'s settings: at most 30 iterations, ftol 1e-6,
    3 degrees and 0.05 trust regions) on kernel C against one on its plain
    version, on one navigation chunk in every mode; the mean float64 0.5
    ||r||^2 at both runs' points within NM_MEAN_TOL of each other."""
    import torch

    from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle
    from kikuchipy_tpu_torch.ops import refine_lm as rl
    from kikuchipy_tpu_torch.utils.optimize import _levenberg_marquardt_normal

    c = NAV_CHUNK
    q0 = rot_q[:c].contiguous()
    pc0 = torch.as_tensor(np.tile(np.asarray(PC) + np.asarray(PC_OFFSET), (c, 1)), dtype=torch.float32, device=device)
    blocks = LM_BLOCKS
    msgs = []
    for mode in ("orientation", "pc", "joint"):
        d = LM_DIMS[mode]
        wrapper, plain, x0, args = lm_problem(mode, rows[:c], torch.zeros((c, d), device=device), q0, pc0, None, quad,
                                              om, dc, geo, DETECTOR_SHAPE)
        kw = dict(max_iters=30, ftol=1e-6, blocks=blocks[mode], args=args)
        got = _levenberg_marquardt_normal(wrapper, x0, **kw)
        ref = _levenberg_marquardt_normal(plain, x0, **kw)
        torch.cuda.synchronize()
        fun_ok = float(((got.fun - ref.fun).abs() <= NM_FUN_TOL).float().mean())
        oks = [fun_ok]
        msg = (f"{mode}: 0.5 |r|^2 within {NM_FUN_TOL:g} on {fun_ok:.4f} (max {float((got.fun - ref.fun).abs().max()):.2e}, "
               f"mean kernel - plain {float((got.fun.double() - ref.fun.double()).mean()):.2e}), iterations equal "
               f"{float((got.n_iter == ref.n_iter).float().mean()):.4f} (mean {float(got.n_iter.float().mean()):.2f} "
               f"vs {float(ref.n_iter.float().mean()):.2f})")
        if mode != "pc":
            ra = unit_quats(rl._rotation(q0, got.x[:, :3]).cpu().numpy())
            rb = unit_quats(rl._rotation(q0, ref.x[:, :3]).cpu().numpy())
            ang = np.degrees(disorientation_angle(ra, rb, "m-3m"))
            oks.append(float((ang <= NM_DEG).mean()))
            msg += f", rotations within {NM_DEG} deg {oks[-1]:.4f}"
        if mode != "orientation":
            dp = (got.x[:, -3:] - ref.x[:, -3:]).abs().amax(dim=1)
            oks.append(float((dp <= LM_PC_TOL).float().mean()))
            msg += f", PCs within {LM_PC_TOL:g} {oks[-1]:.4f} (max {float(dp.max()):.2e})"
        residual = {"orientation": rl.orientation_residual, "pc": rl.pc_residual, "joint": rl.joint_residual}[mode]
        args64 = float64_args(args)
        s_got, s_ref = (float((0.5 * residual(r.x.double(), *args64).square().sum(-1)).mean()) for r in (got, ref))
        msg += (f"; mean float64 0.5 |r|^2 at the kernel's points {s_got:.9f}, at the plain version's {s_ref:.9f} "
                f"(gap {s_got - s_ref:.2e}, limit {NM_MEAN_TOL:g})")
        if min(oks) < NM_AGREE or not bool(torch.isfinite(got.fun).all()) or not abs(s_got - s_ref) <= NM_MEAN_TOL:
            raise AssertionError(f"LM on kernel C disagrees with LM on its plain version: {msg}")
        msgs.append(msg)
    return msgs


def lm_loop_checks(device, rows, rot_q, quad, geo, om, dc) -> tuple[dict, list[str]]:
    """The LM loop kernel (one launch for all points) against the host loop
    on kernel C (levenberg_marquardt_batched over the tangent wrapper) at
    the whole map in every mode, at refine_*'s settings (at most 30
    iterations, ftol 1e-6, 3 degrees and 0.05 trust regions), from the DI
    top-1 and the PC off by PC_OFFSET. Per mode: the kernel's and the host
    loop's times, the evaluations and the largest |d fun|. Also the share of
    the first iteration's systems that the kernel's solve gives bit for bit
    as torch.linalg.solve_ex."""
    import torch

    from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    n = rows.shape[0]
    pc0 = torch.as_tensor(np.tile(np.asarray(PC) + np.asarray(PC_OFFSET), (n, 1)), dtype=torch.float32, device=device)
    out, msgs = {}, []
    for mode in ("orientation", "pc", "joint"):
        d = LM_DIMS[mode]
        tangent, _, x0, args = lm_problem(mode, rows, torch.zeros((n, d), device=device), rot_q, pc0, None, quad, om,
                                          dc, geo, DETECTOR_SHAPE)
        wrapper, host = getattr(rl, LM_LOOP[mode]), getattr(rl, LM_LOOP[mode] + "_plain")
        kw = dict(max_iters=30, ftol=1e-6, blocks=LM_BLOCKS[mode])
        got = wrapper(x0, *args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = host(x0, *args, **kw)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        ms = cuda_ms(lambda: wrapper(x0, *args, **kw), 3)
        dfun = (got.fun - ref.fun).abs()
        shares = {"fun": float((dfun <= NM_FUN_TOL).float().mean()),
                  "n_iter": float((got.n_iter == ref.n_iter).float().mean())}
        if mode != "pc":
            ra = unit_quats(rl._rotation(rot_q, got.x[:, :3].contiguous()).cpu().numpy())
            rb = unit_quats(rl._rotation(rot_q, ref.x[:, :3].contiguous()).cpu().numpy())
            shares["rotation"] = float((np.degrees(disorientation_angle(ra, rb, "m-3m")) <= NM_DEG).mean())
        if mode != "orientation":
            dp = (got.x[:, -3:] - ref.x[:, -3:]).abs().amax(dim=1)
            shares["pc"] = float((dp <= LM_PC_TOL).float().mean())
        same = float(((got.x == ref.x).all(dim=1) & (got.fun == ref.fun)).float().mean())
        # The first iteration's d x d systems at x = 0 (damping 1e-3).
        _, g, jtj = tangent(x0, *args)
        diag = torch.clamp_min(torch.diagonal(jtj, dim1=1, dim2=2), 1e-12)
        a = jtj + 1e-3 * (diag[:, :, None] * torch.eye(d, device=device))
        solve_same = float((rl.solve(a, g) == torch.linalg.solve_ex(a, g[..., None])[0][..., 0]).all(dim=1)
                           .float().mean())
        evals = int(got.n_evals.sum())
        msg = (f"{mode} (n={n}, shared-memory residency {rl.loop_residency(rows.shape[1], d)}): kernel {ms:.4f} ms, "
               f"host loop on kernel C {host_ms:.3f} ms; "
               f"shares {', '.join(f'{k} {v:.4f}' for k, v in shares.items())} (fun within {NM_FUN_TOL:g}, "
               f"rotations {NM_DEG} deg, PCs {LM_PC_TOL:g}; max |dfun| {float(dfun.max()):.2e}), bit for bit "
               f"{same:.4f}; iterations mean {float(got.n_iter.float().mean()):.3f} max {int(got.n_iter.max())} "
               f"(host {float(ref.n_iter.float().mean()):.3f}), converged {float(got.converged.float().mean()):.4f}; "
               f"evaluations {evals} ({evals / n:.3f} a point; the host loop's kernel C evaluated "
               f"{n * (int(ref.n_iter.max()) + 1)}); the first step's solve as solve_ex bit for bit on {solve_same:.4f}")
        finite = bool(torch.isfinite(got.fun).all())
        if (not finite or shares["n_iter"] < LM_ITER_AGREE
                or min(v for k, v in shares.items() if k != "n_iter") < NM_AGREE):
            raise AssertionError(f"the LM loop kernel disagrees with the host loop on kernel C: {msg}")
        out[mode] = {"ms": ms, "host_ms": host_ms, "evals": evals, "err": float(dfun.max()), "same": same}
        msgs.append(msg)
        del got, ref, a, g, jtj
    return out, msgs


# ------------------------- preprocessing ------------------------- #


def gray_diff(got, ref) -> tuple[float, float]:
    """Largest difference and the share of elements that differ."""
    import torch

    diff = (got.to(torch.float64) - ref.to(torch.float64)).abs()
    return float(diff.max()), float((diff > 0).to(torch.float64).mean())


def preprocess_checks(device, scan_u8, static_bg) -> tuple[dict, list[str]]:
    """Kernel D in both modes and kernel E against their plain versions on
    the whole scan (16,384 x 60 x 60 uint8) and on edge cases: float32
    outputs, division, ``scale_bg``, a ragged 57 x 61 crop; the static
    mode's two kernels on 1 x 16, 16 x 1, 40 x 40, 64 x 64, 80 x 80 and 480 x 480
    patterns, n of 1 and 13, a misaligned view, flat patterns (NaN before
    the cast), zeros in a divided background and out ranges in and past
    int32, each on the kernel ``static_path`` chose; the dynamic mode's two
    kernels on the scan (subtract and divide), n of 1 and 13, a misaligned
    view, 64 x 64, 57 x 61, 180 x 180 (the block kernel's scratch), uint16
    in and float32 out, each on the kernel ``dynamic_path`` chose; CLAHE at
    its defaults, with clipping, n of 1 and 13, a misaligned view, with 7 x 7
    tiles (the reflect pad), 57 x 61, rows wider than 64 pixels (8 x 500,
    4 x 1020), uint16 input, float32 out and 480 x 480 patterns (its
    blended values in device memory), each on the kernel
    ``clahe_path`` chose. Static mode bit for bit; the dynamic mode and
    kernel E within one gray level on at most GRAY_SHARE of the pixels
    (float32 outputs within 1e-5 of the range); each pair kernel's bytes the
    block kernel's."""
    import torch

    from kikuchipy_tpu_torch.ops import ahe
    from kikuchipy_tpu_torch.ops import background as bgk
    from kikuchipy_tpu_torch.ops import pattern as tops

    flat = scan_u8.reshape(-1, *scan_u8.shape[-2:])
    ragged = flat[:, :57, :61].contiguous()
    bg = torch.as_tensor(static_bg, dtype=torch.float32, device=device)
    msgs, errs = [], {"static": 0.0, "dynamic": 0.0, "clahe": 0.0}

    def operators(shape):
        plan = tops.dynamic_background_separable_plan(tuple(shape), shape[1] / 8)
        return torch.as_tensor(plan.row_op, device=device), torch.as_tensor(plan.col_op, device=device)

    cases = []
    for label, data in (("scan", flat), ("57x61", ragged)):
        b = bg[: data.shape[-2], : data.shape[-1]].contiguous()
        cases += [
            (f"static {label} subtract uint8", data, dict(static_bg=b), np.uint8),
            (f"static {label} subtract float32", data, dict(static_bg=b), np.float32),
            (f"static {label} divide uint8", data, dict(static_bg=b, op="divide"), np.uint8),
            (f"static {label} scale_bg uint8", data, dict(static_bg=b, scale_bg=True), np.uint8),
        ]
    for label, data, kw, dtype_out in cases:
        kw = dict(kw)
        op = kw.pop("op", "subtract")
        omin, omax = (0, 255) if dtype_out == np.uint8 else (-1.0, 1.0)
        got = bgk.remove_background(data, op, omin, omax, dtype_out, **kw)
        ref = bgk.remove_background_plain(data, op, omin, omax, dtype_out, **kw)
        torch.cuda.synchronize()
        worst, share = gray_diff(got, ref)
        if not torch.equal(got, ref):
            raise AssertionError(f"kernel D disagrees with its plain version ({label}): max {worst:g}, "
                                 f"{share:.2e} of the pixels differ")
        msgs.append(f"{label}: max {worst:g}, {share:.2e} differ")
    # The static mode's two kernels (bgk.static_path): each case takes the
    # kernel the wrapper chose, bit for bit with the plain version.
    wide = flat[:4096].repeat(1, 2, 2)
    odd = torch.empty(13 * 3600 + 1, dtype=torch.uint8, device=device)
    odd[1:].copy_(flat[:13].reshape(-1))
    flat_bg = torch.full((60, 60), 5.0, device=device)
    level = flat[:64].clone()
    level[0] = 5  # p - bg == 0 everywhere: the range is 0 and every output NaN, cast to 0
    level[1] = 200
    zeros_bg = bg.clone()
    zeros_bg[::7, ::5] = 0.0  # p / 0: inf, or NaN where p is 0 too
    holes = flat[:256].clone()
    holes[:, ::14, ::10] = 0
    static_cases = (
        ("1x16", flat[:, :1, :16].contiguous(), bg[:1, :16].contiguous(), {}),
        ("16x1", flat[:, :16, :1].contiguous(), bg[:16, :1].contiguous(), {}),
        ("40x40", flat[:, :40, :40].contiguous(), bg[:40, :40].contiguous(), {}),
        ("64x64", wide[:, :64, :64].contiguous(), wide[0, :64, :64].float().contiguous(), {}),
        ("80x80 divide", wide[:, :80, :80].contiguous(), wide[1, :80, :80].float().contiguous() + 1,
         {"op": "divide"}),
        ("480x480", flat[:64].repeat_interleave(8, dim=-2).repeat_interleave(8, dim=-1).contiguous(),
         bg.repeat_interleave(8, dim=-2).repeat_interleave(8, dim=-1).contiguous(), {}),
        ("n=1", flat[:1], bg, {}),
        ("n=13 scale_bg", flat[:13], bg, {"scale_bg": True}),
        ("n=13 misaligned", odd[1:].view(13, 60, 60), bg, {}),
        ("flat patterns", level, flat_bg, {}),
        ("zeros in the background, divide", holes, zeros_bg, {"op": "divide"}),
        ("scale_bg divide", flat, bg, {"op": "divide", "scale_bg": True}),
        ("out_range (10, 200)", flat, bg, {"out": (10, 200)}),
        ("out_range past int32", flat[:512], bg, {"out": (-3e9, 3e9)}),
    )
    for label, data, b, kw in static_cases:
        kw = dict(kw)
        op = kw.pop("op", "subtract")
        omin, omax = kw.pop("out", (0, 255))
        sy, sx = data.shape[-2:]
        want, vec = bgk.static_path(sy, sx, data.dtype, np.uint8, omin, omax, aligned=data.data_ptr() % 16 == 0)
        before = dict(bgk.remove_background.mode_launches)
        got = bgk.remove_background(data, op, omin, omax, np.uint8, static_bg=b, **kw)
        ref = bgk.remove_background_plain(data, op, omin, omax, np.uint8, static_bg=b, **kw)
        torch.cuda.synchronize()
        took = [k for k in ("warp", "block") if bgk.remove_background.mode_launches[f"static-{k}"]
                > before[f"static-{k}"]]
        if took != [want]:
            raise AssertionError(f"kernel D static ({label}) took {took}, static_path chose {want}")
        worst, share = gray_diff(got, ref)
        if not torch.equal(got, ref):
            raise AssertionError(f"kernel D static ({label}, {want}) disagrees with its plain version: max "
                                 f"{worst:g}, {share:.2e} of the pixels differ")
        errs["static"] = max(errs["static"], worst)
        msgs.append(f"static {label} ({want}{f', {vec} vectors a lane' if vec else ''}): bit for bit")
    # The dynamic mode's two kernels (bgk.dynamic_path): each case takes the
    # kernel the wrapper chose, within the gates of the plain version, and
    # the pair kernel's bytes are the block kernel's.
    big = flat[:64].repeat_interleave(3, dim=-2).repeat_interleave(3, dim=-1).contiguous()
    dynamic_cases = (
        ("scan", flat, np.uint8, {}),
        ("scan divide", flat, np.uint8, {"op": "divide"}),
        ("scan float32 out", flat, np.float32, {}),
        ("n=1", flat[:1], np.uint8, {}),
        ("n=13", flat[:13], np.uint8, {}),
        ("n=13 misaligned", odd[1:].view(13, 60, 60), np.uint8, {}),
        ("64x64", wide[:, :64, :64].contiguous(), np.uint8, {}),
        ("57x61", ragged, np.uint8, {}),
        ("57x61 divide", ragged, np.uint8, {"op": "divide"}),
        ("57x61 float32 out", ragged, np.float32, {}),
        ("180x180 (scratch)", big, np.uint8, {}),
        ("uint16 in", (flat[:512].to(torch.int32) * 257).to(torch.uint16), np.uint8, {}),
    )
    for label, data, dtype_out, kw in dynamic_cases:
        op = kw.get("op", "subtract")
        omin, omax = (0, 255) if dtype_out == np.uint8 else (-1.0, 1.0)
        row, col = operators(data.shape[-2:])
        want, pairs = bgk.dynamic_path(*data.shape[-2:], data.dtype, dtype_out, omin, omax,
                                       aligned=data.data_ptr() % 16 == 0)
        before = dict(bgk.remove_background.mode_launches)
        got = bgk.remove_background(data, op, omin, omax, dtype_out, row_op=row, col_op=col)
        ref = bgk.remove_background_plain(data, op, omin, omax, dtype_out, row_op=row, col_op=col)
        torch.cuda.synchronize()
        took = [k for k in ("pair", "block") if bgk.remove_background.mode_launches[f"dynamic-{k}"]
                > before[f"dynamic-{k}"]]
        if took != [want]:
            raise AssertionError(f"kernel D dynamic ({label}) took {took}, dynamic_path chose {want}")
        worst, share = gray_diff(got, ref)
        ok = (worst <= 1 and share <= GRAY_SHARE) if dtype_out == np.uint8 else worst <= 1e-5 * (omax - omin)
        if not ok:
            raise AssertionError(f"kernel D dynamic ({label}, {want}) disagrees with its plain version: max {worst:g}, "
                                 f"{share:.2e} of the pixels differ")
        same = ""
        if want == "pair":
            with forced_block(bgk, "dynamic_path"):
                block = bgk.remove_background(data, op, omin, omax, dtype_out, row_op=row, col_op=col)
            if not torch.equal(got, block):
                raise AssertionError(f"kernel D dynamic ({label}): the pair kernel's bytes are not the block kernel's")
            same = ", the block kernel's bytes"
        if dtype_out == np.uint8:
            errs["dynamic"] = max(errs["dynamic"], worst)
        msgs.append(f"dynamic {label} ({want}{f', {pairs} pairs a block' if pairs else ''}): max {worst:g}, "
                    f"{share:.2e} differ{same}")
    del wide, odd, level, holes, big
    row, col = operators(flat.shape[-2:])
    pre = bgk.remove_background(flat, "subtract", 0, 255, np.uint8, row_op=row, col_op=col)
    odd = torch.empty(13 * 3600 + 1, dtype=torch.uint8, device=device)
    odd[1:].copy_(pre[:13].reshape(-1))
    for label, data, kw in (
        ("defaults", pre, {}),
        ("clip_limit=0.02", pre, {"clip_limit": 0.02}),
        ("n=1", pre[:1], {}),
        ("n=13", pre[:13], {}),
        ("n=13 misaligned", odd[1:].view(13, 60, 60), {}),
        ("kernel_size=(7, 7)", pre, {"kernel_size": (7, 7)}),
        ("57x61", pre[:, :57, :61].contiguous(), {}),
        # Rows wider than 64 pixels: each word's row by pair_row's product.
        ("8x500", pre[:400].reshape(360, 8, 500), {}),
        ("4x1020", pre[:1020].reshape(900, 4, 1020), {}),
        ("uint16", (pre.to(torch.int32) * 257).to(torch.uint16), {}),
        ("float32 out", pre[:512], {"dtype_out": np.float32}),
        # 480 x 480 (the defaults' 120 x 120 tiles): the blended values go to
        # device memory.
        ("480x480", pre[:256].repeat_interleave(8, dim=-2).repeat_interleave(8, dim=-1).contiguous(), {}),
    ):
        sy, sx = data.shape[-2:]
        ky, kx = kw.get("kernel_size", (sy // 4, sx // 4))
        dtype_out = kw.get("dtype_out", data.dtype)
        want, pairs = ahe.clahe_path(sy, sx, ky, kx, 128, data.dtype, dtype_out, aligned=data.data_ptr() % 16 == 0)
        before = dict(ahe.clahe.mode_launches)
        got = ahe.adaptive_histogram_equalization(data, device=device, **kw)
        chunk = max(512 * 3600 // (sy * sx), 1)
        ref = ahe.clahe_plain(data, ky, kx, 128, kw.get("clip_limit", 0.0), dtype_out, chunk=chunk)
        torch.cuda.synchronize()
        took = [k for k in ("pair", "block") if ahe.clahe.mode_launches[k] > before[k]]
        if took != [want]:
            raise AssertionError(f"kernel E ({label}) took {took}, clahe_path chose {want}")
        worst, share = gray_diff(got, ref)
        ok = worst <= 1e-5 if got.dtype.is_floating_point else (worst <= 1 and share <= GRAY_SHARE)
        if not ok:
            raise AssertionError(f"kernel E disagrees with its plain version ({label}, {want}): max {worst:g}, "
                                 f"{share:.2e} of the pixels differ")
        same = ""
        if want == "pair":
            with forced_block(ahe, "clahe_path"):
                block = ahe.adaptive_histogram_equalization(data, device=device, **kw)
            if not torch.equal(got, block):
                raise AssertionError(f"kernel E ({label}): the pair kernel's bytes are not the block kernel's")
            same = ", the block kernel's bytes"
        if data.dtype == torch.uint8 and not got.dtype.is_floating_point:
            errs["clahe"] = max(errs["clahe"], worst)
        msgs.append(f"clahe {label} ({want}{f', {pairs} pairs a block' if pairs else ''}): max {worst:g}, "
                    f"{share:.2e} differ{same}")
    return errs, msgs


@contextlib.contextmanager
def forced_block(module, chooser: str):
    """Within the context ``module``'s ``chooser`` picks the block kernel:
    the one each pair kernel's bytes are held to."""
    chosen = getattr(module, chooser)
    setattr(module, chooser, lambda *a, **k: ("block", 0))
    try:
        yield
    finally:
        setattr(module, chooser, chosen)


def tutorial_chain(signal, window_cls, timings=None):
    """kikuchipy's tutorial preprocessing on an ``EBSD``: static and dynamic
    background removal, the band-pass of its FFT-filtering example, a
    spatial Gaussian, CLAHE and normalization to float32. With ``timings``
    each step's milliseconds (host clock, synchronized) are added to it."""
    import torch

    band = window_cls("lowpass", cutoff=22, cutoff_width=10, shape=(60, 60)) * window_cls(
        "highpass", cutoff=1, cutoff_width=0.5, shape=(60, 60))
    steps = (
        ("remove_static_background", lambda s: s.remove_static_background()),
        ("remove_dynamic_background", lambda s: s.remove_dynamic_background()),
        ("fft_filter (band-pass, frequency)", lambda s: s.fft_filter(band, function_domain="frequency", shift=True)),
        ("fft_filter (gaussian, spatial)",
         lambda s: s.fft_filter(window_cls("gaussian", std=1), function_domain="spatial")),
        ("adaptive_histogram_equalization", lambda s: s.adaptive_histogram_equalization()),
        ("normalize_intensity", lambda s: s.normalize_intensity(dtype_out=np.float32)),
    )
    for name, step in steps:
        t0 = time.perf_counter()
        signal = step(signal)
        if timings is not None:
            torch.cuda.synchronize()
            timings[name] = timings.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
    return signal


def preprocess_phase(device, scan, smi: str) -> tuple[dict, list[str]]:
    """BASELINE config 3's chain on the main path's scan and on it tiled
    PREPROCESS_TILES times: MB/s of uint8 in for each step and the chain,
    kernel D's and E's launches, the device busy share under
    ``torch.profiler``, and the output's check: float32 of the input's shape,
    and on the scan's first CHAIN_CHECK_PATTERNS patterns the same chain run
    on the CPU, where each step is its plain version (``remove_background_plain``,
    ``clahe_plain``, ``torch.fft``), within the CPU tests' tolerance against
    JAX (median |diff| < 1e-5, under 1% of the pixels off by more than 0.05)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.filters import Window

    out = {}
    msgs = []
    for tiles in (1, PREPROCESS_TILES):
        data = scan.data if tiles == 1 else scan.data.repeat(tiles, 1, 1, 1)
        sig = kt.EBSD(data, static_background=scan.static_background, device=device)
        mb = data.numel() / 1e6
        tutorial_chain(sig, Window)  # warm-up: cuFFT plans, the kernels' first launches
        torch.cuda.synchronize()
        reset_launches()
        timings = {}
        t0 = time.perf_counter()
        result = tutorial_chain(sig, Window, timings)
        torch.cuda.synchronize()
        chain_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        if launches["remove_background"] != 2 or launches["clahe"] != 1:
            raise AssertionError(f"the chain did not run on kernels D (2) and E (1): {launches}")
        if launches["remove_background[dynamic-pair]"] != 1 or launches["clahe[pair]"] != 1:
            raise AssertionError(f"the chain's dynamic removal and CLAHE did not take the pair kernels: {launches}")
        res = result.data
        if tuple(res.shape) != tuple(data.shape) or res.dtype != torch.float32 or not bool(torch.isfinite(res).all()):
            raise AssertionError(f"the chain's output is {tuple(res.shape)} {res.dtype}, finite "
                                 f"{bool(torch.isfinite(res).all())}")
        busy = None
        check_msg = ""
        if tiles == 1:
            k = CHAIN_CHECK_PATTERNS
            plain = tutorial_chain(kt.EBSD(data.reshape(-1, 60, 60)[:k].cpu(), static_background=scan.static_background,
                                           device="cpu"), Window).data
            diff = (res.reshape(-1, 60, 60)[:k].cpu() - plain).abs()
            median, share = float(diff.median()), float((diff > 0.05).to(torch.float64).mean())
            if not (bool(torch.isfinite(diff).all()) and median < 1e-5 and share < 0.01):
                raise AssertionError(f"the chain on the card disagrees with its plain versions on the CPU: median "
                                     f"|diff| {median:g}, {share:.2e} of the pixels off by > 0.05")
            check_msg = (f"; against the plain chain on the CPU ({k} patterns): max |diff| {float(diff.max()):g}, "
                         f"median {median:g}, {share:.2e} of the pixels off by > 0.05")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tutorial_chain(sig, Window)
                torch.cuda.synchronize()
            busy_ms, events = device_busy(prof)
            busy = (busy_ms, events)
        n = data.numel() // (60 * 60)
        out[n] = {"chain_ms": chain_ms, "mb": mb, "steps": dict(timings), "launches": launches, "busy": busy}
        steps = "; ".join(f"{k} {v:.3f} ms ({mb / v * 1e3:.1f} MB/s)" for k, v in timings.items())
        busy_msg = ""
        if busy is not None:
            busy_msg = (f"; under torch.profiler the card busy {busy[0]:.3f} ms, {busy[0] / chain_ms:.1%} of the "
                        f"untraced chain: " + "; ".join(f"{k[:40]} x{c} {t:.3f} ms" for k, c, t in busy[1][:8]))
        msgs.append(f"{smi}: {n} patterns ({mb:.1f} MB uint8): chain {chain_ms:.3f} ms = {mb / chain_ms * 1e3:.1f} "
                    f"MB/s; {steps}; kernel D launches {launches['remove_background']} (static "
                    f"{launches['remove_background[static]']}, dynamic {launches['remove_background[dynamic]']} on the "
                    f"pair kernel), kernel E {launches['clahe']} (pair kernel); output float32{check_msg}{busy_msg}")
        del sig, result, res, data
        torch.cuda.empty_cache()
    return out, msgs


def preprocess_rows(device, scan, errs: dict, launches: dict, sass: dict, clock_mhz: float,
                    sms: int) -> tuple[list[dict], list[str]]:
    """Kernel D's two modes and kernel E at the main path's shape: ms from
    CUDA events after a warm-up, launches back to back queued behind 2 ms
    of device sleep (``ms``, warm: what the last launches left in L2) and
    each alone after L2_FLUSH_BYTES are written (``ms_cold``), both bounds:
    bytes or operations, and the issue slots of the SASS each kernel runs
    (``sass``: D static's ``static_pixel``, E's ``clahe_pixel``, D
    dynamic's ``dynamic_steps`` over this run's operators), each kernel's
    path, the block kernel's ms at the same inputs (the design each pair
    kernel replaced on the main path), the plain versions' ms; D static also
    on the scan tiled PREPROCESS_TILES times. ``launches`` holds each
    kernel's counts by path; a row's ``launches`` is its own path's (the
    main path's for kernel D, the chain's at the main path's size for kernel
    E, which the main path does not run)."""
    import torch

    from kikuchipy_tpu_torch.ops import ahe
    from kikuchipy_tpu_torch.ops import background as bgk
    from kikuchipy_tpu_torch.ops import pattern as tops
    from sass_count import dynamic_slots

    flat = scan.data.reshape(-1, 60, 60)
    n, pix = flat.shape[0], flat.numel()
    bg = torch.as_tensor(scan.static_background, dtype=torch.float32, device=device)
    plan = tops.dynamic_background_separable_plan((60, 60), 60 / 8)
    r_op, c_op = torch.as_tensor(plan.row_op, device=device), torch.as_tensor(plan.col_op, device=device)
    static_u8 = bgk.remove_background(flat, "subtract", 0, 255, np.uint8, static_bg=bg)
    dyn_u8 = bgk.remove_background(static_u8, "subtract", 0, 255, np.uint8, row_op=r_op, col_op=c_op)
    runs = {
        "static": (lambda: bgk.remove_background(flat, "subtract", 0, 255, np.uint8, static_bg=bg),
                   lambda: bgk.remove_background_plain(flat, "subtract", 0, 255, np.uint8, static_bg=bg)),
        "dynamic": (lambda: bgk.remove_background(static_u8, "subtract", 0, 255, np.uint8, row_op=r_op, col_op=c_op),
                    lambda: bgk.remove_background_plain(static_u8, "subtract", 0, 255, np.uint8, row_op=r_op,
                                                        col_op=c_op)),
        "clahe": (lambda: ahe.clahe(dyn_u8, 15, 15, 128, 0.0, np.uint8),
                  lambda: ahe.clahe_plain(dyn_u8, 15, 15, 128, 0.0, np.uint8)),
    }
    # The block kernel each pair kernel replaced on the main path.
    choosers = {"dynamic": (bgk, "dynamic_path"), "clahe": (ahe, "clahe_path")}
    paths = {
        "static": bgk.static_path(60, 60, flat.dtype, np.uint8, 0, 255, aligned=flat.data_ptr() % 16 == 0),
        "dynamic": bgk.dynamic_path(60, 60, flat.dtype, np.uint8, 0, 255, aligned=flat.data_ptr() % 16 == 0),
        "clahe": ahe.clahe_path(60, 60, 15, 15, 128, flat.dtype, np.uint8, aligned=dyn_u8.data_ptr() % 16 == 0),
    }
    # uint8 in and out, and the float32 background or the two operators.
    io_bytes = {"static": 2 * pix + 4 * 3600, "dynamic": 2 * pix + 2 * 4 * 3600, "clahe": 2 * pix}
    # The dynamic products' terms this run's operators need: R @ p takes each
    # nonzero of R once a column of p, (R p) @ C^T each nonzero of C once a
    # row; an FMA is two operations.
    terms = int(torch.count_nonzero(r_op)) * 60 + int(torch.count_nonzero(c_op)) * 60
    ops = {
        "static": pix * D_OPS_PER_PIXEL,
        "dynamic": pix * D_OPS_PER_PIXEL + n * 2 * terms,
        "clahe": pix * E_OPS_PER_PIXEL,
    }
    # Issue slots: thread instructions a pixel (instruction_ms's unit).
    slots, steps = dynamic_slots((r_op, c_op), sass["dynamic_steps"])
    per_pixel = {"static": sass["static_pixel"], "dynamic": slots * 32 / 3600, "clahe": sass["clahe_pixel"]}
    replaces = {
        "static": "kikuchipy_tpu/ops/pattern.py:141 _remove_background under :159 remove_static_background",
        "dynamic": "kikuchipy_tpu/ops/pattern.py:141 _remove_background + :289 _frequency_blur -> "
                   "kikuchipy_tpu/ops/fft_barnes.py:163 separable_filter, under :335 remove_dynamic_background",
        "clahe": "kikuchipy_tpu/ops/ahe.py:75 _clahe_batch + :42 _blend_weights, under :120 "
                 "adaptive_histogram_equalization",
    }
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    rows, msgs = [], []
    for key, (kernel, plain) in runs.items():
        ms = cuda_ms(kernel, 20, lead_ms=2.0)
        ms_cold = cuda_ms_cold(kernel, 20, flush)
        plain_ms = cuda_ms(plain, 2)
        t_bytes = io_bytes[key] / PEAK_BYTES * 1e3
        t_ops = ops[key] / PEAK_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        name = "clahe" if key == "clahe" else f"remove_background[{key}]"
        path, size = paths[key]
        entry = {
            "name": name, "route": "cuda",
            "source": f"kikuchipy_tpu_torch/csrc/{'clahe' if key == 'clahe' else 'background'}.cu",
            "replaces": replaces[key], "launches": launches[name][f"preprocess {n}" if key == "clahe" else "main"],
            "launches_by_path": launches[name],
            "max_abs_err": errs[key], "ms": ms, "ms_cold": ms_cold, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            "path": (f"{path} ({size} vectors a lane)" if key == "static" else f"{path} ({size} pairs a block)")
                    if size else path,
            "instruction_bound_ms": instruction_ms(pix, per_pixel[key], clock_mhz, sms),
            "note": "max_abs_err in gray levels against the plain version over [preprocess-check]'s uint8 cases; "
                    "ms with launches back to back, ms_cold with L2 flushed before each",
        }
        instr = f"; path {entry['path']}; instruction slots {entry['instruction_bound_ms']:.4f} ms at " \
                f"{per_pixel[key]:.4g} a pixel"
        if key == "dynamic":
            instr += (f" ({slots:.0f} a pattern: {steps} product steps over the tiles' bands); {2 * terms} "
                      f"operations a pattern in the products (the operators' nonzeros)")
        if key in choosers:
            with forced_block(*choosers[key]):
                entry["block_ms"] = cuda_ms(kernel, 20, lead_ms=2.0)
                entry["block_ms_cold"] = cuda_ms_cold(kernel, 20, flush)
            instr += (f"; the block kernel it replaced {entry['block_ms']:.4f} ms warm, {entry['block_ms_cold']:.4f} "
                      f"ms cold")
        if key == "static":
            # The scan tiled PREPROCESS_TILES times.
            big = flat.repeat(PREPROCESS_TILES, 1, 1)
            run_big = lambda: bgk.remove_background(big, "subtract", 0, 255, np.uint8, static_bg=bg)
            entry["big"] = {"patterns": big.shape[0], "ms": cuda_ms(run_big, 10, lead_ms=2.0),
                            "ms_cold": cuda_ms_cold(run_big, 10, flush),
                            "bound_ms": max(PREPROCESS_TILES * t_bytes, PREPROCESS_TILES * t_ops),
                            "instruction_bound_ms": PREPROCESS_TILES * entry["instruction_bound_ms"]}
            del big
            b = entry["big"]
            instr += (f"; at {b['patterns']} patterns {b['ms']:.4f} ms warm, {b['ms_cold']:.4f} "
                      f"ms cold (bound {b['bound_ms']:.4f} ms by bytes, instruction slots "
                      f"{b['instruction_bound_ms']:.4f} ms)")
        rows.append(entry)
        slowest = max(bound, entry["instruction_bound_ms"])
        msgs.append(f"{name} {ms:.4f} ms warm, {ms_cold:.4f} ms cold (bound {bound:.4f} ms by {entry['bound_by']}, "
                    f"{bound / ms:.2%} / {bound / ms_cold:.2%} of it; the larger bound {slowest / ms:.2%} / "
                    f"{slowest / ms_cold:.2%}{instr}; {pix / 1e6:.1f} MB uint8 in, {pix / ms / 1e3:.1f} MB/s; plain "
                    f"{plain_ms:.3f} ms; no single PyTorch call computes it)")
    del flush
    return rows, msgs


def sh_analysis_check(dev, mp, coeffs) -> tuple[float, str]:
    """Kernel A at the analysis's shape against the plain twin in float64:
    ``sh_analysis_lambert`` again with its quadrature samples through the
    kernel and through ``lambert_project_plain`` on float64 operands. The
    samples must be within kernel A's per-case limit, 1e-4 of the master's
    range; the coefficients within ``sqrt(4 pi)`` times that of each other
    (Bessel's inequality: the analysis projects the samples onto functions
    orthonormal under the quadrature, whose weights sum to 4 pi), and those
    through the kernel equal to the projector's. Returns the samples' max
    |kernel - plain| and the message."""
    from unittest import mock

    import torch

    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.projection import spherical as sp
    from kikuchipy_tpu_torch.projection.master_pattern import quad_texture

    master = np.asarray(mp._hemispheres_at_energy(None), dtype=np.float32)
    master_range = float(master.max() - master.min())
    samples = {}

    def sampler(name, project):
        def sample(rotations, dirs, master_t, npx, npy, scale):
            samples[name] = project(rotations, dirs, master_t, npx, npy, scale)
            return samples[name]
        return sample

    def kernel(rotations, dirs, master_t, npx, npy, scale):
        return lp.lambert_project(rotations, dirs, quad_texture(master_t), npx, npy, scale)

    def plain64(rotations, dirs, master_t, npx, npy, scale):
        d64 = dict(dtype=torch.float64)
        return lp.lambert_project_plain(rotations.to(**d64), dirs.to(**d64), quad_texture(master_t.to(**d64)), npx,
                                        npy, scale)

    before = lp.lambert_project.launches
    with mock.patch.object(sp, "project_patterns", sampler("kernel", kernel)):
        c_k = sp.sh_analysis_lambert(master, SH_L, device=dev)
    with mock.patch.object(sp, "project_patterns", sampler("plain", plain64)):
        c_p = sp.sh_analysis_lambert(master, SH_L, device=dev)
    if lp.lambert_project.launches != before + 1:
        raise AssertionError("[refine-sh] the analysis check did not launch kernel A once")
    f_err = float((samples["kernel"].double() - samples["plain"]).abs().max())
    c_err, c_norm = float(torch.linalg.norm(c_k - c_p)), float(torch.linalg.norm(c_p))
    same = float((c_k.float() - coeffs).abs().max())
    limit = 1e-4 * master_range
    msg = (f"kernel A at the analysis's shape ({tuple(samples['kernel'].shape)}) against the plain twin in float64: "
           f"samples max |diff| {f_err:.3e} (limit {limit:.3e}, 1e-4 of the range), coefficients |diff| / |c| "
           f"{c_err / c_norm:.3e} (limit {np.sqrt(4 * np.pi) * limit / c_norm:.3e}), the projector's coefficients "
           f"off the kernel's by {same:.1e}")
    if not (f_err <= limit and c_err <= np.sqrt(4 * np.pi) * max(f_err, 1e-30) * (1 + 1e-6)
            and same <= 1e-6 * float(coeffs.abs().max())):
        raise AssertionError(f"[refine-sh] {msg}")
    return f_err, msg


def sh_scores_check(dev, static, mp, res, phase: str) -> tuple[float, str]:
    """Kernel B at the PC modes' shape (the whole map, direction cosines
    from one PC a point) against its plain twin within 2e-6 of 1 - NCC, on
    the phase's own solution: its rotations and PCs, whose scores the
    kernel gives again (within 1e-6). Returns the max |kernel - plain|."""
    import torch

    from kikuchipy_tpu_torch.indexing import refinement as tr
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    n = static.navigation_size
    rot = torch.as_tensor(np.asarray(res.xmap.best_rotations), dtype=torch.float32, device=dev)
    pcs = torch.as_tensor(res.detector.pc.reshape(-1, 3), dtype=torch.float32, device=dev)
    om = torch.as_tensor(np.ascontiguousarray(res.detector.sample_to_detector.T), dtype=torch.float32, device=dev)
    dc = tr._dc_for_pc(pcs, *DETECTOR_SHAPE, om, None).contiguous()
    exp, sq = tr._prepare_experimental(tr._signal_rows(static), None)
    quad, npx, npy, scale = tr._master_arrays(mp, None, dev)
    got = lp.lambert_project_ncc(rot, dc, quad, npx, npy, scale, exp, sq)
    ref = torch.cat([lp.lambert_project_ncc_plain(rot[c:c + 2048], dc[c:c + 2048], quad, npx, npy, scale,
                                                  exp[c:c + 2048], sq[c:c + 2048]) for c in range(0, n, 2048)])
    err = float((got - ref).abs().max())
    own = float(np.abs(1.0 - got.cpu().numpy() - res.xmap.prop["scores"]).max())
    msg = (f"kernel B at B={n}, dc {tuple(dc.shape)} on the solution: max |kernel - plain| {err:.2e} (limit 2e-6), "
           f"its scores off the phase's by {own:.1e}")
    if not (err <= 2e-6 and own <= 1e-6) or not torch.isfinite(got).all():
        raise AssertionError(f"[{phase}] {msg}")
    return err, msg


def sh_refinement_phases(dev, static, xmap, pc_xmap, det, bad_det, mp, truth, near, smi: str) -> tuple[dict, dict]:
    """``[refine-sh]``, ``[refine-sh-pc]``, ``[refine-sh-joint]``: every
    ``EBSD.refine_*`` mode with ``projector="spherical"`` at the JAX default
    ``sh_L`` and ``sh_precision`` on the whole static-corrected map, beside
    the bilinear LM call. Returns each phase's launches of the kernels the
    tier ran (kernel A in the analysis, kernel B for the scores, the LM loop
    kernel in the polish), counted from 0 at the phase's start, and the
    worst |kernel - plain| of kernels A and B at the tier's shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.indexing import refinement as tr
    from kikuchipy_tpu_torch.projection import spherical as sp
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector
    from kikuchipy_tpu_torch.utils.device import matmul_precision
    from kikuchipy_tpu_torch.utils.optimize import _normal_equations_batched

    n = static.navigation_size
    d = DETECTOR_SHAPE[0] * DETECTOR_SHAPE[1]
    ncoef = (SH_L + 1) ** 2
    sh_kw = dict(projector="spherical", sh_L=SH_L, method="lm")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def traced(fn) -> str:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = timed(fn)
        busy, events = device_busy(prof)
        top = "; ".join(f"{k[:40]} x{c} {t:.3f} ms" for k, c, t in events[:5])
        return f"under torch.profiler wall {wall:.1f} ms, device busy {busy:.1f} ms = {busy / wall:.1%}; {top}"

    def check_launches(phase: str, want: dict) -> dict:
        counts = {k: v for k, v in read_launches().items() if v and "[" not in k}
        if counts != want:
            raise AssertionError(f"[{phase}] launched {counts}, expected {want}")
        return counts

    def ang_to(q_ref, res):
        return np.degrees(disorientation_angle(unit_quats(q_ref), unit_quats(res.xmap.best_rotations), "m-3m"))

    def gate_orientation(label: str, res, sel=slice(None)) -> str:
        ang = ang_to(truth[sel], res)
        msg = (f"{label}: disorientation to truth median {np.median(ang):.4f} deg, max over the "
               f"{int(near[sel].sum())} points DI put within {REFINE_START_DEG} deg {ang[near[sel]].max():.4f} "
               f"(limit {REFINE_MAX_DEG})")
        if not ang[near[sel]].max() < REFINE_MAX_DEG or not np.isfinite(res.xmap.prop["scores"]).all():
            raise AssertionError(f"[refine-sh] missed: {msg}")
        return msg

    def gate_pc(phase: str, res) -> tuple[float, str]:
        pcs = res.detector.pc.reshape(-1, 3)
        off = np.abs(pcs.mean(axis=0) - np.asarray(PC))
        msg = f"mean PC {np.round(pcs.mean(axis=0), 6).tolist()} (off {np.round(off, 6).tolist()}, limit {PC_TOL})"
        if not (off < PC_TOL).all() or not np.isfinite(res.xmap.prop["scores"]).all():
            raise AssertionError(f"[{phase}] missed the PC: {msg}")
        return float(np.mean(res.xmap.prop["scores"])), msg

    def peak_gb() -> float:
        return torch.cuda.max_memory_allocated() / 2**30

    launches, errs = {}, {}
    # ---- orientation mode ----
    mp._sh_cache.clear()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    proj, ms_analysis = timed(lambda: mp.spherical_projector(L=SH_L))
    dc = direction_cosines_from_detector(det, device=dev)
    basis, ms_basis = timed(lambda: proj.synthesis_basis(dc))
    call = functools.partial(static.refine_orientation, xmap=xmap, master_pattern=mp, **sh_kw)
    # As many whole chunks a batch as half the free memory holds: kernel B
    # once a batch for the scores. Each point's measured share of the peak
    # must stay within the bytes the cap allows it.
    batch = tr._batch_points(torch.device(dev), NAV_CHUNK, False, "lm", "spherical", SH_L, d)
    batches = -(-n // batch)
    allowed = 4 * (tr._SH_STACKS * sp._width(SH_L) + tr._SH_ROWS * d)
    peak_analysis = peak_gb()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, ms_first = timed(call)
    launches["refine-sh"] = check_launches("refine-sh", {"lambert_project": 1, "lambert_project_ncc": batches})
    peak_first = peak_gb()
    per_point = (torch.cuda.max_memory_allocated() - resident) / min(batch, n)
    if not per_point <= allowed:
        raise AssertionError(f"[refine-sh] {per_point:.0f} bytes a point at the peak, over the cap's {allowed}")
    errs["lambert_project"], analysis_msg = sh_analysis_check(dev, mp, proj.coeffs)
    gate = gate_orientation("default", res)
    bl, ms_bl_first = timed(lambda: static.refine_orientation(xmap=xmap, master_pattern=mp, method="lm"))
    to_bl = ang_to(bl.xmap.best_rotations, res)
    _, ms_call = timed(call)
    _, ms_bl = timed(lambda: static.refine_orientation(xmap=xmap, master_pattern=mp, method="lm"))
    torch.cuda.reset_peak_memory_stats()
    trace = traced(call)
    peak_call = peak_gb()
    res_hi, ms_hi = timed(lambda: static.refine_orientation(xmap=xmap, master_pattern=mp, sh_precision="highest",
                                                            **sh_kw))
    gate_hi = gate_orientation("highest", res_hi)
    iters = res.xmap.prop["num_evals"]
    # One 2,048-point chunk for Nelder-Mead and gradient.
    sub = slice(0, NAV_CHUNK)
    sub_signal = type(static)(static.data.reshape(n, *DETECTOR_SHAPE)[sub], detector=det, device=dev)
    sub_xmap = CrystalMap(rotations=xmap.best_rotations[sub], shape=(NAV_CHUNK,), phases=xmap.phases)
    other = []
    for method in ("nm", "gradient"):
        reset_launches()
        r, ms = timed(lambda: sub_signal.refine_orientation(xmap=sub_xmap, master_pattern=mp, projector="spherical",
                                                            sh_L=SH_L, method=method))
        check_launches("refine-sh", {"lambert_project_ncc": 1})
        other.append(f"method={method!r} on the first {NAV_CHUNK} points {ms:.1f} ms "
                     f"({NAV_CHUNK / ms * 1e3:.1f} patterns/s), num_evals mean {r.xmap.prop['num_evals'].mean():.1f}; "
                     + gate_orientation(method, r, sub))

    # The call's evaluations of a batch: at the start and once an iteration
    # until the batch's last point is done.
    evals = sum(1 + int(iters[c:c + batch].max()) for c in range(0, n, batch))
    log("refine-sh", f"{smi}: EBSD.refine_orientation(xmap=<pallas-int8 top-1>, master_pattern=mp, method='lm', "
        f"projector='spherical', sh_L={SH_L}, sh_precision='default') on the {n} static-corrected patterns "
        f"({batches} batch(es) of {batch}): one-time analysis {ms_analysis:.1f} ms (kernel A once), synthesis basis "
        f"({d} x {ncoef}) {ms_basis:.1f} ms; first call {ms_first:.1f} ms, untraced {ms_call:.1f} ms = "
        f"{n / ms_call * 1e3:.1f} patterns/s against the bilinear LM call's {ms_bl:.3f} ms = {n / ms_bl * 1e3:.1f} "
        f"patterns/s (first {ms_bl_first:.1f} ms); {trace}; launches {launches['refine-sh']}; num_evals mean "
        f"{iters.mean():.2f} max {int(iters.max())}, {evals} evaluations of a batch; {gate}; to the bilinear LM "
        f"solution median {np.median(to_bl):.4f} max {to_bl.max():.4f} deg; peak memory {peak_analysis:.2f} GiB in "
        f"the analysis, {peak_first:.2f} GiB the first call, {peak_call:.2f} GiB a call, {per_point / 2**20:.3f} MiB a point over the {resident / 2**30:.2f} "
        f"GiB resident (the cap allows {allowed / 2**20:.3f}); sh_precision='highest' {ms_hi:.1f} ms, {gate_hi}; "
        + "; ".join(other) + f"; {analysis_msg}")
    # Where the call's time goes, at one batch as the call runs it: one LM
    # evaluation (the residual and its three tangents, one vmapped jvp),
    # the residual alone, the zyz rotation, a Z stage, a T stage and the
    # synthesis product (CUDA events); then one evaluation under the
    # profiler, its device time by kind of kernel and the host's rest.
    tables = sp.wigner_tables(SH_L).device_arrays(dev)
    m = min(batch, n)
    q0 = torch.as_tensor(xmap.best_rotations[:m], dtype=torch.float32, device=dev)
    use_id = tr._sh_variant(q0)
    exp_u = tr.unit_rows(tr._prepare_experimental(tr._signal_rows(static)[:m], None)[0])
    zeros = torch.zeros((m, 3), device=dev)
    basis_w = sp._widen(basis, tables.K)
    eval_args = (q0, use_id, exp_u, proj.coeffs, tables, basis_w, "default")
    stage = {}
    with matmul_precision(True):
        qc = tq.conjugate(q0)
        c = sp._rotate_zyz_preselected(qc, use_id, proj.coeffs, tables, "default")
        t = torch.rand(m, device=dev)
        stage["evaluation"] = cuda_ms(lambda: _normal_equations_batched(
            tr._residual_orientation_delta_sh, zeros, eval_args), 3)
        stage["residual"] = cuda_ms(lambda: tr._residual_orientation_delta_sh(zeros, *eval_args), 3)
        stage["zyz rotation"] = cuda_ms(lambda: sp._rotate_zyz_preselected(qc, use_id, proj.coeffs, tables, "default"),
                                        3)
        stage["Z stage"] = cuda_ms(lambda: sp._z_apply(c, t, tables), 5)
        stage["T stage"] = cuda_ms(lambda: sp._t_apply(c, tables, False, "default"), 5)
        stage["synthesis TF32"] = cuda_ms(lambda: sp._synth(c, basis_w, "default"), 5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = timed(lambda: _normal_equations_batched(tr._residual_orientation_delta_sh, zeros, eval_args))
    with matmul_precision(False):
        stage["synthesis float32"] = cuda_ms(lambda: sp._synth(c, basis_w, "highest"), 3)
    del c
    busy, events = device_busy(prof)
    kinds = {"products": 0.0, "gathers": 0.0, "copies": 0.0, "elementwise and reductions": 0.0}
    for key, _, ms in events:
        k = key.lower()
        kind = ("products" if "gemm" in k or "xmma" in k or "cutlass" in k else "gathers"
                if "gather" in k or "index" in k else "copies" if "memcpy" in k or "copy" in k
                else "elementwise and reductions")
        kinds[kind] += ms
    flops = 2 * m * ncoef * d
    t_tf32, t_f32 = flops / PEAK_TF32_FLOPS * 1e3, flops / PEAK_F32_FLOPS * 1e3
    log("refine-sh-times", f"{smi}: at one batch ({m} points, P={d}, {ncoef} coefficients; CUDA events): "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in stage.items())
        + f"; the synthesis product {flops / 1e12:.3f} TFLOP: TF32 bound {t_tf32:.3f} ms "
        f"({t_tf32 / stage['synthesis TF32']:.1%}), float32 bound {t_f32:.3f} ms "
        f"({t_f32 / stage['synthesis float32']:.1%}); the call's {evals} evaluations of a batch at {stage['evaluation']:.1f} ms: "
        f"{evals * stage['evaluation']:.1f} ms of the untraced call's {ms_call:.1f}; one evaluation under "
        f"torch.profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms ("
        + ", ".join(f"{k} {v:.1f} ms" for k, v in kinds.items())
        + f"), the host's rest {wall - busy:.1f} ms; "
        + "; ".join(f"{k[:40]} x{cnt} {ms:.3f} ms" for k, cnt, ms in events[:6]))

    # ---- PC mode ----
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    (_, bcat, _), ms_bases = timed(lambda: tr._sh_pc_bases(mp, None, bad_det, None, SH_L))
    call = functools.partial(static.refine_projection_center, xmap=pc_xmap, detector=bad_det, master_pattern=mp,
                             **sh_kw)
    res, ms_first = timed(call)
    launches["refine-sh-pc"] = check_launches("refine-sh-pc", {"levenberg_marquardt_projection_center": 1,
                                                               "lambert_project_ncc": 1})
    score, gate = gate_pc("refine-sh-pc", res)
    peak_pc = peak_gb()
    err_pc, scores_msg = sh_scores_check(dev, static, mp, res, "refine-sh-pc")
    bl_call = functools.partial(static.refine_projection_center, xmap=pc_xmap, detector=bad_det, master_pattern=mp,
                                method="lm")
    bl, _ = timed(bl_call)
    _, ms_call = timed(call)
    _, ms_bl = timed(bl_call)
    trace = traced(call)
    q_all = tq.conjugate(torch.as_tensor(pc_xmap.best_rotations, dtype=torch.float32, device=dev))
    with matmul_precision(True):
        # As the call does: the coefficients and the basis in the wide layout.
        c_all, ms_rot = timed(lambda: sp._rotate_zyz(q_all, proj.coeffs, tables, "default"))
        bcat_w = sp._widen(bcat, tables.K)
        ms_sim4 = cuda_ms(lambda: sp._synth(c_all, bcat_w, "default"), 3)
    del c_all, bcat_w
    flops4 = 2 * n * ncoef * 4 * d
    log("refine-sh-pc", f"{smi}: EBSD.refine_projection_center(xmap=<Nelder-Mead's>, detector=<PC off by "
        f"{PC_OFFSET}>, method='lm', projector='spherical') on the {n} patterns: PC bases (7 sh_basis, "
        f"{4 * d} x {ncoef}) {ms_bases:.1f} ms; first call {ms_first:.1f} ms, untraced {ms_call:.1f} ms = "
        f"{n / ms_call * 1e3:.1f} patterns/s against the bilinear LM call's {ms_bl:.3f} ms = "
        f"{n / ms_bl * 1e3:.1f} patterns/s; {trace}; launches {launches['refine-sh-pc']}; {gate}, the bilinear LM's "
        f"{np.round(bl.detector.pc.reshape(-1, 3).mean(0), 6).tolist()}; mean score {score:.5f} (bilinear LM "
        f"{float(np.mean(bl.xmap.prop['scores'])):.5f}); {scores_msg}; peak memory {peak_pc:.2f} GiB "
        f"({peak_pc * 2**30 / n / 2**20:.3f} MiB a point); the map's zyz rotation "
        f"{ms_rot:.1f} ms, its product with [B; dB/dPC] {ms_sim4:.3f} ms ({flops4 / 1e12:.2f} TFLOP, TF32 bound "
        f"{flops4 / PEAK_TF32_FLOPS * 1e3:.3f} ms, {flops4 / PEAK_TF32_FLOPS * 1e3 / ms_sim4:.1%})")

    # ---- joint mode ----
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    call = functools.partial(static.refine_orientation_projection_center, xmap=xmap, detector=bad_det,
                             master_pattern=mp, **sh_kw)
    res, ms_first = timed(call)
    launches["refine-sh-joint"] = check_launches("refine-sh-joint", {
        "levenberg_marquardt_orientation_projection_center": 1, "lambert_project_ncc": 1})
    score, gate = gate_pc("refine-sh-joint", res)
    peak_joint = peak_gb()
    err_joint, scores_msg = sh_scores_check(dev, static, mp, res, "refine-sh-joint")
    errs["lambert_project_ncc"] = max(err_pc, err_joint)
    bl_call = functools.partial(static.refine_orientation_projection_center, xmap=xmap, detector=bad_det,
                                master_pattern=mp, method="lm")
    bl, _ = timed(bl_call)
    score_bl = float(np.mean(bl.xmap.prop["scores"]))
    if not score >= score_bl - 5e-3:
        raise AssertionError(f"[refine-sh-joint] mean score {score:.5f} below the bilinear joint LM's {score_bl:.5f} "
                             "less 5e-3")
    ang, ang_bl = ang_to(truth, res), ang_to(truth, bl)
    _, ms_call = timed(call)
    _, ms_bl = timed(bl_call)
    trace = traced(call)
    log("refine-sh-joint", f"{smi}: EBSD.refine_orientation_projection_center(xmap=<pallas-int8 top-1>, "
        f"detector=<PC off by {PC_OFFSET}>, method='lm', projector='spherical') on the {n} patterns: first call "
        f"{ms_first:.1f} ms, untraced {ms_call:.1f} ms = {n / ms_call * 1e3:.1f} patterns/s against the bilinear LM "
        f"call's {ms_bl:.3f} ms = {n / ms_bl * 1e3:.1f} patterns/s; {trace}; launches {launches['refine-sh-joint']}; {gate}, the "
        f"bilinear LM's {np.round(bl.detector.pc.reshape(-1, 3).mean(0), 6).tolist()}; mean score {score:.5f} against "
        f"the bilinear joint LM's {score_bl:.5f} (limit: no lower than it less 5e-3); disorientation to truth median "
        f"{np.median(ang):.4f} deg, max over the {int(near.sum())} points DI put within {REFINE_START_DEG} deg "
        f"{ang[near].max():.4f} (bilinear joint LM {np.median(ang_bl):.4f} / {ang_bl[near].max():.4f}); num_evals "
        f"mean {res.xmap.prop['num_evals'].mean():.2f}; {scores_msg}; peak memory {peak_joint:.2f} GiB "
        f"({peak_joint * 2**30 / n / 2**20:.3f} MiB a point)")
    return launches, errs


def nm_sass_key(mode: str, P: int) -> str:
    """sass_count.py's key of a Nelder-Mead evaluation's pixel in ``mode``
    on the route ``nelder_mead_plan`` takes for ``P`` pixels."""
    from kikuchipy_tpu_torch.ops.refine_nm import nelder_mead_plan

    return ("orientation" if mode == "orientation" else "pc") + (
        "_cache" if nelder_mead_plan(P, mode).route == "cache" else "")


def instruction_ms(pixels: float, per_pixel: int, clock_mhz: float, sms: int) -> float:
    """Milliseconds the SMs' instruction slots take for ``per_pixel`` instructions
    on each of ``pixels`` pixels, one pixel a thread (32 a warp)."""
    return pixels * per_pixel / 32 / (sms * WARP_INSTR_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3


def device_busy(prof) -> tuple[float, list]:
    """Device milliseconds under a ``torch.profiler`` trace, and its events
    by device time, largest first."""
    def dev_time(e) -> float:
        v = getattr(e, "self_device_time_total", None)
        return getattr(e, "self_cuda_time_total", 0) if v is None else v

    averages = prof.key_averages()
    events = [e for e in averages if "cuda" in str(getattr(e, "device_type", "")).lower() and dev_time(e) > 0]
    if not events:  # no device-side entries: take whatever carries device time
        events = [e for e in averages if dev_time(e) > 0]
    events.sort(key=dev_time, reverse=True)
    return sum(dev_time(e) for e in events) / 1e3, [(e.key, e.count, dev_time(e) / 1e3) for e in events]


# ------------------------ the global solvers (kernel F) ------------------------ #

GLOBAL_METHODS = ("de", "da", "bh", "shgo")
# Trust regions of the global phases: 3 degrees about the DI top-1 (the
# reference benchmark's), 0.02 about the PC off by PC_OFFSET.
GLOBAL_TRUST = {"orientation": [3.0, 3.0, 3.0], "pc": [0.02] * 3, "joint": [3.0, 3.0, 3.0, 0.02, 0.02, 0.02]}
POP_WRAPPER = {"orientation": "population_orientation", "pc": "population_projection_center",
               "joint": "population_orientation_projection_center"}
NM_WRAPPER = {"orientation": "nelder_mead_orientation", "pc": "nelder_mead_projection_center",
              "joint": "nelder_mead_orientation_projection_center"}
# Members of a DE population in each mode's refine_* (JAX's: 24 in
# orientation mode, the solver's default 16 in the others): kernel F's shape.
POP_M = {"orientation": 24, "pc": 16, "joint": 16}
# Kernel F against its plain version (1 - NCC): kernel B's criterion
# ([ncc-check]), since kernel F's values are kernel B's objective bit for bit
# (a float32 sum over 3600 pixels in another order than PyTorch's; 4.17e-7
# measured on 2,048 points); tests/test_torch_gpu.py holds the same. And the
# global phases' mean score against Nelder-Mead's (JAX's criterion,
# tests/test_refinement.py).
POP_TOL = 2e-6
GLOBAL_MEAN_TOL = 1e-3
# Candidates a point of SHGO's one kernel F launch: 64 Halton samples and x0.
SHGO_M = 65
# Spreads of a point's members about its start at which kernel F is held and
# timed, (kind, degrees, PC units): a converging population (sigma 0.1
# deg), population_problem's timed generation (sigma 0.5 deg), and a DE
# call's first population, uniform in the trust regions (3 deg, 0.02).
POP_SPREADS = {"sigma 0.1 deg": ("normal", 0.1, 0.001), "sigma 0.5 deg": ("normal", 0.5, 0.005),
               "uniform 3 deg": ("uniform", 3.0, 0.02)}
# Points whose taps the sectors a member-pixel reads are counted on.
SECTOR_POINTS = 64


def euler_box_offsets(start_q, q, trust_deg) -> np.ndarray:
    """Where each rotation of ``q`` lies in the box of Euler angles that
    ``refine_orientation`` searches about ``start_q`` (the start's Bunge
    angles, as ``to_euler`` gives them, +- ``trust_deg``): the largest
    |offset from the start| over the three angles in half-widths, least over
    ``q``'s symmetric equivalents (m-3m) and both Euler triples of each,
    (phi1, Phi, phi2) and (phi1 + pi, -Phi, phi2 + pi), every angle modulo
    2 pi. ``q`` is in the box where it is at most 1, on its edge at 1."""
    import torch

    from kikuchipy_tpu_torch.crystallography.sampling import _left_products
    from kikuchipy_tpu_torch.crystallography.symmetry import get_point_group
    from kikuchipy_tpu_torch.geometry import quaternion as tq

    e0 = tq.to_euler(torch.as_tensor(np.asarray(start_q), dtype=torch.float64)).numpy()
    eq = _left_products(torch.as_tensor(get_point_group("m-3m").rotations), torch.as_tensor(q, dtype=torch.float64))
    e = tq.to_euler(eq).numpy()
    alt = np.stack([e[..., 0] + np.pi, -e[..., 1], e[..., 2] + np.pi], axis=-1)
    off = np.concatenate([e, alt], axis=1) - e0[:, None, :]
    off = (off + np.pi) % (2 * np.pi) - np.pi
    return (np.abs(off) / np.deg2rad(np.asarray(trust_deg, dtype=np.float64))).max(axis=2).min(axis=1)


def population_problem(mode: str, x0, exp, sq, rot_q, quad, om, dc, geo, shape, M: int, seed: int,
                       spread: str = "sigma 0.5 deg"):
    """(wrapper, objective, plain, x (n, M, d), arguments) of kernel F in
    ``mode``: ``M`` candidates about ``x0`` (the first ``x0`` itself) at
    ``POP_SPREADS[spread]``."""
    import torch
    from kikuchipy_tpu_torch.ops import refine_nm as rn
    from kikuchipy_tpu_torch.ops import refine_population as rp

    n, d = x0.shape
    kind, deg, pc = POP_SPREADS[spread]
    scale = {"orientation": [np.deg2rad(deg)] * 3, "pc": [pc] * 3, "joint": [np.deg2rad(deg)] * 3 + [pc] * 3}
    gen = torch.Generator(device=x0.device).manual_seed(seed)
    scale = torch.tensor(scale[mode], dtype=torch.float32, device=x0.device)
    if kind == "normal":
        noise = torch.randn((n, M, d), generator=gen, device=x0.device) * scale
    else:
        noise = (torch.rand((n, M, d), generator=gen, device=x0.device) * 2.0 - 1.0) * scale
    x = (x0[:, None, :] + noise).contiguous()
    x[:, 0] = x0
    if mode == "orientation":
        return (rp.population_orientation, rn.orientation_objective, rp.population_orientation_plain, x,
                (exp, sq, dc, quad, *geo))
    if mode == "pc":
        return (rp.population_projection_center, rn.pc_objective, rp.population_projection_center_plain, x,
                (exp, sq, rot_q, quad, om, None, *geo, *shape))
    return (rp.population_orientation_projection_center, rn.joint_objective,
            rp.population_orientation_projection_center_plain, x, (exp, sq, quad, om, None, *geo, *shape))


def population_check(wrapper, objective, plain, x, args, label: str, live=None) -> tuple[float, str]:
    """Kernel F on ``x`` against the objective of ops/refine_nm.py member by
    member (kernel B over PyTorch's direction cosines on the card; bit for
    bit, ``+inf`` on the points where ``live`` is false) and against its
    plain version (within POP_TOL). Returns the largest |kernel - plain| and
    a line for the log."""
    import torch

    got = wrapper(x, *args, live=live)
    want = torch.stack([objective(x[:, m].contiguous(), *args) for m in range(x.shape[1])], dim=1)
    if live is not None:
        want = torch.where(live[:, None], want, torch.inf)
    ref = plain(x, *args, live=live)
    torch.cuda.synchronize()
    dead = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device) if live is None else ~live
    e_plain = float((got - ref)[~dead].abs().max()) if bool((~dead).any()) else 0.0
    if not (torch.equal(got, want) and torch.equal(got, torch.where(dead[:, None], ref, got)) and e_plain <= POP_TOL
            and torch.isfinite(got[~dead]).all() and bool((got[dead] == torch.inf).all())):
        raise AssertionError(f"kernel F {label}: against the objective max |diff| "
                             f"{float((got - want)[~dead].abs().max()) if bool((~dead).any()) else 0.0:.3e} (must "
                             f"be 0), against the plain version {e_plain:.3e} (limit {POP_TOL:g}), +inf on every "
                             f"point not live: {bool((got[dead] == torch.inf).all())}")
    return e_plain, f"{label}: bit for bit, plain {e_plain:.2e}"


@contextlib.contextmanager
def forced_group(group: int | None):
    """Kernel F's plan with its group forced to ``group`` (None: as built)."""
    from kikuchipy_tpu_torch.ops import refine_population as rp

    plan = rp.population_plan
    if group is not None:
        rp.population_plan = lambda P, M, mode="orientation", group=group: plan(P, M, mode, group)
    try:
        yield
    finally:
        rp.population_plan = plan


def population_taps(mode: str, x, args):
    """The quad-texture row ``(n, M, P)`` each member-pixel of ``x`` reads
    in ``mode`` (the plain twin's taps); ``args`` the wrapper's, for these
    ``n`` points or the first ``n`` of theirs."""
    from kikuchipy_tpu_torch.geometry.quaternion import from_euler
    from kikuchipy_tpu_torch.ops.lambert_project import _project_plain
    from kikuchipy_tpu_torch.ops.refine_nm import pc_direction_cosines

    n, M, d = x.shape
    flat = x.reshape(n * M, d)
    if mode == "orientation":
        _, _, dc, quad, npx, npy, scale = args
        rot = from_euler(flat).float()
        dcs = dc if dc.ndim == 2 else dc[:n].repeat_interleave(M, 0)
    elif mode == "pc":
        _, _, q0, quad, om, take, npx, npy, scale, nrows, ncols = args
        rot, dcs = q0[:n].repeat_interleave(M, 0), pc_direction_cosines(flat, nrows, ncols, om, take)
    else:
        _, _, quad, om, take, npx, npy, scale, nrows, ncols = args
        rot, dcs = from_euler(flat[:, :3]).float(), pc_direction_cosines(flat[:, 3:], nrows, ncols, om, take)
    _, taps = _project_plain(rot, dcs, quad, npx, npy, scale, taps=True)
    return taps.reshape(n, M, -1)


def sectors_per_member_pixel(taps, group: int) -> float:
    """Distinct 32-byte sectors the members of a group read at one pixel,
    per member-pixel (a 16-byte float4 at row t lies in sector t // 2): 1.0
    at one member a block. A partial last group repeats its last member, as
    the kernel's spare lanes do."""
    import torch

    n, M, P = taps.shape
    pad = -M % group
    if pad:
        taps = torch.cat([taps, taps[:, -1:].expand(n, pad, P)], dim=1)
    s = (taps // 2).reshape(n, -1, group, P).sort(dim=2).values
    distinct = 1 + (s[:, :, 1:] != s[:, :, :-1]).sum(dim=2)
    return float(distinct.sum()) / (n * M * P)


def recording_de(record: list):
    """A stand-in for refinement.py's ``_differential_evolution`` that
    appends each call's evaluations (population, live mask) and result to
    ``record``."""
    from kikuchipy_tpu_torch.indexing import refinement as tr

    run = tr._differential_evolution

    def de(evaluate, *args, **kwargs):
        calls = []

        def recorded(x, live=None):
            calls.append((x, live))
            return evaluate(x) if live is None else evaluate(x, live=live)

        res = run(recorded, *args, **kwargs)
        record.append((evaluate, calls, res))
        return res

    return de


def live_shares(record: list) -> str:
    """The live share by generation of recorded DE calls (recording_de):
    the first call's list, and over all of them the point-generations kernel
    F evaluated against those of a loop that evaluates every point."""
    lists = [[float(live.float().mean()) for _, live in calls if live is not None] for _, calls, _ in record]
    n_points = [calls[0][0].shape[0] for _, calls, _ in record]
    run = sum(sum(share) * k for share, k in zip(lists, n_points))
    full = sum(len(share) * k for share, k in zip(lists, n_points))
    return (f"live share by generation (call 1 of {len(record)}, {n_points[0]} points) "
            f"{[round(v, 3) for v in lists[0]]}; over the {len(record)} call(s) kernel F evaluated "
            f"{run:.0f} of {full} point-generations ({run / max(full, 1):.1%}) after generation 0")


def population_checks(dev, exp, sq, euler0, rot_q, pc0, quad, om, dc, geo) -> tuple[dict, list[str]]:
    """Kernel F at the shapes the global phases give it, against the
    objectives and its plain version (population_check): on one navigation
    chunk (orientation mode's DE and DA batches, M = 24 and 1) in each mode,
    orientation mode also with one set of direction cosines a point; on the
    whole map at PC and joint modes' DA and DE populations (M = 1 and 16)
    and at SHGO's candidate sets in every mode (M = 65). Returns the largest
    |kernel - plain| of each mode."""
    import torch
    from kikuchipy_tpu_torch.ops import refine_nm as rn
    from kikuchipy_tpu_torch.ops import refine_population as rp

    n = exp.shape[0]
    c = min(NAV_CHUNK, n)
    err, msgs = {}, []
    per_point = rn.pc_direction_cosines(pc0[:c] + 0.01 * (torch.rand((c, 3), generator=torch.Generator(
        device=dev).manual_seed(81), device=dev) - 0.5), *DETECTOR_SHAPE, om).contiguous()
    cases = [(mode, c, M, None) for mode in ("orientation", "pc", "joint") for M in (1, 24)]
    cases += [("orientation", c, 1, per_point), ("orientation", c, 24, per_point)]
    cases += [(mode, n, M, None) for mode in ("pc", "joint") for M in (1, POP_M[mode])]
    cases += [(mode, n, SHGO_M, None) for mode in ("orientation", "pc", "joint")]
    cases = [(*case, None, "sigma 0.5 deg", None) for case in cases]
    # Every group the plan can choose, forced; the three spreads; live masks
    # (alternate points, none live).
    alternate = torch.arange(c, device=dev) % 2 == 0
    for mode in ("orientation", "pc", "joint"):
        cases += [(mode, c, POP_M[mode], None, g, "sigma 0.5 deg", None) for g in (1, 2, 4, 8)]
        cases += [(mode, c, POP_M[mode], None, None, spread, None) for spread in POP_SPREADS if spread != "sigma 0.5 deg"]
        cases += [(mode, c, POP_M[mode], None, None, "sigma 0.5 deg", live) for live in (alternate, torch.zeros_like(alternate))]
        cases += [(mode, c, SHGO_M, None, 8, "uniform 3 deg", alternate)]
    for mode, k, M, dc_case, group, spread, live in cases:
        x0 = {"orientation": euler0[:k], "pc": pc0[:k], "joint": torch.cat([euler0[:k], pc0[:k]], dim=1)}[mode]
        wrapper, objective, plain, x, args = population_problem(
            mode, x0, exp[:k], sq[:k], rot_q[:k], quad, om, dc if dc_case is None else dc_case, geo, DETECTOR_SHAPE,
            M, 80 + M, spread)
        with forced_group(group):
            plan = rp.population_plan(exp.shape[1], M, mode)
            label = (f"{mode} n={k} M={M}{' one dc a point' if dc_case is not None else ''} G={plan.group}"
                     f"{' (forced)' if group is not None else ''} {spread}"
                     f"{'' if live is None else f' live {float(live.float().mean()):.2f}'}")
            e_plain, msg = population_check(wrapper, objective, plain, x, args, label, live)
        err[mode] = max(err.get(mode, 0.0), e_plain)
        msgs.append(msg)
    return err, msgs


def global_refinement_phases(dev, static, xmap, refined_xmap, bad_det, mp, truth, near, smi, exp, sq, euler0, rot_q,
                             quad, om, dc, geo, sass, clock_mhz, sms, l2_rate):
    """[population-check], [refine-global], [refine-global-pc],
    [refine-global-joint] and [population-times]. Returns kernel F's rows of
    the kernels line and each global call's Nelder-Mead launches by path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.indexing import refinement as tr
    from kikuchipy_tpu_torch.ops import refine_population as rp

    n = exp.shape[0]
    d = exp.shape[1]
    pc0 = torch.as_tensor(np.tile(np.asarray(PC) + np.asarray(PC_OFFSET), (n, 1)), dtype=torch.float32, device=dev)
    pop_err, check_msgs = population_checks(dev, exp, sq, euler0, rot_q, pc0, quad, om, dc, geo)
    log("population-check", "kernel F (csrc/refine_population.cu) at the global phases' shapes against the objectives "
        "of ops/refine_nm.py (bit for bit) and its plain version (within "
        f"{POP_TOL:g}): " + "; ".join(check_msgs))

    # Each point's start score: 1 - the objective at its start, kernel F at
    # M = 1 on the whole map (bit for bit the Nelder-Mead kernel's).
    start_x = {"orientation": euler0, "pc": pc0, "joint": torch.cat([euler0, pc0], dim=1)}
    start_scores = {}
    for mode in ("orientation", "pc", "joint"):
        wrapper, _, _, x, args = population_problem(mode, start_x[mode], exp, sq, rot_q, quad, om, dc, geo,
                                                    DETECTOR_SHAPE, 1, 0)
        start_scores[mode] = 1.0 - wrapper(x, *args)[:, 0].cpu().numpy()
    # The bases, Nelder-Mead from the same starts in the same boxes. The
    # trust region is a box of Euler angles about the start's: a turn of w
    # about an axis off the start's Euler axes can take up to w / sin(Phi) of
    # phi1 and phi2, so about a start at small Phi the box can leave out a
    # rotation within 3 degrees of the start. The orientation gate
    # holds the near points whose box holds the truth, found from the truth
    # and the start alone (euler_box_offsets); the log gives the starts' Phi
    # and how many boxed Nelder-Mead results end on the box's edge, on both
    # sides of that split.
    nm_tr = static.refine_orientation(xmap=xmap, master_pattern=mp, trust_region=GLOBAL_TRUST["orientation"])
    ang_nm_tr = np.degrees(disorientation_angle(truth, nm_tr.xmap.best_rotations, "m-3m"))
    holds = euler_box_offsets(xmap.best_rotations, truth, GLOBAL_TRUST["orientation"]) <= 1.0
    reach, shut = near & holds, near & ~holds
    on_edge = euler_box_offsets(xmap.best_rotations, nm_tr.xmap.best_rotations,
                                GLOBAL_TRUST["orientation"]) >= 1.0 - 1e-3
    start_phi = np.degrees(tq.to_euler(torch.as_tensor(np.asarray(xmap.best_rotations), dtype=torch.float64))[:, 1].numpy())
    nm_joint_scores = static.refine_orientation_projection_center(
        xmap=xmap, detector=bad_det, master_pattern=mp, trust_region=GLOBAL_TRUST["joint"]).xmap.prop["scores"]

    def split(values, fmt):
        return {name: fmt(values[m]) if m.any() else "none" for name, m in (("truth in the box", reach),
                                                                           ("truth outside", shut))}

    log("refine-global", f"bases: of the {int(near.sum())} points DI put within {REFINE_START_DEG} deg, the Euler box "
        f"{GLOBAL_TRUST['orientation']} about the start holds the truth on {int(reach.sum())}, not on "
        f"{int(shut.sum())}; the start's Phi (deg) "
        f"{split(start_phi, lambda v: f'median {np.median(v):.2f} max {v.max():.2f}, under 10 deg {(v < 10).mean():.1%}')}"
        f"; the boxed Nelder-Mead's result on the box's edge "
        f"{split(on_edge, lambda v: f'{int(v.sum())} of {v.size}')}, its disorientation to truth "
        f"{split(ang_nm_tr, lambda v: f'max {v.max():.4f} deg, {int((v >= REFINE_MAX_DEG).sum())} at or past {REFINE_MAX_DEG}')}"
        f"; its mean score {nm_tr.xmap.prop['scores'].mean():.6f}; the joint Nelder-Mead in the box "
        f"{GLOBAL_TRUST['joint']}: mean score {nm_joint_scores.mean():.6f}")
    start_kw = {"orientation": dict(xmap=xmap), "pc": dict(xmap=refined_xmap, detector=bad_det),
                "joint": dict(xmap=xmap, detector=bad_det)}
    call_name = {"orientation": "refine_orientation", "pc": "refine_projection_center",
                 "joint": "refine_orientation_projection_center"}
    pop_launches, nm_launches, pop_kernel_ms, de_calls = {}, {}, {}, {}
    # Every call runs and reports before a failed gate ends the run.
    failures = []
    for mode, tag in (("orientation", "refine-global"), ("pc", "refine-global-pc"), ("joint", "refine-global-joint")):
        call = getattr(static, call_name[mode])
        kw = dict(master_pattern=mp, trust_region=GLOBAL_TRUST[mode], **start_kw[mode])
        msgs = []
        for method in GLOBAL_METHODS:
            reset_launches()
            # DE's calls recorded: their populations, live masks and results.
            record, de_run = [], tr._differential_evolution
            if method == "de":
                tr._differential_evolution = recording_de(record)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = call(method=method, **kw)
                torch.cuda.synchronize()
                t_first = time.perf_counter() - t0
            finally:
                tr._differential_evolution = de_run
            if method == "de":
                de_calls[mode] = record
            counts = read_launches()
            pops, nms = counts[POP_WRAPPER[mode]], counts[NM_WRAPPER[mode]]
            others = {k: v for k, v in counts.items() if v and k not in (POP_WRAPPER[mode], NM_WRAPPER[mode])}
            if others or nms < 1 or (pops < 1) != (method == "bh"):
                raise AssertionError(f"{call_name[mode]}(method={method!r}) did not run on kernel F and the "
                                     f"Nelder-Mead kernel alone: {counts}")
            pop_launches[(mode, method)], nm_launches[(mode, method)] = pops, nms
            scores, evals = res.xmap.prop["scores"], res.xmap.prop["num_evals"]
            if res.xmap.best_rotations.shape != (n, 4) or not np.isfinite(scores).all():
                raise AssertionError(f"{call_name[mode]}(method={method!r}) gave a bad crystal map")
            below = int((scores < start_scores[mode]).sum())
            if below:
                failures.append(f"{call_name[mode]}(method={method!r}): {below} points end below their start's score")
            ang = np.degrees(disorientation_angle(truth, res.xmap.best_rotations, "m-3m"))
            gate = f"score >= the start's on all points; mean score {scores.mean():.6f}"
            if mode == "orientation":
                worst = np.flatnonzero(near)[np.argsort(ang[near])[-3:]]
                past = ang >= REFINE_MAX_DEG
                gate += (f"; disorientation to truth median {np.median(ang):.4f} deg, max over the {int(reach.sum())} "
                         f"near points whose box holds the truth {ang[reach].max():.4f} (limit {REFINE_MAX_DEG}), "
                         f"over all {int(near.sum())} DI put within {REFINE_START_DEG} deg {ang[near].max():.4f}; at "
                         f"or past the limit {int(past[near].sum())} ({int(past[shut].sum())} of them among the "
                         f"{int(shut.sum())} whose box leaves the truth out; the boxed Nelder-Mead "
                         f"{int((ang_nm_tr[near] >= REFINE_MAX_DEG).sum())}); worst points {worst.tolist()} at "
                         f"{ang[worst].round(3).tolist()} deg, the boxed Nelder-Mead "
                         f"{ang_nm_tr[worst].round(3).tolist()}, start's Phi {start_phi[worst].round(2).tolist()} deg")
                if not ang[reach].max() < REFINE_MAX_DEG:
                    failures.append(f"refine_orientation(method={method!r}) missed: {gate}")
                if method == "de":
                    base = nm_tr.xmap.prop["scores"].mean()
                    gate += f"; Nelder-Mead from the same starts {base:.6f} (limit: less {GLOBAL_MEAN_TOL:g})"
                    if scores.mean() < base - GLOBAL_MEAN_TOL:
                        failures.append(f"refine_orientation(method='de') below Nelder-Mead's mean: {gate}")
            else:
                pcs = res.detector.pc.reshape(-1, 3)
                out = np.abs(pcs - pc0.cpu().numpy()).max(axis=0) - np.asarray(GLOBAL_TRUST[mode][-3:])
                off = np.abs(pcs.mean(axis=0) - np.asarray(PC))
                gate += (f"; mean PC {np.round(pcs.mean(axis=0), 6).tolist()} (off {np.round(off, 6).tolist()}, "
                         f"limit {PC_TOL}), within the trust region (largest excess {out.max():.2e}), "
                         f"disorientation to truth median {np.median(ang):.4f} deg")
                # The mean PC gate is PC mode's; the joint mode's is its mean
                # score (its polish crawls along the PC-rotation valley).
                if not ((out <= 1e-6).all() and (mode == "joint" or (off < PC_TOL).all())):
                    failures.append(f"{call_name[mode]}(method={method!r}) missed the PC: {gate}")
                if mode == "joint":
                    base = nm_joint_scores.mean()
                    gate += (f"; the boxed joint Nelder-Mead's mean score {base:.6f} (limit: less "
                             f"{GLOBAL_MEAN_TOL:g})")
                    if scores.mean() < base - GLOBAL_MEAN_TOL:
                        failures.append(f"joint {method}: mean score below the joint Nelder-Mead's: {gate}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(method=method, **kw)
            torch.cuda.synchronize()
            t_call = time.perf_counter() - t0
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call(method=method, **kw)
                torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) * 1e3
            busy, events = device_busy(prof)
            f_n = sum(cnt for k, cnt, _ in events if "refine_population_" in k)
            f_ms = sum(t for k, _, t in events if "refine_population_" in k)
            nm_ms = sum(t for k, _, t in events if "refine_nm_kernel" in k)
            if f_n:
                pop_kernel_ms[(mode, method)] = f_ms / f_n
            # refine_orientation's nav_chunk batches (its default, NAV_CHUNK)
            chunks = -(-n // NAV_CHUNK) if mode == "orientation" and method != "shgo" else 1
            de_msg = live_shares(record) if method == "de" else ""
            steps = {"de": f"generations {pops / chunks - 1:.1f} a batch; {de_msg}",
                     "da": f"iterations {pops / chunks - 1:.0f} a "
                     "batch", "bh": f"{nms / chunks:.0f} Nelder-Mead launches a batch",
                     "shgo": "65 candidates a point (64 Halton samples and the start)"}[method]
            msgs.append(
                f"{method}: first call {t_first:.3f} s, untraced {t_call * 1e3:.1f} ms = {n / t_call:.1f} patterns/s "
                f"({chunks} batch{'es' if chunks > 1 else ''}); kernel F launches {pops} ({f_n} under the trace, "
                f"{f_ms / max(f_n, 1):.4f} ms a launch, {f_ms:.1f} ms in all), Nelder-Mead kernel launches {nms} "
                f"({nm_ms:.1f} ms); {steps}; num_evals mean {evals.mean():.1f} max {int(evals.max())}; under "
                f"torch.profiler wall {traced:.1f} ms, device busy {busy:.1f} ms = {busy / traced:.1%} (of the untraced call's "
                f"time {busy / (t_call * 1e3):.1%}); {gate}")
        log(tag, f"{smi}: {call_name[mode]}(method=..., trust_region={GLOBAL_TRUST[mode]}) on the {n} static-corrected "
            f"patterns: " + "; ".join(msgs))
    if failures:
        raise AssertionError("the global phases' gates: " + " | ".join(failures))

    # Kernel F at the global solvers' shape: one DE generation of the whole
    # map (M = POP_M) at each spread, against its bounds and its plain
    # version, and held to both as in [population-check]; beside it the
    # sectors a member-pixel reads; then populations the DE call made.
    rows, time_msgs = [], []
    for mode in ("orientation", "pc", "joint"):
        M = POP_M[mode]
        plan = rp.population_plan(d, M, mode)
        spread_ms, sectors, check_msgs = {}, {}, []
        for spread in POP_SPREADS:
            wrapper, objective, plain, x, args = population_problem(mode, start_x[mode], exp, sq, rot_q, quad, om, dc,
                                                                    geo, DETECTOR_SHAPE, M, 90, spread)
            e_plain, check_msg = population_check(wrapper, objective, plain, x, args, f"{mode} n={n} M={M} {spread}")
            pop_err[mode] = max(pop_err[mode], e_plain)
            check_msgs.append(check_msg)
            spread_ms[spread] = cuda_ms(lambda: wrapper(x, *args), 3)
            taps = population_taps(mode, x[:SECTOR_POINTS], args)
            sectors[spread] = {g: sectors_per_member_pixel(taps, g) for g in rp.GROUPS}
            if spread == "sigma 0.5 deg":
                timed = wrapper, plain, x, args
        wrapper, plain, x, args = timed
        ms = spread_ms["sigma 0.5 deg"]
        ms_plain = cuda_ms(lambda: plain(x, *args), 1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                wrapper(x, *args)
            torch.cuda.synchronize()
        _, events = device_busy(prof)
        kernel_only = [t / cnt for k, cnt, t in events if "refine_population_" in k and cnt]
        pixels = n * M * d
        dims = x.shape[2]
        per_pixel_ops = OPS_PER_PIXEL + NCC_OPS_PER_PIXEL + (DC_OPS_PER_PIXEL if mode != "orientation" else 0)
        t_ops = pixels * per_pixel_ops / PEAK_F32_FLOPS * 1e3
        # each input read once (candidates, rows, norms, rotations, direction
        # cosines or pixel table, quad texture), the values written once
        in_bytes = 4 * (x.numel() + exp.numel() + n + (4 * n if mode == "pc" else 0)
                        + (dc.numel() if mode == "orientation" else 2 * d) + quad.numel())
        t_bytes = (in_bytes + 4 * n * M) / PEAK_BYTES * 1e3
        per_pixel = sass["population_pixel"][mode]
        t_instr = instruction_ms(pixels, per_pixel, clock_mhz, sms)
        taps = [pixels / rate * 1e3 for rate in SCATTERED_TAPS_PER_S[::-1]]
        l2_ms = pixels * TAP_BYTES / l2_rate * 1e3
        # The same floor at the plan's group: the sectors its lanes read.
        shared = sectors["sigma 0.5 deg"][plan.group]
        by_path = {f"refine-global{'' if mode == 'orientation' else '-' + mode} {m}": pop_launches[(mode, m)]
                   for m in GLOBAL_METHODS}
        # Populations of the DE call's first batch: generation 0, a middle
        # one and the last, each with its live mask; with the mask equal to
        # the run without it on the live points, +inf on the others.
        evaluate, calls, _ = de_calls[mode][0]
        recorded = {}
        for label, i in (("generation 0", 0), ("middle", len(calls) // 2), ("last", len(calls) - 1)):
            xg, live = calls[i]
            got, full = evaluate(xg, live=live), evaluate(xg)
            if live is not None and not (torch.equal(got[live], full[live]) and bool((got[~live] == torch.inf).all())):
                raise AssertionError(f"kernel F {mode} DE {label}: the live mask changed a live point's values")
            g_taps = population_taps(mode, xg[:SECTOR_POINTS], args)
            recorded[label] = {
                "generation": i, "points": int(xg.shape[0]),
                "live_share": 1.0 if live is None else float(live.float().mean()),
                "ms": cuda_ms(lambda: evaluate(xg, live=live), 3), "ms_without_mask": cuda_ms(lambda: evaluate(xg), 3),
                "sectors_per_member_pixel": {g: sectors_per_member_pixel(g_taps, g) for g in (1, plan.group)}}
        rows.append({
            "name": POP_WRAPPER[mode], "route": "cuda", "source": "kikuchipy_tpu_torch/csrc/refine_population.cu",
            "replaces": "kikuchipy_tpu/utils/optimize.py:883 eval_pop (and :505, :536, :753-756) over "
                        "kikuchipy_tpu/indexing/refinement.py:"
                        + {"orientation": "199 _objective_orientation", "pc": "422 _objective_pc",
                           "joint": "442 _objective_joint"}[mode],
            "launches": pop_launches[(mode, "de")], "max_abs_err": pop_err[mode], "ms": ms, "plain_ms": ms_plain,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "library_same_function_ms": None, "l2_bound_ms": l2_ms,
            "instruction_bound_ms": t_instr, "split_ms": None,
            "kernel_only_ms": kernel_only[0] if kernel_only else None, "de_launch_ms": pop_kernel_ms.get((mode, "de")),
            "de_launch_points": NAV_CHUNK if mode == "orientation" else n,
            "scattered_taps_ms": taps[0], "scattered_sectors_ms": taps[0] * shared,
            "plan": plan._asdict(), "ms_by_spread": spread_ms, "sectors_per_member_pixel": sectors,
            "de_populations": recorded,
            "shape": f"n={n} M={M} d={dims} P={d}", "launches_by_path": by_path,
            "note": "launches: the DE call's of its mode; ms, kernel_only_ms (torch.profiler) and the bounds at "
                    "`shape` (sigma 0.5 deg); ms_by_spread: POP_SPREADS; scattered_sectors_ms: the scattered-taps "
                    "floor at the sectors the plan's group reads a member-pixel (sigma 0.5 deg, the plain twin's "
                    "taps on SECTOR_POINTS points); de_launch_ms: the DE call's mean launch, at de_launch_points "
                    "points a launch; de_populations: the DE call's first batch; max_abs_err: against the plain "
                    "version over [population-check]'s cases and the spreads (bit for bit with the Nelder-Mead "
                    "objectives)",
        })
        time_msgs.append(
            f"{POP_WRAPPER[mode]} at n={n} M={M} (one DE generation; plan {tuple(plan)}; "
            f"{'; '.join(check_msgs)}): sigma 0.5 deg {ms:.3f} ms, the kernel alone "
            f"{rows[-1]['kernel_only_ms']} ms ({pixels / ms / 1e6:.3f} G projected pixels/s); by spread "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in spread_ms.items())
            + "; sectors a member-pixel by group " + ", ".join(
                f"{k} {{{', '.join(f'G={g}: {v:.3f}' for g, v in sec.items())}}}" for k, sec in sectors.items())
            + f"; bound {max(t_ops, t_bytes):.3f} ms by {rows[-1]['bound_by']}; issue slots {t_instr:.3f} ms at "
            f"{per_pixel} SASS a member-pixel ({t_instr / ms:.1%}); scattered taps at {SCATTERED_TAPS_PER_S[0]:.3g}-"
            f"{SCATTERED_TAPS_PER_S[1]:.3g}/s {taps[1]:.3f}-{taps[0]:.3f} ms ({taps[1] / ms:.1%}-{taps[0] / ms:.1%}), "
            f"at the group's {shared:.3f} sectors a member-pixel {taps[1] * shared:.3f}-{taps[0] * shared:.3f} ms "
            f"({taps[1] * shared / ms:.1%}-{taps[0] * shared / ms:.1%}); taps' bytes from L2 {l2_ms:.3f} ms; plain "
            f"version {ms_plain:.1f} ms; no single PyTorch call computes it; the DE call's populations "
            + ", ".join(f"{k} (generation {r['generation']}, {r['points']} points, live {r['live_share']:.3f}): "
                        f"{r['ms']:.3f} ms with the mask, {r['ms_without_mask']:.3f} without, sectors "
                        f"{', '.join(f'G={g}: {v:.3f}' for g, v in r['sectors_per_member_pixel'].items())}"
                        for k, r in recorded.items()))
    log("population-times", f"{smi}: " + "; ".join(time_msgs))
    return rows, nm_launches


# ------------- the workflow around the main path (sampling, kernel G, calibration) ------------- #

# Orientations kept at 2 degrees in m-3m: the spiral of the main path's
# dictionary and the cubochoric grid (both JAX's counts on the CPU).
SPIRAL_COUNT = 107_129
CUBOCHORIC_COUNT = 95_655
# float64 outside the tensor cores (H100 SXM data sheet): kernel G's sums.
PEAK_F64_FLOPS = 34e12
# Kernel G's windows in [neighbours]: the default first (the EBSD call's).
NEIGHBOUR_WINDOWS = {
    "circular 3x3": dict(window="circular", window_shape=(3, 3)),
    "rectangular 2x3": dict(window="rectangular", window_shape=(2, 3)),
    "gaussian 3x3 std 2": dict(window="gaussian", window_shape=(3, 3), std=2),
    "(3,)": dict(window=None, window_shape=(3,)),
    "5x5 rectangular": dict(window="rectangular", window_shape=(5, 5)),
    "rectangular 3x3": dict(window="rectangular", window_shape=(3, 3)),
    "negative 3x3": dict(window=np.array([[-0.5, 1.0, 2.0], [1.0, 4.0, -1.25], [0.5, 1.0, -0.75]])),
}
# ... past the 128 taps passed as launch arguments (the device table), on the
# main path's scan; and a map of patterns whose float32 averages pass the
# shared-memory budget (the device-memory scratch).
NEIGHBOUR_WIDE_WINDOWS = {
    "13x13 rectangular": dict(window="rectangular", window_shape=(13, 13)),
    "13x13 gaussian std 3": dict(window="gaussian", window_shape=(13, 13), std=3),
}
NEIGHBOUR_BIG_MAP = (16, 16)
NEIGHBOUR_BIG_PATTERN = (480, 480)
# Kernel G's 5-tap time on the main path's scan before its redesign (the
# block-a-point kernel the vector kernel replaced; H100 80GB HBM3, 700 W;
# PERF.md), warm.
NEIGHBOUR_5TAP_MS = (0.5445, 0.5634)
# SASS instructions of a pixel of kernel G's main-path instantiation
# (sass_count.py neighbours_pixel: neighbours_vec_kernel<uint8_t, uint8_t,
# 5, true>, a thread's 16 pixels); the run recounts it where the toolkit
# has cuobjdump.
SASS_NEIGHBOURS_PER_PIXEL = 32.125
# Coarser dictionary of the second phase in [calibration] (cubochoric grid).
COARSE_RESOLUTION_DEG = 4.0
# Points of the fitted-PC projection held against the CPU in [calibration].
CALIBRATION_CPU_POINTS = 256


def sampling_phase(smi: str) -> list[str]:
    """``[sampling]``: the spiral and cubochoric samplings of the
    fundamental zone at the main path's 2 degrees on the card: three calls
    each (host clock around a synchronised call), the counts, the device
    busy share of one call under ``torch.profiler``, and the kept rows equal
    to the CPU's at 6 degrees."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kikuchipy_tpu_torch.crystallography import sampling as ts

    msgs = []
    for name, want in (("sample_fundamental_zone", SPIRAL_COUNT), ("get_sample_fundamental", CUBOCHORIC_COUNT)):
        fn = getattr(ts, name)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q = fn(RESOLUTION_DEG, "m-3m")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        norm_off = float(np.abs(np.linalg.norm(q, axis=1) - 1).max())
        if q.shape != (want, 4) or not np.isfinite(q).all() or norm_off > 1e-12:
            raise AssertionError(f"{name}({RESOLUTION_DEG}): shape {q.shape} (want ({want}, 4)), |q| off 1 by "
                                 f"{norm_off:.3g}")
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(RESOLUTION_DEG, "m-3m")
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        busy, events = device_busy(prof)
        card, cpu = fn(6.0, "m-3m"), fn(6.0, "m-3m", device="cpu")
        if card.shape != cpu.shape or float(np.abs(card - cpu).max()) > 1e-12:
            raise AssertionError(f"{name}(6.0) on the card {card.shape} differs from the CPU's {cpu.shape}")
        host = ""
        if name == "sample_fundamental_zone":
            semi = int(np.ceil(131.97049 / (RESOLUTION_DEG - 0.03732)))
            t0 = time.perf_counter()
            ts.super_fibonacci((2 * semi + 1) ** 3)
            host = f"; the spiral on the host alone {(time.perf_counter() - t0) * 1e3:.1f} ms"
        msgs.append(f"{name}({RESOLUTION_DEG}, 'm-3m') on the card: {q.shape[0]} orientations (limit: {want}); calls "
                    f"{', '.join(f'{t:.1f}' for t in times)} ms (the first with the CUDA context's first use of these "
                    f"operations){host}; under torch.profiler wall {wall:.1f} ms, device busy {busy:.2f} ms "
                    f"({busy / wall:.1%}; {len(events)} kernel names: "
                    + "; ".join(f"{k[:40]} x{c} {t:.3f} ms" for k, c, t in events[:4])
                    + f"), {busy / np.median(times[1:]):.1%} of the untraced calls' median; at 6 degrees "
                    f"{card.shape[0]} rows, equal to the CPU's within 1e-12")
    return msgs


def neighbours_library(p, w):
    """Kernel G's function through library calls, timed only (the port
    never calls it): a depthwise ``conv2d`` over the map with the pixels as
    channels in IEEE float32, the same of ones for the per-point weight sum,
    the quotient, the per-pattern min/max rescale to uint8."""
    import torch
    import torch.nn.functional as F

    ny, nx, sy, sx = p.shape
    kh, kw = w.shape
    oy, ox = kh // 2, kw // 2
    pad = (ox, kw - 1 - ox, oy, kh - 1 - oy)
    x = p.reshape(ny, nx, sy * sx).permute(2, 0, 1).to(torch.float32)[None]
    wt = torch.as_tensor(w, dtype=torch.float32, device=p.device)
    acc = F.conv2d(F.pad(x, pad), wt.expand(sy * sx, 1, kh, kw), groups=sy * sx)
    norm = F.conv2d(F.pad(torch.ones((1, 1, ny, nx), device=p.device), pad), wt[None, None])
    out = (acc / norm)[0].permute(1, 2, 0)
    lo, hi = out.amin(dim=-1, keepdim=True), out.amax(dim=-1, keepdim=True)
    return ((out - lo) / (hi - lo) * 255.0).to(torch.uint8).reshape(ny, nx, sy, sx)


def neighbours_phases(device, scan, smi: str, main_count: int, pixel_sass: float, clock_mhz: float,
                      sms: int) -> tuple[dict, list[str], list[str]]:
    """``[neighbours]``: ``EBSD.average_neighbour_patterns`` on the main
    path's 16,384-pattern scan (one launch of kernel G), then kernel G
    against its plain version bit for bit on the scan with each window of
    NEIGHBOUR_WINDOWS, on the edge shapes (maps of 1 x 1, 1 x N, N x 1 and
    3 x 3, 1 x 16 and 7 x 9 patterns), on data a byte past a 16-byte
    boundary and other storage types, each call on the route
    ``neighbours_plan`` names (the vector kernel, on its integer route for
    the EBSD call, or the general kernel). ``[neighbours-times]``: kernel G
    at the main path's shape warm and with L2 flushed, its bounds (bytes,
    float64 operations, issue slots at ``pixel_sass`` a pixel), its plain
    version, and the library yardstick. ``main_count`` is kernel G's
    launches in the main path's run. Returns kernel G's row, and both
    phases' messages."""
    import torch

    from kikuchipy_tpu_torch.ops import neighbours as ng
    from kikuchipy_tpu_torch.utils.device import matmul_precision

    p = scan.data
    ny, nx, sy, sx = p.shape
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg = scan.average_neighbour_patterns()
    torch.cuda.synchronize()
    t_call = (time.perf_counter() - t0) * 1e3
    counts = read_launches()
    if (counts["average_neighbours"] != 1 or sum(v for k, v in counts.items() if "[" not in k) != 1
            or counts["average_neighbours[vector]"] != 1):
        raise AssertionError(f"EBSD.average_neighbour_patterns was not one launch of kernel G's vector kernel alone: "
                             f"{counts}")
    main_plan = ng.neighbours_plan(p.dtype, torch.uint8, p.shape[2] * p.shape[3],
                                   ng.window_taps(ng._resolve_window("circular", (3, 3)))[1], 16, 16)
    if not (main_plan.route == "vector" and main_plan.integer and main_plan.taps == 5):
        raise AssertionError(f"the main path's scan is not on the vector kernel's 5-tap integer route: {main_plan}")
    if avg.data.dtype != torch.uint8 or tuple(avg.data.shape) != tuple(p.shape):
        raise AssertionError(f"average_neighbour_patterns gave {avg.data.dtype} {tuple(avg.data.shape)}")
    max_err = 0.0
    routes = {"vector": 0, "vector (integer)": 0, "general": 0}

    def check(label, data, kw, dtype_out=None):
        nonlocal max_err
        w = ng._resolve_window(kw.get("window"), kw.get("window_shape", (3, 3)),
                               **{k: v for k, v in kw.items() if k not in ("window", "window_shape")})
        offsets, weights = ng.window_taps(w)
        dtype_out = data.dtype if dtype_out is None else dtype_out
        plan = ng.neighbours_plan(data.dtype, dtype_out, data.shape[2] * data.shape[3], weights,
                                  ng._alignment(data.data_ptr()), 16)
        before = dict(ng.average_neighbours.mode_launches)
        got = ng.average_neighbours(data, offsets, weights, dtype_out)
        if ng.average_neighbours.mode_launches[plan.route] != before[plan.route] + 1:
            raise AssertionError(f"kernel G on {label} did not take the route its plan names ({plan})")
        routes[plan.route if not plan.integer else "vector (integer)"] += 1
        ref = ng.average_neighbours_plain(data, offsets, weights, dtype_out)
        torch.cuda.synchronize()
        diff = (got.to(torch.float64) - ref.to(torch.float64)).abs()
        max_err = max(max_err, float(diff.nan_to_num(0.0).max()))
        same = got.dtype == ref.dtype and got.shape == ref.shape and bool(
            torch.equal(torch.isnan(got), torch.isnan(ref)) if got.is_floating_point() else True)
        if got.is_floating_point():
            bits = {torch.float32: torch.int32}[got.dtype]
            keep = ~torch.isnan(ref)
            same = same and torch.equal(got.view(bits)[keep], ref.view(bits)[keep])
        else:
            same = same and torch.equal(got, ref)
        if not same:
            raise AssertionError(f"kernel G differs from its plain version on {label}: max {float(diff.max())}, "
                                 f"{int((diff > 0).sum())} of {diff.numel()} values")
        return got

    default = dict(NEIGHBOUR_WINDOWS["circular 3x3"])
    if not torch.equal(check("the EBSD call's window", p, default), avg.data):
        raise AssertionError("the EBSD call and the wrapper give different patterns")
    cases = [f"the {ny} x {nx} scan, {name}" for name in NEIGHBOUR_WINDOWS]
    for name, kw in NEIGHBOUR_WINDOWS.items():
        check(f"the scan, {name}", p, kw)
    rng = np.random.default_rng(11)
    edge = [((1, 1), (60, 60)), ((1, 128), (60, 60)), ((128, 1), (60, 60)), ((3, 3), (60, 60)), ((3, 3), (1, 16)),
            ((9, 11), (1, 16)), ((9, 11), (7, 9))]
    for nav, sig in edge:
        data = torch.as_tensor(rng.integers(0, 256, size=nav + sig, dtype=np.uint8), device=device)
        for name, kw in NEIGHBOUR_WINDOWS.items():
            check(f"map {nav}, patterns {sig}, {name}", data, kw)
        cases.append(f"map {nav} x patterns {sig} (5 windows)")
    # A byte past a 16-byte boundary: the general kernel.
    flat = torch.empty(32 * 32 * 3600 + 16, dtype=torch.uint8, device=device)
    shifted = flat[1:1 + 32 * 32 * 3600].view(32, 32, 60, 60)
    shifted.copy_(p[:32, :32])
    for name in ("circular 3x3", "gaussian 3x3 std 2"):
        check(f"32 x 32 of the scan a byte past a 16-byte boundary, {name}", shifted, NEIGHBOUR_WINDOWS[name])
    cases.append("32 x 32 of the scan a byte past a 16-byte boundary (2 windows)")
    del flat, shifted
    sub = p[:32, :32]
    for dtype_in, dtype_out in ((torch.uint16, torch.uint16), (torch.float32, torch.float32),
                                (torch.uint8, torch.float32), (torch.float32, torch.uint8)):
        data = (sub.to(torch.int32) * (257 if dtype_in == torch.uint16 else 1)).to(dtype_in)
        check(f"{dtype_in} -> {dtype_out}", data, NEIGHBOUR_WINDOWS["gaussian 3x3 std 2"], dtype_out)
        cases.append(f"32 x 32 of the scan {str(dtype_in)[6:]} -> {str(dtype_out)[6:]}")
    # Past the launch argument's 128 taps (the device table) on the scan, and
    # patterns past the shared-memory budget (the device-memory scratch).
    wide_ms = {}
    for name, kw in NEIGHBOUR_WIDE_WINDOWS.items():
        check(f"the scan, {name}", p, kw)
        cases.append(f"the {ny} x {nx} scan, {name}")
        w_wide = ng._resolve_window(kw["window"], kw["window_shape"],
                                    **{k: v for k, v in kw.items() if k not in ("window", "window_shape")})
        taps_wide = ng.window_taps(w_wide)
        wide_ms[name] = (len(taps_wide[1]), cuda_ms(lambda: ng.average_neighbours(p, *taps_wide, torch.uint8), 10,
                                                    lead_ms=2.0))
    big = torch.as_tensor(rng.integers(0, 256, size=NEIGHBOUR_BIG_MAP + NEIGHBOUR_BIG_PATTERN, dtype=np.uint8),
                          device=device)
    big_ms = {}
    for name, kw in (("circular 3x3", NEIGHBOUR_WINDOWS["circular 3x3"]),
                     ("13x13 gaussian std 3", NEIGHBOUR_WIDE_WINDOWS["13x13 gaussian std 3"])):
        check(f"map {NEIGHBOUR_BIG_MAP}, patterns {NEIGHBOUR_BIG_PATTERN}, {name}", big, kw)
        cases.append(f"map {NEIGHBOUR_BIG_MAP} x patterns {NEIGHBOUR_BIG_PATTERN} ({big.numel() / 1e6:.0f} MB), {name}")
        w_big = ng._resolve_window(kw["window"], kw.get("window_shape", (3, 3)),
                                   **{k: v for k, v in kw.items() if k not in ("window", "window_shape")})
        taps_big = ng.window_taps(w_big)
        big_ms[name] = (len(taps_big[1]), cuda_ms(lambda: ng.average_neighbours(big, *taps_big, torch.uint8), 10,
                                                  lead_ms=2.0))
    del big
    check_msg = (f"EBSD.average_neighbour_patterns() on the main path's {ny * nx} patterns: one launch of kernel G "
                 f"({counts['average_neighbours']}, the vector kernel's 5-tap integer route, a block of "
                 f"{main_plan.warps} warps a map point), {t_call:.2f} ms first call; kernel G == its plain "
                 f"version bit for bit on {len(cases)} cases ({sum(routes.values())} calls by route: {routes}): "
                 + "; ".join(cases))

    # ---- times ----
    w = ng._resolve_window("circular", (3, 3))
    offsets, weights = ng.window_taps(w)
    kernel = lambda: ng.average_neighbours(p, offsets, weights, torch.uint8)  # noqa: E731
    plain = lambda: ng.average_neighbours_plain(p, offsets, weights, torch.uint8)  # noqa: E731
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    ms = cuda_ms(kernel, 20, lead_ms=2.0)
    ms_cold = cuda_ms_cold(kernel, 20, flush)
    plain_ms = cuda_ms(plain, 3)
    with matmul_precision(False):
        library_ms = cuda_ms(lambda: neighbours_library(p, w), 5)
        lib_out = neighbours_library(p, w)
    lib_diff = (lib_out.to(torch.int16) - kernel().to(torch.int16)).abs()
    del flush
    n, npix = ny * nx, sy * sx
    t_bytes = 2 * n * npix / PEAK_BYTES * 1e3
    # The integer route does no float64 operation; the float64 route's count
    # is kept for the other windows' rows.
    t_ops = 0.0 if main_plan.integer else n * npix * 2 * len(weights) / PEAK_F64_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    t_instr = n * npix * pixel_sass / 32 / (sms * WARP_INSTR_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    row = {
        "name": "average_neighbours", "route": "cuda", "source": "kikuchipy_tpu_torch/csrc/neighbours.cu",
        "replaces": "kikuchipy_tpu/ops/neighbors.py:57 _average_impl under :78 average_neighbour_patterns",
        "launches": counts["average_neighbours"],
        "launches_by_path": {"main": main_count, "neighbours": counts["average_neighbours"]},
        "max_abs_err": max_err, "ms": ms, "ms_cold": ms_cold, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": library_ms,
        "instruction_bound_ms": t_instr, "route": str(main_plan),
        "shape": f"map {ny} x {nx}, patterns {sy} x {sx} uint8 -> uint8, {len(weights)} taps",
        "note": "launches: the EBSD.average_neighbour_patterns call's, launches_by_path main: the main path's run; "
                "max_abs_err: the largest |kernel - plain| over [neighbours]' cases; ms with launches back to back, "
                "ms_cold with L2 flushed before each; bound: bytes (the integer route does no float64 operation); "
                "instruction_bound_ms: sass_count.py neighbours_pixel a pixel; library: depthwise conv2d over the "
                "map, the pixels as channels, IEEE float32, the quotient and the rescale (timed only)",
    }
    times_msg = (f"{smi}: kernel G at map {ny} x {nx}, 60 x 60 uint8, {len(weights)} taps: {ms:.4f} ms warm, "
                 f"{ms_cold:.4f} ms cold (bound {bound:.4f} ms by {row['bound_by']}: bytes {t_bytes:.4f} ms for "
                 f"{2 * n * npix / 1e6:.1f} MB, no float64 operation on the integer route; "
                 f"{bound / ms:.2%} / {bound / ms_cold:.2%} of it; issue slots {t_instr:.4f} ms at {pixel_sass:g} "
                 f"SASS a pixel and {clock_mhz:.0f} MHz, {t_instr / ms:.2%} / {t_instr / ms_cold:.2%} of it); "
                 f"plain {plain_ms:.3f} ms; library (depthwise conv2d, "
                 f"float32, timed only) {library_ms:.3f} ms, its uint8 output within {int(lib_diff.max())} gray of "
                 f"kernel G's on {float((lib_diff > 0).float().mean()):.4%} of the pixels")
    lo, hi = NEIGHBOUR_5TAP_MS
    where = "below" if ms < lo else "above" if ms > hi else "within"
    times_msg += f"; the 5-tap time {where} the range of the block-a-point kernel before the redesign ({lo}-{hi} ms)"
    # The float64 route at 9 taps (the Gaussian) on the scan.
    offsets9, weights9 = ng.window_taps(ng._resolve_window("gaussian", (3, 3), std=2))
    ms9 = cuda_ms(lambda: ng.average_neighbours(p, offsets9, weights9, torch.uint8), 20, lead_ms=2.0)
    t_ops9 = n * npix * 2 * len(weights9) / PEAK_F64_FLOPS * 1e3
    times_msg += (f"; the float64 route (gaussian 3x3 std 2, 9 taps) {ms9:.4f} ms (bound {max(t_bytes, t_ops9):.4f} ms "
                  f"by {'operations' if t_ops9 > t_bytes else 'bytes'}, float64 {t_ops9:.4f} ms)")
    row["float64_9tap_ms"] = ms9
    times_msg += "; windows past 128 taps (device table) on the scan: " + "; ".join(
        f"{name} ({n_taps} taps) {t:.4f} ms" for name, (n_taps, t) in wide_ms.items())
    times_msg += (f"; map {NEIGHBOUR_BIG_MAP} of {NEIGHBOUR_BIG_PATTERN} uint8 patterns (device-memory scratch): "
                  + "; ".join(f"{name} ({n_taps} taps) {t:.4f} ms" for name, (n_taps, t) in big_ms.items()))
    row["wide_window_ms"] = {name: t for name, (_, t) in wide_ms.items()}
    row["scratch_ms"] = {name: t for name, (_, t) in big_ms.items()}
    return row, [check_msg], [times_msg]


# ------------------------- Hough indexing (kernel H) ------------------------- #

# Nickel as tests/test_hough.py:14 has it: space group 225, a = 3.5236 A, the
# four fcc atoms. With min_dspacing 1 its poles are the {111}, {200}, {220} and
# {311} families, the synthetic master's bands (BAND_FAMILIES).
NI_LATTICE = (3.5236, 3.5236, 3.5236, 90.0, 90.0, 90.0)
NI_ATOMS = [("ni", 0, 0, 0), ("ni", 0.5, 0.5, 0), ("ni", 0.5, 0, 0.5), ("ni", 0, 0.5, 0.5)]
HOUGH_BANDS = 9
# Clean simulated patterns of [hough] (a), and JAX's criterion on them
# (tests/test_hough.py:61-81): every disorientation under 1 degree, at least
# 3 inlier bands; (b) the noisy scan: the median under 1 degree.
HOUGH_CLEAN = 1024
HOUGH_MAX_DEG = 1.0
HOUGH_MIN_BANDS = 3
# The clean patterns are simulated from a master whose bands have the Bragg
# angle theta_B as sigma (a full width at half maximum of 1.18 x 2 theta_B, as
# a Kikuchi band's); the main path's master blurs each band to twice that.
# On the main path's master the clean patterns are indexed too and reported:
# there the vote misindexes a few of them whatever the package
# (tests/test_torch_hough_master.py holds, on every 64th of them, that JAX
# misindexes some and the port none that JAX indexes), so that run is gated
# on the share under 1 degree and the median.
HOUGH_BAND_WIDTH = 0.5
HOUGH_WIDE_SHARE = 0.95
# SASS instructions of one pole and band of kernel H's scoring (sass_count.py
# hough_pole: |R n . g| and the running maximum, a ninth of the pole's
# broadcast load); the run recounts it where the toolkit has cuobjdump.
SASS_HOUGH_PER_POLE = 4.111111111111111
# [hough-pc]: JAX's full-path case (tests/test_hough.py:218-270), four clean
# patterns each under its own PC, from their mean with a trust region of
# 0.04, gated on the largest error under 1.2e-2; then the scan from the PC
# off by PC_OFFSET.
HOUGH_PC_TRUTH = ((0.41, 0.21, 0.49), (0.43, 0.21, 0.50), (0.41, 0.23, 0.51), (0.43, 0.23, 0.49))
HOUGH_PC_MAX_ERR = 1.2e-2


def ni_phase():
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase

    return Phase("ni", space_group=225, lattice=NI_LATTICE, atoms=NI_ATOMS)


def unit64(q) -> np.ndarray:
    """Quaternions scaled to unit length in float64 (else 2 acos |q . q|
    reads 0.05 degrees between a float32 rotation and itself)."""
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def hough_vote_inputs(signal):
    """Kernel H's inputs on the card as ``hough_indexing`` makes them for
    ``signal``: the integer-peak band normals, nickel's poles, the LUT and
    the band pairs; and the tolerance."""
    import torch

    from kikuchipy_tpu_torch.indexing import hough as th

    dev = signal.data.device
    g, la, lp = th._poles_and_lut(ni_phase(), None, 1.0, 20.0)
    out = th.detect_bands_fused(signal.data, n_bands=HOUGH_BANDS)
    rho_idx, theta_idx = (a.cpu().numpy().reshape(-1, HOUGH_BANDS) for a in out[4:])
    normals = th.bands_to_normals(rho_idx, theta_idx, signal.detector, n_theta=180, n_rho=96)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)  # noqa: E731
    i32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)  # noqa: E731
    return (f32(normals), f32(g), f32(la), i32(lp), i32(th._pair_index(HOUGH_BANDS))), float(np.deg2rad(2.0))


def hough_check(args, tol, chunk: int = 1024) -> tuple[dict, str]:
    """``[hough-check]``: kernel H against ``vote_orientations_plain`` on the
    same inputs by ``hough_vote.vote_disagreements``' criterion (the
    kernel's R and err the plain version's where the best score is clear,
    else a candidate's near the best). ``max_abs_err``: the largest |R - R'|
    or |err - err'| against what each pattern is held to."""
    import torch

    from kikuchipy_tpu_torch.ops import hough_vote as hv

    got = hv.vote_orientations(*args, tol)
    ref = hv.vote_orientations_plain(*args, tol, chunk=chunk)
    torch.cuda.synchronize()
    bad, stats = hv.vote_disagreements(got, ref, *args, tol, chunk=chunk)
    if bad:
        raise AssertionError("kernel H against its plain version: " + "; ".join(bad))
    stats["max_abs_err"] = max(stats["max_r_diff"], stats["max_err_diff"])
    msg = (f"kernel H == vote_orientations_plain on {stats['n']} patterns (n_bands {args[0].shape[1]}, "
           f"{args[1].shape[0]} poles, LUT {args[2].shape[0]}, {args[4].shape[0]} pairs): clear best "
           f"{stats['clear']} (R and err the plain version's), near ties {stats['near_ties']} (R and err a "
           f"candidate's within the gap of the best), a band within {hv.COS_DELTA} of cos(tol) "
           f"{stats['boundary']} (R a candidate's; n_in equal on {stats['boundary_n_in_equal']}), no valid "
           f"candidate {stats['none_valid']} (R candidate 0's); R within {stats['max_r_diff']:.3g} (limit "
           f"{hv.R_TOL}), err within {stats['max_err_diff']:.3g} rad (largest limit {stats['max_err_limit']:.3g})")
    return stats, msg


def hough_valid_candidates(args, tol) -> int:
    """The candidates kernel H scores on these inputs: 8 for each LUT slot in
    tolerance of a pair whose angle is above 0.05 rad (the first K of each
    pair's)."""
    import torch

    from kikuchipy_tpu_torch.ops import hough_vote as hv

    normals, _, la, _, pair_idx = args
    tol32, _ = hv.candidate_threshold(tol)
    k = min(8, la.shape[0])
    total = 0
    for s0 in range(0, normals.shape[0], 2048):
        nrm = normals[s0:s0 + 2048]
        ang = torch.arccos(torch.clamp(torch.abs(torch.sum(nrm[:, pair_idx[:, 0]] * nrm[:, pair_idx[:, 1]], -1)),
                                       0.0, 1.0))
        in_tol = (torch.abs(la[None, None, :] - ang[..., None]) < tol32).sum(-1)
        total += int((torch.clamp(in_tol, max=k) * (ang > hv.MIN_PAIR_ANGLE)).sum()) * 8
    return total


def hough_phases(dev, mp, hough_mp, det, pre, truth, smi: str, pole_sass: float, clock_mhz: float, sms: int):
    """``[hough-check]``, ``[hough]`` and kernel H's row: ``EBSD.hough_indexing``
    with nickel at n_bands=9 on (a) HOUGH_CLEAN clean simulated patterns and
    (b) the main path's 16,384-pattern scan after static and dynamic removal;
    kernel H against its plain version on the scan's normals; the call's
    first and warm times, its stages, the device busy share and peak
    memory; kernel H's times against its bounds."""
    import torch

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography import sampling as ts
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.indexing import hough as th
    from kikuchipy_tpu_torch.ops import hough_vote as hv

    msgs = {"hough-check": [], "hough": []}
    spent = {}
    t_phase = time.perf_counter()
    plain_calls = [0]
    plain = hv.vote_orientations_plain

    def counted_plain(*a, **k):
        plain_calls[0] += 1
        return plain(*a, **k)

    def call(signal):
        """One hough_indexing call: kernel H exactly once, the plain vote never."""
        reset_launches()
        plain_calls[0] = 0
        hv.vote_orientations_plain = counted_plain
        try:
            xm = signal.hough_indexing(phase_list=ni_phase(), n_bands=HOUGH_BANDS)
        finally:
            hv.vote_orientations_plain = plain
        torch.cuda.synchronize()
        counts = read_launches()
        if counts["vote_orientations"] != 1 or plain_calls[0]:
            raise AssertionError(f"hough_indexing: kernel H launched {counts['vote_orientations']} times (want 1), "
                                 f"the plain vote {plain_calls[0]} times (want 0)")
        return xm, counts

    # (a) JAX's own case (tests/test_hough.py:61-81), then HOUGH_CLEAN clean
    # simulated patterns; the first call builds the host operator.
    rng = np.random.default_rng(3)
    eu = rng.uniform(0, 1, size=(4, 3)) * [2 * np.pi, np.pi, 2 * np.pi]
    rot4 = tq.from_euler(torch.as_tensor(eu)).numpy()
    det4 = kt.EBSDDetector(shape=DETECTOR_SHAPE, pc=(0.42, 0.21, 0.5), sample_tilt=70)
    sig4 = kt.EBSD(hough_mp.get_patterns(rot4, det4, dtype_out=np.uint8).data, detector=det4, device=dev)
    n_clean = HOUGH_CLEAN
    clean_rot = truth[:: len(truth) // n_clean][:n_clean]
    clean = kt.EBSD(hough_mp.get_patterns(clean_rot, det, dtype_out=np.uint8).data, detector=det, device=dev)
    wide = kt.EBSD(mp.get_patterns(clean_rot, det, dtype_out=np.uint8).data, detector=det, device=dev)
    # The first call builds the host operator: its build timed inside it.
    th._radon_matrix.cache_clear()
    th._radon_butterfly_matrix.cache_clear()
    th._device_operator.cache_clear()
    build = th._radon_butterfly_matrix
    t_build = []

    def timed_build(*shape):
        t0 = time.perf_counter()
        out = build(*shape)
        t_build.append(time.perf_counter() - t0)
        return out

    th._radon_butterfly_matrix = timed_build
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launches()
        xm4 = sig4.hough_indexing(phase_list=ni_phase(), n_bands=8)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
    finally:
        th._radon_butterfly_matrix = build
    t_build = sum(t_build)
    ang4 = np.degrees(ts.disorientation_angle(rot4, unit64(xm4.rotations), "m-3m"))
    if not (ang4.max() < HOUGH_MAX_DEG and (xm4.prop["nbands"] >= HOUGH_MIN_BANDS).all()):
        raise AssertionError(f"[hough] JAX's case: disorientation {np.round(ang4, 3).tolist()} deg (limit "
                             f"{HOUGH_MAX_DEG}), nbands {xm4.prop['nbands'].tolist()} (limit {HOUGH_MIN_BANDS})")
    xm, counts = call(clean)
    clean_launches = counts["vote_orientations"]
    ang = np.degrees(ts.disorientation_angle(clean_rot, unit64(xm.rotations), "m-3m"))
    nb = xm.prop["nbands"]
    if not (ang.max() < HOUGH_MAX_DEG and (nb >= HOUGH_MIN_BANDS).all()):
        raise AssertionError(f"[hough] clean: disorientation max {ang.max():.3f} deg (limit {HOUGH_MAX_DEG}), "
                             f"nbands min {nb.min()} (limit {HOUGH_MIN_BANDS})")
    clean_warm = [None] * 3
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(clean)
        clean_warm[i] = (time.perf_counter() - t0) * 1e3
    xw, _ = call(wide)
    ang_w = np.degrees(ts.disorientation_angle(clean_rot, unit64(xw.rotations), "m-3m"))
    share_w = float((ang_w < HOUGH_MAX_DEG).mean())
    if not (share_w >= HOUGH_WIDE_SHARE and np.median(ang_w) < HOUGH_MAX_DEG):
        raise AssertionError(f"[hough] clean, the main path's master: under {HOUGH_MAX_DEG} deg {share_w:.4f} (limit "
                             f"{HOUGH_WIDE_SHARE}), median {np.median(ang_w):.3f}")
    msgs["hough"].append(
        f"(a) JAX's case (4 orientations from default_rng(3), PC (0.42, 0.21, 0.5), n_bands 8): disorientation "
        f"{np.round(ang4, 4).tolist()} deg (limit {HOUGH_MAX_DEG}), nbands {xm4.prop['nbands'].tolist()}; "
        f"{n_clean} clean simulated patterns (60 x 60 uint8, bands of sigma {HOUGH_BAND_WIDTH} x 2 theta_B): "
        f"disorientation max {ang.max():.4f} deg, median {np.median(ang):.4f} (limit max {HOUGH_MAX_DEG}), nbands "
        f"min {nb.min()} mean {nb.mean():.2f} (limit >= {HOUGH_MIN_BANDS}); the same orientations on the main "
        f"path's master (sigma 2 theta_B): under {HOUGH_MAX_DEG} deg {share_w:.4f} (limit {HOUGH_WIDE_SHARE}), "
        f"median {np.median(ang_w):.4f}, max {ang_w.max():.2f}, nbands mean {xw.prop['nbands'].mean():.2f}; first "
        f"call (JAX's case) {t_first:.2f} s, of which the host operator build {t_build:.2f} s (then its upload and "
        f"the first use of the operations), warm on the {n_clean} {', '.join(f'{t:.1f}' for t in clean_warm)} ms; "
        f"kernel H launches "
        f"a call {clean_launches}, the plain vote 0; launches of the call "
        f"{ {k: v for k, v in counts.items() if v} }")

    spent["(a)"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # (b) the noisy scan after static and dynamic removal.
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xm, counts = call(pre)
    t_scan_first = (time.perf_counter() - t0) * 1e3
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    ang = np.degrees(ts.disorientation_angle(truth, unit64(xm.rotations), "m-3m"))
    med, under2 = float(np.median(ang)), float((ang < 2.0).mean())
    if not med < HOUGH_MAX_DEG:
        raise AssertionError(f"[hough] scan: median disorientation {med:.3f} deg (limit {HOUGH_MAX_DEG})")
    scan_launches = counts["vote_orientations"]
    b = call_breakdown(lambda: pre.hough_indexing(phase_list=ni_phase(), n_bands=HOUGH_BANDS), 3, traced=2,
                       launches=lambda: hv.vote_orientations.launches)

    # The call's stages, each alone (CUDA events for device stages, the host
    # clock around synchronised host stages).
    n_scan = pre.navigation_size
    flat = pre.data.reshape(n_scan, -1).to(torch.float32)
    th._device_operator.cache_clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rb = th._device_operator(True, *det.shape, 180, 96, str(dev))
    torch.cuda.synchronize()
    t_upload = (time.perf_counter() - t0) * 1e3
    enh = th._operator_product(flat, rb).reshape(n_scan, 96, 180)
    stages = {
        "detection product": cuda_ms(lambda: th._operator_product(flat, rb), 3),
        "peak pick (NMS + topk_stable)": cuda_ms(lambda: th._peak_pick(enh, HOUGH_BANDS), 3),
        "topk_stable alone": cuda_ms(lambda: th.topk_stable(enh.reshape(n_scan, -1), HOUGH_BANDS), 3),
        "peak pick and refinement": cuda_ms(lambda: th._refine_from_enhanced(enh, HOUGH_BANDS), 3),
    }
    out = [a.cpu().numpy() for a in th._refine_from_enhanced(enh, HOUGH_BANDS)]
    t0 = time.perf_counter()
    normals = th.bands_to_normals(out[4], out[5], det, n_theta=180, n_rho=96)
    normals_ref = th.bands_to_normals(out[0], out[1], det, n_theta=180, n_rho=96, return_rho_g=True)[0]
    stages["normals on the host"] = (time.perf_counter() - t0) * 1e3
    args, tol = hough_vote_inputs(pre)
    vote = lambda: hv.vote_orientations(*args, tol)  # noqa: E731
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    ms_h = cuda_ms(vote, 10, lead_ms=2.0)
    ms_h_cold = cuda_ms_cold(vote, 5, flush)
    del flush
    stages["kernel H"] = ms_h
    R0 = vote()[0]
    nref = torch.as_tensor(normals_ref, dtype=torch.float32, device=dev)

    def refits():
        R = R0
        for _ in range(3):
            R, _, _ = th._refit_orientations(R, nref, args[1], tol)
        return R

    stages["three refits"] = cuda_ms(refits, 3)
    R_final = refits()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = ts.reduce_to_fundamental_zone(tq.from_matrix(R_final), "m-3m", device=dev)
    stages["fundamental-zone reduction (host clock)"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    kt.CrystalMap(rotations=q, shape=pre.navigation_shape, prop={"fit": np.zeros(n_scan)})
    stages["the map (host clock)"] = (time.perf_counter() - t0) * 1e3
    ms_plain = cuda_ms(lambda: hv.vote_orientations_plain(*args, tol), 1)
    del enh, flat

    spent["(b) and the stages"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # [hough-check] on the same normals.
    stats, check_msg = hough_check(args, tol)
    msgs["hough-check"].append(check_msg)
    spent["[hough-check]"] = time.perf_counter() - t_phase

    # Kernel H's bounds: the valid candidates' scoring.
    n_valid = hough_valid_candidates(args, tol)
    nb, ng = args[0].shape[1], args[1].shape[0]
    flop = n_valid * nb * (ng * 3 + 9) * 2
    t_ops = flop / PEAK_F32_FLOPS * 1e3
    t_bytes = (args[0].numel() * 4 + n_scan * 44) / PEAK_BYTES * 1e3
    t_instr = n_valid * nb * ng * pole_sass / 32 / (sms * WARP_INSTR_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    n_cand = n_scan * args[4].shape[0] * min(8, args[2].shape[0]) * 8
    row = {
        "name": "vote_orientations", "route": "cuda", "source": "kikuchipy_tpu_torch/csrc/hough_vote.cu",
        "replaces": "kikuchipy_tpu/indexing/hough.py:473 _vote_orientations (XLA code, no TPU kernel)",
        "launches": scan_launches, "launches_by_path": {"hough scan": scan_launches, "hough clean": clean_launches},
        "max_abs_err": stats["max_abs_err"], "ms": ms_h, "ms_cold": ms_h_cold, "plain_ms": ms_plain,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "instruction_bound_ms": t_instr, "near_ties": stats["near_ties"],
        "clear": stats["clear"], "poles": hv.pole_route(ng),
        "block": dict(zip(("patterns", "warps_a_pattern"), hv.block_shape(nb, ng, args[4].shape[0],
                                                                          min(8, args[2].shape[0])))),
        "shape": f"n={n_scan} n_bands={nb} poles={ng} LUT={args[2].shape[0]} pairs={args[4].shape[0]} K=8; "
                 f"{n_valid} of {n_cand} candidates valid",
        "note": "max_abs_err: the largest |R - R'| or |err - err'| over [hough-check]'s patterns, R' and err' "
                "the plain version's on a clear best, the nearest matching candidate's on a near tie; bound: "
                "the valid candidates' R n (9 FMA) and |R n . g| (3 FMA) a pole and band, an FMA two operations; "
                "instruction_bound_ms: sass_count.py hough_pole a pole and band; no PyTorch call computes the vote",
    }
    scan_msg = (f"(b) the main path's {n_scan} noisy patterns after static and dynamic removal: disorientation to the "
                f"truth median {med:.4f} deg (limit {HOUGH_MAX_DEG}), under 2 deg {under2:.4f}, max {ang.max():.2f}; "
                f"nbands mean {xm.prop['nbands'].mean():.2f}; kernel H launches {scan_launches}, the plain vote 0; "
                f"first call on the scan {t_scan_first:.1f} ms, peak memory {peak_gb:.2f} GB over the call's start; "
                f"{breakdown_text(b)}; device busy share "
                + (f"{b['device_ms'] / b['traced_ms']:.1%}" if b["device_ms"] is not None else "not measured")
                + f" of the traced call; stages: operator upload {t_upload:.1f} ms (host clock, once a device), "
                + "; ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
    msgs["hough"].append(scan_msg)
    msgs["hough"].append(
        f"{smi}: kernel H at n={n_scan}: {ms_h:.4f} ms warm, {ms_h_cold:.4f} ms cold; bound {row['bound_ms']:.4f} ms "
        f"by {row['bound_by']} ({flop / 1e9:.2f} GFLOP of {n_valid} valid candidates at "
        f"{PEAK_F32_FLOPS / 1e12:g} TFLOP/s; {row['bound_ms'] / ms_h:.2%} of it), issue slots {t_instr:.4f} ms "
        f"({pole_sass:g} SASS a pole at {clock_mhz:.0f} MHz); plain version {ms_plain:.2f} ms; no single PyTorch "
        f"call computes the vote; the phases took " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    return row, msgs


def hough_pc_phase(dev, hough_mp, det, pre, smi: str) -> list[str]:
    """``[hough-pc]``: ``EBSD.hough_indexing_optimize_pc(batch=True)`` on JAX's
    four-pattern case (gated on its largest PC error under 1.2e-2), then on
    the main path's scan from the PC off by PC_OFFSET (gated on its mean
    error falling below the start's); times and the device busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.geometry import quaternion as tq

    msgs = []
    rng = np.random.default_rng(3)
    eu = rng.uniform(0, 1, size=(4, 3)) * [2 * np.pi, np.pi, 2 * np.pi]
    rot = tq.from_euler(torch.as_tensor(eu)).numpy()
    pc_truth = np.asarray(HOUGH_PC_TRUTH)
    pats = [hough_mp.get_patterns(rot[k:k + 1], dataclasses.replace(det, pc=pc_truth[k]),
                                  dtype_out=np.uint8).data[0]
            for k in range(4)]
    sig = kt.EBSD(torch.stack(pats), detector=dataclasses.replace(det, pc=pc_truth.mean(axis=0)), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det_opt = sig.hough_indexing_optimize_pc(batch=True, phase_list=ni_phase(), n_bands=8,
                                             trust_region=(0.04, 0.04, 0.04))
    torch.cuda.synchronize()
    t_small = (time.perf_counter() - t0) * 1e3
    err = np.abs(np.asarray(det_opt.pc).reshape(4, 3) - pc_truth)
    if not err.max() < HOUGH_PC_MAX_ERR:
        raise AssertionError(f"[hough-pc] four patterns: PC error max {err.max():.4g} (limit {HOUGH_PC_MAX_ERR})")
    msgs.append(f"JAX's four-pattern case (planted +-0.01 PC spread, trust region 0.04, n_bands 8; bands of sigma "
                f"{HOUGH_BAND_WIDTH} x 2 theta_B): PC error max "
                f"{err.max():.5f} (limit {HOUGH_PC_MAX_ERR}), mean {err.mean():.5f}; {t_small:.1f} ms")

    start = np.asarray(PC) + np.asarray(PC_OFFSET)
    bad = kt.EBSD(pre.data, detector=dataclasses.replace(det, pc=start), device=dev)
    n = pre.navigation_size
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det_scan = bad.hough_indexing_optimize_pc(batch=True, phase_list=ni_phase(), n_bands=HOUGH_BANDS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    e_start = float(np.linalg.norm(start - np.asarray(PC)))
    e = np.linalg.norm(np.asarray(det_scan.pc).reshape(n, 3) - np.asarray(PC), axis=1)
    if not e.mean() < e_start:
        raise AssertionError(f"[hough-pc] scan: mean PC error {e.mean():.5f} not below the start's {e_start:.5f}")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bad.hough_indexing_optimize_pc(batch=True, phase_list=ni_phase(), n_bands=HOUGH_BANDS)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, events = device_busy(prof)
    msgs.append(f"{smi}: the main path's {n} patterns from the PC off by {PC_OFFSET} (error {e_start:.5f}): PC error "
                f"mean {e.mean():.5f}, median {np.median(e):.5f}, mean PC "
                f"{np.round(np.asarray(det_scan.pc).reshape(n, 3).mean(axis=0), 5).tolist()} (truth {PC}); calls "
                f"{', '.join(f'{t:.0f}' for t in times)} ms ({n / np.median(times) * 1e3:.0f} patterns/s); under "
                f"torch.profiler wall {wall:.0f} ms, device busy {busy:.1f} ms ({busy / wall:.1%}): "
                + "; ".join(f"{k[:40]} x{c} {t:.2f} ms" for k, c, t in events[:5]))
    return msgs


def calibration_phase(smi: str, mp, det, pre, xmap, refined_pc) -> tuple[list[str], dict[str, int]]:
    """``[calibration]``: the main path's refined PCs (PC mode, one a point)
    through ``extrapolate_pc`` and ``fit_pc``, then ``get_patterns`` with the
    fitted PCs (one launch of kernel A, its first points against the CPU);
    ``merge_crystal_maps`` of the main path's map with a DI map against a
    coarser cubochoric dictionary tagged as a second phase (the merged phase
    is the per-point best mean score); the OSM of the main path's map
    against a direct count on sampled points. Returns the messages and the
    phase's kernel launches."""
    import torch

    from kikuchipy_tpu_torch.crystallography import sampling as ts
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase, PhaseList
    from kikuchipy_tpu_torch.indexing import merge_crystal_maps, orientation_similarity_map
    from kikuchipy_tpu_torch.signals.master_pattern import EBSDMasterPattern

    msgs = []
    nav = (SCAN_SIDE, SCAN_SIDE)
    idx = np.stack(np.indices(nav).astype(float))
    t0 = time.perf_counter()
    # A 192 um square map at 1.5 um steps on 70 um pixels binned 8 times:
    # the PC moves by about 3e-3 over it.
    ex = refined_pc.extrapolate_pc(idx.reshape(2, -1).T, nav, (1.5, 1.5), px_size=70.0, binning=8)
    scatter = refined_pc.pc.reshape(nav + (3,)) - refined_pc.pc_average
    noisy = dataclasses.replace(ex, pc=ex.pc + scatter)
    fit = noisy.fit_pc(idx, idx, transformation="projective")
    fit_aff = noisy.fit_pc(idx, idx, transformation="affine")
    t_fit = (time.perf_counter() - t0) * 1e3
    off = np.abs(fit.pc - ex.pc).max(axis=(0, 1))
    scatter_max = np.abs(scatter).max(axis=(0, 1))
    if fit.pc.shape != nav + (3,) or not np.isfinite(fit.pc).all() or (off > scatter_max).any():
        raise AssertionError(f"fit_pc: shape {fit.pc.shape}, off the extrapolated plane by {off.tolist()} (limit: the "
                             f"refined PCs' scatter {scatter_max.tolist()})")
    # The affine fit regresses each PC on the map indices, which the scatter
    # does not depend on; the projective fit takes its plane from the PC
    # cloud itself, so correlated scatter tilts it: its tilt is reported.
    if abs(fit_aff.sample_tilt - det.sample_tilt) > 1.0:
        raise AssertionError(f"fit_pc's affine sample tilt {fit_aff.sample_tilt:.3f} deg, the detector's "
                             f"{det.sample_tilt}")
    corr = np.corrcoef(scatter.reshape(-1, 3).T)
    msgs.append(f"extrapolate_pc from the PC mode's {refined_pc.navigation_size} refined PCs (mean "
                f"{np.round(refined_pc.pc_average, 6).tolist()}) over the {nav} map at 1.5 um steps (70 um pixels, "
                f"binning 8; PC range {np.round(np.ptp(ex.pc.reshape(-1, 3), axis=0), 6).tolist()}), plus the refined "
                f"PCs' scatter (max {np.round(scatter_max, 6).tolist()}), fit_pc projective / affine: fitted plane "
                f"within {np.round(off, 7).tolist()} of the extrapolated one (limit: the scatter), sample tilt "
                f"{fit.sample_tilt:.4f} / {fit_aff.sample_tilt:.4f} deg (limit on the affine fit's: {det.sample_tilt} "
                f"+- 1; the scatter's correlations x-y {corr[0, 1]:.3f}, x-z {corr[0, 2]:.3f}, y-z {corr[1, 2]:.3f}), "
                f"{t_fit:.1f} ms on the host")

    reset_launches()
    rot = xmap.best_rotations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = mp.get_patterns(rot, fit, dtype_out=np.uint8, chunk_size=8192)
    torch.cuda.synchronize()
    t_proj = (time.perf_counter() - t0) * 1e3
    counts = read_launches()
    if counts["lambert_project"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"get_patterns with one PC a point was not one launch of kernel A alone: {counts}")
    launches = dict(counts)
    k = CALIBRATION_CPU_POINTS
    cpu_mp = EBSDMasterPattern(mp.data, phase=mp.phase, device="cpu")
    cpu_det = dataclasses.replace(fit, pc=fit.pc.reshape(-1, 3)[:k])
    ref = cpu_mp.get_patterns(rot[:k], cpu_det, dtype_out=np.uint8, chunk_size=64).data.numpy()
    got = sim.data.reshape(-1, *DETECTOR_SHAPE)[:k].cpu().numpy()
    gray = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    if gray.max() > 1 or (gray > 0).mean() > GRAY_SHARE:
        raise AssertionError(f"get_patterns with the fitted PCs: {gray.max()} gray off the CPU's on "
                             f"{(gray > 0).mean():.4%} of {k} patterns' pixels")
    msgs.append(f"{smi}: get_patterns({rot.shape[0]} rotations, the fitted detector's {fit.navigation_size} PCs, uint8): "
                f"one launch of kernel A, {t_proj:.1f} ms; its first {k} patterns within {gray.max()} gray of the "
                f"CPU's plain projection on {(gray > 0).mean():.4%} of the pixels (limit: 1 on {GRAY_SHARE:.0%})")

    # A second phase: DI against a coarser cubochoric dictionary.
    reset_launches()
    t0 = time.perf_counter()
    coarse_rot = ts.get_sample_fundamental(COARSE_RESOLUTION_DEG, "m-3m")
    coarse_mp = dataclasses.replace(mp, phase=Phase(name="ni-coarse", point_group="m-3m"))
    coarse = coarse_mp.get_patterns(coarse_rot, det, chunk_size=8192)
    xmap2 = pre.dictionary_indexing(coarse, keep_n=KEEP_N, precision="pallas-int8")
    torch.cuda.synchronize()
    t_second = (time.perf_counter() - t0) * 1e3
    second = read_launches()
    launches = {k: v + second[k] for k, v in launches.items()}
    t0 = time.perf_counter()
    merged = merge_crystal_maps([xmap, xmap2], mean_n_best=3)
    t_merge = (time.perf_counter() - t0) * 1e3
    means = np.stack([x.prop["scores"][:, :3].astype(np.float64).sum(axis=1) / 3 for x in (xmap, xmap2)], axis=1)
    want = np.argmax(means, axis=1)
    if not np.array_equal(merged.phase_id, want) or list(merged.phases.names) != [xmap.phases[0].name, "ni-coarse"]:
        raise AssertionError(f"merge: phase ids differ from the per-point best mean score on "
                             f"{int((merged.phase_id != want).sum())} points; phases {merged.phases.names}")
    win = np.where(want[:, None] == 0, xmap.prop["scores"], xmap2.prop["scores"])
    if not np.array_equal(merged.prop["scores"], win):
        raise AssertionError("merge: the merged scores are not the winning map's")
    msgs.append(f"merge_crystal_maps(main path map, DI against get_sample_fundamental({COARSE_RESOLUTION_DEG}) = "
                f"{coarse_rot.shape[0]} orientations tagged 'ni-coarse'; mean_n_best=3): phase ids equal the per-point "
                f"best mean score on all {want.size} points ({int((want == 0).sum())} main, {int((want == 1).sum())} "
                f"coarse), scores the winner's; the second map {t_second:.1f} ms (sampling, projection, DI: launches "
                f"{ {k: v for k, v in second.items() if v} }), the merge {t_merge:.1f} ms on the host")

    # The main path's scan has no grains (neighbouring truths are unrelated),
    # so its OSM is near 0; a map of 8 x 8-point grains takes each block's
    # first point's list for the whole block.
    sims = xmap.prop["simulation_indices"].reshape(nav + (KEEP_N,))
    g = 8
    grains = dataclasses.replace(xmap, prop={"simulation_indices": np.repeat(np.repeat(
        sims[::g, ::g], g, axis=0), g, axis=1).reshape(-1, KEEP_N)})
    pts = np.random.default_rng(5).integers(0, SCAN_SIDE, size=(64, 2))
    for label, cmap in (("main path map", xmap), ("8 x 8 grains", grains)):
        t0 = time.perf_counter()
        osm = orientation_similarity_map(cmap)
        t_osm = (time.perf_counter() - t0) * 1e3
        lists = cmap.prop["simulation_indices"].reshape(nav + (KEEP_N,))
        for y, x in pts:
            nbr = [(y + dy, x + dx) for dy, dx in ((-1, 0), (0, -1), (0, 1), (1, 0))
                   if 0 <= y + dy < SCAN_SIDE and 0 <= x + dx < SCAN_SIDE]
            direct = np.mean([len(set(lists[y, x]) & set(lists[a, b])) for a, b in nbr])
            if np.float32(direct) != osm[y, x]:
                raise AssertionError(f"OSM of the {label} at ({y}, {x}): {osm[y, x]} against the direct count {direct}")
        extra = ""
        if cmap is grains:
            yy, xx = np.indices(nav)
            inner = (((yy % g) != 0) | (yy == 0)) & (((yy % g) != g - 1) | (yy == SCAN_SIDE - 1)) & (
                ((xx % g) != 0) | (xx == 0)) & (((xx % g) != g - 1) | (xx == SCAN_SIDE - 1))
            if not (osm[inner] == KEEP_N).all():
                raise AssertionError(f"OSM of the grains is not {KEEP_N} inside them: min {osm[inner].min()}")
            extra = f", {KEEP_N} at all {int(inner.sum())} points whose neighbours are in their grain"
        msgs.append(f"orientation_similarity_map({label}, n_best {KEEP_N}): {osm.shape} float32, mean "
                    f"{float(osm.mean()):.3f}, min {float(osm.min()):.3f}, max {float(osm.max()):.3f}, equal to a "
                    f"direct set count at 64 sampled points{extra}; {t_osm:.1f} ms on the host")
    return msgs, launches



# ----------------------- reading files, lazy scans ----------------------- #

# [io]: the main path's scan tiled IO_TILES x IO_TILES on the map (256 x 256
# patterns of 60 x 60, 236 MB, about BASELINE config 3's nickel_ebsd_large).
IO_TILES = 2
# [lazy]: the chunk sizes of the lazy removals, the streamed indexing's and
# refinement's chunks, and the points refined.
LAZY_CHUNKS = (1024, 8192)
LAZY_DI_CHUNK = 2048
LAZY_REFINE_POINTS = 2048
LAZY_REFINE_CHUNK = 1024
# Streamed refinement against the eager call: rotations within this
# (tests/test_lazy.py's tolerance).
LAZY_REFINE_ATOL = 1e-5


def _write_ebsp_v5(path, patterns: np.ndarray, nx: int, seed: int) -> None:
    """An Oxford .ebsp, version 5: map_x/map_y in each header, the records out
    of map order (the first stays first, as the format's reader needs)."""
    import struct

    n, sy, sx = patterns.shape
    order = np.concatenate([[0], 1 + np.random.default_rng(seed).permutation(n - 1)])
    bytes_per = 6 * 4 + sy * sx + 1 + 8 + 1 + 8
    first = 9 + n * 8
    starts = np.zeros(n, np.int64)
    starts[order] = first + np.arange(n) * bytes_per
    rec = np.zeros(n, dtype=np.dtype([("hdr", "<i4", 6), ("pattern", "u1", (sy, sx)), ("hx", "?"),
                                       ("bx", "<f8"), ("hy", "?"), ("by", "<f8")]))
    my, mx = np.divmod(order, nx)
    rec["hdr"] = np.stack([mx, my, np.zeros(n), np.full(n, sy), np.full(n, sx), np.full(n, sy * sx)], 1)
    rec["pattern"] = patterns[order]
    rec["hx"] = rec["hy"] = True
    rec["bx"], rec["by"] = mx * 1.5, my * 1.5
    with open(path, "wb") as f:
        f.write(struct.pack("<q", -5) + b"\x00")
        starts.tofile(f)
        rec.tofile(f)


def _write_up2(path, patterns: np.ndarray) -> None:
    """An EDAX .up2, version 3: uint16 patterns on a square grid."""
    ny, nx, sy, sx = patterns.shape
    with open(path, "wb") as f:
        np.array([3, sx, sy, 42], np.uint32).tofile(f)
        f.write(b"\x00")
        np.array([nx, ny], np.uint32).tofile(f)
        np.array([0], np.uint8).tofile(f)
        np.array([1.5, 1.5], np.float64).tofile(f)
        patterns.tofile(f)


def io_phase(dev, scan, smi: str, folder: Path, seed: int) -> tuple[list[str], Path]:
    """[io]: ``save`` the tiled scan to a NORDIF .dat and ``load`` it eagerly
    onto the card (bytes equal, host seconds, MB/s; the file was just written,
    so the read is warm); a synthesized EDAX .up2 (uint16) and Oxford .ebsp
    (version 5, out of order) to the card, bytes equal; a kikuchipy h5ebsd
    round trip where h5py imports. Returns the messages and the .dat's path."""
    import importlib.util
    import warnings

    import torch

    import kikuchipy_tpu_torch as kt

    msgs = []
    tiled = scan.data.repeat(IO_TILES, IO_TILES, 1, 1)
    mb = tiled.numel() / 1e6
    ny, nx, sy, sx = tiled.shape
    path = folder / "Pattern.dat"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kt.EBSD(tiled, device=dev).save(path)
    t_save = time.perf_counter() - t0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no Setting.txt or background beside the file: sizes given
        t0 = time.perf_counter()
        loaded = kt.load(path, scan_size=(nx, ny), pattern_size=(sx, sy), device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    if loaded.data.device.type != dev.type or not torch.equal(loaded.data, tiled):
        raise AssertionError("the .dat loaded to the card is not the bytes saved")
    msgs.append(f"{smi}: save ({nx} x {ny} x {sx} x {sy} uint8, {mb:.1f} MB) to a NORDIF .dat {t_save:.3f} s "
                f"({mb / t_save:.1f} MB/s, the tensor copied to the host); load to the card {t_load:.3f} s "
                f"({mb / t_load:.1f} MB/s, host clock, the file's pages warm): bytes equal")

    up2_np = np.random.default_rng(seed).integers(0, 1 << 16, (32, 32, sy, sx), dtype=np.uint16)
    _write_up2(folder / "scan.up2", up2_np)
    ebsp_np = scan.data[:32, :32].cpu().numpy()
    _write_ebsp_v5(folder / "scan.ebsp", ebsp_np.reshape(-1, sy, sx), ebsp_np.shape[1], seed)
    for name, want in (("scan.up2", up2_np), ("scan.ebsp", ebsp_np)):
        t0 = time.perf_counter()
        got = kt.load(folder / name, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if got.data.device.type != dev.type or not np.array_equal(got.data.cpu().numpy(), want):
            raise AssertionError(f"{name} loaded to the card is not the bytes written")
        msgs.append(f"{name} ({want.dtype}, {want.shape}) to the card {dt * 1e3:.1f} ms: bytes equal")

    if importlib.util.find_spec("h5py") is None:
        msgs.append("h5py does not import on this machine: the kikuchipy h5ebsd round trip was not run")
    else:
        sig = kt.EBSD(scan.data, detector=scan.detector, static_background=scan.static_background, device=dev)
        sig.save(folder / "scan.h5")
        back = kt.load(folder / "scan.h5", device=dev)
        if not (torch.equal(back.data, sig.data) and np.array_equal(back.static_background, scan.static_background)
                and np.allclose(back.detector.pc, scan.detector.pc, rtol=0, atol=1e-12)):
            raise AssertionError("the kikuchipy h5ebsd round trip changed the scan")
        msgs.append("h5py imports on this machine: kikuchipy h5ebsd round trip of the scan, bytes, background and PC "
                    "equal")
    return msgs, path


def _peak_mb(fn):
    """``fn()``'s result, its host ms (synchronized) and the device memory
    allocated at its start and at its peak, in MB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated() / 1e6
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, start, torch.cuda.max_memory_allocated() / 1e6


def lazy_breakdown(dev, dat: Path, n: int, sy: int, sx: int) -> list[str]:
    """The lazy chain's stages apart at each of LAZY_CHUNKS: the host's copy
    of every chunk out of the memory map into a page-locked buffer (the
    file's pages warm; ``staging.copy_rows``, as ``ChunkStager.put``), and
    every chunk's host-to-device copy from it (CUDA events)."""
    import torch

    from kikuchipy_tpu_torch.utils.staging import copy_rows

    src = np.memmap(dat, dtype=np.uint8, mode="r", shape=(n, sy, sx))
    out = []
    for chunk in LAZY_CHUNKS:
        pinned = torch.empty((chunk, sy, sx), dtype=torch.uint8, pin_memory=dev.type == "cuda")
        buf = torch.empty((chunk, sy, sx), dtype=torch.uint8, device=dev)
        t0 = time.perf_counter()
        for a in range(0, n, chunk):
            copy_rows(pinned[: min(chunk, n - a)].numpy(), src[a : a + chunk])
        host_ms = (time.perf_counter() - t0) * 1e3

        def h2d():
            for a in range(0, n, chunk):
                m = min(chunk, n - a)
                buf[:m].copy_(pinned[:m], non_blocking=True)

        h2d_ms = cuda_ms(h2d, 3)
        mb = n * sy * sx / 1e6
        out.append(f"chunk_size={chunk}: host copy out of the memory map {host_ms:.3f} ms ({mb / host_ms * 1e3:.1f} "
                   f"MB/s), host-to-device copies {h2d_ms:.3f} ms ({mb / h2d_ms * 1e3:.1f} MB/s)")
    return out


def lazy_phase(dev, scan, pre, dictionary, mp, det, top1_rot, smi: str, dat: Path, folder: Path) -> list[str]:
    """[lazy]: ``load(..., lazy=True)`` of [io]'s .dat, both removals and
    ``compute`` at each of LAZY_CHUNKS, byte for byte the eager chain's (kernel
    D); the chain with neighbour averaging's halo rows byte for byte the eager
    one (kernel G); streamed dictionary indexing of the main path's patterns
    against the eager call at the same precision ("int8": the JAX package's
    streamed path has no "pallas-int8"), indices equal and scores within 1e-6;
    streamed refinement of LAZY_REFINE_POINTS against the eager call within
    LAZY_REFINE_ATOL and bit for bit (the Nelder-Mead kernel refines each
    point on its own, so the chunking changes no point's path)."""
    import warnings

    import torch

    import kikuchipy_tpu_torch as kt

    msgs = []
    bg = scan.static_background
    ny, nx = scan.navigation_shape[0] * IO_TILES, scan.navigation_shape[1] * IO_TILES
    sy, sx = scan.signal_shape
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no Setting.txt or background beside the file: sizes given
        eager = dataclasses.replace(kt.load(dat, scan_size=(nx, ny), pattern_size=(sx, sy), device=dev),
                                    static_background=bg)
        lazy = kt.load(dat, scan_size=(nx, ny), pattern_size=(sx, sy), lazy=True, device=dev)
    lazy = dataclasses.replace(lazy, static_background=bg)
    mb = eager.data.numel() / 1e6

    def eager_chain():
        return eager.remove_static_background().remove_dynamic_background()

    eager_chain()  # warm-up
    want, ms_e, start_e, peak_e = _peak_mb(eager_chain)
    parts = [f"eager (the scan on the card) {ms_e:.3f} ms ({mb / ms_e * 1e3:.1f} MB/s), device memory {start_e:.1f} "
             f"MB at the start, peak {peak_e:.1f} MB"]
    for chunk in LAZY_CHUNKS:
        view = dataclasses.replace(lazy, chunk_size=chunk)
        view.remove_static_background().remove_dynamic_background().compute()  # warm-up
        got, ms, start, peak = _peak_mb(lambda: view.remove_static_background().remove_dynamic_background().compute())
        if not torch.equal(got.data, want.data):
            raise AssertionError(f"the lazy removals at chunk_size={chunk} are not the eager chain's bytes")
        parts.append(f"lazy from the memory map, chunk_size={chunk}: {ms:.3f} ms ({mb / ms * 1e3:.1f} MB/s), "
                     f"{start:.1f} MB at the start, peak {peak:.1f} MB; byte for byte")
        del got
    msgs.append(f"{smi}: load(lazy=True) -> remove_static_background().remove_dynamic_background().compute() on "
                f"{ny * nx} patterns ({mb:.1f} MB): " + "; ".join(parts))
    msgs.append(f"{smi}: what holds the lazy chain: " + "; ".join(lazy_breakdown(dev, dat, ny * nx, sy, sx)))

    want = eager.remove_static_background().average_neighbour_patterns()
    for chunk in LAZY_CHUNKS:
        got = dataclasses.replace(lazy, chunk_size=chunk).remove_static_background().average_neighbour_patterns()
        got, ms, _, peak = _peak_mb(got.compute)
        if not torch.equal(got.data, want.data):
            raise AssertionError(f"the lazy chain with halo rows at chunk_size={chunk} is not the eager bytes")
        msgs.append(f"{smi}: static removal + average_neighbour_patterns (halo rows, kernel G) lazily at "
                    f"chunk_size={chunk}: {ms:.3f} ms, peak {peak:.1f} MB; byte for byte the eager chain")
    del want, got, eager

    # The main path's scan, written to its own .dat, indexed a chunk at a time.
    main_dat = folder / "main.dat"
    kt.EBSD(scan.data, device=dev).save(main_dat)
    sny, snx = scan.navigation_shape
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main_lazy = kt.load(main_dat, scan_size=(snx, sny), pattern_size=(sx, sy), lazy=True, device=dev)
    main_lazy = dataclasses.replace(main_lazy, static_background=bg, chunk_size=LAZY_DI_CHUNK)
    eager_xmap, ms_e, _, peak_e = _peak_mb(lambda: pre.dictionary_indexing(dictionary, keep_n=KEEP_N, precision="int8"))
    lazy_xmap, ms_l, _, peak_l = _peak_mb(
        lambda: main_lazy.remove_static_background().remove_dynamic_background().dictionary_indexing(
            dictionary, keep_n=KEEP_N, precision="int8"))
    ei, li = eager_xmap.prop["simulation_indices"], lazy_xmap.prop["simulation_indices"]
    ds = float(np.abs(eager_xmap.prop["scores"] - lazy_xmap.prop["scores"]).max())
    if not np.array_equal(ei, li) or ds > 1e-6:
        raise AssertionError(f"streamed indexing differs from the eager call: {int((ei != li).sum())} indices, max "
                             f"|score diff| {ds:g}")
    msgs.append(f"{smi}: streamed dictionary_indexing (int8, keep_n={KEEP_N}) of the main path's {sny * snx} patterns "
                f"from a .dat, both removals lazily, chunk_size={LAZY_DI_CHUNK}, against {dictionary.navigation_size} "
                f"entries: {ms_l:.3f} ms, peak {peak_l:.1f} MB; the eager call {ms_e:.3f} ms, peak {peak_e:.1f} MB; "
                f"indices equal, max |score diff| {ds:g}")

    # Streamed refinement of the first rows' points from the DI top-1.
    rows = LAZY_REFINE_POINTS // snx
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        part = kt.load(main_dat, scan_size=(snx, rows), pattern_size=(sx, sy), lazy=True, device=dev)
    part = dataclasses.replace(part, static_background=bg, chunk_size=LAZY_REFINE_CHUNK)
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap

    sub_xmap = CrystalMap(rotations=top1_rot[: rows * snx], shape=(rows, snx))
    static_part = kt.EBSD(scan.inav[:, :rows].remove_static_background().data, detector=det, device=dev)
    eager_ref, ms_e, _, _ = _peak_mb(lambda: static_part.refine_orientation(xmap=sub_xmap, master_pattern=mp))
    lazy_ref, ms_l, _, _ = _peak_mb(lambda: part.remove_static_background().refine_orientation(
        xmap=sub_xmap, detector=det, master_pattern=mp))
    er, lr = eager_ref.xmap.best_rotations, lazy_ref.xmap.best_rotations
    dr = float(np.abs(er - lr).max())
    same = int((er == lr).all(axis=1).sum())
    if dr > LAZY_REFINE_ATOL or same != rows * snx:
        raise AssertionError(f"streamed refinement is {dr:g} from the eager call (limit {LAZY_REFINE_ATOL:g}), "
                             f"{same}/{rows * snx} points bit for bit (the kernel refines each point alone: all)")
    msgs.append(f"{smi}: streamed refine_orientation of {rows * snx} points (static removal lazily, "
                f"chunk_size={LAZY_REFINE_CHUNK}, the Nelder-Mead kernel a chunk) {ms_l:.3f} ms against the eager "
                f"call's {ms_e:.3f} ms: max |rotation diff| {dr:g}, {same}/{rows * snx} points bit for bit")
    return msgs


# ------------ the kinematical simulation, decomposition, VBSE, profiling ------------ #

# [simulation]: nickel's reflectors to 0.5 A at 20 kV (338 after allowed()),
# the master pattern at JAX's default size with both hemispheres, its rows
# held against a float64 recomputation (the band-edge rule), 4,096 noisy
# patterns indexed against its 2-degree dictionary.
SIM_DMIN = 0.5
SIM_HALF_SIZE = 500
SIM_CHECK_ROWS = 64
SIM_EDGE_SHARE = 0.005
SIM_PATTERNS = 4096
SIM_NOISE = 6.0
# Bytes a (pixel, reflector) pair moves through the band accumulation's
# PyTorch operations: the product's store (4), |d| (8) and its test (5), the
# clamp (8), acos (8), the two angle tests (5 + 5) and their and (3), the
# inner where (5), the outer where (9) and the sum's read (4).
SIM_BYTES_PER_PAIR = 64
# [decomposition]: the main path's patterns after both removals.
DECOMP_COMPONENTS = 10
SVD_DRIVERS = ("gesvd", "gesvdj", "gesvda")
DECOMP_ORTHO_TOL = 1e-4
DECOMP_RATIO_TOL = 1e-4
DECOMP_RESIDUAL_TOL = 1e-3
# [profiling]: the int8 kernel's name in a trace (the wgmma frame's top-k
# kernel on signed 8-bit operands).
INT8_KERNEL_SYMBOL = "topk_kernel<(anonymous namespace)::S8Op"


def nickel_reflectors(dmin: float):
    """Nickel's allowed reflectors to ``dmin`` A, with structure factors and
    Bragg angles at 20 kV (as the JAX package's tests build them)."""
    from kikuchipy_tpu_torch.crystallography.reciprocal import Lattice, ReciprocalLatticeVectors

    ref = ReciprocalLatticeVectors.from_min_dspacing(Lattice(*NI_LATTICE), dmin)
    ref.calculate_structure_factor(NI_ATOMS)
    ref.calculate_theta(20.0)
    return ref.allowed()


def band_rule_rows(data: np.ndarray, ref, rows) -> dict:
    """``rows`` of each hemisphere of a kinematical master pattern (``data``
    ``(2, size, size)``, linear scaling) against the float64 recomputation
    on the host from the same float32 inputs: the pixels checked, those the
    band-edge rule exempts, and those outside it off by more than float32's
    summation bound."""
    from kikuchipy_tpu_torch.simulation import kikuchi_pattern_simulator as tsim

    size = data.shape[-1]
    arr = np.linspace(-1, 1, size)
    X, Y = np.meshgrid(arr, arr[rows])
    unit, theta = ref.unit.astype(np.float32), ref.theta.astype(np.float32)
    inten = np.abs(ref.structure_factor).astype(np.float32)
    out = dict(pixels=0, uncertain=0, bad=0, max_excess=0.0)
    for h, pole in enumerate((-1, 1)):
        xyz = tsim._inverse_stereographic(X.ravel(), Y.ravel(), pole).astype(np.float32)
        want, uncertain = tsim._accumulate_bands_float64(xyz, unit, theta, inten)
        got = data[h][rows].ravel().astype(np.float64)
        excess = np.abs(got - want) - tsim._band_tolerance(want, ref.size)
        out["pixels"] += got.size
        out["uncertain"] += int(uncertain.sum())
        out["bad"] += int(((excess > 0) & ~uncertain).sum())
        out["max_excess"] = max(out["max_excess"], float(excess[~uncertain].max()))
    return out


def simulation_phase(dev, det, dict_rot, smi: str, seed: int) -> tuple[list[str], dict[str, int]]:
    """[simulation]: the kinematical path at full width on the card (see the
    docstring, item 10). Returns its lines and the kernels' launches of its
    indexing run."""
    import torch

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector, quad_texture
    from kikuchipy_tpu_torch.simulation import KikuchiPatternSimulator
    from kikuchipy_tpu_torch.simulation import kikuchi_pattern_simulator as tsim
    from kikuchipy_tpu_torch.utils.device import matmul_precision

    msgs = []
    t0 = time.perf_counter()
    ref = nickel_reflectors(SIM_DMIN)
    t_ref = (time.perf_counter() - t0) * 1e3
    sim = KikuchiPatternSimulator(ref, phase=ni_phase())
    mp, ms_mp, mem0, peak = _peak_mb(lambda: sim.calculate_master_pattern(half_size=SIM_HALF_SIZE, hemisphere="both"))
    _, ms_mp_warm, _, _ = _peak_mb(lambda: sim.calculate_master_pattern(half_size=SIM_HALF_SIZE, hemisphere="both"))
    size = 2 * SIM_HALF_SIZE + 1
    data = mp.data
    if data.shape != (2, size, size) or data.dtype != np.float32 or not np.isfinite(data).all():
        raise AssertionError(f"[simulation] bad master pattern: {data.shape} {data.dtype}")
    if not np.allclose(data[0], data[1], atol=1e-6 * float(data.max())):
        raise AssertionError("[simulation] the hemispheres of a centrosymmetric crystal differ")
    rows = np.unique(np.linspace(0, size - 1, SIM_CHECK_ROWS).round().astype(int))
    t0 = time.perf_counter()
    rule = band_rule_rows(data, ref, rows)
    t_rule = time.perf_counter() - t0
    share = rule["uncertain"] / rule["pixels"]
    if rule["bad"] or share >= SIM_EDGE_SHARE:
        raise AssertionError(f"[simulation] band-edge rule broken: {rule}, uncertain share {share:.5f}")
    # Where the band accumulation's time goes: one hemisphere, and at one
    # block's shape its product, acos and a copy pass (8 bytes a pair).
    arr = np.linspace(-1, 1, size)
    X, Y = np.meshgrid(arr, arr)
    xyz = torch.as_tensor(tsim._inverse_stereographic(X.ravel(), Y.ravel(), -1).astype(np.float32), device=dev)
    unit = torch.as_tensor(ref.unit.astype(np.float32), device=dev)
    theta = torch.as_tensor(ref.theta.astype(np.float32), device=dev)
    inten = torch.as_tensor(np.abs(ref.structure_factor).astype(np.float32), device=dev)
    ms_hemi = cuda_ms(lambda: tsim._accumulate_bands(xyz, unit, theta, inten), 3)
    block = tsim._BLOCK_ELEMENTS // ref.size
    with matmul_precision(False):
        d = xyz[:block] @ unit.T
        ms_prod = cuda_ms(lambda: xyz[:block] @ unit.T, 5)
    ms_acos = cuda_ms(lambda: torch.acos(d), 5)
    ms_copy = cuda_ms(lambda: torch.neg(d), 5)
    del d
    pairs = xyz.shape[0] * ref.size
    blocks = -(-xyz.shape[0] // block)
    bound_hemi = pairs * SIM_BYTES_PER_PAIR / PEAK_BYTES * 1e3
    msgs.append(
        f"{smi}: nickel to {SIM_DMIN} A at 20 kV: {ref.size} reflectors ({t_ref:.1f} ms on the host); "
        f"calculate_master_pattern(half_size={SIM_HALF_SIZE}, hemisphere='both') {ms_mp:.1f} ms, again "
        f"{ms_mp_warm:.1f} ms (host clock, synchronized; the grid on the host in float64), peak device memory {peak - mem0:.0f} MB above "
        f"{mem0:.0f} MB; one hemisphere's band accumulation {ms_hemi:.3f} ms ({xyz.shape[0]} pixels x {ref.size} "
        f"reflectors in {blocks} blocks of {block}; {SIM_BYTES_PER_PAIR} bytes a pair: {bound_hemi:.3f} ms at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s, {bound_hemi / ms_hemi:.1%} of it); at one block's shape ({block} x "
        f"{ref.size}): the IEEE float32 product {ms_prod:.4f} ms, acos {ms_acos:.4f} ms, a copy pass (neg) "
        f"{ms_copy:.4f} ms; {len(rows)} rows of each hemisphere against the float64 recomputation "
        f"({t_rule:.1f} s on the host): {rule['pixels']} pixels, {rule['uncertain']} within 1e-6 rad of a band "
        f"edge ({share:.4%}, limit {SIM_EDGE_SHARE:.1%}), {rule['bad']} off the others by more than float32's "
        f"summation bound (largest excess {rule['max_excess']:.3e})")

    # The kinematical master through as_lambert, kernel A and the int8 kernel.
    lam, ms_lam, _, _ = _peak_mb(lambda: mp.as_lambert())
    side = lam.data.shape[-1]
    master_np = lam._hemispheres_at_energy()
    quad = quad_texture(torch.as_tensor(master_np, device=dev))
    dc = direction_cosines_from_detector(det, device=dev)
    rng = np.random.default_rng(seed + 19)
    q = rng.normal(size=(SIM_PATTERNS, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rot = torch.as_tensor(q, dtype=torch.float32, device=dev)
    geo = (side, side, (side - 1) / 2)
    yard = Float64Yardstick()
    got, tap = lp.lambert_project(rot, dc, quad, *geo, taps=True)
    p32, t32 = lp.lambert_project_plain(rot, dc, quad, *geo, taps=True)
    p64, t64 = lp.lambert_project_plain(rot.double(), dc.double(), quad.double(), *geo, taps=True)
    yard.add("kinematical", got, tap, p32, t32, p64, t64, float(master_np.max() - master_np.min()))
    del p32, t32, p64, t64, tap
    if yard.failures():
        raise AssertionError(f"[simulation] kernel A on the kinematical master: {yard.failures()}")
    reset_launches()
    t0 = time.perf_counter()
    dictionary = lam.get_patterns(dict_rot, det, chunk_size=8192)
    exp = lam.get_patterns(q, det).data
    lo, hi = exp.amin(dim=(-2, -1), keepdim=True), exp.amax(dim=(-2, -1), keepdim=True)
    noise = torch.as_tensor(rng.standard_normal(exp.shape, dtype=np.float32) * SIM_NOISE, device=dev)
    u8 = ((exp - lo) / (hi - lo) * 200 + 28 + noise).round().clamp(0, 255).to(torch.uint8)
    signal = kt.EBSD(u8.reshape(64, 64, *det.shape), detector=det, device=dev)
    xmap = signal.dictionary_indexing(dictionary, keep_n=KEEP_N, precision="pallas-int8")
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    counts = read_launches()
    if counts["lambert_project"] != 2 or counts["ncc_match_topk_int8"] < 1:
        raise AssertionError(f"[simulation] kernel A not once a get_patterns, or no int8 launch: {counts}")
    ang = np.degrees(disorientation_angle(q, xmap.best_rotations, "m-3m"))
    med, frac8 = float(np.median(ang)), float((ang < 8).mean())
    if not (med < 3.0 and frac8 > 0.9):
        raise AssertionError(f"[simulation] orientations not recovered: median {med:.3f} deg, <8 deg {frac8:.4f}")
    t0 = time.perf_counter()
    geo_sim = sim.on_detector(det, q)
    ms_geo = (time.perf_counter() - t0) * 1e3
    lines = geo_sim.lines_coordinates(0)
    if geo_sim.lines.in_pattern.shape[0] != SIM_PATTERNS or lines.shape[0] < 3 or not np.isfinite(lines).all():
        raise AssertionError(f"[simulation] on_detector: {geo_sim!r}, {lines.shape[0]} lines in pattern 0")
    msgs.append(
        f"{smi}: as_lambert {ms_lam:.1f} ms ({side} x {side}, quad texture {quad.shape[0]} x 4); kernel A on it "
        f"against the float64 twin ({SIM_PATTERNS} rotations): {yard.summary(yard.cases['kinematical'])}; the "
        f"2-degree dictionary ({dict_rot.shape[0]}) and {SIM_PATTERNS} patterns (sigma-{SIM_NOISE:g} noise, uint8) "
        f"by kernel A (launches {counts['lambert_project']}), dictionary_indexing(pallas-int8, keep_n={KEEP_N}) "
        f"(ncc_topk_int8 launches {counts['ncc_match_topk_int8']}): disorientation median {med:.4f} deg, <8 deg "
        f"{frac8:.4f}; the three {t_index * 1e3:.1f} ms; on_detector({SIM_PATTERNS} orientations) {ms_geo:.1f} ms "
        f"on the host: {geo_sim!r}")
    return msgs, counts


def decomposition_phase(dev, pre, smi: str) -> list[str]:
    """[decomposition]: the SVD drivers, then ``EBSD.decomposition`` and
    ``get_decomposition_model`` on the main path's patterns (see the
    docstring, item 10)."""
    import torch

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.ops import decomposition as dec
    from kikuchipy_tpu_torch.utils.device import matmul_precision

    k = DECOMP_COMPONENTS
    n = pre.navigation_size
    x = pre.data.reshape(n, -1).to(torch.float32)
    # The float64 reference on the host: the centered matrix's Gram matrix
    # and its eigendecomposition (the right singular vectors and the squared
    # singular values).
    t0 = time.perf_counter()
    x64 = x.cpu().numpy().astype(np.float64)
    mean64 = x64.mean(axis=0)
    xc64 = x64 - mean64
    w, v = np.linalg.eigh(xc64.T @ xc64)
    w, v = w[::-1], v[:, ::-1]
    ratio64 = (w / w.sum())[:k]
    total64 = float(np.sum(xc64 * xc64))
    res64 = float(np.sqrt(max(total64 - float(w[:k].sum()), 0.0)))
    t_ref = time.perf_counter() - t0

    xc = x - x.mean(dim=0)
    drivers = []
    for driver in SVD_DRIVERS:
        torch.linalg.svd(xc[:512], full_matrices=False, driver=driver)  # the handle and workspace
        ms = cuda_ms(lambda: torch.linalg.svd(xc, full_matrices=False, driver=driver), 1)
        u, s, vt = torch.linalg.svd(xc, full_matrices=False, driver=driver)
        s64 = s.double().cpu().numpy()
        ratio = (s64**2 / np.sum(s64**2))[:k]
        f = vt[:k].double()
        ortho = float((f @ f.T - torch.eye(k, dtype=torch.float64, device=dev)).abs().max())
        with matmul_precision(False):
            res = float((xc - (u[:, :k] * s[:k]) @ vt[:k]).double().norm())
        drivers.append((driver, ms, float(np.abs(ratio - ratio64).max()), ortho, abs(res - res64) / res64))
        del u, s, vt
    del xc
    signal = kt.EBSD(pre.data, device=dev)
    _, ms_dec, mem0, peak_dec = _peak_mb(lambda: signal.decomposition(output_dimension=k))
    lr = signal.learning_results
    model, ms_model, _, peak_model = _peak_mb(lambda: signal.get_decomposition_model(k))
    factors = torch.as_tensor(lr.factors, dtype=torch.float64)
    ortho = float((factors @ factors.T - torch.eye(k, dtype=torch.float64)).abs().max())
    ratio_err = float(np.abs(lr.explained_variance_ratio - ratio64).max())
    f32 = torch.as_tensor(lr.factors, device=dev)
    with matmul_precision(False):
        recon = torch.as_tensor(lr.loadings, device=dev) @ f32 + torch.as_tensor(lr.mean, device=dev)
    res32 = float((x - recon).double().norm())
    res_err = abs(res32 - res64) / res64
    del recon
    # The float64 model rescaled as the port rescales (per pattern to
    # 0-255, truncated).
    v10 = v[:, :k]
    model64 = (xc64 @ v10) @ v10.T + mean64
    lo, hi = model64.min(axis=1, keepdims=True), model64.max(axis=1, keepdims=True)
    model64 = ((model64 - lo) / (hi - lo) * 255).astype(np.uint8)
    got = model.data.reshape(n, -1).cpu().numpy()
    gray = np.abs(got.astype(np.int16) - model64.astype(np.int16))
    gray_max, gray_share = int(gray.max()), float((gray > 0).mean())
    log("decomposition",
        f"{smi}: torch.linalg.svd of the centered {n} x {x.shape[1]} float32 matrix by cuSOLVER driver (one call, "
        f"CUDA events; ratios of the first {k} off float64's, factors' orthonormality, rank-{k} residual off "
        f"float64's, relative): "
        + "; ".join(f"{d} {ms:.1f} ms ({r:.2e}, {o:.2e}, {e:.2e})" for d, ms, r, o, e in drivers)
        + f"; kept {dec.SVD_DRIVER!r}; the float64 reference on the host {t_ref:.1f} s (Gram matrix and eigh)")
    fails = []
    if ortho > DECOMP_ORTHO_TOL:
        fails.append(f"factors orthonormal to {ortho:.2e}")
    if ratio_err > DECOMP_RATIO_TOL:
        fails.append(f"explained-variance ratios {ratio_err:.2e} off float64's")
    if res_err > DECOMP_RESIDUAL_TOL:
        fails.append(f"residual {res32:.6g} against float64's {res64:.6g} ({res_err:.2e})")
    if gray_max > 1 or gray_share > GRAY_SHARE:
        fails.append(f"uint8 model {gray_max} gray off on {gray_share:.4%} of the pixels")
    if model.data.dtype != torch.uint8 or tuple(model.data.shape) != tuple(pre.data.shape):
        fails.append(f"model {model.data.dtype} {tuple(model.data.shape)}")
    if dec.SVD_DRIVER not in SVD_DRIVERS:
        fails.append(f"SVD_DRIVER {dec.SVD_DRIVER!r}")
    if fails:
        raise AssertionError("[decomposition] " + "; ".join(fails))
    return [
        f"{smi}: EBSD.decomposition(output_dimension={k}) {ms_dec:.1f} ms (host clock, synchronized), peak "
        f"{peak_dec - mem0:.0f} MB above {mem0:.0f} MB; get_decomposition_model({k}) {ms_model:.1f} ms, peak "
        f"{peak_model - mem0:.0f} MB above the start; factors orthonormal to {ortho:.2e} (limit "
        f"{DECOMP_ORTHO_TOL:g}); explained-variance ratios {ratio_err:.2e} off float64's (limit "
        f"{DECOMP_RATIO_TOL:g}; the first {k} sum to {float(lr.explained_variance_ratio.sum()):.4f}); residual "
        f"{res32:.6g} against float64's {res64:.6g}, {res_err:.2e} relative (limit {DECOMP_RESIDUAL_TOL:g}); the "
        f"uint8 model off the float64 model by at most {gray_max} gray on {gray_share:.4%} of the pixels (limit "
        f"1 on {GRAY_SHARE:.0%})",
    ]


def vbse_phase(dev, scan, smi: str) -> list[str]:
    """[vbse]: every 5 x 5 tile's sums of the 128 x 128 scan on the card, bit
    for bit a host NumPy sum, and an RGB image of three tiles equal to the
    host's."""
    from kikuchipy_tpu_torch.imaging.vbse import VirtualBSEImager, get_rgb_image

    imager = VirtualBSEImager(scan)
    images = imager.get_images_from_grid()
    ms_grid = cuda_ms(imager.get_images_from_grid, 5)
    host = scan.data.cpu().numpy()
    gy, gx = imager.grid_shape
    sy, sx = scan.signal_shape
    ty, tx = sy // gy, sx // gx
    nav = scan.navigation_shape
    want = host[..., : gy * ty, : gx * tx].astype(np.float64).reshape(nav + (gy, ty, gx, tx)).sum(axis=(-3, -1))
    want = np.moveaxis(want, (-2, -1), (0, 1)).astype(np.float32)
    if images.shape != want.shape or images.tobytes() != want.tobytes():
        raise AssertionError(f"[vbse] grid images differ from the host's: {images.shape} {want.shape}")
    tiles = ((0, 0), (2, 2), (4, 4))
    rgb = imager.get_rgb_image(*tiles)
    ms_rgb = cuda_ms(lambda: imager.get_rgb_image(*tiles), 5)
    rgb_host = get_rgb_image([want[r, c].astype(np.float64) for r, c in tiles])
    if rgb.tobytes() != rgb_host.tobytes():
        raise AssertionError("[vbse] the RGB image differs from the host's")
    roi = (7, 41, 3, 58)
    one = scan.get_virtual_bse_intensity(roi)
    if one.tobytes() != host[..., 7:41, 3:58].astype(np.float64).sum(axis=(-2, -1)).astype(np.float32).tobytes():
        raise AssertionError("[vbse] EBSD.get_virtual_bse_intensity differs from the host's sum")
    return [f"{smi}: VirtualBSEImager.get_images_from_grid() on the {nav} scan of {scan.signal_shape} uint8 "
            f"patterns: {gy} x {gx} tiles in one pass {ms_grid:.3f} ms (with the copy to the host), bit for bit the "
            f"host's NumPy sum; get_rgb_image of tiles {tiles} {ms_rgb:.3f} ms, equal to the host's; "
            f"EBSD.get_virtual_bse_intensity({roi}) equal to the host's"]


PROFILING_TIMEOUT_S = 300


def profiling_trace(log_dir: Path, seed: int) -> int:
    """The capture of [profiling], run as ``chip_smoke.py --profiling-trace
    DIR``: the main path's inputs from ``seed``, one untraced pallas-int8
    indexing call (it loads the kernels), then ``trace(DIR)`` around a
    second. Prints the traced call's wall ms as JSON."""
    import torch

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.crystallography.sampling import (
        reduce_to_fundamental_zone,
        sample_fundamental_zone,
        super_fibonacci,
    )
    from kikuchipy_tpu_torch.utils.profiling import trace

    dev = torch.device("cuda")
    mp = kt.EBSDMasterPattern(master_pattern_data(), phase=Phase(name="ni", point_group="m-3m"), device=dev)
    det = kt.EBSDDetector(shape=DETECTOR_SHAPE, pc=PC, sample_tilt=70)
    n_scan = SCAN_SIDE * SCAN_SIDE
    truth = reduce_to_fundamental_zone(super_fibonacci(n_scan * 7)[::7][:n_scan], "m-3m")
    scan_u8, static_bg = scan_data(mp, det, truth, seed, chunk_size=8192)
    scan = kt.EBSD(scan_u8.reshape(SCAN_SIDE, SCAN_SIDE, *DETECTOR_SHAPE), detector=det,
                   static_background=static_bg, device=dev)
    pre = scan.remove_static_background().remove_dynamic_background()
    dictionary = mp.get_patterns(sample_fundamental_zone(RESOLUTION_DEG, "m-3m"), det, chunk_size=8192)
    pre.dictionary_indexing(dictionary, keep_n=KEEP_N, precision="pallas-int8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(str(log_dir)):
        pre.dictionary_indexing(dictionary, keep_n=KEEP_N, precision="pallas-int8")
    print(json.dumps({"wall_ms": (time.perf_counter() - t0) * 1e3}), flush=True)
    return 0


def profiling_phase(smi: str, folder: Path, seed: int) -> list[str]:
    """[profiling]: ``utils/profiling.py`` ``trace`` around one pallas-int8
    indexing call of the main path; the trace file must name the int8
    kernel. The capture runs in a process of its own (``profiling_trace``):
    on the H100, after the dozens of ``torch.profiler`` captures that come
    before it in this process, CUPTI has left the port's kernels out of a
    capture while it kept PyTorch's (once in three whole runs), so this check
    reads a capture that is its process's first."""
    import torch

    torch.cuda.empty_cache()  # the child shares the card
    log_dir = folder / "trace"
    here = Path(__file__).resolve()
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, str(here), "--seed", str(seed), "--profiling-trace", str(log_dir)],
                              capture_output=True, text=True, cwd=here.parent, timeout=PROFILING_TIMEOUT_S)
    except subprocess.TimeoutExpired as err:
        raise AssertionError(f"[profiling] the tracing process ran past {PROFILING_TIMEOUT_S} s") from err
    process_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[profiling] the tracing process exited {proc.returncode}: {proc.stderr[-2000:]}")
    wall = json.loads(proc.stdout.strip().splitlines()[-1])["wall_ms"]
    files = sorted(log_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"[profiling] trace wrote {len(files)} trace files")
    text = files[0].read_text()
    if INT8_KERNEL_SYMBOL not in text:
        raise AssertionError(f"[profiling] the trace does not name the int8 kernel ({INT8_KERNEL_SYMBOL})")
    return [f"{smi}: trace() around one pallas-int8 call (a process of its own, {process_s:.1f} s with its inputs "
            f"and an untraced call): {wall:.1f} ms with tracing and the export, "
            f"{files[0].name} {files[0].stat().st_size / 1e6:.1f} MB, names {INT8_KERNEL_SYMBOL}... "
            f"{text.count(INT8_KERNEL_SYMBOL)} times"]


# ------------ scale-out: meshes, processes, streaming, the host loader ------------ #

# [parallel]: the sharded DI meshes (all on the one card), the rows of the
# "highest" check, the fused path's mesh, the refinement mesh.
PARALLEL_MESHES = ((1, 1), (2, 2), (1, 4))
PARALLEL_HIGHEST_ROWS = 4096
PARALLEL_FUSED_MESH = (2, 2)
PARALLEL_FUSED_ROTATIONS = 107_008
PARALLEL_REFINE_MESH = (4, 1)
# [multihost]: two processes in a gloo group on the card, the map's first
# 16,383 points (an uneven split), each worker's time limit.
MULTIHOST_PROCESSES = 2
MULTIHOST_POINTS = 16_383
MULTIHOST_TIMEOUT_S = 300
MULTIHOST_DEVICES = 2  # mesh positions of the card a process: the dict axis of DI, the scan axis of refinement
MULTIHOST_WORKER = "tests/_torch_multihost_worker.py"  # the CPU test's worker too
# [streaming]: the main path's scan tiled 4x, read from a memory map.
STREAM_TILES = 4
STREAM_CHUNK = 4096
STREAM_CUT_AFTER = 3


def top1_gate(label: str, got_s, got_i, ref_s, ref_i, gap: float = NEAR_TIE_TOL,
              score_tol: float = NEAR_TIE_TOL) -> str:
    """Top-1 equal wherever the reference's top-1/top-2 gap exceeds
    ``gap`` (a shard's IEEE product may move a score's last bits), and every
    score within ``score_tol``; the rows below the gap are counted, not
    gated."""
    clear = (ref_s[:, 0] - ref_s[:, 1]) > gap
    agree = got_i[:, 0] == ref_i[:, 0]
    if got_i.shape != ref_i.shape or not agree[clear].all():
        raise AssertionError(f"{label}: top-1 differs on {int((~agree[clear]).sum())} rows with a gap > {gap:g} "
                             f"(shapes {got_i.shape}, {ref_i.shape})")
    diff = float(np.abs(got_s - ref_s).max())
    if not diff <= score_tol:
        raise AssertionError(f"{label}: max |score diff| {diff:g} > {score_tol:g}")
    return (f"{label}: top-1 equal on all {int(clear.sum())} rows with a top-1/top-2 gap > {gap:g} ({int((~clear).sum())} "
            f"below it, {int(agree[~clear].sum())} of them equal too); all {ref_i.shape[1]} indices equal on "
            f"{float((got_i == ref_i).all(axis=1).mean()):.4%} of the rows; max |score diff| {diff:.3g} "
            f"(limit {score_tol:g})")


def all_equal_gate(label: str, got_s, got_i, ref_s, ref_i, score_tol: float = 1e-6) -> str:
    """Every one of the ``keep_n`` indices equal and every score within
    ``score_tol``: "int8" selects on exact int32 sums, so the candidate sets
    are the single-device call's and only the rescore may round otherwise."""
    if got_i.shape != ref_i.shape or not np.array_equal(got_i, ref_i):
        rows = int((got_i != ref_i).any(axis=1).sum()) if got_i.shape == ref_i.shape else -1
        raise AssertionError(f"{label}: indices differ on {rows} rows (shapes {got_i.shape}, {ref_i.shape})")
    diff = float(np.abs(got_s - ref_s).max())
    if not diff <= score_tol:
        raise AssertionError(f"{label}: max |score diff| {diff:g} > {score_tol:g}")
    return (f"{label}: all {ref_i.shape[1]} indices equal on all {ref_i.shape[0]} rows; max |score diff| {diff:.3g} "
            f"(limit {score_tol:g})")


def _same_refinement(label: str, got, want) -> str:
    same = bool(np.array_equal(got.xmap.rotations, want.xmap.rotations)
                and np.array_equal(got.xmap.prop["scores"], want.xmap.prop["scores"])
                and np.array_equal(np.asarray(got.detector.pc), np.asarray(want.detector.pc)))
    if not same:
        dr = float(np.abs(got.xmap.rotations - want.xmap.rotations).max())
        raise AssertionError(f"{label}: not the single-device call bit for bit (max |rotation diff| {dr:g})")
    return f"{label}: rotations, scores and PCs bit for bit"


def parallel_phase(dev, pre, static, dictionary, dict_rot, mp, det, bad_det, xmap, refined_xmap, smi: str):
    """[parallel]: ``sharded_dictionary_index`` of the main path's patterns
    against its PreparedDictionary at "int8" on PARALLEL_MESHES of the one
    card and at "highest" on (2, 2), ``sharded_fused_dictionary_index`` on
    (2, 2) and (1, 1), and the three sharded refinements on (4, 1), each
    against the single-device call; returns the messages, kernel A's and
    the Nelder-Mead kernel's launches by call, and the PreparedDictionary."""
    import torch

    from kikuchipy_tpu_torch.indexing.di import dictionary_index, prepare_dictionary
    from kikuchipy_tpu_torch.parallel import (
        make_mesh,
        sharded_dictionary_index,
        sharded_fused_dictionary_index,
        sharded_refine_orientation,
        sharded_refine_orientation_projection_center,
        sharded_refine_projection_center,
    )
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector

    msgs, launches = [], {}
    n = pre.navigation_size
    rows = pre.data.reshape(n, -1)
    prep = prepare_dictionary(dictionary.data, quantize=True, device=dev)
    m = prep.n_dictionary

    def mesh(shape):
        return make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))

    def twice(fn):  # the first call grows the allocator's pool; the second is timed
        fn()
        return _peak_mb(fn)

    (ref, ms_ref, _, peak_ref) = twice(lambda: dictionary_index(rows, prep, keep_n=KEEP_N, precision="int8",
                                                                device=dev))
    parts = [f"single-device dictionary_index {ms_ref:.3f} ms, peak {peak_ref:.1f} MB"]
    for shape in PARALLEL_MESHES:
        (s, i), ms, _, peak = twice(lambda: sharded_dictionary_index(rows, prep, keep_n=KEEP_N, mesh=mesh(shape),
                                                                     precision="int8"))
        gate = all_equal_gate(f"mesh {shape}", s, i, ref.scores, ref.simulation_indices)
        parts.append(f"{gate}; {ms:.3f} ms, peak {peak:.1f} MB (dictionary padded by {(-m) % shape[1]})")
    msgs.append(f"{smi}: sharded_dictionary_index int8 keep_n={KEEP_N} of {n} patterns against the "
                f"{m}-entry PreparedDictionary, the shards on one card: " + "; ".join(parts))

    few = rows[:PARALLEL_HIGHEST_ROWS]
    (ref_h, ms_ref, _, _) = twice(lambda: dictionary_index(few, prep, keep_n=KEEP_N, precision="highest", device=dev))
    (s, i), ms, _, peak = twice(lambda: sharded_dictionary_index(few, prep, keep_n=KEEP_N, mesh=mesh((2, 2)),
                                                                 precision="highest"))
    msgs.append(f"{smi}: sharded_dictionary_index highest on (2, 2) for {len(few)} patterns: "
                + top1_gate("mesh (2, 2)", s, i, ref_h.scores, ref_h.simulation_indices)
                + f"; {ms:.3f} ms against the single-device call's {ms_ref:.3f} ms, peak {peak:.1f} MB")
    del ref_h

    # The fused path: each block projects its dict shard (kernel A) and
    # matches it in IEEE float32.
    rot = np.ascontiguousarray(dict_rot[:PARALLEL_FUSED_ROTATIONS], dtype=np.float32)
    master = mp._hemispheres_at_energy()
    side = master.shape[-1]
    dc = direction_cosines_from_detector(det, device=dev)
    fused = {}
    for shape in (PARALLEL_FUSED_MESH, (1, 1)):
        def call(shape=shape):
            return sharded_fused_dictionary_index(rows, rot, master, dc, side, side, (side - 1) / 2, keep_n=KEEP_N,
                                                  mesh=mesh(shape))
        call()
        reset_launches()
        fused[shape], ms, _, peak = _peak_mb(call)
        launches[f"parallel fused {shape}"] = read_launches()["lambert_project"]
        if launches[f"parallel fused {shape}"] != shape[0] * shape[1]:
            raise AssertionError(f"the fused path on {shape} launched kernel A "
                                 f"{launches[f'parallel fused {shape}']} times, not once a block")
        fused[shape] += (ms, peak)
    (ref_f, ms_ref, _, _) = twice(lambda: dictionary_index(rows, project_fn=mp.projector(det), rotations=rot,
                                                           keep_n=KEEP_N, precision="highest", device=dev))
    s, i, ms, peak = fused[PARALLEL_FUSED_MESH]
    s1, i1, ms1, peak1 = fused[(1, 1)]
    msgs.append(f"{smi}: sharded_fused_dictionary_index keep_n={KEEP_N} over {len(rot)} rotations, kernel A "
                f"launches {launches[f'parallel fused {PARALLEL_FUSED_MESH}']} on {PARALLEL_FUSED_MESH} and "
                f"{launches['parallel fused (1, 1)']} on (1, 1): "
                + top1_gate(f"{PARALLEL_FUSED_MESH} against (1, 1)", s, i, s1, i1) + "; "
                + top1_gate(f"{PARALLEL_FUSED_MESH} against dictionary_index(project_fn, highest)", s, i,
                            ref_f.scores, ref_f.simulation_indices)
                + f"; {ms:.3f} ms (peak {peak:.1f} MB), (1, 1) {ms1:.3f} ms (peak {peak1:.1f} MB), "
                f"dictionary_index(project_fn) {ms_ref:.3f} ms")
    del fused, ref_f

    calls = {"orientation": ("refine_orientation", sharded_refine_orientation, "nelder_mead_orientation",
                             dict(xmap=xmap)),
             "pc": ("refine_projection_center", sharded_refine_projection_center, "nelder_mead_projection_center",
                    dict(xmap=refined_xmap, detector=bad_det)),
             "joint": ("refine_orientation_projection_center", sharded_refine_orientation_projection_center,
                       "nelder_mead_orientation_projection_center", dict(xmap=xmap, detector=bad_det))}
    parts = []
    for mode, (name, sharded, wrapper, kw) in calls.items():
        want, ms_1, _, _ = _peak_mb(lambda: getattr(static, name)(master_pattern=mp, **kw))
        reset_launches()
        got, ms, _, _ = _peak_mb(lambda: sharded(static, mesh=mesh(PARALLEL_REFINE_MESH), master_pattern=mp, **kw))
        counts = read_launches()
        launches[f"parallel refine {mode}"] = counts[wrapper]
        if counts[wrapper] != PARALLEL_REFINE_MESH[0] or counts["lambert_project_ncc"]:
            raise AssertionError(f"sharded {name} launched {wrapper} {counts[wrapper]} times (not once a shard) and "
                                 f"kernel B {counts['lambert_project_ncc']} times")
        parts.append(_same_refinement(f"{mode} mode", got, want)
                     + f", {counts[wrapper]} launches of {wrapper}; {ms:.3f} ms against {ms_1:.3f} ms")
    msgs.append(f"{smi}: the sharded refinements (Nelder-Mead) of the {n}-point static-corrected map on "
                f"{PARALLEL_REFINE_MESH} of one card against the single-device calls: " + "; ".join(parts))
    torch.cuda.synchronize()
    return msgs, launches, prep


def multihost_phase(dev, dict_rot, mp, pre, static, dictionary, xmap, smi: str, folder: Path):
    """[multihost]: MULTIHOST_PROCESSES workers (MULTIHOST_WORKER) in a
    gloo group on the card, each on its host slice of MULTIHOST_POINTS
    patterns (an uneven split): each block's and the gathered DI
    (keep_n=KEEP_N; the match runs at "highest", as JAX's) and LM refinement
    against the single-process calls. Returns the messages and the workers'
    LM loop kernel launches."""
    import torch

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.parallel import multihost_dictionary_index, multihost_mesh, multihost_refine_orientation

    n = MULTIHOST_POINTS
    one = kt.EBSD(static.data.reshape((-1,) + tuple(static.signal_shape))[:n], detector=static.detector, device=dev)
    start = xmap.best_rotations[:n]
    t0 = time.perf_counter()
    ref_s, ref_i = multihost_dictionary_index(pre.data.reshape(pre.navigation_size, -1)[:n], dictionary.data,
                                              keep_n=KEEP_N, mesh=multihost_mesh(n_dict_local=2, devices=[dev] * 2),
                                              n_total=n, gather_results=True)
    torch.cuda.synchronize()
    t_di = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, ref_rot, ref_sc, _ = multihost_refine_orientation(one, xmap=CrystalMap(rotations=start, shape=(n,)),
                                                         detector=static.detector, master_pattern=mp, n_total=n,
                                                         gather_results=True, method="lm", devices=[dev])
    t_ref = time.perf_counter() - t0
    del one
    torch.cuda.empty_cache()  # the workers share the card

    from tests import _torch_multihost_worker as worker

    rows = static.signal_shape
    worker.write_inputs(folder, device=str(dev), n_devices=MULTIHOST_DEVICES, n_dict_local=MULTIHOST_DEVICES,
                        keep_n=KEEP_N, di_patterns=pre.data.reshape((-1,) + tuple(rows))[:n].cpu().numpy(),
                        dict_rot=dict_rot, master=mp._hemispheres_at_energy(), detector_shape=DETECTOR_SHAPE, pc=PC,
                        refine_scan=static.data.reshape((-1,) + tuple(rows))[:n].cpu().numpy(), start=start,
                        refine_kwargs={"method": "lm"})
    t0 = time.perf_counter()
    logs = worker.launch(folder, MULTIHOST_PROCESSES, MULTIHOST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for rank, (rc, out) in enumerate(logs):
        if rc != 0:
            raise AssertionError(f"multihost worker {rank} failed (exit {rc}):\n{out[-4000:]}")

    parts, lm_launches = [], {}
    for rank in range(MULTIHOST_PROCESSES):
        z = np.load(folder / f"out_{rank}.npz")
        sl, sl_r = slice(int(z["start"]), int(z["stop"])), slice(int(z["refine_start"]), int(z["refine_stop"]))
        block = top1_gate(f"process {rank}'s block", z["scores"], z["idx"], ref_s[sl], ref_i[sl])
        gate = top1_gate(f"process {rank}'s gathered copy", z["scores_all"], z["idx_all"], ref_s, ref_i)
        for what, rot, sc, want_rot, want_sc in (("block", z["rot"], z["refine_scores"], ref_rot[sl_r], ref_sc[sl_r]),
                                                 ("gathered copy", z["rot_all"], z["refine_scores_all"], ref_rot,
                                                  ref_sc)):
            if not (np.array_equal(rot, want_rot) and np.array_equal(sc, want_sc)):
                raise AssertionError(f"process {rank}'s LM refinement ({what}) is not the single-process call's: "
                                     f"max |rotation diff| {float(np.abs(rot - want_rot).max()):g}")
        lm_launches[f"multihost rank {rank}"] = int(z["lm_loop"])
        if int(z["lm_loop"]) != MULTIHOST_DEVICES or int(z["tangent"]):
            raise AssertionError(f"process {rank} launched the LM loop kernel {int(z['lm_loop'])} times and kernel C "
                                 f"{int(z['tangent'])} times ({MULTIHOST_DEVICES}, one a shard, and none expected)")
        parts.append(f"{block}; {gate}; LM refinement of the block and the gathered copy bit for bit; rows "
                     f"{sl.start}-{sl.stop}, gathered DI {float(z['t_di']) * 1e3:.1f} ms, refinement "
                     f"{float(z['t_refine']) * 1e3:.1f} ms, peak {float(z['peak_mb']):.1f} MB, LM loop kernel "
                     f"launches {int(z['lm_loop'])}")
    return [f"{smi}: {MULTIHOST_PROCESSES} processes of {MULTIHOST_WORKER} in a gloo group (loopback), both on this card "
            f"(NCCL takes no two ranks on one card), {n} points: " + "; ".join(parts)
            + f"; the single-process calls: DI {t_di * 1e3:.1f} ms, refinement {t_ref * 1e3:.1f} ms; the workers' "
            f"wall time {wall:.1f} s, start-up included"], lm_launches


def streaming_phase(dev, scan, dictionary, prep, smi: str, folder: Path) -> list[str]:
    """[streaming]: ``io.streaming._index_chunks`` over a memory map of the
    main path's scan tiled STREAM_TILES times (raw uint8), STREAM_CHUNK
    patterns a chunk, "int8": against ``LazyEBSD.dictionary_indexing`` and
    the eager call (indices equal), a run cut after STREAM_CUT_AFTER
    checkpointed chunks and resumed, and kernel D's static removal on the
    card against the same removal on the host. The HDF5 reader in front of
    the loop (h5py) is held by the CPU tests, not run here."""
    import torch

    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.indexing.di import dictionary_index
    from kikuchipy_tpu_torch.io.streaming import _index_chunks
    from kikuchipy_tpu_torch.ops.pattern import remove_static_background
    from kikuchipy_tpu_torch.signals.lazy import ArraySource, LazyEBSD

    sig = tuple(scan.signal_shape)
    raw = scan.data.reshape((-1,) + sig).cpu().numpy()
    n = raw.shape[0] * STREAM_TILES
    path = folder / "scan.u8"
    np.concatenate([raw] * STREAM_TILES).tofile(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r", shape=(n,) + sig)
    bg = np.asarray(scan.static_background)
    kw = dict(keep_n=KEEP_N, precision="int8", device=dev)

    def chunks(stop: int = n):
        for s in range(0, stop, STREAM_CHUNK):
            yield s, mm[s:s + STREAM_CHUNK]

    eager, ms_e, _, peak_e = _peak_mb(lambda: dictionary_index(torch.as_tensor(np.array(mm), device=dev), prep,
                                                               **kw))
    _index_chunks(chunks(2 * STREAM_CHUNK), prep, chunk_size=STREAM_CHUNK, **kw)  # warm-up
    got, ms, _, peak = _peak_mb(lambda: _index_chunks(chunks(), prep, chunk_size=STREAM_CHUNK, **kw))
    lazy = LazyEBSD(source=ArraySource(mm, (n,)), chunk_size=STREAM_CHUNK, device=dev)
    lazy_xmap, ms_l, _, _ = _peak_mb(lambda: lazy.dictionary_indexing(dictionary, keep_n=KEEP_N, precision="int8"))
    for label, (s, i) in (("the eager call", (eager.scores, eager.simulation_indices)),
                          ("LazyEBSD.dictionary_indexing", (lazy_xmap.prop["scores"],
                                                            lazy_xmap.prop["simulation_indices"]))):
        ds = float(np.abs(got.scores - s).max())
        if not np.array_equal(got.simulation_indices, i) or ds > 1e-6:
            raise AssertionError(f"_index_chunks differs from {label}: {int((got.simulation_indices != i).sum())} "
                                 f"indices, max |score diff| {ds:g}")
    msgs = [f"{smi}: _index_chunks (int8, keep_n={KEEP_N}) over a memory map of {n} raw patterns (the file's pages "
            f"warm), {STREAM_CHUNK} a chunk, against {prep.n_dictionary} entries: {ms:.3f} ms = "
            f"{n / ms * 1e3:.1f} patterns/s, peak {peak:.1f} MB; indices equal to the eager call's ({ms_e:.3f} ms, "
            f"peak {peak_e:.1f} MB) and LazyEBSD.dictionary_indexing's ({ms_l:.3f} ms), scores within 1e-6; the HDF5 "
            f"reader in front of the loop (stream_patterns, h5py) is not run in this phase: the CPU tests hold it"]

    ckpt = folder / "di.npz"

    def cut():
        for k, item in enumerate(chunks()):
            if k == STREAM_CUT_AFTER + 1:
                raise RuntimeError("cut")
            yield item

    try:
        _index_chunks(cut(), prep, chunk_size=STREAM_CHUNK, checkpoint_path=ckpt, **kw)
        raise AssertionError("the cut run did not stop")
    except RuntimeError as err:
        if str(err) != "cut":
            raise
    with np.load(ckpt) as z:
        kept = sorted(int(k.split("_")[1]) for k in z.files if k.startswith("scores_"))
    if kept != [k * STREAM_CHUNK for k in range(STREAM_CUT_AFTER)]:
        raise AssertionError(f"the cut run checkpointed chunks {kept}")
    resumed = _index_chunks(chunks(), prep, chunk_size=STREAM_CHUNK, checkpoint_path=ckpt, **kw)
    if not (np.array_equal(resumed.simulation_indices, got.simulation_indices)
            and np.array_equal(resumed.scores, got.scores)):
        raise AssertionError("the resumed run differs from the uninterrupted one")
    msgs.append(f"{smi}: a run cut after {STREAM_CUT_AFTER + 1} chunks kept {len(kept)} in its checkpoint (results "
                f"are read one chunk late) and the resumed run equals the uninterrupted one bit for bit")

    reset_launches()
    on_card, ms_d, _, _ = _peak_mb(lambda: _index_chunks(
        chunks(), prep, chunk_size=STREAM_CHUNK, preprocess_fn=lambda c: remove_static_background(c, bg, device=dev),
        preprocess_on_device=True, **kw))
    launches = read_launches()["remove_background[static]"]
    on_host, ms_h, _, _ = _peak_mb(lambda: _index_chunks(
        chunks(), prep, chunk_size=STREAM_CHUNK,
        preprocess_fn=lambda c: remove_static_background(c, bg, device="cpu").numpy(), **kw))
    if not (np.array_equal(on_card.simulation_indices, on_host.simulation_indices)
            and np.array_equal(on_card.scores, on_host.scores)) or launches != n // STREAM_CHUNK:
        raise AssertionError(f"static removal on the card (kernel D, {launches} launches) and on the host give other "
                             f"results")
    msgs.append(f"{smi}: with remove_static_background a chunk on the card (kernel D, {launches} launches) "
                f"{ms_d:.3f} ms = {n / ms_d * 1e3:.1f} patterns/s, on the host in the reader's thread {ms_h:.3f} ms "
                f"= {n / ms_h * 1e3:.1f} patterns/s: bit for bit the same results")
    del mm
    return msgs


def native_phase(dev, scan, smi: str) -> list[str]:
    """[native]: the host loader builds with g++ here; ``preprocess_u8`` of
    the main path's patterns within 2e-6 of kernel D's float32 output;
    host times of its three loops beside NumPy's."""
    from kikuchipy_tpu_torch import native
    from kikuchipy_tpu_torch.ops.pattern import remove_static_background

    if not native.available():
        raise AssertionError(f"the native loader did not build: {native.BUILD_LOG}")
    sig = tuple(scan.signal_shape)
    raw = np.ascontiguousarray(scan.data.reshape((-1,) + sig).cpu().numpy())
    bg = np.asarray(scan.static_background, dtype=np.float32)
    host = native.preprocess_u8(raw, bg)
    card = remove_static_background(scan.data.reshape((-1,) + sig), bg, dtype_out=np.float32, out_range=(-1.0, 1.0),
                                    device=dev).cpu().numpy()
    err = float(np.abs(host - card).max())
    if err > 2e-6:
        raise AssertionError(f"native.preprocess_u8 is {err:g} from kernel D's float32 output")
    order = np.random.default_rng(0).permutation(raw.shape[0])

    def host_ms(fn, reps: int = 5) -> float:
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    times = {"u8_to_f32": (host_ms(lambda: native.u8_to_f32(raw)), host_ms(lambda: raw.astype(np.float32))),
             "reorder_patterns": (host_ms(lambda: native.reorder_patterns(raw, order)), host_ms(lambda: raw[order])),
             "preprocess_u8": (host_ms(lambda: native.preprocess_u8(raw, bg)), None)}
    mb = raw.nbytes / 1e6
    return [f"{smi}: native.available() True ({native.library_path().name}); preprocess_u8 of {raw.shape[0]} patterns "
            f"within {err:.3g} of kernel D's float32 output (limit 2e-6); host ms on {mb:.1f} MB of uint8: "
            + "; ".join(f"{k} {a:.3f} ms ({mb / a * 1e3:.1f} MB/s)" + ("" if b is None else f", NumPy {b:.3f} ms")
                        for k, (a, b) in times.items())]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profiling-trace", type=Path, default=None, metavar="DIR",
                        help="only [profiling]'s capture, written into DIR (the phase runs it in a process of its own)")
    args = parser.parse_args(argv)

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    import kikuchipy_tpu_torch as kt

    here = Path(__file__).resolve().parent
    if Path(kt.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: kikuchipy_tpu_torch is not the checkout's ({kt.__file__})", file=sys.stderr)
        return 2
    if args.profiling_trace is not None:
        return profiling_trace(args.profiling_trace, args.seed)
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.crystallography.sampling import (
        disorientation_angle,
        reduce_to_fundamental_zone,
        sample_fundamental_zone,
        super_fibonacci,
    )
    from kikuchipy_tpu_torch.indexing.di import (
        PreparedDictionary,
        _quantize_rows_int8,
        _rescore_candidates,
        topk_stable,
    )
    from kikuchipy_tpu_torch.indexing.metrics import get_metric
    from kikuchipy_tpu_torch.ops import _build
    from kikuchipy_tpu_torch.ops import ncc_topk as nt
    from kikuchipy_tpu_torch.utils.device import matmul_precision
    from kikuchipy_tpu_torch.projection.master_pattern import (
        direction_cosines_from_detector,
        project_patterns,
        quad_texture,
    )

    dev = torch.device("cuda")
    smi = smi_line()
    log("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    # The Nelder-Mead kernel built with its tap-reuse probe compiles beside them.
    probe = start_probe_build(here)
    built = _build.build_all()
    ptxas = {}
    for name, text in _build.BUILD_LOG.items():
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in text.splitlines() if "registers" in ln]
        frames = [ln for ln in text.splitlines() if "stack frame" in ln]
        spilled = [ln for ln in frames if not ln.startswith("0 bytes stack frame, 0 bytes spill stores")]
        ptxas[name] = (f"max {max(regs, default=0)} registers, {len(spilled)}/{len(frames)} kernels with stack or "
                       f"spills{': ' + ' | '.join(spilled) if spilled else ''}")
    log("build", f"{sorted(built)} in {time.perf_counter() - t0:.1f} s; ptxas {ptxas}")

    # Instruction slots: SASS instructions a pixel, recounted where the toolkit
    # disassembles (sass_count.py), and the card's largest SM clock.
    sass = {"project_pixel": SASS_PER_PIXEL, "direction_cosine": SASS_DC_PER_PIXEL,
            "nm_eval_pixel": dict(SASS_NM_EVAL_PER_PIXEL), "population_pixel": dict(SASS_POP_PER_PIXEL),
            "tangent_pixel": dict(SASS_LM_PER_PIXEL),
            "lm_eval_pixel": dict(SASS_LM_EVAL_PER_PIXEL), "clahe_pixel": SASS_CLAHE_PER_PIXEL,
            "static_pixel": SASS_D_STATIC_PER_PIXEL, "dynamic_steps": dict(SASS_D_DYNAMIC_STEPS),
            "hough_pole": SASS_HOUGH_PER_POLE, "neighbours_pixel": SASS_NEIGHBOURS_PER_PIXEL, "source": "constants"}
    try:
        import sass_count

        counted = sass_count.count()
        sass = {key: counted[key] for key in ("project_pixel", "direction_cosine", "nm_eval_pixel", "population_pixel",
                                              "tangent_pixel",
                                              "lm_eval_pixel", "clahe_pixel", "static_pixel", "dynamic_steps",
                                              "hough_pole", "neighbours_pixel")}
        sass["source"] = "recounted in this run"
    except (ImportError, OSError, RuntimeError, subprocess.CalledProcessError) as err:
        print(f"[sass] recount failed ({type(err).__name__}: {err}); the constants stand", flush=True)
    if min(sass["project_pixel"], sass["direction_cosine"], *sass["nm_eval_pixel"].values(),
           *sass["population_pixel"].values(), sass["clahe_pixel"],
           sass["static_pixel"], sass["hough_pole"], sass["neighbours_pixel"], *sass["tangent_pixel"].values(),
           *sass["lm_eval_pixel"].values(),
           *sass["dynamic_steps"].values()) <= 0:
        raise AssertionError(f"no SASS count a pixel: {sass}")
    clock_mhz = max_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log("sass", f"instructions a pixel: lambert_pixel (kernels A, B, F, the Nelder-Mead kernel) "
        f"{sass['project_pixel']}, the direction cosine from a PC {sass['direction_cosine']}, a pixel of a "
        f"Nelder-Mead evaluation on the cache route (orientation, PC) {sass['nm_eval_pixel']}, a member-pixel of "
        f"kernel F's groups {sass['population_pixel']}, kernel C's pixel (value, "
        f"gradient, tangents) {sass['tangent_pixel']}, a pixel of one evaluation with its passes' sums (kernel C and "
        f"the LM loop kernel) {sass['lm_eval_pixel']}, a pixel of kernel E's pair kernel (its histogram step, blend, "
        f"output and share of the mappings) {sass['clahe_pixel']:g}, a pixel of kernel D's static warp kernel (two "
        f"passes, truncation, packing, the store's share) {sass['static_pixel']:g}, kernel D's dynamic pair kernel "
        f"(a row-product step, a column-product step, a warp's rest a pattern) {sass['dynamic_steps']}, a pole and "
        f"band of kernel H's scoring {sass['hough_pole']:g}, a pixel of kernel G's main-path "
        f"instantiation {sass['neighbours_pixel']:g} ({sass['source']}; constants {SASS_PER_PIXEL}, "
        f"{SASS_DC_PER_PIXEL}, {SASS_NM_EVAL_PER_PIXEL}, {SASS_POP_PER_PIXEL}, {SASS_LM_PER_PIXEL}, "
        f"{SASS_LM_EVAL_PER_PIXEL}, "
        f"{SASS_CLAHE_PER_PIXEL:g}, {SASS_D_STATIC_PER_PIXEL:g}, {SASS_D_DYNAMIC_STEPS}, {SASS_HOUGH_PER_POLE:g}, "
        f"{SASS_NEIGHBOURS_PER_PIXEL:g}); "
        f"dispatch "
        f"{sms} SMs x {WARP_INSTR_PER_SM_CLOCK} warp instructions a clock at {clock_mhz:.0f} MHz")

    # ---- inputs (seeded) ----
    t0 = time.perf_counter()
    mp = kt.EBSDMasterPattern(master_pattern_data(), phase=Phase(name="ni", point_group="m-3m"), device=dev)
    det = kt.EBSDDetector(shape=DETECTOR_SHAPE, pc=PC, sample_tilt=70)
    dict_rot = sample_fundamental_zone(RESOLUTION_DEG, "m-3m")
    n_scan = SCAN_SIDE * SCAN_SIDE
    truth = reduce_to_fundamental_zone(super_fibonacci(n_scan * 7)[::7][:n_scan], "m-3m")
    scan_u8, static_bg = scan_data(mp, det, truth, args.seed, chunk_size=8192)
    scan = kt.EBSD(
        scan_u8.reshape(SCAN_SIDE, SCAN_SIDE, *DETECTOR_SHAPE), detector=det,
        static_background=static_bg, device=dev,
    )
    torch.cuda.synchronize()
    m = dict_rot.shape[0]
    d = DETECTOR_SHAPE[0] * DETECTOR_SHAPE[1]
    m_main = (m // 512) * 512
    k_carry = max(2 * KEEP_N, KEEP_N + 8)
    log("inputs", f"scan {tuple(scan.data.shape)} uint8, dictionary {m} orientations (m_main {m_main}), "
        f"master {mp.data.shape}, seed {args.seed}, {time.perf_counter() - t0:.1f} s")
    for msg in sampling_phase(smi):
        log("sampling", msg)

    # ---- int8 kernel vs plain on the card ----
    max_err, n_cases = kernel_cases(dev, args.seed, m_main, d, k_carry)
    log("kernel-check", f"ncc_topk_int8 == plain bit for bit on {n_cases} cases "
        f"(k up to 512, groups 1-512, short lists, fori/none; 1024 x {m_main} x {d} slab, k={k_carry}); "
        f"max |score diff| {max_err}")

    # ---- main path ----
    reset_launches()
    t0 = time.perf_counter()
    pre = scan.remove_static_background().remove_dynamic_background()
    dictionary = mp.get_patterns(dict_rot, det, chunk_size=8192)
    xmap = pre.dictionary_indexing(dictionary, keep_n=KEEP_N, precision="pallas-int8")
    torch.cuda.synchronize()
    main_launches = read_launches()
    t_main = time.perf_counter() - t0
    if main_launches["ncc_match_topk_int8"] < 1 or main_launches["lambert_project"] != 1:
        raise AssertionError(f"the main path did not launch ncc_topk_int8, or lambert_project not once: {main_launches}")
    if main_launches["remove_background[static]"] != 1 or main_launches["remove_background[dynamic]"] != 1:
        raise AssertionError(f"the main path's two removals were not one launch of kernel D each: {main_launches}")
    if main_launches["remove_background[static-warp]"] != 1:
        raise AssertionError(f"the main path's static removal did not take the static warp kernel: {main_launches}")
    if main_launches["remove_background[dynamic-pair]"] != 1:
        raise AssertionError(f"the main path's dynamic removal did not take the dynamic pair kernel: {main_launches}")
    scores = xmap.prop["scores"]
    idx = xmap.prop["simulation_indices"]
    if scores.shape != (n_scan, KEEP_N) or not np.isfinite(scores).all() or (idx < 0).any():
        raise AssertionError(f"bad indexing output: {scores.shape}, finite {np.isfinite(scores).all()}")

    exact = pre.dictionary_indexing(dictionary, keep_n=2, precision="highest")
    ex_s = exact.prop["scores"]
    ex_i = exact.prop["simulation_indices"]

    def top1_check(name: str, top1: np.ndarray, gap: float, ref_s=ex_s, ref_i=ex_i) -> str:
        clear = (ref_s[:, 0] - ref_s[:, 1]) > gap
        agree = top1 == ref_i[:, 0]
        if not agree[clear].all():
            raise AssertionError(f"{name}: top-1 differs from highest on {int((~agree[clear]).sum())} clear patterns")
        ang = np.degrees(disorientation_angle(truth, dict_rot[top1], "m-3m"))
        med, frac8 = float(np.median(ang)), float((ang < 8).mean())
        if not (med < 3.0 and frac8 > 0.9):
            raise AssertionError(f"{name}: orientations not recovered: median {med:.3f} deg, <8 deg {frac8:.4f}")
        return (f"top-1 == highest on {int(clear.sum())}/{n_scan} patterns with gap > {gap:g} (overall "
                f"{agree.mean():.6f}); disorientation median {med:.4f} deg, <8 deg {frac8:.4f}")

    log("main-path", f"{n_scan} patterns, static and dynamic background removal on kernel D (launches "
        f"{main_launches['remove_background']}, the static one on the warp kernel, the dynamic one on the pair "
        f"kernel), x {m} dictionary projected by "
        f"lambert_project (launches "
        f"{main_launches['lambert_project']}), pallas-int8 keep_n={KEEP_N}: ncc_topk_int8 launches "
        f"{main_launches['ncc_match_topk_int8']}; {top1_check('pallas-int8', idx[:, 0], TOP1_GAP['int8'])}; "
        f"first run {t_main:.2f} s")

    # keep_n = 65 carries k = 130 candidates through the kernel.
    reset_launches()
    wide = pre.dictionary_indexing(dictionary, keep_n=65, precision="pallas-int8")
    wide_launches = read_launches()["ncc_match_topk_int8"]
    w_s = wide.prop["scores"]
    if w_s.shape != (n_scan, 65) or not np.isfinite(w_s).all() or wide_launches < 1:
        raise AssertionError(f"keep_n=65 through pallas-int8: shape {w_s.shape}, launches {wide_launches}")
    if not (np.diff(w_s, axis=1) <= 0).all() or not np.array_equal(wide.prop["simulation_indices"][:, 0], idx[:, 0]):
        raise AssertionError("keep_n=65 through pallas-int8 is unsorted or changes top-1")
    log("keep_n-65", f"dictionary_indexing(keep_n=65, pallas-int8): kernel at k=130, launches {wide_launches}, "
        f"scores descending, top-1 equal to keep_n={KEEP_N}")

    # ---- preprocessing: kernels D and E against their plain versions, then the tutorial chain ----
    pre_errs, pre_msgs = preprocess_checks(dev, scan.data, scan.static_background)
    log("preprocess-check", f"kernel D (static bit for bit; dynamic within 1 gray on <= {GRAY_SHARE:.0%} of the "
        f"pixels, float32 outputs within 1e-5 of the range) and kernel E (within 1 gray on <= {GRAY_SHARE:.0%}) "
        f"against their plain versions on the {n_scan}-pattern scan: " + "; ".join(pre_msgs))
    chain, chain_msgs = preprocess_phase(dev, scan, smi)
    for msg in chain_msgs:
        log("preprocess", msg)
    # Each kernel's launches by path: the main path (kernel D's two removals)
    # and the chain at each size.
    pre_launches = {name: {"main": main_launches[name],
                           **{f"preprocess {n}": c["launches"][name] for n, c in chain.items()}}
                    for name in ("remove_background[static]", "remove_background[dynamic]", "clahe")}
    preprocess_table, pre_time_msgs = preprocess_rows(dev, scan, pre_errs, pre_launches, sass, clock_mhz, sms)
    log("preprocess-times", f"{smi}: " + "; ".join(pre_time_msgs))
    neighbour_row, nb_msgs, nb_time_msgs = neighbours_phases(dev, scan, smi, main_launches["average_neighbours"],
                                                             sass["neighbours_pixel"], clock_mhz, sms)
    for msg in nb_msgs:
        log("neighbours", msg)
    for msg in nb_time_msgs:
        log("neighbours-times", msg)
    t_hough = time.perf_counter()
    # The Hough phases' clean patterns: bands of Kikuchi width (HOUGH_BAND_WIDTH).
    hough_mp = kt.EBSDMasterPattern(master_pattern_data(width=HOUGH_BAND_WIDTH), phase=mp.phase, device=dev)
    hough_row, hough_msgs = hough_phases(dev, mp, hough_mp, det, pre, truth, smi, sass["hough_pole"], clock_mhz, sms)
    for phase in ("hough-check", "hough"):
        for msg in hough_msgs[phase]:
            log(phase, msg)
    for msg in hough_pc_phase(dev, hough_mp, det, pre, smi):
        log("hough-pc", msg)
    log("hough-pc", f"[hough-check], [hough] and [hough-pc] took {time.perf_counter() - t_hough:.1f} s")

    # ---- the projection kernels against their plain twins ----
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    side = MASTER_SIDE
    geo = (side, side, (side - 1) / 2)
    master_np = mp._hemispheres_at_energy()
    quad = quad_texture(torch.as_tensor(master_np, device=dev))
    dc = direction_cosines_from_detector(det, device=dev)
    om = torch.as_tensor(np.ascontiguousarray(det.sample_to_detector.T), dtype=torch.float32, device=dev)
    rot_dict = torch.as_tensor(dict_rot, dtype=torch.float32, device=dev)
    yard = projection_checks(
        dev, dictionary.data.reshape(m, -1), rot_dict, dc, quad, side, float(master_np.max() - master_np.min()), om,
        args.seed)
    # Kernel A's max |kernel - plain| in the kernels line: against the float64
    # twin on the main path's own rows.
    a_err = yard.cases["dictionary"]["max_k"] * float(master_np.max() - master_np.min())
    log("projection-check", f"lambert_project against the plain twin in float64 on {len(yard.cases)} cases (the "
        f"whole {m}-pattern dictionary of the main path, a rescaled slab, one PC per rotation, P=515, B=1, pixels "
        f"within 1e-3 rad of a pole), shares of the master's range {float(master_np.max() - master_np.min()):.4f} "
        f"(of 255 rescaled); limits: pooled max E_k <= max E_t, RMS E_k <= {A_RMS_FACTOR} x RMS E_t, taps off "
        f"float64's <= {A_TAP_FACTOR} x the float32 twin's and < {A_TAP_SHARE:g} of the pixels, each case max E_k "
        f"<= {A_CASE_MAX:g}: pooled {yard.summary(yard.pooled())} | "
        + " | ".join(f"{name}: {yard.summary(c)}" for name, c in yard.cases.items()))
    pre_rows = pre.data.reshape(n_scan, -1)
    top1_rot = xmap.best_rotations
    rot_nav = torch.as_tensor(top1_rot[:NAV_CHUNK], dtype=torch.float32, device=dev)
    b_err, b_yards = ncc_kernel_checks(dev, pre_rows[:NAV_CHUNK], rot_nav, dc, quad, side, om, args.seed)
    log("ncc-check", f"lambert_project_ncc against the plain twin in float64 and float32 on {len(b_yards)} cases "
        f"(B={NAV_CHUNK} of the main path's patterns: shared, masked and per-point direction cosines, P=1000; B=1); "
        f"limits: each case of many patterns and the cases pooled max E_k <= max E_t, pooled RMS E_k <= "
        f"{A_RMS_FACTOR} x RMS E_t, each case |kernel - plain32| <= {B_TWIN_TOL:g}: pooled "
        f"{ncc_yardstick_text(ncc_pooled(b_yards))} | "
        + " | ".join(f"{case}: {ncc_yardstick_text(y)}" for case, y in b_yards.items()))

    # ---- refinement of the main path's crystal map ----
    # The synthetic scan carries a static background and no dynamic one.
    # The dynamic removal (a Gaussian high-pass) that dictionary indexing
    # runs on is not part of the simulated patterns, and on these data it
    # moves the NCC optimum off the truth (printed below, unchecked). The
    # checked refinement takes the scan with its static background removed,
    # the patterns the simulation describes.
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    l2_rate = l2_read_rate(dev)
    static = kt.EBSD(scan.remove_static_background().data, detector=det, device=dev)
    static_rows = static.data.reshape(n_scan, -1)
    ang0 = np.degrees(disorientation_angle(truth, top1_rot, "m-3m"))
    near = ang0 < REFINE_START_DEG
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined = static.refine_orientation(xmap=xmap, master_pattern=mp)
    torch.cuda.synchronize()
    t_refine = time.perf_counter() - t0
    refine_launches = read_launches()
    if refine_launches["nelder_mead_orientation"] < 1 or refine_launches["lambert_project_ncc"] != 0:
        raise AssertionError(f"refinement did not run on the Nelder-Mead kernel alone: {refine_launches}")
    r_scores, r_iters = refined.xmap.prop["scores"], refined.xmap.prop["num_evals"]
    if refined.xmap.best_rotations.shape != (n_scan, 4) or not np.isfinite(r_scores).all():
        raise AssertionError("refinement gave a bad crystal map")
    ang1 = np.degrees(disorientation_angle(truth, refined.xmap.best_rotations, "m-3m"))
    if not (np.median(ang1) < np.median(ang0) and ang1[near].max() < REFINE_MAX_DEG):
        raise AssertionError(
            f"refinement missed: median {np.median(ang0):.4f} -> {np.median(ang1):.4f} deg, max over the "
            f"{int(near.sum())} points DI put within {REFINE_START_DEG} deg: {ang1[near].max():.4f} deg "
            f"(limit {REFINE_MAX_DEG}); worst points {np.argsort(ang1)[-5:].tolist()} at "
            f"{np.sort(ang1)[-5:].round(3).tolist()} deg, from {ang0[np.argsort(ang1)[-5:]].round(3).tolist()}")

    # The kernel against the host loop on kernel B (nelder_mead_batched over
    # _objective_orientation, in navigation chunks as before), on the inputs
    # refine_orientation builds.
    exp_s, sq_s = _prepare_experimental(static_rows, None)
    euler_top1 = tq.to_euler(torch.as_tensor(top1_rot, dtype=torch.float64)).to(torch.float32).to(dev)
    nm_kw = dict(initial_step=np.deg2rad(1.0), max_iters=150, fatol=1e-4, xatol=1e-4)
    nm_args = (euler_top1, exp_s, sq_s, dc, quad, *geo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = host_loop(euler_top1, exp_s, sq_s, dc, quad, geo, nm_kw)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    kern = rn.nelder_mead_orientation(*nm_args, **nm_kw)
    torch.cuda.synchronize()
    same_as_call = float(np.abs((1.0 - kern.fun.cpu().numpy()) - r_scores).max())
    nm_err, nm_msg = nm_agreement("the main path's map", kern, host)
    edge_msgs = nm_edge_cases(dev, static_rows, euler_top1, dc, quad, geo, om, nm_kw, top1_rot, args.seed)
    log("refine-vs-host", f"nelder_mead_orientation against the host loop on kernel B: {nm_msg}; "
        f"refine_orientation's scores within {same_as_call:.2e} of the direct call; edge cases: "
        + "; ".join(edge_msgs))

    # Times: the kernel for the whole map (CUDA events after a warm-up),
    # beside the host loop's one run, the bound and a profiler trace.
    ms_nm = cuda_ms(lambda: rn.nelder_mead_orientation(*nm_args, **nm_kw), 3)
    evals = int(kern.n_evals.sum())
    host_evals = int(host.n_evals.sum())
    t_ops_nm = evals * d * (OPS_PER_PIXEL + NCC_OPS_PER_PIXEL) / PEAK_F32_FLOPS * 1e3
    # each input read once (rows, norms, angles, steps, direction cosines,
    # quad texture) and each output written once
    bytes_nm = 4 * (exp_s.numel() + n_scan * (1 + 3 + 3) + dc.numel() + quad.numel()) + n_scan * (12 + 4 + 4 + 4 + 1)
    t_bytes_nm = bytes_nm / PEAK_BYTES * 1e3
    bound_nm = max(t_ops_nm, t_bytes_nm)
    l2_nm = evals * d * TAP_BYTES / l2_rate * 1e3
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    static.refine_orientation(xmap=xmap, master_pattern=mp)
    torch.cuda.synchronize()
    t_refine2 = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):  # start the tracer once, untimed
        torch.zeros(1, device=dev).add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        static.refine_orientation(xmap=xmap, master_pattern=mp)
        torch.cuda.synchronize()
    traced_wall = (time.perf_counter() - t0) * 1e3
    busy, events = device_busy(prof)
    top = "; ".join(f"{k[:50]} x{c} {t:.3f} ms" for k, c, t in events[:6])
    nm_row = {
        "name": "nelder_mead_orientation", "route": "cuda", "source": "kikuchipy_tpu_torch/csrc/refine_nm.cu",
        "replaces": "kikuchipy_tpu/utils/optimize.py:60 nelder_mead_batched + "
                    "kikuchipy_tpu/indexing/refinement.py:199 _objective_orientation",
        "launches": refine_launches["nelder_mead_orientation"], "max_abs_err": nm_err, "ms": ms_nm,
        "plain_ms": t_host * 1e3, "bound_ms": bound_nm, "bound_by": "operations" if t_ops_nm >= t_bytes_nm else "bytes",
        "library_ms": None, "library_same_function_ms": None, "l2_bound_ms": l2_nm,
        "instruction_bound_ms": instruction_ms(evals * d, sass["nm_eval_pixel"][nm_sass_key("orientation", d)],
                                               clock_mhz, sms),
        "split_ms": None,
        "kernel_only_ms": None, "evaluations": evals, "scattered_taps_ms": evals * d / SCATTERED_TAPS_PER_S[1] * 1e3,
    }
    log("refine", f"{smi}: EBSD.refine_orientation(xmap=<pallas-int8 top-1>, master_pattern=mp) at its defaults "
        f"(Nelder-Mead, bilinear, max_iters=150) on the {n_scan} static-corrected patterns: first call "
        f"{t_refine:.3f} s = {n_scan / t_refine:.1f} patterns/s (the library's first load included); "
        f"nelder_mead_orientation "
        f"launches {refine_launches['nelder_mead_orientation']}, lambert_project_ncc "
        f"{refine_launches['lambert_project_ncc']}; Nelder-Mead iterations mean {r_iters.mean():.1f}, max "
        f"{int(r_iters.max())}; disorientation to truth median {np.median(ang0):.4f} -> {np.median(ang1):.4f} deg, "
        f"max {ang0.max():.3f} -> {ang1.max():.3f} deg; over the {int(near.sum())} points DI put within "
        f"{REFINE_START_DEG} deg: max {ang1[near].max():.4f} deg (limit {REFINE_MAX_DEG}), "
        f"{(ang1 < REFINE_MAX_DEG).mean():.4f} of all points under it")
    log("refine-times", f"{smi}: the whole map, P={d}: kernel {ms_nm:.3f} ms = {n_scan / ms_nm * 1e3:.1f} "
        f"patterns/s ({evals} evaluations, {evals / ms_nm * 1e3:.4g}/s); host loop on kernel B (chunks of "
        f"{NAV_CHUNK}) {t_host * 1e3:.1f} ms = {n_scan / t_host:.1f} patterns/s ({host_evals} evaluations); "
        f"bound {bound_nm:.4f} ms by {nm_row['bound_by']} (operations {t_ops_nm:.4f} ms at "
        f"{OPS_PER_PIXEL + NCC_OPS_PER_PIXEL} a pixel, bytes {t_bytes_nm:.4f} ms), {bound_nm / ms_nm:.2%} of it; "
        f"taps {evals * d * TAP_BYTES / 1e9:.2f} GB from L2 {l2_nm:.3f} ms at the measured "
        f"{l2_rate / 1e12:.3f} TB/s ({l2_nm / ms_nm:.2%}); instruction slots {nm_row['instruction_bound_ms']:.3f} ms at "
        f"{sass['nm_eval_pixel'][nm_sass_key('orientation', d)]} instructions a pixel "
        f"({nm_row['instruction_bound_ms'] / ms_nm:.2%}); "
        f"refine_orientation "
        f"untraced {t_refine2 * 1e3:.3f} ms = {n_scan / t_refine2:.1f} patterns/s; under torch.profiler: wall "
        f"{traced_wall:.3f} ms, device busy {busy:.3f} ms = {busy / traced_wall:.1%} over {len(events)} kernel "
        f"names; {top}")

    # The main path's own patterns (static and dynamic background removed), unchecked.
    reset_launches()
    t0 = time.perf_counter()
    refined_dyn = pre.refine_orientation(xmap=xmap, master_pattern=mp)
    torch.cuda.synchronize()
    t_dyn = time.perf_counter() - t0
    ang_dyn = np.degrees(disorientation_angle(truth, refined_dyn.xmap.best_rotations, "m-3m"))
    exp_d, sq_d = _prepare_experimental(pre_rows[:NAV_CHUNK], None)
    truth_q = torch.as_tensor(truth[:NAV_CHUNK], dtype=torch.float32, device=dev)
    at_truth = float(lp.lambert_project_ncc_plain(truth_q, dc, quad, *geo, exp_d, sq_d).mean())
    at_refined = float(1.0 - refined_dyn.xmap.prop["scores"][:NAV_CHUNK].mean())
    log("refine-dynamic", f"the same call on the main path's {n_scan} patterns with the dynamic background "
        f"removed too (unchecked): {t_dyn:.3f} s, launches {read_launches()['nelder_mead_orientation']}; "
        f"disorientation median {np.median(ang_dyn):.4f} deg, max over the near points {ang_dyn[near].max():.4f} "
        f"deg; on the first chunk mean 1 - NCC {at_refined:.5f} at the refined orientations against "
        f"{at_truth:.5f} at the truth: the optimum of these patterns is not the truth")

    exp_c, sq_c = _prepare_experimental(static_rows[:NAV_CHUNK], None)
    ms_b = cuda_ms(lambda: lp.lambert_project_ncc(rot_nav, dc, quad, *geo, exp_c, sq_c), 20)
    dc_each = torch.broadcast_to(dc, (NAV_CHUNK,) + tuple(dc.shape)).contiguous()
    ms_b_each = cuda_ms(lambda: lp.lambert_project_ncc(rot_nav, dc_each, quad, *geo, exp_c, sq_c), 20)
    pix_b = NAV_CHUNK * d
    bytes_b = 4 * (pix_b + 2 * NAV_CHUNK + 4 * NAV_CHUNK + dc.numel()) + quad.numel() * 4
    t_bytes_b = bytes_b / PEAK_BYTES * 1e3
    t_ops_b = pix_b * (OPS_PER_PIXEL + NCC_OPS_PER_PIXEL) / PEAK_F32_FLOPS * 1e3
    bound_b = max(t_bytes_b, t_ops_b)
    bound_b_each = max((bytes_b + 4 * dc_each.numel()) / PEAK_BYTES,
                       pix_b * (OPS_PER_PIXEL + NCC_OPS_PER_PIXEL) / PEAK_F32_FLOPS) * 1e3
    del dc_each
    log("ncc-times", f"{smi}: kernel B (the host loops' objective, one launch an evaluation) at B={NAV_CHUNK}, P={d}: "
        f"{ms_b * 1e3:.1f} us a launch, bound {bound_b * 1e3:.1f} us ({bound_b / ms_b:.1%}); with one set of "
        f"direction cosines a point {ms_b_each * 1e3:.1f} us, bound {bound_b_each * 1e3:.1f} us")

    # ---- PC and joint refinement of the whole map, each one launch ----
    # From the PC off by PC_OFFSET on the static-corrected scan: PC mode from
    # the refined orientations, joint mode from the DI top-1, both at their
    # defaults; each must be one launch of its Nelder-Mead kernel and none of
    # kernel B.
    bad_det = dataclasses.replace(det, pc=np.asarray(PC) + np.asarray(PC_OFFSET))
    pc_wrapper = {"pc": "nelder_mead_projection_center", "joint": "nelder_mead_orientation_projection_center"}
    pc_call = {"pc": "refine_projection_center", "joint": "refine_orientation_projection_center"}
    pc_start = {"pc": refined.xmap, "joint": xmap}
    pc_res, pc_t, pc_launches, pc_msgs = {}, {}, {}, []
    for mode in ("pc", "joint"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = getattr(static, pc_call[mode])(xmap=pc_start[mode], detector=bad_det, master_pattern=mp)
        torch.cuda.synchronize()
        pc_t[mode] = time.perf_counter() - t0
        counts = read_launches()
        pc_launches[mode] = counts[pc_wrapper[mode]]
        if counts[pc_wrapper[mode]] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"{pc_call[mode]} was not one launch of its Nelder-Mead kernel alone: {counts}")
        pcs = res.detector.pc.reshape(-1, 3)
        mean_pc = pcs.mean(axis=0)
        off = np.abs(mean_pc - np.asarray(PC))
        if pcs.shape != (n_scan, 3) or not np.isfinite(res.xmap.prop["scores"]).all() or not (off < PC_TOL).all():
            raise AssertionError(f"{pc_call[mode]}: mean PC {mean_pc.tolist()} is {off.tolist()} from {PC} "
                                 f"(limit {PC_TOL}), PC shape {pcs.shape}")
        ang = np.degrees(disorientation_angle(truth, res.xmap.best_rotations, "m-3m"))
        pc_res[mode] = res
        pc_msgs.append(
            f"{pc_call[mode]} on the {n_scan} static-corrected patterns from PC {PC} + {PC_OFFSET}: first call "
            f"{pc_t[mode]:.3f} s = {n_scan / pc_t[mode]:.1f} patterns/s, launches {counts[pc_wrapper[mode]]} "
            f"({pc_wrapper[mode]}; kernel B {counts['lambert_project_ncc']}), iterations mean "
            f"{res.xmap.prop['num_evals'].mean():.1f} max {int(res.xmap.prop['num_evals'].max())}, mean PC "
            f"{np.round(mean_pc, 6).tolist()} (off {np.round(off, 6).tolist()}, limit {PC_TOL}), PC std "
            f"{np.round(pcs.std(axis=0), 6).tolist()}, disorientation to truth median {np.median(ang):.4f} deg, "
            f"max {ang.max():.3f} deg" + (f" (orientation mode: median {np.median(ang1):.4f}, max {ang1.max():.3f})"
                                          if mode == "joint" else ""))
    # PC mode on the main path's own patterns (dynamic background removed
    # too), unchecked: the dynamic removal moves the optimum in PC z as well.
    res_dyn = pre.refine_projection_center(xmap=refined.xmap, detector=bad_det, master_pattern=mp)
    pc_msgs.append(f"refine_projection_center on the main path's patterns (unchecked): mean PC "
                   f"{np.round(res_dyn.detector.pc.reshape(-1, 3).mean(axis=0), 6).tolist()}")
    log("refine-pc", f"{smi}: " + "; ".join(pc_msgs))
    cal_msgs, cal_launches = calibration_phase(smi, mp, det, pre, xmap, pc_res["pc"].detector)
    for msg in cal_msgs:
        log("calibration", msg)

    # Each kernel against its host loop on kernel B (nelder_mead_batched over
    # pc_objective / joint_objective, the (n, P, 3) direction cosines built in
    # PyTorch an evaluation) on one navigation chunk of the same inputs, then
    # on the edge cases.
    rot_refined = torch.as_tensor(refined.xmap.best_rotations, dtype=torch.float32, device=dev)
    pc0_all = torch.as_tensor(np.tile(np.asarray(PC) + np.asarray(PC_OFFSET), (n_scan, 1)), dtype=torch.float32,
                              device=dev)
    c = NAV_CHUNK
    pc_host_ms, pc_chunk_ms, pc_err, pc_rows = {}, {}, {}, {}
    vs_msgs = []
    for mode in ("pc", "joint"):
        rot_q = rot_refined if mode == "pc" else None
        (wrapper, plain), pargs, kw = pc_problem(mode, pc0_all[:c], exp_s[:c], sq_s[:c],
                                                None if rot_q is None else rot_q[:c], euler_top1[:c], quad, om, None,
                                                geo, DETECTOR_SHAPE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_pc = plain(*pargs, **kw)
        torch.cuda.synchronize()
        pc_host_ms[mode] = (time.perf_counter() - t0) * 1e3
        kern_pc = wrapper(*pargs, **kw)
        torch.cuda.synchronize()
        pc_chunk_ms[mode] = cuda_ms(lambda: wrapper(*pargs, **kw), 2)
        pc_err[mode], msg = nm_agreement(f"{mode} mode, the first chunk", kern_pc, host_pc, mode)
        x_call = torch.as_tensor(pc_res[mode].detector.pc.reshape(-1, 3)[:c], dtype=torch.float32, device=dev)
        same_as_call = float((x_call - kern_pc.x[:, NM_COLUMNS[mode][1]]).abs().max())
        edge = pc_edge_cases(dev, mode, static_rows, rot_refined, euler_top1, quad, geo, top1_rot, args.seed)
        vs_msgs.append(f"{mode} mode: {msg}; host loop {pc_host_ms[mode]:.1f} ms against the kernel's "
                       f"{pc_chunk_ms[mode]:.3f} ms on the chunk; the map's call within {same_as_call:.2e} in PC "
                       f"of the chunk's; edge cases: " + "; ".join(edge))
    log("refine-pc-vs-host", "; ".join(vs_msgs))

    # ---- each mode against the host loop over the float32 twin, scored in float64 ----
    # The kernel and kernel B share lambert_pixel, not the plain twin's
    # float32 rounding: on one navigation chunk of the same inputs in each
    # mode, the kernel's points against the loop over
    # lambert_project_ncc_plain (float64_check), at the refine_* defaults.
    t_phase = time.perf_counter()
    f64_msgs, f64_bad = [], []
    for mode in ("orientation", "pc", "joint"):
        if mode == "orientation":
            x0, kw, q0 = euler_top1[:c], nm_kw, None
            wrap = lambda x: rn.nelder_mead_orientation(x, exp_s[:c], sq_s[:c], dc, quad, *geo, **nm_kw)  # noqa: E731
        else:
            (w, _), pargs, kw = pc_problem(mode, pc0_all[:c], exp_s[:c], sq_s[:c], rot_refined[:c], euler_top1[:c],
                                           quad, om, None, geo, DETECTOR_SHAPE)
            x0, q0 = pargs[0], rot_refined[:c]
            wrap = lambda x, w=w, pargs=pargs, kw=kw: w(x, *pargs[1:], **kw)  # noqa: E731
        ok, msg, _, _ = float64_check(mode, wrap, x0, kw, exp_s[:c], sq_s[:c], dc, q0, quad, om, None, geo,
                                      DETECTOR_SHAPE)
        f64_msgs.append(f"{mode} mode (n={c}): {msg}")
        if not ok:
            f64_bad.append(mode)
    log("refine-float64", f"the Nelder-Mead kernel against the host loop over the float32 plain twin, both scored by "
        f"the float64 twin; limits: the mean float64 1 - NCC no higher than the loop's by more than {NM_MEAN_TOL:g}, "
        f"in orientation mode {NM_AGREE:.0%} of the points within {NM_DEG} deg (the PC modes' shares within "
        f"{NM_DEG} deg and PC {NM_PC_TOL:g} printed): " + "; ".join(f64_msgs)
        + f" ({time.perf_counter() - t_phase:.1f} s)")
    if f64_bad:
        raise AssertionError(f"[refine-float64] failed in {f64_bad}")

    # Times on the whole map: each kernel (CUDA events), its evaluations and
    # bounds, and its refine_* call untraced and under torch.profiler.
    pc_times = []
    map_calls = {"orientation": lambda: rn.nelder_mead_orientation(*nm_args, **nm_kw)}
    for mode in ("pc", "joint"):
        (wrapper, _), pargs, kw = pc_problem(mode, pc0_all, exp_s, sq_s, rot_refined if mode == "pc" else None,
                                            euler_top1, quad, om, None, geo, DETECTOR_SHAPE)
        map_calls[mode] = lambda wrapper=wrapper, pargs=pargs, kw=kw: wrapper(*pargs, **kw)
        whole = wrapper(*pargs, **kw)
        torch.cuda.synchronize()
        ms_k = cuda_ms(lambda: wrapper(*pargs, **kw), 2)
        evals_k = int(whole.n_evals.sum())
        dims = pargs[0].shape[1]
        pixels = evals_k * d
        t_ops = pixels * (OPS_PER_PIXEL + NCC_OPS_PER_PIXEL + DC_OPS_PER_PIXEL) / PEAK_F32_FLOPS * 1e3
        # each input read once (rows, norms, starts, steps, rotations, pixel
        # table, quad texture) and each output written once
        in_bytes = 4 * (exp_s.numel() + n_scan * (1 + 2 * dims + (4 if mode == "pc" else 0)) + 2 * d + quad.numel())
        t_bytes = (in_bytes + n_scan * (4 * dims + 4 + 4 + 4 + 1)) / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        l2_ms = pixels * TAP_BYTES / l2_rate * 1e3
        t_instr = instruction_ms(pixels, sass["nm_eval_pixel"][nm_sass_key(mode, d)], clock_mhz, sms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(static, pc_call[mode])(xmap=pc_start[mode], detector=bad_det, master_pattern=mp)
        torch.cuda.synchronize()
        t_call = time.perf_counter() - t0
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            getattr(static, pc_call[mode])(xmap=pc_start[mode], detector=bad_det, master_pattern=mp)
            torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
        busy_k, events_k = device_busy(prof)
        top_k = "; ".join(f"{k[:50]} x{cnt} {t:.3f} ms" for k, cnt, t in events_k[:5])
        pc_rows[mode] = {
            "name": pc_wrapper[mode], "route": "cuda", "source": "kikuchipy_tpu_torch/csrc/refine_nm.cu",
            "replaces": "kikuchipy_tpu/utils/optimize.py:60 nelder_mead_batched + kikuchipy_tpu/indexing/"
                        + ("refinement.py:422 _objective_pc" if mode == "pc" else "refinement.py:442 _objective_joint"),
            "launches": pc_launches[mode], "max_abs_err": pc_err[mode], "ms": ms_k,
            "plain_ms": pc_host_ms[mode], "plain_points": c, "chunk_ms": pc_chunk_ms[mode], "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            "library_same_function_ms": None, "l2_bound_ms": l2_ms, "instruction_bound_ms": t_instr, "split_ms": None,
            "kernel_only_ms": None, "evaluations": evals_k, "scattered_taps_ms": pixels / SCATTERED_TAPS_PER_S[1] * 1e3,
        }
        pc_times.append(
            f"{mode} mode: kernel {ms_k:.3f} ms = {n_scan / ms_k * 1e3:.1f} patterns/s ({evals_k} evaluations, "
            f"{evals_k / n_scan:.1f} a point); bound {bound:.4f} ms by {pc_rows[mode]['bound_by']} (operations "
            f"{t_ops:.4f} ms at {OPS_PER_PIXEL + NCC_OPS_PER_PIXEL + DC_OPS_PER_PIXEL} a pixel, bytes {t_bytes:.4f} "
            f"ms), {bound / ms_k:.2%} of it; instruction slots {t_instr:.3f} ms at "
            f"{sass['nm_eval_pixel'][nm_sass_key(mode, d)]} instructions a pixel ({t_instr / ms_k:.2%}); taps "
            f"{pixels * TAP_BYTES / 1e9:.2f} GB from L2 {l2_ms:.3f} ms ({l2_ms / ms_k:.2%}); {pc_call[mode]} "
            f"untraced {t_call * 1e3:.3f} ms = {n_scan / t_call:.1f} patterns/s; under torch.profiler wall "
            f"{traced:.3f} ms, device busy {busy_k:.3f} ms = {busy_k / traced:.1%}; {top_k}; the host loop on "
            f"kernel B {pc_host_ms[mode]:.1f} ms for {c} points ({c / pc_host_ms[mode] * 1e3:.1f} patterns/s)")
    ms_nm_again = cuda_ms(lambda: rn.nelder_mead_orientation(*nm_args, **nm_kw), 2)
    # The tap cache's hits at the whole map, on the kernel built with its probe.
    reuse = tap_reuse(finish_probe_build(probe), map_calls)
    for mode, row in (("orientation", nm_row), *pc_rows.items()):
        row["sass_per_pixel"] = sass["nm_eval_pixel"][nm_sass_key(mode, d)]
        cached = reuse[mode]["later_pixels"] > 0  # none where the plan takes no cache
        row["tap_reuse_share"] = reuse[mode]["share_of_later"] if cached else None
        row["tap_cache_hits_of_all"] = reuse[mode]["share_of_all"] if cached else None
    log("refine-pc-times", f"{smi}: the whole map, P={d}: " + "; ".join(pc_times)
        + f"; orientation mode in the same run {ms_nm_again:.3f} ms; the tap cache's hits (of the pixels after a "
        f"point's first evaluation; of all): " + ", ".join(
            f"{mode} {r['share_of_later']:.4f}; {r['share_of_all']:.4f}" for mode, r in reuse.items()))

    # ---- LM and gradient refinement of the whole map ----
    # Each refine_* call at its defaults with method "lm", then "gradient",
    # from Nelder-Mead's starts. "lm" is one launch of the LM loop kernel
    # (csrc/refine_lm.cu refine_lm_loop_kernel, through the mode's
    # levenberg_marquardt_* wrapper) and no launch of kernel C; every
    # "gradient" evaluation is one launch of kernel C (the tangent wrapper);
    # no other kernel runs. The gates are Nelder-Mead's.
    lm_start = {"orientation": dict(xmap=xmap), "pc": dict(xmap=refined.xmap, detector=bad_det),
                "joint": dict(xmap=xmap, detector=bad_det)}
    lm_launches, lm_kernel_ms, loop_kernel_ms = {}, {}, {}
    for method, tag in (("lm", "refine-lm"), ("gradient", "refine-grad")):
        msgs = []
        for mode in ("orientation", "pc", "joint"):
            call = getattr(static, LM_CALL[mode])
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = call(master_pattern=mp, method=method, **lm_start[mode])
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            counts = read_launches()
            name = LM_LOOP[mode] if method == "lm" else LM_WRAPPER[mode]
            launches = counts[name]
            others = {k: v for k, v in counts.items() if v and k != name}
            if launches < 1 or others or (method == "lm" and launches != 1):
                raise AssertionError(f"{LM_CALL[mode]}(method={method!r}) did not run on "
                                     f"{'one launch of the LM loop kernel' if method == 'lm' else 'kernel C'} alone: "
                                     f"{counts}")
            lm_launches[(method, mode)] = launches
            iters = res.xmap.prop["num_evals"]
            if res.xmap.best_rotations.shape != (n_scan, 4) or not np.isfinite(res.xmap.prop["scores"]).all():
                raise AssertionError(f"{LM_CALL[mode]}(method={method!r}) gave a bad crystal map")
            ang = np.degrees(disorientation_angle(truth, unit_quats(res.xmap.best_rotations), "m-3m"))
            gate = (f"disorientation to truth median {np.median(ang):.4f} deg, max over the {int(near.sum())} points "
                    f"DI put within {REFINE_START_DEG} deg {ang[near].max():.4f} (limit {REFINE_MAX_DEG})")
            if mode == "orientation" and not ang[near].max() < REFINE_MAX_DEG:
                raise AssertionError(f"{LM_CALL[mode]}(method={method!r}) missed: {gate}")
            if mode != "orientation":
                pcs = res.detector.pc.reshape(-1, 3)
                off = np.abs(pcs.mean(axis=0) - np.asarray(PC))
                gate = (f"mean PC {np.round(pcs.mean(axis=0), 6).tolist()} (off {np.round(off, 6).tolist()}, limit "
                        f"{PC_TOL}), PC std {np.round(pcs.std(axis=0), 6).tolist()}, " + gate.split(", max")[0])
                if not (off < PC_TOL).all():
                    raise AssertionError(f"{LM_CALL[mode]}(method={method!r}) missed the PC: {gate}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(master_pattern=mp, method=method, **lm_start[mode])
            torch.cuda.synchronize()
            t_call = time.perf_counter() - t0
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call(master_pattern=mp, method=method, **lm_start[mode])
                torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) * 1e3
            busy_k, events_k = device_busy(prof)
            kern = [(cnt, t) for k, cnt, t in events_k
                    if ("refine_lm_loop_kernel" if method == "lm" else "refine_lm_kernel") in k]
            k_n, k_ms = sum(c for c, _ in kern), sum(t for _, t in kern)
            bounds = ""
            if method == "lm":
                loop_kernel_ms[mode] = k_ms / max(k_n, 1)
                # The call's evaluations: the start and one an iteration.
                evals = n_scan + int(iters.sum())
                pixels = evals * d
                t_instr = instruction_ms(pixels, sass["lm_eval_pixel"][mode], clock_mhz, sms)
                t_taps = pixels * TAP_BYTES / l2_rate * 1e3
                floor = [pixels / rate * 1e3 for rate in SCATTERED_TAPS_PER_S[::-1]]
                k_one = max(loop_kernel_ms[mode], 1e-9)
                bounds = (f"; {evals} evaluations ({evals / n_scan:.3f} a point): the loop kernel "
                          f"{loop_kernel_ms[mode]:.4f} ms against {t_instr:.4f} ms of issue slots at "
                          f"{sass['lm_eval_pixel'][mode]} a pixel ({t_instr / k_one:.2%}), the taps' bytes from L2 "
                          f"{t_taps:.4f} ms ({t_taps / k_one:.2%}) and their scattered sectors at "
                          f"{SCATTERED_TAPS_PER_S[0]:.3g}-{SCATTERED_TAPS_PER_S[1]:.3g}/s {floor[0]:.4f}-{floor[1]:.4f} "
                          f"ms ({floor[0] / k_one:.2%}-{floor[1] / k_one:.2%})")
                # Where the rest of the call goes: the host's own time by op.
                host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                              key=lambda e: e.self_cpu_time_total, reverse=True)
                bounds += "; host self time under the trace: " + "; ".join(
                    f"{e.key[:40]} x{e.count} {e.self_cpu_time_total / 1e3:.3f} ms" for e in host[:6])
            else:
                lm_kernel_ms[mode] = k_ms / max(k_n, 1)
            top_k = "; ".join(f"{k[:40]} x{cnt} {t:.3f} ms" for k, cnt, t in events_k[:4])
            msgs.append(
                f"{LM_CALL[mode]}(method={method!r}) on the {n_scan} static-corrected patterns: first call "
                f"{t_first:.3f} s, untraced {t_call * 1e3:.3f} ms = {n_scan / t_call:.1f} patterns/s; "
                f"{name} launches {launches} (kernel C {counts[LM_WRAPPER[mode]]}; {k_n} under the trace, "
                f"{k_ms / max(k_n, 1):.4f} ms a launch, {k_ms:.3f} ms in all){bounds}; num_evals mean "
                f"{iters.mean():.3f} max {int(iters.max())}; under torch.profiler wall {traced:.3f} ms, device busy "
                f"{busy_k:.3f} ms = {busy_k / traced:.1%} (of the untraced call's time "
                f"{busy_k / (t_call * 1e3):.1%}); {top_k}; " + gate)
        log(tag, f"{smi}: " + "; ".join(msgs))

    # Kernel C against its plain version at the same points, then whole LM
    # runs on both, on one navigation chunk.
    lm_worst, lm_msgs = lm_checks(dev, static_rows, torch.as_tensor(top1_rot, dtype=torch.float32, device=dev), quad,
                                  geo, om, dc, args.seed)
    run_msgs = lm_run_agreement(dev, static_rows, torch.as_tensor(top1_rot, dtype=torch.float32, device=dev), quad,
                                geo, om, dc)
    pole = [m for m in lm_msgs if LM_POLE_CASE in m]
    log("lm-check", f"kernel C against its plain version at the same points (limits: sim equal to kernel A's; no "
        f"further from the float64 plain version than {LM_FACTOR:g} x the float32 one, or {LM_REL:g} of the norms; "
        f"against the float32 one |df| <= {LM_F_TOL:g} but in the {LM_POLE_CASE} case while the float32 one is "
        f"over it against float64; |dg| and |dJtJ| printed): " + "; ".join(m for m in lm_msgs if m not in pole)
        + f" | whole LM runs on the kernel and on the plain version over {NAV_CHUNK} points: " + "; ".join(run_msgs))
    log("lm-check", "the pole case: " + "; ".join(pole))

    # The LM loop kernel against the host loop on kernel C at the whole map,
    # its times, and its rows of the kernel table with both bounds from its
    # evaluations.
    loop_res, loop_msgs = lm_loop_checks(dev, static_rows, torch.as_tensor(top1_rot, dtype=torch.float32, device=dev),
                                         quad, geo, om, dc)
    log("lm-loop-check", f"{smi}: the LM loop kernel against the host loop on kernel C at refine_*'s settings, whole "
        f"map (limits: fun, rotations, PCs on >= {NM_AGREE}, iterations on >= {LM_ITER_AGREE}, all finite): "
        + "; ".join(loop_msgs))
    loop_rows = {}
    for mode in ("orientation", "pc", "joint"):
        dd, r = LM_DIMS[mode], loop_res[mode]
        pixels = r["evals"] * d
        # each input read once (rows, starts, rotations, PCs, direction
        # cosines or pixel table, quad texture), each output written once
        per_point = dd + 4 + (3 if mode != "orientation" else 0)
        in_bytes = 4 * (n_scan * d + n_scan * per_point + (3 * d if mode == "orientation" else 2 * d) + quad.numel())
        out_bytes = n_scan * (4 * dd + 4 + 4 + 1 + 4)
        t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
        t_ops = pixels * lm_ops_per_pixel(mode) / PEAK_F32_FLOPS * 1e3
        t_instr = instruction_ms(pixels, sass["lm_eval_pixel"][mode], clock_mhz, sms)
        l2_ms = pixels * TAP_BYTES / l2_rate * 1e3
        scattered_ms = pixels / SCATTERED_TAPS_PER_S[1] * 1e3
        loop_rows[mode] = {
            "name": LM_LOOP[mode], "route": "cuda", "source": "kikuchipy_tpu_torch/csrc/refine_lm.cu",
            "replaces": "kikuchipy_tpu/utils/optimize.py:244 levenberg_marquardt_batched over :305 jac_and_res + "
                        "kikuchipy_tpu/indexing/refinement.py:132 _project_at",
            "launches": lm_launches[("lm", mode)], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["host_ms"], "plain_points": n_scan, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            "library_same_function_ms": None, "l2_bound_ms": l2_ms, "instruction_bound_ms": t_instr, "split_ms": None,
            "kernel_only_ms": loop_kernel_ms[mode], "evaluations": r["evals"], "bit_for_bit_share": r["same"],
            "scattered_taps_ms": scattered_ms,
            "note": "plain_ms: the host loop on kernel C at the whole map; max_abs_err: max |fun - the host loop's fun|",
        }

    # Times of one launch at the main-path shape (the whole map, at the
    # start x = 0, as LM's first launch), its bounds, and the plain version.
    lm_rows = {}
    q_top1 = torch.as_tensor(top1_rot, dtype=torch.float32, device=dev)
    pc0_map = torch.as_tensor(np.tile(np.asarray(PC) + np.asarray(PC_OFFSET), (n_scan, 1)), dtype=torch.float32,
                              device=dev)
    lm_times = []
    for mode in ("orientation", "pc", "joint"):
        dd = LM_DIMS[mode]
        zeros = torch.zeros((n_scan, dd), device=dev)
        wrapper, plain, x_map, a_map = lm_problem(mode, static_rows, zeros, q_top1, pc0_map, None, quad, om, dc, geo,
                                                  DETECTOR_SHAPE)
        ms_k = cuda_ms(lambda: wrapper(x_map, *a_map), 5)
        c = NAV_CHUNK
        _, _, x_c, a_c = lm_problem(mode, static_rows[:c], zeros[:c], q_top1[:c], pc0_map[:c], None, quad, om, dc, geo,
                                    DETECTOR_SHAPE)
        ms_plain = cuda_ms(lambda: plain(x_c, *a_c), 1)
        pixels = n_scan * d
        per_point = 4 + (4 + 3 if mode != "pc" else 0) + (3 if mode != "orientation" else 0)
        in_bytes = 4 * (n_scan * d + n_scan * per_point + (3 * d if mode == "orientation" else 2 * d) + quad.numel())
        out_bytes = 4 * n_scan * (1 + dd + dd * dd)
        t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
        t_ops = pixels * lm_ops_per_pixel(mode) / PEAK_F32_FLOPS * 1e3
        t_instr = instruction_ms(pixels, sass["tangent_pixel"][mode], clock_mhz, sms)
        l2_ms = pixels * TAP_BYTES / l2_rate * 1e3
        bound = max(t_ops, t_bytes)
        lm_rows[mode] = {
            "name": LM_WRAPPER[mode], "route": "cuda", "source": "kikuchipy_tpu_torch/csrc/refine_lm.cu",
            "replaces": "kikuchipy_tpu/utils/optimize.py:305 jac_and_res + kikuchipy_tpu/indexing/refinement.py:132 "
                        "_project_at",
            "launches": lm_launches[("gradient", mode)], "max_abs_err": lm_worst[mode][0],
            "ms": ms_k, "plain_ms": ms_plain, "plain_points": c, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            "library_same_function_ms": None, "l2_bound_ms": l2_ms, "instruction_bound_ms": t_instr, "split_ms": None,
            "kernel_only_ms": lm_kernel_ms[mode], "g_rel_err": lm_worst[mode][1], "jtj_rel_err": lm_worst[mode][2],
        }
        lm_times.append(
            f"{LM_WRAPPER[mode]} (kernel C, {mode} mode, d={dd}) at n={n_scan}: {ms_k:.4f} ms a call (CUDA events; "
            f"the kernel alone {lm_kernel_ms[mode]:.4f} ms a launch under torch.profiler in [refine-grad]"
            f"{', chunks of ' + str(NAV_CHUNK) if mode == 'orientation' else ''}); bound "
            f"{bound:.4f} ms by {lm_rows[mode]['bound_by']} (operations {t_ops:.4f} ms at {lm_ops_per_pixel(mode)} a "
            f"pixel, bytes {t_bytes:.4f} ms), {bound / ms_k:.2%} of it; instruction slots {t_instr:.4f} ms at "
            f"{sass['tangent_pixel'][mode]} a pixel ({t_instr / ms_k:.2%}); taps {pixels * TAP_BYTES / 1e9:.3f} GB "
            f"from L2 {l2_ms:.4f} ms ({l2_ms / ms_k:.2%}); plain version {ms_plain:.3f} ms for {c} points")
        del zeros, x_map, a_map, x_c, a_c
    log("lm-times", f"{smi}: " + "; ".join(lm_times))

    # ---- the spherical-harmonic tier in every mode ----
    sh_launches, sh_errs = sh_refinement_phases(dev, static, xmap, refined.xmap, det, bad_det, mp, truth, near, smi)
    for mode, row in loop_rows.items():
        row["launches_by_path"] = {"refine-lm": row["launches"], **{
            phase: c[LM_LOOP[mode]] for phase, c in sh_launches.items() if LM_LOOP[mode] in c}}

    # ---- the global solvers in every mode, on kernel F and the Nelder-Mead kernel ----
    global_rows, global_nm = global_refinement_phases(
        dev, static, xmap, refined.xmap, bad_det, mp, truth, near, smi, exp_s, sq_s, euler_top1, rot_refined, quad, om,
        dc, geo, sass, clock_mhz, sms, l2_rate)
    nm_row["launches_by_path"] = {"refine": nm_row["launches"], **{
        f"refine-global {m}": global_nm[("orientation", m)] for m in GLOBAL_METHODS}}
    for mode, row in pc_rows.items():
        row["launches_by_path"] = {f"refine-{mode}": row["launches"], **{
            f"refine-global-{mode} {m}": global_nm[(mode, m)] for m in GLOBAL_METHODS}}

    # ---- this slice's path: prepared rows -> the four fused-kernel entry points ----
    metric = get_metric("ncc")
    exp_prep = metric.prepare(pre.data)
    prep = kt.prepare_dictionary(dictionary.data, quantize=True, device=dev)
    dict_main = prep.prepared[:m_main]
    q_all, s_all = prep.quantized_int8()
    dict_q_main, dict_s_main = q_all[:m_main], s_all[:m_main]
    exp_q, _ = _quantize_rows_int8(exp_prep)
    n_float, slab_err = float_kernel_cases(dev, args.seed, exp_prep, dict_main, k_carry)
    log("float-check", f"f32, f32_blocked, bf16 fori/stream == plain modulo near-ties (tol {NEAR_TIE_TOL:g}) on "
        f"{n_float} cases incl. the 1024 x {m_main} x {d} slab of prepared rows, k={k_carry}; "
        f"slab max |slot score diff| {slab_err}")

    entry = {
        "ncc_match_topk_f32": lambda: nt.ncc_match_topk_f32(exp_prep, dict_main, k_carry, 256, 512),
        "ncc_match_topk_f32_blocked": lambda: nt.ncc_match_topk_f32_blocked(
            exp_prep, dict_main, k_carry, 512, 512, 128),
        "ncc_match_topk_bf16": lambda: nt.ncc_match_topk_bf16(exp_prep, dict_main, k_carry, 512, 512),
        "ncc_match_topk_int8": lambda: nt.ncc_match_topk_int8(exp_q, dict_q_main, dict_s_main, k_carry, 512, 512),
    }
    reset_launches()
    entry_out = {}
    for name, fn in entry.items():
        entry_out[name] = fn()
    torch.cuda.synchronize()
    entry_launches = read_launches()
    if any(entry_launches[name] < 1 for name in entry) or entry_launches["tf32_rows"] != 4:
        raise AssertionError(f"an entry point did not launch its kernel (f32: and two splits each): {entry_launches}")
    exact_main = kt.dictionary_index(
        pre.data, PreparedDictionary(prepared=dict_main, mask_hash=0), keep_n=2, precision="highest", device=dev)
    entry_msgs = []
    for name, (s_k, i_k) in entry_out.items():
        gap = TOP1_GAP["bf16" if "bf16" in name else "f32"]
        if name == "ncc_match_topk_int8":
            # int8 selection is approximate: rescore its k candidates
            # exactly first, as the pallas-int8 tier does.
            i_k = _rescore_candidates(exp_prep, dict_main, i_k, 1)[1]
        msg = top1_check(name, i_k[:, 0].cpu().numpy(), gap, exact_main.scores, exact_main.simulation_indices)
        entry_msgs.append(f"{name}: {msg}")
    log("entry-points", f"{n_scan} x {m_main} x {d}, k={k_carry}: launches {entry_launches}; " + "; ".join(entry_msgs))

    # The float kernels against their plain versions on all 16,384 rows.
    full_err = {}
    for name, rounding in (("ncc_match_topk_f32", torch.float32), ("ncc_match_topk_f32_blocked", torch.float32),
                           ("ncc_match_topk_bf16", torch.bfloat16)):
        s_k, i_k = entry_out[name]
        if rounding == torch.bfloat16:
            ref_s, ref_i = nt.ncc_match_topk_bf16_plain(exp_prep, dict_main, k_carry + 1, 512)
        else:
            ref_s, ref_i = nt.ncc_match_topk_f32_plain(exp_prep, dict_main, k_carry + 1)
        bad = nt.near_tie_disagreements(s_k, i_k, ref_s, ref_i, exp_prep, dict_main, NEAR_TIE_TOL, (), rounding)
        if bad:
            raise AssertionError(f"{name} != plain on the main path's own rows: {bad}")
        full_err[name] = float((s_k - ref_s[:, :k_carry]).abs().max())
        del ref_s, ref_i
    s_k, i_k = entry_out["ncc_match_topk_int8"]
    s_p, i_p = nt.ncc_match_topk_int8_plain(exp_q, dict_q_main, dict_s_main, k_carry, 512)
    if not (torch.equal(s_k, s_p) and torch.equal(i_k, i_p)):
        raise AssertionError("kernel != plain on the main path's own operands")
    full_err["ncc_match_topk_int8"] = float((s_k - s_p).abs().max())
    log("entry-plain", f"all {n_scan} rows against the plain versions (float kernels modulo near-ties, int8 bit "
        f"for bit): max |slot score diff| {full_err}")

    # ---- dictionary_indexing at every tier, and the fused projector call ----
    tier_msgs, tier_ms = [], {}
    for tier in DI_TIERS:
        for approx in (False, True):
            label = f"{tier}{'+approx' if approx else ''}"
            res = pre.dictionary_indexing(dictionary, keep_n=KEEP_N, precision=tier, approx_topk=approx)
            r_s, r_i = res.prop["scores"], res.prop["simulation_indices"]
            if r_s.shape != (n_scan, KEEP_N) or not np.isfinite(r_s).all():
                raise AssertionError(f"{label}: bad output {r_s.shape}")
            tier_msgs.append(f"{label}: {top1_check(label, r_i[:, 0], TOP1_GAP[tier])}")
            tier_ms[label] = cuda_ms(lambda: pre.dictionary_indexing(
                dictionary, keep_n=KEEP_N, precision=tier, approx_topk=approx), 1)
    fused_kw = dict(keep_n=KEEP_N, precision="f16", approx_topk=True, device=dev)
    fused = kt.dictionary_index(pre.data, project_fn=mp.projector(det), rotations=dict_rot, **fused_kw)
    if fused.scores.shape != (n_scan, KEEP_N) or not np.isfinite(fused.scores).all():
        raise AssertionError(f"fused project_fn call: bad output {fused.scores.shape}")
    tier_msgs.append(f"project_fn f16+approx: {top1_check('project_fn', fused.simulation_indices[:, 0], TOP1_GAP['f16'])}")
    tier_ms["project_fn f16+approx"] = cuda_ms(
        lambda: kt.dictionary_index(pre.data, project_fn=mp.projector(det), rotations=dict_rot, **fused_kw), 1)
    log("di-tiers", "; ".join(tier_msgs))
    log("di-times", f"{smi}: " + "; ".join(
        f"{label} {ms:.3f} ms = {n_scan / ms * 1e3:.1f} patterns/s" for label, ms in tier_ms.items()))

    # ---- times ----
    static_call = call_breakdown(scan.remove_static_background, 20,
                                 launches=lambda: sum(fn.launches for _, fn in _wrappers()))
    # The main path's two removals: CUDA events around calls back to back
    # (host and card at once), the same queued behind 10 ms of device sleep
    # (the card's time), and the chained call's breakdown (host clock,
    # device busy, host self time).
    two_removals = lambda: scan.remove_static_background().remove_dynamic_background()
    ms_pre = cuda_ms(two_removals, 5)
    ms_pre_card = cuda_ms(two_removals, 5, lead_ms=10.0)
    pre_call = call_breakdown(two_removals, 20, launches=lambda: sum(fn.launches for _, fn in _wrappers()))
    ms_proj = cuda_ms(lambda: mp.get_patterns(dict_rot, det, chunk_size=8192), 2)
    n_ops = 2.0 * n_scan * m_main * d
    out_bytes = n_scan * k_carry * 8
    f32_product = lambda c0, c1: exp_prep @ dict_main[c0:c1].T
    # Bytes of a row as the f32 kernel reads it: two planes of whole 32-value blocks (v3: of d padded to 128).
    f32_row = lambda dd: 8 * nt.TF32_BLOCK * -(-dd // nt.TF32_BLOCK)
    kernels = [
        # name, replaces (pallas_di.py line), source stem, operations over their peak rate (s), operand bytes,
        # bytes of a kernel row, reps, plain, product-only library call, the product of the same-function library
        # yardstick
        ("ncc_match_topk_f32", 413, "ncc_topk_f32", 3 * n_ops / PEAK_TF32_FLOPS, 4 * (n_scan + m_main) * d,
         f32_row(d), 3, lambda: nt.ncc_match_topk_f32_plain(exp_prep, dict_main, k_carry),
         ("torch.matmul f32, TF32 off", lambda: exp_prep @ dict_main.T), f32_product),
        ("ncc_match_topk_f32_blocked", 179, "ncc_topk_f32", 3 * n_ops / PEAK_TF32_FLOPS, 4 * (n_scan + m_main) * d,
         f32_row(-(-d // 128) * 128), 3, lambda: nt.ncc_match_topk_f32_blocked_plain(exp_prep, dict_main, k_carry),
         ("torch.matmul f32, TF32 off", lambda: exp_prep @ dict_main.T), f32_product),
        ("ncc_match_topk_bf16", 340, "ncc_topk_bf16", n_ops / PEAK_BF16_FLOPS, 2 * (n_scan + m_main) * d, 2 * d, 5,
         lambda: nt.ncc_match_topk_bf16_plain(exp_prep, dict_main, k_carry, 512),
         ("torch.matmul bf16", lambda: exp_bf16 @ dict_bf16.T),
         lambda c0, c1: (exp_bf16 @ dict_bf16[c0:c1].T).float()),
        ("ncc_match_topk_int8", 600, "ncc_topk_int8", n_ops / PEAK_INT8_OPS, (n_scan + m_main) * d + 4 * m_main, d, 5,
         lambda: nt.ncc_match_topk_int8_plain(exp_q, dict_q_main, dict_s_main, k_carry, 512),
         ("torch._int_mm", lambda: torch._int_mm(exp_q, dict_q_main.T)),
         lambda c0, c1: torch._int_mm(exp_q, dict_q_main[c0:c1].T).float() * dict_s_main[None, c0:c1]),
    ]
    exp_bf16, dict_bf16 = exp_prep.to(torch.bfloat16), dict_main.to(torch.bfloat16)
    table, time_msgs = [], []
    with matmul_precision(False):
        for name, line, stem, s_ops, in_bytes, row_bytes, reps, plain_fn, (lib_name, lib_fn), product in kernels:
            ms = cuda_ms(entry[name], reps)
            clocks = smi_line("clocks.sm,power.draw,temperature.gpu")
            ms_plain = cuda_ms(plain_fn, 1)
            ms_lib = cuda_ms(lib_fn, 3)
            ms_same = cuda_ms(lambda: library_same_function(product, m_main, k_carry), 1)
            t_ops, t_bytes = s_ops * 1e3, (in_bytes + out_bytes) / PEAK_BYTES * 1e3
            bound = max(t_ops, t_bytes)
            # The kernels' second bound: the bytes their tile moves from L2
            # to shared memory, at the L2 read rate measured here.
            tile = nt.WGMMA_TILE[stem]
            l2_gb = nt.wgmma_l2_bytes(stem, n_scan, m_main, row_bytes) / 1e9
            l2_ms = l2_gb * 1e9 / l2_rate * 1e3
            # The f32 entry points split their operands on every call: the
            # split and the kernel on split operands, apart.
            split_ms = kernel_only_ms = None
            if stem == "ncc_topk_f32":
                d_multiple = 128 if name.endswith("blocked") else 1  # as the entry point pads d
                split = lambda: [nt.tf32_rows(x, d_multiple) for x in (exp_prep, dict_main)]
                split_ms = cuda_ms(split, reps)
                planes = split()
                if name == "ncc_match_topk_f32":
                    split_row = split_table_row((exp_prep, dict_main), planes, split_ms, entry_launches["tf32_rows"])
                outs = nt._outputs(n_scan, k_carry, dev)
                kernel_only_ms = cuda_ms(lambda: nt._launch(
                    stem, [*planes, *outs], [n_scan, m_main, row_bytes // 8, k_carry, 512, 0], dev), reps)
                del planes
            table.append({
                "name": name,
                "route": "cuda",
                "source": f"kikuchipy_tpu_torch/csrc/{stem}.cu",
                "replaces": f"kikuchipy_tpu/ops/pallas_di.py:{line}",
                "launches": main_launches[name] + wide_launches * (name == "ncc_match_topk_int8")
                + entry_launches[name],
                "max_abs_err": full_err[name],
                "ms": ms,
                "plain_ms": ms_plain,
                "bound_ms": bound,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": ms_lib,
                "library_same_function_ms": ms_same,
                "l2_bound_ms": l2_ms,
                "split_ms": split_ms,
                "kernel_only_ms": kernel_only_ms,
            })
            l2_msg = (f"; {tile['bm']} x {tile['bn']} tile in clusters of {tile['cluster']} moves {l2_gb:.1f} GB from "
                      f"L2, {l2_ms:.3f} ms at the measured {l2_rate / 1e12:.3f} TB/s")
            if split_ms is not None:
                l2_msg += (f"; of the {ms:.3f} ms the split of both operands into TF32 planes {split_ms:.3f} ms, the "
                           f"kernel on split operands {kernel_only_ms:.3f} ms")
            time_msgs.append(f"{name} {ms:.3f} ms [after it: {clocks}] (bound {bound:.3f} ms by "
                             f"{table[-1]['bound_by']}, {bound / ms:.2%} of it{l2_msg}; plain {ms_plain:.3f} ms; "
                             f"{lib_name} {ms_lib:.3f} ms; product + torch.topk + merge per 32768 columns "
                             f"{ms_same:.3f} ms)")
    table.append(split_row)
    table.extend(preprocess_table)
    table.append(neighbour_row)
    table.append(hough_row)
    # The projection kernels: A on the whole dictionary, B on one navigation chunk.
    ms_a = cuda_ms(lambda: lp.lambert_project(rot_dict, dc, quad, *geo), 5)
    ms_a_plain = cuda_ms(lambda: [lp.lambert_project_plain(rot_dict[c0:c0 + 16384], dc, quad, *geo)
                                  for c0 in range(0, m, 16384)], 1)
    ms_b_plain = cuda_ms(lambda: lp.lambert_project_ncc_plain(rot_nav, dc, quad, *geo, exp_c, sq_c), 5)
    pix_a = m * d
    t_bytes_a = (4 * (pix_a + 4 * m + dc.numel()) + 4 * quad.numel()) / PEAK_BYTES * 1e3
    t_ops_a = pix_a * OPS_PER_PIXEL / PEAK_F32_FLOPS * 1e3
    none_keys = dict(library_ms=None, library_same_function_ms=None, split_ms=None, kernel_only_ms=None)
    # Kernel B: the host loops' engine, and the spherical tier's bilinear
    # scores at its solutions.
    notes = {
        "lambert_project": "max_abs_err against the plain twin in float64 on the main path's rows and the spherical "
                           "tier's analysis samples",
        "lambert_project_ncc": "the host loops' objective, and the spherical tier's bilinear scores; max_abs_err "
                               "over [ncc-check] and the tier's PC modes at the whole map",
    }
    by_path = {
        "lambert_project": {"main": main_launches["lambert_project"],
                            **{p: c["lambert_project"] for p, c in sh_launches.items() if "lambert_project" in c},
                            "calibration": cal_launches["lambert_project"]},
        "lambert_project_ncc": {"refine": refine_launches["lambert_project_ncc"],
                                **{p: c["lambert_project_ncc"] for p, c in sh_launches.items()
                                   if "lambert_project_ncc" in c}},
    }
    for name, line, launches, err, ms, plain_ms, bound, by, taps, per_pixel in (
        ("lambert_project", "projection/master_pattern.py:210", main_launches["lambert_project"],
         max(a_err, sh_errs["lambert_project"]), ms_a, ms_a_plain, max(t_bytes_a, t_ops_a),
         "bytes" if t_bytes_a >= t_ops_a else "operations", pix_a, sass["project_pixel"]),
        ("lambert_project_ncc", "indexing/refinement.py:132", refine_launches["lambert_project_ncc"],
         max(b_err, sh_errs["lambert_project_ncc"]), ms_b, ms_b_plain, bound_b,
         "bytes" if t_bytes_b >= t_ops_b else "operations", pix_b, sass["project_pixel"]),
    ):
        l2_ms = taps * TAP_BYTES / l2_rate * 1e3
        t_instr = instruction_ms(taps, per_pixel, clock_mhz, sms)
        table.append({
            "name": name, "route": "cuda", "source": "kikuchipy_tpu_torch/csrc/lambert_project.cu",
            "replaces": f"kikuchipy_tpu/{line}", "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "l2_bound_ms": l2_ms, "instruction_bound_ms": t_instr,
            **none_keys, "launches_by_path": by_path[name], "note": notes[name], "sass_per_pixel": per_pixel,
            **({"float64": {case: {k: y[k] for k in ("max_k", "max_t", "rms_k", "rms_t", "max_k32")}
                            for case, y in b_yards.items()}} if name == "lambert_project_ncc" else {}),
        })
        time_msgs.append(f"{name} {ms:.4f} ms (bound {bound:.4f} ms by {by}, {bound / ms:.2%} of it; instruction slots "
                         f"{t_instr:.4f} ms at {per_pixel} instructions a pixel ({t_instr / ms:.2%}); its "
                         f"{taps * TAP_BYTES / 1e9:.3f} GB of taps from L2 {l2_ms:.4f} ms; plain {plain_ms:.3f} ms"
                         f"{' in slabs of 16384 rows' if name == 'lambert_project' else ''}; no single PyTorch "
                         f"call computes it)")
    table.append(nm_row)
    nm_scattered = [nm_row["evaluations"] * d / rate * 1e3 for rate in SCATTERED_TAPS_PER_S[::-1]]
    time_msgs.append(f"nelder_mead_orientation {ms_nm:.3f} ms (bound {bound_nm:.4f} ms by {nm_row['bound_by']}, "
                     f"{bound_nm / ms_nm:.2%} of it; instruction slots {nm_row['instruction_bound_ms']:.3f} ms "
                     f"({nm_row['instruction_bound_ms'] / ms_nm:.2%}); taps from L2 {l2_nm:.3f} ms, as scattered sectors "
                     f"at {SCATTERED_TAPS_PER_S[0]:.3g}-{SCATTERED_TAPS_PER_S[1]:.3g}/s {nm_scattered[0]:.3f}-"
                     f"{nm_scattered[1]:.3f} ms ({nm_scattered[0] / ms_nm:.2%}-{nm_scattered[1] / ms_nm:.2%}); the host "
                     f"loop on kernel "
                     f"B {t_host * 1e3:.1f} ms; no single PyTorch call computes it)")
    for mode, row in pc_rows.items():
        table.append(row)
        time_msgs.append(f"{row['name']} {row['ms']:.3f} ms (bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                         f"{row['bound_ms'] / row['ms']:.2%} of it; instruction slots {row['instruction_bound_ms']:.3f} ms "
                         f"({row['instruction_bound_ms'] / row['ms']:.2%}); taps from L2 {row['l2_bound_ms']:.3f} ms, as "
                         f"scattered sectors {row['scattered_taps_ms']:.3f}-"
                         f"{row['scattered_taps_ms'] * SCATTERED_TAPS_PER_S[1] / SCATTERED_TAPS_PER_S[0]:.3f} ms "
                         f"({row['scattered_taps_ms'] / row['ms']:.2%}-"
                         f"{row['scattered_taps_ms'] * SCATTERED_TAPS_PER_S[1] / SCATTERED_TAPS_PER_S[0] / row['ms']:.2%}); the "
                         f"host loop on kernel B {row['plain_ms']:.1f} ms for {row['plain_points']} points against "
                         f"{row['chunk_ms']:.3f} ms of kernel; no single PyTorch call computes it)")
    for mode, row in loop_rows.items():
        table.append(row)
        time_msgs.append(f"{row['name']} {row['ms']:.4f} ms ({row['evaluations']} evaluations; bound "
                         f"{row['bound_ms']:.4f} ms by {row['bound_by']}, {row['bound_ms'] / row['ms']:.2%} of it; "
                         f"instruction slots {row['instruction_bound_ms']:.4f} ms "
                         f"({row['instruction_bound_ms'] / row['ms']:.2%}); taps from L2 {row['l2_bound_ms']:.4f} ms "
                         f"({row['l2_bound_ms'] / row['ms']:.2%}), as scattered sectors {row['scattered_taps_ms']:.4f} ms "
                         f"({row['scattered_taps_ms'] / row['ms']:.2%}); the host loop on kernel C {row['plain_ms']:.3f} ms; "
                         f"no single PyTorch call computes it)")
    for mode, row in lm_rows.items():
        table.append(row)
        time_msgs.append(f"{row['name']} {row['ms']:.4f} ms (bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                         f"{row['bound_ms'] / row['ms']:.2%} of it; instruction slots {row['instruction_bound_ms']:.4f} "
                         f"ms; taps from L2 {row['l2_bound_ms']:.4f} ms; plain version {row['plain_ms']:.3f} ms for "
                         f"{row['plain_points']} points; no single PyTorch call computes it)")
    table.extend(global_rows)
    time_msgs.append(f"tf32_rows (both operands) {split_row['ms']:.3f} ms (bound {split_row['bound_ms']:.3f} ms by "
                     f"bytes, {split_row['bound_ms'] / split_row['ms']:.2%} of it; plain {split_row['plain_ms']:.3f} ms)")
    del exp_bf16, dict_bf16
    ms_di = cuda_ms(lambda: pre.dictionary_indexing(dictionary, keep_n=KEEP_N, precision="pallas-int8"), 2)
    mb = scan.data.numel() / 1e6
    log("times", f"{smi}: preprocess {ms_pre:.3f} ms ({mb / ms_pre * 1e3:.1f} MB/s uint8 in), "
        f"{ms_pre_card:.3f} ms queued behind device sleep (the card's time), the chained call "
        f"{breakdown_text(pre_call)}; "
        f"EBSD.remove_static_background() {breakdown_text(static_call)}; "
        f"dictionary projection {ms_proj:.3f} ms ({m} patterns); at n={n_scan} m={m_main} d={d} k={k_carry}: "
        + "; ".join(time_msgs) + f" (library calls: never called by the port); "
        f"dictionary_indexing pallas-int8 {ms_di:.3f} ms = {n_scan / ms_di * 1e3:.1f} patterns/s")

    # ---- where the time of one indexing call and one projection chunk goes ----
    dict_prep = metric.prepare(dictionary.data)
    cand = entry_out["ncc_match_topk_int8"][1][:, :k_carry]
    rot_chunk = torch.as_tensor(dict_rot[:8192], dtype=torch.float32, device=dev)
    parts = {
        "prepare scan": lambda: metric.prepare(pre.data),
        "prepare dictionary": lambda: metric.prepare(dictionary.data),
        "quantize scan": lambda: _quantize_rows_int8(exp_prep),
        "quantize dictionary": lambda: _quantize_rows_int8(dict_prep),
        "remainder (exact)": lambda: topk_stable(exp_prep @ dict_prep[m_main:].T, k_carry),
        "rescore (exact)": lambda: _rescore_candidates(exp_prep, dict_prep, cand, KEEP_N),
        "project 8192 patterns": lambda: project_patterns(
            rot_chunk, dc, None, MASTER_SIDE, MASTER_SIDE, (MASTER_SIDE - 1) / 2, quad=quad
        ),
    }
    spent = {name: cuda_ms(fn, 3) for name, fn in parts.items()}
    int8_ms = next(row["ms"] for row in table if row["name"] == "ncc_match_topk_int8")
    log("breakdown", f"{smi}: kernel {int8_ms:.3f} ms; " + "; ".join(f"{k} {v:.3f} ms" for k, v in spent.items()))

    # ---- a profiler trace of one pallas-int8 indexing call ----
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pre.dictionary_indexing(dictionary, keep_n=KEEP_N, precision="pallas-int8")
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    busy_ms, events = device_busy(prof)
    top = "; ".join(f"{k[:60]} x{c} {t:.3f} ms" for k, c, t in events[:14])
    log("profile", f"{smi}: one pallas-int8 call under torch.profiler: wall {wall_ms:.3f} ms (tracing on), device busy "
        f"{busy_ms:.3f} ms over {len(events)} kernel names; {top}" if events else
        f"{smi}: torch.profiler recorded no device time; wall {wall_ms:.3f} ms")

    # ---- a profiler trace of one dictionary generation (get_patterns) ----
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mp.get_patterns(dict_rot, det, chunk_size=8192)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, events = device_busy(prof)
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0), key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    log("profile-projection", f"{smi}: one get_patterns call ({m} patterns) under torch.profiler: wall {wall_ms:.3f} ms "
        f"(tracing on), device busy {busy_ms:.3f} ms over {len(events)} kernel names: "
        + "; ".join(f"{k[:50]} x{c} {t:.3f} ms" for k, c, t in events[:8])
        + " | host self time: " + "; ".join(f"{e.key[:40]} x{e.count} {e.self_cpu_time_total / 1e3:.3f} ms"
                                           for e in host[:10]))

    # ---- reading and writing scans, and lazy scans from a memory map ----
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        io_msgs, dat = io_phase(dev, scan, smi, Path(tmp), args.seed)
        for msg in io_msgs:
            log("io", msg)
        for msg in lazy_phase(dev, scan, pre, dictionary, mp, det, top1_rot, smi, dat, Path(tmp)):
            log("lazy", msg)
    log("io", f"[io] and [lazy] took {time.perf_counter() - t0:.1f} s")

    # ---- the kinematical simulation, decomposition, virtual BSE imaging, profiling ----
    t0 = time.perf_counter()
    sim_msgs, sim_launches = simulation_phase(dev, det, dict_rot, smi, args.seed)
    for msg in sim_msgs:
        log("simulation", msg)
    for msg in decomposition_phase(dev, pre, smi):
        log("decomposition", msg)
    for msg in vbse_phase(dev, scan, smi):
        log("vbse", msg)
    with tempfile.TemporaryDirectory() as tmp:
        for msg in profiling_phase(smi, Path(tmp), args.seed):
            log("profiling", msg)
    for row in table:
        if row["name"] in ("lambert_project", "ncc_match_topk_int8"):
            row.setdefault("launches_by_path", {"main": main_launches[row["name"]]})
            row["launches_by_path"]["simulation"] = sim_launches[row["name"]]
    log("profiling", f"[simulation], [decomposition], [vbse] and [profiling] took {time.perf_counter() - t0:.1f} s")

    # ---- scale-out: meshes and processes on the one card, streaming, the host loader ----
    t0 = time.perf_counter()
    par_msgs, par_launches, prep = parallel_phase(dev, pre, static, dictionary, dict_rot, mp, det, bad_det, xmap,
                                                  refined.xmap, smi)
    for msg in par_msgs:
        log("parallel", msg)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mh_msgs, mh_launches = multihost_phase(dev, dict_rot, mp, pre, static, dictionary, xmap, smi, Path(tmp))
    for msg in mh_msgs:
        log("multihost", msg)
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for msg in streaming_phase(dev, scan, dictionary, prep, smi, Path(tmp)):
            log("streaming", msg)
    del prep
    t3 = time.perf_counter()
    for msg in native_phase(dev, scan, smi):
        log("native", msg)
    log("native", f"[parallel] {t1 - t0:.1f} s, [multihost] {t2 - t1:.1f} s, [streaming] {t3 - t2:.1f} s, [native] "
        f"{time.perf_counter() - t3:.1f} s")
    for row in table:
        by_path = row.setdefault("launches_by_path", {})
        if row["name"] == "lambert_project":
            by_path.update({k: v for k, v in par_launches.items() if k.startswith("parallel fused")})
        for mode, wrapper in NM_WRAPPER.items():
            if row["name"] == wrapper:
                by_path[f"parallel refine {mode}"] = par_launches[f"parallel refine {mode}"]
        if row["name"] == LM_LOOP["orientation"]:
            by_path.update(mh_launches)

    if "jax" in sys.modules or "kikuchipy_tpu" in sys.modules:
        raise AssertionError("chip_smoke imported JAX or the JAX package")
    log("total", f"{time.perf_counter() - t_start:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
