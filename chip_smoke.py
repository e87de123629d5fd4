#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
  2. build: the CUDA kernels of ``convexadam_torch/csrc`` (one nvcc per source),
     with the registers and spills ``ptxas`` reports for the kernels of
     ``warp.cu``, ``mind.cu``, ``cost_volume.cu`` and ``edt.cu`` (the backward
     kernel must fit 64 registers; the data term's, the forward sampler's,
     every MIND kernel, every cost-volume kernel and the three searches must
     not spill);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes and dtypes (and a ragged shape for the MIND and
     sampling kernels; the sampler with float32 and bfloat16 volumes), with
     two times for the kernel and for its library call, taken in turns
     (kernel, library, library, kernel): ``call_ms``, the median CUDA-event
     time of one wrapper call over 20 calls after warm-up, host issue
     included (``ms`` and ``kernel_ms`` in the records, as before), and
     ``device_ms``, the CUDA time per call of the kernel's own ``__global__``
     functions from ``torch.profiler`` over 20 calls (for the library call,
     the sum of every device kernel the call runs);
  3a. MIND statistics to the bit at 192^3 (bf16 and f32, timed) and at
     every (r, d) in {1, 2, 3}^2 on ragged 37 x 41 x 29, 37 x 41 x 150 and
     37 x 41 x 131 crops (f32, bf16); on the 37 x 41 x 29 crop also at the
     pairs of :data:`MIND_GENERAL_PAIRS`, which run the general kernel (r or
     d 0, d >= 4, r >= 4, halos past shared memory and past the crop), where
     the profiler must see the kernel ``kernels/mind.py:kernel_for`` names
     for each pair (``mind_kernel`` of that (r, d), or
     ``mind_general_kernel``) and no other; the general kernel timed at
     192^3 at (4, 1) (bf16, f32), (1, 5) and (6, 6) (bf16) beside the
     compiled (3, 3);
  3b. the cost volume to the bit at 12 x 32^3 (q = 4, the main path's
     pooled MIND features), at the semantic grid 14 x 32 x 26 x 42 (q = 4)
     and the sweep's 12 x 64 x 53 x 85 (q = 7), all timed (the sweep's
     plain version not), and at every q in 0..9 on ragged crops across the
     kernels' tiles and channel chunks, where the profiler must see the
     kernel of each q (``kernels/cost_volume.py:kernel_for``: q = 1..7 its
     own instantiation, q = 0, 8 and 9 the general kernel); then the
     variants to the bit, timed: SAD at task 3's coarse grid 36 x 80 x 96 x
     112 (q = 3), the semantic grid (q = 5) and task 1's 12 x 48 x 40 x 48
     (q = 8, the general kernel), SSD at task 1's grid through the general
     kernel, one candidate block (one kh) of the (2, 7) class at 14 x 96 x
     80 x 128 and of task 1's grid at q = 8, each also against the same slab
     of the dense volume; SAD at every q in 0..9 and blocks of both metrics
     at q = 0, 1, 4, 7, 8, 9 on the ragged crops; a slab's moving row
     offset (9d) at every q in 0..9, SSD and SAD, volume and block, on two
     ragged crops, equal to the plain version and to the whole volume's rows;
  3d. the Adam data term, rows to the bit, at 12 x 96^3 (bf16 and f32), at
     the semantic Adam grid 14 x 96 x 80 x 128 (bf16) and at 5b's
     grid_sp_adam 3 grid 14 x 64 x 53 x 85 (bf16; no axis divides the
     Abdomen shape), all timed, and on a ragged grid with points past every
     face; the strided form (strides 2 and 3) on the 12 x 96^3 grid's 48^3
     and 32^3 sub-lattices (bf16, timed, and f32) and on a ragged 3 x 37 x
     41 x 29 grid that neither stride divides, rows to the bit;
     both forms on lattice rows from ``row0`` (9d's slabs) of the ragged
     grids, equal to the plain version and to the whole lattice's rows;
  3c. the sampler on the inverse-consistency fields (to the bit, and to
     1e-5 against ``F.grid_sample``), and the fused
     inverse-consistency steps (15 per call, 2 x 3 x 32^3 and a ragged 37 x
     41 x 29 pair sent past every face) against their plain version and
     against the composition they replace (grid adds, one sampler launch
     and the updates per step), both to the bit, and against the same
     composition with ``F.grid_sample`` in its times;
  3e. the three nearest-neighbour search kernels of the HD95 engine against
     their plain versions, tolerance 0 at meaningful entries: on the largest
     label surface of the phase-4c volumes (the liver-sized organ's, K =
     16384), on 65536 seeded points
     in [0, 192)^3 (a large organ's surface at this size) and on a ragged
     case; then all 52 pruned searches of the pair's two label buckets,
     built as the engine builds them, one batched call a bucket; the pruned
     kernel must visit the same tiles as its plain version; the tiled
     kernel's whole output, the init past n_query included, also with no
     live query, with no live target, with Kt = 16383 (a multiple of
     neither the tile nor the chunk) and with 65535 x 1024 + 1000 targets,
     more chunks than the grid's y extent, where the dual search too must
     give every entry of both outputs as its plain version;
  3f. the sampler's coordinate-gradient kernel against its plain version to
     the bit at the semantic Adam grid 14 x 96 x 80 x 128 (bf16 and f32
     volumes, a smooth field of a few voxels, as the Adam loop samples) and
     at a ragged 37 x 41 x 29 case with points past every face,
     and its grid gradient against ``aten.grid_sampler_3d_backward`` (f32
     copies) to 1e-5 relative L2; the forward sampler at the same grid
     against its plain version and ``F.grid_sample``;
  4. main path: ``convex_adam`` with the default config on the 192^3 headline
     pair (seed 0, shift (5, -4, 3)): the shift must be recovered and every
     kernel launched (mind / cost volume / inverse-consistency steps / data
     term 2 / 2 / 15 / 80 per registration, no plain sampler launch); the golden 48^3
     fixture must stay inside the JAX package's f32 and bf16 envelopes;
  4g. the same registration at ``mind_r=4, mind_d=1``: two launches of
     ``mind_general_kernel`` (counted and seen by the profiler), none of a
     compiled MIND kernel, the other kernels as in 4, the shift recovered;
     seconds;
  4c. evaluation path: ``evaluate_field`` of the registered field on a
     synthetic 13-organ label pair (seed 0, the same shift; one liver-sized
     organ, twelve of 6-20 voxel semi-axes) with 20
     keypoints: Dice > 0.9 and HD95 <= 2 voxels on every label, one batched
     pruned-search launch per label bucket (2); with the pruned search switched off, identical
     HD95 from 13 dual and 26 tiled launches; on the zero field, HD95 equal
     to the host scipy-EDT ``hd95`` to 1e-5; evaluation and host times;
  4d. semantic entry: ``convex_adam_semantic_torch`` with the default config
     (bf16 features) on a 13-organ label pair plus background (14 one-hot
     channels) at the Learn2Reg Abdomen CT-CT shape 192 x 160 x 256, moving =
     fixed rolled by the headline shift: launches 2 / 15 / 80 (cost volume,
     inverse-consistency steps, data term), no MIND, sampler or backward
     launch; the shift recovered
     on every axis within 1 voxel for > 20% and within 2 voxels for > 90%
     of the organ voxels (flat one-hot interiors leave most of the field to
     the regularisers; the JAX package gives the same shares on this pair,
     ``scripts/semantic_shift_share.py``); ``evaluate_field`` Dice > 0.9
     and HD95 <= 2 voxels on every organ; median of 3 and peak memory;
  4e. multi-output: ``convex_adam_multi_output`` on the 192^3 headline
     features, 9 finite variants, the (80, 0) variant equal to phase 4's
     single-output field to 1e-5 voxels, one registration's launches;
  4f. autodiff Adam step on 4d's Adam inputs: one gradient through the
     differentiable warp against the fused step (loss 1e-5 relative,
     gradient 1e-4 relative L2), then 80 iterations of each (median |diff|
     < 0.05, p99 < 0.5 voxels), 80 sampler and 80 backward launches;
  5. the sweep (``convexadam_torch.selfconfig``) at the Abdomen shape 192 x
     160 x 256 on three 13-organ subjects (predictions = ground truth),
     pairs (0, 1) and (1, 2):
  5a. ``run_stage1_sweep`` over the first seeded setting of the (grid_sp,
     disp_hw) classes (2, 5), (3, 7), (4, 4) and (5, 2), then over the
     first seeded setting of each of the other 18 classes the seeded
     sampler draws: launches 2 cost volumes and 15 inverse-consistency
     steps per (setting, pair), one pruned search per label bucket per
     case, nothing else; each run's winner's Dice above the identity's;
     every (setting, pair)'s Dice and HD95 equal to ``convex_field_semantic``
     + ``evaluate_field`` composed outside the engine, SDlogJ to 1e-4
     relative, the negative fraction to 1e-6; each composed convex stage
     dense (2 cost volumes, no candidate block) with its peak above what it
     held before at most its ``dense_estimate`` + 1 GB; seconds per setting
     and peak of every class;
  5b. ``run_stage2_sweep`` from 5a's winner over the first seeded Adam
     settings with grid_sp_adam 1, 2, 3 and 4: launches 120 data terms per
     (setting, pair), pass A's 2 + 15 per pair, 16 x buckets pruned searches
     per (setting, pair); the 16 variants of the first pair at grid_sp_adam
     1 and 3 recomputed outside the engine, Dice and HD95 equal to
     ``evaluate_field``'s, at 3 (the Adam grid 64 x 53 x 85) with the first
     calls of each kernel wrapper recorded and held to their plain versions
     as in 7g;
  5c. both paired sweeps on two MIND pairs at 192^3 (20 keypoints each):
     three settings with distinct (r, d), then one Adam setting; 2 MIND
     launches per (setting, pair); the winners' TRE below the initial TRE;
  5d. 5a resumed from its checkpoint with rolled predictions: the same
     arrays, no launch;
  5e. the kernels at shapes only the sweep gives them, against their plain
     versions: the cost volume (to the bit) and the inverse-consistency
     steps of the (2, 5) class (14 x 96 x 80 x 128, q = 5), the data term on
     the grid_sp_adam 1 grid 14 x 192 x 160 x 256 bf16, the batched pruned
     search at the sweep's label buckets, each timed;
  5f. ``selfconfig.protocol.run_full_protocol`` on its sweep fixture (10
     subjects at 192 x 160 x 256, 13 organs, predictions = ground truth),
     the reference's 8 pairs, the first 3 seeded stage-1 settings and the
     first 2 stage-2 settings: launches per (setting, pair) of each stage
     (2 cost volumes and 15 IC steps; pass A's, then 120 data terms; one
     batched pruned search per label bucket per case, two launches for the
     4-organ K = 36864 bucket), both winners above the identity's Dice;
     then stopped by a fault injected into the engine after stage-1 setting
     2, resumed and stopped after stage-2 setting 1, resumed to the end:
     arrays, ranks and winners equal to the uninterrupted run's to the bit,
     each resume launching only for the unfinished settings; then the
     batched pruned search at the fixture's 7 label buckets on the first
     pair's labels warped by the stage-1 winner, against its plain version
     (tolerance 0, the same tiles, each bucket's launches as
     ``pruned_launch_count`` says: the two-launch bucket's second part);
  6. the file-level path, from NIfTI files written under ``chiprun_out/phase6``
     (removed afterwards), every kernel count set to 0 just before each run:
  6a. ``cli.register.main`` with ``--use_mask True`` on a masked MIND pair at
     192 x 160 x 256 (the headline texture and shift, an ellipsoidal body
     mask moved with the image): launches 2 / 2 / 15 / 80, ``disp.nii.gz``
     equal to ``convex_adam(mask_infill(...))`` on the files' arrays to the
     bit, the fixed image's affine, the shift within 1 voxel on > 90% of the
     crop; then ``--multi_iters 40,60,80 --multi_smoothings 0``: three files
     (cut from nine), (80, 0) equal to the single-output field to the bit;
  6b. ``cli.apply.main`` with 6a's field: equal to ``map_coordinates_trilinear``
     composed outside to the bit, a smaller SSD to the fixed image than the
     unwarped image's in the crop;
  6c. ``convex_adam_translation`` on ``MedicalImage``s of 128 x 128 x 96 at
     (1.5, 1.5, 2.0) mm (192^3 at 1 mm) whose origins differ by (2, -3, 1)
     voxels, plain and masked mean: the translation equal to the truth;
  6d. the task driver at the Abdomen shape on phase 5's three subjects with
     CT-like intensities (``AbdomenCTCT``: images, labels, a 13-organ labels
     table, one validation and one test pair): ``L2RTask.load`` →
     ``run_validation_grid`` over one setting, both arms (iterations cut to
     80) → ``select_winner`` → ``run_testset``; launches 2 / 2 / 15 / 80 (MIND)
     and 0 / 2 / 15 / 80 (nnUNet) an arm and case, one pruned search per
     label bucket per evaluation; every variant recomputed outside the task driver,
     its metrics equal to ``evaluate_field``'s and its file to its field; the
     winner's Dice above the identity's; the host split per case (load,
     register, evaluate, write);
  6e. ``cli.l2r.main`` on a 64 x 48 x 64 task with its own six settings: a
     ``WINNER`` line, 108 validation fields and the test field;
  6f. ``cli.sweep.main(["infer", ...])`` from 6d's label files: launches 2 /
     15 / iterations (cost volume, IC steps, data term), Dice above the
     identity's;
  7. the Learn2Reg challenge recipes (``convexadam_torch.pipeline.
     challenges``) at their published shapes, each run with every kernel
     count set to 0 just before it, printing its seconds, peak memory and
     launches:
  7a. task 1 (Abdomen MR-CT) at 192 x 160 x 192: ``register_tps_densified``
     with its defaults (disp_hw 8 through the general kernel, IC, Adam at
     grid 3 for 40 iterations, 4096 TPS control points) equal to
     ``convex_adam`` + the densification composed outside to the bit, the
     shift recovered (> 90% of the central box within 1 voxel); then
     ``task1_field_to_original`` onto a 240 x 200 x 240 grid;
  7b. task 2 (lung CT) at 192 x 192 x 208 with two ellipsoidal lungs:
     ``task2_case`` equal to ``convex_adam(mask_infill(...), TASK2_CONFIG)``
     to the bit, the shift recovered inside the lungs;
  7c. task 3 (OASIS) at 160 x 192 x 224 with 35 structures and the
     background, per-pair and template weights: one SAD launch, equal to
     the composition outside to the bit, median error under 0.5 voxels;
  7d. CuRIOUS at 256 x 256 x 288 on case 1's landmarks
     (``tests/curious_landmarks.npz``) with a synthetic anatomy warped by a
     TPS through the real landmark shift: ``curious_case`` with its
     defaults, deformable and rigid TRE below the identity TRE;
  7e. the (grid_sp 2, disp_hw 7) class at 192 x 160 x 256 both ways:
     streamed (``stream_threshold=0``) equal to dense to the bit, both peaks;
     the natural dispatch at 256 x 256 x 320 (above the threshold) streams;
  7f. the 192^3 headline registration with ``adam_sample_stride`` 2 and 3:
     80 strided data terms each, the shift recovered (> 90% of the central
     box within 1 voxel), central p95 |diff| to phase 4's field under 0.5
     voxels at stride 2 (recorded at 3);
  7g. 7a-7f's recipes (task 3 with its own weights, 7e's natural dispatch)
     run again with the arguments of the first three calls of each kernel
     wrapper they reach recorded (every kernel launched must have a
     recorded call); each recorded call through the kernel and its plain
     version, to the bit (the data term's ``sum(res^2)`` to 1e-5
     relative), the first of each kernel and recipe timed;
  8. the segmentation front end (``convexadam_torch.models``), with the
     packaged ``unet3d_anatomies`` checkpoint:
  8a. the held-out bent tube of ``tests/regen_unet_anatomies.py`` (96 x 96
     x 56, 12 windows of 64 x 64 x 28): Dice > 0.7, the card's blended
     logits within 1e-4 of the port's CPU run, labels apart only where the
     CPU's two-class margin is below 2e-4; ms a window (TF32 off; on, for
     information) and windows a second;
  8b. ``convex_adam_semantic_from_images`` at 192 x 160 x 256 (360 windows
     a volume) on the checkpoint's four anatomies at their 96 x 96 x 56
     scale, the moving image the fixed one rolled by (5, -4, 3) with a
     fresh texture: launches 0 / 2 / 15 / 80, the kernels' calls of the
     warm-up run recorded and held to their plain versions as in 7g, the
     field equal to the normalisation, window labels and ``convex_adam_semantic_torch``
     composed outside to the bit (each stage timed), label Dice > 0.7 in
     both volumes, the warped moving truth's Dice above the identity's by
     0.1; peak memory;
  9. the multi-device layer (``convexadam_torch.parallel``):
  9a. ``register_pairs_batched`` on two 192^3 headline pairs, each field
     equal to its lone call; ``device_usage``, ``stage_timer``,
     ``profile_trace`` and ``probe_device_count() == 1``; the sweep CLI with
     ``--mesh`` over an NCCL group of one rank equal to the CLI without it
     (two of 5a's classes);
  9b. two gloo ranks sharing the card (subprocesses of this script with
     ``--rank``, a free localhost port and a deadline):
     ``convex_displacement_tp`` at the (2, 7) class on 7e's features, both
     directions, every rank's field equal to 7e's dense field and to the
     fields gathered from the ranks to the bit, one candidate-block launch
     a rank and direction, held to its plain version to the bit; each
     rank's seconds and peak;
  9c. the same ranks: 5a's ``run_stage1_sweep`` on a (setting 2, pair 1)
     grid, ``dice``, ``jstd``, ``hd95``, ``rank`` and ``best`` equal to
     5a's to the bit on both;
  9d. four gloo ranks sharing the card (``--space-rank``):
     ``register_pairs_sharded(..., shard_space=True)`` at the default config,
     the 192^3 headline pair split along H over a (pair 1, space 4) grid and
     9a's two pairs over a (pair 2, space 2) grid: every rank's fields equal
     to phase 4's lone field (and 9a's second) to the bit, launches a rank
     2 / 2 / 15 / 80, each rank's recorded cost-volume and data-term calls
     (a slab's moving row offset and first lattice row) held to their plain
     versions; each rank's seconds, peak memory and halo bytes; then a
     12 x 32 x 32 pair (three slab units of 4 rows for four ranks, the last
     holding none) over (pair 1, space 4): every rank's field equal to the
     one-process field to the bit, no MIND, cost-volume or data-term launch
     on the rank of no rows;
  10. output: one JSON line per result, ``{"phase6": {...}}``,
     ``{"phase7": {...}}``, ``{"phase8": {...}}``, ``{"phase9": {...}}``,
     ``{"kernels": [...]}`` (thirteen records: the
     eight Pallas functions' kernels, the inverse-consistency steps and the
     four variants, SAD, candidate block, general cost volume and strided
     data term, each with its launches on every path, phase 6's under
     ``launches_file``, phase 7's under ``launches_challenges``, 8b's under
     ``launches_segmentation``, 9a-9d's (per rank) under
     ``launches_parallel``, and 7g's and 8b's readings under
     ``at_challenge_shape`` and ``at_segmentation_shape``,
     the MIND calls with their bound) second to last, then ``{"ok":
     true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package, and exits non-zero without
a result when no CUDA device is visible.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM datasheet peaks: HBM bytes/s, f32 FLOP/s (fused multiply-adds
# count two), and separately rounded f32 operations a second (132 SMs x 128
# lanes x 1.98 GHz: an operation that cannot fuse takes a lane's whole clock)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F32_UNFUSED = 33.5e12
# torch.profiler sessions a kernel's device time is read from at most, one
# after another (late in the run a session can see no device event at all,
# several in a row; device_times)
PROFILER_SESSIONS = 10

HEADLINE_SHAPE = (192, 192, 192)
HEADLINE_SHIFT = (5, -4, 3)
IC_ITERS = 15  # the pipeline's inverse-consistency steps
EXPECTED_LAUNCHES = {
    "mind_ssd_stats": 2, "cost_volume": 2, "sample_trilinear_ic": IC_ITERS,
    "warp_ssd_loss_grad": 80, "sample_trilinear": 0, "sample_trilinear_bwd": 0,
}
MIND_PAIRS = [(r, d) for r in (1, 2, 3) for d in (1, 2, 3)]  # the search's MIND radii, dilations
# pairs outside {1, 2, 3}^2, which run the general kernel: every pair whose
# old dispatch key r * 4 + d fell on a compiled pair's, a radius or a
# dilation of 0, (4, 1) (the halo staged), halos past shared memory ((5, 5),
# (1, 12), (6, 6): operands from global memory) and past the crop ((8, 16))
MIND_GENERAL_PAIRS = [(0, 5), (0, 9), (1, 5), (1, 6), (1, 7), (1, 9), (2, 5), (2, 7), (0, 2),
                      (1, 0), (4, 1), (5, 5), (1, 12), (6, 6), (8, 16)]
# the 192^3 cases of phase 3a besides the main path's (1, 2), all timed: the
# general kernel at (4, 1), (1, 5) and (6, 6), the compiled (3, 3) beside it
MIND_TIMED = [((3, 3), "bfloat16"), ((4, 1), "bfloat16"), ((3, 3), "float32"),
              ((4, 1), "float32"), ((1, 5), "bfloat16"), ((6, 6), "bfloat16")]
GENERAL_MIND = (4, 1)  # phase 4g's (mind_r, mind_d)
RAGGED_SHAPE = (37, 41, 29)
# wider than one 64-voxel D tile of the compile-time MIND kernel and not a
# multiple of it: a tile seam, a partial last tile, and paired stores (even
# D) or single ones (odd D)
MIND_WIDE_SHAPES = ((37, 41, 150), (37, 41, 131))
# phase 3b's cost volumes (C, h, w, d) beside the main path's: the semantic
# entry's coarse grid (192 x 160 x 256 at grid_sp 6, q = 4), the stage-1
# sweep's largest (192 x 160 x 256 at grid_sp 3, at its widest q, 7), and
# ragged crops across the compiled kernel's 4 x 32 tiles and the general
# kernel's 8 x 16 ones (partial j and l tiles), 16-channel chunks (C = 21),
# with d = 37 and 70 (not multiples of 4: stores through shared memory) and
# d = 40 (16-byte stores), run at every q in 1..7, which run the compiled
# kernel, and at q = 0, 8 and 9, which run the general kernel (one warp; 17
# kw over 9 warps in two rounds; 19 over 7 in three, and a last kd block of
# 1 and of 3)
COST_VOLUME_SEMANTIC = (14, 32, 26, 42)
COST_VOLUME_SWEEP = (12, 64, 53, 85)
SWEEP_Q = 7
COST_VOLUME_RAGGED = ((12, 9, 11, 37), (14, 7, 10, 40), (21, 6, 9, 70))
RAGGED_Q = range(10)
RAGGED_BLOCK_Q = (0, 1, 4, 7, 8, 9)  # candidate blocks of both kernels
L2R_LABELS = 13  # the organ count of Learn2Reg's Abdomen CT-CT task
L2R_MARGIN = 36  # voxels from every face: inside the crop phase 4 checks
L2R_LARGE_AXES = (35, 41)  # semi-axis range of the liver-sized organ
L2R_BUCKETS = 2  # the label buckets of the pair: the liver-sized organ at K = 16384, the rest at 4096
# one batched pruned launch per bucket
EXPECTED_EVAL_LAUNCHES = {"nearest_sq_pruned": L2R_BUCKETS, "nearest_sq_dual": 0,
                          "nearest_sq": 0}
EXPECTED_TILED_EVAL_LAUNCHES = {"nearest_sq_pruned": 0, "nearest_sq_dual": L2R_LABELS,
                                "nearest_sq": 2 * L2R_LABELS}
ABDOMEN_SHAPE = (192, 160, 256)  # Learn2Reg Abdomen CT-CT
ABDOMEN_MARGIN = 12  # voxels from every face: more than the shift, so no organ wraps
SEMANTIC_LABELS = L2R_LABELS + 1  # the one-hot channels: 13 organs and the background
EXPECTED_SEMANTIC_LAUNCHES = {
    "mind_ssd_stats": 0, "cost_volume": 2, "sample_trilinear_ic": IC_ITERS,
    "warp_ssd_loss_grad": 80, "sample_trilinear": 0, "sample_trilinear_bwd": 0,
}
EXPECTED_AUTODIFF_LAUNCHES = {
    "sample_trilinear": 80, "sample_trilinear_bwd": 80, "warp_ssd_loss_grad": 0,
    "sample_trilinear_ic": 0,
}
REPLACES = {
    "mind_ssd_stats": "convexadam_tpu/ops/mind_pallas.py:196",
    "cost_volume": "convexadam_tpu/ops/cost_volume_pallas.py:96",
    "sample_trilinear": "convexadam_tpu/ops/warp_pallas.py:163",
    "sample_trilinear_ic": "convexadam_tpu/ops/warp_pallas.py:163",
    "sample_trilinear_bwd": "convexadam_tpu/ops/warp_pallas.py:348",
    "warp_ssd_loss_grad": "convexadam_tpu/ops/warp_pallas.py:268",
    "nearest_sq": "convexadam_tpu/ops/edt_pallas.py:79",
    "nearest_sq_dual": "convexadam_tpu/ops/edt_pallas.py:181",
    "nearest_sq_pruned": "convexadam_tpu/ops/edt_pallas.py:290",
    # variants: the SAD metric and the candidate blocks replace the XLA scans
    # the JAX package runs for them beside the Pallas SSD kernel (its only
    # SAD, and its streamed path's per-candidate cost); the general kernel and
    # the strided data term are the Pallas functions' own
    "cost_volume_sad": "convexadam_tpu/core/cost_volume.py:131",
    "cost_volume_block": "convexadam_tpu/core/convex.py:141",
    "cost_volume_general": "convexadam_tpu/ops/cost_volume_pallas.py:96",
    "warp_ssd_loss_grad_strided": "convexadam_tpu/ops/warp_pallas.py:268",
    "mind_ssd_stats_general": "convexadam_tpu/ops/mind_pallas.py:196",
}
SOURCES = {
    "mind_ssd_stats": "convexadam_torch/csrc/mind.cu",
    "cost_volume": "convexadam_torch/csrc/cost_volume.cu",
    "sample_trilinear": "convexadam_torch/csrc/warp.cu",
    "sample_trilinear_ic": "convexadam_torch/csrc/warp.cu",
    "sample_trilinear_bwd": "convexadam_torch/csrc/warp.cu",
    "warp_ssd_loss_grad": "convexadam_torch/csrc/warp.cu",
    "nearest_sq": "convexadam_torch/csrc/edt.cu",
    "nearest_sq_dual": "convexadam_torch/csrc/edt.cu",
    "nearest_sq_pruned": "convexadam_torch/csrc/edt.cu",
    "cost_volume_sad": "convexadam_torch/csrc/cost_volume.cu",
    "cost_volume_block": "convexadam_torch/csrc/cost_volume.cu",
    "cost_volume_general": "convexadam_torch/csrc/cost_volume.cu",
    "warp_ssd_loss_grad_strided": "convexadam_torch/csrc/warp.cu",
    "mind_ssd_stats_general": "convexadam_torch/csrc/mind.cu",
}
# the __global__ functions each wrapper launches, as the profiler names them
GLOBALS = {
    "mind_ssd_stats": ("mind_kernel",),
    "cost_volume": ("cost_volume_kernel",),
    "sample_trilinear": ("sample_trilinear_kernel",),
    "sample_trilinear_ic": ("ic_step_kernel",),
    "sample_trilinear_bwd": ("sample_trilinear_bwd_kernel",),
    "warp_ssd_loss_grad": ("warp_ssd_kernel", "sum_partials_kernel"),
    "nearest_sq": ("nearest_sq_kernel",),
    "nearest_sq_dual": ("nearest_sq_dual_kernel",),
    "nearest_sq_pruned": ("nearest_sq_pruned_kernel",),
    "cost_volume_sad": ("cost_volume_kernel", "cost_volume_general_kernel"),
    "cost_volume_block": ("cost_volume_kernel", "cost_volume_general_kernel"),
    "cost_volume_general": ("cost_volume_general_kernel",),
    "warp_ssd_loss_grad_strided": ("warp_ssd_kernel", "sum_partials_kernel"),
    "mind_ssd_stats_general": ("mind_general_kernel",),
}
# phase 5, the sweep at the Abdomen shape, its depth cut to two pairs, the
# first seeded stage-1 setting of each of the 22 (grid_sp, disp_hw) classes
# the seeded sampler draws, and the first seeded stage-2 setting of each
# grid_sp_adam: three subjects (one organ layout rolled by three shifts); a
# sweep of four classes (the largest dense class, the widest displacement,
# the commonest class and the smallest), whose result 5b-5d and 9c use, then
# one of the other 18; two MIND pairs for the paired sweeps
SWEEP_SHIFTS = ((0, 0, 0), HEADLINE_SHIFT, (-3, 4, -2))
SWEEP_PAIRS = ((0, 1), (1, 2))
SWEEP_CLASSES = ((2, 5), (3, 7), (4, 4), (5, 2))  # (grid_sp, disp_hw)
SWEEP_ADAM_GRIDS = (1, 2, 3, 4)
# 5b's settings whose 16 variants of one pair are recomputed outside the
# engine: grid_sp_adam 1, and 3 (the first Adam grid that does not divide
# the volume, 64 x 53 x 85), whose kernel calls are also recorded and held
SWEEP_RECOMPUTED_GRIDS = (1, 3)
# the convex stage's peak above what it holds before, at most its dense
# estimate and this: the one-hot features made at full resolution before
# they are pooled (two volumes, 0.88 GB, and one volume's boolean mask)
SWEEP_PEAK_MARGIN_GB = 1.0
ADAM_ITERS = 120  # the sweep's Adam iterations (settings.STAGE2_SNAPSHOT_ITERS' last)
PAIRED_SHIFTS = (HEADLINE_SHIFT, (-4, 3, 5))
PAIRED_KEYPOINTS = 20
SWEEP_CHECKPOINT = OUT_DIR / "sweep_stage1"
# phase 5f, the whole protocol (`run_full_protocol`) at full width and
# pair depth, its settings cut: the sweep fixture of
# `selfconfig/protocol.py` (10 subjects, 13 organs) at this shape, the
# reference's 8 pairs, the first seeded
# stage-1 settings (classes (3, 3), (2, 2), (4, 4)) and stage-2
# settings (grid_sp_adam 2, 3); a crash injected once this many settings of
# stage 1, then of stage 2, have finished (at the second pair of the next)
PROTOCOL_SHAPE = ABDOMEN_SHAPE
PROTOCOL_SETTINGS = (3, 2)
PROTOCOL_CRASH = (2, 1)
PROTOCOL_CRASH_PAIR = 2
PROTOCOL_DIR = OUT_DIR / "protocol5f"
# phase 6, the file-level path: inputs written as NIfTI under FILE_DIR with a
# CT-like affine (0.8 x 0.8 x 1.5 mm), the masked MIND pair at the Abdomen
# shape, the translation case (128 x 128 x 96 voxels of 1.5 x 1.5 x 2.0 mm,
# 192^3 at 1 mm, moved by whole voxels), the task driver on phase 5's three
# subjects (one setting, both arms, every variant), a small task for the
# l2r CLI's own six settings, and test-set inference from label files
FILE_DIR = OUT_DIR / "phase6"
FILE_AFFINE = np.array([[0.8, 0.0, 0.0, -76.4], [0.0, 0.8, 0.0, -60.2],
                        [0.0, 0.0, 1.5, -190.0], [0.0, 0.0, 0.0, 1.0]])
FILE_CROP = 32  # voxels from every face, as phase 4's crop
BODY_AXES = 0.6
FILE_MULTI_ITERS = (40, 60, 80)
# 6a's multi-output run cut from the CLI's nine variants ({0, 3, 5}
# smoothings) to the three unsmoothed ones: three 94 MB fields, not nine (six
# gzips of 5-6.5 s each fewer), to keep the script's time as phase 7 joins it
FILE_MULTI_SMOOTHINGS = (0,)
TRANSLATION_SIZE = (128, 128, 96)  # (x, y, z)
TRANSLATION_SPACING = (1.5, 1.5, 2.0)
TRANSLATION_VOXELS = (2, -3, 1)  # the moving image's origin shift, (x, y, z) voxels
L2R_TASK = "AbdomenCTCT"
L2R_GRID = ([6], [4], [1.25])  # (grid_sp, disp_hw, lambda) of 6d's one setting
# 6d's iteration list cut from the task driver's (40, 60, 80) to (80,): three
# fields an arm, not nine (the host's gzip of each 94 MB field takes about 5 s)
L2R_GRID_ITERS = (80,)
L2R_SMALL_TASK = "SmallCT"
L2R_SMALL_SHAPE = (64, 48, 64)
INFER_ADAM_S2 = 5  # the decoded variant: 80 iterations, one extra box pass
# targets of phase 3e's tiled case past the card's 65535 target chunks of
# 1024 on the grid's y axis
TILED_GRID_KT = 65535 * 1024 + 1000
# FP32 operations per distance cell of the search kernels (three
# multiply-adds for the cross term, the two norms' add, the min)
CELL_FLOPS = 8
# phase 3b's variants: task 3's coarse grid (OASIS 160 x 192 x 224 at
# grid_sp 2, 36 one-hot channels, q = 3, SAD), task 1's (192 x 160 x 192 at
# grid_sp 4, 12 MIND channels, q = 8: the general kernel), and the (grid_sp
# 2, disp_hw 7) class's grid at the Abdomen shape for a candidate block
COST_VOLUME_TASK3 = (36, 80, 96, 112)
COST_VOLUME_TASK1 = (12, 48, 40, 48)
TASK1_Q = 8  # task 1's disp_hw (pipeline/challenges.py)
COST_VOLUME_STREAM = (14, 96, 80, 128)
# phase 3d's strided data term: strides 2 and 3 on the main path's Adam grid
# and on a ragged grid that neither divides (7f registers at both)
DATA_TERM_STRIDES = (2, 3)
# phase 7, the challenge recipes at their published shapes: Learn2Reg 2021
# task 1 Abdomen MR-CT (preprocessed at 2 mm) with an original CT grid of
# 240 x 200 x 240 at 1.6 mm (the same extent), task 2 lung CT, task 3 OASIS
# with 35 structures and background, CuRIOUS 2020 in the reference's
# resampled space (case 1's landmarks); the streamed class and a shape above
# the dense threshold; the strided data term on the headline pair
TASK1_SHAPE = (192, 160, 192)
TASK1_SHIFT = (3, -2, 2)
TASK1_ORIGINAL = ((240, 200, 240), (1.6, 1.6, 1.6))
TASK2_SHAPE = (192, 192, 208)
TASK2_SHIFT = (4, -3, 2)
TASK3_SHAPE = (160, 192, 224)
TASK3_LABELS = 36
TASK3_SHIFT = (2, -3, 1)
TASK3_SCALE = 24  # box width of the smoothing that sets the structures' size
CURIOUS_CASE = 1
STREAM_CLASS = (2, 7)  # (grid_sp, disp_hw)
STREAM_NATURAL_SHAPE = (256, 256, 320)
# phase 7g: the wrappers whose calls it records, by the module each recipe
# calls them through, and how many calls of each it records in each recipe
CAPTURE_SITES = (("convexadam_torch.core.features", "mind_ssd_stats"),
                 ("convexadam_torch.core.cost_volume", "cost_volume"),
                 ("convexadam_torch.core.convex", "cost_volume_block"),
                 ("convexadam_torch.core.warp", "inverse_consistency_steps"),
                 ("convexadam_torch.core.warp", "warp_ssd_loss_grad"))
CAPTURE_CALLS = 3
# phase 8, the segmentation front end: the packaged anatomy checkpoint on its
# held-out case (a bent tube, tests/regen_unet_anatomies.py, whose numpy
# generators are copied below), then the entry from raw images at the
# Abdomen shape, tiled with 96 x 96 x 56 cases of the checkpoint's four
# anatomies in turn, each synthesised and z-scored as the checkpoint's
# training cases are (the network has seen no other scale and no other
# intensity statistics; a volume z-scored as a whole has far fewer
# foreground voxels, and the network then finds foreground in the
# background); later tiles overwrite the overlaps.  Raw intensities are
# offset + scale x z, all positive, so the entry's nnU-Net normalisation (a
# z-score over the positive voxels) gives back the tiles' z-scores.  The
# moving image is the same tiling with fresh textures, rolled by the
# headline shift (no anatomy lies within the shift of a face)
SEG_CHECKPOINT = "unet3d_anatomies"
SEG_SHAPE = (96, 96, 56)
SEG_ANATOMIES = ("ellipsoid_notch", "twin_blobs", "shell", "bent_tube")
SEG_HOLDOUT = "bent_tube"
SEG_HOLDOUT_SEED = 999
SEG_TILES = ((0, 96), (0, 64), (0, 56, 112, 168, 200))  # tile origins along H, W, D
SEG_TEXTURE_SEEDS = (1001, 2001)  # + the tile's index: the fixed and the moving image
SEG_RAW = (100.0, 20.0)
SEG_WINDOWS = 5 * 4 * 18  # 64 x 64 x 28 windows at step 0.5 over 192 x 160 x 256
SEG_LOGIT_TOL = 1e-4  # the card's blended logits against the port's CPU run
SEG_MARGIN = 2e-4  # labels may differ only where the CPU's two-class margin is below
SEG_DICE = 0.7  # tests/test_segmentation.py:229's held-out gate
SEG_GAIN = 0.1  # warped Dice over the identity's, tests/test_segmentation.py:127
# phase 9, the multi-device layer: two headline pairs batched; the sweep CLI
# with --mesh over an NCCL group of one; two gloo ranks sharing the card as
# subprocesses (a free localhost port, a deadline), running the (2, 7) class
# tensor-parallel on 7e's features and 5a's stage-1 sweep on a (setting 2,
# pair 1) grid
PARALLEL_RANKS = 2
PARALLEL_DEADLINE_S = 420
PARALLEL_GROUP_TIMEOUT_S = 180
PARALLEL_DIR = OUT_DIR / "phase9"
# phase 9d: gloo ranks sharing the card, each 192^3 pair split along H over
# the space axis of these (pair, space) grids; the wrappers whose kernels
# take a slab's offsets (the moving row offset, the data term's first row)
SPACE_RANKS = 4
SPACE_GRIDS = ((1, 4), (2, 2))
# 9d's short case: 12 rows hold three slab units of 4 (the test config's
# grid_sp 4 and grid_sp_adam 2) for four ranks, so the last holds none
SPACE_TINY_SHAPE = (12, 32, 32)
SPACE_TINY_CONFIG = dict(grid_sp=4, disp_hw=2, selected_niter=10, grid_sp_adam=2)
SPACE_TINY_SHIFT = (2, -1, 1)
SPACE_HELD = ("cost_volume", "warp_ssd_loss_grad")
SPACE_DEADLINE_S = 300
CLI_MESH_CLASSES = ((4, 4), (5, 2))  # 9a's CLI settings: phase 5a's two quickest classes


def cuda_ms(torch, fn, warmup: int = 3, reps: int = 20) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_times(torch, fn, kernels=None, warmup: int = 3, reps: int = 20) -> dict:
    """Device time of ``fn`` per call from ``torch.profiler`` over ``reps``
    calls after warm-up: ``device_ms``, the summed CUDA time of the kernels
    whose names contain one of ``kernels`` (every device event where
    ``kernels`` is None), ``device_all_ms`` of every device event,
    ``device_launches``, the selected kernels' launches per call, and
    ``device_kernels``, the names of every device event.  A session
    in which the profiler saw none of the selected kernels is profiled again
    at once, up to :data:`PROFILER_SESSIONS`: the profiler can miss a short
    kernel, and late in this script it can see no device event at all for
    several sessions in a row; a kernel that does not run misses every
    session."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for session in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        own = every = 0.0
        launches = 0
        seen = []
        for e in prof.key_averages():
            # device events only: CPU ops and user annotations carry the
            # device time of what they launch, which would count it twice
            if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
                continue
            every += e.self_device_time_total
            seen.append(e.key)
            if kernels is None or any(k in e.key for k in kernels):
                own += e.self_device_time_total
                launches += e.count
        if own > 0 or session == PROFILER_SESSIONS - 1:
            break
        print(f"  the profiler saw no {kernels or 'device event'} (saw {seen}); profiling again",
              flush=True)
    check(own > 0, f"the profiler saw no device time of {kernels or 'the call'} (saw {seen})")
    return {"device_ms": own / 1e3 / reps, "device_all_ms": every / 1e3 / reps,
            "device_launches": launches / reps, "device_kernels": sorted(set(seen))}


def timed_turns(torch, kern, kernels, lib=None) -> dict:
    """``call_ms`` (:func:`cuda_ms`) and ``device_ms`` (:func:`device_times`
    of the ``kernels`` it launches) of a wrapper call ``kern`` and of the
    library call ``lib`` that computes the same function (every device
    kernel it runs), taken in turns: kernel, library, library, kernel (two
    kernel readings where there is no library call).  Each figure is the
    mean of its two readings; the readings are kept."""
    order = ("kernel", "library", "library", "kernel") if lib is not None else ("kernel",) * 2
    readings: dict = {"kernel": [], "library": []}
    for who in order:
        fn = kern if who == "kernel" else lib
        readings[who].append({"call_ms": cuda_ms(torch, fn),
                              **device_times(torch, fn, kernels if who == "kernel" else None)})
    out = {"readings": readings}
    for who, prefix in (("kernel", ""), ("library", "library_")):
        for key in ("call_ms", "device_ms", "device_all_ms"):
            vals = [r[key] for r in readings[who]]
            out[prefix + key] = float(np.mean(vals)) if vals else None
    out["device_launches"] = readings["kernel"][0]["device_launches"]
    return out


def bound_ms(nbytes: float, flops: float, rate: float = PEAK_F32_FLOPS) -> "tuple[float, str]":
    """The least time of the work: ``nbytes`` at the HBM rate or ``flops``
    at ``rate`` (the FP32 peak; :data:`PEAK_F32_UNFUSED` for operations that
    cannot fuse), whichever is longer."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    tf = flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def headline_pair(torch, resize_trilinear, shape=HEADLINE_SHAPE, shift=HEADLINE_SHIFT, seed=0):
    """Smooth random texture and its copy rolled by ``shift`` (the JAX
    package's bench fixture, rebuilt with the port's resize)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal([s // 4 for s in shape]).astype(np.float32)
    vol = resize_trilinear(torch.from_numpy(base)[None], shape)[0].numpy()
    vol = (vol - vol.mean()) / vol.std() * 100
    return vol, np.roll(vol, shift, axis=(0, 1, 2))


def l2r_label_pair(shape=HEADLINE_SHAPE, shift=HEADLINE_SHIFT, n_labels=L2R_LABELS, seed=0,
                   margin=L2R_MARGIN, large_axes=L2R_LARGE_AXES):
    """A synthetic Learn2Reg-like label pair: ``n_labels`` non-overlapping
    ellipsoidal organs, each at least ``margin`` voxels from every face
    (more than the shift, so ``np.roll`` wraps nothing), and the same labels
    rolled by ``shift`` as the moving volume.  The first organ is
    liver-sized (semi-axes drawn from ``large_axes``, by default a surface
    of more than 16384 points), the others have semi-axes of 6-20 voxels."""
    rng = np.random.default_rng(seed)
    seg = np.zeros(shape, np.int32)
    placed = []
    for _ in range(100000):
        if len(placed) == n_labels:
            break
        ax = rng.integers(*(large_axes if not placed else (6, 21)), 3)
        c = np.array([rng.integers(margin + a, s - margin - a) for a, s in zip(ax, shape)])
        if any(np.linalg.norm(c - c2) <= ax.max() + a2 + 2 for c2, a2 in placed):
            continue
        placed.append((c, ax.max()))
        lo, hi = c - ax, c + ax + 1
        zz, yy, xx = np.ogrid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        inside = (((zz - c[0]) / ax[0]) ** 2 + ((yy - c[1]) / ax[1]) ** 2
                  + ((xx - c[2]) / ax[2]) ** 2) <= 1.0
        seg[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]][inside] = len(placed)
    if len(placed) != n_labels:
        raise RuntimeError(f"placed only {len(placed)} of {n_labels} organs")
    return seg, np.roll(seg, shift, axis=(0, 1, 2))


def search_cells(name, kq, kt, nq, nt, hq=0, ht=0, tiles=0) -> int:
    """Distance cells a search needs on these counts: for the tiled search
    every live query against every live target, whatever kernel computes
    them; for the dual kernel whole tiles of its live query blocks x live
    target tiles, the dead head x head corner skipped; for the pruned
    kernel its visited tiles."""
    from convexadam_torch.kernels.edt import PRUNED_BLOCK, PRUNED_TILE, SEARCH_TILE

    if name == "nearest_sq_pruned":
        return int(tiles) * PRUNED_BLOCK * PRUNED_TILE
    if name == "nearest_sq":
        return min(nq, kq) * min(nt, kt)
    b = SEARCH_TILE
    qb = -(-min(nq, kq) // b)
    tb = -(-min(nt, kt) // b)
    live = sum(1 for i in range(qb) for j in range(tb)
               if (i + 1) * b > hq or (j + 1) * b > ht)
    return live * b * b


def kernel_record(name, shape, dtype, err, tol, t, p_ms, nbytes, flops, steps=1,
                  rate=PEAK_F32_FLOPS):
    """One record of the kernels line from :func:`timed_turns`' ``t``;
    every time is divided by ``steps``, the launches of one wrapper call,
    so that the record gives them per launch (``nbytes`` and ``flops`` are
    one launch's, ``flops`` counted at ``rate``)."""
    b_ms, b_by = bound_ms(nbytes, flops, rate)

    def per(v):
        return None if v is None else v / steps

    return {
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "shape": shape, "dtype": dtype, "max_abs_err": err, "tol": tol,
        "ms": per(t["call_ms"]), "kernel_ms": per(t["call_ms"]), "call_ms": per(t["call_ms"]),
        "device_ms": per(t["device_ms"]), "plain_ms": per(p_ms),
        "library_ms": per(t["library_call_ms"]), "library_call_ms": per(t["library_call_ms"]),
        "library_device_ms": per(t["library_device_ms"]),
        "bound_ms": b_ms, "bound_by": b_by, "timing_readings": t["readings"],
    }


def print_times(what, t, p_ms=None, b_ms=None, lib="library") -> None:
    lib_part = (f"; {lib} call {t['library_call_ms']:.4f} ms, device {t['library_device_ms']:.4f} ms"
                if t["library_call_ms"] is not None else "")
    print(f"  {what}: call {t['call_ms']:.4f} ms, device {t['device_ms']:.4f} ms" + lib_part
          + (f"; plain {p_ms:.4f} ms" if p_ms is not None else "")
          + (f"; bound {b_ms:.4f} ms" if b_ms is not None else ""), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def search_cases(torch, dev, seg_f, seg_m):
    """Phase 3e's inputs: ``(cases, groups, caps, bufs)``.  ``cases`` maps
    a case name to one search's points and counts: the largest label
    surface of the phase-4c pair as the engine buffers it ("surface"), a
    large organ's surface at 192^3 ("large") and a ragged case (K and the
    counts not multiples of any block); ``groups``, ``caps`` and ``bufs``
    are the pair's label buckets, caps and label buffers."""
    from convexadam_torch.core.edt import (
        _caps_offsets,
        label_buffers,
        suggest_hd95_caps,
        surface_lists,
    )
    from convexadam_torch.kernels.edt import COORD_PAD

    groups, gcap = suggest_hd95_caps(seg_f, seg_m, L2R_LABELS)
    caps = [0] * (L2R_LABELS + 1)
    for labs, k in groups:
        for lab in labs:
            caps[lab] = k
    caps = tuple(caps)
    pre = surface_lists(torch.from_numpy(seg_f).to(dev), torch.from_numpy(seg_m).to(dev),
                        L2R_LABELS, gcap)
    bufs = label_buffers(pre, L2R_LABELS, caps)
    lab = int(np.argmax(bufs.n_inner_m.cpu().numpy()[1:])) + 1
    k, off = caps[lab], _caps_offsets(caps)[0][lab]

    def part(b):
        return b[:, off:off + k].contiguous()

    cases = {"surface": dict(
        q=part(bufs.inner_m), t=part(bufs.inner_f), t_out=part(bufs.outer_f),
        nq=int(bufs.n_inner_m[lab]), nt=int(bufs.n_inner_f[lab]),
        hq=min(int(bufs.n_inside_m[lab]), k), ht=min(int(bufs.n_inside_f[lab]), k),
        nt_out=int(bufs.n_outer_f[lab]),
    )}
    rng = np.random.default_rng(0)

    def cloud(K, n, extent):
        flat = np.sort(rng.choice(extent ** 3, size=n, replace=False))
        pts = np.full((3, K), COORD_PAD, np.float32)
        pts[:, :n] = np.stack(np.unravel_index(flat, (extent,) * 3))
        return torch.from_numpy(pts).to(dev)

    for name, K, nq, nt, hq, ht, extent in (("large", 65536, 60000, 58000, 20000, 15000, 192),
                                             ("ragged", 5000, 4321, 4777, 1234, 2345, 64)):
        t = cloud(K, nt, extent)
        cases[name] = dict(q=cloud(K, nq, extent), t=t, t_out=t, nq=nq, nt=nt, hq=hq, ht=ht,
                           nt_out=nt)
    return cases, groups, caps, bufs


def _err_at(a, b, lo, hi) -> float:
    return float((a[lo:hi] - b[lo:hi]).abs().max()) if hi > lo else 0.0


def pruned_bucket_rows(torch, bufs, caps, groups, what="batched", plain_reps=20, timed=True):
    """Every search of each label bucket ``(labels, K)`` of ``groups`` in one
    batched call, as the HD95 engine builds them from ``bufs`` and ``caps``,
    against the plain version: tolerance 0 at meaningful entries, the same
    tiles visited; then, with ``timed``, timed.  Returns one row a bucket,
    with the kernel launches of its call (``launches``)."""
    from convexadam_torch.core.edt import pruned_searches
    from convexadam_torch.kernels import LAUNCHES
    from convexadam_torch.kernels import edt as ke

    rows = []
    for labs, K in groups:
        src, searches, lo, hi, nt = pruned_searches(bufs, caps, K, labs)
        args = (src, searches, lo, hi, nt, K, K)
        kern = (lambda a=args: ke.nearest_sq_pruned_batched(*a, with_tiles=True))
        plain = (lambda a=args: ke.nearest_sq_pruned_batched_plain(*a, with_tiles=True))
        before = LAUNCHES["nearest_sq_pruned"]
        ko = kern()
        launches = LAUNCHES["nearest_sq_pruned"] - before
        po = plain()
        torch.cuda.synchronize()
        cname = f"{what} K={K}"
        check(torch.equal(ko[1], po[1]), f"nearest_sq_pruned {cname}: kernel and plain visit "
              "different tiles")
        bounds = list(zip(lo.tolist(), hi.tolist()))
        err = max(_err_at(ko[0][s], po[0][s], a, b) for s, (a, b) in enumerate(bounds))
        tol = 0.0
        check(err <= tol, f"nearest_sq_pruned {cname}: max err {err} > {tol} at meaningful entries")
        S = len(searches)
        tiles = int(ko[1].sum())
        cells = search_cells("nearest_sq_pruned", K, K, 0, 0, tiles=tiles)
        row = {"case": cname, "name": "nearest_sq_pruned", "K": [K, K], "searches": S,
               "labels": list(labs), "launches": launches, "max_abs_err": err, "cells": cells,
               "tiles": tiles}
        said = ""
        if timed:
            gi, gj = K // ke.PRUNED_BLOCK, K // ke.PRUNED_TILE
            nbytes = S * (4 * (3 * K + 3 * K + K) + 8 * gi * gj + 4 * gi)
            times = timed_turns(torch, kern, GLOBALS["nearest_sq_pruned"])
            row.update(ms=times["call_ms"], device_ms=times["device_ms"],
                       device_launches=times["device_launches"],
                       plain_ms=cuda_ms(torch, plain, min(3, plain_reps), plain_reps))
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, CELL_FLOPS * cells)
            said = f", {times['device_launches']:.0f} launches a call"
        print(f"nearest_sq_pruned {cname}: {S} searches in {launches} launch(es), "
              f"max_abs_err {err:.1e} (tol 0), {cells} cells, {tiles} tiles{said}", flush=True)
        if timed:
            print_times(f"nearest_sq_pruned {cname}", times, row["plain_ms"], row["bound_ms"])
        rows.append(row)
    return rows


def search_phase(torch, dev, seg_f, seg_m):
    """Phase 3e: the three search kernels against their plain versions in
    the roles the HD95 engine gives them, tolerance 0 at meaningful entries
    (exact integer arithmetic on both sides), the pruned tiles equal: one
    search at a time on :func:`search_cases`, then every search of each
    label bucket of the pair in one batched call, as the engine builds
    them.  Returns the records of the label-surface case (the evaluation's
    shapes) and every case's numbers."""
    from convexadam_torch.kernels import edt as ke

    cases, groups, caps, bufs = search_cases(torch, dev, seg_f, seg_m)

    records, detail = [], []
    for cname, c in cases.items():
        q, t, t_out = c["q"], c["t"], c["t_out"]
        nq, nt, hq, ht, nto = c["nq"], c["nt"], c["hq"], c["ht"], c["nt_out"]
        kq, kt = q.shape[1], t.shape[1]
        # the counts live on the card, as the engine passes them
        dnq, dnt, dhq, dht, dnto = (torch.tensor([v], dtype=torch.int32, device=dev)
                                    for v in (nq, nt, hq, ht, nto))
        runs = {
            "nearest_sq": (lambda: ke.nearest_sq(q, t_out, dhq, dnto),
                           lambda: ke.nearest_sq_plain(q, t_out, dhq, dnto)),
            "nearest_sq_dual": (lambda: ke.nearest_sq_dual(q, t, dnq, dnt, dhq, dht),
                                lambda: ke.nearest_sq_dual_plain(q, t, dnq, dnt, dhq, dht)),
            "nearest_sq_pruned": (
                lambda: ke.nearest_sq_pruned(q, t, dhq, dnq, dnt, with_tiles=True),
                lambda: ke.nearest_sq_pruned_plain(q, t, dhq, dnq, dnt, with_tiles=True)),
        }
        for name, (kern, plain) in runs.items():
            ko, po = kern(), plain()
            torch.cuda.synchronize()
            tiles = 0
            if name == "nearest_sq":
                err = _err_at(ko, po, 0, hq)
                # past n_query both hold the init, bit for bit
                check(torch.equal(ko[hq:], po[hq:]), f"{name} {cname}: entries past n_query "
                      "differ from the plain version's init")
                cells = search_cells(name, kq, t_out.shape[1], hq, nto)
                nbytes = 4 * (3 * kq + 3 * t_out.shape[1] + kq)
            elif name == "nearest_sq_dual":
                err = max(_err_at(ko[0], po[0], hq, nq), _err_at(ko[1], po[1], ht, nt))
                cells = search_cells(name, kq, kt, nq, nt, hq, ht)
                nbytes = 4 * (3 * kq + 3 * kt + kq + kt)
            else:
                err = _err_at(ko[0], po[0], hq, nq)
                check(torch.equal(ko[1], po[1]), f"{name} {cname}: kernel and plain visit "
                      "different tiles")
                tiles = int(ko[1].sum())
                cells = search_cells(name, kq, kt, nq, nt, tiles=tiles)
                gi, gj = ko[1].numel(), -(-kt // ke.PRUNED_TILE)
                nbytes = 4 * (3 * kq + 3 * kt + kq) + 8 * gi * gj + 4 * gi
            tol = 0.0  # exact integer distances on both sides
            check(err <= tol, f"{name} {cname}: max err {err} > {tol} at meaningful entries")
            row = {"case": cname, "name": name, "K": [kq, kt], "nq": nq, "nt": nt, "hq": hq,
                   "ht": ht, "nt_out": nto, "max_abs_err": err, "cells": cells, "tiles": tiles}
            print(f"{name} {cname} K=({kq}, {kt}): max_abs_err {err:.1e} (tol 0), "
                  f"{cells} cells" + (f", {tiles} tiles" if tiles else ""), flush=True)
            if cname != "ragged":
                times = timed_turns(torch, kern, GLOBALS[name])
                row["ms"], row["device_ms"] = times["call_ms"], times["device_ms"]
                row["plain_ms"] = cuda_ms(torch, plain)
                row["bound_ms"], row["bound_by"] = bound_ms(nbytes, CELL_FLOPS * cells)
                print_times(f"{name} {cname}", times, row["plain_ms"], row["bound_ms"])
            if cname == "surface":
                records.append(kernel_record(
                    name, [kq, kt], "float32", err, tol, times, row["plain_ms"], nbytes,
                    CELL_FLOPS * cells,
                ))
            detail.append(row)

    # the evaluation's searches of this pair as the engine builds them: every
    # search of a label bucket in one batched call, read in place from the
    # label buffers, kernel against plain
    detail += pruned_bucket_rows(torch, bufs, caps, groups)

    # the tiled search's edges: the whole output, init past n_query included
    for cname, q, t, nq, nt in tiled_edge_cases(torch, dev, cases["surface"]):
        dnq, dnt = (torch.tensor([v], dtype=torch.int32, device=dev) for v in (nq, nt))
        ko = ke.nearest_sq(q, t, dnq, dnt)
        po = ke.nearest_sq_plain(q, t, dnq, dnt)
        torch.cuda.synchronize()
        err = _err_at(ko, po, 0, q.shape[1])
        check(torch.equal(ko, po), f"nearest_sq {cname}: max err {err} against the plain version")
        print(f"nearest_sq {cname} K=({q.shape[1]}, {t.shape[1]}), n = ({nq}, {nt}): "
              f"max_abs_err {err:.1e} (tol 0) over every entry", flush=True)
        detail.append({"case": cname, "name": "nearest_sq", "K": [q.shape[1], t.shape[1]],
                       "nq": nq, "nt": nt, "max_abs_err": err,
                       "cells": search_cells("nearest_sq", q.shape[1], t.shape[1], nq, nt)})
        del ko, po
        if t.shape[1] > 65535 * ke.SEARCH_CHUNK:
            # the dual search past the grid's chunk limit: every output entry
            # of both directions, tolerance 0
            kq_o, kt_o = ke.nearest_sq_dual(q, t, dnq, dnt)
            pq_o, pt_o = ke.nearest_sq_dual_plain(q, t, dnq, dnt)
            torch.cuda.synchronize()
            equal = torch.equal(kq_o, pq_o) and torch.equal(kt_o, pt_o)
            err = max(_err_at(kq_o, pq_o, 0, nq), _err_at(kt_o, pt_o, 0, nt))
            check(equal, f"nearest_sq_dual {cname}: max err {err} against the plain version")
            print(f"nearest_sq_dual {cname} K=({q.shape[1]}, {t.shape[1]}), n = ({nq}, {nt}): "
                  f"max_abs_err {err:.1e} (tol 0) over every entry of both outputs", flush=True)
            detail.append({"case": cname, "name": "nearest_sq_dual",
                           "K": [q.shape[1], t.shape[1]], "nq": nq, "nt": nt,
                           "max_abs_err": err})
            del kq_o, kt_o, pq_o, pt_o
        del q, t
    return records, detail


def tiled_edge_cases(torch, dev, surface):
    """The tiled search's edge cases, ``(name, query, target, n_query,
    n_target)``: the surface case with no live query, with no live target
    and with one target fewer (Kt a multiple of neither the tile nor the
    chunk), and a target set of more chunks than the grid's y extent
    (:data:`TILED_GRID_KT`, about 0.8 GB of points), made on the card from a
    seed: 200 live queries in [0, 64)^3, the targets far away in [512,
    1024)^3 but for the last chunk's, near the queries, which only a CTA's
    second stride reaches; past n_target lie copies of the queries, which
    must not win."""
    q, t = surface["q"], surface["t_out"]
    yield "no live query", q, t, 0, surface["nt_out"]
    yield "no live target", q, t, surface["hq"], 0
    t_odd = t[:, :-1].contiguous()
    yield "one target fewer", q, t_odd, surface["hq"], min(surface["nt_out"], t_odd.shape[1])
    g = torch.Generator(device=dev).manual_seed(0)
    kq, nq, kt = 256, 200, TILED_GRID_KT
    q = torch.randint(0, 64, (3, kq), generator=g, device=dev).float()
    t = torch.randint(512, 1024, (3, kt), generator=g, device=dev).float()
    # the last chunk holds the last 1000 targets, the first 900 of them live
    t[:, -1000:-100] = torch.randint(0, 64, (3, 900), generator=g, device=dev).float()
    t[:, -100:] = q[:, :100]
    yield "past the grid's chunk limit", q, t, nq, kt - 100


def general_mind_phase(torch, vol_np, mov_np, results):
    """Phase 4g: ``convex_adam`` on the 192^3 headline pair with the default
    config but (mind_r, mind_d) = :data:`GENERAL_MIND`: two launches of the
    general MIND kernel, counted and seen by the profiler, no compiled MIND
    kernel, the other kernels' launches as the default registration's; the
    headline shift within 1 voxel on > 90% of the central crop; seconds,
    median of 3.  Returns the launches."""
    from torch.profiler import ProfilerActivity, profile

    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, convex_adam

    cfg = ConvexAdamConfig(mind_r=GENERAL_MIND[0], mind_d=GENERAL_MIND[1])
    convex_adam(vol_np, mov_np, cfg, device="cuda")  # warm-up
    torch.cuda.synchronize()
    for session in range(PROFILER_SESSIONS):
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = convex_adam(vol_np, mov_np, cfg, device="cuda")
            torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "mind" in e.key}
        if seen or session == PROFILER_SESSIONS - 1:
            break
    _launch_checks("4g", launches, dict(EXPECTED_LAUNCHES, mind_ssd_stats=0,
                                        mind_ssd_stats_general=2))
    general = sum(n for k, n in seen.items() if "mind_general_kernel" in k)
    check(general == 2 and sum(seen.values()) == 2,
          f"4g: the profiler saw {seen}, expected 2 launches of mind_general_kernel")
    check(out.shape == HEADLINE_SHAPE + (3,) and bool(np.isfinite(out).all()), "4g: bad field")
    c = 32
    err_v = np.abs(out[c:-c, c:-c, c:-c] - np.array(HEADLINE_SHIFT, np.float32))
    frac_ok = float(np.mean(np.all(err_v < 1.0, axis=-1)))
    check(frac_ok > 0.9, f"4g: headline shift recovered in only {frac_ok:.2%} of the crop")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        convex_adam(vol_np, mov_np, cfg, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    results["registration_general_mind"] = {
        "mind_r_d": list(GENERAL_MIND), "frac_within_1vox": frac_ok,
        "mean_abs_err_vox": float(err_v.mean()), "profiled_mind_launches": seen,
        "registration_s_median": float(np.median(times)), "registration_s": times}
    print(f"4g: registration 192^3 at (mind_r, mind_d) = {GENERAL_MIND}: "
          f"{float(np.median(times)):.4f} s (median of 3), {frac_ok:.2%} of the crop within "
          f"1 voxel, mind_general_kernel launches {general}", flush=True)
    return launches


def evaluation_phase(torch, field, seg_f, seg_m, results):
    """Phase 4c: ``evaluate_field`` on the card, its launch counts on both
    search branches, and its HD95 against the host scipy-EDT ``hd95``."""
    import convexadam_torch.core.edt as tedt
    from convexadam_torch import evaluate_field
    from convexadam_torch.core.metrics import hd95
    from convexadam_torch.kernels import LAUNCHES, reset_launches

    rng = np.random.default_rng(1)
    c = L2R_MARGIN
    kf = rng.uniform(c, HEADLINE_SHAPE[0] - c, (20, 3)).astype(np.float32)
    km = kf + np.asarray(HEADLINE_SHIFT, np.float32)

    def run():
        return evaluate_field(field, seg_f, seg_m, L2R_LABELS, kf, km, device="cuda")

    torch.cuda.synchronize()
    reset_launches()
    ev = run()
    launches = dict(LAUNCHES)
    print(f"launches per evaluation: {launches}", flush=True)
    for name, want in EXPECTED_EVAL_LAUNCHES.items():
        check(launches[name] == want, f"{name}: {launches[name]} launches, expected {want}")
    check(ev["dice"].shape == (L2R_LABELS,) and bool((ev["dice"] > 0.9).all()),
          f"registered Dice {ev['dice']} not > 0.9 on every label")
    check(bool((ev["hd95"] <= 2.0).all()), f"registered HD95 {ev['hd95']} above 2 voxels")
    check(bool(np.isfinite(ev["tre"]).all()) and np.isfinite(ev["sdlogj"]), "non-finite metrics")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)

    # the other search branch, as the JAX tests force it
    enabled = tedt._pruned_search_enabled
    tedt._pruned_search_enabled = lambda K: False
    try:
        reset_launches()
        ev_tiled = run()
        launches_tiled = dict(LAUNCHES)
    finally:
        tedt._pruned_search_enabled = enabled
    print(f"launches per evaluation, pruned search off: {launches_tiled}", flush=True)
    for name, want in EXPECTED_TILED_EVAL_LAUNCHES.items():
        check(launches_tiled[name] == want,
              f"{name}: {launches_tiled[name]} launches with the pruned search off, expected {want}")
    check(np.array_equal(ev_tiled["hd95"], ev["hd95"]),
          f"HD95 differs between the branches: {ev['hd95']} vs {ev_tiled['hd95']}")

    # zero field: the engine against the host EDT loop on the unregistered pair
    zero = np.zeros(HEADLINE_SHAPE + (3,), np.float32)
    ev0 = evaluate_field(zero, seg_f, seg_m, L2R_LABELS, device="cuda")
    zero_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_field(zero, seg_f, seg_m, L2R_LABELS, device="cuda")
        zero_times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    host = hd95(seg_f, seg_m, L2R_LABELS)
    host_s = time.perf_counter() - t0
    herr = float(np.abs(ev0["hd95"] - host).max())
    check(herr <= 1e-5, f"zero-field HD95 differs from the host hd95 by {herr}")
    res = {
        "labels": L2R_LABELS, "dice": ev["dice"].tolist(), "dice30": ev["dice30"],
        "hd95": ev["hd95"].tolist(), "tre": ev["tre"].tolist(), "tre30": ev["tre30"],
        "sdlogj": ev["sdlogj"], "neg_jac_frac": ev["neg_jac_frac"],
        "evaluate_s_median": float(np.median(times)), "evaluate_s": times,
        "zero_field_hd95": ev0["hd95"].tolist(), "host_hd95": host.tolist(),
        "zero_field_vs_host_max_abs_err": herr,
        "zero_field_evaluate_s_median": float(np.median(zero_times)),
        "zero_field_evaluate_s": zero_times, "host_hd95_s": host_s,
        "launches": launches, "launches_pruned_off": launches_tiled,
    }
    print(f"evaluate_field 192^3, {L2R_LABELS} labels: {res['evaluate_s_median']:.4f} s "
          f"(median of 3); zero field {res['zero_field_evaluate_s_median']:.4f} s; host hd95 "
          f"{host_s:.2f} s; min Dice {min(res['dice']):.4f}, max HD95 {max(res['hd95']):.4f}, "
          f"zero-field HD95 vs host {herr:.1e}", flush=True)
    results["evaluation"] = res
    return launches, launches_tiled


def sampler_bwd_phase(torch, dev, gen):
    """Phase 3f: ``sample_trilinear_bwd`` against its plain version (to the
    bit) and against ``aten.grid_sampler_3d_backward``'s grid gradient on
    float32 copies (1e-5 relative L2); at the semantic Adam grid also the
    forward sampler, the other kernel of the autodiff step, against its
    plain version (to the bit) and ``F.grid_sample``.  Returns the records
    of the semantic Adam grid in bfloat16 and every case's numbers."""
    import torch.nn.functional as F

    from convexadam_torch.kernels.warp import (
        sample_trilinear,
        sample_trilinear_bwd,
        sample_trilinear_bwd_plain,
        sample_trilinear_plain,
    )

    records, detail = [], []
    for C, shape, dt, vol, grid, ct in adam_sampler_cases(torch, dev, gen):
        n = int(np.prod(shape))
        scale = 0.37
        rk = sample_trilinear_bwd(vol, grid, ct, scale)
        rp = sample_trilinear_bwd_plain(vol, grid, ct, scale)
        g5 = grid.flip(-1).reshape(1, 1, 1, n, 3)
        go = (ct * scale).reshape(1, C, 1, 1, n)
        vf = vol.float()

        def library():
            return torch.ops.aten.grid_sampler_3d_backward(go, vf, g5, 0, 0, False, [False, True])

        lib = library()[1].reshape(n, 3).flip(-1)
        torch.cuda.synchronize()
        tol = 0.0  # the plain version repeats the kernel's operations in its order
        err = max_err(rk, rp)
        check(err <= tol, f"sample_trilinear_bwd {(C, *shape)} {dt}: max err {err} > {tol}")
        half = torch.tensor([s / 2.0 for s in shape], device=dev)
        mine = rk[0].T * half
        lib_rel = float((mine - lib).norm() / lib.norm())
        check(lib_rel <= 1e-5, f"sample_trilinear_bwd {(C, *shape)} {dt} vs grid_sampler_3d_backward: "
              f"relative L2 {lib_rel}")
        print(f"sample_trilinear_bwd {(C, *shape)} {dt}: max_abs_err {err:.3e} (tol {tol:.1e}); "
              f"vs grid_sampler_3d_backward relative L2 {lib_rel:.3e}", flush=True)
        row = {"shape": [C, *shape], "dtype": str(dt), "max_abs_err": err,
               "grid_sampler_3d_backward_rel_l2": lib_rel}
        if C == SEMANTIC_LABELS:
            t = timed_turns(torch, lambda: sample_trilinear_bwd(vol, grid, ct, scale),
                            GLOBALS["sample_trilinear_bwd"], library)
            row["ms"], row["device_ms"] = t["call_ms"], t["device_ms"]
            row["library_ms"], row["library_device_ms"] = t["library_call_ms"], t["library_device_ms"]
            row["plain_ms"] = cuda_ms(torch, lambda: sample_trilinear_bwd_plain(vol, grid, ct, scale))
            # each input read once, the rows written once; per point the
            # setup (about 120 operations), per channel the scaled cotangent
            # and 8 multiply-adds, then 24 derivative weights and their 24
            # multiply-adds (about 110)
            nbytes = vol.numel() * vol.element_size() + 4 * C * n + 12 * n + 12 * n
            flops = float(n) * (17 * C + 230)
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
            print_times(f"sample_trilinear_bwd {dt}", t, row["plain_ms"], row["bound_ms"],
                        "grid_sampler_3d_backward")
            # the forward sampler of the autodiff step at the same grid
            fk, fp = sample_trilinear(vol, grid), sample_trilinear_plain(vol, grid)
            flib = F.grid_sample(vf, g5, align_corners=False).reshape(1, C, n)
            torch.cuda.synchronize()
            ferr = max_err(fk, fp)
            flib_err = float((fk - flib).norm() / flib.norm())
            check(ferr <= tol, f"sample_trilinear {(C, *shape)} {dt}: max err {ferr} > {tol}")
            # F.grid_sample forms its positions and weights with other
            # roundings (an ulp of a position moves a sample of this random
            # volume by up to about 2e-5): 1e-5 relative L2
            check(flib_err <= 1e-5, f"sample_trilinear {(C, *shape)} {dt} vs F.grid_sample: "
                  f"relative L2 {flib_err}")
            tf = timed_turns(torch, lambda: sample_trilinear(vol, grid), GLOBALS["sample_trilinear"],
                             lambda: F.grid_sample(vf, g5, align_corners=False))
            fp_ms = cuda_ms(torch, lambda: sample_trilinear_plain(vol, grid))
            # the volume and the grid read once, the samples written once;
            # per point about 60 operations of setup, per channel 8 corners
            # x (multiply, add)
            fbytes = vol.numel() * vol.element_size() + 12 * n + 4 * C * n
            fflops = float(n) * (16 * C + 60)
            row["forward"] = {"max_abs_err": ferr, "vs_grid_sample_rel_l2": flib_err,
                              "ms": tf["call_ms"],
                              "device_ms": tf["device_ms"], "library_ms": tf["library_call_ms"],
                              "library_device_ms": tf["library_device_ms"], "plain_ms": fp_ms,
                              "bound_ms": bound_ms(fbytes, fflops)[0]}
            print(f"sample_trilinear {(C, *shape)} {dt}: max_abs_err {ferr:.3e} (tol {tol:.1e}); "
                  f"vs F.grid_sample relative L2 {flib_err:.3e}", flush=True)
            print_times(f"sample_trilinear {dt}", tf, fp_ms, row["forward"]["bound_ms"],
                        "F.grid_sample")
            if dt == torch.bfloat16:
                records.append(kernel_record(
                    "sample_trilinear_bwd", [C, *shape], "bfloat16", err, tol, t,
                    row["plain_ms"], nbytes, flops,
                ))
                records.append(kernel_record(
                    "sample_trilinear", [1, C, *shape], "bfloat16", ferr, tol, tf, fp_ms,
                    fbytes, fflops,
                ))
        detail.append(row)
    return records, detail


def ptxas_entry(usage, *parts) -> dict:
    """Registers and spills (``ptxas -v``) of the first kernel of a source
    whose mangled name contains every one of ``parts``."""
    for mangled, use in usage.items():
        if all(p in mangled for p in parts):
            return {"ptxas_kernel": mangled, "registers": use.get("registers"),
                    "spill_stores": use.get("spill_stores", 0),
                    "spill_loads": use.get("spill_loads", 0)}
    raise AssertionError(f"ptxas reported no kernel named like {parts}")


NO_SPILL_KERNELS = ("warp_ssd_kernel", "mind_kernel", "mind_general_kernel",
                    "sample_trilinear_kernel", "cost_volume",
                    "nearest_sq_kernel", "nearest_sq_dual_kernel", "nearest_sq_pruned_kernel")


def ptxas_report(_build) -> dict:
    """Print ptxas's registers and spills for the kernels of ``warp.cu``,
    ``mind.cu``, ``cost_volume.cu`` and ``edt.cu`` and check them: the
    backward sampler fits 64 registers; the data term, the forward sampler,
    every MIND kernel, every cost-volume kernel and the three searches do
    not spill.  Returns every source's report."""
    usage = {name: _build.resource_usage(name) for name in _build.KERNEL_SOURCES}
    for src in ("warp", "mind", "cost_volume", "edt"):
        for mangled, use in usage[src].items():
            print(f"ptxas {src}.cu {mangled}: {use}", flush=True)
            if "sample_trilinear_bwd_kernel" in mangled:
                check(use["registers"] <= 64, f"{mangled}: {use['registers']} registers, over 64")
            if any(k in mangled for k in NO_SPILL_KERNELS):
                check(use.get("spill_stores", 0) + use.get("spill_loads", 0) == 0,
                      f"{mangled} spills: {use}")
    return usage


def cost_volume_cases(torch, fix_s, mov_s, q):
    """Phase 3b's inputs, ``(what, q, fix, mov)``, the main path's case
    first: the headline pair's pooled MIND features ``fix_s``, ``mov_s`` at
    the default half-width ``q``; then seeded features at the semantic grid
    (:data:`COST_VOLUME_SEMANTIC`, ``q``) and the sweep's
    (:data:`COST_VOLUME_SWEEP`, :data:`SWEEP_Q`), and on every
    :data:`COST_VOLUME_RAGGED` crop at each q in :data:`RAGGED_Q`."""
    gen = torch.Generator().manual_seed(1)
    dev = fix_s.device

    def pair(shape, draw):
        return tuple(draw(shape, generator=gen).to(dev) for _ in range(2))

    yield ("default", q, fix_s, mov_s)
    yield ("semantic", q, *pair(COST_VOLUME_SEMANTIC, torch.rand))
    yield ("sweep", SWEEP_Q, *pair(COST_VOLUME_SWEEP, torch.randn))
    for qr in RAGGED_Q:
        for shape in COST_VOLUME_RAGGED:
            yield ("ragged", qr, *pair(shape, torch.randn))


def cost_volume_phase(torch, fix_s, mov_s, q):
    """Phase 3b: ``cost_volume`` against its plain version to the bit on
    :func:`cost_volume_cases`; on the first ragged crop of each q the
    profiler must see one launch of the kernel :func:`kernel_for` names (the
    instantiation for that q, or the general kernel); the default and
    semantic cases are timed with their plain version, the sweep's without.
    Returns the main case's record and every case's numbers."""
    from convexadam_torch.kernels.cost_volume import cost_volume, cost_volume_plain, kernel_for

    record, detail, profiled = None, [], set()
    for what, qc, fix, mov in cost_volume_cases(torch, fix_s, mov_s, q):
        C, h, w, d = fix.shape
        name = f"cost_volume {what} {(C, h, w, d)} q={qc}"
        ck = cost_volume(fix, mov, qc)
        cp = cost_volume_plain(fix, mov, qc)
        torch.cuda.synchronize()
        tol = 0.0  # same float32 operations in the same channel order: to the bit
        err = max_err(ck, cp)
        del ck, cp
        check(err <= tol, f"{name}: max err {err} > {tol}")
        kernel = kernel_for(qc)
        row = {"case": what, "shape": [C, h, w, d], "q": qc, "kernel": kernel, "max_abs_err": err}
        if what == "ragged" and qc not in profiled:
            profiled.add(qc)
            want = kernel_instance(qc, "ssd")
            ran = device_times(torch, lambda: cost_volume(fix, mov, qc), (want,), 1, 1)
            check(ran["device_launches"] == 1, f"{name}: {ran['device_launches']} launches of {want}")
            row["ran"] = want
        print(f"{name}: max_abs_err {err:.3e} (tol {tol:.1e}), {row.get('ran', kernel)}",
              flush=True)
        if what != "ragged":
            K3, n = (2 * qc + 1) ** 3, h * w * d
            # both feature volumes read once, the volume written once; 3
            # separately rounded operations per output and channel
            nbytes, ops = 2 * C * n * 4 + K3 * n * 4, 3.0 * K3 * n * C
            t = timed_turns(torch, lambda: cost_volume(fix, mov, qc), GLOBALS["cost_volume"])
            p_ms = (cuda_ms(torch, lambda: cost_volume_plain(fix, mov, qc))
                    if what != "sweep" else None)
            rec = kernel_record("cost_volume", [C, h, w, d, qc], "float32", err, tol, t, p_ms,
                                nbytes, ops, rate=PEAK_F32_UNFUSED)
            print_times(name, t, p_ms, rec["bound_ms"])
            row.update({k: rec[k] for k in ("call_ms", "device_ms", "plain_ms", "bound_ms",
                                            "bound_by")})
            if record is None:
                record = rec
        detail.append(row)
    return record, detail


def kernel_instance(q, metric):
    """The profiler's name of the cost-volume kernel that computes half-width
    ``q`` with ``metric``, e.g. ``cost_volume_kernel<4, false>`` (SSD) or
    ``cost_volume_general_kernel<true>`` (SAD at a q without its own)."""
    from convexadam_torch.kernels.cost_volume import kernel_for

    sad = "true" if metric == "sad" else "false"
    kernel = kernel_for(q)
    return f"{kernel}<{q}, {sad}>" if kernel == "cost_volume_kernel" else f"{kernel}<{sad}>"


def cost_volume_variant_phase(torch, dev):
    """Phase 3b's variants against their plain versions to the bit: SAD at
    task 3's coarse grid (q = 3), at the semantic grid (q = 5) and at task
    1's (q = 8, the general kernel), SSD at task 1's grid through the
    general kernel, and a candidate block (one kh) at the (2, 7) class's
    grid and at task 1's, each also against the same slab of the dense
    volume, all timed; then SAD at every q in :data:`RAGGED_Q` and blocks at
    :data:`RAGGED_BLOCK_Q` on the ragged crops, where the profiler must see
    the kernel :func:`kernel_instance` names.  Returns the records by name
    and every case's numbers."""
    from convexadam_torch.kernels.cost_volume import (
        cost_volume,
        cost_volume_block,
        cost_volume_block_plain,
        cost_volume_plain,
    )

    gen = torch.Generator().manual_seed(2)

    def pair(shape, draw=torch.randn):
        return tuple(draw(shape, generator=gen).to(dev) for _ in range(2))

    records, detail = {}, []
    timed = (
        ("cost_volume_sad", "task3", COST_VOLUME_TASK3, 3, "sad", torch.rand),
        ("cost_volume_sad", "semantic", COST_VOLUME_SEMANTIC, 5, "sad", torch.rand),
        ("cost_volume_sad", "task1", COST_VOLUME_TASK1, TASK1_Q, "sad", torch.randn),
        ("cost_volume_general", "task1", COST_VOLUME_TASK1, TASK1_Q, "ssd", torch.randn),
    )
    for name, what, shape, q, metric, draw in timed:
        fix, mov = pair(shape, draw)
        C, h, w, d = shape
        K3, n = (2 * q + 1) ** 3, h * w * d
        label = f"{name} {what} {tuple(shape)} q={q}"
        ck = cost_volume(fix, mov, q, metric)
        cp = cost_volume_plain(fix, mov, q, metric)
        torch.cuda.synchronize()
        err = max_err(ck, cp)
        del ck, cp
        check(err == 0.0, f"{label}: max err {err} > 0")
        want = kernel_instance(q, metric)
        ran = device_times(torch, lambda: cost_volume(fix, mov, q, metric), (want,), 1, 1)
        check(ran["device_launches"] == 1, f"{label}: {ran['device_launches']} launches of {want}")
        # SSD: subtract, square, add; SAD: subtract, add (|x| is an operand
        # modifier), separately rounded, per output and channel
        ops = (2.0 if metric == "sad" else 3.0) * K3 * n * C
        nbytes = 2 * C * n * 4 + K3 * n * 4
        t = timed_turns(torch, lambda: cost_volume(fix, mov, q, metric), GLOBALS[name])
        p_ms = cuda_ms(torch, lambda: cost_volume_plain(fix, mov, q, metric), 1, 3)
        rec = kernel_record(name, [C, h, w, d, q], "float32", err, 0.0, t, p_ms, nbytes, ops,
                            rate=PEAK_F32_UNFUSED)
        rec.update({"metric": metric, "kernel": want, "case": what})
        print_times(f"{label} ({want})", t, p_ms, rec["bound_ms"])
        detail.append({"case": what, "name": name, "shape": list(shape), "q": q, "metric": metric,
                       "kernel": want, "max_abs_err": err,
                       **{k: rec[k] for k in ("call_ms", "device_ms", "plain_ms", "bound_ms")}})
        records.setdefault(name, rec)
        del fix, mov

    # one candidate block, the middle kh, of the streamed (2, 7) class (the
    # record) and of task 1's grid at its q
    for what, shape, q, draw in (("stream", COST_VOLUME_STREAM, STREAM_CLASS[1], torch.rand),
                                 ("task1", COST_VOLUME_TASK1, TASK1_Q, torch.randn)):
        kh, K = q, 2 * q + 1
        fix, mov = pair(shape, draw)
        C, h, w, d = shape
        n = h * w * d
        label = f"cost_volume_block {what} {shape} q={q} kh={kh}"
        bk = cost_volume_block(fix, mov, q, kh, 1)
        bp = cost_volume_block_plain(fix, mov, q, kh, 1)
        dense = cost_volume(fix, mov, q).reshape(K, K, K, h, w, d)
        torch.cuda.synchronize()
        err = max_err(bk, bp)
        slab_equal = torch.equal(bk.reshape(K, K, h, w, d), dense[:, :, kh])
        del bp, dense
        check(err == 0.0 and slab_equal,
              f"{label}: max err {err}, equal to the dense slab {slab_equal}")
        want = kernel_instance(q, "ssd")
        nbytes, ops = 2 * C * n * 4 + K * K * n * 4, 3.0 * K * K * n * C
        t = timed_turns(torch, lambda: cost_volume_block(fix, mov, q, kh, 1), (want,))
        p_ms = cuda_ms(torch, lambda: cost_volume_block_plain(fix, mov, q, kh, 1), 1, 3)
        rec = kernel_record("cost_volume_block", [C, h, w, d, q], "float32", err, 0.0, t, p_ms,
                            nbytes, ops, rate=PEAK_F32_UNFUSED)
        rec.update({"metric": "ssd", "kh": kh, "nkh": 1, "equal_to_dense_slab": slab_equal,
                    "kernel": want, "case": what})
        print_times(f"{label} ({want})", t, p_ms, rec["bound_ms"])
        records.setdefault("cost_volume_block", rec)
        detail.append({"case": what, "name": "cost_volume_block", "shape": [C, h, w, d], "q": q,
                       "kh": kh, "kernel": want, "max_abs_err": err,
                       "equal_to_dense_slab": slab_equal,
                       **{k: rec[k] for k in ("call_ms", "device_ms", "plain_ms", "bound_ms")}})
        del fix, mov, bk

    # ragged crops: SAD at every q, blocks of both metrics
    for qr in RAGGED_Q:
        for si, shape in enumerate(COST_VOLUME_RAGGED):
            fix, mov = pair(shape)
            K = 2 * qr + 1
            ck = cost_volume(fix, mov, qr, "sad")
            cp = cost_volume_plain(fix, mov, qr, "sad")
            torch.cuda.synchronize()
            err = max_err(ck, cp)
            check(err == 0.0, f"cost_volume_sad ragged {shape} q={qr}: max err {err}")
            row = {"case": "ragged", "name": "cost_volume_sad", "shape": list(shape), "q": qr,
                   "max_abs_err": err}
            if si == 0:
                want = kernel_instance(qr, "sad")
                ran = device_times(torch, lambda: cost_volume(fix, mov, qr, "sad"), (want,), 1, 1)
                check(ran["device_launches"] == 1, f"SAD ragged q={qr}: no launch of {want}")
                row["ran"] = want
            detail.append(row)
            if qr in RAGGED_BLOCK_Q:
                for metric in ("ssd", "sad"):
                    kh0, nkh = (qr + si) % K, min(K - (qr + si) % K, 1 + si)
                    bk = cost_volume_block(fix, mov, qr, kh0, nkh, metric)
                    bp = cost_volume_block_plain(fix, mov, qr, kh0, nkh, metric)
                    dense = cost_volume(fix, mov, qr, metric).reshape(K, K, K, *shape[1:])
                    torch.cuda.synchronize()
                    slab = dense[:, :, kh0:kh0 + nkh].reshape(bk.shape)
                    ok = torch.equal(bk, bp) and torch.equal(bk, slab)
                    check(ok, f"cost_volume_block ragged {shape} q={qr} kh {kh0}+{nkh} {metric}: "
                          f"max err {max_err(bk, bp)}, to the slab {max_err(bk, slab)}")
                    detail.append({"case": "ragged", "name": "cost_volume_block",
                                   "shape": list(shape), "q": qr, "kh0": kh0, "nkh": nkh,
                                   "metric": metric, "max_abs_err": 0.0})
            print(f"cost volume variants ragged {shape} q={qr}: SAD max_abs_err {err:.1e} (tol 0)"
                  + (", blocks equal to plain and to the dense slab" if qr in RAGGED_BLOCK_Q
                     else "")
                  + (f", {row['ran']}" if "ran" in row else ""), flush=True)
    detail += cost_volume_slab_cases(torch, pair)
    return records, detail


def cost_volume_slab_cases(torch, pair):
    """The moving row offset (phase 9d's slabs) at every q in
    :data:`RAGGED_Q`, SSD and SAD, volume and one candidate block, on two
    ragged crops: the fixed rows 2 .. h - 3 with the moving rows they reach
    (``mov_row0`` = -min(q, 2)) equal to those rows of the whole volume and to
    the plain version, to the bit; a moving slab a row short of them against
    the plain version (zeros past it)."""
    from convexadam_torch.kernels.cost_volume import (
        cost_volume,
        cost_volume_block,
        cost_volume_block_plain,
        cost_volume_plain,
    )

    detail = []
    for shape in (COST_VOLUME_RAGGED[0], COST_VOLUME_RAGGED[2]):
        fix, mov = pair(shape)
        h = shape[1]
        a, b = 2, h - 2
        for qr in RAGGED_Q:
            K = 2 * qr + 1
            ma, mb = max(0, a - qr), min(h, b + qr)
            for metric in ("ssd", "sad"):
                dense = cost_volume(fix, mov, qr, metric).reshape(K, K, K, *shape[1:])
                for m0, m1 in ((ma, mb), (ma + 1, mb)):
                    f, m = fix[:, a:b].contiguous(), mov[:, m0:m1].contiguous()
                    vk = cost_volume(f, m, qr, metric, m0 - a)
                    vp = cost_volume_plain(f, m, qr, metric, m0 - a)
                    kh = qr % K
                    bk = cost_volume_block(f, m, qr, kh, 1, metric, m0 - a)
                    bp = cost_volume_block_plain(f, m, qr, kh, 1, metric, m0 - a)
                    torch.cuda.synchronize()
                    ok = torch.equal(vk, vp) and torch.equal(bk, bp)
                    if m0 == ma:
                        ok = ok and torch.equal(vk.reshape(K, K, K, b - a, *shape[2:]),
                                                dense[..., a:b, :, :])
                    check(ok, f"cost volume slab {shape} q={qr} {metric} moving rows {m0}..{m1 - 1}"
                          f": max err {max_err(vk, vp)}, block {max_err(bk, bp)}")
                    detail.append({"case": "slab", "shape": list(shape), "q": qr,
                                   "metric": metric, "fixed_rows": [a, b],
                                   "moving_rows": [m0, m1], "max_abs_err": 0.0})
        print(f"cost volume slabs {shape}: q in {list(RAGGED_Q)}, SSD and SAD, volume and block "
              f"with the moving row offset equal to plain and to the whole volume's rows",
              flush=True)
    return detail


def sampler_phase(torch, dev, gen, coarse):
    """Phase 3c's sampler: ``sample_trilinear`` on inverse consistency's 2 x
    3 fields of the ``coarse`` grid (float32 and bfloat16 volumes) and of a
    ragged 37 x 41 x 29 grid, to the bit against its plain version and to
    1e-5 against ``F.grid_sample``; the coarse float32 case timed.  Returns
    that case's record and every case's numbers."""
    import torch.nn.functional as F

    from convexadam_torch.kernels.warp import sample_trilinear, sample_trilinear_plain

    record, detail = None, []
    for shape in (coarse, (37, 41, 29)):
        nvox = shape[0] * shape[1] * shape[2]
        # 2 x 3 fields of 0.1 normalized units, sampled at the identity grid
        # displaced by the swapped fields
        fields32 = (torch.randn((2, 3) + shape, generator=gen) * 0.1).to(dev)
        ident = torch.stack(torch.meshgrid(
            *[(2 * torch.arange(s, dtype=torch.float32) + 1) / s - 1 for s in shape],
            indexing="ij"), -1).reshape(1, nvox, 3).to(dev)
        grid = (ident + fields32.flip(0).permute(0, 2, 3, 4, 1).reshape(2, nvox, 3)).contiguous()
        g5 = grid.flip(-1).reshape(2, 1, 1, nvox, 3)
        errs = {}
        for dt in (torch.float32, torch.bfloat16) if shape == coarse else (torch.float32,):
            fields = fields32.to(dt)
            sk = sample_trilinear(fields, grid)
            sp = sample_trilinear_plain(fields, grid)
            lib = F.grid_sample(fields.float(), g5, mode="bilinear", padding_mode="zeros",
                                align_corners=False).reshape(2, 3, nvox)
            torch.cuda.synchronize()
            err = errs[dt] = max_err(sk, sp)
            tol = 0.0  # same weights and corner order: to the bit
            check(err <= tol, f"sample_trilinear {shape} {dt}: max err {err} > {tol}")
            lib_err = max_err(sk, lib)
            check(lib_err <= 1e-5, f"sample_trilinear {shape} {dt} vs F.grid_sample: {lib_err}")
            print(f"sample_trilinear {shape} {dt}: max_abs_err {err:.3e} (tol {tol:.1e}); "
                  f"vs F.grid_sample {lib_err:.3e}", flush=True)
            detail.append({"shape": [2, 3, *shape], "dtype": str(dt), "max_abs_err": err,
                           "vs_grid_sample": lib_err})
        if shape == coarse:
            t = timed_turns(torch, lambda: sample_trilinear(fields32, grid),
                            GLOBALS["sample_trilinear"],
                            lambda: F.grid_sample(fields32, g5, align_corners=False))
            p_ms = cuda_ms(torch, lambda: sample_trilinear_plain(fields32, grid))
            record = kernel_record(
                "sample_trilinear", [2, 3, *shape], "float32", errs[torch.float32], 0.0, t, p_ms,
                2 * (2 * 3 * nvox * 4) + 2 * nvox * 3 * 4, 2.0 * nvox * (3 * 16 + 30),
            )
            print_times("sample_trilinear 2x3x32^3", t, p_ms, record["bound_ms"], "F.grid_sample")
    return record, detail


def adam_sampler_cases(torch, dev, gen):
    """Phase 3f's inputs, ``(C, shape, dtype, vol, grid, ct)``: the semantic
    Adam grid 14 x 96 x 80 x 128 in bfloat16 and float32, sampled at a
    smooth field of a few voxels (past the faces only next to them, as the
    Adam loop samples), and a ragged 3 x 37 x 41 x 29 float32 case whose
    points reach past every face; a seeded cotangent for each."""
    from convexadam_torch.core.warp import _displaced_grid, resize_trilinear

    adam_grid = tuple(s // 2 for s in ABDOMEN_SHAPE)  # the default grid_sp_adam of 2
    for (C, *shape), dt in (((SEMANTIC_LABELS, *adam_grid), torch.bfloat16),
                            ((SEMANTIC_LABELS, *adam_grid), torch.float32),
                            ((3, 37, 41, 29), torch.float32)):
        n = int(np.prod(shape))
        vol = torch.randn((1, C, *shape), generator=gen).to(dev).to(dt)
        if C == SEMANTIC_LABELS:
            coarse = torch.randn((3, *[s // 8 for s in shape]), generator=gen) * 2.0
            grid = _displaced_grid(shape, resize_trilinear(coarse, shape), False).reshape(1, n, 3)
        else:
            # the identity grid moved by up to 0.3 in normalized units
            ident = torch.stack(torch.meshgrid(
                *[(2 * torch.arange(s, dtype=torch.float32) + 1) / s - 1 for s in shape],
                indexing="ij"), -1).reshape(1, n, 3)
            grid = ident + torch.rand((1, n, 3), generator=gen) * 0.6 - 0.3
        grid = grid.to(dev).contiguous()
        ct = torch.randn((1, C, n), generator=gen).to(dev)
        yield C, tuple(shape), dt, vol, grid, ct


def mind_cases(torch, vol):
    """Phase 3a's inputs, ``(shape, dtype, r, d, x)``, the main path's case
    first: the 192^3 volume ``vol`` at (r, d) = (1, 2) in bf16 and f32 and
    at the pairs of :data:`MIND_TIMED`; every (r, d) the self-configuring
    search draws and every pair of :data:`MIND_GENERAL_PAIRS` on the ragged
    37 x 41 x 29 crop of it, and the search's pairs on
    :data:`MIND_WIDE_SHAPES` (across D tiles), in f32 and bf16."""
    dts = (torch.float32, torch.bfloat16)
    cases = [(HEADLINE_SHAPE, dt, 1, 2) for dt in dts[::-1]]
    cases += [(HEADLINE_SHAPE, getattr(torch, dt), r, d) for (r, d), dt in MIND_TIMED]
    cases += [(RAGGED_SHAPE, dt, r, d) for r, d in MIND_PAIRS + MIND_GENERAL_PAIRS for dt in dts]
    cases += [(shape, dt, r, d) for shape in MIND_WIDE_SHAPES for r, d in MIND_PAIRS
              for dt in dts]
    for shape, dt, r, d in cases:
        yield shape, dt, r, d, vol[: shape[0], : shape[1], : shape[2]].to(dt).contiguous()


def mind_instance(key: str):
    """``(r, d)`` of a compiled MIND kernel's profiler name
    (``...mind_kernel<T, R, DIL>(...)``), or None where the name does not
    show them."""
    m = re.search(r"mind_kernel<[^<>]*?,\s*(\d+),\s*(\d+)>", key)
    return (int(m.group(1)), int(m.group(2))) if m else None


def mind_work(shape, itemsize: int, r: int) -> "tuple[float, float]":
    """(bytes, operations) that ``mind_ssd_stats`` at radius ``r`` needs on
    a volume of ``shape`` whose elements take ``itemsize`` bytes: the volume
    read once, the 12 channels written in its type and the float32
    variance; per voxel 24 operations for the 12 squared differences, 12 x
    (6r + 1) for the separable (2r + 1)^3 box means, 23 for the channel
    minimum, 14 for the variance (145 at r = 1)."""
    n = float(np.prod(shape))
    return n * itemsize + 12 * n * itemsize + n * 4, (145.0 + 72.0 * (r - 1)) * n


def mind_phase(torch, vol):
    """Phase 3a: ``mind_ssd_stats`` against its plain version to the bit on
    :func:`mind_cases`; for every pair (once, on the ragged crop) and every
    192^3 case, the profiler must see one launch of the kernel ``kernel_for``
    names, of that (r, d) where it is a compiled one, and no other MIND
    kernel; the 192^3 cases timed.  Returns the records of the main case
    (1, 2) and of the general kernel at (4, 1) (bf16), and every case's
    numbers."""
    from convexadam_torch.kernels.mind import kernel_for, mind_ssd_stats, mind_ssd_stats_plain

    records, detail, profiled = {}, [], set()
    for shape, dt, r, d, x in mind_cases(torch, vol):
        mk, vk = mind_ssd_stats(x, r, d)
        mp, vp = mind_ssd_stats_plain(x, r, d)
        torch.cuda.synchronize()
        # the kernels repeat the plain version's operations in its order and
        # rounding (bf16 too): they must agree to the bit
        tol = 0.0
        err = max(max_err(mk, mp), max_err(vk, vp))
        check(err <= tol, f"mind_ssd_stats {shape} {dt} (r, d) = {(r, d)}: max err {err} > {tol}")
        del mk, vk, mp, vp
        kernel = kernel_for(r, d)
        row = {"shape": list(shape), "dtype": str(dt), "r": r, "d": d, "max_abs_err": err,
               "kernel": kernel}
        if (r, d) not in profiled or shape == HEADLINE_SHAPE:
            profiled.add((r, d))
            ran = device_times(torch, lambda: mind_ssd_stats(x, r, d),
                               ("mind_kernel", "mind_general_kernel"), 1, 1)
            mine = [k for k in ran["device_kernels"] if kernel in k]
            others = [k for k in ran["device_kernels"] if "mind" in k and k not in mine]
            check(ran["device_launches"] == 1 and len(mine) == 1 and not others,
                  f"mind_ssd_stats (r, d) = {(r, d)}: {ran['device_launches']} launches, "
                  f"saw {ran['device_kernels']}, expected one {kernel}")
            inst = mind_instance(mine[0])
            check(kernel != "mind_kernel" or inst in (None, (r, d)),
                  f"mind_ssd_stats (r, d) = {(r, d)} ran {mine[0]}")
            row["profiled"] = mine[0]
        print(f"mind_ssd_stats {shape} {dt} (r, d) = {(r, d)}: max_abs_err {err:.3e} "
              f"(tol {tol:.1e}), ran {row.get('profiled', kernel)}", flush=True)
        if shape == HEADLINE_SHAPE:
            dname = str(dt)[6:]
            t = timed_turns(torch, lambda: mind_ssd_stats(x, r, d), (kernel,))
            p_ms = cuda_ms(torch, lambda: mind_ssd_stats_plain(x, r, d))
            name = "mind_ssd_stats" if kernel == "mind_kernel" else "mind_ssd_stats_general"
            rec = kernel_record(name, list(shape), dname, err, tol, t, p_ms,
                                *mind_work(shape, x.element_size(), r))
            print_times(f"mind_ssd_stats (r, d) = {(r, d)} {dname} ({kernel})", t, p_ms,
                        rec["bound_ms"])
            row.update({k: rec[k] for k in ("call_ms", "device_ms", "plain_ms", "bound_ms")})
            if dname == "bfloat16" and (r, d) in ((1, 2), GENERAL_MIND):
                records.setdefault(name, rec)
        detail.append(row)
    return records["mind_ssd_stats"], records["mind_ssd_stats_general"], detail


def data_term_cases(torch, gen, feat_f, feat_m, grid_sp_adam):
    """Phase 3d's inputs, ``(what, fix, mov, disp, fac, chain)`` with ``fix``
    flattened to (C, N), the main path's case first: its Adam grid (the
    headline pair's MIND features pooled to 12 x 96^3, a smooth field of a
    few voxels) with bf16 and with f32 moving features, the semantic Adam
    grid 14 x 96 x 80 x 128 in bf16 (seeded features), the sweep's Adam grid
    at grid_sp_adam 3, 14 x 64 x 53 x 85 (no axis divides the Abdomen
    shape; 5b's settings at 3), in bf16, and a ragged 3 x 37 x 41 x 29 grid
    whose displacements push points past every face (f32 and bf16)."""
    from convexadam_torch.core.smoothing import avg_pool3d
    from convexadam_torch.core.warp import resize_trilinear

    dev = feat_f.device

    def smooth(shape):
        coarse = torch.randn((3, *[s // 8 for s in shape]), generator=gen) * 2.0
        return resize_trilinear(coarse, tuple(shape)).to(dev).contiguous()

    pf = avg_pool3d(feat_f.float(), grid_sp_adam).contiguous()
    pm = avg_pool3d(feat_m.float(), grid_sp_adam).contiguous()
    mind_disp = smooth(pf.shape[1:])
    sem_grid = tuple(s // grid_sp_adam for s in ABDOMEN_SHAPE)
    sem_fix, sem_mov = (torch.rand((SEMANTIC_LABELS, *sem_grid), generator=gen).to(dev)
                        for _ in range(2))
    g3_grid = tuple(s // 3 for s in ABDOMEN_SHAPE)
    g3_fix, g3_mov = (torch.rand((SEMANTIC_LABELS, *g3_grid), generator=gen).to(dev)
                      for _ in range(2))
    rag_fix, rag_mov = (torch.randn((3, *RAGGED_SHAPE), generator=gen).to(dev) for _ in range(2))
    rag_disp = ((torch.rand((3, *RAGGED_SHAPE), generator=gen) * 2 - 1) * 6).to(dev)
    cases = [("mind", pf, pm.to(torch.bfloat16), mind_disp), ("mind", pf, pm, mind_disp),
             ("semantic", sem_fix, sem_mov.to(torch.bfloat16), smooth(sem_grid)),
             ("semantic g3", g3_fix, g3_mov.to(torch.bfloat16), smooth(g3_grid)),
             ("ragged", rag_fix, rag_mov, rag_disp),
             ("ragged", rag_fix, rag_mov.to(torch.bfloat16), rag_disp)]
    out = []
    for what, fix, mov, disp in cases:
        C, H, W, D = mov.shape
        N = H * W * D
        out.append((what, fix.reshape(C, N), mov, disp,
                    (H / (H - 1.0), W / (W - 1.0), D / (D - 1.0)), 2.0 * 12.0 / (C * N)))
    return out


def data_term_phase(torch, gen, feat_f, feat_m, grid_sp_adam):
    """Phase 3d: ``warp_ssd_loss_grad`` against its plain version on
    :func:`data_term_cases`, the rows to the bit and ``sum(res^2)`` to 1e-5
    relative; every case but the ragged ones timed, the first the record.
    Returns the main case's record and every case's numbers."""
    from convexadam_torch.kernels.warp import warp_ssd_loss_grad, warp_ssd_loss_grad_plain

    record, detail = None, []
    cases = data_term_cases(torch, gen, feat_f, feat_m, grid_sp_adam)
    ragged = [c for c in cases if c[0] == "ragged"]
    for what, fix_flat, mov, disp, fac, chain in cases:
        C, H, W, D = mov.shape
        N = H * W * D
        dev = mov.device
        ssq_k, rows_k = warp_ssd_loss_grad(mov, disp, fix_flat, fac, chain)
        ssq_p, rows_p = warp_ssd_loss_grad_plain(mov, disp, fix_flat, fac, chain)
        # the first sample positions, per axis below 0 and above size - 1
        pos = [torch.arange(s, device=dev).reshape([-1 if a == b else 1 for b in range(3)])
               + disp[a] * fac[a] for a, s in enumerate((H, W, D))]
        faces = [int((p < 0).sum()) for p in pos] + \
                [int((p > s - 1).sum()) for p, s in zip(pos, (H, W, D))]
        torch.cuda.synchronize()
        # sum(res^2): a fixed two-pass tree in the kernel, torch's own order
        # in the plain version, hence 1e-5 relative; the rows are the same
        # operations in the same order, to the bit
        ssq_rel = abs(float(ssq_k) - float(ssq_p)) / float(ssq_p)
        err = max_err(rows_k, rows_p)
        tol = 0.0
        name = f"warp_ssd_loss_grad {what} {(C, H, W, D)} {mov.dtype}"
        check(ssq_rel <= 1e-5, f"{name}: sum(res^2) relative err {ssq_rel}")
        check(err <= tol, f"{name}: rows max err {err} > {tol}")
        check(what != "ragged" or min(faces) > 0, f"{name}: points past the faces {faces}")
        print(f"{name}: rows max_abs_err {err:.3e} (tol {tol:.1e}); sum(res^2) rel err "
              f"{ssq_rel:.3e}; points past the faces {faces}", flush=True)
        row = {"case": what, "shape": [C, H, W, D], "dtype": str(mov.dtype), "max_abs_err": err,
               "ssq_rel_err": ssq_rel, "points_past_faces": faces}
        if what != "ragged":
            t = timed_turns(torch, lambda: warp_ssd_loss_grad(mov, disp, fix_flat, fac, chain),
                            GLOBALS["warp_ssd_loss_grad"])
            p_ms = cuda_ms(torch, lambda: warp_ssd_loss_grad_plain(mov, disp, fix_flat, fac, chain))
            # each input read once, the rows written once; per point about 60
            # operations of setup and 50 for the rows, per channel 8 corners x
            # (multiply, add) for the sample and for the gradient and 5 more
            nbytes = C * N * (mov.element_size() + 4) + 3 * N * 4 * 2
            rec = kernel_record("warp_ssd_loss_grad", [C, H, W, D], str(mov.dtype)[6:], err, tol,
                                t, p_ms, nbytes, 1.0 * N * (C * 37 + 110))
            print_times(name, t, p_ms, rec["bound_ms"])
            row.update({k: rec[k] for k in ("call_ms", "device_ms", "plain_ms", "bound_ms")})
            if record is None:
                record = rec
        detail.append(row)
    detail += data_term_slab_cases(torch, ragged, 1)
    return record, detail


def data_term_slab_cases(torch, cases, s):
    """The data term on lattice rows from ``row0`` (phase 9d's slabs) of the
    ragged ``cases`` at stride ``s``: the rows of lattice rows 3 .. 11 equal
    to the plain version's and to those of the whole lattice's, to the bit,
    ``sum(res^2)`` to the plain version's to 1e-5 relative."""
    from convexadam_torch.kernels.warp import warp_ssd_loss_grad, warp_ssd_loss_grad_plain

    detail = []
    for what, fix_flat, mov, disp, fac, chain in cases:
        C = mov.shape[0]
        hs, ws, ds = disp.shape[1:]
        r0, r1 = 3, 12
        f = fix_flat.reshape(C, hs, ws, ds)[:, r0:r1].reshape(C, -1).contiguous()
        d = disp[:, r0:r1].contiguous()
        _, whole = warp_ssd_loss_grad(mov, disp, fix_flat, fac, chain, s)
        ssq_k, rows_k = warp_ssd_loss_grad(mov, d, f, fac, chain, s, r0)
        ssq_p, rows_p = warp_ssd_loss_grad_plain(mov, d, f, fac, chain, s, r0)
        torch.cuda.synchronize()
        ssq_rel = abs(float(ssq_k) - float(ssq_p)) / float(ssq_p)
        part = whole.reshape(3, hs, ws, ds)[:, r0:r1].reshape(3, -1)
        name = (f"warp_ssd_loss_grad stride {s} {what} {tuple(mov.shape)} {mov.dtype} "
                f"rows {r0}..{r1 - 1}")
        check(torch.equal(rows_k, rows_p) and torch.equal(rows_k, part) and ssq_rel <= 1e-5,
              f"{name}: rows max err {max_err(rows_k, rows_p)}, to the whole lattice's "
              f"{max_err(rows_k, part)}, sum(res^2) rel {ssq_rel}")
        print(f"{name}: rows equal to plain and to the whole lattice's; sum(res^2) rel err "
              f"{ssq_rel:.3e}", flush=True)
        detail.append({"case": f"{what} slab", "shape": list(mov.shape), "stride": s,
                       "dtype": str(mov.dtype), "lattice_rows": [r0, r1], "max_abs_err": 0.0,
                       "ssq_rel_err": ssq_rel})
    return detail


def strided_data_term_phase(torch, gen, feat_f, feat_m, grid_sp_adam):
    """Phase 3d's strided data term: ``warp_ssd_loss_grad(..., stride=s)``
    for each ``s`` of :data:`DATA_TERM_STRIDES` against its plain version,
    rows to the bit and ``sum(res^2)`` to 1e-5 relative, on the main path's
    Adam grid 12 x 96^3 (bf16 and f32 moving features; the sub-lattice 48^3
    or 32^3 of a smooth field) and on a ragged 3 x 37 x 41 x 29 grid that
    neither stride divides (points pushed past every face); the first case
    of each stride timed.  Returns stride 2's record (stride 3's timing as
    its ``at_stride_3``) and every case's numbers."""
    from convexadam_torch.core.smoothing import avg_pool3d
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.kernels.warp import (
        sub_extent,
        warp_ssd_loss_grad,
        warp_ssd_loss_grad_plain,
    )

    dev = feat_f.device
    pf = avg_pool3d(feat_f.float(), grid_sp_adam).contiguous()
    pm = avg_pool3d(feat_m.float(), grid_sp_adam).contiguous()
    rag_fix, rag_mov = (torch.randn((3, *RAGGED_SHAPE), generator=gen).to(dev) for _ in range(2))
    record, detail = None, []
    for s in DATA_TERM_STRIDES:
        sub = tuple(sub_extent(n, s) for n in pf.shape[1:])
        coarse = torch.randn((3, *[n // 8 for n in sub]), generator=gen) * 2.0
        mind_disp = resize_trilinear(coarse, sub).to(dev).contiguous()
        rag_sub = tuple(sub_extent(n, s) for n in RAGGED_SHAPE)
        rag_disp = ((torch.rand((3, *rag_sub), generator=gen) * 2 - 1) * 6).to(dev)
        cases = [("mind", pf, pm.to(torch.bfloat16), mind_disp), ("mind", pf, pm, mind_disp),
                 ("ragged", rag_fix, rag_mov, rag_disp),
                 ("ragged", rag_fix, rag_mov.to(torch.bfloat16), rag_disp)]
        timed = None
        for what, fix, mov, disp in cases:
            C, H, W, D = mov.shape
            n = disp[0].numel()
            fix_flat = fix[:, ::s, ::s, ::s].reshape(C, n).contiguous()
            fac = (H / (H - 1.0), W / (W - 1.0), D / (D - 1.0))
            chain = 2.0 * 12.0 / (C * n)
            ssq_k, rows_k = warp_ssd_loss_grad(mov, disp, fix_flat, fac, chain, s)
            ssq_p, rows_p = warp_ssd_loss_grad_plain(mov, disp, fix_flat, fac, chain, s)
            pos = [s * torch.arange(m, device=dev).reshape([-1 if a == b else 1 for b in range(3)])
                   + disp[a] * fac[a] for a, m in enumerate(disp.shape[1:])]
            faces = [int((p < 0).sum()) for p in pos] + \
                    [int((p > e - 1).sum()) for p, e in zip(pos, (H, W, D))]
            torch.cuda.synchronize()
            ssq_rel = abs(float(ssq_k) - float(ssq_p)) / float(ssq_p)
            err = max_err(rows_k, rows_p)
            name = f"warp_ssd_loss_grad stride {s} {what} {(C, H, W, D)} {mov.dtype}"
            check(ssq_rel <= 1e-5, f"{name}: sum(res^2) relative err {ssq_rel}")
            check(err == 0.0, f"{name}: rows max err {err} > 0")
            check(what != "ragged" or min(faces) > 0, f"{name}: points past the faces {faces}")
            print(f"{name}: {n} points, rows max_abs_err {err:.3e} (tol 0); sum(res^2) rel err "
                  f"{ssq_rel:.3e}; points past the faces {faces}", flush=True)
            row = {"case": what, "shape": [C, H, W, D], "stride": s, "points": n,
                   "dtype": str(mov.dtype), "max_abs_err": err, "ssq_rel_err": ssq_rel,
                   "points_past_faces": faces}
            if timed is None:
                t = timed_turns(torch, lambda: warp_ssd_loss_grad(mov, disp, fix_flat, fac, chain,
                                                                  s),
                                GLOBALS["warp_ssd_loss_grad_strided"])
                p_ms = cuda_ms(torch, lambda: warp_ssd_loss_grad_plain(mov, disp, fix_flat, fac,
                                                                       chain, s))
                # the moving values the corners reach (at most 8 a point, at
                # most the volume), the sub-lattice's fixed features and field
                # read once, its rows written once; operations as the dense
                # term's
                nbytes = (C * min(H * W * D, 8 * n) * mov.element_size() + C * n * 4
                          + 3 * n * 4 * 2)
                timed = kernel_record("warp_ssd_loss_grad_strided", [C, H, W, D],
                                      str(mov.dtype)[6:], err, 0.0, t, p_ms, nbytes,
                                      1.0 * n * (C * 37 + 110))
                timed["stride"] = s
                print_times(name, t, p_ms, timed["bound_ms"])
                row.update({k: timed[k] for k in ("call_ms", "device_ms", "plain_ms", "bound_ms")})
            detail.append(row)
            if what == "ragged":
                detail += data_term_slab_cases(
                    torch, [(what, fix_flat, mov, disp, fac, chain)], s)
        if record is None:
            record = timed
        else:
            record[f"at_stride_{s}"] = {k: v for k, v in timed.items()
                                        if k not in ("name", "timing_readings")}
    return record, detail


def ic_composition(torch, d1, d2, iters, sample):
    """The inverse-consistency loop as ``core/warp.py`` ran it before the
    fused steps, with the batched sampler ``sample(vol, grid)``: per step
    the two displaced grids, one sampler call of the swapped fields and the
    two updates."""
    from convexadam_torch.core.warp import identity_grid_normalized

    shape = tuple(d1.shape[1:])
    n = d1[0].numel()
    identity = identity_grid_normalized(shape, False, device=d1.device, dtype=d1.dtype)
    for _ in range(iters):
        g1 = (identity + d1.permute(1, 2, 3, 0)).reshape(n, 3)
        g2 = (identity + d2.permute(1, 2, 3, 0)).reshape(n, 3)
        out = sample(torch.stack([d2, d1]).contiguous(), torch.stack([g1, g2]))
        s1 = out[0].reshape((3,) + shape)
        s2 = out[1].reshape((3,) + shape)
        d1, d2 = 0.5 * (d1 - s1), 0.5 * (d2 - s2)
    return torch.stack([d1, d2])


def ic_phase(torch, dev, gen, coarse):
    """Phase 3c's inverse-consistency steps: ``inverse_consistency`` (one
    fused launch per step) against its plain version and the composition it
    replaces, both to the bit, on the 2 x 3 fields of the coarse grid and on
    a ragged pair sent past every face; at the coarse grid the call and
    device times of the fused call, of the old composition and of the same
    composition with ``F.grid_sample``.  Returns the record and every
    case's numbers."""
    import torch.nn.functional as F

    from convexadam_torch.core.warp import identity_grid_normalized, inverse_consistency
    from convexadam_torch.kernels.warp import (
        inverse_consistency_steps,
        inverse_consistency_steps_plain,
        sample_trilinear,
    )

    def grid_sample(vol, grid):
        B, N = grid.shape[:2]
        g = grid.flip(-1).reshape(B, 1, 1, N, 3)
        return F.grid_sample(vol, g, align_corners=False).reshape(B, vol.shape[1], N)

    record, detail = None, []
    for shape, amp in ((coarse, 0.1), ((37, 41, 29), 0.4)):
        fields = (torch.randn((2, 3) + shape, generator=gen) * amp).to(dev)
        d1, d2 = fields[0], fields[1]
        ko = inverse_consistency_steps(fields, IC_ITERS)
        po = inverse_consistency_steps_plain(fields, IC_ITERS)
        co = ic_composition(torch, d1, d2, IC_ITERS, sample_trilinear)
        lo = ic_composition(torch, d1, d2, IC_ITERS, grid_sample)
        eo = torch.stack(inverse_consistency(d1, d2, IC_ITERS))
        # the first step's sample points, per axis below -1 and above 1
        ident = identity_grid_normalized(shape, False, device=dev).permute(3, 0, 1, 2)
        pts = ident[None] + fields
        faces = [int((pts[:, a] < -1).sum()) for a in range(3)] + \
                [int((pts[:, a] > 1).sum()) for a in range(3)]
        torch.cuda.synchronize()
        err, err_comp, err_entry = max_err(ko, po), max_err(ko, co), max_err(eo, ko)
        lib_err = max_err(ko, lo)
        tol = 0.0  # the same operations in the same order on both sides
        check(err <= tol, f"inverse_consistency_steps {shape}: max err {err} vs its plain version")
        check(err_comp <= tol, f"inverse_consistency_steps {shape}: max err {err_comp} vs the "
              "sample_trilinear composition")
        check(err_entry <= tol, f"inverse_consistency {shape}: max err {err_entry} vs the steps")
        check(lib_err <= 1e-4, f"inverse_consistency_steps {shape} vs F.grid_sample: {lib_err}")
        check(shape == coarse or min(faces) > 0, f"ragged IC case: points past the faces {faces}")
        print(f"inverse_consistency_steps {(2, 3, *shape)} x {IC_ITERS}: max_abs_err {err:.1e} vs "
              f"plain, {err_comp:.1e} vs the sample_trilinear composition (tol 0); vs the "
              f"F.grid_sample composition {lib_err:.3e}; first-step points past the faces "
              f"{faces}", flush=True)
        row = {"shape": [2, 3, *shape], "iters": IC_ITERS, "max_abs_err": err,
               "vs_composition": err_comp, "vs_grid_sample_composition": lib_err,
               "points_past_faces": faces}
        if shape == coarse:
            def fused():
                return inverse_consistency(d1, d2, IC_ITERS)

            t = timed_turns(torch, fused, GLOBALS["sample_trilinear_ic"],
                            lambda: ic_composition(torch, d1, d2, IC_ITERS, grid_sample))
            old = timed_turns(torch, fused, GLOBALS["sample_trilinear_ic"],
                              lambda: ic_composition(torch, d1, d2, IC_ITERS, sample_trilinear))
            p_ms = cuda_ms(torch, lambda: inverse_consistency_steps_plain(fields, IC_ITERS))
            n = int(np.prod(shape))
            # per step: both fields read once and written once, and the
            # identity; per point about 30 operations of setup and per
            # channel 8 corners x (multiply, add) and the update
            nbytes = 2 * (2 * 3 * n * 4) + 4 * sum(shape)
            flops = 2.0 * n * (30 + 3 * 17)
            record = kernel_record("sample_trilinear_ic", [2, 3, *shape], "float32", err, tol, t,
                                   p_ms, nbytes, flops, steps=IC_ITERS)
            record.update({
                "iters": IC_ITERS, "call_ms_per_call": t["call_ms"],
                "library_call_ms_per_call": t["library_call_ms"],
                "device_all_ms_per_call": t["device_all_ms"],
                "library": "the same steps composed with F.grid_sample",
                "old_composition": {"call_ms_per_call": old["library_call_ms"],
                                    "device_all_ms_per_call": old["library_device_ms"],
                                    "fused_call_ms_per_call": old["call_ms"]},
            })
            row.update({k: record[k] for k in ("call_ms_per_call", "library_call_ms_per_call",
                                               "device_all_ms_per_call", "old_composition")})
            row["old_composition_readings"] = old["readings"]
            print(f"  inverse_consistency, {IC_ITERS} steps: call {t['call_ms']:.4f} ms (device "
                  f"{t['device_ms']:.4f} ms in ic_step_kernel, {t['device_all_ms']:.4f} ms in all); "
                  f"F.grid_sample composition call {t['library_call_ms']:.4f} ms (device "
                  f"{t['library_device_ms']:.4f} ms); sample_trilinear composition call "
                  f"{old['library_call_ms']:.4f} ms (device {old['library_device_ms']:.4f} ms); "
                  f"plain {p_ms:.4f} ms; bound per step {record['bound_ms']:.5f} ms", flush=True)
            check(t["device_launches"] == IC_ITERS,
                  f"profiler saw {t['device_launches']} ic_step_kernel launches per call")
        detail.append(row)
    return record, detail


def semantic_phase(torch, dev, results, shape=ABDOMEN_SHAPE):
    """Phase 4d: ``convex_adam_semantic_torch`` on the 13-organ pair at the
    Abdomen shape, its launches, shift recovery and ``evaluate_field``.
    Returns the launches and the Adam stage's inputs of that registration
    (pooled fixed and moving features, init) for phase 4f."""
    from convexadam_torch import convex_adam_semantic_torch, evaluate_field
    from convexadam_torch.core.features import semantic_features
    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, _adam_inputs, _convex_stage

    seg_f, seg_m = l2r_label_pair(shape=shape, margin=ABDOMEN_MARGIN)
    sf, sm = (torch.from_numpy(x).to(dev) for x in (seg_f, seg_m))

    def run():
        return convex_adam_semantic_torch(sf, sm, num_labels=SEMANTIC_LABELS, device=dev)

    run()  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    out = run().cpu().numpy()
    launches = dict(LAUNCHES)
    print(f"launches per semantic registration: {launches}", flush=True)
    for name, want in EXPECTED_SEMANTIC_LAUNCHES.items():
        check(launches[name] == want, f"semantic {name}: {launches[name]} launches, expected {want}")
    check(out.shape == shape + (3,) and bool(np.isfinite(out).all()), "bad semantic field")
    organs = seg_f > 0
    err_v = np.abs(out[organs] - np.array(HEADLINE_SHIFT, np.float32))
    # one-hot features are constant inside an organ and constrain only the
    # boundary normal, so the regularisers set the interior: on this pair
    # the JAX package (f32) and the port, on the card and on the CPU, all
    # put about 23% of the organ voxels within 1 voxel and 91% within 2
    # (scripts/semantic_shift_share.py); the limits sit 1-3 points below,
    # so a fault that costs either share more fails here
    frac_ok = float(np.mean(np.all(err_v < 1.0, axis=-1)))
    frac2 = float(np.mean(np.all(err_v < 2.0, axis=-1)))
    check(frac_ok > 0.2, f"semantic: shift recovered within 1 voxel in only {frac_ok:.2%} of the "
          "organ voxels")
    check(frac2 > 0.9, f"semantic: shift recovered within 2 voxels in only {frac2:.2%} of the "
          "organ voxels")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rng = np.random.default_rng(2)
    kf = rng.uniform(ABDOMEN_MARGIN, np.array(shape) - ABDOMEN_MARGIN, (20, 3)).astype(np.float32)
    ev = evaluate_field(out, seg_f, seg_m, L2R_LABELS, kf, kf + np.asarray(HEADLINE_SHIFT, np.float32),
                        device=dev)
    check(bool((ev["dice"] > 0.9).all()), f"semantic Dice {ev['dice']} not > 0.9 on every organ")
    check(bool((ev["hd95"] <= 2.0).all()), f"semantic HD95 {ev['hd95']} above 2 voxels")
    res = {
        "shape": list(shape), "labels": SEMANTIC_LABELS, "config": "default (dtype auto = bfloat16)",
        "organ_voxels": int(organs.sum()), "frac_within_1vox": frac_ok,
        "frac_within_2vox": frac2, "mean_abs_err_vox_per_axis": err_v.mean(0).tolist(),
        "registration_s_median": float(np.median(times)), "registration_s": times,
        "peak_mem_gb": peak, "dice": ev["dice"].tolist(), "hd95": ev["hd95"].tolist(),
        "tre": ev["tre"].tolist(), "tre30": ev["tre30"], "sdlogj": ev["sdlogj"],
        "launches": launches,
    }
    print(f"semantic registration {shape}, {SEMANTIC_LABELS} channels: "
          f"{res['registration_s_median']:.4f} s (median of 3), peak {peak:.2f} GB; "
          f"{frac_ok:.2%} of the organ voxels within 1 voxel, {frac2:.2%} within 2; min Dice {min(res['dice']):.4f}; "
          f"HD95 {np.round(ev['hd95'], 3).tolist()}; TRE mean {float(np.mean(ev['tre'])):.4f}, "
          f"TRE30 {ev['tre30']:.4f}", flush=True)
    results["semantic"] = res
    cfg = ConvexAdamConfig()
    with torch.no_grad():
        ff, fm = semantic_features(sf, sm, SEMANTIC_LABELS, dtype=cfg.compute_dtype(sf.device))
        init = _convex_stage(ff, fm, cfg, shape, for_adam_init=True)
    return launches, _adam_inputs(ff, fm, init, cfg)


def multi_output_phase(torch, dev, vol_np, mov_np, single, results):
    """Phase 4e: MIND features and ``convex_adam_multi_output`` of the
    headline pair, against phase 4's single-output field ``single``."""
    from convexadam_torch import convex_adam_multi_output
    from convexadam_torch.core.features import mindssc
    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig

    cfg = ConvexAdamConfig()
    iters, smoothings = (40, 60, 80), (0, 3, 5)

    def run():
        dt = cfg.compute_dtype(dev)
        with torch.no_grad():
            ff = mindssc(torch.from_numpy(vol_np).to(dev), cfg.mind_r, cfg.mind_d, dtype=dt)
            fm = mindssc(torch.from_numpy(mov_np).to(dev), cfg.mind_r, cfg.mind_d, dtype=dt)
        return convex_adam_multi_output(ff, fm, cfg, iters, smoothings, device=dev)

    torch.cuda.synchronize()
    reset_launches()
    multi = run()
    launches = dict(LAUNCHES)
    print(f"launches per multi-output run: {launches}", flush=True)
    for name, want in EXPECTED_LAUNCHES.items():
        check(launches[name] == want, f"multi-output {name}: {launches[name]} launches, expected {want}")
    check(tuple(multi.shape) == (len(iters), len(smoothings)) + HEADLINE_SHAPE + (3,)
          and bool(torch.isfinite(multi).all()), "bad multi-output fields")
    d80 = float(np.abs(multi[iters.index(80), 0].cpu().numpy() - single).max())
    check(d80 <= 1e-5, f"multi-output (80, 0) differs from the single-output field by {d80}")
    del multi
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    res = {"iters": list(iters), "smoothings": list(smoothings),
           "max_abs_diff_80_0_vs_single": d80, "multi_output_s_median": float(np.median(times)),
           "multi_output_s": times, "launches": launches}
    print(f"multi-output 192^3, 9 variants: {res['multi_output_s_median']:.4f} s (median of 3, "
          f"features included); (80, 0) vs single-output max |diff| {d80:.3e}", flush=True)
    results["multi_output"] = res
    return launches


def autodiff_phase(torch, adam_inputs, results):
    """Phase 4f: the autodiff gradient step (differentiable warp) against
    the fused one on 4d's Adam inputs, one gradient, then 80 iterations of
    each.  Returns the autodiff run's launches."""
    from convexadam_torch.core import adam as tadam
    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig

    cfg = ConvexAdamConfig()
    patch_fix, patch_mov, init = adam_inputs
    C = patch_fix.shape[0]
    fix_flat = patch_fix.reshape(C, -1).contiguous()
    mov = patch_mov.contiguous()
    smooth = tadam.resolve_smoother(cfg.adam_smoother)
    steps = {name: (lambda w, f=f: f(w, fix_flat, mov, cfg.lambda_weight, smooth, 12.0))
             for name, f in (("fused", tadam._grad_step_fused),
                             ("autodiff", tadam._grad_step_autodiff))}
    zero_frac = float((init == 0).float().mean())
    w = init.float().clone().requires_grad_(True)
    (lf, _, gf), (la, _, ga) = steps["fused"](w), steps["autodiff"](w)
    loss_rel = abs(float(la) - float(lf)) / abs(float(lf))
    grad_rel = float((ga - gf).norm() / gf.norm())
    check(loss_rel <= 1e-5, f"autodiff vs fused loss: relative err {loss_rel}")
    check(grad_rel <= 1e-4, f"autodiff vs fused gradient: relative L2 {grad_rel}")
    fields, secs = {}, {}
    for name in ("fused", "autodiff"):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        fields[name], _ = tadam._adam_loop(steps[name], init, cfg.selected_niter)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    print(f"launches per autodiff Adam run: {launches}", flush=True)
    for name, want in EXPECTED_AUTODIFF_LAUNCHES.items():
        check(launches[name] == want, f"autodiff {name}: {launches[name]} launches, expected {want}")
    # component differences in full-resolution voxels
    diff = ((fields["autodiff"] - fields["fused"]).abs() * cfg.grid_sp_adam).flatten().cpu().numpy()
    med, p99 = float(np.median(diff)), float(np.quantile(diff, 0.99))
    check(med < 0.05 and p99 < 0.5, f"autodiff vs fused fields: median {med} / p99 {p99}")
    res = {"adam_grid": list(init.shape[1:]), "init_zero_frac": zero_frac,
           "loss_rel_err": loss_rel, "grad_rel_l2": grad_rel, "median_abs_diff_vox": med,
           "p99_abs_diff_vox": p99, "max_abs_diff_vox": float(diff.max()),
           "fused_adam_s": secs["fused"], "autodiff_adam_s": secs["autodiff"], "launches": launches}
    print(f"autodiff vs fused on {tuple(init.shape[1:])}: loss rel {loss_rel:.3e}, gradient rel L2 "
          f"{grad_rel:.3e}; after {cfg.selected_niter} iterations median |diff| {med:.4f}, p99 "
          f"{p99:.4f}, max {res['max_abs_diff_vox']:.4f} voxels; Adam {secs['fused']:.4f} s fused, "
          f"{secs['autodiff']:.4f} s autodiff", flush=True)
    results["autodiff"] = res
    return launches


def sweep_subjects():
    """Phase 5's three subjects at the Abdomen shape: the 13-organ layout
    of :func:`l2r_label_pair` (seed 0) rolled by each of
    :data:`SWEEP_SHIFTS`, as (3, H, W, D) int32; predictions = ground truth,
    as in the JAX package's sweep tests."""
    base, _ = l2r_label_pair(shape=ABDOMEN_SHAPE, margin=ABDOMEN_MARGIN)
    return np.stack([np.roll(base, s, axis=(0, 1, 2)) for s in SWEEP_SHIFTS])


def seeded_classes() -> "list[tuple[int, int]]":
    """Every (grid_sp, disp_hw) class the seeded stage-1 sampler draws, in
    the order of its first setting."""
    from convexadam_torch.selfconfig import stage1_settings

    return list(dict.fromkeys((s.grid_sp, s.disp_hw) for s in stage1_settings()))


def sweep_settings(classes=SWEEP_CLASSES):
    """The first seeded stage-1 setting of each (grid_sp, disp_hw) class of
    ``classes`` (phase 5a's settings)."""
    from convexadam_torch.selfconfig import stage1_settings

    seeded = stage1_settings()
    settings = []
    for cls in classes:
        idx = [i for i, s in enumerate(seeded) if (s.grid_sp, s.disp_hw) == cls]
        check(bool(idx), f"no seeded stage-1 setting of class {cls}")
        settings.append(seeded[idx[0]])
    return settings


def _launch_checks(what, launches, expected, at_least=()):
    """Every kernel's launches against ``expected``; the names in
    ``at_least`` may launch more (exact re-scoring of an overflow case)."""
    print(f"launches, {what}: {launches}", flush=True)
    for name, want in expected.items():
        ok = launches[name] >= want if name in at_least else launches[name] == want
        check(ok, f"{what}: {launches[name]} launches of {name}, expected {want}")


def sweep_expected(**per_kernel):
    """Expected launches of every kernel: 0 but for ``per_kernel``."""
    out = {name: 0 for name in GLOBALS}
    out.update(per_kernel)
    return out


def _stage1_run(torch, dev, segs, settings, groups, what, checkpoint=None):
    """``run_stage1_sweep`` over ``settings`` on the three subjects, pairs
    :data:`SWEEP_PAIRS`: its launches (2 cost volumes and 15 IC steps a
    (setting, pair), one pruned search a label bucket and case), a finite
    result and the winner's Dice above the identity's.  Returns the result,
    the launches, the seconds, the peak and the identity's Dice."""
    from convexadam_torch.core.metrics import dice_coeff
    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.selfconfig import run_stage1_sweep

    P, S = len(SWEEP_PAIRS), len(settings)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = run_stage1_sweep(segs, segs, SWEEP_PAIRS, settings, L2R_LABELS,
                           checkpoint_path=checkpoint, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = S * P
    _launch_checks(what, launches, sweep_expected(
        cost_volume=2 * n, sample_trilinear_ic=IC_ITERS * n,
        nearest_sq_pruned=len(groups) * n), at_least=("nearest_sq_pruned",) if res.rescored else ())
    check(res.dice.shape == (S, 2) and bool(np.isfinite(res.dice).all())
          and bool(np.isfinite(res.hd95).all()) and bool((res.times > 0).all()),
          f"bad {what} result")
    ident = float(np.mean([
        dice_coeff(torch.from_numpy(segs[f]), torch.from_numpy(segs[m]), L2R_LABELS + 1).mean()
        for f, m in SWEEP_PAIRS]))
    check(res.dice[res.best, 0] > ident,
          f"{what}: winner's Dice {res.dice[res.best, 0]:.4f} not above the identity's {ident:.4f}")
    return res, launches, wall, peak, ident


def sweep_stage1_phase(torch, dev, segs, smi, results):
    """Phase 5a: ``run_stage1_sweep`` on the three subjects, pairs
    :data:`SWEEP_PAIRS`, over the first seeded setting of each class of
    :data:`SWEEP_CLASSES` (the result 5b-5d and 9c use), then over the
    first seeded setting of each other class the seeded sampler draws
    (:func:`seeded_classes`, 22 in all); each run's launches and winner
    against the identity, and every (setting, pair) of both against
    ``convex_field_semantic`` + ``evaluate_field`` composed outside the
    engine: Dice and HD95 exactly, SDlogJ to 1e-4 relative; each class's
    convex stage dense (2 cost volumes, no candidate block) and its peak
    above what was held before it (as 7e measures it) at most its
    ``dense_estimate`` and :data:`SWEEP_PEAK_MARGIN_GB`.  Returns the four
    classes' settings, result and launches (the other run's added to them),
    the label buckets and the (2, 5) class's field of the first pair (for
    phase 5e)."""
    from convexadam_torch import evaluate_field
    from convexadam_torch.core import convex
    from convexadam_torch.selfconfig.checkpoint import SweepCheckpointer
    from convexadam_torch.selfconfig.engine import _suggest_label_groups, convex_field_semantic

    settings = sweep_settings()
    others = sweep_settings([c for c in seeded_classes() if c not in SWEEP_CLASSES])
    groups, global_cap = _suggest_label_groups(segs, L2R_LABELS)
    SweepCheckpointer(SWEEP_CHECKPOINT).clear()
    P = len(SWEEP_PAIRS)
    res, launches, wall, sweep_peak, ident = _stage1_run(
        torch, dev, segs, settings, groups, "stage-1 sweep", SWEEP_CHECKPOINT)
    res_o, launches_o, wall_o, peak_o, _ = _stage1_run(
        torch, dev, segs, others, groups, "stage-1 sweep, the other classes")

    # every (setting, pair) of both runs composed outside the engine, each
    # convex stage counted and its peak read
    rows, field25, classes = [], None, []
    sd_tol, neg_tol = 1e-4, 1e-6  # float32 std and mean against evaluate_field's float64
    worst = {"dice": 0.0, "hd95": 0.0, "sdlogj_rel": 0.0, "neg_jac_frac": 0.0}
    runs = [(st, res, s) for s, st in enumerate(settings)] + \
           [(st, res_o, s) for s, st in enumerate(others)]
    for st, r, s in runs:
        cls = (st.grid_sp, st.disp_hw)
        est = convex.dense_estimate(st.disp_hw, [n // st.grid_sp for n in ABDOMEN_SHAPE]) / 1e9
        over = []
        for i, (f, m) in enumerate(SWEEP_PAIRS):
            field, l_c, secs_c, peak_c, start_c = _run7(torch, lambda: convex_field_semantic(
                segs[f], segs[m], st.nn_mult, L2R_LABELS + 1, st.grid_sp, st.disp_hw, device=dev))
            where = f"stage 1 {st}, pair {(f, m)}"
            _launch_checks(f"{where}, convex stage (dense)", l_c, sweep_expected(
                cost_volume=2, sample_trilinear_ic=IC_ITERS))
            over.append(peak_c - start_c)
            check(over[-1] <= est + SWEEP_PEAK_MARGIN_GB,
                  f"{where}: convex stage peak {over[-1]:.3f} GB above the {start_c:.3f} GB held "
                  f"before, over the {est:.3f} GB estimate + {SWEEP_PEAK_MARGIN_GB} GB")
            if cls == (2, 5) and i == 0:
                field25 = field
            ev = evaluate_field(field.permute(1, 2, 3, 0), segs[f], segs[m], L2R_LABELS,
                                device=dev)
            c = {k: r.cases[k][s, i] for k in ("dice", "hd95", "sdlogj", "neg_jac_frac")}
            hd_case = float(np.mean(ev["hd95"].astype(np.float64)))
            errs = {"dice": float(np.abs(ev["dice"] - c["dice"]).max()),
                    "hd95": abs(hd_case - float(c["hd95"])),
                    "sdlogj_rel": abs(ev["sdlogj"] - float(c["sdlogj"])) / ev["sdlogj"],
                    "neg_jac_frac": abs(ev["neg_jac_frac"] - float(c["neg_jac_frac"]))}
            for k in worst:
                worst[k] = max(worst[k], errs[k])
            check(errs["dice"] == 0.0, f"{where}: engine Dice differs from evaluate_field's")
            check(errs["hd95"] == 0.0, f"{where}: engine HD95 {c['hd95']} != {hd_case}")
            check(errs["sdlogj_rel"] <= sd_tol, f"{where}: SDlogJ rel err {errs['sdlogj_rel']}")
            check(errs["neg_jac_frac"] <= neg_tol, f"{where}: neg. Jacobian err {errs['neg_jac_frac']}")
            rows.append({"setting": list(dataclasses.astuple(st)), "pair": [f, m],
                         "dice_mean": float(np.mean(ev["dice"])), "hd95_mean": hd_case,
                         "sdlogj": ev["sdlogj"], "neg_jac_frac": ev["neg_jac_frac"],
                         "convex_s": secs_c, "convex_peak_above_gb": over[-1]})
            del field
        classes.append({"class": list(cls), "setting": list(dataclasses.astuple(st)),
                        "coarse_grid": [n // st.grid_sp for n in ABDOMEN_SHAPE],
                        "seconds_per_setting": float(r.times[s]), "dice": float(r.dice[s, 0]),
                        "hd95": float(r.hd95[s]), "dense_estimate_gb": est,
                        "convex_peak_above_gb": max(over), "dense": True})
        print(f"stage 1, class {cls} {st}: {r.times[s]:.4f} s per setting ({P} pairs at "
              f"{ABDOMEN_SHAPE}); Dice {r.dice[s, 0]:.4f}, HD95 {r.hd95[s]:.4f}; convex stage "
              f"dense, peak {max(over):.3f} GB above what it held before (estimate {est:.3f} GB) "
              f"[{smi}]", flush=True)
    check(field25 is not None, "no (2, 5) setting composed")
    out = {
        "shape": list(ABDOMEN_SHAPE), "labels": L2R_LABELS, "pairs": [list(p) for p in SWEEP_PAIRS],
        "settings": [list(dataclasses.astuple(s)) for s in settings],
        "classes": [list(c) for c in SWEEP_CLASSES], "label_buckets": [[list(l), k] for l, k in groups],
        "global_cap": global_cap, "dice": res.dice.tolist(), "jstd": res.jstd.tolist(),
        "hd95": res.hd95.tolist(), "times_s": res.times.tolist(), "rank": res.rank.tolist(),
        "best": res.best, "identity_dice": ident, "rescored": res.rescored,
        "rescore_s": res.rescore_sec, "wall_s": wall, "sweep_peak_gb": sweep_peak,
        "other_classes": {"settings": [list(dataclasses.astuple(s)) for s in others],
                          "times_s": res_o.times.tolist(), "best": res_o.best,
                          "rescored": res_o.rescored, "wall_s": wall_o, "sweep_peak_gb": peak_o,
                          "launches": launches_o},
        "per_class": classes, "peak_margin_gb": SWEEP_PEAK_MARGIN_GB,
        "max_err_vs_composed": worst,
        "tolerances": {"dice": 0.0, "hd95": 0.0, "sdlogj_rel": sd_tol, "neg_jac_frac": neg_tol},
        "composed": rows, "launches": launches, "card": smi,
    }
    print(f"stage 1: winner {settings[res.best]} Dice {res.dice[res.best, 0]:.4f} (identity "
          f"{ident:.4f}); rescored {res.rescored}; sweep {wall:.2f} s wall, peak "
          f"{sweep_peak:.2f} GB; the other {len(others)} classes {wall_o:.2f} s wall, peak "
          f"{peak_o:.2f} GB, winner {others[res_o.best]} [{smi}]; engine vs composed: "
          f"Dice {worst['dice']}, HD95 {worst['hd95']}, SDlogJ rel {worst['sdlogj_rel']:.2e} "
          f"(tol {sd_tol}), neg. fraction {worst['neg_jac_frac']:.2e} (tol {neg_tol})", flush=True)
    results["sweep_stage1"] = out
    total = {k: launches[k] + launches_o[k] for k in launches}
    return settings, res, total, field25


def sweep_stage2_phase(torch, dev, segs, winner, smi, results):
    """Phase 5b: ``run_stage2_sweep`` from 5a's winner over the first seeded
    Adam settings with each grid_sp_adam of :data:`SWEEP_ADAM_GRIDS`; its
    launches; the 16 variants of the first pair at each setting of
    :data:`SWEEP_RECOMPUTED_GRIDS` recomputed outside the engine against
    ``evaluate_field``, those at grid_sp_adam 3 (the 64 x 53 x 85 Adam
    grid) with the first calls of each kernel wrapper recorded and held to
    their plain versions (:func:`hold_recorded_calls`)."""
    from convexadam_torch import evaluate_field
    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.selfconfig import run_stage2_sweep, stage2_settings
    from convexadam_torch.selfconfig.engine import (
        _cost_scale,
        _stage2_variants,
        _suggest_label_groups,
        convex_field_semantic,
    )

    seeded = stage2_settings()
    adam = [next(s for s in seeded if s.grid_sp_adam == g) for g in SWEEP_ADAM_GRIDS]
    groups, _ = _suggest_label_groups(segs, L2R_LABELS)
    P, S = len(SWEEP_PAIRS), len(adam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = run_stage2_sweep(segs, segs, SWEEP_PAIRS, winner, adam, L2R_LABELS, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _launch_checks("stage-2 sweep", launches, sweep_expected(
        cost_volume=2 * P, sample_trilinear_ic=IC_ITERS * P, warp_ssd_loss_grad=ADAM_ITERS * S * P,
        nearest_sq_pruned=len(groups) * 16 * S * P),
        at_least=("nearest_sq_pruned",) if res.rescored else ())
    check(res.dice.shape == (S * 16, 2) and bool(np.isfinite(res.dice).all())
          and bool(np.isfinite(res.hd95).all()) and bool(np.isfinite(res.jstd).all()),
          "bad stage-2 sweep result")

    # the first pair's 16 fields recomputed outside, at each setting of
    # SWEEP_RECOMPUTED_GRIDS; at grid_sp_adam 3 the kernel calls recorded
    f, m = SWEEP_PAIRS[0]
    pf, pm = (torch.from_numpy(segs[k]).to(dev) for k in (f, m))
    worst = {"dice": 0.0, "hd95": 0.0}
    held: dict = {}
    for g in SWEEP_RECOMPUTED_GRIDS:
        s = SWEEP_ADAM_GRIDS.index(g)
        st, calls = adam[s], []
        with (_recording(torch, calls) if g == 3 else contextlib.nullcontext()):
            coarse = convex_field_semantic(pf, pm, winner.nn_mult, L2R_LABELS + 1,
                                           winner.grid_sp, winner.disp_hw, coarse=True, device=dev)
            fields = list(_stage2_variants(pf, pm, coarse, winner.nn_mult, st.lambda_weight,
                                           st.grid_sp_adam, st.effective_avg_n, L2R_LABELS,
                                           _cost_scale(pf, pm, L2R_LABELS)))
        for v, field in enumerate(fields):
            ev = evaluate_field(field.permute(1, 2, 3, 0), segs[f], segs[m], L2R_LABELS,
                                device=dev)
            it, kk = divmod(v, 4)
            d_err = float(np.abs(ev["dice"] - res.cases["dice"][s, 0, it, kk]).max())
            h_err = abs(float(np.mean(ev["hd95"].astype(np.float64)))
                        - res.cases["hd95"][s, 0, it, kk])
            worst = {"dice": max(worst["dice"], d_err), "hd95": max(worst["hd95"], h_err)}
            check(d_err == 0.0 and h_err == 0.0, f"stage 2 {st} variant {v}: Dice err {d_err}, "
                  f"HD95 err {h_err} against evaluate_field")
        del fields
        if calls:
            used = {k: 1 for k in ("cost_volume", "sample_trilinear_ic", "warp_ssd_loss_grad")}
            rows = hold_recorded_calls(torch, f"5b grid_sp_adam {g}", calls, used)
            check(any(r["args"]["mov"][1:4] == [n // g for n in ABDOMEN_SHAPE]
                      for r in rows["warp_ssd_loss_grad"]),
                  f"5b: no data-term call on the grid_sp_adam {g} grid recorded")
            held[g] = {k: [{n: v for n, v in r.items() if n != "run"} for r in rows_k]
                       for k, rows_k in rows.items()}
        del calls
    out = {
        "convex_setting": list(dataclasses.astuple(winner)),
        "adam_settings": [list(dataclasses.astuple(s)) for s in adam],
        "dice": res.dice.tolist(), "jstd": res.jstd.tolist(), "hd95": res.hd95.tolist(),
        "times_s": res.times.tolist(), "best": res.best, "rescored": res.rescored,
        "rescore_s": res.rescore_sec, "wall_s": wall, "peak_gb": peak,
        "recomputed_grids": list(SWEEP_RECOMPUTED_GRIDS), "max_err_vs_recomputed": worst,
        "held_calls": held, "launches": launches, "card": smi,
    }
    for s, a in enumerate(adam):
        print(f"stage 2, {a}: {res.times[s]:.4f} s per setting ({P} pairs x 16 variants at "
              f"{ABDOMEN_SHAPE}); best Dice {res.dice[s * 16:(s + 1) * 16, 0].max():.4f} "
              f"[{smi}]", flush=True)
    print(f"stage 2: winner variant {res.best} Dice {res.dice[res.best, 0]:.4f}; rescored "
          f"{res.rescored}; sweep {wall:.2f} s wall, peak {peak:.2f} GB; 16 variants at "
          f"grid_sp_adam {SWEEP_RECOMPUTED_GRIDS} vs evaluate_field: Dice {worst['dice']}, HD95 "
          f"{worst['hd95']}", flush=True)
    results["sweep_stage2"] = out
    return adam, launches


def sweep_paired_phase(torch, dev, adam, smi, results):
    """Phase 5c: both paired sweeps on two MIND pairs at 192^3 (headline
    texture, two seeds and shifts, 20 keypoints each): the first seeded
    paired settings with distinct (r, d) and grid_sp >= 3, then one Adam
    setting (grid_sp_adam 2).  Returns the two runs' launches."""
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.selfconfig import stage1_paired_settings
    from convexadam_torch.selfconfig.paired import (
        run_stage1_paired_sweep,
        run_stage2_paired_sweep,
    )

    vols, movs, kfs, kms = [], [], [], []
    rng = np.random.default_rng(3)
    c = HEADLINE_SHAPE[0] // 6  # keypoints away from the faces, as in phase 4c
    for seed, shift in enumerate(PAIRED_SHIFTS):
        v, mv = headline_pair(torch, resize_trilinear, HEADLINE_SHAPE, shift, seed)
        vols.append(v)
        movs.append(mv)
        kf = rng.uniform(c, HEADLINE_SHAPE[0] - c, (PAIRED_KEYPOINTS, 3)).astype(np.float32)
        kfs.append(kf)
        kms.append(kf + np.asarray(shift, np.float32))
    tre0 = float(np.mean([np.linalg.norm(s) for s in PAIRED_SHIFTS]))
    settings, seen = [], set()
    for st in stage1_paired_settings():
        if st.grid_sp >= 3 and (st.mind_r, st.mind_d) not in seen:
            seen.add((st.mind_r, st.mind_d))
            settings.append(st)
        if len(settings) == 3:
            break
    P, S = len(vols), len(settings)
    torch.cuda.synchronize()
    reset_launches()
    r1 = run_stage1_paired_sweep(np.stack(vols), np.stack(movs), kfs, kms, settings, device=dev)
    l1 = dict(LAUNCHES)
    _launch_checks("paired stage 1", l1, sweep_expected(
        mind_ssd_stats=2 * S * P, cost_volume=2 * S * P, sample_trilinear_ic=IC_ITERS * S * P))
    check(r1.dice[r1.best, 0] < tre0,
          f"paired stage 1: winner TRE {r1.dice[r1.best, 0]:.4f} not below the initial {tre0:.4f}")
    torch.cuda.synchronize()
    reset_launches()
    r2 = run_stage2_paired_sweep(np.stack(vols), np.stack(movs), kfs, kms, settings[r1.best],
                                 [adam], device=dev)
    l2 = dict(LAUNCHES)
    _launch_checks("paired stage 2", l2, sweep_expected(
        mind_ssd_stats=2 * P, cost_volume=2 * P, sample_trilinear_ic=IC_ITERS * P,
        warp_ssd_loss_grad=ADAM_ITERS * P))
    check(bool(np.isfinite(r2.dice).all()) and r2.dice[r2.best, 0] < tre0,
          f"paired stage 2: winner TRE {r2.dice[r2.best, 0]:.4f} not below the initial {tre0:.4f}")
    out = {"shape": list(HEADLINE_SHAPE), "shifts": [list(s) for s in PAIRED_SHIFTS],
           "keypoints": PAIRED_KEYPOINTS, "initial_tre": tre0,
           "stage1_settings": [list(dataclasses.astuple(s)) for s in settings],
           "stage1_tre": r1.dice.tolist(), "stage1_times_s": r1.times.tolist(), "stage1_best": r1.best,
           "adam_setting": list(dataclasses.astuple(adam)), "stage2_tre": r2.dice.tolist(),
           "stage2_times_s": r2.times.tolist(), "stage2_best": r2.best,
           "launches_stage1": l1, "launches_stage2": l2, "card": smi}
    print(f"paired stage 1 at {HEADLINE_SHAPE}: TRE {np.round(r1.dice[:, 0], 4).tolist()} "
          f"(initial {tre0:.4f}), {np.round(r1.times, 4).tolist()} s per setting; stage 2 "
          f"{adam}: best TRE {r2.dice[r2.best, 0]:.4f}, {r2.times[0]:.4f} s [{smi}]", flush=True)
    results["sweep_paired"] = out
    return l1, l2


def sweep_resume_phase(torch, dev, segs, settings, first, results):
    """Phase 5d: 5a resumed from its checkpoint with rolled (garbage)
    predictions: the arrays come back as they were, no cost volume runs."""
    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.selfconfig import run_stage1_sweep
    from convexadam_torch.selfconfig.checkpoint import SweepCheckpointer

    torch.cuda.synchronize()
    reset_launches()
    res = run_stage1_sweep(np.roll(segs, 7, axis=1), segs, SWEEP_PAIRS, settings, L2R_LABELS,
                           checkpoint_path=SWEEP_CHECKPOINT, resume=True, device=dev)
    launches = dict(LAUNCHES)
    _launch_checks("stage-1 resume", launches, sweep_expected())
    for k in ("dice", "jstd", "hd95", "times", "rank"):
        check(np.array_equal(getattr(res, k), getattr(first, k)), f"resume: {k} differs")
    check(res.best == first.best, "resume: another winner")
    SweepCheckpointer(SWEEP_CHECKPOINT).clear()
    print("stage-1 resume from the checkpoint: arrays identical, no kernel launched", flush=True)
    results["sweep_resume"] = {"identical": True, "launches": launches}
    return launches


def sweep_kernel_phase(torch, dev, segs, settings, field25, records, results):
    """Phase 5e: the kernels at shapes the sweep gives them and no earlier
    phase did, each against its plain version: the cost volume and the
    inverse-consistency steps of the (2, 5) class (14 x 96 x 80 x 128 at
    q = 5), the data term on the grid_sp_adam = 1 grid (14 x 192 x 160 x
    256, bfloat16), and the batched pruned search at the sweep's label
    buckets on the (2, 5) class's warped labels.  Adds each reading to the
    kernel's record as ``at_sweep_shape``."""
    from convexadam_torch.core.features import semantic_features
    from convexadam_torch.core.smoothing import avg_pool3d
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.kernels.cost_volume import cost_volume, cost_volume_plain
    from convexadam_torch.kernels.warp import (
        inverse_consistency_steps,
        inverse_consistency_steps_plain,
        warp_ssd_loss_grad,
        warp_ssd_loss_grad_plain,
    )
    from convexadam_torch.selfconfig.engine import (
        _HD95Scorer,
        _suggest_label_groups,
        evaluate_field_semantic,
    )

    by_name = {r["name"]: r for r in records}
    out = {}
    st = next(s for s in settings if (s.grid_sp, s.disp_hw) == (2, 5))
    f, m = SWEEP_PAIRS[0]
    sf, sm = (torch.from_numpy(segs[k]).to(dev) for k in (f, m))
    with torch.no_grad():
        ff, fm = semantic_features(sf, sm, L2R_LABELS + 1, mult=1.0)
        fix_s = avg_pool3d(ff * st.nn_mult, st.grid_sp).contiguous()
        mov_s = avg_pool3d(fm * st.nn_mult, st.grid_sp).contiguous()
    C, h, w, d = fix_s.shape
    q, K3, n = st.disp_hw, (2 * st.disp_hw + 1) ** 3, h * w * d
    ck = cost_volume(fix_s, mov_s, q)
    cp = cost_volume_plain(fix_s, mov_s, q)
    torch.cuda.synchronize()
    err = max_err(ck, cp)
    del ck, cp
    check(err == 0.0, f"cost_volume at the (2, 5) class {(C, h, w, d)}: max err {err}")
    t = timed_turns(torch, lambda: cost_volume(fix_s, mov_s, q), GLOBALS["cost_volume"])
    p_ms = cuda_ms(torch, lambda: cost_volume_plain(fix_s, mov_s, q), 1, 3)
    b_ms, b_by = bound_ms(2 * C * n * 4 + K3 * n * 4, 3.0 * K3 * n * C, PEAK_F32_UNFUSED)
    out["cost_volume"] = {"shape": [C, h, w, d, q], "max_abs_err": err, "call_ms": t["call_ms"],
                          "device_ms": t["device_ms"], "plain_ms": p_ms, "bound_ms": b_ms,
                          "bound_by": b_by}
    print_times(f"cost_volume at the (2, 5) class {(C, h, w, d)} q={q} (max_abs_err {err})", t,
                p_ms, b_ms)
    del fix_s, mov_s

    gen = torch.Generator().manual_seed(5)
    fields = (torch.randn((2, 3, h, w, d), generator=gen) * 0.1).to(dev)
    ko = inverse_consistency_steps(fields, IC_ITERS)
    po = inverse_consistency_steps_plain(fields, IC_ITERS)
    torch.cuda.synchronize()
    err = max_err(ko, po)
    check(err == 0.0, f"inverse_consistency_steps at {(2, 3, h, w, d)}: max err {err}")
    t = timed_turns(torch, lambda: inverse_consistency_steps(fields, IC_ITERS),
                    GLOBALS["sample_trilinear_ic"])
    p_ms = cuda_ms(torch, lambda: inverse_consistency_steps_plain(fields, IC_ITERS), 1, 3)
    b_ms, b_by = bound_ms(2 * (2 * 3 * n * 4) + 4 * (h + w + d), 2.0 * n * (30 + 3 * 17))
    out["sample_trilinear_ic"] = {"shape": [2, 3, h, w, d], "max_abs_err": err,
                                  "call_ms": t["call_ms"] / IC_ITERS,
                                  "device_ms": t["device_ms"] / IC_ITERS,
                                  "plain_ms": p_ms / IC_ITERS, "bound_ms": b_ms, "bound_by": b_by}
    print_times(f"inverse_consistency_steps {(2, 3, h, w, d)} x {IC_ITERS} (max_abs_err {err})",
                t, p_ms)
    del fields, ko, po

    # the data term on the full-resolution Adam grid, bf16 moving features
    H, W, D = ABDOMEN_SHAPE
    N = H * W * D
    fix_flat = ff.float().reshape(C, N).contiguous() * st.nn_mult
    mov = (fm * st.nn_mult).to(torch.bfloat16).contiguous()
    del ff, fm
    coarse = torch.randn((3, H // 8, W // 8, D // 8), generator=gen) * 2.0
    disp = resize_trilinear(coarse, (H, W, D)).to(dev).contiguous()
    fac = (H / (H - 1.0), W / (W - 1.0), D / (D - 1.0))
    chain = 2.0 * 14.0 / (C * N)
    ssq_k, rows_k = warp_ssd_loss_grad(mov, disp, fix_flat, fac, chain)
    ssq_p, rows_p = warp_ssd_loss_grad_plain(mov, disp, fix_flat, fac, chain)
    torch.cuda.synchronize()
    err = max_err(rows_k, rows_p)
    ssq_rel = abs(float(ssq_k) - float(ssq_p)) / float(ssq_p)
    del rows_k, rows_p
    check(err == 0.0 and ssq_rel <= 1e-5,
          f"warp_ssd_loss_grad at {(C, H, W, D)} bf16: rows err {err}, sum(res^2) rel {ssq_rel}")
    t = timed_turns(torch, lambda: warp_ssd_loss_grad(mov, disp, fix_flat, fac, chain),
                    GLOBALS["warp_ssd_loss_grad"])
    p_ms = cuda_ms(torch, lambda: warp_ssd_loss_grad_plain(mov, disp, fix_flat, fac, chain), 1, 3)
    b_ms, b_by = bound_ms(C * N * (2 + 4) + 3 * N * 4 * 2, 1.0 * N * (C * 37 + 110))
    out["warp_ssd_loss_grad"] = {"shape": [C, H, W, D], "dtype": "bfloat16", "max_abs_err": err,
                                 "ssq_rel_err": ssq_rel, "call_ms": t["call_ms"],
                                 "device_ms": t["device_ms"], "plain_ms": p_ms,
                                 "bound_ms": b_ms, "bound_by": b_by}
    print_times(f"warp_ssd_loss_grad {(C, H, W, D)} bf16 (rows max_abs_err {err}, sum(res^2) rel "
                f"{ssq_rel:.2e})", t, p_ms, b_ms)
    del mov, disp, fix_flat

    # the batched pruned search at the sweep's buckets, on the (2, 5) field
    groups, kg = _suggest_label_groups(segs, L2R_LABELS)
    scorer = _HD95Scorer(L2R_LABELS, groups, kg, dev)
    _, _, _, seg_w = evaluate_field_semantic(field25, sf, sm, L2R_LABELS, device=dev)
    _, bufs = scorer.buffers(sf, scorer.prep(sf), seg_w)
    rows = pruned_bucket_rows(torch, bufs, scorer.caps, groups, "sweep bucket", plain_reps=3)
    out["nearest_sq_pruned"] = rows
    for name, reading in out.items():
        by_name[name]["at_sweep_shape"] = reading
    results["sweep_kernels"] = out


class _InjectedCrash(RuntimeError):
    """The fault phase 5f injects into the engine."""


@contextlib.contextmanager
def _patched(patches):
    """``(module, name, value)`` patches, undone on the way out."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, value in patches:
            setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def _crash_at(fn, call: int):
    """``fn`` that raises :class:`_InjectedCrash` at its ``call``-th call
    (from 1) instead of running."""
    count = [0]

    def wrapped(*args, **kwargs):
        count[0] += 1
        if count[0] == call:
            raise _InjectedCrash(f"injected at call {call} of {fn.__name__}")
        return fn(*args, **kwargs)

    return wrapped


def protocol_phase(torch, dev, smi, records, results):
    """Phase 5f: ``run_full_protocol`` on the sweep fixture of
    ``selfconfig/protocol.py`` (10 subjects at :data:`PROTOCOL_SHAPE`, 13
    organs, predictions equal to the ground truth) over the reference's 8
    pairs, the first seeded settings of each stage (:data:`PROTOCOL_SETTINGS`):
    launches per (setting, pair) of each stage (2 cost volumes and 15 IC
    steps in stage 1; pass A's, then 120 data terms in stage 2; one batched
    pruned search per label bucket per case, which takes two launches where
    its order tables outgrow one, ``pruned_launch_count``), both winners
    above the identity's Dice.  Then the run again under a checkpoint, stopped by a fault
    injected into the engine once :data:`PROTOCOL_CRASH` settings of stage 1
    have finished, resumed and stopped again in stage 2 the same way, and
    resumed to its end: the arrays, ranks and winners of both stages equal
    the uninterrupted run's to the bit, and each resume launches kernels only
    for the settings that had not finished.  Last, the batched pruned search
    at the fixture's label buckets, as the engine builds them on the first
    pair's labels warped by the stage-1 winner, against its plain version
    (:func:`pruned_bucket_rows`), each bucket's launches those of
    :func:`pruned_launch_count`; the readings go to the kernel's record as
    ``at_protocol_buckets``.  Returns each protocol run's launches."""
    from convexadam_torch.core.metrics import dice_coeff
    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.kernels.edt import pruned_launch_count
    from convexadam_torch.selfconfig import engine, protocol
    from convexadam_torch.selfconfig.engine import (
        _HD95Scorer,
        _suggest_label_groups,
        convex_field_semantic,
        evaluate_field_semantic,
    )

    t_phase = time.perf_counter()
    segs, L = protocol.make_sweep_fixture(*PROTOCOL_SHAPE)
    pairs = protocol.REF_PAIRS
    P, (n1, n2), (c1, c2) = len(pairs), PROTOCOL_SETTINGS, PROTOCOL_CRASH
    groups, kg = _suggest_label_groups(segs, L)
    # a case's pruned launches: one batched call a bucket, of 4 searches a
    # label, cut where its order tables outgrow a launch's
    B = sum(pruned_launch_count(4 * len(labs), k, k) for labs, k in groups)
    fixture_s = time.perf_counter() - t_phase
    shutil.rmtree(PROTOCOL_DIR, ignore_errors=True)

    def run(tag, resume=False, patches=(), crash=False):
        """One ``run_full_protocol`` call, its launches split where stage 2
        starts; with ``crash``, the injected fault must stop it."""
        marks = {}
        stage2 = protocol.run_stage2_sweep

        def marked(*args, **kwargs):
            torch.cuda.synchronize()
            marks["stage1"] = dict(LAUNCHES)
            return stage2(*args, **kwargs)

        res = None
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with _patched([(protocol, "run_stage2_sweep", marked), *patches]):
            try:
                res = protocol.run_full_protocol(segs, segs, pairs, L, n1=n1, n2=n2,
                                                 checkpoint=PROTOCOL_DIR / tag, resume=resume,
                                                 device=dev)
            except _InjectedCrash as e:
                print(f"5f {tag}: stopped by the fault ({e})", flush=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check((res is None) == crash, f"5f {tag}: {'no' if crash else 'a'} stop")
        total = dict(LAUNCHES)
        first = marks.get("stage1", total)
        return res, first, {k: total[k] - first[k] for k in total}, wall

    def expected(s1, s2, pass_a):
        return (sweep_expected(cost_volume=2 * s1 * P, sample_trilinear_ic=IC_ITERS * s1 * P,
                               nearest_sq_pruned=B * s1 * P),
                sweep_expected(cost_volume=2 * P * pass_a, sample_trilinear_ic=IC_ITERS * P * pass_a,
                               warp_ssd_loss_grad=ADAM_ITERS * s2 * P,
                               nearest_sq_pruned=B * 16 * s2 * P))

    def launch_checks(what, got, want, res):
        at_least = ("nearest_sq_pruned",) if res.rescored else ()
        _launch_checks(what, got, want, at_least)

    ref, l1, l2, wall = run("whole")
    w1, w2 = expected(n1, n2, 1)
    launch_checks("5f stage 1", l1, w1, ref.stage1)
    launch_checks("5f stage 2", l2, w2, ref.stage2)
    for name, r in (("stage 1", ref.stage1), ("stage 2", ref.stage2)):
        check(bool(np.isfinite(r.dice).all()) and bool(np.isfinite(r.hd95).all())
              and bool(np.isfinite(r.jstd).all()), f"5f {name}: a metric not finite")
    ident = float(np.mean([dice_coeff(torch.from_numpy(segs[f]), torch.from_numpy(segs[m]),
                                      L + 1).mean() for f, m in pairs]))
    for name, r in (("stage 1", ref.stage1), ("stage 2", ref.stage2)):
        check(r.dice[r.best, 0] > ident, f"5f {name}: winner's Dice {r.dice[r.best, 0]:.4f} not "
              f"above the identity's {ident:.4f}")

    # stopped in stage 1, resumed and stopped in stage 2, resumed to the end
    crash1 = (engine, "convex_field_semantic",
              _crash_at(engine.convex_field_semantic, c1 * P + PROTOCOL_CRASH_PAIR))
    crash2 = (engine, "_stage2_variants",
              _crash_at(engine._stage2_variants, c2 * P + PROTOCOL_CRASH_PAIR))
    _, _, _, wall_a = run("stopped", patches=[crash1], crash=True)
    _, r1_b, _, wall_b = run("stopped", resume=True, patches=[crash2], crash=True)
    launch_checks("5f resume 1, stage 1", r1_b, expected(n1 - c1, 0, 0)[0], ref.stage1)
    res, r1_c, r2_c, wall_c = run("stopped", resume=True)
    w1, w2 = expected(0, n2 - c2, 1)
    launch_checks("5f resume 2, stage 1", r1_c, w1, res.stage1)
    launch_checks("5f resume 2, stage 2", r2_c, w2, res.stage2)
    for name, got, want in (("stage 1", res.stage1, ref.stage1), ("stage 2", res.stage2, ref.stage2)):
        for k in ("dice", "jstd", "hd95", "rank"):
            check(np.array_equal(getattr(got, k), getattr(want, k)), f"5f resumed {name}: {k} differs")
        check(got.best == want.best, f"5f resumed {name}: winner {got.best}, not {want.best}")
    rec = [r["resumed_settings"] for r in res.records[:2]]
    check(rec == [n1, c2], f"5f resumed settings {rec}, expected {[n1, c2]}")
    shutil.rmtree(PROTOCOL_DIR)

    # the batched pruned search at the fixture's buckets (the 4-organ one in
    # two launches), on the first pair's labels warped by the stage-1 winner
    t_pruned = time.perf_counter()
    best1 = protocol.stage1_settings(n1)[ref.stage1.best]
    f, m = pairs[0]
    sf, sm = (torch.from_numpy(segs[k]).to(dev) for k in (f, m))
    scorer = _HD95Scorer(L, groups, kg, dev)
    with torch.no_grad():
        field = convex_field_semantic(sf, sm, best1.nn_mult, L + 1, best1.grid_sp,
                                      best1.disp_hw, device=dev)
        _, _, _, seg_w = evaluate_field_semantic(field, sf, sm, L, device=dev)
        _, bufs = scorer.buffers(sf, scorer.prep(sf), seg_w)
    pruned = pruned_bucket_rows(torch, bufs, scorer.caps, groups, "protocol bucket",
                                timed=False)
    for row, (labs, k) in zip(pruned, groups):
        _launch_checks(f"5f nearest_sq_pruned {row['case']}",
                       {"nearest_sq_pruned": row["launches"]},
                       {"nearest_sq_pruned": pruned_launch_count(4 * len(labs), k, k)})
    records_by_name = {r["name"]: r for r in records}
    records_by_name["nearest_sq_pruned"]["at_protocol_buckets"] = pruned
    pruned_s = time.perf_counter() - t_pruned
    del field, seg_w, bufs, sf, sm

    r1, r2, total = ref.records
    seconds = time.perf_counter() - t_phase
    out = {
        "shape": list(PROTOCOL_SHAPE), "subjects": int(segs.shape[0]), "labels": L,
        "pairs": [list(p) for p in pairs], "label_buckets": [[list(l), k] for l, k in groups],
        "pruned_launches_per_case": B,
        "stage1_settings": [list(dataclasses.astuple(s)) for s in protocol.stage1_settings(n1)],
        "stage2_settings": [list(dataclasses.astuple(s)) for s in protocol.stage2_settings(n2)],
        "records": ref.records, "identity_dice": ident,
        "stage1_dice": ref.stage1.dice.tolist(), "stage1_times_s": ref.stage1.times.tolist(),
        "stage2_times_s": ref.stage2.times.tolist(),
        "stage2_best_dice": float(ref.stage2.dice[ref.stage2.best, 0]),
        "launches_stage1": l1, "launches_stage2": l2,
        "resume": {"crash_after": [c1, c2], "wall_s": [wall_a, wall_b, wall_c],
                   "launches_resume1_stage1": r1_b, "launches_resume2_stage1": r1_c,
                   "launches_resume2_stage2": r2_c, "resumed_settings": rec, "identical": True},
        "pruned_buckets": pruned, "pruned_buckets_s": pruned_s,
        "wall_s": wall, "fixture_s": fixture_s, "phase_s": seconds, "card": smi,
    }
    print(f"5f protocol on {segs.shape[0]} subjects at {PROTOCOL_SHAPE}, {P} pairs, {L} organs in "
          f"{len(groups)} buckets ({B} pruned launches a case): stage 1 {n1} settings {r1['minutes'] * 60:.2f} s, "
          f"{r1['sec_per_setting_pair']:.4f} s a setting·pair, peak {r1['peak_allocated_gb']} GB, "
          f"winner {r1['best']} Dice {ref.stage1.dice[ref.stage1.best, 0]:.4f} (identity "
          f"{ident:.4f}), rescored {r1['rescored']} ({r1['rescore_sec']:.2f} s); stage 2 {n2} "
          f"settings {r2['minutes'] * 60:.2f} s, {r2['sec_per_setting_pair']:.4f} s a "
          f"setting·pair, peak {r2['peak_allocated_gb']} GB, variant {ref.stage2.best} Dice "
          f"{out['stage2_best_dice']:.4f}, rescored {r2['rescored']} ({r2['rescore_sec']:.2f} s); "
          f"stopped twice and resumed: equal to the bit; the pruned search at the {len(groups)} "
          f"buckets ({[r['launches'] for r in pruned]} launches) equal to its plain version; "
          f"phase {seconds:.2f} s [{smi}]", flush=True)
    results["sweep_protocol"] = out
    return {"protocol": {k: l1[k] + l2[k] for k in l1},
            "protocol_resumes": {k: r1_b[k] + r1_c[k] + r2_c[k] for k in r1_b}}

# ---------------------------------------------------------------------------
# phase 6: the file-level path, from files on disk
# ---------------------------------------------------------------------------


def _write_nib(path, data, affine=None):
    from convexadam_torch.geometry.io import save_volume_nib_order

    save_volume_nib_order(data, FILE_AFFINE if affine is None else affine, path)


def _read_nib(path):
    from convexadam_torch.geometry.io import load_volume_nib_order

    return load_volume_nib_order(path)


def _counted(torch, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after (the card synchronized): (result, launches, seconds)."""
    from convexadam_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(LAUNCHES), time.perf_counter() - t0


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(np.array_equal(a, b))


def body_mask(shape):
    """An ellipsoidal body mask, semi-axes :data:`BODY_AXES` of each extent
    (it holds the central crop and leaves the corners out), uint8."""
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    r2 = sum(((g - (s - 1) / 2) / (BODY_AXES * s)) ** 2 for g, s in zip(grids, shape))
    return (r2 <= 1.0).astype(np.uint8)


def ct_volume(seg, seed):
    """CT-like intensities of a label volume: a soft-tissue body, a
    Hounsfield-like value per organ, smooth noise."""
    import torch

    from convexadam_torch.core.warp import resize_trilinear

    rng = np.random.default_rng(seed)
    hu = np.concatenate([[-100.0], rng.uniform(20, 220, seg.max())]).astype(np.float32)
    noise = rng.standard_normal([max(2, s // 4) for s in seg.shape]).astype(np.float32)
    noise = resize_trilinear(torch.from_numpy(noise)[None], seg.shape)[0].numpy()
    return hu[seg] + 25.0 * noise


def register_file_phase(torch, dev, d, results):
    """Phase 6a: ``cli.register.main`` on a masked MIND pair at the Abdomen
    shape, against ``convex_adam(mask_infill(...))`` on the same arrays;
    then the multi-output files.  Returns the launches and the paths."""
    from convexadam_torch.cli import register
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.pipeline.convex_adam import convex_adam
    from convexadam_torch.pipeline.preprocess import mask_infill

    vol, mov = headline_pair(torch, resize_trilinear, shape=ABDOMEN_SHAPE, shift=HEADLINE_SHIFT)
    mask_f = body_mask(ABDOMEN_SHAPE)
    mask_m = np.roll(mask_f, HEADLINE_SHIFT, axis=(0, 1, 2))
    t0 = time.perf_counter()
    paths = {k: d / f"{k}.nii.gz" for k in ("fixed", "moving", "mask_fixed", "mask_moving")}
    for k, a in zip(paths, (vol, mov, mask_f, mask_m)):
        _write_nib(paths[k], a)
    inputs_s = time.perf_counter() - t0
    args = ["-f", str(paths["fixed"]), "-m", str(paths["moving"]), "--use_mask", "True",
            "--path_mask_fixed", str(paths["mask_fixed"]),
            "--path_mask_moving", str(paths["mask_moving"]), "--device", str(dev)]
    _, launches, reg_s = _counted(torch, lambda: register.main(args + ["--result_path", str(d)]))
    _launch_checks("cli.register --use_mask", launches, sweep_expected(**EXPECTED_LAUNCHES))
    disp, affine = _read_nib(d / "disp.nii.gz")

    # composed outside the CLI on the arrays the files hold
    f_arr, f_aff = _read_nib(paths["fixed"])
    m_arr, _ = _read_nib(paths["moving"])
    mf, mm = _read_nib(paths["mask_fixed"])[0], _read_nib(paths["mask_moving"])[0]
    ref = convex_adam(mask_infill(np.asarray(f_arr, np.float32), np.asarray(mf, np.float32),
                                  device=dev),
                      mask_infill(np.asarray(m_arr, np.float32), np.asarray(mm, np.float32),
                                  device=dev), device=dev)
    disp32 = np.asarray(disp, np.float32)
    check(_bits_equal(disp32, ref), "6a: disp.nii.gz differs from convex_adam(mask_infill(...)) "
          f"by {float(np.abs(disp32 - ref).max())}")
    check(bool(np.array_equal(affine, f_aff)), "6a: disp.nii.gz's affine is not the fixed image's")
    c = FILE_CROP
    err = np.abs(disp32[c:-c, c:-c, c:-c] - np.array(HEADLINE_SHIFT, np.float32))
    frac = float(np.mean(np.all(err < 1.0, axis=-1)))
    check(frac > 0.9, f"6a: shift recovered in only {frac:.2%} of the crop")

    # the multi-output files of one run
    multi = d / "multi"
    multi_args = args + ["--result_path", str(multi), "--multi_iters",
                         ",".join(map(str, FILE_MULTI_ITERS)), "--multi_smoothings",
                         ",".join(map(str, FILE_MULTI_SMOOTHINGS))]
    _, multi_launches, multi_s = _counted(torch, lambda: register.main(multi_args))
    _launch_checks("cli.register --multi_iters", multi_launches, sweep_expected(
        **dict(EXPECTED_LAUNCHES, warp_ssd_loss_grad=max(FILE_MULTI_ITERS))))
    written = sorted(p.name for p in multi.glob("disp_*.nii.gz"))
    want = sorted(f"disp_{it}_{sm}.nii.gz" for it in FILE_MULTI_ITERS
                  for sm in FILE_MULTI_SMOOTHINGS)
    check(written == want, f"6a: --multi_iters wrote {written}")
    last = np.asarray(_read_nib(multi / f"disp_{max(FILE_MULTI_ITERS)}_0.nii.gz")[0], np.float32)
    check(_bits_equal(last, disp32), "6a: the (80, 0) file differs from the single-output field "
          f"by {float(np.abs(last - disp32).max())}")
    out = {"shape": list(ABDOMEN_SHAPE), "inputs_write_s": inputs_s, "register_cli_s": reg_s,
           "multi_cli_s": multi_s, "frac_within_1vox": frac, "launches": launches,
           "launches_multi": multi_launches, "mask_inside_frac": float(mask_f.mean())}
    print(f"6a cli.register --use_mask at {ABDOMEN_SHAPE}: {reg_s:.2f} s (field written), "
          f"equal to convex_adam(mask_infill(...)) to the bit, {frac:.2%} within 1 voxel; "
          f"--multi_iters: {multi_s:.2f} s for {len(want)} files, (80, 0) equal to the single "
          "field; "
          f"inputs written in {inputs_s:.2f} s", flush=True)
    results["file_register"] = out
    return launches, paths, d / "disp.nii.gz", (vol, mov)


def apply_file_phase(torch, dev, d, paths, field_path, vols, results):
    """Phase 6b: ``cli.apply.main`` with 6a's field against
    ``map_coordinates_trilinear`` composed outside; the warp brings the
    moving image closer to the fixed one."""
    from convexadam_torch.cli import apply as apply_cli
    from convexadam_torch.core.warp import identity_grid_voxels, map_coordinates_trilinear

    out_path = d / "warped.nii.gz"
    args = ["--input_field", str(field_path), "--input_moving", str(paths["moving"]),
            "--output_warped", str(out_path), "--device", str(dev)]
    _, launches, secs = _counted(torch, lambda: apply_cli.main(args))
    _launch_checks("cli.apply", launches, sweep_expected())
    warped = np.asarray(_read_nib(out_path)[0], np.float32)
    disp = torch.from_numpy(np.asarray(_read_nib(field_path)[0], np.float32)).to(dev)
    mov = torch.from_numpy(np.asarray(_read_nib(paths["moving"])[0], np.float32)).to(dev)
    coords = identity_grid_voxels(mov.shape, dev) + disp.permute(3, 0, 1, 2)
    ref = map_coordinates_trilinear(mov, coords, mode="constant").cpu().numpy()
    check(_bits_equal(warped, ref), "6b: the warped file differs from map_coordinates_trilinear "
          f"by {float(np.abs(warped - ref).max())}")
    fixed, moving = vols
    c = FILE_CROP
    crop = (slice(c, -c),) * 3
    ssd_w = float(np.mean((warped[crop] - fixed[crop]) ** 2))
    ssd_0 = float(np.mean((moving[crop] - fixed[crop]) ** 2))
    check(ssd_w < ssd_0, f"6b: warped SSD {ssd_w} not below the unwarped {ssd_0}")
    results["file_apply"] = {"apply_cli_s": secs, "ssd_warped": ssd_w, "ssd_unwarped": ssd_0}
    print(f"6b cli.apply: {secs:.2f} s, equal to map_coordinates_trilinear to the bit; "
          f"SSD in the crop {ssd_w:.2f} against {ssd_0:.2f} unwarped", flush=True)
    return launches


def translation_file_phase(torch, dev, results):
    """Phase 6c: ``convex_adam_translation`` on ``MedicalImage``s of
    :data:`TRANSLATION_SIZE` at :data:`TRANSLATION_SPACING` with a known
    whole-voxel origin shift, plain and masked mean."""
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.geometry.image import MedicalImage
    from convexadam_torch.pipeline.translation import convex_adam_translation

    nx, ny, nz = TRANSLATION_SIZE
    data, _ = headline_pair(torch, resize_trilinear, shape=(nz, ny, nx), shift=(0, 0, 0), seed=3)
    origin = (-120.0, 35.5, 410.0)
    truth = tuple(v * s for v, s in zip(TRANSLATION_VOXELS, TRANSLATION_SPACING))
    fixed = MedicalImage(data, TRANSLATION_SPACING, origin)
    moving = MedicalImage(data, TRANSLATION_SPACING, tuple(o + t for o, t in zip(origin, truth)))
    seg = MedicalImage(body_mask(data.shape), TRANSLATION_SPACING, moving.origin)
    out = {"size_xyz": list(TRANSLATION_SIZE), "spacing": list(TRANSLATION_SPACING),
           "truth_xyz_mm": list(truth)}
    launches = None
    for name, segmentation in (("mean", None), ("masked_mean", seg)):
        (t, moved, co), launches, secs = _counted(torch, lambda: convex_adam_translation(
            fixed, moving, segmentation=segmentation, co_moving_images=[moving], device=dev))
        _launch_checks(f"convex_adam_translation ({name})", launches,
                       sweep_expected(**EXPECTED_LAUNCHES))
        check(tuple(float(v) for v in t) == truth, f"6c ({name}): translation {t} != {truth}")
        check(np.allclose(moved.origin, origin, rtol=0, atol=1e-9)
              and np.allclose(co[0].origin, origin, rtol=0, atol=1e-9),
              f"6c ({name}): moved origin {moved.origin} != {origin}")
        out[name] = {"translation_xyz_mm": [float(v) for v in t], "seconds": secs}
        print(f"6c convex_adam_translation ({name}) at {TRANSLATION_SIZE} x "
              f"{TRANSLATION_SPACING} mm: {tuple(float(v) for v in t)} mm = the truth, "
              f"{secs:.2f} s", flush=True)
    results["file_translation"] = out
    return launches


def l2r_task_dir(root, name, segs, shape, val, test):
    """A Learn2Reg-style task directory: ``images/`` and ``labels/`` of
    ``segs`` (CT-like intensities), ``<name>_dataset.json`` (modality CT, a
    labels table, the given validation and test pairs) and
    ``<name>_VAL_evaluation_config.json``."""
    import json as _json

    task = root / name
    (task / "images").mkdir(parents=True, exist_ok=True)
    (task / "labels").mkdir(exist_ok=True)
    for i, seg in enumerate(segs):
        _write_nib(task / "images" / f"{name}_{i:04d}_0000.nii.gz", ct_volume(seg, seed=i))
        _write_nib(task / "labels" / f"{name}_{i:04d}_0000.nii.gz", seg.astype(np.uint8))
    n = int(max(s.max() for s in segs))

    def pair(f, m):
        return {"fixed": f"images/{name}_{f:04d}_0000.nii.gz",
                "moving": f"images/{name}_{m:04d}_0000.nii.gz"}

    dataset = {
        "name": name, "modality": {"0": "CT"},
        "provided_data": {"0": ["image", "label"]},
        "labels": {"0": "background", **{str(k): f"organ_{k}" for k in range(1, n + 1)}},
        "registration_val": [pair(*p) for p in val],
        "registration_test": [pair(*p) for p in test],
    }
    (task / f"{name}_dataset.json").write_text(_json.dumps(dataset))
    (task / f"{name}_VAL_evaluation_config.json").write_text(_json.dumps({
        "evaluation_methods": [{"name": "dice"}, {"name": "hd95"}, {"name": "sdlogj"}],
        "expected_shape": list(shape)}))
    return task


def l2r_grid_phase(torch, dev, root, segs, results):
    """Phase 6d: the task driver at the Abdomen shape: ``L2RTask.load`` →
    ``run_validation_grid`` (one setting, both arms, every variant written)
    → ``select_winner`` → ``run_testset``; every variant recomputed outside
    the task driver and equal."""
    from convexadam_torch import evaluate_field
    from convexadam_torch.core.edt import suggest_hd95_caps
    from convexadam_torch.core.metrics import dice_coeff
    from convexadam_torch.core.warp import warp_with_displacement
    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, convex_adam_multi_output
    from convexadam_torch.selfconfig.l2r import (
        L2RTask,
        _arm_features,
        _case_name,
        _load_case,
        run_testset,
        run_validation_grid,
        select_winner,
    )

    t0 = time.perf_counter()
    l2r_task_dir(root, L2R_TASK, segs, ABDOMEN_SHAPE, val=[(0, 1)], test=[(1, 2)])
    inputs_s = time.perf_counter() - t0
    task = L2RTask.load(root, L2R_TASK)
    check(task.num_labels == L2R_LABELS and task.semantic_features
          and tuple(task.expected_shape) == ABDOMEN_SHAPE, f"6d: task loaded as {task}")
    val_dir = root / "l2r_out" / "validation"
    timings: list = []
    results_grid, launches, grid_s = _counted(torch, lambda: run_validation_grid(
        task, val_dir, iters=L2R_GRID_ITERS, dtype="float32", verbose=False,
        grid_override=L2R_GRID, device=dev, timings=timings))
    n_var = len(L2R_GRID_ITERS) * 3

    # every variant recomputed outside the task driver, one arm at a time
    pair = task.registration_val[0]
    case = _load_case(task, pair, device=dev)
    sf = torch.from_numpy(case["seg_f"]).to(dev)
    sm = torch.from_numpy(case["seg_m"]).to(dev)
    buckets, worst, arms = 0, {"dice": 0.0, "hd95": 0.0, "sdlogj": 0.0}, {}
    g, hw, lam = (v[0] for v in L2R_GRID)
    for arm in ("MIND", "nnUNet"):
        cfg = ConvexAdamConfig(mind_r=1, mind_d=2, lambda_weight=lam, grid_sp=g, disp_hw=hw,
                               dtype="float32")

        def register_arm():
            ff, fm = _arm_features(arm, case, 1, 2, torch.float32, dev)
            return convex_adam_multi_output(ff, fm, cfg, L2R_GRID_ITERS, (0, 3, 5), device=dev)

        fields, arm_launches, _ = _counted(torch, register_arm)
        _launch_checks(f"6d {arm} arm, one case", arm_launches, sweep_expected(
            mind_ssd_stats=2 if arm == "MIND" else 0, cost_volume=2,
            sample_trilinear_ic=IC_ITERS, warp_ssd_loss_grad=max(L2R_GRID_ITERS)))
        arms[arm] = arm_launches
        for a, it in enumerate(L2R_GRID_ITERS):
            for b, smooth in enumerate((0, 3, 5)):
                key = f"{arm};{g};{hw};{lam};{it};{smooth}"
                field = fields[a, b]
                r = results_grid[key]
                ev = evaluate_field(field, sf, sm, L2R_LABELS, device=dev)
                errs = {"dice": float(np.abs(ev["dice"] - r["dice"][0]).max()),
                        "hd95": float(np.abs(ev["hd95"] - r["hd95"][0]).max()),
                        "sdlogj": abs(ev["sdlogj"] - float(r["sdlogj"][0]))}
                for k in worst:
                    worst[k] = max(worst[k], errs[k])
                check(all(v == 0.0 for v in errs.values()),
                      f"6d {key}: driver metrics differ from evaluate_field's: {errs}")
                name = f"disp_{key.replace(';', '_')}_{_case_name(pair)}.nii.gz"
                back = np.asarray(_read_nib(val_dir / name)[0], np.float32)
                check(_bits_equal(back, field.cpu().numpy()), f"6d: {name} differs from its field")
                warped = warp_with_displacement(sm.float()[None], field.permute(3, 0, 1, 2),
                                                mode="nearest")[0].round().to(torch.int32)
                buckets += len(suggest_hd95_caps(case["seg_f"], warped.cpu().numpy(),
                                                 L2R_LABELS)[0])
    check(len(results_grid) == 2 * n_var, f"6d: {len(results_grid)} variants")
    _launch_checks("6d run_validation_grid", launches, sweep_expected(
        mind_ssd_stats=2, cost_volume=4, sample_trilinear_ic=2 * IC_ITERS,
        warp_ssd_loss_grad=2 * max(L2R_GRID_ITERS), nearest_sq_pruned=buckets))

    t_w = time.perf_counter()
    winner, agg = select_winner(results_grid)
    select_s = time.perf_counter() - t_w
    ident = float(dice_coeff(sf, sm, L2R_LABELS + 1).mean())
    win_dice = float(results_grid[winner]["dice"].mean())
    check(win_dice > ident, f"6d: winner {winner} Dice {win_dice:.4f} not above the identity "
          f"{ident:.4f}")
    test_dir = root / "l2r_out" / "testset"
    written, test_launches, test_s = _counted(
        torch, lambda: run_testset(task, winner, test_dir, dtype="float32", device=dev))
    arm_w, it_w = winner.split(";")[0], int(winner.split(";")[4])
    _launch_checks("6d run_testset", test_launches, sweep_expected(
        mind_ssd_stats=2 if arm_w == "MIND" else 0, cost_volume=2,
        sample_trilinear_ic=IC_ITERS, warp_ssd_loss_grad=it_w))
    check(len(written) == 1 and written[0].exists(), f"6d: test set wrote {written}")
    test_field = np.asarray(_read_nib(written[0])[0], np.float32)
    check(test_field.shape == ABDOMEN_SHAPE + (3,) and bool(np.isfinite(test_field).all()),
          "6d: bad test-set field")

    per_field = [t["write"] / n_var for t in timings]
    out = {"shape": list(ABDOMEN_SHAPE), "grid": [list(v) for v in L2R_GRID],
           "iters": list(L2R_GRID_ITERS), "variants": len(results_grid),
           "inputs_write_s": inputs_s, "grid_s": grid_s, "select_s": select_s,
           "testset_s": test_s, "host_split_per_case": timings, "write_s_per_field": per_field,
           "winner": winner, "winner_dice": win_dice, "identity_dice": ident,
           "max_err_vs_outside": worst, "pruned_buckets": buckets, "launches": launches,
           "launches_per_arm": arms, "launches_testset": test_launches}
    for t in timings:
        print(f"6d {t['key']} case {t['case']}: load {t['load']:.3f} s, register "
              f"{t['register']:.3f} s, evaluate {t['evaluate']:.3f} s, write {t['write']:.3f} s "
              f"({t['write'] / n_var:.3f} s a field)", flush=True)
    print(f"6d run_validation_grid: {len(results_grid)} variants in {grid_s:.2f} s, every one "
          f"equal to evaluate_field outside and its file to its field; winner {winner} Dice "
          f"{win_dice:.4f} (identity {ident:.4f}); select {select_s:.2f} s, test set "
          f"{test_s:.2f} s; inputs written in {inputs_s:.2f} s", flush=True)
    results["file_l2r_grid"] = out
    return launches, test_launches


def l2r_cli_phase(torch, dev, root, results):
    """Phase 6e: ``cli.l2r.main`` end to end on a small task, the task's own
    grid settings."""
    import contextlib
    import io

    from convexadam_torch.cli import l2r as l2r_cli

    segs = np.stack([np.roll(l2r_small_labels(), s, axis=(0, 1, 2)) for s in SWEEP_SHIFTS])
    l2r_task_dir(root, L2R_SMALL_TASK, segs, L2R_SMALL_SHAPE, val=[(0, 1)], test=[(1, 2)])
    out_dir = root / "l2r_small_out"
    buf = io.StringIO()
    args = ["--data_dir", str(root), "--task_name", L2R_SMALL_TASK, "--output_dir",
            str(out_dir), "--device", str(dev)]
    with contextlib.redirect_stdout(buf):
        _, launches, secs = _counted(torch, lambda: l2r_cli.main(args))
    text = buf.getvalue()
    winner = [ln for ln in text.splitlines() if ln.startswith("WINNER: ")]
    check(len(winner) == 1, f"6e: no WINNER line in {text!r}")
    n_val = len(list((out_dir / "validation").glob("disp_*.nii.gz")))
    test = list((out_dir / "testset").glob("disp_*.nii.gz"))
    check(n_val == 6 * 2 * 9, f"6e: {n_val} validation fields, expected 108")
    check(len(test) == 1, f"6e: test fields {test}")
    results["file_l2r_cli"] = {"shape": list(L2R_SMALL_SHAPE), "seconds": secs,
                               "winner": winner[0], "validation_fields": n_val,
                               "launches": launches}
    print(f"6e cli.l2r at {L2R_SMALL_SHAPE}: {winner[0]}; {n_val} validation fields and "
          f"{len(test)} test field in {secs:.2f} s", flush=True)
    return launches


def l2r_small_labels():
    """Four box organs in :data:`L2R_SMALL_SHAPE`."""
    h, w, d = L2R_SMALL_SHAPE
    seg = np.zeros(L2R_SMALL_SHAPE, np.int32)
    seg[h // 6: h // 2, w // 5: 3 * w // 5, d // 6: d // 2] = 1
    seg[h // 2 + 2: 5 * h // 6, w // 5: w // 2, d // 4: 3 * d // 4] = 2
    seg[h // 5: 3 * h // 4, 3 * w // 5 + 2: 4 * w // 5, d // 2 + 2: 5 * d // 6] = 3
    seg[h // 3: h // 2, w // 4: w // 2, d // 2 + 3: 3 * d // 4] = 4
    return seg


def sweep_infer_phase(torch, dev, root, results):
    """Phase 6f: ``cli.sweep.main(["infer", ...])`` from 6d's label files,
    one test pair, one seeded setting with grid_sp_adam 2."""
    import json as _json

    from convexadam_torch.cli import sweep as sweep_cli
    from convexadam_torch.core.metrics import dice_coeff
    from convexadam_torch.core.warp import warp_with_displacement
    from convexadam_torch.selfconfig import decode_adam_variant, stage1_settings, stage2_settings

    labels = root / L2R_TASK / "labels"
    pattern = str(labels / f"{L2R_TASK}_%04d_0000.nii.gz")
    s1 = next(i for i, s in enumerate(stage1_settings()) if (s.grid_sp, s.disp_hw) == (4, 4))
    a1 = next(i for i, s in enumerate(stage2_settings()) if s.grid_sp_adam == 2)
    iters, _ = decode_adam_variant(INFER_ADAM_S2)
    out_dir = root / "infer_out"
    config = {"topk": [0, 1, 2], "topk_pair": [[0, 1]], "test": [0, 1, 2], "test_pair": [[1, 2]],
              "HWD": list(ABDOMEN_SHAPE), "f_predict": pattern, "f_gt": pattern,
              "num_labels": L2R_LABELS + 1, "output": str(root / "infer_stage1.npz"),
              "output_dir": str(out_dir)}
    cfg_path = root / "infer_config.json"
    cfg_path.write_text(_json.dumps(config))
    args = ["infer", str(cfg_path), "--convex_s", str(s1), "--adam_s1", str(a1),
            "--adam_s2", str(INFER_ADAM_S2), "--device", str(dev)]
    _, launches, secs = _counted(torch, lambda: sweep_cli.main(args))
    _launch_checks("6f cli.sweep infer", launches, sweep_expected(
        cost_volume=2, sample_trilinear_ic=IC_ITERS, warp_ssd_loss_grad=iters))
    field = np.asarray(_read_nib(out_dir / "disp_1_2.nii.gz")[0], np.float32)
    seg_f = torch.from_numpy(np.asarray(_read_nib(pattern % 1)[0], np.int32)).to(dev)
    seg_m = torch.from_numpy(np.asarray(_read_nib(pattern % 2)[0], np.int32)).to(dev)
    d = torch.from_numpy(field).to(dev).permute(3, 0, 1, 2)
    warped = warp_with_displacement(seg_m.float()[None], d, mode="nearest")[0].round().int()
    dice = float(dice_coeff(seg_f, warped, L2R_LABELS + 1).mean())
    ident = float(dice_coeff(seg_f, seg_m, L2R_LABELS + 1).mean())
    check(dice > ident, f"6f: Dice {dice:.4f} not above the identity {ident:.4f}")
    results["file_sweep_infer"] = {"convex_s": s1, "adam_s1": a1, "adam_s2": INFER_ADAM_S2,
                                   "iters": iters, "seconds": secs, "dice": dice,
                                   "identity_dice": ident, "launches": launches}
    print(f"6f cli.sweep infer (s1 {s1}, adam {a1}, variant {INFER_ADAM_S2}: {iters} "
          f"iterations): {secs:.2f} s, Dice {dice:.4f} (identity {ident:.4f})", flush=True)
    return launches


def file_phase(torch, dev, results):
    """Phase 6: 6a-6f from files under :data:`FILE_DIR`, which is removed
    afterwards (several GB of fields); returns each sub-phase's launches."""
    import shutil

    shutil.rmtree(FILE_DIR, ignore_errors=True)
    FILE_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    launches = {}
    try:
        launches["register_cli"], paths, field_path, vols = register_file_phase(
            torch, dev, FILE_DIR, results)
        launches["apply_cli"] = apply_file_phase(torch, dev, FILE_DIR, paths, field_path, vols,
                                                 results)
        del vols
        launches["translation"] = translation_file_phase(torch, dev, results)
        launches["l2r_grid"], launches["l2r_testset"] = l2r_grid_phase(
            torch, dev, FILE_DIR, sweep_subjects(), results)
        launches["l2r_cli"] = l2r_cli_phase(torch, dev, FILE_DIR, results)
        launches["sweep_infer"] = sweep_infer_phase(torch, dev, FILE_DIR, results)
    finally:
        shutil.rmtree(FILE_DIR, ignore_errors=True)
    results["file_phase_s"] = time.perf_counter() - t0
    print(f"phase 6: {results['file_phase_s']:.2f} s", flush=True)
    return launches

# ---------------------------------------------------------------------------
# phase 7: the Learn2Reg challenge recipes at their published shapes
# ---------------------------------------------------------------------------


def _run7(torch, fn):
    """``fn()`` counted (:func:`_counted`): (result, launches, seconds,
    peak GB, GB allocated before the run)."""
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    out, launches, secs = _counted(torch, fn)
    return out, launches, secs, torch.cuda.max_memory_allocated() / 1e9, start


def _report7(results, key, launches, secs, peak, **extra):
    used = {k: v for k, v in launches.items() if v}
    print(f"7 {key}: {secs:.4f} s, peak {peak:.2f} GB, launches {used}", flush=True)
    results.setdefault("challenges", {})[key] = {
        "seconds": secs, "peak_mem_gb": peak, "launches": launches, **extra}
    return launches


def _frac_within(disp, shift, sel=None) -> float:
    err = np.abs(disp - np.array(shift, np.float32))
    ok = np.all(err < 1.0, axis=-1)
    return float(ok[sel].mean() if sel is not None else ok.mean())


def _central(shape, frac=4):
    """The central box, ``1 / frac`` of each extent from every face."""
    return tuple(slice(s // frac, s - s // frac) for s in shape)


def task1_phase(torch, dev, results, recipes):
    """7a: ``register_tps_densified`` with its defaults (grid_sp 4, disp_hw
    8 through the general kernel, IC, Adam at grid 3 for 40 iterations,
    4096 control points) at the task-1 shape; equal to ``convex_adam`` +
    the densification composed outside, to the bit; the shift recovered in
    the central quarter-margin box (> 90% within 1 voxel, the JAX test's
    bar); then ``task1_field_to_original`` onto a 240 x 200 x 240 grid."""
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.pipeline import challenges as ch
    from convexadam_torch.pipeline.convex_adam import convex_adam

    vol, mov = headline_pair(torch, resize_trilinear, shape=TASK1_SHAPE, shift=TASK1_SHIFT)
    mask = body_mask(TASK1_SHAPE).astype(np.float32)
    recipes["7a_task1"] = lambda: ch.register_tps_densified(vol, mov, mask, device=dev)
    dense, launches, secs, peak, _ = _run7(torch, recipes["7a_task1"])
    cfg = ch.TASK1_CONFIG
    _launch_checks("7a task 1", launches, sweep_expected(
        mind_ssd_stats=2, cost_volume_general=2, sample_trilinear_ic=IC_ITERS,
        warp_ssd_loss_grad=cfg.selected_niter))
    check(dense.shape == TASK1_SHAPE + (3,) and bool(np.isfinite(dense).all()), "7a: bad field")
    disp = convex_adam(vol, mov, cfg, device=dev)
    composed = ch._tps_densify(disp, mask, 4096, 4, True, 0, dev)
    check(_bits_equal(dense, composed), "7a: the recipe's field differs from convex_adam + the "
          f"densification composed outside by {np.abs(dense - composed).max()}")
    box = _central(TASK1_SHAPE)
    frac = _frac_within(dense[box], TASK1_SHIFT)
    check(frac > 0.9, f"7a: shift recovered within 1 voxel in only {frac:.2%} of the central box")
    o_shape, o_spacing = TASK1_ORIGINAL
    whole = ((0.0, 0.0, 0.0), tuple(float(v) for v in o_shape))
    meta = ch.Task1CaseMeta(o_shape, o_spacing, whole, o_shape, o_spacing, whole)
    sp = np.full(3, 2.0, np.float32)
    orig, _, orig_s, _, _ = _run7(torch, lambda: ch.task1_field_to_original(dense, sp, sp, meta,
                                                                          device=dev))
    want_shape = (3,) + tuple(v // 2 for v in o_shape)
    check(orig.shape == want_shape and bool(np.isfinite(orig).all()),
          f"7a: original-space field {orig.shape}, expected {want_shape}, finite")
    # the shift in original voxels (preprocessed / (192 / 240)), x and y
    # flipped and negated
    expect = np.array(TASK1_SHIFT, np.float32) / (TASK1_SHAPE[0] / o_shape[0]) * [-1, -1, 1]
    med = np.median(orig[(slice(None),) + _central(want_shape[1:])].reshape(3, -1), axis=1)
    check(bool(np.all(np.abs(med - expect) < 0.5)),
          f"7a: original-space median {med}, expected {expect}")
    print(f"7a task 1 {TASK1_SHAPE}: {frac:.2%} of the central box within 1 voxel, equal to the "
          f"composition; original-space {want_shape} in {orig_s:.4f} s, median {med}", flush=True)
    return _report7(results, "7a_task1", launches, secs, peak, frac_within_1vox=frac,
                    original_shape=list(want_shape), original_s=orig_s,
                    original_median=med.tolist())


def lung_masks(shape):
    """Two ellipsoidal lungs side by side along the second axis, uint8."""
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    H, W, D = shape
    out = np.zeros(shape, bool)
    for cw in (0.3 * W, 0.7 * W):
        r2 = (((grids[0] - H / 2) / (0.36 * H)) ** 2 + ((grids[1] - cw) / (0.17 * W)) ** 2
              + ((grids[2] - D / 2) / (0.4 * D)) ** 2)
        out |= r2 <= 1.0
    return out.astype(np.uint8)


def _eroded(torch, dev, mask, r):
    """Voxels of ``mask`` at least ``r`` voxels (a box) from its outside."""
    import torch.nn.functional as F

    m = torch.from_numpy(mask.astype(np.float32)).to(dev)[None, None]
    return (F.avg_pool3d(m, 2 * r + 1, stride=1, padding=r) > 0.9999)[0, 0].cpu().numpy()


def task2_phase(torch, dev, results, recipes):
    """7b: ``task2_case`` at the lung CT shape with lung-like masks (moving
    = fixed rolled): equal to ``convex_adam(mask_infill(...))`` with
    :data:`TASK2_CONFIG` composed outside, to the bit; the shift recovered
    on > 90% of the lung voxels at least 8 voxels inside the mask."""
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.pipeline import challenges as ch
    from convexadam_torch.pipeline.convex_adam import convex_adam
    from convexadam_torch.pipeline.preprocess import mask_infill

    vol, mov = headline_pair(torch, resize_trilinear, shape=TASK2_SHAPE, shift=TASK2_SHIFT)
    mask_f = lung_masks(TASK2_SHAPE)
    mask_m = np.roll(mask_f, TASK2_SHIFT, axis=(0, 1, 2))
    recipes["7b_task2"] = lambda: ch.task2_case(vol, mov, mask_f, mask_m, device=dev)
    out, launches, secs, peak, _ = _run7(torch, recipes["7b_task2"])
    cfg = ch.TASK2_CONFIG
    _launch_checks("7b task 2", launches, sweep_expected(
        mind_ssd_stats=2, cost_volume=1, warp_ssd_loss_grad=cfg.selected_niter))
    ref = convex_adam(mask_infill(vol, mask_f, device=dev), mask_infill(mov, mask_m, device=dev),
                      cfg, device=dev)
    check(_bits_equal(out["disp"], ref), "7b: task2_case differs from convex_adam(mask_infill) "
          f"composed outside by {np.abs(out['disp'] - ref).max()}")
    half = (3,) + tuple(v // 2 for v in TASK2_SHAPE)
    check(out["disp_half"].shape == half and bool(np.isfinite(out["disp_half"]).all()),
          "7b: bad half-resolution field")
    inner = _eroded(torch, dev, mask_f, max(2, min(TASK2_SHAPE) // 24))
    check(bool(inner.any()), "7b: no lung voxel left inside the eroded mask")
    frac = _frac_within(out["disp"], TASK2_SHIFT, inner)
    check(frac > 0.9, f"7b: shift recovered within 1 voxel in only {frac:.2%} of the lungs")
    print(f"7b task 2 {TASK2_SHAPE}: {frac:.2%} of {int(inner.sum())} inner lung voxels within "
          "1 voxel, equal to the composition", flush=True)
    return _report7(results, "7b_task2", launches, secs, peak, frac_within_1vox=frac,
                    lung_voxels=int(mask_f.sum()))


def oasis_labels(torch, dev, seed=0):
    """A brain-like parcellation of :data:`TASK3_SHAPE`: noise smoothed
    twice by a :data:`TASK3_SCALE`-wide box, cut at its quantiles into
    :data:`TASK3_LABELS` classes (0 the background and 35 structures, each
    a set of smooth shells a few voxels thick), int32 numpy.  The classes'
    sizes differ by structure (0.5-2x, the same in every subject) and by
    subject (0.8-1.2x, from ``seed``), so weights frozen from a template
    pair are not a subject pair's own."""
    import torch.nn.functional as F

    shape, n_labels = TASK3_SHAPE, TASK3_LABELS
    sizes = (np.random.default_rng(100).uniform(0.5, 2.0, n_labels)
             * np.random.default_rng(seed).uniform(0.8, 1.2, n_labels))
    levels = np.cumsum(sizes / sizes.sum())[:-1]
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((1, 1) + tuple(shape), generator=g, device=dev)
    k = TASK3_SCALE + 1
    for _ in range(2):
        v = F.avg_pool3d(v, k, stride=1, padding=k // 2)
    v = v.reshape(-1)
    q = torch.quantile(v, torch.tensor(levels, dtype=v.dtype, device=dev))
    return torch.bucketize(v, q).reshape(shape).int().cpu().numpy()


def task3_phase(torch, dev, results, recipes):
    """7c: ``task3_case`` on an OASIS-shaped parcellation and its roll,
    with per-pair weights and with weights frozen from another template
    pair (two other parcellations), as the OASIS script freezes them: one
    SAD launch (one direction, no IC) and 100 data terms; equal to
    ``semantic_features`` + ``convex_adam_features`` composed outside, to
    the bit; the median error under 0.5 voxels per axis in the central box
    (the JAX test's bar)."""
    from convexadam_torch.core.features import semantic_features, semantic_template_weights
    from convexadam_torch.pipeline import challenges as ch
    from convexadam_torch.pipeline.convex_adam import convex_adam_features

    seg_f = oasis_labels(torch, dev)
    seg_m = np.roll(seg_f, TASK3_SHIFT, axis=(0, 1, 2))
    sf, sm = (torch.from_numpy(x).to(dev) for x in (seg_f, seg_m))
    template = [torch.from_numpy(oasis_labels(torch, dev, seed=k)).to(dev) for k in (1, 2)]
    weights = semantic_template_weights(*template, TASK3_LABELS).cpu().numpy()
    own = semantic_template_weights(sf, sm, TASK3_LABELS).cpu().numpy()
    check(float(np.abs(weights - own).max()) > 1e-3, "7c: the template weights are the pair's own")
    del template
    cfg = ch.TASK3_CONFIG
    out_launches = {}
    for key, w in (("7c_task3", None), ("7c_task3_template", weights)):
        recipes[key] = (lambda w=w: ch.task3_case(seg_f, seg_m, TASK3_LABELS, template_weights=w,
                                                  device=dev))
        out, launches, secs, peak, _ = _run7(torch, recipes[key])
        _launch_checks(key, launches, sweep_expected(
            cost_volume_sad=1, warp_ssd_loss_grad=cfg.selected_niter))
        with torch.no_grad():
            ff, fm = semantic_features(
                sf, sm, TASK3_LABELS, mult=10.0, dtype=cfg.compute_dtype(dev),
                weights=None if w is None else torch.from_numpy(w).to(dev))
        ref = convex_adam_features(ff, fm, cfg).cpu().numpy()
        del ff, fm
        check(_bits_equal(out["disp"], ref), f"{key}: task3_case differs from the composition "
              f"outside by {np.abs(out['disp'] - ref).max()}")
        box = _central(TASK3_SHAPE, 8)
        err = out["disp"][box] - np.array(TASK3_SHIFT, np.float32)
        med = np.median(err.reshape(-1, 3), axis=0)
        frac = _frac_within(out["disp"][box], TASK3_SHIFT)
        check(bool(np.all(np.abs(med) < 0.5)), f"{key}: median error {med} not under 0.5 voxels")
        print(f"{key} {TASK3_SHAPE}, {TASK3_LABELS} labels: median error {med}, {frac:.2%} within "
              "1 voxel, equal to the composition", flush=True)
        out_launches[key] = _report7(results, key, launches, secs, peak,
                                     median_err=med.tolist(), frac_within_1vox=frac)
    return out_launches


def curious_landmarks(case=CURIOUS_CASE):
    """Case ``case``'s landmark balls in the reference's 256 x 256 x 288
    space (tests/curious_landmarks.npz, read as data): the US and MRI label
    volumes (int32) and the US and MRI label centroids."""
    z = np.load(ROOT / "tests" / "curious_landmarks.npz")
    shape = tuple(int(v) for v in z["shape"])
    segs = []
    for mod in ("US", "MRI"):
        seg = np.zeros(shape, np.int32)
        c = z[f"coords_{mod}_{case}"].astype(np.int64)
        seg[c[:, 0], c[:, 1], c[:, 2]] = z[f"labels_{mod}_{case}"]
        segs.append(seg)
    return segs, z[f"centroids_US_{case}"].astype(np.float32), \
        z[f"centroids_MRI_{case}"].astype(np.float32)


def curious_inputs(torch, dev, case=CURIOUS_CASE):
    """A CuRIOUS case in the reference's 256 x 256 x 288 space: case
    ``case``'s landmarks (:func:`curious_landmarks`) and the volumes
    :func:`curious_volumes` makes around them."""
    return curious_volumes(torch, dev, *curious_landmarks(case))


def curious_volumes(torch, dev, segs, cen_u, cen_m):
    """A synthetic anatomy (smoothed noise of two scales, made on the card
    from a seed) on the grid of the landmark volumes ``segs`` as T1 and
    FLAIR (another contrast of it); the US the T1 warped by a thin-plate
    spline through the US -> MRI landmark centroids ``cen_u`` -> ``cen_m``,
    under a monotone contrast map, zero outside a box around the US
    landmarks (the field of view the reference's `> 10` mask finds).
    Returns numpy (us, t1, flair, seg_us, seg_mri) and the centroids'
    initial TRE."""
    import torch.nn.functional as F

    from convexadam_torch.core.rigid import thin_plate_dense
    from convexadam_torch.core.warp import warp_with_displacement

    shape = segs[0].shape
    half = (np.array(shape, np.float32) - 1.0) / 2.0
    with torch.no_grad():
        ctrl = torch.from_numpy(cen_u / half - 1.0).to(dev)
        vals = torch.from_numpy((cen_m - cen_u) / half).to(dev)
        disp_gt = thin_plate_dense(ctrl, vals, shape, 4) * torch.from_numpy(half).to(dev)
        g = torch.Generator(device=dev).manual_seed(0)

        def smooth(k):
            v = torch.randn((1, 1) + shape, generator=g, device=dev)
            return F.avg_pool3d(v, k, stride=1, padding=k // 2)[0, 0]

        a = smooth(5) + 0.5 * smooth(11)
        a = (a - a.min()) / (a.max() - a.min())
        t1 = 30.0 + 200.0 * a
        flair = 30.0 + 200.0 * (1.0 - a) ** 1.5
        us_raw = warp_with_displacement(t1[None], disp_gt.permute(3, 0, 1, 2).contiguous())[0]
        us = 15.0 + 12.0 * torch.sqrt(torch.clamp(us_raw - 25.0, min=0.0))
        lo = np.maximum(np.floor(cen_u.min(0) - 16).astype(int), 0)
        hi = np.minimum(np.ceil(cen_u.max(0) + 17).astype(int), shape)
        fov = torch.zeros(shape, dtype=torch.bool, device=dev)
        fov[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = True
        us = torch.where(fov, us, torch.zeros_like(us))
        arrays = [x.cpu().numpy().astype(np.float32) for x in (us, t1, flair)]
    tre0_true = np.sqrt(((cen_u - cen_m) ** 2).sum(1))
    return (*arrays, *segs), tre0_true


def curious_phase(torch, dev, results, recipes):
    """7d: ``curious_case`` with its defaults (MIND r 3, d 3 of three
    volumes, masked cost volumes at q = 6 both ways, 5 IC steps,
    ``rigid_from_field`` of 4096 samples and 15 iterations) at 256 x 256 x
    288; the identity TRE that of the real centroids; the deformable and
    the rigid TRE below the identity TRE (the JAX test's bar)."""
    from convexadam_torch.pipeline import challenges as ch

    (us, t1, flair, seg_us, seg_mri), tre0_true = curious_inputs(torch, dev)
    recipes["7d_curious"] = lambda: ch.curious_case(us, t1, flair, seg_us, seg_mri, device=dev)
    res, launches, secs, peak, _ = _run7(torch, recipes["7d_curious"])
    _launch_checks("7d CuRIOUS", launches, sweep_expected(
        mind_ssd_stats=3, cost_volume=2, sample_trilinear_ic=5))
    tre0, tre_def, tre_rigid = (float(np.nanmean(res[k])) for k in ("tre0", "tre_def",
                                                                    "tre_rigid"))
    check(abs(tre0 - float(tre0_true.mean())) < 0.2,
          f"7d: identity TRE {tre0} against the real centroids' {tre0_true.mean()}")
    check(tre_def < tre0 and tre_rigid < tre0,
          f"7d: TRE identity {tre0:.4f}, deformable {tre_def:.4f}, rigid {tre_rigid:.4f}")
    check(bool(np.isfinite(res["disp"]).all()) and res["rigid"].shape == (4, 4), "7d: bad output")
    print(f"7d CuRIOUS case {CURIOUS_CASE} {us.shape}: TRE identity {tre0:.4f}, deformable "
          f"{tre_def:.4f}, rigid {tre_rigid:.4f} voxels", flush=True)
    return _report7(results, "7d_curious", launches, secs, peak, tre0=tre0, tre_def=tre_def,
                    tre_rigid=tre_rigid, rigid=res["rigid"].tolist())


def class_features(torch, dev, seg_a, seg_b, grid_sp):
    """One-hot features of two label volumes (:data:`SEMANTIC_LABELS`
    channels) pooled to ``grid_sp``: the convex stage's inputs of 7e and
    9b."""
    from convexadam_torch.core.features import semantic_features
    from convexadam_torch.core.smoothing import avg_pool3d

    a, b = (torch.from_numpy(x).to(dev) for x in (seg_a, seg_b))
    with torch.no_grad():
        ff, fm = semantic_features(a, b, SEMANTIC_LABELS)
        return (avg_pool3d(ff, grid_sp, stride=grid_sp).contiguous(),
                avg_pool3d(fm, grid_sp, stride=grid_sp).contiguous())


def streamed_phase(torch, dev, results, recipes, keep=None):
    """7e: the (grid_sp 2, disp_hw 7) class at the Abdomen shape on phase
    5's subjects 0 and 1 (14 one-hot channels), both directions: dense (the
    default threshold) and streamed (``stream_threshold=0``), equal to the
    bit, with both peaks; then one direction at 256 x 256 x 320, whose dense
    estimate exceeds the threshold: the natural dispatch streams.  The dense
    fields go to ``keep["7e_dense"]`` (host copies, by direction) when
    ``keep`` is given."""
    from convexadam_torch.core import convex

    g, q = STREAM_CLASS
    K = 2 * q + 1

    def coarse(seg_a, seg_b):
        return class_features(torch, dev, seg_a, seg_b, g)

    segs = sweep_subjects()
    fix_s, mov_s = coarse(segs[0], segs[1])
    est = convex.dense_estimate(q, fix_s.shape[1:])
    check(est <= convex.COST_VOLUME_STREAM_THRESHOLD,
          f"7e: the (2, 7) class estimate {est} streams")
    out = {}
    launches = {}
    for direction, (a, b) in (("forward", (fix_s, mov_s)), ("reverse", (mov_s, fix_s))):
        with torch.no_grad():
            dense, l_d, s_d, p_d, start_d = _run7(
                torch, lambda: convex.convex_displacement(a, b, q))
            streamed, l_s, s_s, p_s, start_s = _run7(
                torch, lambda: convex.convex_displacement(a, b, q, stream_threshold=0))
        _launch_checks(f"7e dense {direction}", l_d, sweep_expected(cost_volume=1))
        _launch_checks(f"7e streamed {direction}", l_s, sweep_expected(cost_volume_block=7 * K))
        equal = torch.equal(dense, streamed)
        check(equal, f"7e {direction}: streamed differs from dense by {max_err(dense, streamed)}")
        ratio = (p_d - start_d) / (est / 1e9)
        print(f"7e {STREAM_CLASS} {ABDOMEN_SHAPE} {direction}: dense {s_d:.4f} s, "
              f"peak {p_d:.2f} GB "
              f"({p_d - start_d:.2f} GB above the {start_d:.2f} GB held before, {ratio:.4f} of the "
              f"{est / 1e9:.2f} GB estimate); streamed {s_s:.4f} s, peak {p_s:.2f} GB "
              f"({p_s - start_s:.2f} GB above); equal to the bit", flush=True)
        out[direction] = {"dense_s": s_d, "dense_peak_gb": p_d, "dense_start_gb": start_d,
                          "dense_peak_over_estimate": ratio, "streamed_s": s_s,
                          "streamed_peak_gb": p_s, "streamed_start_gb": start_s,
                          "equal": equal}
        if direction == "forward":
            launches["7e_dense"], launches["7e_streamed"] = l_d, l_s
        if keep is not None:
            keep.setdefault("7e_dense", {})[direction] = dense.cpu()
        del dense, streamed
    del fix_s, mov_s
    seg_a, seg_b = l2r_label_pair(shape=STREAM_NATURAL_SHAPE, margin=ABDOMEN_MARGIN)
    fix_s, mov_s = coarse(seg_a, seg_b)
    est_n = convex.dense_estimate(q, fix_s.shape[1:])
    check(est_n > convex.COST_VOLUME_STREAM_THRESHOLD,
          f"7e: {STREAM_NATURAL_SHAPE} estimate {est_n} does not exceed the threshold")
    def natural():
        with torch.no_grad():
            return convex.convex_displacement(fix_s, mov_s, q)

    recipes["7e_natural"] = natural
    field, l_n, s_n, p_n, start_n = _run7(torch, natural)
    _launch_checks("7e natural dispatch", l_n, sweep_expected(cost_volume_block=7 * K))
    check(tuple(field.shape) == (3,) + tuple(fix_s.shape[1:]) and bool(torch.isfinite(field).all()),
          "7e natural dispatch: bad field")
    print(f"7e natural dispatch {STREAM_CLASS} {STREAM_NATURAL_SHAPE} ({est_n / 1e9:.2f} GB "
          f"estimate, threshold {convex.COST_VOLUME_STREAM_THRESHOLD / 1e9:.0f} GB): streamed "
          f"{s_n:.4f} s, peak {p_n:.2f} GB", flush=True)
    out["natural"] = {"shape": list(STREAM_NATURAL_SHAPE), "estimate_gb": est_n / 1e9,
                      "seconds": s_n, "peak_gb": p_n, "start_gb": start_n}
    launches["7e_natural"] = l_n
    results.setdefault("challenges", {})["7e_streamed"] = {
        "class": list(STREAM_CLASS), "shape": list(ABDOMEN_SHAPE), "estimate_gb": est / 1e9,
        "threshold_gb": convex.COST_VOLUME_STREAM_THRESHOLD / 1e9, **out,
        "launches": {k: {n: v for n, v in l.items() if v} for k, l in launches.items()}}
    return launches


def strided_phase(torch, dev, vol_np, mov_np, single, results, recipes):
    """7f: the default registration of the 192^3 headline pair with
    ``adam_sample_stride`` 2 and 3 (:data:`DATA_TERM_STRIDES`): 80 strided
    data terms and no dense one each, a finite field, the shift recovered
    (> 90% of the central box within 1 voxel) and the central p95 |diff| to
    phase 4's stride-1 field ``single``, at stride 2 under 0.5 voxels (the
    JAX package's envelope), at stride 3 recorded.  Returns each run's
    launches by its key (``7f_strided``, ``7f_strided3``)."""
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, convex_adam

    box = _central(HEADLINE_SHAPE)
    launches = {}
    for stride in DATA_TERM_STRIDES:
        key = "7f_strided" if stride == 2 else f"7f_strided{stride}"
        cfg = ConvexAdamConfig(adam_sample_stride=stride)
        recipes[key] = functools.partial(convex_adam, vol_np, mov_np, cfg, device=dev)
        out, l_s, secs, peak, _ = _run7(torch, recipes[key])
        _launch_checks(f"7f stride {stride}", l_s, sweep_expected(
            mind_ssd_stats=2, cost_volume=2, sample_trilinear_ic=IC_ITERS,
            warp_ssd_loss_grad_strided=cfg.selected_niter))
        check(bool(np.isfinite(out).all()), f"7f stride {stride}: non-finite field")
        p95 = float(np.percentile(np.abs(out[box] - single[box]), 95))
        frac = _frac_within(out[box], HEADLINE_SHIFT)
        check(stride != 2 or p95 < 0.5,
              f"7f: central p95 |diff| to the stride-1 field {p95:.4f} voxels")
        check(frac > 0.9, f"7f stride {stride}: shift recovered within 1 voxel in only "
              f"{frac:.2%} of the central box")
        print(f"7f stride {stride}: central p95 |diff| to stride 1 {p95:.4f} voxels, "
              f"{frac:.2%} within 1 voxel", flush=True)
        launches[key] = _report7(results, key, launches=l_s, secs=secs, peak=peak, stride=stride,
                                 p95_vs_stride1=p95, frac_within_1vox=frac)
    return launches


def _cloned(torch, x):
    """``x`` with every tensor in it (in tuples, lists, dicts) detached and
    copied."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_cloned(torch, v) for v in x)
    if isinstance(x, dict):
        return {k: _cloned(torch, v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def _recording(torch, calls):
    """Within the block, the first :data:`CAPTURE_CALLS` calls of each
    wrapper of :data:`CAPTURE_SITES` are appended to ``calls`` as (wrapper,
    arguments by name), the tensors copied (a recipe may update its field in
    place); each call then goes on to the wrapper."""
    import importlib
    import inspect

    def recorder(name, fn):
        sig = inspect.signature(fn)

        def wrapped(*args, **kwargs):
            if sum(c[0] == name for c in calls) < CAPTURE_CALLS:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                calls.append((name, _cloned(torch, dict(bound.arguments))))
            return fn(*args, **kwargs)

        return wrapped

    patches = []
    for mod_name, name in CAPTURE_SITES:
        mod = importlib.import_module(mod_name)
        patches.append((mod, name, recorder(name, getattr(mod, name))))
    with _patched(patches):
        yield calls


def _captured_kernel(name, a) -> str:
    """The kernel record (and launch count) a recorded call of wrapper
    ``name`` with arguments ``a`` belongs to."""
    from convexadam_torch.kernels import mind
    from convexadam_torch.kernels.cost_volume import kernel_for

    if name == "mind_ssd_stats":
        general = mind.kernel_for(a["radius"], a["dilation"]) == "mind_general_kernel"
        return "mind_ssd_stats_general" if general else name
    if name == "cost_volume":
        if a["metric"] == "sad":
            return "cost_volume_sad"
        general = kernel_for(a["disp_hw"]) == "cost_volume_general_kernel"
        return "cost_volume_general" if general else "cost_volume"
    if name == "inverse_consistency_steps":
        return "sample_trilinear_ic"
    if name == "warp_ssd_loss_grad":
        return "warp_ssd_loss_grad_strided" if a["stride"] > 1 else "warp_ssd_loss_grad"
    return name


def _shape_of(a) -> dict:
    """The arguments ``a`` of a recorded call, each tensor as its shape and
    type."""
    return {k: ([*v.shape, str(v.dtype)[6:]] if hasattr(v, "shape") else v) for k, v in a.items()}


def _kernel_pairs() -> dict:
    """Each wrapper of :data:`CAPTURE_SITES` by name, with its plain
    version."""
    from convexadam_torch.kernels.cost_volume import cost_volume_block_plain, cost_volume_plain
    from convexadam_torch.kernels.cost_volume import cost_volume, cost_volume_block
    from convexadam_torch.kernels.mind import mind_ssd_stats, mind_ssd_stats_plain
    from convexadam_torch.kernels.warp import (
        inverse_consistency_steps,
        inverse_consistency_steps_plain,
        warp_ssd_loss_grad,
        warp_ssd_loss_grad_plain,
    )

    return {"mind_ssd_stats": (mind_ssd_stats, mind_ssd_stats_plain),
            "cost_volume": (cost_volume, cost_volume_plain),
            "cost_volume_block": (cost_volume_block, cost_volume_block_plain),
            "inverse_consistency_steps": (inverse_consistency_steps,
                                          inverse_consistency_steps_plain),
            "warp_ssd_loss_grad": (warp_ssd_loss_grad, warp_ssd_loss_grad_plain)}


def hold_call(torch, name, a) -> dict:
    """A recorded call of wrapper ``name`` with arguments ``a`` through the
    kernel and its plain version: the row of its ``max_abs_err`` (the data
    term's ``sum(res^2)`` apart, as ``ssq_rel_err``) and argument shapes."""
    kern, plain = _kernel_pairs()[name]
    ko, po = kern(**a), plain(**a)
    torch.cuda.synchronize()
    ko, po = (ko, po) if isinstance(ko, tuple) else ((ko,), (po,))
    row = {"wrapper": name, "args": _shape_of(a)}
    if name == "warp_ssd_loss_grad":
        row["ssq_rel_err"] = abs(float(ko[0]) - float(po[0])) / float(po[0])
        ko, po = ko[1:], po[1:]
    row["max_abs_err"] = max(max_err(k, p) for k, p in zip(ko, po))
    return row


def _held(row) -> bool:
    """Outputs to the bit, the data term's ``sum(res^2)`` to 1e-5 relative
    (its partial sums add in another order)."""
    return row["max_abs_err"] == 0.0 and row.get("ssq_rel_err", 0.0) <= 1e-5


def hold_recorded_calls(torch, key, calls, launches) -> dict:
    """The calls a run ``key`` recorded (:func:`_recording`), each held to
    its plain version (:func:`hold_call`, :func:`_held`); every kernel the
    run launched (``launches``) must have a recorded call.  The first call
    of each kernel is timed.  Returns the rows by kernel record name."""
    kinds = {_captured_kernel(name, a) for name, a in calls}
    missed = [k for k, v in launches.items() if v and k not in kinds]
    check(not missed, f"{key}: launched {missed} with no recorded call")
    readings: dict = {}
    for name, a in calls:
        kname = _captured_kernel(name, a)
        kern, plain = _kernel_pairs()[name]
        row = {"run": key, **hold_call(torch, name, a)}
        check(_held(row), f"{key} {kname} {row['args']}: max err {row['max_abs_err']}, "
              f"sum(res^2) rel {row.get('ssq_rel_err')}")
        if kname not in readings:
            t = timed_turns(torch, lambda: kern(**a), GLOBALS[kname])
            row.update(call_ms=t["call_ms"], device_ms=t["device_ms"],
                       plain_ms=cuda_ms(torch, lambda: plain(**a), 1, 3))
            if name == "mind_ssd_stats":
                x = a["x"]
                row["bound_ms"], row["bound_by"] = bound_ms(
                    *mind_work(tuple(x.shape), x.element_size(), a["radius"]))
        print(f"{key} {kname} {row['args']}: max_abs_err {row['max_abs_err']} (tol 0)"
              + (f", sum(res^2) rel {row['ssq_rel_err']:.2e}" if "ssq_rel_err" in row else "")
              + (f", {row['device_ms']:.4f} ms device, {row['plain_ms']:.4f} ms plain"
                 if "device_ms" in row else "")
              + (f", bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
                 if "bound_ms" in row else ""), flush=True)
        readings.setdefault(kname, []).append(row)
    return readings


def challenge_kernel_phase(torch, recipes, records, results):
    """7g: each recipe of 7a-7f run again (the same inputs) with the
    arguments of the first :data:`CAPTURE_CALLS` calls of every wrapper it
    reaches recorded (:func:`_recording`), each held to its plain version
    (:func:`hold_recorded_calls`).  The readings join each kernel's record
    as ``at_challenge_shape``."""
    by_name = {r["name"]: r for r in records}
    readings: dict = {}
    t0 = time.perf_counter()
    for key, recipe in recipes.items():
        calls: list = []
        with _recording(torch, calls):
            _, launches, _ = _counted(torch, recipe)
        for kname, rows in hold_recorded_calls(torch, f"7g {key}", calls, launches).items():
            readings.setdefault(kname, []).extend(rows)
        del calls
    for kname, rows in readings.items():
        by_name[kname]["at_challenge_shape"] = rows
    secs = time.perf_counter() - t0
    print(f"7g: {sum(map(len, readings.values()))} recorded calls equal to their plain versions "
          f"in {secs:.2f} s", flush=True)
    results["challenges"]["7g_kernels"] = {"seconds": secs, "calls": {
        k: len(v) for k, v in readings.items()}}


def challenge_phase(torch, dev, vol_np, mov_np, single, records, results, keep=None):
    """Phase 7: 7a-7g; returns the launches of each run of 7a-7f by its
    key (7e's dense fields go to ``keep``, :func:`streamed_phase`)."""
    t0 = time.perf_counter()
    recipes: dict = {}
    launches = {"7a_task1": task1_phase(torch, dev, results, recipes),
                "7b_task2": task2_phase(torch, dev, results, recipes)}
    launches.update(task3_phase(torch, dev, results, recipes))
    launches["7d_curious"] = curious_phase(torch, dev, results, recipes)
    launches.update(streamed_phase(torch, dev, results, recipes, keep))
    launches.update(strided_phase(torch, dev, vol_np, mov_np, single, results, recipes))
    del recipes["7c_task3_template"]  # task 3's shapes again, other weights
    challenge_kernel_phase(torch, recipes, records, results)
    results["challenges"]["phase7_s"] = time.perf_counter() - t0
    print(f"phase 7: {results['challenges']['phase7_s']:.2f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8: the segmentation front end
# ---------------------------------------------------------------------------

def _seg_grid(shape):
    return np.meshgrid(*(np.linspace(-1, 1, s, dtype=np.float32) for s in shape), indexing="ij")


def make_anatomy(kind: str, shape=SEG_SHAPE) -> np.ndarray:
    """One of the four binary anatomies of ``tests/regen_unet_anatomies.py``
    (copied): a notched ellipsoid, twin blobs, a shell, a bent tube."""
    z, y, x = _seg_grid(shape)
    if kind == "ellipsoid_notch":
        body = (z / 0.55) ** 2 + (y / 0.45) ** 2 + (x / 0.6) ** 2 < 1.0
        notch = ((z - 0.35) / 0.3) ** 2 + (y / 0.25) ** 2 + ((x - 0.3) / 0.35) ** 2 < 1.0
        return (body & ~notch).astype(np.int32)
    if kind == "twin_blobs":
        b1 = ((z + 0.3) / 0.35) ** 2 + ((y + 0.25) / 0.3) ** 2 + ((x + 0.2) / 0.4) ** 2 < 1.0
        b2 = ((z - 0.35) / 0.25) ** 2 + ((y - 0.3) / 0.22) ** 2 + ((x - 0.25) / 0.28) ** 2 < 1.0
        return (b1 | b2).astype(np.int32)
    if kind == "shell":
        r2 = (z / 0.55) ** 2 + (y / 0.5) ** 2 + (x / 0.6) ** 2
        return ((r2 < 1.0) & (r2 > 0.45)).astype(np.int32)
    if kind == "bent_tube":
        cz = 0.45 * x * x - 0.2
        cy = 0.35 * x
        rad2 = (z - cz) ** 2 + (y - cy) ** 2
        return ((rad2 < 0.06) & (np.abs(x) < 0.75)).astype(np.int32)
    raise ValueError(kind)


def synthesize_image(lab: np.ndarray, seed: int) -> np.ndarray:
    """MRI-like z-scored intensity of a label volume, as
    ``tests/regen_unet_anatomies.py`` makes it (copied): bright foreground,
    texture, a smooth bias field, boundary blur and noise."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    shape = lab.shape
    fg = gaussian_filter(lab.astype(np.float32), 1.5)
    texture = gaussian_filter(rng.standard_normal(shape).astype(np.float32), 2.0)
    bias = gaussian_filter(rng.standard_normal(shape).astype(np.float32), 16.0)
    bias = bias / (np.abs(bias).max() + 1e-6)
    img = 1.6 * fg + 0.7 * texture + 0.8 * bias
    img = img + 0.15 * rng.standard_normal(shape).astype(np.float32)
    return ((img - img.mean()) / img.std()).astype(np.float32)


def binary_dice(pred, truth) -> float:
    pred, truth = np.asarray(pred) == 1, np.asarray(truth) == 1
    return float(2 * np.sum(pred & truth) / (pred.sum() + truth.sum() + 1e-8))


def unet_phase(torch, dev, results):
    """8a: the packaged anatomy checkpoint on its held-out case (96 x 96 x
    56, 12 windows of 64 x 64 x 28) on the card: Dice above
    :data:`SEG_DICE`, the blended logits within :data:`SEG_LOGIT_TOL` of the
    port's CPU run, labels apart only where the CPU's margin is below
    :data:`SEG_MARGIN`; ms a window (TF32 off, and on for information) and
    windows a second."""
    from convexadam_torch.models.segmentation import (
        CHECKPOINTS,
        WINDOW_BATCH,
        UNet3D,
        blended_logits,
        load_pretrained_unet3d,
        load_unet3d,
    )
    from convexadam_torch.utils.sliding_window import compute_steps_for_sliding_window

    predictor, meta = load_pretrained_unet3d(SEG_CHECKPOINT, device=dev)
    check(meta["holdout_anatomy"] == SEG_HOLDOUT, f"8a: {meta['holdout_anatomy']} held out")
    patch = tuple(meta["patch_size"])
    truth = make_anatomy(SEG_HOLDOUT)
    img = synthesize_image(truth, SEG_HOLDOUT_SEED)
    steps = compute_steps_for_sliding_window(patch, img.shape, 0.5)
    n_windows = int(np.prod([len(s) for s in steps]))
    blended_logits(predictor, img, patch, device=dev)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = blended_logits(predictor, img, patch, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cpu_pred, _ = load_pretrained_unet3d(SEG_CHECKPOINT, device="cpu")
    cpu = blended_logits(cpu_pred, img, patch, device="cpu")
    card = card.cpu()
    err = max_err(card, cpu)
    check(err <= SEG_LOGIT_TOL, f"8a: blended logits {err} from the CPU's (tol {SEG_LOGIT_TOL})")
    lab_card, lab_cpu = card.argmax(0).numpy(), cpu.argmax(0).numpy()
    margin = (cpu[1] - cpu[0]).abs().numpy()
    differ = lab_card != lab_cpu
    worst = float(margin[differ].max()) if differ.any() else 0.0
    check(worst < SEG_MARGIN, f"8a: labels differ from the CPU's at margins up to {worst}")
    dice = binary_dice(lab_card, truth)
    check(dice > SEG_DICE, f"8a: held-out Dice {dice:.4f} not above {SEG_DICE}")
    # ms a window: one predictor call on a batch of the case's windows
    vol = torch.from_numpy(img).to(dev)
    batch = torch.stack([vol[sx:sx + patch[0], sy:sy + patch[1], sz:sz + patch[2]]
                         for sx in steps[0] for sy in steps[1] for sz in steps[2]][:WINDOW_BATCH])
    ms = cuda_ms(torch, lambda: predictor(batch)) / len(batch)
    model = UNet3D(meta["num_classes"], meta["channels"])
    model.load_state_dict(load_unet3d(CHECKPOINTS / SEG_CHECKPOINT / "params.npz"))
    model = model.to(dev).eval()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            ms_tf32 = cuda_ms(torch, lambda: model(batch[:, None])) / len(batch)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {"checkpoint": SEG_CHECKPOINT, "shape": list(img.shape), "patch": list(patch),
           "windows": n_windows, "dice": dice, "max_abs_err_vs_cpu": err,
           "tol": SEG_LOGIT_TOL, "labels_differing": int(differ.sum()),
           "max_margin_where_differing": worst,
           "inference_s": secs, "windows_per_s": n_windows / secs,
           "ms_per_window": ms, "ms_per_window_tf32": ms_tf32, "window_batch": len(batch)}
    print(f"8a U-Net {SEG_CHECKPOINT} on the held-out {SEG_HOLDOUT} {img.shape}: Dice "
          f"{dice:.4f}; blended logits {err:.3e} from the CPU's (tol {SEG_LOGIT_TOL}), "
          f"{int(differ.sum())} labels differ; {ms:.4f} ms a window in batches of {len(batch)} "
          f"(TF32 on, for information: {ms_tf32:.4f}); {n_windows} windows in {secs:.4f} s, "
          f"{n_windows / secs:.1f} windows/s", flush=True)
    results["segmentation"] = {"8a_unet": out}


def seg_volumes():
    """8b's truth (fixed, moving) and raw images: the Abdomen volume tiled
    at :data:`SEG_TILES` with the four anatomies in turn, each tile's image
    synthesised with its own texture seed; the moving truth and image are a
    second tiling rolled by the headline shift."""
    anatomies = [make_anatomy(kind, SEG_SHAPE) for kind in SEG_ANATOMIES]
    truths, imgs = [], []
    for seed in SEG_TEXTURE_SEEDS:
        truth = np.zeros(ABDOMEN_SHAPE, np.int32)
        img = np.zeros(ABDOMEN_SHAPE, np.float32)
        origins = [(a, b, c) for a in SEG_TILES[0] for b in SEG_TILES[1] for c in SEG_TILES[2]]
        for k, origin in enumerate(origins):
            box = tuple(slice(o, o + n) for o, n in zip(origin, SEG_SHAPE))
            lab = anatomies[k % len(anatomies)]
            truth[box] = lab
            img[box] = SEG_RAW[0] + SEG_RAW[1] * synthesize_image(lab, seed + k)
        truths.append(truth)
        imgs.append(img)
    check(bool((imgs[0] > 0).all()), "8b: a raw intensity is not positive")
    for a, sh in enumerate(HEADLINE_SHIFT):  # the roll wraps no anatomy voxel
        edge = np.take(truths[1], range(-sh, 0) if sh > 0 else range(0, -sh), axis=a)
        check(not edge.any(), f"8b: an anatomy lies within {abs(sh)} voxels of a face")
    truths[1] = np.roll(truths[1], HEADLINE_SHIFT, axis=(0, 1, 2))
    imgs[1] = np.roll(imgs[1], HEADLINE_SHIFT, axis=(0, 1, 2))
    return truths[0], truths[1], imgs


def segmentation_entry_phase(torch, dev, records, results):
    """8b: ``convex_adam_semantic_from_images`` at the Abdomen shape with
    the anatomy checkpoint (360 windows a volume): launches 0 / 2 / 15 / 80
    (MIND, cost volume, inverse-consistency steps, data term); the kernels'
    calls of the warm-up run recorded and held to their plain versions
    (:func:`hold_recorded_calls`; the readings join each kernel's record as
    ``at_segmentation_shape``); the field equal to nnU-Net normalisation +
    window labels + ``convex_adam_semantic_torch`` composed outside, to the
    bit (the composition timed by stage); each volume's labels' Dice above
    :data:`SEG_DICE`; the warped moving truth's Dice above the identity's by
    :data:`SEG_GAIN`.  Returns the launches."""
    from convexadam_torch import convex_adam_semantic_from_images, convex_adam_semantic_torch
    from convexadam_torch.core.features import nnunet_norm
    from convexadam_torch.core.metrics import dice_coeff
    from convexadam_torch.core.warp import warp_with_displacement
    from convexadam_torch.models.segmentation import load_pretrained_unet3d, predict_labels
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig
    from convexadam_torch.utils.sliding_window import compute_steps_for_sliding_window

    t0 = time.perf_counter()
    truth_f, truth_m, (img_f, img_m) = seg_volumes()
    make_s = time.perf_counter() - t0
    predictor, meta = load_pretrained_unet3d(SEG_CHECKPOINT, device=dev)
    patch = tuple(meta["patch_size"])

    def entry():
        return convex_adam_semantic_from_images(img_f, img_m, predictor, patch, device=dev)

    calls: list = []
    with _recording(torch, calls):  # the warm-up
        _, rec_launches, _ = _counted(torch, entry)
    readings = hold_recorded_calls(torch, "8b", calls, rec_launches)
    by_name = {r["name"]: r for r in records}
    for kname, rows in readings.items():
        by_name[kname]["at_segmentation_shape"] = rows
    del calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    field, launches, secs = _counted(torch, entry)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _launch_checks("8b semantic from images", launches, sweep_expected(
        cost_volume=2, sample_trilinear_ic=IC_ITERS, warp_ssd_loss_grad=80))
    check(field.shape == ABDOMEN_SHAPE + (3,) and bool(np.isfinite(field).all()),
          "8b: bad field")
    # the same stages composed outside the entry, each timed
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = nnunet_norm(torch.from_numpy(img_f).to(dev))
    m = nnunet_norm(torch.from_numpy(img_m).to(dev))
    torch.cuda.synchronize()
    stages["normalisation_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pf = predict_labels(predictor, f, patch, device=dev)
    pm = predict_labels(predictor, m, patch, device=dev)
    torch.cuda.synchronize()
    stages["windows_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    num_labels = int(torch.maximum(pf.max(), pm.max())) + 1
    composed = convex_adam_semantic_torch(pf, pm, ConvexAdamConfig(), num_labels=num_labels,
                                          device=dev)
    torch.cuda.synchronize()
    stages["registration_s"] = time.perf_counter() - t0
    composed = composed.cpu().numpy()
    check(_bits_equal(field, composed), f"8b: the entry's field differs from the composition by "
          f"{float(np.abs(field - composed).max())}")
    dice_f, dice_m = binary_dice(pf.cpu().numpy(), truth_f), binary_dice(pm.cpu().numpy(), truth_m)
    check(min(dice_f, dice_m) > SEG_DICE, f"8b: label Dice {dice_f:.4f} / {dice_m:.4f}")
    sf = torch.from_numpy(truth_f).to(dev)
    sm = torch.from_numpy(truth_m).to(dev).float()[None]

    def warped_dice(disp):
        w = warp_with_displacement(sm, torch.from_numpy(disp).to(dev).permute(3, 0, 1, 2),
                                   mode="nearest")[0].round().to(torch.int32)
        return float(dice_coeff(sf, w, 2)[0])  # label 1

    d_reg, d_id = warped_dice(field), warped_dice(np.zeros_like(field))
    check(d_reg >= d_id + SEG_GAIN, f"8b: warped Dice {d_reg:.4f} against the identity's {d_id:.4f}")
    per_volume = int(np.prod([len(st) for st in compute_steps_for_sliding_window(
        patch, ABDOMEN_SHAPE, 0.5)]))
    check(per_volume == SEG_WINDOWS, f"8b: {per_volume} windows a volume, not {SEG_WINDOWS}")
    n_windows = 2 * per_volume
    out = {"shape": list(ABDOMEN_SHAPE), "anatomies": list(SEG_ANATOMIES),
           "shift": list(HEADLINE_SHIFT), "num_labels": num_labels,
           "windows_per_volume": per_volume, "entry_s": secs, "peak_gb": peak,
           "volumes_s": make_s, **stages,
           "windows_per_s": n_windows / stages["windows_s"], "label_dice": [dice_f, dice_m],
           "warped_dice": d_reg, "identity_dice": d_id, "equal_to_composed": True,
           "kernel_calls_held": {k: len(v) for k, v in readings.items()},
           "launches": {k: v for k, v in launches.items() if v}}
    print(f"8b semantic from images {ABDOMEN_SHAPE}: {secs:.4f} s, peak {peak:.2f} GB; composed: "
          f"normalisation {stages['normalisation_s']:.4f} s, windows {stages['windows_s']:.4f} s "
          f"({n_windows} windows, {out['windows_per_s']:.1f}/s), registration "
          f"{stages['registration_s']:.4f} s; equal to the bit; label Dice {dice_f:.4f} / "
          f"{dice_m:.4f}; warped Dice {d_reg:.4f} (identity {d_id:.4f}); launches "
          f"{out['launches']} (volumes made on the host in {make_s:.2f} s)", flush=True)
    results["segmentation"]["8b_from_images"] = out
    return launches


# ---------------------------------------------------------------------------
# phase 9: the multi-device layer
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def parallel_one_process_phase(torch, dev, vol_np, mov_np, results):
    """9a: ``register_pairs_batched`` on two 192^3 headline pairs, each
    field equal to its lone ``convex_adam_torch`` call to the bit;
    ``device_usage``, ``stage_timer``, ``profile_trace`` (a non-empty trace
    that shows the cost-volume kernel) and ``probe_device_count() == 1``;
    the sweep CLI with ``--mesh`` over an NCCL process group of one rank,
    its arrays equal to the CLI's without it.  Returns the batch's
    launches and its fields on the host."""
    import torch.distributed as dist

    import convexadam_torch.selfconfig as selfconfig
    from convexadam_torch.cli import sweep as cli_sweep
    from convexadam_torch.geometry.io import save_volume_nib_order
    from convexadam_torch.kernels.cost_volume import cost_volume
    from convexadam_torch.parallel.batch import register_pairs_batched
    from convexadam_torch.parallel.distributed import init_distributed
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, convex_adam_torch
    from convexadam_torch.utils.devices import probe_device_count
    from convexadam_torch.utils.memory import device_usage, profile_trace, stage_timer

    t_phase = time.perf_counter()
    fixed = np.stack([vol_np, vol_np])
    moving = np.stack([mov_np, np.roll(vol_np, PAIRED_SHIFTS[1], axis=(0, 1, 2))])
    batched, launches, secs = _counted(torch, lambda: register_pairs_batched(fixed, moving,
                                                                             device=dev))
    _launch_checks("9a batched pairs", launches,
                   sweep_expected(**{k: 2 * v for k, v in EXPECTED_LAUNCHES.items()}))
    batched_np = batched.cpu().numpy()
    timings: dict = {}
    for i in range(2):
        with stage_timer("lone", timings):
            lone = convex_adam_torch(torch.from_numpy(fixed[i]).to(dev),
                                     torch.from_numpy(moving[i]).to(dev), ConvexAdamConfig())
            torch.cuda.synchronize()
        check(torch.equal(lone, batched[i]), f"9a: batched field {i} differs from its lone call "
              f"by {max_err(lone, batched[i])}")
    check(timings["lone"] > 0, "9a: stage_timer read nothing")
    usage = device_usage(dev)
    check(usage.startswith("device usage (current/peak): ") and usage.endswith(" GB"),
          f"9a: device_usage gave {usage!r}")
    del batched, lone
    trace_dir = PARALLEL_DIR / "trace"
    x = torch.randn((12, 32, 32, 32), device=dev)
    # as device_times: the profiler can miss short kernels in a session, so
    # up to PROFILER_SESSIONS sessions of 20 calls
    for session in range(PROFILER_SESSIONS):
        with profile_trace(trace_dir):
            for _ in range(20):
                cost_volume(x, x, 4)
            torch.cuda.synchronize()
        trace = (trace_dir / "trace.json").read_text()
        if "cost_volume_kernel" in trace:
            break
        print(f"  9a: no cost_volume_kernel in the trace of session {session}", flush=True)
    check(len(trace) > 0 and "cost_volume_kernel" in trace,
          "9a: profile_trace wrote no trace of the cost-volume kernel")
    trace_bytes = len(trace)
    shutil.rmtree(trace_dir)
    n_cards = probe_device_count()
    check(n_cards == 1, f"9a: probe_device_count() = {n_cards}")

    # the sweep CLI, without and with --mesh over an NCCL group of one
    segs = sweep_subjects()
    for k, seg in enumerate(segs):
        save_volume_nib_order(seg.astype(np.float32), np.eye(4), PARALLEL_DIR / f"seg_{k}.nii.gz")
    settings = sweep_settings(CLI_MESH_CLASSES)
    full = selfconfig.stage1_settings
    selfconfig.stage1_settings = lambda: settings
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    arrays = {}
    try:
        check(init_distributed() is False, "9a: init_distributed() on a group of one")
        for tag, extra in (("plain", []), ("mesh", ["--mesh", "--setting_batch", "2"])):
            cfg = {"topk": [0, 1, 2], "topk_pair": [list(p) for p in SWEEP_PAIRS],
                   "HWD": list(ABDOMEN_SHAPE), "f_predict": str(PARALLEL_DIR / "seg_%d.nii.gz"),
                   "f_gt": str(PARALLEL_DIR / "seg_%d.nii.gz"), "num_labels": L2R_LABELS + 1,
                   "output": str(PARALLEL_DIR / f"cli_{tag}.npz")}
            path = PARALLEL_DIR / f"cli_{tag}.json"
            path.write_text(json.dumps(cfg))
            t0 = time.perf_counter()
            check(cli_sweep.main(["convex", str(path), "--device", dev.type, *extra]) == 0,
                  f"9a: sweep CLI {tag}")
            arrays[tag] = (dict(np.load(cfg["output"])), time.perf_counter() - t0)
    finally:
        selfconfig.stage1_settings = full
        dist.destroy_process_group()
    for key in ("dice", "jstd", "hd95", "rank"):
        check(np.array_equal(arrays["mesh"][0][key], arrays["plain"][0][key]),
              f"9a: sweep CLI --mesh {key} differs")
    out = {"batched_s": secs, "pairs": 2, "equal_to_lone": True, "lone_s": timings["lone"],
           "device_usage": usage, "trace_bytes": trace_bytes, "probe_device_count": n_cards,
           "cli_settings": [list(dataclasses.astuple(st)) for st in settings],
           "cli_plain_s": arrays["plain"][1], "cli_mesh_s": arrays["mesh"][1],
           "cli_mesh_equal": True, "launches": {k: v for k, v in launches.items() if v}}
    print(f"9a: two 192^3 pairs batched in {secs:.4f} s, each equal to its lone call; "
          f"{usage}; trace {trace_bytes} bytes; probe_device_count {n_cards}; sweep CLI --mesh over "
          f"NCCL (one rank) equal to the CLI without it ({arrays['mesh'][1]:.2f} / "
          f"{arrays['plain'][1]:.2f} s); {time.perf_counter() - t_phase:.2f} s", flush=True)
    results["parallel"] = {"9a_one_process": out}
    return launches, batched_np


def rank_main(out_dir: str) -> int:
    """One gloo rank of phases 9b and 9c (``chip_smoke.py --rank OUT``,
    started by :func:`parallel_ranks_phase` with the process-group
    environment): the (2, 7) class tensor-parallel in both directions on
    7e's features, its candidate-block call recorded and held to the plain
    version (:func:`hold_call`) and the field gathered from every rank;
    then 5a's stage-1 sweep on a (setting 2, pair 1) grid; the fields,
    checks, metrics, seconds, peaks and launches to ``OUT/rank<r>.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    from convexadam_torch.core.convex import convex_displacement_tp
    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.parallel.batch import make_sweep_mesh
    from convexadam_torch.parallel.distributed import all_gather_tensor, init_distributed
    from convexadam_torch.selfconfig import run_stage1_sweep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rank = int(os.environ["RANK"])
    check(init_distributed(backend="gloo", timeout_s=PARALLEL_GROUP_TIMEOUT_S), "not joined")
    segs = sweep_subjects()
    g, q = STREAM_CLASS
    fix_s, mov_s = class_features(torch, dev, segs[0], segs[1], g)
    res: dict = {"rank": rank, "tp": {}}
    for direction, (a, b) in (("forward", (fix_s, mov_s)), ("reverse", (mov_s, fix_s))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated() / 1e9
        calls: list = []
        dist.barrier()
        reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad(), _recording(torch, calls):
            field = convex_displacement_tp(a, b, q, dist.group.WORLD)
        torch.cuda.synchronize()
        out = {"field": field.cpu().numpy(), "seconds": time.perf_counter() - t0,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "start_gb": start,
               "launches": dict(LAUNCHES)}
        with torch.no_grad():
            # the ranks hold their blocks in turn: a block's plain version
            # takes about 20 GB at this shape
            for turn in range(PARALLEL_RANKS):
                if turn == rank:
                    out["held"] = [hold_call(torch, name, args) for name, args in calls]
                    torch.cuda.empty_cache()
                dist.barrier()
            fields = all_gather_tensor(field)
        out["gathered_equal"] = all(torch.equal(f, field) for f in fields)
        res["tp"][direction] = out
        del field, fields, calls
    del fix_s, mov_s
    torch.cuda.empty_cache()
    mesh = make_sweep_mesh(PARALLEL_RANKS, 1, device=dev)
    dist.barrier()
    reset_launches()
    t0 = time.perf_counter()
    s1 = run_stage1_sweep(segs, segs, SWEEP_PAIRS, sweep_settings(), L2R_LABELS, device=dev,
                          mesh=mesh)
    res["sweep"] = {"result": s1, "seconds": time.perf_counter() - t0,
                    "launches": dict(LAUNCHES), "coords": [mesh.coord("setting"),
                                                          mesh.coord("pair")]}
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)
    return 0


def space_rank_main(out_dir: str, backend: str = "gloo") -> int:
    """One rank of phase 9d (``chip_smoke.py --space-rank OUT [BACKEND]``,
    started by :func:`space_phase`; gloo, or NCCL with one card a rank):
    ``register_pairs_sharded(..., shard_space=True)`` at the default config
    on each grid of :data:`SPACE_GRIDS` over the pairs of
    ``OUT/space_inputs.npz``, twice: a warm-up with the first calls of
    every kernel wrapper recorded, then the run whose launches, seconds,
    peak memory and halo and gather bytes count.  Its fields against the
    one-process fields of the inputs file to the bit, and the recorded calls
    of :data:`SPACE_HELD` through the kernel and its plain version
    (:func:`hold_call`), go to ``OUT/space-rank<r>.pkl``; then the short
    case (:data:`SPACE_TINY_SHAPE`) over (pair 1, space 4), its field and
    launches."""
    import pickle

    import torch
    import torch.distributed as dist

    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.parallel import spatial
    from convexadam_torch.parallel.batch import make_mesh, register_pairs_sharded
    from convexadam_torch.parallel.distributed import init_distributed
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig

    dev = torch.device("cuda")
    rank = int(os.environ["RANK"])
    check(init_distributed(backend=backend, timeout_s=PARALLEL_GROUP_TIMEOUT_S), "not joined")
    data = np.load(os.path.join(out_dir, "space_inputs.npz"))
    fixed, moving, refs = data["fixed"], data["moving"], data["fields"]
    cfg = ConvexAdamConfig()
    res: dict = {"rank": rank, "grids": {}}
    for grid in SPACE_GRIDS:
        mesh = make_mesh(*grid, device=dev)
        n_pairs = grid[0]
        calls: list = []
        for run in ("warm-up", "counted"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated() / 1e9
            spatial.TRAFFIC.update(halo_bytes=0, gather_bytes=0)
            dist.barrier()
            reset_launches()
            t0 = time.perf_counter()
            with (_recording(torch, calls) if run == "warm-up" else contextlib.nullcontext()):
                field = register_pairs_sharded(fixed[:n_pairs], moving[:n_pairs], cfg, mesh,
                                               shard_space=True)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if run == "warm-up":
                warm_s = secs
        got = field.cpu().numpy()
        plan = spatial.slab_plan(fixed.shape[1], spatial.slab_unit(cfg), grid[1],
                                 mesh.coord("space"))
        res["grids"][grid] = {
            "card": str(mesh.device), "seconds": secs, "warmup_s": warm_s, "start_gb": start,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": dict(LAUNCHES),
            **spatial.TRAFFIC, "coords": [mesh.coord("pair"), mesh.coord("space")],
            "rows": plan.own(), "equal": [_bits_equal(got[i], refs[i]) for i in range(n_pairs)],
            "max_err": [float(np.abs(got[i] - refs[i]).max()) for i in range(n_pairs)],
            "held": [hold_call(torch, name, a) for name, a in calls if name in SPACE_HELD]}
        del field, calls
        torch.cuda.empty_cache()
    cfg = ConvexAdamConfig(**SPACE_TINY_CONFIG)
    mesh = make_mesh(1, SPACE_RANKS, device=dev)
    dist.barrier()
    reset_launches()
    got = register_pairs_sharded(data["tiny_fixed"][None], data["tiny_moving"][None], cfg, mesh,
                                 shard_space=True)[0].cpu().numpy()
    plan = spatial.slab_plan(SPACE_TINY_SHAPE[0], spatial.slab_unit(cfg), SPACE_RANKS,
                             mesh.coord("space"))
    res["tiny"] = {"rows": plan.own(), "launches": dict(LAUNCHES),
                   "equal": _bits_equal(got, data["tiny_field"]),
                   "max_err": float(np.abs(got - data["tiny_field"]).max())}
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"space-rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)
    return 0


def space_phase(torch, vol_np, mov_np, fields, peak_gb, results, backend="gloo"):
    """9d: :data:`SPACE_RANKS` ranks (:func:`space_rank_main`; gloo ranks
    sharing the card, or with ``backend="nccl"`` one card a rank) split the
    192^3 headline pair along H over a
    (pair 1, space 4) grid, and two headline pairs (9a's) over a (pair 2,
    space 2) grid: every rank's fields equal to the one-process fields
    ``fields`` (phase 4's, 9a's second) to the bit, the default launches a
    rank and pair (2 / 2 / 15 / 80), each rank's recorded cost-volume and
    data-term calls (a slab's offsets) held to their plain versions; each
    rank's seconds, peak memory (phase 4's one-process peak ``peak_gb``
    beside them) and halo bytes; then the short case
    (:data:`SPACE_TINY_SHAPE`, three slab units for four ranks): every
    rank's field equal to the one-process field to the bit, the rank of no
    rows launching no MIND, cost-volume or data-term kernel and the others
    the config's (2 / 2 / 15 / 10), inverse consistency on every rank.
    Returns each rank's launches by grid."""
    from scipy.ndimage import uniform_filter

    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, convex_adam

    torch.cuda.empty_cache()
    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    moving2 = np.roll(vol_np, PAIRED_SHIFTS[1], axis=(0, 1, 2))
    rng = np.random.default_rng(0)
    tiny = (uniform_filter(rng.standard_normal(SPACE_TINY_SHAPE).astype(np.float32), 3)
            * 100).astype(np.float32)
    tiny_m = np.roll(tiny, SPACE_TINY_SHIFT, axis=(0, 1, 2))
    tiny_cfg = ConvexAdamConfig(**SPACE_TINY_CONFIG)
    tiny_field = convex_adam(tiny, tiny_m, tiny_cfg, device="cuda")
    np.savez(PARALLEL_DIR / "space_inputs.npz", fixed=np.stack([vol_np, vol_np]),
             moving=np.stack([mov_np, moving2]), fields=np.stack(fields), tiny_fixed=tiny,
             tiny_moving=tiny_m, tiny_field=tiny_field)
    ranks, wall = _run_ranks(SPACE_RANKS, "space-rank", "9d", SPACE_DEADLINE_S, [backend])
    (PARALLEL_DIR / "space_inputs.npz").unlink()
    launches, out = {}, []
    for r in ranks:
        rank = r["rank"]
        for grid, d in r["grids"].items():
            what = f"9d {backend} rank {rank} on {d['card']} (pair, space) {grid}"
            check(all(d["equal"]), f"{what}: fields differ from the one-process fields by "
                  f"{d['max_err']}")
            _launch_checks(what, d["launches"], sweep_expected(**EXPECTED_LAUNCHES))
            held = d["held"]
            check({h["wrapper"] for h in held} == set(SPACE_HELD) and all(map(_held, held)),
                  f"{what}: calls held {held}")
            launches[f"9d_space_{grid[0]}x{grid[1]}_rank{rank}"] = d["launches"]
            out.append({"rank": rank, "grid": list(grid),
                        **{k: v for k, v in d.items() if k not in ("launches", "held")},
                        "held": [{k: h[k] for k in ("wrapper", "args", "max_abs_err")}
                                 | ({"ssq_rel_err": h["ssq_rel_err"]} if "ssq_rel_err" in h
                                    else {}) for h in held]})
            print(f"{what}: coords {d['coords']}, rows {d['rows'][0]}..{d['rows'][1] - 1}, "
                  f"{d['seconds']:.4f} s ({d['warmup_s']:.4f} s warm-up), peak "
                  f"{d['peak_gb']:.3f} GB ({d['start_gb']:.3f} held before; one process "
                  f"{peak_gb:.3f}), halo {d['halo_bytes']} bytes, gathers {d['gather_bytes']} "
                  f"bytes; fields equal to the one-process fields; {len(held)} cost-volume and "
                  f"data-term calls held to their plain versions, max_abs_err "
                  f"{max(h['max_abs_err'] for h in held)} (tol 0)", flush=True)
    tiny_out = []
    for r in ranks:
        t, rank = r["tiny"], r["rank"]
        what = f"9d {backend} rank {rank}, {SPACE_TINY_SHAPE} over (pair 1, space {SPACE_RANKS})"
        check(t["equal"], f"{what}: field differs from the one-process field by {t['max_err']}")
        holds = t["rows"][0] < t["rows"][1]
        n_iter = SPACE_TINY_CONFIG["selected_niter"]
        _launch_checks(what, t["launches"], sweep_expected(
            mind_ssd_stats=2 * holds, cost_volume=2 * holds, sample_trilinear_ic=IC_ITERS,
            warp_ssd_loss_grad=n_iter * holds))
        launches[f"9d_space_tiny_rank{rank}"] = t["launches"]
        tiny_out.append({"rank": rank, "rows": list(t["rows"]), "equal": t["equal"],
                         "launches": {k: v for k, v in t["launches"].items() if v}})
        rows = f"rows {t['rows'][0]}..{t['rows'][1] - 1}" if holds else "no rows"
        print(f"{what}: {rows}, field equal to the one-process field, launches "
              f"{tiny_out[-1]['launches']}", flush=True)
    check(sum(1 for t in tiny_out if t["rows"][0] == t["rows"][1]) == 1,
          f"9d: the short case's plan {[t['rows'] for t in tiny_out]} leaves no rank empty")
    cards = {d["card"] for r in ranks for d in r["grids"].values()}
    print(f"9d: {SPACE_RANKS} {backend} ranks on {len(cards)} card(s), {wall:.2f} s wall",
          flush=True)
    results["parallel"]["9d_space"] = {"ranks": out, "tiny": {
        "shape": list(SPACE_TINY_SHAPE), "config": SPACE_TINY_CONFIG, "ranks": tiny_out},
        "wall_s": wall, "backend": backend, "one_process_peak_gb": peak_gb}
    return launches


def _run_ranks(n: int, tag: str, what: str, deadline_s: float,
               extra=()) -> "tuple[list, float]":
    """``n`` ranks, each ``python3 chip_smoke.py --<tag> PARALLEL_DIR
    *extra`` with the process group's environment (a free localhost port);
    a rank that fails or outlives ``deadline_s`` fails phase ``what``.
    Returns the ranks' pickled results (``<tag><r>.pkl``, removed) and the
    seconds."""
    import pickle

    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(n):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(n))
        log = open(PARALLEL_DIR / f"{tag}{rank}.log", "w")
        logs.append(log)
        cmd = [sys.executable, str(ROOT / "chip_smoke.py"), f"--{tag}", str(PARALLEL_DIR), *extra]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    try:
        for rank, p in enumerate(procs):
            left = max(1.0, deadline_s - (time.perf_counter() - t0))
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                check(False, f"{what}: rank {rank} outlived the {deadline_s} s deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t0
    for rank, p in enumerate(procs):
        tail = (PARALLEL_DIR / f"{tag}{rank}.log").read_text()[-3000:]
        check(p.returncode == 0, f"{what}: rank {rank} exited {p.returncode}:\n{tail}")
    ranks = []
    for rank in range(n):
        path = PARALLEL_DIR / f"{tag}{rank}.pkl"
        with open(path, "rb") as fh:
            ranks.append(pickle.load(fh))
        path.unlink()
    return ranks, wall


def parallel_ranks_phase(torch, s1, dense, results):
    """9b and 9c: :data:`PARALLEL_RANKS` gloo ranks sharing the card
    (NCCL takes one rank a device), each a subprocess of this script with a
    deadline; a rank that fails or outlives the deadline fails the phase.
    9b: each rank's (2, 7) field, both directions, equal to 7e's dense field
    ``dense`` to the bit and to the field gathered from the other rank
    (gloo on CUDA tensors), its candidate-block call equal to the plain
    version's to the bit, with each rank's seconds, peak and candidate-block
    launches; 9c: both ranks' ``dice``, ``jstd``, ``hd95``, ``rank`` and
    ``best`` equal to 5a's result ``s1`` to the bit.  Returns each rank's
    launches by run."""
    torch.cuda.empty_cache()
    ranks, wall = _run_ranks(PARALLEL_RANKS, "rank", "9b/9c", PARALLEL_DEADLINE_S)
    launches, tp_out, sweep_out = {}, [], []
    for r in ranks:
        rank = r["rank"]
        row = {}
        for direction, d in r["tp"].items():
            ref = dense[direction].numpy()
            check(_bits_equal(d["field"], ref), f"9b rank {rank} {direction}: the tensor-parallel "
                  f"field differs from 7e's dense one by {float(np.abs(d['field'] - ref).max())}")
            check(d["gathered_equal"], f"9b rank {rank} {direction}: the fields gathered from "
                  f"the ranks differ")
            check(d["launches"]["cost_volume_block"] == 1,
                  f"9b rank {rank} {direction}: {d['launches']['cost_volume_block']} block launches")
            held = d["held"]
            check(len(held) == 1 and held[0]["wrapper"] == "cost_volume_block" and _held(held[0]),
                  f"9b rank {rank} {direction}: candidate-block calls held {held}")
            row[direction] = {k: d[k] for k in ("seconds", "peak_gb", "start_gb")}
            row[direction]["cost_volume_block_launches"] = d["launches"]["cost_volume_block"]
            row[direction]["cost_volume_block_held"] = held[0]
        launches[f"9b_tp_rank{rank}"] = {k: sum(d["launches"][k] for d in r["tp"].values())
                                         for k in r["tp"]["forward"]["launches"]}
        tp_out.append(row)
        got = r["sweep"]["result"]
        for key in ("dice", "jstd", "hd95", "rank"):
            check(np.array_equal(getattr(got, key), getattr(s1, key)),
                  f"9c rank {rank}: {key} differs from phase 5a's")
        check(got.best == s1.best, f"9c rank {rank}: winner {got.best}, phase 5a's {s1.best}")
        l9c = r["sweep"]["launches"]
        check(l9c["cost_volume"] > 0 and l9c["sample_trilinear_ic"] > 0,
              f"9c rank {rank}: launches {l9c}")
        launches[f"9c_sweep_rank{rank}"] = l9c
        sweep_out.append({"coords": r["sweep"]["coords"], "seconds": r["sweep"]["seconds"],
                          "times_s": got.times.tolist(),
                          "launches": {k: v for k, v in l9c.items() if v}})
        for direction, d in row.items():
            blk = d["cost_volume_block_held"]
            print(f"9b rank {rank} (2, 7) {direction}: {d['seconds']:.4f} s, peak "
                  f"{d['peak_gb']:.2f} GB ({d['start_gb']:.2f} held before), "
                  f"{d['cost_volume_block_launches']} candidate-block launch; equal to 7e's "
                  f"dense field and to the gathered fields; the block call {blk['args']} "
                  f"max_abs_err {blk['max_abs_err']} (tol 0) against its plain version",
                  flush=True)
        print(f"9c rank {rank} at (setting, pair) {r['sweep']['coords']}: stage-1 sweep "
              f"{r['sweep']['seconds']:.4f} s, times {np.round(got.times, 4).tolist()}; "
              f"dice/jstd/hd95/rank/best equal to 5a's; launches {sweep_out[-1]['launches']}",
              flush=True)
    print(f"9b/9c: {PARALLEL_RANKS} gloo ranks on one card, {wall:.2f} s wall", flush=True)
    results["parallel"]["9b_tensor_parallel"] = tp_out
    results["parallel"]["9c_sweep"] = sweep_out
    results["parallel"]["ranks_wall_s"] = wall
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from convexadam_torch.core.features import mindssc
    from convexadam_torch.core.smoothing import avg_pool3d
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.kernels import LAUNCHES, _build, reset_launches
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, convex_adam

    dev = torch.device("cuda")
    OUT_DIR.mkdir(exist_ok=True)
    results: dict = {}

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}", flush=True)
    print(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    results["card"] = {"nvidia_smi": smi, "name": kind}

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s", flush=True)
    results["build_s"] = build_s
    results["ptxas"] = ptxas_report(_build)

    vol_np, mov_np = headline_pair(torch, resize_trilinear)
    seg_f, seg_m = l2r_label_pair()
    vol = torch.from_numpy(vol_np).to(dev)
    records = []

    # 3a. MIND statistics
    rec, general_rec, results["mind"] = mind_phase(torch, vol)
    rec.update(ptxas_entry(results["ptxas"]["mind"], "mind_kernel", "bfloat16", "Li1ELi2E"))
    general_rec.update(ptxas_entry(results["ptxas"]["mind"], "mind_general_kernel", "bfloat16",
                                   "Lb1E"))
    records += [rec, general_rec]

    # 3b. cost volume: pooled MIND features of the headline pair, 12 x 32^3,
    # q = 4; the semantic and sweep grids; ragged crops at q = 0..9
    cfg = ConvexAdamConfig()
    feat_f = mindssc(vol, 1, 2, dtype=torch.bfloat16)
    feat_m = mindssc(torch.from_numpy(mov_np).to(dev), 1, 2, dtype=torch.bfloat16)
    fix_s = avg_pool3d(feat_f, cfg.grid_sp).float().contiguous()
    mov_s = avg_pool3d(feat_m, cfg.grid_sp).float().contiguous()
    rec, results["cost_volume"] = cost_volume_phase(torch, fix_s, mov_s, cfg.disp_hw)
    rec.update(ptxas_entry(results["ptxas"]["cost_volume"], "cost_volume_kernel",
                           f"ILi{cfg.disp_hw}ELb0E"))
    records.append(rec)
    # the variants: SAD, the general kernel at q = 8, candidate blocks
    variant_records, results["cost_volume_variants"] = cost_volume_variant_phase(torch, dev)
    ptx = results["ptxas"]["cost_volume"]
    variant_records["cost_volume_sad"].update(ptxas_entry(ptx, "cost_volume_kernel", "ILi3ELb1E"))
    variant_records["cost_volume_general"].update(ptxas_entry(ptx, "cost_volume_general_kernel",
                                                              "Lb0E"))
    variant_records["cost_volume_block"].update(ptxas_entry(ptx, "cost_volume_kernel",
                                                            f"ILi{STREAM_CLASS[1]}ELb0E"))
    records += list(variant_records.values())

    # 3c. trilinear sampler on inverse consistency's 2 x 3 x 32^3 fields (as
    # float32 and as bfloat16 volumes), and ragged; then the fused steps
    gen = torch.Generator(device="cpu").manual_seed(0)
    h, w, d = fix_s.shape[1:]
    sampler_at_ic, results["sampler"] = sampler_phase(torch, dev, gen, (h, w, d))
    ic_record, results["inverse_consistency"] = ic_phase(torch, dev, gen, (h, w, d))
    records.append(ic_record)

    # 3d. Adam data term
    rec, results["data_term"] = data_term_phase(torch, gen, feat_f, feat_m, cfg.grid_sp_adam)
    rec.update(ptxas_entry(results["ptxas"]["warp"], "warp_ssd_kernel", "bfloat16"))
    records.append(rec)
    rec, results["data_term_strided"] = strided_data_term_phase(torch, gen, feat_f, feat_m,
                                                                cfg.grid_sp_adam)
    rec.update(ptxas_entry(results["ptxas"]["warp"], "warp_ssd_kernel", "bfloat16"))
    records.append(rec)
    del feat_f, feat_m

    # 3e. the HD95 engine's nearest-neighbour searches
    search_records, search_detail = search_phase(torch, dev, seg_f, seg_m)
    for rec in search_records:
        rec.update(ptxas_entry(results["ptxas"]["edt"], GLOBALS[rec["name"]][0]))
    records += search_records
    results["searches"] = search_detail

    # 3f. the sampler's coordinate gradient
    bwd_records, bwd_detail = sampler_bwd_phase(torch, dev, gen)
    for rec in bwd_records:
        if rec["name"] == "sample_trilinear":
            rec.update(ptxas_entry(results["ptxas"]["warp"], "sample_trilinear_kernel", "bfloat16"))
            # its inverse-consistency shape, the shape of earlier readings
            rec["at_ic_shape"] = {k: v for k, v in sampler_at_ic.items() if k != "timing_readings"}
    records += bwd_records
    results["sampler_bwd"] = bwd_detail

    # 4a. main path: default config on the headline pair
    convex_adam(vol_np, mov_np, device="cuda")  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    out = convex_adam(vol_np, mov_np, device="cuda")
    launches = dict(LAUNCHES)
    print(f"launches per registration: {launches}", flush=True)
    for name, want in EXPECTED_LAUNCHES.items():
        check(launches[name] == want, f"{name}: {launches[name]} launches, expected {want}")
    check(out.shape == HEADLINE_SHAPE + (3,) and bool(np.isfinite(out).all()), "bad field")
    c = 32
    err_v = np.abs(out[c:-c, c:-c, c:-c] - np.array(HEADLINE_SHIFT, np.float32))
    frac_ok = float(np.mean(np.all(err_v < 1.0, axis=-1)))
    check(frac_ok > 0.9, f"headline shift recovered in only {frac_ok:.2%} of the crop")
    torch.cuda.reset_peak_memory_stats()  # phase 3b's sweep volumes are not the registration's
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        convex_adam(vol_np, mov_np, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    reg = {
        "shape": list(HEADLINE_SHAPE), "config": "default (dtype auto = bfloat16)",
        "frac_within_1vox": frac_ok, "mean_abs_err_vox": float(err_v.mean()),
        "registration_s_median": float(np.median(times)), "registration_s": times,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"registration 192^3: {reg['registration_s_median']:.4f} s (median of 3), "
          f"{frac_ok:.2%} of the crop within 1 voxel", flush=True)

    # 4b. golden 48^3 fixture: the JAX package's f32 and bf16 envelopes
    golden = np.load(ROOT / "tests" / "golden_disp_48.npz")
    gvol = golden["vol"].astype(np.float32)
    gmov = np.roll(gvol, tuple(golden["shift"]), axis=(0, 1, 2))
    gcfg = ConvexAdamConfig(grid_sp=4, disp_hw=2, lambda_weight=1.25, selected_niter=80,
                            grid_sp_adam=2)
    gref = golden["disp"].astype(np.float32)
    for dtype, med_lim, p99_lim, max_lim in (("float32", 0.05, 0.5, np.inf),
                                             ("bfloat16", 0.15, 0.75, 1.5)):
        gout = convex_adam(gvol, gmov, gcfg, device="cuda", dtype=dtype)
        epe = np.sqrt(((gout - gref) ** 2).sum(-1))
        med, p99 = float(np.median(epe)), float(np.quantile(epe, 0.99))
        check(med < med_lim and p99 < p99_lim and float(epe.max()) < max_lim,
              f"golden {dtype}: median {med:.4f} / p99 {p99:.4f} / max {epe.max():.4f} "
              f"outside {med_lim} / {p99_lim} / {max_lim}")
        reg[f"golden48_{dtype}"] = {"median_epe": med, "p99_epe": p99, "max_epe": float(epe.max())}
        print(f"golden 48^3 {dtype}: median {med:.4f}, p99 {p99:.4f}", flush=True)

    # 4g. the same registration at an (r, d) the general MIND kernel runs
    general_launches = general_mind_phase(torch, vol_np, mov_np, results)

    # 4c. evaluation path: the registered field on the 13-organ label pair
    eval_launches, tiled_launches = evaluation_phase(torch, out, seg_f, seg_m, results)

    # 4d-4f. the semantic entry, the multi-output run, the autodiff Adam step
    _, adam_inputs = semantic_phase(torch, dev, results)
    multi_output_phase(torch, dev, vol_np, mov_np, out, results)
    autodiff_launches = autodiff_phase(torch, adam_inputs, results)

    # 5. the sweep at the Abdomen shape: stage 1, stage 2, the paired sweeps,
    # resume, and the kernels at the shapes only the sweep gives them
    segs = sweep_subjects()
    s1_settings, s1, sweep_l1, field25 = sweep_stage1_phase(torch, dev, segs, smi, results)
    adam, sweep_l2 = sweep_stage2_phase(torch, dev, segs, s1_settings[s1.best], smi, results)
    paired_l1, paired_l2 = sweep_paired_phase(torch, dev, adam[SWEEP_ADAM_GRIDS.index(2)], smi,
                                              results)
    resume_l = sweep_resume_phase(torch, dev, segs, s1_settings, s1, results)
    sweep_kernel_phase(torch, dev, segs, s1_settings, field25, records, results)
    del field25
    # 5f. `run_full_protocol` over the reference's 8 pairs, stopped
    # and resumed in each stage
    protocol_l = protocol_phase(torch, dev, smi, records, results)

    # 6. the file-level path: the CLIs, the translation, the task driver and
    # test-set inference, from files on disk
    file_launches = file_phase(torch, dev, results)

    # 7. the challenge recipes at their published shapes, the streamed convex
    # path and the strided data term
    keep: dict = {}
    challenge_launches = challenge_phase(torch, dev, vol_np, mov_np, out, records, results, keep)

    # 8. the segmentation front end: the U-Net on its held-out case, then
    # semantic registration from raw images at the Abdomen shape
    unet_phase(torch, dev, results)
    seg_launches = segmentation_entry_phase(torch, dev, records, results)

    # 9. the multi-device layer: one process (batched pairs, the utilities,
    # the sweep CLI over an NCCL group of one), then two gloo ranks sharing
    # the card (the tensor-parallel convex stage, the sweep on a grid)
    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    l9a, batched = parallel_one_process_phase(torch, dev, vol_np, mov_np, results)
    parallel_launches = {"9a_batched": l9a}
    parallel_launches.update(parallel_ranks_phase(torch, s1, keep["7e_dense"], results))
    # 9d. four gloo ranks split each pair along H
    parallel_launches.update(space_phase(torch, vol_np, mov_np, [out, batched[1]],
                                         reg["peak_mem_gb"], results))
    del batched
    shutil.rmtree(PARALLEL_DIR)

    # 8. output: each kernel's launches on the path that runs it
    variant_runs = {"cost_volume_sad": ("7c_task3", "task 3 (SAD) registration of phase 7c"),
                    "cost_volume_general": ("7a_task1", "task 1 (q = 8) registration of phase 7a"),
                    "cost_volume_block": ("7e_streamed",
                                          "streamed (2, 7) direction of phase 7e"),
                    "warp_ssd_loss_grad_strided": ("7f_strided",
                                                   "stride-2 192^3 registration of phase 7f")}
    for rec in records:
        name = rec["name"]
        rec["launches_challenges"] = {k: v[name] for k, v in challenge_launches.items()}
        rec["launches_file"] = {k: v[name] for k, v in file_launches.items()}
        rec["launches_segmentation"] = {"8b_semantic_from_images": seg_launches[name]}
        rec["launches_parallel"] = {k: v[name] for k, v in parallel_launches.items()}
        rec["launches_sweep"] = {"stage1": sweep_l1[name], "stage2": sweep_l2[name],
                                 "paired_stage1": paired_l1[name], "paired_stage2": paired_l2[name],
                                 "stage1_resume": resume_l[name],
                                 "protocol": protocol_l["protocol"][name],
                                 "protocol_resumes": protocol_l["protocol_resumes"][name]}
        if name == "mind_ssd_stats_general":
            rec["launches"] = general_launches[name]
            rec["launches_run"] = (f"192^3 registration at (mind_r, mind_d) = {GENERAL_MIND} "
                                   "of phase 4g")
            rec["launches_per_registration"] = launches[name]
        elif name in variant_runs:
            key, run = variant_runs[name]
            rec["launches"] = challenge_launches[key][name]
            rec["launches_run"] = run
        elif name in ("sample_trilinear", "sample_trilinear_bwd"):
            rec["launches"] = rec["launches_per_autodiff_adam"] = autodiff_launches[name]
            rec["launches_run"] = "80-iteration autodiff Adam of phase 4f"
            rec["launches_per_registration"] = launches[name]
        elif name in EXPECTED_LAUNCHES:
            rec["launches"] = rec["launches_per_registration"] = launches[name]
            rec["launches_run"] = "192^3 default registration of phase 4"
        elif name == "nearest_sq_pruned":
            rec["launches"] = rec["launches_per_evaluation"] = eval_launches[name]
            rec["launches_run"] = "evaluate_field"
        else:
            # the default branch takes the pruned search at every K up to
            # 2097152, so these two run only in the evaluation with it
            # switched off: their launches are that run's
            rec["launches"] = tiled_launches[name]
            rec["launches_run"] = "evaluate_field with the pruned search switched off"
            rec["launches_per_evaluation"] = eval_launches[name]
            rec["launches_per_evaluation_pruned_off"] = tiled_launches[name]
    results["registration"] = reg
    results["kernels"] = records
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"registration": reg}))
    print(json.dumps({"registration_general_mind": results["registration_general_mind"]}))
    print(json.dumps({"evaluation": {k: v for k, v in results["evaluation"].items()
                                     if not isinstance(v, list)}}))
    for key in ("semantic", "multi_output", "autodiff"):
        print(json.dumps({key: results[key]}))
    for key in ("sweep_stage1", "sweep_stage2", "sweep_paired", "sweep_protocol"):
        print(json.dumps({key: {k: v for k, v in results[key].items()
                                if k not in ("composed", "launches", "launches_stage1",
                                             "launches_stage2", "resume")}}))
    print(json.dumps({"phase6": {k: v for k, v in results.items() if k.startswith("file_")}}))
    print(json.dumps({"phase7": results["challenges"]}))
    print(json.dumps({"phase8": results["segmentation"]}))
    print(json.dumps({"phase9": results["parallel"]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "timing_readings"}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--space-rank"]:
        sys.exit(space_rank_main(*sys.argv[2:4]))
    sys.exit(main())
