#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``proudslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero (a
slice's ATE over its bound is raised once the other phases have run, so
that the run still measures them and prints its kernels line; then no
last line is printed):

1. device: require CUDA; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. build: compile the CUDA kernels from ``proudslam_tpu_torch/csrc`` (one
   ``nvcc`` per source and decoder size, all started together): the three
   sources at the bench decoder's (in_dim, width, sdf_dim) = (16, 128,
   128), and ``render_stream.cu``, ``mlp_stream.cu`` and
   ``mlp_stream_f32.cu`` (the streamed plans) at each of the thirty-two
   other sizes of ``mlp_kernel.BUILT_SIZES`` up to width 256,
   ``render_wide.cu``, ``mlp_wide.cu`` and ``mlp_stream_f32.cu`` at its
   twenty-three wide sizes (width 384 and 512; in_dim 16, 32 and 64, and
   in_dim 128 at (128, 512, 256) and (128, 512, 512)), and
   ``render_park.cu``, ``mlp_park.cu`` and ``mlp_stream_f32.cu`` at its
   six parked sizes (width 768 and 1024, ``mlp_kernel.PARK_SIZES``), and
   ``mlp_wgrad.cu`` (K3's second pass, ``decoder_wgrad``, and the reduce)
   and ``mlp_wgrad_f32.cu`` (K3-f32's second pass, ``decoder_wgrad_f32``)
   once for every size: 188 libraries;
   each library's ``-Xptxas -v`` report (registers, spills, wgmma
   warnings) and its count of tensor-core instructions (HGMMA, HMMA) and
   FFMA in ``cuobjdump -sass`` are logged; K1, K2, K3 (its first pass) and
   ``decoder_wgrad`` must each hold HGMMA, no HMMA, and no spills at every
   size; K2-f32, K3-f32 (its first pass) and ``decoder_wgrad_f32`` (f32
   operands, 3xTF32 on ``mma.sync``; K3-f32's forward recompute FFMA)
   HMMA, no HGMMA, and no spills at every size;
3. kernels: run each kernel at the slices' mapping and tracking shapes
   (1024 rays, 65,536 rows) on inputs from the real pipeline and hold it
   against its plain PyTorch version (stated tolerances; K3 full and
   dx-only; all three also at row counts that are no multiple of their
   64-row tile), K2 on K1's features against K1's outputs bit for bit (the
   two run one decoder), K3's second pass (``decoder_wgrad``) against its
   plain version on identical operands at one size of each plan
   (``wgrad_check``, TOL_WGRAD) and K3's gradients bit for bit from call
   to call, K3's two passes timed apart, with CUDA-event times of each
   kernel and its plain version at both shapes, each kernel's bound (least time on the
   card, from this run's shapes) and, for the decoder kernels, a chain of
   bf16 ``torch.matmul`` calls as a yardstick (no single PyTorch call
   computes these functions; the second passes beside their five products
   as ``torch.matmul`` calls); the same for K2-f32 and K3-f32 (full and
   dx-only) on the pcd features at the mapping, tracking and ragged row
   counts, against the plain versions with f32 operands (TF32 off), with a
   chain of f32 ``torch.matmul`` calls as the yardstick, and both the
   3xTF32 bound (the tensor cores) and the FP32-unit bound, K3-f32's two
   passes timed apart and its second pass (``decoder_wgrad_f32``) against
   its plain version on identical f32 operands at one size of each plan
   (``wgrad_check(..., bf16=False)``, TOL_WGRAD_F32); then hold the pcd
   branch's ``render_rays`` (PointNet gather, K2, K3 through autograd) on
   the card against the same call on the CPU, outputs and gradients, on
   512 rays; and ``decoder_values`` with the Gaussian embedder (f32
   operands, 65,536 rows) on the card against the CPU (1e-5 of the largest
   output: the embedding's ``x @ B`` in true f32, TF32 off; the same call
   with TF32 on is logged as the control). Then the same holds of K1, K2
   and K3 at each other size of ``mlp_kernel.BUILT_SIZES`` (``size_phase``:
   the K1 inputs above, with corner embeddings of 32, 64 or 128 values
   from a seed at the in_dim-32, -64 and -128 sizes, that size's
   ``init_decoder`` params; K3's dx there
   held on the rows away from a ReLU kink, ``MARGIN_FLIP``), with times,
   bounds and shares and the bf16 matmul chain's times; and of K2-f32 and
   K3-f32 (full and dx-only) at each other size of
   ``mlp_kernel.BUILT_SIZES`` (``f32_size_phase``: the pcd features above,
   from a PointNet of output width 32, 64 or 128 at the in_dim-32, -64
   and -128 sizes, at the
   mapping, tracking and a ragged row count, that size's params, the f32
   tolerances, K3-f32's dx held on the rows of
   margin >= ``MARGIN_FLIP_F32``, each row whose dx misses a witnessed
   mask flip and the gradients over all rows held at the tolerance plus
   those rows' terms; at the wide sizes K3's weight gradients are held on
   a launch over the rows away from a kink too, the note after
   TOL_FLIP_SHARE,
   and a K2-f32 column that misses its plain version against the float64
   forward, TOL_F32_FWD's note), with times against the f32 matmul
   chain, the 3xTF32 bound and its share. Both run in full (the checks at
   the mapping, tracking and ragged shapes) at the sizes of FULL_SIZES and
   reduced elsewhere (``full=False``: the checks at the tracking shape and
   a ragged count below it; at the parked sizes the kernels timed at both
   shapes and their plain versions and the chains at the tracking shape,
   at the older ones the kernels at the tracking shape, ``size_timing``).
   Then every form at the decoder
   sizes of ``PAD_SIZES``, which the kernels take zero-padded to a built
   size (``pad_phase``: in_dim 8, a width no multiple of 64, sdf_dim >
   width, a size landing on a streamed one, in_dim 24 and 20 padded to
   32, three that pad to wide sizes: (16, 300, 200), (24, 450, 500)
   and (16, 64, 320), in_dim 33, 48 and 40 padded to 64: (33, 64,
   64), (48, 256, 128) and (40, 300, 200), and in_dim 65 to 127 padded to
   128: (65, 64, 64), (100, 256, 128), (96, 300, 200) and (72, 64, 320),
   and two that pad to parked sizes: (16, 700, 200) and (40, 900, 1000)),
   at the tracking shape against
   its plain version at the unpadded
   size with each form's tolerance, and every padded gradient entry
   exactly 0. A ``size table`` line per kernel and streamed size joins its
   times, shares, plain and chain times, error and build;
4b. vox-w256 slice: the vox slice's configuration with the reference's
   wider decoder (16, 256, 128) over the first 5 frames: K1 and K3 (their
   streamed plan, and K3's second pass) launched, K2 and the f32 forms not, the poses finite and
   the unaligned ATE under 3 cm; then vox-d32, the same at (32, 256,
   128) with embeddings of 32 values (the feature width of NICE-SLAM's
   and ESLAM's ``c_dim``), the same launches and bound; then vox-w512,
   the same at (16, 512, 512) (the wide plan of K1 and K3) over the vox
   slice's 40 frames, the same launches and bound; then vox-w1024, the same at the widest built size
   (16, 1024, 1024) (the parked plan of K1 and K3) over the first 10
   frames, the same launches and bound; then vox-d64, the same at (64,
   256, 128) with
   embeddings of 64 values (K3's w1 and wc_x streamed, K1's blend in
   four passes), the same launches and bound; then vox-d128, the same at
   (128, 256, 128) with embeddings of 128 values (K1's and K2's w1 and
   wc_x streamed too, K1's blend in four passes of 32 dims), the same
   launches and bound. K1, K3 and K3's second pass (``decoder_wgrad``) are
   the launches of every one; then ``run_slam.check_config``
   for the card must accept the fused pcd path at f32 operands at (16,
   256, 128), at a padded size, at (32, 256, 128), at (64, 256, 128), at
   (128, 256, 128), at (16, 512, 512), at the padded wide (16, 300, 200),
   at in_dim 48, at in_dim 100 (padded to 128), at (16, 1024, 1024) and
   at the padded (40, 900, 1000), and refuse in_dim 129, width 1025 and
   sdf_dim 1025 (no built size covers them) naming the size and the form,
   with no launch;
4. vox slice: the bench configuration with the fused render path on
   (``config.bench_settings``): ``SlamSystem.initialize`` (200 mapping
   iterations), 39 ``process_frame`` calls over the first 40 frames of the
   480-frame ``scan`` trajectory at 320x240, and ``global_refine(rounds=2)``;
   K1 and K3 must have been launched, the poses finite and the unaligned
   ATE under 3 cm. Then its mesh: ``extract_mesh(res=8)`` with vertex
   colors, cleaned against the slice's depth cloud at the final trajectory
   (``run_slam.accumulate_depth_cloud``), held against the analytic scene
   as ``bench.py`` does: accuracy (mean vertex-to-surface distance) and
   completion (mean distance from depth samples of every 30th frame to
   the nearest vertex) must each be under 10 cm, half the voxel, the mesh
   non-empty, and no kernel may launch inside it (the mesher decodes with
   the plain decoder, as the JAX package's);
5. pcd slice: the same configuration with ``feature_mode="pcd"`` (PointNet
   features of <= 8 stored points per voxel): ``initialize``, the first
   5 frames and ``global_refine(rounds=2)``, which returns at once: the
   first keyframe after the initial one is committed at frame 13 at the
   earliest (``early_keyframe_gap`` 12). K2 and K3 must have been launched
   and K1 not, the poses finite, the point store non-empty, the PointNet
   params trained and the unaligned ATE under 60 cm. That bound and the
   5 frames are the JAX package's own functional test of this branch
   (``tests/test_pcd_features.py``), where the branch drifts by several cm
   per frame; ``tests/test_torch_pcd_slam.py`` run as a script prints both
   engines' drift at that test's size;
5b. pcd-f32 slice: the pcd slice with ``matmul_dtype="f32"`` (the
   configs' default operand type): K2-f32 and K3-f32 (both its passes)
   must have been launched and K1, K2 and K3 not, the poses finite and the
   unaligned ATE
   under the pcd slice's 60 cm; then pcd-f32-w256, the same at the
   reference's wider decoder (16, 256, 128), which runs the streamed f32
   plan: K2-f32 and K3-f32 launched and no other kernel, the poses finite,
   the unaligned ATE under 100 cm (the note at PCD_W256_ATE_LIMIT_CM says
   why not 60), and K2-f32 and K3-f32 on the decoder the slice trained held
   against their plain versions (f32 tolerances); then pcd-f32-d32, the
   same at (32, 256, 128) (PointNet's output width follows in_dim): only
   K2-f32 and K3-f32 launched, the same bounds and checks; then
   pcd-f32-w512, the same at (16, 512, 256) (the wide f32 plan: K2-f32's
   and K3-f32's two live 32-row tiles), the same launches, bound
   and checks; then pcd-f32-d64, the
   same at (64, 256, 128), the same launches, bound and checks; then
   pcd-f32-d128, the same at (128, 256, 128), the same launches, bound and
   checks;
5c. resample run: the vox configuration with ``fixed_sample_batch=False``
   in the tracker and the mapper (a fresh pixel batch per Adam iteration,
   intersected at the current pose) and the Gumbel pixel sampler, over the
   first 10 of the rendered frames and ``global_refine(rounds=2)``: K1 and
   K3 must have been launched, the unaligned ATE under 3 cm; its frames/s
   and per-phase ms are logged beside the fixed-batch vox slice's;
5d. dda slice: the vox slice with ``intersect_mode="dda"`` (the grid
   march through the occupancy grid, built once per tracker and mapper
   call) over its first 20 frames: K1 and K3 launched and no other kernel, the unaligned ATE under
   3 cm, frames/s and per-phase ms logged beside the vox slice's. On its
   final map: ``build_occupancy`` must drop no live voxel; at the tracking
   (1024 rays) and mapping (5 x 1024) shapes ``ray_intersect_dda`` is held
   against the brute ``ray_intersect`` (every brute hit it misses a graze
   with a chord under the march spacing, the hits both find at depths
   within 1e-4, no hit of its own but past the last of a full brute list,
   its grazes within 15% of what a march at that spacing must miss), with
   CUDA-event times of the three functions and the comparison timed by the
   port's ``Profiler``; and on
   1024 rays ``gather_ray_features`` (the ``GatherF8`` gather and its
   segment-sum backward) against ``gather_ray_features_onehot``, values
   and embedding gradients within 1e-5 of each one's largest magnitude;
5e. window slice: the vox configuration with covisibility-weighted
   keyframe windows (``covis_angle_deg=30``, ``keyframe_gap=2``) over the
   first 30 frames and ``global_refine(rounds=2)``: at least 12 windows
   drawn by the covisibility rule, K1 and K3 launched, the unaligned ATE
   under 3 cm;
6. vox profile: another vox run, ``torch.profiler`` over frames 5-6 (each
   engine phase a profiler range): device busy ms per frame in all and
   per phase with each phase's idle share, kernel launches per frame, the
   top kernels' shares, and the host's CPU ms per frame;
7. cli: ``proudslam_tpu_torch.run_slam.main`` on
   ``configs/synthetic/room.yaml`` (its first 10 of 40 frames at
   320x240, the unfused branch with an f32 decoder, 100 initial mapping
   iterations, mesh at res 8) with ``--debug_args.render_freq 5`` into a
   temporary log directory: every artifact must be there (trajectory, mesh
   that parses back, checkpoint + sidecar, metrics, and the panels
   ``imgs/render_00004.png`` and ``imgs/render_00009.png``, each decoding
   to the panel's 3x2 tiles of the 200x160 preview), no kernel launched
   (the unfused branch and the preview run none), the unaligned ATE under
   3 cm, and the checkpoint, loaded into a fresh ``SlamSystem`` on the
   card, must give the saved trajectory bit for bit;
8. cli-pcd: the same entry point on room.yaml with ``--tpu_specs.feature_mode
   pcd --tpu_specs.fused_mlp true --no-mesh``, 5 frames (the YAML's f32
   operands): K2-f32 and K3-f32 (both its passes) must have been launched
   and no other kernel, the trajectory finite and the checkpoint reloaded
   bit for bit;
9. cli-embed: the same entry point on a YAML derived from room.yaml with
   the NeRF embedder (4 frequencies) and a skip, 5 frames and a mesh: no
   kernel launched, the trajectory finite, the checkpoint reloaded bit for
   bit, the ATE logged without a bound;
10. parallel (last, so that no other phase sees a live process group): a
   real NCCL process group of world size 1 on ``cuda:0`` (one card is one
   rank: NCCL takes one rank per device; 2 and 4 ranks are held on the CPU
   by ``tests/test_torch_parallel_*.py`` over gloo), and the vox slice's
   configuration as ``SlamSystem(mesh=make_engine_mesh(1, mp=1))`` (every
   collective of ``parallel/engine.py`` on the path) over the first 5
   frames and ``global_refine(rounds=2)``: K1 and K3 launched on this path
   (its own ``launches_by_path["parallel"]``), the unaligned ATE under
   3 cm, and the trajectory held against the plain engine's on the same
   frames in this call (5 mm, the JAX dry run's mesh-against-single bound;
   one rank's collectives are identities, so equality is expected and
   logged); then ``dryrun_multichip(1)`` (the engine on a mesh against the
   plain engine, the sharded, spatial and Schur BA steps finite, the map
   stored over the ranks) and the Schur step against its dense joint solve
   on ``tests/test_schur.py``'s problem (its tolerances: residual norm rtol
   1e-5, updates atol 5e-4). The process group is destroyed at the end of
   the phase.

Every launch count is set to 0 just before a slice (and each cli run) and
read just after it; the mesh's launches are the counts' change across it.
Standard output ends with the slices' JSON line (with the script's total
seconds), the kernels' JSON line, the card's name and power limit, and
``{"ok": true, "device": {...}}``. The script imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# K1 `feats` are f32 blends computed by the same formula in the same order
# (only FMA contraction can differ): 1e-5 absolute at unit-scale features.
TOL_FEATS = 1e-5
# K1's decoder, which K2 runs too, sums on the tensor cores, in another
# order than the plain version's f32 matmuls: a rounding-level difference
# can flip the bf16 rounding of one hidden activation (2^-8 relative),
# which moves an output by up to ~|h| * |w| / 256 (~3e-4 for the sdf
# column: |ws| <= 0.09). On an H100 the largest error was 1.7e-4 on
# trilinear features, in the sdf column (the colors 4e-5); held at 3e-4,
# where the row-shift check still has a margin of ~500x. Every check must
# be able to tell a kernel that reads a neighbouring row: the plain outputs
# of neighbouring rows must differ by more than SHIFT_MARGIN x the
# tolerance.
TOL_K1_OUT = 3e-4
SHIFT_MARGIN = 100.0
# K2 on the pcd branch's features (rms ~0.07, small hidden activations, so
# a flipped bf16 rounding moves an output less): 1e-4 absolute (2.5e-5 on
# an H100). On K1's trilinear features K2 gives K1's outputs bit for bit
# (it runs K1's decoder on inputs rounded the same way), so it is held
# there at K1's tolerance.
TOL_K2 = 1e-4
# pcd render_rays on the card against the CPU (plain kernel versions):
# PointNet's f32 sums run in another order on each, so a feature can round
# to a neighbouring bf16 value at the decoder's input, as between the port
# and the JAX package on the CPU: the tolerances of that test, 2e-3
# absolute on outputs and 5e-3 of each gradient's largest magnitude (a
# gradient routed to the wrong leaf or dropped is off by ~1 of it).
TOL_RENDER_OUT = 2e-3
TOL_RENDER_GRAD_REL = 5e-3
RENDER_RAYS = 512
# K3 gradients: sums over up to 327,680 rows in another order; a
# rounding-level difference in a hidden pre-activation near 0 flips its
# ReLU mask, which drops or adds one term of dx (the kernel phase logs dx's
# error by each row's smallest |pre-activation|). Held at 1e-2 of each
# output's largest magnitude, at the mapping and tracking shapes (full and
# dx-only) and at ragged row counts (a masked last tile).
TOL_GRAD_REL = 1e-2
# K3 at the streamed plan's sizes (every size but (16, 128, 128)): one
# flipped bf16 rounding of an upstream activation moves a hidden
# pre-activation by ~|h| |w| 2^-8 (~1e-4 at these weights), so a row whose
# smallest |pre-activation| is under MARGIN_FLIP can take another ReLU mask
# than the plain version and its dx differs by a whole term: on an H100, up
# to 3.6e-2 of dx's largest magnitude at (16, 256, 128) over all rows, 3.5e-3
# over the rows at or above 1e-4, 1e-6 over those above 1e-3. So there dx is
# held at TOL_GRAD_REL on the rows at or above MARGIN_FLIP, and the rows
# whose dx misses TOL_GRAD_REL may be at most TOL_FLIP_SHARE of all (a kernel
# that reads the wrong row or column misses it on most rows); every weight
# and bias gradient is held at TOL_GRAD_REL as at (16, 128, 128).
MARGIN_FLIP = 1e-4
TOL_FLIP_SHARE = 1e-2
# K3 at the wide sizes (width 384 and 512): with twice the hidden units and
# up to 512 + in_dim terms in hc's pre-activation, a bf16 rounding that
# differs upstream flips hc's ReLU mask on a few of a column's rows, and
# each flip moves that column of dwc_x, dwc_f and dbc by one row's term
# (x dhc): on an H100 at (16, 512, 512) dwc_x is 1.6e-2 of its largest
# magnitude from its plain version over the 65,536 rows of the tracking
# shape (0.8e-2 over 327,680), and the plain version on the CPU is 0.85e-2
# from the same plain version on the card (against ~1e-6 at (16, 256,
# 128)), while dx on the rows of margin >= MARGIN_FLIP is within 5e-4 and
# no row's dx misses TOL_GRAD_REL. So there, as K3-f32
# at every streamed size, each weight and bias gradient is held at
# TOL_GRAD_REL on a second launch over the rows of margin >= MARGIN_FLIP;
# over all rows it is logged.
K3_RAGGED = 37            # rows cut from the mapping shape for the ragged check
# small ragged row counts, where the masked last tile carries all (27) or
# a third (91 = 64 + 27) of each weight and bias gradient's sum
K3_SMALL = (27, 91)
# decoder_wgrad (K3's second pass) against decoder_wgrad_plain on identical
# bf16 operands: both sum the same products in f32, in another order, over
# a chunk of rows whose terms cancel, so each output's error over its
# largest magnitude reads up to ~1.1e-4 (the first chip run of the pass, at
# width 1024 on 65,536 rows); held at 1e-3, still 10x inside K3's
# TOL_GRAD_REL, while a wrong row, column or tile of an operand moves an
# output by O(1) of it
TOL_WGRAD = 1e-3
# the sizes of wgrad_check: one of each plan of pass 1 (resident, streamed,
# wide, parked) at in_dim 16, the kernel phase's inputs; each on the first
# chunk of the mapping shape's rows, as K3 splits it (all 327,680 rows at
# (16, 128, 128): splits of ~189 row tiles)
WGRAD_SIZES = ((16, 128, 128), (16, 256, 128), (16, 512, 512),
               (16, 1024, 1024))
# K2-f32 and K3-f32 (3xTF32 products, each within a few f32 ulps of the
# true product, summed in another order than the plain version's f32
# matmuls; tests/test_torch_tf32x3.py emulates that arithmetic and finds
# it >= 10x inside both tolerances, one-product TF32 outside them; K3-f32
# recomputes the forward, and so its ReLU masks, with FFMA): the forward at
# 1e-5 of each output column's largest magnitude (the f32 CPU parity
# tolerance of tests/test_torch_mlp_kernel.py); the backward at 1e-4 of each
# output's largest magnitude: its weight gradients are f32 sums over up to
# 327,680 rows, whose rounding grows ~sqrt(rows) x 6e-8 relative (~3e-5 at
# the mapping shape) in either summation order. An f32 rounding-level
# difference can still flip a ReLU mask where a hidden pre-activation is
# within ~1e-7 of 0 (the bf16 forms' 1e-2 allows for that); the log counts
# such rows.
TOL_F32_FWD = 1e-5
TOL_F32_BWD = 1e-4
# decoder_wgrad_f32 (K3-f32's second pass) against decoder_wgrad_plain on
# identical f32 operands at WGRAD_SIZES: 3xTF32 products (each within a few
# f32 ulps of the true one) summed in another order than cuBLAS's f32
# matmuls over a chunk of up to 327,680 rows whose terms cancel (<= 3.3e-6
# of each output's largest magnitude on an H100); held at TOL_F32_BWD, the
# tolerance K3-f32's gradients meet whole, while a wrong row, column or
# tile of an operand moves an output by O(1) of it
TOL_WGRAD_F32 = TOL_F32_BWD
# K2-f32's sdf column is a dot of W hidden values with ws[:, SD] whose
# terms can nearly cancel: on an H100 at (32, 512, 384) on the pcd features
# its largest magnitude is small against the terms', and K2-f32 and its
# plain version (cuBLAS) each sum them with f32 rounding in their own
# order, 2.0e-5 of the column's largest magnitude apart. So where K2-f32
# misses TOL_F32_FWD against its plain version, both are held against the
# same forward in float64 (the f32 params and inputs, exact sums): the
# kernel must be within TOL_F32_FWD of each column's largest magnitude
# there (``_k2_check``).
# K3-f32 at the streamed f32 plan's sizes (mlp_stream_f32.cu): its FFMA
# forward recompute sums each output in sequence, the plain version's f32
# matmuls (cuBLAS) in their own order, so where a hidden pre-activation is
# within ~1e-6 of 0 the two can take different ReLU masks and that row's dx
# differs by a whole term (on an H100, on rows of margin < 1e-6: up to
# 5.3e-3 of dx's largest magnitude at (16, 256, 128) on N(0, 0.09) inputs,
# 8.9e-3 at (16, 128, 64) on the pcd features; every row of margin >= 1e-6
# within 4.1e-6). A weight gradient sums its rows' terms, which the random
# cotangents make a random walk, so one flipped row moves it by ~1/sqrt(N)
# of its largest magnitude: 5.1e-4 in wc_f, wc_x and bc at (16, 128, 64).
# So there dx is held at TOL_F32_BWD on the rows at or above
# MARGIN_FLIP_F32, the rows whose dx misses it may be at most
# TOL_FLIP_SHARE of all (as the bf16 forms' dx at MARGIN_FLIP), and every
# weight and bias gradient is held at TOL_F32_BWD on a second launch over
# the rows at or above MARGIN_FLIP_F32. Over all rows each gradient is
# held at TOL_F32_BWD of its largest magnitude plus what the rows whose dx
# missed move it by (kernel against plain version on those rows alone),
# and each such row must be a witnessed mask flip (_f64_mask_witness):
# the kernel's dx and gradients there are, within TOL_F32_BWD, the exact
# (float64) ones under ReLU masks that differ from the true ones only on
# units whose pre-activation is within f32 rounding of 0. What those rows
# move a gradient by is the float64 difference of their terms under the
# kernel's masks and under the plain version's (found from its dx in the
# same launch: cuBLAS rounds a row otherwise in a launch of one row).
MARGIN_FLIP_F32 = 1e-6
# the witness enumerates the masks of at most this many such units a row
WITNESS_UNITS = 8
# and takes at most this many rows whose dx missed (more fail the check)
WITNESS_ROWS = 64
# decoder sizes no kernel is built for, which the kernels take zero-padded
# to mlp_kernel.built_size: in_dim 8, a width that is no multiple of 64
# (on the resident (16, 128, 128) kernels), sdf_dim > width, a size that
# lands on the streamed (16, 256, 256), in_dim 24 and 20, padded to 32
# on a streamed width-256 size and on the smallest, (32, 64, 64), and the
# wide plan's: (16, 300, 200) to (16, 384, 256), (24, 450, 500) to (32,
# 512, 512), and sdf_dim > width, (16, 64, 320) to (16, 384, 384); and
# in_dim 33 to 63 padded to 64: (33, 64, 64) to the smallest in_dim-64
# size, (48, 256, 128) to the vox-d64 slice's, (40, 300, 200) to (64,
# 384, 256); and in_dim 65 to 127 padded to 128: (65, 64, 64) to the
# smallest in_dim-128 size, (100, 256, 128) to the vox-d128 slice's, (96,
# 300, 200) to (128, 512, 256), and sdf_dim > width, (72, 64, 320), to
# (128, 512, 512); and above 512 the parked sizes': (16, 700, 200) to
# (16, 768, 256) and (40, 900, 1000) to (128, 1024, 1024)
PAD_SIZES = ((8, 40, 24), (16, 100, 72), (16, 128, 192), (12, 200, 256),
             (24, 200, 72), (20, 64, 64), (16, 300, 200), (24, 450, 500),
             (16, 64, 320), (33, 64, 64), (48, 256, 128), (40, 300, 200),
             (65, 64, 64), (100, 256, 128), (96, 300, 200), (72, 64, 320),
             (16, 700, 200), (40, 900, 1000))
K1_RAGGED = (1001, 40)    # rays x samples of K1's ragged check (40,040 rows)
TRACK_RAYS = 1024         # the tracking shape: 1024 rays x S samples
ATE_LIMIT_CM = 3.0
# the slices' ATE bounds missed in this run (slice_phase), raised at the end
ATE_MISSES = []
# the mesh: accuracy and completion each under half the 20 cm voxel
MESH_LIMIT_CM = 10.0
MESH_RES = 8
# the cli phase: the larger of the verify skill's 3 cm "something is
# broken" line and 1.5x the JAX CLI's ATE on the same command (0.666 cm,
# a CPU run of scripts/run_slam.py configs/synthetic/room.yaml)
CLI_ATE_LIMIT_CM = max(3.0, 1.5 * 0.666)
CLI_CONFIG = os.path.join("configs", "synthetic", "room.yaml")
PCD_ATE_LIMIT_CM = 60.0
# pcd-f32-w256 (the pcd slice at (16, 256, 128), f32 operands): the bound
# is set from the spread of this run's ATE over the engine's seeds on an
# H100 (700 W; scripts/torch_pcd_w256.py seeds): with K2-f32 / K3-f32
# 17.5-88.5 cm over seeds 0-23 (median 52.1), with their plain versions
# 20.0-94.2 (median 54.9; the two sets are one distribution, Mann-Whitney
# p = 0.81), unfused 11.1-98.5 over seeds 0-7, while a camera that never
# moves reads 2.6 cm. The 60 cm of the width-128 slices is missed by 9 of
# the kernels' 24 seeds and 7 of the plain versions' (seed 0, this run's:
# 72.9 and 58.9), so 60 cm cannot tell a broken kernel from the branch's
# drift here; 100 cm lies above all 56 runs and holds the slice to the
# range correct decoders reach. The kernels themselves are held on the
# slice's trained decoder (trained_decoder_check).
PCD_W256_ATE_LIMIT_CM = 100.0
N_FRAMES = 40
PCD_FRAMES = 5
RESAMPLE_FRAMES = 10
# the cli phase: room.yaml's first CLI_FRAMES of its 40 frames (cut to
# keep the script inside its time budget with the in_dim-64 sizes), panels
# at frames 4 and 9
CLI_FRAMES = 10
CLI_RENDER_FREQ = 5
PANEL_WH = (3 * 200, 2 * 160)   # room.yaml's default 200x160 preview
PCD_CLI_FRAMES = 5
# the vox-w256 slice: the bench configuration with the reference's wider
# decoder (SURVEY.md: decoder_specs at width 256, sdf_dim 128), which runs
# the streamed plan of K1 and K3
W256_SIZE = (16, 256, 128)
W256_FRAMES = 5
# the vox-d32 and pcd-f32-d32 slices: the reference's wider decoder at the
# per-point feature width of voxel- and plane-feature SLAM systems
# (NICE-SLAM's and ESLAM's c_dim 32), embeddings of as many values
D32_SIZE = (32, 256, 128)
D32_FRAMES = 5
# the vox-w512 slice: twice the reference's widest decoder and the width
# of DeepSDF's SDF MLP (fully connected layers of 512),
# on the wide plan of K1 and K3; pcd-f32-w512 the f32 forms' wide plan at
# sdf_dim 256. vox-w512 runs the vox slice's 40 frames: at seed 0 the
# tracker loses frame 3 (~9 cm) with K3's kernels and with its plain
# version alike, so over 5 or 10 frames that one frame decides the ATE
# (4.90 / 3.63 cm, plain 5.11 / 3.80) and the 3 cm bound cannot tell a
# broken wide plan from that; over 40 frames the two read 1.98 and 2.05
# cm (H100, 700 W; scripts/torch_slice_seeds.py --frames=40)
W512_SIZE = (16, 512, 512)
PCD_W512_SIZE = (16, 512, 256)
W512_FRAMES = N_FRAMES
# the vox-d64 and pcd-f32-d64 slices: the reference's wider decoder on 64
# features a point, as NICE-SLAM's fine-level decoder takes them: its
# middle- and fine-grid features concatenated, 2 x c_dim (NICE-SLAM's
# src/conv_onet/models/decoder.py: fine_decoder = MLP(name='fine', ...,
# c_dim=c_dim*2, ..., concat_feature=True); configs/nice_slam.yaml:
# model: c_dim: 32); embeddings of as many values
D64_SIZE = (64, 256, 128)
D64_FRAMES = 5
# the vox-d128 and pcd-f32-d128 slices: the reference's wider decoder on
# 128 features a point, the most a multiresolution hash encoding gives
# (tiny-cuda-nn's HashGrid at 16 levels x 8 features a level, its largest
# n_features_per_level); embeddings of as many values
D128_SIZE = (128, 256, 128)
D128_FRAMES = 5
# the vox-w1024 slice: the widest built decoder, the end of the sizes the
# port takes (width and sdf_dim 1024), on the parked plan of K1 and K3
W1024_SIZE = (16, 1024, 1024)
W1024_FRAMES = 10
# the sizes whose size_phase and f32_size_phase run in full: five slice
# sizes, the width-256 one at in_dim 16 and 128, the wide ones and the
# widest; the others (the in_dim-32 and -64 slice sizes among them since
# in_dim 128 came) run reduced (checks at the tracking shape and a ragged
# count; the kernels, plain versions and chains timed at both shapes at
# the parked sizes, the kernels at the tracking shape only at the older
# ones, whose other times PERF.md keeps from the run that measured them:
# size_timing), which keeps the script inside its time budget with 62
# sizes
FULL_SIZES = {W256_SIZE, D128_SIZE, W512_SIZE, PCD_W512_SIZE, W1024_SIZE}


# a reduced size's kernels at the mapping shape: the median of 3 event
# pairs of 5 calls each (the default: 5 of 10)
REDUCED_REPS = dict(reps=3, calls=5)


def full_size(size) -> bool:
    """True where the size phases run in full (FULL_SIZES' note)."""
    return tuple(size) in FULL_SIZES


# a parked size's kernels and yardsticks at the mapping shape, whose calls
# take 0.005-0.5 s there: the median of 3 event pairs of 2 calls each
PARK_REPS = dict(reps=3, calls=2)


def size_timing(size, full) -> dict:
    """How the size phases time at ``size`` -> {shape: (the kernels'
    ``_event_ms`` arguments, the plain versions' and chains', or None where
    those are not timed)}. In full, both shapes at the phases' own counts;
    at a parked size both shapes, REDUCED_REPS at the tracking shape and
    PARK_REPS at the mapping one, the plain versions and chains at the
    tracking shape (and at the mapping one in full); at the other reduced
    sizes the kernels at the tracking shape, REDUCED_REPS, and no plain
    version or chain: those run no code of the kernels, and PERF.md keeps
    their times from the run that measured them (FULL_SIZES' note)."""
    from proudslam_tpu_torch.ops.kernels.mlp_kernel import parked

    if parked(size):
        return {"mapping": (PARK_REPS, PARK_REPS if full else None),
                "tracking": (REDUCED_REPS, REDUCED_REPS)}
    if full:
        return {"mapping": ({}, {}), "tracking": ({}, {})}
    return {"tracking": (REDUCED_REPS, None)}
# the vox profile: frames 5-6 (two, for the time budget)
PROFILE_START, PROFILE_FRAMES = 5, 2
# the dda slice's frames (half the vox slice's, for the time budget)
DDA_FRAMES = 20
WIDTH, HEIGHT = 320, 240
# the dda slice's intersection check, on its final map (tests/test_intersect
# .py's rule): every brute hit the grid march misses is a graze, a voxel
# whose chord is under the march spacing; the depths of the hits both find
# agree within 1e-4. The march skips a chord c < spacing with probability
# 1 - c / spacing when its phase is random; on the room's surface map ~28%
# of the brute hits have such chords, and the JAX package's DDA misses
# 14.6% of them there (a CPU run, 1024 rays, the port's DDA slot for slot
# the same), against 2% of the slots on the JAX test's random map. So the
# grazes are held to within 15% of that expectation (~4.7 standard
# deviations at the tracking shape): a march at another spacing, or one
# that skips cells, leaves the band; their share of the hit slots is logged.
TOL_DDA_DEPTH = 1e-4
DDA_GRAZE_BAND = 0.15
# gather_ray_features (GatherF8 gather, segment-sum backward) against the
# one-hot einsum oracle: the same f32 products summed in another order
TOL_ONEHOT = 1e-5
# decoder_values with the Gaussian embedder, card against CPU, f32 operands:
# x @ B reaches |x @ B| ~ 50 at these inputs (B ~ 25 N(0, 1)), where the
# f32 sums' order moves the sine by up to ~6e-5; the outputs, 3e-6 of their
# largest magnitude from an f64 evaluation (a CPU run), are held at 1e-5.
# TF32 (1e-3 relative) would move the sine's argument by ~0.05.
TOL_GAUSSIAN = 1e-5
GAUSSIAN_ROWS = 65536
# the window slice: covisibility-weighted windows at keyframe_gap 2 (a
# commit every 3rd frame, so more than window_size = 4 keyframes exist
# from frame 13 on); at least WINDOW_MIN_DRAWS windows must be drawn by the
# covisibility rule
WINDOW_FRAMES = 30
WINDOW_GAP = 2
WINDOW_ANGLE = 30.0
WINDOW_MIN_DRAWS = 12
CLI_EMBED_FRAMES = 5      # (the time budget)
# the parallel phase: the vox engine on a (1, 1) mesh over NCCL, on the
# first PARALLEL_FRAMES frames. One rank's collectives are identities and
# the engine's kernels and reductions are deterministic, so its trajectory
# is expected to equal the plain engine's; it is held at the JAX dry run's
# 5 mm mesh-against-single bound (the equality is logged).
PARALLEL_FRAMES = 5       # (the time budget)
PARALLEL_TRAJ_TOL_M = 5e-3
# the Schur step against its dense joint solve (tests/test_schur.py)
SCHUR_DAMPING = 1e-3
SCHUR_RTOL = 1e-5
SCHUR_ATOL = 5e-4

# Published H100 SXM peaks (dense) at a 700 W power limit: bf16 and TF32
# tensor cores, f32 outside the tensor cores, HBM3.
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# flops per decoder row (16-128-128-(128+1)-128-3; bf16 operands): the
# five products 2*(16*128 + 128*128 + 128*129 + 128*128 + 16*128) plus
# the color head 2*128*3
DEC_FLOPS = 2 * (16 * 128 + 128 * 128 + 128 * 129 + 128 * 128 + 16 * 128
                 + 128 * 3)


def dec_flops(size) -> int:
    """DEC_FLOPS at a decoder size (in_dim, width, sdf_dim): d-w-w-(sd+1)
    -w-3 with the color head's x part."""
    d, w, sd = size
    return 2 * (d * w + w * w + w * (sd + 1) + sd * w + d * w + w * 3)


def k1_blend_flops(d: int) -> int:
    """K1's blend per sample on the FP32 units at in_dim d: 8 corners x d
    dims x (mul, add) plus the 8 weights."""
    return 2 * 8 * d + 8 * 2
# (library, kernel function): each must hold HGMMA (wgmma), no HMMA and no
# spills
KERNEL_FUNCTIONS = (("render_kernel", "render_forward_kernel"),
                    ("mlp_kernel", "decoder_forward_kernel"),
                    ("mlp_kernel", "decoder_backward_kernel"))
# (library, kernel function) of the f32-operand forms: 3xTF32 on
# ``mma.sync`` (HMMA), no HGMMA, no spills
F32_FUNCTIONS = (("mlp_kernel_f32", "decoder_forward_f32_kernel"),
                 ("mlp_kernel_f32", "decoder_backward_f32_kernel"))
LIBRARIES = ("render_kernel", "mlp_kernel", "mlp_kernel_f32")
# K3's second pass: one library for every decoder size (its sizes are
# run-time arguments), and its kernel function (HGMMA, no HMMA, no spills)
WGRAD_LIBRARY = ("mlp_wgrad", None)
WGRAD_FUNCTION = "decoder_wgrad_kernel"
# K3-f32's second pass: one library for every decoder size, its kernel
# function (HMMA: 3xTF32 on mma.sync; no HGMMA, no spills)
WGRAD_F32_LIBRARY = ("mlp_wgrad_f32", None)
WGRAD_F32_FUNCTION = "decoder_wgrad_f32_kernel"
# the kernels' sources at every other decoder size of mlp_kernel.BUILT_SIZES
# (the streamed plans up to width 256 and in_dim 64, the wide ones above and
# at in_dim 128, mlp_kernel.wide_plan, the parked ones at widths 768 and
# 1024, mlp_kernel.parked; the f32 forms' streamed source takes all), one
# library per size; their kernel
# functions carry KERNEL_FUNCTIONS' and F32_FUNCTIONS' names
STREAM_LIBRARIES = {"render_kernel": "render_stream",
                    "mlp_kernel": "mlp_stream",
                    "mlp_kernel_f32": "mlp_stream_f32"}
WIDE_LIBRARIES = {"render_kernel": "render_wide", "mlp_kernel": "mlp_wide",
                  "mlp_kernel_f32": "mlp_stream_f32"}
PARK_LIBRARIES = {"render_kernel": "render_park", "mlp_kernel": "mlp_park",
                  "mlp_kernel_f32": "mlp_stream_f32"}


def stream_library(lib: str, size) -> str:
    """The source that builds ``lib``'s kernels at a streamed ``size``."""
    from proudslam_tpu_torch.ops.kernels.mlp_kernel import parked, wide_plan

    if parked(size):
        return PARK_LIBRARIES[lib]
    return (WIDE_LIBRARIES if wide_plan(size) else STREAM_LIBRARIES)[lib]
# the kernels a bf16 vox path launches: K1, K3 and K3's second pass
VOX_KERNELS = ("fused_render_forward", "decoder_backward", "decoder_wgrad")
# the kernels' launch counters, by the name of the kernels JSON line
KERNELS = ("fused_render_forward", "decoder_forward", "decoder_backward",
           "decoder_forward_f32", "decoder_backward_f32", "decoder_wgrad",
           "decoder_wgrad_f32")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return smi


def sass_counts(lib) -> dict:
    """Tensor-core instructions and f32 FMAs per kernel function of a built
    library, from ``cuobjdump -sass``: {function: {"HGMMA": n, "HMMA": n,
    "FFMA": n}} (HGMMA is wgmma, HMMA mma.sync, FFMA an f32 fused
    multiply-add on the FP32 units)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found")
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {lib} failed: "
                           f"{res.stderr.strip()[-300:]}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HGMMA": 0, "HMMA": 0, "FFMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA", "FFMA"):
                if f" {op}." in line or f" {op} " in line:
                    counts[fn][op] += 1
    return counts


def ptxas_resources(log_text: str) -> dict:
    """Registers and spill bytes per function from ``-Xptxas -v`` output:
    {mangled name: {"registers": n, "spill_stores": b, "spill_loads": b}}."""
    import re

    res, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            res.setdefault(fn, {})
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                res[fn]["spill_stores"] = int(m.group(1))
                res[fn]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                res[fn]["registers"] = int(m.group(1))
    return res


def _size_tag(size) -> str:
    return "x".join(str(v) for v in size)


def build_phase():
    """Build the libraries (one nvcc each, all started together): the three
    sources at the bench decoder's size (16, 128, 128) and the three
    streamed (or wide) sources at every other size of
    ``mlp_kernel.BUILT_SIZES``; log the ptxas report and the instruction
    counts -> (seconds, {kernel function: its SASS counts and ptxas
    resources at (16, 128, 128)}, {size tag: {kernel function: the same}}
    at all 62 sizes)."""
    from proudslam_tpu_torch.ops.kernels import build
    from proudslam_tpu_torch.ops.kernels.mlp_kernel import BUILT_SIZES

    streamed_sizes = [size for size in BUILT_SIZES
                      if size != build.DEFAULT_SIZE]
    jobs = [(name, build.DEFAULT_SIZE) for name in LIBRARIES]
    jobs += [(stream_library(lib, size), size) for size in streamed_sizes
             for lib in LIBRARIES]
    jobs += [WGRAD_LIBRARY, WGRAD_F32_LIBRARY]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(build.build, name, size)
                  for name, size in jobs]:
            f.result()
    seconds = time.perf_counter() - t0
    # cuobjdump on every library, several at once (one at a time took
    # ~190 s of the script for the 102 libraries)
    with ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        sass = dict(zip(jobs, pool.map(
            lambda job: sass_counts(build.library_path(job[0], size=job[1])),
            jobs)))
    ptxas = {}
    for name, size in jobs:
        text = build.build_log(name, size)
        if size in (build.DEFAULT_SIZE, None):
            for line in text.splitlines():
                if any(k in line for k in ("registers", "spill", "smem",
                                           "wgmma", "Performance",
                                           "Compiling entry")):
                    log(f"ptxas {name}: {line.strip()}")
        ptxas[name, size] = ptxas_resources(text)
        if size in (build.DEFAULT_SIZE, None):
            log(f"sass {name}: {json.dumps(sass[name, size])}")
    # the bf16 kernels run their products on the tensor cores through
    # wgmma, the f32 ones through mma.sync (3xTF32); none spills
    checks = [(lib, build.DEFAULT_SIZE, fn)
              for lib, fn in KERNEL_FUNCTIONS + F32_FUNCTIONS]
    checks += [(stream_library(lib, size), size, fn)
               for size in streamed_sizes
               for lib, fn in KERNEL_FUNCTIONS + F32_FUNCTIONS]
    checks += [(*WGRAD_LIBRARY, WGRAD_FUNCTION),
               (*WGRAD_F32_LIBRARY, WGRAD_F32_FUNCTION)]
    f32_fns = {fn for _, fn in F32_FUNCTIONS} | {WGRAD_F32_FUNCTION}
    found, by_size = {}, {}
    for lib, size, fn in checks:
        # a kernel function's instances (K3-f32's pass 1: its full and its
        # dx-only form), each held below; the one of most registers logged
        names = sorted(f for f in sass[lib, size] if fn in f)
        entries = [{**sass[lib, size][f], **ptxas[lib, size].get(f, {})}
                   for f in names]
        if not entries or any("registers" not in e for e in entries):
            raise AssertionError(f"{fn}: {len(names)} functions in the "
                                 f"SASS of {lib} at {size}, not each in its "
                                 "ptxas report")
        entry = dict(max(entries, key=lambda e: e["registers"]),
                     functions=len(entries))
        if size is not None:
            by_size.setdefault(_size_tag(size), {})[fn] = entry
        if size in (build.DEFAULT_SIZE, None):
            found[fn] = entry
            log(f"{fn}: {json.dumps(entry)}")
        else:
            log(f"{fn} ({lib} at {size}): {json.dumps(entry)}")
        for e in entries:
            if fn in f32_fns:
                if not (e["HMMA"] > 0 and e["HGMMA"] == 0):
                    raise AssertionError(f"{fn} at {size}: instructions "
                                         f"{e}, expected HMMA > 0, HGMMA 0")
            elif not (e["HGMMA"] > 0 and e["HMMA"] == 0):
                raise AssertionError(f"{fn} at {size}: tensor-core "
                                     f"instructions {e}, expected HGMMA > 0, "
                                     "HMMA 0")
            if e.get("spill_stores", 1) or e.get("spill_loads", 1):
                raise AssertionError(f"{fn} at {size}: spills in the ptxas "
                                     f"report {e}")
    return seconds, found, by_size


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(bf16_flops: float, f32_flops: float, nbytes: int,
           tf32x3_flops: float = 0):
    """(bound_ms, bound_by): the larger of the operations over their peak
    rates and the bytes (each input read once, each output written once)
    over the memory rate. ``f32_flops`` run on the FP32 units,
    ``tf32x3_flops`` are f32 products on the tensor cores as three TF32
    products each."""
    ops_ms = (bf16_flops / PEAK_BF16 + f32_flops / PEAK_F32
              + 3 * tf32x3_flops / PEAK_TF32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def _event_ms(fn, reps: int = 5, calls: int = 10) -> float:
    """Time of one call: the median over ``reps`` of the CUDA-event time
    of ``calls`` back-to-back calls, divided by ``calls``, after a warm-up
    call. The host issues a call while the card runs the one before, so a
    call's host time (a kernel wrapper's Python before its launch) is
    hidden wherever the card's time per call exceeds it; with
    ``calls=1`` the card waits for it, and it is counted."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return float(np.median(times))


def _scene():
    from proudslam_tpu_torch.data.synthetic import AnalyticScene, orbit_poses

    # the bench's 480-frame "scan" trajectory (BenchDataset, trajectory
    # "scan", radius 1.6): ~1 cm and up to ~1.3 deg of motion per frame
    poses = orbit_poses(480, radius=1.6, total_yaw=np.pi, yaw_wobble=1.0,
                        yaw_cycles=3.0, pitch_wobble=0.22, pitch_cycles=4.0)
    fx = fy = 0.9 * WIDTH
    cx, cy = (WIDTH - 1) / 2.0, (HEIGHT - 1) / 2.0
    return AnalyticScene(), poses, (fx, fy, cx, cy)


def kernel_inputs(device, dims=None):
    """Mapping-shaped inputs of all three kernels from the real pipeline:
    frame 0 of the scan inserted into a bench-capacity map (and its points
    into a point store), 5x1024 rays of that frame intersected and sampled
    (S=64, H=12). ``rb_by_dim[d]``: the hit slots' corner features at each
    in_dim d of ``dims`` (default ``mlp_kernel.BUILT_IN_DIMS``; embeddings
    of d columns from a seed on the same map and samples; ``rb`` is in_dim
    16's), ``pcd_args_by_dim[d]``: the pcd gather's arguments with a
    PointNet of output width d."""
    import torch

    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.geometry import camera, se3
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.models.pointnet import init_pointnet
    from proudslam_tpu_torch.ops import voxel_hash as vh
    from proudslam_tpu_torch.ops.interp import corner_view
    from proudslam_tpu_torch.ops.kernels.mlp_kernel import pack_params
    from proudslam_tpu_torch.render.pcd_features import (init_point_store,
                                                         insert_frame_points)
    from proudslam_tpu_torch.render.renderer import intersect_and_sample

    s = bench_settings()
    scene, poses, K = _scene()
    rgb, depth = scene.render(poses[0], WIDTH, HEIGHT, *K)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    ms = vh.init_map_state(s.map, gen, device)
    pose6 = se3.tangent_from_matrix(torch.as_tensor(poses[0], dtype=torch.float32,
                                                    device=device))
    dirs = camera.pixel_ray_directions(WIDTH, HEIGHT, *K, device=device)
    d = torch.as_tensor(depth, device=device)
    R = se3.exp_rotation(pose6[3:6])
    pts = camera.transform_points(camera.backproject(dirs, d).reshape(-1, 3),
                                  R, pose6[0:3])
    valid_px = (d > 0).reshape(-1)
    ms = vh.insert_points(ms, pts, valid_px, s.map)
    store = insert_frame_points(
        init_point_store(s.map, s.map.points_per_voxel, device), ms, pts,
        torch.as_tensor(rgb, dtype=torch.float32, device=device).reshape(-1, 3),
        valid_px, s.map)
    nv = ms.num_voxels
    view = ms._replace(voxel_keys=ms.voxel_keys[:nv],
                       voxel_vertex_ids=ms.voxel_vertex_ids[:nv])
    n_rays = 5 * s.mapper.n_rays_each
    pix = torch.randint(0, WIDTH * HEIGHT, (n_rays,), generator=gen,
                        device=device)
    rd = dirs.reshape(-1, 3)[pix] @ R.T
    ro = pose6[0:3].expand_as(rd).contiguous()
    noise = torch.rand((n_rays, s.render.max_samples - s.render.max_hits),
                       generator=gen, device=device)
    inter, samples = intersect_and_sample(ro, rd, view, s.render, noise)
    # trained-map-scale embeddings (the init's N(0, 0.01) barely moves
    # the decoder)
    emb = 0.5 * torch.randn(ms.embeddings.shape, generator=gen,
                            device=device)
    vidx = inter.voxel_idx.clamp_min(0).long()
    rb = corner_view(emb, view.voxel_vertex_ids)[vidx].contiguous()
    rb_by_dim = {s.decoder.in_dim: rb}
    keys_rb = view.voxel_keys[vidx].contiguous()
    valid = samples.voxel_idx >= 0
    bins = torch.where(valid, samples.bin, s.render.max_hits).to(torch.int32)
    dec = init_decoder(gen, s.decoder, device)
    fp = pack_params(dec, s.decoder)
    fp = type(fp)(*[t.contiguous() for t in fp])
    # PointNet with its head at the default-init scale (x50 the init's
    # 0.02); its features are still small (rms ~0.07), so K2 is also held
    # on K1's trilinear features (rms ~0.5)
    pn = init_pointnet(gen, s.decoder.in_dim, device)
    pn["fc"] = {k: v * 50.0 for k, v in pn["fc"].items()}
    sampled_xyz = ro[:, None, :] + rd[:, None, :] * samples.depth[..., None]
    pcd_args = (sampled_xyz, samples.bin, inter.voxel_idx, store, pn,
                s.render.voxel_size)
    pcd_args_by_dim = {s.decoder.in_dim: pcd_args}
    # the other built in_dims: embeddings and a PointNet of that width from
    # a seed of their own (``gen`` goes on to draw the kernel phase's
    # cotangents), on the same map, rays and samples
    if dims is None:
        from proudslam_tpu_torch.ops.kernels.mlp_kernel import BUILT_IN_DIMS
        dims = BUILT_IN_DIMS
    gen_d = torch.Generator(device=device)
    gen_d.manual_seed(7)
    for dim in dims:
        if dim in rb_by_dim:
            continue
        emb_d = 0.5 * torch.randn((ms.embeddings.shape[0], dim),
                                  generator=gen_d, device=device)
        rb_by_dim[dim] = corner_view(emb_d, view.voxel_vertex_ids)[vidx]
        pn_d = init_pointnet(gen_d, dim, device)
        pn_d["fc"] = {k: v * 50.0 for k, v in pn_d["fc"].items()}
        pcd_args_by_dim[dim] = pcd_args[:4] + (pn_d,) + pcd_args[5:]
    gt_c = torch.as_tensor(rgb, device=device).reshape(-1, 3)[pix]
    return dict(rb=rb, keys_rb=keys_rb, bins=bins.contiguous(),
                z=samples.depth.contiguous(), rays_o=ro, rays_d=rd.contiguous(),
                fp=fp, voxel=s.render.voxel_size, valid=valid, nv=nv,
                gen=gen, pcd_args=pcd_args, rb_by_dim=rb_by_dim,
                pcd_args_by_dim=pcd_args_by_dim,
                points=int(store.counts.sum()),
                render=dict(settings=s, view=view, store=store, dec=dec, pn=pn,
                            precomputed=(inter, samples), gt_c=gt_c,
                            gt_d=d.reshape(-1)[pix]))


def _matmul_chain(fp, dtype=None):
    """The decoder as a chain of ``torch.matmul`` calls with weight leaves
    of ``dtype`` (bf16 by default; f32 runs with TF32 off, as the package
    sets it): the yardstick for K2 (forward) and K3 (forward and its
    autograd backward) and their f32 forms. No single PyTorch call computes
    either."""
    import torch

    dtype = torch.bfloat16 if dtype is None else dtype
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 yardstick must run with TF32 off")
    w = {k: v.detach().to(dtype, copy=True).requires_grad_(True)
         for k, v in fp._asdict().items()}

    def fwd(x):
        h1 = torch.relu(x @ w["w1"] + w["b1"])
        h2 = torch.relu(h1 @ w["w2"] + w["b2"])
        so = h2 @ w["ws"] + w["bs"]
        hc = torch.relu(so[:, :-1] @ w["wc_f"] + x @ w["wc_x"] + w["bc"])
        return torch.cat([torch.sigmoid(hc @ w["wo"] + w["bo"]), so[:, -1:]],
                         dim=1)
    return fwd, list(w.values())


def _margins(mk, x, fp, bf16=True):
    """Each row's margin: its smallest |hidden pre-activation| (h1, h2, hc)
    in the plain forward."""
    import torch

    dot = mk._make_dot(bf16)
    h1, _, feat, _, _, _ = mk.decoder_fwd_plain(x, fp, bf16)
    pre = (dot(x, fp.w1) + fp.b1, dot(h1, fp.w2) + fp.b2,
           dot(feat, fp.wc_f) + dot(x, fp.wc_x) + fp.bc)
    return torch.stack([p.abs().amin(1) for p in pre]).amin(0)


def _dx_err_by_margin(mk, x, fp, dx_k, dx_p, bf16=True) -> dict:
    """K3's dx error against its plain version's, over dx's largest
    magnitude, binned by each row's margin (:func:`_margins`). Where the
    margin is within the kernel's rounding-level difference, the two can
    take different ReLU masks -> {bin: [rows, max error]}."""
    margin = _margins(mk, x, fp, bf16)
    err = (dx_k - dx_p).abs().amax(1) / dx_p.abs().max().clamp_min(1e-30)
    edges = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, float("inf"))
    bins = {}
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (margin >= lo) & (margin < hi)
        bins[f"[{lo:g}, {hi:g})"] = [
            int(sel.sum()), float(err[sel].max()) if bool(sel.any()) else 0.0]
    return bins


def _f64_decoder(x, g, fp, force=()):
    """The decoder forward and backward in float64 on rows ``x`` (B, D),
    ``g`` (B, 4) with params ``fp`` (float64), each ReLU mask the sign of
    its pre-activation except where ``force`` sets it: (layer, unit, bits)
    with layer 0 (h1), 1 (h2) or 2 (hc) and ``bits`` (B,) the mask of that
    unit in each row -> (pre-activations (pre1, pre2, prec), dx, the
    per-row gradients as a FusedParams of (B, *shape) tensors)."""
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    def mask(pre, layer):
        m = (pre > 0).to(pre.dtype)
        for lay, unit, bits in force:
            if lay == layer:
                m[:, unit] = bits
        return m

    pre1 = x @ fp.w1 + fp.b1
    m1 = mask(pre1, 0)
    h1 = m1 * pre1
    pre2 = h1 @ fp.w2 + fp.b2
    m2 = mask(pre2, 1)
    h2 = m2 * pre2
    so = h2 @ fp.ws + fp.bs
    feat = so[:, :-1]
    prec = feat @ fp.wc_f + x @ fp.wc_x + fp.bc
    mc = mask(prec, 2)
    hc = mc * prec
    rgb = torch.sigmoid(hc @ fp.wo + fp.bo)
    dzo = g[:, 0:3] * rgb * (1.0 - rgb)
    dhc = (dzo @ fp.wo.T) * mc
    dso = torch.cat([dhc @ fp.wc_f.T, g[:, 3:4]], dim=1)
    dh2 = (dso @ fp.ws.T) * m2
    dh1 = (dh2 @ fp.w2.T) * m1
    dx = dh1 @ fp.w1.T + dhc @ fp.wc_x.T
    outer = lambda a, b: a[:, :, None] * b[:, None, :]  # noqa: E731
    grads = mk.FusedParams(
        w1=outer(x, dh1), b1=dh1[:, None], w2=outer(h1, dh2), b2=dh2[:, None],
        ws=outer(h2, dso), bs=dso[:, None], wc_f=outer(feat, dhc),
        wc_x=outer(x, dhc), bc=dhc[:, None], wo=outer(hc, dzo),
        bo=dzo[:, None])
    return (pre1, pre2, prec), dx, grads


def _f32_rounding_bounds(x, fp, pre):
    """For each hidden pre-activation of the rows ``x`` (float64, exact
    f32 values; ``pre`` from :func:`_f64_decoder`), a bound on how far an
    f32 evaluation of it in any summation order, with or without fused
    multiply-adds, can lie from the exact value: gamma(n) = n u / (1 - n u),
    u = 2^-24, times the sum of the n terms' magnitudes (Higham, Accuracy
    and Stability of Numerical Algorithms, (3.5)), plus the bounds of the
    layer's inputs carried through |w| (a ReLU moves no value by more than
    its input's error) -> (E1, E2, Ec) in ``pre``'s shapes."""
    import torch

    u = 2.0 ** -24

    def gamma(n):
        return n * u / (1 - n * u)

    d, w = fp.w1.shape
    sd = fp.wc_f.shape[0]
    a = lambda t: t.abs()  # noqa: E731
    pre1, pre2, _ = pre
    h1 = torch.relu(pre1)
    e1 = gamma(d + 1) * (a(x) @ a(fp.w1) + a(fp.b1))
    e2 = (gamma(w + 1) * ((h1 + e1) @ a(fp.w2) + a(fp.b2))
          + e1 @ a(fp.w2))
    h2 = torch.relu(pre2)
    wsf, bsf = fp.ws[:, :-1], fp.bs[:, :-1]
    feat = h2 @ wsf + bsf
    ef = gamma(w + 1) * ((h2 + e2) @ a(wsf) + a(bsf)) + e2 @ a(wsf)
    ec = (gamma(sd + d + 1) * ((a(feat) + ef) @ a(fp.wc_f)
                               + a(x) @ a(fp.wc_x) + a(fp.bc))
          + ef @ a(fp.wc_f))
    return e1, e2, ec


def _f64_mask_witness(what, xn, gn, fp, rows, dx_k, dx_p, wgrad, tol):
    """The float64 witness on the rows whose dx missed ``tol`` (``rows``):
    each row's hidden units within f32 rounding of 0
    (:func:`_f32_rounding_bounds`; at most WITNESS_UNITS, the closest) are
    ambiguous, and every assignment of their masks gives an exact float64
    dx and gradients (:func:`_f64_decoder`). The kernel's dx in the full
    launch (``dx_k``) and, if ``wgrad``, its dx and gradients on that row
    alone must each be within ``tol`` of one assignment's (dx over dx_p's
    largest magnitude, each gradient over its own largest): its mask
    differs from the true one only where rounding allows. The plain
    version's assignment is the one nearest its dx in the full launch
    (``dx_p``). Logs, per row, the ambiguous units (layer, unit,
    pre-activation, bound) and whether the kernel and the plain version
    took the true masks -> ({gradient: largest entry of the summed |terms
    under the kernel's masks - terms under the plain version's|} over the
    rows: what they move each gradient by}, the per-row records). Raises
    if a row is not so explained."""
    import itertools

    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    f64 = mk.FusedParams(*[t.double() for t in fp])
    dx_scale = dx_p.abs().max().clamp_min(1e-30).item()
    records = []
    moved = [torch.zeros(t.shape, dtype=torch.float64, device=t.device)
             for t in f64]
    for r in rows.tolist():
        x = xn[r:r + 1].double()
        g = gn[r:r + 1].double()
        pre, _, _ = _f64_decoder(x, g, f64)
        bounds = _f32_rounding_bounds(x, f64, pre)
        amb = []
        for layer, (p, e) in enumerate(zip(pre, bounds)):
            for unit in (p[0].abs() <= e[0]).nonzero().flatten().tolist():
                amb.append((float(p[0, unit].abs() / e[0, unit]), layer,
                            unit, float(p[0, unit]), float(e[0, unit])))
        amb.sort()
        truncated = len(amb) > WITNESS_UNITS
        amb = amb[:WITNESS_UNITS]
        combos = list(itertools.product((0.0, 1.0), repeat=len(amb)))
        bits = torch.tensor(combos, dtype=torch.float64,
                            device=xn.device).reshape(len(combos), len(amb))
        force = [(layer, unit, bits[:, i])
                 for i, (_, layer, unit, _, _) in enumerate(amb)]
        c = len(combos)
        _, dx64, gr64 = _f64_decoder(x.expand(c, -1), g.expand(c, -1), f64,
                                     force)
        true = tuple(1.0 if p > 0 else 0.0 for _, _, _, p, _ in amb)
        true_i = combos.index(true)

        def dx_err(dx_row):
            return ((dx64 - dx_row.double()).abs().amax(1) / dx_scale)

        err = dx_err(dx_k[r])
        e_plain = dx_err(dx_p[r])
        if wgrad:
            dx1, gr1 = mk.decoder_bwd(xn[r:r + 1].contiguous(),
                                      gn[r:r + 1].contiguous(), fp,
                                      want_wgrad=True, bf16=False)
            err = torch.maximum(err, dx_err(dx1[0]))
            for k64, k in zip(gr64, gr1):
                scale = k64[true_i].abs().max().clamp_min(1e-30)
                err = torch.maximum(err, (k64 - k.double()[None]).abs()
                                    .flatten(1).amax(1) / scale)
        best, best_p = int(err.argmin()), int(e_plain.argmin())
        for acc, k64 in zip(moved, gr64):
            acc += (k64[best] - k64[best_p]).abs()
        rec = {"row": r, "ambiguous": [[lay, u, float(f"{p:.3e}"),
                                        float(f"{e:.3e}")]
                                       for _, lay, u, p, e in amb],
               "truncated": truncated, "kernel_err": float(err[best]),
               "kernel_true_masks": best == true_i,
               "plain_true_masks": best_p == true_i,
               "plain_err": float(e_plain[best_p])}
        records.append(rec)
        if not err[best] <= tol:
            log(f"{what}: float64 witness of row {r}: " + json.dumps(rec))
            raise AssertionError(
                f"{what}: row {r}'s dx missed and no rounding-level mask "
                "flip explains it")
    log(f"{what}: float64 witness of the {len(records)} rows whose dx "
        f"missed {tol} (ambiguous units: [layer 0 h1 | 1 h2 | 2 hc, unit, "
        "exact pre-activation, f32 rounding bound]): " + json.dumps(records))
    return {name: float(m.max()) for name, m in
            zip(mk.FusedParams._fields, moved)}, records


def _k3_check(what, xn, gn, fp, wgrad, bf16, log_bins=False):
    """K3 (``bf16``) or K3-f32 on ``xn``, ``gn`` against its plain version
    at the decoder size of ``fp`` (a size no kernel is built for runs
    padded): every weight and bias gradient within the form's tolerance
    (TOL_GRAD_REL or TOL_F32_BWD) of its largest magnitude, dx within it on
    the rows whose margin (smallest |hidden pre-activation|) is at least
    MARGIN_FLIP (MARGIN_FLIP_F32), and the rows whose dx misses it at most
    TOL_FLIP_SHARE of all (ReLU-mask flips). K3-f32 as the note at
    MARGIN_FLIP_F32 says when a row is below it: its gradients held on a
    second launch over the rows at or above it, over all rows at the
    tolerance plus what the rows whose dx missed account for, and each such
    row witnessed in float64 (:func:`_f64_mask_witness`) -> (largest
    absolute error, {output: error over its largest magnitude}). Raises on
    a miss."""
    import math

    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    tol, margin = ((TOL_GRAD_REL, MARGIN_FLIP) if bf16
                   else (TOL_F32_BWD, MARGIN_FLIP_F32))
    wide_bf16 = bf16 and mk.wide(mk.built_size(mk.params_size(fp)))

    def run(x, g):
        dx_k, gr_k = mk.decoder_bwd(x, g, fp, want_wgrad=wgrad, bf16=bf16)
        dx_p, gr_p = mk.decoder_bwd_plain(x, g, fp, want_wgrad=wgrad,
                                          bf16=bf16)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in [("dx", dx_k, dx_p)] + (list(
                zip(mk.FusedParams._fields, gr_k, gr_p)) if wgrad else []):
            errs[name] = ((a - b).abs().max().item(),
                          max(b.abs().max().item(), 1e-30))
        return dx_k, dx_p, errs

    def rel(errs):
        return {k: float(f"{e / s:.3e}") for k, (e, s) in errs.items()}

    dx_k, dx_p, errs = run(xn, gn)
    rels = rel(errs)
    worst = max(e for e, _ in errs.values())
    row_err = ((dx_k - dx_p).abs().amax(1)
               / dx_p.abs().max().clamp_min(1e-30))
    safe = _margins(mk, xn, fp, bf16) >= margin
    dx_safe = float(row_err[safe].max()) if bool(safe.any()) else 0.0
    missed = (row_err > tol).nonzero().flatten()
    flips = missed.numel() / xn.shape[0]
    log(f"{what}, N={xn.shape[0]}, {'full' if wgrad else 'dx-only'}: "
        f"max_abs_err over each output's largest magnitude "
        f"{json.dumps(rels)}; dx on the {int(safe.sum())} rows of margin >= "
        f"{margin} {dx_safe:.3e} (tol {tol}); share of rows whose dx misses "
        f"{tol}: {flips:.2e} (tol {TOL_FLIP_SHARE})")
    if log_bins:
        log(f"{what}: dx error by the row's smallest |hidden "
            "pre-activation|, {bin: [rows, max_abs_err over dx's largest "
            "magnitude]}: "
            + json.dumps(_dx_err_by_margin(mk, xn, fp, dx_k, dx_p, bf16)))
    moved = {k: 0.0 for k in errs}
    if not bf16 and missed.numel():
        if missed.numel() > WITNESS_ROWS:
            raise AssertionError(
                f"{what}: {missed.numel()} rows' dx missed {tol}, more than "
                f"the {WITNESS_ROWS} the float64 witness takes")
        moved.update(_f64_mask_witness(what, xn, gn, fp, missed, dx_k, dx_p,
                                       wgrad, tol)[0])
    if wgrad and not bf16 and not bool(safe.all()):
        _, _, safe_errs = run(xn[safe].contiguous(), gn[safe].contiguous())
        worst = max(worst, max(e for e, _ in safe_errs.values()))
        safe_rels = rel(safe_errs)
        # over all rows: the tolerance plus what the missed rows move each
        # gradient by (the witness's float64 terms)
        limits = {k: float(f"{tol + moved[k] / s:.3e}")
                  for k, (_, s) in errs.items() if k != "dx"}
        all_ok = all(rels[k] <= limits[k] for k in limits)
        log(f"{what}, full, on the {int(safe.sum())} rows of margin >= "
            f"{margin}: max_abs_err over each output's largest magnitude "
            f"{json.dumps(safe_rels)} (tol {tol}); over all rows "
            f"{json.dumps({k: rels[k] for k in limits})} against "
            f"{json.dumps(limits)} ({tol} plus the {missed.numel()} missed "
            f"rows' terms; missed rows / sqrt(N) "
            f"{missed.numel() / math.sqrt(xn.shape[0]):.2e})")
        grads_ok = all_ok and max(v for k, v in safe_rels.items()
                                  if k != "dx") <= tol
    elif wgrad and wide_bf16 and not bool(safe.all()):
        _, _, safe_errs = run(xn[safe].contiguous(), gn[safe].contiguous())
        safe_rels = rel(safe_errs)
        log(f"{what}, full, on the {int(safe.sum())} rows of margin >= "
            f"{margin}: max_abs_err over each output's largest magnitude "
            f"{json.dumps(safe_rels)} (tol {tol}; over all rows logged "
            "above)")
        grads_ok = max(v for k, v in safe_rels.items() if k != "dx") <= tol
    else:
        grads_ok = max((v for k, v in rels.items() if k != "dx"),
                       default=0.0) <= tol
    if not (grads_ok and dx_safe <= tol and flips <= TOL_FLIP_SHARE):
        raise AssertionError(f"{what} disagrees with decoder_bwd_plain, "
                             f"N={xn.shape[0]}")
    return worst, rels


def _entry(err, ms, plain_ms, bound, chain_ms=None):
    e = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
             bound_by=bound[1], library_ms=None)
    if chain_ms is not None:
        e["matmul_chain_ms"] = chain_ms
    return e


def f32_kernel_phase(x, g, fp, track_rows):
    """K2-f32 and K3-f32 (``bf16=False``) on the pcd features ``x`` and the
    cotangents ``g``: against their plain versions with f32 operands at the
    mapping shape, the tracking shape (the first ``track_rows`` rows), a
    ragged count (a masked last tile) and small ragged counts of non-zero
    rows; repeatability; CUDA-event times of each kernel, its plain version
    and the f32 matmul chain at both shapes, and the bound with every
    decoder flop as a 3xTF32 product on the tensor cores (the kernels'
    bound_ms) beside the one at the FP32 units' peak -> the two kernels'
    JSON entries."""
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    N = x.shape[0]
    size0, sms = mk.params_size(fp), _sms(x.device)
    nz = (x.abs().sum(1) > 0).nonzero().flatten()
    shapes = [("mapping", x, g), ("tracking", x[:track_rows], g[:track_rows]),
              ("ragged", x[:N - K3_RAGGED], g[:N - K3_RAGGED])]
    shapes += [("small ragged", x[nz[:n]], g[nz[:n]]) for n in K3_SMALL]
    err_fwd = 0.0
    for label, xi, _ in shapes:
        xi = xi.contiguous()
        out_k = mk.decoder_fwd(xi, fp, bf16=False)
        _, _, _, sdf_p, _, rgb_p = mk.decoder_fwd_plain(xi, fp, False)
        out_p = torch.cat([rgb_p, sdf_p], dim=1)
        out_k2 = mk.decoder_fwd(xi, fp, bf16=False)
        torch.cuda.synchronize()
        scale = out_p.abs().amax(0).clamp_min(1e-30)
        rel = ((out_k - out_p).abs().amax(0) / scale).tolist()
        # what a kernel reading a neighbouring row would give
        shift = ((out_p[1:] - out_p[:-1]).abs().amax(0) / scale).max().item()
        log(f"K2-f32 at the {label} shape, N={xi.shape[0]}: max_abs_err "
            f"over each column's largest magnitude "
            f"{[float(f'{v:.3e}') for v in rel]} (tol {TOL_F32_FWD}); "
            f"one-row shift {shift:.3e}")
        if not max(rel) <= TOL_F32_FWD:
            raise AssertionError(f"K2-f32 disagrees with decoder_fwd_plain at "
                                 f"the {label} shape")
        big = xi.shape[0] > 2 * K3_SMALL[-1]
        if big and not shift > SHIFT_MARGIN * TOL_F32_FWD:
            raise AssertionError("the K2-f32 check cannot tell neighbouring "
                                 "rows")
        if not torch.equal(out_k, out_k2):
            raise AssertionError("K2-f32 is not bitwise repeatable")
        err_fwd = max(err_fwd, (out_k - out_p).abs().max().item())

    err_bwd = 0.0
    margin_bins = None
    for label, xi, gi in shapes:
        xi, gi = xi.contiguous(), gi.contiguous()
        for wgrad in ((True, False) if label in ("mapping", "tracking")
                      else (True,)):
            dx_k, gr_k = mk.decoder_bwd(xi, gi, fp, want_wgrad=wgrad,
                                        bf16=False)
            dx_p, gr_p = mk.decoder_bwd_plain(xi, gi, fp, want_wgrad=wgrad,
                                              bf16=False)
            torch.cuda.synchronize()
            rels = {}
            for name, a, b in [("dx", dx_k, dx_p)] + (list(
                    zip(mk.FusedParams._fields, gr_k, gr_p)) if wgrad else []):
                e = (a - b).abs().max().item()
                rel = e / max(b.abs().max().item(), 1e-30)
                rels[name] = float(f"{rel:.3e}")
                err_bwd = max(err_bwd, e)
            log(f"K3-f32 at the {label} shape, N={xi.shape[0]}, "
                f"{'full' if wgrad else 'dx-only'}: max_abs_err over each "
                f"output's largest magnitude {json.dumps(rels)} (tol "
                f"{TOL_F32_BWD})")
            if label == "mapping" and wgrad:
                margin_bins = _dx_err_by_margin(mk, xi, fp, dx_k, dx_p,
                                                bf16=False)
                log("K3-f32 dx error at the mapping shape by the row's "
                    "smallest |hidden pre-activation|, {bin: [rows, "
                    "max_abs_err over dx's largest magnitude]}: "
                    + json.dumps(margin_bins))
            if not max(rels.values()) <= TOL_F32_BWD:
                raise AssertionError(
                    f"K3-f32 disagrees with decoder_bwd_plain at the {label} "
                    f"shape, N={xi.shape[0]}")
    dx_k, gr_k = mk.decoder_bwd(x, g, fp, bf16=False)
    dx_k2, gr_k2 = mk.decoder_bwd(x, g, fp, bf16=False)
    dx_only, _ = mk.decoder_bwd(x, g, fp, want_wgrad=False, bf16=False)
    if not (torch.equal(dx_k, dx_k2) and torch.equal(dx_k, dx_only)
            and all(torch.equal(a, b) for a, b in zip(gr_k, gr_k2))):
        raise AssertionError("K3-f32 is not bitwise repeatable")

    chain, leaves = _matmul_chain(fp, torch.float32)
    k2 = {"mapping": dict(rows=N), "tracking": dict(rows=track_rows)}
    k3 = {"mapping": dict(rows=N), "tracking": dict(rows=track_rows)}
    for shape in k2:
        rows = k2[shape]["rows"]
        xn, gn = x[:rows].contiguous(), g[:rows].contiguous()
        st = k2[shape]
        st["ms"] = _event_ms(lambda: mk.decoder_fwd(xn, fp, bf16=False))
        st["plain_ms"] = _event_ms(lambda: mk.decoder_fwd_plain(xn, fp, False))
        with torch.no_grad():
            st["matmul_chain_ms"] = _event_ms(lambda: chain(xn))
        nbytes = _nbytes(xn, *fp) + rows * 4 * 4
        st["bound_ms"], st["bound_by"] = _bound(0, 0, nbytes,
                                                DEC_FLOPS * rows)
        st["fp32_bound_ms"], _ = _bound(0, DEC_FLOPS * rows, nbytes)
        st["share"] = st["bound_ms"] / st["ms"]
        st = k3[shape]
        st["ms"] = _event_ms(lambda: mk.decoder_bwd(xn, gn, fp, bf16=False))
        st["plain_ms"] = _event_ms(
            lambda: mk.decoder_bwd_plain(xn, gn, fp, bf16=False))
        st["dx_only_ms"] = _event_ms(lambda: mk.decoder_bwd(
            xn, gn, fp, want_wgrad=False, bf16=False))
        st["dx_only_plain_ms"] = _event_ms(lambda: mk.decoder_bwd_plain(
            xn, gn, fp, want_wgrad=False, bf16=False))
        nbytes = _nbytes(xn, gn, *fp, xn, *gr_k)
        st["bound_ms"], st["bound_by"] = _bound(0, 0, nbytes,
                                                3 * DEC_FLOPS * rows)
        st["fp32_bound_ms"], _ = _bound(0, 3 * DEC_FLOPS * rows, nbytes)
        nbytes = _nbytes(xn, gn, *fp, xn)
        st["dx_only_bound_ms"], _ = _bound(0, 0, nbytes, 2 * DEC_FLOPS * rows)
        st["dx_only_fp32_bound_ms"], _ = _bound(0, 2 * DEC_FLOPS * rows,
                                                nbytes)
        st["share"] = st["bound_ms"] / st["ms"]
        st["dx_only_share"] = st["dx_only_bound_ms"] / st["dx_only_ms"]
        st["pass1_ms"], st["pass2_ms"] = _k3_pass_ms(xn, gn, fp, {},
                                                     bf16=False)
        st["wgrad_gb"] = _wgrad_gb(size0, rows, sms, bf16=False)
        plan = mk.wgrad_plan(size0, rows, sms, bf16=False)
        # a count from the code, not a measurement (_wgrad_gb)
        log(f"K3-f32 at the {shape} shape: pass 1 in "
            f"{mk.backward_partition(rows, sms)[0]} blocks, pass 2 in "
            f"{plan.tiles} output tiles x {plan.splits} splits of <= "
            f"{plan.per_split} 64-row groups, "
            f"{len(mk.wgrad_chunks(plan, size0, rows, False))} chunk(s); "
            f"pass 1 {st['pass1_ms']:.3f} ms, pass 2 {st['pass2_ms']:.3f} "
            f"ms; bytes of the weight gradients through device memory, "
            f"counted from the code: {json.dumps(st['wgrad_gb'])} GB")
    # decoder_wgrad_f32 on its own at the mapping shape (one K3-f32 call's
    # chunks): its time, its plain version's on the same operands, the five
    # products as f32 torch.matmul calls (TF32 off), its bound (the
    # operands read once, the gradients written once; the products' flops
    # as 3xTF32)
    ops = mk.decoder_bwd_operands_plain(x, g, fp, bf16=False)
    plan = mk.wgrad_plan(size0, N, sms, bf16=False)
    wgrad_ms = k3["mapping"]["pass2_ms"]
    wgrad_plain_ms = _event_ms(lambda: mk.decoder_wgrad_plain(ops, size0,
                                                             plan))
    wgrad_matmul_ms = _wgrad_matmul_ms(ops, size0, bf16=False)
    del ops
    wgrad_bound = _bound(0, 0, _wgrad_bound_bytes(size0, N, bf16=False),
                         2 * N * mk.wgrad_part_floats(size0))
    log(f"decoder_wgrad_f32 at the mapping shape, N={N}: {wgrad_ms:.3f} ms "
        f"(plain {wgrad_plain_ms:.3f} ms, 3xTF32 bound "
        f"{wgrad_bound[0]:.4f} ms by {wgrad_bound[1]}, share "
        f"{wgrad_bound[0] / wgrad_ms:.3f}; its five products as f32 "
        f"torch.matmul calls {wgrad_matmul_ms:.3f} ms)")
    wgrad_sizes = wgrad_check(x.device, x, g, fp, bf16=False)
    xg = x.detach().clone().requires_grad_(True)

    def chain_fwd_bwd():
        for t in leaves + [xg]:
            t.grad = None
        chain(xg).backward(g)
    chain_bwd_ms = _event_ms(chain_fwd_bwd)
    for shape in ("mapping", "tracking"):
        a, b = k2[shape], k3[shape]
        log(f"{shape} shape, f32 operands: K2-f32 {a['ms']:.3f} ms (plain "
            f"{a['plain_ms']:.3f} ms, 3xTF32 bound {a['bound_ms']:.4f} ms by "
            f"{a['bound_by']}, share {a['share']:.3f}, FP32-unit bound "
            f"{a['fp32_bound_ms']:.4f} ms; f32 torch.matmul chain forward "
            f"{a['matmul_chain_ms']:.3f} ms, {a['rows']} rows); K3-f32 "
            f"{b['ms']:.3f} ms (plain {b['plain_ms']:.3f} ms, 3xTF32 bound "
            f"{b['bound_ms']:.4f} ms, share {b['share']:.3f}, FP32-unit "
            f"bound {b['fp32_bound_ms']:.4f} ms); K3-f32 dx-only "
            f"{b['dx_only_ms']:.3f} ms (plain {b['dx_only_plain_ms']:.3f} ms, "
            f"3xTF32 bound {b['dx_only_bound_ms']:.4f} ms, share "
            f"{b['dx_only_share']:.3f}, FP32-unit bound "
            f"{b['dx_only_fp32_bound_ms']:.4f} ms)")
    log(f"f32 torch.matmul chain (a chain of calls, not one library call): "
        f"forward+backward {chain_bwd_ms:.3f} ms at N={N}")
    m2, m3 = k2["mapping"], k3["mapping"]
    return {
        "decoder_forward_f32": dict(
            _entry(err_fwd, m2["ms"], m2["plain_ms"],
                   (m2["bound_ms"], m2["bound_by"]), m2["matmul_chain_ms"]),
            shapes=k2),
        "decoder_backward_f32": dict(
            _entry(err_bwd, m3["ms"], m3["plain_ms"],
                   (m3["bound_ms"], m3["bound_by"]), chain_bwd_ms),
            shapes=k3, dx_err_by_margin=margin_bins),
        "decoder_wgrad_f32": dict(
            _entry(max(st["max_abs_err"] for st in wgrad_sizes.values()),
                   wgrad_ms, wgrad_plain_ms, wgrad_bound),
            matmul_ms=wgrad_matmul_ms, rows=N, checks=wgrad_sizes),
    }


def kernel_phase(device):
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk
    from proudslam_tpu_torch.render.pcd_features import gather_pcd_features

    inp = kernel_inputs(device)
    args = (inp["rb"], inp["keys_rb"], inp["bins"], inp["z"], inp["rays_o"],
            inp["rays_d"], inp["fp"], inp["voxel"])
    R, H, _ = inp["rb"].shape
    S = inp["bins"].shape[1]
    log(f"kernels: K1 at R={R} H={H} S={S} (live voxels {inp['nv']}, "
        f"valid samples {int(inp['valid'].sum())})")
    # K1 against its plain version at the mapping shape, the tracking shape
    # (the first TRACK_RAYS rays) and a ragged last tile: K1_RAGGED =
    # (rays, samples), whose product is no multiple of the 64-row tile
    nr, ns = K1_RAGGED
    k1_args = {
        "mapping": args,
        "tracking": tuple(a[:TRACK_RAYS].contiguous() for a in args[:6])
        + args[6:],
        "ragged": tuple(a[:nr, :ns].contiguous()
                        if a.dim() == 2 and a.shape[1] == S
                        else a[:nr].contiguous() for a in args[:6]) + args[6:]}
    err_feats = err_out = 0.0
    for shape, a in k1_args.items():
        out_k, feats_k = rk.fused_render_forward(*a)
        out_p, feats_p = rk.fused_render_forward_plain(*a)
        torch.cuda.synchronize()
        ef = (feats_k - feats_p).abs().max().item()
        eo = (out_k - out_p).abs().amax(0)
        log(f"K1 at the {shape} shape, {a[2].shape[0]} rays x {a[2].shape[1]}"
            f" samples: feats max_abs_err {ef:.3e} (tol {TOL_FEATS}), out "
            f"max_abs_err per column {[float(f'{v:.3e}') for v in eo.tolist()]}"
            f" (tol {TOL_K1_OUT})")
        if not (ef <= TOL_FEATS and eo.max().item() <= TOL_K1_OUT):
            raise AssertionError(f"K1 disagrees with fused_render_forward_plain"
                                 f" at the {shape} shape")
        err_feats, err_out = max(err_feats, ef), max(err_out, eo.max().item())
        # K2 runs K1's decoder on inputs rounded as K1 rounds its features
        out_2 = mk.decoder_fwd(feats_k, a[6])
        torch.cuda.synchronize()
        same = torch.equal(out_2, out_k)
        log(f"K2 on K1's feats at the {shape} shape: "
            + ("bitwise equal to K1's out" if same else
               f"{int((out_2 != out_k).sum())} values differ from K1's out, "
               f"max_abs_err {(out_2 - out_k).abs().max().item():.3e}"))
        if not same:
            raise AssertionError(f"K2 on K1's feats differs from K1's out at "
                                 f"the {shape} shape")
        if shape == "mapping":
            x = feats_p
            # the same samples' outputs one row off: what a kernel reading a
            # neighbouring row would give
            shift1 = (out_p[1:] - out_p[:-1]).abs().max().item()
    log(f"K1 one-row-shift error {shift1:.3e} (margin {SHIFT_MARGIN})")
    if not shift1 > SHIFT_MARGIN * TOL_K1_OUT:
        raise AssertionError("the K1 check cannot tell neighbouring rows")
    k1 = {"mapping": dict(rows=R * S),
          "tracking": dict(rows=min(TRACK_RAYS, R) * S)}
    for shape, st in k1.items():
        a = k1_args[shape]
        st["ms"] = _event_ms(lambda: rk.fused_render_forward(*a))
        st["plain_ms"] = _event_ms(lambda: rk.fused_render_forward_plain(*a))
        st["bound_ms"], st["bound_by"] = _bound(
            DEC_FLOPS * st["rows"], k1_blend_flops(16) * st["rows"],
            _nbytes(*a[:6], *inp["fp"]) + st["rows"] * (4 + 16) * 4)
        st["share"] = st["bound_ms"] / st["ms"]

    g = 1e-2 * torch.randn((x.shape[0], 4), generator=inp["gen"],
                           device=device)
    fp = inp["fp"]
    N = x.shape[0]
    TR = min(TRACK_RAYS * S, N)
    # K3 against its plain version, full and dx-only, at the mapping and
    # tracking shapes, a ragged mapping shape, and small ragged row counts
    # drawn from the rows with non-zero features
    nz = (x.abs().sum(1) > 0).nonzero().flatten()
    k3_cases = [("mapping", x, g, True), ("mapping", x, g, False),
                ("ragged", x[:N - K3_RAGGED], g[:N - K3_RAGGED], True),
                ("tracking", x[:TR], g[:TR], True),
                ("tracking", x[:TR], g[:TR], False)]
    k3_cases += [("small ragged", x[nz[:n]], g[nz[:n]], True)
                 for n in K3_SMALL]
    worst_abs = 0.0
    for label, xn, gn, wgrad in k3_cases:
        xn, gn = xn.contiguous(), gn.contiguous()
        dx_k, gr_k = mk.decoder_bwd(xn, gn, fp, want_wgrad=wgrad)
        dx_p, gr_p = mk.decoder_bwd_plain(xn, gn, fp, want_wgrad=wgrad)
        torch.cuda.synchronize()
        rels = {}
        for name, a, b in [("dx", dx_k, dx_p)] + (list(
                zip(mk.FusedParams._fields, gr_k, gr_p)) if wgrad else []):
            e = (a - b).abs().max().item()
            rels[name] = float(f"{e / max(b.abs().max().item(), 1e-30):.3e}")
            worst_abs = max(worst_abs, e)
        log(f"K3 at the {label} shape, N={xn.shape[0]}, "
            f"{'full' if wgrad else 'dx-only'}: max_abs_err over each "
            f"output's largest magnitude {json.dumps(rels)} (tol "
            f"{TOL_GRAD_REL})")
        if not max(rels.values()) <= TOL_GRAD_REL:
            raise AssertionError(f"K3 disagrees with decoder_bwd_plain at the "
                                 f"{label} shape, N={xn.shape[0]}")
        if label == "mapping" and wgrad:
            log("K3 dx error at the mapping shape by the row's smallest "
                "|hidden pre-activation|, {bin: [rows, max_abs_err over "
                "dx's largest magnitude]}: "
                + json.dumps(_dx_err_by_margin(mk, xn, fp, dx_k, dx_p)))
    # determinism: the cross-block reduction has a fixed order
    dx_k, gr_k = mk.decoder_bwd(x, g, fp)
    dx_k2, gr_k2 = mk.decoder_bwd(x, g, fp)
    dx_only, _ = mk.decoder_bwd(x, g, fp, want_wgrad=False)
    if not (torch.equal(dx_k, dx_k2) and torch.equal(dx_k, dx_only)
            and all(torch.equal(a, b) for a, b in zip(gr_k, gr_k2))):
        raise AssertionError("K3 is not bitwise repeatable")
    log(f"K3 at the mapping shape, N={N}: two calls' dx and 11 gradients "
        "bitwise equal, and dx-only's dx")
    wgrad_sizes = wgrad_check(device, x, g, fp)
    k3 = {"mapping": dict(rows=N), "tracking": dict(rows=TR)}
    sms = _sms(device)
    size0 = mk.params_size(fp)
    for shape, st in k3.items():
        xn, gn = x[:st["rows"]].contiguous(), g[:st["rows"]].contiguous()
        st["ms"] = _event_ms(lambda: mk.decoder_bwd(xn, gn, fp))
        st["plain_ms"] = _event_ms(lambda: mk.decoder_bwd_plain(xn, gn, fp))
        st["dx_only_ms"] = _event_ms(
            lambda: mk.decoder_bwd(xn, gn, fp, want_wgrad=False))
        st["dx_only_plain_ms"] = _event_ms(
            lambda: mk.decoder_bwd_plain(xn, gn, fp, want_wgrad=False))
        st["bound_ms"], st["bound_by"] = _bound(
            3 * DEC_FLOPS * st["rows"], 0,
            _nbytes(xn, gn, *fp, dx_k[:st["rows"]], *gr_k))
        st["dx_only_bound_ms"], _ = _bound(
            2 * DEC_FLOPS * st["rows"], 0, _nbytes(xn, gn, *fp, xn))
        st["share"] = st["bound_ms"] / st["ms"]
        st["pass1_ms"], st["pass2_ms"] = _k3_pass_ms(xn, gn, fp, {})
        st["wgrad_gb"] = _wgrad_gb(size0, st["rows"], sms)
        blocks, per_block = mk.backward_partition(st["rows"], sms)
        plan = mk.wgrad_plan(size0, st["rows"], sms)
        # a count from the code, not a measurement (_wgrad_gb)
        log(f"K3 at the {shape} shape: pass 1 in {blocks} blocks of <= "
            f"{per_block} tiles, pass 2 in {plan.tiles} output tiles x "
            f"{plan.splits} splits of <= {plan.per_split} tiles, "
            f"{len(mk.wgrad_chunks(plan, size0, st['rows']))} chunk(s); "
            f"pass 1 {st['pass1_ms']:.3f} ms, pass 2 {st['pass2_ms']:.3f} "
            f"ms; bytes of the weight gradients through device memory, "
            f"counted from the code: {st['wgrad_gb']['total'] * 1e3:.0f} MB")
    # decoder_wgrad on its own at the mapping shape (one K3 call's chunks):
    # its time, its plain version's on the same operands, the five products
    # as bf16 torch.matmul calls on them (the yardstick), its bound (the
    # operands read once, the five gradients written once; the products'
    # flops)
    ops = mk.decoder_bwd_operands_plain(x, g, fp)
    plan = mk.wgrad_plan(size0, N, sms)
    wgrad_ms = k3["mapping"]["pass2_ms"]
    wgrad_plain_ms = _event_ms(lambda: mk.decoder_wgrad_plain(ops, size0,
                                                             plan))
    wgrad_matmul_ms = _wgrad_matmul_ms(ops, size0)
    del ops
    wgrad_bound = _bound(2 * N * mk.wgrad_part_floats(size0), 0,
                         _wgrad_bound_bytes(size0, N))

    # K2 on the pcd branch's decoder inputs (PointNet features of frame 0's
    # stored points, blended per sample) at the mapping and tracking shapes
    # (the first TRACK_RAYS rays), then on K1's trilinear features at a row
    # count that is no multiple of the 64-row tile
    pcd_args = inp["pcd_args"]
    with torch.no_grad():
        x2 = gather_pcd_features(*pcd_args)
    x2 = x2.reshape(-1, x2.shape[-1]).contiguous()
    N2 = x2.shape[0]
    k2_inputs = {}
    for label, xi, tol in (("pcd", x2, TOL_K2),
                           ("pcd tracking", x2[:TR], TOL_K2),
                           ("trilinear", x[:N - 37], TOL_K1_OUT)):
        out_k = mk.decoder_fwd(xi, fp)
        _, _, _, sdf_p, _, rgb_p = mk.decoder_fwd_plain(xi, fp)
        out_p = torch.cat([rgb_p, sdf_p], dim=1)
        # the same rows' outputs one row off: what a kernel reading a
        # neighbouring row would give
        shift = (out_p[1:] - out_p[:-1]).abs().max().item()
        out_k2 = mk.decoder_fwd(xi, fp)
        torch.cuda.synchronize()
        st = dict(rows=xi.shape[0], stored_points=inp["points"],
                  rms=xi.pow(2).mean().sqrt().item(),
                  zero_row_share=(xi.abs().sum(1) == 0).float().mean().item(),
                  out_std_min=out_p.std(dim=0).min().item(),
                  shift_err=shift,
                  max_abs_err_per_column=(out_k - out_p).abs().amax(0).tolist())
        st["max_abs_err"] = max(st["max_abs_err_per_column"])
        k2_inputs[label] = st
        log(f"K2 on {label} features: " + json.dumps(st)
            + f" (tol {tol}, shift margin {SHIFT_MARGIN})")
        if not st["max_abs_err"] <= tol:
            raise AssertionError(f"K2 disagrees with decoder_fwd_plain on "
                                 f"{label} features")
        if not torch.equal(out_k, out_k2):
            raise AssertionError("K2 is not bitwise repeatable")
    if not k2_inputs["trilinear"]["shift_err"] > SHIFT_MARGIN * TOL_K1_OUT:
        raise AssertionError("the K2 check cannot tell neighbouring rows")
    err2 = max(st["max_abs_err"] for st in k2_inputs.values())

    # K2, its plain version and the same decoder as a chain of bf16 matmuls
    # (the yardstick) at both shapes
    chain, leaves = _matmul_chain(fp)
    x2b = x2.to(torch.bfloat16)
    k2 = {"mapping": dict(rows=N2), "tracking": dict(rows=min(TR, N2))}
    for shape, st in k2.items():
        xn, xb_n = x2[:st["rows"]], x2b[:st["rows"]]
        st["ms"] = _event_ms(lambda: mk.decoder_fwd(xn, fp))
        st["plain_ms"] = _event_ms(lambda: mk.decoder_fwd_plain(xn, fp))
        with torch.no_grad():
            st["matmul_chain_ms"] = _event_ms(lambda: chain(xb_n))
        st["bound_ms"], st["bound_by"] = _bound(
            DEC_FLOPS * st["rows"], 0, _nbytes(xn, *fp) + st["rows"] * 4 * 4)
        st["share"] = st["bound_ms"] / st["ms"]
    xb = x.to(torch.bfloat16).requires_grad_(True)
    gb = g.to(torch.bfloat16)

    def chain_fwd_bwd():
        for t in leaves + [xb]:
            t.grad = None
        chain(xb).backward(gb)
    chain_bwd_ms = _event_ms(chain_fwd_bwd)

    # PointNet + blend at the mapping shape (R*H*K rows), forward and with
    # its backward into the PointNet params and sample positions
    with torch.no_grad():
        gather_ms = _event_ms(lambda: gather_pcd_features(*pcd_args), reps=3)
    sxyz = pcd_args[0].detach().requires_grad_(True)
    pn_leaves = [t.requires_grad_(True) for layer in pcd_args[4]["layers"]
                 for t in layer.values()]
    pn_leaves += [t.requires_grad_(True) for t in pcd_args[4]["fc"].values()]

    def gather_fwd_bwd():
        for t in pn_leaves + [sxyz]:
            t.grad = None
        gather_pcd_features(sxyz, *pcd_args[1:]).sum().backward()
    torch.cuda.reset_peak_memory_stats()
    gather_bwd_ms = _event_ms(gather_fwd_bwd, reps=3)
    gather_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for shape in ("mapping", "tracking"):
        a, b, c = k1[shape], k3[shape], k2[shape]
        log(f"{shape} shape: K1 {a['ms']:.3f} ms (plain {a['plain_ms']:.3f} "
            f"ms, bound {a['bound_ms']:.4f} ms by {a['bound_by']}, share "
            f"{a['share']:.3f}, {a['rows']} rows); K2 {c['ms']:.3f} ms (plain "
            f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms by "
            f"{c['bound_by']}, share {c['share']:.3f}; bf16 torch.matmul "
            f"chain forward {c['matmul_chain_ms']:.3f} ms, {c['rows']} rows); "
            f"K3 {b['ms']:.3f} ms (plain {b['plain_ms']:.3f} ms, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']}, share "
            f"{b['share']:.3f}; pass 1 {b['pass1_ms']:.3f} ms, pass 2 "
            f"{b['pass2_ms']:.3f} ms); K3 dx-only {b['dx_only_ms']:.3f} ms "
            f"(plain "
            f"{b['dx_only_plain_ms']:.3f} ms, bound "
            f"{b['dx_only_bound_ms']:.4f} ms)")
    log(f"bf16 torch.matmul chain (a chain of calls, not one library call): "
        f"forward+backward {chain_bwd_ms:.3f} ms at N={N}")
    log(f"decoder_wgrad at the mapping shape, N={N}: {wgrad_ms:.3f} ms "
        f"(plain {wgrad_plain_ms:.3f} ms, bound {wgrad_bound[0]:.4f} ms by "
        f"{wgrad_bound[1]}, share {wgrad_bound[0] / wgrad_ms:.3f}; its five "
        f"products as bf16 torch.matmul calls {wgrad_matmul_ms:.3f} ms)")
    log(f"pcd gather (PointNet at {pcd_args[3].xyz.shape[1] * R * H} rows + "
        f"blend): forward {gather_ms:.3f} ms, forward+backward "
        f"{gather_bwd_ms:.3f} ms, peak memory {gather_peak_gb:.2f} GB")

    f32 = f32_kernel_phase(x2, g, fp, min(TR, N2))
    render_errs = pcd_render_check(inp["render"], inp["rays_o"],
                                   inp["rays_d"], device)
    # the pcd features at every built in_dim (PointNet of that output width)
    x2_by_dim = {16: x2}
    for d, a in inp["pcd_args_by_dim"].items():
        if d not in x2_by_dim:
            with torch.no_grad():
                xd = gather_pcd_features(*a)
            x2_by_dim[d] = xd.reshape(-1, d).contiguous()
    by_size = {_size_tag(size): size_phase(device, inp, size,
                                           full=full_size(size))
               for size in mk.BUILT_SIZES if mk.streamed(size)}
    f32_by_size = {_size_tag(size): f32_size_phase(
        device, x2_by_dim[size[0]], g, size, min(TR, N2),
        full=full_size(size))
        for size in mk.BUILT_SIZES if mk.streamed(size)}
    for name in ("decoder_forward_f32", "decoder_backward_f32"):
        f32[name]["sizes"] = {tag: st[name]
                              for tag, st in f32_by_size.items()}
    padded = pad_phase(device, inp, x2_by_dim, g)

    m1, m2, m3 = k1["mapping"], k2["mapping"], k3["mapping"]
    sizes = {k: {tag: st[k] for tag, st in by_size.items()}
             for k in ("fused_render_forward", "decoder_forward",
                       "decoder_backward")}
    return {
        "fused_render_forward": dict(
            _entry(max(err_feats, err_out), m1["ms"], m1["plain_ms"],
                   (m1["bound_ms"], m1["bound_by"])), shapes=k1,
            sizes=sizes["fused_render_forward"]),
        "decoder_forward": dict(
            _entry(err2, m2["ms"], m2["plain_ms"],
                   (m2["bound_ms"], m2["bound_by"]), m2["matmul_chain_ms"]),
            shapes=k2, sizes=sizes["decoder_forward"]),
        "decoder_backward": dict(
            _entry(worst_abs, m3["ms"], m3["plain_ms"],
                   (m3["bound_ms"], m3["bound_by"]), chain_bwd_ms),
            shapes=k3, sizes=sizes["decoder_backward"]),
        "decoder_wgrad": dict(
            _entry(max(st["max_abs_err"] for st in wgrad_sizes.values()),
                   wgrad_ms, wgrad_plain_ms, wgrad_bound),
            matmul_ms=wgrad_matmul_ms, rows=N, checks=wgrad_sizes),
        **f32,
        "extra": dict(pcd_gather_ms=gather_ms,
                      pcd_gather_fwd_bwd_ms=gather_bwd_ms,
                      pcd_gather_peak_gb=gather_peak_gb,
                      k1_shift_err=shift1, k2_inputs=k2_inputs,
                      pcd_render=render_errs, pad=padded),
    }


def size_phase(device, inp, size, full=True) -> dict:
    """K1, K2 and K3 at another decoder size of ``mlp_kernel.BUILT_SIZES``
    (the streamed or wide plan), on the kernel phase's K1 inputs with that
    size's ``init_decoder`` params: K1 against its plain version at the
    mapping, tracking and ragged shapes, K2 on K1's features bit for bit
    against K1's outputs, K3 (full and dx-only) against its plain version
    at the mapping and tracking shapes, a ragged mapping shape and the small
    ragged counts, K3's repeatability, and CUDA-event times of each kernel
    and its plain version at both shapes with the bound and its share ->
    {kernel: entry}. ``full=False``: K1's and K3's checks without the
    mapping shape (K3's ragged count cut from the tracking shape, its
    repeatability there). Which shapes are timed, how, and where the plain
    versions and the chain are (their entries None elsewhere):
    :func:`size_timing`."""
    import torch

    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk

    d, w, sd = size
    dec = dataclasses.replace(bench_settings().decoder, in_dim=d, width=w,
                              sdf_dim=sd)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    fp = mk.pack_params(init_decoder(gen, dec, device), dec)
    fp = type(fp)(*[t.contiguous() for t in fp])
    flops = dec_flops(size)
    base = (inp["rb_by_dim"][d], inp["keys_rb"], inp["bins"], inp["z"],
            inp["rays_o"], inp["rays_d"])
    R, S = inp["bins"].shape
    nr, ns = K1_RAGGED
    k1_args = {
        "mapping": base + (fp, inp["voxel"]),
        "tracking": tuple(a[:TRACK_RAYS].contiguous() for a in base)
        + (fp, inp["voxel"]),
        "ragged": tuple(a[:nr, :ns].contiguous()
                        if a.dim() == 2 and a.shape[1] == S
                        else a[:nr].contiguous() for a in base)
        + (fp, inp["voxel"])}
    err1 = 0.0
    for shape, a in k1_args.items():
        if not full and shape == "mapping":
            continue
        out_k, feats_k = rk.fused_render_forward(*a)
        out_p, feats_p = rk.fused_render_forward_plain(*a)
        out_2 = mk.decoder_fwd(feats_k, fp)
        torch.cuda.synchronize()
        ef = (feats_k - feats_p).abs().max().item()
        eo = (out_k - out_p).abs().amax(0)
        same = torch.equal(out_2, out_k)
        log(f"K1 at {size}, the {shape} shape: feats max_abs_err {ef:.3e} "
            f"(tol {TOL_FEATS}), out max_abs_err per column "
            f"{[float(f'{v:.3e}') for v in eo.tolist()]} (tol "
            f"{TOL_K1_OUT}); K2 on K1's feats "
            + ("bitwise equal to K1's out" if same else
               f"differs in {int((out_2 != out_k).sum())} values"))
        if not (ef <= TOL_FEATS and eo.max().item() <= TOL_K1_OUT):
            raise AssertionError(f"K1 at {size} disagrees with "
                                 f"fused_render_forward_plain at the {shape} "
                                 "shape")
        if not same:
            raise AssertionError(f"K2 on K1's feats differs from K1's out at "
                                 f"{size}, the {shape} shape")
        err1 = max(err1, ef, eo.max().item())
        if shape == ("mapping" if full else "tracking"):
            shift = (out_p[1:] - out_p[:-1]).abs().max().item()
    if not shift > SHIFT_MARGIN * TOL_K1_OUT:
        raise AssertionError(f"the K1 check at {size} cannot tell "
                             "neighbouring rows")

    x = rk.fused_render_forward_plain(*k1_args["mapping"])[1]
    N = x.shape[0]
    TRR = min(TRACK_RAYS * S, N)
    g = 1e-2 * torch.randn((N, 4), generator=gen, device=device)
    nz = x.abs().sum(1) > 0
    if mk.parked(mk.built_size(size)):
        # at widths 768 and 1024 a row has ~3,000 hidden units, and few rows
        # have a margin >= MARGIN_FLIP (~0.7% at the tracking shape): the
        # small ragged counts take the first nonzero rows of margin, so
        # that every output is held at the tolerance there
        lead = min(N, 65536)
        nz[:lead] &= _margins(mk, x[:lead], fp) >= MARGIN_FLIP
        nz[lead:] = False
    nz = nz.nonzero().flatten()
    cases = [("tracking", x[:TRR], g[:TRR], True),
             ("tracking", x[:TRR], g[:TRR], False)]
    if full:
        cases = [("mapping", x, g, True), ("mapping", x, g, False),
                 ("ragged", x[:N - K3_RAGGED], g[:N - K3_RAGGED],
                  True)] + cases
    else:
        cases.append(("ragged", x[:TRR - K3_RAGGED], g[:TRR - K3_RAGGED],
                      True))
    cases += [("small ragged", x[nz[:n]], g[nz[:n]], True) for n in K3_SMALL]
    err3 = 0.0
    for label, xn, gn, wgrad in cases:
        e, _ = _k3_check(f"K3 at {size}, the {label} shape", xn.contiguous(),
                         gn.contiguous(), fp, wgrad, True,
                         log_bins=label == cases[0][0] and wgrad)
        err3 = max(err3, e)
    xr, gr = (x, g) if full else (x[:TRR].contiguous(), g[:TRR].contiguous())
    dx_k, gr_k = mk.decoder_bwd(xr, gr, fp)
    dx_k2, gr_k2 = mk.decoder_bwd(xr, gr, fp)
    dx_only, _ = mk.decoder_bwd(xr, gr, fp, want_wgrad=False)
    if not (torch.equal(dx_k, dx_k2) and torch.equal(dx_k, dx_only)
            and all(torch.equal(a, b) for a, b in zip(gr_k, gr_k2))):
        raise AssertionError(f"K3 at {size} is not bitwise repeatable")

    timing = size_timing(size, full)
    sms = _sms(device)
    shapes = {k: v for k, v in (("mapping", N), ("tracking", TRR))
              if k in timing}
    k1, k2, k3 = {}, {}, {}
    chain, leaves = _matmul_chain(fp)
    for shape, rows in shapes.items():
        a = k1_args[shape]
        xn, gn = x[:rows].contiguous(), g[:rows].contiguous()
        xb = xn.to(torch.bfloat16)
        xg = xb.detach().clone().requires_grad_(True)
        gb = gn.to(torch.bfloat16)

        def chain_fwd_bwd():
            for t in leaves + [xg]:
                t.grad = None
            chain(xg).backward(gb)
        reps, yreps = timing[shape]
        yard = yreps is not None              # plain versions and chains
        st = k1[shape] = dict(rows=rows)
        st["ms"] = _event_ms(lambda: rk.fused_render_forward(*a), **reps)
        st["plain_ms"] = (_event_ms(lambda: rk.fused_render_forward_plain(*a),
                                    **yreps) if yard else None)
        st["bound_ms"], st["bound_by"] = _bound(
            flops * rows, k1_blend_flops(d) * rows,
            _nbytes(*a[:6], *fp) + rows * (4 + d) * 4)
        st = k2[shape] = dict(rows=rows)
        st["ms"] = _event_ms(lambda: mk.decoder_fwd(xn, fp), **reps)
        st["plain_ms"] = (_event_ms(lambda: mk.decoder_fwd_plain(xn, fp),
                                    **yreps) if yard else None)
        with torch.no_grad():
            st["matmul_chain_ms"] = (_event_ms(lambda: chain(xb),
                                               **(yreps or dict(reps=3)))
                                     if yard else None)
        st["bound_ms"], st["bound_by"] = _bound(
            flops * rows, 0, _nbytes(xn, *fp) + rows * 4 * 4)
        st = k3[shape] = dict(rows=rows)
        st["ms"] = _event_ms(lambda: mk.decoder_bwd(xn, gn, fp), **reps)
        st["plain_ms"] = (_event_ms(lambda: mk.decoder_bwd_plain(xn, gn, fp),
                                    **yreps) if yard else None)
        st["matmul_chain_ms"] = (_event_ms(chain_fwd_bwd,
                                           **(yreps or dict(reps=3)))
                                 if yard else None)
        st["dx_only_ms"] = _event_ms(
            lambda: mk.decoder_bwd(xn, gn, fp, want_wgrad=False), **reps)
        st["dx_only_plain_ms"] = (_event_ms(
            lambda: mk.decoder_bwd_plain(xn, gn, fp, want_wgrad=False),
            **yreps) if yard else None)
        st["bound_ms"], st["bound_by"] = _bound(
            3 * flops * rows, 0, _nbytes(xn, gn, *fp, xn, *gr_k))
        st["pass1_ms"], st["pass2_ms"] = _k3_pass_ms(xn, gn, fp, reps)
        st["wgrad_gb"] = _wgrad_gb(size, rows, sms)
        st["dx_only_bound_ms"], _ = _bound(2 * flops * rows, 0,
                                           _nbytes(xn, gn, *fp, xn))
        st["dx_only_share"] = st["dx_only_bound_ms"] / st["dx_only_ms"]
        for e in (k1, k2, k3):
            e[shape]["share"] = e[shape]["bound_ms"] / e[shape]["ms"]
        a1, a2, a3 = k1[shape], k2[shape], k3[shape]
        log(f"{shape} shape at {size}: K1 {a1['ms']:.3f} ms (plain "
            f"{_ms(a1['plain_ms'])} ms, bound {a1['bound_ms']:.4f} ms by "
            f"{a1['bound_by']}, share {a1['share']:.3f}); K2 {a2['ms']:.3f} "
            f"ms (plain {_ms(a2['plain_ms'])} ms, bound "
            f"{a2['bound_ms']:.4f} ms, share {a2['share']:.3f}; bf16 "
            f"torch.matmul chain forward {_ms(a2['matmul_chain_ms'])} ms); "
            f"K3 {a3['ms']:.3f} ms (plain {_ms(a3['plain_ms'])} ms, bound "
            f"{a3['bound_ms']:.4f} ms, share {a3['share']:.3f}; chain "
            f"forward+backward {_ms(a3['matmul_chain_ms'])} ms; pass 1 "
            f"{a3['pass1_ms']:.3f} ms, pass 2 {a3['pass2_ms']:.3f} ms); K3 "
            f"dx-only "
            f"{a3['dx_only_ms']:.3f} ms "
            f"(plain {_ms(a3['dx_only_plain_ms'])} ms, bound "
            f"{a3['dx_only_bound_ms']:.4f} ms, share "
            f"{a3['dx_only_share']:.3f}); {rows} rows")
    return {"fused_render_forward": dict(max_abs_err=err1, shapes=k1),
            "decoder_forward": dict(max_abs_err=err1, shapes=k2),
            "decoder_backward": dict(max_abs_err=err3, shapes=k3)}


def _sms(device) -> int:
    """The card's SM count (K3's partitions and splits follow it); one on
    the CPU, where the size phases are rehearsed with the plain
    versions."""
    import torch

    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def _wgrad_bound_bytes(size, rows, bf16=True) -> int:
    """The bytes a second pass must move for ``rows`` rows at ``size``:
    the eight operands of its five products read once (bf16 for K3, f32
    for K3-f32: 2 or 4 (in_dim + 5 width + 2 sdf_dim) a row, the scratch's
    padding left out) and the five gradients written once."""
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    d, w, sd = size
    return ((2 if bf16 else 4) * rows * (d + 5 * w + 2 * sd)
            + 4 * mk.wgrad_part_floats(size))


def _wgrad_gb(size, rows, sms, bf16=True) -> dict:
    """GB K3's (``bf16``) or K3-f32's weight gradients move through device
    memory in a full backward of ``rows`` rows at a built ``size``, by
    count from the code -> {"scratch": pass 1 writes each chunk's operand
    scratch once and pass 2 reads it once (the output tiles that share an
    operand read it again from L2, which this count leaves out),
    "partials": pass 2 writes each split's partial sums and the reduce
    reads them, "slabs": each tile of pass 1 reads and rewrites its
    block's slab of small gradients (a block's first tile only writes it,
    which this count ignores), "total"}."""
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    chunks = mk.wgrad_chunks(mk.wgrad_plan(size, rows, sms, bf16=bf16),
                             size, rows, bf16)
    tile_rows = mk.wgrad_tile_rows(size, bf16)
    gb = dict(
        scratch=2 * sum(mk.wgrad_scratch_bytes(size, r, tile_rows, bf16)
                        for _, r, _, _ in chunks) / 1e9,
        partials=2 * sum(c[2] for c in chunks) * mk.wgrad_part_floats(size)
        * 4 / 1e9,
        slabs=-(-rows // tile_rows) * 2 * mk.small_grad_layout(size)["n"]
        * 4 / 1e9)
    gb["total"] = sum(gb.values())
    return gb


def _pass2_name(bf16: bool) -> str:
    """The second pass's wrapper in mlp_kernel: K3's or K3-f32's."""
    return "decoder_wgrad" if bf16 else "decoder_wgrad_f32"


def _k3_pass_ms(xn, gn, fp, reps, bf16=True) -> tuple:
    """K3's (``bf16``) or K3-f32's two passes timed apart (``_event_ms``
    with ``reps``) at the built size of ``fp`` -> (pass 1 ms, pass 2 ms):
    pass 1 with its wrapper and the reduce (the backward with pass 2
    stubbed out), and pass 2 (``decoder_wgrad`` or ``decoder_wgrad_f32``)
    over every chunk of ``xn``'s rows, each on its chunk's operands as pass
    1 stores them (their plain version, packed: the rows' own values, not a
    stand-in, since the tensor cores' time depends on the data)."""
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    size, n = mk.params_size(fp), xn.shape[0]
    name = _pass2_name(bf16)
    real = getattr(mk, name)
    setattr(mk, name, lambda *a, **k: None)
    try:
        p1 = _event_ms(lambda: mk.decoder_bwd(xn, gn, fp, bf16=bf16), **reps)
    finally:
        setattr(mk, name, real)
    plan = mk.wgrad_plan(size, n, _sms(xn.device), bf16=bf16)
    tile_rows = mk.wgrad_tile_rows(size, bf16)
    chunks = [(mk.pack_operands(mk.decoder_bwd_operands_plain(
        xn[r0:r0 + rows], gn[r0:r0 + rows], fp, bf16), tile_rows, bf16),
        rows, splits, per)
        for r0, rows, splits, per in mk.wgrad_chunks(plan, size, n, bf16)]
    part = torch.empty((plan.splits * mk.wgrad_part_floats(size),),
                       device=xn.device)

    def pass2():
        for scratch, rows, splits, per in chunks:
            getattr(mk, name)(scratch, size, rows, splits, per, part)
    return p1, _event_ms(pass2, **reps)


def _wgrad_matmul_ms(ops, size, bf16=True, reps=None) -> float:
    """The second pass's yardstick: its five products (``wgrad_jobs``) as
    ``torch.matmul`` calls on the same operands, bf16 for K3's, f32 with
    TF32 off for K3-f32's (a chain of calls, not one library call: timed
    here, used nowhere in the port)."""
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    ops = mk.WgradOperands(*[t.to(torch.bfloat16) if bf16 else t
                             for t in ops])
    pairs = [(getattr(ops, a).T, getattr(ops, b))
             for _, a, b, _, _ in mk.wgrad_jobs(size)]
    return _event_ms(lambda: [torch.matmul(a, b) for a, b in pairs],
                     **(reps or {}))


def wgrad_check(device, x, g, fp0, bf16=True) -> dict:
    """``decoder_wgrad`` (K3's second pass; ``decoder_wgrad_f32``, K3-f32's,
    for ``bf16=False``) and the reduce against ``decoder_wgrad_plain`` on
    identical operands: pass 1's operands from its plain version
    (``decoder_bwd_operands_plain``) on the rows of the first chunk the
    backward makes of the kernel phase's inputs ``x``, ``g`` (the mapping
    shape), packed as pass 1 stores them (``pack_operands``), at each size
    of WGRAD_SIZES (one of each plan of pass 1: for K3-f32 its 64-, 32-
    and 16-row tiles and its parked tile A; that size's ``init_decoder``
    params, ``fp0`` at (16, 128, 128)) with the wrapper's splits -> {size
    tag: rows, splits, each output's error over its largest magnitude, the
    largest absolute error}; raises past TOL_WGRAD (TOL_WGRAD_F32). For
    K3 (``bf16``) also against the five products summed in float64 from
    the same operands: pass 2's error and ``decoder_wgrad_plain``'s,
    logged at every size and pass 2's held at TOL_WGRAD at (16, 128, 128)
    and at the size whose splits sum the longest runs of rows."""
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    sms = _sms(device)
    tol = TOL_WGRAD if bf16 else TOL_WGRAD_F32
    pass2 = _pass2_name(bf16)
    runs = {size: mk.wgrad_splits(size, mk.wgrad_plan(
        size, x.shape[0], sms, bf16=bf16).chunk_rows, sms, bf16)[1]
        for size in WGRAD_SIZES}
    held_f64 = {(16, 128, 128), max(runs, key=runs.get)}
    out = {}
    for size in WGRAD_SIZES:
        n = mk.wgrad_plan(size, x.shape[0], sms, bf16=bf16).chunk_rows
        xn, gn = x[:n].contiguous(), g[:n].contiguous()
        fp = fp0 if mk.params_size(fp0) == size else _decoder_at(device,
                                                                size, 2)
        ops = mk.decoder_bwd_operands_plain(xn, gn, fp, bf16)
        splits, per = mk.wgrad_splits(size, n, sms, bf16)
        part = torch.empty((splits * mk.wgrad_part_floats(size),),
                           device=device)
        getattr(mk, pass2)(mk.pack_operands(
            ops, mk.wgrad_tile_rows(size, bf16), bf16), size, n, splits, per,
            part)
        dflat = torch.empty((sum(t.numel() for t in fp),), device=device)
        mk.wgrad_reduce(part, splits, torch.zeros(
            (mk.small_grad_layout(size)["n"],), device=device), 1, size,
            dflat)
        got, off = {}, 0
        for name, t in zip(mk.FusedParams._fields, fp):
            got[name] = dflat[off:off + t.numel()].view(t.shape)
            off += t.numel()
        want = mk.decoder_wgrad_plain(ops, size, mk.WgradPlan(
            n, mk.wgrad_tiles(size, bf16), splits, per, sms))
        torch.cuda.synchronize()
        names = ("w1", "w2", "ws", "wc_f", "wc_x")
        got = [got[k][:, :size[2]] if k == "ws" else got[k] for k in names]

        def rel_to(ref, outs):
            rel = {}
            for k, a, w in zip(names, outs, ref):
                e = (a.double() - w).abs().max().item()
                rel[k] = float(f"{e / max(w.abs().max().item(), 1e-30):.3e}")
            return rel
        rel = rel_to(want, got)
        worst = max((a - w).abs().max().item() for a, w in zip(got, want))
        st = dict(rows=n, splits=splits, per_split=per, rel_err=rel,
                  max_abs_err=worst)
        if bf16:
            exact = mk.decoder_wgrad_plain(
                mk.WgradOperands(*[t.double() for t in ops]), size)
            st["rel_err_f64"] = rel_to(exact, got)
            st["plain_rel_err_f64"] = rel_to(exact, want)
        log(f"{pass2} at {size} on identical operands: "
            + json.dumps(st) + f" (tol {tol} of each output's "
            "largest magnitude" + (", against float64 too at "
                                   f"{sorted(held_f64)}" if bf16 else "")
            + ")")
        if not max(rel.values()) <= tol:
            raise AssertionError(f"{pass2} at {size} disagrees with "
                                 "decoder_wgrad_plain")
        if bf16 and size in held_f64 and not max(
                st["rel_err_f64"].values()) <= tol:
            raise AssertionError(f"{pass2} at {size} disagrees with the "
                                 "float64 products")
        out[_size_tag(size)] = st
        del ops
    return out


def _ms(v) -> str:
    """A time for a log line: ms to 3 decimals, or "not timed"."""
    return "not timed" if v is None else f"{v:.3f}"


def _decoder_at(device, size, seed):
    """Packed ``init_decoder`` params of the bench decoder at ``size``."""
    import torch

    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    d, w, sd = size
    dec = dataclasses.replace(bench_settings().decoder, in_dim=d, width=w,
                              sdf_dim=sd)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fp = mk.pack_params(init_decoder(gen, dec, device), dec)
    return type(fp)(*[t.contiguous() for t in fp])


def _k2_check(what, xn, fp, bf16, tol, size=None):
    """K2 (``bf16``) or K2-f32 on ``xn`` against its plain version, each
    output column within ``tol`` of its largest magnitude (K2-f32: or
    within it of the float64 forward, the note at TOL_F32_FWD), and
    bitwise repeatable -> (largest absolute error, the kernel's
    output)."""
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    out_k = mk.decoder_fwd(xn, fp, bf16=bf16)
    _, _, _, sdf_p, _, rgb_p = mk.decoder_fwd_plain(xn, fp, bf16)
    out_p = torch.cat([rgb_p, sdf_p], dim=1)
    out_k2 = mk.decoder_fwd(xn, fp, bf16=bf16)
    torch.cuda.synchronize()
    scale = out_p.abs().amax(0).clamp_min(1e-30)
    rel = ((out_k - out_p).abs().amax(0) / scale).tolist()
    log(f"{what}, N={xn.shape[0]}: max_abs_err over each column's largest "
        f"magnitude {[float(f'{v:.3e}') for v in rel]} (tol {tol})")
    if not max(rel) <= tol and not bf16:
        f64 = mk.FusedParams(*[t.double() for t in fp])
        _, _, _, sdf_e, _, rgb_e = mk.decoder_fwd_plain(xn.double(), f64,
                                                         False)
        out_e = torch.cat([rgb_e, sdf_e], dim=1)
        scale_e = out_e.abs().amax(0).clamp_min(1e-30)

        def rel_e(o):
            return [float(f"{v:.3e}") for v in
                    ((o.double() - out_e).abs().amax(0) / scale_e).tolist()]
        rel = rel_e(out_k)
        log(f"{what}: against the float64 forward, max_abs_err over each "
            f"column's largest magnitude {rel} (tol {tol}); the plain "
            f"version's {rel_e(out_p)}")
    if not max(rel) <= tol:
        raise AssertionError(f"{what} disagrees with decoder_fwd_plain")
    if not torch.equal(out_k, out_k2):
        raise AssertionError(f"{what} is not bitwise repeatable")
    return (out_k - out_p).abs().max().item(), out_k


def f32_size_phase(device, x, g, size, track_rows, full=True) -> dict:
    """K2-f32 and K3-f32 at another size of ``mlp_kernel.BUILT_SIZES`` (the
    streamed f32 plan, ``mlp_stream_f32.cu``) on the pcd features ``x``
    with the cotangents ``g`` and that size's ``init_decoder`` params:
    K2-f32 at the mapping, tracking and ragged shapes (each column within
    TOL_F32_FWD of its largest magnitude), K3-f32 full and dx-only at the
    mapping and tracking shapes and full at the ragged one (``_k3_check``:
    every weight and bias gradient within TOL_F32_BWD, dx on the rows of
    margin >= MARGIN_FLIP_F32), both bitwise repeatable; CUDA-event times
    of each kernel, its plain version and the f32 matmul chain at both
    shapes, with the 3xTF32 bound and its share -> {kernel: entry}. The
    tracking shape is the first ``track_rows`` rows. ``full=False``: the
    checks at the tracking shape and a ragged count cut from it, the
    repeatability there. Which shapes are timed, how, and where the plain
    versions and the chain are (their entries None elsewhere):
    :func:`size_timing`."""
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    fp = _decoder_at(device, size, 4)
    flops = dec_flops(size)
    N = x.shape[0]
    shapes = (("mapping", N), ("tracking", track_rows),
              ("ragged", (N if full else track_rows) - K3_RAGGED))
    err2 = err3 = 0.0
    for label, rows in shapes if full else shapes[1:]:
        xn, gn = x[:rows].contiguous(), g[:rows].contiguous()
        e, _ = _k2_check(f"K2-f32 at {size}, the {label} shape", xn, fp,
                         False, TOL_F32_FWD)
        err2 = max(err2, e)
        for wgrad in ((True, False) if label != "ragged" else (True,)):
            e, _ = _k3_check(f"K3-f32 at {size}, the {label} shape", xn, gn,
                             fp, wgrad, False,
                             log_bins=label == ("mapping" if full
                                                else "tracking") and wgrad)
            err3 = max(err3, e)
    xr, gr = ((x, g) if full else (x[:track_rows].contiguous(),
                                    g[:track_rows].contiguous()))
    dx_k, gr_k = mk.decoder_bwd(xr, gr, fp, bf16=False)
    dx_k2, gr_k2 = mk.decoder_bwd(xr, gr, fp, bf16=False)
    dx_only, _ = mk.decoder_bwd(xr, gr, fp, want_wgrad=False, bf16=False)
    if not (torch.equal(dx_k, dx_k2) and torch.equal(dx_k, dx_only)
            and all(torch.equal(a, b) for a, b in zip(gr_k, gr_k2))):
        raise AssertionError(f"K3-f32 at {size} is not bitwise repeatable")

    chain, leaves = _matmul_chain(fp, torch.float32)
    k2, k3 = {}, {}
    timing = size_timing(size, full)
    for shape, rows in [sr for sr in shapes[:2] if sr[0] in timing]:
        xn, gn = x[:rows].contiguous(), g[:rows].contiguous()
        reps, yreps = timing[shape]
        yard = yreps is not None              # plain versions and chains
        yreps = yreps or dict(reps=3)
        st = k2[shape] = dict(rows=rows)
        st["ms"] = _event_ms(lambda: mk.decoder_fwd(xn, fp, bf16=False),
                             **reps)
        st["plain_ms"] = (_event_ms(
            lambda: mk.decoder_fwd_plain(xn, fp, False), **yreps)
            if yard else None)
        with torch.no_grad():
            st["matmul_chain_ms"] = (_event_ms(lambda: chain(xn), **yreps)
                                     if yard else None)
        st["bound_ms"], st["bound_by"] = _bound(
            0, 0, _nbytes(xn, *fp) + rows * 4 * 4, flops * rows)
        st = k3[shape] = dict(rows=rows)
        st["ms"] = _event_ms(lambda: mk.decoder_bwd(xn, gn, fp, bf16=False),
                             **reps)
        st["plain_ms"] = (_event_ms(
            lambda: mk.decoder_bwd_plain(xn, gn, fp, bf16=False), **yreps)
            if yard else None)
        st["dx_only_ms"] = _event_ms(lambda: mk.decoder_bwd(
            xn, gn, fp, want_wgrad=False, bf16=False), **reps)
        xg = xn.detach().clone().requires_grad_(True)

        def chain_fwd_bwd():
            for t in leaves + [xg]:
                t.grad = None
            chain(xg).backward(gn)
        st["matmul_chain_ms"] = (_event_ms(chain_fwd_bwd, **yreps) if yard
                                 else None)
        st["bound_ms"], st["bound_by"] = _bound(
            0, 0, _nbytes(xn, gn, *fp, xn, *gr_k), 3 * flops * rows)
        st["wgrad_gb"] = _wgrad_gb(size, rows, _sms(device), bf16=False)
        st["dx_only_bound_ms"], _ = _bound(0, 0, _nbytes(xn, gn, *fp, xn),
                                           2 * flops * rows)
        st["dx_only_share"] = st["dx_only_bound_ms"] / st["dx_only_ms"]
        for e in (k2, k3):
            e[shape]["share"] = e[shape]["bound_ms"] / e[shape]["ms"]
        a, b = k2[shape], k3[shape]
        log(f"{shape} shape at {size}, f32 operands: K2-f32 {a['ms']:.3f} ms "
            f"(plain {_ms(a['plain_ms'])} ms, 3xTF32 bound "
            f"{a['bound_ms']:.4f} ms, share {a['share']:.3f}; f32 "
            f"torch.matmul chain forward {_ms(a['matmul_chain_ms'])} ms); "
            f"K3-f32 {b['ms']:.3f} ms (plain {_ms(b['plain_ms'])} ms, "
            f"3xTF32 bound {b['bound_ms']:.4f} ms, share {b['share']:.3f}; "
            f"chain forward+backward {_ms(b['matmul_chain_ms'])} ms); K3-f32 "
            f"dx-only {b['dx_only_ms']:.3f} ms (3xTF32 bound "
            f"{b['dx_only_bound_ms']:.4f} ms, share "
            f"{b['dx_only_share']:.3f}); {rows} rows")
    # K3-f32's tile rows and block bytes as its library has them (its
    # tile rows alone where the plain version stands in, on the CPU)
    tile_rows, block_bytes = (mk.backward_f32_layout(size)
                              if x.device.type == "cuda"
                              else (mk.wgrad_tile_rows(size, False), None))
    return {"decoder_forward_f32": dict(max_abs_err=err2, shapes=k2),
            "decoder_backward_f32": dict(max_abs_err=err3, shapes=k3,
                                         tile_rows=tile_rows,
                                         block_bytes=block_bytes)}


def pad_phase(device, inp, x2_by_dim, g) -> dict:
    """Each kernel form at the decoder sizes of PAD_SIZES, which no kernel
    is built for and which it runs zero-padded to ``mlp_kernel.built_size``,
    at the tracking shape against its plain version at the unpadded size,
    with each form's tolerance: K1 on the kernel phase's K1 inputs at the
    built in_dim (each corner's first in_dim features), K2 on K1's features
    (equal to K1's outputs), K3 (full and dx-only, ``_k3_check``) on them,
    K2-f32 and K3-f32 on the first in_dim columns of the pcd features at
    the built in_dim. And the kernels at the built size, on inputs and
    params padded by ``pad_params``, return exactly 0 in every padded entry
    of dx and of each weight gradient -> {size tag: {form: largest absolute
    error}}."""
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk

    base = tuple(t[:TRACK_RAYS].contiguous()
                 for t in (inp["keys_rb"], inp["bins"], inp["z"],
                           inp["rays_o"], inp["rays_d"]))
    R, H = base[0].shape
    out = {}
    for size in PAD_SIZES:
        d = size[0]
        built = mk.built_size(size)
        fp = _decoder_at(device, size, 5)
        rb = inp["rb_by_dim"][built[0]][:TRACK_RAYS]
        rb = rb.reshape(R, H, 8, -1)[..., :d].reshape(R, H, 8 * d)
        a = (rb.contiguous(), *base, fp, inp["voxel"])
        x2 = x2_by_dim[built[0]]
        out_k, feats_k = rk.fused_render_forward(*a)
        out_p, feats_p = rk.fused_render_forward_plain(*a)
        out_2 = mk.decoder_fwd(feats_k, fp)
        torch.cuda.synchronize()
        ef = (feats_k - feats_p).abs().max().item()
        eo = (out_k - out_p).abs().max().item()
        same = torch.equal(out_2, out_k)
        log(f"pad: K1 at {size} (run at {built}): feats max_abs_err {ef:.3e} "
            f"(tol {TOL_FEATS}), out {eo:.3e} (tol {TOL_K1_OUT}); K2 on K1's "
            "feats " + ("bitwise equal to K1's out" if same else "differs"))
        if not (feats_k.shape == feats_p.shape and ef <= TOL_FEATS
                and eo <= TOL_K1_OUT and same):
            raise AssertionError(f"K1 or K2 at the padded size {size} "
                                 "disagrees with its plain version")
        errs = {"K1": max(ef, eo), "K2": eo}
        x = feats_p
        gn = g[:x.shape[0]].contiguous()
        xf = x2[:x.shape[0], :d].contiguous()
        errs["K2-f32"], _ = _k2_check(f"pad: K2-f32 at {size}", xf, fp,
                                      False, TOL_F32_FWD)
        for bf16, xn, form in ((True, x, "K3"), (False, xf, "K3-f32")):
            errs[form] = max(_k3_check(f"pad: {form} at {size}", xn, gn, fp,
                                       wgrad, bf16)[0]
                             for wgrad in (True, False))
            dx_b, gr_b = mk.decoder_bwd(mk.pad_rows(xn, built[0]), gn,
                                        mk.pad_params(fp, built), bf16=bf16)
            again = mk.pad_params(mk.unpad_params(gr_b, size), built)
            zeros = (not dx_b[:, d:].any().item()
                     and all(torch.equal(p, q) for p, q in zip(again, gr_b)))
            log(f"pad: {form} at {built} on padded inputs: every padded "
                f"entry of dx and the weight gradients exactly 0: {zeros}")
            if not zeros:
                raise AssertionError(f"{form} at {built} gives a padded "
                                     "gradient entry other than 0")
        out[_size_tag(size)] = errs
    return out


def gaussian_check(device):
    """``decoder_values`` with the Gaussian embedder at the bench decoder's
    widths and f32 operands, GAUSSIAN_ROWS rows, on the card against the
    same call on the CPU: the product ``x @ B`` runs in true f32 on the
    card (TF32 off). The same call with TF32 on is logged as the check's
    control."""
    import torch

    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.models.decoder import (_tree_map, decoder_values,
                                                    embed_input, init_decoder)

    dec = dataclasses.replace(bench_settings().decoder, embedder="gaussian",
                              matmul_dtype="f32")
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    params = init_decoder(gen, dec, device)
    x = 0.5 * torch.randn((GAUSSIAN_ROWS, dec.in_dim), generator=gen,
                          device=device)
    cpu = _tree_map(lambda a: a.cpu(), params)
    ref = decoder_values(cpu, dec, x.cpu())
    scale = ref.abs().max()

    def err(fn):
        return ((fn(params, dec, x).cpu() - ref).abs().max() / scale).item()

    e_out = err(decoder_values)
    e_emb = (embed_input(dec, params, x).cpu()
             - embed_input(dec, cpu, x.cpu())).abs().max().item()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        e_tf32 = err(decoder_values)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    st = dict(rows=GAUSSIAN_ROWS, max_rel_err_out=e_out,
              max_abs_err_embedding=e_emb, max_rel_err_out_tf32_on=e_tf32)
    log("Gaussian embedder decoder_values, card against CPU: "
        + json.dumps(st) + f" (tol {TOL_GAUSSIAN} of the largest output)")
    if not e_out <= TOL_GAUSSIAN:
        raise AssertionError("the Gaussian-embedder decoder on the card "
                             "disagrees with the CPU")
    return st


def _to(nt, device):
    return type(nt)(*[f.to(device) if hasattr(f, "to") else f for f in nt])


def pcd_render_check(r, rays_o, rays_d, device):
    """The pcd branch's ``render_rays`` and the repo's loss on the first
    RENDER_RAYS mapping rays, on the card (K2, K3 through autograd) and on
    the CPU (plain versions) from the same inputs and the same ray
    intersections: outputs and the gradients w.r.t. ray origins and
    directions (the pose), the decoder and PointNet params."""
    import torch

    from proudslam_tpu_torch.models.decoder import tree_leaves, tree_unflatten
    from proudslam_tpu_torch.render.losses import compute_loss
    from proudslam_tpu_torch.render.renderer import render_rays

    s = r["settings"]
    rnd = dataclasses.replace(s.render, feature_mode="pcd")
    n = RENDER_RAYS
    pre = [type(nt)(*[f[:n] for f in nt]) for nt in r["precomputed"]]

    def run(dev):
        o = rays_o[:n].to(dev).requires_grad_(True)
        d = rays_d[:n].to(dev).requires_grad_(True)
        tree = {**r["dec"], "pointnet": r["pn"]}
        leaves = [t.detach().to(dev).clone().requires_grad_(True)
                  for t in tree_leaves(tree)]
        view = _to(r["view"], dev)
        out = render_rays(o, d, view, view.embeddings,
                          tree_unflatten(tree, leaves), s.decoder, rnd,
                          point_store=_to(r["store"], dev),
                          precomputed=[_to(nt, dev) for nt in pre])
        loss, _ = compute_loss(out, r["gt_c"][:n].to(dev),
                               r["gt_d"][:n].to(dev), s.loss,
                               weight_depth_loss=True)
        loss.backward()
        outs = {"color": out.color, "depth": out.depth, "loss": loss,
                "hit": out.hit_mask.float().mean()}
        grads = {"d_o": o.grad, "d_d": d.grad}
        grads.update({f"param{i}": t.grad for i, t in enumerate(leaves)})
        return ({k: v.detach().cpu() for k, v in outs.items()},
                {k: v.cpu() for k, v in grads.items()})

    before = _launches()
    out_k, grad_k = run(device)
    launched = {k: v - before[k] for k, v in _launches().items()}
    out_c, grad_c = run(torch.device("cpu"))
    err_out = max((out_k[k] - out_c[k]).abs().max().item() for k in out_c)
    err_grad = max(((grad_k[k] - grad_c[k]).abs().max()
                    / grad_c[k].abs().max().clamp_min(1e-30)).item()
                   for k in grad_c)
    st = dict(rays=n, hit_share=out_c["hit"].item(),
              color_std_min=out_c["color"].std(dim=0).min().item(),
              depth_std=out_c["depth"].std().item(), max_abs_err_out=err_out,
              max_rel_err_grad=err_grad, launches=launched)
    log("pcd render_rays, card against CPU: " + json.dumps(st)
        + f" (tol {TOL_RENDER_OUT}, {TOL_RENDER_GRAD_REL} of each "
        "gradient's largest magnitude)")
    if device.type == "cuda" and launched != {
            "fused_render_forward": 0, "decoder_forward": 1,
            "decoder_backward": 1, "decoder_forward_f32": 0,
            "decoder_backward_f32": 0, "decoder_wgrad": 1,
            "decoder_wgrad_f32": 0}:
        raise AssertionError("pcd render_rays did not run K2 and K3 once")
    if not (err_out <= TOL_RENDER_OUT and err_grad <= TOL_RENDER_GRAD_REL):
        raise AssertionError("pcd render_rays on the card disagrees with "
                             "the CPU")
    return st


def refusal_check() -> dict:
    """``run_slam.check_config`` for the card accepts the fused pcd path at
    f32 operands at the reference's (16, 256, 128), where K2-f32 and K3-f32
    run their streamed plan, at a padded size, (12, 200, 72), at in_dim 32,
    (32, 256, 128), at in_dim 64, (64, 256, 128), at in_dim 48, padded to
    64, at in_dim 128, (128, 256, 128), at in_dim 100, padded to 128, at
    (16, 512, 512), at a padded wide size, (16, 300, 200), at the widest
    built size, (16, 1024, 1024), and at a padded parked size, (40, 900,
    1000); and refuses in_dim 129, width 1025 and sdf_dim 1025, which no
    built size covers, with a ``ValueError`` naming the size and the form
    (K2-f32 on that path, K1 on the fused vox path), before any data loads
    and with no kernel launched."""
    from proudslam_tpu_torch.config import load_config
    from proudslam_tpu_torch.run_slam import check_config

    over = {"tpu_specs.feature_mode": "pcd", "tpu_specs.fused_mlp": True,
            "tpu_specs.matmul_dtype": "f32",
            "decoder_specs.width": W256_SIZE[1],
            "decoder_specs.sdf_dim": W256_SIZE[2]}
    padded = {"decoder_specs.in_dim": 12, "decoder_specs.width": 200,
              "decoder_specs.sdf_dim": 72}
    path = os.path.join(ROOT, CLI_CONFIG)
    before = _launches()
    accepted = []
    wide = {"decoder_specs.width": W512_SIZE[1],
            "decoder_specs.sdf_dim": W512_SIZE[2]}
    padded_wide = {"decoder_specs.width": 300, "decoder_specs.sdf_dim": 200}
    widest = {"decoder_specs.width": W1024_SIZE[1],
              "decoder_specs.sdf_dim": W1024_SIZE[2]}
    padded_parked = {"decoder_specs.in_dim": 40, "decoder_specs.width": 900,
                     "decoder_specs.sdf_dim": 1000}
    for kv in (over, {**over, **padded},
               {**over, "decoder_specs.in_dim": D32_SIZE[0]},
               {**over, "decoder_specs.in_dim": D64_SIZE[0]},
               {**over, "decoder_specs.in_dim": 48},
               {**over, "decoder_specs.in_dim": D128_SIZE[0]},
               {**over, "decoder_specs.in_dim": 100},
               {**over, **wide}, {**over, **padded_wide},
               {**over, **widest}, {**over, **padded_parked}):
        dec = check_config(load_config(path, dict(kv)), "cuda").decoder
        accepted.append([dec.in_dim, dec.width, dec.sdf_dim])
    refused = {}
    for key, val in (("decoder_specs.in_dim", D128_SIZE[0] + 1),
                     ("decoder_specs.width", W1024_SIZE[1] + 1),
                     ("decoder_specs.sdf_dim", W1024_SIZE[2] + 1)):
        for mode, form in (("pcd", "K2-f32"), ("vox", "K1")):
            kv = {**over, "tpu_specs.feature_mode": mode, key: val}
            try:
                check_config(load_config(path, kv), "cuda")
            except ValueError as e:
                msg = str(e)
            else:
                raise AssertionError(f"check_config accepted {key}={val} on "
                                     f"the fused {mode} path")
            if form not in msg or str(val) not in msg:
                raise AssertionError(f"the refusal names no {form} or size: "
                                     f"{msg}")
            refused[f"{mode} {key}={val}"] = msg
    if _launches() != before:
        raise AssertionError("a kernel launched in check_config")
    st = {"accepted_pcd_f32": accepted, "refused": refused}
    log("refusal: " + json.dumps(st))
    return st


def render_frames():
    """The first N_FRAMES frames of the scan, quantized as the datasets
    store them (uint8 rgb, uint16 depth)."""
    scene, poses, K = _scene()
    t0 = time.perf_counter()
    # one frame a thread: numpy's array operations release the GIL
    with ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        frames = list(pool.map(lambda p: scene.render(p, WIDTH, HEIGHT, *K),
                               poses[:N_FRAMES]))
    log(f"rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s "
        "(host)")
    depth_quant = 65535.0 / 10.0
    quant = [(np.clip(c * 255.0 + 0.5, 0, 255).astype(np.uint8),
              np.clip(d * depth_quant + 0.5, 0, 65535.0).astype(np.uint16))
             for c, d in frames]
    return quant, poses, K, depth_quant


def _counters():
    """Each kernel's launch counter (an object with ``launches``), by the
    kernel's name in the kernels JSON line."""
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk

    return {"fused_render_forward": rk.fused_render_forward,
            "decoder_forward": mk.decoder_fwd,
            "decoder_backward": mk.decoder_bwd,
            "decoder_forward_f32": mk.decoder_fwd_f32,
            "decoder_backward_f32": mk.decoder_bwd_f32,
            "decoder_wgrad": mk.decoder_wgrad,
            "decoder_wgrad_f32": mk.decoder_wgrad_f32}


def _launches():
    return {k: c.launches for k, c in _counters().items()}


def _reset_launches() -> None:
    for c in _counters().values():
        c.launches = 0


def _new_slam(device, settings, frames, mesh=None, seed=0):
    """A ``SlamSystem`` for the scan's camera and frame size."""
    from proudslam_tpu_torch.engine.slam import SlamSystem

    return SlamSystem(settings, frames[2], (HEIGHT, WIDTH), seed=seed,
                      point_stride=2, device=device, mesh=mesh)


def _initialize(slam, frames) -> None:
    quant, poses, _, depth_quant = frames
    slam.initialize(quant[0][0].astype(np.float32) / 255.0,
                    quant[0][1].astype(np.float32) / depth_quant, poses[0],
                    stamp=0)


def _process(slam, frames, first: int, last: int) -> None:
    for i in range(first, last):
        slam.process_frame(i, *frames[0][i])


def _timed(fn) -> float:
    """Host seconds of ``fn()`` until the card has finished its work."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


class _FrameSequence:
    """The slice's frames as a dataset (``run_slam``'s protocol:
    ``intrinsics``, ``dataset[i] -> (i, rgb, depth, K, pose)``),
    dequantized."""

    def __init__(self, frames, n_frames):
        self.quant, self.poses, self.intrinsics, self.depth_quant = frames
        self.n = n_frames

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        c, d = self.quant[i]
        return (i, c.astype(np.float32) / 255.0,
                d.astype(np.float32) / self.depth_quant, None, self.poses[i])


def mesh_phase(slam, settings, frames, n_frames, est) -> dict:
    """``extract_mesh`` of a slice's map with colors, cleaned against the
    slice's depth cloud at the trajectory ``est``, and its accuracy and
    completion against the analytic scene (``bench.py``'s measure)."""
    from scipy.spatial import cKDTree

    from proudslam_tpu_torch.mesher import extract_mesh
    from proudslam_tpu_torch.run_slam import accumulate_depth_cloud

    seq = _FrameSequence(frames, n_frames)
    before = _launches()
    t0 = time.perf_counter()
    cloud = accumulate_depth_cloud(seq, est, 0, settings)
    cloud_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = extract_mesh(slam.map_state, slam.decoder_params, settings.map,
                        settings.decoder, res=MESH_RES, depth_points=cloud)
    mesh_s = time.perf_counter() - t0      # ends with host arrays
    launched = {k: v - before[k] for k, v in _launches().items()}
    st = dict(res=MESH_RES, cloud_points=len(cloud), cloud_ms=cloud_s * 1e3,
              mesh_ms=mesh_s * 1e3, verts=len(mesh.verts),
              faces=len(mesh.faces), launches=launched)
    if not (len(mesh.verts) and len(mesh.faces)):
        raise AssertionError(f"empty mesh: {st}")
    if mesh.colors is None or not np.isfinite(mesh.colors).all():
        raise AssertionError("mesh without finite vertex colors")
    scene = _scene()[0]
    st["acc_cm"] = float(np.mean(scene.surface_distance(mesh.verts))) * 100
    kept = np.unique(mesh.faces)
    st["acc_kept_cm"] = float(np.mean(
        scene.surface_distance(mesh.verts[kept]))) * 100
    fx, fy, cx, cy = seq.intrinsics
    ys, xs = np.mgrid[0:HEIGHT:4, 0:WIDTH:4]
    dirs = np.stack([(xs - cx) / fx, (ys - cy) / fy,
                     np.ones_like(xs, np.float32)], axis=-1)
    samples = []
    for i in range(0, n_frames, 30):
        _, _, d, _, pose = seq[i]
        pts = (dirs * d[::4, ::4, None]).reshape(-1, 3)
        pts = pts[(d[::4, ::4] > 0).reshape(-1)]
        samples.append(pts @ pose[:3, :3].T + pose[:3, 3])
    st["comp_cm"] = float(np.mean(
        cKDTree(mesh.verts).query(np.concatenate(samples))[0])) * 100
    log("mesh: " + json.dumps(st) + f" (limit {MESH_LIMIT_CM} cm)")
    if any(launched.values()):
        raise AssertionError(f"a kernel launched inside the mesh: {launched}")
    if not (st["acc_cm"] < MESH_LIMIT_CM and st["comp_cm"] < MESH_LIMIT_CM):
        raise AssertionError(f"mesh accuracy {st['acc_cm']:.2f} cm or "
                             f"completion {st['comp_cm']:.2f} cm >= "
                             f"{MESH_LIMIT_CM}")
    return st


def trained_decoder_check(settings):
    """``slice_phase``'s ``after`` for a fused pcd slice at f32 operands:
    K2-f32 and K3-f32 (full and dx-only) on the decoder the slice trained,
    against their plain versions at each form's tolerance (``_k2_check``,
    ``_k3_check``), on TRACK_RAYS x S rows of features at the pcd branch's
    scale (0.07 N(0, 1)) with 1e-2 N(0, 1) cotangents: the kernels on the
    weights the engine reached, which the branch's drift cannot blur."""
    def after(slam):
        import torch

        from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

        fp = mk.pack_params(slam.decoder_params, settings.decoder)
        fp = type(fp)(*[t.detach().contiguous() for t in fp])
        gen = torch.Generator(device=slam.device)
        gen.manual_seed(6)
        rows = TRACK_RAYS * settings.render.max_samples
        x = 0.07 * torch.randn((rows, settings.decoder.in_dim), generator=gen,
                               device=slam.device)
        g = 1e-2 * torch.randn((rows, 4), generator=gen, device=slam.device)
        what = "on the slice's trained decoder"
        e2, _ = _k2_check(f"K2-f32 {what}", x, fp, False, TOL_F32_FWD)
        e3 = max(_k3_check(f"K3-f32 {what}", x, g, fp, wgrad, False)[0]
                 for wgrad in (True, False))
        return {"trained_decoder_max_abs_err": {"K2-f32": e2, "K3-f32": e3}}
    return after


def at_size(settings, size):
    """``settings`` with the decoder size (in_dim, width, sdf_dim), the map's
    embeddings of in_dim values (as ``settings_from_config`` sets them)."""
    d, w, sd = size
    return dataclasses.replace(
        settings, map=dataclasses.replace(settings.map, embed_dim=d),
        decoder=dataclasses.replace(settings.decoder, in_dim=d, width=w,
                                    sdf_dim=sd))


def slice_phase(device, name, settings, frames, n_frames, ate_limit_cm,
                launched, not_launched, mesh=False, setup=None, after=None,
                engine_mesh=None, seed=0):
    """``initialize``, ``process_frame`` over frames 1..n_frames-1 and
    ``global_refine(rounds=2)``; the kernels in ``launched`` must have been
    launched in the run and those in ``not_launched`` not, and the
    unaligned ATE must be under ``ate_limit_cm`` (None: logged only). ``mesh``: then
    the slice's mesh (:func:`mesh_phase`). ``setup(slam)`` runs before the
    slice, ``after(slam)`` after its checks (after the launch counts are
    read), its dict joining the slice's stats. ``engine_mesh``: the
    ``SlamSystem``'s (dp, mp) mesh (``parallel/engine.py``); ``seed`` its
    seed (the decoder's and the map's initial values, the ray draws)."""
    import torch

    from proudslam_tpu_torch.utils.metrics import ate_rmse, rpe_rmse

    poses = frames[1]
    slam = _new_slam(device, settings, frames, mesh=engine_mesh, seed=seed)
    if setup is not None:
        setup(slam)
    pn0 = None
    if "pointnet" in slam.decoder_params:
        pn0 = slam.decoder_params["pointnet"]["fc"]["w"].clone()
    torch.cuda.synchronize()
    _reset_launches()
    init_s = _timed(lambda: _initialize(slam, frames))
    n_init_maps = len(slam.clock.marks["map"])
    loop_s = _timed(lambda: _process(slam, frames, 1, n_frames))
    refine_s = _timed(lambda: slam.global_refine(rounds=2))
    launches = _launches()

    est = slam.get_trajectory()
    gt = np.stack(poses[:n_frames])
    if not np.isfinite(est).all():
        raise AssertionError(f"{name} slice: non-finite poses")
    ate = ate_rmse(est, gt, align=False) * 100
    ate_al = ate_rmse(est, gt, align=True) * 100
    rpe = rpe_rmse(est, gt, delta=1) * 100
    pos_err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1) * 100
    ms = slam.clock.ms()
    n = n_frames - 1
    frame_map = ms["map"][n_init_maps:n_init_maps + n]
    stats = {
        "frames": n_frames, "fps": n / loop_s, "init_s": init_s,
        "refine_s": refine_s,
        "track_ms": float(np.mean(ms["track"])),
        "map_ms": float(np.mean(frame_map)),
        "insert_ms": float(np.mean(ms["insert"][1:])),
        "ate_cm": ate, "ate_aligned_cm": ate_al, "rpe_cm": rpe,
        "max_pos_err_cm": float(pos_err.max()),
        "num_voxels": slam.map_state.num_voxels,
        "num_cells": slam.map_state.num_cells, "num_keyframes": slam.num_kf,
        "launches": launches,
    }
    if slam.point_store is not None:
        stats["points"] = int(slam.point_store.counts.sum())
    log(f"{name} slice: " + json.dumps(stats))
    log(f"{name} slice: position error per frame (cm): "
        + " ".join(f"{e:.2f}" for e in pos_err))
    for k in launched:
        if launches[k] <= 0:
            raise AssertionError(f"{name} slice: {k} was not launched")
    for k in not_launched:
        if launches[k] != 0:
            raise AssertionError(f"{name} slice: {k} was launched")
    if slam.point_store is not None and not stats["points"] > 0:
        raise AssertionError(f"{name} slice: empty point store")
    if pn0 is not None:
        moved = (slam.decoder_params["pointnet"]["fc"]["w"] - pn0).abs().max()
        if not float(moved) > 0:
            raise AssertionError(f"{name} slice: PointNet was not trained")
    if ate_limit_cm is not None and not ate < ate_limit_cm:
        ATE_MISSES.append(
            f"{name} slice: unaligned ATE {ate:.3f} cm >= {ate_limit_cm}")
        log(f"FAILED: {ATE_MISSES[-1]} (raised after the other phases)")
    if mesh:
        stats["mesh"] = mesh_phase(slam, settings, frames, n_frames, est)
    if after is not None:
        stats.update(after(slam))
    return stats


def _view_rays(slam, n_views, gen):
    """TRACK_RAYS random pixels of each of the slice's last ``n_views``
    refined camera poses as world rays (origins, directions)."""
    import torch

    from proudslam_tpu_torch.geometry import se3

    dirs = slam.rays_dir.reshape(-1, 3)
    os_, ds_ = [], []
    for p6 in slam._refined_pose6[-n_views:]:
        pix = torch.randint(0, dirs.shape[0], (TRACK_RAYS,), generator=gen,
                            device=dirs.device)
        d = dirs[pix] @ se3.exp_rotation(p6[3:6]).T
        ds_.append(d)
        os_.append(p6[0:3].expand_as(d))
    return torch.cat(os_).contiguous(), torch.cat(ds_).contiguous()


def _dda_against_brute(got, want, rays_d, spacing) -> dict:
    """The grid march's hits ``got`` against the brute slab test's ``want``
    (see TOL_DDA_DEPTH)."""
    import torch

    wi, gi = want.voxel_idx, got.voxel_idx
    brute = wi >= 0
    match = (wi[:, :, None] == gi[:, None, :]) & brute[:, :, None]
    missed = brute & ~match.any(-1)
    # a hit of the march's own is a voxel past the brute list's last one,
    # where a ray has more hits than the list holds: after a missed graze
    # the march takes the next voxel
    extra = (gi >= 0) & ~match.any(1)
    past = brute.all(-1, keepdim=True) & (
        got.t_near >= want.t_near[:, -1:] - TOL_DDA_DEPTH)
    chord = (want.t_far - want.t_near) * rays_d.norm(dim=-1, keepdim=True)
    expected = torch.where(brute, (1.0 - chord / spacing).clamp_min(0.0),
                           0.0).sum().item()

    def depth_err(a, b):
        diff = (a[:, :, None] - b[:, None, :]).abs()
        return torch.where(match, diff, 0.0).max().item()

    grazes = int(missed.sum())
    return dict(
        rays=wi.shape[0], brute_hit_slots=int(brute.sum()),
        dda_hit_slots=int((gi >= 0).sum()), grazes=grazes,
        graze_share_of_hit_slots=grazes / max(int(brute.sum()), 1),
        graze_share_of_slots=grazes / wi.numel(),
        grazes_expected=expected, grazes_over_expected=grazes / max(
            expected, 1e-9),
        brute_hits_with_chord_under_spacing=int((brute & (chord < spacing))
                                                .sum()),
        max_missed_chord=chord[missed].max().item() if grazes else 0.0,
        dda_hits_past_brute_list=int((extra & past).sum()),
        dda_hits_not_in_brute=int((extra & ~past).sum()),
        max_t_near_err=depth_err(want.t_near, got.t_near),
        max_t_far_err=depth_err(want.t_far, got.t_far),
        dda_sorted=bool((got.t_near[:, 1:] - got.t_near[:, :-1] >= -1e-5)
                        .all()))


def dda_checks(slam) -> dict:
    """On the dda slice's final map: ``build_occupancy``'s live voxels
    dropped as outside ``grid_dims`` (must be 0); ``ray_intersect_dda``
    against the brute ``ray_intersect`` at the tracking and mapping shapes
    (TOL_DDA_DEPTH), with CUDA-event times of the three functions, the
    comparison timed by the port's ``Profiler``; and, on TRACK_RAYS rays,
    ``gather_ray_features`` (GatherF8, segment-sum backward) against
    ``gather_ray_features_onehot``, values and embedding gradients."""
    import torch

    from proudslam_tpu_torch.ops.interp import (gather_ray_features,
                                                gather_ray_features_onehot)
    from proudslam_tpu_torch.ops.intersect import (build_occupancy,
                                                   ray_intersect,
                                                   ray_intersect_dda)
    from proudslam_tpu_torch.ops.voxel_hash import unpack_key
    from proudslam_tpu_torch.render.renderer import intersect_and_sample
    from proudslam_tpu_torch.utils.profiler import Profiler

    rs = slam.settings.render
    view = slam._render_view()
    keys, nv = view.voxel_keys, view.num_voxels
    occ = build_occupancy(keys, nv, rs)
    dropped = nv - int((occ >= 0).sum())
    centers = (unpack_key(keys).float() + 0.5) * rs.voxel_size
    live = torch.ones(nv, dtype=torch.bool, device=keys.device)
    spacing = rs.dda_step_frac * rs.voxel_size
    gen = torch.Generator(device=keys.device)
    gen.manual_seed(5)
    o5, d5 = _view_rays(slam, 5, gen)
    prof = Profiler(device=keys.device)
    prof.enable()
    shapes = {}
    for shape, n in (("tracking", TRACK_RAYS), ("mapping", 5 * TRACK_RAYS)):
        o, d = o5[-n:].contiguous(), d5[-n:].contiguous()
        prof.tick(f"dda_vs_brute_{shape}")
        got = ray_intersect_dda(o, d, keys, nv, rs, occupancy=occ)
        want = ray_intersect(o, d, centers, live, rs)
        st = _dda_against_brute(got, want, d, spacing)
        prof.tok(f"dda_vs_brute_{shape}")
        st.update(
            build_occupancy_ms=_event_ms(
                lambda: build_occupancy(keys, nv, rs)),
            ray_intersect_dda_ms=_event_ms(
                lambda: ray_intersect_dda(o, d, keys, nv, rs, occupancy=occ)),
            ray_intersect_ms=_event_ms(
                lambda: ray_intersect(o, d, centers, live, rs)))
        shapes[shape] = st
        log(f"dda against brute at the {shape} shape: " + json.dumps(st)
            + f" (misses must be grazes, chord < {spacing:.3f} m; depths "
            f"<= {TOL_DDA_DEPTH}; grazes within {DDA_GRAZE_BAND:.0%} of the "
            "random-phase expectation)")
    # the one-hot oracle of the gather on TRACK_RAYS rays of the same map
    o, d = o5[:TRACK_RAYS], d5[:TRACK_RAYS]
    H, S = rs.max_hits, rs.max_samples
    noise = torch.rand((TRACK_RAYS, S - H), generator=gen, device=o.device)
    inter, samples = intersect_and_sample(o, d, view, rs, noise, occ)
    valid = samples.voxel_idx >= 0
    bins = torch.where(valid, samples.bin, H)
    xyz = o[:, None, :] + d[:, None, :] * samples.depth[..., None]
    emb0 = slam.map_state.embeddings.detach()
    cot = torch.randn((TRACK_RAYS, S, emb0.shape[1]), generator=gen,
                      device=o.device) * valid[..., None]
    res = {}
    for name, fn in (("gather", gather_ray_features),
                     ("onehot", gather_ray_features_onehot)):
        e = emb0.clone().requires_grad_(True)
        f = fn(xyz, bins, inter.voxel_idx, view.voxel_keys,
               view.voxel_vertex_ids, e, rs.voxel_size)
        (f * cot).sum().backward()
        res[name] = (f.detach()[valid], e.grad)
    (fg, gg), (fo, go) = res["gather"], res["onehot"]
    oracle = dict(rays=TRACK_RAYS, valid_samples=int(valid.sum()),
                  max_rel_err_values=((fg - fo).abs().max()
                                      / fo.abs().max()).item(),
                  max_rel_err_embedding_grad=((gg - go).abs().max()
                                              / go.abs().max()).item())
    log("gather_ray_features against the one-hot oracle: "
        + json.dumps(oracle) + f" (tol {TOL_ONEHOT} of each one's largest "
        "magnitude)")
    out = dict(occupancy_dropped=dropped, intersect=shapes,
               onehot_oracle=oracle, profiler=prof.summary())
    log(f"dda checks: build_occupancy dropped {dropped} live voxels of {nv}; "
        "Profiler: " + json.dumps(out["profiler"]))
    if dropped:
        raise AssertionError(f"build_occupancy dropped {dropped} voxels")
    for shape, st in shapes.items():
        if not (st["max_missed_chord"] < spacing + 1e-5
                and st["dda_hits_not_in_brute"] == 0 and st["dda_sorted"]
                and st["max_t_near_err"] <= TOL_DDA_DEPTH
                and st["max_t_far_err"] <= TOL_DDA_DEPTH
                and abs(st["grazes_over_expected"] - 1.0) <= DDA_GRAZE_BAND
                and st["brute_hit_slots"] > st["rays"]):
            raise AssertionError(f"dda against brute at the {shape} shape")
    if not (oracle["max_rel_err_values"] <= TOL_ONEHOT
            and oracle["max_rel_err_embedding_grad"] <= TOL_ONEHOT):
        raise AssertionError("gather_ray_features disagrees with the one-hot "
                             "oracle")
    return {"dda_checks": out}


class _WindowLog:
    """Records each window the engine draws during a slice, and whether the
    covisibility rule drew it (more committed keyframes than the window
    holds, and lagged angles present)."""

    def __init__(self):
        self.windows = []

    def setup(self, slam):
        draw = slam._select_window

        def recording():
            sel, valid = draw()
            covis = (slam.num_kf > slam.settings.mapper.window_size
                     and slam._covis_host is not None)
            self.windows.append(dict(num_kf=slam.num_kf, covis=covis,
                                     window=sel))
            return sel, valid
        slam._select_window = recording

    def after(self, slam):
        drawn = [w for w in self.windows if w["covis"]]
        st = dict(windows=len(self.windows), covis_drawn=len(drawn),
                  first_covis_frame=(self.windows.index(drawn[0]) + 1
                                     if drawn else None),
                  covis_windows=[w["window"] for w in drawn])
        log("window slice: " + json.dumps(st)
            + f" (at least {WINDOW_MIN_DRAWS} drawn by the covisibility rule)")
        if len(drawn) < WINDOW_MIN_DRAWS:
            raise AssertionError(f"window slice: {len(drawn)} windows drawn "
                                 "by the covisibility rule")
        return {"covis": st}


def _read_ply(path):
    """(verts (N, 3), faces (M, 3)) of an ASCII PLY as ``save_ply``
    writes it."""
    with open(path) as f:
        head, body = f.read().split("end_header\n")
    nv = int(head.split("element vertex ")[1].split()[0])
    nf = int(head.split("element face ")[1].split()[0])
    lines = body.splitlines()
    if len(lines) != nv + nf:
        raise AssertionError(f"{path}: {len(lines)} lines for {nv} vertices "
                             f"and {nf} faces")
    verts = np.array([ln.split()[:3] for ln in lines[:nv]], np.float64)
    faces = np.array([ln.split()[1:] for ln in lines[nv:]], np.int64)
    return verts.reshape(-1, 3), faces.reshape(-1, 3)


def _png_size(path):
    """(width, height) of a PNG from its IHDR chunk, after checking that
    its pixel data decompresses to that size (8-bit RGB rows with a filter
    byte, as the port's logger writes them)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    if len(zlib.decompress(idat)) != h * (1 + 3 * w):
        raise AssertionError(f"{path}: pixel data does not match {w}x{h}")
    return w, h


def cli_phase(device, name, overrides=(), launched=(), panels=(),
              mesh=True, ate_limit_cm=CLI_ATE_LIMIT_CM, config=None):
    """``run_slam.main`` on ``config`` (``configs/synthetic/room.yaml`` by
    default, with the config ``overrides``) into a temporary log directory:
    artifacts (the panels
    ``imgs/render_<frame>.png`` of the frames in ``panels``, the mesh when
    ``mesh``), the kernels in ``launched`` launched and no other, the ATE
    limit (none when ``ate_limit_cm`` is None), and the checkpoint reloaded
    to the saved trajectory bit for bit."""
    import tempfile

    import torch

    from proudslam_tpu_torch.config import load_config, settings_from_config
    from proudslam_tpu_torch.engine.slam import SlamSystem
    from proudslam_tpu_torch.run_slam import main as run_slam_main
    from proudslam_tpu_torch.run_slam import parse_overrides
    from proudslam_tpu_torch.utils.checkpoint import load_checkpoint

    config = config or os.path.join(ROOT, CLI_CONFIG)
    flags = [o for o in overrides if o == "--no-mesh"]
    keyed = [o for o in overrides if o != "--no-mesh"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as logs:
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        res = run_slam_main([config, "--log_dir", logs, "--device",
                             str(device), *overrides])
        wall_s = time.perf_counter() - t0
        launches = _launches()
        run = res["dir"]
        need = ["misc/frame_poses.npy", "ckpt/final_ckpt.npz",
                "ckpt/final_ckpt.meta.json", "metrics.jsonl"]
        need += ["mesh/final_mesh.ply"] if mesh else []
        need += [f"imgs/render_{i:05d}.png" for i in panels]
        paths = {k: os.path.join(run, *k.split("/")) for k in need}
        missing = [k for k, p in paths.items() if not os.path.exists(p)]
        if missing:
            raise AssertionError(f"{name}: missing artifacts {missing}")
        written = sorted(os.listdir(os.path.join(run, "imgs")))
        if written != sorted(f"render_{i:05d}.png" for i in panels):
            raise AssertionError(f"{name}: panels {written}")
        sizes = {os.path.basename(p): _png_size(p) for k, p in paths.items()
                 if k.startswith("imgs/")}
        poses = np.load(paths["misc/frame_poses.npy"])
        if mesh:
            verts, faces = _read_ply(paths["mesh/final_mesh.ply"])
            if not (len(verts) and len(faces) and np.isfinite(verts).all()):
                raise AssertionError(f"{name}: empty or non-finite mesh")
        with open(paths["metrics.jsonl"]) as f:
            metrics = [json.loads(ln) for ln in f]
        cfg = load_config(config, parse_overrides(keyed))
        fresh = SlamSystem(settings_from_config(cfg),
                           res["intrinsics"], tuple(res["image_hw"]), seed=1,
                           device=device)
        load_checkpoint(paths["ckpt/final_ckpt.npz"], fresh)
        reloaded = fresh.get_trajectory()
    same = reloaded.shape == poses.shape and np.array_equal(reloaded, poses)
    keys = ["frames", "skipped", "fps", "init_s", "loop_s", "refine_s",
            "track_ms", "map_ms", "insert_ms", "ate_cm", "ate_aligned_cm",
            "num_voxels", "num_keyframes"]
    keys += ["mesh_s", "mesh_verts", "mesh_faces"] if mesh else []
    st = {k: res[k] for k in keys}
    st.update(wall_s=wall_s, launches=launches, flags=flags,
              overrides=keyed, panel_sizes=sizes,
              metrics_ate_cm=metrics[-1].get("ate_rmse_cm"),
              checkpoint_trajectory_bitwise=same)
    log(f"{name}: " + json.dumps(st) + f" (ATE limit {ate_limit_cm} cm)")
    for k, v in launches.items():
        if (k in launched) != (v > 0):
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{list(launched) or 'none'}")
    if any(wh != PANEL_WH for wh in sizes.values()):
        raise AssertionError(f"{name}: panel sizes {sizes}, expected "
                             f"{PANEL_WH}")
    if not (poses.shape == (res["frames"] + 1, 4, 4)
            and np.isfinite(poses).all()):
        raise AssertionError(f"{name}: trajectory {poses.shape}")
    if not same:
        raise AssertionError(f"{name}: the reloaded checkpoint's trajectory "
                             "differs from frame_poses.npy")
    if ate_limit_cm is not None and not st["ate_cm"] < ate_limit_cm:
        raise AssertionError(f"{name}: unaligned ATE {st['ate_cm']:.3f} cm "
                             f">= {ate_limit_cm}")
    return st


def cli_embed_phase(device):
    """``run_slam.main`` on a YAML derived from room.yaml with the NeRF
    embedder (4 frequencies) and a skip after the first layer (a list
    value: the command line cannot set it), CLI_EMBED_FRAMES frames and a
    mesh: the plain decoder only (no kernel takes an embedder), the
    checkpoint reloaded bit for bit, the ATE logged without a bound."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_embed_") as tmp:
        path = os.path.join(tmp, "room_nerf.yaml")
        with open(path, "w") as f:
            f.write(f"base_config: {os.path.join(ROOT, CLI_CONFIG)}\n"
                    "decoder_specs:\n  embedder: nerf\n  multires: 4\n"
                    "  skips: [0]\n")
        return cli_phase(device, "cli-embed",
                         ("--data_specs.num_frames", str(CLI_EMBED_FRAMES)),
                         ate_limit_cm=None, config=path)


def _schur_problem(device):
    """``tests/test_schur.py``'s problem, drawn with torch: a 7x7 wall of
    points at z = 1.05, D = 8 embeddings ~ 0.05 N(0, 1), a 32-wide decoder,
    3 poses ~ 0.01 N(0, 1) with slot 0 anchored, 64 rays each."""
    import torch

    from proudslam_tpu_torch.config import (DecoderSettings, MapSettings,
                                            RenderSettings, SystemSettings)
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops import voxel_hash as vh

    settings = SystemSettings(
        render=RenderSettings(voxel_size=0.2, step_size=0.02, max_hits=8,
                              max_samples=40),
        map=MapSettings(voxel_size=0.2, num_embeddings=256, embed_dim=8,
                        voxel_capacity=256, frame_voxel_capacity=128),
        decoder=DecoderSettings(width=32, sdf_dim=16, in_dim=8))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = vh.init_map_state(settings.map, gen, device)
    xs, ys = np.meshgrid(np.arange(-3, 4), np.arange(-3, 4))
    pts = np.stack([xs.ravel() * 0.2 + 0.1, ys.ravel() * 0.2 + 0.1,
                    np.full(xs.size, 1.05)], axis=-1)
    state = vh.insert_points(
        state, torch.as_tensor(pts, dtype=torch.float32, device=device),
        torch.ones((len(pts),), dtype=torch.bool, device=device),
        settings.map)
    state = state._replace(embeddings=0.05 * torch.randn(
        state.embeddings.shape, generator=gen, device=device))
    params = init_decoder(gen, settings.decoder, device)
    K, N = 3, 64
    SJ = settings.render.max_samples - settings.render.max_hits
    dirs = torch.cat([0.3 * torch.randn((K, N, 2), generator=gen,
                                        device=device),
                      torch.ones((K, N, 1), device=device)], dim=-1)
    gt_d = 1.0 + 0.1 * torch.rand((K, N), generator=gen, device=device)
    noise = torch.rand((K, N, SJ), generator=gen, device=device)
    poses = 0.01 * torch.randn((K, 6), generator=gen, device=device)
    anchor = torch.tensor([True, False, False], device=device)
    return settings, state, params, (poses, dirs, gt_d, noise, anchor)


def parallel_forms(device) -> dict:
    """``dryrun_multichip(1)`` (the engine on a mesh against the plain
    engine, the sharded, spatial and Schur BA steps, the map stored over
    the ranks; each with its own assertions) and the Schur step against
    its dense joint solve on ``tests/test_schur.py``'s problem."""
    import torch

    from proudslam_tpu_torch.parallel.dryrun import dryrun_multichip
    from proudslam_tpu_torch.parallel.schur import (dense_gn_reference,
                                                    make_schur_gn_step)
    from proudslam_tpu_torch.parallel.spatial import make_joint_mesh

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        dryrun_multichip(1, device=device)
    st = {"dryrun_s": time.perf_counter() - t0}
    settings, state, params, (poses, dirs, gt_d, noise, anchor) = \
        _schur_problem(device)
    t0 = time.perf_counter()
    res = make_schur_gn_step(make_joint_mesh(1, device=device), settings,
                             damping=SCHUR_DAMPING)(
        state, params, poses, dirs, gt_d, noise, anchor)
    torch.cuda.synchronize()
    st["schur_s"] = time.perf_counter() - t0
    d_emb, d_poses, r_norm = dense_gn_reference(
        state, params, poses, dirs, gt_d, noise, settings, anchor,
        damping=SCHUR_DAMPING)
    got_emb, got_poses = res.d_emb.cpu().numpy(), res.d_poses.cpu().numpy()
    st.update(
        schur_r_norm=float(res.r_norm), dense_r_norm=r_norm,
        schur_pose_err=float(np.abs(got_poses - d_poses).max()),
        schur_emb_err=float(np.abs(got_emb - d_emb).max()),
        dense_pose_max=float(np.abs(d_poses).max()),
        dense_emb_max=float(np.abs(d_emb).max()))
    log("parallel forms: " + json.dumps(st) + f" (Schur against the dense "
        f"solve: |r| rtol {SCHUR_RTOL}, updates atol {SCHUR_ATOL})")
    if not (np.isfinite(got_emb).all() and np.isfinite(got_poses).all()):
        raise AssertionError("parallel: non-finite Schur step")
    if not (abs(st["schur_r_norm"] - r_norm) <= SCHUR_RTOL * r_norm
            and st["schur_pose_err"] <= SCHUR_ATOL
            and st["schur_emb_err"] <= SCHUR_ATOL):
        raise AssertionError(f"parallel: the Schur step disagrees with its "
                             f"dense solve: {st}")
    if not (st["dense_pose_max"] > 1e-6 and st["dense_emb_max"] > 1e-6
            and np.allclose(got_poses[0], 0.0)):
        raise AssertionError(f"parallel: trivial or unanchored step: {st}")
    return st


def parallel_phase(device, settings, frames) -> dict:
    """The vox configuration's ``SlamSystem`` on a (1, 1) engine mesh over
    a real NCCL process group of one rank (the card is one device, and
    NCCL takes one rank per device), on the first PARALLEL_FRAMES frames
    and ``global_refine(rounds=2)``: K1 and K3 launched on this path, the
    unaligned ATE under 3 cm, the trajectory held against the plain
    engine's on the same frames; then :func:`parallel_forms`. The process
    group is destroyed before the phase returns."""
    import socket

    import torch
    import torch.distributed as dist

    from proudslam_tpu_torch.parallel import distributed
    from proudslam_tpu_torch.parallel.engine import make_engine_mesh

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    log("parallel: world size 1 on cuda:0 over NCCL: one card is one rank "
        "(NCCL refuses two ranks on one device); the semantics across 2 and "
        "4 ranks are held on the CPU by tests/test_torch_parallel_*.py")
    plain = _new_slam(device, settings, frames)
    plain_init_s = _timed(lambda: _initialize(plain, frames))
    plain_loop_s = _timed(lambda: _process(plain, frames, 1, PARALLEL_FRAMES))
    plain.global_refine(rounds=2)
    plain_est = plain.get_trajectory()
    del plain
    distributed.initialize(f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                           device=device)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"parallel: backend {dist.get_backend()}")
        mesh = make_engine_mesh(1, mp=1)

        def after(slam):
            est = slam.get_trajectory()
            dt = np.linalg.norm(est[:, :3, 3] - plain_est[:, :3, 3], axis=-1)
            st = {"backend": dist.get_backend(), "world_size":
                  dist.get_world_size(), "mesh": mesh.shape,
                  "plain_init_s": plain_init_s,
                  "plain_fps": (PARALLEL_FRAMES - 1) / plain_loop_s,
                  "traj_max_diff_m": float(dt.max()),
                  "traj_bitwise_equal": bool(np.array_equal(est, plain_est))}
            log("parallel against the plain engine: " + json.dumps(st)
                + f" (tolerance {PARALLEL_TRAJ_TOL_M} m)")
            if not dt.max() <= PARALLEL_TRAJ_TOL_M:
                raise AssertionError(f"parallel: trajectory {dt.max()} m "
                                     "from the plain engine's")
            st["forms"] = parallel_forms(device)
            return st

        return slice_phase(
            device, "parallel", settings, frames, PARALLEL_FRAMES,
            ATE_LIMIT_CM, launched=VOX_KERNELS,
            not_launched=("decoder_forward", "decoder_forward_f32",
                          "decoder_backward_f32", "decoder_wgrad_f32"),
            after=after, engine_mesh=mesh)
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()


def profile_phase(device, settings, frames, start=PROFILE_START,
                  count=PROFILE_FRAMES):
    """Where the vox slice's device time goes: ``torch.profiler`` over
    ``count`` frames after ``start - 1`` unprofiled ones. Each phase of the
    engine's clock (track, map, insert) is also a profiler range; on the
    device timeline a phase spans its range, is busy for the kernels that
    start inside it, and idle otherwise. Also the top kernels' shares of
    all busy time, and the host's CPU time in profiled operators and in
    ``cudaLaunchKernel``. The profiler slows the host, so the phases'
    spans (and idle shares) are upper bounds of the unprofiled run's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from proudslam_tpu_torch.engine.slam import PhaseClock

    class RangedClock(PhaseClock):
        @contextlib.contextmanager
        def phase(self, name):
            with record_function(f"phase:{name}"), super().phase(name):
                yield

    slam = _new_slam(device, settings, frames)
    slam.clock = RangedClock(device)
    _initialize(slam, frames)
    _timed(lambda: _process(slam, frames, 1, start))
    _reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s = _timed(lambda: _process(slam, frames, start, start + count))
    launches = _launches()
    # device-timeline events: the phases' ranges (GPU annotations) and the
    # kernels; a kernel belongs to the phase whose range holds its start
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    windows = [(e.name[len("phase:"):], e.time_range.start, e.time_range.end)
               for e in evs if e.name.startswith("phase:")]
    kernels = [e for e in evs if not e.name.startswith("phase:")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    phases = {}
    for name, t0_us, t1_us in windows:
        ph = phases.setdefault(name, dict(span_us=0.0, busy_us=0.0,
                                          kernels=0))
        ph["span_us"] += t1_us - t0_us
        for e in kernels:
            if t0_us <= e.time_range.start < t1_us:
                ph["busy_us"] += e.time_range.elapsed_us()
                ph["kernels"] += 1
    by_name = {}
    for e in kernels:
        k = by_name.setdefault(e.name, [0.0, 0])
        k[0] += e.time_range.elapsed_us()
        k[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    # the host: CPU time of every profiled operator, and the launches
    host = prof.key_averages()
    cpu_us = sum(e.self_cpu_time_total for e in host)
    launch = [e for e in host if e.key == "cudaLaunchKernel"]
    st = dict(frames=[start, start + count - 1],
              wall_ms_per_frame_profiled=wall_s * 1e3 / count,
              host_cpu_ms_per_frame=cpu_us / 1e3 / count,
              cuda_launch_kernel_per_frame=dict(
                  calls=sum(e.count for e in launch) / count,
                  cpu_ms=sum(e.self_cpu_time_total for e in launch) / 1e3
                  / count),
              device_busy_ms_per_frame=busy_us / 1e3 / count,
              kernel_launches_per_frame=len(kernels) / count,
              phases={name: dict(
                  device_span_ms_per_frame=ph["span_us"] / 1e3 / count,
                  device_busy_ms_per_frame=ph["busy_us"] / 1e3 / count,
                  idle_share=1.0 - ph["busy_us"] / max(ph["span_us"], 1e-9),
                  kernels_per_frame=ph["kernels"] / count)
                  for name, ph in phases.items()},
              launches=launches,
              top_kernels=[dict(name=name[:80], share=us / max(busy_us, 1e-9),
                                ms_per_frame=us / 1e3 / count,
                                calls_per_frame=n / count)
                           for name, (us, n) in top])
    log("vox profile: " + json.dumps(st))
    if not busy_us > 0:
        raise AssertionError("the profile saw no device time")
    return st


def size_table(record) -> None:
    """One log line per kernel and streamed decoder size: its times at the
    mapping and tracking shapes with the bound's share, the plain version's
    and the matmul chain's times, its error against the plain version, and
    its build (registers, spills, HGMMA / HMMA / FFMA counts; K3-f32's
    tile rows and a block's shared-memory bytes)."""
    for k in record["kernels"]:
        for tag, st in k.get("sizes", {}).items():
            b = k["build_by_size"].get(tag, {})
            row = {"max_abs_err": st["max_abs_err"], **{
                key: b.get(key) for key in ("registers", "spill_stores",
                                            "HGMMA", "HMMA", "FFMA")},
                   **{key: st[key] for key in ("tile_rows", "block_bytes")
                      if key in st}}
            for shape, sh in st["shapes"].items():
                row[shape] = {key: sh.get(key) for key in (
                    "ms", "share", "bound_ms", "plain_ms", "matmul_chain_ms",
                    "dx_only_ms", "pass1_ms", "pass2_ms", "wgrad_gb")}
            log(f"size table: {k['name']} at {tag}: {json.dumps(row)}")


def main() -> None:
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    smi = device_phase()
    import torch

    try:
        import proudslam_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the port package is missing: {e}")
    from proudslam_tpu_torch.config import bench_settings

    device = torch.device("cuda", 0)
    log(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    phase_s, t_mark = {}, [time.perf_counter()]

    def mark(name):
        """Seconds since the last mark, kept as phase ``name``."""
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now
    build_s, built, built_by_size = build_phase()
    log(f"build: {build_s:.1f} s")
    mark("build")
    kern = kernel_phase(device)
    kern["extra"]["gaussian_embedder"] = gaussian_check(device)
    mark("kernels")
    frames = render_frames()
    mark("frames")
    vox = bench_settings()
    bf16_kernels = ("fused_render_forward", "decoder_forward",
                    "decoder_backward", "decoder_wgrad")
    f32_kernels = ("decoder_forward_f32", "decoder_backward_f32",
                   "decoder_wgrad_f32")
    stats = {"vox": slice_phase(
        device, "vox", vox, frames, N_FRAMES, ATE_LIMIT_CM,
        launched=VOX_KERNELS,
        not_launched=("decoder_forward",) + f32_kernels, mesh=True)}
    stats["vox-w256"] = slice_phase(
        device, "vox-w256", at_size(vox, W256_SIZE), frames, W256_FRAMES,
        ATE_LIMIT_CM, launched=VOX_KERNELS,
        not_launched=("decoder_forward",) + f32_kernels)
    stats["vox-d32"] = slice_phase(
        device, "vox-d32", at_size(vox, D32_SIZE), frames, D32_FRAMES,
        ATE_LIMIT_CM, launched=VOX_KERNELS,
        not_launched=("decoder_forward",) + f32_kernels)
    stats["vox-w512"] = slice_phase(
        device, "vox-w512", at_size(vox, W512_SIZE), frames, W512_FRAMES,
        ATE_LIMIT_CM, launched=VOX_KERNELS,
        not_launched=("decoder_forward",) + f32_kernels)
    stats["vox-w1024"] = slice_phase(
        device, "vox-w1024", at_size(vox, W1024_SIZE), frames, W1024_FRAMES,
        ATE_LIMIT_CM, launched=VOX_KERNELS,
        not_launched=("decoder_forward",) + f32_kernels)
    stats["vox-d64"] = slice_phase(
        device, "vox-d64", at_size(vox, D64_SIZE), frames, D64_FRAMES,
        ATE_LIMIT_CM, launched=VOX_KERNELS,
        not_launched=("decoder_forward",) + f32_kernels)
    stats["vox-d128"] = slice_phase(
        device, "vox-d128", at_size(vox, D128_SIZE), frames, D128_FRAMES,
        ATE_LIMIT_CM, launched=VOX_KERNELS,
        not_launched=("decoder_forward",) + f32_kernels)
    kern["extra"]["refusal"] = refusal_check()
    mark("vox slices")
    pcd = dataclasses.replace(
        vox, render=dataclasses.replace(vox.render, feature_mode="pcd"),
        map=dataclasses.replace(vox.map, points_per_voxel=8))
    stats["pcd"] = slice_phase(
        device, "pcd", pcd, frames, PCD_FRAMES, PCD_ATE_LIMIT_CM,
        launched=("decoder_forward", "decoder_backward", "decoder_wgrad"),
        not_launched=("fused_render_forward",) + f32_kernels)
    pcd_f32 = dataclasses.replace(pcd, decoder=dataclasses.replace(
        pcd.decoder, matmul_dtype="f32"))
    stats["pcd-f32"] = slice_phase(
        device, "pcd-f32", pcd_f32, frames, PCD_FRAMES, PCD_ATE_LIMIT_CM,
        launched=f32_kernels, not_launched=bf16_kernels)
    pcd_f32_w256 = at_size(pcd_f32, W256_SIZE)
    stats["pcd-f32-w256"] = slice_phase(
        device, "pcd-f32-w256", pcd_f32_w256, frames, PCD_FRAMES,
        PCD_W256_ATE_LIMIT_CM, launched=f32_kernels,
        not_launched=bf16_kernels, after=trained_decoder_check(pcd_f32_w256))
    pcd_f32_d32 = at_size(pcd_f32, D32_SIZE)
    stats["pcd-f32-d32"] = slice_phase(
        device, "pcd-f32-d32", pcd_f32_d32, frames, PCD_FRAMES,
        PCD_W256_ATE_LIMIT_CM, launched=f32_kernels,
        not_launched=bf16_kernels, after=trained_decoder_check(pcd_f32_d32))
    pcd_f32_w512 = at_size(pcd_f32, PCD_W512_SIZE)
    stats["pcd-f32-w512"] = slice_phase(
        device, "pcd-f32-w512", pcd_f32_w512, frames, PCD_FRAMES,
        PCD_W256_ATE_LIMIT_CM, launched=f32_kernels,
        not_launched=bf16_kernels, after=trained_decoder_check(pcd_f32_w512))
    pcd_f32_d64 = at_size(pcd_f32, D64_SIZE)
    stats["pcd-f32-d64"] = slice_phase(
        device, "pcd-f32-d64", pcd_f32_d64, frames, PCD_FRAMES,
        PCD_W256_ATE_LIMIT_CM, launched=f32_kernels,
        not_launched=bf16_kernels, after=trained_decoder_check(pcd_f32_d64))
    pcd_f32_d128 = at_size(pcd_f32, D128_SIZE)
    stats["pcd-f32-d128"] = slice_phase(
        device, "pcd-f32-d128", pcd_f32_d128, frames, PCD_FRAMES,
        PCD_W256_ATE_LIMIT_CM, launched=f32_kernels,
        not_launched=bf16_kernels, after=trained_decoder_check(pcd_f32_d128))
    mark("pcd slices")
    resample = dataclasses.replace(
        vox, render=dataclasses.replace(vox.render, pixel_sampler="gumbel"),
        tracker=dataclasses.replace(vox.tracker, fixed_sample_batch=False),
        mapper=dataclasses.replace(vox.mapper, fixed_sample_batch=False))
    stats["resample"] = slice_phase(
        device, "resample", resample, frames, RESAMPLE_FRAMES, ATE_LIMIT_CM,
        launched=VOX_KERNELS,
        not_launched=("decoder_forward",) + f32_kernels)
    log("resample against the fixed-batch vox slice: " + json.dumps(
        {k: {p: stats[p][k] for p in ("vox", "resample")}
         for k in ("frames", "fps", "init_s", "track_ms", "map_ms",
                   "insert_ms", "ate_cm")}))
    dda = dataclasses.replace(vox, render=dataclasses.replace(
        vox.render, intersect_mode="dda"))
    stats["dda"] = slice_phase(
        device, "dda", dda, frames, DDA_FRAMES, ATE_LIMIT_CM,
        launched=VOX_KERNELS,
        not_launched=("decoder_forward",) + f32_kernels, after=dda_checks)
    log("dda against the brute vox slice: " + json.dumps(
        {k: {p: stats[p][k] for p in ("vox", "dda")}
         for k in ("frames", "fps", "init_s", "refine_s", "track_ms",
                   "map_ms", "insert_ms", "ate_cm", "ate_aligned_cm")}))
    window = dataclasses.replace(vox, mapper=dataclasses.replace(
        vox.mapper, covis_angle_deg=WINDOW_ANGLE, keyframe_gap=WINDOW_GAP))
    wlog = _WindowLog()
    stats["window"] = slice_phase(
        device, "window", window, frames, WINDOW_FRAMES, ATE_LIMIT_CM,
        launched=VOX_KERNELS,
        not_launched=("decoder_forward",) + f32_kernels, setup=wlog.setup,
        after=wlog.after)
    mark("resample, dda, window slices")
    profile = profile_phase(device, vox, frames)
    mark("profile")
    stats["cli"] = cli_phase(
        device, "cli", ("--debug_args.render_freq", str(CLI_RENDER_FREQ),
                        "--data_specs.num_frames", str(CLI_FRAMES)),
        panels=range(CLI_RENDER_FREQ - 1, CLI_FRAMES, CLI_RENDER_FREQ))
    stats["cli-pcd"] = cli_phase(
        device, "cli-pcd", ("--tpu_specs.feature_mode", "pcd",
                            "--tpu_specs.fused_mlp", "true",
                            "--data_specs.num_frames", str(PCD_CLI_FRAMES),
                            "--no-mesh"),
        launched=f32_kernels, mesh=False, ate_limit_cm=None)
    stats["cli-embed"] = cli_embed_phase(device)
    mark("cli")
    # last: the NCCL process group lives only inside this phase
    stats["parallel"] = parallel_phase(device, vox, frames)
    mark("parallel")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    mlp = "proudslam_tpu/ops/pallas/mlp_kernel.py"
    csrc = "proudslam_tpu_torch/csrc"
    meta = {
        "fused_render_forward": (
            "render_kernel", "proudslam_tpu/ops/pallas/render_kernel.py:63",
            None, "render_forward_kernel"),
        "decoder_forward": (
            "mlp_kernel", f"{mlp}:132", "bf16=True", "decoder_forward_kernel"),
        "decoder_backward": (
            "mlp_kernel", f"{mlp}:141", "bf16=True",
            "decoder_backward_kernel"),
        "decoder_forward_f32": (
            "mlp_kernel_f32", f"{mlp}:132", "bf16=False",
            "decoder_forward_f32_kernel"),
        "decoder_backward_f32": (
            "mlp_kernel_f32", f"{mlp}:141", "bf16=False",
            "decoder_backward_f32_kernel"),
    }
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{csrc}/{src}.cu",
         "stream_source": f"{csrc}/{STREAM_LIBRARIES[src]}.cu",
         "wide_source": f"{csrc}/{WIDE_LIBRARIES[src]}.cu",
         "park_source": f"{csrc}/{PARK_LIBRARIES[src]}.cu",
         "replaces": rep, "replaces_form": form,
         "launches": sum(st["launches"][name] for st in stats.values()),
         "launches_by_path": {p: st["launches"][name]
                              for p, st in stats.items()},
         "build": built[fn],
         "build_by_size": {tag: fns[fn] for tag, fns in built_by_size.items()
                           if fn in fns},
         **kern[name]}
        for name, (src, rep, form, fn) in meta.items()]}
    record["kernels"].append(
        {"name": "decoder_wgrad", "route": "cuda",
         "source": f"{csrc}/mlp_wgrad.cu", "replaces": f"{mlp}:172",
         "replaces_form": "bf16=True: _bwd_kernel's weight-gradient sums "
                          "(dw[:] += _dotg(...), lines 172-193)",
         "launches": sum(st["launches"]["decoder_wgrad"]
                         for st in stats.values()),
         "launches_by_path": {p: st["launches"]["decoder_wgrad"]
                              for p, st in stats.items()},
         "build": built[WGRAD_FUNCTION], **kern["decoder_wgrad"]})
    record["kernels"].append(
        {"name": "decoder_wgrad_f32", "route": "cuda",
         "source": f"{csrc}/mlp_wgrad_f32.cu", "replaces": f"{mlp}:172",
         "replaces_form": "bf16=False: _bwd_kernel's weight-gradient sums "
                          "(dw[:] += _dotg(...), lines 172-193)",
         "launches": sum(st["launches"]["decoder_wgrad_f32"]
                         for st in stats.values()),
         "launches_by_path": {p: st["launches"]["decoder_wgrad_f32"]
                              for p, st in stats.items()},
         "build": built[WGRAD_F32_FUNCTION], **kern["decoder_wgrad_f32"]})
    size_table(record)
    unlaunched = [k["name"] for k in record["kernels"] if k["launches"] <= 0]
    if unlaunched:
        raise AssertionError(f"kernels launched on no path: {unlaunched}")
    total_s = time.perf_counter() - t_start
    log(f"chip_smoke: {total_s:.1f} s in all; by phase: "
        + json.dumps({k: round(v, 1) for k, v in phase_s.items()}))
    print(json.dumps({"slices": stats, "kernel_phase": kern["extra"],
                      "vox_profile": profile, "total_s": total_s,
                      "phase_s": phase_s}))
    print(json.dumps(record))
    if ATE_MISSES:
        raise AssertionError("; ".join(ATE_MISSES))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
