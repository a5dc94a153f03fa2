"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `cfear_radarodometry_code_public_tpu_torch/
csrc/` with nvcc and checks each against its plain PyTorch twin on the card:
the 1-NN kernels A and C (A also at every main-path shape of `A_SHAPES`
and a ragged one, C at every main-path shape of `C_SHAPES`; two launches
bit-identical and a B=1 call equal to its lane of a batched call), D1 and
D2 at every shape of `C_SHAPES` in the same way and bit for bit against C,
timed beside C and the issue-slot floor of their inner loop (`sass_loop`),
E there too (D_pad 8, and 16 at `E_WIDE`; its (nn, d2) bit for bit against
C's, g against its twin's), timed beside C and C + the flat gather, B1
and B2 at every shape of `A_SHAPES` they take, in the same way against A, the
fused LM solve F (both variants, the six cost /
loss pairs of `LM_CASES` at S=4, and every width the main paths give it,
`LM_SHAPES`: the long run's reverse and forward solves, 1 and 4 x 2048
cells, the `sweep` path's 1 and 3 x 1024, CFEAR-1's and CFEAR-2's P2L
solves over 1 and 3 x 2048, and the s50 widths, S=16 and
S=50 of 1024 cells and S=50 of 3072, so that every cluster
size the kernel picks is held against the twin; a lane of a B=8 call must
equal its own B=1 call bit for bit) and the feature-moment kernel G (on
the slice's own frames, lane by lane as well, and on a cloud in which one
voxel holds 2,000 points).
Then it drives the CFEAR-3 host-ingest odometry slice at Oxford sensor scale
(400 x 3768 polar sweeps, k=40, point_budget 8192, max_cells 1024, S=4
keyframes, Morton-ordered cells, block-sparse association) through the
port's entry points: single-sequence (`OdometryRunner`, host ingest), the
preset as users call it (`auto`: kernel A), the default image ingest
(`image`: raw sweeps filtered on the card, held to the host-ingest run at
1e-4 and repeated bit for bit; after its counts are read, its frames/s
in turns with host ingest's), the offline CLI as users run it (`cli`:
`offline_odometry.main` with the CFEAR-3 Oxford preset as --config-file,
32 frames, image ingest, --save-graph, held to the reference CLI's
golden), the CLI beyond that (`cli-oxford` and `cli-mulran`: directories
in the released Oxford and MulRan layouts, written from the simulator with
the port's own PNG encoder and read back bit for bit without PIL, the
MulRan sweeps range-major and counter-clockwise; `cli-cfear1` and
`cli-cfear2`: the paper's P2L presets, kernel A at S=1 and S=3 and kernel
F's P2L instances in the odometry step; `cli-cacfar`: CFEAR-3 under
CA-CFAR, the card's CA-CFAR rows first held to the host filter's;
`cli-grid`: CFEAR-3 with the reference's bucket-grid association, torch
ops on the card, kernel F and no association kernel, the card's bucket
tables held to the reference's built in numpy and a second run bit for
bit; `cli-raw`: raw cells, kernel A at B=1 S=4 Msrc=M=4096 and F at B=1
N=16,384; `cli-kvarntorp` and `cli-volvo`: the 832-bin counter-clockwise
geometries read from directories in MulRan's layout; each against the
reference CLI's golden: keyframe decisions and failed frames identical,
poses within `CLI_PATH_TOL`, the graph's counts, and kernels A and F
called only at shapes the kernel phases hold), the reference's
evaluation sweep as users run it (`sweep`: eight
jobs of `tools/run_ablation_sweep.py`'s grids and world, cut to 48
frames, through the port's `parallel.sweep.run_sweep` and offline CLI,
kernels A at S = 1-8 and F with the Tukey, no-loss and P2D costs, each job
held to the reference's golden: keyframe decisions and failed frames
identical, the Tukey-0.1 job failing frames, poses within `SWEEP_TOL`),
batched x8 (`make_batched_step`, two runs that must agree bit for
bit), single-sequence with `feature.backend="pallas"` (kernel G), the
same at a point budget whose occupied voxels pass kernel G's compact-cell
budget on every frame (`pallas-features-overflow`: the frames and voxels
dropped printed, G held bit for bit against its twin on those frames'
inputs first), and a parked sensor (`stationary`: one sweep repeated, only
the bootstrap keyframe, every pose within 0.2 m of the origin; kernel C
on a source equal to its target, every d2 exactly 0, and F at zero
residual against their twins).
Then CFEAR-3-s50, the 50-keyframe submap, over 128 frames:
exact and with the K=16 gate (`s50`, `s50-k16`; both print their drift
under `bench.py --check-drift`'s protocol beside the golden's), batched x8
(`s50-batched`), and the preset as users call it (`s50-preset`), after which
C, D1, D2 and E are held against their twins on the window that path ends
with (B=1, M=3072; C's time there, and on the `s50` window, joins C's
entry on the kernels line). The multi-keyframe kernels D1, D2 and the fused-lookup
kernel E run on the 50-keyframe window the `s50` path ends with, at B=1 and
B=8, and are held bit for bit against kernel C, the flat gather and their
twins (`s50-window`). Last, the long-run odometry path of
`tools/run_longrun.py` (CFEAR-3, max_cells 2048, the reverse-registration
health check every 8 frames, `auto` -> kernel A) over 256 frames of the
extent-1000 world at 12 m/s (`longrun`), split through a checkpoint
(`longrun-resume`, bit-identical), with the cost-sampling covariance
(`longrun-cov`), in the adversarial world at 8 m/s (`longrun-adv8`) and
at 12 m/s, the breaking regime, over 384 frames (`longrun-adv12`: the
reference's golden marks one health check unhealthy there, and the port
must mark it too), and a sensor that goes blind (`longrun-blind`: the
health check on every frame, image ingest, all-zero sweeps from frame 32:
flags as the golden's, every checked blind frame unhealthy, no NaN; kernel
A without a valid target and on a source of no cell, F with no weight and
with one row, against their twins);
kernels B1 and B2 run on the window `longrun` ends with (the forward S=4
and the reverse S=1 problem, B=1 and B=8) and are held bit for bit against
kernel A and their twin (`longrun-window`). Then the SLAM pass of `tools/run_slam_scale.py`
(`slam`: CFEAR-3 at Oxford width, max_cells 1024, two laps of 256 frames
of the seed-9 world): odometry, the graph with scan payloads on the card,
`close_from_graph` (loop verification in chunks of 512 lanes: kernels A at
B=512 S=1 and F at B=512 N=1024, both also held against their twins at
that shape), `to_arrays` and `optimize` (40 GN x 400 PCG); the keyframe
count, the accepted loop edges and the keyframe ATE before and after are
held to the golden's, and `optimize` on the golden's own graph arrays must
repeat bit for bit and equal JAX's; `slam-dropout` is the same pass with
the sweeps rendered under azimuth dropout 0.35 (after `merge-mesh`), held
to its own golden: the keyframe count, `slam`'s loop-edge shares on the
edges the card's verification accepts on a graph built from the golden's
own odometry, the pass's own loop-edge count within
`SLAM_DROPOUT_OWN_LOOP_SHARE` of the golden's, the closed keyframe ATE
within `SLAM_DROPOUT_ATE_TOL`, and the pass's own accepted pairs and those
the card's verification accepts on the committed card odometry
(`CARD_SLAM_DROPOUT`) both equal to that file's, which the reference
accepts on it; then `refine`: `refine_many_to_many` on the
reference's cells of 16 keyframes from perturbed poses (no kernel), two
runs bit-identical and within `REFINE_TOL` of the reference's refinement.
Then the multi-session merge
(`merge`): a second drive of 128 frames over the same world, from frame
320 of its route with its own speckle, odometry and graph on the card,
folded into the `slam` path's map by `merge_many` (cross-session
verification in one chunk of 256 lanes: kernels A at B=256 S=1 and F at
B=256 N=1024, both also held against their twins at that shape), held to
its golden (inlier matches, `t_ab`, the new session's keyframe error, and
that error under 0.2x the identity alignment's); `merge-mesh`, the same
merge with its joint solve on a NCCL group of one process, bit for bit;
`merge-cli3`, the merge CLI (`merge_sessions.main`) on the card over three
session graph files (the `slam` map, the `merge` path's session B and a
third drive C from frame 160), the merged graph and TUM file read back
and held to its golden (node counts, each merge's inliers, `t_ab` and
new session's keyframe error; kernels A at B=256 and B=128 S=1, F);
`fleet`, `parallel.mesh.MultiSequenceRunner` over 8 distinct 64-frame
sequences with image ingest (lane 0 against the CFEAR-3 golden, every
lane against its own single run, two runs bit for bit); and `segmented`,
`parallel.segments.run_segmented` over the CFEAR-3 sequence in 4
segments (ATE within 0.3 m of the serial run's). Last, `online`: the online
daemon (`online_odometry.OnlineOdometry`, the CFEAR-3 Oxford preset
unmodified, host ingest, kernels A and F) follows a radar pack that a
recorder thread grows with the CFEAR-3 sequence in bursts of 1-5 frames;
one TUM line a frame with monotone stamps, the lines the daemon's poses,
and its trajectory bit-identical to `OdometryRunner` over the same frames
in one call; it prints the lag from a frame's append to its flushed line. Each path is held
against a JAX golden (`tools/make_torch_port_golden.py`) or another run, and must launch
the kernels it runs (launch counts zeroed just before each path, read just
after). Exits non-zero, printing no result, when there is no CUDA card or
any phase fails. The last line of stdout is {"ok": true, "device": {...}};
the line before it lists the kernels, each with its time, its plain twin's,
its bound and the time of the closest PyTorch library route, and
`host_paced`: the twins and library routes whose time is the host's pace
(`_cuda_ms`; a kernel timed so fails the run).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import inspect
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

import cfear_radarodometry_code_public_tpu_torch as port
from cfear_radarodometry_code_public_tpu_torch import offline_odometry
from cfear_radarodometry_code_public_tpu_torch.datasets import png, synthetic
from cfear_radarodometry_code_public_tpu_torch.eval import kitti, slam_scale
from cfear_radarodometry_code_public_tpu_torch.eval.trajectory import ate_rmse
from cfear_radarodometry_code_public_tpu_torch.models import (
    loopclosure, multisession, odometry, posegraph)
from cfear_radarodometry_code_public_tpu_torch.ops import (
    _build, cuda_assoc, cuda_features, cuda_lm, features, filtering,
    registration)
from cfear_radarodometry_code_public_tpu_torch.ops.features import CellMap
from cfear_radarodometry_code_public_tpu_torch.parallel import (
    distributed, mesh, segments, sweep)
from cfear_radarodometry_code_public_tpu_torch.utils import native_io, se2

ROOT = os.path.dirname(os.path.abspath(__file__))
_GOLDEN_DIR = os.path.join(ROOT, "cfear_radarodometry_code_public_tpu_torch",
                           "golden")
GOLDEN = os.path.join(_GOLDEN_DIR, "cfear3_oxford_seed1_64.npz")
GOLDEN_PALLAS = os.path.join(_GOLDEN_DIR,
                             "cfear3_oxford_seed1_64_pallasfeat.npz")
SEQUENCE = {"seed": 1, "n_frames": 64, "speed": 6.0}   # as bench.py renders it
# A parked sensor (`stationary` path): the reference's test
# `tests/test_odometry.py:98` (`test_stationary_sensor_no_keyframes`) at
# Oxford width: one sweep of SEQUENCE's world (`make_world` from the
# generator of its seed, as `make_sequence` draws it) rendered at the
# origin, repeated for STATIONARY's frames, through `slice_config()`
# (kernel C) with host ingest. Identical sweeps give identical cells, so
# the first association of frame 1 matches every source cell to itself
# (kernel C's exact d2 = 0) and kernel F starts at zero residual. Only the
# bootstrap frame may be a keyframe, and every pose must stay within
# STATIONARY_MAX_XY of the origin (that test's bound). Its golden:
# `make_torch_port_golden.py --preset stationary`.
STATIONARY = {"seed": 1, "n_frames": 24}
STATIONARY_MAX_XY = 0.2
GOLDEN_STATIONARY = os.path.join(_GOLDEN_DIR,
                                 "cfear3_stationary_oxford_seed1_24.npz")
# Voxel overflow on kernel G's path (`pallas-features-overflow` path): the
# slice with `feature.backend="pallas"` at a point budget users set for
# denser sweeps, OVERFLOW_POINT_BUDGET (24 x 512) at the default pre_cells
# (c_pre 4,608), over OVERFLOW_SEQUENCE (SEQUENCE cut to 32 frames). There
# the budget holds every point the host filter keeps (11,286-11,847 a
# frame on SEQUENCE's 64), which occupy 5,473-5,716 voxels (at the slice's
# 8192 points 4,428-4,649, and 5 of SEQUENCE's 64 frames already pass
# c_pre): every frame drops the voxels ranked at or beyond c_pre
# (`features._moment_inputs`), as the reference does. Its golden:
# `make_torch_port_golden.py --preset overflow`.
OVERFLOW_POINT_BUDGET = 12288
OVERFLOW_SEQUENCE = {**SEQUENCE, "n_frames": 32}
GOLDEN_OVERFLOW = os.path.join(_GOLDEN_DIR,
                               "cfear3_oxford_seed1_32_pallasfeat_pb12288.npz")
# CFEAR-3-s50: bench.py's default 128 frames; at 6 m/s nearly every frame
# is a keyframe, so the 50-keyframe window is full for the last ~75 frames
S50_SEQUENCE = {"seed": 1, "n_frames": 128, "speed": 6.0}
# The offline CLI as users run it (`cli` path): the CFEAR-3 Oxford preset
# as a --config-file, the synthetic world of SEQUENCE cut to 32 frames, the
# default image ingest and --save-graph; its golden is the reference CLI
# with the same arguments and --cpu (`make_torch_port_golden.py --preset
# cli`)
CLI_SEQUENCE = {"seed": 1, "n_frames": 32, "speed": 6.0}
GOLDEN_CLI = os.path.join(_GOLDEN_DIR, "cfear3_cli_oxford_seed1_32.npz")
# The offline CLI beyond CFEAR-3 on synthetic input (the `cli-*` paths).
# `cli-oxford` and `cli-mulran` read dataset directories in the released
# layouts, written from the simulator as tests/test_e2e_golden.py and
# tests/test_e2e_golden_mulran.py write theirs but with the port's own PNG
# encoder (`datasets/png.py`; the loader decodes them without PIL): Oxford
# <microseconds>.png sweeps of 400 x (11 + 3768), the 11 metadata columns
# zero, and `radar_odometry.csv`; MulRan range-major <nanoseconds>.png
# sweeps of 3360 x 400, rendered counter-clockwise, and a `stamp,x,y,yaw`
# CSV. Each is the world of `world_seed`, a trajectory of `traj_seed`
# (n_frames + 1 poses, the first a pre-roll pose so that the first sweep's
# stamp lies inside the ground truth), sweep i rendered with the generator
# of `render_seed + i`; stamps start at `t0` (the loader's unit).
DATASET_SEQUENCES = {
    "oxford": {"world_seed": 7, "traj_seed": 8, "render_seed": 1000,
               "n_frames": 32, "speed": 8.0, "t0": 1_547_120_000_000_000},
    "mulran": {"world_seed": 17, "traj_seed": 18, "render_seed": 2000,
               "n_frames": 32, "speed": 8.0,
               "t0": 1_561_000_000_000_000_000},
    # the 832-bin sensors of Kvarntorp and Volvo (`config.py`: bins of
    # 0.175238 m, counter-clockwise, min_distance 4.0 and 2.5), in MulRan's
    # layout, which both CLIs read for them (`mulran_frames`)
    "kvarntorp": {"world_seed": 27, "traj_seed": 28, "render_seed": 3000,
                  "n_frames": 32, "speed": 8.0,
                  "t0": 1_600_000_000_000_000_000},
    "volvo": {"world_seed": 37, "traj_seed": 38, "render_seed": 4000,
              "n_frames": 32, "speed": 8.0,
              "t0": 1_640_000_000_000_000_000},
}
# `cli-cfear1`, `cli-cfear2` and `cli-cacfar` run CLI_SEQUENCE's world at
# Oxford width (400 x 3768) with the paper's CFEAR-1 and CFEAR-2 presets
# (P2L, weight "Combined", submaps of 1 and 3 scans: kernel A at S=1 and 3
# of 2048 cells, kernel F's P2L instances in the odometry step) and with
# CFEAR-3 under CA-CFAR, each preset's Oxford form given with
# --config-file, as `cli` gives CFEAR-3's. `auto` resolves to kernel A on
# a card on every one of these paths. Their goldens: the reference's CLI
# with the same arguments and --cpu, kernel A in interpret mode
# (`make_torch_port_golden.py --preset cli-oxford`, ...).
CLI_PATHS = {
    "cli-oxford": {"preset": "CFEAR-3", "dataset": "oxford"},
    "cli-mulran": {"preset": "CFEAR-3", "dataset": "mulran"},
    "cli-cfear1": {"preset": "CFEAR-1"},
    "cli-cfear2": {"preset": "CFEAR-2"},
    "cli-cacfar": {"preset": "CFEAR-3",
                   "extra": ["--filter_type", "cacfar"]},
    # CFEAR-3 with the reference's bucket-grid association (`assoc_method=
    # "grid"` in the --config-file: torch ops on the card, no association
    # kernel; kernel F alone), and with raw cells (`--use_raw_pointcloud`:
    # max_cells_raw 4096, so kernel A at B=1 S=4 Msrc=M=4096 and kernel F
    # at B=1 N=16,384)
    "cli-grid": {"preset": "CFEAR-3", "assoc": "grid"},
    "cli-raw": {"preset": "CFEAR-3", "extra": ["--use_raw_pointcloud"]},
    # the 832-bin geometries as users run them: `--dataset kvarntorp|volvo`
    # over a directory in MulRan's layout (A at S=4 M=3072, F at N=12,288)
    "cli-kvarntorp": {"preset": "CFEAR-3", "dataset": "kvarntorp"},
    "cli-volvo": {"preset": "CFEAR-3", "dataset": "volvo"},
}
# The association kernels; `cli-grid` must launch none of them (its lookup
# is torch ops), so that the path cannot turn into kernel A unseen
ASSOC_KERNELS = ("nn_min", "nn_min_multi", "nn_min_multi_unrolled",
                 "nn_min_sparse", "nn_min_sparse_multi",
                 "nn_min_sparse_unrolled", "nn_min_sparse_attrs")
# Their tolerances (position m, yaw rad, motion m), about 3x the larger of
# two spreads of the reference's own from its golden on the path
# (`make_torch_port_golden.py --preset <path> --assoc-method dense`, and
# with `--eager` the same run op by op, `jax.disable_jit()`: the compiled
# reference fuses the image filter with the compensation, which can keep a
# cell the op-by-op reference and the port do not; JAX on the CPU). Dense /
# op by op: cli-oxford 4.10 / 6.18 cm, 1.30e-3 / 1.74e-3 rad, 4.31 / 1.90
# cm; cli-mulran 0.72 / 0.95 cm, 3.20e-4 / 3.47e-4, 0.54 / 1.08 cm;
# cli-cfear1 0.42 / 1.61 cm, 1.83e-4 / 4.15e-4, 0.28 / 0.27 cm; cli-cfear2
# 0.18 / 0.32 cm, 1.02e-4 / 1.26e-4, 0.07 / 0.08 cm; cli-cacfar 0.83 /
# 1.04 cm, 2.43e-4 / 3.18e-4, 0.99 / 0.96 cm; cli-grid 0.83 / 0.56 cm,
# 3.87e-4 / 1.38e-4, 0.88 / 0.56 cm (dense: the exact association the
# bucket grid stands in for); cli-kvarntorp 0.43 / 0.24 cm, 7.2e-5 /
# 6.5e-5, 0.24 / 0.25 cm; cli-volvo 2.75 / 0.001 cm, 4.94e-4 / 9.0e-7,
# 1.12 / 0.001 cm. Keyframe decisions, failed frames (none) and graph
# counts are identical in every one of these runs. The golden run again
# under XLA_FLAGS=--xla_cpu_max_isa=AVX stays within 1.8 mm of it on every
# path but cli-raw. cli-raw is the ill-conditioned raw-cell ablation: its
# dense run parts from kernel A's form at the points' near-ties (11
# keyframes against the golden's 1, poses 19.8 m apart), so its bound is
# 3x the spread of kernel A's form alone, op by op and under AVX: 65.0 /
# 44.0 cm, 4.63e-3 / 2.62e-3 rad, 19.1 / 20.7 cm, each with the golden's
# single keyframe (the reference does not track with raw cells here: ATE
# 15.7 m over 32 frames).
CLI_PATH_TOL = {"cli-oxford": (0.19, 5.2e-3, 0.13),
                "cli-mulran": (0.03, 1.05e-3, 0.033),
                "cli-cfear1": (0.049, 1.25e-3, 0.0085),
                "cli-cfear2": (0.0098, 3.8e-4, 0.0024),
                "cli-cacfar": (0.031, 9.5e-4, 0.030),
                "cli-grid": (0.025, 1.2e-3, 0.027),
                "cli-raw": (1.95, 1.4e-2, 0.62),
                "cli-kvarntorp": (0.013, 2.2e-4, 0.0076),
                "cli-volvo": (0.083, 1.5e-3, 0.034)}
# The SLAM pass (`slam` path) of `tools/run_slam_scale.py`: its configuration
# (`slam_config`) and multi-lap world of seed 9, cut in depth from 4,096
# frames (4 laps of 1,024) to 2 laps of 256 at 2.5 m/s, where loops close
# (the golden, `make_torch_port_golden.py --preset slam`: JAX on the CPU,
# kernel A in interpret mode); 40 GN x 400 PCG iterations as the tool runs
SLAM_SEQUENCE = {"n_frames": 512, "lap_frames": 256, "speed": 2.5,
                 "extent": 300.0}
SLAM_ITERS = {"iters": 40, "cg_iters": 400}
GOLDEN_SLAM = os.path.join(_GOLDEN_DIR, "cfear3_slam_seed9_512.npz")
# Its limits. The reference's own spread between its dense association and
# kernel A on this sequence (`make_torch_port_golden.py --preset slam
# --assoc-method dense`, JAX on the CPU): the same 171 keyframes, 74
# against 72 accepted loop edges with 65 pairs in both, closed keyframe ATE
# 0.131 against 0.114 m. The keyframe count must be identical, the accepted
# loop edges within 10% of the golden's count (about 3x the 2.8% spread)
# with at least 70% of its pairs (3x the 10% it missed), and closure must
# lower the keyframe ATE. The port's `optimize` on the golden's own graph
# arrays is held to JAX's optimized poses within SLAM_OPT_TOL (position m,
# yaw rad), the bound of tests/test_torch_posegraph.py's
# `test_optimize_on_the_slam_golden_graph` (1.1e-5 m on the CPU).
SLAM_LOOP_SHARE, SLAM_PAIR_SHARE = 0.10, 0.70
SLAM_OPT_TOL = (1e-3, 1e-4)
# The SLAM pass with azimuth-wedge dropout (`slam-dropout` path): `slam`'s
# world, route and configuration rendered with dropout 0.35, as
# `eval_results/SLAM_SCALE_dropout_tpu.txt` runs the reference's pass. Its
# golden: `make_torch_port_golden.py --preset slam --dropout 0.35`.
SLAM_DROPOUT_SEQUENCE = {**SLAM_SEQUENCE, "dropout_prob": 0.35}
GOLDEN_SLAM_DROPOUT = os.path.join(_GOLDEN_DIR,
                                   "cfear3_slam_dropout35_seed9_512.npz")
# Its limits. The reference's own reruns of this pass (`... --preset slam
# --dropout 0.35`, with `--assoc-method dense`, and each again under
# XLA_FLAGS=--xla_cpu_max_isa=AVX, `--compare-only` for kernel A; JAX on
# the CPU) keep 171 keyframes and accept 47, 47 and 49 loop edges (40, 44
# and 8 of the golden's 47 pairs: with the AVX dense run the keyframe
# flags shift, and a pair's node indices with them), the odometry up to
# 1.00 m, 2.24e-2 rad and 0.39 m per motion from the golden's, the closed
# keyframe ATE 0.1607, 0.1438 and 0.1158 m against 0.1443. A pass's loop
# edges follow the odometry it is given, which parts from the golden's by
# float32 rounding grown over 512 frames of dropout; so the shares of
# `slam` (SLAM_LOOP_SHARE, SLAM_PAIR_SHARE) hold the edges the card's
# verification accepts on a graph built from the golden's own odometry
# (`golden_loops`), and the path's own closed keyframe ATE must lie within
# SLAM_DROPOUT_ATE_TOL of the golden's, about 3x the 0.0285 m of the
# reference's reruns (ROADMAP queue 3, "slam-dropout's loop edges").
SLAM_DROPOUT_ATE_TOL = 0.086
# ...and the pass's own accepted loop-edge count, on the odometry the card
# gives it. Given the card's odometry (`golden/card_h100_slam_dropout35_
# seed9_512.npz`, `tools/slam_verify_torch.py --save-odometry`), the
# reference's closure on the CPU accepts the card's 55 pairs exactly with
# kernel A (with and without AVX) and with its dense form under AVX, and
# those 55 and one more with the dense form (`--reference-closure`); from
# the card runner's state before the first keyframe flag it sets apart
# from the golden's (frame 414) the reference sets the card's flags, and
# from the reference's state there the port sets the golden's (`--flags`):
# the count follows the odometry, and the odometry parts by float32
# rounding (ROADMAP queue 3, closed as a finding). The bound is about 3x
# the reference's own spread of that count over its rounding variants
# (kernel A, kernel A under AVX, dense, dense under AVX) on three render
# draws of this world and route at 512 frames: 47-49 on the golden's draw,
# 56-59 on draw 9101 and 43-48 on draw 9102 (5 edges, 11.6% of 43;
# `make_torch_port_golden.py --preset slam --dropout 0.35 [--render-seed
# N] [--assoc-method dense]`, JAX on the CPU). It admits 31-63 edges
# against the golden's 47, so it cannot tell an offset of the size seen
# (the card's 55, 8 above the golden's) from rounding: it holds only a
# gross fault.
SLAM_DROPOUT_OWN_LOOP_SHARE = 0.35
# The exact check: the card's odometry of the pass, as `tools/slam_verify_
# torch.py --save-odometry` wrote it on an H100. On it the reference's
# closure (kernel A in interpret mode) and the port's on the CPU accept the
# file's own 55 pairs (`tests/test_torch_degenerate.py::test_closure_on_
# the_card_odometry_equals_the_reference`, slow), and so must the card's
# closure. The pass's own accepted set must be the file's too: the card's
# odometry repeats bit for bit from call to call. A change that moves the
# card's odometry remakes the file with `--save-odometry` and reruns that
# test.
CARD_SLAM_DROPOUT = os.path.join(_GOLDEN_DIR,
                                 "card_h100_slam_dropout35_seed9_512.npz")
# The joint refinement of all scan poses (`refine` phase,
# `ops/registration.refine_many_to_many`, which no runner calls): the
# reference's cells of REFINE's `keyframes` consecutive keyframes of the
# `slam` golden's drive from keyframe `first` (its odometry, max_cells
# 1024; `posegraph.compute_scan_payloads`), their odometry poses perturbed
# by normal noise of `noise` (m, rad) from the generator of `seed`, the
# first pose fixed; refined by the port on the card as the reference
# refines them (4 outer x 8 GN x 24 CG, 8 pairs a scan). Its golden, which
# holds the inputs and the reference's refined poses:
# `make_torch_port_golden.py --preset refine`. No kernel: the dense 1-NN
# is the matmul form, outside any kernel, as in the reference.
REFINE = {"first": 0, "keyframes": 16, "noise": [0.25, 0.015], "seed": 5}
GOLDEN_REFINE = os.path.join(_GOLDEN_DIR, "cfear3_refine_slam_seed9_16.npz")
# Its bound (position m, yaw rad), about 3x the larger of the reference's
# own spreads on these inputs (`make_torch_port_golden.py --preset refine
# --eager`, and `--compare-only` under XLA_FLAGS=--xla_cpu_max_isa=AVX,
# JAX on the CPU): op by op 1.94e-3 m / 3.22e-5 rad, under AVX 2.48e-3 m /
# 4.63e-5 rad from the compiled golden (the port on the CPU: 3.05e-3 m /
# 2.12e-5 rad, `--port-cpu`).
REFINE_TOL = (7.5e-3, 1.4e-4)
# The multi-session merge (`merge` path): session A is the `slam` path's
# graph after loop closure (the map a user has); session B drives the same
# seed-9 world along the lap route from its frame 320 for 128 frames with
# its own speckle (`slam_scale.make_route_slice`), so an identity alignment
# is off by the route offset. `merge_many([A, B], iters=15)`. Its golden:
# `make_torch_port_golden.py --preset merge` (JAX on the CPU, kernel A in
# interpret mode).
MERGE_SEQUENCE = {"start": 320, "n_frames": 128, "render_seed": 909}
MERGE_ITERS = 15
GOLDEN_MERGE = os.path.join(_GOLDEN_DIR, "cfear3_merge_seed9_512_128.npz")
# Its limits. The reference's own spread between its dense association and
# kernel A on this merge (`make_torch_port_golden.py --preset merge
# --assoc-method dense`, JAX on the CPU): the same 171 + 43 nodes and 129
# candidate pairs; 29 against 32 inlier matches (9.4%), 28 of the golden's
# 32 pairs found (12.5% missed); t_ab 0.141 m and 1.94e-3 rad apart; B's
# merged keyframe error 0.331 against 0.272 m (0.059 m). The limits are
# about 3x that: the inlier count within 30% of the golden's with at least
# 60% of its pairs, t_ab within 0.42 m and 6e-3 rad, B's merged keyframe
# error within 0.18 m of the golden's, and under 0.2x the identity
# alignment's (35.9 m), the bar of tests/test_multisession.py:99-126.
MERGE_COUNT_SHARE, MERGE_PAIR_SHARE = 0.30, 0.60
MERGE_T_TOL = (0.42, 6e-3)
MERGE_ERR_TOL = 0.18
# The merge CLI over three sessions (`merge-cli3` path): the `slam` path's
# closed graph (A), the `merge` path's session B and a session C that
# drives the same route from MERGE3_SEQUENCE's start with its own speckle,
# each saved as a graph file with its scan payloads, merged by the port's
# `merge_sessions.main` on the card as users call it (`merge3_args`: the
# CFEAR-3 Oxford preset at the graphs' cell budget): B against A, then C
# against the joint A + B. Its golden: `make_torch_port_golden.py --preset
# merge3` (the reference's merge CLI on the reference's own three graphs,
# JAX on the CPU, kernel A in interpret mode).
MERGE3_SEQUENCE = {"start": 160, "n_frames": 96, "render_seed": 929}
GOLDEN_MERGE3 = os.path.join(_GOLDEN_DIR,
                             "cfear3_merge3_seed9_512_128_96.npz")
# Its limits, set as MERGE_*'s are, from the reference's own spread between
# its dense association and kernel A on this merge (`make_torch_port_golden
# .py --preset merge3 --assoc-method dense`, JAX on the CPU): the same 171
# + 43 + 33 nodes and 129 and 99 candidate pairs; inliers 31 against 33
# (6.1%) and 53 against 53, with 28 and 51 of the golden's pairs found
# (15.2% and 3.8% missed); t_ab 0.060 m / 3.80e-3 rad and 0.165 m /
# 5.40e-3 rad apart; the new sessions' merged keyframe errors 0.036 and
# 0.068 m apart. The limits are about 3x the larger of the two merges':
# each merge's inlier count within 18% of the golden's with at least 54%
# of its pairs, t_ab within 0.50 m and 1.6e-2 rad, the new session's
# keyframe error within 0.20 m of the golden's.
MERGE3_COUNT_SHARE, MERGE3_PAIR_SHARE = 0.18, 0.54
MERGE3_T_TOL = (0.50, 1.6e-2)
MERGE3_ERR_TOL = 0.20
# The fleet (`fleet` path): BATCH distinct sequences of SEQUENCE's length
# and speed, seeds 1-8, through `parallel.mesh.MultiSequenceRunner`; and
# the segment runner (`segmented` path) over SEQUENCE
FLEET_SEEDS = tuple(range(1, 9))
SEGMENTS = {"n_segments": 4, "overlap": 8, "chunk": 16}
GOLDEN_S50 = os.path.join(_GOLDEN_DIR, "cfear3s50_oxford_seed1_128.npz")
GOLDEN_S50_K16 = os.path.join(_GOLDEN_DIR, "cfear3s50k16_oxford_seed1_128.npz")
BATCH = 8
# Trajectory tolerances against the JAX-on-CPU golden and between the
# port's own runs. They differ by f32 ulps (sin/cos, sum order, XLA's FMA
# in the golden's distances), which move a few points across voxel and gate
# boundaries and flip a few accepted associations. The reference itself
# spreads as far between its own association backends: on this sequence its
# dense form and its block-sparse kernel differ by 2.18 cm per pose, 5.0e-4
# rad and 8.8 mm per frame-to-frame motion (JAX on the CPU;
# `tools/make_torch_port_golden.py --assoc-method dense` prints it). The
# tolerances are about 3x that; a wrong association rule or sign costs
# 0.1-1 m.
TOL = (0.08, 3e-3, 0.025)   # (position m, yaw rad, motion m)
# CFEAR-3-s50 against its goldens, set the same way (`... --preset
# CFEAR-3-s50 [--k-active 16] --assoc-method dense`): dense against
# block-sparse, the exact window differs by 1.68 cm per pose, 4.10e-4 rad
# and 1.68 cm per motion, K16 by 1.68 cm, 3.96e-4 rad and 1.68 cm (the
# largest position difference is on frame 1, whose pose is its motion,
# before the gate has a keyframe to drop). The limits are about 3x that.
S50_TOL = (0.05, 1.25e-3, 0.05)
# The s50 paths' drift under `bench.py --check-drift`'s protocol (KITTI
# drift, step 5, subsequences of 50 and 100 m), printed beside the golden's
# and the reference artifact's accuracy figures
# (`eval_results/BENCH_s50_tpu.txt:10,15`: 0.060% exact, 0.065% K16).
S50_DRIFT_KW = {"step_size": 5, "lengths": (50.0, 100.0)}
S50_DRIFT_ARTIFACT = {"s50": 0.060, "s50-k16": 0.065}
# The long-run odometry path (`tools/run_longrun.py`'s configuration, cut
# from 1024 to 256 frames, about 770 m at 12 m/s): CFEAR-3 at Oxford scale,
# max_cells 2048, the reverse-registration health check every 8 frames, in
# the reference's easy world and its stable adversarial world at 8 m/s.
LONGRUN_SEQUENCE = {"seed": 11, "n_frames": 256, "speed": 12.0,
                    "extent": 1000.0}
ADVERSARIAL = {"n_dynamic": 40, "dropout_prob": 0.5,
               "speckle_burst_prob": 0.4}
LONGRUN_ADV8_SEQUENCE = {**LONGRUN_SEQUENCE, "speed": 8.0, **ADVERSARIAL}
# The breaking regime of `tools/run_longrun.py` (adversarial at 12 m/s),
# at the smallest multiple of 128 frames at which the reference itself
# marks a health check unhealthy: 384 frames (one of 47 checks, frame 328;
# `make_torch_port_golden.py --preset longrun --adversarial --speed 12
# --frames 384`; at 256 frames none of 31 is).
LONGRUN_ADV12_SEQUENCE = {**LONGRUN_SEQUENCE, "n_frames": 384, **ADVERSARIAL}
# Its tolerances, set as TOL is (`make_torch_port_golden.py --preset longrun
# [--adversarial --speed 8] --assoc-method dense`): over the 256 frames the
# reference's dense form differs from its kernel A by 12.25 cm per pose,
# 1.10e-3 rad and 2.07 cm per motion in the easy world (4.03 cm, 6.13e-4
# rad, 1.38 cm in the adversarial one; a pose difference grows along the
# run as drift does); the limits are about 3x the larger. The health
# signal's spread is 1.42 cm and 2.99e-4 rad (0.89 cm, 2.55e-4 rad), and
# HEALTH_TOL is about 3x that: it bounds health_dist and health_rot, and a
# checked frame whose golden discrepancy lies within it of a limit may flip
# `healthy`. Keyframe and health-checked flags must be identical.
LONGRUN_TOL = (0.40, 3.5e-3, 0.06)
HEALTH_TOL = (0.045, 1e-3)
# The breaking regime drifts, and a pose difference grows along the run as
# drift does: its bounds are set the same way at its depth (`... --preset
# longrun --adversarial --speed 12 --frames 384 --assoc-method dense`):
# there the reference's dense form and its kernel A differ by 42.76 cm per
# pose, 3.81e-3 rad and 13.83 cm per motion, the health signal by 4.93 cm
# and 5.13e-3 rad (healthy flags identical); the limits are about 3x that.
LONGRUN_ADV12_TOL = (1.3, 1.15e-2, 0.42)
HEALTH_ADV12_TOL = (0.15, 1.55e-2)
# A blind sensor (`longrun-blind` path): the reference's test of the
# collapsed reverse solve (`tests/test_odometry.py:253`,
# `test_collapsed_reverse_solve_is_unhealthy`) at Oxford width: the long
# run's configuration with the health check on every frame
# (`blind_config`), image ingest (the runner's default, as in that test),
# over LONGRUN_SEQUENCE's world cut to 48 frames, all zero from
# BLIND_FROM on (the sensor goes blind). A blind frame has no cells: its
# forward solve gives kernel A source rows of no cell, its reverse solve
# targets none valid (A's (0, +inf) rows), and kernel F a problem whose
# weights are all zero (cost 0, and 0/0 for a relative decrease). Its
# golden: `make_torch_port_golden.py --preset blind` (the reference on the
# CPU, kernel A in interpret mode).
BLIND_SEQUENCE = {**LONGRUN_SEQUENCE, "n_frames": 48}
BLIND_FROM = 32
GOLDEN_BLIND = os.path.join(_GOLDEN_DIR, "cfear3_longrun_blind_seed11_48.npz")
# The online daemon as users run it: the CFEAR-3 Oxford preset unmodified
# (max_cells 3072, no point budget: host ingest hands (A, K) candidate sets
# over; `auto` -> kernel A at S=4, F in the LM), following a pack that a
# recorder thread grows with the smoke's CFEAR-3 sequence in bursts of
# ONLINE_BURST frames, ONLINE_SLEEP_S apart, in chunks of 8.
ONLINE_BURST = (1, 5)
ONLINE_SLEEP_S = (0.02, 0.12)
# The reference's evaluation sweep as users run it (`sweep` path): jobs of
# `tools/run_ablation_sweep.py`'s ablation grids, each one in-process call
# of the offline CLI through the port's `parallel.sweep.run_sweep`, in its
# adversarial world (40 moving objects, azimuth dropout 0.5, interference
# bursts 0.4, 12 m/s, max_cells 1024; `auto` -> kernel A at S = the submap
# size, F at N = S x 1024), seed 11, cut from 120 frames to 48. Each job
# is a grid of one or two: (name, grid, extra CLI arguments). They take
# the Tukey-0.1 loss, which must fail frames through the divergence gate
# (`min_assoc_fraction`), its None-0.1 neighbour, P2D with covar_scale 2,
# an 8-keyframe submap, res 1.5 (many more voxels, but fewer valid cells
# than max_cells: at most 357 on seed 12's 120 frames,
# `tools/res15_frames_torch.py`), motion compensation off, the adaptive threshold
# (`z_min_quantile` 0.98) and time-continuous registration. Its golden:
# `make_torch_port_golden.py --preset sweep` (the reference's
# `run_sweep` and CLI on the CPU, kernel A in interpret mode).
SWEEP_SEQUENCE = {"seed": 11, "n_frames": 48, "speed": 12.0}
SWEEP_JOBS = (
    ("loss_function", {"loss_type": ["Tukey", "None"], "loss_limit": [0.1]},
     ()),
    ("baseline_p2d", {"cost_type": ["P2D"], "covar_scale": [2.0]}, ()),
    ("submap_keyframes", {"submap_scan_size": [8]}, ()),
    ("resolution", {"res": [1.5]}, ()),
    ("motion_compensation", {"compensate": ["false"]}, ()),
    ("z_min_quantile", {"z_min_quantile": [0.98]}, ()),
    ("time_continuous", {}, ("--time_continuous",)),
)
GOLDEN_SWEEP = os.path.join(_GOLDEN_DIR, "cfear3_sweep_adv_seed11_48.npz")
SWEEP_TUKEY = "loss_function/job_0"       # Tukey, loss_limit 0.1
# Its tolerance, set as TOL is (`make_torch_port_golden.py --preset sweep
# --assoc-method dense`): over the eight jobs the reference's dense form
# differs from its kernel A by at most 6.97 cm per pose (the
# time-continuous job), 8.98e-4 rad (the 8-keyframe submap) and 1.88 cm
# per motion (None-0.1), with identical keyframe decisions and failed
# frames in every job (the Tukey-0.1 job fails 2 frames in both); the
# limits are about 3x that.
SWEEP_TOL = (0.21, 2.7e-3, 0.06)
# Kernel F against its twin: the tolerance of the reference's own
# kernel-vs-XLA test (tests/test_registration.py:565-567); the two sum in
# another order, which can move an accept or convergence test by an ulp.
LM_POSE_TOL, LM_COST_RTOL = 1e-4, 1e-3
# ...and the cost under which a one-row problem (two residuals for three
# unknowns: a line of exact fits) counts as fitted: the reference's own
# solves end at 0 or 2e-9-5e-9 on such and on zero-residual problems
# (tests/test_torch_degenerate.py), about 3x that rounded up.
LM_FIT_COST = 2e-8
# ...and the pose bound on such a problem, about 3x the reference's own
# spread: where on the line a solve stops is rounding's choice, and the
# reference's solves op by op, compiled and in its kernel (interpret mode)
# land up to 1.866e-3 m apart on `tests/test_torch_cuda.py`'s one-row
# problem, a step apart on three lanes of four (`tools/tool_spread_torch.py
# --problems lm`).
LM_ROW_POSE_TOL = 5.6e-3
# Losses on whose problems here the reference's own two LM solvers (its
# fused kernel in interpret mode and its packed-XLA loop) accept a
# different number of steps on some lane: a step whose cost decrease lies
# within float32 rounding (`tools/tool_spread_torch.py --problems lm`:
# P2P/None, lane 5 of `phase_lm`'s problem, 1 against 2 steps). For them a
# lane's steps are not compared with the twin's, and its pose only where
# the steps agree; every lane's cost is.
LM_STEPS_FREE = ("None",)
# ...and the pose bound of a loss whose problems the reference's own two
# solvers part on wider than LM_POSE_TOL: Tukey's, 1.43e-4 on
# `tests/test_torch_cuda.py`'s problem (a lane that runs to the 20-
# iteration limit; the same script), about 3x.
LM_POSE_TOL_LOSS = {"Tukey": 4.5e-4}
# The cost/loss pairs held at the slice's width: the presets' (P2P/Huber,
# P2L/Huber, P2D/Cauchy) and the `sweep` path's others (no loss, Tukey's,
# and P2D with Huber's)
LM_CASES = (("P2P", "Huber"), ("P2L", "Huber"), ("P2D", "Cauchy"),
            ("P2P", "None"), ("P2P", "Tukey"), ("P2D", "Huber"))
# Kernel F's widths on the main paths, (keyframes, cells, cost, loss) with
# N = keyframes x cells, one for each cluster size the kernel picks: the
# long run's reverse solve (N=2,048: one CTA a lane), the slice (4,096) and
# the long run's forward solve (8,192), the online daemon's preset (12,288),
# the s50 K16 and exact windows (16,384 and 51,200: 8 CTAs a lane) and the
# s50 preset's (153,600: 16); the `sweep` path's submaps of 1 and 3
# keyframes of 1024 cells (N=1,024 and 3,072; its 2 and 8 give N=2,048
# and 8,192, above); and the paper's CFEAR-1 and CFEAR-2 (`cli-cfear1`,
# `cli-cfear2`): P2L with Huber's loss over 1 and 3 keyframes of 2048
# cells (N=2,048, one CTA a lane, and 6,144, a cluster of 8); the raw
# cells of `cli-raw`, 4 keyframes of 4096 (N=16,384 at B=1; 12,288 is also
# `cli-kvarntorp`'s and `cli-volvo`'s)
LM_SHAPES = ((1, 2048, "P2P", "Huber"), (4, 1024, "P2P", "Huber"),
             (4, 2048, "P2P", "Huber"), (4, 3072, "P2P", "Huber"),
             (16, 1024, "P2P", "Cauchy"), (50, 1024, "P2P", "Cauchy"),
             (50, 3072, "P2P", "Cauchy"), (1, 1024, "P2P", "Huber"),
             (3, 1024, "P2P", "Huber"), (1, 2048, "P2L", "Huber"),
             (3, 2048, "P2L", "Huber"), (4, 4096, "P2P", "Huber"))
# ...and loop verification: one keyframe of 1024 cells a lane (N=1,024),
# the path's own cost (CFEAR-3: P2P/Huber) and P2L, over the SLAM pass's
# 512 lanes, the merge's 256 (its 129 candidate pairs, `_next_pow2`) and
# the third session's 128 in `merge-cli3` (99 pairs)
LM_VERIFY = ((512, 256, 128), ((1, 1024, "P2P", "Huber"),
                          (1, 1024, "P2L", "Huber")))
# Kernel G against its twin on the card: rows 0-8 bit-equal (both sum each
# cell in (point, offset) order with unfused f32 operations), rows 9-15
# zero. MOMENT_RTOL, 1e-4 of each row's largest value, is the limit where
# the two run on different devices or against the reference's kernel, whose
# sums are taken in another order.
MOMENT_RTOL = 1e-4
CROWD = 2000   # points in the one voxel of `crowded_cloud`
_PKG = "cfear_radarodometry_code_public_tpu"
KERNELS = {   # name -> (TPU kernel it replaces, CUDA source)
    "nn_min": (f"{_PKG}/ops/pallas_assoc.py:48", "nn_assoc.cu"),
    "nn_min_multi": (f"{_PKG}/ops/pallas_assoc.py:143", "nn_assoc.cu"),
    "nn_min_multi_unrolled": (f"{_PKG}/ops/pallas_assoc.py:683",
                              "nn_assoc.cu"),
    "nn_min_sparse": (f"{_PKG}/ops/pallas_assoc.py:263", "nn_assoc.cu"),
    "nn_min_sparse_multi": (f"{_PKG}/ops/pallas_assoc.py:376", "nn_assoc.cu"),
    "nn_min_sparse_unrolled": (f"{_PKG}/ops/pallas_assoc.py:479",
                               "nn_assoc.cu"),
    "nn_min_sparse_attrs": (f"{_PKG}/ops/pallas_assoc.py:591", "nn_assoc.cu"),
    "lm_solve_fused": (f"{_PKG}/ops/pallas_lm.py:339", "lm_fused.cu"),
    "moment_accumulate": (f"{_PKG}/ops/pallas_features.py:135", "moments.cu"),
}
# The least time the card could take for a kernel's work (`bound_ms`): the
# larger of its bytes (each input read once, each output written once) over
# the memory rate and its operations over the float32 rate outside the
# tensor cores (NVIDIA H100 SXM data sheet; both assume the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Kernel C's shapes on the main paths, (B, S, Msrc, M): CFEAR-3 single and
# x8 (S=4), s50 single and x8 (S=50, 1024 cells), the s50 preset (3072
# cells), a source budget under the target budget, and a target budget
# without a static instance of kernel D2 (4096). `phase_c_shapes`
# (run by `phase_kernels`) holds C against its twin at each, on
# `c_inputs`, and times it;
# tools/compare_torch_kernels.py times two trees' C at the same shapes.
C_SHAPES = ((1, 4, 1024, 1024), (8, 4, 1024, 1024), (1, 50, 1024, 1024),
            (8, 50, 1024, 1024), (1, 50, 3072, 3072), (8, 4, 512, 1024),
            (1, 4, 1024, 4096))
# Kernels D1 and D2 are instances of one template, `nn_min_sparse_walk_kernel
# <kNT>` (D1 kNT = 0, D2 kNT = M / 512): the functions whose inner loop
# (`sass_loop`) sets their issue-slot floor, D2's at M = 1024 (every
# instance has the same loop). `phase_d_shapes` holds them against C at
# every shape of C_SHAPES; tools/compare_torch_kernels.py times two trees'.
D_FUNCTIONS = {"nn_min_sparse_multi": "nn_min_sparse_walk_kernelILi0EE",
               "nn_min_sparse_unrolled": "nn_min_sparse_walk_kernelILi2EE"}
# Kernels C and E are the two instances of one template,
# `nn_min_sparse_split_kernel<kAttrs>` (C false; E true: C's kernel and then
# the winner's attribute column copied): the functions whose inner loop
# (`sass_loop`) sets their issue-slot floor. `phase_e_shapes` holds E
# against C at every shape of C_SHAPES with D_pad 8, and at E_WIDE also
# with 16; tools/compare_torch_kernels.py times two trees'.
C_FUNCTION = "nn_min_sparse_split_kernelILb0EE"
E_FUNCTION = "nn_min_sparse_split_kernelILb1EE"
E_WIDE = (8, 4, 1024, 1024)
# Kernels B1 and B2 are instances of one template, `nn_min_dense_walk_kernel
# <kS>` (B1 kS = 0, B2 kS = S): the functions whose inner loop (`sass_loop`)
# sets their issue-slot floor, B2's at S = 4 (both instances have the same
# loop; B2 at any S outside `UNROLLED_S` runs kS = 0). `phase_b_shapes`
# holds them against A at every shape of A_SHAPES that the reference's B1
# and B2 take (Msrc % ts_multi(M) == 0); tools/compare_torch_kernels.py
# times two trees'.
B_FUNCTIONS = {"nn_min_multi": "nn_min_dense_walk_kernelILi0EE",
               "nn_min_multi_unrolled": "nn_min_dense_walk_kernelILi4EE"}
# Kernel A's shapes on the main paths, (B, S, Msrc, M): `phase_kernels`'
# CFEAR-3 x8 shape, the long run's forward association (B=1, S=4 of 2048
# cells), its window at B=8, the health check's reverse solve (S=1) and
# `sample_covariance`'s 27 offsets folded into lanes (`longrun-cov`), the
# SLAM pass's loop verification (512 lanes of one keyframe each, `slam`),
# the merge's (256 lanes, `merge`), the second merge of `merge-cli3` (its
# 99 candidate pairs against the joint graph: 128 lanes), the online
# daemon's preset (B=1, S=4
# of 3072 cells, `online`), the `sweep` path's submaps (B=1, S = 1, 2, 3,
# 4, 8 of 1024 cells), CFEAR-2's submap (B=1, S=3 of 2048 cells,
# `cli-cfear2`; CFEAR-1's S=1 is the reverse solve's shape), the raw
# cells' budget (B=1, S=4 of max_cells_raw 4096, `cli-raw`; the online
# preset's shape is also `cli-kvarntorp`'s and `cli-volvo`'s), a target
# budget that is not a multiple of 128 (B_RAGGED, which B1 and B2 take);
# last a ragged shape, checked and not timed. `phase_a_shapes` (run by
# `phase_kernels`) holds A against its twin at each, on `a_inputs`, and
# times it; tools/compare_torch_kernels.py times two trees' A at the same
# shapes.
A_RAGGED = (3, 2, 1000, 1500)
A_VERIFY = (512, 1, 1024, 1024)
A_MERGE = (256, 1, 1024, 1024)
A_MERGE3 = (128, 1, 1024, 1024)
A_ONLINE = (1, 4, 3072, 3072)
A_SWEEP = tuple((1, s, 1024, 1024) for s in (1, 2, 3, 4, 8))
A_CFEAR2 = (1, 3, 2048, 2048)
A_RAW = (1, 4, 4096, 4096)
B_RAGGED = (3, 2, 1024, 1500)
A_SHAPES = ((8, 4, 1024, 1024), (1, 4, 2048, 2048), (8, 4, 2048, 2048),
            (1, 1, 2048, 2048), (27, 4, 2048, 2048), A_VERIFY, A_MERGE,
            A_MERGE3, A_ONLINE, *A_SWEEP, A_CFEAR2, A_RAW, B_RAGGED,
            A_RAGGED)
# operations counted per squared distance (2 subtractions, 2 products, a
# sum; the compare is not counted), per LM row and pass (a cost-only pass,
# and a cost/gradient/Hessian pass, from the twin's arithmetic for P2P), and
# per (point, neighbour offset) moment row of kernel G (12 products and
# sums for the row, 9 accumulations)
NN_FLOPS, LM_COST_FLOPS, LM_CGH_FLOPS, MOMENT_FLOPS = 5, 25, 60, 21


def slice_config(assoc_method: str = "pallas_sparse", spatial_sort=True,
                 feature_backend: str | None = None):
    """CFEAR-3 at Oxford scale with the bench settings (`bench.py:121-143`).
    `slice_config("auto", False)` is the preset as users call it, which
    resolves to the dense kernel A on a CUDA card;
    `slice_config(feature_backend="pallas")` takes kernel G for the
    feature moments."""
    cfg = port.preset("CFEAR-3", dataset="oxford")
    feat = dataclasses.replace(cfg.feature, point_budget=8192, max_cells=1024,
                               spatial_sort=spatial_sort)
    if feature_backend is not None:
        feat = dataclasses.replace(feat, backend=feature_backend)
    return cfg.replace(
        feature=feat,
        registration=dataclasses.replace(cfg.registration,
                                         assoc_method=assoc_method))


def slam_config():
    """CFEAR-3 at Oxford scale with `tools/run_slam_scale.py:60-63`'s
    settings: max_cells 1024, point_budget 8192, Morton-ordered cells;
    `auto` association (S=4 odometry and S=1 verification: kernel A)."""
    cfg = port.preset("CFEAR-3", dataset="oxford")
    return cfg.replace(feature=dataclasses.replace(
        cfg.feature, max_cells=1024, point_budget=8192, spatial_sort=True))


def s50_config(k_active: int = 0):
    """CFEAR-3-s50 at Oxford scale with the bench settings for that preset
    (`bench.py:124-143` under `--preset CFEAR-3-s50`): point_budget 8192,
    max_cells 1024, spatial_sort on, `assoc_method="pallas_sparse"` (kernel
    C); `k_active=16` is `--max-active-keyframes 16`, the K16 gate."""
    cfg = port.preset("CFEAR-3-s50", dataset="oxford")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, point_budget=8192,
                                    max_cells=1024, spatial_sort=True),
        registration=dataclasses.replace(
            cfg.registration, assoc_method="pallas_sparse",
            max_active_keyframes=k_active))


def longrun_config(max_cells: int = 2048, health_every: int = 8):
    """`tools/run_longrun.py`'s configuration: CFEAR-3 at Oxford scale,
    host-compact ingest (point_budget 8192), `max_cells` 2048,
    spatial_sort, `odometry.health_check_every` 8, the preset's
    `assoc_method="auto"` (kernel A on a card: S=4 is under the sparse
    kernel's 8)."""
    cfg = port.preset("CFEAR-3", dataset="oxford")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=max_cells,
                                    point_budget=8192, spatial_sort=True),
        odometry=dataclasses.replace(cfg.odometry,
                                     health_check_every=health_every))


def longrun_golden(sequence) -> str:
    """The golden file of a long-run sequence."""
    adv = "_adv" if sequence.get("n_dynamic") else ""
    return os.path.join(
        _GOLDEN_DIR, f"cfear3_longrun{adv}_seed{sequence['seed']}_"
        f"{sequence['n_frames']}_{sequence['speed']:g}ms.npz")


def blind_config():
    """The long run's configuration with the reverse-registration health
    check on every frame (`health_check_every=1`, as the reference's test
    of the collapsed reverse solve sets it)."""
    return longrun_config(health_every=1)


def blind_images(cfg):
    """BLIND_SEQUENCE's sweeps, all zero from BLIND_FROM on, and its ground
    truth."""
    images, gt = synthetic.make_sequence(cfg=cfg, **BLIND_SEQUENCE)
    images = np.array(images)
    images[BLIND_FROM:] = 0
    return images, gt


def stationary_images(cfg) -> np.ndarray:
    """STATIONARY's frames: one sweep of SEQUENCE's world rendered at the
    origin, repeated (the reference test's case)."""
    rng = np.random.default_rng(STATIONARY["seed"])
    world = synthetic.make_world(rng)
    img = synthetic.render_polar(world, np.zeros(3), cfg, rng)
    return np.stack([img] * STATIONARY["n_frames"])


def overflow_config():
    """The slice with kernel G's feature backend at OVERFLOW_POINT_BUDGET
    points and the default pre_cells."""
    cfg = slice_config(feature_backend="pallas")
    return cfg.replace(feature=dataclasses.replace(
        cfg.feature, point_budget=OVERFLOW_POINT_BUDGET))


def cli_config():
    """The configuration the `cli` path passes with --config-file: the
    CFEAR-3 Oxford preset unmodified (`auto`, no spatial sort: kernel A on
    a card)."""
    return port.preset("CFEAR-3", dataset="oxford")


def cli_args(config_path: str, out_dir: str) -> list:
    """The offline CLI's arguments of the `cli` path (without --cpu)."""
    seq = CLI_SEQUENCE
    return ["--config-file", config_path, "--dataset", "synthetic",
            "--seed", str(seq["seed"]), "--speed", str(seq["speed"]),
            "--n-frames", str(seq["n_frames"]), "--output-dir", out_dir]


def read_cli_run(out_dir: str, period: float) -> dict:
    """What an offline CLI run wrote: poses (T, 3) from `est/00.txt`, the
    keyframe flags (the frames whose stamps are the graph's nodes), and
    the node and edge counts of `simple_graph.npz`, read back through the
    port's `GraphBuilder.load`."""
    rows = np.loadtxt(os.path.join(out_dir, "est", "00.txt")).reshape(-1, 12)
    poses = np.stack([rows[:, 3], rows[:, 7],
                      np.arctan2(rows[:, 4], rows[:, 0])], -1)
    graph = posegraph.GraphBuilder.load(os.path.join(out_dir,
                                                     "simple_graph.npz"))
    fused = np.zeros(len(rows), bool)
    fused[np.rint(np.asarray(graph.stamps) / period).astype(int)] = True
    return {"poses": poses, "fused": fused, "n_nodes": len(graph.poses),
            "n_edges": len(graph.edges),
            "n_scans": sum(s is not None for s in graph.scans)}


def _relative(a, b) -> np.ndarray:
    """The motion taking pose a to pose b, in a's frame (yaw wrapped)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    dth = b[2] - a[2]
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                     np.arctan2(np.sin(dth), np.cos(dth))])


def write_dataset(dataset: str, root: str, n_frames: int = 0) -> np.ndarray:
    """DATASET_SEQUENCES[dataset] rendered (sweep i at trajectory pose i +
    1 with the motion since pose i, its yaw unwrapped, as the reference
    tests' fixture writers render theirs) and written under `root` in the
    released layout (`radar/` and `gt.csv` for Oxford, `polar/` and
    `gt.csv` for MulRan, Kvarntorp and Volvo; see `cli_path_args`); its
    first `n_frames` sweeps only, when given. Returns the sweeps as the
    loader must read them back."""
    seq = DATASET_SEQUENCES[dataset]
    cfg = port.preset("CFEAR-3", dataset=dataset)
    world = synthetic.make_world(np.random.default_rng(seq["world_seed"]))
    dt, n = cfg.radar.sensor_period, n_frames or seq["n_frames"]
    traj = synthetic.make_trajectory(np.random.default_rng(seq["traj_seed"]),
                                     n + 1, dt=dt, speed=seq["speed"])
    unit = 1e6 if dataset == "oxford" else 1e9
    stamps = [seq["t0"] + int(i * dt * unit) for i in range(n + 1)]
    images = []
    for i in range(n):
        motion = _relative(traj[i], traj[i + 1])
        motion[2] = traj[i + 1, 2] - traj[i, 2]
        images.append(synthetic.render_polar(
            world, traj[i + 1], cfg,
            np.random.default_rng(seq["render_seed"] + i), motion=motion,
            t=(i + 1) * dt))
    images = np.stack(images)
    oxford = dataset == "oxford"
    sweeps = radar_dir(dataset, root)
    os.makedirs(sweeps, exist_ok=True)
    for i, img in enumerate(images):
        stored = (np.concatenate([np.zeros((img.shape[0], 11), np.uint8),
                                  img], 1) if oxford
                  else np.ascontiguousarray(np.rot90(img, -1)))
        png.write_png(os.path.join(sweeps, f"{stamps[i + 1]}.png"), stored)
    with open(os.path.join(root, "gt.csv"), "w") as f:
        if oxford:      # relative poses, source -> destination
            f.write("source_radar_timestamp,destination_radar_timestamp,"
                    "x,y,z,roll,pitch,yaw\n")
            for i in range(len(images)):
                rel = _relative(traj[i], traj[i + 1])
                f.write(f"{stamps[i]},{stamps[i + 1]},{rel[0]:.9f},"
                        f"{rel[1]:.9f},0.0,0.0,0.0,{rel[2]:.9f}\n")
        else:           # global poses
            f.write("stamp,x,y,yaw\n")
            for i, p in enumerate(traj):
                f.write(f"{stamps[i] * 1e-9:.6f},{p[0]:.9f},{p[1]:.9f},"
                        f"{p[2]:.9f}\n")
    return images


def cli_path_sequence(name: str) -> dict:
    spec = CLI_PATHS[name]
    return DATASET_SEQUENCES[spec["dataset"]] if "dataset" in spec \
        else CLI_SEQUENCE


def cli_path_args(name: str, root: str, out_dir: str) -> list:
    """The offline CLI's arguments of a `cli-*` path (without --cpu), its
    inputs under `root` (`prepare_cli_path`)."""
    spec = CLI_PATHS[name]
    if "dataset" in spec:
        ds = spec["dataset"]
        return ["--dataset", ds, "--radar-dir", radar_dir(ds, root),
                "--gt-csv", os.path.join(root, "gt.csv"), "--preset",
                spec["preset"], "--output-dir", out_dir]
    seq = CLI_SEQUENCE
    return ["--config-file", os.path.join(root, "config.json"), "--dataset",
            "synthetic", "--seed", str(seq["seed"]), "--speed",
            str(seq["speed"]), "--n-frames", str(seq["n_frames"]),
            *spec.get("extra", ()), "--output-dir", out_dir]


def radar_dir(dataset: str, root: str) -> str:
    """The sweeps' directory of a dataset written under `root`."""
    return os.path.join(root, "radar" if dataset == "oxford" else "polar")


def cli_path_config(name: str):
    """The --config-file of a `cli-*` path without a dataset directory:
    the preset's Oxford form, with the path's association method."""
    spec = CLI_PATHS[name]
    cfg = port.preset(spec["preset"], dataset="oxford")
    if "assoc" in spec:
        cfg = cfg.replace(registration=dataclasses.replace(
            cfg.registration, assoc_method=spec["assoc"]))
    return cfg


def prepare_cli_path(name: str, root: str):
    """Write a `cli-*` path's inputs under `root`: the dataset directory,
    or the path's --config-file. Returns the sweeps of a dataset path
    (None for the others)."""
    spec = CLI_PATHS[name]
    os.makedirs(root, exist_ok=True)
    if "dataset" in spec:
        return write_dataset(spec["dataset"], root)
    cli_path_config(name).save(os.path.join(root, "config.json"))
    return None


def cli_golden_path(name: str) -> str:
    return os.path.join(_GOLDEN_DIR, f"{name.replace('-', '_')}_32.npz")


def run_cli(cli_mod, runner_cls, argv: list) -> dict:
    """One offline CLI run (`cli_mod.main(argv)`, the port's or the
    reference's): the poses of `est/00.txt`, the runner's keyframe and
    success flags and configuration (its `process`, recorded), the graph's
    node and edge counts (`simple_graph.npz` read back by the port's
    `GraphBuilder.load`) and the CLI's result."""
    with recorded(runner_cls, "process") as calls:
        result = cli_mod.main(argv)
    if len(calls) != 1:
        raise AssertionError(f"the CLI ran {len(calls)} odometry passes")
    runner = calls[0][0]["self"]
    out = runner.frame_outputs()
    out_dir = argv[argv.index("--output-dir") + 1]
    rows = np.loadtxt(os.path.join(out_dir, "est", "00.txt")).reshape(-1, 12)
    graph = posegraph.GraphBuilder.load(os.path.join(out_dir,
                                                     "simple_graph.npz"))
    return {"poses": np.stack([rows[:, 3], rows[:, 7],
                               np.arctan2(rows[:, 4], rows[:, 0])], -1),
            "fused": np.asarray(out.fused), "success": np.asarray(out.success),
            "cfg": runner.cfg.to_dict(), "result": result,
            "n_nodes": len(graph.poses), "n_edges": len(graph.edges),
            "n_scans": sum(s is not None for s in graph.scans),
            "runner": runner}


@contextlib.contextmanager
def recorded(owner, name: str):
    """While the block runs, `owner.name` (a module's function or a class's
    method) appends each call's (arguments by parameter name, result) to the
    list it yields."""
    calls, orig = [], getattr(owner, name)
    sig = inspect.signature(orig)

    def spy(*args, **kw):
        out = orig(*args, **kw)
        calls.append((sig.bind(*args, **kw).arguments, out))
        return out

    setattr(owner, name, spy)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)


def merge_errors(opt_b, poses_b, gt_b) -> tuple:
    """B's keyframe position RMSE (m) after the merge (`opt_b`, its rows of
    the merged poses) and with the identity alignment (`poses_b`, its own
    odometry poses), against its ground-truth keyframe poses `gt_b`; A's
    frame is the world's (both start at the route's origin)."""
    def rmse(p):
        return float(np.sqrt(np.mean(np.sum((p[:, :2] - gt_b[:, :2]) ** 2,
                                            1))))
    return rmse(opt_b), rmse(poses_b)


def merge3_args(graphs: list, out: str, tum: str) -> list:
    """The merge CLI's arguments of the `merge-cli3` path (without --cpu):
    the session graphs, the merged graph and TUM outputs, the CFEAR-3
    Oxford preset at `slam_config`'s cell budget and MERGE_ITERS."""
    return [*graphs, "--out", out, "--tum", tum, "--dataset", "oxford",
            "--max-cells", str(slam_config().feature.max_cells), "--iters",
            str(MERGE_ITERS)]


def read_tum(path: str) -> np.ndarray:
    """A TUM pose file as (N, 4) rows of stamp, x, y, and the yaw from its
    quaternion (z, w)."""
    rows = np.loadtxt(path).reshape(-1, 8)
    return np.stack([rows[:, 0], rows[:, 1], rows[:, 2],
                     2.0 * np.arctan2(rows[:, 6], rows[:, 7])], -1)


def _say(msg: str) -> None:
    print(msg, flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# Plain twins and library routes whose calls outlasted the timer's spin
# (`_cuda_ms`): their times are the host's pace, not the card's alone.
host_paced: list = []
SPIN_CYCLES = 20_000_000          # ~10 ms at the H100's clock
MAX_SPIN_CYCLES = 16 * SPIN_CYCLES


def _cuda_ms(fn, n: int, twin: str = "") -> float:
    """Mean device ms per call of fn() over n calls, by CUDA events, after
    warm-up. The calls are queued behind a spin on the stream, so the card
    runs them back to back however long the host takes to launch each: a
    kernel of 20 us is timed, not the 40-80 us its wrapper takes on the
    host. An event recorded straight after the spin tells whether that
    held: if it has completed when the last call has been queued, the
    queue drained and the time is the host's pace. A kernel is then timed
    again behind a spin four times as long, and the smoke fails when the
    longest does not cover the host. `twin` names a plain twin or library
    route (many launches, host syncs), which may outlast any spin: it is
    timed once, at the host's pace if need be, as it runs in use, and then
    listed in `host_paced`."""
    fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    while True:
        start, gate, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        torch.cuda._sleep(spin)
        gate.record()
        start.record()
        for _ in range(n):
            fn()
        ahead = not gate.query()   # the spin still ran: nothing started yet
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / n
        if ahead:
            return ms
        if twin:
            if twin not in host_paced:
                host_paced.append(twin)
            return ms
        if spin >= MAX_SPIN_CYCLES:
            raise AssertionError(
                f"timer: the host took longer to queue {n} calls than a "
                f"spin of {spin} cycles; {ms:.4f} ms is not a device time")
        spin *= 4


def sass_loop(lib_path, function):
    """The inner loop of `function` (a substring of its mangled name) in the
    built library, by `cuobjdump -sass`: the basic block (cut at every
    branch and branch target) with the most FMUL, two a distance. In kernel
    C's, A's, D1's and D2's form that block is the whole branch-free loop
    over a group of targets; in a loop with branches inside (a first form's)
    it is only a part. Returns {instructions, fmul, fmnmx,
    slots_per_distance}, or None where the library has no such function:
    every instruction takes one issue slot of its SM sub-partition."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*)")
    for chunk in sass.split("Function : ")[1:]:
        if function not in chunk.split(None, 1)[0]:
            continue
        code = [(int(m.group(1), 16), m.group(2), m.group(3))
                for m in map(ins.search, chunk.splitlines()) if m]
        cuts = {int(t, 16) for _, o, rest in code if o == "BRA"
                for t in re.findall(r"0x([0-9a-f]+)", rest)}
        cuts |= {a + 16 for a, o, _ in code if o in ("BRA", "EXIT")}
        blocks = [[]]
        for a, o, _ in code:
            if a in cuts:
                blocks.append([])
            if o != "NOP":
                blocks[-1].append(o)
        body = max(blocks, key=lambda b: sum(o.startswith("FMUL") for o in b))
        n_mul = sum(o.startswith("FMUL") for o in body)
        return {"instructions": len(body), "fmul": n_mul,
                "fmnmx": sum(o.startswith("FMNMX") for o in body),
                "slots_per_distance": len(body) / max(n_mul / 2, 1)}
    return None


def max_sm_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


@functools.lru_cache(maxsize=None)
def _loop(function: str) -> dict:
    loop = sass_loop(_build.library()._name, function)
    if loop is None:
        raise AssertionError(f"no function {function} in the built library")
    return loop


@functools.lru_cache(maxsize=None)
def _issue_hz() -> float:
    """Issue slots a second of the card: SMs x 128 lanes x top SM clock."""
    return (torch.cuda.get_device_properties(0).multi_processor_count * 128
            * max_sm_hz())


def issue_floor_ms(function: str, distances: float) -> float:
    """The least time `distances` distance evaluations take through the
    inner loop of `function`: its SASS instructions a distance over the
    card's issue slots a second."""
    return (distances * _loop(function)["slots_per_distance"] / _issue_hz()
            * 1e3)


def bound(nbytes: float, flops: float) -> dict:
    """`bound_ms` and `bound_by` of a kernel call from its bytes and
    operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nn_bound(src, tar, valid, share: float = 1.0, extra_bytes: int = 0):
    """The bound of one 1-NN call: src, tar and valid read, nn and d2
    written, NN_FLOPS per distance over the `share` of (source, target)
    pairs the call must evaluate (the executed tile pairs of a block-sparse
    kernel)."""
    b, s, m = valid.shape
    m_src = src.shape[1]
    nbytes = b * m_src * 8 + b * s * m * 9 + b * s * m_src * 8 + extra_bytes
    return bound(nbytes, NN_FLOPS * b * s * m_src * m * share)


def library_nn(src, tar, valid):
    """The closest PyTorch library route to the 1-NN kernels, timed beside
    them and called nowhere in the port: `torch.cdist` over every (source,
    target) pair of each keyframe, invalid targets masked, then `min`."""
    b, s, m = valid.shape
    d = torch.cdist(src[:, None].expand(b, s, -1, 2).reshape(b * s, -1, 2),
                    tar.reshape(b * s, m, 2))
    return d.masked_fill_(~valid.reshape(b * s, 1, m), float("inf")).min(-1)


def library_nn_attrs(src, tar, valid, attrs_t):
    """`library_nn` and then `torch.gather` of the winners' attribute
    columns: the library route of kernel E."""
    d, nn = library_nn(src, tar, valid)
    b, s, d_pad, _ = attrs_t.shape
    idx = nn.reshape(b, s, 1, -1).expand(b, s, d_pad, -1)
    return d, nn, torch.gather(attrs_t, 3, idx)


def _wall_world(rng):
    """4,800 points on 24 random 60 m walls within +-110 m."""
    walls = []
    for _ in range(24):
        p0 = rng.uniform(-110, 110, 2)
        ang = rng.uniform(0, 2 * np.pi)
        t = rng.uniform(0, 60, 200)
        walls.append(p0 + np.stack([np.cos(ang) * t, np.sin(ang) * t], -1))
    return np.concatenate(walls)


def _morton_cells(rng, b, s, m, dev):
    """Slice-shaped association inputs: per lane a wall world seen by S+1
    scans of m cells (~900 of 1024 valid, in proportion for other m,
    Morton-ordered by 3 m voxel, padding last), keyframes a few metres
    apart. The last lane's last keyframe is empty, unless it is the only
    one; lane 0's first keyframe holds two identical targets in different
    512-row tiles with a source point on them (an exact tie)."""
    leaf = 3.0
    src = np.zeros((b, m, 2), np.float32)
    tar = np.zeros((b, s, m, 2), np.float32)
    valid = np.zeros((b, s + 1, m), bool)
    for i in range(b):
        world = _wall_world(rng)
        for k in range(s + 1):
            n = int(rng.integers(850, 1000)) * m // 1024
            pts = world[rng.choice(len(world), n, replace=False)]
            pts = pts + rng.normal(0, 0.3, pts.shape) + k * 1.5
            ij = np.floor(pts / leaf).astype(np.int64) + 64
            code = np.zeros(n, np.int64)
            for bit in range(8):
                code |= ((ij[:, 0] >> bit) & 1) << (2 * bit)
                code |= ((ij[:, 1] >> bit) & 1) << (2 * bit + 1)
            pts = pts[np.argsort(code, kind="stable")]
            rows = src[i] if k == 0 else tar[i, k - 1]
            rows[:n] = pts
            valid[i, k, :n] = True
    if b * s > 1:
        valid[b - 1, s] = False
    tar[0, 0, 700] = tar[0, 0, 300]
    valid[0, 1, [300, 700]] = True
    src[0, 5] = tar[0, 0, 300]
    to = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return to(src), to(valid[:, 0]), to(tar), to(valid[:, 1:])


def c_inputs(dev, b, s, m_src, m, radius=2.0, seed=0):
    """Kernel C's arguments (src, src_bounds, tar, tar_bounds, valid,
    radius) at a shape of C_SHAPES: `_morton_cells` of m cells, the first
    m_src source rows, the association radius (2 m; 4 m in the first
    iteration)."""
    src, src_valid, tar, valid = _morton_cells(np.random.default_rng(seed),
                                               b, s, m, dev)
    src, src_valid = src[:, :m_src].contiguous(), src_valid[:, :m_src]
    return (src, cuda_assoc.tile_bounds(src, src_valid, cuda_assoc.TS_SPARSE),
            tar, cuda_assoc.tile_bounds(tar, valid, cuda_assoc.TT_SPARSE),
            valid, torch.full((b,), radius, device=dev))


def a_inputs(dev, b, s, m_src, m, seed=0):
    """Kernel A's arguments (src, tar, valid) at a shape of A_SHAPES:
    `_morton_cells` of m cells, the first m_src source rows."""
    src, _, tar, valid = _morton_cells(np.random.default_rng(seed), b, s, m,
                                       dev)
    return src[:, :m_src].contiguous(), tar, valid.contiguous()


def shape_key(b, s, m_src, m) -> str:
    return f"B={b} S={s} Msrc={m_src} M={m}"


def _hold(name, key, kernel, plain, args):
    """1-NN kernel `name` against its twin on `args` at shape `key`:
    bit-equal, two launches bit-identical, the first and last lane equal
    to their own B=1 calls. Returns the kernel's and the twin's (nn, d2)."""
    b = args[0].shape[0]
    got, again = kernel(*args), kernel(*args)
    alone = {i: kernel(*(a[i:i + 1].contiguous() for a in args))
             for i in sorted({0, b - 1})}
    want = plain(*args)
    torch.cuda.synchronize()
    if not all(map(torch.equal, got, want)):
        raise AssertionError(f"kernel {name} at {key} disagrees with its "
                             f"twin: {int((got[0] != want[0]).sum())} nn "
                             "mismatches")
    if not all(map(torch.equal, again, got)):
        raise AssertionError(f"kernel {name} at {key}: two launches differ")
    for i, one in alone.items():
        if not all(torch.equal(x[0], y[i]) for x, y in zip(one, got)):
            raise AssertionError(f"kernel {name} at {key}: lane {i} differs "
                                 "from its B=1 call")
    return got, want


def phase_a_shapes(dev, card):
    """Kernel A at every shape of A_SHAPES: bit-equal to its twin, two
    launches bit-identical, the first and last lane of a call equal to
    their own B=1 calls; then, but for A_RAGGED, timed beside its bound,
    `cdist + min` and its twin. Returns {shape_key: record}."""
    res = {}
    for shape in A_SHAPES:
        args = a_inputs(dev, *shape)
        key = shape_key(*shape)
        (nn_a, d2_a), (_, d2_q) = _hold("A", key, cuda_assoc.nn_min,
                                        cuda_assoc.nn_min_plain, args)
        # `_morton_cells`' tie, and its empty keyframe where it has one
        empty = shape[0] * shape[1] == 1 or torch.isinf(d2_a[-1, -1]).all()
        if nn_a[0, 0, 5].item() != 300 or not empty:
            raise AssertionError(f"kernel A at {key}: the tie or the empty "
                                 "keyframe is wrong")
        fin = torch.isfinite(d2_q)
        res[key] = r = {"max_abs_err": float((d2_a[fin] - d2_q[fin]).abs()
                                             .max())}
        if shape == A_RAGGED:
            _say(f"kernel A {key}: bit-equal to its twin, repeat and lanes "
                 "bit-identical (not timed)")
            continue
        r.update(ms=_cuda_ms(lambda: cuda_assoc.nn_min(*args), 100),
                 **nn_bound(*args),
                 library_ms=_cuda_ms(lambda: library_nn(*args), 5,
                                     "cdist + min"))
        r["plain_ms"] = _cuda_ms(lambda: cuda_assoc.nn_min_plain(*args),
                                 5, "nn_min_plain")
        _say(f"kernel A {key}: bit-equal to its twin, repeat and lanes "
             f"bit-identical; kernel {r['ms']:.4f} ms, bound "
             f"{r['bound_ms']:.4f} ms ({r['bound_by']}), cdist + min "
             f"{r['library_ms']:.4f} ms ({card})")
    return res


def b_shapes():
    """The shapes of A_SHAPES kernels B1 and B2 take, as the reference's
    (Msrc % ts_multi(M) == 0): all but A_RAGGED."""
    return [sh for sh in A_SHAPES if sh[2] % cuda_assoc.ts_multi(sh[3]) == 0]


def phase_b_shapes(dev, card, a_recs):
    """Kernels B1 and B2 at every shape of `b_shapes()`: bit-equal to
    kernel A and its twin, two launches bit-identical, the first and last
    lane of a call equal to their own B=1 calls (`_hold`, against the
    twin's output computed once a shape); then timed beside A's time at
    the shape (`a_recs`, `phase_a_shapes`' records of this run), its bound
    and `cdist + min`, and the issue-slot floor of their own loop. Returns
    {name: {"sass": loop, "by_shape": {shape_key: record}}}."""
    res = {k: {"sass": _loop(f), "by_shape": {}}
           for k, f in B_FUNCTIONS.items()}
    for shape in b_shapes():
        args = a_inputs(dev, *shape)
        key = shape_key(*shape)
        a_out = cuda_assoc.nn_min(*args)
        want = cuda_assoc.nn_min_plain(*args)
        torch.cuda.synchronize()
        if not all(map(torch.equal, a_out, want)):
            raise AssertionError(f"kernel A at {key} differs from its twin")
        a = a_recs[key]
        fin = torch.isfinite(want[1])
        for name, function in B_FUNCTIONS.items():
            fn = getattr(cuda_assoc, name)
            (nn_b, d2_b), _ = _hold(name, key, fn, lambda *_: want, args)
            if not (torch.equal(nn_b, a_out[0]) and torch.equal(d2_b, a_out[1])):
                raise AssertionError(f"kernel {name} at {key} differs from "
                                     "kernel A")
            groups, split = cuda_assoc.multi_split(*shape)
            r = res[name]["by_shape"][key] = {
                "max_abs_err": float((d2_b[fin] - want[1][fin]).abs().max()),
                "ms": _cuda_ms(lambda: fn(*args), 100), "a_ms": a["ms"],
                "groups": groups, "split": split,
                "floor_ms": issue_floor_ms(function, float(np.prod(shape))),
                **{k: a[k] for k in ("bound_ms", "bound_by", "library_ms")}}
            _say(f"kernel {name} {key}: bit-equal to A and its twin, repeat "
                 f"and lanes bit-identical; {groups} keyframe groups, "
                 f"cluster {split}; kernel {r['ms']:.4f} ms "
                 f"({r['ms'] / r['a_ms']:.2f}x A's {r['a_ms']:.4f}), "
                 f"issue-slot floor {r['floor_ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms ({card})")
    return res


def phase_c_shapes(dev, card):
    """Kernel C at every shape of C_SHAPES: bit-equal to its twin, two
    launches bit-identical, the first and last lane of a B=8 call equal to
    their own B=1 calls; then timed beside its bound at the executed share
    of tile pairs and `cdist + min`. Returns {shape_key: record}."""
    res = {}
    for shape in C_SHAPES:
        args = c_inputs(dev, *shape)
        key = shape_key(*shape)
        (nn_c, d2_c), (_, d2_q) = _hold(
            "C", key, cuda_assoc.nn_min_sparse,
            cuda_assoc.nn_min_sparse_plain, args)
        live = float(cuda_assoc.pair_live(args[1], args[3], args[5])
                     .float().mean())
        fin = torch.isfinite(d2_q)
        res[key] = {
            "max_abs_err": float((d2_c[fin] - d2_q[fin]).abs().max()),
            "ms": _cuda_ms(lambda: cuda_assoc.nn_min_sparse(*args), 100),
            **nn_bound(args[0], args[2], args[4], live,
                       args[1].numel() * 4 + args[3].numel() * 4),
            "library_ms": _cuda_ms(lambda: library_nn(args[0], args[2],
                                                      args[4]), 5,
                                   "cdist + min"),
            "live_pairs": live}
        r = res[key]
        _say(f"kernel C {key}: bit-equal to its twin, repeat and lanes "
             f"bit-identical; executed tile pairs {live:.4f}; kernel "
             f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
             f"({r['bound_by']}), cdist + min {r['library_ms']:.4f} ms "
             f"({card})")
    return res


def phase_d_shapes(dev, card, c_recs):
    """Kernels D1 and D2 at every shape of C_SHAPES: bit-equal to kernel C
    and its twin, two launches bit-identical, the first and last lane of a
    call equal to their own B=1 calls (`_hold`); then timed beside C's
    time at the shape (`c_recs`, `phase_c_shapes`' records of this run),
    its bound and `cdist + min`, and the issue-slot floor of their own
    loop at the executed share of tile pairs. Returns {name: {"sass":
    loop, "by_shape": {shape_key: record}}}."""
    res = {k: {"sass": _loop(f), "by_shape": {}}
           for k, f in D_FUNCTIONS.items()}
    for shape in C_SHAPES:
        args = c_inputs(dev, *shape)
        key = shape_key(*shape)
        c_out = cuda_assoc.nn_min_sparse(*args)
        c = c_recs[key]
        distances = float(np.prod(shape)) * c["live_pairs"]
        for name, function in D_FUNCTIONS.items():
            fn = getattr(cuda_assoc, name)
            (nn_d, d2_d), (_, d2_q) = _hold(
                name, key, fn, cuda_assoc.nn_min_sparse_plain, args)
            if not (torch.equal(nn_d, c_out[0])
                    and torch.equal(d2_d, c_out[1])):
                raise AssertionError(f"kernel {name} at {key} differs from "
                                     "kernel C")
            fin = torch.isfinite(d2_q)
            r = res[name]["by_shape"][key] = {
                "max_abs_err": float((d2_d[fin] - d2_q[fin]).abs().max()),
                "ms": _cuda_ms(lambda: fn(*args), 100), "c_ms": c["ms"],
                "groups": cuda_assoc.walk_groups(*shape),
                "floor_ms": issue_floor_ms(function, distances),
                **{k: c[k] for k in ("bound_ms", "bound_by", "library_ms",
                                     "live_pairs")}}
            _say(f"kernel {name} {key}: bit-equal to C and its twin, repeat "
                 f"and lanes bit-identical; {r['groups']} keyframe groups; "
                 f"kernel {r['ms']:.4f} ms ({r['ms'] / r['c_ms']:.2f}x C's "
                 f"{r['c_ms']:.4f}), issue-slot floor {r['floor_ms']:.4f} ms, "
                 f"bound {r['bound_ms']:.4f} ms ({card})")
    return res


def e_inputs(dev, shape, d_pad=8, seed=5):
    """Kernel E's arguments at a shape of C_SHAPES, in its argument order:
    `c_inputs` and random attribute columns attrs_t (B, S, D_pad, M); and
    the same columns as rows (B, S, M, D_pad), the flat gather's input."""
    args = c_inputs(dev, *shape)
    b, s, _, m = shape
    at = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(b, s, d_pad, m)).astype(np.float32)).to(dev)
    return (*args[:5], at, args[5]), at.transpose(-1, -2).contiguous()


def phase_e_shapes(dev, card, c_recs):
    """Kernel E at every shape of C_SHAPES with D_pad 8, and at E_WIDE also
    with 16: its (nn, d2) bit-equal to kernel C's, g to its twin's, two
    launches bit-identical, the first and last lane of a call equal to their
    own B=1 calls (`_hold`); then timed beside C's time at the shape
    (`c_recs`, `phase_c_shapes`' records of this run) and C + the flat
    gather (`registration._gather_attrs`, what the main path runs), with
    the issue-slot floor of its own loop at the executed share of tile
    pairs. Returns {"sass": E's loop, "c_sass": C's, "by_shape":
    {shape_key: record}}."""
    res = {"sass": _loop(E_FUNCTION), "c_sass": _loop(C_FUNCTION),
           "by_shape": {}}
    for shape in C_SHAPES:
        c = c_recs[shape_key(*shape)]
        for d_pad in (8, 16) if shape == E_WIDE else (8,):
            args, attrs = e_inputs(dev, shape, d_pad)
            c_args = (*args[:5], args[6])
            key = shape_key(*shape) + f" D_pad={d_pad}"
            c_out = cuda_assoc.nn_min_sparse(*c_args)
            (nn_e, d2_e, g_e), (_, d2_q, _) = _hold(
                "E", key, cuda_assoc.nn_min_sparse_attrs,
                cuda_assoc.nn_min_sparse_attrs_plain, args)
            if not (torch.equal(nn_e, c_out[0])
                    and torch.equal(d2_e, c_out[1])):
                raise AssertionError(f"kernel E at {key}: (nn, d2) differ "
                                     "from kernel C's")
            fin = torch.isfinite(d2_q)
            r = res["by_shape"][key] = {
                "max_abs_err": float((d2_e[fin] - d2_q[fin]).abs().max()),
                "split": cuda_assoc.sparse_split(*shape),
                "ms": _cuda_ms(lambda: cuda_assoc.nn_min_sparse_attrs(*args),
                               100),
                "c_ms": c["ms"],
                "c_gather_ms": _cuda_ms(lambda: registration._gather_attrs(
                    attrs, cuda_assoc.nn_min_sparse(*c_args)[0]), 100,
                    "C + gather"),
                "floor_ms": issue_floor_ms(
                    E_FUNCTION, float(np.prod(shape)) * c["live_pairs"]),
                **nn_bound(args[0], args[2], args[4], c["live_pairs"],
                           (args[1].numel() + args[3].numel()
                            + args[5].numel() + g_e.numel()) * 4),
                "live_pairs": c["live_pairs"]}
            _say(f"kernel E {key}: (nn, d2) bit-equal to C, g to its twin, "
                 f"repeat and lanes bit-identical; cluster {r['split']}; "
                 f"kernel {r['ms']:.4f} ms ({r['ms'] / r['c_ms']:.2f}x C's "
                 f"{r['c_ms']:.4f}; C + gather {r['c_gather_ms']:.4f}), "
                 f"issue-slot floor {r['floor_ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms ({card})")
    _say(f"kernels C / E inner loop (cuobjdump -sass): "
         f"{res['c_sass']['instructions']} / {res['sass']['instructions']} "
         f"instructions, {res['c_sass']['slots_per_distance']:.3f} / "
         f"{res['sass']['slots_per_distance']:.3f} issue slots a distance")
    return res


def phase_kernels(dev, card):
    """Kernels A and C against their plain twins at the slice's shapes,
    A at every shape of A_SHAPES (`phase_a_shapes`) and B1 and B2 there
    against A (`phase_b_shapes`), C at every shape of C_SHAPES
    (`phase_c_shapes`), and D1, D2 (`phase_d_shapes`) and E
    (`phase_e_shapes`) there against C."""
    b, s, m = BATCH, 4, 1024
    src, src_valid, tar, valid = _morton_cells(np.random.default_rng(0),
                                               b, s, m, dev)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    _say(f"build: {len(_build.SOURCES)} sources, nvcc in parallel, then "
         f"link: {build_s:.2f} s ({card})")
    for line in (_build.build_info.get("cmd") or "cached").splitlines():
        _say(f"  {line}")
    for line in _build.build_info.get("report", "").splitlines():
        _say(f"  ptxas: {line}")
    res = {}
    nn_a, d2_a = cuda_assoc.nn_min(src, tar, valid)
    nn_p, d2_p = cuda_assoc.nn_min_plain(src, tar, valid)
    torch.cuda.synchronize()
    if not (torch.equal(nn_a, nn_p) and torch.equal(d2_a, d2_p)):
        raise AssertionError("kernel A disagrees with nn_min_plain: "
                             f"{int((nn_a != nn_p).sum())} nn mismatches")
    if nn_a[0, 0, 5].item() != 300:
        raise AssertionError("kernel A: tie not resolved to the lowest index")
    if not torch.isinf(d2_a[7, s - 1]).all():
        raise AssertionError("kernel A: empty keyframe must give +inf")
    fin = torch.isfinite(d2_p)
    lib_ms = _cuda_ms(lambda: library_nn(src, tar, valid), 20,
                      "cdist + min")
    res["nn_min"] = {
        "max_abs_err": float((d2_a[fin] - d2_p[fin]).abs().max()),
        "ms": _cuda_ms(lambda: cuda_assoc.nn_min(src, tar, valid), 200),
        "plain_ms": _cuda_ms(lambda: cuda_assoc.nn_min_plain(src, tar, valid),
                             20, "nn_min_plain"),
        **nn_bound(src, tar, valid), "library_ms": lib_ms,
        "by_shape": phase_a_shapes(dev, card)}
    sb = cuda_assoc.tile_bounds(src, src_valid, cuda_assoc.TS_SPARSE)
    tb = cuda_assoc.tile_bounds(tar, valid, cuda_assoc.TT_SPARSE)
    errs, times, ptimes, bounds = [], [], [], []
    for r in (2.0, 4.0):
        radius = torch.full((b,), r, device=dev)
        nn_c, d2_c = cuda_assoc.nn_min_sparse(src, sb, tar, tb, valid, radius)
        nn_q, d2_q = cuda_assoc.nn_min_sparse_plain(src, sb, tar, tb, valid,
                                                    radius)
        torch.cuda.synchronize()
        if not (torch.equal(nn_c, nn_q) and torch.equal(d2_c, d2_q)):
            raise AssertionError(f"kernel C (r={r}) disagrees with "
                                 "nn_min_sparse_plain")
        within = d2_p <= r * r
        if not (torch.equal(nn_c[within], nn_p[within])
                and torch.equal(d2_c[within], d2_p[within])):
            raise AssertionError(f"kernel C (r={r}) differs from A within "
                                 "the radius")
        if not (d2_c[~within] >= r * r).all():
            raise AssertionError(f"kernel C (r={r}): a row beyond the radius "
                                 "reports d2 < r^2")
        fin = torch.isfinite(d2_q)
        errs.append(float((d2_c[fin] - d2_q[fin]).abs().max()))
        times.append(_cuda_ms(lambda: cuda_assoc.nn_min_sparse(
            src, sb, tar, tb, valid, radius), 200))
        ptimes.append(_cuda_ms(lambda: cuda_assoc.nn_min_sparse_plain(
            src, sb, tar, tb, valid, radius), 20, "nn_min_sparse_plain"))
        share = float(cuda_assoc.pair_live(sb, tb, radius).float().mean())
        bounds.append(nn_bound(src, tar, valid, share,
                               sb.numel() * 4 + tb.numel() * 4))
        _say(f"kernel C r={r}: rows within radius "
             f"{float(within.float().mean()):.3f}, kernel {times[-1]:.4f} ms, "
             f"plain {ptimes[-1]:.4f} ms ({card})")
    # the executed tile pairs set the operations; both radii are averaged
    res["nn_min_sparse"] = {"max_abs_err": max(errs),
                            "ms": float(np.mean(times)),
                            "plain_ms": float(np.mean(ptimes)),
                            "bound_ms": float(np.mean(
                                [x["bound_ms"] for x in bounds])),
                            "bound_by": bounds[0]["bound_by"],
                            "library_ms": lib_ms,
                            "by_shape": phase_c_shapes(dev, card)}
    res.update(phase_b_shapes(dev, card, res["nn_min"]["by_shape"]))
    res.update(phase_d_shapes(dev, card, res["nn_min_sparse"]["by_shape"]))
    res["nn_min_sparse_attrs"] = phase_e_shapes(
        dev, card, res["nn_min_sparse"]["by_shape"])
    _say(f"kernel A: nn equal, d2 bit-equal; kernel {res['nn_min']['ms']:.4f}"
         f" ms, plain {res['nn_min']['plain_ms']:.4f} ms, bound "
         f"{res['nn_min']['bound_ms']:.4f} ms, cdist + min {lib_ms:.4f} ms "
         f"at B={b} S={s} M={m} ({card})")
    _say("kernel C: nn equal, d2 bit-equal to its twin and to A within the "
         "radius, d2 >= r^2 beyond it")
    return res


def lm_problem(rng, b, s, m, cost, loss):
    """`b` packed LM problems shaped like the slice's associations: per lane
    m source cells on a wall world (88% valid), each seen in s keyframes
    with 0.15 m noise and 8% gross outliers, weights 0.3-2 with 15% of the
    associations dropped, random unit normals (P2L) and random sqrt-
    information (P2D). Returns (cfg, packed (b, 8, s*m), pose0 (b, 3),
    true pose (b, 3)) as numpy f32; pose0 is the true pose perturbed by
    ~0.3 m / 0.02 rad."""
    cfg = slice_config()
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, cost=cost, loss=loss))
    n_ok = int(0.88 * m)
    src = np.zeros((b, m, 2))
    for i in range(b):
        world = _wall_world(rng)
        src[i, :n_ok] = (world[rng.choice(len(world), n_ok, replace=False)]
                         + rng.normal(0, 0.3, (n_ok, 2)))
    true = rng.uniform(-1, 1, (b, 3)) * np.array([1.5, 0.5, 0.05])
    c, sn = np.cos(true[:, 2])[:, None], np.sin(true[:, 2])[:, None]
    moved = np.stack([c * src[..., 0] - sn * src[..., 1] + true[:, :1],
                      sn * src[..., 0] + c * src[..., 1] + true[:, 1:2]], -1)
    tgt = moved[:, None] + rng.normal(0, 0.15, (b, s, m, 2))
    out = rng.random((b, s, m)) < 0.08
    tgt[out] += rng.uniform(-4, 4, (int(out.sum()), 2))
    w = rng.uniform(0.3, 2.0, (b, s, m)) * (rng.random((b, s, m)) < 0.85)
    w[..., n_ok:] = 0.0
    if cost == "P2L":
        ang = rng.uniform(0, 2 * np.pi, (b, s, m))
        r5, r6, r7 = np.cos(ang), np.sin(ang), np.zeros((b, s, m))
    elif cost == "P2D":
        r5, r6, r7 = (rng.uniform(0.5, 2, (b, s, m)), rng.normal(0, 0.3, (b, s, m)),
                      rng.uniform(0.5, 2, (b, s, m)))
    else:
        r5, r6, r7 = np.ones((b, s, m)), np.zeros((b, s, m)), np.ones((b, s, m))
    sx = np.broadcast_to(src[:, None, :, 0], (b, s, m))
    sy = np.broadcast_to(src[:, None, :, 1], (b, s, m))
    packed = np.stack([a.reshape(b, s * m) for a in
                       (sx, sy, tgt[..., 0], tgt[..., 1], w, r5, r6, r7)], 1)
    pose0 = true + rng.normal(0, 1, (b, 3)) * np.array([0.3, 0.3, 0.02])
    f32 = np.float32
    return cfg, packed.astype(f32), pose0.astype(f32), true.astype(f32)


def lm_bound(packed, steps) -> dict:
    """The bound of one kernel F call: the packed rows read once, and per
    lane one cost-only pass per accepted step and one cost/gradient/Hessian
    pass per accepted step and for the start (rejected steps, which the
    kernel also evaluates, are not counted: a lower bound on the work)."""
    b, _, n = packed.shape
    steps = steps.to(torch.float64)
    flops = float((n * (LM_COST_FLOPS * steps
                        + LM_CGH_FLOPS * (steps + 1))).sum())
    return bound(packed.numel() * 4 + b * 9 * 4, flops)


def lm_inputs(rng, dev, s, m, cost, loss, b=BATCH):
    """`lm_problem` at B=b lanes on the card: (cfg, packed, pose0, true)."""
    cfg, packed, pose0, true = lm_problem(rng, b, s, m, cost, loss)
    return (cfg, *(torch.as_tensor(a).to(dev) for a in (packed, pose0, true)))


def lm_shape_key(s, m, cost, loss) -> str:
    """The key of an LM_SHAPES entry in the `*_by_n` records: N, and the
    cost and loss after it for a pair other than P2P/Huber."""
    return str(s * m) if (cost, loss) == ("P2P", "Huber") \
        else f"{s * m} {cost}/{loss}"


def _lm_case(rng, dev, card, s, m, cost, loss, b=BATCH):
    """Kernel F, both variants, on `lm_problem(rng, b, s, m, cost, loss)`
    against its plain twin, and each lane (the first and last when b >
    BATCH) solved alone (B=1) against the same lane of the batched call.
    Returns a record: |dpose|, the device ms of the early-exit and masked
    variants at B=b and of lane 0 alone, the twin's ms, the bound and N."""
    cfg, packed, pose0, true = lm_inputs(rng, dev, s, m, cost, loss, b)
    ee = cuda_lm.lm_solve_fused(packed, pose0, cfg, early_exit=True)
    masked = cuda_lm.lm_solve_fused(packed, pose0, cfg, early_exit=False)
    lanes = range(b) if b <= BATCH else sorted({0, b - 1})
    alone = {i: cuda_lm.lm_solve_fused(packed[i:i + 1].contiguous(),
                                       pose0[i:i + 1].contiguous(), cfg)
             for i in lanes}
    plain = cuda_lm.lm_solve_fused_plain(packed, pose0, cfg)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(ee, masked)):
        raise AssertionError(f"kernel F {cost}/{loss}: early exit and "
                             "masked variants differ")
    for i, one in alone.items():
        if not all(torch.equal(x[i], y[0]) for x, y in zip(ee, one)):
            raise AssertionError(f"kernel F {cost}/{loss}: lane {i} of the "
                                 f"B={b} call differs from its B=1 call")
    apart = torch.nonzero(ee[2] != plain[2]).flatten().tolist()
    if apart and loss not in LM_STEPS_FREE:
        raise AssertionError(
            f"kernel F {cost}/{loss}: accepted steps differ from the twin's "
            f"in lanes {apart}")
    same = ee[2] == plain[2]
    dpose = float((ee[0] - plain[0])[same].abs().max()) if same.any() else 0.0
    dcost = float(((ee[1] - plain[1]).abs() / plain[1].abs()).max())
    tol = LM_POSE_TOL_LOSS.get(loss, LM_POSE_TOL)
    if not (np.isfinite(dpose) and dpose <= tol and dcost <= LM_COST_RTOL):
        raise AssertionError(
            f"kernel F {cost}/{loss} disagrees with its twin: pose "
            f"{dpose:.3e} (tol {tol}), cost rel {dcost:.3e} "
            f"(tol {LM_COST_RTOL})")
    off = float((ee[0] - true).abs().max())
    n = 100 if s * m <= 16384 else 30
    t_ee = _cuda_ms(lambda: cuda_lm.lm_solve_fused(packed, pose0, cfg), n)
    t_m = _cuda_ms(lambda: cuda_lm.lm_solve_fused(
        packed, pose0, cfg, early_exit=False), n)
    t_1 = _cuda_ms(lambda: cuda_lm.lm_solve_fused(
        packed[:1], pose0[:1], cfg), n)
    t_p = _cuda_ms(lambda: cuda_lm.lm_solve_fused_plain(packed, pose0, cfg),
                   5, "lm_solve_fused_plain")
    t_p1 = _cuda_ms(lambda: cuda_lm.lm_solve_fused_plain(
        packed[:1], pose0[:1], cfg), 5, "lm_solve_fused_plain")
    steps = ee[2].tolist() if b <= BATCH else (
        f"{float(ee[2].float().mean()):.2f} a lane on average")
    _say(f"kernel F {cost}/{loss}: early exit == masked and B=1 == lane of "
         f"B={b} bit for bit; vs twin |dpose| {dpose:.3e}, cost rel "
         f"{dcost:.3e}; steps {steps} (lanes whose steps differ from the "
         f"twin's: {apart}); max "
         f"|pose - true| {off:.4f}; early exit {t_ee:.4f} ms, masked "
         f"{t_m:.4f} ms, B=1 {t_1:.4f} ms, plain {t_p:.4f} ms at B={b} "
         f"N={packed.shape[2]}, {t_p1:.4f} ms at B=1 ({card})")
    return {"dpose": dpose, "ms": t_ee, "masked_ms": t_m, "b1_ms": t_1,
            "plain_ms": t_p, "b1_plain_ms": t_p1,
            "bound": lm_bound(packed, ee[2]),
            "b1_bound_ms": lm_bound(packed[:1], ee[2][:1])["bound_ms"],
            "n": packed.shape[2], "key": lm_shape_key(s, m, cost, loss)}


def phase_lm(dev, card):
    """Kernel F, both variants, against its plain twin at the slice's width
    (B=8 lanes, N = 4 keyframes x 1024 cells, every pair of LM_CASES) and at
    every other width of `LM_SHAPES`, so that every cluster size the main
    paths reach (1, 8 and 16 CTAs a lane) is held against the twin, early
    exit against masked, and B=1 against B=8; then at the loop
    verification shapes (`LM_VERIFY`: B=512 and 256, N=1,024). `ms` is the
    slice's (P2P/Huber); `ms_by_n` lists the early-exit time at every
    width, B=8; `by_case` each cost/loss pair's at the slice's width;
    `verify` the verification shapes' records."""
    rng = np.random.default_rng(1)
    rows = [_lm_case(rng, dev, card, 4, 1024, cost, loss)
            for cost, loss in LM_CASES]
    by_case = {f"{cost}/{loss}": {"dpose": r["dpose"], "ms": r["ms"],
                                  "plain_ms": r["plain_ms"], **r["bound"]}
               for (cost, loss), r in zip(LM_CASES, rows)}
    first = rows[0]
    rows += [_lm_case(rng, dev, card, *shape) for shape in LM_SHAPES
             if shape != (4, 1024) + LM_CASES[0]]
    by_n = sorted(rows[:1] + rows[len(LM_CASES):], key=lambda r: r["n"])
    lanes, shapes = LM_VERIFY
    verify = {f"B={b} N={sh[0] * sh[1]} {sh[2]}/{sh[3]}":
              _lm_case(rng, dev, card, *sh, b=b)
              for b in lanes for sh in shapes}
    # no single PyTorch call solves a trust-region LM: no library route
    return {"lm_solve_fused": {
        "max_abs_err": max(r["dpose"] for r in rows + list(verify.values())),
        "ms": first["ms"], "plain_ms": first["plain_ms"], **first["bound"],
        "library_ms": None,
        **{f"{k}_by_n": {r["key"]: r[k] for r in by_n}
           for k in ("ms", "masked_ms", "b1_ms", "plain_ms", "b1_plain_ms",
                     "b1_bound_ms")},
        "bound_ms_by_n": {r["key"]: r["bound"]["bound_ms"] for r in by_n},
        "by_case": by_case,
        "verify": {k: {"dpose": r["dpose"], "ms": r["ms"],
                       "plain_ms": r["plain_ms"], **r["bound"]}
                   for k, r in verify.items()}}}


def crowded_cloud(rng, b, n, cfg, crowd=CROWD):
    """(B, n) point clouds, as numpy PointCloud leaves, in which one voxel
    holds `crowd` points and its eight neighbours none: walls at x < -5 m,
    the crowd in the voxel [10, 11) x [4, 5) leaf lengths."""
    leaf, _, _ = features._grid_geometry(cfg)
    xy = np.zeros((b, n, 2))
    for i in range(b):
        walls = []
        for _ in range(16):
            p0 = np.array([rng.uniform(-110, -50), rng.uniform(-60, 60)])
            ang = rng.uniform(0, 2 * np.pi)
            t = rng.uniform(0, 40, (n - crowd) // 16 + 1)
            walls.append(p0 + np.stack([np.cos(ang) * t, np.sin(ang) * t], -1))
        rest = np.concatenate(walls)[:n - crowd] + rng.normal(
            0, 0.2, (n - crowd, 2))
        pts = np.concatenate([
            rest, (np.array([10.0, 4.0]) + rng.uniform(0.05, 0.95, (crowd, 2)))
            * leaf])
        xy[i] = pts[rng.permutation(n)]
    intensity = rng.uniform(40, 220, (b, n))
    valid = np.ones((b, n), bool)
    return (xy.astype(np.float32), intensity.astype(np.float32), valid,
            rng.random((b, n)) < 0.5)


def _check_moments(name, got, plain):
    """Kernel G's output against its twin's on the card: rows 0-8 bit-equal,
    rows 9-15 zero. Returns the largest absolute difference (0.0)."""
    if not torch.equal(got[:, 0], plain[:, 0]):
        raise AssertionError(f"kernel G {name}: counts differ from the twin")
    if got[:, 9:].abs().max() != 0:
        raise AssertionError(f"kernel G {name}: padding rows are not zero")
    if not torch.equal(got[:, :9], plain[:, :9]):
        d = (got[:, :9] - plain[:, :9]).abs().amax((0, 2)).tolist()
        raise AssertionError(f"kernel G {name}: moments are not bit-equal to "
                             f"the twin's (max |diff| per row {d})")
    return float((got - plain).abs().max())


def moment_inputs(images, dev, cfg=None):
    """Kernel G's arguments on the first BATCH frames of `images` as BATCH
    lanes (`features._moment_inputs` of the host-filtered points, under
    `cfg`, by default the slice's with the pallas backend), and each lane's
    alone (B=1): (inputs, [lane inputs])."""
    cfg = cfg or slice_config(feature_backend="pallas")
    rows = odometry.host_filter(images[:BATCH], cfg, "compact")
    pts = filtering.points_from_compact(odometry.to_device(rows, dev), cfg)
    inputs = features._moment_inputs(pts, cfg)
    one = [tuple(t[i:i + 1].contiguous() for t in inputs[:5])
           + tuple(inputs[5:]) for i in range(BATCH)]
    return inputs, one


def index_add_yardstick(inputs):
    """The library route beside kernel G, timed and called nowhere in the
    port: one `index_add_` of every (point, offset) hit's 9 ready moment
    columns into its cell (float atomics). Returns (call, hits)."""
    pack, n_off, c_pre = inputs[0], inputs[6], inputs[7]
    trank = pack[:, 5 + n_off:5 + 2 * n_off].transpose(1, 2)
    hits = trank < c_pre
    rows9 = torch.randn((int(hits.sum()), 9), device=pack.device)
    ids = (torch.arange(pack.shape[0], device=pack.device)[:, None, None]
           * c_pre + trank.to(torch.int64))[hits]
    return (lambda: torch.zeros((pack.shape[0] * c_pre, 9), device=pack.device)
            .index_add_(0, ids, rows9)), int(hits.sum())


def phase_moments(images, dev, card):
    """Kernel G against its plain twin on the slice's first 8 frames as 8
    lanes (N = 8192 points, c_pre = 4608 cells): bit-equal, two launches
    bit-identical, each lane alone (B=1) equal to its lane of the B=8 call;
    and on `crowded_cloud`, where one cell's list is 2,000 hits long."""
    cfg = slice_config(feature_backend="pallas")
    inputs, one = moment_inputs(images, dev)
    pack, c_pre = inputs[0], inputs[7]
    k1 = cuda_features.moment_accumulate(*inputs)
    k2 = cuda_features.moment_accumulate(*inputs)
    plain = cuda_features.moment_accumulate_plain(*inputs)
    torch.cuda.synchronize()
    if not torch.equal(k1, k2):
        raise AssertionError("kernel G: two launches differ")
    err_abs = _check_moments("slice", k1, plain)
    for i, lane_inputs in enumerate(one):
        if not torch.equal(cuda_features.moment_accumulate(*lane_inputs)[0],
                           k1[i]):
            raise AssertionError(f"kernel G: lane {i} of the B={BATCH} call "
                                 "differs from its B=1 call")
    crowd = filtering.PointCloud(*(torch.as_tensor(a).to(dev) for a in
                                   crowded_cloud(np.random.default_rng(5), 2,
                                                 pack.shape[2], cfg)))
    c_inputs = features._moment_inputs(crowd, cfg)
    c1 = cuda_features.moment_accumulate(*c_inputs)
    c_plain = cuda_features.moment_accumulate_plain(*c_inputs)
    torch.cuda.synchronize()
    _check_moments("crowded", c1, c_plain)
    longest = c1[:, 0].amax(-1).tolist()
    if min(longest) < CROWD:
        raise AssertionError(f"kernel G crowded: longest cell lists {longest}"
                             f", expected at least {CROWD}")
    occupied = (plain[:, 0] > 0).sum(-1).tolist()
    ms = _cuda_ms(lambda: cuda_features.moment_accumulate(*inputs), 50)
    ms_1 = _cuda_ms(lambda: cuda_features.moment_accumulate(*one[0]), 50)
    ms_c = _cuda_ms(lambda: cuda_features.moment_accumulate(*c_inputs), 50)
    plain_ms = _cuda_ms(lambda: cuda_features.moment_accumulate_plain(*inputs),
                        5, "moment_accumulate_plain")
    library, n_hits = index_add_yardstick(inputs)
    lib_ms = _cuda_ms(library, 50, "index_add_")
    g_bound = bound(sum(t.numel() * 4 for t in inputs[:5]) + k1.numel() * 4,
                    MOMENT_FLOPS * float(n_hits))
    over32 = float((plain[:, 0] > 32).sum() / max(sum(occupied), 1))
    _say(f"kernel G: pack {tuple(pack.shape)}, c_pre {c_pre}, cells with "
         f"points per lane {occupied}, {over32:.3f} of them with more than "
         f"32 hits, longest list {int(plain[:, 0].max())}; rows 0-8 "
         f"bit-equal to the twin, two launches and B=1 against B={BATCH} bit-identical; "
         f"crowded cloud (longest lists {longest}) bit-equal; kernel "
         f"{ms:.4f} ms, B=1 {ms_1:.4f} ms, crowded B=2 {ms_c:.4f} ms, plain "
         f"{plain_ms:.4f} ms, bound {g_bound['bound_ms']:.4f} ms "
         f"({g_bound['bound_by']}), index_add_ {lib_ms:.4f} ms over "
         f"{n_hits} hits ({card})")
    return {"moment_accumulate": {"max_abs_err": err_abs, "ms": ms,
                                  "plain_ms": plain_ms, **g_bound,
                                  "library_ms": lib_ms, "b1_ms": ms_1}}


def traj_spread(got, want):
    """(max |dpos| m, max |dyaw| rad, max |dmotion| m) between two (N, 3)
    trajectories; a motion is the frame-to-frame step in the earlier
    pose's frame."""
    def motions(t):
        d = t[1:] - t[:-1]
        c, s = np.cos(t[:-1, 2]), np.sin(t[:-1, 2])
        return np.stack([c * d[:, 0] + s * d[:, 1],
                         -s * d[:, 0] + c * d[:, 1]], -1)

    return (float(np.abs(got[:, :2] - want[:, :2]).max()),
            float(np.abs(got[:, 2] - want[:, 2]).max()),
            float(np.abs(motions(got) - motions(want)).max()))


def _check_traj(name, got, want, fused, fused_want, tol=TOL):
    dpos, dyaw, dmot = traj_spread(got, want)
    _say(f"{name}: max |dpos| {dpos:.6f} m, |dyaw| {dyaw:.3e} rad, "
         f"|dmotion| {dmot:.6f} m; fused flags equal: "
         f"{bool(np.array_equal(fused, fused_want))}")
    if not np.array_equal(fused, fused_want):
        raise AssertionError(f"{name}: keyframe decisions differ at frames "
                             f"{np.flatnonzero(fused != fused_want).tolist()}")
    if dpos > tol[0] or dyaw > tol[1] or dmot > tol[2]:
        raise AssertionError(f"{name}: trajectory outside tolerance "
                             f"({tol[0]} m, {tol[1]} rad, {tol[2]} m)")
    return dpos


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_single(cfg, images, dev, passes=2):
    """`passes` runs of OdometryRunner over the frames (reset between);
    returns the runner of the last and the wall time of each. The first
    pass includes the warm-up."""
    runner = odometry.OdometryRunner(cfg, ingest="host", device=dev, chunk=16)
    secs = []
    for rep in range(passes):
        if rep:
            runner.reset()
        t0 = time.perf_counter()
        runner.process(images)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
    return runner, secs


def _report(name, traj, out, gt, secs, card, g_ate):
    """Print a path's frames/s, ATE, drift and counts; fail when its ATE is
    more than 5 cm worse than the golden's `g_ate`."""
    n = traj.shape[0]
    _say(f"{name}: {n} frames, " + ", ".join(
        f"pass {i + 1} {n / t:.2f} frames/s" for i, t in enumerate(secs))
        + f" (pass 1 with the warm-up; host filter included; {card})")
    ate = ate_rmse(traj[:, :2], gt[:, :2])
    drift = kitti.kitti_drift(traj, gt, step_size=5, lengths=(50.0,))
    _say(f"{name}: ATE {ate:.4f} m (golden {g_ate:.4f} m), drift "
         f"{drift['t_err_percent']:.3f}% over 50 m, keyframes "
         f"{int(out.fused.sum())}, mean cells {out.num_cells.mean():.1f}, "
         f"mean assoc {out.num_assoc[1:].mean():.1f}")
    if ate > g_ate + 0.05:
        raise AssertionError(f"{name}: ATE {ate} m worse than the golden's "
                             f"{g_ate} m")


def phase_single(cfg, images, gt, dev, card, golden, name="single",
                 tol=TOL, full_window=False, passes=2):
    """One sequence through OdometryRunner (`passes` times), held against a
    JAX golden. With `full_window`, the run must end with every keyframe
    slot valid. Returns (trajectory, frame outputs, final state)."""
    n = images.shape[0]
    runner, secs = _run_single(cfg, images, dev, passes)
    traj, out = runner.trajectory(), runner.frame_outputs()
    with np.load(golden) as z:
        if json.loads(str(z["config"])) != cfg.to_dict():
            raise AssertionError("golden was made for another configuration")
        g_traj, g_fused, g_ate = z["poses"], z["fused"], float(z["ate"])
    if not np.isfinite(traj).all() or traj.shape != (n, 3):
        raise AssertionError("trajectory not finite or of the wrong shape")
    if not out.success.all():
        raise AssertionError(f"failed frames {np.flatnonzero(~out.success)}")
    _check_traj(f"{name} vs JAX golden", traj, g_traj, out.fused, g_fused,
                tol)
    _report(name, traj, out, gt, secs, card, g_ate)
    n_kf = int(runner.state.kf_valid.sum())
    _say(f"{name}: {n_kf} of {cfg.odometry.submap_scan_size} keyframe slots "
         "valid at the end")
    if full_window and n_kf != cfg.odometry.submap_scan_size:
        raise AssertionError(f"{name}: the keyframe window is not full")
    return traj, out, runner.state


def phase_s50_drift(name, traj, golden, card) -> None:
    """The s50 path `name`'s KITTI drift under `bench.py --check-drift`'s
    protocol (S50_DRIFT_KW), beside its golden's under the same protocol
    and the reference artifact's (S50_DRIFT_ARTIFACT); printed only."""
    with np.load(golden) as z:
        g_traj, gt = z["poses"], z["gt"]
    got = kitti.kitti_drift(traj, gt, **S50_DRIFT_KW)
    want = kitti.kitti_drift(g_traj, gt, **S50_DRIFT_KW)
    _say(f"{name}: drift {got['t_err_percent']:.4f}% over "
         f"{got['n_subsequences']} subsequences of 50 and 100 m, step 5 "
         f"(golden {want['t_err_percent']:.4f}%; the reference artifact "
         f"{S50_DRIFT_ARTIFACT[name]:.3f}% at its own length) ({card})")


def phase_auto(images, traj, out, dev, card):
    """The preset as users call it (assoc 'auto', no spatial sort): on a
    card it resolves to kernel A; held against the kernel-C run."""
    n = images.shape[0]
    runner, secs = _run_single(slice_config("auto", spatial_sort=False),
                               images, dev, 1)
    traj_a, out_a = runner.trajectory(), runner.frame_outputs()
    if not out_a.success.all():
        raise AssertionError("auto (kernel A) run has failed frames")
    _check_traj("auto (kernel A) vs pallas_sparse (kernel C)", traj_a, traj,
                out_a.fused, out.fused)
    _say(f"auto (kernel A): {n / secs[0]:.2f} frames/s, warm-up included "
         f"({card})")


def phase_image(cfg, images, traj, out, dev, card):
    """The slice with the default image ingest: raw sweeps uploaded by the
    runner's feeder thread and filtered on the card. Held to the `single`
    path's host-ingest trajectory (atol 1e-4, identical keyframe flags);
    a second run must equal the first bit for bit. Returns the runner."""
    runner = odometry.OdometryRunner(cfg, device=dev, chunk=16)
    if runner.kind != "image":
        raise AssertionError("the runner's default ingest is not 'image'")
    runs = []
    for rep in range(2):
        if rep:
            runner.reset()
        runner.process(images)
        runs.append((runner.trajectory(), runner.frame_outputs()))
    (traj_i, out_i), (traj_2, _) = runs
    if not out_i.success.all():
        raise AssertionError("image ingest: failed frames "
                             f"{np.flatnonzero(~out_i.success).tolist()}")
    _check_traj("image ingest vs host ingest (single)", traj_i, traj,
                out_i.fused, out.fused, (1e-4, 1e-4, 1e-4))
    same_host = bool(np.array_equal(traj_i, traj))
    repeat = bool(np.array_equal(traj_2, traj_i))
    _say(f"image ingest: bit-identical to the host-ingest run: {same_host}; "
         f"second run bit-identical to the first: {repeat}")
    if not repeat:
        raise AssertionError("two image-ingest runs of the same frames "
                             "gave different trajectories")
    return runner


def phase_ingest_rates(cfg, images, runner, dev, card):
    """Image ingest (`runner`, the `image` path's) and host ingest over the
    same frames in turns (host, image, image, host): frames/s from one
    call. Run outside the counted paths; `tools/profile_torch_ingest.py`
    times the image filter and the upload apart."""
    n = images.shape[0]
    host = odometry.OdometryRunner(cfg, ingest="host", device=dev, chunk=16)
    host.process(images[:16])
    rates = []
    for name, r in (("host", host), ("image", runner), ("image", runner),
                    ("host", host)):
        r.reset()
        _sync(dev)
        t0 = time.perf_counter()
        r.process(images)
        _sync(dev)
        rates.append(f"{name} {n / (time.perf_counter() - t0):.2f}")
    _say(f"image vs host ingest, the same {n} frames in turns: frames/s "
         f"{', '.join(rates)} ({card})")


def phase_cli(dev, card):
    """The port's offline CLI as users run it (`cli_args`: default image
    ingest, --save-graph) on the card, held to the reference CLI's golden
    (`GOLDEN_CLI`): poses within TOL, identical keyframe decisions, no
    failed frame, every frame in `est/00.txt`, and a graph with the
    golden's node and edge counts and a payload on every node."""
    with np.load(GOLDEN_CLI) as z:
        g = {k: z[k] for k in z.files}
    cfg = cli_config()
    if json.loads(str(g["config"])) != cfg.to_dict() \
            or json.loads(str(g["sequence"])) != CLI_SEQUENCE:
        raise AssertionError("cli: golden was made for another configuration "
                             "or sequence")
    method = registration.resolve_assoc_method(
        cfg, cfg.feature.max_cells, cfg.feature.max_cells,
        cfg.odometry.submap_scan_size, dev)
    if method != "pallas":
        raise AssertionError(f"cli: auto resolved to {method}, expected "
                             "kernel A")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cfear3_oxford.json")
        cfg.save(path)
        out_dir = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        result = offline_odometry.main(cli_args(path, out_dir))
        secs = time.perf_counter() - t0
        got = read_cli_run(out_dir, cfg.radar.sensor_period)
        for name in ("est/result.txt", "pars.txt", "est/00_tum.txt",
                     "est/00_cov.txt"):
            if not os.path.exists(os.path.join(out_dir, name)):
                raise AssertionError(f"cli: {name} was not written")
    n = CLI_SEQUENCE["n_frames"]
    if got["poses"].shape != (n, 3) or result["frames"] != n:
        raise AssertionError(f"cli: {got['poses'].shape[0]} rows in "
                             f"est/00.txt, expected {n}")
    if result["registration_failures"]:
        raise AssertionError(f"cli: {result['registration_failures']} "
                             "registration failures")
    _check_traj("cli vs the reference CLI's golden", got["poses"],
                g["poses"], got["fused"], g["fused"])
    counts = (got["n_nodes"], got["n_edges"])
    want = (int(g["n_nodes"]), int(g["n_edges"]))
    if counts != want or got["n_scans"] != got["n_nodes"]:
        raise AssertionError(f"cli: graph of {counts} nodes/edges and "
                             f"{got['n_scans']} payloads, golden {want}")
    _say(f"cli: {n} frames, {result['keyframes']} keyframes, ATE "
         f"{result['ate_m']:.4f} m (golden {float(g['ate']):.4f}), graph "
         f"{counts[0]} nodes / {counts[1]} edges as the golden; "
         f"{secs:.1f} s for the whole CLI run, rendering and graph "
         f"included ({card})")


def check_dataset_read(name: str, root: str, images) -> None:
    """The port's loader (`oxford_frames` or `mulran_frames`, PNGs decoded
    by `datasets/png.py`) reads a `cli-*` path's directory back to the
    rendered sweeps bit for bit, with stamps from the file names; the
    sweeps are the ones its golden was made from."""
    from cfear_radarodometry_code_public_tpu_torch.datasets import oxford
    ds = CLI_PATHS[name]["dataset"]
    t0 = time.perf_counter()
    frames = list(oxford.oxford_frames(radar_dir(ds, root)) if ds == "oxford"
                  else oxford.mulran_frames(radar_dir(ds, root)))
    ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    got = np.stack([img for _, img in frames])
    seq = DATASET_SEQUENCES[ds]
    dt = port.preset("CFEAR-3", dataset=ds).radar.sensor_period
    if not np.array_equal(got, images):
        raise AssertionError(f"{name}: the loader's sweeps differ from the "
                             "rendered ones")
    with np.load(cli_golden_path(name)) as z:
        if hashlib.sha256(images.tobytes()).hexdigest() \
                != str(z["images_sha256"]):
            raise AssertionError(f"{name}: golden was made from other sweeps")
    if not np.allclose(np.diff([t for t, _ in frames]), dt, atol=1e-6):
        raise AssertionError(f"{name}: stamps not {dt} s apart")
    _say(f"{name}: {len(frames)} sweeps of {got.shape[1:]} written as PNG "
         f"and read back bit for bit without PIL, {ms:.1f} ms a sweep on "
         f"the host clock, first stamp {frames[0][0]:.6f} s (t0 "
         f"{seq['t0']})")


def phase_cacfar_filter(dev, card) -> None:
    """CA-CFAR on the `cli-cacfar` path's sweeps (CLI_SEQUENCE at Oxford
    width): the card's image filter (`filtering.cfar_select`) gives the
    native host filter's rows (`cfar_filter_frames_host`) bin for bin and
    intensity for intensity."""
    cfg = port.preset("CFEAR-3", dataset="oxford")
    cfg = cfg.replace(filter=dataclasses.replace(cfg.filter, method="cacfar"))
    images, _ = synthetic.make_sequence(cfg=cfg, **CLI_SEQUENCE)
    bins, valid, intens = filtering.cfar_select(
        torch.as_tensor(images).to(dev), cfg)
    h_bins, h_int, _ = native_io.cfar_filter_frames_host(images, cfg)
    got_b = torch.where(valid, bins.to(torch.int64), -1).cpu().numpy()
    got_i = torch.where(valid, intens, 0).cpu().numpy()
    per_az = valid.sum(-1).cpu().numpy()
    if not (np.array_equal(got_b, h_bins.astype(np.int64))
            and np.array_equal(got_i, np.where(h_bins >= 0, h_int, 0))):
        raise AssertionError("cli-cacfar: the card's CA-CFAR rows differ "
                             "from the host filter's")
    _say(f"cli-cacfar filter: the card's CA-CFAR rows equal the host "
         f"filter's on {images.shape[0]} sweeps of {images.shape[1:]}: "
         f"{int(per_az.sum())} detections, {float(per_az.mean()):.1f} an "
         f"azimuth, {int((per_az == cfg.filter.cfar_max_per_azimuth).sum())} "
         f"azimuths at the cap of {cfg.filter.cfar_max_per_azimuth} ({card})")


@contextlib.contextmanager
def kernel_shapes():
    """While the block runs, the shapes of kernel A's calls, (B, S, Msrc,
    M), and of kernel F's, (B, N), are collected into the two sets the
    block is given."""
    a_shapes, f_shapes = set(), set()
    nn_min, lm_solve = cuda_assoc.nn_min, cuda_lm.lm_solve_fused

    def spy_a(src, tar, valid):
        a_shapes.add((*valid.shape[:2], src.shape[1], valid.shape[2]))
        return nn_min(src, tar, valid)

    def spy_f(packed, pose0, cfg, early_exit=True):
        f_shapes.add((packed.shape[0], packed.shape[2]))
        return lm_solve(packed, pose0, cfg, early_exit)

    cuda_assoc.nn_min, cuda_lm.lm_solve_fused = spy_a, spy_f
    try:
        yield a_shapes, f_shapes
    finally:
        cuda_assoc.nn_min, cuda_lm.lm_solve_fused = nn_min, lm_solve


def drive_cli_path(name: str, root: str, dev) -> tuple:
    """A `cli-*` path: the port's offline CLI on the card with
    `cli_path_args` over the inputs under `root`. Returns (the run, with
    the shapes kernels A and F were called at, and seconds)."""
    if dev.type != "cuda":
        raise AssertionError(f"{name}: the path runs on the card")
    t0 = time.perf_counter()
    with kernel_shapes() as (a_shapes, f_shapes):
        run = run_cli(offline_odometry, odometry.OdometryRunner,
                      cli_path_args(name, root, os.path.join(root, "run")))
    run.update(a_shapes=a_shapes, f_shapes=f_shapes)
    return run, time.perf_counter() - t0


def cli_path_kernels(name: str) -> tuple:
    """(the kernels a `cli-*` path must launch, those it must not)."""
    if CLI_PATHS[name].get("assoc") == "grid":
        return ("lm_solve_fused",), ASSOC_KERNELS
    return ("nn_min", "lm_solve_fused"), ()


def check_path_shapes(name: str, a_shapes, f_shapes) -> None:
    """Every shape a path called kernels A and F at is one the kernel
    phases hold against the twins: A's in A_SHAPES, F's width N in
    LM_SHAPES (lanes of B=8 calls, and B=1 calls of lane 0) or, at its
    lane count, in LM_VERIFY."""
    widths = {s * m for s, m, _, _ in LM_SHAPES}
    verify = {(b, s * m) for b in LM_VERIFY[0] for s, m, _, _ in LM_VERIFY[1]}
    a_out = sorted(a_shapes - set(A_SHAPES))
    f_out = sorted(x for x in f_shapes
                   if not (x[0] in (1, BATCH) and x[1] in widths)
                   and x not in verify)
    if a_out or f_out:
        raise AssertionError(f"{name}: kernel A at {a_out} or kernel F at "
                             f"(B, N) {f_out}, shapes the kernel phases do "
                             "not hold")


def phase_cli_path(name: str, run: dict, secs: float, dev, card) -> None:
    """A `cli-*` path against its golden (`cli_golden_path`): the same
    configuration, sequence and arguments; `auto` resolved to kernel A;
    every frame in `est/00.txt`; failed frames and keyframe decisions
    identical; poses within CLI_PATH_TOL[name]; the graph with the
    golden's node and edge counts and a payload on every node."""
    with np.load(cli_golden_path(name)) as z:
        g = {k: z[k] for k in z.files}
    if json.loads(str(g["sequence"])) != cli_path_sequence(name) \
            or json.loads(str(g["argv"])) != cli_path_args(name, "<in>",
                                                           "<run>") \
            or json.loads(str(g["config"])) != run["cfg"]:
        raise AssertionError(f"{name}: golden was made for another "
                             "configuration, sequence or arguments")
    cfg = port.CFEARConfig.from_dict(run["cfg"])
    m = (cfg.feature.max_cells_raw if cfg.feature.use_raw_pointcloud
         else cfg.feature.max_cells)
    method = registration.resolve_assoc_method(
        cfg, m, m, cfg.odometry.submap_scan_size, dev)
    expected = CLI_PATHS[name].get("assoc", "pallas")
    if method != expected:
        raise AssertionError(f"{name}: the association resolved to {method}, "
                             f"expected {expected}")
    check_path_shapes(name, run["a_shapes"], run["f_shapes"])
    s_kf = cfg.odometry.submap_scan_size
    if (expected == "pallas" and (1, s_kf, m, m) not in run["a_shapes"]) \
            or (1, s_kf * m) not in run["f_shapes"]:
        raise AssertionError(f"{name}: kernel A never at (1, {s_kf}, {m}, "
                             f"{m}) or F never at B=1 N={s_kf * m}")
    n = cli_path_sequence(name)["n_frames"]
    if run["poses"].shape != (n, 3) or run["result"]["frames"] != n:
        raise AssertionError(f"{name}: {run['poses'].shape[0]} rows in "
                             f"est/00.txt, expected {n}")
    fails = np.flatnonzero(~run["success"]).tolist()
    want = np.flatnonzero(~g["success"]).tolist()
    if fails != want or len(fails) != run["result"]["registration_failures"]:
        raise AssertionError(f"{name}: failed frames {fails}, golden {want}")
    _check_traj(f"{name} vs the reference CLI's golden", run["poses"],
                g["poses"], run["fused"], g["fused"], CLI_PATH_TOL[name])
    counts = (run["n_nodes"], run["n_edges"])
    g_counts = (int(g["n_nodes"]), int(g["n_edges"]))
    if counts != g_counts or run["n_scans"] != run["n_nodes"]:
        raise AssertionError(f"{name}: graph of {counts} nodes/edges and "
                             f"{run['n_scans']} payloads, golden {g_counts}")
    r = run["result"]
    _say(f"{name}: {n} frames, {r['keyframes']} keyframes, {len(fails)} "
         f"failed, ATE {r['ate_m']:.4f} m (golden {float(g['ate']):.4f}), "
         f"drift {r['t_err_percent']:.4f}% (golden "
         f"{float(g['drift']):.4f}%), graph {counts[0]} nodes / {counts[1]} "
         f"edges as the golden; {cfg.name} {cfg.registration.cost}/"
         f"{cfg.registration.loss}, filter {cfg.filter.method}, "
         f"association {method}, S={cfg.odometry.submap_scan_size}, "
         f"{'raw cells' if cfg.feature.use_raw_pointcloud else 'max_cells'} "
         f"{m}, {cfg.radar.n_bins} bins; kernel A at (B, S, Msrc, M) "
         f"{sorted(run['a_shapes'])}, F at (B, N) {sorted(run['f_shapes'])}; "
         f"{secs:.1f} s for the whole CLI run ({r['fps']:.2f} frames/s in "
         f"its result) ({card})")


def grid_reference_table(mean, valid, cfg) -> np.ndarray:
    """The reference's bucket table (`registration.py:_associate_grid`'s
    build) in numpy, from one keyframe's cell means (M, 2) float32 and
    validity: slot b * C + r holds the r-th valid in-grid cell of bucket b
    in index order, r < C (`bucket_capacity`), -1 where empty; the cells
    past a full bucket are dropped. The bucket index uses the same float32
    division and floor as the port. Returns (G * G * C,) int32."""
    bin_size, g = registration._bucket_geometry(cfg)
    cap = cfg.registration.bucket_capacity
    bi = np.floor(mean / np.float32(bin_size)).astype(np.int32) + g // 2
    ok = valid & ((bi >= 0) & (bi < g)).all(-1)
    table = np.full(g * g * cap, -1, np.int32)
    fill = np.zeros(g * g, np.int64)
    for i in np.flatnonzero(ok):
        b = bi[i, 0] * g + bi[i, 1]
        if fill[b] < cap:
            table[b * cap + fill[b]] = i
        fill[b] += 1
    return table


def phase_grid_tables(name: str, run: dict, dev, card) -> None:
    """`cli-grid`'s bucket tables on the window its run ends with
    (`registration.build_buckets` over the runner's keyframe cells, S of
    M=3072): two builds on the card bit-identical, equal to the CPU's
    build of the same cells and to the reference's table built in numpy
    (`grid_reference_table`), and the overflow sink at -1: the dump slot
    past the sink, which every cell without a slot is scattered to, never
    leaks into the kept table."""
    cfg = port.CFEARConfig.from_dict(run["cfg"])
    state = run["runner"].state
    kf = CellMap(*(a[None] for a in state.kf_cells))
    first = registration.build_buckets(kf, cfg)
    again = registration.build_buckets(kf, cfg)
    on_cpu = registration.build_buckets(
        CellMap(*(a.cpu() for a in kf)), cfg)
    torch.cuda.synchronize()
    got = first.cpu().numpy()[0]
    cap = cfg.registration.bucket_capacity
    _, g = registration._bucket_geometry(cfg)
    mean, valid = kf.mean.cpu().numpy()[0], kf.valid.cpu().numpy()[0]
    want = np.stack([grid_reference_table(m, v, cfg)
                     for m, v in zip(mean, valid)])
    live = int((valid & state.kf_valid.cpu().numpy()[:, None]).sum())
    if not torch.equal(first, again) or not torch.equal(first.cpu(), on_cpu):
        raise AssertionError(f"{name}: bucket tables differ between two card "
                             "builds or from the CPU's")
    if not (np.array_equal(got[:, :-1], want) and (got[:, -1] == -1).all()):
        raise AssertionError(f"{name}: the card's bucket table is not the "
                             "reference's (a dump-slot write leaked?)")
    occupancy = np.bincount(
        (want.reshape(mean.shape[0], g * g, cap) >= 0).sum(-1).ravel(),
        minlength=cap + 1)
    kept = int((want >= 0).sum())
    _say(f"{name}: bucket tables on {mean.shape[0]} keyframes x "
         f"{mean.shape[1]} cells ({live} valid in live keyframes), {g} x {g} "
         f"buckets of {cap}: two card builds bit-identical, equal to the "
         f"CPU's and to the reference's table built in numpy, sink -1; "
         f"{kept} cells kept, {int(valid.sum()) - kept} dropped (a full "
         f"bucket or outside the grid), {int(occupancy[cap])} buckets full "
         f"({card})")


def phase_grid_repeat(name: str, root: str, run: dict, card) -> None:
    """`cli-grid` run again on the card: its poses, keyframe flags and
    result bit for bit the first run's."""
    again = run_cli(offline_odometry, odometry.OdometryRunner,
                    cli_path_args(name, root, os.path.join(root, "again")))
    same = (np.array_equal(again["poses"], run["poses"])
            and np.array_equal(again["fused"], run["fused"])
            and np.array_equal(again["success"], run["success"]))
    _say(f"{name}: a second run on the card bit-identical to the first: "
         f"{same} ({card})")
    if not same:
        raise AssertionError(f"{name}: two runs on the card differ")


def sweep_args() -> list:
    """The offline CLI's arguments common to every `sweep` job (without
    --cpu): `tools/run_ablation_sweep.py`'s, at SWEEP_SEQUENCE."""
    seq = SWEEP_SEQUENCE
    return ["--dataset", "synthetic", "--n-frames", str(seq["n_frames"]),
            "--speed", str(seq["speed"]), "--n-dynamic", "40",
            "--dropout-prob", "0.5", "--speckle-burst-prob", "0.4",
            "--max_cells", "1024", "--chunk", "25", "--no-save-graph",
            "--seed", str(seq["seed"])]


def run_sweep_jobs(sweep_mod, runner_cls, root: str, base: list) -> dict:
    """Every job of SWEEP_JOBS through `sweep_mod.run_sweep` (the port's,
    or the reference's for its golden) with the CLI arguments `base`, under
    `root`. Returns {"<grid>/job_<n>": {"poses", "fused", "success",
    "result"}}: the job's runner (`runner_cls`, whose `process` is
    recorded) read back after its grid ran, and its `est/result.txt`."""
    jobs = {}
    for name, grid, extra in SWEEP_JOBS:
        with recorded(runner_cls, "process") as calls:
            dirs = sweep_mod.run_sweep(os.path.join(root, name), grid,
                                       list(base) + list(extra))
        if len(calls) != len(dirs):
            raise AssertionError(f"sweep {name}: {len(calls)} runs for "
                                 f"{len(dirs)} jobs")
        for d, (args, _) in zip(dirs, calls):
            runner = args["self"]
            out = runner.frame_outputs()
            with open(os.path.join(d, "est", "result.txt")) as f:
                result = dict(line.strip().split(": ", 1) for line in f)
            jobs[f"{name}/{os.path.basename(d)}"] = {
                "poses": np.asarray(runner.trajectory(), np.float64),
                "fused": np.asarray(out.fused),
                "success": np.asarray(out.success), "result": result}
        del calls
    return jobs


def drive_sweep(dev):
    """The `sweep` path: every job of SWEEP_JOBS through the port's
    `parallel.sweep.run_sweep` on the card. Returns (jobs, seconds)."""
    if dev.type != "cuda":
        raise AssertionError("sweep: the path runs on the card")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        jobs = run_sweep_jobs(sweep, odometry.OdometryRunner, tmp,
                              sweep_args())
        return jobs, time.perf_counter() - t0


def phase_sweep(jobs, secs, card):
    """Each `sweep` job against its golden (`GOLDEN_SWEEP`): identical
    keyframe decisions and failed frames (the Tukey-0.1 job fails some
    through the divergence gate, as the golden's does, and no other job
    fails any), poses within SWEEP_TOL; each job's frames/s on the host
    clock from its `est/result.txt`."""
    with np.load(GOLDEN_SWEEP) as z:
        g = {k: z[k] for k in z.files}
    if json.loads(str(g["sequence"])) != SWEEP_SEQUENCE \
            or json.loads(str(g["argv"])) != sweep_args() \
            or json.loads(str(g["jobs"])) != json.loads(json.dumps(
                SWEEP_JOBS)):
        raise AssertionError("sweep: golden was made for other jobs")
    names = json.loads(str(g["names"]))
    if sorted(names) != sorted(jobs):
        raise AssertionError(f"sweep: jobs {sorted(jobs)}, golden {names}")
    for i, name in enumerate(names):
        got = jobs[name]
        fails = int((~got["success"]).sum())
        want_fails = int((~g[f"success_{i}"]).sum())
        if fails != want_fails or fails != int(got["result"][
                "registration_failures"]):
            raise AssertionError(f"sweep {name}: {fails} failed frames, "
                                 f"golden {want_fails}")
        if name == SWEEP_TUKEY and not fails:
            raise AssertionError(f"sweep {name}: Tukey-0.1 must fail frames")
        _check_traj(f"sweep {name} vs golden", got["poses"], g[f"poses_{i}"],
                    got["fused"], g[f"fused_{i}"], SWEEP_TOL)
        _say(f"sweep {name}: {int(got['fused'].sum())} keyframes, {fails} "
             f"failed frames (golden {want_fails}), drift "
             f"{float(got['result']['t_err_percent']):.4f}% (golden "
             f"{float(g['drift'][i]):.4f}%), ATE "
             f"{float(got['result']['ate_m']):.4f} m (golden "
             f"{float(g['ate'][i]):.4f}); {got['result']['fps']} frames/s "
             f"on the host clock ({card})")
    _say(f"sweep: {len(jobs)} jobs of {SWEEP_SEQUENCE['n_frames']} frames "
         f"in {secs:.1f} s, rendering included ({card})")


def phase_batched(cfg, images, traj, out, dev, card, batch=BATCH, tol=TOL):
    """make_batched_step over `batch` lanes fed the same frames, twice;
    every lane held against the single-sequence run."""
    n = images.shape[0]
    rows = odometry.host_filter(images, cfg, "compact")
    staged = odometry.to_device(odometry.filtering.CompactCandidates(
        *(np.broadcast_to(a[:, None], (n, batch) + a.shape[1:])
          for a in rows)), dev)
    boot = odometry.make_bootstrap(cfg, batched=True)
    step = odometry.make_batched_step(cfg)

    def run():
        states = odometry.init_state(cfg, dev, batch=batch)
        states, o = boot(states, odometry._map(lambda a: a[0], staged))
        outs = [o]
        for t in range(1, n):
            states, o = step(states, odometry._map(lambda a: a[t], staged))
            outs.append(o)
        return odometry.FrameOutput(*(torch.stack(x, 1).cpu().numpy()
                                      for x in zip(*outs)))

    trajs, secs = [], []
    for rep in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        res = run()
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        trajs.append([odometry.compose_trajectory(
            odometry.FrameOutput(*(a[i] for a in res))) for i in range(batch)])
        dev_lane = []
        for i in range(batch):
            if not res.success[i].all():
                raise AssertionError(f"batched lane {i} has failed frames")
            dev_lane.append(_check_traj(f"batched lane {i} vs single",
                                        trajs[-1][i], traj, res.fused[i],
                                        out.fused, tol))
        _say(f"batched run {rep + 1}: largest |dpos| of each lane from the "
             f"single run (m): {[f'{d:.6f}' for d in dev_lane]}")
    bitwise = all(np.array_equal(a, b) for a, b in zip(*trajs))
    _say(f"batched x{batch}: {batch * n / secs[0]:.2f} and "
         f"{batch * n / secs[1]:.2f} frames/s per card over two runs "
         f"(inputs pre-staged on the card; {card}); trajectories "
         f"bit-identical across the two runs: {bitwise}")
    if not bitwise:
        raise AssertionError("two batched runs of the same frames gave "
                             "different trajectories")


def phase_s50_preset(images, gt, dev, card):
    """CFEAR-3-s50 as users call it (max_cells 3072, no point budget:
    candidates ingest; `auto`, which resolves to kernel C on a card) over
    the s50 sequence: every frame must succeed, and the ATE must be within
    5 cm of the exact golden's (it has no golden of its own). Returns the
    configuration and the final state."""
    cfg = port.preset("CFEAR-3-s50", dataset="oxford")
    m = cfg.feature.max_cells
    method = registration.resolve_assoc_method(
        cfg, m, m, cfg.odometry.submap_scan_size, dev)
    if method != "pallas_sparse":
        raise AssertionError(f"s50-preset: auto resolved to {method}")
    runner, secs = _run_single(cfg, images, dev, 1)
    if runner.kind != "candidates":
        raise AssertionError("s50-preset: expected the candidates ingest")
    traj, out = runner.trajectory(), runner.frame_outputs()
    if not np.isfinite(traj).all() or not out.success.all():
        raise AssertionError("s50-preset: failed or non-finite frames "
                             f"{np.flatnonzero(~out.success)}")
    with np.load(GOLDEN_S50) as z:
        g_ate = float(z["ate"])
    _report(f"s50-preset (max_cells {m}, auto -> kernel C)", traj, out, gt,
            secs, card, g_ate)
    return cfg, runner.state


def _lanes(a, b):
    """(1, ...) -> (b, ...): one lane broadcast over b, contiguous."""
    return a.expand((b,) + a.shape[1:]).contiguous()


def window_inputs(state, cfg, dev, name="s50 window", lanes=(1, BATCH)):
    """The real keyframe window that an s50 run ends with, built as the
    reference's TPU probe builds it (`tools/profile_s50.py:72-117`): the
    source is the newest keyframe's cells in the world frame at its pose;
    the targets are the window's `_world_attrs`; bounds by `tile_bounds`;
    the radius is `assoc_radius`. Returns {B: (args, attrs_t, attrs)} for
    each lane count B in `lanes` (the window broadcast over B lanes), where
    args = (src, src_bounds, tar, tar_bounds, valid, radius) and attrs_t
    (B, S, D_pad, M) is attrs (B, S, M, D) transposed and zero-padded."""
    kf = CellMap(*(a[None] for a in state.kf_cells))
    kf_poses, kf_valid = state.kf_poses[None], state.kf_valid[None]
    attrs = registration._world_attrs(kf, kf_poses, cfg)     # (1, S, M, D)
    src_w = se2.transform(kf_poses[:, -1], kf.mean[:, -1])
    _, s, m, d = attrs.shape
    d_pad = 8 if d <= 8 else 16
    attrs_t = attrs.new_zeros((1, s, d_pad, m))
    attrs_t[:, :, :d] = attrs.transpose(-1, -2)
    tar_valid = (attrs[..., 6] > 0.5) & kf_valid[..., None]
    r = cfg.registration.assoc_radius
    _say(f"{name}: S={s}, valid keyframes {int(kf_valid.sum())}, mean "
         f"valid cells {float(kf.valid.float().sum(-1).mean()):.1f}, M={m}, "
         f"D={d} (D_pad {d_pad}), radius {r} m")
    win = {}
    for b in lanes:
        src, tar, valid = (_lanes(a, b) for a in (src_w, attrs[..., 0:2],
                                                  tar_valid))
        sb = cuda_assoc.tile_bounds(src, _lanes(kf.valid[:, -1], b),
                                    cuda_assoc.TS_SPARSE).contiguous()
        tb = cuda_assoc.tile_bounds(tar, valid,
                                    cuda_assoc.TT_SPARSE).contiguous()
        radius = torch.full((b,), r, device=dev)
        win[b] = ((src, sb, tar, tb, valid, radius), _lanes(attrs_t, b),
                  _lanes(attrs, b))
    return win


def _window_calls(args, at):
    """name -> a call of one association kernel on the window."""
    return {
        "nn_min_sparse": lambda: cuda_assoc.nn_min_sparse(*args),
        "nn_min_sparse_multi": lambda: cuda_assoc.nn_min_sparse_multi(*args),
        "nn_min_sparse_unrolled":
            lambda: cuda_assoc.nn_min_sparse_unrolled(*args),
        "nn_min_sparse_attrs":
            lambda: cuda_assoc.nn_min_sparse_attrs(*args[:5], at, args[5])}


def drive_window(win):
    """Kernels C, D1, D2 and E once each on the window at every lane count,
    as the reference's probe drives them; returns their outputs by B."""
    outs = {b: {k: f() for k, f in _window_calls(args, at).items()}
            for b, (args, at, _) in win.items()}
    torch.cuda.synchronize()
    return outs


def phase_window(win, outs, r, card, name="s50 window"):
    """The window's outputs (`drive_window`) checked: at every lane count C
    equals its twin, D1 and D2 equal C bit for bit, E's (nn, d2) equal C's,
    its g equals its twin's and the flat gather (`_gather_attrs`) on every
    row within the radius and is zero on +inf rows and in the padding.
    Times by CUDA events: C, D1, D2, E, the gather, C + gather, and the
    twins; D1's and D2's keyframe groups, C's and E's cluster size, and
    the issue-slot floor of each. Returns {B:
    records of C, D1, D2 and E}; every check is bit for bit, so each
    max_abs_err is 0.0."""
    res = {}
    for b, (args, at, att) in win.items():
        o = outs[b]
        nn_c, d2_c = o["nn_min_sparse"]
        nn_p, d2_p = cuda_assoc.nn_min_sparse_plain(*args)
        _, _, g_p = cuda_assoc.nn_min_sparse_attrs_plain(*args[:5], at, args[5])
        gathered = registration._gather_attrs(att, nn_c)
        torch.cuda.synchronize()
        if not (torch.equal(nn_c, nn_p) and torch.equal(d2_c, d2_p)):
            raise AssertionError(f"{name} B={b}: kernel C differs from its "
                                 "twin")
        for k, (nn, d2, *_) in o.items():
            if not (torch.equal(nn, nn_c) and torch.equal(d2, d2_c)):
                raise AssertionError(f"{name} B={b}: {k} (nn, d2) differ from "
                                     "kernel C's")
        g_e = o["nn_min_sparse_attrs"][2]
        if not torch.equal(g_e, g_p):
            raise AssertionError(f"{name} B={b}: kernel E's g differs from its twin")
        d = att.shape[-1]
        within, inf = d2_c <= r * r, torch.isinf(d2_c)
        g_rows = g_e.transpose(-1, -2)                     # (B, S, Msrc, D_pad)
        if not torch.equal(g_rows[..., :d][within], gathered[within]):
            raise AssertionError(f"{name} B={b}: kernel E's g differs from the flat "
                                 "gather within the radius")
        if (g_rows[inf] != 0).any() or (g_rows[..., d:] != 0).any():
            raise AssertionError(f"{name} B={b}: kernel E's g is not zero on +inf "
                                 "rows or padding")
        live = float(cuda_assoc.pair_live(args[1], args[3], args[5])
                     .float().mean())
        t = {k: _cuda_ms(f, 50) for k, f in _window_calls(args, at).items()}
        t["gather"] = _cuda_ms(lambda: registration._gather_attrs(att, nn_c),
                               50, "gather")
        t["C + gather"] = _cuda_ms(lambda: registration._gather_attrs(
            att, cuda_assoc.nn_min_sparse(*args)[0]), 50, "C + gather")
        t["plain"] = _cuda_ms(lambda: cuda_assoc.nn_min_sparse_plain(*args), 5,
                              "nn_min_sparse_plain")
        t["plain E"] = _cuda_ms(lambda: cuda_assoc.nn_min_sparse_attrs_plain(
            *args[:5], at, args[5]), 5, "nn_min_sparse_attrs_plain")
        t["cdist + min"] = _cuda_ms(lambda: library_nn(args[0], args[2],
                                                       args[4]), 5,
                                    "cdist + min")
        t["cdist + min + gather"] = _cuda_ms(lambda: library_nn_attrs(
            args[0], args[2], args[4], at), 5, "cdist + min + gather")
        extra = args[1].numel() * 4 + args[3].numel() * 4
        bnd = nn_bound(args[0], args[2], args[4], live, extra)
        bnd_e = nn_bound(args[0], args[2], args[4], live,
                         extra + at.numel() * 4 + g_e.numel() * 4)
        _say(f"{name} B={b}: executed tile pairs {live:.4f}, rows within "
             f"the radius {float(within.float().mean()):.4f}, +inf rows "
             f"{float(inf.float().mean()):.4f}; D1, D2 == C == twin bit for "
             f"bit, E (nn, d2) == C, E g == gather within r, 0 on +inf rows")
        _say(f"{name} B={b} (ms, CUDA events; {card}): "
             + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
        _say(f"{name} B={b}: bound {bnd['bound_ms']:.4f} ms "
             f"({bnd['bound_by']}; E {bnd_e['bound_ms']:.4f} ms) at the "
             f"executed share of tile pairs")
        res[b] = {k: {"max_abs_err": 0.0, "ms": t[k],
                      **(bnd_e if k.endswith("attrs") else bnd),
                      "plain_ms": t["plain E" if k.endswith("attrs")
                                    else "plain"],
                      "library_ms": t["cdist + min + gather"
                                      if k.endswith("attrs")
                                      else "cdist + min"]}
                  for k in ("nn_min_sparse", "nn_min_sparse_multi",
                            "nn_min_sparse_unrolled", "nn_min_sparse_attrs")}
        shape = (b, args[2].shape[1], args[0].shape[1], args[2].shape[2])
        d = {k: res[b][k] for k in D_FUNCTIONS}
        for k, function in D_FUNCTIONS.items():
            d[k].update(groups=cuda_assoc.walk_groups(*shape),
                        floor_ms=issue_floor_ms(
                            function, float(np.prod(shape)) * live))
        for k, function in (("nn_min_sparse", C_FUNCTION),
                            ("nn_min_sparse_attrs", E_FUNCTION)):
            res[b][k].update(split=cuda_assoc.sparse_split(*shape),
                             floor_ms=issue_floor_ms(
                                 function, float(np.prod(shape)) * live))
        res[b]["nn_min_sparse_attrs"].update(
            c_ms=t["nn_min_sparse"], c_gather_ms=t["C + gather"])
        e = res[b]["nn_min_sparse_attrs"]
        _say(f"{name} B={b}: E {e['ms'] / e['c_ms']:.2f}x C, "
             f"{e['ms'] / e['c_gather_ms']:.2f}x C + gather, cluster "
             f"{e['split']}, issue-slot floor {e['floor_ms']:.4f} ms (C "
             f"{res[b]['nn_min_sparse']['floor_ms']:.4f})")
        _say(f"{name} B={b}: D1 / D2 " + " / ".join(
            f"{t[k] / t['nn_min_sparse']:.2f}" for k in d) + "x C, "
             f"{d['nn_min_sparse_multi']['groups']} keyframe groups, "
             "issue-slot floor " + " / ".join(
                 f"{r['floor_ms']:.4f}" for r in d.values()) + " ms")
    return res


def _health_summary(checked, healthy, dist) -> str:
    if not checked.any():
        return "no health checks"
    return (f"{int(checked.sum())} health checks, unhealthy "
            f"{float((~healthy[checked]).mean()):.4f}, median "
            f"discrepancy {float(np.median(dist[checked])):.4f} m")


def phase_longrun(name, cfg, images, gt, sequence, dev, card, passes=1,
                  tol=LONGRUN_TOL, health_tol=HEALTH_TOL):
    """The long-run path through OdometryRunner, held against its JAX
    golden (`longrun_golden`): every frame successful, keyframe decisions
    and health-checked flags identical, poses within `tol`, health_dist
    and health_rot within `health_tol`, `healthy` identical except on
    frames whose golden discrepancy lies within `health_tol` of its limit
    (printed), and, where the golden marks checks unhealthy, at least one
    of them unhealthy here too. `auto` must resolve to kernel A for the
    forward (S=4) and the reverse (S=1) problem. Returns (runner,
    trajectory, frame outputs)."""
    m = cfg.feature.max_cells
    for s_act in (cfg.odometry.submap_scan_size, 1):
        method = registration.resolve_assoc_method(cfg, m, m, s_act, dev)
        if method != "pallas":
            raise AssertionError(f"{name}: auto resolved to {method} at "
                                 f"S={s_act}, expected kernel A")
    n = images.shape[0]
    runner, secs = _run_single(cfg, images, dev, passes)
    traj, out = runner.trajectory(), runner.frame_outputs()
    with np.load(longrun_golden(sequence)) as z:
        g = {k: z[k] for k in z.files}
    if json.loads(str(g["config"])) != cfg.to_dict() \
            or json.loads(str(g["sequence"])) != sequence:
        raise AssertionError(f"{name}: golden was made for another "
                             "configuration or sequence")
    if not np.isfinite(traj).all() or traj.shape != (n, 3):
        raise AssertionError(f"{name}: trajectory not finite or of the "
                             "wrong shape")
    if not out.success.all():
        raise AssertionError(f"{name}: failed frames "
                             f"{np.flatnonzero(~out.success).tolist()}")
    _check_traj(f"{name} vs JAX golden (kernel A, interpret mode)", traj,
                g["poses"], out.fused, g["fused"], tol)
    if not np.array_equal(out.health_checked, g["health_checked"]):
        raise AssertionError(f"{name}: health-checked flags differ")
    chk = out.health_checked
    ddist = float(np.abs(out.health_dist - g["health_dist"]).max())
    drot = float(np.abs(out.health_rot - g["health_rot"]).max())
    odo = cfg.odometry
    near = chk & ((np.abs(g["health_dist"] - odo.health_max_dist)
                   <= health_tol[0])
                  | (np.abs(g["health_rot"]
                            - np.radians(odo.health_max_rot_deg))
                     <= health_tol[1]))
    flips = np.flatnonzero(out.healthy != g["healthy"])
    unhealthy = np.flatnonzero(chk & ~out.healthy)
    g_unhealthy = np.flatnonzero(chk & ~g["healthy"])
    _say(f"{name}: health vs golden: max |d health_dist| {ddist:.6f} m, "
         f"|d health_rot| {drot:.3e} rad; healthy differs on frames "
         f"{flips.tolist()}; checked frames near a limit (within "
         f"{health_tol}) {np.flatnonzero(near).tolist()}; unhealthy checks "
         f"at frames {unhealthy.tolist()} (golden {g_unhealthy.tolist()}, "
         f"health_dist there {g['health_dist'][g_unhealthy].tolist()} m)")
    if ddist > health_tol[0] or drot > health_tol[1]:
        raise AssertionError(f"{name}: health_dist or health_rot outside "
                             f"{health_tol}")
    if not near[flips].all():
        raise AssertionError(f"{name}: healthy differs on frames away from "
                             f"the limits: {flips[~near[flips]].tolist()}")
    if len(g_unhealthy) and not np.isin(unhealthy, g_unhealthy).any():
        raise AssertionError(f"{name}: none of the golden's unhealthy "
                             f"checks {g_unhealthy.tolist()} is unhealthy")
    ate = ate_rmse(traj[:, :2], gt[:, :2])
    drift = kitti.kitti_drift(traj, gt)
    g_drift = kitti.kitti_drift(g["poses"], gt)
    per_len = " ".join(f"{k:g}m:{v['t_err_percent']:.3f}%" for k, v in
                       sorted(drift.get("per_length", {}).items()))
    _say(f"{name}: {n} frames, " + ", ".join(
        f"pass {i + 1} {n / t:.2f} frames/s" for i, t in enumerate(secs))
        + f" (host filter included; {card})")
    _say(f"{name}: ATE {ate:.4f} m (golden {float(g['ate']):.4f}), KITTI "
         f"drift {drift['t_err_percent']:.4f}% r_err "
         f"{drift['r_err_deg_per_m']:.5f} deg/m over "
         f"{drift['n_subsequences']} subsequences ({per_len}; golden "
         f"{g_drift['t_err_percent']:.4f}%); "
         f"{_health_summary(chk, out.healthy, out.health_dist)} (golden "
         f"{_health_summary(chk, g['healthy'], g['health_dist'])}); "
         f"keyframes {int(out.fused.sum())}, mean cells "
         f"{out.num_cells.mean():.1f}, mean assoc {out.num_assoc[1:].mean():.1f}")
    return runner, traj, out


def phase_resume(cfg, images, traj, out, dev, card):
    """The long-run path split at its midpoint through `save_checkpoint`
    and `OdometryRunner.resume`: trajectory, keyframe flags and health
    fields bit-identical to the unsplit run (`tools/run_longrun.py:134-156`
    demands the same of the reference)."""
    half = images.shape[0] // 2
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "longrun_ckpt.npz")
        first = odometry.OdometryRunner(cfg, ingest="host", device=dev,
                                        chunk=16)
        first.process(images[:half])
        first.save_checkpoint(ck)
        runner = odometry.OdometryRunner.resume(cfg, ck, device=dev,
                                                chunk=16)
        runner.process(images[half:])
    traj2, out2 = runner.trajectory(), runner.frame_outputs()
    same = {k: bool(np.array_equal(getattr(out2, k), getattr(out, k)))
            for k in ("pose", "fused", "health_checked", "healthy",
                      "health_dist", "health_rot")}
    same["trajectory"] = bool(np.array_equal(traj2, traj))
    _say(f"longrun-resume: split at frame {half}; bit-identical to the "
         f"unsplit run: {same} (max |delta| "
         f"{float(np.abs(traj2 - traj).max()):.2e})")
    if not all(same.values()):
        raise AssertionError("longrun-resume: the resumed run differs from "
                             "the unsplit one")


def phase_cov(cfg, images, traj, out, dev, card):
    """The long-run path with `estimate_cov_by_sampling`: poses and health
    fields equal to the plain run's bit for bit (the covariance feeds
    nothing back); every covariance finite; the sampled ones (frames where
    the fit was convex, so the covariance differs from the Censi one)
    symmetric positive definite."""
    runner, secs = _run_single(cfg, images, dev, 1)
    traj_c, out_c = runner.trajectory(), runner.frame_outputs()
    if not (np.array_equal(traj_c, traj)
            and all(np.array_equal(getattr(out_c, k), getattr(out, k))
                    for k in ("fused", "health_checked", "healthy",
                              "health_dist"))):
        raise AssertionError("longrun-cov: poses or health fields differ "
                             "from the run without sampling")
    cov = out_c.cov.astype(np.float64)
    if not np.isfinite(cov).all():
        raise AssertionError("longrun-cov: non-finite covariance")
    sampled = np.flatnonzero((out_c.cov != out.cov).any((1, 2)))
    c = cov[sampled]
    asym = float(np.abs(c - c.transpose(0, 2, 1)).max() / np.abs(c).max())
    evals = np.linalg.eigvalsh(0.5 * (c + c.transpose(0, 2, 1)))
    n = images.shape[0]
    _say(f"longrun-cov: {n / secs[0]:.2f} frames/s ({card}); sampled "
         f"covariance on {len(sampled)} of {n - 1} frames (the rest not "
         f"convex: Censi), asymmetry {asym:.2e} of the largest entry, "
         f"smallest eigenvalue {float(evals.min()):.3e}, median sqrt(var) "
         f"x/y/yaw {np.sqrt(np.median(c[:, [0, 1, 2], [0, 1, 2]], 0)).tolist()}")
    if len(sampled) == 0 or not (evals > 0).all() or asym > 1e-5:
        raise AssertionError("longrun-cov: no sampled covariance, or one "
                             "that is not symmetric positive definite")


def longrun_window(state, cfg, dev, lanes=(1, BATCH)):
    """The dense association problems on the window the long-run path
    ends with, built as `window_inputs` builds the s50 window: the forward
    problem (S=4 keyframes of M=2048 as targets, the newest keyframe's
    cells in the world frame as the source) and the reverse problem of the
    health check (S=1: the newest keyframe as the only target, the one
    before it as the source). Returns {(S, B): (src, tar, valid)} for each
    lane count B in `lanes` (the window broadcast over B lanes)."""
    kf = CellMap(*(a[None] for a in state.kf_cells))
    kf_poses, kf_valid = state.kf_poses[None], state.kf_valid[None]
    attrs = registration._world_attrs(kf, kf_poses, cfg)      # (1, S, M, D)
    tar_valid = (attrs[..., 6] > 0.5) & kf_valid[..., None]
    s = attrs.shape[1]
    problems = {
        s: (se2.transform(kf_poses[:, -1], kf.mean[:, -1]), attrs[..., 0:2],
            tar_valid),
        1: (se2.transform(kf_poses[:, -2], kf.mean[:, -2]),
            attrs[:, -1:, :, 0:2], tar_valid[:, -1:])}
    _say(f"longrun window: S={s}, valid keyframes {int(kf_valid.sum())}, "
         f"mean valid cells {float(kf.valid.float().sum(-1).mean()):.1f}, "
         f"M={attrs.shape[2]}")
    return {(k, b): tuple(_lanes(a, b) for a in p)
            for k, p in problems.items() for b in lanes}


def _multi_calls(args):
    return {"nn_min_multi": lambda: cuda_assoc.nn_min_multi(*args),
            "nn_min_multi_unrolled":
                lambda: cuda_assoc.nn_min_multi_unrolled(*args)}


def drive_longrun_window(win):
    """Kernels B1 and B2 once each on every problem of the window."""
    outs = {key: {k: f() for k, f in _multi_calls(args).items()}
            for key, args in win.items()}
    torch.cuda.synchronize()
    return outs


def phase_longrun_window(win, outs, card):
    """The window's B1 and B2 outputs (`drive_longrun_window`) held bit
    for bit against kernel A and against their twin, then timed with CUDA
    events beside A, the twin and the library route. Returns the records of
    B1 and B2 at the forward problem with B=8."""
    res = {}
    for (s, b), args in win.items():
        nn_a, d2_a = cuda_assoc.nn_min(*args)
        nn_p, d2_p = cuda_assoc.nn_min_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(nn_a, nn_p) and torch.equal(d2_a, d2_p)):
            raise AssertionError(f"longrun window S={s} B={b}: kernel A "
                                 "differs from its twin")
        for k, (nn, d2) in outs[(s, b)].items():
            if not (torch.equal(nn, nn_a) and torch.equal(d2, d2_a)):
                raise AssertionError(f"longrun window S={s} B={b}: {k} "
                                     "differs from kernel A")
        t = {k: _cuda_ms(f, 50) for k, f in _multi_calls(args).items()}
        t["A"] = _cuda_ms(lambda: cuda_assoc.nn_min(*args), 50)
        t["plain"] = _cuda_ms(lambda: cuda_assoc.nn_min_plain(*args), 5,
                              "nn_min_plain")
        t["cdist + min"] = _cuda_ms(lambda: library_nn(*args), 5,
                                    "cdist + min")
        bnd = nn_bound(*args)
        within = float((d2_a <= 4.0).float().mean())
        _say(f"longrun window S={s} B={b}: B1, B2 == A == twin bit for bit "
             f"(rows within 2 m {within:.4f}); ms (CUDA events; {card}): "
             + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
             + f", bound {bnd['bound_ms']:.4f} ({bnd['bound_by']})")
        if (s, b) == (max(k for k, _ in win), BATCH):
            res = {k: {"max_abs_err": 0.0, "ms": t[k], "plain_ms": t["plain"],
                       **bnd, "library_ms": t["cdist + min"]}
                   for k in _multi_calls(args)}
    return res


def drive_recorded(cfg, images, dev, ingest, kernels):
    """OdometryRunner (`ingest`) over `images` on `dev`, with every call of
    the wrappers named in `kernels` (functions of `cuda_assoc` or
    `cuda_lm`) recorded in order. Returns (runner, {name: calls})."""
    owners = {"nn_min": cuda_assoc, "nn_min_sparse": cuda_assoc,
              "lm_solve_fused": cuda_lm}
    with contextlib.ExitStack() as stack:
        calls = {k: stack.enter_context(recorded(owners[k], k))
                 for k in kernels}
        runner = odometry.OdometryRunner(cfg, ingest=ingest, device=dev,
                                         chunk=16)
        runner.process(images)
        _sync(dev)
    return runner, calls


def _nan_fields(out, traj) -> list:
    """The FrameOutput fields (and the trajectory) that hold a NaN."""
    bad = [k for k, v in out._asdict().items()
           if np.issubdtype(np.asarray(v).dtype, np.floating)
           and np.isnan(v).any()]
    return bad + (["trajectory"] if np.isnan(traj).any() else [])


def phase_blind(cfg, run, gt, card, name="longrun-blind"):
    """The `longrun-blind` path against GOLDEN_BLIND: keyframe, success,
    health-checked and healthy flags identical to the golden's, every
    checked blind frame unhealthy, frames before BLIND_FROM within
    LONGRUN_TOL, no NaN in any FrameOutput field or in the trajectory, and
    `auto` resolved to kernel A for the forward and the reverse solve."""
    runner, _ = run
    m = cfg.feature.max_cells
    for s_act in (cfg.odometry.submap_scan_size, 1):
        method = registration.resolve_assoc_method(cfg, m, m, s_act,
                                                   runner.device)
        if method != "pallas":
            raise AssertionError(f"{name}: auto resolved to {method} at "
                                 f"S={s_act}, expected kernel A")
    traj, out = runner.trajectory(), runner.frame_outputs()
    with np.load(GOLDEN_BLIND) as z:
        g = {k: z[k] for k in z.files}
    if json.loads(str(g["config"])) != cfg.to_dict() \
            or json.loads(str(g["sequence"])) != BLIND_SEQUENCE \
            or int(g["blind_from"]) != BLIND_FROM:
        raise AssertionError(f"{name}: golden was made for another "
                             "configuration or sequence")
    nan = _nan_fields(out, traj)
    if nan or traj.shape != (len(gt), 3):
        raise AssertionError(f"{name}: NaN in {nan}, or a trajectory of "
                             f"shape {traj.shape}")
    for k in ("fused", "success", "health_checked", "healthy"):
        got = np.asarray(getattr(out, k))
        if not np.array_equal(got, g[k]):
            raise AssertionError(f"{name}: {k} differs from the golden's at "
                                 f"frames {np.flatnonzero(got != g[k]).tolist()}")
    blind = np.arange(len(traj)) >= BLIND_FROM
    chk = out.health_checked
    if not chk[blind].any() or out.healthy[blind & chk].any():
        raise AssertionError(f"{name}: a checked blind frame is healthy, or "
                             "none is checked")
    n = BLIND_FROM
    _check_traj(f"{name} frames 0-{n - 1} vs JAX golden (kernel A, "
                "interpret mode)", traj[:n], g["poses"][:n], out.fused[:n],
                g["fused"][:n], LONGRUN_TOL)
    _say(f"{name}: {len(traj)} frames, blind from {BLIND_FROM}: failed "
         f"frames {np.flatnonzero(~out.success).tolist()} (golden the same), "
         f"{int(chk[blind].sum())} blind frames checked, all unhealthy; "
         f"health_dist on them {sorted(set(out.health_dist[blind].tolist()))}"
         f"; cells / associations on the blind frames "
         f"{int(out.num_cells[blind].max())} / "
         f"{int(out.num_assoc[blind].max())} at most; no NaN in "
         f"{len(out._fields)} fields ({card})")


def _hold_degenerate_a(name, key, args, card):
    """Kernel A on a recorded call's arguments `args`: bit-equal to its
    twin, two launches bit-identical; timed beside its twin, `cdist + min`
    and its bound (no distance counted where no target is valid).
    Returns (nn, d2, record)."""
    (nn, d2), (nn_q, d2_q) = _hold("A", key, cuda_assoc.nn_min,
                                   cuda_assoc.nn_min_plain, args)
    share = 1.0 if args[2].any() else 0.0
    fin = torch.isfinite(d2_q)
    rec = {"max_abs_err": float((d2[fin] - d2_q[fin]).abs().max())
           if fin.any() else 0.0,
           "ms": _cuda_ms(lambda: cuda_assoc.nn_min(*args), 100),
           **nn_bound(*args, share),
           "library_ms": _cuda_ms(lambda: library_nn(*args), 5,
                                  "cdist + min"),
           "plain_ms": _cuda_ms(lambda: cuda_assoc.nn_min_plain(*args), 5,
                                "nn_min_plain")}
    _say(f"kernel A {name} {key}: bit-equal to its twin, repeat and lanes "
         f"bit-identical; nn in {sorted(set(nn.flatten().tolist()))[:4]}"
         f"..., d2 finite {int(torch.isfinite(d2).sum())} of {d2.numel()}; "
         f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
         f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}) ({card})")
    return nn, d2, rec


def _hold_degenerate_f(name, packed, pose0, cfg, card, at_guess):
    """Kernel F, both variants, on a degenerate problem against its twin:
    the variants bit-equal and no NaN in cost or relative decrease. With
    `at_guess` (no weight, or zero residual at the guess) no step is taken
    and pose, cost, steps and relative decrease equal the twin's, the pose
    the guess bit for bit. Otherwise (one non-zero row a lane: two
    residuals for three unknowns, fitted exactly by a line of poses) both
    must fit it (cost under LM_FIT_COST) and the pose must lie within
    LM_ROW_POSE_TOL of the twin's. How many steps each takes to get there
    is decided within float32 rounding of a zero cost, so the steps are
    printed beside the twin's, not held: on the card the kernel stops
    after 2 and its twin after 4 (the reference's own solves differ by a
    step either way on such problems on the CPU). Returns a record."""
    ee = cuda_lm.lm_solve_fused(packed, pose0, cfg, early_exit=True)
    masked = cuda_lm.lm_solve_fused(packed, pose0, cfg, early_exit=False)
    plain = cuda_lm.lm_solve_fused_plain(packed, pose0, cfg)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(ee, masked)):
        raise AssertionError(f"kernel F {name}: early exit and masked "
                             "variants differ")
    for k, i in (("cost", 1), ("relative decrease", 3)):
        if torch.isnan(ee[i]).any() or torch.isnan(plain[i]).any():
            raise AssertionError(f"kernel F {name}: NaN in its {k} "
                                 f"({ee[i].tolist()}, twin "
                                 f"{plain[i].tolist()})")
    dpose = float((ee[0] - plain[0]).abs().max())
    if at_guess:
        same = all(torch.equal(x, y) for x, y in zip(ee, plain))
        if not (same and torch.equal(ee[0], pose0)
                and not ee[2].any()):
            raise AssertionError(
                f"kernel F {name}: steps {ee[2].tolist()} (twin "
                f"{plain[2].tolist()}), cost {ee[1].tolist()} (twin "
                f"{plain[1].tolist()}), the pose {dpose:.3e} from the "
                "twin's: it must keep the guess as the twin does")
    elif ee[1].max() > LM_FIT_COST or plain[1].max() > LM_FIT_COST \
            or dpose > LM_ROW_POSE_TOL:
        raise AssertionError(f"kernel F {name}: cost {ee[1].tolist()} (twin "
                             f"{plain[1].tolist()}), the pose {dpose:.3e} "
                             "from the twin's: it must fit the row within "
                             f"{LM_ROW_POSE_TOL} of the twin's pose")
    rec = {"dpose": dpose, "steps": ee[2].tolist(),
           "twin_steps": plain[2].tolist(),
           "ms": _cuda_ms(lambda: cuda_lm.lm_solve_fused(packed, pose0, cfg),
                          100),
           "plain_ms": _cuda_ms(lambda: cuda_lm.lm_solve_fused_plain(
               packed, pose0, cfg), 5, "lm_solve_fused_plain"),
           **lm_bound(packed, ee[2])}
    _say(f"kernel F {name} (B={packed.shape[0]} N={packed.shape[2]}): early "
         f"exit == masked bit for bit, steps {rec['steps']} (twin "
         f"{rec['twin_steps']}), cost {ee[1].tolist()}, relative decrease "
         f"{ee[3].tolist()} (twin {plain[1].tolist()}, {plain[3].tolist()}), "
         f"|dpose| from the twin {dpose:.3e}"
         f"{'; the guess kept bit for bit, as the twin' if at_guess else ''}"
         f"; kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms "
         f"({card})")
    return rec


def _single_row(packed):
    """A copy of `packed` whose weights are zero but on each lane's first
    row of non-zero weight."""
    one = packed.clone()
    w = one[:, 4]
    keep = torch.argmax((w != 0).to(torch.int32), dim=1)
    mask = torch.zeros_like(w, dtype=torch.bool)
    mask[torch.arange(w.shape[0], device=w.device), keep] = True
    one[:, 4] = torch.where(mask, w, torch.zeros_like(w))
    return one


def phase_blind_kernels(run, card):
    """Kernels A and F on the degenerate calls of the `longrun-blind` path,
    each against its twin: A on a blind frame's reverse solve (no valid
    target: (0, +inf) on every row, as the twin gives) and on its forward
    solve (a source of no cell); F, both variants, on a blind frame's
    problem (every weight zero: no step, the guess kept bit for bit, as the
    twin) and on a seeing frame's problem cut to a single non-zero row
    (fitted exactly by kernel and twin). Returns records for the kernels
    line."""
    _, calls = run
    a_calls = [c[0] for c in calls["nn_min"]]
    rev = [i for i, a in enumerate(a_calls) if not a["valid"].any()]
    if not rev or rev[0] == 0 or a_calls[rev[0] - 1]["valid"].shape[1] == 1:
        raise AssertionError("longrun-blind: no reverse solve without a "
                             "valid target after a forward solve")
    recs = {}
    for label, i in (("no valid target", rev[0]),
                     ("no source cell", rev[0] - 1)):
        args = tuple(a_calls[i][k] for k in ("src", "tar", "valid"))
        key = f"{label} {shape_key(*args[2].shape[:2], args[0].shape[1], args[2].shape[2])}"
        nn, d2, recs[f"A {key}"] = _hold_degenerate_a("blind", key, args,
                                                      card)
        if label == "no valid target" and not (
                (nn == 0).all() and torch.isinf(d2).all()):
            raise AssertionError("kernel A: rows without a valid target "
                                 "must give (0, +inf)")
    f_calls = [c[0] for c in calls["lm_solve_fused"]]
    zero = [c for c in f_calls if not c["packed"][:, 4].any()]
    seeing = [c for c in f_calls if c["packed"][:, 4].any()]
    if not zero or not seeing:
        raise AssertionError("longrun-blind: no kernel F call with all "
                             "weights zero, or none with weights")
    for label, c, at_guess in (("all weights zero", zero[-1], True),
                               ("one non-zero row", seeing[-1], False)):
        packed = c["packed"] if at_guess else _single_row(c["packed"])
        recs[f"F {label}"] = _hold_degenerate_f(
            label, packed, c["pose0"], c["cfg"], card, at_guess)
    return recs


def phase_stationary(cfg, run, card, name="stationary"):
    """The `stationary` path against GOLDEN_STATIONARY: only the bootstrap
    keyframe (flags equal to the golden's), every frame successful, every
    pose within STATIONARY_MAX_XY of the origin and within TOL of the
    golden's; then kernel C on frame 1's first association (source equal to
    target: d2 exactly 0 on every valid source row, each matched to a cell
    at its own place, bit-equal to the twin) and kernel F on its first
    problem (zero residual at the guess) against their twins. Returns
    records for the kernels line."""
    runner, calls = run
    traj, out = runner.trajectory(), runner.frame_outputs()
    with np.load(GOLDEN_STATIONARY) as z:
        g = {k: z[k] for k in z.files}
    if json.loads(str(g["config"])) != cfg.to_dict() \
            or json.loads(str(g["sequence"])) != STATIONARY:
        raise AssertionError(f"{name}: golden was made for another "
                             "configuration or sequence")
    nan = _nan_fields(out, traj)
    if nan or not out.success.all():
        raise AssertionError(f"{name}: NaN in {nan}, or failed frames "
                             f"{np.flatnonzero(~out.success).tolist()}")
    if np.flatnonzero(out.fused).tolist() != [0]:
        raise AssertionError(f"{name}: keyframes at "
                             f"{np.flatnonzero(out.fused).tolist()}")
    xy = float(np.abs(traj[:, :2]).max())
    if xy >= STATIONARY_MAX_XY:
        raise AssertionError(f"{name}: a pose {xy:.4f} m from the origin")
    _check_traj(f"{name} vs JAX golden (kernel C, interpret mode)", traj,
                g["poses"], out.fused, g["fused"], TOL)
    _say(f"{name}: {len(traj)} frames of one sweep, keyframes "
         f"{np.flatnonzero(out.fused).tolist()}, max |xy| {xy:.6f} m (golden "
         f"{float(np.abs(g['poses'][:, :2]).max()):.6f}), associations "
         f"{out.num_assoc[1:].min()}-{out.num_assoc[1:].max()} ({card})")
    c = calls["nn_min_sparse"][0][0]
    args = tuple(c[k] for k in ("src", "src_bounds", "tar", "tar_bounds",
                                "valid", "radius"))
    got, again = cuda_assoc.nn_min_sparse(*args), cuda_assoc.nn_min_sparse(*args)
    want = cuda_assoc.nn_min_sparse_plain(*args)
    torch.cuda.synchronize()
    if not (all(map(torch.equal, got, want))
            and all(map(torch.equal, again, got))):
        raise AssertionError(f"{name}: kernel C on source = target differs "
                             "from its twin or between launches")
    nn, d2 = got
    src, tar, valid = args[0], args[2], args[4]
    slot = valid[0].any(-1).nonzero().flatten()
    if len(slot) != 1:
        raise AssertionError(f"{name}: frame 1 sees {len(slot)} keyframes")
    k = int(slot[0])
    rows = valid[0, k]          # the keyframe's cells are the frame's own
    matched = tar[0, k][nn[0, k].long()]
    if not (bool((d2[0, k][rows] == 0).all())
            and torch.equal(matched[rows], src[0][rows])):
        raise AssertionError(f"{name}: kernel C does not match every cell to "
                             "itself at d2 = 0")
    recs = {"C source = target": {
        "max_abs_err": 0.0, "rows": int(rows.sum()),
        "ms": _cuda_ms(lambda: cuda_assoc.nn_min_sparse(*args), 100),
        "plain_ms": _cuda_ms(lambda: cuda_assoc.nn_min_sparse_plain(*args),
                             5, "nn_min_sparse_plain"),
        **nn_bound(src, tar, valid, float(cuda_assoc.pair_live(
            args[1], args[3], args[5]).float().mean()))}}
    _say(f"{name}: kernel C on frame 1's first association: {int(rows.sum())}"
         f" source cells each at d2 = 0 on its own place, bit-equal to the "
         f"twin; kernel {recs['C source = target']['ms']:.4f} ms ({card})")
    f = calls["lm_solve_fused"][0][0]
    if not torch.equal(f["pose0"], torch.zeros_like(f["pose0"])):
        raise AssertionError(f"{name}: frame 1's first solve does not start "
                             "at the identity")
    recs["F zero residual"] = _hold_degenerate_f(
        "zero residual", f["packed"], f["pose0"], f["cfg"], card, True)
    return recs


def overflow_counts(images, cfg, dev) -> tuple:
    """Per frame of `images`, the occupied voxels of its host-filtered
    points and the number kernel G's inputs drop (ranked at or beyond
    c_pre): (occupied, dropped, c_pre), numpy arrays and an int."""
    rows = odometry.host_filter(images, cfg, "compact")
    pts = filtering.points_from_compact(odometry.to_device(rows, dev), cfg)
    leaf, dim, _ = features._grid_geometry(cfg)
    occupied = features._voxel_centroids(pts.xy, pts.valid, leaf, dim)[5]
    occ = occupied.sum(-1).cpu().numpy()
    c_pre = features._pre_cells(cfg)
    return occ, np.maximum(occ - c_pre, 0), c_pre


def phase_overflow_moments(images, dev, card, name="pallas-features-overflow"):
    """Kernel G on the overflow path's frames: how many frames and voxels
    pass c_pre (at least half the frames must), then, BATCH frames a call,
    bit-equal to its twin and each lane equal to its own B=1 call. Returns
    a record for the kernels line."""
    cfg = overflow_config()
    occ, dropped, c_pre = overflow_counts(images, cfg, dev)
    over = np.flatnonzero(dropped)
    _say(f"{name}: c_pre {c_pre}, occupied voxels a frame {int(occ.min())}"
         f"-{int(occ.max())}; {len(over)} of {len(occ)} frames drop voxels, "
         f"{int(dropped.sum())} in all ({int(dropped.max())} at most in a "
         f"frame)")
    if 2 * len(over) < len(occ):
        raise AssertionError(f"{name}: only {len(over)} of {len(occ)} frames "
                             "drop voxels")
    lanes = 0
    for lo in range(0, len(over) - len(over) % BATCH, BATCH):
        inputs, one = moment_inputs(images[over[lo:lo + BATCH]], dev, cfg)
        got = cuda_features.moment_accumulate(*inputs)
        plain = cuda_features.moment_accumulate_plain(*inputs)
        torch.cuda.synchronize()
        _check_moments(name, got, plain)
        for i, lane in enumerate(one):
            if not torch.equal(cuda_features.moment_accumulate(*lane)[0],
                               got[i]):
                raise AssertionError(f"kernel G {name}: lane {i} differs "
                                     "from its B=1 call")
        lanes += BATCH
    ms = _cuda_ms(lambda: cuda_features.moment_accumulate(*inputs), 50)
    plain_ms = _cuda_ms(lambda: cuda_features.moment_accumulate_plain(
        *inputs), 5, "moment_accumulate_plain")
    library, n_hits = index_add_yardstick(inputs)
    rec = {"frames": len(occ), "overflowing": len(over),
           "voxels dropped": int(dropped.sum()), "ms": ms,
           "plain_ms": plain_ms,
           "library_ms": _cuda_ms(library, 50, "index_add_"),
           **bound(sum(t.numel() * 4 for t in inputs[:5]) + got.numel() * 4,
                   MOMENT_FLOPS * float(n_hits))}
    _say(f"{name}: kernel G bit-equal to its twin on {lanes} overflowing "
         f"frames, {BATCH} a call, each lane equal to its B=1 call; kernel "
         f"{ms:.4f} ms at B={BATCH} (pack {tuple(inputs[0].shape)}), plain "
         f"{plain_ms:.4f} ms, index_add_ {rec['library_ms']:.4f} ms, bound "
         f"{rec['bound_ms']:.4f} ms ({card})")
    return rec


def drive_refine(dev):
    """The `refine` phase's runs: the port's `refine_many_to_many` on
    GOLDEN_REFINE's inputs on `dev`, twice. Returns (golden, both results,
    wall seconds of the first)."""
    with np.load(GOLDEN_REFINE) as z:
        g = {k: z[k] for k in z.files}
    cfg = slam_config()
    if json.loads(str(g["config"])) != cfg.to_dict() \
            or json.loads(str(g["refine"])) != REFINE:
        raise AssertionError("refine: golden was made for another "
                             "configuration")
    cells = CellMap(*(torch.as_tensor(g["cells_" + f]).to(dev)
                      for f in CellMap._fields))
    poses0 = torch.as_tensor(g["poses0"]).to(dev)
    valid = torch.as_tensor(g["valid"]).to(dev)
    t0 = time.perf_counter()
    first = registration.refine_many_to_many(cells, poses0, valid, cfg)
    _sync(dev)
    secs = time.perf_counter() - t0
    again = registration.refine_many_to_many(cells, poses0, valid, cfg)
    return g, first, again, secs


def phase_refine(run, card):
    """`refine_many_to_many` on the card against the reference's refined
    poses: two runs bit-identical, within REFINE_TOL, the first pose
    fixed."""
    g, first, again, secs = run
    if not torch.equal(first, again):
        raise AssertionError("refine: two runs on the card differ")
    got, want = first.cpu().numpy(), g["refined"]
    dxy = float(np.abs(got[:, :2] - want[:, :2]).max())
    dth = float(np.abs(got[:, 2] - want[:, 2]).max())
    moved = float(np.abs(got[:, :2] - g["poses0"][:, :2]).max())
    _say(f"refine: {got.shape[0]} scans, max |dxy| {dxy:.3e} m, |dyaw| "
         f"{dth:.3e} rad from the reference's refined poses (poses moved up "
         f"to {moved:.4f} m); a second run bit-identical; {secs:.2f} s wall "
         f"({card})")
    if not np.array_equal(got[0], g["poses0"][0]):
        raise AssertionError("refine: the first pose moved")
    if dxy > REFINE_TOL[0] or dth > REFINE_TOL[1]:
        raise AssertionError(f"refine: outside {REFINE_TOL} of the "
                             "reference's refined poses")


def drive_slam(cfg, images, dev):
    """The SLAM pass on the card as `tools/run_slam_scale_torch.py` runs
    it: host-ingest odometry, the graph with scan payloads on the card,
    `close_from_graph` (verification in chunks of 512 lanes: kernels A and
    F), `to_arrays`, `optimize` (SLAM_ITERS). Returns its results, the wall
    seconds of each stage and the launches of the verification alone."""
    secs, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        _sync(dev)
        secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    runner = odometry.OdometryRunner(cfg, chunk=32, ingest="host", device=dev)
    runner.process(images)
    traj, out = runner.trajectory(), runner.frame_outputs()
    lap("odometry")
    gb = posegraph.build_graph_from_odometry(out, traj, images=images,
                                             cfg=cfg, device=dev)
    lap("graph + payloads")
    before = _launches()
    accepted = loopclosure.LoopCloser(cfg, device=dev).close_from_graph(gb)
    verify = {k: v - before[k] for k, v in _launches().items()
              if v != before[k]}
    lap("close_from_graph")
    opt, _ = posegraph.optimize(gb.to_arrays(device=dev), **SLAM_ITERS)
    opt = opt.poses.cpu().numpy()
    lap("to_arrays + optimize")
    return {"traj": traj, "out": out, "gb": gb, "accepted": accepted,
            "opt": opt, "secs": secs, "verify": verify}


def golden_outputs(g):
    """The two fields of a SLAM golden's frame outputs that the graph
    builder reads: its keyframe flags, and unit odometry covariances
    (loop verification does not read them)."""
    fused = np.asarray(g["fused"])
    return types.SimpleNamespace(
        fused=fused, cov=np.broadcast_to(np.eye(3), (len(fused), 3, 3)))


def golden_loops(cfg, g, images, dev) -> set:
    """The loop edges `close_from_graph` accepts on `dev` on a graph with
    scan payloads built from a SLAM golden's own odometry."""
    gb = posegraph.build_graph_from_odometry(golden_outputs(g), g["poses"],
                                             images=images, cfg=cfg,
                                             device=dev)
    return set(loopclosure.LoopCloser(cfg, device=dev).close_from_graph(gb))


def golden_graph(z, dev) -> posegraph.PoseGraph:
    """The graph arrays the reference's `to_arrays` wrote into a golden."""
    return posegraph.PoseGraph(*(torch.as_tensor(z["g_" + f]).to(dev)
                                 for f in posegraph.PoseGraph._fields))


def phase_slam(cfg, res, gt, dev, card, name="slam", golden=GOLDEN_SLAM,
               sequence=SLAM_SEQUENCE, images=None):
    """The `slam` path (or `name`'s, over `sequence`) against its golden
    (`GOLDEN_SLAM`, or `golden`): every frame successful, the keyframe
    count identical, accepted loop edges within SLAM_LOOP_SHARE of the
    golden's count and SLAM_PAIR_SHARE of its pairs, closure lowering the
    keyframe ATE (both printed beside the golden's). With the path's
    sweeps `images` (`slam-dropout`), the loop edges so held are those the
    card's verification accepts on a graph built from the golden's own
    odometry (`golden_loops`), the path's own count must lie within
    SLAM_DROPOUT_OWN_LOOP_SHARE of the golden's, its closed keyframe ATE
    within SLAM_DROPOUT_ATE_TOL of the golden's, and both the card's
    closure on the committed card odometry (CARD_SLAM_DROPOUT) and the
    pass's own accepted set must be that file's pairs, which the
    reference's closure accepts on it.
    Then the port's `optimize` on the golden's own graph arrays, twice:
    bit-identical, and within SLAM_OPT_TOL of JAX's optimized poses."""
    for s_act in (cfg.odometry.submap_scan_size, 1):
        m = cfg.feature.max_cells
        method = registration.resolve_assoc_method(cfg, m, m, s_act, dev)
        if method != "pallas":
            raise AssertionError(f"{name}: auto resolved to {method} at "
                                 f"S={s_act}, expected kernel A")
    with np.load(golden) as z:
        g = {k: z[k] for k in z.files}
    if json.loads(str(g["config"])) != cfg.to_dict() \
            or json.loads(str(g["sequence"])) != sequence \
            or json.loads(str(g["iters"])) != SLAM_ITERS:
        raise AssertionError(f"{name}: golden was made for another "
                             "configuration or sequence")
    traj, out = res["traj"], res["out"]
    n = traj.shape[0]
    if not np.isfinite(traj).all() or traj.shape != (len(gt), 3):
        raise AssertionError(f"{name}: trajectory not finite or of the wrong "
                             "shape")
    if not out.success.all():
        raise AssertionError(f"{name}: failed frames "
                             f"{np.flatnonzero(~out.success).tolist()}")
    dpos, dyaw, dmot = traj_spread(traj, g["poses"])
    kf = np.flatnonzero(out.fused)
    g_kf = int(g["fused"].sum())
    _say(f"{name}: odometry vs JAX golden: max |dpos| {dpos:.6f} m, |dyaw| "
         f"{dyaw:.3e} rad, |dmotion| {dmot:.6f} m; keyframes {len(kf)} "
         f"(golden {g_kf}); keyframe flags equal "
         f"{bool(np.array_equal(out.fused, g['fused']))}")
    if len(kf) != g_kf:
        raise AssertionError(f"{name}: {len(kf)} keyframes, golden {g_kf}")
    acc = set(res["accepted"])
    g_acc = set(map(tuple, g["accepted"].tolist()))
    both = len(acc & g_acc)
    n_cand = res["gb"].n_constraints(posegraph.CANDIDATE)
    ate_odo = slam_scale.keyframe_ate(traj[kf], gt[kf])
    ate_slam = slam_scale.keyframe_ate(res["opt"], gt[kf])
    lr0 = slam_scale.loop_residuals(res["gb"].edges, traj[kf],
                                    posegraph.LOOP_APPEARANCE)
    lr1 = slam_scale.loop_residuals(res["gb"].edges, res["opt"],
                                    posegraph.LOOP_APPEARANCE)
    _say(f"{name}: accepted loop edges {len(acc)} (golden {len(g_acc)}, "
         f"{both} pairs in both), candidates {n_cand} (golden "
         f"{int(g['n_candidates'])}); loop residual median "
         f"{np.median(lr0):.4f} -> {np.median(lr1):.4f} m (golden "
         f"{float(g['loop_res_before']):.4f} -> "
         f"{float(g['loop_res_after']):.4f}); keyframe ATE {ate_odo:.4f} -> "
         f"{ate_slam:.4f} m (golden {float(g['ate_odo']):.4f} -> "
         f"{float(g['ate_slam']):.4f})")
    _say(f"{name}: {n} frames; wall s by stage " + json.dumps(
        {k: round(v, 2) for k, v in res["secs"].items()})
        + f"; verification launches {json.dumps(res['verify'])} ({card})")
    loops, on = acc, "its own odometry"
    if images is not None:
        loops, on = golden_loops(cfg, g, images, dev), "the golden's odometry"
        _say(f"{name}: on the golden's odometry the card's verification "
             f"accepts {len(loops)} loop edges (golden {len(g_acc)}, "
             f"{len(loops & g_acc)} pairs in both) ({card})")
        if abs(ate_slam - float(g["ate_slam"])) > SLAM_DROPOUT_ATE_TOL:
            raise AssertionError(f"{name}: closed keyframe ATE {ate_slam:.4f}"
                                 f" m, golden {float(g['ate_slam']):.4f}")
        if abs(len(acc) - len(g_acc)) > SLAM_DROPOUT_OWN_LOOP_SHARE \
                * len(g_acc):
            raise AssertionError(
                f"{name}: the pass accepted {len(acc)} loop edges on its own "
                f"odometry, outside {SLAM_DROPOUT_OWN_LOOP_SHARE:.0%} of the "
                f"golden's {len(g_acc)}")
        with np.load(CARD_SLAM_DROPOUT) as z:
            c = {k: z[k] for k in ("poses", "fused", "accepted", "card")}
        c_acc = set(map(tuple, c["accepted"].tolist()))
        on_file = golden_loops(cfg, c, images, dev)
        same = bool(np.array_equal(traj, c["poses"])
                    and np.array_equal(out.fused, c["fused"]))
        _say(f"{name}: on the committed card odometry ({c['card']}) the "
             f"card's verification accepts {len(on_file)} loop edges, "
             f"{len(on_file & c_acc)} of the file's {len(c_acc)} (the "
             f"reference's on it); the pass's own {len(acc)}, "
             f"{len(acc & c_acc)} of them; its odometry the file's bit for "
             f"bit: {same} (max |dpos| "
             f"{float(np.abs(traj[:, :2] - c['poses'][:, :2]).max()):.3e} m)"
             f" ({card})")
        if on_file != c_acc:
            raise AssertionError(f"{name}: on the committed card odometry the"
                                 " card's closure accepts other pairs than "
                                 "the reference's")
        if acc != c_acc:
            raise AssertionError(
                f"{name}: the pass's own accepted pairs are not the committed "
                f"card odometry's (odometry the same: {same}); remake "
                f"{os.path.basename(CARD_SLAM_DROPOUT)} with `tools/"
                "slam_verify_torch.py --save-odometry` if the card's "
                "odometry moved")
    if abs(len(loops) - len(g_acc)) > SLAM_LOOP_SHARE * len(g_acc) \
            or len(loops & g_acc) < SLAM_PAIR_SHARE * len(g_acc):
        raise AssertionError(f"{name}: accepted loop edges on {on} outside "
                             f"{SLAM_LOOP_SHARE:.0%} of the golden's count "
                             f"or under {SLAM_PAIR_SHARE:.0%} of its pairs")
    if not ate_slam < ate_odo:
        raise AssertionError(f"{name}: closure did not lower the keyframe ATE "
                             f"({ate_odo:.4f} -> {ate_slam:.4f} m)")
    graph = golden_graph(g, dev)
    t0 = time.perf_counter()
    first, _ = posegraph.optimize(graph, **SLAM_ITERS)
    _sync(dev)
    secs = time.perf_counter() - t0
    again, _ = posegraph.optimize(graph, **SLAM_ITERS)
    same = torch.equal(first.poses, again.poses)
    got = first.poses.cpu().numpy()
    want = g["opt_poses"]
    dxy = float(np.abs(got[:, :2] - want[:, :2]).max())
    dth = float(np.abs(got[:, 2] - want[:, 2]).max())
    _say(f"{name}: optimize on the golden's graph ({graph.poses.shape[0]} "
         f"nodes, {int(graph.edge_valid.sum())} edges) vs JAX: max |dxy| "
         f"{dxy:.3e} m, |dyaw| {dth:.3e} rad; a second run bit-identical: "
         f"{same}; {secs:.2f} s wall ({card})")
    if not same:
        raise AssertionError(f"{name}: two optimize runs on the card differ")
    if dxy > SLAM_OPT_TOL[0] or dth > SLAM_OPT_TOL[1]:
        raise AssertionError(f"{name}: optimize outside {SLAM_OPT_TOL} of "
                             "JAX's on the golden's graph")


def drive_merge(cfg, gb_a, images_b, dev, mesh=None, gb_b=None):
    """Session B's host-ingest odometry and graph with payloads on the card
    (unless `gb_b` is given), then `merge_many([A, B])` as users call it
    (on `mesh` when one is given). Returns its results, the candidate
    pairs, the launches and wall seconds of `merge_many` alone."""
    res = {}
    if gb_b is None:
        runner = odometry.OdometryRunner(cfg, chunk=32, ingest="host",
                                         device=dev)
        runner.process(images_b)
        res["traj"], res["out"] = runner.trajectory(), runner.frame_outputs()
        gb_b = posegraph.build_graph_from_odometry(
            res["out"], res["traj"], images=images_b, cfg=cfg, device=dev)
    before = _launches()
    _sync(dev)
    t0 = time.perf_counter()
    with recorded(multisession, "cross_session_matches") as found, \
            recorded(loopclosure.LoopCloser, "_verify") as verify:
        opt, joint, merges, offsets = multisession.merge_many(
            [gb_a, gb_b], cfg, iters=MERGE_ITERS, mesh=mesh, device=dev)
    _sync(dev)
    res.update(
        gb_b=gb_b, opt=opt, joint=joint, t_ab=merges[0]["t_ab"],
        inliers=[(m["i_a"], m["j_b"]) for m in merges[0]["inliers"]],
        verified=[(m["i_a"], m["j_b"]) for m in found[0][1]],
        pairs=len(verify[0][0]["src_idx"]), secs=time.perf_counter() - t0,
        launches={k: v - before[k] for k, v in _launches().items()
                  if v != before[k]})
    return res


def phase_merge(cfg, res, gt_b, card):
    """The `merge` path against its golden (`GOLDEN_MERGE`): session B's
    keyframe flags identical; the inlier matches within MERGE_COUNT_SHARE
    of the golden's count with at least MERGE_PAIR_SHARE of its pairs;
    `t_ab` within MERGE_T_TOL; B's keyframe error after the merge within
    MERGE_ERR_TOL of the golden's and under 0.2x the identity alignment's
    (`tests/test_multisession.py:99-126`)."""
    with np.load(GOLDEN_MERGE) as z:
        g = {k: z[k] for k in z.files}
    if json.loads(str(g["config"])) != cfg.to_dict() \
            or json.loads(str(g["sequence"])) != SLAM_SEQUENCE \
            or json.loads(str(g["merge_sequence"])) != MERGE_SEQUENCE \
            or json.loads(str(g["iters"])) != MERGE_ITERS:
        raise AssertionError("merge: golden was made for another "
                             "configuration or sequence")
    out, gb_a_nodes = res["out"], int(g["a_nodes"])
    if not out.success.all():
        raise AssertionError("merge: session B has failed frames")
    dpos, dyaw, dmot = traj_spread(res["traj"], g["b_poses"])
    _say(f"merge: session B odometry vs JAX golden: max |dpos| {dpos:.6f} m, "
         f"|dyaw| {dyaw:.3e} rad, |dmotion| {dmot:.6f} m; keyframes "
         f"{int(out.fused.sum())} (golden {int(g['b_fused'].sum())})")
    if not np.array_equal(out.fused, g["b_fused"]):
        raise AssertionError("merge: session B's keyframe flags differ from "
                             "the golden's")
    lanes = (loopclosure.LoopCloser.VERIFY_CHUNK
             if res["pairs"] > loopclosure.LoopCloser.VERIFY_CHUNK
             else loopclosure._next_pow2(res["pairs"]))
    if (lanes, 1, cfg.feature.max_cells, cfg.feature.max_cells) \
            not in A_SHAPES or lanes not in LM_VERIFY[0]:
        raise AssertionError(f"merge: verification at B={lanes}, a shape "
                             "the kernel phases do not hold")
    kf = np.flatnonzero(out.fused)
    ka = len(res["joint"].poses) - len(kf)
    err, err_id = merge_errors(res["opt"][ka:], np.stack(res["gb_b"].poses),
                               gt_b[kf])
    got, want = set(res["inliers"]), set(map(tuple, g["inliers"].tolist()))
    both = len(got & want)
    t_ab = np.asarray(res["t_ab"])
    dt = (float(np.abs(t_ab[:2] - g["t_ab"][:2]).max()),
          float(abs(t_ab[2] - g["t_ab"][2])))
    _say(f"merge: {res['pairs']} candidate pairs in "
         f"{-(-res['pairs'] // lanes)} chunk(s) of {lanes} lanes; verified "
         f"{len(res['verified'])} (golden {len(g['verified'])}), inliers "
         f"{len(got)} (golden {len(want)}, {both} in both); t_ab "
         f"{np.round(t_ab, 4).tolist()} (golden "
         f"{np.round(g['t_ab'], 4).tolist()}: |d| {dt[0]:.4f} m, "
         f"{dt[1]:.2e} rad; B's true start {np.round(gt_b[0], 4).tolist()}); "
         f"B's keyframe error {err:.4f} m merged (golden "
         f"{float(g['err_merged']):.4f}), {err_id:.4f} m with the identity "
         f"alignment; A {ka} nodes (golden {gb_a_nodes})")
    _say(f"merge: merge_many {res['secs']:.2f} s wall, launches "
         f"{json.dumps(res['launches'])} ({card})")
    if ka != gb_a_nodes:
        raise AssertionError(f"merge: session A has {ka} nodes, golden "
                             f"{gb_a_nodes}")
    if abs(len(got) - len(want)) > MERGE_COUNT_SHARE * len(want) \
            or both < MERGE_PAIR_SHARE * len(want):
        raise AssertionError("merge: inlier matches outside "
                             f"{MERGE_COUNT_SHARE:.0%} of the golden's count "
                             f"or under {MERGE_PAIR_SHARE:.0%} of its pairs")
    if dt[0] > MERGE_T_TOL[0] or dt[1] > MERGE_T_TOL[1]:
        raise AssertionError(f"merge: t_ab outside {MERGE_T_TOL} of the "
                             "golden's")
    if abs(err - float(g["err_merged"])) > MERGE_ERR_TOL \
            or not err < 0.2 * err_id:
        raise AssertionError(f"merge: B's keyframe error {err:.4f} m is "
                             f"outside {MERGE_ERR_TOL} m of the golden's or "
                             "not under 0.2x the identity alignment's")


def phase_merge_mesh(cfg, gb_a, merged, dev, card):
    """The `merge` path's merge with its joint solve on a NCCL group of one
    process (`parallel.distributed.initialize` over a local TCP
    rendezvous, `parallel.mesh.make_mesh`), torn down after: bit for bit
    the `merge` path's (the all-reduce of one rank is the identity)."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sk.getsockname()[1]}"
    distributed.initialize(coord, 1, 0, device=dev)
    try:
        m = mesh.make_mesh(device=dev)
        if m.group is None or m.size != 1 or \
                torch.distributed.get_backend() != "nccl":
            raise AssertionError("merge-mesh: no NCCL group of one process")
        res = drive_merge(cfg, gb_a, None, dev, mesh=m, gb_b=merged["gb_b"])
    finally:
        torch.distributed.destroy_process_group()
    same = (np.array_equal(res["opt"], merged["opt"])
            and np.array_equal(res["t_ab"], merged["t_ab"])
            and res["inliers"] == merged["inliers"])
    d = float(np.abs(res["opt"] - merged["opt"]).max())
    _say(f"merge-mesh: edge-sharded solve on a NCCL group of 1 ({coord}): "
         f"merged poses max |d| {d:.3e} from the merge path's, bit-identical "
         f"{same}; merge_many {res['secs']:.2f} s wall ({card})")
    if not same:
        raise AssertionError("merge-mesh: the sharded merge differs from "
                             "the merge path's")


def drive_merge3(cfg, gb_a, gb_b, images_c, dev, tmp):
    """Session C's host-ingest odometry and graph with payloads on the card,
    the three session graphs saved under `tmp` (A, B, C), then the port's
    merge CLI over them on the card as users call it (`merge3_args`, no
    --cpu). Returns the CLI's result, the merged graph and TUM file read
    back, each merge's candidate pairs, verified matches, inliers and
    `t_ab`, the shapes kernels A and F were called at, and the wall
    seconds of the CLI alone."""
    from cfear_radarodometry_code_public_tpu_torch import merge_sessions
    runner = odometry.OdometryRunner(cfg, chunk=32, ingest="host", device=dev)
    runner.process(images_c)
    res = {"traj": runner.trajectory(), "out": runner.frame_outputs()}
    gb_c = posegraph.build_graph_from_odometry(
        res["out"], res["traj"], images=images_c, cfg=cfg, device=dev)
    paths = [os.path.join(tmp, f"{k}.npz") for k in "abc"]
    for gb, path in zip((gb_a, gb_b, gb_c), paths):
        gb.save(path)
    out, tum = os.path.join(tmp, "merged.npz"), os.path.join(tmp, "merged.tum")
    _sync(dev)
    t0 = time.perf_counter()
    with recorded(multisession, "cross_session_matches") as found, \
            recorded(multisession, "align_from_matches") as aligned, \
            recorded(loopclosure.LoopCloser, "_verify") as verify, \
            kernel_shapes() as (a_shapes, f_shapes):
        result = merge_sessions.main(merge3_args(paths, out, tum))
    _sync(dev)
    res.update(
        secs=time.perf_counter() - t0, result=result,
        nodes=[len(gb.poses) for gb in (gb_a, gb_b, gb_c)],
        own_poses=[np.stack(gb.poses) for gb in (gb_b, gb_c)],
        merged=posegraph.GraphBuilder.load(out), tum=read_tum(tum),
        pairs=[len(v[0]["src_idx"]) for v in verify],
        verified=[[(m["i_a"], m["j_b"]) for m in f[1]] for f in found],
        inliers=[[(m["i_a"], m["j_b"]) for m in a[1][1]] for a in aligned],
        t_ab=[np.asarray(a[1][0]) for a in aligned],
        a_shapes=a_shapes, f_shapes=f_shapes)
    return res


def phase_merge3(cfg, res, fused_b, gt_b, gt_c, card):
    """The `merge-cli3` path against its golden (`GOLDEN_MERGE3`): the same
    configuration, sequences and CLI arguments; session C's keyframe flags
    identical; node counts identical, per session and merged; for each of
    the two merges the inlier matches within MERGE3_COUNT_SHARE of the
    golden's count with at least MERGE3_PAIR_SHARE of its pairs, `t_ab`
    within MERGE3_T_TOL, the new session's keyframe error within
    MERGE3_ERR_TOL of the golden's and under 0.2x the identity
    alignment's; the TUM file one line a merged node, at the merged
    graph's stamps and poses; kernels A and F at shapes the kernel phases
    hold."""
    with np.load(GOLDEN_MERGE3) as z:
        g = {k: z[k] for k in z.files}
    if json.loads(str(g["config"])) != cfg.to_dict() \
            or json.loads(str(g["sequence"])) != SLAM_SEQUENCE \
            or json.loads(str(g["merge_sequences"])) != [MERGE_SEQUENCE,
                                                         MERGE3_SEQUENCE] \
            or json.loads(str(g["argv"])) != merge3_args(
                ["<a>", "<b>", "<c>"], "<out>", "<tum>") \
            or json.loads(str(g["iters"])) != MERGE_ITERS:
        raise AssertionError("merge-cli3: golden was made for another "
                             "configuration, sequence or arguments")
    out = res["out"]
    if not out.success.all():
        raise AssertionError("merge-cli3: session C has failed frames")
    dpos, dyaw, dmot = traj_spread(res["traj"], g["poses_2"])
    _say(f"merge-cli3: session C odometry vs JAX golden: max |dpos| "
         f"{dpos:.6f} m, |dyaw| {dyaw:.3e} rad, |dmotion| {dmot:.6f} m; "
         f"keyframes {int(out.fused.sum())} (golden "
         f"{int(g['fused_2'].sum())})")
    if not np.array_equal(out.fused, g["fused_2"]) \
            or not np.array_equal(fused_b, g["fused_1"]):
        raise AssertionError("merge-cli3: session B's or C's keyframe flags "
                             "differ from the golden's")
    merged = res["merged"]
    nodes = res["nodes"]
    if nodes != g["nodes"].tolist() or len(merged.poses) != int(g["n_nodes"]) \
            or res["result"]["n_nodes"] != len(merged.poses) \
            or res["result"]["n_sessions"] != 3:
        raise AssertionError(f"merge-cli3: sessions of {nodes} nodes merged "
                             f"into {len(merged.poses)}, golden "
                             f"{g['nodes'].tolist()} -> {int(g['n_nodes'])}")
    check_path_shapes("merge-cli3", res["a_shapes"], res["f_shapes"])
    opt = np.stack(merged.poses)
    offsets = np.asarray(res["result"]["offsets"])
    tum = res["tum"]
    dyaw = np.angle(np.exp(1j * (tum[:, 3] - opt[:, 2])))
    if tum.shape != (len(merged.poses), 4) \
            or not np.allclose(tum[:, 0], merged.stamps, atol=1e-6) \
            or not np.allclose(tum[:, 1:3], opt[:, :2], atol=1e-6) \
            or not np.allclose(dyaw, 0.0, atol=1e-5):
        raise AssertionError("merge-cli3: the TUM file is not the merged "
                             "graph's stamps and poses")
    fails = []
    for k, (fused, gt) in enumerate(((fused_b, gt_b), (out.fused, gt_c)),
                                    start=1):
        lo, hi = offsets[k], offsets[k] + nodes[k]
        kf = np.flatnonzero(fused)
        err, err_id = merge_errors(opt[lo:hi], res["own_poses"][k - 1],
                                   gt[kf])
        got = set(res["inliers"][k - 1])
        want = set(map(tuple, g[f"inliers_{k}"].tolist()))
        both = len(got & want)
        t_ab = res["t_ab"][k - 1]
        dt = (float(np.abs(t_ab[:2] - g[f"t_ab_{k}"][:2]).max()),
              float(abs(t_ab[2] - g[f"t_ab_{k}"][2])))
        _say(f"merge-cli3 merge {k}: {res['pairs'][k - 1]} candidate pairs "
             f"(golden {int(g[f'pairs_{k}'])}); verified "
             f"{len(res['verified'][k - 1])} (golden "
             f"{len(g[f'verified_{k}'])}), inliers {len(got)} (golden "
             f"{len(want)}, {both} in both); t_ab {np.round(t_ab, 4).tolist()}"
             f" (golden {np.round(g[f't_ab_{k}'], 4).tolist()}: |d| "
             f"{dt[0]:.4f} m, {dt[1]:.2e} rad); session {k} keyframe error "
             f"{err:.4f} m merged (golden {float(g[f'err_{k}']):.4f}), "
             f"{err_id:.4f} m with the identity alignment")
        if abs(len(got) - len(want)) > MERGE3_COUNT_SHARE * len(want) \
                or both < MERGE3_PAIR_SHARE * len(want):
            fails.append(f"merge {k}: inlier matches outside "
                         f"{MERGE3_COUNT_SHARE:.0%} of the golden's count or "
                         f"under {MERGE3_PAIR_SHARE:.0%} of its pairs")
        if dt[0] > MERGE3_T_TOL[0] or dt[1] > MERGE3_T_TOL[1]:
            fails.append(f"merge {k}: t_ab outside {MERGE3_T_TOL}")
        if abs(err - float(g[f"err_{k}"])) > MERGE3_ERR_TOL \
                or not err < 0.2 * err_id:
            fails.append(f"merge {k}: keyframe error {err:.4f} m outside "
                         f"{MERGE3_ERR_TOL} m of the golden's or not under "
                         "0.2x the identity alignment's")
    _say(f"merge-cli3: {nodes} nodes merged into {len(merged.poses)} "
         f"(golden {int(g['n_nodes'])}), {len(merged.edges)} edges (golden "
         f"{int(g['n_edges'])}); TUM {tum.shape[0]} lines; kernel A at "
         f"{sorted(res['a_shapes'])}, F at (B, N) {sorted(res['f_shapes'])}; "
         f"merge CLI {res['secs']:.2f} s wall ({card})")
    if fails:
        raise AssertionError("merge-cli3: " + "; ".join(fails))


def drive_fleet(cfg, images, dev):
    """`MultiSequenceRunner(cfg, batch=BATCH, chunk=16)`, image ingest, over
    BATCH distinct sequences (`images` (BATCH, T, A, R)), twice. Returns
    each run's (trajectories, frame outputs) and wall seconds."""
    runs, secs = [], []
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        fleet = mesh.MultiSequenceRunner(cfg, batch=BATCH, chunk=16,
                                         device=dev)
        fleet.process(images)
        trajs = fleet.trajectories()
        secs.append(time.perf_counter() - t0)
        runs.append((trajs, fleet.frame_outputs()))
    return runs, secs


def phase_fleet(cfg, images, runs, secs, traj1, fused1, dev, card):
    """The `fleet` path's two runs (`drive_fleet` over `images`: SEQUENCE
    at the seeds FLEET_SEEDS, lane 0 SEQUENCE itself): lane 0 within TOL
    of the CFEAR-3 golden, every lane within TOL of its own single-sequence
    image-ingest run with identical keyframes (lane 0's is `traj1`,
    `fused1`; the others run here, after the path's launches are read),
    and two runs bit for bit."""
    (trajs, out), (again, _) = runs
    with np.load(GOLDEN) as z:
        g_traj, g_fused = z["poses"], z["fused"]
    _check_traj("fleet lane 0 vs JAX golden", trajs[0], g_traj, out.fused[0],
                g_fused)
    dev_lane = []
    for i in range(BATCH):
        if not out.success[i].all():
            raise AssertionError(f"fleet lane {i} has failed frames")
        if i == 0:
            single, fused = traj1, fused1
        else:
            runner = odometry.OdometryRunner(cfg, device=dev, chunk=16)
            runner.process(images[i])
            single, fused = runner.trajectory(), runner.frame_outputs().fused
        dev_lane.append(_check_traj(f"fleet lane {i} vs its single run",
                                    trajs[i], single, out.fused[i], fused))
    bitwise = np.array_equal(trajs, again)
    n = images.shape[0] * images.shape[1]
    _say(f"fleet x{BATCH}: largest |dpos| of each lane from its single run "
         f"(m): {[f'{d:.6f}' for d in dev_lane]}; {n / secs[0]:.2f} and "
         f"{n / secs[1]:.2f} frames/s per card over two runs (image ingest, "
         f"upload included; {card}); bit-identical across the runs: "
         f"{bitwise}")
    if not bitwise:
        raise AssertionError("fleet: two runs of the same frames differ")


def phase_segmented(cfg, images, gt, serial, dev, card):
    """`run_segmented` over SEQUENCE in SEGMENTS: finite, its ATE within
    0.3 m of the serial image-ingest run's and no seam step over 3 m (the
    bounds of `tests/test_segments.py:28-45`)."""
    _sync(dev)
    t0 = time.perf_counter()
    traj = segments.run_segmented(images, cfg, device=dev, **SEGMENTS)
    secs = time.perf_counter() - t0
    ate, ate_serial = (ate_rmse(t[:, :2], gt[:, :2]) for t in (traj, serial))
    step = float(np.linalg.norm(np.diff(traj[:, :2], axis=0), axis=1).max())
    _say(f"segmented {json.dumps(SEGMENTS)}: ATE {ate:.4f} m (serial "
         f"{ate_serial:.4f} m), largest step {step:.3f} m; {secs:.2f} s wall "
         f"({card})")
    if not np.isfinite(traj).all() or traj.shape != serial.shape:
        raise AssertionError("segmented: trajectory not finite or of the "
                             "wrong shape")
    if ate > ate_serial + 0.3 or step > 3.0:
        raise AssertionError("segmented: ATE more than 0.3 m over the serial "
                             "run's, or a seam step over 3 m")


def online_config():
    """The configuration the `online` path's daemon runs: the CFEAR-3
    Oxford preset unmodified, as `online_odometry.main` builds it."""
    return port.preset("CFEAR-3", dataset="oxford")


def drive_online(cfg, images, dev, tmp, seed=0):
    """The online daemon as users run it: a recorder thread appends
    `images` to a radar pack under `tmp` (stamps i * sensor period) in
    bursts of ONLINE_BURST frames, ONLINE_SLEEP_S apart, while
    `OnlineOdometry(..., device=dev, chunk=8)` with host ingest follows the
    pack until it has every frame. Returns (daemon, TUM path, append time
    of each frame, flush time of each frame's line, wall seconds of the
    daemon's run)."""
    import threading

    from cfear_radarodometry_code_public_tpu_torch import online_odometry
    pack, tum = os.path.join(tmp, "live.radarpack"), os.path.join(tmp,
                                                                  "poses.tum")
    n, period = images.shape[0], cfg.radar.sensor_period
    rng = np.random.default_rng(seed)
    appended = np.zeros(n)
    with open(pack, "wb") as f:       # header; the frame count stays 0
        f.write(np.array([online_odometry._MAGIC, 0, images.shape[1],
                          images.shape[2]], np.uint64).tobytes())

    def recorder():
        i = 0
        while i < n:
            hi = min(n, i + int(rng.integers(ONLINE_BURST[0],
                                             ONLINE_BURST[1] + 1)))
            for j in range(i, hi):
                with open(pack, "ab") as f:
                    f.write(np.uint64(round(j * period * 1e9)).tobytes())
                    f.write(np.ascontiguousarray(images[j]).tobytes())
                appended[j] = time.perf_counter()
            i = hi
            time.sleep(float(rng.uniform(*ONLINE_SLEEP_S)))

    daemon = online_odometry.OnlineOdometry(cfg, pack, tum, chunk=8,
                                            ingest="host", device=dev)
    flushed: list = []
    emit = daemon._emit

    def timed_emit(out_f):
        new = emit(out_f)
        flushed.extend([time.perf_counter()] * new)
        return new

    daemon._emit = timed_emit
    th = threading.Thread(target=recorder, daemon=True)
    t0 = time.perf_counter()
    th.start()
    processed = daemon.run(follow=True, idle_timeout_s=30.0, max_frames=n)
    wall = time.perf_counter() - t0
    th.join()
    if processed != n:
        raise AssertionError(f"online: {processed} of {n} frames processed")
    return daemon, tum, appended, np.asarray(flushed), wall


def phase_online(cfg, images, run, launches, dev, card):
    """The `online` path's checks, after its counts are read: one TUM line
    a frame, with monotone stamps; each line the daemon's pose as
    `_tum_line` prints it; the daemon's trajectory bit-identical to
    `OdometryRunner` over the same frames in one `process` call. Prints
    the lag from a frame's append to its flushed line, frames/s and the
    path's kernel A and F launches."""
    from cfear_radarodometry_code_public_tpu_torch import online_odometry
    daemon, tum, appended, flushed, wall = run
    n = images.shape[0]
    with open(tum) as f:
        lines = f.read().splitlines()
    traj = daemon.trajectory()
    stamps = np.array([float(ln.split()[0]) for ln in lines])
    if len(lines) != n or not (np.diff(stamps) > 0).all():
        raise AssertionError(f"online: {len(lines)} TUM lines for {n} "
                             "frames, or stamps not increasing")
    if lines != [online_odometry._tum_line(daemon.stamps[i], traj[i])
                 .rstrip("\n") for i in range(n)]:
        raise AssertionError("online: the streamed poses are not the "
                             "daemon's trajectory")
    runner = odometry.OdometryRunner(cfg, ingest="host", device=dev, chunk=8)
    runner.process(images)
    offline = runner.trajectory()
    same = bool(np.array_equal(traj, offline))
    lag = (flushed - appended) * 1e3
    _say(f"online: {n} frames followed in {wall:.2f} s -> {n / wall:.2f} "
         f"frames/s (the recorder's sleeps included); lag from append to "
         f"flushed line median {np.median(lag):.1f} ms, max "
         f"{lag.max():.1f} ms; launches kernel A {launches['nn_min']}, F "
         f"{launches['lm_solve_fused']} ({card})")
    _say(f"online: trajectory bit-identical to OdometryRunner over the same "
         f"frames in one call: {same} (max |delta| "
         f"{float(np.abs(traj - offline).max()):.2e})")
    if not same:
        raise AssertionError("online: the daemon's trajectory differs from "
                             "the offline runner's")


def _reset_launches() -> None:
    for mod in (cuda_assoc, cuda_lm, cuda_features):
        mod.reset_launches()


def _launches() -> dict:
    return {**cuda_assoc.launches, **cuda_lm.launches, **cuda_features.launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = _card()
    _say(card)
    _say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
         f"native host filter: {native_io.native_available()}")
    # wall seconds of each part of the run, printed before the kernels line
    took: dict = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        took[name] = took.get(name, 0.0) + time.perf_counter() - t0
        return result

    def render(cfg, sequence):
        images, gt = timed("render", lambda: synthetic.make_sequence(
            cfg=cfg, **sequence))
        _say(f"rendered {images.shape}; {took['render']:.1f} s of rendering "
             "so far")
        return images, gt

    kernels = timed("build + A, C", lambda: phase_kernels(dev, card))
    kernels.update(timed("F", lambda: phase_lm(dev, card)))

    cfg = slice_config()
    images, gt = render(cfg, SEQUENCE)
    kernels.update(timed("G", lambda: phase_moments(images, dev, card)))

    # the paths: each one's launches are counted from zero just before it
    paths: dict = {}

    def drive(name, needs, fn, never=()):
        _reset_launches()
        result = timed(name, fn)
        paths[name] = _launches()
        _say(f"launches in the {name} path: {paths[name]}")
        for k in needs:
            if paths[name][k] == 0:
                raise AssertionError(f"the {name} path never launched {k}")
        for k in never:
            if paths[name][k]:
                raise AssertionError(f"the {name} path launched {k}")
        return result

    traj, out, _ = drive(
        "single", ("nn_min_sparse", "lm_solve_fused"),
        lambda: phase_single(cfg, images, gt, dev, card, GOLDEN))
    drive("auto", ("nn_min", "lm_solve_fused"),
          lambda: phase_auto(images, traj, out, dev, card))
    runner_i = drive("image", ("nn_min_sparse", "lm_solve_fused"),
                     lambda: phase_image(cfg, images, traj, out, dev, card))
    traj_i, fused_i = runner_i.trajectory(), runner_i.frame_outputs().fused
    timed("image vs host", lambda: phase_ingest_rates(cfg, images, runner_i,
                                                      dev, card))
    drive("cli", ("nn_min", "lm_solve_fused"), lambda: phase_cli(dev, card))
    # the CLI beyond CFEAR-3 on synthetic input: dataset directories, the
    # paper's other presets, CA-CFAR; each path's inputs written first
    with tempfile.TemporaryDirectory() as tmp:
        for name in CLI_PATHS:
            root = os.path.join(tmp, name)
            written = timed("render", lambda: prepare_cli_path(name, root))
            if written is not None:
                timed("cli inputs", lambda: check_dataset_read(name, root,
                                                               written))
            if name == "cli-cacfar":
                timed("cli inputs", lambda: phase_cacfar_filter(dev, card))
            needs, never = cli_path_kernels(name)
            run = drive(name, needs, lambda: drive_cli_path(name, root, dev),
                        never)
            timed("cli checks", lambda: phase_cli_path(name, *run, dev, card))
            if CLI_PATHS[name].get("assoc") == "grid":
                timed("cli checks", lambda: phase_grid_tables(name, run[0],
                                                              dev, card))
                timed("cli checks", lambda: phase_grid_repeat(name, root,
                                                              run[0], card))
            del run
            shutil.rmtree(root)
    jobs_sw = drive("sweep", ("nn_min", "lm_solve_fused"),
                    lambda: drive_sweep(dev))
    timed("sweep checks", lambda: phase_sweep(*jobs_sw, card))
    drive("batched", ("nn_min_sparse", "lm_solve_fused"),
          lambda: phase_batched(cfg, images, traj, out, dev, card))
    drive("pallas-features",
          ("moment_accumulate", "nn_min_sparse", "lm_solve_fused"),
          lambda: phase_single(slice_config(feature_backend="pallas"), images,
                               gt, dev, card, GOLDEN_PALLAS,
                               "pallas-features", passes=1))
    # voxel overflow on kernel G's path: a larger point budget, the default
    # pre_cells; G held on the overflowing frames first
    over = overflow_config()
    images_o, gt_o = render(over, OVERFLOW_SEQUENCE)
    kernels["moment_accumulate"]["overflow"] = timed(
        "G", lambda: phase_overflow_moments(images_o, dev, card))
    drive("pallas-features-overflow",
          ("moment_accumulate", "nn_min_sparse", "lm_solve_fused"),
          lambda: phase_single(over, images_o, gt_o, dev, card,
                               GOLDEN_OVERFLOW, "pallas-features-overflow",
                               passes=1))
    del images_o
    # a parked sensor: one sweep repeated (kernel C at d2 = 0, F at zero
    # residual, held against their twins after the counts are read)
    images_st = timed("render", lambda: stationary_images(cfg))
    run_st = drive("stationary", ("nn_min_sparse", "lm_solve_fused"),
                   lambda: drive_recorded(cfg, images_st, dev, "host",
                                          ("nn_min_sparse", "lm_solve_fused")))
    degenerate = timed("degenerate checks",
                       lambda: phase_stationary(cfg, run_st, card))
    del images_st, run_st

    s50 = s50_config()
    images50, gt50 = render(s50, S50_SEQUENCE)
    traj50, out50, state50 = drive(
        "s50", ("nn_min_sparse", "lm_solve_fused"),
        lambda: phase_single(s50, images50, gt50, dev, card, GOLDEN_S50,
                             "s50", S50_TOL, full_window=True))
    traj16, _, _ = drive(
        "s50-k16", ("nn_min_sparse", "lm_solve_fused"),
        lambda: phase_single(s50_config(16), images50, gt50, dev, card,
                             GOLDEN_S50_K16, "s50-k16", S50_TOL,
                             full_window=True, passes=1))
    for name, t, golden in (("s50", traj50, GOLDEN_S50),
                            ("s50-k16", traj16, GOLDEN_S50_K16)):
        phase_s50_drift(name, t, golden, card)
    drive("s50-batched", ("nn_min_sparse", "lm_solve_fused"),
          lambda: phase_batched(s50, images50, traj50, out50, dev, card,
                                tol=S50_TOL))
    preset, state_p = drive("s50-preset", ("nn_min_sparse", "lm_solve_fused"),
                            lambda: phase_s50_preset(images50, gt50, dev, card))
    # kernel C at the preset's shapes (B=1, S=50, Msrc=M=3072) against its
    # twin on the window that path ends with, and D1, D2, E beside it; C's,
    # D1's and D2's records on the real windows join their entries on the
    # kernels line
    def keep_windows(recs, label):
        for k in ("nn_min_sparse", *D_FUNCTIONS):
            kernels[k].setdefault("windows", {})[label] = recs[k]

    win_p = window_inputs(state_p, preset, dev, "s50-preset window", (1,))
    keep_windows(timed("window checks", lambda: phase_window(
        win_p, drive_window(win_p), preset.registration.assoc_radius, card,
        "s50-preset window"))[1], "s50-preset window B=1")
    # D1, D2 and E on the window the s50 path ends with: the counted run is
    # one call of each; the checks against C and the twins, and the
    # timings, come after the counts are read
    win = window_inputs(state50, s50, dev)
    outs = drive("s50-window", ("nn_min_sparse", "nn_min_sparse_multi",
                                "nn_min_sparse_unrolled",
                                "nn_min_sparse_attrs"),
                 lambda: drive_window(win))
    # the kernels line keeps the s50 window's B=8 times of D1, D2 and E
    recs = timed("window checks", lambda: phase_window(
        win, outs, s50.registration.assoc_radius, card))
    for b, rec in recs.items():
        keep_windows(rec, f"s50 window B={b}")
    for k, rec in recs[BATCH].items():
        if k != "nn_min_sparse":
            kernels.setdefault(k, {}).update(rec)

    # the long-run path (`tools/run_longrun.py`, cut to 256 frames)
    lr = longrun_config()
    images_lr, gt_lr = render(lr, LONGRUN_SEQUENCE)
    runner_lr, traj_lr, out_lr = drive(
        "longrun", ("nn_min", "lm_solve_fused"),
        lambda: phase_longrun("longrun", lr, images_lr, gt_lr,
                              LONGRUN_SEQUENCE, dev, card))
    drive("longrun-resume", ("nn_min", "lm_solve_fused"),
          lambda: phase_resume(lr, images_lr, traj_lr, out_lr, dev, card))
    drive("longrun-cov", ("nn_min", "lm_solve_fused"),
          lambda: phase_cov(lr.replace(odometry=dataclasses.replace(
              lr.odometry, estimate_cov_by_sampling=True)), images_lr,
              traj_lr, out_lr, dev, card))
    # B1 and B2 on the window the longrun path ends with: the counted run is
    # one call of each per problem; checks and timings come after the read
    win_lr = longrun_window(runner_lr.state, lr, dev)
    outs_lr = drive("longrun-window", ("nn_min_multi", "nn_min_multi_unrolled"),
                    lambda: drive_longrun_window(win_lr))
    for k, rec in timed("window checks", lambda: phase_longrun_window(
            win_lr, outs_lr, card)).items():
        kernels[k].update(rec)
    del images_lr
    images_a, gt_a = render(lr, LONGRUN_ADV8_SEQUENCE)
    drive("longrun-adv8", ("nn_min", "lm_solve_fused"),
          lambda: phase_longrun("longrun-adv8", lr, images_a, gt_a,
                                LONGRUN_ADV8_SEQUENCE, dev, card))
    del images_a
    images_a, gt_a = render(lr, LONGRUN_ADV12_SEQUENCE)
    drive("longrun-adv12", ("nn_min", "lm_solve_fused"),
          lambda: phase_longrun("longrun-adv12", lr, images_a, gt_a,
                                LONGRUN_ADV12_SEQUENCE, dev, card,
                                tol=LONGRUN_ADV12_TOL,
                                health_tol=HEALTH_ADV12_TOL))
    del images_a
    # a blind sensor: the long run's world, all-zero sweeps from BLIND_FROM
    # (kernel A without a valid target or source cell, F with no weight,
    # held against their twins after the counts are read)
    blind = blind_config()
    images_bl, gt_bl = timed("render", lambda: blind_images(blind))
    run_bl = drive("longrun-blind", ("nn_min", "lm_solve_fused"),
                   lambda: drive_recorded(blind, images_bl, dev, "image",
                                          ("nn_min", "lm_solve_fused")))
    timed("degenerate checks", lambda: phase_blind(blind, run_bl, gt_bl,
                                                   card))
    degenerate.update(timed("degenerate checks",
                            lambda: phase_blind_kernels(run_bl, card)))
    del images_bl, run_bl
    for k, prefix in (("nn_min", "A "), ("nn_min_sparse", "C "),
                      ("lm_solve_fused", "F ")):
        kernels[k]["degenerate"] = {n[2:]: r for n, r in degenerate.items()
                                    if n.startswith(prefix)}

    # the SLAM pass (`tools/run_slam_scale_torch.py`, cut to 2 laps of 256)
    slam = slam_config()
    images_s, gt_s = timed("render", lambda: slam_scale.make_lap_sequence(
        slam, **SLAM_SEQUENCE))
    _say(f"rendered {images_s.shape}; {took['render']:.1f} s of rendering "
         "so far")
    res = drive("slam", ("nn_min", "lm_solve_fused"),
                lambda: drive_slam(slam, images_s, dev))
    timed("slam checks", lambda: phase_slam(slam, res, gt_s, dev, card))
    del images_s

    # the multi-session merge: the slam path's map and a new drive
    seq = SLAM_SEQUENCE
    images_b, gt_b = timed("render", lambda: slam_scale.make_route_slice(
        slam, lap_frames=seq["lap_frames"], speed=seq["speed"],
        extent=seq["extent"], **MERGE_SEQUENCE))
    merged = drive("merge", ("nn_min", "lm_solve_fused"),
                   lambda: drive_merge(slam, res["gb"], images_b, dev))
    timed("merge checks", lambda: phase_merge(slam, merged, gt_b, card))
    del images_b
    drive("merge-mesh", ("nn_min", "lm_solve_fused"),
          lambda: phase_merge_mesh(slam, res["gb"], merged, dev, card))
    # the merge CLI over three sessions: the slam path's map, the merge
    # path's session B and a third drive, C
    images_c, gt_c = timed("render", lambda: slam_scale.make_route_slice(
        slam, lap_frames=seq["lap_frames"], speed=seq["speed"],
        extent=seq["extent"], **MERGE3_SEQUENCE))
    with tempfile.TemporaryDirectory() as tmp:
        merged3 = drive("merge-cli3", ("nn_min", "lm_solve_fused"),
                        lambda: drive_merge3(slam, res["gb"], merged["gb_b"],
                                             images_c, dev, tmp))
    timed("merge checks", lambda: phase_merge3(
        slam, merged3, merged["out"].fused, gt_b, gt_c, card))
    del res, merged, merged3, images_c
    # the SLAM pass again, its sweeps rendered with azimuth dropout
    images_s, gt_s = timed("render", lambda: slam_scale.make_lap_sequence(
        slam, **SLAM_DROPOUT_SEQUENCE))
    res_d = drive("slam-dropout", ("nn_min", "lm_solve_fused"),
                  lambda: drive_slam(slam, images_s, dev))
    timed("slam checks", lambda: phase_slam(
        slam, res_d, gt_s, dev, card, "slam-dropout", GOLDEN_SLAM_DROPOUT,
        SLAM_DROPOUT_SEQUENCE, images_s))
    del images_s, res_d
    # the joint refinement of all scan poses (no kernel, as in the
    # reference): the reference's cells and perturbed poses from its golden
    run_r = drive("refine", (), lambda: drive_refine(dev), never=tuple(KERNELS))
    timed("refine checks", lambda: phase_refine(run_r, card))
    del run_r
    # the sequence fleet and the segment runner on the slice
    fleet = timed("render", lambda: np.stack([images] + [
        synthetic.make_sequence(cfg=cfg, **{**SEQUENCE, "seed": s})[0]
        for s in FLEET_SEEDS[1:]]))
    runs, secs = drive("fleet", ("nn_min_sparse", "lm_solve_fused"),
                       lambda: drive_fleet(cfg, fleet, dev))
    timed("fleet checks", lambda: phase_fleet(cfg, fleet, runs, secs, traj_i,
                                              fused_i, dev, card))
    del fleet, runs
    drive("segmented", ("nn_min_sparse", "lm_solve_fused"),
          lambda: phase_segmented(cfg, images, gt, traj_i, dev, card))
    # the online daemon following a growing pack of the CFEAR-3 sequence
    online = online_config()
    with tempfile.TemporaryDirectory() as tmp:
        run = drive("online", ("nn_min", "lm_solve_fused"),
                    lambda: drive_online(online, images, dev, tmp))
        timed("online checks", lambda: phase_online(
            online, images, run, paths["online"], dev, card))
    launches = {k: sum(p[k] for p in paths.values()) for k in KERNELS}
    _say(f"kernel launches in the main-path runs: {launches}")
    _say("wall seconds by part: " + json.dumps(
        {k: round(v, 1) for k, v in took.items()})
        + f"; {sum(took.values()):.1f} s in all ({card})")
    _say(f"timed at the host's pace (calls that outlasted the spin): "
         f"{host_paced}")

    csrc = os.path.relpath(os.path.dirname(_build.SOURCES[0]), ROOT)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"{csrc}/{src}",
         "replaces": tpu, "launches": launches[name], **kernels[name]}
        for name, (tpu, src) in KERNELS.items()],
        "host_paced": host_paced}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
