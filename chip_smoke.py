#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build the band and windowed conv
kernels and the probe kernels, check them, serve ScanNet-scale scenes,
train SpUNet-v1m1 at ScanNet's batch, pretrain PonderIndoor-v2 at bench.py's
workload, run every probe kernel at its probe's shape, train and serve the
PPT fine-tune recipe from scene files, run the paper's multi-dataset
pretrain from RGB-D scene files, train and evaluate its instance
segmentation recipe from scene files with instance labels, run its
outdoor half: the nuScenes LiDAR pretrain from procedural scans and the
nuScenes lidarseg fine-tune from that checkpoint, train, test and serve
MinkUNet34C on ScanNet scenes, train, test and profile the SpUNet
classifier, run the modules no recipe names and data parallelism, and run
the pretrain step on host-built plans and two training steps on the
windowed gather route (K4 / K5).

    python3 chip_smoke.py [--parent-log LOG]

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and the
repo around it, and runs in phases; any failure exits non-zero:

1. print the card's name and power limit; refuse to run without CUDA;
2. build every kernel with nvcc, one process per source in parallel: K1
   (``ponderv2_tpu_torch/csrc/band_conv.cu``), K2 and K3
   (``csrc/band_conv_bwd.cu``; K1-K5, P5 ``kd`` and P7 V2-V4 on the
   tensor-core tiles of ``csrc/mma_tile.cuh``), K4, K5 and the P7
   ablations' forward on K4's kernel (``csrc/windowed_gather.cu``), the row
   gather-sum (``csrc/row_gather.cu``) and the window-read and
   grouped-construct kernels (``csrc/probe_kernels.cu``); print ptxas
   registers and spills;
3. compare K1 with its plain PyTorch version on the card at every distinct
   (level, Cin, Cout) band conv of the serving slice, at the level row
   counts of a real fragment, in f32 (TF32 off) and bf16, plus a
   window-overflow case and a zero-gated (``pair_budget=0``) case, and time
   both; print each conv's live entries and the rows the compacted and the
   slab tile multiply (K1 runs the first in f32 and the second in bf16, K2's
   dx the second), counted from the plan;
4. serve ``configs/_test_/semseg_spunet_scannet_synthetic.py`` through
   ``tools/test_torch.py:main_worker`` with seeded random weights: 2 scenes x
   4 rotations x (6 or 9) fragments = 60 forwards of 78-85k voxels at full
   width; check K1's launch count, every ``contract_ok`` and the logits;
5. run one fragment again with K1 replaced by its plain version and compare
   the logits;
6. train ``configs/_test_/semseg_spunet_scannet_synthetic_train.py`` (the
   backbone's ``remat`` off) through ``tools/train_torch.py:main_worker``:
   3 steps of 12 scenes
   (1,572,864-row budget) at full width and depth, then one SemSegEvaluator
   pass; check every step's loss, ``contract_ok``, lr and K1/K2/K3 launch
   counts against the routing, and that the checkpoint loads;
7. compare K1, K2 and K3 with their plain versions at every distinct
   (level, Cin, Cout) band conv of that training batch, in f32 and bf16,
   time each in f32 where the step runs it (with the rows K1 and K2's dx
   multiply), and run the backward through
   the autograd wrapper with window overflow and with ``pair_budget=0``;
8. run one step's forward and backward from the saved state twice with
   the kernels, then twice with all three replaced by their plain versions
   (and once more with the plain versions summing in another order: taps
   reversed, dW rows in two halves); require equal bits between the two
   runs of each path (loss and every gradient), and hold the kernel path's
   loss and gradients to the plain path's (each gradient within 1e-3 of its
   max|ref| plus 3x its difference between the plain and the reordered
   plain run);
9. pretrain ``configs/_test_/pretrain_bench_torch.py`` (bench.py's
   workload: PonderIndoor-v2 with SpUNet-v1m1, UNet3D-v1m2 and NeuS at full
   width, bf16, batch 2 of 100k-point RGB-D scenes, the conv plans built on
   the host a batch ahead, as ``host_plans`` asks) through
   ``tools/train_torch.py:main_worker`` for 3 steps; check every step's
   loss, ``contract_ok``, lr and K1/K2/K3 launches against the routing;
10. compare K1, K2 and K3 with their plain versions at every distinct
    (level, Cin, Cout) band conv of that pretrain batch, in f32 and bf16,
    and time each in bf16 (the step's dtype) where the step runs it (with
    the rows K1 and K2's dx multiply);
11. run one pretrain step's forward and backward from the seeded state
    (the same random draws each time) as in 8: equal bits run to run on
    each path, and kernel vs plain within 3e-2 (the bf16 bound of
    bench.py:227) of max|ref| plus 3x the reordered plain run's difference;
12. run the windowed conv entry point
    (``tools/experiments/probe_windowed_torch.py:windowed_conv``, K4 and
    K5) in bf16 at the probe's four shapes and on two rulebooks of the
    pretrain batch (the k5 stem's, 6->32, and L0's k3 at 32->32), count
    its launches, compare each kernel with its plain version in f32 and
    bf16, require equal bits from a second launch in each dtype, time both
    (and the kernels in f32), and report the share of covered windows, the
    tile each kernel ran and the rows it multiplies against the live
    entries (counted from the geometry); with ``--parent-log`` (a log of
    another tree's run) each conv's bf16 times beside that tree's;
13. run every ported probe function (P1-P5, P7 V2-V5; PERF.md's kernel
    table) through its entry point (``tools/experiments/
    probe_{gather,bisect,windowed}_torch.py``) at its probe's shape and on
    its inputs, with the counts set to 0 before each and read after: its
    kernel launched once and no other; hold each against its plain version
    on the card (equal, or within 1e-5 of max|ref| where the products are
    summed in another order: P3 ``k2`` through K4, P5 ``kd``, P7 V2-V4) and
    time kernel, plain version and library call on the device (replayed
    from a CUDA graph, the L2 flushed before each call; the kernel with it
    warm too) and per call issued from Python, and beside the window copies
    (P3 ``k0``, P4 A-D), which no single call computes, a slice's ``copy_``
    into the same output as a floor (beside P5 ``kb`` and ``ka`` a ``copy_``
    of their input into their output); first an empty kernel
    (``csrc/row_gather.cu`` built with its vector path emptied, at P1's launch),
    the launch floor printed in the phase's first line and beside each
    probe's bound, then one at P5 ``ka``'s grid (``csrc/probe_kernels.cu``
    with ``slab_slots`` emptied), printed beside ``ka`` in P1's place; for
    P7 V2-V4 (K4's slab
    tile) print the rows multiplied against the live entries; with
    ``--parent-log`` each kernel's time beside that tree's;
14. write 36 + 1 of SyntheticDataset's 100k-point scenes into a
    temporary data root in ScanNet's processed layout and run the paper's
    fine-tune recipe (``configs/scannet/semseg-ppt-v1m1-0-sc-s3-st-spunet-
    lovasz-ft.py``: PPT-v1m1 over SpUNet-v1m3 with PDNorm, ScanNetDataset,
    batch 12) on them, changing only its data roots, epochs (3 steps and
    one evaluation), weight and save path: train through
    ``tools/train_torch.py:main_worker`` and check every step's loss,
    ``contract_ok``, lr and K1/K2/K3 launches against the routing, that
    every forward got condition "ScanNet" and only its norms' (``bns.1``)
    running statistics moved, and that the checkpoint loads; compare K1-K3
    with their plain versions at the batch's convs as in 7, and hold one
    step's grads from the trained state as in 8, with float64 as the
    reference: every K1-K3 call of the step against float64 on its own
    inputs (within 3 x 2^-22 of its sum of |products|, the tiles' stated
    f32 accuracy), rho the largest ratio of a call's kernel error to its
    plain f32 error, and each gradient of the kernel path within 1e-3 of
    max|ref| plus 3 rho x the plain path's difference from the same step
    in float64, of the plain path and of float64 alike; then serve the val
    scene (4 rotations)
    through ``tools/test_torch.py:main_worker`` with the trained weights:
    K1's launches, every ``contract_ok``, a fragment's logits;
15. write SyntheticRGBDDataset's 100k-point scenes, each with 6 views of
    480 x 640 from its z-buffer, in the Structured3D (16 rooms), ScanNet (8
    scenes) and S3DIS (8 rooms) RGB-D layouts and units, and run the
    paper's multi-dataset pretrain (``configs/scannet/pretrain-ponder-ppt-
    v1m1-0-sc-s3-st-spunet.py``: PonderIndoor-v2 over SpUNet-v1m1 with
    three conditions, MultiDatasetTrainer, batch 8, f32) on them, changing
    only its data roots, epochs (one round: 4 steps), save path and, on a
    host with fewer than 72 CPUs, ``num_worker`` (the backbone's ``remat``
    is on, its default: the step does not fit in 80 GB without it, and the
    backward runs each band conv's K1 again): check the 4 steps and
    ``len(train_loader)``, the conditions that reached the model in order
    (Structured3D, Structured3D, ScanNet, S3DIS) and the class subset each
    used, the lr against OneCycle over 4 steps, every loss term and
    ``contract_ok``, and K1/K2/K3 launches against each batch's routing;
    compare K1-K3 with their plain versions at the first batch's convs as
    in 7, hold every K1-K3 call of a step against float64 as in 14, and
    one step's grads from the seeded state as in 8 (if that bound fails,
    as in 14);
16. write 36 + 4 of SyntheticDataset's 100k-point scenes in ScanNet's
    layout, each box an instance (``scene_instance_ids``), and run the
    paper's instance-segmentation recipe (``configs/scannet/insseg-ppt-v1m1-
    0-pointgroup-spunet-ft.py``: PG-v1m1 over PPT-v1m1 in backbone_mode over
    SpUNet-v1m3, batch 12, f32) on them, changing only its data roots,
    epochs (3 steps and one evaluation), weight and save path: train through
    ``tools/train_torch.py:main_worker`` with the checks of 14 and each
    step's time, data wait, peak memory, live rows and loss terms; the
    recipe's ``InsSegEvaluator`` over the 4 val scenes (each scene's
    forward, host clustering, proposals and AP times; its mAP re-scored from
    its own proposals; the native clustering's calls); the ground truth as
    predictions (the neighbour cap with the full offset, mAP50 1.0 with half
    of it); the native clustering against its plain version; K1-K3 against
    their plain versions at the first batch's convs as in 7, and the seeded
    first batch's grads as in 15;
17. write 12 + 4 procedural nuScenes LiDAR scans (32 beams, six 1600 x
    900 PNG cameras each, ``datasets/preprocessing/synthetic_nuscenes.py``)
    and run the paper's outdoor pretrain
    (``configs/nuscenes/pretrain-ponder-spunet-v1m1-0-base.py``:
    PonderOutdoor-v2 over SpUNet-v1m1 with ``in_channels`` 4, SimpleConv3D
    onto 180 x 180 x 5, NeuS on 512 rays a scan, batch 4, f32) on the 12,
    changing only its data root, epochs (3 steps), save path and
    ``num_worker``: the checks of 14 and each step's time, data wait, peak
    memory, live rows and loss terms; each level's plan (rulebook or
    SubmPlan against the 192 Mi dense-grid limit at ``sparse_shape`` (1440,
    1440, 108)), its convs' routes and the final band budgets; the plain
    gather convs' forward + backward time; K1-K3 against their plain
    versions at the first batch's convs as in 7; every K1-K3 call of a step
    against float64 and the seeded step's grads as in 15; then one step of
    each of ``-base-color``, ``-base-color-amp`` (its ``RandomShift`` and
    camera ``RandomFlip``) and ``-base-semantic`` (the committed stub CLIP
    embeddings) on the other 4 scans;
18. write 36 + 2 scans without cameras and run the paper's nuScenes
    lidarseg fine-tune (``configs/nuscenes/semseg-ppt-v1m1-0-nu-sk-wa-spunet-
    ft.py``: DefaultSegmentor over SpUNet-v1m1, CE + Lovasz, Mix3D 0.8,
    batch 12, f32) from 17's checkpoint as its ``weight``, changing only
    its data roots, epochs (3 steps and one evaluation), weight, save path
    and ``num_worker``: the checkpoint's ``backbone.*`` loaded and nothing
    else, the checks of 17, the val scans served through ``SemSegTester``
    (K1's launches, every ``contract_ok``, a time per fragment), K1-K3 as
    in 7 and one step's grads from the trained state as in 14;
19. write 36 + 1 scenes in ScanNet's layout and train MinkUNet34C on them
    (``MINK_CONFIG``, the ScanNet SpUNet recipe with its backbone
    MinkUNet34C, ``in_channels`` 6 from color + normal, as Pointcept's
    ``semseg-minkunet34c-0-base.py``; batch 12, f32, the backbone's
    ``remat`` on, its default): 3 steps with ``SemSegEvaluator`` and the
    checks of 14, the routing traced from the model's convs and held to
    the 36 band convs its config gives (``MINK_BAND_CONVS_PER_FORWARD``:
    K1-K3), then ``PreciseEvaluator`` (its K1 launches counted apart):
    ``SemSegTester`` with ``model_best.pth`` and ``submit`` over the val
    scene, its ``submit/{name}.txt`` one of ScanNet's class ids a point;
    ``PartSegTester`` once over it; K1-K3 against their plain
    versions at the first batch's convs as in 7; the seeded step's grads as
    in 15;
20. train the SpUNet classifier (``CLS_RECIPE``: DefaultClassifier over
    SpUNet-v1m1 in ``cls_mode`` at its published widths, 40 classes, batch
    32, Pointcept's ``cls-spunet-v1m1-0-base.py``) on synthetic objects of
    10,000 points (``register_object_dataset``): 3 steps with
    ``ClsEvaluator`` and the checks of 14, ``ClsTester`` over 8 objects,
    ``RuntimeProfiler`` over 1 + 2 more steps (its ``SystemExit(0)`` caught
    and its code checked; its Chrome trace must name K1's kernel), K1-K3
    against their plain versions as in 7 and the seeded step's grads as in
    15;
21. the modules no recipe names, on the card: (a) the ScanNet SpUNet
    recipe (``ORIGIN_CONFIG``) on 12 + 2 scene files in phase 14's layout
    with ``cache=True`` and ``DataCacheOperator``, its val pipeline with
    ``Copy`` (coord -> origin_coord, segment -> origin_segment) before
    ``GridSample`` and ``Collect`` keeping both: one step at batch 12 with
    the checks of 14, then ``SemSegEvaluator`` projecting each val voxel's
    prediction onto the scene's original points (``pointops.knn_query`` on
    the card). Checked: the cached scenes equal their files, each voxel row
    is one of its scene's original points (one frame), the projection
    equals an exact float64 nearest-neighbour search on the host
    (``scipy.spatial.cKDTree``) wherever the two nearest squared distances
    differ by more than ``NEAR_TIE`` of their terms (near-ties counted),
    the stored ``val/mIoU`` equals one computed on the host from the
    projected labels, and no segment of the run is left in /dev/shm;
    (b) ``pointops`` at scene size (a val scene's 100k points against its
    ~85k voxels): ``knn_query`` (k 1 and 16), ``ball_query``,
    ``farthest_point_sampling`` (4096 of 100k), ``interpolation``,
    ``grouping`` with its backward and the two attention steps, each
    against float64 on the host, ms a call printed as ``[pointops]`` lines
    (plain PyTorch: no kernel row); (c) the VolSDF pretrain: 9's config
    with ``VolSDFModel`` and ``ErrorBoundedSampler`` at its defaults, 3
    steps (each step's K1-K3 launches 9's routing, ``contract_ok``, finite
    losses), one step's grads kernel vs plain at 11's bound with the same
    draws, then one step of ``NeuSModel`` with ``UniSurfSampler``;
22. data parallelism (``parallel/mesh.py``, ``engines/launch.py``): (a) in
    this process, a process group of one over NCCL: one step of the
    ScanNet SpUNet-v1m1 recipe (``DP_CONFIG``, batch 12, on phase 14's
    scene files) through the trainer's data-parallel branch (DDP) equals
    the single-process step bit for bit (loss, every grad, parameters,
    running statistics), and one NCCL allreduce of the grads' volume timed
    under ``torch.profiler``; then ``launch`` spawns two ranks sharing
    the card over gloo, each running (b) the same recipe at its global
    batch of 12, 6 a rank, 3 steps and one more with SyncBN: every step's
    K1-K3 launches as the rank's own batch routes them, ``contract_ok``
    the ranks' minimum and the two replicas equal bit for bit; the first
    step's grads against the mean of both shards' grads computed in rank
    0's process and the running statistics against the mean of both
    shards' moves; in the SyncBN step each BN's statistics against one
    forward over both shards' valid rows; the DP step's grads kernel vs
    plain with the relus pinned, each within phase 7's 1e-4 of its
    max|ref|, and one gloo allreduce of the grads' volume timed under
    ``torch.profiler``; and (c) two steps of
    ``configs/_test_/pretrain_bench_torch.py`` (bf16, one scene a rank,
    the eikonal double backward under DDP): the ranks' ray draws differ,
    rank 0's are one process's, the replicas stay equal; per rank the
    step ms, peak memory and launches, and the phase's wall time;
23. the two JAX paths ported last: (a) the host plan prefetch on the
    main path: 9's config for 3 steps through the ``Trainer`` with
    ``host_plans`` on (each next batch's conv plans built on the CPU by
    ``engines/plan_prefetch.py``'s thread) and off (built inside the step):
    every leaf of each batch's host-built plans integer-equal to the
    in-step build on the card, the loss, every grad and every parameter
    bit-equal after each step, no plan built inside a step with it on,
    K1-K3 at 9's routing; both runs' step and data-wait ms, the host build's
    ms a batch, the plans' MiB and copy ms, and the in-step build's ms and
    host syncs; (b) the windowed gather conv route on K4 / K5
    (``PONDER_WINDOWED_GATHER`` set inside the phase): one step of 19's
    MinkUNet34C and one of 18's nuScenes fine-tune from the seeded state
    against the same step without the switch, relus pinned, on each
    recipe's first 12 scenes collated without Mix3D (loss and grads within
    1e-4 of max|ref| plus 3x the plain step's own reordered difference, as
    in 8) and, for MinkUNet34C, on the run's own first batch (Mix3D: its
    duplicate voxels part the windowed dW from the mirrored backward's by
    design, so its differences are printed); every K4 / K5 call against
    its plain version on its own inputs, K4 / K5 launched in each step; the
    convs by route, each windowed conv's share of entries inside their
    windows, and the windowed convs' ms against the plain gather convs' on
    the same inputs;
24. print times and peak memory, a JSON line of the kernels, and last
    ``{"ok": true, "device": {...}}``.
"""

import argparse
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs/_test_/semseg_spunet_scannet_synthetic.py")
TRAIN_CONFIG = os.path.join(ROOT, "configs/_test_/semseg_spunet_scannet_synthetic_train.py")
PRETRAIN_CONFIG = os.path.join(ROOT, "configs/_test_/pretrain_bench_torch.py")
# the paper's fine-tune recipe (PPT-v1m1 over SpUNet-v1m3), run on 36 + 1
# scenes written in ScanNet's layout; its Add transform sets the condition
PPT_CONFIG = os.path.join(ROOT, "configs/scannet/semseg-ppt-v1m1-0-sc-s3-st-spunet-lovasz-ft.py")
PPT_TRAIN_SCENES = 36
PPT_CONDITION = "ScanNet"
# the paper's multi-dataset pretrain (PonderIndoor-v2 over SpUNet-v1m1 with
# three conditions, MultiDatasetTrainer), run on scenes written in the
# Structured3D, ScanNet and S3DIS RGB-D layouts: Structured3D's 16 rooms give
# its 2 batches of 8, ScanNet's and S3DIS's 8 one each, so one epoch is one
# round of the config's ratios 2 / 1 / 1
MULTI_CONFIG = os.path.join(ROOT, "configs/scannet/pretrain-ponder-ppt-v1m1-0-sc-s3-st-spunet.py")
MULTI_SCENES = {"Structured3D": 16, "ScanNet": 8, "S3DIS": 8}
MULTI_ORDER = ["Structured3D", "Structured3D", "ScanNet", "S3DIS"]
MULTI_VIEWS = 6  # per room; the config picks 5
MULTI_VIEW_HW = (480, 640)
S3DIS_TRAIN_AREAS = ("Area_1", "Area_2", "Area_3", "Area_4", "Area_6")
# the paper's ScanNet instance-segmentation recipe (PG-v1m1 over PPT-v1m1 in
# backbone_mode over SpUNet-v1m3), run on 36 + 4 scenes written in ScanNet's
# layout with one instance per box
INSSEG_CONFIG = os.path.join(ROOT, "configs/scannet/insseg-ppt-v1m1-0-pointgroup-spunet-ft.py")
INSSEG_TRAIN_SCENES, INSSEG_VAL_SCENES = 36, 4
INSSEG_TERMS = ("seg_loss", "bias_l1_loss", "bias_cosine_loss")
# the plain (numpy) clustering runs on the trained model's val scene only
# below this many neighbour pairs (its Python BFS visits each)
INSSEG_PLAIN_PAIRS = 5_000_000
# the paper's outdoor half: the nuScenes LiDAR pretrain (PonderOutdoor-v2
# over SpUNet-v1m1; 12 procedural scans give the base config 3 batches of 4,
# 4 more one batch of each other config) and the lidarseg fine-tune from its
# checkpoint (36 scans, 3 batches of 12; 2 val scans)
NUSCENES_PRETRAIN = {name: os.path.join(
    ROOT, f"configs/nuscenes/pretrain-ponder-spunet-v1m1-0-{name}.py")
    for name in ("base", "base-color", "base-color-amp", "base-semantic")}
NUSCENES_SEMSEG = os.path.join(ROOT, "configs/nuscenes/semseg-ppt-v1m1-0-nu-sk-wa-spunet-ft.py")
NUSCENES_PRETRAIN_SCANS, NUSCENES_ONE_STEP_SCANS = 12, 4
NUSCENES_SEMSEG_SCANS, NUSCENES_VAL_SCANS = 36, 2
# MinkUNet34C on ScanNet: the SpUNet recipe with its backbone replaced and
# its features color + normal (in_channels 6), as Pointcept's
# configs/scannet/semseg-minkunet34c-0-base.py has them; 36 + 1 scenes
# written in ScanNet's layout (one val scene: its precise test serves 30
# fragments)
MINK_CONFIG = os.path.join(ROOT, "configs/scannet/semseg-spunet-v1m1-0-base.py")
MINK_TRAIN_SCENES, MINK_VAL_SCENES = 36, 1
# band convs per forward of MinkUNet34C, from its config by the routing rule
# (mink_unet.py, layers.py:subm_route): a level whose blocks are wider than
# 64 channels carries a band plan, and every block conv on it runs band.
# Encoder L3 (128) 4 blocks and L4 (256) 6 blocks -> 8 + 12 convs; the four
# decoder stages (256, 128, 96, 96 at L3..L0) 2 blocks each -> 16. L1 (32)
# and L2 (64) encoder blocks, the stem, strided/inverse convs and head are
# not band.
MINK_BAND_CONVS_PER_FORWARD = 36
# the SpUNet classifier: Pointcept's configs/modelnet40/cls-spunet-v1m1-0-base.py
# (DefaultClassifier over SpUNet-v1m1 in cls_mode at its published widths,
# 40 classes, batch 32), on synthetic objects of ModelNet40's 10,000
# resampled points: 3 batches to train on, 8 objects to evaluate and test
CLS_TRAIN_OBJECTS, CLS_VAL_OBJECTS, CLS_POINTS, CLS_CLASSES = 96, 8, 10_000, 40
# band convs per forward of its encoder: every level L1-L4 carries an
# attached band plan (plans.py:build_spunet_plans, band-eligible at every
# width) and runs 2, 3, 4, 6 blocks of 2 convs -> 30; no decoder
CLS_BAND_CONVS_PER_FORWARD = 30
CLS_RECIPE = """\
_base_ = [{runtime!r}]
num_classes = {classes}
batch_size = 32
batch_size_val = 8
num_worker = 8
epoch = 1
eval_epoch = 1
point_budget = 32 * {points}
point_budget_val = 8 * {points}
sparse_shape = (320, 320, 320)  # unit-sphere objects scaled up to 1.5 at 1 cm
model = dict(
    type="DefaultClassifier", num_classes=num_classes, backbone_embed_dim=256,
    backbone=dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, cls_mode=True,
                  channels=(32, 64, 128, 256, 256, 128, 96, 96),
                  layers=(2, 3, 4, 6, 2, 2, 2, 2)),
    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])
optimizer = dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=1e-4, nesterov=True)
scheduler = dict(type="MultiStepLR", base_lr=0.1, milestones=[0.6, 0.8], gamma=0.1)
_eval = [dict(type="GridSample", grid_size=0.01, hash_type="fnv", mode="train",
              keys=("coord", "normal"), return_grid_coord=True),
         dict(type="Collect", keys=("coord", "grid_coord", "category"),
              feat_keys=("coord", "normal"))]
_train = [dict(type="RandomScale", scale=[0.7, 1.5], anisotropic=True),
          dict(type="RandomShift", shift=[(-0.2, 0.2), (-0.2, 0.2), (-0.2, 0.2)]),
          _eval[0], dict(type="ShufflePoint"), _eval[1]]
data = dict(
    num_classes=num_classes,
    train=dict(type="SyntheticObjectDataset", num_objects={train}, points={points},
               num_classes=num_classes, transform=_train, seed=0),
    val=dict(type="SyntheticObjectDataset", num_objects={val}, points={points},
             num_classes=num_classes, transform=_eval, seed=1000),
    test=dict(type="SyntheticObjectDataset", num_objects={val}, points={points},
              num_classes=num_classes, transform=_eval, seed=1000))
hooks = [dict(type="CheckpointLoader"), dict(type="IterationTimer", warmup_iter=2),
         dict(type="InformationWriter"), dict(type="ClsEvaluator"),
         dict(type="CheckpointSaver", save_freq=None)]
test = dict(type="ClsTester")
"""
# phase 21: segmentation evaluated on the original points (the ScanNet
# SpUNet recipe, one step at batch 12, two val scenes), and pointops at the
# size of one of those scenes
ORIGIN_CONFIG = os.path.join(ROOT, "configs/scannet/semseg-spunet-v1m1-0-base.py")
ORIGIN_TRAIN_SCENES = 12
ORIGIN_VAL_SCENES = 2
# a near-tie of two squared distances: they differ by no more than this
# share of |q|^2 + |r|^2 (16 f32 ulps of the terms the expanded form
# |q|^2 + |r|^2 - 2 q.r cancels), or, for the direct form sum (q - r)^2 of
# f32 coordinates, of 2 d (|q| + |r|) + d^2 (what rounding q and r to f32
# and the sum's own rounding can move d^2 by)
NEAR_TIE = 16 * 2.0 ** -24
# phase 22: data parallelism, the ScanNet SpUNet-v1m1 recipe on phase 14's
# scene files; loader workers a process (the recipe's 12, for two ranks on
# the 8-CPU host) and each rank's share of the card's memory
DP_CONFIG = os.path.join(ROOT, "configs/scannet/semseg-spunet-v1m1-0-base.py")
DP_WORKERS = 3
DP_MEMORY_FRACTION = 0.45
SEED = 0
# band convs per forward of SpUNet-v1m1 at ScanNet's sparse_shape, from the
# routing (models/sparse_unet/layers.py:subm_route): L0 runs the last decoder
# stage's 2 blocks (4 convs, inline band plans since cin > 64); L1-L4 carry
# attached band plans and run enc/dec blocks 2+2, 3+2, 4+2 and 6 -> 8, 10,
# 12, 12 convs. The stem (k5), strided/inverse convs and head are not band.
BAND_CONVS_PER_FORWARD = 46
KERNEL_SOURCES = {
    "band_fwd_core": ("ponderv2_tpu_torch/csrc/band_conv.cu",
                      "ponderv2_tpu/ops/band_conv.py:192"),
    "band_dxdw_core": ("ponderv2_tpu_torch/csrc/band_conv_bwd.cu",
                       "ponderv2_tpu/ops/band_conv.py:278"),
    "band_dw_core": ("ponderv2_tpu_torch/csrc/band_conv_bwd.cu",
                     "ponderv2_tpu/ops/band_conv.py:222"),
    "windowed_conv_fwd": ("ponderv2_tpu_torch/csrc/windowed_gather.cu",
                          "ponderv2_tpu/ops/pallas_gather.py:147"),
    "windowed_conv_dw": ("ponderv2_tpu_torch/csrc/windowed_gather.cu",
                         "ponderv2_tpu/ops/pallas_gather.py:197"),
}
BAND_CORES = ("band_fwd_core", "band_dxdw_core", "band_dw_core")
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s; FLOP/s of bf16
# on the tensor cores, and of f32 at f32 accuracy: 3xTF32 (K2's f32 route,
# three TF32 products per f32 product) at a third of the 495 TFLOP/s TF32
# rate, above the CUDA cores' 67
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
F32_PEAK = "165 TFLOP/s: 3xTF32, a third of the 495 TFLOP/s TF32 rate"
# the f32 tiles' stated accuracy (csrc/mma_tile.cuh: 3xTF32 keeps "about
# 3 x 2^-22 of each product"): a K1-K3 output element in f32 is held to
# this share of its sum of |products| against float64
TILE_F32_ACCURACY = 3 * 2.0 ** -22
# what "ms" of a K1-K5 row is (the probe rows say theirs)
EAGER_TIMING = ("CUDA events around calls issued one by one from Python after a "
                "warm-up, L2 not flushed")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters):
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()  # warm-up
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(out, ref):
    return (out - ref.float()).abs().max().item(), ref.float().abs().max().item()


def seeded_state_dict(model, batch, device):
    """Seeded random weights, with BN running stats calibrated on one
    fragment (train-mode statistics taken with momentum 1), so activations
    keep their scale through the ~60 layers instead of shrinking."""
    import torch

    from ponderv2_tpu_torch.models.norm import MaskedBatchNorm

    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model.to(device)
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(batch)
    for m in bns:
        m.momentum = 0.01
    model.eval()
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def band_convs(spunet, level_rb):
    """Every band conv of one SpUNet forward: {(level, cin, cout): count}."""
    from ponderv2_tpu_torch.models.sparse_unet.layers import subm_route

    convs = {}
    for level, blocks in ([(s + 1, spunet.enc[s]) for s in range(4)]
                          + [(r, spunet.dec[r]) for r in range(4)]):
        for block in blocks.values():
            for conv in (block.conv1, block.conv2):
                key = (level, conv.in_channels, conv.out_channels)
                if subm_route(level_rb[level], *key[1:], 3).startswith("band"):
                    convs[key] = convs.get(key, 0) + 1
    return convs


def level_plans(spunet, st):
    """The conv plans of ``st`` as the backbone builds them: per level the
    k3 plan (SubmPlan or plain rulebook) and the level's coords, and the k5
    stem's plan."""
    from ponderv2_tpu_torch.models.sparse_unet.plans import (
        build_spunet_plans_auto, capacity_schedule)

    plans = build_spunet_plans_auto(
        st.coords, st.spatial_shape, st.batch_size,
        spunet.capacities or capacity_schedule(st.capacity, spunet.num_stages),
        spunet.channels)
    return ([plans.l0] + list(plans.subm),
            [st.coords] + [s[0] for s in plans.strided], plans.stem)


def band_routing(spunet, level_rb):
    """The band convs of one forward and their backward route: ({(level,
    cin, cout): count}, {key: fused}, K1/K2/K3 launches per train step).
    Under the backbone's ``remat`` the backward runs each band conv's
    forward (K1) again."""
    from ponderv2_tpu_torch.ops import band_conv as bc

    convs = band_convs(spunet, level_rb)
    fused = {key: bc.fused_bwd_fits(-(-key[1] // 128) * 128, -(-key[2] // 128) * 128)
             for key in convs}
    n_band = sum(convs.values())
    n_fused = sum(c for key, c in convs.items() if fused[key])
    n_fwd = n_band * (2 if getattr(spunet, "remat", False) else 1)
    return convs, fused, [n_fwd + (n_band - n_fused), n_fused, n_band - n_fused]


def bound_ms(moved_bytes, flops, dtype):
    """The least time an H100 SXM could take: (max(bytes / 3.35 TB/s,
    FLOPs / peak of the dtype) in ms, the bytes-time, the FLOP-time)."""
    t_bytes = moved_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).rsplit(".", 1)[-1]] * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def band_live_mask(plan, n, kz=3, block=None, window=None):
    """(n, K^3) bool: the in-window entries of a band plan over its first
    ``n`` rows, the ones K1-K3 multiply (overflow entries go to the plain
    residual); ``block``/``window`` default to the band conv's."""
    import torch

    from ponderv2_tpu_torch.ops import band_conv as bc

    block, window = block or bc.BLOCK, window or bc.WINDOW
    rbt = plan.rbt[:n].to(torch.int64)
    i = torch.arange(n, device=rbt.device)
    cols = torch.arange(rbt.shape[1], device=rbt.device) // kz
    pos = rbt - plan.w0.to(torch.int64)[cols[None, :], (i // block)[:, None]]
    return (rbt >= 0) & (pos >= 0) & (pos < window)


def band_live_entries(plan, n, kz=3):
    return int(band_live_mask(plan, n, kz).sum())


def band_rows_multiplied(plan, n, kz=3, block=None, window=None):
    """(in-window entries, rows the compacted tile multiplies, rows the slab
    tile multiplies) of a band plan over its first ``n`` rows, per output
    column tile, counted from the plan as the tiles decide: the compacted
    tile (``mma_tile.cuh:compact_gather_gemm``, K1 in f32) multiplies, per
    tile of ``K1_TILE`` rows and tap, the live entries rounded up to whole
    16-row slabs; the slab tile (``gather_gemm``: K2's dx, K1 in bf16)
    every 16-row slab that holds a live entry of the tap."""
    import torch

    from ponderv2_tpu_torch.ops import band_conv as bc

    live = band_live_mask(plan, n, kz, block, window)
    k3 = live.shape[1]
    rows = bc.K1_TILE[0]
    live = torch.cat([live, live.new_zeros((-n % rows, k3))])
    per_tile = live.reshape(-1, rows, k3).sum(1)
    compacted = int(((per_tile + 15) // 16 * 16).sum())
    slabs = int(live.reshape(-1, 16, k3).any(1).sum()) * 16
    return int(live.sum()), compacted, slabs


def k1_tile(dtype):
    """Which tile K1 runs in ``dtype`` (``ops/band_conv.py:fwd_plan``)."""
    from ponderv2_tpu_torch.ops import band_conv as bc

    return "compacted" if bc.fwd_plan(1, 8, 8, 27, dtype).compact else "slabs"


def band_op_bound(op, plan, n, cin, cout, dtype):
    """``bound_ms`` of one band-conv kernel call: each input read once,
    each output written once; 2 FLOPs per in-window entry and channel pair
    (twice that for K2's dx + dW), f32 at the 3xTF32 rate (``F32_PEAK``)."""
    import torch

    elt = 2 if dtype == torch.bfloat16 else 4
    idx = 4 * (plan.rbt.numel() + plan.w0.numel())
    wts = 27 * cin * cout * elt
    fin, gin, dx, dw = n * cin * elt, n * cout * elt, n * cin * 4, 27 * cin * cout * 4
    moved = {"fwd": fin + idx + wts + n * cout * 4, "dx": gin + idx + wts + dx,
             "dxdw": gin + fin + idx + wts + dx + dw, "dw": fin + gin + idx + dw}[op]
    flops = 2.0 * band_live_entries(plan, n) * cin * cout * (2 if op == "dxdw" else 1)
    return bound_ms(moved, flops, dtype)


def compare_band_kernels(convs, fused, level_rb, level_coords, gen, dtype, stats,
                         fwd_runs=1):
    """K1, K2 and K3 against their plain versions at every band conv of
    ``convs`` ({(level, cin, cout): count per forward}), in f32 (1e-4 of
    max(|ref|, 1)) and bf16 (3e-2 of max|ref|); each op the train step runs
    on a conv is timed in ``dtype`` and added, times its count, to
    ``stats[core]`` (ms, plain_ms, bound_ms, bytes_ms, ops_ms, err, err_bf16);
    the forward ``fwd_runs`` times (2 under the backbone's ``remat``)."""
    import torch

    from ponderv2_tpu_torch.ops import band_conv as bc

    dev = gen.device
    owner = {"fwd": "band_fwd_core", "dx": "band_fwd_core",
             "dxdw": "band_dxdw_core", "dw": "band_dw_core"}
    for (level, cin, cout), count in sorted(convs.items()):
        legacy, plan = band_plan_of(level_rb[level])
        n = legacy.shape[1]
        valid = (level_coords[level][:, 0] >= 0)[:, None]
        f = torch.randn(n, cin, device=dev, generator=gen) * valid
        g = torch.randn(n, cout, device=dev, generator=gen) * valid
        w = torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5
        wmt = w.flip(0).transpose(1, 2).contiguous()
        args, tail = (plan.rbt, plan.w0), (3, bc.BLOCK, bc.WINDOW)
        calls = {
            "fwd": (lambda a, b, c, d: bc.band_fwd_core(a, *args, c, *tail),
                    lambda a, b, c, d: bc.band_fwd_core_plain(a, *args, c, *tail)),
            "dx": (lambda a, b, c, d: bc.band_fwd_core(b, *args, d, *tail),
                   lambda a, b, c, d: bc.band_fwd_core_plain(b, *args, d, *tail)),
            "dxdw": (lambda a, b, c, d: bc.band_dxdw_core(b, a, *args, d, *tail),
                     lambda a, b, c, d: bc.band_dxdw_core_plain(b, a, *args, d, *tail)),
            "dw": (lambda a, b, c, d: bc.band_dw_core(a, b, *args, *tail),
                   lambda a, b, c, d: bc.band_dw_core_plain(a, b, *args, *tail)),
        }
        low = (f.bfloat16(), g.bfloat16(), w.bfloat16(), wmt.bfloat16())
        timed = low if dtype == torch.bfloat16 else (f, g, w, wmt)
        line = []
        for op, (kern, plain) in calls.items():
            def pairs(outs, refs):
                return list(zip(outs, refs)) if op == "dxdw" else [(outs, refs)]

            errs = [max_err(o, r) for o, r in pairs(kern(f, g, w, wmt), plain(f, g, w, wmt))]
            torch.cuda.synchronize()
            check(all(e <= 1e-4 * max(s, 1.0) for e, s in errs),
                  f"{op} f32 L{level} {cin}->{cout}: {errs}")
            errs_b = [max_err(o, r) for o, r in pairs(kern(*low), plain(*low))]
            check(all(e <= 3e-2 * s for e, s in errs_b),
                  f"{op} bf16 L{level} {cin}->{cout}: {errs_b}")
            st = stats[owner[op]]
            st["err"] = max(st["err"], max(e for e, _ in errs))
            st["err_bf16"] = max(st["err_bf16"], max(e for e, _ in errs_b))
            # time where the step runs it: the forward on every band conv,
            # K2 on the fused ones, K1 (dx) + K3 on the split ones
            runs = {"fwd": True, "dx": not fused[(level, cin, cout)],
                    "dxdw": fused[(level, cin, cout)],
                    "dw": not fused[(level, cin, cout)]}[op]
            timing = ""
            if runs:
                t_k = cuda_ms(lambda: kern(*timed), 5)
                t_p = cuda_ms(lambda: plain(*timed), 3)
                b, b_bytes, b_ops = band_op_bound(op, plan, n, cin, cout, dtype)
                runs_per_step = count * (fwd_runs if op == "fwd" else 1)
                for key, v in (("ms", t_k), ("plain_ms", t_p), ("bound_ms", b),
                               ("bytes_ms", b_bytes), ("ops_ms", b_ops)):
                    st[key] += runs_per_step * v
                timing = f" {t_k:.3f}/{t_p:.3f} ms (bound {b:.4f})"
            line.append(f"{op} err {max(e for e, _ in errs):.2e} "
                        f"bf16 {max(e for e, _ in errs_b):.2e}{timing}")
        live, compacted, slabs = band_rows_multiplied(plan, n)
        print(f"[band] L{level} rows {n} {cin}->{cout} x{count} "
              f"{'fused' if fused[(level, cin, cout)] else 'split'}: " + "; ".join(line)
              + f"; live entries {live}, rows multiplied per column tile: compacted "
              f"{compacted}, slabs {slabs} (K1 {k1_tile(dtype)}, K2's dx slabs)")
        del f, g, w, wmt, low, timed


def reordered_fwd(f, rbt, w0, w, kz, block, window):
    """K1's function as its plain version computes it, but with the taps
    summed in reverse: another f32 order, for the spread of a grads check."""
    from ponderv2_tpu_torch.ops import band_conv as bc

    n = f.shape[0]
    out = 0.0
    for t in reversed(range(w.shape[0])):
        out = out + bc._tap_rows(f, rbt, w0, t, n, kz, block, window).float() @ w[t].float()
    return out


def reordered_dw(f, g, rbt, w0, kz, block, window):
    """K3's function with the rows summed in two halves, the second first."""
    import torch

    from ponderv2_tpu_torch.ops import band_conv as bc

    n = f.shape[0]
    h = n // 2
    ff = f.float()
    dwr = []
    for t in range(rbt.shape[1]):
        rows = bc._tap_rows(g, rbt, w0, t, n, kz, block, window).float()
        dwr.append(ff[h:].T @ rows[h:] + ff[:h].T @ rows[:h])
    return torch.stack(dwr)


def reordered_dxdw(g, f, rbt, w0, wmt, kz, block, window):
    """K2's function summed in another order (``reordered_fwd``,
    ``reordered_dw``)."""
    return (reordered_fwd(g, rbt, w0, wmt, kz, block, window),
            reordered_dw(f, g, rbt, w0, kz, block, window))


def reordered_gather_sum(f, rulebook, w):
    """``ops/spconv.py:_gather_conv_sum`` with its taps summed in reverse:
    the plain gather conv's function in another f32 order, for the spread
    of a grads check."""
    import torch

    from ponderv2_tpu_torch.ops.scatter import sum_dtype

    acc = sum_dtype(f.dtype)
    out = torch.zeros(rulebook.shape[1], w.shape[2], dtype=acc, device=f.device)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    for k in reversed(range(rulebook.shape[0])):
        idx = rulebook[k]
        g = torch.where((idx >= 0)[:, None], f[idx.clamp(min=0).to(torch.int64)], zero)
        out += (g @ w[k]).to(acc)
    return out


def band_plan_of(rb):
    """The band plan a conv on this level runs (attached, or inline with
    the budget retry, as SubMConv builds it)."""
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.spconv import BandedRulebook, SubmPlan

    if isinstance(rb, (SubmPlan, BandedRulebook)):
        if rb.band is not None:
            return rb.legacy, rb.band
        rb = rb.legacy
    return rb, bc.build_band_plan_auto(rb, 3)


def launch_split(records):
    """A hook class that, at the end of training, keeps the K1-K3 launches
    so far in ``records["train_launches"]`` and sets every count to 0, so
    that the hooks after it (a ``PreciseEvaluator``) are counted apart."""
    from ponderv2_tpu_torch.engines.hooks import HookBase
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops import windowed_gather as wg

    class LaunchSplit(HookBase):
        def after_train(self):
            records["train_launches"] = [k.launches for k in bc.KERNELS]
            for k in bc.KERNELS + wg.KERNELS:
                k.launches = 0

    return LaunchSplit


def step_probe(records):
    """A hook class that records each training step in ``records``
    (``{"steps": [], "conditions": []}``, and every batch when it holds
    ``"batches": []``)."""
    import torch

    from ponderv2_tpu_torch.engines.hooks import HookBase
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops import windowed_gather as wg

    class StepProbe(HookBase):
        """Per step: the synced metrics, the step's K1-K5 launches
        and the lr the schedule gives; keeps the first batch, the BN
        running statistics before training, and the ``condition`` each
        forward of the model was given and the loss terms it returned."""

        def before_train(self):
            trainer = self.trainer
            model = trainer.model
            records["running_before"] = {k: v.detach().clone() for k, v
                                         in model.state_dict().items() if "running" in k}
            model.register_forward_pre_hook(
                lambda module, args: records["conditions"].append(args[0].get("condition")))
            model.register_forward_hook(lambda module, args, out: records.setdefault(
                "terms", []).append({k: v.detach() for k, v in out.items()
                                     if k.endswith("loss") and torch.is_tensor(v)}))
            if "val" in records:
                # each val batch, its forward's output and seconds, and the
                # seconds and proposals of each host clustering
                eval_step, propose = trainer.eval_step, model.propose_instances

                def timed_eval_step(input_dict):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = eval_step(input_dict)
                    torch.cuda.synchronize()
                    records["val"].append(dict(batch=input_dict, out=out,
                                               seconds=time.perf_counter() - t))
                    return out

                def timed_propose(*args):
                    t = time.perf_counter()
                    proposals = propose(*args)
                    records["val"][-1].update(proposals=proposals,
                                              cluster_s=time.perf_counter() - t)
                    return proposals

                trainer.eval_step = timed_eval_step
                model.propose_instances = timed_propose

        def before_step(self):
            self.before = [k.launches for k in bc.KERNELS + wg.KERNELS]
            if "peaks" in records:  # each step's own peak, the run's kept apart
                records["peak_floor"] = max(records.get("peak_floor", 0),
                                            torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()

        def after_step(self):
            trainer = self.trainer
            if "peaks" in records:
                records["peaks"].append(torch.cuda.max_memory_allocated())
            metrics = trainer.sync_metrics()
            metrics["launches"] = [k.launches - b for k, b
                                   in zip(bc.KERNELS + wg.KERNELS, self.before)]
            metrics["schedule_lr"] = trainer.schedule(trainer.step - 1)
            records["steps"].append(metrics)
            records.setdefault("batch", trainer.comm_info["input_dict"])
            if "batches" in records:
                records["batches"].append(trainer.comm_info["input_dict"])

    return StepProbe


def step_grads(gmodel, inputs, cores=None):
    """One forward and backward of ``gmodel`` on ``inputs``, with the band
    cores swapped for ``cores`` (name: function) if given: (loss, grads,
    K1-K3 launches, seconds)."""
    import torch

    from ponderv2_tpu_torch.ops import band_conv as bc

    saved = {name: getattr(bc, name) for name in BAND_CORES}
    if cores:
        for name, fn in cores.items():
            setattr(bc, name, fn)
    on_cuda = next(gmodel.parameters()).is_cuda
    try:
        gmodel.zero_grad(set_to_none=True)
        before = [k.launches for k in bc.KERNELS]
        if on_cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = gmodel(inputs)
        out["loss"].backward()
        if on_cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launched = [k.launches - b for k, b in zip(bc.KERNELS, before)]
        grads = {n: p.grad.detach().clone() for n, p in gmodel.named_parameters()
                 if p.grad is not None}
        return float(out["loss"].detach()), grads, launched, secs
    finally:
        for name, fn in saved.items():
            setattr(bc, name, fn)


def float64_cores(calls):
    """K1-K3 cores that launch the kernels and, per call, compute the same
    function in float64 and in plain f32 from the call's own inputs; each
    call appends (kernel, rows, cin, cout, kernel error, plain f32 error,
    max sum of |products|) to ``calls``, errors as max abs against
    float64. K2 appends its dx and its dW."""
    from ponderv2_tpu_torch.ops import band_conv as bc

    kern = {name: getattr(bc, name) for name in BAND_CORES}

    def f64(*args):
        return [a.double() if a.is_floating_point() else a for a in args]

    def mag(*args):
        return [a.double().abs() if a.is_floating_point() else a for a in args]

    def err(out, exact):
        return (out.double() - exact).abs().max().item()

    def fwd(f, rbt, w0, w, kz, block, window):
        out = kern["band_fwd_core"](f, rbt, w0, w, kz, block, window)
        exact = bc.band_fwd_core_plain(*f64(f, rbt, w0, w), kz, block, window)
        plain = bc.band_fwd_core_plain(f, rbt, w0, w, kz, block, window)
        m = bc.band_fwd_core_plain(*mag(f, rbt, w0, w), kz, block, window).max().item()
        calls.append(("K1", f.shape[0], f.shape[1], w.shape[2], err(out, exact),
                      err(plain, exact), m))
        return out

    def dxdw(g, f, rbt, w0, wmt, kz, block, window):
        dx, dwr = kern["band_dxdw_core"](g, f, rbt, w0, wmt, kz, block, window)
        ex, ew = bc.band_dxdw_core_plain(*f64(g, f, rbt, w0, wmt), kz, block, window)
        px, pw = bc.band_dxdw_core_plain(g, f, rbt, w0, wmt, kz, block, window)
        mx, mw = bc.band_dxdw_core_plain(*mag(g, f, rbt, w0, wmt), kz, block, window)
        calls.append(("K2 dx", f.shape[0], g.shape[1], f.shape[1], err(dx, ex), err(px, ex),
                      mx.max().item()))
        calls.append(("K2 dW", f.shape[0], f.shape[1], g.shape[1], err(dwr, ew),
                      err(pw, ew), mw.max().item()))
        return dx, dwr

    def dw(f, g, rbt, w0, kz, block, window):
        out = kern["band_dw_core"](f, g, rbt, w0, kz, block, window)
        exact = bc.band_dw_core_plain(*f64(f, g, rbt, w0), kz, block, window)
        plain = bc.band_dw_core_plain(f, g, rbt, w0, kz, block, window)
        m = bc.band_dw_core_plain(*mag(f, g, rbt, w0), kz, block, window).max().item()
        calls.append(("K3", f.shape[0], f.shape[1], g.shape[1], err(out, exact),
                      err(plain, exact), m))
        return out

    return {"band_fwd_core": fwd, "band_dxdw_core": dxdw, "band_dw_core": dw}


def calls_vs_float64(tag, gmodel, inputs):
    """One step of ``gmodel`` on ``inputs`` with the kernels, each K1-K3
    call held against float64 on its own inputs (``float64_cores``): every
    output within ``TILE_F32_ACCURACY`` of its sum of |products|. Prints
    each kernel's worst share of that bound (and plain f32's) and its
    largest ratio of kernel to plain f32 error; returns rho, the largest of
    those ratios (at least 1)."""
    calls = []
    step_grads(gmodel, inputs, float64_cores(calls))
    worst = {}
    for name, n, cin, cout, e_k, e_p, m in calls:
        check(e_k <= TILE_F32_ACCURACY * m,
              f"{tag}: {name} {n} rows {cin}->{cout}: err {e_k:.3e} against float64 > "
              f"3 x 2^-22 x max sum|products| {m:.3e}")
        w = worst.setdefault(name.split()[0], [0.0, 0.0, 0.0])
        w[0] = max(w[0], e_k / (TILE_F32_ACCURACY * m))
        w[1] = max(w[1], e_k / max(e_p, 2.0 ** -24 * m))  # e_p no finer than 1 ulp
        w[2] = max(w[2], e_p / (TILE_F32_ACCURACY * m))
    rho = max(1.0, max(w[1] for w in worst.values()))
    print(f"[grad] {tag}: {len(calls)} K1-K3 outputs (K2's dx and dW apart) against "
          "float64 on their own inputs, as a share of 3 x 2^-22 x max sum|products| "
          "(kernel, plain f32) and kernel error / plain f32 error at most: " + "; ".join(
              f"{k} {a:.3f}, {c:.3f}, {b:.2f}x" for k, (a, b, c) in worst.items())
          + f"; rho {rho:.3f}", flush=True)
    return rho


class PinnedRelu:
    """``torch.relu`` with its decisions shared across runs of a step.
    ``run("record", fn)`` runs ``fn`` with every relu call's mask (x > 0)
    kept in call order; ``run("replay", fn)`` zeroes each call's input where
    the recorded mask of that call is off and counts in ``flips`` the
    elements whose own decision differs. Runs that replay one record
    compute one smooth function, so their grads part only by rounding,
    also where an activation sits within rounding of 0. The recording run
    applies its masks as the replays do (``masked_fill``): with
    ``torch.relu`` there, the pretrain model's step gave other grads than
    its replay, bit for bit, with no decision changed."""

    def __init__(self):
        self.masks, self.flips, self.mode, self.i = [], 0, None, 0

    def __call__(self, x):
        own = x > 0
        if self.mode == "record":
            self.masks.append(own)
            return x.masked_fill(~own, 0)
        mask = self.masks[self.i]
        self.i += 1
        self.flips += int((own != mask).sum())
        return x.masked_fill(~mask, 0)

    def run(self, mode, fn):
        import torch

        self.mode, self.i, self.relu = mode, 0, torch.relu
        if mode == "record":
            self.masks = []
        else:
            self.flips = 0
        torch.relu = self
        try:
            out = fn()
        finally:
            torch.relu = self.relu
        check(mode == "record" or self.i == len(self.masks),
              f"pinned relu: {self.i} calls replayed, {len(self.masks)} recorded")
        return out


class PinnedSampler:
    """A renderer's sampler whose samples are shared across runs of a step.
    ``run(fn)`` puts it in the renderer's place for ``fn``: the first run
    keeps every call's (starts, ends) in call order; every later run gets
    the kept samples back, and ``moved`` records how far (in depth) its own
    sampler's would lie from them. The error-bounded sampler's bisection
    and inverse-CDF draws follow the sdf, which the kernel and plain paths
    round differently; with one set of samples both compute one smooth
    function of the parameters, and their grads part only by rounding."""

    def __init__(self, renderer):
        self.renderer, self.inner, self.samples = renderer, renderer.sampler, []

    def __getattr__(self, name):
        if name.startswith("__") or name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def __call__(self, *args, **kwargs):
        own = self.inner(*args, **kwargs)
        if not self.replay:
            self.samples.append(own)
            return own
        kept = self.samples[self.i]
        self.i += 1
        self.moved = max([self.moved] + [(a - b).abs().max().item() for a, b in zip(own, kept)])
        return kept

    def run(self, fn):
        self.replay, self.i, self.moved = bool(self.samples), 0, 0.0
        self.renderer.sampler = self
        try:
            out = fn()
        finally:
            self.renderer.sampler = self.inner
        check(not self.replay or self.i == len(self.samples),
              f"pinned samples: {self.i} calls replayed, {len(self.samples)} kept")
        return out


def float64_step_grads(gmodel, inputs, remat=True):
    """One forward and backward of a float64 copy of ``gmodel`` through the
    plain versions, every sum in float64 (``ops.scatter.sum_dtype``): the
    reference a grads check holds both f32 paths to. Each strided and
    inverse conv (the packed convs keep 8 masked copies of their input for
    the backward), and with ``remat`` each residual block and each conv +
    norm of the backbone (SpUNet-v1m3's or v1m1's, MinkUNet's blocks), runs
    under activation checkpointing, so the step fits beside the f32 model;
    without ``remat`` every relu runs in the order of the f32 runs (the
    model's own ``remat`` included), as ``PinnedRelu`` replays them.
    Returns (loss, grads, peak GiB of the step on the card)."""
    import copy
    from functools import partial

    import torch
    from torch.utils.checkpoint import checkpoint

    from ponderv2_tpu_torch.ops import band_conv as bc

    m64 = copy.deepcopy(gmodel).double()
    units = ("PDBasicBlock", "PDConvNorm", "BasicBlock", "ConvBNRelu", "Bottleneck")
    for m in m64.modules():
        # the packed convs call no relu: checkpointed with or without remat
        if type(m).__name__ in ("StridedConv", "InverseConv") or (
                remat and type(m).__name__ in units):
            m.forward = partial(checkpoint, m.forward, use_reentrant=False)
    x64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
           for k, v in inputs.items()}
    plain = {name: getattr(bc, f"{name}_plain") for name in BAND_CORES}
    on_cuda = next(gmodel.parameters()).is_cuda
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    loss, grads, _, _ = step_grads(m64, x64, plain)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_cuda else 0.0
    del m64, x64
    return loss, grads, peak


def tightest_margins_line(tag, margins, rho, reference, k=3):
    """The ``[grad]`` line of the ``k`` gradients closest to their bound,
    the tightest first. ``margins``: (err / bound, name, against, err,
    max|ref|, difference of the plain path) per gradient and reference."""
    tightest = sorted(margins, reverse=True)[:k]
    return (f"[grad] {tag}: the {len(tightest)} grads closest to their bound, tightest "
            f"first (err / (grad_rel x max|ref| + 3 x {rho:.3f} x {reference} difference "
            f"of the plain path)): " + "; ".join(
                f"{name} vs {against} {m:.3f} (err {e:.3e}, max|ref| {sc:.3e}, {reference} "
                f"{sp:.3e})" for m, name, against, e, sc, sp in tightest))


def grads_kernel_vs_plain(tag, gmodel, inputs, expect, loss_rel, grad_rel,
                          loss_spread, reference="reordered", pin_relu=False,
                          pin_samples=False):
    """Two runs of each path, and one reference run that measures the f32
    rounding a gradient carries. The step is reproducible (cuDNN
    deterministic, every sum in a fixed order), so the two runs of a path
    must give equal bits, loss and every gradient. The kernels sum in
    another order than the plain versions, and the deepest encoder convs'
    dW, summed over up to ~1M rows into a BN-centred cotangent, cancel; so
    each gradient is held to ``grad_rel`` of its max|ref| plus 3x its f32
    rounding, which ``reference`` measures:

    - ``"reordered"``: the plain path's difference from the plain versions
      summing in another order (``reordered_fwd``);
    - ``"float64"``: the plain path's difference from the same step in
      float64 (``float64_step_grads``), times the kernels' precision
      against plain f32 on this step: one more kernel run holds every
      K1-K3 call against float64 on its own inputs (``float64_cores``),
      each output within ``TILE_F32_ACCURACY`` of its sum of |products|,
      and takes rho, the largest ratio of a call's kernel error to its
      plain f32 error (at least 1). The kernel path is then held to
      ``grad_rel`` of max|ref| plus 3 rho x the plain path's float64
      difference, against the plain path and against float64 alike: no
      further from float64 than the plain path, scaled by how much
      coarser the kernels' f32 sums are per call (3xTF32 products on
      tensor cores against cuBLAS's f32 FMA).

    The loss is held to ``loss_rel`` of the plain path's (plus 3x the
    reordered difference if ``loss_spread``). With ``pin_relu`` every relu
    of every run takes the first plain run's decisions (``PinnedRelu``), so
    an activation within rounding of 0 cannot switch a gradient on in one
    path and off in another; the line says how many decisions each run's
    own forward would have made otherwise, and the kernel path may make
    at most 3x as many as the reference run. With ``pin_samples`` every
    run renders the first plain run's ray samples (``PinnedSampler``)."""
    import torch

    from ponderv2_tpu_torch.ops import band_conv as bc

    plain_cores = {name: getattr(bc, f"{name}_plain") for name in BAND_CORES}
    reordered_cores = {"band_fwd_core": reordered_fwd,
                       "band_dxdw_core": reordered_dxdw,
                       "band_dw_core": reordered_dw}
    pin = PinnedRelu()
    flips = {}
    pinned = PinnedSampler(gmodel.renderer) if pin_samples else None
    moved = {}

    def run(fn, name=None):
        if pinned is not None:
            fn = (lambda f: lambda: pinned.run(f))(fn)
        if not pin_relu:
            out = fn()
        else:
            out = pin.run("replay" if pin.masks else "record", fn)
            if name is not None:
                flips[name] = pin.flips
        if pinned is not None and name is not None:
            moved[name] = pinned.moved
        return out

    def plain_runs():
        return [run(lambda: step_grads(gmodel, inputs, plain_cores)) for _ in range(2)]

    # the record comes first
    plain = plain_runs() if pin_relu or pin_samples else None
    kern = [run(lambda: step_grads(gmodel, inputs), "kernel") for _ in range(2)]
    plain = plain or plain_runs()
    (loss_k, grads_k, launched_k, secs_k), (loss_p, grads_p, launched_p, secs_p) = (
        kern[0], plain[0])
    check(launched_k == expect and launched_p == [0, 0, 0],
          f"{tag}: launches kernel path {launched_k}, plain path {launched_p}")
    for path, (first, second) in (("kernel", kern), ("plain", plain)):
        unequal = [n for n, g in first[1].items() if not torch.equal(second[1][n], g)]
        check(first[0] == second[0] and not unequal,
              f"{tag}: two runs of the {path} path differ: loss {first[0]!r} vs "
              f"{second[0]!r}, {len(unequal)} grads, e.g. {unequal[:3]}")
    check(sorted(grads_k) == sorted(grads_p), f"{tag}: grads of other params")
    rho = 1.0
    if reference == "float64":
        rho = calls_vs_float64(tag, gmodel, inputs)
        loss_r, grads_r, peak = run(lambda: float64_step_grads(gmodel, inputs,
                                                               remat=not pin_relu), "float64")
        check(sorted(grads_r) == sorted(grads_p), f"{tag}: float64 grads of other params")
        ref_note = (f"float64 plain run: loss {loss_r:.9f}, peak memory "
                    f"{peak:.3f} GiB")
    else:
        loss_r, grads_r = run(lambda: step_grads(gmodel, inputs, reordered_cores),
                              "reordered")[:2]
        ref_note = f"reordered plain loss {loss_r:.7f}"
    spread_l = abs(loss_r - loss_p)
    check(abs(loss_k - loss_p) <= loss_rel * abs(loss_p)
          + (3 * spread_l if loss_spread else 0.0),
          f"{tag}: loss kernel {loss_k} vs plain {loss_p} ({ref_note})")
    rows, margins = [], []
    for name, ref in grads_p.items():
        scale = ref.abs().max().item()
        err = (grads_k[name] - ref).abs().max().item()
        # the plain path's f32 rounding, as ``reference`` measures it
        spread = (grads_r[name].double() - ref.double()).abs().max().item()
        bound = max(grad_rel * scale + 3 * rho * spread, 1e-30)
        errs = [(err, "plain")]
        if reference == "float64":
            errs.append(((grads_k[name].double() - grads_r[name]).abs().max().item(),
                         "float64"))
        for e, against in errs:
            margins.append((e / bound, name, against, e, scale, spread))
        rows.append((err / max(scale, 1e-30), spread / max(scale, 1e-30), name))
    if pin_relu:
        print(f"[grad] {tag}: every relu pinned to the plain path's decisions "
              f"({sum(int(m.numel()) for m in pin.masks)} over {len(pin.masks)} calls); "
              "each run's own forward would decide otherwise at: " + ", ".join(
                  f"{k} {v}" for k, v in flips.items()), flush=True)
        # rounding moves only the decisions at near-ties: the kernels' no
        # more of them than 3x the reference run's
        check(flips["kernel"] <= 3 * max(flips[reference], 1),
              f"{tag}: the kernel path's relus decide {flips['kernel']} elements otherwise, "
              f"the {reference} run's {flips[reference]}")
    if pin_samples:
        print(f"[grad] {tag}: every run renders the first plain run's ray samples "
              f"({len(pinned.samples)} sampler calls); each run's own sampler would move "
              "them by up to (depth): " + ", ".join(f"{k} {v:.3e}" for k, v in moved.items()),
              flush=True)
    print(tightest_margins_line(tag, margins, rho, reference), flush=True)
    for m, name, against, err, scale, spread in margins:
        check(m <= 1.0, f"{tag}: grad {name}: kernel vs {against} {err:.3e} > {grad_rel} x "
              f"{scale:.3e} + 3 x {rho:.3f} x {reference} {spread:.3e}")
    rows.sort()
    strict = sum(r[0] <= 1e-3 for r in rows)
    print(f"[grad] {tag}: two runs of each path equal bit for bit; loss kernel "
          f"{loss_k:.7f} plain {loss_p:.7f} ({ref_note}); "
          f"{strict} of {len(rows)} grads within 1e-3 of their max|ref|; worst "
          f"{rows[-1][2]} at {rows[-1][0]:.3e} ({reference} plain {rows[-1][1]:.3e}); "
          f"largest {reference} difference of the plain path "
          f"{max(r[1] for r in rows):.3e}; forward+backward {1e3 * secs_k:.1f} / "
          f"{1e3 * kern[1][3]:.1f} ms with the kernels, {1e3 * secs_p:.1f} / "
          f"{1e3 * plain[1][3]:.1f} ms plain")
    for ratio, spread, name in rows[-5:]:
        print(f"[grad]   {name}: kernel vs plain {ratio:.3e}, {reference} vs plain "
              f"{spread:.3e} (of max|ref|)")


def grads_either_bound(tag, gmodel, inputs, expect, pin_relu=False):
    """``grads_kernel_vs_plain`` at phase 8's bound (the reordered plain
    path); if that fails, at phase 14's float64 form. Returns which held."""
    try:
        grads_kernel_vs_plain(tag, gmodel, inputs, expect, 1e-5, 1e-3, False,
                              pin_relu=pin_relu)
        holds = "phase 8's (reordered plain)"
    except RuntimeError as e:
        print(f"[grad] {tag}: phase 8's bound failed ({e}); holding it to phase 14's "
              "float64 form", flush=True)
        grads_kernel_vs_plain(tag, gmodel, inputs, expect, 1e-5, 1e-3, False,
                              reference="float64", pin_relu=pin_relu)
        holds = "phase 14's (float64)"
    print(f"[grad] {tag}: the bound that holds is {holds}")
    return holds


def traced_routing(model, inputs, expected):
    """The band convs of one forward of ``model`` on ``inputs`` (a batch
    dict), as its SubMConvs route them: an eval forward with a hook on each
    records the convs that took a band route and the rulebook each ran on;
    their count must be ``expected``, the band convs the model's config
    gives. Returns the ``spunet_routing`` tuple: per level (from its rows:
    each level's capacity halves the last's) the rulebook its band convs ran
    on and its rows' coords; {(level, cin, cout): count}; {key: fused};
    K1/K2/K3 launches per train step (each band conv's forward twice under
    the backbone's ``remat``: every band conv sits in a checkpointed block);
    band convs per forward."""
    import torch

    from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv
    from ponderv2_tpu_torch.ops import band_conv as bc

    level_rb, level_coords, convs = {}, {}, {}
    rows0 = inputs["feat"].shape[0]

    def record(module, args, out):
        if not module.last_route.startswith("band"):
            return
        st, rb = args[0], args[1]
        # the level, from the rows (each level's capacity halves the last's)
        level = round(math.log2(rows0 / st.coords.shape[0]))
        level_rb[level], level_coords[level] = rb, st.coords
        key = (level, module.in_channels, module.out_channels)
        convs[key] = convs.get(key, 0) + 1

    handles = [m.register_forward_hook(record) for m in model.modules()
               if isinstance(m, SubMConv)]
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(inputs)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    n_band = sum(convs.values())
    check(n_band == expected, f"the traced forward ran {n_band} band convs, its config "
          f"gives {expected}: {convs}")
    fused = {key: bc.fused_bwd_fits(-(-key[1] // 128) * 128, -(-key[2] // 128) * 128)
             for key in convs}
    n_fused = sum(c for key, c in convs.items() if fused[key])
    n_fwd = n_band * (2 if model.backbone.remat else 1)
    per_step = [n_fwd + (n_band - n_fused), n_fused, n_band - n_fused]
    return level_rb, level_coords, convs, fused, per_step, n_band


def spunet_routing(model, inputs, st):
    """SpUNet-v1m1's band convs on the batch ``inputs`` (sorted sparse
    tensor ``st``), derived from its plans (``level_plans``,
    ``band_routing``): the ``traced_routing`` tuple."""
    spunet = spunet_of(model)
    level_rb, level_coords, _ = level_plans(spunet, st)
    convs, fused, per_step = band_routing(spunet, level_rb)
    return level_rb, level_coords, convs, fused, per_step, BAND_CONVS_PER_FORWARD


def spunet_of(model):
    """The sparse U-Net under ``model``'s wrappers (segmentor, PPT, PG)."""
    m = model.backbone
    while not hasattr(m, "enc"):
        m = m.backbone
    return m


def train_and_check(tag, cfg, dev, records=None, val_metric="val/mIoU", steps_expected=3,
                    band_convs_per_fwd=None):
    """Train ``cfg`` (3 steps and its evaluations) through
    ``tools/train_torch.py:main_worker`` with a ``step_probe`` hook, the
    K1-K5 counts set to 0 first, and check what each such run must show:
    every step's loss finite, ``contract_ok``, the lr the schedule gives
    and the K1/K2/K3 launches ``band_routing`` derives for the first batch;
    each val forward's band convs; the run's launches in all; the
    checkpoint holding the trained state and loading into a fresh model.
    Prints the routing, each step, the step and data times and the peak
    memory, each line tagged ``[tag]``. Returns a namespace: the trained
    ``model``, the probe's ``records``, the first batch's model inputs
    ``b_inputs`` (with its ``condition``) and sparse tensor ``st``, its
    plans and routing, the checkpoint's ``state``, ``launches``,
    ``peak_gib``, ``step_ms`` and the ``CheckpointLoader``'s
    ``weight_load`` report. ``records`` may ask the probe for more
    (``step_probe``; ``"peaks": []`` each step's peak memory); ``val_metric``
    is the evaluation's storage key to print (None: the config evaluates
    nothing); ``steps_expected`` the steps of the run;
    ``band_convs_per_fwd`` the band convs per forward that the config of a
    backbone other than SpUNet-v1m1's U-Net gives: its routing is then
    traced (``traced_routing``) and held to that count, else derived from
    the SpUNet plans (``spunet_routing``). A ``PreciseEvaluator``'s tester
    (``precise``) runs after training with the counts set to 0 just before
    it (``launch_split``): each of its forwards must report ``contract_ok``
    and launch K1 once a band conv, and its launches are returned apart
    (``precise_launches``)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from ponderv2_tpu_torch.engines.common import split_batch, with_condition
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops import windowed_gather as wg
    from ponderv2_tpu_torch.ops.sparse import maybe_sort_by_key
    from ponderv2_tpu_torch.ops.spconv import BandedRulebook, SubmPlan
    from train_torch import main_worker

    records = records if records is not None else {"steps": [], "conditions": []}
    hooks = list(cfg.hooks)
    precise_at = next((i for i, h in enumerate(hooks) if h["type"] == "PreciseEvaluator"),
                      None)
    if precise_at is not None:
        hooks.insert(precise_at, dict(type=launch_split(records)))
    cfg.hooks = hooks + [dict(type=step_probe(records))]
    torch.cuda.reset_peak_memory_stats(dev)
    for k in bc.KERNELS + wg.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    trainer = main_worker(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = records.get("train_launches", [k.launches for k in bc.KERNELS])
    precise_launches = [k.launches for k in bc.KERNELS] if precise_at is not None else None
    peak_gib = max(torch.cuda.max_memory_allocated(dev), records.get("peak_floor", 0),
                   *records.get("peaks", [])) / 2 ** 30
    steps = records["steps"]
    n_val = len(trainer.val_loader) if trainer.val_loader is not None else 0
    model = trainer.model
    val_band = sum(m.last_route.startswith("band") for m in model.modules()
                   if isinstance(m, SubMConv))  # the last forward was a val one
    print(f"[{tag}] {len(steps)} steps + {n_val} val forwards in {train_s:.2f} s; "
          f"launches (K1, K2, K3) {launches}; peak memory {peak_gib:.3f} GiB")

    # the routing of the first batch (derived from its plans)
    arrays, static = split_batch(records["batch"])
    b_inputs = with_condition({k: torch.as_tensor(v, device=dev) for k, v in arrays.items()},
                              static)
    b_inputs.update(trainer.static_ctx)
    st, _ = maybe_sort_by_key(batch_to_sparse_tensor(b_inputs))
    if band_convs_per_fwd is None:
        routing = spunet_routing(model, b_inputs, st)
    else:
        routing = traced_routing(model, b_inputs, band_convs_per_fwd)
    level_rb, level_coords, convs, fused, per_step, band_per_fwd = routing
    n_band = sum(convs.values())
    live = int((b_inputs["batch"] >= 0).sum())
    rbs = level_rb.values() if isinstance(level_rb, dict) else level_rb
    attached = sum(isinstance(rb, (SubmPlan, BandedRulebook)) and rb.band is not None
                   for rb in rbs)
    print(f"[{tag}] routing at batch {cfg.batch_size}: {n_band} band convs per forward "
          f"(on {len(level_rb)} rulebooks, {attached} with attached plans), "
          f"{per_step[1]} fused backward (K2), {per_step[2]} split (K1 + K3): "
          f"launches per step {per_step}; {live} live rows of {st.capacity}"
          + (f"; batch conditions {static['condition']}" if "condition" in static else ""))
    check(len(steps) == len(trainer.train_loader) == steps_expected,
          f"{tag}: {len(steps)} steps")
    for i, m in enumerate(steps):
        print(f"[{tag}] step {i}: loss {m['loss']:.6f} lr {m['lr']:.6e} contract_ok "
              f"{m['contract_ok']} launches {m['launches']}")
        check(np.isfinite(m["loss"]), f"{tag} step {i} loss {m['loss']}")
        check(m["contract_ok"] == 1.0, f"{tag} step {i} contract_ok False")
        check(m["lr"] == m["schedule_lr"], f"{tag} step {i} lr {m['lr']} != schedule")
        check(m["launches"] == per_step + [0, 0],
              f"{tag} step {i} launches {m['launches']} != routing {per_step}")
    check(not n_val or val_band == band_per_fwd,
          f"{tag}: val forward ran {val_band} band convs")
    precise = trainer.comm_info.get("precise_tester")
    n = steps_expected
    check(launches == [n * per_step[0] + n_val * band_per_fwd, n * per_step[1],
                       n * per_step[2]],
          f"{tag}: training launches {launches} ({n_val} val forwards)")
    check((precise is None) == (precise_at is None), f"{tag}: no precise evaluation ran")
    if precise is not None:
        n_precise = len(precise.fragment_seconds)
        check(all(precise.contract_ok),
              f"{tag}: a precise-evaluation forward reported contract_ok False")
        check(precise_launches == [n_precise * band_per_fwd, 0, 0],
              f"{tag}: the precise evaluation's launches {precise_launches} != "
              f"{n_precise} forwards x {band_per_fwd} band convs")
        print(f"[{tag}] precise evaluation: {n_precise} forwards, launches (K1, K2, K3) "
              f"{precise_launches}")

    ckpt_path = os.path.join(cfg.save_path, "model", "model_last.pth")
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    fresh = build_model(dict(cfg.model))
    fresh.load_state_dict(ckpt["state_dict"])
    check(ckpt["step"] == n and all(torch.equal(v.cpu(), fresh.state_dict()[k])
                                    for k, v in model.state_dict().items()),
          f"{tag}: the checkpoint does not hold the trained state")
    batch_times = [v for v, _ in trainer.storage.history("batch_time").values()]
    data_times = [v for v, _ in trainer.storage.history("data_time").values()]
    val_note = ""
    if val_metric is not None:
        val_note = (f"; {val_metric} {trainer.storage.history(val_metric).latest():.4f} "
                    f"(random-init weights after {n} steps)")
    print(f"[{tag}] checkpoint {ckpt_path} (step {ckpt['step']}) loads into a fresh "
          f"model{val_note}")
    # IterationTimer's batch_time runs from the end of one step to the end
    # of the next, so it holds the data wait; the step is the difference
    step_times = [b - d for b, d in zip(batch_times, data_times)]
    step_ms = 1e3 * float(np.median(step_times[1:] or step_times))
    print(f"[time] {tag} step (host clock, batch to device .. metrics synced): "
          f"{', '.join(f'{1e3 * t:.1f}' for t in step_times)} ms, median of the last "
          f"{max(len(step_times) - 1, 1)} {step_ms:.1f} ms; data wait "
          f"{', '.join(f'{1e3 * t:.1f}' for t in data_times)} ms")
    print(f"[memory] {tag} peak {peak_gib:.3f} GiB")
    run = SimpleNamespace(
        model=model, records=records, b_inputs=b_inputs, st=st, level_rb=level_rb,
        level_coords=level_coords, convs=convs, fused=fused, per_step=per_step,
        state=ckpt["state_dict"], launches=launches, peak_gib=peak_gib, step_ms=step_ms,
        n_val=n_val, step_times_ms=[1e3 * t for t in step_times],
        val_scalars={k: trainer.storage.history(k).latest()
                     for k in trainer.storage.histories() if k.startswith("val/")},
        data_ms=[1e3 * t for t in data_times], ckpt_path=ckpt_path,
        weight_load=trainer.comm_info.get("weight_load"), precise=precise,
        precise_metrics=trainer.comm_info.get("precise_metrics"),
        precise_weight=cfg.get("weight"), precise_launches=precise_launches,
        band_per_fwd=band_per_fwd)
    del trainer, fresh, ckpt
    gc.collect()
    torch.cuda.empty_cache()
    return run


def serve_and_check(tag, cfg, dev):
    """Serve ``cfg``'s test set through ``tools/test_torch.py:main_worker``
    with the K1-K3 counts set to 0 first, and check what each such run must
    show: every ``contract_ok``, ``BAND_CONVS_PER_FORWARD`` band convs in
    the last forward, and K1 launched that many times per forward, K2 and
    K3 never. Prints the run, tagged ``[tag]``. Returns a namespace: the
    ``tester``, its ``forwards``, ``launches``, ``peak_gib`` and
    ``seconds``."""
    from types import SimpleNamespace

    import torch

    from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv
    from ponderv2_tpu_torch.ops import band_conv as bc
    from test_torch import main_worker

    torch.cuda.reset_peak_memory_stats(dev)
    for k in bc.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    tester = main_worker(cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = [k.launches for k in bc.KERNELS]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    forwards = len(tester.fragment_seconds)
    per_fwd = sum(m.last_route.startswith("band") for m in tester.model.modules()
                  if isinstance(m, SubMConv))
    print(f"[{tag}] {forwards} forwards in {seconds:.2f} s; K1 launches {launches[0]}; band "
          f"convs in the last forward {per_fwd}; peak memory {peak_gib:.3f} GiB")
    check(per_fwd == BAND_CONVS_PER_FORWARD, f"{tag}: last forward ran {per_fwd} band convs")
    check(launches == [BAND_CONVS_PER_FORWARD * forwards, 0, 0],
          f"{tag}: serving launches (K1, K2, K3) {launches} != ({BAND_CONVS_PER_FORWARD} x "
          f"{forwards}, 0, 0)")
    check(all(tester.contract_ok), f"{tag}: a forward reported contract_ok False")
    return SimpleNamespace(tester=tester, forwards=forwards, launches=launches,
                           peak_gib=peak_gib, seconds=seconds)


def scene_instance_ids(segment, points):
    """Instance ids of a ``SyntheticDataset`` scene of ``points`` points,
    from its layout (``make_scene``): the floor's and the wall's
    ``points // 4`` rows each get -1; box ``b`` owns the next ``cnt`` rows
    from ``2 * (points // 4) + b * cnt`` on (``cnt`` = the object rows / the
    boxes) and gets id ``b``. Each box has its own class, so the boxes are
    told apart by their labels."""
    import numpy as np

    shell = 2 * (points // 4)
    obj = np.asarray(segment)[shell:]
    n_boxes = len(np.unique(obj))
    cnt = len(obj) // n_boxes
    ids = np.arange(len(obj)) // cnt
    check(cnt * n_boxes == len(obj) and np.array_equal(obj, obj[ids * cnt]),
          f"scene layout: {len(obj)} object rows, {n_boxes} labels")
    return np.concatenate([np.full(shell, -1, np.int64), ids.astype(np.int64)])


def write_scannet_scenes(root, n_train, n_val, points=100_000, instances=False):
    """ScanNet's processed layout, the one ``ScanNetDataset`` reads:
    ``{root}/{train,val}/sceneXXXX_00.pth``, each a dict of ``coord``,
    ``color``, ``normal``, ``semantic_gt20`` and ``instance_gt``, filled with
    the ``points``-point scenes ``SyntheticDataset`` makes from the seed;
    ``instance_gt`` is theirs (-1 everywhere), or with ``instances`` one id
    per box (``scene_instance_ids``)."""
    import torch

    from ponderv2_tpu_torch.datasets.defaults import SyntheticDataset

    synth = SyntheticDataset(num_scenes=n_train + n_val, points_per_scene=points, seed=SEED)
    for i in range(n_train + n_val):
        scene = synth.make_scene(i)
        split = "train" if i < n_train else "val"
        os.makedirs(os.path.join(root, split), exist_ok=True)
        instance = (scene_instance_ids(scene["segment"], points) if instances
                    else scene["instance"])
        torch.save(dict(coord=scene["coord"], color=scene["color"], normal=scene["normal"],
                        semantic_gt20=scene["segment"], instance_gt=instance),
                   os.path.join(root, split, f"scene{i:04d}_00.pth"))


def ppt_recipe_options(data_root, save_path):
    """What a run of ``PPT_CONFIG`` on scenes under ``data_root`` changes:
    the data roots, one epoch with one evaluation (3 steps of the 36 train
    scenes), no pretrained weight (the recipe's checkpoint is not in the
    repo) and the save path. Model, criteria, optimizer, scheduler,
    transforms, batch, point budget and Mix3D stay the recipe's."""
    return {"data.train.data_root": data_root, "data.val.data_root": data_root,
            "data.test.data_root": data_root, "epoch": 1, "eval_epoch": 1,
            "weight": None, "save_path": save_path}


def ppt_recipe_phase(dev, tmp, gen, stats):
    """Phase 14: the PPT fine-tune recipe from scene files. Trains 3 steps
    and one evaluation (``train_and_check``), checks the condition that
    reached the model and the norms that moved, holds K1-K3 and the step's
    grads against their plain versions, and serves the val scene
    (``serve_and_check``). Adds K1-K3's per-step times to ``stats``;
    returns the run's records."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.datasets import collate_fn
    from ponderv2_tpu_torch.engines.common import split_batch, with_condition
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.models import build_model

    data_root = os.path.join(tmp, "ppt_scannet")
    t0 = time.perf_counter()
    write_scannet_scenes(data_root, PPT_TRAIN_SCENES, 1)
    print(f"[ppt] wrote {PPT_TRAIN_SCENES} train + 1 val scenes of 100,000 points in "
          f"ScanNet's layout in {time.perf_counter() - t0:.1f} s")

    # ---- train 3 steps + one evaluation
    cfg = default_config_parser(PPT_CONFIG, ppt_recipe_options(
        data_root, os.path.join(tmp, "ppt_train")))
    cfg.seed = SEED
    cfg.device = str(dev)
    run = train_and_check("ppt", cfg, dev)
    out = {"train_launches": run.launches, "train_peak_gib": run.peak_gib,
           "step_ms": run.step_ms, "data_ms": run.data_ms}

    # the condition: the recipe's Add sets "ScanNet" on every scene; the
    # trainer hands the model the first scene's; the head and the backbone
    # both take index 1 of their conditions, so only bns.1 moves
    model, records = run.model, run.records
    n_forwards = 3 + run.n_val
    ci = model.conditions.index(PPT_CONDITION)
    check(records["conditions"] == [PPT_CONDITION] * n_forwards
          and ci == 1 and model.backbone.conditions.index(PPT_CONDITION) == 1,
          f"conditions that reached the model: {records['conditions']}")
    moved = sorted(k for k, v in records["running_before"].items()
                   if not torch.equal(run.state[k], v.cpu()))
    expected = sorted(k for k in records["running_before"] if f".bns.{ci}." in k)
    check(moved == expected, f"{len(moved)} running statistics moved, expected "
          f"{len(expected)} (bns.{ci}): e.g. {sorted(set(moved) ^ set(expected))[:3]}")
    print(f"[ppt] every forward ({n_forwards}) got condition {PPT_CONDITION!r} (index {ci} "
          f"of the head's and the backbone's); the {len(moved)} running statistics that "
          f"moved are exactly those of bns.{ci}")
    del model, run.model
    gc.collect()
    torch.cuda.empty_cache()

    # ---- K1, K2, K3 against their plain versions at this batch's convs
    compare_band_kernels(run.convs, run.fused, run.level_rb, run.level_coords, gen,
                         torch.float32, stats)

    # ---- one step's grads from the trained state, as in 8, with float64
    # as the reference: this step amplifies f32 rounding ~1e4x, and K1
    # rounds a few times more than plain f32 per call, so phase 8's
    # reordered plain term does not bound it (tools/experiments/
    # ppt_grads_torch.py)
    gmodel = build_model(dict(cfg.model))
    gmodel.load_state_dict(run.state)
    gmodel.to(dev).train()
    grads_kernel_vs_plain("PPT fine-tune step from the trained state", gmodel, run.b_inputs,
                          run.per_step, 1e-5, 1e-3, False, reference="float64")
    del gmodel, run
    gc.collect()
    torch.cuda.empty_cache()

    # ---- serve the val scene with the trained weights (4 rotations)
    ckpt_path = os.path.join(cfg.save_path, "model", "model_last.pth")
    scfg = default_config_parser(PPT_CONFIG, {
        **ppt_recipe_options(data_root, os.path.join(tmp, "ppt_test")), "weight": ckpt_path})
    scfg.seed = SEED
    scfg.device = str(dev)
    served = serve_and_check("ppt", scfg, dev)
    tester = served.tester
    out["serve_launches"], out["serve_peak_gib"] = served.launches, served.peak_gib
    scene = tester.test_dataset[0]
    n_rot = len(scfg.data.test.test_cfg.aug_transform)
    check(n_rot == 4 and served.forwards == len(scene["fragment_list"]),
          f"{served.forwards} forwards for {len(scene['fragment_list'])} fragments")
    frag = scene["fragment_list"][0]
    budget = scfg.get("point_budget_test", scfg.point_budget)
    fb = collate_fn([dict(frag)], point_budget=budget, scene_budget=1)
    fout = tester.eval_fragment(with_condition(*split_batch(fb)))
    logits = fout["seg_logits"]
    check(frag["condition"] == PPT_CONDITION and logits.shape == (budget, 20)
          and bool(np.isfinite(logits).all()) and bool(fout["contract_ok"]),
          f"PPT fragment logits {logits.shape}")
    out["fragment_ms"] = 1e3 * float(np.median(tester.fragment_seconds))
    print(f"[ppt] served the val scene: {n_rot} rotations, {served.forwards} fragments of "
          f"{', '.join(str(len(f['coord'])) for f in scene['fragment_list'][:4])}... "
          f"voxels; every contract_ok True; a fragment's logits ({logits.shape[0]}, "
          f"{logits.shape[1]}) finite")
    print(f"[time] PPT per-fragment latency in the tester (median of {served.forwards}, host "
          f"to logits on host, {budget}-row budget): {out['fragment_ms']:.2f} ms")
    del tester, served
    gc.collect()
    torch.cuda.empty_cache()
    return out


def write_multidataset_scenes(root, counts=None, points=100_000, views=MULTI_VIEWS,
                              hw=MULTI_VIEW_HW):
    """``SyntheticRGBDDataset``'s scenes (``points`` points, labels in each
    dataset's class count: 25, 20, 13) with ``views`` views each rendered by
    its z-buffer at ``hw`` (a centre crop of its square image; the
    intrinsics follow), written in each RGB-D dataset's layout and units
    under ``root`` for ``counts`` ({dataset: rooms or scenes}, default
    ``MULTI_SCENES``):

    - Structured3D, as ``preprocess_structured3d.py:parse_scene`` writes it:
      ``structured3d/train/scene_XXXXX/room_R.pth`` (``coord``, ``color``
      uint8, ``normal``, ``semantic_gt`` (N, 1) int16) and
      ``room_R_rgbd/frame_K.pth`` (``intrinsic``, ``extrinsic`` cam2world,
      ``rgb`` uint8, ``depth`` int32 mm with 65535 where there is none,
      ``depth_mask``, ``semantic_map``);
    - ScanNet: ``scannet/train/sceneXXXX_00.pth`` (as
      ``write_scannet_scenes``) and ``scannet_rgbd/sceneXXXX_00/K.npz``
      (``color``, ``depth`` in m, ``pose`` cam2world, ``intrinsic``,
      ``label``);
    - S3DIS, as ``preprocess_s3dis.py:parse_room`` writes it:
      ``s3dis/Area_A/office_I.pth`` (``coord``, ``color``, ``normal``,
      ``semantic_gt``, ``instance_gt``) and ``office_I_rgbd/*.pth`` (as
      Structured3D's, ``depth`` uint16 in 1/4000 m).

    Returns {"structured3d", "scannet", "scannet_rgbd", "s3dis": root}."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.datasets.defaults import SyntheticRGBDDataset

    counts = counts or MULTI_SCENES
    H, W = hw
    crop = (W - H) // 2
    roots = {name: os.path.join(root, name)
             for name in ("structured3d", "scannet", "scannet_rgbd", "s3dis")}

    def scenes(n, num_classes, seed):
        synth = SyntheticRGBDDataset(num_scenes=n, points_per_scene=points,
                                     num_classes=num_classes, num_cameras=views,
                                     image_size=W, seed=seed)
        for i in range(n):
            s = synth.make_scene(i)
            for key in ("rgb", "depth", "semantic2d"):
                s[key] = s[key][:, crop:crop + H]
            s["intrinsic"] = s["intrinsic"].astype(np.float64)
            s["intrinsic"][:, 1, 2] -= crop
            s["cam2world"] = np.linalg.inv(s["extrinsic"].astype(np.float64))
            yield i, s

    def save(obj, *path):
        os.makedirs(os.path.dirname(os.path.join(*path)), exist_ok=True)
        torch.save(obj, os.path.join(*path))

    def view(s, v, depth):
        valid = s["depth"][v] > 0
        return dict(intrinsic=s["intrinsic"][v], extrinsic=s["cam2world"][v],
                    rgb=s["rgb"][v].astype(np.uint8), depth=depth, depth_mask=valid,
                    semantic_map=np.where(valid, s["semantic2d"][v], -1))

    for i, s in scenes(counts["Structured3D"], 25, SEED):
        room = os.path.join(roots["structured3d"], "train", f"scene_{i // 2:05d}",
                            f"room_{i % 2}")
        save(dict(coord=s["coord"], color=s["color"].astype(np.uint8), normal=s["normal"],
                  semantic_gt=s["segment"].astype(np.int16)[:, None]), room + ".pth")
        for v in range(views):
            mm = np.round(s["depth"][v] * 1000.0).astype(np.int32)
            save(view(s, v, np.where(mm > 0, mm, 65535)), room + "_rgbd", f"frame_{v}.pth")
    for i, s in scenes(counts["ScanNet"], 20, SEED + 1000):
        name = f"scene{i:04d}_00"
        save(dict(coord=s["coord"], color=s["color"], normal=s["normal"],
                  semantic_gt20=s["segment"], instance_gt=s["instance"]),
             roots["scannet"], "train", f"{name}.pth")
        os.makedirs(os.path.join(roots["scannet_rgbd"], name), exist_ok=True)
        for v in range(views):
            np.savez(os.path.join(roots["scannet_rgbd"], name, f"{v:06d}.npz"),
                     color=s["rgb"][v].astype(np.uint8), depth=s["depth"][v],
                     pose=s["cam2world"][v].astype(np.float32),
                     intrinsic=s["intrinsic"][v].astype(np.float32),
                     label=s["semantic2d"][v].astype(np.int16))
    for i, s in scenes(counts["S3DIS"], 13, SEED + 2000):
        room = os.path.join(roots["s3dis"], S3DIS_TRAIN_AREAS[i % len(S3DIS_TRAIN_AREAS)],
                            f"office_{i}")
        save(dict(coord=s["coord"], color=s["color"].astype(np.uint8), normal=s["normal"],
                  semantic_gt=s["segment"].astype(np.int16)[:, None],
                  instance_gt=s["instance"].astype(np.int16)[:, None]), room + ".pth")
        for v in range(views):
            depth = np.round(s["depth"][v] * 4000.0).astype(np.uint16)
            save(view(s, v, depth), room + "_rgbd", f"cam{v}_0_{v}.pth")
    return roots


def multi_pretrain_options(roots, save_path, num_worker=None):
    """What a run of ``MULTI_CONFIG`` on the scenes of
    ``write_multidataset_scenes`` changes: the data roots, one epoch
    (``epoch`` = ``eval_epoch`` = 1: one round of 4 batches), the save path
    and, where given, ``num_worker``. Model widths, conditions, transforms,
    batch, point budget, dtype, optimizer and schedule stay the config's,
    the backbone's ``remat`` too (on by default, as in the JAX package;
    without it the first step runs out of the H100's 80 GB)."""
    opts = {"data.train.datasets.0.data_root": roots["structured3d"],
            "data.train.datasets.1.data_root": roots["scannet"],
            "data.train.datasets.1.rgbd_root": roots["scannet_rgbd"],
            "data.train.datasets.2.data_root": roots["s3dis"],
            "epoch": 1, "eval_epoch": 1, "save_path": save_path}
    if num_worker is not None:
        opts["num_worker"] = num_worker
    return opts


def multi_pretrain_phase(dev, tmp, gen, stats):
    """Phase 15: the paper's multi-dataset pretrain from files. Writes the
    scenes, trains one epoch (4 steps) through ``tools/train_torch.py:
    main_worker`` with the K1-K5 counts set to 0 first, and checks the steps
    (conditions in order, the class subset each used, the lr against
    OneCycle over 4 steps, losses, ``contract_ok``, K1-K3 launches against
    each batch's routing); holds K1-K3 against their plain versions at the
    first batch's convs (timed in f32 into ``stats``), each K1-K3 call of a
    step against float64, and one step's grads from the seeded state, kernel
    path against plain. Returns the run's launches and times."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.engines.common import split_batch, with_condition
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops import windowed_gather as wg
    from ponderv2_tpu_torch.ops.sparse import maybe_sort_by_key
    from ponderv2_tpu_torch.utils.scheduler import build_scheduler
    from train_torch import main_worker

    t0 = time.perf_counter()
    roots = write_multidataset_scenes(os.path.join(tmp, "multi_data"))
    h, w = MULTI_VIEW_HW
    print(f"[multi] wrote {MULTI_SCENES} rooms or scenes of 100,000 points, {MULTI_VIEWS} "
          f"views of {h} x {w} each, in each dataset's layout in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- train one epoch: one round, Structured3D x2, ScanNet, S3DIS
    cpus = os.cpu_count()
    num_worker = None if cpus >= 3 * 24 else max(1, cpus // 3)
    cfg = default_config_parser(MULTI_CONFIG, multi_pretrain_options(
        roots, os.path.join(tmp, "multi_train"), num_worker))
    cfg.seed = SEED
    cfg.device = str(dev)
    print(f"[multi] os.cpu_count() {cpus}: num_worker {cfg.num_worker} per dataset "
          f"(the config's 24 for each of 3 loaders wants 72)")
    records = {"steps": [], "conditions": [], "batches": []}
    cfg.hooks = list(cfg.hooks) + [dict(type=step_probe(records))]
    torch.cuda.reset_peak_memory_stats(dev)
    for k in bc.KERNELS + wg.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    trainer = main_worker(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = [k.launches for k in bc.KERNELS]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    model, steps = trainer.model, records["steps"]
    spunet = model.backbone
    print(f"[multi] {len(steps)} steps in {train_s:.2f} s; launches (K1, K2, K3) "
          f"{launches}; peak memory {peak_gib:.3f} GiB; backbone remat {spunet.remat}")
    check(len(steps) == len(trainer.train_loader) == len(MULTI_ORDER),
          f"multi: {len(steps)} steps, len(train_loader) {len(trainer.train_loader)}")
    check(records["conditions"] == MULTI_ORDER,
          f"multi: conditions that reached the model {records['conditions']}")
    subsets = [len(model.valid_index[model.conditions.index(c)]) for c in MULTI_ORDER]
    n_emb = model.class_embedding.shape[0]
    check(subsets == [25, 25, 20, 13] and n_emb == 36,
          f"multi: class subsets {subsets} of {n_emb} rows")
    schedule = build_scheduler(dict(cfg.scheduler), len(MULTI_ORDER))

    step_ms = [1e3 * (b - d) for (b, _), (d, _) in zip(
        trainer.storage.history("batch_time").values(),
        trainer.storage.history("data_time").values())]
    data_ms = [1e3 * d for d, _ in trainer.storage.history("data_time").values()]
    first = None
    for i, (m, batch) in enumerate(zip(steps, records["batches"])):
        arrays, static = split_batch(batch)
        inputs = with_condition({k: torch.as_tensor(v, device=dev)
                                 for k, v in arrays.items()}, static)
        inputs.update(trainer.static_ctx)
        st, _ = maybe_sort_by_key(batch_to_sparse_tensor(inputs))
        level_rb, level_coords, _ = level_plans(spunet, st)
        convs, fused, per_step = band_routing(spunet, level_rb)
        live = int((inputs["batch"] >= 0).sum())
        terms = {k: float(v) for k, v in records["terms"][i].items()}
        print(f"[multi] step {i} ({static['condition'][0]}, {subsets[i]} classes of "
              f"{n_emb}): loss {m['loss']:.6f} lr {m['lr']:.6e} contract_ok "
              f"{m['contract_ok']} launches {m['launches']} (routing {per_step}: "
              f"{sum(convs.values())} band convs, {per_step[1]} fused); {live} live rows; "
              f"step {step_ms[i]:.1f} ms, data wait {data_ms[i]:.1f} ms; "
              + " ".join(f"{k} {v:.4f}" for k, v in terms.items() if k != "loss"))
        check(static["condition"] == [MULTI_ORDER[i]] * cfg.batch_size,
              f"multi step {i}: batch conditions {static['condition']}")
        check(np.isfinite(m["loss"]) and "ppt_loss" in terms
              and all(np.isfinite(v) for v in terms.values()),
              f"multi step {i}: loss terms {m['loss']} {terms}")
        check(m["contract_ok"] == 1.0, f"multi step {i} contract_ok False")
        check(m["lr"] == m["schedule_lr"] and abs(m["lr"] - schedule(i)) <= 1e-12 * m["lr"],
              f"multi step {i} lr {m['lr']} != OneCycle over 4 steps {schedule(i)}")
        check(m["launches"] == per_step + [0, 0],
              f"multi step {i} launches {m['launches']} != routing {per_step}")
        if first is None:
            first = (inputs, level_rb, level_coords, convs, fused, per_step)
        else:
            del inputs, st, level_rb, level_coords
    del records["batches"]
    by_cond = {}
    for c, ms in zip(MULTI_ORDER, step_ms):
        by_cond.setdefault(c, []).append(ms)
    print(f"[time] multi-dataset pretrain step by condition (host clock, batch to device .. "
          f"metrics synced): " + "; ".join(f"{c} {', '.join(f'{v:.1f}' for v in ms)} ms"
                                           for c, ms in by_cond.items())
          + f"; data wait {', '.join(f'{v:.1f}' for v in data_ms)} ms")
    print(f"[memory] multi-dataset pretrain peak {peak_gib:.3f} GiB")
    check(launches == [sum(m["launches"][j] for m in steps) for j in range(3)],
          f"multi: launches {launches} outside the steps")
    gmodel_cfg = dict(cfg.model)
    del trainer, model, steps
    gc.collect()
    torch.cuda.empty_cache()

    # ---- K1, K2, K3 against their plain versions at the first batch's convs
    inputs, level_rb, level_coords, convs, fused, per_step = first
    compare_band_kernels(convs, fused, level_rb, level_coords, gen, torch.float32, stats,
                         fwd_runs=2 if spunet.remat else 1)
    del level_rb, level_coords
    gc.collect()
    torch.cuda.empty_cache()

    # ---- each K1-K3 call of a step against float64, and the step's grads
    # from the seeded state, kernel path against plain (phase 8's bound; if
    # it fails, phase 14's float64 form)
    gmodel = build_model(gmodel_cfg)
    gmodel.reset_parameters(torch.Generator().manual_seed(SEED))
    gmodel.to(dev).train()
    B, V, H, W = inputs["depth"].shape
    draws = gmodel.draw_noise(torch.Generator(device=dev).manual_seed(SEED), B, V, H * W)
    inputs = {**inputs, "draws": draws}
    tag = "multi-dataset pretrain step from the seeded state (f32)"
    calls_vs_float64(tag, gmodel, inputs)
    holds = grads_either_bound(tag, gmodel, inputs, per_step)
    del gmodel, inputs, draws
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_launches": launches, "peak_gib": peak_gib, "step_ms": step_ms,
            "data_ms": data_ms, "grads_bound": holds}


def insseg_recipe_options(data_root, save_path):
    """What a run of ``INSSEG_CONFIG`` on scenes under ``data_root``
    changes: the data roots, one epoch with one evaluation (3 steps of the 36
    train scenes, then the 4 val scenes), no pretrained weight (the recipe's
    checkpoint is not in the repo) and the save path. Model, criteria,
    optimizer, scheduler, transforms, batch, point budgets and
    ``num_worker`` stay the recipe's."""
    return {"data.train.data_root": data_root, "data.val.data_root": data_root,
            "epoch": 1, "eval_epoch": 1, "weight": None, "save_path": save_path}


def oracle_predictions(batch, num_classes, shrink):
    """A val batch's ground truth as a model's output: one-hot logits of
    ``segment``, and offsets that move each instance's rows ``shrink`` of
    the way to its centroid (``shrink`` x (``instance_centroid`` - ``coord``)
    on rows of an instance, 0 elsewhere)."""
    import numpy as np

    seg = np.asarray(batch["segment"])
    logits = np.zeros((len(seg), num_classes), np.float32)
    rows = np.nonzero(seg >= 0)[0]
    logits[rows, seg[rows]] = 1.0
    coord = np.asarray(batch["coord"], np.float32)
    gt_bias = np.asarray(batch["instance_centroid"], np.float32) - coord
    bias = np.where((np.asarray(batch["instance"]) >= 0)[:, None],
                    np.float32(shrink) * gt_bias, np.float32(0))
    return logits, bias


def insseg_oracle(model, val_batches, num_classes, segment_ignore):
    """The clustering and the AP matching on the val batches with the ground
    truth as predictions (``oracle_predictions``). With the full offset
    every row of an instance lands on its centroid, so each row's neighbour
    list is the instance's first ``NEIGHBOR_CAP`` rows and the BFS reaches
    those only: each proposal must be exactly those rows of one instance
    (on the first batch: the native BFS checks every pair of an instance's
    rows, ~1e8 for each of these instances). With half the offset the rows
    stay apart and each instance is one proposal: mAP50 must be 1.0 over
    all batches. Returns ({shrink: AP result}, the half offset's inputs of
    the first scene for the native-vs-plain check)."""
    import numpy as np

    from ponderv2_tpu_torch.engines.hooks.evaluator import evaluate_instance_ap, split_scenes
    from ponderv2_tpu_torch.models.point_group.cluster import NEIGHBOR_CAP

    results, first = {}, None
    for shrink in (1.0, 0.5):
        preds, gts, n_props, n_capped = [], [], 0, 0
        for batch in val_batches[:1] if shrink == 1.0 else val_batches:
            logits, bias = oracle_predictions(batch, num_classes, shrink)
            coord, rows = np.asarray(batch["coord"], np.float32), np.asarray(batch["batch"])
            proposals = model.propose_instances(coord, logits, bias, rows)
            if shrink == 1.0:
                inst = np.where(rows >= 0, np.asarray(batch["instance"]), -1)
                for p in proposals:
                    owner = inst[np.argmax(p["mask"])]
                    members = np.nonzero(inst == owner)[0]
                    want = np.zeros(len(inst), bool)
                    want[members[:NEIGHBOR_CAP]] = True
                    check(owner >= 0 and np.array_equal(p["mask"], want),
                          f"insseg oracle (full offset): a proposal of {int(p['mask'].sum())} "
                          f"rows is not the first {NEIGHBOR_CAP} of instance {owner} "
                          f"({len(members)} rows)")
                    n_capped += len(members) > NEIGHBOR_CAP
            elif first is None:
                valid = (rows == rows[rows >= 0].min()) & ~np.isin(
                    logits.argmax(-1), segment_ignore)
                first = ((coord + bias)[valid], logits.argmax(-1)[valid])
            p_, g_ = split_scenes(batch, proposals)
            preds += p_
            gts += g_
            n_props += len(proposals)
        res = evaluate_instance_ap(preds, gts, num_classes, segment_ignore)
        results[shrink] = res
        print(f"[insseg] oracle ({shrink:g} x the offset to the centroid): {n_props} "
              f"proposals over {len(gts)} scenes; mAP / mAP50 / mAP25 {res['mAP']:.4f} / "
              f"{res['mAP50']:.4f} / {res['mAP25']:.4f}"
              + (f"; {n_capped} proposals cut to the first {NEIGHBOR_CAP} rows of an "
                 "instance of more (the neighbour cap)" if shrink == 1.0 else ""))
    check(results[0.5]["mAP50"] == 1.0,
          f"insseg oracle (half offset): mAP50 {results[0.5]['mAP50']} != 1.0")
    return results, first


def insseg_recipe_phase(dev, tmp, gen, stats):
    """Phase 16: the paper's ScanNet instance-segmentation recipe from scene
    files with instance labels. Trains 3 steps and one evaluation
    (``train_and_check``, the ``InsSegEvaluator`` of the recipe), prints each
    step and each val scene, checks the condition that reached the model,
    re-scores the evaluator's proposals, holds the clustering and the AP
    with the ground truth as predictions (``insseg_oracle``) and the native
    clustering against its plain version, then K1-K3 (timed in f32 into
    ``stats``) and the seeded first batch's grads against their plain
    versions. Returns the run's launches and times."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.engines.hooks.evaluator import evaluate_instance_ap, split_scenes
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.models.point_group import cluster

    data_root = os.path.join(tmp, "insseg_scannet")
    t0 = time.perf_counter()
    write_scannet_scenes(data_root, INSSEG_TRAIN_SCENES, INSSEG_VAL_SCENES, instances=True)
    print(f"[insseg] wrote {INSSEG_TRAIN_SCENES} train + {INSSEG_VAL_SCENES} val scenes of "
          f"100,000 points with one instance per box in ScanNet's layout in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- train 3 steps + one evaluation (InsSegEvaluator)
    cfg = default_config_parser(INSSEG_CONFIG, insseg_recipe_options(
        data_root, os.path.join(tmp, "insseg_train")))
    cfg.seed = SEED
    cfg.device = str(dev)
    cluster.NATIVE.launches = 0
    records = {"steps": [], "conditions": [], "batches": [], "peaks": [], "val": []}
    run = train_and_check("insseg", cfg, dev, records, val_metric="val/mAP50")
    native_launches = cluster.NATIVE.launches
    model = run.model
    model.__dict__.pop("propose_instances", None)  # the probe's timing wrapper
    check(type(model).__name__ == "PointGroup" and model.backbone.backbone_mode
          and type(model.backbone).__name__ == "PointPromptTraining",
          f"insseg model {type(model).__name__} over {type(model.backbone).__name__}")
    n_forwards = 3 + run.n_val
    check(records["conditions"] == [PPT_CONDITION] * n_forwards,
          f"insseg: conditions that reached the model {records['conditions']}")
    for i, (m, batch) in enumerate(zip(records["steps"], records["batches"])):
        terms = {k: float(v) for k, v in records["terms"][i].items()}
        live = int((np.asarray(batch["batch"]) >= 0).sum())
        print(f"[insseg] step {i}: {run.step_times_ms[i]:.1f} ms, data wait "
              f"{run.data_ms[i]:.1f} ms, peak {records['peaks'][i] / 2 ** 30:.3f} GiB, {live} "
              f"live rows, contract_ok {m['contract_ok']}, launches {m['launches']}; "
              + " ".join(f"{k} {terms[k]:.6f}" for k in INSSEG_TERMS))
        check(all(np.isfinite(terms[k]) for k in INSSEG_TERMS + ("loss",)),
              f"insseg step {i}: loss terms {terms}")
    print(f"[insseg] every forward ({n_forwards}) got condition {PPT_CONDITION!r}")
    del records["batches"]

    # ---- the evaluation: each val scene, and the evaluator's mAP re-scored
    num_classes = cfg.data.num_classes
    ignore = tuple(cfg.model.segment_ignore_index)
    val = records["val"]
    check(len(val) == INSSEG_VAL_SCENES == run.n_val, f"insseg: {len(val)} val forwards")
    preds, gts, want_native = [], [], 0
    eval_ms = {"forward": [], "cluster": [], "ap": []}
    for j, v in enumerate(val):
        p_, g_ = split_scenes(v["batch"], v["proposals"])
        t = time.perf_counter()
        res = evaluate_instance_ap(p_, g_, num_classes, ignore)
        ap_s = time.perf_counter() - t
        rows = np.asarray(v["batch"]["batch"])
        classes = v["out"]["seg_logits"].argmax(-1).cpu().numpy()
        want_native += bool((~np.isin(classes[rows >= 0], ignore)).any())
        for key, sec in (("forward", v["seconds"]), ("cluster", v["cluster_s"]), ("ap", ap_s)):
            eval_ms[key].append(1e3 * sec)
        print(f"[insseg] val scene {j}: {int((rows >= 0).sum())} rows; forward "
              f"{1e3 * v['seconds']:.1f} ms, clustering {1e3 * v['cluster_s']:.1f} ms on the "
              f"host, {len(v['proposals'])} proposals, AP {1e3 * ap_s:.1f} ms (this scene's "
              f"mAP50 {res['mAP50']:.4f})")
        preds += p_
        gts += g_
    res = evaluate_instance_ap(preds, gts, num_classes, ignore)
    scores = {k: run.val_scalars[f"val/{k}"] for k in ("mAP", "mAP50", "mAP25")}
    print(f"[insseg] InsSegEvaluator over {len(gts)} val scenes: mAP / mAP50 / mAP25 "
          f"{scores['mAP']:.4f} / {scores['mAP50']:.4f} / {scores['mAP25']:.4f} (random-init "
          f"weights after 3 steps); native clustering calls {native_launches}")
    check(all(np.isfinite(v) for v in scores.values())
          and all(res[k] == v for k, v in scores.items()),
          f"insseg: evaluator {scores}, its proposals re-scored {res}")
    check(native_launches == want_native,
          f"insseg: {native_launches} native clustering calls, {want_native} scenes to cluster")

    # ---- the clustering and the AP on the ground truth, and native vs plain
    oracle, (pts, classes) = insseg_oracle(model, [v["batch"] for v in val], num_classes,
                                           ignore)
    radius = model.cluster_thresh * model.voxel_size
    cases = [("oracle (half offset)", pts, classes)]
    v = val[0]
    rows = np.asarray(v["batch"]["batch"])
    pred = v["out"]["seg_logits"].argmax(-1).cpu().numpy()
    sel = (rows == rows[rows >= 0].min()) & ~np.isin(pred, ignore)
    shifted = (np.asarray(v["batch"]["coord"], np.float32)
               + v["out"]["bias_pred"].float().cpu().numpy())[sel]
    tree = cKDTree(shifted) if sel.any() else None
    pairs = int(tree.count_neighbors(tree, radius)) if tree is not None else 0
    if 0 < pairs <= INSSEG_PLAIN_PAIRS:
        cases.append(("the trained model's", shifted, pred[sel]))
    else:
        print(f"[insseg] native vs plain on the trained model's val scene 0 not run: "
              f"{pairs} neighbour pairs within the radius (plain run limit "
              f"{INSSEG_PLAIN_PAIRS})")
    for label, x, c in cases:
        t = time.perf_counter()
        ids_n, n_n = cluster.bfs_cluster(x, c, radius, model.cluster_min_points)
        t_n = time.perf_counter() - t
        t = time.perf_counter()
        ids_p, n_p = cluster.bfs_cluster_plain(x, c, radius, model.cluster_min_points)
        t_p = time.perf_counter() - t
        check(n_n == n_p and np.array_equal(ids_n, ids_p),
              f"insseg: native clustering vs plain on {label} val scene 0: {n_n} vs {n_p} "
              f"clusters, {int((ids_n != ids_p).sum())} ids differ")
        print(f"[insseg] native clustering vs plain on {label} val scene 0 ({len(x)} points): "
              f"equal ids, {n_n} clusters; native {1e3 * t_n:.1f} ms, plain {1e3 * t_p:.1f} ms")
    del val, records["val"], v
    gc.collect()
    torch.cuda.empty_cache()

    # ---- K1, K2, K3 against their plain versions at the first batch's convs
    compare_band_kernels(run.convs, run.fused, run.level_rb, run.level_coords, gen,
                         torch.float32, stats)

    # ---- the seeded first batch's grads, kernel path against plain (phase
    # 8's bound; if it fails, phase 14's float64 form), the heads' included
    gmodel = build_model(dict(cfg.model))
    gmodel.reset_parameters(torch.Generator().manual_seed(SEED))
    gmodel.to(dev).train()
    check({"bias_head.0.weight", "bias_head.2.weight", "seg_head.weight"}
          <= {n for n, _ in gmodel.named_parameters()}, "insseg: the heads' parameters")
    tag = "insseg step from the seeded state (f32)"
    holds = grads_either_bound(tag, gmodel, run.b_inputs, run.per_step)
    out = {"train_launches": run.launches, "peak_gib": run.peak_gib,
           "step_ms": run.step_times_ms, "data_ms": run.data_ms, "eval_ms": eval_ms,
           "scores": scores, "oracle_mAP50": {k: r["mAP50"] for k, r in oracle.items()},
           "grads_bound": holds}
    del gmodel, run, model
    gc.collect()
    torch.cuda.empty_cache()
    return out



def nuscenes_options(config, data_root, save_path, num_worker, weight=None):
    """What a run of a nuScenes config (``NUSCENES_PRETRAIN`` /
    ``NUSCENES_SEMSEG``) on ``write_synthetic_nuscenes``'s scans changes: its
    data roots, one epoch (``epoch`` = ``eval_epoch`` = 1), the save path,
    ``num_worker`` (the configs' 16 want 16 CPUs) and, for the fine-tune,
    the pretrain checkpoint as ``weight``. Model, transforms, batch, point
    budgets, optimizer and schedule stay the config's."""
    opts = {"data.train.data_root": data_root, "epoch": 1, "eval_epoch": 1,
            "save_path": save_path, "num_worker": num_worker}
    if config == NUSCENES_SEMSEG:
        opts.update({"data.val.data_root": data_root, "data.test.data_root": data_root,
                     "weight": weight})
    return opts


def nuscenes_num_worker(config_workers):
    """The config's ``num_worker``, cut to the host's CPUs less two."""
    return max(1, min(int(config_workers), (os.cpu_count() or 1) - 2))


def band_levels_report(tag, spunet, level_rb, spatial_shape, batch_size):
    """Per level of ``level_rb``: its cells (batch x X x Y x Z against the
    192 Mi dense-grid limit), its plan (a SubmPlan, or a plain rulebook),
    the routes its k3 convs take and, where a band plan runs (attached, or
    built inline as ``SubMConv`` builds it), its final budgets after the
    doublings and its live overflow entries. Prints one line; checks every
    band plan's ``ok``; returns the levels that run K1-K3."""
    import math
    from collections import Counter

    from ponderv2_tpu_torch.models.sparse_unet.layers import subm_route
    from ponderv2_tpu_torch.models.sparse_unet.plans import level_spatial_shapes
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.hashing import DENSE_GRID_LIMIT
    from ponderv2_tpu_torch.ops.spconv import SubmPlan

    shapes = level_spatial_shapes(spatial_shape, spunet.num_stages)
    parts, band_levels = [], []
    for level, rb in enumerate(level_rb):
        blocks = ([spunet.enc[level - 1]] if level >= 1 else []) + (
            [spunet.dec[level]] if level < spunet.num_stages else [])
        convs = [c for bl in blocks for b in bl.values() for c in (b.conv1, b.conv2)]
        routes = Counter(subm_route(rb, c.in_channels, c.out_channels, 3) for c in convs)
        X, Y, Z = shapes[level]
        cells = batch_size * X * Y * Z
        plan = rb.band if isinstance(rb, SubmPlan) else (
            bc.build_band_plan_auto(rb, 3) if routes.get("band-inline") else None)
        text = (f"L{level} {X}x{Y}x{Z} x{batch_size} = {cells:.3g} cells "
                f"({'<=' if cells <= DENSE_GRID_LIMIT else '>'} 192 Mi): "
                f"{'SubmPlan' if isinstance(rb, SubmPlan) else 'rulebook'}, "
                + ", ".join(f"{n} {r}" for r, n in sorted(routes.items())))
        if plan is not None:
            budget = plan.ov_i.shape[0]
            doublings = round(math.log2(budget / bc.ENTRY_BUDGET))
            text += (f"; band budgets pair {bc.PAIR_BUDGET << doublings} entry {budget} "
                     f"({doublings} doublings), {sum(plan.ov_counts)} overflow entries, "
                     f"ok {bool(plan.ok)}")
            check(bool(plan.ok), f"{tag}: L{level} band plan overflows its budgets after "
                                 f"{doublings} doublings")
            band_levels.append(level)
        parts.append(text)
    print(f"[{tag}] per level (the k5 stem at L0 runs the plain gather conv): "
          + "; ".join(parts))
    return band_levels


def rulebook_convs_ms(tag, spunet, level_rb, stem, level_coords, gen):
    """Forward + backward ms (CUDA events) of the convs that run the plain
    gather conv (``ops/spconv.py:subm_conv_symmetric``) in one step: the k5
    stem and every k3 conv whose route is plain or slab, at its rows and
    widths, on random features. Prints and returns their sum."""
    import torch

    from ponderv2_tpu_torch.models.sparse_unet.layers import subm_route
    from ponderv2_tpu_torch.ops.spconv import SubmPlan, subm_conv_symmetric

    def legacy(rb):
        return rb.legacy if isinstance(rb, SubmPlan) else rb

    stem_conv = spunet.conv_input[0]
    cases = [("stem k5", legacy(stem), level_coords[0], stem_conv.in_channels,
              stem_conv.out_channels, 1)]
    for level, rb in enumerate(level_rb):
        blocks = ([spunet.enc[level - 1]] if level >= 1 else []) + (
            [spunet.dec[level]] if level < spunet.num_stages else [])
        plain = [c for bl in blocks for b in bl.values() for c in (b.conv1, b.conv2)
                 if not subm_route(rb, c.in_channels, c.out_channels, 3).startswith("band")]
        if plain:
            cases.append((f"L{level} k3", legacy(rb), level_coords[level],
                          plain[0].in_channels, plain[0].out_channels, len(plain)))
    total, parts = 0.0, []
    for label, rulebook, coords, cin, cout, count in cases:
        mask = coords[:, 0] >= 0
        f = (torch.randn(coords.shape[0], cin, device=coords.device, generator=gen)
             * mask[:, None]).requires_grad_()
        w = (torch.randn(rulebook.shape[0], cin, cout, device=coords.device, generator=gen)
             / (rulebook.shape[0] * cin) ** 0.5).requires_grad_()

        def fwd_bwd():
            subm_conv_symmetric(f, rulebook, w, mask, None).sum().backward()

        ms = cuda_ms(fwd_bwd, 3)
        total += count * ms
        parts.append(f"{label} {cin}->{cout} x{count} over {int(mask.sum())} rows "
                     f"{ms:.2f} ms")
    print(f"[{tag}] the plain gather convs of a step, forward + backward (CUDA events): "
          + "; ".join(parts) + f"; {total:.1f} ms a step")
    return total


def nuscenes_host_ms(cfg, scans=2):
    """Host ms per scan of the pretrain's data path, in this process: the
    file reads (the LiDAR and six PNG decodes, ``get_data``), then each
    transform of the config's pipeline (``ProjectOnImage``'s per-camera
    z-buffer loop among them). Prints one line per scan."""
    import numpy as np

    from ponderv2_tpu_torch.datasets import build_dataset

    ds = build_dataset(dict(cfg.data.train))
    state = np.random.get_state()
    np.random.seed(SEED)
    try:
        for i in range(scans):
            t = time.perf_counter()
            data = ds.get_data(i)
            times = [("read", time.perf_counter() - t)]
            for tf in ds.transform.transforms:
                t = time.perf_counter()
                data = tf(data)
                times.append((type(tf).__name__, time.perf_counter() - t))
            print(f"[nuscenes] host ms for scan {i}: " + ", ".join(
                f"{k} {1e3 * v:.1f}" for k, v in times)
                + f"; {1e3 * sum(v for _, v in times):.1f} in all")
    finally:
        np.random.set_state(state)


def nuscenes_pretrain_phase(dev, tmp, gen, stats):
    """Phase 17: the paper's nuScenes LiDAR pretrain from files. Writes
    ``NUSCENES_PRETRAIN_SCANS`` + ``NUSCENES_ONE_STEP_SCANS`` procedural
    scans with six cameras each; trains the base config 3 steps at batch 4
    (``train_and_check``), prints each step and the levels' plans, holds
    K1-K3 against their plain versions at the first batch's convs (timed in
    f32 into ``stats``), every K1-K3 call of a step against float64 and the
    seeded step's grads, kernel path against plain; then one step of each
    other pretrain config. Returns the run's launches and times and the
    base run's checkpoint."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.datasets.preprocessing.synthetic_nuscenes import (
        IMAGE_HW, write_synthetic_nuscenes)
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.utils.config import Config

    root, root_one = (os.path.join(tmp, d) for d in ("nuscenes", "nuscenes_one"))
    workers = nuscenes_num_worker(Config.fromfile(NUSCENES_PRETRAIN["base"]).num_worker)
    t0 = time.perf_counter()
    write_synthetic_nuscenes(root, {"train": NUSCENES_PRETRAIN_SCANS}, SEED, workers=workers)
    write_synthetic_nuscenes(root_one, {"train": NUSCENES_ONE_STEP_SCANS}, SEED + 1,
                             workers=workers)
    print(f"[nuscenes] wrote {NUSCENES_PRETRAIN_SCANS} + {NUSCENES_ONE_STEP_SCANS} "
          f"procedural LiDAR scans (32 beams, six {IMAGE_HW[1]} x {IMAGE_HW[0]} PNG "
          f"cameras each) in {time.perf_counter() - t0:.1f} s")

    runs = {}
    for name, config in NUSCENES_PRETRAIN.items():
        base = name == "base"
        cfg = default_config_parser(config, nuscenes_options(
            config, root if base else root_one,
            os.path.join(tmp, f"nuscenes_{name}"), workers))
        cfg.seed = SEED
        cfg.device = str(dev)
        tag = f"nuscenes-{name}"
        if base:
            print(f"[nuscenes] os.cpu_count() {os.cpu_count()}: num_worker {cfg.num_worker} "
                  f"(the config's 16)")
            nuscenes_host_ms(cfg)
        records = {"steps": [], "conditions": [], "batches": [], "peaks": []}
        run = train_and_check(tag, cfg, dev, records, val_metric=None,
                              steps_expected=3 if base else 1)
        spunet = spunet_of(run.model)
        for i, (m, batch) in enumerate(zip(records["steps"], records["batches"])):
            terms = {k: float(v) for k, v in records["terms"][i].items()}
            live = int((np.asarray(batch["batch"]) >= 0).sum())
            print(f"[{tag}] step {i}: {run.step_times_ms[i]:.1f} ms, data wait "
                  f"{run.data_ms[i]:.1f} ms, peak {records['peaks'][i] / 2 ** 30:.3f} GiB, "
                  f"{live} live rows, {batch['ray_start'].shape[1]} rays a scan; "
                  + " ".join(f"{k} {v:.5f}" for k, v in terms.items()))
            check(all(np.isfinite(v) for v in terms.values())
                  and set(cfg.metric_keys) - {"psnr"} <= set(terms),
                  f"{tag} step {i}: loss terms {terms}")
        if name == "base-semantic":
            emb = run.model.class_embedding
            print(f"[{tag}] the semantic head's class embeddings: {tuple(emb.shape)} from "
                  "assets/clip_text/nuscenes16.npy, a deterministic stub (no CLIP weights "
                  "in the repository)")
        band_levels = band_levels_report(tag, spunet, run.level_rb, cfg.sparse_shape,
                                         cfg.batch_size)
        runs[name] = dict(launches=run.launches, step_ms=run.step_times_ms,
                          data_ms=run.data_ms, peak_gib=run.peak_gib,
                          band_levels=band_levels, per_step=run.per_step)
        if not base:
            del run, records
            gc.collect()
            torch.cuda.empty_cache()
            continue
        ckpt_path = run.ckpt_path
        _, _, stem = level_plans(spunet, run.st)
        rulebook_ms = rulebook_convs_ms(tag, spunet, run.level_rb, stem, run.level_coords,
                                        gen)
        compare_band_kernels(run.convs, run.fused, run.level_rb, run.level_coords, gen,
                             torch.float32, stats, fwd_runs=2 if spunet.remat else 1)
        b_inputs, per_step, model_cfg = run.b_inputs, run.per_step, dict(cfg.model)
        del run, records, stem
        gc.collect()
        torch.cuda.empty_cache()

        # each K1-K3 call of a step against float64, and the seeded step's
        # grads, kernel path against plain (phase 8's bound; if it fails,
        # phase 14's float64 form)
        gmodel = build_model(model_cfg)
        gmodel.reset_parameters(torch.Generator().manual_seed(SEED))
        gmodel.to(dev).train()
        B, R = b_inputs["ray_start"].shape[:2]
        inputs = {**b_inputs, "draws": gmodel.draw_noise(
            torch.Generator(device=dev).manual_seed(SEED), B, R)}
        gtag = "nuscenes pretrain step from the seeded state (f32)"
        calls_vs_float64(gtag, gmodel, inputs)
        holds = grads_either_bound(gtag, gmodel, inputs, per_step)
        runs[name].update(rulebook_ms=rulebook_ms, grads_bound=holds)
        del gmodel, inputs, b_inputs
        gc.collect()
        torch.cuda.empty_cache()
    return {"runs": runs, "train_launches": runs["base"]["launches"], "ckpt": ckpt_path}


def nuscenes_semseg_phase(dev, tmp, gen, stats, weight):
    """Phase 18: the paper's nuScenes lidarseg fine-tune from files, from
    phase 17's checkpoint (``weight``). Writes ``NUSCENES_SEMSEG_SCANS`` +
    ``NUSCENES_VAL_SCANS`` scans (no cameras), trains 3 steps at batch 12
    and one evaluation (``train_and_check``), checks which checkpoint
    entries loaded, prints each step and the levels' plans, serves the val
    scans through ``SemSegTester`` (``serve_and_check``), holds K1-K3
    against their plain versions at the first batch's convs (timed in f32
    into ``stats``), the seeded step's grads as phases 15-17 do with every
    relu pinned to the plain path's decisions (``PinnedRelu``), and the
    trained step's grads as phase 14 does (every K1-K3 call and the grads
    against float64). Returns the run's launches and times."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.datasets.preprocessing.synthetic_nuscenes import (
        write_synthetic_nuscenes)
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.utils.config import Config

    root = os.path.join(tmp, "nuscenes_semseg")
    workers = nuscenes_num_worker(Config.fromfile(NUSCENES_SEMSEG).num_worker)
    t0 = time.perf_counter()
    write_synthetic_nuscenes(root, {"train": NUSCENES_SEMSEG_SCANS,
                                    "val": NUSCENES_VAL_SCANS}, SEED + 2, cameras=False,
                             workers=workers)
    print(f"[nuscenes-semseg] wrote {NUSCENES_SEMSEG_SCANS} + {NUSCENES_VAL_SCANS} "
          f"procedural LiDAR scans in {time.perf_counter() - t0:.1f} s")
    cfg = default_config_parser(NUSCENES_SEMSEG, nuscenes_options(
        NUSCENES_SEMSEG, root, os.path.join(tmp, "nuscenes_semseg_train"), workers, weight))
    cfg.seed = SEED
    cfg.device = str(dev)
    tag = "nuscenes-semseg"
    records = {"steps": [], "conditions": [], "batches": [], "peaks": []}
    run = train_and_check(tag, cfg, dev, records)
    report = run.weight_load
    pretrained = torch.load(weight, map_location="cpu", weights_only=True)["state_dict"]
    print(f"[{tag}] weight {weight}: {len(report['loaded'])} entries loaded, all "
          f"backbone.*; skipped {len(report['skipped'])} of the checkpoint "
          f"({', '.join(sorted({k.split('.')[0] for k in report['skipped']}))}: "
          f"{report['skipped']}); the model's {report['missing']} not in it")
    want = sorted(k for k in pretrained if k.startswith("backbone."))
    check(report["loaded"] == want and report["missing"] == ["backbone.final.bias",
                                                             "backbone.final.weight"]
          and not any(k.startswith("backbone.") for k in report["skipped"]),
          f"{tag}: weight load {len(report['loaded'])} loaded, missing {report['missing']}")
    moved = [k for k in want if "running" in k
             and not torch.equal(records["running_before"][k].cpu(), pretrained[k])]
    check(not moved, f"{tag}: running statistics at step 0 differ from the checkpoint: "
                     f"{moved[:3]}")
    for i, (m, batch) in enumerate(zip(records["steps"], records["batches"])):
        live = int((np.asarray(batch["batch"]) >= 0).sum())
        print(f"[{tag}] step {i}: {run.step_times_ms[i]:.1f} ms, data wait "
              f"{run.data_ms[i]:.1f} ms, peak {records['peaks'][i] / 2 ** 30:.3f} GiB, "
              f"{live} live rows, loss {m['loss']:.6f}")
    spunet = spunet_of(run.model)
    band_levels = band_levels_report(tag, spunet, run.level_rb, cfg.sparse_shape,
                                     cfg.batch_size)
    _, _, stem = level_plans(spunet, run.st)
    rulebook_ms = rulebook_convs_ms(tag, spunet, run.level_rb, stem, run.level_coords, gen)
    del stem, records

    # ---- serve the val scans through SemSegTester with the trained weights
    tcfg = default_config_parser(NUSCENES_SEMSEG, nuscenes_options(
        NUSCENES_SEMSEG, root, os.path.join(tmp, "nuscenes_semseg_test"), workers,
        run.ckpt_path))
    tcfg.seed = SEED
    tcfg.device = str(dev)
    served = serve_and_check("nuscenes-serve", tcfg, dev)
    frag_ms = [1e3 * t for t in served.tester.fragment_seconds]
    print(f"[nuscenes-serve] {NUSCENES_VAL_SCANS} val scans, {served.forwards} fragments "
          f"(GridSample test mode, one rotation, no crop) at the point budget "
          f"{tcfg.get('point_budget_test', tcfg.point_budget)}: "
          f"{', '.join(f'{t:.1f}' for t in frag_ms)} ms a fragment (host to logits)")
    serve_launches = served.launches
    del served

    compare_band_kernels(run.convs, run.fused, run.level_rb, run.level_coords, gen,
                         torch.float32, stats, fwd_runs=2 if spunet.remat else 1)
    b_inputs, per_step, state = run.b_inputs, run.per_step, run.state
    out = {"train_launches": run.launches, "serve_launches": serve_launches,
           "step_ms": run.step_times_ms, "data_ms": run.data_ms, "peak_gib": run.peak_gib,
           "band_levels": band_levels, "rulebook_ms": rulebook_ms, "fragment_ms": frag_ms}
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the seeded first batch's grads, kernel path against plain, as
    # phases 15-17 hold theirs, with every relu taking the plain path's
    # decisions: in this seeded state an activation of dec.2.block1 lies
    # within f32 rounding of 0, and any perturbation of K1's size at one of
    # ~30 of the step's K1 calls switches it (and its gradient) on or off,
    # K1's own error as well as half or minus it, the plain path reordered
    # as well as float64 (tools/experiments/nuscenes_grads_torch.py)
    gmodel = build_model(dict(cfg.model))
    gmodel.reset_parameters(torch.Generator().manual_seed(SEED))
    gmodel.to(dev).train()
    gtag = "nuscenes semseg step from the seeded state (f32)"
    out["grads_bound"] = {"seeded, relu pinned": grads_either_bound(
        gtag, gmodel, b_inputs, per_step, pin_relu=True)}

    # ---- one step's grads from the trained state, as in 14: every K1-K3
    # call against float64 on its own inputs, and the grads with float64 as
    # the reference
    gmodel.load_state_dict(state)
    gtag = "nuscenes semseg step from the trained state (f32)"
    grads_kernel_vs_plain(gtag, gmodel, b_inputs, per_step, 1e-5, 1e-3, False,
                          reference="float64")
    out["grads_bound"]["trained"] = "phase 14's (float64)"
    # the model's config and two batches for phase 23b's windowed step
    ctx = {k: b_inputs[k] for k in ("spatial_shape", "batch_size")}
    out["step_inputs"] = (dict(cfg.model), [
        ("the first batch without Mix3D", unmixed_batch(cfg, dev, ctx), None)])
    del gmodel, b_inputs, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def minkunet_options(data_root, save_path):
    """What a run of ``MINK_CONFIG`` on scenes under ``data_root`` changes:
    the data roots, one epoch with one evaluation (3 steps of the 36 train
    scenes), no weight, the save path, and ``submit`` for the precise
    test."""
    return {"data.train.data_root": data_root, "data.val.data_root": data_root,
            "data.test.data_root": data_root, "epoch": 1, "eval_epoch": 1,
            "weight": None, "save_path": save_path, "submit": True}


def minkunet_recipe(data_root, save_path):
    """``MINK_CONFIG`` with its backbone MinkUNet34C (``in_channels`` 6,
    ``out_channels`` 20) and its Collects' features color + normal, as
    Pointcept's ``semseg-minkunet34c-0-base.py``, and ``PreciseEvaluator``
    after training; ``minkunet_options`` for the run."""
    from ponderv2_tpu_torch.engines.defaults import default_config_parser

    cfg = default_config_parser(MINK_CONFIG, minkunet_options(data_root, save_path))
    cfg.model.backbone = dict(type="MinkUNet34C", in_channels=6, out_channels=20)
    for collect in (cfg.data.train.transform[-1], cfg.data.val.transform[-1],
                    cfg.data.test.test_cfg.post_transform[-1]):
        collect.feat_keys = ("color", "normal")
    cfg.hooks = list(cfg.hooks) + [dict(type="PreciseEvaluator")]
    return cfg


def minkunet_phase(dev, tmp, gen, stats):
    """Phase 19: MinkUNet34C on ScanNet, trained and served at full width.
    Writes ``MINK_TRAIN_SCENES`` + ``MINK_VAL_SCENES`` scenes, trains 3
    steps at batch 12 with ``SemSegEvaluator`` and ``PreciseEvaluator``
    (``train_and_check``, routing traced), checks the precise test's
    ``submit/{name}.txt`` files (ScanNet's class ids, one a point), runs
    ``PartSegTester`` once over the val scenes, holds K1-K3 against their
    plain versions at the first batch's convs (f32, into ``stats``) and the
    seeded step's grads kernel vs plain. Returns the run's launches and
    times."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.datasets.scannet import VALID_CLASS_IDS_20
    from ponderv2_tpu_torch.engines.test import TESTERS
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.ops import band_conv as bc

    tag = "minkunet"
    data_root = os.path.join(tmp, "mink_scannet")
    t0 = time.perf_counter()
    write_scannet_scenes(data_root, MINK_TRAIN_SCENES, MINK_VAL_SCENES)
    print(f"[{tag}] wrote {MINK_TRAIN_SCENES} train + {MINK_VAL_SCENES} val scenes of "
          f"100,000 points in ScanNet's layout in {time.perf_counter() - t0:.1f} s")
    cfg = minkunet_recipe(data_root, os.path.join(tmp, "mink_train"))
    cfg.seed = SEED
    cfg.device = str(dev)
    records = {"steps": [], "conditions": [], "batches": [], "peaks": []}
    run = train_and_check(tag, cfg, dev, records,
                          band_convs_per_fwd=MINK_BAND_CONVS_PER_FORWARD)
    remat = run.model.backbone.remat
    for i, (m, batch) in enumerate(zip(records["steps"], records["batches"])):
        live = int((np.asarray(batch["batch"]) >= 0).sum())
        print(f"[{tag}] step {i}: {run.step_times_ms[i]:.1f} ms, data wait "
              f"{run.data_ms[i]:.1f} ms, peak {records['peaks'][i] / 2 ** 30:.3f} GiB, "
              f"{live} live rows, loss {m['loss']:.6f}")

    # ---- the precise test after training: SemSegTester with submit
    precise = run.precise
    check(precise is not None and run.precise_weight.endswith("model_best.pth"),
          f"{tag}: PreciseEvaluator tested {run.precise_weight}")
    submit_dir = os.path.join(cfg.save_path, "submit")
    names = sorted(f[:-len(".pth")] for f in os.listdir(os.path.join(data_root, "val")))
    for name in names:
        scene = torch.load(os.path.join(data_root, "val", f"{name}.pth"), weights_only=False)
        ids = np.loadtxt(os.path.join(submit_dir, f"{name}.txt"), dtype=np.int64)
        check(ids.shape == (len(scene["coord"]),) and np.isin(ids, VALID_CLASS_IDS_20).all(),
              f"{tag}: submit/{name}.txt holds {ids.shape} ids, "
              f"{np.setdiff1d(ids, VALID_CLASS_IDS_20)[:5]} outside ScanNet's")
    frag_ms = [1e3 * t for t in precise.fragment_seconds]
    print(f"[{tag}] PreciseEvaluator: SemSegTester with {os.path.basename(run.precise_weight)} "
          f"over {len(names)} val scenes, {len(frag_ms)} fragments (4 rotations), mIoU "
          f"{run.precise_metrics['m_iou']:.4f}; submit/{{{', '.join(names)}}}.txt hold "
          f"ScanNet's class ids, one a point; {run.band_per_fwd} band convs (K1) a forward")
    print(f"[time] {tag} per-fragment latency in the tester (host to logits): "
          f"{', '.join(f'{t:.1f}' for t in frag_ms)} ms, median {np.median(frag_ms):.2f} ms")

    # ---- PartSegTester once over the val scenes, one category of all parts
    pcfg = minkunet_recipe(data_root, os.path.join(tmp, "mink_partseg"))
    pcfg.data.test = pcfg.data.val
    pcfg.weight = run.ckpt_path
    pcfg.seed = SEED
    pcfg.device = str(dev)
    for k in bc.KERNELS:
        k.launches = 0
    tester = TESTERS.build(dict(type="PartSegTester", cfg=pcfg))
    part = tester.test()
    forwards = len(tester.fragment_seconds)
    launches = [k.launches for k in bc.KERNELS]
    check(forwards == MINK_VAL_SCENES and all(tester.contract_ok)
          and launches == [forwards * run.band_per_fwd, 0, 0]
          and list(part["iou_count"]) == [MINK_VAL_SCENES]
          and 0.0 <= part["ins_miou"] <= 1.0,
          f"{tag}: PartSegTester {forwards} forwards, launches {launches}, {part}")
    print(f"[{tag}] PartSegTester over {forwards} val scenes (one category, 20 parts): "
          f"ins.mIoU {part['ins_miou']:.4f} cat.mIoU {part['cat_miou']:.4f}; K1 launches "
          f"{launches[0]}; {', '.join(f'{1e3 * t:.1f}' for t in tester.fragment_seconds)} ms "
          f"a forward")
    del tester

    compare_band_kernels(run.convs, run.fused, run.level_rb, run.level_coords, gen,
                         torch.float32, stats, fwd_runs=2 if remat else 1)
    out = {"train_launches": run.launches, "step_ms": run.step_times_ms,
           "data_ms": run.data_ms, "peak_gib": run.peak_gib, "fragment_ms": frag_ms,
           "serve_launches": run.precise_launches,
           "per_step": run.per_step}
    b_inputs, per_step = run.b_inputs, run.per_step
    del run, precise
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the seeded first batch's grads, kernel path against plain
    gmodel = build_model(dict(cfg.model))
    gmodel.reset_parameters(torch.Generator().manual_seed(SEED))
    gmodel.to(dev).train()
    out["grads_bound"] = grads_either_bound("MinkUNet34C step from the seeded state (f32)",
                                            gmodel, b_inputs, per_step, pin_relu=True)
    # the model's config and two batches for phase 23b's windowed step
    ctx = {k: b_inputs[k] for k in ("spatial_shape", "batch_size")}
    out["step_inputs"] = (dict(cfg.model), [
        ("the first batch without Mix3D", unmixed_batch(cfg, dev, ctx), None),
        ("the run's first batch (Mix3D)", b_inputs, per_step)])
    del gmodel, b_inputs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def register_object_dataset():
    """Register ``SyntheticObjectDataset`` with the port's datasets (once):
    ModelNet40-like objects made from the seed, ``points`` points on an
    ellipsoid whose axes its class draws (each object's drawn within 10% of
    them), with their normals, centred and scaled into the unit sphere, and
    a 0-d ``category``."""
    import numpy as np

    from ponderv2_tpu_torch.datasets import DATASETS
    from ponderv2_tpu_torch.datasets.transform import Compose

    if "SyntheticObjectDataset" in DATASETS:
        return

    @DATASETS.register_module()
    class SyntheticObjectDataset:
        def __init__(self, num_objects=8, points=CLS_POINTS, num_classes=CLS_CLASSES,
                     transform=None, seed=0, loop=1):
            self.num_objects, self.points, self.num_classes = num_objects, points, num_classes
            self.transform = Compose(transform or [])
            self.seed, self.loop = seed, loop

        def __len__(self):
            return self.num_objects * self.loop

        def make_object(self, i):
            category = (self.seed + i) % self.num_classes
            axes = np.random.RandomState(10_000 + category).uniform(0.3, 1.0, 3)
            rng = np.random.RandomState(self.seed + i)
            axes = axes * rng.uniform(0.9, 1.1, 3)
            d = rng.randn(self.points, 3)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            coord = d * axes
            normal = coord / axes ** 2
            normal /= np.linalg.norm(normal, axis=1, keepdims=True)
            coord -= coord.mean(0)
            coord /= np.linalg.norm(coord, axis=1).max()
            return dict(coord=coord.astype(np.float32), normal=normal.astype(np.float32),
                        category=np.asarray(category, np.int64))

        def __getitem__(self, idx):
            return self.transform(self.make_object(idx % self.num_objects))


def classifier_recipe(tmp, save_path):
    """``CLS_RECIPE`` written as a config file under ``tmp`` and parsed as
    the training entry point parses one."""
    from ponderv2_tpu_torch.engines.defaults import default_config_parser

    path = os.path.join(tmp, "cls-spunet-v1m1-0-base.py")
    with open(path, "w") as f:
        f.write(CLS_RECIPE.format(runtime=os.path.join(ROOT, "configs/_base_/default_runtime.py"),
                                  classes=CLS_CLASSES, points=CLS_POINTS,
                                  train=CLS_TRAIN_OBJECTS, val=CLS_VAL_OBJECTS))
    return default_config_parser(path, {"save_path": save_path})


def classifier_phase(dev, tmp, gen, stats):
    """Phase 20: the SpUNet classifier. Trains 3 steps at batch 32 with
    ``ClsEvaluator`` (``train_and_check``, routing traced), tests 8 objects
    with ``ClsTester``, profiles 2 more steps with ``RuntimeProfiler`` (its
    ``SystemExit(0)`` caught on purpose and its code checked; the Chrome
    trace must name K1's kernel), holds K1-K3 against their plain versions
    at the first batch's convs (f32, into ``stats``) and the seeded step's
    grads kernel vs plain. Returns the run's launches and times."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.engines.test import TESTERS
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.ops import band_conv as bc
    from train_torch import main_worker

    tag = "classifier"
    register_object_dataset()
    cfg = classifier_recipe(tmp, os.path.join(tmp, "cls_train"))
    cfg.seed = SEED
    cfg.device = str(dev)
    records = {"steps": [], "conditions": [], "batches": [], "peaks": []}
    run = train_and_check(tag, cfg, dev, records, val_metric="val/allAcc",
                          band_convs_per_fwd=CLS_BAND_CONVS_PER_FORWARD)
    remat = run.model.backbone.remat
    for i, (m, batch) in enumerate(zip(records["steps"], records["batches"])):
        live = int((np.asarray(batch["batch"]) >= 0).sum())
        print(f"[{tag}] step {i}: {run.step_times_ms[i]:.1f} ms, data wait "
              f"{run.data_ms[i]:.1f} ms, peak {records['peaks'][i] / 2 ** 30:.3f} GiB, "
              f"{live} live rows of {CLS_POINTS} points x 32 objects, loss {m['loss']:.6f}")
    acc = run.val_scalars.get("val/allAcc")
    check(acc is not None and 0.0 <= acc <= 1.0, f"{tag}: ClsEvaluator's val/allAcc {acc}")

    # ---- ClsTester over the 8 test objects with the trained weights
    tcfg = classifier_recipe(tmp, os.path.join(tmp, "cls_test"))
    tcfg.weight = run.ckpt_path
    tcfg.seed = SEED
    tcfg.device = str(dev)
    for k in bc.KERNELS:
        k.launches = 0
    tester = TESTERS.build(dict(type="ClsTester", cfg=tcfg))
    metrics = tester.test()
    forwards = len(tester.fragment_seconds)
    launches = [k.launches for k in bc.KERNELS]
    check(forwards == CLS_VAL_OBJECTS and all(tester.contract_ok)
          and launches == [forwards * run.band_per_fwd, 0, 0]
          and 0.0 <= metrics["all_acc"] <= 1.0,
          f"{tag}: ClsTester {forwards} forwards, launches {launches}, {metrics}")
    frag_ms = [1e3 * t for t in tester.fragment_seconds]
    print(f"[{tag}] ClsEvaluator val/allAcc {acc:.4f}; ClsTester over {forwards} objects: "
          f"allAcc {metrics['all_acc']:.4f} (random-init weights after 3 steps); K1 launches "
          f"{launches[0]}; {', '.join(f'{t:.1f}' for t in frag_ms)} ms an object")
    del tester

    # ---- RuntimeProfiler: 1 warm-up step, 2 traced, then SystemExit(0)
    pcfg = classifier_recipe(tmp, os.path.join(tmp, "cls_profile"))
    pcfg.seed = SEED
    pcfg.device = str(dev)
    trace_dir = os.path.join(tmp, "cls_trace")
    pcfg.hooks = [dict(type="RuntimeProfiler", trace_dir=trace_dir, warm_up=1, record=2)]
    for k in bc.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    try:
        main_worker(pcfg)
    except SystemExit as e:  # the hook ends the run on purpose
        code = e.code
    else:
        code = "no SystemExit"
    check(code == 0, f"{tag}: RuntimeProfiler ended the run with {code!r}")
    launches = [k.launches for k in bc.KERNELS]
    check(launches == [3 * n for n in run.per_step],
          f"{tag}: the profiled run's launches {launches} != 3 x {run.per_step}")
    path = os.path.join(trace_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    k1 = [e for e in events if "band_fwd_kernel" in e.get("name", "")]
    check(k1, f"{tag}: the trace names no band_fwd_kernel")
    k1_ms = sum(e.get("dur", 0) for e in k1) / 1e3 / 2
    print(f"[{tag}] RuntimeProfiler: 3 steps in {time.perf_counter() - t0:.1f} s, "
          f"SystemExit(0); {path} ({os.path.getsize(path) / 2 ** 20:.1f} MiB, "
          f"{len(events)} events) names K1's kernel {len(k1)} times ({k1[0]['name']}; "
          f"{k1_ms:.3f} ms of it a traced step)")
    del events, k1

    compare_band_kernels(run.convs, run.fused, run.level_rb, run.level_coords, gen,
                         torch.float32, stats, fwd_runs=2 if remat else 1)
    out = {"train_launches": run.launches, "step_ms": run.step_times_ms,
           "data_ms": run.data_ms, "peak_gib": run.peak_gib, "object_ms": frag_ms,
           "per_step": run.per_step}
    b_inputs, per_step = run.b_inputs, run.per_step
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the seeded first batch's grads, kernel path against plain
    gmodel = build_model(dict(cfg.model))
    gmodel.reset_parameters(torch.Generator().manual_seed(SEED))
    gmodel.to(dev).train()
    out["grads_bound"] = grads_either_bound("classifier step from the seeded state (f32)",
                                            gmodel, b_inputs, per_step, pin_relu=True)
    del gmodel, b_inputs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def origin_recipe(data_root, save_path):
    """``ORIGIN_CONFIG`` on scenes under ``data_root``: its data roots, one
    epoch with one evaluation, no weight, the save path; the scene cache on
    for the train and val sets, filled by ``DataCacheOperator`` before
    training; the val pipeline with ``Copy`` of coord and segment before
    ``GridSample`` and ``Collect`` keeping both with their offset. Model,
    criteria, optimizer, transforms, batch and budgets stay the recipe's."""
    from ponderv2_tpu_torch.engines.defaults import default_config_parser

    cfg = default_config_parser(ORIGIN_CONFIG, {
        "data.train.data_root": data_root, "data.val.data_root": data_root,
        "data.test.data_root": data_root, "epoch": 1, "eval_epoch": 1, "weight": None,
        "save_path": save_path})
    for split in ("train", "val"):
        cfg.data[split]["cache"] = True
    val = list(cfg.data.val.transform)
    check(val[0]["type"] == "CenterShift" and val[1]["type"] == "GridSample"
          and val[-1]["type"] == "Collect", f"the recipe's val pipeline {val}")
    collect = dict(val[-1])
    collect["keys"] = tuple(collect["keys"]) + ("origin_coord", "origin_segment")
    collect["offset_keys_dict"] = dict(offset="coord", origin_offset="origin_coord")
    cfg.data.val.transform = ([val[0], dict(type="Copy", keys_dict=dict(
        coord="origin_coord", segment="origin_segment"))] + val[1:-1] + [collect])
    # after Copy only CenterShift moves coord, and it moves origin_coord too
    check([t["type"] for t in val[1:-1]] == ["GridSample", "CenterShift", "NormalizeColor"],
          f"a transform after Copy: {[t['type'] for t in val[1:-1]]}")
    cfg.hooks = [dict(type="DataCacheOperator", data_root=data_root, split="train")] + list(
        cfg.hooks)
    return cfg


def tie_tolerance(q64, ref_sq_max):
    """Per query: how far apart two squared distances may come out of the
    expanded form by rounding, ``NEAR_TIE`` of |q|^2 + the largest |r|^2."""
    return NEAR_TIE * ((q64 ** 2).sum(1) + ref_sq_max)


def direct_tie_tolerance(q64, ref_norm_max, d2):
    """Per query: the same for the direct form at squared distances up to
    ``d2``, ``NEAR_TIE`` of 2 d (|q| + the largest |r|) + d^2."""
    import numpy as np

    return NEAR_TIE * (2 * np.sqrt(d2) * (np.sqrt((q64 ** 2).sum(1)) + ref_norm_max) + d2)


def origin_eval_phase(dev, tmp, gen):
    """Phase 21 (a): the ScanNet recipe evaluated on the original points,
    with its scenes cached in shared memory. Returns the first val scene's
    voxel rows and original points, for (b)."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from ponderv2_tpu_torch.datasets.defaults import load_scene, scene_cache_name
    from ponderv2_tpu_torch.engines.hooks import HookBase
    from ponderv2_tpu_torch.engines.hooks import evaluator as ev
    from ponderv2_tpu_torch.utils import cache
    from ponderv2_tpu_torch.utils.misc import intersection_and_union

    tag = "origin"
    data_root = os.path.join(tmp, "origin_scannet")
    t0 = time.perf_counter()
    write_scannet_scenes(data_root, ORIGIN_TRAIN_SCENES, ORIGIN_VAL_SCENES)
    print(f"[{tag}] wrote {ORIGIN_TRAIN_SCENES} train + {ORIGIN_VAL_SCENES} val scenes of "
          f"100,000 points in ScanNet's layout in {time.perf_counter() - t0:.1f} s")
    cfg = origin_recipe(data_root, os.path.join(tmp, "origin_train"))
    cfg.seed = SEED
    cfg.device = str(dev)
    seen = {"val": [], "knn": []}

    class Recorder(HookBase):
        """Keeps each val forward's predictions and batch, and, after the
        step, the run's key, its segments and every cached train scene
        checked against its file."""

        def before_train(self):
            trainer = self.trainer
            eval_step = trainer.eval_step

            def recorded(input_dict):
                out = eval_step(input_dict)  # the evaluator's own argmax
                seen["val"].append(dict(
                    batch=input_dict, pred=out["seg_logits"].float().cpu().numpy().argmax(-1)))
                return out

            trainer.eval_step = recorded

        def after_step(self):
            trainer = self.trainer
            ds = trainer.train_loader.dataset.dataset
            run = trainer.cache_run
            equal = []
            for path in ds.data_list:
                cached = cache.shared_dict(scene_cache_name(ds.data_root, path), run=run)
                scene = load_scene(path)
                equal.append(sorted(cached) == sorted(scene) and all(
                    np.array_equal(cached[k], scene[k]) for k in scene))
            seen.update(run=run, segments=cache.segments(run), equal=equal)

    knn = ev.knn_query

    def recorded_knn(k, ref, ref_b, q, q_b, *args, **kwargs):
        if q.is_cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        idx, d2 = knn(k, ref, ref_b, q, q_b, *args, **kwargs)
        if q.is_cuda:
            torch.cuda.synchronize()
        seen["knn"].append(dict(ms=1e3 * (time.perf_counter() - t), idx=idx.cpu().numpy(),
                                d2=d2.cpu().numpy(), device=q.device.type,
                                dtype=str(q.dtype), n_ref=len(ref)))
        return idx, d2

    cfg.hooks = [dict(type=Recorder)] + list(cfg.hooks)
    ev.knn_query = recorded_knn
    try:
        run = train_and_check(tag, cfg, dev, steps_expected=1)
    finally:
        ev.knn_query = knn
    n_train = len(seen.get("equal", []))
    check(n_train == ORIGIN_TRAIN_SCENES and all(seen["equal"]),
          f"{tag}: {sum(seen.get('equal', []))} of {n_train} cached train scenes equal "
          "their files")
    print(f"[{tag}] DataCacheOperator cached the {n_train} train scenes (each equal to its "
          f"file); {len(seen['segments'])} segments of run {seen['run']} in /dev/shm after "
          f"the step")
    left = cache.segments(seen["run"])
    check(not left and not os.path.exists(cache._manifest_dir(seen["run"])),
          f"{tag}: {len(left)} segments of the run left in /dev/shm")
    print(f"[{tag}] after training: no segment of the run left in /dev/shm and no manifest "
          "in the temporary directory")

    # ---- the projection against an exact float64 search, and val/mIoU
    check(len(seen["val"]) == len(seen["knn"]) == ORIGIN_VAL_SCENES,
          f"{tag}: {len(seen['val'])} val forwards, {len(seen['knn'])} projections")
    num_classes, ignore = cfg.data.num_classes, cfg.data.ignore_index
    sums = [np.zeros(num_classes) for _ in range(3)]
    exact_sums = [np.zeros(num_classes) for _ in range(3)]
    scene0 = None
    for i, (val, knn_out) in enumerate(zip(seen["val"], seen["knn"])):
        batch = val["batch"]
        check(knn_out["device"] == "cuda", f"{tag}: the projection ran on the "
              f"{knn_out['device']}")
        coord, b = np.asarray(batch["coord"]), np.asarray(batch["batch"])
        origin, ob = np.asarray(batch["origin_coord"]), np.asarray(batch["origin_batch"])
        live = b >= 0
        check(set(np.unique(b[live])) == {0} and set(np.unique(ob)) == {0},
              f"{tag}: val batch {i} holds more than one scene")
        rows = coord[live].astype(np.float64)
        pts = origin.astype(np.float64)
        # one frame: every voxel row is one of the scene's original points
        d_frame, _ = cKDTree(pts).query(rows, k=1)
        check(float(d_frame.max()) == 0.0, f"{tag}: a voxel row lies {d_frame.max():.3e} m "
              "from every original point (frames differ)")
        dist, hidx = cKDTree(rows).query(pts, k=2)
        d2 = dist ** 2
        host = hidx[:, 0]  # into the live rows, as the evaluator's search
        pred = val["pred"][live]
        check(knn_out["dtype"] == "torch.float32" and knn_out["n_ref"] == len(rows),
              f"{tag}: the projection ran in {knn_out['dtype']} against {knn_out['n_ref']} "
              f"rows ({len(rows)} live)")
        # the evaluator's projection (f32, the direct form), and for the
        # record the expanded form on the same f32 inputs
        zero = torch.zeros(len(origin), dtype=torch.int32, device=dev)
        expanded = ev.knn_query(
            1, torch.as_tensor(rows, dtype=torch.float32, device=dev), zero[:len(rows)],
            torch.as_tensor(origin, dtype=torch.float32, device=dev), zero)[0][:, 0]
        forms = (("direct (the evaluator's)", knn_out["idx"][:, 0],
                  direct_tie_tolerance(pts, float(np.sqrt((rows ** 2).sum(1)).max()),
                                       d2[:, 1])),
                 ("expanded", expanded.cpu().numpy(),
                  tie_tolerance(pts, float((rows ** 2).sum(1).max()))))
        notes = []
        for form, idx, tol in forms:
            tie = (d2[:, 1] - d2[:, 0]) <= tol
            wrong = (idx != host) & ~tie
            check(not wrong.any(), f"{tag}: val scene {i}: {form} form: {int(wrong.sum())} "
                  "points project to another voxel than the exact search, away from "
                  "near-ties")
            notes.append(f"{form} form {int((idx != host).sum())} other voxels, all at "
                         f"near-ties ({int(tie.sum())} near-ties, tolerance up to "
                         f"{tol.max():.2e} m^2), {int((pred[idx] != pred[host]).sum())} "
                         "labels changed by them")
        port = knn_out["idx"][:, 0]
        d2_err = np.abs(knn_out["d2"][:, 0] - d2[:, 0])
        print(f"[{tag}] val scene {i}: {len(rows)} voxels ({len(coord)} rows with the "
              f"padding), {len(origin)} original points ({origin.dtype} in the batch, f32 in "
              f"the projection); projection {knn_out['ms']:.1f} ms on the card; against the "
              "exact float64 search: " + "; ".join(notes) + "; the evaluator's sqdist error "
              f"max {d2_err.max():.2e} m^2 (negative sqdist "
              f"{int((knn_out['d2'][:, 0] < 0).sum())})")
        segment = np.asarray(batch["origin_segment"])
        valid = ob >= 0
        for s, lab in ((sums, pred[port]), (exact_sums, pred[host])):
            out = intersection_and_union(np.where(valid, lab, ignore),
                                         np.where(valid, segment, ignore), num_classes, ignore)
            for acc, x in zip(s, out):
                acc += x
        if scene0 is None:
            scene0 = dict(coord=coord[live], origin_coord=origin)
    m_iou = float(np.mean(sums[0] / (sums[1] + 1e-10)))
    exact_iou = float(np.mean(exact_sums[0] / (exact_sums[1] + 1e-10)))
    stored = run.val_scalars["val/mIoU"]
    check(abs(stored - m_iou) <= 1e-12, f"{tag}: stored val/mIoU {stored} != {m_iou} "
          "computed on the host from the projected labels")
    print(f"[{tag}] val/mIoU {stored:.6f} over the original points, equal to the host's "
          f"from the projected labels; {exact_iou:.6f} through the exact search")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return scene0


def pointops_phase(dev, scene):
    """Phase 21 (b): ``ops/pointops`` on one val scene's original points
    (queries) and voxel rows (refs), each call against float64 on the host,
    with its ms (CUDA events, median of 3 calls after one more)."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from ponderv2_tpu_torch.ops import pointops as po

    tag = "pointops"
    # in f32, as a model's point features and the evaluator's projection are
    # (the val batches' coordinates come out of CenterShift in float64)
    ref = torch.as_tensor(scene["coord"], dtype=torch.float32, device=dev)
    q = torch.as_tensor(scene["origin_coord"], dtype=torch.float32, device=dev)
    ref64 = ref.cpu().numpy().astype(np.float64)
    q64 = q.cpu().numpy().astype(np.float64)
    rb = torch.zeros(len(ref), dtype=torch.int32, device=dev)
    qb = torch.zeros(len(q), dtype=torch.int32, device=dev)
    n_ref, n_q = len(ref), len(q)
    ref_sq_max = float((ref64 ** 2).sum(1).max())
    tree = cKDTree(ref64)
    out = {}

    def timed(name, fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = float(np.median(times))
        return res

    # ---- knn_query, k = 1 and 16, and k = 1 in the direct form (the
    # evaluator's projection)
    dist, hidx = tree.query(q64, k=17)
    d2 = dist ** 2
    for k, direct in ((1, False), (16, False), (1, True)):
        name = f"knn_query k={k}" + (" direct" if direct else "")
        tol = (direct_tie_tolerance(q64, float(np.sqrt((ref64 ** 2).sum(1)).max()), d2[:, k])
               if direct else tie_tolerance(q64, ref_sq_max))
        idx, sq = timed(name, lambda: po.knn_query(k, ref, rb, q, qb, direct=direct))
        idx, sq = idx.cpu().numpy(), sq.cpu().numpy().astype(np.float64)
        gaps = np.diff(d2, axis=1)  # (n_q, 16): rank j to j + 1
        tie_lo = np.concatenate([np.zeros((n_q, 1), bool), gaps[:, :k - 1] <= tol[:, None]], 1)
        tie_hi = gaps[:, :k] <= tol[:, None]
        free = ~(tie_lo | tie_hi)
        wrong = (idx != hidx[:, :k]) & free
        d_err = np.abs(sq - d2[:, :k]) - tol[:, None]
        check(not wrong.any() and (d_err <= 0).all(),
              f"{tag}: {name}: {int(wrong.sum())} indices off the exact search away "
              f"from near-ties, sqdist beyond tolerance {int((d_err > 0).sum())}")
        print(f"[pointops] {name}, {n_q} queries against {n_ref} refs: "
              f"{out[name]:.2f} ms a call; against float64: "
              f"{int((idx != hidx[:, :k]).sum())} indices differ, all at near-ties "
              f"({int((~free).sum())} near-tied ranks, tolerance up to {tol.max():.2e} m^2); "
              "sqdist within tolerance")
    tol = tie_tolerance(q64, ref_sq_max)
    knn16 = torch.as_tensor(hidx[:, :16].astype(np.int32), device=dev)

    # ---- ball_query: 5 cm, 16 samples; the host check on 10k queries. A
    # ref within rounding of the sphere, or of the query itself (min_radius
    # 0: a d^2 of 0 may round below it and drop out, as in JAX), may be
    # taken or not; every other ref must be, if its index comes in turn
    radius, nsample, m = 0.05, 16, 10_000
    idx, sq = timed("ball_query", lambda: po.ball_query(radius, nsample, ref, rb, q, qb))
    idx = idx.cpu().numpy()
    near = tree.query_ball_point(q64[:m], radius * 1.001)
    loose = 0
    for i, cand in enumerate(near):
        row = idx[i]
        n_hit = 1 + int(np.argmax(np.append(np.diff(row) <= 0, True)))
        hits = row[:n_hit]
        d_hit = ((ref64[hits] - q64[i]) ** 2).sum(1)
        cand = np.sort(np.asarray(cand, np.int64))
        dc = ((ref64[cand] - q64[i]) ** 2).sum(1)
        clear = cand[(dc > tol[i]) & (dc < radius ** 2 - tol[i])]
        loose += int(len(clear) < len(cand))
        if not len(hits) or (d_hit > radius ** 2 + tol[i]).any():
            # no ref in radius: every entry ref 0, as the JAX function gives
            check(len(clear) == 0 and (row == 0).all(),
                  f"{tag}: ball_query query {i}: {row} with in-radius refs {clear[:5]}")
            continue
        full = n_hit == nsample
        want = clear[clear <= hits[-1]] if full else clear
        check((row[n_hit:] == row[0]).all() and np.isin(want, hits).all(),
              f"{tag}: ball_query query {i}: {row} leaves out {np.setdiff1d(want, hits)[:5]}")
    print(f"[pointops] ball_query r={radius} nsample={nsample}, {n_q} queries: "
          f"{out['ball_query']:.2f} ms a call; each of the first {m}: every hit in radius "
          f"and in index order, no ref clearly in radius passed over, the fill the first "
          f"hit ({loose} with a ref within rounding of the sphere or the query)")

    # ---- farthest_point_sampling: 4096 of the 100k points
    n_fps = 4096
    mask = torch.ones(n_q, dtype=torch.bool, device=dev)
    picks = timed("farthest_point_sampling", lambda: po.farthest_point_sampling(q, mask, n_fps),
                  reps=1).cpu().numpy()
    check(picks[0] == 0 and len(np.unique(picks)) == n_fps, f"{tag}: FPS picks {picks[:5]}")
    far = np.full(n_q, np.inf)
    agree, worst = 0, 0.0
    for i in range(1, n_fps):
        far = np.minimum(far, ((q64 - q64[picks[i - 1]]) ** 2).sum(1))
        top = far.max()
        worst = max(worst, (top - far[picks[i]]) / top)
        agree += int(np.argmax(far) == picks[i])
    check(worst <= 1e-5, f"{tag}: an FPS pick lies {worst:.2e} of the farthest distance short")
    print(f"[pointops] farthest_point_sampling {n_fps} of {n_q}: "
          f"{out['farthest_point_sampling']:.1f} ms a call; each pick within {worst:.1e} of "
          f"the float64 farthest ({agree} of {n_fps - 1} the very argmax)")

    # ---- interpolation of 32 channels from the voxels onto the points
    g = torch.Generator(device=dev).manual_seed(SEED)
    feat = torch.randn(n_ref, 32, generator=g, device=dev)
    res = timed("interpolation", lambda: po.interpolation(ref, rb, q, qb, feat))
    idx3, sq3 = po.knn_query(3, ref, rb, q, qb)
    w = 1.0 / (np.sqrt(np.maximum(sq3.cpu().numpy().astype(np.float64), 0.0)) + 1e-8)
    w /= w.sum(1, keepdims=True)
    f64 = feat.cpu().numpy().astype(np.float64)
    want = (f64[idx3.cpu().numpy()] * w[..., None]).sum(1)
    err = np.abs(res.cpu().numpy() - want).max() / np.abs(want).max()
    check(err <= 1e-5, f"{tag}: interpolation {err:.2e} of max|ref| off float64")
    we = 1.0 / (dist[:, :3] + 1e-8)
    we /= we.sum(1, keepdims=True)
    exact = (f64[hidx[:, :3]] * we[..., None]).sum(1)
    print(f"[pointops] interpolation k=3, 32 channels onto {n_q} points: "
          f"{out['interpolation']:.2f} ms a call; {err:.1e} of max|ref| off float64 on its "
          f"neighbours and distances; {np.abs(res.cpu().numpy() - exact).max():.2e} off the "
          "exact float64 search's")

    # ---- grouping and its backward over the 16 nearest
    feat.requires_grad_(True)
    cot = torch.randn(n_q, 16, 32, generator=g, device=dev)

    def group():
        feat.grad = None
        grouped = po.grouping(feat, knn16)
        grouped.backward(cot)
        return grouped

    grouped = timed("grouping fwd+bwd", group)
    idx16 = hidx[:, :16]
    check(torch.equal(grouped.detach(), feat.detach()[knn16.long()]),
          f"{tag}: grouping's rows")
    want = np.zeros((n_ref, 32))
    np.add.at(want, idx16.reshape(-1), cot.cpu().numpy().astype(np.float64).reshape(-1, 32))
    err = np.abs(feat.grad.cpu().numpy() - want).max() / np.abs(want).max()
    check(err <= 1e-5, f"{tag}: grouping's backward {err:.2e} of max|ref| off float64")
    print(f"[pointops] grouping 16 x 32 onto {n_q} points, forward + backward: "
          f"{out['grouping fwd+bwd']:.2f} ms a call; rows equal, the backward's sums "
          f"{err:.1e} of max|ref| off float64")
    feat.requires_grad_(False)

    # ---- the attention steps over the 16-nearest edges
    it = torch.arange(n_q, device=dev, dtype=torch.int32).repeat_interleave(16)
    ir = knn16.reshape(-1)
    qv = torch.randn(n_q, 16, generator=g, device=dev)
    kv = torch.randn(n_ref, 16, generator=g, device=dev)
    wr = torch.randn(16, generator=g, device=dev)
    wf = torch.randn(len(it), 16, generator=g, device=dev)
    rel = timed("attention_relation_step",
                lambda: po.attention_relation_step(qv, kv, wr, it, ir))
    fus = timed("attention_fusion_step",
                lambda: po.attention_fusion_step(wf, kv, it, ir, n_q))
    it_h, ir_h = it.cpu().numpy(), idx16.reshape(-1)
    want = (qv.cpu().numpy().astype(np.float64)[it_h] * kv.cpu().numpy().astype(np.float64)[ir_h]
            * wr.cpu().numpy().astype(np.float64))
    err_r = np.abs(rel.cpu().numpy() - want).max() / np.abs(want).max()
    want = np.zeros((n_q, 16))
    np.add.at(want, it_h, wf.cpu().numpy().astype(np.float64)
              * kv.cpu().numpy().astype(np.float64)[ir_h])
    err_f = np.abs(fus.cpu().numpy() - want).max() / np.abs(want).max()
    check(err_r <= 1e-6 and err_f <= 1e-5,
          f"{tag}: attention steps {err_r:.2e} / {err_f:.2e} of max|ref| off float64")
    print(f"[pointops] attention_relation_step / attention_fusion_step over {len(it)} edges, "
          f"16 channels: {out['attention_relation_step']:.2f} / "
          f"{out['attention_fusion_step']:.2f} ms a call; {err_r:.1e} / {err_f:.1e} of "
          "max|ref| off float64")
    return out


def with_compute_dtype(cfg, dtype):
    """A copy of the model config ``cfg`` with every ``compute_dtype`` set
    to ``dtype``."""
    if isinstance(cfg, dict):
        return {k: dtype if k == "compute_dtype" else with_compute_dtype(v, dtype)
                for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(with_compute_dtype(v, dtype) for v in cfg)
    return cfg


def render_extras_phase(dev, tmp, p_step):
    """Phase 21 (c): the VolSDF pretrain (9's workload with ``VolSDFModel``
    and ``ErrorBoundedSampler`` at its defaults): 3 steps, each step's K1-K3
    launches 9's routing ``p_step``, ``contract_ok`` and finite losses; one
    step's grads kernel vs plain at 11's bound with the same draws, the
    first plain run's ray samples and its relu decisions, in bf16 and in
    f32; then one step of ``NeuSModel`` with ``UniSurfSampler``. Returns
    the step times."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.engines.common import split_batch
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops import windowed_gather as wg
    from train_torch import main_worker

    out = {}
    for tag, renderer, steps in (
            ("volsdf", dict(type="VolSDFModel", sampler=dict(type="ErrorBoundedSampler")), 3),
            ("unisurf", dict(type="NeuSModel", sampler=dict(type="UniSurfSampler")), 1)):
        cfg = default_config_parser(PRETRAIN_CONFIG, {"save_path": os.path.join(tmp, tag)})
        cfg.seed = SEED
        cfg.device = "cuda"
        cfg.model.renderer = dict(cfg.model.renderer, **renderer)
        cfg.data.train.num_scenes = steps * cfg.batch_size
        records = {"steps": [], "conditions": []}
        cfg.hooks = list(cfg.hooks) + [dict(type=step_probe(records))]
        for k in bc.KERNELS + wg.KERNELS:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer = main_worker(cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        sampler = trainer.model.renderer.sampler
        check(type(sampler).__name__ == renderer["sampler"]["type"]
              and type(trainer.model.renderer).__name__ == renderer["type"],
              f"{tag}: built {type(trainer.model.renderer).__name__} over "
              f"{type(sampler).__name__}")
        check(len(records["steps"]) == steps, f"{tag}: {len(records['steps'])} steps")
        for i, m in enumerate(records["steps"]):
            terms = {k: m[k] for k in cfg.metric_keys if k in m}
            print(f"[{tag}] step {i}: loss {m['loss']:.6f} contract_ok {m['contract_ok']} "
                  f"launches {m['launches']} " + " ".join(f"{k} {v:.4f}"
                                                         for k, v in terms.items()))
            check(np.isfinite(m["loss"]) and all(np.isfinite(v) for v in terms.values()),
                  f"{tag} step {i}: a loss is not finite")
            check(m["contract_ok"] == 1.0, f"{tag} step {i} contract_ok False")
            check(m["launches"] == p_step + [0, 0],
                  f"{tag} step {i} launches {m['launches']} != phase 9's routing {p_step}")
        batch_times = [v for v, _ in trainer.storage.history("batch_time").values()]
        data_times = [v for v, _ in trainer.storage.history("data_time").values()]
        step_ms = [1e3 * (b - d) for b, d in zip(batch_times, data_times)]
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(f"[time] {tag} pretrain step at batch {cfg.batch_size} (bf16, "
              f"{sampler.total_samples()} samples a ray): "
              f"{', '.join(f'{t:.1f}' for t in step_ms)} ms; {secs:.1f} s in all; peak "
              f"{peak:.3f} GiB")
        out[tag] = dict(step_ms=step_ms, peak_gib=peak)
        if tag == "volsdf":
            inputs = {k: torch.as_tensor(v, device=dev)
                      for k, v in split_batch(records["batch"])[0].items()}
            inputs.update(trainer.static_ctx)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            B, V, H, W = inputs["depth"].shape
            draws = None
            # the config's bf16, and f32 (where the two paths' rounding moves
            # grads far less, so a wrong kernel shows), each from the same
            # seeded weights
            for dtype, label in (("bfloat16", "bf16"), ("float32", "f32")):
                gmodel = build_model(with_compute_dtype(dict(cfg.model), dtype))
                gmodel.reset_parameters(torch.Generator().manual_seed(SEED))
                gmodel.to(dev).train()
                if draws is None:
                    draws = gmodel.draw_noise(torch.Generator(device=dev).manual_seed(SEED),
                                              B, V, H * W)
                grads_kernel_vs_plain(f"VolSDF pretrain step from the seeded state ({label})",
                                      gmodel, {**inputs, "draws": draws}, p_step, 3e-2, 3e-2,
                                      True, pin_relu=True, pin_samples=True)
                del gmodel
                gc.collect()
                torch.cuda.empty_cache()
            del draws, inputs
        else:
            del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return out


def windowed_cases(probe, dev, level_rb, stem):
    """Phase 12's six convs, (label, tap group, rulebook (k3, n) int32 on
    ``dev``, cin, cout): the probe's four shapes (``probe``:
    ``probe_windowed_torch``), then the rulebooks of the pretrain batch's k5
    stem (6 -> 32) and L0 k3 convs (32 -> 32) from ``level_plans``."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.ops.spconv import SubmPlan

    def legacy(rb):
        return (rb.legacy if isinstance(rb, SubmPlan) else rb).contiguous()

    return ([(f"probe {label}", group, torch.from_numpy(rb).to(dev), cin, cout)
             for label, group, rb, cin, cout in probe.cases(np.random.RandomState(SEED))]
            + [("pretrain stem k5 6->32", 25, legacy(stem), 6, 32),
               ("pretrain L0 k3 32->32", 9, legacy(level_rb[0]), 32, 32)])


def parent_times(path):
    """{conv label: (K4 ms, K5 ms)} from the ``[windowed]`` lines of another
    tree's phase 12 log, in bf16."""
    line = re.compile(r"^\[windowed\] (.+?) \(\d+ rows, group \d+\):.*? K4 ([\d.]+) ms"
                      r".*? K5 ([\d.]+) ms")
    with open(path) as f:
        return {m[1]: (float(m[2]), float(m[3])) for m in map(line.match, f) if m}


def parent_probe_times(path):
    """{probe function: kernel ms (device, L2 cold)} from the ``[probe]``
    lines of another tree's phase 13 log."""
    line = re.compile(r"^\[probe\] (.+?) \([^()]*\): .*?kernel / plain / library ([\d.]+) /")
    with open(path) as f:
        return {m[1]: float(m[2]) for m in map(line.match, f) if m}


def dp_recipe(data_root, save_path, **options):
    """``DP_CONFIG`` (the ScanNet SpUNet-v1m1 recipe) on scenes under
    ``data_root``: its data roots, one epoch, no weight, no evaluation or
    hooks (the phase drives ``Trainer.run_step`` itself), ``DP_WORKERS``
    loader workers a process, the save path, and ``options``. Model,
    criteria, optimizer, transforms, global batch and budgets stay the
    recipe's."""
    from ponderv2_tpu_torch.engines.defaults import default_config_parser

    cfg = default_config_parser(DP_CONFIG, {
        "data.train.data_root": data_root, "data.val.data_root": data_root,
        "data.test.data_root": data_root, "epoch": 1, "eval_epoch": 1, "weight": None,
        "evaluate": False, "num_worker": DP_WORKERS, "save_path": save_path, **options})
    cfg.hooks = []
    cfg.seed = SEED
    return cfg


def model_digest(model):
    """sha256 of the bytes of every parameter and buffer of ``model``."""
    import hashlib

    import torch

    digest = hashlib.sha256()
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        digest.update(name.encode())
        digest.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    return digest.hexdigest()


def allreduce_ranges(prof):
    """The profiler's events that name an allreduce (gloo / NCCL ranges,
    NCCL kernels): {name: (calls, host ms, device ms)}."""
    rows = {}
    for e in prof.key_averages():
        key = e.key.lower()
        if "allreduce" in key or "all_reduce" in key:
            device_us = getattr(e, "device_time_total", None)
            if device_us is None:
                device_us = getattr(e, "cuda_time_total", 0.0)
            rows[e.key] = (e.count, e.cpu_time_total / 1e3, device_us / 1e3)
    return rows


class CoreTimer:
    """While entered, CUDA events around every K1-K3 call (the band cores of
    ``ops/band_conv.py``, looked up at each call); ``ms()``: each core's
    summed device ms, from one stream's events, so that a rank sharing the
    card counts the time its calls took beside the other's."""

    def __enter__(self):
        from ponderv2_tpu_torch.ops import band_conv as bc

        self.saved = {name: getattr(bc, name) for name in BAND_CORES}
        self.events = {name: [] for name in BAND_CORES}
        for name, fn in self.saved.items():
            setattr(bc, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        import torch

        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events[name].append((start, end))
            return out

        return timed

    def __exit__(self, *exc):
        from ponderv2_tpu_torch.ops import band_conv as bc

        for name, fn in self.saved.items():
            setattr(bc, name, fn)

    def ms(self):
        import torch

        torch.cuda.synchronize()
        return [sum(s.elapsed_time(e) for s, e in self.events[name]) for name in BAND_CORES]


def timed_allreduce(model, dev, reps=3):
    """One allreduce of a f32 buffer as large as ``model``'s parameters (the
    gradients DDP sums a step) on the process group's backend, ``reps``
    times under ``torch.profiler``, each waited for: (the median ms, its
    MiB, the profiler's allreduce ranges of the ``reps`` calls)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ponderv2_tpu_torch.utils import comm

    buf = torch.ones(sum(p.numel() for p in model.parameters()), device=dev)
    times = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            comm.synchronize()
            torch.cuda.synchronize()
            t = time.perf_counter()
            dist.all_reduce(buf)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
    return sorted(times)[len(times) // 2], 4 * buf.numel() / 2 ** 20, allreduce_ranges(prof)


def ranges_note(rows):
    return "; ".join(f"{k} x{c} host {h:.2f} ms device {d:.2f} ms"
                     for k, (c, h, d) in rows.items())


def dp_kernel_vs_plain(tag, gmodel, inputs, expect):
    """One forward and backward of the DDP-wrapped ``gmodel`` through the
    plain versions, every relu's decision recorded (``PinnedRelu``), then
    one through the kernels taking those decisions: the loss within 1e-5
    of the plain path's and every averaged gradient within phase 7's 1e-4
    of its max|ref|."""
    from ponderv2_tpu_torch.ops import band_conv as bc

    pin = PinnedRelu()
    plain_cores = {name: getattr(bc, f"{name}_plain") for name in BAND_CORES}
    loss_p, grads_p, launched_p, secs_p = pin.run(
        "record", lambda: step_grads(gmodel, inputs, plain_cores))
    loss_k, grads_k, launched_k, secs_k = pin.run("replay", lambda: step_grads(gmodel, inputs))
    check(launched_k == expect and launched_p == [0, 0, 0],
          f"{tag}: launches kernel path {launched_k}, plain path {launched_p}")
    check(sorted(grads_k) == sorted(grads_p), f"{tag}: grads of other params")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), f"{tag}: loss {loss_k} vs {loss_p}")
    rel = {n: (grads_k[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
           for n, g in grads_p.items()}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= 1e-4, f"{tag}: grad {worst} kernel vs plain {rel[worst]:.3e} of max|ref|")
    print(f"[grad] {tag}: the DP step kernel vs plain, relus pinned ({pin.flips} decisions "
          f"the kernel path's own forward makes otherwise): loss {loss_k:.7f} / {loss_p:.7f}, "
          f"every one of {len(rel)} averaged grads within 1e-4 of its max|ref|, worst {worst} "
          f"{rel[worst]:.3e}; forward+backward {1e3 * secs_k:.1f} ms with the kernels, "
          f"{1e3 * secs_p:.1f} ms plain", flush=True)
    return rel[worst]


def recorded_steps(trainer):
    """Wrap ``trainer``'s optimizer step and metric reduction: returns a dict
    whose ``grads`` each step's (averaged) grads fill, and ``local`` each
    step's metrics before the ranks reduce them."""
    from ponderv2_tpu_torch.engines import train as engine

    seen = {"grads": [], "local": []}
    step = trainer.optimizer.step
    reduce = engine.reduce_metrics

    def recorded_step(*args, **kwargs):
        seen["grads"].append({n: p.grad.detach().clone()
                              for n, p in trainer.model.named_parameters()})
        return step(*args, **kwargs)

    def recorded_reduce(metrics, keys=()):
        seen["local"].append({k: float(v) for k, v in metrics.items()})
        return reduce(metrics, keys)

    trainer.optimizer.step = recorded_step
    engine.reduce_metrics = recorded_reduce
    seen["restore"] = lambda: setattr(engine, "reduce_metrics", reduce)
    return seen


def dp_world_one(dev, data_root, tmp):
    """22 (a): one step of ``DP_CONFIG`` at its global batch of 12 through
    the data-parallel branch (DDP over NCCL in a world of one) and through
    the single-process trainer, from one seeded state on one batch: loss,
    every grad, the parameters and the running statistics equal bit for
    bit. The DP step is run once more under ``torch.profiler`` for its
    allreduce ranges."""
    import torch
    import torch.distributed as dist

    from ponderv2_tpu_torch.engines.launch import _free_port
    from ponderv2_tpu_torch.engines.train import TRAINERS

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    runs, batch = {}, None
    try:
        for dp in (False, True):
            cfg = dp_recipe(data_root, os.path.join(tmp, f"dp_one_{dp}"), data_parallel=dp)
            cfg.device = str(dev)
            trainer = TRAINERS.build(dict(type="Trainer", cfg=cfg))
            check(trainer.data_parallel == dp and trainer.num_devices == 1,
                  f"dp {dp}: branch {trainer.data_parallel}, {trainer.num_devices} ranks")
            if batch is None:
                batch = next(iter(trainer.train_loader))
            seen = recorded_steps(trainer)
            trainer.comm_info["input_dict"] = batch
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                trainer.run_step()
                metrics = trainer.sync_metrics()
            finally:
                seen["restore"]()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
            runs[dp] = dict(metrics=metrics, grads=seen["grads"][0], ms=ms,
                            state={k: v.clone() for k, v in trainer.model.state_dict().items()},
                            ddp=type(trainer.step_model).__name__)
            if dp:
                comm_ms, mib, rows = timed_allreduce(trainer.model, dev)
                runs[dp].update(rows=rows, comm_ms=comm_ms, mib=mib)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    one, ddp = runs[False], runs[True]
    check(ddp["ddp"] == "DistributedDataParallel", f"the DP branch's model: {ddp['ddp']}")
    check(one["metrics"] == ddp["metrics"],
          f"world of one: metrics {one['metrics']} vs DP {ddp['metrics']}")
    unequal = [n for n, g in one["grads"].items() if not torch.equal(g, ddp["grads"][n])]
    unequal += [n for n, v in one["state"].items() if not torch.equal(v, ddp["state"][n])]
    check(not unequal, f"world of one: {len(unequal)} grads / state entries differ from the "
                       f"single-process step, e.g. {unequal[:3]}")
    print(f"[dp] (a) NCCL, a world of one, batch 12: the DP step equals the single-process "
          f"step bit for bit (loss {one['metrics']['loss']:.7f}, {len(one['grads'])} grads, "
          f"{len(one['state'])} parameters and statistics); step {ddp['ms']:.1f} ms (DP) vs "
          f"{one['ms']:.1f} ms (one process); one NCCL allreduce of the {ddp['mib']:.1f} MiB of "
          f"f32 grads {ddp['comm_ms']:.3f} ms ({100 * ddp['comm_ms'] / ddp['ms']:.2f}% of the "
          f"DP step), the profiler's ranges over 3: {ranges_note(ddp['rows'])}", flush=True)
    return dict(ms_one=one["ms"], ms_dp=ddp["ms"], comm_ms=ddp["comm_ms"])


def dp_fine_tune_rank(dev, data_root, save_path, rank):
    """22 (b) on one of two ranks sharing the card over gloo: ``DP_CONFIG``
    at its global batch of 12 (6 a rank), 3 steps without SyncBN and one
    with. Checks every step: the K1-K3 launches this rank's batch routes
    to (phase 6's routing), ``contract_ok`` the minimum of the ranks',
    equal bits on both ranks after the step; the first step's grads equal
    the mean of both shards' grads computed in rank 0's process and the
    running statistics the mean of both shards' moves; in the SyncBN step
    every BN's statistics equal those of one forward over both shards'
    valid rows. Then the DP step's grads kernel vs plain
    (``dp_kernel_vs_plain``), and one allreduce of the grads' volume timed
    under the profiler."""
    import copy

    import numpy as np
    import torch

    from ponderv2_tpu_torch.engines.common import split_batch
    from ponderv2_tpu_torch.engines.defaults import default_setup
    from ponderv2_tpu_torch.engines.train import TRAINERS
    from ponderv2_tpu_torch.models import norm
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.sparse import maybe_sort_by_key
    from ponderv2_tpu_torch.utils import comm

    tag = f"[dp] (b) rank {rank}:"
    cfg = default_setup(dp_recipe(data_root, save_path))
    cfg.device = str(dev)
    trainer = TRAINERS.build(dict(type="Trainer", cfg=cfg))
    check(trainer.data_parallel and trainer.num_devices == 2
          and trainer.static_ctx["batch_size"] == 6, f"{tag} the DP branch's set-up")
    seen = recorded_steps(trainer)
    loader = iter(trainer.train_loader)
    out = dict(step_ms=[], launches=[], peak_gib=[])

    def inputs_of(batch):
        arrays = trainer._to_device(batch)
        return {**arrays, **trainer.static_ctx}

    def bn_stats_of(fn):
        """Each MaskedBatchNorm's (mean, var) in ``fn``'s forward, in order."""
        rec, batch_stats = [], norm.MaskedBatchNorm.batch_stats

        def recording(self, x, mask):
            mean, var = batch_stats(self, x, mask)
            if self.training and not norm._RECOMPUTING[0]:
                rec.append((mean.detach().clone(), var.detach().clone()))
            return mean, var

        norm.MaskedBatchNorm.batch_stats = recording
        try:
            fn()
        finally:
            norm.MaskedBatchNorm.batch_stats = batch_stats
        return rec

    try:
        for i in range(4):
            try:
                batch = next(loader)
            except StopIteration:
                loader = iter(trainer.train_loader)
                batch = next(loader)
            sync = i == 3
            trainer.sync_bn = sync
            inputs = inputs_of(batch)
            st, _ = maybe_sort_by_key(batch_to_sparse_tensor(inputs))
            per_step = spunet_routing(trainer.model, inputs, st)[4]
            batches = comm.all_gather({k: v for k, v in batch.items()}) if i in (0, 3) else None
            pre = copy.deepcopy(trainer.model) if rank == 0 and i in (0, 3) else None
            before = [k.launches for k in bc.KERNELS]
            torch.cuda.reset_peak_memory_stats(dev)
            trainer.comm_info["input_dict"] = batch
            comm.synchronize()  # a step's time starts on both ranks at once
            torch.cuda.synchronize()
            t = time.perf_counter()
            if sync:
                stats_dp = bn_stats_of(trainer.run_step)
            elif i == 1:
                with CoreTimer() as timer:
                    trainer.run_step()
                out["core_ms"] = timer.ms()
            else:
                trainer.run_step()
            metrics = trainer.sync_metrics()
            torch.cuda.synchronize()
            out["step_ms"].append(1e3 * (time.perf_counter() - t))
            out["peak_gib"].append(torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            launched = [k.launches - b for k, b in zip(bc.KERNELS, before)]
            out["launches"].append(launched)
            check(launched == per_step, f"{tag} step {i}: launches {launched} != this "
                                        f"rank's routing {per_step}")
            local = comm.all_gather(seen["local"][-1]["contract_ok"])
            check(metrics["contract_ok"] == min(local) == 1.0,
                  f"{tag} step {i}: contract_ok {metrics['contract_ok']}, ranks' {local}")
            digests = comm.all_gather(model_digest(trainer.model))
            check(digests[0] == digests[1], f"{tag} step {i}: the replicas differ")
            print(f"{tag} step {i}{' (SyncBN)' if sync else ''}: loss {metrics['loss']:.6f} "
                  f"(this rank's {seen['local'][-1]['loss']:.6f}) lr {metrics['lr']:.6e} "
                  f"contract_ok {metrics['contract_ok']} launches {launched}, "
                  f"{out['step_ms'][-1]:.1f} ms, peak {out['peak_gib'][-1]:.3f} GiB; "
                  "the replicas equal bit for bit", flush=True)
            if i == 0 and rank == 0:
                # both shards' grads and moves, one after the other in this process
                grads, moves = [], []
                for shard in batches:
                    ref = copy.deepcopy(pre)
                    ref.train()
                    out_ref = ref(inputs_of(shard))
                    out_ref["loss"].backward()
                    grads.append({n: p.grad if p.grad is not None else torch.zeros_like(p)
                                  for n, p in ref.named_parameters()})
                    moves.append({n: b for n, b in ref.named_buffers() if "running" in n})
                    del ref, out_ref
                got = seen["grads"][0]
                gerr = max((got[n] - (g + grads[1][n]) / 2).abs().max().item()
                           / max(g.abs().max().item(), grads[1][n].abs().max().item(), 1e-30)
                           for n, g in grads[0].items())
                state = trainer.model.state_dict()
                serr = max((state[n] - (m + moves[1][n]) / 2).abs().max().item()
                           for n, m in moves[0].items())
                check(gerr <= 2.0 ** -22 and serr <= 2.0 ** -21,
                      f"{tag} step 0: grads {gerr:.3e} of max|shard grad| off the mean of "
                      f"both shards', running statistics {serr:.3e} off the mean of both moves")
                print(f"{tag} step 0: the DP grads against the mean of both shards' grads in "
                      f"one process: {gerr:.3e} of max|grad| (equal bits where 0); running "
                      f"statistics against the mean of both shards' moves: {serr:.3e}",
                      flush=True)
                out["mean_grad_err"], out["mean_stat_err"] = gerr, serr
                del grads, moves
            if sync and rank == 0:
                # one forward over both shards' valid rows: the ranks' first
                # rows, then the second's (scenes renumbered), padding last
                parts = [split_batch(b)[0] for b in batches]
                keys = [k for k in parts[0] if parts[0][k].shape[:1] == parts[0]["batch"].shape]
                live = [np.asarray(p["batch"]) >= 0 for p in parts]
                whole = {}
                for k in keys:
                    vals = [np.asarray(p[k]) for p in parts]
                    if k == "batch":
                        vals = [vals[0], np.where(live[1], vals[1] + 6, -1)]
                    whole[k] = np.concatenate([vals[0][live[0]], vals[1][live[1]],
                                               vals[0][~live[0]], vals[1][~live[1]]])
                ref = copy.deepcopy(pre)
                ref.train()
                ref_inputs = {**{k: torch.as_tensor(v, device=dev) for k, v in whole.items()},
                              **trainer.static_ctx, "batch_size": 12}
                with torch.no_grad():
                    stats_ref = bn_stats_of(lambda: ref(ref_inputs))
                check(len(stats_ref) == len(stats_dp) > 0,
                      f"{tag} SyncBN: {len(stats_dp)} BN calls vs {len(stats_ref)}")
                worst = max(max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                                for a, b in zip(dp_pair, ref_pair))
                            for dp_pair, ref_pair in zip(stats_dp, stats_ref))
                check(worst <= 1e-4, f"{tag} SyncBN: BN statistics {worst:.3e} of max|ref| "
                                     "off those over both shards' rows")
                print(f"{tag} SyncBN step: each of {len(stats_dp)} BN calls' statistics "
                      f"within {worst:.3e} of max|ref| of one forward over both shards' "
                      f"{int(sum(l.sum() for l in live))} valid rows", flush=True)
                out["sync_stat_err"] = worst
                del ref, ref_inputs
            del pre, batches
        # the DP step kernel vs plain, from the trained state, relus pinned
        trainer.sync_bn = False
        out["kernel_vs_plain"] = dp_kernel_vs_plain(f"dp rank {rank}", trainer.step_model,
                                                    inputs, per_step)
    finally:
        seen["restore"]()
    # the allreduce of one step's grads over gloo, timed and under the profiler
    out["comm_ms"], mib, rows = timed_allreduce(trainer.model, dev)
    out["comm_share"] = out["comm_ms"] / sorted(out["step_ms"])[len(out["step_ms"]) // 2]
    print(f"{tag} one gloo allreduce of the {mib:.1f} MiB of f32 grads (two ranks on the "
          f"card: device to host, sum, host to device) {out['comm_ms']:.1f} ms, "
          f"{100 * out['comm_share']:.1f}% of the median step; the profiler's ranges over 3: "
          f"{ranges_note(rows)}", flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_pretrain_rank(dev, save_path, rank):
    """22 (c) on one of two ranks: 2 steps of ``PRETRAIN_CONFIG`` (bench.py's
    PonderIndoor-v2 workload, bf16, the eikonal term's double backward in
    every forward) at its global batch of 2, one scene a rank. Checks: each
    rank's ray draws differ from the other's, rank 0's are a world of one's,
    the replicas equal bit for bit after each step, finite loss and
    ``contract_ok``, the K1-K3 launches of this rank's routing."""
    import torch

    from ponderv2_tpu_torch.engines.defaults import default_config_parser, default_setup
    from ponderv2_tpu_torch.engines.train import TRAINERS
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.sparse import maybe_sort_by_key
    from ponderv2_tpu_torch.utils import comm

    tag = f"[dp] (c) rank {rank}:"
    cfg = default_config_parser(PRETRAIN_CONFIG, {"save_path": save_path, "hooks": []})
    cfg.seed = SEED
    cfg = default_setup(cfg)
    cfg.device = str(dev)
    trainer = TRAINERS.build(dict(type="Trainer", cfg=cfg))
    check(trainer.data_parallel and trainer.static_ctx["batch_size"] == 1,
          f"{tag} the DP branch's set-up")
    out = dict(step_ms=[], launches=[], peak_gib=[])
    for i, batch in enumerate(trainer.train_loader):
        if i == 2:
            break
        inputs = {**trainer._to_device(batch), **trainer.static_ctx}
        _, views, h, w = inputs["depth"].shape
        draws = trainer.model.draw_noise(trainer.step_generator(), 1, views, h * w)
        mine = torch.cat([v.float().reshape(-1) for v in draws.values()
                          if torch.is_tensor(v)]).cpu()
        others = comm.all_gather(mine)
        check(not torch.equal(others[0], others[1]), f"{tag} step {i}: both ranks draw alike")
        if rank == 0:
            one = trainer.model.draw_noise(torch.Generator(device=dev).manual_seed(
                (SEED << 32) | trainer.step), 1, views, h * w)
            check(all(torch.equal(one[k], v) for k, v in draws.items() if torch.is_tensor(v)),
                  f"{tag} step {i}: rank 0 draws otherwise than one process")
        st, _ = maybe_sort_by_key(batch_to_sparse_tensor(inputs))
        level_rb = level_plans(trainer.model.backbone, st)[0]
        per_step = band_routing(trainer.model.backbone, level_rb)[2]
        before = [k.launches for k in bc.KERNELS]
        torch.cuda.reset_peak_memory_stats(dev)
        trainer.comm_info["input_dict"] = batch
        comm.synchronize()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with CoreTimer() as timer:
            trainer.run_step()
        out["core_ms"] = timer.ms()
        metrics = trainer.sync_metrics()
        torch.cuda.synchronize()
        out["step_ms"].append(1e3 * (time.perf_counter() - t))
        out["peak_gib"].append(torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        launched = [k.launches - b for k, b in zip(bc.KERNELS, before)]
        out["launches"].append(launched)
        check(launched == per_step, f"{tag} step {i}: launches {launched} != {per_step}")
        check(math.isfinite(metrics["loss"]) and metrics["contract_ok"] == 1.0,
              f"{tag} step {i}: loss {metrics['loss']} contract_ok {metrics['contract_ok']}")
        digests = comm.all_gather(model_digest(trainer.model))
        check(digests[0] == digests[1], f"{tag} step {i}: the replicas differ")
        print(f"{tag} step {i}: loss {metrics['loss']:.6f} "
              + " ".join(f"{k} {metrics[k]:.4f}" for k in cfg.metric_keys if k in metrics)
              + f" launches {launched}, {out['step_ms'][-1]:.1f} ms, peak "
              f"{out['peak_gib'][-1]:.3f} GiB; ray draws differ between the ranks, rank 0's "
              "are one process's; the replicas equal bit for bit", flush=True)
    check(len(out["step_ms"]) == 2, f"{tag} {len(out['step_ms'])} steps")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_rank(job):
    """The body of each of phase 22's two ranks (spawned by
    ``engines/launch.py:launch`` over gloo, both on ``job["device"]``): (b)
    then (c); writes what it measured to ``{job["out"]}/rank{r}.pt``."""
    import torch

    from ponderv2_tpu_torch.utils import comm

    rank = comm.get_rank()
    dev = torch.device(job["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_per_process_memory_fraction(DP_MEMORY_FRACTION, dev)
    t = time.perf_counter()
    out = dict(b=dp_fine_tune_rank(dev, job["data_root"], os.path.join(job["out"], "b"), rank))
    out["b_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["c"] = dp_pretrain_rank(dev, os.path.join(job["out"], f"c{rank}"), rank)
    out["c_s"] = time.perf_counter() - t
    torch.save(out, os.path.join(job["out"], f"rank{rank}.pt"))


def data_parallel_phase(dev, tmp):
    """Phase 22: (a) in this process, then (b) and (c) on two ranks that
    ``launch`` spawns on this card over gloo. Returns the ranks' records
    and (a)'s numbers."""
    import torch

    from ponderv2_tpu_torch.engines.launch import launch

    data_root = os.path.join(tmp, "ppt_scannet")  # phase 14's scene files
    check(len(os.listdir(os.path.join(data_root, "train"))) == PPT_TRAIN_SCENES,
          "phase 14's scene files")
    a = dp_world_one(dev, data_root, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "dp_ranks")
    os.makedirs(out, exist_ok=True)
    t = time.perf_counter()
    launch(dp_rank, num_gpus_per_machine=2, backend="gloo",
           cfg=(dict(data_root=data_root, out=out, device=str(dev)),))
    spawned_s = time.perf_counter() - t
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    for r, rec in enumerate(ranks):
        print(f"[dp] rank {r}: (b) {rec['b_s']:.1f} s, steps "
              f"{', '.join(f'{t:.1f}' for t in rec['b']['step_ms'])} ms, peak "
              f"{max(rec['b']['peak_gib']):.3f} GiB, launches {rec['b']['launches']}, gloo "
              f"allreduce of the grads {rec['b']['comm_ms']:.1f} ms "
              f"({100 * rec['b']['comm_share']:.1f}% of the median step), K1/K2/K3 "
              f"{', '.join(f'{t:.3f}' for t in rec['b']['core_ms'])} ms in step 1; (c) "
              f"{rec['c_s']:.1f} s, steps {', '.join(f'{t:.1f}' for t in rec['c']['step_ms'])} "
              f"ms, peak {max(rec['c']['peak_gib']):.3f} GiB, launches {rec['c']['launches']}, "
              f"K1/K2/K3 {', '.join(f'{t:.3f}' for t in rec['c']['core_ms'])} ms in step 1")
    print(f"[dp] the two ranks, spawned to joined: {spawned_s:.1f} s")
    return dict(a=a, ranks=ranks, spawned_s=spawned_s)


def plan_leaves(tree, path="plans"):
    """Every leaf of a plans tree with its path: tensors, ``None`` and the
    band plans' per-tap counts."""
    import torch

    if tree is None or isinstance(tree, (torch.Tensor, int)):
        return [(path, tree)]
    names = tree._fields if hasattr(tree, "_fields") else range(len(tree))
    return [leaf for name, v in zip(names, tree) for leaf in plan_leaves(v, f"{path}.{name}")]


def sync_count(fn):
    """(``fn()``, the host syncs it made, its seconds on the host clock up
    to the device's end): ``torch.cuda.set_sync_debug_mode`` warns at each
    synchronizing call."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t = time.perf_counter()
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    return out, sum("synchroniz" in str(w.message) for w in caught), secs


def host_plans_phase(dev, tmp, p_step):
    """Phase 23a: ``configs/_test_/pretrain_bench_torch.py`` (bf16, batch 2,
    full width) for 3 steps through the ``Trainer`` with ``host_plans`` on
    (the next batch's plans built on the CPU by the prefetch thread,
    ``engines/plan_prefetch.py``) and off (built inside the step on the
    card). Holds every leaf of each batch's host-built plans integer-equal
    to the in-step build of the same batch, the two runs' loss, grads and
    parameters bit-equal after every step, no plan built inside a step with
    the prefetch on, and K1-K3 at ``p_step`` a step. Prints both runs' step
    and data-wait ms, the build's ms a batch in the thread, the plans' bytes
    and copy ms, and the in-step build's ms and host syncs."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.engines.common import plans_to_device
    from ponderv2_tpu_torch.engines.defaults import default_config_parser, default_setup
    from ponderv2_tpu_torch.engines.plan_prefetch import PlanPrefetchLoader
    from ponderv2_tpu_torch.engines.train import Trainer
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.models.sparse_unet import spunet as spunet_module
    from ponderv2_tpu_torch.models.sparse_unet.plans import capacity_schedule
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.sparse import maybe_sort_by_key

    tag = "host-plans"
    runs = {}
    inline = spunet_module.build_spunet_plans_auto
    for host in (True, False):
        cfg = default_config_parser(PRETRAIN_CONFIG, {
            "save_path": os.path.join(tmp, f"host_plans_{int(host)}"), "host_plans": host})
        cfg.seed = SEED
        cfg.device = str(dev)
        trainer = Trainer(default_setup(cfg))
        check(isinstance(trainer.train_loader, PlanPrefetchLoader) == host,
              f"{tag}: host_plans={host} gave a {type(trainer.train_loader).__name__}")
        rec = dict(loss=[], grads=[], params=[], launches=[], step_ms=[], wait_ms=[],
                   batches=[], inline_builds=0)
        step = trainer.optimizer.step

        def recording_step(*args, _rec=rec, _trainer=trainer, **kwargs):
            _rec["grads"].append([p.grad.detach().clone()
                                  for p in _trainer.model.parameters() if p.grad is not None])
            return step(*args, **kwargs)

        def counting_build(*args, _rec=rec, **kwargs):
            _rec["inline_builds"] += 1
            return inline(*args, **kwargs)

        trainer.optimizer.step = recording_step
        spunet_module.build_spunet_plans_auto = counting_build
        try:
            batches = iter(trainer.train_loader)
            for _ in range(len(trainer.train_loader)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = next(batches)
                t1 = time.perf_counter()
                before = [k.launches for k in bc.KERNELS]
                trainer.comm_info["input_dict"] = batch
                trainer.run_step()
                metrics = trainer.sync_metrics()
                torch.cuda.synchronize()
                rec["step_ms"].append(1e3 * (time.perf_counter() - t1))
                rec["wait_ms"].append(1e3 * (t1 - t0))
                rec["launches"].append([k.launches - b for k, b in zip(bc.KERNELS, before)])
                rec["loss"].append(metrics["loss"])
                rec["params"].append([p.detach().clone() for p in trainer.model.parameters()])
                rec["batches"].append(batch)
                check(metrics["contract_ok"] == 1.0, f"{tag}: host_plans={host} contract_ok")
        finally:
            spunet_module.build_spunet_plans_auto = inline
        rec["build_ms"] = [1e3 * s for s in getattr(trainer.train_loader, "build_seconds", [])]
        rec["static_ctx"] = trainer.static_ctx
        rec["spunet"] = trainer.model.backbone
        runs[host] = rec
        print(f"[{tag}] host_plans {'on' if host else 'off'}: {len(rec['loss'])} steps, "
              f"losses {', '.join(f'{v:.7f}' for v in rec['loss'])}; step ms (batch "
              f"to the card .. metrics synced) {', '.join(f'{t:.1f}' for t in rec['step_ms'])}; "
              f"data wait ms {', '.join(f'{t:.1f}' for t in rec['wait_ms'])}; plans built "
              f"inside the steps {rec['inline_builds']}; launches K1-K3 {rec['launches']}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

    on, off = runs[True], runs[False]
    steps = len(off["loss"])
    check(len(on["loss"]) == steps == 3, f"{tag}: {len(on['loss'])} / {steps} steps")
    check(on["inline_builds"] == 0 and off["inline_builds"] == steps,
          f"{tag}: plans built inside the steps {on['inline_builds']} / {off['inline_builds']}")
    check(on["launches"] == off["launches"] == [p_step] * steps,
          f"{tag}: launches {on['launches']} / {off['launches']}, routing {p_step}")
    for i in range(steps):
        unequal = [j for j, (a, b) in enumerate(zip(on["grads"][i], off["grads"][i]))
                   if not torch.equal(a, b)]
        moved = [j for j, (a, b) in enumerate(zip(on["params"][i], off["params"][i]))
                 if not torch.equal(a, b)]
        check(on["loss"][i] == off["loss"][i] and not unequal and not moved
              and len(on["grads"][i]) == len(off["grads"][i]),
              f"{tag}: step {i} differs: loss {on['loss'][i]!r} vs {off['loss'][i]!r}, "
              f"{len(unequal)} grads, {len(moved)} parameters")
    print(f"[{tag}] the {steps} steps bit-equal with the prefetch on and off: loss, "
          f"{len(on['grads'][0])} grads and {len(on['params'][0])} parameters after each step")

    # each batch's host-built plans against the in-step build of its rows
    spunet, ctx = on["spunet"], on["static_ctx"]
    nbytes, device_ms, syncs = [], [], []
    for i, batch in enumerate(on["batches"]):
        host_plans = batch["spunet_plans"]
        arrays = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
                  if isinstance(v, np.ndarray)}
        st, _ = maybe_sort_by_key(batch_to_sparse_tensor({**arrays, **ctx}), True)
        caps = spunet.capacities or capacity_schedule(st.capacity, spunet.num_stages)
        dev_plans, n_sync, secs = sync_count(lambda: inline(
            st.coords, st.spatial_shape, st.batch_size, caps, spunet.channels))
        hl, dl = plan_leaves(host_plans), plan_leaves(dev_plans)
        check([p for p, _ in hl] == [p for p, _ in dl], f"{tag}: batch {i} plan trees differ")
        for (path, a), (_, b) in zip(hl, dl):
            same = (a is None and b is None) if a is None or b is None else (
                torch.equal(a, b.cpu()) if isinstance(a, torch.Tensor) else a == b)
            check(same, f"{tag}: batch {i} {path} differs between the host and the card")
        tensors = [a for _, a in hl if isinstance(a, torch.Tensor)]
        check(all(t.is_pinned() for t in tensors if t.numel()),
              f"{tag}: batch {i} plans not pinned")
        nbytes.append(sum(t.numel() * t.element_size() for t in tensors))
        device_ms.append(1e3 * secs)
        syncs.append(n_sync)
        print(f"[{tag}] batch {i}: {len(hl)} plan leaves ({len(tensors)} tensors, "
              f"{nbytes[-1] / 2 ** 20:.1f} MiB) integer-equal to the in-step build on the "
              f"card; host build {on['build_ms'][i]:.1f} ms in the thread; the in-step "
              f"build {device_ms[-1]:.1f} ms with {n_sync} host syncs")
    copy_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        moved = plans_to_device(on["batches"][-1]["spunet_plans"], dev)
        torch.cuda.synchronize()
        copy_ms.append(1e3 * (time.perf_counter() - t))
        del moved
    print(f"[{tag}] the plans' copy to the card from pinned memory: "
          f"{', '.join(f'{t:.2f}' for t in copy_ms)} ms for {nbytes[-1] / 2 ** 20:.1f} MiB "
          f"({nbytes[-1] / 1e6 / (min(copy_ms) / 1e3) / 1e3:.1f} GB/s at the fastest)")
    out = dict(step_ms_on=on["step_ms"], step_ms_off=off["step_ms"],
               wait_ms_on=on["wait_ms"], wait_ms_off=off["wait_ms"],
               build_ms=on["build_ms"], plan_mib=[b / 2 ** 20 for b in nbytes],
               copy_ms=copy_ms, device_build_ms=device_ms, device_build_syncs=syncs)
    total = {k: [w + t for w, t in zip(r["wait_ms"], r["step_ms"])]
             for k, r in (("on", on), ("off", off))}
    out.update(total_ms_on=total["on"], total_ms_off=total["off"])
    print(f"[{tag}] step ms on {np.median(on['step_ms'][1:]):.1f} / off "
          f"{np.median(off['step_ms'][1:]):.1f} (median of the last 2); data wait + step "
          f"ms on {', '.join(f'{t:.1f}' for t in total['on'])} / off "
          f"{', '.join(f'{t:.1f}' for t in total['off'])}; host build "
          f"{np.median(on['build_ms']):.1f} ms a batch; in-step build "
          f"{np.median(device_ms):.1f} ms, {int(np.median(syncs))} syncs")
    del runs, on, off
    gc.collect()
    torch.cuda.empty_cache()
    return out


class windowed_switch:
    """``PONDER_WINDOWED_GATHER`` set to "1" (or removed) inside the block,
    restored after it."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.saved = os.environ.get("PONDER_WINDOWED_GATHER")
        if self.on:
            os.environ["PONDER_WINDOWED_GATHER"] = "1"
        else:
            os.environ.pop("PONDER_WINDOWED_GATHER", None)

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("PONDER_WINDOWED_GATHER", None)
        else:
            os.environ["PONDER_WINDOWED_GATHER"] = self.saved


def checked_windowed_kernels(errors):
    """Swap K4's and K5's wrappers for ones that also run each call's plain
    version on the same inputs and keep (error, max|ref|) in ``errors``
    (kernel name: list); returns the restore function."""
    from ponderv2_tpu_torch.ops import windowed_gather as wg

    saved = (wg.windowed_conv_fwd, wg.windowed_conv_dw)

    def wrap(kernel, plain, name):
        def call(*args):
            out = kernel(*args)
            errors.setdefault(name, []).append(max_err(out, plain(*args)))
            return out
        return call

    wg.windowed_conv_fwd = wrap(saved[0], wg.windowed_conv_fwd_plain, "windowed_conv_fwd")
    wg.windowed_conv_dw = wrap(saved[1], wg.windowed_conv_dw_plain, "windowed_conv_dw")

    def restore():
        wg.windowed_conv_fwd, wg.windowed_conv_dw = saved
    return restore


def windowed_conv_times(gmodel, inputs):
    """Per SubMConv that takes the windowed route in one forward of
    ``gmodel`` (no grad, switch on): (rows, cin, cout, taps, share of
    entries inside their windows, the windowed conv's ms forward over its
    rulebook's route, the plain gather conv's, K4's alone, the windowed
    forward + backward's ms and the plain one's, the route's build (the
    first conv over each rulebook; the step builds it once a rulebook, 0.0
    for the convs after), the residual's entries), CUDA events around each
    call on the step's own features, rulebook and weights."""
    import torch

    from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv, subm_route
    from ponderv2_tpu_torch.ops import windowed_gather as wg
    from ponderv2_tpu_torch.ops.spconv import (BandedRulebook, SubmPlan, WINDOW_WB,
                                               build_windowed_route, subm_conv_gather,
                                               subm_conv_symmetric)

    seen = []

    def grab(module, args):
        st, rb = args[0], args[1]
        if subm_route(rb, module.in_channels, module.out_channels,
                      module.kernel_size) == "windowed":
            legacy = rb.legacy if isinstance(rb, (SubmPlan, BandedRulebook)) else rb
            seen.append((module, st.features.detach(), legacy, st.mask))

    hooks = [m.register_forward_pre_hook(grab) for m in gmodel.modules()
             if isinstance(m, SubMConv)]
    try:
        with windowed_switch(True), torch.no_grad():
            gmodel(inputs)
    finally:
        for h in hooks:
            h.remove()
    rows, built = [], set()
    for module, f, legacy, mask in seen:
        cdt = module.compute_dtype or f.dtype
        w = module.taps().detach()
        route = build_windowed_route(legacy, f.shape[0])
        build_ms = 0.0
        if id(legacy) not in built:
            built.add(id(legacy))
            build_ms = cuda_ms(lambda: build_windowed_route(legacy, f.shape[0]), 3)
        fp = wg.pad_features(f, wg.padded_rows(f.shape[0], WINDOW_WB), cdt)
        wc = w.to(cdt).contiguous()
        g = torch.randn(f.shape[0], w.shape[2], device=f.device)

        def conv(x, wt, windowed):
            if windowed:
                return subm_conv_symmetric(x, legacy, wt, mask, cdt, route)
            return subm_conv_gather(x, legacy, wt, mask, cdt)

        def fwd(windowed):
            with torch.no_grad():
                return conv(f, w, windowed)

        def fwd_bwd(windowed):
            x, wt = f.clone().requires_grad_(), w.clone().requires_grad_()
            return torch.autograd.grad(conv(x, wt, windowed), (x, wt), g)

        rows.append((f.shape[0], module.in_channels, module.out_channels,
                     legacy.shape[0], int(route.inside) / max(int(route.live), 1),
                     cuda_ms(lambda: fwd(True), 3), cuda_ms(lambda: fwd(False), 3),
                     cuda_ms(lambda: wg.windowed_conv_fwd(fp, route.geom, wc, WINDOW_WB,
                                                          route.group), 3),
                     cuda_ms(lambda: fwd_bwd(True), 2), cuda_ms(lambda: fwd_bwd(False), 2),
                     build_ms, sum(route.res_counts)))
        del route, fp, wc, g
    del seen
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def unmixed_batch(cfg, dev, static_ctx):
    """The recipe's first ``batch_size`` train scenes collated as its loader
    collates them, but without Mix3D (each voxel once in its scene), on the
    card with ``static_ctx``. Mix3D merges two scenes' voxels into one
    without removing the duplicates, and the subm backward's mirrored
    gather (K2, the plain gather conv) is the gradient of the forward only
    where no voxel is duplicated."""
    import random

    import numpy as np
    import torch

    from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
    from ponderv2_tpu_torch.engines.common import split_batch, with_condition

    np.random.seed(SEED)
    random.seed(SEED)
    dataset = build_dataset(dict(cfg.data.train))
    batch = collate_fn([dataset[i] for i in range(cfg.batch_size)],
                       point_budget=cfg.point_budget, scene_budget=cfg.batch_size)
    arrays, static = split_batch(batch)
    inputs = with_condition({k: torch.as_tensor(v, device=dev) for k, v in arrays.items()},
                            static)
    inputs.update(static_ctx)
    return inputs


def duplicate_voxels(inputs):
    """The batch's valid rows whose (batch, x, y, z) repeats the row before
    (the collate sorts rows by it)."""
    import torch

    c = torch.cat([inputs["batch"][:, None].long(), inputs["grid_coord"].long()], 1)
    valid = inputs["batch"] >= 0
    return int(((c[1:] == c[:-1]).all(1) & valid[1:]).sum())


def windowed_route_phase(dev, recipes):
    """Phase 23b: with ``PONDER_WINDOWED_GATHER`` set (restored after), one
    training step of each recipe in ``recipes`` ((tag, model config,
    [(label, inputs on the card, K1-K3 a step or None), ...]): phase 19's
    MinkUNet34C and phase 18's nuScenes lidarseg fine-tune, batch 12, f32)
    from the seeded state against the same step with the switch off, every
    relu pinned to the switch-off step's decisions (``PinnedRelu``). The
    first batch of each recipe is collated without Mix3D
    (``unmixed_batch``): there the loss and each grad are held within phase
    7's 1e-4 of max|ref| plus 3x the f32 rounding the plain step itself
    carries, which a third run measures with every gather conv and band
    core summing in another order (phase 8's form; ``reordered_*``). On a batch with duplicate voxels (the recipe's own
    first batch, Mix3D) the two routes compute other dW by design (the
    windowed dW gathers directly, JAX ``_windowed_dw``; the plain backward
    by the mirror taps), so its differences are printed, not held. On
    every batch: K1-K3 as without the switch, K4 / K5 launched, each K4 / K5
    call held to its plain version on the call's own inputs (phase 12's
    bound, 1e-4 of max(max|ref|, 1)). Prints the convs by route, each
    windowed conv's share of entries inside their windows, K4 / K5
    launches a step, and on the first batch the windowed convs' ms against
    the same convs' plain gather ms. Returns per recipe its numbers."""
    import torch
    from collections import Counter

    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.models.sparse_unet.layers import InverseConv, StridedConv, SubMConv
    from ponderv2_tpu_torch.ops import spconv
    from ponderv2_tpu_torch.ops import windowed_gather as wg

    reordered_cores = {"band_fwd_core": reordered_fwd, "band_dxdw_core": reordered_dxdw,
                       "band_dw_core": reordered_dw}
    out = {}
    for tag, model_cfg, batches in recipes:
        for b, (label, inputs, per_step) in enumerate(batches):
            gmodel = build_model(dict(model_cfg))
            gmodel.reset_parameters(torch.Generator().manual_seed(SEED))
            gmodel.to(dev).train()
            dups = duplicate_voxels(inputs)
            pin = PinnedRelu()
            with windowed_switch(False):
                loss_p, grads_p, launched_p, secs_p = pin.run(
                    "record", lambda: step_grads(gmodel, inputs))
                # the plain step with every gather conv and band core summing
                # in another order: the f32 rounding each grad carries
                saved_sum = spconv._gather_conv_sum
                spconv._gather_conv_sum = reordered_gather_sum
                try:
                    loss_r, grads_r = pin.run("replay", lambda: step_grads(
                        gmodel, inputs, reordered_cores))[:2]
                finally:
                    spconv._gather_conv_sum = saved_sum
            errors = {}
            restore = checked_windowed_kernels(errors)
            before = [k.launches for k in wg.KERNELS]
            try:
                with windowed_switch(True):
                    loss_w, grads_w, launched_w, secs_w = pin.run(
                        "replay", lambda: step_grads(gmodel, inputs))
            finally:
                restore()
            launches = [k.launches - b for k, b in zip(wg.KERNELS, before)]
            convs = [m for m in gmodel.modules()
                     if isinstance(m, (SubMConv, StridedConv, InverseConv))]
            routes = Counter(m.last_route for m in convs)
            shares = [(m.in_channels, m.out_channels, m.kernel_size,
                       int(m.last_window[0]), int(m.last_window[1]))
                      for m in convs if m.last_window is not None]
            where = f"{tag}, {label}"
            check(launched_w == launched_p and (per_step is None
                                                or launched_p == list(per_step)),
                  f"{where}: K1-K3 launches {launched_w} with the switch, {launched_p} "
                  f"without, routing {per_step}")
            check(min(launches) >= 1, f"{where}: K4/K5 launches {launches} in the step")
            worst = {}
            for name, errs in errors.items():
                for e, scale in errs:
                    check(e <= 1e-4 * max(scale, 1.0),
                          f"{where}: {name} vs plain {e:.3e} at max|ref| {scale:.3e}")
                worst[name] = max(e for e, _ in errs)
            check(sum(len(v) for v in errors.values()) == sum(launches),
                  f"{where}: {sum(len(v) for v in errors.values())} checked calls, "
                  f"launches {launches}")
            check(sorted(grads_w) == sorted(grads_p) == sorted(grads_r),
                  f"{where}: grads of other params")
            ratios, margins = [], []
            for n, r in grads_p.items():
                scale = r.abs().max().item()
                err = (grads_w[n] - r).abs().max().item()
                spread = (grads_r[n] - r).abs().max().item()
                ratios.append((err / max(scale, 1e-30), n))
                margins.append((err / max(1e-4 * scale + 3 * spread, 1e-30), n, err, scale,
                                spread))
            ratios.sort()
            margins.sort()
            if dups == 0:
                check(abs(loss_w - loss_p) <= 1e-4 * abs(loss_p) + 3 * abs(loss_r - loss_p),
                      f"{where}: loss {loss_w} with the switch, {loss_p} without, "
                      f"{loss_r} reordered")
                for m, name, err, scale, spread in margins:
                    check(m <= 1.0, f"{where}: grad {name} {err:.3e} > 1e-4 x {scale:.3e} "
                                    f"+ 3 x reordered {spread:.3e}")
                m, name, err, scale, spread = margins[-1]
                held = (f"held within 1e-4 of max|ref| plus 3x the plain step's own "
                        f"reordered difference; tightest {name}: {err:.3e} against "
                        f"{1e-4 * scale:.3e} + 3 x {spread:.3e}, margin {m:.3f}")
            else:
                held = (f"not held: {dups} duplicate voxels, where the windowed dW "
                        f"(direct gather) and the plain backward (mirror taps) part; "
                        f"{sum(r > 1e-4 for r, _ in ratios)} of {len(ratios)} grads over "
                        f"1e-4, the next worst {ratios[-2][1]} at {ratios[-2][0]:.3e}")
            print(f"[windowed-route] {where}: {dups} duplicate voxels; convs by route "
                  f"{dict(sorted(routes.items(), key=str))}; K4 / K5 launches in the step "
                  f"{launches} (forward, the remat recompute and the subm backward's dx run "
                  f"K4), K1-K3 {launched_w} as without the switch; every K4 / K5 call "
                  f"against its plain version on its own inputs: worst "
                  + ", ".join(f"{k} {v:.3e}" for k, v in sorted(worst.items()))
                  + f"; loss {loss_w:.7f} vs {loss_p:.7f} without the switch; worst grad "
                  f"{ratios[-1][1]} at {ratios[-1][0]:.3e} of max|ref| ({held}; relus "
                  f"pinned, {pin.flips} decisions the switch's own forward would make "
                  f"otherwise); forward + backward {1e3 * secs_w:.1f} ms with the switch, "
                  f"{1e3 * secs_p:.1f} ms without", flush=True)
            inside = sum(s[3] for s in shares)
            live = sum(s[4] for s in shares)
            print(f"[windowed-route] {where}: entries inside their windows per windowed "
                  f"conv (cin -> cout, k): " + ", ".join(
                      f"{ci}->{co} k{k} {a / max(n, 1):.4f} ({a}/{n})"
                      for ci, co, k, a, n in shares)
                  + f"; all {inside / max(live, 1):.4f}", flush=True)
            del grads_p, grads_w, grads_r, errors
            if b:
                del gmodel, pin
                continue
            # the step's forward + backward again, without the per-call checks
            step_s = {}
            for on in (True, False):
                with windowed_switch(on):
                    step_s.setdefault(on, []).append(pin.run(
                        "replay", lambda: step_grads(gmodel, inputs))[3])
            print(f"[windowed-route] {tag}: the step's forward + backward (relus pinned, no "
                  f"checks) {', '.join(f'{1e3 * t:.1f}' for t in step_s[True])} ms with the "
                  f"switch, {', '.join(f'{1e3 * t:.1f}' for t in step_s[False])} ms "
                  f"without", flush=True)
            del pin
            times = windowed_conv_times(gmodel, inputs)
            tot = [sum(r[i] for r in times) for i in range(5, 11)]
            for r in times:
                print(f"[windowed-route] {tag}: conv {r[1]}->{r[2]} {r[3]} taps, {r[0]} "
                      f"rows, inside {r[4]:.4f} ({r[11]} residual entries): forward "
                      f"{r[5]:.3f} ms (K4 alone {r[7]:.3f}, the route's build {r[10]:.3f}) "
                      f"vs plain {r[6]:.3f} ms; forward + backward {r[8]:.3f} vs "
                      f"{r[9]:.3f} ms")
            print(f"[windowed-route] {tag}: the step's {len(times)} windowed convs, one "
                  f"forward each: {tot[0]:.3f} ms (K4 alone {tot[2]:.3f}) vs plain "
                  f"{tot[1]:.3f} ms, plus {tot[5]:.3f} ms for the routes' builds, one a "
                  f"rulebook ({sum(r[10] > 0 for r in times)}); forward + backward "
                  f"{tot[3]:.3f} vs {tot[4]:.3f} ms (CUDA events)", flush=True)
            out[tag] = dict(launches_per_step=launches, max_abs_err=worst,
                            routes={str(k): v for k, v in routes.items()},
                            inside_share=inside / max(live, 1), convs=len(times),
                            fwd_ms=tot[0], plain_fwd_ms=tot[1], k4_ms=tot[2],
                            fwd_bwd_ms=tot[3], plain_fwd_bwd_ms=tot[4], route_ms=tot[5],
                            step_ms=[1e3 * t for t in step_s[True]],
                            plain_step_ms=[1e3 * t for t in step_s[False]])
            del gmodel
            gc.collect()
            torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent-log",
                        help="print phases 12's and 13's times beside this log's")
    opts = parser.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "ponderv2_tpu_torch")):
        # the script copied out of the repo: there is nothing to run
        print(f"chip_smoke: no ponderv2_tpu_torch/ beside {__file__}; run it from the "
              "root of a checkout of the repo", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs "
              "a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    sys.path.insert(0, os.path.join(ROOT, "tools", "experiments"))
    import numpy as np

    from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
    from ponderv2_tpu_torch.engines.common import split_batch
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.models.point_group import cluster
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops import probe_kernels as pk
    from ponderv2_tpu_torch.ops import row_gather as rg
    from ponderv2_tpu_torch.ops import windowed_gather as wg
    from ponderv2_tpu_torch.ops.cuda_build import BUILD_LOGS, load_libraries
    from ponderv2_tpu_torch.ops.sparse import make_sparse_tensor, maybe_sort_by_key
    from ponderv2_tpu_torch.ops.spconv import SubmPlan, apply_sparse_conv
    from ponderv2_tpu_torch.utils.config import Config
    from train_torch import main_worker as train_main_worker
    import probe_bisect_torch
    import probe_gather_torch
    import probe_windowed_torch as probe

    phase_s = {}
    tic = run_start = time.perf_counter()

    def phase_done(name):
        nonlocal tic
        now = time.perf_counter()
        phase_s[name] = now - tic
        print(f"[phase] {name}: {phase_s[name]:.2f} s", flush=True)
        tic = now

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}; "
          "TF32 off for matmul and cuDNN")
    phase_done("1 card")

    # ---- 2. build every kernel: one nvcc per source, all started together
    all_kernels = bc.KERNELS + wg.KERNELS + wg.PROBE_KERNELS + rg.KERNELS + pk.KERNELS
    sources = sorted({k.source for k in all_kernels})
    load_libraries(*sources)
    for module in (bc, wg, rg, pk):
        module.build_kernels()
    for name in sources:
        for ln in BUILD_LOGS.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"[build] {name}: {ln.strip()}")
    t0 = time.perf_counter()
    cluster.load_native()
    print(f"[build] csrc/cluster.cpp (the host clustering): g++ {' '.join(cluster.CXX_FLAGS)} "
          f"in {time.perf_counter() - t0:.1f} s")
    phase_done("2 build")

    # per kernel and path: max error vs plain (f32, bf16), and the ms of the
    # kernel, its plain version and its bound over one train step (or, for
    # K4/K5, one run of the windowed conv entry point)
    def new_stats():
        return {name: dict(err=0.0, err_bf16=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                           bytes_ms=0.0, ops_ms=0.0) for name in KERNEL_SOURCES}

    stats, pstats = new_stats(), new_stats()  # fine-tune path; pretrain path

    cfg = Config.fromfile(CONFIG)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cfg.save_path = tmp
        cfg.seed = SEED
        cfg.device = "cuda"
        model = build_model(dict(cfg.model))
        spunet = model.backbone
        dataset = build_dataset(dict(cfg.data.test))
        # scene 0 gives 4 x 6 fragments, scene 1 4 x 9 (the most points in
        # one 2 cm voxel sets the count): 60 forwards
        scenes = [dataset[i] for i in range(len(dataset))]
        n_fragments = sum(len(s["fragment_list"]) for s in scenes)
        frag = scenes[0]["fragment_list"][0]
        batch = collate_fn([dict(frag)], point_budget=cfg.point_budget_test,
                           scene_budget=1)
        arrays, _ = split_batch(batch)
        inputs = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
        inputs.update(spatial_shape=tuple(cfg.sparse_shape), batch_size=1)

        # ---- 3. K1 against its plain version at the serving slice's shapes
        coords = torch.cat([inputs["batch"][:, None].int(),
                            inputs["grid_coord"].int()], 1)
        st = make_sparse_tensor(inputs["feat"], coords, cfg.sparse_shape, 1)
        level_rb, level_coords, _ = level_plans(spunet, st)
        convs = band_convs(spunet, level_rb)
        check(sum(convs.values()) == BAND_CONVS_PER_FORWARD,
              f"routing gives {sum(convs.values())} band convs per forward")

        gen = torch.Generator(device=dev).manual_seed(SEED)
        k1_serve_err, k1_ms, plain_ms = 0.0, 0.0, 0.0
        for (level, cin, cout), count in sorted(convs.items()):
            legacy, plan = band_plan_of(level_rb[level])
            n = legacy.shape[1]
            valid = (level_coords[level][:, 0] >= 0)[:, None]
            f = torch.randn(n, cin, device=dev, generator=gen) * valid
            w = torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5
            args = (plan.rbt, plan.w0)
            tail = (3, bc.BLOCK, bc.WINDOW)
            out = bc.band_fwd_core(f, *args, w, *tail)
            ref = bc.band_fwd_core_plain(f, *args, w, *tail)
            torch.cuda.synchronize()
            err, scale = max_err(out, ref)
            # f32 both ways; only the order of the 27 x Cin-term sums differs
            check(err <= 1e-4 * max(scale, 1.0),
                  f"K1 f32 L{level} {cin}->{cout}: err {err:.3e} scale {scale:.3e}")
            fb, wb = f.bfloat16(), w.bfloat16()
            errb, _ = max_err(bc.band_fwd_core(fb, *args, wb, *tail),
                              bc.band_fwd_core_plain(fb, *args, wb, *tail))
            # bf16 inputs, f32 products and sums in both, in another order;
            # held to the bench's bf16 bound, 3e-2 (bench.py:227)
            check(errb <= 3e-2 * scale, f"K1 bf16 L{level} {cin}->{cout}: err {errb:.3e}")
            t_k = cuda_ms(lambda: bc.band_fwd_core(f, *args, w, *tail), 10)
            t_p = cuda_ms(lambda: bc.band_fwd_core_plain(f, *args, w, *tail), 10)
            k1_serve_err = max(k1_serve_err, err)
            k1_ms += count * t_k
            plain_ms += count * t_p
            live, compacted, slabs = band_rows_multiplied(plan, n)
            print(f"[K1] L{level} rows {n} {cin}->{cout} x{count}: max_abs_err f32 "
                  f"{err:.3e} (max|ref| {scale:.3e}) bf16 {errb:.3e}; "
                  f"K1 ({k1_tile(torch.float32)}) {t_k:.4f} ms plain {t_p:.4f} "
                  f"ms; band ok {bool(plan.ok)} overflow entries {sum(plan.ov_counts)}; live "
                  f"entries {live}, rows multiplied per column tile: compacted {compacted}, "
                  f"slabs {slabs}")

        # window overflow (block 32 / window 8) and budget gating, through
        # the whole band_subm_conv wrapper against the plain gather conv
        rb4 = level_rb[4]
        n4 = rb4.legacy.shape[1]
        mask4 = level_coords[4][:, 0] >= 0
        f4 = torch.randn(n4, 256, device=dev, generator=gen) * mask4[:, None]
        w4 = torch.randn(27, 256, 256, device=dev, generator=gen) / (27 * 256) ** 0.5
        ovf_plan = bc.build_band_plan(rb4.legacy, 3, block=32, window=8,
                                      pair_budget=10 ** 6, entry_budget=27 * n4)
        check(bool(ovf_plan.ok) and sum(ovf_plan.ov_counts) > 0,
              "block 32 / window 8 plan should be ok with overflow entries")
        with torch.no_grad():
            out = bc.band_subm_conv((3, 32, 8), f4, ovf_plan, w4, mask4)
        ref = apply_sparse_conv(f4, rb4.legacy, w4, mask4)
        err = (out - ref).abs().max().item()
        check(err <= 1e-4 * max(ref.abs().max().item(), 1.0),
              f"overflow case err {err:.3e}")
        k1_serve_err = max(k1_serve_err, err)
        print(f"[K1] block 32 / window 8 at L4: {sum(ovf_plan.ov_counts)} overflow "
              f"entries, max_abs_err vs plain conv {err:.3e}")
        gated = bc.build_band_plan(rb4.legacy, 3, block=32, window=8, pair_budget=0)
        check(not bool(gated.ok), "pair_budget=0 plan should not be ok")
        with torch.no_grad():
            zero = bc.band_subm_conv((3, 32, 8), f4, gated, w4, mask4)
        check(float(zero.abs().sum()) == 0.0, "pair_budget=0 must give exact zeros")
        print("[K1] pair_budget=0: ok False, output exactly zero")
        stats["band_fwd_core"]["err"] = k1_serve_err
        phase_done("3 K1 vs plain, serving shapes")

        # ---- 4. the serving slice: all fragments through main_worker
        weights = os.path.join(tmp, "spunet_seeded.pth")
        torch.save(seeded_state_dict(model, inputs, dev), weights)
        cfg.weight = weights
        served = serve_and_check("slice", cfg, dev)
        tester, forwards, serve_launches = served.tester, served.forwards, served.launches
        del served
        check(forwards == n_fragments,
              f"expected {n_fragments} forwards, ran {forwards}")
        phase_done("4 serving slice")

        # ---- 5. one fragment through the plain versions, same weights
        def run(plain):
            core = bc.band_fwd_core
            if plain:
                bc.band_fwd_core = bc.band_fwd_core_plain
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                with torch.inference_mode():
                    out = tester.model(inputs)
                logits = out["seg_logits"].float()
                torch.cuda.synchronize()
                return logits, bool(out["contract_ok"]), time.perf_counter() - t
            finally:
                bc.band_fwd_core = core

        lk, ok_k, t_k1 = run(False)
        lp, ok_p, t_p1 = run(True)
        _, _, t_p2 = run(True)
        _, _, t_k2 = run(False)
        valid = inputs["batch"] >= 0
        check(ok_k and ok_p, "contract_ok False on the check fragment")
        check(tuple(lk.shape) == (cfg.point_budget_test, 20), f"logits shape {lk.shape}")
        check(bool(torch.isfinite(lk).all()), "non-finite logits")
        check(float(lk[~valid].abs().sum()) == 0.0, "padding rows must be zero")
        scale = lk.abs().max().item()
        diff = (lk - lp).abs().max().item()
        check(diff <= 1e-4 * scale, f"kernel vs plain logits: {diff:.3e} > 1e-4 x {scale:.3e}")
        frag_ms = 1e3 * float(np.median(tester.fragment_seconds))
        print(f"[slice] kernel vs plain path logits: max_abs_diff {diff:.3e}, "
              f"max|logits| {scale:.3e}")
        print(f"[time] per-fragment latency in the tester (median of {forwards}, "
              f"host to logits on host): {frag_ms:.2f} ms")
        print(f"[time] one fragment's forward, kernel path {1e3 * t_k1:.2f} / "
              f"{1e3 * t_k2:.2f} ms, plain path {1e3 * t_p1:.2f} / {1e3 * t_p2:.2f} ms")
        print(f"[time] K1 per serving forward ({BAND_CONVS_PER_FORWARD} band convs): "
              f"{k1_ms:.3f} ms vs plain {plain_ms:.3f} ms")
        del tester, model, spunet, level_rb, level_coords, st, inputs
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("5 serving kernel vs plain")

        # ---- 6. the training slice: 3 steps + one evaluation via main_worker
        # the fine-tune step without the backbone's remat (on by default),
        # the step that phases 6-8 time and check
        tcfg = default_config_parser(TRAIN_CONFIG, {"save_path": os.path.join(tmp, "train"),
                                                    "model.backbone.remat": False})
        tcfg.seed = SEED
        tcfg.device = "cuda"
        run = train_and_check("train", tcfg, dev)
        train_launches, state, b_inputs, st12 = run.launches, run.state, run.b_inputs, run.st
        level_rb, level_coords, tconvs, fused, per_step = (
            run.level_rb, run.level_coords, run.convs, run.fused, run.per_step)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("6 training slice")

        # ---- 7. K1, K2, K3 vs plain at the training batch's shapes
        def bound32(err, scale):
            return err <= 1e-4 * max(scale, 1.0)

        compare_band_kernels(tconvs, fused, level_rb, level_coords, gen, torch.float32,
                             stats)

        # the autograd wrapper's backward with window overflow and gating
        legacy4 = level_rb[4].legacy if isinstance(level_rb[4], SubmPlan) else level_rb[4]
        n4 = legacy4.shape[1]
        mask4 = level_coords[4][:, 0] >= 0
        f4 = torch.randn(n4, 256, device=dev, generator=gen) * mask4[:, None]
        w4 = torch.randn(27, 256, 256, device=dev, generator=gen) / (27 * 256) ** 0.5
        cot = torch.randn(n4, 256, device=dev, generator=gen)
        ovf_plan = bc.build_band_plan(legacy4, 3, block=32, window=8,
                                      pair_budget=10 ** 6, entry_budget=27 * n4)
        gated = bc.build_band_plan(legacy4, 3, block=32, window=8, pair_budget=0)
        check(bool(ovf_plan.ok) and not bool(gated.ok), "overflow / gated plans")
        fp, wp = f4.clone().requires_grad_(), w4.clone().requires_grad_()
        apply_sparse_conv(fp, legacy4, wp, mask4).backward(cot)
        route = bc.fused_bwd_fits
        try:
            for use_fused in (True, False):
                bc.fused_bwd_fits = lambda *a, **k: use_fused
                fb, wb = f4.clone().requires_grad_(), w4.clone().requires_grad_()
                bc.band_subm_conv((3, 32, 8), fb, ovf_plan, wb, mask4).backward(cot)
                (ex, sx), (ew, sw) = max_err(fb.grad, fp.grad), max_err(wb.grad, wp.grad)
                check(bound32(ex, sx) and bound32(ew, sw),
                      f"overflow backward ({use_fused}): dx {ex:.3e}/{sx:.3e} "
                      f"dW {ew:.3e}/{sw:.3e}")
                fz, wz = f4.clone().requires_grad_(), w4.clone().requires_grad_()
                zero = bc.band_subm_conv((3, 32, 8), fz, gated, wz, mask4)
                zero.backward(cot)
                check(float(zero.abs().sum()) == 0.0 and float(fz.grad.abs().sum()) == 0.0
                      and float(wz.grad.abs().sum()) == 0.0,
                      "pair_budget=0 must give exact zero output, dx and dW")
                print(f"[bwd] block 32 / window 8 at L4 ({n4} rows, "
                      f"{sum(ovf_plan.ov_counts)} overflow entries), "
                      f"{'K2' if use_fused else 'K1 + K3'}: dx err {ex:.3e} "
                      f"(max {sx:.3e}), dW err {ew:.3e} (max {sw:.3e}) vs autograd "
                      "through the plain conv; pair_budget=0: zero out, dx, dW")
        finally:
            bc.fused_bwd_fits = route
        del f4, w4, cot, fp, wp
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("7 K1/K2/K3 vs plain, training shapes")

        # ---- 8. one step's grads from the saved state: kernels vs plain
        gmodel = build_model(dict(tcfg.model)).to(dev)
        gmodel.load_state_dict(state)
        gmodel.train()
        grads_kernel_vs_plain("fine-tune step from the trained state", gmodel, b_inputs,
                              per_step, 1e-5, 1e-3, False)
        del gmodel, state, b_inputs, level_rb, level_coords, st12
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("8 grads kernel vs plain")

        # ---- 9. the pretrain step: 3 steps of bench.py's workload
        precords = {"steps": [], "conditions": []}
        pcfg = default_config_parser(PRETRAIN_CONFIG,
                                     {"save_path": os.path.join(tmp, "pretrain")})
        pcfg.seed = SEED
        pcfg.device = "cuda"
        pcfg.hooks = list(pcfg.hooks) + [dict(type=step_probe(precords))]
        torch.cuda.reset_peak_memory_stats(dev)
        for k in bc.KERNELS + wg.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        trainer = train_main_worker(pcfg)
        torch.cuda.synchronize()
        pretrain_s = time.perf_counter() - t0
        pretrain_launches = [k.launches for k in bc.KERNELS + wg.KERNELS]
        pretrain_peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        psteps = precords["steps"]
        p_inputs = {k: torch.as_tensor(v, device=dev)
                    for k, v in split_batch(precords["batch"])[0].items()}
        p_inputs.update(trainer.static_ctx)
        st2, _ = maybe_sort_by_key(batch_to_sparse_tensor(p_inputs))
        spunet = trainer.model.backbone
        level_rb, level_coords, stem = level_plans(spunet, st2)
        pconvs, pfused, p_step = band_routing(spunet, level_rb)
        n_attached = sum(isinstance(rb, SubmPlan) and rb.band is not None
                         for rb in level_rb)
        live = int((p_inputs["batch"] >= 0).sum())
        print(f"[pretrain] {len(psteps)} steps in {pretrain_s:.2f} s; launches (K1..K5) "
              f"{pretrain_launches}; peak memory {pretrain_peak_gib:.3f} GiB")
        print(f"[pretrain] routing at batch {pcfg.batch_size}: {sum(pconvs.values())} band "
              f"convs per forward ({n_attached} of 5 levels with attached band plans), "
              f"{p_step[1]} fused backward (K2), {p_step[2]} split (K1 + K3): launches "
              f"per step {p_step}; {live} live rows of {st2.capacity}; stem route "
              f"{'slab' if isinstance(stem, SubmPlan) else 'plain'}")
        check(len(psteps) == len(trainer.train_loader) == 3, f"{len(psteps)} pretrain steps")
        check(n_attached == 5, f"{n_attached} of 5 levels with attached band plans")
        for i, m in enumerate(psteps):
            print(f"[pretrain] step {i}: loss {m['loss']:.6f} lr {m['lr']:.6e} contract_ok "
                  f"{m['contract_ok']} launches {m['launches']} "
                  + " ".join(f"{k} {m[k]:.4f}" for k in pcfg.metric_keys if k in m))
            check(np.isfinite(m["loss"]), f"pretrain step {i} loss {m['loss']}")
            check(m["contract_ok"] == 1.0, f"pretrain step {i} contract_ok False")
            check(m["lr"] == m["schedule_lr"], f"pretrain step {i} lr != schedule")
            check(m["launches"] == p_step + [0, 0],
                  f"pretrain step {i} launches {m['launches']} != routing {p_step}")
        check(pretrain_launches == [3 * c for c in p_step] + [0, 0],
              f"pretrain launches {pretrain_launches}")
        ckpt = torch.load(os.path.join(pcfg.save_path, "model", "model_last.pth"),
                          map_location="cpu", weights_only=True)
        check(ckpt["step"] == 3, "pretrain checkpoint step")
        batch_times = [v for v, _ in trainer.storage.history("batch_time").values()]
        data_times = [v for v, _ in trainer.storage.history("data_time").values()]
        pstep_times = [b - d for b, d in zip(batch_times, data_times)]
        print(f"[time] pretrain step (host clock, batch to device .. metrics synced): "
              f"{', '.join(f'{1e3 * t:.1f}' for t in pstep_times)} ms, median of the "
              f"last 2 {1e3 * float(np.median(pstep_times[1:])):.1f} ms; data wait "
              f"{', '.join(f'{1e3 * t:.1f}' for t in data_times)} ms")
        print(f"[memory] pretrain peak {pretrain_peak_gib:.3f} GiB")
        del trainer, ckpt
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("9 pretrain steps")

        # ---- 10. K1, K2, K3 vs plain at the pretrain batch's shapes, timed in bf16
        compare_band_kernels(pconvs, pfused, level_rb, level_coords, gen, torch.bfloat16,
                             pstats)
        phase_done("10 K1/K2/K3 vs plain, pretrain shapes")

        # ---- 11. one pretrain step's grads: kernels vs plain, same draws,
        # from the seeded initial state (the trained state of phase 9 has
        # taken a step at the peak lr and is further from smooth)
        gmodel = build_model(dict(pcfg.model))
        gmodel.reset_parameters(torch.Generator().manual_seed(SEED))
        gmodel.to(dev).train()
        B, V, H, W = p_inputs["depth"].shape
        draws = gmodel.draw_noise(torch.Generator(device=dev).manual_seed(SEED), B, V, H * W)
        grads_kernel_vs_plain("pretrain step from the seeded state (bf16)", gmodel,
                              {**p_inputs, "draws": draws}, p_step, 3e-2, 3e-2, True)

        del gmodel, draws
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("11 pretrain grads kernel vs plain")

        # ---- 12. the windowed conv entry point (K4, K5): the probe's shapes
        # and two rulebooks of the pretrain batch
        check([k.launches for k in wg.KERNELS] == [0, 0],
              "K4/K5 launched outside the windowed conv entry point")
        cases = windowed_cases(probe, dev, level_rb, stem)
        inputs_w = [probe.case_inputs(rb, cin, cout, SEED + i, dev)
                    for i, (_, _, rb, cin, cout) in enumerate(cases)]
        parent = parent_times(opts.parent_log) if opts.parent_log else {}
        f32_ms = [0.0, 0.0]  # K4, K5 over the six convs
        bf16 = torch.bfloat16
        for k in wg.KERNELS:
            k.launches = 0
        path = [probe.windowed_conv(rb, *inputs_w[i], probe.BLOCK, probe.WB, group, bf16)
                for i, (_, group, rb, _, _) in enumerate(cases)]
        torch.cuda.synchronize()
        windowed_launches = [k.launches for k in wg.KERNELS]
        check(windowed_launches == [len(cases)] * 2,
              f"windowed conv launches {windowed_launches} for {len(cases)} convs")
        for i, (label, group, rb, cin, cout) in enumerate(cases):
            geom, out, dw = path[i]
            feats, w, g = inputs_w[i]
            _, out_p, dw_p = probe.windowed_conv(rb, feats, w, g, probe.BLOCK, probe.WB,
                                                 group, bf16, plain=True)
            _, out32, dw32 = probe.windowed_conv(rb, feats, w, g, probe.BLOCK, probe.WB,
                                                 group, torch.float32)
            _, out32p, dw32p = probe.windowed_conv(rb, feats, w, g, probe.BLOCK, probe.WB,
                                                   group, torch.float32, plain=True)
            # a second launch of each kernel, in each dtype: equal bits
            for dtype, first in ((bf16, (out, dw)), (torch.float32, (out32, dw32))):
                again = probe.windowed_conv(rb, feats, w, g, probe.BLOCK, probe.WB, group,
                                            dtype)[1:]
                check(all(torch.equal(a, b) for a, b in zip(again, first)),
                      f"{label}: a second K4/K5 launch in {dtype} differs")
            torch.cuda.synchronize()
            # the plain versions sum the same products (bf16 values, f32
            # accumulation) in another order: 1e-4 of max(|ref|, 1) in both
            errs = {}
            for kname, o, r in (("windowed_conv_fwd", out, out_p),
                                ("windowed_conv_dw", dw, dw_p),
                                ("windowed_conv_fwd", out32, out32p),
                                ("windowed_conv_dw", dw32, dw32p)):
                e, sc = max_err(o, r)
                check(e <= 1e-4 * max(sc, 1.0), f"{kname} {label}: err {e:.3e} at {sc:.3e}")
                errs.setdefault(kname, []).append(e)
            n = rb.shape[1]
            # the kernels in f32, timed on their own
            f = wg.pad_features(feats, wg.padded_rows(n, probe.WB), torch.float32)
            gc_ = torch.zeros((geom.rbb.shape[1] * probe.BLOCK, cout), device=dev)
            gc_[:n] = g
            ms32 = (cuda_ms(lambda: wg.windowed_conv_fwd(f, geom, w, probe.WB, group), 5),
                    cuda_ms(lambda: wg.windowed_conv_dw(f, geom, gc_, probe.WB, group), 5))
            f32_ms = [a + b for a, b in zip(f32_ms, ms32)]
            f = wg.pad_features(feats, wg.padded_rows(n, probe.WB), bf16)
            wc = w.to(bf16).contiguous()
            gc_ = torch.zeros((geom.rbb.shape[1] * probe.BLOCK, cout), dtype=bf16,
                              device=dev)
            gc_[:n] = g.to(bf16)
            calls = {
                "windowed_conv_fwd": (
                    lambda: wg.windowed_conv_fwd(f, geom, wc, probe.WB, group),
                    lambda: wg.windowed_conv_fwd_plain(f, geom, wc, probe.WB, group),
                    probe.bound_ms(geom, probe.WB, cin, cout, n, bf16, weights=True)),
                "windowed_conv_dw": (
                    lambda: wg.windowed_conv_dw(f, geom, gc_, probe.WB, group),
                    lambda: wg.windowed_conv_dw_plain(f, geom, gc_, probe.WB, group),
                    probe.bound_ms(geom, probe.WB, cin, cout, n, bf16, weights=False)),
            }
            line, calls_ms = [], {}
            for kname, (kern, plain, (b, term)) in calls.items():
                t_k, t_p = cuda_ms(kern, 5), cuda_ms(plain, 3)
                calls_ms[kname] = t_k
                st = pstats[kname]
                st["err_bf16"] = max(st["err_bf16"], errs[kname][0])
                st["err"] = max(st["err"], errs[kname][1])
                st["ms"] += t_k
                st["plain_ms"] += t_p
                st["bound_ms"] += b
                st["bytes_ms" if term == "bytes" else "ops_ms"] += b
                line.append(f"{'K4' if kname.endswith('fwd') else 'K5'} {t_k:.3f} ms vs "
                            f"plain {t_p:.3f} ms (bound {b:.4f} ms, {term}), err bf16 "
                            f"{errs[kname][0]:.2e} f32 {errs[kname][1]:.2e}")
            live = probe.live_entries(geom, probe.WB)
            print(f"[windowed] {label} ({n} rows, group {group}): covered "
                  f"{bool(geom.covered)} (share {probe.covered_share(geom, probe.WB):.4f}, "
                  f"{live} in-window entries); " + "; ".join(line))
            k3, nrows = rb.shape[0], geom.rbb.shape[1] * probe.BLOCK
            fplan = wg.windowed_fwd_plan(nrows, cin, cout, k3, bf16)
            dplan = wg.windowed_dw_plan(nrows, cin, cout, k3, bf16)
            k4_rows = probe.k4_rows_multiplied(geom, probe.WB)
            k5_rows = probe.k5_rows_multiplied(geom, probe.WB, dplan, bf16)
            print(f"[windowed] {label}: K4 tile slabs {bc.DX_ROWS} x {fplan.co_tile} "
                  f"({fplan.ctas} CTAs), K5 tile {dplan.co_tile} x {dplan.ci_tile} of dW^T "
                  f"({dplan.ctas} CTAs, {dplan.nchunks} chunks of {dplan.chunk} rows; a "
                  f"second launch: equal bits); rows multiplied per channel tile against "
                  f"{live} live entries: K4 {k4_rows} ({k4_rows / max(live, 1):.2f}x), K5 "
                  f"{k5_rows} ({k5_rows / max(live, 1):.2f}x); f32 K4 {ms32[0]:.3f} ms, K5 "
                  f"{ms32[1]:.3f} ms")
            if label in parent:
                (p4, p5), t4, t5 = parent[label], calls_ms["windowed_conv_fwd"], calls_ms[
                    "windowed_conv_dw"]
                print(f"[windowed] {label}: parent -> this tree, K4 {p4:.3f} -> {t4:.3f} ms, "
                      f"K5 {p5:.3f} -> {t5:.3f} ms")
            del f, wc, gc_
        print(f"[windowed] {len(cases)} convs (bf16): K4 {pstats['windowed_conv_fwd']['ms']:.3f} "
              f"ms, K5 {pstats['windowed_conv_dw']['ms']:.3f} ms"
              + (f" (parent {sum(v[0] for v in parent.values()):.3f} / "
                 f"{sum(v[1] for v in parent.values()):.3f} ms over {len(parent)} convs)"
                 if parent else "") + f"; f32: K4 {f32_ms[0]:.3f} ms, K5 {f32_ms[1]:.3f} ms")
        del path, inputs_w, cases, level_rb, level_coords, stem
        phase_done("12 windowed conv K4/K5")

        # ---- 13. the probe kernels: each probe function through its entry
        # point, at its probe's shape and on its inputs
        probe_rows = []
        parent = parent_probe_times(opts.parent_log) if opts.parent_log else {}
        floor_ms = probe_gather_torch.launch_floor_ms(dev)
        print(f"[probe] launch floor: an empty kernel (csrc/row_gather.cu emptied, at P1's "
              f"launch) {floor_ms:.4f} ms ({probe.TIMING})", flush=True)
        # the empty kernel beside each row: at its own grid for P5 ka, else P1's
        empty_ms = {pk.SLAB_SLOTS: probe_bisect_torch.slab_slots_empty_ms(dev)}
        print(f"[probe] an empty kernel at P5 ka's grid (csrc/probe_kernels.cu with slab_slots "
              f"emptied) {empty_ms[pk.SLAB_SLOTS]:.4f} ms", flush=True)
        for v in (probe_gather_torch.variants(dev) + probe_bisect_torch.variants(dev)
                  + probe.profile_variants(dev)):
            for k in all_kernels:
                k.launches = 0
            out = v.run(False)
            torch.cuda.synchronize()
            launched = {k.symbol: k.launches for k in all_kernels if k.launches}
            check(launched == {v.kernel.symbol: 1}, f"{v.name}: launches {launched}")
            m = probe.measure(v, out, 20)
            print("[probe] " + probe.report(v, m)
                  + f"; empty kernel {empty_ms.get(v.kernel, floor_ms):.4f} ms", flush=True)
            if v.name in parent:
                print(f"[probe] {v.name}: parent -> this tree {parent[v.name]:.4f} -> "
                      f"{m['ms']:.4f} ms (device, L2 cold)")
            check(m["agree"], f"{v.name}: kernel vs plain max_abs_err {m['max_abs_err']}")
            probe_rows.append((v, m, launched[v.kernel.symbol]))
            del out
        phase_done("13 probe kernels")

        # ---- 14. the PPT fine-tune recipe from scene files
        ppt_stats = new_stats()
        ppt = ppt_recipe_phase(dev, tmp, gen, ppt_stats)
        phase_done("14 PPT recipe from files")

        # ---- 15. the multi-dataset pretrain from files
        multi_stats = new_stats()
        multi = multi_pretrain_phase(dev, tmp, gen, multi_stats)
        phase_done("15 multi-dataset pretrain from files")

        # ---- 16. the instance-segmentation recipe from files
        insseg_stats = new_stats()
        insseg = insseg_recipe_phase(dev, tmp, gen, insseg_stats)
        phase_done("16 insseg recipe from files")

        # ---- 17. the nuScenes LiDAR pretrain from files
        nus_stats = new_stats()
        nus = nuscenes_pretrain_phase(dev, tmp, gen, nus_stats)
        phase_done("17 nuScenes outdoor pretrain from files")

        # ---- 18. the nuScenes semseg fine-tune from phase 17's checkpoint
        nseg_stats = new_stats()
        nseg = nuscenes_semseg_phase(dev, tmp, gen, nseg_stats, nus["ckpt"])
        phase_done("18 nuScenes semseg fine-tune from files")

        # ---- 19. MinkUNet34C on ScanNet: trained, precise-tested, served
        mink_stats = new_stats()
        mink = minkunet_phase(dev, tmp, gen, mink_stats)
        phase_done("19 MinkUNet34C ScanNet semseg")

        # ---- 20. the SpUNet classifier
        cls_stats = new_stats()
        clf = classifier_phase(dev, tmp, gen, cls_stats)
        phase_done("20 SpUNet classifier")

        # ---- 21. the modules no recipe names: segmentation evaluated on the
        # original points, pointops at scene size, the VolSDF / UniSurf renders
        scene0 = origin_eval_phase(dev, tmp, gen)
        pointops_ms = pointops_phase(dev, scene0)
        extras = render_extras_phase(dev, tmp, p_step)
        del scene0
        phase_done("21 origin-point evaluation, pointops, VolSDF and UniSurf")

        # ---- 22. data parallelism: a world of one over NCCL, then two ranks
        # sharing the card over gloo
        dp = data_parallel_phase(dev, tmp)
        phase_done("22 data parallel")

        # ---- 23. the two JAX paths ported last: (a) the main path's host
        # plan prefetch, (b) the windowed gather conv route on K4/K5
        hp = host_plans_phase(dev, tmp, p_step)
        recipes = [(tag, *r.pop("step_inputs")) for tag, r in
                   (("MinkUNet34C", mink), ("nuScenes semseg", nseg))]
        wr = windowed_route_phase(dev, recipes)
        del recipes
        phase_done("23 host plans and the windowed route")

        # ---- 24. output
        print(f"[time] per fine-tune step at batch {tcfg.batch_size} (f32): "
              + "; ".join(f"{name} {stats[name]['ms']:.3f} ms vs plain "
                          f"{stats[name]['plain_ms']:.3f} ms (bound "
                          f"{stats[name]['bound_ms']:.3f} ms)" for name in BAND_CORES))
        print(f"[time] per pretrain step at batch {pcfg.batch_size} (bf16): "
              + "; ".join(f"{name} {pstats[name]['ms']:.3f} ms vs plain "
                          f"{pstats[name]['plain_ms']:.3f} ms (bound "
                          f"{pstats[name]['bound_ms']:.3f} ms)" for name in BAND_CORES))
        print(f"[time] per PPT fine-tune step at batch 12 (f32): "
              + "; ".join(f"{name} {ppt_stats[name]['ms']:.3f} ms vs plain "
                          f"{ppt_stats[name]['plain_ms']:.3f} ms (bound "
                          f"{ppt_stats[name]['bound_ms']:.3f} ms)" for name in BAND_CORES))
        print(f"[time] per multi-dataset pretrain step at batch 8 (f32, the first batch's "
              f"convs): " + "; ".join(f"{name} {multi_stats[name]['ms']:.3f} ms vs plain "
                                      f"{multi_stats[name]['plain_ms']:.3f} ms (bound "
                                      f"{multi_stats[name]['bound_ms']:.3f} ms)"
                                      for name in BAND_CORES))
        print(f"[time] per insseg step at batch 12 (f32, the first batch's convs): "
              + "; ".join(f"{name} {insseg_stats[name]['ms']:.3f} ms vs plain "
                          f"{insseg_stats[name]['plain_ms']:.3f} ms (bound "
                          f"{insseg_stats[name]['bound_ms']:.3f} ms)" for name in BAND_CORES))
        for label, st in ((f"nuScenes pretrain step at batch 4 (f32, remat, the first batch's "
                           f"convs)", nus_stats),
                          (f"nuScenes semseg step at batch 12 (f32, remat, the first batch's "
                           f"convs)", nseg_stats),
                          (f"MinkUNet34C step at batch 12 (f32, remat, the first batch's "
                           f"convs)", mink_stats),
                          (f"classifier step at batch 32 (f32, remat, the first batch's "
                           f"convs)", cls_stats)):
            print(f"[time] per {label}: " + "; ".join(
                f"{name} {st[name]['ms']:.3f} ms vs plain {st[name]['plain_ms']:.3f} ms "
                f"(bound {st[name]['bound_ms']:.3f} ms)" for name in BAND_CORES))
        print(f"[time] phase 21: pointops ms a call at scene size: "
              + ", ".join(f"{k} {v:.2f}" for k, v in pointops_ms.items())
              + "; " + "; ".join(f"{tag} pretrain steps {', '.join(f'{t:.1f}' for t in r['step_ms'])}"
                                 f" ms, peak {r['peak_gib']:.3f} GiB"
                                 for tag, r in extras.items()))
        print(f"[time] phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))
        print(f"[time] the whole run: {time.perf_counter() - run_start:.1f} s")

        def entry(name, launches, st):
            return {
                "launches": launches,
                "max_abs_err": st["err"],
                "ms": st["ms"],
                "plain_ms": st["plain_ms"],
                "bound_ms": st["bound_ms"],
                "bound_by": "bytes" if st["bytes_ms"] >= st["ops_ms"] else "operations",
                "library_ms": None,
                "timing": EAGER_TIMING,
            }

        # the main path of K1-K3 is the pretrain step (bf16; launches over its
        # 3 steps, times per step); the fine-tune step's numbers (f32) and the
        # serving launches ride along. K4/K5: one run of the windowed conv
        # entry point over its convs
        main_launches = dict(zip(KERNEL_SOURCES, pretrain_launches[:3] + windowed_launches))
        print(f"[time] phase 23a: pretrain step ms with host plans "
              f"{', '.join(f'{t:.1f}' for t in hp['step_ms_on'])}, without "
              f"{', '.join(f'{t:.1f}' for t in hp['step_ms_off'])}; host build "
              f"{', '.join(f'{t:.1f}' for t in hp['build_ms'])} ms a batch")
        kernels = []
        wg_names = ["windowed_conv_fwd", "windowed_conv_dw"]
        for name in KERNEL_SOURCES:
            row = {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
                   "replaces": KERNEL_SOURCES[name][1]}
            row.update(entry(name, main_launches[name], pstats[name]))
            row["max_abs_err_bf16"] = pstats[name]["err_bf16"]
            if name in BAND_CORES:
                i = BAND_CORES.index(name)
                row["fine_tune"] = entry(name, train_launches[i], stats[name])
                row["fine_tune"]["f32_peak"] = F32_PEAK
                row["serving_launches"] = serve_launches[i]
                row["ppt_fine_tune"] = entry(name, ppt["train_launches"][i], ppt_stats[name])
                row["ppt_serving_launches"] = ppt["serve_launches"][i]
                row["multi_pretrain"] = entry(name, multi["train_launches"][i],
                                              multi_stats[name])
                row["insseg"] = entry(name, insseg["train_launches"][i], insseg_stats[name])
                row["nuscenes_pretrain"] = entry(name, nus["train_launches"][i],
                                                 nus_stats[name])
                row["nuscenes_semseg"] = entry(name, nseg["train_launches"][i],
                                               nseg_stats[name])
                row["nuscenes_serving_launches"] = nseg["serve_launches"][i]
                row["minkunet34c"] = entry(name, mink["train_launches"][i], mink_stats[name])
                row["minkunet34c"]["launches_per_step"] = mink["per_step"][i]
                row["minkunet34c_serving_launches"] = mink["serve_launches"][i]
                row["classifier"] = entry(name, clf["train_launches"][i], cls_stats[name])
                row["classifier"]["launches_per_step"] = clf["per_step"][i]
                # phase 22 (b) / (c): each rank's launches a step
                row["data_parallel"] = {
                    "fine_tune_launches_per_rank_step": [
                        [step[i] for step in r["b"]["launches"]] for r in dp["ranks"]],
                    "fine_tune_ms_per_rank_step": [r["b"]["core_ms"][i] for r in dp["ranks"]],
                    "pretrain_launches_per_rank_step": [
                        [step[i] for step in r["c"]["launches"]] for r in dp["ranks"]],
                    "pretrain_ms_per_rank_step": [r["c"]["core_ms"][i] for r in dp["ranks"]]}
            else:
                # phase 23b: the windowed route in a training step, per recipe
                row["windowed_route"] = {
                    tag: {"launches_per_step": r["launches_per_step"][
                              wg_names.index(name)],
                          "max_abs_err": r["max_abs_err"].get(name),
                          "inside_share": r["inside_share"], "convs": r["convs"],
                          "fwd_ms": r["fwd_ms"], "plain_fwd_ms": r["plain_fwd_ms"],
                          "k4_ms": r["k4_ms"], "fwd_bwd_ms": r["fwd_bwd_ms"],
                          "plain_fwd_bwd_ms": r["plain_fwd_bwd_ms"]}
                    for tag, r in wr.items()}
            kernels.append(row)
        # the probe kernels: one row per ported probe function, its launches
        # from its own run through the entry point
        for v, m, launches in probe_rows:
            kernels.append({
                "name": v.name, "route": "cuda",
                "source": f"ponderv2_tpu_torch/csrc/{v.kernel.source}.cu",
                "replaces": v.replaces, "launches": launches,
                **{key: m[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "warm_ms",
                                           "eager_ms", "floor_ms")},
                "timing": probe.TIMING})
        print(json.dumps({"kernels": kernels}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
