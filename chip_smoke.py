#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepipr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on a failed check (so the exit code is not 0):

1. Environment: the card, its power limit, and the float32 settings as
   the port's ``resolve_device`` pins them (TF32 off in cuDNN and cuBLAS:
   f32 on the card is IEEE f32); nothing else sets them.
2. Build: every CUDA kernel of ``deepipr_tpu_torch/csrc`` with nvcc (sm_90a)
   into ``build/deepipr_tpu_torch/``, with ptxas's registers, spills and
   shared memory; each kernel's PTX read for 64-bit integer division (which
   fails the run) and, where the toolkit has cuobjdump, its SASS size.
3. Kernels: each kernel's f32 and bf16 forms against their plain PyTorch
   versions on the card, at the main paths' shapes, the JAX package's test
   shapes and ragged ones (its vector and scalar paths), K2 and its
   gradient K2-bwd twice for bit-identical results, ReLU on and off; then
   timed beside the plain version, a library yardstick where one exists,
   the memory bound, the event timer's own floor and the CUPTI duration,
   ResNet-50's shapes with the ReLU as its positions have it.
4. Serving, in f32 and then in bf16: ResNet18Private at CIFAR-10 width with
   passport_configs/resnet18_passport.json, random weights, passports and BN
   statistics from ``--seed``. The serving path runs through the public
   entry points (Predictor for both branches, the both-branch eval step,
   verify_ownership for genuine and forged passports) with every kernel's
   launch count set to 0 just before and read just after; the card's
   outputs are checked against the same model on the CPU.
5. Throughput: Predictor images/s for both branches at batch 256 and 1024,
   the verification latency, and each branch's device time by kernel
   from torch.profiler (printed, not asserted).
6. Training (bench.py's path), in f32 and then in bf16 (bench.py's
   precision): V2 ResNet18Private from ``--seed``, SGD (lr 0.01, momentum
   0.9, decay 1e-4), batch 256, pad 4, one warm-up and three timed
   device-resident epochs over 12,800 synthetic uint8 images, with the
   launch counts set to 0 just before and read just after (K1's form once
   per step, nothing else); the loss and sign loss must fall. Then two
   steps on the card against the same two steps on the CPU, the trained
   model through the serving entry points, and one profiled train step.
7. The entry point, in-process: ``cli.train_v1`` scheme 0, then
   ``cli.train_v23`` V2 with keys derived from its last.ckpt, ``--bf16
   --epoch-scan --pallas-input``, with launch counts (K1 bf16 every step,
   K2 bf16 in each epoch's validation and signature detection); then
   ``--eval`` of that run, ``verify_ownership`` of its best.ckpt loaded into
   a fresh model, and one V3 epoch. Logdirs under ``build/``.
8. The attack suite, in-process, on that V2 run's best.ckpt (f32): the
   attack grid through ``cli.robustness_grid`` at cut depths (attack 1 with
   8 reps, pruning and flip at 11 levels, attacks 2 and 3 ``--epoch-scan``
   for 1 epoch at flipperc 0, 0.1, 0.25 and 0.5, the forge at those four
   fractions for 100 steps; CSVs under ``build/chip_smoke_grid/logs/``),
   then attack 3 host-fed, with launch counts (K2 f32, K2-bwd, K1 f32 each
   on the grid; no bf16 form) and each step's wall time; the unchanged
   ``tools/collect_robustness.py`` on the grid's CSVs, every section with
   its rows and the card's backend stamp; K2 and K2-bwd launches per
   ambiguity step; the CE and sign-loss gradient on every fake passport;
   one ambiguity step and one forge step on the card against the CPU.
9. AlexNet serving (``alexnet_serve``): V1 and V2 AlexNet at CIFAR-10 width
   (passport_configs/alexnet_passport.json: features_4-6, K2 at
   (N,384,8,8) and (N,256,8,8)) from ``--seed``, f32 and bf16, through
   phase 4's checks with 3 K2 launches per passport forward (V1 on either
   branch, V2 on the private one), their throughput; then one V2 private
   forward of the ImageNet variant (1000 classes, 224 px, K2 at 13x13, the
   scalar path) card vs CPU in f32 and bf16.
10. AlexNet through the entry points (``alexnet_cli``): training.sh's first
    recipe at reduced length, ``cli.train_v1`` scheme 0 for 1 epoch, then
    V1 (``--train-passport --sign-loss 0.1 --key-type shuffle
    --epoch-scan --pallas-input``) and V2 (``cli.train_v23``) for 5 epochs
    each from its last.ckpt, batch 256 over 12,800 images, with launch
    counts (K1 every step, K2 in validation and signature detection); the
    loss falls, the signature is embedded, and each best.ckpt verifies in a
    fresh model.
11. AlexNet attacks (``alexnet_attacks``), the attack CLIs at their
    defaults (--arch alexnet --scheme 1) on the V1 best.ckpt: pruning,
    flip ``--fidxs 4,5,6``, attack 3 for 1 epoch; the forge attack (V2
    only) ``--steps 50`` on the V2 best.ckpt; 3 K2 and 3 K2-bwd launches
    an ambiguity step, and one ambiguity step card vs CPU.
12. Transfer learning (``transfer_path``): ``--transfer-learning`` through
    the train CLIs, rtal and ftal, from the V2 and V3 best.ckpt of phase 7
    and AlexNet V1's of phase 10, TL_EPOCHS epochs each on the synthetic
    set (12,800 images) at batch 256, with launch counts (K2 f32 in the
    derivation, the survival rows and V3's trigger-set retest; no other
    kernel: TL is host-fed); the history's columns, finite rows, the
    experiment's model unchanged, seconds per epoch; then two TL steps card
    vs CPU from the V2 and the V3 checkpoint (V3's trigger-set rows
    included), two train steps with remat="full" against "none" on the
    card, and the peak memory and step time of each at batch 256.
13. Folded inference (``fold_path``): ResNet18Private and AlexNet V2 from
    ``--seed`` folded for each branch (``Predictor(folded=True)``), f32 and
    bf16, against the unfolded model on the card, with no K2 launch in a
    folded forward; then folded and unfolded Predictor img/s side by side.
14. Interop (``interop_path``): the V2 best.ckpt exported to a reference
    .pth and imported into a fresh model bit for bit, verified; a
    hand-built torchvision ResNet18 through ``load_torch_pretrained``, card
    vs CPU at 224 px; an ImageNet ResNet18Private private forward at 224
    px (K2 at (64,512,7,7), held and timed in phase 3), batch 64, card vs
    CPU in f32 and bf16.
15. ResNet-50 (``resnet50_*``, passport_configs/resnet50_passport.json:
    all ten layer4 positions, K2 at (N,512,8,8), (N,512,4,4) and, without
    the ReLU at convbn_3 and shortcut, (N,2048,4,4)): phase 4's serving
    path on ResNet50Private V2 in f32 and bf16 with 10 K2 launches a
    private forward, its throughput and profile; phase 6's training in f32
    and bf16 with a two-step f32 parity whose bounds take the CPU step's
    own spread; the entry point with ``--arch resnet50`` (scheme 0 for 1
    epoch, V2 ``--epoch-scan --pallas-input`` for RESNET50_EPOCHS until the
    signature reads back, best.ckpt verified in a fresh model); an
    ambiguity and a forge step on that checkpoint card vs CPU (10 K2-bwd
    launches a step, 4 without the mask); both branches folded against
    the unfolded model; the checkpoint through a .pth round trip;
    hand-built torchvision ResNet-34 and ResNet-50 at 224 px card vs CPU;
    an ImageNet ResNet50Private private forward at 224 px (K2 at 14x14 and
    7x7) in f32 and bf16.
16. The licensing and dispute workflow (``deploy``), through the CLIs:
    ``cli.train_ensemble`` trains a fleet of two ResNet18Private V2
    licensees signed "Alice" and "Bob" (passports from phase 7's scheme-0
    last.ckpt, ``--epoch-scan``, batch 256 over 12,800 images) until each
    member's detection reads 1.0; ``cli.verify_ownership`` verifies member
    0 with ``--commit`` and ``--check-commitment`` (the record also on the
    CPU) and refuses member 1's passports and member 1's record;
    ``cli.export_deployment``'s artifact against the folded Predictor;
    ``cli.export_torch_checkpoint``'s .pth read back and verified;
    ``cli.serve_http`` in a thread, folded on member 0 and on AlexNet V1's
    best.ckpt ``--no-folded --no-private`` (K2 in every request), each
    answer against an in-process Predictor, 8 concurrent requests, the
    error codes and the median ``latency_ms`` of each bucket. K2 f32
    launches counted over the phase.
17. The host data path (``data``), after phase 11 in the run: a JPEG
    ImageFolder (tools/make_imagefolder.py: 10 classes, 64 training and 16
    validation images a class, 256 px) and a 101-class Caltech folder at
    32 px written under ``build/``; AlexNet's ImageNet head (1000
    classes, 224 px, dropout) through ``cli.train_v1`` scheme 0 for 1
    epoch and ``cli.train_v23`` V2 ``--device-augment --key-type random``
    for 2 epochs f32 and 1 epoch ``--bf16``, batch 64, streamed and
    prefetched, with exact launch counts (K1 at pad 0 with zero draws once
    a step, K2 3 times a validation batch and in signature detection); one
    V2 step on each of the first two streamed batches card vs CPU with
    injected dropout masks (the two chained logged beside the CPU's own
    one-ulp spread); the V2 step's device time alone, on a batch already
    on the card; the prefetch split (the producer's seconds a batch, the
    step's device milliseconds, the epoch's wall time) of the ImageNet
    epochs and of one host-fed ResNet18Private f32 epoch over 12,800
    images; prefetched batches against the loader's own moved by hand,
    bit for bit; the loader alone, a batch's seconds at 1, os.cpu_count()
    and 16 decode threads; and Caltech-101 transfer learning (rtal, 1
    epoch) from phase 7's V2 best.ckpt, its survival rows with K2 counted.
18. The norm types the port trains besides BN (``norms``, after phase 6 in
    the run): ResNet18Private V2 with ``gn``, ``in`` and ``none``, and BN
    with ``--separate-stats``,
    each branch's forward and one train step at batch 32, card vs CPU at
    phase 6's f32 bounds.

19. Multi-process training (``parallel_path``), full width: ResNet18Private
    V2 f32 as phase 6 trains it, batch 256. (a) Four ``gloo`` ranks on
    cuda:0 (NCCL refuses two ranks on one GPU) on a 4x1 mesh: two split V2
    steps and two V3 steps of the mesh epoch (the trigger pair padded to 4
    at weight 0), K1 on each rank's 64 rows, then each rank's evaluation
    (K2); held against one process stepping the same global batches with
    the same draws at phase 6's f32 bounds, the four ranks' states bit for
    bit, K1 and K2 counted on every rank. (d) The model axis on a 2x2 mesh
    over gloo: one step of a model-sharded state equal to the replicated
    step bit for bit, and its multi-process checkpoint round trip. (b) A
    ``shard_ensemble`` fleet of two on the 2x2 mesh, two steps, each member
    against itself stepped alone. (c) ``cli.train_v23 --multihost
    --epoch-scan`` under torchrun with one NCCL rank for 2 epochs, bit for
    bit with the same command without --multihost (history.csv, the
    clock's columns aside, and last.ckpt); then ``--resume`` of it through
    ``load_state_multihost`` and a ``torch.distributed.checkpoint`` round
    trip, bit for bit. Each sub-phase's seconds.

The entry-point runs of phases 7, 10 and 15 hold every signature
detection row of their last epoch, and their best.ckpt in a fresh model,
at exactly 1.0. Their epoch-mean ``train_sign_acc`` is printed, not held:
a scale that crosses zero for a few steps of a high-lr epoch lowers it,
in the JAX package as in the port, from the same state with the same
draws (PERF.md §6).

20. The host augment (``host_augment``, after phase 3 in the run):
    ``deepipr_tpu_torch/csrc/augment.cpp`` built with g++ (``-O3
    -march=native``, data/native.py's ``get_lib``) on the card's host; data/native.py's
    ``augment_normalize_native`` (the host-fed training batch of 256 at pad
    4 with every extreme draw, the trigger set's pair at pad 0) and
    ``normalize_native`` (the CIFAR validation batch, the ImageNet stream's
    64x224x224x3) against their plain versions within HOST_TOL, padding
    and flip positions exact, and both timed on the host. The native calls
    are counted on every host-fed path (HOST_FED: phase 17's host-fed
    ResNet18Private epoch and Caltech-101 TL, phase 12's TL runs, phase
    16's fleet and two servers), each set to 0 just before the path and
    read just after; a path without them fails the run.

21. What TF32 did (``precision``, after phase 20 in the run): ResNet18Private
    V2 f32 against the CPU, (a) the private forward at batch 256 as phase 4
    takes it and (b) one V2 step at batch 32 as phase 6's parity takes it,
    each run first with torch's default flags forced back on after the
    entry point resolved its device (cuDNN's f32 convolutions in TF32, as
    the port computed before its pin; the gaps printed, not held), then
    pinned, held to phase 4's and phase 6's f32 bounds. The gaps: relative
    to the norm and elementwise, each on a line of its own.

The gloo ranks of phase 19 record both TF32 flags after their first entry
points; the run fails unless they read False on every rank.

Each phase's wall time is printed on a line of its own.

The line before the last holds the kernels' JSON record, and the line
before it the host kernel's (``{"host_kernels": [...]}``); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits with
an error before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
REQUEST_BATCH = 256
MAIN_SHAPE = (REQUEST_BATCH, 512, 4, 4)  # every passport block of the path
# tests/test_pallas.py's shapes in NCHW, batch 1 (signature detection), and
# ragged ones: H*W = 49 (ImageNet's layer4, the scalar path) and C not a
# multiple of the channel tile
CHECK_SHAPES = [MAIN_SHAPE, (1, 512, 4, 4), (1024, 512, 4, 4),
                # the V3 trigger-set batch (prepare_wm's 2): the TL retest
                (2, 512, 4, 4),
                (4, 128, 8, 8), (2, 256, 16, 16), (2, 64, 56, 56),
                (2, 128, 28, 28), (8, 512, 7, 7), (3, 40, 5, 3),
                # AlexNet: features_4 (384 channels) and _5/_6 (256) at 8x8
                # (CIFAR) at the request batch and batch 1, and at 13x13
                # (ImageNet, 224 px: the scalar path, tiles of 3 channels,
                # a ragged last tile at 256)
                (256, 384, 8, 8), (256, 256, 8, 8), (1, 384, 8, 8),
                (1, 256, 8, 8), (64, 384, 13, 13), (64, 256, 13, 13),
                # the unfolded AlexNet V1 server's bucket 8 (the deploy
                # phase's 3- and 8-row and concurrent requests, its warm-up)
                (8, 384, 8, 8), (8, 256, 8, 8),
                # ImageNet ResNet18's layer4 at 224 px (interop_path)
                (64, 512, 7, 7),
                # ResNet50Private's layer4 (resnet50_passport.json): the
                # 1x1 convbnrelu_1 of layer4_0 on layer3's 8x8 map, the
                # 2048-channel convbn_3 and shortcut (ReLU off there) at the
                # request batch, Predictor's 1024, detection's 1 and the V3
                # trigger batch's 2; at 224 px 14x14 (H*W = 196, the vector
                # path) and 7x7
                (256, 512, 8, 8), (256, 2048, 4, 4), (1024, 2048, 4, 4),
                (1024, 512, 8, 8), (1, 512, 8, 8), (1, 2048, 4, 4),
                (2, 2048, 4, 4), (64, 512, 14, 14), (64, 2048, 7, 7),
                # the attack steps' forward at the attack CLIs' batch 64
                # (ResNet18Private, AlexNet, ResNet50Private), and ResNet-50
                # bf16 serving's eval step on the SERVE_BF16_CPU_ROWS rows
                # held against the CPU
                (64, 512, 4, 4), (64, 384, 8, 8), (64, 256, 8, 8),
                (64, 512, 8, 8), (64, 2048, 4, 4), (32, 512, 4, 4),
                (32, 512, 8, 8), (32, 2048, 4, 4),
                # the data phase's ImageNet AlexNet: validation at batch 128
                # and its last batch of 32, and signature detection
                (128, 384, 13, 13), (128, 256, 13, 13), (32, 384, 13, 13),
                (32, 256, 13, 13), (1, 384, 13, 13), (1, 256, 13, 13)]
# K2 and K2-bwd timed at AlexNet's shapes besides the main ones
ALEXNET_TIMED = [(256, 384, 8, 8), (256, 256, 8, 8), (64, 384, 13, 13)]
ALEXNET_BWD_TIMED = [(64, 384, 8, 8), (64, 256, 8, 8)]
# K2 at ImageNet ResNet18Private's layer4 (224 px, the interop phase's batch)
IMAGENET_K2 = (64, 512, 7, 7)
# K2 and K2-bwd timed at ResNet50Private's shapes, (shape, relu): the
# 2048-channel positions (convbn_3, shortcut) run without the ReLU; CIFAR
# at the request batch and, at 224 px, the ImageNet batch
RESNET50_TIMED = [((256, 2048, 4, 4), False), ((256, 512, 8, 8), True),
                  ((64, 512, 14, 14), True), ((64, 2048, 7, 7), False)]
RESNET50_BWD_TIMED = [((64, 2048, 4, 4), False), ((64, 512, 8, 8), True)]
# the card against the plain version of the same arithmetic: the GAP sums
# in another order (tests/test_pallas.py's tolerance)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
# K2's bf16 form against its plain version: at most one bf16 unit in the
# last place (both take the normalize in the same IEEE f32 operations, so
# it is expected bit for bit); scale/bias as the f32 form's
BF16_ULPS = 1
BF16 = torch.bfloat16
# the card's model against the CPU's: convolutions accumulate in other
# orders (tests/test_torch_export.py:102's tolerance)
LOGITS_TOL = dict(rtol=1e-3, atol=2e-4)
# K2-bwd: the serving shapes at the attack CLIs' batch 64 and beyond, the
# forge attack's batch 1, 7x7 (the scalar path) and a ragged tile. dy is one
# product of the same f32 factors as the plain version's, under the same
# mask (the kernel's recomputed one against K2's own out > 0): bit for bit;
# the per-channel sums run in another order
# (tests/test_torch_port_cuda.py's tolerance)
BWD_SHAPES = [(64, 512, 4, 4), MAIN_SHAPE, (1024, 512, 4, 4), (1, 512, 4, 4),
              (8, 512, 7, 7), (3, 40, 5, 3),
              # AlexNet's features_4 and _5/_6 at the attack CLIs' batch and
              # the forge attack's batch 1
              (64, 384, 8, 8), (64, 256, 8, 8), (1, 384, 8, 8),
              # ResNet50Private's layer4 at the attack batch and the forge
              # attack's batch 1
              (64, 2048, 4, 4), (64, 512, 8, 8), (1, 2048, 4, 4),
              (1, 512, 8, 8)]
BWD_SUM_TOL = dict(rtol=1e-4, atol=1e-4)
# K1 normalized against its plain version: tests/test_pallas_augment.py's
# tolerance (1 ulp); the pixels before normalizing must agree bit for bit
AUGMENT_TOL = dict(rtol=0.0, atol=3e-7)
# the training slice (bench.py:47, 57-71): 50 steps per epoch
TRAIN_IMAGES, TRAIN_BATCH, TRAIN_PAD, TRAIN_LR = 12800, 256, 4, 0.01
# K1's cases: (label, set shape, batch, pad, draws). The training batch
# first (the one timed), batch 1 and 13, the tests' 16x16, and a 15x15x3
# set whose H*W*C (675) is not a multiple of 16 and whose W is not one of
# 4; then 224 px, where a 672-byte source row lets 73 rows fit the shared
# memory and an image takes 4 tiles of 56 rows: the ImageNet stream's
# batch at pad 0 with zero draws (the data phase's K1, timed too), and
# 223x223 (rows of 669 bytes: byte loads, scalar stores) at pad 28. Every
# extreme draw at 32 and at 224 px follows (augment_cases)
AUGMENT_SHAPES = [
    ("B=256 32x32 pad 4", (TRAIN_IMAGES, 32, 32, 3), TRAIN_BATCH, 4,
     "random"),
    ("B=1 32x32 pad 4", (TRAIN_IMAGES, 32, 32, 3), 1, 4, "random"),
    ("B=13 32x32 pad 4", (TRAIN_IMAGES, 32, 32, 3), 13, 4, "random"),
    ("B=16 16x16 pad 2", (64, 16, 16, 3), 16, 2, "random"),
    ("B=1 15x15 pad 2", (64, 15, 15, 3), 1, 2, "random"),
    ("B=13 15x15 pad 2", (64, 15, 15, 3), 13, 2, "random"),
    ("B=64 224x224 pad 0", (64, 224, 224, 3), 64, 0, "zero"),
    ("B=8 223x223 pad 28", (16, 223, 223, 3), 8, 28, "random"),
]
IMAGENET_AUGMENT = 6  # the index of the 224 px case timed
# timed epochs of the training paths, after one warm-up (ResNet-50's cut
# from 3 for the deploy phase's time; its epochs agree within 0.2 %)
TIMED_EPOCHS = {"resnet18": 3, "resnet50": 2}
# traces taken before a lost kernel record fails (3 until one run on the
# H100 lost records in three traces in a row: 38, 32 and 46 of 50)
PROFILER_ATTEMPTS = 6
ATTACK_BATCH = 64  # the attack CLIs' default --batch-size
# two train steps on the card against the same two on the CPU: metrics and
# BN statistics elementwise; each parameter's update (after - before)
# norm-wise, since a pre-ReLU value within float32 noise of zero lands on
# opposite sides in cuDNN and on the CPU and moves whole gradients
# (tests/test_torch_port_train.py, PARAM_TOL)
PARITY_BATCH = 32
TRAIN_TOL = dict(rtol=1e-3, atol=1e-4)
UPDATE_TOL = 5e-2
# bf16 on the card against bf16 on the CPU. A bf16 forward or backward is
# ill-conditioned elementwise (one bf16 rounding that lands the other way
# moves whole gradients), so the bounds are tests/test_torch_port_bf16.py's
# for the port against JAX: each parameter's update within 0.6 of its norm
# and the whole update within 0.12; metrics and BN statistics within 1e-2;
# private logits within 5e-2 of their norm; forged per-layer detection
# rates within 8 of 512 bits of the CPU run's
BF16_TRAIN_TOL = dict(rtol=1e-2, atol=8e-3)
BF16_UPDATE_TOL = 0.6
BF16_WHOLE_UPDATE_TOL = 0.12
BF16_LOGITS_NORM_TOL = 5e-2
BF16_FORGED_TOL = 8 / 512
# the entry point: the JAX package's CLIs' flags on the port's, logdirs
# under build/ (ignored by git); bench.py's 12,800 images per epoch
REPO = os.path.dirname(os.path.abspath(__file__))
CLI_LOGDIR = os.path.join("build", "chip_smoke_logs")
# the attack grid (cli/robustness_grid.py) at cut depths: 8 attack-1 reps,
# 1 epoch of attacks 2 and 3 at each flipperc, 100 forge steps; run from
# its own directory, which the collector reads, and the collector's
# sections with their tables' rows at those depths
GRID_DIR = os.path.join("build", "chip_smoke_grid")
GRID_TAG = "200"
GRID_DEPTHS = {"attack_rep": 8, "epochs": 1, "steps": 100}
GRID_SECTIONS = {"Attack 1": 3, "Pruning attack": 11, "Sign-flip attack": 11,
                 "Attack 2": 4, "Attack 3": 4, "Forge attack": 4}
CLI_COMMON = ["--arch", "resnet", "--dataset", "synthetic",
              "--batch-size", str(TRAIN_BATCH), "--logdir", CLI_LOGDIR]
CLI_V2 = ["--passport-config", "passport_configs/resnet18_passport.json",
          "--key-type", "shuffle", "--bf16", "--epoch-scan", "--pallas-input"]
# AlexNet: the CLIs' default architecture and passport config
# (features_4-6); the ImageNet variant's serving check at 224 px
ALEXNET_CONFIG = "passport_configs/alexnet_passport.json"
ALEXNET_LOGDIR = os.path.join("build", "chip_smoke_alexnet")
ALEXNET_CLI = ["--arch", "alexnet", "--dataset", "synthetic", "--batch-size",
               str(TRAIN_BATCH), "--logdir", ALEXNET_LOGDIR]
ALEXNET_PASSPORT = ["--passport-config", ALEXNET_CONFIG, "--key-type",
                    "shuffle", "--epoch-scan", "--pallas-input"]
# training.sh's 200, cut for time. On the card V1's epoch-mean sign
# accuracy read 0.99997 after 2 epochs and 0.99990 / 0.99987 after 2 / 3:
# at the recipe's constant lr a few scales near 0 still cross it in some
# steps, while every end-of-epoch detection is already 1.0
ALEXNET_EPOCHS = 5
ALEXNET_K2 = 3  # K2 launches of a passport forward: features_4, 5 and 6
IMAGENET_SIZE, IMAGENET_BATCH = 224, 64
# transfer learning: the paper's fine-tuning removal attack, 2 epochs (cut
# from the recipe's) of the CLIs' 12,800 synthetic images at batch 256
TL_EPOCHS, TL_IMAGES = 2, TRAIN_IMAGES
REMAT_STEPS = 10  # timed train steps of each remat turn
RESNET_CONFIG = "passport_configs/resnet18_passport.json"
RESNET_K2 = 5  # K2 launches of a ResNet18Private private forward
# folded against unfolded logits on the card: f32 at tests/test_fold.py's
# tolerance; bf16 norm-wise, as the serving path holds bf16 logits
FOLD_TOL = dict(rtol=1e-4, atol=1e-4)
# ResNet-50: passport_configs/resnet50_passport.json flags all of layer4
# (10 positions, 4 of them without the ReLU), so a private forward
# launches K2 10 times
RESNET50_CONFIG = "passport_configs/resnet50_passport.json"
RESNET50_K2 = 10
RESNET50_LOGDIR = os.path.join("build", "chip_smoke_resnet50")
RESNET50_CLI = ["--arch", "resnet50", "--dataset", "synthetic",
                "--batch-size", str(TRAIN_BATCH), "--logdir", RESNET50_LOGDIR]
RESNET50_V2 = ["--passport-config", RESNET50_CONFIG, "--key-type", "shuffle",
               "--epoch-scan", "--pallas-input"]
# V2 epochs until the last epoch's mean train_sign_acc reads 1.0 on the
# card (the recipe's 200, cut for time): on the H100 the first epoch reads
# 0.982; 3 sufficed in four runs, but in a fifth (PERF.md section 6)
# epochs 2 and 3 read 0.9999980 and 0.9999922, a few of an epoch's 563,200
# bit-steps crossing the sign while the sign loss still falls
RESNET50_EPOCHS = 5
CONFIGS = {"alexnet": ALEXNET_CONFIG, "resnet50": RESNET50_CONFIG}
MODEL_NAMES = {"resnet18": "ResNet18Private", "resnet50": "ResNet50Private"}
K2_PER_FORWARD = {"alexnet": ALEXNET_K2, "resnet18": RESNET_K2,
                  "resnet50": RESNET50_K2}
# rows of a bf16 serving batch held card vs CPU: bf16 convolutions are
# slow on the CPU (ResNet-50's most), and eval-mode rows are independent
SERVE_BF16_CPU_ROWS = {"resnet18": REQUEST_BATCH, "resnet50": 32}
# train_parity's step count for each training phase, by dtype. ResNet-50:
# one f32 step, its second being ill-conditioned (the sign loss of a random
# 11,264-bit signature drives the first update, and the second amplifies
# its rounding); no bf16 run, bf16 training being too slow on the CPU
PARITY_STEPS = {"resnet18": {torch.float32: 2, BF16: 2},
                "resnet50": {torch.float32: 1}}
# the licensing and dispute workflow (deploy_path): a fleet of two
# ResNet18Private V2 licensees through cli.train_ensemble, each signed with
# its name, trained until each member's detection reads 1.0 (the
# recipe's 200 epochs cut); logs, checkpoints and records under build/
DEPLOY_DIR = os.path.join("build", "chip_smoke_deploy")
DEPLOY_MEMBERS = ("Alice", "Bob")
# member 0's lowest detection read 0.998 after the first epoch in one run
# of two on the H100, 1.0 after the second in both (PERF.md section 6); a
# third for margin
DEPLOY_EPOCHS = 3
# rows of the requests each server answers (its buckets 1, 8, 64 and 256,
# 3 padded to 8), and the requests timed at each bucket for the median
# latency_ms
SERVE_ROWS = (1, 3, 8, 64, 256)
SERVE_TIMED = {1: 20, 8: 20, 64: 10, 256: 5}
HTTP_TIMEOUT = 120  # seconds: no request of the phase may hang the run
# the hand-built torchvision files each ResNet's interop phase loads
TORCHVISION_ARCHS = {"resnet18": ("resnet18",),
                     "resnet50": ("resnet34", "resnet50")}
# the norm types held card vs CPU besides BN (W15): (norm_type,
# separate_stats)
NORM_CASES = (("gn", False), ("in", False), ("none", False), ("bn", True))
# the data phase: a JPEG ImageFolder as tools/make_imagefolder.py writes it
# (10 classes, 64 training and 16 validation images a class, 256 px: 10
# steps an epoch at IMAGENET_BATCH, validation batches of 128 and 32) and
# a 101-class Caltech folder at 32 px, under build/
DATA_DIR = os.path.join("build", "chip_smoke_data")
DATA_CLASSES, DATA_TRAIN, DATA_VAL, DATA_PX = 10, 64, 16, 256
CALTECH_PER_CLASS = 10
# the host augment (host_augment): data/native.py's C++ against its plain
# versions (the JAX package's NumPy path). The float values within
# HOST_TOL: one fused multiply-add against a divide and a subtract, 4.77e-7
# apart at most over every byte value and channel (the CPU tests' bound);
# where a pixel is padding and where it is flipped, exactly. The shapes:
# the host-fed CIFAR training and validation batches, the trigger set's
# pair, the ImageNet stream's normalized batch; host milliseconds, median
# of HOST_REPS calls (HOST_REPS_LARGE at 224 px)
HOST_TOL = dict(rtol=0.0, atol=1e-6)
HOST_REPS, HOST_REPS_LARGE = 20, 5
# {path: native calls on it}, the counts set to 0 just before the path
# (native_reset) and read just after (native_calls)
HOST_CALLS: dict = {}
# the host-fed paths and the native functions each must call
HOST_FED = {
    "data_resnet_host_f32": ("normalize_native", "augment_normalize_native"),
    "data_caltech_tl": ("normalize_native", "augment_normalize_native"),
    "transfer": ("normalize_native", "augment_normalize_native"),
    "fleet": ("normalize_native",),
    "http_folded": ("normalize_native",),
    "http_alexnet_v1": ("normalize_native",),
}
# the parallel path (parallel_path): PARALLEL_RANKS gloo ranks on the one
# card (NCCL refuses two ranks on one GPU); a set of two V2 and two V3
# steps at batch 256, a trigger set of 8, a fleet of two; the entry point
# under torchrun on the CLI's default synthetic set (2048 images, 8 steps
# an epoch). Inputs, rank results and logdirs under build/
PARALLEL_DIR = os.path.join("build", "chip_smoke_parallel")
PARALLEL_RANKS = 4
PARALLEL_SET = 4 * TRAIN_BATCH
PARALLEL_TRIGGERS = 8
PARALLEL_MEMBERS = 2
PARALLEL_TIMEOUT = 420  # seconds for the processes of one launch
PARALLEL_CLI_EPOCHS, PARALLEL_CLI_IMAGES = 2, 2048
PARALLEL_CLI = ["--arch", "resnet", "--dataset", "synthetic", "--batch-size",
                str(TRAIN_BATCH), "--passport-config", RESNET_CONFIG,
                "--key-type", "random", "--epochs", str(PARALLEL_CLI_EPOCHS),
                "--epoch-scan"]


def log(*parts):
    print(*parts, flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Log the wall time of the phase run inside, on a line of its own."""
    t = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t:.1f} s wall")


# ----------------------------------------------------------- environment

def tf32_flags() -> dict:
    """The TF32 flags as read now (every entry point's ``resolve_device``
    pins both off)."""
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def environment() -> str:
    """The card, its power limit and the f32 settings after the port's
    first ``resolve_device``, which nothing else sets; fails unless both
    TF32 flags read False."""
    from deepipr_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; count "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)
    flags = tf32_flags()
    log(f"after resolve_device('cuda'): "
        + " ".join(f"{k}={v}" for k, v in flags.items()))
    if any(flags.values()):
        raise AssertionError(f"resolve_device left TF32 on: {flags}")
    return smi


def build_kernels() -> None:
    from deepipr_tpu_torch.ops import cuda_build

    t = time.perf_counter()
    reports = cuda_build.build()
    log(f"build: {sorted(reports)} in {time.perf_counter() - t:.1f} s "
        f"into {cuda_build.BUILD_DIR}")
    for name, report in reports.items():
        for line in report.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line):
                log(f"  {name}: {line.strip()}")
    for name in cuda_build.kernel_names():
        read_code(name, cuda_build)


def read_code(name: str, cuda_build) -> None:
    """Fail if the kernel's PTX holds a 64-bit integer division or
    remainder, which no kernel of the port should need; log its IEEE f32
    divisions and, where the toolkit has cuobjdump, each compiled
    function's SASS size and the subroutines it calls."""
    ptx = cuda_build.ptx(name)
    div64 = re.findall(r"\b(?:div|rem)\.[su]64\b", ptx)
    fdiv = len(re.findall(r"\bdiv\.rn\.f32\b", ptx))
    log(f"  {name}: PTX holds {len(div64)} 64-bit integer divisions or "
        f"remainders, {fdiv} IEEE f32 divisions")
    if div64:
        raise AssertionError(f"{name}: 64-bit integer division in the PTX")
    try:
        tool = cuda_build.toolkit_program("cuobjdump")
    except RuntimeError:
        log(f"  {name}: cuobjdump not found, SASS not read")
        return
    lib = str(cuda_build.library_path(name))
    usage = subprocess.run([tool, "-res-usage", lib], check=True,
                           capture_output=True, text=True, timeout=120).stdout
    for function, res in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)",
                                    usage):
        log(f"  {name}: {function[-50:]}: {res.strip()}")
    sass = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    for function in sass.split("Function : ")[1:]:
        title = function.splitlines()[0].strip()
        count = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/", function, re.M))
        calls = len(set(re.findall(r"CALL\.\S+\s+(\S+)", function)))
        log(f"  {name}: {title[-50:]}: {count} SASS instructions, "
            f"{calls} subroutine(s) called")


# --------------------------------------------------------------- timing

class DeviceTimer:
    """Median device time of one call, with the L2 cache flushed before
    each call, as the port's caller meets it after other layers' traffic.
    The card is held busy before each timed call so host-side overhead of
    the call is not counted, only the card's work."""

    def __init__(self, iters: int = 50):
        self.iters = iters
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                 device="cuda")  # 256 MB > the 50 MB L2
        self.one = torch.empty(1, device="cuda")

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(self.iters)]
        for start, end in pairs:
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def floor_ms(self) -> float:
        """The timer's own floor: ``ms`` of a one-element ``zero_()``, the
        card's launch-to-event overhead around the smallest kernel."""
        return self.ms(self.one.zero_)

    def profiled_ms(self, fn, kernel: str, clean: bool = False,
                    per_call: int = 1) -> float:
        """Median CUPTI duration (torch.profiler) of the kernel whose name
        holds ``kernel``, over ``iters`` calls of ``fn``, the L2 flushed
        before each: the kernel alone, without the launch. The flush writes
        (as for ``ms``), which leaves the L2 full of dirty lines that the
        kernel's traffic must write back; ``clean`` flushes by reading.
        ``per_call``: kernels of that name a call launches (their durations
        are added). A trace that lost kernel records (CUPTI drops some under
        load) is taken again, up to PROFILER_ATTEMPTS times."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for attempt in range(1, PROFILER_ATTEMPTS + 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(self.iters):
                    if clean:
                        self.flush.sum()
                    else:
                        self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            events = sorted((e for e in prof.events()
                             if e.device_type == DeviceType.CUDA
                             and kernel in e.name),
                            key=lambda e: e.time_range.start)
            if len(events) == self.iters * per_call:
                break
            log(f"  the profiler saw {len(events)} launches of {kernel}, "
                f"expected {self.iters * per_call} (attempt {attempt})")
        else:
            raise AssertionError(f"the profiler lost launches of {kernel} "
                                 f"in {PROFILER_ATTEMPTS} traces")
        us = [e.time_range.elapsed_us() for e in events]
        calls = [sum(us[i:i + per_call]) for i in range(0, len(us), per_call)]
        return statistics.median(calls) / 1e3


# -------------------------------------------------------------- kernels

def memory_diagnostics(timer: DeviceTimer, fn, kernel: str, copy,
                       copy_kernel: str, label: str, smi: str) -> None:
    """Log what bounds a memory kernel in practice: its CUPTI duration
    after a reading flush (clean L2), and the CUPTI duration of one
    PyTorch elementwise kernel (``copy``, named ``copy_kernel``) that reads
    and writes the same bytes, after either flush."""
    diag = {"profiled_clean_ms": timer.profiled_ms(fn, kernel, clean=True),
            "copy_profiled_ms": timer.profiled_ms(copy, copy_kernel),
            "copy_profiled_clean_ms": timer.profiled_ms(copy, copy_kernel,
                                                        clean=True)}
    log(f"{label} memory diagnostics: {json.dumps(diag)} [{smi}]")


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two bf16 tensors in bf16 units in the
    last place, on a monotone line of their bit patterns."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    return int((ordered(a) - ordered(b)).abs().max())


def epilogue_inputs(shape, gen, dtype=torch.float32):
    """y in ``dtype``; the passport outputs and statistics in f32."""
    n, c, h, w = shape
    dev = "cuda"
    y = torch.randn(shape, generator=gen).to(dev, dtype)
    key_out = torch.randn((1, c, h, w), generator=gen).to(dev)
    skey_out = torch.randn((1, c, h, w), generator=gen).to(dev)
    mean = torch.randn(c, generator=gen).to(dev)
    var = (0.5 + 1.5 * torch.rand(c, generator=gen)).to(dev)
    return y, key_out, skey_out, mean, var


def check_epilogue(gen, dtype=torch.float32) -> float:
    """The kernel's ``dtype`` form against its plain version; returns the
    largest error. The bf16 form's out within BF16_ULPS; scale and bias bit
    for bit the plain version's fixed-order GAP, and in bf16 the f32
    form's on the same passport outputs."""
    from deepipr_tpu_torch.ops.passport_epilogue import (
        fixed_order_gap,
        passport_epilogue,
        passport_epilogue_reference,
    )

    worst = 0.0
    cases = [(shape, epilogue_inputs(shape, gen, dtype))
             for shape in CHECK_SHAPES]
    # y and key_out one element off 16-byte alignment: the scalar path at
    # H*W = 16
    y, key_out, *rest = epilogue_inputs(MAIN_SHAPE, gen, dtype)
    cases.append(("misaligned y and key_out", (misaligned(y),
                                               misaligned(key_out), *rest)))
    for label, args in cases:
        case_worst, unequal = 0.0, 0
        for relu in (True, False):
            got = passport_epilogue(*args, relu=relu)
            again = passport_epilogue(*args, relu=relu)
            torch.cuda.synchronize()
            want = passport_epilogue_reference(*args, relu=relu)
            for name, g, a, w in zip(("out", "scale", "bias"), got, again,
                                     want):
                if not torch.equal(g, a):
                    raise AssertionError(f"passport_epilogue {label}: two "
                                         f"calls gave different {name}")
                if name != "out":
                    if not torch.equal(g, w):
                        raise AssertionError(
                            f"passport_epilogue {label} {dtype}: {name} "
                            "differs from fixed_order_gap")
                elif dtype == torch.float32:
                    torch.testing.assert_close(g, w, **KERNEL_TOL)
                elif g.dtype != dtype or bf16_ulps(g, w) > BF16_ULPS:
                    raise AssertionError(
                        f"passport_epilogue {label} {dtype}: {g.dtype}, "
                        f"{bf16_ulps(g, w)} ulps from the plain version")
                err = (g.float() - w.float()).abs().max().item()
                case_worst, worst = max(case_worst, err), max(worst, err)
                unequal += int((g != w).sum())
            if dtype != torch.float32:
                f32 = passport_epilogue(args[0].float().contiguous(),
                                        *args[1:], relu=relu)
                if not all(torch.equal(g, f) for g, f in zip(got[1:],
                                                             f32[1:])):
                    raise AssertionError(f"passport_epilogue {label}: the "
                                         "bf16 form's scale/bias differ "
                                         "from the f32 form's")
        log(f"passport_epilogue {label} {dtype}: agrees with the plain "
            f"version (relu on and off; largest error {case_worst}, "
            f"{unequal} elements not bit for bit), bit-identical over two "
            "calls")
    return worst


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def time_epilogue(gen, timer: DeviceTimer, shape, smi: str,
                  dtype=torch.float32, relu: bool = True) -> dict:
    from deepipr_tpu_torch.ops.passport_epilogue import (
        passport_epilogue,
        passport_epilogue_reference,
    )

    y, key_out, skey_out, mean, var = args = epilogue_inputs(shape, gen,
                                                             dtype)
    _, scale, bias = passport_epilogue_reference(*args, relu=relu)

    def library():
        # the nearest single library call, with scale/bias precomputed
        out = F.batch_norm(y, mean, var, scale, bias, False, 0.0, 1e-5)
        if relu:
            out.relu_()

    n, c, h, w = shape
    # y read and out written in their dtype; the passport outputs, the
    # statistics and scale/bias in f32
    nbytes = (y.element_size() * 2 * n * c * h * w
              + 4 * (2 * c * h * w + 4 * c))
    flops = (5 if relu else 4) * n * c * h * w + 2 * c * h * w
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / F32_FLOPS_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)
    def kernel():
        passport_epilogue(*args, relu=relu)

    copy = torch.empty_like(y)
    memory_diagnostics(timer, kernel, "passport_epilogue_kernel",
                       lambda: torch.mul(y, 1.0, out=copy), "MulFunctor",
                       f"passport_epilogue {shape} {dtype} relu={relu}", smi)
    return {
        "ms": timer.ms(kernel),
        "profiled_ms": timer.profiled_ms(kernel, "passport_epilogue_kernel"),
        "plain_ms": timer.ms(lambda: passport_epilogue_reference(
            *args, relu=relu)),
        "library_ms": timer.ms(library),
        "bound_ms": bound[bound_by],
        "bound_by": bound_by,
    }


def backward_inputs(shape, gen, relu=True):
    """K2-bwd's inputs on the card, (g, y, bias, scale, mean, var, g_scale,
    g_bias), and K2's own out: bias, scale and out from K2 on the same y
    (the plain version takes its mask from that out)."""
    from deepipr_tpu_torch.ops.passport_epilogue import passport_epilogue

    y, key_out, skey_out, mean, var = epilogue_inputs(shape, gen)
    out, scale, bias = passport_epilogue(y, key_out, skey_out, mean, var,
                                         relu=relu)
    c = shape[1]
    g = torch.randn(shape, generator=gen).cuda()
    g_scale = torch.randn(c, generator=gen).cuda()
    g_bias = torch.randn(c, generator=gen).cuda()
    return [g, y, bias, scale, mean, var, g_scale, g_bias], out


def counters_nonzero(t: torch.Tensor) -> int:
    """K2-bwd's arrival counters of t's device and current stream that are
    not 0 (every launch must leave them at 0)."""
    from deepipr_tpu_torch.ops.passport_epilogue import arrival_counters

    torch.cuda.synchronize()
    index = t.device.index
    return int(arrival_counters(
        index, torch.cuda.current_stream(index).cuda_stream).count_nonzero())


def check_backward(gen) -> float:
    """K2-bwd against its plain version fed K2's own out, at BWD_SHAPES and
    a misaligned y, relu on and off: dy bit for bit, dkey_out and dskey_out
    within BWD_SUM_TOL, bit-identical over two calls, the arrival counters
    at 0 after each call. Returns the largest error."""
    from deepipr_tpu_torch.ops.passport_epilogue import (
        passport_epilogue_backward,
        passport_epilogue_backward_reference,
    )

    worst = 0.0
    cases = [(shape, shape) for shape in BWD_SHAPES]
    cases.append(("misaligned y", MAIN_SHAPE))
    for label, shape in cases:
        for relu in (True, False):
            args, out = backward_inputs(shape, gen, relu)
            if label == "misaligned y":
                args[1] = misaligned(args[1])
            calls = []
            for _ in range(2):
                calls.append(passport_epilogue_backward(*args, relu=relu))
                if counters_nonzero(args[1]):
                    raise AssertionError(f"passport_epilogue_backward "
                                         f"{label}: arrival counters left "
                                         "above 0")
            got, again = calls
            g, y, _, scale, mean, var, g_scale, g_bias = args
            want = passport_epilogue_backward_reference(
                g, y, out, scale, mean, var, g_scale, g_bias, relu=relu)
            for name, g, a, w in zip(("dy", "dkey_out", "dskey_out"), got,
                                     again, want):
                if not torch.equal(g, a):
                    raise AssertionError(f"passport_epilogue_backward "
                                         f"{label}: two calls gave "
                                         f"different {name}")
                if name == "dy" and not torch.equal(g, w):
                    raise AssertionError(
                        f"passport_epilogue_backward {label} relu={relu}: "
                        f"dy differs from the plain version's at "
                        f"{int((g != w).sum())} elements")
                torch.testing.assert_close(g, w, **BWD_SUM_TOL)
                worst = max(worst, (g - w).abs().max().item())
        log(f"passport_epilogue_backward {label}: dy bit for bit with the "
            "plain version fed K2's out, the planes within BWD_SUM_TOL (relu "
            "on and off), bit-identical over two calls, counters at 0")
    log(f"passport_epilogue_backward: largest error {worst}")
    return worst


def time_backward(gen, timer: DeviceTimer, shape, smi: str,
                  relu: bool = True) -> dict:
    """K2-bwd (with or without the ReLU mask) beside its plain version and
    the yardstick: ATen's eval-mode batch-norm backward on the same shapes
    (dx, dweight, dbias; no ReLU mask, no passport planes)."""
    from deepipr_tpu_torch.ops.passport_epilogue import (
        passport_epilogue_backward,
        passport_epilogue_backward_reference,
    )

    args, out = backward_inputs(shape, gen, relu)
    g, y, _, scale, mean, var, g_scale, g_bias = args

    def library():
        torch.ops.aten.native_batch_norm_backward(
            g, y, scale, mean, var, None, None, False, 1e-5,
            [True, True, True])

    n, c, h, w = shape
    elems = n * c * h * w
    # the function's least traffic, 12 bytes an element: g and y read and
    # dy written (the mask needs no out); bias, scale, mean, var and the two
    # gradients of scale/bias read; dkey_out and dskey_out written
    nbytes = 4 * (3 * elems + 6 * c + 2 * c * h * w)
    flops = 11 * elems + 2 * c * h * w
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / F32_FLOPS_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)

    def kernel():
        passport_epilogue_backward(*args, relu=relu)

    copy = torch.empty_like(y)
    memory_diagnostics(timer, kernel, "passport_epilogue_bwd_kernel",
                       lambda: torch.add(g, y, out=copy), "CUDAFunctor_add",
                       f"passport_epilogue_backward {shape} relu={relu}", smi)
    return {
        "ms": timer.ms(kernel),
        "profiled_ms": timer.profiled_ms(kernel,
                                         "passport_epilogue_bwd_kernel"),
        "plain_ms": timer.ms(lambda: passport_epilogue_backward_reference(
            g, y, out, scale, mean, var, g_scale, g_bias, relu=relu)),
        "library_ms": timer.ms(library),
        "bound_ms": bound[bound_by],
        "bound_by": bound_by,
    }


def augment_cases(seed: int):
    """K1's inputs on the card: (label, set, idx, (oy, ox, flip), pad), one
    per AUGMENT_SHAPES entry, then every extreme draw (offsets 0 and 2*pad,
    flip on and off) from the 12,800-image set at pad 4 and from the 224
    px set at pad 28, where a tile's source rows are offset by the crop."""
    from deepipr_tpu_torch.data.device_augment import draw_augment

    rng = np.random.default_rng(seed)
    sets = {}
    for _, shape, _, _, _ in AUGMENT_SHAPES:
        if shape not in sets:
            sets[shape] = torch.from_numpy(rng.integers(
                0, 256, shape, dtype=np.uint8)).cuda()
    gen = torch.Generator().manual_seed(seed)
    cases = []
    for label, shape, b, pad, kind in AUGMENT_SHAPES:
        idx = torch.randperm(shape[0], generator=gen)[:b].int()
        draws = (draw_augment(gen, b, pad) if kind == "random" else
                 (torch.zeros(b, dtype=torch.int32),) * 3)
        cases.append((label, sets[shape], idx.cuda(),
                      tuple(t.cuda() for t in draws), pad))
    for label, ds, pad, repeat in (
            ("extreme draws 32x32 pad 4", sets[AUGMENT_SHAPES[0][1]], 4, 2),
            ("extreme draws 224x224 pad 28",
             sets[AUGMENT_SHAPES[IMAGENET_AUGMENT][1]], 28, 1)):
        extremes = torch.tensor(
            [(oy, ox, f) for oy in (0, 2 * pad) for ox in (0, 2 * pad)
             for f in (0, 1)] * repeat, dtype=torch.int32)
        idx = torch.randperm(ds.shape[0],
                             generator=gen)[:len(extremes)].int()
        cases.append((label, ds, idx.cuda(),
                      tuple(extremes[:, i].contiguous().cuda()
                            for i in range(3)), pad))
    return cases


def check_augment(cases, dtype=torch.float32) -> float:
    """K1's ``dtype`` form against its plain version on the same card
    tensors: the pixels (mean 0, std 1/255) bit for bit, the normalized
    batch at AUGMENT_TOL in f32 and bit for bit in bf16. Returns the
    largest normalized error."""
    from deepipr_tpu_torch.data.device_augment import (
        augment_reference,
        scaled_stats,
    )
    from deepipr_tpu_torch.ops.fused_augment import fused_augment

    zero = torch.zeros(3, device="cuda")
    one = torch.ones(3, device="cuda")
    worst = 0.0
    for label, ds, idx, draws, pad in cases:
        exact = dtype != torch.float32
        for stats, tol in (((zero, one), None),
                           (scaled_stats(device="cuda"), AUGMENT_TOL)):
            got = fused_augment(ds, idx, *draws, *stats, pad, dtype)
            torch.cuda.synchronize()
            want = augment_reference(ds[idx.long()], *draws, pad, *stats,
                                     dtype)
            if got.shape != want.shape or got.dtype != dtype:
                raise AssertionError(f"fused_augment {label}: got "
                                     f"{got.dtype} {tuple(got.shape)}")
            if tol is None or exact:
                if not torch.equal(got.view(torch.int16 if exact else
                                            torch.int32),
                                   want.view(torch.int16 if exact else
                                             torch.int32)):
                    raise AssertionError(f"fused_augment {label} {dtype}: "
                                         "differs from the plain version")
            else:
                torch.testing.assert_close(got, want, **tol)
            worst = max(worst, (got.float() - want.float()).abs().max().item())
        log(f"fused_augment {label} {dtype}: agrees with the plain version "
            f"(pixels bit for bit, normalized "
            f"{'bit for bit' if exact else 'within 3e-7'})")
    return worst


def time_augment(timer: DeviceTimer, case, smi: str,
                 dtype=torch.float32) -> dict:
    from deepipr_tpu_torch.data.device_augment import (
        augment_reference,
        scaled_stats,
    )
    from deepipr_tpu_torch.ops.fused_augment import fused_augment

    _, ds, idx, draws, pad = case
    mean255, std255 = scaled_stats(device="cuda")
    _, h, w, c = ds.shape
    b = idx.shape[0]
    size = torch.empty((), dtype=dtype).element_size()
    # the gathered rows read once, the batch written once in its dtype, four
    # int32 per row (idx, oy, ox, flip) and the two (C,) f32 statistics
    nbytes = b * h * w * c * (1 + size) + 16 * b + 8 * c
    flops = 2 * b * h * w * c  # a subtract and a divide per output
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / F32_FLOPS_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)

    def kernel():
        fused_augment(ds, idx, *draws, mean255, std255, pad, dtype)

    rows = ds[:b]
    batch = torch.empty((b, h, w, c), dtype=dtype, device="cuda")
    memory_diagnostics(timer, kernel, "fused_augment_kernel",
                       lambda: batch.copy_(rows), "direct_copy",
                       f"fused_augment {case[0]} {dtype}", smi)

    return {
        "ms": timer.ms(kernel),
        "profiled_ms": timer.profiled_ms(kernel, "fused_augment_kernel"),
        "plain_ms": timer.ms(lambda: augment_reference(
            ds[idx.long()], *draws, pad, mean255, std255, dtype)),
        "library_ms": None,  # no single PyTorch call gathers, crops and flips
        "bound_ms": bound[bound_by],
        "bound_by": bound_by,
    }


# ---------------------------------------------------------------- model

@torch.no_grad()
def random_model(seed: int, dtype=None, arch: str = "resnet18",
                 private: bool = True, num_classes: int = 10,
                 size: int = 32):
    """ResNet18Private (or ``arch`` with its passport config, CONFIGS, V1
    where ``private`` is false) on the CPU in compute dtype ``dtype``: weights,
    passports and BN running stats from ``seed``, each signature ``b`` set
    to the sign of its derived scale (the signature a trained model
    carries)."""
    from deepipr_tpu_torch.attacks.common import derived_affines
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.ops.norms import BatchNorm
    from deepipr_tpu_torch.utils.config import (
        construct_passport_kwargs,
        load_passport_config,
    )

    config = CONFIGS.get(arch, RESNET_CONFIG)
    kw, plkeys = construct_passport_kwargs(load_passport_config(config),
                                           "bn", "random", 0.1)
    model = build_model(arch, num_classes, norm_type="bn", passport_kwargs=kw,
                        private=private, input_size=size, seed=seed,
                        dtype=dtype, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 2.0, generator=gen)
    for path, aux in derived_affines(model, (1, size, size, 3),
                                     private).items():
        block = model.get_submodule(path.replace("/", "."))
        block.b.copy_(torch.where(aux["scale"] >= 0, 1.0, -1.0))
    log(f"model: {arch} {'V2' if private else 'V1'} "
        f"{dtype or torch.float32}, {num_classes} classes, "
        f"{size}x{size}x3, passports in {plkeys}")
    return model


def forged_passports(model, seed: int):
    from deepipr_tpu_torch.serve import passports

    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(b.shape, generator=gen)
            for k, b in passports(model).items()}


def request_batches(count: int, seed: int):
    from deepipr_tpu_torch.data.datasets import normalize, synthetic_dataset

    _, _, x, y = synthetic_dataset(num_train=0, num_test=count * REQUEST_BATCH,
                                   size=32, seed=seed)
    return [{"image": normalize(x[i:i + REQUEST_BATCH]),
             "label": y[i:i + REQUEST_BATCH]}
            for i in range(0, len(x), REQUEST_BATCH)]


def serve_path(gpu_model, cpu_model, batches, forged, launches,
               form: str = "passport_epilogue", private_model: bool = True,
               per_forward: int = 5, cpu_rows: int = REQUEST_BATCH) -> dict:
    """The serving and verification path on the card, checked against the
    CPU. ``launches()`` reads the kernels' launch counts; ``form`` names the
    K2 form the model's dtype takes, ``per_forward`` its launches in a
    passport forward: the private branch's of a V2 model
    (``private_model``), either branch's of a V1 model. A bf16 model's
    private logits are held to the CPU's norm-wise (BF16_LOGITS_NORM_TOL)
    and its forged per-layer detection rates within BF16_FORGED_TOL of the
    CPU's; an f32 model's elementwise and exactly. The logits and eval
    sums are compared on the first ``cpu_rows`` rows of the first batch
    (eval-mode rows are independent): the logits the card served for that
    batch, the sums from a card step on those rows."""
    bf16 = form.endswith("bf16")
    from deepipr_tpu_torch.serve import Predictor, verify_ownership
    from deepipr_tpu_torch.train.steps import (
        make_dual_eval_step,
        make_eval_step,
        run_dual_eval,
        run_eval,
    )

    public = Predictor(gpu_model, ind=0)
    private = Predictor(gpu_model, ind=1)
    served = []  # each batch's private logits
    for batch in batches:
        before = launches()[form]
        logits0 = public.logits(batch["image"])
        between = launches()[form]
        logits1 = private.logits(batch["image"])
        served.append(logits1)
        counted = (between - before, launches()[form] - between)
        if counted != (0 if private_model else per_forward, per_forward):
            raise AssertionError(f"{counted} epilogue launches in a public "
                                 "and a private forward, expected "
                                 f"{per_forward} in each passport forward")
        for logits in (logits0, logits1):
            if logits.shape != (REQUEST_BATCH, 10) or \
                    not torch.isfinite(logits).all():
                raise AssertionError("non-finite or misshapen logits")
    compared = {k: v[:cpu_rows] for k, v in batches[0].items()}
    cpu_logits = Predictor(cpu_model, ind=1, device="cpu").logits(
        compared["image"])
    gpu_logits = served[0][:cpu_rows].cpu()
    if bf16:
        err = ((gpu_logits - cpu_logits).norm() / cpu_logits.norm()).item()
        log(f"  bf16 private logits, card vs CPU: {err:.3g} of their norm")
        if err > BF16_LOGITS_NORM_TOL:
            raise AssertionError(f"bf16 private logits differ from the CPU "
                                 f"run's by {err} of their norm")
    else:
        torch.testing.assert_close(gpu_logits, cpu_logits, **LOGITS_TOL)
    log("Predictor: public and private branches answered "
        f"{len(batches)} batches of {REQUEST_BATCH}; private logits match "
        f"the CPU run's on {cpu_rows} rows; {per_forward} {form} launches "
        "per passport forward")

    if private_model:
        step = make_dual_eval_step(gpu_model)
        metrics = run_dual_eval(step, batches)
        cpu_sums = make_dual_eval_step(cpu_model, device="cpu")(compared)
    else:
        step = make_eval_step(gpu_model)
        metrics = run_eval(step, batches)
        cpu_sums = make_eval_step(cpu_model, device="cpu")(compared)
    gpu_sums = step(compared)
    for k, v in cpu_sums.items():
        if bf16:  # one bf16 logit flip moves a correct count by one
            torch.testing.assert_close(gpu_sums[k].cpu().double(), v.double(),
                                       rtol=2e-2, atol=3.0)
        else:
            torch.testing.assert_close(gpu_sums[k].cpu().double(),
                                       v.double(), rtol=1e-3, atol=1e-2)
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite eval metrics {metrics}")
    log(f"{'dual ' if private_model else ''}eval over {len(batches)} "
        f"batches: {metrics}")

    genuine = verify_ownership(gpu_model, (1, 32, 32, 3),
                               private=private_model)
    if not (genuine["verified"] and genuine["detection_rate"] == 1.0):
        raise AssertionError(f"genuine passports did not verify: {genuine}")
    fake = verify_ownership(gpu_model, (1, 32, 32, 3), private=private_model,
                            claimed_passports=forged)
    fake_cpu = verify_ownership(cpu_model, (1, 32, 32, 3),
                                private=private_model,
                                claimed_passports=forged, device="cpu")
    if fake["verified"] or not fake["detection_rate"] < 0.7:
        raise AssertionError(f"forged passports verified: {fake}")
    gap = max(abs(fake["layers"][k] - fake_cpu["layers"][k])
              for k in fake["layers"])
    if gap > (BF16_FORGED_TOL if bf16 else 0.0):
        raise AssertionError(f"forged rates differ: card {fake['layers']}, "
                             f"CPU {fake_cpu['layers']}")
    log(f"verify_ownership: genuine {genuine['detection_rate']} "
        f"(verified={genuine['verified']}); forged "
        f"{fake['detection_rate']:.4f}, per layer {fake['layers']} "
        f"(largest difference from the CPU run's: {gap})")
    return metrics


def throughput(gpu_model, smi: str, label: str = "f32",
               private: bool = True) -> None:
    from deepipr_tpu_torch.serve import Predictor, verify_ownership

    gen = torch.Generator().manual_seed(7)
    for batch in (256, 1024):
        # device-resident NHWC input: the card's work, not the host copy
        x = torch.randn((batch, 32, 32, 3), generator=gen).cuda()
        for ind in (0, 1):
            pred = Predictor(gpu_model, ind=ind)
            for _ in range(3):
                pred.logits(x)
            torch.cuda.synchronize()
            reps = 20
            t = time.perf_counter()
            for _ in range(reps):
                pred.logits(x)
            torch.cuda.synchronize()
            rate = reps * batch / (time.perf_counter() - t)
            log(f"throughput: Predictor ind={ind} batch={batch} {label}: "
                f"{rate:.1f} img/s [{smi}]")
    times = []
    for _ in range(20):
        t = time.perf_counter()
        verify_ownership(gpu_model, (1, 32, 32, 3), private=private)
        times.append((time.perf_counter() - t) * 1e3)
    log(f"latency: verify_ownership {label} median "
        f"{statistics.median(times):.3f} ms over 20 calls [{smi}]")


def profiled(fn, reps: int, what: str, smi: str, top: int = 12) -> dict:
    """Run ``fn`` ``reps`` times under torch.profiler; log the device time
    per run by kernel and the card's idle share between the first kernel's
    start and the last one's end. Returns {kernel name: us per run}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler saw no kernel on the card")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    log(f"profile: {what}: {busy / reps / 1e3:.3f} ms of kernels per run, "
        f"{len(kernels) / reps:.0f} kernels, card idle "
        f"{100 * (1 - busy / span):.1f} % of the span [{smi}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {100 * us / busy:5.1f} %  {us / reps:9.1f} us/run  "
            f"{name[:100]}")
    return {name: us / reps for name, us in by_name.items()}


def where_time_goes(gpu_model, smi: str, reps: int = 5,
                    per_forward: int = 5) -> None:
    """Device time by kernel over ``reps`` forwards of each branch at batch
    256; ``per_forward``: K2's launches in the ind=1 forward."""
    from deepipr_tpu_torch.serve import Predictor

    x = torch.randn((REQUEST_BATCH, 32, 32, 3),
                    generator=torch.Generator().manual_seed(8)).cuda()
    for ind in (0, 1):
        pred = Predictor(gpu_model, ind=ind)
        for _ in range(3):
            pred.logits(x)
        us = profiled(lambda: pred.logits(x), reps,
                      f"ind={ind} forward, batch {REQUEST_BATCH}", smi)
    k2 = sum(t for name, t in us.items() if "passport_epilogue" in name)
    log(f"  K2 passport_epilogue: {k2:.1f} us per ind=1 forward "
        f"({per_forward} launches), {100 * k2 / sum(us.values()):.2f} % of "
        "its device time")


def resnet_serve(seed: int, smi: str, launches, reset,
                 arch: str = "resnet18") -> dict:
    """The serving path (``serve_path``) on ResNet18Private, or ``arch``
    with its config (ResNet50Private: K2 at (N,512,8,8), (N,512,4,4) and,
    without the ReLU, (N,2048,4,4)), from ``seed``, f32 and bf16, with the
    arch's K2 launches in each private forward and none in a public one
    (bf16 held to the CPU on SERVE_BF16_CPU_ROWS rows); then Predictor's
    img/s, the verification latency and the device time by kernel.
    Returns {path name: launch counts}."""
    batches = request_batches(3, seed)
    prefix = "resnet" if arch == "resnet18" else arch
    out = {}
    for form, dtype in (("passport_epilogue", None),
                        ("passport_epilogue_bf16", BF16)):
        cpu_model = random_model(seed, dtype, arch)
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        forged = forged_passports(cpu_model, seed + 2)
        reset()
        serve_path(gpu_model, cpu_model, batches, forged, launches, form,
                   per_forward=K2_PER_FORWARD[arch],
                   cpu_rows=SERVE_BF16_CPU_ROWS[arch] if dtype
                   else REQUEST_BATCH)
        counts = launches()
        log(f"{MODEL_NAMES[arch]} serving-path launches ({form}): {counts}")
        if not counts[form] or sum(counts.values()) != counts[form]:
            raise AssertionError(f"{form} did not carry the {arch} serving "
                                 f"path: {counts}")
        out[f"{prefix}_serve_{'bf16' if dtype else 'f32'}"] = counts
        label = "bf16" if dtype else "f32"
        throughput(gpu_model, smi, f"{MODEL_NAMES[arch]} {label}")
        where_time_goes(gpu_model, smi, per_forward=K2_PER_FORWARD[arch])
        log(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del gpu_model, cpu_model
    return out


# ------------------------------------------------------------- training

def train_model(seed: int, device: str, dtype=None, arch: str = "resnet18"):
    """bench.py's model: V2 ResNet18Private, resnet18_passport.json with
    ('bn', 'shuffle', 0.1), weights, passports and signatures from seed, in
    compute dtype ``dtype``; or ``arch`` with its config (CONFIGS)."""
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.utils.config import (
        construct_passport_kwargs,
        load_passport_config,
    )

    kw, _ = construct_passport_kwargs(
        load_passport_config(CONFIGS.get(arch, RESNET_CONFIG)),
        "bn", "shuffle", 0.1)
    return build_model(arch, 10, norm_type="bn", passport_kwargs=kw,
                       private=True, seed=seed, dtype=dtype, device=device)


def train_path(seed: int, smi: str, launches, reset, dtype=torch.float32,
               arch: str = "resnet18"):
    """bench.py's loop through the port's entry points, in ``dtype`` (K1's
    output and the model's compute dtype): one warm-up and TIMED_EPOCHS[arch]
    timed epochs, host-clocked with one read of the epoch's mean metrics at
    its end; img/s from the best timed epoch. Returns the trained model,
    its state, the resident set, the path's launch counts, held-out batches
    of the same synthetic distribution and the img/s. ``arch``: the model
    of ``train_model``."""
    from deepipr_tpu_torch.data.datasets import normalize, synthetic_dataset
    from deepipr_tpu_torch.train.epoch import (
        device_resident,
        make_epoch_train_fn,
    )
    from deepipr_tpu_torch.train.state import TrainState

    x, y, x_test, y_test = synthetic_dataset(
        num_train=TRAIN_IMAGES, num_test=2 * REQUEST_BATCH, size=32, seed=seed)
    held_out = [{"image": normalize(x_test[i:i + REQUEST_BATCH]),
                 "label": y_test[i:i + REQUEST_BATCH]}
                for i in range(0, len(x_test), REQUEST_BATCH)]
    bf16 = dtype == BF16
    k1 = "fused_augment_bf16" if bf16 else "fused_augment"
    model = train_model(seed, "cuda", dtype if bf16 else None, arch)
    xs, ys = device_resident(x, y)
    epoch_fn = make_epoch_train_fn(model, True, TRAIN_BATCH, TRAIN_PAD,
                                   seed=seed, out_dtype=dtype)
    state = TrainState.create(model, TRAIN_LR)
    steps = TRAIN_IMAGES // TRAIN_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset()
    history, seconds = [], []
    for epoch in range(1 + TIMED_EPOCHS[arch]):
        t = time.perf_counter()
        state, metrics = epoch_fn(state, xs, ys, epoch_key=1000 * seed + epoch)
        values = torch.stack(list(metrics.values())).tolist()  # one sync
        seconds.append(time.perf_counter() - t)
        history.append(dict(zip(metrics, values)))
        log(f"train epoch {epoch} ({'warm-up' if epoch == 0 else 'timed'}): "
            f"{seconds[-1]:.3f} s, {history[-1]}")
    counts = launches()

    log(f"training-path launches ({dtype}): {counts}")
    epochs = 1 + TIMED_EPOCHS[arch]
    if counts[k1] != steps * epochs or sum(counts.values()) != counts[k1]:
        raise AssertionError(f"{k1} launched {counts[k1]} times in {epochs} "
                             f"epochs of {steps} steps; all counts {counts}")
    for k in ("loss", "sign_loss"):
        if not history[-1][k] < history[0][k]:
            raise AssertionError(f"mean {k} did not fall: {history[0][k]} in "
                                 f"the first epoch, {history[-1][k]} in the "
                                 "last")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"non-finite training metrics {history}")
    best = min(seconds[1:])
    rate = steps * TRAIN_BATCH / best
    log(f"throughput: train {MODEL_NAMES[arch]} V2 batch {TRAIN_BATCH} "
        f"{'bf16' if bf16 else 'f32'}, device-resident epoch "
        f"incl. K1: {rate:.1f} img/s (best of {TIMED_EPOCHS[arch]} epochs: "
        f"{', '.join(f'{s:.3f}' for s in seconds[1:])} s) [{smi}]")
    log(f"peak device memory, training: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, state, xs, ys, counts, held_out, rate


def parity_inputs(seed: int, dtype=torch.float32, arch: str = "resnet18",
                  cpu_model=None) -> dict:
    """``train_parity``'s inputs: a V2 model on the CPU (``cpu_model``, or
    ``train_model``'s at ``seed + 3``), its starting parameters, a set of
    two batches, their permutation and each step's augmentation draws."""
    from deepipr_tpu_torch.data.datasets import synthetic_dataset
    from deepipr_tpu_torch.data.device_augment import draw_augment

    x, y, _, _ = synthetic_dataset(num_train=2 * PARITY_BATCH, num_test=0,
                                   size=32, seed=seed + 3)
    gen = torch.Generator().manual_seed(seed + 4)
    perm = torch.randperm(len(x), generator=gen)
    draws = [draw_augment(gen, PARITY_BATCH, TRAIN_PAD) for _ in range(2)]
    if cpu_model is None:
        cpu_model = train_model(seed + 3, "cpu",
                                dtype if dtype == BF16 else None, arch)
    start = {k: p.detach().clone() for k, p in cpu_model.named_parameters()}
    return {"x": x, "y": y, "perm": perm, "draws": draws, "dtype": dtype,
            "model": cpu_model, "start": start}


def parity_run(inputs: dict, dev: str, model, steps: int,
               around=contextlib.nullcontext) -> dict:
    """``steps`` train steps of ``model`` (on ``dev``) over ``inputs``
    through the epoch entry point, the steps themselves run inside
    ``around()``, after the entry point has resolved its device. Returns
    the epoch's mean metrics; ``model`` holds the trained state."""
    from deepipr_tpu_torch.train.epoch import (
        device_resident,
        make_epoch_train_fn,
    )
    from deepipr_tpu_torch.train.state import TrainState

    draws = inputs["draws"]
    fn = make_epoch_train_fn(
        model, True, PARITY_BATCH, TRAIN_PAD, device=dev,
        out_dtype=inputs["dtype"],
        draws=lambda step, n: tuple(t.to(dev) for t in draws[step]))
    state = TrainState.create(model, TRAIN_LR)
    xs, ys = device_resident(inputs["x"], inputs["y"], dev)
    perm = inputs["perm"][:steps * PARITY_BATCH].to(dev)
    with around():
        state, metrics = fn(state, xs, ys, 0, perm=perm)
        return {k: v.item() for k, v in metrics.items()}


def train_parity(seed: int, dtype=torch.float32, arch: str = "resnet18",
                 steps: int = 2, cpu_model=None, label: str = "") -> None:
    """``steps`` (1 or 2) steps from the same weights, permutation and
    draws: the card through the kernels, the CPU through their plain
    versions. In bf16 the parameters are held norm-wise only
    (BF16_UPDATE_TOL per parameter, BF16_WHOLE_UPDATE_TOL for the whole
    update), the metrics and BN statistics at BF16_TRAIN_TOL.
    ``cpu_model``: a V2 model on the CPU in place of ``train_model``'s."""
    inputs = parity_inputs(seed, dtype, arch, cpu_model)
    cpu = inputs["model"]
    gpu = copy.deepcopy(cpu).to("cuda")
    cpu_metrics = parity_run(inputs, "cpu", cpu, steps)
    gpu_metrics = parity_run(inputs, "cuda", gpu, steps)
    compare_training(f"train parity {label or arch} ({dtype}): {steps} "
                     f"steps at batch {PARITY_BATCH}", cpu, gpu,
                     inputs["start"], cpu_metrics, gpu_metrics, dtype == BF16)


def training_gaps(cpu, gpu, start: dict, cpu_metrics: dict,
                  gpu_metrics: dict, tol: dict) -> dict:
    """How far the card's trained model ``gpu`` lies from the CPU's
    ``cpu`` (both from the ``start`` parameters): each state entry's
    largest excess over ``tol`` (negative: within it) and largest
    difference, each metric's, and each parameter's update difference over
    the update's norm ("update") and the whole update's."""
    gpu_state = gpu.state_dict()
    beyond, largest, update_err, diffs, updates = {}, {}, {}, [], []
    for name, want in cpu.state_dict().items():
        got = gpu_state[name].cpu()
        limit = tol["atol"] + tol["rtol"] * want.abs()
        beyond[name] = ((got - want).abs() - limit).max().item()
        largest[name] = (got - want).abs().max().item()
        if name in start:
            update = want - start[name]
            update_err[name] = ((got - want).norm().item()
                                / max(update.norm().item(), 1e-30))
            diffs.append((got - want).ravel())
            updates.append(update.ravel())
    metrics = {k: (abs(gpu_metrics[k] - v),
                   abs(gpu_metrics[k] - v) - tol["atol"] - tol["rtol"] * abs(v))
               for k, v in cpu_metrics.items()}
    return {"beyond": beyond, "largest": largest, "update": update_err,
            "whole": (torch.cat(diffs).norm()
                      / torch.cat(updates).norm()).item(),
            "metrics": metrics}


def compare_training(label: str, cpu, gpu, start: dict, cpu_metrics: dict,
                     gpu_metrics: dict, bf16: bool = False,
                     what: str = "card vs CPU") -> None:
    """The card's trained model ``gpu`` against the CPU's ``cpu`` from the
    same ``start`` parameters: metrics, BN statistics and passports at
    TRAIN_TOL (BF16_TRAIN_TOL), each parameter's update within UPDATE_TOL
    (BF16_UPDATE_TOL) of its norm, in bf16 the whole update within
    BF16_WHOLE_UPDATE_TOL."""
    log(f"{label}, {what}: metrics {gpu_metrics} vs {cpu_metrics}")
    tol = BF16_TRAIN_TOL if bf16 else TRAIN_TOL
    update_tol = BF16_UPDATE_TOL if bf16 else UPDATE_TOL
    gaps = training_gaps(cpu, gpu, start, cpu_metrics, gpu_metrics, tol)
    beyond, update_err = gaps["beyond"], gaps["update"]
    worst = max(beyond, key=beyond.get)
    worst_update = max(update_err, key=update_err.get)
    log(f"  largest excess over rtol {tol['rtol']} / atol {tol['atol']}: "
        f"{beyond[worst]:.3g} at {worst}; largest parameter-update "
        f"difference {update_err[worst_update]:.3g} of the update's norm at "
        f"{worst_update}; whole update {gaps['whole']:.3g}")
    failed = [k for k, (_, excess) in gaps["metrics"].items()
              if not excess <= 0]
    failed += [k for k in beyond
               if k not in start and beyond[k] > 0]  # BN stats, passports
    failed += [k for k, e in update_err.items() if e > update_tol]
    if bf16 and gaps["whole"] > BF16_WHOLE_UPDATE_TOL:
        failed.append(f"whole update {gaps['whole']}")
    if failed:
        raise AssertionError(f"{label}: {what} training differ in "
                             f"{failed}")
    log(f"  metrics, BN statistics and passports within rtol {tol['rtol']} "
        f"/ atol {tol['atol']}; every parameter's update within "
        f"{update_tol} of its norm")


def logits_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The card's logits ``got`` against the CPU's ``want``: the
    difference over their norm, the largest elementwise difference, and
    the largest excess over LOGITS_TOL (negative: within it)."""
    diff = (got - want).abs()
    limit = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * want.abs()
    return {"norm": ((got - want).norm() / want.norm()).item(),
            "max_abs": diff.max().item(),
            "excess": (diff - limit).max().item()}


def precision(seed: int, smi: str) -> dict:
    """What TF32 did to the port's f32 (phase 21): ResNet18Private V2 f32
    on the card against the CPU, each item run twice, first with torch's
    default flags forced back on after the entry point has resolved its
    device (``torch_default_tf32``: what the port computed before the pin;
    printed, not held), then pinned (held to the f32 bounds). (a) The
    private forward at batch 256, as ``serve_path`` takes it; (b) one V2
    step at batch 32, as ``train_parity`` takes it. Returns the gaps."""
    from deepipr_tpu_torch.serve import Predictor
    from deepipr_tpu_torch.utils.device import torch_default_tf32

    runs = (("TF32 forced on", torch_default_tf32),
            ("pinned", contextlib.nullcontext))
    out = {}
    cpu_model = random_model(seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    image = request_batches(1, seed)[0]["image"]
    want = Predictor(cpu_model, ind=1, device="cpu").logits(image)
    private = Predictor(gpu_model, ind=1)
    for run, around in runs:
        with around():
            got = private.logits(image).cpu()
        gap = out[f"(a) {run}"] = logits_gap(got, want)
        log(f"precision (a) private logits, batch {REQUEST_BATCH}, {run}: "
            f"card vs CPU {gap['norm']:.3g} of their norm, largest "
            f"elementwise difference {gap['max_abs']:.3g}, largest excess "
            f"over rtol {LOGITS_TOL['rtol']} / atol {LOGITS_TOL['atol']} "
            f"{gap['excess']:.3g} [{smi}]")
    torch.testing.assert_close(got, want, **LOGITS_TOL)  # the pinned run's

    inputs = parity_inputs(seed)
    cpu, start = inputs["model"], inputs["start"]
    cards = {run: copy.deepcopy(cpu).to("cuda") for run, _ in runs}
    cpu_metrics = parity_run(inputs, "cpu", cpu, 1)
    for run, around in runs:
        gpu_metrics = parity_run(inputs, "cuda", cards[run], 1, around)
        gaps = training_gaps(cpu, cards[run], start, cpu_metrics,
                             gpu_metrics, TRAIN_TOL)
        stats = [k for k in gaps["beyond"] if k not in start]
        worst = max(gaps["update"], key=gaps["update"].get)
        gap = out[f"(b) {run}"] = {
            "metrics_rel": max(d / max(abs(cpu_metrics[k]), 1e-30)
                               for k, (d, _) in gaps["metrics"].items()),
            "metrics_excess": max(e for _, e in gaps["metrics"].values()),
            "stats_max_abs": max(gaps["largest"][k] for k in stats),
            "stats_excess": max(gaps["beyond"][k] for k in stats),
            "update": gaps["update"][worst], "update_at": worst,
            "whole": gaps["whole"]}
        log(f"precision (b) one V2 step, batch {PARITY_BATCH}, {run}: "
            f"metrics {gap['metrics_rel']:.3g} apart relative to the CPU's "
            f"(excess over rtol {TRAIN_TOL['rtol']} / atol "
            f"{TRAIN_TOL['atol']} {gap['metrics_excess']:.3g}); BN "
            f"statistics and passports {gap['stats_max_abs']:.3g} apart at "
            f"most (excess {gap['stats_excess']:.3g}); largest parameter "
            f"update {gap['update']:.3g} of its norm apart at "
            f"{gap['update_at']} (bound {UPDATE_TOL}), the whole update "
            f"{gap['whole']:.3g} [{smi}]")
        if run == "pinned":
            compare_training(f"precision (b) one V2 step, {run}", cpu,
                             cards[run], start, cpu_metrics, gpu_metrics)
    log(f"precision: {json.dumps(out)}")
    return out


def trained_serving(model, held_out) -> None:
    """The trained model (left in train mode) through the eval entry
    points on held-out images; none of them may move a BN running
    statistic."""
    from deepipr_tpu_torch.serve import verify_ownership
    from deepipr_tpu_torch.train.steps import (
        make_dual_eval_step,
        make_signature_fn,
        run_dual_eval,
    )

    before = {k: b.clone() for k, b in model.named_buffers()}
    metrics = run_dual_eval(make_dual_eval_step(model), held_out)
    rates = make_signature_fn(model, (1, 32, 32, 3), True)()
    verdict = verify_ownership(model, (1, 32, 32, 3), private=True)
    changed = [k for k, b in model.named_buffers()
               if not torch.equal(b, before[k])]
    if changed or not model.training:
        raise AssertionError(f"the eval entry points moved {changed} or "
                             "left train mode")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite dual-eval metrics {metrics}")
    log(f"trained model: dual eval on held-out images {metrics}; signature "
        f"detection {rates}; "
        f"verify_ownership detection rate {verdict['detection_rate']:.4f} "
        f"(verified={verdict['verified']}); no BN statistic moved")


def train_profile(model, state, xs, ys, seed: int, smi: str,
                  reps: int = 3, dtype=torch.float32) -> None:
    """Device time by kernel over ``reps`` train steps at batch 256, K1's
    share among them."""
    from deepipr_tpu_torch.train.steps import make_train_step

    step = make_train_step(model, True, pad=TRAIN_PAD, seed=seed,
                           out_dtype=dtype)
    rows = torch.randperm(xs.shape[0], device="cuda")[:TRAIN_BATCH].int()
    batch = {"image": xs, "index": rows, "label": ys[rows.long()]}
    step(state, batch)
    us = profiled(lambda: step(state, batch), reps,
                  f"{type(model).__name__} {model.num_blocks} train step "
                  f"{dtype}, batch {TRAIN_BATCH}", smi, top=16)
    k1 = sum(t for name, t in us.items() if "fused_augment" in name)
    log(f"  K1 fused_augment: {k1:.1f} us/step, "
        f"{100 * k1 / sum(us.values()):.2f} % of the step's device time")


def resnet_train(seed: int, smi: str, launches, reset,
                 arch: str = "resnet18") -> dict:
    """bench.py's loop (``train_path``) on ResNet18Private or ``arch``, f32
    and bf16, K1 counted; card against CPU as PARITY_STEPS gives it; the
    trained model through the eval entry points; one profiled step of
    each. Returns {path name: launch counts}."""
    prefix = "resnet" if arch == "resnet18" else arch
    out, rates = {}, {}
    for form, dtype in (("fused_augment", torch.float32),
                        ("fused_augment_bf16", BF16)):
        trained, state, xs, ys, counts, held_out, rates[form] = train_path(
            seed, smi, launches, reset, dtype, arch)
        out[f"{prefix}_train_{'bf16' if dtype == BF16 else 'f32'}"] = counts
        if dtype in PARITY_STEPS[arch]:
            train_parity(seed, dtype, arch, PARITY_STEPS[arch][dtype])
        trained_serving(trained, held_out)
        train_profile(trained, state, xs, ys, seed, smi, dtype=dtype)
        del trained, state, xs, ys
    log(f"throughput: train {MODEL_NAMES[arch]} V2 batch {TRAIN_BATCH}: "
        f"bf16 {rates['fused_augment_bf16']:.1f} img/s beside f32 "
        f"{rates['fused_augment']:.1f} img/s "
        f"({rates['fused_augment_bf16'] / rates['fused_augment']:.2f}x) "
        f"[{smi}]")
    return out


# ------------------------------------------------------------ entry point

def history(logdir: str) -> list:
    import csv

    with open(os.path.join(logdir, "history.csv")) as f:
        return [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def cli_path(smi: str, launches, reset):
    """The training entry point in-process, as a user runs it: scheme 0
    (train_v1), then V2 from its last.ckpt with pretrained-derived shuffle
    keys, bf16 and the device-resident epoch (train_v23), then --eval of
    that run, then its best.ckpt loaded into a fresh model and verified;
    then one V3 epoch. Returns the V2 run's launch counts and the V2 and V3
    runs' best.ckpt."""
    import shutil

    from deepipr_tpu_torch.cli import train_v1, train_v23
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.serve import verify_ownership
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.utils.checkpoint import load_state

    shutil.rmtree(CLI_LOGDIR, ignore_errors=True)
    size = {"synthetic_train": TRAIN_IMAGES}
    t = time.perf_counter()
    run1 = train_v1.main(CLI_COMMON + ["--epochs", "2"], **size)
    log(f"entry point: scheme 0, 2 epochs, in {time.perf_counter() - t:.1f} s")
    pretrained = os.path.join(run1.logdir, "models", "last.ckpt")

    epochs = 4
    reset()
    t = time.perf_counter()
    run2 = train_v23.main(CLI_COMMON + CLI_V2 + [
        "--pretrained-path", pretrained, "--epochs", str(epochs)], **size)
    counts = launches()
    log(f"entry point: V2 bf16 --epoch-scan, {epochs} epochs, in "
        f"{time.perf_counter() - t:.1f} s; launches {counts}")
    for run in (run1, run2):
        for name in ("config.json", "history.csv", "models/best.ckpt",
                     "models/last.ckpt"):
            if not os.path.exists(os.path.join(run.logdir, name)):
                raise AssertionError(f"{run.logdir} lacks {name}")
    rows = history(run2.logdir)
    log(f"  V2 history: {rows}")
    steps = TRAIN_IMAGES // TRAIN_BATCH
    valid_batches = len(run2.valid_data)
    # each epoch's validation: 5 launches per private forward of a batch,
    # and 5 in the signature detection's forward
    want = {"fused_augment_bf16": steps * epochs,
            "passport_epilogue_bf16": epochs * 5 * (valid_batches + 1)}
    if counts != {**dict.fromkeys(counts, 0), **want}:
        raise AssertionError(f"entry-point launches {counts}, expected {want}")
    if not rows[-1]["train_loss"] < rows[0]["train_loss"]:
        raise AssertionError("the V2 run's training loss did not fall")
    check_detection(run2, "ResNet18Private V2 bf16 entry point")

    expid = os.path.basename(run2.logdir)
    evaluated = train_v23.main(CLI_COMMON + CLI_V2 + [
        "--pretrained-path", pretrained, "--eval", "--exp-id", expid],
        **size).evaluate_only()
    if not all(np.isfinite(v) for v in evaluated.values()):
        raise AssertionError(f"--eval gave {evaluated}")

    fresh = build_model("resnet18", 10, passport_kwargs=run2.passport_kwargs,
                        private=True, seed=12345, dtype=BF16)
    load_state(os.path.join(run2.logdir, "models", "best.ckpt"),
               TrainState.create(fresh, 0.0), restore_opt=False)
    verdict = verify_ownership(fresh, (1, 32, 32, 3), private=True)
    if verdict["detection_rate"] != 1.0:
        raise AssertionError(f"best.ckpt does not verify: {verdict}")
    log(f"entry point: --eval of run {expid}: {evaluated}; best.ckpt in a "
        f"fresh bf16 model verifies (detection "
        f"{verdict['detection_rate']}) [{smi}]")

    t = time.perf_counter()
    run3 = train_v23.main(CLI_COMMON + CLI_V2 + [
        "--train-backdoor", "--pretrained-path", pretrained, "--epochs", "1"])
    header = history(run3.logdir)[0]
    if "wm_total_acc" not in header:
        raise AssertionError(f"the V3 run's history lacks the trigger set: "
                             f"{sorted(header)}")
    log(f"entry point: V3 bf16 --epoch-scan, 1 epoch, in "
        f"{time.perf_counter() - t:.1f} s: {history(run3.logdir)[-1]}")
    return counts, os.path.join(run2.logdir, "models", "best.ckpt"), \
        os.path.join(run3.logdir, "models", "best.ckpt")


# ------------------------------------------------------------ attacks

def attack_argv(best: str) -> list:
    return ["--arch", "resnet18", "--dataset", "synthetic", "--scheme", "2",
            "--passport-config", "passport_configs/resnet18_passport.json",
            "--loadpath", best]


def collected_sections(markdown: str) -> dict:
    """{model: {section: {"heading", "header", "rows", "source"}}} of
    tools/collect_robustness.py's output: each section's heading, its
    table's header, the count of its table's rows and its source line.
    A record of one model has no model line; its sections are under
    None."""
    out, model, title = {None: {}}, None, None
    for line in markdown.splitlines()[1:]:  # past the record's title
        if line.startswith("# "):
            model, title = line[2:], None
            out[model] = {}
        elif line.startswith("## "):
            title = line[3:].split(" — ")[0].split(" (")[0]
            out[model][title] = {"heading": line[3:], "header": None,
                                 "rows": 0, "source": ""}
        elif title and line.startswith("|") and not line.startswith("|-"):
            entry = out[model][title]
            if entry["header"] is None:
                entry["header"] = line
            else:
                entry["rows"] += 1
        elif title and line.startswith("Source"):
            out[model][title]["source"] = line
    return out


def collect_robustness(root: str, expnames, tag: str, out: str) -> dict:
    """Run the unchanged tools/collect_robustness.py from ``root`` (where
    ``logs/`` holds the CSVs) on ``expnames``; returns
    ``collected_sections`` of the record it wrote to ``out``."""
    cmd = [sys.executable, os.path.join(REPO, "tools",
                                        "collect_robustness.py"),
           "--tag", tag, "--out", out]
    for name in expnames:
        cmd += ["--expname", name]
    subprocess.run(cmd, cwd=root, check=True, capture_output=True,
                   timeout=120)
    with open(os.path.join(root, out)) as f:
        return collected_sections(f.read())


def attack_path(best: str, smi: str, launches, reset) -> dict:
    """The attack grid (cli/robustness_grid.py, the six attack CLIs
    in-process) on the card, on the V2 run's best.ckpt (f32 weights in an
    f32 model), on that run's synthetic set (12,800 train, 512 validation
    images), batch 64, at GRID_DEPTHS; then attack 3 host-fed; then the
    unchanged collector on the grid's CSVs. Returns the path's launch
    counts."""
    import shutil

    from deepipr_tpu_torch.cli import passport_attack_3, robustness_grid

    # the collector's layout: the checkpoint under logs/<exp>/<id>/models/
    # of the grid's own directory, where the attack CLIs write their CSVs
    shutil.rmtree(GRID_DIR, ignore_errors=True)
    run = os.path.relpath(best, CLI_LOGDIR).split(os.sep)
    ckpt = os.path.join("logs", *run)
    os.makedirs(os.path.join(GRID_DIR, os.path.dirname(ckpt)))
    os.symlink(os.path.abspath(best), os.path.join(GRID_DIR, ckpt))
    expname = "/".join(run[:2])
    cfg = os.path.join(REPO, "passport_configs", "resnet18_passport.json")

    reset()
    t = time.perf_counter()
    with contextlib.chdir(GRID_DIR):
        # the V2 run's synthetic set: its size draws its class templates
        records = robustness_grid.main(
            [ckpt, "resnet18", "2", cfg, GRID_TAG],
            synthetic_train=TRAIN_IMAGES, **GRID_DEPTHS)
    grid_wall = time.perf_counter() - t
    grid = {}
    for r in records:
        grid.setdefault(r["module"].rsplit(".", 1)[-1], []).append(r)
    walls = {name: [round(r["seconds"], 1) for r in rs]
             for name, rs in grid.items()}
    grid_launches = {k: sum(r["launches"][k] for r in records)
                     for k in records[0]["launches"]}
    log(f"attack grid ({GRID_DEPTHS}) in {grid_wall:.1f} s: wall times "
        f"{walls} s; launches {grid_launches} [{smi}]")
    for name, count in grid_launches.items():
        if not count:
            raise AssertionError(f"{name} was not launched on the attack "
                                 f"grid: {grid_launches}")

    rows = grid["pruning_attack"][0]["out"]
    if len(rows) != 11 or rows[0]["detect_mean"] != 1.0:
        raise AssertionError(f"pruning: {len(rows)} rows, detection at 0 % "
                             f"{rows[0]['detect_mean']}")
    log("  pruning: detection by level "
        f"{[round(r['detect_mean'], 4) for r in rows]}, accuracy "
        f"{[r['acc'] for r in rows]}")

    rows = grid["flip_attack"][0]["out"]
    detect = {k: v for k, v in rows[0].items() if k.startswith("detect_")}
    if len(rows) != 11 or any({k: r[k] for k in detect} != detect
                              for r in rows):
        raise AssertionError("flip: detection moved with the flipped "
                             f"affines: {[r['detect_mean'] for r in rows]}")
    if not rows[5]["acc"] < rows[0]["acc"]:
        raise AssertionError(f"flip: accuracy at 50 % {rows[5]['acc']} is "
                             f"not below 0 %'s {rows[0]['acc']}")
    log(f"  flip: detection {rows[0]['detect_mean']} at every level; "
        f"accuracy {[r['acc'] for r in rows]}")

    rows = grid["passport_attack_1"][0]["out"]
    genuine = rows[0]["valid_acc"]
    fake = float(np.mean([r["valid_acc"] for r in rows[1:]]))
    if rows[0]["attack_rep"] != -1 or not fake < genuine:
        raise AssertionError(f"attack 1: fake mean {fake} vs genuine "
                             f"{genuine}")
    log(f"  attack 1: genuine {genuine} %, fake mean {fake:.2f} % over "
        f"{len(rows) - 1} reps")

    for name in ("passport_attack_2", "passport_attack_3"):
        for r in grid[name]:
            if not all(np.isfinite(v) for row in r["out"]
                       for v in row.values() if isinstance(v, float)):
                raise AssertionError(f"{name} {r['argv']}: {r['out']}")
            log(f"  {name} {r['argv'][-4:]}: {r['out'][-1]}")

    forged, hists = grid["passport_forge_attack"][0]["out"]
    for row, hist in zip(forged, hists):
        if not hist[-1]["mse"] < hist[0]["mse"]:
            raise AssertionError(f"forge {row['flipperc']}: MSE did not "
                                 f"fall: {hist}")
    log(f"  forge: {forged}; MSE by flip fraction "
        f"{[[h['mse'] for h in hist] for hist in hists]}")

    # attack 3 host-fed, at the CLIs' default tag (CSVs under logs/ of the
    # working directory, apart from the grid's)
    t = time.perf_counter()
    rows = passport_attack_3.main(attack_argv(best) + [
        "--flipperc", "0.1", "--epochs", "1"], synthetic_train=TRAIN_IMAGES)
    if not all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float)):
        raise AssertionError(f"attack 3: {rows}")
    log(f"  attack 3 host-fed, 1 epoch, in {time.perf_counter() - t:.1f} s: "
        f"{rows[-1]}")
    counts = launches()

    backend = f"cuda:{torch.cuda.get_device_name(0)}"
    sections = collect_robustness(GRID_DIR, [expname], GRID_TAG,
                                  "ROBUSTNESS_SMOKE.md")[None]
    got = {title: s["rows"] for title, s in sections.items()}
    if got != GRID_SECTIONS:
        raise AssertionError(f"the collector's sections {got}, not "
                             f"{GRID_SECTIONS}")
    if f"({GRID_DEPTHS['attack_rep']} reps" not in \
            sections["Attack 1"]["heading"]:
        raise AssertionError(f"attack 1: {sections['Attack 1']}")
    for title, s in sections.items():
        if f"(backend: {backend})" not in s["source"]:
            raise AssertionError(f"{title}: {s['source']}")
    log(f"collector: sections {got}, every source stamped {backend}")
    log(f"attack-path launches: {counts} [{smi}]")
    for name in ("passport_epilogue", "passport_epilogue_backward",
                 "fused_augment"):
        if not counts[name]:
            raise AssertionError(f"{name} was not launched on the attack "
                                 f"path: {counts}")
    if counts["passport_epilogue_bf16"] or counts["fused_augment_bf16"]:
        raise AssertionError(f"a bf16 form ran on the f32 attack path: "
                             f"{counts}")
    return counts


def ambiguity_checks(argv: list, launches, reset, private: bool = True,
                     per_step: int = 5,
                     batch_sizes=(ATTACK_BATCH, REQUEST_BATCH),
                     forge_step: bool = True, models=None) -> float:
    """On the checkpoint the attack CLIs' ``argv`` name (by default the V2
    best.ckpt), or on ``models`` ({"cpu": model, "cuda": its copy}, for an
    architecture the attack CLIs do not take), ``argv`` then unused: K2 and
    K2-bwd launches per ambiguity step (``per_step``
    each) at ``batch_sizes``; the CE and sign-loss gradient (maximize
    coefficient 0) finite and non-zero on every fake passport, and within
    UPDATE_TOL of its norm of the CPU's on the same weights and batch; then
    one ambiguity step and (``forge_step``) one forge step on the card
    against the same steps on the CPU, from the same weights and draws:
    metrics at TRAIN_TOL, each passport's update within UPDATE_TOL of its
    norm. Returns the worst update error."""
    from deepipr_tpu_torch.attacks import ambiguity, forge
    from deepipr_tpu_torch.attacks.cli_common import load_attacked_model
    from deepipr_tpu_torch.cli import passport_attack_3
    from deepipr_tpu_torch.serve import passports

    if models is None:
        args = passport_attack_3.build_parser().parse_args(argv)
        models = {dev: load_attacked_model(args, device=dev)[0]
                  for dev in ("cpu", "cuda")}
    images = request_batches(1, 5)[0]
    # the attack CLIs' batch
    parity = {k: v[:ATTACK_BATCH] for k, v in images.items()}
    orig_cpu = {k: v.detach().clone()
                for k, v in passports(models["cpu"]).items()}
    gen = torch.Generator().manual_seed(6)
    noise = {k: torch.randn(v.shape, generator=gen)
             for k, v in orig_cpu.items()}
    init = {k: torch.rand(v.shape, generator=gen) * 2 - 1
            for k, v in orig_cpu.items()}

    def step_inputs(dev, batch):
        """(signature, orig, fake, x, y) on ``dev``, the same on each."""
        orig = {k: v.to(dev) for k, v in orig_cpu.items()}
        fake = ambiguity.initial_fakes(orig, 0.001, 0, noise)
        signature = ambiguity.flip_signature_bits(
            ambiguity.signatures(models[dev]), 0.1, 1)
        x = torch.as_tensor(batch["image"]).to(dev)
        x = x.permute(0, 3, 1, 2).contiguous()
        y = torch.as_tensor(batch["label"]).to(dev).long()
        return signature, orig, fake, x, y

    def ambiguity_step(dev, batch, coef=ambiguity.MAXIMIZE_COEF):
        signature, orig, fake, x, y = step_inputs(dev, batch)
        start = {k: v.detach().clone() for k, v in fake.items()}
        step = ambiguity.make_ambiguity_step(
            models[dev], signature, private,
            ambiguity.PassportOptimizer(fake, 0.01), coef)
        metrics = step(fake, orig, x, y)
        return ({k: (fake[k] - start[k]).cpu() for k in fake},
                {k: v.item() for k, v in metrics.items()})

    for n in batch_sizes:
        batch = {"image": images["image"][:n], "label": images["label"][:n]}
        reset()
        ambiguity_step("cuda", batch)
        counts = launches()
        log(f"ambiguity step at batch {n}: K2 {counts['passport_epilogue']}, "
            f"K2-bwd {counts['passport_epilogue_backward']} launches")
        if (counts["passport_epilogue"], counts["passport_epilogue_backward"]
                ) != (per_step, per_step):
            raise AssertionError(f"ambiguity step launches {counts}")

    # the CE and sign-loss terms alone (the gradient that flows through
    # K2-bwd) reach every fake passport, on the card as on the CPU
    grads = {}
    for dev in ("cpu", "cuda"):
        signature, orig, fake, x, y = step_inputs(dev, parity)
        loss, _ = ambiguity.ambiguity_loss(models[dev], signature, private,
                                           fake, orig, x, y, coef=0.0)
        grads[dev] = {k: g.cpu() for k, g in zip(
            fake, torch.autograd.grad(loss, list(fake.values())))}
    norms = {k: g.norm().item() for k, g in grads["cuda"].items()}
    if not all(np.isfinite(v) and v > 0 for v in norms.values()):
        raise AssertionError(f"CE + sign loss gradients {norms}")
    log(f"ambiguity, maximize coefficient 0: gradient norms {norms}")
    grad_err = {k: ((g - grads["cpu"][k]).norm() / grads["cpu"][k].norm()
                    ).item() for k, g in grads["cuda"].items()}
    name = max(grad_err, key=grad_err.get)
    log(f"  card vs CPU: each gradient within {UPDATE_TOL} of its norm; "
        f"worst {grad_err[name]:.3g} at {name}")
    if grad_err[name] > UPDATE_TOL:
        raise AssertionError(f"CE + sign loss gradients, card vs CPU: "
                             f"{grad_err}")

    worst = {}
    upd, met = {}, {}
    for dev in ("cpu", "cuda"):
        upd[dev], met[dev] = ambiguity_step(dev, parity)
    for dev in ("cpu", "cuda") if forge_step else ():
        pp, _, hist = forge.forge_attack(models[dev], (1, 32, 32, 3),
                                         flipperc=0.5, steps=1, seed=0,
                                         log_every=1, init=init)
        upd[f"forge {dev}"] = {k: (v.cpu() - init[k]) for k, v in pp.items()}
        met[f"forge {dev}"] = {"mse": hist[0]["mse"]}
    for kind in ("", "forge ") if forge_step else ("",):
        cpu, gpu = met[f"{kind}cpu"], met[f"{kind}cuda"]
        bad = [k for k, v in cpu.items()
               if not abs(gpu[k] - v) <= TRAIN_TOL["atol"]
               + TRAIN_TOL["rtol"] * abs(v)]
        for k, u in upd[f"{kind}cpu"].items():
            err = ((upd[f"{kind}cuda"][k] - u).norm() / u.norm()).item()
            worst[f"{kind or 'ambiguity '}{k}"] = err
            if err > UPDATE_TOL:
                bad.append(k)
        log(f"{kind or 'ambiguity '}step, card vs CPU: metrics {gpu} vs "
            f"{cpu}")
        if bad:
            raise AssertionError(f"{kind or 'ambiguity '}step: card and CPU "
                                 f"differ in {bad}")
    name = max(worst, key=worst.get)
    log(f"  each passport's update within {UPDATE_TOL} of its norm; worst "
        f"{worst[name]:.3g} at {name}")
    return worst[name]


# ------------------------------------------------------------- AlexNet

def alexnet_serve(seed: int, smi: str, launches, reset) -> dict:
    """Phase 4's serving path on V1 and V2 AlexNet (CIFAR-10 width, K2 at
    (N,384,8,8) and (N,256,8,8)) in f32 and bf16, with 3 K2 launches in
    each passport forward, and their throughput; then the ImageNet
    variant. Returns the launches of each K2 form over the checked path."""
    batches = request_batches(3, seed)
    counts = {"passport_epilogue": 0, "passport_epilogue_bf16": 0}
    for private in (False, True):
        for form, dtype in (("passport_epilogue", None),
                            ("passport_epilogue_bf16", BF16)):
            cpu_model = random_model(seed, dtype, "alexnet", private)
            gpu_model = copy.deepcopy(cpu_model).to("cuda")
            forged = forged_passports(cpu_model, seed + 2)
            reset()
            serve_path(gpu_model, cpu_model, batches, forged, launches, form,
                       private_model=private, per_forward=ALEXNET_K2)
            got = launches()
            if not got[form] or sum(got.values()) != got[form]:
                raise AssertionError(f"{form} did not carry the AlexNet "
                                     f"serving path: {got}")
            counts[form] += got[form]
            label = (f"AlexNet {'V2' if private else 'V1'} "
                     f"{'bf16' if dtype else 'f32'}")
            throughput(gpu_model, smi, label, private)
            where_time_goes(gpu_model, smi, per_forward=ALEXNET_K2)
            del gpu_model, cpu_model
    for form, dtype in (("passport_epilogue", None),
                        ("passport_epilogue_bf16", BF16)):
        reset()
        imagenet_forward(seed, form, dtype, launches)
        counts[form] += launches()[form]
    log(f"AlexNet serving-path launches: {counts}")
    return counts


def imagenet_forward(seed: int, form: str, dtype, launches) -> None:
    """One private forward of a V2 ImageNet AlexNet (1000 classes, 224 px:
    K2 at (64,384,13,13) and (64,256,13,13), the scalar path) through
    Predictor, against the CPU: f32 at LOGITS_TOL on the whole batch; bf16
    within BF16_LOGITS_NORM_TOL of the norm on 8 rows (eval-mode rows are
    independent, and bf16 convolutions are slow on the CPU)."""
    from deepipr_tpu_torch.serve import Predictor

    cpu_model = random_model(seed, dtype, "alexnet", True, num_classes=1000,
                             size=IMAGENET_SIZE)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    if tuple(gpu_model.features_4.key.shape) != (1, 192, 13, 13):
        raise AssertionError("the ImageNet variant's features_4 is not 13x13")
    x = torch.randn((IMAGENET_BATCH, IMAGENET_SIZE, IMAGENET_SIZE, 3),
                    generator=torch.Generator().manual_seed(seed + 9))
    before = launches()[form]
    gpu_logits = Predictor(gpu_model, ind=1).logits(x).cpu()
    if launches()[form] - before != ALEXNET_K2:
        raise AssertionError(f"ImageNet private forward: "
                             f"{launches()[form] - before} {form} launches")
    rows = IMAGENET_BATCH if dtype is None else 8
    cpu_logits = Predictor(cpu_model, ind=1, device="cpu").logits(x[:rows])
    if gpu_logits.shape != (IMAGENET_BATCH, 1000) or \
            not torch.isfinite(gpu_logits).all():
        raise AssertionError("non-finite or misshapen ImageNet logits")
    if dtype is None:
        torch.testing.assert_close(gpu_logits, cpu_logits, **LOGITS_TOL)
        err = (gpu_logits - cpu_logits).abs().max().item()
    else:
        err = ((gpu_logits[:rows] - cpu_logits).norm()
               / cpu_logits.norm()).item()
        if err > BF16_LOGITS_NORM_TOL:
            raise AssertionError(f"bf16 ImageNet logits differ from the "
                                 f"CPU's by {err} of their norm")
    log(f"ImageNet AlexNet V2 private forward, batch {IMAGENET_BATCH}, "
        f"{dtype or torch.float32}: {ALEXNET_K2} {form} launches at 13x13; "
        f"card vs CPU on {rows} rows: {err:.3g} "
        f"({'largest error' if dtype is None else 'of the norm'})")


def alexnet_cli(smi: str, launches, reset):
    """training.sh's first recipe at reduced length, in-process: scheme 0
    (train_v1 at --arch alexnet) for 1 epoch, then V1 (train_v1
    --train-passport, shuffle keys from its last.ckpt, --epoch-scan
    --pallas-input) and V2 (train_v23, the same keys and input stage) for
    ALEXNET_EPOCHS each, batch 256 over 12,800 images. Each passport run:
    K1 f32 every step and K2 f32 3 times a validation batch and in
    signature detection, nothing else; the loss falls, the final
    train_sign_acc is 1.0, and its best.ckpt in a fresh model verifies
    with detection 1.0. Returns the two runs' launch counts and best.ckpt
    paths."""
    import shutil

    from deepipr_tpu_torch.cli import train_v1, train_v23
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.serve import verify_ownership
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.utils.checkpoint import load_state

    shutil.rmtree(ALEXNET_LOGDIR, ignore_errors=True)
    size = {"synthetic_train": TRAIN_IMAGES}
    t = time.perf_counter()
    run0 = train_v1.main(ALEXNET_CLI + ["--epochs", "1"], **size)
    log(f"AlexNet entry point: scheme 0, 1 epoch, in "
        f"{time.perf_counter() - t:.1f} s: {history(run0.logdir)[-1]}")
    pretrained = ["--pretrained-path",
                  os.path.join(run0.logdir, "models", "last.ckpt"),
                  "--epochs", str(ALEXNET_EPOCHS)]
    steps = TRAIN_IMAGES // TRAIN_BATCH
    counts, best = {}, {}
    for scheme, main, flags in (
            (1, train_v1, ["--train-passport", "--sign-loss", "0.1"]),
            (2, train_v23, [])):
        reset()
        t = time.perf_counter()
        run = main.main(ALEXNET_CLI + ALEXNET_PASSPORT + flags + pretrained,
                        **size)
        counts[scheme] = got = launches()
        rows = history(run.logdir)
        log(f"AlexNet entry point: V{scheme} --epoch-scan, "
            f"{ALEXNET_EPOCHS} epochs, in {time.perf_counter() - t:.1f} s; "
            f"launches {got}; history {rows}")
        want = {"fused_augment": steps * ALEXNET_EPOCHS,
                "passport_epilogue": ALEXNET_EPOCHS * ALEXNET_K2
                * (len(run.valid_data) + 1)}
        if got != {**dict.fromkeys(got, 0), **want}:
            raise AssertionError(f"AlexNet V{scheme} launches {got}, "
                                 f"expected {want}")
        if not rows[-1]["train_loss"] < rows[0]["train_loss"]:
            raise AssertionError(f"AlexNet V{scheme}: the loss did not fall")
        check_detection(run, f"AlexNet V{scheme} entry point")
        best[scheme] = os.path.join(run.logdir, "models", "best.ckpt")
        fresh = build_model("alexnet", 10, passport_kwargs=run.passport_kwargs,
                            private=scheme == 2, seed=12345)
        load_state(best[scheme], TrainState.create(fresh, 0.0),
                   restore_opt=False)
        verdict = verify_ownership(fresh, (1, 32, 32, 3),
                                   private=scheme == 2)
        if verdict["detection_rate"] != 1.0:
            raise AssertionError(f"AlexNet V{scheme} best.ckpt does not "
                                 f"verify: {verdict}")
        log(f"  V{scheme} best.ckpt in a fresh model: detection "
            f"{verdict['layers']} [{smi}]")
    return counts, best


def alexnet_attacks(best: dict, smi: str, launches, reset) -> dict:
    """The attack CLIs at their defaults (--arch alexnet --scheme 1, batch
    64) on the V1 best.ckpt, over the training run's synthetic set: pruning
    (detection 1.0 at 0 %), flip ``--fidxs 4,5,6`` (detection constant),
    attack 3 ``--flipperc 0.1`` for 1 epoch; the forge attack ``--steps
    50`` on the V2 best.ckpt (it refuses V1). Then K2 and K2-bwd launches
    per ambiguity step and one step card vs CPU (``ambiguity_checks``).
    Returns the CLIs' launch counts."""
    from deepipr_tpu_torch.cli import (
        flip_attack,
        passport_attack_3,
        passport_forge_attack,
        pruning_attack,
    )

    v1 = ["--dataset", "synthetic", "--loadpath", best[1]]
    size = {"synthetic_train": TRAIN_IMAGES}
    walls = {}

    def run(name, main, argv):
        t = time.perf_counter()
        out = main(argv, **size)
        walls[name] = time.perf_counter() - t
        return out

    reset()
    rows = run("pruning", pruning_attack.main, v1)
    if len(rows) != 11 or rows[0]["detect_mean"] != 1.0:
        raise AssertionError(f"AlexNet pruning: detection at 0 % "
                             f"{rows[0]['detect_mean']}")
    log(f"AlexNet pruning: detection at 0 / 50 % {rows[0]['detect_mean']} / "
        f"{rows[5]['detect_mean']:.4f}, accuracy {rows[0]['acc']} / "
        f"{rows[5]['acc']}")
    rows = run("flip", flip_attack.main, v1 + ["--fidxs", "4,5,6"])
    if len({r["detect_mean"] for r in rows}) != 1:
        raise AssertionError("AlexNet flip: detection moved with the flipped "
                             "affines")
    log(f"AlexNet flip --fidxs 4,5,6: detection {rows[0]['detect_mean']}, "
        f"accuracy {[r['acc'] for r in rows]}")
    rows = run("attack 3", passport_attack_3.main,
               v1 + ["--flipperc", "0.1", "--epochs", "1"])
    if not all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float)):
        raise AssertionError(f"AlexNet attack 3: {rows}")
    log(f"AlexNet attack 3: {rows[-1]}")
    forged, hists = run("forge", passport_forge_attack.main,
                        ["--dataset", "synthetic", "--scheme", "2",
                         "--loadpath", best[2], "--steps", "50"])
    if not all(np.isfinite(r["forge_mse"]) for r in forged):
        raise AssertionError(f"AlexNet forge: {forged}")
    log(f"AlexNet forge: {forged}")
    counts = launches()
    log(f"AlexNet attack-path launches: {counts}; wall times "
        f"{ {k: round(v, 1) for k, v in walls.items()} } s [{smi}]")
    for name in ("passport_epilogue", "passport_epilogue_backward"):
        if not counts[name]:
            raise AssertionError(f"{name} was not launched on the AlexNet "
                                 f"attack path: {counts}")
    if counts["passport_epilogue_bf16"] or counts["fused_augment_bf16"]:
        raise AssertionError(f"a bf16 form ran on the f32 attack path: "
                             f"{counts}")
    ambiguity_checks(["--arch", "alexnet", "--scheme", "1", "--dataset",
                      "synthetic", "--loadpath", best[1]], launches, reset,
                     private=False, per_step=ALEXNET_K2,
                     batch_sizes=(ATTACK_BATCH,), forge_step=False)
    return counts


# ------------------------------------------------- transfer learning

@contextlib.contextmanager
def clone_start(seen: dict):
    """Record the transfer-learning clone and its weights before its first
    step (``seen['model']``, ``seen['start']``, CPU copies) and the
    validation set its rows are evaluated on (``seen['valid']``)."""
    from deepipr_tpu_torch.train import transfer

    real, real_eval = transfer.make_train_step, transfer.run_eval

    def spy(model, *args, **kwargs):
        seen["model"] = model
        seen["start"] = {k: v.detach().cpu().clone()
                         for k, v in model.state_dict().items()}
        return real(model, *args, **kwargs)

    def spy_eval(step, dataset):
        seen.setdefault("valid", dataset)
        return real_eval(step, dataset)

    transfer.make_train_step, transfer.run_eval = spy, spy_eval
    try:
        yield
    finally:
        transfer.make_train_step, transfer.run_eval = real, real_eval


def tl_argv(arch: str, best: str, tl_scheme: str, logdir: str) -> list:
    config = ALEXNET_CONFIG if arch == "alexnet" else RESNET_CONFIG
    return ["--arch", arch, "--dataset", "synthetic", "--batch-size",
            str(TRAIN_BATCH), "--passport-config", config,
            "--transfer-learning", "--tl-dataset", "synthetic",
            "--tl-scheme", tl_scheme, "--pretrained-path", best,
            "--epochs", str(TL_EPOCHS), "--logdir", logdir]


def transfer_path(bests: dict, smi: str, launches, reset) -> dict:
    """``--transfer-learning`` through the train CLIs in-process, rtal and
    ftal, from each of ``bests`` ({label: (arch, scheme, best.ckpt)}),
    TL_EPOCHS epochs over TL_IMAGES synthetic images at batch 256. Each run:
    the columns JAX writes (train_*, valid_*, old_wm_passport_* per
    passport layer, backdoor_* for V3), finite rows, ``exp.model`` bit for
    bit the loaded checkpoint afterwards, and K2 f32 launched exactly as
    the run derives: the clone's surgery, each epoch's survival rows (V2/V3)
    and V3's trigger-set retest through the copied-back model. Returns the
    path's launch counts."""
    from deepipr_tpu_torch.attacks.common import plkey_to_module_path
    from deepipr_tpu_torch.cli import train_v1, train_v23

    logdir = os.path.join("build", "chip_smoke_tl")
    counts = {}
    seconds = {}
    native_reset()
    for label, (arch, scheme, best) in bests.items():
        main = train_v1 if scheme == 1 else train_v23
        flags = {1: ["--train-passport"], 2: [],
                 3: ["--train-backdoor"]}[scheme]
        per_forward = ALEXNET_K2 if arch == "alexnet" else RESNET_K2
        for tl_scheme in ("rtal", "ftal"):
            reset()
            t = time.perf_counter()
            exp = main.main(tl_argv(arch, best, tl_scheme, logdir) + flags,
                            synthetic_train=TL_IMAGES)
            wall = time.perf_counter() - t
            got = launches()
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
            rows = history(os.path.join(exp.logdir, "tl_1"))
            seconds[f"{label} {tl_scheme}"] = wall / TL_EPOCHS
            log(f"transfer learning {label} {tl_scheme}: {TL_EPOCHS} epochs "
                f"in {wall:.1f} s ({wall / TL_EPOCHS:.2f} s an epoch, "
                f"setup and checkpoints included); launches {got}; last row "
                f"{rows[-1]} [{smi}]")
            want_cols = {"epoch", "train_acc", "train_loss", "train_sign_acc",
                         "train_sign_loss", "valid_acc", "valid_loss"}
            if scheme == 3:
                want_cols |= {f"backdoor_{k}" for k in (
                    "acc_public", "acc_private", "loss_public",
                    "loss_private", "total_acc")}
            branch = "public" if scheme == 1 else "private"
            want_cols |= {f"old_wm_passport_{branch}_{p.replace('.', '/')}"
                          for p in map(plkey_to_module_path, exp.plkeys)}
            if set(rows[-1]) != want_cols or len(rows) != TL_EPOCHS:
                raise AssertionError(f"TL {label} {tl_scheme}: columns "
                                     f"{sorted(rows[-1])}, want "
                                     f"{sorted(want_cols)}")
            if not all(np.isfinite(v) for r in rows for v in r.values()):
                raise AssertionError(f"TL {label} {tl_scheme}: {rows}")
            loaded = torch.load(best, map_location="cpu",
                                weights_only=True)["model"]
            changed = [k for k, v in exp.model.state_dict().items()
                       if not torch.equal(v.cpu(), loaded[k])]
            if changed:
                raise AssertionError(f"TL {label} {tl_scheme} wrote the "
                                     f"experiment's model: {changed[:4]}")
            # K2 f32: the surgery's derivation, then each epoch's survival
            # rows (V2/V3) and trigger-set retest (V3), nothing else
            k2 = per_forward
            if scheme != 1:
                k2 += TL_EPOCHS * per_forward
            if scheme == 3:
                k2 += TL_EPOCHS * per_forward * len(exp.wm_data)
            want = {"passport_epilogue": k2}
            if got != {**dict.fromkeys(got, 0), **want}:
                raise AssertionError(f"TL {label} {tl_scheme} launches {got}, "
                                     f"expected {want}")
            del exp
    HOST_CALLS["transfer"] = native_calls()
    log(f"transfer learning: seconds an epoch {seconds} [{smi}]")
    tl_parity(bests["ResNet18Private V2"][2])
    tl_parity(bests["ResNet18Private V3"][2], ["--train-backdoor"])
    remat_check(0)
    remat_cost(0, smi)
    return counts


def remat_check(seed: int) -> None:
    """Two split V2 train steps (batch PARITY_BATCH, K1 input stage) with
    remat="full" against remat="none" on the card, cuDNN deterministic:
    parameters and BN running statistics bit for bit (the recomputed
    forward takes no second EMA step), one K1 launch a step either way."""
    from deepipr_tpu_torch.data.datasets import synthetic_dataset
    from deepipr_tpu_torch.data.device_augment import draw_augment
    from deepipr_tpu_torch.ops.fused_augment import fused_augment
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.train.steps import make_train_step

    x, y, _, _ = synthetic_dataset(num_train=2 * PARITY_BATCH, num_test=0,
                                   size=32, seed=seed + 5)
    gen = torch.Generator().manual_seed(seed + 6)
    draws = [tuple(t.cuda() for t in draw_augment(gen, PARITY_BATCH,
                                                  TRAIN_PAD))
             for _ in range(2)]
    states = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in ("none", "full"):
            model = train_model(seed + 5, "cuda")
            state = TrainState.create(model, TRAIN_LR)
            step = make_train_step(model, True, pad=TRAIN_PAD, remat=remat,
                                   draws=lambda s, n: draws[s])
            before = fused_augment.launches
            for i in range(2):
                rows = slice(i * PARITY_BATCH, (i + 1) * PARITY_BATCH)
                step(state, {"image": x[rows], "label": y[rows]})
            if fused_augment.launches - before != 2:
                raise AssertionError(f"remat={remat}: "
                                     f"{fused_augment.launches - before} "
                                     "K1 launches in 2 steps")
            states[remat] = {k: v.clone()
                             for k, v in model.state_dict().items()}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    differ = [k for k, v in states["none"].items()
              if not torch.equal(states["full"][k], v)]
    if differ:
        raise AssertionError(f"remat='full' differs from 'none' in "
                             f"{differ[:6]}")
    log(f"remat='full': 2 split V2 steps at batch {PARITY_BATCH} on the "
        f"card, parameters and BN statistics bit for bit with 'none'")


def remat_cost(seed: int, smi: str) -> dict:
    """What remat="full" buys and costs: a split V2 train step of
    ResNet18Private at batch TRAIN_BATCH (f32, K1 input stage) with
    remat="none" and "full" in turns (none, full, full, none). Each turn
    takes two warm-up steps, then REMAT_STEPS steps timed by CUDA events,
    with torch.cuda.max_memory_allocated over them: the peak, and the peak
    less what was allocated before them (activations and the step's
    temporaries). Returns {remat: [(ms a step, peak MiB, above MiB)]}."""
    from deepipr_tpu_torch.data.datasets import synthetic_dataset
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.train.steps import make_train_step

    x, y, _, _ = synthetic_dataset(num_train=TRAIN_BATCH, num_test=0,
                                   size=32, seed=seed + 7)
    batch = {"image": torch.from_numpy(x).cuda(),
             "label": torch.from_numpy(y).cuda()}
    mib = 2.0 ** 20
    out = {}
    for remat in ("none", "full", "full", "none"):
        model = train_model(seed + 5, "cuda")
        state = TrainState.create(model, TRAIN_LR)
        step = make_train_step(model, True, pad=TRAIN_PAD, remat=remat)
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REMAT_STEPS):
            step(state, batch)
        end.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out.setdefault(remat, []).append(
            (start.elapsed_time(end) / REMAT_STEPS, peak / mib,
             (peak - before) / mib))
        del model, state, step
    log(f"remat cost, split V2 step at batch {TRAIN_BATCH} (f32, K1 input), "
        f"turns none/full/full/none as (ms a step, peak MiB, MiB above "
        f"the resident state): {out} [{smi}]")
    return out


def tl_parity(best: str, flags=()) -> None:
    """Two TL steps (rtal, batch PARITY_BATCH) from a ResNet18Private V2 or
    V3 (``flags``) best.ckpt on the card against the same on the CPU: the
    rows at TRAIN_TOL, survival exactly, the clone's BN statistics at
    TRAIN_TOL and each parameter's update within UPDATE_TOL of its norm
    (train_parity's f32 bounds). The losses of the fine-tuned weights
    (valid_loss, backdoor_loss_*) carry the updates' spread (up to 2.5e-2
    of their norm, and a valid loss of 13 on the card), so across the runs
    they are held at UPDATE_TOL, and on equal weights at TRAIN_TOL both
    ways: the card's valid row against the CPU's evaluation of the card's
    fine-tuned weights; then the card's valid and survival rows and V3's
    trigger-set retest (K2 at (2,512,4,4)) on the CPU run's fine-tuned
    weights against the CPU's rows. Accuracies on equal weights exactly."""
    import shutil

    from deepipr_tpu_torch.attacks.common import plkey_to_module_path
    from deepipr_tpu_torch.cli import train_v23
    from deepipr_tpu_torch.train import transfer
    from deepipr_tpu_torch.train.steps import evaluate

    def differ(got: dict, want: dict, loss_rtol: float) -> list:
        out = []
        for k, v in want.items():
            rtol = loss_rtol if k in ("valid_loss", "backdoor_loss_public",
                                      "backdoor_loss_private") else \
                TRAIN_TOL["rtol"]
            if (got[k] != v if k.startswith("old_wm_") else
                    not abs(got[k] - v) <= TRAIN_TOL["atol"] + rtol * abs(v)):
                out.append(k)
        return out

    def equal_weights(got: dict, want: dict) -> list:
        return (differ(got, want, TRAIN_TOL["rtol"])
                + [k for k in got if "acc" in k and got[k] != want[k]])

    def valid_row(model, data, dev) -> dict:
        return {f"valid_{k}": v for k, v in
                evaluate(model, data, device=dev).items()}

    runs = {}
    for dev in ("cpu", "cuda"):
        logdir = os.path.join("build", f"chip_smoke_tl_parity_{dev}")
        shutil.rmtree(logdir, ignore_errors=True)
        argv = tl_argv("resnet", best, "rtal", logdir) + list(flags)
        argv[argv.index("--batch-size") + 1] = str(PARITY_BATCH)
        argv[argv.index("--epochs") + 1] = "1"
        seen = {}
        with clone_start(seen):
            exp = train_v23.main(argv, device=dev,
                                 synthetic_train=2 * PARITY_BATCH,
                                 synthetic_test=PARITY_BATCH)
        rows = history(os.path.join(exp.logdir, "tl_1"))
        final = {k: v.detach().cpu().clone() for k, v in
                 seen["model"].state_dict().items()}
        runs[dev] = (rows[-1], seen["start"], final, exp, seen["model"],
                     seen["valid"])
    (cpu_row, start, cpu, _, cclone, cvalid) = runs["cpu"]
    (gpu_row, _, gpu, gexp, gclone, gvalid) = runs["cuda"]
    bad = differ(gpu_row, cpu_row, UPDATE_TOL)
    worst = {}
    for k, want in cpu.items():
        if "running_" in k:
            if not torch.allclose(gpu[k], want, **TRAIN_TOL):
                bad.append(k)
            continue
        update = (want - start[k]).norm().item()
        worst[k] = (gpu[k] - want).norm().item() / max(update, 1e-30)
        if worst[k] > UPDATE_TOL:
            bad.append(k)
    name = max(worst, key=worst.get)
    log(f"TL parity {' '.join(flags) or 'V2'}, 2 steps at batch "
        f"{PARITY_BATCH}, card vs CPU: row "
        f"{gpu_row} vs {cpu_row}; worst update {worst[name]:.3g} of its "
        f"norm at {name}")

    # the card's valid row against the CPU's evaluation of its weights
    with torch.no_grad():
        cclone.load_state_dict(gpu)
    mine = valid_row(cclone, cvalid, "cpu")
    card = {k: gpu_row[k] for k in mine}
    bad += [f"card's weights: {k}" for k in equal_weights(card, mine)]
    log(f"TL parity {' '.join(flags) or 'V2'}, the card's valid row and the "
        f"CPU's on the card's fine-tuned weights: {card} vs {mine}")

    # the card's rows on the CPU's fine-tuned weights
    with torch.no_grad():
        gclone.load_state_dict(cpu)
    plpaths = [plkey_to_module_path(k) for k in gexp.plkeys]
    same = valid_row(gclone, gvalid, "cuda")
    same.update({f"old_wm_passport_{k}": v for k, v in
                 transfer._signature_survival(gexp, gclone, plpaths).items()})
    if gexp.train_backdoor:
        copied = copy.deepcopy(gexp.model)
        transfer._copy_back(gexp, gclone, copied)
        same.update({f"backdoor_{k}": v for k, v in
                     gexp._dual_eval(gexp.wm_data, copied).items()})
    want = {k: cpu_row[k] for k in same}
    bad += [f"same weights: {k}" for k in equal_weights(same, want)]
    log(f"TL parity {' '.join(flags) or 'V2'}, the card's rows on the CPU's "
        f"fine-tuned weights: {same} vs {want}")
    if bad:
        raise AssertionError(f"TL card and CPU differ in {bad}")


# -------------------------------------------------------------- folding

def _norm_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def fold_path(seed: int, smi: str, launches, reset,
              archs=("resnet18", "alexnet"), timed: bool = True) -> dict:
    """``Predictor(folded=True)`` for each branch of ResNet18Private and
    AlexNet V2 (or ``archs``; random weights, passports and BN statistics
    from ``seed``), f32 and bf16, against the unfolded model on the card:
    f32 at FOLD_TOL, bf16 within BF16_LOGITS_NORM_TOL of the norm; a folded
    forward launches no kernel, the unfolded private one K2 in the dtype's
    form. Then (``timed``) folded and unfolded img/s in turns. Returns the
    path's launch counts (the unfolded forwards' K2)."""
    from deepipr_tpu_torch.serve import Predictor

    batches = request_batches(1, seed)
    counts = {}
    for arch in archs:
        per_forward = K2_PER_FORWARD[arch]
        for form, dtype in (("passport_epilogue", None),
                            ("passport_epilogue_bf16", BF16)):
            gpu_model = random_model(seed, dtype, arch).to("cuda")
            x = batches[0]["image"]
            reset()
            for ind in (0, 1):
                folded = Predictor(gpu_model, ind=ind, folded=True)
                before = launches()
                got = folded.logits(x)
                after = launches()
                if after != before:
                    raise AssertionError(f"a folded forward launched "
                                         f"{after} (before {before})")
                want = Predictor(gpu_model, ind=ind).logits(x)
                k2 = launches()[form] - after[form]
                if k2 != (per_forward if ind == 1 else 0):
                    raise AssertionError(f"unfolded ind={ind}: {k2} {form}")
                if not torch.isfinite(got).all():
                    raise AssertionError("non-finite folded logits")
                err = _norm_err(got, want)
                if dtype is None:
                    torch.testing.assert_close(got, want, **FOLD_TOL)
                elif err > BF16_LOGITS_NORM_TOL:
                    raise AssertionError(f"bf16 folded logits {err} of the "
                                         "norm from the unfolded model's")
                log(f"fold {arch} {dtype or torch.float32} ind={ind}: folded "
                    f"vs unfolded logits on the card, largest error "
                    f"{(got.float() - want.float()).abs().max().item():.3g}, "
                    f"{err:.3g} of the norm; 0 launches folded")
            for k, v in launches().items():
                counts[k] = counts.get(k, 0) + v
            if timed:
                label = f"{arch} V2 {'bf16' if dtype else 'f32'}"
                folded_throughput(gpu_model, smi, label)
            del gpu_model
    return counts


def folded_throughput(gpu_model, smi: str, label: str) -> None:
    """Predictor img/s, folded and unfolded in turns (unfolded, folded,
    folded, unfolded), each branch, batch 256 and 1024, input on the card;
    the public branch's device time by kernel at batch 1024, folded and
    unfolded."""
    from deepipr_tpu_torch.serve import Predictor

    gen = torch.Generator().manual_seed(7)
    for batch in (256, 1024):
        x = torch.randn((batch, 32, 32, 3), generator=gen).cuda()
        for ind in (0, 1):
            preds = {"unfolded": Predictor(gpu_model, ind=ind),
                     "folded": Predictor(gpu_model, ind=ind, folded=True)}
            rates = {k: [] for k in preds}
            for name in ("unfolded", "folded", "folded", "unfolded"):
                pred = preds[name]
                for _ in range(3):
                    pred.logits(x)
                torch.cuda.synchronize()
                reps = 20
                t = time.perf_counter()
                for _ in range(reps):
                    pred.logits(x)
                torch.cuda.synchronize()
                rates[name].append(reps * batch / (time.perf_counter() - t))
            log(f"throughput: Predictor {label} ind={ind} batch={batch}: "
                f"folded {rates['folded'][0]:.1f} / {rates['folded'][1]:.1f}"
                f" img/s, unfolded {rates['unfolded'][0]:.1f} / "
                f"{rates['unfolded'][1]:.1f} img/s [{smi}]")
            if batch == 1024 and ind == 0:  # where the public branch's time goes
                for name, pred in preds.items():
                    profiled(lambda: pred.logits(x), 5,
                             f"{label} {name} ind=0 forward, batch {batch}",
                             smi, top=6)


# -------------------------------------------------------------- interop

def interop_path(best: str, seed: int, smi: str, launches, reset,
                 arch: str = "resnet18") -> dict:
    """The V2 best.ckpt of ``arch`` (f32 model) exported to a
    reference-layout .pth and imported into a fresh model bit for bit, its
    genuine detection rate 1.0 (K2); hand-built torchvision models
    (TORCHVISION_ARCHS) through ``load_torch_pretrained``, card vs CPU at
    224 px; an ImageNet private forward of ``arch`` at 224 px, batch 64
    (ResNet18Private: K2 at (64,512,7,7)), card vs CPU in f32 and bf16.
    Returns the path's launch counts."""
    from deepipr_tpu_torch.interop.torch_export import save_torch_checkpoint
    from deepipr_tpu_torch.interop.torch_import import load_torch_checkpoint
    from deepipr_tpu_torch.interop.torchvision_import import (
        load_torch_pretrained,
    )
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.serve import Predictor, verify_ownership
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.utils.checkpoint import load_state

    folder = os.path.join("build", "chip_smoke_interop")
    os.makedirs(folder, exist_ok=True)
    pth = os.path.join(folder, f"{arch}_v2.pth")
    trained = train_model(12345, "cuda", arch=arch)
    load_state(best, TrainState.create(trained, 0.0), restore_opt=False)
    save_torch_checkpoint(pth, trained)
    fresh = train_model(54321, "cuda", arch=arch)
    reset()
    load_torch_checkpoint(pth, fresh)
    differ = [k for k, v in trained.state_dict().items()
              if not torch.equal(fresh.state_dict()[k], v)]
    if differ:
        raise AssertionError(f".pth round trip changed {differ[:4]}")
    verdict = verify_ownership(fresh, (1, 32, 32, 3), private=True)
    if verdict["detection_rate"] != 1.0:
        raise AssertionError(f"the imported V2 model does not verify: "
                             f"{verdict}")
    if launches()["passport_epilogue"] != K2_PER_FORWARD[arch]:
        raise AssertionError(f"verify_ownership launches {launches()}")
    log(f"interop: {MODEL_NAMES[arch]} V2 best.ckpt -> reference .pth -> a "
        f"fresh model, bit for bit; detection {verdict['layers']}")
    counts = launches()
    del trained, fresh

    rng = np.random.default_rng(seed)
    x = torch.randn((4, IMAGENET_SIZE, IMAGENET_SIZE, 3),
                    generator=torch.Generator().manual_seed(seed + 11))
    for tv_arch in TORCHVISION_ARCHS[arch]:
        sd = torchvision_resnet(rng, tv_arch)
        tv = os.path.join(folder, f"tv_{tv_arch}.pth")
        torch.save(sd, tv)
        models = {}
        for dev in ("cpu", "cuda"):
            models[dev] = build_model(tv_arch, 1000, input_size=IMAGENET_SIZE,
                                      device=dev)
            load_torch_pretrained(tv, models[dev], tv_arch)
        if not torch.equal(models["cuda"].linear.weight.cpu(),
                           sd["fc.weight"]):
            raise AssertionError(f"torchvision {tv_arch} fc.weight did not "
                                 "reach linear")
        gpu = Predictor(models["cuda"]).logits(x).cpu()
        cpu = Predictor(models["cpu"], device="cpu").logits(x)
        torch.testing.assert_close(gpu, cpu, **LOGITS_TOL)
        log(f"interop: hand-built torchvision {tv_arch} via "
            f"load_torch_pretrained, 224 px, card vs CPU largest error "
            f"{(gpu - cpu).abs().max().item():.3g}")
        del models

    for form, dtype in (("passport_epilogue", None),
                        ("passport_epilogue_bf16", BF16)):
        reset()
        imagenet_resnet_forward(seed, form, dtype, launches, arch)
        for k, v in launches().items():
            counts[k] = counts.get(k, 0) + v
    return counts


def torchvision_resnet(rng, arch: str) -> dict:
    """torchvision ResNet-18's, -34's or -50's state-dict keys and shapes
    with random weights and BN statistics (no pretrained weights are
    downloaded)."""
    def conv(co, ci, k):
        return rng.normal(0, (2 / (co * k * k)) ** 0.5, (co, ci, k, k))

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c)
        sd[f"{prefix}.bias"] = rng.normal(0, 0.1, c)
        sd[f"{prefix}.running_mean"] = rng.normal(0, 0.1, c)
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, c)

    blocks = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
              "resnet50": (3, 4, 6, 3)}[arch]
    bottleneck = arch == "resnet50"
    expansion = 4 if bottleneck else 1
    sd = {"conv1.weight": conv(64, 3, 7)}
    bn("bn1", 64)
    cin = 64
    for li, (planes, n) in enumerate(zip((64, 128, 256, 512), blocks),
                                     start=1):
        cout = planes * expansion
        for b in range(n):
            p = f"layer{li}.{b}"
            c1_in = cin if b == 0 else cout
            if bottleneck:
                sd[f"{p}.conv1.weight"] = conv(planes, c1_in, 1)
                sd[f"{p}.conv2.weight"] = conv(planes, planes, 3)
                sd[f"{p}.conv3.weight"] = conv(cout, planes, 1)
                bn(f"{p}.bn1", planes)
                bn(f"{p}.bn2", planes)
                bn(f"{p}.bn3", cout)
            else:
                sd[f"{p}.conv1.weight"] = conv(cout, c1_in, 3)
                sd[f"{p}.conv2.weight"] = conv(cout, cout, 3)
                bn(f"{p}.bn1", cout)
                bn(f"{p}.bn2", cout)
            if b == 0 and (li != 1 or bottleneck):
                sd[f"{p}.downsample.0.weight"] = conv(cout, cin, 1)
                bn(f"{p}.downsample.1", cout)
        cin = cout
    sd["fc.weight"] = rng.normal(0, cin ** -0.5, (1000, cin))
    sd["fc.bias"] = rng.normal(0, 0.1, 1000)
    out = {k: torch.from_numpy(np.asarray(v, np.float32))
           for k, v in sd.items()}
    out.update({k.replace("running_mean", "num_batches_tracked"):
                torch.tensor(0) for k in sd if k.endswith("running_mean")})
    return out


def imagenet_resnet_forward(seed: int, form: str, dtype, launches,
                            arch: str = "resnet18") -> None:
    """One private forward of an ImageNet ResNet18Private (1000 classes,
    224 px, resnet18_passport.json: K2 at (64,512,7,7)), or of ``arch``
    with its config (ResNet50Private: K2 at (64,512,14,14), (64,512,7,7)
    and, without the ReLU, (64,2048,7,7)), through Predictor, against the
    CPU: f32 at LOGITS_TOL on the batch; bf16 within BF16_LOGITS_NORM_TOL
    of the norm on 8 rows."""
    from deepipr_tpu_torch.serve import Predictor

    cpu_model = random_model(seed, dtype, arch, True, num_classes=1000,
                             size=IMAGENET_SIZE)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    per_forward = K2_PER_FORWARD[arch]
    last = (gpu_model.layer4_0.convbn_3 if arch == "resnet50"
            else gpu_model.layer4_0.convbn_2)
    if tuple(last.key.shape) != (1, 512, 7, 7):
        raise AssertionError("the ImageNet ResNet's layer4 is not 7x7")
    x = torch.randn((IMAGENET_BATCH, IMAGENET_SIZE, IMAGENET_SIZE, 3),
                    generator=torch.Generator().manual_seed(seed + 10))
    before = launches()[form]
    gpu_logits = Predictor(gpu_model, ind=1).logits(x).cpu()
    if launches()[form] - before != per_forward:
        raise AssertionError(f"ImageNet ResNet private forward: "
                             f"{launches()[form] - before} {form} launches")
    rows = IMAGENET_BATCH if dtype is None else 8
    cpu_logits = Predictor(cpu_model, ind=1, device="cpu").logits(x[:rows])
    if gpu_logits.shape != (IMAGENET_BATCH, 1000) or \
            not torch.isfinite(gpu_logits).all():
        raise AssertionError("non-finite or misshapen ImageNet logits")
    if dtype is None:
        torch.testing.assert_close(gpu_logits, cpu_logits, **LOGITS_TOL)
        err = (gpu_logits - cpu_logits).abs().max().item()
    else:
        err = _norm_err(gpu_logits[:rows], cpu_logits)
        if err > BF16_LOGITS_NORM_TOL:
            raise AssertionError(f"bf16 ImageNet ResNet logits differ from "
                                 f"the CPU's by {err} of their norm")
    log(f"ImageNet {MODEL_NAMES[arch]} private forward, batch "
        f"{IMAGENET_BATCH}, {dtype or torch.float32}: {per_forward} {form} "
        f"launches; card vs CPU on {rows} rows: {err:.3g} "
        f"({'largest error' if dtype is None else 'of the norm'})")


# ------------------------------------------------------------- ResNet-50

def resnet50_cli(smi: str, launches, reset):
    """The training entry point with --arch resnet50, in-process: scheme 0
    (train_v1) for 1 epoch, then V2 (train_v23, resnet50_passport.json,
    shuffle keys from its last.ckpt, --epoch-scan --pallas-input, f32) for
    RESNET50_EPOCHS, batch 256 over 12,800 images: K1 f32 every step and
    K2 f32 10 times a validation batch and in each signature detection,
    nothing else; the loss falls, the last epoch's mean train_sign_acc and
    every detection row read 1.0, and its best.ckpt in a fresh model
    verifies. Returns the V2 run's launch counts and its best.ckpt."""
    import shutil

    from deepipr_tpu_torch.cli import train_v1, train_v23
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.serve import verify_ownership
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.utils.checkpoint import load_state

    shutil.rmtree(RESNET50_LOGDIR, ignore_errors=True)
    size = {"synthetic_train": TRAIN_IMAGES}
    t = time.perf_counter()
    run0 = train_v1.main(RESNET50_CLI + ["--epochs", "1"], **size)
    log(f"ResNet-50 entry point: scheme 0, 1 epoch, in "
        f"{time.perf_counter() - t:.1f} s: {history(run0.logdir)[-1]}")
    pretrained = os.path.join(run0.logdir, "models", "last.ckpt")
    reset()
    t = time.perf_counter()
    run2 = train_v23.main(RESNET50_CLI + RESNET50_V2 + [
        "--pretrained-path", pretrained, "--epochs", str(RESNET50_EPOCHS)],
        **size)
    counts = launches()
    rows = history(run2.logdir)
    log(f"ResNet-50 entry point: V2 --epoch-scan --pallas-input, "
        f"{RESNET50_EPOCHS} epochs, in {time.perf_counter() - t:.1f} s; "
        f"launches {counts}")
    for epoch, row in enumerate(rows):
        log(f"  epoch {epoch}: train_sign_acc "
            f"{row['train_sign_acc']}, train_loss {row['train_loss']}, "
            f"train_sign_loss {row['train_sign_loss']}, "
            f"valid_total_acc {row['valid_total_acc']}, detection "
            f"{sorted({v for k, v in row.items() if k.startswith('s_')})}")
    steps = TRAIN_IMAGES // TRAIN_BATCH
    want = {"fused_augment": steps * RESNET50_EPOCHS,
            "passport_epilogue": RESNET50_EPOCHS * RESNET50_K2
            * (len(run2.valid_data) + 1)}
    if counts != {**dict.fromkeys(counts, 0), **want}:
        raise AssertionError(f"ResNet-50 entry-point launches {counts}, "
                             f"expected {want}")
    if not rows[-1]["train_loss"] < rows[0]["train_loss"]:
        raise AssertionError("the ResNet-50 V2 run's loss did not fall")
    signature = {k: v for k, v in rows[-1].items() if k.startswith("s_")}
    if len(signature) != RESNET50_K2:
        raise AssertionError(f"the ResNet-50 V2 run detects {signature}")
    check_detection(run2, "ResNet50Private V2 entry point")
    best = os.path.join(run2.logdir, "models", "best.ckpt")
    fresh = build_model("resnet50", 10, passport_kwargs=run2.passport_kwargs,
                        private=True, seed=12345)
    load_state(best, TrainState.create(fresh, 0.0), restore_opt=False)
    verdict = verify_ownership(fresh, (1, 32, 32, 3), private=True)
    if verdict["detection_rate"] != 1.0:
        raise AssertionError(f"the ResNet-50 best.ckpt does not verify: "
                             f"{verdict}")
    log(f"  ResNet-50 V2 best.ckpt in a fresh model: detection "
        f"{verdict['layers']} [{smi}]")
    return counts, best


def resnet50_attack_steps(best: str, launches, reset) -> dict:
    """``ambiguity_checks`` on the ResNet-50 V2 best.ckpt (f32), which the
    attack CLIs do not take (their --arch choices are the JAX package's):
    10 K2 and 10 K2-bwd launches an ambiguity step at batch 64 (4 of each
    without the ReLU), one ambiguity step and one forge step card vs CPU.
    Returns the launch counts from the step at batch 64 on."""
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.utils.checkpoint import load_state

    models = {}
    for dev in ("cpu", "cuda"):
        models[dev] = train_model(12345, dev, arch="resnet50")
        load_state(best, TrainState.create(models[dev], 0.0),
                   restore_opt=False)
    ambiguity_checks([], launches, reset, per_step=RESNET50_K2,
                     batch_sizes=(ATTACK_BATCH,), models=models)
    counts = launches()
    log(f"ResNet-50 attack steps: launches {counts}")
    return counts


# ----------------------------------------------------------------- main

# -------------------------------------------------------------- deploy

def _http(url: str, obj=None):
    """(status, JSON body) of a GET (obj None) or a JSON POST to a server
    of this process."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def fleet_path(pretrained: str, smi: str) -> list:
    """cli.train_ensemble: ResNet18Private V2, two members signed "Alice"
    and "Bob", --epoch-scan, batch 256 over 12,800 images, passports from
    the entry point's scheme-0 last.ckpt; each member's lowest per-layer
    detection must read 1.0 after the last epoch, and the members'
    passports differ. Returns the member checkpoints."""
    from deepipr_tpu_torch.cli import train_ensemble
    from deepipr_tpu_torch.serve import passports
    from deepipr_tpu_torch.train.ensemble import member_state

    t = time.perf_counter()
    run = train_ensemble.main(
        ["--arch", "resnet", "--members", str(len(DEPLOY_MEMBERS)),
         "--signatures", ",".join(DEPLOY_MEMBERS), "--epoch-scan",
         "--batch-size", str(TRAIN_BATCH), "--epochs", str(DEPLOY_EPOCHS),
         "--passport-config", RESNET_CONFIG, "--pretrained-path", pretrained,
         "--out", os.path.join(DEPLOY_DIR, "fleet")],
        synthetic_train=TRAIN_IMAGES)
    wall = time.perf_counter() - t
    for i, e in enumerate(run["epochs"], start=1):
        log(f"fleet epoch {i}: {e['seconds']:.3f} s, "
            f"{TRAIN_IMAGES / e['seconds']:.1f} img/s per member "
            f"({len(DEPLOY_MEMBERS)} members), losses {e['loss'].tolist()}, "
            f"lowest detection {e['sign'].tolist()} [{smi}]")
    accs = [{k: m[k] for k in ("acc_public", "acc_private")}
            for m in run["members"]]
    log(f"cli.train_ensemble: {DEPLOY_EPOCHS} epochs in {wall:.1f} s wall; "
        f"members {accs}")
    if not (run["epochs"][-1]["sign"] == 1.0).all():
        raise AssertionError(f"the fleet's detection is not 1.0 after "
                             f"{DEPLOY_EPOCHS} epochs: {run['epochs']}")
    own = [passports(member_state(run["ensemble"], i).model)
           for i in range(len(DEPLOY_MEMBERS))]
    if any(torch.equal(own[0][k], own[1][k]) for k in own[0]):
        raise AssertionError("two members share a passport")
    return [m["path"] for m in run["members"]]


def dispute_path(members: list, smi: str) -> None:
    """cli.verify_ownership on the fleet: member 0 with --commit --num-chars
    5 verifies and decodes "Alice" on every layer, member 1 "Bob"; member
    0 against its record verifies (also on the CPU, from the same
    checkpoint); member 1's passports claimed for member 0 fail (exit 1),
    at the CPU's detection rates layer for layer; member 1's record does
    not hold for member 0.

    A licensee's passports are another shuffle of the same pretrained
    activations (all non-negative after a ReLU), so a member's derived
    signs follow its filters more than the shuffle: the claim reads well
    above a random forgery's 0.5 (0.82-0.91 on the H100, PERF.md section
    6), and fails only because it is not 1.0."""
    from deepipr_tpu_torch.cli import verify_ownership

    common = ["--arch", "resnet", "--passport-config", RESNET_CONFIG]
    recs = [os.path.join(DEPLOY_DIR, f"member_{i}.commit.json")
            for i in range(len(members))]
    for i, name in enumerate(DEPLOY_MEMBERS):
        t = time.perf_counter()
        res = verify_ownership.main(common + [
            "--ckpt", members[i], "--commit", recs[i], "--num-chars",
            str(len(name))])
        seconds = time.perf_counter() - t
        if not res["verified"] or set(res["decoded"].values()) != {name}:
            raise AssertionError(f"member {i} does not verify as {name}: "
                                 f"{res}")
        log(f"verify_ownership member {i} --commit --num-chars "
            f"{len(name)}: exit 0, decoded {set(res['decoded'].values())}, "
            f"{seconds:.3f} s in-process (build, load, derive, hash) [{smi}]")
    checks = {
        "own record": (["--ckpt", members[0], "--check-commitment", recs[0]],
                       True, True),
        "member 1's passports claimed": (
            ["--ckpt", members[0], "--claimed-ckpt", members[1]], False,
            None),
        "member 1's record": (["--ckpt", members[0], "--check-commitment",
                               recs[1]], False, False),
    }
    for what, (argv, verified, valid) in checks.items():
        t = time.perf_counter()
        res = verify_ownership.main(common + argv)
        seconds = time.perf_counter() - t
        if res["verified"] != verified or \
                res.get("commitment_valid") != valid:
            raise AssertionError(f"verify_ownership with {what}: {res}")
        if what.endswith("claimed"):
            cpu = verify_ownership.main(common + argv, device="cpu")
            if res["layers"] != cpu["layers"]:
                raise AssertionError(f"claimed passports: the card's rates "
                                     f"{res['layers']}, the CPU's "
                                     f"{cpu['layers']}")
            log(f"  member 1's passports on member 0, by layer (the CPU's "
                f"too): {res['layers']}")
        log(f"verify_ownership member 0, {what}: exit "
            f"{0 if res['verified'] else 1}, detection "
            f"{res['detection_rate']:.4f}, commitment_valid "
            f"{res.get('commitment_valid')}; {seconds:.3f} s [{smi}]")
    res = verify_ownership.main(common + ["--ckpt", members[0],
                                          "--check-commitment", recs[0]],
                                device="cpu")
    if not (res["verified"] and res["commitment_valid"]):
        raise AssertionError(f"the card's record does not verify on the "
                             f"CPU: {res}")
    log("verify_ownership on the CPU: the card's record verifies")


def export_path(members: list) -> None:
    """cli.export_deployment of member 0 (--ind 0): the artifact holds no
    passport, signature or BN statistic, and its logits on the card lie
    within FOLD_TOL of the folded Predictor's; cli.export_torch_checkpoint
    of member 0: the .pth read back through interop/torch_import detects
    1.0."""
    from deepipr_tpu_torch.cli import export_deployment, \
        export_torch_checkpoint
    from deepipr_tpu_torch.cli.common import checkpoint_model, passport_kwargs
    from deepipr_tpu_torch.interop.torch_import import load_torch_checkpoint
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.serve import Predictor, verify_ownership
    from deepipr_tpu_torch.utils.checkpoint import load_model

    common = ["--arch", "resnet", "--passport-config", RESNET_CONFIG,
              "--ckpt", members[0]]
    artifact = os.path.join(DEPLOY_DIR, "member_0.deploy.ckpt")
    export_deployment.main(common + ["--ind", "0", "--out", artifact])
    names = torch.load(artifact, map_location="cpu",
                       weights_only=True)["model"]
    secret = [k for k in names if k.rsplit(".", 1)[-1] in (
        "key", "skey", "b", "running_mean", "running_var")]
    if secret:
        raise AssertionError(f"the deployment artifact holds {secret[:4]}")
    deployed = load_model(artifact, build_model("resnet", 10, "none"))
    kw = passport_kwargs(RESNET_CONFIG, "bn", "shuffle", 0.1)
    model = checkpoint_model(members[0], "resnet", 10, "bn", kw, True, 32,
                             "cuda")
    x = request_batches(1, 17)[0]["image"]
    got = Predictor(deployed).logits(x)
    want = Predictor(model, folded=True, input_shape=(1, 32, 32, 3)).logits(x)
    torch.testing.assert_close(got, want, **FOLD_TOL)
    log(f"export_deployment: {len(names)} entries, no secrets; artifact vs "
        f"folded Predictor on the card, largest error "
        f"{(got - want).abs().max().item():.3g}")

    pth = os.path.join(DEPLOY_DIR, "member_0.pth")
    export_torch_checkpoint.main(common + ["--out", pth])
    fresh = build_model("resnet", 10, passport_kwargs=kw, private=True,
                        seed=777)
    load_torch_checkpoint(pth, fresh)
    verdict = verify_ownership(fresh, (1, 32, 32, 3), private=True)
    if verdict["detection_rate"] != 1.0:
        raise AssertionError(f"the exported .pth does not verify: {verdict}")
    log(f"export_torch_checkpoint: .pth read back detects "
        f"{verdict['detection_rate']}")


def http_path(name: str, argv: list, smi: str, counted: str) -> dict:
    """cli.serve_http (``argv``) in a thread of this process: requests of
    SERVE_ROWS rows in uint8 and normalized, each answer equal to an
    in-process Predictor's on the same padded batch (and on the unpadded
    rows); 8 concurrent requests as their serial twins; /healthz, a bad
    shape (400) and 257 rows (413); then the median latency_ms of each
    bucket. The server's native calls (it normalizes each uint8 request)
    go into HOST_CALLS[counted]: the rows compared are normalized before
    the count starts. Returns {bucket: median ms}."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from deepipr_tpu_torch.cli import serve_http
    from deepipr_tpu_torch.data.datasets import normalize, synthetic_dataset

    _, _, images, _ = synthetic_dataset(num_train=0, num_test=512, seed=23)
    normalized = {rows: normalize(images[:rows]) for rows in SERVE_ROWS}
    native_reset()
    args = serve_http.build_parser().parse_args(argv)
    t = time.perf_counter()
    srv = serve_http.make_server(args, port=0)
    log(f"serve_http {name}: built and warmed in "
        f"{time.perf_counter() - t:.1f} s")
    twin = serve_http.build_predictor(args)  # the in-process Predictor
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, body = _http(url + "/healthz")
        if code != 200 or not body["ok"]:
            raise AssertionError(f"/healthz: {code} {body}")
        for rows in SERVE_ROWS:
            x = images[:rows]
            bucket = next(s for s in srv.batch_sizes if s >= rows)
            padded = np.zeros((bucket, 32, 32, 3), np.float32)
            padded[:rows] = normalized[rows]
            want = twin.predict(padded)[:rows].tolist()
            alone = twin.predict(normalized[rows]).tolist()
            for form, obj in (("uint8", {"images": x.tolist()}),
                              ("normalized",
                               {"images": normalized[rows].tolist()})):
                code, body = _http(url + "/predict", obj)
                if code != 200 or body["classes"] != want:
                    raise AssertionError(f"{name}: {rows} rows {form}: "
                                         f"{code}, not the Predictor's")
            log(f"serve_http {name}: {rows} rows (bucket {bucket}) uint8 "
                f"and normalized equal the in-process Predictor's; "
                f"{sum(a != b for a, b in zip(want, alone))} rows differ "
                f"from it unpadded")
        batches = [images[8 * i:8 * i + n].tolist()
                   for i, n in enumerate(range(1, 9))]
        serial = [_http(url + "/predict", {"images": b})[1]["classes"]
                  for b in batches]
        with ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(
                lambda b: _http(url + "/predict", {"images": b}), batches))
        if [a[1].get("classes") for a in answers] != serial:
            raise AssertionError(f"{name}: concurrent answers differ from "
                                 "their serial twins")
        for obj, status in (({"images": np.zeros((2, 5, 5, 3)).tolist()},
                             400),
                            ({"images": np.zeros((257, 2, 2, 3)).tolist()},
                             413)):
            code, body = _http(url + "/predict", obj)
            if code != status:
                raise AssertionError(f"{name}: {code} {body}, expected "
                                     f"{status}")
        medians = {}
        for bucket, reps in SERVE_TIMED.items():
            obj = {"images": images[:bucket].tolist()}
            ms = [_http(url + "/predict", obj)[1]["latency_ms"]
                  for _ in range(reps)]
            medians[bucket] = statistics.median(ms)
        log(f"serve_http {name}: 8 concurrent requests as their serial "
            f"twins; /healthz, 400, 413; median latency_ms by bucket "
            f"{medians} (requests by bucket {SERVE_TIMED}) [{smi}]")
        HOST_CALLS[counted] = native_calls()
        return medians
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=HTTP_TIMEOUT)


def deploy_path(pretrained: str, alexnet_v1: str, smi: str, launches,
                reset) -> dict:
    """The licensing and dispute workflow through its CLIs: the fleet
    (``fleet_path``), verification and commitments (``dispute_path``), the
    deployment artifact and the .pth (``export_path``), and two servers
    (``http_path``): member 0 folded, and AlexNet V1's best.ckpt
    ``--no-folded --no-private``, whose every request runs K2. Returns the
    phase's launch counts (K2 f32 in the signature rows, the dual evals,
    verification, the commitments and V1 serving)."""
    import shutil

    shutil.rmtree(DEPLOY_DIR, ignore_errors=True)
    os.makedirs(DEPLOY_DIR)
    reset()
    native_reset()
    members = fleet_path(pretrained, smi)
    HOST_CALLS["fleet"] = native_calls()
    dispute_path(members, smi)
    export_path(members)
    folded = http_path("folded ResNet18Private member 0", [
        "--ckpt", members[0], "--arch", "resnet", "--passport-config",
        RESNET_CONFIG], smi, "http_folded")
    before = launches()["passport_epilogue"]
    v1 = http_path("AlexNet V1 --no-folded --no-private", [
        "--ckpt", alexnet_v1, "--arch", "alexnet", "--passport-config",
        ALEXNET_CONFIG, "--no-folded", "--no-private"], smi,
        "http_alexnet_v1")
    counts = launches()
    if counts["passport_epilogue"] == before:
        raise AssertionError("the unfolded V1 server launched no K2")
    log(f"deploy: launches {counts}; median latency_ms folded {folded}, "
        f"V1 unfolded {v1} [{smi}]")
    return counts


# ------------------------------------------------------------ norm types

def norm_types_check(seed: int, smi: str) -> None:
    """ResNet18Private V2 with each norm type the port trains besides eval
    BN's K2 path (``gn``, ``in``, ``none``; passport layers take K2 only
    for BN, models/layers.py), and BN with ``--separate-stats``: each
    branch's forward at batch PARITY_BATCH at LOGITS_TOL, and one train
    step at train_parity's f32 bounds, card vs CPU."""
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.serve import Predictor
    from deepipr_tpu_torch.utils.config import (
        construct_passport_kwargs,
        load_passport_config,
        mark_separate_stats,
    )

    x = torch.randn((PARITY_BATCH, 32, 32, 3),
                    generator=torch.Generator().manual_seed(seed + 21))
    for norm, separate in NORM_CASES:
        label = f"ResNet18Private V2 norm {norm}" + (
            " --separate-stats" if separate else "")
        kw, _ = construct_passport_kwargs(
            load_passport_config(RESNET_CONFIG), norm, "shuffle", 0.1)
        if separate:
            mark_separate_stats(kw)
        cpu_model = build_model("resnet18", 10, norm_type=norm,
                                passport_kwargs=kw, private=True,
                                seed=seed + 22, device="cpu")
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        for ind in (0, 1):
            got = Predictor(gpu_model, ind=ind).logits(x).cpu()
            want = Predictor(cpu_model, ind=ind, device="cpu").logits(x)
            torch.testing.assert_close(got, want, **LOGITS_TOL)
            log(f"{label}: branch {ind} forward, card vs CPU largest "
                f"error {(got - want).abs().max().item():.3g}")
        del gpu_model
        train_parity(seed, steps=1, cpu_model=cpu_model, label=label)
    log(f"norm types: every case agrees card vs CPU [{smi}]")


# --------------------------------------------------------- host augment

def _native_fns():
    from deepipr_tpu_torch.data import native

    return native.normalize_native, native.augment_normalize_native


def native_reset() -> None:
    """Set the calls of data/native.py's functions to 0 (just before a
    host-fed path; ``native_calls`` reads them just after)."""
    for fn in _native_fns():
        fn.calls = 0


def native_calls() -> dict:
    return {fn.__name__: fn.calls for fn in _native_fns()}


def host_augment_cases(seed: int) -> list:
    """(function, label, batch, draws or None, pad): the training batch at
    pad 4 whose first eight images take every extreme draw (offsets 0 and
    2 pad on both axes, the flip off and on), the trigger set's pair at pad
    0 (one flipped), the CIFAR validation batch and the ImageNet stream's
    batch normalized."""
    rng = np.random.default_rng(seed)
    cifar = rng.integers(0, 256, (TRAIN_BATCH, 32, 32, 3), dtype=np.uint8)
    pad = TRAIN_PAD
    ys = rng.integers(0, 2 * pad + 1, TRAIN_BATCH).astype(np.int32)
    xs = rng.integers(0, 2 * pad + 1, TRAIN_BATCH).astype(np.int32)
    flips = (rng.random(TRAIN_BATCH) < 0.5).astype(np.uint8)
    corners = [(y, x, f) for y in (0, 2 * pad) for x in (0, 2 * pad)
               for f in (0, 1)]
    for i, (y, x, f) in enumerate(corners):
        ys[i], xs[i], flips[i] = y, x, f
    pair = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    zeros = np.zeros(2, np.int32)
    imagenet = rng.integers(0, 256, (IMAGENET_BATCH, IMAGENET_SIZE,
                                     IMAGENET_SIZE, 3), dtype=np.uint8)
    return [
        ("augment_normalize_native", f"{TRAIN_BATCH}x32x32x3 pad {pad}",
         cifar, (ys, xs, flips), pad),
        ("augment_normalize_native", "2x32x32x3 pad 0", pair,
         (zeros, zeros, np.array([0, 1], np.uint8)), 0),
        ("normalize_native", f"{TRAIN_BATCH}x32x32x3", cifar, None, 0),
        ("normalize_native",
         f"{IMAGENET_BATCH}x{IMAGENET_SIZE}x{IMAGENET_SIZE}x3", imagenet,
         None, 0),
    ]


def _host_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps + 1):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return 1e3 * statistics.median(times[1:])


def host_augment(seed: int, smi: str) -> dict:
    """data/native.py on the card's host: csrc/augment.cpp built with g++;
    each case of ``host_augment_cases`` against the plain version within
    HOST_TOL, the padding and flip positions exact (a constant-255 batch
    with its first column black); both timed on the host. Returns
    {function: record} for the host_kernels line."""
    from deepipr_tpu_torch.data import native
    from deepipr_tpu_torch.data.datasets import IMAGENET_MEAN, IMAGENET_STD

    t = time.perf_counter()
    native.get_lib()
    log(f"host_augment: g++ {' '.join(native.GXX_FLAGS)} -> "
        f"{native.library_path()} in {time.perf_counter() - t:.2f} s; host "
        f"{native.host_id()!r}, "
        f"os.cpu_count() {os.cpu_count()}")
    stats = (IMAGENET_MEAN, IMAGENET_STD)
    out = {}
    for name, label, batch, draws, pad in host_augment_cases(seed):
        if draws is None:
            def run(fn, x):
                return fn(x, *stats)

            fns = (native.normalize_native, native.normalize_plain)
        else:
            def run(fn, x):
                return fn(x, *draws, pad, *stats)

            fns = (native.augment_normalize_native,
                   native.augment_normalize_plain)
        got, want = (run(fn, batch) for fn in fns)
        err = float(np.abs(got - want).max())
        if got.dtype != np.float32 or got.shape != batch.shape:
            raise AssertionError(f"host_augment {name} {label}: "
                                 f"{got.dtype} {got.shape}")
        np.testing.assert_allclose(got, want, **HOST_TOL)
        white = np.full_like(batch, 255)
        white[:, :, 0] = 0
        got, want = (run(fn, white) for fn in fns)
        if not np.array_equal(got > 0, want > 0):
            raise AssertionError(f"host_augment {name} {label}: padding or "
                                 "flip positions differ from the plain "
                                 "version")
        reps = HOST_REPS if batch.size < 2**22 else HOST_REPS_LARGE
        ms = _host_ms(lambda: run(fns[0], batch), reps)
        plain_ms = _host_ms(lambda: run(fns[1], batch), reps)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "reps": reps}
        log(f"host_augment {name} {label}: {json.dumps(row)} "
            f"[{smi}; host {native.host_id()!r}, {os.cpu_count()} "
            f"cores]")
        entry = out.setdefault(name, {
            "name": name, "route": "host c++ (g++ "
            + " ".join(native.GXX_FLAGS) + ")",
            "source": "deepipr_tpu_torch/csrc/augment.cpp",
            "replaces": "deepipr_tpu/data/native.py (native/augment.cpp)",
            "tol": HOST_TOL, "host": native.host_id(),
            "cpu_count": os.cpu_count(), "by_shape": {}})
        entry["by_shape"][label] = row
    for entry in out.values():
        entry["max_abs_err"] = max(r["max_abs_err"]
                                   for r in entry["by_shape"].values())
    return out


def host_calls_report(host: dict) -> list:
    """Each host-fed path's native calls (HOST_CALLS) checked against
    HOST_FED, into the host_kernels records: raises if a path did not run
    or made no call of a function it must call."""
    missing = [(path, fn) for path, fns in HOST_FED.items() for fn in fns
               if not HOST_CALLS.get(path, {}).get(fn)]
    if missing:
        raise AssertionError(f"host-fed paths without native calls: "
                             f"{missing}; counted {HOST_CALLS}")
    for name, entry in host.items():
        by_path = {path: c[name] for path, c in HOST_CALLS.items()
                   if c.get(name)}
        entry["calls"] = sum(by_path.values())
        entry["calls_by_path"] = by_path
    log(f"host_augment: native calls by path {json.dumps(HOST_CALLS)}")
    return list(host.values())


# ------------------------------------------------------------ data path

def write_data(root: str) -> dict:
    """The data phase's sets under ``root``, by tools/make_imagefolder.py:
    ILSVRC2012/{train,val} (DATA_CLASSES classes, DATA_TRAIN and DATA_VAL
    JPEGs a class at DATA_PX) and caltech-101/<class> (101 classes,
    CALTECH_PER_CLASS JPEGs a class at 32 px). Returns the counts."""
    import shutil

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import make_imagefolder

    from concurrent.futures import ThreadPoolExecutor

    shutil.rmtree(root, ignore_errors=True)
    base = os.path.join(root, "ILSVRC2012")
    splits = {"imagenet train": (base, "train", DATA_CLASSES, DATA_TRAIN,
                                 DATA_PX),
              "imagenet val": (base, "val", DATA_CLASSES, DATA_VAL, DATA_PX),
              "caltech-101": (root, "caltech-101", 101, CALTECH_PER_CLASS,
                              32)}
    with ThreadPoolExecutor(len(splits)) as pool:
        counts = {name: pool.submit(make_imagefolder.write_split, where,
                                    split, classes, per_class, 0, px, 90)
                  for name, (where, split, classes, per_class, px)
                  in splits.items()}
    return {name: c.result() for name, c in counts.items()}


@contextlib.contextmanager
def step_events(records: list):
    """Each train step the experiment builds, bracketed by CUDA events on
    the current stream; (start, end) pairs appended to ``records``."""
    from deepipr_tpu_torch.train import experiment

    real = experiment.make_train_step

    def spy(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch)
            end.record()
            records.append((start, end))
            return out

        return timed

    experiment.make_train_step = spy
    try:
        yield
    finally:
        experiment.make_train_step = real


def prefetch_split(label: str, exp, records: list, smi: str) -> dict:
    """The last epoch's split of a host-fed run: the producer's seconds a
    batch in the loader (decode, crop, stack) and in staging, the step's
    device milliseconds between its CUDA events, and the epoch's wall
    time beside steps x max and steps x sum of the two."""
    torch.cuda.synchronize()
    host = exp.prefetch_stats["host_s"]
    stage = exp.prefetch_stats["stage_s"]
    steps = len(host)
    device_ms = [s.elapsed_time(e) for s, e in records[-steps:]]
    wall = history(exp.logdir)[-1]["train_time"]
    host_ms = 1e3 * statistics.mean(host)
    stage_ms = 1e3 * statistics.mean(stage)
    step_ms = statistics.mean(device_ms)
    out = {"steps": steps, "host_ms": host_ms, "stage_ms": stage_ms,
           "device_ms": step_ms, "wall_s": wall,
           "steps_x_max_s": steps * max(host_ms + stage_ms, step_ms) / 1e3,
           "steps_x_sum_s": steps * (host_ms + stage_ms + step_ms) / 1e3,
           "cpu_count": os.cpu_count()}
    log(f"prefetch split {label}: {json.dumps(out)} [{smi}]")
    return out


def update_spread(a, b, start: dict) -> tuple:
    """(largest per-parameter, whole) distance between two trained models'
    parameters, each over the norm of ``a``'s update from ``start``."""
    b_params = dict(b.named_parameters())
    per, diffs, updates = {}, [], []
    for name, p in a.named_parameters():
        update = p.detach().cpu() - start[name]
        diff = b_params[name].detach().cpu() - p.detach().cpu()
        per[name] = diff.norm().item() / max(update.norm().item(), 1e-30)
        diffs.append(diff.ravel())
        updates.append(update.ravel())
    whole = (torch.cat(diffs).norm() / torch.cat(updates).norm()).item()
    worst = max(per, key=per.get)
    return per[worst], worst, whole


def step_alone(label: str, exp, smi: str, reps: int = 10) -> float:
    """The median device milliseconds of ``exp``'s train step between CUDA
    events on one streamed batch already on the card, with no producer
    running beside it (the model trains on)."""
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in next(iter(exp.train_data)).items()}
    pairs = []
    for rep in range(reps + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        exp.state, _ = exp.train_step(exp.state, batch)
        end.record()
        if rep >= 2:
            pairs.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in pairs)
    log(f"{label}: a train step alone {ms:.3f} ms on the card (median of "
        f"{reps}, batch {len(batch['label'])}) [{smi}]")
    return ms


def imagenet_parity(seed: int, batches: list, smi: str) -> None:
    """AlexNet's ImageNet head (1000 classes, 224 px, dropout) V2 from random
    weights on the first two streamed raw batches, card vs CPU, with the
    same injected dropout masks; K1 at pad 0 with zero draws on the card,
    its plain version on the CPU. One step on each batch from the same
    start, each held at train_parity's f32 bounds; then both steps
    chained, whose spread is logged beside the CPU's own after every
    starting weight is moved by at most one ulp: the second step amplifies
    rounding (PERF.md section 6)."""
    from deepipr_tpu_torch.models.alexnet import DROPOUT_KEEP
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.train.steps import make_train_step, zero_draws
    from deepipr_tpu_torch.utils.config import (
        construct_passport_kwargs,
        load_passport_config,
    )

    kw, _ = construct_passport_kwargs(load_passport_config(ALEXNET_CONFIG),
                                      "bn", "shuffle", 0.1)
    cpu_model = build_model("alexnet", 1000, passport_kwargs=kw,
                            private=True, imagenet=True,
                            input_size=IMAGENET_SIZE, seed=seed + 31,
                            device="cpu")
    gen = torch.Generator().manual_seed(seed + 32)
    masks = [[torch.rand(shape, generator=gen) < DROPOUT_KEEP
              for shape in cpu_model.dropout_shapes(len(b["label"]))]
             for b in batches]
    start = {k: p.detach().clone() for k, p in cpu_model.named_parameters()}

    def train(dev: str, order, model=cpu_model):
        model = copy.deepcopy(model).to(dev)
        state = TrainState.create(model, TRAIN_LR)
        sums = {}
        for i in order:
            step = make_train_step(
                model, True, pad=0, draws=zero_draws(torch.device(dev)),
                dropout=lambda t, shapes, i=i: [m.to(dev) for m in masks[i]],
                device=dev)
            state, metrics = step(state, batches[i])
            sums = {k: sums.get(k, 0.0) + v.item() for k, v in metrics.items()}
        return model, {k: v / len(order) for k, v in sums.items()}

    for i in range(len(batches)):
        (cpu, cpu_metrics), (gpu, gpu_metrics) = train("cpu", [i]), \
            train("cuda", [i])
        compare_training(f"ImageNet AlexNet V2, streamed batch {i} at batch "
                         f"{len(batches[i]['label'])}, dropout masks "
                         f"injected", cpu, gpu, start, cpu_metrics,
                         gpu_metrics)
    chained = list(range(len(batches)))
    cpu, _ = train("cpu", chained)
    gpu, _ = train("cuda", chained)
    bumped = copy.deepcopy(cpu_model)
    bump = torch.Generator().manual_seed(seed + 33)
    with torch.no_grad():
        for p in bumped.parameters():
            way = torch.randint(-1, 2, p.shape, generator=bump)
            inf = torch.full_like(p, float("inf"))
            p.copy_(torch.where(way > 0, torch.nextafter(p, inf),
                                torch.where(way < 0, torch.nextafter(p, -inf),
                                            p)))
    ulp, _ = train("cpu", chained, bumped)
    for label, other in (("card vs CPU", gpu), ("CPU vs CPU from weights "
                                                 "one ulp apart", ulp)):
        worst, name, whole = update_spread(cpu, other, start)
        log(f"ImageNet AlexNet V2, {len(chained)} chained steps, {label}: "
            f"largest parameter-update difference {worst:.3g} of the "
            f"update's norm at {name}; whole update {whole:.3g} [{smi}]")


def prefetched_equal(root: str) -> None:
    """Three batches of the ImageNet stream, raw and normalized, through
    ``prefetch`` onto the card against the loader's own moved by hand:
    bit for bit."""
    from deepipr_tpu_torch.data.datasets import StreamingImageFolder
    from deepipr_tpu_torch.data.prefetch import prefetch

    for raw in (True, False):
        def loader():
            return StreamingImageFolder(
                os.path.join(root, "ILSVRC2012", "train"), IMAGENET_BATCH,
                train=True, shuffle=True, seed=5, raw=raw)

        got = list(itertools.islice(
            prefetch(loader(), size=2, device="cuda"), 3))
        want = [{k: torch.as_tensor(v).cuda() for k, v in b.items()}
                for _, b in zip(range(3), loader())]
        for g, w in zip(got, want):
            if sorted(g) != sorted(w) or not all(
                    g[k].device.type == "cuda" and g[k].dtype == w[k].dtype
                    and torch.equal(g[k], w[k]) for k in w):
                raise AssertionError(f"a prefetched batch (raw={raw}) "
                                     "differs from the loader's own")
    log("prefetch: raw and normalized ImageNet batches on the card equal "
        "the loader's own moved by hand, bit for bit")


def loader_threads(root: str, smi: str, batches: int = 3) -> dict:
    """The ImageNet loader alone (raw train batches of 64, nothing else
    running): the median milliseconds a batch over ``batches`` batches after
    the first, with 1 decode thread, one a host core and the default 16;
    beside it, a batch's worth of PIL resizes of one crop to 224 px, alone
    in the loader's crop step, on 1 and on 16 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from deepipr_tpu_torch.data.datasets import StreamingImageFolder

    crop = Image.fromarray(np.random.default_rng(7).integers(
        0, 256, (180, 200, 3), dtype=np.uint8))
    out = {"cpu_count": os.cpu_count()}
    for workers in (1, 16):
        with ThreadPoolExecutor(workers) as pool:
            t = time.perf_counter()
            list(pool.map(lambda _: crop.resize((IMAGENET_SIZE,) * 2),
                          range(IMAGENET_BATCH)))
            out[f"resize_{workers}_ms"] = 1e3 * (time.perf_counter() - t)
    for workers in sorted({1, os.cpu_count(), 16}):
        loader = StreamingImageFolder(
            os.path.join(root, "ILSVRC2012", "train"), IMAGENET_BATCH,
            train=True, shuffle=True, seed=7, raw=True, workers=workers)
        times, it = [], iter(loader)
        for _ in range(batches + 1):
            t = time.perf_counter()
            next(it)
            times.append(time.perf_counter() - t)
        it.close()
        out[f"workers_{workers}_ms"] = 1e3 * statistics.median(times[1:])
    out["speedup_16"] = out["workers_1_ms"] / out["workers_16_ms"]
    log(f"loader threads: {json.dumps(out)} [{smi}]")
    return out


def data_path(best: str, smi: str, launches, reset) -> dict:
    """The host data path through the entry points (phase 17 of the
    module's docstring). Returns {path name: launch counts}."""
    from deepipr_tpu_torch.attacks.common import plkey_to_module_path
    from deepipr_tpu_torch.cli import train_v1, train_v23
    from deepipr_tpu_torch.data.datasets import prepare_dataset

    t = time.perf_counter()
    written = write_data(DATA_DIR)
    log(f"data: wrote {written} JPEGs under {DATA_DIR} in "
        f"{time.perf_counter() - t:.1f} s; os.cpu_count() {os.cpu_count()}")
    logdir = os.path.join(DATA_DIR, "logs")
    common = ["--arch", "alexnet", "--dataset", "imagenet1000",
              "--batch-size", str(IMAGENET_BATCH), "--data-root", DATA_DIR,
              "--logdir", logdir]
    # random keys: deriving shuffle or image keys runs the pretrained model
    # in train mode, which the ImageNet head's dropout refuses without
    # masks, in the JAX package (InvalidRngError, train/keys.py:43) as in
    # the port
    v2 = common + ["--passport-config", ALEXNET_CONFIG, "--key-type",
                   "random", "--device-augment"]
    out, records = {}, []
    with step_events(records):
        reset()
        t = time.perf_counter()
        run0 = train_v1.main(common + ["--epochs", "1"])
        got = launches()
        log(f"data: ImageNet AlexNet scheme 0, 1 epoch, in "
            f"{time.perf_counter() - t:.1f} s: {history(run0.logdir)[-1]}; "
            f"launches {got}")
        if any(got.values()):
            raise AssertionError(f"scheme 0 launched a kernel: {got}")
        prefetch_split("ImageNet AlexNet scheme 0 f32 (normalized on the "
                       "host)", run0, records, smi)
        for label, flags, epochs, k1, k2 in (
                ("f32", [], 2, "fused_augment", "passport_epilogue"),
                ("bf16", ["--bf16"], 1, "fused_augment_bf16",
                 "passport_epilogue_bf16")):
            reset()
            t = time.perf_counter()
            run = train_v23.main(v2 + flags + ["--epochs", str(epochs)])
            got = out[f"data_imagenet_{label}"] = launches()
            rows = history(run.logdir)
            log(f"data: ImageNet AlexNet V2 --device-augment {label}, "
                f"{epochs} epochs, in {time.perf_counter() - t:.1f} s; "
                f"launches {got}; history {rows}")
            steps = len(run.train_data)
            want = {k1: epochs * steps,
                    k2: epochs * ALEXNET_K2 * (len(run.valid_data) + 1)}
            if got != {**dict.fromkeys(got, 0), **want}:
                raise AssertionError(f"ImageNet V2 {label} launches {got}, "
                                     f"expected {want}")
            cols = {f"train_{k}" for k in (
                "acc_public", "acc_private", "loss", "sign_loss",
                "sign_acc", "time", "images_per_sec")}
            cols |= {f"valid_{k}" for k in (
                "loss_public", "acc_public", "loss_private", "acc_private",
                "total_acc")}
            cols |= {f"s_private_{plkey_to_module_path(k)}"
                     for k in run.plkeys}
            if set(rows[-1]) != cols or len(rows) != epochs:
                raise AssertionError(f"ImageNet V2 {label} columns "
                                     f"{sorted(rows[-1])}, want "
                                     f"{sorted(cols)}")
            if not all(np.isfinite(v) for r in rows for v in r.values()):
                raise AssertionError(f"ImageNet V2 {label}: {rows}")
            prefetch_split(f"ImageNet AlexNet V2 {label} (uint8, K1 "
                           f"normalizes)", run, records, smi)
            step_alone(f"ImageNet AlexNet V2 {label}", run, smi)
            del run

    t = time.perf_counter()
    train, _ = prepare_dataset({"dataset": "imagenet1000",
                                "batch_size": IMAGENET_BATCH,
                                "data_root": DATA_DIR, "device_augment": True})
    batches = [b for _, b in zip(range(2), train)]
    imagenet_parity(0, batches, smi)
    log(f"data: ImageNet train parity in {time.perf_counter() - t:.1f} s")
    prefetched_equal(DATA_DIR)
    loader_threads(DATA_DIR, smi)

    # one host-fed ResNet18Private f32 epoch over 12,800 images
    with step_events(records):
        reset()
        native_reset()
        run = train_v23.main(CLI_COMMON + [
            "--passport-config", RESNET_CONFIG, "--key-type", "shuffle",
            "--pretrained-path", os.path.join(
                CLI_LOGDIR, "resnet_synthetic_v0", "1", "models",
                "last.ckpt"), "--epochs", "1", "--logdir", logdir],
            synthetic_train=TRAIN_IMAGES)
        HOST_CALLS["data_resnet_host_f32"] = native_calls()
        got = out["data_resnet_host_f32"] = launches()
        want = {"passport_epilogue": RESNET_K2 * (len(run.valid_data) + 1)}
        if got != {**dict.fromkeys(got, 0), **want}:
            raise AssertionError(f"host-fed ResNet18Private launches {got}, "
                                 f"expected {want}")
        prefetch_split("ResNet18Private V2 f32 host-fed (augmented on the "
                       "host)", run, records, smi)
        del run

    reset()
    native_reset()
    t = time.perf_counter()
    exp = train_v23.main(
        ["--arch", "resnet", "--dataset", "synthetic", "--batch-size",
         str(TRAIN_BATCH), "--passport-config", RESNET_CONFIG,
         "--transfer-learning", "--tl-dataset", "caltech-101",
         "--tl-scheme", "rtal", "--pretrained-path", best, "--epochs", "1",
         "--logdir", logdir, "--data-root", DATA_DIR])
    HOST_CALLS["data_caltech_tl"] = native_calls()
    got = out["data_caltech_tl"] = launches()
    rows = history(os.path.join(exp.logdir, "tl_1"))
    log(f"data: Caltech-101 transfer learning rtal, 1 epoch, in "
        f"{time.perf_counter() - t:.1f} s; launches {got}; rows {rows}")
    cols = {"epoch", "train_acc", "train_loss", "train_sign_acc",
            "train_sign_loss", "valid_acc", "valid_loss"}
    cols |= {f"old_wm_passport_private_{p.replace('.', '/')}"
             for p in map(plkey_to_module_path, exp.plkeys)}
    if set(rows[-1]) != cols or len(rows) != 1 or not all(
            np.isfinite(v) for v in rows[-1].values()):
        raise AssertionError(f"Caltech-101 TL rows {rows}, want columns "
                             f"{sorted(cols)}")
    want = {"passport_epilogue": 2 * RESNET_K2}
    if got != {**dict.fromkeys(got, 0), **want}:
        raise AssertionError(f"Caltech-101 TL launches {got}, expected "
                             f"{want}")
    return out


# ------------------------------------------------------ signature checks

def check_detection(run, label: str) -> None:
    """Hold every signature detection row of the last epoch at exactly 1.0,
    and print its epoch-mean ``train_sign_acc``, which counts every bit at
    every step: a scale crossing zero for a few steps of a high-lr epoch
    lowers it in the JAX package alike (PERF.md §6), so it is not
    held."""
    rows = history(run.logdir)
    signature = {k: v for k, v in rows[-1].items() if k.startswith("s_")}
    log(f"  {label}: epoch-mean train_sign_acc "
        f"{[r['train_sign_acc'] for r in rows]}")
    if not signature or set(signature.values()) != {1.0}:
        raise AssertionError(f"{label}: the signature is not embedded: "
                             f"detection {signature}")


# ------------------------------------------------------- the parallel path

def parallel_inputs(seed: int) -> dict:
    """What every rank of the parallel path is handed: bench.py's model's
    weights, a set of PARALLEL_SET images with its permutation and each
    step's draws (V2 then V3), the trigger set and its permutation, a
    validation batch, a fleet of two and its batches, and a batch for the
    model axis."""
    from deepipr_tpu_torch.data.datasets import normalize, synthetic_dataset
    from deepipr_tpu_torch.data.device_augment import draw_augment

    x, y, xv, yv = synthetic_dataset(num_train=PARALLEL_SET,
                                     num_test=REQUEST_BATCH, size=32,
                                     seed=seed + 30)
    wx, wy, fx, fy = synthetic_dataset(num_train=PARALLEL_TRIGGERS,
                                       num_test=2 * TRAIN_BATCH, size=32,
                                       seed=seed + 31)
    gen = torch.Generator().manual_seed(seed + 32)
    steps = PARALLEL_SET // TRAIN_BATCH
    return {
        "seed": seed,
        "state": train_model(seed + 30, "cpu").state_dict(),
        "members": [train_model(seed + 40 + i, "cpu").state_dict()
                    for i in range(PARALLEL_MEMBERS)],
        "images": torch.from_numpy(x), "labels": torch.from_numpy(y),
        "perm": torch.randperm(PARALLEL_SET, generator=gen),
        "draws": [list(draw_augment(gen, TRAIN_BATCH, TRAIN_PAD))
                  for _ in range(steps)],
        "wm_images": torch.from_numpy(wx), "wm_labels": torch.from_numpy(wy),
        "wm_perm": torch.randperm(PARALLEL_TRIGGERS, generator=gen),
        "valid": {"image": torch.from_numpy(normalize(xv)),
                  "label": torch.from_numpy(yv)},
        "fleet": [{"image": torch.from_numpy(normalize(fx[i:i + TRAIN_BATCH])),
                   "label": torch.from_numpy(fy[i:i + TRAIN_BATCH])}
                  for i in range(0, 2 * TRAIN_BATCH, TRAIN_BATCH)],
    }


def _digest(flat: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(flat.tobytes()).hexdigest()


def _v3_batch(inputs: dict, images, labels, wm, t: int, rows, take: int,
              dev) -> dict:
    """The epoch's V3 batch of step ``t`` (train/epoch.py): the rows, the
    next ``take`` triggers of the cycle, the pair at weight 1 and the
    lookaheads at weight 0."""
    wm_x, wm_y = wm
    m = wm_x.shape[0]
    idx = inputs["wm_perm"].to(dev)[(t * 2 + torch.arange(take, device=dev))
                                    % m]
    weight = torch.ones(TRAIN_BATCH + take, device=dev)
    weight[TRAIN_BATCH + 2:] = 0.0
    return {"image": images, "index": rows.to(torch.int32),
            "label": labels[rows], "wm_image": wm_x[idx],
            "wm_label": wm_y[idx], "weight": weight}


def parallel_rank(rank: int, directory: str) -> None:
    """One of PARALLEL_RANKS gloo ranks on cuda:0 (``--parallel-rank``):
    (a) two split V2 then two V3 steps of the mesh epoch (K1 over this
    rank's rows) on a 4x1 mesh and one evaluation (K2), (d) one step of a
    model-sharded state against the replicated one on a 2x2 mesh and the
    sharded state's checkpoint round trip, (b) two steps of a
    ``shard_ensemble`` fleet of two on the 2x2 mesh. Writes
    ``rank<r>.pt``: launch counts, seconds, the TF32 flags as read after
    its first entry points, digests of the states (rank 0
    also the state and metrics of (a); the ranks at batch coordinate 0
    their member of (b))."""
    from deepipr_tpu_torch.ops.fused_augment import fused_augment
    from deepipr_tpu_torch.ops.passport_epilogue import passport_epilogue
    from deepipr_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from deepipr_tpu_torch.parallel.mesh import (
        axis_index,
        flat_state,
        make_mesh,
        shard_model_parallel,
    )
    from deepipr_tpu_torch.train.ensemble import (
        make_ensemble_train_step,
        member_indices,
        shard_ensemble,
        stack_states,
    )
    from deepipr_tpu_torch.train.epoch import (
        device_resident,
        make_epoch_train_fn,
    )
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.train.steps import (
        make_dual_eval_step,
        make_signature_fn,
        make_train_step,
        run_dual_eval,
    )
    from deepipr_tpu_torch.utils.checkpoint import (
        load_state_multihost,
        save_state_multihost,
        snapshot,
    )

    torch.cuda.set_device(0)
    store = os.path.abspath(os.path.join(directory, "store"))
    maybe_initialize_distributed(f"file://{store}", PARALLEL_RANKS, rank,
                                 backend="gloo")
    inputs = torch.load(os.path.join(directory, "inputs.pt"),
                        weights_only=True)
    seed = inputs["seed"]
    out = {"seconds": {}}

    def model_from(state):
        model = train_model(seed, "cuda")
        model.load_state_dict(state)
        return model

    # (a) the mesh epoch on a 4x1 mesh, V2 and V3 each from the same
    # weights, then every rank's evaluation
    t = time.perf_counter()
    dp = make_mesh()
    draws = [tuple(d.cuda() for d in step) for step in inputs["draws"]]
    images, labels = device_resident(inputs["images"], inputs["labels"],
                                     "cuda")
    wm = device_resident(inputs["wm_images"], inputs["wm_labels"], "cuda")
    half = PARALLEL_SET // 2
    perm = inputs["perm"].cuda()
    fused_augment.launches = passport_epilogue.launches = 0
    fused_augment.form_launches = dict.fromkeys(fused_augment.form_launches,
                                                0)
    passport_epilogue.form_launches = dict.fromkeys(
        passport_epilogue.form_launches, 0)
    out["state_a"], out["metrics_a"], out["digest_a"] = {}, {}, {}
    for kind, offset in (("v2", 0), ("v3", half // TRAIN_BATCH)):
        model = model_from(inputs["state"])
        fn = make_epoch_train_fn(
            model, True, TRAIN_BATCH, TRAIN_PAD, wm_batch=2, device="cuda",
            draws=lambda s, n, o=offset: draws[o + s], mesh=dp)
        state = TrainState.create(model, TRAIN_LR)
        if kind == "v2":
            state, metrics = fn(state, images, labels, 0, perm=perm[:half])
        else:
            state, metrics = fn(state, images, labels, 0, *wm,
                                perm=perm[half:],
                                wm_perm=inputs["wm_perm"].cuda())
        out["digest_a"][kind] = _digest(flat_state(state))
        if kind == "v2":  # this process sets no flag: the entry points do
            out["tf32"] = tf32_flags()
        if rank == 0:
            out["state_a"][kind] = {k: v.cpu() for k, v in
                                    model.state_dict().items()}
            out["metrics_a"][kind] = {k: v.item()
                                      for k, v in metrics.items()}
    valid = run_dual_eval(make_dual_eval_step(model, device="cuda"),
                          [inputs["valid"]])
    rows = make_signature_fn(model, (1, 32, 32, 3), True, device="cuda")()
    out["launches"] = {
        "fused_augment": fused_augment.form_launches[torch.float32],
        "passport_epilogue": passport_epilogue.form_launches[torch.float32]}
    out["valid_a"], out["rows_a"] = valid, rows
    torch.cuda.synchronize()
    out["seconds"]["a"] = time.perf_counter() - t

    # (d) the model axis on a 2x2 mesh, cuDNN deterministic: the two steps
    # are the same arithmetic, so the card's must agree bit for bit
    t = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tp = make_mesh(model_axis=2)
    batch = inputs["fleet"][0]
    whole = {}
    for kind in ("replicated", "sharded"):
        model = model_from(inputs["state"])
        state = TrainState.create(model, TRAIN_LR)
        if kind == "sharded":
            shard_model_parallel(state, tp)
            out["d_sharded"] = len(state.model_sharded)
        step = make_train_step(model, True, device="cuda", mesh=tp)
        state, metrics = step(state, batch)
        snap = snapshot(state)
        whole[kind] = torch.cat([v.reshape(-1).float() for v in
                                 snap["model"].values()])
        out[f"d_loss_{kind}"] = metrics["loss"].item()
    out["d_max_abs"] = (whole["sharded"] - whole["replicated"]).abs().max(
        ).item()
    path = os.path.join(directory, "tp.ckpt")
    save_state_multihost(path, state)
    back = load_state_multihost(path, TrainState.create(
        model_from(inputs["state"]), TRAIN_LR), mesh=dp)
    out["d_round_trip"] = torch.equal(
        torch.cat([v.reshape(-1).float().cpu() for v in
                   back.model.state_dict().values()]), whole["sharded"])
    torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    out["seconds"]["d"] = time.perf_counter() - t

    # (b) a fleet of two over 'model', each member over 'batch'
    t = time.perf_counter()
    fleet = stack_states([TrainState.create(model_from(s), TRAIN_LR)
                          for s in inputs["members"]])
    local = shard_ensemble(fleet, tp)
    step = make_ensemble_train_step(local, True, device="cuda", mesh=tp)
    metrics = []
    for batch in inputs["fleet"]:
        local, m = step(local, batch)
        metrics.append({k: v.tolist() for k, v in m.items()})
    out["b_members"] = member_indices(len(fleet), tp)
    out["b_digest"] = [_digest(flat_state(s)) for s in local]
    if axis_index(tp, "batch") == 0:
        out["b_states"] = [{k: v.cpu() for k, v in
                            s.model.state_dict().items()} for s in local]
        out["b_metrics"] = metrics
    torch.cuda.synchronize()
    out["seconds"]["b"] = time.perf_counter() - t

    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _launch_ranks(directory: str) -> list:
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r),
         "--parallel-dir", directory], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(PARALLEL_RANKS)]


def _wait(procs: list, timeout: float, label: str) -> list:
    """Every process's output; all are killed once ``timeout`` seconds
    have passed, and a failed one fails the phase."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{label} process {i} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
    return outs


def _model_with(state: dict, seed: int):
    model = train_model(seed, "cpu")
    model.load_state_dict(state)
    return model


def parallel_reference(inputs: dict) -> dict:
    """One process on the card stepping (a)'s global batches with the same
    draws, and each fleet member alone on (b)'s."""
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.train.steps import make_train_step

    seed = inputs["seed"]
    draws = [tuple(d.cuda() for d in step) for step in inputs["draws"]]
    images = inputs["images"].cuda().contiguous()
    labels = inputs["labels"].cuda().long()
    wm = (inputs["wm_images"].cuda().contiguous(),
          inputs["wm_labels"].cuda().long())
    rows = inputs["perm"].cuda().view(-1, TRAIN_BATCH)
    take = -(-2 // PARALLEL_RANKS) * PARALLEL_RANKS
    half = rows.shape[0] // 2
    models, metrics = {}, {}
    for kind, offset in (("v2", 0), ("v3", half)):
        model = train_model(seed, "cuda")
        model.load_state_dict(inputs["state"])
        state = TrainState.create(model, TRAIN_LR)
        step = make_train_step(model, True, pad=TRAIN_PAD, device="cuda",
                               draws=lambda s, n, o=offset: draws[o + s])
        seen = []
        for t in range(half):
            r = rows[offset + t]
            if kind == "v2":
                batch = {"image": images, "index": r.to(torch.int32),
                         "label": labels[r]}
            else:
                batch = _v3_batch(inputs, images, labels, wm, t, r, take,
                                  "cuda")
            state, m = step(state, batch)
            seen.append(m)
        models[kind] = model
        metrics[kind] = {n: torch.stack([m[n] for m in seen]).mean().item()
                         for n in seen[0]}
    members = []
    for i, s in enumerate(inputs["members"]):
        member = train_model(seed, "cuda")
        member.load_state_dict(s)
        mstate = TrainState.create(member, TRAIN_LR)
        mstep = make_train_step(member, True, device="cuda")
        ms = []
        for batch in inputs["fleet"]:
            mstate, m = mstep(mstate, batch)
            ms.append({k: v.item() for k, v in m.items()})
        members.append((member, ms))
    return {"models": models, "metrics": metrics, "members": members}


TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1"]


def deterministic_train_v23(argv: list) -> None:
    """``cli.train_v23``'s ``main`` on ``argv`` with cuDNN's deterministic
    algorithms (``--deterministic-train-v23``, (c)'s two runs): in IEEE f32
    cuDNN's default choice sums some gradients in an order that varies
    between runs, so two runs of the same arithmetic agree bit for bit only
    with it, as (d) holds its two steps."""
    from deepipr_tpu_torch.cli import train_v23

    torch.backends.cudnn.deterministic = True
    train_v23.main(argv)


def start_parallel_cli() -> dict:
    """(c), started beside the ranks: ``cli.train_v23 --multihost`` under
    torchrun with one NCCL rank for PARALLEL_CLI_EPOCHS epochs, and the same
    command without --multihost, each with cuDNN deterministic
    (``deterministic_train_v23``). Returns {name: (process, logdir,
    start)}."""
    import shutil

    runs = {}
    script = [os.path.abspath(__file__), "--deterministic-train-v23"]
    for name, cmd in (("multihost", TORCHRUN + script + [
            *PARALLEL_CLI, "--multihost"]), ("plain", [
            sys.executable, *script, *PARALLEL_CLI])):
        logdir = os.path.join(PARALLEL_DIR, f"cli_{name}")
        shutil.rmtree(logdir, ignore_errors=True)
        runs[name] = (subprocess.Popen(
            cmd + ["--logdir", logdir], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), logdir, time.perf_counter())
    return runs


def finish_parallel_cli(runs: dict, smi: str) -> None:
    """(c): the two runs of ``start_parallel_cli`` bit for bit (every
    history.csv column but the clock's, and last.ckpt); then, under torchrun
    again, ``--resume`` of that last.ckpt through ``load_state_multihost``
    for one epoch, and the checkpoint through ``load_state_multihost`` and
    a ``save_state_dcp`` / ``load_state_dcp`` round trip bit for bit
    (``--resume-check``)."""
    run = {}
    for name, (proc, logdir, t) in runs.items():
        _wait([proc], PARALLEL_TIMEOUT, f"train_v23 ({name})")
        log(f"parallel_path (c) train_v23 {name}, {PARALLEL_CLI_EPOCHS} "
            f"epochs beside the ranks: {time.perf_counter() - t:.1f} s "
            f"[{smi}]")
        run[name] = os.path.join(logdir, "resnet_synthetic_v2", "1")
    got, want = (history(run[k]) for k in ("multihost", "plain"))
    if len(got) != PARALLEL_CLI_EPOCHS or [sorted(r) for r in got] != [
            sorted(r) for r in want]:
        raise AssertionError(f"--multihost history {got} vs {want}")
    differ = [(i, k) for i, (g, w) in enumerate(zip(got, want))
              for k in w if k not in ("train_time", "train_images_per_sec")
              and g[k] != w[k]]
    a, b = (torch.load(os.path.join(run[k], "models", "last.ckpt"),
                       weights_only=True) for k in ("multihost", "plain"))
    differ += [k for k in b["model"] if not torch.equal(a["model"][k],
                                                        b["model"][k])]
    differ += [i for i, st in b["optimizer"]["state"].items()
               if not torch.equal(a["optimizer"]["state"][i]
                                  ["momentum_buffer"], st["momentum_buffer"])]
    if a["step"] != b["step"]:
        differ.append("step")
    if differ:
        raise AssertionError(f"--multihost with one rank changed "
                             f"{differ[:8]}")
    log(f"parallel_path (c): --multihost on one NCCL rank equals the run "
        f"without it bit for bit: {len(want[0]) - 2} history columns x "
        f"{len(want)} epochs (train_time and train_images_per_sec aside), "
        f"last.ckpt's {len(b['model'])} entries, momentum and step "
        f"{b['step']}")

    t = time.perf_counter()
    out = _wait([subprocess.Popen(
        TORCHRUN + [os.path.abspath(__file__), "--resume-check",
                    os.path.join(run["multihost"], "models", "last.ckpt"),
                    "--parallel-dir", os.path.join(PARALLEL_DIR,
                                                   "cli_resumed")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)], PARALLEL_TIMEOUT, "torchrun --resume-check")[0]
    for line in out.splitlines():
        if line.startswith("resume-check"):
            log(f"parallel_path (c) {line}")
    if "resume-check ok" not in out:
        raise AssertionError(f"--resume-check:\n{out[-6000:]}")
    log(f"parallel_path (c) resume and dcp: {time.perf_counter() - t:.1f} s")


def resume_check(ckpt: str, logdir: str) -> None:
    """Under torchrun (``--resume-check``): ``cli.train_v23 --multihost
    --resume`` of ``ckpt`` for one epoch; ``ckpt`` through
    ``load_state_multihost`` into a fresh state, then a
    ``save_state_dcp``/``load_state_dcp`` round trip, each bit for bit with
    the file."""
    import torch.distributed as dist

    from deepipr_tpu_torch.cli import train_v23
    from deepipr_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
        rank_device,
    )
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.utils.checkpoint import (
        load_state_dcp,
        load_state_multihost,
        save_state_dcp,
        snapshot,
    )

    if not maybe_initialize_distributed():
        raise AssertionError("no torchrun variables")
    try:
        exp = train_v23.main([*PARALLEL_CLI, "--multihost", "--epochs", "1",
                              "--resume", ckpt, "--logdir", logdir])
        rows = history(exp.logdir)
        want = torch.load(ckpt, weights_only=True)
        steps = want["step"] + len(rows) * PARALLEL_CLI_IMAGES // TRAIN_BATCH
        if (len(rows) != 1 or exp.state.step != steps
                or not all(np.isfinite(v) for v in rows[0].values())):
            raise AssertionError(f"resumed run: step {exp.state.step}, "
                                 f"expected {steps}; rows {rows}")
        print(f"resume-check: --resume from step {want['step']} ran to step "
              f"{exp.state.step} on {dist.get_backend()} rank "
              f"{dist.get_rank()} of {dist.get_world_size()}", flush=True)

        def fresh():
            return TrainState.create(train_model(0, rank_device()), TRAIN_LR)

        def equal(snap):
            return (snap["step"] == want["step"]
                    and all(torch.equal(snap["model"][k], v)
                            for k, v in want["model"].items())
                    and all(torch.equal(snap["optimizer"]["state"][i]
                                        ["momentum_buffer"],
                                        st["momentum_buffer"])
                            for i, st in want["optimizer"]["state"].items()))

        loaded = load_state_multihost(ckpt, fresh())
        if not equal(snapshot(loaded)):
            raise AssertionError("load_state_multihost changed the state")
        directory = os.path.join(logdir, "dcp")
        save_state_dcp(directory, loaded)
        if not equal(snapshot(load_state_dcp(directory, fresh()))):
            raise AssertionError("the dcp round trip changed the state")
        print(f"resume-check: load_state_multihost and the dcp round trip "
              f"bit for bit ({len(want['model'])} entries, momentum, step "
              f"{want['step']})", flush=True)
    finally:
        dist.destroy_process_group()
    print("resume-check ok", flush=True)


def parallel_path(seed: int, smi: str) -> dict:
    """The port's multi-process training on the one card (module docstring,
    phase 19). Returns the launch counts of (a) summed over the ranks: K1
    in every step of every rank, K2 in every rank's evaluation."""
    import shutil

    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    os.makedirs(PARALLEL_DIR)
    inputs = parallel_inputs(seed)
    torch.save(inputs, os.path.join(PARALLEL_DIR, "inputs.pt"))
    t = time.perf_counter()
    procs = _launch_ranks(PARALLEL_DIR)
    runs = {}
    try:
        runs = start_parallel_cli()
        ref = parallel_reference(inputs)
        _wait(procs, PARALLEL_TIMEOUT, "parallel rank")
        counts = parallel_checks(inputs, ref, seed, smi, t)
        finish_parallel_cli(runs, smi)
    finally:
        _kill(procs + [p for p, _, _ in runs.values()])
    return counts


def _kill(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def parallel_checks(inputs: dict, ref: dict, seed: int, smi: str,
                    t: float) -> dict:
    """(a), (d) and (b) from the ranks' results; returns (a)'s launch
    counts summed over the ranks."""
    log(f"parallel_path: {PARALLEL_RANKS} gloo ranks on cuda:0 and the "
        f"one-process reference: {time.perf_counter() - t:.1f} s [{smi}]")
    ranks = [torch.load(os.path.join(PARALLEL_DIR, f"rank{r}.pt"),
                        weights_only=True) for r in range(PARALLEL_RANKS)]
    for r, out in enumerate(ranks):
        log(f"parallel_path rank {r}: seconds "
            f"{json.dumps({k: round(v, 3) for k, v in out['seconds'].items()})}"
            f", launches {out['launches']}, after its first entry points "
            f"{out['tf32']}")
        if any(out["tf32"].values()):
            raise AssertionError(f"rank {r} ran with TF32 on: {out['tf32']}")

    # (a) the ranks against one process, and against each other
    start = {k: v.clone() for k, v in
             _model_with(inputs["state"], seed).named_parameters()}
    for kind in ("v2", "v3"):
        compare_training(
            f"parallel_path (a) {kind}: {PARALLEL_RANKS} ranks x "
            f"{TRAIN_BATCH // PARALLEL_RANKS} rows"
            + (f" (and the trigger pair padded to {PARALLEL_RANKS} at weight "
               "0)" if kind == "v3" else "") + ", 2 steps",
            ref["models"][kind].cpu(),
            _model_with(ranks[0]["state_a"][kind], seed), start,
            ref["metrics"][kind], ranks[0]["metrics_a"][kind],
            what="ranks vs one process")
        digests = {out["digest_a"][kind] for out in ranks}
        if len(digests) != 1:
            raise AssertionError(f"(a) {kind}: the ranks' states differ: "
                                 f"{digests}")
    if any(out["valid_a"] != ranks[0]["valid_a"]
           or out["rows_a"] != ranks[0]["rows_a"] for out in ranks):
        raise AssertionError("(a): the ranks' evaluations differ")
    steps = PARALLEL_SET // TRAIN_BATCH
    for r, out in enumerate(ranks):
        k1, k2 = (out["launches"][k] for k in ("fused_augment",
                                                "passport_epilogue"))
        if k1 != steps or k2 != 2 * RESNET_K2:
            raise AssertionError(f"rank {r}: K1 {k1} launches in {steps} "
                                 f"steps, K2 {k2} in its evaluation")
    log(f"parallel_path (a): the {PARALLEL_RANKS} ranks' parameters, BN "
        f"statistics, passports and momentum bit for bit; on each rank K1 "
        f"once in each of its {steps} steps, K2 {2 * RESNET_K2} times in its "
        f"evaluation (the dual eval and the signature rows); valid "
        f"{ranks[0]['valid_a']}")

    # (d) the model axis, on the card over gloo (the gather broadcasts)
    for r, out in enumerate(ranks):
        if (out["d_max_abs"] != 0.0 or not out["d_round_trip"]
                or out["d_loss_sharded"] != out["d_loss_replicated"]
                or out["d_sharded"] < 5):
            raise AssertionError(f"rank {r} (d): " + json.dumps(
                {k: v for k, v in out.items() if k.startswith("d_")}))
    log(f"parallel_path (d): the model axis runs on the card over gloo; "
        f"{ranks[0]['d_sharded']} tensors sharded 2 ways on a 2x2 mesh, one "
        f"step equal to the replicated step bit for bit (loss "
        f"{ranks[0]['d_loss_sharded']}), its save_state_multihost / "
        f"load_state_multihost round trip bit for bit")

    # (b) each member of the fleet against itself stepped alone
    for a, b in ((0, 2), (1, 3)):  # the ranks of one member's batch group
        if (ranks[a]["b_members"] != ranks[b]["b_members"]
                or ranks[a]["b_digest"] != ranks[b]["b_digest"]):
            raise AssertionError(f"(b): ranks {a} and {b} differ")
    for r in (0, 1):
        for j, i in enumerate(ranks[r]["b_members"]):
            member, ms = ref["members"][i]
            start = {k: v.clone() for k, v in _model_with(
                inputs["members"][i], seed).named_parameters()}
            last = {k: v[j] for k, v in ranks[r]["b_metrics"][-1].items()}
            compare_training(
                f"parallel_path (b): fleet member {i} over a 2-way batch "
                f"axis, 2 steps", member.cpu(),
                _model_with(ranks[r]["b_states"][j], seed), start, ms[-1],
                last, what="ranks vs the member alone")
    log(f"parallel_path (b): {PARALLEL_MEMBERS} members over 'model', each "
        "over 'batch', against each member stepped alone")

    counts = dict.fromkeys(("passport_epilogue", "passport_epilogue_bf16",
                            "passport_epilogue_backward", "fused_augment",
                            "fused_augment_bf16"), 0)
    for out in ranks:
        for k, v in out["launches"].items():
            counts[k] += v
    return counts


def shape_key(shape, relu: bool = True) -> str:
    return "x".join(map(str, shape)) + ("" if relu else " relu off")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    # the processes the parallel phase starts, and a run of that phase alone
    parser.add_argument("--parallel-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--parallel-dir", help=argparse.SUPPRESS)
    parser.add_argument("--resume-check", help=argparse.SUPPRESS)
    parser.add_argument("--deterministic-train-v23", nargs=argparse.REMAINDER,
                        help=argparse.SUPPRESS)
    parser.add_argument("--parallel-only", action="store_true",
                        help="the environment, the build and phase 19 only "
                             "(prints no result)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.parallel_rank is not None:
        parallel_rank(args.parallel_rank, args.parallel_dir)
        return 0
    if args.resume_check is not None:
        resume_check(args.resume_check, args.parallel_dir)
        return 0
    if args.deterministic_train_v23 is not None:
        deterministic_train_v23(args.deterministic_train_v23)
        return 0
    if args.parallel_only:
        smi = environment()
        with phase("build"):
            build_kernels()
        with phase("parallel_path"):
            log(f"parallel_path launches: {parallel_path(args.seed, smi)}")
        return 0

    from deepipr_tpu_torch.ops.fused_augment import fused_augment
    from deepipr_tpu_torch.ops.passport_epilogue import (
        passport_epilogue,
        passport_epilogue_backward,
    )

    started = time.perf_counter()
    smi = environment()
    with phase("build"):
        build_kernels()

    gen = torch.Generator().manual_seed(args.seed)
    with phase("kernel checks"):
        max_err = {"passport_epilogue": check_epilogue(gen),
                   "passport_epilogue_bf16": check_epilogue(gen, BF16),
                   "passport_epilogue_backward": check_backward(gen)}
        cases = augment_cases(args.seed)
        max_err["fused_augment"] = check_augment(cases)
        max_err["fused_augment_bf16"] = check_augment(cases, BF16)
    with phase("kernel times"):
        timer = DeviceTimer()
        floor_ms = timer.floor_ms()
        log(f"event timer floor (one-element zero_, L2 flushed): {floor_ms} "
            f"ms [{smi}]")
        # timing[form]: the main shape's; by_shape[form]: every timed shape
        timing, by_shape = {}, {}
        for form, dtype in (("passport_epilogue", torch.float32),
                            ("passport_epilogue_bf16", BF16)):
            for shape, relu in ((MAIN_SHAPE, True), ((1024, 512, 4, 4), True),
                                *((s, True) for s in ALEXNET_TIMED),
                                (IMAGENET_K2, True), *RESNET50_TIMED):
                t = time_epilogue(gen, timer, shape, smi, dtype, relu)
                log(f"{form} {shape} relu={relu}: {json.dumps(t)} [{smi}]")
                by_shape.setdefault(form, {})[shape_key(shape, relu)] = t
                if shape == MAIN_SHAPE:
                    timing[form] = t
        for shape, relu in (((ATTACK_BATCH, 512, 4, 4), True),
                            (MAIN_SHAPE, True),
                            *((s, True) for s in ALEXNET_BWD_TIMED),
                            *RESNET50_BWD_TIMED):
            t = time_backward(gen, timer, shape, smi, relu)
            log(f"passport_epilogue_backward {shape} relu={relu}: "
                f"{json.dumps(t)} [{smi}]")
            by_shape.setdefault("passport_epilogue_backward",
                                {})[shape_key(shape, relu)] = t
            if shape == (ATTACK_BATCH, 512, 4, 4):
                timing["passport_epilogue_backward"] = t
        for form, dtype in (("fused_augment", torch.float32),
                            ("fused_augment_bf16", BF16)):
            for case in (cases[0], cases[IMAGENET_AUGMENT]):
                t = time_augment(timer, case, smi, dtype)
                log(f"{form} {case[0]}: {json.dumps(t)} [{smi}]")
                _, h, w, c = case[1].shape
                by_shape.setdefault(form, {})[shape_key(
                    (case[2].shape[0], c, h, w))] = t
                if case is cases[0]:
                    timing[form] = t
        del cases, timer
    with phase("host_augment"):
        host = host_augment(args.seed, smi)
    with phase("precision"):
        precision(args.seed, smi)

    wrappers = {"passport_epilogue": passport_epilogue,
                "fused_augment": fused_augment}

    def launches():
        """Launches of each kernel form, named as in the kernels line."""
        counts = {}
        for name, fn in wrappers.items():
            counts[name] = fn.form_launches[torch.float32]
            counts[f"{name}_bf16"] = fn.form_launches[BF16]
        counts["passport_epilogue_backward"] = \
            passport_epilogue_backward.launches
        return counts

    def reset():
        for fn in wrappers.values():
            fn.launches = 0
            fn.form_launches = dict.fromkeys(fn.form_launches, 0)
        passport_epilogue_backward.launches = 0

    # paths[name][form]: launches of each form over one main path's run,
    # the counts set to 0 just before it and read just after
    paths = {}
    with phase("resnet serve"):
        paths.update(resnet_serve(args.seed, smi, launches, reset))

    with phase("resnet train"):
        paths.update(resnet_train(args.seed, smi, launches, reset))
    with phase("norms"):
        norm_types_check(args.seed, smi)

    with phase("resnet cli"):
        paths["resnet_cli"], best, v3_best = cli_path(smi, launches, reset)
    with phase("resnet attacks"):
        paths["resnet_attacks"] = attack_path(best, smi, launches, reset)
        ambiguity_checks(attack_argv(best), launches, reset)

    with phase("alexnet_serve"):
        paths["alexnet_serve"] = alexnet_serve(args.seed, smi, launches,
                                               reset)
    with phase("alexnet_cli"):
        counts, alexnet_best = alexnet_cli(smi, launches, reset)
        paths["alexnet_cli_v1"], paths["alexnet_cli_v2"] = counts[1], \
            counts[2]
    with phase("alexnet_attacks"):
        paths["alexnet_attacks"] = alexnet_attacks(alexnet_best, smi,
                                                   launches, reset)
    with phase("data"):
        paths.update(data_path(best, smi, launches, reset))
    with phase("parallel_path"):
        paths["parallel_path"] = parallel_path(args.seed, smi)
        if not all(paths["parallel_path"][k] for k in ("fused_augment",
                                                       "passport_epilogue")):
            raise AssertionError(f"parallel_path launches "
                                 f"{paths['parallel_path']}")
    # every kernel form on the AlexNet paths: K1 in training, K2 in both
    # forms in serving (8x8 and 13x13), K2-bwd in the attacks
    alexnet = {form: sum(c.get(form, 0) for name, c in paths.items()
                         if name.startswith("alexnet"))
               for form in ("fused_augment", "passport_epilogue",
                            "passport_epilogue_bf16",
                            "passport_epilogue_backward")}
    if not all(alexnet.values()):
        raise AssertionError(f"a kernel form was not launched on the AlexNet "
                             f"paths: {alexnet}")

    with phase("transfer"):
        paths["transfer"] = transfer_path({
            "ResNet18Private V2": ("resnet", 2, best),
            "ResNet18Private V3": ("resnet", 3, v3_best),
            "AlexNet V1": ("alexnet", 1, alexnet_best[1])},
            smi, launches, reset)
    with phase("fold"):
        paths["fold"] = fold_path(args.seed, smi, launches, reset)
    with phase("interop"):
        paths["interop"] = interop_path(best, args.seed, smi, launches,
                                        reset)
    with phase("deploy"):
        paths["deploy"] = deploy_path(
            os.path.join(CLI_LOGDIR, "resnet_synthetic_v0", "1", "models",
                         "last.ckpt"), alexnet_best[1], smi, launches, reset)

    with phase("resnet50_serve"):
        paths.update(resnet_serve(args.seed, smi, launches, reset,
                                  "resnet50"))
    with phase("resnet50_train"):
        paths.update(resnet_train(args.seed, smi, launches, reset,
                                  "resnet50"))
    with phase("resnet50_cli"):
        paths["resnet50_cli"], r50_best = resnet50_cli(smi, launches, reset)
        paths["resnet50_attack_steps"] = resnet50_attack_steps(
            r50_best, launches, reset)
    with phase("resnet50_fold_interop"):
        paths["resnet50_fold"] = fold_path(args.seed, smi, launches, reset,
                                           archs=("resnet50",), timed=False)
        paths["resnet50_interop"] = interop_path(
            r50_best, args.seed, smi, launches, reset, arch="resnet50")
    # K2 f32 on the TL retests; both K2 forms behind the fold checks and in
    # the ImageNet ResNet forwards; K2-bwd in the ResNet-50 attack steps
    both = ("passport_epilogue", "passport_epilogue_bf16")
    for name, forms in (("transfer", ("passport_epilogue",)),
                        ("deploy", ("passport_epilogue",)),
                        ("fold", both), ("interop", both),
                        ("resnet50_fold", both), ("resnet50_interop", both),
                        ("resnet50_attack_steps",
                         ("passport_epilogue",
                          "passport_epilogue_backward"))):
        if not all(paths[name].get(form) for form in forms):
            raise AssertionError(f"{forms} not all launched on the {name} "
                                 f"path: {paths[name]}")
    resnet50 = {form: sum(c.get(form, 0) for name, c in paths.items()
                          if name.startswith("resnet50"))
                for form in ("fused_augment", "fused_augment_bf16",
                             "passport_epilogue", "passport_epilogue_bf16",
                             "passport_epilogue_backward")}
    if not all(resnet50.values()):
        raise AssertionError(f"a kernel form was not launched on the "
                             f"ResNet-50 paths: {resnet50}")
    log(f"launches by path: {json.dumps(paths)}")

    # K2-bwd is the gradient of K2. It replaces no Pallas kernel: the JAX
    # package differentiates the XLA epilogue that its default mode "off"
    # (pallas_fused.py:121, 142-149) selects
    sources = {
        "passport_epilogue": "deepipr_tpu/ops/pallas_fused.py:52",
        "passport_epilogue_backward": "deepipr_tpu/models/layers.py:177",
        "fused_augment": "deepipr_tpu/ops/pallas_augment.py:64",
    }
    timed_shape = {"passport_epilogue": MAIN_SHAPE,
                   "passport_epilogue_backward": (ATTACK_BATCH, 512, 4, 4),
                   "fused_augment": (TRAIN_BATCH, 3, 32, 32)}
    kernels = []
    for form in ("passport_epilogue", "passport_epilogue_bf16",
                 "passport_epilogue_backward", "fused_augment",
                 "fused_augment_bf16"):
        base = form.removesuffix("_bf16")
        by_path = {name: c[form] for name, c in paths.items() if c.get(form)}
        if not by_path:
            raise AssertionError(f"{form} was launched on no main path")
        entry = {
            "name": form,
            "route": "cuda",
            "source": "deepipr_tpu_torch/csrc/"
                      f"{base.removesuffix('_backward')}.cu",
            "replaces": sources[base],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max_err[form],
            "floor_ms": floor_ms,
            "shape": shape_key(timed_shape[base]),
            **timing[form],
        }
        if form in by_shape:
            entry["by_shape"] = by_shape[form]
        kernels.append(entry)
    host_kernels = host_calls_report(host)
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(json.dumps({"host_kernels": host_kernels}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
