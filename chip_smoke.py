#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepipr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on a failed check (so the exit code is not 0):

1. Environment: the card, its power limit, the float32 settings.
2. Build: every CUDA kernel of ``deepipr_tpu_torch/csrc`` with nvcc (sm_90a)
   into ``build/deepipr_tpu_torch/``, with ptxas's registers, spills and
   shared memory; each kernel's PTX read for 64-bit integer division (which
   fails the run) and, where the toolkit has cuobjdump, its SASS size.
3. Kernels: each kernel's f32 and bf16 forms against their plain PyTorch
   versions on the card, at the main paths' shapes, the JAX package's test
   shapes and ragged ones (its vector and scalar paths), K2 and its
   gradient K2-bwd twice for bit-identical results; then timed beside the
   plain version, a library yardstick where one exists, the memory bound,
   the event timer's own floor and the CUPTI duration.
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
   pruning and flip CLIs (11 levels), attack 1 (8 reps), attack 2, attack 3
   host-fed and ``--epoch-scan``, and the forge attack, with launch counts
   (K2 f32, K2-bwd, K1 f32; no bf16 form) and each attack's wall time; K2
   and K2-bwd launches per ambiguity step; the CE and sign-loss gradient on
   every fake passport; one ambiguity step and one forge step on the card
   against the CPU. CSVs under ``logs/``.
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

Each phase's wall time is printed on a line of its own.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits with
an error before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
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
                (4, 128, 8, 8), (2, 256, 16, 16), (2, 64, 56, 56),
                (2, 128, 28, 28), (8, 512, 7, 7), (3, 40, 5, 3),
                # AlexNet: features_4 (384 channels) and _5/_6 (256) at 8x8
                # (CIFAR) at the request batch and batch 1, and at 13x13
                # (ImageNet, 224 px: the scalar path, tiles of 3 channels,
                # a ragged last tile at 256)
                (256, 384, 8, 8), (256, 256, 8, 8), (1, 384, 8, 8),
                (1, 256, 8, 8), (64, 384, 13, 13), (64, 256, 13, 13)]
# K2 and K2-bwd timed at AlexNet's shapes besides the main ones
ALEXNET_TIMED = [(256, 384, 8, 8), (256, 256, 8, 8), (64, 384, 13, 13)]
ALEXNET_BWD_TIMED = [(64, 384, 8, 8), (64, 256, 8, 8)]
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
              (64, 384, 8, 8), (64, 256, 8, 8), (1, 384, 8, 8)]
BWD_SUM_TOL = dict(rtol=1e-4, atol=1e-4)
# K1 normalized against its plain version: tests/test_pallas_augment.py's
# tolerance (1 ulp); the pixels before normalizing must agree bit for bit
AUGMENT_TOL = dict(rtol=0.0, atol=3e-7)
# the training slice (bench.py:47, 57-71): 50 steps per epoch
TRAIN_IMAGES, TRAIN_BATCH, TRAIN_PAD, TRAIN_LR = 12800, 256, 4, 0.01
# K1's cases: (label, set shape, batch, pad). The training batch first (the
# one timed), batch 1 and 13, the tests' 16x16, and a 15x15x3 set whose
# H*W*C (675) is not a multiple of 16 and whose W is not one of 4
AUGMENT_SHAPES = [
    ("B=256 32x32 pad 4", (TRAIN_IMAGES, 32, 32, 3), TRAIN_BATCH, 4),
    ("B=1 32x32 pad 4", (TRAIN_IMAGES, 32, 32, 3), 1, 4),
    ("B=13 32x32 pad 4", (TRAIN_IMAGES, 32, 32, 3), 13, 4),
    ("B=16 16x16 pad 2", (64, 16, 16, 3), 16, 2),
    ("B=1 15x15 pad 2", (64, 15, 15, 3), 1, 2),
    ("B=13 15x15 pad 2", (64, 15, 15, 3), 13, 2),
]
TIMED_EPOCHS = 3
PROFILER_ATTEMPTS = 3  # traces taken before a lost kernel record fails
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
CLI_LOGDIR = os.path.join("build", "chip_smoke_logs")
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


def log(*parts):
    print(*parts, flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Log the wall time of the phase run inside, on a line of its own."""
    t = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t:.1f} s wall")


# ----------------------------------------------------------- environment

def environment() -> str:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; count "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
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
                worst = max(worst, (g.float() - w.float()).abs().max().item())
            if dtype != torch.float32:
                f32 = passport_epilogue(args[0].float().contiguous(),
                                        *args[1:], relu=relu)
                if not all(torch.equal(g, f) for g, f in zip(got[1:],
                                                             f32[1:])):
                    raise AssertionError(f"passport_epilogue {label}: the "
                                         "bf16 form's scale/bias differ "
                                         "from the f32 form's")
        log(f"passport_epilogue {label} {dtype}: agrees with the plain "
            "version (relu on and off), bit-identical over two calls")
    return worst


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def time_epilogue(gen, timer: DeviceTimer, shape, smi: str,
                  dtype=torch.float32) -> dict:
    from deepipr_tpu_torch.ops.passport_epilogue import (
        passport_epilogue,
        passport_epilogue_reference,
    )

    y, key_out, skey_out, mean, var = args = epilogue_inputs(shape, gen,
                                                             dtype)
    _, scale, bias = passport_epilogue_reference(*args)

    def library():
        # the nearest single library call, with scale/bias precomputed
        F.batch_norm(y, mean, var, scale, bias, False, 0.0, 1e-5).relu_()

    n, c, h, w = shape
    # y read and out written in their dtype; the passport outputs, the
    # statistics and scale/bias in f32
    nbytes = (y.element_size() * 2 * n * c * h * w
              + 4 * (2 * c * h * w + 4 * c))
    flops = 5 * n * c * h * w + 2 * c * h * w
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / F32_FLOPS_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)
    copy = torch.empty_like(y)
    memory_diagnostics(timer, lambda: passport_epilogue(*args),
                       "passport_epilogue_kernel",
                       lambda: torch.mul(y, 1.0, out=copy), "MulFunctor",
                       f"passport_epilogue {shape} {dtype}", smi)
    return {
        "ms": timer.ms(lambda: passport_epilogue(*args)),
        "profiled_ms": timer.profiled_ms(lambda: passport_epilogue(*args),
                                         "passport_epilogue_kernel"),
        "plain_ms": timer.ms(lambda: passport_epilogue_reference(*args)),
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


def time_backward(gen, timer: DeviceTimer, shape, smi: str) -> dict:
    """K2-bwd beside its plain version and the yardstick: ATen's eval-mode
    batch-norm backward on the same shapes (dx, dweight, dbias; no ReLU
    mask, no passport planes)."""
    from deepipr_tpu_torch.ops.passport_epilogue import (
        passport_epilogue_backward,
        passport_epilogue_backward_reference,
    )

    args, out = backward_inputs(shape, gen)
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
        passport_epilogue_backward(*args)

    copy = torch.empty_like(y)
    memory_diagnostics(timer, kernel, "passport_epilogue_bwd_kernel",
                       lambda: torch.add(g, y, out=copy), "CUDAFunctor_add",
                       f"passport_epilogue_backward {shape}", smi)
    return {
        "ms": timer.ms(kernel),
        "profiled_ms": timer.profiled_ms(kernel,
                                         "passport_epilogue_bwd_kernel"),
        "plain_ms": timer.ms(lambda: passport_epilogue_backward_reference(
            g, y, out, scale, mean, var, g_scale, g_bias)),
        "library_ms": timer.ms(library),
        "bound_ms": bound[bound_by],
        "bound_by": bound_by,
    }


def augment_cases(seed: int):
    """K1's inputs on the card: (label, set, idx, (oy, ox, flip), pad), one
    per AUGMENT_SHAPES entry, then every extreme draw (offsets 0 and 2*pad,
    flip on and off) from the 12,800-image set."""
    from deepipr_tpu_torch.data.device_augment import draw_augment

    rng = np.random.default_rng(seed)
    sets = {}
    for _, shape, _, _ in AUGMENT_SHAPES:
        if shape not in sets:
            sets[shape] = torch.from_numpy(rng.integers(
                0, 256, shape, dtype=np.uint8)).cuda()
    gen = torch.Generator().manual_seed(seed)
    cases = []
    for label, shape, b, pad in AUGMENT_SHAPES:
        idx = torch.randperm(shape[0], generator=gen)[:b].int()
        draws = draw_augment(gen, b, pad)
        cases.append((label, sets[shape], idx.cuda(),
                      tuple(t.cuda() for t in draws), pad))
    extremes = torch.tensor([(oy, ox, f) for oy in (0, 8) for ox in (0, 8)
                             for f in (0, 1)] * 2, dtype=torch.int32)
    idx = torch.randperm(TRAIN_IMAGES, generator=gen)[:len(extremes)].int()
    cases.append(("extreme draws 32x32 pad 4", sets[AUGMENT_SHAPES[0][1]],
                  idx.cuda(),
                  tuple(extremes[:, i].contiguous().cuda() for i in range(3)),
                  4))
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
    """ResNet18Private (or ``arch`` with its passport config, V1 where
    ``private`` is false) on the CPU in compute dtype ``dtype``: weights,
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

    config = (ALEXNET_CONFIG if arch == "alexnet"
              else "passport_configs/resnet18_passport.json")
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
               per_forward: int = 5) -> dict:
    """The serving and verification path on the card, checked against the
    CPU. ``launches()`` reads the kernels' launch counts; ``form`` names the
    K2 form the model's dtype takes, ``per_forward`` its launches in a
    passport forward: the private branch's of a V2 model
    (``private_model``), either branch's of a V1 model. A bf16 model's
    private logits are held to the CPU's norm-wise (BF16_LOGITS_NORM_TOL)
    and its forged per-layer detection rates within BF16_FORGED_TOL of the
    CPU's; an f32 model's elementwise and exactly."""
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
    for batch in batches:
        before = launches()[form]
        logits0 = public.logits(batch["image"])
        between = launches()[form]
        logits1 = private.logits(batch["image"])
        counted = (between - before, launches()[form] - between)
        if counted != (0 if private_model else per_forward, per_forward):
            raise AssertionError(f"{counted} epilogue launches in a public "
                                 "and a private forward, expected "
                                 f"{per_forward} in each passport forward")
        for logits in (logits0, logits1):
            if logits.shape != (REQUEST_BATCH, 10) or \
                    not torch.isfinite(logits).all():
                raise AssertionError("non-finite or misshapen logits")
    cpu_logits = Predictor(cpu_model, ind=1, device="cpu").logits(
        batches[0]["image"])
    gpu_logits = private.logits(batches[0]["image"]).cpu()
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
        f"the CPU run; {per_forward} {form} launches per passport forward")

    if private_model:
        step = make_dual_eval_step(gpu_model)
        metrics = run_dual_eval(step, batches)
        cpu_sums = make_dual_eval_step(cpu_model, device="cpu")(batches[0])
    else:
        step = make_eval_step(gpu_model)
        metrics = run_eval(step, batches)
        cpu_sums = make_eval_step(cpu_model, device="cpu")(batches[0])
    gpu_sums = step(batches[0])
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


def throughput(gpu_model, smi: str, label: str = "f32 (TF32 off)",
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


# ------------------------------------------------------------- training

def train_model(seed: int, device: str, dtype=None):
    """bench.py's model: V2 ResNet18Private, resnet18_passport.json with
    ('bn', 'shuffle', 0.1), weights, passports and signatures from seed, in
    compute dtype ``dtype``."""
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.utils.config import (
        construct_passport_kwargs,
        load_passport_config,
    )

    kw, _ = construct_passport_kwargs(
        load_passport_config("passport_configs/resnet18_passport.json"),
        "bn", "shuffle", 0.1)
    return build_model("resnet18", 10, norm_type="bn", passport_kwargs=kw,
                       private=True, seed=seed, dtype=dtype, device=device)


def train_path(seed: int, smi: str, launches, reset, dtype=torch.float32):
    """bench.py's loop through the port's entry points, in ``dtype`` (K1's
    output and the model's compute dtype): one warm-up and TIMED_EPOCHS
    timed epochs, host-clocked with one read of the epoch's mean metrics at
    its end; img/s from the best timed epoch. Returns the trained model,
    its state, the resident set, the path's launch counts, held-out batches
    of the same synthetic distribution and the img/s."""
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
    model = train_model(seed, "cuda", dtype if bf16 else None)
    xs, ys = device_resident(x, y)
    epoch_fn = make_epoch_train_fn(model, True, TRAIN_BATCH, TRAIN_PAD,
                                   seed=seed, out_dtype=dtype)
    state = TrainState.create(model, TRAIN_LR)
    steps = TRAIN_IMAGES // TRAIN_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset()
    history, seconds = [], []
    for epoch in range(1 + TIMED_EPOCHS):
        t = time.perf_counter()
        state, metrics = epoch_fn(state, xs, ys, epoch_key=1000 * seed + epoch)
        values = torch.stack(list(metrics.values())).tolist()  # one sync
        seconds.append(time.perf_counter() - t)
        history.append(dict(zip(metrics, values)))
        log(f"train epoch {epoch} ({'warm-up' if epoch == 0 else 'timed'}): "
            f"{seconds[-1]:.3f} s, {history[-1]}")
    counts = launches()

    log(f"training-path launches ({dtype}): {counts}")
    epochs = 1 + TIMED_EPOCHS
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
    log(f"throughput: train ResNet18Private V2 batch {TRAIN_BATCH} "
        f"{'bf16' if bf16 else 'f32 (TF32 off)'}, device-resident epoch "
        f"incl. K1: {rate:.1f} img/s (best of {TIMED_EPOCHS} epochs: "
        f"{', '.join(f'{s:.3f}' for s in seconds[1:])} s) [{smi}]")
    log(f"peak device memory, training: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, state, xs, ys, counts, held_out, rate


def train_parity(seed: int, dtype=torch.float32) -> None:
    """Two steps from the same weights, permutation and draws: the card
    through the kernels, the CPU through their plain versions. In bf16 the
    parameters are held norm-wise only (BF16_UPDATE_TOL per parameter,
    BF16_WHOLE_UPDATE_TOL for the whole update), the metrics and BN
    statistics at BF16_TRAIN_TOL."""
    from deepipr_tpu_torch.data.datasets import synthetic_dataset
    from deepipr_tpu_torch.data.device_augment import draw_augment
    from deepipr_tpu_torch.train.epoch import (
        device_resident,
        make_epoch_train_fn,
    )
    from deepipr_tpu_torch.train.state import TrainState

    x, y, _, _ = synthetic_dataset(num_train=2 * PARITY_BATCH, num_test=0,
                                   size=32, seed=seed + 3)
    gen = torch.Generator().manual_seed(seed + 4)
    perm = torch.randperm(len(x), generator=gen)
    draws = [draw_augment(gen, PARITY_BATCH, TRAIN_PAD) for _ in range(2)]
    bf16 = dtype == BF16
    cpu_model = train_model(seed + 3, "cpu", dtype if bf16 else None)
    start = {k: p.detach().clone() for k, p in cpu_model.named_parameters()}
    runs = {}
    for dev, model in (("cpu", cpu_model),
                       ("cuda", copy.deepcopy(cpu_model).to("cuda"))):
        fn = make_epoch_train_fn(
            model, True, PARITY_BATCH, TRAIN_PAD, device=dev, out_dtype=dtype,
            draws=lambda step, n, dev=dev: tuple(t.to(dev)
                                                 for t in draws[step]))
        state = TrainState.create(model, TRAIN_LR)
        state, metrics = fn(state, *device_resident(x, y, dev), 0,
                            perm=perm.to(dev))
        runs[dev] = (model, {k: v.item() for k, v in metrics.items()})
    (cpu, cpu_metrics), (gpu, gpu_metrics) = runs["cpu"], runs["cuda"]
    log(f"train parity ({dtype}): 2 steps at batch {PARITY_BATCH}, card vs "
        f"CPU: metrics {gpu_metrics} vs {cpu_metrics}")
    tol = BF16_TRAIN_TOL if bf16 else TRAIN_TOL
    update_tol = BF16_UPDATE_TOL if bf16 else UPDATE_TOL
    gpu_state = gpu.state_dict()
    beyond, update_err, diffs, updates = {}, {}, [], []
    for name, want in cpu.state_dict().items():
        got = gpu_state[name].cpu()
        limit = tol["atol"] + tol["rtol"] * want.abs()
        beyond[name] = ((got - want).abs() - limit).max().item()
        if name in start:
            update = want - start[name]
            update_err[name] = ((got - want).norm().item()
                                / max(update.norm().item(), 1e-30))
            diffs.append((got - want).ravel())
            updates.append(update.ravel())
    whole = (torch.cat(diffs).norm() / torch.cat(updates).norm()).item()
    worst = max(beyond, key=beyond.get)
    worst_update = max(update_err, key=update_err.get)
    log(f"  largest excess over rtol {tol['rtol']} / atol {tol['atol']}: "
        f"{beyond[worst]:.3g} at {worst}; largest parameter-update "
        f"difference {update_err[worst_update]:.3g} of the update's norm at "
        f"{worst_update}; whole update {whole:.3g}")
    failed = [k for k, v in cpu_metrics.items()
              if not abs(gpu_metrics[k] - v) <= tol["atol"] + tol["rtol"] * abs(v)]
    failed += [k for k in beyond
               if k not in start and beyond[k] > 0]  # BN stats, passports
    failed += [k for k, e in update_err.items() if e > update_tol]
    if bf16 and whole > BF16_WHOLE_UPDATE_TOL:
        failed.append(f"whole update {whole}")
    if failed:
        raise AssertionError(f"card and CPU training differ in {failed}")
    log(f"  metrics, BN statistics and passports within rtol {tol['rtol']} "
        f"/ atol {tol['atol']}; every parameter's update within "
        f"{update_tol} of its norm")


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
                  f"train step {dtype}, batch {TRAIN_BATCH}", smi, top=16)
    k1 = sum(t for name, t in us.items() if "fused_augment" in name)
    log(f"  K1 fused_augment: {k1:.1f} us/step, "
        f"{100 * k1 / sum(us.values()):.2f} % of the step's device time")


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
    then one V3 epoch. Returns the V2 run's launch counts and best.ckpt."""
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

    epochs = 3
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
    signature = {k: v for k, v in rows[-1].items() if k.startswith("s_")}
    if rows[-1]["train_sign_acc"] != 1.0 or set(signature.values()) != {1.0}:
        raise AssertionError(f"the V2 run's signature is not embedded: "
                             f"sign_acc {rows[-1]['train_sign_acc']}, "
                             f"detection {signature}")

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
    return counts, os.path.join(run2.logdir, "models", "best.ckpt")


# ------------------------------------------------------------ attacks

def attack_argv(best: str) -> list:
    return ["--arch", "resnet18", "--dataset", "synthetic", "--scheme", "2",
            "--passport-config", "passport_configs/resnet18_passport.json",
            "--loadpath", best]


def attack_path(best: str, smi: str, launches, reset) -> dict:
    """The six attack CLIs in-process on the card, on the V2 run's best.ckpt
    (f32 weights in an f32 model), on that run's synthetic set (12,800
    train, 512 validation images), batch 64. Returns the path's launch
    counts."""
    from deepipr_tpu_torch.cli import (
        flip_attack,
        passport_attack_1,
        passport_attack_2,
        passport_attack_3,
        passport_forge_attack,
        pruning_attack,
    )

    argv = attack_argv(best)
    walls = {}

    def run(name, main, *extra):
        t = time.perf_counter()
        # the V2 run's synthetic set: its size draws its class templates
        out = main(argv + list(extra), synthetic_train=TRAIN_IMAGES)
        walls[name] = time.perf_counter() - t
        log(f"attack: {name} ({' '.join(extra) or 'defaults'}) in "
            f"{walls[name]:.1f} s")
        return out

    reset()
    rows = run("pruning", pruning_attack.main)
    if len(rows) != 11 or rows[0]["detect_mean"] != 1.0:
        raise AssertionError(f"pruning: {len(rows)} rows, detection at 0 % "
                             f"{rows[0]['detect_mean']}")
    log("  pruning: detection by level "
        f"{[round(r['detect_mean'], 4) for r in rows]}, accuracy "
        f"{[r['acc'] for r in rows]}")

    rows = run("flip", flip_attack.main)
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

    rows = run("attack 1", passport_attack_1.main, "--attack-rep", "8")
    genuine = rows[0]["valid_acc"]
    fake = float(np.mean([r["valid_acc"] for r in rows[1:]]))
    if rows[0]["attack_rep"] != -1 or not fake < genuine:
        raise AssertionError(f"attack 1: fake mean {fake} vs genuine "
                             f"{genuine}")
    log(f"  attack 1: genuine {genuine} %, fake mean {fake:.2f} % over 8 "
        "reps")

    rows = run("attack 2", passport_attack_2.main, "--flipperc", "0.5",
               "--epochs", "2")
    if not all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float)):
        raise AssertionError(f"attack 2: {rows}")
    log(f"  attack 2: {rows[-1]}")

    for extra in ([], ["--epoch-scan"]):
        rows = run(f"attack 3{' --epoch-scan' if extra else ''}",
                   passport_attack_3.main, "--flipperc", "0.1", "--epochs",
                   "2", *extra)
        if not all(np.isfinite(v) for r in rows for v in r.values()
                   if isinstance(v, float)):
            raise AssertionError(f"attack 3: {rows}")
        log(f"  attack 3{' --epoch-scan' if extra else ''}: {rows[-1]}")

    forged, hists = run("forge", passport_forge_attack.main, "--flippercs",
                        "0,0.5", "--steps", "100")
    for row, hist in zip(forged, hists):
        if not hist[-1]["mse"] < hist[0]["mse"]:
            raise AssertionError(f"forge {row['flipperc']}: MSE did not "
                                 f"fall: {hist}")
    log(f"  forge: {forged}; MSE by flip fraction "
        f"{[[h['mse'] for h in hist] for hist in hists]}")
    counts = launches()
    log(f"attack-path launches: {counts}; wall times "
        f"{ {k: round(v, 1) for k, v in walls.items()} } s [{smi}]")
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
                     forge_step: bool = True) -> float:
    """On the checkpoint the attack CLIs' ``argv`` name (by default the V2
    best.ckpt): K2 and K2-bwd launches per ambiguity step (``per_step``
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
                     f"{'bf16' if dtype else 'f32 (TF32 off)'}")
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
        signature = {k: v for k, v in rows[-1].items() if k.startswith("s_")}
        if rows[-1]["train_sign_acc"] != 1.0 or \
                set(signature.values()) != {1.0}:
            raise AssertionError(f"AlexNet V{scheme}: the signature is not "
                                 f"embedded: sign_acc "
                                 f"{rows[-1]['train_sign_acc']}, detection "
                                 f"{signature}")
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


# ----------------------------------------------------------------- main

def shape_key(shape) -> str:
    return "x".join(map(str, shape))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

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
            for shape in (MAIN_SHAPE, (1024, 512, 4, 4), *ALEXNET_TIMED):
                t = time_epilogue(gen, timer, shape, smi, dtype)
                log(f"{form} {shape}: {json.dumps(t)} [{smi}]")
                by_shape.setdefault(form, {})[shape_key(shape)] = t
                if shape == MAIN_SHAPE:
                    timing[form] = t
        for shape in ((ATTACK_BATCH, 512, 4, 4), MAIN_SHAPE,
                      *ALEXNET_BWD_TIMED):
            t = time_backward(gen, timer, shape, smi)
            log(f"passport_epilogue_backward {shape}: {json.dumps(t)} "
                f"[{smi}]")
            by_shape.setdefault("passport_epilogue_backward",
                                {})[shape_key(shape)] = t
            if shape == (ATTACK_BATCH, 512, 4, 4):
                timing["passport_epilogue_backward"] = t
        for form, dtype in (("fused_augment", torch.float32),
                            ("fused_augment_bf16", BF16)):
            timing[form] = time_augment(timer, cases[0], smi, dtype)
            log(f"{form} {cases[0][0]}: {json.dumps(timing[form])} [{smi}]")
        del cases, timer

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
        batches = request_batches(3, args.seed)
        for form, dtype in (("passport_epilogue", None),
                            ("passport_epilogue_bf16", BF16)):
            cpu_model = random_model(args.seed, dtype)
            gpu_model = copy.deepcopy(cpu_model).to("cuda")
            forged = forged_passports(cpu_model, args.seed + 2)
            reset()
            serve_path(gpu_model, cpu_model, batches, forged, launches, form)
            counts = launches()
            log(f"serving-path launches ({form}): {counts}")
            if not counts[form] or sum(counts.values()) != counts[form]:
                raise AssertionError(f"{form} did not carry the serving "
                                     f"path: {counts}")
            paths[f"resnet_serve_{'bf16' if dtype else 'f32'}"] = counts
            label = "bf16" if dtype else "f32 (TF32 off)"
            throughput(gpu_model, smi, label)
            where_time_goes(gpu_model, smi)
            log(f"peak device memory: "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del gpu_model, cpu_model

    rates = {}
    with phase("resnet train"):
        for form, dtype in (("fused_augment", torch.float32),
                            ("fused_augment_bf16", BF16)):
            trained, state, xs, ys, counts, held_out, rates[form] = \
                train_path(args.seed, smi, launches, reset, dtype)
            paths[f"resnet_train_{'bf16' if dtype == BF16 else 'f32'}"] = \
                counts
            train_parity(args.seed, dtype)
            trained_serving(trained, held_out)
            train_profile(trained, state, xs, ys, args.seed, smi,
                          dtype=dtype)
            del trained, state, xs, ys
        log(f"throughput: train ResNet18Private V2 batch {TRAIN_BATCH}: "
            f"bf16 {rates['fused_augment_bf16']:.1f} img/s beside f32 "
            f"{rates['fused_augment']:.1f} img/s "
            f"({rates['fused_augment_bf16'] / rates['fused_augment']:.2f}x) "
            f"[{smi}]")

    with phase("resnet cli"):
        paths["resnet_cli"], best = cli_path(smi, launches, reset)
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
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
