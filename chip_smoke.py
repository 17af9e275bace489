#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepipr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on a failed check (so the exit code is not 0):

1. Environment: the card, its power limit, the float32 settings.
2. Build: every CUDA kernel of ``deepipr_tpu_torch/csrc`` with nvcc (sm_90a)
   into ``build/deepipr_tpu_torch/``, with ptxas's registers, spills and
   shared memory; each kernel's PTX read for 64-bit integer division (which
   fails the run) and, where the toolkit has cuobjdump, its SASS size.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes, the JAX package's test shapes and ragged ones
   (its vector and scalar paths), K2 twice for bit-identical results; then
   timed beside its plain version, a library yardstick where one exists,
   its memory bound, the event timer's own floor and its CUPTI duration.
4. Serving: ResNet18Private at CIFAR-10 width with
   passport_configs/resnet18_passport.json, random weights, passports and BN
   statistics from ``--seed``. The serving path runs through the public
   entry points (Predictor for both branches, the both-branch eval step,
   verify_ownership for genuine and forged passports) with every kernel's
   launch count set to 0 just before and read just after; the card's
   outputs are checked against the same model on the CPU.
5. Throughput: Predictor images/s for both branches at batch 256 and 1024,
   the verification latency, and each branch's device time by kernel
   from torch.profiler (printed, not asserted).
6. Training (bench.py's path): V2 ResNet18Private from ``--seed``, SGD
   (lr 0.01, momentum 0.9, decay 1e-4), batch 256, pad 4, one warm-up and
   three timed device-resident epochs over 12,800 synthetic uint8 images,
   with the launch counts set to 0 just before and read just after (K1 once
   per step, K2 never); the loss and sign loss must fall. Then two steps
   on the card against the same two steps on the CPU, the trained model
   through the serving entry points, and one profiled train step.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits with
an error before printing any result.
"""

from __future__ import annotations

import argparse
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
                (2, 128, 28, 28), (8, 512, 7, 7), (3, 40, 5, 3)]
# the card against the plain version of the same arithmetic: the GAP sums
# in another order (tests/test_pallas.py's tolerance)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
# the card's model against the CPU's: convolutions accumulate in other
# orders (tests/test_torch_export.py:102's tolerance)
LOGITS_TOL = dict(rtol=1e-3, atol=2e-4)
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
# two train steps on the card against the same two on the CPU: metrics and
# BN statistics elementwise; each parameter's update (after - before)
# norm-wise, since a pre-ReLU value within float32 noise of zero lands on
# opposite sides in cuDNN and on the CPU and moves whole gradients
# (tests/test_torch_port_train.py, PARAM_TOL)
PARITY_BATCH = 32
TRAIN_TOL = dict(rtol=1e-3, atol=1e-4)
UPDATE_TOL = 5e-2


def log(*parts):
    print(*parts, flush=True)


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

    def profiled_ms(self, fn, kernel: str, clean: bool = False) -> float:
        """Median CUPTI duration (torch.profiler) of the kernel whose name
        holds ``kernel``, over ``iters`` calls of ``fn``, the L2 flushed
        before each: the kernel alone, without the launch. The flush writes
        (as for ``ms``), which leaves the L2 full of dirty lines that the
        kernel's traffic must write back; ``clean`` flushes by reading."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(self.iters):
                if clean:
                    self.flush.sum()
                else:
                    self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(us) != self.iters:
            raise AssertionError(f"the profiler saw {len(us)} launches of "
                                 f"{kernel}, expected {self.iters}")
        return statistics.median(us) / 1e3


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


def epilogue_inputs(shape, gen):
    n, c, h, w = shape
    dev = "cuda"
    y = torch.randn(shape, generator=gen).to(dev)
    key_out = torch.randn((1, c, h, w), generator=gen).to(dev)
    skey_out = torch.randn((1, c, h, w), generator=gen).to(dev)
    mean = torch.randn(c, generator=gen).to(dev)
    var = (0.5 + 1.5 * torch.rand(c, generator=gen)).to(dev)
    return y, key_out, skey_out, mean, var


def check_epilogue(gen) -> float:
    """The kernel against its plain version; returns the largest error."""
    from deepipr_tpu_torch.ops.passport_epilogue import (
        passport_epilogue,
        passport_epilogue_reference,
    )

    worst = 0.0
    cases = [(shape, epilogue_inputs(shape, gen)) for shape in CHECK_SHAPES]
    # y and key_out 4 bytes off 16-byte alignment: the scalar path at H*W=16
    y, key_out, *rest = epilogue_inputs(MAIN_SHAPE, gen)
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
                if name == "out":
                    torch.testing.assert_close(g, w, **KERNEL_TOL)
                else:
                    torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
                worst = max(worst, (g - w).abs().max().item())
        log(f"passport_epilogue {label}: agrees with the plain version "
            f"(relu on and off), bit-identical over two calls")
    return worst


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def time_epilogue(gen, timer: DeviceTimer, shape, smi: str) -> dict:
    from deepipr_tpu_torch.ops.passport_epilogue import (
        passport_epilogue,
        passport_epilogue_reference,
    )

    y, key_out, skey_out, mean, var = args = epilogue_inputs(shape, gen)
    _, scale, bias = passport_epilogue_reference(*args)

    def library():
        # the nearest single library call, with scale/bias precomputed
        F.batch_norm(y, mean, var, scale, bias, False, 0.0, 1e-5).relu_()

    n, c, h, w = shape
    nbytes = 4 * (2 * n * c * h * w + 2 * c * h * w + 4 * c)
    flops = 5 * n * c * h * w + 2 * c * h * w
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / F32_FLOPS_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)
    copy = torch.empty_like(y)
    memory_diagnostics(timer, lambda: passport_epilogue(*args),
                       "passport_epilogue_kernel",
                       lambda: torch.mul(y, 1.0, out=copy), "MulFunctor",
                       f"passport_epilogue {shape}", smi)
    return {
        "ms": timer.ms(lambda: passport_epilogue(*args)),
        "profiled_ms": timer.profiled_ms(lambda: passport_epilogue(*args),
                                         "passport_epilogue_kernel"),
        "plain_ms": timer.ms(lambda: passport_epilogue_reference(*args)),
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


def check_augment(cases) -> float:
    """K1 against its plain version on the same card tensors: the pixels
    (mean 0, std 1/255) bit for bit, the normalized batch at AUGMENT_TOL.
    Returns the largest normalized error."""
    from deepipr_tpu_torch.data.device_augment import (
        augment_reference,
        scaled_stats,
    )
    from deepipr_tpu_torch.ops.fused_augment import fused_augment

    zero = torch.zeros(3, device="cuda")
    one = torch.ones(3, device="cuda")
    worst = 0.0
    for label, ds, idx, draws, pad in cases:
        for stats, tol in (((zero, one), None),
                           (scaled_stats(device="cuda"), AUGMENT_TOL)):
            got = fused_augment(ds, idx, *draws, *stats, pad)
            torch.cuda.synchronize()
            want = augment_reference(ds[idx.long()], *draws, pad, *stats)
            if got.shape != want.shape or got.dtype != torch.float32:
                raise AssertionError(f"fused_augment {label}: got "
                                     f"{got.dtype} {tuple(got.shape)}")
            if tol is None:
                if not torch.equal(got, want):
                    raise AssertionError(f"fused_augment {label}: pixels "
                                         "differ from the plain version")
            else:
                torch.testing.assert_close(got, want, **tol)
                worst = max(worst, (got - want).abs().max().item())
        log(f"fused_augment {label}: agrees with the plain version (pixels "
            "bit for bit, normalized within 3e-7)")
    return worst


def time_augment(timer: DeviceTimer, case, smi: str) -> dict:
    from deepipr_tpu_torch.data.device_augment import (
        augment_reference,
        scaled_stats,
    )
    from deepipr_tpu_torch.ops.fused_augment import fused_augment

    _, ds, idx, draws, pad = case
    mean255, std255 = scaled_stats(device="cuda")
    _, h, w, c = ds.shape
    b = idx.shape[0]
    # the gathered rows read once, the f32 batch written once, four int32
    # per row (idx, oy, ox, flip) and the two (C,) f32 statistics
    nbytes = b * h * w * c * (1 + 4) + 16 * b + 8 * c
    flops = 2 * b * h * w * c  # a subtract and a divide per output
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / F32_FLOPS_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)

    def kernel():
        fused_augment(ds, idx, *draws, mean255, std255, pad)

    rows, batch = ds[:b], torch.empty((b, h, w, c), device="cuda")
    memory_diagnostics(timer, kernel, "fused_augment_kernel",
                       lambda: batch.copy_(rows), "direct_copy",
                       f"fused_augment {case[0]}", smi)

    return {
        "ms": timer.ms(kernel),
        "profiled_ms": timer.profiled_ms(kernel, "fused_augment_kernel"),
        "plain_ms": timer.ms(lambda: augment_reference(
            ds[idx.long()], *draws, pad, mean255, std255)),
        "library_ms": None,  # no single PyTorch call gathers, crops and flips
        "bound_ms": bound[bound_by],
        "bound_by": bound_by,
    }


# ---------------------------------------------------------------- model

@torch.no_grad()
def random_model(seed: int):
    """ResNet18Private on the CPU: weights, passports and BN running stats
    from ``seed``, each signature ``b`` set to the sign of its derived scale
    (the signature a trained model carries)."""
    from deepipr_tpu_torch.attacks.common import derived_affines
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.ops.norms import BatchNorm
    from deepipr_tpu_torch.utils.config import (
        construct_passport_kwargs,
        load_passport_config,
    )

    kw, plkeys = construct_passport_kwargs(
        load_passport_config("passport_configs/resnet18_passport.json"),
        "bn", "random", 0.1)
    model = build_model("resnet18", 10, norm_type="bn", passport_kwargs=kw,
                        private=True, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 2.0, generator=gen)
    for path, aux in derived_affines(model, (1, 32, 32, 3), True).items():
        block = model.get_submodule(path.replace("/", "."))
        block.b.copy_(torch.where(aux["scale"] >= 0, 1.0, -1.0))
    log(f"model: ResNet18Private, CIFAR-10 32x32x3, passports in {plkeys}")
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


def serve_path(gpu_model, cpu_model, batches, forged, launches) -> dict:
    """The serving and verification path on the card, checked against the
    CPU. ``launches()`` reads the kernels' launch counts."""
    from deepipr_tpu_torch.serve import Predictor, verify_ownership
    from deepipr_tpu_torch.train.steps import make_dual_eval_step, run_dual_eval

    public = Predictor(gpu_model, ind=0)
    private = Predictor(gpu_model, ind=1)
    for batch in batches:
        logits0 = public.logits(batch["image"])
        before = launches()["passport_epilogue"]
        logits1 = private.logits(batch["image"])
        per_forward = launches()["passport_epilogue"] - before
        if per_forward != 5:
            raise AssertionError(f"{per_forward} epilogue launches in one "
                                 "private forward, expected 5")
        for logits in (logits0, logits1):
            if logits.shape != (REQUEST_BATCH, 10) or \
                    not torch.isfinite(logits).all():
                raise AssertionError("non-finite or misshapen logits")
    cpu_logits = Predictor(cpu_model, ind=1, device="cpu").logits(
        batches[0]["image"])
    torch.testing.assert_close(private.logits(batches[0]["image"]).cpu(),
                               cpu_logits, **LOGITS_TOL)
    log("Predictor: public and private branches answered "
        f"{len(batches)} batches of {REQUEST_BATCH}; private logits match "
        "the CPU run; 5 epilogue launches per private forward")

    step = make_dual_eval_step(gpu_model)
    metrics = run_dual_eval(step, batches)
    cpu_sums = make_dual_eval_step(cpu_model, device="cpu")(batches[0])
    gpu_sums = step(batches[0])
    for k, v in cpu_sums.items():
        torch.testing.assert_close(gpu_sums[k].cpu().double(), v.double(),
                                   rtol=1e-3, atol=1e-2)
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite dual-eval metrics {metrics}")
    log(f"dual eval over {len(batches)} batches: {metrics}")

    genuine = verify_ownership(gpu_model, (1, 32, 32, 3), private=True)
    if not (genuine["verified"] and genuine["detection_rate"] == 1.0):
        raise AssertionError(f"genuine passports did not verify: {genuine}")
    fake = verify_ownership(gpu_model, (1, 32, 32, 3), private=True,
                            claimed_passports=forged)
    fake_cpu = verify_ownership(cpu_model, (1, 32, 32, 3), private=True,
                                claimed_passports=forged, device="cpu")
    if fake["verified"] or not fake["detection_rate"] < 0.7:
        raise AssertionError(f"forged passports verified: {fake}")
    if fake["layers"] != fake_cpu["layers"]:
        raise AssertionError(f"forged rates differ: card {fake['layers']}, "
                             f"CPU {fake_cpu['layers']}")
    log(f"verify_ownership: genuine {genuine['detection_rate']} "
        f"(verified={genuine['verified']}); forged "
        f"{fake['detection_rate']:.4f}, per layer {fake['layers']} "
        "(equal to the CPU run)")
    return metrics


def throughput(gpu_model, smi: str) -> None:
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
            log(f"throughput: Predictor ind={ind} batch={batch} f32 "
                f"(TF32 off): {rate:.1f} img/s [{smi}]")
    times = []
    for _ in range(20):
        t = time.perf_counter()
        verify_ownership(gpu_model, (1, 32, 32, 3), private=True)
        times.append((time.perf_counter() - t) * 1e3)
    log(f"latency: verify_ownership median {statistics.median(times):.3f} ms "
        f"over 20 calls [{smi}]")


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


def where_time_goes(gpu_model, smi: str, reps: int = 5) -> None:
    """Device time by kernel over ``reps`` forwards of each branch at batch
    256."""
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
    log(f"  K2 passport_epilogue: {k2:.1f} us per private forward (5 "
        f"launches), {100 * k2 / sum(us.values()):.2f} % of its device time")


# ------------------------------------------------------------- training

def train_model(seed: int, device: str):
    """bench.py's model: V2 ResNet18Private, resnet18_passport.json with
    ('bn', 'shuffle', 0.1), weights, passports and signatures from seed."""
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.utils.config import (
        construct_passport_kwargs,
        load_passport_config,
    )

    kw, _ = construct_passport_kwargs(
        load_passport_config("passport_configs/resnet18_passport.json"),
        "bn", "shuffle", 0.1)
    return build_model("resnet18", 10, norm_type="bn", passport_kwargs=kw,
                       private=True, seed=seed, device=device)


def train_path(seed: int, smi: str, launches, reset):
    """bench.py's loop through the port's entry points: one warm-up and
    TIMED_EPOCHS timed epochs, host-clocked with one read of the epoch's
    mean metrics at its end; img/s from the best timed epoch. Returns the
    trained model, its state, the resident set, the path's launch counts
    and held-out batches of the same synthetic distribution."""
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
    model = train_model(seed, "cuda")
    xs, ys = device_resident(x, y)
    epoch_fn = make_epoch_train_fn(model, True, TRAIN_BATCH, TRAIN_PAD,
                                   seed=seed)
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

    log(f"training-path launches: {counts}")
    epochs = 1 + TIMED_EPOCHS
    if counts["fused_augment"] != steps * epochs:
        raise AssertionError(f"fused_augment launched {counts['fused_augment']}"
                             f" times in {epochs} epochs of {steps} steps")
    if counts["passport_epilogue"] != 0:
        raise AssertionError("the eval-only passport epilogue launched "
                             "during training")
    for k in ("loss", "sign_loss"):
        if not history[-1][k] < history[0][k]:
            raise AssertionError(f"mean {k} did not fall: {history[0][k]} in "
                                 f"the first epoch, {history[-1][k]} in the "
                                 "last")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"non-finite training metrics {history}")
    best = min(seconds[1:])
    log(f"throughput: train ResNet18Private V2 batch {TRAIN_BATCH} f32 "
        f"(TF32 off), device-resident epoch incl. K1: "
        f"{steps * TRAIN_BATCH / best:.1f} img/s (best of {TIMED_EPOCHS} "
        f"epochs: {', '.join(f'{s:.3f}' for s in seconds[1:])} s) [{smi}]")
    log(f"peak device memory, training: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, state, xs, ys, counts, held_out


def train_parity(seed: int) -> None:
    """Two steps from the same weights, permutation and draws: the card
    through the kernels, the CPU through their plain versions."""
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
    cpu_model = train_model(seed + 3, "cpu")
    start = {k: p.detach().clone() for k, p in cpu_model.named_parameters()}
    runs = {}
    for dev, model in (("cpu", cpu_model),
                       ("cuda", copy.deepcopy(cpu_model).to("cuda"))):
        fn = make_epoch_train_fn(
            model, True, PARITY_BATCH, TRAIN_PAD, device=dev,
            draws=lambda step, n, dev=dev: tuple(t.to(dev)
                                                 for t in draws[step]))
        state = TrainState.create(model, TRAIN_LR)
        state, metrics = fn(state, *device_resident(x, y, dev), 0,
                            perm=perm.to(dev))
        runs[dev] = (model, {k: v.item() for k, v in metrics.items()})
    (cpu, cpu_metrics), (gpu, gpu_metrics) = runs["cpu"], runs["cuda"]
    log(f"train parity: 2 steps at batch {PARITY_BATCH}, card vs CPU: "
        f"metrics {gpu_metrics} vs {cpu_metrics}")
    gpu_state = gpu.state_dict()
    beyond, update_err = {}, {}
    for name, want in cpu.state_dict().items():
        got = gpu_state[name].cpu()
        limit = TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * want.abs()
        beyond[name] = ((got - want).abs() - limit).max().item()
        if name in start:
            update = (want - start[name]).norm().item()
            update_err[name] = (got - want).norm().item() / max(update, 1e-30)
    worst = max(beyond, key=beyond.get)
    worst_update = max(update_err, key=update_err.get)
    log(f"  largest excess over rtol 1e-3 / atol 1e-4: {beyond[worst]:.3g} "
        f"at {worst}; largest parameter-update difference "
        f"{update_err[worst_update]:.3g} of the update's norm at "
        f"{worst_update}")
    failed = [k for k, v in cpu_metrics.items()
              if not abs(gpu_metrics[k] - v)
              <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(v)]
    failed += [k for k in beyond
               if k not in start and beyond[k] > 0]  # BN stats, passports
    failed += [k for k, e in update_err.items() if e > UPDATE_TOL]
    if failed:
        raise AssertionError(f"card and CPU training differ in {failed}")
    log(f"  metrics, BN statistics and passports within rtol 1e-3 / atol "
        f"1e-4; every parameter's update within {UPDATE_TOL} of its norm")


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
                  reps: int = 3) -> None:
    """Device time by kernel over ``reps`` train steps at batch 256, K1's
    share among them."""
    from deepipr_tpu_torch.train.steps import make_train_step

    step = make_train_step(model, True, pad=TRAIN_PAD, seed=seed)
    rows = torch.randperm(xs.shape[0], device="cuda")[:TRAIN_BATCH].int()
    batch = {"image": xs, "index": rows, "label": ys[rows.long()]}
    step(state, batch)
    us = profiled(lambda: step(state, batch), reps,
                  f"train step, batch {TRAIN_BATCH}", smi, top=16)
    k1 = sum(t for name, t in us.items() if "fused_augment" in name)
    log(f"  K1 fused_augment: {k1:.1f} us/step, "
        f"{100 * k1 / sum(us.values()):.2f} % of the step's device time")


# ----------------------------------------------------------------- main

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from deepipr_tpu_torch.ops.fused_augment import fused_augment
    from deepipr_tpu_torch.ops.passport_epilogue import passport_epilogue

    smi = environment()
    build_kernels()

    gen = torch.Generator().manual_seed(args.seed)
    max_err = {"passport_epilogue": check_epilogue(gen)}
    cases = augment_cases(args.seed)
    max_err["fused_augment"] = check_augment(cases)
    timer = DeviceTimer()
    floor_ms = timer.floor_ms()
    log(f"event timer floor (one-element zero_, L2 flushed): {floor_ms} ms "
        f"[{smi}]")
    timing = {}
    for shape in (MAIN_SHAPE, (1024, 512, 4, 4)):
        timing[shape] = time_epilogue(gen, timer, shape, smi)
        log(f"passport_epilogue {shape}: {json.dumps(timing[shape])} [{smi}]")
    timing["fused_augment"] = time_augment(timer, cases[0], smi)
    log(f"fused_augment {cases[0][0]}: {json.dumps(timing['fused_augment'])} "
        f"[{smi}]")
    del cases, timer

    wrappers = {"passport_epilogue": passport_epilogue,
                "fused_augment": fused_augment}

    def launches():
        return {name: fn.launches for name, fn in wrappers.items()}

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    cpu_model = random_model(args.seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batches = request_batches(3, args.seed)
    forged = forged_passports(cpu_model, args.seed + 2)

    reset()
    serve_path(gpu_model, cpu_model, batches, forged, launches)
    serve_counts = launches()
    log(f"serving-path launches: {serve_counts}")
    if not serve_counts["passport_epilogue"]:
        raise AssertionError(f"K2 never launched on the serving path: "
                             f"{serve_counts}")

    throughput(gpu_model, smi)
    where_time_goes(gpu_model, smi)
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del gpu_model, cpu_model

    trained, state, xs, ys, train_counts, held_out = train_path(
        args.seed, smi, launches, reset)
    train_parity(args.seed)
    trained_serving(trained, held_out)
    train_profile(trained, state, xs, ys, args.seed, smi)

    path_launches = {"passport_epilogue": serve_counts["passport_epilogue"],
                     "fused_augment": train_counts["fused_augment"]}
    sources = {
        "passport_epilogue": "deepipr_tpu/ops/pallas_fused.py:52",
        "fused_augment": "deepipr_tpu/ops/pallas_augment.py:64",
    }
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"deepipr_tpu_torch/csrc/{name}.cu",
        "replaces": sources[name],
        "launches": path_launches[name],
        "max_abs_err": max_err[name],
        "floor_ms": floor_ms,
        **timing[MAIN_SHAPE if name == "passport_epilogue" else name],
    } for name in ("passport_epilogue", "fused_augment")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
