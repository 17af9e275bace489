#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepipr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on a failed check (so the exit code is not 0):

1. Environment: the card, its power limit, the float32 settings.
2. Build: every CUDA kernel of ``deepipr_tpu_torch/csrc`` with nvcc (sm_90a)
   into ``build/deepipr_tpu_torch/``.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes and the JAX package's test shapes, then timed
   beside its plain version, a library yardstick and its memory bound.
4. Model: ResNet18Private at CIFAR-10 width with
   passport_configs/resnet18_passport.json, random weights, passports and BN
   statistics from ``--seed``. The serving path runs through the public
   entry points (Predictor for both branches, the both-branch eval step,
   verify_ownership for genuine and forged passports) with every kernel's
   launch count set to 0 just before and read just after; the card's
   outputs are checked against the same model on the CPU.
5. Throughput: Predictor images/s for both branches at batch 256 and 1024,
   the verification latency, and each branch's device time by kernel
   from torch.profiler (printed, not asserted).

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits with
an error before printing any result.
"""

from __future__ import annotations

import argparse
import copy
import json
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
# tests/test_pallas.py's shapes in NCHW, and batch 1 (signature detection)
CHECK_SHAPES = [MAIN_SHAPE, (1, 512, 4, 4), (1024, 512, 4, 4),
                (4, 128, 8, 8), (2, 256, 16, 16), (2, 64, 56, 56),
                (2, 128, 28, 28)]
# the card against the plain version of the same arithmetic: the GAP sums
# in another order (tests/test_pallas.py's tolerance)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
# the card's model against the CPU's: convolutions accumulate in other
# orders (tests/test_torch_export.py:102's tolerance)
LOGITS_TOL = dict(rtol=1e-3, atol=2e-4)


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
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


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


# -------------------------------------------------------------- kernels

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
    for shape in CHECK_SHAPES:
        args = epilogue_inputs(shape, gen)
        for relu in (True, False):
            got = passport_epilogue(*args, relu=relu)
            torch.cuda.synchronize()
            want = passport_epilogue_reference(*args, relu=relu)
            for name, g, w in zip(("out", "scale", "bias"), got, want):
                if name == "out":
                    torch.testing.assert_close(g, w, **KERNEL_TOL)
                else:
                    torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
                worst = max(worst, (g - w).abs().max().item())
        log(f"passport_epilogue {shape}: agrees with the plain version "
            f"(relu on and off)")
    return worst


def time_epilogue(gen, timer: DeviceTimer, shape) -> dict:
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
    return {
        "ms": timer.ms(lambda: passport_epilogue(*args)),
        "plain_ms": timer.ms(lambda: passport_epilogue_reference(*args)),
        "library_ms": timer.ms(library),
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


def where_time_goes(gpu_model, smi: str, reps: int = 5) -> None:
    """Device time by kernel over ``reps`` forwards of each branch at batch
    256, from torch.profiler's CUDA activity, and the card's idle share
    between the first kernel's start and the last one's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepipr_tpu_torch.serve import Predictor

    x = torch.randn((REQUEST_BATCH, 32, 32, 3),
                    generator=torch.Generator().manual_seed(8)).cuda()
    for ind in (0, 1):
        pred = Predictor(gpu_model, ind=ind)
        for _ in range(3):
            pred.logits(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                pred.logits(x)
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
        log(f"profile: ind={ind} forward, batch {REQUEST_BATCH}: "
            f"{busy / reps / 1e3:.3f} ms of kernels per forward, "
            f"{len(kernels) / reps:.0f} kernels, card idle "
            f"{100 * (1 - busy / span):.1f} % of the span [{smi}]")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            log(f"  {100 * us / busy:5.1f} %  {us / reps:9.1f} us/forward  "
                f"{name[:100]}")


# ----------------------------------------------------------------- main

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from deepipr_tpu_torch.ops.passport_epilogue import passport_epilogue

    smi = environment()
    build_kernels()

    gen = torch.Generator().manual_seed(args.seed)
    max_err = check_epilogue(gen)
    timer = DeviceTimer()
    timing = {}
    for shape in (MAIN_SHAPE, (1024, 512, 4, 4)):
        timing[shape] = time_epilogue(gen, timer, shape)
        log(f"passport_epilogue {shape}: {json.dumps(timing[shape])} [{smi}]")

    cpu_model = random_model(args.seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batches = request_batches(3, args.seed)
    forged = forged_passports(cpu_model, args.seed + 2)

    def launches():
        return {"passport_epilogue": passport_epilogue.launches}

    passport_epilogue.launches = 0
    serve_path(gpu_model, cpu_model, batches, forged, launches)
    counts = launches()
    log(f"main-path launches: {counts}")
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the path never launched: {counts}")

    throughput(gpu_model, smi)
    where_time_goes(gpu_model, smi)
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    kernels = [{
        "name": "passport_epilogue",
        "route": "cuda",
        "source": "deepipr_tpu_torch/csrc/passport_epilogue.cu",
        "replaces": "deepipr_tpu/ops/pallas_fused.py:52",
        "launches": counts["passport_epilogue"],
        "max_abs_err": max_err,
        **timing[MAIN_SHAPE],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
