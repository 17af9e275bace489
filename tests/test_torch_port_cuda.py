"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Without a CUDA card each test skips: a CUDA kernel has no CPU mode, and the
CPU tests hold the plain versions to the JAX package instead
(tests/test_torch_port_kernels.py).
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from deepipr_tpu_torch.data.device_augment import (
    augment_reference,
    draw_augment,
    scaled_stats,
)
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.ops.fused_augment import augment_geometry, fused_augment
from deepipr_tpu_torch.ops.passport_epilogue import (
    arrival_counters,
    backward_geometry,
    epilogue_geometry,
    fixed_order_gap,
    passport_epilogue,
    passport_epilogue_backward,
    passport_epilogue_backward_reference,
    passport_epilogue_reference,
)
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import make_train_step
from deepipr_tpu_torch.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
)
from deepipr_tpu_torch.utils.device import resolve_device

CONFIGS = Path(__file__).resolve().parent.parent / "passport_configs"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return resolve_device("cuda")  # f32 is IEEE f32: TF32 pinned off


# NCHW: the serving path's layer4 blocks at batch 256 and 1 (signature
# detection), tests/test_pallas.py's shapes, and AlexNet's features_4-6 at
# 8x8 (CIFAR) and 13x13 (ImageNet, 224 px)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512, 4, 4), (1, 512, 4, 4),
                                   (4, 128, 8, 8), (2, 64, 56, 56),
                                   (256, 384, 8, 8), (1, 256, 8, 8),
                                   (64, 384, 13, 13)])
@pytest.mark.parametrize("relu", [True, False])
def test_epilogue_kernel_matches_plain_version(cuda, shape, relu):
    n, c, h, w = shape
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(shape, generator=g),
            torch.randn((1, c, h, w), generator=g),
            torch.randn((1, c, h, w), generator=g),
            torch.randn(c, generator=g),
            0.5 + 1.5 * torch.rand(c, generator=g)]
    args = [a.to(cuda) for a in args]
    before = passport_epilogue.launches
    got = passport_epilogue(*args, relu=relu)
    torch.cuda.synchronize()
    assert passport_epilogue.launches == before + 1
    want = passport_epilogue_reference(*args, relu=relu)
    for g_, w_ in zip(got, want):
        # the kernel's GAP is a fixed-order tree, torch's mean another order
        # (tests/test_pallas.py's tolerance)
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-6)


def _epilogue_args(shape, device, seed=0):
    n, c, h, w = shape
    g = torch.Generator().manual_seed(seed)
    args = [torch.randn(shape, generator=g),
            torch.randn((1, c, h, w), generator=g),
            torch.randn((1, c, h, w), generator=g),
            torch.randn(c, generator=g),
            0.5 + 1.5 * torch.rand(c, generator=g)]
    return [a.to(device) for a in args]


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary: a row of a larger tensor at an odd offset."""
    flat = torch.zeros((2, t.numel() + 1), dtype=t.dtype, device=t.device)
    view = flat[1, 1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


# ragged cases of the redesigned kernel: H*W = 49 (the scalar path), C not a
# multiple of the channel tile, batch 1; a key_out off 16-byte alignment, and
# y off it (the scalar path at H*W = 16); AlexNet's ImageNet features_5/6,
# H*W = 169 (the scalar path) in tiles of 3 channels, the last of 256 ragged
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hw49", "ragged_tile", "batch1",
                                  "misaligned_key", "misaligned_y",
                                  "hw169"])
def test_epilogue_kernel_ragged_and_misaligned(cuda, case):
    shape = {"hw49": (8, 512, 7, 7), "ragged_tile": (3, 40, 5, 3),
             "batch1": (1, 512, 4, 4), "hw169": (64, 256, 13, 13)}.get(
        case, (16, 512, 4, 4))
    args = _epilogue_args(shape, cuda, seed=1)
    if case == "misaligned_key":
        args[1] = _misaligned(args[1])
    elif case == "misaligned_y":
        args[0] = _misaligned(args[0])
    n, c, h, w = shape
    geo = epilogue_geometry(n, c, h * w, args[0].data_ptr(), 0)
    assert geo.vector == (case not in ("hw49", "ragged_tile",
                                       "misaligned_y", "hw169"))
    for relu in (True, False):
        got = passport_epilogue(*args, relu=relu)
        torch.cuda.synchronize()
        want = passport_epilogue_reference(*args, relu=relu)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        for g_, w_ in zip(got[1:], want[1:]):
            torch.testing.assert_close(g_, w_, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512, 4, 4), (8, 512, 7, 7),
                                   (64, 256, 13, 13)])
def test_epilogue_kernel_is_deterministic(cuda, shape):
    """Every block derives a channel's coefficients in one fixed order and
    no atomics are used: two calls agree bit for bit."""
    args = _epilogue_args(shape, cuda, seed=2)
    first = passport_epilogue(*args)
    second = passport_epilogue(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_epilogue_rejects_mixed_devices(cuda):
    y = torch.zeros((2, 8, 4, 4), device=cuda)
    k = torch.zeros((1, 8, 4, 4))
    with pytest.raises(ValueError):
        passport_epilogue(y, k, k, torch.zeros(8), torch.ones(8))


def bf16_ulps(a, b) -> int:
    """The largest distance between two bf16 tensors in bf16 units in the
    last place, on a monotone line of their bit patterns."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    return int((ordered(a) - ordered(b)).abs().max())


# the bf16 form: the main shapes, H*W = 49 (the scalar path), a ragged tile,
# H*W = 4 (not a multiple of 8: the scalar path), y or out off 16-byte
# alignment, and AlexNet's features_4 at 8x8 and 13x13 (the scalar path)
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["main", "batch1", "hw49", "ragged_tile",
                                  "hw4", "misaligned_y", "misaligned_out",
                                  "alexnet_8x8", "alexnet_13x13"])
def test_epilogue_bf16_kernel_matches_plain_version(cuda, case):
    shape = {"main": (256, 512, 4, 4), "batch1": (1, 512, 4, 4),
             "hw49": (8, 512, 7, 7), "ragged_tile": (3, 40, 5, 3),
             "hw4": (4, 128, 2, 2), "alexnet_8x8": (256, 384, 8, 8),
             "alexnet_13x13": (64, 384, 13, 13)}.get(case, (16, 512, 4, 4))
    args = _epilogue_args(shape, cuda, seed=3)
    args[0] = args[0].to(torch.bfloat16)
    if case == "misaligned_y":
        args[0] = _misaligned(args[0])
    n, c, h, w = shape
    geo = epilogue_geometry(n, c, h * w, args[0].data_ptr(), 0, itemsize=2)
    assert geo.vector == (case in ("main", "batch1", "misaligned_out",
                                   "alexnet_8x8"))
    if geo.vector:  # every thread of the tile carries y
        assert geo.threads == geo.row_split * geo.tile_c * h * w // 8
    for relu in (True, False):
        before = passport_epilogue.launches
        got = passport_epilogue(*args, relu=relu)
        torch.cuda.synchronize()
        assert passport_epilogue.launches == before + 1
        want = passport_epilogue_reference(*args, relu=relu)
        assert got[0].dtype == torch.bfloat16
        assert bf16_ulps(got[0], want[0]) <= 1
        for g_, w_ in zip(got[1:], want[1:]):
            assert g_.dtype == torch.float32
            torch.testing.assert_close(g_, w_, rtol=0, atol=1e-6)
    # scale and bias equal the f32 form's on the same passport outputs, and
    # the plain version's fixed-order GAP, bit for bit
    f32 = passport_epilogue(args[0].float().contiguous(), *args[1:])
    for g_, w_ in zip(got[1:], f32[1:]):
        assert torch.equal(g_, w_)
    assert torch.equal(got[1], fixed_order_gap(args[2]))
    assert torch.equal(got[2], fixed_order_gap(args[1]))


@pytest.mark.cuda
def test_epilogue_bf16_kernel_is_deterministic(cuda):
    args = _epilogue_args((256, 512, 4, 4), cuda, seed=4)
    args[0] = args[0].to(torch.bfloat16)
    first = passport_epilogue(*args)
    second = passport_epilogue(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- K2-bwd

def _backward_args(shape, device, seed=5, relu=True):
    """(g, y, bias, scale, mean, var, g_scale, g_bias) and K2's own out:
    bias, scale and out from the forward kernel on the same y, so the
    plain version's mask is the forward's own."""
    y, key_out, skey_out, mean, var = _epilogue_args(shape, device, seed)
    out, scale, bias = passport_epilogue(y, key_out, skey_out, mean, var,
                                         relu=relu)
    gen = torch.Generator().manual_seed(seed + 1)
    c = shape[1]
    g = torch.randn(shape, generator=gen).to(device)
    g_scale = torch.randn(c, generator=gen).to(device)
    g_bias = torch.randn(c, generator=gen).to(device)
    return [g, y, bias, scale, mean, var, g_scale, g_bias], out


def _counters_at_zero(t):
    torch.cuda.synchronize()
    index = t.device.index
    stream = torch.cuda.current_stream(index).cuda_stream
    return int(arrival_counters(index, stream).count_nonzero()) == 0


# dy is one product of the same f32 factors on both sides; the per-channel
# sums over N*H*W terms run in another order (the kernel's rows, lanes and
# row blocks against torch's reduction), which moves them by a few f32
# units of their magnitude (up to about 1e2 at batch 1024)
BWD_SUM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b64", "b256", "b1024", "b1", "hw49",
                                  "ragged_tile", "misaligned_y",
                                  "alexnet_b64_384", "alexnet_b64_256",
                                  "alexnet_b1"])
@pytest.mark.parametrize("relu", [True, False])
def test_epilogue_backward_kernel_matches_plain_version(cuda, case, relu):
    # b1: the forge attack's batch of one image; alexnet_*: AlexNet's
    # features_4 and _5/_6 at 8x8 at the attack CLIs' batch and the forge's
    shape = {"b64": (64, 512, 4, 4), "b1024": (1024, 512, 4, 4),
             "b1": (1, 512, 4, 4), "hw49": (8, 512, 7, 7),
             "ragged_tile": (3, 40, 5, 3), "alexnet_b64_384": (64, 384, 8, 8),
             "alexnet_b64_256": (64, 256, 8, 8),
             "alexnet_b1": (1, 384, 8, 8)}.get(case, (256, 512, 4, 4))
    args, out = _backward_args(shape, cuda, relu=relu)
    if case == "misaligned_y":
        args[1] = _misaligned(args[1])
    n, c, h, w = shape
    geo = backward_geometry(n, c, h * w, args[0].data_ptr(),
                            args[1].data_ptr())
    assert geo.vector == (case not in ("hw49", "ragged_tile",
                                       "misaligned_y"))
    before = passport_epilogue_backward.launches
    got = passport_epilogue_backward(*args, relu=relu)
    assert _counters_at_zero(args[1])
    again = passport_epilogue_backward(*args, relu=relu)
    assert _counters_at_zero(args[1])
    assert passport_epilogue_backward.launches == before + 2
    g, y, _, scale, mean, var, g_scale, g_bias = args
    want = passport_epilogue_backward_reference(
        g, y, out, scale, mean, var, g_scale, g_bias, relu=relu)
    for g_, a_ in zip(got, again):
        assert torch.equal(g_, a_)  # no float atomics: bit-identical
    # the recomputed mask is K2's out > 0: dy bit for bit
    assert torch.equal(got[0], want[0])
    for g_, w_ in zip(got[1:], want[1:]):
        assert g_.shape == (1, c, h, w)
        torch.testing.assert_close(g_, w_, **BWD_SUM_TOL)


@pytest.mark.cuda
def test_epilogue_under_autograd_runs_both_kernels(cuda):
    """With grad mode on and passports that require a gradient, the outputs
    carry a grad_fn; backward is one K2-bwd launch and agrees with autograd
    of the plain version on the CPU."""
    shape = (32, 512, 4, 4)
    y, key_out, skey_out, mean, var = _epilogue_args(shape, cuda, seed=6)
    leaves = [t.clone().requires_grad_(True) for t in (y, key_out, skey_out)]
    fwd, bwd = passport_epilogue.launches, passport_epilogue_backward.launches
    out, scale, bias = passport_epilogue(*leaves, mean, var)
    assert all(t.grad_fn is not None for t in (out, scale, bias))
    assert passport_epilogue.launches == fwd + 1
    gen = torch.Generator().manual_seed(7)
    g = torch.randn(shape, generator=gen)
    loss = (out * g.to(cuda)).sum() + scale.square().sum() + bias.sum()
    grads = torch.autograd.grad(loss, leaves)
    assert _counters_at_zero(y)
    assert passport_epilogue_backward.launches == bwd + 1
    assert passport_epilogue.launches == fwd + 1

    cpu = [t.detach().cpu().requires_grad_(True) for t in leaves]
    o, s, b = passport_epilogue_reference(*cpu, mean.cpu(), var.cpu())
    want = torch.autograd.grad((o * g).sum() + s.square().sum() + b.sum(),
                               cpu)
    torch.testing.assert_close(grads[0].cpu(), want[0], rtol=1e-5, atol=1e-6)
    for g_, w_ in zip(grads[1:], want[1:]):
        torch.testing.assert_close(g_.cpu(), w_, **BWD_SUM_TOL)


@pytest.mark.cuda
def test_epilogue_bf16_under_autograd_raises(cuda):
    args = _epilogue_args((4, 512, 4, 4), cuda, seed=8)
    args[1].requires_grad_(True)
    args[0] = args[0].to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="K2-bwd"):
        passport_epilogue(*args)
    with torch.no_grad():  # no gradient wanted: the forward kernel runs
        passport_epilogue(*args)


# ------------------------------------------------------------------ K1

@pytest.fixture(scope="module")
def sets():
    """The training slice's resident set (12,800 x 32x32x3) and the tests'
    64 x 16x16x3 one, uint8, made on the host."""
    rng = np.random.default_rng(0)
    return {32: torch.from_numpy(rng.integers(0, 256, (12800, 32, 32, 3),
                                              dtype=np.uint8)),
            16: torch.from_numpy(rng.integers(0, 256, (64, 16, 16, 3),
                                              dtype=np.uint8)),
            15: torch.from_numpy(rng.integers(0, 256, (64, 15, 15, 3),
                                              dtype=np.uint8))}


def _extremes(pad):
    """Every extreme draw: offsets 0 and 2*pad, flip off and on, twice."""
    rows = [(oy, ox, f) for oy in (0, 2 * pad) for ox in (0, 2 * pad)
            for f in (0, 1)] * 2
    t = torch.tensor(rows, dtype=torch.int32)
    return tuple(t[:, i].contiguous() for i in range(3))


# (set side, batch, pad, extreme draws): the training batch, batch 1 and
# 13, the tests' 16x16 shape, and a 15x15x3 set (H*W*C = 675 not a multiple
# of 16, W not one of 4: byte copies and scalar stores)
AUGMENT_CASES = {"B256": (32, 256, 4, False), "B1": (32, 1, 4, False),
                 "B13": (32, 13, 4, False), "B16_16x16": (16, 16, 2, False),
                 "extremes": (32, 16, 4, True),
                 "B1_15x15": (15, 1, 2, False), "B13_15x15": (15, 13, 2, False),
                 "extremes_15x15": (15, 16, 2, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(AUGMENT_CASES))
def test_augment_kernel_matches_plain_version(cuda, sets, case):
    side, b, pad, extreme = AUGMENT_CASES[case]
    ds = sets[side].to(cuda)
    gen = torch.Generator().manual_seed(b)
    idx = torch.randperm(ds.shape[0], generator=gen)[:b].int().to(cuda)
    draws = _extremes(pad) if extreme else draw_augment(gen, b, pad)
    draws = tuple(t.to(cuda) for t in draws)
    for stats, exact in (((torch.zeros(3, device=cuda),
                           torch.ones(3, device=cuda)), True),
                         (scaled_stats(device=cuda), False)):
        before = fused_augment.launches
        got = fused_augment(ds, idx, *draws, *stats, pad)
        torch.cuda.synchronize()
        assert fused_augment.launches == before + 1
        want = augment_reference(ds[idx.long()], *draws, pad, *stats)
        assert got.shape == (b, 3, side, side)
        if exact:  # the gathered, cropped, flipped pixels bit for bit
            assert torch.equal(got, want)
        else:  # tests/test_pallas_augment.py's tolerance
            torch.testing.assert_close(got, want, rtol=0, atol=3e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(AUGMENT_CASES))
def test_augment_bf16_kernel_matches_plain_version_bit_for_bit(cuda, sets,
                                                               case):
    side, b, pad, extreme = AUGMENT_CASES[case]
    ds = sets[side].to(cuda)
    gen = torch.Generator().manual_seed(b + 1)
    idx = torch.randperm(ds.shape[0], generator=gen)[:b].int().to(cuda)
    draws = _extremes(pad) if extreme else draw_augment(gen, b, pad)
    draws = tuple(t.to(cuda) for t in draws)
    stats = scaled_stats(device=cuda)
    before = fused_augment.launches
    got = fused_augment(ds, idx, *draws, *stats, pad, torch.bfloat16)
    torch.cuda.synchronize()
    assert fused_augment.launches == before + 1
    want = augment_reference(ds[idx.long()], *draws, pad, *stats,
                             torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 3, side, side)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_augment_bf16_kernel_misaligned_set(cuda, sets):
    """A set one byte past a 16-byte boundary takes the byte copies (the
    15x15 cases above take the scalar stores); bit for bit all the same."""
    ds = sets[32][:64]
    flat = torch.zeros(ds.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = flat[1:].view(ds.shape)
    shifted.copy_(ds.to(cuda))
    gen = torch.Generator().manual_seed(5)
    idx = torch.randperm(64, generator=gen)[:13].int().to(cuda)
    draws = tuple(t.to(cuda) for t in draw_augment(gen, 13, 4))
    stats = scaled_stats(device=cuda)
    got = fused_augment(shifted, idx, *draws, *stats, 4, torch.bfloat16)
    want = augment_reference(shifted[idx.long()], *draws, 4, *stats,
                             torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_augment_kernel_misaligned_set(cuda, sets):
    """A set that starts one byte past a 16-byte boundary takes the byte
    copies, and its pixels still agree bit for bit."""
    ds = sets[32][:64]
    flat = torch.zeros(ds.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = flat[1:].view(ds.shape)
    shifted.copy_(ds.to(cuda))
    _, h, w, c = ds.shape
    assert not augment_geometry(13, h, w, c, shifted.data_ptr(), 0).vector_load
    gen = torch.Generator().manual_seed(3)
    idx = torch.randperm(64, generator=gen)[:13].int().to(cuda)
    draws = tuple(t.to(cuda) for t in draw_augment(gen, 13, 4))
    stats = (torch.zeros(3, device=cuda), torch.ones(3, device=cuda))
    got = fused_augment(shifted, idx, *draws, *stats, 4)
    want = augment_reference(shifted[idx.long()], *draws, 4, *stats)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["mixed_devices", "float_set", "strided"])
def test_augment_wrapper_rejects(cuda, sets, fault):
    ds = sets[16].to(cuda)
    draws = [t.to(cuda) for t in draw_augment(torch.Generator(), 4, 2)]
    args = [ds, torch.arange(4, dtype=torch.int32, device=cuda), *draws,
            *scaled_stats(device=cuda), 2]
    if fault == "mixed_devices":
        args[1] = args[1].cpu()
    elif fault == "float_set":
        args[0] = ds.float()
    else:
        args[0] = ds[:, :, ::2]
    before = fused_augment.launches
    with pytest.raises((TypeError, ValueError)):
        fused_augment(*args)
    assert fused_augment.launches == before


# ---------------------------------------------------------------- train

@pytest.mark.cuda
def test_split_private_train_step_matches_cpu(cuda):
    """One ResNet9 V2 split-private step (K1 on the card, its plain version
    on the CPU) from the same weights and draws; chip_smoke.py's
    card-vs-CPU tolerance (convolutions sum in other orders)."""
    kw, _ = construct_passport_kwargs(
        load_passport_config(str(CONFIGS / "resnet9_passport.json")),
        "bn", "shuffle", 0.1)
    cpu_model = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                            input_size=16, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    rng = np.random.default_rng(1)
    batch = {"image": rng.integers(0, 256, (16, 16, 16, 3), dtype=np.uint8),
             "label": rng.integers(0, 10, 16)}
    draws = draw_augment(torch.Generator().manual_seed(2), 16, 2)
    metrics = {}
    for dev, model in (("cpu", cpu_model), (cuda, gpu_model)):
        step = make_train_step(
            model, True, pad=2, device=dev,
            draws=lambda step, n, dev=dev: tuple(t.to(dev) for t in draws))
        _, metrics[str(dev)] = step(TrainState.create(model, 0.01), batch)
    for k, v in metrics["cpu"].items():
        torch.testing.assert_close(metrics["cuda"][k].cpu(), v, rtol=1e-3,
                                   atol=1e-4, msg=k)
    want = cpu_model.state_dict()
    for name, t in gpu_model.state_dict().items():
        torch.testing.assert_close(t.cpu(), want[name], rtol=1e-3, atol=1e-4,
                                   msg=name)


# K1 at 224 px, where an image takes 4 tiles of 56 rows (a 672-byte source
# row, 73 rows in the shared memory): the ImageNet stream's normalize (pad
# 0, zero draws), every extreme draw at pad 28 (a tile's source rows offset
# by the crop), and 223x223 (669-byte rows: byte loads, scalar stores)
K1_224_CASES = {"224_pad0_zero_draws": (224, 16, 0, "zero"),
                "224_pad28_extremes": (224, 16, 28, "extremes"),
                "223_pad28": (223, 8, 28, "random")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(K1_224_CASES))
def test_augment_kernel_at_224_matches_plain_version(cuda, case, dtype):
    side, b, pad, kind = K1_224_CASES[case]
    rng = np.random.default_rng(side)
    ds = torch.from_numpy(rng.integers(0, 256, (24, side, side, 3),
                                       dtype=np.uint8)).to(cuda)
    gen = torch.Generator().manual_seed(b)
    idx = torch.randperm(ds.shape[0], generator=gen)[:b].int().to(cuda)
    draws = {"zero": lambda: (torch.zeros(b, dtype=torch.int32),) * 3,
             "extremes": lambda: _extremes(pad),
             "random": lambda: draw_augment(gen, b, pad)}[kind]()
    draws = tuple(t.to(cuda) for t in draws)
    for stats, tol in (((torch.zeros(3, device=cuda),
                         torch.ones(3, device=cuda)), None),
                       (scaled_stats(device=cuda), dict(rtol=0, atol=3e-7))):
        got = fused_augment(ds, idx, *draws, *stats, pad, dtype)
        torch.cuda.synchronize()
        want = augment_reference(ds[idx.long()], *draws, pad, *stats, dtype)
        assert got.dtype == dtype and got.shape == (b, 3, side, side)
        if tol is None or dtype == torch.bfloat16:  # bit for bit
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
def test_prefetch_onto_the_card_equals_a_hand_moved_batch(cuda):
    """Batches through pinned buffers and the side stream equal the same
    arrays moved by hand, with work queued on the consumer's stream
    between reads and more batches than the ring has slots."""
    from deepipr_tpu_torch.data.prefetch import prefetch

    rng = np.random.default_rng(3)
    batches = [{"image": rng.integers(0, 256, (8, 32, 32, 3),
                                      dtype=np.uint8),
                "label": rng.integers(0, 10, 8).astype(np.int32),
                "weight": rng.random(8).astype(np.float32)}
               for _ in range(9)]
    seen = 0
    for got, want in zip(prefetch(iter(batches), size=2, device=cuda),
                         batches):
        for k, v in want.items():
            assert got[k].device.type == "cuda"
            assert torch.equal(got[k], torch.as_tensor(v).to(cuda)), k
        torch.cuda._sleep(100_000)  # the step keeps the stream busy
        seen += 1
    assert seen == len(batches)
