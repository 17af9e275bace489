"""FLOPs and kernel bytes at the cells' shapes, against hand counts."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, harness
from portbench.reference.resnet import RefResNet

R18 = harness.load_json(harness.HERE / "configs"
                        / "resnet18-private-v2-cifar10.json")
R50 = harness.load_json(harness.HERE / "configs"
                        / "resnet50-private-v2-cifar10.json")


def _mac(cin, cout, k, hw):
    return cin * cout * k * k * hw * hw


def test_resnet18_forward_by_hand():
    # CIFAR ResNet-18: stem 3->64 at 32x32; four 3x3 64->64 at 32x32;
    # layer2-4 each: a strided 3x3, three 3x3 and a 1x1 shortcut
    stem = _mac(3, 64, 3, 32)
    layer1 = 4 * _mac(64, 64, 3, 32)
    stage = lambda cin, c, hw: (_mac(cin, c, 3, hw) + 3 * _mac(c, c, 3, hw)
                                + _mac(cin, c, 1, hw))
    f = counts.forward_flops(R18)
    assert f["prefix"] == 2 * (stem + layer1 + stage(64, 128, 16)
                               + stage(128, 256, 8))
    assert f["suffix"] == f["passport"] == 2 * stage(256, 512, 4)
    assert f["head"] == 2 * 512 * 10
    # 0.42 GMAC of prefix and 0.134 of layer4, the suffix twice, the
    # passports' two rows a step, backward twice the forward: 4.14 GFLOP an
    # image
    step = counts.train_step_flops(R18, 256)
    assert step == 3 * (256 * (f["prefix"] + 2 * f["suffix"] + 2 * f["head"])
                        + 2 * f["passport"])
    assert step / 256 == pytest.approx(4.144e9, rel=1e-3)


def test_resnet50_layer4_by_hand():
    # layer4 at 4x4 out of 8x8: block 0 (1x1 1024->512 at 8x8, 3x3 s2,
    # 1x1 512->2048, shortcut 1x1 s2 1024->2048), blocks 1-2 alike
    b0 = (_mac(1024, 512, 1, 8) + _mac(512, 512, 3, 4) + _mac(512, 2048, 1, 4)
          + _mac(1024, 2048, 1, 4))
    rest = _mac(2048, 512, 1, 4) + _mac(512, 512, 3, 4) \
        + _mac(512, 2048, 1, 4)
    assert counts.forward_flops(R50)["suffix"] == 2 * (b0 + 2 * rest)


@pytest.mark.parametrize("config", [R18, R50], ids=["r18", "r50"])
@pytest.mark.parametrize("ind", [0, 1])
def test_forward_flops_match_torch_counter(config, ind):
    """torch's FLOP counter over the reference's forward at batch 2 counts
    the convolutions and the head alike (the private branch convolves each
    passport block's key and skey as one row each)."""
    ref = RefResNet(config)
    x = torch.zeros(2, 3, 32, 32)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref(x, ind)
    assert fc.get_total_flops() == counts.infer_request_flops(config, 2, ind)


def test_k1_and_k2_bytes():
    # PERF.md's byte bounds at batch 256: K1 3.93 MB f32 and 2.36 MB bf16
    # of pixels, K2 16.85 MB at (256, 512, 4, 4) f32
    assert counts.k1_bytes(256, 32, 3, 4) == 786432 + 3145728 + 4096 + 24
    assert counts.k1_bytes(256, 32, 3, 2) == 786432 + 1572864 + 4096 + 24
    assert counts.k2_bytes(256, 512, 4, 4, 4) == 16850944
    assert counts.k2_bytes(1024, 512, 4, 4, 2) == 2 * 1024 * 512 * 16 * 2 \
        + 2 * 512 * 16 * 4 + 16 * 512


def test_k2_shapes():
    assert counts.k2_shapes(R18, 1024) == [(1024, 512, 4, 4)] * 5
    shapes = counts.k2_shapes(R50, 8)
    assert len(shapes) == 10 and shapes[0] == (8, 512, 8, 8)
    assert shapes.count((8, 2048, 4, 4)) == 4
    json.dumps(shapes)
