"""The plain reference against the port on the CPU at a small batch, on the
same values: a forward of each branch, a V2 train step, and bf16."""

import pytest
import torch

from portbench import harness
from portbench.inputs import draw_table, make_values, train_set
from portbench.models import build_port_model, leaf_shapes, reference_model
from portbench.reference.resnet import SGD, augment, train_step

harness.import_program()
CPU = torch.device("cpu")
CONFIGS = {name: harness.load_json(harness.HERE / "configs" / f"{name}.json")
           for name in ("resnet18-private-v2-cifar10",
                        "resnet50-private-v2-cifar10")}


def _pair(name, dtype="float32", seed=5):
    config = CONFIGS[name]
    values = make_values(leaf_shapes(config), seed, CPU)
    return (build_port_model(config, dtype, values, CPU),
            reference_model(config, dtype, values, CPU), values)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().pow(2).mean().sqrt())


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("ind", [0, 1])
def test_forward_of_each_branch(name, ind):
    port, ref, _ = _pair(name)
    x = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = port(x, ind=ind)
        want, aux = ref.eval()(x, ind)
    assert _rel(got.logits, want) < 1e-5
    assert len(got.aux) == len(aux) == (0 if ind == 0 else
                                        len(ref.passport_blocks()))
    for path, a in got.aux.items():
        scale, bias, _, _ = aux[path.replace("/", ".")]
        assert _rel(a["scale"], scale) < 1e-5
        assert _rel(a["bias"], bias) < 1e-5


def test_bf16_forward():
    port, ref, _ = _pair("resnet18-private-v2-cifar10", "bfloat16")
    x = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for ind in (0, 1):
            assert _rel(port(x, ind=ind).logits, ref.eval()(x, ind)[0]) \
                < 2e-2


def test_v2_train_step():
    """One split V2 step of the port (K1's plain version, BN statistics
    re-applied to the prefix, W3) against the reference's two whole
    forwards: the loss, every parameter's gradient and update, and every
    running statistic."""
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.train.steps import make_train_step

    name = "resnet18-private-v2-cifar10"
    port, ref, values = _pair(name)
    b, pad, lr, wd = 8, 4, 0.01, 1e-4
    images, labels = train_set(3, b, 32, 3, 10, CPU)
    table = draw_table(3, 1, b, pad, CPU)
    state = TrainState.create(port, lr, momentum=0.9, weight_decay=wd)
    step = make_train_step(port, True, pad=pad, device=CPU,
                           draws=lambda s, n: tuple(t[s] for t in table))
    _, metrics = step(state, {"image": images, "label": labels})
    opt = SGD(ref, lr, 0.9, wd)
    loss, grads = train_step(ref, opt, augment(images, *(t[0] for t in table),
                                               pad), labels)
    assert float(metrics["loss"] + metrics["sign_loss"]) == pytest.approx(
        loss, rel=1e-5)
    got = dict(port.named_parameters())
    norms = sorted(float(g.norm()) for g in grads.values())
    med = norms[len(norms) // 2]
    for n, p in ref.named_parameters():
        buf = state.optimizer.state[got[n]]["momentum_buffer"]
        scale = max(float(grads[n].norm()), med)
        # a pre-ReLU value within rounding of 0 flips between the two and
        # moves whole gradients: the port's own CPU bound, 5 % of a norm
        assert float((buf - wd * values[n] - grads[n]).norm()) / scale < 5e-2
        moved = p.detach() - values[n]
        assert float((got[n].detach() - values[n] - moved).norm()) \
            / float(moved.norm()) < 5e-2
    buffers = dict(port.named_buffers())
    for n, v in ref.named_buffers():
        assert torch.allclose(buffers[n], v, rtol=1e-5, atol=1e-6), n
