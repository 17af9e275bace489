"""Plain PyTorch reference of the V2 (private passport) ResNet on CIFAR shapes.

It follows the JAX package's equations (``deepipr_tpu/models/resnet.py``,
``models/layers.py``, ``ops/norms.py``, ``train/steps.py``) and the
original DeepIPR reference they port, written again in plain ``torch``
operations, with no kernel, fusion or split of the program:

- BatchNorm: train mode normalizes with the batch mean and the *biased*
  variance and folds both into the running statistics with flax's momentum,
  ``running = 0.9 * running + 0.1 * batch``; eval mode uses the running
  statistics. Epsilon 1e-5.
- BasicBlock: convbnrelu_1 -> convbn_2 (with a ReLU, the reference's quirk)
  -> + shortcut (a ConvBlock with a ReLU, the same quirk) -> ReLU.
  Bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (no ReLU) + shortcut (no ReLU)
  -> ReLU.
- A passport block: conv (no bias) -> affine-free BN -> ``scale * y +
  bias`` (-> ReLU). Public branch (ind=0): learned scale and bias. Private
  branch (ind=1): ``scale = mean(conv(skey))``, ``bias = mean(conv(key))``
  over (batch, H, W), the block's own convolution on its passports.
- The V2 train step runs two whole forwards, public then private, each of
  which updates the BN running statistics (the original trainer's order,
  which the program's split step reproduces with its re-applied EMA, W3);
  loss = CE(public) + CE(private) + the private branch's sign losses,
  ``sum(alpha * relu(0.1 - b * scale)) + 1e-5 * sum(scale ** 2)``; SGD with
  momentum 0.9 and weight decay added to the gradient before the momentum,
  applied to every parameter.
- The input stage: zero-pad, crop at the drawn offsets, flip, normalize with
  255 * ImageNet mean and std in float32.
- Compute dtype (the configuration's precision; float32 or bfloat16), as
  the JAX package's ``dtype=`` rounds: a convolution takes its input and
  weight in it and returns it; BN takes its statistics and normalizes in
  float32 and rounds once; a passport block's scale and bias, float32, are
  rounded to it before the affine, which runs in it, as do the ReLUs and the
  residual sums; the passports' convolutions return float32, and the global
  average pool, the head, the losses and every weight stay float32. In
  float32 every rounding is the identity.

``lower`` runs every convolution and the head's matmul with their operands
rounded to a lower precision (reference/lower.py): the control of the
comparison that decides ``correct``. This package imports nothing of the
program it judges.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.lower import Lower, low_conv2d, low_linear

EPS = 1e-5
BN_MOMENTUM = 0.9
HINGE_MARGIN = 0.1
SCALE_REG = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# (planes, stride) of layer1..layer4
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))

Aux = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]


def pin_ieee_f32() -> None:
    """Float32 convolutions and matmuls on the card in IEEE float32 (torch
    would run cuDNN's in TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int, pad: int,
                 dtype: torch.dtype):
        super().__init__()
        self.stride, self.pad, self.dtype = stride, pad, dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))

    def forward(self, x, lower: Optional[Lower] = None):
        if lower is None:
            return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                            stride=self.stride, padding=self.pad)
        return low_conv2d(x.float(), self.weight, self.stride, self.pad,
                          lower).to(self.dtype)


class BN(nn.Module):
    def __init__(self, c: int, affine: bool):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(c))
            self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        dtype, x = x.dtype, x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
            with torch.no_grad():
                for run, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                    run.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * batch)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean[None, :, None, None]) / torch.sqrt(
            var[None, :, None, None] + EPS)
        if self.affine:
            y = y * self.weight[None, :, None, None] \
                + self.bias[None, :, None, None]
        return y.to(dtype)


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, k, stride, pad, relu, dtype):
        super().__init__()
        self.relu = relu
        self.conv = Conv(cin, cout, k, stride, pad, dtype)
        self.bn = BN(cout, affine=True)

    def forward(self, x, ind: int, lower=None):
        y = self.bn(self.conv(x, lower))
        return (F.relu(y) if self.relu else y), None


class PassportBlock(nn.Module):
    def __init__(self, cin, cout, k, stride, pad, relu, in_hw, alpha, dtype):
        super().__init__()
        self.relu, self.alpha = relu, alpha
        self.conv = Conv(cin, cout, k, stride, pad, dtype)
        self.bn = BN(cout, affine=False)
        self.register_buffer("key", torch.zeros(1, cin, *in_hw))
        self.register_buffer("skey", torch.zeros(1, cin, *in_hw))
        self.register_buffer("b", torch.ones(cout))
        self.scale = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def derived(self, lower=None) -> Tuple[torch.Tensor, torch.Tensor]:
        scale = self.conv(self.skey, lower).float().mean(dim=(0, 2, 3))
        bias = self.conv(self.key, lower).float().mean(dim=(0, 2, 3))
        return scale, bias

    def forward(self, x, ind: int, lower=None):
        y = self.bn(self.conv(x, lower))
        aux = None
        if ind == 0:
            scale, bias = self.scale, self.bias
        else:
            scale, bias = self.derived(lower)
            aux = (scale, bias, self.b, self.alpha)
        y = scale.to(y.dtype)[None, :, None, None] * y \
            + bias.to(y.dtype)[None, :, None, None]
        return (F.relu(y) if self.relu else y), aux


def conv_out(hw: Tuple[int, int], k: int, s: int, p: int) -> Tuple[int, int]:
    return tuple((d + 2 * p - k) // s + 1 for d in hw)


def _block(flag, cin, cout, k, s, p, relu, in_hw, alpha, dtype):
    if flag:
        return PassportBlock(cin, cout, k, s, p, relu, in_hw, alpha, dtype)
    return ConvBlock(cin, cout, k, s, p, relu, dtype)


class Unit(nn.Module):
    """A residual block: its sub-blocks in call order, each (name, k,
    stride, pad, relu, cin, cout, input hw), and whether the shortcut is a
    block or the identity."""

    def __init__(self, subs, flags: Dict[str, object], alpha: float,
                 dtype: torch.dtype):
        super().__init__()
        self.names = []
        for name, k, s, p, relu, cin, cout, hw in subs:
            self.add_module(name, _block(bool(flags.get(name)), cin, cout, k,
                                         s, p, relu, hw, alpha, dtype))
            self.names.append(name)

    def forward(self, x, ind: int, lower=None):
        aux = {}
        out = x
        for name in self.names:
            if name == "shortcut":
                continue
            out, aux[name] = getattr(self, name)(out, ind, lower)
        if "shortcut" in self.names:
            sc, aux["shortcut"] = self.shortcut(x, ind, lower)
        else:
            sc = x
        return F.relu(out + sc), aux


def _unit_subs(bottleneck: bool, cin: int, planes: int, stride: int,
               hw: Tuple[int, int]):
    """Sub-blocks of one residual block and its output (channels, hw)."""
    out_hw = conv_out(hw, 3, stride, 1)
    if bottleneck:
        cout = 4 * planes
        subs = [("convbnrelu_1", 1, 1, 0, True, cin, planes, hw),
                ("convbnrelu_2", 3, stride, 1, True, planes, planes, hw),
                ("convbn_3", 1, 1, 0, False, planes, cout, out_hw)]
        sc_relu = False
    else:
        cout = planes
        subs = [("convbnrelu_1", 3, stride, 1, True, cin, planes, hw),
                ("convbn_2", 3, 1, 1, True, planes, planes, out_hw)]
        sc_relu = True
    if stride != 1 or cin != cout:
        subs.append(("shortcut", 1, stride, 0, sc_relu, cin, cout, hw))
    return subs, cout, out_hw


def layer_specs(config: Dict) -> List[Tuple[str, List[tuple]]]:
    """[(unit name, sub-blocks)] of the configuration's network, each
    sub-block (name, k, stride, pad, relu, cin, cout, input hw, passport
    flag): the shapes the reference is built from and the benchmark counts
    FLOPs from (portbench/counts.py)."""
    pk = config["passport_config"]
    size = config["input_size"]
    hw = (size, size)
    units = [("convbnrelu_1", [("convbnrelu_1", 3, 1, 1, True,
                                config["channels"], 64, hw,
                                bool(pk["convbnrelu_1"]))])]
    bottleneck = config["block"] == "bottleneck"
    cin = 64
    for li, ((planes, stride), n) in enumerate(
            zip(STAGES, config["num_blocks"]), start=1):
        for bi in range(n):
            subs, cin_next, hw_next = _unit_subs(
                bottleneck, cin, planes, stride if bi == 0 else 1, hw)
            flags = pk[f"layer{li}"][str(bi)]
            units.append((f"layer{li}_{bi}",
                          [s + (bool(flags.get(s[0])),) for s in subs]))
            cin, hw = cin_next, hw_next
    return units


class RefResNet(nn.Module):
    """The configuration's V2 ResNet in compute dtype ``dtype``; module and
    leaf names are the program's state-dict names
    (``layer4_0.convbnrelu_1.conv.weight``)."""

    def __init__(self, config: Dict, dtype: torch.dtype = torch.float32):
        super().__init__()
        alpha = float(config["sign_loss"])
        self.unit_names = []
        for unit, subs in layer_specs(config):
            if unit == "convbnrelu_1":
                name, k, s, p, relu, cin, cout, hw, flag = subs[0]
                self.convbnrelu_1 = _block(flag, cin, cout, k, s, p, relu,
                                           hw, alpha, dtype)
            else:
                flags = {sub[0]: sub[-1] for sub in subs}
                self.add_module(unit, Unit([sub[:-1] for sub in subs], flags,
                                           alpha, dtype))
            self.unit_names.append(unit)
        width = 512 * (4 if config["block"] == "bottleneck" else 1)
        self.linear = nn.Linear(width, config["num_classes"])

    def forward(self, x, ind: int, lower: Optional[Lower] = None
                ) -> Tuple[torch.Tensor, Dict[str, Aux]]:
        """x: NCHW -> (float32 logits, {block path: (scale, bias, b,
        alpha)} of the private branch's passport blocks)."""
        aux: Dict[str, Aux] = {}
        for unit in self.unit_names:
            x, got = getattr(self, unit)(x, ind, lower)
            if unit == "convbnrelu_1":
                got = {"": got}
            for sub, a in got.items():
                if a is not None:
                    aux[f"{unit}.{sub}" if sub else unit] = a
        pooled = x.mean(dim=(2, 3), dtype=torch.float32)
        if lower is None:
            return self.linear(pooled), aux
        return low_linear(pooled, self.linear.weight, self.linear.bias,
                          lower), aux

    def passport_blocks(self) -> Dict[str, PassportBlock]:
        return {name: m for name, m in self.named_modules()
                if isinstance(m, PassportBlock)}


def sign_loss(aux: Dict[str, Aux]) -> torch.Tensor:
    return sum((alpha * torch.relu(HINGE_MARGIN - b * scale)).sum()
               + SCALE_REG * (scale * scale).sum()
               for scale, _, b, alpha in aux.values())


def augment(images_u8: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
            flip: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, C, H, W) float32: zero-pad by ``pad``, crop
    at (oy, ox), flip where ``flip``, normalize."""
    b, h, w, c = images_u8.shape
    dev = images_u8.device
    x = F.pad(images_u8.float(), (0, 0, pad, pad, pad, pad))
    rows = oy.long()[:, None] + torch.arange(h, device=dev)
    cols = ox.long()[:, None] + torch.arange(w, device=dev)
    x = x[torch.arange(b, device=dev)[:, None, None], rows[:, :, None],
          cols[:, None, :]]
    x = torch.where(flip.bool()[:, None, None, None], x.flip(2), x)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev) * 255.0
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


class SGD:
    """SGD with momentum; decay added to the gradient before the momentum;
    every parameter is updated."""

    def __init__(self, model: nn.Module, lr: float, momentum: float,
                 weight_decay: float):
        self.params = dict(model.named_parameters())
        self.lr, self.momentum, self.wd = lr, momentum, weight_decay
        self.bufs: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        for name, p in self.params.items():
            d = grads[name] + self.wd * p
            buf = self.bufs.get(name)
            buf = d.clone() if buf is None else buf.mul_(self.momentum).add_(d)
            self.bufs[name] = buf
            p.sub_(self.lr * buf)


def train_step(model: RefResNet, opt: SGD, x: torch.Tensor, y: torch.Tensor,
               lower: Optional[Lower] = None
               ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """One V2 step on the normalized NCHW batch ``x`` -> (CE(public) +
    CE(private) + sign loss, the step's gradient of every parameter)."""
    model.train()
    logits0, _ = model(x, 0, lower)
    logits1, aux = model(x, 1, lower)
    loss = F.cross_entropy(logits0, y) + F.cross_entropy(logits1, y) \
        + sign_loss(aux)
    names = list(opt.params)
    grads = torch.autograd.grad(loss, [opt.params[n] for n in names],
                                allow_unused=True)
    grads = {n: torch.zeros_like(opt.params[n]) if g is None else g
             for n, g in zip(names, grads)}
    opt.step(grads)
    return float(loss.detach()), grads
