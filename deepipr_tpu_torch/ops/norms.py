"""Normalization layers matching the reference's norm-type choices.

Counterpart of ``deepipr_tpu/ops/norms.py``. The reference uses
(models/layers/conv2d.py:11-18, passportconv2d.py:56-64):

- 'bn': BatchNorm2d (affine for normal blocks, affine-free for passport blocks)
- 'gn': GroupNorm with C//16 groups
- 'in': InstanceNorm2d (affine-free, no running stats)
- 'none': identity

Train-mode BN holds to the JAX package's (flax's) conventions:

- W1: the running variance stores the *biased* batch variance (torch's
  ``nn.BatchNorm2d`` stores the unbiased one);
- W2: the running-stat EMA is ``running = 0.9*running + 0.1*batch``
  (flax momentum 0.9, torch's momentum 0.1). Epsilon is 1e-5.

Under ``remat="full"`` (train/steps.py) the backward recomputes each
block's forward; ``running_stats_frozen()`` is entered for that
recomputation, so the running statistics take the EMA once a forward, as
the JAX package's functional statistics do.

Under bf16 (flax's ``BatchNorm(dtype=bf16)`` and ``GroupNorm(dtype=bf16)``)
a norm takes the block's bf16 activations and returns bf16: statistics,
running buffers and affine parameters stay f32, and the normalize runs in
f32 and is rounded once.

On a mesh (train/steps.py with ``mesh=``) each rank holds its rows of the
global batch. Flax's BN under the JAX package's mesh takes its mean over
the sharded batch axis, which XLA makes a global reduction: it normalizes
with the whole global batch's statistics, the weight-0 padding rows
included. Inside ``synced_batch_stats(group)`` train-mode BN does the same
(``_SyncBatchNorm``): the forward sums each channel over the group's ranks
in f32, first the sum, then the centred sum of squares (the two passes of
``var_mean``), and the backward sums dy and dy*x_hat over them. The
running statistics then take the global batch's mean and biased variance,
equal on every rank. ``torch.nn.SyncBatchNorm`` cannot stand in: it has
no CPU path. Without a group, or with a group of one rank, the code and
the bits are the single-process ones.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5
# running = BN_MOMENTUM*running + (1-BN_MOMENTUM)*batch; the split dual
# forward re-applies this EMA for prefix units (train/steps.py)
BN_MOMENTUM = 0.9

_frozen = threading.local()
# the 'batch' process group whose ranks share train-mode BN statistics
# (synced_batch_stats); a process-wide setting, since a remat
# recomputation runs in autograd's threads
_sync = {"group": None, "size": 1}


@contextlib.contextmanager
def synced_batch_stats(group, size: int) -> Iterator[None]:
    """Train-mode BN takes its statistics over the rows of every rank of
    ``group`` (``size`` ranks, each with as many rows) while inside."""
    before = dict(_sync)
    _sync.update(group=group, size=size)
    try:
        yield
    finally:
        _sync.update(before)


def _channel_sum(t: torch.Tensor) -> torch.Tensor:
    return t.sum(dim=(0, 2, 3))


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BN over the rows of every rank of a group: returns
    (y, batch mean, biased batch variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, size):
        import torch.distributed as dist

        xf = x.to(torch.float32)
        count = x.numel() // x.shape[1] * size
        total = _channel_sum(xf)
        dist.all_reduce(total, group=group)
        mean = total / count
        centred = xf - _per_channel(mean)
        sq = _channel_sum(centred * centred)
        dist.all_reduce(sq, group=group)
        var = sq / count
        invstd = torch.rsqrt(var + eps)
        xhat = centred * _per_channel(invstd)
        y = xhat
        if weight is not None:
            y = y * _per_channel(weight) + _per_channel(bias)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.group, ctx.count = group, count
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        import torch.distributed as dist

        xhat, invstd, weight = ctx.saved_tensors
        dyf = dy.to(torch.float32)
        sum_dy = _channel_sum(dyf)
        sum_dy_xhat = _channel_sum(dyf * xhat)
        # the affine's gradients are this rank's part; the step's gradient
        # all-reduce sums them over the ranks
        dweight = sum_dy_xhat.clone() if weight is not None else None
        dbias = sum_dy.clone() if weight is not None else None
        both = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(both, group=ctx.group)
        mean_dy, mean_dy_xhat = (both / ctx.count).chunk(2)
        scale = invstd if weight is None else invstd * weight
        dx = _per_channel(scale) * (dyf - _per_channel(mean_dy)
                                    - xhat * _per_channel(mean_dy_xhat))
        return dx.to(dy.dtype), dweight, dbias, None, None, None


@contextlib.contextmanager
def running_stats_frozen() -> Iterator[None]:
    """Train-mode BN in this thread normalizes with the batch statistics
    and leaves its running statistics as they are: the context of a
    checkpointed block's recomputation, whose forward already took the
    EMA."""
    before = getattr(_frozen, "on", False)
    _frozen.on = True
    try:
        yield
    finally:
        _frozen.on = before


class BatchNorm(nn.Module):
    """BN over (N, H, W) per channel, with ``running_mean``/``running_var``.

    Eval mode normalizes with the running statistics. Train mode normalizes
    with the batch's mean and biased variance and folds both into the
    running statistics (W1, W2), in place.
    """

    def __init__(self, features: int, affine: bool = True, eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None
            # an f32 identity affine for bf16 inputs: with f32 parameters
            # F.batch_norm normalizes a bf16 input in f32 and rounds once
            self.register_buffer("unit_weight", torch.ones(features),
                                 persistent=False)
            self.register_buffer("unit_bias", torch.zeros(features),
                                 persistent=False)

    def running_stats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var), for consumers that fuse the normalize (the epilogue);
        eval mode only, since train mode normalizes with batch statistics."""
        if self.training:
            raise RuntimeError("running_stats() is for eval mode; train-mode "
                               "BN normalizes with batch statistics")
        return self.running_mean, self.running_var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight, self.bias
        if weight is None and x.dtype != torch.float32:
            weight, bias = self.unit_weight, self.unit_bias
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, False, 0.0, self.eps)
        if _sync["size"] > 1:
            y, mean, var = _SyncBatchNorm.apply(
                x, self.weight, self.bias, self.eps, _sync["group"],
                _sync["size"])
            if not getattr(_frozen, "on", False):
                with torch.no_grad():
                    for buf, batch in ((self.running_mean, mean),
                                       (self.running_var, var)):
                        buf.mul_(BN_MOMENTUM).add_(batch,
                                                   alpha=1.0 - BN_MOMENTUM)
            return y
        if getattr(_frozen, "on", False):
            return F.batch_norm(x, None, None, weight, bias, True, 0.0,
                                self.eps)
        # the running buffers stay out of F.batch_norm, which would store the
        # unbiased variance (W1); the statistics are taken in f32
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(torch.float32), dim=(0, 2, 3),
                                       correction=0)
            for buf, batch in ((self.running_mean, mean),
                               (self.running_var, var)):
                buf.mul_(BN_MOMENTUM).add_(batch, alpha=1.0 - BN_MOMENTUM)
        return F.batch_norm(x, None, None, weight, bias, True, 0.0, self.eps)


class GroupNorm(nn.Module):
    """GroupNorm; InstanceNorm is the one-channel-per-group case."""

    def __init__(self, num_groups: int, features: int, affine: bool,
                 eps: float = EPS):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.to(torch.float32), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


def make_norm(norm_type: str, features: int,
              affine: Optional[bool] = None) -> Optional[nn.Module]:
    """The norm submodule for a block; None for norm_type='none'.

    ``affine=None`` picks the torch default per norm type: BN/GN affine,
    InstanceNorm affine-free.
    """
    if norm_type == "bn":
        return BatchNorm(features, affine=True if affine is None else affine)
    if norm_type == "gn":
        if features % 16 != 0:
            raise ValueError(f"GroupNorm requires features % 16 == 0, got {features}")
        return GroupNorm(features // 16, features,
                         affine=True if affine is None else affine)
    if norm_type == "in":
        return GroupNorm(features, features,
                         affine=False if affine is None else affine)
    if norm_type == "none":
        return None
    raise ValueError(f"unknown norm type: {norm_type}")


def apply_norm(norm: Optional[nn.Module], x: torch.Tensor) -> torch.Tensor:
    return x if norm is None else norm(x)
