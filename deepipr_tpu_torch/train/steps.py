"""Train and eval steps for all schemes, plus signature detection.

Counterpart of ``deepipr_tpu/train/steps.py``. Scheme semantics (reference
experiments/trainer.py, trainer_private.py):

- scheme 0 (baseline) / 1 (V1 passport): one forward; loss = CE + the sum of
  the passport layers' sign losses (V1 only).
- scheme 2 (V2) / 3 (V3): two forwards per batch, public ind=0 and private
  ind=1; loss = CE(pub) + CE(priv) + the private branch's sign losses; BN
  running statistics are updated by both forwards in turn
  (trainer_private.py:159-173). V3 concatenates a trigger batch.

The model holds its own weights, so a train step updates ``state`` in place
and returns it, keeping the JAX call shape ``step(state, batch) -> (state,
metrics)``; an eval step is called with a batch alone. ``batch["image"]`` is
NHWC as in the JAX package, ``batch["label"]`` integer class ids. Metrics
and sums stay device tensors; the ``run_*`` loops and the epoch read them
back once at the end.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from deepipr_tpu_torch.attacks.common import derived_affines
from deepipr_tpu_torch.data.device_augment import (
    Draws,
    draw_augment,
    normalize_device,
    scaled_stats,
)
from deepipr_tpu_torch.models.alexnet import DROPOUT_KEEP
from deepipr_tpu_torch.models.branching import branch_point
from deepipr_tpu_torch.ops.fused_augment import fused_augment
from deepipr_tpu_torch.ops.norms import (
    BN_MOMENTUM,
    BatchNorm,
    synced_batch_stats,
)
from deepipr_tpu_torch.parallel.mesh import (
    all_reduce_gradients,
    axis_group,
    axis_size,
    batch_rows,
    gather_model_parallel,
)
from deepipr_tpu_torch.passport.codec import bit_accuracy
from deepipr_tpu_torch.passport.sign_loss import total_sign_loss
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.utils.device import (
    DeviceLike,
    nhwc_to_nchw,
    require_on_device,
    resolve_device,
    seeded_generator,
)
from deepipr_tpu_torch.utils.mode import eval_mode
from deepipr_tpu_torch.utils.spans import span

DrawFn = Callable[[int, int], Draws]
# dropout(step, shapes) -> one boolean keep mask of each shape
DropoutFn = Callable[[int, Sequence[Tuple[int, ...]]], List[torch.Tensor]]
DROPOUT_STREAM = 1  # folded in after the step: apart from seeded_draws'


def cross_entropy_mean(logits, labels, weight=None):
    """Mean CE; with a per-sample weight vector, the weighted mean (weight-0
    samples pad a batch and do not count)."""
    ce = F.cross_entropy(logits, labels, reduction="none")
    if weight is None:
        return ce.mean()
    return (ce * weight).sum() / weight.sum().clamp(min=1.0)


def top1_accuracy(logits, labels, weight=None):
    """Percentage top-1 accuracy (reference accuracy(), trainer.py:28-43)."""
    hit = (logits.argmax(dim=-1) == labels).to(torch.float32)
    if weight is None:
        return 100.0 * hit.mean()
    return 100.0 * (hit * weight).sum() / weight.sum().clamp(min=1.0)


def collect_aux(aux: Dict[str, Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The model's derived-affine outputs as a list of aux dicts."""
    return list(aux.values())


def collect_aux_with_paths(aux: Dict[str, Dict[str, Any]]
                           ) -> List[Tuple[str, Dict[str, Any]]]:
    """The model's derived-affine outputs as (module path, aux) pairs."""
    return list(aux.items())


def seeded_draws(seed: int, pad: int, device: torch.device) -> DrawFn:
    """draws(step, n) -> (oy, ox, flip) on ``device``, a function of
    (seed, step) alone: the counterpart of ``fold_in(aug_root, step)``."""

    def draws(step: int, n: int) -> Draws:
        return draw_augment(seeded_generator(device, seed, step), n, pad)

    return draws


def zero_draws(device: torch.device) -> DrawFn:
    """draws(step, n) -> all-zero (oy, ox, flip) on ``device``: with pad 0,
    kernel K1 then only normalizes (the JAX package's ``normalize_device``,
    the ImageNet stream's device transform)."""

    def draws(step: int, n: int) -> Draws:
        zeros = torch.zeros(n, dtype=torch.int32, device=device)
        return zeros, zeros, zeros

    return draws


def seeded_dropout(seed: int, device: torch.device) -> DropoutFn:
    """dropout(step, shapes) -> keep masks (each unit kept with
    probability DROPOUT_KEEP) on ``device``, a function of (seed, step)
    alone: the counterpart of ``fold_in(drop_root, step)``, a stream apart
    from ``seeded_draws``'."""

    def dropout(step: int, shapes) -> List[torch.Tensor]:
        gen = seeded_generator(device, seed, step, DROPOUT_STREAM)
        return [torch.rand(shape, generator=gen, device=device) < DROPOUT_KEEP
                for shape in shapes]

    return dropout


def _bn_buffers(modules) -> List[torch.Tensor]:
    return [buf for m in modules for bn in m.modules()
            if isinstance(bn, BatchNorm)
            for buf in (bn.running_mean, bn.running_var)]


def _local_mean(values, weight, denom):
    """This rank's part of a mean over the global batch: sum(values *
    weight) / max(denom, 1), with ``denom`` the global sum of the weights
    (the global row count without weights), a tensor."""
    if weight is not None:
        values = values * weight
    return values.sum() / denom.clamp(min=1.0)


def make_train_step(model, private: bool, split_branches: bool = True,
                    pad: Optional[int] = None, remat: str = "none",
                    seed: int = 0, draws: Optional[DrawFn] = None,
                    dropout: Optional[DropoutFn] = None,
                    out_dtype: torch.dtype = torch.float32,
                    device: DeviceLike = "cuda", mesh=None):
    """Build the SGD train step for this model and scheme.

    Returns step(state, batch) -> (state, metrics), which updates ``state``
    (the model's weights and buffers, the momentum, the step counter) in
    place and puts the model in train mode. Metrics are detached device
    tensors: 'loss' (the CE part), 'sign_loss', 'sign_acc', and 'acc' or
    'acc_public'/'acc_private'.

    The batch's arrays may be NumPy or tensors already on ``device`` (the
    prefetcher's, data/prefetch.py), which are used without a copy.

    pad=None: ``batch["image"]`` is a normalized NHWC float batch. pad=int:
    it is raw uint8 NHWC, either the batch or, with ``batch["index"]``, the
    set the batch's rows are gathered from; kernel K1
    (ops/fused_augment.py) gathers, pads by ``pad``, crops, flips and
    normalizes in one launch, writing ``out_dtype`` (f32, or bf16 for a
    bf16 model, the JAX epoch's ``out_dtype``). Its draws come from
    ``draws(state.step, n)``, by default ``seeded_draws(seed, pad,
    device)``; tests inject JAX's; ``zero_draws`` with pad 0 normalizes
    only. V3: ``batch["wm_image"]`` (uint8) is
    normalized only, in the same dtype, and appended, with
    ``batch["wm_label"]``. ``batch["weight"]``: optional per-sample loss
    weights. The loss, the sign loss and the metrics are f32 whatever the
    model's dtype.

    A model with dropout (AlexNet's ImageNet head, ``dropout_shapes``)
    takes its keep masks from ``dropout(state.step, shapes)``, by default
    ``seeded_dropout(seed, device)``; tests inject JAX's. Every forward of
    a step uses the same masks, as the JAX step hands each the same
    dropout key.

    split_branches (private models): the public and private forwards agree
    up to the first passport block, so the shared prefix runs once and the
    private branch starts from its output (models/branching.py). The
    reference's two full forwards update the prefix's BN statistics twice
    with the same batch statistics; the split step re-applies the EMA to the
    prefix units (W3):
        r1 = m*r0 + (1-m)*s  (prefix ran once)
        r2 = m*r1 + (1-m)*s = r1 + m*(r1 - r0)
    Gradients are unchanged: CE0(f(x)) + CE1(g(f(x))) differentiates the
    prefix f once through both terms either way.

    remat="full": every unit of the model (ResNet's stem and blocks,
    AlexNet's conv blocks) keeps no activations, and the backward
    recomputes its forward (``torch.utils.checkpoint``), in each forward of
    the step, the split ones included. The recomputation normalizes with
    the same batch statistics and takes no EMA step (ops/norms.py), and the
    dropout masks are the step's arguments, so updates and running
    statistics are those of remat="none".

    mesh (parallel/mesh.py): the JAX package's step on a mesh, whose
    numbers are those of one device stepping the whole global batch. Every
    rank is handed the same global batch and keeps its rows
    (``batch_rows``, ``P("batch")``'s order): the draws and dropout masks
    are drawn for the global batch and sliced, and K1 gathers only this
    rank's rows; on V3's device path the rows run across the task images
    and the triggers appended to them. Then:

    - train-mode BN takes the global batch's statistics
      (ops/norms.py::synced_batch_stats);
    - the CE and the accuracies are this rank's part of the global
      weighted means, over the global sum of the weights;
    - the sign loss acts on the replicated passports and weights, so every
      rank makes the same gradient of it: each adds 1/shards of it, and the
      sum counts it once;
    - after ``backward()``, one all-reduce sums every parameter's gradient
      and the metric parts over the 'batch' group
      (``all_reduce_gradients``). This is not ``DistributedDataParallel``:
      the split step runs two forwards before its one backward, which
      DDP's reducer does not expect, and W10's zero gradients of the
      parameters a branch never uses must be summed as well;
    - with a 'model' axis, a state sharded by ``shard_model_parallel``
      runs its forward on whole weights gathered from the slices
      (``gather_model_parallel``).

    A mesh of one rank takes the single-process path.
    """
    if remat not in ("none", "full"):
        raise ValueError(f"remat must be 'none' or 'full', got {remat!r}")
    dev = resolve_device(device)
    require_on_device(model, dev)
    fork = branch_point(model) if private and split_branches else None
    prefix_bufs, snapshot = [], []
    if fork is not None:
        prefix_bufs = _bn_buffers(getattr(model, u) for u in fork[1])
        snapshot = [torch.empty_like(b) for b in prefix_bufs]
    if pad is not None:
        mean255, std255 = scaled_stats(device=dev)
        draws = draws or seeded_draws(seed, pad, dev)
    dropout = dropout or seeded_dropout(seed, dev)
    dropout_shapes = getattr(model, "dropout_shapes", lambda n: [])
    if mesh is not None and mesh.size() == 1:
        mesh = None
    shards = axis_size(mesh, "batch") if mesh is not None else 1

    def rows(n: int) -> Tuple[int, int]:
        return batch_rows(n, mesh) if mesh is not None else (0, n)

    def inputs(state: TrainState, batch):
        """(x, y, the global batch's size, this rank's rows [lo, hi))."""
        labels = batch["label"]
        if pad is None:
            lo, hi = rows(len(labels))
            y = torch.as_tensor(labels[lo:hi], device=dev).long()
            return (nhwc_to_nchw(batch["image"][lo:hi], dev), y,
                    len(labels), (lo, hi))
        images = torch.as_tensor(batch["image"], device=dev).contiguous()
        index = batch.get("index")
        if index is None:
            index = torch.arange(images.shape[0], device=dev)
        index = torch.as_tensor(index, device=dev).to(torch.int32)
        n_task = index.shape[0]
        n = n_task + (len(batch["wm_label"]) if "wm_image" in batch else 0)
        lo, hi = rows(n)
        # this rank's task rows, then its trigger rows
        t_lo, t_hi = min(lo, n_task), min(hi, n_task)
        w_lo, w_hi = max(lo, n_task) - n_task, max(hi, n_task) - n_task
        oy, ox, flip = draws(state.step, n_task)
        y = torch.as_tensor(labels, device=dev).long()[t_lo:t_hi]
        if t_hi > t_lo or mesh is None:
            x = fused_augment(images, index[t_lo:t_hi], oy[t_lo:t_hi],
                              ox[t_lo:t_hi], flip[t_lo:t_hi], mean255,
                              std255, pad, out_dtype)
        else:  # a rank whose rows are all triggers
            x = torch.empty((0, images.shape[3], images.shape[1],
                             images.shape[2]), dtype=out_dtype, device=dev)
        if "wm_image" in batch:
            wm = torch.as_tensor(batch["wm_image"][w_lo:w_hi],
                                 device=dev).contiguous()
            x = torch.cat([x, normalize_device(wm, x.dtype)])
            y = torch.cat([y, torch.as_tensor(batch["wm_label"][w_lo:w_hi],
                                              device=dev).long()])
        return x, y, n, (lo, hi)

    def step(state: TrainState, batch):
        if state.model is not model:
            raise ValueError("the state holds another model than this step's")
        if getattr(state, "model_sharded", None) and state.mesh is not mesh:
            raise ValueError("the state is sharded over another mesh than "
                             "this step's")
        with span("train.step", unit=state.step):
            return _step(state, batch)

    def _step(state: TrainState, batch):
        model.train()
        with span("train.input"):
            x, y, n, (lo, hi) = inputs(state, batch)
            w = batch.get("weight")
            if w is not None:
                w = torch.as_tensor(w, dtype=torch.float32, device=dev)
                denom = w.sum()
                w = w[lo:hi]
            elif mesh is not None:
                denom = torch.tensor(float(n), device=dev)

            shapes = dropout_shapes(n)
            fwd = {}
            if shapes:
                fwd["dropout_masks"] = [m[lo:hi] for m in
                                        dropout(state.step, shapes)]
        if remat == "full":
            fwd["remat"] = True
        whole = gather_model_parallel(state)
        if whole:
            def forward(*args, **kwargs):
                return functional_call(model, whole, args, kwargs)
        else:
            forward = model

        def ce_of(logits):
            if mesh is None:
                return cross_entropy_mean(logits, y, w)
            return _local_mean(F.cross_entropy(logits, y, reduction="none"),
                               w, denom)

        def acc_of(logits):
            if mesh is None:
                return top1_accuracy(logits, y, w)
            hit = (logits.argmax(dim=-1) == y).to(torch.float32)
            return 100.0 * _local_mean(hit, w, denom)

        sync = (synced_batch_stats(axis_group(mesh, "batch"), shards)
                if shards > 1 else contextlib.nullcontext())
        with sync:
            with span("train.forward"):
                if fork is not None:
                    fork_name, _ = fork
                    if prefix_bufs:  # none under the gn, in and none norms
                        torch._foreach_copy_(snapshot, prefix_bufs)
                    out0 = forward(x, ind=0, tap_at=fork_name, **fwd)
                    out1 = forward(out0.tap, ind=1, start_at=fork_name,
                                   **fwd)
                elif private:
                    out0 = forward(x, ind=0, **fwd)
                    out1 = forward(x, ind=1, **fwd)
                else:
                    out = forward(x, **fwd)
                    ce = ce_of(out.logits)
                    sl, sacc = total_sign_loss(collect_aux(out.aux), dev)
                    metrics = {"acc": acc_of(out.logits)}
                if private:
                    ce = ce_of(out0.logits) + ce_of(out1.logits)
                    sl, sacc = total_sign_loss(collect_aux(out1.aux), dev)
                    metrics = {"acc_public": acc_of(out0.logits),
                               "acc_private": acc_of(out1.logits)}
            # on a mesh every rank makes the same sign-loss gradient; the
            # gradient sum counts it once
            with span("train.backward"):
                (ce + (sl / shards if shards > 1 else sl)).backward()
        metrics["loss"] = ce
        if shards > 1:
            parts = torch.stack([v.detach() for v in metrics.values()])
            total = all_reduce_gradients(list(model.parameters()), mesh,
                                         extra=parts)
            metrics = dict(zip(metrics, total.unbind()))
        if prefix_bufs:
            with span("train.prefix_stats"), torch.no_grad():
                moved = torch._foreach_sub(prefix_bufs, snapshot)
                torch._foreach_add_(prefix_bufs, moved, alpha=BN_MOMENTUM)
        with span("train.optimizer"):
            state.apply_gradients()
        metrics.update({"sign_loss": sl, "sign_acc": sacc})
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def _batch(batch, device):
    x = nhwc_to_nchw(batch["image"], device)
    y = torch.as_tensor(batch["label"], device=device).long()
    return x, y


def _sums(logits, y):
    ce = F.cross_entropy(logits, y, reduction="sum")
    correct = (logits.argmax(dim=-1) == y).sum()
    return ce, correct


def make_dual_eval_step(model, split_branches: bool = True,
                        device: DeviceLike = "cuda"):
    """Both-branch eval in one data pass (reference TesterPrivate.test,
    trainer_private.py:218-251).

    The shared prefix up to the first passport block runs once and the
    private branch forks from its output: at eval the branches are identical
    up to that block (same weights, same BN running stats). Runs in eval
    mode whatever the model's mode."""
    dev = resolve_device(device)
    require_on_device(model, dev)
    fork = branch_point(model) if split_branches else None

    @torch.inference_mode()
    def step(batch):
        x, y = _batch(batch, dev)
        with eval_mode(model):
            if fork is not None:
                name, _ = fork
                out0 = model(x, ind=0, tap_at=name)
                logits0 = out0.logits
                logits1 = model(out0.tap, ind=1, start_at=name).logits
            else:
                logits0 = model(x, ind=0).logits
                logits1 = model(x, ind=1).logits
        out = {}
        for tag, logits in (("public", logits0), ("private", logits1)):
            out[f"ce_sum_{tag}"], out[f"correct_{tag}"] = _sums(logits, y)
        return out

    return step


def run_dual_eval(step, dataset) -> Dict[str, float]:
    """Drive a dual eval step -> the TesterPrivate metric dict."""
    sums, count = None, 0
    for batch in dataset:
        out = step(batch)
        sums = out if sums is None else {k: sums[k] + out[k] for k in sums}
        count += len(batch["label"])
    if count == 0:
        return {"loss_public": 0.0, "acc_public": 0.0,
                "loss_private": 0.0, "acc_private": 0.0, "total_acc": 0.0}
    res = {
        "loss_public": float(sums["ce_sum_public"]) / count,
        "acc_public": 100.0 * int(sums["correct_public"]) / count,
        "loss_private": float(sums["ce_sum_private"]) / count,
        "acc_private": 100.0 * int(sums["correct_private"]) / count,
    }
    res["total_acc"] = (res["acc_public"] + res["acc_private"]) / 2
    return res


def make_eval_step(model, ind: int = 0, force_passport: bool = False,
                   device: DeviceLike = "cuda",
                   tensors: Optional[Mapping[str, torch.Tensor]] = None):
    """Sum-reduced CE + correct-count eval step (reference Tester.test), in
    eval mode whatever the model's mode. ``tensors`` (by state-dict name,
    e.g. an attack's fake passports) stand in for the model's own in each
    call (``functional_call``); the model is not modified."""
    dev = resolve_device(device)
    require_on_device(model, dev)
    kwargs = {"ind": ind, "force_passport": force_passport}

    @torch.inference_mode()
    def step(batch):
        x, y = _batch(batch, dev)
        with eval_mode(model):
            if tensors is None:
                logits = model(x, **kwargs).logits
            else:
                logits = functional_call(model, dict(tensors), (x,),
                                         kwargs).logits
        ce_sum, correct = _sums(logits, y)
        return {"ce_sum": ce_sum, "correct": correct}

    return step


def run_eval(step, dataset) -> Dict[str, float]:
    """Drive a prebuilt eval step over a dataset -> {'loss', 'acc'}."""
    ce_sum, correct, count = None, None, 0
    for batch in dataset:
        out = step(batch)
        ce_sum = out["ce_sum"] if ce_sum is None else ce_sum + out["ce_sum"]
        correct = out["correct"] if correct is None else correct + out["correct"]
        count += len(batch["label"])
    if count == 0:
        return {"loss": 0.0, "acc": 0.0}
    return {"loss": float(ce_sum) / count, "acc": 100.0 * int(correct) / count}


def evaluate(model, dataset, ind: int = 0, force_passport: bool = False,
             device: DeviceLike = "cuda") -> Dict[str, float]:
    """One-shot full-dataset eval."""
    step = make_eval_step(model, ind=ind, force_passport=force_passport,
                          device=device)
    return run_eval(step, dataset)


def make_signature_fn(model, input_shape, private: bool,
                      device: DeviceLike = "cuda"):
    """Signature detection (TesterPrivate.test_signature,
    trainer_private.py:37-71): fn() -> {layer_path: detection_rate}.

    The derived scale depends only on (conv kernel, skey), so a zeros input
    of the NHWC ``input_shape`` drives the model once with the passport
    branch forced.
    """
    dev = resolve_device(device)
    require_on_device(model, dev)
    prefix = "private_" if private else "public_"

    def fn() -> Dict[str, float]:
        affines = derived_affines(model, input_shape, private)
        return {prefix + path: float(bit_accuracy(aux["scale"], aux["b"]))
                for path, aux in affines.items()}

    return fn


def test_signature(model, input_shape, private: bool,
                   device: DeviceLike = "cuda") -> Dict[str, float]:
    """One-shot convenience wrapper around make_signature_fn."""
    return make_signature_fn(model, input_shape, private, device=device)()
