"""Device-resident epoch training: the set lives on the card, one host read
per epoch.

Counterpart of ``deepipr_tpu/train/epoch.py``. The training set is parked on
the device once as raw uint8 (``device_resident``); each epoch draws a
permutation on the device (drop_last), and each step hands the train step
the resident set with the step's row indices, so kernel K1
(ops/fused_augment.py) gathers, crops, flips and normalizes the batch in one
launch. V3 trigger batches ride resident too, cycled by step index (the
reference's cycling trigger loader, trainer.py:115-126). Metrics are
averaged on the device; the caller reads them once per epoch.

The JAX package runs the epoch as one ``lax.scan``; here it is a loop over
steps. Its ``input_stage`` switch has no counterpart: the port has one
input stage, K1 on a CUDA tensor and its plain version on a CPU tensor.

On a mesh (``mesh=``, parallel/mesh.py) every rank holds the whole set
resident (``device_resident`` on each rank: replicated, as the JAX
package's ``P()``), draws the same permutation, and hands the train step
the global batch's row indices; the step's K1 gathers only this rank's
rows. The JAX package refuses its Pallas input stage on a mesh, since a
``pallas_call`` is opaque to SPMD partitioning; the port's K1 is called on
each rank's rows and keeps the one input stage everywhere. V3 takes its
trigger batch rounded up to the 'batch' axis (``wm_take``), the extra
triggers lookaheads of the cycle at loss weight 0, exactly as the JAX
epoch does (epoch.py:132-135, 203-214).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepipr_tpu_torch.parallel.mesh import axis_size
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import DrawFn, DropoutFn, make_train_step
from deepipr_tpu_torch.utils.device import DeviceLike, resolve_device, \
    seeded_generator
from deepipr_tpu_torch.utils.spans import span


def epoch_permutation(perm: torch.Tensor, batch_size: int
                      ) -> Tuple[int, torch.Tensor]:
    """(steps, (steps, batch_size) rows) of a shuffled order of the set, with
    drop_last semantics."""
    steps = perm.shape[0] // batch_size
    if steps == 0:
        raise ValueError(f"batch_size {batch_size} exceeds the dataset "
                         f"({perm.shape[0]} images)")
    return steps, perm[: steps * batch_size].view(steps, batch_size)


def device_resident(images_u8, labels, device: DeviceLike = "cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (N, H, W, C) uint8 set and its labels, copied to ``device`` once
    and reused by every epoch."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(images_u8, np.uint8)).to(dev).contiguous()
    y = torch.as_tensor(np.asarray(labels)).to(dev).long()
    return x, y


def make_epoch_train_fn(model, private: bool, batch_size: int, pad: int,
                        split_branches: bool = True, remat: str = "none",
                        wm_batch: int = 2, seed: int = 0,
                        draws: Optional[DrawFn] = None,
                        dropout: Optional[DropoutFn] = None,
                        out_dtype: torch.dtype = torch.float32,
                        device: DeviceLike = "cuda", mesh=None):
    """Build epoch_fn(state, images_u8, labels, epoch_key[, wm_images_u8,
    wm_labels], perm=None, wm_perm=None) -> (state, mean_metrics).

    ``images_u8``/``labels`` come from ``device_resident``. The epoch's
    permutation is ``torch.randperm`` from a generator seeded by
    ``epoch_key`` on the device, the trigger set's from (epoch_key, 1);
    ``perm``/``wm_perm`` replace them (tests inject JAX's). Each step takes
    the next ``wm_batch`` triggers round-robin. ``draws``: the per-step
    augmentation draws, ``dropout`` the per-step dropout masks, and
    ``out_dtype`` the dtype K1 writes, as in ``make_train_step``.
    ``mean_metrics``: each step metric averaged over the epoch, as device
    tensors. ``mesh``: train data-parallel over its 'batch' axis (module
    docstring); ``batch_size`` must divide by the axis's size.
    """
    dev = resolve_device(device)
    n_shards = axis_size(mesh, "batch") if mesh is not None else 1
    if batch_size % n_shards:
        raise ValueError(f"epoch scan on a {n_shards}-way batch mesh needs "
                         f"batch_size % {n_shards} == 0, got {batch_size}")
    # the trigger take of a step: wm_batch on one rank, rounded up to the
    # batch axis on a mesh; the extras carry loss weight 0
    wm_take = -(-wm_batch // n_shards) * n_shards
    step_fn = make_train_step(model, private, split_branches=split_branches,
                              pad=pad, remat=remat, seed=seed, draws=draws,
                              dropout=dropout, out_dtype=out_dtype,
                              device=dev, mesh=mesh)

    def epoch_fn(state: TrainState, images_u8: torch.Tensor,
                 labels: torch.Tensor, epoch_key: int,
                 wm_images_u8: Optional[torch.Tensor] = None,
                 wm_labels: Optional[torch.Tensor] = None,
                 perm: Optional[torch.Tensor] = None,
                 wm_perm: Optional[torch.Tensor] = None,
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("train.epoch"):
            n = images_u8.shape[0]
            if perm is None:
                perm = torch.randperm(
                    n, generator=seeded_generator(dev, epoch_key), device=dev)
            steps, rows = epoch_permutation(torch.as_tensor(perm, device=dev),
                                            batch_size)
            rows = rows.to(torch.int32)
            if wm_images_u8 is not None:
                m = wm_images_u8.shape[0]
                if wm_perm is None:
                    wm_perm = torch.randperm(
                        m, generator=seeded_generator(dev, epoch_key, 1),
                        device=dev)
                wm_perm = torch.as_tensor(wm_perm, device=dev).long()
                cycle = torch.arange(wm_take, device=dev)
                weight = None
                if wm_take != wm_batch:
                    weight = torch.ones(batch_size + wm_take, device=dev)
                    weight[batch_size + wm_batch:] = 0.0

            history = []
            for t in range(steps):
                idx = rows[t]
                batch = {"image": images_u8, "index": idx,
                         "label": labels[idx.long()]}
                if wm_images_u8 is not None:
                    wm_idx = wm_perm[(t * wm_batch + cycle) % m]
                    batch["wm_image"] = wm_images_u8[wm_idx]
                    batch["wm_label"] = wm_labels[wm_idx]
                    if weight is not None:
                        batch["weight"] = weight
                state, metrics = step_fn(state, batch)
                history.append(metrics)
            with span("train.metrics"):
                return state, {k: torch.stack([h[k] for h in history]).mean()
                               for k in history[0]}

    return epoch_fn
