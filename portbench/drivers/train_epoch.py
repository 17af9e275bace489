"""Driver 'train_epoch': the port's device-resident V2 epoch, run in slices.

Set-up builds one train state (the port's model holding the benchmark's
values, SGD with momentum) and the epoch function of ``train/epoch.py``,
makes the uint8 training set on the device, and drives the state through
its first ``check_steps`` steps, one call of the epoch function each, on
rows of a permutation of their own. What those steps produced (each step's
loss, the first gradient as the optimizer took it, each leaf's change) is
read then and judged against the reference after the window.

The window goes on with the same state. Each epoch takes a permutation and
a table of kernel K1's draws made from the seed (passed as ``perm=`` and
``draws=``) and runs as consecutive slices of ``slice_steps`` steps, each
one call of the epoch function ending in a host read of its metrics. The
window closes at the end of the slice in which ``--seconds`` pass;
``img_s`` is every image stepped over the window's wall time.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from portbench.compare import train_numbers
from portbench.inputs import draw_table, make_values, permutation, train_set
from portbench.models import DTYPES, build_port_model, leaf_shapes, \
    reference_model
from portbench.reference.resnet import SGD, augment, pin_ieee_f32, \
    train_step
from portbench.trace import TraceSummary, traced

TINY = {"batch": 4, "train_images": 24, "slice_steps": 2, "trace_steps": 2}


class Draws:
    """K1's draws for a step of the train state: the rows of the table
    loaded for the steps from ``first`` on."""

    def __init__(self):
        self.first, self.table = 0, None

    def load(self, first: int, table) -> None:
        self.first, self.table = first, table

    def __call__(self, step: int, n: int):
        return tuple(t[step - self.first] for t in self.table)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's norm in float64 on the host, in one read."""
    norms = torch.stack([t.double().norm() for t in tensors.values()])
    return dict(zip(tensors, norms.tolist()))


def _bn_names(values) -> List[str]:
    return [k for k in values if k.endswith(("running_mean", "running_var"))]


class Job:
    unit = "step"
    compare = staticmethod(train_numbers)

    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.batch = traffic["batch"]

    def setup(self) -> None:
        from deepipr_tpu_torch.train.epoch import make_epoch_train_fn
        from deepipr_tpu_torch.train.state import TrainState

        t, dev, b = self.traffic, self.device, self.batch
        clock = time.perf_counter()
        values = make_values(leaf_shapes(self.config), self.seed, dev)
        self.model = build_port_model(self.config, t["dtype"], values, dev)
        self.state = TrainState.create(self.model, t["lr"],
                                       momentum=t["momentum"],
                                       weight_decay=t["weight_decay"])
        self.images, self.labels = train_set(
            self.seed, t["train_images"], self.config["input_size"],
            self.config["channels"], self.config["num_classes"], dev)
        self.draws = Draws()
        self.epoch_fn = make_epoch_train_fn(
            self.model, True, b, t["pad"], draws=self.draws,
            out_dtype=DTYPES[t["dtype"]], device=dev)
        self.phases = {"build": time.perf_counter() - clock}
        clock = time.perf_counter()

        k = t["check_steps"]
        rows = permutation(self.seed, t["train_images"], dev, "check")[:k * b]
        table = draw_table(self.seed, k, b, t["pad"], dev, "check")
        self.check_inputs = (self.images[rows], self.labels[rows], table)
        self.draws.load(self.state.step, table)
        losses = []
        for i in range(k):
            m = self._slice(rows[i * b:(i + 1) * b])
            losses.append(m["loss"] + m["sign_loss"])
            if i == 0:
                grad = self._first_gradient()
        params = dict(self.model.named_parameters())
        buffers = dict(self.model.named_buffers())
        self.prog = {
            "loss": losses, "grad": grad,
            "update": _norms({n: p.detach() - values[n]
                              for n, p in params.items()}),
            "bn": _norms({n: buffers[n] - values[n]
                          for n in _bn_names(values)}),
        }
        self.phases["first_steps"] = time.perf_counter() - clock

    def _slice(self, rows: torch.Tensor) -> Dict[str, float]:
        """One call of the epoch function over ``rows``; its mean metrics,
        read to the host."""
        self.state, metrics = self.epoch_fn(self.state, self.images,
                                            self.labels, 0, perm=rows)
        return dict(zip(metrics, torch.stack(list(metrics.values()))
                        .tolist()))

    def _first_gradient(self) -> Dict[str, float]:
        """The first step's gradient of every parameter, from the state
        after it: the momentum holds g + wd * p0, and p0 = p1 + lr * it."""
        t = self.traffic
        opt = self.state.optimizer
        grads = {}
        for name, p in self.model.named_parameters():
            # none where a step left the optimizer as it was
            buf = opt.state[p].get("momentum_buffer", torch.zeros_like(p))
            grads[name] = buf - t["weight_decay"] * (p.detach()
                                                     + t["lr"] * buf)
        return _norms(grads)

    def _epoch_rows(self, epoch: int) -> torch.Tensor:
        t = self.traffic
        steps = t["train_images"] // self.batch
        self.draws.load(self.state.step, draw_table(
            self.seed, steps, self.batch, t["pad"], self.device, "epoch",
            epoch))
        return permutation(self.seed, t["train_images"], self.device,
                           "epoch", epoch)

    def window(self, seconds: float) -> Dict:
        b = self.batch
        per_epoch = self.traffic["train_images"] // b
        epoch, pos, steps, failed = 0, per_epoch, 0, 0
        t0 = time.perf_counter()
        per_step = []
        while True:
            s0 = time.perf_counter()
            if pos == per_epoch:
                perm, pos = self._epoch_rows(epoch), 0
                epoch += 1
            take = min(self.traffic["slice_steps"], per_epoch - pos)
            metrics = self._slice(perm[pos * b:(pos + take) * b])
            if not all(math.isfinite(v) for v in metrics.values()):
                failed += take
            pos += take
            steps += take
            per_step.append(1e3 * (time.perf_counter() - s0) / take)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"metrics": {"img_s": steps * b / elapsed},
                "attempted": steps, "failed": failed, "units": steps,
                "images": steps * b, "seconds": elapsed,
                "detail": "ms a step, slice by slice: "
                          f"{[round(x, 2) for x in per_step]}"}

    def trace(self) -> TraceSummary:
        t, b = self.traffic, self.batch
        k = t["trace_steps"]
        rows = permutation(self.seed, t["train_images"], self.device,
                           "trace")[:k * b]
        table = draw_table(self.seed, k, b, t["pad"], self.device, "trace")

        def steps() -> int:
            self.draws.load(self.state.step, table)
            self._slice(rows)
            return k

        return traced(steps, self.device)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.model, self.state, self.epoch_fn, self.images, self.labels
        self.draws.load(0, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, lower=None) -> Dict:
        """The reference's readings of the same first steps, from the same
        values, rows and draws; ``lower``: its control."""
        t, dev, b = self.traffic, self.device, self.batch
        pin_ieee_f32()
        values = make_values(leaf_shapes(self.config), self.seed, dev)
        ref = reference_model(self.config, t["dtype"], values, dev)
        opt = SGD(ref, t["lr"], t["momentum"], t["weight_decay"])
        images, labels, (oy, ox, flip) = self.check_inputs
        losses = []
        for i in range(t["check_steps"]):
            rows = slice(i * b, (i + 1) * b)
            x = augment(images[rows], oy[i], ox[i], flip[i], t["pad"])
            loss, grads = train_step(ref, opt, x, labels[rows], lower)
            losses.append(loss)
            if i == 0:
                grad = _norms(grads)
        buffers = dict(ref.named_buffers())
        return {
            "loss": losses, "grad": grad,
            "update": _norms({n: p.detach() - values[n]
                              for n, p in ref.named_parameters()}),
            "bn": _norms({n: buffers[n] - values[n]
                          for n in _bn_names(values)}),
        }

    def program_readings(self) -> Dict:
        return self.prog
