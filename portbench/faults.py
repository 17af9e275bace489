"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` catches them. Neither run.py nor rehearse.py plants
any; control.py reads them on the card and the CPU tests see each make a
run come out not correct.

- ``frozen_state``: every train step returns the state as it found it.
- ``half_batch``: every train step takes the first half of its batch, the
  mean taken over those rows.
- ``altered_answer``: ``Predictor.predict`` serves, for the first row of
  each request, the class its logits put second.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Iterator

TRAIN = ("frozen_state", "half_batch")
INFER = ("altered_answer",)


def _frozen(model, step):
    def frozen(state, batch):
        params = {k: v.clone() for k, v in model.state_dict().items()}
        opt = copy.deepcopy(state.optimizer.state_dict())
        count = state.step
        state, metrics = step(state, batch)
        model.load_state_dict(params)
        state.optimizer.load_state_dict(opt)
        state.step = count
        return state, metrics

    return frozen


def _half(model, step):
    def half(state, batch):
        n = len(batch["label"]) // 2
        return step(state, {**batch, "index": batch["index"][:n],
                            "label": batch["label"][:n]})

    return half


@contextlib.contextmanager
def plant(name: str) -> Iterator[None]:
    if name in TRAIN:
        import deepipr_tpu_torch.train.epoch as epoch

        real = epoch.make_train_step
        wrap = _frozen if name == "frozen_state" else _half
        epoch.make_train_step = lambda model, *a, **k: wrap(
            model, real(model, *a, **k))
        try:
            yield
        finally:
            epoch.make_train_step = real
    elif name in INFER:
        from deepipr_tpu_torch.serve import Predictor

        real = Predictor.predict

        def predict(self, x):
            top2 = self.logits(x).topk(2, dim=-1).indices
            classes = top2[:, 0].clone()
            classes[0] = top2[0, 1]
            return classes

        Predictor.predict = predict
        try:
            yield
        finally:
            Predictor.predict = real
    else:
        raise ValueError(f"no fault {name!r}")


def for_unit(unit: str):
    return TRAIN if unit == "step" else INFER
