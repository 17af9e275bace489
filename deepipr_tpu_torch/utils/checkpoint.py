"""Checkpointing: the full train state in one file.

Counterpart of ``deepipr_tpu/utils/checkpoint.py``. Unlike the reference's
weights-only ``.pth`` (experiments/base.py:139-150), a checkpoint carries the
complete state: the model's ``state_dict`` (parameters, BN running
statistics, passports ``key``/``skey`` and signatures ``b``), the
optimizer's state (momentum) and the step counter. Everything is saved as
CPU tensors with ``torch.save`` and loaded with ``torch.load(...,
weights_only=True)`` (W8): no pickled code runs at load.

The multi-host and Orbax variants of the JAX module (``save_state_multihost``,
``load_state_multihost``, ``save_state_orbax``, ``load_state_orbax``) are
ROADMAP queue 1, item 7.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict

import torch

from deepipr_tpu_torch.train.state import TrainState

# state_dict entries a checkpoint must match exactly (W8): a passport or a
# signature silently kept from the template would verify the wrong owner
_STRICT_LEAVES = ("key", "skey", "b")


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def snapshot(state: TrainState) -> Dict[str, Any]:
    """The state as a dict of CPU copies: what a checkpoint file holds."""
    return _to_cpu({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": int(state.step)})


def _write(path: str, snap: Dict[str, Any]) -> None:
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(snap, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_state(path: str, state: TrainState) -> None:
    """Atomic write: serialize to path.tmp, fsync, rename; a crash mid-save
    never corrupts the previous checkpoint."""
    _write(path, snapshot(state))


class AsyncCheckpointer:
    """Overlap the disk write of a checkpoint with the next epoch's work.

    ``save()`` copies the state to the host on the caller's thread (so the
    train step may go on updating it) and hands the write to one worker
    thread. The queue is bounded: a producer faster than the disk blocks
    instead of piling snapshots up. Errors surface at ``flush()``; call it
    before reading checkpoints back or exiting.
    """

    def __init__(self, max_pending: int = 3):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._error = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            path, snap = self._q.get()
            try:
                _write(path, snap)
            except BaseException as e:  # surfaced on the next flush()
                self._error = e
            finally:
                self._q.task_done()

    def save(self, path: str, state: TrainState) -> None:
        self._q.put((path, snapshot(state)))

    def flush(self) -> None:
        """Block until all queued saves are on disk; re-raise any error."""
        self._q.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise e


def load_state(path: str, template: TrainState,
               restore_opt: bool = True) -> TrainState:
    """Restore a checkpoint into ``template`` (in place, on the template's
    device) and return it.

    ``restore_opt=False`` keeps the template's optimizer state and step
    counter: the "load pretrained weights" semantics of ``--pretrained-path``
    and the attack tools. The model entries must match the template's; an
    unmatched passport or signature entry raises, and so does an entry the
    template has and the checkpoint lacks. Entries of the checkpoint that
    the template lacks are dropped with a loud warning, as the JAX package
    does.
    """
    data = torch.load(path, map_location="cpu", weights_only=True)
    entries = data["model"]
    own = template.model.state_dict()
    missing = sorted(set(own) - set(entries))
    dropped = sorted(set(entries) - set(own))
    strict = [k for k in missing + dropped
              if k.rsplit(".", 1)[-1] in _STRICT_LEAVES]
    if strict:
        raise ValueError(f"checkpoint {path}: passport or signature entries "
                         f"do not match the model: {strict}")
    if missing:
        raise ValueError(f"checkpoint {path} lacks model entries {missing}")
    if dropped:
        print(f"WARNING: load_state dropped {len(dropped)} checkpoint "
              f"entr{'y' if len(dropped) == 1 else 'ies'} not in the "
              f"template: {dropped[:6]}{' ...' if len(dropped) > 6 else ''}")
        entries = {k: v for k, v in entries.items() if k in own}
    template.model.load_state_dict(entries, strict=True)
    if restore_opt:
        template.optimizer.load_state_dict(data["optimizer"])
        template.step = int(data["step"])
    return template
