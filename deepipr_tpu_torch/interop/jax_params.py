"""Load a JAX variable tree of ``deepipr_tpu`` into a port model.

The tree is the JAX model's variables as nested dicts of numpy arrays, i.e.
``jax.tree.map(np.asarray, state.model_variables())``, with the collections
``params`` / ``batch_stats`` / ``passport`` / ``signature``. The port's
module names equal the JAX module paths, so a path maps to a state-dict name
by joining with dots; what changes is the leaf name and the layout (the
mapping of interop/torch_export.py in the JAX package, without the
reference's aliases):

  params/<mod>/conv/kernel (H,W,I,O)  -> <mod>.conv.weight (O,I,H,W)
  params/<mod>/conv/bias              -> <mod>.conv.bias
  params/<mod>/bn*/scale|bias         -> <mod>.bn*.weight|bias
  params/<mod>/scale|bias             -> <mod>.scale|bias (learned affine)
  params/linear/kernel (in,out)       -> linear.weight (out,in)
  params/linear/bias                  -> linear.bias
  batch_stats/<mod>/bn*/mean|var      -> <mod>.bn*.running_mean|running_var
  passport/<mod>/key|skey (1,H,W,C)   -> <mod>.key|skey (1,C,H,W)
  signature/<mod>/b                   -> <mod>.b

Every entry must match on both sides; anything unmatched raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats", "passport", "signature")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v, np.float32)


def _port_entry(collection: str, path: Tuple[str, ...], v: np.ndarray):
    *mods, leaf = path
    # a tree of a single block has its own leaves at the top level
    mod = "".join(f"{m}." for m in mods)
    if collection == "params":
        if leaf == "kernel" and v.ndim == 4:
            return f"{mod}weight", v.transpose(3, 2, 0, 1)
        if leaf == "kernel" and v.ndim == 2:
            return f"{mod}weight", v.T
        if mods and mods[-1] in ("bn", "bn_private") and leaf == "scale":
            return f"{mod}weight", v
        if leaf in ("scale", "bias"):
            return f"{mod}{leaf}", v
    elif collection == "batch_stats" and leaf in ("mean", "var"):
        return f"{mod}running_{leaf}", v
    elif collection == "passport" and leaf in ("key", "skey") and v.ndim == 4:
        return f"{mod}{leaf}", v.transpose(0, 3, 1, 2)
    elif collection == "signature" and leaf == "b":
        return f"{mod}b", v
    raise ValueError(f"unmapped JAX variable {collection}/{'/'.join(path)}")


def jax_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """The JAX variable tree as port state-dict entries (numpy, port layout)."""
    out: Dict[str, np.ndarray] = {}
    for collection, tree in variables.items():
        if collection not in COLLECTIONS:
            raise ValueError(f"unknown variable collection {collection!r}")
        for path, v in _flatten(tree):
            name, value = _port_entry(collection, path, v)
            out[name] = np.array(value, order="C")  # a writable copy
    return out


@torch.no_grad()
def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Fill ``model`` (in place, on its device) from a JAX variable tree.

    Raises ValueError on an entry either side lacks or a shape mismatch.
    """
    entries = jax_state_dict(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(entries))
    extra = sorted(set(entries) - set(own))
    if missing or extra:
        raise ValueError(f"JAX variables do not match the model: missing "
                         f"{missing}, unexpected {extra}")
    for name, value in entries.items():
        if tuple(own[name].shape) != value.shape:
            raise ValueError(f"{name}: model has shape {tuple(own[name].shape)}, "
                             f"JAX variables {value.shape}")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in entries.items()},
                          strict=True)
