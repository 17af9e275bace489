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
  params/classifier_4|6/kernel        -> classifier_4|6.weight, the same
  params/<dense>/bias                 -> <dense>.bias
  params/classifier/kernel (H*W*C,out)  -> classifier.weight (out,C*H*W)
  params/classifier_1/kernel (9216,out) -> classifier_1.weight (out,9216)
  batch_stats/<mod>/bn*/mean|var      -> <mod>.bn*.running_mean|running_var
  passport/<mod>/key|skey (1,H,W,C)   -> <mod>.key|skey (1,C,H,W)
  signature/<mod>/b                   -> <mod>.b

The two Linears of AlexNet that read a flattened conv map (``classifier``
on CIFAR's 256x4x4, ``classifier_1`` on the ImageNet head's 256x6x6) are
not a plain transpose: JAX flattens its NHWC map in (h, w, c) order, the
port, like the reference, its NCHW map in (c, h, w) order (``x.view(n,
-1)``), so their input rows are reordered on load (the inverse of the JAX
package's ``_FLATTENED_LINEAR_SHAPES``, interop/torch_import.py:32-44).
ResNet's ``linear`` follows the global average pool and needs nothing.

Every entry must match on both sides; anything unmatched raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats", "passport", "signature")

# Linear layers that read a flattened conv map, keyed by (module path,
# in_features): the map's (C, H, W)
FLATTENED_LINEAR_SHAPES = {
    ("classifier", 4096): (256, 4, 4),  # CIFAR AlexNet
    ("classifier_1", 9216): (256, 6, 6),  # AlexNet's ImageNet head
}


def _hwc_rows_to_chw_columns(kernel: np.ndarray, chw) -> np.ndarray:
    """A (H*W*C, out) Dense kernel whose rows are in (h, w, c) order as a
    (out, C*H*W) Linear weight whose columns are in (c, h, w) order."""
    c, h, w = chw
    return kernel.reshape(h, w, c, -1).transpose(3, 2, 0, 1).reshape(
        kernel.shape[1], -1)


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
            chw = FLATTENED_LINEAR_SHAPES.get((".".join(mods), v.shape[0]))
            if chw is not None:
                return f"{mod}weight", _hwc_rows_to_chw_columns(v, chw)
            if mods in (["classifier"], ["classifier_1"]):
                raise ValueError(f"params/{'/'.join(path)}: no (C, H, W) "
                                 f"for a flattened map of {v.shape[0]}")
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
