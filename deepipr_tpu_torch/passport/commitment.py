"""Passport pre-commitment: the cryptographic answer to post-hoc forgery.

Counterpart of ``deepipr_tpu/passport/commitment.py``. A forger with data
and white-box access can optimize passports that carry their signature and
recover accuracy (attacks/forge.py); what tells owner from forger is time.
The owner commits to the passports and signatures before the model is
distributed; a forger can only produce theirs afterwards. ``commit`` hashes
the secrets (and, with ``input_shape``, the signs of the scales they derive
through the weights) into SHA-256 digests; publishing the record proves
possession at that date without revealing the secrets, and a dispute is
settled by revealing them and checking the earliest registered record.

A record written by either package verifies in the other, bit for bit, so
the digests hash exactly what the JAX package hashes (commitment.py:30-45
there): each leaf under its ``/``-joined JAX path (``layer4_0/convbnrelu_1/
key``), numpy's dtype string (``float32``) and shape string (``(1, 4, 4,
512)``), then its float64 bytes in JAX's layout. The passport and signature
trees therefore come from ``interop/jax_params.py::export_jax_variables``
(passports NHWC), never from the port's NCHW buffers.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Mapping, Optional

import numpy as np

from deepipr_tpu_torch.attacks.common import derived_affines
from deepipr_tpu_torch.interop.jax_params import export_jax_variables

SCHEME = "deepipr-passport-commitment-v1"


def _leaves(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


def canonical_digest(tree: Mapping) -> bytes:
    """SHA-256 of a nested dict of arrays: leaves in sorted path order, each
    as its path, dtype and shape strings, then its float64 bytes."""
    h = hashlib.sha256()
    for key, a in sorted(_leaves(tree), key=lambda e: e[0]):
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a.astype(np.float64)).tobytes())
    return h.digest()


def commit(model, input_shape=None, private: bool = True,
           meta: Optional[Dict] = None) -> Dict:
    """Commitment record for a model's ownership secrets.

    Binds the passports and signatures; with the NHWC ``input_shape`` it
    also binds the signs of the derived scales (one forward of the
    passport branch, K2 on the card), so the record covers the weights'
    interaction with the passports, not only the passport bytes.
    """
    variables = export_jax_variables(model)
    record = {
        "scheme": SCHEME,
        "passport_sha256": canonical_digest(
            variables.get("passport", {})).hex(),
        "signature_sha256": canonical_digest(
            variables.get("signature", {})).hex(),
    }
    if input_shape is not None:
        affines = derived_affines(model, input_shape, private)
        signs = {path: np.sign(aux["scale"].reshape(-1).float().cpu()
                               .numpy())
                 for path, aux in affines.items()}
        record["derived_signs_sha256"] = canonical_digest(signs).hex()
    if meta:
        record["meta"] = dict(meta)
    record["commitment"] = hashlib.sha256(
        json.dumps(record, sort_keys=True).encode()).hexdigest()
    return record


def verify_commitment(model, record: Dict, input_shape=None,
                      private: bool = True) -> bool:
    """Recompute the commitment from a revealed model and compare. A record
    made without the weights binding is checked without it."""
    if "derived_signs_sha256" not in record:
        input_shape = None
    fresh = commit(model, input_shape=input_shape, private=private,
                   meta=record.get("meta"))
    want = {k: v for k, v in record.items() if k != "commitment"}
    got = {k: v for k, v in fresh.items() if k != "commitment"}
    return want == got and record.get("commitment") == fresh["commitment"]
