"""Attack suite: fake-passport (1), reverse-engineering (2), ambiguity (3),
pruning, sign-flipping, and deployment-forgery attacks.

Counterpart of ``deepipr_tpu/attacks/__init__.py``, with its exports by the
same names. They load on first access: ``serve.py`` and ``train/steps.py``
import ``attacks.common``, and the attack modules import both.
"""

import importlib

_EXPORTS = {
    "ambiguity_attack": "ambiguity",
    "flip_signature_bits": "ambiguity",
    "derived_affines": "common",
    "detect_signature_from_affines": "common",
    "global_sign_flip": "common",
    "plkey_to_module_path": "common",
    "random_passport_attack": "fake_passport",
    "forge_attack": "forge",
    "forged_signature_accuracy": "forge",
    "flip_attack": "flip",
    "materialize_affines": "flip",
    "global_prune": "pruning",
    "pruning_attack": "pruning",
    "reverse_attack": "reverse",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
