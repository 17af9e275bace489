"""Signature codec: encode ownership signatures as sign vectors, decode them back.

Counterpart of ``deepipr_tpu/passport/codec.py``. Semantics match the
reference (models/layers/passportconv2d.py:25-41):

- default: random signs drawn per channel,
- int: constant sign vector,
- str: ASCII text, 8 bits per char MSB-first (``format(ord(c), 'b').zfill(8)``),
  bit '1' -> +1, bit '0' -> -1; channels beyond the text keep random signs.

Random signs come from an explicit ``torch.Generator``; they are not the JAX
package's bits for the same seed, so tests hand both sides the same ``b``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

SignatureSpec = Union[None, int, str]


def string_to_bits(text: str) -> np.ndarray:
    """ASCII text -> {0,1} bit array, 8 bits per char, MSB first.

    Characters above 0xFF would produce more than 8 bits and are rejected.
    """
    bits = []
    for c in text:
        s = format(ord(c), "b").zfill(8)
        if len(s) != 8:
            raise ValueError(f"character {c!r} does not fit in 8 bits")
        bits.extend(int(ch) for ch in s)
    return np.asarray(bits, dtype=np.int32)


def bits_to_string(bits: np.ndarray) -> str:
    """{0,1} bit array -> ASCII text (inverse of :func:`string_to_bits`)."""
    bits = np.asarray(bits).reshape(-1)
    n = (len(bits) // 8) * 8
    chars = []
    for i in range(0, n, 8):
        byte = 0
        for b in bits[i : i + 8]:
            byte = (byte << 1) | int(b)
        chars.append(chr(byte))
    return "".join(chars)


def encode_signature(
    generator: torch.Generator,
    out_channels: int,
    spec: SignatureSpec = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Build a +-1 signature vector ``b`` of length ``out_channels`` (on CPU).

    ``spec``: None -> random signs; int -> constant; str -> ASCII bits in the
    leading channels, random signs elsewhere.
    """
    u = torch.rand(out_channels, generator=generator)
    b = torch.where(u >= 0.5, 1.0, -1.0)

    if spec is None:
        pass
    elif isinstance(spec, (int, np.integer)):
        b = torch.full((out_channels,), float(spec))
    elif isinstance(spec, str):
        bits = string_to_bits(spec)
        if len(bits) > out_channels:
            raise ValueError(
                f"too much bit information: {len(bits)} bits > {out_channels} channels"
            )
        b[: len(bits)] = torch.from_numpy(np.where(bits == 1, 1.0, -1.0))
    else:
        raise TypeError(f"unsupported signature spec: {type(spec)}")

    return b.to(dtype)


def decode_bits(scale: torch.Tensor) -> torch.Tensor:
    """Extract the embedded {0,1} bits from a scale vector: bit = sign(scale) > 0."""
    return (torch.sign(scale.reshape(-1)) > 0).to(torch.int32)


def decode_string(scale: torch.Tensor, num_chars: Optional[int] = None) -> str:
    """Decode embedded ASCII text from a scale vector's signs."""
    bits = decode_bits(scale).cpu().numpy()
    if num_chars is not None:
        bits = bits[: num_chars * 8]
    return bits_to_string(bits)


def bit_accuracy(scale: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fraction of channels where sign(scale) matches sign(b).

    Reference metric: experiments/trainer_private.py:49-64. The count of
    matches times the f32 reciprocal of the channel count, as XLA evaluates
    the JAX package's ``jnp.mean`` (and ATen's CUDA mean): a rate of 384
    channels is then the same f32 on the CPU, on the card and in JAX, where
    ATen's CPU mean divides and may land one ulp away.
    """
    hits = (torch.sign(scale.reshape(-1)) == torch.sign(b.reshape(-1))
            ).to(torch.float32)
    return hits.sum() * (1.0 / hits.numel())
