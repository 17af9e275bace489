"""Kernel K1 (ops/fused_augment.py) against its byte bound at the cell's
batch: each launch's least time at the card's memory bandwidth over its
CUPTI time, over the traced slice."""

from portbench.readers import k1_roofline_pct as read  # noqa: F401
