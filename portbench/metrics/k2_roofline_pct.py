"""Kernel K2 (ops/passport_epilogue.py, the forward) against its byte bound
at the shapes of the private forward's passport blocks: the launches' least
time at the card's memory bandwidth over their CUPTI time, over the traced
slice."""

from portbench.readers import k2_roofline_pct as read  # noqa: F401
