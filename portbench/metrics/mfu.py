"""Model FLOPs of the window's steps or requests over the window's wall
time, as a share of the compute dtype's dense peak."""

from portbench.readers import mfu as read  # noqa: F401
