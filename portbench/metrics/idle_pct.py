"""The device's idle share: its busy time a step or request in the traced
slice against the untraced window's wall time a step or request."""

from portbench.readers import idle_pct as read  # noqa: F401
