"""K4's call (flash attention backward, dq)."""

from portbench.counts import k4_call as bound_s  # noqa: F401
