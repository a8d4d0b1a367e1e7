"""K5's call (flash attention backward, dk and dv)."""

from portbench.counts import k5_call as bound_s  # noqa: F401
