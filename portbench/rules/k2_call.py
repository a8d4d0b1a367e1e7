"""K2's call (flash attention forward)."""

from portbench.counts import k2_call as bound_s  # noqa: F401
