"""K1's call (correlation taps on the pooled pyramid)."""

from portbench.counts import k1_call as bound_s  # noqa: F401
