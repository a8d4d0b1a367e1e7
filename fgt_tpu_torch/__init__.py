"""PyTorch + CUDA port of fgt_tpu for NVIDIA Hopper (H100).

Mirrors ``fgt_tpu``'s layout (``core/``, ``models/``, ``ops/``,
``pipeline/``, ``train/``, ``convert/``, ``native/``, ``utils/``). Dense
model code is plain PyTorch; every Pallas kernel of the JAX package (the
RAFT correlation lookups on pooled features and on the all-pairs
pyramid, flash attention forward and backward) is hand-written CUDA C++
for ``sm_90a`` under ``csrc/``, built with nvcc at first use and bound
with ctypes. Public functions keep the JAX package's layouts (NHWC
frames, ``[T, H, W, 2]`` flows, ``[N, L, ch]`` attention) so the two
packages can be compared like for like.

This package imports torch, numpy, scipy and the standard library only.
"""

DEFAULT_DEVICE = "cuda"
