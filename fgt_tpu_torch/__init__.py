"""PyTorch + CUDA port of fgt_tpu for NVIDIA Hopper (H100).

Mirrors ``fgt_tpu``'s layout (``models/``, ``ops/``, ``pipeline/``,
``train/``, ``convert/``, ``native/``, ``utils/``). Dense model code is
plain PyTorch; the Pallas kernels on the object-removal path and on FGT
GAN training (the RAFT correlation lookup, flash attention forward and
backward) are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``,
built with nvcc at first use and bound with ctypes. Public functions keep the JAX package's layouts (NHWC frames,
``[T, H, W, 2]`` flows, ``[N, L, ch]`` attention) so the two packages
can be compared like for like.

This package imports torch, numpy, scipy and the standard library only.
"""

DEFAULT_DEVICE = "cuda"
