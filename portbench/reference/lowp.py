"""The control's precision: the reference computed in fp8, the precision
below the configurations' bf16. Inside :func:`fp8_products`, every
convolution, linear layer and einsum (the reference's attention and
correlation products) takes both operands rounded to float8_e4m3fn,
each tensor scaled by its largest magnitude to the format's range
(448), and accumulates in f32. Gradients pass through the rounding
unchanged.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    scale = (x.detach().abs().amax().float() / E4M3_MAX).clamp_min(1e-30)
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


@contextlib.contextmanager
def fp8_products():
    saved = {(F, n): getattr(F, n) for n in ("conv2d", "conv3d", "linear")}
    saved[(torch, "einsum")] = torch.einsum

    def wrap(fn, einsum=False):
        if einsum:
            return lambda eq, *ops: fn(eq, *(fp8(o) for o in ops))
        return lambda x, w, *a, **kw: fn(fp8(x), fp8(w), *a, **kw)
    try:
        for (mod, name), fn in saved.items():
            setattr(mod, name, wrap(fn, name == "einsum"))
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
