"""The yardstick's arithmetic: the operations and bytes each kernel call
needs (counted from its shapes, each input byte read once and each
output byte written once, whatever the kernel reads again), the least
time the card could take for them, and the model FLOPs of a clip or a
training step, counted by ``torch.utils.flop_counter`` over the plain
reference on the ``meta`` device (matrix products and convolutions; the
flow diffusion's sparse iterations and elementwise work are left out).

The kernel rules are copies of ``chip_smoke.py``'s (``bound``,
``k1_bound``, K2's and K4/K5's counts in ``phase_k2`` and ``phase_k45``).
"""

from __future__ import annotations

from portbench.common import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S

# f32 outside the tensor cores, the peak of K1's f32 body
PEAK_F32_FLOPS = 67e12


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    """The least seconds: the larger of bytes over the memory peak and
    operations over the arithmetic peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def _peak(dtype) -> float:
    import torch

    return PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


def k1_call(fmap1, pyramid, coords, radius) -> float:
    """K1 (correlation taps on a pooled pyramid): f1, every level and
    the coords read once at their own element size, the taps written
    once in level 0's dtype; two operations a channel for each in-bounds
    corner of every level, seven a tap to combine."""
    import torch

    b, h, w, c = fmap1.shape
    k = 2 * radius + 1
    out = b * h * w * len(pyramid) * k * k
    valid = 0
    d = torch.arange(-radius, radius + 2, device=coords.device)
    for lvl, lv in enumerate(pyramid):
        c0 = torch.floor(coords.float() / 2 ** lvl).clamp(-1e6, 1e6)
        vx = (c0[..., :1] + d >= 0) & (c0[..., :1] + d <= lv.shape[2] - 1)
        vy = (c0[..., 1:] + d >= 0) & (c0[..., 1:] + d <= lv.shape[1] - 1)
        valid += int((vx.sum(-1) * vy.sum(-1)).sum().item())
    nbytes = (fmap1.numel() * pyramid[0].element_size()
              + sum(lv.numel() * lv.element_size() for lv in pyramid)
              + coords.numel() * 4 + out * pyramid[0].element_size())
    flops = 2 * c * valid + 7 * out
    return bound_s(nbytes, flops, _peak(pyramid[0].dtype))


def _nlc(q) -> tuple:
    n = 1
    for d in q.shape[:-2]:
        n *= d
    return n, q.shape[-2], q.shape[-1]


def k2_call(q, *_, **__) -> float:
    """K2 (attention forward): q, k, v read and out written once, the
    f32 log-sum-exp rows written; 4·N·L²·ch operations."""
    n, l, ch = _nlc(q)
    nbytes = 4 * n * l * ch * q.element_size() + n * l * 4
    return bound_s(nbytes, 4.0 * n * l * l * ch, _peak(q.dtype))


def k4_call(q, *_, **__) -> float:
    """K4 (dq): q, k, v, dO read, dq written, two f32 rows read; three
    products of 2·N·L²·ch."""
    n, l, ch = _nlc(q)
    nbytes = 5 * n * l * ch * q.element_size() + 2 * n * l * 4
    return bound_s(nbytes, 6.0 * n * l * l * ch, _peak(q.dtype))


def k5_call(q, *_, **__) -> float:
    """K5 (dk, dv): q, k, v, dO read, dk and dv written, two f32 rows
    read; four products of 2·N·L²·ch."""
    n, l, ch = _nlc(q)
    nbytes = 6 * n * l * ch * q.element_size() + 2 * n * l * 4
    return bound_s(nbytes, 8.0 * n * l * l * ch, _peak(q.dtype))


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def clip_flops(lafc_cfg: dict, fgt_cfg: dict, n: int, h: int, w: int,
               raft_iters: int) -> int:
    """Model FLOPs of one object-removal clip of ``n`` frames at h x w:
    RAFT encoding every frame at flow resolution (2x under 350 px) and
    refining the 2(n-1) pairs, LAFC over its 2(n-1) windows, FGT over
    the fixed windows."""
    import torch

    from portbench.reference.fgt import FGT
    from portbench.reference.lafc import LAFC
    from portbench.reference.pipeline import fgt_window_ids
    from portbench.reference.raft import RAFT

    meta = torch.device("meta")
    fh, fw = (2 * h, 2 * w) if h < 350 else (h, w)
    with meta, torch.no_grad():
        raft, lafc, fgt = RAFT(), LAFC(lafc_cfg), FGT(fgt_cfg)
        enc = _count(lambda: raft.encode(torch.zeros(1, fh, fw, 3)))
        h8, w8 = -(-fh // 8), -(-fw // 8)
        fmap = torch.zeros(2, h8, w8, 256)
        net = inp = torch.zeros(1, h8, w8, raft.hidden_dim)

        def refine(iters):
            return _count(lambda: raft.refine(fmap[:1], fmap[1:], net, inp,
                                              iters))
        one, two = refine(1), refine(2)
        pair = one + (raft_iters - 1) * (two - one)
        nf = lafc_cfg["num_flows"]
        lafc_w = _count(lambda: lafc(torch.zeros(1, nf, h, w, 2),
                                     torch.zeros(1, nf, h, w, 1)))
        ids, _ = fgt_window_ids(n)
        t = ids.shape[1]
        fgt_w = _count(lambda: fgt(torch.zeros(1, t, h, w, 3),
                                   torch.zeros(1, t, h, w, 2),
                                   torch.zeros(1, t, h, w, 1)))
    return (n * enc + 2 * (n - 1) * (pair + lafc_w)
            + ids.shape[0] * fgt_w)


def train_step_flops(gen_cfg: dict, flow_cfg: dict, dist_cnum: int, b: int,
                     t: int, h: int, w: int) -> int:
    """Model FLOPs of one GAN step: the oracle's forward, the
    generator's forward and backward, the discriminator's three calls
    and the backward passes through it."""
    import torch

    from portbench.reference.fgt import FGT
    from portbench.reference.lafc import LAFCSingle
    from portbench.reference.train import RefTrainStep, TemporalPatchGAN

    with torch.device("meta"):
        step = RefTrainStep(FGT(gen_cfg), TemporalPatchGAN(3, dist_cnum),
                            LAFCSingle(flow_cfg).requires_grad_(False),
                            1e-4, (0.9, 0.999))
        batch = {"frames": torch.zeros(b, t, h, w, 3),
                 "masks": torch.zeros(b, t, h, w, 1),
                 "flows": torch.zeros(b, t, h, w, 2)}
        return _count(lambda: step(batch, optimize=False))
