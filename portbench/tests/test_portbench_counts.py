"""The operation and byte counters against hand counts at small shapes."""

import math

import pytest
import torch

from portbench import counts
from portbench.common import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
from portbench.reference import raft as rr

from tiny import removal


def test_k2_counts():
    q = torch.zeros(2, 3, 4, 16, 8, dtype=torch.bfloat16)
    n, l, ch = 24, 16, 8
    nbytes = 4 * n * l * ch * 2 + n * l * 4
    flops = 4 * n * l * l * ch
    want = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
    assert counts.k2_call(q, q, q, 0.1) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("fn,n_out,mats", [(counts.k4_call, 1, 3),
                                          (counts.k5_call, 2, 4)])
def test_k45_counts(fn, n_out, mats):
    q = torch.zeros(32, 900, 128, dtype=torch.bfloat16)
    n, l, ch = 32, 900, 128
    nbytes = (4 + n_out) * n * l * ch * 2 + 2 * n * l * 4
    flops = 2 * mats * n * l * l * ch
    want = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
    assert fn(q) == pytest.approx(want, rel=1e-12)


def test_k1_counts_by_hand():
    g = torch.Generator().manual_seed(0)
    f2 = torch.randn(1, 5, 6, 4, generator=g)
    pyr = [f2, torch.nn.functional.avg_pool2d(
        f2.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)]
    f1 = torch.randn(1, 5, 6, 4, generator=g)
    coords = torch.rand(1, 5, 6, 2, generator=g) * 9 - 2
    r = 1
    valid = 0
    for lvl, lv in enumerate(pyr):
        hl, wl = lv.shape[1:3]
        for y in range(5):
            for x in range(6):
                cx = math.floor(float(coords[0, y, x, 0]) / 2 ** lvl)
                cy = math.floor(float(coords[0, y, x, 1]) / 2 ** lvl)
                for dy in range(-r, r + 2):
                    for dx in range(-r, r + 2):
                        valid += (0 <= cx + dx <= wl - 1
                                  and 0 <= cy + dy <= hl - 1)
    out = 30 * 2 * 9
    nbytes = 4 * (f1.numel() + sum(lv.numel() for lv in pyr)
                  + coords.numel() + out)
    flops = 2 * 4 * valid + 7 * out
    want = max(nbytes / PEAK_BYTES_PER_S, flops / counts.PEAK_F32_FLOPS)
    assert counts.k1_call(f1, pyr, coords, r) == pytest.approx(want,
                                                               rel=1e-12)


def test_conv_flops_by_hand():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, device="meta")
    got = counts._count(lambda: conv(torch.zeros(2, 3, 10, 12,
                                                 device="meta")))
    assert got == 2 * 2 * 8 * 10 * 12 * 3 * 9


def test_refine_extrapolation_is_exact():
    """clip_flops counts RAFT's refine at 1 and 2 iterations and
    extrapolates; the count at 3 iterations must equal it."""
    with torch.device("meta"):
        raft = rr.RAFT()
        fmap, net, inp = raft.encode(torch.zeros(2, 64, 64, 3))
        at = [counts._count(lambda i=i: raft.refine(
            fmap[:1], fmap[1:], net[:1], inp[:1], i)) for i in (1, 2, 3)]
    assert at[2] == at[0] + 2 * (at[1] - at[0])


def test_clip_flops_is_the_sum_of_its_parts():
    cfg, _ = removal()
    n, h, w = 6, 64, 64
    total = counts.clip_flops(cfg["lafc"], cfg["fgt"], n, h, w, 2)
    from portbench.reference.fgt import FGT
    from portbench.reference.lafc import LAFC
    from portbench.reference.pipeline import fgt_window_ids
    with torch.device("meta"), torch.no_grad():
        raft, lafc, fgt = rr.RAFT(), LAFC(cfg["lafc"]), FGT(cfg["fgt"])
        enc = counts._count(lambda: raft.encode(torch.zeros(n, 2 * h, 2 * w,
                                                            3)))
        fmap, net, inp = raft.encode(torch.zeros(n, 2 * h, 2 * w, 3))
        i, j = torch.arange(n - 1), torch.arange(1, n)
        src, dst = torch.cat([i, j]), torch.cat([j, i])
        ref = counts._count(lambda: raft.refine(fmap[src], fmap[dst],
                                                net[src], inp[src], 2))
        lafc_f = counts._count(lambda: lafc(
            torch.zeros(2 * (n - 1), 3, h, w, 2),
            torch.zeros(2 * (n - 1), 3, h, w, 1)))
        ids, _ = fgt_window_ids(n)
        fgt_f = counts._count(lambda: fgt(
            torch.zeros(*ids.shape, h, w, 3), torch.zeros(*ids.shape, h, w, 2),
            torch.zeros(*ids.shape, h, w, 1)))
    assert total == enc + ref + lafc_f + fgt_f


def test_train_step_flops_covers_the_backward():
    from tiny import train
    cfg, _ = train()
    step = counts.train_step_flops(cfg["generator"], cfg["flow_config"],
                                   cfg["dist_cnum"], 2, 5, 64, 64)
    from portbench.reference.fgt import FGT
    with torch.device("meta"), torch.no_grad():
        fwd = counts._count(lambda: FGT(cfg["generator"])(
            torch.zeros(2, 5, 64, 64, 3), torch.zeros(2, 5, 64, 64, 2),
            torch.zeros(2, 5, 64, 64, 1)))
    assert step > 3 * fwd
