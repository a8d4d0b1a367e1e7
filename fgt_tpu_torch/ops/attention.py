"""FGT attention modules — counterparts of ``fgt_tpu/ops/attention.py``.

* :class:`TMHSA`, temporal window attention: every ``g x g`` coarse cell
  attends across all frames of the window; the attention itself runs
  through kernel K2 (:func:`fgt_tpu_torch.ops.flash_attention.flash_attend`)
  on CUDA tensors.
* :class:`FlowGuidedSWMHSA`, flow-guided spatial window attention with
  global tokens: torch einsums (XLA code in the JAX package, no Pallas).

Tensor parallelism (``parallel/partition.shard_module`` calls
:meth:`TMHSA.shard` / :meth:`FlowGuidedSWMHSA.shard`): a module holds
heads / tp local heads of q, k and v (column-parallel, behind Megatron's
*f*) and the matching input rows of ``output_linear`` (row-parallel,
all-reduced over tp before its replicated bias). The spatial module's
``reweightFlow``, LayerNorms and ``global_extract_k/v`` stay replicated.

Sequence parallelism (Ulysses, JAX ``TMHSA.seq_axis``): each rank of
the sp group holds its share of the folded b·t frames (uneven where sp
does not divide b·t, as JAX's partitioner shards such an axis); TMHSA's
q, k and v go frame-sharded -> head-sharded by an all-to-all, K2 runs
on this rank's heads over every frame, and the result goes back. The
spatial module is per frame and needs nothing.

Attribute names follow the reference attention_base.py /
attention_flow.py (``query_embedding``, ``reweightFlow.0``,
``global_extract_k`` ...). LayerNorm epsilon is flax's 1e-6, the value
the JAX package runs with.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fgt_tpu_torch.ops.flash_attention import flash_attend
from fgt_tpu_torch.parallel.collectives import (all_to_all, copy_to_group,
                                                group_rank,
                                                row_parallel_linear)

LN_EPS = 1e-6


def _pad_hw(x: torch.Tensor, pad_b: int, pad_r: int) -> torch.Tensor:
    """Zero-pad the H (dim 1) and W (dim 2) axes of [B, H, W, C]."""
    if pad_b == 0 and pad_r == 0:
        return x
    return F.pad(x, (0, 0, 0, pad_r, 0, pad_b))


class FrameShard(NamedTuple):
    """This rank's share of the folded b·t frames under sequence
    parallelism: every rank's frame count (``splits``, in rank order)
    and the sp group."""

    splits: Sequence[int]
    group: object


def frames_to_heads(y: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    """[bt_r, ..., c] (this rank's frames, every local head) ->
    [bt, ..., c / sp] (every frame, this rank's heads)."""
    sp = len(shard.splits)
    bt_r, rest, c = y.shape[0], y.shape[1:-1], y.shape[-1]
    cells = math.prod(rest)
    y = y.reshape(bt_r, cells, sp, c // sp).permute(2, 0, 1, 3)
    y = all_to_all(y.reshape(sp * bt_r, cells, c // sp), shard.splits,
                   [bt_r] * sp, shard.group)
    return y.reshape(sum(shard.splits), *rest, c // sp)


def heads_to_frames(y: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    """The inverse of :func:`frames_to_heads`."""
    sp = len(shard.splits)
    bt_r = shard.splits[group_rank(shard.group)]
    rest, cs = y.shape[1:-1], y.shape[-1]
    cells = math.prod(rest)
    y = all_to_all(y.reshape(y.shape[0], cells, cs), [bt_r] * sp,
                   shard.splits, shard.group)
    y = y.reshape(sp, bt_r, cells, cs).permute(1, 2, 0, 3)
    return y.reshape(bt_r, *rest, sp * cs)


def _local_heads(num_heads: int, tp: int, name: str) -> int:
    if num_heads % tp:
        raise ValueError(f"{name}: {num_heads} heads do not split over "
                         f"tp {tp} (the split is over whole heads)")
    return num_heads // tp


class TMHSA(nn.Module):
    def __init__(self, d_model: int, group_size: int, num_heads: int):
        super().__init__()
        self.group_size = group_size
        self.num_heads = num_heads
        self.local_heads = num_heads
        self.tp_group = None
        self.query_embedding = nn.Linear(d_model, d_model)
        self.key_embedding = nn.Linear(d_model, d_model)
        self.value_embedding = nn.Linear(d_model, d_model)
        self.output_linear = nn.Linear(d_model, d_model)

    def shard(self, group, tp: int) -> None:
        """Run on heads / tp local heads, collectives on ``group``."""
        self.local_heads = _local_heads(self.num_heads, tp, "TMHSA")
        self.tp_group = group

    def forward(self, x: torch.Tensor, t: int, h: int, w: int,
                shard: Optional[FrameShard] = None) -> torch.Tensor:
        """x: [b·t, h·w, c], or this rank's frames of them under
        ``shard`` (sequence parallelism)."""
        bt_r, n, c = x.shape
        assert n == h * w, f"token count {n} != {h}x{w}"
        bt = bt_r if shard is None else sum(shard.splits)
        b = bt // t
        g = self.group_size
        heads = self.local_heads
        ch = c // self.num_heads
        wh, ww = math.ceil(h / g), math.ceil(w / g)
        pad_b = (wh - h % wh) % wh
        pad_r = (ww - w % ww) % ww
        new_h, new_w = h + pad_b, w + pad_r
        win_h, win_w = new_h // g, new_w // g

        xs = _pad_hw(x.reshape(bt_r, h, w, c), pad_b, pad_r)
        xs = copy_to_group(xs, self.tp_group)
        qkv = [emb(xs) for emb in (self.query_embedding, self.key_embedding,
                                   self.value_embedding)]
        if shard is not None:
            qkv = [frames_to_heads(y, shard) for y in qkv]
            heads //= len(shard.splits)

        def part(y):
            y = y.reshape(b, t, g, win_h, g, win_w, heads, ch)
            y = y.permute(0, 2, 4, 6, 1, 3, 5, 7)
            return y.reshape(b, g * g, heads, t * win_h * win_w, ch)

        att = flash_attend(*(part(y) for y in qkv), 1.0 / math.sqrt(ch))
        att = att.reshape(b, g, g, heads, t, win_h, win_w, ch)
        att = att.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(
            bt, new_h, new_w, heads * ch)
        if shard is not None:
            att = heads_to_frames(att, shard)
        att = att[:, :h, :w].reshape(bt_r, n, att.shape[-1])
        return row_parallel_linear(self.output_linear, att, self.tp_group)


class FlowGuidedSWMHSA(nn.Module):
    """Reference SWMHSA_depthGlobalWindowConcatLN_qkFlow_reweightFlow
    (attention_flow.py:25-171): flow features gated by
    sigmoid(Linear(x ++ f)); q/k from frame ++ gated flow, v from the
    frame; keys/values are window tokens ++ global tokens from depthwise
    stride-``global_stride`` convs. Local and global keys are contracted
    separately, so global K/V are never repeated per window."""

    def __init__(self, d_model: int, flow_d_model: int, window_size: int,
                 global_stride: int, num_heads: int):
        super().__init__()
        c, cf = d_model, flow_d_model
        self.window_size = window_size
        self.num_heads = num_heads
        self.local_heads = num_heads
        self.tp_group = None
        self.query_embedding = nn.Linear(c + cf, c)
        self.key_embedding = nn.Linear(c + cf, c)
        self.value_embedding = nn.Linear(c, c)
        self.output_linear = nn.Linear(c, c)
        self.reweightFlow = nn.Sequential(nn.Linear(c + cf, cf), nn.Sigmoid())
        self.q_norm = nn.LayerNorm(c + cf, eps=LN_EPS)
        self.k_norm = nn.LayerNorm(c + cf, eps=LN_EPS)
        self.v_norm = nn.LayerNorm(c, eps=LN_EPS)
        self.global_extract_k = nn.Conv2d(c + cf, c + cf, global_stride,
                                          stride=global_stride, groups=c + cf)
        self.global_extract_v = nn.Conv2d(c, c, global_stride,
                                          stride=global_stride, groups=c)

    def shard(self, group, tp: int) -> None:
        """Run on heads / tp local heads of q, k and v, collectives on
        ``group``."""
        self.local_heads = _local_heads(self.num_heads, tp,
                                        "FlowGuidedSWMHSA")
        self.tp_group = group

    def forward(self, x: torch.Tensor, f: torch.Tensor, h: int,
                w: int) -> torch.Tensor:
        bt, n, c = x.shape
        cf = f.shape[-1]
        ws = self.window_size
        heads = self.local_heads
        ch = c // self.num_heads
        pad_r = (ws - w % ws) % ws
        pad_b = (ws - h % ws) % ws
        new_h, new_w = h + pad_b, w + pad_r
        gh, gw = new_h // ws, new_w // ws

        xs = _pad_hw(x.reshape(bt, h, w, c), pad_b, pad_r)
        fs = _pad_hw(f.reshape(bt, h, w, cf), pad_b, pad_r)
        fs = fs * self.reweightFlow(torch.cat([xs, fs], dim=-1))
        qk = torch.cat([xs, fs], dim=-1)                  # [bt, H, W, c+cf]
        qk_c = c + cf

        def nchw_conv(conv, y):
            return conv(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        k_global = nchw_conv(self.global_extract_k, qk).reshape(bt, -1, qk_c)
        v_global = nchw_conv(self.global_extract_v, xs).reshape(bt, -1, c)

        def windows(y, cc):
            y = y.reshape(bt, gh, ws, gw, ws, cc).permute(0, 1, 3, 2, 4, 5)
            return y.reshape(bt, gh * gw, ws * ws, cc)

        q_win = windows(qk, qk_c)
        x_win = windows(xs, c)
        tpg = self.tp_group
        q = self.query_embedding(copy_to_group(self.q_norm(q_win), tpg))
        k_loc = self.key_embedding(copy_to_group(self.k_norm(q_win), tpg))
        k_glo = self.key_embedding(copy_to_group(self.k_norm(k_global), tpg))
        v_loc = self.value_embedding(copy_to_group(self.v_norm(x_win), tpg))
        v_glo = self.value_embedding(copy_to_group(self.v_norm(v_global),
                                                   tpg))

        nw, nloc = gh * gw, ws * ws
        q = q.reshape(bt, nw, nloc, heads, ch).float()
        k_loc = k_loc.reshape(bt, nw, nloc, heads, ch).float()
        v_loc = v_loc.reshape(bt, nw, nloc, heads, ch).float()
        k_glo = k_glo.reshape(bt, -1, heads, ch).float()
        v_glo = v_glo.reshape(bt, -1, heads, ch).float()

        scale = 1.0 / math.sqrt(ch)
        s_loc = torch.einsum("bwqhc,bwkhc->bwhqk", q, k_loc) * scale
        s_glo = torch.einsum("bwqhc,bkhc->bwhqk", q, k_glo) * scale
        probs = torch.softmax(torch.cat([s_loc, s_glo], dim=-1), dim=-1)
        att = (torch.einsum("bwhqk,bwkhc->bwqhc", probs[..., :nloc], v_loc)
               + torch.einsum("bwhqk,bkhc->bwqhc", probs[..., nloc:], v_glo))
        cl = heads * ch
        att = att.to(x.dtype).reshape(bt, gh, gw, ws, ws, cl)
        att = att.permute(0, 1, 3, 2, 4, 5).reshape(bt, new_h, new_w, cl)
        att = att[:, :h, :w].reshape(bt, n, cl)
        return row_parallel_linear(self.output_linear, att, tpg)
