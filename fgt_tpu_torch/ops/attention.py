"""FGT attention modules — counterparts of ``fgt_tpu/ops/attention.py``.

* :class:`TMHSA`, temporal window attention: every ``g x g`` coarse cell
  attends across all frames of the window; the attention itself runs
  through kernel K2 (:func:`fgt_tpu_torch.ops.flash_attention.flash_attend`)
  on CUDA tensors.
* :class:`FlowGuidedSWMHSA`, flow-guided spatial window attention with
  global tokens: torch einsums (XLA code in the JAX package, no Pallas).

Attribute names follow the reference attention_base.py /
attention_flow.py (``query_embedding``, ``reweightFlow.0``,
``global_extract_k`` ...). LayerNorm epsilon is flax's 1e-6, the value
the JAX package runs with.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from fgt_tpu_torch.ops.flash_attention import flash_attend

LN_EPS = 1e-6


def _pad_hw(x: torch.Tensor, pad_b: int, pad_r: int) -> torch.Tensor:
    """Zero-pad the H (dim 1) and W (dim 2) axes of [B, H, W, C]."""
    if pad_b == 0 and pad_r == 0:
        return x
    return F.pad(x, (0, 0, 0, pad_r, 0, pad_b))


class TMHSA(nn.Module):
    def __init__(self, d_model: int, group_size: int, num_heads: int):
        super().__init__()
        self.group_size = group_size
        self.num_heads = num_heads
        self.query_embedding = nn.Linear(d_model, d_model)
        self.key_embedding = nn.Linear(d_model, d_model)
        self.value_embedding = nn.Linear(d_model, d_model)
        self.output_linear = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
        bt, n, c = x.shape
        assert n == h * w, f"token count {n} != {h}x{w}"
        b = bt // t
        g = self.group_size
        heads = self.num_heads
        ch = c // heads
        wh, ww = math.ceil(h / g), math.ceil(w / g)
        pad_b = (wh - h % wh) % wh
        pad_r = (ww - w % ww) % ww
        new_h, new_w = h + pad_b, w + pad_r
        win_h, win_w = new_h // g, new_w // g

        xs = _pad_hw(x.reshape(bt, h, w, c), pad_b, pad_r)

        def part(y):
            y = y.reshape(b, t, g, win_h, g, win_w, heads, ch)
            y = y.permute(0, 2, 4, 6, 1, 3, 5, 7)
            return y.reshape(b, g * g, heads, t * win_h * win_w, ch)

        att = flash_attend(part(self.query_embedding(xs)),
                           part(self.key_embedding(xs)),
                           part(self.value_embedding(xs)),
                           1.0 / math.sqrt(ch))
        att = att.reshape(b, g, g, heads, t, win_h, win_w, ch)
        att = att.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(bt, new_h, new_w, c)
        att = att[:, :h, :w].reshape(bt, n, c)
        return self.output_linear(att)


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

    def forward(self, x: torch.Tensor, f: torch.Tensor, h: int,
                w: int) -> torch.Tensor:
        bt, n, c = x.shape
        cf = f.shape[-1]
        ws = self.window_size
        heads = self.num_heads
        ch = c // heads
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
        q = self.query_embedding(self.q_norm(q_win))
        k_loc = self.key_embedding(self.k_norm(q_win))
        k_glo = self.key_embedding(self.k_norm(k_global))
        v_loc = self.value_embedding(self.v_norm(x_win))
        v_glo = self.value_embedding(self.v_norm(v_global))

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
        att = att.to(x.dtype).reshape(bt, gh, gw, ws, ws, c)
        att = att.permute(0, 1, 3, 2, 4, 5).reshape(bt, new_h, new_w, c)
        att = att[:, :h, :w].reshape(bt, n, c)
        return self.output_linear(att)
