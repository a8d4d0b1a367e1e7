"""Weight bridge between fgt_tpu flax trees and the port's torch modules.

The port's modules use the original hitachinsk/FGT ``state_dict`` key
names, so the reference checkpoints load into them directly. The
``*_mapping`` tables (own copies of the flat ``flax path -> (torch key,
kind)`` tables of the JAX package's converter) bridge the two layouts in
both directions:

  conv2d   OIHW   <-> HWIO
  conv3d   OIDHW  <-> DHWIO
  dwconv2d (O,1,kh,kw) <-> (kh,kw,1,O)
  linear   (out,in) <-> (in,out)
  raw      copied as-is (biases, norms, running stats)
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

Mapping = Dict[Tuple[str, ...], Tuple[str, str]]


def torch_to_jax_array(kind: str, arr: np.ndarray) -> np.ndarray:
    """Torch layout -> flax layout for one leaf."""
    if kind in ("conv2d", "dwconv2d"):
        return arr.transpose(2, 3, 1, 0)
    if kind == "conv3d":
        return arr.transpose(2, 3, 4, 1, 0)
    if kind == "linear":
        return arr.T
    return arr


def jax_to_torch_array(kind: str, arr: np.ndarray) -> np.ndarray:
    """Flax layout -> torch layout for one leaf (inverse of
    :func:`torch_to_jax_array`)."""
    if kind in ("conv2d", "dwconv2d"):
        return arr.transpose(3, 2, 0, 1)
    if kind == "conv3d":
        return arr.transpose(4, 3, 0, 1, 2)
    if kind == "linear":
        return arr.T
    return arr


def _get_in(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def jax_to_torch_state(variables_np: dict, mapping: Mapping,
                       strict: bool = True) -> Dict[str, torch.Tensor]:
    """Flax variable tree (numpy leaves) -> torch ``state_dict``.

    Every mapped flax leaf becomes one torch entry under its reference
    key. With ``strict`` a mapped path missing from the tree raises."""
    state: Dict[str, torch.Tensor] = {}
    missing = []
    for flax_path, (torch_key, kind) in mapping.items():
        try:
            leaf = _get_in(variables_np, flax_path)
        except (KeyError, TypeError):
            missing.append("/".join(flax_path))
            continue
        arr = np.ascontiguousarray(jax_to_torch_array(kind, np.asarray(leaf)))
        state[torch_key] = torch.from_numpy(arr.astype(np.float32))
    if missing and strict:
        raise KeyError(f"flax paths missing from the tree: {missing[:10]} "
                       f"(+{max(0, len(missing) - 10)} more)")
    return state


def torch_to_jax_leaves(state: Dict[str, Any], mapping: Mapping
                        ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Torch ``state_dict`` -> {flax path: flax-layout array}."""
    out = {}
    for flax_path, (torch_key, kind) in mapping.items():
        t = state[torch_key]
        arr = t.detach().cpu().float().numpy() if hasattr(t, "detach") \
            else np.asarray(t)
        out[flax_path] = torch_to_jax_array(kind, arr)
    return out


# --------------------------------------------------------------------------
# per-model mappings
# --------------------------------------------------------------------------

def _conv(flax_prefix, torch_prefix, kind="conv2d", bias=True):
    m = {flax_prefix + ("kernel",): (torch_prefix + ".weight", kind)}
    if bias:
        m[flax_prefix + ("bias",)] = (torch_prefix + ".bias", "raw")
    return m


def _linear(flax_prefix, torch_prefix, bias=True):
    m = {flax_prefix + ("kernel",): (torch_prefix + ".weight", "linear")}
    if bias:
        m[flax_prefix + ("bias",)] = (torch_prefix + ".bias", "raw")
    return m


def _layernorm(flax_prefix, torch_prefix):
    return {flax_prefix + ("scale",): (torch_prefix + ".weight", "raw"),
            flax_prefix + ("bias",): (torch_prefix + ".bias", "raw")}


def _batchnorm(p_prefix, s_prefix, torch_prefix):
    return {
        p_prefix + ("BatchNorm_0", "scale"): (f"{torch_prefix}.weight", "raw"),
        p_prefix + ("BatchNorm_0", "bias"): (f"{torch_prefix}.bias", "raw"),
        s_prefix + ("BatchNorm_0", "mean"): (f"{torch_prefix}.running_mean",
                                             "raw"),
        s_prefix + ("BatchNorm_0", "var"): (f"{torch_prefix}.running_var",
                                            "raw"),
    }


def raft_mapping() -> Mapping:
    """RAFT/raft.py tree (big variant) <-> fgt_tpu.models.raft paths."""
    P = ("params",)
    S = ("batch_stats",)
    m: Mapping = {}

    def encoder(name, norm):
        mm = {}
        mm.update(_conv(P + (name, "conv1"), f"{name}.conv1"))
        mm.update(_conv(P + (name, "conv2"), f"{name}.conv2"))
        if norm == "batch":
            mm.update(_batchnorm(P + (name, "norm1"), S + (name, "norm1"),
                                 f"{name}.norm1"))
        for i in range(3):
            for j in range(2):
                blk = (name, f"layer{i}_{j}")
                tblk = f"{name}.layer{i + 1}.{j}"
                mm.update(_conv(P + blk + ("conv1",), tblk + ".conv1"))
                mm.update(_conv(P + blk + ("conv2",), tblk + ".conv2"))
                norms = ["norm1", "norm2"]
                if i > 0 and j == 0:  # strided block has downsample
                    mm.update(_conv(P + blk + ("downsample",),
                                    tblk + ".downsample.0"))
                    norms.append("norm3")
                if norm == "batch":
                    for nidx in norms:
                        mm.update(_batchnorm(P + blk + (nidx,),
                                             S + blk + (nidx,),
                                             f"{tblk}.{nidx}"))
        return mm

    m.update(encoder("fnet", "instance"))
    m.update(encoder("cnet", "batch"))

    ub = P + ("update_block",)
    for c in ("convc1", "convc2", "convf1", "convf2", "conv"):
        m.update(_conv(ub + ("encoder", c), f"update_block.encoder.{c}"))
    for ours, theirs in (("convz_h", "convz1"), ("convr_h", "convr1"),
                         ("convq_h", "convq1"), ("convz_v", "convz2"),
                         ("convr_v", "convr2"), ("convq_v", "convq2")):
        m.update(_conv(ub + ("gru", ours), f"update_block.gru.{theirs}"))
    m.update(_conv(ub + ("flow_conv1",), "update_block.flow_head.conv1"))
    m.update(_conv(ub + ("flow_conv2",), "update_block.flow_head.conv2"))
    m.update(_conv(ub + ("mask_conv1",), "update_block.mask.0"))
    m.update(_conv(ub + ("mask_conv2",), "update_block.mask.2"))
    return m


def _vanilla(flax_prefix, torch_prefix, kind="conv2d", bias=True):
    """A VanillaConv block: <prefix>/conv/kernel <- <prefix>.featureConv."""
    return _conv(flax_prefix + ("conv",), torch_prefix + ".featureConv",
                 kind, bias)


def lafc_mapping(res_blocks: int = 1) -> Mapping:
    P = ("params", "net")
    m: Mapping = {}

    def p3d(ours, theirs):
        mm = {}
        mm.update(_vanilla(P + (ours, "conv1"), theirs + ".conv1", "conv3d"))
        mm.update(_vanilla(P + (ours, "conv2"), theirs + ".conv2", "conv3d"))
        return mm

    m.update(p3d("enc2_block0", "net.encoder2.1"))
    m.update(p3d("enc2_block1", "net.encoder2.2"))
    m.update(p3d("enc4_block0", "net.encoder4.0"))
    m.update(p3d("enc4_block1", "net.encoder4.1"))
    for i in range(res_blocks):
        m.update(p3d(f"res{i}", f"net.res_blocks.{i}"))
    for c in ("condense2", "condense4_pre", "condense4_post"):
        m.update(_vanilla(P + (c,), f"net.{c}", "conv3d"))
    for i in range(4):
        m.update(_vanilla(P + (f"middle{i}",), f"net.middle.{i}"))
    m.update(_conv(P + ("dec2_deconv", "conv", "conv"),
                   "net.decoder2.0.conv.featureConv"))
    m.update(_vanilla(P + ("dec2_conv0",), "net.decoder2.1"))
    m.update(_vanilla(P + ("dec2_conv1",), "net.decoder2.2"))
    m.update(_conv(P + ("dec_deconv", "conv", "conv"),
                   "net.decoder.0.conv.featureConv"))
    m.update(_vanilla(P + ("dec_conv0",), "net.decoder.1"))
    m.update(_vanilla(P + ("dec_conv1",), "net.decoder.2"))
    for ours, theirs in (("projection", "projection"), ("mid1", "mid_layer_1"),
                         ("mid2", "mid_layer_2"), ("out", "out_layer")):
        m.update(_vanilla(P + ("edge_detector", ours),
                          f"net.edgeDetector.{theirs}"))
    return m


def _transformer_t(flax_prefix, torch_prefix):
    m = {}
    att = flax_prefix + ("attention",)
    for ours, theirs in (("query", "query_embedding"), ("key", "key_embedding"),
                         ("value", "value_embedding"), ("out", "output_linear")):
        m.update(_linear(att + (ours,), f"{torch_prefix}.attention.{theirs}"))
    m.update(_layernorm(flax_prefix + ("norm1",), f"{torch_prefix}.norm1"))
    m.update(_layernorm(flax_prefix + ("norm2",), f"{torch_prefix}.norm2"))
    m.update(_linear(flax_prefix + ("ffn", "conv1"), f"{torch_prefix}.ffn.conv1"))
    m.update(_linear(flax_prefix + ("ffn", "conv2"),
                     f"{torch_prefix}.ffn.conv2.2"))
    return m


def _transformer_s(flax_prefix, torch_prefix):
    m = {}
    att = flax_prefix + ("attention",)
    for ours, theirs in (("query", "query_embedding"), ("key", "key_embedding"),
                         ("value", "value_embedding"), ("out", "output_linear")):
        m.update(_linear(att + (ours,), f"{torch_prefix}.attention.{theirs}"))
    m.update(_linear(att + ("reweight",),
                     f"{torch_prefix}.attention.reweightFlow.0"))
    for nm in ("q_norm", "k_norm", "v_norm"):
        m.update(_layernorm(att + (nm,), f"{torch_prefix}.attention.{nm}"))
    m.update(_conv(att + ("global_k", "conv"),
                   f"{torch_prefix}.attention.global_extract_k", "dwconv2d"))
    m.update(_conv(att + ("global_v", "conv"),
                   f"{torch_prefix}.attention.global_extract_v", "dwconv2d"))
    m.update(_layernorm(flax_prefix + ("norm",), f"{torch_prefix}.norm"))
    m.update(_linear(flax_prefix + ("ffn", "conv1"), f"{torch_prefix}.ffn.conv1"))
    m.update(_linear(flax_prefix + ("ffn", "conv2"),
                     f"{torch_prefix}.ffn.conv2.2"))
    return m


def fgt_mapping(num_blocks: int = 8) -> Mapping:
    P = ("params", "net")
    m: Mapping = {}
    for i in range(9):
        m.update(_conv(P + ("frame_encoder", f"conv{i}"),
                       f"net.frame_endoder.layers.{2 * i}"))
    for i in range(4):
        m.update(_vanilla(P + ("flow_encoder", f"block{i}"),
                          f"net.flow_encoder.{i + 1}"))
    m.update(_conv(P + ("patch2vec",), "net.patch2vec"))
    m.update(_conv(P + ("f_patch2vec",), "net.f_patch2vec"))
    m.update(_conv(P + ("add_pos_emb", "proj"), "net.add_pos_emb.proj",
                   "dwconv2d"))
    m.update(_transformer_t(P + ("first_t_transformer",),
                            "net.first_t_transformer"))
    m.update(_transformer_s(P + ("first_s_transformer",),
                            "net.first_s_transformer"))
    for i in range(num_blocks // 2 - 1):
        m.update(_transformer_t(P + (f"block{i}_t",),
                                f"net.transformer.{i}.t_transformer"))
        m.update(_transformer_s(P + (f"block{i}_s",),
                                f"net.transformer.{i}.s_transformer"))
    m.update(_linear(P + ("vec2patch", "embedding"), "net.vec2patch.embedding"))
    m.update(_conv(P + ("decoder", "layer1", "conv", "conv"),
                   "net.decoder.layer1.conv.featureConv"))
    m.update(_vanilla(P + ("decoder", "layer2"), "net.decoder.layer2"))
    m.update(_conv(P + ("decoder", "layer3", "conv", "conv"),
                   "net.decoder.layer3.conv.featureConv"))
    m.update(_vanilla(P + ("decoder", "final"), "net.decoder.final"))
    return m


def load_state(module: torch.nn.Module, state: Dict[str, torch.Tensor]):
    """Strict load that keeps each parameter's dtype and device."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing[:10]}, "
                       f"unexpected {extra[:10]}")
    module.load_state_dict({k: v.to(own[k].dtype) for k, v in state.items()})
    return module
