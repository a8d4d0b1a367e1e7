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
  raw      copied as-is (biases, norms, running stats, spectral u)

The discriminator's spectral ``v`` also needs its entries permuted
(``_v_to_torch`` / ``_v_to_jax``).
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


def raft_small_mapping() -> Mapping:
    """RAFT --small tree (SmallEncoder bottlenecks, plain ConvGRU,
    FlowHead; reference raft.py:48-51, extractor.py:195-266,
    update.py:62-112) <-> fgt_tpu.models.raft paths. Its instance norms
    and cnet's missing norm carry no parameters."""
    P = ("params",)
    m: Mapping = {}
    for name in ("fnet", "cnet"):
        m.update(_conv(P + (name, "conv1"), f"{name}.conv1"))
        m.update(_conv(P + (name, "conv2"), f"{name}.conv2"))
        for i in range(3):
            for j in range(2):
                blk = P + (name, f"layer{i}_{j}")
                tblk = f"{name}.layer{i + 1}.{j}"
                for c in ("conv1", "conv2", "conv3"):
                    m.update(_conv(blk + (c,), f"{tblk}.{c}"))
                if i > 0 and j == 0:
                    m.update(_conv(blk + ("downsample",),
                                   f"{tblk}.downsample.0"))
    ub = P + ("update_block",)
    for c in ("convc1", "convf1", "convf2", "conv"):
        m.update(_conv(ub + ("encoder", c), f"update_block.encoder.{c}"))
    for g in ("convz", "convr", "convq"):
        m.update(_conv(ub + ("gru", g), f"update_block.gru.{g}"))
    m.update(_conv(ub + ("flow_conv1",), "update_block.flow_head.conv1"))
    m.update(_conv(ub + ("flow_conv2",), "update_block.flow_head.conv2"))
    return m


def i3d_mapping() -> Mapping:
    """The JAX package's I3D (``fgt_tpu/core/vfid.py``) <-> pytorch-i3d
    ``InceptionI3d`` keys (what ``convert_i3d_checkpoint`` reads):
    every unit a bias-free Conv3d and a BatchNorm3d named ``bn``."""
    from fgt_tpu_torch.core.vfid import BRANCHES, INCEPTION_BLOCKS, STEM

    P, S = ("params",), ("batch_stats",)
    units = [name for name, *_ in STEM] + [
        f"{name}.{b}" for name, _ in INCEPTION_BLOCKS for b in BRANCHES]
    m: Mapping = {}
    for unit in units:
        path = tuple(unit.split("."))
        m.update(_conv(P + path + ("conv3d",), f"{unit}.conv3d", "conv3d",
                       bias=False))
        m[P + path + ("bn", "scale")] = (f"{unit}.bn.weight", "raw")
        m[P + path + ("bn", "bias")] = (f"{unit}.bn.bias", "raw")
        m[S + path + ("bn", "mean")] = (f"{unit}.bn.running_mean", "raw")
        m[S + path + ("bn", "var")] = (f"{unit}.bn.running_var", "raw")
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


def lafc_single_mapping(res_blocks: int = 1) -> Mapping:
    P = ("params", "net")
    m: Mapping = {}
    m.update(_vanilla(P + ("enc2_conv0",), "net.encoder2.1"))
    m.update(_vanilla(P + ("enc2_conv1",), "net.encoder2.2"))
    m.update(_vanilla(P + ("enc4_conv0",), "net.encoder4.0"))
    m.update(_vanilla(P + ("enc4_conv1",), "net.encoder4.1"))
    for i in range(res_blocks):
        m.update(_conv(P + (f"res{i}", "conv1"), f"net.res_blocks.{i}.conv1"))
        m.update(_conv(P + (f"res{i}", "conv2"), f"net.res_blocks.{i}.conv2"))
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


def vgg19_mapping() -> Mapping:
    """The JAX package's ``VGG19Features`` (``conv0 .. conv15``) <->
    torchvision's ``features.<idx>`` keys (what
    ``convert_vgg19_checkpoint`` reads, in conv order)."""
    from fgt_tpu_torch.train.perceptual import conv_indices

    m: Mapping = {}
    for i, idx in enumerate(conv_indices()):
        m.update(_conv(("params", f"conv{i}"), f"features.{idx}"))
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


def discriminator_mapping() -> Mapping:
    """T-PatchGAN: flax params + spectral ``u``; the spectral ``v`` needs
    a permutation and goes through :func:`jax_to_torch_discriminator_state`
    / :func:`torch_to_jax_discriminator_leaves`."""
    P = ("params",)
    S = ("spectral",)
    m: Mapping = {}
    for i in range(5):
        m[P + (f"conv{i}", "kernel")] = (f"conv.{2 * i}.weight_orig", "conv3d")
        m[S + (f"conv{i}", "u")] = (f"conv.{2 * i}.weight_u", "raw")
    m.update(_conv(P + ("conv5",), "conv.10", "conv3d"))
    return m


# The power iteration's v spans the flattened kernel minus its output
# axis: torch flattens OIDHW as I·D·H·W, flax flattens DHWIO as D·H·W·I.

def _v_to_torch(v: np.ndarray, kernel_oidhw: tuple) -> np.ndarray:
    _, i, d, h, w = kernel_oidhw
    return v.reshape(d, h, w, i).transpose(3, 0, 1, 2).reshape(-1)


def _v_to_jax(v: np.ndarray, kernel_oidhw: tuple) -> np.ndarray:
    _, i, d, h, w = kernel_oidhw
    return v.reshape(i, d, h, w).transpose(1, 2, 3, 0).reshape(-1)


def jax_to_torch_discriminator_state(variables_np: dict
                                     ) -> Dict[str, torch.Tensor]:
    """T-PatchGAN flax variables (params + spectral) -> torch
    ``state_dict`` with ``weight_orig``, ``weight_u`` and ``weight_v``."""
    state = jax_to_torch_state(variables_np, discriminator_mapping())
    for i in range(5):
        shape = tuple(state[f"conv.{2 * i}.weight_orig"].shape)
        v = np.asarray(variables_np["spectral"][f"conv{i}"]["v"])
        state[f"conv.{2 * i}.weight_v"] = torch.from_numpy(
            np.ascontiguousarray(_v_to_torch(v, shape)).astype(
                np.float32))
    return state


def torch_to_jax_discriminator_leaves(state: Dict[str, Any]
                                      ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Torch T-PatchGAN ``state_dict`` -> {flax path: array}, spectral
    ``v`` included."""
    out = torch_to_jax_leaves(state, discriminator_mapping())
    for i in range(5):
        w = state[f"conv.{2 * i}.weight_orig"]
        v = state[f"conv.{2 * i}.weight_v"].detach().cpu().float().numpy()
        out[("spectral", f"conv{i}", "v")] = _v_to_jax(
            v, tuple(w.shape))
    return out


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
