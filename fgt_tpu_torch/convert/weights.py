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
  sn_v     a spectral-norm ``v``: its entries permuted, as flax flattens
           a kernel (k.., I) and torch (I, k..) (``_v_to_torch`` /
           ``_v_to_jax``, given the sibling ``weight_orig``'s shape)

The LAFC, LAFC-single and FGT tables follow the config's ``conv_type``
and ``norm`` (:func:`_block`): a gated block's ``feature`` / ``gating``
convs, BN's ``params`` scale / bias and ``batch_stats`` mean / var, IN's
scale / bias, SN's ``spectral`` u / v.
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


def _weight_orig_shape(state: Dict[str, Any], v_key: str) -> tuple:
    return tuple(state[v_key[:-len("weight_v")] + "weight_orig"].shape)


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
    for torch_key, kind in mapping.values():
        if kind == "sn_v" and torch_key in state:
            state[torch_key] = torch.from_numpy(np.ascontiguousarray(
                _v_to_torch(state[torch_key].numpy(),
                            _weight_orig_shape(state, torch_key))))
    return state


def torch_to_jax_leaves(state: Dict[str, Any], mapping: Mapping
                        ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Torch ``state_dict`` -> {flax path: flax-layout array}."""
    out = {}
    for flax_path, (torch_key, kind) in mapping.items():
        t = state[torch_key]
        arr = t.detach().cpu().float().numpy() if hasattr(t, "detach") \
            else np.asarray(t)
        if kind == "sn_v":
            arr = _v_to_jax(arr, _weight_orig_shape(state, torch_key))
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


def _block(path, torch_prefix, conv_type="vanilla", norm=None,
           kind="conv2d", bias=True, deconv=False) -> Mapping:
    """One block of ``fgt_tpu.ops.conv_blocks`` whose flax path below
    the collection is ``path`` <-> the port's block at ``torch_prefix``
    (a deconv's block one level down, as ``conv``): the vanilla block's
    ``conv`` or the gated block's ``feature`` / ``gating`` convs (SN:
    ``weight_orig`` + ``spectral`` u / v), the partial block's bias-free
    ``feature`` conv and own ``bias``, and the BN / IN layer."""
    if deconv:
        path, torch_prefix = path + ("conv",), torch_prefix + ".conv"
    P, S, B = ("params",) + path, ("spectral",) + path, \
        ("batch_stats",) + path
    convs = {"vanilla": [("conv", "featureConv")],
             "gated": [("feature", "featureConv"), ("gating", "gatingConv")],
             "partial": [("feature", "featureConv")]}[conv_type]
    sn = norm == "SN" and conv_type != "partial"
    m: Mapping = {}
    for ours, theirs in convs:
        t = f"{torch_prefix}.{theirs}"
        if sn:
            m[P + (ours, "kernel")] = (f"{t}.weight_orig", kind)
            m[S + (ours, "u")] = (f"{t}.weight_u", "raw")
            m[S + (ours, "v")] = (f"{t}.weight_v", "sn_v")
            if bias:
                m[P + (ours, "bias")] = (f"{t}.bias", "raw")
        else:
            m.update(_conv(P + (ours,), t, kind,
                           bias and conv_type != "partial"))
    if conv_type == "partial" and bias:
        m[P + ("bias",)] = (f"{torch_prefix}.bias", "raw")
    t = f"{torch_prefix}.norm_layer"
    if norm == "BN":
        m.update(_batchnorm(P + ("norm_act",), B + ("norm_act",), t))
    elif norm == "IN":
        m.update(_layernorm(P + ("norm_act", "GroupNorm_0"), t))
    return m


def lafc_mapping(res_blocks: int = 1, conv_type: str = "vanilla") -> Mapping:
    """LAFC at ``res_blocks`` and ``conv_type`` (its blocks take no
    norm)."""
    N = ("net",)
    m: Mapping = {}

    def blk(ours, theirs, kind="conv2d", deconv=False):
        m.update(_block(N + ours, theirs, conv_type, None, kind,
                        deconv=deconv))

    for ours, theirs in (("enc2_block0", "net.encoder2.1"),
                         ("enc2_block1", "net.encoder2.2"),
                         ("enc4_block0", "net.encoder4.0"),
                         ("enc4_block1", "net.encoder4.1")) + tuple(
            (f"res{i}", f"net.res_blocks.{i}") for i in range(res_blocks)):
        blk((ours, "conv1"), theirs + ".conv1", "conv3d")
        blk((ours, "conv2"), theirs + ".conv2", "conv3d")
    for c in ("condense2", "condense4_pre", "condense4_post"):
        blk((c,), f"net.{c}", "conv3d")
    _trunk_2d(blk)
    return m


def _trunk_2d(blk) -> None:
    """The 2-D middle, decoders and edge head that LAFC and LAFC-single
    share."""
    for i in range(4):
        blk((f"middle{i}",), f"net.middle.{i}")
    blk(("dec2_deconv",), "net.decoder2.0", deconv=True)
    blk(("dec2_conv0",), "net.decoder2.1")
    blk(("dec2_conv1",), "net.decoder2.2")
    blk(("dec_deconv",), "net.decoder.0", deconv=True)
    blk(("dec_conv0",), "net.decoder.1")
    blk(("dec_conv1",), "net.decoder.2")
    for ours, theirs in (("projection", "projection"), ("mid1", "mid_layer_1"),
                         ("mid2", "mid_layer_2"), ("out", "out_layer")):
        blk(("edge_detector", ours), f"net.edgeDetector.{theirs}")


def lafc_single_mapping(res_blocks: int = 1,
                        conv_type: str = "vanilla") -> Mapping:
    """LAFC-single at ``res_blocks`` and ``conv_type`` (its residual
    blocks are plain convs)."""
    N = ("net",)
    m: Mapping = {}

    def blk(ours, theirs, kind="conv2d", deconv=False):
        m.update(_block(N + ours, theirs, conv_type, None, kind,
                        deconv=deconv))

    blk(("enc2_conv0",), "net.encoder2.1")
    blk(("enc2_conv1",), "net.encoder2.2")
    blk(("enc4_conv0",), "net.encoder4.0")
    blk(("enc4_conv1",), "net.encoder4.1")
    P = ("params",) + N
    for i in range(res_blocks):
        m.update(_conv(P + (f"res{i}", "conv1"), f"net.res_blocks.{i}.conv1"))
        m.update(_conv(P + (f"res{i}", "conv2"), f"net.res_blocks.{i}.conv2"))
    _trunk_2d(blk)
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


def fgt_mapping(num_blocks: int = 8, conv_type: str = "vanilla",
                norm: str | None = None) -> Mapping:
    """FGT at ``num_blocks``; the flow encoder and decoder blocks in
    ``conv_type`` and ``norm``."""
    P = ("params", "net")
    m: Mapping = {}

    def blk(ours, theirs, deconv=False):
        m.update(_block(("net",) + ours, theirs, conv_type, norm,
                        deconv=deconv))

    for i in range(9):
        m.update(_conv(P + ("frame_encoder", f"conv{i}"),
                       f"net.frame_endoder.layers.{2 * i}"))
    for i in range(4):
        blk(("flow_encoder", f"block{i}"), f"net.flow_encoder.{i + 1}")
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
    for layer in ("layer1", "layer2", "layer3", "final"):
        blk(("decoder", layer), f"net.decoder.{layer}",
            deconv=layer in ("layer1", "layer3"))
    return m


def discriminator_mapping() -> Mapping:
    """T-PatchGAN: flax params + spectral ``u`` (the JAX converter's
    table); :func:`jax_to_torch_discriminator_state` /
    :func:`torch_to_jax_discriminator_leaves` add the spectral ``v``."""
    P = ("params",)
    S = ("spectral",)
    m: Mapping = {}
    for i in range(5):
        m[P + (f"conv{i}", "kernel")] = (f"conv.{2 * i}.weight_orig", "conv3d")
        m[S + (f"conv{i}", "u")] = (f"conv.{2 * i}.weight_u", "raw")
    m.update(_conv(P + ("conv5",), "conv.10", "conv3d"))
    return m


# The power iteration's v spans the flattened kernel minus its output
# axis: torch flattens O I k.. as I·k.., flax flattens k.. I O as k..·I
# (2-D and 3-D kernels alike).

def _v_to_torch(v: np.ndarray, kernel_oik: tuple) -> np.ndarray:
    i, k = kernel_oik[1], tuple(kernel_oik[2:])
    return np.moveaxis(v.reshape(k + (i,)), -1, 0).reshape(-1)


def _v_to_jax(v: np.ndarray, kernel_oik: tuple) -> np.ndarray:
    i, k = kernel_oik[1], tuple(kernel_oik[2:])
    return np.moveaxis(v.reshape((i,) + k), 0, -1).reshape(-1)


def _discriminator_with_v() -> Mapping:
    m = discriminator_mapping()
    for i in range(5):
        m[("spectral", f"conv{i}", "v")] = (f"conv.{2 * i}.weight_v", "sn_v")
    return m


def jax_to_torch_discriminator_state(variables_np: dict
                                     ) -> Dict[str, torch.Tensor]:
    """T-PatchGAN flax variables (params + spectral) -> torch
    ``state_dict`` with ``weight_orig``, ``weight_u`` and ``weight_v``."""
    return jax_to_torch_state(variables_np, _discriminator_with_v())


def torch_to_jax_discriminator_leaves(state: Dict[str, Any]
                                      ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Torch T-PatchGAN ``state_dict`` -> {flax path: array}, spectral
    ``v`` included."""
    return torch_to_jax_leaves(state, _discriminator_with_v())


# --------------------------------------------------------------------------
# the JAX package's weight files
# --------------------------------------------------------------------------

KINDS = ("raft", "raft_small", "lafc", "lafc_single", "fgt", "i3d")


def _meta_module(kind: str, config: dict) -> torch.nn.Module:
    """The port's module of ``kind`` on the meta device (shapes only)."""
    from fgt_tpu_torch.core import vfid
    from fgt_tpu_torch.models import fgt, lafc, lafc_single, raft

    with torch.device("meta"):
        if kind in ("raft", "raft_small"):
            return raft.RAFT(small=kind == "raft_small")
        if kind == "lafc":
            return lafc.Model(config)
        if kind == "lafc_single":
            return lafc_single.Model(config)
        if kind == "fgt":
            return fgt.Model(config)
        return vfid.I3D()


def mapping_for(kind: str, config: dict) -> Mapping:
    """The table the JAX package's converter picks for ``kind``
    (``tools/convert_weights.py``): RAFT big or small, LAFC and
    LAFC-single at the config's ``resBlocks`` and FGT at its
    ``numBlocks`` (the JAX ``from_dict`` precedence over ``res_blocks`` /
    ``num_blocks``), each in its ``conv_type`` (and FGT's ``norm``),
    I3D."""
    from fgt_tpu_torch.models.fgt import FGTConfig
    from fgt_tpu_torch.models.lafc import lafc_keys

    if kind == "raft":
        return raft_mapping()
    if kind == "raft_small":
        return raft_small_mapping()
    if kind in ("lafc", "lafc_single"):
        keys = lafc_keys(config)
        table = lafc_mapping if kind == "lafc" else lafc_single_mapping
        return table(int(keys["res_blocks"]), keys["conv_type"])
    if kind == "fgt":
        c = FGTConfig.from_dict(config)
        return fgt_mapping(int(c.num_blocks), c.conv_type, c.norm)
    if kind == "i3d":
        return i3d_mapping()
    raise ValueError(f"unknown model kind {kind!r}; one of {KINDS}")


def _flatten(tree, prefix=()) -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (k,)))
    return out


def state_from_variables(kind: str, tree: dict,
                         config: dict | None = None
                         ) -> Dict[str, torch.Tensor]:
    """A flax variable tree of the JAX package (as
    ``utils/checkpoint.load_pytree`` reads a ``.msgpack``) -> the port's
    ``state_dict`` of model ``kind`` (one of :data:`KINDS`) built from
    ``config``. A bare params dict (no top-level ``params``) is wrapped.
    Every leaf of the table must be there at the shape the port's module
    takes, and the tree must hold nothing else: anything missing, extra
    or misshapen raises ``ValueError`` naming its path, so no tree loads
    in part."""
    config = dict(config or {})
    mapping = mapping_for(kind, config)
    if not isinstance(tree, dict):
        raise ValueError(f"{kind}: a variable tree is a dict, not "
                         f"{type(tree).__name__}")
    if "params" not in tree:
        tree = {"params": tree}
    leaves = _flatten(tree)
    want = _meta_module(kind, config).state_dict()
    name = "/".join
    missing = [name(p) for p in mapping if p not in leaves]
    extra = [name(p) for p in leaves if p not in mapping]
    bad = []
    for path, (key, how) in mapping.items():
        if path not in leaves:
            continue
        leaf = leaves[path]
        if isinstance(leaf, torch.Tensor):       # bfloat16 leaves
            leaf = leaves[path] = leaf.float().numpy()
        leaf, shape = np.asarray(leaf), tuple(want[key].shape)
        if leaf.ndim != len(shape) or \
                jax_to_torch_array(how, leaf).shape != shape:
            bad.append(f"{name(path)} {leaf.shape} (the port's {key} is "
                       f"{shape})")
    if missing or extra or bad:
        raise ValueError(
            f"{kind}: the variable tree does not match the model"
            + "".join(f"; {what} ({len(paths)}): {paths[:8]}"
                      for what, paths in (("missing", missing),
                                          ("not in the model", extra),
                                          ("wrong shape", bad)) if paths))
    tree_np = {}
    for path, leaf in leaves.items():
        node = tree_np
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return jax_to_torch_state(tree_np, mapping)


def load_weights(path: str, kind: str, config: dict | None = None
                 ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of model ``kind`` in the weights file at
    ``path``: a JAX package ``*.msgpack`` through
    :func:`state_from_variables`, anything else a ``torch.load`` state
    dict (``utils/checkpoint.load_state_dict``)."""
    from fgt_tpu_torch.utils import checkpoint

    if path.endswith(".msgpack"):
        return state_from_variables(kind, checkpoint.load_pytree(path),
                                    config)
    return checkpoint.load_state_dict(path)


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
