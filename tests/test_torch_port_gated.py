"""Gated models and the conv norms in the port vs the JAX package, on the
CPU, at small widths (cnum 8):

* gated LAFC and LAFC-single (a ``norm`` in their config is ignored, as
  ``LAFCConfig`` ignores it) and gated FGT under each norm (None, BN, IN,
  SN), f32 and bf16 (twice the JAX package's own bf16 deviation);
* their ``.msgpack`` (written by the JAX package) through
  ``state_from_variables``, strict: it loads, round-trips through
  ``torch_to_jax_leaves``, and a missing or an extra leaf raises;
* the GAN step under BN and SN against ``make_fgt_train_step`` (SGD and
  three Adam steps): the JAX step optimises the generator's whole
  variable tree, so BN's running statistics move by their gradients as
  the weights do, and SN's u, v (stop_gradient) stay;
* a gated stage-1 step against ``make_lafc_train_step`` (the clip's
  global norm over the gate's doubled parameter set);
* the whole object-removal slice from JAX-written gated + BN checkpoint
  directories, the port's CLI against the JAX CLI;
* ``FGTTrainer`` on a gated BN generator: an exact resume, and its
  ``latest`` directory through the inference CLI's loader;
* the gated + BN generator under ``--tp 2`` on two gloo processes
  (``tests/torch_port_parallel_worker.py``): its forward against JAX,
  also under ``--sp 2``, one SGD GAN step against one process, also
  on two data-parallel ranks.

The JAX variables get random norm scales, biases and running statistics
(an identity layer would hide a mismatch) and SN's u, v after three
power iterations (a random pair can make sigma = u·W·v nearly cancel).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fgt_tpu.models.fgt import Model as JaxFGT
from fgt_tpu.models.lafc import Model as JaxLAFC
from fgt_tpu.models.lafc_single import Model as JaxLAFCSingle
from fgt_tpu.pipeline import video_inpainting as jvi
from fgt_tpu.train import fgt_step as jfs
from fgt_tpu.train import lafc_step as jls
from fgt_tpu.train import schedules as jsched
from fgt_tpu.train.trainer import LAFCTrainer as JaxLAFCTrainer
from fgt_tpu.utils import checkpoint as jckpt
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import discriminator as tdisc
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.models import lafc as tlafc
from fgt_tpu_torch.models import lafc_single as tls
from fgt_tpu_torch.pipeline import video_inpainting as tvi
from fgt_tpu_torch.train import fgt_step as tfs
from fgt_tpu_torch.train import schedules as tsched
from fgt_tpu_torch.train.lafc_step import LAFCTrainStep
from fgt_tpu_torch.utils import checkpoint
from test_torch_port_bf16 import assert_within_jax_bf16_spread, bf16_tree
from test_torch_port_conv_blocks import _randomize_norms
from test_torch_port_msgpack import _jax_variables
from test_torch_port_pipeline import TINY_FGT, TINY_LAFC, _video
from test_torch_port_train import (DIST_CNUM, FGT_SMALL, LAFC_SINGLE_SMALL,
                                   _assert_metrics, _batch)
from test_train_steps import LAFC_CFG, _lafc_batch

torch.set_num_threads(1)

NORMS = [None, "BN", "IN", "SN"]
GATED_FGT = dict(FGT_SMALL, conv_type="gated")
GATED_SINGLE = dict(LAFC_SINGLE_SMALL, conv_type="gated")
GATED_LAFC = dict(LAFC_CFG, conv_type="gated", norm="SN")   # norm ignored
SHAPE = (1, 3, 32, 32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _warm_spectral(variables, iters=3):
    """u, v after ``iters`` power iterations on each SN kernel (numpy)."""
    if "spectral" not in variables:
        return variables
    out = dict(variables)

    def walk(spec, params):
        new = {}
        for k, v in spec.items():
            if "u" in v and not isinstance(v["u"], dict):
                mat = params[k]["kernel"].reshape(-1, v["u"].shape[0]).T
                u = v["u"]
                for _ in range(iters):
                    vv = mat.T @ u
                    vv = vv / (np.linalg.norm(vv) + 1e-12)
                    u = mat @ vv
                    u = u / (np.linalg.norm(u) + 1e-12)
                new[k] = {"u": u.astype(np.float32),
                          "v": vv.astype(np.float32)}
            else:
                new[k] = walk(v, params[k])
        return new
    out["spectral"] = walk(variables["spectral"], variables["params"])
    return out


def _fgt_cfg(norm):
    return dict(GATED_FGT, norm=norm)


@functools.lru_cache(maxsize=None)
def _fgt_vars(norm):
    jm = JaxFGT(config=_fgt_cfg(norm))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros(SHAPE + (3,)),
                         jnp.zeros(SHAPE + (2,)), jnp.zeros(SHAPE + (1,)))
    return _warm_spectral(_randomize_norms(v, np.random.RandomState(5)))


def _fgt_map(norm):
    return weights.fgt_mapping(GATED_FGT["numBlocks"], "gated", norm)


def _port_fgt(norm, variables=None):
    port = tfgt.Model(_fgt_cfg(norm)).eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables or _fgt_vars(norm), _fgt_map(norm)))
    return port


def _fgt_inputs(seed=4, shape=SHAPE):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, shape + (3,)).astype(np.float32),
            rng.randn(*shape, 2).astype(np.float32),
            (rng.rand(*shape, 1) > 0.8).astype(np.float32))


@pytest.mark.parametrize("norm", NORMS)
def test_gated_fgt_matches_jax(norm):
    """f32, tolerance 1e-4 absolute (the vanilla FGT test's)."""
    frames, flows, masks = _fgt_inputs()
    want = jax.jit(JaxFGT(config=_fgt_cfg(norm)).apply)(
        _fgt_vars(norm), jnp.asarray(frames * (1 - masks)),
        jnp.asarray(flows), jnp.asarray(masks))
    with torch.no_grad():
        got = _port_fgt(norm)(_t(frames * (1 - masks)), _t(flows), _t(masks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@functools.lru_cache(maxsize=None)
def _lafc_pair(kind):
    b = _lafc_batch()
    if kind == "lafc":
        jm, cfg = JaxLAFC(config=GATED_LAFC), GATED_LAFC
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(b["flows"]),
                             jnp.asarray(b["masks"]))
        return jm.apply, _np(v), weights.lafc_mapping(0, "gated"), cfg
    cfg = dict(GATED_LAFC, model="lafc_single")
    jm = JaxLAFCSingle(config=cfg)
    v = jax.jit(jm.init)(jax.random.PRNGKey(1),
                         jnp.asarray(b["flows"][:, 1]),
                         jnp.asarray(b["masks"][:, 1]))
    return (JaxLAFCTrainer._single_window(jm.apply), _np(v),
            weights.lafc_single_mapping(0, "gated"), cfg)


def _port_lafc(kind):
    _, v, mapping, cfg = _lafc_pair(kind)
    model = tlafc.Model(cfg) if kind == "lafc" else tls.Model(cfg)
    weights.load_state(model, weights.jax_to_torch_state(v, mapping))
    return model


@pytest.mark.parametrize("kind", ["lafc", "lafc_single"])
def test_gated_lafc_matches_jax(kind):
    """f32: flow to 1e-4 of its scale, edge to 1e-5 (the vanilla LAFC
    test's); the gate's convs are in the tables, the ignored norm adds
    none."""
    apply, v, mapping, _ = _lafc_pair(kind)
    assert any(p[-2] == "gating" for p in mapping)
    b = _lafc_batch(seed=3)
    want_f, want_e = jax.jit(apply)(v, jnp.asarray(b["diffused_flows"]),
                           jnp.asarray(b["masks"]))
    port = _port_lafc(kind)
    x = (_t(b["diffused_flows"]), _t(b["masks"]))
    if kind == "lafc_single":
        x = (x[0][:, 1], x[1][:, 1])
    with torch.no_grad():
        got_f, got_e = port(*x)
    scale = np.abs(np.asarray(want_f)).max()
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=1e-5)


@pytest.mark.parametrize("name", ["fgt_BN", "fgt_IN", "fgt_SN", "lafc"])
def test_gated_bf16_within_jax_spread(name):
    """bf16 as the pipelines run it (JAX casts every f32 leaf, BN's
    running statistics and SN's u, v included; the port moves its module
    to bf16): max |port_bf16 - jax_bf16| <= 2 max |jax_bf16 - jax_f32|,
    relative to the largest f32 output."""
    if name == "lafc":
        apply, v, _, _ = _lafc_pair("lafc")
        b = _lafc_batch(seed=3)
        args = (b["diffused_flows"], b["masks"])
        port = _port_lafc("lafc")
    else:
        norm = name.split("_")[1]
        v = _fgt_vars(norm)
        apply = JaxFGT(config=_fgt_cfg(norm)).apply
        frames, flows, masks = _fgt_inputs()
        args = (frames * (1 - masks), flows, masks)
        port = _port_fgt(norm)
    jit = jax.jit(apply)
    out32 = jit(v, *(jnp.asarray(a) for a in args))
    out16 = jit(bf16_tree(v), *(jnp.asarray(a, jnp.bfloat16) for a in args))
    port = port.to(torch.bfloat16)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a).to(torch.bfloat16) for a in args))
    if name == "lafc":           # the flow head
        got, out16, out32 = got[0], out16[0], out32[0]
    assert_within_jax_bf16_spread(got.float().numpy(),
                                  np.asarray(out16.astype(jnp.float32)),
                                  np.asarray(out32))


MSGPACK_CASES = [("lafc", None), ("lafc_single", None), ("fgt", "BN"),
                 ("fgt", "IN"), ("fgt", "SN")]


@pytest.mark.parametrize("kind,norm", MSGPACK_CASES)
def test_msgpack_loads_strictly(tmp_path, kind, norm):
    """A JAX-written ``.msgpack`` of a gated (and normed) model: every
    leaf loads through ``state_from_variables`` (strict), the port's
    ``state_dict`` comes back through ``torch_to_jax_leaves`` leaf for
    leaf (SN's v permuted both ways), and a tree missing a leaf, or
    holding one more, raises naming it."""
    if kind == "fgt":
        v, cfg, port = _fgt_vars(norm), _fgt_cfg(norm), tfgt.Model(
            _fgt_cfg(norm))
    else:
        _, v, _, cfg = _lafc_pair(kind)
        port = tlafc.Model(cfg) if kind == "lafc" else tls.Model(cfg)
    path = str(tmp_path / "model.msgpack")
    jckpt.save_pytree(v, path)
    tree = checkpoint.load_pytree(path)
    weights.load_state(port, weights.state_from_variables(kind, tree, cfg))
    mapping = weights.mapping_for(kind, cfg)
    back = weights.torch_to_jax_leaves(port.state_dict(), mapping)
    flat = {tuple(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(v)[0]}
    assert set(back) == set(flat)
    for p, leaf in flat.items():
        np.testing.assert_array_equal(back[p], leaf, err_msg="/".join(p))
    if norm in ("BN", "SN"):
        coll = "batch_stats" if norm == "BN" else "spectral"
        assert any(p[0] == coll for p in flat)
        short = checkpoint.load_pytree(path)
        node = short[coll]["net"]["decoder"]["final"]
        node.pop(next(iter(node)))
        with pytest.raises(ValueError, match="missing"):
            weights.state_from_variables(kind, short, cfg)
    extra = checkpoint.load_pytree(path)
    extra["params"]["net"]["stray"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="not in the model"):
        weights.state_from_variables(kind, extra, cfg)


# --------------------------------------------------------------- GAN step

@functools.lru_cache(maxsize=None)
def _gan_side_models():
    """The T-PatchGAN and the gated LAFC-single oracle's variables."""
    from fgt_tpu.models.discriminator import TemporalPatchGAN as JaxPatchGAN

    disc = JaxPatchGAN(in_channels=3, dist_cnum=DIST_CNUM)
    oracle = JaxLAFCSingle(config=GATED_SINGLE)
    d_vars = _np(jax.jit(disc.init)(jax.random.PRNGKey(1),
                                    jnp.zeros(SHAPE + (3,))))
    o_vars = _np(jax.jit(oracle.init)(jax.random.PRNGKey(2),
                                      jnp.zeros((1, 32, 32, 2)),
                                      jnp.zeros((1, 32, 32, 1))))
    return disc, oracle, d_vars, o_vars


def _jax_gan(norm, g_tx, d_tx, bi_mode=None):
    disc, oracle, d_vars, _ = _gan_side_models()
    gen = JaxFGT(config=_fgt_cfg(norm))

    def d_apply(variables, video, sn_update):
        if sn_update:
            out, mut = disc.apply(variables, video, sn_update=True,
                                  mutable=["spectral"])
            return out, mut["spectral"]
        return disc.apply(variables, video), variables["spectral"]

    step = jfs.make_fgt_train_step(
        lambda p, f, fl, m: gen.apply(p, f, fl, m), d_apply,
        lambda p, f, m: oracle.apply(p, f, m), g_tx, d_tx, bi_mode=bi_mode,
        donate=False)
    g_vars = _fgt_vars(norm)
    state = jfs.GANTrainState(
        g_params=g_vars, d_params=d_vars["params"],
        d_spectral=d_vars["spectral"], g_opt=g_tx.init(g_vars),
        d_opt=d_tx.init(d_vars["params"]), step=jnp.zeros((), jnp.int32))
    return step, state


def _port_gan(norm, make_opt, schedule=None, bi_mode=None):
    _, _, d_vars, o_vars = _gan_side_models()
    gen = _port_fgt(norm)
    disc = tdisc.TemporalPatchGAN(3, DIST_CNUM)
    weights.load_state(disc, weights.jax_to_torch_discriminator_state(d_vars))
    oracle = tls.Model(GATED_SINGLE).eval().requires_grad_(False)
    weights.load_state(oracle, weights.jax_to_torch_state(
        o_vars, weights.lafc_single_mapping(1, "gated")))
    return tfs.FGTTrainStep(gen, disc, oracle, make_opt(gen.parameters()),
                            make_opt(disc.parameters()), schedule,
                            bi_mode=bi_mode)


def _leaves(variables):
    return {tuple(p.key for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(variables)[0]}


def _assert_delta(got, want, w0, top, path):
    """An SGD delta within 1e-3 of its tensor's largest |delta|, floored
    at 1e-6 of the model's largest (the tp tests' bounds), plus two ulps
    of the weight: a delta is the difference of two rounded f32
    weights."""
    ulp = np.spacing(np.abs(w0).max().astype(np.float32))
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=max(1e-3 * np.abs(want).max(), 1e-6 * top) + 2 * ulp,
        err_msg="/".join(path))


@pytest.mark.parametrize("norm", ["BN", "SN"])
def test_gan_step_sgd_under_a_norm_matches_jax(norm):
    """One SGD step (lr 0.5, so a delta is -lr x its gradient), f32:
    metrics to 1e-4 relative; every generator leaf's delta, BN's running
    mean and var among them, to 1e-3 of its tensor's largest |delta|,
    floored at 1e-6 of the model's largest (the tp tests' bounds: the
    flow encoder's gradients are rounding noise, ~1e-8, in JAX as in the
    port), plus two ulps of the weight (a delta is the difference of two
    rounded f32 weights); the decoder's BN statistics moved, SN's u and v did not move
    on either side."""
    lr, batch = 0.5, _batch()
    step, state = _jax_gan(norm, optax.sgd(lr), optax.sgd(lr))
    state1, want = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        _gan_side_models()[3])
    port = _port_gan(norm, lambda ps: torch.optim.SGD(ps, lr=lr))
    before = {k: v.detach().clone() for k, v in
              port.gen.state_dict().items()}
    got = port({k: _t(v) for k, v in batch.items()})
    _assert_metrics(got, want, 1e-4)
    mapping = _fgt_map(norm)
    delta = weights.torch_to_jax_leaves(
        {k: v.detach() - before[k] if k.endswith(("weight_orig", "weight",
                                                  "bias", "running_mean",
                                                  "running_var"))
         else v for k, v in port.gen.state_dict().items()}, mapping)
    j0, j1 = _leaves(state.g_params), _leaves(state1.g_params)
    top = max(np.abs(j1[p] - j0[p]).max() for p in mapping)
    moved = 0
    for path in mapping:
        if path[0] == "spectral":
            continue
        jd = j1[path] - j0[path]
        _assert_delta(delta[path], jd, j0[path], top, path)
        moved += (path[0] == "batch_stats" and "decoder" in path
                  and np.abs(jd).max() > 1e-6 * top)
    after = weights.torch_to_jax_leaves(port.gen.state_dict(), mapping)
    if norm == "BN":
        assert moved == 8          # mean and var of the 4 decoder layers
    else:
        spec = [p for p in mapping if p[0] == "spectral"]
        assert len(spec) == 32     # u and v of 16 convs
        for path in spec:
            np.testing.assert_array_equal(j1[path], j0[path])
            np.testing.assert_allclose(after[path], j0[path], atol=1e-7)


@pytest.mark.parametrize("norm", ["BN", "SN"])
def test_gan_step_adam_under_a_norm_matches_jax(norm):
    """Three steps of the trainer's Adam on a warmup schedule,
    alternating flow directions: every metric of every step to 1e-3
    relative (the vanilla Adam test's bound); then BN's running
    statistics against JAX's: Adam moves each entry by about lr per
    step whatever its gradient's size, so each must agree to 1e-3 of the
    largest move."""
    sched = jsched.warmup_step_decay(2e-3, 2, 0.5, warmup=2)
    step, state = _jax_gan(norm, jsched.make_adam(sched),
                           jsched.make_adam(sched), "alternate")
    port = _port_gan(norm, tsched.make_adam,
                     tsched.warmup_step_decay(2e-3, 2, 0.5, warmup=2),
                     "alternate")
    batch = _batch(seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    j0 = _leaves(state.g_params)
    for _ in range(3):
        state, want = step(state, jb, _gan_side_models()[3])
        got = port(tb)
        _assert_metrics(got, want, 1e-3)
    j1 = _leaves(state.g_params)
    after = weights.torch_to_jax_leaves(port.gen.state_dict(),
                                        _fgt_map(norm))
    for path in _fgt_map(norm):
        if path[0] == "params":
            continue
        jd = j1[path] - j0[path]
        if norm == "SN":
            np.testing.assert_array_equal(jd, 0)
        else:
            assert np.abs(jd).max() > 0
        np.testing.assert_allclose(after[path] - j0[path], jd, rtol=0,
                                   atol=1e-3 * np.abs(jd).max() + 1e-7,
                                   err_msg="/".join(path))


# ---------------------------------------------------------------- stage 1

@pytest.mark.parametrize("kind", ["lafc", "lafc_single"])
def test_gated_lafc_step_matches_jax(kind):
    """One SGD step (lr 0.5) with a global-norm clip at 0.1, f32: the
    gated models' gradient norm over the gate's doubled parameter set is
    about 0.25 on this batch (flows scaled by 5; the gates damp it far
    below the vanilla models' > 10, so the trainer's clip at 10 would not
    act), so the clip scales every delta; metrics to 1e-5 relative (the
    vanilla stage-1 test's bound), deltas as in the GAN test above."""
    lr, clip = 0.5, 0.1
    apply, v, mapping, _ = _lafc_pair(kind)
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.sgd(lr))
    step = jls.make_lafc_train_step(apply, tx, donate=False)
    batch = _lafc_batch(seed=0)
    for k in ("flows", "diffused_flows"):
        batch[k] = batch[k] * np.float32(5.0)
    v1, _, want = step(v, tx.init(v),
                       {k: jnp.asarray(a) for k, a in batch.items()})
    port = _port_lafc(kind)
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    got = LAFCTrainStep(port, torch.optim.SGD(port.parameters(), lr=lr),
                        grad_clip=clip, single=kind == "lafc_single")(
        {k: _t(a) for k, a in batch.items()})
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    delta = weights.torch_to_jax_leaves(
        {k: p.detach() - before[k] for k, p in port.named_parameters()},
        mapping)
    l0, l1 = _leaves(v), _leaves(v1)
    jd_all = {p: l1[p] - l0[p] for p in mapping}
    top = max(np.abs(jd).max() for jd in jd_all.values())
    for p, jd in jd_all.items():
        _assert_delta(delta[p], jd, l0[p], top, p)
    norm = np.sqrt(sum((jd.astype(np.float64) ** 2).sum()
                       for jd in jd_all.values())) / lr
    assert norm == pytest.approx(clip, rel=1e-4)        # the clip acted


def test_gated_bn_trainer_resumes_exactly_and_its_latest_loads(tmp_path):
    """``FGTTrainer`` with a gated BN generator and a gated LAFC-single
    oracle, mixed precision, on the CPU: 2 steps, save the trio, 2 more;
    a trainer resumed from the trio takes the same 2 steps with
    bit-equal losses, BN's running statistics (moved by Adam) and their
    Adam moments equal to the first run's; the run's ``latest``
    directory loads through the inference CLI's loader as a gated BN
    FGT holding those statistics."""
    from fgt_tpu_torch.train.trainer import FGTTrainer
    from test_torch_port_train import _gen_losses, _trainer_opt

    oracle = tls.init_lafc_single(tls.Model(GATED_SINGLE),
                                  torch.Generator().manual_seed(0))
    checkpoint.save(oracle.state_dict(), str(tmp_path / "oracle.pth"))
    full = _batch(seed=2)
    batch = {"frames": full["frames"], "masks": full["masks"],
             "forward_flo": full["flows"]}
    kw = dict(conv_type="gated", norm="BN", mixed_precision=1,
              flow_config=GATED_SINGLE)
    first = FGTTrainer(_trainer_opt(tmp_path, **kw), device="cpu")
    stats = [k for k in first.gen.state_dict() if "running_" in k]
    assert len(stats) == 16
    before = {k: first.gen.state_dict()[k].clone() for k in stats}
    first.train([batch])
    paths = first.save_checkpoint(0)
    first.total_iterations = 4
    first.train([batch, batch])
    second = FGTTrainer(_trainer_opt(tmp_path, path=paths, resume=True,
                                     **kw), device="cpu")
    start = len(_gen_losses(second))
    second.total_iterations = 4
    second.train([batch])
    assert _gen_losses(second)[start:] == _gen_losses(first)[2:4]
    a, b = first.gen.state_dict(), second.gen.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert sum(not torch.equal(a[k], before[k]) for k in stats) >= 8
    names = [n for n, _ in first.gen.named_parameters()]
    sa, sb = first.g_opt.state_dict(), second.g_opt.state_dict()
    for k in stats:
        i = names.index(k)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][key], sb["state"][i][key]), k
    cfg, state = tvi._load_ckpt_dir(os.path.join(first.run_dir, "latest"),
                                    tvi.DEFAULT_FGT_CONFIG)
    assert (cfg["conv_type"], cfg["norm"]) == ("gated", "BN")
    for k in stats:
        assert torch.equal(state[k], b[k]), k


# ------------------------------------------------------------ whole slice

SLICE_LAFC = dict(TINY_LAFC, conv_type="gated")
SLICE_FGT = dict(TINY_FGT, conv_type="gated", norm="BN",
                 input_resolution=[64, 64], kernel_size=[7, 7])
SLICE_FLAGS = ["--imgH", "64", "--imgW", "64", "--raft_iters", "2",
               "--flow_mask_dilates", "2", "--neighbor_stride", "3",
               "--step", "4", "--f32"]


def test_object_removal_gated_bn_matches_jax_cli(tmp_path):
    """Gated LAFC + gated BN FGT checkpoint directories as the JAX
    package writes them (``.msgpack`` + ``config.yaml``; BN's running
    statistics random), read by both CLIs: equal to the input outside
    the hole; inside, mean |diff| <= 0.25 and at most 1% of the pixels
    off by more than one level (the vanilla slice test's bound)."""
    import imageio.v2 as imageio

    rng = np.random.RandomState(6)
    f, m = jnp.zeros((1, 3, 64, 64, 2)), jnp.zeros((1, 3, 64, 64, 1))
    lafc_v = _np(jax.jit(JaxLAFC(config=SLICE_LAFC).init)(
        jax.random.PRNGKey(0), f, m))
    fgt_v = _randomize_norms(jax.jit(JaxFGT(config=SLICE_FGT).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 2, 64, 64, 3)), f[:, :2],
        m[:, :2]), rng)
    jckpt.save_model_dir(lafc_v, SLICE_LAFC, str(tmp_path / "lafc"),
                         name="lafc")
    jckpt.save_model_dir(fgt_v, SLICE_FGT, str(tmp_path / "fgt"),
                         name="fgt")
    jckpt.save_pytree(_jax_variables("raft"), str(tmp_path / "raft.msgpack"))
    frames, masks = _video(6, 64, 64, seed=3)
    np.save(tmp_path / "frames.npy", frames)
    np.save(tmp_path / "masks.npy", masks)
    ckpts = ["--lafc_ckpts", str(tmp_path / "lafc"), "--fgt_ckpts",
             str(tmp_path / "fgt"), "--raft_model",
             str(tmp_path / "raft.msgpack")]
    got = np.load(tvi.main([
        "--path", str(tmp_path / "frames.npy"), "--path_mask",
        str(tmp_path / "masks.npy"), "--outroot", str(tmp_path / "port"),
        "--device", "cpu", *ckpts, *SLICE_FLAGS]))
    for sub, stack in (("frames", frames), ("masks", masks * 255)):
        (tmp_path / sub).mkdir()
        for i, img in enumerate(stack):
            imageio.imwrite(tmp_path / sub / f"{i:05d}.png", img)
    args = jvi.build_parser().parse_args([
        "--path", str(tmp_path / "frames"), "--path_mask",
        str(tmp_path / "masks"), "--outroot", str(tmp_path / "jax"),
        "--vis_frame", *ckpts, *SLICE_FLAGS])
    jvi.video_inpainting(args, models=jvi.Models(args))
    want = np.stack([imageio.imread(tmp_path / "jax" / "frames" /
                                    f"{i:05d}.png") for i in range(6)])
    hole = masks > 0
    np.testing.assert_array_equal(got[~hole], frames[~hole])
    np.testing.assert_array_equal(want[~hole], frames[~hole])
    d = np.abs(got.astype(int) - want.astype(int))[hole]
    assert d.mean() <= 0.25 and (d > 1).mean() <= 0.01, (d.mean(), d.max())


# ---------------------------------------------------------------- --tp 2

def test_tp2_gated_bn_generator_matches_jax_and_one_process(tmp_path):
    """Two gloo ranks under tp 2 (the gate's convs, the BN layers and
    their running statistics replicated by the rules): the forward
    against JAX (f32, 2e-5 absolute and 1e-5 relative, the tp tests'
    bound), also under sp 2 (BN on running statistics is per frame, so
    splitting the frames changes nothing), and one SGD GAN step against one process: metrics to 1e-4
    relative, each gathered generator leaf's delta, BN's running
    statistics among them, within 1e-3 of its tensor's largest delta,
    floored at 1e-6 of the model's largest (the tp tests' bounds); the
    ranks' replicated leaves bit-equal. The same step on two
    data-parallel ranks, each on half the batch (BN's statistics
    averaged with the other gradients), meets the same bounds, its
    metrics as means over the ranks."""
    from fgt_tpu_torch.parallel import partition
    from test_torch_port_parallel import (FWD_ATOL, FWD_RTOL, _inputs,
                                          _ranks, _spec, _start, _wait)

    norm, root = "BN", str(tmp_path)
    cfg = dict(_fgt_cfg(norm), numBlocks=4, mlp_ratio=4)   # tp's widths
    jm = JaxFGT(config=cfg)
    g_vars = _warm_spectral(_randomize_norms(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros(SHAPE + (3,)),
        jnp.zeros(SHAPE + (2,)), jnp.zeros(SHAPE + (1,))),
        np.random.RandomState(7)))
    mapping = weights.fgt_mapping(4, "gated", norm)
    gen_state = weights.jax_to_torch_state(g_vars, mapping)
    specs = partition.partition_specs(gen_state, 2)
    for name, d in specs.items():     # the conv blocks stay whole
        if "flow_encoder" in name or "decoder" in name:
            assert d is None, name
    assert any(d is not None for d in specs.values())
    _, _, d_vars, o_vars = _gan_side_models()
    paths = {}
    for k, v in (("gen", gen_state),
                 ("disc", weights.jax_to_torch_discriminator_state(d_vars)),
                 ("oracle", weights.jax_to_torch_state(
                     o_vars, weights.lafc_single_mapping(1, "gated")))):
        paths[k] = os.path.join(root, f"{k}.pth")
        checkpoint.save(v, paths[k])
    inputs = _inputs(2, 2, 0)
    np.savez(os.path.join(root, "fwd.npz"), **inputs)
    batch = _batch(seed=3)
    np.savez(os.path.join(root, "gan.npz"),
             **{f"0/{k}": v for k, v in batch.items()})
    spec_files = [
        _spec(root, "fwd", 2, 2, 1, "forward", config=cfg,
              state=paths["gen"], inputs=os.path.join(root, "fwd.npz")),
        _spec(root, "fwd_sp", 2, 1, 2, "forward", config=cfg,
              state=paths["gen"], inputs=os.path.join(root, "fwd.npz")),
        _spec(root, "gan", 2, 2, 1, "gan_step", config=cfg, states=paths,
              oracle_config=GATED_SINGLE, dist_cnum=DIST_CNUM,
              batch=os.path.join(root, "gan.npz"), optimizer="sgd"),
        _spec(root, "gan_dp", 2, 1, 1, "gan_step", config=cfg,
              states=paths, oracle_config=GATED_SINGLE, dist_cnum=DIST_CNUM,
              batch=os.path.join(root, "gan.npz"), optimizer="sgd")]
    procs = _start(2, spec_files, root)
    try:
        want = np.asarray(jm.apply(g_vars, *(jnp.asarray(a) for a in (
            inputs["frames"] * (1 - inputs["masks"]), inputs["flows"],
            inputs["masks"]))))
        one = tfs.FGTTrainStep(*_one_process_gan(cfg, paths))
        ref = one({k: _t(v) for k, v in batch.items()})
    finally:
        _wait(procs)
    for r in _ranks(root, "fwd", 2) + _ranks(root, "fwd_sp", 2):
        np.testing.assert_allclose(r["out"].numpy(), want, atol=FWD_ATOL,
                                   rtol=FWD_RTOL)
    ref_gen = one.gen.state_dict()
    top = max(float((v - gen_state[k]).abs().max())
              for k, v in ref_gen.items())
    ranks, dp = _ranks(root, "gan", 2), _ranks(root, "gan_dp", 2)
    dp_mean = {k: np.mean([r["metrics"][0][k] for r in dp]) for k in ref}
    _assert_metrics(dp_mean, ref, 1e-4)
    for r in ranks:
        _assert_metrics(r["metrics"][0], ref, 1e-4)
    for r in ranks + dp:
        assert set(r["gen"]) == set(ref_gen)
        for k, v in ref_gen.items():
            d_want = (v - gen_state[k]).numpy()
            np.testing.assert_allclose(
                r["gen"][k].numpy() - gen_state[k].numpy(), d_want, rtol=0,
                atol=max(1e-3 * np.abs(d_want).max(), 1e-6 * top), err_msg=k)
        key = "net.decoder.final.norm_layer.running_var"
        assert not torch.equal(r["gen"][key], gen_state[key])
    own = [r["own"] for r in ranks]
    for k, spec in partition.partition_specs(gen_state, 2).items():
        if spec is None:
            assert torch.equal(own[0][k], own[1][k]), k


def _one_process_gan(cfg, paths):
    gen = tfgt.Model(cfg)
    weights.load_state(gen, checkpoint.load_state_dict(paths["gen"]))
    disc = tdisc.TemporalPatchGAN(3, DIST_CNUM)
    weights.load_state(disc, checkpoint.load_state_dict(paths["disc"]))
    oracle = tls.Model(GATED_SINGLE).eval().requires_grad_(False)
    weights.load_state(oracle, checkpoint.load_state_dict(paths["oracle"]))

    def sgd(ps):
        return torch.optim.SGD(ps, lr=0.5)
    return gen, disc, oracle, sgd(gen.parameters()), sgd(disc.parameters())
