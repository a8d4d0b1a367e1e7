"""FGT stage-2 GAN training in the PyTorch port vs the JAX package, on
the CPU, in f32, at a small size (as ``tests/test_train_steps.py``'s
FGT_CFG_SMALL):

* the plain versions of kernels K4/K5 against ``jax.grad`` of the flash
  Pallas kernel in interpret mode, at ragged L;
* the ``FlashAttention`` autograd Function and TMHSA gradients;
* the spectral-norm conv / T-PatchGAN (logits and u, v after an update),
  LAFC-single, the losses, the flow normalization and the schedule;
* one GAN step driven by SGD (so parameter deltas compare gradients),
  three Adam steps, and an exact resume trajectory of the trainer.

Weights move through ``convert.weights``; inputs are made with numpy.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fgt_tpu.models.discriminator import TemporalPatchGAN as JaxPatchGAN
from fgt_tpu.models.fgt import Model as JaxFGT
from fgt_tpu.models.lafc_single import Model as JaxLAFCSingle
from fgt_tpu.ops.attention import TMHSA as JaxTMHSA
from fgt_tpu.ops.flash_attention import flash_mhsa as jax_flash_mhsa
from fgt_tpu.train import fgt_step as jfs
from fgt_tpu.train import losses as jlosses
from fgt_tpu.train import schedules as jsched
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import discriminator as tdisc
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.models import lafc_single as tls
from fgt_tpu_torch.ops import attention as tatt
from fgt_tpu_torch.ops import flash_attention as tflash
from fgt_tpu_torch.train import fgt_step as tfs
from fgt_tpu_torch.train import losses as tlosses
from fgt_tpu_torch.train import schedules as tsched
from fgt_tpu_torch.train.trainer import FGTTrainer
from fgt_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

FGT_SMALL = {
    "model": "model", "in_channel": 4, "cnum": 8, "flow_inChannel": 2,
    "flow_cnum": 8, "frame_hidden": 32, "flow_hidden": 16, "PASSMASK": 1,
    "numBlocks": 2, "num_head": 4, "conv_type": "vanilla", "norm": None,
    "use_bias": 1, "ape": 1, "mlp_ratio": 2, "drop": 0, "tw": 2, "sw": 4,
    "gd": 2, "kernel_size_w": 7, "kernel_size_h": 7, "stride_h": 3,
    "stride_w": 3, "pad_h": 3, "pad_w": 3, "res_h": 32, "res_w": 32,
    "use_flash": 0,
}
LAFC_SINGLE_SMALL = {"cnum": 8, "in_channel": 3, "PASSMASK": 1,
                     "use_residual": 1, "resBlocks": 1, "use_bias": 1,
                     "conv_type": "vanilla"}
DIST_CNUM = 8


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- K4 / K5

@pytest.mark.parametrize("n,l", [(2, 10), (2, 300)])
def test_k45_plain_matches_jax_flash_grad(n, l):
    """dq, dk, dv from the plain versions of K4/K5 (fed K2's lse and
    dsum = rowsum(dO∘O)) against jax.grad through the Pallas flash kernel
    in interpret mode, ragged L (padded to 128/384 blocks in JAX).
    f32; tolerance 2e-5 absolute (reassociated sums of ~L terms)."""
    rng = np.random.RandomState(l)
    q, k, v, do = (rng.randn(n, l, 128).astype(np.float32) for _ in range(4))
    scale = 128 ** -0.5

    def f(q_, k_, v_):
        out = jax_flash_mhsa(q_, k_, v_, scale=scale, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    out, lse = tflash.flash_mhsa(_t(q), _t(k), _t(v), scale)
    dsum = (_t(do) * out).sum(-1)
    dq = tflash.flash_attention_dq(_t(q), _t(k), _t(v), _t(do), lse, dsum,
                                   scale)
    dk, dv = tflash.flash_attention_dkv(_t(q), _t(k), _t(v), _t(do), lse,
                                        dsum, scale)
    for got, exp in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-5,
                                   rtol=0)


def test_flash_attention_function_matches_autograd_of_plain():
    """FlashAttention (K2 forward, K4/K5 backward: plain versions here)
    against autograd through the plain forward; [2, 3, L, 128] operands
    through flash_attend. f32; tolerance 1e-5."""
    rng = np.random.RandomState(7)
    q, k, v, do = (rng.randn(2, 3, 77, 128).astype(np.float32)
                   for _ in range(4))
    ours = [_t(a).requires_grad_() for a in (q, k, v)]
    ref = [_t(a).requires_grad_() for a in (q, k, v)]
    out = tflash.flash_attend(*ours, 0.1)
    assert out.grad_fn is not None
    want = tflash.flash_attention_plain(
        *(r.reshape(6, 77, 128) for r in ref), 0.1)[0].reshape(out.shape)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=1e-6)
    (out * _t(do)).sum().backward()
    (want * _t(do)).sum().backward()
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)


def test_tmhsa_grads_match_jax_flash():
    """TMHSA (through FlashAttention) against the JAX module with its
    flash kernel and custom VJP (interpret mode): input and parameter
    gradients, ragged cells (h, w not multiples of the group), head dim
    128. f32; tolerance 1e-4 relative to the largest input gradient for
    the input, to the largest parameter gradient for the parameters (the
    key bias gradient is zero in exact arithmetic: softmax ignores a
    shift shared by all keys, so only rounding noise is left there)."""
    rng = np.random.RandomState(2)
    t, h, w, c = 3, 5, 7, 256
    x = rng.randn(2 * t, h * w, c).astype(np.float32)
    g = rng.randn(2 * t, h * w, c).astype(np.float32)
    jm = JaxTMHSA(d_model=c, group_size=2, num_heads=2, use_flash=True)
    variables = jax.jit(lambda r, a: jm.init(r, a, t, h, w))(
        jax.random.PRNGKey(0), jnp.asarray(x))

    def f(params, xx):
        return jnp.sum(jm.apply({"params": params}, xx, t, h, w) * g)

    gp, gx = jax.grad(f, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    mapping = {}
    for ours, theirs in (("query", "query_embedding"),
                         ("key", "key_embedding"),
                         ("value", "value_embedding"),
                         ("out", "output_linear")):
        mapping.update(weights._linear(("params", ours), theirs))
    port = tatt.TMHSA(c, 2, 2)
    weights.load_state(port, weights.jax_to_torch_state(
        _np_tree(variables), mapping))
    xt = _t(x).requires_grad_()
    (port(xt, t, h, w) * _t(g)).sum().backward()
    grads = weights.torch_to_jax_leaves(
        {k: p.grad for k, p in port.named_parameters()}, mapping)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=1e-4 * np.abs(np.asarray(gx)).max())
    want = {path: np.asarray(gp[path[1]][path[2]]) for path in mapping}
    top = max(np.abs(a).max() for a in want.values())
    for path in mapping:
        np.testing.assert_allclose(grads[path], want[path], atol=1e-4 * top,
                                   rtol=0, err_msg="/".join(path))


# ------------------------------------------------- discriminator / oracle

@pytest.fixture(scope="module")
def disc_pair():
    jm = JaxPatchGAN(in_channels=3, dist_cnum=DIST_CNUM)
    variables = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                          jnp.zeros((1, 3, 32, 32, 3))))
    port = tdisc.TemporalPatchGAN(3, DIST_CNUM)
    weights.load_state(port,
                       weights.jax_to_torch_discriminator_state(variables))
    return jm, variables, port


@pytest.mark.parametrize("sn_update", [False, True])
def test_discriminator_and_sn_state_match_jax(disc_pair, sn_update):
    """T-PatchGAN logits through five spectral-norm 3D convs; with
    ``sn_update`` one power iteration per conv, after which u and v must
    match (v compared in flax order through the permutation). f32;
    tolerance 1e-4 on logits, 1e-5 on u, v."""
    jm, variables, _ = disc_pair
    port = tdisc.TemporalPatchGAN(3, DIST_CNUM)
    weights.load_state(port,
                       weights.jax_to_torch_discriminator_state(variables))
    rng = np.random.RandomState(3)
    video = rng.uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    if sn_update:
        want, mut = jm.apply(variables, jnp.asarray(video), sn_update=True,
                             mutable=["spectral"])
        spectral = _np_tree(mut["spectral"])
    else:
        want, spectral = jm.apply(variables, jnp.asarray(video)), \
            variables["spectral"]
    with torch.no_grad():
        got = port(_t(video), sn_update=sn_update)
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4 * scale)
    leaves = weights.torch_to_jax_discriminator_leaves(port.state_dict())
    for i in range(5):
        for vec in ("u", "v"):
            np.testing.assert_allclose(
                leaves[("spectral", f"conv{i}", vec)],
                spectral[f"conv{i}"][vec], atol=1e-5)
    if sn_update:   # the update moved the state
        assert not np.allclose(spectral["conv0"]["v"],
                               variables["spectral"]["conv0"]["v"])


def test_lafc_single_matches_jax():
    """LAFC-single flow (with its activated head) and edge, f32;
    tolerance 1e-4 relative to the output scale."""
    jm = JaxLAFCSingle(config=LAFC_SINGLE_SMALL)
    variables = _np_tree(jax.jit(jm.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 48, 2)),
        jnp.zeros((1, 32, 48, 1))))
    port = tls.Model(LAFC_SINGLE_SMALL)
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.lafc_single_mapping(1)))
    rng = np.random.RandomState(4)
    flow = rng.randn(2, 32, 48, 2).astype(np.float32)
    mask = (rng.rand(2, 32, 48, 1) > 0.7).astype(np.float32)
    want_f, want_e = jm.apply(variables, jnp.asarray(flow), jnp.asarray(mask))
    with torch.no_grad():
        got_f, got_e = port(_t(flow), _t(mask))
    scale = np.abs(np.asarray(want_f)).max()
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=1e-5)


# ------------------------------------------- losses, flows, schedule

@pytest.mark.parametrize("kind", ["hinge", "nsgan", "lsgan"])
def test_losses_match_jax(kind):
    """Adversarial losses (each real/fake x disc/gen) and the normalized
    L1, f32; tolerance 1e-6 relative."""
    rng = np.random.RandomState(5)
    logits = rng.uniform(-2, 2, (2, 3, 4, 4, 8)).astype(np.float32)
    if kind == "nsgan":
        logits = 1 / (1 + np.exp(-logits))
    for is_real in (True, False):
        for is_disc in (True, False):
            want = jlosses.adversarial_loss(jnp.asarray(logits), is_real,
                                            is_disc, kind)
            got = tlosses.adversarial_loss(_t(logits), is_real, is_disc, kind)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    pred, target = (rng.randn(2, 3, 8, 8, 3).astype(np.float32)
                    for _ in range(2))
    mask = (rng.rand(2, 3, 8, 8, 1) > 0.6).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):
        want = jlosses.l1_normalized(jnp.asarray(pred), jnp.asarray(target),
                                     jnp.asarray(m))
        got = tlosses.l1_normalized(_t(pred), _t(target), _t(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_norm_flows_matches_jax():
    """Signed-max normalization, including a negative-max channel and an
    all-zero one (divisor 1). Exact in f32."""
    rng = np.random.RandomState(6)
    flows = rng.randn(2, 3, 5, 6, 2).astype(np.float32)
    flows[0, 1, ..., 0] = -np.abs(flows[0, 1, ..., 0])
    flows[1, 2, ..., 1] = 0.0
    want = np.asarray(jfs.norm_flows_nhwc(jnp.asarray(flows)))
    got = tfs.norm_flows_nhwc(_t(flows)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("warmup,world", [(None, 1), (10, 1), (10, 4)])
def test_schedule_matches_jax(warmup, world):
    """warmup_step_decay with the world-size slope quirk, steps 0..40;
    tolerance 1e-7 relative (f32 in JAX)."""
    want = jsched.warmup_step_decay(1e-3, 15, 0.5, warmup, world)
    got = tsched.warmup_step_decay(1e-3, 15, 0.5, warmup, world)
    for s in range(41):
        np.testing.assert_allclose(got(s), float(want(jnp.int32(s))),
                                   rtol=1e-6)


# ------------------------------------------------------------ GAN step

def _batch(b=2, t=3, h=32, w=32, seed=0):
    """bench_train.py's synth_fgt_batch recipe at a small size, plus
    forward and backward flows."""
    rng = np.random.RandomState(seed)
    base = rng.rand(1, 1, h, w, 3).astype(np.float32)
    frames = np.broadcast_to(base, (b, t, h, w, 3)).copy() * 2 - 1
    frames += rng.randn(b, t, h, w, 3).astype(np.float32) * 0.05
    masks = np.zeros((b, t, h, w, 1), np.float32)
    masks[:, :, h // 3: h // 3 + 12, w // 3: w // 3 + 14] = 1.0
    return {"frames": frames.astype(np.float32), "masks": masks,
            "flows": rng.randn(b, t, h, w, 2).astype(np.float32),
            "flows_fwd": rng.randn(b, t, h, w, 2).astype(np.float32),
            "flows_bwd": rng.randn(b, t, h, w, 2).astype(np.float32)}


@pytest.fixture(scope="module")
def gan_models():
    """JAX generator (use_flash 0), T-PatchGAN and LAFC-single oracle,
    initialized once; numpy variable trees."""
    gen = JaxFGT(config=FGT_SMALL)
    disc = JaxPatchGAN(in_channels=3, dist_cnum=DIST_CNUM)
    oracle = JaxLAFCSingle(config=LAFC_SINGLE_SMALL)
    shape = (1, 3, 32, 32)
    g_vars = _np_tree(jax.jit(gen.init)(
        jax.random.PRNGKey(0), jnp.zeros(shape + (3,)),
        jnp.zeros(shape + (2,)), jnp.zeros(shape + (1,))))
    d_vars = _np_tree(jax.jit(disc.init)(jax.random.PRNGKey(1),
                                         jnp.zeros(shape + (3,))))
    o_vars = _np_tree(jax.jit(oracle.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 2)),
        jnp.zeros((1, 32, 32, 1))))
    return gen, disc, oracle, g_vars, d_vars, o_vars


def _jax_step(gan_models, g_tx, d_tx, bi_mode=None):
    gen, disc, oracle, g_vars, d_vars, o_vars = gan_models

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
    state = jfs.GANTrainState(
        g_params=g_vars, d_params=d_vars["params"],
        d_spectral=d_vars["spectral"], g_opt=g_tx.init(g_vars),
        d_opt=d_tx.init(d_vars["params"]), step=jnp.zeros((), jnp.int32))
    return step, state


def _port_step(gan_models, make_opt, schedule=None, bi_mode=None):
    _, _, _, g_vars, d_vars, o_vars = gan_models
    gen = tfgt.Model(FGT_SMALL)
    weights.load_state(gen, weights.jax_to_torch_state(
        g_vars, weights.fgt_mapping(FGT_SMALL["numBlocks"])))
    disc = tdisc.TemporalPatchGAN(3, DIST_CNUM)
    weights.load_state(disc, weights.jax_to_torch_discriminator_state(d_vars))
    oracle = tls.Model(LAFC_SINGLE_SMALL).eval().requires_grad_(False)
    weights.load_state(oracle, weights.jax_to_torch_state(
        o_vars, weights.lafc_single_mapping(1)))
    return tfs.FGTTrainStep(gen, disc, oracle, make_opt(gen.parameters()),
                            make_opt(disc.parameters()), schedule,
                            bi_mode=bi_mode)


def _assert_metrics(got, want, rtol):
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("bi_mode", [None, "fuse"])
def test_gan_step_sgd_matches_jax(gan_models, bi_mode):
    """One GAN step (oracle, D update with two SN iterations, G against
    the updated D) with optax.sgd vs torch.optim.SGD, lr 0.5, so each
    parameter delta is -lr x its gradient. f32. Metrics to 1e-4
    relative; each delta to 1e-3 of its tensor's largest |delta|
    (gradients through ~30 layers, reassociated); spectral u, v after the
    step to 1e-5."""
    lr = 0.5
    step, state = _jax_step(gan_models, optax.sgd(lr), optax.sgd(lr),
                            bi_mode)
    batch = _batch()
    state1, want = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        gan_models[5])
    port = _port_step(gan_models,
                      lambda ps: torch.optim.SGD(ps, lr=lr), None, bi_mode)
    g0 = {k: p.detach().clone() for k, p in port.gen.named_parameters()}
    d0 = {k: p.detach().clone() for k, p in port.disc.named_parameters()}
    got = port({k: _t(v) for k, v in batch.items()})
    _assert_metrics(got, want, 1e-4)

    g_map = weights.fgt_mapping(FGT_SMALL["numBlocks"])
    g_delta = weights.torch_to_jax_leaves(
        {k: p.detach() - g0[k] for k, p in port.gen.named_parameters()},
        g_map)
    d_state = port.disc.state_dict()
    d_delta = dict(d_state)
    d_delta.update({k: p.detach() - d0[k]
                    for k, p in port.disc.named_parameters()})
    d_delta = weights.torch_to_jax_leaves(d_delta,
                                          weights.discriminator_mapping())
    jg = {"params": jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), state1.g_params["params"],
        gan_models[3]["params"])}
    jd = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                state1.d_params, gan_models[4]["params"])
    for path in g_map:
        _close_delta(g_delta[path], _get(jg, path), path)
    for path in weights.discriminator_mapping():
        if path[0] == "params":
            _close_delta(d_delta[path], _get({"params": jd}, path), path)
    leaves = weights.torch_to_jax_discriminator_leaves(d_state)
    spec = _np_tree(state1.d_spectral)
    for i in range(5):
        for vec in ("u", "v"):
            np.testing.assert_allclose(leaves[("spectral", f"conv{i}", vec)],
                                       spec[f"conv{i}"][vec], atol=1e-5)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _close_delta(got, want, path):
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-3 * top + 1e-9, rtol=0,
                               err_msg="/".join(path))


def test_gan_step_adam_three_steps_match_jax(gan_models):
    """Three steps with the trainer's Adam and a warmup schedule, on
    alternating flow directions: every metric of every step, to 1e-3
    relative (Adam's first steps move each weight by ~lr·sign(g), so
    small gradient differences shift later losses slightly)."""
    sched = jsched.warmup_step_decay(2e-3, 2, 0.5, warmup=2)
    step, state = _jax_step(gan_models, jsched.make_adam(sched),
                            jsched.make_adam(sched), "alternate")
    port = _port_step(gan_models, tsched.make_adam,
                      tsched.warmup_step_decay(2e-3, 2, 0.5, warmup=2),
                      "alternate")
    batch = _batch(seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    for _ in range(3):
        state, want = step(state, jb, gan_models[5])
        got = port(tb)
        _assert_metrics(got, want, 1e-3)


# ------------------------------------------------------------- trainer

def _trainer_opt(root, **kw):
    opt = dict(FGT_SMALL, name="fgt_small", outputdir=str(root), seed=3,
               dist_cnum=DIST_CNUM, mixed_precision=0, record_iter=1,
               flow_checkPoint=str(root / "oracle.pth"),
               flow_config=LAFC_SINGLE_SMALL,
               train={"lr": 1e-3, "UPDATE_INTERVAL": 100, "MAX_ITERS": 2,
                      "log_freq": 1, "save_checkpoint_freq": 1000,
                      "L1M": 1, "L1V": 1, "adv": 0.01})
    opt.update(kw)
    return opt


def _gen_losses(trainer):
    with open(trainer.metrics.path) as f:
        return [json.loads(line)["gen_loss"] for line in f]


def test_trainer_resume_trajectory_is_exact(tmp_path):
    """FGTTrainer on the CPU (oracle from a seeded checkpoint): 2 steps,
    save the gen/dist/opt trio, 3 more steps; a new trainer resumed from
    the trio takes the same 3 steps with bit-identical losses, and the
    same weights, SN state and Adam state after them."""
    oracle = tls.init_lafc_single(tls.Model(LAFC_SINGLE_SMALL),
                                  torch.Generator().manual_seed(0))
    checkpoint.save(oracle.state_dict(), str(tmp_path / "oracle.pth"))
    batch = {k: v for k, v in _batch(seed=2).items()
             if k in ("frames", "masks")}
    batch["forward_flo"] = _batch(seed=2)["flows"]

    first = FGTTrainer(_trainer_opt(tmp_path), device="cpu")
    first.train([batch])
    paths = first.save_checkpoint(0)
    first.total_iterations = 5
    first.train([batch, batch])
    assert first.current_step == 5

    second = FGTTrainer(_trainer_opt(tmp_path, path=paths, resume=True),
                        device="cpu")
    assert second.current_step == 2 and second.gan_step.step == 2
    start = len(_gen_losses(second))
    second.total_iterations = 5
    second.train([batch])
    assert _gen_losses(second)[start:] == _gen_losses(first)[2:5]
    for a, b in zip(first.gen.state_dict().values(),
                    second.gen.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(first.disc.state_dict().values(),
                    second.disc.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = first.g_opt.state_dict(), second.g_opt.state_dict()
    for i in sa["state"]:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][key], sb["state"][i][key])
    assert os.path.exists(os.path.join(first.run_dir, "latest", "model.pth"))
