"""Tensor, sequence and data parallelism of the PyTorch port on the CPU,
against one process and against the JAX package on its 8 virtual CPU
devices (``tests/torch_port_parallel_worker.py`` runs the ranks, gloo,
each spawned with a timeout; every group of ranks starts at once, and
the JAX references are computed while they run):

* rules: the port's ``FGT_TP_RULES`` shard exactly the leaves JAX's
  ``partition_specs`` shards at tp 2, 4 and 8 (names mapped through
  ``convert/weights.fgt_mapping``), with an equal ``tp_param_fraction``;
  an indivisible leaf is replicated; a split within a head is refused;
* forward: the tiny FGT of ``tests/test_tensor_parallel.py`` on 2 ranks
  at tp 2, at sp 2 (b·t = 5, which 2 does not divide) and on 4 ranks at
  tp 2 x sp 2, against JAX's ``put_partitioned`` forward on
  ``make_mesh(dp=4, tp=2)`` (its sequence-parallel forward for the odd
  b·t) and its unsharded one, at atol 2e-5 / rtol 1e-5 (the JAX test's
  bound); every rank's output is bit-equal;
* GAN step: one SGD step and three Adam steps at tp 2 and at sp 2
  against one process and against JAX's ``make_fgt_train_step`` on a
  dp 2 x tp 4 mesh, at ``tests/test_torch_port_train.py``'s bounds; the
  discriminator and the replicated generator leaves bit-equal across
  the ranks;
* the inference CLI under ``--dp``, ``--tp 2`` and ``--sp 2`` (two
  ``torchrun``-style processes) within 1 u8 level of one process, and
  only rank 0 writes;
* the sampler: the tp ranks of one dp group draw the same items and
  masks, through the spawned loader;
* checkpoints: a tp run's checkpoint loads in one process, and a tp run
  resumed from it takes the same steps bit for bit.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fgt_tpu.models.fgt import FGT as JaxFGTNet
from fgt_tpu.models.fgt import FGTConfig as JaxFGTConfig
from fgt_tpu.models.fgt import Model as JaxFGT
from fgt_tpu.parallel import mesh as jmesh
from fgt_tpu.parallel import partition as jpart
from fgt_tpu.train import schedules as jsched
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.parallel import partition
from fgt_tpu_torch.parallel.mesh import Mesh, axis_ranks
from fgt_tpu_torch.pipeline import image_io
from fgt_tpu_torch.utils import checkpoint
from test_torch_port_pipeline import TINY_FGT, TINY_LAFC, _video
from test_torch_port_train import (DIST_CNUM, FGT_SMALL, LAFC_SINGLE_SMALL,
                                   _batch, _jax_step, _port_step,
                                   gan_models)  # noqa: F401 (a fixture)
from test_torch_port_train_cli import _config, _write_tree

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_parallel_worker.py")
TIMEOUT = 240          # seconds, per spawned process
# the tiny FGT of tests/test_tensor_parallel.py (hidden 49 x 4 = 196)
TP_FGT = dict(FGT_SMALL, numBlocks=4, mlp_ratio=4)
FWD_ATOL, FWD_RTOL = 2e-5, 1e-5


def _free_address():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _inputs(b, t, seed):
    rng = np.random.RandomState(seed)
    return {"frames": (rng.rand(b, t, 32, 32, 3) * 2 - 1).astype(np.float32),
            "flows": rng.randn(b, t, 32, 32, 2).astype(np.float32),
            "masks": (rng.rand(b, t, 32, 32, 1) > 0.7).astype(np.float32)}


def _start(world, specs, root, env=None):
    """Start ``world`` ranks of the worker on the SPEC files ``specs``."""
    return [subprocess.Popen([sys.executable, WORKER, str(r), *specs],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, env=env, cwd=root)
            for r in range(world)]


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _spec(root, name, world, tp, sp, job, **kw):
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(dict(kw, job=job, name=name, world=world, tp=tp, sp=sp,
                       address=_free_address(), out=root), f)
    return path


def _ranks(root, name, world):
    return [torch.load(os.path.join(root, f"{name}_rank{r}.pt"),
                       weights_only=False)   # numpy items: our own files
            for r in range(world)]


def _cli_argv(root, outroot):
    return ["--path", os.path.join(root, "frames"), "--path_mask",
            os.path.join(root, "masks"), "--lafc_ckpts",
            os.path.join(root, "lafc"), "--fgt_ckpts",
            os.path.join(root, "fgt"), "--raft_model", "/nonexistent",
            "--imgH", "32", "--imgW", "32", "--raft_iters", "1",
            "--flow_mask_dilates", "1", "--neighbor_stride", "2", "--step",
            "2", "--f32", "--device", "cpu", "--outroot", outroot]


CLI_FLAGS = {"dp": ["--dp"], "tp": ["--tp", "2"], "sp": ["--sp", "2"]}


def _cli_inputs(root):
    frames, masks = _video(7, 32, 32, seed=4)
    for sub in ("frames", "masks", "lafc", "fgt"):
        os.makedirs(os.path.join(root, sub))
    for i, (fr, m) in enumerate(zip(frames, masks)):
        image_io.write_png(os.path.join(root, "frames", f"{i:05d}.png"), fr)
        image_io.write_png(os.path.join(root, "masks", f"{i:05d}.png"),
                           m * 255)
    for sub, cfg in (("lafc", TINY_LAFC), ("fgt", TINY_FGT)):
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg, f)


def _start_cli(root, name, flags):
    """Two ranks of the inference CLI from ``torchrun``'s environment,
    each in a working directory of its own (``outroot`` relative)."""
    address, port = _free_address().split(":")
    procs = []
    for r in range(2):
        cwd = os.path.join(root, f"{name}_cwd{r}")
        os.makedirs(cwd)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE),
                   OMP_NUM_THREADS="1", RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR=address, MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fgt_tpu_torch.pipeline.video_inpainting",
             *_cli_argv(root, "out"), *flags], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=cwd))
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory, gan_models):
    """Every multi-rank run, started at once; the one-process and JAX
    references are computed while they run."""
    root = str(tmp_path_factory.mktemp("parallel"))
    fwd_vars = jax.tree_util.tree_map(np.asarray, jax.jit(
        JaxFGT(config=TP_FGT).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)),
            jnp.zeros((1, 2, 32, 32, 2)), jnp.zeros((1, 2, 32, 32, 1))))
    states = {"fwd": weights.jax_to_torch_state(
        fwd_vars, weights.fgt_mapping(TP_FGT["numBlocks"]))}
    _, _, _, g_vars, d_vars, o_vars = gan_models
    states.update(
        gen=weights.jax_to_torch_state(
            g_vars, weights.fgt_mapping(FGT_SMALL["numBlocks"])),
        disc=weights.jax_to_torch_discriminator_state(d_vars),
        oracle=weights.jax_to_torch_state(o_vars,
                                          weights.lafc_single_mapping(1)))
    paths = {}
    for k, v in states.items():
        paths[k] = os.path.join(root, f"{k}.pth")
        checkpoint.save(v, paths[k])
    inputs = {"even": _inputs(4, 2, 0), "odd": _inputs(1, 5, 1)}
    for k, v in inputs.items():
        np.savez(os.path.join(root, f"{k}.npz"), **v)
    gan_batch = _batch(seed=3)
    np.savez(os.path.join(root, "gan.npz"),
             **{f"0/{k}": v for k, v in gan_batch.items()})

    # a tp run of FGTTrainer (3 steps, a checkpoint at step 2), then one
    # resumed from that checkpoint
    oracle_path = paths["oracle"]
    train_batches = [_batch(seed=10 + s) for s in range(3)]
    np.savez(os.path.join(root, "train.npz"), **{
        f"{s}/{k}": v for s, b in enumerate(train_batches)
        for k, v in (("frames", b["frames"]), ("masks", b["masks"]),
                     ("forward_flo", b["flows"]))})
    np.savez(os.path.join(root, "train_tail.npz"), **{
        f"0/{k}": v for k, v in (("frames", train_batches[2]["frames"]),
                                 ("masks", train_batches[2]["masks"]),
                                 ("forward_flo", train_batches[2]["flows"]))})
    train_opt = dict(FGT_SMALL, name="tp_run", outputdir=os.path.join(
        root, "train_out"), seed=3, dist_cnum=DIST_CNUM, mixed_precision=0,
        record_iter=1, flow_checkPoint=oracle_path,
        flow_config=LAFC_SINGLE_SMALL,
        train={"lr": 1e-3, "UPDATE_INTERVAL": 100, "MAX_ITERS": 3,
               "log_freq": 1, "save_checkpoint_freq": 2, "L1M": 1,
               "L1V": 1, "adv": 0.01})
    ckpt = {k: os.path.join(root, "train_out", "tp_run", "checkpoints",
                            f"{k.split('_')[0].replace('dis', 'dist')}_0_2"
                            ".pth")
            for k in ("gen_state", "dis_state", "opt_state")}
    resume_opt = dict(train_opt, name="tp_resume", path=ckpt, resume=True)

    # the sampler: LAFC-single from a disk tree, two loader workers
    sampler_opt = _sampler_opt(root)

    two = [
        _spec(root, "fwd_tp", 2, 2, 1, "forward", config=TP_FGT,
              state=paths["fwd"], inputs=os.path.join(root, "even.npz")),
        _spec(root, "fwd_sp", 2, 1, 2, "forward", config=TP_FGT,
              state=paths["fwd"], inputs=os.path.join(root, "odd.npz"))]
    for opt_kind in ("sgd", "adam"):
        for tp, sp in ((2, 1), (1, 2)):
            two.append(_spec(
                root, f"{opt_kind}_tp{tp}_sp{sp}", 2, tp, sp, "gan_step",
                config=FGT_SMALL, oracle_config=LAFC_SINGLE_SMALL,
                dist_cnum=DIST_CNUM, optimizer=opt_kind,
                batch=os.path.join(root, "gan.npz"),
                states={k: paths[k] for k in ("gen", "disc", "oracle")}))
    two += [_spec(root, "train_tp", 2, 2, 1, "train", opt=train_opt,
                  batches=os.path.join(root, "train.npz")),
            _spec(root, "resume_tp", 2, 2, 1, "train", opt=resume_opt,
                  batches=os.path.join(root, "train_tail.npz")),
            _spec(root, "sampler_tp", 2, 2, 1, "sampler", opt=sampler_opt)]
    four = [_spec(root, "fwd_tpsp", 4, 2, 2, "forward", config=TP_FGT,
                  state=paths["fwd"], inputs=os.path.join(root, "even.npz"))]
    _cli_inputs(root)
    groups = [_start(2, two, root), _start(4, four, root)]
    groups += [_start_cli(root, name, flags)
               for name, flags in CLI_FLAGS.items()]

    # references, while the ranks run
    from fgt_tpu_torch.pipeline import video_inpainting as tvi
    one_cli = tvi.main(_cli_argv(root, os.path.join(root, "one")) +
                       ["--host_diffusion"])
    ref = {"cli": np.load(one_cli)}
    port = tfgt.Model(TP_FGT)
    weights.load_state(port, states["fwd"])
    jmodel = JaxFGT(config=TP_FGT)
    with torch.no_grad():
        for k, v in inputs.items():
            x = {n: torch.from_numpy(a) for n, a in v.items()}
            ref[f"port_{k}"] = port(x["frames"] * (1 - x["masks"]),
                                    x["flows"], x["masks"]).numpy()
            masked = v["frames"] * (1 - v["masks"])
            ref[f"jax_{k}"] = np.asarray(jax.jit(jmodel.apply)(
                fwd_vars, masked, v["flows"], v["masks"]))
    mesh = jmesh.make_mesh(dp=4, tp=2)
    v = inputs["even"]
    ref["jax_tp"] = np.asarray(jax.jit(jmodel.apply)(
        jpart.put_partitioned(mesh, fwd_vars),
        *jmesh.put_batch(mesh, [v["frames"] * (1 - v["masks"]), v["flows"],
                                v["masks"]])))
    # JAX's Ulysses forward over sp 2 at the odd b·t, tp 2 beside it
    jcfg = JaxFGTConfig.from_dict(dict(TP_FGT, seq_axis="sp"))
    sp_mesh = jmesh.make_mesh(dp=2, tp=2, sp=2)
    v = inputs["odd"]
    with jax.sharding.set_mesh(sp_mesh):
        ref["jax_sp"] = np.asarray(jax.jit(JaxFGTNet(jcfg).apply)(
            {"params": fwd_vars["params"]["net"]},
            v["frames"] * (1 - v["masks"]), v["flows"], v["masks"]))
    ref.update(_gan_references(gan_models, gan_batch))

    for procs in groups:
        _wait(procs)
    out = {name: _ranks(root, name, 2) for name in (
        "fwd_tp", "fwd_sp", "train_tp", "resume_tp", "sampler_tp",
        *(f"{o}_tp{tp}_sp{sp}" for o in ("sgd", "adam")
          for tp, sp in ((2, 1), (1, 2))))}
    out["fwd_tpsp"] = _ranks(root, "fwd_tpsp", 4)
    return dict(root=root, ref=ref, out=out, states=states, ckpt=ckpt,
                train_opt=train_opt, train_batches=train_batches)


def _sampler_opt(root):
    """LAFC-single's committed config on an 8-video tree under ``root``,
    two loader workers."""
    from fgt_tpu_torch.utils.config import prefix_paths, read_yaml

    tree = pathlib.Path(root) / "tree"
    _write_tree(tree / "train", 8, 10)
    opt = read_yaml(_config(tree, "lafc_single", 2))
    opt["datasets"]["dataInfo"] = prefix_paths(opt["datasets"]["dataInfo"],
                                               str(tree))
    opt["datasets"]["train"]["n_workers"] = 2
    return opt


def _gan_references(gan_models, batch):
    """One process (port) and JAX on a dp 2 x tp 4 mesh: one SGD step at
    lr 0.5 and three Adam steps on the trainer's warmup schedule."""
    ref = {}
    mesh = jmesh.make_mesh(dp=2, tp=4)
    jb = jmesh.put_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    sched = jsched.warmup_step_decay(2e-3, 2, 0.5, warmup=2)
    from fgt_tpu_torch.train import schedules as tsched
    for kind, (g_tx, d_tx, bi, steps, make, tsch) in {
            "sgd": (optax.sgd(0.5), optax.sgd(0.5), None, 1,
                    lambda ps: torch.optim.SGD(ps, lr=0.5), None),
            "adam": (jsched.make_adam(sched), jsched.make_adam(sched),
                     "alternate", 3, tsched.make_adam,
                     tsched.warmup_step_decay(2e-3, 2, 0.5, warmup=2))
    }.items():
        step, state = _jax_step(gan_models, g_tx, d_tx, bi)
        state = state._replace(
            g_params=jpart.put_partitioned(mesh, state.g_params),
            g_opt=jpart.put_partitioned(mesh, state.g_opt),
            d_params=jmesh.put_replicated(mesh, state.d_params),
            d_spectral=jmesh.put_replicated(mesh, state.d_spectral),
            d_opt=jmesh.put_replicated(mesh, state.d_opt),
            step=jmesh.put_replicated(mesh, state.step))
        jax_metrics = []
        for _ in range(steps):
            state, m = step(state, jb, gan_models[5])
            jax_metrics.append({k: float(v) for k, v in m.items()})
        port = _port_step(gan_models, make, tsch, bi)
        one = [{k: float(v) for k, v in port(tb).items()}
               for _ in range(steps)]
        if kind == "sgd":
            flat_step, flat = _jax_step(gan_models, g_tx, d_tx, bi)
            flat, _ = flat_step(flat, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, gan_models[5])
            ref["sgd_jax_flat_gen"] = jax.tree_util.tree_map(
                np.asarray, flat.g_params)
        ref[f"{kind}_jax"] = jax_metrics
        ref[f"{kind}_one"] = one
        ref[f"{kind}_jax_gen"] = jax.tree_util.tree_map(np.asarray,
                                                        state.g_params)
        ref[f"{kind}_one_gen"] = {k: v.detach().clone()
                                  for k, v in port.gen.state_dict().items()}
        ref[f"{kind}_one_disc"] = {k: v.detach().clone() for k, v in
                                   port.disc.state_dict().items()}
    return ref


# ------------------------------------------------------------- rules

def _jax_sharded_names(tree, tp):
    """Port names of the leaves JAX's ``partition_specs`` shards on a tp
    mesh, and its ``tp_param_fraction``."""
    mesh = jmesh.make_mesh(tp=tp)
    specs = jpart.partition_specs(tree, mesh)
    flat = dict(jax.tree_util.tree_flatten_with_path(specs)[0])
    names = set()
    mapping = weights.fgt_mapping(TP_FGT["numBlocks"])
    for path, spec in flat.items():
        key = tuple(str(getattr(p, "key", p)) for p in path)
        if any(ax is not None for ax in spec):
            names.add(mapping[key][0])
    return names, jpart.tp_param_fraction(mesh, tree)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_rules_shard_the_leaves_jax_shards(tp):
    """The port's rules split exactly the leaves JAX's rules split, with
    the same fraction of the parameters; at tp 8 the FFN's hidden of 196
    does not divide and stays replicated in both."""
    model = JaxFGT(config=TP_FGT)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)),
        jnp.zeros((1, 2, 32, 32, 2)), jnp.zeros((1, 2, 32, 32, 1))))
    want, want_frac = _jax_sharded_names(tree, tp)
    state = weights.jax_to_torch_state(
        tree, weights.fgt_mapping(TP_FGT["numBlocks"]))
    specs = partition.partition_specs(state, tp)
    assert {k for k, d in specs.items() if d is not None} == want
    assert partition.tp_param_fraction(state, tp) == pytest.approx(
        want_frac, rel=1e-12)
    ffn = "net.first_t_transformer.ffn.conv1.weight"
    assert specs[ffn] == (None if tp == 8 else 0)
    assert specs["net.first_t_transformer.attention.output_linear.weight"] \
        == 1
    assert specs["net.first_t_transformer.attention.output_linear.bias"] \
        is None


def test_shard_module_refuses_a_split_within_a_head():
    """tp 8 over 4 heads would split a head (JAX shards the 32 features
    regardless); the port's split is over whole heads."""
    model = tfgt.Model(TP_FGT)
    mesh = Mesh({"dp": 1, "tp": 8, "sp": 1}, {"dp": 0, "tp": 0, "sp": 0},
                dict.fromkeys(("dp", "tp", "sp")))
    with pytest.raises(ValueError, match="whole heads"):
        partition.shard_module(model, mesh)


def test_mesh_groups_are_the_jax_mesh_rows():
    """Ranks laid out row-major over (dp, tp, sp), sp innermost, as
    ``make_mesh`` lays out its devices."""
    devices = np.arange(8)
    grid = devices.reshape(2, 2, 2)
    sizes = {"dp": 2, "tp": 2, "sp": 2}
    for axis, dim in (("dp", 0), ("tp", 1), ("sp", 2)):
        want = np.moveaxis(grid, dim, -1).reshape(-1, 2).tolist()
        assert sorted(axis_ranks(sizes, axis)) == sorted(want)


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("name,batch,sharded", [
    ("fwd_tp", "even", "jax_tp"), ("fwd_sp", "odd", "jax_sp"),
    ("fwd_tpsp", "even", "jax_tp")])
def test_forward_matches_jax(runs, name, batch, sharded):
    ref = runs["ref"]
    outs = [r["out"].numpy() for r in runs["out"][name]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    for want in (ref[sharded], ref[f"jax_{batch}"]):
        np.testing.assert_allclose(outs[0], want, atol=FWD_ATOL,
                                   rtol=FWD_RTOL)
    np.testing.assert_allclose(outs[0], ref[f"port_{batch}"], atol=FWD_ATOL,
                               rtol=FWD_RTOL)


# ------------------------------------------------------------- GAN step

GAN_RUNS = [(o, tp, sp) for o in ("sgd", "adam") for tp, sp in ((2, 1),
                                                                (1, 2))]


def _gan(runs, o, tp, sp):
    return runs["out"][f"{o}_tp{tp}_sp{sp}"]


@pytest.mark.parametrize("o,tp,sp", GAN_RUNS)
def test_gan_step_matches_one_process_and_jax_mesh(runs, o, tp, sp):
    """Metrics of every step against one process and JAX's step on a
    dp 2 x tp 4 mesh: 1e-4 relative after one SGD step, 1e-3 over three
    Adam steps (``tests/test_torch_port_train.py``'s bounds)."""
    rtol = 1e-4 if o == "sgd" else 1e-3
    got = _gan(runs, o, tp, sp)[0]["metrics"]
    for want in (runs["ref"][f"{o}_one"], runs["ref"][f"{o}_jax"]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-6,
                                           err_msg=k)


@pytest.mark.parametrize("o,tp,sp", GAN_RUNS)
def test_gan_step_updates_match_one_process(runs, o, tp, sp):
    """The gathered generator and the discriminator after the steps:
    each SGD delta within 1e-3 of its tensor's largest delta (as
    against JAX in ``tests/test_torch_port_train.py``), against one
    process and against the JAX mesh's generator, floored at 1e-6 of
    the model's largest delta and, against the mesh, at twice its own
    distance from the unsharded JAX step (an encoder layer's gradient is
    1e-6 of the largest: it moves by the f32 rounding of sums whose
    terms reach the largest gradients, in JAX as in the port); Adam
    weights within 1e-2 x lr of one process's
    (``tests/test_torch_port_dp.py``'s bound)."""
    init = runs["states"]
    got = _gan(runs, o, tp, sp)[0]
    one_gen, one_disc = (runs["ref"][f"{o}_one_gen"],
                         runs["ref"][f"{o}_one_disc"])
    g_map = weights.fgt_mapping(FGT_SMALL["numBlocks"])
    jax_gen = weights.jax_to_torch_state(runs["ref"][f"{o}_jax_gen"], g_map)
    jax_flat = (weights.jax_to_torch_state(runs["ref"]["sgd_jax_flat_gen"],
                                           g_map) if o == "sgd" else None)
    for name, one, start in (("gen", one_gen, init["gen"]),
                             ("disc", one_disc, init["disc"])):
        assert set(got[name]) == set(one)
        for k, want in one.items():
            g = got[name][k].numpy()
            if not want.is_floating_point() or k.endswith(("_u", "_v")):
                np.testing.assert_allclose(g, want.numpy(), atol=1e-5,
                                           err_msg=k)
                continue
            if o == "adam":
                np.testing.assert_allclose(g, want.numpy(), rtol=0,
                                           atol=1e-2 * 2e-3, err_msg=k)
                continue
            top = max(float((v - start[n]).abs().max())
                      for n, v in one.items() if v.is_floating_point())
            refs = [(want.numpy(), 1e-6 * top)]
            if name == "gen":
                refs.append((jax_gen[k].numpy(), max(1e-6 * top, 2 * float(
                    (jax_gen[k] - jax_flat[k]).abs().max()))))
            for r, floor in refs:
                d_want = r - start[k].numpy()
                np.testing.assert_allclose(
                    g - start[k].numpy(), d_want, rtol=0,
                    atol=max(1e-3 * np.abs(d_want).max(), floor), err_msg=k)


@pytest.mark.parametrize("o,tp,sp", GAN_RUNS)
def test_replicated_leaves_stay_bit_equal_across_ranks(runs, o, tp, sp):
    a, b = _gan(runs, o, tp, sp)
    for k in a["disc"]:
        assert torch.equal(a["disc"][k], b["disc"][k]), k
    specs = partition.partition_specs(runs["states"]["gen"], tp)
    split = 0
    for k in a["own"]:
        if specs[k] is None:
            assert torch.equal(a["own"][k], b["own"][k]), k
        else:
            split += 1
            assert a["own"][k].shape[specs[k]] * tp == \
                runs["states"]["gen"][k].shape[specs[k]], k
    assert split == (0 if tp == 1 else 2 * (7 + 3))   # 2 attentions, 2 FFNs


# ------------------------------------------------------------- inference CLI

@pytest.mark.parametrize("name", list(CLI_FLAGS))
def test_inference_cli_under_a_mesh(runs, name):
    """Two ranks of the CLI against one process with the host diffusion
    (the solve a mesh takes): within 1 u8 level; rank 0 alone wrote its
    (relative) ``outroot``."""
    root = runs["root"]
    out = np.load(os.path.join(root, f"{name}_cwd0", "out", "result.npy"))
    want = runs["ref"]["cli"]
    assert out.shape == want.shape and out.dtype == np.uint8
    assert np.abs(out.astype(np.int16) - want).max() <= 1
    assert os.path.isfile(os.path.join(root, f"{name}_cwd0", "out",
                                       "timings.json"))
    assert os.listdir(os.path.join(root, f"{name}_cwd1")) == []


@pytest.mark.parametrize("argv,want", [
    ([], (False, 1, 1)), (["--dp"], (True, 1, 1)),
    (["--tp", "2", "--sp", "4"], (False, 2, 4))])
def test_mesh_flags_parse_as_the_jax_cli(argv, want):
    from fgt_tpu.pipeline import video_inpainting as jvi
    from fgt_tpu_torch.pipeline import video_inpainting as tvi

    got = tvi.build_parser().parse_args(argv)
    ref = jvi.build_parser().parse_args(argv)
    assert (got.dp, got.tp, got.sp) == (ref.dp, ref.tp, ref.sp) == want


# ------------------------------------------------------------- data

def test_tp_ranks_of_one_dp_group_draw_the_same_items(runs):
    """Both tp ranks (one dp group) shard the sampler alike and load the
    same items and masks through two spawned workers each."""
    a, b = runs["out"]["sampler_tp"]
    assert a["indices"] == b["indices"] and len(a["indices"]) == 8
    assert sorted(a["batch"]) == sorted(b["batch"])
    for k in a["batch"]:
        np.testing.assert_array_equal(a["batch"][k], b["batch"][k],
                                      err_msg=k)


# ------------------------------------------------------------- checkpoints

def test_tp_checkpoint_loads_in_one_process(runs):
    """The tp run's checkpoint is the full state dict one process
    writes: it loads strictly into an unsharded generator, equals the
    ranks' gathered state, and its Adam moments have the full shapes."""
    a, b = runs["out"]["train_tp"]
    path = os.path.join(a["run_dir"], "latest", "model.pth")
    state = checkpoint.load_state_dict(path)
    model = tfgt.Model(FGT_SMALL)
    weights.load_state(model, state)
    for k, v in model.state_dict().items():
        assert torch.equal(v, a["gen"][k]) and torch.equal(v, b["gen"][k]), k
    opt = checkpoint.load(runs["ckpt"]["opt_state"])["g_opt"]
    names = [n for n, _ in model.named_parameters()]
    for i, st in opt["state"].items():
        assert st["exp_avg"].shape == model.state_dict()[names[i]].shape


def test_tp_resume_is_exact(runs):
    """A tp run resumed from the step-2 checkpoint takes step 3 as the
    uninterrupted run did: equal losses, equal weights."""
    full, resumed = runs["out"]["train_tp"], runs["out"]["resume_tp"]
    for k, v in full[0]["gen"].items():
        assert torch.equal(v, resumed[0]["gen"][k]), k
    for k, v in full[0]["own"]["disc"].items():
        assert torch.equal(v, resumed[0]["own"]["disc"][k]), k
    with open(os.path.join(full[0]["run_dir"], "tb", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(resumed[0]["run_dir"], "tb",
                           "metrics.jsonl")) as f:
        tail = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert [r["step"] for r in tail] == [3]
    assert tail[0]["gen_loss"] == rows[2]["gen_loss"]
