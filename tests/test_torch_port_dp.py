"""Data-parallel training in the PyTorch port, on the CPU, against one
process on the global batch and against the JAX package's step on it:

* two gloo processes (``tests/torch_port_dp_worker.py``, spawned with a
  timeout) each train ``LAFCTrainer`` (LAFC, LAFC-single) or
  ``FGTTrainer`` on its half of three global batches of 4, whose halves'
  holes differ in area (about 0.45 of the frame against 0.05), so a
  per-shard mask normaliser would change every l1 and census term.
  Against one process on the whole batches: the logged metrics (means
  over the ranks) to 1e-5 relative (seen: 2.3e-7), every parameter and
  buffer to 1e-2 x lr (seen: 1.1e-3 x lr; the all-reduce of two half
  batch gradients reassociates the sums, and Adam moves a weight whose
  gradient is near its epsilon by up to lr whatever the gradient's
  size). The two replicas are bit-equal (each applies
  the same averaged gradient), the discriminator's spectral-norm u, v
  included. Against the JAX step on the global batch (Adam, the
  schedule, LAFC's clip): every metric of every step to 1e-3 relative
  (seen: 1.4e-5), as ``tests/test_torch_port_train.py`` bounds three
  Adam steps;
* only rank 0 writes the run directory (one log, one metrics stream,
  one checkpoint set, nothing archived);
* the training CLI's ``--coordinator --num_processes --process_id``
  parse as the JAX CLI's, and two CLI processes train LAFC-single from a
  disk tree on shards of its sampler.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.models.discriminator import TemporalPatchGAN as JaxPatchGAN
from fgt_tpu.models.fgt import Model as JaxFGT
from fgt_tpu.models.lafc import Model as JaxLAFC
from fgt_tpu.models.lafc_single import Model as JaxLAFCSingle
from fgt_tpu.train import fgt_step as jfs
from fgt_tpu.train import lafc_step as jls
from fgt_tpu.train import schedules as jsched
from fgt_tpu.train import train as jtrain
from fgt_tpu.train.trainer import LAFCTrainer as JaxLAFCTrainer
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.train import train as ttrain
from fgt_tpu_torch.train.trainer import FGTTrainer, LAFCTrainer
from fgt_tpu_torch.utils import checkpoint
from test_torch_port_train import DIST_CNUM, FGT_SMALL, LAFC_SINGLE_SMALL
from test_torch_port_train_cli import _config, _write_tree
from test_train_steps import LAFC_CFG

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_dp_worker.py")
TIMEOUT = 300          # seconds, per spawned process
STEPS, B, H, W, T = 3, 4, 32, 32, 3
LR, DECAY = 1e-3, 2


def _free_address():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _masks(rng, b, t):
    """[b, t, H, W, 1] holes: the first half of the batch large (rank 0's
    shard), the second half small (rank 1's)."""
    m = np.zeros((b, t, H, W, 1), np.float32)
    for i in range(b):
        side = 22 if i < b // 2 else 7
        y, x = rng.randint(0, H - side, 2)
        m[i, :, y:y + side, x:x + side] = 1
    return m


def _batches(kind):
    """Three global batches, in the trainer's keys."""
    out = []
    for s in range(STEPS):
        rng = np.random.RandomState(10 + s)
        if kind == "model":
            base = rng.rand(B, 1, H, W, 3).astype(np.float32) * 2 - 1
            frames = base + rng.randn(B, T, H, W, 3).astype(np.float32) * 0.05
            out.append({"frames": frames.astype(np.float32),
                        "masks": _masks(rng, B, T),
                        "forward_flo": rng.randn(B, T, H, W, 2).astype(
                            np.float32)})
        else:
            masks = _masks(rng, B, T)
            flows = rng.randn(B, T, H, W, 2).astype(np.float32)
            out.append({
                "flows": flows,
                "diffused_flows": (flows * (1 - masks)).astype(np.float32),
                "masks": masks,
                "edges": (rng.rand(B, H, W, 1) > 0.9).astype(np.float32),
                "current_frame": rng.rand(B, H, W, 3).astype(np.float32),
                "shift_frame": rng.rand(B, H, W, 3).astype(np.float32)})
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_init(kind):
    """(JAX step, its initial state / params, the port's initial state
    dicts by checkpoint key, the oracle's JAX params)."""
    sched = jsched.warmup_step_decay(LR, DECAY, 0.1)
    if kind == "model":
        gen = JaxFGT(config=FGT_SMALL)
        disc = JaxPatchGAN(in_channels=3, dist_cnum=DIST_CNUM)
        oracle = JaxLAFCSingle(config=LAFC_SINGLE_SMALL)
        shape = (1, T, H, W)
        g = _np_tree(jax.jit(gen.init)(
            jax.random.PRNGKey(0), jnp.zeros(shape + (3,)),
            jnp.zeros(shape + (2,)), jnp.zeros(shape + (1,))))
        d = _np_tree(jax.jit(disc.init)(jax.random.PRNGKey(1),
                                        jnp.zeros(shape + (3,))))
        o = _np_tree(jax.jit(oracle.init)(
            jax.random.PRNGKey(2), jnp.zeros((1, H, W, 2)),
            jnp.zeros((1, H, W, 1))))

        def d_apply(variables, video, sn_update):
            if sn_update:
                out, mut = disc.apply(variables, video, sn_update=True,
                                      mutable=["spectral"])
                return out, mut["spectral"]
            return disc.apply(variables, video), variables["spectral"]

        g_tx, d_tx = jsched.make_adam(sched), jsched.make_adam(sched)
        step = jfs.make_fgt_train_step(
            lambda p, f, fl, m: gen.apply(p, f, fl, m), d_apply,
            lambda p, f, m: oracle.apply(p, f, m), g_tx, d_tx, donate=False)
        state = jfs.GANTrainState(
            g_params=g, d_params=d["params"], d_spectral=d["spectral"],
            g_opt=g_tx.init(g), d_opt=d_tx.init(d["params"]),
            step=jnp.zeros((), jnp.int32))
        states = {
            "gen_state": weights.jax_to_torch_state(
                g, weights.fgt_mapping(FGT_SMALL["numBlocks"])),
            "dis_state": weights.jax_to_torch_discriminator_state(d),
            "oracle": weights.jax_to_torch_state(
                o, weights.lafc_single_mapping(1))}
        return step, state, states, o
    if kind == "lafc":
        jm = JaxLAFC(config=LAFC_CFG)
        apply = jm.apply
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, T, H, W, 2)),
                         jnp.zeros((1, T, H, W, 1)))
        mapping = weights.lafc_mapping(0)
    else:
        jm = JaxLAFCSingle(config=LAFC_CFG)
        apply = JaxLAFCTrainer._single_window(jm.apply)
        params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 2)),
                         jnp.zeros((1, H, W, 1)))
        mapping = weights.lafc_single_mapping(0)
    params = _np_tree(params)
    tx = jsched.make_adam(sched, grad_clip=10.0)
    step = jls.make_lafc_train_step(apply, tx, donate=False)
    return step, (params, tx.init(params)), \
        {"gen_state": weights.jax_to_torch_state(params, mapping)}, None


def _opt(kind, root, name, states):
    """The trainer's options: the tiny config, the JAX step's schedule
    (no warmup) and, for LAFC, the clip; weights from ``states`` through
    the trainer's finetune path (weights only, step 0)."""
    paths = {}
    for key, state in states.items():
        paths[key] = os.path.join(root, f"{key}.pth")
        checkpoint.save(state, paths[key])
    train = {"lr": LR, "UPDATE_INTERVAL": DECAY, "MAX_ITERS": STEPS,
             "log_freq": 1, "save_checkpoint_freq": 1000}
    common = dict(name=name, outputdir=os.path.join(root, "out"), seed=3,
                  mixed_precision=0, record_iter=1, finetune=1, resume=True)
    if kind == "model":
        return dict(FGT_SMALL, **common, dist_cnum=DIST_CNUM,
                    flow_checkPoint=paths.pop("oracle"),
                    flow_config=LAFC_SINGLE_SMALL, path=paths,
                    train=dict(train, L1M=1, L1V=1, adv=0.01))
    return dict(LAFC_CFG, **common, model=kind, gc=1, path=paths,
                train=dict(train, ternary=0.01, edge_loss=1.0))


def _spawn(args_list, timeout=TIMEOUT, env=None):
    procs = [subprocess.Popen(args, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for args in args_list]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _rows(run_dir):
    with open(os.path.join(run_dir, "tb", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _models(trainer):
    if isinstance(trainer, FGTTrainer):
        return {"gen": trainer.gen.state_dict(),
                "disc": trainer.disc.state_dict()}
    return {"model": trainer.model.state_dict()}


@pytest.fixture(scope="module", params=["lafc", "lafc_single", "model"])
def runs(request, tmp_path_factory):
    kind = request.param
    root = str(tmp_path_factory.mktemp(f"dp_{kind}"))
    step, state, states, oracle = _jax_init(kind)
    batches = _batches(kind)
    np.savez(os.path.join(root, "batches.npz"),
             **{f"{s}/{k}": v for s, b in enumerate(batches)
                for k, v in b.items()})
    spec = {"kind": kind, "world": 2, "address": _free_address(),
            "opt": _opt(kind, root, "dp", states),
            "batches": os.path.join(root, "batches.npz"), "out": root}
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    _spawn([[sys.executable, WORKER, str(r), os.path.join(root, "spec.json")]
            for r in range(2)])
    replicas = [torch.load(os.path.join(root, f"{kind}_rank{r}.pt"))
                ["models"] for r in range(2)]

    opt = _opt(kind, root, "single", states)
    single = (FGTTrainer(opt, device="cpu") if kind == "model"
              else LAFCTrainer(opt, device="cpu"))
    single.train(batches)

    want = []
    for b in batches:
        if kind == "model":
            jb = {"frames": jnp.asarray(b["frames"]),
                  "masks": jnp.asarray(b["masks"]),
                  "flows": jnp.asarray(b["forward_flo"])}
            state, m = step(state, jb, oracle)
        else:
            params, opt_state = state
            params, opt_state, m = step(
                params, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
            state = (params, opt_state)
        want.append({k: float(v) for k, v in m.items()})
    return dict(kind=kind, root=root, replicas=replicas,
                dp_rows=_rows(os.path.join(root, "out", "dp")),
                single_rows=_rows(single.run_dir),
                single=_models(single), jax=want)


def _metric_names(rows):
    return [k for k in rows[0] if k not in ("step", "time", "it_per_s",
                                            "lr")]


def test_two_ranks_equal_one_process_on_the_global_batch(runs):
    dp, one = runs["dp_rows"], runs["single_rows"]
    assert [r["step"] for r in dp] == [r["step"] for r in one] == [1, 2, 3]
    for a, b in zip(dp, one):
        for k in _metric_names(one):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    for name, want in runs["single"].items():
        got = runs["replicas"][0][name]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-2 * LR, err_msg=f"{name}.{k}")


def test_replicas_stay_bit_equal(runs):
    a, b = runs["replicas"]
    for name in a:
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), f"{name}.{k}"


def test_two_ranks_equal_the_jax_step_on_the_global_batch(runs):
    rows, want = runs["dp_rows"], runs["jax"]
    names = _metric_names(rows)
    assert set(names) == set(want[0])
    for got, ref in zip(rows, want):
        for k in names:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, atol=1e-6,
                                       err_msg=k)


def test_only_rank_zero_writes_the_run_directory(runs):
    out = os.path.join(runs["root"], "out")
    assert sorted(os.listdir(out)) == ["dp", "single"]
    run = os.path.join(out, "dp")
    assert len([f for f in os.listdir(run) if f.startswith("run_")]) == 1
    assert len(runs["dp_rows"]) == STEPS
    ckpts = os.listdir(os.path.join(run, "checkpoints"))
    assert len(ckpts) == (3 if runs["kind"] == "model" else 2)
    assert os.path.isfile(os.path.join(run, "latest", "model.pth"))


@pytest.mark.parametrize("argv", [
    [],
    ["--coordinator", "10.0.0.1:1234", "--num_processes", "4",
     "--process_id", "3"],
    ["--coordinator=localhost:99", "--num_processes=2", "--process_id=0"],
])
def test_dp_flags_parse_as_the_jax_cli(argv):
    got = ttrain.args_parser(["--model", "lafc"] + argv)
    want = jtrain.args_parser(["--model", "lafc"] + argv)
    for k in ("coordinator", "num_processes", "process_id"):
        assert getattr(got, k) == getattr(want, k), k


def test_two_cli_processes_train_from_disk(tmp_path):
    """``python -m fgt_tpu_torch.train.train --coordinator ...
    --num_processes 2 --process_id i --device cpu``: LAFC-single, 2
    steps from an 8-video tree (the committed config's batch of 4 per
    rank, each rank on its shard of 4 videos); rank 0's run directory
    holds the 2 logged steps, the other rank writes nothing."""
    _write_tree(tmp_path / "train", 8, 10)
    cfg = _config(tmp_path, "lafc_single", 2)
    address = _free_address()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    _spawn([[sys.executable, "-m", "fgt_tpu_torch.train.train", "--model",
             "lafc_single", "--opt", cfg, "--datadir", str(tmp_path),
             "--device", "cpu", "--coordinator", address,
             "--num_processes", "2", "--process_id", str(r)]
            for r in range(2)], env=env)
    out = tmp_path / "out"
    assert os.listdir(out) == ["LAFC_single_train"]
    rows = _rows(str(out / "LAFC_single_train"))
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)


def test_process_id_out_of_range_raises():
    """The rendezvous checks the flags before it waits on a peer."""
    from fgt_tpu_torch.utils import dist

    with pytest.raises(ValueError, match="--process_id 2"):
        dist.init_from_flags(_free_address(), 2, 2, "cpu")
    assert not dist.initialized()
