"""The JAX package's files read by the port, on the CPU, against the JAX
package and flax:

* YAML: every ``config.yaml`` the JAX package writes (``save_model_dir``
  through ``yaml.safe_dump``, block sequences for its lists) reads as
  ``yaml.safe_load`` reads it, by ``read_yaml`` and ``read_flat_yaml``;
* the codec: ``utils/checkpoint.load_pytree`` equals
  ``flax.serialization.msgpack_restore`` on the variables of every kind
  (RAFT, RAFT small, LAFC, LAFC-single, FGT at tiny widths, I3D), on
  bfloat16 leaves, numpy scalars and chunked leaves, and
  ``utils/msgpack.pack`` writes flax's bytes; complex numbers, unknown
  ext codes and broken data raise;
* ``convert/weights.state_from_variables`` picks the JAX converter's
  table and refuses any tree that does not match the model;
* JAX-written directories (``fgt_tpu.utils.checkpoint.save_model_dir``
  and ``save_pytree``) through the port's inference CLI (bit-equal to the
  same weights as ``.pth``, within the whole-slice tolerance of the JAX
  CLI on the same directories, ``result.mp4`` holding ``result.npy``'s
  planes), flow extraction, evaluation and the FGT trainer's oracle.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from fgt_tpu.core import vfid as jvfid
from fgt_tpu.models import raft as jraft
from fgt_tpu.models.registry import build_model
from fgt_tpu.pipeline import video_inpainting as jvi
from fgt_tpu.train import train as jtrain
from fgt_tpu.utils import checkpoint as jckpt
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.core import vfid as tvfid
from fgt_tpu_torch.core import video_io
from fgt_tpu_torch.pipeline import video_inpainting as tvi
from fgt_tpu_torch.utils import checkpoint, msgpack
from fgt_tpu_torch.utils.config import read_flat_yaml, read_yaml
from test_torch_port_pipeline import TINY_FGT, TINY_LAFC, _video

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = jax.random.PRNGKey(0)


# ------------------------------------------------------------------ YAML

def _trainer_config(name: str, model: str) -> dict:
    """The config the JAX trainers write beside ``latest/`` for the
    committed ``configs/<name>.yaml`` (``fgt_tpu/train/trainer.py``
    ``save_checkpoint``: the scalar and list keys of the CLI's opt)."""
    opt = jtrain.build_opt(jtrain.args_parser(
        ["--model", model, "--opt", os.path.join(ROOT, "configs",
                                                 f"{name}.yaml")]))
    cfg = {k: v for k, v in opt.items()
           if isinstance(v, (int, float, str, bool, list, tuple))}
    cfg["model"] = model
    return cfg


JAX_CONFIGS = {
    "default_lafc": lambda: dict(jvi.DEFAULT_LAFC_CONFIG),
    "default_fgt": lambda: dict(jvi.DEFAULT_FGT_CONFIG),
    "fgt_train": lambda: _trainer_config("fgt_train", "model"),
    "lafc_train": lambda: _trainer_config("lafc_train", "lafc"),
    "lafc_single_train": lambda: _trainer_config("lafc_single_train",
                                                 "lafc_single"),
}


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_configs_the_jax_package_writes_read_as_pyyaml(name, tmp_path):
    """``save_model_dir``'s ``config.yaml`` of the JAX CLI's default
    configs and of the JAX trainers' configs (lists such as
    ``input_resolution`` as block sequences): ``read_yaml`` equals
    ``yaml.safe_load``, ``read_flat_yaml`` its top-level non-mapping
    keys."""
    jckpt.save_model_dir({"params": {}}, JAX_CONFIGS[name](), str(tmp_path))
    path = str(tmp_path / "config.yaml")
    with open(path) as f:
        want = yaml.safe_load(f)
    if name.endswith("_train"):
        assert "\n- " in open(path).read()       # block sequences written
        assert isinstance(want["input_resolution"], list)
    assert read_yaml(path) == want
    assert read_flat_yaml(path) == {k: v for k, v in want.items()
                                    if not isinstance(v, dict)}


# ----------------------------------------------------------------- codec

LAFC_SINGLE = dict(TINY_LAFC, model="lafc_single")
CONFIGS = {"raft": {}, "raft_small": {}, "lafc": TINY_LAFC,
           "lafc_single": LAFC_SINGLE, "fgt": TINY_FGT, "i3d": {}}
TABLES = {"raft": weights.raft_mapping(),
          "raft_small": weights.raft_small_mapping(),
          "lafc": weights.lafc_mapping(1),
          "lafc_single": weights.lafc_single_mapping(1),
          "fgt": weights.fgt_mapping(2), "i3d": weights.i3d_mapping()}


def _i3d_variables():
    """The JAX I3D's variable tree (its shapes by ``jax.eval_shape``, no
    compile) with seeded values: fan-in scaled kernels, positive scales
    and variances."""
    shapes = jax.eval_shape(jvfid.I3D().init, RNG,
                            jnp.zeros((1, 9, 32, 32, 3)))
    rng = np.random.RandomState(0)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("var", "scale"):
            a = 0.5 + rng.rand(*s.shape)
        else:
            a = 0.1 * rng.randn(*s.shape)
        return a.astype(s.dtype)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_variables(kind: str):
    """The JAX package's variables of ``kind`` (jitted init; tiny LAFC /
    FGT widths), as numpy."""
    if kind.startswith("raft"):
        model = jraft.RAFT(jraft.RAFTConfig(small=kind == "raft_small"))
        d = jnp.zeros((1, 64, 64, 3))
        v = jax.jit(lambda: model.init(RNG, d, d, iters=1))()
    elif kind in ("lafc", "lafc_single"):
        model = build_model(kind, CONFIGS[kind])
        f, m = jnp.zeros((1, 3, 64, 64, 2)), jnp.zeros((1, 3, 64, 64, 1))
        if kind == "lafc_single":
            f, m = f[:, 0], m[:, 0]
        v = jax.jit(lambda: model.init(RNG, f, m))()
    elif kind == "fgt":
        model = build_model("model", TINY_FGT)
        v = jax.jit(lambda: model.init(
            RNG, jnp.zeros((1, 2, 64, 64, 3)), jnp.zeros((1, 2, 64, 64, 2)),
            jnp.zeros((1, 2, 64, 64, 1))))()
    else:
        v = _i3d_variables()
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.fixture(scope="module")
def jax_variables():
    return {kind: _jax_variables(kind) for kind in CONFIGS}


def _assert_same_tree(got, want, path=()):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], path + (k,))
    elif getattr(want, "dtype", None) is not None and \
            want.dtype.name == "bfloat16":        # arrays and scalars
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_load_pytree_equals_flax_and_feeds_the_port(kind, jax_variables,
                                                    tmp_path):
    """A file written by the JAX package's ``save_pytree``: the port's
    ``load_pytree`` equals ``msgpack_restore`` (keys, order, dtypes,
    values), ``pack`` gives the file's bytes back, and
    ``state_from_variables`` equals the weight table the JAX converter
    picks for the kind, loading strictly into the port's module."""
    variables = jax_variables[kind]
    path = str(tmp_path / f"{kind}.msgpack")
    jckpt.save_pytree(variables, path)
    with open(path, "rb") as f:
        data = f.read()
    got = checkpoint.load_pytree(path)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    assert msgpack.pack(got) == data
    state = weights.state_from_variables(kind, got, CONFIGS[kind])
    want = weights.jax_to_torch_state(variables, TABLES[kind])
    assert list(state) == list(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k
    if kind == "i3d":
        tvfid.load_i3d_state(tvfid.I3D(), state)
    else:
        module = weights._meta_module(kind, CONFIGS[kind]).to_empty(
            device="cpu")
        weights.load_state(module, state)
    # a bare params dict is wrapped (RAFT big and I3D carry batch stats)
    if set(variables) == {"params"}:
        bare = weights.state_from_variables(kind, got["params"],
                                            CONFIGS[kind])
        assert all(torch.equal(bare[k], state[k]) for k in state)


def test_bf16_npscalar_and_chunked_leaves(tmp_path, monkeypatch):
    """bfloat16 leaves (read as torch.bfloat16 through an int16 view),
    numpy scalars (ext 3), Python scalars, strings and bytes, and leaves
    over flax's ``MAX_CHUNK_SIZE`` (monkeypatched to 64 bytes: chunked
    f32 and bf16 leaves, one nested) through flax and the port: the same
    tree, the same bytes."""
    rng = np.random.RandomState(0)
    bf16 = np.asarray(jnp.asarray(rng.randn(6, 8), jnp.bfloat16))
    tree = {"params": {"w_bf16": bf16, "small_bf16": bf16[:2, :3],
                       "big": rng.randn(7, 9).astype(np.float32),
                       "deep": {"k": rng.randn(3, 11).astype(np.float32)},
                       "ints": np.arange(5, dtype=np.int64)},
            "step": np.int32(7), "lr": np.float32(1e-4), "s_bf16": bf16[0, 0],
            "name": "x" * 40, "flag": True, "n": -300, "x": 0.5,
            "none": None, "raw": b"\x00\x01"}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize(tree)
    assert data.count(msgpack.CHUNKED.encode()) == 3
    got = msgpack.unpack(data)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    assert got["s_bf16"].dtype == torch.bfloat16 and got["s_bf16"].dim() == 0
    # torch has no bfloat16 scalar type: that one leaf packs back as a 0-d
    # array (ext 1), as a JAX tree's bfloat16 jax.Array of shape () does
    del got["s_bf16"], tree["s_bf16"]
    assert msgpack.pack(got, max_chunk=64) == \
        serialization.msgpack_serialize(tree)
    jckpt.save_pytree(tree, str(tmp_path / "t.msgpack"))
    _assert_same_tree(checkpoint.load_pytree(str(tmp_path / "t.msgpack")),
                      serialization.msgpack_restore(
                          (tmp_path / "t.msgpack").read_bytes()))


def test_save_pytree_writes_what_the_jax_package_reads(jax_variables,
                                                       tmp_path):
    """The port's ``save_pytree`` of the FGT variables restores through
    the JAX package's ``load_pytree`` with the JAX model's template, and
    a bfloat16 tensor leaf reads back in flax as the same bfloat16
    array."""
    variables = dict(jax_variables["fgt"])
    path = str(tmp_path / "fgt.msgpack")
    checkpoint.save_pytree(variables, path)
    restored = jckpt.load_pytree(variables, path)
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), b)
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}
    checkpoint.save_pytree(tree, path)
    want = np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3))
    np.testing.assert_array_equal(
        serialization.msgpack_restore(open(path, "rb").read())["w"], want)


def test_unread_data_raises():
    """ext 2 (a Python complex), an unknown ext code, an unknown dtype,
    truncated and trailing bytes: ValueError, naming what."""
    import msgpack as reference_msgpack

    with pytest.raises(ValueError, match="ext type 2"):
        msgpack.unpack(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="ext type 9"):
        msgpack.unpack(reference_msgpack.packb(
            {"x": reference_msgpack.ExtType(9, b"abc")}))
    payload = reference_msgpack.packb(((2,), "float8_e9", b"\x00\x00"))
    with pytest.raises(ValueError, match="unknown dtype"):
        msgpack.unpack(reference_msgpack.packb(
            {"x": reference_msgpack.ExtType(1, payload)}))
    data = serialization.msgpack_serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpack(data[:-2])
    with pytest.raises(ValueError, match="trailing"):
        msgpack.unpack(data + b"\xc0")


def test_mismatched_tree_raises_naming_the_path(jax_variables):
    """No partial load: a tree of another model, one leaf missing, one
    leaf too many or a config of another width raise ValueError naming
    the path; so does RAFT big's params without its batch stats."""
    lafc = jax_variables["lafc"]
    with pytest.raises(ValueError, match="missing .*params/net/"):
        weights.state_from_variables("fgt", lafc, TINY_FGT)
    dropped = {"params": {"net": dict(lafc["params"]["net"])}}
    del dropped["params"]["net"]["middle0"]
    with pytest.raises(ValueError, match="middle0/conv/kernel"):
        weights.state_from_variables("lafc", dropped, TINY_LAFC)
    extra = {"params": {"net": dict(lafc["params"]["net"],
                                    stray={"kernel": np.zeros(3)})}}
    with pytest.raises(ValueError, match="not in the model.*stray"):
        weights.state_from_variables("lafc", extra, TINY_LAFC)
    with pytest.raises(ValueError, match="wrong shape"):
        weights.state_from_variables("lafc", lafc, dict(TINY_LAFC, cnum=16))
    with pytest.raises(ValueError, match="batch_stats"):
        weights.state_from_variables("raft", jax_variables["raft"]["params"])
    with pytest.raises(ValueError, match="unknown model kind"):
        weights.state_from_variables("vgg", lafc)


# ------------------------------------------------- committed fixtures

FIXTURES = os.path.join(ROOT, "tests", "data", "msgpack")
FIXTURE_CHUNK = 64         # flax's MAX_CHUNK_SIZE when chunked.msgpack is made


def fixture_trees() -> dict:
    """The trees of ``tests/data/msgpack/*.msgpack`` (a few KB): a
    variables-shaped tree, every leaf type flax writes, and chunked f32
    and bf16 leaves."""
    rng = np.random.RandomState(7)
    bf16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    return {
        "variables": {
            "params": {"net": {"conv": {
                "kernel": rng.randn(3, 3, 2, 4).astype(np.float32),
                "bias": rng.randn(4).astype(np.float32)}}},
            "batch_stats": {"norm": {
                "mean": rng.randn(4).astype(np.float32),
                "var": rng.rand(4).astype(np.float32)}}},
        "leaves": {
            "bf16": bf16(rng.randn(4, 6)), "f16": rng.randn(5).astype(
                np.float16), "f64": rng.randn(2, 2), "i64": np.arange(
                    -3, 4), "u8": np.arange(9, dtype=np.uint8).reshape(3, 3),
            "bool": rng.rand(6) > 0.5, "empty": np.zeros((0, 3), np.float32),
            "step": np.int32(1234), "lr": np.float32(2.5e-4),
            "name": "fgt", "n": -70000, "x": 0.125, "flag": False,
            "none": None},
        "chunked": {"params": {
            "big": rng.randn(10, 7).astype(np.float32),
            "big_bf16": bf16(rng.randn(5, 8)),
            "small": rng.randn(3).astype(np.float32)}},
    }


def fixture_bytes(name: str, tree) -> bytes:
    """flax's bytes of a fixture (``chunked`` at ``FIXTURE_CHUNK``)."""
    old = serialization.MAX_CHUNK_SIZE
    if name == "chunked":
        serialization.MAX_CHUNK_SIZE = FIXTURE_CHUNK
    try:
        return serialization.msgpack_serialize(tree)
    finally:
        serialization.MAX_CHUNK_SIZE = old


def fixture_manifest(tree, prefix=()) -> dict:
    """{leaf path: {shape, dtype, sha256 of the C bytes, sum}} of the
    array leaves of a restored fixture (bfloat16 by its bits)."""
    import hashlib

    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(fixture_manifest(v, path))
        elif isinstance(v, (np.ndarray, np.generic)):
            a = np.asarray(v)
            raw = a.view(np.int16) if a.dtype.name == "bfloat16" else a
            out["/".join(path)] = {
                "shape": list(a.shape), "dtype": a.dtype.name,
                "sha256": hashlib.sha256(raw.tobytes()).hexdigest(),
                "sum": float(a.astype(np.float64).sum())}
        else:
            out["/".join(path)] = {"value": v}
    return out


def write_fixtures() -> None:
    """Rewrite ``tests/data/msgpack``: each tree as flax writes it, and
    ``manifest.json`` of what flax restores."""
    os.makedirs(FIXTURES, exist_ok=True)
    manifest = {}
    for name, tree in fixture_trees().items():
        data = fixture_bytes(name, tree)
        with open(os.path.join(FIXTURES, f"{name}.msgpack"), "wb") as f:
            f.write(data)
        manifest[f"{name}.msgpack"] = fixture_manifest(
            serialization.msgpack_restore(data))
    with open(os.path.join(FIXTURES, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


@pytest.mark.parametrize("name", sorted(fixture_trees()))
def test_committed_fixtures_are_flax_written_and_read(name):
    """Each committed fixture is the bytes flax writes of its tree today,
    its manifest is what flax restores, and the card's check
    (``chip_smoke.check_msgpack_fixtures``) passes on the port's read."""
    import chip_smoke

    tree = fixture_trees()[name]
    with open(os.path.join(FIXTURES, f"{name}.msgpack"), "rb") as f:
        data = f.read()
    assert data == fixture_bytes(name, tree)
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest[f"{name}.msgpack"] == fixture_manifest(
        serialization.msgpack_restore(data))
    _assert_same_tree(msgpack.unpack(data),
                      serialization.msgpack_restore(data))
    assert chip_smoke.check_msgpack_fixtures(FIXTURES)[f"{name}.msgpack"] \
        == len(manifest[f"{name}.msgpack"])


# -------------------------------------------- JAX-written directories

# a config with the lists the JAX trainers write (block sequences)
FGT_CFG = dict(TINY_FGT, input_resolution=[64, 64], kernel_size=[7, 7])


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory, jax_variables):
    """LAFC and FGT directories as the JAX package writes them
    (``lafc.msgpack`` / ``fgt.msgpack`` and ``config.yaml``), RAFT's
    ``raft.msgpack``, and the same weights as ``.pth`` directories
    (through the weight tables) with the same YAML."""
    root = tmp_path_factory.mktemp("jax_dirs")
    jckpt.save_model_dir(jax_variables["lafc"], TINY_LAFC,
                         str(root / "lafc"), name="lafc")
    jckpt.save_model_dir(jax_variables["fgt"], FGT_CFG, str(root / "fgt"),
                         name="fgt")
    jckpt.save_pytree(jax_variables["raft"], str(root / "raft.msgpack"))
    for kind in ("lafc", "fgt"):
        (root / f"{kind}_pth").mkdir()
        torch.save(weights.jax_to_torch_state(jax_variables[kind],
                                              TABLES[kind]),
                   root / f"{kind}_pth" / f"{kind}.pth.tar")
        (root / f"{kind}_pth" / "config.yaml").write_bytes(
            (root / kind / "config.yaml").read_bytes())
    torch.save(weights.jax_to_torch_state(jax_variables["raft"],
                                          TABLES["raft"]), root / "raft.pth")
    frames, masks = _video(6, 64, 64, seed=3)
    np.save(root / "frames.npy", frames)
    np.save(root / "masks.npy", masks)
    return root


SLICE_FLAGS = ["--imgH", "64", "--imgW", "64", "--raft_iters", "2",
               "--flow_mask_dilates", "2", "--neighbor_stride", "3",
               "--step", "4", "--f32"]


def _port_cli(root, out, lafc, fgt, raft):
    path = tvi.main(["--path", str(root / "frames.npy"), "--path_mask",
                     str(root / "masks.npy"), "--outroot", str(out),
                     "--lafc_ckpts", str(root / lafc), "--fgt_ckpts",
                     str(root / fgt), "--raft_model", str(root / raft),
                     "--device", "cpu", *SLICE_FLAGS])
    return np.load(path)


def test_cli_reads_jax_directories_as_pth_and_as_the_jax_cli(jax_dirs,
                                                             tmp_path):
    """The port's CLI from the JAX-written directories and raft.msgpack:
    bit-equal to its run from the same weights as ``.pth``; held against
    the JAX CLI reading the same directories under
    ``test_whole_slice_matches_jax_pipeline``'s bound (equal outside the
    hole; inside, mean |diff| <= 0.25 and at most 1% of the pixels off by
    more than 1 level); ``result.mp4`` holds ``result.npy``'s planes."""
    import imageio.v2 as imageio

    root = jax_dirs
    got = _port_cli(root, tmp_path / "port", "lafc", "fgt", "raft.msgpack")
    again = _port_cli(root, tmp_path / "pth", "lafc_pth", "fgt_pth",
                      "raft.pth")
    np.testing.assert_array_equal(got, again)
    planes = video_io.read_planes(str(tmp_path / "port" / "result.mp4"))
    assert len(planes) == len(got)
    for frame, pl in zip(got, planes):
        for a, b in zip(pl, video_io.rgb_to_yuv420(frame)):
            np.testing.assert_array_equal(a, b)

    frames, masks = np.load(root / "frames.npy"), np.load(root / "masks.npy")
    for sub, stack in (("frames", frames), ("masks", masks * 255)):
        (tmp_path / sub).mkdir()
        for i, img in enumerate(stack):
            imageio.imwrite(tmp_path / sub / f"{i:05d}.png", img)
    args = jvi.build_parser().parse_args([
        "--path", str(tmp_path / "frames"), "--path_mask",
        str(tmp_path / "masks"), "--outroot", str(tmp_path / "jax"),
        "--lafc_ckpts", str(root / "lafc"), "--fgt_ckpts", str(root / "fgt"),
        "--raft_model", str(root / "raft.msgpack"), "--vis_frame",
        *SLICE_FLAGS])
    models = jvi.Models(args)
    jvi.video_inpainting(args, models=models)
    want = np.stack([imageio.imread(tmp_path / "jax" / "frames" /
                                    f"{i:05d}.png") for i in range(6)])
    hole = masks > 0
    np.testing.assert_array_equal(got[~hole], frames[~hole])
    np.testing.assert_array_equal(want[~hole], frames[~hole])
    d = np.abs(got.astype(int) - want.astype(int))[hole]
    assert d.mean() <= 0.25 and (d > 1).mean() <= 0.01, (d.mean(), d.max())


def test_cli_refuses_a_directory_of_another_model(jax_dirs, tmp_path):
    """``--fgt_ckpts`` holding LAFC's msgpack raises; the msgpack wins over
    a ``.pth`` beside it."""
    bad = tmp_path / "fgt"
    bad.mkdir()
    (bad / "fgt.msgpack").write_bytes(
        (jax_dirs / "lafc" / "lafc.msgpack").read_bytes())
    (bad / "config.yaml").write_bytes(
        (jax_dirs / "fgt" / "config.yaml").read_bytes())
    (bad / "fgt.pth.tar").write_bytes(
        (jax_dirs / "fgt_pth" / "fgt.pth.tar").read_bytes())
    with pytest.raises(ValueError, match="fgt: the variable tree"):
        tvi._load_ckpt_dir(str(bad), tvi.DEFAULT_FGT_CONFIG)


def test_flow_extract_reads_raft_msgpack(jax_dirs, tmp_path):
    """``flow_extract --raft_model raft.msgpack``: the ``.flo`` files equal
    the run from the same weights as ``.pth`` byte for byte, and the JAX
    tool's ``extract_video`` with its own ``load_pytree`` of the file
    within 5e-3 px (``test_torch_port_flow_extract``'s bound)."""
    from fgt_tpu.core import flow_io as jflow_io
    from fgt_tpu.pipeline.flow_extract import extract_video
    from fgt_tpu_torch.pipeline import flow_extract

    frames = _video(4, 64, 64, seed=11)[0]
    (tmp_path / "data").mkdir()
    np.save(tmp_path / "data" / "clip.npy", frames)
    for name, raft in (("msgpack", "raft.msgpack"), ("pth", "raft.pth")):
        flow_extract.main([
            "--datapath", str(tmp_path / "data"), "--outroot",
            str(tmp_path / name),
            "--height", "64", "--width", "64", "--iters", "2",
            "--raft_model", str(jax_dirs / raft), "--device", "cpu"])
    model = jraft.RAFT(jraft.RAFTConfig(iters=2))
    d = jnp.zeros((1, 64, 64, 3))
    template = jax.jit(lambda: model.init(RNG, d, d, iters=1))()
    variables = jckpt.load_pytree(template, str(jax_dirs / "raft.msgpack"))
    raft_fn = jax.jit(lambda v, a, b: model.apply(v, a, b, iters=2,
                                                  test_mode=True)[1])
    extract_video(raft_fn, variables, frames.astype(np.float32),
                  str(tmp_path / "jax"), chunk=4)
    for sub in ("forward_flo", "backward_flo"):
        files = sorted(os.listdir(tmp_path / "msgpack" / "clip" / sub))
        assert len(files) == 3
        for f in files:
            got = tmp_path / "msgpack" / "clip" / sub / f
            assert got.read_bytes() == \
                (tmp_path / "pth" / "clip" / sub / f).read_bytes()
            np.testing.assert_allclose(
                jflow_io.read_flow(str(got)),
                jflow_io.read_flow(str(tmp_path / "jax" / sub / f)),
                atol=5e-3)


def test_evaluate_reads_i3d_msgpack(jax_dirs, jax_variables, tmp_path):
    """``evaluate --vfid_ckpt i3d.msgpack`` (the JAX package's I3D
    variables): every number equal to the run with the same weights as a
    pytorch-i3d ``.pt``."""
    from fgt_tpu_torch.pipeline import evaluate

    for sub, stack in (("frames", np.load(jax_dirs / "frames.npy")),
                       ("masks", np.load(jax_dirs / "masks.npy"))):
        (tmp_path / sub).mkdir()
        np.save(tmp_path / sub / "clip0.npy", stack)
        np.save(tmp_path / sub / "clip1.npy", stack[::-1])
    jckpt.save_pytree(jax_variables["i3d"], str(tmp_path / "i3d.msgpack"))
    torch.save(weights.jax_to_torch_state(jax_variables["i3d"],
                                          TABLES["i3d"]), tmp_path / "i3d.pt")
    runs = {}
    for name in ("i3d.msgpack", "i3d.pt"):
        runs[name] = evaluate.main([
            "--frames", str(tmp_path / "frames"), "--masks",
            str(tmp_path / "masks"), "--outroot",
            str(tmp_path / f"out_{name}"),
            "--imgH", "64", "--imgW", "64", "--lafc_ckpts",
            str(jax_dirs / "lafc"), "--fgt_ckpts", str(jax_dirs / "fgt"),
            "--raft_model", str(jax_dirs / "raft.msgpack"),
            "--raft_iters", "2", "--vfid_ckpt", str(tmp_path / name),
            "--device", "cpu"])
    a, b = runs["i3d.msgpack"], runs["i3d.pt"]
    assert np.isfinite(a["vfid"])
    for key in ("psnr", "ssim", "l1", "l2", "vfid", "frames"):
        assert a[key] == b[key], key


def test_fgt_trainer_oracle_from_a_jax_lafc_single_run(tmp_path):
    """``flow_checkPoint`` naming a JAX LAFC-single run's
    ``latest/model.msgpack`` (written by ``save_model_dir`` as the JAX
    trainer writes it): the oracle holds the same weights as from the
    ``.pth``, one GAN step gives the same losses, and the oracle's output
    matches the JAX module applied with the JAX package's own load of the
    file (1e-5 of the largest value: f32 convolution order)."""
    from test_torch_port_train import (DIST_CNUM, FGT_SMALL,
                                       LAFC_SINGLE_SMALL, _batch)
    from fgt_tpu_torch.train.trainer import FGTTrainer

    cfg = dict(LAFC_SINGLE_SMALL, model="lafc_single")
    model = build_model("lafc_single", cfg)
    f, m = jnp.zeros((1, 32, 32, 2)), jnp.zeros((1, 32, 32, 1))
    template = jax.jit(lambda: model.init(jax.random.PRNGKey(4), f, m))()
    latest = tmp_path / "LAFC_single_train" / "latest"
    jckpt.save_model_dir(template, cfg, str(latest))
    torch.save(weights.jax_to_torch_state(
        jax.tree_util.tree_map(np.asarray, template),
        weights.lafc_single_mapping(1)), tmp_path / "oracle.pth")
    batch = _batch(seed=2)
    batch = {"frames": batch["frames"], "masks": batch["masks"],
             "forward_flo": batch["flows"]}
    trainers = {}
    for name, ckpt in (("msgpack", latest / "model.msgpack"),
                       ("pth", tmp_path / "oracle.pth")):
        trainers[name] = FGTTrainer(dict(
            FGT_SMALL, name=f"fgt_{name}", outputdir=str(tmp_path), seed=3,
            dist_cnum=DIST_CNUM, mixed_precision=0, record_iter=1,
            flow_checkPoint=str(ckpt), flow_config=LAFC_SINGLE_SMALL,
            train={"lr": 1e-3, "UPDATE_INTERVAL": 100, "MAX_ITERS": 1,
                   "log_freq": 1, "save_checkpoint_freq": 1000}),
            device="cpu")
        trainers[name].train([batch])
    a, b = (trainers[k].flow_model.state_dict() for k in ("msgpack", "pth"))
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    losses = []
    for t in trainers.values():
        with open(t.metrics.path) as fh:
            losses.append([{k: v for k, v in json.loads(line).items()
                            if k not in ("time", "it_per_s")} for line in fh])
    assert losses[0] == losses[1] and "gen_loss" in losses[0][0]

    rng = np.random.RandomState(0)
    flow = rng.randn(2, 32, 32, 2).astype(np.float32)
    mask = (rng.rand(2, 32, 32, 1) > 0.7).astype(np.float32)
    loaded = jckpt.load_pytree(template, str(latest / "model.msgpack"))
    want = np.asarray(model.apply(loaded, jnp.asarray(flow),
                                  jnp.asarray(mask))[0])
    with torch.no_grad():
        got = trainers["msgpack"].flow_model(
            torch.from_numpy(flow), torch.from_numpy(mask))[0].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


if __name__ == "__main__":
    write_fixtures()
