"""The port's data path against the JAX package and cv2, on the CPU:

* ``image_io.resize_nearest`` bit-equal to ``cv2.resize(INTER_NEAREST)``
  over a grid of sizes, up and down; the inference loader's masks equal
  the JAX CLI's ``load_masks`` on an 800-px-wide mask (before the repair
  the port took floor(x·src/dst) and picked other columns);
* ``image_io.resize_linear`` bit-equal to ``cv2.resize`` on float32 with
  1-4 channels at the slice's size pairs: frame and flow sources (the
  test tree's 48x64, 240x432, 480p) to 256x256, 240x432 and 480x864,
  and 240x432 <-> 480x864. cv2 resizes 1, 3 and 4 channels through IPP
  and 2 (flows) through its own path; the pairs where IPP's 3- and
  4-channel kernel leaves the port's lerp are named, with the deviation
  pinned at one ulp;
* the YAML reader equal to ``yaml.safe_load`` on every ``configs/*.yaml``
  and on the writer's output, refusing what it does not read;
* each training dataset's items, key by key, equal to the JAX dataset's
  on a PNG + ``.flo`` tree (48x64, 2 videos x 10 frames) under the same
  ``random`` / ``np.random`` seeds, at the source flow size, below it
  and above it;
* ``ShardedSampler`` equal to the JAX sampler over shards and epochs;
  the spawned 2-worker loader yields the inline loader's items (up to
  the per-worker seeding), propagates a worker's error, and stops its
  workers; the data modules import no torch.
"""

import os
import random
import subprocess
import sys

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import yaml

from fgt_tpu import data as jdata
from fgt_tpu.core.flow_io import write_flow
from fgt_tpu.pipeline import video_inpainting as jvi
from fgt_tpu_torch import data as tdata
from fgt_tpu_torch.data import datasets as tds
from fgt_tpu_torch.pipeline import image_io
from fgt_tpu_torch.pipeline import video_inpainting as tvi
from fgt_tpu_torch.utils.config import dump_yaml, read_yaml
from torch_port_loader_items import FailingItems, IndexItems

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULP_255 = float(np.spacing(np.float32(255)))


# ------------------------------------------------------------ resizes

NEAREST_SIZES = [1, 2, 3, 5, 7, 17, 31, 48, 64, 97, 240, 256, 432, 480,
                 800, 854, 864]


@pytest.mark.parametrize("src", NEAREST_SIZES)
def test_resize_nearest_bit_equal_to_cv2(src):
    rng = np.random.RandomState(src)
    img = rng.randint(0, 256, (src, src + 3), np.uint8)
    for dst in NEAREST_SIZES:
        want = cv2.resize(img, (dst + 1, dst), interpolation=cv2.INTER_NEAREST)
        got = image_io.resize_nearest(img[None], dst, dst + 1)[0]
        assert np.array_equal(got, want), (src, dst)


def test_load_masks_matches_jax_cli_on_a_wide_mask(tmp_path):
    """A 450x800 mask whose columns each hold their own hard edge,
    loaded at 240x432 by both CLIs: equal element for element (the
    parent's floor(x·800/432) picked 15 other columns)."""
    rng = np.random.RandomState(0)
    cols = rng.rand(800) > 0.5
    mask = np.zeros((450, 800), np.uint8)
    mask[:, cols] = 255
    mask[: 450 // 3] = 0
    for i in range(2):
        cv2.imwrite(str(tmp_path / f"{i:05d}.png"), np.roll(mask, i, axis=1))
    want = jvi.load_masks(str(tmp_path), 240, 432, 0, 0)[0]
    got = tvi.load_masks(str(tmp_path), 240, 432) > 0
    assert got.shape == want.shape
    assert np.array_equal(got, want)


SOURCES = [(48, 64), (240, 432), (480, 854), (480, 864)]
TARGETS = [(256, 256), (240, 432), (480, 864)]
PAIRS = sorted({(s, t) for s in SOURCES for t in TARGETS if s != t}
               | {((480, 864), (240, 432)), ((240, 432), (480, 864))})
# cv2's IPP kernel for 3 and 4 channels leaves the lerp here, by one ulp
IPP_UPSCALE = {((48, 64), (480, 864))}


def _float_image(shape, channels, seed):
    img = np.random.RandomState(seed).rand(*shape, channels) * 255
    return img[..., 0].astype(np.float32) if channels == 1 \
        else img.astype(np.float32)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("src,dst", PAIRS)
def test_resize_linear_bit_equal_to_cv2(src, dst, channels):
    img = _float_image(src, channels, seed=sum(src) + channels)
    want = cv2.resize(img, dst[::-1])
    got = image_io.resize_linear(img[None], *dst)[0]
    assert got.shape == want.shape and got.dtype == np.float32
    if channels in (3, 4) and (src, dst) in IPP_UPSCALE:
        err = np.abs(got - want)
        assert 0 < err.max() <= ULP_255, err.max()
        assert (err > 0).mean() < 0.01
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((240, 432), (61, 97)),
                                     ((480, 864), (240, 432)),
                                     ((33, 17), (480, 864))])
def test_resize_linear_flows_take_cv2s_own_path(src, dst):
    """Two channels: cv2's generic path (no IPP), including an exact 2x
    downscale (its area-fast path) and a 4x one."""
    flow = np.random.RandomState(1).randn(*src, 2).astype(np.float32) * 20
    want = cv2.resize(flow, dst[::-1])
    assert np.array_equal(image_io.resize_linear(flow[None], *dst)[0], want)


# ------------------------------------------------------------ YAML

CONFIGS = sorted(f for f in os.listdir(os.path.join(ROOT, "configs"))
                 if f.endswith(".yaml"))


@pytest.mark.parametrize("name", CONFIGS)
def test_read_yaml_equals_pyyaml_on_configs(name, tmp_path):
    path = os.path.join(ROOT, "configs", name)
    with open(path) as f:
        want = yaml.safe_load(f)
    assert read_yaml(path) == want
    out = tmp_path / name
    out.write_text(dump_yaml(want))
    assert yaml.safe_load(out.read_text()) == want
    assert read_yaml(str(out)) == want


@pytest.mark.parametrize("text", [
    "a:\n  - b: 1\n",                     # a mapping in a sequence
    "a: &x 1\nb: *x\n",                   # anchor / alias
    "a: !!str 1\n",                       # tag
    "a: |\n  text\n",                     # block scalar
    "a: 1\n   b: 2\n",                    # stray indentation
    "a: {b: 1\n",                         # unclosed flow map
    "a: 1\n---\nb: 2\n",                  # a second document
    "a:\n\tb: 1\n",                       # tab indentation
])
def test_read_yaml_refuses_what_it_does_not_read(text, tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(ValueError):
        read_yaml(str(path))


def test_read_yaml_nested_flow_and_scalars(tmp_path):
    text = ("# head\n---\nname: run  # trailing\nflags: [1, 2.5, ~, yes, "
            "'a b', \"c\"]\nnest:\n  flow: {x: [1, {y: off}], z: 1e3,\n"
            "         w: .5}\n  deep:\n    k: -7\n    empty:\nlast: null\n")
    path = tmp_path / "c.yaml"
    path.write_text(text)
    assert read_yaml(str(path)) == yaml.safe_load(text)


# ------------------------------------------------------------ datasets

H, W = 48, 64
N_FRAMES = 10


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngtree")
    rng = np.random.RandomState(0)
    for video in ("video_a", "video_b"):
        fd = root / "frames" / video
        fd.mkdir(parents=True)
        for d in ("forward_flo", "backward_flo"):
            (root / "flows" / video / d).mkdir(parents=True)
        for i in range(N_FRAMES):
            imageio.imwrite(fd / f"{i:05d}.png",
                            (rng.rand(H, W, 3) * 255).astype(np.uint8))
            if i < N_FRAMES - 1:
                for d in ("forward_flo", "backward_flo"):
                    write_flow(rng.randn(H, W, 2).astype(np.float32) * 3,
                               str(root / "flows" / video / d /
                                   f"{i:05d}.flo"))
    return root


def _info(root, fh, fw):
    return {"frame_path": str(root / "frames"),
            "flow_path": str(root / "flows"), "name2len": None,
            "flow": {"flow_height": fh, "flow_width": fw},
            "edge": {"sigma": 1, "low_threshold": 0.1,
                     "high_threshold": 0.2}}


DATASETS = {
    "train_dataset": lambda fh, fw: {
        "sample": "random", "input_resolution": (fh, fw), "num_frames": 5,
        "flow_direction": "bi"},
    "train_dataset_edge": lambda fh, fw: {
        "sample": "seq", "num_flows": 3, "flow_interval": 3},
    "train_dataset_single_edge": lambda fh, fw: {"sample": "seq"},
}


@pytest.mark.parametrize("size", [(48, 64), (40, 56), (64, 96)])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_items_equal_jax(tree, name, size):
    """Three items (0, 1, 0) of each dataset under the same seeds: every
    key, dtype, shape and value equal."""
    opt, info = DATASETS[name](*size), _info(tree, *size)
    items = []
    for pkg in (jdata, tdata):
        random.seed(3)
        np.random.seed(3)
        ds = pkg.create_dataset(opt, info, "train", name)
        items.append([ds[i] for i in (0, 1, 0)])
    for want, got in zip(*items):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_name2len_and_helpers(tree):
    assert tds.load_name2len(None, str(tree / "frames")) == \
        jdata.load_name2len(None, str(tree / "frames"))
    mask = (np.random.RandomState(2).rand(60, 90) > 0.5).astype(np.uint8) * 255
    from fgt_tpu.data import datasets as jds
    assert np.array_equal(tds.resize_mask(mask, 48, 64),
                          jds.resize_mask(mask, 48, 64))
    flow = np.random.RandomState(3).randn(60, 90, 2).astype(np.float32)
    assert np.array_equal(tds.flow_tf(flow, 48, 64), jds.flow_tf(flow, 48, 64))
    frame = str(tree / "frames" / "video_a" / "00003.png")
    assert np.array_equal(tds.read_frame(frame, 40, 56),
                          jds.read_frame(frame, 40, 56))


def test_jpeg_frames_raise_naming_the_decoder(tmp_path):
    """Baseline and progressive JPEG frames read as the JAX dataset reads
    them; one the decoder does not take (arithmetic-coded) raises, naming
    the file and what it is."""
    frame = (np.random.RandomState(5).rand(30, 50, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "00000.jpg")
    cv2.imwrite(path, frame)
    assert np.array_equal(tds.read_frame(path, 24, 40),
                          jdata.datasets.read_frame(path, 24, 40))
    cv2.imwrite(path, frame, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert np.array_equal(tds.read_frame(path, 24, 40),
                          jdata.datasets.read_frame(path, 24, 40))
    data = bytearray(open(path, "rb").read())
    sof = data.index(b"\xff\xc2")
    data[sof + 1] = 0xCA            # the same data announced as SOF10
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="00000.jpg: arithmetic-coded"):
        tds.read_frame(path, 8, 8)


def _jpeg_copy(src, dst, rng):
    """The tree with every PNG frame re-encoded as ``NNNNN.jpg`` by cv2
    (varied quality, sampling and restart interval; every third frame
    with EXIF orientation 6, which the datasets ignore, as imageio
    does); flows copied."""
    import shutil

    from PIL import Image

    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.png"))
    samplings = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    for png in sorted(src.rglob("*.png")):
        out = dst / png.relative_to(src).with_suffix(".jpg")
        img = imageio.imread(png)
        k = int(png.stem)
        if k % 3 == 2:
            exif = Image.Exif()
            exif[0x0112] = 6
            Image.fromarray(img).save(out, quality=85, exif=exif.tobytes())
        else:
            cv2.imwrite(str(out), img[..., ::-1], [
                cv2.IMWRITE_JPEG_QUALITY, int(rng.randint(60, 100)),
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samplings[k % 3],
                cv2.IMWRITE_JPEG_RST_INTERVAL, k % 2])
    return dst


@pytest.fixture(scope="module")
def jpeg_tree(tree, tmp_path_factory):
    return _jpeg_copy(tree, tmp_path_factory.mktemp("jpegtree") / "t",
                      np.random.RandomState(1))


@pytest.mark.parametrize("size", [(48, 64), (40, 56)])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_items_equal_jax_on_a_jpeg_tree(jpeg_tree, name, size):
    """The JPEG tree (YouTube-VOS's layout, ``NNNNN.jpg``): three items
    (0, 1, 0) of each dataset under the same seeds, every key equal."""
    opt, info = DATASETS[name](*size), _info(jpeg_tree, *size)
    assert not list(jpeg_tree.rglob("*.png"))
    items = []
    for pkg in (jdata, tdata):
        random.seed(4)
        np.random.seed(4)
        ds = pkg.create_dataset(opt, info, "train", name)
        items.append([ds[i] for i in (0, 1, 0)])
    for want, got in zip(*items):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_cli_loaders_read_jpeg_as_the_jax_cli(jpeg_tree, tmp_path):
    """The inference CLI's ``load_frames`` / ``load_masks`` on a JPEG
    directory against the JAX CLI's (cv2.imread: EXIF orientation
    applied): plain frames resized from 48x64, frames that all carry
    orientation 6 (read as 64x48), JPEG masks and a watermark premask."""
    from PIL import Image

    video = jpeg_tree / "frames" / "video_a"
    tvi_frames, src = tvi.load_frames(str(video), 40, 56)
    jax_frames, jsrc = jvi.load_frames(str(video), 40, 56, 80, 112)
    assert tuple(src) == tuple(jsrc) == (48, 64)
    assert np.array_equal(tvi_frames, jax_frames)

    rot, masks = tmp_path / "rot", tmp_path / "masks"
    rot.mkdir()
    masks.mkdir()
    rng = np.random.RandomState(6)
    exif = Image.Exif()
    exif[0x0112] = 6
    for i in range(3):
        img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(rot / f"{i:05d}.jpg", quality=90,
                                  exif=exif.tobytes())
        m = np.zeros((48, 64), np.uint8)
        m[10 + 3 * i:30, 20:44 - i] = 255
        cv2.imwrite(str(masks / f"{i:05d}.jpg"), m)
    got, src = tvi.load_frames(str(rot), 32, 24)
    want, jsrc = jvi.load_frames(str(rot), 32, 24, 64, 48)
    assert tuple(src) == tuple(jsrc) == (64, 48)
    assert np.array_equal(got, want)
    got_m = tvi.load_masks(str(masks), 40, 56) > 0
    assert np.array_equal(got_m, jvi.load_masks(str(masks), 40, 56, 0, 0)[0])
    wm = tmp_path / "wm"
    wm.mkdir()
    for i in range(3):      # three plain frames of video_b (k % 3 != 2)
        (wm / f"{i:05d}.jpg").write_bytes(
            (video.parent / "video_b" / f"{3 * i:05d}.jpg").read_bytes())
    got, _ = tvi.load_frames(str(wm), 40, 56, premask_path=str(masks))
    want, _ = jvi.load_frames(str(wm), 40, 56, 80, 112,
                              mask_path=str(masks), premask=True)
    assert np.array_equal(got, want)


def test_load_frames_resizes_each_frame_from_its_own_size(tmp_path):
    """The JAX CLI resizes every frame (and mask) from its own size, so a
    directory of frames of two sizes loads; the parent stacked them at
    the source size first and raised. Source size: the last frame's."""
    rng = np.random.RandomState(8)
    for i, (h, w) in enumerate([(48, 64), (60, 80), (48, 64)]):
        cv2.imwrite(str(tmp_path / f"{i:05d}.png"),
                    (rng.rand(h, w, 3) * 255).astype(np.uint8))
    got, src = tvi.load_frames(str(tmp_path), 40, 56)
    want, jsrc = jvi.load_frames(str(tmp_path), 40, 56, 80, 112)
    assert tuple(src) == tuple(jsrc) == (48, 64)
    assert np.array_equal(got, want)
    got_m = tvi.load_masks(str(tmp_path), 40, 56) > 0
    assert np.array_equal(got_m, jvi.load_masks(str(tmp_path), 40, 56, 0,
                                                0)[0])


def test_evaluation_ground_truth_reads_jpeg_as_the_jax_tool(jpeg_tree):
    """``evaluate.ground_truth`` on a JPEG directory: the JAX tool's
    imageio read (orientation ignored) and cv2's uint8 resize."""
    from fgt_tpu_torch.pipeline import evaluate

    video = jpeg_tree / "frames" / "video_b"
    got = evaluate.ground_truth(str(video), 6, 40, 56)
    files = sorted(os.listdir(video))[:6]
    want = np.stack([cv2.resize(imageio.imread(video / f)[..., :3], (56, 40))
                     for f in files])
    assert np.array_equal(got, want)


def test_failed_item_falls_back_to_item_zero_as_jax(tree):
    """A video that cannot load yields item 0, as in the JAX package (and
    the reference): equal items under the same seeds. When item 0 fails
    too, the error propagates."""
    info = _info(tree, H, W)
    opt = DATASETS["train_dataset_single_edge"](H, W)
    items = []
    for pkg in (jdata, tdata):
        ds = pkg.create_dataset(opt, info, "train",
                                "train_dataset_single_edge")
        ds.name2len = dict(ds.name2len, video_b=0)   # video_b cannot load
        random.seed(1)
        np.random.seed(1)
        items.append(ds[1])
    assert sorted(items[1]) == sorted(items[0])
    for k in items[0]:
        assert np.array_equal(items[1][k], items[0][k]), k
    ds.name2len = {"video_a": 0, "video_b": 0}
    with pytest.raises(ValueError):
        ds[1]


# ------------------------------------------------------------ loader

@pytest.mark.parametrize("n,shards,shuffle", [(10, 1, True), (10, 3, True),
                                              (2, 4, True), (7, 2, False)])
def test_sharded_sampler_equals_jax(n, shards, shuffle):
    for shard in range(shards):
        want = jdata.ShardedSampler(n, shard, shards, shuffle, seed=5)
        got = tdata.ShardedSampler(n, shard, shards, shuffle, seed=5)
        assert len(got) == len(want)
        for epoch in range(3):
            want.set_epoch(epoch)
            got.set_epoch(epoch)
            assert list(got) == list(want)


def test_two_worker_loader_yields_the_inline_items():
    ds = IndexItems(11)
    sampler = tdata.ShardedSampler(len(ds), seed=2)
    inline = list(tdata.DataLoader(ds, 3, sampler, num_workers=0))
    with tdata.DataLoader(ds, 3, sampler, num_workers=2) as loader:
        pooled = list(loader)
        again = list(loader)                      # the pool is reused
        pool = loader._pool
        procs = list(pool._processes.values())
    assert loader._pool is None
    assert all(not p.is_alive() for p in procs)
    assert len(pooled) == len(inline) == len(again) == 3
    for a, b, c in zip(inline, pooled, again):
        assert np.array_equal(a["index"], b["index"])
        assert np.array_equal(a["index"], c["index"])
        assert a["draw"].shape == b["draw"].shape == (3, 1)


def test_worker_error_propagates():
    ds = FailingItems(6, bad=4)
    loader = tdata.DataLoader(ds, 2, tdata.ShardedSampler(6, shuffle=False),
                              num_workers=2)
    try:
        with pytest.raises(RuntimeError, match="item 4"):
            list(loader)
    finally:
        loader.close()


def test_real_dataset_through_two_workers(tree):
    info = _info(tree, H, W)
    opt = dict(DATASETS["train_dataset_edge"](H, W), batch_size=2,
               n_workers=2)
    ds = tdata.create_dataset(opt, info, "train", "train_dataset_edge")
    inline = next(iter(tdata.create_dataloader(
        "train", ds, dict(opt, n_workers=0), {"seed": 1})))
    loader = tdata.create_dataloader("train", ds, opt, {"seed": 1})
    try:
        pooled = next(iter(loader))
    finally:
        loader.close()
    assert sorted(pooled) == sorted(inline)
    for k in inline:
        assert pooled[k].shape == inline[k].shape and \
            pooled[k].dtype == inline[k].dtype, k
    assert set(np.unique(pooled["masks"])) <= {0.0, 1.0}


def test_data_modules_import_no_torch():
    """The loader's workers import the datasets; none of it is torch."""
    code = ("import sys, fgt_tpu_torch.data, fgt_tpu_torch.data.datasets; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"
