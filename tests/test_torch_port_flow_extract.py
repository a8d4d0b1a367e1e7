"""Offline flow extraction, ``.flo`` I/O and the batch driver of the
port, on the CPU:

* ``write_flow``/``read_flow`` round trip, and each package reads the
  other's files;
* ``python -m fgt_tpu_torch.pipeline.flow_extract`` (PNG directory and
  ``.npy`` stack, resized from another source size) against the JAX
  package's ``extract_video`` with the same RAFT weights, f32, 2
  iterations, on the all-pairs pyramid path (K3's plain version);
* ``run_batch`` over two tiny videos with one resident model set.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_port_pipeline import TINY_FGT, TINY_LAFC, _video
from fgt_tpu.core import flow_io as jflow_io
from fgt_tpu.models.raft import RAFT, RAFTConfig
from fgt_tpu.pipeline.flow_extract import extract_video
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.core import flow_io
from fgt_tpu_torch.models import raft as traft
from fgt_tpu_torch.ops import corr_lookup as tcl
from fgt_tpu_torch.pipeline import batch, flow_extract, image_io
from fgt_tpu_torch.pipeline import video_inpainting as tvi

torch.set_num_threads(1)


def test_flo_roundtrip_and_cross_read(tmp_path):
    rng = np.random.RandomState(0)
    flow = (rng.randn(7, 11, 2) * 9).astype(np.float32)
    flow_io.write_flow(flow, str(tmp_path / "port.flo"))
    jflow_io.write_flow(flow, str(tmp_path / "jax.flo"))
    for reader in (flow_io.read_flow, jflow_io.read_flow):
        for name in ("port.flo", "jax.flo"):
            np.testing.assert_array_equal(reader(str(tmp_path / name)), flow)
    assert (tmp_path / "port.flo").read_bytes() == \
        (tmp_path / "jax.flo").read_bytes()


def test_flow_extract_cli_matches_jax_extract_video(tmp_path):
    """Two videos at 72x80 (a PNG directory and an .npy stack), resized
    to 64x64; 4 and 5 frames with --chunk 3 (a partial last chunk).
    Tolerance 5e-3 px: f32 reassociation through 2 GRU iterations."""
    import cv2

    videos = {"a_png": _video(4, 72, 80, seed=11)[0],
              "b_npy": _video(5, 72, 80, seed=12)[0]}
    data = tmp_path / "data"
    (data / "a_png").mkdir(parents=True)
    for i, fr in enumerate(videos["a_png"]):
        image_io.write_png(str(data / "a_png" / f"{i:05d}.png"), fr)
    np.save(data / "b_npy.npy", videos["b_npy"])

    model = RAFT(RAFTConfig(iters=2))
    dummy = jnp.zeros((1, 64, 64, 3))
    variables = jax.jit(lambda r: model.init(r, dummy, dummy, iters=1))(
        jax.random.PRNGKey(2))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = traft.RAFT()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.raft_mapping()))
    torch.save(port.state_dict(), tmp_path / "raft.pth")

    tcl.lookup_corr_pyramid.launches = 0
    n = flow_extract.main([
        "--datapath", str(data), "--outroot", str(tmp_path / "port"),
        "--height", "64", "--width", "64", "--iters", "2", "--chunk", "3",
        "--raft_model", str(tmp_path / "raft.pth"), "--device", "cpu"])
    assert n == 9 and tcl.lookup_corr_pyramid.launches == 0

    raft_fn = jax.jit(lambda v, a, b: model.apply(v, a, b, iters=2,
                                                  test_mode=True)[1])
    for name, frames in videos.items():
        resized = np.stack([cv2.resize(f.astype(np.float32), (64, 64),
                                       interpolation=cv2.INTER_LINEAR)
                            for f in frames])
        extract_video(raft_fn, variables, resized,
                      str(tmp_path / "jax" / name), chunk=3)
        for sub in ("forward_flo", "backward_flo"):
            files = sorted(os.listdir(tmp_path / "jax" / name / sub))
            assert files == sorted(os.listdir(tmp_path / "port" / name / sub))
            assert len(files) == len(frames) - 1
            for f in files:
                got = flow_io.read_flow(str(tmp_path / "port" / name / sub
                                            / f))
                want = jflow_io.read_flow(str(tmp_path / "jax" / name / sub
                                              / f))
                assert got.shape == (64, 64, 2)
                np.testing.assert_allclose(got, want, atol=5e-3)


def test_flow_extract_reads_a_jpeg_tree_as_the_jax_tool(tmp_path):
    """A JPEG video (``NNNNN.jpg``, one frame with EXIF orientation 6,
    which the JAX tool's imageio ignores) and a PNG frame among them,
    sorted together: the frames the port's CLI resizes equal the JAX
    tool's (imageio + cv2 float resize), and its flows equal
    ``extract_video``'s on those frames within 5e-3 px."""
    import cv2
    from PIL import Image

    frames = _video(4, 72, 80, seed=21)[0]
    video = tmp_path / "data" / "clip"
    video.mkdir(parents=True)
    for i, fr in enumerate(frames):
        path = video / f"{i:05d}.{'png' if i == 2 else 'jpg'}"
        if i == 1:
            exif = Image.Exif()
            exif[0x0112] = 6
            Image.fromarray(fr).save(path, quality=90, exif=exif.tobytes())
        elif i == 2:
            image_io.write_png(str(path), fr)
        else:
            cv2.imwrite(str(path), fr[..., ::-1])
    import imageio.v2 as imageio

    files = sorted(os.listdir(video))
    jax_frames = np.stack([cv2.resize(
        imageio.imread(video / f).astype(np.float32)[..., :3], (64, 64),
        interpolation=cv2.INTER_LINEAR) for f in files])
    port_frames = image_io.resize_linear(
        image_io.read_stack(str(video), "unchanged"), 64, 64)
    np.testing.assert_array_equal(port_frames, jax_frames)

    model = RAFT(RAFTConfig(iters=2))
    dummy = jnp.zeros((1, 64, 64, 3))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: model.init(r, dummy, dummy, iters=1))(jax.random.PRNGKey(3)))
    port = traft.RAFT()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.raft_mapping()))
    torch.save(port.state_dict(), tmp_path / "raft.pth")
    n = flow_extract.main([
        "--datapath", str(tmp_path / "data"), "--outroot",
        str(tmp_path / "port"), "--height", "64", "--width", "64",
        "--iters", "2", "--raft_model", str(tmp_path / "raft.pth"),
        "--device", "cpu"])
    assert n == 4
    raft_fn = jax.jit(lambda v, a, b: model.apply(v, a, b, iters=2,
                                                  test_mode=True)[1])
    extract_video(raft_fn, variables, jax_frames, str(tmp_path / "jax"))
    for sub in ("forward_flo", "backward_flo"):
        for i in range(3):
            got = flow_io.read_flow(str(tmp_path / "port" / "clip" / sub /
                                        f"{i:05d}.flo"))
            want = jflow_io.read_flow(str(tmp_path / "jax" / sub /
                                          f"{i:05d}.flo"))
            np.testing.assert_allclose(got, want, atol=5e-3)


def test_run_batch_serves_two_videos_with_one_model_set(tmp_path, monkeypatch):
    """Both rows ok, one result per video, unchanged outside the hole;
    ``Models`` is built once for the batch."""
    built = []
    real = tvi.Models

    def counting(*a, **k):
        built.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tvi, "Models", counting)
    videos = {}
    for v in range(2):
        frames, masks = _video(4, 32, 32, seed=13 + v)
        videos[f"v{v}"] = (frames, masks)
        for sub, arr in (("videos", frames), ("masks", masks * 255)):
            (tmp_path / sub / f"v{v}").mkdir(parents=True)
            for i, a in enumerate(arr):
                image_io.write_png(str(tmp_path / sub / f"v{v}" /
                                       f"{i:05d}.png"), a)
    for sub, cfg in (("lafc", TINY_LAFC), ("fgt", TINY_FGT)):
        (tmp_path / sub).mkdir()
        with open(tmp_path / sub / "config.json", "w") as f:
            json.dump(cfg, f)
    rows = batch.main([
        "--videos_root", str(tmp_path / "videos"), "--masks_root",
        str(tmp_path / "masks"), "--outroot", str(tmp_path / "out"),
        "--lafc_ckpts", str(tmp_path / "lafc"), "--fgt_ckpts",
        str(tmp_path / "fgt"), "--raft_model", "/nonexistent",
        "--imgH", "32", "--imgW", "32", "--raft_iters", "1",
        "--flow_mask_dilates", "1", "--neighbor_stride", "2", "--step", "2",
        "--f32", "--device", "cpu"])
    assert len(built) == 1
    assert [r["video"] for r in rows] == ["v0", "v1"]
    assert all(r["ok"] for r in rows), rows
    with open(tmp_path / "out" / "batch_summary.jsonl") as f:
        assert [json.loads(line)["ok"] for line in f] == [True, True]
    for name, (frames, masks) in videos.items():
        out = np.load(tmp_path / "out" / name / "result.npy")
        assert out.shape == frames.shape and out.dtype == np.uint8
        np.testing.assert_array_equal(out[masks == 0], frames[masks == 0])
