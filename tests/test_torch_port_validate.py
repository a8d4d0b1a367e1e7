"""In-training validation in the port against the JAX package, on the
CPU: ``validate_lafc`` (LAFC and LAFC-single) and ``validate_fgt`` (with
and without the LAFC-single oracle, with masks from a mask tree and the
centered square) on a DAVIS-style tree (2 videos x 24 PNG frames at
48x64, forward flows, masks), tiny models whose JAX parameters are
carried across by ``convert/weights.py``, validated at 32x32.

Tolerance: the models run in f32 on both sides; their outputs differ by
f32 rounding, which can move a composite's u8 value by one at a
rounding boundary. PSNR and SSIM agree to 1e-3 relative, L1 and L2 to
1e-3 absolute (of values in u8 units for FGT, in flow units for LAFC);
the canvases' pixels agree to 1 (u8).

The JAX functions weigh the hole by ``rect_mask``'s 255 where they take
the centered square (always in ``validate_lafc``); the port's hole is
{0, 1}. The comparisons patch the JAX module's ``rect_mask`` to {0, 1},
and one test pins what the unpatched JAX function does.
"""

import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.core.flow_io import write_flow
from fgt_tpu.core.masks import rect_mask as jax_rect_mask
from fgt_tpu.models.fgt import Model as JaxFGT
from fgt_tpu.models.lafc import Model as JaxLAFC
from fgt_tpu.models.lafc_single import Model as JaxLAFCSingle
from fgt_tpu.train import validate as jval
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.models import lafc as tlafc
from fgt_tpu_torch.models import lafc_single as tls
from fgt_tpu_torch.train import validate as tval
from test_torch_port_train import FGT_SMALL, LAFC_SINGLE_SMALL
from test_train_steps import LAFC_CFG

torch.set_num_threads(1)

H, W, N = 48, 64, 24
RES = (32, 32)
MASK = 12


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def val_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("davis")
    rng = np.random.RandomState(0)
    base = rng.rand(H + 8, W + 24, 3)
    for video in ("bear", "camel"):
        for sub in ("frames", "masks", os.path.join("flows", video,
                                                    "forward_flo")):
            os.makedirs(root / sub / video if "flows" not in sub
                        else root / sub, exist_ok=True)
        for i in range(N):
            frame = base[4:4 + H, i // 2:i // 2 + W]
            frame = frame + 0.1 * rng.rand(H, W, 3)
            imageio.imwrite(root / "frames" / video / f"{i:05d}.png",
                            (frame / 1.1 * 255).astype(np.uint8))
            m = np.zeros((H, W), np.uint8)
            m[10 + i % 5:26, 14 + i:34 + i] = 255
            imageio.imwrite(root / "masks" / video / f"{i:05d}.png", m)
            if i < N - 1:
                yy, xx = np.mgrid[:H, :W] / 10.0
                flow = np.stack([np.sin(yy + i / 5) * 3, np.cos(xx) * 2],
                                -1).astype(np.float32)
                write_flow(flow, str(root / "flows" / video / "forward_flo"
                                     / f"{i:05d}.flo"))
        # backward flows for the LAFC protocol
        bdir = root / "flows" / video / "backward_flo"
        os.makedirs(bdir)
        for i in range(N - 1):
            write_flow(rng.randn(H, W, 2).astype(np.float32),
                       str(bdir / f"{i:05d}.flo"))
    return root


@pytest.fixture
def square01(monkeypatch):
    """The JAX validation's centered square as a {0, 1} hole."""
    monkeypatch.setattr(jval, "rect_mask",
                        lambda *a, **k: (jax_rect_mask(*a, **k) > 0)
                        .astype(np.uint8))


@pytest.fixture(scope="module")
def lafc_models():
    out = {}
    flows = jnp.zeros((1, 3) + RES + (2,))
    masks = jnp.zeros((1, 3) + RES + (1,))
    jm = JaxLAFC(config=LAFC_CFG)
    v = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), flows, masks))
    tm = tlafc.Model(LAFC_CFG)
    weights.load_state(tm, weights.jax_to_torch_state(
        v, weights.lafc_mapping(0)))
    out[False] = (jm, v, tm)
    js = JaxLAFCSingle(config=LAFC_CFG)
    v = _np_tree(jax.jit(js.init)(jax.random.PRNGKey(1), flows[:, 0],
                                  masks[:, 0]))
    ts = tls.Model(LAFC_CFG)
    weights.load_state(ts, weights.jax_to_torch_state(
        v, weights.lafc_single_mapping(0)))
    out[True] = (js, v, ts)
    return out


@pytest.fixture(scope="module")
def fgt_models():
    shape = (1, 5) + RES
    gen = JaxFGT(config=dict(FGT_SMALL, res_h=RES[0], res_w=RES[1]))
    g_vars = _np_tree(jax.jit(gen.init)(
        jax.random.PRNGKey(3), jnp.zeros(shape + (3,)),
        jnp.zeros(shape + (2,)), jnp.zeros(shape + (1,))))
    oracle = JaxLAFCSingle(config=LAFC_SINGLE_SMALL)
    o_vars = _np_tree(jax.jit(oracle.init)(
        jax.random.PRNGKey(4), jnp.zeros((1,) + RES + (2,)),
        jnp.zeros((1,) + RES + (1,))))
    tgen = tfgt.Model(dict(FGT_SMALL, res_h=RES[0], res_w=RES[1]))
    weights.load_state(tgen, weights.jax_to_torch_state(
        g_vars, weights.fgt_mapping(FGT_SMALL["numBlocks"])))
    toracle = tls.Model(LAFC_SINGLE_SMALL).eval()
    weights.load_state(toracle, weights.jax_to_torch_state(
        o_vars, weights.lafc_single_mapping(1)))
    return gen, g_vars, oracle, o_vars, tgen, toracle


def _assert_scores(got, want):
    assert sorted(got) == sorted(want) == ["l1", "l2", "psnr", "ssim"]
    for k in ("psnr", "ssim"):
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), (k, got, want)
    for k in ("l1", "l2"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got, want)


def _assert_canvases(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert names and sorted(os.listdir(got_dir)) == names
    for name in names:
        a = imageio.imread(os.path.join(got_dir, name)).astype(int)
        b = imageio.imread(os.path.join(want_dir, name)).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name


@pytest.mark.parametrize("single", [False, True])
def test_validate_lafc_matches_jax(val_tree, lafc_models, single, square01,
                                   tmp_path):
    jm, v, tm = lafc_models[single]
    flow_root = str(val_tree / "flows")
    want = jval.validate_lafc(jm, v, flow_root, num_videos=2,
                              resolution=RES, mask_size=MASK, num_flows=3,
                              interval=3, single=single,
                              save_dir=str(tmp_path / "jax"))
    got = tval.validate_lafc(tm, flow_root, num_videos=2, resolution=RES,
                             mask_size=MASK, num_flows=3, interval=3,
                             single=single, save_dir=str(tmp_path / "port"))
    _assert_scores(got, want)
    _assert_canvases(tmp_path / "port", tmp_path / "jax")


def test_jax_validate_lafc_weighs_the_hole_by_255(val_tree, lafc_models):
    """The unpatched JAX function composites filled·255 - 254·target in
    the hole, so its L1 is far from the {0, 1} composite's."""
    jm, v, tm = lafc_models[False]
    flow_root = str(val_tree / "flows")
    quirk = jval.validate_lafc(jm, v, flow_root, num_videos=2,
                               resolution=RES, mask_size=MASK)
    got = tval.validate_lafc(tm, flow_root, num_videos=2, resolution=RES,
                             mask_size=MASK)
    assert quirk["l1"] > 10 * got["l1"]


@pytest.mark.parametrize("oracle", [False, True])
@pytest.mark.parametrize("masks", [True, False])
def test_validate_fgt_matches_jax(val_tree, fgt_models, oracle, masks,
                                  square01, tmp_path):
    gen, g_vars, jor, o_vars, tgen, tor = fgt_models
    mask_root = str(val_tree / "masks") if masks else None
    kw = dict(num_videos=2, resolution=RES, mask_size=MASK, pivot=20,
              num_frames=5)
    want = jval.validate_fgt(
        gen, g_vars, str(val_tree / "frames"), str(val_tree / "flows"),
        flow_params=o_vars if oracle else None,
        flow_model=jor if oracle else None, mask_root=mask_root,
        save_dir=str(tmp_path / "jax"), **kw)
    got = tval.validate_fgt(
        tgen, str(val_tree / "frames"), str(val_tree / "flows"),
        flow_model=tor if oracle else None, mask_root=mask_root,
        save_dir=str(tmp_path / "port"), **kw)
    _assert_scores(got, want)
    _assert_canvases(tmp_path / "port", tmp_path / "jax")


def test_validation_reads_png_only(val_tree, fgt_models, tmp_path):
    """Frames come as PNG or as the JPEG the decoder takes; a JPEG it
    does not take (arithmetic-coded: progressive data announced as SOF10)
    raises, naming it, rather than being skipped."""
    import cv2

    frames = tmp_path / "frames" / "v"
    frames.mkdir(parents=True)
    data = cv2.imencode(".jpg", np.zeros((H, W, 3), np.uint8),
                        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    sof = data.index(b"\xff\xc2")
    data = data[:sof + 1] + b"\xca" + data[sof + 2:]
    for i in range(8):
        (frames / f"{i:05d}.jpg").write_bytes(data)
    with pytest.raises(ValueError, match="00000.jpg: arithmetic-coded"):
        tval.validate_fgt(fgt_models[4], str(tmp_path / "frames"), None,
                          resolution=RES, mask_size=MASK)


@pytest.fixture(scope="module")
def jpeg_val_tree(val_tree, tmp_path_factory):
    """The DAVIS-style tree with its frames as ``NNNNN.jpg`` (cv2, q90,
    4:2:0; DAVIS ships JPEG frames and PNG masks), flows and masks
    copied."""
    import shutil

    import cv2

    root = tmp_path_factory.mktemp("davis_jpeg") / "t"
    shutil.copytree(val_tree, root,
                    ignore=lambda d, names: [n for n in names
                                             if n.endswith(".png")
                                             and "frames" in d])
    for png in sorted((val_tree / "frames").rglob("*.png")):
        out = root / png.relative_to(val_tree).with_suffix(".jpg")
        cv2.imwrite(str(out), imageio.imread(png)[..., ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
    return root


@pytest.mark.parametrize("oracle", [False, True])
def test_validate_fgt_matches_jax_on_a_jpeg_tree(jpeg_val_tree, fgt_models,
                                                 oracle, tmp_path):
    """``validate_fgt`` on JPEG frames with the PNG mask tree, both
    packages, the tolerances of the PNG runs."""
    gen, g_vars, jor, o_vars, tgen, tor = fgt_models
    assert not list((jpeg_val_tree / "frames").rglob("*.png"))
    kw = dict(num_videos=2, resolution=RES, mask_size=MASK, pivot=20,
              num_frames=5)
    want = jval.validate_fgt(
        gen, g_vars, str(jpeg_val_tree / "frames"),
        str(jpeg_val_tree / "flows"),
        flow_params=o_vars if oracle else None,
        flow_model=jor if oracle else None,
        mask_root=str(jpeg_val_tree / "masks"),
        save_dir=str(tmp_path / "jax"), **kw)
    got = tval.validate_fgt(
        tgen, str(jpeg_val_tree / "frames"), str(jpeg_val_tree / "flows"),
        flow_model=tor if oracle else None,
        mask_root=str(jpeg_val_tree / "masks"),
        save_dir=str(tmp_path / "port"), **kw)
    _assert_scores(got, want)
    _assert_canvases(tmp_path / "port", tmp_path / "jax")


def test_validate_lafc_matches_jax_beside_a_jpeg_tree(jpeg_val_tree,
                                                      lafc_models, square01):
    """``validate_lafc`` reads only flows: the JPEG tree's flows give the
    JAX package's scores."""
    jm, v, tm = lafc_models[False]
    flow_root = str(jpeg_val_tree / "flows")
    want = jval.validate_lafc(jm, v, flow_root, num_videos=2,
                              resolution=RES, mask_size=MASK)
    got = tval.validate_lafc(tm, flow_root, num_videos=2, resolution=RES,
                             mask_size=MASK)
    _assert_scores(got, want)
