"""The PyTorch port's own rules, checked on the CPU:

* no module of ``fgt_tpu_torch`` (nor ``chip_smoke.py``) imports JAX,
  flax, the JAX package, or cv2/imageio/PIL/yaml, which the GPU machine
  lacks;
* entry points default to the ``cuda`` device (the evaluation driver,
  the VFID scorer, both trainers and the training CLI too);
* the weight bridge round-trips every leaf of the RAFT (big and small),
  LAFC, LAFC-single, FGT, T-PatchGAN, I3D and VGG19 tables with no key
  missing on either side, and its tables equal the JAX package's
  converter tables;
* CPU tensors take the kernels' plain versions (K1-K5) without counting a
  launch;
* flash attention stays differentiable when its forward is a kernel
  whose output carries no autograd history;
* the bf16 bodies of K1, K2, K4 and K5 run on tensor cores
  (``mma.sync``), dtype 0 still dispatches to the f32 bodies, and no
  module calls PyTorch's fused attention;
* K3 streams its windows with cp.async in a two-slot ring, and the
  radii its wrapper accepts are the kernel's instantiations;
* the kernel build cache is named after the source and the headers
  beside it;
* frame I/O and the stage timer;
* ``--Nonlocal`` parses as the JAX CLI parses it.
"""

import ast
import inspect
import os
import re
import shutil
import time

import numpy as np
import pytest
import torch

from fgt_tpu.convert import torch2jax
from fgt_tpu_torch import DEFAULT_DEVICE
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.core import vfid as tvfid
from fgt_tpu_torch.models import discriminator as tdisc
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.models import lafc as tlafc
from fgt_tpu_torch.models import lafc_single as tls
from fgt_tpu_torch.models import raft as traft
from fgt_tpu_torch.ops import _build, corr_fused, corr_lookup, flash_attention
from fgt_tpu_torch.pipeline import batch, evaluate, flow_extract, image_io
from fgt_tpu_torch.pipeline import video_inpainting as tvi
from fgt_tpu_torch.train import perceptual as tperc
from fgt_tpu_torch.train import train as train_cli
from fgt_tpu_torch.tools import sustained_train
from fgt_tpu_torch.train.trainer import FGTTrainer, LAFCTrainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "fgt_tpu_torch", "csrc")
FORBIDDEN = {"jax", "jaxlib", "flax", "fgt_tpu", "cv2", "imageio", "yaml",
             "PIL", "msgpack"}


def _port_sources():
    pkg = os.path.join(ROOT, "fgt_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_no_reference_package_no_cv2():
    sources = list(_port_sources())
    assert len(sources) > 15
    rel = {os.path.relpath(p, ROOT) for p in sources}
    for module in ("core/flow_viz.py", "core/metrics.py", "core/vfid.py",
                   "pipeline/evaluate.py", "utils/profiling.py",
                   "core/edge.py", "core/warp.py", "train/lafc_step.py",
                   "train/perceptual.py", "train/precision.py",
                   "core/raster.py", "core/masks.py", "core/region_fill.py",
                   "data/__init__.py", "data/datasets.py", "data/loader.py",
                   "train/validate.py", "train/train.py",
                   "utils/config.py", "core/jpeg.py", "native/__init__.py",
                   "pipeline/image_io.py", "utils/msgpack.py",
                   "core/video_io.py", "tools/demo.py",
                   "core/jpeg_encode.py", "data/mask_models.py",
                   "data/readers.py", "models/registry.py",
                   "utils/progress.py", "tools/sustained_train.py"):
        assert f"fgt_tpu_torch/{module}" in rel, module
    bad = {(os.path.relpath(p, ROOT), m) for p in sources
           for m in _imported_roots(p) if m in FORBIDDEN}
    assert not bad, sorted(bad)


def test_entry_points_default_to_cuda():
    assert DEFAULT_DEVICE == "cuda"
    sig = inspect.signature(tvi.Models.__init__)
    assert sig.parameters["device"].default == "cuda"
    assert tvi.build_parser().parse_args([]).device == "cuda"
    for trainer in (FGTTrainer, LAFCTrainer):
        sig = inspect.signature(trainer.__init__)
        assert sig.parameters["device"].default == "cuda"
    assert train_cli.args_parser(["--model", "lafc"]).device == "cuda"
    assert flow_extract.build_parser().parse_args(
        ["--datapath", "d", "--outroot", "o"]).device == "cuda"
    assert inspect.signature(flow_extract.load_raft).parameters[
        "device"].default == "cuda"
    # the batch driver parses the inference CLI's flags
    assert batch.build_parser is tvi.build_parser
    assert evaluate.build_parser().parse_args(
        ["--frames", "f", "--masks", "m"]).device == "cuda"
    assert inspect.signature(tvfid.VFIDScorer.__init__).parameters[
        "device"].default == "cuda"
    assert inspect.signature(tvfid.vfid).parameters["device"].default == \
        "cuda"
    assert sustained_train.build_parser().parse_args([]).device == "cuda"


def _random_tree(own, paths):
    """Random flax-layout leaves for ``paths`` ({path: (torch key, kind)})
    shaped after the torch ``state_dict`` ``own``."""
    rng = np.random.RandomState(0)
    tree, leaves = {}, {}
    for path, (key, kind) in paths.items():
        shape = weights.torch_to_jax_array(kind, own[key].numpy()).shape
        leaf = rng.randn(*shape).astype(np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
        leaves[path] = leaf
    return tree, leaves


def _bridge_roundtrip(module, mapping):
    """Random flax-layout leaves for every mapped path -> torch state ->
    strict load (no key missing either way) -> back to flax layout."""
    own = module.state_dict()
    tree, leaves = _random_tree(own, mapping)
    state = weights.jax_to_torch_state(tree, mapping)
    assert set(state) == set(own), sorted(set(state) ^ set(own))[:10]
    weights.load_state(module, state)
    back = weights.torch_to_jax_leaves(module.state_dict(), mapping)
    for path, leaf in leaves.items():
        np.testing.assert_array_equal(back[path], leaf)


def _discriminator_roundtrip(module):
    """As :func:`_bridge_roundtrip`, with the spectral ``v`` vectors,
    whose entries the bridge permutes; the torch -> flax ``v`` must equal
    the JAX package's ``convert_discriminator_state``."""
    own = module.state_dict()
    paths = dict(weights.discriminator_mapping())
    for i in range(5):
        paths[("spectral", f"conv{i}", "v")] = (f"conv.{2 * i}.weight_v",
                                                "raw")
    tree, leaves = _random_tree(own, paths)
    state = weights.jax_to_torch_discriminator_state(tree)
    assert set(state) == set(own), sorted(set(state) ^ set(own))[:10]
    weights.load_state(module, state)
    back = weights.torch_to_jax_discriminator_leaves(module.state_dict())
    assert set(back) == set(leaves)
    for path, leaf in leaves.items():
        np.testing.assert_array_equal(back[path], leaf)
    ref = torch2jax.convert_discriminator_state(module.state_dict(), tree)
    for i in range(5):
        np.testing.assert_array_equal(ref["spectral"][f"conv{i}"]["v"],
                                      leaves[("spectral", f"conv{i}", "v")])


@pytest.mark.parametrize("name", ["raft", "raft_small", "lafc",
                                  "lafc_single", "fgt", "discriminator",
                                  "i3d", "vgg19"])
def test_weight_bridge_roundtrips_every_leaf(name):
    if name == "raft":
        mapping, module = weights.raft_mapping(), traft.RAFT()
        assert mapping == torch2jax.raft_mapping()
    elif name == "raft_small":
        mapping, module = weights.raft_small_mapping(), traft.RAFT(small=True)
        assert mapping == torch2jax.raft_small_mapping()
    elif name == "i3d":   # the JAX package converts with code, no table
        mapping, module = weights.i3d_mapping(), tvfid.I3D()
    elif name == "vgg19":  # likewise (convert_vgg19_checkpoint)
        mapping, module = weights.vgg19_mapping(), tperc.VGG19Features()
    elif name == "lafc":
        mapping = weights.lafc_mapping(1)
        module = tlafc.Model(tvi.DEFAULT_LAFC_CONFIG)
        assert mapping == torch2jax.lafc_mapping(1)
    elif name == "lafc_single":
        mapping = weights.lafc_single_mapping(1)
        module = tls.Model({"cnum": 48})
        assert mapping == torch2jax.lafc_single_mapping(1)
    elif name == "discriminator":
        assert weights.discriminator_mapping() == \
            torch2jax.discriminator_mapping()
        _discriminator_roundtrip(tdisc.TemporalPatchGAN(3, 32))
        return
    else:
        mapping = weights.fgt_mapping(8)
        module = tfgt.Model(tvi.DEFAULT_FGT_CONFIG)
        assert mapping == torch2jax.fgt_mapping(8)
    _bridge_roundtrip(module, mapping)


def test_cpu_tensors_take_plain_versions_without_launching():
    corr_fused.lookup_corr_fused.launches = 0
    flash_attention.flash_mhsa.launches = 0
    f = torch.randn(1, 4, 6, 64)
    pyr = corr_fused.build_fmap_pyramid(f, 2)
    out = corr_fused.lookup_corr_fused(f, pyr, torch.zeros(1, 4, 6, 2), 1)
    assert out.shape == (1, 4, 6, 18)
    q = torch.randn(2, 10, 128)
    o, lse = flash_attention.flash_mhsa(q, q, q, 0.1)
    assert o.shape == q.shape and lse.shape == (2, 10)
    dsum = lse * 0
    dq = flash_attention.flash_attention_dq(q, q, q, q, lse, dsum, 0.1)
    dk, dv = flash_attention.flash_attention_dkv(q, q, q, q, lse, dsum, 0.1)
    assert dq.shape == dk.shape == dv.shape == q.shape
    corr_lookup.lookup_corr_pyramid.launches = 0
    vols = corr_lookup.build_corr_pyramid(f, f, 2)
    taps = corr_lookup.lookup_corr_pyramid(vols, torch.zeros(1, 4, 6, 2), 1)
    assert taps.shape == (1, 4, 6, 18) and taps.dtype == torch.float32
    assert corr_lookup.lookup_corr_pyramid.launches == 0
    assert corr_fused.lookup_corr_fused.launches == 0
    for fn in (flash_attention.flash_mhsa, flash_attention.flash_attention_dq,
               flash_attention.flash_attention_dkv):
        assert fn.launches == 0, fn.__name__


def test_route_counter_resets_after_inference_mode():
    """K1's route counter made by a first launch under inference mode
    (as the pipeline runs it) can still be reset outside it."""
    dev = torch.device("cpu")
    corr_fused._routes.pop(dev, None)
    try:
        with torch.inference_mode():
            corr_fused._route_buffer(dev).add_(3)
        corr_fused.reset_route_tiles()
        assert corr_fused._routes[dev].tolist() == [0, 0]
    finally:
        corr_fused._routes.pop(dev, None)


def test_flash_attend_keeps_autograd_history(monkeypatch):
    """On the card the forward kernel fills its output through ctypes, so
    that output has no autograd history. flash_attend must still return a
    tensor with a grad_fn whose backward reaches q, k and v (the
    FlashAttention Function, backward through K4/K5). The kernel is
    stood in for by a detached plain forward."""
    def kernel_like(q, k, v, scale):
        out, lse = flash_attention.flash_attention_plain(
            q.detach(), k.detach(), v.detach(), scale)
        return out, lse

    monkeypatch.setattr(flash_attention, "flash_mhsa", kernel_like)
    q, k, v = (torch.randn(2, 3, 20, 128, requires_grad=True)
               for _ in range(3))
    out = flash_attention.flash_attend(q, k, v, 0.1)
    assert out.grad_fn is not None
    out.square().sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and t.grad.abs().sum() > 0


def _read_csrc(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _body(src: str, name: str) -> str:
    """The braces of the first definition of function ``name`` in ``src``
    (the first ``name(`` in the text)."""
    start = src.index("{", src.index(name + "("))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
    raise ValueError(f"unbalanced braces after {name}")


@pytest.mark.parametrize("source,kernel", [
    ("flash_attention.cu", "flash_fwd_bf16_kernel"),
    ("flash_attention_bwd.cu", "flash_dkv_bf16_kernel"),
    ("flash_attention_bwd.cu", "flash_dq_bf16_kernel")])
def test_bf16_bodies_run_on_tensor_cores(source, kernel):
    """K2's, K4's and K5's bf16 bodies multiply with mma.sync (bf16
    operands, f32 accumulation) on fragments filled by ldmatrix from tiles
    that cp.async brings in."""
    src = _read_csrc(source)
    assert '#include "mma_bf16.cuh"' in src
    body = _body(src, kernel)
    for call in ("mma_bf16(", "ldmatrix_x4(", "ldmatrix_x4_trans(",
                 "load_rows_async<"):
        assert call in body, call
    helper = _body(_read_csrc("mma_bf16.cuh"), "mma_bf16")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in helper


def test_k1_bf16_body_runs_on_tensor_cores():
    """K1's bf16 body serves each (tile, level) by the box route, whose
    window dots come from mma.sync on ldmatrix fragments of f1's tile and
    the box's rows, or by the general route, and counts both; the Python
    constants match the kernel's."""
    src = _read_csrc("corr_fused.cu")
    assert '#include "mma_bf16.cuh"' in src
    body = _body(src, "corr_fused_bf16_kernel")
    for call in ("box_dots<", "general_dots<", "cp_async16(",
                 "atomicAdd(routes"):
        assert call in body, call
    products = _body(src, "stage_dots")
    assert "mma_bf16(" in products and "ldmatrix_x4(" in products
    assert f"kBoxCap = {corr_fused.BOX_CAP};" in src
    assert f"kTile = {corr_fused.TILE};" in src


@pytest.mark.parametrize("source,entry,bf16_launch,f32_launch,f32_kernel", [
    ("flash_attention.cu", "flash_attention_forward", "tc::launch",
     "launch<float>", "flash_fwd_kernel"),
    ("flash_attention_bwd.cu", "flash_attention_dkv", "tc::launch_dkv",
     "launch_dkv<float>", "flash_dkv_kernel"),
    ("flash_attention_bwd.cu", "flash_attention_dq", "tc::launch_dq",
     "launch_dq<float>", "flash_dq_kernel"),
    ("corr_fused.cu", "corr_fused_lookup", "tc::launch", "launch<float>",
     "corr_fused_kernel")])
def test_c_entries_dispatch_on_dtype(source, entry, bf16_launch, f32_launch,
                                     f32_kernel):
    """dtype 1 goes to the tensor-core body, dtype 0 to the f32 body,
    which stays on the FMA units: no mma, no TF32."""
    src = _read_csrc(source)
    found = re.search(r"dtype == 1\s*\?\s*([\w:<>]+)\(.*?:\s*([\w:<>]+)\(",
                      _body(src, 'extern "C" int ' + entry), re.S)
    assert found and found.groups() == (bf16_launch, f32_launch)
    simt = _body(src, f32_kernel)
    assert "fmaf(" in simt and "mma" not in simt and "tf32" not in simt


def test_k3_body_rings_its_windows_and_instantiates_its_radii():
    """K3's body copies each pixel's windows with 16-byte cp.async one
    pixel ahead (wait for all but the newest group), and the C entry
    instantiates exactly the radii ``corr_lookup.KERNEL_RADII`` lets
    through."""
    src = _read_csrc("corr_lookup.cu")
    assert '#include "mma_bf16.cuh"' in src
    body = _body(src, "corr_lookup_kernel")
    for call in ("issue<T, R>(", "taps<T, O, R>(", "cp_async_commit()",
                 "cp_async_wait<1>()"):
        assert call in body, call
    assert "cp_async16(" in _body(src, "issue")
    radii = re.findall(r"case (\d+): return launch<T, O, (\d+)>",
                       _body(src, "launch_radius"))
    assert [int(a) for a, b in radii if a == b] == list(
        corr_lookup.KERNEL_RADII)


def test_no_module_calls_pytorch_fused_attention():
    """SDPA is only chip_smoke.py's yardstick (library_ms); the port
    computes attention with its own kernels."""
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        if path.endswith("chip_smoke.py"):
            assert "scaled_dot_product_attention" in text
        else:
            assert "scaled_dot_product_attention" not in text, path


@pytest.mark.parametrize("edited,rebuilds", [
    ("mma_bf16.cuh", True), ("flash_attention.cu", True),
    ("flash_attention_bwd.cu", False)])
def test_build_cache_name_follows_source_and_headers(tmp_path, edited,
                                                     rebuilds):
    """An edited header beside a source, like an edited source, renames
    the cached library (so it rebuilds); another source does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    src = str(csrc / "flash_attention.cu")
    flags = ["nvcc"] + _build.NVCC_FLAGS
    before = _build._target("flash_attention", src, flags)
    assert before == _build._target("flash_attention", src, flags)
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = _build._target("flash_attention", src, flags)
    assert (after != before) == rebuilds
    assert os.path.dirname(after) == _build.BUILD_DIR


def test_png_roundtrip_and_reads_imageio_files(tmp_path):
    import imageio.v2 as imageio

    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (17, 23, 3)).astype(np.uint8)
    gray = rng.randint(0, 256, (9, 31)).astype(np.uint8)
    for img in (rgb, gray):
        p = str(tmp_path / f"own{img.ndim}.png")
        image_io.write_png(p, img)
        np.testing.assert_array_equal(image_io.read_png(p), img)
        np.testing.assert_array_equal(imageio.imread(p), img)
        q = str(tmp_path / f"imageio{img.ndim}.png")
        imageio.imwrite(q, img)     # adaptive row filters
        np.testing.assert_array_equal(image_io.read_png(q), img)


def test_stage_timer_syncs_the_device_before_stopping(monkeypatch):
    """Device work is charged to the stage that queued it: on a CUDA
    device the timer synchronizes at both ends of every stage."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    timer = tvi.StageTimer("cuda")
    with timer.stage("work"):
        time.sleep(0.05)
    with timer.stage("work"):
        pass
    assert len(calls) == 4
    assert timer.times["work"] >= 0.05
    cpu = tvi.StageTimer("cpu")
    with cpu.stage("x"):
        pass
    assert len(calls) == 4


def test_chunk_backoff_halves_on_device_oom_and_records_it():
    """A device OOM halves the batch and retries (the JAX pipeline's
    _chunk_backoff); an OOM at batch 1 propagates."""
    seen = []

    def dispatch(c):
        seen.append(c)
        if c > 2:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return c * 10

    record = []
    assert tvi.chunk_backoff(dispatch, 8, "s1_raft", record) == (20, 2)
    assert seen == [8, 4, 2]
    assert record == [("s1_raft", 8, 4), ("s1_raft", 4, 2)]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tvi.chunk_backoff(lambda c: dispatch(9), 1, "s6_fgt")


@pytest.mark.parametrize("argv,want", [
    ([], False), (["--Nonlocal", "1"], True), (["--Nonlocal", "True"], True),
    (["--Nonlocal", "False"], True), (["--Nonlocal", "0"], True),
    (["--Nonlocal", ""], False), (["--Nonlocal"], SystemExit)])
def test_nonlocal_parses_as_the_jax_cli(argv, want):
    """``type=bool``, as the JAX CLI and the reference have it: any
    nonempty value turns --Nonlocal on ("False" too), only an empty
    string leaves it off, and a bare flag is an error. Both parsers read
    the same argv the same way."""
    from fgt_tpu.pipeline import video_inpainting as jvi

    for parser in (jvi.build_parser(), tvi.build_parser()):
        if want is SystemExit:
            with pytest.raises(SystemExit):
                parser.parse_args(argv)
        else:
            assert parser.parse_args(argv).Nonlocal is want
