"""The PyTorch port's own rules, checked on the CPU:

* no module of ``fgt_tpu_torch`` (nor ``chip_smoke.py``) imports JAX,
  flax, the JAX package, or cv2/imageio/yaml, which the GPU machine lacks;
* entry points default to the ``cuda`` device;
* the weight bridge round-trips every leaf of the RAFT, LAFC and FGT
  tables with no key missing on either side, and its tables equal the
  JAX package's converter tables;
* CPU tensors take the kernels' plain versions without counting a launch;
* frame I/O and the stage timer.
"""

import ast
import inspect
import os
import time

import numpy as np
import pytest
import torch

from fgt_tpu.convert import torch2jax
from fgt_tpu_torch import DEFAULT_DEVICE
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.models import lafc as tlafc
from fgt_tpu_torch.models import raft as traft
from fgt_tpu_torch.ops import corr_fused, flash_attention
from fgt_tpu_torch.pipeline import image_io
from fgt_tpu_torch.pipeline import video_inpainting as tvi

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "fgt_tpu", "cv2", "imageio", "yaml"}


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
    bad = {(os.path.relpath(p, ROOT), m) for p in sources
           for m in _imported_roots(p) if m in FORBIDDEN}
    assert not bad, sorted(bad)


def test_entry_points_default_to_cuda():
    assert DEFAULT_DEVICE == "cuda"
    sig = inspect.signature(tvi.Models.__init__)
    assert sig.parameters["device"].default == "cuda"
    assert tvi.build_parser().parse_args([]).device == "cuda"


def _bridge_roundtrip(module, mapping):
    """Random flax-layout leaves for every mapped path -> torch state ->
    strict load (no key missing either way) -> back to flax layout."""
    rng = np.random.RandomState(0)
    own = module.state_dict()
    tree, leaves = {}, {}
    for path, (key, kind) in mapping.items():
        shape = weights.torch_to_jax_array(kind, own[key].numpy()).shape
        leaf = rng.randn(*shape).astype(np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
        leaves[path] = leaf
    state = weights.jax_to_torch_state(tree, mapping)
    assert set(state) == set(own), sorted(set(state) ^ set(own))[:10]
    weights.load_state(module, state)
    back = weights.torch_to_jax_leaves(module.state_dict(), mapping)
    for path, leaf in leaves.items():
        np.testing.assert_array_equal(back[path], leaf)


@pytest.mark.parametrize("name", ["raft", "lafc", "fgt"])
def test_weight_bridge_roundtrips_every_leaf(name):
    if name == "raft":
        mapping, module = weights.raft_mapping(), traft.RAFT()
        assert mapping == torch2jax.raft_mapping()
    elif name == "lafc":
        mapping = weights.lafc_mapping(1)
        module = tlafc.Model(tvi.DEFAULT_LAFC_CONFIG)
        assert mapping == torch2jax.lafc_mapping(1)
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
    assert corr_fused.lookup_corr_fused.launches == 0
    assert flash_attention.flash_mhsa.launches == 0


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
