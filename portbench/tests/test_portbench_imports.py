"""A fresh interpreter that imports the harness and the reference holds
no module of JAX or of the JAX package (top-level names compared whole),
and the reference imports nothing of the port."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROBE = """
import json, sys
import portbench.run, portbench.control, portbench.kinds.infer
import portbench.kinds.train
import portbench.reference.pipeline, portbench.reference.train
import portbench.reference.lowp
import fgt_tpu_torch.pipeline.video_inpainting, fgt_tpu_torch.train.fgt_step
tops = sorted({n.split('.')[0] for n in sys.modules})
print(json.dumps(tops))
"""

REF_PROBE = """
import json, sys
import portbench.reference.pipeline, portbench.reference.train
import portbench.reference.lowp, portbench.counts, portbench.weights
print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))
"""


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    assert not _tops(PROBE) & {"jax", "jaxlib", "flax", "fgt_tpu"}


def test_reference_loads_nothing_of_the_port():
    tops = _tops(REF_PROBE)
    assert not tops & {"jax", "jaxlib", "flax", "fgt_tpu", "fgt_tpu_torch"}
