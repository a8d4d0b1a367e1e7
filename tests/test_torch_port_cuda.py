"""The port's CUDA kernels against their plain versions. These need a
GPU and nvcc: marked ``cuda``; they skip on machines without a card and
run there with

    python -m pytest tests/test_torch_port_cuda.py -m cuda
"""

import pytest
import torch

from fgt_tpu_torch.ops import corr_fused as cf
from fgt_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.parametrize("dtype,c,radius,levels", [
    (torch.float32, 64, 4, 4), (torch.bfloat16, 256, 4, 4),
    (torch.float32, 32, 2, 2)])
def test_k1_kernel_matches_plain(dev, dtype, c, radius, levels):
    g = torch.Generator(device=dev).manual_seed(0)
    f1 = torch.randn(2, 15, 21, c, device=dev, generator=g).to(dtype)
    f2 = torch.randn(2, 15, 21, c, device=dev, generator=g)
    pyr = cf.build_fmap_pyramid(f2, levels, dtype=dtype)
    coords = torch.rand(2, 15, 21, 2, device=dev, generator=g) * 24 - 2
    coords[0, 0] = 1e4
    before = cf.lookup_corr_fused.launches
    got = cf.lookup_corr_fused(f1, pyr, coords, radius).float()
    want = cf.lookup_corr_plain(f1, pyr, coords, radius).float()
    assert cf.lookup_corr_fused.launches == before + 1
    top = want.abs().max().item()
    tol = 1e-4 * max(1.0, top) if dtype == torch.float32 else top * 2 ** -7
    assert (got - want).abs().max().item() <= tol
    assert got[0, 0].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel_matches_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(3, 300, 128, device=dev, generator=g).to(dtype)
               for _ in range(3))
    out, lse = fa.flash_mhsa(q, k, v, 128 ** -0.5)
    want, want_lse = fa.flash_attention_plain(q, k, v, 128 ** -0.5)
    top = want.float().abs().max().item()
    tol = 2e-5 if dtype == torch.float32 else top * 2 ** -7
    assert (out.float() - want.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-4


def test_k2_rejects_other_head_dims(dev):
    q = torch.randn(2, 50, 64, device=dev)
    with pytest.raises(ValueError):
        fa.flash_mhsa(q, q, q, 0.125)
