"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels build
with ``nvcc`` on first use); elsewhere they skip. The file imports no JAX,
so it also runs on a host that has only the port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Tolerances: f32 within 1e-4 (the kernel sums in another order than the
plain version); bf16 within 2e-2 (p is rounded to bf16 before the P·V
product, and the output to bf16).
"""

import pytest
import torch

from pddl_tpu_torch.ops import _kernels
from pddl_tpu_torch.ops import attention as tatt

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# (b, h, hkv, d, bs, t, depths): Llama-1B's decode shape at mixed depths
# (0, mid-block, T*bs-1), an odd group (rep 3, D 128), the CPU tests' tiny
# shape.
SHAPES = {
    "llama1b": (8, 32, 8, 64, 16, 64, [0, 7, 16, 100, 391, 512, 777, 1023]),
    "rep3_d128": (4, 12, 4, 128, 16, 8, [0, 5, 70, 127]),
    "tiny": (3, 4, 2, 8, 4, 6, [23, 0, 9]),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _case(dev, dtype, b, h, hkv, d, bs, t, depths, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 1 + b * t
    kp = torch.randn(n, hkv, bs, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n, hkv, bs, d, generator=gen, device=dev).to(dtype)
    table = torch.randperm(n - 1, generator=gen, device=dev)[:b * t] + 1
    q = torch.randn(b, h, 1, d, generator=gen, device=dev).to(dtype)
    index = torch.tensor(depths, dtype=torch.int32, device=dev)
    return q, kp, vp, table.view(b, t).to(torch.int32), index


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 6, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_paged_decode_kernel_matches_plain(shape, dtype, window):
    dev = _card()
    case = _case(dev, dtype, *SHAPES[shape])
    before = _kernels.launch_counts["paged_decode"]
    got = tatt.paged_decode_attention(*case, window=window)
    assert _kernels.launch_counts["paged_decode"] == before + 1
    ref = tatt.paged_decode_attention(*case, window=window, kernel=False)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - ref.float()).abs().max())
    assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_paged_decode_kernel_raises_on_what_it_does_not_take():
    """A CUDA tensor launches the kernel or raises: no quiet fallback."""
    dev = _card()
    q, kp, vp, table, index = _case(dev, torch.float32, *SHAPES["tiny"])
    before = _kernels.launch_counts["paged_decode"]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tatt.paged_decode_attention_kernel(q.half(), kp.half(), vp.half(),
                                           table, index)
    with pytest.raises(ValueError, match="int32"):
        tatt.paged_decode_attention_kernel(q, kp, vp, table.long(), index)
    with pytest.raises(ValueError, match="contiguous"):
        tatt.paged_decode_attention_kernel(
            q, kp.transpose(2, 3).contiguous().transpose(2, 3), vp, table,
            index)
    assert _kernels.launch_counts["paged_decode"] == before
