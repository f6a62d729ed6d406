"""Synchronized BatchNorm on the card (`pddl_tpu_torch/models/resnet.py`).
These tests need an NVIDIA card; elsewhere they skip. The file imports no
JAX, so it runs on a host that has only the port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dist_cuda.py -q

It opens a process group of one on the card (NCCL) for its module, with
a gloo group beside it for the CPU side. A BatchNorm bound to a group of
one makes the plain ``native_batch_norm`` call, bitwise the unbound one's
(outputs, gradients, running averages). The synchronized path itself, run
over the group of one, agrees with the same path on the CPU within 1e-5
(f32; the card's reductions sum in another order), and with
``native_batch_norm`` within 1e-5.
"""

import os
import socket

import pytest
import torch
import torch.distributed as tdist

from pddl_tpu_torch.models.resnet import (
    BatchNorm,
    _SyncBatchNorm,
    bind_data_group,
)

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def groups():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL has no CPU mode")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    try:
        yield tdist.group.WORLD, tdist.new_group([0], backend="gloo")
    finally:
        tdist.destroy_process_group()


def _case(device, seed=0, shape=(6, 24, 7, 7)):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 3 + 1).to(device)
    cot = torch.randn(shape, generator=gen).to(device)
    return (x.contiguous(memory_format=torch.channels_last), cot,
            torch.rand(shape[1], generator=gen).to(device) + 0.5,
            torch.randn(shape[1], generator=gen).to(device))


def _run(x, cot, w, b, group=None):
    norm = BatchNorm(x.shape[1], momentum=0.9, device=x.device)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    bind_data_group(norm, group)
    x = x.clone().requires_grad_()
    y = norm(x)
    (y * cot).sum().backward()
    return [y.detach(), x.grad, norm.weight.grad, norm.bias.grad,
            norm.running_mean, norm.running_var]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_of_one_is_the_plain_call_bitwise(groups, dtype):
    nccl, _ = groups
    x, cot, w, b = _case("cuda")
    x = x.to(dtype)
    for got, want in zip(_run(x, cot, w, b, nccl), _run(x, cot, w, b)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_sync_math_on_the_card_matches_the_cpu(groups):
    nccl, gloo = groups
    outs = []
    for device, group in (("cuda", nccl), ("cpu", gloo)):
        x, cot, w, b = _case(device)
        x = x.clone().requires_grad_()
        wp = w.clone().requires_grad_()
        bp = b.clone().requires_grad_()
        y, mean, var = _SyncBatchNorm.apply(x, wp, bp, group)
        (y * cot).sum().backward()
        outs.append([t.detach().cpu() for t in (y, mean, var, x.grad,
                                                 wp.grad, bp.grad)])
    for card, cpu in zip(*outs):
        torch.testing.assert_close(card, cpu, rtol=1e-5, atol=1e-5)
    native = _run(*_case("cuda"))
    for sync, plain in zip((outs[0][0], outs[0][3], outs[0][4], outs[0][5]),
                           native[:4]):
        torch.testing.assert_close(sync, plain.cpu(), rtol=1e-5, atol=1e-5)
