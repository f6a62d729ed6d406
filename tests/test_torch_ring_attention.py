"""The port's ring attention (`pddl_tpu_torch/ops/ring_attention.py`)
against the JAX package on the CPU.

One 2-process and one 4-process gloo cluster (`tests/_torch_sp_child.py
ring`, one deadline each) run `ring_attention`, `ring_attention_flash`
(the plain versions of K1/K2 per rotation on the CPU) and
`sequence_parallel_attention(use_flash=True)` on each case's sequence
shards, causal and not, MHA and GQA, windowed: at 2 processes a window of
20 over shards of 16 (normalized against the global 32, where the local
length would drop it), at 4 processes a window of 8 over shards of 8, so
`_band_hops` is 2 of 4. Meanwhile this process runs the JAX XLA ring
(`sequence_parallel_attention(use_flash=False)` on as many fake devices)
and the JAX reference on the global arrays. The gathered outputs are
within 1e-5 of both, the gradients of q, k and v within 1e-4 of their
max-abs, and a call's forward makes `_band_hops − 1` K/V hops (K and V in
one message): the out-of-band rotations make none.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cluster import REPO, Cluster
from _torch_sp_child import RING_CASES, RING_OPS, ring_inputs
from pddl_tpu.core.mesh import MeshConfig, build_mesh
from pddl_tpu.ops.attention import attention_reference
from pddl_tpu.ops.ring_attention import (
    _band_hops as jax_band_hops,
    sequence_parallel_attention,
)
from pddl_tpu_torch.ops.ring_attention import _band_hops

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _jax_runs(name):
    """(reference, XLA ring) outputs and q/k/v gradients for the case."""
    world, *_, causal, window = RING_CASES[name]
    x = {k: jnp.asarray(v) for k, v in ring_inputs(name).items()}
    mesh = build_mesh(MeshConfig(data=1, seq=world),
                      devices=jax.devices()[:world])

    def ref(q, k, v):
        return attention_reference(q, k, v, causal=causal, window=window)

    def ring(q, k, v):
        return sequence_parallel_attention(q, k, v, mesh, causal=causal,
                                           window=window, use_flash=False)

    out = {}
    for label, fn in (("ref", ref), ("xla_ring", ring)):
        def run(q, k, v, g, fn=fn):
            o, vjp = jax.vjp(fn, q, k, v)
            return (o, *vjp(g))

        got = jax.jit(run)(x["q"], x["k"], x["v"], x["g"])
        out[label] = [np.asarray(t) for t in got]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ring")
    script = os.path.join(REPO, "tests", "_torch_sp_child.py")
    clusters = []
    try:
        for world in (2, 4):
            clusters.append(Cluster(script, world, "ring", str(work)))
        want = {name: _jax_runs(name) for name in RING_CASES}
        outs = [o for c in clusters for o in c.wait(timeout=180)]
    finally:
        for c in clusters:
            c.kill()
    assert all("OK" in o for o in outs)
    return work, want


@pytest.mark.parametrize("op", RING_OPS)
@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_ops_match_the_jax_xla_ring_and_reference(runs, name, op):
    work, want = runs
    got = np.load(work / f"ring_{name}.npz")
    o, dq, dk, dv = (got[f"{op}/{k}"] for k in ("o", "dq", "dk", "dv"))
    for label in ("ref", "xla_ring"):
        w_o, w_dq, w_dk, w_dv = want[name][label]
        np.testing.assert_allclose(o, w_o, rtol=0, atol=1e-5)
        for g, w in ((dq, w_dq), (dk, w_dk), (dv, w_dv)):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())
    world, *_, s, _, causal, window = RING_CASES[name]
    hops = int(got["hops"])
    assert hops == jax_band_hops(world, s // world, window)
    # K and V travel together: one hop a rotation beyond the diagonal, at
    # most the 2·(hops − 1) K/V shifts of separate K and V.
    assert int(got[f"{op}/shifts_fwd"]) == hops - 1 <= 2 * (hops - 1)
    if name == "gqa_window8_band":
        assert hops == 2 < world


@pytest.mark.parametrize("world", [2, 4])
def test_ring_shift_is_differentiable(runs, world):
    """``collectives.ppermute_ring``: member i's x reaches i + 1 and the
    gradient goes back by −1 (JAX's ``ppermute`` and its transpose),
    one counted shift each way."""
    work, _ = runs
    got = np.load(work / f"ring_shift_{world}.npz")
    y, grad = got["got"][:, 0], got["got"][:, 1]
    for i in range(world):
        np.testing.assert_array_equal(y[i], (i - 1) % world)
        np.testing.assert_array_equal(grad[i], (i + 1) % world + 1)
    assert list(got["counts"]) == [1, 1]


def test_band_hops_is_the_jax_rule():
    for n in (1, 2, 4, 8):
        for s_local in (1, 8, 16, 100):
            for window in (None, 1, 7, 8, 24, 512):
                assert (_band_hops(n, s_local, window)
                        == jax_band_hops(n, s_local, window))
