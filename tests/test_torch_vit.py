"""The port's ViT (`pddl_tpu_torch/models/vit.py`) against the JAX ViT on
the CPU, through the weight bridge (f32):

- the forward within 1e-5 (rtol and atol) of JAX's, with
  `attention="reference"` and with `"flash"` (the JAX Pallas kernels
  interpreted, the port's plain versions; non-causal), and the features
  of a headless model; the bridge round trip exact (the patch embed's
  `[p, p, C, E]` kernel becomes `[E, C, p, p]` and back);
- the port's `Trainer` and the JAX `Trainer` on the same image batches
  (`SyntheticImageClassification`), 3 adam steps from the same weights:
  losses within rtol 1e-4, parameters within 2·lr·steps (Adam's
  sign-of-noise steps, as `tests/test_torch_resnet.py` holds them);
- the options once unported (ring attention, ``mesh``, Switch-MoE)
  give the JAX model's logits.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddl_tpu.data.synthetic import SyntheticImageClassification as JaxImages
from pddl_tpu.models.vit import tiny_vit as jax_tiny_vit
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu_torch.bridge import vit_params_from_jax, vit_params_to_jax
from pddl_tpu_torch.data.synthetic import SyntheticImageClassification
from pddl_tpu_torch.models.vit import tiny_vit
from pddl_tpu_torch.train.loop import Trainer

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _pair(**kw):
    jm = jax_tiny_vit(**kw)
    img = jnp.zeros((1, 32, 32, 3), jnp.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(2), img,
                                              train=False)["params"])
    tm = tiny_vit(device="cpu", **kw)
    tm.load_state_dict(vit_params_from_jax(params))
    return jm, params, tm


@pytest.mark.parametrize("kw", [dict(), dict(attention="flash"),
                                dict(num_classes=0, patch_size=4)],
                         ids=["reference", "flash", "features_p4"])
def test_forward_matches_jax_and_the_bridge_round_trips(kw):
    jm, params, tm = _pair(**kw)
    img = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    ref = jm.apply({"params": params}, jnp.asarray(img), train=False)
    with torch.no_grad():
        got = tm(torch.tensor(img), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    back = vit_params_to_jax(tm)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_three_adam_steps_match_jax_trainer():
    cfg = dict(batch_size=8, image_size=32, num_classes=10, seed=1)
    lr, steps = 1e-3, 3
    jm = jax_tiny_vit(attention="flash")
    jtr = JaxTrainer(jm, optimizer="adam", learning_rate=lr, seed=0)
    jtr.init_state(JaxImages(**cfg).batch(0))
    tm = tiny_vit(attention="flash", device="cpu")
    tm.load_state_dict(vit_params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params)))
    tr = Trainer(tm, optimizer="adam", learning_rate=lr, device="cpu")
    jh = jtr.fit(JaxImages(**cfg), epochs=steps, steps_per_epoch=1,
                 verbose=0)
    th = tr.fit(SyntheticImageClassification(**cfg), epochs=steps,
                steps_per_epoch=1, verbose=0)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=1e-4)
    want = jax.tree.map(np.asarray, jtr.state.params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=2 * lr * steps), vit_params_to_jax(tm), want)


@pytest.mark.parametrize("kw,item", [
    (dict(attention="ring_flash"), "item 7"),
    (dict(mesh="one process"), "item 7"), (dict(moe_experts=2), "item 5")])
def test_unported_options_raise(kw, item):
    """Ring attention and ``mesh`` (item 7) and Switch-MoE blocks (item 5)
    are ported: each ViT gives the JAX model's logits. The flash ring runs
    over a one-process mesh against the JAX XLA ring (the same function)
    over one device; a mesh whose seq axis is 1 leaves the attention as
    it is (tests/test_torch_sequence_parallel.py shards the tokens)."""
    if "moe_experts" in kw:
        jm, params, tm = _pair(**kw)
    else:
        from pddl_tpu.core.mesh import MeshConfig, build_mesh
        from pddl_tpu_torch.core.mesh import build_mesh as port_mesh

        jkw = dict(mesh=build_mesh(MeshConfig(data=1),
                                   devices=jax.devices()[:1]))
        tkw = dict(mesh=port_mesh(device="cpu"))
        if "attention" in kw:
            jkw["attention"], tkw["attention"] = "ring", kw["attention"]
        jm = jax_tiny_vit(**jkw)
        params = jax.tree.map(np.asarray, jm.init(
            jax.random.key(2), jnp.zeros((1, 32, 32, 3), jnp.float32),
            train=False)["params"])
        tm = tiny_vit(device="cpu", **tkw)
        tm.load_state_dict(vit_params_from_jax(params))
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(
        {"params": params}, jnp.asarray(x), train=False)), rtol=0,
        atol=1e-5)
