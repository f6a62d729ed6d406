"""Sequence parallelism of the port (`mesh` with a `seq` axis in Llama,
GPT and ViT over a mirrored strategy, `parallel/base.py`) against the
JAX package on the CPU.

One 2-process and one 4-process gloo cluster (`tests/_torch_sp_child.py
sp`, one deadline each that kills the survivors) train each leg from the
JAX initial weights, while the JAX single-device `Trainer` runs the same
steps in this process (attention `"reference"`, the global sequence):

- 2 processes (data 1 x seq 2): a ring GPT (learned positions sliced), a
  ring-flash GQA Llama with `remat="dots"` (the ring runs again in the
  recompute) under clipped Adam for 2 steps (then saved: the save
  restores into one process bitwise);
- 4 processes: `dryrun_multichip` shape 2 (data 2 x seq 2 ring-flash
  ViT: the head's token mean a sum over `seq`) and shape 9 (a ring-flash
  GQA sliding-window Llama at seq 4, S 64: the band skips a rotation).

Each leg: the loss within 1e-5 relative, the gradient norm within 1e-4
relative, every parameter within 2e-5 (2·lr·steps for Adam). The mesh's
coordinates equal JAX's, the refusals that stay (a `seq` axis beside
`model`, `expert` or `stage`, routed blocks under it, decoding with a
mesh) name ROADMAP.md queue 1 item 7. (A one-process mesh's ring models
against the JAX models: tests/test_torch_gpt.py, test_torch_vit.py and
test_torch_repairs.py.)
"""

import os

import jax
import numpy as np
import pytest
import torch

from _torch_cluster import REPO, Cluster
from _torch_sp_child import CLIP, LR, SP_LEGS, lm_keys, sp_batch
from pddl_tpu.core.mesh import MeshConfig as JaxMeshConfig
from pddl_tpu.core.mesh import build_mesh as jax_build_mesh
from pddl_tpu.models.gpt import GPT as JaxGPT
from pddl_tpu.models.llama import Llama as JaxLlama
from pddl_tpu.models.vit import ViT as JaxViT
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu.train.state import make_optimizer as jax_make_optimizer
from pddl_tpu_torch import bridge
from pddl_tpu_torch.ckpt import Checkpointer
from pddl_tpu_torch.ckpt.checkpoint import local_state
from pddl_tpu_torch.core import mesh as tmesh
from pddl_tpu_torch.models.gpt import GPT, decode_cache
from pddl_tpu_torch.models.llama import Llama
from pddl_tpu_torch.models.vit import ViT
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.state import make_optimizer

ITEM_7 = r"ROADMAP\.md queue 1 item 7"
JAX_FAMILY = {"llama": JaxLlama, "gpt": JaxGPT, "vit": JaxViT}
PORT = {"llama": (Llama, bridge.llama_params_from_jax,
                  bridge.llama_params_to_jax),
        "gpt": (GPT, bridge.gpt_params_from_jax, bridge.gpt_params_to_jax),
        "vit": (ViT, bridge.vit_params_from_jax, bridge.vit_params_to_jax)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _jax_kw(family, kw):
    kw = dict(kw, attention="reference")
    kw.pop("image_size", None)
    return kw


def _jax_trainer(leg):
    _, family, kw, _, _, opt, _, _, _ = SP_LEGS[leg]
    optimizer = opt
    if opt == "adam":
        optimizer = jax_make_optimizer("adam", LR["adam"],
                                       grad_clip_norm=CLIP)
    jtr = JaxTrainer(JAX_FAMILY[family](**_jax_kw(family, kw)),
                     optimizer=optimizer, learning_rate=LR[opt], seed=0,
                     log_grad_norm=True, **lm_keys(family))
    jtr.init_state(sp_batch(leg, 0))
    return jtr


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """The children's outputs (both clusters at once), and each leg's JAX
    run from the same weights (computed here while they run)."""
    work = tmp_path_factory.mktemp("sp")
    trainers = {leg: _jax_trainer(leg) for leg in SP_LEGS}
    init = {}
    for leg, jtr in trainers.items():
        params = jax.tree.map(np.asarray, jtr.state.params)
        init.update({f"{leg}:{k}": v for k, v in _flat(params).items()})
    np.savez(work / "init.npz", **init)
    script = os.path.join(REPO, "tests", "_torch_sp_child.py")
    clusters = []
    try:
        for world in (2, 4):
            clusters.append(Cluster(script, world, "sp", str(work)))
        runs = {}
        for leg, jtr in trainers.items():
            steps = SP_LEGS[leg][6]
            hist = jtr.fit(iter([sp_batch(leg, s) for s in range(steps)]),
                           epochs=steps, steps_per_epoch=1, verbose=0)
            runs[leg] = (hist.history,
                         jax.tree.map(np.asarray, jtr.state.params))
        outs = [o for c in clusters for o in c.wait(timeout=240)]
    finally:
        for c in clusters:
            c.kill()
    assert all("OK" in o for o in outs)
    return work, runs


def _port_meta(family, kw):
    cls = PORT[family][0]
    return cls(device="meta", **{k: v for k, v in kw.items()
                                 if k != "attention"})


@pytest.mark.parametrize("leg", sorted(SP_LEGS))
def test_sequence_parallel_step_matches_jax_single_device(legs, leg):
    work, runs = legs
    _, family, kw, data, seq, opt, steps, _, _ = SP_LEGS[leg]
    got = np.load(work / f"{leg}.npz")
    hist, want = runs[leg]
    np.testing.assert_allclose(got["log/loss"], hist["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["log/grad_norm"], hist["grad_norm"],
                               rtol=1e-4)
    sd = {k[len("param/"):]: torch.from_numpy(got[k]) for k in got.files
          if k.startswith("param/")}
    to_jax = PORT[family][2](_port_meta(family, kw), sd)
    bound = 2 * LR[opt] * steps if opt == "adam" else 2e-5
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=bound), to_jax, want)
    calls = dict(zip(got["count_names"], got["counts"][:, 0]))
    depth = kw.get("depth", 1)
    # One K/V hop a rotation beyond the diagonal, every layer, every step
    # (again in a remat recompute); shape 9's window skips the last of
    # its 4 rotations.
    rotations = 3 if leg == "shape9_llama" else seq
    recompute = 2 if kw.get("remat", "none") != "none" else 1
    assert calls["ring_kv_fwd"] == (rotations - 1) * depth * steps * recompute
    assert calls["ring_dkv_bwd"] == (rotations - 1) * depth * steps
    if family == "vit":
        assert calls["seq_sum_fwd"] == calls["seq_sum_bwd"] == steps


def test_sequence_parallel_save_restores_into_one_process(legs):
    work, _ = legs
    _, family, kw, _, _, opt, steps, _, _ = SP_LEGS["sp_llama_adam"]
    got = np.load(work / "sp_llama_adam.npz")
    ckpt = Checkpointer(str(work / "ckpt_sp_llama_adam"), read_only=True)
    assert ckpt.all_steps() == [steps]
    one = Trainer(Llama(device="cpu", **dict(kw, attention="flash",
                                             remat="none")),
                  optimizer=lambda ps: make_optimizer(
                      ps, "adam", LR["adam"], grad_clip_norm=CLIP),
                  device="cpu", **lm_keys(family))
    state, meta = ckpt.restore()
    one.load_state_dict(local_state(one, state, meta))
    for name, t in one.model.state_dict().items():
        assert torch.equal(t, torch.from_numpy(got[f"param/{name}"])), name


def test_mesh_coordinates_equal_jax_and_what_stays_refused():
    devices = np.asarray(jax.devices()[:8])
    for cfg in (dict(data=2, seq=4), dict(data=-1, model=2, stage=2),
                dict(data=2, stage=4)):
        jm = jax_build_mesh(JaxMeshConfig(**cfg), devices=devices)
        sizes = JaxMeshConfig(**cfg).axis_sizes(8)
        for rank in range(8):
            coords = tmesh.axis_coords(sizes, rank)
            idx = tuple(coords[a] for a in tmesh.CANONICAL_AXES)
            assert jm.devices[idx].id == devices[rank].id
    sizes = JaxMeshConfig(data=2, seq=2).axis_sizes(4)
    assert tmesh.axis_lines(sizes, "data+seq", range(4)) == [(0, 1, 2, 3)]
    assert tmesh.axis_lines(sizes, "seq", range(4)) == [(0, 1), (2, 3)]
    for beside in ("model", "expert", "stage"):
        with pytest.raises(NotImplementedError, match=ITEM_7):
            tmesh._check_axes(dict(JaxMeshConfig(seq=2, **{beside: 2})
                                   .axis_sizes(4)), False)
    mesh = _fake_seq_mesh(2)
    with pytest.raises(NotImplementedError, match=ITEM_7):
        Llama(vocab_size=16, device="meta", attention="ring", mesh=mesh,
              moe_experts=2)
    with pytest.raises(ValueError, match="use 'ring' or 'ring_flash'"):
        GPT(vocab_size=16, device="meta", attention="flash", mesh=mesh)
    with pytest.raises(ValueError, match="needs the mesh"):
        ViT(device="meta", attention="ring_flash")
    one = Llama(vocab_size=16, max_len=32, embed_dim=32, depth=1,
                num_heads=4, attention="ring", device="cpu",
                mesh=tmesh.build_mesh(device="cpu"))
    with pytest.raises(NotImplementedError, match=ITEM_7):
        one(torch.zeros((1, 4), dtype=torch.long), cache=decode_cache(one, 1),
            cache_index=0)


def _fake_seq_mesh(seq):
    sizes = {"data": 1, "model": 1, "seq": seq, "expert": 1, "stage": 1}
    return tmesh.Mesh(sizes, (0,), None, torch.device("cpu"))
