"""One process of the gloo clusters of tests/test_torch_ring_attention.py,
tests/test_torch_sequence_parallel.py and tests/test_torch_pipeline.py
(not a test file). Imports only the port, never jax.

Run as ``python _torch_sp_child.py MODE WORKDIR`` with the ``PDDL_*``
bootstrap set; the world size picks the legs of MODE:

- ``ring``: the port's three ring ops on :data:`RING_CASES` (inputs from
  :func:`ring_inputs`): each process takes its sequence shard, and rank 0
  writes the gathered outputs, gradients and shift counts; then
  ``collectives.ppermute_ring`` forward and backward;
- ``sp``: the sequence-parallel training legs of :data:`SP_LEGS` from
  the JAX initial weights in ``WORKDIR/init.npz``;
- ``pp``: the pipeline legs: at 2 processes the GPipe forward and
  gradients of :data:`PP_FWD` and a checkpointed Adam step, at 4 the
  training legs of :data:`PP_LEGS` (and whether the replicated embed
  and head are equal on every process).

Rank 0 writes ``WORKDIR/{leg}.npz``; every process prints ``child {rank}
OK``.
"""

import os
import sys

import numpy as np
import torch

from pddl_tpu_torch import bridge
from pddl_tpu_torch.ckpt import Checkpointer
from pddl_tpu_torch.core import collectives, dist
from pddl_tpu_torch.core.mesh import MeshConfig, build_mesh
from pddl_tpu_torch.models.gpt import GPT, GPipeGPT
from pddl_tpu_torch.models.llama import GPipeLlama, Llama
from pddl_tpu_torch.models.vit import GPipeViT, ViT
from pddl_tpu_torch.ops.ring_attention import (
    _band_hops,
    ring_attention,
    ring_attention_flash,
    sequence_parallel_attention,
)
from pddl_tpu_torch.parallel.mirrored import MirroredStrategy
from pddl_tpu_torch.parallel.pipeline import PipelineStrategy
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.state import make_optimizer

# ---------------------------------------------------------------- ring ops
# name: (world, B, H, H_kv, S, D, causal, window)
RING_CASES = {
    "mha": (2, 2, 4, 4, 32, 8, False, None),
    "gqa_causal": (2, 2, 4, 2, 32, 8, True, None),
    "gqa_window20": (2, 1, 4, 2, 32, 8, True, 20),
    "mha_causal4": (4, 1, 4, 4, 32, 8, True, None),
    "gqa4": (4, 2, 4, 2, 32, 8, False, None),
    "gqa_window8_band": (4, 2, 4, 2, 32, 8, True, 8),
}
RING_OPS = ("ring", "ring_flash", "sequence_parallel")


def ring_inputs(name):
    _, b, h, hkv, s, d, _, _ = RING_CASES[name]
    rng = np.random.default_rng(sorted(RING_CASES).index(name))
    return {k: rng.normal(size=shape).astype(np.float32) for k, shape in (
        ("q", (b, h, s, d)), ("k", (b, hkv, s, d)), ("v", (b, hkv, s, d)),
        ("g", (b, h, s, d)))}


def run_ring(work, n, me):
    mesh = build_mesh(MeshConfig(data=1, seq=n), device="cpu")
    for name, (world, *_, causal, window) in RING_CASES.items():
        if world != n:
            continue
        x = ring_inputs(name)
        s = x["q"].shape[2] // n

        def local(a):
            return torch.from_numpy(a[:, :, me * s:(me + 1) * s].copy())

        out = {}
        for op in RING_OPS:
            q, k, v = (local(x[t]).requires_grad_() for t in "qkv")
            collectives.reset_tp_counts()
            kw = dict(causal=causal, window=window)
            if op == "sequence_parallel":
                o = sequence_parallel_attention(q, k, v, mesh, use_flash=True,
                                                **kw)
            else:
                fn = ring_attention if op == "ring" else ring_attention_flash
                o = fn(q, k, v, None, **kw)
            fwd = dict(collectives.TP_COUNTS)
            (o * local(x["g"])).sum().backward()
            for key, t in (("o", o), ("dq", q.grad), ("dk", k.grad),
                           ("dv", v.grad)):
                out[f"{op}/{key}"] = collectives.all_gather(
                    t.detach().contiguous(), None, axis=2, tiled=True).numpy()
            out[f"{op}/shifts_fwd"] = np.array(fwd.get("ring_kv_fwd",
                                                       [0, 0])[0])
        out["hops"] = np.array(_band_hops(n, s, window))
        if me == 0:
            np.savez(os.path.join(work, f"ring_{name}.npz"), **out)
    # The differentiable shift: member i's x to i + 1, the gradient back.
    x = torch.full((3,), float(me), requires_grad=True)
    collectives.reset_tp_counts()
    y = collectives.ppermute_ring(x, None, shift=1)
    (y * (me + 1)).sum().backward()
    got = collectives.all_gather(torch.stack([y.detach(), x.grad]), None)
    if me == 0:
        np.savez(os.path.join(work, f"ring_shift_{n}.npz"), got=got.numpy(),
                 counts=np.array([collectives.TP_COUNTS[k][0] for k in
                                  ("ppermute_ring_fwd", "ppermute_ring_bwd")]))


# ------------------------------------------------------ sequence parallel
# leg: (world, family, model options, data, seq, optimizer, steps, batch,
#       sequence length)
SP_LEGS = {
    "sp_gpt": (2, "gpt", dict(vocab_size=64, max_len=64, embed_dim=32,
                              depth=2, num_heads=4, attention="ring"),
               1, 2, "sgd", 1, 2, 32),
    "sp_llama_adam": (2, "llama", dict(vocab_size=64, max_len=64,
                                       embed_dim=32, depth=2, num_heads=4,
                                       num_kv_heads=2, remat="dots",
                                       attention="ring_flash"),
                      1, 2, "adam", 2, 2, 32),
    # dryrun_multichip shape 2: DP x SP ring-flash ViT (64 tokens).
    "shape2_vit": (4, "vit", dict(patch_size=4, embed_dim=32, depth=1,
                                  num_heads=4, num_classes=100,
                                  image_size=32, attention="ring_flash"),
                   2, 2, "sgd", 1, 4, None),
    # shape 9: ring GQA SWA Llama; at seq 4 and S 64 the band skips a
    # rotation (_band_hops 3 of 4).
    "shape9_llama": (4, "llama", dict(vocab_size=16, max_len=64,
                                      embed_dim=32, depth=1, num_heads=4,
                                      num_kv_heads=2, sliding_window=24,
                                      attention="ring_flash"),
                     1, 4, "sgd", 1, 2, 64),
}
LR = {"sgd": 0.1, "adam": 5e-6}
CLIP = 0.5


def sp_batch(leg, step):
    """The leg's batch at ``step`` (the same for both packages)."""
    _, family, kw, _, _, _, _, batch, seq = SP_LEGS[leg]
    rng = np.random.default_rng(200 + 10 * sorted(SP_LEGS).index(leg) + step)
    if family == "vit":
        return {"image": rng.normal(size=(batch, 32, 32, 3)).astype(
                    np.float32),
                "label": rng.integers(0, kw["num_classes"], batch).astype(
                    np.int32)}
    x = rng.integers(0, kw["vocab_size"], (batch, seq + 1)).astype(np.int32)
    return {"tokens": x[:, :-1], "targets": x[:, 1:]}


def lm_keys(family):
    return ({} if family == "vit"
            else dict(input_key="tokens", target_key="targets"))


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def leg_params(work, leg):
    init = np.load(os.path.join(work, "init.npz"))
    return unflatten({k.split(":", 1)[1]: init[k] for k in init.files
                      if k.startswith(leg + ":")})


def sp_optimizer(opt):
    if opt == "adam":
        def optimizer(ps):
            return make_optimizer(ps, "adam", LR["adam"], grad_clip_norm=CLIP)
        return optimizer
    return opt


def run_sp(work, n, me):
    for leg, (world, family, kw, data, seq, opt, steps, _, _) in \
            SP_LEGS.items():
        if world != n:
            continue
        strat = MirroredStrategy(device="cpu", mesh_config=MeshConfig(
            data=data, seq=seq))
        params = leg_params(work, leg)
        cls, from_jax = {"llama": (Llama, bridge.llama_params_from_jax),
                         "gpt": (GPT, bridge.gpt_params_from_jax),
                         "vit": (ViT, bridge.vit_params_from_jax)}[family]
        model = cls(mesh=strat.mesh, device="cpu", **kw)
        model.load_state_dict(from_jax(params))
        tr = Trainer(model, optimizer=sp_optimizer(opt),
                     learning_rate=LR[opt], strategy=strat,
                     log_grad_norm=True, device="cpu", **lm_keys(family))
        collectives.reset_tp_counts()
        logs = [tr.train_step(sp_batch(leg, s)) for s in range(steps)]
        # The logs of a step, averaged over the batch's processes.
        out = {f"log/{k}": np.array([float(collectives.pmean(
            d[k], strat.batch_group)) for d in logs]) for k in logs[0]}
        out.update({f"param/{k}": v.numpy()
                    for k, v in tr.model.state_dict().items()})
        out["counts"] = np.array([[v[0], v[1]] for _, v in
                                  sorted(collectives.TP_COUNTS.items())])
        out["count_names"] = np.array(sorted(collectives.TP_COUNTS))
        if opt == "adam":
            Checkpointer(os.path.join(work, f"ckpt_{leg}"),
                         async_save=False).save_trainer(tr)
        if me == 0:
            np.savez(os.path.join(work, f"{leg}.npz"), **out)


# --------------------------------------------------------------- pipeline
# The forward/gradient legs at stage 2: (family, options, microbatches,
# remat_stages).
PP_FWD = {
    "llama_m1": ("llama", {}, 1, False),
    "llama_m2": ("llama", {}, 2, False),
    "llama_m4": ("llama", {}, 4, False),
    "llama_m2_remat": ("llama", dict(remat_stages=True), 2, False),
    "gpt_m2": ("gpt", {}, 2, False),
    "vit_m2": ("vit", {}, 2, False),
}
PP_BATCH = 4


def pp_kw(family, extra, m):
    if family == "llama":
        kw = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2)
    elif family == "gpt":
        kw = dict(vocab_size=64, max_len=64, embed_dim=32, num_heads=4)
    else:
        kw = dict(patch_size=8, embed_dim=32, num_heads=4, num_classes=10)
    return dict(n_stages=2, blocks_per_stage=2, n_microbatches=m, **kw,
                **extra)


def pp_input(family, seed=0):
    """The forward legs' input and output cotangent."""
    rng = np.random.default_rng(300 + seed)
    if family == "vit":
        x = rng.normal(size=(PP_BATCH, 32, 32, 3)).astype(np.float32)
        g = rng.normal(size=(PP_BATCH, 10)).astype(np.float32)
    else:
        x = rng.integers(0, 64, (PP_BATCH, 16)).astype(np.int32)
        g = rng.normal(size=(PP_BATCH, 16, 64)).astype(np.float32)
    return x, g


PORT_GPIPE = {"llama": GPipeLlama, "gpt": GPipeGPT, "vit": GPipeViT}

# The training legs at 4 processes (dryrun_multichip shapes 5 and 7):
# (data, stage, model, patch, global batch).
PP_LEGS = {
    "shape5_vit": (2, 2, 1, 4, 8),
    "shape7_vit_3d": (1, 2, 2, 8, 4),
}
PP_LEG_KW = dict(n_stages=2, blocks_per_stage=1, n_microbatches=2,
                 embed_dim=32, num_heads=4, num_classes=100)
PP_ADAM = dict(family="llama", m=2, steps=1)


def pp_leg_batch(leg):
    batch = PP_LEGS[leg][4]
    rng = np.random.default_rng(400 + sorted(PP_LEGS).index(leg))
    return {"image": rng.normal(size=(batch, 32, 32, 3)).astype(np.float32),
            "label": rng.integers(0, 100, batch).astype(np.int32)}


def port_extra(family):
    """The port's GPipeViT is told the image size flax infers."""
    return dict(image_size=32) if family == "vit" else {}


def _port_gpipe(family, kw, params, strat):
    """Built on the strategy's mesh, the model holds its own stage only
    and loads that stage's slice of the JAX tree."""
    model = PORT_GPIPE[family](mesh=strat.mesh, device="cpu", **kw,
                               **port_extra(family))
    assert not model.is_whole
    model.load_state_dict(bridge.gpipe_params_from_jax(
        params, stage=model.stage_index))
    return model


def run_pp_forward(work):
    for leg, (family, extra, m, _) in PP_FWD.items():
        strat = PipelineStrategy(2, device="cpu")
        model = _port_gpipe(family, pp_kw(family, extra, m),
                            leg_params(work, "fwd_" + family), strat)
        strat.bind(model)
        x, g = pp_input(family)
        collectives.reset_tp_counts()
        out = model(torch.from_numpy(x).long() if family != "vit"
                    else torch.from_numpy(x))
        (out * torch.from_numpy(g)).sum().backward()
        strat.reduce_gradients(model)
        named = dict(model.named_parameters())
        whole = {}
        for name, p in named.items():
            whole.update(strat._whole(name, p.grad))
        res = {"out": out.detach().numpy()}
        res.update({f"grad/{k}": v.numpy() for k, v in whole.items()})
        res["counts"] = np.array([[v[0], v[1]] for _, v in
                                  sorted(collectives.TP_COUNTS.items())])
        res["count_names"] = np.array(sorted(collectives.TP_COUNTS))
        res["local_params"] = np.array(sum(p.numel() for p in named.values()))
        if dist.process_index() == 0:
            np.savez(os.path.join(work, f"pp_{leg}.npz"), **res)
    # A checkpointed Adam step.
    strat = PipelineStrategy(2, device="cpu")
    model = _port_gpipe("llama", pp_kw("llama", {}, PP_ADAM["m"]),
                        leg_params(work, "fwd_llama"), strat)
    x, _ = pp_input("llama", 1)
    tr = Trainer(model, optimizer="adam", learning_rate=1e-3, strategy=strat,
                 device="cpu", input_key="tokens", target_key="targets")
    tr.train_step({"tokens": x[:, :-1], "targets": x[:, 1:]})
    Checkpointer(os.path.join(work, "ckpt_pp"),
                 async_save=False).save_trainer(tr)
    whole = strat.gather_state_dict(tr.model)
    if dist.process_index() == 0:
        np.savez(os.path.join(work, "pp_adam.npz"),
                 **{k: v.numpy() for k, v in whole.items()})


def run_pp_legs(work):
    for leg, (data, stage, mp, patch, _) in PP_LEGS.items():
        strat = PipelineStrategy(stage, model_parallel=mp, device="cpu")
        assert strat.mesh.shape["data"] == data
        model = _port_gpipe("vit", dict(PP_LEG_KW, patch_size=patch),
                            leg_params(work, leg), strat)
        tr = Trainer(model, optimizer="sgd", learning_rate=LR["sgd"],
                     strategy=strat, log_grad_norm=True, device="cpu")
        collectives.reset_tp_counts()
        logs = tr.train_step(pp_leg_batch(leg))
        out = {f"log/{k}": np.array([float(collectives.pmean(
            v, strat.batch_group))]) for k, v in logs.items()}
        out.update({f"param/{k}": v.numpy() for k, v in
                    strat.gather_state_dict(tr.model).items()})
        out["counts"] = np.array([[v[0], v[1]] for _, v in
                                  sorted(collectives.TP_COUNTS.items())])
        out["count_names"] = np.array(sorted(collectives.TP_COUNTS))
        # The replicated embed and head, equal on every process.
        mine = torch.cat([p.detach().reshape(-1) for part in
                          (tr.model.embed, tr.model.head)
                          for p in part.parameters()])
        every = collectives.all_gather(mine, None)
        out["replicated_equal"] = np.array(bool(
            (every == every[0]).all()))
        if dist.process_index() == 0:
            np.savez(os.path.join(work, f"{leg}.npz"), **out)


def main(mode, work):
    torch.set_num_threads(1)
    dist.initialize(device="cpu")
    n, me = dist.process_count(), dist.process_index()
    if mode == "ring":
        run_ring(work, n, me)
    elif mode == "sp":
        run_sp(work, n, me)
    elif n == 2:
        run_pp_forward(work)
    else:
        run_pp_legs(work)
    # Leave together: a process that exits while a peer's gloo pairs are
    # still open can abort it.
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"child {me} OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
