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
  the JAX initial weights in ``WORKDIR/init.npz``; at 2 processes also
  the mesh-built models' decoding (:data:`DECODE_LEGS`, through
  ``generate()`` and a paged ``ServeEngine``), the routed FFN over the
  sequence shards (:data:`MOE_CASES`) and a ResNet whose BatchNorm
  reduces over the ``seq`` axis (``axis_name="seq"``, :func:`bn_inputs`);
  at 4 processes also the legs of :data:`MESH_LEGS`, a ``seq`` axis
  beside ``model``, ``expert`` and ``stage``, and meshes of chosen ranks
  and of each host's processes with axes beyond ``data``;
- ``pp``: the pipeline legs: at 2 processes the GPipe forward and
  gradients of :data:`PP_FWD`, a checkpointed Adam step and a wrapped
  update rule's save and ``fit(resume=)`` (:data:`PP_WRAPPED`), at 4 the
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
from pddl_tpu_torch.ckpt import Checkpointer, CheckpointEveryN
from pddl_tpu_torch.core import collectives, dist
from pddl_tpu_torch.core.mesh import MeshConfig, build_mesh
from pddl_tpu_torch.models.gpt import GPT, GPipeGPT, generate
from pddl_tpu_torch.models.layers import SeqShard
from pddl_tpu_torch.models.llama import GPipeLlama, Llama
from pddl_tpu_torch.models.resnet import BatchNorm, tiny_resnet
from pddl_tpu_torch.models.vit import GPipeViT, ViT
from pddl_tpu_torch.ops.moe import SwitchFFN
from pddl_tpu_torch.ops.ring_attention import (
    _band_hops,
    ring_attention,
    ring_attention_flash,
    sequence_parallel_attention,
)
from pddl_tpu_torch.parallel.mirrored import MirroredStrategy
from pddl_tpu_torch.parallel.pipeline import PipelineStrategy
from pddl_tpu_torch.parallel.tensor_parallel import (
    LLAMA_EP_RULES,
    LLAMA_TP_RULES,
    ExpertParallelStrategy,
    TensorParallelStrategy,
)
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.train.callbacks import Callback
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
    # A routed (MoE) ring Llama under seq 2: the routing over the whole
    # row, with capacity drops (top 2 of 4 experts at capacity factor 1).
    "sp_moe_llama": (2, "llama", dict(vocab_size=64, max_len=64,
                                      embed_dim=32, depth=2, num_heads=4,
                                      num_kv_heads=2, moe_experts=4,
                                      moe_top_k=2, moe_capacity_factor=1.0,
                                      attention="ring_flash"),
                     1, 2, "sgd", 1, 2, 32),
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


# Decoding a model built with a seq-2 mesh: (the SP leg whose weights it
# loads, prompt length, new tokens). Each process decodes the whole
# sequence.
DECODE_LEGS = {"sp_llama_adam": (8, 8), "sp_gpt": (8, 8)}
DECODE_BATCH = 2


def decode_prompts(leg):
    plen, _ = DECODE_LEGS[leg]
    vocab = SP_LEGS[leg][2]["vocab_size"]
    rng = np.random.default_rng(500 + sorted(DECODE_LEGS).index(leg))
    return rng.integers(0, vocab, (DECODE_BATCH, plen)).astype(np.int32)


def run_decode(work, mesh, me):
    out = {}
    for leg, (_, new) in DECODE_LEGS.items():
        _, family, kw, *_ = SP_LEGS[leg]
        cls, from_jax = {"llama": (Llama, bridge.llama_params_from_jax),
                         "gpt": (GPT, bridge.gpt_params_from_jax)}[family]
        model = cls(mesh=mesh, device="cpu",
                    **(dict(kw, remat="none") if family == "llama" else kw))
        model.load_state_dict(from_jax(leg_params(work, leg)))
        model.eval()
        prompts = decode_prompts(leg)
        with torch.no_grad():
            out[f"{leg}/generate"] = generate(model, prompts, new).numpy()
        eng = ServeEngine(model, device="cpu", max_slots=DECODE_BATCH,
                          prefill_len=16, paged=True)
        handles = [eng.submit(p.tolist(), new) for p in prompts]
        eng.run()
        out[f"{leg}/engine"] = np.array([h.tokens for h in handles])
    # Every process decodes the same tokens.
    every = collectives.all_gather(torch.from_numpy(np.concatenate(
        [v.reshape(-1) for _, v in sorted(out.items())])), None)
    out["same_on_every_process"] = np.array(bool((every == every[0]).all()))
    if me == 0:
        np.savez(os.path.join(work, "sp_decode.npz"), **out)


# The routed FFN over 2 sequence shards: (top_k, expert_act, capacity
# factor, train, router bias); inputs and weights from ``moe_inputs``.
MOE_CASES = {
    "top1_gelu_drops": (1, "gelu", 1.0, True, (2.0, 1.5, 0.0, 0.0)),
    "top2_swiglu_drops": (2, "swiglu", 1.0, True, (2.0, 1.5, 0.0, 0.0)),
    "top2_gelu_eval_dropless": (2, "gelu", 0.5, False, None),
}
MOE_B, MOE_S, MOE_E, MOE_N, MOE_H = 2, 16, 32, 4, 48


def moe_module(case, device="cpu"):
    top_k, act, cf, _, _ = MOE_CASES[case]
    return SwitchFFN(MOE_E, MOE_N, top_k=top_k, capacity_factor=cf,
                     expert_act=act,
                     hidden_dim=MOE_H if act == "swiglu" else None,
                     device=device)


def moe_inputs(case):
    """The case's input ``[B, S, E]`` and the module's weights (a seeded
    draw, the router's bias set to crowd experts 0 and 1)."""
    rng = np.random.default_rng(600 + sorted(MOE_CASES).index(case))
    x = rng.normal(size=(MOE_B, MOE_S, MOE_E)).astype(np.float32)
    tm = moe_module(case)
    tm.reset_parameters(torch.Generator().manual_seed(7))
    bias = MOE_CASES[case][4]
    if bias is not None:
        with torch.no_grad():
            tm.router.bias.copy_(torch.tensor(bias))
    return x, {k: v.detach().clone() for k, v in tm.state_dict().items()}


def run_moe(work, mesh, me):
    seq = SeqShard(mesh)
    out = {}
    for case, (top_k, _, _, train, _) in MOE_CASES.items():
        x, sd = moe_inputs(case)
        s = MOE_S // seq.n
        local = torch.from_numpy(x[:, me * s:(me + 1) * s].copy())
        tm = moe_module(case)
        tm.load_state_dict(sd)
        local.requires_grad_()
        y = tm(local, train, seq)
        aux = tm.sown["losses"]["moe_aux_loss"]
        drop = tm.sown["metrics"]["moe_drop_rate"]
        # A fixed cotangent: the input's gradient and the router's.
        g = torch.from_numpy(np.random.default_rng(1).normal(
            size=x.shape).astype(np.float32)[:, me * s:(me + 1) * s].copy())
        # Each shard carries 1/n of the whole-row aux loss: its gradient
        # comes back n-fold through seq_sum, so the shards sum to the
        # one-process gradient.
        ((y * g).sum() + aux / seq.n).backward()
        with torch.no_grad():
            r = tm.routing(local, train, seq)

        def whole(t):
            return collectives.all_gather(t.detach().contiguous(), None,
                                          axis=1, tiled=True).numpy()

        out[f"{case}/out"] = whole(y)
        out[f"{case}/dx"] = whole(local.grad)
        out[f"{case}/aux"] = aux.detach().numpy()
        out[f"{case}/drop"] = drop.detach().numpy()
        out[f"{case}/capacity"] = np.array(r.capacity)
        # The router weight's gradient summed over the shards (the batch
        # average of a 2-process run, times 2).
        out[f"{case}/drouter"] = collectives.psum(
            tm.router.weight.grad, None).numpy()
        for j in range(top_k):
            for key, t in (("expert", r.expert[j]), ("kept", r.kept[j]),
                           ("position", r.position[j]),
                           ("gate", r.gates[j])):
                out[f"{case}/{key}{j}"] = whole(t)
    if me == 0:
        np.savez(os.path.join(work, "sp_moe.npz"), **out)


# A tiny ResNet whose BatchNorm reduces over the seq axis: each of the 2
# processes holds half the rows.
BN_BATCH, BN_SEED = 4, 3


def bn_inputs():
    rng = np.random.default_rng(800)
    return (rng.normal(size=(BN_BATCH, 16, 16, 3)).astype(np.float32),
            rng.normal(size=(BN_BATCH, 10)).astype(np.float32))


def run_bn_axis(work, me):
    strat = MirroredStrategy(device="cpu", mesh_config=MeshConfig(
        data=1, seq=2))
    model = tiny_resnet(device="cpu", axis_name="seq", seed=BN_SEED)
    strat.bind(model)
    group = strat.mesh.axis_group("seq")
    bound = [m.sync_group is group for m in model.modules()
             if isinstance(m, BatchNorm)]
    rows = BN_BATCH // 2
    x, g = (torch.from_numpy(a[me * rows:(me + 1) * rows].copy())
            for a in bn_inputs())
    y = model(x, train=True)
    (y * g).sum().backward()
    out = {"bound": np.array(bound),
           "out": collectives.all_gather(y.detach(), group, tiled=True
                                         ).numpy()}
    out.update({f"buffer/{k}": v.numpy()
                for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))})
    out.update({f"grad/{k}": collectives.psum(p.grad, group).numpy()
                for k, p in model.named_parameters()})
    if me == 0:
        np.savez(os.path.join(work, "sp_bn_axis.npz"), **out)


# A seq axis of 2 beside another axis of 2 over 4 processes: (strategy,
# model options). Each leg trains one SGD step on ``sp_batch``'s rule
# (batch 2, S 32) from the JAX initial weights.
_MESH_LLAMA = dict(vocab_size=64, max_len=64, embed_dim=32, depth=2,
                   num_heads=4, num_kv_heads=2, attention="ring_flash")
MESH_LEGS = {
    "sp_tp_llama": ("tp", _MESH_LLAMA),
    "sp_ep_llama": ("ep", dict(_MESH_LLAMA, moe_experts=4, moe_top_k=2,
                               moe_capacity_factor=1.0)),
    "sp_pp_llama": ("pp", dict(vocab_size=64, embed_dim=32, num_heads=4,
                               num_kv_heads=2, n_stages=2,
                               blocks_per_stage=1, n_microbatches=2,
                               attention="ring_flash")),
}
MESH_BATCH, MESH_SEQ = 2, 32


def mesh_batch(leg):
    rng = np.random.default_rng(900 + sorted(MESH_LEGS).index(leg))
    x = rng.integers(0, 64, (MESH_BATCH, MESH_SEQ + 1)).astype(np.int32)
    return {"tokens": x[:, :-1], "targets": x[:, 1:]}


def mesh_strategy(kind):
    if kind == "tp":
        return TensorParallelStrategy(2, rules=LLAMA_TP_RULES, device="cpu",
                                      seq_parallel=2)
    if kind == "ep":
        return ExpertParallelStrategy(2, rules=LLAMA_EP_RULES, device="cpu",
                                      seq_parallel=2)
    return PipelineStrategy(2, device="cpu", seq_parallel=2)


def run_mesh_legs(work, me):
    for leg, (kind, kw) in MESH_LEGS.items():
        strat = mesh_strategy(kind)
        params = leg_params(work, leg)
        if kind == "pp":
            model = _port_gpipe("llama", kw, params, strat)
        else:
            model = Llama(mesh=strat.mesh, device="cpu", **kw)
            model.load_state_dict(bridge.llama_params_from_jax(params))
        tr = Trainer(model, optimizer="sgd", learning_rate=LR["sgd"],
                     strategy=strat, log_grad_norm=True, device="cpu",
                     input_key="tokens", target_key="targets")
        collectives.reset_tp_counts()
        logs = tr.train_step(mesh_batch(leg))
        out = {f"log/{k}": np.array([float(collectives.pmean(
            v, strat.batch_group))]) for k, v in logs.items()}
        out.update({f"param/{k}": v.numpy() for k, v in
                    strat.gather_state_dict(tr.model).items()})
        out["counts"] = np.array([[v[0], v[1]] for _, v in
                                  sorted(collectives.TP_COUNTS.items())])
        out["count_names"] = np.array(sorted(collectives.TP_COUNTS))
        out["coords"] = np.array([strat.mesh.axis_index(a) for a in
                                  ("data", "model", "seq", "expert",
                                   "stage")])
        every = collectives.all_gather(torch.from_numpy(out["coords"]),
                                       None)
        if me == 0:
            out["every_coords"] = every.numpy()
            np.savez(os.path.join(work, f"{leg}.npz"), **out)


def run_chosen_meshes(work, me):
    """Meshes of chosen ranks (each pair builds its own, members only)
    and of each host's processes (2 hosts of 2) with a seq axis."""
    pair = (0, 1) if me < 2 else (2, 3)
    chosen = build_mesh(MeshConfig(data=1, seq=2), ranks=pair,
                        device="cpu")
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        local = build_mesh(MeshConfig(data=1, seq=2, local_only=True),
                           device="cpu")
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    rows = []
    for mesh in (chosen, local):
        seq = mesh.axis_group("seq")
        got = collectives.all_gather(torch.tensor([float(me)]), seq)
        rows.append([mesh.axis_index("seq"), *mesh.axis_ranks["seq"],
                     *got.reshape(-1).long().tolist()])
    every = collectives.all_gather(torch.tensor(rows), None)
    if me == 0:
        np.savez(os.path.join(work, "chosen_meshes.npz"),
                 rows=every.numpy())


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
    if n == 2:
        mesh = build_mesh(MeshConfig(data=1, seq=2), device="cpu")
        run_decode(work, mesh, me)
        run_moe(work, mesh, me)
        run_bn_axis(work, me)
    if n == 4:
        run_mesh_legs(work, me)
        run_chosen_meshes(work, me)


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


# A wrapped update rule under the pipeline: bf16 parameters with f32
# masters, clipped Adam under a warmup-cosine schedule, accumulation over
# 2 micro-steps. Saved at step 3 (mid-window), then resumed to step 6.
PP_WRAPPED = dict(steps=6, save_at=3, lr=1e-2,
                  optimizer=dict(schedule="warmup_cosine",
                                 schedule_options=dict(warmup_steps=1,
                                                       decay_steps=8),
                                 grad_clip_norm=0.5),
                  trainer=dict(gradient_accumulation_steps=2,
                               param_update="f32_master"))


def pp_wrapped_trainer(model, strategy=None):
    """A scheduled, clipped Adam (a prebuilt chain) under the trainer's
    accumulation and ``f32_master`` rule."""
    def optimizer(ps):
        return make_optimizer(ps, "adam", PP_WRAPPED["lr"],
                              **PP_WRAPPED["optimizer"])
    return Trainer(model, optimizer=optimizer, learning_rate=PP_WRAPPED["lr"],
                   strategy=strategy, device="cpu", input_key="tokens",
                   target_key="targets", **PP_WRAPPED["trainer"])


def pp_wrapped_data():
    rng = np.random.default_rng(700)
    out = []
    for _ in range(PP_WRAPPED["steps"]):
        x = rng.integers(0, 64, (PP_BATCH, 17)).astype(np.int32)
        out.append({"tokens": x[:, :-1], "targets": x[:, 1:]})
    return out


def named_leaves(tree, path=""):
    """``{path: leaf}`` of nested dicts, lists and tuples (a dict's
    entries by key, whatever their insertion order)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(named_leaves(v, f"{path}/{k}"))
    return out


class StopAt(Callback):
    def __init__(self, step):
        self.at = step

    def on_train_batch_end(self, step, logs):
        if self.trainer.step >= self.at:
            self.trainer.stop_training = True


def run_pp_wrapped(work):
    """The uninterrupted run, and a run saved at ``save_at`` then
    resumed by a fresh trainer: both end bitwise equal."""
    def fit(callbacks=(), resume=None):
        strat = PipelineStrategy(2, device="cpu")
        model = _port_gpipe("llama", dict(pp_kw("llama", {}, 2),
                                          param_dtype=torch.bfloat16),
                            leg_params(work, "fwd_llama"), strat)
        tr = pp_wrapped_trainer(model, strat)
        tr.fit(pp_wrapped_data(), epochs=1,
               steps_per_epoch=PP_WRAPPED["steps"], callbacks=callbacks,
               resume=resume, verbose=0)
        return tr, strat

    clean, strat = fit()
    ckpt = os.path.join(work, "ckpt_pp_wrapped")
    saved, _ = fit([CheckpointEveryN(ckpt, every_n_steps=PP_WRAPPED["save_at"],
                                     async_save=False),
                    StopAt(PP_WRAPPED["save_at"])])
    at_save = strat.gather_state_dict(saved.model)
    resumed, _ = fit(resume=ckpt)

    def leaves(tr):
        return sorted(named_leaves((tr.model.state_dict(),
                                    tr.optimizer.state_dict())).items())

    same = [ka == kb and (bool(torch.equal(a, b))
                          if isinstance(a, torch.Tensor) else a == b)
            for (ka, a), (kb, b) in zip(leaves(clean), leaves(resumed),
                                        strict=True)]
    if dist.process_index() == 0:
        np.savez(os.path.join(work, "pp_wrapped.npz"),
                 resumed_equal=np.array(same), steps=np.array(
                     [saved.step, resumed.step, clean.step]),
                 **{f"save/{k}": v.float().numpy()
                    for k, v in at_save.items()})


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
        run_pp_wrapped(work)
    else:
        run_pp_legs(work)
    # Leave together: a process that exits while a peer's gloo pairs are
    # still open can abort it.
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"child {me} OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
