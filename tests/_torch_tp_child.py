"""One process of the two-process gloo cluster for
tests/test_torch_tensor_parallel.py (not a test file). Imports only the
port, never jax.

Run as ``python _torch_tp_child.py WORKDIR`` with the ``PDDL_*``
bootstrap set. ``WORKDIR/init.npz`` holds the JAX package's initial
weights of each leg's model (flat ``a/b/c`` keys); each leg bridges them
into the port's model, binds it under its strategy and takes one step
(two for the clipped-Adam leg) on the batches of :func:`batch`:

- ``tp_llama``: DP1 x TP2 ``tiny_llama`` (GQA 4/2), sgd;
- ``tp_vit``: DP1 x TP2 ``tiny_vit``, sgd;
- ``ep_llama``: DP1 x EP2 routed Llama (4 experts, top-2, capacity
  factor 1, so tokens drop), sgd;
- ``ep_vit``: DP1 x EP2 Switch ViT (4 experts, top-1), sgd;
- ``tp_adam``: the TP2 Llama under adam with ``grad_clip_norm``, 2 steps,
  then saved through ``Checkpointer.save_trainer`` (rank 0 writes);
- ``generate`` / ``generate_speculative`` at TP2 on ``tp_llama``'s
  initial weights.

Rank 0 writes each leg's logs and gathered parameters to
``WORKDIR/{leg}.npz`` and prints ``child {rank} OK``.
"""

import os
import sys

import numpy as np
import torch

from pddl_tpu_torch import bridge
from pddl_tpu_torch.ckpt import Checkpointer
from pddl_tpu_torch.core import collectives, dist
from pddl_tpu_torch.models.gpt import generate
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.models.speculative import generate_speculative
from pddl_tpu_torch.models.vit import tiny_vit
from pddl_tpu_torch.parallel.tensor_parallel import (
    LLAMA_EP_RULES,
    LLAMA_TP_RULES,
    VIT_EP_RULES,
    VIT_TP_RULES,
    ExpertParallelStrategy,
    TensorParallelStrategy,
)
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.state import make_optimizer

VOCAB, SEQ, BATCH = 64, 16, 4
LR = {"sgd": 0.1, "adam": 5e-6}
CLIP = 0.5
# Each leg: (family, model options, strategy kind, optimizer, steps).
LEGS = {
    "tp_llama": ("llama", {}, "tp", "sgd", 1),
    "tp_vit": ("vit", {}, "tp", "sgd", 1),
    "ep_llama": ("llama", dict(moe_experts=4, moe_top_k=2, moe_every=1,
                               moe_capacity_factor=1.0), "ep", "sgd", 1),
    "ep_vit": ("vit", dict(moe_experts=4, moe_top_k=1, moe_every=1),
               "ep", "sgd", 1),
    "tp_adam": ("llama", {}, "tp", "adam", 2),
}
PROMPT, NEW, DRAFT = 6, 10, 3


def model_kw(family, extra):
    if family == "llama":
        return dict(vocab_size=VOCAB, max_len=64, **extra)
    return dict(num_classes=10, **extra)


def batch(family, step):
    """The leg's batch at ``step`` (the same for both packages)."""
    rng = np.random.default_rng(100 + step)
    if family == "llama":
        x = rng.integers(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
        return {"tokens": x[:, :-1], "targets": x[:, 1:]}
    return {"image": rng.normal(size=(BATCH, 32, 32, 3)).astype(np.float32),
            "label": rng.integers(0, 10, BATCH).astype(np.int32)}


def prompt():
    return np.random.default_rng(7).integers(0, VOCAB, (2, PROMPT)).astype(
        np.int32)


def keys(family):
    return (dict(input_key="tokens", target_key="targets")
            if family == "llama" else {})


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def port_model(family, extra, params):
    if family == "llama":
        m = tiny_llama(device="cpu", **model_kw(family, extra))
        m.load_state_dict(bridge.llama_params_from_jax(params))
    else:
        m = tiny_vit(device="cpu", **model_kw(family, extra))
        m.load_state_dict(bridge.vit_params_from_jax(params))
    return m


def strategy(family, kind):
    rules = {("llama", "tp"): LLAMA_TP_RULES, ("vit", "tp"): VIT_TP_RULES,
             ("llama", "ep"): LLAMA_EP_RULES, ("vit", "ep"): VIT_EP_RULES}
    if kind == "tp":
        return TensorParallelStrategy(2, rules=rules[family, kind],
                                      device="cpu")
    return ExpertParallelStrategy(2, rules=rules[family, kind], device="cpu")


def run_leg(name, params, work):
    family, extra, kind, opt, steps = LEGS[name]
    model = port_model(family, extra, params)
    strat = strategy(family, kind)
    optimizer = opt
    if opt == "adam":
        def optimizer(ps):
            return make_optimizer(ps, "adam", LR["adam"],
                                  grad_clip_norm=CLIP)
    tr = Trainer(model, optimizer=optimizer, learning_rate=LR[opt],
                 strategy=strat, log_grad_norm=True, device="cpu",
                 **keys(family))
    collectives.reset_tp_counts()
    logs = [tr.train_step(batch(family, s)) for s in range(steps)]
    out = {f"log/{k}": np.array([float(d[k]) for d in logs])
           for k in logs[0]}
    out.update({f"param/{k}": v.numpy()
                for k, v in strat.gather_state_dict(tr.model).items()})
    out["counts"] = np.array([[v[0], v[1]] for _, v in
                              sorted(collectives.TP_COUNTS.items())])
    out["count_names"] = np.array(sorted(collectives.TP_COUNTS))
    out["local_bytes"] = np.array(sum(p.numel() * p.element_size()
                                      for p in tr.model.parameters()))
    if name == "tp_adam":
        Checkpointer(os.path.join(work, "ckpt"),
                     async_save=False).save_trainer(tr)
    if dist.process_index() == 0:
        np.savez(os.path.join(work, f"{name}.npz"), **out)


def run_generate(params, work):
    model = port_model("llama", {}, params)
    strat = strategy("llama", "tp")
    p = torch.as_tensor(prompt())
    tokens = generate(model, p, NEW, strategy=strat)
    spec = generate_speculative(model, p, NEW, draft_len=DRAFT,
                                strategy=strat)
    sharded = strat.shard_model(model)
    cache_heads = sharded.cache_kv_heads
    if dist.process_index() == 0:
        np.savez(os.path.join(work, "generate.npz"), tokens=tokens.numpy(),
                 spec=spec.numpy(), cache_heads=cache_heads,
                 whole_heads=model.num_kv_heads)


def main(work):
    torch.set_num_threads(1)
    dist.initialize(device="cpu")
    init = np.load(os.path.join(work, "init.npz"))
    by_leg = {}
    for key in init.files:
        leg, rest = key.split(":", 1)
        by_leg.setdefault(leg, {})[rest] = init[key]
    for name, (family, _, kind, _, _) in LEGS.items():
        run_leg(name, unflatten(by_leg[f"{family}_{kind}"]), work)
    run_generate(unflatten(by_leg["llama_tp"]), work)
    print(f"child {dist.process_index()} OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
