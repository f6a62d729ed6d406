"""The engine surface the fleet calls (`pddl_tpu_torch/serve/engine.py`),
on the CPU: ``warmup()`` leaves no trace, ``compile_counts()`` has the
JAX engine's keys per configuration and counts real input signatures,
and ``export_prefix_chain``/``import_prefix_chain`` move a cached chain
between the two packages' engines on bridged weights, both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu.serve.tenant import AdapterRegistry as JaxRegistry
from pddl_tpu.serve.tenant import TenantConfig as JaxTenantConfig
from pddl_tpu_torch.bridge import gpt_params_from_jax
from pddl_tpu_torch.models.gpt import tiny_gpt
from pddl_tpu_torch.serve import SamplingParams, ServeEngine
from pddl_tpu_torch.serve import drain as drain_io
from pddl_tpu_torch.serve.tenant import AdapterRegistry, TenantConfig

V, MAX_LEN = 32, 64


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny_gpt(vocab_size=V, max_len=MAX_LEN)
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    tm = tiny_gpt(vocab_size=V, max_len=MAX_LEN, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(jax.tree.map(np.asarray, params)))
    return {"jm": jm, "jv": {"params": params}, "tm": tm}


def _tenants():
    regs = {"jax": JaxRegistry(32, V, rank=4),
            "port": AdapterRegistry(32, V, rank=4)}
    for reg in regs.values():
        reg.register_random("acme", 1)
    return {"jax": dict(tenant=JaxTenantConfig(registry=regs["jax"])),
            "port": dict(tenant=TenantConfig(registry=regs["port"]))}


CONFIGS = {
    "row": dict(prefix_cache_blocks=0),
    "prefix": {},
    "paged": dict(paged=True),
    "tier_row": dict(host_tier=1 << 20),
    "tier_paged": dict(paged=True, host_tier=1 << 20),
    "spec_row": dict(spec_k=2),
    "spec_paged": dict(paged=True, spec_k=2),
    "tenant_row": "tenant",
    "tenant_paged": "tenant",
}


def _kw(name, pkg):
    kw = CONFIGS[name]
    if kw == "tenant":
        kw = dict(_tenants()[pkg], paged=name.endswith("paged"))
    return dict(max_slots=2, prefill_len=16, prefix_block_size=4, **kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_compile_counts_keys_match_jax_and_read_one_after_warmup(models,
                                                                 name):
    """The census has the JAX engine's keys in each configuration; every
    entry reads 1 after warmup and still 1 after a wave (shape-closed)."""
    jeng = JaxServeEngine(models["jm"], models["jv"], **_kw(name, "jax"))
    eng = ServeEngine(models["tm"], device="cpu", **_kw(name, "port"))
    assert set(eng.compile_counts()) == set(jeng.compile_counts())
    assert set(eng.compile_counts().values()) == {0}
    eng.warmup()
    assert set(eng.compile_counts().values()) == {1}
    kw = {"adapter": "acme"} if name.startswith("tenant") else {}
    hs = [eng.submit(list(range(1, 12)), 6, **kw),
          eng.submit(list(range(1, 9)) + [5, 5], 5)]
    eng.run(max_steps=100)
    assert all(len(h.tokens) == n for h, n in zip(hs, (6, 5)))
    assert set(eng.compile_counts().values()) == {1}, eng.compile_counts()


def test_a_new_input_shape_reads_two(models):
    """Feed the one-shot prefill a new padded width: its count reads 2,
    every other site stays at 1."""
    eng = ServeEngine(models["tm"], device="cpu", **_kw("row", "port"))
    eng.submit([1, 2, 3, 4, 5], 4)
    eng.run(max_steps=50)
    assert set(eng.compile_counts().values()) == {1}
    eng.prefill_len = 8  # the prefill now pads to [1, 8]
    eng.submit([6, 7, 8], 3)
    eng.run(max_steps=50)
    counts = eng.compile_counts()
    assert counts.pop("prefill") == 2
    assert set(counts.values()) == {1}


def _zero_beyond_scratch(tree) -> bool:
    return all(not leaf[1:].any() for blk in tree.values()
               for leaf in blk["attn"].values())


@pytest.mark.parametrize("mode", ["row", "paged"])
def test_warmup_leaves_no_trace_and_a_wave_bitwise_unchanged(models, mode):
    """A warmed engine's wave (greedy and sampled requests, shared
    prefixes) equals, tick for tick and token for token, that of an
    engine that never warmed; warmup itself touches no metric, slot,
    radix block or telemetry record, and writes nothing outside the
    scratch block of the pool."""
    kw = dict(max_slots=2, prefill_len=16, prefix_block_size=4,
              paged=mode == "paged", host_tier=1 << 20,
              clock=lambda: 0.0)
    warm = ServeEngine(models["tm"], device="cpu", **kw)
    cold = ServeEngine(models["tm"], device="cpu", **kw)
    fresh = cold.metrics.snapshot()
    warm.warmup()
    warm.warmup()  # idempotent
    assert warm.metrics.snapshot() == fresh
    assert warm._prefix.blocks_live == 0 and warm.live_slots == 0
    assert len(warm.telemetry.snapshot()) == 0
    pool = warm._cache if mode == "paged" else warm._pool
    assert _zero_beyond_scratch(pool)
    # Warmup records no autograd history in the caches it writes (a
    # cache holding a graph would keep every activation of it alive).
    for tree in (warm._cache, warm._row, warm._pool):
        for blk in (tree or {}).values():
            assert not any(leaf.requires_grad
                           for leaf in blk["attn"].values())
    cold._warm = True  # this engine never warms
    prompts = [list(range(1, 14)), list(range(1, 10)) + [7, 7],
               [3, 1, 4, 1, 5, 9, 2, 6]]
    sampling = [SamplingParams(), SamplingParams(),
                SamplingParams(temperature=0.9, top_k=8)]
    runs = {}
    for name, eng in (("warm", warm), ("cold", cold)):
        hs = [eng.submit(p, 6, sampling=s) for p, s in zip(prompts,
                                                           sampling)]
        ticks = []
        while eng.has_work:
            eng.step()
            ticks.append([list(h.tokens) for h in hs])
        runs[name] = ticks
    assert runs["warm"] == runs["cold"]
    assert all(len(t) == 6 for t in runs["warm"][-1])
    assert warm.metrics.snapshot() == cold.metrics.snapshot()


def _paged_tier(models, pkg):
    kw = dict(max_slots=2, prefill_len=32, prefix_block_size=4, paged=True,
              host_tier=1 << 20)
    if pkg == "jax":
        return JaxServeEngine(models["jm"], models["jv"], **kw)
    return ServeEngine(models["tm"], device="cpu", **kw)


def _serve(eng, prompt, n=6):
    h = eng.submit(prompt, n)
    eng.run(max_steps=100)
    return list(h.tokens)


def test_prefix_chains_import_both_ways(models):
    """A chain cached by the JAX engine imports into the port engine's
    host tier, and one cached by the port engine into the JAX engine's;
    the importer's next request for the prefix promotes it and streams
    the tokens a recompute gives. The chain entry is byte-equal whichever
    engine exported it."""
    rng = np.random.default_rng(0)
    shared = {k: rng.integers(0, V, 16).tolist() for k in ("a", "b")}
    tail = {k: [rng.integers(0, V, 5).tolist() for _ in range(2)]
            for k in shared}
    jeng = _paged_tier(models, "jax")
    peng = _paged_tier(models, "port")
    for k, eng in (("a", jeng), ("b", peng)):
        _serve(eng, shared[k] + tail[k][0])
    entries = {pkg: eng.export_prefix_chain(shared[k] + tail[k][1])
               for pkg, k, eng in (("jax", "a", jeng), ("port", "b", peng))}
    for entry in entries.values():
        assert entry is not None and len(entry["blocks"]) == 4
    # The port engine caching the same prompt exports the same chain:
    # the same tokens, leaf keys, shapes and dtypes, and K/V within f32
    # rounding of the JAX engine's.
    twin = _paged_tier(models, "port")
    _serve(twin, shared["a"] + tail["a"][0])
    mine = drain_io.kv_chain_from_wire(
        twin.export_prefix_chain(shared["a"] + tail["a"][1]))
    theirs = drain_io.kv_chain_from_wire(entries["jax"])
    assert mine[0] == theirs[0]
    for a, b in zip(mine[1], theirs[1]):
        assert list(a) == list(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            torch.testing.assert_close(a[key], b[key], rtol=1e-5,
                                       atol=1e-5)
    assert peng.import_prefix_chain(entries["jax"]) == 4
    assert jeng.import_prefix_chain(entries["port"]) == 4
    before = {"jax": jeng.metrics.snapshot()["host_tier_promotions"],
              "port": peng.metrics.snapshot()["host_tier_promotions"]}
    got = {"port": _serve(peng, shared["a"] + tail["a"][1]),
           "jax": _serve(jeng, shared["b"] + tail["b"][1])}
    assert peng.metrics.snapshot()["host_tier_promotions"] > before["port"]
    assert jeng.metrics.snapshot()["host_tier_promotions"] > before["jax"]
    recompute = ServeEngine(models["tm"], device="cpu", max_slots=2,
                            prefill_len=32, prefix_block_size=4, paged=True)
    assert got["port"] == _serve(recompute, shared["a"] + tail["a"][1])
    assert got["jax"] == _serve(recompute, shared["b"] + tail["b"][1])
    assert set(peng.compile_counts().values()) == {1}
    # Refusals: the tier off, and a chain of another configuration.
    assert recompute.export_prefix_chain(shared["a"]) is None
    assert recompute.import_prefix_chain(entries["jax"]) == 0
    other = ServeEngine(tiny_gpt(vocab_size=V, max_len=MAX_LEN, depth=1,
                                 device="cpu"), device="cpu", max_slots=2,
                        prefill_len=32, prefix_block_size=4, paged=True,
                        host_tier=1 << 20)
    assert other.import_prefix_chain(entries["jax"]) == 0
