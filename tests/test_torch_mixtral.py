"""Mixtral checkpoints in and out of the port's routed Llama
(`pddl_tpu_torch/ckpt/hf_import.py`, `hf_export.py`) against genuine
`transformers` and the JAX package on the CPU, f32 (the pattern of
`tests/test_llama.py`'s Mixtral tests).

- `load_hf_mixtral` of an in-code `MixtralForCausalLM` gives
  transformers' logits within 1e-5, dropless at eval also under a router
  biased so every token's top-2 is experts 0 and 1; the same refusals as
  the JAX importer (a dense model, the wrong `moe_top_k`, the wrong expert
  count, `moe_eval_dropless=False` with a capacity that can drop), and a
  saved directory loads offline.
- `export_hf_llama` of a routed Llama is byte-equal to the JAX export of
  the same weights, transformers loads it strictly, and export then
  `load_hf_mixtral` is the identity, bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from pddl_tpu.ckpt.hf_export import export_hf_llama as jax_export  # noqa: E402
from pddl_tpu.ckpt.hf_import import load_hf_mixtral as jax_load  # noqa: E402
from pddl_tpu.models.llama import Llama as JaxLlama  # noqa: E402
from pddl_tpu_torch.bridge import (  # noqa: E402
    llama_params_from_jax,
    llama_params_to_jax,
)
from pddl_tpu_torch.ckpt import export_hf_llama, load_hf_mixtral  # noqa: E402
from pddl_tpu_torch.models.llama import Llama  # noqa: E402

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

V, E, L, H = 61, 32, 2, 4


def _hf(**extra):
    cfg = transformers.MixtralConfig(
        vocab_size=V, hidden_size=E, intermediate_size=64,
        num_hidden_layers=L, num_attention_heads=H, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-6, rope_theta=10000.0,
        attention_dropout=0.0, tie_word_embeddings=False,
        num_local_experts=4, num_experts_per_tok=2, sliding_window=None,
        router_aux_loss_coef=0.0, **extra)
    torch.manual_seed(0)
    return transformers.MixtralForCausalLM(cfg).eval()


def _kw(**kw):
    base = dict(vocab_size=V, max_len=64, embed_dim=E, depth=L, num_heads=H,
                num_kv_heads=2, intermediate_dim=64, rms_eps=1e-6,
                attention="reference", moe_experts=4, moe_top_k=2)
    base.update(kw)
    return base


def _llama(**kw):
    return Llama(device="cpu", **_kw(**kw))


def _tokens():
    return np.random.default_rng(3).integers(0, V, (2, 17)).astype(np.int32)


def _logits(model, tokens):
    with torch.no_grad():
        if isinstance(model, Llama):
            return model(torch.from_numpy(tokens), train=False).numpy()
        return model(torch.from_numpy(tokens.astype(np.int64))).logits.numpy()


@pytest.fixture(scope="module")
def hf():
    return _hf()


def test_mixtral_logits_match_transformers(hf):
    ours = load_hf_mixtral(hf, _llama())
    np.testing.assert_allclose(_logits(ours, _tokens()),
                               _logits(hf, _tokens()), rtol=0, atol=1e-5)


def test_dropless_eval_under_a_biased_router(hf):
    biased = _hf()
    with torch.no_grad():
        for layer in biased.model.layers:
            gate = layer.block_sparse_moe.gate
            gate.weight.zero_()
            gate.weight[0, :] = 5.0
            gate.weight[1, :] = 4.0
    ours = load_hf_mixtral(biased, _llama(moe_capacity_factor=1.0))
    tokens = _tokens()
    np.testing.assert_allclose(_logits(ours, tokens), _logits(biased, tokens),
                               rtol=0, atol=1e-5)
    with torch.no_grad():
        train = ours(torch.from_numpy(tokens), train=True).numpy()
    assert not np.allclose(train, _logits(ours, tokens), atol=1e-3)


@pytest.mark.parametrize("kw,match", [
    (dict(moe_experts=0), "moe_experts"),
    (dict(moe_top_k=1), "num_experts_per_tok"),
    (dict(moe_experts=8), "experts"),
    (dict(moe_capacity_factor=1.0, moe_eval_dropless=False), "capacity"),
])
def test_refusals_are_the_jax_importers(hf, kw, match):
    tokens = jnp.asarray(_tokens())
    jm = JaxLlama(**_kw(**kw))
    v = jax.jit(lambda k: jm.init(k, tokens, train=False))(jax.random.key(0))
    with pytest.raises(ValueError, match=match):
        jax_load(hf, v, model=jm)
    with pytest.raises(ValueError, match=match):
        load_hf_mixtral(hf, _llama(**kw))


def test_saved_directory_loads_offline(hf, tmp_path, monkeypatch):
    hf.save_pretrained(str(tmp_path / "mixtral"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    by_path = load_hf_mixtral(str(tmp_path / "mixtral"), _llama())
    direct = load_hf_mixtral(hf, _llama())
    for k, t in direct.state_dict().items():
        assert torch.equal(t, by_path.state_dict()[k]), k
    with pytest.raises(TypeError, match="load_hf_mixtral\\(model_or_dir"):
        load_hf_mixtral(hf, {"params": {}})


def test_export_is_the_jax_exports_and_round_trips():
    hf = _hf()  # its weights are replaced below
    jm = JaxLlama(**_kw())
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init(
        k, jnp.asarray(_tokens()), train=False))(jax.random.key(7))["params"])
    ours = _llama()
    ours.load_state_dict(llama_params_from_jax(params))
    want = jax_export({"params": params}, model=jm)
    got = export_hf_llama(ours)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == \
            want[k].tobytes(), k
    missing, unexpected = hf.load_state_dict(
        {k: torch.from_numpy(v) for k, v in got.items()}, strict=True)
    assert not missing and not unexpected
    back = _llama(moe_capacity_factor=1.0)

    class Holder:
        def state_dict(self):
            return got

    load_hf_mixtral(Holder(), back)
    for k, t in ours.state_dict().items():
        if "router.bias" not in k:  # Mixtral's gate has no bias
            assert torch.equal(t, back.state_dict()[k]), k
    jax.tree.map(np.testing.assert_array_equal,
                 llama_params_to_jax(ours), params)
    np.testing.assert_allclose(_logits(back, _tokens()),
                               _logits(hf, _tokens()), rtol=0, atol=1e-5)
