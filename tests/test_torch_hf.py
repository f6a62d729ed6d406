"""HuggingFace import and export of the port's LM families
(``pddl_tpu_torch.ckpt.hf_import`` / ``hf_export``) against genuine
``transformers`` models built from in-code configs (random init, no
network) and against the JAX package's importer and exporter.

- GPT-2 and Llama logits match ``transformers`` within the JAX tests'
  tolerances (2e-4 and 3e-4), a ``vocab_multiple``-padded model too;
- the port's import is bitwise the JAX import carried over
  ``bridge.*_params_from_jax`` (both start from the same bridged init, so
  padding rows agree as well);
- ``export_hf_llama`` is byte-equal to the JAX export of the same bridged
  weights and loads ``strict=True`` into ``LlamaForCausalLM`` and
  ``Qwen2ForCausalLM``; export then import is the identity, padding
  included;
- every refusal of the JAX importer with its text (``ln_eps``,
  ``rms_eps``, the sliding window, mixed layer types, q/k/v biases both
  ways, depth, positions), a Mistral with its window and a Qwen2 with
  its biases, a ``save_pretrained`` directory loaded by path with
  ``HF_HUB_OFFLINE=1``, a Mixtral refused naming ROADMAP.md queue 1
  item 5, and a JAX-form call refused with the port's form.

The ``transformers`` oracles are built once per module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from pddl_tpu.ckpt.hf_export import export_hf_llama as jax_export_hf_llama  # noqa: E402
from pddl_tpu.ckpt.hf_import import load_hf_gpt2 as jax_load_hf_gpt2  # noqa: E402
from pddl_tpu.ckpt.hf_import import load_hf_llama as jax_load_hf_llama  # noqa: E402
from pddl_tpu.models.gpt import GPT as JaxGPT  # noqa: E402
from pddl_tpu.models.llama import Llama as JaxLlama  # noqa: E402
from pddl_tpu_torch.bridge import (  # noqa: E402
    gpt_params_from_jax,
    llama_params_from_jax,
)
from pddl_tpu_torch.ckpt import (  # noqa: E402
    export_hf_llama,
    load_hf_gpt2,
    load_hf_llama,
)
from pddl_tpu_torch.models.gpt import GPT  # noqa: E402
from pddl_tpu_torch.models.llama import Llama  # noqa: E402

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# tests/test_hf_import.py's GPT-2 and tests/test_llama.py's Llama.
GV, GP, GE, GL, GH = 97, 64, 32, 2, 2
LV, LE, LL, LH = 61, 32, 2, 4
MIXTRAL_REFUSAL = r"moe_experts=config\.num_local_experts"


def _tokens(vocab, batch=2, seq=17, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq)
                                                ).astype(np.int32)


def _hf_logits(hf, tokens):
    with torch.no_grad():
        return hf(torch.from_numpy(tokens.astype(np.int64))).logits.numpy()


def _port_logits(model, tokens):
    with torch.no_grad():
        return model(torch.from_numpy(tokens), train=False).numpy()


def _hf_gpt2_model(vocab=GV):
    cfg = transformers.GPT2Config(
        vocab_size=vocab, n_positions=GP, n_embd=GE, n_layer=GL, n_head=GH,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _hf_llama_model(cls=None, kv_heads=2, **extra):
    cls = cls or transformers.LlamaForCausalLM
    cfg = cls.config_class(
        vocab_size=LV, hidden_size=LE, intermediate_size=64,
        num_hidden_layers=LL, num_attention_heads=LH,
        num_key_value_heads=kv_heads, max_position_embeddings=64,
        rms_norm_eps=1e-6, rope_theta=10000.0, attention_dropout=0.0,
        tie_word_embeddings=False, **extra)
    torch.manual_seed(0)
    return cls(cfg).eval()


@pytest.fixture(scope="module")
def hf():
    """Every oracle of the module, built once."""
    return {
        "gpt2": _hf_gpt2_model(),
        "llama": _hf_llama_model(),
        "mistral": _hf_llama_model(transformers.MistralForCausalLM,
                                   sliding_window=8),
        "qwen2": _hf_llama_model(transformers.Qwen2ForCausalLM),
        "qwen2_mixed": _hf_llama_model(
            transformers.Qwen2ForCausalLM, use_sliding_window=True,
            sliding_window=8, max_window_layers=1),
    }


def _gpt(**kw):
    kw.setdefault("ln_eps", 1e-5)
    return GPT(vocab_size=GV, max_len=GP, embed_dim=GE, depth=GL,
               num_heads=GH, attention="reference", device="cpu", **kw)


def _llama(**kw):
    kw.setdefault("rms_eps", 1e-6)
    return Llama(vocab_size=LV, max_len=64, embed_dim=LE, depth=LL,
                 num_heads=LH, num_kv_heads=2, intermediate_dim=64,
                 attention="reference", device="cpu", **kw)


def _jax_llama(**kw):
    kw.setdefault("rms_eps", 1e-6)
    return JaxLlama(vocab_size=LV, max_len=64, embed_dim=LE, depth=LL,
                    num_heads=LH, num_kv_heads=2, intermediate_dim=64,
                    attention="reference", **kw)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _assert_state_equal(a, b):
    a, b = dict(a), dict(b)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------------ GPT-2
@pytest.mark.parametrize("vocab_multiple", [1, 32], ids=["exact", "padded"])
def test_gpt2_logits_match_transformers(hf, vocab_multiple):
    ours = load_hf_gpt2(hf["gpt2"], _gpt(vocab_multiple=vocab_multiple))
    tokens = _tokens(GV)
    got = _port_logits(ours, tokens)
    assert got.shape[-1] == GV  # padding sliced away
    np.testing.assert_allclose(got, _hf_logits(hf["gpt2"], tokens),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("vocab_multiple", [1, 32], ids=["exact", "padded"])
def test_gpt2_import_is_bitwise_the_jax_import(hf, vocab_multiple):
    jm = JaxGPT(vocab_size=GV, max_len=GP, embed_dim=GE, depth=GL,
                num_heads=GH, attention="reference", ln_eps=1e-5,
                vocab_multiple=vocab_multiple)
    v = jm.init(jax.random.key(0), jnp.asarray(_tokens(GV)), train=False)
    want = gpt_params_from_jax(_np_tree(
        jax_load_hf_gpt2(hf["gpt2"], v, model=jm)["params"]))
    ours = _gpt(vocab_multiple=vocab_multiple)
    ours.load_state_dict(gpt_params_from_jax(_np_tree(v["params"])))
    load_hf_gpt2(hf["gpt2"], ours)
    _assert_state_equal(ours.state_dict(), want)


def test_gpt2_refusals(hf):
    with pytest.raises(ValueError, match="ln_eps"):
        load_hf_gpt2(hf["gpt2"], _gpt(ln_eps=1e-6))
    with pytest.raises(ValueError, match="ln_eps"):
        load_hf_gpt2(hf["gpt2"], _gpt(), expected_ln_eps=1e-6)
    with pytest.raises(ValueError, match="depths must match"):
        load_hf_gpt2(hf["gpt2"], GPT(vocab_size=GV, max_len=GP,
                                     embed_dim=GE, depth=GL + 1,
                                     num_heads=GH, ln_eps=1e-5,
                                     attention="reference", device="cpu"))
    with pytest.raises(ValueError, match="depths must match"):
        load_hf_gpt2(hf["gpt2"], GPT(vocab_size=GV, max_len=GP,
                                     embed_dim=GE, depth=1, num_heads=GH,
                                     ln_eps=1e-5, attention="reference",
                                     device="cpu"))
    with pytest.raises(ValueError, match="positions"):
        load_hf_gpt2(hf["gpt2"], GPT(vocab_size=GV, max_len=GP * 2,
                                     embed_dim=GE, depth=GL, num_heads=GH,
                                     ln_eps=1e-5, attention="reference",
                                     device="cpu"))
    # A checkpoint vocabulary LARGER than the model's: the shape error.
    with pytest.raises(ValueError, match="shape"):
        load_hf_gpt2(hf["gpt2"], GPT(vocab_size=GV - 10, max_len=GP,
                                     embed_dim=GE, depth=GL, num_heads=GH,
                                     ln_eps=1e-5, attention="reference",
                                     device="cpu"))
    # The JAX form ({"params": ...} second) names the port's.
    with pytest.raises(TypeError, match="load_hf_gpt2\\(model_or_dir, model"):
        load_hf_gpt2(hf["gpt2"], {"params": {}})


# ------------------------------------------------------------------ Llama
@pytest.mark.parametrize("vocab_multiple", [1, 32], ids=["exact", "padded"])
def test_llama_logits_match_transformers(hf, vocab_multiple):
    ours = load_hf_llama(hf["llama"], _llama(vocab_multiple=vocab_multiple))
    tokens = _tokens(LV, seq=24)
    np.testing.assert_allclose(_port_logits(ours, tokens),
                               _hf_logits(hf["llama"], tokens),
                               atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("kind", ["llama", "padded", "mistral", "qwen2"])
def test_llama_import_is_bitwise_the_jax_import(hf, kind):
    kw = {"padded": dict(vocab_multiple=32),
          "mistral": dict(sliding_window=8),
          "qwen2": dict(qkv_bias=True)}.get(kind, {})
    src = hf["llama" if kind == "padded" else kind]
    jm = _jax_llama(**kw)
    v = jm.init(jax.random.key(0), jnp.asarray(_tokens(LV)), train=False)
    want = llama_params_from_jax(_np_tree(
        jax_load_hf_llama(src, v, model=jm)["params"]))
    ours = _llama(**kw)
    ours.load_state_dict(llama_params_from_jax(_np_tree(v["params"])))
    load_hf_llama(src, ours)
    _assert_state_equal(ours.state_dict(), want)


@pytest.mark.parametrize("kind", ["mistral", "qwen2"])
def test_mistral_and_qwen2_logits_match_transformers(hf, kind):
    """A Mistral imports with its window (S 24 > window 8, so the window
    shapes the logits); a Qwen2 with its q/k/v biases."""
    kw = dict(sliding_window=8) if kind == "mistral" else dict(qkv_bias=True)
    ours = load_hf_llama(hf[kind], _llama(**kw))
    tokens = _tokens(LV, seq=24)
    np.testing.assert_allclose(_port_logits(ours, tokens),
                               _hf_logits(hf[kind], tokens),
                               atol=3e-4, rtol=3e-4)


def test_llama_refusals(hf):
    with pytest.raises(ValueError, match="rms_eps"):
        load_hf_llama(hf["llama"], _llama(rms_eps=1e-5))
    with pytest.raises(ValueError, match="rope_theta"):
        load_hf_llama(hf["llama"], _llama(rope_theta=500000.0))
    with pytest.raises(ValueError, match="rope_theta"):
        load_hf_llama(hf["llama"], _llama(), expected_rope_theta=5e5)
    with pytest.raises(ValueError, match="sliding_window"):
        load_hf_llama(hf["mistral"], _llama())
    with pytest.raises(ValueError, match="sliding_window"):
        load_hf_llama(hf["llama"], _llama(sliding_window=8))
    with pytest.raises(ValueError, match="per-layer attention types"):
        load_hf_llama(hf["qwen2_mixed"], _llama(qkv_bias=True))
    with pytest.raises(ValueError, match="qkv_bias=True"):
        load_hf_llama(hf["qwen2"], _llama())
    with pytest.raises(ValueError, match="qkv_bias=False"):
        load_hf_llama(hf["llama"], _llama(qkv_bias=True))
    with pytest.raises(ValueError, match="depths must match"):
        load_hf_llama(hf["llama"], Llama(
            vocab_size=LV, max_len=64, embed_dim=LE, depth=LL + 1,
            num_heads=LH, num_kv_heads=2, intermediate_dim=64,
            rms_eps=1e-6, attention="reference", device="cpu"))
    with pytest.raises(TypeError, match="load_hf_llama\\(model_or_dir, model"):
        load_hf_llama(hf["llama"], {"params": {}})


def test_mixtral_checkpoint_is_refused(hf):
    mixtral = _hf_llama_model(transformers.MixtralForCausalLM,
                              num_local_experts=4, num_experts_per_tok=2,
                              sliding_window=None, router_aux_loss_coef=0.0)
    # Routed experts are ported: a dense model still refuses a Mixtral
    # (the JAX importer's error), a routed one loads it
    # (tests/test_torch_mixtral.py holds it to transformers).
    with pytest.raises(ValueError, match=MIXTRAL_REFUSAL):
        load_hf_llama(mixtral, _llama())
    routed = load_hf_llama(mixtral, _llama(moe_experts=4, moe_top_k=2))
    np.testing.assert_allclose(_port_logits(routed, _tokens(LV)),
                               _hf_logits(mixtral, _tokens(LV)), rtol=0,
                               atol=1e-5)


def test_save_pretrained_directory_loads_offline(hf, tmp_path, monkeypatch):
    hf["llama"].save_pretrained(str(tmp_path / "llama"))
    hf["gpt2"].save_pretrained(str(tmp_path / "gpt2"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    by_path = load_hf_llama(str(tmp_path / "llama"), _llama())
    _assert_state_equal(by_path.state_dict(),
                        load_hf_llama(hf["llama"], _llama()).state_dict())
    by_path = load_hf_gpt2(str(tmp_path / "gpt2"), _gpt())
    _assert_state_equal(by_path.state_dict(),
                        load_hf_gpt2(hf["gpt2"], _gpt()).state_dict())


# ----------------------------------------------------------------- export
@pytest.mark.parametrize("kind", ["llama", "padded", "qwen2"])
def test_export_is_byte_equal_to_the_jax_export(kind):
    kw = {"padded": dict(vocab_multiple=32),
          "qwen2": dict(qkv_bias=True)}.get(kind, {})
    jm = _jax_llama(**kw)
    v = jm.init(jax.random.key(7), jnp.asarray(_tokens(LV)), train=False)
    want = jax_export_hf_llama(v, model=jm)
    ours = _llama(**kw)
    ours.load_state_dict(llama_params_from_jax(_np_tree(v["params"])))
    got = export_hf_llama(ours)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


@pytest.mark.parametrize("kind", ["llama", "qwen2"])
def test_export_loads_strictly_into_transformers(kind):
    cls = {"llama": transformers.LlamaForCausalLM,
           "qwen2": transformers.Qwen2ForCausalLM}[kind]
    ours = _llama(qkv_bias=kind == "qwen2", seed=7)
    sd = {k: torch.from_numpy(x) for k, x in export_hf_llama(ours).items()}
    target = _hf_llama_model(cls)
    missing, unexpected = target.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    tokens = _tokens(LV, seq=24)
    np.testing.assert_allclose(_hf_logits(target.eval(), tokens),
                               _port_logits(ours, tokens),
                               atol=3e-4, rtol=3e-4)


def test_export_then_import_is_the_identity_with_padding():
    """Padding rows are sliced off by ``vocab_size`` and kept by the
    importer; ``state_dict=`` exports a tree of the model's names (the
    trainer's EMA shadows)."""
    ours = _llama(vocab_multiple=32, seed=7)
    sd = export_hf_llama(ours)
    assert sd["model.embed_tokens.weight"].shape == (LV, LE)
    assert sd["lm_head.weight"].shape == (LV, LE)

    class Holder:
        def state_dict(self):
            return sd

    back = load_hf_llama(Holder(), _llama(vocab_multiple=32, seed=7))
    _assert_state_equal(back.state_dict(), ours.state_dict())
    shadows = {k: v * 2 for k, v in ours.state_dict().items()}
    doubled = export_hf_llama(ours, state_dict=shadows)
    np.testing.assert_array_equal(doubled["model.norm.weight"],
                                  2 * sd["model.norm.weight"])


def test_tied_llama_head_takes_the_embedding():
    """A checkpoint without ``lm_head.weight`` ties the head to the
    embedding (Llama-3.2-1B ties its embeddings)."""
    sd = export_hf_llama(_llama(seed=3))
    del sd["lm_head.weight"]

    class Holder:
        def state_dict(self):
            return sd

    tied = load_hf_llama(Holder(), _llama())
    np.testing.assert_array_equal(
        tied.state_dict()["head.lm_head.weight"].numpy(),
        sd["model.embed_tokens.weight"])
