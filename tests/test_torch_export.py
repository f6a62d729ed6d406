"""Serving artifacts on ``torch.export`` (``pddl_tpu_torch.ckpt.export``),
the counterparts of ``tests/test_checkpoint.py``'s StableHLO tests, on
the CPU:

- the inference artifact takes ``bridge.resnet_params_from_jax``'s output
  as it is, reproduces the eager forward and the JAX model's logits, and
  records its input shape; ``platforms`` is recorded and a device not
  listed is refused;
- the decode artifact reproduces ``generate()``'s tokens exactly, greedy
  and sampled (temperature with top-k and top-p) with the same seed, for
  GPT and Llama, a sliding-window Llama on its ring cache, and int8
  weights through ``dequantize``; its zip holds no weights (smaller than
  the weights it serves); its greedy tokens equal the JAX ``generate`` on
  the bridged weights in f32;
- K1's registered ops give ``torch.export`` its output shapes (meta
  tensors) and run no CPU kernel.
"""

import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddl_tpu.models.gpt import GPT as JaxGPT
from pddl_tpu.models.gpt import generate as jax_generate
from pddl_tpu.models.resnet import ResNet as JaxResNet
from pddl_tpu_torch.bridge import gpt_params_from_jax, resnet_params_from_jax
from pddl_tpu_torch.ckpt import (
    export_inference_fn,
    load_decode_artifact,
    load_inference_artifact,
    save_decode_artifact,
    save_inference_artifact,
)
from pddl_tpu_torch.models.gpt import GPT, generate, tiny_gpt
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.models.resnet import ResNet
from pddl_tpu_torch.ops.quant import dequantize, quantize_int8

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = "cpu"
RESNET = dict(stage_sizes=(1,), num_classes=8, width_multiplier=0.25,
              small_input_stem=True)


def _images(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _input_shapes(ep):
    user = set(ep.graph_signature.user_inputs)
    return [tuple(n.meta["val"].shape) for n in ep.graph.nodes
            if n.op == "placeholder" and n.name in user]


# -------------------------------------------------------------- inference
def test_inference_artifact_round_trip(tmp_path):
    """An artifact of a port ResNet given the bridged JAX weights as
    ``params`` (the port's names, straight from the bridge), saved and
    loaded: its logits are the eager port model's and the JAX model's, and
    it records its input shape."""
    jm = JaxResNet(**RESNET)
    x = _images((2, 16, 16, 3))
    v = jm.init(jax.random.key(0), jnp.asarray(x), train=False)
    bridged = resnet_params_from_jax(jax.tree.map(np.asarray, v["params"]),
                                     jax.tree.map(np.asarray,
                                                  v["batch_stats"]))
    model = ResNet(**RESNET, device=CPU, seed=5)
    path = str(tmp_path / "resnet.pt2")
    save_inference_artifact(path, model, bridged, (2, 16, 16, 3))
    call, exported = load_inference_artifact(path, device=CPU)
    got = call(torch.from_numpy(x)).numpy()
    model.load_state_dict(bridged)
    with torch.no_grad():
        eager = model(torch.from_numpy(x), train=False).numpy()
    np.testing.assert_allclose(got, eager, rtol=1e-6, atol=1e-6)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert _input_shapes(exported) == [(2, 16, 16, 3)]


def test_inference_artifact_platforms():
    model = ResNet(**RESNET, device=CPU, seed=0)
    both = export_inference_fn(model, None, (1, 8, 8, 3),
                               platforms=("cpu", "cuda"))
    call, exported = load_inference_artifact(both, device=CPU)
    assert call(torch.zeros(1, 8, 8, 3)).shape == (1, 8)
    with zipfile.ZipFile(io.BytesIO(both)) as z:
        name = next(n for n in z.namelist()
                    if n.endswith("pddl_manifest.json"))
        assert json.loads(z.read(name))["platforms"] == ["cpu", "cuda"]
    only_cpu = export_inference_fn(model, None, (1, 8, 8, 3))
    with pytest.raises(ValueError, match="platforms"):
        load_inference_artifact(only_cpu, device="cuda")
    with pytest.raises(ValueError, match="platforms"):
        export_inference_fn(model, None, (1, 8, 8, 3), platforms=("tpu",))


# ----------------------------------------------------------------- decode
def _run(path, params, prompt, seed=0):
    """Load an artifact and decode ``prompt``; ``seed`` as the JAX key
    data ``[0, seed]``."""
    prefill, decode, manifest = load_decode_artifact(path, device=CPU)
    cache, logits = prefill(params, prompt)
    return (decode(params, cache, logits, np.array([0, seed], np.uint32)),
            manifest)


def _decode(path, model, prompt, new, params=None, **kw):
    save_decode_artifact(path, model, params, batch=prompt.shape[0],
                         prompt_len=prompt.shape[1], max_new_tokens=new,
                         **kw)
    return _run(path, params if params is not None
                else dict(model.state_dict()), prompt)


def _want(model, prompt, new, seed=0, params=None, param_transform=None,
          **kw):
    gen = (torch.Generator().manual_seed(seed)
           if kw.get("temperature", 0) > 0 else None)
    variables = None if params is None else {"params": params}
    return generate(model, prompt, new, generator=gen, variables=variables,
                    param_transform=param_transform, **kw)[:, prompt.shape[1]:]


PROMPT = torch.arange(1, 17, dtype=torch.int32).reshape(2, 8)
# The GPT of the decode tests: tiny depth, widths whose weights (7.3 MB)
# dwarf the programs' graphs.
GPT_KW = dict(vocab_size=1024, max_len=64, embed_dim=256, depth=2,
              num_heads=4, attention="reference")
SAMPLED = dict(temperature=0.8, top_k=8, top_p=0.9)


@pytest.fixture(scope="module")
def gpt_artifacts(tmp_path_factory):
    """One greedy and one sampled artifact of one GPT, shared: params are
    call arguments, so other weights of the same shapes reuse them."""
    work = tmp_path_factory.mktemp("decode")
    model = GPT(**GPT_KW, device=CPU)
    out = {"model": model}
    for name, kw in (("greedy", {}), ("sampled", SAMPLED)):
        path = str(work / f"{name}.zip")
        save_decode_artifact(path, model, None, batch=2, prompt_len=8,
                             max_new_tokens=12, **kw)
        out[name] = path
    return out


@pytest.mark.parametrize("name", ["greedy", "sampled"])
def test_gpt_decode_artifact_equals_generate(gpt_artifacts, name):
    model = gpt_artifacts["model"]
    toks, manifest = _run(gpt_artifacts[name], dict(model.state_dict()),
                          PROMPT, seed=42)
    assert manifest["max_new_tokens"] == 12
    assert manifest["quantized_params"] is False
    assert toks.dtype == torch.int32
    kw = SAMPLED if name == "sampled" else {}
    assert torch.equal(toks, _want(model, PROMPT, 12, seed=42, **kw))


def test_decode_zip_holds_no_weights(gpt_artifacts):
    model = gpt_artifacts["model"]
    weights = sum(t.numel() * t.element_size()
                  for t in model.state_dict().values())
    path = gpt_artifacts["greedy"]
    size = os.path.getsize(path)
    assert size < weights / 2, (size, weights)
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["decode.pt2", "manifest.json",
                                        "prefill.pt2", "sample.pt2"]


def test_decode_artifact_equals_the_jax_generate(gpt_artifacts):
    """Bridged JAX weights through the same artifact: its greedy tokens
    are the JAX ``generate``'s (f32)."""
    jm = JaxGPT(**GPT_KW)
    v = jm.init(jax.random.key(0), jnp.asarray(PROMPT.numpy()))
    params = gpt_params_from_jax(jax.tree.map(np.asarray, v["params"]))
    toks, _ = _run(gpt_artifacts["greedy"], params, PROMPT)
    want = jax_generate(jm, v, jnp.asarray(PROMPT.numpy()), 12)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want)[:, 8:])


def test_llama_decode_artifact_equals_generate(tmp_path):
    """A GQA Llama with a sliding window, decoding on its ring cache
    (window 100, a ring of 128 under max_len 512; the GPT tests cover a
    full-length cache)."""
    model = tiny_llama(vocab_size=32, max_len=512, sliding_window=100,
                       device=CPU, seed=1)
    prompt = (torch.arange(20, dtype=torch.int32).reshape(2, 10) * 7) % 32
    toks, _ = _decode(str(tmp_path / "l.zip"), model, prompt, 10)
    assert torch.equal(toks, _want(model, prompt, 10))


def test_decode_positions_may_not_cross_the_ring_wrap(tmp_path):
    model = tiny_llama(vocab_size=32, max_len=512, sliding_window=100,
                       device=CPU)
    with pytest.raises(ValueError, match="wrap at 128"):
        save_decode_artifact(str(tmp_path / "x.zip"), model, None, batch=1,
                             prompt_len=120, max_new_tokens=20)


def test_int8_decode_artifact_equals_generate(tmp_path):
    model = tiny_gpt(vocab_size=32, max_len=64, device=CPU)
    q = quantize_int8(model, min_elems=128)
    prompt = torch.arange(8, dtype=torch.int32).reshape(2, 4) % 32
    toks, manifest = _decode(str(tmp_path / "q.zip"), model, prompt, 9,
                             params=q, param_transform=dequantize)
    assert manifest["quantized_params"] is True
    assert torch.equal(toks, _want(model, prompt, 9, params=q,
                                   param_transform=dequantize))


# -------------------------------------------------------------------- K1
def test_flash_forward_ops_have_fake_shapes():
    q = torch.empty(2, 8, 16, 32, device="meta")
    k = torch.empty(2, 2, 16, 32, device="meta")
    o, lse = torch.ops.pddl_tpu_torch.flash_fwd(q, k, k, True, 0.25, 0, 0)
    assert o.shape == q.shape and lse.shape == (2, 8, 16)
    assert lse.dtype == torch.float32
    o = torch.ops.pddl_tpu_torch.flash_fwd_nolse(q, k, k, True, 0.25, 4, 0)
    assert o.shape == q.shape
    with pytest.raises(NotImplementedError):
        torch.ops.pddl_tpu_torch.flash_fwd(torch.zeros(1, 2, 4, 8),
                                           torch.zeros(1, 2, 4, 8),
                                           torch.zeros(1, 2, 4, 8), True,
                                           1.0, 0, 0)
