"""Serving artifacts on ``torch.export`` (the port of
:mod:`pddl_tpu.ckpt.export`).

The reference's only deployable artifact is a Keras ``.h5``, which needs
the whole Python/TF stack to serve. The JAX package serializes the
compiled program itself (StableHLO); the port serializes the traced
program: ``torch.export`` captures the forward as an ATen graph with its
input shapes and dtypes recorded, and the artifact is the bytes of
``torch.export.save``.

**The inference artifact** (:func:`export_inference_fn`,
:func:`save_inference_artifact`, :func:`load_inference_artifact`): the
model's forward in eval mode (``train=False``) with its weights baked in.
``params`` and ``batch_stats`` take the port's ``state_dict`` names (so
:func:`~pddl_tpu_torch.bridge.resnet_params_from_jax`'s output goes
straight in), or ``None`` for the model's own. The artifact records its
platforms (``"cpu"``, ``"cuda"``; by default the exporting device's) and
the loader refuses a device not listed, as the JAX loader does; an
artifact exported on one device and listing another is moved there at
load (``torch.export.passes.move_to_device_pass``).

**The decode artifact** (:func:`export_decode_programs`,
:func:`save_decode_artifact`, :func:`load_decode_artifact`): one zip, as
the JAX package's, holding ``manifest.json`` (the JAX keys) and the
programs of ``generate()`` — ``prefill.pt2`` (``(params, prompt i32[B,
P]) -> (cache, logits)``, its zero cache built inside), ``decode.pt2``
and ``sample.pt2``. Parameters are call arguments, so new weights of the
same shapes reuse the artifact and the zip holds none; with
``param_transform=dequantize`` the arguments are the int8 and scale
leaves of :func:`~pddl_tpu_torch.ops.quant.quantize_int8` and the dequant
is inside the programs (``manifest["quantized_params"]``).

**The decode loop.** ``torch.export`` has no counterpart of the JAX
package's one ``lax.scan`` over the new tokens. So ``decode.pt2`` is ONE
step — the forward of the last token at its position, then the draw of
the next — and the loaded ``decode(params, cache, logits, key_data) ->
tokens i32[B, T]`` draws the first token with ``sample.pt2`` and calls
the step ``T - 1`` times. The step writes the cache it is given in
place, as the eager forward does. Its position enters as the length of a
zero-size ``[position, 0]`` input, a dimension the export keeps symbolic
over the artifact's positions ``[P, P + T - 2]``: every call then runs
exactly the eager step's operations at that position (the live prefix of
the cache, not the whole cache), so the tokens are bitwise
``generate()``'s. Sampling (temperature, top-k, top-p) is inside the
programs; its uniform noise ``[B, V]`` is an input, drawn in the loop
from a ``torch.Generator`` on the programs' device seeded from
``key_data`` (an int, or the JAX ``uint32[2]`` key data read as
``hi << 32 | lo``), so the draws are those of ``generate(...,
generator=torch.Generator(device).manual_seed(seed))``.

A sliding-window model's prefill on the card runs K1 with its LSE, which
is registered as the op ``pddl_tpu_torch::flash_fwd``
(:mod:`pddl_tpu_torch.ops.attention`): its exported program carries the
op, and loading it needs ``pddl_tpu_torch`` imported
(``manifest["needs_pddl_tpu_torch"]``). A ring-cache model's artifact
must keep its decode positions on one side of the ring's wrap (the
step's live prefix is the ring once it wrapped).
"""

from __future__ import annotations

import copy
import io
import json
import os
import zipfile
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.export import Dim, ExportedProgram

from pddl_tpu_torch.device import resolve_device
from pddl_tpu_torch.models.gpt import _last_logits, decode_cache, sample_logits
from pddl_tpu_torch.models.llama import ring_len
from pddl_tpu_torch.ops import attention  # noqa: F401 - registers K1's ops
from pddl_tpu_torch.ops.quant import _check_names

_MANIFEST = "pddl_manifest.json"  # the extra file of a saved program
_OP_NAMESPACE = "pddl_tpu_torch"


def _save_program(ep: ExportedProgram, manifest: dict) -> bytes:
    """The program's bytes without its example inputs (a decode
    program's would be the weights)."""
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={_MANIFEST: json.dumps(manifest)})
    return buf.getvalue()


def _needs_port(ep: ExportedProgram) -> bool:
    """Does the graph call an op this package registers (K1)?"""
    return any(getattr(node.target, "namespace", None) == _OP_NAMESPACE
               for node in ep.graph.nodes if node.op == "call_function")


def _load_program(data: bytes, device) -> Tuple[ExportedProgram, dict]:
    """Deserialize one program, refuse a device its platforms do not
    list, and move it there when it was exported elsewhere."""
    extra = {_MANIFEST: ""}
    ep = torch.export.load(io.BytesIO(data), extra_files=extra)
    manifest = json.loads(extra[_MANIFEST])
    kind = torch.device("cuda" if device is None else device).type
    platforms = manifest["platforms"]
    if kind not in platforms:
        raise ValueError(
            f"the artifact was exported for platforms {platforms}, not "
            f"{kind!r}: export it with platforms including {kind!r} to "
            "serve it there")
    dev = resolve_device(device)
    if manifest["device"] != dev.type:
        from torch.export.passes import move_to_device_pass  # noqa: PLC0415

        ep = move_to_device_pass(ep, dev)
    return ep, manifest


def _platforms(platforms: Optional[Sequence[str]], dev: torch.device):
    out = [dev.type] if not platforms else [str(p).lower()
                                            for p in platforms]
    for p in out:
        if p not in ("cpu", "cuda"):
            raise ValueError(f"platforms are 'cpu' and 'cuda', got {p!r}")
    if dev.type not in out:
        raise ValueError(f"platforms {out} leave out the exporting device "
                         f"{dev.type!r}")
    return out


class _Forward(nn.Module):
    def __init__(self, model: nn.Module, kwargs: dict):
        super().__init__()
        self.model = model
        self.kwargs = kwargs

    def forward(self, x):
        return self.model(x, **self.kwargs)


def export_inference_fn(model: nn.Module, params: Optional[Mapping],
                        input_shape: Sequence[int], *,
                        input_dtype: torch.dtype = torch.float32,
                        batch_stats: Optional[Mapping] = None,
                        apply_kwargs: Optional[dict] = None,
                        platforms: Optional[Sequence[str]] = None) -> bytes:
    """The model's eval forward with its weights baked in, as the bytes
    of ``torch.export.save``. ``input_shape`` includes the batch. The
    export runs on the model's device; ``platforms`` (default: that
    device's) lists where the artifact may be loaded (module
    docstring)."""
    dev = model.device
    frozen = copy.deepcopy(model).eval().requires_grad_(False)
    state = {**(params or {}), **(batch_stats or {})}
    if state:
        unknown = sorted(set(state) - set(frozen.state_dict()))
        if unknown:
            raise ValueError(f"params name no tensor of the model: "
                             f"{unknown[:4]}")
        frozen.load_state_dict(state, strict=False)
    kwargs = {"train": False, **(apply_kwargs or {})}
    x = torch.zeros(tuple(input_shape), dtype=input_dtype, device=dev)
    ep = torch.export.export(_Forward(frozen, kwargs), (x,), strict=False)
    return _save_program(ep, {"platforms": _platforms(platforms, dev),
                              "device": dev.type,
                              "needs_pddl_tpu_torch": _needs_port(ep)})


def _write_atomic(path: str, write: Callable[[str], None]) -> str:
    tmp = f"{path}.tmp.{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)
    return path


def save_inference_artifact(path: str, *args, **kwargs) -> str:
    """:func:`export_inference_fn` straight to a file (written beside it
    and renamed into place); returns ``path``."""
    data = export_inference_fn(*args, **kwargs)

    def write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)

    return _write_atomic(path, write)


def load_inference_artifact(path_or_bytes, device=None
                            ) -> Tuple[Callable, ExportedProgram]:
    """Deserialize an inference artifact onto ``device`` (``None``: the
    card); returns ``(call, exported)``: ``call(x)`` runs the program,
    ``exported`` is the ``ExportedProgram``, whose input spec records the
    shape."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    ep, _ = _load_program(data, device)
    module = ep.module()

    @torch.no_grad()
    def call(x):
        return module(x)

    return call, ep


# --------------------------------------------------------------- decode
class _Sample(nn.Module):
    """One draw over ``[B, V]`` logits: ``generate()``'s
    :func:`~pddl_tpu_torch.models.gpt.sample_logits`, its noise an
    input (``None`` when greedy)."""

    def __init__(self, temperature, top_k, top_p):
        super().__init__()
        self.kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)

    def forward(self, logits, noise):
        return sample_logits(None, logits, noise=noise,
                             **self.kw).to(torch.int32)


class _Prefill(nn.Module):
    def __init__(self, model, batch, prompt_len):
        super().__init__()
        self.m = model
        self.batch, self.prompt_len = batch, prompt_len

    def forward(self, prompt):
        cache = decode_cache(self.m, self.batch)
        return cache, _last_logits(self.m, prompt, self.prompt_len,
                                   cache=cache, cache_index=0)


class _Step(nn.Module):
    """Forward the last token at the position ``pos.shape[0]`` (writing
    the cache in place), then draw the next."""

    def __init__(self, model, sample):
        super().__init__()
        self.m = model
        self.sample = sample

    def forward(self, cache, tok, pos, noise):
        logits = _last_logits(self.m, tok[:, None], 1, cache=cache,
                              cache_index=pos.shape[0])
        return self.sample(logits, noise)


class _WithParams(nn.Module):
    """A program whose model's parameters are call arguments: the program
    is held outside the module tree, so no weight is lifted into the
    artifact, and ``torch.func.functional_call`` puts ``params`` (after
    ``transform``) in place of the model's own."""

    def __init__(self, program: nn.Module, transform: Optional[Callable]):
        super().__init__()
        object.__setattr__(self, "program", program)
        self.transform = transform

    def forward(self, params, *args):
        dense = self.transform(params) if self.transform else params
        return torch.func.functional_call(
            self.program, {f"m.{k}": v for k, v in dense.items()}, args)


def _static(tree):
    """``tree``'s dynamic-shape spec with every dimension static."""
    if isinstance(tree, Mapping):
        return {k: _static(v) for k, v in tree.items()}
    return None


def _seed(key_data) -> int:
    if isinstance(key_data, int):
        return key_data
    words = [int(w) for w in torch.as_tensor(key_data).reshape(-1).tolist()]
    if len(words) == 1:
        return words[0]
    hi, lo = words[-2:]
    return ((hi & 0xFFFFFFFF) << 32) | (lo & 0xFFFFFFFF)


def _check_ring(model, prompt_len: int, max_new_tokens: int) -> None:
    ring = ring_len(model.sliding_window, model.max_len)
    first, last = prompt_len, prompt_len + max_new_tokens - 2
    if ring is not None and max_new_tokens > 1 and first < ring <= last:
        raise ValueError(
            f"decode positions {first}..{last} cross the ring cache's wrap "
            f"at {ring}: export an artifact whose positions stay on one "
            "side of it")


@torch.no_grad()
def export_decode_programs(model: nn.Module, params: Optional[Mapping] = None,
                           *, batch: int, prompt_len: int,
                           max_new_tokens: int, temperature: float = 0.0,
                           top_k: Optional[int] = None,
                           top_p: Optional[float] = None,
                           platforms: Optional[Sequence[str]] = None,
                           param_transform: Optional[Callable] = None
                           ) -> Dict[str, Any]:
    """The generation pipeline of ``generate()`` as exported programs
    (module docstring): ``{"prefill": bytes, "decode": bytes, "sample":
    bytes, "manifest": dict}``. ``params`` is the tree the programs will
    be called with (the model's ``state_dict`` names; int8 leaves with
    ``param_transform=dequantize``), ``None`` for the model's own
    parameters as its example. The programs run on the model's
    device."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if prompt_len + max_new_tokens > model.max_len:
        raise ValueError(f"prompt+new tokens {prompt_len + max_new_tokens} "
                         f"exceed max_len {model.max_len}")
    if temperature <= 0 and (top_k is not None or top_p is not None):
        raise ValueError("top_k/top_p require temperature > 0")
    _check_ring(model, prompt_len, max_new_tokens)
    if params is None:
        params = {k: v.detach() for k, v in model.state_dict().items()}
    _check_names(model, params, param_transform, "params")
    dev = model.device
    sample = _Sample(temperature, top_k, top_p)
    prompt = torch.zeros((batch, prompt_len), dtype=torch.int32, device=dev)
    pre = torch.export.export(
        _WithParams(_Prefill(model, batch, prompt_len), param_transform),
        (params, prompt), strict=False)
    cache, logits = pre.module()(params, prompt)
    noise = (torch.rand(tuple(logits.shape), device=dev)
             if temperature > 0 else None)
    first = torch.export.export(sample, (logits, noise), strict=False)
    last = prompt_len + max_new_tokens - 2
    pos = torch.empty((last, 0), device=dev)
    pos_dim = ({0: Dim("position", min=prompt_len, max=last)}
               if last > prompt_len else None)
    tok = torch.zeros((batch,), dtype=torch.int32, device=dev)
    step = torch.export.export(
        _WithParams(_Step(model, sample), param_transform),
        (params, cache, tok, pos, noise), strict=False,
        dynamic_shapes=(_static(params), (_static(cache), None, pos_dim,
                                          None)))
    manifest = {
        "batch": batch, "prompt_len": prompt_len,
        "max_new_tokens": max_new_tokens, "temperature": temperature,
        "top_k": top_k, "top_p": top_p,
        "platforms": _platforms(platforms, dev),
        "quantized_params": param_transform is not None,
        "device": dev.type,
        "needs_pddl_tpu_torch": _needs_port(pre) or _needs_port(step),
        # The programs take ``params`` in this order (a pytree's spec).
        "param_names": list(params),
    }
    return {"prefill": _save_program(pre, manifest),
            "decode": _save_program(step, manifest),
            "sample": _save_program(first, manifest),
            "manifest": manifest}


_MEMBERS = ("prefill", "decode", "sample")


def save_decode_artifact(path: str, *args, **kwargs) -> str:
    """:func:`export_decode_programs` into ONE zip (``prefill.pt2``,
    ``decode.pt2``, ``sample.pt2``, ``manifest.json``), written beside
    ``path`` and renamed into place; returns ``path``."""
    arts = export_decode_programs(*args, **kwargs)

    def write(tmp):
        with zipfile.ZipFile(tmp, "w") as z:
            for name in _MEMBERS:
                z.writestr(f"{name}.pt2", arts[name])
            z.writestr("manifest.json", json.dumps(arts["manifest"]))

    return _write_atomic(path, write)


def load_decode_artifact(path: str, device=None):
    """Deserialize a :func:`save_decode_artifact` file onto ``device``
    (``None``: the card). Returns ``(prefill, decode, manifest)``:
    ``prefill(params, prompt) -> (cache, logits)`` and ``decode(params,
    cache, logits, key_data) -> tokens i32[B, T]`` (the loop of the
    module docstring; it writes ``cache`` in place)."""
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read("manifest.json"))
        mods = {name: _load_program(z.read(f"{name}.pt2"), device)[0]
                .module() for name in _MEMBERS}
    p, t = manifest["prompt_len"], manifest["max_new_tokens"]
    sampling = manifest["temperature"] > 0

    def ordered(params):
        return {name: params[name] for name in manifest["param_names"]}

    @torch.no_grad()
    def prefill(params, prompt):
        return mods["prefill"](ordered(params), prompt)

    @torch.no_grad()
    def decode(params, cache, logits, key_data):
        params = ordered(params)
        dev = logits.device
        gen = (torch.Generator(device=dev).manual_seed(_seed(key_data))
               if sampling else None)

        def noise():
            if gen is None:
                return None
            return torch.rand(tuple(logits.shape), generator=gen, device=dev)

        tok = mods["sample"](logits, noise())
        out = [tok]
        for i in range(1, t):
            pos = torch.empty((p + i - 1, 0), device=dev)
            tok = mods["decode"](params, cache, tok, pos, noise())
            out.append(tok)
        return torch.stack(out, dim=1)

    return prefill, decode, manifest
