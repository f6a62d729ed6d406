"""Drain and restore, the serving side of checkpoint-on-SIGTERM (the
port's own copy of :mod:`pddl_tpu.serve.drain`, framework-free).

``ServeEngine.drain()`` collects every queued and running request's HOST
state (prompt, tokens generated so far, sampling parameters, deadline
budget, SLO class, tenant fields, draft accounting); these helpers write
and read it; ``ServeEngine.restore()`` resubmits the lot into a fresh
engine, where the replay path rebuilds each running request's K/V
token-exactly (the prompt re-prefilled, the known tokens re-fed through
the ticks).

The snapshot holds NO device state: K/V is a pure function of (weights,
tokens), recomputing it costs one replay prefill a request, and shipping
it would tie the snapshot to one cache layout. It is JSON written
atomically (a temp file, fsync, ``os.replace``), so a kill mid-drain
leaves the old snapshot or the new one, never a torn file.

The wire format is the JAX package's, byte for byte: a snapshot either
package drains restores into the other, in either engine mode, and the
JAX package's fleet and the port's (``serve/fleet/``) migrate streams over
it. :func:`kv_chain_to_wire` / :func:`kv_chain_from_wire` are the
fleet's prefix-chain entries, byte for byte the JAX package's too.

Versions: v2 added each entry's ``priority`` (v1 entries restore as
``interactive``); v3 the header's ``paged`` and each running entry's
``block_table`` (postmortem context, never read by restore); v4 each
entry's tenant ``adapter`` and ``constraint`` (absent: none); v5 the
header's ``spec_k`` and each entry's ``spec`` draft accounting (absent:
zeros). Every readable version restores through the same replay path
into any engine, speculative or not, row or paged; other versions are
refused.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import torch

from pddl_tpu_torch.serve.request import (
    Priority,
    Request,
    RequestHandle,
    RequestState,
    SamplingParams,
)

SNAPSHOT_VERSION = 5
_READABLE_VERSIONS = frozenset({1, 2, 3, 4, 5})

# The exact entry keys ``_encode_core``/``encode_handle`` emit at the
# current version, in their order (the JAX package's manifest): changing
# the entry's shape means a new version, in both packages.
ENTRY_KEYS_V5 = ("prompt", "max_new_tokens", "sampling", "deadline_s",
                 "priority", "adapter", "constraint", "elapsed_s",
                 "tokens", "ttft_s", "spec", "block_table")


def encode_sampling(sampling: SamplingParams) -> Dict[str, object]:
    """The one wire shape of sampling parameters."""
    return {
        "temperature": float(sampling.temperature),
        "top_k": int(sampling.top_k) if sampling.top_k is not None else None,
        "top_p": (float(sampling.top_p)
                  if sampling.top_p is not None else None),
    }


def decode_sampling(d) -> SamplingParams:
    d = d or {}
    return SamplingParams(temperature=float(d.get("temperature", 0.0)),
                          top_k=d.get("top_k"), top_p=d.get("top_p"))


def encode_spec(handle: RequestHandle) -> Dict[str, object]:
    """The v5 per-entry draft accounting: the stream's lifetime drafted
    and accepted counters (zeros on a non-speculative engine)."""
    return {"drafted": int(getattr(handle, "spec_drafted", 0)),
            "accepted": int(getattr(handle, "spec_accepted", 0))}


def encode_handle(handle: RequestHandle, now_s: float,
                  block_table=None) -> Dict[str, object]:
    """One request's restorable host state. ``elapsed_s`` (its age at
    the drain) in place of an absolute arrival lets the restoring engine,
    whose clock has another epoch, keep the deadline budget already
    spent. ``block_table``: a paged engine's pool block ids of a running
    request (v3 postmortem context)."""
    entry = _encode_core(handle, now_s)
    if block_table is not None:
        entry["block_table"] = [int(b) for b in block_table]
    return entry


def _encode_core(handle: RequestHandle, now_s: float) -> Dict[str, object]:
    return {
        "prompt": [int(t) for t in handle.request.prompt],
        "max_new_tokens": int(handle.request.max_new_tokens),
        "sampling": encode_sampling(handle.request.sampling),
        "deadline_s": (float(handle.request.deadline_s)
                       if handle.request.deadline_s is not None else None),
        "priority": handle.request.priority.value,
        "adapter": (str(handle.request.adapter)
                    if handle.request.adapter is not None else None),
        "constraint": handle.request.constraint,
        "elapsed_s": max(0.0, float(now_s - handle.arrival_s)),
        "tokens": [int(t) for t in handle.tokens],
        "ttft_s": (float(handle.ttft_s)
                   if handle.ttft_s is not None else None),
        "spec": encode_spec(handle),
    }


def decode_handle(entry: Dict[str, object], now_s: float) -> RequestHandle:
    """Rebuild a QUEUED handle from a snapshot entry. A non-empty
    ``tokens`` marks it for the engine's replay admission (K/V rebuilt
    from prompt and tokens, the stream continued token-exactly); an
    empty one re-enters as a fresh request. Keys an older version lacks
    decode to what its requests implicitly were."""
    req = Request(
        prompt=[int(t) for t in entry["prompt"]],
        max_new_tokens=int(entry["max_new_tokens"]),
        sampling=decode_sampling(entry.get("sampling")),
        deadline_s=entry.get("deadline_s"),
        priority=Priority(entry.get("priority",
                                    Priority.INTERACTIVE.value)),
        adapter=entry.get("adapter"),
        constraint=entry.get("constraint"),
    )
    handle = RequestHandle(
        req, arrival_s=float(now_s) - float(entry.get("elapsed_s", 0.0)))
    handle.tokens = [int(t) for t in entry.get("tokens", [])]
    handle.ttft_s = entry.get("ttft_s")
    spec = entry.get("spec") or {}
    handle.spec_drafted = int(spec.get("drafted", 0))
    handle.spec_accepted = int(spec.get("accepted", 0))
    handle.state = RequestState.QUEUED
    return handle


# Wire dtype names (numpy's, as the JAX package writes them) of the
# torch dtypes a K/V leaf may have.
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}
_TORCH_DTYPES = {name: dt for dt, name in _WIRE_DTYPES.items()}


def _leaf_bytes(arr) -> bytes:
    """A CPU tensor's (or numpy array's) raw row-major bytes; a 16-bit
    float goes through its int16 view (numpy has no bfloat16)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    import numpy as np  # noqa: PLC0415

    return np.ascontiguousarray(arr).tobytes()


def _leaf_dtype(arr) -> str:
    if isinstance(arr, torch.Tensor):
        return _WIRE_DTYPES[arr.dtype]
    return str(arr.dtype)


def kv_chain_to_wire(tokens: List[int], blocks) -> Dict[str, object]:
    """The replica-to-replica prefix-transfer wire entry: a cached
    chain's token ids plus each block's per-leaf K/V payload, JSON-safe
    (raw bytes base64'd with shape and numpy dtype name), riding the same
    JSON-line transports the drain snapshot rides. Not a snapshot entry
    (chains are cache contents, not requests), so it leaves the versioned
    entry manifest alone. Byte for byte the JAX package's entry for the
    same tokens and blocks (CPU tensors, or numpy arrays)."""
    import base64  # noqa: PLC0415

    return {
        "tokens": [int(t) for t in tokens],
        "blocks": [
            {key: {"shape": list(arr.shape), "dtype": _leaf_dtype(arr),
                   "b64": base64.b64encode(_leaf_bytes(arr)).decode()}
             for key, arr in block.items()}
            for block in blocks],
    }


def kv_chain_from_wire(entry: Dict[str, object]):
    """Decode :func:`kv_chain_to_wire`: ``(tokens, blocks)`` with each
    block a ``{leaf_key: CPU tensor}`` dict, shape and dtype restored
    verbatim. Validation is the importer's job (the engine's host tier
    checks every payload against its own leaf spec and refuses a
    mismatch, so a chain of another configuration imports nothing); a
    dtype name no K/V leaf has raises ``ValueError``."""
    import base64  # noqa: PLC0415

    tokens = [int(t) for t in entry.get("tokens", [])]
    blocks = []
    for block in entry.get("blocks", []):
        decoded = {}
        for key, leaf in block.items():
            dtype = _TORCH_DTYPES.get(leaf["dtype"])
            if dtype is None:
                raise ValueError(
                    f"chain leaf {key!r} has dtype {leaf['dtype']!r}; "
                    f"K/V leaves are one of {sorted(_TORCH_DTYPES)}")
            raw = bytearray(base64.b64decode(leaf["b64"]))
            decoded[key] = torch.frombuffer(raw, dtype=dtype).reshape(
                [int(s) for s in leaf["shape"]])
        blocks.append(decoded)
    return tokens, blocks


def save_snapshot(snapshot: Dict[str, object], path: str) -> None:
    """Atomic write (a temp file, fsync, rename): a kill mid-drain leaves
    the previous snapshot or this one, never a torn file."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snapshot, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_snapshot(path: str) -> Dict[str, object]:
    with open(path) as f:
        snapshot = json.load(f)
    version = snapshot.get("version")
    if version not in _READABLE_VERSIONS:
        raise ValueError(
            f"serve drain snapshot version {version!r} unsupported "
            f"(this build reads versions "
            f"{sorted(_READABLE_VERSIONS)})")
    return snapshot


def restored_handles(snapshot: Dict[str, object],
                     now_s: float) -> List[RequestHandle]:
    """Decode every request of a snapshot in its order (the drain writes
    running requests first, oldest first, so the restore keeps the
    service order). Only ``requests`` is read: the ``telemetry`` block is
    postmortem context for a reader of the file."""
    return [decode_handle(e, now_s) for e in snapshot["requests"]]
