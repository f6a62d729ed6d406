"""Continuous-batching online serving engine (the port of
:mod:`pddl_tpu.serve.engine`), in its two modes.

Orca-style iteration-level scheduling: requests join and leave the
running batch at token granularity. Each :meth:`ServeEngine.step`:

1. REAP cancelled and timed-out slots;
2. ADMIT queued requests into free slots — the radix index
   (``kvcache/radix.py``) matches the longest cached prompt prefix, the
   uncached suffix is chunk-prefilled (narrow chunks for short suffixes,
   one wide chunk for a long remainder), the prompt's full blocks are
   handed to the index, and the first token is sampled from the prefill
   logits (that is TTFT);
3. one fused decode TICK for every live slot, with per-slot sampling
   parameters as batched arrays; finished slots are evicted host-side.

``paged=False`` (the default, as in the JAX package) keeps each live
request in a RESIDENT ROW of a pooled slot cache ``[S, H_kv, max_len,
D]`` per layer. Admission works in one batch-1 row: a prefix hit
GATHERS the matched pool blocks into it (a copy), the suffix chunks
continue it, the prompt's uncovered full blocks are DONATED back to the
pool (a copy), and the row is copied into the slot. The tick writes each
slot's token at its own position and attends over the rows through
:func:`~pddl_tpu_torch.ops.attention.decode_attention`, bounded by the
deepest slot. ``prefix_cache_blocks=0`` turns the prefix cache off:
each admission is then one padded one-shot prefill.

``paged=True`` has no rows: the pool IS the cache. A prefix hit points
the slot's block table at the matched blocks IN PLACE (pinned, never
copied), private blocks take the suffix, a fresh private block is
appended before a slot writes across a block boundary, and each layer
attends through the table — on the card the hand-written paged-decode
kernel (``ops/csrc/paged_decode.cu``).

Token-exactness of shared blocks is structural: both families' caches
are position-absolute (Llama caches post-RoPE keys; GPT adds its
position embeddings before the blocks), so a block computed by one
request is bit-valid for every request with the same prompt tokens. A
model whose decode needs a rolling ring cache (``Llama.uses_ring_cache``)
is refused in both modes, as the JAX engine refuses it; it decodes
through ``models/gpt.generate``.

Speculative serving (``spec_k > 0``, both modes): the tick becomes a
DRAFT/VERIFY window. Each step proposes ``spec_k`` tokens per slot — the
shared n-gram drafter (``models/speculative.ngram_drafts``) over a host
history of each slot's tokens, or (``paged=True`` only) a small draft
model whose K/V lives in a second cache tree over the target's block ids,
so it shares the tables and the prefix sharing — and ONE forward of the
target over the ``[S, spec_k+1]`` block at per-slot positions checks
them, through the same multi-token path chunked prefill uses. A greedy
slot emits the longest matching draft prefix plus one token, each the
argmax given the true prefix, so its stream equals the non-speculative
one; a sampled slot takes no drafts and ticks one token. A rejected tail
is undone by the host-owned position alone: its K/V lies past the
position, where no sweep reads it, until the next window overwrites it.
On the card the draft model's single-token steps run the paged-decode
kernel; the verify's multi-token attention takes the plain path, as the
JAX engine's does.

Multi-tenant serving (``tenant=TenantConfig(...)``, both modes, with or
without ``spec_k``; `serve/tenant/`): ``submit(adapter=...)`` serves a
request through a registered LoRA adapter, whose factors are loaded at
admission into a fixed-shape device pool (``[P, d, r]`` / ``[P, r, V]``
f32; pinned while a slot uses them, LRU-evicted when cold, row 0 the
all-zero identity) and applied to the LM HEAD as a batched gather-matmul
over the slots' rows (``ops/lora.batched_lora_delta``): K/V stay
adapter-invariant, so prefix and paged blocks are shared across
tenants. ``submit(constraint=...)`` compiles a regex or JSON schema into
a token FSM at submit; each slot's allow mask (``[S, V]`` on the host,
copied to the card only when a row changed) is applied as
``where(mask, logits, -inf)`` ahead of the batched sampler, eos is
allowed exactly in accepting states, and a stream with no legal
continuation finishes ``FinishReason.GRAMMAR``. A speculative engine
walks each constrained greedy slot's FSM along its drafts, stamps
per-position masks ``[S, spec_k+1, V]`` for the verify and caps its
acceptance at the legal prefix. A slot with no adapter and no constraint
is bitwise the base model.

int8 serving composes as in the JAX engine: ``ServeEngine(model,
{"params": quantize_int8(model)}, param_transform=dequantize)`` serves
a copy of the model holding the int8 weights (``ops/quant.with_params``;
the caller's model keeps its own, so drop it to free them), each
dequantized at its product in every forward — the prefill chunks, the
tick, the verify and the tenant tick's head outside the module — so
int8 is what the card holds; the pool stores K/V, which weight storage
never touches. A draft model's ``spec_draft_variables`` load as given,
with no transform, as the JAX engine applies none to them.

Fault tolerance (``serve/faults.py``): every device call goes through
one guarded boundary (``_device_call``), with the JAX engine's sites at
the same points in the control flow, so a seeded
:class:`~pddl_tpu_torch.serve.faults.FaultPlan` fires at the same ``(step,
site)`` coordinates in both packages. Transient errors retry with bounded
exponential backoff; when retries run out (or a real error struck a call
that writes a cache in place) the affected slots' K/V is declared LOST
and the requests REPLAY: the prompt re-prefills through the normal
admission and the emitted tokens are re-fed through the coming ticks
(``spec_k + 1`` a window on a speculative engine), never re-sampled, so
every stream stays token-exact. An allocation failure — the CUDA caching
allocator's ``torch.OutOfMemoryError``, or an injected one — flips the
engine DEGRADED: unpinned prefix blocks are flushed from the index,
donations stop, serving continues on the cold path, and the cache re-arms
after ``degraded_cooldown_s``. A rebuild after a real error zeroes the
resident tensors in place (the same shapes, the JAX engine's fresh
zeros), so it never holds two copies. A request past ``max_replays``
fails alone (``FinishReason.ERROR``). Preemption (``preempt_cap``, 2 by
default as in the JAX engine) parks a running BEST_EFFORT stream for
queued interactive work and resumes it through the same replay.

The host KV tier (``host_tier=``, ``kvcache/hosttier.py``): with a tier
armed, the radix index's LRU eviction DEMOTES reuse-worthy chains — one
``cache_blocks_gather`` per leaf over the reclaim's victims and one
device-to-host copy — into a byte-budgeted host pool, and an admission
that misses the device pool but hits the tier PROMOTES the chain back
(one host-to-device copy and one ``cache_blocks_scatter`` per leaf, the
``host_promote`` site), charged against the prefill budget at
``promote_tokens_per_block`` a block. Degraded mode bypasses the tier in
both directions; a disabled tier leaves the engine bit-identical to an
untiered one.

Sliced prefill (``prefill_slice_tokens``, both modes, the prefix
machinery on): an admission prefills at most that many prompt tokens a
``step()`` in narrow chunks (the wide chunk, one head-of-line block, is
never taken), and the decode tick runs between slices, so one long cold
prompt no longer stalls every running stream. One slice is in flight at a
time; it parks across steps in ``_slice`` (the row engine's admission
row, or the paged engine's pinned chain and private blocks), a draft
model's tree advancing chunk for chunk beside it. Cancel and deadline
land mid-slice; a lost chunk unwinds it like any admission.

Drain and restore (``serve/drain.py``, the JAX package's snapshot v5 byte
for byte): :meth:`ServeEngine.install_drain_handler` arms a SIGTERM
handler that only sets a flag; the next ``step()`` drains at its
boundary: every running, mid-admission and queued request's host state
is snapshotted (atomically to a file, if given), admission stops and
``step()`` returns 0. :meth:`ServeEngine.restore` resubmits a snapshot,
drained by either package, into a fresh engine of either mode, and each
running stream resumes token-exactly through the replay path.

Tracing (``tracer=`` / :meth:`ServeEngine.set_tracer`,
``obs/trace.py``): the JAX engine's per-request span hooks, at the same
points with the same arguments, every argument a host scalar the engine
already holds; the default :data:`~pddl_tpu_torch.obs.trace.NULL_TRACER`
costs one no-op call a hook and allocates nothing.

Warmup and the program census: PyTorch compiles nothing, but the JAX
engine's contract stays. :meth:`ServeEngine.warmup` runs one dummy
admission into slot 0 and one tick with every slot dead, so every site
runs once with its serving shapes and every kernel the engine will launch
is built and loaded (K4 on a paged engine) before traffic; it leaves no
trace (the radix index empty, no slot taken, the metrics, the telemetry,
the fault plan and the sampling generator as they were; junk K/V lands at
parked positions or in the scratch sink) and ``step()`` calls it
implicitly. :meth:`ServeEngine.compile_counts` has the JAX engine's keys
for the same configuration, and each value is a count the engine
measures: the number of distinct signatures (shapes and dtypes) of the
tensor inputs the site's JAX program takes that the site was entered
with since construction. It reads 1 after warmup on a shape-closed
engine, so "zero recompiles after warmup" means the same thing in both
packages: no new program shape. Host values are not shapes: block-id
lists (the JAX programs take them padded to a fixed width), offsets,
lengths, the tick's ``max_index`` bound, and a tenant engine's optional
mask and adapter-row inputs (one shape each when present).

Cross-replica prefix transfer (the fleet's chain pulls,
``serve/fleet/``): :meth:`ServeEngine.export_prefix_chain` reads the
longest cached chain for a prompt (the device match, pinned for the read,
then host-tier blocks extending it) as a ``serve/drain.py`` chain wire
entry; :meth:`ServeEngine.import_prefix_chain` stores a decoded chain in
the host tier, block by block, and the next admission promotes it
through the ``host_promote`` site like a locally spilled chain.
"""

from __future__ import annotations

import signal
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from pddl_tpu_torch.device import resolve_device
from pddl_tpu_torch.models.gpt import (
    _last_logits,
    decode_cache,
    insert_cache_slot,
    load_variables,
    prefill_row_features,
    sample_logits_batched,
    slot_decode_cache,
)
from pddl_tpu_torch.models.speculative import ngram_drafts
from pddl_tpu_torch.obs.ring import TelemetryRing
from pddl_tpu_torch.obs.trace import NULL_TRACER
from pddl_tpu_torch.ops.attention import (
    cache_blocks_gather,
    cache_blocks_scatter,
)
from pddl_tpu_torch.ops.lora import adapter_pool_load, batched_lora_delta
from pddl_tpu_torch.serve import drain as drain_io
from pddl_tpu_torch.serve.faults import (
    InjectedResourceExhausted,
    InjectedTransientError,
    classify,
)
from pddl_tpu_torch.serve.kvcache import (
    HostTierCache,
    HostTierConfig,
    RadixPrefixCache,
    donate_prefix_blocks,
    gather_prefix_into_row,
    kv_block_pool,
    kv_leaf_items,
    paged_decode_cache,
    pool_nbytes,
)
from pddl_tpu_torch.serve.metrics import ServeMetrics
from pddl_tpu_torch.serve.request import (
    FinishReason,
    Priority,
    QueueFull,
    Request,
    RequestHandle,
    RequestState,
    SamplingParams,
)
from pddl_tpu_torch.serve.scheduler import SLOScheduler
from pddl_tpu_torch.serve.tenant import (
    AdapterPool,
    AdapterPoolExhausted,
    AdapterRegistry,
    compile_constraint,
    constraint_key,
)

def _zero(tree: dict) -> None:
    """Zero every K/V leaf of a cache or pool tree in place."""
    for _, leaf in kv_leaf_items(tree):
        leaf.zero_()


def _signature(x):
    """The shapes and dtypes of the tensors and arrays in ``x`` (nested
    through dicts, lists and tuples); host values (ints, floats, block-id
    lists, ``None``, other objects) contribute ``None``."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if isinstance(x, np.ndarray):
        return x.shape, x.dtype.str
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        sig = tuple(_signature(v) for v in x)
        return sig if any(v is not None for v in sig) else None
    return None


class _SlotStateLost(RuntimeError):
    """Internal escalation: a device call outlasted its retry budget (or
    failed in a way that may have written part of a resident tensor), so
    whatever slot or row state it touched must be rebuilt, not reused.
    Never escapes the engine: admission turns it into a request replay or
    failure, the tick into a full live-slot replay. ``consumed`` names the
    resident resource (``cache``/``row``/``pool``) a REAL mid-call error
    may have left half-written; ``None`` for injected faults, which fire
    before the call runs and touch nothing."""

    def __init__(self, site: str, cause: BaseException,
                 consumed: Optional[str] = None):
        self.site = site
        self.consumed = consumed
        super().__init__(f"device call {site!r} lost after retries: {cause}")


# Which resident tree each site's call writes in place (the JAX engine's
# donated trees: PyTorch donates nothing, but a call that raises midway
# may have written part of its K/V). A REAL error from one of these is
# never re-dispatched — the escalation rebuilds the resource instead.
# ``prefill`` and ``sample_first`` write nothing resident.
_DONATED_BY_SITE = {
    "tick": "cache", "insert": "cache",
    "gather": "row", "chunk_prefill": "row", "chunk_prefill_wide": "row",
    "donate": "pool",
}

# The paged engine's map: the pool IS the cache, and every paged call that
# writes K/V writes it, so recovery is always the full pool rebuild and a
# live-slot replay.
_PAGED_DONATED_BY_SITE = {
    "tick": "pool", "chunk_prefill": "pool", "chunk_prefill_wide": "pool",
}

# Speculative additions: ``verify`` replaces ``tick``; the draft model's
# admission chunk writes the draft tree, which shares the paged pool's
# block ids. The n-gram ``draft`` writes nothing (a lost draft call falls
# back to repeat-last-token drafts), so the ``draft`` entry is stamped per
# engine, only when a draft model drafts.
_SPEC_DONATED_ROW = {"verify": "cache"}
_SPEC_DONATED_PAGED = {"verify": "pool", "draft_prefill": "pool"}


class ServeEngine:
    """Online multiplexer of generate requests onto one fused decode tick.

    Args:
      model: a port Llama or GPT (``pddl_tpu_torch.models``); it is
        moved to ``device`` in place.
      variables: ``None`` serves the model's own weights; ``{"params":
        tree}`` serves a copy of the model holding the tree (dense, or
        the int8 tree of ``ops/quant.quantize_int8`` with
        ``param_transform``: ``models/gpt.load_variables``), leaving
        ``model``'s own weights as they were.
      device: where the engine runs — ``None`` means ``cuda`` (raises on
        a host without a card), ``"cpu"`` runs the plain PyTorch paths.
      max_slots: batch slots ``S`` — the max concurrent requests in one
        fused tick.
      prefill_len: the longest prompt accepted (default ``max_len // 2``);
        also the wide prefill chunk's width.
      max_queue_depth / prefill_token_budget / aging_s: admission knobs
        (``scheduler.py``).
      eos_token: optional stop token (included in the stream when hit).
      rng: a ``torch.Generator`` on ``device`` for sampled requests
        (default: seeded with 0).
      clock: injectable monotonic clock.
      prefix_cache_blocks: pool size in blocks, block 0 the scratch sink.
        ``None`` sizes it to two cached prompts per slot (``paged=False``)
        or to every slot at ``max_len`` plus that headroom (``paged=True``,
        where an explicit size must cover ``max_slots * ceil(max_len /
        block_size) + 1`` so a live stream never starves for a writable
        block). ``0`` turns the prefix cache off (``paged=False`` only).
      prefix_block_size: tokens per pool block (the sharing granularity).
      prefix_chunk: the narrow prefill chunk width (default
        ``max(prefix_block_size, prefill_len // 4)``).
      paged: False (default) for the resident-row engine, True for the
        paged one (module docstring).
      host_tier: the host KV tier (module docstring): a
        :class:`~pddl_tpu_torch.serve.kvcache.HostTierConfig` or a plain
        int byte budget. Needs the prefix machinery; refused beside
        ``spec_draft_model`` (a promoted block carries target K/V only).
        ``None`` (default) or budget 0 disables it.
      fault_plan: an optional :class:`~pddl_tpu_torch.serve.faults.
        FaultPlan` consulted before every guarded device call; ``None``
        in production (real device errors take the same recovery paths).
      max_retries: transient-error retries per device call before the
        touched slot state is declared lost and requests replay.
      retry_backoff_s / backoff_sleep: the bounded exponential backoff
        (``base * 2**attempt``) between retries, and how it waits.
      max_replays: slot-state rebuilds per request before it fails
        terminally with ``FinishReason.ERROR``.
      degraded_cooldown_s: how long an OOM keeps the prefix cache
        degraded before re-arming; a repeat OOM pushes it out again.
      preempt_cap: times one BEST_EFFORT stream may be parked (slot
        freed, requeued, resumed token-exactly through replay) for queued
        interactive work; 0 disables preemption.
      telemetry_capacity: size of the per-step :class:`TelemetryRing`.
      spec_k: speculative serving (module docstring): up to ``spec_k``
        drafts per greedy slot per step, checked in one ``[S, spec_k+1]``
        verify forward; 0 (default) keeps the one-token tick.
      spec_ngram: the n-gram drafter's key length.
      spec_draft_model: a port Llama or GPT that drafts in place of the
        n-gram lookup (``paged=True`` only; the same vocabulary,
        ``max_len`` at least the target's, no ring cache); it is moved to
        ``device``.
      spec_draft_variables: ``None`` keeps the draft model's weights;
        ``{"params": tree}`` drafts from a copy of it holding a dense
        tree, untransformed (``param_transform`` is the target's, as in
        the JAX engine).
      tenant: a :class:`~pddl_tpu_torch.serve.tenant.TenantConfig` turns
        on multi-tenant serving (module docstring): per-request LoRA
        adapters and grammar constraints. ``None`` (default) serves the
        base model only, and ``submit``'s ``adapter``/``constraint`` are
        refused.
      param_transform: applied to each int8 leaf of ``variables`` at
        each use (``ops/quant.dequantize``).
      prefill_slice_tokens: sliced prefill (module docstring): at most
        this many prompt tokens prefilled a ``step()``, in narrow chunks,
        the decode tick between slices; needs the prefix machinery.
        ``None`` (default) admits whole prompts.
      tracer: a per-request tracer
        (:class:`~pddl_tpu_torch.obs.trace.RequestTracer`); ``None``
        installs the no-op :data:`~pddl_tpu_torch.obs.trace.NULL_TRACER`.
        Swap at run time with :meth:`set_tracer`.

    A model with :attr:`~pddl_tpu_torch.models.llama.Llama.uses_ring_cache`
    set is refused, as the JAX engine refuses it.

    ``metrics`` carries counters the JAX engine lacks, outside its
    snapshot: ``copy_bytes_gathered`` (pool → admission row on a prefix
    hit) and ``copy_bytes_donated`` (admission row → pool), the row
    engine's copies that the paged one avoids, and ``mask_restages``
    (host-to-device copies of a tenant engine's grammar masks).
    """

    def __init__(self, model, variables=None, *, device=None,
                 max_slots: int = 8,
                 prefill_len: Optional[int] = None,
                 max_queue_depth: int = 64,
                 prefill_token_budget: Optional[int] = None,
                 aging_s: Optional[float] = 30.0,
                 prefill_slice_tokens: Optional[int] = None,
                 eos_token: Optional[int] = None,
                 param_transform=None,
                 rng: Optional[torch.Generator] = None,
                 clock=time.monotonic,
                 prefix_cache_blocks: Optional[int] = None,
                 prefix_block_size: int = 8,
                 prefix_chunk: Optional[int] = None,
                 paged: bool = False,
                 host_tier=None, fault_plan=None, max_retries: int = 3,
                 retry_backoff_s: float = 0.02, backoff_sleep=time.sleep,
                 max_replays: int = 3, degraded_cooldown_s: float = 5.0,
                 preempt_cap: int = 2, tenant=None, spec_k: int = 0,
                 spec_ngram: int = 3, spec_draft_model=None,
                 spec_draft_variables=None, tracer=None,
                 telemetry_capacity: int = 512):
        if getattr(model, "uses_ring_cache", False):
            raise NotImplementedError(
                "the serving engine needs full-length KV caches; "
                f"sliding_window={model.sliding_window} allocates a "
                "rolling ring cache whose slot reuse is not supported yet")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if max_replays < 0:
            raise ValueError(f"max_replays must be >= 0, got {max_replays}")
        if preempt_cap < 0:
            raise ValueError(f"preempt_cap must be >= 0, got {preempt_cap}")
        self.device = resolve_device(device)
        self.model = load_variables(model.to(self.device), variables,
                                    param_transform)
        self.max_slots = int(max_slots)
        self.prefill_len = int(prefill_len if prefill_len is not None
                               else model.max_len // 2)
        if not 1 <= self.prefill_len <= model.max_len:
            raise ValueError(
                f"prefill_len {self.prefill_len} outside [1, "
                f"{model.max_len}]")
        self.eos_token = eos_token
        self._clock = clock
        self._rng = (rng if rng is not None
                     else torch.Generator(device=self.device).manual_seed(0))
        self.scheduler = SLOScheduler(
            max_queue_depth=max_queue_depth,
            prefill_token_budget=prefill_token_budget, aging_s=aging_s)
        self.metrics = ServeMetrics()
        # The tracer defaults to the shared no-op object: a hook is one
        # method call that allocates nothing.
        self._tracer = NULL_TRACER
        self.telemetry = TelemetryRing(telemetry_capacity)
        self._step_idx = 0
        # The step coordinate the fault plan, the trace events and the
        # telemetry record all stamp.
        self._cur_step = 0
        self._site_wall: Dict[str, float] = {}
        self._last_wall_s = 0.0
        # Resilience state (``serve/faults.py``).
        self._faults = fault_plan
        self._max_retries = int(max_retries)
        self._retry_backoff_s = float(retry_backoff_s)
        self._backoff_sleep = backoff_sleep
        self._max_replays = int(max_replays)
        self._degraded_cooldown_s = float(degraded_cooldown_s)
        self._degraded = False
        self._degraded_entered_s = 0.0
        self._degraded_until_s = 0.0
        self._preempt_cap = int(preempt_cap)
        # Handles popped from the queue but not yet slotted: a kill
        # mid-admission (or a parked slice) leaves its handle here, first
        # in line next step and in the drain snapshot.
        self._admitting: Deque[RequestHandle] = deque()
        self._drain_flag = False
        self._drained = False
        self._drain_path: Optional[str] = None
        self._snapshot: Optional[dict] = None
        self._prev_handlers: Dict[int, object] = {}
        # The program census (:meth:`compile_counts`): each site's
        # distinct input signatures since construction.
        self._warm = False
        self._site_sigs: Dict[str, set] = {}

        bs = int(prefix_block_size)
        if bs < 1:
            raise ValueError(f"prefix_block_size must be >= 1, got {bs}")
        # A prefix hit must leave >= 1 suffix token to produce the
        # sampled-from logits, so the longest matchable chain is
        # (prefill_len - 1) tokens, floor-blocked.
        self._match_cap = (self.prefill_len - 1) // bs
        self._donate_cap = self.prefill_len // bs
        chunk = (int(prefix_chunk) if prefix_chunk is not None
                 else max(bs, self.prefill_len // 4))
        self._paged = bool(paged)
        # Paged: T table entries cover every position a stream can reach;
        # the pool must hold one writable block per live position-block
        # plus the scratch sink, or a decode tick could starve mid-stream.
        self._table_width = -(-model.max_len // bs)
        paged_floor = self.max_slots * self._table_width + 1
        headroom = 2 * self.max_slots * max(self._donate_cap, 1)
        if prefix_cache_blocks is not None:
            pool_blocks = int(prefix_cache_blocks)
        elif self._paged:
            pool_blocks = paged_floor + headroom
        else:
            pool_blocks = headroom + 1 if self._match_cap >= 1 else 0
        self._prefix_on = pool_blocks > 0
        if self._paged:
            if not self._prefix_on:
                raise ValueError(
                    "paged=True needs the block-pool machinery; "
                    "prefix_cache_blocks=0 disables it")
            if pool_blocks < paged_floor:
                raise ValueError(
                    f"paged=True needs prefix_cache_blocks >= {paged_floor} "
                    f"(max_slots * ceil(max_len/block_size) + scratch) so "
                    f"live streams can never starve for a writable block; "
                    f"got {pool_blocks}")
        if self._prefix_on:
            if self._match_cap < 1:
                raise ValueError(
                    f"prefix_block_size {bs} leaves no cacheable block "
                    f"under prefill_len {self.prefill_len} (need "
                    "block_size < prefill_len); pass prefix_cache_blocks=0 "
                    "to disable prefix caching")
            if not 1 <= chunk or self.prefill_len + chunk > model.max_len:
                raise ValueError(
                    f"prefix_chunk {chunk} needs 1 <= chunk and prefill_len "
                    f"+ chunk <= max_len ({self.prefill_len} + {chunk} > "
                    f"{model.max_len}): a chunk starting at the deepest "
                    "cached offset would clamp its positions")
            if pool_blocks < 2:
                raise ValueError(
                    f"prefix_cache_blocks must be >= 2 (block 0 is the "
                    f"reserved scratch sink), got {pool_blocks}")
        # Sliced prefill: one slice in flight at a time (the admission
        # row, or one pinned chain, is the single admission pipeline);
        # `_slice` holds its resumable state across steps.
        if prefill_slice_tokens is not None:
            if not self._prefix_on:
                raise ValueError(
                    "prefill_slice_tokens requires the prefix-cache "
                    "engine (its chunk programs are the slicing "
                    "mechanism); leave prefix_cache_blocks enabled or "
                    "unset prefill_slice_tokens")
            if prefill_slice_tokens < 1:
                raise ValueError(
                    f"prefill_slice_tokens must be >= 1, got "
                    f"{prefill_slice_tokens}")
        self._slice_tokens = (int(prefill_slice_tokens)
                              if prefill_slice_tokens is not None else None)
        self._slice: Optional[dict] = None
        self._slice_budget_left = 0
        self._init_spec(model, spec_k, spec_ngram, spec_draft_model,
                        spec_draft_variables)
        self._init_tenant(model, tenant)
        self.prefix_block_size = bs
        self._chunk = chunk
        # The WIDE chunk (the whole prefill_len) serves cold or barely
        # cached prompts in one forward; it can start as deep as
        # prefill_len/4 (the width policy's threshold), so its positions
        # must stay in range there too. With the prefix cache off, an
        # admission is one padded prefill and there are no chunks.
        self._has_wide = (self._prefix_on and self._chunk < self.prefill_len
                          and self.prefill_len + self.prefill_len // 4
                          <= model.max_len)

        self._prefix = (RadixPrefixCache(bs, pool_blocks)
                        if self._prefix_on else None)
        if self._paged:
            self._cache = paged_decode_cache(self.model, pool_blocks, bs)
            # The draft model's K/V: a second tree over the same block ids.
            self._dcache = (paged_decode_cache(self._draft, pool_blocks, bs)
                            if self._draft_on else None)
            self._pool = self._row = None
            token_slots = pool_blocks * bs
        else:
            self._cache = slot_decode_cache(self.model, self.max_slots)
            self._pool = (kv_block_pool(self.model, pool_blocks, bs)
                          if self._prefix_on else None)
            # The resident admission row: every admission with the prefix
            # cache on is prefilled here, then copied into its slot.
            self._row = (decode_cache(self.model, 1) if self._prefix_on
                         else None)
            token_slots = self.max_slots * model.max_len
        # KV bytes one token occupies across every layer: what a gathered,
        # donated or avoided copy of one token is worth.
        self._kv_token_bytes = pool_nbytes(self._cache) // token_slots
        # The recovery class of each guarded site (module tables above).
        self._donated_by_site = dict(_PAGED_DONATED_BY_SITE if self._paged
                                     else _DONATED_BY_SITE)
        if self._spec_on:
            self._donated_by_site.update(
                _SPEC_DONATED_PAGED if self._paged else _SPEC_DONATED_ROW)
            if self._draft_on:
                # The draft model's steps write the draft tree: a real
                # mid-call error escalates to the pool-class rebuild,
                # which rebuilds both trees.
                self._donated_by_site["draft"] = "pool"

        # One handle per occupied slot; the other per-slot state lives in
        # the host arrays below, stamped into every tick.
        self._slots: List[Optional[RequestHandle]] = [None] * self.max_slots
        self._slot_nodes: List[Optional[object]] = [None] * self.max_slots
        self._positions = np.zeros(self.max_slots, np.int32)
        self._tokens = np.zeros(self.max_slots, np.int32)
        self._temps = np.zeros(self.max_slots, np.float32)
        self._top_ks = np.zeros(self.max_slots, np.int32)
        self._top_ps = np.full(self.max_slots, 2.0, np.float32)
        # Paged: host-authoritative block tables (scratch-filled for
        # parked slots) and the private, not-yet-shared block ids each
        # slot owns.
        self._tables = (np.zeros((self.max_slots, self._table_width),
                                 np.int32) if self._paged else None)
        self._private: List[List[int]] = [[] for _ in range(self.max_slots)]
        self._init_host_tier(host_tier)
        if tracer is not None:
            self.set_tracer(tracer)

    def _init_host_tier(self, host_tier) -> None:
        """Arm the host KV tier (the ``host_tier`` argument): the
        byte-budgeted :class:`HostTierCache` with this engine's per-leaf
        block spec, and the demotion hook on the radix index's eviction
        path. ``None`` or a zero budget installs nothing: the engine stays
        bit-identical to an untiered one. Refused in the JAX engine's
        words where it refuses."""
        self._host = None
        self._host_promote_tokens = 0
        if host_tier is None:
            return
        cfg = (host_tier if isinstance(host_tier, HostTierConfig)
               else HostTierConfig(byte_budget=int(host_tier)))
        if cfg.byte_budget == 0:
            return
        if not self._prefix_on:
            raise ValueError(
                "host_tier needs the prefix-cache machinery (the radix "
                "eviction path is what demotes); leave "
                "prefix_cache_blocks enabled or pass host_tier=None")
        if self._draft_on:
            raise NotImplementedError(
                "host_tier with spec_draft_model is not supported yet: "
                "a promoted block carries target K/V only, and the "
                "draft tree's twin block would be junk — mirroring the "
                "second cache tree through the tier is follow-on work")
        bs = self.prefix_block_size
        spec = {key: ((1,) + tuple(leaf.shape[1:-2]) + (bs, leaf.shape[-1]),
                      leaf.dtype)
                for key, leaf in kv_leaf_items(self._tier_target())}
        self._host = HostTierCache(bs, cfg.byte_budget,
                                   min_chain_blocks=cfg.min_chain_blocks,
                                   leaf_spec=spec)
        self._host_promote_tokens = int(cfg.promote_tokens_per_block)
        # A real mid-call promotion error may have half-written the pool:
        # the pool-class rebuild (paged: the full live-slot replay).
        self._donated_by_site["host_promote"] = "pool"
        self._prefix.on_evict = self._demote_blocks

    def _tier_target(self) -> dict:
        """The pool tree the host tier spills from and promotes into."""
        return self._cache if self._paged else self._pool

    def _init_spec(self, model, spec_k, spec_ngram, spec_draft_model,
                   spec_draft_variables) -> None:
        """The speculative options, checked as the JAX engine checks them
        (in its words), and the drafter's per-slot token history."""
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self._spec_k = int(spec_k)
        self._spec_on = self._spec_k > 0
        self._spec_ngram = int(spec_ngram)
        self._draft_on = spec_draft_model is not None
        self._draft = self._dcache = None
        if spec_draft_variables is not None and not self._draft_on:
            raise ValueError(
                "spec_draft_variables without spec_draft_model")
        if self._spec_on:
            if self._spec_ngram < 1:
                raise ValueError(
                    f"spec_ngram must be >= 1, got {spec_ngram}")
            # Prompt + emitted tokens per slot, on the host: positions past
            # a slot's live edge hold junk, which verification rejects.
            self._hist = np.zeros((self.max_slots, model.max_len), np.int32)
        if not self._draft_on:
            return
        if not self._spec_on:
            raise ValueError(
                "spec_draft_model needs spec_k >= 1 (the draft "
                "model only exists to fill the verify window)")
        if not self._paged:
            raise ValueError(
                "spec_draft_model rides the paged KV block pool as "
                "a second cache tree; pass paged=True (the n-gram "
                "drafter serves resident-row engines)")
        if spec_draft_model.vocab_size != model.vocab_size:
            raise ValueError(
                f"draft model vocab {spec_draft_model.vocab_size} "
                f"!= target vocab {model.vocab_size}")
        if spec_draft_model.max_len < model.max_len:
            raise ValueError(
                f"draft model max_len {spec_draft_model.max_len} < "
                f"target max_len {model.max_len}: the draft cache "
                "must cover every position a stream can reach")
        if getattr(spec_draft_model, "uses_ring_cache", False):
            raise NotImplementedError(
                "draft models with rolling ring caches are not "
                "supported (same slot-reuse constraint as the "
                "target)")
        self._draft = load_variables(spec_draft_model.to(self.device),
                                     spec_draft_variables,
                                     role="spec_draft_variables")

    def _init_tenant(self, model, tenant) -> None:
        """The multi-tenant state, checked as the JAX engine checks it (in
        its words): the host-side adapter pool bookkeeping, the device
        factor pools, per-slot adapter rows, per-slot grammar masks (and
        per-position ones for the verify window) and the FSM cache. All
        absent on a plain engine."""
        self._tenant = tenant
        self._tenant_on = tenant is not None
        self._registry = self._apool = None
        if not self._tenant_on:
            return
        registry = tenant.registry
        if registry is None:
            registry = AdapterRegistry(model.embed_dim, model.vocab_size)
            tenant.registry = registry
        if (registry.embed_dim != model.embed_dim
                or registry.vocab_size != model.vocab_size):
            raise ValueError(
                f"adapter registry shape ({registry.embed_dim}, "
                f"{registry.vocab_size}) does not match the model "
                f"({model.embed_dim}, {model.vocab_size})")
        if tenant.token_strings is not None \
                and len(tenant.token_strings) != model.vocab_size:
            raise ValueError(
                f"token_strings has {len(tenant.token_strings)} "
                f"entries; the grammar vocabulary must cover every "
                f"token id (vocab_size {model.vocab_size})")
        pool_rows = (int(tenant.adapter_pool_slots)
                     if tenant.adapter_pool_slots is not None
                     else self.max_slots + 4)
        if pool_rows < self.max_slots + 1:
            raise ValueError(
                f"adapter_pool_slots {pool_rows} is below the live-"
                f"mix floor max_slots + 1 = {self.max_slots + 1} "
                "(every slot on a distinct adapter plus the "
                "identity row 0); see docs/OPERATIONS.md 'Adapter "
                "pool sizing'")
        s, v = self.max_slots, model.vocab_size
        self._registry = registry
        self._apool = AdapterPool(pool_rows)
        self._apool_a = torch.zeros((pool_rows, model.embed_dim,
                                     registry.rank), device=self.device)
        self._apool_b = torch.zeros((pool_rows, registry.rank, v),
                                    device=self.device)
        # Per-slot adapter rows: the host copy, and the card's, restaged
        # only when a row changed (admission, release).
        self._arow = np.zeros(s, np.int64)
        self._arow_dev = None
        # Per-slot allow masks, all-True (a bitwise pass-through) unless
        # a constrained stream holds the slot; the card's copy restages
        # only when a host row changed. A speculative engine adds the
        # verify window's per-position masks.
        self._masks = np.ones((s, v), np.bool_)
        self._masks_dev = None
        self._masks_dirty = True
        self._masks_w = (np.ones((s, self._spec_k + 1, v), np.bool_)
                         if self._spec_on else None)
        self._masks_w_dev = None
        self._masks_w_dirty = True
        # (fsm, state) per constrained slot; None otherwise.
        self._fsms: List[Optional[tuple]] = [None] * s
        self._fsm_cache: Dict[str, object] = {}

    # ----------------------------------------------------- observability
    @property
    def tracer(self):
        """The installed tracer (the shared no-op object when tracing is
        off: check ``tracer.enabled``)."""
        return self._tracer

    def set_tracer(self, tracer) -> None:
        """Install (or, with ``None``, remove) a per-request tracer. Also
        wires the fault plan's injection observer, while the tracer is
        enabled, so every injected fault (latency ones included, which
        raise nothing) surfaces at the ``(step, site)`` it fired at."""
        self._tracer = NULL_TRACER if tracer is None else tracer
        if self._faults is not None:
            self._faults.on_inject = (
                self._tracer.on_fault_injected if self._tracer.enabled
                else None)

    # -------------------------------------------------------- submission
    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               sampling: Optional[SamplingParams] = None,
               deadline_s: Optional[float] = None,
               priority: Priority = Priority.INTERACTIVE,
               adapter: Optional[str] = None,
               constraint: Optional[dict] = None) -> RequestHandle:
        """Queue one request; returns its streaming handle. Raises
        :class:`~pddl_tpu_torch.serve.request.QueueFull` (with a
        priority-aware ``retry_after_s`` hint) when the queue is at
        depth.

        Tenant fields (need ``tenant=TenantConfig(...)``): ``adapter``
        names a registered LoRA adapter (``None`` = base model);
        ``constraint`` is a grammar/schema spec dict (``{"kind": "regex",
        "pattern": ...}`` or ``{"kind": "json_schema", "schema": {...}}``)
        compiled HERE, so a malformed spec rejects the request, never a
        tick. After :meth:`drain` the engine accepts nothing."""
        if self._drained:
            raise RuntimeError(
                "engine is drained (snapshot taken, admission stopped); "
                "restore the snapshot into a fresh engine")
        priority = Priority(priority)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        if prompt.size > self.prefill_len:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the engine's "
                f"prefill_len {self.prefill_len}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.model.max_len:
            raise ValueError(
                f"prompt + new tokens {prompt.size + max_new_tokens} "
                f"exceed max_len {self.model.max_len}")
        if (adapter is not None or constraint is not None) \
                and not self._tenant_on:
            raise ValueError(
                "adapter/constraint need a tenant-enabled engine "
                "(ServeEngine(..., tenant=TenantConfig(...)))")
        if adapter is not None and adapter not in self._registry:
            raise ValueError(
                f"adapter {adapter!r} is not registered "
                f"(known: {self._registry.names})")
        if constraint is not None:
            self._compiled_fsm(constraint)  # validate + warm the cache
        req = Request(prompt=prompt.tolist(),
                      max_new_tokens=int(max_new_tokens),
                      sampling=sampling or SamplingParams(),
                      deadline_s=deadline_s, priority=priority,
                      adapter=adapter, constraint=constraint)
        handle = RequestHandle(req, arrival_s=self._clock())
        try:
            self.scheduler.submit(handle)
        except QueueFull as e:
            self.metrics.record_rejected(priority.value)
            raise QueueFull(
                e.queue_depth, e.max_queue_depth,
                retry_after_s=self.metrics.estimate_retry_after_s(
                    self.scheduler.depth_at_or_above(priority)),
                priority=priority) from None
        if constraint is not None:
            self.metrics.record_constrained()
        self._tracer.on_submit(handle, self.scheduler.depth)
        return handle

    # ------------------------------------------------------------- state
    @property
    def paged(self) -> bool:
        return self._paged

    @property
    def prefix_cache_enabled(self) -> bool:
        return self._prefix_on

    @property
    def host_tier_enabled(self) -> bool:
        """True when the host KV tier is armed (``host_tier=`` with a
        nonzero byte budget)."""
        return self._host is not None

    @property
    def host_tier_bytes_resident(self) -> int:
        """Host bytes the tier holds now (0 with the tier off)."""
        return self._host.bytes_resident if self._host is not None else 0

    @property
    def host_tier_blocks_resident(self) -> int:
        """Demoted blocks resident in the host tier now."""
        return (self._host.blocks_resident if self._host is not None
                else 0)

    @property
    def degraded(self) -> bool:
        """True while an OOM has the prefix cache shed and donations off
        (serving continues on the cold path); re-arms after
        ``degraded_cooldown_s`` without another OOM."""
        return self._degraded

    @property
    def drained(self) -> bool:
        """True once :meth:`drain` snapshotted the engine: admission is
        stopped and ``step()`` returns 0 (restore into a fresh engine)."""
        return self._drained

    @property
    def spec_enabled(self) -> bool:
        """True when the tick is the speculative draft/verify window."""
        return self._spec_on

    @property
    def spec_k(self) -> int:
        return self._spec_k

    @property
    def spec_draft_model_enabled(self) -> bool:
        """True when a draft model drafts; False means the n-gram drafter
        (or speculation off)."""
        return self._draft_on

    # ----------------------------------------------------------- tenancy
    @property
    def tenant_enabled(self) -> bool:
        """True when this engine serves per-request LoRA adapters and
        grammar constraints (`serve/tenant/`)."""
        return self._tenant_on

    @property
    def adapter_registry(self):
        """The engine's :class:`~pddl_tpu_torch.serve.tenant.AdapterRegistry`
        (``None`` on a plain engine). Adapters registered here become
        submittable at once; residency is handled at admission."""
        return self._registry

    @property
    def adapter_pool_resident(self) -> int:
        """Adapters currently device-resident (0 on a plain engine)."""
        return self._apool.resident if self._tenant_on else 0

    def _compiled_fsm(self, spec):
        """Compile (or fetch) the token FSM for a constraint spec dict,
        cached by its canonical key (bounded: client-supplied specs must
        not grow host memory forever). A constraint whose START state
        allows no token and has no eos escape is refused here."""
        key = constraint_key(spec)
        fsm = self._fsm_cache.get(key)
        if fsm is None:
            if self._tenant.token_strings is None:
                raise ValueError(
                    "constrained decoding needs TenantConfig."
                    "token_strings (the token-id -> string vocabulary "
                    "grammar compilation maps masks through)")
            fsm = compile_constraint(spec, self._tenant.token_strings)
            if len(self._fsm_cache) >= 256:
                self._fsm_cache.pop(next(iter(self._fsm_cache)))
            self._fsm_cache[key] = fsm
        if fsm.is_dead_end(fsm.start, self.eos_token):
            raise ValueError(
                "constraint admits no first token over this engine's "
                "vocabulary (it matches only the empty string, and the "
                "engine has no eos token to emit)")
        return fsm

    def _acquire_adapter(self, name: str, fresh: bool = True) -> int:
        """Resolve an adapter name to a PINNED device pool row, loading
        the factors on a cold miss (LRU-evicting an unpinned row under
        pressure). The pool's floor (``max_slots + 1``) keeps a live mix
        from exhausting it. ``fresh=False`` marks a replay re-admission
        (pool traffic counted, per-tenant request volume not). An
        unresolvable shortfall escalates as :class:`_SlotStateLost`, so
        admission charges a replay instead of crashing the step."""
        row = self._apool.lookup(name)
        if row is not None:
            self.metrics.record_adapter_hit(name, self._apool.resident,
                                            fresh=fresh)
            self._apool.pin(row)
            return row
        try:
            adapter = self._registry.get(name)
        except KeyError as e:
            raise _SlotStateLost("adapter_admit", e) from e
        try:
            row = self._apool.assign(name)
        except AdapterPoolExhausted as e:
            raise _SlotStateLost("adapter_admit", e) from e
        try:
            self._device_call("adapter_load", adapter_pool_load,
                              self._apool_a, self._apool_b, row,
                              torch.from_numpy(adapter.a),
                              torch.from_numpy(adapter.b))
        except _SlotStateLost:
            self._apool.unassign(row)
            raise
        self.metrics.record_adapter_load(name, self._apool.resident,
                                         self._apool.evictions, fresh=fresh)
        self._apool.pin(row)
        return row

    def _release_adapter(self, row) -> None:
        """Unpin a slot's (or a failed admission's) adapter row; row 0
        (identity / no adapter) is a no-op."""
        if self._tenant_on and int(row) != 0:
            self._apool.unpin(int(row))

    def _tenant_admit(self, handle):
        """The tenant half of one admission: ``(pinned_adapter_row,
        compiled_fsm_or_None)``; ``(0, None)`` on a plain engine. Raises
        :class:`_SlotStateLost` (self-unwound) on unresolvable specs or
        pools."""
        if not self._tenant_on:
            return 0, None
        req = handle.request
        fsm = None
        if req.constraint is not None:
            try:
                fsm = self._compiled_fsm(req.constraint)
            except ValueError as e:
                raise _SlotStateLost("constraint_admit", e) from e
        # "Fresh" means this request's FIRST service: a replay charged
        # before its first token has no tokens but a replay count.
        fresh = not handle.tokens and not handle.replays
        arow = (self._acquire_adapter(req.adapter, fresh=fresh)
                if req.adapter is not None else 0)
        return arow, fsm

    def _adapted(self, logits: torch.Tensor, feats: torch.Tensor,
                 rows: Optional[torch.Tensor]) -> torch.Tensor:
        """``logits`` plus the LoRA deltas of the pool rows ``rows`` (on
        the card) over ``feats`` (``[B, d]`` or a window ``[B, W, d]``);
        ``rows=None`` adds nothing (every row is the identity, whose
        delta is an exact f32 zero)."""
        if rows is None:
            return logits
        return logits + batched_lora_delta(feats, self._apool_a,
                                           self._apool_b, rows)

    def _stage_rows(self) -> Optional[torch.Tensor]:
        """The card's copy of the slots' adapter rows, restaged only when
        one changed; ``None`` when every slot is on the identity row (the
        host knows it, and the tick then skips the delta). Called before
        a forward is queued, as :meth:`_stage_masks` is."""
        if not self._arow.any():
            return None
        if self._arow_dev is None:
            self._arow_dev = torch.from_numpy(self._arow).to(self.device)
        return self._arow_dev

    def _stage_masks(self, window: bool = False):
        """The card's copy of the tick's ``[S, V]`` masks (or the verify
        window's ``[S, spec_k+1, V]``), restaged only when a host row
        changed; ``None`` when no constrained stream is live, as the
        all-True masks then pass the logits through unchanged. Called
        before a forward is queued: a host-to-device copy waits for the
        stream."""
        if all(f is None for f in self._fsms):
            return None
        if window:
            if self._masks_w_dev is None or self._masks_w_dirty:
                self._masks_w_dev = torch.from_numpy(self._masks_w).to(
                    self.device)
                self._masks_w_dirty = False
                self.metrics.mask_restages += 1
            return self._masks_w_dev
        if self._masks_dev is None or self._masks_dirty:
            self._masks_dev = torch.from_numpy(self._masks).to(self.device)
            self._masks_dirty = False
            self.metrics.mask_restages += 1
        return self._masks_dev

    def _set_mask(self, sid: int, row: Optional[np.ndarray]) -> None:
        """Stamp slot ``sid``'s allow row (``None``: all-True), marking
        the card's copy stale only when the row changed (a state that
        loops on itself keeps its row, and the card its copy)."""
        if row is None:
            if self._masks[sid].all():
                return
            row = True
        elif np.array_equal(self._masks[sid], row):
            return
        self._masks[sid] = row
        self._masks_dirty = True

    @property
    def blocks_shared(self) -> int:
        """Pool blocks referenced by MORE THAN ONE live slot's table right
        now (ids are unique within a row, so a count > 1 means > 1
        slot); 0 outside paged mode."""
        if not self._paged:
            return 0
        live = [sid for sid, h in enumerate(self._slots) if h is not None]
        if len(live) < 2:
            return 0
        rows = self._tables[live]
        _, counts = np.unique(rows[rows != 0], return_counts=True)
        return int((counts > 1).sum())

    @property
    def block_table_fill(self) -> float:
        """Mean fraction of live slots' table entries that point at real
        (non-scratch) blocks; 0.0 outside paged mode."""
        if not self._paged:
            return 0.0
        live = [sid for sid, h in enumerate(self._slots) if h is not None]
        if not live:
            return 0.0
        return float((self._tables[live] != 0).mean())

    def resident_kv_report(self) -> dict:
        """Live-stream KV accounting, comparable across the two modes:

        - ``tokens_resident``: summed depth of every live stream;
        - ``kv_bytes_used``: device bytes holding that state — the row
          engine pays each live slot's depth privately plus one pool copy
          of every cached block; the paged engine pays each distinct
          referenced block once;
        - ``kv_bytes_allocated``: the reserved footprint (slot cache +
          pool, or the paged pool).

        The port's caches hold K/V only: ``kv_bytes_allocated`` is the
        JAX engine's less its position-counter (and block-table) leaves.
        """
        live = [sid for sid, h in enumerate(self._slots) if h is not None]
        tokens = int(sum(int(self._positions[sid]) for sid in live))
        allocated = pool_nbytes(self._cache)
        if self._paged:
            distinct = set()
            for sid in live:
                distinct.update(int(b) for b in self._tables[sid] if b != 0)
            used = (len(distinct) * self.prefix_block_size
                    * self._kv_token_bytes)
            return {"tokens_resident": tokens, "kv_bytes_used": used,
                    "kv_bytes_allocated": allocated}
        used = tokens * self._kv_token_bytes
        if self._prefix_on:
            used += (self._prefix.blocks_live * self.prefix_block_size
                     * self._kv_token_bytes)
            allocated += pool_nbytes(self._pool)
        return {"tokens_resident": tokens, "kv_bytes_used": used,
                "kv_bytes_allocated": allocated}

    @property
    def prefix_pool_nbytes(self) -> int:
        """Device bytes the KV block pool holds: the row engine's prefix
        pool (0 with the cache off), or the paged engine's whole pool."""
        if self._paged:
            return pool_nbytes(self._cache)
        return pool_nbytes(self._pool) if self._prefix_on else 0

    @property
    def live_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def has_work(self) -> bool:
        if self._drained:
            return False
        return (self.live_slots > 0 or self.scheduler.depth > 0
                or bool(self._admitting))

    def _free_slot_ids(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _evict(self, slot_id: int, state: RequestState,
               reason: FinishReason) -> None:
        handle = self._slots[slot_id]
        handle.state = state
        handle.finish_reason = reason
        handle.finish_s = self._clock()
        self.metrics.record_finish(reason.value,
                                   handle.request.priority.value)
        self._tracer.on_finish(handle, reason.value)
        self._park_slot(slot_id)

    def _park_slot(self, slot_id: int) -> None:
        """Vacate a slot at position 0 with greedy parameters, and release
        its pin on the donated prompt chain (the blocks stay cached,
        LRU-evictable). A row's next junk writes land at position 0, and
        the next admission overwrites the whole row. Paged: the table row
        goes all-scratch (junk lands in the sink) and the slot's PRIVATE
        blocks — tail and generated tokens, never shared — return to the
        free list. A tenant slot releases its adapter pin (the factors
        stay resident, LRU-evictable once no live slot needs them) and
        its masks go back to all-True, a bitwise pass-through."""
        self._slots[slot_id] = None
        if self._tenant_on:
            self._release_adapter(self._arow[slot_id])
            if self._arow[slot_id]:
                self._arow[slot_id] = 0
                self._arow_dev = None
            self._set_mask(slot_id, None)
            if self._masks_w is not None \
                    and not self._masks_w[slot_id].all():
                self._masks_w[slot_id] = True
                self._masks_w_dirty = True
            self._fsms[slot_id] = None
        if self._private[slot_id]:
            self._prefix.release(self._private[slot_id])
            self._private[slot_id] = []
        if self._paged:
            self._tables[slot_id, :] = 0
        if self._slot_nodes[slot_id] is not None:
            self._prefix.unpin(self._slot_nodes[slot_id])
            self._slot_nodes[slot_id] = None
        self._positions[slot_id] = 0
        self._tokens[slot_id] = 0
        self._temps[slot_id] = 0.0
        self._top_ks[slot_id] = 0
        self._top_ps[slot_id] = 2.0

    # ---------------------------------------------------- fault handling
    def _device_call(self, site: str, fn, *args):
        """The ONE guarded device-call boundary: consult the fault plan,
        classify failures, retry transients with bounded exponential
        backoff, flip degraded on OOM (never a blind retry: an allocation
        failure will not pass until memory is shed), and escalate to
        :class:`_SlotStateLost` when the budget runs out. ``KillPoint`` is
        a BaseException and passes through. Injected faults fire BEFORE
        ``fn`` runs, so a retry never meets a half-written tensor; a REAL
        error from a call that writes a resident tree in place is never
        re-dispatched — it escalates at once, tagged with that tree, so
        the recovery rebuilds it. Errors :func:`classify` does not know
        (a CUDA error other than the allocator's OOM, a bug) propagate."""
        attempt = 0
        while True:
            try:
                if self._faults is not None:
                    self._faults.check(site)
                self._note_signature(site, args)
                t0 = time.perf_counter()
                out = fn(*args)
                # Host wall time of the call (an asynchronous launch's
                # enqueue, plus any copy to the host it waits for),
                # summed per site into the step's telemetry record and
                # handed to the tracer's prefill-chunk events.
                dt = time.perf_counter() - t0
                self._site_wall[site] = self._site_wall.get(site, 0.0) + dt
                self._last_wall_s = dt
                return out
            except Exception as e:
                kind = classify(e)
                if kind is None:
                    raise  # not a device fault: bugs stay loud
                injected = isinstance(e, (InjectedTransientError,
                                          InjectedResourceExhausted))
                consumed = (None if injected
                            else self._donated_by_site.get(site))
                if kind == "oom":
                    self._enter_degraded()
                    raise _SlotStateLost(site, e, consumed) from e
                if consumed is not None:
                    raise _SlotStateLost(site, e, consumed) from e
                attempt += 1
                if attempt > self._max_retries:
                    raise _SlotStateLost(site, e) from e
                self.metrics.record_retry(site)
                self._tracer.on_retry(self._cur_step, site, attempt)
                self._backoff_sleep(
                    self._retry_backoff_s * (2 ** (attempt - 1)))

    def _note_signature(self, site: str, args) -> None:
        """Count the input signature ``site`` is entered with (the
        census :meth:`compile_counts` reads). The tick reads its inputs
        from the engine, so its signature is taken over them; the verify
        leaves out the tenant engine's optional masks and adapter rows."""
        if site == "tick":
            args = (self._cache, self._positions, self._tables,
                    self._tokens, self._temps, self._top_ks, self._top_ps)
        elif site == "verify":
            args = (self._cache,) + tuple(args[:5])
        self._site_sigs.setdefault(site, set()).add(_signature(args))

    def _izeros(self, *shape) -> torch.Tensor:
        """An int32 zero tensor on the engine's device (warmup's dummy
        tokens, tables, positions and caps)."""
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def _warm_call(self, site: str, fn, *args):
        """One warmup call: counted in the census, outside the fault
        plan, the retries and the per-site wall (warmup is not traffic)."""
        self._note_signature(site, args)
        return fn(*args)

    @torch.no_grad()
    def warmup(self) -> None:
        """Run every site once with its serving shapes before traffic, so
        every kernel the engine will launch is built and loaded (K4
        through ``ops/_kernels.py`` on a paged engine, on the card): one
        dummy admission into slot 0 and one tick with every slot dead.
        No trace is left: the junk K/V lands at parked positions (row
        mode: the slot insert overwrites whole rows) or in the scratch
        sink (paged: all-scratch tables); the dummy gather and donation
        use only the scratch block, so the radix index stays empty and
        no slot is taken; the metrics, the telemetry, the tracer and the
        fault plan are not touched, and the sampling generator's state is
        put back. Idempotent; :meth:`step` calls it implicitly."""
        if self._warm:
            return
        rng_state = self._rng.get_state()
        zeros = self._izeros
        if self._tenant_on:
            # The identity row takes zeros: its content is unchanged.
            self._warm_call(
                "adapter_load", adapter_pool_load, self._apool_a,
                self._apool_b, 0,
                torch.zeros((self.model.embed_dim, self._registry.rank)),
                torch.zeros((self._registry.rank, self.model.vocab_size)))
        if self._paged:
            t1 = zeros(1, self._table_width)
            _, logits, _ = self._warm_call(
                "chunk_prefill", prefill_row_features, self.model,
                zeros(1, self._chunk), 1, self._cache, 0, t1)
            if self._has_wide:
                _, logits, _ = self._warm_call(
                    "chunk_prefill_wide", prefill_row_features, self.model,
                    zeros(1, self.prefill_len), 1, self._cache, 0, t1)
            if self._host is not None:
                self._warm_call(
                    "host_promote", self._promote_rows,
                    self._assemble_promote_rows([]),
                    np.zeros(self._match_cap, np.int64))
        elif self._prefix_on:
            scratch = [0] * self._match_cap
            self._warm_call("gather", gather_prefix_into_row, self._pool,
                            self._row, scratch)
            _, logits, _ = self._warm_call(
                "chunk_prefill", prefill_row_features, self.model,
                zeros(1, self._chunk), 1, self._row, 0, None)
            if self._has_wide:
                _, logits, _ = self._warm_call(
                    "chunk_prefill_wide", prefill_row_features, self.model,
                    zeros(1, self.prefill_len), 1, self._row, 0, None)
            self._warm_call("donate", donate_prefix_blocks, self._pool,
                            self._row, [0] * self._donate_cap, 0)
            if self._host is not None:
                self._warm_call(
                    "host_promote", self._promote_rows,
                    self._assemble_promote_rows([]),
                    np.zeros(self._match_cap, np.int64))
            self._warm_call("insert", insert_cache_slot, self._cache,
                            self._row, 0)
        else:
            row, logits, _ = self._warm_call(
                "prefill", prefill_row_features, self.model,
                zeros(1, self.prefill_len), 1)
            self._warm_call("insert", insert_cache_slot, self._cache, row, 0)
        self._warm_call("sample_first", self._sample_first, logits, None,
                        0.0, 0, 2.0)
        if self._spec_on:
            self._warm_spec()
        else:
            self._warm_call("tick", self._tick)
        self._rng.set_state(rng_state)
        self._warm = True

    def _warm_spec(self) -> None:
        """The draft/verify pair (and the draft model's admission chunk)
        with all-dead inputs: caps 0 and forced -1 accept nothing, and the
        junk writes land at parked positions or in the scratch sink."""
        s, k = self.max_slots, self._spec_k
        forced_tok = np.zeros((s, k), np.int32)
        forced_n = np.full(s, -1, np.int32)
        zeros = self._izeros
        table = zeros(s, self._table_width) if self._paged else None
        if self._draft_on:
            self._warm_call("draft_prefill", self._draft_chunk,
                            zeros(1, self._chunk), 0,
                            zeros(1, self._table_width))
        self._warm_call("draft", self._draft_tokens, zeros(s), zeros(s, 1),
                        table, forced_tok, forced_n)
        self._warm_call("verify", self._verify, zeros(s, k + 1), zeros(s),
                        table, zeros(s), zeros(s) - 1, None, None)

    def compile_counts(self) -> Dict[str, int]:
        """The program census, with the JAX engine's keys for this
        configuration: per site, the number of distinct input signatures
        (the shapes and dtypes of the tensors its JAX program takes) it
        was entered with since construction. Every entry reads 1 after
        :meth:`warmup` and stays there on a shape-closed engine: the
        zero-recompiles-after-warmup contract."""
        return {site: len(self._site_sigs.get(site, ()))
                for site in self._program_sites()}

    def _program_sites(self) -> List[str]:
        """The JAX engine's resident programs in this configuration."""
        if self._paged:
            sites = ["sample_first", "chunk_prefill"]
            if self._spec_on:
                sites += ["verify", "draft"]
                if self._draft_on:
                    sites.append("draft_prefill")
            else:
                sites.append("tick")
            if self._has_wide:
                sites.append("chunk_prefill_wide")
            if self._tenant_on:
                sites.append("adapter_load")
            if self._host is not None:
                sites.append("host_promote")
            return sites
        sites = ["insert", "sample_first"]
        sites += ["verify", "draft"] if self._spec_on else ["tick"]
        if self._tenant_on:
            sites.append("adapter_load")
        if self._prefix_on:
            sites += ["gather", "chunk_prefill"]
            if self._has_wide:
                sites.append("chunk_prefill_wide")
            sites.append("donate")
            if self._host is not None:
                sites.append("host_promote")
        else:
            sites.append("prefill")
        return sites

    def _enter_degraded(self) -> None:
        """OOM response: flush every unpinned prefix block from the index
        (the sheddable consumer; the freed ids' storage stays allocated,
        as in the JAX engine), stop donations, keep serving on the cold
        path. A repeat OOM pushes the re-arm time out."""
        now = self._clock()
        if not self._degraded:
            self._degraded = True
            self._degraded_entered_s = now
            self.metrics.record_degraded_entry()
            self._tracer.on_degraded_entry(self._cur_step)
            if self._prefix_on:
                self._prefix.flush_unpinned()
        self._degraded_until_s = now + self._degraded_cooldown_s

    def _maybe_rearm_degraded(self) -> None:
        now = self._clock()
        if self._degraded and now >= self._degraded_until_s:
            self._degraded = False
            self.metrics.record_degraded_exit(now - self._degraded_entered_s)
            self._tracer.on_degraded_exit(
                self._cur_step, now - self._degraded_entered_s)

    def _reset_prefix_pool(self) -> None:
        """A REAL failure of a call that writes the row engine's pool may
        have left it half-written: zero it in place (the JAX engine's
        fresh zeros, without a second allocation) and start a fresh index,
        since every stored chain points into it. Live slots keep decoding
        from their private rows; their pins die with the old index."""
        if not self._prefix_on:
            return
        _zero(self._pool)
        self._prefix = RadixPrefixCache(self.prefix_block_size,
                                        self._prefix.num_blocks)
        self._slot_nodes = [None] * self.max_slots
        if self._host is not None:
            # The old index died without demoting; the fresh one demotes.
            # The tier's host copies survive and stay promotable.
            self._prefix.on_evict = self._demote_blocks

    def _reset_paged_pool(self) -> None:
        """Rebuild the paged world after its one tree may have been
        half-written (or live K/V presumed lost): the pool (and a draft
        model's tree) zeroed in place, a fresh index, every table back to
        scratch, all private ownership dropped. Callers park and replay
        the live slots FIRST — their K/V lived here."""
        _zero(self._cache)
        if self._draft_on:
            _zero(self._dcache)
        self._prefix = RadixPrefixCache(self.prefix_block_size,
                                        self._prefix.num_blocks)
        self._tables[:] = 0
        self._private = [[] for _ in range(self.max_slots)]
        self._slot_nodes = [None] * self.max_slots
        if self._host is not None:
            self._prefix.on_evict = self._demote_blocks

    def _recover_consumed(self, lost: _SlotStateLost) -> None:
        """Rebuild whatever resident tree a real mid-call error may have
        half-written (``_SlotStateLost.consumed``). The admission row is
        rebuilt by the admission unwind; the slot cache's rebuild is a
        full live-slot replay; in paged mode every such tree is the one
        pool holding all live K/V, so recovery is the live-slot replay."""
        if lost.consumed == "cache":
            self._lose_live_slots()
        elif lost.consumed == "pool":
            if self._paged:
                self._lose_live_slots()
            else:
                self._reset_prefix_pool()

    def _mark_replay(self, handle: RequestHandle) -> bool:
        """Charge one replay against ``handle``; True = requeue it for a
        slot-state rebuild, False = replay budget exhausted, the request
        settled FAILED/ERROR (the engine keeps serving everyone else)."""
        handle.replays += 1
        handle.replay_pending = []
        if handle.replays > self._max_replays:
            handle.state = RequestState.FAILED
            handle.finish_reason = FinishReason.ERROR
            handle.finish_s = self._clock()
            self.metrics.record_finish(FinishReason.ERROR.value,
                                       handle.request.priority.value)
            self._tracer.on_replay(handle, self._cur_step, False)
            self._tracer.on_finish(handle, FinishReason.ERROR.value)
            return False
        self.metrics.record_replay()
        self._tracer.on_replay(handle, self._cur_step, True)
        return True

    def _lose_live_slots(self) -> None:
        """The tick's (or a cache-writing call's) retry budget ran out:
        every live slot's K/V must be presumed gone. Park every live slot
        (releasing its pins into the old index), rebuild the slot cache
        or the paged world in place, and requeue the live requests in the
        front lane for replay; each rebuilds token-exactly from its prompt
        and emitted tokens at re-admission."""
        requeue: List[RequestHandle] = []
        for sid, handle in enumerate(self._slots):
            if handle is None:
                continue
            self._park_slot(sid)
            if self._mark_replay(handle):
                requeue.append(handle)
        if self._paged:
            # A parked slice holds private ids and a pinned node of the
            # index about to be retired: drop it without releasing them
            # (a release would double-own the ids in the fresh free list).
            # Its handle is still at the head of `_admitting`, so the next
            # step admits it again from scratch against the fresh pool.
            # Its adapter pin outlives the reset and unwinds now.
            if self._slice is not None:
                self._release_adapter(self._slice["arow"])
            self._slice = None
            self._reset_paged_pool()
        else:
            _zero(self._cache)
        self.scheduler.requeue_front(requeue)

    def _expired(self, handle: RequestHandle, now: float) -> bool:
        return (handle.request.deadline_s is not None
                and now - handle.arrival_s > handle.request.deadline_s)

    def _reap(self) -> None:
        """Cancellations and deadlines, checked at tick granularity."""
        now = self._clock()
        for sid, handle in enumerate(self._slots):
            if handle is None:
                continue
            if handle.cancelled:
                self._evict(sid, RequestState.CANCELLED,
                            FinishReason.CANCELLED)
            elif self._expired(handle, now):
                self._evict(sid, RequestState.TIMED_OUT,
                            FinishReason.TIMED_OUT)

    # ---------------------------------------------------------- admission
    def _match_blocks(self, prompt) -> int:
        """Cap on the matchable chain for one prompt (blocks): leave at
        least one suffix token."""
        return min(self._match_cap,
                   (len(prompt) - 1) // self.prefix_block_size)

    def _prefill_cost(self, handle) -> int:
        """Admission-budget charge: the UNCACHED suffix length (a pop-time
        estimate; the match at prefill time is authoritative). Blocks the
        host tier will promote charge ``promote_tokens_per_block`` each
        instead of ``block_size``; degraded mode charges the whole prompt
        (the cache is not consulted on the cold path)."""
        prompt = handle.request.prompt
        if self._degraded or not self._prefix_on:
            cost = len(prompt)
        else:
            match = self._prefix.match(prompt,
                                       max_blocks=self._match_blocks(prompt))
            cost = len(prompt) - match.n_blocks * self.prefix_block_size
            if self._host is not None:
                h = self._host.match_depth(
                    prompt, match.n_blocks,
                    self._match_blocks(prompt) - match.n_blocks)
                if h > 0:
                    cost -= h * self.prefix_block_size
                    cost += h * self._host_promote_tokens
        # A COLD adapter load is admission-path work (a host-to-device
        # factor copy), charged like an uncached suffix; a resident one,
        # like a cached prefix, costs nothing.
        if (self._tenant_on and handle.request.adapter is not None
                and self._apool.row_of(handle.request.adapter) is None):
            cost += int(self._tenant.adapter_load_tokens)
        # A speculative engine charges a replayed stream's re-feed at its
        # accepted (emitted) tokens, never the drafted window's compute.
        if self._spec_on and handle.tokens:
            cost += len(handle.tokens)
        return cost

    # ---------------------------------------------------- host KV tier
    def _demote_blocks(self, victims) -> None:
        """``radix.on_evict`` hook — eviction becomes demotion: spill the
        dying blocks' K/V into the host tier when their chains are
        reuse-worthy, the whole reclaim in one gather and one
        device-to-host copy (:meth:`_gather_blocks_host`). Opportunistic:
        a refused or failed spill degrades to free-and-recompute, never to
        an error, and degraded mode spills nothing."""
        if self._degraded:
            return
        keep = []
        for node in victims:
            if not self._host.spill_worthy(self._prefix.chain_depth(node)):
                continue
            tokens = self._prefix.chain_tokens(node)
            if self._host.has_block(tokens):
                continue  # kept across a promotion: nothing to move
            keep.append((tokens, node.block_id))
        if not keep:
            return
        try:
            blocks = self._gather_blocks_host([bid for _, bid in keep])
        except Exception as e:  # noqa: BLE001 - device faults only
            if classify(e) is None:
                raise  # not a device fault: bugs stay loud
            return
        for (tokens, _), data in zip(keep, blocks):
            if self._host.store(tokens, data):
                self.metrics.record_host_spill(self._host.bytes_resident)

    def _gather_blocks_host(self, block_ids) -> List[Dict[str, torch.Tensor]]:
        """Pool blocks ``block_ids`` as per-block host payload dicts keyed
        by leaf path: one ``cache_blocks_gather`` per leaf into one stacked
        tensor, ONE device-to-host copy (complete on return, before any of
        the freed ids can be reallocated and overwritten), then host-side
        per-block copies (so a shed sibling cannot keep the batch buffer
        alive)."""
        bs = self.prefix_block_size
        items = list(kv_leaf_items(self._tier_target()))
        ids = torch.as_tensor(list(block_ids), dtype=torch.int64)
        host = torch.stack([cache_blocks_gather(leaf, ids)
                            for _, leaf in items]).cpu()
        return [{key: host[i, ..., j * bs:(j + 1) * bs, :].clone()
                 for i, (key, _) in enumerate(items)}
                for j in range(len(block_ids))]

    def _assemble_promote_rows(self, blocks) -> torch.Tensor:
        """The ``host_promote`` scatter's source on the host: per KV leaf a
        row ``[1, H_kv, match_cap*bs, D]`` with the promoted payloads at
        ``[0, k*bs)`` and ZEROS beyond (those positions scatter into the
        padded scratch ids, and the paged scratch block stays zero), all
        leaves stacked into one tensor for one host-to-device copy."""
        bs = self.prefix_block_size
        items = list(kv_leaf_items(self._tier_target()))
        _, first = items[0]
        rows = torch.zeros((len(items), 1) + tuple(first.shape[1:-2])
                           + (self._match_cap * bs, first.shape[-1]),
                           dtype=first.dtype)
        for j, block in enumerate(blocks):
            for i, (key, _) in enumerate(items):
                rows[i, ..., j * bs:(j + 1) * bs, :] = block[key]
        return rows

    def _promote_rows(self, rows: torch.Tensor, ids: np.ndarray) -> None:
        """The promotion's device half: one host-to-device copy of the
        stacked rows, then one ``cache_blocks_scatter`` per leaf into the
        pool blocks ``ids`` (scratch-padded)."""
        dev = rows.to(self.device)
        for i, (_, leaf) in enumerate(kv_leaf_items(self._tier_target())):
            cache_blocks_scatter(leaf, dev[i], ids, 0)

    def _promote_host_chain(self, prompt: np.ndarray, handle) -> int:
        """Promotion: extend the device match with host-tier blocks —
        allocate device ids under the ANCHOR's pin, scatter the payloads
        (the ``host_promote`` site) and attach the ids to the radix index,
        so the admission that follows matches a deeper chain. Every exit
        (allocator shortfall, injected fault, real error) releases its ids
        and both pins exactly. ``handle`` is the admission's request (for
        the tracer). Returns the promoted block count."""
        if self._degraded:
            return 0
        cap = self._match_blocks(prompt)
        match = self._prefix.match(prompt, max_blocks=cap)
        if match.n_blocks >= cap:
            return 0
        tip = self._host.pin_chain(prompt, match.n_blocks,
                                   cap - match.n_blocks)
        promoted = 0
        if tip is not None:
            try:
                promoted = self._promote_pinned(prompt, match, tip,
                                                handle)
            finally:
                self._host.unpin(tip)
        return promoted

    def _promote_pinned(self, prompt: np.ndarray, match, tip,
                        handle) -> int:
        """The host-to-device half of a promotion under the caller's
        host-tier pin: allocate device ids beneath the ANCHOR's pin
        (eviction must not steal the chain the ids extend), dispatch the
        scatter, attach the ids."""
        bs = self.prefix_block_size
        m = match.n_blocks
        anchor = match.node
        self._prefix.pin(anchor)
        try:
            ids = self._prefix.allocate(tip.depth - m)
            k = len(ids)
            if k == 0:
                return 0
            node = tip
            while node.depth > m + k:  # the allocator came up short:
                node = node.parent     # promote the prefix that fits
            rows = self._assemble_promote_rows(
                self._host.chain_data(node, k))
            dids = np.zeros(self._match_cap, np.int64)
            dids[:k] = ids
            try:
                self._device_call("host_promote", self._promote_rows, rows,
                                  dids)
            except _SlotStateLost:
                self._prefix.release(ids)
                raise
            self._prefix.extend(anchor, prompt[m * bs:(m + k) * bs], ids)
            self.metrics.record_host_promotion(
                k, k * self._host_promote_tokens, self._host.bytes_resident)
            self._tracer.on_prefill_chunk(handle, "host_promote", m * bs,
                                          k * bs, self._last_wall_s)
            return k
        finally:
            self._prefix.unpin(anchor)

    def _chunk_loop(self, prompt: np.ndarray, off: int, handle, cache,
                    table=None):
        """The suffix chunk loop and its width policy, one for the row and
        paged admissions (each forward pays a fixed cost plus per-token
        compute): a long remainder (>= 3/4 of the wide width) takes the
        WIDE chunk in one forward (the ``chunk_prefill_wide`` site), short
        suffixes — the prefix-hit case — take narrow chunks
        (``chunk_prefill``) and pay only for the uncached tail. Each chunk
        continues ``cache`` (the admission row, or the paged pool through
        ``table``) in place; returns the last chunk's logits and features
        at its last token."""
        plen = int(prompt.size)
        logits = feats = None
        while off < plen:
            rem = plen - off
            if self._has_wide and 4 * rem >= 3 * self.prefill_len:
                width, site = self.prefill_len, "chunk_prefill_wide"
            else:
                width, site = self._chunk, "chunk_prefill"
            w = min(width, rem)
            chunk_toks = np.zeros((1, width), np.int32)
            chunk_toks[0, :w] = prompt[off:off + w]
            _, logits, feats = self._device_call(
                site, prefill_row_features, self.model,
                torch.from_numpy(chunk_toks).to(self.device), w, cache, off,
                table)
            self._tracer.on_prefill_chunk(handle, site, off, w,
                                          self._last_wall_s)
            off += w
        return logits, feats

    def _prefill_into_row(self, prompt: np.ndarray, handle):
        """Prefill one prompt into a row cache, reusing any cached prefix:
        promote a host-tier continuation first, gather the matched chain
        into the resident admission row, chunk-prefill the suffix, donate
        the prompt's uncovered full blocks and pin the chain. With the
        prefix cache off, one padded prefill on a fresh row; degraded, a
        cold chunked prefill that neither reads nor grows the cache.
        ``handle`` is the admission's request (each call lands on its
        span). Returns ``(row_cache, last_logits, last_feats,
        pinned_node_or_None)``."""
        plen = int(prompt.size)
        bs = self.prefix_block_size
        if not self._prefix_on:
            padded = np.zeros((1, self.prefill_len), np.int32)
            padded[0, :plen] = prompt
            row, logits, feats = self._device_call(
                "prefill", prefill_row_features, self.model,
                torch.from_numpy(padded).to(self.device), plen)
            self._tracer.on_prefill_chunk(handle, "prefill", 0, plen,
                                          self._last_wall_s)
            return row, logits, feats, None
        if self._host is not None:
            self._promote_host_chain(prompt, handle)
        use_prefix = not self._degraded
        match, n_cached = None, 0
        if use_prefix:
            match = self._prefix.match(prompt,
                                       max_blocks=self._match_blocks(prompt))
            n_cached = match.n_blocks * bs
            self._tracer.on_prefix_match(handle, match.n_blocks, n_cached)
        if n_cached > 0:
            # Everything past the gathered prefix is stale: the chunks
            # overwrite it, or it parks past the position the insert
            # stamps. A full miss gathers nothing.
            self._gather_row(match, handle)
        logits, feats = self._chunk_loop(prompt, n_cached, handle,
                                         self._row)
        if not use_prefix:
            return self._row, logits, feats, None
        node = self._donate_tail(prompt, match, n_cached)
        return self._row, logits, feats, node

    def _gather_row(self, match, handle) -> None:
        """Copy the matched chain's pool blocks into the admission row
        (the ``gather`` site)."""
        n_cached = match.n_blocks * self.prefix_block_size
        self._device_call("gather", gather_prefix_into_row, self._pool,
                          self._row, match.block_ids)
        self.metrics.copy_bytes_gathered += n_cached * self._kv_token_bytes
        self._tracer.on_prefill_chunk(handle, "gather", 0, n_cached,
                                      self._last_wall_s)

    def _donate_tail(self, prompt: np.ndarray, match, n_cached: int):
        """Donate the prompt's uncovered FULL blocks and pin the chain.
        ``match`` must be CURRENT (a sliced admission matches again at its
        finish: ticks ran between its slices, and an OOM flush may have
        detached a node matched at its start).
        First descend any chain ALREADY stored past the (capped) gather
        match — those blocks must not be allocated afresh. Pin before
        allocating, so this admission's own eviction pass can never free
        the blocks just gathered from; the pool copy (the ``donate`` site)
        runs before ``extend`` attaches the ids, so a fault leaves the
        index pointing at no junk. Returns the pinned node."""
        bs = self.prefix_block_size
        node, stored = self._prefix.descend(match.node, prompt,
                                            match.n_blocks)
        self._prefix.pin(node)
        want = len(prompt) // bs - stored
        if want > 0:
            new_ids = self._prefix.allocate(min(want, self._donate_cap))
            if new_ids:
                try:
                    self._device_call("donate", donate_prefix_blocks,
                                      self._pool, self._row, new_ids, stored)
                except _SlotStateLost:
                    self._prefix.release(new_ids)
                    self._prefix.unpin(node)
                    raise
                self.metrics.copy_bytes_donated += (
                    len(new_ids) * bs * self._kv_token_bytes)
                tip = self._prefix.extend(
                    node, prompt[stored * bs:(stored + len(new_ids)) * bs],
                    new_ids)
                self._prefix.unpin(node)
                self._prefix.pin(tip)
                node = tip
        self.metrics.record_prefix_lookup(
            n_cached, blocks_live=self._prefix.blocks_live,
            evictions=self._prefix.evictions)
        return node

    def _paged_match_and_allocate(self, prompt: np.ndarray, handle):
        """promote → match → pin → allocate private suffix blocks → stamp
        the table row. The pin lands BEFORE any allocation, so an eviction
        during this admission can never take a matched block from under
        it; degraded mode skips the index (every block private). Returns
        ``(pinned_node_or_None, n_matched_blocks, table_row [T],
        private_ids)``; raises :class:`_SlotStateLost` unwound on a
        shortfall."""
        plen = int(prompt.size)
        bs = self.prefix_block_size
        table_row = np.zeros(self._table_width, np.int32)
        node, m = None, 0
        if self._host is not None:
            self._promote_host_chain(prompt, handle)
        if not self._degraded:
            match = self._prefix.match(prompt,
                                       max_blocks=self._match_blocks(prompt))
            m = match.n_blocks
            if m > 0:
                node = match.node
                self._prefix.pin(node)
                table_row[:m] = match.block_ids
            self._tracer.on_prefix_match(handle, m, m * bs)
        need = -(-plen // bs) - m
        private = list(self._prefix.allocate(need)) if need > 0 else []
        if len(private) < need:
            # Everything unpinned is gone and it still does not fit: undo
            # and escalate; the unwind charges a replay.
            self._prefix.release(private)
            if node is not None:
                self._prefix.unpin(node)
            raise _SlotStateLost(
                "paged_alloc",
                RuntimeError(f"block pool exhausted ({need} blocks needed, "
                             f"{len(private)} free/evictable)"))
        table_row[m:m + len(private)] = private
        return node, m, table_row, private

    def _prefill_paged(self, prompt: np.ndarray, handle):
        """A prefix hit PINS the matched chain and points the slot's table
        at it in place; private blocks take the suffix, which the chunks
        write straight into the pool. A lost chunk hands the private
        blocks and the pin back before it propagates. Returns
        ``(last_logits, last_feats, node, table_row, private_ids)``."""
        node, m, table_row, private = self._paged_match_and_allocate(
            prompt, handle)
        n_cached = m * self.prefix_block_size
        use_prefix = not self._degraded
        table = torch.from_numpy(table_row[None]).to(self.device)
        try:
            logits, feats = self._chunk_loop(prompt, n_cached, handle,
                                             self._cache, table)
            if self._draft_on:
                self._draft_prefill_loop(prompt, n_cached, table)
        except _SlotStateLost:
            # An injected fault wrote nothing: hand the resources back. A
            # real error resets the whole paged world right after (the
            # unwind's _recover_consumed), so releasing first is harmless.
            self._prefix.release(private)
            if node is not None:
                self._prefix.unpin(node)
            raise
        if n_cached > 0:
            self.metrics.record_copy_avoided(
                n_cached * self._kv_token_bytes)
        if use_prefix:
            node = self._donate_tail_paged(prompt, node, table_row, private,
                                           m)
            self.metrics.record_prefix_lookup(
                n_cached, blocks_live=self._prefix.blocks_live,
                evictions=self._prefix.evictions)
        return logits, feats, node, table_row, private

    def _draft_prefill_loop(self, prompt: np.ndarray, off: int,
                            table) -> None:
        """Chunk-prefill the uncached suffix through the DRAFT model into
        its tree (the ``draft_prefill`` site), narrow chunks only, at the
        target's offsets and blocks: a donated shared block then carries
        valid draft K/V for every later hit, beside the target's. Only K/V
        is wanted: the head is skipped."""
        plen = int(prompt.size)
        while off < plen:
            w = min(self._chunk, plen - off)
            chunk_toks = np.zeros((1, self._chunk), np.int32)
            chunk_toks[0, :w] = prompt[off:off + w]
            self._device_call("draft_prefill", self._draft_chunk,
                              torch.from_numpy(chunk_toks).to(self.device),
                              int(off), table)
            off += w

    def _draft_chunk(self, tokens: torch.Tensor, off: int, table) -> None:
        self._draft(tokens, cache=self._dcache, cache_index=off,
                    block_table=table, features_only=True)

    def _donate_tail_paged(self, prompt: np.ndarray, node, table_row,
                           private: List[int], m: int):
        """Donation with ZERO copies: the prompt's full blocks are already
        written in the pool — hand their ownership to the radix index and
        keep the slot's pin on the chain tip. A chain segment the index
        ALREADY stores swaps the slot's table onto the stored blocks (the
        same tokens at the same positions are bit-identical K/V) and the
        duplicates go back to the free list. Returns the pinned tip (or
        ``node`` unchanged when the prompt has no full blocks)."""
        bs = self.prefix_block_size
        full = len(prompt) // bs
        anchor = node if node is not None else self._prefix.match(
            prompt, max_blocks=0).node
        deeper, stored = self._prefix.descend(anchor, prompt, m)
        if stored > m:
            chain = self._prefix.chain_ids(deeper)
            for j in range(m, stored):
                mine = int(table_row[j])
                table_row[j] = chain[j]
                private.remove(mine)
                self._prefix.release([mine])
        if deeper is not anchor or node is None:
            if node is not None:
                self._prefix.unpin(node)
            self._prefix.pin(deeper)
        node = deeper
        if full > stored:
            ids = [int(table_row[j]) for j in range(stored, full)]
            tip = self._prefix.extend(node, prompt[stored * bs:full * bs],
                                      ids)
            chain = self._prefix.chain_ids(tip)
            for j in range(stored, full):
                # extend attaches our block, or (defensively) frees it on
                # a dedup — swap the table either way.
                private.remove(int(table_row[j]))
                table_row[j] = chain[j]
            self._prefix.unpin(node)
            self._prefix.pin(tip)
            node = tip
        return node

    def _admit(self) -> None:
        if self._slice_tokens is not None:
            # The per-STEP prefill allowance: every chunk an admission
            # runs this step draws from it, so the decode tick below is
            # never more than one allowance away.
            self._slice_budget_left = self._slice_tokens
        if self._slice is not None:
            # A prefill parked in an earlier step owns the admission
            # pipeline: advance it first; only once it settles may new
            # admissions start.
            if not self._continue_slice():
                return
        free = self._free_slot_ids()
        if not free:
            free = self._preempt_for_interactive()
            if not free:
                return

        def _queued_cancel(handle):
            handle.finish_s = self._clock()
            self.metrics.record_finish(FinishReason.CANCELLED.value,
                                       handle.request.priority.value)
            self._tracer.on_finish(handle, FinishReason.CANCELLED.value)

        def _queued_expired(handle):
            # Died in the queue: never pay its prefill.
            handle.finish_s = self._clock()
            self.metrics.record_finish(FinishReason.DEADLINE.value,
                                       handle.request.priority.value)
            self._tracer.on_deadline_shed(handle)
            self._tracer.on_finish(handle, FinishReason.DEADLINE.value)

        # The suffix-priced cost_fn walks the radix tree per pop; only pay
        # that when a budget consumes the result.
        use_cost = ((self._prefix_on or self._tenant_on or self._spec_on)
                    and self.scheduler.prefill_token_budget is not None)
        # A kill mid-admission can leave a handle in `_admitting`: it owns
        # the first free slot before anything new is popped.
        self._admitting.extend(self.scheduler.admit(
            len(free) - len(self._admitting), on_cancelled=_queued_cancel,
            on_expired=_queued_expired, now_fn=self._clock,
            cost_fn=self._prefill_cost if use_cost else None))
        while self._admitting and free:
            if (self._slice_tokens is not None
                    and self._slice_budget_left <= 0):
                break  # this step's prefill allowance is spent
            handle = self._admitting[0]
            sid = free.pop(0)
            try:
                if self._slice_tokens is not None:
                    if not self._start_slice(sid, handle):
                        return  # parked: the handle stays in _admitting
                else:
                    self._admit_one(sid, handle)
            except _SlotStateLost as lost:
                free.insert(0, sid)
                self._unwind_admission(lost, handle)
            self._admitting.popleft()

    def _paged_append_blocks(self) -> None:
        """Before a tick: every block a live slot is about to write — at
        its position, and with ``spec_k > 0`` through the verify window's
        ``position + spec_k``, clamped at the table's edge (writes past
        it land in the scratch sink) — gets a fresh PRIVATE block if it
        has none. The allocation LRU-evicts unpinned cached chains under
        pressure; with the pool at its validated floor it cannot fail for
        a live stream, and if a mis-sized pool ever makes it fail, the
        slot is parked and REPLAYED. A window never reaches a shared
        block: every position past the prompt lies in a private block,
        which is checked."""
        bs = self.prefix_block_size
        span = self._spec_k
        for sid, handle in enumerate(self._slots):
            if handle is None:
                continue
            pos = int(self._positions[sid])
            hi = min((pos + span) // bs, self._table_width - 1)
            need = [blk for blk in range(pos // bs, hi + 1)
                    if self._tables[sid, blk] == 0]
            if need:
                ids = self._prefix.allocate(len(need))
                if len(ids) < len(need):
                    self._prefix.release(ids)
                    self._park_slot(sid)
                    if self._mark_replay(handle):
                        self.scheduler.requeue_front([handle])
                    continue
                for blk, bid in zip(need, ids):
                    self._tables[sid, blk] = bid
                    self._private[sid].append(bid)
            if span and not all(int(self._tables[sid, blk])
                                in self._private[sid]
                                for blk in range(pos // bs, hi + 1)):
                raise RuntimeError(
                    f"slot {sid}'s verify window at position {pos} reaches "
                    "a shared block (engine bug)")

    def _preempt_for_interactive(self) -> List[int]:
        """Every slot is busy and ``interactive`` work is queued: park
        running BEST_EFFORT streams (fewest tokens first, the cheapest
        replay) and requeue them through the normal lane; each resumes
        token-exactly later through the replay admission. A handle is
        preempted at most ``preempt_cap`` times, and only ACTUAL
        interactive submissions trigger this (aging promotions and
        replay-lane entries do not), so preemption cannot cascade.
        Returns the freed slot ids."""
        if self._preempt_cap < 1:
            return []
        want = self.scheduler.queued_of_class(Priority.INTERACTIVE)
        if want < 1:
            return []
        victims = sorted(
            ((sid, h) for sid, h in enumerate(self._slots)
             if h is not None
             and h.request.priority is Priority.BEST_EFFORT
             and h.preemptions < self._preempt_cap
             and not h.replay_pending),
            key=lambda p: len(p[1].tokens))
        freed: List[int] = []
        for sid, victim in victims[:want]:
            victim.preemptions += 1
            self.metrics.record_preemption()
            self._tracer.on_preempt(victim, self._cur_step)
            self._park_slot(sid)
            self.scheduler.requeue(victim)
            freed.append(sid)
        return freed

    def _unwind_admission(self, lost: _SlotStateLost,
                          handle: RequestHandle) -> None:
        """A call died during this handle's admission; the per-request
        unwind already released its pins and the slot never became live.
        A parked slice still owns its adapter pin and, paged, its chain
        pin and private blocks: released here (the whole-prompt paths
        release their own before raising, and then no slice was set).
        Zero the resident admission row (a real error may have
        half-written it), rebuild anything else the failed call wrote (the
        slot cache: live-slot replay; the block pool: pool and index), and
        charge the request a replay."""
        sl, self._slice = self._slice, None
        if sl is not None:
            self._release_slice(sl)
        if not self._paged and self._prefix_on:
            _zero(self._row)
        self._recover_consumed(lost)
        if self._mark_replay(handle):
            self.scheduler.requeue_front([handle])

    def _admit_one(self, sid: int, handle: RequestHandle) -> None:
        """Admit one popped request into slot ``sid``. Tenant order: the
        FSM compile and the adapter pin land FIRST, a prefill failure
        releases the pin before it propagates, and the install hands the
        pin to the slot. The adapter's delta is added to the prefill's
        last logits, so the first token comes from the adapted model (a
        replay samples none). The sliced path is :meth:`_start_slice`."""
        self._tracer.on_admit(handle, sid, bool(handle.tokens))
        prompt = np.asarray(handle.request.prompt, np.int32)
        arow, fsm = self._tenant_admit(handle)
        try:
            if self._paged:
                logits, feats, node, table_row, private = \
                    self._prefill_paged(prompt, handle)
            else:
                row, logits, feats, node = self._prefill_into_row(prompt,
                                                                  handle)
        except BaseException:
            self._release_adapter(arow)
            raise
        logits = self._first_logits(logits, feats, arow, handle)
        if self._paged:
            self._install_slot(sid, handle, logits, node,
                               table_row=table_row, private=private,
                               arow=arow, fsm=fsm)
        else:
            self._install_slot(sid, handle, logits, node, row=row,
                               arow=arow, fsm=fsm)

    def _first_logits(self, logits, feats, arow: int, handle):
        """The prefill's last logits a fresh request samples its first
        token from: the adapter's delta added on an adapter row (a replay
        samples none, so its logits pass through)."""
        if arow and not handle.tokens:
            return self._adapted(logits, feats,
                                 torch.tensor([arow], device=self.device))
        return logits

    # ---------------------------------------------------- sliced admission
    def _start_slice(self, sid: int, handle: RequestHandle) -> bool:
        """Begin a sliced admission: the tenant half, then (paged) match,
        pin and allocate every private block now, or (row) promote, match
        and gather now, then chunk-prefill under the step's allowance.
        Returns True when the admission completed within this step's
        allowance; False parks it in ``self._slice`` for the next step,
        the decode tick running in between."""
        prompt = np.asarray(handle.request.prompt, np.int32)
        self._tracer.on_admit(handle, sid, bool(handle.tokens))
        arow, fsm = self._tenant_admit(handle)
        # The adapter pin's owner: before the slice exists nobody else
        # unwinds it; once it exists, the slice does (`_unwind_admission`)
        # or, after it finished, the install's own failure path.
        created = False
        try:
            sl = {"handle": handle, "sid": sid, "prompt": prompt,
                  "logits": None, "feats": None, "arow": arow, "fsm": fsm,
                  "node": None, "table": None, "table_dev": None,
                  "private": []}
            if self._paged:
                # Host-only: the matched blocks are referenced in place,
                # and the pin keeps the chain under this admission across
                # the ticks between slices.
                node, m, table_row, private = \
                    self._paged_match_and_allocate(prompt, handle)
                sl.update(node=node, table=table_row, private=private,
                          table_dev=torch.from_numpy(table_row[None]).to(
                              self.device))
                n_cached = m * self.prefix_block_size
            else:
                if self._host is not None:
                    # Promote before the gather, so the match below sees
                    # the host tier's blocks.
                    self._promote_host_chain(prompt, handle)
                n_cached = 0
                if not self._degraded:
                    match = self._prefix.match(
                        prompt, max_blocks=self._match_blocks(prompt))
                    n_cached = match.n_blocks * self.prefix_block_size
                    self._tracer.on_prefix_match(handle, match.n_blocks,
                                                 n_cached)
                if n_cached > 0:
                    # The gathered copy is private: later evictions cannot
                    # reach it.
                    self._gather_row(match, handle)
            sl.update(off=n_cached, n_cached=n_cached)
            self._slice = sl
            created = True
            return self._advance_slice(sl)
        except _SlotStateLost:
            if not created:
                self._release_adapter(arow)
            raise

    def _release_slice(self, sl: dict) -> None:
        """Hand back what a parked slice owns: its adapter pin and, paged,
        its private blocks and chain pin."""
        self._release_adapter(sl["arow"])
        if sl["private"]:
            self._prefix.release(sl["private"])
        if sl["node"] is not None:
            self._prefix.unpin(sl["node"])

    def _continue_slice(self) -> bool:
        """Resume the parked slice. Returns True once it settled
        (installed, cancelled, expired or unwound), so admission may go on,
        and False while it still has chunks to go."""
        sl = self._slice
        handle = sl["handle"]
        now = self._clock()
        if handle.cancelled or self._expired(handle, now):
            # Not in a slot yet, so `_reap` cannot see it: settle here.
            # The half-prefilled row is junk the next admission
            # overwrites; paged, the private blocks go back to the free
            # list, unreachable until reallocated and rewritten.
            self._release_slice(sl)
            self._slice = None
            if handle.cancelled:
                handle.state = RequestState.CANCELLED
                handle.finish_reason = FinishReason.CANCELLED
            else:
                handle.state = RequestState.TIMED_OUT
                handle.finish_reason = FinishReason.TIMED_OUT
            handle.finish_s = now
            self.metrics.record_finish(handle.finish_reason.value,
                                       handle.request.priority.value)
            self._tracer.on_finish(handle, handle.finish_reason.value)
            self._admitting.popleft()
            return True
        try:
            done = self._advance_slice(sl)
        except _SlotStateLost as lost:
            self._unwind_admission(lost, handle)
            self._admitting.popleft()
            return True
        if done:
            self._admitting.popleft()
        return done

    def _advance_slice(self, sl: dict) -> bool:
        """Run narrow chunks (the ``chunk_prefill`` site) until the prompt
        is prefilled or the step's allowance is spent, always at least one
        chunk. The wide chunk is never taken: one huge forward is the
        head-of-line block slicing exists to break up. A draft model's
        tree advances chunk for chunk beside the target's (the
        ``draft_prefill`` site), at the same offsets and blocks."""
        handle, prompt = sl["handle"], sl["prompt"]
        cache = self._cache if self._paged else self._row
        plen = int(prompt.size)
        spent = 0
        while sl["off"] < plen:
            if spent and self._slice_budget_left <= 0:
                return False
            off = int(sl["off"])
            w = min(self._chunk, plen - off)
            chunk_toks = np.zeros((1, self._chunk), np.int32)
            chunk_toks[0, :w] = prompt[off:off + w]
            toks = torch.from_numpy(chunk_toks).to(self.device)
            _, sl["logits"], sl["feats"] = self._device_call(
                "chunk_prefill", prefill_row_features, self.model, toks, w,
                cache, off, sl["table_dev"])
            if self._draft_on:
                self._device_call("draft_prefill", self._draft_chunk, toks,
                                  off, sl["table_dev"])
            self._tracer.on_prefill_chunk(handle, "chunk_prefill", off, w,
                                          self._last_wall_s)
            sl["off"] = off + w
            spent += w
            self._slice_budget_left -= w
        self._finish_slice(sl)
        return True

    def _finish_slice(self, sl: dict) -> None:
        """The prompt is prefilled: donate and pin (row: off a FRESH
        match, as ticks, and perhaps an OOM flush, ran between the
        slices), then install the slot as the whole-prompt path does."""
        handle, sid, prompt = sl["handle"], sl["sid"], sl["prompt"]
        n_cached = int(sl["n_cached"])
        logits = self._first_logits(sl["logits"], sl["feats"], sl["arow"],
                                    handle)
        if self._paged:
            node = sl["node"]
            if n_cached > 0:
                # Counted at the finish, as the whole-prompt path counts
                # it, so a mid-slice unwind and replay never count twice.
                self.metrics.record_copy_avoided(
                    n_cached * self._kv_token_bytes)
            if not self._degraded:
                # The start's pin survived the ticks between the slices
                # (a flush spares pinned chains), so donation descends
                # from it. While degraded the matched blocks stay pinned
                # and undonated: the table references them in place.
                node = self._donate_tail_paged(
                    prompt, node, sl["table"], sl["private"],
                    n_cached // self.prefix_block_size)
                self.metrics.record_prefix_lookup(
                    n_cached, blocks_live=self._prefix.blocks_live,
                    evictions=self._prefix.evictions)
            self._slice = None
            self._install_slot(sid, handle, logits, node,
                               table_row=sl["table"], private=sl["private"],
                               arow=sl["arow"], fsm=sl["fsm"])
            return
        node = None
        if not self._degraded:
            match = self._prefix.match(prompt,
                                       max_blocks=self._match_blocks(prompt))
            node = self._donate_tail(prompt, match, n_cached)
        self._slice = None
        self._install_slot(sid, handle, logits, node, row=self._row,
                           arow=sl["arow"], fsm=sl["fsm"])

    def _sample_first(self, logits, fsm, t, k, p) -> int:
        """The first token from the prefill logits, under the FSM's start
        mask for a constrained request."""
        if fsm is not None:
            start = torch.from_numpy(
                fsm.allow_row(fsm.start, self.eos_token)[None])
            logits = torch.where(start.to(logits.device), logits, -torch.inf)
        return int(sample_logits_batched(
            self._rng, logits, temperature=np.float32([t]),
            top_k=np.int32([k]), top_p=np.float32([p]))[0])

    def _install_slot(self, sid: int, handle: RequestHandle, logits, node,
                      row=None, table_row=None, private=(), arow: int = 0,
                      fsm=None) -> None:
        """Make a prefilled request live in slot ``sid``: copy its row into
        the slot cache (row mode, the ``insert`` site; paged mode stamps
        the slot's table — the K/V already lives in the pool). A FRESH
        request samples its first token from the prefill logits
        (``sample_first``, that is TTFT); a REPLAYED one (``handle.tokens``
        non-empty) rebuilt its K/V from the prompt and re-feeds the
        emitted tokens through the coming ticks, so no token is
        re-sampled or streamed twice. A tenant slot takes over the
        admission's adapter pin (``arow``); a constrained one (``fsm``)
        samples under the start state's mask, or on a replay re-derives
        its FSM state from the emitted tokens. Every failure releases the
        admission's pins and private blocks before it propagates."""
        req = handle.request
        plen = len(req.prompt)
        replay = bool(handle.tokens)
        t, k, p = req.sampling.as_arrays()

        def _unwind():
            if self._paged and private:
                self._prefix.release(list(private))
            if node is not None:
                self._prefix.unpin(node)
            self._release_adapter(arow)

        fsm_state = None
        if fsm is not None and replay:
            try:
                fsm_state = fsm.advance_many(handle.tokens,
                                             eos_token=self.eos_token)
            except ValueError as e:
                _unwind()
                raise _SlotStateLost("constraint_admit", e) from e
        try:
            if not self._paged:
                self._device_call("insert", insert_cache_slot, self._cache,
                                  row, sid)
            if replay:
                first = handle.tokens[0]
                handle.replay_pending = list(handle.tokens[1:])
            else:
                first = self._device_call("sample_first", self._sample_first,
                                          logits, fsm, t, k, p)
        except _SlotStateLost:
            _unwind()
            raise
        if self._paged:
            self._tables[sid] = table_row
            self._private[sid] = list(private)
        self._slot_nodes[sid] = node
        if not replay:
            now = self._clock()
            handle.tokens.append(first)
            handle.ttft_s = now - handle.arrival_s
            self.metrics.record_first_token(handle.ttft_s,
                                            handle.request.priority.value)
            self.metrics.record_admission(now)
            self._tracer.on_first_token(handle, handle.ttft_s)
        self._slots[sid] = handle
        self._positions[sid] = plen
        self._tokens[sid] = first
        self._temps[sid] = t
        self._top_ks[sid] = k
        self._top_ps[sid] = p
        if self._spec_on:
            # The drafter's history: the prompt and the emitted tokens (one
            # for a fresh admission, the whole stream for a replay), zeroed
            # first so a previous stream's tail never matches.
            self._hist[sid, :] = 0
            self._hist[sid, :plen] = np.asarray(req.prompt, np.int32)
            n = min(len(handle.tokens), self.model.max_len - plen)
            if n > 0:
                self._hist[sid, plen:plen + n] = handle.tokens[:n]
        if self._tenant_on:
            # The slot now owns the adapter pin (released at park) and
            # the grammar state and mask row the coming ticks read.
            if arow != self._arow[sid]:
                self._arow[sid] = arow
                self._arow_dev = None
            if fsm is not None:
                # A replay's state was re-derived from its stream above.
                if not replay:
                    if self.eos_token is not None \
                            and first == self.eos_token:
                        fsm_state = fsm.start  # evicted as EOS below
                    else:
                        fsm_state = fsm.advance(fsm.start, first)
                        if fsm_state < 0:  # masked sample: impossible
                            raise RuntimeError(
                                "constrained first token escaped its "
                                "start-state mask (engine bug)")
                self._fsms[sid] = (fsm, fsm_state)
                self._set_mask(sid, fsm.allow_row(fsm_state,
                                                  self.eos_token))
            else:
                self._fsms[sid] = None
                self._set_mask(sid, None)
        if replay:
            # Every re-fed token's finish conditions were evaluated before
            # the fault; only the live edge is re-checked.
            if self.eos_token is not None \
                    and handle.tokens[-1] == self.eos_token:
                self._evict(sid, RequestState.FINISHED, FinishReason.EOS)
            elif fsm is not None and fsm_state is not None \
                    and fsm.is_dead_end(fsm_state, self.eos_token):
                self._evict(sid, RequestState.FINISHED, FinishReason.GRAMMAR)
            elif len(handle.tokens) >= req.max_new_tokens:
                self._evict(sid, RequestState.FINISHED, FinishReason.LENGTH)
            return
        # A one-token request (or an immediate eos, or an immediately
        # complete grammar) finishes at admission without ever joining a
        # tick.
        if self.eos_token is not None and first == self.eos_token:
            self._evict(sid, RequestState.FINISHED, FinishReason.EOS)
        elif fsm is not None and fsm.is_dead_end(fsm_state, self.eos_token):
            self._evict(sid, RequestState.FINISHED, FinishReason.GRAMMAR)
        elif req.max_new_tokens == 1:
            self._evict(sid, RequestState.FINISHED, FinishReason.LENGTH)

    # --------------------------------------------------------------- tick
    def _tick(self) -> np.ndarray:
        """One fused decode step for every slot (parked ones write junk at
        position 0 of their row, or into the paged scratch sink): returns
        the sampled next tokens, host-side. The host owns the positions,
        so the deepest one bounds every layer's sweep with no sync. A
        tenant engine runs the model ``features_only``, applies the head
        (the same ops as the model's own), adds the slots' LoRA deltas
        and masks the logits before the same batched sampler."""
        dev = self.device
        tokens = torch.from_numpy(self._tokens[:, None]).to(dev)
        table = (torch.from_numpy(self._tables).to(dev) if self._paged
                 else None)
        if self._tenant_on:
            masks, rows = self._stage_masks(), self._stage_rows()
        out = self.model(
            tokens, cache=self._cache,
            cache_index=torch.from_numpy(self._positions).to(dev),
            block_table=table, max_index=int(self._positions.max()),
            features_only=self._tenant_on)
        if self._tenant_on:
            logits = self._adapted(self.model.head_logits(out)[:, -1],
                                   out[:, -1], rows)
            if masks is not None:
                logits = torch.where(masks, logits, -torch.inf)
        else:
            logits = out[:, -1]
        nxt = sample_logits_batched(
            self._rng, logits, temperature=self._temps,
            top_k=self._top_ks, top_p=self._top_ps)
        return nxt.cpu().numpy()  # per-tick host sync (streaming)

    # ------------------------------------------------- speculative tick
    def _draft_tokens(self, pos: torch.Tensor, tok: torch.Tensor, table,
                      forced_tok: np.ndarray,
                      forced_n: np.ndarray) -> torch.Tensor:
        """``[S, spec_k]`` drafts: the n-gram lookup over a CPU view of
        the host history (it never goes to the card), or the draft
        model's ``spec_k`` greedy single-token steps from the slots'
        tokens ``tok [S, 1]`` at positions ``pos [S]`` through the shared
        tables (on the card, the paged-decode kernel), then one more step
        that writes the last draft's K/V — a fully accepted window would
        otherwise leave a hole in the draft cache. A row with
        ``forced_n > j`` takes ``forced_tok[:, j]`` at step ``j`` (a
        replay's known tokens, teacher-forced so the draft cache stays
        exact through recovery; ``forced_n`` is -1 for other rows)."""
        k = self._spec_k
        if not self._draft_on:
            return ngram_drafts(torch.from_numpy(self._hist),
                                torch.from_numpy(self._positions),
                                self._spec_ngram, k)
        dev = self.device
        deepest = int(self._positions.max())
        outs = []
        for j in range(k):
            logits = _last_logits(self._draft, tok, 1, cache=self._dcache,
                                  cache_index=pos + j, block_table=table,
                                  max_index=deepest + j)
            nxt = logits.argmax(dim=-1).to(torch.int32)
            if (forced_n > j).any():
                nxt = torch.where(
                    torch.from_numpy(forced_n > j).to(dev),
                    torch.from_numpy(forced_tok[:, j]).to(dev), nxt)
            outs.append(nxt)
            tok = nxt[:, None]
        self._draft(tok, cache=self._dcache, cache_index=pos + k,
                    block_table=table, max_index=deepest + k,
                    features_only=True)
        return torch.stack(outs, dim=1)

    def _verify(self, block: torch.Tensor, pos: torch.Tensor, table,
                caps: torch.Tensor, forced: torch.Tensor, masks=None,
                rows=None):
        """ONE target forward over the ``[S, spec_k+1]`` block at the
        slots' positions ``pos`` (the multi-token write and sweep; paged:
        the pool insert and the plain multi-token attention), greedy
        acceptance as the cumulative product of matches against the
        block's drafts, capped per row, ``forced >= 0`` taken as given,
        and position 0 drawn by the batched sampler the one-token tick
        uses. A tenant engine judges the drafts under the ADAPTED model
        (the LoRA deltas of the slots' pool ``rows`` at every window
        position) and the per-position grammar ``masks``, before the
        argmax and the position-0 draw. Returns the window ``[S,
        spec_k+1]`` and the accepted lengths ``[S]`` on the host, from one
        device-to-host copy."""
        out = self.model(block, cache=self._cache, cache_index=pos,
                         block_table=table,
                         max_index=int(self._positions.max()),
                         features_only=self._tenant_on)
        if self._tenant_on:
            logits = self._adapted(self.model.head_logits(out), out, rows)
            if masks is not None:
                logits = torch.where(masks, logits, -torch.inf)
        else:
            logits = out
        y = logits.argmax(dim=-1).to(torch.int32)
        match = (block[:, 1:] == y[:, :-1]).to(torch.int32)
        acc = torch.minimum(match.cumprod(dim=1).sum(dim=1), caps)
        acc = torch.where(forced >= 0, forced, acc).to(torch.int32)
        y[:, 0] = sample_logits_batched(
            self._rng, logits[:, 0], temperature=self._temps,
            top_k=self._top_ks, top_p=self._top_ps)
        out = torch.cat([y, acc[:, None]], dim=1).cpu().numpy()
        return out[:, :-1], out[:, -1]  # per-tick host sync (streaming)

    def _dispatch_draft(self, pos, tok, table, forced_tok,
                        forced_n) -> torch.Tensor:
        """The ``draft`` site. A draft failure is never fatal to the
        streams: when the retry budget runs out with nothing written (an
        injected fault, or the n-gram lookup, which writes nothing) the
        window falls back to repeat-last-token drafts — the n-gram
        drafter's own no-match fallback — and pays acceptance, not
        correctness. Only a real error in the draft model's steps, which
        write its tree, escalates (a full live-slot replay)."""
        try:
            return self._device_call("draft", self._draft_tokens, pos, tok,
                                     table, forced_tok, forced_n)
        except _SlotStateLost as lost:
            if lost.consumed is not None:
                raise
            return torch.from_numpy(
                np.repeat(self._tokens[:, None], self._spec_k, axis=1))

    def _spec_tick(self, live) -> int:
        """One speculative step: draft → ONE verify over the ``[S,
        spec_k+1]`` window → host-side accept and evict. A greedy slot may
        accept up to ``spec_k`` drafts (its cap); a sampled slot's cap is
        0, so it ticks one token exactly as the plain tick does. A
        replaying slot re-feeds up to ``spec_k + 1`` known tokens a window
        (forced, never sampled; the last one stays as the next window's
        current token). Returns the tokens emitted; raises
        :class:`_SlotStateLost` to the caller like the plain tick."""
        s, k = self.max_slots, self._spec_k
        w_width = k + 1
        forced_tok = np.zeros((s, k), np.int32)
        forced_n = np.full(s, -1, np.int32)
        for sid in live:
            pend = self._slots[sid].replay_pending
            if pend:
                j = min(k, len(pend) - 1)
                if j > 0:
                    forced_tok[sid, :j] = pend[:j]
                forced_n[sid] = j
        forced = forced_n >= 0
        caps = np.zeros(s, np.int32)
        walks = []  # constrained greedy slots: capped by the FSM walk
        for sid in live:
            if forced[sid]:
                continue
            fsm_entry = self._fsms[sid] if self._tenant_on else None
            if self._temps[sid] > 0:
                # A sampled row ticks one token (cap 0); a constrained one
                # draws it under its state's mask, lifted to position 0
                # of the window.
                if fsm_entry is not None:
                    self._masks_w[sid, 0] = self._masks[sid]
                    self._masks_w[sid, 1:] = True
                    self._masks_w_dirty = True
            elif fsm_entry is None:
                caps[sid] = k
            else:
                walks.append(sid)
        # The per-slot state goes to the card in ONE copy, before any
        # forward is queued (a host-to-device copy waits for the stream).
        packed = np.concatenate(
            [np.stack([self._positions, self._tokens, caps, forced_n], 1),
             self._tables if self._paged else np.zeros((s, 0), np.int32)],
            axis=1)
        state = torch.from_numpy(packed).to(self.device)
        rows = self._stage_rows() if self._tenant_on else None
        pos, tok = state[:, 0], state[:, 1:2]
        table = state[:, 4:].contiguous() if self._paged else None
        drafts = self._dispatch_draft(pos, tok, table, forced_tok, forced_n)
        if forced.any():
            # A replaying row's window is its known tokens, zeros past
            # them, whatever was drafted.
            drafts = torch.where(
                torch.from_numpy(forced[:, None]).to(drafts.device),
                torch.from_numpy(forced_tok).to(drafts.device),
                drafts.to(torch.int32))
        caps_dev = state[:, 2]
        if walks:
            # The walk reads the drafts on the host: the n-gram drafts are
            # there already, a draft model's cost one more copy.
            host = drafts.cpu().numpy()
            for sid in walks:
                caps[sid] = self._grammar_draft_walk(sid, self._fsms[sid],
                                                     host[sid])
            caps_dev = torch.from_numpy(caps).to(self.device)
        drafted_tick = int(caps.sum())
        masks = self._stage_masks(window=True) if self._tenant_on else None
        block = torch.cat([tok, drafts.to(self.device)], dim=1)
        win, acc = self._device_call("verify", self._verify, block, pos,
                                     table, caps_dev, state[:, 3], masks,
                                     rows)
        new_tokens = 0
        accepted_tick = 0
        for sid in live:
            handle = self._slots[sid]
            if forced[sid]:
                j = int(forced_n[sid])
                del handle.replay_pending[:j]
                self._positions[sid] += j + 1
                self._tokens[sid] = handle.replay_pending.pop(0)
                continue
            n_emit = int(acc[sid]) + 1
            if caps[sid] > 0:
                accepted_tick += int(acc[sid])
                handle.spec_drafted += int(caps[sid])
                handle.spec_accepted += int(acc[sid])
            pos0 = int(self._positions[sid])
            # The WHOLE window goes into the history, the rejected tail
            # included (the model's own next-token guesses: a lookup
            # that crosses the live edge reads them, not zeros); the next
            # window covers that extent before the edge reaches it.
            end = min(pos0 + 1 + w_width, self._hist.shape[1])
            if end > pos0 + 1:
                self._hist[sid, pos0 + 1:end] = win[sid, :end - pos0 - 1]
            evicted = False
            for j in range(n_emit):
                emitted = int(win[sid, j])
                handle.tokens.append(emitted)
                new_tokens += 1
                self._tracer.on_token(handle, self._cur_step)
                # Tokens past an in-window eos or grammar end are never
                # emitted; the live FSM advances by the accepted tokens.
                reason = self._emit_finish(sid, handle, emitted)
                if reason is not None:
                    self._evict(sid, RequestState.FINISHED, reason)
                    evicted = True
                    break
            if not evicted:
                self._positions[sid] += n_emit
                self._tokens[sid] = int(win[sid, n_emit - 1])
        self.metrics.record_spec_tick(drafted_tick, accepted_tick)
        return new_tokens

    def _grammar_draft_walk(self, sid: int, fsm_entry, drafts_row) -> int:
        """Walk one constrained greedy slot's FSM along its drafts: stamp
        the per-position allow masks the verify judges under, and return
        the accept cap, the longest draft prefix that is a legal
        continuation (an allowed eos draft is acceptable and ends the
        walk; past an illegal draft the masks stay pass-through, as the
        cap discards those positions). The slot's LIVE state is untouched
        here: it advances by the accepted tokens only."""
        fsm, state = fsm_entry
        mw = self._masks_w
        mw[sid, 0] = self._masks[sid]
        cap = 0
        for j in range(1, self._spec_k + 1):
            d = int(drafts_row[j - 1])
            if not mw[sid, j - 1][d]:
                mw[sid, j:] = True
                break
            if self.eos_token is not None and d == self.eos_token:
                cap = j  # an accepted eos finishes the stream in-window
                mw[sid, j:] = True
                break
            state = fsm.advance(state, d)
            mw[sid, j] = fsm.allow_row(state, self.eos_token)
            cap = j
        self._masks_w_dirty = True
        return cap

    def _emit_finish(self, sid: int, handle: RequestHandle,
                     tok: int) -> Optional[FinishReason]:
        """After slot ``sid`` emitted ``tok``: the reason its stream ends
        there, or None. Eos first (a constrained slot's mask allows eos
        only in an accepting state, so it is grammar acceptance too);
        then a constrained slot advances its FSM and ends GRAMMAR at a
        dead end, or restamps its mask row; then the length."""
        if self.eos_token is not None and tok == self.eos_token:
            return FinishReason.EOS
        fsm_entry = self._fsms[sid] if self._tenant_on else None
        if fsm_entry is not None:
            fsm, state = fsm_entry
            state = fsm.advance(state, tok)
            if state < 0:  # masked sample: impossible
                raise RuntimeError(
                    "constrained token escaped its state mask (engine bug)")
            self._fsms[sid] = (fsm, state)
            if fsm.is_dead_end(state, self.eos_token):
                return FinishReason.GRAMMAR
            if len(handle.tokens) < handle.request.max_new_tokens:
                self._set_mask(sid, fsm.allow_row(state, self.eos_token))
        if len(handle.tokens) >= handle.request.max_new_tokens:
            return FinishReason.LENGTH
        return None

    @torch.no_grad()
    def step(self) -> int:
        """One engine tick: (drain check) → re-arm check → reap → admit →
        append blocks → one fused decode tick for all live slots → evict
        finished. Returns tokens emitted this step (admission first-tokens
        included; replay re-feeds emit nothing — those tokens were already
        streamed). With ``spec_k > 0`` the tick is the draft/verify window
        (:meth:`_spec_tick`), up to ``spec_k + 1`` tokens a slot. The step
        index is the fault plan's and the tracer's step coordinate. After a
        drain this returns 0 and does nothing."""
        if self._drain_flag and not self._drained:
            # The drain handler's flag: snapshot and stop at this step
            # boundary, a consistent request set.
            self.drain(self._drain_path)
        if self._drained:
            return 0
        self.warmup()
        cur = self._step_idx
        self._cur_step = cur
        if self._faults is not None:
            self._faults.on_step(cur)
        self._step_idx = cur + 1
        self._site_wall = {}
        retries_before = self.metrics.retries
        t0 = self._clock()
        emitted_before = self.metrics.tokens_emitted
        self._maybe_rearm_degraded()
        self._reap()
        self._admit()
        if self._paged:
            self._paged_append_blocks()
        live = [i for i, s in enumerate(self._slots) if s is not None]
        new_tokens = 0
        if live and self._spec_on:
            try:
                new_tokens = self._spec_tick(live)
            except _SlotStateLost:
                # The window writes the resident tree as the tick does
                # (and a draft model's tree shares the paged pool's
                # fate): every live slot replays.
                self._lose_live_slots()
        elif live:
            try:
                nxt = self._device_call("tick", self._tick)
            except _SlotStateLost:
                self._lose_live_slots()
                nxt = None
            for sid in live if nxt is not None else ():
                handle = self._slots[sid]
                if handle.replay_pending:
                    # Rebuilding lost K/V: the tick just re-wrote this
                    # row's next known token — feed the following one and
                    # discard the sampled output.
                    self._tokens[sid] = handle.replay_pending.pop(0)
                    self._positions[sid] += 1
                    continue
                tok = int(nxt[sid])
                handle.tokens.append(tok)
                new_tokens += 1
                self._positions[sid] += 1
                self._tokens[sid] = tok
                self._tracer.on_token(handle, cur)
                reason = self._emit_finish(sid, handle, tok)
                if reason is not None:
                    self._evict(sid, RequestState.FINISHED, reason)
        now = self._clock()
        self.metrics.record_tick(now, self.scheduler.depth, len(live),
                                 self.max_slots, new_tokens, now - t0)
        if self._paged:
            self.metrics.record_paged_gauges(self.blocks_shared,
                                             self.block_table_fill)
        emitted = self.metrics.tokens_emitted - emitted_before
        self.telemetry.append({
            "step": cur, "t_s": now, "queue_depth": self.scheduler.depth,
            "live_slots": len(live), "tokens": emitted,
            "tick_wall_s": now - t0,
            "retries": self.metrics.retries - retries_before,
            "degraded": self._degraded,
            "site_wall_s": self._site_wall,
        })
        self._tracer.on_tick(cur, self.scheduler.depth, len(live), emitted,
                             now - t0)
        return emitted

    def run(self, max_steps: Optional[int] = None) -> None:
        """Drive ``step()`` until queue and slots drain (or the step
        budget runs out)."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break

    # ------------------------------------------------------ drain/restore
    def install_drain_handler(self, path: Optional[str] = None,
                              signals=(signal.SIGTERM,)) -> None:
        """Arm checkpoint-on-SIGTERM: the handler only sets a flag
        (async-signal-safe); the :meth:`drain` itself (snapshot to
        ``path``, admission stopped) runs at the next ``step()`` boundary,
        so the snapshot is a consistent request set."""
        self._drain_path = path

        def _on_signal(signum, frame):  # flag only: async-signal-safe
            self._drain_flag = True

        for sig in signals:
            self._prev_handlers[sig] = signal.signal(sig, _on_signal)

    def uninstall_drain_handler(self) -> None:
        """Put the previous signal handlers back."""
        for sig, old in self._prev_handlers.items():
            signal.signal(sig, old)
        self._prev_handlers.clear()

    def drain(self, path: Optional[str] = None) -> dict:
        """Snapshot every in-flight request's host state and stop.

        Running slots first, oldest first (the restore owes them the
        earliest re-admission), then any handle caught mid-admission (a
        parked slice's included), then the queue: each as prompt, tokens
        so far, sampling parameters, remaining deadline budget, class,
        tenant fields and draft accounting (``serve/drain.py``, snapshot
        v5). No device state is saved: K/V is a pure function of the
        weights and tokens, and the restore recomputes it through the
        replay path. A paged engine records each running slot's block
        table (postmortem context). Idempotent; with ``path`` the
        snapshot is also written atomically. Afterwards the engine admits
        nothing and ``step()`` returns 0."""
        if self._drained:
            return self._snapshot
        now = self._clock()
        handles = sorted((h for h in self._slots if h is not None),
                         key=lambda h: h.arrival_s)
        handles.extend(self._admitting)
        handles.extend(self.scheduler.drain())
        tables = {}
        if self._paged:
            for sid, h in enumerate(self._slots):
                if h is not None:
                    row = self._tables[sid]
                    tables[id(h)] = [int(b) for b in row[row != 0]]
        self._snapshot = {
            "version": drain_io.SNAPSHOT_VERSION,
            "drained_unix_s": time.time(),
            "paged": self._paged,
            "spec_k": self._spec_k,
            "requests": [drain_io.encode_handle(
                h, now, block_table=tables.get(id(h))) for h in handles],
            # Last-moments telemetry, postmortem context the restore
            # ignores.
            "telemetry": self.telemetry.summary(),
        }
        self._tracer.on_drain(self._cur_step, len(handles))
        self._drained = True
        self._drain_flag = True
        if path is not None:
            drain_io.save_snapshot(self._snapshot, path)
        return self._snapshot

    def restore(self, source) -> List[RequestHandle]:
        """Resubmit a drain snapshot (a dict or a path), drained by either
        package, into THIS engine (a fresh one, of either mode). Running
        requests resume token-exactly: their handles re-enter the queue's
        bypass lane with the tokens so far, and the replay admission
        rebuilds their K/V before the stream goes on (a finished
        restored handle holds the request's FULL stream). Depth limits do
        not apply. Returns the new handles in service order."""
        if isinstance(source, str):
            source = drain_io.load_snapshot(source)
        handles = drain_io.restored_handles(source, self._clock())
        if not self._tenant_on:
            # A tenant stream on a plain engine would silently serve the
            # base model: refuse instead (v1-v3 entries carry neither
            # field and restore here unchanged).
            bad = [h for h in handles
                   if h.request.adapter is not None
                   or h.request.constraint is not None]
            if bad:
                raise ValueError(
                    f"snapshot carries {len(bad)} tenant request(s) "
                    "(adapter/constraint) but this engine has no "
                    "tenant=TenantConfig(...)")
        self.scheduler.restore(handles)
        for h in handles:
            self._tracer.on_restored(h, len(h.tokens))
        return handles

    # ------------------------------------------- cross-replica transfer
    def export_prefix_chain(self, tokens, max_blocks: Optional[int] = None):
        """The replica-to-replica prefix-transfer EXPORT: the longest
        cached chain for ``tokens`` — the device radix match first (read
        to the host in one gather and one copy, the read demotion uses,
        pinned for exactly the read), host-tier blocks extending it —
        as a ``serve/drain.py`` chain wire entry. ``None`` when nothing
        is cached, the prefix machinery or the HOST TIER is off (a
        tier-less replica could not receive a peer's chain either:
        exporting is a tiered-fleet feature), or the engine is degraded
        (exporting from a shed cache would race the flush) or drained."""
        if (not self._prefix_on or self._host is None
                or self._degraded or self._drained):
            return None
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        cap = self._match_blocks(tokens)
        if max_blocks is not None:
            cap = min(cap, int(max_blocks))
        if cap < 1:
            return None
        match = self._prefix.match(tokens, max_blocks=cap)
        m = match.n_blocks
        blocks: List[Dict[str, torch.Tensor]] = []
        if m > 0:
            self._prefix.pin(match.node)
            try:
                blocks = self._gather_blocks_host(match.block_ids)
            except Exception as e:  # noqa: BLE001 - device faults only
                if classify(e) is None:
                    raise
                blocks = []  # a failed read exports nothing
            finally:
                self._prefix.unpin(match.node)
            if len(blocks) < m:
                return None
        if m < cap:  # the guard above made sure the tier is armed
            tip = self._host.pin_chain(tokens, m, cap - m)
            if tip is not None:
                try:
                    blocks.extend(self._host.chain_data(tip, tip.depth - m))
                finally:
                    self._host.unpin(tip)
        if not blocks:
            return None
        bs = self.prefix_block_size
        return drain_io.kv_chain_to_wire(
            [int(t) for t in tokens[:len(blocks) * bs]], blocks)

    def import_prefix_chain(self, entry) -> int:
        """The transfer IMPORT: the decoded chain's blocks enter the HOST
        TIER only (no device work on the routing path: the next admission
        for the prefix promotes them through the budget-charged
        ``host_promote`` site, as a locally spilled chain). A payload
        failing this engine's leaf spec is refused block by block, and
        the first refusal ends the import (a hole would end every deeper
        block's promotability). Returns the blocks stored; 0 with the
        tier off."""
        if self._host is None:
            return 0
        tokens, blocks = drain_io.kv_chain_from_wire(entry)
        bs = self.prefix_block_size
        stored = 0
        for j, data in enumerate(blocks):
            chain = tokens[:(j + 1) * bs]
            if len(chain) < (j + 1) * bs:
                break
            if self._host.has_block(chain):
                continue
            if not self._host.store(chain, data):
                break
            stored += 1
            self.metrics.record_host_spill(self._host.bytes_resident)
        return stored
