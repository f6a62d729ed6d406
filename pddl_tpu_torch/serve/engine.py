"""Continuous-batching online serving engine over the PAGED decode path
(the port of :mod:`pddl_tpu.serve.engine` for ``paged=True``).

Orca-style iteration-level scheduling: requests join and leave the
running batch at token granularity. Each :meth:`ServeEngine.step`:

1. REAP cancelled and timed-out slots;
2. ADMIT queued requests into free slots — the radix index
   (``kvcache/radix.py``) matches the longest cached prompt prefix and
   the slot's block table points at those pool blocks IN PLACE (pinned,
   never copied); private blocks are allocated for the suffix, which is
   chunk-prefilled straight into them (narrow chunks for short suffixes,
   one wide chunk for a long remainder); the prompt's full blocks are
   then handed to the index (a refcount hand-off — zero copies) and the
   first token is sampled from the prefill logits (that is TTFT);
3. APPEND a fresh private block to every live slot about to write at a
   block boundary;
4. one fused decode TICK for every live slot: each layer writes its token's
   K/V through the slot's table and attends through it — on the card the
   hand-written paged-decode kernel (``ops/csrc/paged_decode.cu``) — with
   per-slot sampling parameters as batched arrays; finished slots are
   evicted host-side (their private blocks return to the free list, their
   pinned chain stays cached and becomes LRU-evictable).

Token-exactness of shared blocks is structural: Llama caches post-RoPE
keys at their absolute positions, so a block computed by one request is
bit-valid for every request with the same prompt tokens.

PyTorch runs eagerly, so the JAX engine's fixed compiled-program set
(and its ``compile_counts`` pin) has no counterpart here. Not ported yet
— each raises ``NotImplementedError`` naming its ROADMAP.md item: the
resident-row engine (``paged=False``) and the sliding-window ring cache,
speculative serving (``spec_k`` and its options), tenancy (``tenant``,
``submit``'s ``adapter``/``constraint``), int8 serving
(``param_transform``), the host KV tier (``host_tier``), fault injection
and replay (``fault_plan``, its retry and replay knobs,
``preempt_cap > 0``), sliced prefill (``prefill_slice_tokens``),
drain/restore and tracers.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from pddl_tpu_torch.device import resolve_device
from pddl_tpu_torch.models.gpt import prefill_row_from, sample_logits_batched
from pddl_tpu_torch.obs.ring import TelemetryRing
from pddl_tpu_torch.serve.kvcache import (
    RadixPrefixCache,
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

_ROADMAP_ROW = "ROADMAP.md queue 1 item 2 (the resident-row engine)"
_ROADMAP_FEATURES = "ROADMAP.md queue 1 item 3 (engine features)"


def _not_ported(what: str, item: str = _ROADMAP_FEATURES
                ) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet ({item}); the port's engine serves "
        "paged=True with the prefix cache")


class ServeEngine:
    """Online multiplexer of generate requests onto one paged decode path.

    Args:
      model: a port Llama (``pddl_tpu_torch.models.llama``); it is moved
        to ``device`` in place.
      variables: accepted for the JAX signature at ``None`` only: the
        port's model carries its weights (anything else raises, naming
        the fleet's ROADMAP.md item).
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
        ``None`` sizes it to every slot at ``max_len`` plus headroom for
        two cached prompts per slot; an explicit size must cover
        ``max_slots * ceil(max_len / block_size) + 1`` so a live stream
        never starves for a writable block.
      prefix_block_size: tokens per pool block (the sharing granularity).
      prefix_chunk: the narrow prefill chunk width (default
        ``max(prefix_block_size, prefill_len // 4)``).
      paged: must be True (the resident-row engine is not ported).
      preempt_cap: must be 0 (preemption resumes through replay
        admission, not ported).
      telemetry_capacity: size of the per-step :class:`TelemetryRing`.
      prefill_slice_tokens / param_transform / host_tier / fault_plan /
      max_retries / retry_backoff_s / backoff_sleep / max_replays /
      degraded_cooldown_s / tenant / spec_k / spec_ngram /
      spec_draft_model / spec_draft_variables / tracer: not ported;
      anything but the JAX engine's defaults raises.

    A model with :attr:`~pddl_tpu_torch.models.llama.Llama.uses_ring_cache`
    set is refused, as the JAX engine refuses it.
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
                 paged: bool = True,
                 host_tier=None, fault_plan=None, max_retries: int = 3,
                 retry_backoff_s: float = 0.02, backoff_sleep=time.sleep,
                 max_replays: int = 3, degraded_cooldown_s: float = 5.0,
                 preempt_cap: int = 0, tenant=None, spec_k: int = 0,
                 spec_ngram: int = 3, spec_draft_model=None,
                 spec_draft_variables=None, tracer=None,
                 telemetry_capacity: int = 512):
        if variables is not None:
            # The port's model carries its weights; the JAX engine takes
            # them apart, and its fleet workers pass them so.
            raise _not_ported("a separate variables tree",
                              "ROADMAP.md queue 1 item 8 (the fleet)")
        if not paged:
            raise _not_ported("paged=False", _ROADMAP_ROW)
        if getattr(model, "uses_ring_cache", False):
            raise _not_ported(
                f"sliding_window={model.sliding_window} (a rolling ring "
                "cache in decode)", _ROADMAP_ROW)
        for what, given in (("prefill_slice_tokens",
                             prefill_slice_tokens is not None),
                            ("param_transform", param_transform is not None),
                            ("host_tier", host_tier is not None),
                            ("fault_plan", fault_plan is not None),
                            ("max_retries", max_retries != 3),
                            ("retry_backoff_s", retry_backoff_s != 0.02),
                            ("backoff_sleep", backoff_sleep is not time.sleep),
                            ("max_replays", max_replays != 3),
                            ("degraded_cooldown_s",
                             degraded_cooldown_s != 5.0),
                            ("preempt_cap > 0", preempt_cap > 0),
                            ("tenant", tenant is not None),
                            ("spec_k > 0", spec_k > 0),
                            ("spec_ngram", spec_ngram != 3),
                            ("spec_draft_model", spec_draft_model is not None),
                            ("spec_draft_variables",
                             spec_draft_variables is not None),
                            ("tracer", tracer is not None)):
            if given:
                raise _not_ported(what)
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
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
        self.telemetry = TelemetryRing(telemetry_capacity)
        self._step_idx = 0

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
        # T table entries cover every position a stream can reach; the
        # pool must hold one writable block per live position-block plus
        # the scratch sink, or a decode tick could starve mid-stream.
        self._table_width = -(-model.max_len // bs)
        paged_floor = self.max_slots * self._table_width + 1
        if prefix_cache_blocks is None:
            pool_blocks = (paged_floor
                           + 2 * self.max_slots * max(self._donate_cap, 1))
        else:
            pool_blocks = int(prefix_cache_blocks)
        if pool_blocks < paged_floor:
            raise ValueError(
                f"paged=True needs prefix_cache_blocks >= {paged_floor} "
                f"(max_slots * ceil(max_len/block_size) + scratch) so live "
                f"streams can never starve for a writable block; got "
                f"{pool_blocks}")
        if self._match_cap < 1:
            raise ValueError(
                f"prefix_block_size {bs} leaves no cacheable block under "
                f"prefill_len {self.prefill_len} (need block_size < "
                "prefill_len)")
        if not 1 <= chunk or self.prefill_len + chunk > model.max_len:
            raise ValueError(
                f"prefix_chunk {chunk} needs 1 <= chunk and prefill_len + "
                f"chunk <= max_len ({self.prefill_len} + {chunk} > "
                f"{model.max_len}): a chunk starting at the deepest cached "
                "offset would clamp its positions")
        self.prefix_block_size = bs
        self._chunk = chunk
        # The WIDE chunk (the whole prefill_len) serves cold or barely
        # cached prompts in one forward; it can start as deep as
        # prefill_len/4 (the width policy's threshold), so its positions
        # must stay in range there too.
        self._has_wide = (self._chunk < self.prefill_len
                          and self.prefill_len + self.prefill_len // 4
                          <= model.max_len)

        self._prefix = RadixPrefixCache(bs, pool_blocks)
        self._cache = paged_decode_cache(self.model, pool_blocks, bs)
        # KV bytes one token occupies across every layer: what one avoided
        # gather copy is worth (`copy_bytes_avoided`).
        self._kv_token_bytes = pool_nbytes(self._cache) // (pool_blocks * bs)

        # One handle per occupied slot; the other per-slot state lives in
        # the host arrays below, stamped into every tick.
        self._slots: List[Optional[RequestHandle]] = [None] * self.max_slots
        self._slot_nodes: List[Optional[object]] = [None] * self.max_slots
        self._positions = np.zeros(self.max_slots, np.int32)
        self._tokens = np.zeros(self.max_slots, np.int32)
        self._temps = np.zeros(self.max_slots, np.float32)
        self._top_ks = np.zeros(self.max_slots, np.int32)
        self._top_ps = np.full(self.max_slots, 2.0, np.float32)
        # Host-authoritative block tables (scratch-filled for parked
        # slots) and the private, not-yet-shared block ids each slot owns.
        self._tables = np.zeros((self.max_slots, self._table_width),
                                np.int32)
        self._private: List[List[int]] = [[] for _ in range(self.max_slots)]

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
        depth. ``adapter`` and ``constraint`` (tenancy) must be None."""
        for what, given in (("adapter", adapter), ("constraint", constraint)):
            if given is not None:
                raise _not_ported(f"submit({what}=...)")
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
        req = Request(prompt=prompt.tolist(),
                      max_new_tokens=int(max_new_tokens),
                      sampling=sampling or SamplingParams(),
                      deadline_s=deadline_s, priority=priority)
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
        return handle

    def drain(self, path: Optional[str] = None):
        raise _not_ported("drain")

    def restore(self, source):
        raise _not_ported("restore")

    # ------------------------------------------------------------- state
    @property
    def paged(self) -> bool:
        return True

    @property
    def blocks_shared(self) -> int:
        """Pool blocks referenced by MORE THAN ONE live slot's table right
        now (ids are unique within a row, so a count > 1 means > 1
        slot)."""
        live = [sid for sid, h in enumerate(self._slots) if h is not None]
        if len(live) < 2:
            return 0
        rows = self._tables[live]
        _, counts = np.unique(rows[rows != 0], return_counts=True)
        return int((counts > 1).sum())

    @property
    def block_table_fill(self) -> float:
        """Mean fraction of live slots' table entries that point at real
        (non-scratch) blocks."""
        live = [sid for sid, h in enumerate(self._slots) if h is not None]
        if not live:
            return 0.0
        return float((self._tables[live] != 0).mean())

    @property
    def live_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def has_work(self) -> bool:
        return self.live_slots > 0 or self.scheduler.depth > 0

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
        self._park_slot(slot_id)

    def _park_slot(self, slot_id: int) -> None:
        """Vacate a slot: its table row goes all-scratch (its next junk
        writes land in the sink), its PRIVATE blocks — tail and generated
        tokens, never shared — return to the free list, and its pin on
        the donated prompt chain is released (the blocks stay cached,
        LRU-evictable)."""
        self._slots[slot_id] = None
        if self._private[slot_id]:
            self._prefix.release(self._private[slot_id])
            self._private[slot_id] = []
        self._tables[slot_id, :] = 0
        if self._slot_nodes[slot_id] is not None:
            self._prefix.unpin(self._slot_nodes[slot_id])
            self._slot_nodes[slot_id] = None
        self._positions[slot_id] = 0
        self._tokens[slot_id] = 0
        self._temps[slot_id] = 0.0
        self._top_ks[slot_id] = 0
        self._top_ps[slot_id] = 2.0

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
        estimate; the match at prefill time is authoritative)."""
        prompt = handle.request.prompt
        match = self._prefix.match(prompt,
                                   max_blocks=self._match_blocks(prompt))
        return len(prompt) - match.n_blocks * self.prefix_block_size

    def _chunk_loop(self, prompt: np.ndarray, off: int, dispatch):
        """The suffix chunk loop and its width policy (each forward pays a
        fixed cost plus per-token compute): a long remainder (>= 3/4 of
        the wide width) takes the WIDE chunk in one forward, short
        suffixes — the prefix-hit case — take narrow chunks and pay only
        for the uncached tail. ``dispatch(chunk_toks, w, off)`` runs one
        chunk and returns its logits."""
        plen = int(prompt.size)
        logits = None
        while off < plen:
            rem = plen - off
            if self._has_wide and 4 * rem >= 3 * self.prefill_len:
                width = self.prefill_len
            else:
                width = self._chunk
            w = min(width, rem)
            chunk_toks = np.zeros((1, width), np.int32)
            chunk_toks[0, :w] = prompt[off:off + w]
            logits = dispatch(chunk_toks, w, off)
            off += w
        return logits

    def _paged_match_and_allocate(self, prompt: np.ndarray):
        """match → pin → allocate private suffix blocks → stamp the table
        row. The pin lands BEFORE any allocation, so an eviction during
        this admission can never take a matched block from under it.
        Returns ``(pinned_node_or_None, n_matched_blocks, table_row [T],
        private_ids)``."""
        plen = int(prompt.size)
        bs = self.prefix_block_size
        table_row = np.zeros(self._table_width, np.int32)
        node = None
        match = self._prefix.match(prompt,
                                   max_blocks=self._match_blocks(prompt))
        m = match.n_blocks
        if m > 0:
            node = match.node
            self._prefix.pin(node)
            table_row[:m] = match.block_ids
        need = -(-plen // bs) - m
        private = list(self._prefix.allocate(need)) if need > 0 else []
        if len(private) < need:
            self._prefix.release(private)
            if node is not None:
                self._prefix.unpin(node)
            # The pool's validated floor rules this out; the JAX engine's
            # answer (requeue for replay) is not ported.
            raise RuntimeError(
                f"block pool exhausted ({need} blocks needed, "
                f"{len(private)} free/evictable)")
        table_row[m:m + len(private)] = private
        return node, m, table_row, private

    def _prefill_paged(self, prompt: np.ndarray):
        """A prefix hit PINS the matched chain and points the slot's table
        at it in place; private blocks take the suffix, which the chunks
        write straight into the pool. Returns ``(last_logits, node,
        table_row, private_ids)``."""
        node, m, table_row, private = self._paged_match_and_allocate(prompt)
        n_cached = m * self.prefix_block_size
        table = torch.from_numpy(table_row[None]).to(self.device)

        def _dispatch(chunk_toks, w, off):
            toks = torch.from_numpy(chunk_toks).to(self.device)
            _, logits = prefill_row_from(self.model, toks, w, self._cache,
                                         off, table)
            return logits

        logits = self._chunk_loop(prompt, n_cached, _dispatch)
        if n_cached > 0:
            self.metrics.record_copy_avoided(
                n_cached * self._kv_token_bytes)
        node = self._donate_tail_paged(prompt, node, table_row, private, m)
        self.metrics.record_prefix_lookup(
            n_cached, blocks_live=self._prefix.blocks_live,
            evictions=self._prefix.evictions)
        return logits, node, table_row, private

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
        free = self._free_slot_ids()
        if not free:
            return

        def _queued_cancel(handle):
            handle.finish_s = self._clock()
            self.metrics.record_finish(FinishReason.CANCELLED.value,
                                       handle.request.priority.value)

        def _queued_expired(handle):
            # Died in the queue: never pay its prefill.
            handle.finish_s = self._clock()
            self.metrics.record_finish(FinishReason.DEADLINE.value,
                                       handle.request.priority.value)

        # The suffix-priced cost_fn walks the radix tree per pop; only pay
        # that when a budget consumes the result.
        use_cost = self.scheduler.prefill_token_budget is not None
        for handle in self.scheduler.admit(
                len(free), on_cancelled=_queued_cancel,
                on_expired=_queued_expired, now_fn=self._clock,
                cost_fn=self._prefill_cost if use_cost else None):
            self._admit_one(free.pop(0), handle)

    def _admit_one(self, sid: int, handle: RequestHandle) -> None:
        prompt = np.asarray(handle.request.prompt, np.int32)
        logits, node, table_row, private = self._prefill_paged(prompt)
        self._install_slot(sid, handle, logits, node, table_row, private)

    def _install_slot(self, sid: int, handle: RequestHandle, logits, node,
                      table_row, private) -> None:
        """Make a prefilled request live in slot ``sid``: sample its first
        token from the prefill logits (TTFT) and stamp the slot's table —
        the KV already lives in the pool, so installing is host
        bookkeeping."""
        req = handle.request
        plen = len(req.prompt)
        t, k, p = req.sampling.as_arrays()
        first = int(sample_logits_batched(
            self._rng, logits, temperature=np.float32([t]),
            top_k=np.int32([k]), top_p=np.float32([p]))[0])
        self._tables[sid] = table_row
        self._private[sid] = list(private)
        self._slot_nodes[sid] = node
        now = self._clock()
        handle.tokens.append(first)
        handle.ttft_s = now - handle.arrival_s
        self.metrics.record_first_token(handle.ttft_s,
                                        handle.request.priority.value)
        self.metrics.record_admission(now)
        self._slots[sid] = handle
        self._positions[sid] = plen
        self._tokens[sid] = first
        self._temps[sid] = t
        self._top_ks[sid] = k
        self._top_ps[sid] = p
        # A one-token request (or an immediate eos) finishes at admission
        # without ever joining a tick.
        if self.eos_token is not None and first == self.eos_token:
            self._evict(sid, RequestState.FINISHED, FinishReason.EOS)
        elif req.max_new_tokens == 1:
            self._evict(sid, RequestState.FINISHED, FinishReason.LENGTH)

    def _paged_append_blocks(self) -> None:
        """Before a tick: every live slot about to write at a block
        boundary gets a fresh PRIVATE block appended to its table. The
        allocation LRU-evicts unpinned cached chains under pressure; with
        the pool at its validated floor it cannot fail for a live stream
        (the JAX engine parks and replays the slot if a mis-sized pool
        ever makes it fail; replay is not ported, so this raises)."""
        bs = self.prefix_block_size
        for sid, handle in enumerate(self._slots):
            if handle is None:
                continue
            blk = int(self._positions[sid]) // bs
            if blk >= self._table_width or self._tables[sid, blk] != 0:
                continue
            ids = self._prefix.allocate(1)
            if not ids:
                raise RuntimeError(
                    f"block pool exhausted appending a block for slot "
                    f"{sid}; slot replay is not ported ({_ROADMAP_FEATURES})")
            self._tables[sid, blk] = ids[0]
            self._private[sid].append(ids[0])

    # --------------------------------------------------------------- tick
    def _tick(self) -> np.ndarray:
        """One fused decode step for every slot (parked ones write into
        the scratch sink): returns the sampled next tokens, host-side."""
        dev = self.device
        tokens = torch.from_numpy(self._tokens[:, None]).to(dev)
        logits = self.model(
            tokens, cache=self._cache,
            cache_index=torch.from_numpy(self._positions).to(dev),
            block_table=torch.from_numpy(self._tables).to(dev))
        nxt = sample_logits_batched(
            self._rng, logits[:, -1], temperature=self._temps,
            top_k=self._top_ks, top_p=self._top_ps)
        return nxt.cpu().numpy()  # per-tick host sync (streaming)

    @torch.no_grad()
    def step(self) -> int:
        """One engine tick: reap → admit → append blocks → one fused
        decode tick for all live slots → evict finished. Returns tokens
        emitted this step (admission first-tokens included)."""
        cur = self._step_idx
        self._step_idx = cur + 1
        t0 = self._clock()
        emitted_before = self.metrics.tokens_emitted
        self._reap()
        self._admit()
        self._paged_append_blocks()
        live = [i for i, s in enumerate(self._slots) if s is not None]
        new_tokens = 0
        if live:
            nxt = self._tick()
            for sid in live:
                handle = self._slots[sid]
                tok = int(nxt[sid])
                handle.tokens.append(tok)
                new_tokens += 1
                self._positions[sid] += 1
                self._tokens[sid] = tok
                if self.eos_token is not None and tok == self.eos_token:
                    self._evict(sid, RequestState.FINISHED, FinishReason.EOS)
                elif len(handle.tokens) >= handle.request.max_new_tokens:
                    self._evict(sid, RequestState.FINISHED,
                                FinishReason.LENGTH)
        now = self._clock()
        self.metrics.record_tick(now, self.scheduler.depth, len(live),
                                 self.max_slots, new_tokens, now - t0)
        self.metrics.record_paged_gauges(self.blocks_shared,
                                         self.block_table_fill)
        emitted = self.metrics.tokens_emitted - emitted_before
        self.telemetry.append({
            "step": cur, "t_s": now, "queue_depth": self.scheduler.depth,
            "live_slots": len(live), "tokens": emitted,
            "tick_wall_s": now - t0,
        })
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
