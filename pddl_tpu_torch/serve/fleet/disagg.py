"""Disaggregated prefill/decode serving: role-split fleet with
block-granular KV hand-off.

The port's own copy of :mod:`pddl_tpu.serve.fleet.disagg` (host Python,
no JAX): the same names, error texts, literal tables and wire shapes.

DistServe (Zhong et al., OSDI '24) and Splitwise (Patel et al., ISCA
'24) make the case this module implements: prefill and decode have
opposite resource shapes — prefill is compute-bound and bursty, decode
is latency-bound and steady — so co-locating them means one long cold
prompt admitted onto a decode-heavy replica inflates every resident
stream's token latency. The fix is to split the ROLES: prefill
replicas absorb cold prompts (chunked through the engine's
``prefill_slice_tokens`` state machine, so even a 32k prompt
time-slices against the prefill replica's own tick), and the finished
KV chain ships to a decode replica whose resident streams never pay
for it.

**Roles.** Every replica driver carries a ``role`` — ``prefill``,
``decode``, or ``unified`` (the default, fully backward compatible:
an all-unified fleet routes exactly like an undisaggregated one). The
fleet is ARMED for disaggregation when it holds at least one strict-``prefill`` AND one
strict-``decode`` replica; while armed, the router sends every
non-sticky admission to the prefill pool (route label ``prefill``),
and sticky sessions keep following their stream — which, after the
hand-off, lives on a decode replica.

**The hand-off.** The first token a prefill replica emits for a
stream is the completion signal: prefill is done, decode has begun in
the wrong place. The :class:`HandoffManager` (driven by the router
AFTER its slot loop, the same no-mutation-under-iteration discipline
the autoscaler rides) then rebinds the stream:

1. the finished prefill chain exports from the source over the
   `serve/drain.py` chain wire format (the ``chain_pull_blocks``
   machinery) and imports into the decode replica's HOST tier, where
   the replay admission PROMOTES it — block copies, not prefill
   compute, are all the decode replica pays;
2. the stream itself moves by the mirror-replay contract under a
   FRESH rid (the source's cancel-finish must fall into the void, not
   settle the moved stream), journaled under the original rid via the
   same alias discipline hedges use;
3. the router stamps the rebinding in the WAL
   (:func:`~pddl_tpu_torch.serve.fleet.journal.encode_handoff`) and counts
   it (``handoffs_completed``/``handoffs_failed``/``handoff_bytes``/
   ``handoff_tokens``).

Every failure mode degrades, never loses: a source that dies
mid-export unwinds through ``_on_death`` (the stream re-prefills
elsewhere, token-exact; the engine's export pins release in its own
``finally``), a dead import target likewise, and a merely REFUSED
transfer leaves the stream decoding on the prefill replica (slow
beats wrong) and counts a failure.

**Per-role autoscaling.** :class:`RoleAutoscaler` multiplexes one
:class:`~pddl_tpu_torch.serve.fleet.autoscaler.FleetAutoscaler` per role
pool behind the single ``step()``/``close()``/``gauges()`` surface the
router drives — independent pressure/load bands per role, shared
replica-id line, one decision per role per routing round. Sizing the
pools is the operator's lever (docs/OPERATIONS.md § "Disaggregated
serving runbook").
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from pddl_tpu_torch.utils.faults import KillPoint

# Machine-checked role vocabulary: the
# replica roles the router, the drivers, and the worker process all
# agree on. `fleet/worker.py` declares the same literal tuple — the
# rule pins the two to set equality, so a role added here cannot be a
# config value the worker silently rejects (or vice versa).
ROLES = ("prefill", "decode", "unified")


def validate_role(role) -> str:
    """Normalize + validate a replica role (None -> ``unified``)."""
    role = "unified" if role is None else str(role)
    if role not in ROLES:
        raise ValueError(f"replica role must be one of {ROLES}, "
                         f"got {role!r}")
    return role


def role_of(driver) -> str:
    """A driver's role; drivers predating disaggregation are ``unified``."""
    return getattr(driver, "role", "unified")


def _chain_wire_bytes(entry) -> int:
    """Payload size of a chain wire entry (the b64 block leaves) — the
    hand-off bytes the exposition counts."""
    if not isinstance(entry, dict):
        return 0
    total = 0
    for block in entry.get("blocks", []):
        for leaf in block.values():
            b64 = leaf.get("b64") if isinstance(leaf, dict) else None
            if isinstance(b64, str):
                total += len(b64)
    return total


class HandoffManager:
    """The prefill->decode rebinding executor, owned by one
    :class:`~pddl_tpu_torch.serve.fleet.router.FleetRouter`.

    The router's event loop calls :meth:`note` when a stream's first
    tokens arrive on a prefill-role slot, and :meth:`execute` once per
    routing round AFTER the slot loop — a hand-off restores onto
    another slot and must never happen under the slot iteration."""

    def __init__(self, router):
        self._router = router
        self._pending: List[int] = []
        # Streams whose transfer a target REFUSED (no host tier /
        # budget): they finish where they are — retrying every round
        # would pay the export D2H again and again for nothing.
        self._refused: set = set()
        # Streams already counted against decode_long_prompt_stalls
        # (one count per stream, however many rounds the stall lasts —
        # these DO retry, a decode replica may free up).
        self._stalled: set = set()

    @property
    def pending(self) -> int:
        return len(self._pending)

    def note(self, rid: int) -> None:
        """Mark one rid as decode-ready (its prefill slot just emitted
        tokens). Idempotent within a round."""
        if rid in self._refused:
            return
        if rid not in self._pending:
            self._pending.append(rid)

    def execute(self) -> int:
        """Run every pending hand-off; returns how many completed."""
        if not self._pending:
            return 0
        pending, self._pending = self._pending, []
        moved = 0
        for rid in pending:
            moved += self._handoff_one(rid)
        # The give-up/stall sets hold rids, and rids outlive streams:
        # purge settled ones so a long-lived router cannot leak.
        if self._refused or self._stalled:
            live = set(self._router._by_rid)
            self._refused &= live
            self._stalled &= live
        return moved

    def _handoff_one(self, rid: int) -> int:
        from pddl_tpu_torch.serve.fleet import journal as journal_io
        from pddl_tpu_torch.serve.fleet.replica import ReplicaDied

        r = self._router
        fh = r._by_rid.get(rid)
        # Hedged pairs keep their own settle ceremony: a hand-off of
        # one copy would race the first-result-wins cancellation.
        if fh is None or fh.done or rid in r._hedge_peer \
                or rid in r._hedge_rids:
            return 0
        src = next((s for s in r._slots if rid in s.assigned), None)
        if src is None or role_of(src.driver) != "prefill" \
                or not src.available:
            return 0
        targets = [s for s in r._slots
                   if s.available and s is not src
                   and role_of(s.driver) in ("decode", "unified")]
        if not targets:
            # No decode replica can take it: the long prompt decodes
            # where it prefilled for now — the interference the stall
            # gauge makes visible on the dashboard. Counted once per
            # stream; the next tokens event re-notes it, so the move
            # still happens if a decode replica frees up.
            if rid not in self._stalled:
                self._stalled.add(rid)
                r.metrics.decode_long_prompt_stalls += 1
            return 0
        dst = min(targets, key=lambda s: s.load)
        prompt = list(fh.request.prompt)
        t0 = r._gray_timer()
        # The stream's trace follows it across the rebind below: both
        # chain-wire legs carry the ORIGINAL trace context, and the
        # fresh rid aliases back (`TraceCollector.rebind`) so one
        # stitched trace spans prefill replica -> wire -> decode.
        collector = r._dtrace
        ctx = (collector.context_for(rid)
               if collector is not None else None)
        export_s = import_s = 0.0
        # 1. Ship the finished prefill KV: source exports the chain
        # (drain wire format), target lands it in its HOST tier. The
        # engine's export pins the chain for exactly the copy and
        # releases in its own finally — a KillPoint here leaks
        # nothing, it kills the replica and the unwind below
        # re-prefills the stream elsewhere.
        chain = None
        n_blocks = 0
        export = getattr(src.driver, "export_chain", None)
        import_fn = getattr(dst.driver, "import_chain", None)
        try:
            if export is not None:
                t_leg = r._gray_timer()
                chain = (export(prompt, None, trace=ctx)
                         if ctx is not None else export(prompt, None))
                export_s = r._gray_timer() - t_leg
        except (KillPoint, ReplicaDied) as e:
            r.metrics.handoffs_failed += 1
            r._on_death(src, e)
            return 0
        except Exception:  # noqa: BLE001 - refused export: move anyway
            chain = None
        if chain and import_fn is not None:
            try:
                t_leg = r._gray_timer()
                n_blocks = (import_fn(chain, trace=ctx)
                            if ctx is not None else import_fn(chain))
                import_s = r._gray_timer() - t_leg
            except (KillPoint, ReplicaDied) as e:
                r.metrics.handoffs_failed += 1
                r._on_death(dst, e)
                return 0
            except Exception:  # noqa: BLE001 - refused import
                n_blocks = 0
        if not n_blocks:
            # The KV did not land (no host tier, refused import, empty
            # export): moving the stream would make the target
            # re-prefill the long prompt — the exact interference this
            # subsystem exists to prevent. Keep decoding on the
            # prefill replica instead (slow for this stream, harmless
            # for the residents), count the failure, and stop retrying
            # this stream.
            self._refused.add(rid)
            r.metrics.handoffs_failed += 1
            r._tracer.on_fleet_event(
                "handoff_refused", request_id=fh.request.request_id,
                from_replica=src.replica_id, to_replica=dst.replica_id)
            return 0
        # 2. Commit point: move the stream under a FRESH rid. The
        # source's cancel produces a finish event for the OLD rid,
        # which must fall into the void (`_by_rid` miss) instead of
        # settling the moved stream — the same unbinding discipline
        # `_settle_hedge` uses. The journal keeps the original rid:
        # its admit is filed there, so tokens/finish/checkpoint alias
        # back (the hedge-alias mechanism, reused verbatim).
        new_rid = r._new_rid()
        entry = r._wire_entry(fh)
        src.assigned.pop(rid, None)
        r._by_rid.pop(rid, None)
        old_alias = r._hedge_alias.pop(rid, rid)
        try:
            src.driver.cancel(rid)
        except Exception:  # noqa: BLE001 - a dying source settles later
            pass
        if collector is not None:
            collector.rebind(rid, new_rid)
        try:
            if collector is not None:
                dst.driver.restore(
                    [(new_rid, entry)],
                    traces={new_rid: collector.context_for(new_rid)})
            else:
                dst.driver.restore([(new_rid, entry)])
        except (KillPoint, ReplicaDied) as e:
            r.metrics.handoffs_failed += 1
            r._on_death(dst, e)
            # The stream is bound nowhere right now: re-enter it
            # through the migration machinery from a fresh mirror.
            r._hedge_alias[new_rid] = old_alias
            if not fh.done:
                r._distribute([(new_rid, r._wire_entry(fh), fh)],
                              "replay")
            return 0
        # 3. Rebind.
        fh.replica_id = dst.replica_id
        fh.migrations += 1
        dst.assigned[new_rid] = fh
        r._by_rid[new_rid] = fh
        r._hedge_alias[new_rid] = old_alias
        dst.shadow.observe(prompt, max_blocks=r._affinity_blocks)
        if n_blocks > 0:
            pulled = (len(chain.get("tokens", [])) // r._block_size
                      if isinstance(chain, dict) else n_blocks)
            dst.shadow.observe_host(
                prompt, max_blocks=min(r._affinity_blocks, pulled))
        if fh.session is not None:
            r._session_pin(fh.session, dst)
        moved_bytes = _chain_wire_bytes(chain) if n_blocks > 0 else 0
        moved_tokens = (len(chain.get("tokens", []))
                        if n_blocks > 0 and isinstance(chain, dict)
                        else 0)
        r.metrics.handoffs_completed += 1
        r.metrics.handoff_bytes += moved_bytes
        r.metrics.handoff_tokens += moved_tokens
        if r._journal is not None:
            r._journal.append(journal_io.encode_handoff(
                old_alias, src.replica_id, dst.replica_id))
        r._tracer.on_fleet_event(
            "handoff", request_id=fh.request.request_id,
            from_replica=src.replica_id, to_replica=dst.replica_id,
            blocks=n_blocks, bytes=moved_bytes,
            ms=round((r._gray_timer() - t0) * 1e3, 3))
        if collector is not None:
            collector.on_handoff(new_rid, src.replica_id,
                                 dst.replica_id, export_s, import_s,
                                 n_blocks)
        return 1


class _SummedAutoscaleMetrics:
    """The per-role controllers' counters summed into one snapshot —
    the exposition surface :func:`~pddl_tpu_torch.obs.export.fleet_exposition`
    reads is identical for a single controller and a multiplexer."""

    def __init__(self, controllers: Dict[str, object]):
        self._controllers = controllers

    def snapshot(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for controller in self._controllers.values():
            for key, n in controller.metrics.snapshot().items():
                out[key] = out.get(key, 0) + n
        return out


class RoleAutoscaler:
    """Per-role capacity control: one hysteretic
    :class:`~pddl_tpu_torch.serve.fleet.autoscaler.FleetAutoscaler` per role
    pool, multiplexed behind the single ``step()``/``close()`` surface
    the router drives.

    Args:
      router: the fleet to control; the constructor attaches itself
        (so ``router.step()`` drives one decision tick PER ROLE per
        routing round — the pools' pressure signals are independent).
      factories: ``{role: fn(replica_id) -> driver}`` — each factory
        must return a driver carrying that role (the role is the
        factory's contract, not the controller's to stamp). One
        controller is built per entry; roles absent from the map are
        not scaled.
      per_role: optional ``{role: kwargs}`` overriding ``common_kw``
        for that role's controller (independent min/max and bands —
        the sizing lever the runbook describes).
      **common_kw: forwarded to every controller
        (:class:`FleetAutoscaler` kwargs).
    """

    def __init__(self, router, factories: Dict[str, object], *,
                 per_role: Optional[Dict[str, Dict]] = None,
                 **common_kw):
        from pddl_tpu_torch.serve.fleet.autoscaler import FleetAutoscaler

        if not factories:
            raise ValueError("RoleAutoscaler needs at least one role "
                             "factory")
        self.router = router
        # One replica-id line across every pool: two controllers
        # minting ids independently would collide on the shared fleet.
        next_id = 1 + max((s.replica_id for s in router.replicas),
                          default=-1)
        self._ids = itertools.count(next_id)
        self.controllers: Dict[str, object] = {}
        for role in sorted(factories):
            kw = dict(common_kw)
            kw.update((per_role or {}).get(role, {}))
            self.controllers[role] = FleetAutoscaler(
                router, factories[role], role=validate_role(role),
                attach=False, id_alloc=lambda: next(self._ids), **kw)
        self.metrics = _SummedAutoscaleMetrics(self.controllers)
        router.attach_autoscaler(self)

    def step(self, now: Optional[float] = None) -> Dict[str, object]:
        """One control tick per role pool; returns each pool's
        :class:`~pddl_tpu_torch.serve.fleet.autoscaler.ScaleDecision`."""
        return {role: c.step(now)
                for role, c in self.controllers.items()}

    def close(self) -> None:
        for controller in self.controllers.values():
            controller.close()

    @property
    def pending_spawns(self) -> int:
        return sum(c.pending_spawns for c in self.controllers.values())

    def gauges(self) -> Dict[str, object]:
        """Merged controller gauges: fleet-wide scalars plus the
        per-role pool sizes/bounds as labeled series."""
        any_controller = next(iter(self.controllers.values()))
        return {
            "replicas": len(self.router.replicas),
            "pending_spawns": self.pending_spawns,
            "pressure": any_controller._last_pressure,
            "role_replicas": {
                role: len(c._pool())
                for role, c in self.controllers.items()},
            "role_pending_spawns": {
                role: c.pending_spawns
                for role, c in self.controllers.items()},
            "role_min_replicas": {
                role: c.min_replicas
                for role, c in self.controllers.items()},
            "role_max_replicas": {
                role: c.max_replicas
                for role, c in self.controllers.items()},
            "role_mean_load": {
                role: round(c.mean_load(), 4)
                for role, c in self.controllers.items()},
        }
