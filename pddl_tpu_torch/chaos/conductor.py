"""Seeded multi-plane chaos conductor + invariant referee.

The port's own copy of :mod:`pddl_tpu.chaos.conductor` (host Python, no
JAX): the same names, error texts, literal tables and wire shapes.

Every robustness test before this one exercised ONE fault plane per test:
device faults, replica death, wire storms,
router SIGKILL, disk failure. Jepsen-style
campaign testing and the gray-failure literature (Huang et al.,
HotOS '17) both make the same argument: real incidents COMPOSE — and
a recovery path that survives each plane alone can still deadlock,
double-free, or silently lose a stream when two planes overlap.

:class:`ChaosConductor` owns that composition. From one seed it draws
a randomized schedule of :class:`ChaosAction` coordinates — hard
kills, gray slow-wall spans, storage-fault storms, a router crash, a
primary/standby PARTITION — fires them against a live
fleet while the passive planes (device fault-plan rates, wire
fault-plan rates) run underneath, then settles the workload and runs
the INVARIANT REFEREE:

- **acked_terminal** — every acked stream reached a terminal state;
- **token_exact** — every finished stream matches the greedy oracle
  token-for-token (survivors, migrants, and revived streams alike);
- **zero_recompiles** — no survivor's engine compiled anything twice
  (recovery must ride warm executables, the repo's north-star rule);
- **pins_balanced** — every reachable radix/prefix refcount returned
  to zero (no stream leaked a pin through a mid-flight death);
- **recover_idempotent** — :func:`~pddl_tpu_torch.serve.fleet.journal.
  read_state` over the WAL directory is bit-stable across two reads
  (recovery is a pure fold, running it twice changes nothing);
- **recovery_bounded** — the router crash+recover cycle, when the
  campaign includes one, completed within ``recovery_bound_s``;
- **exposition_round_trip** — the surviving fleet's Prometheus
  exposition still parses under the strict referee;
- **trace_complete** — with distributed tracing armed
  (``router_kw=dict(dtrace=True)``), every acked stream's stitched
  fleet trace is gap-free across kills, migrations, and hand-offs
  (`pddl_tpu_torch.obs.assemble`); auto-skipped when tracing is off;
- **single_writer** — with the ``partition`` plane armed, no two
  routers' commands are accepted in the same epoch interval: every
  command the deposed primary attempted after the standby promoted
  was refused by epoch fencing (typed reject, counted); auto-skipped
  when the plane did not fire.

The conductor is deliberately duck-typed over fleets: the caller
supplies replica factories, per-replica :class:`ReplicaChaos` handles
(which knobs exist on a local vs process replica differs), the oracle,
and router policy; the conductor supplies the schedule, the drive
loop, the crash/recover choreography, and the referee. The same seed
against the same factories replays the same campaign — a failing
campaign is a reproducible bug report, not a flake.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pddl_tpu_torch.serve.fleet import journal as journal_io
from pddl_tpu_torch.serve.fleet.journal import RouterJournal
from pddl_tpu_torch.serve.fleet.replica import EpochFenced
from pddl_tpu_torch.serve.fleet.router import FleetRouter
from pddl_tpu_torch.serve.fleet.standby import (HotStandby, Lease, LeaseKeeper,
                                          WalShipper)
from pddl_tpu_torch.utils.faults import FaultKind


def local_kill(plan) -> None:
    """Schedule a hard KILL at an in-process replica's next engine
    tick — the :class:`~pddl_tpu_torch.utils.faults.FaultPlan` analog of
    SIGKILLing a worker process."""
    step = max(plan.step_idx + 1, 0)
    plan._sched.setdefault((step, "tick"), []).append(FaultKind.KILL)


@dataclasses.dataclass
class ReplicaChaos:
    """One replica's chaos surface — whichever knobs its driver type
    actually has. ``plan`` (device FaultPlan) and ``wire_plan`` are
    PASSIVE planes: armed at construction, they fire by their own
    seeded rates while the campaign runs. ``slow_fn(delay_s)`` turns
    the gray slow-wall on (``0.0`` turns it off); ``kill_fn()`` is the
    un-drainable hard death."""

    replica_id: int
    plan: Optional[object] = None
    wire_plan: Optional[object] = None
    slow_fn: Optional[Callable[[float], None]] = None
    kill_fn: Optional[Callable[[], None]] = None


@dataclasses.dataclass(frozen=True)
class ChaosAction:
    """One scheduled campaign event: at drive-loop step ``step``, do
    ``kind`` (``kill`` / ``slow_on`` / ``slow_off`` / ``storm_on`` /
    ``storm_off`` / ``router_crash`` / ``partition``) to
    ``replica_id`` (fleet-wide actions carry None)."""

    step: int
    kind: str
    replica_id: Optional[int] = None
    value: Optional[float] = None


@dataclasses.dataclass
class CampaignReport:
    """What one campaign did and what the referee concluded."""

    seed: int
    planes: Tuple[str, ...]
    actions: List[ChaosAction]
    steps: int
    wall_s: float
    recovery_s: Optional[float]
    injected: Dict[str, int]
    invariants: Dict[str, bool]
    violations: List[str]
    skipped: List[str]
    failover_s: Optional[float] = None  # partition plane: silence ->
    #                                     promoted standby serving

    @property
    def ok(self) -> bool:
        return all(self.invariants.values())


def _state_fingerprint(journal_dir: str) -> str:
    """Canonical JSON of the WAL fold — two reads of an untouched
    directory must produce identical bytes (recover() idempotence)."""
    entries, next_rid = journal_io.read_state(journal_dir)
    return json.dumps(
        {"next_rid": next_rid,
         "entries": [[rid, entries[rid]] for rid in sorted(entries)]},
        sort_keys=True, separators=(",", ":"))


def _fold_injected(chaos: Sequence[ReplicaChaos],
                   acc: Dict[str, int]) -> None:
    """Accumulate passive-plane injection counts out of a chaos
    surface — called before the surface is replaced at a router crash,
    so pre-crash wire/device injections survive into the report."""
    for c in chaos:
        if c.plan is not None:
            acc["device"] = acc.get("device", 0) + int(
                getattr(c.plan, "total_injected", 0))
        if c.wire_plan is not None:
            acc["wire"] = acc.get("wire", 0) + int(
                getattr(c.wire_plan, "total_injected", 0))


def _pins_balanced(fleet) -> Tuple[bool, List[str]]:
    """Every reachable in-process prefix index back at refcount zero
    (process replicas keep their pools behind the pipe — their engines
    check the same invariant under their own tests)."""
    bad: List[str] = []
    for slot in getattr(fleet, "replicas", []):
        engine = getattr(slot.driver, "engine", None)
        prefix = getattr(engine, "_prefix", None)
        if prefix is None:
            continue
        stack = [prefix._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not prefix._root and node.ref != 0:
                bad.append(f"replica {slot.replica_id}: block "
                           f"{node.block_id} ref={node.ref}")
    return (not bad), bad


class ChaosConductor:
    """Seeded campaign engine over a fleet factory.

    Args:
      make_replicas: ``fn() -> list[driver]`` — FRESH replica drivers
        (called once to build the fleet, again for crash recovery).
      make_chaos: ``fn(fleet) -> list[ReplicaChaos]`` — the chaos
        surface for the CURRENT fleet's replicas.
      oracle: ``fn(prompt, max_new_tokens) -> list[int]`` — the greedy
        reference the token-exact invariant compares against.
      journal_dir: WAL directory; arms the journal + the router-crash
        plane + the recover-idempotence referee. ``None`` = no WAL.
      storage_plan: the :class:`~pddl_tpu_torch.utils.faults.
        StorageFaultPlan` shared with the journal (the conductor
        drives its storm spans); ``None`` disables the storage plane.
      router_kw / journal_kw: policy forwarded to every
        :class:`FleetRouter` / :class:`RouterJournal` built here.
      recovery_bound_s: the bounded-recovery invariant's ceiling.
      seed: campaign PRNG seed — same seed, same schedule.
    """

    def __init__(self, make_replicas, make_chaos, oracle, *,
                 journal_dir: Optional[str] = None,
                 storage_plan=None,
                 router_kw: Optional[Dict] = None,
                 journal_kw: Optional[Dict] = None,
                 recovery_bound_s: float = 60.0,
                 seed: int = 0):
        self._make_replicas = make_replicas
        self._make_chaos = make_chaos
        self._oracle = oracle
        self.journal_dir = journal_dir
        self.storage_plan = storage_plan
        self._router_kw = dict(router_kw or {})
        self._journal_kw = dict(journal_kw or {})
        self.recovery_bound_s = float(recovery_bound_s)
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)

    # ------------------------------------------------------------ schedule
    def _draw_schedule(self, planes: Sequence[str], horizon: int,
                       chaos: List[ReplicaChaos], *, kills: int,
                       slow_delay_s: float,
                       storm_rate: float) -> List[ChaosAction]:
        rng = self._rng
        actions: List[ChaosAction] = []
        lo, hi = 2, max(3, int(horizon * 0.6))
        # Span-shaped planes (gray, storage storm) start EARLY so they
        # overlap live traffic — a storm over a drained fleet touches
        # no disk ops and proves nothing.
        early_hi = max(lo + 1, horizon // 4)
        if "kill" in planes:
            victims = [c for c in chaos if c.kill_fn is not None]
            for _ in range(min(kills, len(victims))):
                victim = victims[int(rng.integers(len(victims)))]
                actions.append(ChaosAction(int(rng.integers(lo, hi)),
                                           "kill", victim.replica_id))
        if "gray" in planes:
            slowables = [c for c in chaos if c.slow_fn is not None]
            if slowables:
                victim = slowables[int(rng.integers(len(slowables)))]
                start = int(rng.integers(lo, early_hi))
                span = int(rng.integers(4, max(5, horizon // 3)))
                actions.append(ChaosAction(start, "slow_on",
                                           victim.replica_id,
                                           slow_delay_s))
                actions.append(ChaosAction(start + span, "slow_off",
                                           victim.replica_id, 0.0))
        if "storage" in planes and self.storage_plan is not None:
            start = int(rng.integers(lo, early_hi))
            span = int(rng.integers(4, max(5, horizon // 3)))
            actions.append(ChaosAction(start, "storm_on", None,
                                       storm_rate))
            actions.append(ChaosAction(start + span, "storm_off"))
        if "router" in planes and self.journal_dir is not None:
            # After the mid-campaign window so the crash lands on a
            # fleet already carrying composed damage.
            actions.append(ChaosAction(int(rng.integers(hi, horizon)),
                                       "router_crash"))
        if "partition" in planes and self.journal_dir is not None:
            # Early-mid window, strictly BEFORE the router-crash
            # window: the partition's promoted standby is the router
            # the crash plane then gets to SIGKILL — the planes
            # compose instead of fighting over one takeover.
            actions.append(ChaosAction(int(rng.integers(lo, hi)),
                                       "partition"))
        actions.sort(key=lambda a: (a.step, a.kind))
        return actions

    # --------------------------------------------------------------- build
    def _build_journal(self) -> Optional[RouterJournal]:
        if self.journal_dir is None:
            return None
        return RouterJournal(self.journal_dir,
                             storage_plan=self.storage_plan,
                             **self._journal_kw)

    def _arm_ha(self, fleet, lease_ttl_s: float) -> Dict[str, object]:
        """The partition plane's precondition: a lease-armed primary
        (epoch stamped on every worker-bound command) with a hot
        standby tailing its WAL over the framed transport."""
        lease = Lease(os.path.join(self.journal_dir, "ha_lease.json"),
                      ttl_s=lease_ttl_s)
        keeper = LeaseKeeper(lease, "primary", seed=self.seed)
        fleet.set_epoch(keeper.acquire())
        standby = HotStandby(
            self.journal_dir, [s.driver for s in fleet.replicas],
            lease=lease, holder="standby", seed=self.seed + 1,
            router_kw=self._router_kw,
            journal_kw={"storage_plan": self.storage_plan,
                        **self._journal_kw})
        shipper = WalShipper(fleet._journal, standby.feed)
        standby.attach(shipper)
        return {"lease": lease, "keeper": keeper, "standby": standby,
                "shipper": shipper, "partitioned": False,
                "promoted": False, "probes_attempted": 0,
                "probes_refused": 0, "counted": 0}

    # ----------------------------------------------------------------- run
    def run(self, workload: Sequence[Tuple[Sequence[int], int]], *,
            planes: Sequence[str] = ("device", "wire", "storage",
                                     "gray", "kill", "router"),
            horizon: int = 40, kills: int = 1,
            slow_delay_s: float = 0.01, storm_rate: float = 1.0,
            max_wall_s: float = 120.0,
            pace_s: float = 0.0, lease_ttl_s: float = 0.25,
            partition_probes: int = 3) -> CampaignReport:
        """One campaign: build fleet, submit workload, fire the drawn
        schedule while stepping, settle, referee. Prompts must be
        unique per campaign (they key the token-exact check across a
        router crash).

        ``pace_s`` sleeps between steps WHILE actions are pending:
        process fleets step orders of magnitude faster than their
        workers produce tokens, so an unpaced schedule can fire its
        whole horizon before any traffic exists for the planes to
        overlap. Once the schedule drains, settling spins unpaced."""
        t0 = time.monotonic()
        prompts = [tuple(int(t) for t in p) for p, _ in workload]
        if len(set(prompts)) != len(prompts):
            raise ValueError("campaign prompts must be unique")
        reps = self._make_replicas()
        fleet = FleetRouter(reps, journal=self._build_journal(),
                            **self._router_kw)
        chaos = self._make_chaos(fleet)
        by_id = {c.replica_id: c for c in chaos}
        ha = (self._arm_ha(fleet, lease_ttl_s)
              if "partition" in planes and self.journal_dir is not None
              else None)
        failover_s: Optional[float] = None
        schedule = self._draw_schedule(planes, horizon, chaos,
                                       kills=kills,
                                       slow_delay_s=slow_delay_s,
                                       storm_rate=storm_rate)
        pending = list(schedule)
        expect = {tuple(int(t) for t in p): list(self._oracle(list(p), n))
                  for p, n in workload}
        handles = [(tuple(int(t) for t in p), int(n),
                    fleet.submit(list(p), int(n)))
                   for p, n in workload]
        violations: List[str] = []
        skipped: List[str] = []
        injected_acc: Dict[str, int] = {}
        storm_baseline: Optional[int] = None
        finished_pre_crash: List[Tuple[tuple, List[int]]] = []
        recovery_s: Optional[float] = None
        revived_handles: Dict[int, object] = {}
        crashed = False
        step_idx = 0
        deadline = t0 + max_wall_s
        while time.monotonic() < deadline:
            while pending and pending[0].step <= step_idx:
                action = pending.pop(0)
                if action.kind in ("kill", "slow_on", "slow_off"):
                    target = by_id.get(action.replica_id)
                    fn = (target.kill_fn if action.kind == "kill"
                          else target.slow_fn) if target else None
                    if fn is not None:
                        try:
                            if action.kind == "kill":
                                fn()
                            else:
                                fn(action.value or 0.0)
                        except Exception:  # noqa: BLE001 - chaos on an
                            pass           # already-dead target is a no-op
                elif action.kind == "storm_on":
                    self.storage_plan._rates = (
                        float(action.value or 1.0), 0.0, 0.0, 0.0)
                    storm_baseline = int(
                        self.storage_plan.total_injected)
                elif action.kind == "storm_off":
                    live_now = (revived_handles.values() if crashed
                                else [fh for _, _, fh in handles])
                    if (storm_baseline is not None
                            and int(self.storage_plan.total_injected)
                            == storm_baseline
                            and not all(fh.done for fh in live_now)):
                        # The storm has not touched a single disk op
                        # yet (workers may still be prefilling): hold
                        # it until it bites or the fleet drains — a
                        # storm over an idle journal proves nothing.
                        pending.append(
                            ChaosAction(step_idx + 1, "storm_off"))
                        pending.sort(key=lambda a: (a.step, a.kind))
                        continue
                    storm_baseline = None
                    self.storage_plan._rates = (0.0, 0.0, 0.0, 0.0)
                elif action.kind == "partition":
                    if ha is None:
                        continue
                    # Full bidirectional silence: the primary stops
                    # being stepped and stops renewing — but the
                    # OBJECT stays alive, and after the standby
                    # promotes it keeps trying to command (the mode
                    # kill can never produce).
                    ha["partitioned"] = True
                    if self.storage_plan is not None:
                        # Promotion arms a FRESH journal against the
                        # disk exactly like cold recovery does — a
                        # still-raging storm would fail that open, so
                        # the partition ends the storm (same call the
                        # router_crash plane makes below).
                        self.storage_plan._rates = (0.0, 0.0, 0.0, 0.0)
                        storm_baseline = None
                    t_part = time.monotonic()
                    promoted = None
                    while time.monotonic() < deadline:
                        out = ha["standby"].step()
                        if out is not None:
                            promoted = out
                            break
                        time.sleep(0.005)
                    if promoted is None:
                        violations.append(
                            "standby never promoted during partition")
                        continue
                    new_fleet, reborn = promoted
                    failover_s = time.monotonic() - t_part
                    ha["promoted"] = True
                    # The deposed-but-alive primary issues commands:
                    # every one must come back a TYPED EpochFenced
                    # reject — and the refusal must be counted.
                    for k in range(int(partition_probes)):
                        probe = [1 + (k % 30)] * (6 + k)
                        ha["probes_attempted"] += 1
                        try:
                            fleet.submit(probe, 4)
                        except EpochFenced:
                            ha["probes_refused"] += 1
                        except Exception:  # noqa: BLE001 - any other
                            pass   # outcome is NOT a fencing refusal
                    ha["counted"] = int(
                        fleet.metrics.fenced_commands_refused)
                    # The workload rides over: reborn handles replace
                    # the deposed router's, matched by unique prompt
                    # (finished streams keep their settled handles).
                    reborn_by_prompt = {
                        tuple(int(t) for t in fh.request.prompt): fh
                        for fh in reborn.values()}
                    handles = [(ptup, n, reborn_by_prompt.get(ptup, fh))
                               for ptup, n, fh in handles]
                    fleet = new_fleet
                elif action.kind == "router_crash":
                    crashed = True
                    if self.storage_plan is not None:
                        # Recovery re-opens the journal against the
                        # disk: a still-raging storm would fail that
                        # open, so the crash ends the storm (it proved
                        # what it could).
                        self.storage_plan._rates = (0.0, 0.0, 0.0, 0.0)
                        storm_baseline = None
                    _fold_injected(chaos, injected_acc)
                    fleet, recovery_s, revived_handles, chaos = \
                        self._crash_and_recover(fleet, chaos, violations)
                    by_id = {c.replica_id: c for c in chaos}
                    for ptup, n, fh in handles:
                        if fh.done and fh.state.value == "finished":
                            finished_pre_crash.append(
                                (ptup, list(fh.tokens)))
            fleet.step()
            if ha is not None:
                if not ha["partitioned"]:
                    ha["keeper"].step()   # primary keeps its lease
                elif ha["promoted"]:
                    ha["standby"].step()  # promoted standby renews
            step_idx += 1
            live = (revived_handles.values() if crashed
                    else [fh for _, _, fh in handles])
            if not pending and all(fh.done for fh in live):
                break
            if pending and pace_s > 0.0:
                time.sleep(pace_s)
        wall_s = time.monotonic() - t0
        report = self._referee(fleet, handles, expect, crashed,
                               finished_pre_crash, revived_handles,
                               recovery_s, violations, skipped, planes,
                               ha)
        report.actions = schedule
        report.steps = step_idx
        report.wall_s = wall_s
        report.failover_s = failover_s
        _fold_injected(chaos, injected_acc)
        if self.storage_plan is not None:
            injected_acc["storage"] = int(
                self.storage_plan.total_injected)
        report.injected = injected_acc
        fleet.close()
        return report

    # ------------------------------------------------------- crash/recover
    def _crash_and_recover(self, fleet, chaos, violations):
        """The router-SIGKILL plane: abandon the live router un-closed
        (exactly what a SIGKILL leaves — buffered, un-fsynced tail
        lost), reap its replicas, verify the WAL fold is bit-stable,
        then rebuild over FRESH replicas via :meth:`FleetRouter.
        recover` and time the cycle until every revived stream made
        forward progress."""
        for c in chaos:
            if c.kill_fn is not None:
                try:
                    c.kill_fn()
                except Exception:  # noqa: BLE001 - already-dead victim
                    pass
        fp1 = _state_fingerprint(self.journal_dir)
        fp2 = _state_fingerprint(self.journal_dir)
        if fp1 != fp2:
            violations.append("read_state not bit-stable across reads")
        t0 = time.monotonic()
        reps = self._make_replicas()
        recovered, revived = FleetRouter.recover(
            self.journal_dir, reps, journal=self._build_journal(),
            **self._router_kw)
        mirrored = {rid: len(fh.tokens) for rid, fh in revived.items()}
        deadline = time.monotonic() + self.recovery_bound_s
        while time.monotonic() < deadline:
            recovered.step()
            if all(fh.done or len(fh.tokens) > mirrored[rid]
                   for rid, fh in revived.items()):
                break
        recovery_s = time.monotonic() - t0
        new_chaos = self._make_chaos(recovered)
        return recovered, recovery_s, revived, new_chaos

    # -------------------------------------------------------------- referee
    def _referee(self, fleet, handles, expect, crashed,
                 finished_pre_crash, revived_handles, recovery_s,
                 violations, skipped, planes,
                 ha=None) -> CampaignReport:
        invariants: Dict[str, bool] = {}
        live = (list(revived_handles.values()) if crashed
                else [fh for _, _, fh in handles])
        invariants["acked_terminal"] = all(fh.done for fh in live)
        if not invariants["acked_terminal"]:
            violations.append(
                f"{sum(not fh.done for fh in live)} acked stream(s) "
                f"not terminal")
        exact = True
        checked = 0
        if crashed:
            pairs = list(finished_pre_crash) + [
                (tuple(int(t) for t in fh.request.prompt),
                 list(fh.tokens))
                for fh in revived_handles.values()
                if fh.done and fh.state.value == "finished"]
        else:
            pairs = [(ptup, list(fh.tokens)) for ptup, _, fh in handles
                     if fh.done and fh.state.value == "finished"]
        for ptup, toks in pairs:
            checked += 1
            if toks != expect[ptup]:
                exact = False
                violations.append(
                    f"stream {ptup[:4]}...: tokens diverged from "
                    f"oracle ({toks[:6]} vs {expect[ptup][:6]})")
        if checked == 0:
            exact = False
            violations.append("no finished stream to verify")
        invariants["token_exact"] = exact
        counts = fleet.compile_counts()
        invariants["zero_recompiles"] = bool(counts) and all(
            v == 1 for v in counts.values())
        if not invariants["zero_recompiles"]:
            violations.append(f"recompiles: {counts}")
        balanced, bad = _pins_balanced(fleet)
        invariants["pins_balanced"] = balanced
        violations.extend(bad)
        if self.journal_dir is not None:
            fp1 = _state_fingerprint(self.journal_dir)
            fp2 = _state_fingerprint(self.journal_dir)
            invariants["recover_idempotent"] = (
                fp1 == fp2
                and not any("bit-stable" in v for v in violations))
        else:
            invariants["recover_idempotent"] = True
            skipped.append("recover_idempotent (no journal)")
        if "router" in planes and self.journal_dir is not None:
            invariants["recovery_bounded"] = (
                recovery_s is not None
                and recovery_s <= self.recovery_bound_s)
            if not invariants["recovery_bounded"]:
                violations.append(f"recovery took {recovery_s}s "
                                  f"(bound {self.recovery_bound_s}s)")
        else:
            invariants["recovery_bounded"] = True
            skipped.append("recovery_bounded (no router crash)")
        try:
            from pddl_tpu_torch.obs.export import (fleet_exposition,
                                             parse_prometheus_text)
            parse_prometheus_text(fleet_exposition(fleet))
            invariants["exposition_round_trip"] = True
        except Exception as e:  # noqa: BLE001 - the referee reports
            invariants["exposition_round_trip"] = False
            violations.append(f"exposition: {e}")
        if ha is not None and ha.get("promoted"):
            attempted = int(ha["probes_attempted"])
            refused = int(ha["probes_refused"])
            counted = int(ha["counted"])
            invariants["single_writer"] = (
                attempted > 0 and refused == attempted
                and counted >= attempted)
            if not invariants["single_writer"]:
                violations.append(
                    f"single_writer: {refused}/{attempted} deposed "
                    f"commands refused ({counted} counted)")
        else:
            invariants["single_writer"] = True
            skipped.append("single_writer (partition plane not fired)")
        collector = getattr(fleet, "dtrace", None)
        if collector is None:
            invariants["trace_complete"] = True
            skipped.append("trace_complete (tracing not armed)")
        else:
            # A few extra pump rounds first: span batches for the very
            # last finishes may still sit in worker pipes.
            for _ in range(3):
                try:
                    fleet.step()
                except Exception:  # noqa: BLE001 - settled fleet only
                    break
            from pddl_tpu_torch.obs.assemble import stitch
            gappy: List[str] = []
            for tid, trace in stitch(collector.records()).items():
                for gap in trace.gaps():
                    gappy.append(f"trace {tid}: {gap}")
            invariants["trace_complete"] = not gappy
            violations.extend(gappy[:5])
        return CampaignReport(
            seed=self.seed, planes=tuple(planes), actions=[], steps=0,
            wall_s=0.0, recovery_s=recovery_s, injected={},
            invariants=invariants, violations=violations,
            skipped=skipped)
