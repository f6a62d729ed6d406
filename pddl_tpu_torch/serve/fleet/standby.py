"""Router high availability: WAL-shipped hot standby with fenced
takeover.

The port's own copy of :mod:`pddl_tpu.serve.fleet.standby` (host Python,
no JAX): the same names, error texts, literal tables and wire shapes.

The journal made the router's control-plane state durable and the
storage-fault layer made the STORAGE under it untrusted — but recovery
stayed cold:
``FleetRouter.recover()`` is an offline restart someone must invoke
(12.2 s median in the campaigns, every stream stalled throughout),
and nothing defends against the failure mode the gray-failure
literature calls the worst one: an alive-yet-partitioned primary that
keeps issuing commands. This module closes both gaps with the
primary/backup discipline production control planes use (Borg;
ZooKeeper/Raft-style leases):

- :class:`WalShipper` — primary side. Hooks the journal's
  ``on_record`` observer and ships EVERY append (NON_DURABLE buffered
  ones included) as an CRC-framed line to a sink, so the standby's
  view is bounded by the wire, not by fsync latency.
- :class:`WalTail` — standby side. Feeds shipped lines through a
  :class:`~.transport.FrameReceiver` (validated, deduplicated,
  re-ordered) and folds the records incrementally into exactly the
  state ``journal.read_state`` would recover: ``{rid: drain entry}``
  mirrors plus ``next_rid``, plus the rid->replica bindings and the
  writer's fencing epoch. Joining mid-stream — or losing frames a
  one-way replication stream can never resend — falls back to a disk
  catch-up from checkpoint+segment (counted: ``standby_catchups``).
- :class:`Lease` / :class:`LeaseKeeper` — file-backed single-writer
  lease. The holder renews on a seeded SUBTRACTIVE jitter schedule
  (the breaker/spawn discipline: jitter only ever fires renewal
  EARLY, so it can never eat the lease's safety margin); a standby
  promotes when the lease lapses. Epochs increment on every change of
  holder — the epoch IS the single-writer token.
- :class:`HotStandby` — ties them together. ``step()`` watches the
  lease and tails the stream; ``promote()`` fences every live replica
  at the new epoch FIRST (a deposed-but-alive primary physically
  cannot double-drive the fleet — workers refuse its stale-epoch
  commands with a typed reject), cancels the stale in-flight streams,
  then rebuilds a :class:`~.router.FleetRouter` over the SAME live
  driver objects (no respawn, no weight reload, no recompile — that is
  the sub-second hot path) and re-enters every unfinished stream
  through the mirror-replay contract, token-exact under fresh
  rids.

Loss-window semantics under storage faults: a primary whose
journal degraded NON_DURABLE still ships every record over the wire,
so a healthy stream loses nothing; if frames are ALSO lost (the
partition case), the window is exactly the fsync-batched token deltas
— whose replay regenerates identical token values, because decoding is
a pure function of (params, prompt, tokens-so-far).
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Callable, Dict, List, Optional, Tuple

from pddl_tpu_torch.serve.fleet import journal as journal_io
from pddl_tpu_torch.serve.fleet.replica import EpochFenced, ReplicaDied
from pddl_tpu_torch.serve.fleet.router import FleetHandle, FleetRouter
from pddl_tpu_torch.serve.fleet.transport import FrameReceiver, FrameSender, \
    decode_frame, FrameError


class LeaseHeld(RuntimeError):
    """Acquisition refused: another holder's lease has not expired.
    The standby's promotion path treats this as "the primary is alive
    after all" — it keeps tailing instead of splitting the brain."""

    def __init__(self, holder: str, other: str, remaining_s: float):
        self.holder = holder
        self.other = other
        self.remaining_s = float(remaining_s)
        super().__init__(
            f"lease held by {other!r} for another "
            f"{remaining_s:.3f}s (requested by {holder!r})")


class Lease:
    """File-backed single-writer lease: ``{holder, epoch, renewed_s,
    expires_s}`` written atomically (tmp + replace, the checkpoint
    discipline). The EPOCH increments exactly when the holder CHANGES
    — re-acquisition and renewal by the same holder keep it — so two
    routers can never both believe they own the same epoch interval.

    Clocks: ``clock`` must be shared by every contender (the default
    ``time.monotonic`` is per-host — which is the deployment unit here;
    a cross-host lease store would bring its own clock, like every
    lease service does).
    """

    def __init__(self, path: str, *, ttl_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if ttl_s <= 0.0:
            raise ValueError(f"ttl_s must be positive, got {ttl_s}")
        self.path = str(path)
        self.ttl_s = float(ttl_s)
        self._clock = clock

    def read(self) -> Optional[Dict[str, object]]:
        """The current lease body, or None when absent/unreadable (a
        torn write is impossible by construction; a missing file means
        nobody has ever held it)."""
        try:
            with open(self.path) as f:
                body = json.load(f)
        except (OSError, ValueError):
            return None
        return body if isinstance(body, dict) else None

    def _write(self, body: Dict[str, object]) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(body, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def acquire(self, holder: str, *, steal: bool = False) -> int:
        """Take (or retake) the lease; returns the epoch now owned.
        Raises :class:`LeaseHeld` when another holder's lease is still
        live — unless ``steal=True``, the operator's forced-failover
        override (the deposed holder is still fenced out by the epoch
        bump, so a steal is rude but never unsafe)."""
        now = self._clock()
        cur = self.read()
        epoch = 0
        if cur is not None:
            epoch = int(cur.get("epoch", 0))
            if str(cur.get("holder")) != holder:
                remaining = float(cur.get("expires_s", 0.0)) - now
                if remaining > 0.0 and not steal:
                    raise LeaseHeld(holder, str(cur.get("holder")),
                                    remaining)
                epoch += 1  # holder change: new single-writer interval
        else:
            epoch = 1  # first holder ever arms epoch 1
        self._write({"holder": str(holder), "epoch": int(epoch),
                     "renewed_s": now, "expires_s": now + self.ttl_s})
        return int(epoch)

    def renew(self, holder: str) -> bool:
        """Extend the expiry iff ``holder`` still owns the lease.
        False means deposed: someone else took over (or the file is
        gone) — the caller must stop acting as primary."""
        cur = self.read()
        if cur is None or str(cur.get("holder")) != holder:
            return False
        now = self._clock()
        cur["renewed_s"] = now
        cur["expires_s"] = now + self.ttl_s
        self._write(cur)
        return True

    def age_s(self) -> Optional[float]:
        """Seconds since the current holder last renewed — the
        ``lease_age_s`` gauge. None when nobody holds it (rendered
        NaN by the exposition)."""
        cur = self.read()
        if cur is None:
            return None
        return max(0.0, self._clock() - float(cur.get("renewed_s", 0.0)))

    def expired(self) -> bool:
        cur = self.read()
        if cur is None:
            return True
        return self._clock() >= float(cur.get("expires_s", 0.0))


class LeaseKeeper:
    """Drives one holder's acquisition + renewal on a seeded-jitter
    schedule (the breaker/spawn discipline). Renewal is scheduled
    every ``renew_every_s`` (default: a third of the TTL) minus a
    SUBTRACTIVE jitter — ``interval *= 1 - jitter_frac * U[0,1)`` —
    so two keepers restarting together desynchronize, yet a jittered
    renewal always lands EARLIER than the unjittered one: jitter can
    never push a renewal past the lease's safety margin."""

    def __init__(self, lease: Lease, holder: str, *,
                 renew_every_s: Optional[float] = None,
                 jitter_frac: float = 0.1,
                 seed: Optional[int] = None):
        if not 0.0 <= jitter_frac < 1.0:
            raise ValueError(
                f"jitter_frac must be in [0, 1), got {jitter_frac}")
        if renew_every_s is None:
            renew_every_s = lease.ttl_s / 3.0
        if not 0.0 < renew_every_s < lease.ttl_s:
            raise ValueError(
                f"renew_every_s must sit inside the TTL "
                f"(0, {lease.ttl_s}), got {renew_every_s}")
        self.lease = lease
        self.holder = str(holder)
        self.renew_every_s = float(renew_every_s)
        self.jitter_frac = float(jitter_frac)
        self._rng = random.Random(seed)
        self._next_renew_s: Optional[float] = None
        self.epoch: Optional[int] = None
        self.renewals = 0
        self.deposed = False

    def _interval_s(self) -> float:
        return self.renew_every_s * (
            1.0 - self.jitter_frac * self._rng.random())

    def acquire(self, *, steal: bool = False) -> int:
        self.epoch = self.lease.acquire(self.holder, steal=steal)
        self.deposed = False
        self._next_renew_s = self.lease._clock() + self._interval_s()
        return self.epoch

    def step(self, now: Optional[float] = None) -> bool:
        """Renew when due. Returns False ONCE the keeper discovers it
        was deposed — the caller (a primary's driver loop) must stop
        commanding the fleet immediately."""
        if self.deposed:
            return False
        if self._next_renew_s is None:
            return True  # never acquired: nothing to keep
        if now is None:
            now = self.lease._clock()
        if now >= self._next_renew_s:
            if not self.lease.renew(self.holder):
                self.deposed = True
                return False
            self.renewals += 1
            self._next_renew_s = now + self._interval_s()
        return True

    def lease_age_s(self) -> Optional[float]:
        return self.lease.age_s()

    def lag_records(self) -> Optional[int]:
        return None  # a primary has no replication lag: gauge NaN


class WalShipper:
    """Primary-side record streaming: ``journal.on_record`` -> one
    CRC-framed line per append, pushed at a sink callable (a pipe
    write, a socket send, or — in tests and the single-host bench —
    the standby's ``feed`` directly). Fire-and-forget: a sink failure
    drops the frame and the standby's disk catch-up covers it; the
    observer must never be able to wedge the primary's append path."""

    def __init__(self, journal, sink: Callable[[bytes], None], *,
                 resend_buffer: int = 512):
        self.sender = FrameSender(resend_buffer=resend_buffer)
        self._sink = sink
        self.shipped = 0
        self.ship_errors = 0
        journal.on_record = self._on_record

    def _on_record(self, seq: int, record: Dict) -> None:
        payload = json.dumps({"seq": int(seq), "record": record},
                             separators=(",", ":")).encode()
        line = self.sender.encode(payload)
        try:
            self._sink(line)
            self.shipped += 1
        except Exception:  # noqa: BLE001 - replication is best-effort;
            self.ship_errors += 1  # durability lives in the journal


class WalTail:
    """Standby-side fold of the replicated record stream into the
    exact state ``journal.read_state`` recovers: ``entries`` ({rid:
    drain-format mirror entry} for every admitted-unfinished stream),
    ``next_rid``, ``bindings`` (rid -> last routed replica id), and
    ``primary_epoch`` (the newest ``epoch`` record — who is allowed to
    be writing this WAL). Records are deduplicated by the JOURNAL
    sequence, so the live stream and a disk catch-up can overlap
    freely."""

    def __init__(self, journal_dir: str, *,
                 gap_feeds: int = 8, first_seq: int = 1):
        self.journal_dir = str(journal_dir)
        self._receiver = FrameReceiver(first_seq=first_seq)
        self._gap_feeds = int(gap_feeds)
        self._gap_streak = 0
        self.entries: Dict[int, Dict] = {}
        self._finished: set = set()
        self.bindings: Dict[int, int] = {}
        self.next_rid = 0
        self.covered_seq = 0     # newest journal seq folded
        self.last_seen_seq = 0   # newest journal seq OBSERVED (gauge)
        self.primary_epoch: Optional[int] = None
        self.records_folded = 0
        self.catchups = 0

    # ------------------------------------------------------------- fold
    def _fold(self, seq: int, record: Dict) -> None:
        seq = int(seq)
        if seq <= self.covered_seq:
            return  # already folded (catch-up / duplicate overlap)
        # Jumping a hole here is deliberate: on a one-way stream the
        # missing records are either on disk (the next catch-up folds
        # them — it refolds from the checkpoint wholesale) or gone
        # with a NON_DURABLE primary, in which case they were token
        # deltas the replay regenerates identically.
        self.covered_seq = seq
        self.last_seen_seq = max(self.last_seen_seq, seq)
        self.records_folded += 1
        kind = record.get("rec")
        rid = int(record.get("rid", -1))
        self.next_rid = max(self.next_rid, rid + 1)
        if kind == "admit" and rid not in self._finished:
            entry = {k: record.get(k) for k in
                     ("prompt", "max_new_tokens", "sampling",
                      "deadline_s", "priority", "adapter", "constraint")}
            entry["tokens"] = []
            entry["elapsed_s"] = 0.0
            entry["ttft_s"] = None
            entry["session"] = record.get("session")
            self.entries[rid] = entry
        elif kind == "tokens" and rid in self.entries:
            self.entries[rid]["tokens"] = (
                list(self.entries[rid].get("tokens", []))
                + [int(t) for t in record.get("toks", [])])
        elif kind == "finish":
            self._finished.add(rid)
            self.entries.pop(rid, None)
            self.bindings.pop(rid, None)
        elif kind in ("route", "handoff"):
            self.bindings[rid] = int(record.get("replica", -1))
        elif kind == "epoch":
            self.primary_epoch = int(record.get("epoch", 0))

    # ------------------------------------------------------------- wire
    def feed(self, line: bytes) -> int:
        """One shipped line in; the number of records folded out. A
        gap that persists across ``gap_feeds`` consecutive feeds (a
        dropped frame no one can resend) triggers a disk catch-up."""
        before = self.records_folded
        # Track the newest seq OBSERVED even when delivery is stalled
        # behind a gap — it is what the lag gauge measures against.
        try:
            _, raw = decode_frame(line.rstrip(b"\n"))
            peek = json.loads(raw)
            self.last_seen_seq = max(self.last_seen_seq,
                                     int(peek.get("seq", 0)))
        except (FrameError, ValueError):
            pass
        for payload in self._receiver.feed(line.rstrip(b"\n")):
            try:
                body = json.loads(payload)
            except ValueError:
                continue
            self._fold(int(body.get("seq", 0)), body.get("record") or {})
        if self._receiver.has_gap:
            self._gap_streak += 1
            if self._gap_streak >= self._gap_feeds:
                self.catch_up()
        else:
            self._gap_streak = 0
        return self.records_folded - before

    def resync(self, first_seq: int) -> None:
        """Re-point the FRAME sequence space (a standby attaching to a
        shipper that already sent frames). Journal-seq dedup makes the
        record fold immune to where the frame numbering starts."""
        self._receiver = FrameReceiver(first_seq=first_seq)
        self._gap_streak = 0

    # ------------------------------------------------------------- disk
    def catch_up(self) -> int:
        """Refold from checkpoint+segment (the join path, and the heal
        for wire gaps / NON_DURABLE backlogs). Wholesale: disk is the
        durable truth up to its tip, and any fresher wire-only state
        is re-applied on top by seq dedup — first from the frames a
        gap left buffered in the receiver, then by the live feed."""
        self.catchups += 1
        entries, next_rid = journal_io.read_state(self.journal_dir)
        self.entries = entries
        self._finished = set()
        self.next_rid = max(self.next_rid, int(next_rid))
        disk_tip = 0
        for name in ("wal.prev.log", "wal.log"):
            path = os.path.join(self.journal_dir, name)
            for seq, record in journal_io.iter_wal_records(path):
                disk_tip = max(disk_tip, int(seq))
                kind = record.get("rec")
                if kind in ("route", "handoff"):
                    rid = int(record.get("rid", -1))
                    if rid in self.entries:
                        self.bindings[rid] = int(
                            record.get("replica", -1))
                elif kind == "finish":
                    self._finished.add(int(record.get("rid", -1)))
                elif kind == "epoch":
                    self.primary_epoch = int(record.get("epoch", 0))
        cp = journal_io.load_checkpoint(self.journal_dir)
        if cp is not None:
            disk_tip = max(disk_tip, int(cp.get("covered_seq", 0)))
        self.covered_seq = max(self.covered_seq, disk_tip)
        self.last_seen_seq = max(self.last_seen_seq, self.covered_seq)
        self.bindings = {rid: b for rid, b in self.bindings.items()
                         if rid in self.entries}
        # Frames stranded behind the unhealable gap: newer than disk
        # iff the primary was NON_DURABLE — fold them, dedup does the
        # rest.
        for _, payload in self._receiver.drain_pending():
            try:
                body = json.loads(payload)
            except ValueError:
                continue
            self._fold(int(body.get("seq", 0)), body.get("record") or {})
        self._gap_streak = 0
        return self.covered_seq

    def lag_records(self) -> int:
        """Journal records observed on the wire but not yet folded —
        the ``standby_lag_records`` gauge (0 = fully caught up)."""
        return max(0, self.last_seen_seq - self.covered_seq)


class HotStandby:
    """A warm second router: tails the primary's WAL, watches the
    lease, and takes over the SAME live replica drivers inside the
    detection budget when the lease lapses.

    Args:
      journal_dir: the primary's journal directory (shared storage —
        also where the promoted router keeps journaling).
      replicas: the LIVE driver objects (``LocalReplica`` /
        ``ProcessReplica``) the primary is commanding. Takeover
        re-binds these — no respawn, no weight reload, no recompile.
      lease: the shared :class:`Lease`; ``holder`` names this standby.
      router_kw / journal_kw: forwarded to the promoted
        :class:`FleetRouter` / :class:`~.journal.RouterJournal`.
      jitter_frac / seed: the keeper's renewal jitter (post-promotion
        this standby becomes the renewing primary).
    """

    def __init__(self, journal_dir: str, replicas, *, lease: Lease,
                 holder: str = "standby",
                 router_kw: Optional[Dict] = None,
                 journal_kw: Optional[Dict] = None,
                 jitter_frac: float = 0.1, seed: Optional[int] = None,
                 gap_feeds: int = 8):
        self.journal_dir = str(journal_dir)
        self.replicas = list(replicas)
        self.lease = lease
        self.holder = str(holder)
        self.keeper = LeaseKeeper(lease, self.holder,
                                  jitter_frac=jitter_frac, seed=seed)
        self.tail = WalTail(journal_dir, gap_feeds=gap_feeds)
        self._router_kw = dict(router_kw or {})
        self._journal_kw = dict(journal_kw or {})
        self.router: Optional[FleetRouter] = None
        self.promoted = False
        # Join = the first catch-up: fold whatever checkpoint+segment
        # already hold so the live stream only has to carry the suffix.
        self.tail.catch_up()

    # ------------------------------------------------------------ wiring
    def feed(self, line: bytes) -> None:
        """The shipper's sink (or a pipe pump's per-line callback)."""
        self.tail.feed(line)

    def attach(self, shipper: WalShipper) -> None:
        """In-process convenience: point ``shipper`` at this standby
        and align the frame sequence space with what it already sent
        (the mid-stream join; history comes from the disk catch-up
        the constructor already ran)."""
        self.tail.resync(shipper.sender.last_seq + 1)
        shipper._sink = self.feed

    # ---------------------------------------------------------- watching
    def lease_age_s(self) -> Optional[float]:
        return self.lease.age_s()

    def lag_records(self) -> Optional[int]:
        return self.tail.lag_records()

    def step(self, now: Optional[float] = None
             ) -> Optional[Tuple[FleetRouter, Dict[int, FleetHandle]]]:
        """One watch round: keep the post-promotion lease renewed, or
        — while still a standby — promote the moment the primary's
        lease lapses. Returns the ``(router, handles)`` pair ONCE, on
        the round that promoted; None otherwise."""
        if self.promoted:
            self.keeper.step(now)
            return None
        if not self.lease.expired():
            return None
        try:
            return self.promote()
        except LeaseHeld:
            return None  # raced another standby: keep tailing

    # --------------------------------------------------------- promotion
    def promote(self, *, steal: bool = False
                ) -> Tuple[FleetRouter, Dict[int, FleetHandle]]:
        """Fenced takeover. Order matters:

        1. Acquire the lease — the epoch bumps (holder change).
        2. FENCE every live replica at the new epoch. From this line
           on, the deposed primary's commands are typed rejects: it
           cannot admit, cancel, or restore anything, so the state we
           are about to rebuild from cannot be mutated under us.
        3. Final disk catch-up: everything the primary durably wrote
           up to the fence (its post-fence appends can only be flush
           stragglers for streams we are about to replay anyway).
        4. Cancel the stale in-flight rids (new epoch) — the streams
           re-enter under fresh rids; the old copies must not keep
           burning slots or emitting events.
        5. Rebuild a :class:`FleetRouter` over the SAME driver
           objects + a fresh journal over the same directory, arm the
           epoch, and mirror-replay every unfinished stream (the
           mirror-replay contract: token-exact continuation, zero recompiles).

        Returns ``(router, {old_rid: FleetHandle})`` — handles keyed
        by the PRIMARY's rids, so callers correlate reborn streams
        with the ones they were awaiting.
        """
        epoch = self.keeper.acquire(steal=steal)
        fenced = 0
        for driver in self.replicas:
            try:
                driver.fence(epoch)
                fenced += 1
            except (ReplicaDied, EpochFenced, OSError):
                continue  # dead: the router's probe loop owns it now
        self.tail.catch_up()
        stale = sorted(self.tail.entries)
        by_id = {d.replica_id: d for d in self.replicas}
        for rid in stale:
            targets = ([by_id[self.tail.bindings[rid]]]
                       if self.tail.bindings.get(rid) in by_id
                       else self.replicas)
            for driver in targets:
                try:
                    driver.cancel(rid, epoch=epoch)
                except (ReplicaDied, EpochFenced, OSError):
                    continue
        journal = journal_io.RouterJournal(self.journal_dir,
                                           **self._journal_kw)
        router = FleetRouter(self.replicas, journal=journal,
                             **self._router_kw)
        router.set_epoch(epoch)
        router._rid_counter = max(router._rid_counter,
                                  int(self.tail.next_rid))
        now = router._clock()
        migrate: List[Tuple[int, Dict, FleetHandle]] = []
        handles: Dict[int, FleetHandle] = {}
        for old_rid in stale:
            entry = self.tail.entries[old_rid]
            fh = router._handle_from_entry(entry, now)
            rid = router._new_rid()
            router._by_rid[rid] = fh
            migrate.append((rid, entry, fh))
            handles[old_rid] = fh
        router._distribute(migrate, "replay")
        router._journal_checkpoint()
        router.metrics.takeovers += 1
        router.metrics.standby_catchups += self.tail.catchups
        router.ha = self  # the exposition's lease/lag gauge surface
        router._tracer.on_fleet_event(
            "takeover", epoch=epoch, revived=len(migrate),
            fenced_replicas=fenced, catchups=self.tail.catchups)
        self.router = router
        self.promoted = True
        return router, handles
