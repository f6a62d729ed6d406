"""Router write-ahead log: the control plane becomes crash-safe.

The port's own copy of :mod:`pddl_tpu.serve.fleet.journal` (host Python,
no JAX): the same names, error texts, literal tables and wire shapes.

Every fault the fleet survives — device errors, replica
death, overload, kill-mid-migration — assumed
the :class:`~pddl_tpu_torch.serve.fleet.router.FleetRouter` process itself
is immortal. This module removes that assumption with the CheckFreq
discipline (Mohan et al., FAST '21) the training side already applies
to its checkpoints: journal first, verify on read, restore from
the newest VERIFIED state.

**The WAL.** :class:`RouterJournal` appends one CRC-framed binary
record per control-plane event to ``wal.log``:

- ``admit`` — a request entered the fleet (the full replayable
  request: prompt, budget, sampling, priority, tenant fields,
  session). Durable (fsync) BEFORE the caller's handle returns: an
  acked admission survives a router SIGKILL, an unacked one was never
  promised.
- ``route`` — the rid -> replica binding (admission, migration, and
  hedge bindings alike — the ``HandleLedger`` assignment journaled).
- ``tokens`` — the emitted-token mirror delta. fsync-BATCHED: losing
  a tail of token records is safe by construction, because the
  mirror-replay contract regenerates the identical
  tokens from (params, prompt, tokens-so-far).
- ``finish`` — the stream settled (with state/reason); recovery
  replays admits minus finishes.
- ``handoff`` — the disaggregated fleet's prefill->decode KV
  rebinding: the finished prefill chain left
  ``from_replica`` and the stream now decodes on ``replica``.
  Audit-only on recovery, like ``route``.

Record framing on disk is ``magic | seq | length | crc32 | payload``;
a torn tail (the record a SIGKILL cut mid-write) fails its CRC or
length check and everything from the first unreadable record on is
discarded — exactly the readable prefix is recovered, which is what
"crash-exact" means for a log.

**Checkpoint + truncate.** The WAL cannot grow forever; every
``checkpoint_every_records`` appends the router snapshots its live
mirrors — riding the `serve/drain.py` entry encoder, the SAME wire
format migration uses — into ``checkpoint.json`` (tmp + fsync +
atomic rename, with an embedded whole-file CRC), demotes the previous
checkpoint to ``checkpoint.prev.json``, and rotates the WAL segment
(``wal.log`` -> ``wal.prev.log``; the segment before THAT is the only
thing deleted — it is covered by two generations of checkpoint).
Every record carries a monotone ``seq`` and the checkpoint stores the
last seq it covers, so a crash anywhere in the cycle replays nothing
twice. A checkpoint that fails its CRC on read (torn by a crash
mid-cycle, bit-rotted later) falls back to the previous verified one
PLUS the rotated segment that checkpoint still covers — the
newest-VERIFIED discipline, with no window where corruption loses
acknowledged state.

**Recovery.** :func:`read_state` folds checkpoint + WAL tail into
``{rid: entry}`` drain-format wire entries for every in-flight
stream; :meth:`~pddl_tpu_torch.serve.fleet.router.FleetRouter.recover`
builds a fresh router over fresh/re-spawned replicas and re-enters
them through the mirror-replay path — token-exact, zero special
cases, because router death is now just the snapshot path's second
"normal case".

**Storage faults.** The WAL exists to survive crashes, so
it cannot itself be fail-stop-naive about the disk under it. Every
file op routes through :class:`_JournalVFS` (faults injectable via
``utils.faults.StorageFaultPlan``), and failures degrade instead of
propagating out of ``append``:

- transient write/fsync errors retry with bounded backoff;
- persistent failure enters **NON_DURABLE** mode: acks keep flowing
  (``append`` never raises ``OSError``), the backlog is retained
  in-memory, the widened loss-on-crash window is alarmed via the
  ``journal_non_durable`` gauge + a traced event, and rate-limited
  re-arm probes (plus every durable append, which still attempts a
  synchronous write+fsync) restore durability the moment the disk
  recovers — the OOM-degraded discipline applied to storage;
- ``ENOSPC`` sets :attr:`RouterJournal.emergency_checkpoint_due` so
  the router runs an immediate checkpoint+rotate, reclaiming the
  covered segment instead of blind-retrying a full disk;
- a mid-:meth:`RouterJournal.checkpoint` failure aborts with the
  checkpoint/prev pair still readable and never leaves ``_fd``
  closed for good (recovery falls back to the newest VERIFIED state,
  the rule; probes re-open the WAL).

A torn write leaves garbage bytes past the last good frame; the
journal tracks the known-good byte offset and truncates back to it
before writing again, so retries never bury readable records behind
an unreadable tail.
"""

from __future__ import annotations

import errno
import json
import os
import struct
import time
import zlib
from typing import Dict, List, Optional, Tuple

from pddl_tpu_torch.serve import drain as drain_io
from pddl_tpu_torch.utils.faults import StorageFaultKind

# Version 3: version 2 (the disaggregation-era WAL) plus the
# ``epoch`` record — the router-HA single-writer token. A
# promoted router stamps its fencing epoch into the log so a forensic
# read shows exactly which writer issued every suffix, and so a
# standby tailing the stream learns leadership changes in-band.
# Bumping the record shape requires bumping this AND renaming
# RECORD_KEYS_V3 — a static snapshot-hygiene rule can check
# the pairing, the same discipline `serve/drain.py` carries for its
# snapshot entries. V1/V2 logs stay readable: the new record kind is
# additive and recovery ignores it like ``route``.
JOURNAL_VERSION = 3
_READABLE_JOURNAL_VERSIONS = frozenset({1, 2, 3})

# Machine-checked wire manifest: the
# exact record keys the encode_* functions below emit at the CURRENT
# journal version. Changing a record shape requires bumping
# JOURNAL_VERSION and renaming this tuple to RECORD_KEYS_V<new> in the
# same commit — the static checker fails the tree otherwise.
RECORD_KEYS_V3 = ("rec", "rid", "prompt", "max_new_tokens", "sampling",
                  "deadline_s", "priority", "adapter", "constraint",
                  "session", "replica", "via", "toks", "state", "reason",
                  "from_replica", "epoch")

# Machine-checked record-kind vocabulary:
# every ``"rec"`` literal an encoder below emits, exactly. Recovery's
# fold dispatches on these; adding a kind here without a reader-side
# decision (rebuild vs audit-only) is what the rule exists to catch.
RECORD_KINDS = ("admit", "route", "tokens", "finish", "handoff",
                "epoch")

# Machine-checked ``via`` vocabulary: every
# label a ``route`` record may carry — the router's routing labels
# plus the re-bind provenances (``migration``/``hedge``). The
# router's ROUTE_LABELS must be a subset; a label minted there but
# missing here is a binding the forensic reader cannot classify.
VIA_LABELS = ("sticky", "adapter", "affinity", "load", "host_tier",
              "hash", "shed", "prefill", "migration", "hedge")

_HEADER = struct.Struct(">4sQII")  # magic, seq, payload len, crc32
_MAGIC = b"PJL1"

# Machine-checked storage-op vocabulary (the `site-vocab` rule,
# storage leg): every file-operation site the journal dispatches
# through ``_JournalVFS._storage_op``, exactly — and the SITES of
# ``utils.faults.StorageFaultPlan`` must equal it. An op gated here
# but missing from the plan is a fault coordinate chaos can never
# reach; a plan site nothing dispatches is a schedule that silently
# never fires.
STORAGE_OPS = ("open", "write", "fsync", "replace", "fstat")


class _JournalVFS:
    """The journal's file-op seam: every ``os``-level operation the WAL
    and checkpoint cycle perform goes through here, and an optional
    :class:`~pddl_tpu_torch.utils.faults.StorageFaultPlan` is consulted
    immediately BEFORE each real call — same injection-before-dispatch
    discipline as the device ``_device_call`` sites, so a fault never
    leaves the real op half-observed. TORN is the one exception by
    design: the plan *returns* it and :meth:`write` persists a prefix
    of the buffer before raising EIO, modeling the power-cut shape
    ``_readable_prefix_len`` truncates at recovery."""

    def __init__(self, plan=None):
        self.plan = plan

    def _storage_op(self, op: str) -> Optional[StorageFaultKind]:
        if self.plan is None:
            return None
        return self.plan.check(op)

    def open(self, path: str, flags: int, mode: int = 0o644) -> int:
        self._storage_op("open")
        return os.open(path, flags, mode)

    def write(self, fd: int, data) -> int:
        kind = self._storage_op("write")
        if kind is StorageFaultKind.TORN:
            half = len(data) // 2
            if half:
                os.write(fd, data[:half])
            raise OSError(errno.EIO,
                          f"injected torn write ({half}/{len(data)} bytes)")
        return os.write(fd, data)

    def fsync(self, fd: int) -> None:
        self._storage_op("fsync")
        os.fsync(fd)

    def replace(self, src: str, dst: str) -> None:
        self._storage_op("replace")
        os.replace(src, dst)

    def fstat(self, fd: int):
        self._storage_op("fstat")
        return os.fstat(fd)


def encode_admit(rid: int, request, session: Optional[str]) -> Dict:
    """The admission record: everything replay needs to re-enter the
    request from zero (the drain entry's request half, rid-tagged)."""
    return {
        "rec": "admit",
        "rid": int(rid),
        "prompt": [int(t) for t in request.prompt],
        "max_new_tokens": int(request.max_new_tokens),
        "sampling": drain_io.encode_sampling(request.sampling),
        "deadline_s": (float(request.deadline_s)
                       if request.deadline_s is not None else None),
        "priority": request.priority.value,
        "adapter": (str(request.adapter)
                    if request.adapter is not None else None),
        "constraint": request.constraint,
        "session": session,
    }


def encode_route(rid: int, replica_id: int, via: str) -> Dict:
    """The rid -> replica binding (``via``: the routing label, or
    ``migration``/``hedge`` for re-binds)."""
    return {"rec": "route", "rid": int(rid), "replica": int(replica_id),
            "via": str(via)}


def encode_tokens(rid: int, toks: List[int]) -> Dict:
    """The emitted-token mirror delta (fsync-batched; safe to lose —
    replay regenerates)."""
    return {"rec": "tokens", "rid": int(rid),
            "toks": [int(t) for t in toks]}


def encode_finish(rid: int, state: str, reason: Optional[str]) -> Dict:
    return {"rec": "finish", "rid": int(rid), "state": str(state),
            "reason": reason}


def encode_handoff(rid: int, from_replica: int, to_replica: int) -> Dict:
    """The prefill->decode KV rebinding (disaggregated fleet): the
    finished prefill chain shipped from ``from_replica`` and the stream
    now runs on ``to_replica``. Audit-only on recovery —
    like ``route``, the fresh fleet re-routes — but it is what a
    hand-off forensic reads."""
    return {"rec": "handoff", "rid": int(rid),
            "replica": int(to_replica),
            "from_replica": int(from_replica)}


def encode_fence_epoch(epoch: int) -> Dict:
    """Encoder for the ``"epoch"`` record (NOT ``encode_epoch``: a
    helper named ``encode_<declared wire key>`` reads as a nested
    sub-encoder to the snapshot-hygiene manifest check, and
    ``epoch`` is both the record kind and its field).

    The single-writer token: the issuing
    router's fencing epoch, stamped at arm/takeover and re-stamped
    after every checkpoint so the live WAL tail always carries the
    current writer's identity. Audit-only on recovery — leadership is
    re-acquired through the lease, never replayed — but it is what a
    split-brain forensic reads."""
    return {"rec": "epoch", "epoch": int(epoch)}


class RouterJournal:
    """Append-only, CRC-framed, fsync-batched control-plane WAL with an
    atomic checkpoint+truncate cycle.

    Args:
      journal_dir: directory holding ``wal.log`` / ``checkpoint.json``
        / ``checkpoint.prev.json``. Created if absent; an existing
        WAL/checkpoint is picked up (the recovery path) and appends
        continue after the readable prefix.
      fsync_batch_records: buffered (non-durable) appends are flushed
        on every :meth:`tick` and fsynced once this many records are
        pending — the token-delta batching knob. ``1`` fsyncs every
        record (chaos tests wanting exact durability).
      checkpoint_every_records: :attr:`checkpoint_due` turns True after
        this many appended records since the last checkpoint; the
        router runs the cycle from its step loop.
      storage_plan: optional
        :class:`~pddl_tpu_torch.utils.faults.StorageFaultPlan` the VFS shim
        consults before every file op (chaos/testing).
      retry_limit: bounded-backoff retries for a transient write/fsync
        error while still durable; past it the journal degrades to
        NON_DURABLE. While already degraded every attempt is single-
        shot (it doubles as a probe) — no backoff hammering.
      retry_backoff_s: first retry delay (doubles per retry).
      rearm_interval_s: minimum spacing of NON_DURABLE re-arm probes
        driven from :meth:`tick`.
      clock / sleep_fn: injectable time sources (tests use fakes).
    """

    def __init__(self, journal_dir: str, *,
                 fsync_batch_records: int = 64,
                 checkpoint_every_records: int = 4096,
                 storage_plan=None,
                 retry_limit: int = 3,
                 retry_backoff_s: float = 0.001,
                 rearm_interval_s: float = 0.25,
                 clock=time.monotonic,
                 sleep_fn=time.sleep):
        self.dir = journal_dir
        os.makedirs(journal_dir, exist_ok=True)
        self.wal_path = os.path.join(journal_dir, "wal.log")
        self.wal_prev_path = os.path.join(journal_dir, "wal.prev.log")
        self.checkpoint_path = os.path.join(journal_dir,
                                            "checkpoint.json")
        self.checkpoint_prev_path = os.path.join(journal_dir,
                                                 "checkpoint.prev.json")
        self._fsync_batch = max(1, int(fsync_batch_records))
        self._checkpoint_every = max(1, int(checkpoint_every_records))
        self.vfs = _JournalVFS(storage_plan)
        self._retry_limit = max(0, int(retry_limit))
        self._retry_backoff_s = float(retry_backoff_s)
        self._rearm_interval_s = float(rearm_interval_s)
        self._clock = clock
        self._sleep = sleep_fn
        # Degradation state (the discipline applied to storage).
        self.non_durable = False
        self.emergency_checkpoint_due = False
        self.storage_errors = 0    # every OSError observed, retries incl.
        self.degraded_events = 0   # entries into NON_DURABLE
        self.rearms = 0            # exits from NON_DURABLE
        self._next_probe_s = 0.0
        self._wal_bytes_last = 0
        # Observer ``fn(event, detail_dict)`` — the router wires it to
        # its tracer + FleetMetrics so degradation is alarmable.
        self.on_storage_event = None
        # Observer ``fn(seq, record)`` — fired on EVERY append, before
        # any disk I/O, so a hot standby's WAL shipper sees the record
        # stream even while the journal is degraded NON_DURABLE (when
        # the disk shows nothing, the wire is the only replica of the
        # backlog). Must not raise; must not touch the journal.
        self.on_record = None
        # Continue the seq line past whatever is already durable — and
        # TRUNCATE the torn tail first: appending after unreadable
        # bytes would put every later record (fsynced admits included)
        # beyond the readable prefix recovery stops at.
        last_seq = self._scan_last_seq()
        self._next_seq = last_seq + 1
        self._fd: Optional[int] = None
        self._good_bytes = 0       # byte offset of the last good frame end
        self._dirty_tail = False   # garbage past _good_bytes (failed write)
        self._open_wal()           # loud on a dead disk: arming must fail
        self._pending = 0          # appended but not yet fsynced
        self._buffer: List[bytes] = []
        self.records_since_checkpoint = 0
        self.records_appended = 0
        self.fsyncs = 0
        self._closed = False

    # ------------------------------------------------------------- append
    def append(self, record: Dict, *, durable: bool = False) -> int:
        """Frame + buffer one record; ``durable=True`` flushes AND
        fsyncs before returning (the admit contract). Returns the
        record's seq.

        NEVER raises ``OSError``: a storage failure degrades the
        journal to NON_DURABLE (alarmed, probed, backlog retained)
        instead of killing the control plane that exists to survive
        crashes. Callers check :attr:`non_durable` / wire
        :attr:`on_storage_event` when they need to know."""
        if self._closed:
            raise ValueError("journal is closed")
        seq = self._next_seq
        self._next_seq += 1
        payload = json.dumps(record, separators=(",", ":")).encode()
        frame = _HEADER.pack(_MAGIC, seq, len(payload),
                             zlib.crc32(payload) & 0xFFFFFFFF) + payload
        self._buffer.append(frame)
        self._pending += 1
        self.records_appended += 1
        self.records_since_checkpoint += 1
        if self.on_record is not None:
            self.on_record(seq, record)
        if durable or self._pending >= self._fsync_batch:
            if self.non_durable:
                # Writes pause while degraded: the batch threshold must
                # not hammer the dead disk with an O(backlog) join per
                # batch — durable appends become rate-limited probe
                # opportunities instead, same cadence as tick().
                self._maybe_probe()
            else:
                self.commit()
        return seq

    # -------------------------------------------------- degradation core
    def _observe(self, event: str, **detail) -> None:
        if self.on_storage_event is not None:
            self.on_storage_event(event, detail)

    def _enter_non_durable(self, op: str, err: OSError) -> None:
        if not self.non_durable:
            self.non_durable = True
            self.degraded_events += 1
            self._observe("journal_degraded", op=op,
                          errno=err.errno, error=str(err))
        self._next_probe_s = self._clock() + self._rearm_interval_s

    def _rearm(self) -> None:
        if self.non_durable:
            self.non_durable = False
            self.rearms += 1
            self._observe("journal_rearmed")

    def _open_wal(self) -> None:
        """(Re)open the WAL fd after truncating any unreadable tail —
        shared by __init__, the checkpoint rotate, and re-arm probes.
        Raises ``OSError`` (callers decide loud vs degrade)."""
        prefix = _readable_prefix_len(self.wal_path)
        if prefix is not None:
            with open(self.wal_path, "r+b") as f:
                f.truncate(prefix)
        self._fd = self.vfs.open(
            self.wal_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self._good_bytes = prefix or 0
        self._dirty_tail = False
        self._wal_bytes_last = self._good_bytes

    def _try_reopen(self) -> bool:
        try:
            self._open_wal()
            return True
        except OSError as e:
            self.storage_errors += 1
            self._observe("journal_storage_error", op="open",
                          errno=e.errno, error=str(e))
            self._enter_non_durable("open", e)
            return False

    def _repair_tail(self) -> bool:
        """Truncate garbage a failed/torn write left past the last good
        frame, so a retry never buries readable records behind an
        unreadable tail."""
        if not self._dirty_tail:
            return True
        try:
            os.ftruncate(self._fd, self._good_bytes)
            self._dirty_tail = False
            return True
        except OSError:
            return False

    def _write_all(self, data: bytes) -> None:
        view = memoryview(data)
        while view:
            n = self.vfs.write(self._fd, view)
            view = view[n:]

    def _guard(self, fn, op: str) -> bool:
        """Run one file op with bounded-backoff retries (single-shot
        while already degraded — every attempt then doubles as a
        probe). On persistent failure: degrade, don't raise."""
        attempts = 1 if self.non_durable else self._retry_limit + 1
        delay = self._retry_backoff_s
        err: Optional[OSError] = None
        for i in range(attempts):
            try:
                fn()
                return True
            except OSError as e:
                err = e
                self.storage_errors += 1
                self._observe("journal_storage_error", op=op,
                              errno=e.errno, error=str(e))
                if op == "write":
                    # Unknown how much landed: mark the tail dirty and
                    # repair before any retry.
                    self._dirty_tail = True
                    if not self._repair_tail():
                        break
                if e.errno == errno.ENOSPC:
                    # A full disk is not transient: reclaim space via
                    # an emergency checkpoint+rotate, don't blind-retry.
                    self.emergency_checkpoint_due = True
                    break
                if i + 1 < attempts:
                    self._sleep(delay)
                    delay *= 2.0
        self._enter_non_durable(op, err)
        return False

    def _flush(self, fsync: bool) -> bool:
        if self._fd is None and not self._try_reopen():
            return False
        if not self._repair_tail():
            return False
        if self._buffer:
            data = b"".join(self._buffer)
            if not self._guard(lambda: self._write_all(data), "write"):
                return False
            self._good_bytes += len(data)
            self._buffer = []
        if fsync and (self._pending or self.non_durable):
            # While degraded, fsync even with nothing pending: the
            # successful fsync IS the probe signal that re-arms.
            if not self._guard(lambda: self.vfs.fsync(self._fd), "fsync"):
                return False
            self.fsyncs += 1
            self._pending = 0
        if fsync and self.non_durable:
            self._rearm()
        return True

    def commit(self) -> bool:
        """Flush the buffer and fsync. Returns True when everything
        appended so far is durable; False when the journal is (now)
        running NON_DURABLE with the backlog retained in-memory."""
        return self._flush(fsync=True)

    def tick(self) -> None:
        """The step-cadence flush: write buffered frames to the OS (so
        a mere router restart loses nothing) but only fsync when the
        batch threshold says so — the fsync-batching contract. While
        NON_DURABLE, writes pause and this fires a rate-limited re-arm
        probe instead (a full flush+fsync attempt) — no hammering a
        dead disk every step."""
        if self.non_durable:
            self._maybe_probe()
            return
        self._flush(fsync=self._pending >= self._fsync_batch)

    def _maybe_probe(self) -> None:
        """One rate-limited re-arm attempt (full flush+fsync) if the
        probe interval has elapsed — the ONLY disk path while degraded,
        shared by tick() and the append batch threshold."""
        now = self._clock()
        if now >= self._next_probe_s:
            self._next_probe_s = now + self._rearm_interval_s
            self._flush(fsync=True)

    @property
    def checkpoint_due(self) -> bool:
        return self.records_since_checkpoint >= self._checkpoint_every

    @property
    def wal_bytes(self) -> int:
        """On-disk WAL size — last KNOWN size when ``fstat`` fails
        (counted, not swallowed to 0: a zero here reads as "empty WAL"
        to checkpoint/size telemetry during exactly the disk failures
        it should be reporting)."""
        if self._fd is not None:
            try:
                self._wal_bytes_last = int(
                    self.vfs.fstat(self._fd).st_size)
            except OSError as e:
                self.storage_errors += 1
                self._observe("journal_storage_error", op="fstat",
                              errno=e.errno, error=str(e))
        return self._wal_bytes_last

    # --------------------------------------------------------- checkpoint
    def checkpoint(self, entries: List[Tuple[int, Dict]],
                   next_rid: int) -> bool:
        """The atomic checkpoint+truncate cycle: snapshot the live
        rid-tagged mirrors (drain-format entries — the encoder
        migration already rides), make it durable and verified, THEN
        truncate the WAL. Crash anywhere inside: recovery still finds
        either (new checkpoint, truncated-or-full WAL with seqs the
        checkpoint covers marked) or (previous checkpoint, full WAL).

        Storage-fault contract: a failure anywhere in the
        cycle ABORTS with the checkpoint/prev pair still readable
        (recovery falls back to the newest VERIFIED state, the
        checkpoint rule) and never leaves ``_fd`` closed for good — at
        worst the WAL fd is down and NON_DURABLE probes re-open it. Returns True
        on a completed cycle. A verified checkpoint makes everything
        it covers durable regardless of the WAL backlog, so success
        drops the covered backlog and re-arms a degraded journal;
        this is also exactly how the ``ENOSPC`` emergency path
        reclaims space (the rotate retires the oldest segment)."""
        self.commit()  # best effort: the snapshot comes from live mirrors
        covered_seq = self._next_seq - 1
        body = {
            "version": JOURNAL_VERSION,
            "snapshot_version": drain_io.SNAPSHOT_VERSION,
            "covered_seq": covered_seq,
            "next_rid": int(next_rid),
            "requests": [[int(rid), entry] for rid, entry in entries],
        }
        blob = json.dumps(body, sort_keys=True,
                          separators=(",", ":")).encode()
        payload = json.dumps({"crc": zlib.crc32(blob) & 0xFFFFFFFF,
                              "body": body}).encode()
        tmp = self.checkpoint_path + ".tmp"
        try:
            fd = self.vfs.open(
                tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                view = memoryview(payload)
                while view:
                    n = self.vfs.write(fd, view)
                    view = view[n:]
                self.vfs.fsync(fd)
            finally:
                os.close(fd)
            if os.path.exists(self.checkpoint_path):
                self.vfs.replace(self.checkpoint_path,
                                 self.checkpoint_prev_path)
            self.vfs.replace(tmp, self.checkpoint_path)
        except OSError as e:
            # Abort with the pair readable: the worst interleaving
            # (current demoted to prev, tmp never promoted) still
            # leaves the old checkpoint verified at the prev slot.
            self.storage_errors += 1
            self._observe("journal_checkpoint_failed", op="checkpoint",
                          errno=e.errno, error=str(e))
            self._enter_non_durable("checkpoint", e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        # The new checkpoint is durable and verified: every buffered
        # frame has seq <= covered_seq, so a retained NON_DURABLE
        # backlog is covered and can be dropped.
        self.emergency_checkpoint_due = False
        self._buffer = []
        self._pending = 0
        # Rotate the WAL segment rather than truncating it: the
        # segment this checkpoint covers stays on disk as
        # wal.prev.log until the NEXT cycle retires it, so a
        # checkpoint that later fails its CRC can still fall back to
        # checkpoint.prev + this segment with nothing lost. seq keeps
        # counting upward so the covered_seq skip-rule stays monotone
        # across cycles.
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
        rotated = True
        try:
            if os.path.exists(self.wal_path):
                self.vfs.replace(self.wal_path, self.wal_prev_path)
        except OSError as e:
            # Rotation is an optimization (space reclaim); appends can
            # continue in the un-rotated segment — the covered_seq
            # skip-rule keeps replay exact either way.
            rotated = False
            self.storage_errors += 1
            self._observe("journal_storage_error", op="replace",
                          errno=e.errno, error=str(e))
        self.records_since_checkpoint = 0
        if not self._try_reopen():
            return False  # fd down; NON_DURABLE probes keep retrying
        self._rearm()     # checkpoint + live fd = durable again
        return rotated

    # --------------------------------------------------------------- read
    def _scan_last_seq(self) -> int:
        last = 0
        for path in (self.wal_prev_path, self.wal_path):
            for seq, _ in iter_wal_records(path):
                last = max(last, seq)
        cp = load_checkpoint(self.dir)
        if cp is not None:
            last = max(last, int(cp.get("covered_seq", 0)))
        return last

    def close(self) -> None:
        if not self._closed:
            self.commit()  # best effort — close never raises OSError
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None
            self._closed = True


def _readable_prefix_len(wal_path: str) -> Optional[int]:
    """Byte length of the WAL's readable prefix (None when the file
    does not exist). Everything past it is a torn tail appends must
    not land behind."""
    try:
        with open(wal_path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    end = 0
    off = 0
    while off + _HEADER.size <= len(data):
        magic, _, length, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC:
            break
        start = off + _HEADER.size
        stop = start + length
        if stop > len(data) \
                or (zlib.crc32(data[start:stop]) & 0xFFFFFFFF) != crc:
            break
        off = stop
        end = off
    return end


def iter_wal_records(wal_path: str):
    """``(seq, record)`` for the READABLE prefix of a WAL file: stops
    at the first torn/corrupt frame (a record whose header, length, or
    CRC does not verify) — everything after it is untrusted."""
    try:
        with open(wal_path, "rb") as f:
            data = f.read()
    except OSError:
        return
    off = 0
    while off + _HEADER.size <= len(data):
        magic, seq, length, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC:
            return  # lost framing: discard the tail
        start = off + _HEADER.size
        end = start + length
        if end > len(data):
            return  # torn tail: the record a crash cut mid-write
        payload = data[start:end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            return  # corrupt record: nothing after it is trusted
        try:
            record = json.loads(payload)
        except ValueError:
            return
        yield int(seq), record
        off = end


def tail_wal_records(wal_path: str,
                     offset: int = 0) -> Tuple[List[Tuple[int, Dict]],
                                               int]:
    """Incremental WAL read for a standby's catch-up loop:
    ``(records, new_offset)`` over the readable frames starting at byte
    ``offset``. Pass the returned offset back on the next poll to read
    only what the primary appended since — the file is never re-parsed
    from the top. A torn/corrupt frame ends the read at its start (the
    offset does NOT advance past it), so a half-flushed tail is re-read
    whole once the primary completes it."""
    try:
        with open(wal_path, "rb") as f:
            f.seek(offset)
            data = f.read()
    except OSError:
        return [], offset
    out: List[Tuple[int, Dict]] = []
    off = 0
    while off + _HEADER.size <= len(data):
        magic, seq, length, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC:
            break
        start = off + _HEADER.size
        end = start + length
        if end > len(data):
            break
        payload = data[start:end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            break
        try:
            record = json.loads(payload)
        except ValueError:
            break
        out.append((int(seq), record))
        off = end
    return out, offset + off


def load_checkpoint(journal_dir: str) -> Optional[Dict]:
    """The newest VERIFIED checkpoint body (the checkpoint discipline): the
    current file if its embedded CRC verifies, else the previous one,
    else None (recover from the WAL alone)."""
    for name in ("checkpoint.json", "checkpoint.prev.json"):
        path = os.path.join(journal_dir, name)
        try:
            with open(path) as f:
                wrapped = json.load(f)
        except (OSError, ValueError):
            continue
        body = wrapped.get("body")
        if not isinstance(body, dict):
            continue
        blob = json.dumps(body, sort_keys=True,
                          separators=(",", ":")).encode()
        if (zlib.crc32(blob) & 0xFFFFFFFF) != wrapped.get("crc"):
            continue  # torn mid-cycle: fall back to the previous one
        if body.get("version") not in _READABLE_JOURNAL_VERSIONS:
            raise ValueError(
                f"router journal version {body.get('version')!r} "
                f"unsupported (this build reads "
                f"{sorted(_READABLE_JOURNAL_VERSIONS)})")
        return body


def read_state(journal_dir: str) -> Tuple[Dict[int, Dict], int]:
    """Fold checkpoint + WAL tail into the recoverable control-plane
    state: ``({rid: drain-format entry}, next_rid)`` for every stream
    that was admitted and had not finished. Entries carry the mirrored
    tokens, so the replay path continues each stream token-exactly
    from what the journal durably saw (tokens past the last fsync
    replay to the identical values — they are a pure function of
    (params, prompt, tokens-so-far))."""
    entries: Dict[int, Dict] = {}
    max_rid = -1
    covered_seq = 0
    cp = load_checkpoint(journal_dir)
    if cp is not None:
        covered_seq = int(cp.get("covered_seq", 0))
        max_rid = int(cp.get("next_rid", 0)) - 1
        for rid, entry in cp.get("requests", []):
            entries[int(rid)] = dict(entry)
    finished: set = set()
    records: List[Tuple[int, Dict]] = []
    # Both segments, rotated-first: seqs are monotone across rotation,
    # and the covered_seq filter drops whatever the verified
    # checkpoint already folded in — including the whole prev segment
    # when the CURRENT checkpoint verified, and only its pre-prev
    # prefix when recovery fell back a generation.
    for name in ("wal.prev.log", "wal.log"):
        records.extend(iter_wal_records(os.path.join(journal_dir, name)))
    records.sort(key=lambda p: p[0])
    for seq, record in records:
        if seq <= covered_seq:
            continue  # the checkpoint already folded this record in
        kind = record.get("rec")
        rid = int(record.get("rid", -1))
        max_rid = max(max_rid, rid)
        if kind == "admit":
            entry = {k: record.get(k) for k in
                     ("prompt", "max_new_tokens", "sampling",
                      "deadline_s", "priority", "adapter",
                      "constraint")}
            entry["tokens"] = []
            entry["elapsed_s"] = 0.0
            entry["ttft_s"] = None
            entry["session"] = record.get("session")
            entries[rid] = entry
        elif kind == "tokens" and rid in entries:
            entries[rid]["tokens"] = (
                list(entries[rid].get("tokens", []))
                + [int(t) for t in record.get("toks", [])])
        elif kind == "finish":
            finished.add(rid)
            entries.pop(rid, None)
        # "route", "handoff", and "epoch" records rebuild nothing
        # here: recovery re-routes on the fresh fleet (the old bindings
        # name dead processes) and re-acquires leadership through the
        # lease, but they make the decision history auditable and are
        # what a partial-failover, hand-off, or split-brain forensic
        # reads.
    for rid in finished:
        entries.pop(rid, None)
    return entries, max_rid + 1
