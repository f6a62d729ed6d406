"""Framed replica transport: the wire stops being trusted.

The port's own copy of :mod:`pddl_tpu.serve.fleet.transport` (host
Python, no JAX): the same names, error texts, literal tables and wire
shapes.

The plain JSON-line pipe protocol between
:class:`~pddl_tpu_torch.serve.fleet.replica.ProcessReplica` and `fleet/worker.py` was raw JSON lines — which
assumes the stdio pipe is a perfectly reliable, perfectly ordered
network. That is true of a kernel pipe on one box and false of every
transport the fleet will ever ride at pod scale (TCP through proxies,
RDMA with flaky links, a relay that re-chunks writes). Gray Failure
(Huang et al., HotOS '17) is explicit that the differential between
"dead" and "subtly corrupting/delaying" is what takes systems down, so
this module makes the wire UNTRUSTED and the failure modes injectable:

- **Framing.** Every payload travels as one line::

      PF1 <seq> <crc32-hex> <len> <payload-json>\\n

  Length-prefix (byte length of the payload), CRC32 over the payload
  bytes, and a per-direction monotone sequence number. A frame whose
  length or CRC disagrees is REJECTED, never parsed — zero corrupt
  frames accepted is a property of the codec, not of luck. The frame
  stays newline-terminated so the existing select()/readline pump
  loops keep working unchanged.
- **Sequencing.** The receiver delivers payloads in seq order:
  duplicates (seq already delivered) are dropped, gaps (a future seq
  arrives first) are buffered and trigger a bounded RESEND REQUEST for
  the missing range; the sender keeps a bounded replay buffer of
  recent frames to answer from. Retries are bounded with timeout
  backoff — an unrecoverable wire degrades to the typed
  :class:`~pddl_tpu_torch.serve.fleet.replica.ReplicaDied` path the router
  already migrates around, it never wedges the router loop.
- **Bounded reads.** A single frame larger than ``max_frame_bytes``
  (default 8 MiB — a drain-snapshot or chain-pull base64 payload is
  MBs, a runaway line is not) is a TYPED reject
  (:class:`FrameTooLarge` recorded in the stats, the oversized bytes
  discarded up to the next newline), closing the unbounded
  single-line read the loops had.
- **Injection.** :class:`WireFaultPlan` is the `utils/faults.py`
  discipline applied to frames: seeded Bernoulli rates plus scheduled
  ``(step, site)`` coordinates (step = the frame's sequence number,
  site = the pipe direction), firing CORRUPT / TRUNCATE / DUPLICATE /
  REORDER / DELAY / DROP mutations on the byte stream. The same seed
  against the same workload mangles the same frames, so every
  recovery path of the framed transport is testable in tier-1 on CPU.
"""

from __future__ import annotations

import dataclasses
import enum
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FRAME_MAGIC = b"PF1"
# Large enough for chain-pull/base64 snapshot payloads, small enough
# that a runaway writer cannot balloon the peer's line buffer without
# a typed reject. Both pipe ends enforce it.
MAX_FRAME_BYTES = 8 * 1024 * 1024


class FrameError(ValueError):
    """A frame failed validation (bad magic/length/CRC): the payload
    is untrusted and is NOT parsed. The receiver records it and asks
    for a resend; nothing raises across the pump loop."""


class FrameTooLarge(FrameError):
    """A single line exceeded ``max_frame_bytes`` — the typed reject
    for the unbounded single-line pipe read (a multi-MB payload must
    arrive as a VALID frame under the cap, or not at all)."""


CONTROL_MAGIC = b"PFC"


def encode_control(payload: Dict) -> bytes:
    """A transport-CONTROL line (resend requests): deliberately
    OUTSIDE the sequence space. A control message ordered behind the
    very gap it reports would deadlock the healing — each side waiting
    for the other's missing frame — so control lines are sequence-free,
    idempotent, and periodically re-sent; a corrupted one is simply
    dropped and the next period repeats it."""
    import json

    return CONTROL_MAGIC + b" " + json.dumps(
        payload, separators=(",", ":")).encode() + b"\n"


def decode_control(line: bytes) -> Optional[Dict]:
    """The control payload, or None if the line is not (or no longer)
    a well-formed control line."""
    import json

    if not line.startswith(CONTROL_MAGIC + b" "):
        return None
    try:
        payload = json.loads(line[len(CONTROL_MAGIC) + 1:])
    except ValueError:
        return None
    return payload if isinstance(payload, dict) else None


def encode_frame(seq: int, payload_json: bytes) -> bytes:
    """One framed line: magic, sequence, CRC32, length, payload."""
    crc = zlib.crc32(payload_json) & 0xFFFFFFFF
    return b" ".join([FRAME_MAGIC, str(int(seq)).encode(),
                      format(crc, "08x").encode(),
                      str(len(payload_json)).encode(),
                      payload_json]) + b"\n"


def decode_frame(line: bytes) -> Tuple[int, bytes]:
    """``(seq, payload_json)`` of a framed line (no trailing newline),
    raising :class:`FrameError` on any validation failure."""
    parts = line.split(b" ", 4)
    if len(parts) != 5 or parts[0] != FRAME_MAGIC:
        raise FrameError("not a PF1 frame")
    try:
        seq = int(parts[1])
        crc = int(parts[2], 16)
        length = int(parts[3])
    except ValueError as e:
        raise FrameError(f"malformed frame header: {e}") from e
    payload = parts[4]
    if len(payload) != length:
        raise FrameError(
            f"length mismatch: header says {length}, got {len(payload)}")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise FrameError("CRC32 mismatch")
    return seq, payload


class FrameSender:
    """Outbound framing: assigns the monotone sequence and keeps a
    bounded replay buffer so the peer's resend requests can be
    answered without re-deriving application state."""

    def __init__(self, *, resend_buffer: int = 512):
        self._next_seq = 1
        self._buffer: "OrderedDict[int, bytes]" = OrderedDict()
        self._resend_buffer = int(resend_buffer)
        self.frames_sent = 0
        self.frames_resent = 0

    def encode(self, payload_json: bytes) -> bytes:
        seq = self._next_seq
        self._next_seq += 1
        frame = encode_frame(seq, payload_json)
        self._buffer[seq] = frame
        while len(self._buffer) > self._resend_buffer:
            self._buffer.popitem(last=False)
        self.frames_sent += 1
        return frame

    @property
    def last_seq(self) -> int:
        """Sequence number of the most recently encoded frame (0 when
        none yet) — the fault plan's step coordinate on egress."""
        return self._next_seq - 1

    def resend_from(self, from_seq: int) -> List[bytes]:
        """Every buffered frame with ``seq >= from_seq``, in order.
        Frames that aged out of the buffer are gone — the requester's
        bounded retry then degrades to its typed failure path."""
        out = [frame for seq, frame in self._buffer.items()
               if seq >= int(from_seq)]
        self.frames_resent += len(out)
        return out


class FrameReceiver:
    """Inbound framing: validates, de-duplicates, re-orders, and
    reports the gap to ask a resend for. Feed it raw lines; read
    in-order payloads back.

    Stats keys (all monotone counters): ``frames_ok``, ``crc_rejects``
    (CRC/length/parse failures — frames the codec REFUSED), ``dups``
    (sequence already delivered), ``gaps`` (a future frame arrived
    first), ``too_large`` (the typed oversize reject).
    """

    def __init__(self, *, max_frame_bytes: int = MAX_FRAME_BYTES,
                 reorder_buffer: int = 256, first_seq: int = 1):
        # ``first_seq``: where the sequence space begins for THIS
        # receiver. A standby that joins an already-running WAL stream
        # resumes from the shipper's next frame
        # after a disk catch-up — demanding history the sender's replay
        # buffer no longer holds would wedge the gap logic forever.
        self._expected = int(first_seq)
        self._pending: Dict[int, bytes] = {}
        self._max_frame = int(max_frame_bytes)
        self._reorder_buffer = int(reorder_buffer)
        self.stats: Dict[str, int] = {
            "frames_ok": 0, "crc_rejects": 0, "dups": 0, "gaps": 0,
            "too_large": 0}

    @property
    def expected_seq(self) -> int:
        return self._expected

    @property
    def has_gap(self) -> bool:
        return bool(self._pending)

    def feed(self, line: bytes) -> List[bytes]:
        """One raw line in; zero or more IN-ORDER payloads out (a
        gap-filling frame releases everything buffered behind it)."""
        if len(line) > self._max_frame:
            # Typed oversize reject. An oversized frame that VALIDATES
            # (correct CRC, just over policy) is refused terminally —
            # its sequence slot is consumed so the stream advances
            # (resending the same oversize would wedge the gap logic
            # forever); an oversized frame that fails validation takes
            # the corrupt path (resend may produce an intact one).
            self.stats["too_large"] += 1
            try:
                seq, _ = decode_frame(line)
            except FrameError:
                self.stats["crc_rejects"] += 1
                return []
            if seq != self._expected:
                return []
            out: List[bytes] = []
            self._expected += 1
            while self._expected in self._pending:
                out.append(self._pending.pop(self._expected))
                self._expected += 1
            self.stats["frames_ok"] += len(out)
            return out
        try:
            seq, payload = decode_frame(line)
        except FrameError:
            self.stats["crc_rejects"] += 1
            return []
        if seq < self._expected or seq in self._pending:
            self.stats["dups"] += 1
            return []
        if seq > self._expected:
            self.stats["gaps"] += 1
            if len(self._pending) < self._reorder_buffer:
                self._pending[seq] = payload
            return []
        out = [payload]
        self._expected += 1
        while self._expected in self._pending:
            out.append(self._pending.pop(self._expected))
            self._expected += 1
        self.stats["frames_ok"] += len(out)
        return out

    def drain_pending(self) -> List[Tuple[int, bytes]]:
        """Abandon in-order delivery: every buffered out-of-order
        frame, ``(seq, payload)`` sorted by seq, and the expectation
        jumps past them. The standby's catch-up path (router HA)
        calls this after refolding from disk — a gap on a
        one-way replication stream will never heal from the wire (the
        primary may be dead), and the disk fold already covers the
        missing range's durable prefix; whatever was buffered beyond
        it is the NON_DURABLE backlog, deduplicated downstream by the
        journal's own record sequence."""
        out = sorted(self._pending.items())
        self._pending.clear()
        if out:
            self._expected = max(self._expected, out[-1][0] + 1)
        return out


# ------------------------------------------------------ fault injection


class WireFaultKind(enum.Enum):
    CORRUPT = "corrupt"      # flip payload bytes: CRC must reject
    TRUNCATE = "truncate"    # cut the line short: length must reject
    DUPLICATE = "duplicate"  # deliver the frame twice: seq must dedup
    REORDER = "reorder"      # hold the frame, deliver after the next
    DELAY = "delay"          # tail-latency: sleep, frame intact
    DROP = "drop"            # lose the frame: gap + resend must heal


@dataclasses.dataclass(frozen=True)
class WireFaultSpec:
    """One scheduled wire fault: fire ``kind`` on the frame whose
    sequence number is ``step`` travelling in direction ``site``
    (``"cmd"`` parent->worker, ``"ev"`` worker->parent) — the
    `utils/faults.py` (step, site) coordinate discipline applied to
    the pipe."""

    step: int
    site: str
    kind: WireFaultKind


class WireFaultPlan:
    """Seeded wire-fault schedule over a framed pipe's two directions.

    The `utils/faults.py` shape: explicit :class:`WireFaultSpec`
    coordinates are the surgical tool, per-frame Bernoulli rates from
    one seeded generator are the chaos tool; the same seed against the
    same workload mangles the same frames. ``apply(site, seq, line)``
    returns the list of lines actually delivered in place of ``line``
    (possibly mutated, duplicated, reordered with a held frame, or
    empty for a drop).
    """

    SITES: Tuple[str, ...] = ("cmd", "ev")

    def __init__(self, seed: int = 0, *, corrupt_rate: float = 0.0,
                 truncate_rate: float = 0.0, duplicate_rate: float = 0.0,
                 reorder_rate: float = 0.0, delay_rate: float = 0.0,
                 drop_rate: float = 0.0, delay_s: float = 0.002,
                 sites: Optional[Sequence[str]] = None,
                 scheduled: Sequence[WireFaultSpec] = (),
                 max_random_injections: Optional[int] = None,
                 sleep_fn=time.sleep):
        rates = {"corrupt": corrupt_rate, "truncate": truncate_rate,
                 "duplicate": duplicate_rate, "reorder": reorder_rate,
                 "delay": delay_rate, "drop": drop_rate}
        for name, rate in rates.items():
            if not 0.0 <= rate <= 1.0:
                raise ValueError(
                    f"{name}_rate must be in [0, 1], got {rate}")
        if sum(rates.values()) > 1.0:
            raise ValueError("wire fault rates must sum to <= 1")
        if sites is not None:
            unknown = set(sites) - set(self.SITES)
            if unknown:
                raise ValueError(
                    f"unknown wire site(s) {sorted(unknown)}; valid "
                    f"sites are {self.SITES}")
        for spec in scheduled:
            if spec.site not in self.SITES:
                raise ValueError(
                    f"unknown scheduled wire site {spec.site!r}; valid "
                    f"sites are {self.SITES}")
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self._rates = {WireFaultKind(k): float(v)
                       for k, v in rates.items()}
        self.delay_s = float(delay_s)
        self._sites = frozenset(sites) if sites is not None else None
        self._sched: Dict[Tuple[int, str], List[WireFaultKind]] = {}
        for spec in scheduled:
            self._sched.setdefault((spec.step, spec.site), []).append(
                spec.kind)
        self._max_random = max_random_injections
        self._random_fired = 0
        self._sleep = sleep_fn
        # One held frame per site (the REORDER mechanism): delivered
        # in front of the NEXT frame on the same direction.
        self._held: Dict[str, bytes] = {}
        self.injected: Dict[WireFaultKind, int] = {
            k: 0 for k in WireFaultKind}
        self.on_inject = None  # fn(seq, site, kind_value), tracer hook

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def _draw(self, site: str, seq: int) -> Optional[WireFaultKind]:
        pending = self._sched.get((seq, site))
        if pending:
            kind = pending.pop(0)
            if not pending:
                del self._sched[(seq, site)]
            return kind
        if self._sites is not None and site not in self._sites:
            return None
        if (self._max_random is not None
                and self._random_fired >= self._max_random):
            return None
        total = sum(self._rates.values())
        if total <= 0.0:
            return None
        u = self._rng.random()
        acc = 0.0
        for kind, rate in self._rates.items():
            acc += rate
            if u < acc:
                self._random_fired += 1
                return kind
        return None

    def apply(self, site: str, seq: int, line: bytes) -> List[bytes]:
        """The lines to actually deliver in place of ``line``."""
        out: List[bytes] = []
        held = self._held.pop(site, None)
        kind = self._draw(site, seq)
        if kind is None:
            if held is not None:
                out.append(held)
            out.append(line)
            return out
        self.injected[kind] += 1
        if self.on_inject is not None:
            self.on_inject(seq, site, kind.value)
        if kind is WireFaultKind.CORRUPT:
            mangled = bytearray(line)
            # Flip a byte inside the payload region (past the header),
            # never the trailing newline — the line structure survives,
            # the CRC must not.
            idx = max(0, len(mangled) - 2 - int(
                self._rng.integers(0, max(1, len(mangled) // 2))))
            mangled[idx] ^= 0x5A
            out.extend([] if held is None else [held])
            out.append(bytes(mangled))
        elif kind is WireFaultKind.TRUNCATE:
            cut = max(len(FRAME_MAGIC) + 1, len(line) // 2)
            out.extend([] if held is None else [held])
            out.append(line[:cut] + b"\n")
        elif kind is WireFaultKind.DUPLICATE:
            out.extend([] if held is None else [held])
            out.extend([line, line])
        elif kind is WireFaultKind.REORDER:
            # Hold THIS frame; a previously held one flushes first so
            # at most one frame per site is ever in flight late.
            if held is not None:
                out.append(held)
            self._held[site] = line
        elif kind is WireFaultKind.DELAY:
            self._sleep(self.delay_s)
            out.extend([] if held is None else [held])
            out.append(line)
        else:  # DROP
            if held is not None:
                out.append(held)
        return out

    def flush(self, site: str) -> List[bytes]:
        """Release a held (REORDER) frame — call when the stream is
        ending so a reordered final frame is not lost forever."""
        held = self._held.pop(site, None)
        return [held] if held is not None else []
