"""Crash-durable flight recorder: a worker's last words.

The port's own copy of :mod:`pddl_tpu.obs.flightrec` (host Python, no
JAX): the same names, error texts, literal tables and wire shapes.

A SIGKILL'd worker takes its in-memory telemetry ring and any
unshipped spans with it — exactly the records an operator needs to
explain the death. The flight recorder writes them to a per-worker
file as they happen: CRC-framed JSON records appended to a
``current.frec`` segment, atomically rotated (fsync + rename) into
numbered ``seg-NNNNNN.frec`` files with the oldest pruned. Plain
appends are enough for process-death durability — the page cache
survives SIGKILL — so the hot path never fsyncs; rotation is the
machine-crash checkpoint.

Every file operation routes through the journal VFS shim
(:class:`pddl_tpu_torch.serve.fleet.journal._JournalVFS`), so a
StorageFaultPlan covers the recorder exactly like the WAL and a
failing disk degrades it to counted no-export (``records_dropped``,
then ``disabled``) — it must NEVER crash serving.

:func:`harvest` is the router's side: read every segment of a dead
worker's directory, CRC-verify, stop cleanly at a torn tail, and
return the records for the postmortem bundle
(:func:`write_postmortem`) alongside the WAL and drain mirrors.
"""

from __future__ import annotations

import json
import os
import re
import struct
import time
import zlib
from typing import Dict, List, Optional

from pddl_tpu_torch.serve.fleet.journal import _JournalVFS

_MAGIC = b"PFR1"
# Frame: magic, payload length, crc32(payload) — then the payload.
_HEADER = struct.Struct(">4sII")
_SEG_RE = re.compile(r"^seg-(\d{6})\.frec$")

CURRENT_NAME = "current.frec"


class FlightRecorder:
    """Append-only, bounded, fault-degrading record sink for one
    worker process.

    ``append`` never raises: an ``OSError`` (real disk trouble or an
    injected storage fault) is counted, and after ``error_limit``
    strikes the recorder disables itself — every later append is a
    counted drop. Serving never notices.
    """

    def __init__(self, dirpath: str, *, storage_plan=None,
                 max_segment_bytes: int = 262144,
                 max_segments: int = 4,
                 error_limit: int = 3,
                 tracer=None,
                 clock=time.monotonic):
        self.dir = str(dirpath)
        self.max_segment_bytes = int(max_segment_bytes)
        self.max_segments = int(max_segments)
        self.error_limit = int(error_limit)
        self._vfs = _JournalVFS(storage_plan)
        self._tracer = tracer
        self._clock = clock
        self._fd: Optional[int] = None
        self._cur_bytes = 0
        self.records_written = 0
        self.records_dropped = 0
        self.bytes_written = 0
        self.rotations = 0
        self.errors = 0
        self.disabled = False
        try:
            os.makedirs(self.dir, exist_ok=True)
            self._open_current()
        except OSError:
            self._note_error(fatal=True)

    # ------------------------------------------------------- file plumbing
    @property
    def current_path(self) -> str:
        return os.path.join(self.dir, CURRENT_NAME)

    def _segment_seqs(self) -> List[int]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        seqs = []
        for name in names:
            m = _SEG_RE.match(name)
            if m:
                seqs.append(int(m.group(1)))
        return sorted(seqs)

    def _open_current(self) -> None:
        self._fd = self._vfs.open(
            self.current_path,
            os.O_WRONLY | os.O_CREAT | os.O_APPEND)
        self._cur_bytes = self._vfs.fstat(self._fd).st_size

    def _close_fd(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None

    def _note_error(self, fatal: bool = False) -> None:
        self.errors += 1
        if fatal or self.errors >= self.error_limit:
            self.disabled = True
            self._close_fd()

    # ------------------------------------------------------------- writes
    def append(self, record: Dict[str, object]) -> bool:
        """Frame and append one record; ``False`` means dropped
        (disabled recorder or a counted write failure)."""
        if self.disabled or self._fd is None:
            self.records_dropped += 1
            return False
        try:
            payload = json.dumps(record, separators=(",", ":"),
                                 default=_json_default).encode("utf-8")
            frame = _HEADER.pack(_MAGIC, len(payload),
                                 zlib.crc32(payload)) + payload
            self._vfs.write(self._fd, frame)
        except (OSError, TypeError, ValueError):
            self.records_dropped += 1
            self._note_error()
            return False
        self._cur_bytes += len(frame)
        self.bytes_written += len(frame)
        self.records_written += 1
        if self._cur_bytes >= self.max_segment_bytes:
            self._rotate()
        return True

    def _rotate(self) -> None:
        """Seal ``current`` into a numbered segment: fsync (the
        machine-crash checkpoint), atomic rename, prune the oldest
        beyond ``max_segments``, reopen a fresh current."""
        if self._fd is None:
            return
        try:
            self._vfs.fsync(self._fd)
            self._close_fd()
            seqs = self._segment_seqs()
            next_seq = (seqs[-1] + 1) if seqs else 1
            seg_path = os.path.join(self.dir,
                                    f"seg-{next_seq:06d}.frec")
            self._vfs.replace(self.current_path, seg_path)
            self._open_current()
        except OSError:
            self._note_error()
            return
        self.rotations += 1
        for seq in self._segment_seqs()[:-self.max_segments]:
            try:
                os.unlink(os.path.join(self.dir,
                                       f"seg-{seq:06d}.frec"))
            except OSError:
                pass
        if self._tracer is not None:
            self._tracer.on_flight_rotate(self.rotations,
                                          self.bytes_written)

    def close(self) -> None:
        if self._fd is not None:
            try:
                self._vfs.fsync(self._fd)
            except OSError:
                pass
            self._close_fd()

    def counts(self) -> Dict[str, int]:
        return {
            "records_written": self.records_written,
            "records_dropped": self.records_dropped,
            "bytes_written": self.bytes_written,
            "rotations": self.rotations,
            "errors": self.errors,
            "disabled": int(self.disabled),
        }


def _json_default(obj):
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


# ----------------------------------------------------------- harvesting


def readable_records(data: bytes) -> List[Dict[str, object]]:
    """Decode the readable prefix of one segment's bytes: frames are
    trusted until the first torn/corrupt one (short header, bad magic,
    truncated payload, CRC mismatch), then reading stops — the same
    prefix discipline the WAL applies."""
    out: List[Dict[str, object]] = []
    off = 0
    n = len(data)
    while off + _HEADER.size <= n:
        magic, length, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC:
            break
        start = off + _HEADER.size
        end = start + length
        if end > n:
            break  # torn tail: the crash cut this frame short
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            break
        try:
            out.append(json.loads(payload.decode("utf-8")))
        except (UnicodeDecodeError, ValueError):
            break
        off = end
    return out


def harvest(dirpath: str) -> List[Dict[str, object]]:
    """Read a (dead) worker's flight-recorder directory: every sealed
    segment in sequence order, then the unsealed ``current`` tail.
    Unreadable files are skipped — harvest returns whatever survived,
    it never raises."""
    records: List[Dict[str, object]] = []
    try:
        names = os.listdir(dirpath)
    except OSError:
        return records
    ordered = sorted(n for n in names if _SEG_RE.match(n))
    if CURRENT_NAME in names:
        ordered.append(CURRENT_NAME)
    for name in ordered:
        try:
            with open(os.path.join(dirpath, name), "rb") as f:
                data = f.read()
        except OSError:
            continue
        records.extend(readable_records(data))
    return records


def write_postmortem(dirpath: str,
                     bundle: Dict[str, object]) -> Optional[str]:
    """Drop the router's postmortem bundle next to the segments it
    was harvested from (``postmortem-NNN.json``, never overwriting an
    earlier death's bundle). Returns the path, or ``None`` if the
    directory is as dead as the worker."""
    try:
        existing = [n for n in os.listdir(dirpath)
                    if n.startswith("postmortem-")]
        path = os.path.join(
            dirpath, f"postmortem-{len(existing):03d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f, indent=2, sort_keys=True,
                      default=_json_default)
        os.replace(tmp, path)
        return path
    except OSError:
        return None
