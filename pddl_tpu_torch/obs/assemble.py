"""Trace assembler: stitch fleet trace records, find gaps, attribute
TTFT.

The port's own copy of :mod:`pddl_tpu.obs.assemble` (host Python, no
JAX): the same names, error texts, literal tables and wire shapes.

Input is the flat record stream a
:class:`pddl_tpu_torch.obs.propagate.TraceCollector` accumulates (or its
JSONL dump): one ``kind="fleet_span"`` record per stream on the
router's clock, plus every replica's ``kind="span"`` records on their
own monotonic clocks. :func:`stitch` groups them by trace id —
hand-off rebinds and hedge copies already share one id thanks to the
collector's alias discipline — and each :class:`Trace` can then

- judge itself **gap-free** (:meth:`Trace.gaps`): router record
  terminal, at least one replica span for every finished stream,
  token coverage matching the acked token count, and both sides of
  every hand-off present;
- attribute its TTFT to **segments** (:meth:`Trace.critical_path`):
  queue wait, admission, prefix match, host-tier promotion, prefill
  compute, hand-off export/import, and the residual first tick. All
  segment arithmetic is same-clock-domain (walls measured inside one
  process); the per-replica clock offsets are only used to place
  spans on the router's axis for display.

:func:`aggregate` folds many traces into fleet-level percentiles per
segment — the "where does TTFT go" table the CLI
(``python -m pddl_tpu_torch.obs.assemble records.jsonl``) prints.

``TRACE_EVENTS`` below is the authoritative event-name vocabulary:
a static ``trace-vocab`` rule can check every literal the tracer and
the propagation layer emit against it, both directions.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List, Optional, Sequence

# The recognized trace-event vocabulary. Engine-side span events come
# from obs/trace.py, chain-wire transfer spans and router fleet_span
# events from obs/propagate.py. a static rule (trace-vocab) can enforce that
# emitters use only these names and that none of them is stale.
TRACE_EVENTS = (
    # engine-side span events (obs/trace.py)
    "queued",
    "admitted",
    "prefix_match",
    "prefill_chunk",
    "first_token",
    "decode",
    "deadline_shed",
    "preempted",
    "replay",
    "restored",
    # chain-wire transfer spans (obs/propagate.py)
    "chain_export",
    "chain_import",
    # router-side fleet_span events (obs/propagate.py)
    "submit",
    "route",
    "hedge",
    "restore",
    "handoff",
    "handoff_export",
    "handoff_import",
    "finish",
)

# TTFT critical-path segments, in pipeline order. Values are seconds;
# they sum to the stream's TTFT (first_tick absorbs the residual).
TRACE_SEGMENTS = (
    "queue_wait",
    "admission",
    "prefix_match",
    "host_promote",
    "prefill",
    "handoff_export",
    "handoff_import",
    "first_tick",
)


def _named(events: Sequence[Dict[str, object]],
           name: str) -> List[Dict[str, object]]:
    return [e for e in events if e.get("name") == name]


def _pct(values: List[float], q: float) -> float:
    """Nearest-rank percentile (matches serve/metrics.py)."""
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[idx]


class Trace:
    """One stream's stitched records: the router's fleet_span plus
    every replica/chain span sharing its trace id."""

    __slots__ = ("trace_id", "router", "spans")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.router: Optional[Dict[str, object]] = None
        self.spans: List[Dict[str, object]] = []

    # ------------------------------------------------------- accessors
    def replica_spans(self) -> List[Dict[str, object]]:
        """Engine request spans only (chain transfer spans excluded)."""
        return [s for s in self.spans
                if s.get("name") not in ("chain_export", "chain_import")]

    def chain_spans(self) -> List[Dict[str, object]]:
        return [s for s in self.spans
                if s.get("name") in ("chain_export", "chain_import")]

    def replicas(self) -> List[int]:
        seen: List[int] = []
        for s in self.spans:
            r = s.get("replica")
            if r is not None and r not in seen:
                seen.append(r)  # insertion order = arrival order
        return seen

    # ------------------------------------------------------------ gaps
    def gaps(self) -> List[str]:
        """Why this trace is NOT gap-free (empty list == clean).

        A finished stream must have the router's terminal record, at
        least one replica span, token coverage >= the acked token
        count (max across spans — a restored handle carries the full
        token list, so the final span covers replays and hand-offs),
        and, when the router recorded a hand-off, spans from both the
        prefill and the decode replica.
        """
        out: List[str] = []
        if self.router is None:
            return ["no_router_record"]
        state = self.router.get("state")
        if state is None:
            return ["router_not_terminal"]
        if state != "finished":
            # Failed/cancelled/shed streams end wherever they ended;
            # only token-bearing completions owe full coverage.
            return out
        spans = self.replica_spans()
        if not spans:
            out.append("no_replica_span")
        else:
            acked = int(self.router.get("n_tokens") or 0)
            cover = max(
                int((s.get("attrs") or {}).get("tokens_emitted") or 0)
                for s in spans)
            if cover < acked:
                out.append(f"token_coverage:{cover}/{acked}")
        events = self.router.get("events") or []
        for h in _named(events, "handoff"):
            src = h.get("from_replica")
            dst = h.get("to_replica")
            have = {s.get("replica") for s in spans}
            if src not in have:
                out.append(f"no_prefill_span:replica{src}")
            if dst not in have:
                out.append(f"no_decode_span:replica{dst}")
            if h.get("blocks"):
                names = {s.get("name") for s in self.chain_spans()}
                if "chain_export" not in names:
                    out.append("no_chain_export_span")
                if "chain_import" not in names:
                    out.append("no_chain_import_span")
        return out

    # --------------------------------------------------- critical path
    def critical_path(self) -> Optional[Dict[str, float]]:
        """Attribute this stream's TTFT to ``TRACE_SEGMENTS``.

        Anchored on the replica span that contains the ``first_token``
        event — its own events carry queue wait, admission time,
        per-chunk prefill walls (site-tagged: ``gather`` is prefix-
        cache reuse, ``host_promote`` the host-tier climb) all on ONE
        clock. Hand-off export/import walls count only when the router
        saw the hand-off before first token (a mid-prefill migration);
        the usual post-first-token hand-off is not TTFT. ``first_tick``
        is the residual, clamped at zero.
        """
        ft_span = None
        ft_ev = None
        for s in self.replica_spans():
            hits = _named(s.get("events") or [], "first_token")
            if hits:
                ft_span, ft_ev = s, hits[0]
                break
        if ft_span is None or ft_ev is None:
            return None
        evs = ft_span.get("events") or []
        ft_t = float(ft_ev.get("t_s") or 0.0)
        ttft = ft_ev.get("ttft_s")
        if ttft is None and self.router is not None:
            ttft = self.router.get("ttft_s")
        if ttft is None:
            ttft = ft_t - float(ft_span.get("start_s") or ft_t)
        ttft = float(ttft)

        seg = {name: 0.0 for name in TRACE_SEGMENTS}
        admits = [e for e in _named(evs, "admitted")
                  if float(e.get("t_s") or 0.0) <= ft_t]
        admit_t = None
        if admits:
            admit = admits[-1]  # last admission before first token
            admit_t = float(admit.get("t_s") or 0.0)
            seg["queue_wait"] = max(
                0.0, float(admit.get("queue_wait_s") or 0.0))
        first_chunk_t = None
        for e in _named(evs, "prefill_chunk"):
            t = float(e.get("t_s") or 0.0)
            if t > ft_t:
                continue
            wall = max(0.0, float(e.get("wall_s") or 0.0))
            site = e.get("site")
            if site == "gather":
                seg["prefix_match"] += wall
            elif site == "host_promote":
                seg["host_promote"] += wall
            else:
                seg["prefill"] += wall
            if first_chunk_t is None or t - wall < first_chunk_t:
                first_chunk_t = t - wall
        if admit_t is not None and first_chunk_t is not None:
            seg["admission"] = max(0.0, first_chunk_t - admit_t)
        if self.router is not None:
            revents = self.router.get("events") or []
            ft_router = _named(revents, "first_token")
            ft_router_t = (float(ft_router[0].get("t_s") or 0.0)
                           if ft_router else None)
            for name in ("handoff_export", "handoff_import"):
                for e in _named(revents, name):
                    if (ft_router_t is not None
                            and float(e.get("t_s") or 0.0) > ft_router_t):
                        continue
                    seg[name] += max(0.0, float(e.get("wall_s") or 0.0))
        spent = sum(seg.values())
        seg["first_tick"] = max(0.0, ttft - spent)
        seg["ttft_s"] = ttft
        return seg


def stitch(records: Iterable[Dict[str, object]], *,
           apply_offsets: bool = False) -> Dict[str, Trace]:
    """Group a flat record stream into traces by trace id.

    With ``apply_offsets=True``, replica span timestamps (``start_s``,
    ``end_s``, event ``t_s``) are shifted into the router's clock
    domain using each record's ``clock_offset_s`` tag — wanted for
    cross-process timeline display, unnecessary for gap checks and
    segment math (those stay within one clock).
    """
    traces: Dict[str, Trace] = {}
    for rec in records:
        tid = rec.get("trace_id")
        if not tid:
            continue
        trace = traces.setdefault(str(tid), Trace(str(tid)))
        kind = rec.get("kind")
        if kind == "fleet_span":
            # Prefer the record that reached a terminal state (a
            # recovered router may contribute a second, live one).
            if (trace.router is None
                    or trace.router.get("state") is None):
                trace.router = rec
        elif kind == "span":
            if apply_offsets and rec.get("clock_offset_s") is not None:
                rec = _shift(rec, -float(rec["clock_offset_s"]))
            trace.spans.append(rec)
    return traces


def _shift(rec: Dict[str, object], delta: float) -> Dict[str, object]:
    out = dict(rec)
    for key in ("start_s", "end_s"):
        if out.get(key) is not None:
            out[key] = float(out[key]) + delta
    evs = []
    for e in out.get("events") or []:
        e = dict(e)
        if e.get("t_s") is not None:
            e["t_s"] = float(e["t_s"]) + delta
        evs.append(e)
    out["events"] = evs
    return out


def aggregate(traces: Iterable[Trace]) -> Dict[str, object]:
    """Fleet-level TTFT attribution: per-segment mean/p50/p95/p99
    seconds over every trace with a resolvable critical path, plus
    trace counts and gap totals."""
    paths: List[Dict[str, float]] = []
    n_traces = 0
    gappy = 0
    for t in traces:
        n_traces += 1
        if t.gaps():
            gappy += 1
        cp = t.critical_path()
        if cp is not None:
            paths.append(cp)
    segments: Dict[str, Dict[str, float]] = {}
    for name in TRACE_SEGMENTS + ("ttft_s",):
        vals = [p[name] for p in paths if name in p]
        if not vals:
            continue
        segments[name] = {
            "mean_s": sum(vals) / len(vals),
            "p50_s": _pct(vals, 0.50),
            "p95_s": _pct(vals, 0.95),
            "p99_s": _pct(vals, 0.99),
        }
    return {
        "traces": n_traces,
        "attributed": len(paths),
        "gappy": gappy,
        "segments": segments,
    }


def read_jsonl(path: str) -> List[Dict[str, object]]:
    records: List[Dict[str, object]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def render_report(traces: Dict[str, Trace]) -> str:
    """The human-facing attribution report: one line per trace (state,
    tokens, TTFT, gap verdict), then the fleet segment table."""
    lines: List[str] = []
    agg = aggregate(traces.values())
    lines.append(f"traces={agg['traces']} attributed={agg['attributed']}"
                 f" gappy={agg['gappy']}")
    lines.append("")
    lines.append(f"{'trace_id':>18} {'state':>10} {'tokens':>7}"
                 f" {'ttft_ms':>9} {'replicas':>9} gaps")
    for tid in sorted(traces):
        t = traces[tid]
        state = "?" if t.router is None else (
            t.router.get("state") or "live")
        toks = 0 if t.router is None else int(
            t.router.get("n_tokens") or 0)
        cp = t.critical_path()
        ttft = "-" if cp is None else f"{cp['ttft_s'] * 1e3:.2f}"
        reps = ",".join(str(r) for r in t.replicas()) or "-"
        gaps = ";".join(t.gaps()) or "ok"
        lines.append(f"{tid:>18} {state:>10} {toks:>7}"
                     f" {ttft:>9} {reps:>9} {gaps}")
    lines.append("")
    lines.append(f"{'segment':>16} {'mean_ms':>9} {'p50_ms':>9}"
                 f" {'p95_ms':>9} {'p99_ms':>9}")
    for name in TRACE_SEGMENTS + ("ttft_s",):
        stats = agg["segments"].get(name)  # type: ignore[union-attr]
        if stats is None:
            continue
        lines.append(
            f"{name:>16} {stats['mean_s'] * 1e3:>9.3f}"
            f" {stats['p50_s'] * 1e3:>9.3f}"
            f" {stats['p95_s'] * 1e3:>9.3f}"
            f" {stats['p99_s'] * 1e3:>9.3f}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pddl_tpu_torch.obs.assemble",
        description="Stitch fleet trace records and attribute TTFT.")
    parser.add_argument("records", help="JSONL trace-record dump "
                        "(TraceCollector.dump output)")
    parser.add_argument("--json", action="store_true",
                        help="emit the aggregate as JSON instead of "
                        "the report table")
    args = parser.parse_args(argv)
    traces = stitch(read_jsonl(args.records))
    if args.json:
        print(json.dumps(aggregate(traces.values()), indent=2,
                         sort_keys=True))
    else:
        print(render_report(traces))
    return 0


if __name__ == "__main__":
    sys.exit(main())
