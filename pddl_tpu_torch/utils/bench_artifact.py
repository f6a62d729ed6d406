"""Bench-artifact provenance and repeat-timing discipline (the port of
:mod:`pddl_tpu.utils.bench_artifact`: the same statistics, directions,
comparison and gate, and a provenance block that also names the card).

Numbers measured on mixed trees with single-shot timings disagree with
each other and with the prose that quotes them (the JAX package's serving
artifacts once sat 26% apart on an identical config). This module is the
fix, for every bench of the port:

- :func:`provenance` stamps ``{git_commit, dirty, n_repeats, device}``
  into the record, so any artifact can be traced to the exact tree it
  measured (and a dirty tree is visible, not hidden) and to the card it
  ran on: its name and power limit, as ``nvidia-smi`` reports them (a
  card set below its maximum power runs slower under load).
- :func:`timed_stats` runs ``n_repeats >= 3`` timed repetitions and
  returns ``{median, spread_pct, samples}`` — the median is the
  headline, the spread is the drift detector (a >5% spread means the
  number is weather, not signal, and the docs must say so).

Keep the sync discipline: PyTorch returns before the card finishes, so
on the card the ``sync`` callable waits for the device
(``lambda _: torch.cuda.synchronize()``); a host clock without it times
the enqueue, not the work.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional, Tuple


def git_commit() -> Dict[str, object]:
    """``{commit, dirty}`` of the working tree, or ``unknown`` outside
    a repo — never raises (benches must run anywhere)."""
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            check=True, timeout=10).stdout.strip()
        dirty = bool(subprocess.run(
            ["git", "status", "--porcelain"], capture_output=True,
            text=True, check=True, timeout=10).stdout.strip())
        return {"commit": commit, "dirty": dirty}
    except Exception:  # noqa: BLE001 - no git, not a repo, timeout: all fine
        return {"commit": "unknown", "dirty": None}


def device_line() -> Optional[str]:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card's line), or ``None`` where there is no ``nvidia-smi`` —
    never raises (benches must run anywhere; a bench that needs the card
    checks for it itself)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        return out.splitlines()[0] if out else None
    except Exception:  # noqa: BLE001 - no tool, no card, timeout: all fine
        return None


def provenance(n_repeats: int) -> Dict[str, object]:
    """The artifact-level provenance block every bench embeds as
    ``record["provenance"]``."""
    g = git_commit()
    return {
        "git_commit": g["commit"],
        "git_dirty": g["dirty"],
        "n_repeats": int(n_repeats),
        "timing": "median over n_repeats; spread_pct = "
                  "100*(max-min)/median",
        "device": device_line(),
    }


def median_spread(samples: List[float]) -> tuple:
    """``(median, spread_pct)`` of a sample list — ONE definition of
    both statistics (``statistics.median``, even-length averaging), so
    no bench can drift to a different convention. Requires >= 3
    samples: a single sample cannot expose drift."""
    if len(samples) < 3:
        raise ValueError(
            f"need >= 3 samples for a meaningful spread, got "
            f"{len(samples)}")
    med = statistics.median(samples)
    return med, 100.0 * (max(samples) - min(samples)) / med


def timed_stats(fn: Callable, sync: Callable, *,
                n_repeats: int = 3) -> Dict[str, object]:
    """Median/spread wall-clock of ``sync(fn())`` over ``n_repeats``
    repetitions (>= 3 enforced via :func:`median_spread`). The caller
    warms up (kernel builds, allocator, autotuning) before the first
    call; on the card ``sync`` is ``lambda _: torch.cuda.synchronize()``."""
    samples: List[float] = []
    for _ in range(max(n_repeats, 0)):
        t0 = time.perf_counter()
        sync(fn())
        samples.append(time.perf_counter() - t0)
    med, spread = median_spread(samples)
    return {
        "median_s": med,
        "spread_pct": spread,
        "samples_s": [round(s, 6) for s in samples],
    }


# ---------------------------------------------------------------------
# Artifact comparison: the perf-trajectory gate.
#
# The artifact series is now long enough that SILENT regressions are the
# main risk to the "fast as the hardware allows" claim: a slow change
# lands, the next round re-measures on the slower tree, and the docs
# faithfully quote the regressed number. The gate makes that loud:
# compare() diffs two records measured at the SAME (metric, config) and
# fails on any headline median moving the WRONG direction by more than
# the threshold — higher-is-better keys (tok/s, speedup, hit rate,
# retention) falling, lower-is-better keys (TTFT, latency, wall time)
# rising. Spread/sample/count keys are noise, not headlines, and are
# never compared.

# Direction heuristics over the repo's artifact key vocabulary. Checked
# in order: the FIRST match wins, so e.g. "ttft_reduction_x" (a ratio,
# higher = better) beats the "ttft" latency rule.
_HIGHER_BETTER = ("tokens_per_s", "tokens_per_sec", "speedup", "retained",
                  "reduction", "hit_rate", "accepted", "_per_tick",
                  "throughput", "goodput", "shed_absorbed",
                  "eliminated", "tokens_per_byte",
                  # Any *_tok_s leaf is a decode rate (r14's mixed/
                  # plain/constrained legs included); adapter_hit_rate
                  # rides "hit_rate", mask_overhead_x "overhead". The
                  # graftlint snapshot-hygiene rule audits every
                  # committed headline key against this vocabulary.
                  "tok_s",
                  # Throughput ratios against a clean baseline
                  # (r09 tracing_off_vs_r08_clean_x, r11 vs_r08_clean_x)
                  # and the tracing-on/off retention ratio: up = less
                  # overhead lost.
                  "clean_x", "tracing_on_over_off",
                  # Elastic-autoscaling headlines (r16): goodput rides
                  # the "goodput" rule; scale_events is the per-wave
                  # floor of executed capacity transitions (an r-record
                  # whose autoscaler stops scaling must fail loudly);
                  # *_zero_lost counts requests live-migrated with
                  # nothing lost — fewer proven-safe migrations is a
                  # coverage regression.
                  "scale_events", "zero_lost",
                  # Speculative-serving headlines (r17): acceptance_rate
                  # is the draft-quality series behind the throughput
                  # win (spec_tok_s rides "tok_s", spec_speedup_x rides
                  # "speedup", tokens_per_tick rides "_per_tick").
                  "acceptance_rate",
                  # Tiered-KV-cache headlines (r18): demotion/promotion
                  # traffic that stopped happening is a coverage
                  # regression (spilled blocks are chains saved from
                  # recompute, promoted blocks are prefills avoided);
                  # "promot" covers both host_tier_promotions and
                  # host_tier_promote_tokens_charged; hit-rate leaves
                  # ride "hit_rate", the TTFT ratio rides "ttft"
                  # below, chain pulls ride "chain_pull".
                  "spill", "promot", "chain_pull",
                  # Control-plane robustness headlines (r19): hedge
                  # wins are interactive requests a gray replica would
                  # have stalled (throughput_retained rides
                  # "retained", the hedged-TTFT ratio rides
                  # "reduction"; raw wire-reject COUNTS are draw-level
                  # telemetry, deliberately not gated).
                  "hedge_win",
                  # Storage-fault availability (r21): the fraction of
                  # clean throughput the fleet holds while its WAL is
                  # degraded NON_DURABLE under a persistent-EIO storm
                  # — a dying disk must cost serving nothing (re-arm
                  # latency rides "latency", campaign recovery rides
                  # "recovery_s").
                  "availability")
_LOWER_BETTER = ("ttft", "latency", "_ms", "_wall_s", "overhead",
                 "_seconds", "tick_s", "step_s", "copy_us",
                 # Time the brownout ladder spent engaged (r16): a
                 # same-config record whose fleet browns out longer
                 # regressed its overload posture.
                 "rung_time",
                 # Router WAL crash recovery wall time (r19): MTTR for
                 # the control plane — a same-config record whose
                 # recovery got slower regressed the durability story.
                 "recovery_s",
                 # Prefill tokens the fleet spent on prefixes a sibling
                 # replica already held (r18): the number the chain
                 # pull exists to eliminate.
                 "duplicate_prefill",
                 # Decode-side p99 token latency under long-prompt
                 # bursts (r20): the interference disaggregation
                 # exists to remove — lower means prefill stopped
                 # stealing decode ticks.
                 "interference",
                 # Hot-standby detection+promotion wall time (r23):
                 # the HA headline riding next to recovery_s — a
                 # same-config record whose failover got slower
                 # regressed the whole point of keeping a standby.
                 "failover_s")
_NEVER = ("spread", "samples", "per_pair", "per_repeat", "n_requests",
          "count", "injected", "provenance", "seed", "offered",
          # The r18 tier curve's sweep axis (working_set_x is a
          # multiple of the pool size, not a measurement) — its _x
          # suffix only LOOKS like a ratio headline.
          "working_set")


def metric_direction(key: str) -> int:
    """+1 higher-is-better, -1 lower-is-better, 0 not comparable."""
    k = key.lower()
    if any(m in k for m in _NEVER):
        return 0
    for m in _HIGHER_BETTER:
        if m in k:
            return 1
    for m in _LOWER_BETTER:
        if m in k:
            return -1
    return 0


def load_artifact(path: str) -> List[Dict[str, object]]:
    """Records from an artifact file: whole-file JSON (single record,
    possibly pretty-printed) or JSONL (one record per line)."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
        return doc if isinstance(doc, list) else [doc]
    except json.JSONDecodeError:
        return [json.loads(line) for line in text.splitlines()
                if line.strip()]


def artifact_key(record: Dict[str, object]) -> Optional[Tuple[str, str]]:
    """The comparability key: ``(metric, canonical-config-json)``.
    Records only compare when BOTH match — a different model or slot
    count is a different experiment, not a regression. Records without
    a ``metric`` field predate the discipline and are skipped."""
    metric = record.get("metric")
    if not isinstance(metric, str):
        return None
    return metric, json.dumps(record.get("config", {}), sort_keys=True)


def _numeric_leaves(node, path: str = "") -> Dict[str, float]:
    out: Dict[str, float] = {}
    if isinstance(node, dict):
        for k, v in node.items():
            out.update(_numeric_leaves(v, f"{path}.{k}" if path else str(k)))
    elif isinstance(node, list):
        # Lists of sub-records (the fleet artifact's per-N scaling and
        # killed legs) are headline-bearing; key items by a semantic
        # field when one exists so a series that grows an N still pairs
        # the shared entries, else by index.
        for i, v in enumerate(node):
            tag = (f"[replicas={v['replicas']}]"
                   if isinstance(v, dict) and "replicas" in v else f"[{i}]")
            out.update(_numeric_leaves(v, path + tag))
    elif isinstance(node, bool):
        pass
    elif isinstance(node, (int, float)):
        out[path] = float(node)
    return out


def compare(old: Dict[str, object], new: Dict[str, object], *,
            threshold_pct: float = 5.0) -> List[Dict[str, object]]:
    """Regressions of ``new`` vs ``old`` (same artifact_key required):
    every shared numeric leaf under ``results`` (plus top-level
    scalars) whose directional move exceeds ``threshold_pct`` of the
    old value. Returns ``[]`` when nothing regressed; raises if the
    records are not comparable at all."""
    ko, kn = artifact_key(old), artifact_key(new)
    if ko is None or kn is None or ko != kn:
        raise ValueError(
            f"records are not comparable: {ko} vs {kn} — the gate "
            "compares identical (metric, config) only")
    leaves_old = _numeric_leaves(old.get("results", {}), "results")
    leaves_new = _numeric_leaves(new.get("results", {}), "results")
    for rec, leaves in ((old, leaves_old), (new, leaves_new)):
        for k, v in rec.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                leaves[k] = float(v)
    regressions: List[Dict[str, object]] = []
    for path in sorted(set(leaves_old) & set(leaves_new)):
        direction = metric_direction(path)
        if direction == 0:
            continue
        a, b = leaves_old[path], leaves_new[path]
        if a == 0.0:
            continue
        change_pct = 100.0 * (b - a) / abs(a)
        if -direction * change_pct > threshold_pct:
            regressions.append({
                "path": path, "old": a, "new": b,
                "change_pct": round(change_pct, 2),
                "direction": "higher-better" if direction > 0
                             else "lower-better",
            })
    # A directional leaf that DISAPPEARS is the quietest regression of
    # all — rename results.tokens_per_s and the intersection above never
    # sees it again. Growing new legs is fine (old side lacks them);
    # dropping a headline the old record measured is not.
    for path in sorted(set(leaves_old) - set(leaves_new)):
        if metric_direction(path) == 0:
            continue
        regressions.append({
            "path": path, "old": leaves_old[path], "new": None,
            "change_pct": None, "direction": "missing-in-new",
        })
    return regressions


_R_PREFIX = re.compile(r"^r(\d+)")


def check_series(paths: List[str], *, threshold_pct: float = 5.0):
    """The series gate: group every record in ``paths`` by
    :func:`artifact_key`, order each group by its ``rNN`` filename
    round (then filename), and :func:`compare` each consecutive pair.
    Returns ``(pairs_checked, failures)`` where each failure is
    ``{key, old_path, new_path, regressions}`` — the caller (the
    ``bench_gate`` pytest marker, or the CLI) fails loudly on any."""
    def round_of(path: str) -> int:
        m = _R_PREFIX.match(os.path.basename(path))
        return int(m.group(1)) if m else -1

    groups: Dict[Tuple[str, str], List[Tuple[int, str, Dict]]] = {}
    for path in paths:
        try:
            records = load_artifact(path)
        except (json.JSONDecodeError, OSError):
            continue  # not an artifact record file (txt probes etc.)
        for record in records:
            key = artifact_key(record)
            if key is None:
                continue
            groups.setdefault(key, []).append((round_of(path), path,
                                               record))
    pairs_checked, failures = 0, []
    for key, members in sorted(groups.items()):
        members.sort(key=lambda m: (m[0], m[1]))
        for (_, old_path, old), (_, new_path, new) in zip(members,
                                                          members[1:]):
            pairs_checked += 1
            regressions = compare(old, new, threshold_pct=threshold_pct)
            if regressions:
                failures.append({"key": key, "old_path": old_path,
                                 "new_path": new_path,
                                 "regressions": regressions})
    return pairs_checked, failures


def _main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``python -m pddl_tpu_torch.utils.bench_artifact compare OLD NEW``
    or ``... gate DIR`` (every r*.json under DIR). Exit 1 = regression."""
    import argparse
    import glob
    import sys

    p = argparse.ArgumentParser(prog="bench_artifact")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("compare", help="diff two artifacts at one config")
    pc.add_argument("old")
    pc.add_argument("new")
    pg = sub.add_parser("gate", help="gate the committed r*.json series")
    pg.add_argument("directory")
    for sp in (pc, pg):
        sp.add_argument("--threshold-pct", type=float, default=5.0)
    args = p.parse_args(argv)
    if args.cmd == "compare":
        old = load_artifact(args.old)[0]
        regressions = compare(old, load_artifact(args.new)[0],
                              threshold_pct=args.threshold_pct)
        pairs, failures = 1, ([{"key": artifact_key(old),
                                "old_path": args.old,
                                "new_path": args.new,
                                "regressions": regressions}]
                              if regressions else [])
    else:
        paths = sorted(glob.glob(os.path.join(args.directory, "r*.json")))
        pairs, failures = check_series(paths,
                                       threshold_pct=args.threshold_pct)
    print(f"bench gate: {pairs} comparable pair(s) checked, "
          f"{len(failures)} with regressions > {args.threshold_pct}%",
          file=sys.stderr)
    for failure in failures:
        print(f"REGRESSION {failure['old_path']} -> "
              f"{failure['new_path']} ({failure['key'][0]}):",
              file=sys.stderr)
        for r in failure["regressions"]:
            change = ("leaf vanished" if r["change_pct"] is None
                      else f"{r['change_pct']:+.1f}%")
            print(f"  {r['path']}: {r['old']} -> {r['new']} "
                  f"({change}, {r['direction']})",
                  file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(_main())
