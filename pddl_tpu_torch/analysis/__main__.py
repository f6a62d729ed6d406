"""The graftlint CLI: ``python -m pddl_tpu_torch.analysis [--check] [paths]``.

Exit codes: 0 clean (every finding suppressed or baselined, no stale
baseline entries, no parse errors), 1 findings/stale entries, 2 usage
or parse errors. ``--check`` is the CI mode tier-1 runs
(tests/test_torch_analysis.py pins it clean over ``pddl_tpu_torch/``);
without it the run additionally lists baselined findings for a human
pass.
"""

from __future__ import annotations

import argparse
import sys

from pddl_tpu_torch.analysis.core import (
    DEFAULT_BASELINE,
    all_rules,
    apply_baseline,
    load_baseline,
    run_analysis,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pddl_tpu_torch.analysis",
        description="graftlint: static invariant analysis "
                    "(pure AST — never imports the checked code)")
    parser.add_argument("paths", nargs="*", default=["pddl_tpu_torch"],
                        help="files/directories to analyze "
                             "(default: pddl_tpu_torch)")
    parser.add_argument("--check", action="store_true",
                        help="CI mode: succeed silently, fail loudly")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="baseline JSON of justified exceptions")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline (show everything)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule names to run")
    parser.add_argument("--list-rules", action="store_true",
                        help="list registered rules and exit")
    args = parser.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for rule in rules:
            print(f"{rule.name}: {rule.doc}")
        return 0
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - {r.name for r in rules}
        if unknown:
            print(f"unknown rule(s): {sorted(unknown)}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.name in wanted]

    findings, errors, analyzed = run_analysis(args.paths, rules=rules)
    for err in errors:
        print(f"error: {err}", file=sys.stderr)

    try:
        entries = [] if args.no_baseline else load_baseline(args.baseline)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    kept, used, stale = apply_baseline(
        findings, entries, analyzed_paths=analyzed,
        active_rules={r.name for r in rules})

    for f in kept:
        print(f.format())
    if not args.check and used:
        print(f"-- {len(findings) - len(kept)} baselined finding(s) "
              f"under {len(used)} justified exception(s)")
    for e in stale:
        print(f"stale baseline entry (nothing matches it — remove): "
              f"[{e['rule']}] {e['path']} :: {e['symbol']}",
              file=sys.stderr)

    failed = bool(kept) or bool(stale) or bool(errors)
    if failed:
        print(f"graftlint: {len(kept)} finding(s), {len(stale)} stale "
              f"baseline entr(y/ies), {len(errors)} error(s)",
              file=sys.stderr)
    elif not args.check:
        print(f"graftlint: clean ({len(rules)} rules"
              + (f", {len(findings)} baselined" if findings else "")
              + ")")
    # Per the contract above: 2 = broken RUN (bad paths, unparseable
    # files), 1 = findings/stale entries, 0 = clean. A CI wrapper must
    # be able to tell "the tree has a bug" from "the gate never ran".
    if errors:
        return 2
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
