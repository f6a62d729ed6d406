"""graftlint retargeted at the port: ``pddl_tpu_torch.analysis`` held
against ``pddl_tpu.analysis``.

- On every JAX fixture (``tests/fixtures/graftlint/``) the port's rules
  give the JAX rules' ``(rule, path, line, symbol)`` findings exactly.
- The forms only the port has (``tests/fixtures/graftlint_torch/``): the
  engine's site-listing census, and every module pair resolved at the
  port's paths (a seeded mismatch in ``pairs_bad/`` per pair, none in
  ``pairs_good/``).
- The tree gate: ``python -m pddl_tpu_torch.analysis --check
  pddl_tpu_torch/`` exits 0 and imports no torch, jax or ``pddl_tpu``;
  without the baseline it shows only the three port-only counters; every
  path a rule pairs exists under ``pddl_tpu_torch/``.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys

import pytest

from pddl_tpu.analysis import run_analysis as jax_run_analysis
from pddl_tpu.analysis.checkers import RULES as JAX_RULES
from pddl_tpu_torch.analysis import (
    DEFAULT_BASELINE,
    load_baseline,
    run_analysis,
)
from pddl_tpu_torch.analysis.checkers import RULES
from pddl_tpu_torch.analysis.checkers import (
    epoch_vocab,
    exposition,
    role_vocab,
    site_vocab,
    snapshot_vocab,
    trace_vocab,
)

pytestmark = pytest.mark.analysis

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "graftlint")
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "graftlint_torch")


def _keys(findings):
    return sorted((f.rule, f.path, f.line, f.symbol) for f in findings)


def _run(paths, **kw):
    findings, errors, _ = run_analysis(paths, **kw)
    assert not errors, errors
    return findings


# ------------------------------------------------ parity with the JAX rules


@pytest.mark.parametrize(
    "fixture", sorted(os.path.basename(p) for p in
                      glob.glob(os.path.join(JAX_FIXTURES, "*.py"))))
def test_port_rules_match_jax_rules_on_jax_fixture(fixture):
    path = os.path.join(JAX_FIXTURES, fixture)
    ours = _run([path])
    theirs, errors, _ = jax_run_analysis([path])
    assert not errors, errors
    assert _keys(ours) == _keys(theirs)
    # Rules of the same name, in the same order, flagging the same lines.
    assert [r.name for r in RULES] == [r.name for r in JAX_RULES]


# ------------------------------------------------------ the port's forms

# (fixture, {rule: findings}) — each bad fixture's exact findings by rule.
PORT_BAD = [
    ("site_vocab_sites_bad.py", {"site-vocab": 3}),
    ("pairs_bad", {"trace-vocab": 2, "site-vocab": 2, "role-vocab": 2,
                   "epoch-vocab": 1, "exposition-parity": 1,
                   "snapshot-hygiene": 1}),
]
PORT_GOOD = ["site_vocab_sites_good.py", "pairs_good"]


def _port_fixture(name):
    path = os.path.join(FIXTURES, name)
    if name.endswith(".py"):
        return _run([path])
    # A tree laid out at the port's paths, analyzed with itself as root
    # so every pair resolves inside it.
    return _run([os.path.join(path, "pddl_tpu_torch")], root=path)


@pytest.mark.parametrize("fixture,expected", PORT_BAD,
                         ids=[f for f, _ in PORT_BAD])
def test_port_form_bad_fixture_is_flagged(fixture, expected):
    found = _port_fixture(fixture)
    by_rule = {}
    for f in found:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    assert by_rule == expected, [f.format() for f in found]


@pytest.mark.parametrize("fixture", PORT_GOOD)
def test_port_form_good_twin_is_clean(fixture):
    found = _port_fixture(fixture)
    assert found == [], [f.format() for f in found]


def test_site_listing_census_is_compared_not_skipped():
    """The JAX rule reads only literal ``compile_counts`` keys, so on the
    port's form it reports every dispatched site as uncounted; the
    port's rule reads the listed sites and finds only the seeded ones."""
    path = os.path.join(FIXTURES, "site_vocab_sites_good.py")
    theirs, _, _ = jax_run_analysis([path])
    assert {f.rule for f in theirs} == {"site-vocab"} and len(theirs) > 0
    assert _run([path]) == []


# ------------------------------------------------------------ the tree


def _pair_paths():
    yield from (p for pair in trace_vocab.TRACE_PAIRS for p in pair)
    yield from (p for pair in epoch_vocab.WORKER_DRIVER_PAIRS for p in pair)
    yield from (p for pair in role_vocab.ROUTER_JOURNAL_PAIRS for p in pair)
    yield from (p for pair in role_vocab.ROLES_PAIRS for p in pair)
    yield from (p for pair in site_vocab.ENGINE_FAULTS_PAIRS for p in pair)
    for gate, faults, _ in site_vocab.STORAGE_FAULTS_PAIRS:
        yield from (gate, faults)
    for export, _, metrics, _ in exposition.COUNTER_KEY_BINDINGS:
        yield from (export, metrics)
    yield snapshot_vocab.BENCH_VOCAB_SUFFIX


def test_every_pair_path_exists_in_the_port():
    """A pair that matches no file is a rule that silently checks
    nothing."""
    paths = sorted(set(_pair_paths()))
    assert len(paths) == 16
    for rel in paths:
        assert rel.startswith("pddl_tpu_torch/"), rel
        assert os.path.isfile(os.path.join(REPO_ROOT, rel)), rel


def test_baseline_entries_are_justified_and_only_the_port_counters():
    entries = load_baseline(DEFAULT_BASELINE)
    assert entries and all(e["reason"].strip() for e in entries)
    found = _run([os.path.join(REPO_ROOT, "pddl_tpu_torch")])
    # Without the baseline: exactly the three port-only counters, each a
    # finding the one entry absorbs.
    assert {f.rule for f in found} == {"exposition-parity"}
    assert sorted(f.message.split()[0] for f in found) == [
        "ServeMetrics.copy_bytes_donated",
        "ServeMetrics.copy_bytes_gathered",
        "ServeMetrics.mask_restages"]
    keys = {(e["rule"], e["path"], e["symbol"]) for e in entries}
    assert {(f.rule, f.path, f.symbol) for f in found} == keys
    for name in ("copy_bytes_gathered", "copy_bytes_donated",
                 "mask_restages"):
        assert name in entries[0]["reason"]


def test_tree_is_clean_via_cli_and_imports_no_framework():
    """THE gate: the CLI over the port exits 0, and the run imports no
    torch, no jax and nothing of the JAX package."""
    code = (
        "import sys, pddl_tpu_torch.analysis.__main__ as m; "
        "rc = m.main(['--check', 'pddl_tpu_torch/']); "
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'jax', 'flax', 'pddl_tpu')); "
        "assert not bad, bad; sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_exit_codes_and_default_path(tmp_path):
    """0 clean, 1 findings, 2 a run that never really ran; no path
    means ``pddl_tpu_torch``."""
    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "pddl_tpu_torch.analysis", *args],
            cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)

    assert cli().returncode == 0
    bad = cli("--check", os.path.join(FIXTURES, "site_vocab_sites_bad.py"))
    assert bad.returncode == 1 and "site-vocab" in bad.stdout
    assert cli("--check", "no_such_dir_xyz/").returncode == 2
    listed = cli("--list-rules")
    assert listed.returncode == 0
    assert all(cls.name in listed.stdout for cls in RULES)
