"""Rule ``snapshot-hygiene``: wire-format keys may only change with a
version bump, and bench-artifact headline keys must have a direction
in the ``bench_artifact`` vocabulary.

**(a) versioned wire manifests.** ``serve/drain.py`` owns the serving
snapshot wire format; priorities, block tables and adapters/constraints
each changed the entry shape WITH a version bump plus
forward/backward-compat pins. The failure mode this rule closes:
a key added or renamed without the bump — every restoring engine
happily reads the versioned header, then mis-decodes the entries.
Mechanism: the module must carry a literal manifest named
``ENTRY_KEYS_V{SNAPSHOT_VERSION}`` matching the keys its encode
functions actually emit (dict-literal keys plus ``entry["k"] = ...``
stores in ``encode*``-named functions). Changing the encoder without
updating the manifest fails; updating the manifest forces its name —
and therefore ``SNAPSHOT_VERSION`` — into the diff. The SAME
discipline covers the control-plane WAL:
``serve/fleet/journal.py`` carries ``RECORD_KEYS_V{JOURNAL_VERSION}``
pinned against its record encoders — a record-shape change without a
``JOURNAL_VERSION`` bump fails the tree, because a recovering router
mis-decoding its own log is the quietest way to lose requests.

**(b) bench-artifact direction vocabulary.** The perf gate
(``utils/bench_artifact.compare``) only guards keys it can assign a
direction; a headline metric whose name matches no vocabulary rule
silently exits the gate (the "quietest regression" of vanished
leaves — this is the same hole for NEW leaves). Every committed artifact leaf that is headline-shaped (ends
in ``_x``, or a ``*tok_s``/``*tokens_per_s`` rate) must get a nonzero
direction from the vocabulary parsed out of ``bench_artifact.py``
(``_HIGHER_BETTER``/``_LOWER_BETTER``/``_NEVER`` — AST-extracted, no
import).
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from pddl_tpu_torch.analysis.core import (
    Module,
    Project,
    Rule,
    const_str_tuple,
    string_keys,
)

BENCH_VOCAB_SUFFIX = "pddl_tpu_torch/utils/bench_artifact.py"
_HEADLINE_RE = re.compile(r"(_x$|tok_s$|tokens_per_s$)")

# The versioned-manifest families this rule enforces: (version
# constant, manifest prefix). serve/drain.py carries SNAPSHOT_VERSION
# + ENTRY_KEYS_V<n>; serve/fleet/journal.py carries JOURNAL_VERSION +
# RECORD_KEYS_V<n> — one mechanism, two wire formats.
_MANIFEST_FAMILIES = (
    ("SNAPSHOT_VERSION", "ENTRY_KEYS_V"),
    ("JOURNAL_VERSION", "RECORD_KEYS_V"),
)


class SnapshotHygieneRule(Rule):
    name = "snapshot-hygiene"
    doc = ("snapshot/journal wire keys change only with a version "
           "bump; artifact headline keys need a gate direction")

    def __init__(self, artifacts_root: Optional[str] = None):
        # Injectable for tests; default: the repo's committed series.
        self._artifacts_root = artifacts_root

    def run(self, project: Project) -> Iterable:
        for module in project.modules:
            for version_name, prefix in _MANIFEST_FAMILIES:
                yield from self._check_manifest(module, version_name,
                                                prefix)
        yield from self._check_artifacts(project)

    # ----------------------------------------------- entry manifests
    def _check_manifest(self, module: Module, version_name: str,
                        prefix: str) -> Iterable:
        manifest_re = re.compile("^" + re.escape(prefix) + r"(\d+)$")
        version: Optional[Tuple[int, int]] = None    # (value, line)
        manifests: List[Tuple[int, List[str], int]] = []  # (v, keys, line)
        for node in module.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                if not isinstance(target, ast.Name):
                    continue
                if target.id == version_name \
                        and isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, int):
                    version = (node.value.value, node.lineno)
                m = manifest_re.match(target.id)
                if m:
                    keys = const_str_tuple(node.value)
                    if keys is not None:
                        manifests.append((int(m.group(1)), keys,
                                          node.lineno))
        if version is None:
            return
        vnum, vline = version
        current = [m for m in manifests if m[0] == vnum]
        if not current:
            yield self.finding(
                module, vline,
                f"{version_name} is {vnum} but no {prefix}{vnum} "
                "manifest exists — the wire format is unreviewable; "
                "declare the key manifest next to the version")
            return
        _, declared, mline = current[0]
        # A helper named encode_<key> for a DECLARED entry key is a
        # nested sub-encoder (its dict keys live under that entry key,
        # e.g. encode_sampling/encode_spec) — only the entry-level
        # encoders define the wire manifest.
        sub_encoders = {f"encode_{k}" for k in declared}
        encoded = self._encoded_keys(module.tree, sub_encoders)
        if encoded is None:
            return
        actual = set(encoded)
        if set(declared) != actual:
            added = sorted(actual - set(declared))
            removed = sorted(set(declared) - actual)
            detail = []
            if added:
                detail.append(f"encoder emits undeclared {added}")
            if removed:
                detail.append(f"manifest declares unemitted {removed}")
            yield self.finding(
                module, mline,
                f"wire keys changed without a {version_name} bump: "
                f"{'; '.join(detail)} — bump the version, rename the "
                f"manifest to {prefix}{vnum + 1}, and extend the "
                "compat pins")

    @staticmethod
    def _encoded_keys(tree: ast.AST,
                      sub_encoders: Set[str]) -> Optional[Set[str]]:
        """Keys the encode path emits: dict-literal keys in functions
        named ``*encode*`` plus ``entry["k"] = ...`` stores there.
        ``sub_encoders`` (``encode_<declared key>`` helpers) are
        skipped — their dicts nest under an entry key."""
        keys: Set[str] = set()
        found = False
        for node in ast.walk(tree):
            if not (isinstance(node, ast.FunctionDef)
                    and "encode" in node.name
                    and node.name not in sub_encoders):
                continue
            found = True
            for sub in ast.walk(node):
                if isinstance(sub, ast.Dict):
                    for k, _ in string_keys(sub):
                        keys.add(k)
                elif isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if isinstance(t, ast.Subscript) \
                                and isinstance(t.slice, ast.Constant) \
                                and isinstance(t.slice.value, str):
                            keys.add(t.slice.value)
        return keys if found else None

    # --------------------------------------------- artifact headlines
    def _check_artifacts(self, project: Project) -> Iterable:
        vocab_mod = project.module_by_suffix(BENCH_VOCAB_SUFFIX)
        if vocab_mod is None:
            return
        vocab = self._direction_vocab(vocab_mod.tree)
        if vocab is None:
            return
        higher, lower, never = vocab
        root = self._artifacts_root
        if root is None:
            root = os.path.join(project.root, "artifacts")
        if not os.path.isdir(root):
            return
        flagged: Set[str] = set()
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for name in sorted(filenames):
                if not name.endswith(".json"):
                    continue
                path = os.path.join(dirpath, name)
                try:
                    with open(path, encoding="utf-8") as f:
                        record = json.load(f)
                except (OSError, ValueError):
                    continue
                rel = os.path.relpath(path, project.root) \
                    if path.startswith(project.root) else path
                for key in self._leaf_keys(record):
                    if not _HEADLINE_RE.search(key):
                        continue
                    # None = a _NEVER match, a deliberate ruling ("not
                    # a headline") — only direction 0 is a vocab GAP.
                    if self._direction(key, higher, lower,
                                       never) != 0:
                        continue
                    if key in flagged:
                        continue
                    flagged.add(key)
                    yield Finding_for_artifact(self, vocab_mod, rel, key)

    @staticmethod
    def _direction_vocab(tree: ast.AST):
        found: Dict[str, List[str]] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id in (
                        "_HIGHER_BETTER", "_LOWER_BETTER", "_NEVER"):
                    vals = const_str_tuple(node.value)
                    if vals is not None:
                        found[target.id] = vals
        if set(found) != {"_HIGHER_BETTER", "_LOWER_BETTER", "_NEVER"}:
            return None
        return (found["_HIGHER_BETTER"], found["_LOWER_BETTER"],
                found["_NEVER"])

    @staticmethod
    def _direction(key: str, higher, lower, never) -> Optional[int]:
        """Mirror of bench_artifact.metric_direction over the
        AST-extracted vocabulary, except a _NEVER match returns None
        (an explicit ruling) rather than 0 (no ruling at all)."""
        k = key.lower()
        if any(m in k for m in never):
            return None
        for m in higher:
            if m in k:
                return 1
        for m in lower:
            if m in k:
                return -1
        return 0

    def _leaf_keys(self, record) -> Iterable[str]:
        if isinstance(record, dict):
            for k, v in record.items():
                if isinstance(v, (dict, list)):
                    yield from self._leaf_keys(v)
                elif isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    yield str(k)
        elif isinstance(record, list):
            for item in record:
                yield from self._leaf_keys(item)


def Finding_for_artifact(rule: SnapshotHygieneRule, vocab_mod: Module,
                         artifact_rel: str, key: str):
    return rule.finding(
        vocab_mod, 1,
        f"artifact {artifact_rel} headline key {key!r} gets no "
        "direction from the bench_artifact vocabulary — the perf gate "
        "silently skips it; extend _HIGHER_BETTER/_LOWER_BETTER (or "
        "_NEVER it with cause)")
