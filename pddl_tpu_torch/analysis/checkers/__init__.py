"""The graftlint rule registry — one module per invariant.

Each checker file's docstring names the invariant it encodes and the
failure that motivated it; ``docs/ANALYSIS.md`` is the catalogue.
Adding a checker: subclass
:class:`pddl_tpu_torch.analysis.core.Rule`, set ``name``/``doc``, implement
``run(project)``, append the class here, and give it a seeded-bad
fixture + good twin under ``tests/fixtures/graftlint/`` (or
``tests/fixtures/graftlint_torch/`` for a form only the port has).
"""

from __future__ import annotations

from pddl_tpu_torch.analysis.checkers.donation import DonationRule
from pddl_tpu_torch.analysis.checkers.epoch_vocab import EpochVocabRule
from pddl_tpu_torch.analysis.checkers.exposition import ExpositionParityRule
from pddl_tpu_torch.analysis.checkers.pin_release import PinReleaseRule
from pddl_tpu_torch.analysis.checkers.recompile import RecompileHazardRule
from pddl_tpu_torch.analysis.checkers.role_vocab import RoleVocabRule
from pddl_tpu_torch.analysis.checkers.site_vocab import SiteVocabRule
from pddl_tpu_torch.analysis.checkers.snapshot_vocab import SnapshotHygieneRule
from pddl_tpu_torch.analysis.checkers.trace_vocab import TraceVocabRule

RULES = (
    PinReleaseRule,
    DonationRule,
    RecompileHazardRule,
    SiteVocabRule,
    ExpositionParityRule,
    SnapshotHygieneRule,
    RoleVocabRule,
    TraceVocabRule,
    EpochVocabRule,
)

__all__ = ["RULES"] + [cls.__name__ for cls in RULES]
