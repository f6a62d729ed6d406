"""Multi-plane chaos campaigns (the port's own copy of
:mod:`pddl_tpu.chaos`).

One fault plane per test file proves each recovery path in isolation;
production failures arrive COMPOSED — a wire storm while a disk
degrades while a replica grays out while the scheduler SIGKILLs the
router. `conductor.py` turns the repo's fault planes (device
`FaultPlan` sites, `WireFaultPlan`, `StorageFaultPlan`, gray
slow-walls, hard kills, router crash+recover) into seeded randomized
campaigns against a full fleet, with an invariant referee after every
run.
"""

from pddl_tpu_torch.chaos.conductor import (CampaignReport, ChaosAction,
                                            ChaosConductor, ReplicaChaos,
                                            local_kill)

__all__ = ["CampaignReport", "ChaosAction", "ChaosConductor",
           "ReplicaChaos", "local_kill"]
