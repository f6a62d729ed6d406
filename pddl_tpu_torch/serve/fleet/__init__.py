"""Multi-replica serving fleet (the port's own copy of
:mod:`pddl_tpu.serve.fleet`): health-checked router, replica failover,
live request migration, elastic autoscaling, router high availability.

`router.py` is the front door (prefix-affinity + sticky-session +
rendezvous routing, QueueFull shedding, failover with `serve/drain.py`
as the migration wire format, runtime `scale_up`/`scale_down`
mechanics), `replica.py` the driver surface (:class:`LocalReplica`
in-process for deterministic tier-1 chaos, :class:`ProcessReplica` over
a stdio pipe for real multiprocess parallelism — with the typed
:class:`ReplicaSpawnTimeout` + non-blocking ``poll_ready`` the
autoscaler's concurrent warm-starts ride on), `worker.py` the replica
process entrypoint, `health.py` the per-replica circuit breaker,
`admission.py` the overload front door (per-priority token buckets,
overload detector, hysteretic brownout ladder), `autoscaler.py` the
pressure-driven capacity controller that closes the loop (scale-up
ahead of the brownout ladder, scale-down by zero-loss live migration),
`tracegen.py` the seeded scenario-diversity trace generator (diurnal
curve, heavy-tail session mix, tenant popularity skew), and `replay.py`
the hint-honoring open-loop replay client that meters
goodput-per-replica-hour, `journal.py` the control-plane WAL that
makes the ROUTER itself crash-recoverable (``FleetRouter.recover``),
and `transport.py` the CRC-framed, sequence-checked, fault-injectable
pipe protocol between :class:`ProcessReplica` and `worker.py`, and
`disagg.py` the disaggregated prefill/decode layer: replica
ROLES, the prefill->decode KV hand-off executor, and the per-role
autoscaler multiplexer, and `standby.py` the hot standby that takes
the fleet over from a crashed router through the shared journal. The
JAX package's `docs/OPERATIONS.md` runbooks apply as written.
"""

from pddl_tpu_torch.serve.fleet.admission import (
    AdmissionControl,
    BrownoutController,
    BrownoutRung,
    OverloadDetector,
    TokenBucket,
)
from pddl_tpu_torch.serve.fleet.autoscaler import (
    AutoscaleMetrics,
    FleetAutoscaler,
    ScaleDecision,
)
from pddl_tpu_torch.serve.fleet.disagg import (
    ROLES,
    HandoffManager,
    RoleAutoscaler,
    validate_role,
)
from pddl_tpu_torch.serve.fleet.health import (
    BreakerState,
    CircuitBreaker,
    GrayDetector,
)
from pddl_tpu_torch.serve.fleet.journal import RouterJournal
from pddl_tpu_torch.serve.fleet.replay import ReplayReport, replay_trace
from pddl_tpu_torch.serve.fleet.replica import (
    EpochFenced,
    LocalReplica,
    ProcessReplica,
    ReplicaDied,
    ReplicaSpawnTimeout,
)
from pddl_tpu_torch.serve.fleet.router import (
    FleetHandle,
    FleetMetrics,
    FleetRouter,
    NoHealthyReplica,
    ReplicaLifecycle,
)
from pddl_tpu_torch.serve.fleet.standby import (
    HotStandby,
    Lease,
    LeaseHeld,
    LeaseKeeper,
    WalShipper,
    WalTail,
)
from pddl_tpu_torch.serve.fleet.tracegen import diurnal_trace
from pddl_tpu_torch.serve.fleet.transport import (
    FrameReceiver,
    FrameSender,
    WireFaultKind,
    WireFaultPlan,
    WireFaultSpec,
)

__all__ = [
    "AdmissionControl",
    "AutoscaleMetrics",
    "BreakerState",
    "BrownoutController",
    "BrownoutRung",
    "CircuitBreaker",
    "EpochFenced",
    "FleetAutoscaler",
    "FleetHandle",
    "FleetMetrics",
    "FleetRouter",
    "FrameReceiver",
    "FrameSender",
    "GrayDetector",
    "HandoffManager",
    "HotStandby",
    "Lease",
    "LeaseHeld",
    "LeaseKeeper",
    "LocalReplica",
    "NoHealthyReplica",
    "OverloadDetector",
    "ProcessReplica",
    "ROLES",
    "ReplayReport",
    "ReplicaDied",
    "ReplicaLifecycle",
    "ReplicaSpawnTimeout",
    "RoleAutoscaler",
    "RouterJournal",
    "ScaleDecision",
    "TokenBucket",
    "WalShipper",
    "WalTail",
    "WireFaultKind",
    "WireFaultPlan",
    "WireFaultSpec",
    "diurnal_trace",
    "replay_trace",
    "validate_role",
]
