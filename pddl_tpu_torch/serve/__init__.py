"""Online serving (the port of :mod:`pddl_tpu.serve`): ``engine.py`` the
step loop (resident rows or a paged pool, speculation, tenancy, fault
recovery, preemption, the host KV tier, sliced prefill, drain/restore,
tracing), ``scheduler.py`` the admission policy, ``request.py`` the
per-request lifecycle, ``metrics.py`` the telemetry, ``faults.py`` seeded
fault injection, ``drain.py`` the drain snapshot (the JAX package's v5
wire format), ``kvcache/`` the prefix cache (block pool, radix index,
host tier) and ``tenant/`` the multi-tenant layer."""

from pddl_tpu_torch.serve.drain import (
    SNAPSHOT_VERSION,
    load_snapshot,
    save_snapshot,
)
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.serve.faults import (
    FaultKind,
    FaultPlan,
    FaultSpec,
    InjectedResourceExhausted,
    InjectedTransientError,
    KillPoint,
)
from pddl_tpu_torch.serve.kvcache import (
    HostTierCache,
    HostTierConfig,
    RadixPrefixCache,
)
from pddl_tpu_torch.serve.metrics import ServeMetrics
from pddl_tpu_torch.serve.request import (
    AdmissionRejected,
    FinishReason,
    Priority,
    QueueFull,
    Request,
    RequestHandle,
    RequestState,
    SamplingParams,
)
from pddl_tpu_torch.serve.scheduler import FCFSScheduler, SLOScheduler
from pddl_tpu_torch.serve.tenant import AdapterRegistry, TenantConfig

__all__ = [
    "AdapterRegistry",
    "AdmissionRejected",
    "FCFSScheduler",
    "FaultKind",
    "FaultPlan",
    "FaultSpec",
    "FinishReason",
    "HostTierCache",
    "HostTierConfig",
    "InjectedResourceExhausted",
    "InjectedTransientError",
    "KillPoint",
    "Priority",
    "QueueFull",
    "RadixPrefixCache",
    "Request",
    "RequestHandle",
    "RequestState",
    "SLOScheduler",
    "SNAPSHOT_VERSION",
    "SamplingParams",
    "ServeEngine",
    "ServeMetrics",
    "TenantConfig",
    "load_snapshot",
    "save_snapshot",
]
