"""Bad twin: the engine's fault-site vocabulary."""


class FaultPlan:
    SITES = ("tick",)
