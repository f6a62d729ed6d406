"""Good twin: the storage-fault vocabulary."""


class StorageFaultPlan:
    SITES = ("open", "write")
