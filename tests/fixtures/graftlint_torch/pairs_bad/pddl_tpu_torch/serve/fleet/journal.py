"""Bad twin: the journal's route labels and storage
gates, paired with the router and ``utils/faults.py`` by path."""

VIA_LABELS = ("affinity", "least_loaded")
STORAGE_OPS = ("open", "write")


def _storage_op(op):
    return op


def append(record):
    _storage_op("open")
    _storage_op("write")
    return record
