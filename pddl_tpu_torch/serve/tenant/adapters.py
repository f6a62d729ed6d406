"""Per-request LoRA adapters: registry + paged device pool, host side (the
port's own copy of :mod:`pddl_tpu.serve.tenant.adapters`, numpy only).

The S-LoRA serving model (Sheng et al., 2023), built on the discipline
the KV block pool already follows (`serve/kvcache/`):

- :class:`AdapterRegistry` — every adapter the deployment knows, HOST
  resident (numpy factors, rank zero-padded to the registry's fixed
  ``rank`` so one pool shape serves heterogeneous ranks; per-adapter
  ``scale`` pre-folded into the up factor at registration so the device
  apply is a pure two-matmul chain).
- :class:`AdapterPool` — the bookkeeping of a fixed-shape DEVICE pool
  (``[P, d, r]`` / ``[P, r, V]``, `ops/lora.py`): row 0 is the reserved
  IDENTITY row (all zeros = base model), rows are pin-on-admit
  refcounted for their whole slot residency, and a cold load under a
  full pool LRU-evicts the least recently used UNPINNED row. The engine
  owns the device tensors and the load; this class only decides WHICH
  row.

Admission economics: a cold adapter load is a host-to-device transfer
on the admission path, so the engine's ``cost_fn`` charges
``adapter_load_tokens`` extra for a non-resident adapter; a warm one
costs nothing, exactly like a cached prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from pddl_tpu_torch.ops.lora import IDENTITY_ROW


@dataclasses.dataclass(frozen=True)
class LoRAAdapter:
    """One registered adapter: rank-padded factors, scale pre-folded.

    ``a`` is ``[d, rank]``, ``b`` is ``[rank, V]`` (already multiplied
    by the adapter's scale), both float32 numpy — the exact tensors a
    pool load ships."""

    name: str
    a: np.ndarray
    b: np.ndarray

    @property
    def nbytes(self) -> int:
        return int(self.a.nbytes + self.b.nbytes)


class AdapterRegistry:
    """Host-side catalogue of every servable adapter.

    Args:
      embed_dim: the model's feature width ``d`` (validated by the
        engine against its model).
      vocab_size: the adapted head's output width ``V``.
      rank: the POOL rank ``r`` — the fixed-shape ceiling every
        registered adapter is zero-padded to (a smaller true rank pads
        with zero columns/rows, which is a mathematical no-op).
    """

    def __init__(self, embed_dim: int, vocab_size: int, rank: int = 8):
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.embed_dim = int(embed_dim)
        self.vocab_size = int(vocab_size)
        self.rank = int(rank)
        self._adapters: Dict[str, LoRAAdapter] = {}

    def register(self, name: str, a, b, *, scale: float = 1.0) -> LoRAAdapter:
        """Register factors ``a [d, r]`` / ``b [r, V]`` (``r <= rank``;
        zero-padded up). Re-registering a name replaces it — already-
        RESIDENT copies in a pool keep serving the old weights until
        reloaded (document, don't surprise: live slots pinned an
        adapter version, like a pinned prefix chain)."""
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        if a.ndim != 2 or a.shape[0] != self.embed_dim:
            raise ValueError(
                f"adapter {name!r}: a must be [{self.embed_dim}, r], "
                f"got {a.shape}")
        if b.ndim != 2 or b.shape != (a.shape[1], self.vocab_size):
            raise ValueError(
                f"adapter {name!r}: b must be [{a.shape[1]}, "
                f"{self.vocab_size}], got {b.shape}")
        r = a.shape[1]
        if r > self.rank:
            raise ValueError(
                f"adapter {name!r}: rank {r} exceeds the registry's "
                f"pool rank {self.rank}")
        pa = np.zeros((self.embed_dim, self.rank), np.float32)
        pb = np.zeros((self.rank, self.vocab_size), np.float32)
        pa[:, :r] = a
        pb[:r] = b * float(scale)
        adapter = LoRAAdapter(str(name), pa, pb)
        self._adapters[adapter.name] = adapter
        return adapter

    def register_random(self, name: str, seed: int, *,
                        scale: float = 0.05,
                        rank: Optional[int] = None) -> LoRAAdapter:
        """Deterministic random adapter from ``seed`` — the fleet's
        determinism contract (`fleet/worker.py` builds each process
        replica's registry from (name, seed) config pairs, so every
        replica and the chaos oracle hold bit-identical factors)."""
        r = int(rank) if rank is not None else self.rank
        rng = np.random.RandomState(int(seed))
        a = rng.randn(self.embed_dim, r).astype(np.float32)
        b = rng.randn(r, self.vocab_size).astype(np.float32)
        return self.register(name, a, b, scale=scale)

    def get(self, name: str) -> LoRAAdapter:
        try:
            return self._adapters[name]
        except KeyError:
            raise KeyError(
                f"adapter {name!r} is not registered "
                f"(known: {sorted(self._adapters)})") from None

    def __contains__(self, name: str) -> bool:
        return name in self._adapters

    def __len__(self) -> int:
        return len(self._adapters)

    @property
    def names(self) -> List[str]:
        return sorted(self._adapters)

    @property
    def adapter_nbytes(self) -> int:
        """Bytes ONE pool row holds (the pool-sizing unit in the
        OPERATIONS runbook)."""
        return 4 * self.rank * (self.embed_dim + self.vocab_size)


class AdapterPoolExhausted(RuntimeError):
    """Every pool row is pinned by a live slot and a cold adapter needs
    one: the admission escalates (replay-charged) exactly like a block
    pool shortfall. The runbook's sizing floor — ``pool_slots >=
    max_slots + 1`` — makes this impossible for a live mix."""


class AdapterPool:
    """Row bookkeeping of the device adapter pool (row 0 = identity).

    The engine consults :meth:`lookup` (resident?) → :meth:`assign`
    (reserve a row) → dispatches the device load → :meth:`pin`; a
    faulted load :meth:`unassign`\\ s the reservation.
    :meth:`pin`/:meth:`unpin` bracket slot residency; assignment under
    pressure LRU-evicts unpinned resident rows."""

    def __init__(self, slots: int):
        if slots < 2:
            raise ValueError(
                f"adapter pool needs >= 2 rows (row {IDENTITY_ROW} is "
                f"the reserved identity), got {slots}")
        self.slots = int(slots)
        self._row_of: Dict[str, int] = {}
        self._name_of: Dict[int, str] = {}
        self._refs = [0] * self.slots
        self._free: List[int] = list(range(1, self.slots))
        self._stamp = 0
        self._last_access = [0] * self.slots
        self.evictions = 0

    # ------------------------------------------------------------ stats
    @property
    def resident(self) -> int:
        return len(self._row_of)

    def row_of(self, name: str) -> Optional[int]:
        return self._row_of.get(name)

    # --------------------------------------------------------- assign
    def lookup(self, name: str) -> Optional[int]:
        """Resident row for ``name`` (LRU-touched), or None (cold)."""
        row = self._row_of.get(name)
        if row is not None:
            self._stamp += 1
            self._last_access[row] = self._stamp
        return row

    def assign(self, name: str) -> int:
        """Reserve a row for a cold load: a free row, else LRU-evict an
        unpinned resident one. The mapping is recorded immediately so a
        same-tick second admission of ``name`` finds it resident (the
        device load the engine dispatches right after is what makes the
        row's CONTENT real — a load fault must :meth:`unassign`)."""
        if name in self._row_of:
            raise ValueError(f"adapter {name!r} is already resident")
        if self._free:
            row = self._free.pop(0)
        else:
            victims = [r for r in range(1, self.slots)
                       if self._refs[r] == 0 and r in self._name_of]
            if not victims:
                raise AdapterPoolExhausted(
                    f"all {self.slots - 1} adapter pool rows are pinned "
                    "by live slots (size the pool >= max_slots + 1; see "
                    "docs/OPERATIONS.md 'Adapter pool sizing')")
            row = min(victims, key=lambda r: self._last_access[r])
            del self._row_of[self._name_of.pop(row)]
            self.evictions += 1
        self._row_of[name] = row
        self._name_of[row] = name
        self._stamp += 1
        self._last_access[row] = self._stamp
        return row

    def unassign(self, row: int) -> None:
        """Unwind a reservation whose device load never landed."""
        name = self._name_of.pop(row, None)
        if name is not None:
            del self._row_of[name]
        self._free.append(row)

    # ------------------------------------------------------- refcounts
    def pin(self, row: int) -> None:
        """One live slot depends on this row (identity row: no-op —
        it is structurally unevictable)."""
        if row != IDENTITY_ROW:
            self._refs[row] += 1

    def unpin(self, row: int) -> None:
        if row == IDENTITY_ROW:
            return
        if self._refs[row] <= 0:
            raise RuntimeError(
                "adapter unpin without a matching pin (refcount "
                "underflow) — an engine slot released its adapter twice")
        self._refs[row] -= 1

    def pinned_rows(self) -> List[int]:
        return [r for r in range(1, self.slots) if self._refs[r] > 0]
