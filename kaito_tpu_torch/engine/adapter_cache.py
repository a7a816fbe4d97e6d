"""Bounded two-tier LoRA adapter cache (the JAX package's
``docs/multi-lora.md``).

Counterpart of ``kaito_tpu.engine.adapter_cache``:

- **Device slot table**: the stacked per-target lanes the layer loop
  reads (``model.TransformerLM.lora``: ``{group: {f"{t}_a": [L, S+1, in,
  rmax], f"{t}_b": [L, S+1, rmax, out]}}``, lane 0 the base's zeros),
  allocated once at a FIXED capacity of ``slots`` adapters at rank
  ``rmax``.  Loading, evicting or faulting an adapter copies its padded,
  scaling-folded factors into a lane in place (``copy_``, in the
  engine's stream order), so every buffer keeps its address: a captured
  decode or verify graph is never captured again across a load, an
  eviction, a fault or a delete.  A tensor-parallel model holds each
  shard's split of every lane (``model.lora_shard``).
- **Host tier**: a byte-budgeted LRU of evicted adapters' factors; an
  adapter squeezed out of the table faults back in on its next request.

A lane referenced by in-flight work is pinned: the engine supplies
``busy_fn`` and the cache never evicts or overwrites a busy adapter.

One difference from the JAX cache: an installed adapter keeps its raw
factors (as given, unpadded and unscaled) on the host beside its lane,
and an eviction demotes those instead of reading the lane back and
dividing by the scaling.  The host tier then holds exactly what was
installed, in every dtype, and an eviction reads nothing back from the
device.  (The JAX cache's read-back round trip moved no bit at a scaling
of 1.5 in bf16 or fp32 on the port's tests, so both write the same
lanes on a fault.)

The engine runs every call that writes lanes on its own thread, between
steps (``InferenceEngine._on_engine_thread``), so an HTTP thread's load
never races a window in flight.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Callable, Optional

import numpy as np
import torch

from kaito_tpu_torch.tuning.lora import load_adapter

logger = logging.getLogger(__name__)

# load-refusal reasons (the label values of
# kaito:adapter_load_failures_total)
REASON_BASE_MISMATCH = "base_mismatch"
REASON_RANK_OVERFLOW = "rank_overflow"
REASON_UNREADABLE = "unreadable"
REASON_NO_TARGETS = "no_targets"
REASON_CAPACITY = "capacity"


class AdapterLoadError(ValueError):
    """A load the cache refused; ``reason`` is the counter label."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class AdapterBusyError(RuntimeError):
    """Eviction/overwrite refused: in-flight requests pin the slot."""


class HostAdapterEntry:
    __slots__ = ("factors", "r", "scaling", "base", "nbytes")

    def __init__(self, factors: dict, r: int, scaling: float, base: str,
                 nbytes: int):
        self.factors = factors
        self.r = r
        self.scaling = scaling
        self.base = base
        self.nbytes = nbytes


class HostAdapterTier:
    """Byte-budgeted LRU of evicted adapters' host factors, keyed by
    adapter name: a same-key put replaces, an entry over the budget is
    refused, eviction pops the least recently used."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self.used_bytes = 0
        self._entries: "collections.OrderedDict[str, HostAdapterEntry]" = \
            collections.OrderedDict()
        self.hits = 0          # pop() found the adapter (fault-back-in)
        self.misses = 0        # pop() came up empty
        self.evicted_entries = 0

    def __len__(self) -> int:
        return len(self._entries)

    def names(self) -> list[str]:
        return list(self._entries)

    def put(self, name: str, entry: HostAdapterEntry) -> bool:
        self.discard(name)
        if entry.nbytes > self.max_bytes:
            return False
        while self.used_bytes + entry.nbytes > self.max_bytes and self._entries:
            _, old = self._entries.popitem(last=False)
            self.used_bytes -= old.nbytes
            self.evicted_entries += 1
        self._entries[name] = entry
        self.used_bytes += entry.nbytes
        return True

    def pop(self, name: str) -> Optional[HostAdapterEntry]:
        entry = self._entries.pop(name, None)
        if entry is not None:
            self.used_bytes -= entry.nbytes
            self.hits += 1
        else:
            self.misses += 1
        return entry

    def has(self, name: str) -> bool:
        return name in self._entries

    def discard(self, name: str) -> None:
        entry = self._entries.pop(name, None)
        if entry is not None:
            self.used_bytes -= entry.nbytes


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


class AdapterCache:
    """Fixed-capacity device slot table + host-RAM overflow tier over a
    model's lanes (:meth:`model.TransformerLM.alloc_lora`)."""

    def __init__(self, model, *, slots: int, rmax: int, base_model: str = "",
                 host_bytes: int = 0, allow_base_mismatch: bool = False):
        if slots < 1:
            raise ValueError("adapter cache needs at least one slot")
        if rmax < 1:
            raise ValueError("adapter rmax must be positive")
        if model.is_mla:
            raise ValueError("per-request adapters are not supported on MLA models")
        self.slots = slots
        self.rmax = rmax
        self.base_model = base_model
        self.allow_base_mismatch = allow_base_mismatch
        self._model = model
        self._lock = threading.RLock()
        # engine hook: True while in-flight work references the adapter
        self.busy_fn: Callable[[str], bool] = lambda name: False
        # name -> slot (1-based; 0 is the base lane), mutated in place:
        # the engine's adapter_index is this dict
        self.name_to_slot: dict[str, int] = {}
        self._slot_names: list[str] = [""] * (slots + 1)
        self._lru: "collections.OrderedDict[str, None]" = collections.OrderedDict()
        self._meta: dict[str, dict] = {}
        self.host = HostAdapterTier(host_bytes) if host_bytes > 0 else None
        self.loads_total = 0
        self.evictions_total = 0
        self.hits_total = 0
        self.faults_total = 0
        self.load_failures: dict[str, int] = {}
        self._specs = {g: s for g, s in model.lora_specs().items() if s}
        if not self._specs:
            raise ValueError("model exposes no per-request-servable LoRA targets")
        model.alloc_lora(slots + 1, rmax)
        self._layers = {g.name: g.count for g in model.groups}
        nbytes = sum(n * (i * rmax + rmax * o) for g, n in self._layers.items()
                     for i, o in self._specs.get(g, {}).values()) * (slots + 1) \
            * torch.empty((), dtype=model.dtype).element_size()
        self.table_bytes = nbytes
        logger.info("adapter cache: %d device slots (rmax=%d, %.1f MiB)%s", slots,
                    rmax, nbytes / 2**20, "" if self.host is None else
                    f" + {host_bytes / 2**20:.0f} MiB host tier")

    @property
    def serve_lora(self):
        """The model's lanes (a list of per-shard dicts under tensor
        parallelism)."""
        return self._model.lora

    # -- residency ---------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self.name_to_slot)

    def resident(self) -> list[str]:
        with self._lock:
            return list(self.name_to_slot)

    def has(self, name: str) -> bool:
        with self._lock:
            return (name in self.name_to_slot
                    or (self.host is not None and self.host.has(name)))

    def ensure(self, name: str) -> int:
        """Slot of ``name``, faulting it back from the host tier when the
        table evicted it.  KeyError when the cache holds no trace of it."""
        with self._lock:
            slot = self.name_to_slot.get(name)
            if slot is not None:
                self._lru.move_to_end(name)
                self.hits_total += 1
                return slot
            entry = self.host.pop(name) if self.host is not None else None
            if entry is None:
                raise KeyError(name)
            slot = self._install_locked(name, entry.factors, r=entry.r,
                                        scaling=entry.scaling, base=entry.base)
            self.faults_total += 1
            return slot

    # -- loading -----------------------------------------------------------

    def _refuse(self, reason: str, message: str) -> AdapterLoadError:
        self.load_failures[reason] = self.load_failures.get(reason, 0) + 1
        logger.warning("adapter load refused (%s): %s", reason, message)
        return AdapterLoadError(reason, message)

    def read(self, name: str, path: str) -> tuple:
        """Read an artifact directory (no device work): (factors, r,
        scaling, base).  An unreadable one is refused and counted."""
        try:
            adapter, cfg, base = load_adapter(path)
        except Exception as e:
            with self._lock:
                raise self._refuse(REASON_UNREADABLE,
                                   f"adapter {name!r} at {path}: {e}") from None
        return adapter, cfg.r, cfg.scaling, base

    def load_from_path(self, name: str, path: str) -> int:
        """Load a kaito-tpu-lora-v1 artifact directory into a slot."""
        adapter, r, scaling, base = self.read(name, path)
        return self.install(name, adapter, r=r, scaling=scaling, base=base)

    def install(self, name: str, factors: dict, *, r: int, scaling: float,
                base: str = "") -> int:
        """Install raw factors (flat ``{group}/{t}_lora_a`` keys or the
        nested tree) into a slot; returns it.  Refusals raise
        :class:`AdapterLoadError` with a counted reason, a table pinned
        full with reason "capacity"."""
        with self._lock:
            if (base and self.base_model and base != self.base_model
                    and not self.allow_base_mismatch):
                raise self._refuse(
                    REASON_BASE_MISMATCH,
                    f"adapter {name!r} targets base {base!r}, serving "
                    f"{self.base_model!r} (pass --adapter-allow-base-mismatch "
                    f"to serve it anyway)")
            if r > self.rmax:
                raise self._refuse(
                    REASON_RANK_OVERFLOW,
                    f"adapter {name!r} rank {r} exceeds the slot table's rmax "
                    f"{self.rmax} (restart with a larger --adapter-rmax)")
            flat = _flatten_factors(factors)
            if not any(f"{g}/{t}_lora_a" in flat
                       for g, spec in self._specs.items() for t in spec):
                raise self._refuse(
                    REASON_NO_TARGETS,
                    f"adapter {name!r} carries no per-request-servable targets")
            return self._install_locked(name, flat, r=r, scaling=scaling, base=base)

    def _install_locked(self, name: str, factors: dict, *, r: int, scaling: float,
                        base: str) -> int:
        flat = _flatten_factors(factors)
        slot = self.name_to_slot.get(name)
        if slot is not None and self.busy_fn(name):
            raise AdapterBusyError(f"adapter {name!r} is serving in-flight requests")
        if slot is None:
            slot = self._free_slot_locked()
        self._write_slot(slot, flat, scaling)
        prev = self._slot_names[slot]
        if prev and prev != name:
            self.name_to_slot.pop(prev, None)
            self._lru.pop(prev, None)
        self._slot_names[slot] = name
        self.name_to_slot[name] = slot
        self._lru[name] = None
        self._lru.move_to_end(name)
        self._meta[name] = {"r": r, "scaling": scaling, "base": base, "factors": flat,
                            "nbytes": sum(_nbytes(a) for a in flat.values())}
        self.loads_total += 1
        logger.info("adapter %s -> slot %d (r=%d)", name, slot, r)
        return slot

    def _free_slot_locked(self) -> int:
        if len(self.name_to_slot) < self.slots:
            used = set(self.name_to_slot.values())
            for s in range(1, self.slots + 1):
                if s not in used:
                    return s
        for victim in self._lru:
            if not self.busy_fn(victim):
                return self._evict_locked(victim)
        raise self._refuse(REASON_CAPACITY,
                           f"all {self.slots} adapter slots pinned by in-flight "
                           f"requests")

    def _evict_locked(self, name: str) -> int:
        """Free ``name``'s slot (its lane is overwritten by the next
        install) and demote its factors to the host tier."""
        slot = self.name_to_slot.pop(name)
        self._lru.pop(name, None)
        meta = self._meta.pop(name, {})
        self._slot_names[slot] = ""
        self.evictions_total += 1
        if self.host is not None:
            self.host.put(name, HostAdapterEntry(
                factors=meta.get("factors", {}), r=int(meta.get("r", self.rmax)),
                scaling=float(meta.get("scaling", 1.0)),
                base=str(meta.get("base", "")), nbytes=int(meta.get("nbytes", 0)) or 1))
        logger.info("adapter %s evicted from slot %d%s", name, slot,
                    "" if self.host is None else " (host tier)")
        return slot

    def _write_slot(self, slot: int, flat: dict, scaling: float) -> None:
        """Copy the padded factors into lane ``slot`` of every target (B
        times ``scaling``, in fp32, then cast to the model dtype); a
        target the adapter lacks is zeroed, so a reused lane never leaks
        its previous occupant's deltas."""
        dtype = self._model.dtype
        for g, spec in self._specs.items():
            L = self._layers[g]
            for t, (in_dim, out_dim) in spec.items():
                pa = np.zeros((L, in_dim, self.rmax), np.float32)
                pb = np.zeros((L, self.rmax, out_dim), np.float32)
                a, b = flat.get(f"{g}/{t}_lora_a"), flat.get(f"{g}/{t}_lora_b")
                if a is not None and b is not None:
                    a, b = _f32(a), _f32(b)              # [L, in, r], [L, r, out]
                    pa[:, :, :a.shape[-1]] = a
                    pb[:, :b.shape[1], :] = b * scaling
                self._model.write_lora_lane(slot, g, t, torch.from_numpy(pa).to(dtype),
                                            torch.from_numpy(pb).to(dtype))

    # -- removal -----------------------------------------------------------

    def remove(self, name: str) -> bool:
        """Drop an adapter from both tiers (DELETE /v1/adapters; no
        fault-back-in afterwards).  False when the cache holds no trace
        of it; AdapterBusyError while in-flight requests pin it."""
        with self._lock:
            dropped = False
            if name in self.name_to_slot:
                if self.busy_fn(name):
                    raise AdapterBusyError(
                        f"adapter {name!r} is serving in-flight requests")
                slot = self.name_to_slot.pop(name)
                self._lru.pop(name, None)
                self._meta.pop(name, None)
                self._slot_names[slot] = ""
                self._write_slot(slot, {}, 1.0)
                self.evictions_total += 1
                dropped = True
            if self.host is not None and self.host.has(name):
                self.host.discard(name)
                dropped = True
            return dropped

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        """The ``GET /v1/adapters`` payload."""
        with self._lock:
            resident = [{"name": n, "slot": s,
                         "r": int(self._meta.get(n, {}).get("r", 0)),
                         "base": str(self._meta.get(n, {}).get("base", ""))}
                        for n, s in sorted(self.name_to_slot.items(),
                                           key=lambda kv: kv[1])]
            return {
                "enabled": True,
                "slots": self.slots,
                "rmax": self.rmax,
                "resident": resident,
                "host_tier": (sorted(self.host.names())
                              if self.host is not None else []),
                "loads_total": self.loads_total,
                "evictions_total": self.evictions_total,
                "hits_total": self.hits_total,
                "faults_total": self.faults_total,
                "load_failures": dict(self.load_failures),
            }


def _flatten_factors(factors: dict) -> dict:
    """The flat ``{group}/{t}_lora_a`` layout of either form."""
    if factors and all(isinstance(v, dict) for v in factors.values()):
        return {f"{g}/{k}": v for g, stack in factors.items() for k, v in stack.items()}
    return dict(factors)
