"""Identity-keyed, byte-bounded LRU cache for host-built layouts (the
port's own copy of the JAX package's ``utils/idcache.py``).

The layout caches (``ops/spmm.py``'s routed layouts and prepared operators,
``ops/stochastic.py``'s training grids) key on tensor ``id()`` — cheap and
exact, but two hazards follow:

* a recycled ``id`` may alias a dead graph's entry → every entry keeps
  *strong references* to its anchor tensors and a hit re-checks them by
  ``is`` identity;
* entries hold tens of MB of device memory each → eviction is by
  *accumulated bytes* against a cap (``GNNTF_LAYOUT_CACHE_MB``, default
  2048, shared by all caches of the default budget).
"""
from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Any, Optional, Tuple

_log = logging.getLogger("gnntf_tpu_torch")


def _default_cap_bytes() -> int:
    mb = float(os.environ.get("GNNTF_LAYOUT_CACHE_MB", "2048"))
    return int(mb * 1024 * 1024)


def sizeof(obj) -> int:
    """Recursive ``nbytes`` of the tensors and arrays reachable through an
    object's dataclass fields and tuple/list/dict containers; 0 for scalars
    and None."""
    seen = set()

    def walk(o) -> int:
        if o is None or id(o) in seen:
            return 0
        seen.add(id(o))
        nbytes = getattr(o, "nbytes", None)
        if isinstance(nbytes, int):
            return nbytes
        if isinstance(o, (tuple, list)):
            return sum(walk(v) for v in o)
        if isinstance(o, dict):
            return sum(walk(v) for v in o.values())
        if hasattr(o, "__dataclass_fields__"):
            return sum(walk(getattr(o, f)) for f in o.__dataclass_fields__)
        return 0

    return walk(obj)


class Budget:
    """A byte budget shared by several caches.  Member caches register
    themselves, so an over-budget eviction can reach beyond the cache
    being written."""

    def __init__(self, cap_bytes: Optional[int] = None):
        self._cap = cap_bytes
        self.used = 0
        self.caches = []
        self._over_warned = False  # one warning per cap crossing

    @property
    def cap(self) -> int:
        return self._cap if self._cap is not None else _default_cap_bytes()

    def evict_to_cap(self, protect: "IdLRU" = None) -> None:
        """Drop least-recently-used entries from the *other* member caches
        until within cap, keeping each one's most recent entry."""
        cap = self.cap
        for cache in self.caches:
            if cache is protect:
                continue
            while self.used > cap and len(cache) > 1:
                cache._pop_oldest()

    def clear_all(self) -> None:
        for cache in self.caches:
            cache.clear()


GLOBAL_BUDGET = Budget()


class IdLRU:
    """LRU keyed on tuples that may contain tensor ``id()``s.

    ``put(key, anchors, value, nbytes=None)`` stores ``value`` with the
    tuple of tensors whose identities appear in ``key``; ``get(key,
    anchors)`` returns the value only if every anchor is the *same object*
    as at put time.  Eviction is least-recently-used by bytes against the
    shared :class:`Budget`; a cache always keeps its most recent entry."""

    def __init__(self, budget: Budget = GLOBAL_BUDGET):
        self._budget = budget
        self._data: OrderedDict = OrderedDict()
        budget.caches.append(self)

    def get(self, key, anchors: Tuple) -> Any:
        hit = self._data.get(key)
        if hit is None:
            return None
        stored_anchors, value, _ = hit
        if len(stored_anchors) != len(anchors) or any(
                a is not b for a, b in zip(stored_anchors, anchors)):
            return None
        self._data.move_to_end(key)
        return value

    def put(self, key, anchors: Tuple, value,
            nbytes: Optional[int] = None) -> None:
        nbytes = sizeof(value) if nbytes is None else nbytes
        old = self._data.pop(key, None)
        if old is not None:
            self._budget.used -= old[2]
        self._data[key] = (tuple(anchors), value, nbytes)
        self._budget.used += nbytes
        self._evict()

    def _pop_oldest(self) -> None:
        _, (_, _, nbytes) = self._data.popitem(last=False)
        self._budget.used -= nbytes

    def _evict(self) -> None:
        cap = self._budget.cap
        while self._budget.used > cap and len(self._data) > 1:
            self._pop_oldest()
        if self._budget.used > cap:
            self._budget.evict_to_cap(protect=self)
        if self._budget.used > cap:
            # the cap is soft at the floor: each cache keeps its most recent
            # entry, so the resident total may exceed it; say so once a
            # crossing
            if not self._budget._over_warned:
                self._budget._over_warned = True
                _log.warning(
                    "layout-cache budget exceeded: %.0f MB resident vs "
                    "GNNTF_LAYOUT_CACHE_MB=%.0f cap (each of %d caches keeps "
                    "its most recent entry); raise the cap or call "
                    "utils.idcache.GLOBAL_BUDGET.clear_all()",
                    self._budget.used / 1e6, cap / 1e6,
                    len(self._budget.caches))
        else:
            self._budget._over_warned = False

    def __len__(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        for _, _, nbytes in self._data.values():
            self._budget.used -= nbytes
        self._data.clear()
