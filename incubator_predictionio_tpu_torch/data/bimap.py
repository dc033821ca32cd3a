"""Serializable bidirectional map; contiguous string↔int vocabularies.

Copy of ``incubator_predictionio_tpu/data/bimap.py``.

Parity target: reference BiMap.scala:28-167 — every template uses
``BiMap.stringInt/stringLong`` to map user/item ids to contiguous indices. The
reference builds these from RDDs with ``zipWithUniqueId``; here we build from
any iterable (the event pipeline hands us numpy arrays or lists), and the
contiguous-index guarantee is strict (0..n-1) because the indices feed directly
into embedding-table rows on device.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator, Mapping
from typing import Generic, TypeVar

import numpy as np

K = TypeVar("K")
V = TypeVar("V")


class BiMap(Generic[K, V]):
    """Immutable bidirectional map (reference BiMap.scala:28)."""

    __slots__ = ("_fwd", "_rev", "_inv")

    def __init__(self, forward: Mapping[K, V]):
        fwd = dict(forward)
        rev = {v: k for k, v in fwd.items()}
        if len(rev) != len(fwd):
            raise ValueError("BiMap values must be unique")
        self._fwd = fwd
        self._rev = rev
        self._inv = None

    # -- forward access ---------------------------------------------------
    def __getitem__(self, key: K) -> V:
        return self._fwd[key]

    def get(self, key: K, default=None):
        return self._fwd.get(key, default)

    def __contains__(self, key: K) -> bool:
        return key in self._fwd

    def __len__(self) -> int:
        return len(self._fwd)

    def __iter__(self) -> Iterator[K]:
        return iter(self._fwd)

    def keys(self):
        return self._fwd.keys()

    def values(self):
        return self._fwd.values()

    def items(self):
        return self._fwd.items()

    def to_dict(self) -> dict:
        return dict(self._fwd)

    # -- inverse (BiMap.scala:44) ----------------------------------------
    def inverse(self) -> "BiMap[V, K]":
        """The reversed view, memoized on the instance — every predict path
        asks for it per query, and the map is immutable, so one wrapper pair
        serves the process lifetime (the two views share the same dicts and
        point at each other)."""
        if self._inv is None:
            inv = BiMap.__new__(BiMap)
            inv._fwd = self._rev
            inv._rev = self._fwd
            inv._inv = self
            self._inv = inv
        return self._inv

    # -- pickling (MODELDATA blobs) ---------------------------------------
    # the memoized inverse never serializes (it is derived, and pickling it
    # would drag a second wrapper into every model blob); blobs written
    # before the memo slot existed restore cleanly too
    def __getstate__(self):
        return {"_fwd": self._fwd, "_rev": self._rev}

    def __setstate__(self, state) -> None:
        if isinstance(state, tuple):  # (None, slots_dict) pre-memo format
            state = state[1]
        self._fwd = state["_fwd"]
        self._rev = state["_rev"]
        self._inv = None

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BiMap) and self._fwd == other._fwd

    def __hash__(self) -> int:
        return hash(frozenset(self._fwd.items()))

    def __repr__(self) -> str:  # pragma: no cover
        return f"BiMap({self._fwd!r})"

    # -- constructors (BiMap.scala:90-120) --------------------------------
    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Contiguous 0..n-1 index map over distinct keys, in first-seen order.

        (The reference's ``stringInt``/``stringLong`` use ``zipWithUniqueId``
        which is *not* contiguous across partitions; we tighten the contract to
        contiguous because indices address embedding rows.)
        """
        seen: dict[str, int] = {}
        for k in keys:
            if k not in seen:
                seen[k] = len(seen)
        return BiMap(seen)

    string_long = string_int  # alias: Python ints are arbitrary precision

    # -- vectorized lookup for the device path ---------------------------
    def lookup_array(self, keys: Iterable[K], default: int = -1) -> np.ndarray:
        """Vectorized forward lookup → int32 numpy array (missing → default)."""
        return np.fromiter(
            (self._fwd.get(k, default) for k in keys), dtype=np.int32
        )
