"""Compiled filter masks: per-item Python loops → vectorized index scatters.

Copy of ``incubator_predictionio_tpu/serving/masks.py`` over the port's
``BiMap.lookup_array`` (host numpy; the port imports nothing of the JAX
package).

Every business-rule filter reduces to the same primitive: a set of catalog
rows that must score -inf. The seed templates computed those sets with
per-item interpreter loops (the category filter iterated the whole
``item_map`` per query — O(catalog) Python); here the loops happen ONCE at
``prepare_for_serving`` when :class:`CategoryIndex` inverts the catalog's
category metadata, and query time is numpy scatters:

- category allow/ban → union of the precompiled per-category row arrays;
- white/black lists, seen items, unavailable items → ``BiMap.lookup_array``
  index scatters.

Mask values are exactly ``{0.0, -inf}`` and every filter only ever *bans*
(the whitelist bans non-members), so composition is order-free — the
vectorized masks are bitwise identical to the serial loops' output, which
the batched-vs-serial parity tests rely on.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from incubator_predictionio_tpu_torch.data.bimap import BiMap

_NEG_INF = np.float32(-np.inf)

#: Bound on the per-index memoized union results (distinct category filter
#: tuples seen); serving traffic reuses a handful of filters, but the cache
#: must not grow without bound under adversarial query streams.
_UNION_CACHE_MAX = 256


class CategoryIndex:
    """Category → member catalog rows, inverted once from item metadata.

    The CSR-style structure behind vectorized category filtering: for each
    category, the sorted int32 array of catalog rows carrying it. A query's
    ``categories=(...)`` filter becomes the union of a few row arrays (OR
    over rows) instead of a per-item intersection test over the whole
    catalog.
    """

    __slots__ = ("n_rows", "_rows", "_union_cache")

    def __init__(self, id_map: BiMap, categories: Mapping[str, Sequence[str]]):
        self.n_rows = len(id_map)
        by_cat: dict[str, list[int]] = {}
        for iid, idx in id_map.items():
            for c in categories.get(iid, ()):
                by_cat.setdefault(c, []).append(idx)
        self._rows = {
            c: np.asarray(sorted(v), np.int32) for c, v in by_cat.items()
        }
        # memoized unions keyed by the (deduped, sorted) category tuple —
        # coalesced batches overwhelmingly repeat the same filter
        self._union_cache: dict[tuple[str, ...], np.ndarray] = {}

    def rows_with_any(self, cats: Iterable[str]) -> np.ndarray:
        """Sorted unique rows carrying ANY of ``cats`` (the OR over rows)."""
        key = tuple(sorted(set(cats)))
        hit = self._union_cache.get(key)
        if hit is not None:
            return hit
        arrs = [self._rows[c] for c in key if c in self._rows]
        rows = (np.unique(np.concatenate(arrs)) if arrs
                else np.empty(0, np.int32))
        if len(self._union_cache) >= _UNION_CACHE_MAX:
            self._union_cache.clear()
        self._union_cache[key] = rows
        return rows

    def allow_vec(self, cats: Iterable[str]) -> np.ndarray:
        """[n] f32 mask: 0 where the row has any of ``cats``, -inf elsewhere
        (the reference's ``categories`` filter: keep items intersecting)."""
        mask = np.full(self.n_rows, _NEG_INF, np.float32)
        mask[self.rows_with_any(cats)] = 0.0
        return mask

    def ban_vec(self, cats: Iterable[str]) -> np.ndarray:
        """[n] f32 mask: -inf where the row has any of ``cats``
        (``categoryBlackList``)."""
        mask = np.zeros(self.n_rows, np.float32)
        mask[self.rows_with_any(cats)] = _NEG_INF
        return mask


class HasCategoryIndex:
    """Mixin for serving models carrying ``item_map`` + ``categories``:
    one lazy, memoized :class:`CategoryIndex` build shared by every
    template model (eagerly compiled by each model's
    ``prepare_for_serving``, lazily on first direct-``predict`` use)."""

    _cat_index = None  # class default; instances memoize on first access

    def category_index(self) -> CategoryIndex:
        if self._cat_index is None:
            self._cat_index = CategoryIndex(self.item_map, self.categories)
        return self._cat_index


def whitelist_vec(id_map: BiMap, white_list: Sequence[str]) -> np.ndarray:
    """[n] f32 mask: 0 at whitelisted rows, -inf elsewhere (unknown ids are
    dropped, like the reference's flatten)."""
    n = len(id_map)
    allowed = id_map.lookup_array(white_list)
    mask = np.full(n, _NEG_INF, np.float32)
    mask[allowed[allowed >= 0]] = 0.0
    return mask


def ban_rows(mask: np.ndarray, id_map: BiMap,
             ids: Optional[Iterable[str]]) -> np.ndarray:
    """Scatter -inf into ``mask`` at the rows of ``ids`` (in place; unknown
    ids ignored). The vectorized form of the per-item ``.get`` loops."""
    if ids:
        idx = id_map.lookup_array(ids)
        mask[idx[idx >= 0]] = _NEG_INF
    return mask
