"""Sharded-read primitives: shard → vocab allgather → remap.

Counterpart of ``incubator_predictionio_tpu/data/sharded.py`` (:33-106),
the per-process read path of a multi-process job (reference counterpart:
RDD partition reads, data/.../storage/PEvents.scala:38): each process
reads ONLY its entity shard of the store (``find_sharded`` /
``assemble_triples`` with ``n_shards``), then the processes exchange
vocabulary-sized metadata — never event-sized — to agree on global id
spaces:

- :func:`concat_vocab` — for the SHARDED entity type (users): shards are
  entity-disjoint, so the global vocabulary is the concatenation of the
  per-shard vocabularies and a local index globalizes by adding an offset;
- :func:`union_vocab` — for the target type (items), whose ids cross
  shards: the first-seen union over shards in process order, with an int32
  remap array for local indices;
- :func:`global_sum` / :func:`global_row_count` / :func:`union_label_set`
  — reductions over small per-shard statistics.

Every function is also correct single-process (it degenerates to identity).
All calls are collective: every process must make the same sequence.
``ctx`` is anything with ``allgather_obj`` and ``process_index``
(``parallel/mesh.py:DeviceContext``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def concat_vocab(ctx, local_vocab: Sequence[str]) -> tuple[np.ndarray, int]:
    """Entity-disjoint vocabularies → (global vocab, this process's offset).

    Local index ``i`` globalizes as ``i + offset``. No id may appear in two
    processes' vocabularies (true when the store was read entity-sharded):
    a violation raises instead of minting two global rows for one entity."""
    parts = ctx.allgather_obj(list(local_vocab))
    vocab = np.asarray([v for p in parts for v in p], object)
    if len(np.unique(vocab)) != len(vocab):
        seen: dict = {}
        for pi, p in enumerate(parts):
            for v in p:
                if v in seen:
                    raise ValueError(
                        f"entity id {v!r} appears in shards {seen[v]} and "
                        f"{pi} — concat_vocab requires entity-disjoint "
                        "shard reads (use union_vocab for cross-shard id "
                        "spaces)")
                seen[v] = pi
    offset = sum(len(p) for p in parts[: ctx.process_index])
    return vocab, offset


def union_vocab(ctx, local_vocab: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    """Cross-shard vocabularies → (global vocab, local→global remap).

    Global order is first-seen over shards in process order (what a
    single-process first-seen read gives); ``remap[local_idx] ==
    global_idx`` (int32)."""
    parts = ctx.allgather_obj(list(local_vocab))
    glob: dict[str, int] = {}
    for p in parts:
        for v in p:
            glob.setdefault(v, len(glob))
    vocab = np.asarray(list(glob), object)
    remap = np.asarray([glob[v] for v in local_vocab], np.int32)
    return vocab, remap


def _add_leaves(parts):
    """Leaf-wise sum of same-shaped trees of tuples, lists, dicts and
    numeric leaves (scalars, numpy arrays) — what the reference's
    ``jax.tree.map(add_all, *parts)`` does, without jax."""
    head = parts[0]
    if head is None:
        return None
    if isinstance(head, tuple):
        fields = [_add_leaves([p[i] for p in parts]) for i in range(len(head))]
        return type(head)(*fields) if hasattr(head, "_fields") else tuple(fields)
    if isinstance(head, list):
        return [_add_leaves([p[i] for p in parts]) for i in range(len(head))]
    if isinstance(head, dict):
        return {k: _add_leaves([p[k] for p in parts]) for k in head}
    out = head
    for leaf in parts[1:]:
        out = out + leaf
    return out


def global_sum(ctx, value):
    """Sum small numeric host values over processes, leaf-wise: ``value``
    may be a scalar, a numpy array, or a tuple / list / dict of them
    (moment accumulators sum element-wise, they do not concatenate)."""
    return _add_leaves(ctx.allgather_obj(value))


def global_row_count(ctx, n_local: int) -> int:
    return int(global_sum(ctx, int(n_local)))


def union_label_set(ctx, local_labels) -> list:
    """Sorted union of label values across processes (classification's
    global class vocabulary)."""
    parts = ctx.allgather_obj(sorted(set(local_labels)))
    return sorted({v for p in parts for v in p})
