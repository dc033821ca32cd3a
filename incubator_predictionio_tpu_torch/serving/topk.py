"""Axis-wise grouped top-k for batched serving.

Copy of ``incubator_predictionio_tpu/serving/topk.py``.

ONE implementation of the batched selection chain, shared by every
template's ``batch_predict`` so the bitwise contract with the serial oracle
(``argpartition`` → ``argsort`` on the selected columns, numpy default
kinds) lives in exactly one place. Rows are grouped by their requested
``num`` and each group runs one vectorized ``axis=1`` pass — per-row
results are identical to running the serial chain row by row, including
tie resolution (introselect/quicksort are applied per 1-D slice either
way).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def topk_row(scores: np.ndarray, num: int) -> np.ndarray:
    """Top-``num`` indices of ONE 1-D score row, best-first — the same
    ``argpartition`` → ``argsort`` chain :func:`grouped_topk` runs axis-wise,
    so single-row consumers (the two-stage rerank) share the serial oracle's
    tie resolution instead of re-implementing the selection."""
    num = min(num, scores.shape[0])
    if num <= 0:
        return np.empty(0, np.int64)
    part = np.argpartition(-scores, num - 1)[:num]
    return part[np.argsort(-scores[part])]


def merge_topk(
    cand_ids: np.ndarray, cand_scores: np.ndarray, num: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise top-``num`` over gathered candidate lists (the cross-shard
    merge of sharded serving, and the fleet router's cross-PROCESS fan-in
    of shard-owner partials — docs/sharding.md "Multi-host shard owners"):
    ``cand_ids``/``cand_scores`` are ``[B, C]`` with each shard's
    candidates already best-first and shards concatenated in
    ascending-row-range order. Runs the same axis-wise
    ``argpartition`` → ``argsort`` chain as :func:`grouped_topk`, so merged
    results match the single-host serial oracle's selection (ids resolve
    through ``cand_ids``). Callers may pad short candidate lists with
    ``-inf`` scores; a padded slot can never displace a real candidate."""
    b, c = cand_scores.shape
    num = min(num, c)
    if num <= 0 or b == 0:
        return (np.empty((b, 0), cand_ids.dtype),
                np.empty((b, 0), cand_scores.dtype))
    part = np.argpartition(-cand_scores, num - 1, axis=1)[:, :num]
    row = np.arange(b)[:, None]
    order = np.argsort(-cand_scores[row, part], axis=1)
    top = np.take_along_axis(part, order, 1)
    return np.take_along_axis(cand_ids, top, 1), cand_scores[row, top]


def grouped_topk(
    scored: np.ndarray, nums: Sequence[int],
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-row top-``nums[r]`` of ``scored[r]``, selection-parity with the
    serial ``argpartition(-s, num-1)[:num]`` → ``argsort`` chain.

    Returns one ``(indices, scores)`` pair per row, ordered best-first.
    ``num <= 0`` rows return empty results (templates normalize their
    serial paths the same way — a non-positive ``num`` is a degenerate
    query, not a catalog dump). Callers apply their own keep-predicates
    (finiteness, score cuts) on the returned score rows.
    """
    out: list[tuple[np.ndarray, np.ndarray]] = [None] * len(nums)  # type: ignore[list-item]
    empty = (np.empty(0, np.int64), np.empty(0, np.float32))
    by_num: dict[int, list[int]] = {}
    for r, num in enumerate(nums):
        if num <= 0:
            out[r] = empty
        else:
            by_num.setdefault(int(num), []).append(r)
    for num, rows in by_num.items():
        sub = scored[rows]
        part = np.argpartition(-sub, num - 1, axis=1)[:, :num]
        top_scores = np.take_along_axis(sub, part, 1)
        order = np.argsort(-top_scores, axis=1)
        top = np.take_along_axis(part, order, 1)
        top_scores = np.take_along_axis(top_scores, order, 1)
        for rr, r in enumerate(rows):
            out[r] = (top[rr], top_scores[rr])
    return out
