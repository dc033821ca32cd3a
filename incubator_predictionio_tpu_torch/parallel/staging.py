"""Per-process input staging for entity-sharded training rows.

Counterpart of ``incubator_predictionio_tpu/parallel/staging.py`` (:27-82,
``stage_sharded_batches``): this process holds ``n_local`` rows (its
entity shard, indices already global); batches are assembled per process
and the global batch ``b`` is every process's local batch ``b`` in process
order (the reference's ``make_array_from_process_local_data`` layout) —
host memory per process is data/P instead of a full replica. Where the
reference puts the local batches into a global array, this port copies
them to the process's own device: one device a process, so the local
batch is the process's whole share of the global one.

Rows are shuffled per process and padded (by resampling local rows) to a
whole number of equal local batches; a weight column zeroes the padding's
loss contribution so resampled rows don't bias the objective.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def stage_sharded_batches(
    ctx,
    arrays: Sequence[np.ndarray],
    batch_size: int,
    seed: int,
    n_global: Optional[int] = None,
):
    """Stage this process's rows into its local batches on ``ctx.device``.

    ``arrays``: equal-length ``[n_local, ...]`` host arrays (one shard's
    rows). Returns ``(staged, weights, n_global)``: ``staged`` a tuple of
    ``[n_batches, b_local, ...]`` tensors on ``ctx.device`` (the arrays'
    dtypes), ``weights`` the matching ``[n_batches, b_local]`` fp32 0/1
    tensor, ``n_global`` the job-wide row count; ``b_local`` is the global
    batch over the process count. The shuffle, the padding and the weights
    are the reference's numpy, bitwise. Collective: all processes must call
    with the same ``batch_size``/``seed``."""
    n_local = len(arrays[0])
    for a in arrays:
        if len(a) != n_local:
            raise ValueError("staged arrays must share the leading dim")
    from incubator_predictionio_tpu_torch.data.sharded import (
        data_shard,
        gather_data,
        global_row_count,
    )

    if n_global is None:
        n_global = global_row_count(ctx, n_local)
    shard, procs = data_shard(ctx)
    global_batch = ctx.pad_to_batch_multiple(min(batch_size, max(n_global, 1)))
    if global_batch % procs:
        raise ValueError(
            f"global batch {global_batch} not divisible by {procs} data shards")
    b_local = global_batch // procs
    # every process needs the same n_batches: size for the largest shard
    max_local = int(max(gather_data(ctx, n_local)))
    n_batches = max(1, (max_local + b_local - 1) // b_local)
    n_pad = n_batches * b_local
    rng = np.random.default_rng(seed + shard)
    if n_local:
        order = np.concatenate([
            rng.permutation(n_local),
            rng.integers(0, n_local, n_pad - n_local),
        ])
        arrays = [np.asarray(a) for a in arrays]
    else:
        # all-padding shard: one zero row, all weights zero
        order = np.zeros(n_pad, np.int64)
        arrays = [np.zeros((1, *np.asarray(a).shape[1:]),
                           np.asarray(a).dtype) for a in arrays]
    w = np.concatenate([
        np.ones(n_local, np.float32),
        np.zeros(n_pad - n_local, np.float32),
    ])
    staged = tuple(
        _put_local(ctx, a[order].reshape(n_batches, b_local, *a.shape[1:]))
        for a in arrays
    )
    weights = _put_local(ctx, w.reshape(n_batches, b_local))
    return staged, weights, n_global


def _put_local(ctx, a: np.ndarray) -> torch.Tensor:
    """This process's ``[n_batches, b_local, ...]`` batches on its device
    (the reference's ``MeshContext.put_local_batches``)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)
