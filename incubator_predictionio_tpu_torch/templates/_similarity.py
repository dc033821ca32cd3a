"""Shared cosine-similarity serving path of the similarproduct family
(similarproduct, recommended_user).

Counterpart of ``incubator_predictionio_tpu/templates/_similarity.py``. One
bf16 product scores every candidate against the query vectors on the
serving device; filters ride as an additive -inf mask (the reference's
per-candidate cosine loops: similarproduct ALSAlgorithm.scala:150-175,
recommended-user ALSAlgorithm.scala:150-160).

:func:`qv_scores` is the reference's ``(q.bf16 @ vt.bf16)``, whose result
JAX rounds to bf16 before widening it to fp32. Here both operands hold
bf16-rounded values in fp32 storage (:func:`device_catalog` rounds the
catalog once at deploy): their products are exact in fp32 (also under
TF32, whose 10-bit mantissa holds a bf16 value's 8), the sum is fp32, and
the result is rounded to bf16 once, as the reference's is.

Batching contract, as in the reference: the product is the ONLY device op
and the per-query sum over its vectors' score rows happens on the host, so
a coalesced batch's query vectors stack into one ``[ΣQ, k] × [k, n]``
product (:func:`sim_scores_stacked`) that reproduces the per-query
:func:`sim_scores` rows as long as the device's row results do not depend
on how many rows share the product — bitwise on the CPU; on an H100
cuBLAS picks its kernel by M, and a stacked row can land one bf16 ulp from
the serial one. Row counts pad to the serving bucket ladder (zero rows
score zero and are sliced off), so the device sees a handful of shapes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from incubator_predictionio_tpu_torch.models.two_tower import (
    SERVE_BUCKETS,
    serve_bucket,
)


def l2_normalize(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-9)


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    """fp32 storage holding ``t`` rounded to bf16 (nearest even)."""
    return t.to(torch.bfloat16).to(torch.float32)


def device_catalog(vecs: np.ndarray, device) -> torch.Tensor:
    """The ``[k, n]`` candidate matrix on ``device``: the transpose of the
    ``[n, k]`` L2-normalized table, rounded to bf16 once (fp32 storage)."""
    vt = torch.from_numpy(np.ascontiguousarray(np.asarray(vecs, np.float32).T))
    return _bf16_values(vt.to(device))


def qv_scores(qvecs: torch.Tensor, cand_vt: torch.Tensor) -> torch.Tensor:
    """[q, k] query rows × [k, n] candidate columns (bf16 values) → [q, n]
    per-row scores, rounded to bf16, as fp32. Rows must be L2-normalized
    for cosine semantics."""
    return _bf16_values(torch.matmul(_bf16_values(qvecs), cand_vt))


def _matmul_rows(qvecs: np.ndarray, cand_vt: torch.Tensor) -> np.ndarray:
    """One bucket-padded :func:`qv_scores` product → host [q, n] rows."""
    q = qvecs.shape[0]
    bucket = serve_bucket(max(q, 1))
    if bucket != q:
        qvecs = np.concatenate(
            [qvecs, np.zeros((bucket - q, qvecs.shape[1]), qvecs.dtype)])
    rows = qv_scores(torch.from_numpy(qvecs).to(cand_vt.device), cand_vt)
    return rows[:q].cpu().numpy()


def warmup(cand_vt: torch.Tensor) -> int:
    """Run the product once at every bucket of the ladder at deploy, so no
    live query pays for the device libraries' first use. Returns the count
    of buckets run."""
    for b in SERVE_BUCKETS:
        _matmul_rows(np.zeros((b, cand_vt.shape[0]), np.float32), cand_vt)
    return len(SERVE_BUCKETS)


def sim_scores(qvecs, cand_vt: torch.Tensor, mask) -> np.ndarray:
    """[q, k] query rows → [n] summed cosine scores (+ mask), host sum."""
    rows = _matmul_rows(np.asarray(qvecs, np.float32), cand_vt)
    return rows.sum(axis=0) + np.asarray(mask)


def sim_scores_stacked(
    qvecs: np.ndarray,
    counts: Sequence[int],
    cand_vt: torch.Tensor,
    masks: Optional[np.ndarray] = None,
) -> np.ndarray:
    """A whole batch in ONE product.

    ``qvecs`` is every query's vectors concatenated ([ΣQ, k], query i owning
    ``counts[i]`` consecutive rows); ``masks`` an optional [B, n] additive
    mask. Returns [B, n] summed scores, each row summed on the host as
    :func:`sim_scores` sums it."""
    rows = _matmul_rows(np.asarray(qvecs, np.float32), cand_vt)
    out = np.empty((len(counts), rows.shape[1]), np.float32)
    off = 0
    for i, c in enumerate(counts):
        row = rows[off:off + c].sum(axis=0)
        out[i] = row + masks[i] if masks is not None else row
        off += c
    return out
