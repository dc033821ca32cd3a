"""Vectorized batched serving for the rule-filtered templates.

Counterpart of ``incubator_predictionio_tpu/serving/__init__.py``:

- :mod:`masks <incubator_predictionio_tpu_torch.serving.masks>` — the
  catalog's category metadata compiled once at ``prepare_for_serving`` into
  a :class:`~incubator_predictionio_tpu_torch.serving.masks.CategoryIndex`,
  every query's filter assembled as vectorized index scatters into an
  additive -inf mask;
- :mod:`cache <incubator_predictionio_tpu_torch.serving.cache>` — a TTL +
  single-flight cache for serving-time live store reads
  (``PIO_SERVING_CONSTRAINT_TTL_MS=0`` restores the reference's
  read-per-query semantics);
- :mod:`ann <incubator_predictionio_tpu_torch.serving.ann>` — two-stage
  retrieval (IVF coarse probe on kernel K2, exact rerank);
- :mod:`topk <incubator_predictionio_tpu_torch.serving.topk>` — the
  grouped top-k every batched path shares with its serial oracle.
"""

from incubator_predictionio_tpu_torch.serving.ann import IVFIndex, build_ivf
from incubator_predictionio_tpu_torch.serving.cache import (
    TTLCache,
    constraint_ttl_sec,
)
from incubator_predictionio_tpu_torch.serving.masks import (
    CategoryIndex,
    HasCategoryIndex,
    ban_rows,
    whitelist_vec,
)
from incubator_predictionio_tpu_torch.serving.topk import grouped_topk, topk_row

__all__ = [
    "CategoryIndex",
    "HasCategoryIndex",
    "IVFIndex",
    "TTLCache",
    "ban_rows",
    "build_ivf",
    "constraint_ttl_sec",
    "grouped_topk",
    "topk_row",
    "whitelist_vec",
]
