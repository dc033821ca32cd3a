"""JSON helpers: dataclass/numpy-aware encoding, query binding.

Copy of ``incubator_predictionio_tpu/utils/json_util.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Type

import numpy as np

from incubator_predictionio_tpu_torch.utils.params import params_from_json


def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(w[:1].upper() + w[1:] for w in rest)


def to_jsonable(obj: Any, camelize_fields: bool = False) -> Any:
    """Recursively convert dataclasses / numpy scalars+arrays / tuples into
    JSON-encodable structures.

    ``camelize_fields=True`` renders DATACLASS FIELD names in camelCase —
    the reference's wire shape for predictions (``itemScores``,
    ``similarUserScores``; query binding already accepts camelCase in).
    Plain dict keys are user data and pass through untouched.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            (_camel(f.name) if camelize_fields else f.name):
                to_jsonable(getattr(obj, f.name), camelize_fields)
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v, camelize_fields) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v, camelize_fields) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def bind_query(query_cls: Optional[Type], payload: dict) -> Any:
    """Bind a /queries.json body onto the algorithm's query dataclass.

    Falls back to the raw dict when the algorithm declares no query class
    (the reference's CustomQuerySerializer escape hatch)."""
    if query_cls is None or not dataclasses.is_dataclass(query_cls):
        return payload
    # reuse the params binding rules (camelCase→snake_case, unknown keys raise)
    return params_from_json(query_cls, payload)
