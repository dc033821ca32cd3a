"""Params marker + JSON↔dataclass binding.

Copy of ``incubator_predictionio_tpu/utils/params.py`` (the port imports
nothing of the JAX package, so it keeps its own).

Replaces the reference's dual json4s/Gson extraction stack
(workflow/JsonExtractor.scala:39-100, controller/Params.scala): stage params
are plain dataclasses; variant JSON binds by field name, accepting both
camelCase (reference engine.json convention) and snake_case keys. Unknown
keys raise — silently dropped hyperparameters are how tuning runs lie.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Optional, Type


@dataclasses.dataclass(frozen=True)
class Params:
    """Marker base class for stage parameters (controller/Params.scala:26)."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    """No parameters (controller/Params.scala:32)."""


_CAMEL_RE = re.compile(r"(?<!^)(?=[A-Z])")


def snake_case(name: str) -> str:
    """camelCase → snake_case (shared by params binding and webhook mappers)."""
    return _CAMEL_RE.sub("_", name).lower()


_snake = snake_case


def params_from_json(cls: Optional[Type[Params]], obj: Any) -> Params:
    """Bind a JSON object (dict or string) to a params dataclass.

    camelCase keys map onto snake_case fields; extra keys are an error;
    missing keys fall back to dataclass defaults (missing required fields
    raise TypeError, as the reference's extractor raises MappingException).
    """
    if cls is None or cls is EmptyParams:
        return EmptyParams()
    if obj is None:
        obj = {}
    if isinstance(obj, str):
        obj = json.loads(obj) if obj.strip() else {}
    if not isinstance(obj, dict):
        raise TypeError(f"params for {cls.__name__} must be a JSON object, got {obj!r}")
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"params class {cls.__name__} must be a dataclass")
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    for k, v in obj.items():
        name = k if k in field_names else _snake(k)
        if name not in field_names:
            raise TypeError(
                f"unknown parameter {k!r} for {cls.__name__}; known: {sorted(field_names)}"
            )
        if name in kwargs:
            raise TypeError(f"duplicate parameter {k!r} for {cls.__name__}")
        kwargs[name] = v
    return cls(**kwargs)


def params_to_json_dict(params: Params) -> dict[str, Any]:
    """Dataclass → JSON dict (snake_case keys; used for meta rows and the
    evaluator's results, reference utils/params.py:70)."""
    if params is None or isinstance(params, EmptyParams):
        return {}
    return dataclasses.asdict(params)
