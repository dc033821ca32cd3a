"""Once-per-key axis-degradation registry.

Counterpart of ``incubator_predictionio_tpu/sharding/degrade.py``. A
trainer asked for a parallel axis the mesh doesn't have (``n_experts=4``
with no ``expert`` axis, ``tensor_parallel`` with no ``model`` axis): it
degrades and keeps training, and the degradation lands here:

- the warning logs ONCE per (component, axis, requested, mesh-axes) key,
  with the requested-vs-available axes named;
- every occurrence is COUNTED, and :func:`degradations` returns the
  machine-readable list.

Its callers are the transformer's fit, as the reference's:
``tensor_parallel`` without a ``model`` axis and ``n_experts`` without an
``expert`` axis; the other parallel axes come with the rest of ROADMAP.md
Queue 1, item 4.5.
"""

from __future__ import annotations

import logging
import threading

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
_RECORDS: dict[tuple, dict] = {}


def record_axis_degradation(component: str, axis: str, requested,
                            mesh_axes, detail: str) -> dict:
    """Note that ``component`` wanted ``requested`` over mesh axis ``axis``
    but the mesh only has ``mesh_axes``. Logs once per distinct key;
    returns the (shared, mutable) record with its occurrence count."""
    mesh_axes = tuple(mesh_axes)
    key = (component, axis, str(requested), mesh_axes)
    with _LOCK:
        rec = _RECORDS.get(key)
        if rec is None:
            rec = _RECORDS[key] = {
                "component": component,
                "axis": axis,
                "requested": requested,
                "mesh_axes": list(mesh_axes),
                "detail": detail,
                "count": 0,
            }
            logger.warning(
                "%s: %s requested but the mesh has no '%s' axis "
                "(mesh axes: %s) — %s",
                component, requested, axis, mesh_axes, detail)
        rec["count"] += 1
        return rec


def degradations() -> list[dict]:
    """Every distinct degradation seen by this process, with counts."""
    with _LOCK:
        return [dict(r) for r in _RECORDS.values()]


def reset() -> None:
    """Forget everything (tests)."""
    with _LOCK:
        _RECORDS.clear()
