"""Divergence guard: quarantine the stream before it corrupts serving.

Counterpart of ``incubator_predictionio_tpu/streaming/guard.py``. The
guard runs after every fold and on a deeper schedule:

- **finiteness** — any non-finite overlay row trips immediately;
- **norm bound** — a row whose norm exceeds ``max_norm_factor`` × the base
  tables' p99 row norm trips;
- **recall floor** — when the model serves two-stage retrieval, sampled
  queries compare the pruned path against the exact one; recall@k under
  ``recall_floor`` trips. The probe prepares the updater's own
  delta-applied copy on the device the caller names (the updater's);
- **reference bound** (tests) — :func:`compare_to_reference` scores an
  incremental model against a full retrain.

A trip **quarantines** the stream: a durable marker lands in the state
dir, the updater refuses further folds, and a full retrain (a new engine
instance id) clears it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np

from incubator_predictionio_tpu_torch.streaming.stream_metrics import QUARANTINED
from incubator_predictionio_tpu_torch.utils.fs import atomic_write_bytes

QUARANTINE_FILE = "quarantine.json"


@dataclasses.dataclass
class GuardConfig:
    max_norm_factor: float = 10.0     # PIO_STREAM_GUARD_NORM_FACTOR
    recall_floor: float = 0.9         # PIO_STREAM_GUARD_RECALL_FLOOR
    recall_sample: int = 32           # users sampled for the recall probe
    recall_every: int = 8             # folds between recall probes
    recall_k: int = 10

    @classmethod
    def from_env(cls) -> "GuardConfig":
        e = os.environ.get
        return cls(
            max_norm_factor=float(e("PIO_STREAM_GUARD_NORM_FACTOR", "10")),
            recall_floor=float(e("PIO_STREAM_GUARD_RECALL_FLOOR", "0.9")),
            recall_sample=int(e("PIO_STREAM_GUARD_RECALL_SAMPLE", "32")),
            recall_every=int(e("PIO_STREAM_GUARD_RECALL_EVERY", "8")),
            recall_k=int(e("PIO_STREAM_GUARD_RECALL_K", "10")),
        )


# -- quarantine marker -------------------------------------------------------

def quarantine_path(state_dir: str) -> str:
    return os.path.join(state_dir, QUARANTINE_FILE)


def read_quarantine(state_dir: str) -> Optional[dict]:
    try:
        with open(quarantine_path(state_dir)) as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return None


def quarantine(state_dir: str, reason: str, at_seq: int,
               base_instance: str) -> dict:
    """Durable quarantine marker: the stream stays down across updater
    restarts until a full retrain produces a new instance id."""
    marker = {
        "reason": reason,
        "atSeq": at_seq,
        "baseInstance": base_instance,
        "quarantinedAt": time.time(),
        "action": "full retrain + redeploy required "
                  "(pio-tpu train && pio-tpu redeploy); a new engine "
                  "instance clears this marker",
    }
    atomic_write_bytes(quarantine_path(state_dir),
                       json.dumps(marker, indent=2).encode(), durable=True)
    QUARANTINED.inc()
    return marker


def clear_quarantine(state_dir: str) -> None:
    try:
        os.remove(quarantine_path(state_dir))
    except FileNotFoundError:
        pass


# -- checks ------------------------------------------------------------------

class DivergenceGuard:
    def __init__(self, config: Optional[GuardConfig] = None):
        self.config = config or GuardConfig.from_env()
        self._norm_bound: Optional[float] = None
        self._folds_since_recall = 0

    def _base_norm_bound(self, trainer) -> float:
        if self._norm_bound is None:
            norms = []
            for kind in ("u", "i"):
                emb, bias = trainer._base[kind]
                if len(emb):
                    n = np.sqrt((emb.astype(np.float64) ** 2).sum(axis=1)
                                + bias.astype(np.float64) ** 2)
                    norms.append(np.percentile(n, 99))
            base = max(norms) if norms else 1.0
            self._norm_bound = self.config.max_norm_factor * max(base, 1e-3)
        return self._norm_bound

    def check_fold(self, trainer, fold_rows: dict[tuple, np.ndarray]
                   ) -> Optional[str]:
        """Cheap per-fold checks over the rows THIS fold touched.
        Returns a trip reason, or None."""
        bound = self._base_norm_bound(trainer)
        for key, row in fold_rows.items():
            if not np.all(np.isfinite(row)):
                return f"non-finite row {key}"
            norm = float(np.linalg.norm(row))
            if norm > bound:
                return (f"row {key} norm {norm:.3g} exceeds divergence "
                        f"bound {bound:.3g}")
        return None

    def maybe_check_recall(self, model, device=None) -> Optional[str]:
        """Every ``recall_every`` folds: sampled recall@k of the pruned
        two-stage path against the exact one on the CURRENT model, prepared
        for serving on ``device`` (CUDA unless the caller names another)
        when it is not yet. No-op when the model serves exact retrieval."""
        self._folds_since_recall += 1
        if self._folds_since_recall < self.config.recall_every:
            return None
        self._folds_since_recall = 0
        mf = getattr(model, "mf", model)
        ivf = getattr(mf, "_ivf", None)
        if ivf is None:
            return None
        from incubator_predictionio_tpu_torch.serving import ann

        if not ann.two_stage_enabled(mf.n_items):
            return None
        from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerMF

        cfg = self.config
        n_users = mf.n_users
        if n_users == 0:
            return None
        if not mf.prepared:
            mf.prepare_for_serving(device=device)
        rng = np.random.default_rng(0)
        sample = rng.choice(n_users, size=min(cfg.recall_sample, n_users),
                            replace=False).astype(np.int32)
        k = min(cfg.recall_k, mf.n_items)
        pruned_idx, _ = TwoTowerMF.recommend_batch(mf, sample, k)
        exact_idx, _ = TwoTowerMF.recommend_batch(mf, sample, k,
                                                  _force_exact=True)
        hits = sum(
            len(set(p.tolist()) & set(e.tolist()))
            for p, e in zip(pruned_idx, exact_idx))
        recall = hits / float(exact_idx.size) if exact_idx.size else 1.0
        if recall < cfg.recall_floor:
            return (f"two-stage recall@{k} {recall:.3f} under floor "
                    f"{cfg.recall_floor} (stale index diverged)")
        return None


def compare_to_reference(inc_model, ref_model, sample_users: int = 64,
                         k: int = 10, seed: int = 0, device=None) -> dict:
    """Incremental-vs-full-retrain agreement on sampled users: score RMSE
    over the catalog and top-k overlap (the exact path, prepared on
    ``device`` — CUDA unless the caller names another — where a model is
    not prepared yet). Callers assert against the documented tolerance."""
    from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerMF

    inc, ref = inc_model.mf, ref_model.mf
    for m in (inc, ref):
        m.ensure_host()
        if not m.prepared:
            m.prepare_for_serving(device=device)
    n_users = min(inc.n_users, ref.n_users)
    n_items = min(inc.n_items, ref.n_items)
    rng = np.random.default_rng(seed)
    sample = rng.choice(n_users, size=min(sample_users, n_users),
                        replace=False).astype(np.int64)

    def full_scores(m):
        ue = np.asarray(m.user_emb, np.float32)[sample]
        ub = np.asarray(m.user_bias, np.float32)[sample]
        it = np.asarray(m.item_emb, np.float32)[:n_items]
        ib = np.asarray(m.item_bias, np.float32)[:n_items]
        return ue @ it.T + ib[None, :] + ub[:, None] + m.mean

    s_inc = full_scores(inc)
    s_ref = full_scores(ref)
    rmse = float(np.sqrt(np.mean((s_inc - s_ref) ** 2)))
    k = min(k, n_items)
    top_inc, _ = TwoTowerMF.recommend_batch(inc, sample.astype(np.int32), k,
                                            _force_exact=True)
    top_ref, _ = TwoTowerMF.recommend_batch(ref, sample.astype(np.int32), k,
                                            _force_exact=True)
    overlap = sum(
        len(set(a.tolist()) & set(b.tolist()))
        for a, b in zip(top_inc, top_ref)) / float(top_ref.size)
    return {"score_rmse": rmse, "topk_overlap": overlap,
            "sampled_users": int(len(sample)), "k": int(k)}
