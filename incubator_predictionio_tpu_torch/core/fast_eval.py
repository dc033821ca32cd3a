"""FastEvalEngine — prefix-memoized evaluation for hyperparameter tuning.

Copy of ``incubator_predictionio_tpu/core/fast_eval.py``
(controller/FastEvalEngine.scala:46-346). When evaluating many
EngineParams variants, pipeline prefixes that share parameters are computed
once: the datasource read is keyed by datasource params, prepared data by
(datasource, preparator) params, trained models by (…, one algorithm's
params). Frozen params dataclasses are the hash keys, and the model cache
holds whatever the algorithm's ``train`` returned: a host model, or a
model whose tables or parameters stay on the card (a device-resident
two-tower model, a transformer), so the cache may hold device memory for
every fold of every distinct algorithm params until ``batch_eval``
returns.

Workflow usage: construct with the same class maps as Engine (or from an
existing Engine via ``from_engine``), then ``batch_eval`` over variants.
"""

from __future__ import annotations

import logging
from typing import Any

from incubator_predictionio_tpu_torch.core.base import doer
from incubator_predictionio_tpu_torch.core.controller import (
    Engine,
    EngineParams,
    NamedParams,
    WorkflowParams,
)
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

logger = logging.getLogger(__name__)


class FastEvalEngine(Engine):
    """Engine whose ``batch_eval`` memoizes per-prefix pipeline results."""

    @staticmethod
    def from_engine(engine: Engine) -> "FastEvalEngine":
        return FastEvalEngine(
            engine.data_source_class_map,
            engine.preparator_class_map,
            engine.algorithm_class_map,
            engine.serving_class_map,
        )

    def batch_eval(
        self,
        ctx: DeviceContext,
        engine_params_list: list[EngineParams],
        params: WorkflowParams = WorkflowParams(),
    ) -> list[tuple[EngineParams, list]]:
        # prefix caches (FastEvalEngineWorkflow getDataSourceResult :88 et seq.)
        ds_cache: dict[NamedParams, list] = {}
        prep_cache: dict[tuple, list] = {}
        algo_cache: dict[tuple, list] = {}
        stats = {"ds": 0, "prep": 0, "algo": 0}

        def eval_sets(ds_params: NamedParams) -> list:
            if ds_params not in ds_cache:
                stats["ds"] += 1
                cls = self._pick(self.data_source_class_map, ds_params[0], "datasource")
                ds_cache[ds_params] = doer(cls, ds_params[1]).read_eval(ctx)
            return ds_cache[ds_params]

        def prepared(ds_params: NamedParams, prep_params: NamedParams) -> list:
            key = (ds_params, prep_params)
            if key not in prep_cache:
                stats["prep"] += 1
                cls = self._pick(self.preparator_class_map, prep_params[0], "preparator")
                prep = doer(cls, prep_params[1])
                prep_cache[key] = [
                    prep.prepare(ctx, td) for td, _, _ in eval_sets(ds_params)
                ]
            return prep_cache[key]

        def models(
            ds_params: NamedParams, prep_params: NamedParams, algo_params: NamedParams
        ) -> list:
            key = (ds_params, prep_params, algo_params)
            if key not in algo_cache:
                stats["algo"] += 1
                cls = self._pick(self.algorithm_class_map, algo_params[0], "algorithm")
                algo = doer(cls, algo_params[1])
                algo_cache[key] = [
                    algo.train(ctx, pd) for pd in prepared(ds_params, prep_params)
                ]
            return algo_cache[key]

        results = []
        for ep in engine_params_list:
            sets = eval_sets(ep.data_source_params)
            algo_list = ep.algorithm_params_list or (("", None),)
            fold_models = [
                models(ep.data_source_params, ep.preparator_params, ap)
                for ap in algo_list
            ]
            algorithms = [
                doer(self._pick(self.algorithm_class_map, name, "algorithm"), p)
                for name, p in algo_list
            ]
            serving = doer(
                self._pick(self.serving_class_map, ep.serving_params[0], "serving"),
                ep.serving_params[1],
            )
            variant_out = []
            for fold, (td, ei, qa) in enumerate(sets):
                queries = [(i, serving.supplement(q)) for i, (q, _) in enumerate(qa)]
                per_query: list[list[Any]] = [[] for _ in queries]
                for algo, models_per_fold in zip(algorithms, fold_models):
                    for i, p in algo.batch_predict(models_per_fold[fold], queries):
                        per_query[i].append(p)
                variant_out.append((ei, [
                    (sq, serving.serve(sq, preds), a)
                    for ((_, sq), (_, a), preds) in zip(queries, qa, per_query)
                ]))
            results.append((ep, variant_out))
        logger.info(
            "FastEvalEngine: %d variants → %d datasource reads, %d prepares, "
            "%d trainings", len(engine_params_list), stats["ds"], stats["prep"],
            stats["algo"],
        )
        self.last_cache_stats = dict(stats)
        return results
