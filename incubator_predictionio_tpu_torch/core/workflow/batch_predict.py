"""BatchPredict — offline bulk scoring (the ``batchpredict`` verb).

Counterpart of ``incubator_predictionio_tpu/core/workflow/batch_predict.py``
(:1-123; reference workflow/BatchPredict.scala:145-235): read one JSON
query per line, run supplement → each algorithm's ``batch_predict`` →
serve per query, write one camel-cased JSON prediction per line. The
deployed models are loaded once (``server/query_server.py:
load_deployed_engine``, on the context's device) and the queries go
through each algorithm's vectorised ``batch_predict`` in chunks of
``query_chunk``, the batch dimension of one device dispatch.

Multi-process (``launch -n N batchpredict``, which adds
``--distributed``): each process scores a contiguous slice of the input,
``round(i·total/N)`` to ``round((i+1)·total/N)``, streaming only its own
lines, and writes ``<output>.part-<i>`` — the reference's
``saveAsTextFile`` part-file layout (BatchPredict.scala:228);
concatenating the parts in order reproduces the one-process output.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
from typing import Optional

from incubator_predictionio_tpu_torch.data.storage.registry import Storage
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.server.query_server import (
    ServerConfig,
    load_deployed_engine,
)
from incubator_predictionio_tpu_torch.utils.json_util import bind_query, to_jsonable

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BatchPredictConfig:
    """(BatchPredict.scala flags :60-110)"""

    engine_variant: str = "engine.json"
    input_path: str = "batchpredict-input.json"
    output_path: str = "batchpredict-output.json"
    query_chunk: int = 1024  # device batch per predict round


def part_path(output_path: str, pid: int) -> str:
    """The one place the distributed part-file naming scheme lives."""
    return f"{output_path}.part-{pid:05d}"


def _slice_lines(path: str, pid: int, procs: int) -> list[str]:
    """This process's contiguous slice of the non-blank lines, read in two
    streaming passes (a count, then the slice): only the slice is ever in
    memory."""
    with open(path) as fin:
        total = sum(1 for line in fin if line.strip())
    bounds = [round(i * total / procs) for i in range(procs + 1)]
    lo, hi = bounds[pid], bounds[pid + 1]
    lines = []
    with open(path) as fin:
        i = 0
        for line in fin:
            line = line.strip()
            if not line:
                continue
            if i >= hi:
                break
            if i >= lo:
                lines.append(line)
            i += 1
    return lines


def _remove_stale_parts(ctx: DeviceContext, output_path: str) -> None:
    """Process 0 removes the parts of an earlier run (possibly with more
    processes: they would corrupt the ``cat part-*`` merge). The outcome
    crosses one allgather — a barrier, so that the cleanup precedes every
    write — BEFORE anyone raises: raising before the collective would park
    the other processes in it until their deadline."""
    cleanup_error = None
    if ctx.is_primary:
        try:
            for stale in glob.glob(glob.escape(output_path) + ".part-*"):
                os.remove(stale)
        except OSError as e:
            cleanup_error = repr(e)
    failures = [s for s in ctx.allgather_obj(cleanup_error) if s]
    if failures:
        raise RuntimeError(
            f"stale part cleanup failed on the primary: {failures[0]}")


def run_batch_predict(
    config: BatchPredictConfig,
    storage: Optional[Storage] = None,
    ctx: Optional[DeviceContext] = None,
) -> int:
    """Returns the number of predictions this process wrote."""
    ctx = ctx or DeviceContext.create()
    deployed = load_deployed_engine(
        ServerConfig(engine_variant=config.engine_variant), storage, ctx)
    serving = deployed.serving
    out_path = config.output_path
    if ctx.process_count > 1:
        lines = _slice_lines(config.input_path, ctx.process_index,
                             ctx.process_count)
        out_path = part_path(config.output_path, ctx.process_index)
        _remove_stale_parts(ctx, config.output_path)
    else:
        with open(config.input_path) as fin:
            lines = [line.strip() for line in fin if line.strip()]
    n = 0
    with open(out_path, "w") as fout:
        queries = [
            serving.supplement(bind_query(deployed.query_cls, json.loads(line)))
            for line in lines
        ]
        for start in range(0, len(queries), config.query_chunk):
            chunk = list(enumerate(queries[start:start + config.query_chunk]))
            per_query: list[list] = [[] for _ in chunk]
            for algo, model in zip(deployed.algorithms, deployed.models):
                for i, p in algo.batch_predict(model, chunk):
                    per_query[i].append(p)
            for (_, q), preds in zip(chunk, per_query):
                fout.write(json.dumps(to_jsonable(
                    serving.serve(q, preds), camelize_fields=True)) + "\n")
                n += 1
    logger.info("batch predict: %d queries → %s", n, out_path)
    return n
