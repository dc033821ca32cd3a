#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (incubator_predictionio_tpu_torch).

Run from the repo root on a machine with one NVIDIA card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (into ``build/kernels/``),
one ``nvcc`` a source, all started together, and holds each kernel against
its plain PyTorch version on the card at the shapes the serving paths give
it. Then it serves, through the port's QueryServer on the card, with weights
random from a seed:

- the recommendation engine at the width of the repo's ``retrieval_scale``
  bench configuration (rank 32, 10,000 users, a 1,000,000-item
  mixture-of-concepts catalog): exact serving runs kernel K1 (int8 catalog
  scorer), two-stage serving kernel K2 (int8 IVF coarse probe);
- the sequential template at the width of the repo's ``bench_sequential``
  configuration (vocab 10,000, d_model 512, 6 layers, 8 heads of 64):
  at ``max_len`` 512 every attention runs kernel K4 (small-head causal
  MHA), at ``max_len`` 1024 kernel K5 (causal flash attention).

Then it trains the sequential template on the card, through
``DataSource._build_fold`` and ``TransformerAlgorithm.train``, on
cycle-structured sessions from a seed: ``bench_sequential``'s full
configuration at ``max_len`` 512 (2,048 rows, batch 64, 2 epochs: 64
steps; K4 forward and backward), a one-step parity check of the kernels
against the plain attention on the card, and a deploy of the trained model
that answers queries; and the same widths at ``max_len`` 1024 (256 rows, 4
steps; K5 forward with statistics, its dk/dv and dq backward kernels, the
chunked cross-entropy). Before that it holds each backward kernel against
its plain version at the training shapes.

Then it streams live events into the served recommendation model, as the
repo's ``bench_streaming_freshness`` does: a ``StreamUpdater`` tails a
PIOLOG01 log written with the port's codec, folds each batch, archives each
delta and ships it over a real socket to the QueryServer's ``POST
/delta``, which builds the delta-applied engine beside the live one and
swaps it in: 8 rounds of 25 events (event-visible latency), then a backlog
of 8,000 (32 micro-batches, updater events/s), all under the default
``PIO_STREAM_FUSED=auto``, the host fused pass (no K3 launch); then a
second backlog of 8,000 under ``PIO_STREAM_FUSED=device``, each
micro-batch through kernel K3 (row-block adam) on the card. It holds K3
(and its table-resident form) against the plain version, the trainer's
state against a host replay, the answers after the stream against the
plain CPU path (exact) and the exact answers (two-stage), and the
replica's exactly-once checks. It measures the card's launch floor (the
device time of the smallest launch) beside the kernels.

Then ``rec-reload`` runs the query server's safety tier on the same
persisted instance A (exact, K1), through a sqlite copy of the store: a
deploy with 4 smoke queries on a ``FakeClock``; ``POST /reload`` to an
instance B (A's towers perturbed from ``default_rng(61)``) loaded beside
the live one, its answers held against the plain CPU path, A pinned for
probation; ``POST /rollback`` (A's answers bitwise, 409 once the window
has passed); a planted instance C whose algorithm raises, refused by the
smoke gate (409, the live answers bitwise unchanged); B again with its
dispatch failing, the serving breaker tripping inside probation and A
restored; a burst of 256 against an admission queue of 8 (429s with
``Retry-After``, every 200 A's live answer), 504 sheds past a budget on the
fake clock, a brownout in and out (each answer the last good one plus
``"degraded": true``); a drain begun by SIGTERM through
``install_signal_drain`` with a burst held in flight (those finish 200, new
queries 503); then ``python -m incubator_predictionio_tpu_torch.tools.cli
stream --once`` in its own process under ``PIO_STREAM_FUSED=device`` on a
backlog of 2,000 events from ``default_rng(67)`` (K3 in that process), its
delta gated, applied and pinned, the touched users' answers held against
the plain CPU path of the tables the updater's state holds. It prints
``torch.cuda.memory_allocated()`` before the reload, in probation and after
the rollback. Every serving phase ends with ``/health``'s serving and
algorithm breakers closed and no degraded answer besides the planted ones.

Then ``rec-obs`` reads the telemetry on the same instance A (exact, K1),
on the real clock: 4 bursts of 64 over the socket, 16 queries with a
seeded ``X-PIO-Trace`` (each echoed, each span found in
``/traces.json``), ``/metrics`` scraped before and after and parsed with
the port's strict parser (``pio_http_requests_total`` and the latency
histogram count every 200 sent; ``serve.batch`` counts one scope a batch
served and its four phases sum to within 10% of the scopes' wall), the
answers against the plain CPU path, ``pio_device_bytes_peak`` between
``torch.cuda.memory_allocated()`` and the card's total, one burst inside
``utils/tracing.py``'s ``profile_trace`` (K1's kernel and the
``serve.batch`` range in the written trace, K1's device time from it),
and the CLI ``metrics``, ``profile`` and ``status`` as processes against
the server. The other phase buckets are read where they run:
``train.fit`` and ``pio_training_mfu`` (equal to this script's MFU) after
rec-train's timed fit, ``stream.fold`` after the ``stream`` phase's
``device`` backlog, ``shard.search`` after ``rec-shard``, and
rec-workflow's CLI ``train`` runs with ``--profile-dir`` (its trace holds
the card's kernels).

Then it trains the recommendation template on the card. ``rec-train``
runs the repo's ``bench_recommendation_scaled`` configuration, not cut
(1,000,000 users, 100,000 items, rank 128, 4,000,000 events from
``default_rng(9)``, batch 65,536, 4 epochs = 248 steps, bf16 adam
moments), through ``TwoTowerMF.fit``: a warm-up fit, the timed fit (train
events/s, ``hbm_util`` and MFU by bench.py's formula), a 1-epoch fit whose
loss is recorded beside it, one step's device time by op, one step and a
3-epoch fit held against the CPU at cut sizes; then ``RecModel.save`` → ``load``
(tables bitwise) and a deploy of the device-resident model through the
QueryServer: exact answers through K1 at D 128 held against the plain CPU
path, two-stage answers through K2 (recall against exact printed), and K1
and K2 held against their plain versions at those shapes.
``rec-workflow`` runs the normal entry points in-process on sqlite
storage: CLI ``app new``, ``import`` of 100,050 events at the MovieLens-1M
shape, ``train`` on the card (its loss below a 1-iteration fit's),
deploy, queries over a socket held against numpy scoring of the trained
tables.

After ``rec-train``, ``rec-shard`` serves sharded (``PIO_SHARD_SERVE=1``,
``sharding/serve.py``): bench.py's ``sharded_serving`` lane at its own
widths (rank 32, 10,000 users, 150,000 clustered items from
``default_rng(13)``, batches of 16, nprobe 16) in four lanes — exact and
two-stage on one card, sharded exact and sharded two-stage from tables
resident on the card with ``min(8, cards)`` shards — the sharded exact
answers held bitwise against the single-card bf16 path for 256 queries,
the sharded two-stage recall@10 ≥ 0.95 with K2 launched once a shard a
batch, and a host model in four host blocks (four K2 probes on the card a
batch) held to the same floor; then rec-train's persisted model deployed
through ``RecModel.load`` and the QueryServer: its answers to 64 users
under each rule-mask kind bitwise the single-card bf16 path's, two-stage
with int8 per-shard IVF (recall@10 ≥ 0.95 probing every partition, K2 on
each shard's card), a ``POST /delta`` of 512 item and 512 user rows
rebuilding only the owning shards' blocks, its answers bitwise a fresh
sharded prepare's, no full-table gather, and socket bursts of 64 beside
the single-card int8 path. With ≥ 2 cards both run again over ``min(4,
cards)`` cards, with each card's scoring time and the merge's.

Between ``rec-train`` and ``rec-workflow``, ``rec-stream`` streams into rec-train's persisted
model, deployed resident on the card, through a storage whose EVENTDATA
is the ``eventlog`` backend: ``bench_streaming_freshness``'s traffic goes
in through ``EventLogEvents.insert_batch``, the updater's feed is
``resolve_feed_path``'s file, and the ``stream`` phase's rounds, backlogs
(K3 at D 129 under ``device``) and checks run at 1,000,000 × 100,000, rank
128. After the sequential training phases, ``seq-workflow`` runs the
sequential template through the CLI from stored events (``app new``,
``import`` of 2,048 users' cycle sessions of 16-128 ``view`` events,
``train`` at ``max_len`` 512 on the card, deploy), holds the sessions read
back from the store against the arrays, and each ``{"user": U}`` answer
against the ``recentItems`` answer of the same history; ``ckpt-resume``
interrupts a two-tower fit (rec-train's cut size) and a sequential fit
(seq-train512's widths, 256 rows), resumes each from its checkpoint, holds
the restored state bitwise against what was saved and the resumed fit
against an uninterrupted one, and times one checkpoint at rec-train's full
shape.

Last, the similar-product, recommended-user, e-commerce and classification
templates (no kernel of the repo lies on their paths: cuBLAS products,
elementwise passes and the two-tower trainer). ``sim-train`` runs
bench.py's ``bench_similarproduct`` configuration, not cut (10,000 x 10,000,
250,000 positives from ``default_rng(7)`` and 3 sampled negatives each,
rank 64, batch 65,536, 10 epochs) through ``TwoTowerMF.fit`` (a warm-up
fit, the timed fit, one step by op, a cut fit against the CPU), deploys
the cosine model through the QueryServer (queries of 1-5 items with the
category, white- and blackList filters: singles and a burst of 64, held
against the CPU path and against serial serving) and trains
``CooccurrenceAlgorithm`` on the positives, its top lists held exactly
against scipy's int64 ``Uᵀ U`` rounded to bf16. ``sim-workflow`` drives
the template through the CLI on sqlite (``als``, then ``likealgo`` on
like/dislike events), ``recuser-workflow`` the recommended-user template
(100,000 follows), ``ecomm`` bench.py's ``bench_ecommerce_retrieval``
configuration (serial ``predict`` against ``batch_predict``, bitwise, then
the same events through the CLI with the ALS fit on the card),
``cls-train`` bench.py's ``bench_classification`` configuration through
``MLPClassifier.fit`` (one step against the CPU) and ``cls-workflow`` the
classification template through the CLI (``mlp``; ``nb`` + ``mlp`` under
``vote``).

``pio eval`` runs through the CLI's ``eval`` verb on three of those
phases' stored events, each in its phase's directory: ``rec-eval`` after
``rec-workflow`` (RecommendationEvaluation over half the reference grid,
rank 16/32 × 5 iterations, 3 folds: 6 fits on the card, FastEvalEngine's
one read and one prepare, Precision@10 beside chance, variant 0 again on
the CPU), ``seq-eval`` after ``seq-workflow`` (SequentialEvaluation at the
sequential training width, 1 epoch × learning rate 1e-3/5e-3: K4
forward and backward in every fold's fit, the held-out queries checked
against the sessions, 16 queries with the kernels against the plain
attention) and ``cls-eval`` after ``cls-workflow`` (CompleteEvaluation
over the reference grid at 10 of its 60 epochs: accuracy and each label's
precision, ``best.json``, variant 0 on the CPU).

``rec-launch`` trains the recommendation template in two processes through
the CLI's ``launch -n 2 train``: 400,000 rate events (rec-train's widths,
rank 128 and 100,000 items, with users and events cut 10x) imported into
one sqlite file, each process reading its entity shard, staging its
batches and running the data-parallel fit over a ``torch.distributed``
group (gloo through the host when the processes share the card, NCCL with
a card each), process 0 alone writing the instance and the model. It holds
the shard reads, the one instance and blob, the replicas' equal digests
and a replay of both shards' global batches through the single-process
loop on the card, checks the fit's collectives on a one-process NCCL
group, then deploys the model through K1 (exact) and K2 (two-stage),
each path's answers held against its plain CPU path on the same model.
``rec-batchpredict`` scores 4,416 queries (known, black-listed and unknown
users) with that stored model through the CLI's ``batchpredict``, in one
process and under ``launch -n 2 batchpredict`` (part files), K1 at B 1024
held against its plain version first; the parts concatenated must equal
the one-process output. ``rec-supervised`` trains on rec-launch's store
under the fault-tolerant tier: a ``Supervisor`` runs ``train
--distributed`` as 2 members (gloo on one card; 3 epochs, a member-slice
checkpoint after each) as a control, then again with a new checkpoint
directory, SIGKILLing the highest rank once 2 epochs are committed: one
recovery, generation 2, the resumed fit's last leaves bitwise the
control's, one COMPLETED instance, a generation-1 zombie fenced, ``dist
status`` on the mesh, and the recovered model's K1 answers equal the
control's (with two cards, one more chaos run on NCCL, bitwise the gloo
control). ``rec-model``, after it, trains rec-launch's store over a
``model`` mesh axis: ``launch -n 2 train --mesh-axes '{"model": 2}'``,
two processes on one card (gloo), each holding half of each table and of
both adam moments; the persisted tables must be bitwise a one-process
replay of the same global batches from the two blocks concatenated, and
16 users' K1 answers through the QueryServer equal to the replay model's
(with two cards, the same launch over NCCL, bitwise the gloo run).
``rec-launch-eval`` runs ``launch -n 2 eval`` on
rec-workflow's stored events (sharded folds, data-parallel fits, one
EVALCOMPLETED row by process 0, each fold's query set against the one
computed from the events); ``seq-launch``, after ``seq-eval``, runs
``launch -n 2 train`` of the sequential template on seq-workflow's stored
sessions at its full width (K4 forward and backward in both processes,
one all-reduce of the gradients a step), replays both shards' batches in
one process (split into the processes' local batches, twice: two
identical fits on the card must end bitwise; and whole) against the
launched model, and serves it through K4 against the plain attention.
``seq-tp``, after it, imports the first 256 of seq-workflow's users'
sessions as app ``seqtp`` and trains them tensor-parallel at the full
width: ``launch -n 2 train --mesh-axes '{"model": 2}'`` with
``tensorParallel``, each process half of the attention and FFN
projections and 4 of the 8 heads through K4 forward and backward, 4
steps; its step losses held to a replicated fit in this process from the
same initial parameters, then a deploy and bursts through K4.
``seq-moe``, after it, trains a mixture of experts on the same app at the
full width with Switch-Base-8's routing (8 experts, capacity factor 1.25,
auxiliary weight 1e-2): one step with K4 against one with the plain
attention, the MoE layer on the card against the CPU, the layer over a
two-process ``expert`` line where the capacity drops tokens (factor 0.5)
held to the plain layer of the whole batch, a one-process fit
(4 steps, K4 forward and backward), then ``launch -n 2 train
--mesh-axes '{"expert": 2}'``: each process 4 of the 8 experts and 32 rows
of each batch (K4 at (32, 8, 512, 64) forward and backward), the kept
tokens' rows exchanged by two all-to-alls a layer over gloo; its step
losses and persisted parameters held to the one-process fit beside a
planted fault (one member's returned rows dropped) that the band must
catch (with two cards, the launch again over NCCL, bitwise the gloo
run); then a deploy and bursts through K4, each batch the server formed
held to the plain attention's forward of that batch (a mixture of
experts routes over its batch). ``seq-axes``, after it, trains over the
``seq`` and ``pipe`` mesh axes: two fresh processes over ``{"seq": 2}``
(both on the card over gloo; with two cards each on its own over NCCL)
run ring attention at ``bench_sequential``'s width and ``max_len``
1,024, 512 positions a process — the ring layer at (32, 1024, 8, 64)
held to the plain attention of the whole sequence on the card (output
and gradients), then a 2-step ring fit of seeded cycle sessions (batch
32, whole rows) held to a one-process fit in this process with local
attention on the plain attention from the same init, beside a planted
fault (the own chunk masked fully) the band must see, the replicas'
digests equal —; and, while those processes run, ``launch -n 2 train
--mesh-axes '{"pipe": 2}'`` on the first 128 of seq-workflow's users'
sessions (2 steps of 64) with ``pipelineStages`` 2 and 4 microbatches:
each process 3 of the 6 layers, K4 at (16, 8, 512, 64) forward and
backward, the handoffs through the port's point-to-point exchange; its
step losses and persisted parameters held to a one-process replay from
the same init on the same batches, then a deploy and a burst through K4.

``tpl-launch``, after ``cls-eval``, runs ``launch -n 2 train`` of the
similar-product (``als``, ``likealgo``, ``cooccurrence``),
recommended-user, e-commerce and classification (``nb`` + ``mlp`` under
``vote``) templates on the stores of their workflow phases, both
processes on the card over gloo: each process reads its shard, the
two-tower and MLP fits run data-parallel, the co-occurrence counts and the
naive Bayes moments are summed over the processes. It holds the shard
reads and the replicas, each launched model bitwise against the job
replayed in this process's threads, the co-occurrence lists against an
int64 oracle with each shard's counts rounded to bf16 before the sum, the
naive Bayes and MLP fits against one-process fits, and serves each
launched engine through the QueryServer; then ``launch -n 2 eval`` of the
classification template, its accuracy against cls-eval's.

Every check failure raises: the script catches nothing, and a non-zero exit
is the verdict. Its last line is one JSON object, ``{"ok": true, "device":
{...}}``; the line before it names the card and its power limit; a
``{"kernels": [...]}`` line before that gives each kernel's launches on the
main path, its error against the plain version and its times.
``chiprun_out/chip_smoke.json`` keeps the whole record.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import gc
import hashlib
import json
import logging
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

#: the reference's kernel tolerances (tests/test_retrieval_kernel.py:42, :291)
K1_TOL = 2e-2
K2_RTOL, K2_ATOL = 3e-7, 1e-6
#: K2's probe buckets held against its plain version, bitwise: the
#: smallest, the two-stage serving burst's and a large one
K2_BUCKETS = (8, 64, 256)
#: an H100 SXM's published peaks (NVIDIA data sheet, dense), at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12  # outside the tensor cores
RECALL_FLOOR = 0.95  # tests/test_two_stage_retrieval.py
N_USERS, N_ITEMS, RANK = 10_000, 1_000_000, 32
FACTORY = ("incubator_predictionio_tpu_torch.templates.recommendation."
           "RecommendationEngine")
#: the reference's attention tolerance (tests/test_small_head_attention.py:34,
#: tests/test_ring_attention.py:90)
ATT_TOL = 2e-2
#: bench.py bench_sequential's full-size configuration
SEQ_VOCAB, SEQ_D, SEQ_LAYERS, SEQ_HEADS = 10_000, 512, 6, 8
#: served scores of the kernel path vs the same model with the plain
#: attention versions, on the card: absolute, on bf16-valued scores
SEQ_SCORE_TOL = 2e-2
SEQ_FACTORY = ("incubator_predictionio_tpu_torch.templates.sequential."
               "SequentialEngine")
#: the reference's attention-gradient tolerance, relative to each
#: gradient's max abs (tests/test_small_head_attention.py:55-58)
GRAD_TOL = 2e-2
#: bench_sequential's full-size training (bench.py:897-898): rows, batch,
#: epochs, adam's default learning rate
TRAIN_ROWS, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_LR = 2048, 64, 2, 1e-3
#: the max_len 1024 training phase: the same widths, 4 steps
TRAIN_ROWS_1024, TRAIN_EPOCHS_1024 = 256, 1
#: one training step with the kernels against one with the plain attention
#: versions, on the card, from the same init: the loss, relative
STEP_LOSS_RTOL = 1e-2
#: K3's (R, D) checks: a fold micro-batch of 256 events at rank 32 touches
#: at most 512 rows of D 33; the others are the reference's test shapes
K3_SHAPES = ((1, 33), (37, 17), (265, 8), (512, 33), (4096, 33), (512, 129))
K3_MAIN = (512, 33)
#: the same micro-batch at rank 128 (D 129): rec-stream's, on rec-train's model
K3_REC = (512, 129)
#: the reference's band for its compiled adam engines
#: (tests/test_sparse_update.py:62-70), if K3 is not bitwise
K3_RTOL, K3_ATOL = 2e-5, 1e-7
#: bench.py bench_streaming_freshness (:3147-3150, :3196): 8 freshness
#: rounds of 25 events, a sustained backlog of 8,000, micro-batches of 256
STREAM_ROUNDS, STREAM_ROUND_EVENTS, STREAM_BACKLOG, STREAM_MICRO = 8, 25, 8000, 256
#: users of the backlog queried after the stream: all of them for the
#: two-stage recall, the first 16 against the plain CPU path
STREAM_EVAL_USERS, STREAM_CPU_USERS = 256, 16
#: the learning rate of the served model's config (the reference's default)
STREAM_LR = 3e-2
OUT = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke.json"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, inner: int = 5, warm: int = 3) -> float:
    """Time of one call as the card sees it: CUDA events around ``inner``
    back-to-back calls, divided by ``inner``; the median over ``reps`` such
    runs. For a kernel shorter than its wrapper's host work this is the
    host's enqueue rate (:func:`device_ms` gives the kernel alone)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


@contextlib.contextmanager
def cuda_profile():
    """Profile the block's CUDA activity with ``torch.profiler`` (CUPTI sees
    every kernel and copy of the process, whichever thread launched it).
    The yielded dict is filled on exit: device ms by kernel or copy name,
    summed over the block."""
    from torch.profiler import ProfilerActivity, profile

    by_name: dict[str, float] = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield by_name
        torch.cuda.synchronize()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3


def busy_record(by_name: dict, wall_s: float, top: int) -> dict:
    """The device's busy share of a profiled wall time, the ``top`` names
    by device ms, and the device ms of each attention kernel that ran
    (:data:`KERNEL_SYMBOLS`, with K4's backward also by its two kernels)."""
    busy = sum(by_name.values())
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3),
            "top_device_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top]),
            "attention_device_ms": {
                w: sum(t for n, t in by_name.items() if sym in n)
                for w, sym in {**KERNEL_SYMBOLS, **K4_BWD_PART_SYMBOLS}.items()
                if any(sym in n for n in by_name)}}


def device_busy(fn, calls: int = 3):
    """Device time per call of everything ``fn`` runs on the card (every
    kernel and copy), from ``torch.profiler``, and the time by name. Every
    ``fn`` given here launches work on the card, so a profiled run that
    comes back with no record at all (seen on the H100 machine) is run
    again, up to three runs in all."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with cuda_profile() as by_name:
            for _ in range(calls):
                fn()
        if by_name:
            break
    by_name = {n: t / calls for n, t in by_name.items()}
    return sum(by_name.values()), by_name


def device_ms(fn, kernel: str, calls: int = 20):
    """Device time a call of the CUDA kernels whose names contain
    ``kernel`` (a wrapper may launch more than one), from ``torch.profiler``
    — without the host time of the Python wrapper that back-to-back timing
    of a tiny kernel measures. None when the profiler recorded no such
    kernel (in :func:`device_ms_of`'s repeated runs)."""
    return device_ms_of(fn, [kernel], calls)[kernel]


def device_ms_of(fn, symbols, calls: int = 5, tries: int = 3) -> dict:
    """Device time a call of the kernels whose names contain each of
    ``symbols``, all from one profiled run of ``fn`` (a wrapper may launch
    several kernels). On the H100 machine the profiler came back from a
    run with no record of a kernel that had run (once one of K4's two
    backward kernels, once every kernel of the run), so a run that misses a
    symbol is repeated, up to ``tries`` runs in all, and each repeat is
    logged; a symbol still missing maps to None."""
    for attempt in range(tries):
        _, by_name = device_busy(fn, calls)
        got = {s: (sum(t for n, t in by_name.items() if s in n)
                   if any(s in n for n in by_name) else None) for s in symbols}
        if all(v is not None for v in got.values()):
            break
        log(f"profiler run {attempt + 1} of {tries} saw no "
            f"{[s for s, v in got.items() if v is None]}; kernels seen: "
            f"{sorted(n[:48] for n in by_name)}")
    return got


def bound(n_bytes: float, n_ops: float):
    """The least time of the work on the card: (ms, "bytes" or
    "operations"), against the data sheet's HBM rate and bf16 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def pct(xs, p):
    return float(np.percentile(np.asarray(xs) * 1e3, p)) if xs else None


def max_err_with_infs(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want| over the finite entries; the -inf entries (masked
    and padded items) must sit at the same places."""
    fin = torch.isfinite(want)
    check(bool((torch.isfinite(got) == fin).all()), "non-finite entries differ")
    check(bool((got[~fin] == want[~fin]).all()), "masked entries differ")
    return float((got[fin] - want[fin]).abs().max())


# -- the model of the bench's retrieval_scale lane ---------------------------

def towers():
    """bench.py bench_retrieval_scale at 1M items: √N concepts, σ 0.5,
    default_rng(11) — the clustered geometry trained factors have."""
    rng = np.random.default_rng(11)
    n_concepts = max(64, int(round(np.sqrt(N_ITEMS))))
    concepts = rng.standard_normal((n_concepts, RANK)).astype(np.float32)
    item = concepts[rng.integers(0, n_concepts, N_ITEMS)] \
        + 0.5 * rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    user = concepts[rng.integers(0, n_concepts, N_USERS)] \
        + 0.5 * rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    user_bias = (rng.standard_normal(N_USERS) * 0.1).astype(np.float32)
    item_bias = (rng.standard_normal(N_ITEMS) * 0.1).astype(np.float32)
    eval_users = rng.integers(0, N_USERS, 256)
    return user, item, user_bias, item_bias, eval_users


# -- phase 3: each kernel against its plain version ---------------------------

def k1_case(R, q, items_q, scales, bias, mask, row_mask=None):
    b, d = q.shape
    n = items_q.shape[0]
    got = R.score_catalog_quantized(q, items_q, scales, bias, mask, row_mask)
    want = R.score_catalog_reference(q, items_q, scales, bias, mask, row_mask)
    torch.cuda.synchronize()
    err = max_err_with_infs(got, want)
    check(err <= K1_TOL, f"K1 B={b} N={n} D={d}: max abs err {err} > {K1_TOL}")
    out = {"B": b, "N": n, "D": d, "row_mask": row_mask is not None,
           "max_abs_err": err, "tolerance": K1_TOL}
    del got, want
    out["ms"] = time_ms(lambda: R.score_catalog_quantized(
        q, items_q, scales, bias, mask, row_mask))
    out["device_ms"] = device_ms(lambda: R.score_catalog_quantized(
        q, items_q, scales, bias, mask, row_mask),
        RETRIEVAL_SYMBOLS["score_catalog_quantized"])
    out["plain_ms"] = time_ms(lambda: R.score_catalog_reference(
        q, items_q, scales, bias, mask, row_mask))
    # library yardstick: one fp32 matmul over the dequantized operands, its
    # device time as the kernel's (its CUDA-event time beside it)
    qf = q.to(torch.bfloat16).float()
    deq_t = (items_q.float() * scales[:, None]).T.contiguous()
    out["library_event_ms"] = time_ms(lambda: torch.matmul(qf, deq_t))
    out["library_ms"] = device_busy(lambda: torch.matmul(qf, deq_t), calls=5)[0]
    del qf, deq_t
    nbytes = (b * d * 4 + n * d + 3 * n * 4 + b * n * 4
              + (b * n * 4 if row_mask is not None else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * n * d / BF16_OPS_PER_S * 1e3
    out["bound_ms"] = max(t_bytes, t_ops)
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"K1 B={b:<4d} N={n} D={d:<3d} row_mask={row_mask is not None!s:<5} "
        f"max_abs_err={err:.3e} (tol {K1_TOL}) ms={out['ms']:.4f} "
        f"device_ms={fmt(out['device_ms'])} "
        f"plain_ms={out['plain_ms']:.4f} matmul_device_ms={out['library_ms']:.4f} "
        f"matmul_ms={out['library_event_ms']:.4f} bound_ms={out['bound_ms']:.4f}")
    return out


def k2_case(R, q_q, q_s, cq, cs, cb):
    b, d = q_q.shape
    c = cq.shape[0]
    got = R.score_centroids_quantized(q_q, q_s, cq, cs, cb)
    want = R.score_centroids_reference(q_q, q_s, cq, cs, cb)
    torch.cuda.synchronize()
    err = max_err_with_infs(got, want)
    fin = torch.isfinite(want)
    check(bool(((got[fin] - want[fin]).abs()
                <= K2_ATOL + K2_RTOL * want[fin].abs()).all()),
          f"K2 B={b} C={c} D={d}: max abs err {err} beyond rtol {K2_RTOL} "
          f"atol {K2_ATOL}")
    out = {"B": b, "C": c, "D": d, "max_abs_err": err,
           "tolerance": {"rtol": K2_RTOL, "atol": K2_ATOL},
           "bitwise_equal": got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()}
    check(out["bitwise_equal"], f"K2 B={b} C={c} D={d}: not bitwise equal to "
          f"its plain version (max abs err {err})")
    out["ms"] = time_ms(lambda: R.score_centroids_quantized(q_q, q_s, cq, cs, cb))
    out["device_ms"] = device_ms(lambda: R.score_centroids_quantized(
        q_q, q_s, cq, cs, cb), RETRIEVAL_SYMBOLS["score_centroids_quantized"])
    out["plain_ms"] = time_ms(lambda: R.score_centroids_reference(
        q_q, q_s, cq, cs, cb))
    qf, cf_t = q_q.float(), cq.float().T.contiguous()
    out["library_event_ms"] = time_ms(lambda: torch.matmul(qf, cf_t))
    out["library_ms"] = device_busy(lambda: torch.matmul(qf, cf_t), calls=5)[0]
    nbytes = b * d + b * 4 + c * d + 2 * c * 4 + b * c * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * c * d / INT8_OPS_PER_S * 1e3
    out["bound_ms"] = max(t_bytes, t_ops)
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"K2 B={b:<4d} C={c} D={d:<3d} max_abs_err={err:.3e} "
        f"(rtol {K2_RTOL}, atol {K2_ATOL}) bitwise={out['bitwise_equal']} "
        f"ms={out['ms']:.4f} device_ms={fmt(out['device_ms'])} "
        f"plain_ms={out['plain_ms']:.4f} matmul_device_ms={out['library_ms']:.4f} "
        f"matmul_ms={out['library_event_ms']:.4f} bound_ms={out['bound_ms']:.6f}")
    return out


def kernel_checks(R, user, item, item_bias, ivf, dev):
    """K1 at the exact path's shapes (D 32, N 1,000,448, B 1/8/64/128/256 —
    the serving buckets' ladder up to the top bucket — and the row-mask
    variant at B 8 and 64), at the recommendation_scaled width (D 128, N
    100,352) and at a D that is not a multiple of 16 (D 40, N 100,352); K2
    at the coarse probe's (D 32, C 1024, the probe buckets
    :data:`K2_BUCKETS`). The catalog is the served one, quantized on the
    card."""
    items_q, scales, bias, mask = R.quantize_catalog_device(
        torch.from_numpy(item).to(dev), torch.from_numpy(item_bias).to(dev))
    hq, hs = R.quantize_rows(item)
    check(np.array_equal(items_q[:N_ITEMS].cpu().numpy(), hq)
          and np.array_equal(scales[:N_ITEMS].cpu().numpy(), hs),
          "device quantization differs from quantize_rows")
    log("quantize_catalog_device == quantize_rows bitwise on the served catalog")
    users = torch.from_numpy(user[:256]).to(dev)
    k1 = []
    for b in (1, 8, 64, 128, 256):
        k1.append(k1_case(R, users[:b].contiguous(), items_q, scales, bias, mask))
    rng = np.random.default_rng(5)
    for b in (8, 64):
        rm = np.zeros((b, items_q.shape[0]), np.float32)
        rm[np.arange(b)[:, None], rng.integers(0, N_ITEMS, (b, 16))] = -np.inf
        k1.append(k1_case(R, users[:b].contiguous(), items_q, scales, bias, mask,
                          torch.from_numpy(rm).to(dev)))
        del rm
    n_small = 100_000
    for d in (128, 40):
        it = rng.standard_normal((n_small, d)).astype(np.float32)
        qd = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32)).to(dev)
        k1.append(k1_case(R, qd, *R.quantize_catalog_device(
            torch.from_numpy(it).to(dev),
            torch.from_numpy(rng.standard_normal(n_small).astype(np.float32)).to(dev))))
    cent_q, cent_s = R.quantize_rows(np.asarray(ivf.centroids[:, :-1], np.float32))
    cq, cs, cb = (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for v in R.pad_centroids(
                      cent_q, cent_s, np.asarray(ivf.centroids[:, -1], np.float32)))
    k2 = []
    for b in K2_BUCKETS:
        q_q, q_s = R.quantize_rows(user[:b])
        k2.append(k2_case(R, torch.from_numpy(q_q).to(dev),
                          torch.from_numpy(q_s).to(dev), cq, cs, cb))
    del items_q, scales, bias, mask
    return k1, k2


def topk_tie_check(dev) -> dict:
    """The device top-k of both device paths (int8 through K1,
    ``_topk_quantized``; bf16, ``_topk_scores``) on a catalog above the
    host path's size, with constructed ties, against a numpy lexsort on
    (-score, index) over the same scores — ``jax.lax.top_k``'s answer.
    Ties: every item row is one of 25,000 rows drawn with repeats (equal
    rows score bitwise equal), and an exclude set that leaves 25 items
    unmasked for a top-40 (15 places at -inf). Also the repair's cost:
    device ms of the ordered top-k against ``torch.topk`` alone on the
    exact burst's shape."""
    from incubator_predictionio_tpu_torch.models import two_tower as T
    from incubator_predictionio_tpu_torch.ops import retrieval as R

    rng = np.random.default_rng(21)
    n_items, b = 100_000, 64  # 3.3M table elements: above the host path's 2M
    rows = rng.integers(0, n_items // 4, n_items)
    base = rng.standard_normal((n_items // 4, RANK)).astype(np.float32)
    base_bias = (rng.standard_normal(n_items // 4) * 0.1).astype(np.float32)
    model = T.TwoTowerModel(
        user_emb=rng.standard_normal((b, RANK)).astype(np.float32),
        item_emb=base[rows], user_bias=np.zeros(b, np.float32),
        item_bias=base_bias[rows], mean=3.0, config=T.TwoTowerConfig(rank=RANK))
    keep = rng.choice(n_items, 25, replace=False)
    excluded = np.setdiff1d(np.arange(n_items), keep)
    uidx = torch.arange(b, device=dev)
    out = {"n_items": n_items, "batch": b, "cases": []}
    for quantize in (True, False):
        model.prepare_for_serving(quantize=quantize, host_max_elements=None,
                                  build_index=False, device=dev)
        path = model.serving_info()["path"]
        check(path == ("device-int8" if quantize else "device-bf16"),
              f"tie check not on the device path: {path}")
        ue, ub = model._device_users
        for num, exclude in ((10, None), (40, excluded)):
            if quantize:
                items_q, scales, bias, mask = model._device_items_q
            else:
                item_t, item_b, mask = model._device_items
            if exclude is not None:
                m = np.zeros(mask.shape[0], np.float32)
                m[exclude] = -np.inf
                mask = mask + torch.from_numpy(m).to(dev)
            if quantize:
                idx, vals = T._topk_quantized(uidx, ue, ub, items_q, scales, bias,
                                              mask, None, model.mean, num, n_items)
                scores = R.score_catalog_quantized(ue[uidx].float(), items_q, scales,
                                                   bias, mask, None)
                scores = scores.add_(ub[uidx][:, None]).add_(model.mean)[:, :n_items]
            else:
                idx, vals = T._topk_scores(uidx, ue, ub, item_t, item_b, model.mean,
                                           mask, None, num)
                scores = T._exact_scores(ue[uidx], ub[uidx], item_t, item_b,
                                         model.mean, mask, None)
            s = scores.cpu().numpy()
            idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
            bad = 0
            ties = 0
            for r in range(b):
                want = np.lexsort((np.arange(n_items), -s[r]))[:num]
                bad += not (np.array_equal(idx[r], want)
                            and np.array_equal(vals[r], s[r][want]))
                ties += int((s[r] == s[r][want[-1]]).sum() > 1)
            check(bad == 0, f"device top-k ({path}, num {num}): {bad} rows differ "
                  "from lax.top_k's order")
            check(ties > 0, f"tie check ({path}, num {num}): no tie at the k-th place")
            out["cases"].append({"path": path, "num": num,
                                 "excluded": 0 if exclude is None else len(exclude),
                                 "rows_tied_at_kth": ties, "rows_differing": bad})
            log(f"device top-k {path} num={num} excluded="
                f"{0 if exclude is None else len(exclude)}: {b} rows equal the "
                f"lexsort oracle ({ties} tied at the k-th place)")
    del model
    from incubator_predictionio_tpu_torch.models.two_tower import _top_k

    s = torch.randn((64, N_ITEMS), device=dev)
    out["torch_topk_device_ms"] = device_busy(lambda: torch.topk(s, 10, dim=1), 5)[0]
    out["ordered_top_k_device_ms"] = device_busy(lambda: _top_k(s, 10), 5)[0]
    log(f"top-k of [64, {N_ITEMS}], k 10, device ms: torch.topk "
        f"{out['torch_topk_device_ms']:.4f}, in lax.top_k's order "
        f"{out['ordered_top_k_device_ms']:.4f}")
    return out


#: (B, H, L, D) of each attention case: the serving batches (1, 8, 64) at
#: the sequential phases' lengths, the reference's other shapes,
#: seq-tp's training shape (a process's 4 of the 8 heads), seq-moe's
#: (an expert line's member: 32 of the batch's 64 rows) and seq-axes'
#: pipe (a microbatch: 16 of the batch's 64 rows)
K4_SHAPES = ((1, 8, 512, 64), (8, 8, 512, 64), (64, 8, 512, 64),
             (3, 8, 128, 128), (8, 8, 192, 64), (64, 4, 512, 64),
             (32, 8, 512, 64), (16, 8, 512, 64))
#: K5's also (B, H, L, D, block) where the block is not the reference's
#: flash block: L 576 gives the kernel a ragged last 128-row query tile
K5_SHAPES = ((64, 8, 1024, 64), (8, 8, 768, 64), (8, 8, 640, 32),
             (8, 8, 512, 32), (8, 8, 576, 64, 64))
#: K1's and K2's symbols in the profiler's kernel names (csrc/retrieval.cu)
RETRIEVAL_SYMBOLS = {"score_catalog_quantized": "score_catalog_kernel",
                     "score_centroids_quantized": "score_centroids_kernel"}
#: K3's symbol (csrc/sparse_update.cu): both entries, stacked and indexed,
#: launch the one kernel template
SPARSE_SYMBOLS = {"adam_rows": "adam_rows_kernel",
                  "adam_rows_indexed": "adam_rows_kernel"}
#: each kernel wrapper's symbol in the profiler's kernel names (K4's in
#: csrc/attention.cu, K5's in csrc/flash_attention.cu; none is part of a
#: name in the other source)
KERNEL_SYMBOLS = {"causal_mha_small_head": "small_head_fwd_kernel",
                  "flash_causal_attention": "flash_fwd_kernel",
                  "causal_mha_small_head_bwd": "small_head_bwd_",
                  "flash_causal_attention_bwd_dkv": "flash_bwd_dkv_kernel",
                  "flash_causal_attention_bwd_dq": "flash_bwd_dq_kernel"}
#: the two kernels of K4's backward wrapper: dq (with the row term's walk),
#: then dk/dv
K4_BWD_PART_SYMBOLS = {"causal_mha_small_head_bwd_dq": "small_head_bwd_dq_kernel",
                       "causal_mha_small_head_bwd_dkv": "small_head_bwd_dkv_kernel"}


def attention_case(A, name, shape, seed):
    """One attention kernel against its plain version on the same bf16
    tensors of the card (tolerance :data:`ATT_TOL`, absolute and relative,
    as the reference's kernel tests), with its times beside the bound and
    ``scaled_dot_product_attention`` as the library yardstick (its device
    time, as the kernel's; its CUDA-event time beside it)."""
    from incubator_predictionio_tpu_torch.parallel.ring import flash_block_size

    b, h, l, d = shape[:4]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    if name == "causal_mha_small_head":
        kernel = lambda: A.causal_mha_small_head(q, k, v)  # noqa: E731
        plain = lambda: A.causal_mha_small_head_reference(q, k, v)  # noqa: E731
    else:
        block = shape[4] if len(shape) > 4 else flash_block_size(l)
        kernel = lambda: A.flash_causal_attention(q, k, v, block)  # noqa: E731
        plain = lambda: A.flash_causal_attention_reference(q, k, v, block)  # noqa: E731
    got, want = kernel().float(), plain().float()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite output")
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= ATT_TOL + ATT_TOL * want.abs()).all())
    check(ok, f"{name} {shape}: max abs err {err} beyond {ATT_TOL}")
    del got, want
    out = {"B": b, "H": h, "L": l, "D": d, "max_abs_err": err,
           "tolerance": ATT_TOL}
    if name != "causal_mha_small_head":
        out["block"] = block
    out["ms"] = time_ms(kernel, reps=5, inner=3)
    out["device_ms"] = device_ms(kernel, KERNEL_SYMBOLS[name], calls=5)
    check(out["device_ms"] is not None,
          f"{name} {shape}: the profiler saw no {KERNEL_SYMBOLS[name]}")
    out["plain_ms"] = time_ms(plain, reps=3, inner=2, warm=1)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True)
    out["library_event_ms"] = time_ms(sdpa, reps=5, inner=3)
    out["library_ms"] = device_busy(sdpa, calls=5)[0]
    # the causal half: q·kᵀ and p·v over L²/2 entries
    t_ops = 4.0 * b * h * l * l * d / 2 / BF16_OPS_PER_S * 1e3
    t_bytes = 4.0 * b * h * l * d * 2 / HBM_BYTES_PER_S * 1e3
    out["bound_ms"] = max(t_ops, t_bytes)
    out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"{name:<22s} B={b:<3d} H={h} L={l:<5d} D={d:<4d} max_abs_err={err:.3e} "
        f"(tol {ATT_TOL}) ms={out['ms']:.4f} device_ms={fmt(out['device_ms'])} "
        f"plain_ms={out['plain_ms']:.4f} sdpa_device_ms={out['library_ms']:.4f} "
        f"sdpa_ms={out['library_event_ms']:.4f} bound_ms={out['bound_ms']:.4f}")
    return out


def attention_checks(A):
    k4 = [attention_case(A, "causal_mha_small_head", s, 100 + i)
          for i, s in enumerate(K4_SHAPES)]
    k5 = [attention_case(A, "flash_causal_attention", s, 200 + i)
          for i, s in enumerate(K5_SHAPES)]
    gc.collect()
    torch.cuda.empty_cache()
    return k4, k5


#: (B, H, L, D) of each K4 backward case and (B, H, L, D, block) of each
#: K5 one: the training shapes at max_len 512 and 1024, and the
#: reference's other head width; L 192 (K4) and 576 (K5) give the kernels
#: a ragged last 128-row query tile; H 4 is seq-tp's, a process's half of
#: the heads; B 32 is seq-moe's, an expert line's member's half of the
#: rows; B 16 is seq-axes' pipe microbatch
K4_BWD_SHAPES = ((64, 8, 512, 64), (3, 8, 128, 128), (8, 8, 192, 64),
                 (64, 4, 512, 64), (32, 8, 512, 64), (16, 8, 512, 64))
K5_BWD_SHAPES = ((64, 8, 1024, 64, 512), (2, 8, 256, 128, 256),
                 (8, 8, 576, 64, 64))


def sdpa_bwd_ms(q, k, v, do) -> float:
    """Device time of the backward of ``scaled_dot_product_attention(
    is_causal=True)`` on these inputs (the library yardstick, used nowhere
    in the port): the profiler's device time of forward + backward less
    that of the forward alone, both with gradients wanted."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    fwd, _ = device_busy(lambda: sdpa(qr, kr, vr, is_causal=True))
    both, _ = device_busy(lambda: torch.autograd.grad(
        sdpa(qr, kr, vr, is_causal=True), (qr, kr, vr), do))
    return both - fwd


def grad_errors(got, want):
    """Max abs error of each of (dq, dk, dv) against the plain backward,
    and the same relative to the plain gradient's max abs."""
    out = {}
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(g.float()).all()), f"{n}: non-finite")
        err = float((g.float() - w.float()).abs().max())
        out[n] = (err, err / float(w.float().abs().max()))
    return out


def attention_bwd_case(A, name, shape, seed):
    """One backward kernel against its plain backward on the same bf16
    tensors of the card (:data:`GRAD_TOL` of each gradient's max abs), with
    its times beside its bound and SDPA's backward. The forward's
    statistics come from the forward kernel with statistics, whose output
    must be bitwise the serving kernel's."""
    b, h, l, d = shape[:4]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, l, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    bhld, bhl2d, bhl = b * h * l * d, b * h * l * l * d, b * h * l
    out = {"B": b, "H": h, "L": l, "D": d, "tolerance": GRAD_TOL}
    if name == "causal_mha_small_head_bwd":
        o_serve = A.causal_mha_small_head(q, k, v)
        o, m, l_sum = A.causal_mha_small_head_with_stats(q, k, v)
    else:
        block = out["block"] = shape[4]
        o_serve = A.flash_causal_attention(q, k, v, block)
        o, m, l_sum = A.flash_causal_attention_with_stats(q, k, v, block)
    torch.cuda.synchronize()
    out["o_bitwise_with_stats"] = bool(torch.equal(o, o_serve))
    check(out["o_bitwise_with_stats"], f"{name} {shape}: the forward's output "
          "with statistics differs from the serving kernel's")
    # bytes of the whole backward: q, k, v, do in, dq, dk, dv out, m and l
    # in; 5 matmuls over the causal half
    out["bwd_bound_ms"], out["bwd_bound_by"] = bound(7 * bhld * 2 + 2 * bhl * 4,
                                                     5 * bhl2d)
    if name == "causal_mha_small_head_bwd":
        errs = grad_errors(A.causal_mha_small_head_bwd(q, k, v, do, m, l_sum),
                           A.causal_mha_small_head_bwd_reference(q, k, v, do))
        plain = lambda: A.causal_mha_small_head_bwd_reference(q, k, v, do)  # noqa: E731
        parts = {name: (lambda: A.causal_mha_small_head_bwd(q, k, v, do, m, l_sum),
                        plain, 7 * bhld * 2 + 2 * bhl * 4, 5 * bhl2d)}
        # its kernels' work: dq and the row term (reads q, k, v, do, m, l;
        # writes dq, t), then dk and dv (reads q, k, v, do, m, l, t)
        split = {"causal_mha_small_head_bwd_dq": (5 * bhld * 2 + 3 * bhl * 4, 3 * bhl2d),
                 "causal_mha_small_head_bwd_dkv": (6 * bhld * 2 + 3 * bhl * 4, 4 * bhl2d)}
    else:
        di = (o.float() * do.float()).sum(-1)
        errs = grad_errors(
            A.flash_causal_attention_bwd(q, k, v, o, do, m, l_sum, block),
            A.flash_causal_attention_bwd_reference(q, k, v, o, do, m, l_sum, block))
        plain = lambda: A.flash_causal_attention_bwd_reference(  # noqa: E731
            q, k, v, o, do, m, l_sum, block)
        stats = 3 * bhl * 4
        args = (q, k, v, do, m, l_sum, di, block)
        parts = {
            "flash_causal_attention_bwd_dkv": (
                lambda: A.flash_causal_attention_bwd_dkv(*args),
                lambda: A.flash_causal_attention_bwd_dkv_reference(*args),
                6 * bhld * 2 + stats, 4 * bhl2d),
            "flash_causal_attention_bwd_dq": (
                lambda: A.flash_causal_attention_bwd_dq(*args),
                lambda: A.flash_causal_attention_bwd_dq_reference(*args),
                5 * bhld * 2 + stats, 3 * bhl2d)}
    torch.cuda.synchronize()
    out["errors"] = {n: {"max_abs_err": e, "rel_err": r} for n, (e, r) in errs.items()}
    out["max_abs_err"] = max(e for e, _ in errs.values())
    worst = max(r for _, r in errs.values())
    check(worst <= GRAD_TOL, f"{name} {shape}: gradient error {worst} of the "
          f"max abs beyond {GRAD_TOL}")
    # the whole backward (dq, dk, dv): plain, and SDPA's as the library
    out["plain_ms"] = time_ms(plain, reps=3, inner=1, warm=1)
    out["library_ms"] = sdpa_bwd_ms(q, k, v, do)
    out["kernels"] = {}
    for part, (fn, part_plain, n_bytes, n_ops) in parts.items():
        # K4's one wrapper: its two kernels from the same profiled runs
        syms = [KERNEL_SYMBOLS[part]] + (list(K4_BWD_PART_SYMBOLS.values())
                                         if part == "causal_mha_small_head_bwd" else [])
        seen = device_ms_of(fn, syms)
        rec = {"ms": time_ms(fn, reps=5, inner=3),
               "device_ms": seen[KERNEL_SYMBOLS[part]],
               # one kernel's part alone: no library call computes only it
               "plain_ms": (out["plain_ms"] if len(parts) == 1
                            else time_ms(part_plain, reps=3, inner=1, warm=1)),
               "library_ms": out["library_ms"] if len(parts) == 1 else None}
        check(rec["device_ms"] is not None,
              f"{part} {shape}: the profiler saw no {KERNEL_SYMBOLS[part]}")
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, n_ops)
        out["kernels"][part] = rec
        log(f"{part:<31s} B={b:<3d} H={h} L={l:<5d} D={d:<4d} "
            + " ".join(f"{n}_err={e:.3e}({r:.1e})" for n, (e, r) in errs.items())
            + f" ms={rec['ms']:.4f} device_ms={fmt(rec['device_ms'])} "
            f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
            f"({rec['bound_by']})")
        if part == "causal_mha_small_head_bwd":
            # one wrapper, two kernels: each one's device time by its symbol
            rec["parts"] = {}
            for sub, sym in K4_BWD_PART_SYMBOLS.items():
                check(seen[sym] is not None, f"{sub} {shape}: the profiler saw no {sym}")
                b_ms, b_by = bound(*split[sub])
                rec["parts"][sub] = {"device_ms": seen[sym], "bound_ms": b_ms,
                                     "bound_by": b_by}
                log(f"{sub:<31s} B={b:<3d} H={h} L={l:<5d} D={d:<4d} "
                    f"device_ms={seen[sym]:.4f} bound_ms={b_ms:.4f} ({b_by})")
    recs = out["kernels"].values()
    out["bwd_device_ms"] = (None if any(r["device_ms"] is None for r in recs)
                            else sum(r["device_ms"] for r in recs))
    log(f"{name:<31s} whole backward: device_ms={fmt(out['bwd_device_ms'])} "
        f"plain_ms={out['plain_ms']:.4f} sdpa_bwd_ms={out['library_ms']:.4f} "
        f"bound_ms={out['bwd_bound_ms']:.4f} ({out['bwd_bound_by']})")
    del q, k, v, do
    return out


def attention_bwd_checks(A):
    k4 = [attention_bwd_case(A, "causal_mha_small_head_bwd", s, 300 + i)
          for i, s in enumerate(K4_BWD_SHAPES)]
    k5 = [attention_bwd_case(A, "flash_causal_attention_bwd", s, 400 + i)
          for i, s in enumerate(K5_BWD_SHAPES)]
    gc.collect()
    torch.cuda.empty_cache()
    return k4, k5


# -- phase 4: the main path through the QueryServer ---------------------------

@contextlib.contextmanager
def retrieval_mode(mode: str):
    """PIO_RETRIEVAL_MODE for one phase, restored after it."""
    prev = os.environ.get("PIO_RETRIEVAL_MODE")
    os.environ["PIO_RETRIEVAL_MODE"] = mode
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("PIO_RETRIEVAL_MODE")
        else:
            os.environ["PIO_RETRIEVAL_MODE"] = prev


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def post_all(session, url, payloads, concurrent: bool):
    """POST each payload; returns (bodies, latencies in s). All must be 200
    live answers: a degraded one (the server's fallback when the predict
    path fails, e.g. a kernel that does not launch) fails the check."""
    async def one(p):
        t0 = time.perf_counter()
        async with session.post(url, json=p) as resp:
            body = await resp.json()
            check(resp.status == 200, f"status {resp.status} for {p}: {body}")
            check(not (isinstance(body, dict) and body.get("degraded")),
                  f"a degraded answer for {p}: {body}")
        return body, time.perf_counter() - t0

    if concurrent:
        got = await asyncio.gather(*[one(p) for p in payloads])
    else:
        got = [await one(p) for p in payloads]
    return [g[0] for g in got], [g[1] for g in got]


async def profiled_burst(session, url, payloads) -> dict:
    """One concurrent burst under :func:`cuda_profile` (it sees the
    serving threads' kernels too): the device's busy share of the burst's
    wall time and the device time by kernel name. The profiler's host cost
    is inside the wall time, so the share is a lower bound."""
    with cuda_profile() as by_name:
        t0 = time.perf_counter()
        await post_all(session, url, payloads, True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"queries": len(payloads), **busy_record(by_name, wall, 6)}


def log_window(name: str, w: dict) -> None:
    log(f"[{name}] profiled burst of {w['queries']}: wall {w['wall_ms']:.2f} ms, "
        f"device busy {w['device_busy_ms']:.3f} ms "
        f"(share {w['device_busy_share']:.4f}); attention kernels' device ms: "
        + ", ".join(f"{k}={v:.3f}" for k, v in w["attention_device_ms"].items())
        + "; top device ms: "
        + ", ".join(f"{k[:60]}={v:.3f}" for k, v in w["top_device_ms"].items()))


def ids_of(body) -> list[str]:
    return [s["item"] for s in body["itemScores"]]


async def serving_verdict(session, base, tag, planted=0) -> int:
    """``GET /health`` at the end of a phase that serves: the serving and
    every algorithm breaker closed, and no degraded answer beyond the
    ``planted`` ones (a kernel that fails to launch trips the algorithm
    breaker, and the server would answer degraded 200s). Returns the
    degraded count."""
    async with session.get(f"{base}/health") as resp:
        h = await resp.json()
    states = {"serving": h["servingBreaker"]["state"],
              **{k: v["state"] for k, v in h["algorithmBreakers"].items()}}
    check(all(v == "closed" for v in states.values()),
          f"[{tag}] breakers at the phase's end: {states}")
    n = h["degradedResponses"]
    check(n == planted, f"[{tag}] {n} degraded answers ({planted} planted)")
    log(f"[{tag}] degraded answers: {n} ({planted} planted); breakers "
        f"closed: {sorted(states)}")
    return n


async def serve_phase(name, variant_path, storage, ctx, body_fn):
    """Deploy a QueryServer (prepare + warmup run in its constructor), run
    ``body_fn(session, url, server)``, shut it down."""
    from incubator_predictionio_tpu_torch.server.query_server import (
        QueryServer,
        ServerConfig,
    )

    t0 = time.perf_counter()
    server = QueryServer(
        ServerConfig(engine_variant=variant_path, ip="127.0.0.1",
                     port=free_port()),
        storage=storage, ctx=ctx)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    log(f"[{name}] deployed in {deploy_s:.2f} s: "
        f"{json.dumps(server.deployed.models[0].serving_info())}")
    await server.start()
    import aiohttp

    try:
        async with aiohttp.ClientSession() as session:
            url = f"http://127.0.0.1:{server.config.port}/queries.json"
            result = await body_fn(session, url, server)
            result["degraded"] = await serving_verdict(
                session, url.rsplit("/", 1)[0], name)
    finally:
        await server.shutdown()
    result["deploy_s"] = deploy_s
    result["batches_served"] = server.batcher.batches_served
    result["max_batch_seen"] = server.batcher.max_batch_seen
    return result


def check_vs_cpu(name, towers_, users, bodies):
    """The served top-10 of ``users`` (exact mode) against the port's plain
    CPU path on the same towers (``(user, item, user_bias, item_bias,
    mean)``): the CPU's top-12, so that an id may cross the 10th place only
    through a near-tie (the two sum in different orders, fp32 roundoff);
    every served score within 1e-4. Returns the counts of equal id sets and
    equal orders."""
    from incubator_predictionio_tpu_torch.models.two_tower import (
        TwoTowerConfig,
        TwoTowerMF,
        TwoTowerModel,
    )

    user, item, user_bias, item_bias, mean = towers_
    cpu = TwoTowerModel(user_emb=user, item_emb=item, user_bias=user_bias,
                        item_bias=item_bias, mean=mean,
                        config=TwoTowerConfig(rank=user.shape[1]))
    cpu.prepare_for_serving(quantize=True, host_max_elements=0,
                            device="cpu", build_index=False)
    ci, cs = TwoTowerMF.recommend_batch(cpu, np.asarray(users, np.int32), 12)
    same_order = same_set = 0
    for r, body in enumerate(bodies):
        got = ids_of(body)
        want = [f"i{i}" for i in ci[r][:10]]
        cpu_score = dict(zip([f"i{i}" for i in ci[r]], cs[r].tolist()))
        for iid in set(got) ^ set(want):
            check(iid in cpu_score
                  and abs(cpu_score[iid] - float(cs[r][9])) <= 1e-4,
                  f"[{name}] top-10 differs from the CPU path for "
                  f"u{users[r]} beyond a near-tie: {got} vs {want}")
        for s in body["itemScores"]:
            check(abs(s["score"] - cpu_score[s["item"]]) <= 1e-4,
                  f"[{name}] score {s} vs CPU {cpu_score[s['item']]}")
        same_set += set(got) == set(want)
        same_order += got == want
    log(f"[{name}] top-10 of {len(bodies)} users vs the plain CPU path: same "
        f"ids for {same_set}/{len(bodies)}, same order for "
        f"{same_order}/{len(bodies)}, scores within 1e-4")
    return same_set, same_order


async def main_path(R, variant_path, storage, ctx, model_arrays, eval_users):
    user, item, user_bias, item_bias = model_arrays
    lat = {}

    async def exact(session, url, server):
        info = server.deployed.models[0].serving_info()
        check(info["path"] == "device-int8" and info["device"].startswith("cuda"),
              f"not on the int8 device path: {info}")
        check(info["retrieval_mode"] == "exact", f"not exact: {info}")
        check(R.score_catalog_quantized.launches > 0,
              "K1 did not launch during warmup")
        log(f"[exact] K1 launches after deploy+warmup: "
            f"{R.score_catalog_quantized.launches}")
        singles = [{"user": f"u{u}", "num": 10} for u in eval_users[:16]]
        b_single, lat["exact_single"] = await post_all(session, url, singles, False)
        burst = [{"user": f"u{u}", "num": 10} for u in eval_users[16:80]]
        _, lat["exact_burst64"] = await post_all(session, url, burst, True)
        banned = {}
        bl = []
        for u, body in zip(eval_users[:8], b_single[:8]):
            ban = ids_of(body)[:3] + [f"i{(int(u) * 7919) % N_ITEMS}"]
            banned[f"u{u}"] = set(ban)
            bl.append({"user": f"u{u}", "num": 10, "blackList": ban})
        b_bl, lat["exact_blacklist"] = await post_all(session, url, bl, True)
        for p, body in zip(bl, b_bl):
            got = ids_of(body)
            check(len(got) == 10, f"short blackList answer {body}")
            check(not set(got) & banned[p["user"]], f"banned id served: {body}")
        oracle = {}
        for lo in range(0, len(eval_users), 64):
            payload = [{"user": f"u{u}", "num": 10}
                       for u in eval_users[lo:lo + 64]]
            bodies, ls = await post_all(session, url, payload, True)
            lat.setdefault("exact_eval", []).extend(ls)
            for p, body in zip(payload, bodies):
                oracle[p["user"]] = ids_of(body)
        for body in b_single + bodies:
            check(len(body["itemScores"]) == 10, f"short answer {body}")
        # the port's plain CPU path on the same towers, for the 16 singles
        same_set, same_order = check_vs_cpu(
            "exact", (user, item, user_bias, item_bias, 3.0),
            eval_users[:16], b_single)
        window = await profiled_burst(session, url, payload)
        log_window("exact", window)
        return {"oracle": oracle, "cpu_same_ids": same_set,
                "cpu_same_order": same_order, "profiled_burst": window}

    R.reset_launches()
    with retrieval_mode("exact"):
        res_a = await serve_phase("exact", variant_path, storage, ctx, exact)
    gc.collect()
    torch.cuda.empty_cache()
    oracle = res_a.pop("oracle")
    k1_after_a = R.score_catalog_quantized.launches

    async def two_stage(session, url, server):
        info = server.deployed.models[0].serving_info()
        check(info["retrieval_mode"] == "two_stage", f"not two-stage: {info}")
        check((info["index"] or {}).get("coarse_device", "").startswith("cuda"),
              f"coarse stage not on the card: {info}")
        k2_deploy = R.score_centroids_quantized.launches
        hits = total = 0
        for lo in range(0, len(eval_users), 64):
            payload = [{"user": f"u{u}", "num": 10}
                       for u in eval_users[lo:lo + 64]]
            bodies, ls = await post_all(session, url, payload, True)
            lat.setdefault("two_stage", []).extend(ls)
            for p, body in zip(payload, bodies):
                got = ids_of(body)
                check(len(got) == 10, f"short answer {body}")
                hits += len(set(got) & set(oracle[p["user"]]))
                total += 10
        recall = hits / total
        check(R.score_centroids_quantized.launches > k2_deploy,
              "K2 did not launch on the two-stage queries")
        check(recall >= RECALL_FLOOR, f"recall@10 {recall} < {RECALL_FLOOR}")
        log(f"[two_stage] recall@10 vs the exact answers: {recall:.4f} "
            f"(floor {RECALL_FLOOR}); K2 launches at deploy {k2_deploy}, "
            f"after 256 queries {R.score_centroids_quantized.launches}")
        window = await profiled_burst(session, url, payload)
        log_window("two_stage", window)
        return {"recall_at_10": recall, "index": info["index"],
                "profiled_burst": window}

    # the default mode: two-stage at this catalog size
    with retrieval_mode("auto"):
        res_b = await serve_phase("two_stage", variant_path, storage, ctx,
                                  two_stage)
    launches = {"score_catalog_quantized": R.score_catalog_quantized.launches,
                "score_centroids_quantized": R.score_centroids_quantized.launches}
    check(k1_after_a > 0, "K1 never launched on the main path")
    check(launches["score_centroids_quantized"] > 0,
          "K2 never launched on the main path")
    latency = {k: {"n": len(v), "p50_ms": pct(v, 50), "p99_ms": pct(v, 99)}
               for k, v in lat.items()}
    for k, v in latency.items():
        log(f"latency {k:<16s} n={v['n']:<4d} p50={v['p50_ms']:.2f} ms "
            f"p99={v['p99_ms']:.2f} ms")
    return launches, {"exact": res_a, "two_stage": res_b, "latency": latency}


# -- phases 5 and 6: the sequential template through the QueryServer ---------

def deploy_storage(factory, variant_params, algo_name, model, tmp):
    """A memory storage holding one COMPLETED instance of ``model`` and its
    variant file; returns (storage, variant path)."""
    import datetime as dt

    from incubator_predictionio_tpu_torch.data.storage import (
        EngineInstance,
        Model,
        Storage,
    )
    from incubator_predictionio_tpu_torch.utils.serialization import (
        serialize_model,
    )

    storage = Storage({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    variant_path = os.path.join(tmp, f"{algo_name}-engine.json")
    with open(variant_path, "w") as f:
        json.dump({"id": algo_name, "version": "1", "engineFactory": factory,
                   "algorithms": [{"name": algo_name,
                                   "params": variant_params}]}, f)
    now = dt.datetime.now(dt.timezone.utc)
    iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=now, end_time=now,
        engine_id=algo_name, engine_version="1",
        engine_variant=os.path.abspath(variant_path), engine_factory=factory))
    storage.get_model_data_models().insert(Model(iid, serialize_model([model])))
    return storage, variant_path


def sessions(rng, n):
    """``recentItems`` sessions of 5–512 items (rows shorter than max_len
    are left-padded)."""
    return [[f"i{i}" for i in rng.integers(0, SEQ_VOCAB - 1, int(m))]
            for m in rng.integers(5, 513, n)]


def check_answers(payloads, bodies):
    for p, body in zip(payloads, bodies):
        got = ids_of(body)
        check(len(got) == p["num"], f"short answer {len(got)} for num {p['num']}")
        check(not set(got) & set(p["recentItems"]),
              f"a history item was served: {set(got) & set(p['recentItems'])}")


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at ``|x|`` (8 significant bits against
    fp32's 24)."""
    return float(np.spacing(np.float32(abs(x)))) * 2.0 ** 16


def check_against_plain(model, payloads, bodies, plain=None, tag=""):
    """The served answers (kernel attention) against the same model's
    forward with the plain attention version, on the card: every served
    score within :data:`SEQ_SCORE_TOL` of the plain score of that item, and
    the ids equal up to near-ties at the last place (the scores are bf16
    values, so ties are common). Where one bf16 step at the score's
    magnitude is larger than :data:`SEQ_SCORE_TOL` (scores of 4 and more,
    0.03125), one step is the band: the two fp32 sums then round to
    neighbouring bf16 values. ``plain`` holds each payload's plain score
    row where the caller computed it (by default the plain forward of the
    payloads as one batch); ``tag`` starts each failure's message. Returns
    the largest score difference and the counts of equal id sets and
    orders."""
    from incubator_predictionio_tpu_torch.models.transformer import (
        TransformerRecommender,
    )
    from incubator_predictionio_tpu_torch.parallel.ring import (
        causal_attention_reference,
    )
    from incubator_predictionio_tpu_torch.templates.sequential import (
        encode_session,
    )

    if plain is None:
        rows = np.stack([encode_session(p["recentItems"], model.item_map,
                                        model.config.max_len) for p in payloads])
        plain = TransformerRecommender.next_item_scores(
            model, rows, attention=causal_attention_reference)
    inv = model.item_map.inverse()
    worst, same_set, same_order = 0.0, 0, 0
    for p, body, s in zip(payloads, bodies, plain):
        s = s.copy()
        s[0] = -np.inf
        for iid in p["recentItems"]:
            tok = model.item_map.get(iid)
            if tok is not None:
                s[tok] = -np.inf
        num = p["num"]
        top = np.argsort(-s, kind="stable")[:num]
        want = [inv[int(t)] for t in top]
        got = ids_of(body)
        last = float(s[top[-1]])
        for iid in set(got) ^ set(want):
            check(abs(float(s[model.item_map[iid]]) - last)
                  <= max(SEQ_SCORE_TOL, bf16_ulp(last)),
                  f"{tag}top-{num} differs from the plain path beyond a "
                  f"near-tie: {got} vs {want}")
        for x in body["itemScores"]:
            plain_score = float(s[model.item_map[x["item"]]])
            diff = abs(x["score"] - plain_score)
            worst = max(worst, diff)
            check(diff <= max(SEQ_SCORE_TOL, bf16_ulp(plain_score)),
                  f"{tag}score {x} vs plain {plain_score}")
        same_set += set(got) == set(want)
        same_order += got == want
    return worst, same_set, same_order


async def sequential_phase(name, max_len, ctx, seed, n_singles, n_bursts):
    """Deploy the sequential template at the bench width and ``max_len``
    (weights at the reference's init scales from ``default_rng(seed)``)
    and drive it; returns (launches of K4 and K5 in the phase, record)."""
    from incubator_predictionio_tpu_torch import convert
    from incubator_predictionio_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params_numpy,
    )
    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.parallel.ring import attention_route

    route = attention_route(64, max_len, SEQ_HEADS, SEQ_D // SEQ_HEADS)
    expect = {"small_head": A.causal_mha_small_head,
              "flash": A.flash_causal_attention}[route]
    others = [w for w in A.KERNEL_WRAPPERS if w is not expect]
    params = init_params_numpy(TransformerConfig(
        vocab_size=SEQ_VOCAB, max_len=max_len, d_model=SEQ_D,
        n_heads=SEQ_HEADS, n_layers=SEQ_LAYERS), seed)
    model = convert.transformer_model_from_params(
        params, [f"i{j}" for j in range(SEQ_VOCAB - 1)], n_heads=SEQ_HEADS)
    del params
    rng = np.random.default_rng(seed)
    singles = [{"recentItems": s, "num": 10} for s in sessions(rng, n_singles)]
    bursts = [[{"recentItems": s, "num": 10} for s in sessions(rng, 64)]
              for _ in range(n_bursts)]
    cold = {"recentItems": ["never-seen", "unknown-2"], "num": 10}
    lat: dict[str, list] = {}

    async def body(session, url, server):
        served = server.deployed.models[0]
        info = served.serving_info()
        check(info["device"].startswith("cuda"), f"not on the card: {info}")
        check(expect.launches == SEQ_LAYERS,
              f"warmup launched {expect.__name__} {expect.launches} times, "
              f"not {SEQ_LAYERS}")
        b_single, lat[f"{name}_single"] = await post_all(
            session, url, singles, False)
        check_answers(singles, b_single)
        for burst in bursts:
            b_burst, ls = await post_all(session, url, burst, True)
            lat.setdefault(f"{name}_burst64", []).extend(ls)
            check_answers(burst, b_burst)
        (b_cold,), _ = await post_all(session, url, [cold], False)
        check(b_cold["itemScores"] == [], f"cold session answered {b_cold}")
        worst, same_set, same_order = check_against_plain(
            served, singles, b_single)
        log(f"[{name}] {len(singles)} singles vs the plain attention path on "
            f"the card: same ids {same_set}/{len(singles)}, same order "
            f"{same_order}/{len(singles)}, max score diff {worst:.3e} "
            f"(tol {SEQ_SCORE_TOL})")
        # time each batch dispatch of the profiled burst on the server side
        # (bind, forward, D2H, top-k): the rest of the wall is HTTP and JSON
        deployed, dispatches = server.deployed, []

        def timed_predict_batch(payloads, _inner=deployed.predict_batch):
            t0 = time.perf_counter()
            try:
                return _inner(payloads)
            finally:
                dispatches.append((len(payloads), time.perf_counter() - t0))

        deployed.predict_batch = timed_predict_batch
        try:
            window = await profiled_burst(session, url, bursts[0])
        finally:
            del deployed.predict_batch
        window["dispatches"] = [{"queries": n, "ms": t * 1e3}
                                for n, t in dispatches]
        log_window(name, window)
        log(f"[{name}] server-side dispatches of the profiled burst "
            f"(queries, ms): " + ", ".join(
                f"({d['queries']}, {d['ms']:.2f})" for d in window["dispatches"]))
        batches = server.batcher.batches_served
        check(expect.launches == SEQ_LAYERS * (1 + batches),
              f"{expect.__name__} launched {expect.launches} times for "
              f"{batches} served batches + warmup; {SEQ_LAYERS} a batch expected")
        for w in others:  # the other forward, and no backward when serving
            check(w.launches == 0,
                  f"{w.__name__} launched {w.launches} times at max_len {max_len}")
        return {"route": route, "plain_max_score_diff": worst,
                "plain_same_ids": same_set, "plain_same_order": same_order,
                "queries": len(singles) + 64 * (n_bursts + 1) + 1,
                "profiled_burst": window}

    with tempfile.TemporaryDirectory() as tmp:
        storage, variant_path = deploy_storage(
            SEQ_FACTORY, {"maxLen": max_len, "dModel": SEQ_D,
                          "nHeads": SEQ_HEADS, "nLayers": SEQ_LAYERS},
            "transformer", model, tmp)
        del model
        A.reset_launches()
        res = await serve_phase(name, variant_path, storage, ctx, body)
        launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{name}] launches in the phase: {launches} "
        f"({res['batches_served']} batches served + warmup)")
    res["launches"] = launches
    res["latency"] = {k: {"n": len(v), "p50_ms": pct(v, 50), "p99_ms": pct(v, 99)}
                      for k, v in lat.items()}
    for k, v in res["latency"].items():
        log(f"latency {k:<16s} n={v['n']:<4d} p50={v['p50_ms']:.2f} ms "
            f"p99={v['p99_ms']:.2f} ms")
    return launches, res


# -- phases 7-9: training the sequential template on the card ------------------

def cycle_sessions(rng, n: int, max_len: int, lengths=None):
    """Sessions with something to learn: over the 9,999 items, a random
    start and a length of 5 to ``max_len + 1`` (or ``lengths``, an
    inclusive (low, high)), each item followed by the next of the cycle,
    ``next(i_k) = i_{k+1 mod 9999}``."""
    n_items = SEQ_VOCAB - 1
    starts = rng.integers(0, n_items, n)
    lo, hi = lengths or (5, max_len + 1)
    lengths = rng.integers(lo, hi + 1, n)
    return [[f"i{(int(s) + j) % n_items}" for j in range(int(m))]
            for s, m in zip(starts, lengths)]


def profiled_step(net, batch, lr) -> dict:
    """One training step under :func:`cuda_profile`, after one unprofiled
    step: the device's busy share of the step's wall time and the device
    time by kernel."""
    from incubator_predictionio_tpu_torch.models.transformer import train_step
    from incubator_predictionio_tpu_torch.utils.optim import adam_init

    state = adam_init(list(net.parameters()), net.cfg.adam_moments_dtype)
    train_step(net, state, batch, lr)
    torch.cuda.synchronize()
    with cuda_profile() as by_name:
        t0 = time.perf_counter()
        train_step(net, state, batch, lr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return busy_record(by_name, wall, 12)


def step_parity(cfg, batch, dev) -> dict:
    """One step with the kernels against one step with the plain attention
    versions, on the card, from the same init. What the backward kernels
    produce is held by the gradients: each parameter's within
    :data:`GRAD_TOL` of that gradient's max abs. The loss (the forward's)
    must agree within :data:`STEP_LOSS_RTOL`, and after adam every
    parameter within 2·lr — a band adam's first step (±lr·|g|/(|g|+eps) an
    element) keeps whatever the gradient, so it checks only that the update
    ran; the mean difference is recorded beside it."""
    from incubator_predictionio_tpu_torch.models import transformer as T
    from incubator_predictionio_tpu_torch.parallel.ring import (
        causal_attention_reference,
    )
    from incubator_predictionio_tpu_torch.utils.optim import adam_init, adam_update

    init = T._init_params(cfg, torch.Generator(device=dev).manual_seed(cfg.seed), dev)
    res = {}
    for name, att in (("kernels", T.causal_attention),
                      ("plain", causal_attention_reference)):
        net = T.TransformerNet(init, cfg, dev, trainable=True)
        names, params = zip(*net.named_parameters())
        state = adam_init(list(params), cfg.adam_moments_dtype)
        loss = T.train_loss(net, *batch, attention=att)
        grads = torch.autograd.grad(loss, params)
        adam_update(list(params), grads, state, cfg.learning_rate)
        res[name] = (float(loss.detach()), grads, [p.detach() for p in params])
        del net, state, loss
    (lk, gk, pk), (lp, gp, pp) = res["kernels"], res["plain"]
    grad_rel = {n: float((a - b).abs().max()) / float(b.abs().max())
                for n, a, b in zip(names, gk, gp)}
    worst = max(grad_rel, key=grad_rel.get)
    diff = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
    mean = (sum(float((a - b).abs().sum()) for a, b in zip(pk, pp))
            / sum(a.numel() for a in pk))
    out = {"loss_kernels": lk, "loss_plain": lp,
           "loss_rel_diff": abs(lk - lp) / abs(lp),
           "grad_rel_err": grad_rel, "grad_worst": worst,
           "grad_worst_rel_err": grad_rel[worst],
           "param_max_abs_diff": diff, "param_mean_abs_diff": mean,
           "param_band": 2 * cfg.learning_rate}
    check(out["loss_rel_diff"] <= STEP_LOSS_RTOL,
          f"step loss {lk} (kernels) vs {lp} (plain) beyond {STEP_LOSS_RTOL}")
    check(grad_rel[worst] <= GRAD_TOL,
          f"the gradient of {worst} differs by {grad_rel[worst]} of its max "
          f"abs between the kernels and the plain attention (> {GRAD_TOL})")
    check(diff <= out["param_band"],
          f"a parameter differs by {diff} > 2·lr after one step")
    return out


def train_phase(name, max_len, n_rows, epochs, ctx, seed, parity=False,
                deploy=False):
    """Train the sequential template at the bench width on cycle sessions
    from ``default_rng(seed)``, through ``DataSource._build_fold`` and
    ``TransformerAlgorithm.train``, with the kernel counts at 0 just before
    and read just after; then profile one step and, where asked, run the
    step-parity check and deploy the trained model. Returns (launches in
    the fit, launches in the deploy phase, record)."""
    from incubator_predictionio_tpu_torch.models.transformer import TransformerNet
    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.parallel.ring import attention_route
    from incubator_predictionio_tpu_torch.templates.sequential import (
        DataSource,
        DataSourceParams,
        TransformerAlgorithm,
        TransformerAlgorithmParams,
    )

    dev = ctx.device
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    td = DataSource(DataSourceParams(app_name="chip-smoke", max_len=max_len)) \
        ._build_fold(ctx, cycle_sessions(rng, n_rows, max_len), False)
    td.sanity_check()
    fold_s = time.perf_counter() - t0
    algo = TransformerAlgorithm(TransformerAlgorithmParams(
        app_name="chip-smoke", max_len=max_len, d_model=SEQ_D, n_heads=SEQ_HEADS,
        n_layers=SEQ_LAYERS, learning_rate=TRAIN_LR, batch_size=TRAIN_BATCH,
        epochs=epochs))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    fit_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    peak = torch.cuda.max_memory_allocated()
    cfg = model.config
    n = len(td.sequences)
    steps = epochs * -(-n // TRAIN_BATCH)
    tokens = epochs * n * max_len
    train_sec = model.timings["train_sec"]
    # bench.py:913-920: non-embedding params, 6 FLOPs a param a token, plus
    # attention's 12 · layers · d · L
    flops_per_token = 6 * 12 * SEQ_LAYERS * SEQ_D ** 2 + 12 * SEQ_LAYERS * SEQ_D * max_len
    rec = {"max_len": max_len, "rows": n, "vocab": cfg.vocab_size,
           "batch": TRAIN_BATCH, "epochs": epochs, "steps": steps,
           "fold_s": fold_s, "fit_s": fit_s, "timings": model.timings,
           "train_tokens_per_s": tokens / train_sec,
           "mfu": tokens * flops_per_token / train_sec / BF16_OPS_PER_S,
           "first_step_loss": float(model.step_losses[0, 0]),
           "final_loss": model.final_loss,
           "peak_device_bytes": peak, "launches": launches}
    check(np.isfinite(model.final_loss), f"[{name}] final loss {model.final_loss}")
    check(bool(np.isfinite(model.step_losses).all()), f"[{name}] a step loss is not finite")
    route = attention_route(TRAIN_BATCH, max_len, SEQ_HEADS, SEQ_D // SEQ_HEADS)
    ran = ({"small_head": ("causal_mha_small_head", "causal_mha_small_head_bwd"),
            "flash": ("flash_causal_attention", "flash_causal_attention_bwd_dkv",
                      "flash_causal_attention_bwd_dq")}[route])
    for w, count in launches.items():
        want = SEQ_LAYERS * steps if w in ran else 0
        check(count == want, f"[{name}] {w} launched {count} times in the fit, "
              f"{want} expected ({SEQ_LAYERS} layers × {steps} steps)")
    log(f"[{name}] fit: {n} rows of {max_len + 1} tokens (vocab {cfg.vocab_size}), "
        f"batch {TRAIN_BATCH}, {epochs} epochs = {steps} steps in "
        f"{train_sec:.3f} s (train_sec; fit {fit_s:.3f} s, fold {fold_s:.2f} s): "
        f"{rec['train_tokens_per_s']:.1f} train tokens/s, MFU {rec['mfu']:.4f}; "
        f"loss first step {rec['first_step_loss']:.4f}, final {model.final_loss:.4f}; "
        f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    if epochs > 1:
        check(model.final_loss < rec["first_step_loss"],
              f"[{name}] final loss {model.final_loss} not below the first "
              f"step's {rec['first_step_loss']}")
    batch = (torch.from_numpy(td.sequences[:TRAIN_BATCH, :-1].astype(np.int64)).to(dev),
             torch.arange(max_len, device=dev).expand(TRAIN_BATCH, max_len),
             torch.from_numpy(td.sequences[:TRAIN_BATCH, 1:].astype(np.int64)).to(dev),
             torch.from_numpy(((td.sequences[:TRAIN_BATCH, 1:] != 0)
                               & (td.sequences[:TRAIN_BATCH, :-1] != 0))
                              .astype(np.float32)).to(dev))
    rec["profiled_step"] = profiled_step(
        TransformerNet(model.params, cfg, dev, trainable=True), batch, cfg.learning_rate)
    w = rec["profiled_step"]
    log(f"[{name}] profiled step: wall {w['wall_ms']:.2f} ms, device busy "
        f"{w['device_busy_ms']:.3f} ms (share {w['device_busy_share']:.4f}); "
        "attention kernels' device ms: "
        + ", ".join(f"{k}={v:.3f}" for k, v in w["attention_device_ms"].items())
        + "; top device ms: "
        + ", ".join(f"{k[:60]}={v:.3f}" for k, v in w["top_device_ms"].items()))
    if parity:
        rec["step_parity"] = step_parity(cfg, batch, dev)
        sp = rec["step_parity"]
        log(f"[{name}] one step, kernels vs plain attention from the same init: "
            f"loss {sp['loss_kernels']:.6f} vs {sp['loss_plain']:.6f} (rel "
            f"{sp['loss_rel_diff']:.2e}, tol {STEP_LOSS_RTOL}); worst gradient "
            f"{sp['grad_worst']} {sp['grad_worst_rel_err']:.2e} of its max abs "
            f"(tol {GRAD_TOL}); params max abs diff "
            f"{sp['param_max_abs_diff']:.3e} (band 2·lr = {sp['param_band']}), mean "
            f"{sp['param_mean_abs_diff']:.3e}")
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    serve_launches = {}
    if deploy:
        serve_launches, rec["deploy"] = asyncio.run(
            deploy_trained(name, model, max_len, ctx, rng))
    return launches, serve_launches, rec


async def deploy_trained_body(name, payloads, expected, session, url, server):
    info = server.deployed.models[0].serving_info()
    check(info["device"].startswith("cuda"), f"not on the card: {info}")
    bodies, ls = await post_all(session, url, payloads, False)
    check_answers(payloads, bodies)
    hits = sum(int(e in ids_of(b)) for e, b in zip(expected, bodies))
    log(f"[{name}-serve] {len(payloads)} recentItems queries answered, no "
        f"history item served; the next item of the cycle in the top 10 for "
        f"{hits}/{len(payloads)}")
    return {"queries": len(payloads), "next_item_in_top10": hits,
            "latency_p50_ms": pct(ls, 50), "latency_p99_ms": pct(ls, 99)}


async def deploy_trained(name, model, max_len, ctx, rng):
    """The trained model through the port's QueryServer (memory storage):
    16 ``recentItems`` queries of cycle sessions, each answered in full
    with no history item."""
    from incubator_predictionio_tpu_torch.ops import attention as A

    n_items = SEQ_VOCAB - 1
    payloads, expected = [], []
    for s in cycle_sessions(rng, 16, max_len):
        payloads.append({"recentItems": s, "num": 10})
        expected.append(f"i{(int(s[-1][1:]) + 1) % n_items}")
    with tempfile.TemporaryDirectory() as tmp:
        storage, variant_path = deploy_storage(
            SEQ_FACTORY, {"maxLen": max_len, "dModel": SEQ_D,
                          "nHeads": SEQ_HEADS, "nLayers": SEQ_LAYERS},
            "transformer", model, tmp)
        A.reset_launches()
        res = await serve_phase(
            f"{name}-serve", variant_path, storage, ctx,
            lambda session, url, server: deploy_trained_body(
                name, payloads, expected, session, url, server))
        launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    for w, count in launches.items():
        check((count > 0) == (w == "causal_mha_small_head"),
              f"[{name}-serve] {w} launched {count} times")
    return launches, res


# -- phase 10: streaming live events into the served model ---------------------

def adam_problem(r: int, d: int, seed: int):
    """A stacked touched-row problem as the reference's tests make it
    (tests/test_sparse_update.py:43): fresh rows (t 1) beside rows trained
    up to 500 steps."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(r, d)).astype(np.float32)
    m = (rng.normal(size=(r, d)) * 0.01).astype(np.float32)
    v = np.abs(rng.normal(size=(r, d)) * 1e-4).astype(np.float32)
    g = rng.normal(size=(r, d)).astype(np.float32)
    t = rng.integers(1, 501, r).astype(np.int64)
    t[:3] = 1
    return rows, m, v, g, t


def max_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance between two float32 arrays in units of the
    last place (0 when bitwise equal, -0.0 and 0.0 alike)."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max()) if a.size else 0


def host_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Median host wall time of one call (for host work, and for calls that
    end in a device→host copy)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fused_adam_library(S, stack, t):
    """K3's library yardstick: one ``torch._fused_adam_`` call over the R
    rows as R tensors of [D], each with its own step count, so each row
    gets its own bias corrections (the library takes them in fp32 on the
    card, K3 from the host's double). Returns (the call on clones of the
    stack — it updates them in place — and the result of its first call,
    [3, R, D] as K3's)."""
    rows, m, v, g = stack.clone().unbind(0)
    steps = [torch.tensor(float(x), device=stack.device) for x in t]
    views = [list(a.unbind(0)) for a in (rows, m, v, g)]

    def call():
        torch._fused_adam_(views[0], views[3], views[1], views[2], [], steps,
                           lr=STREAM_LR, beta1=S.ADAM_B1, beta2=S.ADAM_B2,
                           weight_decay=0.0, eps=S.ADAM_EPS, amsgrad=False,
                           maximize=False)

    call()
    return call, torch.stack([rows, m, v]).cpu().numpy()


def k3_case(S, r, d, seed, dev) -> dict:
    """K3 against its plain version on the same tensors of the card: bitwise,
    or the reference's band; and against the host fused pass."""
    rows, m, v, g, t = adam_problem(r, d, seed)
    bc1, bc2 = S.adam_bias_corrections(t)
    stack = torch.from_numpy(np.stack([rows, m, v, g])).to(dev)
    bc = torch.from_numpy(np.stack([bc1, bc2])).to(dev)
    got = S.adam_rows(stack, bc, STREAM_LR).cpu().numpy()
    want = S.adam_rows_reference(stack, bc, STREAM_LR).cpu().numpy()
    host = np.stack(S.fused_adam_rows(rows, m, v, g, t, STREAM_LR))
    # the device engine's staged entry (copy up, K3, copy down, one call)
    engine = np.stack(S.fused_adam_rows_device(rows, m, v, g, t, STREAM_LR,
                                               device=dev))
    check(bool(np.isfinite(got).all()), f"K3 R={r} D={d}: non-finite")
    out = {"R": r, "D": d, "max_abs_err": float(np.abs(got - want).max()),
           "max_ulps": max_ulps(got, want),
           "bitwise_plain": got.tobytes() == want.tobytes(),
           "max_ulps_host": max_ulps(got, host),
           "bitwise_host": got.tobytes() == host.tobytes(),
           "bitwise_engine_host": engine.tobytes() == host.tobytes(),
           "tolerance": {"rtol": K3_RTOL, "atol": K3_ATOL}}
    for name, a, ref in (("plain", got, want), ("host", got, host),
                         ("engine_host", engine, host)):
        check(out[f"bitwise_{name}"]
              or bool(np.allclose(a, ref, rtol=K3_RTOL, atol=K3_ATOL)),
              f"K3 R={r} D={d} ({name}): {max_ulps(a, ref)} ulps, beyond "
              f"rtol {K3_RTOL} atol {K3_ATOL}")
    if (r, d) in (K3_MAIN, K3_REC):
        out["ms"] = time_ms(lambda: S.adam_rows(stack, bc, STREAM_LR))
        out["device_ms"] = device_ms(lambda: S.adam_rows(stack, bc, STREAM_LR),
                                     SPARSE_SYMBOLS["adam_rows"])
        out["plain_ms"] = time_ms(lambda: S.adam_rows_reference(stack, bc,
                                                                STREAM_LR))
        lib_call, lib_out = fused_adam_library(S, stack, t)
        out["library_max_abs_err"] = float(np.abs(lib_out - got).max())
        check(bool(np.allclose(lib_out, got, rtol=1e-5, atol=1e-6)),
              f"torch._fused_adam_ is not K3's function: max abs err "
              f"{out['library_max_abs_err']}")
        out["library_ms"] = time_ms(lib_call)
        out["library_device_ms"] = device_ms(lib_call, "multi_tensor_apply")
        out["host_fused_ms"] = host_ms(
            lambda: S.fused_adam_rows(rows, m, v, g, t, STREAM_LR))
        # the device engine as the fold calls it: pack, one copy up, K3,
        # one copy down
        out["device_engine_ms"] = host_ms(
            lambda: S.fused_adam_rows_device(rows, m, v, g, t, STREAM_LR,
                                             device=dev))
        # bytes: rows, m, v, g and the two corrections in, rows, m, v out;
        # ~12 fp32 operations an element, outside the tensor cores
        t_bytes = (7 * r * d + 2 * r) * 4 / HBM_BYTES_PER_S * 1e3
        t_ops = 12.0 * r * d / FP32_OPS_PER_S * 1e3
        out["bound_ms"] = max(t_bytes, t_ops)
        out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"K3 adam_rows R={r:<5d} D={d:<3d} max_abs_err={out['max_abs_err']:.3e} "
        f"ulps={out['max_ulps']} bitwise_plain={out['bitwise_plain']} "
        f"bitwise_host={out['bitwise_host']} "
        f"engine_bitwise_host={out['bitwise_engine_host']}"
        + (f" ms={out['ms']:.4f} device_ms={fmt(out['device_ms'])} "
           f"plain_ms={out['plain_ms']:.4f} fused_adam_ms={out['library_ms']:.4f} "
           f"fused_adam_device_ms={fmt(out['library_device_ms'])} "
           f"(err {out['library_max_abs_err']:.3e}) "
           f"host_fused_ms={out['host_fused_ms']:.4f} "
           f"device_engine_ms={out['device_engine_ms']:.4f} "
           f"bound_ms={out['bound_ms']:.6f} ({out['bound_by']})"
           if "ms" in out else ""))
    return out


def k3b_check(S, dev) -> dict:
    """K3's table-resident form (``fused_gather_adam_scatter``) on the card,
    at the fold's micro-batch (R 512, D 33) against a 100,000-row table: the
    touched rows equal K3 on the gathered rows, bit for bit; every
    untouched row and the input tables are unchanged; each call is one K3
    launch (its indexed entry) beside the tables' copies. Then its device
    time a call (every kernel and copy it runs) and its host time."""
    rng = np.random.default_rng(7)
    n, d, r = 100_000, RANK + 1, 512
    tabs = [rng.normal(size=(n, d)).astype(np.float32),
            (rng.normal(size=(n, d)) * 0.01).astype(np.float32),
            np.abs(rng.normal(size=(n, d)) * 1e-4).astype(np.float32)]
    idx = np.sort(rng.choice(n, r, replace=False))
    g = rng.normal(size=(r, d)).astype(np.float32)
    bc1, bc2 = S.adam_bias_corrections(rng.integers(1, 501, r))
    T = [torch.from_numpy(a).to(dev) for a in (*tabs, idx, g, bc1, bc2)]
    before = S.adam_rows.launches
    new = S.fused_gather_adam_scatter(*T, lr=STREAM_LR)
    check(S.adam_rows.launches == before + 1,
          f"K3b launched K3 {S.adam_rows.launches - before} times, not once")
    i = T[3]
    direct = S.adam_rows(torch.stack([T[0][i], T[1][i], T[2][i], T[4]]),
                         torch.stack([T[5], T[6]]), STREAM_LR)
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[i] = False
    for k in range(3):
        check(torch.equal(new[k][i], direct[k]),
              "K3b touched rows differ from K3 on the gathered rows")
        check(torch.equal(new[k][keep], T[k][keep]), "K3b moved an untouched row")
        check(np.array_equal(T[k].cpu().numpy(), tabs[k]), "K3b mutated its input")
    del new, direct

    def call():
        return S.fused_gather_adam_scatter(*T, lr=STREAM_LR)

    def plain():
        # the same function through K3's plain indexed version, on the card
        out = tuple(t.clone() for t in T[:3])
        S.adam_rows_indexed_reference(tuple(T[:3]), T[3], T[4], T[5], T[6],
                                      out, STREAM_LR)
        return out

    busy, by_name = device_busy(call, calls=10)
    # bytes: the three tables read and three new ones written (the function
    # is functional), idx, g and the two corrections read
    t_bytes = (6 * n * d * 4 + r * 8 + r * d * 4 + 2 * r * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 12.0 * r * d / FP32_OPS_PER_S * 1e3
    out = {"N": n, "D": d, "R": r, "touched_bitwise_k3": True,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "untouched_unchanged": True, "launches_a_call": 1,
           "device_ms": busy, "device_ms_by_name": by_name,
           "kernel_device_ms": sum(t for nm, t in by_name.items()
                                   if SPARSE_SYMBOLS["adam_rows_indexed"] in nm),
           "ms": time_ms(call), "plain_ms": time_ms(plain),
           # no single PyTorch call computes gather → adam → scatter
           "library_ms": None}
    log(f"K3b fused_gather_adam_scatter N={n} D={d} R={r}: touched rows bitwise "
        f"K3's, untouched rows and inputs unchanged, one K3 launch a call; "
        f"device ms a call {busy:.4f} (K3 {out['kernel_device_ms']:.4f}; "
        f"bound {out['bound_ms']:.4f}, {out['bound_by']}; "
        f"{sorted(n_[:40] for n_ in by_name)}), ms {out['ms']:.4f}, plain "
        f"{out['plain_ms']:.4f}")
    return out


def launch_floor() -> dict:
    """The card's smallest launch: the profiler's device time of a
    ``fill_`` of a one-element CUDA tensor, and its CUDA-event time."""
    x = torch.empty(1, device="cuda")
    busy, by_name = device_busy(lambda: x.fill_(1.0), calls=50)
    out = {"device_ms": busy, "names": sorted(by_name),
           "event_ms": time_ms(lambda: x.fill_(1.0))}
    log(f"launch floor: fill_ of a one-element tensor, device ms "
        f"{busy:.5f}, event ms {out['event_ms']:.5f}")
    return out


def k3_checks(S, dev):
    cases = [k3_case(S, r, d, 500 + i, dev) for i, (r, d) in enumerate(K3_SHAPES)]
    return cases, k3b_check(S, dev)


def live_events(rng, n: int, n_users: int = N_USERS, n_items: int = N_ITEMS):
    """bench.py:3159-3169: ``rate`` events of random users and items, rating
    1 + 4·U(0, 1), stamped now."""
    import datetime as dt

    from incubator_predictionio_tpu_torch.data.event import DataMap, Event

    now = dt.datetime.now(dt.timezone.utc)
    return [Event(event="rate", entity_type="user",
                  entity_id=f"u{rng.integers(0, n_users)}",
                  target_entity_type="item",
                  target_entity_id=f"i{rng.integers(0, n_items)}",
                  properties=DataMap({"rating": float(1 + 4 * rng.random())}),
                  event_time=now)
            for _ in range(n)]


@contextlib.contextmanager
def gc_pauses():
    """The process's garbage collections inside the block, through
    ``gc.callbacks``: a list, filled as they happen, of (generation, start,
    seconds) on the ``time.perf_counter`` clock."""
    pauses, started = [], {}

    def hook(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            t0 = started.pop("t")
            pauses.append((info["generation"], t0, time.perf_counter() - t0))

    gc.callbacks.append(hook)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(hook)


def gc_record(pauses, lo=-np.inf, hi=np.inf) -> dict:
    """Count and seconds, by generation, of the collections that started in
    [lo, hi]."""
    out = {}
    for gen, t0, s in pauses:
        if lo <= t0 <= hi:
            n, total = out.get(gen, (0, 0.0))
            out[gen] = (n + 1, total + s)
    return {f"gen{g}": {"n": n, "s": s} for g, (n, s) in sorted(out.items())}


def replay_check(name, up, folds) -> dict:
    """The trainer's state after the stream against a replay of the same
    events, fold by fold, into a CPU trainer on the host fused pass
    (``PIO_STREAM_FUSED=1``): the same keys, step counts exact, rows and
    moments bitwise (or within K3's band)."""
    from incubator_predictionio_tpu_torch.streaming.trainer import DeltaTrainer

    tr = up.trainer
    (ue, ub), (ie, ib) = tr._base["u"], tr._base["i"]
    os.environ["PIO_STREAM_FUSED"] = "1"
    try:
        rep = DeltaTrainer(ue, ub, ie, ib, tr.mean, tr.user_index,
                           tr.item_index, learning_rate=tr.lr, reg=tr.reg,
                           event_names=tr.event_names,
                           default_values=tr.default_values,
                           micro_batch=tr.micro_batch, device="cpu")
        for events in folds:
            rep.fold(events)
    finally:
        del os.environ["PIO_STREAM_FUSED"]
    check(set(rep.rows) == set(tr.rows), "replay touched other rows")
    check(rep.t == tr.t, "replay step counts differ")
    ulps = bitwise = 0
    for key in tr.rows:
        for a, b in ((tr.rows, rep.rows), (tr.m, rep.m), (tr.v, rep.v)):
            bitwise += a[key].tobytes() == b[key].tobytes()
            ulps = max(ulps, max_ulps(a[key], b[key]))
            check(bool(np.allclose(a[key], b[key], rtol=K3_RTOL, atol=K3_ATOL)),
                  f"trainer row {key} beyond K3's band of the host replay")
    n = 3 * len(tr.rows)
    log(f"[{name}] trainer state vs a host replay (mode 1): {len(tr.rows)} rows, "
        f"step counts exact, {bitwise}/{n} arrays bitwise, max {ulps} ulps")
    return {"rows": len(tr.rows), "arrays_bitwise": bitwise, "arrays": n,
            "max_ulps": ulps}


class CodecLog:
    """A PIOLOG01 log written with the port's codec alone (the ``stream``
    phase's feed)."""

    def __init__(self, path: str):
        from incubator_predictionio_tpu_torch.native import format as pfmt

        self.path, self._fmt = path, pfmt
        self._interner, self._written = pfmt.Interner(), 0
        with open(path, "wb") as f:
            f.write(pfmt.MAGIC)

    def append(self, events) -> None:
        with open(self.path, "ab") as f:
            for e in events:
                self._written += 1
                f.write(self._fmt.encode_event(e, f"ev{self._written:010d}",
                                               self._interner))


async def stream_phase(R, S, variant_path, storage, ctx, tmp, feed, *,
                       name="stream", n_users=N_USERS, n_items=N_ITEMS,
                       recall_floor=RECALL_FLOOR, guard=None):
    """Stream live events into the served model (bench_streaming_freshness's
    traffic over ``n_users`` × ``n_items``), with every count at 0 just
    before and read just after. ``feed`` is the log the events go to
    (``.path``, ``.append(events)``); the two-stage recall after the stream
    is held to ``recall_floor`` unless it is None. Returns (launches,
    record)."""
    import dataclasses

    import aiohttp

    from incubator_predictionio_tpu_torch.server.query_server import (
        QueryServer,
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.streaming import delta as deltas
    from incubator_predictionio_tpu_torch.streaming.updater import (
        StreamUpdater,
        UpdaterConfig,
        load_base_model,
    )

    check("PIO_STREAM_FUSED" not in os.environ,
          "PIO_STREAM_FUSED is set: the phase runs the default (auto) first")
    log_path, append = feed.path, feed.append
    rng = np.random.default_rng(5)
    # the events of every round (the last one profiled) and the backlog,
    # drawn in the order they are appended
    rounds = [live_events(rng, STREAM_ROUND_EVENTS, n_users, n_items)
              for _ in range(STREAM_ROUNDS + 1)]
    backlog = live_events(rng, STREAM_BACKLOG, n_users, n_items)
    # the second backlog, folded by the device engine (PIO_STREAM_FUSED=device)
    backlog_dev = live_events(rng, STREAM_BACKLOG, n_users, n_items)
    users = list(dict.fromkeys(int(e.entity_id[1:]) for e in backlog))
    users = users[:STREAM_EVAL_USERS]
    payloads = [{"user": f"u{u}", "num": 10} for u in users]
    loop = asyncio.get_running_loop()
    R.reset_launches()
    S.reset_launches()
    t0 = time.perf_counter()
    server = QueryServer(ServerConfig(engine_variant=variant_path, ip="127.0.0.1",
                                      port=free_port()), storage=storage, ctx=ctx)
    torch.cuda.synchronize()
    rec = {"deploy_s": time.perf_counter() - t0,
           "served_resident_at_deploy": server.deployed.models[0].mf.device_resident}
    await server.start()
    url = f"http://127.0.0.1:{server.config.port}"
    try:
        t0 = time.perf_counter()
        model, inst, names, defaults = await loop.run_in_executor(
            None, lambda: load_base_model(variant_path, storage, ctx))
        rec["updater_model_resident"] = model.mf.device_resident
        # a resident model's one pull of its tables to the host, which the
        # updater's trainer folds on (reference updater.py:170)
        t1 = time.perf_counter()
        model.mf.ensure_host()
        rec["ensure_host_s"] = time.perf_counter() - t1
        rec["ensure_host_bytes"] = (
            (model.mf.n_users + model.mf.n_items) * (model.mf.config.rank + 1) * 4
            if rec["updater_model_resident"] else 0)
        up = StreamUpdater(
            UpdaterConfig(state_dir=os.path.join(tmp, f"{name}-state"),
                          feed_path=log_path, replicas=(url,),
                          batch_events=16_384, micro_batch=STREAM_MICRO),
            model, inst, event_names=names, default_values=defaults, ctx=ctx,
            guard=guard)
        rec["updater_setup_s"] = time.perf_counter() - t0
        check(up.trainer.device.type == "cuda", f"trainer on {up.trainer.device}")
        # the start-up heap (torch, the server, the model, the earlier
        # phases' survivors) leaves the collector's reach, as a long-lived
        # updater's would: otherwise one full collection, ~0.2 s on the
        # H100 machine's host, lands wherever the traffic happens to
        # trigger it (PERF.md §6)
        gc.collect()
        gc.freeze()
        visible = []
        # where a round's time goes on the updater's side: the fold, the
        # ships (the replica's /delta: copy, prepare on the card, swap) and
        # the commit; the rest of run_once is the archive, the updater's
        # own delta apply and the guard
        stages: dict[str, list] = {"run_once": [], "fold": [], "ship": [],
                                   "commit": []}
        starts: dict[str, list] = {k: [] for k in stages}

        def timed(name, fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                starts[name].append(t0)
                try:
                    return fn(*a, **k)
                finally:
                    stages[name].append(time.perf_counter() - t0)
            return wrapper

        up.trainer.fold = timed("fold", up.trainer.fold)
        up.ship_all = timed("ship", up.ship_all)
        up._commit = timed("commit", up._commit)
        run_once = timed("run_once", up.run_once)
        async with aiohttp.ClientSession() as s:
            async def health():
                async with s.get(f"{url}/health") as r:
                    return (await r.json())["deployment"]["streaming"]

            async def answers():
                """The backlog users' top-10, exact (K1) then two-stage
                (K2), and the two-stage recall@10 against the exact."""
                out = {}
                for mode in ("exact", "auto"):
                    with retrieval_mode(mode):
                        bodies, lat = [], []
                        for lo in range(0, len(payloads), 64):
                            b, ls = await post_all(
                                s, f"{url}/queries.json",
                                payloads[lo:lo + 64], True)
                            bodies += b
                            lat += ls
                        out[mode] = (bodies, lat)
                hits = sum(len(set(ids_of(a)) & set(ids_of(b)))
                           for a, b in zip(out["auto"][0], out["exact"][0]))
                return out, hits / (10 * len(payloads))

            _, rec["recall_before_stream"] = await answers()
            for batch in rounds[:STREAM_ROUNDS]:
                t0 = time.perf_counter()
                await loop.run_in_executor(None, append, batch)
                out = await loop.run_in_executor(None, run_once)
                check(out["status"] == "applied", f"round: {out}")
                check((await health())["lastDeltaSeq"] == out["toSeq"],
                      f"the replica did not reach {out['toSeq']}")
                visible.append(time.perf_counter() - t0)
            # one more round under the profiler: the device's busy share of
            # a delta's whole path (kept out of the event-visible numbers)
            batch = rounds[-1]
            with cuda_profile() as by_name:
                t0 = time.perf_counter()
                await loop.run_in_executor(None, append, batch)
                out = await loop.run_in_executor(None, up.run_once)
                check(out["status"] == "applied", f"profiled round: {out}")
                check((await health())["lastDeltaSeq"] == out["toSeq"],
                      "the replica did not reach the profiled round's delta")
                wall = time.perf_counter() - t0
            rec["profiled_round"] = busy_record(by_name, wall, 8)
            log_window(f"{name} round", {"queries": STREAM_ROUND_EVENTS,
                                         **rec["profiled_round"]})
            check(S.adam_rows.launches == 0, f"K3 launched "
                  f"{S.adam_rows.launches} times on the host pass's rounds")
            await loop.run_in_executor(None, append, backlog)
            with gc_pauses() as pauses:
                t0 = time.perf_counter()
                out = await loop.run_in_executor(None, up.run_once)
                sustained_s = time.perf_counter() - t0
            check(out["status"] == "applied" and out["events"] == STREAM_BACKLOG,
                  f"backlog: {out}")
            check((await health())["lastDeltaSeq"] == out["toSeq"],
                  "the replica did not reach the backlog's delta")
            phases = dict(up.trainer.last_phases)
            # the collections of the whole run_once, and of the fold's
            # assemble phase (which opens the fold)
            fold0 = starts["fold"][-1]
            gc_backlog = {"run_once": gc_record(pauses),
                          "assemble": gc_record(pauses, fold0,
                                                fold0 + phases["assemble"])}
            check(S.adam_rows.launches == 0, f"K3 launched "
                  f"{S.adam_rows.launches} times on the host pass's backlog")
            # the same traffic again, fresh events, through the device
            # engine: one K3 launch a micro-batch
            await loop.run_in_executor(None, append, backlog_dev)
            from incubator_predictionio_tpu_torch.obs import profile as P

            snap = P.phase_snapshot()
            os.environ["PIO_STREAM_FUSED"] = "device"
            try:
                t0 = time.perf_counter()
                out = await loop.run_in_executor(None, up.run_once)
                device_s = time.perf_counter() - t0
            finally:
                del os.environ["PIO_STREAM_FUSED"]
            # rec-obs (e): the fold's phases under device, K3 inside compute
            rec["obs_stream_fold"] = check_phases(
                name, "stream.fold", phase_delta(snap, "stream.fold"),
                ("assemble", "compute", "gather"))
            check(out["status"] == "applied" and out["events"] == STREAM_BACKLOG,
                  f"device backlog: {out}")
            check((await health())["lastDeltaSeq"] == out["toSeq"],
                  "the replica did not reach the device backlog's delta")
            phases_dev = dict(up.trainer.last_phases)
            k3_backlog = S.adam_rows.launches
            check(k3_backlog == -(-STREAM_BACKLOG // STREAM_MICRO),
                  f"K3 launched {k3_backlog} times for the device backlog")
            # exactly-once: a re-ship dedupes, a broken chain is refused
            last = deltas.list_archived(up.config.state_dir)[-1][2]
            with open(last, "rb") as f:
                payload = f.read()
            ans = await loop.run_in_executor(None, up.transport.ship, url, payload)
            check(ans.get("status") == "duplicate", f"re-ship answered {ans}")
            d = deltas.load_delta(last)
            bad = deltas.encode_delta(dataclasses.replace(
                d, from_seq=d.from_seq + 1, to_seq=d.to_seq + 1))
            ans2 = await loop.run_in_executor(None, up.transport.ship, url, bad)
            check(ans2.get("httpStatus") == 409
                  and ans2.get("reason") == "out-of-order",
                  f"a delta off the chain answered {ans2}")
            st = await health()
            check(st["applied"] == STREAM_ROUNDS + 3 and st["deduped"] == 1,
                  f"replica counts {st}")
            served = server.deployed.models[0]
            mf, umf = served.mf, up.model.mf
            for table in ("user_emb", "item_emb", "user_bias", "item_bias"):
                check(np.array_equal(getattr(mf, table), getattr(umf, table)),
                      f"[{name}] served {table} differs from the updater's "
                      "applied model")
            replay = replay_check(name, up, [*rounds, backlog, backlog_dev])
            touched_users = sorted(i for k, i in up.trainer.rows if k == "u")
            touched_items = {f"i{i}" for k, i in up.trainer.rows if k == "i"}
            info = served.serving_info()
            check(info["retrieval_mode"] == "two_stage"
                  and (info["index"] or {}).get("coarse_device", "").startswith("cuda"),
                  f"not two-stage on the card: {info}")
            k1 = R.score_catalog_quantized.launches
            k2 = R.score_centroids_quantized.launches
            out, recall = await answers()
            (exact, lat_exact), (two, lat_two) = out["exact"], out["auto"]
            check(R.score_catalog_quantized.launches > k1,
                  "K1 did not launch on the exact queries after the stream")
            check(R.score_centroids_quantized.launches > k2,
                  "K2 did not launch on the two-stage queries after the stream")
            same_set, same_order = check_vs_cpu(
                f"{name}-exact", (umf.user_emb, umf.item_emb, umf.user_bias,
                                  umf.item_bias, umf.mean),
                users[:STREAM_CPU_USERS], exact[:STREAM_CPU_USERS])
            check(recall_floor is None or recall >= recall_floor,
                  f"[{name}] recall@10 {recall} < {recall_floor}")
            seen = 0
            for u, body in zip(users, two):
                for x in body["itemScores"]:
                    if x["item"] in touched_items:
                        j = int(x["item"][1:])
                        want = float(umf.user_emb[u] @ umf.item_emb[j]
                                     + umf.item_bias[j] + umf.user_bias[u]
                                     + umf.mean)
                        check(abs(x["score"] - want) <= 1e-4,
                              f"touched item {x} vs its current row's {want}")
                        seen += 1
            ivf = mf._ivf
            stale = {f"i{i}" for i in ivf.stale_ids.tolist()}
            check(stale == touched_items, "the IVF overlay does not hold "
                  "exactly the touched items")
            check(np.array_equal(ivf.stale_emb, umf.item_emb[ivf.stale_ids])
                  and np.array_equal(ivf.stale_bias, umf.item_bias[ivf.stale_ids]),
                  "the IVF overlay rows are not the current rows")
            log(f"[{name}] two-stage after the stream: recall@10 {recall:.4f} vs "
                f"exact over {len(users)} backlog users (floor {recall_floor}; "
                f"{rec['recall_before_stream']:.4f} before the stream); {seen} "
                f"touched items served, each "
                f"at its current row's score; overlay holds {len(stale)} rows")
            # a delta's two halves on the replica, apart: the host copy of
            # the tables (with_row_updates of no rows) and the re-prepare
            # of the copy on the card, profiled
            t0 = time.perf_counter()
            copy = mf.with_row_updates({}, {})
            rec["delta_host_copy_ms"] = (time.perf_counter() - t0) * 1e3
            with cuda_profile() as by_name:
                t0 = time.perf_counter()
                copy.prepare_for_serving(quantize=True, device=ctx.device,
                                         build_index=False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rec["delta_reprepare"] = busy_record(by_name, wall, 6)
            del copy
            w = rec["delta_reprepare"]
            log(f"[{name}] a delta's halves on the replica: the host copy of "
                f"the tables {rec['delta_host_copy_ms']:.1f} ms; the re-prepare "
                f"on the card {w['wall_ms']:.1f} ms wall, {w['device_busy_ms']:.3f} "
                "ms device: " + ", ".join(f"{k[:40]}={v:.3f}"
                                          for k, v in w["top_device_ms"].items()))
            rec["degraded"] = await serving_verdict(s, url, name)
    finally:
        gc.unfreeze()
        await server.shutdown()
    launches = {"score_catalog_quantized": R.score_catalog_quantized.launches,
                "score_centroids_quantized": R.score_centroids_quantized.launches,
                "adam_rows": S.adam_rows.launches}
    for kernel, count in launches.items():
        check(count > 0, f"[{name}] {kernel} never launched in the phase")
    check(launches["adam_rows"] == k3_backlog,
          f"K3 launched {launches['adam_rows']} times in the phase, "
          f"{k3_backlog} of them in the device backlog")
    apply_ms = [t * 1e3 for t in server.delta_apply_s]
    rec.update({
        "event_visible_ms": {"n": len(visible), "p50": pct(visible, 50),
                             "p99": pct(visible, 99), "all": [t * 1e3 for t in visible]},
        "updater_events_per_sec": STREAM_BACKLOG / sustained_s,
        "backlog_run_once_s": sustained_s, "backlog_fold_phases_s": phases,
        "backlog_gc": gc_backlog,
        "device_backlog": {"updater_events_per_sec": STREAM_BACKLOG / device_s,
                           "run_once_s": device_s, "fold_phases_s": phases_dev,
                           "k3_launches": k3_backlog},
        "delta_apply_ms": {"n": len(apply_ms),
                           "p50": pct(server.delta_apply_s, 50),
                           "p99": pct(server.delta_apply_s, 99),
                           "max": max(apply_ms), "all": apply_ms},
        "touched_users": len(touched_users), "touched_items": len(touched_items),
        "replay": replay, "exact_cpu_same_ids": same_set,
        "exact_cpu_same_order": same_order, "two_stage_recall_at_10": recall,
        "touched_items_served": seen,
        "round_stages_ms": {k: {"p50": pct(v[:STREAM_ROUNDS], 50),
                                "max": pct(v[:STREAM_ROUNDS], 100)}
                            for k, v in stages.items()},
        "latency_ms": {"exact_p50": pct(lat_exact, 50), "two_stage_p50": pct(lat_two, 50)},
        "launches": launches})
    v = rec["event_visible_ms"]
    log(f"[{name}] event visible p50 {v['p50']:.1f} ms p99 {v['p99']:.1f} ms "
        f"({STREAM_ROUNDS} rounds of {STREAM_ROUND_EVENTS}); backlog of "
        f"{STREAM_BACKLOG}: {rec['updater_events_per_sec']:.1f} events/s "
        f"(run_once {sustained_s:.3f} s; fold phases "
        + ", ".join(f"{k} {t:.3f} s" for k, t in phases.items())
        + f"; garbage collections {gc_backlog}); ")
    log(f"[{name}] backlogs of {STREAM_BACKLOG}, host pass (auto) | device "
        f"engine (device, {k3_backlog} K3 launches): events/s "
        f"{rec['updater_events_per_sec']:.1f} | "
        f"{rec['device_backlog']['updater_events_per_sec']:.1f}; run_once "
        f"{sustained_s:.3f} | {device_s:.3f} s; fold compute "
        f"{phases['compute']:.4f} | {phases_dev['compute']:.4f} s")
    log(f"[{name}] "
        "a round's stages p50 (ms): "
        + ", ".join(f"{k} {v['p50']:.1f}" for k, v in rec["round_stages_ms"].items())
        + "; delta apply on the replica p50 "
        f"{rec['delta_apply_ms']['p50']:.1f} ms p99 {rec['delta_apply_ms']['p99']:.1f} "
        f"ms max {rec['delta_apply_ms']['max']:.1f} ms; the updater model's "
        f"table pull (ensure_host) {rec['ensure_host_s']:.3f} s, "
        f"{rec['ensure_host_bytes']} bytes; launches {launches}")
    return launches, rec


# -- rec-reload: the query server's safety tier on the main path's model ------

#: rec-reload: 16 users' answers held through every swap, 4 smoke queries of
#: known users, the overload burst and its admission queue, the budget of
#: the 504 server (fake clock), the stream verb's backlog
#: (``default_rng(67)``), the probation window (the reference's default)
RELOAD_USERS, RELOAD_SMOKE = 16, 4
RELOAD_BURST, RELOAD_QUEUE = 256, 8
RELOAD_TIMEOUT_S = 1.0
RELOAD_STREAM_EVENTS = 2000
RELOAD_PROBATION_S = 30.0


def planted_engine():
    """The recommendation engine with an algorithm whose ``predict``
    raises: rec-reload's instance C, which the smoke gate must refuse. The
    variant file names this function as its engine factory while C is the
    newest instance."""
    from incubator_predictionio_tpu_torch.core.controller import Engine
    from incubator_predictionio_tpu_torch.templates import recommendation as rec

    class PlantedALS(rec.ALSAlgorithm):
        def predict(self, model, query):
            raise RuntimeError(f"planted fault for {query.user}")

    return Engine(rec.DataSource, rec.IdentityPreparator,
                  {"als": PlantedALS}, rec.FirstServing)


def same_bodies(tag, got, want) -> None:
    """Served answers bitwise earlier ones: ids and scores (the JSON
    floats of the same fp32 values)."""
    for g, w in zip(got, want, strict=True):
        check(g == w, f"[{tag}] answer {g} differs from {w}")


async def until(cond, what: str, timeout_s: float = 30.0) -> None:
    t_end = time.perf_counter() + timeout_s
    while not cond():
        check(time.perf_counter() < t_end, f"timed out waiting for {what}")
        await asyncio.sleep(0.002)


async def reload_phase(R, towers_, eval_users, storage_a, ctx, tmp, smi):
    """The query server's safety tier on the main path's persisted
    instance A (1,000,000 items at rank 32, the int8 K1 path, exact), every
    count at 0 just before and read just after, on a sqlite copy of the
    store that the ``stream`` verb's process reads too: (a) deploy A with 4
    smoke queries and a ``FakeClock``; (b) ``/reload`` to B (A's towers
    perturbed from ``default_rng(61)``), B's answers against the plain CPU
    path, A pinned; (c) ``/rollback``, A's answers bitwise, 409 once the
    window has passed; (d) a planted instance C refused by the smoke gate;
    (e) B again, its dispatch failing: the serving breaker trips inside
    probation and A comes back; (f) a burst of 256 against an admission
    queue of 8 (429s), 504 sheds, a brownout in and out on the fake clock;
    (g) a drain begun by SIGTERM through ``install_signal_drain``; (h) the
    CLI ``stream --once`` in its own process under
    ``PIO_STREAM_FUSED=device`` on a backlog of 2,000 events (started once
    (e) is done, so that its start-up overlaps (f) and (g), which run on
    other servers over A's engine). Returns (launches, record)."""
    import datetime as dt
    import pickle
    import signal
    import threading

    import aiohttp

    from incubator_predictionio_tpu_torch import convert
    from incubator_predictionio_tpu_torch.data.storage import (
        EngineInstance,
        Model,
    )
    from incubator_predictionio_tpu_torch.resilience.clock import FakeClock
    from incubator_predictionio_tpu_torch.resilience.policy import (
        ServingUnavailable,
    )
    from incubator_predictionio_tpu_torch.server.lifecycle import (
        install_signal_drain,
    )
    from incubator_predictionio_tpu_torch.server.query_server import (
        QueryServer,
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.utils.serialization import (
        serialize_model,
    )

    tag = "rec-reload"
    t_phase = time.perf_counter()
    steps: dict = {}
    user, item, user_bias, item_bias = towers_
    users = [int(u) for u in eval_users[:RELOAD_USERS]]
    payloads = [{"user": f"u{u}", "num": 10} for u in users]
    smoke = tuple({"user": f"u{int(u)}", "num": 10} for u in
                  eval_users[RELOAD_USERS:RELOAD_USERS + RELOAD_SMOKE])
    (a_src,) = storage_a.get_meta_data_engine_instances().get_all()
    blob_a = storage_a.get_model_data_models().get(a_src.id).models
    root = os.path.join(tmp, "reload")
    loop = asyncio.get_running_loop()
    rec = {"card": smi}
    R.reset_launches()
    with cli_storage(root) as registry, retrieval_mode("exact"):
        storage = registry.get_storage()
        insts = storage.get_meta_data_engine_instances()
        variant = os.path.join(root, "engine.json")

        def write_variant(factory):
            with open(variant, "w") as f:
                json.dump({"id": "reload", "version": "1",
                           "engineFactory": factory,
                           "algorithms": [{"name": "als",
                                           "params": {"rank": RANK}}]}, f)

        def insert(blob, seconds):
            when = a_src.start_time + dt.timedelta(seconds=seconds)
            iid = insts.insert(EngineInstance(
                id="", status="COMPLETED", start_time=when, end_time=when,
                engine_id="reload", engine_version="1",
                engine_variant=os.path.abspath(variant),
                engine_factory=FACTORY))
            storage.get_model_data_models().insert(Model(iid, blob))
            return iid

        def retire(iid):
            insts.update(dataclasses.replace(insts.get(iid), status="FAILED"))

        def mem(collect: bool = False) -> int:
            """``torch.cuda.memory_allocated()``; after a rollback, once
            the dropped engine's cycles are collected."""
            if collect:
                gc.collect()
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated()

        write_variant(FACTORY)
        a_id = insert(blob_a, 0)
        del blob_a
        clk = FakeClock()
        cfg = ServerConfig(engine_variant=variant, ip="127.0.0.1",
                           port=free_port(), smoke_queries=smoke,
                           reload_probation_sec=RELOAD_PROBATION_S)
        t0 = time.perf_counter()
        server = QueryServer(cfg, storage=storage, ctx=ctx, clock=clk)
        torch.cuda.synchronize()
        steps["deploy_a"] = time.perf_counter() - t0
        info = server.deployed.models[0].serving_info()
        check(info["path"] == "device-int8" and info["retrieval_mode"] == "exact"
              and info["device"].startswith("cuda"), f"[{tag}] A serves {info}")
        servers = [server]
        proc = None  # the stream verb's process, once started
        await server.start()
        base = f"http://127.0.0.1:{cfg.port}"
        q = f"{base}/queries.json"
        try:
            async with aiohttp.ClientSession(
                    connector=aiohttp.TCPConnector(limit=0)) as s:
                async def post(url, payload=None):
                    async with s.post(url, json=payload) as r:
                        return r.status, await r.json(), r.headers.get(
                            "Retry-After")

                async def deployment():
                    async with s.get(f"{base}/health") as r:
                        return (await r.json())["deployment"]

                # (a) A's answers, the reference for every swap back to A
                t0 = time.perf_counter()
                answers_a, _ = await post_all(s, q, payloads, False)
                want_of = {p["user"]: w for p, w in zip(payloads, answers_a)}
                # (b) B: A's towers perturbed, persisted as the newer instance
                rng = np.random.default_rng(61)
                bu = user + 0.1 * rng.standard_normal(user.shape, dtype=np.float32)
                bi = item + 0.1 * rng.standard_normal(item.shape, dtype=np.float32)
                blob_b = serialize_model([convert.rec_model_from_arrays(
                    bu, bi, user_bias, item_bias, 3.0, RANK,
                    [f"u{i}" for i in range(N_USERS)],
                    [f"i{i}" for i in range(N_ITEMS)])])
                b_id = insert(blob_b, 1)
                steps["persist_b"] = time.perf_counter() - t0
                m_before = mem()
                t0 = time.perf_counter()
                st, body, _ = await post(f"{base}/reload")
                steps["reload_b"] = time.perf_counter() - t0
                check(st == 200 and body["engineInstanceId"] == b_id,
                      f"[{tag}] /reload answered {st} {body}")
                dep = await deployment()
                check(dep["instanceId"] == b_id and dep["probationActive"]
                      and dep["previousInstanceId"] == a_id,
                      f"[{tag}] after the reload: {dep}")
                m_probation = mem()
                answers_b, _ = await post_all(s, q, payloads, False)
                check(answers_b != answers_a, f"[{tag}] B answers as A does")
                t0 = time.perf_counter()
                b_same = check_vs_cpu(f"{tag} B", (bu, bi, user_bias, item_bias,
                                                   3.0), users, answers_b)
                steps["b_vs_cpu"] = time.perf_counter() - t0
                # (c) by hand: A comes back bitwise; no pin once the window passed
                st, body, _ = await post(f"{base}/rollback")
                check(st == 200 and body["engineInstanceId"] == a_id,
                      f"[{tag}] /rollback answered {st} {body}")
                same_bodies(f"{tag} rollback",
                            (await post_all(s, q, payloads, False))[0], answers_a)
                m_after = mem(collect=True)
                engine_bytes = m_probation - m_before
                check(engine_bytes > 0 and m_after - m_before < engine_bytes / 2,
                      f"[{tag}] device memory {m_before} before the reload, "
                      f"{m_probation} in probation, {m_after} after the rollback")
                clk.advance(RELOAD_PROBATION_S + 1.0)
                st, body, _ = await post(f"{base}/rollback")
                check(st == 409, f"[{tag}] /rollback past the window: {st} {body}")
                # (d) C's algorithm raises: the smoke gate refuses it (its
                # tables are small: the gate, not the load, is under test)
                crng = np.random.default_rng(62)
                c_id = insert(serialize_model([convert.rec_model_from_arrays(
                    crng.standard_normal((64, RANK), dtype=np.float32),
                    crng.standard_normal((4096, RANK), dtype=np.float32),
                    np.zeros(64, np.float32), np.zeros(4096, np.float32), 3.0,
                    RANK, [f"u{i}" for i in range(64)],
                    [f"i{i}" for i in range(4096)])]), 2)
                write_variant(f"{__name__}.planted_engine")
                t0 = time.perf_counter()
                try:
                    st, body, _ = await post(f"{base}/reload")
                finally:
                    write_variant(FACTORY)
                    retire(c_id)
                steps["reload_c"] = time.perf_counter() - t0
                check(st == 409 and "planted fault" in body.get("error", ""),
                      f"[{tag}] the planted instance's reload: {st} {body}")
                dep = await deployment()
                check(dep["instanceId"] == a_id
                      and dep["lastReload"]["status"] == "rejected"
                      and dep["lastReload"]["instanceId"] == c_id,
                      f"[{tag}] after the smoke gate: {dep}")
                same_bodies(f"{tag} smoke gate",
                            (await post_all(s, q, payloads, False))[0], answers_a)
                # (e) B again, its dispatch failing: the serving breaker trips
                # inside probation and A is restored
                t0 = time.perf_counter()
                st, body, _ = await post(f"{base}/reload")
                steps["reload_b_again"] = time.perf_counter() - t0
                check(st == 200 and body["engineInstanceId"] == b_id,
                      f"[{tag}] the second /reload answered {st} {body}")
                m_probation2 = mem()

                def boom(batch):
                    raise ServingUnavailable("planted fault: B's dispatch fails")

                server.deployed.predict_batch = boom
                planted = []
                for p in payloads[:cfg.algo_breaker_threshold]:
                    st, body, _ = await post(q, p)
                    check(st == 200 and body == {**want_of[p["user"]],
                                                 "degraded": True},
                          f"[{tag}] planted failure answered {st} {body}")
                    planted.append(body)
                dep = await deployment()
                check(dep["instanceId"] == a_id
                      and dep["lastReload"]["status"] == "rolled_back"
                      and dep["lastReload"]["rolledBackFrom"] == b_id
                      and dep["rollbacks"] == 3,
                      f"[{tag}] after the breaker trip: {dep}")
                del boom
                same_bodies(f"{tag} probation rollback",
                            (await post_all(s, q, payloads, False))[0], answers_a)
                m_after2 = mem(collect=True)
                check(m_after2 - m_before < engine_bytes / 2,
                      f"[{tag}] device memory {m_after2} after the probation "
                      f"rollback, {m_before} before the reloads")
                steps["a_to_e"] = time.perf_counter() - t_phase
                # (h) starts here: the stream verb's process reaches the
                # card while (f) and (g) run on other servers over A's engine
                t_h = time.perf_counter()
                retire(b_id)  # the newest COMPLETED instance is A again
                log_path = os.path.join(root, "reload.piolog")
                CodecLog(log_path).append(live_events(
                    np.random.default_rng(67), RELOAD_STREAM_EVENTS,
                    N_USERS, N_ITEMS))
                state = os.path.join(root, "stream-state")
                before = server.deployed
                proc = await asyncio.create_subprocess_exec(
                    sys.executable, "-m",
                    "incubator_predictionio_tpu_torch.tools.cli", "stream",
                    "--once", "-v", variant, "--state-dir", state,
                    "--replica", base, "--feed-path", log_path, "--from-start",
                    "--batch-events", str(RELOAD_STREAM_EVENTS),
                    env=dict(os.environ, PIO_STREAM_FUSED="device",
                             PYTHONPATH=str(Path(__file__).resolve().parent)),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                # (f) overload, on two more servers over the live engine (A)
                t_f = time.perf_counter()

                async def one(url, p):
                    return await post(f"{url}/queries.json", p)

                clk2 = FakeClock()
                server2 = QueryServer(
                    ServerConfig(ip="127.0.0.1", port=free_port(),
                                 admission_max_queue=RELOAD_QUEUE),
                    storage=storage, ctx=ctx, deployed=server.deployed,
                    clock=clk2)
                servers.append(server2)
                await server2.start()
                base2 = f"http://127.0.0.1:{server2.config.port}"
                same_bodies(f"{tag} overload server", (await post_all(
                    s, f"{base2}/queries.json", payloads, False))[0], answers_a)
                burst = [payloads[i % RELOAD_USERS] for i in range(RELOAD_BURST)]
                got = await asyncio.gather(*[one(base2, p) for p in burst])
                outcomes = {"200": 0, "429": 0}
                for p, (st, body, ra) in zip(burst, got):
                    if st == 200:
                        check(body == want_of[p["user"]],
                              f"[{tag}] a burst answer is not A's live answer: {body}")
                    else:
                        check(st == 429 and ra is not None and int(ra) >= 1,
                              f"[{tag}] burst answered {st} {body} (Retry-After {ra})")
                    outcomes[str(st)] += 1
                check(outcomes["200"] > 0 and outcomes["429"] > 0,
                      f"[{tag}] burst outcomes {outcomes}")
                # brownout, on server2's fake clock: degraded = last good
                ctrl = server2._admission
                ctrl.decide(RELOAD_QUEUE - 2)
                clk2.advance(1.1)
                check(ctrl.decide(RELOAD_QUEUE - 2)[0] == "brownout",
                      f"[{tag}] no brownout: {ctrl.snapshot(0)}")
                brown = await asyncio.gather(*[one(base2, p) for p in payloads])
                clk2.advance(0.1)
                brown.append(await one(base2, payloads[0]))
                for p, (st, body, _) in zip(payloads + payloads[:1], brown):
                    check(st == 200 and body == {**want_of[p["user"]],
                                                 "degraded": True},
                          f"[{tag}] brownout answered {st} {body}")
                clk2.advance(2.1)
                st, body, _ = await one(base2, payloads[0])
                check(st == 200 and body == want_of[payloads[0]["user"]]
                      and not ctrl.brownout_active,
                      f"[{tag}] after the brownout: {st} {body}")
                outcomes["brownout_200"] = len(brown)
                rec["overload_degraded"] = await serving_verdict(
                    s, base2, f"{tag} overload", planted=len(brown))
                # 504: a dispatch held while RELOAD_USERS - 1 queue behind
                # it; their budget (fake clock) passes before assembly
                clk3 = FakeClock()
                server3 = QueryServer(
                    ServerConfig(ip="127.0.0.1", port=free_port(),
                                 query_timeout_sec=RELOAD_TIMEOUT_S,
                                 max_in_flight=1),
                    storage=storage, ctx=ctx, deployed=server.deployed,
                    clock=clk3)
                servers.append(server3)
                await server3.start()
                base3 = f"http://127.0.0.1:{server3.config.port}"
                live = server.deployed
                gate = threading.Event()

                def gated(batch, real=live.predict_batch):
                    gate.wait(timeout=30.0)
                    return real(batch)

                live.predict_batch = gated
                try:
                    first = asyncio.create_task(one(base3, payloads[0]))
                    await until(lambda: server3.batcher._inflight,
                                "the held dispatch")
                    rest = [asyncio.create_task(one(base3, p))
                            for p in payloads[1:]]
                    await until(lambda: server3.batcher.queue.qsize()
                                >= len(rest), "the queue behind it")
                    clk3.advance(1.5 * RELOAD_TIMEOUT_S)
                finally:
                    gate.set()
                st, body, _ = await first
                check(st == 200 and body == answers_a[0],
                      f"[{tag}] the held dispatch answered {st} {body}")
                for st, body, ra in await asyncio.gather(*rest):
                    check(st == 504 and ra is not None,
                          f"[{tag}] a queued query past its budget: {st} {body}")
                outcomes["504"] = len(rest)
                await serving_verdict(s, base3, f"{tag} shed")
                steps["overload"] = time.perf_counter() - t_f
                # (g) drain: SIGTERM through install_signal_drain while a
                # burst is held in flight (one dispatch, the rest queued)
                t_g = time.perf_counter()
                server4 = QueryServer(
                    ServerConfig(ip="127.0.0.1", port=free_port(),
                                 max_in_flight=1),
                    storage=storage, ctx=ctx, deployed=live, clock=FakeClock())
                servers.append(server4)
                await server4.start()
                base4 = f"http://127.0.0.1:{server4.config.port}"
                install_signal_drain(loop, server4._stop_event, "rec-reload")
                check(signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL,
                                                               None),
                      f"[{tag}] the drain's SIGTERM handler is not installed")
                waiter = asyncio.create_task(server4.wait_stopped())
                gate.clear()
                try:
                    inflight = [asyncio.create_task(one(base4, p))
                                for p in payloads]
                    # one held dispatch (the batch that coalesced first),
                    # the rest queued behind it
                    b4 = server4.batcher
                    await until(lambda: b4._inflight and b4.batches_served == 1
                                and b4.max_batch_seen + b4.queue.qsize()
                                == RELOAD_USERS, "the burst in flight")
                    await serving_verdict(s, base4, f"{tag} drain")
                    os.kill(os.getpid(), signal.SIGTERM)
                    await until(lambda: server4._drain_state.draining,
                                "the drain")
                    refused = await asyncio.gather(
                        *[one(base4, p) for p in payloads[:RELOAD_SMOKE]])
                finally:
                    gate.set()
                    loop.remove_signal_handler(signal.SIGTERM)
                    loop.remove_signal_handler(signal.SIGINT)
                finished = await asyncio.gather(*inflight)
                await asyncio.wait_for(waiter, 60)
                del live.predict_batch, gated, live
                for st, body, ra in refused:
                    check(st == 503 and ra is not None,
                          f"[{tag}] a query during the drain: {st} {body}")
                same_bodies(f"{tag} drained", [b for _, b, _ in finished],
                            answers_a)
                check(all(st == 200 for st, _, _ in finished),
                      f"[{tag}] in-flight statuses {[x[0] for x in finished]}")
                outcomes["drain_200"] = len(finished)
                outcomes["drain_503"] = len(refused)
                steps["drain"] = time.perf_counter() - t_g
                # (h) the stream verb's delta, applied to A on server 1
                out, err = await asyncio.wait_for(proc.communicate(), 600)
                out, err = out.decode(), err.decode()
                OUT.parent.mkdir(parents=True, exist_ok=True)
                (OUT.parent / "rec_reload_stream.log").write_text(out + err)
                check(proc.returncode == 0,
                      f"[{tag}] stream --once exited {proc.returncode}:\n"
                      f"{err[-4000:]}")
                steps["stream_verb"] = time.perf_counter() - t_h
                res = json.loads(out.strip().splitlines()[-1])
                check(res["status"] == "applied"
                      and res["events"] == RELOAD_STREAM_EVENTS
                      and res["ships"][0].get("shipped") == 1,
                      f"[{tag}] stream --once: {res}")
                m = re.search(r"stream: kernel launches (\{.*\})", err)
                check(m is not None, f"[{tag}] no launch line:\n{err[-4000:]}")
                child = json.loads(m.group(1))
                check(child["adam_rows"] == -(-RELOAD_STREAM_EVENTS // STREAM_MICRO),
                      f"[{tag}] K3 launched {child['adam_rows']} times in the "
                      "stream verb's process")
                dep = await deployment()
                check(dep["lastReload"]["status"] == "delta"
                      and dep["probationActive"] and server._previous is before
                      and dep["streaming"]["lastDeltaSeq"] == res["toSeq"],
                      f"[{tag}] after the stream verb's delta: {dep}")
                del before
                # the updater's state: its rows over A's tables
                with open(os.path.join(state, "trainer.pkl"), "rb") as f:
                    rows = pickle.load(f)["trainer"]["rows"]
                tu, ti = user.copy(), item.copy()
                tub, tib = user_bias.copy(), item_bias.copy()
                for (kind, idx), row in rows.items():
                    if kind == "u":
                        tu[idx], tub[idx] = row[:RANK], row[RANK]
                    elif kind == "i":
                        ti[idx], tib[idx] = row[:RANK], row[RANK]
                touched = sorted(i for k, i in rows if k == "u")[:RELOAD_USERS]
                bodies, _ = await post_all(s, q, [{"user": f"u{u}", "num": 10}
                                                  for u in touched], False)
                stream_same = check_vs_cpu(f"{tag} stream", (tu, ti, tub, tib,
                                                             3.0), touched, bodies)
                del tu, ti, tub, tib
                # --status reads the state dir alone (cli_run: exit 0)
                st_info = json.loads(cli_run(f"{tag} status", [
                    "stream", "--state-dir", state, "--status"]))
                check(st_info["archivedDeltas"] == 1
                      and st_info["cursor"]["seq"] == res["toSeq"],
                      f"[{tag}] stream --status: {st_info}")
                # the window passes: the delta's pin is released and there
                # is nothing left to roll back to
                clk.advance(RELOAD_PROBATION_S + 1.0)
                dep = await deployment()
                check(not dep["probationActive"] and server._previous is None,
                      f"[{tag}] past the delta's window: {dep}")
                # (the first read names the pin it released, as the
                # reference's /health does)
                dep = await deployment()
                check(dep["previousInstanceId"] is None,
                      f"[{tag}] past the delta's window: {dep}")
                st, body, _ = await post(f"{base}/rollback")
                check(st == 409, f"[{tag}] /rollback past the delta's window: "
                      f"{st} {body}")
                steps["stream_checks"] = time.perf_counter() - t_h - steps[
                    "stream_verb"]
                rec["degraded"] = await serving_verdict(
                    s, base, tag, planted=len(planted))
        finally:
            if proc is not None and proc.returncode is None:
                proc.kill()
                await proc.wait()
            for srv in servers:
                await srv.shutdown()
    launches = {"score_catalog_quantized": R.score_catalog_quantized.launches}
    check(launches["score_catalog_quantized"] > 0,
          f"[{tag}] K1 never launched in the phase")
    phase_s = time.perf_counter() - t_phase
    mib = 2 ** 20
    rec.update({
        "phase_s": phase_s, "steps_s": steps, "outcomes": outcomes,
        "memory_allocated_bytes": {
            "before_reload": m_before, "in_probation": m_probation,
            "after_rollback": m_after, "in_probation_again": m_probation2,
            "after_probation_rollback": m_after2},
        "b_vs_cpu_same_ids_order": b_same, "stream_vs_cpu_same_ids_order": stream_same,
        "stream_verb": {"events": res["events"], "rows": res["rows"],
                        "process_launches": child, "toSeq": res["toSeq"]},
        "launches": launches})
    log(f"[{tag}] device memory allocated ({smi}): {m_before / mib:.1f} MiB "
        f"before the reload, {m_probation / mib:.1f} MiB in probation (A "
        f"pinned beside B), {m_after / mib:.1f} MiB after the rollback; "
        f"{m_probation2 / mib:.1f} / {m_after2 / mib:.1f} MiB around the "
        "probation rollback")
    log(f"[{tag}] outcomes {outcomes}; the stream verb's process: K3 "
        f"{child['adam_rows']} launches, {res['events']} events, {res['rows']} "
        f"rows; K1 {launches['score_catalog_quantized']} launches in the phase")
    log(f"[{tag}] phase {phase_s:.1f} s on {smi}: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in steps.items()))
    return launches, rec


# -- rec-obs: the telemetry that reads the card ------------------------------

#: rec-obs: 4 bursts of 64 queries (the same 64 users in each), 16 of the
#: 256 carrying a seeded X-PIO-Trace; the phase's budget in seconds
OBS_BURSTS, OBS_BURST, OBS_TRACED, OBS_BUDGET_S = 4, 64, 16, 15.0
#: traced runs of a block whose trace misses the kernels it ran, in all:
#: on the H100 machine a torch.profiler trace came back, now and then,
#: without the record of a kernel that had run (``device_ms_of``), once
#: rec-obs's traced burst without its K1 launch; each repeat is logged
TRACE_TRIES = 3
#: a scope's phase buckets sum to within this share of its wall (the
#: reference's conservation contract, obs/profile.py)
CONSERVE_TOL = 0.10
#: PERF.md's K1 row: device ms at (B 64, N 1,000,448, D 32)
K1_PERF_ROW_MS = 0.1113
#: earlier readings on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6), to
#: print beside this run's: rec-workflow's CLI train without a profiler
#: (s), rec-shard's sharded exact and exact lanes without the fences at
#: shard.search's phase edges, shard_ab.py's sharded lane on one and four
#: cards (q/s)
WF_TRAIN_UNPROFILED_S = 2.52
SHARD_LANES_UNFENCED_QPS = {"sharded_exact": 13_395.8, "exact": 14_765.3,
                            "shard_ab_one_card": 13_975.1,
                            "shard_ab_four_cards": 2_911.8}


def phase_delta(before: dict, scope: str) -> dict:
    """``scope``'s profiler aggregates since ``before`` (an earlier
    ``obs/profile.py`` ``phase_snapshot()``): wall seconds, scope count, and
    each phase that moved (seconds, count)."""
    from incubator_predictionio_tpu_torch.obs import profile as P

    empty = {"wall_seconds": 0.0, "count": 0, "phases": {}}
    now, was = P.phase_snapshot().get(scope, empty), before.get(scope, empty)
    phases = {}
    for p, v in now["phases"].items():
        old = was["phases"].get(p, {"seconds": 0.0, "count": 0})
        if v["count"] > old["count"]:
            phases[p] = {"seconds": v["seconds"] - old["seconds"],
                         "count": v["count"] - old["count"]}
    return {"wall_seconds": now["wall_seconds"] - was["wall_seconds"],
            "count": now["count"] - was["count"], "phases": phases}


def check_phases(tag: str, scope: str, d: dict, names) -> dict:
    """The scope ran, every phase in ``names`` was recorded, and the phases
    sum to within :data:`CONSERVE_TOL` of the scope's wall; logs the
    breakdown and returns it with the covered share."""
    check(d["count"] > 0, f"[{tag}] no {scope} scope was recorded")
    check(set(names) <= set(d["phases"]),
          f"[{tag}] {scope} phases {sorted(d['phases'])}, want {sorted(names)}")
    wall = d["wall_seconds"]
    covered = sum(v["seconds"] for v in d["phases"].values())
    check(abs(covered - wall) <= CONSERVE_TOL * wall,
          f"[{tag}] {scope} phases sum to {covered:.6f} s of a {wall:.6f} s "
          "wall")
    log(f"[{tag}] {scope}: {d['count']} scope(s), wall {wall * 1e3:.3f} ms; "
        + ", ".join(f"{p} {v['seconds'] * 1e3:.3f} ms "
                    f"({v['seconds'] / wall:.1%}, {v['count']}x)"
                    for p, v in sorted(d["phases"].items(),
                                       key=lambda kv: -kv[1]["seconds"]))
        + f"; covered {covered / wall:.4f} of the wall")
    return {**d, "covered_share": covered / wall}


def sample(page: dict, name: str, **labels):
    """The value of one sample of a parsed exposition (None if absent)."""
    for sname, lab, value in page.get(name, {"samples": []})["samples"]:
        if sname == name and lab == labels:
            return value
    sub = name.rsplit("_", 1)[0]
    for sname, lab, value in page.get(sub, {"samples": []})["samples"]:
        if sname == name and lab == labels:
            return value
    return None


def close_bodies(tag: str, got, want, tol: float = 1e-4) -> None:
    """Answers of the same users in another batch: every score within
    ``tol`` of the earlier answer's, and an id may differ only through a
    near-tie at the last place (K1's two kernels, B ≤ 8 and B > 8, sum in
    other orders)."""
    for g, w in zip(got, want, strict=True):
        gs = {x["item"]: x["score"] for x in g["itemScores"]}
        ws = {x["item"]: x["score"] for x in w["itemScores"]}
        last = min(ws.values())
        for k in gs.keys() & ws.keys():
            check(abs(gs[k] - ws[k]) <= tol, f"[{tag}] {k}: {gs[k]} vs {ws[k]}")
        for k in gs.keys() ^ ws.keys():
            check(abs(gs.get(k, ws.get(k)) - last) <= tol,
                  f"[{tag}] {sorted(gs)} vs {sorted(ws)} beyond a near-tie")


def trace_events(log_dir: str) -> tuple[list, int]:
    """The events of the one ``*.pt.trace.json`` ``profile_trace`` wrote
    under ``log_dir``, and its size in bytes."""
    paths = sorted(Path(log_dir).glob("*.pt.trace.json"))
    check(len(paths) == 1, f"trace files under {log_dir}: {paths}")
    return json.loads(paths[0].read_text())["traceEvents"], paths[0].stat().st_size


async def obs_cli(tag: str, argv) -> tuple[int, str]:
    """One CLI verb in a fresh process from the repo root (the server it
    reads runs on this process's event loop)."""
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
        *argv, cwd=root, env=env, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.STDOUT)
    try:
        out, _ = await asyncio.wait_for(proc.communicate(), 120)
    except asyncio.TimeoutError:
        proc.kill()
        await proc.wait()
        raise
    text = out.decode()
    check(proc.returncode == 0, f"[{tag}] {argv} exited {proc.returncode}: "
          f"{text[-2000:]}")
    return proc.returncode, text


async def obs_phase(R, towers_, eval_users, storage, variant_path, ctx, tmp,
                    smi):
    """The telemetry that reads the card, on the main path's persisted
    instance A (1,000,448 × 32, int8 K1, exact), on the real clock, every
    count at 0 just before and read just after: (a) 4 bursts of 64 over
    the socket, 16 of them with a seeded ``X-PIO-Trace``, ``/metrics``
    scraped before and after and parsed with the port's strict parser
    (requests and the latency histogram count the 200s sent, ``serve.batch``
    a scope a batch and its four phases conserving the wall, each traced
    request's span in ``/traces.json``, ``serve.batch`` in
    ``/profile.json``, the answers the plain CPU path's); (b) the device
    memory watermark between ``memory_allocated`` and the card's total, the
    in-use gauge, ``jitCompileKeys``; (c) a burst of 64 traced by
    ``torch.profiler`` (K1's kernel and the ``serve.batch`` range in the
    file); (f) the CLI ``metrics``, ``profile`` and ``status`` as processes
    against the server. Returns (launches, record)."""
    import aiohttp

    from incubator_predictionio_tpu_torch.obs import profile as P
    from incubator_predictionio_tpu_torch.obs.metrics import (
        parse_prometheus_text,
    )
    from incubator_predictionio_tpu_torch.server.query_server import (
        QueryServer,
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.utils import tracing

    tag = "rec-obs"
    t_phase = time.perf_counter()
    steps: dict = {}
    user, item, user_bias, item_bias = towers_
    users = [int(u) for u in eval_users[:OBS_BURST]]
    payloads = [{"user": f"u{u}", "num": 10} for u in users]
    rng = np.random.default_rng(71)
    n = OBS_BURSTS * OBS_BURST
    picks = sorted(int(i) for i in rng.choice(n, OBS_TRACED, replace=False))
    traced = {i: (f"{int(rng.integers(1, 1 << 62)):016x}",
                  f"{int(rng.integers(1, 1 << 62)):016x}") for i in picks}
    http_200 = {"service": "query_server", "route": "/queries.json",
                "method": "POST", "status": "200"}
    rec = {"card": smi, "traced": len(traced)}
    R.reset_launches()
    with retrieval_mode("exact"):
        cfg = ServerConfig(engine_variant=variant_path, ip="127.0.0.1",
                           port=free_port())
        t0 = time.perf_counter()
        server = QueryServer(cfg, storage=storage, ctx=ctx)
        torch.cuda.synchronize()
        steps["deploy"] = time.perf_counter() - t0
        info = server.deployed.models[0].serving_info()
        check(info["path"] == "device-int8" and info["retrieval_mode"] == "exact"
              and info["device"].startswith("cuda"), f"[{tag}] A serves {info}")
        await server.start()
        base = f"http://127.0.0.1:{cfg.port}"
        try:
            async with aiohttp.ClientSession(
                    connector=aiohttp.TCPConnector(limit=0)) as s:
                async def scrape() -> dict:
                    async with s.get(f"{base}/metrics") as r:
                        check(r.status == 200, f"[{tag}] /metrics {r.status}")
                        return parse_prometheus_text(await r.text())

                async def get_json(path):
                    async with s.get(f"{base}{path}") as r:
                        check(r.status == 200, f"[{tag}] {path} {r.status}")
                        return await r.json()

                async def one(i, p):
                    hdr = ({"X-PIO-Trace": f"{traced[i][0]}:{traced[i][1]}:s=1"}
                           if i in traced else {})
                    async with s.post(f"{base}/queries.json", json=p,
                                      headers=hdr) as r:
                        body = await r.json()
                        echo = r.headers.get("X-PIO-Trace")
                    check(r.status == 200 and not body.get("degraded"),
                          f"[{tag}] query {i}: {r.status} {body}")
                    want = traced[i][0] if i in traced else echo
                    check(echo is not None and echo == want and len(echo) == 16,
                          f"[{tag}] query {i} echoed {echo!r}, sent {traced.get(i)}")
                    return body

                # (a) the server's counts against the requests sent
                t0 = time.perf_counter()
                snap = P.phase_snapshot()
                batches0 = server.batcher.batches_served
                before = await scrape()
                bursts = []
                for b in range(OBS_BURSTS):
                    bursts.append(await asyncio.gather(*[
                        one(b * OBS_BURST + j, p) for j, p in enumerate(payloads)]))
                after = await scrape()
                batches = server.batcher.batches_served - batches0
                steps["bursts"] = time.perf_counter() - t0

                def moved(name, **labels):
                    return ((sample(after, name, **labels) or 0.0)
                            - (sample(before, name, **labels) or 0.0))

                sent = n
                got_200 = moved("pio_http_requests_total", **http_200)
                got_hist = moved("pio_http_request_seconds_count",
                                 service="query_server", route="/queries.json")
                check(got_200 == sent and got_hist == sent,
                      f"[{tag}] {sent} 200s sent; pio_http_requests_total "
                      f"moved {got_200}, the latency histogram {got_hist}")
                scopes = moved("pio_profile_scopes_total", scope="serve.batch")
                serve = phase_delta(snap, "serve.batch")
                check(scopes == batches == serve["count"],
                      f"[{tag}] serve.batch scopes {scopes} (aggregates "
                      f"{serve['count']}) for {batches} batches served")
                rec["serve_batch"] = check_phases(
                    tag, "serve.batch", serve,
                    ("assemble", "mask", "dispatch", "merge"))
                for i, (tid, sid) in traced.items():
                    doc = await get_json(f"/traces.json?traceId={tid}")
                    spans = [(x["name"], x["parentId"], x["attrs"].get("status"))
                             for x in doc["spans"]]
                    check(("POST /queries.json", sid, 200) in spans,
                          f"[{tag}] trace {tid}: spans {spans}")
                prof = await get_json("/profile.json")
                check("serve.batch" in prof["phases"],
                      f"[{tag}] /profile.json phases {sorted(prof['phases'])}")
                for b in range(1, OBS_BURSTS):
                    close_bodies(f"{tag} burst {b}", bursts[b], bursts[0])
                t0 = time.perf_counter()
                same = check_vs_cpu(tag, (user, item, user_bias, item_bias, 3.0),
                                    users, bursts[0])
                steps["vs_cpu"] = time.perf_counter() - t0
                rec.update({"sent": sent, "http_200": got_200,
                            "latency_count": got_hist, "batches": batches,
                            "cpu_same_ids_order": same})

                # (b) the card's memory
                torch.cuda.synchronize()
                allocated = torch.cuda.memory_allocated()
                total = torch.cuda.mem_get_info()[1]
                page = await scrape()
                peak = sample(page, "pio_device_bytes_peak", device="cuda:0")
                in_use = sample(page, "pio_device_bytes_in_use", device="cuda:0")
                check(peak is not None and allocated <= peak <= total,
                      f"[{tag}] pio_device_bytes_peak {peak} outside "
                      f"[{allocated}, {total}]")
                check(in_use is not None and in_use > 0,
                      f"[{tag}] pio_device_bytes_in_use {in_use}")
                health = await get_json("/health")
                check(health["jitCompileKeys"] >= 1,
                      f"[{tag}] jitCompileKeys {health['jitCompileKeys']}")
                rec["memory"] = {"memory_allocated": allocated, "total": total,
                                 "peak_gauge": peak, "in_use_gauge": in_use,
                                 "jit_compile_keys": health["jitCompileKeys"]}
                log(f"[{tag}] device memory ({smi}): watermark {peak} B, in "
                    f"use {in_use} B, memory_allocated {allocated} B, card "
                    f"total {total} B; jitCompileKeys {health['jitCompileKeys']}")
                if torch.cuda.device_count() > 1:
                    mem = subprocess.run(
                        ["nvidia-smi", "--query-gpu=index,memory.used",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, timeout=60).stdout.strip()
                    log(f"[{tag}] per-card memory after a scrape: {mem}")
                    rec["per_card_memory"] = mem

                # (c) one burst traced by torch.profiler, repeated (up to
                # TRACE_TRIES bursts in all) where its trace misses K1
                sym = RETRIEVAL_SYMBOLS["score_catalog_quantized"]
                t0 = time.perf_counter()
                for attempt in range(1, TRACE_TRIES + 1):
                    tdir = tempfile.mkdtemp(prefix="rec-obs-trace-", dir=tmp)
                    k1_before = R.score_catalog_quantized.launches
                    with tracing.profile_trace(tdir):
                        with tracing.annotate("serve.batch"):
                            traced_burst = await asyncio.gather(*[
                                one(-1 - j, p) for j, p in enumerate(payloads)])
                        torch.cuda.synchronize()
                    close_bodies(f"{tag} traced burst", traced_burst, bursts[0])
                    events, size = trace_events(tdir)
                    k1 = [e for e in events if e.get("cat") == "kernel"
                          and sym in e.get("name", "")]
                    ranges = [e for e in events if e.get("name") == "serve.batch"]
                    if k1:
                        break
                    cats = collections.Counter(e.get("cat") for e in events)
                    log(f"[{tag}] traced burst {attempt} of {TRACE_TRIES}: no "
                        f"K1 kernel in its trace ({size} B; events by category "
                        f"{dict(cats)}; K1 launched "
                        f"{R.score_catalog_quantized.launches - k1_before} "
                        "times in the burst)")
                steps["profiled_burst"] = time.perf_counter() - t0
                check(k1 and ranges, f"[{tag}] the trace holds {len(k1)} K1 "
                      f"kernels and {len(ranges)} serve.batch ranges "
                      f"(traced burst {attempt} of {TRACE_TRIES})")
                k1_ms = sum(e["dur"] for e in k1) / len(k1) / 1e3 if k1 else None
                rec["trace"] = {"bytes": size, "k1_kernels": len(k1),
                                "k1_device_ms": k1_ms, "tries": attempt}
                log(f"[{tag}] traced burst of {OBS_BURST}: {size} B of trace, "
                    f"{len(k1)} K1 kernels "
                    f"({sorted({e['name'][:40] for e in k1})}), {fmt(k1_ms)} "
                    f"ms a launch (PERF.md's K1 row: {K1_PERF_ROW_MS} at B "
                    "64, N 1,000,448, D 32)")

                # (f) the CLI against this server, three processes at once
                t0 = time.perf_counter()
                outs = await asyncio.gather(
                    obs_cli(tag, ["metrics", base, "--filter", "pio_http"]),
                    obs_cli(tag, ["profile", base]), obs_cli(tag, ["status"]))
                steps["cli"] = time.perf_counter() - t0
                (_, m_out), (_, p_out), (_, s_out) = outs
                check("pio_http_requests_total" in m_out,
                      f"[{tag}] metrics printed {m_out[-500:]}")
                check("serve.batch" in p_out,
                      f"[{tag}] profile printed {p_out[-500:]}")
                check("  cuda:0: " in s_out, f"[{tag}] status printed {s_out}")
                rec["cli_status"] = s_out.strip().splitlines()
                await serving_verdict(s, base, tag)
        finally:
            await server.shutdown()
    launches = {"score_catalog_quantized": R.score_catalog_quantized.launches}
    check(launches["score_catalog_quantized"] > 0,
          f"[{tag}] K1 never launched in the phase")
    rec.update({"launches": launches, "steps_s": steps,
                "phase_s": time.perf_counter() - t_phase})
    log(f"[{tag}] phase {rec['phase_s']:.1f} s (budget {OBS_BUDGET_S:.0f} s) "
        f"on {smi}: " + ", ".join(f"{k} {v:.2f} s" for k, v in steps.items())
        + f"; K1 {launches['score_catalog_quantized']} launches")
    return launches, rec


def mfu_check(tag: str, snap: dict, model, flops: float, smi: str) -> dict:
    """After a timed fit: ``train.fit``'s four phases are recorded, and the
    ``pio_training_mfu`` gauge equals this script's MFU of the fit (the
    same flops, the fit's own unrounded train seconds, the bf16 peak)."""
    from incubator_predictionio_tpu_torch.obs import profile as P
    from incubator_predictionio_tpu_torch.obs.metrics import (
        REGISTRY,
        parse_prometheus_text,
    )

    fit = check_phases(tag, "train.fit", phase_delta(snap, "train.fit"),
                       ("h2d", "init", "compute", "gather"))
    check(fit["count"] == 1, f"[{tag}] {fit['count']} train.fit scopes")
    train_s = fit["phases"]["compute"]["seconds"]
    check(round(train_s, 4) == model.timings["train_sec"],
          f"[{tag}] train.fit compute {train_s} vs timings "
          f"{model.timings['train_sec']}")
    peak = P.detected_peak_flops()
    check(peak is not None, f"[{tag}] no bf16 peak known for the card ({smi})")
    gauge = sample(parse_prometheus_text(REGISTRY.expose()), "pio_training_mfu")
    mfu = flops / train_s / BF16_OPS_PER_S
    check(gauge is not None and abs(gauge - mfu) <= 1e-6 * mfu,
          f"[{tag}] pio_training_mfu {gauge} vs the script's {mfu}")
    log(f"[{tag}] pio_training_mfu {gauge:.6e} = the script's {mfu:.6e} "
        f"({flops:.4e} FLOPs over {train_s:.4f} s at {peak:.4g} FLOP/s; "
        f"{smi})")
    return {"train_fit": fit, "mfu_gauge": gauge, "mfu": mfu, "peak": peak}


# -- phases 11 and 12: training the recommendation template on the card -------

#: bench.py bench_recommendation_scaled's full configuration (:196-207):
#: 1,000,000 users, 100,000 items, rank 128, 4,000,000 events drawn as
#: _bench_two_tower draws them (:142-145, default_rng(9)), batch 65,536,
#: 4 epochs, bf16 adam moments
REC_USERS, REC_ITEMS, REC_RANK = 1_000_000, 100_000, 128
REC_EVENTS, REC_BATCH, REC_EPOCHS, REC_MOMENTS = 4_000_000, 65_536, 4, "bfloat16"
#: the one-step check of the card against the CPU, cut to tables the CPU
#: steps through in a second (one batch of 65,536 at rank 128)
REC_STEP_USERS, REC_STEP_ITEMS = 20_000, 5_000
#: each table's gradient on the card within this share of the CPU's max
#: abs (tests/test_torch_two_tower_training.py's band against JAX), the
#: loss within REC_STEP_LOSS_RTOL
REC_GRAD_TOL, REC_STEP_LOSS_RTOL = 4e-3, 1e-4
#: a 3-epoch fit on the card against the same fit on the CPU from the same
#: tables, at a cut size (20,000 users, 5,000 items, rank 128, 80,000
#: events, batch 32,768: 9 steps): the last epoch's loss within
#: REC_FIT_LOSS_RTOL relative, each table within REC_FIT_TABLE_RTOL
#: relative Frobenius error: tests/test_torch_two_tower_training.py's
#: bands for the port against JAX
REC_FIT_USERS, REC_FIT_ITEMS, REC_FIT_EVENTS, REC_FIT_BATCH = 20_000, 5_000, 80_000, 32_768
REC_FIT_LOSS_RTOL, REC_FIT_TABLE_RTOL = 1e-4, 1e-2
#: users queried after the deploy: 16 singles held against the plain CPU
#: path, 64 more in a burst, all 80 for two-stage recall
REC_EVAL_USERS = 80
#: rec-workflow: bench.py's MovieLens-1M shape (:108-110) through the CLI,
#: 100,000 rate events (cut from the bench's 1,000,000 for the phase's
#: time) and a few buys; rank 64, 20 iterations, batch 65,536
WF_USERS, WF_ITEMS, WF_EVENTS, WF_BUYS = 6040, 3706, 100_000, 50
WF_RANK, WF_ITERS, WF_BATCH = 64, 20, 65_536


def two_tower_flops_bytes(n_events, rank, batch, epochs, n_users, n_items,
                          moment_bytes):
    """bench.py:_two_tower_flops_bytes: (steps, FLOPs, HBM bytes) of a fit
    — per step 12·rank·batch + 12·params FLOPs, and each table read and
    written once, each moment read and written once at its storage width,
    plus the batch's row gathers."""
    n_batches = max(1, -(-n_events // batch))
    steps = epochs * n_batches
    n_params = (n_users + n_items) * (rank + 1)
    flops_step = 12 * rank * batch + 12 * n_params
    bytes_step = n_params * (4 * 2 + moment_bytes * 4) + batch * rank * 4 * 4
    return steps, steps * flops_step, steps * bytes_step


def rec_fit(ctx, data, seed, epochs=REC_EPOCHS):
    from incubator_predictionio_tpu_torch.models.two_tower import (
        TwoTowerConfig,
        TwoTowerMF,
    )

    users, items, ratings = data
    return TwoTowerMF(TwoTowerConfig(
        rank=REC_RANK, batch_size=REC_BATCH, epochs=epochs, seed=seed,
        adam_moments_dtype=REC_MOMENTS)).fit(
            ctx, users, items, ratings, REC_USERS, REC_ITEMS)


def rec_step_by_op(model, data, dev, tables=None) -> dict:
    """One step of the fit on a copy of the trained tables (its first
    staged batch), on the card: the device time of its loss-and-gradient
    half by kind (the row gathers, the gradients' zeroing, the
    scatter-add, the rest: the loss and the backward's elementwise work)
    and of its adam half, from ``torch.profiler``; then one whole step's
    device busy share of its wall time. ``tables`` (fused ``[ue, ie]`` on
    the card) stands in for a host model's."""
    from incubator_predictionio_tpu_torch.models.two_tower import (
        _loss_and_grads,
        _stage_batches,
    )
    from incubator_predictionio_tpu_torch.utils.optim import (
        adam_apply,
        adam_tree_init,
    )

    cfg = model.config
    staged = _stage_batches(cfg, *data)
    batch = [torch.from_numpy(a[0].copy()).to(dev) for a in staged[:4]]
    if tables is None:
        tables = [model._tables["ue"].clone(), model._tables["ie"].clone()]
    grads = [torch.empty_like(t) for t in tables]
    state = adam_tree_init(tables, cfg.adam_moments_dtype)

    def loss_half():
        _loss_and_grads(tables, grads, *batch, cfg.reg)

    def adam_half():
        adam_apply(tables, grads, state, cfg.learning_rate)

    def step():
        loss_half()
        adam_half()

    loss_ms, loss_by = device_busy(loss_half)
    adam_ms, adam_by = device_busy(adam_half)
    kinds = {"gather": ("indexSelect", "_scatter_gather_elementwise"),
             "scatter_add": ("indexFunc", "index_add"),
             "zero": ("FillFunctor", "fill_")}
    by_kind = {k: sum(t for n, t in loss_by.items() if any(s in n for s in syms))
               for k, syms in kinds.items()}
    by_kind["loss_elementwise"] = loss_ms - sum(by_kind.values())
    by_kind["adam"] = adam_ms
    step()
    torch.cuda.synchronize()
    with cuda_profile() as by_name:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = {"device_ms_by_op": by_kind, "step_device_ms": loss_ms + adam_ms,
           "loss_top_device_ms": dict(sorted(loss_by.items(), key=lambda kv: -kv[1])[:8]),
           "adam_top_device_ms": dict(sorted(adam_by.items(), key=lambda kv: -kv[1])[:8]),
           "profiled_step": busy_record(by_name, wall, 8)}
    del tables, grads, state, batch
    return rec


def rec_step_parity(dev) -> dict:
    """One step of the fit on the card against the same step on the CPU,
    from the same initial tables, at a cut size (:data:`REC_STEP_USERS` ×
    :data:`REC_STEP_ITEMS` at rank 128, one batch of 65,536 events): each
    table's gradient within :data:`REC_GRAD_TOL` of the CPU's max abs (the
    card sums duplicate rows with atomics, in no fixed order), the loss
    within :data:`REC_STEP_LOSS_RTOL`."""
    from incubator_predictionio_tpu_torch.models.two_tower import (
        TwoTowerConfig,
        _init_tables,
        _loss_and_grads,
        _stage_batches,
    )

    rng = np.random.default_rng(13)
    n = REC_BATCH
    data = (rng.integers(0, REC_STEP_USERS, n).astype(np.int32),
            rng.integers(0, REC_STEP_ITEMS, n).astype(np.int32),
            (1.0 + 4.0 * rng.random(n)).astype(np.float32))
    cfg = TwoTowerConfig(rank=REC_RANK, batch_size=REC_BATCH, seed=2)
    staged = _stage_batches(cfg, *data)
    init = _init_tables(cfg, REC_STEP_USERS, REC_STEP_ITEMS, "cpu",
                        torch.Generator().manual_seed(2))
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        tables = [t.to(d, copy=True) for t in init]
        grads = [torch.empty_like(t) for t in tables]
        batch = [torch.from_numpy(a[0].copy()).to(d) for a in staged[:4]]
        loss = _loss_and_grads(tables, grads, *batch, cfg.reg)
        out[name] = (float(loss), [g.cpu() for g in grads])
    (lc, gc_), (lg, gg) = out["cpu"], out["card"]
    rel = {k: float((a - b).abs().max() / b.abs().max())
           for k, a, b in zip(("ue", "ie"), gg, gc_)}
    res = {"users": REC_STEP_USERS, "items": REC_STEP_ITEMS, "rank": REC_RANK,
           "batch": n, "loss_card": lg, "loss_cpu": lc,
           "loss_rel_diff": abs(lg - lc) / abs(lc), "grad_rel_err": rel,
           "grad_tol": REC_GRAD_TOL}
    check(res["loss_rel_diff"] <= REC_STEP_LOSS_RTOL,
          f"[rec-train] step loss on the card {lg} vs the CPU {lc}")
    for k, e in rel.items():
        check(e <= REC_GRAD_TOL, f"[rec-train] the {k} gradient on the card "
              f"differs from the CPU's by {e} of its max abs (> {REC_GRAD_TOL})")
    log(f"[rec-train] one step, card vs CPU from the same tables "
        f"({REC_STEP_USERS}x{REC_STEP_ITEMS}, rank {REC_RANK}, batch {n}): loss "
        f"{lg:.6f} vs {lc:.6f} (rel {res['loss_rel_diff']:.2e}); gradients "
        + ", ".join(f"{k} {e:.2e}" for k, e in rel.items())
        + f" of their max abs (tol {REC_GRAD_TOL})")
    return res


def rec_fit_parity(dev) -> dict:
    """A 3-epoch fit on the card against the same fit on the CPU, from the
    same initial tables and staged batches, at a cut size (the
    ``REC_FIT_*`` constants): the whole loop — gathers, loss, scatter-add,
    the dense adam with bf16 moments — through ``_train_epochs`` on each
    device. Checks the last epoch's loss and every table."""
    from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerConfig

    rng = np.random.default_rng(17)
    n = REC_FIT_EVENTS
    data = (rng.integers(0, REC_FIT_USERS, n).astype(np.int32),
            rng.integers(0, REC_FIT_ITEMS, n).astype(np.int32),
            (1.0 + 4.0 * rng.random(n)).astype(np.float32))
    cfg = TwoTowerConfig(rank=REC_RANK, batch_size=REC_FIT_BATCH, epochs=3,
                         seed=3, adam_moments_dtype=REC_MOMENTS)
    return fit_parity(dev, "rec-train", data, REC_FIT_USERS, REC_FIT_ITEMS, cfg)


def fit_parity(dev, tag, data, n_users, n_items, cfg) -> dict:
    """``cfg.epochs`` of ``_train_epochs`` on the card against the same on
    the CPU, from the same initial tables (seed ``cfg.seed``) and staged
    batches of ``data``: the last epoch's loss within
    :data:`REC_FIT_LOSS_RTOL` relative, each table within
    :data:`REC_FIT_TABLE_RTOL` relative Frobenius error."""
    from incubator_predictionio_tpu_torch.models.two_tower import (
        _init_tables,
        _stage_batches,
        _train_epochs,
    )
    from incubator_predictionio_tpu_torch.utils.optim import adam_tree_init

    n = len(data[0])
    staged = _stage_batches(cfg, *data)
    init = _init_tables(cfg, n_users, n_items, "cpu",
                        torch.Generator().manual_seed(cfg.seed))
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        tables = [t.to(d, copy=True) for t in init]
        grads = [torch.empty_like(t) for t in tables]
        state = adam_tree_init(tables, cfg.adam_moments_dtype)
        batches = [torch.from_numpy(a).to(d) for a in staged[:4]]
        loss = _train_epochs(tables, grads, state, *batches, cfg.learning_rate,
                             cfg.reg, cfg.epochs)
        out[name] = (float(loss), [t.cpu() for t in tables])
    (lc, tc), (lg, tg) = out["cpu"], out["card"]
    rel = {k: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
           for k, a, b in zip(("ue", "ie"), tg, tc)}
    res = {"users": n_users, "items": n_items, "rank": cfg.rank, "events": n,
           "batch": cfg.batch_size, "epochs": cfg.epochs,
           "adam_moments_dtype": cfg.adam_moments_dtype,
           "steps": cfg.epochs * staged[0].shape[0], "loss_card": lg,
           "loss_cpu": lc, "loss_rel_diff": abs(lg - lc) / abs(lc),
           "table_rel_err": rel}
    check(np.isfinite(lg), f"[{tag}] cut fit loss on the card {lg}")
    check(res["loss_rel_diff"] <= REC_FIT_LOSS_RTOL,
          f"[{tag}] cut fit: loss on the card {lg} vs the CPU {lc}")
    for k, e in rel.items():
        check(e <= REC_FIT_TABLE_RTOL, f"[{tag}] cut fit: table {k} on the "
              f"card {e} relative Frobenius from the CPU's (> {REC_FIT_TABLE_RTOL})")
    log(f"[{tag}] {cfg.epochs}-epoch fit, card vs CPU from the same tables "
        f"({n_users}x{n_items}, rank {cfg.rank}, {n} events, "
        f"{res['steps']} steps): loss {lg:.6f} vs {lc:.6f} (rel "
        f"{res['loss_rel_diff']:.2e}, tol {REC_FIT_LOSS_RTOL}); tables "
        + ", ".join(f"{k} {e:.2e}" for k, e in rel.items())
        + f" (tol {REC_FIT_TABLE_RTOL})")
    return res


def rec_kernel_cases(R, mf, dev) -> tuple[list, list]:
    """K1 and K2 held against their plain versions at the trained model's
    shapes (D 128): K1 at B 64 over the trained catalog quantized on the
    card, K2 at the probe buckets over its IVF centroids."""
    k = mf.config.rank
    ie = mf._tables["ie"][: mf._n_items]
    items_q, scales, bias, mask = R.quantize_catalog_device(
        ie[:, :k].contiguous(), ie[:, k].contiguous())
    q = mf._tables["ue"][:64, :k].contiguous()
    k1 = [k1_case(R, q, items_q, scales, bias, mask)]
    ivf = mf._ivf
    cent_q, cent_s = R.quantize_rows(np.asarray(ivf.centroids[:, :-1], np.float32))
    cq, cs, cb = (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for v in R.pad_centroids(
                      cent_q, cent_s, np.asarray(ivf.centroids[:, -1], np.float32)))
    user = mf._tables["ue"][:256, :k].cpu().numpy()
    k2 = []
    for b in K2_BUCKETS:
        q_q, q_s = R.quantize_rows(user[:b])
        k2.append(k2_case(R, torch.from_numpy(q_q).to(dev),
                          torch.from_numpy(q_s).to(dev), cq, cs, cb))
    for c in k1 + k2:
        c["trained_shape"] = True
    a, b = k1[0], next(c for c in k2 if c["B"] == 64)
    log(f"[rec-train] trained shapes: K1 B 64 N {a['N']} D {a['D']} device "
        f"{fmt(a['device_ms'])} ms, library (torch.matmul, dequantized) "
        f"{a['library_ms']:.4f} ms, bound {a['bound_ms']:.4f} ms ({a['bound_by']}); "
        f"K2 B 64 C {b['C']} ({ivf.n_partitions} centroids padded) D {b['D']} device "
        f"{fmt(b['device_ms'])} ms, library {b['library_ms']:.4f} ms, bound "
        f"{b['bound_ms']:.6f} ms ({b['bound_by']})")
    return k1, k2


@contextlib.contextmanager
def env_vars(**values):
    """Environment variables for one phase, restored after it."""
    prev = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


async def rec_serve(R, variant_path, storage, ctx, towers_, eval_users):
    """Deploy the persisted trained model through the QueryServer, exact
    (K1) then two-stage (K2), with the counts at 0 just before and read
    just after; returns (launches, record)."""
    lat = {}
    oracle = {}

    async def exact(session, url, server):
        info = server.deployed.models[0].serving_info()
        check(info["path"] == "device-int8" and info["device"].startswith("cuda")
              and info["device_resident"],
              f"[rec-exact] not on the device int8 path of a resident model: {info}")
        check(info["retrieval_mode"] == "exact", f"[rec-exact] not exact: {info}")
        singles = [{"user": f"u{u}", "num": 10} for u in eval_users[:16]]
        b_single, lat["rec_exact_single"] = await post_all(session, url, singles, False)
        burst = [{"user": f"u{u}", "num": 10} for u in eval_users[16:]]
        b_burst, lat["rec_exact_burst64"] = await post_all(session, url, burst, True)
        for p, body in zip(singles + burst, b_single + b_burst):
            check(len(body["itemScores"]) == 10, f"[rec-exact] short answer {body}")
            oracle[p["user"]] = ids_of(body)
        bl = [{"user": p["user"], "num": 10, "blackList": oracle[p["user"]][:3]}
              for p in singles[:8]]
        b_bl, lat["rec_exact_blacklist"] = await post_all(session, url, bl, True)
        for p, body in zip(bl, b_bl):
            got = ids_of(body)
            check(len(got) == 10 and not set(got) & set(p["blackList"]),
                  f"[rec-exact] banned id served: {body}")
        same_set, same_order = check_vs_cpu("rec-exact", towers_,
                                            eval_users[:16], b_single)
        return {"cpu_same_ids": same_set, "cpu_same_order": same_order}

    async def two_stage(session, url, server):
        info = server.deployed.models[0].serving_info()
        check(info["retrieval_mode"] == "two_stage",
              f"[rec-two-stage] not two-stage: {info}")
        check((info["index"] or {}).get("coarse_device", "").startswith("cuda"),
              f"[rec-two-stage] coarse stage not on the card: {info}")
        k2_deploy = R.score_centroids_quantized.launches
        payload = [{"user": f"u{u}", "num": 10} for u in eval_users]
        bodies, lat["rec_two_stage"] = await post_all(session, url, payload, True)
        hits = 0
        for p, body in zip(payload, bodies):
            got = ids_of(body)
            check(len(got) == 10, f"[rec-two-stage] short answer {body}")
            hits += len(set(got) & set(oracle[p["user"]]))
        check(R.score_centroids_quantized.launches > k2_deploy,
              "[rec-two-stage] K2 did not launch on the queries")
        recall = hits / (10 * len(payload))
        log(f"[rec-two-stage] recall@10 vs the exact answers: {recall:.4f} "
            "(no floor: tables trained on uniform random events have no "
            f"cluster structure); index {info['index']}")
        return {"recall_at_10": recall, "index": info["index"]}

    R.reset_launches()
    with retrieval_mode("exact"):
        res_a = await serve_phase("rec-exact", variant_path, storage, ctx, exact)
    gc.collect()
    torch.cuda.empty_cache()
    with retrieval_mode("auto"):
        res_b = await serve_phase("rec-two-stage", variant_path, storage, ctx,
                                  two_stage)
    launches = {"score_catalog_quantized": R.score_catalog_quantized.launches,
                "score_centroids_quantized": R.score_centroids_quantized.launches}
    for name, count in launches.items():
        check(count > 0, f"[rec-train] {name} never launched serving the "
              "trained model")
    latency = {k: {"n": len(v), "p50_ms": pct(v, 50), "p99_ms": pct(v, 99)}
               for k, v in lat.items()}
    for k, v in latency.items():
        log(f"latency {k:<20s} n={v['n']:<4d} p50={v['p50_ms']:.2f} ms "
            f"p99={v['p99_ms']:.2f} ms")
    return launches, {"exact": res_a, "two_stage": res_b, "latency": latency}


def rec_train_phase(R, ctx, tmp):
    """Train the recommendation template's model at bench_recommendation_
    scaled's full configuration through the port's ``TwoTowerMF.fit`` on
    the card (a warm-up fit with seed 0, the timed fit with seed 1, a
    1-epoch fit to compare the loss with), profile one step by op, hold
    one step against the CPU, persist the device-resident model, load it
    back, deploy it through the QueryServer (K1, K2 at D 128) and hold K1
    and K2 against their plain versions at its shapes. Returns (launches,
    record)."""
    import datetime as dt

    from incubator_predictionio_tpu_torch.core.controller import class_path
    from incubator_predictionio_tpu_torch.core import PersistentModelManifest
    from incubator_predictionio_tpu_torch.data.bimap import BiMap
    from incubator_predictionio_tpu_torch.data.storage import (
        EngineInstance,
        Model,
        Storage,
    )
    from incubator_predictionio_tpu_torch.templates.recommendation import (
        ALSAlgorithmParams,
        RecModel,
    )
    from incubator_predictionio_tpu_torch.utils.serialization import (
        serialize_model,
    )

    dev = ctx.device
    rng = np.random.default_rng(9)
    data = (rng.integers(0, REC_USERS, REC_EVENTS).astype(np.int32),
            rng.integers(0, REC_ITEMS, REC_EVENTS).astype(np.int32),
            (1.0 + 4.0 * rng.random(REC_EVENTS)).astype(np.float32))
    t0 = time.perf_counter()
    warm = rec_fit(ctx, data, seed=0)
    warm_s = time.perf_counter() - t0
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    from incubator_predictionio_tpu_torch.obs import profile as P

    snap = P.phase_snapshot()
    t0 = time.perf_counter()
    model = rec_fit(ctx, data, seed=1)
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps, flops, nbytes = two_tower_flops_bytes(
        REC_EVENTS, REC_RANK, REC_BATCH, REC_EPOCHS, REC_USERS, REC_ITEMS,
        moment_bytes=2 if REC_MOMENTS == "bfloat16" else 4)
    # rec-obs (d): the timed fit's phases and the MFU gauge, read before
    # the next fit moves them
    obs = mfu_check("rec-train", snap, model, flops, smi_name_power())
    one = rec_fit(ctx, data, seed=1, epochs=1)
    loss_1 = one.final_loss
    del one
    t_train = model.timings["train_sec"]
    bound_step_ms = nbytes / steps / HBM_BYTES_PER_S * 1e3
    rec = {"users": REC_USERS, "items": REC_ITEMS, "rank": REC_RANK,
           "events": REC_EVENTS, "batch": REC_BATCH, "epochs": REC_EPOCHS,
           "steps": steps, "adam_moments_dtype": REC_MOMENTS,
           "warmup_fit_s": warm_s, "fit_s": fit_s, "timings": model.timings,
           "events_per_sec": REC_EPOCHS * REC_EVENTS / fit_s,
           "train_events_per_sec": REC_EPOCHS * REC_EVENTS / t_train,
           "step_ms": t_train / steps * 1e3,
           "hbm_util": nbytes / t_train / HBM_BYTES_PER_S,
           "mfu": flops / t_train / BF16_OPS_PER_S,
           "bytes_per_step": nbytes / steps, "bound_step_ms": bound_step_ms,
           "bound_train_events_per_sec": REC_EPOCHS * REC_EVENTS
           / (bound_step_ms * steps / 1e3),
           "final_loss": model.final_loss, "one_epoch_loss": loss_1,
           "peak_device_bytes": peak, "obs": obs}
    check(model.device_resident, "[rec-train] the trained tables are not resident")
    check(np.isfinite(model.final_loss) and np.isfinite(loss_1),
          f"[rec-train] final loss {model.final_loss}, 1-epoch {loss_1}")
    # no check that the loss falls: at this configuration (rank 128, four
    # events a user) the reference's fit raises its training loss from the
    # first epoch to the fourth too; rec_fit_parity holds the whole loop
    # against the CPU, and rec-workflow holds a falling loss
    log(f"[rec-train] fit {REC_USERS}x{REC_ITEMS} rank {REC_RANK}, {REC_EVENTS} "
        f"events x {REC_EPOCHS} epochs = {steps} steps of {REC_BATCH} "
        f"({REC_MOMENTS} moments): fit {fit_s:.3f} s (warm-up {warm_s:.3f} s), "
        f"timings {model.timings}; {rec['events_per_sec']:.1f} events/s, "
        f"{rec['train_events_per_sec']:.1f} train events/s, "
        f"{rec['step_ms']:.3f} ms a step (bound {bound_step_ms:.3f} ms), "
        f"hbm_util {rec['hbm_util']:.4f}, mfu {rec['mfu']:.5f}; loss "
        f"{model.final_loss:.6f} (1 epoch: {loss_1:.6f}); peak device memory "
        f"{peak / 2**30:.2f} GiB")
    rec["step_by_op"] = rec_step_by_op(model, data, dev)
    w = rec["step_by_op"]
    log(f"[rec-train] one step's device ms by op: "
        + ", ".join(f"{k}={v:.4f}" for k, v in w["device_ms_by_op"].items())
        + f"; profiled step wall {w['profiled_step']['wall_ms']:.3f} ms, busy "
        f"{w['profiled_step']['device_busy_ms']:.3f} ms (share "
        f"{w['profiled_step']['device_busy_share']:.4f}); adam top: "
        + ", ".join(f"{k[:50]}={v:.4f}" for k, v in w["adam_top_device_ms"].items()))
    rec["step_parity"] = rec_step_parity(dev)
    rec["fit_parity"] = rec_fit_parity(dev)
    del data
    gc.collect()

    # persist → load → deploy, under this phase's own PIO_FS_BASEDIR
    fs = os.path.join(tmp, "rec-train-fs")
    with env_vars(PIO_FS_BASEDIR=fs), retrieval_mode("auto"):
        t0 = time.perf_counter()
        user_map = BiMap({f"u{i}": i for i in range(REC_USERS)})
        item_map = BiMap({f"i{j}": j for j in range(REC_ITEMS)})
        model._prepare_index()  # as ALSAlgorithm.train: the IVF persists
        recm = RecModel(model, user_map, item_map)
        rec["index_build_s"] = time.perf_counter() - t0
        storage = Storage({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
        variant_path = os.path.join(tmp, "rec-train-engine.json")
        with open(variant_path, "w") as f:
            json.dump({"id": "rec-train", "version": "1", "engineFactory": FACTORY,
                       "algorithms": [{"name": "als",
                                       "params": {"rank": REC_RANK}}]}, f)
        now = dt.datetime.now(dt.timezone.utc)
        iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
            id="", status="COMPLETED", start_time=now, end_time=now,
            engine_id="rec-train", engine_version="1",
            engine_variant=os.path.abspath(variant_path), engine_factory=FACTORY))
        params = ALSAlgorithmParams(rank=REC_RANK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(recm.save(f"{iid}_0", params, ctx), "[rec-train] save did not persist")
        rec["persist_sec"] = time.perf_counter() - t0
        storage.get_model_data_models().insert(Model(iid, serialize_model(
            [PersistentModelManifest(class_path(RecModel))])))
        t0 = time.perf_counter()
        back = RecModel.load(f"{iid}_0", params, ctx)
        torch.cuda.synchronize()
        rec["deploy_load_sec"] = time.perf_counter() - t0
        for k in ("ue", "ie"):
            check(torch.equal(back.mf._tables[k], model._tables[k]),
                  f"[rec-train] table {k} differs after save → load")
        del back
        log(f"[rec-train] IVF index {model._ivf.n_partitions} partitions "
            f"(+ maps) {rec['index_build_s']:.2f} s; persist {rec['persist_sec']:.3f} s, "
            f"load {rec['deploy_load_sec']:.3f} s; tables bitwise after save → load")
        k = REC_RANK
        ue = model._tables["ue"].cpu().numpy()
        ie = model._tables["ie"].cpu().numpy()
        towers_ = (ue[:, :k].copy(), ie[:, :k].copy(), ue[:, k].copy(),
                   ie[:, k].copy(), model.mean)
        del ue, ie
        eval_users = np.random.default_rng(21).integers(0, REC_USERS, REC_EVAL_USERS)
        launches, rec["serve"] = asyncio.run(rec_serve(
            R, variant_path, storage, ctx, towers_, eval_users))
        del towers_
        rec["k1_cases"], rec["k2_cases"] = rec_kernel_cases(R, model, dev)
    del recm, model
    gc.collect()
    torch.cuda.empty_cache()
    # rec-stream deploys the persisted model again (popped by main)
    rec["persisted"] = {"fs": fs, "iid": iid, "variant_path": variant_path}
    return launches, rec


def one_iteration_loss(variant_path, ctx) -> float:
    """The final loss of the variant's training for one iteration, on the
    same events (read anew through its DataSource): what the trained
    model's loss must fall below."""
    from incubator_predictionio_tpu_torch.core.controller import (
        resolve_engine_factory,
        variant_from_file,
    )

    variant = variant_from_file(variant_path)
    engine = resolve_engine_factory(variant["engineFactory"])()
    ep = engine.engine_params_from_variant(variant)
    ds, _, (algo,), _ = engine._instantiate(ep)
    import dataclasses

    algo.params = dataclasses.replace(algo.params, num_iterations=1)
    return float(algo.train(ctx, ds.read_training(ctx)).mf.final_loss)


async def rec_workflow_body(one_loss, session, url, server):
    """The trained model's loss below a 1-iteration fit's; 16 users'
    served top-10 against numpy scoring of the trained tables (up to
    near-ties at the 10th place, scores within 1e-4), and a blackList
    never served."""
    model = server.deployed.models[0]
    check(np.isfinite(model.mf.final_loss) and model.mf.final_loss < one_loss,
          f"[rec-workflow] the trained loss {model.mf.final_loss} is not below "
          f"a 1-iteration fit's {one_loss}")
    info = model.serving_info()
    check(info["path"] == "host-numpy", f"[rec-workflow] serving path {info}")
    mf = model.mf.ensure_host()
    inv = model.item_map.inverse()
    users = [f"u{u}" for u in range(0, WF_USERS, WF_USERS // 16)][:16]
    payloads = [{"user": u, "num": 10} for u in users]
    bodies, ls = await post_all(session, url, payloads, False)
    same = 0
    for u, body in zip(users, bodies):
        r = model.user_map[u]
        s = (mf.user_emb[r] @ mf.item_emb.T + mf.item_bias + mf.user_bias[r]
             + mf.mean)
        top = np.argsort(-s, kind="stable")[:12]
        want = [inv[int(i)] for i in top[:10]]
        got = ids_of(body)
        for iid in set(got) ^ set(want):
            j = model.item_map[iid]
            check(abs(float(s[j]) - float(s[top[9]])) <= 1e-4,
                  f"[rec-workflow] top-10 of {u} differs from numpy beyond a "
                  f"near-tie: {got} vs {want}")
        for item in body["itemScores"]:
            check(abs(item["score"] - float(s[model.item_map[item["item"]]])) <= 1e-4,
                  f"[rec-workflow] score {item} vs numpy")
        same += got == want
    bl = [{"user": u, "num": 10, "blackList": ids_of(b)[:3]}
          for u, b in zip(users[:8], bodies[:8])]
    b_bl, _ = await post_all(session, url, bl, True)
    for p, body in zip(bl, b_bl):
        check(len(ids_of(body)) == 10 and not set(ids_of(body)) & set(p["blackList"]),
              f"[rec-workflow] banned id served: {body}")
    log(f"[rec-workflow] top-10 of 16 users equal to numpy scoring of the "
        f"trained tables for {same}/16 (the rest up to near-ties); no "
        f"blackList id served")
    return {"same_top10": same, "final_loss": model.mf.final_loss,
            "timings": getattr(model.mf, "timings", None),
            "latency_p50_ms": pct(ls, 50), "latency_p99_ms": pct(ls, 99)}


def rec_workflow_phase(R, ctx, tmp):
    """The normal entry points, in-process, on sqlite storage under this
    phase's own ``PIO_FS_BASEDIR``: CLI ``app new``, ``import`` of a
    JSON-lines file of 100,000 rate events at the MovieLens-1M shape
    (``default_rng(42)`` as bench.py draws them) and a few buys, CLI
    ``train`` (on the card) with an engine.json of rank 64, 20 iterations,
    batch 65,536, then a deploy through the QueryServer and queries over a
    socket. Returns (launches, record)."""
    import datetime as dt
    import io

    from incubator_predictionio_tpu_torch.data.storage import registry
    from incubator_predictionio_tpu_torch.tools import cli

    wf = os.path.join(tmp, "rec-workflow")
    os.makedirs(wf, exist_ok=True)
    env = {"PIO_FS_BASEDIR": wf, "PIO_STORAGE_SOURCES_WF_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_WF_PATH": os.path.join(wf, "pio.db")}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = f"pio_{repo.lower()}"
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "WF"
    rng = np.random.default_rng(42)
    users = rng.integers(0, WF_USERS, WF_EVENTS)
    items = rng.integers(0, WF_ITEMS, WF_EVENTS)
    ratings = (1.0 + 4.0 * rng.random(WF_EVENTS)).astype(np.float32)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    events_path = os.path.join(wf, "events.json")
    with open(events_path, "w") as f:
        for j, (u, i, r) in enumerate(zip(users, items, ratings)):
            f.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "properties": {"rating": float(r)},
                "eventTime": (t0 + dt.timedelta(seconds=j)).isoformat()}) + "\n")
        for j in range(WF_BUYS):
            f.write(json.dumps({
                "event": "buy", "entityType": "user", "entityId": f"u{j}",
                "targetEntityType": "item", "targetEntityId": f"i{(j * 7) % WF_ITEMS}",
                "eventTime": (t0 + dt.timedelta(seconds=WF_EVENTS + j)).isoformat()})
                + "\n")
    variant_path = os.path.join(wf, "engine.json")
    with open(variant_path, "w") as f:
        json.dump({"id": "rec-workflow", "version": "1", "engineFactory": FACTORY,
                   "datasource": {"params": {"appName": "ml1m"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": WF_RANK, "numIterations": WF_ITERS,
                       "batchSize": WF_BATCH}}]}, f)

    def run(argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        check(rc == 0, f"[rec-workflow] {argv} exited {rc}: {buf.getvalue()}")
        return buf.getvalue()

    rec = {"events": WF_EVENTS, "buys": WF_BUYS, "rank": WF_RANK,
           "iterations": WF_ITERS, "batch": WF_BATCH}
    # the CLI's own logging set-up (INFO) must not flood the rest of the
    # run: warnings only, as before it
    logging.basicConfig(level=logging.WARNING,
                        format="[%(levelname)s] [%(name)s] %(message)s")
    prev = registry.use_storage(None)
    try:
        with env_vars(**env):
            out = run(["app", "new", "ml1m"])
            app_id = int(out.split("ID: ")[-1].split()[0])
            s0 = time.perf_counter()
            out = run(["import", "--appid", str(app_id), "--input", events_path])
            rec["import_s"] = time.perf_counter() - s0
            check(f"Imported {WF_EVENTS + WF_BUYS} events." in out,
                  f"[rec-workflow] import: {out}")
            # rec-obs (f): the profiled train's trace holds the card's
            # kernels; a train whose trace has none is run again (up to
            # TRACE_TRIES trains in all), the last one's instance kept
            for attempt in range(1, TRACE_TRIES + 1):
                s0 = time.perf_counter()
                tdir = os.path.join(wf, f"train-trace-{attempt}")
                out = run(["train", "-v", variant_path, "--device",
                           str(ctx.device), "--profile-dir", tdir])
                rec["train_s"] = time.perf_counter() - s0
                events, size = trace_events(tdir)
                kernels = sum(e.get("cat") == "kernel" for e in events)
                if kernels:
                    break
                log(f"[rec-workflow] profiled train {attempt} of {TRACE_TRIES}: "
                    f"no kernel event in its trace ({size} B; events by "
                    f"category {dict(collections.Counter(e.get('cat') for e in events))})")
            check(kernels > 0, f"[rec-workflow] the train trace ({size} B) "
                  f"holds no CUDA kernel event (train {attempt} of {TRACE_TRIES})")
            rec["train_trace"] = {"bytes": size, "kernel_events": kernels,
                                  "tries": attempt}
            log(f"[rec-workflow] train --profile-dir: {rec['train_s']:.2f} s "
                f"(without it: {WF_TRAIN_UNPROFILED_S} s), a trace of "
                f"{size} B with {kernels} kernel events ({smi_name_power()})")
            iid = out.split("Engine instance ID: ")[-1].strip()
            storage = registry.get_storage()
            inst = storage.get_meta_data_engine_instances().get(iid)
            check(inst is not None and inst.status == "COMPLETED",
                  f"[rec-workflow] instance {iid}: {inst}")
            check(storage.get_model_data_models().get(iid) is not None,
                  f"[rec-workflow] instance {iid} has no model row")
            rec["one_iteration_loss"] = one_iteration_loss(variant_path, ctx)
            R.reset_launches()
            with retrieval_mode("auto"):  # the default: exact at this size
                res = asyncio.run(serve_phase(
                    "rec-workflow", variant_path, storage, ctx,
                    lambda session, url, server: rec_workflow_body(
                        rec["one_iteration_loss"], session, url, server)))
            launches = {"score_catalog_quantized": R.score_catalog_quantized.launches,
                        "score_centroids_quantized": R.score_centroids_quantized.launches}
            rec.update(res)
    finally:
        s = registry.use_storage(prev)
        if s is not None:
            s.close()
    log(f"[rec-workflow] app new → import {WF_EVENTS + WF_BUYS} events in "
        f"{rec['import_s']:.2f} s → train on the card in {rec['train_s']:.2f} s "
        f"(instance COMPLETED; loss {rec['final_loss']:.6f}, 1 iteration "
        f"{rec['one_iteration_loss']:.6f}) → deploy → 16 + 8 queries over a "
        f"socket; launches {launches}")
    return launches, rec


# -- phases 13-15: the event store under the ported paths -------------------

def rec_stream_phase(R, S, ctx, tmp, persisted):
    """Stream live events into rec-train's persisted model (1,000,000 ×
    100,000, rank 128), deployed resident on the card, through a storage
    whose EVENTDATA is the ``eventlog`` backend: the events go in through
    ``EventLogEvents.insert_batch`` and the updater's feed is
    ``resolve_feed_path``'s file. The traffic and checks are the
    ``stream`` phase's (:func:`stream_phase`) at these tables, K3 at D 129
    under ``device``. Returns (launches, record)."""
    import datetime as dt

    from incubator_predictionio_tpu_torch.core import PersistentModelManifest
    from incubator_predictionio_tpu_torch.core.controller import class_path
    from incubator_predictionio_tpu_torch.data.storage import (
        EngineInstance,
        Model,
        Storage,
    )
    from incubator_predictionio_tpu_torch.data.storage.base import App
    from incubator_predictionio_tpu_torch.data.storage.eventlog_backend import (
        EventLogEvents,
    )
    from incubator_predictionio_tpu_torch.native import format as pfmt
    from incubator_predictionio_tpu_torch.streaming.feed import resolve_feed_path
    from incubator_predictionio_tpu_torch.streaming.guard import (
        DivergenceGuard,
        GuardConfig,
    )
    from incubator_predictionio_tpu_torch.templates.recommendation import RecModel
    from incubator_predictionio_tpu_torch.utils.serialization import (
        serialize_model,
    )

    d = os.path.join(tmp, "rec-stream")
    env = {"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(d, "pio.db"),
           "PIO_STORAGE_SOURCES_LOG_TYPE": "eventlog",
           "PIO_STORAGE_SOURCES_LOG_PATH": os.path.join(d, "eventlog")}
    for repo, src in (("METADATA", "DB"), ("EVENTDATA", "LOG"),
                      ("MODELDATA", "DB")):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = f"pio_{repo.lower()}"
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = src
    os.makedirs(d, exist_ok=True)
    storage = Storage(env)
    events = storage.get_events()
    check(isinstance(events, EventLogEvents), f"[rec-stream] EVENTDATA {events}")
    app_id = storage.get_meta_data_apps().insert(App(0, "rec-stream"))
    events.init(app_id)
    # the persisted instance, under the same id as in rec-train, so that
    # RecModel.load finds its tables under PIO_FS_BASEDIR
    iid, variant_path = persisted["iid"], persisted["variant_path"]
    now = dt.datetime.now(dt.timezone.utc)
    storage.get_meta_data_engine_instances().insert(EngineInstance(
        id=iid, status="COMPLETED", start_time=now, end_time=now,
        engine_id="rec-train", engine_version="1",
        engine_variant=os.path.abspath(variant_path), engine_factory=FACTORY))
    storage.get_model_data_models().insert(Model(iid, serialize_model(
        [PersistentModelManifest(class_path(RecModel))])))
    path = resolve_feed_path(storage, "rec-stream")
    check(path == events.log_path(app_id), f"[rec-stream] feed path {path}")

    class StoreFeed:
        """The eventlog backend as the stream's writer."""

        def __init__(self):
            self.path = path

        def append(self, evs):
            events.insert_batch(evs, app_id)

    # rec-train's tables have no cluster structure: their IVF's recall is
    # ~0.02 before any delta, so the guard's two-stage recall probe runs
    # with a floor of 0 (the norm and finiteness checks keep theirs)
    guard = DivergenceGuard(GuardConfig(recall_floor=0.0))
    try:
        with env_vars(PIO_FS_BASEDIR=persisted["fs"]), retrieval_mode("auto"):
            launches, rec = asyncio.run(stream_phase(
                R, S, variant_path, storage, ctx, d, StoreFeed(),
                name="rec-stream", n_users=REC_USERS, n_items=REC_ITEMS,
                recall_floor=None, guard=guard))
    finally:
        storage.close()
    check(rec["served_resident_at_deploy"] and rec["updater_model_resident"],
          f"[rec-stream] the deployed model was not resident: {rec}")
    with open(path, "rb") as f:
        buf = f.read()
    rec["log_records"] = sum(kind == pfmt.KIND_EVENT
                             for _, kind, _ in pfmt.iter_records(buf))
    rec["log_bytes"] = len(buf)
    return launches, rec


#: rec-shard (a): bench.py's sharded_serving lane at its own widths
#: (bench_sharded_serving, bench.py:727-879): rank 32, 10,000 users, a
#: 150,000-item mixture-of-concepts catalog from default_rng(13), batches
#: of 16, num 10, PIO_RETRIEVAL_NPROBE 16
SHARD_RANK, SHARD_USERS, SHARD_ITEMS = 32, 10_000, 150_000
SHARD_BATCH, SHARD_NUM, SHARD_NPROBE = 16, 10, "16"
SHARD_LANE_S = 1.0       # each lane's q/s window (the bench's is 2 s)
#: rec-shard (b): users held bitwise under each mask kind, single queries,
#: two-stage recall queries, delta rows (default_rng(41)), socket bursts
SHARD_B_USERS, SHARD_B_SINGLES, SHARD_B_RECALL = 64, 8, 256
SHARD_DELTA_ROWS, SHARD_BURSTS = 512, 4
SHARD_MASK_KINDS = ("none", "exclude", "row_mask", "both")


def shard_series() -> dict:
    """The pio_shard_* series now: counters' values, histograms' counts and
    sums."""
    from incubator_predictionio_tpu_torch.sharding import shard_metrics as M

    out = {}
    for s in (M.SHARD_BATCHES, M.SHARD_FALLBACKS, M.FULL_GATHERS,
              M.DELTA_ROUTED, M.TOPK_SEC, M.MERGE_SEC, M.MERGE_FANIN):
        if s.kind == "histogram":
            _, out[f"{s.name}_sum"], out[f"{s.name}_count"] = (
                s.children()[0][1].snapshot())
        else:
            out[s.name] = s.value
    return out


def series_delta(before: dict) -> dict:
    after = shard_series()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def same_answer(a, b) -> bool:
    """Ids equal and scores bitwise."""
    return (np.array_equal(a[0], b[0]) and a[1].dtype == b[1].dtype
            and np.array_equal(np.asarray(a[1]).view(np.int32),
                               np.asarray(b[1]).view(np.int32)))


def shard_masks(rng, b, n_items, kind):
    """One of recommend_batch's rule-mask kinds (tests/test_sharding.py:68)."""
    exclude = row_mask = None
    if kind in ("exclude", "both"):
        exclude = rng.choice(n_items, max(20, n_items // 50),
                             replace=False).astype(np.int64)
    if kind in ("row_mask", "both"):
        row_mask = np.zeros((b, n_items), np.float32)
        hits = max(50, b * n_items // 400)
        row_mask[rng.integers(0, b, hits), rng.integers(0, n_items, hits)] = -np.inf
    return exclude, row_mask


def lane_qps(model, qusers, num) -> float:
    """Batches of ``qusers`` rows through recommend_batch for at least
    SHARD_LANE_S: queries a second."""
    from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerMF

    TwoTowerMF.recommend_batch(model, qusers[0], num)
    done, t0 = 0, time.perf_counter()
    while True:
        TwoTowerMF.recommend_batch(model, qusers[done % len(qusers)], num)
        done += 1
        dt = time.perf_counter() - t0
        if dt >= SHARD_LANE_S and done >= 8:
            return done * qusers.shape[1] / dt


def card_times(model, rows, num) -> dict:
    """Per-card scoring ms and the merge ms (CUDA events on each card's
    stream) and the batch's wall ms, means over ``rows``' batches, through
    the device-sharded exact search."""
    sh = model._sharded
    per, merge, wall = [], [], []
    for row in rows:
        ev = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sh.search_exact(model, row, num, events=ev)
        wall.append((time.perf_counter() - t0) * 1e3)
        for d in sh.device.devices:
            torch.cuda.synchronize(d)
        per.append([ev[s][0].elapsed_time(ev[s][1])
                    for s in range(sh.n_shards)])
        merge.append(ev["merge"][0].elapsed_time(ev["merge"][1]))
    per = np.asarray(per)
    return {"card_scoring_ms": per.mean(axis=0).tolist(),
            "merge_ms": float(np.mean(merge)), "wall_ms": float(np.mean(wall)),
            "sum_of_cards_ms": float(per.sum(axis=1).mean())}


def shard_lane_data():
    rng = np.random.default_rng(13)
    n_concepts = max(64, int(round(np.sqrt(SHARD_ITEMS))))
    concepts = rng.standard_normal((n_concepts, SHARD_RANK)).astype(np.float32)
    item = concepts[rng.integers(0, n_concepts, SHARD_ITEMS)] \
        + 0.5 * rng.standard_normal((SHARD_ITEMS, SHARD_RANK)).astype(np.float32)
    user = concepts[rng.integers(0, n_concepts, SHARD_USERS)] \
        + 0.5 * rng.standard_normal((SHARD_USERS, SHARD_RANK)).astype(np.float32)
    user_bias = (rng.standard_normal(SHARD_USERS) * 0.1).astype(np.float32)
    item_bias = (rng.standard_normal(SHARD_ITEMS) * 0.1).astype(np.float32)
    qusers = rng.integers(0, SHARD_USERS, (64, SHARD_BATCH)).astype(np.int32)
    eusers = rng.integers(0, SHARD_USERS, (256 // SHARD_BATCH, SHARD_BATCH)
                          ).astype(np.int32)
    return user, item, user_bias, item_bias, qusers, eusers


def shard_lanes(R, ctx, n_req: int, tag: str, full: bool) -> dict:
    """bench_sharded_serving's four lanes on the card: exact and two-stage
    single-card, then sharded exact and sharded two-stage from fused tables
    resident on the card under PIO_SHARD_SERVE=1 with ``n_req`` shards
    requested (clamped to the cards); then a host model under
    PIO_SHARD_SERVE_SHARDS=4 (host blocks, four per-shard IVF probes through
    K2 on the card). Without ``full``, only the exact single-card lane (the
    oracle) and the two sharded lanes."""
    from incubator_predictionio_tpu_torch.models.two_tower import (
        TwoTowerConfig,
        TwoTowerMF,
        TwoTowerModel,
    )

    dev = ctx.device
    cards = torch.cuda.device_count()
    user, item, user_bias, item_bias, qusers, eusers = shard_lane_data()
    num = SHARD_NUM

    def host_model():
        return TwoTowerModel(user_emb=user, item_emb=item, user_bias=user_bias,
                             item_bias=item_bias, mean=3.0,
                             config=TwoTowerConfig(rank=SHARD_RANK))

    def resident_model():
        """The same towers as fused tables resident on the card, what a
        device-resident fit or restore holds."""
        m = TwoTowerModel(mean=3.0, config=TwoTowerConfig(rank=SHARD_RANK))
        m._tables = {
            "ue": torch.from_numpy(np.concatenate(
                [user, user_bias[:, None]], 1)).to(dev),
            "ie": torch.from_numpy(np.concatenate(
                [item, item_bias[:, None]], 1)).to(dev)}
        m._n_users, m._n_items = SHARD_USERS, SHARD_ITEMS
        m._device = dev
        return m

    def answers(model):
        return [TwoTowerMF.recommend_batch(model, row, num) for row in eusers]

    def recall(got, want):
        return float(np.mean([len(set(g[r]) & set(w[r])) / num
                              for (g, _), (w, _) in zip(got, want)
                              for r in range(SHARD_BATCH)]))

    forced = str(n_req) if n_req > 1 else ""
    n_expect = min(n_req if n_req > 1 else max(cards, 2), cards)
    lanes = {}
    with env_vars(PIO_RETRIEVAL_NPROBE=SHARD_NPROBE):
        with env_vars(PIO_SHARD_SERVE="0"), retrieval_mode("exact"):
            m = host_model()
            m.prepare_for_serving(serve_k=num, host_max_elements=0, device=dev)
            check(m.serving_info()["path"] == "device-bf16",
                  f"[{tag}] exact lane {m.serving_info()}")
            m.warmup(max_batch=SHARD_BATCH)
            lanes["exact"] = {"qps": lane_qps(m, qusers, num)}
            oracle = answers(m)
            del m
        if full:
            with env_vars(PIO_SHARD_SERVE="0"), retrieval_mode("two_stage"):
                m = host_model()
                m.prepare_for_serving(serve_k=num, device=dev)
                m.warmup(max_batch=SHARD_BATCH)
                lanes["two_stage"] = {"qps": lane_qps(m, qusers, num),
                                      "recall_at_10": recall(answers(m), oracle)}
                del m
        with env_vars(PIO_SHARD_SERVE="1", PIO_SHARD_SERVE_SHARDS=forced):
            with retrieval_mode("exact"):
                md = resident_model()
                md.prepare_for_serving(serve_k=num, device=dev)
                info = md.serving_info()
                check(info["path"] == "sharded-device-bf16"
                      and info["sharding"]["n_shards"] == n_expect,
                      f"[{tag}] sharded exact lane {info}")
                md.warmup(max_batch=SHARD_BATCH)
                before = shard_series()
                got = answers(md)
                bitwise = all(same_answer(g, w) for g, w in zip(got, oracle))
                check(bitwise, f"[{tag}] sharded exact answers are not bitwise "
                      "the single-card bf16 path's")
                lanes["sharded_exact"] = {
                    "qps": lane_qps(md, qusers, num),
                    "n_shards": info["sharding"]["n_shards"],
                    "devices": info["sharding"]["devices"],
                    "bitwise_single_card_256": bitwise,
                    "recall_at_10": recall(got, oracle)}
                if n_expect > 1:
                    lanes["sharded_exact"]["per_card"] = card_times(
                        md, qusers[:16], num)
                lanes["sharded_exact"]["pio_shard"] = series_delta(before)
                del md
            with retrieval_mode("two_stage"):
                md = resident_model()
                md.prepare_for_serving(serve_k=num, device=dev)
                sh = md._sharded
                check([str(i.device) for i in sh.ivf]
                      == [str(d) for d in sh.device.devices],
                      f"[{tag}] per-shard IVF devices {[i.device for i in sh.ivf]}")
                md.warmup(max_batch=SHARD_BATCH)
                before = shard_series()
                k2 = R.score_centroids_quantized.launches
                got = answers(md)
                k2_per_batch = (R.score_centroids_quantized.launches - k2) / len(eusers)
                r = recall(got, oracle)
                check(r >= RECALL_FLOOR, f"[{tag}] sharded two-stage recall@10 "
                      f"{r:.4f} < {RECALL_FLOOR}")
                check(k2_per_batch == sh.n_shards,
                      f"[{tag}] K2 launched {k2_per_batch} times a batch over "
                      f"{sh.n_shards} shards")
                lanes["sharded_two_stage"] = {
                    "qps": lane_qps(md, qusers, num), "n_shards": sh.n_shards,
                    "recall_at_10": r, "k2_launches_a_batch": k2_per_batch,
                    "ivf_devices": [str(i.device) for i in sh.ivf],
                    "pio_shard": series_delta(before)}
                del md, sh
        if full:
            with env_vars(PIO_SHARD_SERVE="1", PIO_SHARD_SERVE_SHARDS="4"), \
                    retrieval_mode("two_stage"):
                m = host_model()
                m.prepare_for_serving(serve_k=num, device=dev)
                info = m.serving_info()
                sh = m._sharded
                check(info["path"] == "sharded-host-numpy" and sh.n_shards == 4
                      and all(str(i.device) == str(dev) for i in sh.ivf),
                      f"[{tag}] host-sharded lane {info}")
                before = shard_series()
                k2 = R.score_centroids_quantized.launches
                got = answers(m)
                k2_per_batch = (R.score_centroids_quantized.launches - k2) / len(eusers)
                r = recall(got, oracle)
                check(r >= RECALL_FLOOR, f"[{tag}] host-sharded two-stage "
                      f"recall@10 {r:.4f} < {RECALL_FLOOR}")
                check(k2_per_batch == 4, f"[{tag}] K2 launched {k2_per_batch} "
                      "times a batch over 4 host shards")
                lanes["host_sharded_two_stage"] = {
                    "qps": lane_qps(m, qusers, num), "n_shards": 4,
                    "recall_at_10": r, "k2_launches_a_batch": k2_per_batch,
                    "pio_shard": series_delta(before)}
                del m, sh
    for name, lane in lanes.items():
        log(f"[{tag}] {name}: {lane['qps']:.1f} q/s"
            + (f", recall@10 {lane['recall_at_10']:.4f}"
               if "recall_at_10" in lane else "")
            + (f", {lane['n_shards']} shard(s)" if "n_shards" in lane else "")
            + (f", per card {lane['per_card']}" if "per_card" in lane else "")
            + (f"; pio_shard {lane['pio_shard']}" if "pio_shard" in lane else ""))
    return {"n_items": SHARD_ITEMS, "rank": SHARD_RANK, "batch": SHARD_BATCH,
            "num": num, "nprobe": int(SHARD_NPROBE), "n_requested": n_req,
            "lanes": lanes}


async def shard_trained(R, ctx, persisted, tag="rec-shard") -> dict:
    """rec-train's persisted model (1,000,000 users × 100,000 items, rank
    128) deployed under PIO_SHARD_SERVE=1 through RecModel.load and the
    QueryServer: its answers bitwise the single-card bf16 path's under every
    mask kind, two-stage recall with int8 per-shard IVF, a POST /delta of
    item and user rows routed to the owning shards, no full-table gather,
    and socket bursts beside the single-card int8 path."""
    import datetime as dt

    import aiohttp

    from incubator_predictionio_tpu_torch.core import PersistentModelManifest
    from incubator_predictionio_tpu_torch.core.controller import class_path
    from incubator_predictionio_tpu_torch.data.storage import (
        EngineInstance,
        Model,
        Storage,
    )
    from incubator_predictionio_tpu_torch.models.two_tower import (
        TwoTowerMF,
        TwoTowerModel,
    )
    from incubator_predictionio_tpu_torch.server.query_server import (
        QueryServer,
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.sharding import shard_metrics as M
    from incubator_predictionio_tpu_torch.sharding.serve import restore_shards
    from incubator_predictionio_tpu_torch.streaming import delta as deltas
    from incubator_predictionio_tpu_torch.templates.recommendation import (
        ALSAlgorithmParams,
        RecModel,
    )
    from incubator_predictionio_tpu_torch.utils.serialization import (
        serialize_model,
    )

    dev = ctx.device
    cards = torch.cuda.device_count()
    iid, variant_path = persisted["iid"], persisted["variant_path"]
    storage = Storage({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    now = dt.datetime.now(dt.timezone.utc)
    storage.get_meta_data_engine_instances().insert(EngineInstance(
        id=iid, status="COMPLETED", start_time=now, end_time=now,
        engine_id="rec-train", engine_version="1",
        engine_variant=os.path.abspath(variant_path), engine_factory=FACTORY))
    storage.get_model_data_models().insert(Model(iid, serialize_model(
        [PersistentModelManifest(class_path(RecModel))])))
    params = ALSAlgorithmParams(rank=REC_RANK)
    rec = {}
    rng = np.random.default_rng(31)

    def single_card():
        """The single-card bf16 exact path on the same persisted tables."""
        with env_vars(PIO_SHARD_SERVE="0"):
            m = RecModel.load(f"{iid}_0", params, ctx)
            m.mf.prepare_for_serving(host_max_elements=0, device=dev)
        check(m.mf.serving_info()["path"] == "device-bf16",
              f"[{tag}] single-card oracle {m.mf.serving_info()}")
        return m.mf

    async def bursts(session, url, users):
        lat = []
        for i in range(SHARD_BURSTS):
            payload = [{"user": f"u{u}", "num": 10}
                       for u in users[i * 64:(i + 1) * 64]]
            bodies, ls = await post_all(session, url, payload, True)
            for body in bodies:
                check(len(body["itemScores"]) == 10, f"[{tag}] short answer {body}")
            lat += ls
        return lat, bodies

    gathers0 = M.FULL_GATHERS.value
    with env_vars(PIO_FS_BASEDIR=persisted["fs"], PIO_SHARD_SERVE="1",
                  PIO_SHARD_SERVE_SHARDS=""), retrieval_mode("exact"):
        loaded = RecModel.load(f"{iid}_0", params, ctx)
        n_items, n_users = loaded.mf.n_items, loaded.mf.n_users
        rs = restore_shards(n_items, REC_RANK, 1, device_type=dev.type)
        check(loaded.restore_shards == rs, f"[{tag}] load chose "
              f"{loaded.restore_shards} shards, restore_shards {rs}")
        del loaded
        n_expect = min(max(cards, 2), cards)
        t0 = time.perf_counter()
        server = QueryServer(
            ServerConfig(engine_variant=variant_path, ip="127.0.0.1",
                         port=free_port()), storage=storage, ctx=ctx)
        torch.cuda.synchronize()
        rec["deploy_s"] = time.perf_counter() - t0
        served = server.deployed.models[0]
        info = served.serving_info()
        check(info["path"] == "sharded-device-bf16"
              and info["sharding"]["n_shards"] == n_expect,
              f"[{tag}] served {info}")
        rec["restore_shards"] = rs
        rec["n_shards"] = info["sharding"]["n_shards"]
        rec["devices"] = info["sharding"]["devices"]
        log(f"[{tag}] deployed {n_users}x{n_items} rank {REC_RANK} in "
            f"{rec['deploy_s']:.2f} s: restore_shards {rs}, serving "
            f"{rec['n_shards']} shard(s) on {rec['devices']}"
            + (" (one card: PIO_SHARD_SERVE=1 asks for 2 shards and the "
               "device layout clamps to the 1 card, as the reference clamps "
               "to its devices, two_tower.py:366)" if cards == 1 else ""))
        single = single_card()
        users = rng.integers(0, n_users, SHARD_B_USERS).astype(np.int32)
        before_delta = {}
        bitwise = {}
        for kind in SHARD_MASK_KINDS:
            exclude, row_mask = shard_masks(rng, SHARD_B_USERS, n_items, kind)
            got = TwoTowerMF.recommend_batch(served.mf, users, 10, exclude, row_mask)
            want = TwoTowerMF.recommend_batch(single, users, 10, exclude, row_mask)
            bitwise[kind] = same_answer(got, want)
            check(bitwise[kind], f"[{tag}] sharded answers ({kind}) are not "
                  "bitwise the single-card bf16 path's")
            if kind == "none":
                before_delta["batch"] = got
        for u in users[:SHARD_B_SINGLES]:
            one = np.asarray([u], np.int32)
            check(same_answer(TwoTowerMF.recommend_batch(served.mf, one, 10),
                              TwoTowerMF.recommend_batch(single, one, 10)),
                  f"[{tag}] single query for user {u} not bitwise")
        rec["bitwise_single_card"] = {**bitwise, "singles": SHARD_B_SINGLES}
        # two-stage with int8 per-shard IVF on a fresh sharded prepare
        with retrieval_mode("two_stage"):
            ts = RecModel.load(f"{iid}_0", params, ctx)
            t0 = time.perf_counter()
            ts.prepare_for_serving(ctx)
            rec["two_stage_prepare_s"] = time.perf_counter() - t0
            sh = ts.mf._sharded
            check(sh is not None and sh.ivf and all(i.quantized for i in sh.ivf)
                  and [str(i.device) for i in sh.ivf]
                  == [str(d) for d in sh.device.devices],
                  f"[{tag}] two-stage {ts.mf.serving_info()}")
            ts.warmup(64)
            rusers = rng.integers(0, n_users, SHARD_B_RECALL).astype(np.int32)
            # the oracle holds rec-train's whole-catalog IVF: force exact
            exact_ans = [TwoTowerMF.recommend_batch(
                single, rusers[i:i + 64], 10, _force_exact=True)[0]
                for i in range(0, SHARD_B_RECALL, 64)]

            def recall_at(nprobe):
                with env_vars(PIO_RETRIEVAL_NPROBE=nprobe):
                    k2 = R.score_centroids_quantized.launches
                    got = [TwoTowerMF.recommend_batch(ts.mf, rusers[i:i + 64], 10)[0]
                           for i in range(0, SHARD_B_RECALL, 64)]
                    k2 = R.score_centroids_quantized.launches - k2
                hits = sum(len(set(g[r]) & set(w[r])) for g, w in zip(got, exact_ans)
                           for r in range(len(g)))
                return hits / (10 * SHARD_B_RECALL), k2

            parts = sh.ivf[0].n_partitions
            r_default, _ = recall_at("0")
            r_all, k2_all = recall_at(str(max(i.n_partitions for i in sh.ivf)))
            check(r_all >= RECALL_FLOOR, f"[{tag}] two-stage recall@10 "
                  f"{r_all:.4f} < {RECALL_FLOOR} probing every partition")
            check(k2_all == sh.n_shards * (SHARD_B_RECALL // 64),
                  f"[{tag}] K2 launched {k2_all} times for "
                  f"{SHARD_B_RECALL // 64} batches over {sh.n_shards} shards")
            rec["two_stage"] = {
                "partitions_per_shard": [i.n_partitions for i in sh.ivf],
                "quantized": True, "recall_at_10_default_nprobe": r_default,
                "recall_at_10_all_partitions": r_all,
                "k2_launches": k2_all, "ivf_devices": [str(i.device) for i in sh.ivf]}
            log(f"[{tag}] two-stage int8 per-shard IVF ({parts} partitions a "
                f"shard; prepare {rec['two_stage_prepare_s']:.2f} s): recall@10 "
                f"{r_default:.4f} at the default nprobe (no floor: rec-train's "
                f"tables hold no cluster structure), {r_all:.4f} probing every "
                f"partition; K2 {k2_all} launches on {rec['two_stage']['ivf_devices']}")
            del ts, sh
        gc.collect()
        torch.cuda.empty_cache()
        await server.start()
        try:
            async with aiohttp.ClientSession() as session:
                base = f"http://127.0.0.1:{server.config.port}"
                url = f"{base}/queries.json"
                lat_users = rng.integers(0, n_users, 64 * SHARD_BURSTS)
                lat_sharded, _ = await bursts(session, url, lat_users)
                async with session.get(f"{base}/health") as resp:
                    health = await resp.json()
                summary = health["deployment"]["sharding"][0]
                check(summary["nShards"] == rec["n_shards"]
                      and summary["rows"][-1][1] == n_items,
                      f"[{tag}] /health sharding {summary}")
                rec["health_sharding"] = summary
                # POST /delta: 512 item rows and 512 user rows
                drng = np.random.default_rng(41)
                item_ids = drng.choice(n_items, SHARD_DELTA_ROWS, replace=False)
                user_ids = drng.choice(n_users, SHARD_DELTA_ROWS, replace=False)
                width = REC_RANK + 1
                d = deltas.ModelDelta(
                    base_instance=iid, chain_base=0, from_seq=0, to_seq=1,
                    user_rows={int(u): (drng.standard_normal(width) * 0.1
                                        ).astype(np.float32) for u in user_ids},
                    item_rows={int(i): (drng.standard_normal(width) * 0.1
                                        ).astype(np.float32) for i in item_ids})
                old_sh = served.mf._sharded
                t0 = time.perf_counter()
                async with session.post(f"{base}/delta",
                                        data=deltas.encode_delta(d)) as resp:
                    ans = await resp.json()
                rec["delta_s"] = time.perf_counter() - t0
                check(resp.status == 200 and ans.get("status") == "applied",
                      f"[{tag}] POST /delta answered {resp.status} {ans}")
                new_mf = server.deployed.models[0].mf
                new_sh = new_mf._sharded
                rps = old_sh.spec.rows_per_shard
                owners = sorted(set((item_ids // rps).tolist()))
                u_owners = sorted(set(
                    (user_ids // old_sh.spec_users.rows_per_shard).tolist()))
                for s in range(old_sh.n_shards):
                    check((new_sh.device.item_t[s] is old_sh.device.item_t[s])
                          == (s not in owners)
                          and (new_sh.device.users[s] is old_sh.device.users[s])
                          == (s not in u_owners),
                          f"[{tag}] shard {s}'s blocks: rebuilt only on the owners")
                # the receiver still answers as before; the new model
                # answers as a fresh sharded prepare of the updated tables
                check(same_answer(TwoTowerMF.recommend_batch(served.mf, users, 10),
                                  before_delta["batch"]),
                      f"[{tag}] the delta moved the live model's answers")
                fresh = TwoTowerModel(mean=new_mf.mean, config=new_mf.config)
                fresh._tables = dict(new_mf._tables)
                fresh._n_users, fresh._n_items = n_users, n_items
                fresh.prepare_for_serving(device=dev)
                check(fresh._sharded is not None, f"[{tag}] fresh prepare "
                      f"{fresh.serving_info()}")
                dusers = np.concatenate([users, user_ids[:64].astype(np.int32)])
                check(same_answer(TwoTowerMF.recommend_batch(new_mf, dusers, 10),
                                  TwoTowerMF.recommend_batch(fresh, dusers, 10)),
                      f"[{tag}] post-delta answers are not bitwise a fresh "
                      "sharded prepare's")
                rec["delta"] = {"item_rows": SHARD_DELTA_ROWS,
                                "user_rows": SHARD_DELTA_ROWS,
                                "item_owner_shards": owners,
                                "user_owner_shards": u_owners, "apply_s": rec["delta_s"],
                                "bitwise_fresh_prepare": True}
                del fresh, old_sh, new_sh, new_mf
                lat_after, _ = await bursts(session, url, lat_users)
                rec["degraded"] = await serving_verdict(session, base, tag)
        finally:
            await server.shutdown()
        rec["full_gathers"] = M.FULL_GATHERS.value - gathers0
        check(rec["full_gathers"] == 0, f"[{tag}] {rec['full_gathers']} "
              "full-table gathers across load, prepare, warmup, queries and "
              "the delta")
        del server, served, single
        gc.collect()
        torch.cuda.empty_cache()
    # the same bursts on the single-card int8 path (K1)
    with env_vars(PIO_FS_BASEDIR=persisted["fs"], PIO_SHARD_SERVE="0"), \
            retrieval_mode("exact"):
        server = QueryServer(
            ServerConfig(engine_variant=variant_path, ip="127.0.0.1",
                         port=free_port()), storage=storage, ctx=ctx)
        check(server.deployed.models[0].serving_info()["path"] == "device-int8",
              f"[{tag}] int8 {server.deployed.models[0].serving_info()}")
        await server.start()
        try:
            async with aiohttp.ClientSession() as session:
                lat_int8, _ = await bursts(
                    session, f"http://127.0.0.1:{server.config.port}/queries.json",
                    lat_users)
                await serving_verdict(
                    session, f"http://127.0.0.1:{server.config.port}",
                    f"{tag} int8")
        finally:
            await server.shutdown()
        del server
    gc.collect()
    torch.cuda.empty_cache()
    rec["latency"] = {
        name: {"n": len(v), "p50_ms": pct(v, 50), "p99_ms": pct(v, 99)}
        for name, v in (("sharded_exact_burst64", lat_sharded),
                        ("sharded_exact_burst64_after_delta", lat_after),
                        ("single_card_int8_burst64", lat_int8))}
    for k, v in rec["latency"].items():
        log(f"[{tag}] latency {k:<36s} n={v['n']:<4d} p50={v['p50_ms']:.2f} ms "
            f"p99={v['p99_ms']:.2f} ms")
    log(f"[{tag}] bitwise vs single-card bf16 {rec['bitwise_single_card']}; "
        f"delta {rec['delta']}; full gathers {rec['full_gathers']}")
    return rec


def shard_trained_multi(ctx, persisted, n_shards, tag="rec-shard-multi") -> dict:
    """With ≥ 2 cards: rec-train's tables served over ``n_shards`` cards,
    bitwise the single-card bf16 path's, with each card's scoring ms and
    the merge ms."""
    from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerMF
    from incubator_predictionio_tpu_torch.templates.recommendation import (
        ALSAlgorithmParams,
        RecModel,
    )

    dev = ctx.device
    params = ALSAlgorithmParams(rank=REC_RANK)
    name = f"{persisted['iid']}_0"
    rng = np.random.default_rng(33)
    with env_vars(PIO_FS_BASEDIR=persisted["fs"], PIO_SHARD_SERVE="0"), \
            retrieval_mode("exact"):
        single = RecModel.load(name, params, ctx).mf
        single.prepare_for_serving(host_max_elements=0, device=dev)
    with env_vars(PIO_FS_BASEDIR=persisted["fs"], PIO_SHARD_SERVE="1",
                  PIO_SHARD_SERVE_SHARDS=str(n_shards)), retrieval_mode("exact"):
        m = RecModel.load(name, params, ctx).mf
        m.prepare_for_serving(device=dev)
        check(m._sharded is not None and m._sharded.n_shards == n_shards,
              f"[{tag}] {m.serving_info()}")
        users = rng.integers(0, m.n_users, (8, 64)).astype(np.int32)
        for kind in SHARD_MASK_KINDS:
            exclude, row_mask = shard_masks(rng, 64, m.n_items, kind)
            check(same_answer(
                TwoTowerMF.recommend_batch(m, users[0], 10, exclude, row_mask),
                TwoTowerMF.recommend_batch(single, users[0], 10, exclude, row_mask)),
                f"[{tag}] {n_shards}-card answers ({kind}) not bitwise single-card")
        times = card_times(m, users, 10)
    log(f"[{tag}] rec-train's model over {n_shards} cards: bitwise the "
        f"single-card bf16 path under every mask kind; {times}")
    return {"n_shards": n_shards, "devices": [str(d) for d in m._sharded.device.devices],
            "bitwise_single_card": True, **times}


def rec_shard_phase(R, ctx, tmp, persisted):
    """Sharded serving on the card(s): bench_sharded_serving's lanes
    (:func:`shard_lanes`) and rec-train's persisted model under
    PIO_SHARD_SERVE=1 (:func:`shard_trained`); with ≥ 2 cards both again
    over ``min(4, cards)`` cards with each card's scoring time. Returns
    (launches, record)."""
    from incubator_predictionio_tpu_torch.obs import profile as P

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    R.reset_launches()
    snap = P.phase_snapshot()
    rec = {"cards": cards}
    rec["lanes"] = shard_lanes(R, ctx, min(8, cards), "rec-shard", full=True)
    # the fences at shard.search's phase edges against the lanes' speed
    lanes = rec["lanes"]["lanes"]
    log(f"[rec-shard] lanes with shard.search's fences ({smi_name_power()}): "
        f"sharded exact {lanes['sharded_exact']['qps']:.1f} q/s, exact "
        f"{lanes['exact']['qps']:.1f} q/s (earlier, without the fences: "
        f"{SHARD_LANES_UNFENCED_QPS})")
    gc.collect()
    torch.cuda.empty_cache()
    rec["trained"] = asyncio.run(shard_trained(R, ctx, persisted))
    if cards >= 2:
        n = min(4, cards)
        rec["multi_card"] = {
            "lanes": shard_lanes(R, ctx, n, "rec-shard-multi", full=False),
            "trained": shard_trained_multi(ctx, persisted, n)}
    else:
        log("[rec-shard] one card visible: every device-sharded lane ran "
            "with one shard (the clamp to the local cards); the multi-card "
            "pass needs ≥ 2 cards")
    launches = {"score_catalog_quantized": R.score_catalog_quantized.launches,
                "score_centroids_quantized": R.score_centroids_quantized.launches}
    for name, count in launches.items():
        check(count > 0, f"[rec-shard] {name} never launched")
    rec["launches"] = launches
    # rec-obs (e): the device-sharded searches' fenced phases (h2d,
    # compute, gather) and the per-shard IVF searches' (compute, merge)
    rec["obs_shard_search"] = check_phases(
        "rec-shard", "shard.search", phase_delta(snap, "shard.search"),
        ("h2d", "compute", "gather", "merge"))
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[rec-shard] phase {rec['phase_s']:.1f} s; launches {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


#: seq-workflow: bench_sequential's widths (bench.py:897-899) trained from
#: events in the store; 2,048 users' cycle sessions of 16-128 items (~150k
#: view events: the session count is the cut, for the import's time at
#: ~58 µs an event)
SEQ_WF_USERS, SEQ_WF_LENGTHS, SEQ_WF_MAX_LEN = 2048, (16, 128), 512
#: seq-workflow's variant's epochs (32 steps), which seq-launch trains too
#: (cut from 2 for the script's time: PERF.md §4)
SEQ_WF_EPOCHS = 1


async def seq_workflow_body(sessions_, session, url, server):
    """16 ``{"user": U}`` singles against 16 ``recentItems`` singles of the
    same users' last 512 items: the same top-10, scores within 1e-4; then a
    burst of 64 user queries. The trained loss falls over its epoch."""
    model = server.deployed.models[0]
    info = model.serving_info()
    check(info["device"].startswith("cuda"), f"[seq-workflow] not on the card: {info}")
    first, final = float(model.step_losses[0, 0]), model.final_loss
    check(np.isfinite(final) and np.isfinite(model.step_losses).all()
          and final < first,
          f"[seq-workflow] loss first step {first}, final {final}")
    picked = list(range(0, SEQ_WF_USERS, SEQ_WF_USERS // 16))[:16]
    users = [{"user": f"u{k}", "num": 10} for k in picked]
    recent = [{"recentItems": sessions_[k][-SEQ_WF_MAX_LEN:], "num": 10}
              for k in picked]
    b_user, l_user = await post_all(session, url, users, False)
    b_recent, l_recent = await post_all(session, url, recent, False)
    check_answers(recent, b_user)  # the user's history is never served
    worst = 0.0
    for p, a, b in zip(users, b_user, b_recent):
        check(ids_of(a) == ids_of(b),
              f"[seq-workflow] {p['user']}: {ids_of(a)} vs recentItems {ids_of(b)}")
        for x, y in zip(a["itemScores"], b["itemScores"]):
            worst = max(worst, abs(x["score"] - y["score"]))
    check(worst <= 1e-4, f"[seq-workflow] user vs recentItems scores {worst}")
    burst = [{"user": f"u{k}", "num": 10} for k in range(64)]
    b_burst, l_burst = await post_all(session, url, burst, True)
    check_answers([{"recentItems": sessions_[k], "num": 10} for k in range(64)],
                  b_burst)
    n_items = SEQ_VOCAB - 1
    hits = sum(f"i{(int(sessions_[k][-1][1:]) + 1) % n_items}" in ids_of(b)
               for k, b in zip(picked, b_user))
    log(f"[seq-workflow] 16 user queries equal to the recentItems queries of "
        f"the same histories (max score diff {worst:.2e}); the next item of "
        f"the cycle in the top 10 for {hits}/16; loss first step {first:.4f}, "
        f"final {final:.4f}")
    return {"user_vs_recent_max_score_diff": worst, "next_item_in_top10": hits,
            "first_step_loss": first, "final_loss": final,
            "latency_ms": {k: {"n": len(v), "p50": pct(v, 50), "p99": pct(v, 99)}
                           for k, v in (("user_single", l_user),
                                        ("recent_single", l_recent),
                                        ("user_burst64", l_burst))}}


def seq_workflow_phase(ctx, tmp):
    """The sequential template through the normal entry points, in-process,
    on sqlite: CLI ``app new``, ``import`` of the sessions' ``view`` events,
    ``train`` on the card at bench_sequential's widths (``max_len`` 512,
    batch 64, 1 epoch), the sessions read back from the store held against
    the same sessions folded directly, a deploy and queries over a socket.
    Returns (launches of the attention kernels, record)."""
    import datetime as dt
    import io

    from incubator_predictionio_tpu_torch.data.storage import registry
    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.templates.sequential import (
        DataSource,
        DataSourceParams,
    )
    from incubator_predictionio_tpu_torch.tools import cli

    wf = os.path.join(tmp, "seq-workflow")
    os.makedirs(wf, exist_ok=True)
    env = {"PIO_FS_BASEDIR": wf, "PIO_STORAGE_SOURCES_WF_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_WF_PATH": os.path.join(wf, "pio.db")}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = f"pio_{repo.lower()}"
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "WF"
    sessions_ = cycle_sessions(np.random.default_rng(31), SEQ_WF_USERS,
                               SEQ_WF_MAX_LEN, SEQ_WF_LENGTHS)
    n_events = sum(len(x) for x in sessions_)
    t0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
    events_path = os.path.join(wf, "events.json")
    with open(events_path, "w") as f:
        j = 0
        for k, items in enumerate(sessions_):
            for item in items:
                f.write(json.dumps({
                    "event": "view", "entityType": "user", "entityId": f"u{k}",
                    "targetEntityType": "item", "targetEntityId": item,
                    "eventTime": (t0 + dt.timedelta(seconds=j)).isoformat()})
                    + "\n")
                j += 1
    params = {"appName": "seq", "maxLen": SEQ_WF_MAX_LEN, "dModel": SEQ_D,
              "nHeads": SEQ_HEADS, "nLayers": SEQ_LAYERS,
              "learningRate": TRAIN_LR, "batchSize": TRAIN_BATCH,
              "epochs": SEQ_WF_EPOCHS}
    variant_path = os.path.join(wf, "engine.json")
    with open(variant_path, "w") as f:
        json.dump({"id": "seq-workflow", "version": "1",
                   "engineFactory": SEQ_FACTORY,
                   "datasource": {"params": {"appName": "seq",
                                             "maxLen": SEQ_WF_MAX_LEN}},
                   "algorithms": [{"name": "transformer", "params": params}]}, f)

    def run(argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        check(rc == 0, f"[seq-workflow] {argv} exited {rc}: {buf.getvalue()}")
        return buf.getvalue()

    rec = {"users": SEQ_WF_USERS, "events": n_events,
           "session_lengths": SEQ_WF_LENGTHS, "max_len": SEQ_WF_MAX_LEN,
           "batch": TRAIN_BATCH, "epochs": SEQ_WF_EPOCHS}
    prev = registry.use_storage(None)
    try:
        with env_vars(**env):
            out = run(["app", "new", "seq"])
            app_id = int(out.split("ID: ")[-1].split()[0])
            s0 = time.perf_counter()
            out = run(["import", "--appid", str(app_id), "--input", events_path])
            rec["import_s"] = time.perf_counter() - s0
            check(f"Imported {n_events} events." in out, f"[seq-workflow] import: {out}")
            # the sessions read back from the store, against the same
            # sessions folded directly from the arrays
            ds = DataSource(DataSourceParams(app_name="seq", max_len=SEQ_WF_MAX_LEN))
            want = ds._build_fold(ctx, sessions_, False)
            s0 = time.perf_counter()
            got = ds.read_training(ctx)
            rec["read_training_s"] = time.perf_counter() - s0
            check(dict(got.item_map.items()) == dict(want.item_map.items())
                  and got.sequences.tobytes() == want.sequences.tobytes(),
                  "[seq-workflow] read_training's sessions differ from the "
                  "arrays'")
            rec["rows"], rec["vocab"] = len(got.sequences), len(got.item_map) + 1
            del got, want
            A.reset_launches()
            s0 = time.perf_counter()
            out = run(["train", "-v", variant_path, "--device", str(ctx.device)])
            rec["train_s"] = time.perf_counter() - s0
            fit_launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
            for w in ("causal_mha_small_head", "causal_mha_small_head_bwd"):
                check(fit_launches[w] > 0, f"[seq-workflow] {w} never launched "
                      f"in the CLI train: {fit_launches}")
            iid = out.split("Engine instance ID: ")[-1].strip()
            storage = registry.get_storage()
            inst = storage.get_meta_data_engine_instances().get(iid)
            check(inst is not None and inst.status == "COMPLETED",
                  f"[seq-workflow] instance {iid}: {inst}")
            A.reset_launches()
            res = asyncio.run(serve_phase(
                "seq-workflow", variant_path, storage, ctx,
                lambda session, url, server: seq_workflow_body(
                    sessions_, session, url, server)))
            serve_launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
            rec.update(res)
    finally:
        s = registry.use_storage(prev)
        if s is not None:
            s.close()
    launches = {k: fit_launches[k] + serve_launches[k] for k in fit_launches}
    rec["launches"] = {"train": fit_launches, "serve": serve_launches}
    lat = rec["latency_ms"]
    log(f"[seq-workflow] app new → import {n_events} view events of "
        f"{SEQ_WF_USERS} users in {rec['import_s']:.2f} s → read_training "
        f"{rec['read_training_s']:.2f} s ({rec['rows']} rows, vocab "
        f"{rec['vocab']}, equal to the arrays') → train on the card "
        f"{rec['train_s']:.2f} s → deploy → queries: user p50 "
        f"{lat['user_single']['p50']:.2f} p99 {lat['user_single']['p99']:.2f} ms, "
        f"recentItems p50 {lat['recent_single']['p50']:.2f} p99 "
        f"{lat['recent_single']['p99']:.2f} ms, user burst of 64 p50 "
        f"{lat['user_burst64']['p50']:.2f} ms; launches {rec['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def _tree_rel(got, want) -> tuple[bool, float]:
    """(bitwise, worst relative Frobenius error) over lists of tensors."""
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    rel = max(float(torch.linalg.norm((a - b).float()) / torch.linalg.norm(b.float()))
              for a, b in zip(got, want))
    return bitwise, rel


def _resume_verdict(name, resumed, straight, again, loss) -> dict:
    """Resumed against uninterrupted: bitwise, or rec-train's cut-fit band
    (loss 1e-4 relative, each tensor 1e-2 relative Frobenius); two
    uninterrupted fits beside it, the card's own noise."""
    bitwise, rel = _tree_rel(resumed, straight)
    noise_bitwise, noise_rel = _tree_rel(again, straight)
    loss_rel = abs(loss[0] - loss[1]) / abs(loss[1])
    out = {"bitwise": bitwise, "rel_frobenius": rel, "loss_rel": loss_rel,
           "uninterrupted_twice_bitwise": noise_bitwise,
           "uninterrupted_twice_rel_frobenius": noise_rel,
           "uninterrupted_twice_loss_rel": abs(loss[2] - loss[1]) / abs(loss[1])}
    check(bitwise or (loss_rel <= REC_FIT_LOSS_RTOL and rel <= REC_FIT_TABLE_RTOL),
          f"[ckpt-resume] {name}: resumed vs uninterrupted {out}")
    log(f"[ckpt-resume] {name}: resumed vs uninterrupted bitwise {bitwise}, "
        f"worst rel Frobenius {rel:.3e}, loss rel {loss_rel:.3e} (band "
        f"{REC_FIT_TABLE_RTOL} / {REC_FIT_LOSS_RTOL}); two uninterrupted fits: "
        f"bitwise {noise_bitwise}, rel {noise_rel:.3e}, loss rel "
        f"{out['uninterrupted_twice_loss_rel']:.3e}")
    return out


def ckpt_resume_phase(ctx, tmp):
    """Interrupted fits resumed on the card: the two-tower fit at
    rec-train's cut size (20,000 × 5,000, rank 128, batch 65,536, resident,
    bf16 moments) stopped after 2 of 4 epochs with ``checkpoint_every=1``
    and resumed; the sequential fit at seq-train512's widths on 256 rows
    stopped after 1 of 2 epochs and resumed (K4 forward and backward). Each
    restored state is held bitwise against what was saved, and each resumed
    fit against an uninterrupted one. Then one checkpoint's save time and
    bytes at rec-train's full shape. Returns (attention launches, record)."""
    from incubator_predictionio_tpu_torch.models.transformer import (
        TransformerNet,
        _init_params,
    )
    from incubator_predictionio_tpu_torch.models.two_tower import (
        TwoTowerConfig,
        TwoTowerMF,
        _init_tables,
    )
    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.templates.sequential import (
        DataSource,
        DataSourceParams,
        TransformerAlgorithm,
        TransformerAlgorithmParams,
    )
    from incubator_predictionio_tpu_torch.utils.checkpoint import (
        TrainCheckpointer,
        scalar,
    )
    from incubator_predictionio_tpu_torch.utils.optim import adam_init, adam_tree_init

    dev = ctx.device
    rec = {}
    rng = np.random.default_rng(17)
    n = REC_FIT_EVENTS
    data = (rng.integers(0, REC_FIT_USERS, n).astype(np.int32),
            rng.integers(0, REC_FIT_ITEMS, n).astype(np.int32),
            (1.0 + 4.0 * rng.random(n)).astype(np.float32))

    def two_tower(epochs, d=None, every=0):
        return TwoTowerMF(TwoTowerConfig(
            rank=REC_RANK, batch_size=REC_BATCH, epochs=epochs, seed=3,
            adam_moments_dtype=REC_MOMENTS, gather="device",
            checkpoint_dir=d, checkpoint_every=every)).fit(
                ctx, *data, REC_FIT_USERS, REC_FIT_ITEMS)

    straight, again = two_tower(4), two_tower(4)
    d = os.path.join(tmp, "ckpt-rec")
    partial = two_tower(2, d, 1)
    ck = TrainCheckpointer(d)
    check(ck.all_steps() == [1, 2], f"[ckpt-resume] steps {ck.all_steps()}")
    n_batches = -(-n // REC_BATCH)
    like_t = list(_init_tables(TwoTowerConfig(rank=REC_RANK), REC_FIT_USERS,
                               REC_FIT_ITEMS, dev,
                               torch.Generator(device=dev).manual_seed(0)))
    like = {"params": like_t, "opt": adam_tree_init(like_t, REC_MOMENTS),
            "epoch": scalar(0)}
    state = ck.restore(2, like=like)
    saved = ck.restore(2)  # the file as written, on the host
    st = state["opt"]
    check(all(torch.equal(state["params"][i], partial._tables[k])
              for i, k in enumerate(("ue", "ie"))),
          "[ckpt-resume] restored tables differ from the fit's")
    check(st.count == saved["opt"]["count"] == 2 * n_batches,
          f"[ckpt-resume] adam's step count {st.count}")
    check(all(t.device == dev and t.dtype == torch.bfloat16
              and torch.equal(t.cpu(), w)
              for t, w in zip(st.m + st.v, saved["opt"]["m"] + saved["opt"]["v"])),
          "[ckpt-resume] restored moments are not bitwise the saved bf16 ones")
    del state, saved, like, like_t, st
    resumed = two_tower(4, d, 1)
    rec["two_tower"] = {"users": REC_FIT_USERS, "items": REC_FIT_ITEMS,
                        "events": n, "steps_per_epoch": n_batches,
                        "restored_bitwise": True,
                        **_resume_verdict(
                            "two-tower", [resumed._tables[k] for k in ("ue", "ie")],
                            [straight._tables[k] for k in ("ue", "ie")],
                            [again._tables[k] for k in ("ue", "ie")],
                            (resumed.final_loss, straight.final_loss,
                             again.final_loss))}
    del straight, again, partial, resumed
    gc.collect()
    torch.cuda.empty_cache()

    # the sequential fit: seq-train512's widths, 256 rows, 1 of 2 epochs
    td = DataSource(DataSourceParams(app_name="ckpt", max_len=512))._build_fold(
        ctx, cycle_sessions(np.random.default_rng(12), 256, 512), False)

    def seq(epochs, d=None, every=0):
        return TransformerAlgorithm(TransformerAlgorithmParams(
            app_name="ckpt", max_len=512, d_model=SEQ_D, n_heads=SEQ_HEADS,
            n_layers=SEQ_LAYERS, learning_rate=TRAIN_LR, batch_size=TRAIN_BATCH,
            epochs=epochs, checkpoint_dir=d, checkpoint_every=every)).train(ctx, td)

    A.reset_launches()
    straight, again = seq(2), seq(2)
    d = os.path.join(tmp, "ckpt-seq")
    partial = seq(1, d, 1)
    cfg = partial.config
    net = TransformerNet(_init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                      dev), cfg, dev, trainable=True)
    params = list(net.parameters())
    ck = TrainCheckpointer(d)
    state = ck.restore(1, like={"params": params,
                                "opt": adam_init(params, cfg.adam_moments_dtype),
                                "epoch": scalar(0)})
    want = list(TransformerNet(partial.params, cfg, dev, trainable=True).parameters())
    check(all(torch.equal(a, b) for a, b in zip(state["params"], want)),
          "[ckpt-resume] restored transformer parameters differ from the fit's")
    steps = -(-len(td.sequences) // TRAIN_BATCH)
    check(state["opt"].count == steps,
          f"[ckpt-resume] transformer adam count {state['opt'].count}")
    del net, params, state, want
    resumed = seq(2, d, 1)
    launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    for w in ("causal_mha_small_head", "causal_mha_small_head_bwd"):
        check(launches[w] > 0, f"[ckpt-resume] {w} never launched: {launches}")

    def leaves(m):
        return list(TransformerNet(m.params, cfg, dev, trainable=True).parameters())

    with torch.no_grad():
        rec["transformer"] = {"rows": len(td.sequences), "steps_per_epoch": steps,
                              "restored_bitwise": True, **_resume_verdict(
                                  "transformer", leaves(resumed), leaves(straight),
                                  leaves(again), (resumed.final_loss,
                                                  straight.final_loss,
                                                  again.final_loss))}
    del straight, again, partial, resumed, td
    gc.collect()
    torch.cuda.empty_cache()

    # one checkpoint at rec-train's full shape: both tables fp32, bf16 moments
    tables = [torch.randn(REC_USERS, REC_RANK + 1, device=dev),
              torch.randn(REC_ITEMS, REC_RANK + 1, device=dev)]
    opt = adam_tree_init(tables, REC_MOMENTS)
    opt.count = 248
    ck = TrainCheckpointer(os.path.join(tmp, "ckpt-full"), max_to_keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(4, {"params": tables, "opt": opt, "epoch": scalar(4)})
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(ck.directory, "step-4.pt"))
    t0 = time.perf_counter()
    back = ck.restore(4, like={"params": [torch.empty_like(t) for t in tables],
                               "opt": adam_tree_init(tables, REC_MOMENTS),
                               "epoch": scalar(0)})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(back["params"], tables))
          and back["opt"].count == 248, "[ckpt-resume] full-shape restore")
    rec["full_shape"] = {"users": REC_USERS, "items": REC_ITEMS,
                         "rank": REC_RANK, "moments": REC_MOMENTS,
                         "bytes": nbytes, "save_s": save_s,
                         "restore_s": restore_s}
    log(f"[ckpt-resume] one checkpoint at {REC_USERS}x{REC_ITEMS}, rank "
        f"{REC_RANK} + bias, {REC_MOMENTS} moments: {nbytes} bytes, save "
        f"{save_s:.3f} s, restore onto the card {restore_s:.3f} s")
    del tables, opt, back
    gc.collect()
    torch.cuda.empty_cache()
    rec["launches"] = launches
    return launches, rec


# -- phases 16-21: the similar-product, recommended-user, e-commerce and
#    classification templates on the card --------------------------------------

#: bench.py bench_similarproduct (:242-277), not cut: 10,000 x 10,000,
#: 250,000 positives from default_rng(7), 3 sampled negatives each, rank
#: 64, batch 65,536, 10 epochs
SIM_USERS, SIM_ITEMS, SIM_POS, SIM_NEGS = 10_000, 10_000, 250_000, 3
SIM_RANK, SIM_BATCH, SIM_EPOCHS = 64, 65_536, 10
SIM_FACTORY = ("incubator_predictionio_tpu_torch.templates.similarproduct."
               "SimilarProductEngine")
#: the catalog's categories (c0..c7, an item's i % 8), the query mix's
#: singles and burst
SIM_CATS, SIM_SINGLES, SIM_BURST = 8, 32, 64
#: the card's cosine answers against the CPU path of the same model:
#: bf16-rounded products summed over ≤ 5 rows, absolute
SIM_SCORE_TOL = 1e-2
#: sim-train's cut fit against the CPU: 2,000 x 2,000 at rank 64, 20,000
#: positives + 60,000 negatives, batch 65,536 (2 batches), 3 epochs
SIM_FIT_USERS, SIM_FIT_ITEMS, SIM_FIT_POS = 2_000, 2_000, 20_000
#: sim-workflow: 100,000 view events over sim-train's 10,000 x 10,000 (cut
#: from 1,000,000 for the import's time), then 20,000 like/dislike events
SIMWF_VIEWS, SIMWF_LIKES = 100_000, 20_000
#: recuser-workflow: 10,000 users, 100,000 follow events
RU_USERS, RU_FOLLOWS = 10_000, 100_000
RU_FACTORY = ("incubator_predictionio_tpu_torch.templates.recommended_user."
              "RecommendedUserEngine")
#: bench.py bench_ecommerce_retrieval's full configuration (:354-420)
EC_USERS, EC_ITEMS, EC_RANK, EC_VIEWS, EC_UNAVAILABLE = 500, 4_000, 32, 40, 40
EC_SERIAL, EC_BATCHED, EC_BATCH = 256, 4_064, 128
EC_FACTORY = "incubator_predictionio_tpu_torch.templates.ecommerce.ECommerceEngine"
#: bench.py bench_classification (:328-347), not cut
CLS_ROWS, CLS_HIDDEN, CLS_EPOCHS, CLS_BATCH = 100_000, (128, 128), 40, 4_096
#: one MLP step on the card against the CPU from the same parameters
CLS_GRAD_TOL, CLS_LOSS_RTOL = 4e-3, 1e-4
#: cls-workflow: 10,000 users' $set events (cut from the bench's 100,000
#: rows for the import's time); labels on the card vs the CPU path
CLSWF_USERS, CLS_LABEL_AGREE = 10_000, 0.99
CLS_FACTORY = ("incubator_predictionio_tpu_torch.templates.classification."
               "ClassificationEngine")


def sqlite_env(root: str) -> dict:
    """Every repository on one sqlite file under ``root`` (also the
    phase's ``PIO_FS_BASEDIR``)."""
    env = {"PIO_FS_BASEDIR": root, "PIO_STORAGE_SOURCES_WF_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_WF_PATH": os.path.join(root, "pio.db")}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = f"pio_{repo.lower()}"
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "WF"
    return env


@contextlib.contextmanager
def cli_storage(root: str):
    """The process storage from :func:`sqlite_env` for the block (what the
    CLI and ``LEventStore()`` read), closed after it."""
    from incubator_predictionio_tpu_torch.data.storage import registry

    os.makedirs(root, exist_ok=True)
    logging.basicConfig(level=logging.WARNING,
                        format="[%(levelname)s] [%(name)s] %(message)s")
    prev = registry.use_storage(None)
    try:
        with env_vars(**sqlite_env(root)):
            yield registry
    finally:
        s = registry.use_storage(prev)
        if s is not None:
            s.close()
        # the CLI sets INFO; the rest of the run logs warnings only
        logging.getLogger().setLevel(logging.WARNING)


def cli_run(tag: str, argv) -> str:
    import io

    from incubator_predictionio_tpu_torch.tools import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    logging.getLogger().setLevel(logging.WARNING)
    check(rc == 0, f"[{tag}] {argv} exited {rc}: {buf.getvalue()}")
    return buf.getvalue()


def write_events(path: str, dicts) -> int:
    with open(path, "w") as f:
        n = 0
        for d in dicts:
            f.write(json.dumps(d) + "\n")
            n += 1
    return n


def cli_app_import(tag, root, name, dicts) -> tuple[int, dict]:
    """CLI ``app new`` + ``import`` of ``dicts``; (app id, timings)."""
    out = cli_run(tag, ["app", "new", name])
    app_id = int(out.split("ID: ")[-1].split()[0])
    path = os.path.join(root, f"{name}-events.json")
    n = write_events(path, dicts)
    t0 = time.perf_counter()
    out = cli_run(tag, ["import", "--appid", str(app_id), "--input", path])
    import_s = time.perf_counter() - t0
    check(f"Imported {n} events." in out, f"[{tag}] import: {out}")
    return app_id, {"events": n, "import_s": import_s,
                    "import_us_per_event": import_s / n * 1e6}


def cli_train(tag, registry, variant_path, ctx) -> tuple[str, float]:
    t0 = time.perf_counter()
    out = cli_run(tag, ["train", "-v", variant_path, "--device", str(ctx.device)])
    train_s = time.perf_counter() - t0
    iid = out.split("Engine instance ID: ")[-1].strip()
    storage = registry.get_storage()
    inst = storage.get_meta_data_engine_instances().get(iid)
    check(inst is not None and inst.status == "COMPLETED",
          f"[{tag}] instance {iid}: {inst}")
    blob = storage.get_model_data_models().get(iid)
    check(blob is not None, f"[{tag}] instance {iid} has no model row")
    check(not pickle_names_torch(blob.models),
          f"[{tag}] the persisted models hold a torch object")
    return iid, train_s


def write_variant(path, factory, app, algorithms, serving=None) -> str:
    v = {"id": os.path.basename(path).split(".")[0], "version": "1",
         "engineFactory": factory, "datasource": {"params": {"appName": app}},
         "algorithms": algorithms}
    if serving:
        v["serving"] = {"name": serving}
    with open(path, "w") as f:
        json.dump(v, f)
    return path


def pickle_names_torch(blob: bytes) -> bool:
    """Whether a pickle refers to the torch module (a tensor in it would:
    ``torch._utils._rebuild_tensor_v2``)."""
    import pickletools

    return any(isinstance(arg, str) and (arg == "torch" or arg.startswith("torch."))
               for _, arg, _ in pickletools.genops(blob))


def cpu_copy(model):
    """The same model through MODELDATA's pickling, prepared on the CPU:
    the port's plain CPU path."""
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
    from incubator_predictionio_tpu_torch.utils.serialization import (
        deserialize_model,
        serialize_model,
    )

    blob = serialize_model(model)
    check(not pickle_names_torch(blob), "a served model pickles a torch object")
    return deserialize_model(blob).prepare_for_serving(DeviceContext.create("cpu"))


def near_tie_check(tag, got, want, full, tol, key="item"):
    """``got`` / ``want``: lists of {key, score}; ``full``: id → the
    reference's score. Ids equal up to near-ties at the last place, shared
    ids' scores within ``tol``. Returns whether the lists are equal."""
    g = [s[key] for s in got]
    w = [s[key] for s in want]
    check(abs(len(g) - len(w)) <= 1, f"[{tag}] answer lengths {len(g)} vs {len(w)}")
    if w:
        last = want[-1]["score"]
        for x in set(g) ^ set(w):
            check(abs(full.get(x, -np.inf) - last) <= tol,
                  f"[{tag}] answers differ beyond a near-tie: {g} vs {w}")
    for a in got:
        if a[key] in full:
            check(abs(a["score"] - full[a[key]]) <= tol,
                  f"[{tag}] score {a} vs {full[a[key]]}")
    return g == w


def as_dicts(result, field="item_scores", key="item"):
    return [{key: getattr(s, key), "score": s.score} for s in getattr(result, field)]


def lat_record(xs) -> dict:
    return {"n": len(xs), "p50_ms": pct(xs, 50), "p99_ms": pct(xs, 99)}


def sim_data(seed=7, n_users=None, n_items=None, n_pos=None):
    """bench_similarproduct's events: positives uniform over users and
    items, SIM_NEGS sampled negatives each (``sample_negatives``)."""
    from incubator_predictionio_tpu_torch.models.negative_sampling import (
        sample_negatives,
    )

    n_users, n_items = n_users or SIM_USERS, n_items or SIM_ITEMS
    n_pos = n_pos or SIM_POS
    rng = np.random.default_rng(seed)
    pos_u = rng.integers(0, n_users, n_pos).astype(np.int32)
    pos_i = rng.integers(0, n_items, n_pos).astype(np.int32)
    neg_u, neg_i = sample_negatives(pos_u, pos_i, n_items, SIM_NEGS, rng)
    data = (np.concatenate([pos_u, neg_u]), np.concatenate([pos_i, neg_i]),
            np.concatenate([np.ones(n_pos, np.float32),
                            np.zeros(len(neg_u), np.float32)]))
    return pos_u, pos_i, data


def sim_queries(rng, n, item_ids, cats=8):
    """Queries of 1-5 items with the four filter kinds in turn."""
    out = []
    n_items = len(item_ids)
    for j in range(n):
        p = {"items": [item_ids[int(i)] for i in rng.choice(n_items, 1 + j % 5,
                                                              replace=False)],
             "num": 10}
        kind = j % 4
        if kind == 1:
            p["categories"] = [f"c{j % cats}", f"c{(j + 3) % cats}"]
        elif kind == 2:
            p["categoryBlackList"] = [f"c{j % cats}"]
            p["blackList"] = [item_ids[int(i)] for i in rng.integers(0, n_items, 5)]
        elif kind == 3:
            p["whiteList"] = [item_ids[int(i)] for i in rng.integers(0, n_items, 500)]
            p["blackList"] = p["whiteList"][:3]
        out.append(p)
    return out


def sim_filters_hold(tag, model, payloads, bodies):
    for p, body in zip(payloads, bodies):
        got = ids_of(body)
        check(len(got) == p["num"], f"[{tag}] short answer {body} for {p}")
        check(not set(got) & set(p["items"]), f"[{tag}] a query item served: {p}")
        check(not set(got) & set(p.get("blackList") or ()),
              f"[{tag}] a blackList item served: {p}")
        if "whiteList" in p:
            check(set(got) <= set(p["whiteList"]), f"[{tag}] outside the whiteList")
        for iid in got:
            c = set(model.categories.get(iid, ()))
            if "categories" in p:
                check(c & set(p["categories"]), f"[{tag}] {iid} {c} not in {p}")
            if "categoryBlackList" in p:
                check(not c & set(p["categoryBlackList"]), f"[{tag}] {iid} {c} banned")


def sim_full_scores(model, p) -> dict:
    """The CPU model's summed scores of one query, every catalog id."""
    from incubator_predictionio_tpu_torch.templates import _similarity as sim
    from incubator_predictionio_tpu_torch.templates import similarproduct as sp

    q = query_of(sp.Query, p)
    known = [model.item_map[i] for i in q.items if i in model.item_map]
    s = sim.sim_scores(model.item_vecs[known], model._device_vt,
                       sp._category_mask(model, q))
    inv = model.item_map.inverse()
    return {inv[j]: float(v) for j, v in enumerate(s) if np.isfinite(v)}


def query_of(cls, payload: dict):
    """A /queries.json body bound to the template's Query as the server
    binds it (camelCase keys), its lists as tuples."""
    import dataclasses

    from incubator_predictionio_tpu_torch.utils.params import params_from_json

    q = params_from_json(cls, payload)
    return dataclasses.replace(q, **{
        f.name: tuple(getattr(q, f.name)) for f in dataclasses.fields(q)
        if isinstance(getattr(q, f.name), list)})


def sim_vs_cpu(tag, model, payloads, bodies) -> dict:
    """Served answers against the plain CPU path of the same model."""
    from incubator_predictionio_tpu_torch.templates import similarproduct as sp

    cpu = cpu_copy(model)
    same = 0
    for p, body in zip(payloads, bodies):
        want = sp._similar_items(cpu, query_of(sp.Query, p))
        same += near_tie_check(tag, body["itemScores"], as_dicts(want),
                               sim_full_scores(cpu, p), SIM_SCORE_TOL)
    return {"cpu_same_ids": same, "queries": len(payloads)}


def stacked_vs_serial(model, payloads) -> dict:
    """The burst's stacked product against the serial products of the same
    queries, on the card: bitwise or not, the largest difference in fp32
    ulps and absolute."""
    from incubator_predictionio_tpu_torch.templates import _similarity as sim

    qs = [[model.item_map[i] for i in p["items"]] for p in payloads]
    stacked = sim.sim_scores_stacked(model.item_vecs[np.concatenate(qs)],
                                     [len(q) for q in qs], model._device_vt)
    serial = np.stack([sim.sim_scores(model.item_vecs[q], model._device_vt, 0.0)
                       for q in qs])
    return {"bitwise": stacked.tobytes() == serial.tobytes(),
            "equal": bool(np.array_equal(stacked, serial)),
            "max_ulps": max_ulps(stacked, serial),
            "max_abs": float(np.abs(stacked - serial).max())}


async def sim_serve_body(tag, payloads, session, url, server):
    from incubator_predictionio_tpu_torch.templates import similarproduct as sp

    model = server.deployed.models[0]
    info = model.serving_info()
    check(info["device"].startswith("cuda"), f"[{tag}] catalog not on the card: {info}")
    singles, burst = payloads[:SIM_SINGLES], payloads[SIM_SINGLES:]
    b_single, l_single = await post_all(session, url, singles, False)
    b_burst, l_burst = await post_all(session, url, burst, True)
    sim_filters_hold(tag, model, payloads, b_single + b_burst)
    rec = sim_vs_cpu(tag, model, payloads, b_single + b_burst)
    # the burst (stacked products of coalesced batches) against the same
    # queries served one at a time on the card
    same = 0
    for p, body in zip(burst, b_burst):
        q = query_of(sp.Query, p)
        serial = as_dicts(sp._similar_items(model, q))
        same += body["itemScores"] == serial
        near_tie_check(f"{tag}-burst", body["itemScores"], serial,
                       {s["item"]: s["score"] for s in serial}, SIM_SCORE_TOL)
    rec["burst_equal_serial"] = same
    rec["stacked_vs_serial"] = stacked_vs_serial(model, burst)
    rec["latency"] = {"single": lat_record(l_single), "burst64": lat_record(l_burst)}
    log(f"[{tag}] {len(singles)} singles p50 {rec['latency']['single']['p50_ms']:.2f} "
        f"p99 {rec['latency']['single']['p99_ms']:.2f} ms; burst of {len(burst)} p50 "
        f"{rec['latency']['burst64']['p50_ms']:.2f} p99 "
        f"{rec['latency']['burst64']['p99_ms']:.2f} ms; {rec['cpu_same_ids']}/"
        f"{len(payloads)} answers equal to the CPU path (the rest up to near-ties); "
        f"burst equal to serial {same}/{len(burst)}; stacked vs serial products "
        f"{rec['stacked_vs_serial']}")
    return rec


def cooccur_oracle(pos_u, pos_i, n_users, n_items) -> np.ndarray:
    """scipy's int64 ``Uᵀ U`` over the de-duplicated views, rounded to bf16
    (nearest even), as a dense fp32 [n_items, n_items]."""
    import scipy.sparse as sparse

    keys = np.unique(pos_u.astype(np.int64) * n_items + pos_i)
    u = sparse.csr_matrix((np.ones(len(keys), np.int64),
                           (keys // n_items, keys % n_items)),
                          shape=(n_users, n_items))
    exact = (u.T @ u).toarray()
    rounded = torch.from_numpy(exact.astype(np.float32)).bfloat16().float().numpy()
    del exact
    return rounded


def oracle_top_lists(counts: np.ndarray, n: int) -> dict:
    """Each item's ``n`` most co-occurring items of an oracle count matrix
    (its diagonal zeroed in place), the nonzero counts in descending
    order, as ``CooccurrenceModel.top_cooccurrences`` holds them."""
    np.fill_diagonal(counts, 0)
    top = {}
    for i in range(counts.shape[0]):
        row = counts[i]
        nz = np.nonzero(row)[0]
        if len(nz):
            order = nz[np.argsort(-row[nz])][:n]
            top[i] = [(int(j), int(row[j])) for j in order]
    return top


def sim_train_phase(ctx, tmp):
    """bench_similarproduct's configuration, not cut, through
    ``TwoTowerMF.fit`` on the card (a warm-up fit, the timed fit, one step
    by op), a cut fit against the CPU, the similarity model deployed
    through the QueryServer (singles and a burst of 64 held against the
    CPU path and against serial serving), and ``CooccurrenceAlgorithm`` on
    the positives as views, its top lists held exactly against an int64
    ``Uᵀ U`` rounded to bf16."""
    from incubator_predictionio_tpu_torch.data.bimap import BiMap
    from incubator_predictionio_tpu_torch.models.two_tower import (
        TwoTowerConfig,
        TwoTowerMF,
    )
    from incubator_predictionio_tpu_torch.templates import similarproduct as sp
    from incubator_predictionio_tpu_torch.templates._similarity import l2_normalize

    dev = ctx.device
    t0 = time.perf_counter()
    pos_u, pos_i, data = sim_data()
    data_s = time.perf_counter() - t0

    def fit(seed, **kw):
        cfg = dict(rank=SIM_RANK, batch_size=SIM_BATCH, epochs=SIM_EPOCHS, seed=seed)
        cfg.update(kw)
        return TwoTowerMF(TwoTowerConfig(**cfg)).fit(ctx, *data, SIM_USERS, SIM_ITEMS)

    t0 = time.perf_counter()
    fit(0)
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = fit(1)
    fit_s = time.perf_counter() - t0
    n = len(data[0])
    steps, flops, nbytes = two_tower_flops_bytes(
        n, SIM_RANK, SIM_BATCH, SIM_EPOCHS, SIM_USERS, SIM_ITEMS, moment_bytes=4)
    t_train = model.timings["train_sec"]
    rec = {"users": SIM_USERS, "items": SIM_ITEMS, "positives": SIM_POS,
           "events": n, "rank": SIM_RANK, "batch": SIM_BATCH, "epochs": SIM_EPOCHS,
           "steps": steps, "data_s": data_s, "warmup_fit_s": warm_s, "fit_s": fit_s,
           "timings": model.timings, "events_per_sec": SIM_EPOCHS * n / fit_s,
           "train_events_per_sec": SIM_EPOCHS * n / t_train,
           "step_ms": t_train / steps * 1e3,
           "bound_step_ms": nbytes / steps / HBM_BYTES_PER_S * 1e3,
           "hbm_util": nbytes / t_train / HBM_BYTES_PER_S,
           "mfu": flops / t_train / BF16_OPS_PER_S, "final_loss": model.final_loss}
    check(np.isfinite(model.final_loss), f"[sim-train] loss {model.final_loss}")
    k = SIM_RANK
    tables = [torch.from_numpy(np.concatenate(
        [e, b[:, None]], axis=1).astype(np.float32)).to(dev)
        for e, b in ((model.user_emb, model.user_bias),
                     (model.item_emb, model.item_bias))]
    rec["step_by_op"] = rec_step_by_op(model, data, dev, tables)
    del tables
    w = rec["step_by_op"]
    log(f"[sim-train] fit {SIM_USERS}x{SIM_ITEMS} rank {k}, {n} events x "
        f"{SIM_EPOCHS} epochs = {steps} steps of {SIM_BATCH}: fit {fit_s:.3f} s "
        f"(warm-up {warm_s:.3f} s; data {data_s:.2f} s), timings {model.timings}; "
        f"{rec['events_per_sec']:.1f} events/s, {rec['train_events_per_sec']:.1f} "
        f"train events/s, {rec['step_ms']:.3f} ms a step (bound "
        f"{rec['bound_step_ms']:.4f} ms), hbm_util {rec['hbm_util']:.4f}, mfu "
        f"{rec['mfu']:.6f}; loss {model.final_loss:.6f}; one step's device ms: "
        + ", ".join(f"{a}={b:.4f}" for a, b in w["device_ms_by_op"].items())
        + f"; busy share {w['profiled_step']['device_busy_share']:.4f}")
    cu, ci, cdata = sim_data(seed=8, n_users=SIM_FIT_USERS, n_items=SIM_FIT_ITEMS,
                             n_pos=SIM_FIT_POS)
    rec["fit_parity"] = fit_parity(dev, "sim-train", cdata, SIM_FIT_USERS,
                                   SIM_FIT_ITEMS, TwoTowerConfig(
                                       rank=SIM_RANK, batch_size=SIM_BATCH,
                                       epochs=3, seed=4))
    # the similarity model, deployed through the QueryServer
    item_ids = [f"i{j}" for j in range(SIM_ITEMS)]
    cats = {iid: (f"c{j % SIM_CATS}",) for j, iid in enumerate(item_ids)}
    ism = sp.ItemSimModel(l2_normalize(model.item_emb), BiMap.string_int(item_ids),
                          cats)
    storage, variant_path = deploy_storage(SIM_FACTORY, {"rank": SIM_RANK}, "als",
                                           ism, tmp)
    payloads = sim_queries(np.random.default_rng(71), SIM_SINGLES + SIM_BURST,
                           item_ids)
    rec["serve"] = asyncio.run(serve_phase(
        "sim-train", variant_path, storage, ctx,
        lambda session, url, server: sim_serve_body(
            "sim-train", payloads, session, url, server)))
    del model, ism, storage
    # co-occurrence on the positives as views (a dense 10,000 x 10,000 U)
    users = BiMap.string_int(f"u{j}" for j in range(SIM_USERS))
    empty_i, empty_f = np.zeros(0, np.int32), np.zeros(0, np.float32)
    td = sp.TrainingData(users, BiMap.string_int(item_ids), cats, pos_u, pos_i,
                         empty_i, empty_i, empty_f)
    algo = sp.CooccurrenceAlgorithm(sp.CooccurrenceAlgorithmParams(n=20))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cm = algo.train(ctx, td)
    cooc_train_s = time.perf_counter() - t0
    cooc_ms, cooc_by = device_busy(lambda: sp._cooccur(
        pos_u, pos_i, SIM_USERS, SIM_ITEMS, dev), calls=1)
    got = sp._cooccur(pos_u, pos_i, SIM_USERS, SIM_ITEMS, dev)
    want = cooccur_oracle(pos_u, pos_i, SIM_USERS, SIM_ITEMS)
    check(got.tobytes() == want.tobytes(),
          "[sim-train] Uᵀ U on the card differs from int64 counts rounded to bf16")
    top = oracle_top_lists(want, 20)
    check(cm.top_cooccurrences == top,
          "[sim-train] co-occurrence top lists differ from the int64 oracle's")
    cq = [{"items": [item_ids[int(i)] for i in pos_i[j:j + 2]], "num": 10}
          for j in range(0, 64, 2)]
    answered = sum(bool(algo.predict(cm, sp.Query(items=tuple(q["items"]))).item_scores)
                   for q in cq)
    rec["cooccurrence"] = {"train_s": cooc_train_s, "product_device_ms": cooc_ms,
                           "top_device_ms": dict(sorted(cooc_by.items(),
                                                        key=lambda kv: -kv[1])[:4]),
                           "items_with_lists": len(top),
                           "max_count": int(want.max()),
                           "top_lists_equal": True, "queries_answered": answered}
    log(f"[sim-train] co-occurrence: train {cooc_train_s:.2f} s (Uᵀ U device "
        f"{cooc_ms:.3f} ms); Uᵀ U bitwise the int64 counts rounded to bf16; top "
        f"lists of {len(top)} items equal; max co-count {int(want.max())}")
    del want, got, cm
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def sim_numpy_scores(model, p) -> dict:
    """numpy scoring of the model's own tables: bf16-rounded rows and
    catalog, fp32 products rounded to bf16, summed over the query's rows,
    plus the template's filter mask."""
    from incubator_predictionio_tpu_torch.templates import similarproduct as sp

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()

    q = query_of(sp.Query, p)
    known = [model.item_map[i] for i in q.items if i in model.item_map]
    rows = bf(bf(model.item_vecs[known]) @ bf(model.item_vecs).T)
    s = rows.sum(axis=0) + sp._category_mask(model, q)
    inv = model.item_map.inverse()
    return {inv[j]: float(v) for j, v in enumerate(s) if np.isfinite(v)}


async def simwf_body(tag, payloads, session, url, server):
    model = server.deployed.models[0]
    check(model.serving_info()["device"].startswith("cuda"),
          f"[{tag}] not on the card: {model.serving_info()}")
    bodies, lat = await post_all(session, url, payloads, False)
    sim_filters_hold(tag, model, payloads, bodies)
    same = 0
    for p, body in zip(payloads, bodies):
        full = sim_numpy_scores(model, p)
        want = sorted(full.items(), key=lambda kv: -kv[1])[:p["num"]]
        same += near_tie_check(tag, body["itemScores"],
                               [{"item": a, "score": b} for a, b in want],
                               full, SIM_SCORE_TOL)
    return {"numpy_same_ids": same, "queries": len(payloads), "bodies": bodies,
            "latency": lat_record(lat)}


#: a fresh interpreter loads the latest instance of a variant from the
#: storage its environment names, serves the payloads on the card and
#: prints the answers as one JSON line
FRESH_PROCESS = """
import json, sys
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.server.query_server import (
    ServerConfig, load_deployed_engine)
from incubator_predictionio_tpu_torch.utils.json_util import to_jsonable
variant, device, payloads = sys.argv[1], sys.argv[2], json.loads(sys.stdin.read())
deployed = load_deployed_engine(ServerConfig(engine_variant=variant),
                                ctx=DeviceContext.create(device))
print(json.dumps([to_jsonable(deployed.predict(p), camelize_fields=True)
                  for p in payloads]))
"""


def fresh_process_answers(tag, variant, payloads, bodies, ctx) -> dict:
    """The trained model loaded and served by a fresh process on the same
    device (the phase's storage from the environment): its answers must
    equal the served ones."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", FRESH_PROCESS, variant, str(ctx.device)],
        input=json.dumps(payloads), capture_output=True, text=True,
        timeout=300, env=dict(os.environ,
                              PYTHONPATH=str(Path(__file__).resolve().parent)))
    check(out.returncode == 0, f"[{tag}] the fresh process failed: {out.stderr[-2000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    check(got == bodies, f"[{tag}] a fresh process serves other answers")
    return {"equal": True, "wall_s": time.perf_counter() - t0}


def sim_workflow_phase(ctx, tmp):
    """The similarproduct template through the CLI on sqlite: ``app new``,
    ``import`` of 10,000 items' ``$set`` categories and 100,000 ``view``
    events (``default_rng(13)``), ``train`` (als) on the card, deploy,
    queries over a socket held against numpy scoring of the trained tables,
    a fresh ``load_deployed_engine`` (and, for ``als``, a fresh process on
    the card) serving the same answers; then 20,000
    like/dislike events into the same app and the ``likealgo`` variant."""
    import datetime as dt

    from incubator_predictionio_tpu_torch.server.query_server import (
        ServerConfig,
        load_deployed_engine,
    )
    from incubator_predictionio_tpu_torch.utils.json_util import to_jsonable

    root = os.path.join(tmp, "sim-workflow")
    rng = np.random.default_rng(13)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    item_ids = [f"i{j}" for j in range(SIM_ITEMS)]
    items = [{"event": "$set", "entityType": "item", "entityId": iid,
              "properties": {"categories": [f"c{j % SIM_CATS}"]},
              "eventTime": t0.isoformat()} for j, iid in enumerate(item_ids)]
    vu = rng.integers(0, SIM_USERS, SIMWF_VIEWS)
    vi = rng.integers(0, SIM_ITEMS, SIMWF_VIEWS)
    views = [{"event": "view", "entityType": "user", "entityId": f"u{u}",
              "targetEntityType": "item", "targetEntityId": f"i{i}",
              "eventTime": (t0 + dt.timedelta(seconds=j + 1)).isoformat()}
             for j, (u, i) in enumerate(zip(vu, vi))]
    lu = rng.integers(0, SIM_USERS, SIMWF_LIKES)
    li = rng.integers(0, SIM_ITEMS, SIMWF_LIKES)
    like = rng.random(SIMWF_LIKES) < 0.7
    likes = [{"event": "like" if k else "dislike", "entityType": "user",
              "entityId": f"u{u}", "targetEntityType": "item",
              "targetEntityId": f"i{i}",
              "eventTime": (t0 + dt.timedelta(seconds=SIMWF_VIEWS + j + 1)).isoformat()}
             for j, (u, i, k) in enumerate(zip(lu, li, like))]
    payloads = sim_queries(np.random.default_rng(14), 16, item_ids)
    rec = {}
    with cli_storage(root) as registry:
        app_id, rec["import"] = cli_app_import("sim-workflow", root, "simwf",
                                               items + views)
        for name, extra in (("als", None), ("likealgo", likes)):
            tag = f"sim-workflow-{name}"
            if extra:
                path = os.path.join(root, "likes.json")
                n = write_events(path, extra)
                s0 = time.perf_counter()
                out = cli_run(tag, ["import", "--appid", str(app_id), "--input", path])
                check(f"Imported {n} events." in out, f"[{tag}] import: {out}")
                rec["import_likes_s"] = time.perf_counter() - s0
            variant = write_variant(
                os.path.join(root, f"sim-{name}.json"), SIM_FACTORY, "simwf",
                [{"name": name, "params": {"rank": SIM_RANK, "numIterations": 10,
                                           "seed": 1}}])
            iid, train_s = cli_train(tag, registry, variant, ctx)
            storage = registry.get_storage()
            res = asyncio.run(serve_phase(
                tag, variant, storage, ctx,
                lambda session, url, server: simwf_body(tag, payloads, session,
                                                        url, server)))
            bodies = res.pop("bodies")
            fresh = load_deployed_engine(ServerConfig(engine_variant=variant),
                                         storage, ctx, warmup=False)
            again = [to_jsonable(fresh.predict(p), camelize_fields=True)
                     for p in payloads]
            check(again == bodies, f"[{tag}] a fresh load serves other answers")
            res.update({"train_s": train_s, "instance": iid, "fresh_load_equal": True})
            if name == "als":
                res["fresh_process"] = fresh_process_answers(tag, variant, payloads,
                                                             bodies, ctx)
            rec[name] = res
            log(f"[{tag}] train on the card {train_s:.2f} s; {res['numpy_same_ids']}/"
                f"{len(payloads)} answers equal to numpy scoring of the trained "
                f"tables (the rest up to near-ties); a fresh load "
                + ("and a fresh process serve" if "fresh_process" in res else "serves")
                + f" the same answers; singles p50 {res['latency']['p50_ms']:.2f} ms")
            del fresh
    log(f"[sim-workflow] import {rec['import']['events']} events in "
        f"{rec['import']['import_s']:.2f} s ({rec['import']['import_us_per_event']:.1f} "
        f"µs an event), {SIMWF_LIKES} like/dislike in {rec['import_likes_s']:.2f} s")
    return rec


async def recuser_body(payloads, session, url, server):
    from incubator_predictionio_tpu_torch.templates import _similarity as sim
    from incubator_predictionio_tpu_torch.templates import recommended_user as ru

    tag = "recuser-workflow"
    model = server.deployed.models[0]
    check(model.serving_info()["device"].startswith("cuda"),
          f"[{tag}] not on the card: {model.serving_info()}")
    singles, burst = payloads[:16], payloads[16:]
    b_single, l_single = await post_all(session, url, singles, False)
    b_burst, l_burst = await post_all(session, url, burst, True)
    cpu = cpu_copy(model)
    algo = ru.ALSAlgorithm(ru.ALSAlgorithmParams())
    same = 0
    for p, body in zip(payloads, b_single + b_burst):
        got = [s["user"] for s in body["similarUserScores"]]
        check(all(s["score"] > 0 for s in body["similarUserScores"]),
              f"[{tag}] a score ≤ 0 served: {body}")
        check(not set(got) & set(p["users"]), f"[{tag}] a query user served")
        check(not set(got) & set(p.get("blackList") or ()),
              f"[{tag}] a blackListed user served")
        q = query_of(ru.Query, p)
        want = algo.predict(cpu, q)
        known = [cpu.user_map[u] for u in q.users if u in cpu.user_map]
        s = sim.sim_scores(cpu.user_vecs[known], cpu._device_vt,
                           algo._filter_mask(cpu, q))
        inv = cpu.user_map.inverse()
        full = {inv[j]: float(v) for j, v in enumerate(s) if np.isfinite(v)}
        same += near_tie_check(tag, body["similarUserScores"],
                               as_dicts(want, "similar_user_scores", "user"),
                               full, SIM_SCORE_TOL, key="user")
    return {"cpu_same_ids": same, "queries": len(payloads),
            "latency": {"single": lat_record(l_single), "burst64": lat_record(l_burst)}}


def recuser_queries(rng, n):
    """Queries of 1-3 users, with a blackList or a whiteList in turn."""
    payloads = []
    for j in range(n):
        p = {"users": [f"u{int(u)}" for u in rng.choice(RU_USERS, 1 + j % 3,
                                                        replace=False)],
             "num": 10}
        if j % 3 == 1:
            p["blackList"] = [f"u{int(u)}" for u in rng.integers(0, RU_USERS, 5)]
        elif j % 3 == 2:
            p["whiteList"] = [f"u{int(u)}" for u in rng.integers(0, RU_USERS, 800)]
        payloads.append(p)
    return payloads


def recuser_workflow_phase(ctx, tmp):
    """The recommended-user template through the CLI on sqlite: 10,000
    users' 100,000 ``follow`` events (``default_rng(17)``), ``train`` on the
    card, deploy, 16 singles and a burst of 64 held against the plain CPU
    path of the same model; the ``score > 0`` cut, no query user and no
    blackListed user served."""
    import datetime as dt

    root = os.path.join(tmp, "recuser-workflow")
    rng = np.random.default_rng(17)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    fu = rng.integers(0, RU_USERS, RU_FOLLOWS)
    ft = (fu + rng.integers(1, RU_USERS, RU_FOLLOWS)) % RU_USERS  # never oneself
    follows = [{"event": "follow", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "user", "targetEntityId": f"u{t}",
                "eventTime": (t0 + dt.timedelta(seconds=j)).isoformat()}
               for j, (u, t) in enumerate(zip(fu, ft))]
    payloads = recuser_queries(np.random.default_rng(18), 16 + 64)
    with cli_storage(root) as registry:
        _, rec = cli_app_import("recuser-workflow", root, "recuser", follows)
        variant = write_variant(os.path.join(root, "recuser.json"), RU_FACTORY,
                                "recuser", [{"name": "als", "params": {
                                    "rank": 32, "numIterations": 10, "seed": 1}}])
        rec["instance"], rec["train_s"] = cli_train("recuser-workflow", registry,
                                                    variant, ctx)
        rec.update(asyncio.run(serve_phase(
            "recuser-workflow", variant, registry.get_storage(), ctx,
            lambda session, url, server: recuser_body(payloads, session, url, server))))
    log(f"[recuser-workflow] import {rec['events']} follows in {rec['import_s']:.2f} s; "
        f"train on the card {rec['train_s']:.2f} s; {rec['cpu_same_ids']}/"
        f"{rec['queries']} answers equal to the CPU path (the rest up to near-ties); "
        f"singles p50 {rec['latency']['single']['p50_ms']:.2f} ms, burst of 64 p50 "
        f"{rec['latency']['burst64']['p50_ms']:.2f} p99 "
        f"{rec['latency']['burst64']['p99_ms']:.2f} ms")
    return rec


class CountingReads:
    """An event store that counts the reads serving makes through it."""

    def __init__(self, inner):
        self._inner = inner
        self.reads = 0

    def find(self, *args, **kwargs):
        self.reads += 1
        return self._inner.find(*args, **kwargs)

    def find_by_entities(self, *args, **kwargs):
        self.reads += 1
        return self._inner.find_by_entities(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def ecomm_events(rng):
    """bench_ecommerce_retrieval's events: 4,000 items' categories (c0..c7,
    g0..g2), 40 views a user for 500 users, 40 unavailable items."""
    import datetime as dt

    t0 = dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc).isoformat()
    cats = {f"i{i}": (f"c{i % 8}", f"g{i % 3}") for i in range(EC_ITEMS)}
    out = [{"event": "$set", "entityType": "item", "entityId": iid,
            "properties": {"categories": list(c)}, "eventTime": t0}
           for iid, c in cats.items()]
    for u in range(EC_USERS):
        for i in map(int, rng.integers(0, EC_ITEMS, EC_VIEWS)):
            out.append({"event": "view", "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "item", "targetEntityId": f"i{i}",
                        "eventTime": t0})
    out.append({"event": "$set", "entityType": "constraint",
                "entityId": "unavailableItems",
                "properties": {"items": [f"i{i}" for i in range(EC_UNAVAILABLE)]},
                "eventTime": t0})
    return cats, out


def ecomm_query(rng, j):
    u = f"u{int(rng.integers(0, EC_USERS))}" if j % 16 else "coldstart"
    kind = j % 4
    p = {"user": u, "num": 10}
    if kind == 1:
        p["categories"] = [f"c{j % 8}"]
    elif kind == 2:
        p["blackList"] = [f"i{i}" for i in range(j % 7)]
    elif kind == 3:
        p["categories"] = [f"g{j % 3}"]
        p["whiteList"] = [f"i{i}" for i in range(100, 1100)]
    return p


def ecomm_phase(ctx, tmp):
    """bench_ecommerce_retrieval's configuration (500 users, 4,000 items,
    rank 32, 40 views a user, 40 unavailable items, ``default_rng(3)``) on
    memory events: the serial ``predict`` (TTL 0, a read per query) against
    the vectorized ``batch_predict`` (the default TTL), query for query
    (equal ids, bitwise scores), their store reads and times; the same
    model over a socket; then the same events through the CLI on sqlite
    (the ALS fit on the card) and a deploy whose answers — a known user,
    unknown users with views (predictSimilar) and without (popularity) —
    are held against the CPU path of the same model."""
    import dataclasses

    from incubator_predictionio_tpu_torch.data.bimap import BiMap
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.storage import App, Storage
    from incubator_predictionio_tpu_torch.data.storage import registry as reg
    from incubator_predictionio_tpu_torch.models.two_tower import (
        TwoTowerConfig,
        TwoTowerModel,
    )
    from incubator_predictionio_tpu_torch.serving import TTLCache
    from incubator_predictionio_tpu_torch.templates import ecommerce as ec
    from incubator_predictionio_tpu_torch.utils.json_util import to_jsonable

    rng = np.random.default_rng(3)
    cats, dicts = ecomm_events(rng)
    root = os.path.join(tmp, "ecomm")
    os.makedirs(root, exist_ok=True)
    storage = Storage({
        "PIO_STORAGE_SOURCES_META_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_META_PATH": os.path.join(root, "meta.db"),
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    app_id = storage.get_meta_data_apps().insert(App(0, "bench-ecomm"))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([Event.from_json_dict(d) for d in dicts], app_id)
    norm = rng.standard_normal((EC_ITEMS, EC_RANK)).astype(np.float32)
    norm /= np.linalg.norm(norm, axis=1, keepdims=True) + 1e-9
    model = ec.ECommModel(
        mf=TwoTowerModel(
            user_emb=rng.standard_normal((EC_USERS, EC_RANK)).astype(np.float32),
            item_emb=rng.standard_normal((EC_ITEMS, EC_RANK)).astype(np.float32),
            user_bias=np.zeros(EC_USERS, np.float32),
            item_bias=np.zeros(EC_ITEMS, np.float32),
            mean=3.0, config=TwoTowerConfig(rank=EC_RANK)),
        user_map=BiMap.string_int(f"u{u}" for u in range(EC_USERS)),
        item_map=BiMap.string_int(f"i{i}" for i in range(EC_ITEMS)),
        categories=cats,
        popularity=rng.integers(0, 100, EC_ITEMS).astype(np.float32),
        item_vecs_norm=norm).prepare_for_serving(ctx)
    payloads = [ecomm_query(rng, j) for j in range(max(EC_SERIAL, EC_BATCHED))]
    queries = [query_of(ec.Query, p) for p in payloads]
    counting = CountingReads(events)
    storage.get_events = lambda: counting
    prev = reg.use_storage(storage)
    rec = {"users": EC_USERS, "items": EC_ITEMS, "rank": EC_RANK,
           "views_per_user": EC_VIEWS, "unavailable": EC_UNAVAILABLE}
    try:
        serial = ec.ECommAlgorithm(ec.ECommAlgorithmParams(app_name="bench-ecomm"))
        serial._constraint_cache = TTLCache(0)  # the reference's semantics
        batched = ec.ECommAlgorithm(ec.ECommAlgorithmParams(app_name="bench-ecomm"))
        want = [serial.predict(model, q) for q in queries[:EC_BATCH]]
        got = dict(batched.batch_predict(model, list(enumerate(queries[:EC_BATCH]))))
        for i in range(EC_BATCH):
            check([(s.item, s.score) for s in want[i].item_scores]
                  == [(s.item, s.score) for s in got[i].item_scores],
                  f"[ecomm] batch answer {i} differs from the serial one")
            check(not {f"i{j}" for j in range(EC_UNAVAILABLE)}
                  & {s.item for s in got[i].item_scores},
                  f"[ecomm] an unavailable item served: {got[i]}")
        r0 = counting.reads
        t0 = time.perf_counter()
        for q in queries[:EC_SERIAL]:
            serial.predict(model, q)
        serial_s = time.perf_counter() - t0
        rec["serial"] = {"queries": EC_SERIAL, "qps": EC_SERIAL / serial_s,
                         "store_reads_per_query": (counting.reads - r0) / EC_SERIAL}
        sizes: dict = {}
        r0 = counting.reads
        t0 = time.perf_counter()
        for off in range(0, EC_BATCHED, EC_BATCH):
            chunk = queries[off:off + EC_BATCH]
            batched.batch_predict(model, list(enumerate(chunk)))
            sizes[str(len(chunk))] = sizes.get(str(len(chunk)), 0) + 1
        batched_s = time.perf_counter() - t0
        rec["batched"] = {"queries": EC_BATCHED, "qps": EC_BATCHED / batched_s,
                          "batch_sizes": sizes,
                          "store_reads_per_batch": (counting.reads - r0)
                          / sum(sizes.values())}
        rec["speedup"] = rec["batched"]["qps"] / rec["serial"]["qps"]
        rec["serial_equals_batch"] = EC_BATCH
        # the same model over a socket: singles, then a burst of 64
        dstore, variant = deploy_storage(EC_FACTORY, {"appName": "bench-ecomm"},
                                         "ecomm", dataclasses.replace(model), tmp)

        async def body(session, url, server):
            b1, l1 = await post_all(session, url, payloads[:32], False)
            b2, l2 = await post_all(session, url, payloads[32:96], True)
            for p, b in zip(payloads[:96], b1 + b2):
                q = query_of(ec.Query, p)
                check(b == to_jsonable(serial.predict(model, q), camelize_fields=True),
                      f"[ecomm] served answer for {p} differs from predict")
            return {"latency": {"single": lat_record(l1), "burst64": lat_record(l2)}}

        rec["socket"] = asyncio.run(serve_phase("ecomm", variant, dstore, ctx, body))
    finally:
        reg.use_storage(prev)
        storage.close()
    log(f"[ecomm] serial predict {rec['serial']['qps']:.1f} q/s "
        f"({rec['serial']['store_reads_per_query']:.2f} store reads a query) vs "
        f"batch_predict {rec['batched']['qps']:.1f} q/s "
        f"({rec['batched']['store_reads_per_batch']:.2f} reads a batch, sizes "
        f"{sizes}): {rec['speedup']:.1f}x; {EC_BATCH} batch answers bitwise the "
        f"serial ones; socket singles p50 "
        f"{rec['socket']['latency']['single']['p50_ms']:.2f} ms, burst p50 "
        f"{rec['socket']['latency']['burst64']['p50_ms']:.2f} p99 "
        f"{rec['socket']['latency']['burst64']['p99_ms']:.2f} ms")
    rec["training"] = ecomm_training(ctx, os.path.join(tmp, "ecomm-train"), dicts)
    return rec


def ecomm_training(ctx, root, dicts):
    """The e-commerce events through the CLI on sqlite, the ALS fit on the
    card, a deploy; answers against the CPU path of the same model."""
    import datetime as dt

    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.serving import TTLCache
    from incubator_predictionio_tpu_torch.templates import ecommerce as ec

    tag = "ecomm-train"
    with cli_storage(root) as registry:
        app_id, rec = cli_app_import(tag, root, "ecomm", dicts)
        variant = write_variant(os.path.join(root, "ecomm.json"), EC_FACTORY, "ecomm",
                                [{"name": "ecomm", "params": {
                                    "appName": "ecomm", "rank": EC_RANK,
                                    "numIterations": 10, "seed": 1}}])
        rec["instance"], rec["train_s"] = cli_train(tag, registry, variant, ctx)
        storage = registry.get_storage()
        # a user the model has not seen, with views after the train
        t_new = dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc)
        storage.get_events().insert_batch([Event.from_json_dict({
            "event": "view", "entityType": "user", "entityId": "newcomer",
            "targetEntityType": "item", "targetEntityId": f"i{i}",
            "eventTime": (t_new + dt.timedelta(seconds=i)).isoformat()})
            for i in (101, 202, 303)], app_id)
        payloads = [{"user": "u1", "num": 10}, {"user": "u2", "num": 5,
                                                 "categories": ["c3"]},
                    {"user": "newcomer", "num": 10},
                    {"user": "newcomer", "num": 6, "blackList": ["i7"]},
                    {"user": "stranger", "num": 10}]

        async def body(session, url, server):
            algo = server.deployed.algorithms[0]
            model = server.deployed.models[0]
            check(np.isfinite(model.mf.final_loss), f"[{tag}] loss {model.mf.final_loss}")
            algo._constraint_cache = TTLCache(0)
            bodies, lat = await post_all(session, url, payloads, False)
            cpu = cpu_copy(model)
            ref = ec.ECommAlgorithm(ec.ECommAlgorithmParams(app_name="ecomm"))
            ref._constraint_cache = TTLCache(0)
            paths = []
            for p, b in zip(payloads, bodies):
                q = query_of(ec.Query, p)
                want = as_dicts(ref.predict(cpu, q))
                check(b["itemScores"] == want,
                      f"[{tag}] {p}: served {b} vs the CPU path {want}")
                check(len(want) == p["num"], f"[{tag}] short answer {want}")
                paths.append("known" if p["user"] in model.user_map
                             else "similar" if p["user"] == "newcomer" else "popularity")
            return {"final_loss": model.mf.final_loss, "paths": paths,
                    "latency": lat_record(lat)}

        rec.update(asyncio.run(serve_phase(tag, variant, storage, ctx, body)))
    log(f"[{tag}] import {rec['events']} events in {rec['import_s']:.2f} s, train on "
        f"the card {rec['train_s']:.2f} s (loss {rec['final_loss']:.6f}); answers "
        f"({rec['paths']}) equal to the CPU path's")
    return rec


def cls_step_parity(dev, x, y, cfg) -> dict:
    """One MLP step's loss and gradients on the card against the CPU from
    the same parameters and batch."""
    from incubator_predictionio_tpu_torch.models import mlp

    classes, y_idx = np.unique(y, return_inverse=True)
    xn = ((x - x.mean(0)) / (x.std(0) + 1e-8)).astype(np.float32)[:cfg.batch_size]
    yb = y_idx[:cfg.batch_size].astype(np.int64)
    init = mlp.init_params(torch.Generator().manual_seed(5),
                           [x.shape[1], *cfg.hidden_dims, len(classes)], "cpu")
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        net = mlp.MLPNet([{k: v.to(d) for k, v in layer.items()} for layer in init])
        loss = mlp.weighted_xent(net(torch.from_numpy(xn).to(d)),
                                 torch.from_numpy(yb).to(d),
                                 torch.ones(len(yb), device=d))
        grads = torch.autograd.grad(loss, list(net.parameters()))
        out[name] = (float(loss.detach()), [g.cpu() for g in grads])
    (lc, gc_), (lg, gg) = out["cpu"], out["card"]
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(gg, gc_)]
    res = {"loss_card": lg, "loss_cpu": lc, "loss_rel_diff": abs(lg - lc) / abs(lc),
           "grad_rel_err": rel, "grad_tol": CLS_GRAD_TOL}
    check(res["loss_rel_diff"] <= CLS_LOSS_RTOL,
          f"[cls-train] step loss on the card {lg} vs the CPU {lc}")
    for e in rel:
        check(e <= CLS_GRAD_TOL, f"[cls-train] a gradient on the card differs from "
              f"the CPU's by {e} of its max abs (> {CLS_GRAD_TOL})")
    return res


def cls_train_phase(ctx):
    """bench_classification's configuration, not cut (100,000 x 3 from
    ``default_rng(0)``, hidden (128, 128), 40 epochs, batch 4,096), through
    ``MLPClassifier.fit`` on the card: a warm-up fit, the timed fit, the
    device busy share of one step, one step against the CPU."""
    from incubator_predictionio_tpu_torch.models import mlp

    dev = ctx.device
    rng = np.random.default_rng(0)
    x = rng.normal(size=(CLS_ROWS, 3)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32)
    cfg = mlp.MLPConfig(hidden_dims=CLS_HIDDEN, epochs=CLS_EPOCHS,
                        batch_size=CLS_BATCH)
    t0 = time.perf_counter()
    mlp.MLPClassifier(cfg).fit(ctx, x, y)
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = mlp.MLPClassifier(cfg).fit(ctx, x, y)
    fit_s = time.perf_counter() - t0
    dims = [3, *CLS_HIDDEN, 2]
    flops = CLS_EPOCHS * CLS_ROWS * 6 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    acc = float(np.mean(mlp.MLPClassifier.predict(model, x[:20_000]) == y[:20_000]))
    # one step's device time and busy share
    net = mlp.MLPNet([{k: torch.from_numpy(v).to(dev) for k, v in layer.items()}
                      for layer in model.params])
    from incubator_predictionio_tpu_torch.utils.optim import adam_init

    state = adam_init([p.data for p in net.parameters()])
    xn = ((x - model.mean) / model.std).astype(np.float32)
    xb, yb, wb = mlp.stage_batches(xn, y.astype(np.int64), CLS_BATCH, ctx, dev)

    def step():
        mlp.train_step(net, state, xb[0], yb[0], wb[0], cfg.learning_rate)

    step_ms, step_by = device_busy(step, calls=5)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    steps = CLS_EPOCHS * xb.shape[0]
    rec = {"rows": CLS_ROWS, "hidden": CLS_HIDDEN, "epochs": CLS_EPOCHS,
           "batch": CLS_BATCH, "steps": steps, "warmup_fit_s": warm_s, "fit_s": fit_s,
           "events_per_sec": CLS_EPOCHS * CLS_ROWS / fit_s,
           "mfu": flops / fit_s / BF16_OPS_PER_S, "final_loss": model.final_loss,
           "train_accuracy_20k": acc, "step_wall_ms": step_wall_ms,
           "step_device_ms": step_ms, "step_busy_share": step_ms / step_wall_ms,
           "step_top_device_ms": dict(sorted(step_by.items(), key=lambda kv: -kv[1])[:6])}
    check(np.isfinite(model.final_loss) and acc > 0.95,
          f"[cls-train] loss {model.final_loss}, accuracy {acc}")
    rec["step_parity"] = cls_step_parity(dev, x, y, cfg)
    rec["naive_bayes"] = nb_twice(ctx, x, y)
    p = rec["step_parity"]
    log(f"[cls-train] fit {CLS_ROWS} rows x {CLS_EPOCHS} epochs = {steps} steps of "
        f"{CLS_BATCH}: {fit_s:.3f} s (warm-up {warm_s:.3f} s), "
        f"{rec['events_per_sec']:.1f} events/s, mfu {rec['mfu']:.6f}; loss "
        f"{model.final_loss:.6f}, accuracy {acc:.4f}; a step {step_wall_ms:.3f} ms "
        f"wall, {step_ms:.4f} ms device (busy share {rec['step_busy_share']:.4f}); "
        f"card vs CPU step: loss rel {p['loss_rel_diff']:.2e}, gradients "
        + ", ".join(f"{e:.2e}" for e in p["grad_rel_err"]) + f" (tol {CLS_GRAD_TOL}); "
        f"two naive Bayes fits on the card bitwise, "
        f"{rec['naive_bayes']['fit_s']:.4f} s a fit")
    return rec


def nb_twice(ctx, x, y) -> dict:
    """The naive Bayes fit on the card twice from the same rows: the
    segment sums are sorted, so the two fits must be bitwise."""
    from incubator_predictionio_tpu_torch.templates import classification as tcl

    algo = tcl.NaiveBayesAlgorithm(tcl.NaiveBayesAlgorithmParams())
    td = tcl.TrainingData(x, y)
    algo.train(ctx, td)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fits = [algo.train(ctx, td) for _ in range(2)]
    fit_s = (time.perf_counter() - t0) / 2
    for name in ("means", "variances", "log_priors"):
        a, b = (getattr(f, name) for f in fits)
        check(a.tobytes() == b.tobytes(),
              f"[cls-train] two naive Bayes fits on the card differ in {name}")
    return {"fit_s": fit_s, "bitwise_twice": True}


async def cls_body(tag, payloads, labels, session, url, server):
    from incubator_predictionio_tpu_torch.templates import classification as cl

    for m in server.deployed.models:
        check(m.serving_info()["device"].startswith("cuda"),
              f"[{tag}] not on the card: {m.serving_info()}")
    singles, burst = payloads[:16], payloads[16:80]
    b1, l1 = await post_all(session, url, singles, False)
    b2, l2 = await post_all(session, url, burst, True)
    served = [b["label"] for b in b1 + b2]
    cpu = [cpu_copy(m) for m in server.deployed.models]
    want = []
    for p in payloads[:80]:
        q = cl.Query(tuple(p["features"]))
        preds = [a.predict(m, q) for a, m in zip(server.deployed.algorithms, cpu)]
        want.append(server.deployed.serving.serve(q, preds).label)
    agree = float(np.mean([a == b for a, b in zip(served, want)]))
    acc = float(np.mean([a == b for a, b in zip(served, labels[:80])]))
    check(agree >= CLS_LABEL_AGREE,
          f"[{tag}] labels on the card agree with the CPU path on {agree}")
    return {"cpu_label_agreement": agree, "accuracy_80": acc,
            "latency": {"single": lat_record(l1), "burst64": lat_record(l2)}}


def cls_workflow_phase(ctx, tmp):
    """The classification template through the CLI on sqlite: 10,000 users'
    ``$set`` events with attr0..2 and a plan that is a linear rule of them
    (``default_rng(19)``); the ``mlp`` variant, then ``nb`` + ``mlp`` under
    ``vote``; each deployed, 16 singles and a burst of 64 held against the
    same models' CPU path."""
    import datetime as dt

    root = os.path.join(tmp, "cls-workflow")
    rng = np.random.default_rng(19)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    x = rng.normal(size=(CLSWF_USERS, 3)) * [1.0, 2.0, 0.5] + [0.0, 3.0, -1.0]
    s = x @ np.array([1.0, -0.5, 2.0])
    plan = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(float)
    dicts = [{"event": "$set", "entityType": "user", "entityId": f"u{j}",
              "properties": {"attr0": float(r[0]), "attr1": float(r[1]),
                             "attr2": float(r[2]), "plan": float(p)},
              "eventTime": (t0 + dt.timedelta(seconds=j)).isoformat()}
             for j, (r, p) in enumerate(zip(x, plan))]
    payloads = [{"features": [float(v) for v in r]} for r in x[:80]]
    rec = {}
    with cli_storage(root) as registry:
        _, rec["import"] = cli_app_import("cls-workflow", root, "cls", dicts)
        for name, algos, serving in (
                ("mlp", [{"name": "mlp", "params": {"hiddenDims": [64, 64],
                                                    "epochs": 20}}], None),
                ("nb-vote", [{"name": "nb", "params": {}},
                             {"name": "mlp", "params": {"hiddenDims": [64, 64],
                                                        "epochs": 20}}], "vote")):
            tag = f"cls-workflow-{name}"
            variant = write_variant(os.path.join(root, f"cls-{name}.json"),
                                    CLS_FACTORY, "cls", algos, serving)
            iid, train_s = cli_train(tag, registry, variant, ctx)
            res = asyncio.run(serve_phase(
                tag, variant, registry.get_storage(), ctx,
                lambda session, url, server: cls_body(tag, payloads, plan,
                                                      session, url, server)))
            res["train_s"] = train_s
            rec[name] = res
            log(f"[{tag}] train on the card {train_s:.2f} s; labels equal to the "
                f"CPU path on {res['cpu_label_agreement']:.4f}, accuracy "
                f"{res['accuracy_80']:.4f}; singles p50 "
                f"{res['latency']['single']['p50_ms']:.2f} ms, burst of 64 p50 "
                f"{res['latency']['burst64']['p50_ms']:.2f} ms")
    return rec


# -- the evaluation phases: `pio eval` on the card ----------------------------

#: the reference Evaluations' folds (templates' eval_k)
EVAL_K = 3
#: card against CPU, per fold, variant 0: Precision@10 (rec-eval) and
#: accuracy (cls-eval) within this absolute band — rec-train's fit bands
#: carried to a top-10 metric
EVAL_CPU_BAND = 0.02
#: seq-eval's kernels-vs-plain serving check: eval queries of the best
#: variant's first fold
SEQ_EVAL_PLAIN_QUERIES = 16
REC_EVALUATION = ("incubator_predictionio_tpu_torch.templates.recommendation."
                  "RecommendationEvaluation")
SEQ_EVALUATION = ("incubator_predictionio_tpu_torch.templates.sequential."
                  "SequentialEvaluation")
CLS_EVALUATION = ("incubator_predictionio_tpu_torch.templates.classification."
                  "CompleteEvaluation")


#: the recommendation grids' iterations in rec-eval and rec-launch-eval
#: (the reference grid's 10, cut for the script's time: PERF.md §4)
REC_EVAL_ITERATIONS = 5


class RecEvalGrid:
    """rec-eval's EngineParamsGenerator (the CLI loads it by class path):
    the reference RecommendationEvaluation's grid cut to its 10-iteration
    half, rank 16 / 32, on rec-workflow's app ``ml1m``, each at 5
    iterations (the 20-iteration half runs the same path; depth cut for
    the script's time: PERF.md §4)."""

    def __init__(self):
        from incubator_predictionio_tpu_torch.core import EngineParams
        from incubator_predictionio_tpu_torch.templates import recommendation as trec

        self.engine_params_list = [
            EngineParams.create(
                data_source=trec.DataSourceParams(app_name="ml1m", eval_k=EVAL_K),
                algorithms=[("als", trec.ALSAlgorithmParams(
                    rank=rank, num_iterations=REC_EVAL_ITERATIONS))])
            for rank in (16, 32)]


class SeqEvalGrid:
    """seq-eval's generator at seq-workflow's full width (d_model 512, 6
    layers, 8 heads of 64, ``max_len`` 512, batch 64): 1 epoch × learning
    rate 1e-3 / 5e-3 (its 2-epoch half cut for the script's time;
    PERF.md §4). The reference SequentialEvaluation's own
    grid (d_model 32, heads of 16, ``max_len`` 32) reaches no kernel."""

    def __init__(self):
        from incubator_predictionio_tpu_torch.core import EngineParams
        from incubator_predictionio_tpu_torch.templates import sequential as tseq

        self.engine_params_list = [
            EngineParams.create(
                data_source=tseq.DataSourceParams(
                    app_name="seq", max_len=SEQ_WF_MAX_LEN, eval_k=EVAL_K),
                algorithms=[("transformer", tseq.TransformerAlgorithmParams(
                    app_name="seq", max_len=SEQ_WF_MAX_LEN, d_model=SEQ_D,
                    n_heads=SEQ_HEADS, n_layers=SEQ_LAYERS, learning_rate=lr,
                    batch_size=TRAIN_BATCH, epochs=epochs))])
            for epochs in (1,) for lr in (1e-3, 5e-3)]


#: cls-eval's MLP epochs: the reference grid trains 60; 10 run the same
#: path at a sixth of the fits' time (cut for the script's time: PERF.md
#: §4)
CLS_EVAL_EPOCHS = 10


def cls_eval_grid() -> list:
    """The reference ``_classification_grid`` (hidden (16,) / (32, 32) ×
    learning rate 1e-2 / 3e-2) on cls-workflow's app ``cls``, at
    :data:`CLS_EVAL_EPOCHS`."""
    from incubator_predictionio_tpu_torch.templates import classification as tcl

    return [dataclasses.replace(ep, algorithm_params_list=tuple(
        (name, dataclasses.replace(p, epochs=CLS_EVAL_EPOCHS))
        for name, p in ep.algorithm_params_list))
        for ep in tcl._classification_grid("cls", EVAL_K)]


class ClsEvalGrid:
    """cls-eval's generator: :func:`cls_eval_grid`."""

    def __init__(self):
        self.engine_params_list = cls_eval_grid()


@contextlib.contextmanager
def eval_spy(data_source_cls, algorithm_cls, keep_models=False):
    """Times ``read_eval``, each ``train`` (synchronized on the card) and
    ``batch_predict`` over one evaluation, and keeps what
    ``FastEvalEngine.batch_eval`` returned with its cache stats (and, with
    ``keep_models``, the (params, model) of each train)."""
    from incubator_predictionio_tpu_torch.core.fast_eval import FastEvalEngine

    rec = {"read_eval_s": 0.0, "train_s": [], "predict_s": 0.0, "queries": 0,
           "models": [], "results": None, "cache_stats": None}

    def read_eval(orig):
        def f(self, ctx):
            t0 = time.perf_counter()
            out = orig(self, ctx)
            rec["read_eval_s"] += time.perf_counter() - t0
            return out
        return f

    def train(orig):
        def f(self, ctx, pd):
            t0 = time.perf_counter()
            model = orig(self, ctx, pd)
            if ctx.device.type == "cuda":
                torch.cuda.synchronize()
            rec["train_s"].append(time.perf_counter() - t0)
            if keep_models:
                rec["models"].append((self.params, model))
            return model
        return f

    def batch_predict(orig):
        def f(self, model, queries):
            t0 = time.perf_counter()
            out = orig(self, model, queries)
            rec["predict_s"] += time.perf_counter() - t0
            rec["queries"] += len(queries)
            return out
        return f

    def batch_eval(orig):
        def f(self, *args, **kw):
            out = orig(self, *args, **kw)
            rec["results"], rec["cache_stats"] = out, dict(self.last_cache_stats)
            return out
        return f

    patched = [(data_source_cls, "read_eval", read_eval),
               (algorithm_cls, "train", train),
               (algorithm_cls, "batch_predict", batch_predict),
               (FastEvalEngine, "batch_eval", batch_eval)]
    saved = []
    for cls, name, wrap in patched:
        saved.append((cls, name, cls.__dict__.get(name)))
        setattr(cls, name, wrap(getattr(cls, name)))
    try:
        yield rec
    finally:
        for cls, name, orig in saved:
            if orig is None:
                delattr(cls, name)
            else:
                setattr(cls, name, orig)


def cli_eval(tag, registry, evaluation, generator, ctx, spy):
    """CLI ``eval`` on ``ctx``'s device; checks the instance row
    (EVALCOMPLETED, its JSON parses, every score finite, ``bestIdx`` the
    first arg-max) and FastEvalEngine's one read and one prepare. Returns
    (instance, parsed results, wall s)."""
    t0 = time.perf_counter()
    out = cli_run(tag, ["eval", evaluation, f"{__name__}:{generator}",
                        "--device", str(ctx.device)])
    wall = time.perf_counter() - t0
    iid = out.split("Instance ID: ")[-1].split()[0]
    inst = registry.get_storage().get_meta_data_evaluation_instances().get(iid)
    check(inst is not None and inst.status == "EVALCOMPLETED",
          f"[{tag}] instance {iid}: {inst}")
    check(inst.evaluator_results in out, f"[{tag}] the one-liner was not printed: {out}")
    res = json.loads(inst.evaluator_results_json)
    scores = [r["score"] for r in res["results"]]
    check(len(scores) > 0 and all(np.isfinite(scores)), f"[{tag}] scores {scores}")
    check(res["bestIdx"] == int(np.argmax(scores)),
          f"[{tag}] bestIdx {res['bestIdx']} of scores {scores}")
    n = len(scores)
    check(spy["cache_stats"] == {"ds": 1, "prep": 1, "algo": n},
          f"[{tag}] FastEvalEngine cache stats {spy['cache_stats']}")
    check(len(spy["train_s"]) == n * EVAL_K,
          f"[{tag}] {len(spy['train_s'])} fits for {n} variants × {EVAL_K} folds")
    return inst, res, wall


def eval_timings(spy, wall) -> dict:
    return {"wall_s": wall, "read_eval_s": spy["read_eval_s"],
            "fits": len(spy["train_s"]), "train_s": sum(spy["train_s"]),
            "train_s_each": spy["train_s"], "batch_predict_s": spy["predict_s"],
            "queries": spy["queries"],
            "queries_per_s": spy["queries"] / max(spy["predict_s"], 1e-9),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "cache_stats": spy["cache_stats"]}


def eval_line(tag, t) -> str:
    return (f"[{tag}] eval wall {t['wall_s']:.2f} s: read_eval "
            f"{t['read_eval_s']:.2f} s, {t['fits']} fits on the card "
            f"{t['train_s']:.2f} s, batch_predict {t['batch_predict_s']:.2f} s "
            f"for {t['queries']} queries ({t['queries_per_s']:.1f}/s); peak "
            f"device memory {t['max_memory_allocated_bytes'] / 2**30:.3f} GiB; "
            f"cache {t['cache_stats']}")


def fold_scores_vs_cpu(tag, engine, ep, metric, ctx, card_folds, key):
    """Variant ``ep`` again through ``Engine.eval`` on the CPU from the same
    store: each fold's queries equal the card's, ``metric`` within
    :data:`EVAL_CPU_BAND` per fold."""
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

    cpu = DeviceContext.create("cpu")
    t0 = time.perf_counter()
    cpu_folds = engine.eval(cpu, ep)
    cpu_s = time.perf_counter() - t0
    out = []
    for (ei, card), (ei_c, host) in zip(card_folds, cpu_folds, strict=True):
        check(ei == ei_c and [key(q, a) for q, _, a in card]
              == [key(q, a) for q, _, a in host],
              f"[{tag}] fold {ei}: the CPU's queries differ from the card's")
        a, b = metric.calculate(ctx, [(ei, card)]), metric.calculate(cpu, [(ei, host)])
        check(abs(a - b) <= EVAL_CPU_BAND,
              f"[{tag}] fold {ei}: {metric.header} {a} on the card, {b} on the CPU")
        out.append({"fold": ei["fold"], "card": a, "cpu": b})
    return {"folds": out, "cpu_eval_s": cpu_s}


def rec_eval_phase(ctx, tmp):
    """``pio eval`` of the recommendation template on rec-workflow's sqlite
    app (100,050 events at MovieLens-1M's shape): RecommendationEvaluation
    with :class:`RecEvalGrid` (2 variants × 3 folds = 6 fits on the card;
    scoring is host numpy at this catalog, as in the reference), then
    variant 0 again on the CPU, Precision@10 per fold within
    :data:`EVAL_CPU_BAND`. Returns the record."""
    from incubator_predictionio_tpu_torch.templates import recommendation as trec

    root = os.path.join(tmp, "rec-workflow")
    torch.cuda.reset_peak_memory_stats()
    with cli_storage(root) as registry:
        with eval_spy(trec.DataSource, trec.ALSAlgorithm) as spy:
            inst, res, wall = cli_eval("rec-eval", registry, REC_EVALUATION,
                                       "RecEvalGrid", ctx, spy)
        rec = eval_timings(spy, wall)
        n_q, chance = 0, []
        for _, folds in spy["results"]:
            for _, qpa in folds:
                for q, p, a in qpa:
                    ids = [x.item for x in p.item_scores]
                    check(len(ids) <= q.num and len(set(ids)) == len(ids),
                          f"[rec-eval] {q.user}: {len(ids)} items for num "
                          f"{q.num}, {len(ids) - len(set(ids))} repeated")
                    n_q += 1
                    pos = sum(r.rating >= 2.0 for r in a.ratings)
                    if pos:
                        # a random top-10's expected Precision@10
                        chance.append(10 * pos / WF_ITEMS / min(10, pos))
        ep0, card_folds = spy["results"][0]
        rec["cpu"] = fold_scores_vs_cpu(
            "rec-eval", trec.RecommendationEngine().apply(), ep0,
            trec.PrecisionAtK(k=10, rating_threshold=2.0), ctx, card_folds,
            lambda q, a: (q.user, q.num, a))
    rec.update({"scores": [r["score"] for r in res["results"]],
                "positive_count": [r["otherScores"][0] for r in res["results"]],
                "best_idx": res["bestIdx"], "chance": float(np.mean(chance)),
                "answers": n_q, "one_liner": inst.evaluator_results})
    log(eval_line("rec-eval", rec))
    log(f"[rec-eval] Precision@10 of rank 16/32 × {REC_EVAL_ITERATIONS} iterations "
        f"{[round(x, 4) for x in rec['scores']]} (best {rec['best_idx']}) against "
        f"chance {rec['chance']:.4f}; positives a query "
        f"{rec['positive_count'][0]:.2f}; {n_q} answers, none over num, none "
        f"repeated; variant 0 on the CPU per fold "
        f"{[(round(f['card'], 4), round(f['cpu'], 4)) for f in rec['cpu']['folds']]}")
    return rec


# -- phase: multi-process training of the recommendation template -----------

#: rec-launch: bench_recommendation_scaled's widths (:196-207; rank 128,
#: 100,000 items) with users and events cut 10x for the sqlite import's
#: time (1,000,000 -> 100,000 users, 4,000,000 -> 400,000 rate events, drawn
#: from default_rng(23); the first 100,000 events name every item once, so
#: the catalog keeps its full width and passes PIO_RETRIEVAL_MIN_ITEMS's
#: default); rec-train's batch (65,536) and epochs (4); fp32 adam moments
#: (the template's default)
LAUNCH_USERS, LAUNCH_ITEMS, LAUNCH_RANK = 100_000, 100_000, 128
LAUNCH_EVENTS, LAUNCH_BATCH, LAUNCH_EPOCHS = 400_000, 65_536, 4
LAUNCH_PROCS = 2
#: the launch's own deadline (a wedged peer fails the phase, not the call)
LAUNCH_TIMEOUT_S = 600
#: the replay (both shards' batches through the single-process loop on the
#: card, from the same initial tables; both take the sorted scatter)
#: against the launched model's tables, max abs difference: 0. The
#: two run the same kernels on the same rows in the same order, the
#: launched fit on half the rows a launch; adam turns any rounding
#: difference of a near-zero gradient into a step of about ±lr, so a band
#: between 0 and lr would hide nothing and admit a real fault
LAUNCH_REPLAY_TOL = 0.0

LAUNCH_LINE = {
    "dist": re.compile(r"distributed: process (\d+) of (\d+), backend (\w+), "
                       r"device (\S+)"),
    "read": re.compile(r"sharded read: (\d+) of (\d+) rows \(shard (\d+)/(\d+)\), "
                       r"(\d+) local users, (\d+) global users, (\d+) global "
                       r"items in ([\d.]+) s"),
    "fit": re.compile(r"data-parallel fit: process (\d+) of (\d+) \(backend "
                      r"(\w+), (\S+)\): (\d+) steps of (\d+) local rows; stage "
                      r"([\d.]+) s, train ([\d.]+) s, exchange ([\d.]+) ms a "
                      r"step; loss (\S+); replica digest (\w+), equal"),
}


def launch_sections(out: str, lines=LAUNCH_LINE, tag="rec-launch",
                    many=()) -> list[dict]:
    """Each launched process's lines parsed: its exit code and, for each
    pattern of ``lines``, its one matching line (every matching line for
    the keys in ``many``)."""
    parts = re.split(r"^--- process (\d+) \(exit (-?\d+)\) ---$", out,
                     flags=re.M)
    procs = []
    for i in range(1, len(parts), 3):
        body = parts[i + 2]
        rec = {"process": int(parts[i]), "rc": int(parts[i + 1]), "log": body}
        check(rec["rc"] == 0, f"[{tag}] process {parts[i]} exited "
              f"{rec['rc']}:\n{body[-4000:]}")
        for key, rx in lines.items():
            m = rx.findall(body)
            if key in many:
                rec[key] = m
                continue
            check(len(m) == 1, f"[{tag}] process {parts[i]}: {len(m)} "
                  f"'{key}' lines in its log:\n{body[-4000:]}")
            rec[key] = m[0]
        procs.append(rec)
    check([p["process"] for p in procs] == list(range(LAUNCH_PROCS)),
          f"[{tag}] processes {[p['process'] for p in procs]}:\n{out[-4000:]}")
    return procs


class ShardScript:
    """One process's view of a job for the replay: each ``allgather_obj``
    returns every shard's part of that call (scripted in advance, in
    process order) after checking this process's own; ``device`` is where
    the staging puts its batches."""

    def __init__(self, index, script, device=None):
        self.process_index = self.data_index = index
        self.process_count = self.data_size = len(script[0])
        self.device = device
        self._script = list(script)

    def allgather_obj(self, obj, axis=None):
        parts = self._script.pop(0)
        check(repr(parts[self.process_index]) == repr(obj),
              "[replay] a shard diverged from its script")
        return list(parts)

    def pad_to_batch_multiple(self, n):
        k = self.process_count
        return ((n + k - 1) // k) * k


def shard_triples(users, items, ratings, n_shards):
    """Each entity shard's ``assemble_triples`` result computed from the
    generated arrays (events in time order, ``u<i>`` / ``i<j>`` ids), not
    from the store: the users whose id's crc32 falls in the shard, the
    latest rating of a pair winning, rows in pair-first-seen order and both
    vocabularies in first-emitted order."""
    import zlib

    shard_of = {}
    out = []
    for s in range(n_shards):
        uv: dict = {}
        iv: dict = {}
        row: dict = {}
        ui, ii, vals = [], [], []
        for u, i, r in zip(users, items, ratings):
            su = shard_of.get(u)
            if su is None:
                su = shard_of[u] = zlib.crc32(f"u{u}".encode()) % n_shards
            if su != s:
                continue
            a = uv.setdefault(f"u{u}", len(uv))
            b = iv.setdefault(f"i{i}", len(iv))
            j = row.get((a, b))
            if j is not None:
                vals[j] = r
                continue
            row[(a, b)] = len(vals)
            ui.append(a)
            ii.append(b)
            vals.append(r)
        out.append((np.asarray(list(uv), object), np.asarray(list(iv), object),
                    np.asarray(ui, np.int32), np.asarray(ii, np.int32),
                    np.asarray(vals, np.float32)))
    return out


def launch_replay(arrays, variant_path, ctx):
    """Both shards read and staged in this process (``_read_sharded`` and
    ``_stage_local`` under :class:`ShardScript`, the shards' triples from
    :func:`shard_triples`), their local batches concatenated into the
    global ones, and the single-process loop run on the card from the
    launched fit's initial tables. Returns its tables, loss and train
    seconds, and the vocabularies, the mean and the read's seconds."""
    from incubator_predictionio_tpu_torch.core.controller import (
        resolve_engine_factory,
        variant_from_file,
    )
    from incubator_predictionio_tpu_torch.models import two_tower as tt
    from incubator_predictionio_tpu_torch.utils.optim import adam_tree_init

    variant = variant_from_file(variant_path)
    engine = resolve_engine_factory(variant["engineFactory"])()
    ds, _, (algo,), _ = engine._instantiate(engine.engine_params_from_variant(variant))
    t0 = time.perf_counter()
    reads = shard_triples(*(a.tolist() for a in arrays), LAUNCH_PROCS)
    read_s = time.perf_counter() - t0
    script = [[list(r[0]) for r in reads], [list(r[1]) for r in reads],
              [len(r[4]) for r in reads]]
    ds._store = type("Shards", (), {"assemble_triples": lambda self, *a, **k:
                                    reads[k["shard_index"]]})()
    shards = [ds.read_training(ShardScript(s, script)) for s in range(LAUNCH_PROCS)]
    a = algo.params
    cfg = tt.TwoTowerConfig(rank=a.rank, learning_rate=a.learning_rate,
                            reg=a.lambda_, epochs=a.num_iterations,
                            batch_size=a.batch_size, seed=a.seed or 0)
    stats = [[(len(sh.ratings), float(np.asarray(sh.ratings, np.float64).sum()))
              for sh in shards]]
    staged = [tt.TwoTowerMF(cfg)._stage_local(
        ShardScript(s, stats), sh.user_idx, sh.item_idx, sh.ratings)
        for s, sh in enumerate(shards)]
    dev = ctx.device
    glob = [torch.from_numpy(np.concatenate([st[j] for st in staged], axis=1)).to(dev)
            for j in range(4)]
    n_users, n_items = len(shards[0].user_vocab), len(shards[0].item_vocab)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    tables = list(tt._init_tables(cfg, n_users, n_items, dev, gen))
    state = adam_tree_init(tables, cfg.adam_moments_dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(tt._train_epochs(tables, [torch.empty_like(t) for t in tables],
                                  state, *glob, cfg.learning_rate, cfg.reg,
                                  cfg.epochs))
    out = {"tables": [t.cpu().numpy() for t in tables], "loss": loss,
           "train_s": time.perf_counter() - t0}
    del tables, state
    return out, {"mean": staged[0][4], "read_s": read_s,
                 "user_vocab": shards[0].user_vocab,
                 "item_vocab": shards[0].item_vocab,
                 "steps": cfg.epochs * int(glob[0].shape[0])}


def nccl_collectives_check(ctx) -> dict:
    """A world-size-1 NCCL group on this card: the collectives the fit
    makes (the row all-gather, the loss all-reduce, ``allgather_obj``) on
    CUDA tensors of the fit's shapes, against their plain results."""
    from incubator_predictionio_tpu_torch.parallel.launcher import free_port
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

    with env_vars(PIO_DIST_COORDINATOR=f"127.0.0.1:{free_port()}",
                  PIO_DIST_NUM_PROCESSES="1", PIO_DIST_PROCESS_ID="0"):
        one = DeviceContext.create(distributed=True)
    try:
        check(one.backend == "nccl" and one.device.type == "cuda",
              f"[rec-launch] a 1-process group on the card is {one}")
        rows = torch.randn(LAUNCH_BATCH // LAUNCH_PROCS, 2 * (LAUNCH_RANK + 1),
                           device=one.device)
        losses = torch.rand(8, device=one.device)
        got = one.all_gather(rows)
        check(got.shape == (1, *rows.shape) and torch.equal(got[0], rows),
              "[rec-launch] NCCL all_gather differs from its input")
        check(torch.equal(one.all_reduce_sum(losses), losses),
              "[rec-launch] NCCL all_reduce differs from its input")
        check(one.allgather_obj(("n", 3)) == [("n", 3)],
              "[rec-launch] allgather_obj over NCCL")
        ms = time_ms(lambda: one.all_gather(rows), reps=10, inner=5)
    finally:
        one.stop()
    return {"backend": one.backend, "all_gather_ms": ms,
            "all_gather_bytes": rows.numel() * 4}


def cpu_int8(mf):
    """The plain CPU int8 serving path of a host two-tower model: the same
    arrays, quantized on the host, no index."""
    from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerModel

    cpu = TwoTowerModel(user_emb=mf.user_emb, item_emb=mf.item_emb,
                        user_bias=mf.user_bias, item_bias=mf.item_bias,
                        mean=mf.mean, config=mf.config)
    cpu.prepare_for_serving(quantize=True, host_max_elements=0, device="cpu",
                            build_index=False)
    return cpu


def two_stage_vs_cpu(name, model, served_mf, user_ids, bodies) -> dict:
    """The served two-stage answers of ``user_ids`` against the plain CPU
    two-stage path on the same model and the same IVF index (its coarse
    probe the exact host twin of K2, which K2 equals bitwise; the same host
    rerank): top-10 ids equal up to near-ties at the 10th place, scores
    within 1e-4. Also the share of the catalog that the probed partitions
    hold for these users, the recall@10 a probe blind to the exact answer
    would reach."""
    import dataclasses

    from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerMF
    from incubator_predictionio_tpu_torch.ops.retrieval import quantize_rows
    from incubator_predictionio_tpu_torch.serving import ann

    mf = model.mf
    cpu = cpu_int8(mf)
    ivf = dataclasses.replace(served_mf._ivf, device=None)
    cpu._ivf = ivf
    rows = np.asarray([model.user_map[u] for u in user_ids], np.int32)
    ci, cs = TwoTowerMF.recommend_batch(cpu, rows, 12)
    inv = model.item_map.inverse()
    same = 0
    for r, body in enumerate(bodies):
        got = ids_of(body)
        want = [inv[int(i)] for i in ci[r][:10]]
        cpu_score = dict(zip([inv[int(i)] for i in ci[r]], cs[r].tolist()))
        for iid in set(got) ^ set(want):
            check(iid in cpu_score and abs(cpu_score[iid] - float(cs[r][9])) <= 1e-4,
                  f"[{name}] two-stage top-10 differs from the CPU two-stage "
                  f"path beyond a near-tie: {got} vs {want}")
        for s in body["itemScores"]:
            check(s["item"] in cpu_score
                  and abs(s["score"] - cpu_score[s["item"]]) <= 1e-4,
                  f"[{name}] two-stage score {s} vs the CPU two-stage path")
        same += got == want
    q = np.asarray(mf.user_emb, np.float32)[rows]
    probe = ivf.probe(q, ann.resolved_nprobe(ivf.n_partitions),
                      q_quant=quantize_rows(q))
    probed = float((np.diff(ivf.offsets)[probe].sum(1) / ivf.n_items).mean())
    return {"cpu_two_stage_same_order": same, "probed_catalog_share": probed,
            "nprobe": int(probe.shape[1]), "partitions": ivf.n_partitions}


async def rec_launch_body(model, user_ids, session, url, server, lat, answers,
                          name):
    """A burst of 64 users; on the exact path 16 of them also against the
    plain CPU int8 path on the same model (top-10 up to near-ties at the
    10th place, scores within 1e-4)."""
    from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerMF

    served = server.deployed.models[0]
    info = served.serving_info()
    payload = [{"user": u, "num": 10} for u in user_ids]
    bodies, lat[name] = await post_all(session, url, payload, True)
    for body in bodies:
        check(len(body["itemScores"]) == 10
              and all(np.isfinite(s["score"]) for s in body["itemScores"]),
              f"[{name}] answer {body}")
    answers[name] = [ids_of(b) for b in bodies]
    if name != "rec-launch-exact":
        check(info["retrieval_mode"] == "two_stage"
              and (info["index"] or {}).get("coarse_device", "").startswith("cuda"),
              f"[{name}] not two-stage on the card: {info}")
        return {"serving_info": info,
                **two_stage_vs_cpu(name, model, served.mf, user_ids[:16],
                                   bodies[:16])}
    check(info["path"] == "device-int8" and info["device"].startswith("cuda")
          and info["retrieval_mode"] == "exact",
          f"[{name}] not the exact int8 path on the card: {info}")
    cpu = cpu_int8(model.mf)
    rows = np.asarray([model.user_map[u] for u in user_ids[:16]], np.int32)
    ci, cs = TwoTowerMF.recommend_batch(cpu, rows, 12)
    inv = model.item_map.inverse()
    same = 0
    for r, body in enumerate(bodies[:16]):
        got = ids_of(body)
        want = [inv[int(i)] for i in ci[r][:10]]
        cpu_score = dict(zip([inv[int(i)] for i in ci[r]], cs[r].tolist()))
        for iid in set(got) ^ set(want):
            check(iid in cpu_score and abs(cpu_score[iid] - float(cs[r][9])) <= 1e-4,
                  f"[{name}] top-10 differs from the CPU path beyond a "
                  f"near-tie: {got} vs {want}")
        for s in body["itemScores"]:
            check(abs(s["score"] - cpu_score[s["item"]]) <= 1e-4,
                  f"[{name}] score {s} vs CPU {cpu_score[s['item']]}")
        same += got == want
    return {"serving_info": info, "cpu_same_order": same}


def launch_train(registry, variant_path, backend, n_instances, **env):
    """``launch -n 2 train -v <variant>`` through the CLI, in-process, its
    children under ``env``; every process's lines held (exit 0, the
    backend, on the card, shard reads that partition the rows, equal
    losses and replica digests), then the ``n_instances``-th COMPLETED
    instance and its model blob. Returns the processes' records, the
    launch wall and the persisted model."""
    from incubator_predictionio_tpu_torch.utils.serialization import (
        deserialize_model,
    )

    tag = f"rec-launch {backend}"
    s0 = time.perf_counter()
    with env_vars(PYTHONPATH=str(Path(__file__).resolve().parent), **env):
        out = cli_run(tag, [
            "launch", "-n", str(LAUNCH_PROCS), "--timeout",
            str(LAUNCH_TIMEOUT_S), "train", "-v", variant_path])
    wall = time.perf_counter() - s0
    OUT.parent.mkdir(parents=True, exist_ok=True)
    (OUT.parent / f"rec_launch_{backend}.log").write_text(out)
    procs = launch_sections(out, tag=tag)
    per = []
    for p in procs:
        d, r, f = p["dist"], p["read"], p["fit"]
        check(d[2] == backend == f[2],
              f"[{tag}] process {p['process']} runs backend {d[2]}")
        check(d[3].startswith("cuda") and f[3].startswith("cuda"),
              f"[{tag}] process {p['process']} ran on {d[3]}")
        per.append({"process": p["process"], "device": d[3],
                    "local_rows": int(r[0]), "global_rows": int(r[1]),
                    "local_users": int(r[4]), "read_s": float(r[7]),
                    "steps": int(f[4]), "local_batch": int(f[5]),
                    "stage_s": float(f[6]), "train_s": float(f[7]),
                    "exchange_ms_per_step": float(f[8]),
                    "loss": float(f[9]), "digest": f[10]})
    total = per[0]["global_rows"]
    check(all(q["global_rows"] == total for q in per)
          and sum(q["local_rows"] for q in per) == total
          and all(0 < q["local_rows"] < total for q in per),
          f"[{tag}] shard reads {per}")
    check(len({q["digest"] for q in per}) == 1,
          f"[{tag}] replica digests differ: {per}")
    check(len({q["loss"] for q in per}) == 1, f"[{tag}] losses {per}")
    storage = registry.get_storage()
    insts = sorted(storage.get_meta_data_engine_instances().get_all(),
                   key=lambda i: i.start_time)
    check([i.status for i in insts] == ["COMPLETED"] * n_instances,
          f"[{tag}] instances {[(i.id, i.status) for i in insts]}")
    blob = storage.get_model_data_models().get(insts[-1].id)
    check(blob is not None, f"[{tag}] no model blob")
    model = deserialize_model(blob.models)[0]
    check(not model.mf.device_resident and model.mf.user_emb.shape ==
          (len(model.user_map), LAUNCH_RANK),
          f"[{tag}] the persisted model: {model.mf.user_emb.shape}")
    return {"processes": per, "wall_s": wall, "model": model}


def launch_arrays():
    """rec-launch's rate events as arrays: users, items (the first
    ``LAUNCH_ITEMS`` naming every item once), ratings, from
    ``default_rng(23)``."""
    rng = np.random.default_rng(23)
    users = rng.integers(0, LAUNCH_USERS, LAUNCH_EVENTS)
    items = np.concatenate([rng.permutation(LAUNCH_ITEMS), rng.integers(
        0, LAUNCH_ITEMS, LAUNCH_EVENTS - LAUNCH_ITEMS)])
    ratings = (1.0 + 4.0 * rng.random(LAUNCH_EVENTS)).astype(np.float32)
    return users, items, ratings


def rec_launch_phase(R, ctx, tmp):
    """``launch -n 2 train -v engine.json`` on the card through the CLI:
    ``app new`` and ``import`` of 400,000 rate events into one sqlite file,
    two processes sharing one card (gloo by the backend rule) that each
    read their entity shard, stage their batches and run the data-parallel
    fit; process 0 alone writes the instance and the model. Where the
    machine has two cards, a second launch with a card each (NCCL), whose
    tables must equal the first's bitwise. Held: the shard reads, one
    COMPLETED instance and one blob, equal replica digests, the replay;
    then the model deployed through K1 (exact) and K2 (two-stage).
    Returns (launches, record)."""
    import datetime as dt

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "rec-launch")
    users, items, ratings = launch_arrays()
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    dicts = ({"event": "rate", "entityType": "user", "entityId": f"u{u}",
              "targetEntityType": "item", "targetEntityId": f"i{i}",
              "properties": {"rating": float(r)},
              "eventTime": (t0 + dt.timedelta(seconds=j)).isoformat()}
             for j, (u, i, r) in enumerate(zip(users.tolist(), items.tolist(),
                                               ratings.tolist())))
    rec = {"users": LAUNCH_USERS, "items": LAUNCH_ITEMS, "rank": LAUNCH_RANK,
           "events": LAUNCH_EVENTS, "batch": LAUNCH_BATCH,
           "epochs": LAUNCH_EPOCHS, "processes": LAUNCH_PROCS,
           "card_count": torch.cuda.device_count()}
    with cli_storage(root) as registry:
        _, rec["import"] = cli_app_import("rec-launch", root, "launch", dicts)
        variant_path = write_variant(
            os.path.join(root, "engine.json"), FACTORY, "launch",
            [{"name": "als", "params": {
                "rank": LAUNCH_RANK, "numIterations": LAUNCH_EPOCHS,
                "batchSize": LAUNCH_BATCH}}])
        # one card: the processes share it (gloo through the host), also
        # where the machine has more
        first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        launched = launch_train(registry, variant_path, "gloo", 1,
                                CUDA_VISIBLE_DEVICES=first)
        per, model = launched["processes"], launched["model"]
        mf = model.mf
        total = per[0]["global_rows"]
        train_wall = max(q["train_s"] for q in per)
        rec.update({
            "launch_wall_s": launched["wall_s"], "backend": "gloo",
            "processes_record": per,
            "train_events_per_sec": total * LAUNCH_EPOCHS / train_wall,
            "final_loss": mf.final_loss, "timings": mf.timings})
        if torch.cuda.device_count() >= LAUNCH_PROCS:
            # a card each: NCCL, the same fit over another transport
            nccl = launch_train(registry, variant_path, "nccl", 2)
            diff = max(float(np.abs(getattr(nccl["model"].mf, n)
                                    - getattr(mf, n)).max())
                       for n in ("user_emb", "item_emb", "user_bias", "item_bias"))
            check(diff == 0.0, f"[rec-launch] the NCCL launch's tables differ "
                  f"from the gloo launch's by {diff}")
            rec["nccl_launch"] = {k: v for k, v in nccl.items() if k != "model"}
            rec["nccl_launch"]["max_abs_diff_vs_gloo"] = diff
            model, mf = nccl["model"], nccl["model"].mf

        # the replay: both shards in this process, the single-process loop
        replay, meta = launch_replay((users, items, ratings), variant_path, ctx)
        check(list(meta["user_vocab"]) == list(model.user_map.keys())
              and list(meta["item_vocab"]) == list(model.item_map.keys())
              and meta["mean"] == mf.mean,
              "[rec-launch] the replay's vocabularies or mean differ")
        got = {"ue": (mf.user_emb, mf.user_bias), "ie": (mf.item_emb, mf.item_bias)}
        diffs = []
        for t, key in zip(replay["tables"], ("ue", "ie")):
            emb, bias = got[key]
            want = np.concatenate([emb, bias[:, None]], 1)
            diffs.append(float(np.abs(t[:len(emb)] - want).max()))
        rep = {"max_abs_diff": max(diffs), "loss": replay["loss"],
               "train_s": replay["train_s"]}
        rec["replay"] = {**rep, "read_s": meta["read_s"], "steps": meta["steps"]}
        check(rep["max_abs_diff"] <= LAUNCH_REPLAY_TOL,
              f"[rec-launch] the replay differs from the launched model by "
              f"{rep['max_abs_diff']} > {LAUNCH_REPLAY_TOL}")
        del replay
        rec["nccl_1"] = nccl_collectives_check(ctx)

        # deploy the primary's model: exact (K1) and two-stage (K2)
        storage = registry.get_storage()
        pick = np.random.default_rng(21).choice(len(model.user_map), 64,
                                                replace=False)
        vocab = list(model.user_map.keys())
        user_ids = [vocab[int(i)] for i in pick]
        lat, answers = {}, {}
        R.reset_launches()
        with retrieval_mode("exact"):
            rec["exact"] = asyncio.run(serve_phase(
                "rec-launch-exact", variant_path, storage, ctx,
                lambda s, u, srv: rec_launch_body(model, user_ids, s, u, srv,
                                                  lat, answers,
                                                  "rec-launch-exact")))
        gc.collect()
        torch.cuda.empty_cache()
        with retrieval_mode("auto"):
            rec["two_stage"] = asyncio.run(serve_phase(
                "rec-launch-two-stage", variant_path, storage, ctx,
                lambda s, u, srv: rec_launch_body(model, user_ids, s, u, srv,
                                                  lat, answers,
                                                  "rec-launch-two-stage")))
        launches = {"score_catalog_quantized": R.score_catalog_quantized.launches,
                    "score_centroids_quantized": R.score_centroids_quantized.launches}
    for name, count in launches.items():
        check(count > 0, f"[rec-launch] {name} never launched serving the "
              "launched model")
    hits = sum(len(set(a) & set(b)) for a, b in zip(
        answers["rec-launch-exact"], answers["rec-launch-two-stage"]))
    rec["two_stage"]["recall_at_10"] = hits / (10 * len(user_ids))
    rec["latency"] = {k: {"n": len(v), "p50_ms": pct(v, 50), "p99_ms": pct(v, 99)}
                      for k, v in lat.items()}
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    # rec-batchpredict scores this model from the same store
    rec["persisted"] = {"root": root, "variant_path": variant_path,
                        "model": model}
    smi = smi_name_power()
    log(f"[rec-launch] ({smi}) import {LAUNCH_EVENTS} events "
        f"{rec['import']['import_s']:.2f} s; launch -n {LAUNCH_PROCS} train: "
        f"wall {rec['launch_wall_s']:.2f} s, backend gloo, the processes "
        f"sharing one card ({rec['card_count']} card(s) visible; NCCL with "
        f"a card each: "
        + (f"wall {rec['nccl_launch']['wall_s']:.2f} s, tables bitwise the "
           "gloo launch's" if "nccl_launch" in rec else "not measured")
        + ")")
    for q in per:
        log(f"[rec-launch] ({smi}) process {q['process']} on {q['device']}: read "
            f"{q['local_rows']} of {q['global_rows']} rows in {q['read_s']:.3f} s, "
            f"stage {q['stage_s']:.3f} s, train {q['train_s']:.3f} s "
            f"({q['steps']} steps of {q['local_batch']} local rows), exchange "
            f"{q['exchange_ms_per_step']:.3f} ms a step; digest {q['digest']}")
    log(f"[rec-launch] ({smi}) train events/s {rec['train_events_per_sec']:.1f} "
        f"({total} global rows x {LAUNCH_EPOCHS} epochs / {train_wall:.3f} s); "
        f"loss {mf.final_loss:.6f}; replica digests equal")
    log(f"[rec-launch] ({smi}) replay of both shards' global batches on the "
        f"card: max abs diff {rep['max_abs_diff']:.3e} (band "
        f"{LAUNCH_REPLAY_TOL}), loss {rep['loss']:.6f}, train "
        f"{rep['train_s']:.3f} s; NCCL 1-process all_gather of "
        f"{rec['nccl_1']['all_gather_bytes']} bytes {rec['nccl_1']['all_gather_ms']:.4f} ms")
    log(f"[rec-launch] ({smi}) burst of 64: exact p50 "
        f"{rec['latency']['rec-launch-exact']['p50_ms']:.2f} ms, two-stage p50 "
        f"{rec['latency']['rec-launch-two-stage']['p50_ms']:.2f} ms (recall@10 "
        f"vs exact {rec['two_stage']['recall_at_10']:.4f}, no floor: tables "
        f"trained on uniform random events; the probed partitions hold "
        f"{rec['two_stage']['probed_catalog_share']:.4f} of the catalog; "
        f"{rec['two_stage']['cpu_two_stage_same_order']} of 16 two-stage "
        f"answers in the CPU two-stage path's order); launches {launches}; phase "
        f"{rec['phase_s']:.1f} s")
    return launches, rec


# -- phase: batch prediction on rec-launch's stored model --------------------

#: rec-batchpredict's input: known users (num 10), unknown users (the cold
#: path: the reference's empty answer), known users with a blackList of
#: BP_BANNED ids (3 of them from the user's CPU top-10), in one file drawn
#: from default_rng(37); batchpredict's default chunk of 1024 pads to the
#: serving bucket 1024 (K1 at B 1024 over the 100,352-row padded catalog)
BP_KNOWN, BP_UNKNOWN, BP_BLACK, BP_BANNED = 4096, 64, 256, 5
#: answers of the one-process run held against the plain CPU int8 path
BP_CPU_USERS = 16


def near_tie_same(tag, got, want, scores, tenth, tol=1e-4):
    """``got`` and ``want`` (item scores of one answer) hold the same ids up
    to near-ties at the last place (an id in one only scores within ``tol``
    of ``want``'s last score, by ``scores``) and the same scores within
    ``tol``; returns whether they are equal as they stand."""
    gi, wi = [x["item"] for x in got], [x["item"] for x in want]
    for iid in set(gi) ^ set(wi):
        check(iid in scores and abs(scores[iid] - tenth) <= tol,
              f"[{tag}] ids differ beyond a near-tie: {gi} vs {wi}")
    for x in got:
        check(x["item"] in scores and abs(x["score"] - scores[x["item"]]) <= tol,
              f"[{tag}] score {x} vs {scores.get(x['item'])}")
    return got == want


@contextlib.contextmanager
def algorithm_clock(algorithm_cls):
    """Host time inside ``algorithm_cls.batch_predict`` (its answers are
    host objects, so the card's work is done when it returns)."""
    rec = {"s": 0.0, "calls": 0, "queries": 0}
    orig = algorithm_cls.__dict__["batch_predict"]

    def timed(self, model, queries):
        t0 = time.perf_counter()
        out = orig(self, model, queries)
        rec["s"] += time.perf_counter() - t0
        rec["calls"] += 1
        rec["queries"] += len(queries)
        return out

    algorithm_cls.batch_predict = timed
    try:
        yield rec
    finally:
        algorithm_cls.batch_predict = orig


BP_LINE = {
    "dist": LAUNCH_LINE["dist"],
    "done": re.compile(r"Batch predict completed: (\d+) predictions written to "
                       r"(\S+) \(slice (\d+)/(\d+)\)"),
}


def rec_batchpredict_phase(R, ctx, persisted):
    """``batchpredict`` on rec-launch's stored model (100,000 × 100,000,
    rank 128, deployed int8 on the card): 4,416 queries, one process
    through the CLI in-process, then ``launch -n 2 batchpredict`` (gloo,
    both processes on the card). K1 is first held against its plain
    version at the new shape, B 1024. Held: the parts concatenated equal
    the one-process output (ids up to near-ties at the 10th place, scores
    within 1e-4; the bitwise lines counted), 16 users' answers equal the
    plain CPU int8 path's, no black-listed id served, unknown users
    answered empty. Returns (launches, record)."""
    from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerMF
    from incubator_predictionio_tpu_torch.templates import recommendation as trec

    t_phase = time.perf_counter()
    root, variant_path, model = (persisted[k] for k in ("root", "variant_path",
                                                        "model"))
    mf, dev = model.mf, ctx.device
    rng = np.random.default_rng(37)
    vocab = list(model.user_map.keys())
    pick = rng.choice(len(vocab), BP_KNOWN + BP_BLACK, replace=False)
    # K1 at B 1024 against its plain version, before the phase relies on it
    k = mf.config.rank
    items_q, scales, bias, mask = R.quantize_catalog_device(
        torch.from_numpy(mf.item_emb).to(dev),
        torch.from_numpy(mf.item_bias).to(dev))
    q = torch.from_numpy(np.ascontiguousarray(mf.user_emb[pick[:1024]])).to(dev)
    k1 = k1_case(R, q, items_q, scales, bias, mask)
    del items_q, scales, bias, mask, q
    # the queries: the black-listed users' bans from their CPU top-10
    cpu = cpu_int8(mf)
    inv = model.item_map.inverse()
    check_rows = pick[:BP_CPU_USERS]
    black_rows = pick[BP_KNOWN:]
    ci, cs = TwoTowerMF.recommend_batch(
        cpu, np.concatenate([check_rows, black_rows]).astype(np.int32), 12)
    cpu_answers = {vocab[int(u)]: (ci[r], cs[r]) for r, u in enumerate(check_rows)}
    queries = [{"user": vocab[int(u)], "num": 10} for u in pick[:BP_KNOWN]]
    for r, u in enumerate(black_rows):
        top = [inv[int(i)] for i in ci[BP_CPU_USERS + r][:10]]
        extra = rng.choice(len(inv), BP_BANNED - 3, replace=False)
        queries.append({"user": vocab[int(u)], "num": 10,
                        "blackList": top[:3] + [inv[int(i)] for i in extra]})
    queries += [{"user": f"cold{j}", "num": 10} for j in range(BP_UNKNOWN)]
    queries = [queries[int(j)] for j in rng.permutation(len(queries))]
    inp = os.path.join(root, "bp-input.json")
    write_events(inp, queries)
    one_out = os.path.join(root, "bp-one.json")
    many_out = os.path.join(root, "bp-launched.json")
    rec = {"queries": len(queries), "known": BP_KNOWN, "unknown": BP_UNKNOWN,
           "black_listed": BP_BLACK, "chunk": 1024, "k1_b1024": k1}
    with cli_storage(root) as registry, retrieval_mode("exact"):
        del registry
        torch.cuda.reset_peak_memory_stats()
        R.reset_launches()
        with algorithm_clock(trec.ALSAlgorithm) as clock:
            t0 = time.perf_counter()
            out = cli_run("rec-batchpredict", [
                "batchpredict", "--input", inp, "--output", one_out,
                "-v", variant_path])
            one_wall = time.perf_counter() - t0
        launches = {"score_catalog_quantized": R.score_catalog_quantized.launches}
        check(f"Batch predict completed: {len(queries)} predictions written "
              f"to {one_out}" in out, f"[rec-batchpredict] {out}")
        rec["one_process"] = {
            "wall_s": one_wall, "queries_per_s": len(queries) / one_wall,
            "batch_predict_s": clock["s"], "batch_predict_calls": clock["calls"],
            "scoring_queries_per_s": len(queries) / clock["s"],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        with env_vars(PYTHONPATH=str(Path(__file__).resolve().parent),
                      CUDA_VISIBLE_DEVICES=first):
            t0 = time.perf_counter()
            out = cli_run("rec-batchpredict launch", [
                "launch", "-n", str(LAUNCH_PROCS), "--timeout",
                str(LAUNCH_TIMEOUT_S), "batchpredict", "--input", inp,
                "--output", many_out, "-v", variant_path])
            many_wall = time.perf_counter() - t0
    OUT.parent.mkdir(parents=True, exist_ok=True)
    (OUT.parent / "rec_batchpredict_launch.log").write_text(out)
    procs = launch_sections(out, BP_LINE, "rec-batchpredict launch")
    parts = []
    for p in procs:
        d, done = p["dist"], p["done"]
        check(d[2] == "gloo" and d[3].startswith("cuda")
              and int(done[2]) == p["process"] + 1,
              f"[rec-batchpredict launch] process {p['process']}: {d} {done}")
        with open(done[1]) as f:
            part = f.read().splitlines()
        check(len(part) == int(done[0]), f"[rec-batchpredict launch] part "
              f"{done[1]}: {len(part)} lines, {done[0]} written")
        parts += part
    rec["launched"] = {"wall_s": many_wall,
                       "queries_per_s": len(queries) / many_wall,
                       "slices": [int(p["done"][0]) for p in procs]}
    with open(one_out) as f:
        one = f.read().splitlines()
    check(len(one) == len(parts) == len(queries),
          f"[rec-batchpredict] {len(one)} lines, {len(parts)} in the parts, "
          f"{len(queries)} queries")
    bitwise, cpu_same = 0, 0
    for q, a, b in zip(queries, one, parts):
        got, want = json.loads(b)["itemScores"], json.loads(a)["itemScores"]
        if q["user"].startswith("cold"):
            check(got == want == [], f"[rec-batchpredict] cold user {q}: {a}")
            bitwise += a == b
            continue
        check(len(want) == 10 and all(np.isfinite(x["score"]) for x in want),
              f"[rec-batchpredict] answer {a} to {q}")
        banned = set(q.get("blackList", ()))
        check(not banned & ({x["item"] for x in want} | {x["item"] for x in got}),
              f"[rec-batchpredict] a black-listed id served to {q}")
        scores = {x["item"]: x["score"] for x in want + got}
        near_tie_same("rec-batchpredict parts", got, want, scores,
                      want[-1]["score"])
        bitwise += a == b
        if q["user"] in cpu_answers:
            idx, sc = cpu_answers[q["user"]]
            ref = [{"item": inv[int(i)], "score": float(v)} for i, v in zip(idx, sc)]
            cpu_same += near_tie_same(
                "rec-batchpredict vs CPU", want, ref[:10],
                {x["item"]: x["score"] for x in ref}, ref[9]["score"])
    check(launches["score_catalog_quantized"] > 0,
          "[rec-batchpredict] K1 never launched in the one-process run")
    rec.update({"lines_bitwise": bitwise, "cpu_checked": len(cpu_answers),
                "cpu_same_order": cpu_same, "launches": launches,
                "phase_s": time.perf_counter() - t_phase})
    smi = smi_name_power()
    o, m = rec["one_process"], rec["launched"]
    log(f"[rec-batchpredict] ({smi}) {len(queries)} queries ({BP_KNOWN} known, "
        f"{BP_BLACK} black-listed, {BP_UNKNOWN} unknown), chunks of 1024: one "
        f"process {o['wall_s']:.2f} s wall, {o['queries_per_s']:.1f} queries/s "
        f"(batch_predict {o['batch_predict_s']:.3f} s in {o['batch_predict_calls']} "
        f"calls, {o['scoring_queries_per_s']:.1f} queries/s; peak device memory "
        f"{o['max_memory_allocated_bytes'] / 2**30:.3f} GiB); launch -n 2 "
        f"{m['wall_s']:.2f} s wall, {m['queries_per_s']:.1f} queries/s, slices "
        f"{m['slices']}")
    log(f"[rec-batchpredict] ({smi}) the parts concatenated equal the "
        f"one-process output, {bitwise} of {len(queries)} lines bitwise; "
        f"{cpu_same} of {len(cpu_answers)} checked answers in the CPU int8 "
        f"path's order; no black-listed id served; K1 at B 1024 N {k1['N']} "
        f"D {k1['D']}: device {fmt(k1['device_ms'])} ms, bound "
        f"{k1['bound_ms']:.4f} ms ({k1['bound_by']}), torch.matmul "
        f"{k1['library_ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms; launches "
        f"{launches}; phase {rec['phase_s']:.1f} s")
    return launches, rec


# -- phase: fault-tolerant multi-process training (rec-supervised) -----------

#: rec-supervised: rec-launch's store and widths (100,000 x 100,000, rank
#: 128, 400,000 events, batch 65,536), 3 epochs, a slice checkpoint after
#: each (the reference's chaos test's variant, tests/test_chaos_procs.py:
#: 2191-2201, and bench.py:3532 bench_distributed_training)
SUP_EPOCHS = 3  # cut from 10 for the script's time (PERF.md §4)
SUP_KILL_AFTER = 2   # SIGKILL the highest live rank once this step commits
SUP_HEARTBEAT_MS = 2000
SUP_TIMEOUT_S = 600
SUP_MTTR_LIMIT_S = 60.0
SUP_SERVE_USERS = 16
SUP_LINE = {
    "resume": re.compile(r"resuming from epoch (\d+) \(of (\d+)\)"),
    "slice": re.compile(r"dist checkpoint: member (\d+) step (\d+): slice of "
                        r"(\d+) bytes written in ([\d.]+) ms, commit ([\d.]+) ms"),
    "read": LAUNCH_LINE["read"],
    "fit": LAUNCH_LINE["fit"],
    "dist": LAUNCH_LINE["dist"],
    "gap": re.compile(r"dist member \d+: lease renewed at most ([\d.]+) ms"),
}


def supervised_run(tag, variant_path, state_dir, ckpt_dir, env, kill,
                   cpu_devices_per_process=None) -> dict:
    """``train -v <variant> --distributed`` as 2 members under a
    ``Supervisor``; with ``kill``, the highest live rank is SIGKILLed from
    this process once ``SUP_KILL_AFTER`` epochs are committed. Returns the
    result and the members' parsed log lines, held: the run ok, its
    recoveries, every member's backend, its slices' steps."""
    import signal
    import threading

    from incubator_predictionio_tpu_torch.distributed.supervisor import Supervisor
    from incubator_predictionio_tpu_torch.utils import checkpoint as ckpt_fs

    sup = Supervisor(["train", "-v", variant_path, "--distributed"],
                     LAUNCH_PROCS, state_dir, heartbeat_ms=SUP_HEARTBEAT_MS,
                     max_recoveries=2, env=env, timeout=SUP_TIMEOUT_S,
                     cpu_devices_per_process=cpu_devices_per_process)
    box, killed = {}, None
    t0 = time.perf_counter()
    runner = threading.Thread(target=lambda: box.update(res=sup.run()))
    runner.start()
    while kill and runner.is_alive():
        steps = ckpt_fs.committed_steps(ckpt_dir)
        alive = sup.alive_pids()
        if steps and steps[-1] >= SUP_KILL_AFTER and len(alive) == LAUNCH_PROCS:
            rank, pid = sorted(alive.items())[-1]
            os.kill(pid, signal.SIGKILL)
            killed = {"rank": rank, "pid": pid, "committed": steps[-1],
                      "at_s": time.perf_counter() - t0}
            break
        time.sleep(0.02)
    runner.join(SUP_TIMEOUT_S + 60)
    wall = time.perf_counter() - t0
    check(not runner.is_alive(), f"[{tag}] the supervised run wedged")
    res = box["res"]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    (OUT.parent / f"rec_supervised_{tag}.log").write_text(res.logs_text())
    check(res.ok, f"[{tag}] not ok ({res.detail}, rcs {res.returncodes}):\n"
          f"{res.logs_text()[-4000:]}")
    check(not kill or killed is not None,
          f"[{tag}] the run ended before {SUP_KILL_AFTER} epochs committed")
    check(res.recoveries == (1 if kill else 0) and
          res.generation == (2 if kill else 1),
          f"[{tag}] recoveries {res.recoveries}, generation {res.generation}")
    gen = res.generation
    members = {}
    for rank in range(LAUNCH_PROCS):
        path = os.path.join(state_dir, "logs", f"member-{rank}.gen-{gen}.log")
        text = Path(path).read_text(errors="replace")
        rec = {k: rx.findall(text) for k, rx in SUP_LINE.items()}
        check(len(rec["fit"]) == 1 and len(rec["read"]) == 1,
              f"[{tag}] member {rank} of generation {gen}: {len(rec['fit'])} "
              f"fit lines:\n{text[-4000:]}")
        check(("Training completed. Engine instance ID" in text) == (rank == 0)
              and ("secondary process" in text) == (rank != 0),
              f"[{tag}] member {rank}'s role:\n{text[-2000:]}")
        rec["iid"] = (text.split("Engine instance ID: ")[-1].split()[0]
                      if rank == 0 else None)
        members[rank] = rec
    return {"res": res, "wall_s": wall, "killed": killed, "members": members}


def supervised_record(tag, run, resumed) -> dict:
    """The numbers a supervised run prints: wall, MTTR, the resume epoch,
    member 0's slice write and commit ms a step, the bytes a step writes,
    train events/s of the last generation."""
    m0 = run["members"][0]
    slices = [(int(s), int(b), float(w), float(c))
              for m, s, b, w, c in m0["slice"] if m == "0"]
    read, fit = m0["read"][0], m0["fit"][0]
    epochs_run = SUP_EPOCHS - resumed
    train_s = float(fit[7])
    return {"wall_s": run["wall_s"], "mttr_s": run["res"].mttr_s,
            "recoveries": run["res"].recoveries,
            "generation": run["res"].generation, "killed": run["killed"],
            "resumed_epoch": resumed, "backend": fit[2],
            "slice_write_ms": [w for _, _, w, _ in slices],
            "commit_ms": [c for _, _, _, c in slices],
            "step_bytes": sorted({b for _, b, _, _ in slices}),
            "global_rows": int(read[1]), "train_s": train_s,
            "steps": int(fit[4]), "exchange_ms_per_step": float(fit[8]),
            "train_events_per_sec": int(read[1]) * epochs_run / train_s,
            "iid": m0["iid"],
            "lease_gap_ms": [float(m["gap"][0]) if m["gap"] else None
                             for _, m in sorted(run["members"].items())]}


def rec_supervised_phase(R, ctx, tmp, cpu_devices_per_process=None):
    """Fault-tolerant training on rec-launch's store: a control run of 2
    supervised members over gloo on one card, then a chaos run with a new
    checkpoint directory whose highest rank is SIGKILLed once 2 epochs are
    committed: one recovery, generation 2, an MTTR under a minute, a
    resume from a committed epoch ≥ 2, the last step's leaves bitwise the
    control's, one COMPLETED instance and one blob by the primary, a
    zombie of generation 1 fenced; ``dist status`` on its mesh; both
    models deployed through K1, the answers of 16 users equal. With two
    cards, a chaos run on NCCL (a card each), its leaves bitwise the gloo
    control's. Returns (launches, record)."""
    from incubator_predictionio_tpu_torch.distributed.checkpoint import (
        DistSliceCheckpointer,
    )
    from incubator_predictionio_tpu_torch.distributed.errors import (
        FencedGenerationError,
    )
    from incubator_predictionio_tpu_torch.distributed.meshdir import MeshDirectory
    from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerMF
    from incubator_predictionio_tpu_torch.tools import cli
    from incubator_predictionio_tpu_torch.utils import checkpoint as ckpt_fs
    from incubator_predictionio_tpu_torch.utils.serialization import (
        deserialize_model,
    )

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "rec-launch")  # rec-launch's store
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    gloo_env = {"PYTHONPATH": str(Path(__file__).resolve().parent),
                "CUDA_VISIBLE_DEVICES": first}
    rec = {"epochs": SUP_EPOCHS, "heartbeat_ms": SUP_HEARTBEAT_MS,
           "processes": LAUNCH_PROCS, "card_count": torch.cuda.device_count()}
    runs, leaves, models = {}, {}, {}
    with cli_storage(root) as registry:
        storage = registry.get_storage()
        instances = storage.get_meta_data_engine_instances()

        def one(tag, kill, env):
            ck_dir = os.path.join(root, f"ck-{tag}")
            state_dir = os.path.join(root, f"mesh-{tag}")
            variant = write_variant(
                os.path.join(root, f"sup-{tag}.json"), FACTORY, "launch",
                [{"name": "als", "params": {
                    "rank": LAUNCH_RANK, "numIterations": SUP_EPOCHS,
                    "batchSize": LAUNCH_BATCH, "checkpointDir": ck_dir,
                    "checkpointEvery": 1}}])
            before = {i.id for i in instances.get_all()}
            run = supervised_run(tag, variant, state_dir, ck_dir, env, kill,
                                 cpu_devices_per_process)
            new = [i for i in instances.get_all() if i.id not in before]
            done = [i for i in new if i.status == "COMPLETED"]
            blobs = [i.id for i in new
                     if storage.get_model_data_models().get(i.id) is not None]
            check(len(done) == 1 and done[0].id == run["members"][0]["iid"]
                  and blobs == [done[0].id],
                  f"[rec-supervised {tag}] new instances "
                  f"{[(i.id, i.status) for i in new]}, blobs {blobs}")
            blob = storage.get_model_data_models().get(done[0].id)
            resumed = [int(e) for m in run["members"].values()
                       for e, _ in m["resume"]]
            if kill:
                check(len(resumed) == LAUNCH_PROCS and len(set(resumed)) == 1
                      and resumed[0] >= SUP_KILL_AFTER,
                      f"[rec-supervised {tag}] resume epochs {resumed}")
                check(len(run["res"].mttr_s) == 1
                      and 0.0 <= run["res"].mttr_s[0] < SUP_MTTR_LIMIT_S,
                      f"[rec-supervised {tag}] MTTR {run['res'].mttr_s}")
            else:
                check(resumed == [], f"[rec-supervised {tag}] resumed {resumed}")
            steps = ckpt_fs.committed_steps(ck_dir)
            check(steps and steps[-1] == SUP_EPOCHS,
                  f"[rec-supervised {tag}] committed steps {steps}")
            manifests = [ckpt_fs.read_member_slice(ck_dir, SUP_EPOCHS, m)
                         for m in range(LAUNCH_PROCS)]
            check(all(m is not None for m in manifests)
                  and len(manifests[0][0]["entries"]) == 8
                  and all(m[0]["entries"] == [] for m in manifests[1:]),
                  f"[rec-supervised {tag}] step {SUP_EPOCHS}'s manifests")
            leaves[tag] = ckpt_fs.assemble_committed_step(ck_dir, SUP_EPOCHS)
            models[tag] = deserialize_model(blob.models)[0]
            runs[tag] = {"run": run, "state_dir": state_dir, "ck_dir": ck_dir,
                         "resumed": resumed[0] if resumed else 0}
            rec[tag] = supervised_record(tag, run, runs[tag]["resumed"])
            rec[tag]["instances"] = [(i.id, i.status) for i in new]

        one("control", False, gloo_env)
        one("chaos", True, gloo_env)
        if torch.cuda.device_count() >= LAUNCH_PROCS \
                and cpu_devices_per_process is None:
            one("chaos_nccl", True, {
                k: v for k, v in gloo_env.items() if k != "CUDA_VISIBLE_DEVICES"})
            check(rec["chaos_nccl"]["backend"] == "nccl",
                  f"[rec-supervised] the NCCL run's backend "
                  f"{rec['chaos_nccl']['backend']}")
        check(rec["control"]["backend"] == rec["chaos"]["backend"] == "gloo",
              f"[rec-supervised] backends {rec['control']['backend']}, "
              f"{rec['chaos']['backend']}")
        for tag in [t for t in leaves if t != "control"]:
            same = len(leaves[tag]) == len(leaves["control"]) == 8 and all(
                a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes()
                for a, b in zip(leaves[tag], leaves["control"]))
            rec[tag]["bitwise_control"] = same
            check(same, f"[rec-supervised] {tag}'s step-{SUP_EPOCHS} leaves "
                  "differ from the control's")
        rec["step_leaves"] = [[list(a.shape), a.dtype.str]
                              for a in leaves["control"]]
        del leaves

        # a zombie of generation 1 cannot touch the chaos run's checkpoints
        md = MeshDirectory(runs["chaos"]["state_dir"])
        zombie = DistSliceCheckpointer(
            runs["chaos"]["ck_dir"], members=LAUNCH_PROCS, member=0,
            generation=1, meshdir=md, slice_fn=lambda i, leaf, m, n: [(leaf, None)])
        try:
            zombie.save(SUP_EPOCHS + 1, {"w": torch.zeros(2)})
            fenced = False
        except FencedGenerationError:
            fenced = True
        check(fenced, "[rec-supervised] a generation-1 zombie saved a slice")
        check(ckpt_fs.committed_steps(runs["chaos"]["ck_dir"])[-1] == SUP_EPOCHS,
              "[rec-supervised] the zombie moved the commits")
        rec["zombie_fenced"] = fenced

        # dist status on the chaos mesh (degraded once the run has ended:
        # every member dropped its lease)
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["dist", "status", "--state-dir",
                           runs["chaos"]["state_dir"], "--json"])
        snap = json.loads(buf.getvalue())
        check(snap["generation"] == 2 and snap["lastCommit"]["step"] == SUP_EPOCHS
              and snap["lastCommit"]["generation"] == 2,
              f"[rec-supervised] dist status {snap}")
        rec["dist_status"] = {"rc": rc, **{k: snap[k] for k in (
            "generation", "expectedMembers", "aliveMembers", "degraded",
            "lastCommit")}}

        # the recovered model and the control's through K1 (int8, D 128)
        R.reset_launches()
        answers = {}
        with retrieval_mode("exact"):
            for tag in ("control", "chaos"):
                model = models[tag].prepare_for_serving(ctx)
                info = model.mf.serving_info()
                check(info["path"] == "device-int8"
                      and info["device"].startswith(ctx.device.type),
                      f"[rec-supervised] {tag} serves {info}")
                vocab = list(model.user_map.keys())
                pick = np.random.default_rng(41).choice(
                    len(vocab), SUP_SERVE_USERS, replace=False)
                idx, scores = TwoTowerMF.recommend_batch(
                    model.mf, np.asarray(pick, np.int32), 10)
                check(bool(np.isfinite(scores).all()),
                      f"[rec-supervised] {tag}: non-finite scores")
                answers[tag] = (idx.tolist(), scores.tolist())
        launches = {"score_catalog_quantized": R.score_catalog_quantized.launches}
        check(launches["score_catalog_quantized"] > 0,
              "[rec-supervised] K1 never launched serving the recovered model")
        check(answers["chaos"] == answers["control"],
              "[rec-supervised] the recovered model's K1 answers differ from "
              "the control's")
        del models
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    smi = smi_name_power()
    for tag in [t for t in ("control", "chaos", "chaos_nccl") if t in rec]:
        r = rec[tag]
        w, c = r["slice_write_ms"], r["commit_ms"]
        log(f"[rec-supervised] ({smi}) {tag}: wall {r['wall_s']:.2f} s, "
            f"backend {r['backend']}, generation {r['generation']}, "
            f"recoveries {r['recoveries']}, MTTR "
            f"{[round(x, 3) for x in r['mttr_s']]} s, killed {r['killed']}, "
            f"resumed from epoch {r['resumed_epoch']}; member 0's slice of "
            f"{r['step_bytes']} bytes a step: write median "
            f"{statistics.median(w):.1f} ms (max {max(w):.1f}), commit median "
            f"{statistics.median(c):.1f} ms (max {max(c):.1f}) over {len(w)} "
            f"steps of the last generation; train {r['train_s']:.3f} s for "
            f"{SUP_EPOCHS - r['resumed_epoch']} epochs ({r['steps']} steps, "
            f"exchange {r['exchange_ms_per_step']:.3f} ms a step): "
            f"{r['train_events_per_sec']:.1f} train events/s; the members' "
            f"leases renewed at most {r['lease_gap_ms']} ms apart (expiry "
            f"{SUP_HEARTBEAT_MS} ms)"
            + (f"; step-{SUP_EPOCHS} leaves bitwise the control's"
               if r.get("bitwise_control") else ""))
    log(f"[rec-supervised] ({smi}) zombie of generation 1 fenced; dist status: "
        f"generation {rec['dist_status']['generation']}, last commit "
        f"{rec['dist_status']['lastCommit']['step']}, rc "
        f"{rec['dist_status']['rc']}; {SUP_SERVE_USERS} users' K1 answers of "
        f"the recovered model equal the control's; launches {launches}; "
        f"phase {rec['phase_s']:.1f} s")
    return launches, rec


# -- phase: launch -n 2 eval of the recommendation template ------------------

# -- phase: the model mesh axis, on rec-launch's store -----------------------

#: rec-model's mesh: two processes on one model line, each holding half of
#: each table and of both adam moments
MODEL_AXES = '{"model": 2}'
REC_MODEL_USERS = 16  # the deployed model's answers held against the replay's
REC_MODEL_LINE = {
    "dist": LAUNCH_LINE["dist"],
    "fit": re.compile(
        r"model-axis fit: process (\d+) of (\d+) at (\{.*?\}) \(backend "
        r"(\w+), (\S+)\): blocks ue rows \[(\d+), (\d+)\) of (\d+), ie rows "
        r"\[(\d+), (\d+)\) of (\d+); (\d+) steps of (\d+) local rows; stage "
        r"([\d.]+) s, train ([\d.]+) s, exchange rows ([\d.]+) ms a step "
        r"\((\d+) bytes\), gradients ([\d.]+) ms a step \((\d+) bytes\); loss "
        r"(\S+); block digest (\w+), equal on its data line; table digest "
        r"(\w+); peak device memory (\d+) bytes"),
}


def rec_model_train(registry, variant_path, backend, **env):
    """``launch -n 2 train -v <variant> --mesh-axes '{"model": 2}'``
    through the CLI, in-process, its children under ``env``; every
    process's lines held (exit 0, the backend, on the card, its block the
    half of each padded table its model coordinate owns, equal losses and
    table digests), then the one new COMPLETED instance and its model.
    Returns the processes' records, the launch wall and the model."""
    from incubator_predictionio_tpu_torch.utils.serialization import (
        deserialize_model,
    )

    tag = f"rec-model {backend}"
    insts = registry.get_storage().get_meta_data_engine_instances()
    before = {i.id for i in insts.get_all()}
    with env_vars(PYTHONPATH=str(Path(__file__).resolve().parent), **env):
        t0 = time.perf_counter()
        out = cli_run(tag, ["launch", "-n", str(LAUNCH_PROCS), "--timeout",
                            str(LAUNCH_TIMEOUT_S), "train", "-v", variant_path,
                            "--mesh-axes", MODEL_AXES])
        wall = time.perf_counter() - t0
    OUT.parent.mkdir(parents=True, exist_ok=True)
    (OUT.parent / f"rec_model_{backend}.log").write_text(out)
    per = []
    for p in launch_sections(out, REC_MODEL_LINE, tag):
        d, f = p["dist"], p["fit"]
        s = p["process"]
        check(d[2] == backend == f[3] and d[3].startswith("cuda")
              and f[4].startswith("cuda"), f"[{tag}] process {s}: {d} {f[:5]}")
        bounds = [(int(f[5]), int(f[6]), int(f[7])), (int(f[8]), int(f[9]), int(f[10]))]
        for lo, hi, rows in bounds:
            check(rows % LAUNCH_PROCS == 0 and (lo, hi) == (
                s * rows // LAUNCH_PROCS, (s + 1) * rows // LAUNCH_PROCS),
                f"[{tag}] process {s} holds rows [{lo}, {hi}) of {rows}")
        per.append({"process": s, "device": d[3], "coords": json.loads(f[2]),
                    "ue_rows": bounds[0], "ie_rows": bounds[1],
                    "steps": int(f[11]), "local_batch": int(f[12]),
                    "stage_s": float(f[13]), "train_s": float(f[14]),
                    "exchange_rows_ms_per_step": float(f[15]),
                    "exchange_rows_bytes": int(f[16]),
                    "exchange_grads_ms_per_step": float(f[17]),
                    "exchange_grads_bytes": int(f[18]), "loss": float(f[19]),
                    "block_digest": f[20], "table_digest": f[21],
                    "peak_bytes": int(f[22])})
    check(len({q["table_digest"] for q in per}) == 1
          and len({q["loss"] for q in per}) == 1
          and len({q["block_digest"] for q in per}) == LAUNCH_PROCS,
          f"[{tag}] digests or losses: {per}")
    new = [i for i in insts.get_all() if i.id not in before]
    check([i.status for i in new] == ["COMPLETED"]
          and new[0].mesh_conf == {"axes": json.loads(MODEL_AXES),
                                   "distributed": True},
          f"[{tag}] new instances {[(i.id, i.status, i.mesh_conf) for i in new]}")
    blob = registry.get_storage().get_model_data_models().get(new[0].id)
    check(blob is not None, f"[{tag}] no model blob")
    return {"processes": per, "wall_s": wall,
            "model": deserialize_model(blob.models)[0]}


def rec_model_replay(arrays, variant_path, ctx):
    """The one-process replay: the store's triples (from the generated
    arrays, :func:`shard_triples` with one shard), the one-process staging
    (what the launched processes stage: the mesh has no data shards), the
    initial tables the two blocks concatenated
    (``sharding/table.py:init_block`` of each shard), and the
    single-process loop on the card. Returns its tables, loss, train
    seconds, vocabularies and mean."""
    from incubator_predictionio_tpu_torch.core.controller import (
        resolve_engine_factory,
        variant_from_file,
    )
    from incubator_predictionio_tpu_torch.models import two_tower as tt
    from incubator_predictionio_tpu_torch.sharding.table import (
        ShardSpec,
        init_block,
    )
    from incubator_predictionio_tpu_torch.utils.optim import adam_tree_init

    variant = variant_from_file(variant_path)
    engine = resolve_engine_factory(variant["engineFactory"])()
    ds, _, (algo,), _ = engine._instantiate(engine.engine_params_from_variant(variant))
    (reads,) = shard_triples(*(a.tolist() for a in arrays), 1)
    ds._store = type("Store", (), {"assemble_triples": lambda self, *a, **k: reads})()
    td = ds.read_training(ctx)
    a = algo.params
    cfg = tt.TwoTowerConfig(rank=a.rank, learning_rate=a.learning_rate,
                            reg=a.lambda_, epochs=a.num_iterations,
                            batch_size=a.batch_size, seed=a.seed or 0)
    *batches, mean = tt._stage_batches(cfg, td.user_idx, td.item_idx, td.ratings)
    dev = ctx.device
    batches = [torch.from_numpy(b).to(dev) for b in batches]
    n_shards = json.loads(MODEL_AXES)["model"]
    scale = float(1.0 / np.sqrt(cfg.rank))
    tables = [torch.cat([init_block(ShardSpec(name, n, cfg.rank + 1, n_shards),
                                    s, cfg.rank, cfg.seed, scale, dev)
                         for s in range(n_shards)])
              for name, n in (("ue", len(td.user_vocab)),
                              ("ie", len(td.item_vocab)))]
    state = adam_tree_init(tables, cfg.adam_moments_dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(tt._train_epochs(tables, [torch.empty_like(t) for t in tables],
                                  state, *batches, cfg.learning_rate, cfg.reg,
                                  cfg.epochs))
    out = {"tables": [t.cpu().numpy() for t in tables], "loss": loss,
           "train_s": time.perf_counter() - t0, "mean": mean,
           "user_vocab": td.user_vocab, "item_vocab": td.item_vocab,
           "config": cfg, "steps": cfg.epochs * int(batches[0].shape[0])}
    del tables, state, batches
    return out


async def rec_model_body(R, model, replay_mf, user_ids, session, url, server):
    """``REC_MODEL_USERS`` users, one request at a time, through the
    QueryServer's exact int8 path (K1 on the card), K1's count read as
    soon as the last answer is in (the deployed model's launches alone);
    then each answer, ids and scores, held equal to the replay model's
    through the same path in this process, one user a call (the same
    serving bucket, so the same K1 kernel)."""
    from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerMF

    info = server.deployed.models[0].serving_info()
    check(info["path"] == "device-int8" and info["device"].startswith("cuda"),
          f"[rec-model] not the int8 path on the card: {info}")
    bodies, lat = await post_all(session, url,
                                 [{"user": u, "num": 10} for u in user_ids], False)
    served = R.score_catalog_quantized.launches
    inv = model.item_map.inverse()
    same = 0
    for u, body in zip(user_ids, bodies):
        ids, scores = TwoTowerMF.recommend_batch(
            replay_mf, np.asarray([model.user_map[u]], np.int32), 10)
        got = [(x["item"], x["score"]) for x in body["itemScores"]]
        want = [(inv[int(i)], float(v)) for i, v in zip(ids[0], scores[0])]
        same += got == want
    check(same == len(user_ids), f"[rec-model] {same} of {len(user_ids)} "
          "answers equal to the replay model's")
    return {"serving_info": info, "same_answers": same,
            "p50_ms": pct(lat, 50), "served_launches": served,
            "replay_launches": R.score_catalog_quantized.launches - served}


def rec_model_phase(R, ctx, tmp):
    """``launch -n 2 train --mesh-axes '{"model": 2}'`` on rec-launch's
    stored events (400,000 rate events, 100,000 × 100,000, rank 128, batch
    65,536, 4 epochs, fp32 moments): two processes on ``cuda:0`` over
    gloo, each holding half of each table and of both moments. Held: each
    process's block, equal losses and table digests, one COMPLETED
    instance whose ``mesh_conf`` is the request, the persisted tables
    bitwise a one-process replay from the two blocks concatenated on the
    same global batches (:func:`rec_model_replay`); with two or more cards
    the same launch over NCCL, bitwise the gloo run's; then a deploy
    through the QueryServer, ``REC_MODEL_USERS`` users' K1 answers equal to
    the replay model's. Returns (launches, record)."""
    from incubator_predictionio_tpu_torch.models.two_tower import TwoTowerModel

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "rec-launch")
    arrays = launch_arrays()
    rec = {"axes": json.loads(MODEL_AXES), "users": LAUNCH_USERS,
           "items": LAUNCH_ITEMS, "rank": LAUNCH_RANK, "events": LAUNCH_EVENTS,
           "batch": LAUNCH_BATCH, "epochs": LAUNCH_EPOCHS,
           "card_count": torch.cuda.device_count()}
    with cli_storage(root) as registry:
        variant_path = write_variant(
            os.path.join(root, "engine-model.json"), FACTORY, "launch",
            [{"name": "als", "params": {
                "rank": LAUNCH_RANK, "numIterations": LAUNCH_EPOCHS,
                "batchSize": LAUNCH_BATCH}}])
        first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        launched = rec_model_train(registry, variant_path, "gloo",
                                   CUDA_VISIBLE_DEVICES=first)
        per, model = launched["processes"], launched["model"]
        mf = model.mf
        names = ("user_emb", "item_emb", "user_bias", "item_bias")
        rec.update({"launch_wall_s": launched["wall_s"], "backend": "gloo",
                    "processes_record": per, "final_loss": mf.final_loss,
                    "timings": mf.timings})
        if torch.cuda.device_count() >= LAUNCH_PROCS:
            nccl = rec_model_train(registry, variant_path, "nccl")
            diff = max(float(np.abs(getattr(nccl["model"].mf, n)
                                    - getattr(mf, n)).max()) for n in names)
            check(diff == 0.0, f"[rec-model] the NCCL launch's tables differ "
                  f"from the gloo launch's by {diff}")
            rec["nccl_launch"] = {k: v for k, v in nccl.items() if k != "model"}
            rec["nccl_launch"]["max_abs_diff_vs_gloo"] = diff
        replay = rec_model_replay(arrays, variant_path, ctx)
        check(list(replay["user_vocab"]) == list(model.user_map.keys())
              and list(replay["item_vocab"]) == list(model.item_map.keys())
              and replay["mean"] == mf.mean,
              "[rec-model] the replay's vocabularies or mean differ")
        k = LAUNCH_RANK
        ue, ie = replay["tables"]
        nu, ni = len(model.user_map), len(model.item_map)
        want = {"user_emb": ue[:nu, :k], "item_emb": ie[:ni, :k],
                "user_bias": ue[:nu, k], "item_bias": ie[:ni, k]}
        bitwise = all(np.array_equal(getattr(mf, n), want[n]) for n in names)
        diff = max(float(np.abs(getattr(mf, n) - want[n]).max()) for n in names)
        rec["replay"] = {"bitwise": bitwise, "max_abs_diff": diff,
                         "loss": replay["loss"], "train_s": replay["train_s"],
                         "steps": replay["steps"]}
        check(bitwise, f"[rec-model] the persisted tables are not the "
              f"one-process replay's: max abs diff {diff}")
        replay_mf = TwoTowerModel(mean=replay["mean"], config=replay["config"],
                                  **want)
        del replay
        gc.collect()
        torch.cuda.empty_cache()
        pick = np.random.default_rng(29).choice(nu, REC_MODEL_USERS, replace=False)
        vocab = list(model.user_map.keys())
        user_ids = [vocab[int(i)] for i in pick]
        with retrieval_mode("exact"):
            # prepared as the server prepares the launched model
            # (RecModel.prepare_for_serving): int8 on the card
            replay_mf.prepare_for_serving(quantize=ctx.device.type == "cuda",
                                          device=ctx.device, build_index=False)
            # the count from 0 over the deploy and the served queries only
            R.reset_launches()
            rec["serve"] = asyncio.run(serve_phase(
                "rec-model", variant_path, registry.get_storage(), ctx,
                lambda s, u, srv: rec_model_body(R, model, replay_mf, user_ids,
                                                 s, u, srv)))
        launches = {"score_catalog_quantized": rec["serve"]["served_launches"]}
        del replay_mf
    check(launches["score_catalog_quantized"] > 0,
          f"[rec-model] K1 never launched serving the launched model: {launches}")
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    smi = smi_name_power()
    log(f"[rec-model] ({smi}) launch -n {LAUNCH_PROCS} train --mesh-axes "
        f"{MODEL_AXES}: wall {rec['launch_wall_s']:.2f} s, backend gloo, the "
        f"processes sharing one card ({rec['card_count']} card(s) visible; "
        "NCCL with a card each: "
        + (f"wall {rec['nccl_launch']['wall_s']:.2f} s, tables bitwise the "
           "gloo launch's" if "nccl_launch" in rec else "not measured") + ")")
    for q in per:
        log(f"[rec-model] ({smi}) process {q['process']} at {q['coords']} on "
            f"{q['device']}: ue rows {q['ue_rows']}, ie rows {q['ie_rows']}; "
            f"stage {q['stage_s']:.3f} s, train {q['train_s']:.3f} s "
            f"({q['steps']} steps of {q['local_batch']} rows); exchange rows "
            f"{q['exchange_rows_ms_per_step']:.3f} ms a step "
            f"({q['exchange_rows_bytes']} bytes), gradients "
            f"{q['exchange_grads_ms_per_step']:.3f} ms a step "
            f"({q['exchange_grads_bytes']} bytes); peak device memory "
            f"{q['peak_bytes'] / 2**30:.3f} GiB")
    log(f"[rec-model] ({smi}) persisted tables bitwise the one-process replay "
        f"({rec['replay']['steps']} steps, train {rec['replay']['train_s']:.3f} "
        f"s, loss {rec['replay']['loss']:.6f} against the launch's "
        f"{mf.final_loss:.6f}); {rec['serve']['same_answers']}/"
        f"{REC_MODEL_USERS} K1 answers equal the replay model's (deploy "
        f"{rec['serve']['deploy_s']:.2f} s); the server's launches {launches} "
        f"(the replay's {rec['serve']['replay_launches']} apart); phase "
        f"{rec['phase_s']:.1f} s")
    return launches, rec


class RecLaunchEvalGrid:
    """rec-launch-eval's EngineParamsGenerator (each launched process loads
    it as ``chip_smoke:RecLaunchEvalGrid``): rank 16 / 32, 5 iterations
    (10 before the depth was cut for the script's time: PERF.md §4), on
    rec-workflow's app ``ml1m``, 3 folds."""

    def __init__(self):
        from incubator_predictionio_tpu_torch.core import EngineParams
        from incubator_predictionio_tpu_torch.templates import recommendation as trec

        self.engine_params_list = [
            EngineParams.create(
                data_source=trec.DataSourceParams(app_name="ml1m", eval_k=EVAL_K),
                algorithms=[("als", trec.ALSAlgorithmParams(
                    rank=rank, num_iterations=REC_EVAL_ITERATIONS))])
            for rank in (16, 32)]


LAUNCH_EVAL_LINE = {
    "dist": LAUNCH_LINE["dist"],
    "fold": re.compile(r"sharded eval fold (\d+) of (\d+): (\d+) of (\d+) train "
                       r"rows \(shard (\d+)/(\d+)\), (\d+) held-out queries, "
                       r"query digest (\w+)"),
    "fit": re.compile(r"data-parallel fit: process \d+ of \d+ .*?train ([\d.]+) "
                      r"s, exchange ([\d.]+) ms a step; loss (\S+); replica "
                      r"digest (\w+), equal"),
    "finished": re.compile(r"evaluation finished: (.*)$", re.M),
}


def expected_fold_digests(ds, k):
    """Each fold's gathered query set as the sharded read must build it,
    computed in this process from the whole store: each process's rows are
    the whole read's rows of its users (crc32 entity shards), in the same
    order; fold membership is crc32(f"{seed}|{user}|{item}") % k."""
    import zlib

    from incubator_predictionio_tpu_torch.data.storage.base import entity_shard
    from incubator_predictionio_tpu_torch.templates import recommendation as trec

    td = ds._read()
    u_str = td.user_vocab[td.user_idx]
    i_str = td.item_vocab[td.item_idx]
    shard = np.asarray([entity_shard(u, LAUNCH_PROCS) for u in u_str])
    fold_of = np.asarray([zlib.crc32(f"{ds.params.seed}|{u}|{i}".encode()) % k
                          for u, i in zip(u_str, i_str)])
    out = []
    for fold in range(k):
        parts = []
        for s in range(LAUNCH_PROCS):
            rows = shard == s
            sub = trec.TrainingData(td.user_idx[rows], td.item_idx[rows],
                                    td.ratings[rows], td.user_vocab, td.item_vocab)
            qa = ds._fold_qa(sub, fold_of[rows] == fold)
            parts.append([(q.user, q.num, [(r.item, r.rating) for r in a.ratings])
                          for q, a in qa])
        out.append((sum(len(p) for p in parts), trec.query_digest(parts)))
    return out


def rec_launch_eval_phase(ctx, tmp):
    """``launch -n 2 eval`` of the recommendation template on rec-workflow's
    stored 100,050 events: RecommendationEvaluation with
    :class:`RecLaunchEvalGrid` (2 variants × 3 folds: 6 data-parallel fits
    in each process, both on the card over gloo). Held: one new
    EVALCOMPLETED row, written by process 0 alone; both processes' result
    lines equal; each fold's gathered query set (its count and digest, as
    each process logs it) the one computed here from the events with the
    crc32 rule; every fit's replica digest equal across the processes;
    scores finite, ``bestIdx`` the first arg-max. Returns the record."""
    from incubator_predictionio_tpu_torch.templates import recommendation as trec

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "rec-workflow")
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    with cli_storage(root) as registry:
        rows = registry.get_storage().get_meta_data_evaluation_instances()
        before = {i.id for i in rows.get_all()}
        ds = trec.DataSource(trec.DataSourceParams(app_name="ml1m", eval_k=EVAL_K))
        t0 = time.perf_counter()
        want = expected_fold_digests(ds, EVAL_K)
        expect_s = time.perf_counter() - t0
        with env_vars(PYTHONPATH=str(Path(__file__).resolve().parent),
                      CUDA_VISIBLE_DEVICES=first):
            t0 = time.perf_counter()
            out = cli_run("rec-launch-eval", [
                "launch", "-n", str(LAUNCH_PROCS), "--timeout",
                str(LAUNCH_TIMEOUT_S), "eval", REC_EVALUATION,
                f"{Path(__file__).stem}:RecLaunchEvalGrid"])
            wall = time.perf_counter() - t0
        new = [i for i in rows.get_all() if i.id not in before]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    (OUT.parent / "rec_launch_eval.log").write_text(out)
    procs = launch_sections(out, LAUNCH_EVAL_LINE, "rec-launch-eval",
                            many=("fold", "fit"))
    check(len(new) == 1 and new[0].status == "EVALCOMPLETED",
          f"[rec-launch-eval] new evaluation rows {[(i.id, i.status) for i in new]}")
    inst = new[0]
    check(f"Evaluation completed. Instance ID: {inst.id}" in procs[0]["log"]
          and "Evaluation completed (secondary process" in procs[1]["log"],
          "[rec-launch-eval] the primary did not write the row, or a "
          "secondary claimed it")
    check(procs[0]["finished"] == procs[1]["finished"],
          f"[rec-launch-eval] the processes' results differ: "
          f"{[p['finished'] for p in procs]}")
    for p in procs:
        check(p["dist"][2] == "gloo" and p["dist"][3].startswith("cuda"),
              f"[rec-launch-eval] process {p['process']}: {p['dist']}")
        got = [(int(f[6]), f[7]) for f in sorted(p["fold"], key=lambda f: int(f[0]))]
        check(got == want, f"[rec-launch-eval] process {p['process']}: the folds' "
              f"query sets {got} differ from the events' {want}")
    fits = [p["fit"] for p in procs]
    variants = len(RecLaunchEvalGrid().engine_params_list)
    check(len(fits[0]) == len(fits[1]) == variants * EVAL_K,
          f"[rec-launch-eval] {[len(f) for f in fits]} fits, want "
          f"{variants * EVAL_K}")
    check(all(a[3] == b[3] for a, b in zip(*fits)),
          "[rec-launch-eval] a fit's replica digests differ across processes")
    res = json.loads(inst.evaluator_results_json)
    scores = [r["score"] for r in res["results"]]
    check(len(scores) == variants and all(np.isfinite(scores))
          and res["bestIdx"] == int(np.argmax(scores)),
          f"[rec-launch-eval] scores {scores}, bestIdx {res['bestIdx']}")
    rec = {"wall_s": wall, "fits": len(fits[0]),
           "fit_train_s": [[float(f[0]) for f in fp] for fp in fits],
           "exchange_ms_per_step": [[float(f[1]) for f in fp] for fp in fits],
           "folds": [{"queries": n, "digest": d} for n, d in want],
           "expected_read_s": expect_s, "scores": scores,
           "best_idx": res["bestIdx"], "one_liner": inst.evaluator_results,
           "phase_s": time.perf_counter() - t_phase}
    smi = smi_name_power()
    log(f"[rec-launch-eval] ({smi}) launch -n 2 eval: wall {wall:.2f} s, "
        f"{rec['fits']} data-parallel fits a process (train "
        f"{sum(rec['fit_train_s'][0]):.2f} s on process 0, exchange "
        f"{np.mean(rec['exchange_ms_per_step'][0]):.3f} ms a step); folds' "
        f"queries {[n for n, _ in want]} equal to the events' on both "
        f"processes; Precision@10 {[round(x, 4) for x in scores]} (best "
        f"{res['bestIdx']}); one EVALCOMPLETED row, by process 0; phase "
        f"{rec['phase_s']:.1f} s")
    return rec


# -- phase: launch -n 2 train of the sequential template ----------------------

SEQ_LAUNCH_LINE = {
    "dist": LAUNCH_LINE["dist"],
    "read": re.compile(r"sharded read: (\d+) of (\d+) rows \(shard (\d+)/(\d+)\)\s*$",
                       re.M),
    "fit": re.compile(
        r"data-parallel fit: process (\d+) of (\d+) \(backend (\w+), (\S+)\): "
        r"(\d+) steps of (\d+) local rows; stage ([\d.]+) s, train ([\d.]+) s, "
        r"exchange ([\d.]+) ms a step; loss (\S+); replica digest (\w+), equal "
        r"on every process; staged (\d+) rows \((\w+) real\); peak device "
        r"memory (\d+) bytes; attention launches (\{.*\})"),
}
#: the replays against the launched model: the loss within seq-train's
#: 1e-2 relative (each replay); the parameters within 2e-2 of each
#: tensor's max abs (and relative Frobenius) of the split replay, what the
#: launched processes compute without the transport. The same split
#: replay run twice must end bitwise: sequential training on the card is
#: the same every run (the embeddings' backward, ``_lookup`` in
#: models/transformer.py, sums in one order)
SEQ_LAUNCH_LOSS_RTOL, SEQ_LAUNCH_PARAM_TOL = 1e-2, 2e-2


def seq_launch_replay(ds, model, dev):
    """Both shards read in this process (``_collect_sessions`` of each
    shard, ``_build_fold`` and the staging under :class:`ShardScript`),
    then loops on the card from the launched fit's initial parameters:
    ``split`` — each step a backward over each process's local batch (the
    global batch's weight sum the denominator), the gradients summed in
    process order, then adam, what the launched processes compute without
    the transport — run twice (``split_again``: two identical fits);
    ``global`` — the single-process step on the global batches (the
    processes' local batches concatenated). Returns (item map, {loop:
    (final loss, parameters, train s)})."""
    from incubator_predictionio_tpu_torch.data.bimap import BiMap
    from incubator_predictionio_tpu_torch.models import transformer as ttr
    from incubator_predictionio_tpu_torch.parallel.staging import (
        stage_sharded_batches,
    )
    from incubator_predictionio_tpu_torch.utils.optim import adam_init, adam_update

    n = LAUNCH_PROCS
    sessions = [list(ds._collect_sessions(ShardScript(s, [[0] * n]))[0].values())
                for s in range(n)]
    bases = [list(BiMap.string_int([i for x in ss for i in x])) for ss in sessions]
    counts = [sum(len(x) >= 2 for x in ss) for ss in sessions]
    folds = [ds._build_fold(ShardScript(s, [bases, counts]), sessions[s], True)
             for s in range(n)]
    cfg = model.config
    staged = []
    for s, td in enumerate(folds):
        seqs = td.sequences
        tokens, targets = seqs[:, :-1], seqs[:, 1:]
        weights = (targets != 0).astype(np.float32) * (tokens != 0).astype(np.float32)
        (tb, yb, wb), w_pad, _ = stage_sharded_batches(
            ShardScript(s, [counts, counts], dev),
            (tokens.astype(np.int32), targets.astype(np.int32), weights),
            cfg.batch_size, cfg.seed)
        staged.append((tb.long(), yb.long(), wb * w_pad[..., None]))
    denoms = sum(st[2].sum((1, 2)) for st in staged).clamp(min=1.0)
    glob = [torch.cat([st[j] for st in staged], 1) for j in range(3)]
    n_batches = glob[0].shape[0]

    def run(split):
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        net = ttr.TransformerNet(ttr._init_params(cfg, gen, dev), cfg, dev,
                                 trainable=True)
        params = list(net.parameters())
        opt = adam_init(params, cfg.adam_moments_dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cfg.epochs):
            losses = []
            for i in range(n_batches):
                if not split:
                    b = glob[0].shape[1]
                    pos = torch.arange(cfg.max_len, device=dev).expand(b, cfg.max_len)
                    losses.append(ttr.train_step(
                        net, opt, (glob[0][i], pos, glob[1][i], glob[2][i]),
                        cfg.learning_rate))
                    continue
                acc = loss = None
                for tb, yb, wb in staged:
                    pos = torch.arange(cfg.max_len, device=dev).expand(
                        tb.shape[1], cfg.max_len)
                    part = ttr.train_loss(net, tb[i], pos, yb[i], wb[i],
                                          denom=denoms[i])
                    flat = torch.cat([g.reshape(-1) for g in
                                      torch.autograd.grad(part, params)])
                    acc = flat if acc is None else acc + flat
                    loss = part.detach() if loss is None else loss + part.detach()
                adam_update(params, [g.view_as(p) for g, p in zip(
                    acc.split([p.numel() for p in params]), params)],
                    opt, cfg.learning_rate)
                losses.append(loss)
        loss = float(torch.stack(losses).mean())
        out = (loss, net.params_numpy(), time.perf_counter() - t0)
        del net, opt, params
        gc.collect()
        torch.cuda.empty_cache()
        return out

    return folds[0].item_map, {"split": run(True), "split_again": run(True),
                               "global": run(False)}


def param_distance(a, b) -> dict:
    """Two parameter trees apart: bitwise, and the worst tensor by the
    largest element difference over its max abs and by relative
    Frobenius (each with its name)."""
    out = {"bitwise": True, "max_abs_ratio": 0.0, "max_abs_ratio_at": None,
           "rel_frobenius": 0.0, "rel_frobenius_at": None}
    for name, x, y in _tree_pairs(a, b):
        out["bitwise"] &= bool(np.array_equal(x, y))
        ratio = float(np.abs(x - y).max()) / max(float(np.abs(x).max()), 1e-30)
        rel = float(np.linalg.norm(y - x)) / max(float(np.linalg.norm(x)), 1e-30)
        if ratio > out["max_abs_ratio"]:
            out["max_abs_ratio"], out["max_abs_ratio_at"] = ratio, name
        if rel > out["rel_frobenius"]:
            out["rel_frobenius"], out["rel_frobenius_at"] = rel, name
    return out


async def seq_launch_body(sessions_, session, url, server, lat, bursts=3):
    """``bursts`` bursts of 64 ``recentItems`` queries (prefixes of the
    stored sessions) through the launched model's K4 forward; the last
    burst held against the plain attention forward on the card."""
    rng = np.random.default_rng(41)
    bodies = payloads = None
    lat["burst64"] = []
    for _ in range(bursts):
        pick = rng.choice(len(sessions_), 64, replace=False)
        payloads = [{"recentItems": list(sessions_[int(j)][:-1]), "num": 10}
                    for j in pick]
        t0 = time.perf_counter()
        bodies, _ = await post_all(session, url, payloads, True)
        lat["burst64"].append(time.perf_counter() - t0)
    check_answers(payloads, bodies)
    worst, same_set, same_order = check_against_plain(
        server.deployed.models[0], payloads, bodies)
    return {"max_score_diff": worst, "same_set": same_set,
            "same_order": same_order}


def seq_launch_train(registry, variant_path, backend, **env):
    """``launch -n 2 train -v <variant>`` of the sequential template through
    the CLI, in-process, its children under ``env``; every process's lines
    held (exit 0, the backend, on the card, shard reads that partition the
    rows, K4 forward and backward launched, equal losses and replica
    digests), then the one new COMPLETED instance and its model. Returns
    the processes' records, the launch wall and the persisted model."""
    from incubator_predictionio_tpu_torch.utils.serialization import (
        deserialize_model,
    )

    tag = f"seq-launch {backend}"
    insts = registry.get_storage().get_meta_data_engine_instances()
    before = {i.id for i in insts.get_all()}
    with env_vars(PYTHONPATH=str(Path(__file__).resolve().parent), **env):
        t0 = time.perf_counter()
        out = cli_run(tag, ["launch", "-n", str(LAUNCH_PROCS), "--timeout",
                            str(LAUNCH_TIMEOUT_S), "train", "-v", variant_path])
        wall = time.perf_counter() - t0
    OUT.parent.mkdir(parents=True, exist_ok=True)
    (OUT.parent / f"seq_launch_{backend}.log").write_text(out)
    per = []
    for p in launch_sections(out, SEQ_LAUNCH_LINE, tag):
        d, r, f = p["dist"], p["read"], p["fit"]
        att = json.loads(f[14])
        check(d[2] == backend == f[2] and d[3].startswith("cuda"),
              f"[{tag}] process {p['process']}: {d}")
        for w in ("causal_mha_small_head", "causal_mha_small_head_bwd"):
            check(att.get(w, 0) > 0, f"[{tag}] process {p['process']}: "
                  f"{w} never launched: {att}")
        per.append({"process": p["process"], "device": d[3],
                    "local_rows": int(r[0]), "global_rows": int(r[1]),
                    "steps": int(f[4]), "local_batch": int(f[5]),
                    "stage_s": float(f[6]), "train_s": float(f[7]),
                    "exchange_ms_per_step": float(f[8]), "loss": float(f[9]),
                    "digest": f[10], "staged_rows": int(f[11]),
                    "peak_bytes": int(f[13]), "attention_launches": att})
    total = per[0]["global_rows"]
    check(all(q["global_rows"] == total for q in per)
          and sum(q["local_rows"] for q in per) == total
          and all(0 < q["local_rows"] < total for q in per),
          f"[{tag}] shard reads {per}")
    check(len({q["digest"] for q in per}) == 1 and len({q["loss"] for q in per}) == 1,
          f"[{tag}] replica digests or losses differ: {per}")
    new = [i for i in insts.get_all() if i.id not in before]
    check([i.status for i in new] == ["COMPLETED"],
          f"[{tag}] new instances {[(i.id, i.status) for i in new]}")
    blob = registry.get_storage().get_model_data_models().get(new[0].id)
    check(blob is not None, f"[{tag}] no model blob")
    return {"processes": per, "wall_s": wall,
            "model": deserialize_model(blob.models)[0]}


def seq_launch_phase(ctx, tmp):
    """``launch -n 2 train`` of the sequential template on seq-workflow's
    stored sessions at its full width (``max_len`` 512, d_model 512, 6
    layers of 8 heads of 64, batch 64: 32 a process, 1 epoch), both
    processes on the card over gloo, each reading its user shard and
    running the data-parallel fit (K4 forward and backward, one
    all-reduce of the gradients a step). Held: proper shard reads whose
    rows sum to the global count, K4 forward and backward launched in both
    processes, equal replica digests, one new COMPLETED instance and blob
    (where the machine has two cards, a second launch with a card each,
    over NCCL, held against the first as the replay is),
    the replays of :func:`seq_launch_replay` in the bands of
    :data:`SEQ_LAUNCH_LOSS_RTOL` (the loss) and :data:`SEQ_LAUNCH_PARAM_TOL`
    (the parameters), the split replay run twice bitwise; then a
    deploy of the launched model and bursts through K4 held against the
    plain attention. Returns (launches of the attention kernels in this
    process, record)."""
    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.templates import sequential as tseq

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "seq-workflow")
    variant_path = os.path.join(root, "engine.json")
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    sessions_ = cycle_sessions(np.random.default_rng(31), SEQ_WF_USERS,
                               SEQ_WF_MAX_LEN, SEQ_WF_LENGTHS)
    with cli_storage(root) as registry:
        storage = registry.get_storage()
        # one card: the processes share it (gloo through the host), also
        # where the machine has more
        gloo = seq_launch_train(registry, variant_path, "gloo",
                                CUDA_VISIBLE_DEVICES=first)
        per, model, wall = gloo["processes"], gloo["model"], gloo["wall_s"]
        total = per[0]["global_rows"]
        # a card each: NCCL, the same fit over another transport
        nccl = (seq_launch_train(registry, variant_path, "nccl")
                if torch.cuda.device_count() >= LAUNCH_PROCS else None)
        # the replays: both shards' batches, one process, on the card
        ds = tseq.DataSource(tseq.DataSourceParams(app_name="seq",
                                                   max_len=SEQ_WF_MAX_LEN))
        item_map, replays = seq_launch_replay(ds, model, ctx.device)
        replay = {loop: {"loss": loss, "train_s": replay_s,
                         "loss_rel": abs(loss - per[0]["loss"]) / abs(loss)}
                  for loop, (loss, _, replay_s) in replays.items()}
        for loop in ("split", "global"):
            replay[loop].update(param_distance(replays[loop][1], model.params))
        # two identical fits: the same single-process loop run twice
        replay["split_again"].update(param_distance(
            replays["split"][1], replays["split_again"][1]))
        check(replay["split_again"]["bitwise"]
              and replays["split"][0] == replays["split_again"][0],
              f"[seq-launch] two identical fits on the card differ: "
              f"{replay['split_again']}")
        del replays
        gc.collect()
        torch.cuda.empty_cache()
        smi = smi_name_power()
        for loop, r in replay.items():
            log(f"[seq-launch] ({smi}) replay ({loop}{' vs split' if loop == 'split_again' else ''}) "
                f"on the card: loss {r['loss']:.6f} against the launch's "
                f"{per[0]['loss']:.6f} (rel {r['loss_rel']:.3e}), parameters "
                f"bitwise {r['bitwise']}, the largest difference "
                f"{r['max_abs_ratio']:.3e} of its tensor's max abs "
                f"({r['max_abs_ratio_at']}), relative Frobenius "
                f"{r['rel_frobenius']:.3e} ({r['rel_frobenius_at']}), train "
                f"{r['train_s']:.3f} s")
        check(dict(item_map.items()) == dict(model.item_map.items()),
              "[seq-launch] the replay's item map differs from the launched model's")
        for loop, r in replay.items():
            check(r["loss_rel"] <= SEQ_LAUNCH_LOSS_RTOL,
                  f"[seq-launch] loss {per[0]['loss']} against the {loop} "
                  f"replay's {r['loss']} (band {SEQ_LAUNCH_LOSS_RTOL})")
        if nccl is not None:
            replay["nccl"] = {"loss": nccl["processes"][0]["loss"],
                              **param_distance(nccl["model"].params, model.params)}
            replay["nccl"]["loss_rel"] = abs(
                replay["nccl"]["loss"] - per[0]["loss"]) / abs(per[0]["loss"])
            log(f"[seq-launch] ({smi}) the NCCL launch (a card each) against the "
                f"gloo launch: loss rel {replay['nccl']['loss_rel']:.3e}, "
                f"parameters bitwise {replay['nccl']['bitwise']}, "
                f"{replay['nccl']['max_abs_ratio']:.3e} of a tensor's max abs, "
                f"relative Frobenius {replay['nccl']['rel_frobenius']:.3e}")
            check(replay["nccl"]["loss_rel"] <= SEQ_LAUNCH_LOSS_RTOL,
                  f"[seq-launch] the NCCL launch's loss {replay['nccl']['loss']}")
        for loop in ("split", "nccl"):
            for key in ("max_abs_ratio", "rel_frobenius"):
                if loop not in replay:
                    continue
                check(replay[loop][key] <= SEQ_LAUNCH_PARAM_TOL,
                      f"[seq-launch] the launched model is {replay[loop][key]:.3e} "
                      f"({key}) from the {loop} fit, past {SEQ_LAUNCH_PARAM_TOL}")
        lat = {}
        A.reset_launches()
        served = asyncio.run(serve_phase(
            "seq-launch", variant_path, storage, ctx,
            lambda s, u, srv: seq_launch_body(sessions_, s, u, srv, lat)))
        launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    check(launches["causal_mha_small_head"] > 0,
          f"[seq-launch] K4 never launched serving the launched model: {launches}")
    train_wall = max(q["train_s"] for q in per)
    cfg = model.config
    rec = {"launch_wall_s": wall, "processes": per, "global_rows": total,
           "card_count": torch.cuda.device_count(),
           "nccl_launch": None if nccl is None else {
               k: v for k, v in nccl.items() if k != "model"},
           "train_tokens_per_s": cfg.epochs * total * cfg.max_len / train_wall,
           "replay": replay,
           "burst64_ms": [x * 1e3 for x in lat["burst64"]],
           "burst64_p50_ms": pct(lat["burst64"], 50),
           "kernels_vs_plain": served,
           "serve_launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    smi = smi_name_power()
    log(f"[seq-launch] ({smi}) launch -n 2 train at max_len {cfg.max_len}, "
        f"d_model {cfg.d_model}, {cfg.n_layers} layers of {cfg.n_heads} heads, "
        f"batch {cfg.batch_size}, {cfg.epochs} epochs: wall {wall:.2f} s, "
        f"{rec['train_tokens_per_s']:.1f} train tokens/s")
    for q in per:
        log(f"[seq-launch] ({smi}) process {q['process']} on {q['device']}: read "
            f"{q['local_rows']} of {q['global_rows']} rows, staged "
            f"{q['staged_rows']}, train {q['train_s']:.3f} s ({q['steps']} steps "
            f"of {q['local_batch']} rows), exchange {q['exchange_ms_per_step']:.3f} "
            f"ms a step, peak device memory {q['peak_bytes'] / 2**30:.3f} GiB, "
            f"K4 launches {q['attention_launches']}; digest {q['digest']}")
    log(f"[seq-launch] ({smi}) burst of 64 p50 {rec['burst64_p50_ms']:.2f} ms "
        f"(deploy {served['deploy_s']:.2f} s), against the plain attention "
        f"max score diff {served['max_score_diff']:.2e} (sets equal "
        f"{served['same_set']}/64, orders {served['same_order']}/64); serve launches "
        f"{launches}; phase {rec['phase_s']:.1f} s")
    return launches, rec


# -- phase: tensor parallelism of the sequential transformer ----------------

#: seq-tp's fit: the first SEQ_TP_USERS of seq-workflow's users' sessions,
#: stored as app "seqtp" in its store, one epoch at batch 64: 4 steps (cut
#: for the script's time limit: a step is mostly gloo's all-reduces)
SEQ_TP_USERS, SEQ_TP_EPOCHS = 256, 1
#: the launched tensor-parallel fit's step losses against the one-process
#: replicated fit from the same initial parameters, relative: each
#: row-parallel partial product rounds to bf16 before the sum over
#: ``model`` where the replicated product rounds once. Set from readings
#: on the H100: 4.672e-6 and 5.442e-6 (PERF.md §6)
SEQ_TP_LOSS_RTOL = 1e-4
#: the persisted (gathered) parameters against the replicated fit's, per
#: leaf: ``‖p_tp − p_rep‖ / ‖p_rep − p_0‖``, the two fits apart over the
#: update the replicated fit made from the shared init ``p_0``; the
#: largest leaf's. Set from readings on the H100 between the
#: tensor-parallel fit's, 0.0732 (a layer norm's gain: adam's first steps
#: move an element by about lr·sign(g), so a gradient near 0 may step
#: either way), and the planted fault's, 1.132 (a replicated fit with head
#: 0's attention output zeroed), which must lie above it (PERF.md §6)
SEQ_TP_PARAM_RTOL = 0.3
SEQ_TP_LINE = {
    "dist": LAUNCH_LINE["dist"],
    "fit": re.compile(
        r"tensor-parallel fit: process (\d+) of (\d+) at (\{.*?\}) \(backend "
        r"(\w+), (\S+)\): (\d+) of (\d+) heads; wq (\[.*?\]), w1 (\[.*?\]), "
        r"wo (\[.*?\]), w2 (\[.*?\]); (\d+) steps of (\d+) local rows; stage "
        r"([\d.]+) s, train ([\d.]+) s, exchange model ([\d.]+) ms a step, "
        r"data ([\d.]+) ms a step; loss (\S+); model digest (\w+), equal on "
        r"every process; peak device memory (\d+) bytes; attention launches "
        r"(\{.*\})"),
}


def seq_tp_train(registry, variant_path, backend, **env):
    """``launch -n 2 train -v <variant> --mesh-axes '{"model": 2}'`` of the
    sequential template with ``tensorParallel`` through the CLI,
    in-process; every process's lines held (exit 0, the backend, on the
    card, half the heads, the slices' shapes, K4 forward and backward
    launched, equal losses and model digests), then the new COMPLETED
    instance and its model."""
    from incubator_predictionio_tpu_torch.utils.serialization import (
        deserialize_model,
    )

    tag = f"seq-tp {backend}"
    insts = registry.get_storage().get_meta_data_engine_instances()
    before = {i.id for i in insts.get_all()}
    with env_vars(PYTHONPATH=str(Path(__file__).resolve().parent), **env):
        t0 = time.perf_counter()
        out = cli_run(tag, ["launch", "-n", str(LAUNCH_PROCS), "--timeout",
                            str(LAUNCH_TIMEOUT_S), "train", "-v", variant_path,
                            "--mesh-axes", MODEL_AXES])
        wall = time.perf_counter() - t0
    OUT.parent.mkdir(parents=True, exist_ok=True)
    (OUT.parent / f"seq_tp_{backend}.log").write_text(out)
    d, dh, tp = SEQ_D, 4 * SEQ_D, LAUNCH_PROCS
    shapes = [[d, d // tp], [d, dh // tp], [d // tp, d], [dh // tp, d]]
    per = []
    for p in launch_sections(out, SEQ_TP_LINE, tag):
        dist, f = p["dist"], p["fit"]
        got = [json.loads(x) for x in f[7:11]]
        att = json.loads(f[20])
        check(dist[2] == backend == f[3] and dist[3].startswith("cuda")
              and (int(f[5]), int(f[6])) == (SEQ_HEADS // tp, SEQ_HEADS)
              and got == shapes,
              f"[{tag}] process {p['process']}: {dist} {f[:11]}")
        for w in ("causal_mha_small_head", "causal_mha_small_head_bwd"):
            check(att.get(w, 0) > 0, f"[{tag}] process {p['process']}: "
                  f"{w} never launched: {att}")
        per.append({"process": p["process"], "device": dist[3],
                    "coords": json.loads(f[2]), "heads": int(f[5]),
                    "wq": got[0], "w1": got[1], "wo": got[2], "w2": got[3],
                    "steps": int(f[11]), "local_batch": int(f[12]),
                    "stage_s": float(f[13]), "train_s": float(f[14]),
                    "exchange_model_ms_per_step": float(f[15]),
                    "exchange_data_ms_per_step": float(f[16]),
                    "loss": float(f[17]), "digest": f[18],
                    "peak_bytes": int(f[19]), "attention_launches": att})
    check(len({q["digest"] for q in per}) == 1 and len({q["loss"] for q in per}) == 1,
          f"[{tag}] model digests or losses differ: {per}")
    new = [i for i in insts.get_all() if i.id not in before]
    check([i.status for i in new] == ["COMPLETED"],
          f"[{tag}] new instances {[(i.id, i.status) for i in new]}")
    blob = registry.get_storage().get_model_data_models().get(new[0].id)
    check(blob is not None, f"[{tag}] no model blob")
    return {"processes": per, "wall_s": wall,
            "model": deserialize_model(blob.models)[0]}


def session_events(sessions_) -> list:
    """``view`` events of user ``u<k>`` on each item of session ``k``, one
    second apart (seq-tp's and seq-axes' apps)."""
    import datetime as dt

    t0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
    dicts, j = [], 0
    for k, items in enumerate(sessions_):
        for item in items:
            dicts.append({"event": "view", "entityType": "user",
                          "entityId": f"u{k}", "targetEntityType": "item",
                          "targetEntityId": item,
                          "eventTime": (t0 + dt.timedelta(seconds=j)).isoformat()})
            j += 1
    return dicts


def seq_tp_phase(ctx, tmp):
    """Tensor parallelism over a ``model`` axis of two processes on
    ``cuda:0`` (gloo): the first :data:`SEQ_TP_USERS` of seq-workflow's
    users' sessions imported as app ``seqtp`` into its store, ``launch -n
    2 train --mesh-axes '{"model": 2}'`` at seq-workflow's full width
    (``max_len`` 512, d_model 512, 6 × 8 heads of 64, batch 64,
    ``tensorParallel``) for :data:`SEQ_TP_EPOCHS` epoch: each process holds
    half of ``wq``, ``wk``, ``wv``, ``w1``, ``b1``, ``wo``, ``w2`` and runs K4
    forward and backward on its 4 heads. Held: the slices' shapes, K4
    launched in both processes, equal digests, the canonical layout
    persisted, the step losses within :data:`SEQ_TP_LOSS_RTOL` of a
    one-process replicated fit from the same initial parameters; then a
    deploy and bursts through K4 held against the plain attention.
    Returns (launches of the attention kernels in this process, record)."""
    from incubator_predictionio_tpu_torch.models import transformer as ttr
    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.templates import sequential as tseq

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "seq-workflow")
    sessions_ = cycle_sessions(np.random.default_rng(31), SEQ_WF_USERS,
                               SEQ_WF_MAX_LEN, SEQ_WF_LENGTHS)[:SEQ_TP_USERS]
    dicts = session_events(sessions_)
    params = {"maxLen": SEQ_WF_MAX_LEN, "dModel": SEQ_D, "nHeads": SEQ_HEADS,
              "nLayers": SEQ_LAYERS, "learningRate": TRAIN_LR,
              "batchSize": TRAIN_BATCH, "epochs": SEQ_TP_EPOCHS}
    with cli_storage(root) as registry:
        _, imported = cli_app_import("seq-tp", root, "seqtp", dicts)
        variant_path = os.path.join(root, "engine-tp.json")
        with open(variant_path, "w") as f:
            json.dump({"id": "seq-tp", "version": "1",
                       "engineFactory": SEQ_FACTORY,
                       "datasource": {"params": {"appName": "seqtp",
                                                 "maxLen": SEQ_WF_MAX_LEN}},
                       "algorithms": [{"name": "transformer", "params": {
                           **params, "tensorParallel": True}}]}, f)
        first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        launched = seq_tp_train(registry, variant_path, "gloo",
                                CUDA_VISIBLE_DEVICES=first)
        per, model, wall = (launched["processes"], launched["model"],
                            launched["wall_s"])
        cfg = model.config
        check(all(np.shape(model.params["layers"][i][n]) == shape
                  for i in range(SEQ_LAYERS)
                  for n, shape in (("wq", (SEQ_D, SEQ_D)),
                                   ("w1", (SEQ_D, 4 * SEQ_D)),
                                   ("wo", (SEQ_D, SEQ_D)),
                                   ("w2", (4 * SEQ_D, SEQ_D)))),
              "[seq-tp] the persisted model is not in the canonical layout")
        # the replicated fit in this process from the same initial
        # parameters (the same seed on the same card) on the same rows, in
        # the launched fit's order
        ds = tseq.DataSource(tseq.DataSourceParams(app_name="seqtp",
                                                   max_len=SEQ_WF_MAX_LEN))
        td = launched_rows(ds.read_training(ctx), cfg)
        check(dict(td.item_map.items()) == dict(model.item_map.items()),
              "[seq-tp] the replicated fit's item map differs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = ttr.TransformerRecommender(dataclasses.replace(
            cfg, tensor_parallel=False)).fit(ctx, td.sequences, td.item_map)
        rep_s = time.perf_counter() - t0
        got, want = np.asarray(model.step_losses), np.asarray(rep.step_losses)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        check(got.shape == want.shape and rel <= SEQ_TP_LOSS_RTOL,
              f"[seq-tp] step losses {got.tolist()} against the replicated "
              f"fit's {want.tolist()}: {rel:.3e} relative (band "
              f"{SEQ_TP_LOSS_RTOL})")
        # the shared init, drawn as both fits draw it (the seed on the card)
        p0 = _tree_numpy(ttr._init_params(
            cfg, torch.Generator(device=ctx.device).manual_seed(cfg.seed),
            ctx.device))
        param_rel, param_leaf = update_rel(model.params, rep.params, p0)
        # the planted fault: the replicated fit with head 0's attention
        # output zeroed in every layer; the bands must see it
        fault, fault_losses = planted_head_fault(
            ttr, dataclasses.replace(cfg, tensor_parallel=False), ctx, td)
        fault_loss_rel = float(np.max(np.abs(fault_losses - want)
                                      / np.abs(want)))
        fault_rel, fault_leaf = update_rel(fault, rep.params, p0)
        del rep, fault, p0
        check(param_rel <= SEQ_TP_PARAM_RTOL,
              f"[seq-tp] the persisted parameters are {param_rel:.3e} of the "
              f"replicated fit's update apart at {param_leaf} (band "
              f"{SEQ_TP_PARAM_RTOL})")
        check(fault_rel > SEQ_TP_PARAM_RTOL,
              f"[seq-tp] the band {SEQ_TP_PARAM_RTOL} does not see a zeroed "
              f"head: the planted fault's parameters {fault_rel:.3e} apart at "
              f"{fault_leaf}")
        gc.collect()
        torch.cuda.empty_cache()
        lat = {}
        A.reset_launches()
        served = asyncio.run(serve_phase(
            "seq-tp", variant_path, registry.get_storage(), ctx,
            lambda s, u, srv: seq_launch_body(sessions_, s, u, srv, lat)))
        launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    check(launches["causal_mha_small_head"] > 0,
          f"[seq-tp] K4 never launched serving the model: {launches}")
    train_wall = max(q["train_s"] for q in per)
    rec = {"launch_wall_s": wall, "processes": per, "import": imported,
           "card_count": torch.cuda.device_count(),
           "steps": per[0]["steps"], "step_losses": got.tolist(),
           "replicated_step_losses": want.tolist(),
           "step_loss_max_rel": rel, "replicated_train_s": rep_s,
           "param_update_rel": param_rel, "param_update_rel_leaf": param_leaf,
           "param_update_rel_band": SEQ_TP_PARAM_RTOL,
           "planted_fault": {"param_update_rel": fault_rel,
                             "param_update_rel_leaf": fault_leaf,
                             "step_loss_max_rel": fault_loss_rel},
           "train_tokens_per_s": per[0]["steps"] * TRAIN_BATCH
           * SEQ_WF_MAX_LEN / train_wall,
           "burst64_ms": [x * 1e3 for x in lat["burst64"]],
           "burst64_p50_ms": pct(lat["burst64"], 50),
           "kernels_vs_plain": served, "serve_launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    smi = smi_name_power()
    log(f"[seq-tp] ({smi}) launch -n 2 train --mesh-axes {MODEL_AXES} at "
        f"max_len {cfg.max_len}, d_model {cfg.d_model}, {cfg.n_layers} layers "
        f"of {cfg.n_heads} heads, batch {cfg.batch_size}: {rec['steps']} "
        f"steps, wall {wall:.2f} s, {rec['train_tokens_per_s']:.1f} train "
        f"tokens/s; the replicated fit in this process {rep_s:.2f} s")
    for q in per:
        log(f"[seq-tp] ({smi}) process {q['process']} at {q['coords']} on "
            f"{q['device']}: {q['heads']} of {SEQ_HEADS} heads, wq {q['wq']}, "
            f"w1 {q['w1']}, wo {q['wo']}, w2 {q['w2']}; train {q['train_s']:.3f} "
            f"s; exchange model {q['exchange_model_ms_per_step']:.3f} ms a step; "
            f"peak device memory {q['peak_bytes'] / 2**30:.3f} GiB; attention "
            f"launches {q['attention_launches']}")
    log(f"[seq-tp] ({smi}) against the replicated fit: step losses max "
        f"relative {rel:.3e} (band {SEQ_TP_LOSS_RTOL}), parameters "
        f"{param_rel:.3e} of its update at {param_leaf} (band "
        f"{SEQ_TP_PARAM_RTOL}); the planted zeroed head: parameters "
        f"{fault_rel:.3e} at {fault_leaf}, step losses {fault_loss_rel:.3e}")
    log(f"[seq-tp] ({smi}) burst of 64 p50 "
        f"{rec['burst64_p50_ms']:.2f} ms, against the plain attention max "
        f"score diff {served['max_score_diff']:.2e}; serve launches "
        f"{launches}; phase {rec['phase_s']:.1f} s")
    return launches, rec


# -- phase: the expert mesh axis, mixture-of-experts training and serving ----

#: Switch-Base-8's routing (Fedus et al. 2021), the reference's defaults
#: (TransformerConfig, transformer.py:58-60): top-1 over 8 experts,
#: capacity factor 1.25, auxiliary weight 1e-2
SEQ_MOE_EXPERTS = 8
SEQ_MOE_AXES = '{"expert": 2}'
#: rows of the first training batch through the MoE layer on the card and
#: on the CPU (the CPU's bf16 products at the full batch would take the
#: script tens of seconds)
SEQ_MOE_LAYER_ROWS = 16
#: the launched expert-parallel fit's step losses against the one-process
#: fit from the same initial parameters, relative: the members' products
#: run at other shapes (32 rows, 4 experts) than the one process's, so
#: their fp32 sums round to other bf16 values now and then, and a token
#: whose router logits are a near-tie may pick another expert. Set from
#: readings on the H100: 1.193e-4, against the planted fault's 7.945e-3
#: (PERF.md §6)
SEQ_MOE_LOSS_RTOL = 1e-3
#: the persisted (gathered) parameters against the one-process fit's, per
#: leaf, ``‖p_ep − p_1‖ / ‖p_1 − p_0‖``, the largest leaf's. Set from
#: readings on the H100 between the launched fit's, 0.209 (an expert's
#: ``we2``: adam's first steps move an element by about lr·sign(g), and a
#: token routed elsewhere moves its expert's gradient by its share), and
#: the planted fault's, 1.191 (PERF.md §6)
SEQ_MOE_PARAM_RTOL = 0.5
SEQ_MOE_LINE = {
    "dist": LAUNCH_LINE["dist"],
    "fit": re.compile(
        r"expert-parallel fit: process (\d+) of (\d+) at (\{.*?\}) \(backend "
        r"(\w+), (\S+)\): experts \[(\d+), (\d+)\) of (\d+); we1 (\[.*?\]), "
        r"be1 (\[.*?\]), we2 (\[.*?\]), be2 (\[.*?\]); (\d+) steps of (\d+) "
        r"rows a member \(local batch (\d+)\); stage ([\d.]+) s, train "
        r"([\d.]+) s, all-to-all ([\d.]+) ms a step \((\d+) bytes a step\), "
        r"counts ([\d.]+) ms a step, data all-reduce ([\d.]+) ms a step; kept "
        r"and dropped tokens a layer in the last step (\[\[.*?\]\]); loss "
        r"(\S+); model digest (\w+), equal on every process; peak device "
        r"memory (\d+) bytes; attention launches (\{.*\})"),
}


def seq_moe_train(registry, variant_path, backend, **env):
    """``launch -n 2 train -v <variant> --mesh-axes '{"expert": 2}'`` of
    the sequential template with ``numExperts`` through the CLI,
    in-process; every process's lines held (exit 0, the backend, on the
    card, its half of the experts and their shapes, rows a member, K4
    forward and backward launched, bytes sent, equal losses and model
    digests), then the new COMPLETED instance and its model."""
    from incubator_predictionio_tpu_torch.utils.serialization import (
        deserialize_model,
    )

    tag = f"seq-moe {backend}"
    insts = registry.get_storage().get_meta_data_engine_instances()
    before = {i.id for i in insts.get_all()}
    with env_vars(PYTHONPATH=str(Path(__file__).resolve().parent), **env):
        t0 = time.perf_counter()
        out = cli_run(tag, ["launch", "-n", str(LAUNCH_PROCS), "--timeout",
                            str(LAUNCH_TIMEOUT_S), "train", "-v", variant_path,
                            "--mesh-axes", SEQ_MOE_AXES])
        wall = time.perf_counter() - t0
    OUT.parent.mkdir(parents=True, exist_ok=True)
    (OUT.parent / f"seq_moe_{backend}.log").write_text(out)
    d, dh, e, ep = SEQ_D, 4 * SEQ_D, SEQ_MOE_EXPERTS, LAUNCH_PROCS
    shapes = [[e // ep, d, dh], [e // ep, dh], [e // ep, dh, d], [e // ep, d]]
    per = []
    for p in launch_sections(out, SEQ_MOE_LINE, tag):
        dist, f = p["dist"], p["fit"]
        k = p["process"]
        got = [json.loads(x) for x in f[8:12]]
        att = json.loads(f[25])
        check(dist[2] == backend == f[3] and dist[3].startswith("cuda")
              and (int(f[5]), int(f[6]), int(f[7])) == (k * e // ep,
                                                        (k + 1) * e // ep, e)
              and got == shapes and int(f[13]) == TRAIN_BATCH // ep
              and int(f[18]) > 0,
              f"[{tag}] process {k}: {dist} {f[:19]}")
        for w in ("causal_mha_small_head", "causal_mha_small_head_bwd"):
            check(att.get(w, 0) > 0, f"[{tag}] process {k}: {w} never "
                  f"launched: {att}")
        per.append({"process": k, "device": dist[3],
                    "coords": json.loads(f[2]),
                    "experts": [int(f[5]), int(f[6])], "we1": got[0],
                    "be1": got[1], "we2": got[2], "be2": got[3],
                    "steps": int(f[12]), "member_rows": int(f[13]),
                    "local_batch": int(f[14]), "stage_s": float(f[15]),
                    "train_s": float(f[16]),
                    "all_to_all_ms_per_step": float(f[17]),
                    "all_to_all_bytes_per_step": int(f[18]),
                    "counts_ms_per_step": float(f[19]),
                    "data_all_reduce_ms_per_step": float(f[20]),
                    "kept_dropped_last_step": json.loads(f[21]),
                    "loss": float(f[22]), "digest": f[23],
                    "peak_bytes": int(f[24]), "attention_launches": att})
    check(len({q["digest"] for q in per}) == 1 and len({q["loss"] for q in per}) == 1,
          f"[{tag}] model digests or losses differ: {per}")
    new = [i for i in insts.get_all() if i.id not in before]
    check([i.status for i in new] == ["COMPLETED"],
          f"[{tag}] new instances {[(i.id, i.status) for i in new]}")
    blob = registry.get_storage().get_model_data_models().get(new[0].id)
    check(blob is not None, f"[{tag}] no model blob")
    return {"processes": per, "wall_s": wall,
            "model": deserialize_model(blob.models)[0]}


def moe_layer_check(ttr, cfg, td, dev) -> dict:
    """The MoE layer (``moe_ffn``, layer 0's initial weights) on the card
    against the port's CPU path on the same input: the first
    :data:`SEQ_MOE_LAYER_ROWS` rows of the training data, their embeddings
    through layer 0's second norm. Held: the share of real tokens whose
    expert or keep differs (printed; a near-tie of the router's bf16 logits
    may flip); where the routing agrees, ``y`` within :data:`ATT_TOL`
    (absolute and relative, the reference's band for the bf16 products);
    the auxiliary loss 1e-3 relative. Its forward's time on the card at
    the training batch (64 rows) beside it."""
    init = ttr._init_params(cfg, torch.Generator(device=dev).manual_seed(cfg.seed), dev)
    layer = init["layers"][0]
    weights = [layer[k] for k in ("wr", "we1", "be1", "we2", "be2")]

    def inputs(rows):
        tokens = torch.from_numpy(np.ascontiguousarray(
            td.sequences[:rows, :-1], np.int64)).to(dev)
        positions = torch.arange(cfg.max_len, device=dev).expand(rows, cfg.max_len)
        h = init["item_emb"][tokens] + init["pos_emb"][positions]
        return ttr._ln(h, layer["ln2"]["g"], layer["ln2"]["b"]), tokens != 0

    factor = cfg.expert_capacity_factor
    with torch.no_grad():
        x, mask = inputs(SEQ_MOE_LAYER_ROWS)
        y, aux, (chosen, keep) = ttr.moe_ffn(x, mask, *weights, factor)
        yc, auxc, (cc, kc) = ttr.moe_ffn(x.cpu(), mask.cpu(),
                                         *(w.cpu() for w in weights), factor)
        m = mask.cpu().reshape(-1)
        differ = ((chosen.cpu() != cc) | (keep.cpu() != kc)) & m
        agree = (~differ).reshape(SEQ_MOE_LAYER_ROWS, cfg.max_len)
        d = (y.cpu() - yc).abs()[agree]
        ok = bool((d <= ATT_TOL + ATT_TOL * yc.abs()[agree]).all())
        xb, mb = inputs(TRAIN_BATCH)
        layer_ms = time_ms(lambda: ttr.moe_ffn(xb, mb, *weights, factor),
                           reps=5, inner=3)
    # one forward and backward of the layer at the training batch, by op
    xg = xb.detach().requires_grad_(True)
    params = [w.detach().clone().requires_grad_(True) for w in weights]

    def fwd_bwd():
        y_, aux_, _ = ttr.moe_ffn(xg, mb, *params, factor)
        torch.autograd.grad(y_.sum() + aux_, [xg, *params])

    fwd_bwd()
    torch.cuda.synchronize()
    with cuda_profile() as by_name:
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile = busy_record(by_name, wall, 8)
    out = {"rows": SEQ_MOE_LAYER_ROWS, "real_tokens": int(m.sum()),
           "routing_differs": int(differ.sum()),
           "routing_differs_share": float(differ.sum()) / max(int(m.sum()), 1),
           "kept": int(keep.sum()), "y_max_abs_diff": float(d.max()),
           "aux_card": float(aux), "aux_cpu": float(auxc),
           "aux_rel": abs(float(aux) - float(auxc)) / abs(float(auxc)),
           "forward_ms_batch64": layer_ms, "fwd_bwd_profile_batch64": profile}
    check(torch.isfinite(y).all().item(), "[seq-moe] non-finite MoE output")
    check(ok, f"[seq-moe] the MoE layer on the card differs from the CPU "
          f"beyond {ATT_TOL} where the routing agrees: {out}")
    check(out["aux_rel"] <= 1e-3, f"[seq-moe] aux on the card {out}")
    del init
    return out


#: the dropped-token check: seq-moe's MoE layer at its full shape (batch
#: 64, max_len 512, d_model 512, 8 experts) over a two-process ``expert``
#: line, at capacity factor 0.5 on inputs with 128-512 real tokens a row:
#: capacity int(0.5·32,768/8) = 2,048 an expert against ~2,560 real tokens
#: an expert, so every expert drops (seq-moe's own data drops none)
SEQ_MOE_DROP_FACTOR = 0.5
SEQ_MOE_DROP_SHAPE = (TRAIN_BATCH, 512, SEQ_D, SEQ_MOE_EXPERTS)
SEQ_MOE_DROP_SEED = 47
#: the members' routing against the plain router's on the whole batch:
#: the share of real tokens that may pick another expert (a near-tie of
#: bf16 logits summed in another order; routing the wrong rows moves 7 of
#: 8)
SEQ_MOE_DROP_FLIPS = 1e-2
MOE_DROP_MEMBER = """
import sys
import chip_smoke
chip_smoke.moe_drop_member(sys.argv[1], sys.argv[2],
                           [int(v) for v in sys.argv[3].split(",")])
"""


def moe_drop_case(dev, shape):
    """The dropped-token check's inputs from :data:`SEQ_MOE_DROP_SEED`:
    ``x`` ``[B, L, d]`` N(0, 1) (a normed activation), the real tokens the
    last 1/4 to all of each row, and the layer's weights at the
    reference's init scales with random biases (an expert's bias shows in
    every slot it runs, empty or not)."""
    b, l, d, e = shape
    g = torch.Generator().manual_seed(SEQ_MOE_DROP_SEED)
    x = torch.randn(b, l, d, generator=g)
    lengths = torch.randint(l // 4, l + 1, (b,), generator=g)
    mask = torch.arange(l)[None, :] >= (l - lengths)[:, None]
    weights = (torch.randn(d, e, generator=g) * d ** -0.5,
               torch.randn(e, d, 4 * d, generator=g) * d ** -0.5,
               torch.randn(e, 4 * d, generator=g) * 0.1,
               torch.randn(e, 4 * d, d, generator=g) * (4 * d) ** -0.5,
               torch.randn(e, d, generator=g) * 0.1)
    return x.to(dev), mask.to(dev), [w.to(dev) for w in weights]


def moe_drop_member(out_path, device, shape):
    """One member of the dropped-token check (a process of the job that
    ``PIO_DIST_*`` describes, on ``device``): the MoE layer over an
    ``expert`` line of the job's processes, this member's rows of the
    batch and its experts, at :data:`SEQ_MOE_DROP_FACTOR`; its output,
    routing and kept/dropped counts saved to ``out_path``."""
    from incubator_predictionio_tpu_torch.models.transformer import (
        ExpertParallel,
        moe_ffn,
    )
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

    world = int(os.environ["PIO_DIST_NUM_PROCESSES"])
    ctx = DeviceContext.create(device, distributed=True, axes={"expert": world})
    try:
        b, l, _, e = shape
        x, mask, (wr, we1, be1, we2, be2) = moe_drop_case(ctx.device, shape)
        experts = ExpertParallel(ctx, e, b * l)
        lo, hi = experts.rank * b // experts.size, (experts.rank + 1) * b // experts.size
        own = slice(experts.first, experts.first + experts.local)
        with torch.no_grad():
            y, aux, (chosen, keep) = moe_ffn(
                x[lo:hi], mask[lo:hi], wr, we1[own], be1[own], we2[own],
                be2[own], SEQ_MOE_DROP_FACTOR, experts)
        torch.save({"y": y.cpu(), "aux": float(aux), "chosen": chosen.cpu(),
                    "keep": keep.cpu(), "kept_dropped": experts.stats[0],
                    "bytes": experts.bytes, "backend": ctx.backend,
                    "device": str(ctx.device), "experts": [own.start, own.stop]},
                   out_path)
    finally:
        ctx.stop()


def plain_kept(chosen, real, n_experts, capacity):
    """Each real token kept when fewer than ``capacity`` real tokens of its
    expert precede it (numpy, token order)."""
    pos = np.zeros(len(chosen), np.int64)
    for k in range(n_experts):
        mine = np.flatnonzero((chosen == k) & real)
        pos[mine] = np.arange(len(mine))
    return real & (pos < capacity)


def moe_drop_reference(x, mask, weights, chosen, factor):
    """The plain MoE layer on the whole batch with the given routing
    ``chosen`` ``[S]``: each expert's real tokens counted in token order
    (numpy), those below the capacity kept; each kept token's row through
    its expert alone (bf16 products as the reference's), times its bf16
    gate; the auxiliary loss over the real tokens. Returns (y ``[S, d]``,
    keep, aux, the router's own choice)."""
    wr, we1, be1, we2, be2 = weights
    b, l, d = x.shape
    e, s = wr.shape[1], b * l
    xf, m = x.reshape(s, d), mask.reshape(s).cpu().numpy()
    probs = torch.softmax((xf.bfloat16() @ wr.bfloat16()).float(), dim=-1)
    ch = chosen.numpy()
    keep = plain_kept(ch, m, e, max(1, int(factor * s / e)))
    y = torch.zeros(s, d, device=x.device)
    for k in range(e):
        rows = torch.from_numpy(np.flatnonzero(keep & (ch == k))).to(x.device)
        h = torch.nn.functional.gelu(
            (xf[rows].bfloat16() @ we1[k].bfloat16()).float() + be1[k],
            approximate="tanh")
        out = ((h.bfloat16() @ we2[k].bfloat16()).float() + be2[k]).bfloat16().float()
        gate = probs[rows, k].bfloat16().float()
        y[rows] = (gate[:, None] * out).bfloat16().float()
    mt = torch.from_numpy(m).to(x.device)
    n_real = max(int(m.sum()), 1)
    frac = torch.from_numpy(np.bincount(ch[m], minlength=e) / n_real).to(x.device)
    aux = e * float((frac * ((probs * mt[:, None]).sum(0) / n_real)).sum())
    return y, keep, aux, torch.argmax(probs, dim=-1).cpu().numpy()


def moe_drop_check(dev, shape=SEQ_MOE_DROP_SHAPE, procs=LAUNCH_PROCS) -> dict:
    """The MoE layer over a ``procs``-process ``expert`` line where the
    capacity binds (:data:`SEQ_MOE_DROP_FACTOR`): the members (fresh
    processes, gloo, on ``dev``; on the card all on its first) run
    :func:`moe_drop_member`, and their rows joined in member order are
    held to :func:`moe_drop_reference` on the whole batch with the members'
    routing — the kept tokens equal, each member's kept and dropped counts
    those of the global batch, tokens dropped, ``y`` 0 where a token is
    dropped or padding and within :data:`ATT_TOL` where kept, the aux
    shares' sum 1e-3 relative; the members' routing against the plain
    router's within :data:`SEQ_MOE_DROP_FLIPS`. Beside it, the tokens a
    local capacity (each member's own count against its own S) would keep
    otherwise: what the check sees of that fault. Returns the record."""
    from incubator_predictionio_tpu_torch.parallel.launcher import free_port

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent),
               PIO_DIST_COORDINATOR=f"127.0.0.1:{free_port()}",
               PIO_DIST_NUM_PROCESSES=str(procs))
    if torch.device(dev).type == "cuda":
        env["CUDA_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"member{i}.pt") for i in range(procs)]
        members = [subprocess.Popen(
            [sys.executable, "-c", MOE_DROP_MEMBER, paths[i],
             "cuda:0" if torch.device(dev).type == "cuda" else str(dev),
             ",".join(map(str, shape))],
            env=dict(env, PIO_DIST_PROCESS_ID=str(i)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(procs)]
        try:
            logs = [p.communicate(timeout=300)[0] for p in members]
        finally:
            for p in members:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, p in enumerate(members):
            check(p.returncode == 0, f"[seq-moe drops] member {i} exited "
                  f"{p.returncode}: {logs[i][-2000:]}")
        got = [torch.load(q) for q in paths]
    wall = time.perf_counter() - t0
    b, l, d, e = shape
    x, mask, weights = moe_drop_case(dev, shape)
    chosen = torch.cat([g["chosen"] for g in got])
    keep = torch.cat([g["keep"] for g in got]).numpy()
    y = torch.cat([g["y"] for g in got]).reshape(b * l, d)
    with torch.no_grad():
        y_ref, keep_ref, aux_ref, own = moe_drop_reference(
            x, mask, weights, chosen, SEQ_MOE_DROP_FACTOR)
    y_ref = y_ref.cpu()
    m = mask.reshape(-1).cpu().numpy()
    real, kept = int(m.sum()), int(keep_ref.sum())
    flips = int(((own != chosen.numpy()) & m).sum())
    # a local capacity: each member counts from 0 against its own S
    per = b * l // procs
    local = np.concatenate([plain_kept(
        chosen.numpy()[i * per:(i + 1) * per], m[i * per:(i + 1) * per], e,
        max(1, int(SEQ_MOE_DROP_FACTOR * per / e))) for i in range(procs)])
    off = ~keep_ref
    diff = (y - y_ref).abs()[torch.from_numpy(keep_ref)]
    y_ok = bool((diff <= ATT_TOL + ATT_TOL * y_ref.abs()[torch.from_numpy(keep_ref)]).all())
    aux = sum(g["aux"] for g in got)
    rec = {"shape": list(shape), "factor": SEQ_MOE_DROP_FACTOR,
           "capacity": max(1, int(SEQ_MOE_DROP_FACTOR * b * l / e)),
           "real_tokens": real, "kept": kept, "dropped": real - kept,
           "members": [{k: g[k] for k in ("kept_dropped", "bytes", "backend",
                                          "device", "experts")} for g in got],
           "routing_flips": flips,
           "keep_equal": bool((keep == keep_ref).all()),
           "y_max_abs_diff_kept": float(diff.max()) if diff.numel() else 0.0,
           "y_zero_elsewhere": bool((y[torch.from_numpy(off)] == 0).all()),
           "aux": aux, "aux_ref": aux_ref,
           "aux_rel": abs(aux - aux_ref) / abs(aux_ref),
           "local_capacity_differs": int((local != keep_ref).sum()),
           "wall_s": wall}
    check(rec["dropped"] > 0, f"[seq-moe drops] no token dropped: {rec}")
    check(flips <= SEQ_MOE_DROP_FLIPS * real,
          f"[seq-moe drops] the members route {flips} of {real} real tokens "
          f"elsewhere than the plain router: {rec}")
    check(rec["keep_equal"], f"[seq-moe drops] the members keep other "
          f"tokens than the global batch's capacity: {rec}")
    check(all(tuple(q["kept_dropped"]) == (kept, real - kept)
              for q in rec["members"]),
          f"[seq-moe drops] a member's kept/dropped counts: {rec}")
    check(rec["y_zero_elsewhere"] and y_ok and torch.isfinite(y).all().item(),
          f"[seq-moe drops] y against the plain layer beyond {ATT_TOL} where "
          f"kept, or not 0 elsewhere: {rec}")
    check(rec["aux_rel"] <= 1e-3, f"[seq-moe drops] aux shares: {rec}")
    check(rec["local_capacity_differs"] > 0, f"[seq-moe drops] a local "
          f"capacity would keep the same tokens: the case cannot see it: {rec}")
    return rec


def planted_route_fault(ttr, cfg, ctx, td):
    """The one-process MoE fit with one member's returned rows dropped (a
    control the parameter band must catch): in each layer, the tokens of
    the batch's second half routed to the first half of the experts (what
    the second member of ``{"expert": 2}`` gets back from the first) keep
    the residual alone. Returns its parameters and step losses."""
    real = ttr.moe_ffn

    def dropped(x, token_mask, *args, **kw):
        y, aux, (chosen, keep) = real(x, token_mask, *args, **kw)
        b = x.shape[0]
        lost = (chosen.reshape(b, -1) < args[0].shape[1] // 2)
        lost[: b // 2] = False
        return y * (~lost)[..., None], aux, (chosen, keep)

    ttr.moe_ffn = dropped
    try:
        bad = ttr.TransformerRecommender(cfg).fit(ctx, td.sequences,
                                                  td.item_map)
    finally:
        ttr.moe_ffn = real
    return bad.params, np.asarray(bad.step_losses)


class PinnedRouting:
    """The router of ``models.transformer`` (``_route``) wrapped: in each
    layer's first call it records its tokens' experts, and every later
    call routes with them, the gate staying the router's probability of
    that expert (a step with the kernels, then one with the plain
    attention on the same routing: a token whose router logits are a
    near-tie may pick another expert under the other attention's
    roundings, and then its expert's gradient moves by that token's share,
    which is not the kernels' error). ``moe_ffn`` is wrapped only to learn
    the layer of each call. ``pin=False`` records each call's routing
    only."""

    def __init__(self, ttr, pin: bool = True):
        self.ttr, self.pin = ttr, pin
        self.real, self.real_route = ttr.moe_ffn, ttr._route
        self.routes: dict = {}
        self.calls: list = []

    def __enter__(self):
        layer = {}

        def ffn(x, token_mask, *args, index=0, **kw):
            layer["index"], layer["mask"] = index, token_mask.reshape(-1)
            return self.real(x, token_mask, *args, index=index, **kw)

        def route(x, wr):
            probs, chosen = self.real_route(x, wr)
            index = layer["index"]
            if self.pin and index in self.routes:
                chosen = self.routes[index]
            self.routes.setdefault(index, chosen.detach())
            self.calls.append((index, chosen.detach(), layer["mask"]))
            return probs, chosen

        self.ttr.moe_ffn, self.ttr._route = ffn, route
        return self

    def __exit__(self, *exc):
        self.ttr.moe_ffn, self.ttr._route = self.real, self.real_route


def moe_step_parity(ttr, cfg, batch, dev) -> dict:
    """:func:`step_parity` for a mixture of experts: the step with the
    plain attention routes each token to the expert the kernels' step
    chose (:class:`PinnedRouting`), so that the gradients hold what the
    attention kernels compute; beside it, the real tokens each layer routes
    elsewhere when the plain attention's forward routes for itself."""
    from incubator_predictionio_tpu_torch.parallel.ring import (
        causal_attention_reference,
    )

    with PinnedRouting(ttr):
        out = step_parity(cfg, batch, dev)
    init = ttr._init_params(cfg, torch.Generator(device=dev).manual_seed(cfg.seed), dev)
    net = ttr.TransformerNet(init, cfg, dev)
    flips = []
    with torch.no_grad(), PinnedRouting(ttr, pin=False) as rec:
        net(batch[0], batch[1], ttr.causal_attention)
        net(batch[0], batch[1], causal_attention_reference)
    n = cfg.n_layers
    for (i, a, m), (_, b, _) in zip(rec.calls[:n], rec.calls[n:]):
        flips.append(int(((a != b) & m).sum()))
    out["unpinned_routing_flips_by_layer"] = flips
    out["real_tokens"] = int(batch[0].ne(0).sum())
    del net, init
    return out


class ScoreSpy:
    """Records each ``next_item_scores`` call of the served model (the rows
    of a served batch and its scores), so that a burst's answers can be
    held to the plain attention's on the very batches the server formed:
    a mixture of experts' capacity, and so its routing, is the batch's."""

    def __init__(self, ttr):
        self.ttr, self.calls = ttr, []
        self.real = ttr.TransformerRecommender.next_item_scores

    def __enter__(self):
        real, calls = self.real, self.calls

        def spy(model, rows, attention=self.ttr.causal_attention):
            scores = real(model, rows, attention)
            calls.append((np.array(rows), scores))
            return scores

        self.ttr.TransformerRecommender.next_item_scores = staticmethod(spy)
        return self

    def __exit__(self, *exc):
        self.ttr.TransformerRecommender.next_item_scores = staticmethod(self.real)


def check_same_batches(model, calls, payloads, bodies):
    """Every served answer against the plain attention's forward of the
    batch it was served in (:class:`ScoreSpy`), on the card, by
    :func:`check_against_plain`. Returns the largest difference, the
    counts of equal sets and orders, and the batch sizes."""
    from incubator_predictionio_tpu_torch.models.transformer import (
        TransformerRecommender,
    )
    from incubator_predictionio_tpu_torch.parallel.ring import (
        causal_attention_reference,
    )
    from incubator_predictionio_tpu_torch.templates.sequential import (
        encode_session,
    )

    where = {}
    for rows, _ in calls:
        plain = TransformerRecommender.next_item_scores(
            model, rows, attention=causal_attention_reference)
        for i, row in enumerate(rows):
            where[row.tobytes()] = plain[i]
    keys = [encode_session(p["recentItems"], model.item_map,
                           model.config.max_len).astype(calls[0][0].dtype).tobytes()
            for p in payloads]
    check(all(k in where for k in keys),
          "[seq-moe] a query's row was not among the served batches")
    worst, same_set, same_order = check_against_plain(
        model, payloads, bodies, [where[k] for k in keys], "[seq-moe] ")
    return worst, same_set, same_order, [len(r) for r, _ in calls]


async def seq_moe_body(sessions_, session, url, server, lat):
    """Bursts of 64 ``recentItems`` queries through the MoE model's K4
    forward, each recorded batch held to the plain attention's."""
    from incubator_predictionio_tpu_torch.models import transformer as ttr

    rng = np.random.default_rng(43)
    lat["burst64"] = []
    with ScoreSpy(ttr) as spy:
        for _ in range(3):
            pick = rng.choice(len(sessions_), 64, replace=False)
            payloads = [{"recentItems": list(sessions_[int(j)][:-1]), "num": 10}
                        for j in pick]
            spy.calls.clear()
            t0 = time.perf_counter()
            bodies, _ = await post_all(session, url, payloads, True)
            lat["burst64"].append(time.perf_counter() - t0)
    check_answers(payloads, bodies)
    worst, same_set, same_order, sizes = check_same_batches(
        server.deployed.models[0], spy.calls, payloads, bodies)
    return {"max_score_diff": worst, "same_set": same_set,
            "same_order": same_order, "served_batches": sizes}


def seq_moe_phase(ctx, tmp):
    """Mixture-of-experts training and serving of the sequential template
    at its full width with Switch-Base-8's routing (``numExperts`` 8,
    capacity factor 1.25, auxiliary weight 1e-2), on seq-tp's app
    ``seqtp`` (256 users, 4 steps of 64): (a) a one-process MoE fit in this
    process (the degradation recorded: no ``expert`` axis), after one step
    with K4 against one with the plain attention from the same init, the
    MoE layer on the card against the CPU, and the layer over a two-process
    ``expert`` line where tokens drop (:func:`moe_drop_check`); (b)
    ``launch -n 2 train --mesh-axes '{"expert": 2}'``, two processes on
    ``cuda:0`` (gloo),
    each holding 4 of the 8 experts and 32 rows of each batch (K4 at (32,
    8, 512, 64) forward and backward), the kept tokens' rows exchanged by
    two all-to-alls a layer: its step losses within
    :data:`SEQ_MOE_LOSS_RTOL` of (a)'s, its persisted parameters within
    :data:`SEQ_MOE_PARAM_RTOL` of (a)'s update, and a planted fault (one
    member's returned rows dropped) beyond it; with two cards the same
    launch over NCCL, bitwise the gloo run; (c) a deploy of the persisted
    model and bursts through K4, each served batch held to the plain
    attention's forward of that batch. Returns (launches of the attention
    kernels in this process's fit and serving, record)."""
    from incubator_predictionio_tpu_torch.models import transformer as ttr
    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.sharding import degrade
    from incubator_predictionio_tpu_torch.templates import sequential as tseq

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "seq-workflow")
    sessions_ = cycle_sessions(np.random.default_rng(31), SEQ_WF_USERS,
                               SEQ_WF_MAX_LEN, SEQ_WF_LENGTHS)[:SEQ_TP_USERS]
    params = {"maxLen": SEQ_WF_MAX_LEN, "dModel": SEQ_D, "nHeads": SEQ_HEADS,
              "nLayers": SEQ_LAYERS, "learningRate": TRAIN_LR,
              "batchSize": TRAIN_BATCH, "epochs": SEQ_TP_EPOCHS,
              "numExperts": SEQ_MOE_EXPERTS}
    with cli_storage(root) as registry:
        variant_path = os.path.join(root, "engine-moe.json")
        with open(variant_path, "w") as f:
            json.dump({"id": "seq-moe", "version": "1",
                       "engineFactory": SEQ_FACTORY,
                       "datasource": {"params": {"appName": "seqtp",
                                                 "maxLen": SEQ_WF_MAX_LEN}},
                       "algorithms": [{"name": "transformer",
                                       "params": params}]}, f)
        ds = tseq.DataSource(tseq.DataSourceParams(app_name="seqtp",
                                                   max_len=SEQ_WF_MAX_LEN))
        td = ds.read_training(ctx)
        cfg = ttr.TransformerConfig(
            vocab_size=len(td.item_map) + 1, max_len=SEQ_WF_MAX_LEN,
            d_model=SEQ_D, n_heads=SEQ_HEADS, n_layers=SEQ_LAYERS,
            learning_rate=TRAIN_LR, batch_size=TRAIN_BATCH,
            epochs=SEQ_TP_EPOCHS, n_experts=SEQ_MOE_EXPERTS)
        check((cfg.expert_capacity_factor, cfg.router_aux_weight) == (1.25, 1e-2),
              f"[seq-moe] not Switch-Base-8's routing: {cfg}")
        # the rows in the launched fit's order: the one-process fit is its
        # reference
        td = launched_rows(td, cfg)
        # (a) one process: the kernels against the plain attention on one
        # step, the layer on the card against the CPU, then the fit
        seqs = td.sequences[:TRAIN_BATCH]
        tokens = torch.from_numpy(np.ascontiguousarray(seqs[:, :-1], np.int64)).to(ctx.device)
        targets = torch.from_numpy(np.ascontiguousarray(seqs[:, 1:], np.int64)).to(ctx.device)
        weights = ((targets != 0) & (tokens != 0)).float()
        positions = torch.arange(cfg.max_len, device=ctx.device).expand(
            tokens.shape[0], cfg.max_len)
        parity = moe_step_parity(ttr, cfg, (tokens, positions, targets, weights),
                                 ctx.device)
        del tokens, targets, weights, positions
        layer = moe_layer_check(ttr, cfg, td, ctx.device)
        drops = moe_drop_check(ctx.device)
        gc.collect()
        torch.cuda.empty_cache()
        degrade.reset()
        A.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = ttr.TransformerRecommender(cfg).fit(ctx, td.sequences, td.item_map)
        one_s = time.perf_counter() - t0
        fit_launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
        one_peak = torch.cuda.max_memory_allocated()
        check([d["axis"] for d in degrade.degradations()] == ["expert"],
              f"[seq-moe] the one-process fit's degradation: "
              f"{degrade.degradations()}")
        check(np.isfinite(one.final_loss) and one.params["layers"][0]["we1"].shape
              == (SEQ_MOE_EXPERTS, SEQ_D, 4 * SEQ_D),
              f"[seq-moe] the one-process fit: loss {one.final_loss}")
        for w in ("causal_mha_small_head", "causal_mha_small_head_bwd"):
            check(fit_launches[w] > 0, f"[seq-moe] {w} never launched in the "
                  f"one-process fit: {fit_launches}")
        # (b) expert-parallel over two processes on this card
        first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        launched = seq_moe_train(registry, variant_path, "gloo",
                                 CUDA_VISIBLE_DEVICES=first)
        per, model, wall = (launched["processes"], launched["model"],
                            launched["wall_s"])
        check(model.config.n_experts == SEQ_MOE_EXPERTS and all(
            np.shape(model.params["layers"][i][n]) == shape
            for i in range(SEQ_LAYERS)
            for n, shape in (("we1", (SEQ_MOE_EXPERTS, SEQ_D, 4 * SEQ_D)),
                             ("be1", (SEQ_MOE_EXPERTS, 4 * SEQ_D)),
                             ("we2", (SEQ_MOE_EXPERTS, 4 * SEQ_D, SEQ_D)),
                             ("be2", (SEQ_MOE_EXPERTS, SEQ_D)),
                             ("wr", (SEQ_D, SEQ_MOE_EXPERTS)))),
              "[seq-moe] the persisted model is not in the canonical layout")
        check(dict(td.item_map.items()) == dict(model.item_map.items()),
              "[seq-moe] the launched fit's item map differs")
        got, want = np.asarray(model.step_losses), np.asarray(one.step_losses)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        check(got.shape == want.shape and rel <= SEQ_MOE_LOSS_RTOL,
              f"[seq-moe] step losses {got.tolist()} against the one-process "
              f"fit's {want.tolist()}: {rel:.3e} relative (band "
              f"{SEQ_MOE_LOSS_RTOL})")
        p0 = _tree_numpy(ttr._init_params(
            cfg, torch.Generator(device=ctx.device).manual_seed(cfg.seed),
            ctx.device))
        param_rel, param_leaf = update_rel(model.params, one.params, p0)
        fault, fault_losses = planted_route_fault(ttr, cfg, ctx, td)
        fault_loss_rel = float(np.max(np.abs(fault_losses - want) / np.abs(want)))
        fault_rel, fault_leaf = update_rel(fault, one.params, p0)
        del fault, p0
        check(param_rel <= SEQ_MOE_PARAM_RTOL,
              f"[seq-moe] the persisted parameters are {param_rel:.3e} of the "
              f"one-process fit's update apart at {param_leaf} (band "
              f"{SEQ_MOE_PARAM_RTOL})")
        check(fault_rel > SEQ_MOE_PARAM_RTOL,
              f"[seq-moe] the band {SEQ_MOE_PARAM_RTOL} does not see one "
              f"member's returned rows dropped: the planted fault's "
              f"parameters {fault_rel:.3e} apart at {fault_leaf}")
        nccl = None
        if torch.cuda.device_count() >= LAUNCH_PROCS:
            again = seq_moe_train(registry, variant_path, "nccl")
            nccl = {"processes": again["processes"], "wall_s": again["wall_s"],
                    "bitwise_gloo": bitwise_trees(again["model"].params,
                                                  model.params)}
            check(nccl["bitwise_gloo"], "[seq-moe] the NCCL launch's "
                  "parameters differ from the gloo launch's")
            del again
        del one
        gc.collect()
        torch.cuda.empty_cache()
        # (c) the persisted model served through K4
        lat = {}
        A.reset_launches()
        served = asyncio.run(serve_phase(
            "seq-moe", variant_path, registry.get_storage(), ctx,
            lambda s, u, srv: seq_moe_body(sessions_, s, u, srv, lat)))
        serve_launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    check(serve_launches["causal_mha_small_head"] > 0,
          f"[seq-moe] K4 never launched serving the model: {serve_launches}")
    launches = {k: fit_launches[k] + serve_launches[k] for k in fit_launches}
    train_wall = max(q["train_s"] for q in per)
    rec = {"launch_wall_s": wall, "processes": per, "nccl": nccl,
           "card_count": torch.cuda.device_count(), "rows": len(td.sequences),
           "step_parity": parity, "moe_layer": layer, "drops": drops,
           "one_process": {"train_s": one_s, "peak_bytes": one_peak,
                           "step_losses": want.tolist(),
                           "launches": fit_launches,
                           "train_tokens_per_s": want.size * TRAIN_BATCH
                           * SEQ_WF_MAX_LEN / one_s},
           "steps": per[0]["steps"], "step_losses": got.tolist(),
           "step_loss_max_rel": rel, "step_loss_band": SEQ_MOE_LOSS_RTOL,
           "param_update_rel": param_rel, "param_update_rel_leaf": param_leaf,
           "param_update_rel_band": SEQ_MOE_PARAM_RTOL,
           "planted_fault": {"param_update_rel": fault_rel,
                             "param_update_rel_leaf": fault_leaf,
                             "step_loss_max_rel": fault_loss_rel},
           "train_tokens_per_s": per[0]["steps"] * TRAIN_BATCH
           * SEQ_WF_MAX_LEN / train_wall,
           "burst64_ms": [x * 1e3 for x in lat["burst64"]],
           "burst64_p50_ms": pct(lat["burst64"], 50),
           "kernels_vs_plain": served, "serve_launches": serve_launches,
           "phase_s": time.perf_counter() - t_phase}
    smi = smi_name_power()
    log(f"[seq-moe] ({smi}) {SEQ_MOE_EXPERTS} experts, capacity factor "
        f"{cfg.expert_capacity_factor}, aux {cfg.router_aux_weight}, at "
        f"max_len {cfg.max_len}, d_model {cfg.d_model}, {cfg.n_layers} layers "
        f"of {cfg.n_heads} heads, batch {cfg.batch_size}, {len(td.sequences)} "
        f"rows: kernels vs plain one step (the plain step on the kernels' "
        f"routing): loss rel {parity['loss_rel_diff']:.3e}, worst gradient "
        f"{parity['grad_worst']} {parity['grad_worst_rel_err']:.3e}; the plain "
        f"forward routing for itself moves "
        f"{parity['unpinned_routing_flips_by_layer']} of "
        f"{parity['real_tokens']} real tokens a layer")
    log(f"[seq-moe] ({smi}) the MoE layer on the card vs the CPU ({layer['rows']} "
        f"rows, {layer['real_tokens']} real tokens): routing differs for "
        f"{layer['routing_differs']} ({layer['routing_differs_share']:.2e}), y max "
        f"abs diff {layer['y_max_abs_diff']:.3e} where it agrees, aux rel "
        f"{layer['aux_rel']:.2e}; forward at batch 64 {layer['forward_ms_batch64']:.3f} ms; "
        f"forward and backward {layer['fwd_bwd_profile_batch64']['wall_ms']:.3f} ms wall, "
        f"device busy {layer['fwd_bwd_profile_batch64']['device_busy_ms']:.3f} ms, top "
        f"{json.dumps(layer['fwd_bwd_profile_batch64']['top_device_ms'])}")
    log(f"[seq-moe] ({smi}) dropped tokens over a 2-process expert line "
        f"(gloo, {drops['members'][0]['device']}) at factor "
        f"{drops['factor']}, shape {drops['shape']}: capacity "
        f"{drops['capacity']}, {drops['kept']} kept and {drops['dropped']} "
        f"dropped of {drops['real_tokens']} real tokens, as the global "
        f"batch's plain count (a local capacity would differ on "
        f"{drops['local_capacity_differs']}); routing flips "
        f"{drops['routing_flips']}; y max abs diff "
        f"{drops['y_max_abs_diff_kept']:.3e} where kept, 0 elsewhere; aux rel "
        f"{drops['aux_rel']:.2e}; {drops['members'][0]['bytes']} bytes sent a "
        f"member; wall {drops['wall_s']:.1f} s")
    log(f"[seq-moe] ({smi}) one process: {want.size} steps in {one_s:.2f} s, "
        f"{rec['one_process']['train_tokens_per_s']:.1f} train tokens/s, peak "
        f"{one_peak / 2**30:.3f} GiB, attention launches {fit_launches}")
    log(f"[seq-moe] ({smi}) launch -n 2 train --mesh-axes {SEQ_MOE_AXES}: "
        f"{rec['steps']} steps, wall {wall:.2f} s, "
        f"{rec['train_tokens_per_s']:.1f} train tokens/s")
    for q in per:
        log(f"[seq-moe] ({smi}) process {q['process']} at {q['coords']} on "
            f"{q['device']}: experts {q['experts']}, we1 {q['we1']}, we2 "
            f"{q['we2']}, {q['member_rows']} rows a member; train "
            f"{q['train_s']:.3f} s; all-to-all {q['all_to_all_ms_per_step']:.3f} "
            f"ms a step ({q['all_to_all_bytes_per_step']} bytes), counts "
            f"{q['counts_ms_per_step']:.3f} ms, data all-reduce "
            f"{q['data_all_reduce_ms_per_step']:.3f} ms; kept/dropped "
            f"{q['kept_dropped_last_step']}; peak {q['peak_bytes'] / 2**30:.3f} "
            f"GiB; attention launches {q['attention_launches']}")
    log(f"[seq-moe] ({smi}) against the one-process fit: step losses max "
        f"relative {rel:.3e} (band {SEQ_MOE_LOSS_RTOL}), parameters "
        f"{param_rel:.3e} of its update at {param_leaf} (band "
        f"{SEQ_MOE_PARAM_RTOL}); the planted fault (member 1's returned rows "
        f"dropped): parameters {fault_rel:.3e} at {fault_leaf}, step losses "
        f"{fault_loss_rel:.3e}; NCCL {nccl and nccl['bitwise_gloo']}")
    log(f"[seq-moe] ({smi}) burst of 64 p50 {rec['burst64_p50_ms']:.2f} ms "
        f"(served batches {served['served_batches']}), against the plain "
        f"attention of the same batches max score diff "
        f"{served['max_score_diff']:.2e} (sets {served['same_set']}/64, orders "
        f"{served['same_order']}/64); serve launches {serve_launches}; phase "
        f"{rec['phase_s']:.1f} s")
    return launches, rec


# -- phase: the seq and pipe mesh axes: ring attention, the GPipe schedule ---

#: the ring: bench_sequential's long width (bench.py:897-899: vocab 10,000,
#: d_model 512, 6 layers of 8 heads of 64) at max_len 1,024 over a
#: two-process seq line, 512 positions a process; whole rows, batch 32, 2
#: steps (4 took 11.8 s of train a member on an NVIDIA H100 80GB HBM3 at
#: 700.00 W: cut for the time limit, PERF.md §4) of the cycle sessions of
#: SEQ_RING_SEED (256 to 1,025 items)
SEQ_RING_AXES = {"seq": 2}
SEQ_RING_MAX_LEN, SEQ_RING_BATCH, SEQ_RING_ROWS = 1024, 32, 64
SEQ_RING_SEED = 53
#: the ring fit's step losses against a one-process fit with local
#: attention on the plain attention, from the same init on the same
#: batches, relative: the ring rounds p to bf16 unnormalised, the plain
#: attention normalised (tests/test_torch_ring_attention.py's band for the
#: same comparison; 5.2e-5 there). A ring that masks its own chunk fully
#: (the planted fault) gives NaN: a row with nothing to attend
SEQ_RING_LOSS_RTOL = 1e-3
RING_MEMBER = """
import json
import sys
import chip_smoke
chip_smoke.seq_ring_member(sys.argv[1], sys.argv[2], json.loads(sys.argv[3]))
"""
#: the pipe: the first SEQ_PIPE_USERS of seq-workflow's users (app
#: ``seqpipe``; max_len 512, full width, batch 64) over a two-process pipe
#: line, 3 of the 6 layers a stage, 4 microbatches of 16 rows (K4 at (16,
#: 8, 512, 64)), 2 steps (seq-tp's 256 users, 4 steps, took 18.2 s of
#: train a process on an NVIDIA H100 80GB HBM3 at 700.00 W: cut for the
#: time limit, PERF.md §4)
SEQ_PIPE_AXES = '{"pipe": 2}'
SEQ_PIPE_MICROBATCHES = 4
SEQ_PIPE_USERS = 128
#: the launched pipelined fit against a one-process replay from the same
#: init on the same batches (tests/test_torch_pipeline.py's bands for the
#: same comparison: measured 3.3e-6 in loss and 0.062 of the update there;
#: a pipeline that counts the logits' gradient once a stage, 2.98e-4 and
#: 0.488): step losses relative, and ``‖p − p_1‖ / ‖p_1 − p_0‖`` of the
#: largest leaf
SEQ_PIPE_LOSS_RTOL = 1e-4
SEQ_PIPE_PARAM_RTOL = 0.3
SEQ_PIPE_LINE = {
    "dist": LAUNCH_LINE["dist"],
    "fit": re.compile(
        r"pipeline fit: process (\d+) of (\d+) at (\{.*?\}) \(backend (\w+), "
        r"(\S+)\): pipe stage (\d+) of (\d+), layers \[(\d+), (\d+)\) of "
        r"(\d+); (\d+) microbatches of (\d+) rows; (\d+) steps of (\d+) local "
        r"rows; stage ([\d.]+) s, train ([\d.]+) s, handoff ([\d.]+) ms a step "
        r"\((\d+) bytes a step\), gradients ([\d.]+) ms a step; loss (\S+); "
        r"model digest (\w+), equal on every process; peak device memory "
        r"(\d+) bytes; attention launches (\{.*\})"),
}


def ring_sizes() -> dict:
    """The ring check's sizes, handed to its member processes."""
    return {"vocab": SEQ_VOCAB, "max_len": SEQ_RING_MAX_LEN,
            "batch": SEQ_RING_BATCH, "rows": SEQ_RING_ROWS, "d": SEQ_D,
            "heads": SEQ_HEADS, "layers": SEQ_LAYERS, "lr": TRAIN_LR}


def seq_ring_cfg(z: dict):
    from incubator_predictionio_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    return TransformerConfig(
        vocab_size=z["vocab"], max_len=z["max_len"], d_model=z["d"],
        n_heads=z["heads"], n_layers=z["layers"], learning_rate=z["lr"],
        batch_size=z["batch"], epochs=1)


def seq_ring_rows(z: dict) -> np.ndarray:
    """``[rows, max_len + 1]`` token rows: the cycle sessions of
    :data:`SEQ_RING_SEED` (a quarter to all of ``max_len + 1`` items),
    item ``i<n>`` as token ``n + 1`` (below ``vocab``), left-padded."""
    width = z["max_len"] + 1
    sessions = cycle_sessions(np.random.default_rng(SEQ_RING_SEED),
                              z["rows"], z["max_len"], (width // 4, width))
    rows = np.zeros((len(sessions), width), np.int32)
    for r, items in enumerate(sessions):
        rows[r, width - len(items):] = [int(i[1:]) % (z["vocab"] - 1) + 1
                                        for i in items]
    return rows


def ring_layer_case(dev, z: dict):
    """The ring layer's check inputs: q, k, v and the output's cotangent,
    ``[batch, max_len, heads, d / heads]`` fp32 from a seed on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(SEQ_RING_SEED)
    return [torch.randn((z["batch"], z["max_len"], z["heads"],
                         z["d"] // z["heads"]), generator=g, device=dev)
            for _ in range(4)]


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def own_chunk_masked(real):
    """``_chunk_attend`` with the own chunk's causal mask made all -inf (the
    planted fault of the ring's checks)."""
    def attend(q, k, v, mask, m, l, o):
        inf = torch.isinf(mask)
        if bool(inf.any()) and not bool(inf.all()):
            mask = torch.full_like(mask, -torch.inf)
        return real(q, k, v, mask, m, l, o)

    return attend


def seq_ring_member(out_path, device, z: dict):
    """One member of the ring's check (a process of the job ``PIO_DIST_*``
    describes, on ``device``; ``{"seq": 2}``): the ring layer on its chunk
    of :func:`ring_layer_case` forward and backward, then the ring fit of
    :func:`seq_ring_rows` (whole rows: each process stages its 512
    positions of every row), then one step of the planted fault; saves
    what the parent checks to ``out_path``."""
    from incubator_predictionio_tpu_torch.models import transformer as ttr
    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.parallel import ring as tring
    from incubator_predictionio_tpu_torch.parallel.mesh import (
        DeviceContext,
        check_replicas,
    )

    ctx = DeviceContext.create(device, distributed=True, axes=SEQ_RING_AXES)
    try:
        dev = ctx.device
        cuda = dev.type == "cuda"
        lc = z["max_len"] // ctx.axis_size("seq")
        cols = slice(ctx.axis_index("seq") * lc, (ctx.axis_index("seq") + 1) * lc)
        q, k, v, do = ring_layer_case(dev, z)
        qc, kc, vc = (x[:, cols].contiguous().requires_grad_(True)
                      for x in (q, k, v))
        _sync(dev)
        t0 = time.perf_counter()
        out = tring.ring_attention_sharded(qc, kc, vc, ctx)
        out.backward(do[:, cols])
        _sync(dev)
        layer_s = time.perf_counter() - t0
        layer = {"out": out.detach().cpu(), "s": layer_s,
                 "grads": [x.grad.cpu() for x in (qc, kc, vc)]}
        del q, k, v, do, qc, kc, vc, out
        rows, cfg = seq_ring_rows(z), seq_ring_cfg(z)
        A.reset_launches()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        model = ttr.TransformerRecommender(cfg).fit(ctx, rows, None)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
        # equal on both members, or the fit's own check raised
        digest = check_replicas(ctx, list(ttr._leaves(model.params)))
        # the planted fault, one step: the replicas' check would compare
        # NaN parameters, so it is skipped for this fit alone
        real_attend, real_check = tring._chunk_attend, ttr.check_replicas
        tring._chunk_attend = own_chunk_masked(real_attend)
        ttr.check_replicas = lambda *a, **kw: ""
        try:
            bad = ttr.TransformerRecommender(cfg).fit(
                ctx, rows[:z["batch"]], None)
        finally:
            tring._chunk_attend, ttr.check_replicas = real_attend, real_check
        torch.save({"layer": layer, "step_losses": model.step_losses,
                    "timings": model.timings, "digest": digest,
                    "peak_bytes": peak, "launches": launches,
                    "fault_losses": bad.step_losses, "backend": ctx.backend,
                    "device": str(dev), "positions": [cols.start, cols.stop]},
                   out_path)
    finally:
        ctx.stop()


def seq_ring_check(ctx, meanwhile=None) -> tuple[dict, object]:
    """(a) of :func:`seq_axes_phase`: two fresh processes
    (:func:`seq_ring_member`; on one card both on it over gloo, with two
    or more each on its own over NCCL) run the ring layer and the ring fit
    over ``{"seq": 2}``; held: the layer's output within :data:`ATT_TOL`
    of ``causal_attention_reference`` on the card and each gradient
    within :data:`GRAD_TOL` of its max abs; the fit's step losses within
    :data:`SEQ_RING_LOSS_RTOL` of a one-process fit in this process with
    local attention on the plain attention (same init, same batches), the
    planted fault outside it; the replicas' digests equal. ``meanwhile()``
    runs in this process while the members start and run (the phase's
    other half: the script's time limit); returns (the record, what
    ``meanwhile`` returned)."""
    from incubator_predictionio_tpu_torch.models import transformer as ttr
    from incubator_predictionio_tpu_torch.parallel import ring as tring
    from incubator_predictionio_tpu_torch.parallel.launcher import free_port

    dev = ctx.device
    z = ring_sizes()
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent),
               PIO_DIST_COORDINATOR=f"127.0.0.1:{free_port()}",
               PIO_DIST_NUM_PROCESSES=str(LAUNCH_PROCS))
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"member{i}.pt") for i in range(LAUNCH_PROCS)]
        members = [subprocess.Popen(
            [sys.executable, "-c", RING_MEMBER, paths[i],
             "cuda:0" if dev.type == "cuda" else str(dev), json.dumps(z)],
            env=dict(env, PIO_DIST_PROCESS_ID=str(i)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(LAUNCH_PROCS)]
        try:
            other = meanwhile() if meanwhile is not None else None
            # the plain attention of the whole sequence, and the
            # one-process fit with local attention on the plain attention
            q, k, v, do = ring_layer_case(dev, z)
            qr, kr, vr = (x.requires_grad_(True) for x in (q, k, v))
            want = tring.causal_attention_reference(qr, kr, vr)
            want.backward(do)
            want = want.detach().cpu()
            refs = [x.grad.cpu() for x in (qr, kr, vr)]
            del q, k, v, do, qr, kr, vr
            cfg = dataclasses.replace(seq_ring_cfg(z), attention="local")
            real = ttr.causal_attention
            ttr.causal_attention = tring.causal_attention_reference
            try:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                local = ttr.TransformerRecommender(cfg).fit(
                    ctx, seq_ring_rows(z), None)
                local_s = time.perf_counter() - t1
            finally:
                ttr.causal_attention = real
            gc.collect()
            torch.cuda.empty_cache()
            logs = [p.communicate(timeout=300)[0] for p in members]
        finally:
            for p in members:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, p in enumerate(members):
            check(p.returncode == 0, f"[seq-axes ring] member {i} exited "
                  f"{p.returncode}: {logs[i][-3000:]}")
        got = [torch.load(q, weights_only=False) for q in paths]
    wall = time.perf_counter() - t0
    out = torch.cat([g["layer"]["out"] for g in got], 1)
    err = float((out - want).abs().max())
    ok = bool(((out - want).abs() <= ATT_TOL + ATT_TOL * want.abs()).all())
    grad_err = {}
    for j, (name, ref) in enumerate(zip(("dq", "dk", "dv"), refs)):
        g = torch.cat([m["layer"]["grads"][j] for m in got], 1)
        grad_err[name] = float((g - ref).abs().max() / ref.abs().max())
    del want, refs
    want_l = np.asarray(local.step_losses)
    got_l = np.asarray(got[0]["step_losses"])
    rel = float(np.max(np.abs(got_l - want_l) / np.abs(want_l)))
    fault = np.asarray(got[0]["fault_losses"])
    fault_rel = float(np.max(np.abs(fault - want_l[:1, :1]) / np.abs(want_l[:1, :1])))
    del local
    gc.collect()
    torch.cuda.empty_cache()
    n_steps = got_l.size
    members = []
    for m in got:
        t = m["timings"]
        members.append({
            "backend": m["backend"], "device": m["device"],
            "positions": m["positions"], "layer_s": m["layer"]["s"],
            "train_s": t["train_sec"],
            "rotation_ms_per_step": t["rotation_sec"] / n_steps * 1e3,
            "rotation_bytes_per_step": t["rotation_bytes"] // n_steps,
            "gradient_ms_per_step": (t["exchange_sec"] - t["rotation_sec"])
            / n_steps * 1e3,
            "peak_bytes": m["peak_bytes"], "launches": m["launches"],
            "digest": m["digest"]})
    rec = {"wall_s": wall, "members": members,
           "layer": {"shape": [z["batch"], z["max_len"], z["heads"],
                               z["d"] // z["heads"]],
                     "max_abs_err": err, "grad_err_rel_max": grad_err},
           "step_losses": got_l.tolist(), "local_step_losses": want_l.tolist(),
           "local_train_s": local_s, "step_loss_max_rel": rel,
           "step_loss_band": SEQ_RING_LOSS_RTOL,
           "planted_fault": {"step_losses": fault.tolist(),
                             "step_loss_rel": fault_rel},
           "train_tokens_per_s": n_steps * z["batch"] * z["max_len"]
           / max(m["train_s"] for m in members), "concurrent": meanwhile is not None}
    check(ok, f"[seq-axes ring] the ring layer's output differs from the plain "
          f"attention by {err} (band {ATT_TOL})")
    check(max(grad_err.values()) <= GRAD_TOL,
          f"[seq-axes ring] the ring layer's gradients {grad_err} (band {GRAD_TOL})")
    check(len({m["digest"] for m in members}) == 1,
          f"[seq-axes ring] replica digests differ: {members}")
    check(got_l.shape == want_l.shape and np.isfinite(got_l).all()
          and rel <= SEQ_RING_LOSS_RTOL,
          f"[seq-axes ring] step losses {got_l.tolist()} against the local "
          f"fit's {want_l.tolist()}: {rel:.3e} relative (band "
          f"{SEQ_RING_LOSS_RTOL})")
    check(not (fault_rel <= SEQ_RING_LOSS_RTOL),
          f"[seq-axes ring] the band {SEQ_RING_LOSS_RTOL} does not see the "
          f"own chunk masked: {fault.tolist()}")
    check(all(m["rotation_bytes_per_step"] > 0 for m in members),
          f"[seq-axes ring] no rotation: {members}")
    return rec, other


def seq_pipe_train(registry, variant_path, backend, **env):
    """``launch -n 2 train -v <variant> --mesh-axes '{"pipe": 2}'`` of the
    sequential template with ``pipelineStages`` 2 through the CLI,
    in-process; every process's lines held (exit 0, the backend, on the
    card, its stage and its 3 of the 6 layers, 4 microbatches of 16 rows,
    K4 forward and backward launched, handoff bytes, equal losses and
    model digests), then the new COMPLETED instance and its model."""
    from incubator_predictionio_tpu_torch.utils.serialization import (
        deserialize_model,
    )

    tag = f"seq-axes pipe {backend}"
    insts = registry.get_storage().get_meta_data_engine_instances()
    before = {i.id for i in insts.get_all()}
    with env_vars(PYTHONPATH=str(Path(__file__).resolve().parent), **env):
        t0 = time.perf_counter()
        out = cli_run(tag, ["launch", "-n", str(LAUNCH_PROCS), "--timeout",
                            str(LAUNCH_TIMEOUT_S), "train", "-v", variant_path,
                            "--mesh-axes", SEQ_PIPE_AXES])
        wall = time.perf_counter() - t0
    OUT.parent.mkdir(parents=True, exist_ok=True)
    (OUT.parent / f"seq_pipe_{backend}.log").write_text(out)
    k = SEQ_LAYERS // LAUNCH_PROCS
    mb = TRAIN_BATCH // SEQ_PIPE_MICROBATCHES
    per = []
    for p in launch_sections(out, SEQ_PIPE_LINE, tag):
        dist, f = p["dist"], p["fit"]
        s = p["process"]
        att = json.loads(f[22])
        check(dist[2] == backend == f[3] and dist[3].startswith("cuda")
              and [int(x) for x in f[5:13]] == [s, LAUNCH_PROCS, s * k,
                                                (s + 1) * k, SEQ_LAYERS,
                                                SEQ_PIPE_MICROBATCHES, mb,
                                                int(f[12])]
              and int(f[13]) == TRAIN_BATCH and int(f[17]) > 0,
              f"[{tag}] process {s}: {dist} {f[:19]}")
        for w in ("causal_mha_small_head", "causal_mha_small_head_bwd"):
            check(att.get(w, 0) > 0, f"[{tag}] process {s}: {w} never "
                  f"launched: {att}")
        per.append({"process": s, "device": dist[3], "coords": json.loads(f[2]),
                    "stage": s, "layers": [int(f[7]), int(f[8])],
                    "microbatches": int(f[10]), "microbatch_rows": int(f[11]),
                    "steps": int(f[12]), "stage_s": float(f[14]),
                    "train_s": float(f[15]),
                    "handoff_ms_per_step": float(f[16]),
                    "handoff_bytes_per_step": int(f[17]),
                    "gradient_ms_per_step": float(f[18]), "loss": float(f[19]),
                    "digest": f[20], "peak_bytes": int(f[21]),
                    "attention_launches": att})
    check(len({q["digest"] for q in per}) == 1 and len({q["loss"] for q in per}) == 1,
          f"[{tag}] model digests or losses differ: {per}")
    new = [i for i in insts.get_all() if i.id not in before]
    check([i.status for i in new] == ["COMPLETED"],
          f"[{tag}] new instances {[(i.id, i.status) for i in new]}")
    blob = registry.get_storage().get_model_data_models().get(new[0].id)
    check(blob is not None, f"[{tag}] no model blob")
    return {"processes": per, "wall_s": wall,
            "model": deserialize_model(blob.models)[0]}


def launched_rows(td, cfg):
    """``td`` with its rows in the order a launched fit stages them on a
    mesh of one data shard (``parallel/staging.py``: the shard's rows
    shuffled by ``default_rng(seed)``; every process of the line stages
    all of them so): what a one-process replay of that fit trains on. The
    rows must fill whole batches (no resampled padding)."""
    n = len(td.sequences)
    check(n % cfg.batch_size == 0, f"{n} rows do not fill batches of "
          f"{cfg.batch_size}: the launched fit pads by resampling")
    order = np.random.default_rng(cfg.seed).permutation(n)
    return dataclasses.replace(td, sequences=td.sequences[order])


def seq_pipe_check(ctx, tmp) -> tuple[dict, dict]:
    """(b) of :func:`seq_axes_phase`: ``launch -n 2 train --mesh-axes
    '{"pipe": 2}'`` on the first :data:`SEQ_PIPE_USERS` of seq-workflow's
    users (app ``seqpipe``) at the full width, batch 64,
    ``pipelineStages`` 2, ``pipelineMicrobatches`` 4; held: each process's
    stage, layers and K4 launches, the canonical layout persisted, the
    step losses and parameters against a one-process replay from the same
    init on the same batches; then a deploy and one burst of 64 through K4
    held to the plain attention. Returns (this process's attention
    launches while serving, record)."""
    from incubator_predictionio_tpu_torch.models import transformer as ttr
    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.templates import sequential as tseq

    root = os.path.join(tmp, "seq-workflow")
    sessions_ = cycle_sessions(np.random.default_rng(31), SEQ_WF_USERS,
                               SEQ_WF_MAX_LEN, SEQ_WF_LENGTHS)[:SEQ_PIPE_USERS]
    params = {"maxLen": SEQ_WF_MAX_LEN, "dModel": SEQ_D, "nHeads": SEQ_HEADS,
              "nLayers": SEQ_LAYERS, "learningRate": TRAIN_LR,
              "batchSize": TRAIN_BATCH, "epochs": SEQ_TP_EPOCHS,
              "pipelineStages": LAUNCH_PROCS,
              "pipelineMicrobatches": SEQ_PIPE_MICROBATCHES}
    with cli_storage(root) as registry:
        cli_app_import("seq-axes pipe", root, "seqpipe",
                       session_events(sessions_))
        variant_path = os.path.join(root, "engine-pipe.json")
        with open(variant_path, "w") as f:
            json.dump({"id": "seq-pipe", "version": "1",
                       "engineFactory": SEQ_FACTORY,
                       "datasource": {"params": {"appName": "seqpipe",
                                                 "maxLen": SEQ_WF_MAX_LEN}},
                       "algorithms": [{"name": "transformer",
                                       "params": params}]}, f)
        first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        launched = seq_pipe_train(registry, variant_path, "gloo",
                                  CUDA_VISIBLE_DEVICES=first)
        per, model, wall = (launched["processes"], launched["model"],
                            launched["wall_s"])
        cfg = model.config
        check(len(model.params["layers"]) == SEQ_LAYERS and all(
            np.shape(model.params["layers"][i][n]) == shape
            for i in range(SEQ_LAYERS)
            for n, shape in (("wq", (SEQ_D, SEQ_D)), ("w1", (SEQ_D, 4 * SEQ_D)),
                             ("w2", (4 * SEQ_D, SEQ_D)))),
              "[seq-axes pipe] the persisted model is not in the canonical layout")
        ds = tseq.DataSource(tseq.DataSourceParams(app_name="seqpipe",
                                                   max_len=SEQ_WF_MAX_LEN))
        td = launched_rows(ds.read_training(ctx), cfg)
        check(dict(td.item_map.items()) == dict(model.item_map.items()),
              "[seq-axes pipe] the replay's item map differs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = ttr.TransformerRecommender(dataclasses.replace(
            cfg, pipeline_stages=0, pipeline_microbatches=0)).fit(
            ctx, td.sequences, td.item_map)
        one_s = time.perf_counter() - t0
        got, want = np.asarray(model.step_losses), np.asarray(one.step_losses)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        p0 = _tree_numpy(ttr._init_params(
            cfg, torch.Generator(device=ctx.device).manual_seed(cfg.seed),
            ctx.device))
        param_rel, param_leaf = update_rel(model.params, one.params, p0)
        del one, p0
        check(got.shape == want.shape and rel <= SEQ_PIPE_LOSS_RTOL,
              f"[seq-axes pipe] step losses {got.tolist()} against the "
              f"one-process replay's {want.tolist()}: {rel:.3e} relative "
              f"(band {SEQ_PIPE_LOSS_RTOL})")
        check(param_rel <= SEQ_PIPE_PARAM_RTOL,
              f"[seq-axes pipe] the persisted parameters are {param_rel:.3e} "
              f"of the replay's update apart at {param_leaf} (band "
              f"{SEQ_PIPE_PARAM_RTOL})")
        gc.collect()
        torch.cuda.empty_cache()
        lat = {}
        A.reset_launches()
        served = asyncio.run(serve_phase(
            "seq-axes pipe", variant_path, registry.get_storage(), ctx,
            lambda s, u, srv: seq_launch_body(sessions_, s, u, srv, lat,
                                              bursts=1)))
        launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    check(launches["causal_mha_small_head"] > 0,
          f"[seq-axes pipe] K4 never launched serving the model: {launches}")
    train_wall = max(q["train_s"] for q in per)
    rec = {"launch_wall_s": wall, "processes": per,
           "steps": per[0]["steps"], "step_losses": got.tolist(),
           "replay_step_losses": want.tolist(), "replay_train_s": one_s,
           "step_loss_max_rel": rel, "step_loss_band": SEQ_PIPE_LOSS_RTOL,
           "param_update_rel": param_rel, "param_update_rel_leaf": param_leaf,
           "param_update_rel_band": SEQ_PIPE_PARAM_RTOL,
           "train_tokens_per_s": per[0]["steps"] * TRAIN_BATCH
           * SEQ_WF_MAX_LEN / train_wall,
           "burst64_ms": [x * 1e3 for x in lat["burst64"]],
           "kernels_vs_plain": served, "serve_launches": launches}
    return launches, rec


def seq_axes_phase(ctx, tmp):
    """The ``seq`` and ``pipe`` mesh axes: (a) ring attention over a
    two-process ``seq`` line (:func:`seq_ring_check`) at max_len 1,024,
    (b) the GPipe schedule over a two-process ``pipe`` line through the CLI
    (:func:`seq_pipe_check`) on 128 of seq-workflow's users, launched while
    (a)'s processes run, so the two share the card. Returns (launches of the
    attention kernels in this process's serving, record)."""
    t_phase = time.perf_counter()
    # the pipe's launch runs while the ring's members run: each half is
    # mostly its processes' start-up, and the script has a time limit
    ring, (launches, pipe) = seq_ring_check(
        ctx, lambda: seq_pipe_check(ctx, tmp))
    rec = {"ring": ring, "pipe": pipe, "card_count": torch.cuda.device_count(),
           "phase_s": time.perf_counter() - t_phase}
    smi = smi_name_power()
    log(f"[seq-axes] ({smi}) ring over {SEQ_RING_AXES} at max_len "
        f"{SEQ_RING_MAX_LEN}, d_model {SEQ_D}, {SEQ_LAYERS} layers of "
        f"{SEQ_HEADS} heads, batch {SEQ_RING_BATCH}: the layer at "
        f"{ring['layer']['shape']} against the plain attention max abs "
        f"{ring['layer']['max_abs_err']:.3e}, gradients "
        f"{json.dumps(ring['layer']['grad_err_rel_max'])} of their max abs; "
        f"{len(ring['step_losses'][0])} steps, losses max relative "
        f"{ring['step_loss_max_rel']:.3e} against the local fit (band "
        f"{SEQ_RING_LOSS_RTOL}; the planted fault's losses "
        f"{ring['planted_fault']['step_losses']}); "
        f"{ring['train_tokens_per_s']:.1f} train tokens/s; the ring's wall "
        f"{ring['wall_s']:.1f} s (the pipe's launch beside it), the local "
        f"fit {ring['local_train_s']:.2f} s")
    for i, m in enumerate(ring["members"]):
        log(f"[seq-axes] ({smi}) ring process {i} ({m['backend']}, "
            f"{m['device']}) positions {m['positions']}: train "
            f"{m['train_s']:.3f} s; rotation {m['rotation_ms_per_step']:.3f} "
            f"ms a step ({m['rotation_bytes_per_step']} bytes), gradient "
            f"all-reduce {m['gradient_ms_per_step']:.3f} ms a step; peak "
            f"{m['peak_bytes'] / 2**30:.3f} GiB; launches {m['launches']}")
    log(f"[seq-axes] ({smi}) launch -n 2 train --mesh-axes {SEQ_PIPE_AXES}: "
        f"{pipe['steps']} steps, wall {pipe['launch_wall_s']:.2f} s, "
        f"{pipe['train_tokens_per_s']:.1f} train tokens/s; against the "
        f"one-process replay: losses {pipe['step_loss_max_rel']:.3e} (band "
        f"{SEQ_PIPE_LOSS_RTOL}), parameters {pipe['param_update_rel']:.3e} of "
        f"its update at {pipe['param_update_rel_leaf']} (band "
        f"{SEQ_PIPE_PARAM_RTOL}); replay {pipe['replay_train_s']:.2f} s")
    for q in pipe["processes"]:
        log(f"[seq-axes] ({smi}) pipe process {q['process']} on {q['device']}: "
            f"stage {q['stage']}, layers {q['layers']}, {q['microbatches']} "
            f"microbatches of {q['microbatch_rows']} rows; train "
            f"{q['train_s']:.3f} s; handoff {q['handoff_ms_per_step']:.3f} ms a "
            f"step ({q['handoff_bytes_per_step']} bytes), gradients "
            f"{q['gradient_ms_per_step']:.3f} ms a step; peak "
            f"{q['peak_bytes'] / 2**30:.3f} GiB; attention launches "
            f"{q['attention_launches']}")
    log(f"[seq-axes] ({smi}) burst of 64 {pipe['burst64_ms'][0]:.2f} ms against "
        f"the plain attention max score diff "
        f"{pipe['kernels_vs_plain']['max_score_diff']:.2e}; serve launches "
        f"{launches}; phase {rec['phase_s']:.1f} s")
    return launches, rec


# -- phase: checkpoints of split weights (tensor, expert, pipe) ---------------

#: seq-ckpt: seq-workflow's full width (max_len 512, d_model 512, 8 heads
#: of 64, batch 64) on the first SEQ_CKPT_USERS of seq-tp's users'
#: sessions (one step an epoch), 2 epochs with a checkpoint after each, in
#: three layouts over a two-process line, each on ``cuda:0`` over gloo:
#: Megatron's slices over ``model`` (K4 on 4 heads), Switch-Base-8's
#: experts over ``expert`` (K4 at B 32), GPipe's stages over ``pipe`` (4
#: microbatches, K4 at (16, 8, 512, 64)). Depth cut to SEQ_CKPT_LAYERS of
#: the 6 layers for the script's time limit: all 6 took 96.8–137.4 s of
#: phase on an NVIDIA H100 80GB HBM3 at 700.00 W, a third of it the
#: experts' 1,349,971,968-byte state saved 3 times and restored (PERF.md §4)
SEQ_CKPT_USERS, SEQ_CKPT_EPOCHS, SEQ_CKPT_LAYERS = 64, 2, 2
SEQ_CKPT_LAYOUTS = {
    "model": ({"model": 2}, {"tensor_parallel": True}),
    "expert": ({"expert": 2}, {"n_experts": SEQ_MOE_EXPERTS}),
    "pipe": ({"pipe": 2}, {"pipeline_stages": 2,
                           "pipeline_microbatches": SEQ_PIPE_MICROBATCHES}),
}
SEQ_CKPT_RESUMED = "checkpoint: resuming from epoch 1 (of 2)"
CKPT_MEMBER = """
import json
import sys
import chip_smoke
chip_smoke.seq_ckpt_member(sys.argv[1], sys.argv[2], json.loads(sys.argv[3]))
"""


def seq_ckpt_sizes(directory: str) -> dict:
    """The checkpoint check's sizes and directory, handed to its members."""
    return {"vocab": SEQ_VOCAB, "max_len": SEQ_WF_MAX_LEN, "d": SEQ_D,
            "heads": SEQ_HEADS, "layers": SEQ_CKPT_LAYERS, "lr": TRAIN_LR,
            "batch": TRAIN_BATCH, "users": SEQ_CKPT_USERS, "dir": directory}


def seq_ckpt_cfg(z: dict, layout: str, directory: str, **kw):
    from incubator_predictionio_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    return TransformerConfig(
        vocab_size=z["vocab"], max_len=z["max_len"], d_model=z["d"],
        n_heads=z["heads"], n_layers=z["layers"], learning_rate=z["lr"],
        batch_size=z["batch"], epochs=SEQ_CKPT_EPOCHS,
        checkpoint_dir=directory, checkpoint_every=1,
        **{**SEQ_CKPT_LAYOUTS[layout][1], **kw})


def seq_ckpt_rows(z: dict) -> np.ndarray:
    """``[users, max_len + 1]`` token rows: the first ``users`` of seq-tp's
    users' sessions (seq-workflow's ``cycle_sessions`` of
    ``default_rng(31)``), item ``i<n>`` as token ``n + 1``, left-padded."""
    width = z["max_len"] + 1
    sessions = cycle_sessions(np.random.default_rng(31), SEQ_WF_USERS,
                              SEQ_WF_MAX_LEN, SEQ_WF_LENGTHS)[:z["users"]]
    rows = np.zeros((len(sessions), width), np.int32)
    for r, items in enumerate(sessions):
        items = items[-width:]
        rows[r, width - len(items):] = [int(i[1:]) % (z["vocab"] - 1) + 1
                                        for i in items]
    return rows


class CkptRecords(logging.Handler):
    """The checkpoint module's records (``utils/checkpoint.py`` logs each
    save's and restore's seconds and bytes, and the resume)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def take(self, start: str) -> list:
        """The arguments of the records whose message starts ``start``."""
        return [r.args for r in self.records if r.msg.startswith(start)]

    def messages(self) -> list:
        return [r.getMessage() for r in self.records]


def equal_states(a: list, b: list) -> bool:
    """Two checkpointed states' leaves (:func:`state_leaves` order) equal
    bit for bit: tensors compared on the first one's device, ints as ints."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if not isinstance(x, torch.Tensor):
            if x != y:
                return False
        elif (x.shape != y.shape or x.dtype != y.dtype
              or not torch.equal(x, y.to(x.device))):
            return False
    return True


class NextSlice:
    """The planted fault of seq-ckpt: a context whose coordinate on every
    axis is the next member's, so a layout's ``cut`` hands each member the
    other's slice."""

    def __init__(self, ctx):
        self.ctx = ctx

    def axis_size(self, axis):
        return self.ctx.axis_size(axis)

    def axis_index(self, axis):
        return (self.ctx.axis_index(axis) + 1) % self.ctx.axis_size(axis)


def seq_ckpt_layout(ctx, rows, z: dict, layout: str, records) -> dict:
    """One layout of :func:`seq_ckpt_member` on ``ctx`` (its axes
    :data:`SEQ_CKPT_LAYOUTS`'): the uninterrupted fit saving steps 1 and
    2; step 2 removed (a kill after epoch 1's save); the fit again, which
    must resume; the state it restored gathered whole again and held
    bitwise to step 1's file; then step 1's leaves cut again with each
    member handed the other's slice (the planted fault) and held the same
    way. What the parent checks."""
    from incubator_predictionio_tpu_torch.models import transformer as ttr
    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.utils import checkpoint as ckpt

    dev = ctx.device
    cuda = dev.type == "cuda"
    d = os.path.join(z["dir"], layout)
    cfg = seq_ckpt_cfg(z, layout, d)
    A.reset_launches()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    records.records.clear()
    t0 = time.perf_counter()
    straight = ttr.TransformerRecommender(cfg).fit(ctx, rows, None)
    straight_s = time.perf_counter() - t0
    steps = ckpt.TrainCheckpointer(d).all_steps()
    saves = records.take("checkpoint: step %d saved")
    ctx.allgather_obj("straight")  # both members done with the directory
    if ctx.is_primary:
        os.remove(os.path.join(d, "step-2.pt"))
    ctx.allgather_obj("killed")
    # the restore the fit makes, gathered whole again, and its template
    seen = {}
    real_restore = ckpt.TrainCheckpointer.restore

    def spy(self, step=None, like=None):
        state = real_restore(self, step, like)
        if like is not None and "whole" not in seen:
            # copies: the whole leaves go on training in place
            seen.update(layout=self._layout, like=like, whole=[
                t.clone() if isinstance(t, torch.Tensor) else t
                for t in ckpt.state_leaves(self._layout.gather(state))])
        return state

    records.records.clear()
    ckpt.TrainCheckpointer.restore = spy
    try:
        t0 = time.perf_counter()
        resumed = ttr.TransformerRecommender(cfg).fit(ctx, rows, None)
        resumed_s = time.perf_counter() - t0
    finally:
        ckpt.TrainCheckpointer.restore = real_restore
    messages = records.messages()
    restores = records.take("checkpoint: step %d restored")
    resaves = records.take("checkpoint: step %d saved")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    saved = ckpt.state_leaves(ckpt.TrainCheckpointer(d).restore(1))
    restored_bitwise = equal_states(seen.pop("whole"), saved)
    # the planted fault: step 1's leaves cut with the slices swapped
    lay = seen["layout"]
    real_ctx, lay.ctx = lay.ctx, NextSlice(lay.ctx)
    try:
        swapped = lay.cut([ckpt.leaf_to_numpy(x) for x in saved], seen["like"])
    finally:
        lay.ctx = real_ctx
    fault_bitwise = equal_states(ckpt.state_leaves(lay.gather(swapped)), saved)
    same = [bool(np.array_equal(a, b)) for a, b in zip(
        ttr._leaves(resumed.params), ttr._leaves(straight.params))]
    return {"steps": steps, "straight_s": straight_s, "resumed_s": resumed_s,
            "timings": [straight.timings, resumed.timings],
            "resumed_logged": any(SEQ_CKPT_RESUMED in m for m in messages),
            "params_bitwise": all(same) and len(same) > 0,
            "loss_bitwise": (resumed.final_loss == straight.final_loss
                             and np.array_equal(resumed.step_losses[-1],
                                                straight.step_losses[-1])),
            "straight_losses": np.asarray(straight.step_losses).tolist(),
            "resumed_losses": np.asarray(resumed.step_losses).tolist(),
            "restored_bitwise": restored_bitwise,
            "fault_bitwise": fault_bitwise,
            "state_bytes": sum(t.numel() * t.element_size() for t in saved
                               if isinstance(t, torch.Tensor)),
            "saves": [{"step": a[0], "s": a[1], "gather_s": a[2],
                       "bytes_written": a[3]} for a in saves + resaves],
            "restores": [{"s": a[1], "read_s": a[2]} for a in restores],
            "peak_bytes": peak, "launches": launches,
            "digest": hashlib.sha256(b"".join(
                np.ascontiguousarray(a).tobytes()
                for a in ttr._leaves(resumed.params))).hexdigest()[:16]}


def seq_ckpt_member(out_path, device, z: dict):
    """One member of seq-ckpt (a process of the job ``PIO_DIST_*``
    describes, on ``device``): the three layouts of
    :data:`SEQ_CKPT_LAYOUTS` in turn (:func:`seq_ckpt_layout`), each a
    context over the one group of the job with that layout's axis (a line
    of two is the whole job); saves what the parent checks to
    ``out_path``."""
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

    clock = {"entered": time.time()}  # the epoch clock, as the parent's
    ctx = DeviceContext.create(device, distributed=True,
                               axes=SEQ_CKPT_LAYOUTS["model"][0])
    clock["joined"] = time.time()
    records = CkptRecords()
    log_ = logging.getLogger("incubator_predictionio_tpu_torch.utils.checkpoint")
    log_.addHandler(records)
    log_.setLevel(logging.INFO)
    try:
        rows = seq_ckpt_rows(z)
        out = {"backend": ctx.backend, "device": str(ctx.device),
               "layouts": {}, "clock": clock}
        for name, (axes, _) in SEQ_CKPT_LAYOUTS.items():
            clock[name] = time.time()
            out["layouts"][name] = seq_ckpt_layout(
                dataclasses.replace(ctx, axes=axes), rows, z, name, records)
        clock["done"] = time.time()
        torch.save(out, out_path)
    finally:
        ctx.stop()


def seq_ckpt_cross(ctx, z: dict, members) -> dict:
    """The cross-layout resume of seq-ckpt, in this process while the
    members go on: as soon as the tensor-parallel fit has written step 1
    (an atomic rename: complete once it is there), a copy of it alone is
    resumed by a one-process replicated fit of the same config. Returns
    its epoch-2 loss, whether it logged the resume, its seconds and this
    process's attention launches."""
    from incubator_predictionio_tpu_torch.models import transformer as ttr
    from incubator_predictionio_tpu_torch.ops import attention as A

    first = os.path.join(z["dir"], "model", "step-1.pt")
    while not os.path.exists(first) and all(p.poll() is None for p in members):
        time.sleep(0.05)
    cross = os.path.join(z["dir"], "cross")
    os.makedirs(cross, exist_ok=True)
    if os.path.exists(first):
        shutil.copy(first, cross)
    records = CkptRecords()
    log_ = logging.getLogger("incubator_predictionio_tpu_torch.utils.checkpoint")
    log_.addHandler(records)
    level = log_.level
    log_.setLevel(logging.INFO)
    A.reset_launches()
    try:
        t0 = time.perf_counter()
        one = ttr.TransformerRecommender(seq_ckpt_cfg(
            z, "model", cross, tensor_parallel=False)).fit(
            ctx, seq_ckpt_rows(z), None)
        train_s = time.perf_counter() - t0
    finally:
        log_.removeHandler(records)
        log_.setLevel(level)
    return {"loss": one.final_loss, "train_s": train_s,
            "resumed": any(SEQ_CKPT_RESUMED in m for m in records.messages()),
            "messages": records.messages(),
            "launches": {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}}


def seq_ckpt_phase(ctx, tmp, meanwhile=None):
    """Checkpoints of split weights on the card: two fresh processes
    (:func:`seq_ckpt_member`, both on ``cuda:0`` over gloo) fit
    seq-workflow's widths (:data:`SEQ_CKPT_LAYERS` layers) on 64 rows in
    three layouts: tensor parallelism over
    ``{"model": 2}``, Switch-Base-8's experts over ``{"expert": 2}``, two
    pipeline stages with 4 microbatches over ``{"pipe": 2}``. Held, each
    layout on both members: steps 1 and 2 saved; after step 2 is removed
    the fit logs its resume from epoch 1; its parameters and epoch-2 loss
    bitwise the uninterrupted fit's; the state it restored bitwise step
    1's file; a restore that hands each member the other's slice not.
    Beside them, the cross-layout resume in this process: the
    tensor-parallel step 1 resumed by a one-process replicated fit, which
    must log the
    resume and land within :data:`SEQ_TP_LOSS_RTOL` of the
    tensor-parallel epoch-2 loss (:func:`seq_ckpt_cross`, as soon as that
    step is written). ``meanwhile()`` runs in this process first, while
    the members start. Returns (this process's attention launches,
    record) and what ``meanwhile`` returned."""
    from incubator_predictionio_tpu_torch.parallel.launcher import free_port

    t_phase, t_launch = time.perf_counter(), time.time()
    base = os.path.join(tmp, "seq-ckpt")
    os.makedirs(base, exist_ok=True)
    z = seq_ckpt_sizes(base)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent),
               PIO_DIST_COORDINATOR=f"127.0.0.1:{free_port()}",
               PIO_DIST_NUM_PROCESSES=str(LAUNCH_PROCS))
    paths = [os.path.join(base, f"member{i}.pt") for i in range(LAUNCH_PROCS)]
    members = [subprocess.Popen(
        [sys.executable, "-c", CKPT_MEMBER, paths[i],
         "cuda:0" if ctx.device.type == "cuda" else str(ctx.device),
         json.dumps(z)],
        env=dict(env, PIO_DIST_PROCESS_ID=str(i)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(LAUNCH_PROCS)]
    try:
        other = meanwhile() if meanwhile is not None else None
        t_wait = time.perf_counter()
        cross = seq_ckpt_cross(ctx, z, members)
        logs = [p.communicate(timeout=600)[0] for p in members]
    finally:
        for p in members:
            if p.poll() is None:
                p.kill()
                p.wait()
    members_s = time.perf_counter() - t_phase
    OUT.parent.mkdir(parents=True, exist_ok=True)
    (OUT.parent / "seq_ckpt_members.log").write_text(
        "\n".join(f"--- member {i} ---\n{t}" for i, t in enumerate(logs)))
    for i, p in enumerate(members):
        check(p.returncode == 0, f"[seq-ckpt] member {i} exited "
              f"{p.returncode}: {logs[i][-3000:]}")
    got = [torch.load(q, weights_only=False) for q in paths]
    per = {}
    for name in SEQ_CKPT_LAYOUTS:
        ms = [m["layouts"][name] for m in got]
        for i, m in enumerate(ms):
            tag = f"[seq-ckpt {name}] member {i}"
            check(m["steps"] == [1, 2], f"{tag}: the uninterrupted fit saved "
                  f"steps {m['steps']}")
            check(m["resumed_logged"], f"{tag}: no \"{SEQ_CKPT_RESUMED}\"")
            check(m["params_bitwise"] and m["loss_bitwise"],
                  f"{tag}: the resumed fit is not bitwise the uninterrupted "
                  f"one: losses {m['resumed_losses']} against "
                  f"{m['straight_losses']}")
            check(m["restored_bitwise"], f"{tag}: the restored state is not "
                  f"bitwise step 1's file")
            check(not m["fault_bitwise"], f"{tag}: the check does not see "
                  f"each member handed the other's slice")
            for w in ("causal_mha_small_head", "causal_mha_small_head_bwd"):
                check(m["launches"][w] > 0,
                      f"{tag}: {w} never launched: {m['launches']}")
        check(len({m["digest"] for m in ms}) == 1,
              f"[seq-ckpt {name}] the members' models differ: "
              f"{[m['digest'] for m in ms]}")
        per[name] = {
            "axes": SEQ_CKPT_LAYOUTS[name][0],
            "state_bytes": ms[0]["state_bytes"],
            "saves": [m["saves"] for m in ms],
            "restores": [m["restores"] for m in ms],
            "straight_s": [m["straight_s"] for m in ms],
            "resumed_s": [m["resumed_s"] for m in ms],
            "fit_timings": [m["timings"] for m in ms],
            "peak_bytes": [m["peak_bytes"] for m in ms],
            "launches": [m["launches"] for m in ms],
            "epoch2_loss": ms[0]["straight_losses"][-1],
            "checks": {k: [m[k] for m in ms] for k in (
                "resumed_logged", "params_bitwise", "loss_bitwise",
                "restored_bitwise", "fault_bitwise")}}
    want = float(np.mean(per["model"]["epoch2_loss"]))
    one_loss, launches = cross["loss"], cross["launches"]
    rel = abs(one_loss - want) / abs(want)
    check(cross["resumed"], f"[seq-ckpt cross] the one-process replicated "
          f"fit did not resume the tensor-parallel step 1: {cross['messages']}")
    check(np.isfinite(one_loss) and rel <= SEQ_TP_LOSS_RTOL,
          f"[seq-ckpt cross] epoch-2 loss {one_loss} against the "
          f"tensor-parallel {want}: {rel:.3e} relative (band "
          f"{SEQ_TP_LOSS_RTOL})")
    for w in ("causal_mha_small_head", "causal_mha_small_head_bwd"):
        check(launches[w] > 0, f"[seq-ckpt cross] {w} never launched: "
              f"{launches}")
    one_s = cross["train_s"]
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(base, ignore_errors=True)
    rec = {"layouts": per, "members_wall_s": members_s,
           "wait_after_meanwhile_s": time.perf_counter() - t_wait,
           "concurrent": meanwhile is not None,
           "backend": got[0]["backend"], "device": got[0]["device"],
           # each member's clock, seconds after the launch: entered its
           # code, joined the group, began each layout, done
           "member_clock_s": [{k: v - t_launch for k, v in m["clock"].items()}
                              for m in got],
           "cross": {"loss": one_loss, "tp_loss": want, "epoch2_loss_rel": rel,
                     "band": SEQ_TP_LOSS_RTOL, "train_s": one_s,
                     "launches": launches},
           "phase_s": time.perf_counter() - t_phase}
    smi = smi_name_power()
    for name, r in per.items():
        save = r["saves"][0]
        log(f"[seq-ckpt] ({smi}) {name} over {r['axes']}: whole state "
            f"{r['state_bytes']} bytes; saves (member 0) "
            + ", ".join(f"step {s['step']} {s['s']:.3f} s (gather "
                        f"{s['gather_s']:.3f} s, {s['bytes_written']} bytes "
                        f"written)" for s in save)
            + f"; restores {[[round(x['s'], 3) for x in m] for m in r['restores']]} "
            f"s (read {[[round(x['read_s'], 3) for x in m] for m in r['restores']]} "
            f"s); fits {r['straight_s']} s, "
            f"resumed {r['resumed_s']} s; peak "
            f"{[round(b / 2**30, 3) for b in r['peak_bytes']]} GiB; K4 "
            f"launches {[m['causal_mha_small_head'] for m in r['launches']]}, "
            f"backward {[m['causal_mha_small_head_bwd'] for m in r['launches']]}; "
            f"checks {r['checks']}")
    log(f"[seq-ckpt] ({smi}) cross-layout: the {{\"model\": 2}} step 1 resumed "
        f"by a one-process replicated fit: epoch-2 loss {rec['cross']['loss']} "
        f"against {want}, {rel:.3e} relative (band {SEQ_TP_LOSS_RTOL}); "
        f"members' wall {members_s:.1f} s; phase {rec['phase_s']:.1f} s")
    return (launches, rec), other


def bitwise_trees(a, b) -> bool:
    return all(np.array_equal(x, y) for _, x, y in _tree_pairs(a, b))


def _tree_numpy(tree):
    """A parameter tree of tensors as numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_numpy(v) for v in tree]
    return tree.detach().float().cpu().numpy()


def update_rel(params, ref, init):
    """The largest over the leaves of ``‖params − ref‖ / ‖ref − init‖``
    (float64 norms): two fits from ``init`` apart, against the update the
    ``ref`` fit made. Returns (value, leaf)."""
    worst = (0.0, "")
    for (name, a, b), (_, _, c) in zip(_tree_pairs(params, ref),
                                       _tree_pairs(params, init)):
        apart = float(np.linalg.norm((a - b).astype(np.float64)))
        moved = float(np.linalg.norm((b - c).astype(np.float64)))
        r = apart / moved if moved else (0.0 if apart == 0.0 else float("inf"))
        worst = max(worst, (r, name))
    return worst


def planted_head_fault(ttr, cfg, ctx, td):
    """The replicated fit of ``cfg`` on ``td`` with head 0's attention
    output zeroed in every layer (a control the parameter band must
    catch): returns its parameters and step losses."""
    real = ttr.train_step

    def zero_head(q, k, v):
        out = ttr.causal_attention(q, k, v)  # [B, L, H, D]
        keep = torch.ones(out.shape[-2], 1, device=out.device, dtype=out.dtype)
        keep[0] = 0
        return out * keep

    ttr.train_step = lambda *a, **kw: real(*a, **{**kw, "attention": zero_head})
    try:
        bad = ttr.TransformerRecommender(cfg).fit(ctx, td.sequences,
                                                  td.item_map)
    finally:
        ttr.train_step = real
    return bad.params, np.asarray(bad.step_losses)


def _tree_pairs(a, b, name="params"):
    """(path, a leaf, b leaf) over two parameter trees of one shape."""
    if isinstance(a, dict):
        check(list(a) == list(b) or set(a) == set(b), f"{name}: keys differ")
        for k in a:
            yield from _tree_pairs(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, list):
        check(len(a) == len(b), f"{name}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _tree_pairs(x, y, f"{name}.{i}")
    else:
        yield name, np.asarray(a), np.asarray(b)


def seq_eval_phase(ctx, tmp):
    """``pio eval`` of the sequential template on seq-workflow's stored
    sessions: SequentialEvaluation with :class:`SeqEvalGrid` at full width
    (2 variants × 3 folds = 6 fits, K4 forward and backward in each,
    ``batch_predict``'s forward through K4); each fold's queries are its
    held-out sessions of at least 3 items; 16 of the best variant's first
    fold's queries served with the kernels and with the plain attention
    versions on the card. Returns (launches, record)."""
    import zlib

    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.templates import sequential as tseq

    root = os.path.join(tmp, "seq-workflow")
    sessions_ = cycle_sessions(np.random.default_rng(31), SEQ_WF_USERS,
                               SEQ_WF_MAX_LEN, SEQ_WF_LENGTHS)
    torch.cuda.reset_peak_memory_stats()
    with cli_storage(root) as registry:
        A.reset_launches()
        with eval_spy(tseq.DataSource, tseq.TransformerAlgorithm,
                      keep_models=True) as spy:
            inst, res, wall = cli_eval("seq-eval", registry, SEQ_EVALUATION,
                                       "SeqEvalGrid", ctx, spy)
        launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    for w in ("causal_mha_small_head", "causal_mha_small_head_bwd"):
        check(launches[w] > 0, f"[seq-eval] {w} never launched: {launches}")
    rec = eval_timings(spy, wall)
    fold_of = [zlib.crc32(f"seq|u{k}".encode()) % EVAL_K
               for k in range(len(sessions_))]
    for _, folds in spy["results"]:
        for ei, qpa in folds:
            want = [(tuple(x[:-1]), x[-1]) for k, x in enumerate(sessions_)
                    if fold_of[k] == ei["fold"] and len(x) >= 3]
            check([(q.recent_items, a.next_item) for q, _, a in qpa] == want,
                  f"[seq-eval] fold {ei}: the queries are not its held-out "
                  "sessions")
    best_ep = spy["results"][res["bestIdx"]][0]
    model = next(m for p, m in spy["models"]
                 if p == best_ep.algorithm_params_list[0][1])
    spy["models"].clear()
    qpa = spy["results"][res["bestIdx"]][1][0][1]  # its first fold's
    # (a session none of whose items the fold's vocabulary knows answers
    # empty, as the reference's: not one to compare)
    queries = [(j, q) for j, (q, _, _) in enumerate(qpa)
               if any(i in model.item_map for i in q.recent_items)
               ][:SEQ_EVAL_PLAIN_QUERIES]
    algo = tseq.TransformerAlgorithm(best_ep.algorithm_params_list[0][1])
    served = dict(algo.batch_predict(model, queries))
    payloads = [{"recentItems": list(q.recent_items), "num": q.num}
                for _, q in queries]
    bodies = [{"itemScores": as_dicts(served[j])} for j, _ in queries]
    check_answers(payloads, bodies)
    worst, same_set, same_order = check_against_plain(model, payloads, bodies)
    del model, algo
    rec.update({"hit_rate_at_10": [r["score"] for r in res["results"]],
                "best_idx": res["bestIdx"], "launches": launches,
                "kernels_vs_plain": {"queries": len(queries),
                                     "max_score_diff": worst,
                                     "same_set": same_set,
                                     "same_order": same_order}})
    log(eval_line("seq-eval", rec))
    log(f"[seq-eval] HitRate@10 of 1 epoch × lr 1e-3/5e-3 "
        f"{[round(x, 4) for x in rec['hit_rate_at_10']]} (best "
        f"{rec['best_idx']}); every fold's queries its held-out sessions of ≥ 3 "
        f"items; {len(queries)} of the best variant's first fold served with "
        f"the kernels against the plain attention: max score diff {worst:.2e}, "
        f"sets equal {same_set}, orders equal {same_order}; launches {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def cls_eval_phase(ctx, tmp):
    """``pio eval`` of the classification template on cls-workflow's 10,000
    stored users: CompleteEvaluation (accuracy, and each label's precision)
    with :class:`ClsEvalGrid`, run with the phase's directory as the working
    directory so that its ``best.json`` lands there; then variant 0 again on
    the CPU, accuracy per fold within :data:`EVAL_CPU_BAND`."""
    from incubator_predictionio_tpu_torch.templates import classification as tcl

    root = os.path.join(tmp, "cls-workflow")
    torch.cuda.reset_peak_memory_stats()
    with cli_storage(root) as registry, contextlib.chdir(root):
        with eval_spy(tcl.DataSource, tcl.MLPAlgorithm) as spy:
            inst, res, wall = cli_eval("cls-eval", registry, CLS_EVALUATION,
                                       "ClsEvalGrid", ctx, spy)
        with open(os.path.join(root, "best.json")) as f:
            best = json.load(f)
        rec = eval_timings(spy, wall)
        ep0, card_folds = spy["results"][0]
        rec["cpu"] = fold_scores_vs_cpu(
            "cls-eval", tcl.ClassificationEngine().apply(), ep0, tcl.Accuracy(),
            ctx, card_folds, lambda q, a: (q.features, a))
    headers = ["Precision(label = 0.0)", "Precision(label = 1.0)",
               "Precision(label = 2.0)"]
    check(res["metricHeader"] == "Accuracy" and res["otherMetricHeaders"] == headers
          and all(len(r["otherScores"]) == 3 and all(np.isfinite(r["otherScores"]))
                  for r in res["results"]),
          f"[cls-eval] metrics recorded: {res['metricHeader']}, "
          f"{res['otherMetricHeaders']}")
    check(best == {"bestEngineParams": res["bestEngineParams"],
                   "score": res["bestScore"]},
          f"[cls-eval] best.json {best} differs from the instance row's best")
    rec.update({"accuracy": [r["score"] for r in res["results"]],
                "precisions": [r["otherScores"] for r in res["results"]],
                "best_idx": res["bestIdx"], "best_json": best})
    log(eval_line("cls-eval", rec))
    log(f"[cls-eval] accuracy of hidden (16,)/(32, 32) × lr 1e-2/3e-2 "
        f"{[round(x, 4) for x in rec['accuracy']]} (best {rec['best_idx']}), "
        f"per-label precision of the best "
        f"{[round(x, 4) for x in rec['precisions'][rec['best_idx']]]}; best.json "
        f"equal to the row's best; variant 0 on the CPU per fold "
        f"{[(round(f['card'], 4), round(f['cpu'], 4)) for f in rec['cpu']['folds']]}")
    return rec


# -- phase: launch -n 2 of the four other templates -----------------------------

#: each launched process's lines: the read (every template logs it alike),
#: every data-parallel fit (two-tower and MLP), the co-occurrence exchange
TPL_LAUNCH_LINE = {
    "dist": LAUNCH_LINE["dist"],
    "read": re.compile(r"sharded read: (\d+) of (\d+) rows \(shard (\d+)/(\d+)\) "
                       r"in ([\d.]+) s"),
    "fit": re.compile(
        r"data-parallel fit: process (\d+) of (\d+) \(backend (\w+), (\S+)\): "
        r"(\d+) steps of (\d+) local rows; stage ([\d.]+) s, train ([\d.]+) s, "
        r"exchange ([\d.]+) ms a step; loss (\S+); replica digest (\w+), equal "
        r"on every process; (?:staged \d+ rows \(\S+ real\); )?peak device "
        r"memory (\d+) bytes"),
    "cooc": re.compile(r"co-occurrence: the processes' \[(\d+), (\d+)\] count "
                       r"matrices summed \((\d+) bytes a process\) in ([\d.]+) s"),
}
#: the naive Bayes moments of the launch (float64 host sums over the
#: shards) against the one-process fit on the card (float32 sorted
#: segment sums): within this share of each array's max abs
TPL_NB_TOL = 1e-6
#: the MLP's data-parallel fit (the launched one is bitwise its threaded
#: replay) against the one-process loop on the same global batches (the
#: processes' local batches side by side), over one epoch: the loss,
#: relative. The two differ only in the order of the gradient's fp32 sums
#: and in cuBLAS's per-M rounding of the bf16 forward, which adam carries
#: further each epoch: at cls-workflow's shape on an H100 they were 3.1e-4
#: apart after one epoch and 15% after the fit's 20 (the phase records
#: both). The launched model's accuracy on the stored rows against the
#: one-process fit's, absolute: that fit trains on other batches (the rows
#: in store order, each shard shuffled) and ends elsewhere at ~0.02 (the
#: phase records it beside the same fit on the rows in another order), so
#: the final losses of the two are not compared.
TPL_MLP_LOSS_RTOL, TPL_MLP_ACC_BAND = 1e-2, 0.02


class ThreadGroup:
    """``n`` processes of a job as threads of this process, on one card:
    each thread's :class:`DeviceContext` meets the others' at a barrier in
    every collective — ``allgather_obj`` (every thread's object, in process
    order), ``all_gather`` (their tensors stacked in process order),
    ``all_reduce_sum`` (their sum in process order, a new tensor). What the
    launched processes compute, without the transport (gloo's sum of two
    tensors is the same correctly rounded add)."""

    def __init__(self, n: int, device):
        import threading

        self.n, self.device = n, device
        self._barrier = threading.Barrier(n, timeout=300)
        self._slots = [None] * n

    def _meet(self, index, obj, combine):
        self._slots[index] = obj
        self._barrier.wait()
        out = combine(list(self._slots))
        self._barrier.wait()  # every thread has combined the slots
        return out

    def context(self, index: int):
        from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

        group = self

        class Member(DeviceContext):
            # the data axis is every thread; any other axis is one
            def allgather_obj(self, obj, axis=None):
                if self._line(axis)[1] == 1:
                    return [obj]
                return group._meet(index, obj, lambda parts: parts)

            def all_gather(self, t, axis=None):
                if self._line(axis)[1] == 1:
                    return t.unsqueeze(0)
                return group._meet(index, t.contiguous(), torch.stack)

            def all_reduce_sum(self, t, axis=None):
                if self._line(axis)[1] == 1:
                    return t.clone()

                def total(parts):
                    out = parts[0].clone()
                    for q in parts[1:]:
                        out = out + q
                    return out

                return group._meet(index, t, total)

        return Member(torch.device(self.device), index, self.n, "threads")

    def run(self, fn):
        import threading

        results, errors = [None] * self.n, [None] * self.n

        def body(i):
            try:
                results[i] = fn(self.context(i))
            except BaseException as e:  # noqa: BLE001 - raised below
                errors[i] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(i,)) for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None and not isinstance(e, threading.BrokenBarrierError):
                raise e
        for e in errors:
            if e is not None:
                raise e
        return results


def engine_of(variant_path):
    """The variant's engine and engine parameters (what ``train`` builds)."""
    from incubator_predictionio_tpu_torch.core.controller import (
        resolve_engine_factory,
        variant_from_file,
    )

    variant = variant_from_file(variant_path)
    engine = resolve_engine_factory(variant["engineFactory"])()
    return engine, engine.engine_params_from_variant(variant)


def threaded_train(variant_path, dev):
    """The launched job replayed in this process (:class:`ThreadGroup`):
    each thread reads its shard of the store and trains every algorithm
    of the variant over the group, as ``Engine.train`` does in each
    launched process. Returns each thread's (training data, models)."""
    engine, ep = engine_of(variant_path)

    def one(member):
        ds, prep, algos, _ = engine._instantiate(ep)
        td = ds.read_training(member)
        pd = prep.prepare(member, td)
        return td, [a.train(member, pd) for a in algos]

    return ThreadGroup(LAUNCH_PROCS, dev).run(one)


def model_arrays(model) -> dict:
    """The arrays a persisted model of these templates holds."""
    names = {"ItemSimModel": ("item_vecs",), "SimilarUserModel": ("user_vecs",),
             "NaiveBayesModel": ("means", "variances", "log_priors")}
    kind = type(model).__name__
    if kind in names:
        return {n: getattr(model, n) for n in names[kind]}
    if kind == "ECommModel":
        return {"user_emb": model.mf.user_emb, "item_emb": model.mf.item_emb,
                "user_bias": model.mf.user_bias, "item_bias": model.mf.item_bias,
                "popularity": model.popularity}
    if kind == "MLPModel":
        out = {"mean": model.mean, "std": model.std}
        for i, layer in enumerate(model.params):
            out.update({f"{k}{i}": v for k, v in layer.items()})
        return out
    return {}


def bitwise_arrays(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


class ClsLaunchEvalGrid:
    """tpl-launch's eval generator (each launched process loads it as
    ``chip_smoke:ClsLaunchEvalGrid``): cls-eval's first variant (hidden
    (16,), learning rate 1e-2, :data:`CLS_EVAL_EPOCHS` epochs), 3 folds, on
    cls-workflow's app ``cls``; one variant keeps the phase inside its
    time."""

    def __init__(self):
        self.engine_params_list = cls_eval_grid()[:1]


def tpl_launch_specs():
    """(tag, the workflow phase's store, app, factory, algorithms, serving,
    16 queries) of each template's launch, at the workflow phases' widths
    and half their depth (5 iterations, 10 MLP epochs; cut for the
    script's time: PERF.md §4)."""
    rng = np.random.default_rng(43)
    item_ids = [f"i{j}" for j in range(SIM_ITEMS)]
    cls_rows = np.random.default_rng(44).normal(size=(80, 3)) * [1.0, 2.0, 0.5] \
        + [0.0, 3.0, -1.0]
    two = {"numIterations": 5, "seed": 1}
    return [
        ("sim", "sim-workflow", "simwf", SIM_FACTORY,
         [{"name": "als", "params": {"rank": SIM_RANK, **two}},
          {"name": "likealgo", "params": {"rank": SIM_RANK, **two}},
          {"name": "cooccurrence", "params": {"n": 20}}], None,
         sim_queries(rng, 16, item_ids)),
        ("recuser", "recuser-workflow", "recuser", RU_FACTORY,
         [{"name": "als", "params": {"rank": 32, **two}}], None,
         recuser_queries(rng, 16)),
        ("ecomm", "ecomm-train", "ecomm", EC_FACTORY,
         [{"name": "ecomm", "params": {"appName": "ecomm", "rank": EC_RANK, **two}}],
         None, [ecomm_query(rng, j) for j in range(1, 17)]),
        ("cls", "cls-workflow", "cls", CLS_FACTORY,
         [{"name": "nb", "params": {}},
          {"name": "mlp", "params": {"hiddenDims": [64, 64], "epochs": 10}}],
         "vote", [{"features": [float(v) for v in r]} for r in cls_rows]),
    ]


def tpl_answers_hold(tag, kind, model, payloads, bodies):
    """No filtered id in the launched engine's answers."""
    if kind == "sim":
        sim_filters_hold(tag, model, payloads, bodies)
        return
    for p, b in zip(payloads, bodies):
        if kind == "cls":
            check(b.get("label") in (0.0, 1.0, 2.0), f"[{tag}] label {b} for {p}")
            continue
        key, field = (("user", "similarUserScores") if kind == "recuser"
                      else ("item", "itemScores"))
        got = [x[key] for x in b[field]]
        check(0 < len(got) <= p["num"], f"[{tag}] answer {b} for {p}")
        check(not set(got) & set(p.get("blackList") or ()),
              f"[{tag}] a blackListed id served for {p}")
        if "whiteList" in p:
            check(set(got) <= set(p["whiteList"]), f"[{tag}] outside the whiteList")
        if kind == "recuser":
            check(not set(got) & set(p["users"]) and all(
                x["score"] > 0 for x in b[field]), f"[{tag}] {b} for {p}")
            continue
        check(not {f"i{i}" for i in range(EC_UNAVAILABLE)} & set(got),
              f"[{tag}] an unavailable item served for {p}")
        for iid in got:
            if "categories" in p:
                check(set(model.categories.get(iid, ())) & set(p["categories"]),
                      f"[{tag}] {iid} outside {p['categories']}")


def tpl_launch_one(spec, ctx, tmp) -> dict:
    """``launch -n 2 train`` of one template on its workflow phase's store,
    both processes on the card over gloo. Held: every process's lines
    (exit 0, gloo, the card, shard reads that partition the rows, each
    fit's replica digests and losses equal across the processes), one new
    COMPLETED instance; its models against :func:`threaded_train` — the
    two-tower tables and the MLP bitwise, the co-occurrence lists equal to
    the int64 oracle with each shard's counts rounded to bf16 before the
    sum, naive Bayes within :data:`TPL_NB_TOL` of the one-process fit on
    the card (and bitwise the replay's), the MLP's data-parallel loss and the
    launched accuracy in the bands of :data:`TPL_MLP_LOSS_RTOL`
    (:func:`tpl_cls_single`); then a deploy
    through the QueryServer answering 16 queries with no filtered id."""
    from incubator_predictionio_tpu_torch.utils.serialization import (
        deserialize_model,
    )

    kind, store, app, factory, algos, serving, payloads = spec
    tag = f"tpl-launch {kind}"
    root = os.path.join(tmp, store)
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    rec = {"template": kind}
    with cli_storage(root) as registry:
        variant = write_variant(os.path.join(root, f"launch-{kind}.json"), factory,
                                app, algos, serving)
        storage = registry.get_storage()
        insts = storage.get_meta_data_engine_instances()
        before = {i.id for i in insts.get_all()}
        with env_vars(PYTHONPATH=str(Path(__file__).resolve().parent),
                      CUDA_VISIBLE_DEVICES=first):
            t0 = time.perf_counter()
            out = cli_run(tag, ["launch", "-n", str(LAUNCH_PROCS), "--timeout",
                                str(LAUNCH_TIMEOUT_S), "train", "-v", variant])
            rec["wall_s"] = time.perf_counter() - t0
        OUT.parent.mkdir(parents=True, exist_ok=True)
        (OUT.parent / f"tpl_launch_{kind}.log").write_text(out)
        per = []
        for p in launch_sections(out, TPL_LAUNCH_LINE, tag, many=("fit", "cooc")):
            d, r = p["dist"], p["read"]
            check(d[2] == "gloo" and d[3].startswith("cuda"),
                  f"[{tag}] process {p['process']}: {d}")
            per.append({"process": p["process"], "device": d[3],
                        "local_rows": int(r[0]), "global_rows": int(r[1]),
                        "read_s": float(r[4]),
                        "fits": [{"steps": int(f[4]), "local_batch": int(f[5]),
                                  "stage_s": float(f[6]), "train_s": float(f[7]),
                                  "exchange_ms_per_step": float(f[8]),
                                  "loss": f[9], "digest": f[10],
                                  "peak_bytes": int(f[11])} for f in p["fit"]],
                        "cooccurrence": [{"bytes": int(c[2]), "s": float(c[3])}
                                         for c in p["cooc"]]})
        total = per[0]["global_rows"]
        check(all(q["global_rows"] == total for q in per)
              and sum(q["local_rows"] for q in per) == total
              and all(0 < q["local_rows"] < total for q in per),
              f"[{tag}] shard reads {per}")
        n_fits = sum(a["name"] != "cooccurrence" and a["name"] != "nb" for a in algos)
        check(all(len(q["fits"]) == n_fits for q in per),
              f"[{tag}] {[len(q['fits']) for q in per]} data-parallel fits, "
              f"{n_fits} expected")
        for a, b in zip(per[0]["fits"], per[1]["fits"]):
            check(a["digest"] == b["digest"] and a["loss"] == b["loss"],
                  f"[{tag}] the replicas differ: {a} {b}")
        new = [i for i in insts.get_all() if i.id not in before]
        check([i.status for i in new] == ["COMPLETED"],
              f"[{tag}] new instances {[(i.id, i.status) for i in new]}")
        blob = storage.get_model_data_models().get(new[0].id)
        check(blob is not None and not pickle_names_torch(blob.models),
              f"[{tag}] the persisted models")
        launched = deserialize_model(blob.models)
        # the replay: the job's computation in this process's threads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay = threaded_train(variant, ctx.device)
        rec["replay_s"] = time.perf_counter() - t0
        check(len(launched) == len(replay[0][1]) == len(algos),
              f"[{tag}] {len(launched)} launched models")
        compared = []
        for a, m, r0, r1 in zip(algos, launched, replay[0][1], replay[1][1]):
            arrays = model_arrays(m)
            if arrays:
                check(bitwise_arrays(model_arrays(r0), model_arrays(r1)),
                      f"[{tag}] {a['name']}: the replay's threads differ")
                same = bitwise_arrays(arrays, model_arrays(r0))
                check(same, f"[{tag}] {a['name']}: the launched model differs from "
                      f"the replay's")
                compared.append({"algorithm": a["name"], "bitwise_replay": same})
        if kind == "sim":
            rec["cooccurrence"] = tpl_cooccur_oracle(tag, launched[2], replay, algos[2])
        if kind == "cls":
            rec.update(tpl_cls_single(tag, launched, [td for td, _ in replay], ctx))
        rec["models"] = compared
        rec["processes"] = per
        del replay
        gc.collect()
        torch.cuda.empty_cache()

        async def body(session, url, server):
            bodies, lat = await post_all(session, url, payloads, False)
            tpl_answers_hold(tag, kind, server.deployed.models[0], payloads, bodies)
            return {"queries": len(payloads), "latency": lat_record(lat)}

        rec["serve"] = asyncio.run(serve_phase(tag, variant, storage, ctx, body))
    return rec


def tpl_cooccur_oracle(tag, model, replay, algo) -> dict:
    """The launched co-occurrence lists against the int64 oracle: each
    shard's (the replay threads' reads) ``Uᵀ U`` rounded to bf16, then
    summed in process order."""
    t0 = time.perf_counter()
    total = None
    for td, _ in replay:
        part = cooccur_oracle(td.view_u, td.view_i, len(td.users), len(td.items))
        total = part if total is None else total + part
    top = oracle_top_lists(total, algo["params"]["n"])
    check(model.top_cooccurrences == top,
          f"[{tag}] the co-occurrence lists differ from the oracle's")
    check(replay[0][1][2].top_cooccurrences == top,
          f"[{tag}] the replay's co-occurrence lists differ from the oracle's")
    return {"items_with_lists": len(top), "max_count": int(total.max()),
            "oracle_s": time.perf_counter() - t0, "lists_equal_oracle": True}


def tpl_cls_single(tag, launched, shards, ctx) -> dict:
    """The launched naive Bayes against the one-process fit on the card
    from the whole read. The MLP's data-parallel fit over one epoch (the
    job's threads on ``shards``, their staged local batches kept) against
    the one-process loop on the same global batches from the same initial
    parameters; that loop over the launched fit's epochs beside the
    launched loss; the launched model's accuracy on the stored rows
    against the one-process fit's, and that fit again on the rows in
    another order."""
    from incubator_predictionio_tpu_torch.models import mlp as tmlp
    from incubator_predictionio_tpu_torch.parallel import staging
    from incubator_predictionio_tpu_torch.templates import classification as tcl

    dev = ctx.device
    td = tcl.DataSource(tcl.DataSourceParams(app_name="cls")).read_training(ctx)
    nb = tcl.NaiveBayesAlgorithm(tcl.NaiveBayesAlgorithmParams()).train(ctx, td)
    worst = 0.0
    for name in ("means", "variances", "log_priors"):
        a, b = getattr(launched[0], name), getattr(nb, name)
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    check(list(launched[0].classes) == list(nb.classes) and worst <= TPL_NB_TOL,
          f"[{tag}] naive Bayes: {worst:.3e} of a max abs from the one-process "
          f"fit (band {TPL_NB_TOL})")
    cfg = launched[1].config
    one_epoch = dataclasses.replace(cfg, epochs=1)
    staged, stage = {}, staging.stage_sharded_batches

    def keep(member, *args, **kwargs):
        staged[member.process_index] = stage(member, *args, **kwargs)
        return staged[member.process_index]

    staging.stage_sharded_batches = keep
    try:
        dp = ThreadGroup(LAUNCH_PROCS, dev).run(
            lambda m: tmlp.MLPClassifier(one_epoch).fit(
                m, shards[m.process_index].x, shards[m.process_index].y,
                rows_are_local=True))
    finally:
        staging.stage_sharded_batches = stage
    (xb, yb), wb = ([torch.cat([staged[p][0][j] for p in sorted(staged)], 1)
                     for j in range(2)],
                    torch.cat([staged[p][1] for p in sorted(staged)], 1))
    dims = [xb.shape[-1], *cfg.hidden_dims, len(launched[1].classes)]

    def loop(epochs):
        net = tmlp.MLPNet(tmlp.init_params(
            torch.Generator(device=dev).manual_seed(cfg.seed), dims, dev))
        return float(tmlp.train_epochs(net, xb, yb.long(), wb,
                                       cfg.learning_rate, epochs))

    glob1, glob = loop(1), loop(cfg.epochs)
    rel = abs(dp[0].final_loss - glob1) / abs(glob1)
    check(rel <= TPL_MLP_LOSS_RTOL,
          f"[{tag}] MLP: one data-parallel epoch's loss {dp[0].final_loss} "
          f"against the one-process loop's on the same global batches {glob1}")
    algo = tcl.MLPAlgorithm(tcl.MLPAlgorithmParams(
        hidden_dims=cfg.hidden_dims, learning_rate=cfg.learning_rate,
        batch_size=cfg.batch_size, epochs=cfg.epochs, seed=cfg.seed))
    single = algo.train(ctx, td)
    perm = np.random.default_rng(45).permutation(len(td.y))
    shuffled = algo.train(ctx, tcl.TrainingData(td.x[perm], td.y[perm]))

    def accuracy(model):
        if model._net is None:
            model.prepare_for_serving(ctx)
        return float(np.mean(tmlp.MLPClassifier.predict(model, td.x) == td.y))

    acc, acc_single = accuracy(launched[1]), accuracy(single)
    check(abs(acc - acc_single) <= TPL_MLP_ACC_BAND,
          f"[{tag}] MLP accuracy {acc} against the one-process fit's {acc_single}")
    return {"nb_vs_single_max_abs_ratio": worst,
            "mlp_epoch1_loss": dp[0].final_loss, "mlp_epoch1_global_loop_loss": glob1,
            "mlp_epoch1_loss_rel": rel,
            "mlp_loss": launched[1].final_loss, "mlp_global_loop_loss": glob,
            "mlp_single_loss": single.final_loss,
            "mlp_single_loss_other_order": shuffled.final_loss,
            "mlp_accuracy": acc, "mlp_single_accuracy": acc_single}


def tpl_launch_eval(ctx, tmp, cls_eval) -> dict:
    """``launch -n 2 eval`` of the classification template on cls-eval's
    store: CompleteEvaluation with :class:`ClsLaunchEvalGrid` (1 variant ×
    3 folds: every process reads every row and trains its slice of each
    global batch). Held: one new EVALCOMPLETED row, by process 0; both
    processes' results equal; every fit's replica digests equal; the
    variant's accuracy within :data:`EVAL_CPU_BAND` of cls-eval's."""
    root = os.path.join(tmp, "cls-workflow")
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    lines = {"dist": LAUNCH_LINE["dist"], "fit": TPL_LAUNCH_LINE["fit"],
             "finished": LAUNCH_EVAL_LINE["finished"]}
    with cli_storage(root) as registry, contextlib.chdir(root):
        rows = registry.get_storage().get_meta_data_evaluation_instances()
        before = {i.id for i in rows.get_all()}
        with env_vars(PYTHONPATH=str(Path(__file__).resolve().parent),
                      CUDA_VISIBLE_DEVICES=first):
            t0 = time.perf_counter()
            out = cli_run("tpl-launch eval", [
                "launch", "-n", str(LAUNCH_PROCS), "--timeout", str(LAUNCH_TIMEOUT_S),
                "eval", CLS_EVALUATION, f"{Path(__file__).stem}:ClsLaunchEvalGrid"])
            wall = time.perf_counter() - t0
        new = [i for i in rows.get_all() if i.id not in before]
    (OUT.parent / "tpl_launch_eval.log").write_text(out)
    procs = launch_sections(out, lines, "tpl-launch eval", many=("fit",))
    check(len(new) == 1 and new[0].status == "EVALCOMPLETED"
          and f"Evaluation completed. Instance ID: {new[0].id}" in procs[0]["log"]
          and "Evaluation completed (secondary process" in procs[1]["log"],
          f"[tpl-launch eval] new rows {[(i.id, i.status) for i in new]}")
    check(procs[0]["finished"] == procs[1]["finished"],
          "[tpl-launch eval] the processes' results differ")
    fits = [p["fit"] for p in procs]
    check(len(fits[0]) == len(fits[1]) == EVAL_K
          and all(a[10] == b[10] for a, b in zip(*fits)),
          f"[tpl-launch eval] fits {[len(f) for f in fits]} or their replicas differ")
    for p in procs:
        check(p["dist"][2] == "gloo" and p["dist"][3].startswith("cuda"),
              f"[tpl-launch eval] process {p['process']}: {p['dist']}")
    res = json.loads(new[0].evaluator_results_json)
    scores = [r["score"] for r in res["results"]]
    single = cls_eval["accuracy"][:1]
    check(len(scores) == 1 and all(abs(a - b) <= EVAL_CPU_BAND
                                   for a, b in zip(scores, single)),
          f"[tpl-launch eval] accuracy {scores} against cls-eval's {single}")
    return {"wall_s": wall, "accuracy": scores, "single_accuracy": single,
            "fits": len(fits[0]),
            "fit_train_s": [float(f[7]) for f in fits[0]],
            "exchange_ms_per_step": [float(f[8]) for f in fits[0]],
            "peak_bytes": [max(int(f[11]) for f in fp) for fp in fits]}


def tpl_launch_phase(ctx, tmp, cls_eval) -> dict:
    """``launch -n 2 train`` of the similar-product (als, likealgo,
    cooccurrence), recommended-user, e-commerce and classification (nb +
    mlp under vote) templates on their workflow phases' stores, each held
    by :func:`tpl_launch_one`; then ``launch -n 2 eval`` of the
    classification template (:func:`tpl_launch_eval`)."""
    smi = smi_name_power()
    rec = {}
    for spec in tpl_launch_specs():
        t0 = time.perf_counter()
        r = rec[spec[0]] = tpl_launch_one(spec, ctx, tmp)
        r["phase_s"] = time.perf_counter() - t0
        for q in r["processes"]:
            fits = "; ".join(
                f"{f['steps']} steps of {f['local_batch']} rows, train "
                f"{f['train_s']:.3f} s, exchange {f['exchange_ms_per_step']:.3f} ms "
                f"a step, peak {f['peak_bytes'] / 2**30:.3f} GiB"
                for f in q["fits"])
            cooc = "".join(f"; co-occurrence sum {c['bytes']} bytes in {c['s']:.3f} s"
                           for c in q["cooccurrence"])
            log(f"[tpl-launch {spec[0]}] ({smi}) process {q['process']}: read "
                f"{q['local_rows']} of {q['global_rows']} rows in {q['read_s']:.3f} "
                f"s; {fits}{cooc}")
        extra = ""
        if "cooccurrence" in r:
            extra = (f"; co-occurrence lists of {r['cooccurrence']['items_with_lists']} "
                     f"items equal to the oracle (max count "
                     f"{r['cooccurrence']['max_count']})")
        if "mlp_loss" in r:
            extra = (f"; naive Bayes {r['nb_vs_single_max_abs_ratio']:.3e} of a max "
                     f"abs from the one-process fit; MLP, one data-parallel epoch "
                     f"{r['mlp_epoch1_loss']:.6f} against the one-process loop on the "
                     f"same global batches {r['mlp_epoch1_global_loop_loss']:.6f} "
                     f"(rel {r['mlp_epoch1_loss_rel']:.3e}); launched loss "
                     f"{r['mlp_loss']:.6f}, that loop's {r['mlp_global_loop_loss']:.6f}, "
                     f"the one-process fit's {r['mlp_single_loss']:.6f} (rows in "
                     f"another order: {r['mlp_single_loss_other_order']:.6f}); "
                     f"accuracy {r['mlp_accuracy']:.4f} against "
                     f"{r['mlp_single_accuracy']:.4f}")
        log(f"[tpl-launch {spec[0]}] ({smi}) launch -n 2 train: wall "
            f"{r['wall_s']:.2f} s; models bitwise the threaded replay "
            f"({[m['algorithm'] for m in r['models']]}, replay {r['replay_s']:.2f} s)"
            f"{extra}; {r['serve']['queries']} queries served, no filtered id "
            f"(p50 {r['serve']['latency']['p50_ms']:.2f} ms); phase {r['phase_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    e = rec["eval"] = tpl_launch_eval(ctx, tmp, cls_eval)
    log(f"[tpl-launch eval] ({smi}) launch -n 2 eval: wall {e['wall_s']:.2f} s, "
        f"{e['fits']} fits a process (train {sum(e['fit_train_s']):.2f} s, exchange "
        f"{np.mean(e['exchange_ms_per_step']):.3f} ms a step, peak "
        f"{[round(b / 2**30, 3) for b in e['peak_bytes']]} GiB); accuracy "
        f"{[round(x, 4) for x in e['accuracy']]} against cls-eval's "
        f"{[round(x, 4) for x in e['single_accuracy']]}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return rec


def template_phases(ctx, tmp) -> dict:
    """The six phases of the other templates, then cls-eval, then
    tpl-launch on their stores, in turn."""
    out = {}
    for name, phase in (("sim_train", lambda: sim_train_phase(ctx, tmp)),
                        ("sim_workflow", lambda: sim_workflow_phase(ctx, tmp)),
                        ("recuser_workflow", lambda: recuser_workflow_phase(ctx, tmp)),
                        ("ecomm", lambda: ecomm_phase(ctx, tmp)),
                        ("cls_train", lambda: cls_train_phase(ctx)),
                        ("cls_workflow", lambda: cls_workflow_phase(ctx, tmp)),
                        ("cls_eval", lambda: cls_eval_phase(ctx, tmp)),
                        ("tpl_launch", lambda: tpl_launch_phase(
                            ctx, tmp, out["cls_eval"]))):
        t0 = time.perf_counter()
        out[name] = phase()
        out[name]["phase_s"] = time.perf_counter() - t0
        log(f"[{name}] phase {out[name]['phase_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a "
              "card only", file=sys.stderr)
        return 1
    from incubator_predictionio_tpu_torch import convert
    from incubator_predictionio_tpu_torch.ops import _build
    from incubator_predictionio_tpu_torch.ops import retrieval as R
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
    from incubator_predictionio_tpu_torch.ops import attention as A
    from incubator_predictionio_tpu_torch.ops import sparse_update as S
    from incubator_predictionio_tpu_torch.serving import ann

    # fp32 matmuls stay fp32 (the plain versions and the library yardstick)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_name_power()
    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc: {nvcc_v}")
    log(f"card: {smi}  (torch: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible)")
    log("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    for k in sorted(k for k in os.environ if k.startswith("PIO_RETRIEVAL_")):
        log(f"note: {k}={os.environ[k]} is set in the environment")

    t0 = time.perf_counter()
    built = _build.build_all()  # one nvcc a source, all started together
    libs = []
    for n in ("retrieval", "attention", "flash_attention", "sparse_update"):
        _build.library(n)
        libs.append(_build.library_path(n).name)
    build_s = time.perf_counter() - t0
    log(f"kernel build: {built or 'cached'} in {build_s:.2f} s ({libs})")

    ctx = DeviceContext.create()
    dev = ctx.device
    t0 = time.perf_counter()
    user, item, user_bias, item_bias, eval_users = towers()
    ivf = ann.build_ivf(item, item_bias, key=ann.build_key(N_ITEMS))
    log(f"towers {N_USERS}x{RANK} / {N_ITEMS}x{RANK}; IVF index built once: "
        f"{ivf.n_partitions} partitions in {ivf.build_seconds:.2f} s "
        f"(setup {time.perf_counter() - t0:.2f} s)")

    k1, k2 = kernel_checks(R, user, item, item_bias, ivf, dev)
    topk = topk_tie_check(dev)
    k4, k5 = attention_checks(A)
    k4b, k5b = attention_bwd_checks(A)
    k3, k3b = k3_checks(S, dev)
    floor = launch_floor()

    # persist: convert → RecModel (index attached) → blob → memory storage
    rec = convert.rec_model_from_arrays(
        user, item, user_bias, item_bias, 3.0, RANK,
        [f"u{i}" for i in range(N_USERS)], [f"i{i}" for i in range(N_ITEMS)])
    rec.mf._ivf = ivf
    with tempfile.TemporaryDirectory() as tmp:
        storage, variant_path = deploy_storage(FACTORY, {"rank": RANK}, "als",
                                               rec, tmp)
        del rec
        launches, main = asyncio.run(main_path(
            R, variant_path, storage, ctx,
            (user, item, user_bias, item_bias), eval_users))
        gc.collect()
        torch.cuda.empty_cache()
        # the stream phase reuses the persisted model and its IVF index
        with retrieval_mode("auto"):
            counts, main["stream"] = asyncio.run(stream_phase(
                R, S, variant_path, storage, ctx, tmp,
                CodecLog(os.path.join(tmp, "live.piolog"))))
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        gc.collect()
        torch.cuda.empty_cache()
        # the query server's safety tier on the same persisted instance
        counts, main["rec_reload"] = asyncio.run(reload_phase(
            R, (user, item, user_bias, item_bias), eval_users, storage, ctx,
            tmp, smi))
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        # the telemetry that reads the card, on the same instance A
        counts, main["rec_obs"] = asyncio.run(obs_phase(
            R, (user, item, user_bias, item_bias), eval_users, storage,
            variant_path, ctx, tmp, smi))
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
    del user, item, user_bias, item_bias, ivf, storage
    gc.collect()
    torch.cuda.empty_cache()
    # the recommendation template trained on the card: the bench's scaled
    # configuration through fit, persist, load and deploy, then the
    # normal entry points (CLI app new, import, train, deploy) on sqlite
    with tempfile.TemporaryDirectory() as tmp:
        counts, main["rec_train"] = rec_train_phase(R, ctx, tmp)
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        gc.collect()
        torch.cuda.empty_cache()
        # sharded serving: the sharded_serving lanes, then rec-train's
        # persisted model under PIO_SHARD_SERVE=1 (K2 a shard)
        counts, main["rec_shard"] = rec_shard_phase(
            R, ctx, tmp, main["rec_train"]["persisted"])
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        # streaming into the card-trained model, through the eventlog backend
        counts, main["rec_stream"] = rec_stream_phase(
            R, S, ctx, tmp, main["rec_train"].pop("persisted"))
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        gc.collect()
        torch.cuda.empty_cache()
        counts, main["rec_workflow"] = rec_workflow_phase(R, ctx, tmp)
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        # pio eval on rec-workflow's stored events (no kernel: host scoring)
        t0 = time.perf_counter()
        main["rec_eval"] = rec_eval_phase(ctx, tmp)
        main["rec_eval"]["phase_s"] = time.perf_counter() - t0
        log(f"[rec-eval] phase {main['rec_eval']['phase_s']:.1f} s")
        # multi-process training: launch -n 2 train, the primary's model
        # deployed through K1 and K2; then batchpredict on that model, in
        # one process and under launch -n 2 (K1 at B 1024)
        with tempfile.TemporaryDirectory() as tmp2:
            counts, main["rec_launch"] = rec_launch_phase(R, ctx, tmp2)
            for k, c in counts.items():
                launches[k] = launches.get(k, 0) + c
            gc.collect()
            torch.cuda.empty_cache()
            counts, main["rec_batchpredict"] = rec_batchpredict_phase(
                R, ctx, main["rec_launch"].pop("persisted"))
            for k, c in counts.items():
                launches[k] = launches.get(k, 0) + c
            gc.collect()
            torch.cuda.empty_cache()
            # fault-tolerant training on rec-launch's store: supervised
            # members, a member killed, the resumed fit bitwise the control
            counts, main["rec_supervised"] = rec_supervised_phase(R, ctx, tmp2)
            for k, c in counts.items():
                launches[k] = launches.get(k, 0) + c
            gc.collect()
            torch.cuda.empty_cache()
            # the model mesh axis on rec-launch's store: two processes
            # each holding half of every table, bitwise a one-process
            # replay, deployed through K1
            counts, main["rec_model"] = rec_model_phase(R, ctx, tmp2)
            for k, c in counts.items():
                launches[k] = launches.get(k, 0) + c
        gc.collect()
        torch.cuda.empty_cache()
        # launch -n 2 eval on rec-workflow's stored events
        main["rec_launch_eval"] = rec_launch_eval_phase(ctx, tmp)
    k1 = k1 + main["rec_train"].pop("k1_cases") + [
        main["rec_batchpredict"]["k1_b1024"]]
    k2 = k2 + main["rec_train"].pop("k2_cases")
    # each sequential phase runs with the counts at 0 and reads them after;
    # a kernel's launches on the main path are the sum over the phases
    att_launches = {w.__name__: 0 for w in A.KERNEL_WRAPPERS}

    def add(counts):
        for k, c in counts.items():
            att_launches[k] += c

    for name, max_len, seed, n_singles, n_bursts in (
            ("seq512", 512, 512, 16, 2), ("seq1024", 1024, 1024, 8, 1)):
        counts, main[f"sequential_{max_len}"] = asyncio.run(sequential_phase(
            name, max_len, ctx, seed=seed, n_singles=n_singles, n_bursts=n_bursts))
        add(counts)
    fit_counts, serve_counts, main["train_512"] = train_phase(
        "seq-train512", 512, TRAIN_ROWS, TRAIN_EPOCHS, ctx, seed=11,
        parity=True, deploy=True)
    add(fit_counts)
    add(serve_counts)
    fit_counts, _, main["train_1024"] = train_phase(
        "seq-train1024", 1024, TRAIN_ROWS_1024, TRAIN_EPOCHS_1024, ctx, seed=12)
    add(fit_counts)
    # the sequential template from stored events, then interrupted fits
    # resumed from their checkpoints
    with tempfile.TemporaryDirectory() as tmp:
        for name, phase in (("seq_workflow", seq_workflow_phase),
                            ("seq_eval", seq_eval_phase),
                            ("seq_launch", seq_launch_phase),
                            ("seq_tp", seq_tp_phase),
                            ("seq_moe", seq_moe_phase),
                            ("seq_axes", seq_axes_phase)):
            t0 = time.perf_counter()
            counts, main[name] = phase(ctx, tmp)
            main[name]["phase_s"] = time.perf_counter() - t0
            log(f"[{name}] phase {main[name]['phase_s']:.1f} s")
            add(counts)

        # interrupted fits resumed in this process while seq-ckpt's members
        # (split weights saved and resumed) start and run beside it
        def ckpt_resume():
            t0 = time.perf_counter()
            counts, rec = ckpt_resume_phase(ctx, tmp)
            rec["phase_s"] = time.perf_counter() - t0
            log(f"[ckpt_resume] phase {rec['phase_s']:.1f} s")
            return counts, rec

        (counts, main["seq_ckpt"]), (resume_counts, main["ckpt_resume"]) = (
            seq_ckpt_phase(ctx, tmp, meanwhile=ckpt_resume))
        log(f"[seq_ckpt] phase {main['seq_ckpt']['phase_s']:.1f} s (ckpt_resume "
            f"beside it)")
        add(resume_counts)
        add(counts)
    launches.update(att_launches)
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the main path")
    # the similar-product, recommended-user, e-commerce and classification
    # templates: no kernel of the repo lies on their paths
    with tempfile.TemporaryDirectory() as tmp:
        main["templates"] = template_phases(ctx, tmp)

    def entry(name, source, replaces, cases, main_case):
        return {"name": name, "route": "cuda",
                "source": f"incubator_predictionio_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": main_case["ms"], "device_ms": main_case["device_ms"],
                "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"],
                "launch_floor_ms": floor["device_ms"],
                "shape": {k: main_case[k] for k in main_case
                          if k in ("B", "H", "L", "N", "C", "R", "D")}}

    def bwd_entry(name, source, replaces, cases, grads=("dq", "dk", "dv")):
        main_case = cases[0]  # the training shape
        e = entry(name, source, replaces, cases,
                  {**main_case, **main_case["kernels"][name]})
        e["max_abs_err"] = max(c["errors"][g]["max_abs_err"]
                               for c in cases for g in grads)
        if "parts" in main_case["kernels"][name]:
            e["parts"] = main_case["kernels"][name]["parts"]
        return e

    b1024 = main["rec_batchpredict"]["k1_b1024"]
    seq_children = [q["attention_launches"]
                    for q in main["seq_launch"]["processes"]]
    tp_children = [q["attention_launches"] for q in main["seq_tp"]["processes"]]
    moe_children = [q["attention_launches"] for q in main["seq_moe"]["processes"]]
    pipe_children = [q["attention_launches"]
                     for q in main["seq_axes"]["pipe"]["processes"]]
    ckpt_children = {name: r["launches"]
                     for name, r in main["seq_ckpt"]["layouts"].items()}
    kernels = [
        {**entry("score_catalog_quantized", "retrieval.cu",
                 "incubator_predictionio_tpu/ops/retrieval.py:97", k1,
                 next(c for c in k1 if c["B"] == 64 and c["D"] == RANK
                      and not c["row_mask"])),
         "rec_batchpredict": {
             **{k: b1024[k] for k in ("B", "N", "D", "max_abs_err", "ms",
                                      "device_ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
             "launches": main["rec_batchpredict"]["launches"][
                 "score_catalog_quantized"]},
         "rec_model_launches": main["rec_model"]["launches"][
             "score_catalog_quantized"],
         "rec_reload_launches": main["rec_reload"]["launches"][
             "score_catalog_quantized"],
         "rec_obs_launches": main["rec_obs"]["launches"][
             "score_catalog_quantized"],
         "rec_obs_trace_device_ms": main["rec_obs"]["trace"]["k1_device_ms"]},
        {**entry("score_centroids_quantized", "retrieval.cu",
                 "incubator_predictionio_tpu/ops/retrieval.py:188", k2,
                 next(c for c in k2 if c["B"] == 64)),
         "rec_shard_launches": main["rec_shard"]["launches"][
             "score_centroids_quantized"]},
        {**entry("adam_rows", "sparse_update.cu",
                 "incubator_predictionio_tpu/ops/sparse_update.py:93", k3,
                 next(c for c in k3 if (c["R"], c["D"]) == K3_MAIN)),
         "host_fused_ms": next(c for c in k3 if "ms" in c)["host_fused_ms"],
         "device_engine_ms": next(c for c in k3 if "ms" in c)["device_engine_ms"],
         "k3b_device_ms": k3b["device_ms"], "k3b_plain_ms": k3b["plain_ms"],
         "rec_reload_stream_process_launches": main["rec_reload"][
             "stream_verb"]["process_launches"]["adam_rows"],
         "d129": {k: v for k, v in next(
             c for c in k3 if (c["R"], c["D"]) == K3_REC).items()
             if k in ("max_abs_err", "max_ulps", "bitwise_plain", "ms",
                      "device_ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_by", "host_fused_ms", "device_engine_ms")}},
        {**entry("causal_mha_small_head", "attention.cu",
                 "incubator_predictionio_tpu/ops/attention.py:122", k4,
                 next(c for c in k4 if c["B"] == 64)),
         "seq_launch_process_launches": [
             c["causal_mha_small_head"] for c in seq_children],
         "seq_tp_process_launches": [
             c["causal_mha_small_head"] for c in tp_children],
         "seq_moe_process_launches": [
             c["causal_mha_small_head"] for c in moe_children],
         "seq_axes_pipe_process_launches": [
             c["causal_mha_small_head"] for c in pipe_children],
         "seq_ckpt_process_launches": {
             name: [c["causal_mha_small_head"] for c in cs]
             for name, cs in ckpt_children.items()}},
        {**bwd_entry("causal_mha_small_head_bwd", "attention.cu",
                     "incubator_predictionio_tpu/ops/attention.py:136", k4b),
         "seq_launch_process_launches": [
             c["causal_mha_small_head_bwd"] for c in seq_children],
         "seq_tp_process_launches": [
             c["causal_mha_small_head_bwd"] for c in tp_children],
         "seq_moe_process_launches": [
             c["causal_mha_small_head_bwd"] for c in moe_children],
         "seq_axes_pipe_process_launches": [
             c["causal_mha_small_head_bwd"] for c in pipe_children],
         "seq_ckpt_process_launches": {
             name: [c["causal_mha_small_head_bwd"] for c in cs]
             for name, cs in ckpt_children.items()}},
        entry("flash_causal_attention", "flash_attention.cu",
              "incubator_predictionio_tpu/parallel/ring.py:201", k5,
              next(c for c in k5 if c["B"] == 64)),
        bwd_entry("flash_causal_attention_bwd_dkv", "flash_attention.cu",
                  "jax/experimental/pallas/ops/tpu/flash_attention.py:1121", k5b,
                  ("dk", "dv")),
        bwd_entry("flash_causal_attention_bwd_dq", "flash_attention.cu",
                  "jax/experimental/pallas/ops/tpu/flash_attention.py:1456", k5b,
                  ("dq",)),
    ]
    record = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "k1_cases": k1, "k2_cases": k2, "k4_cases": k4, "k5_cases": k5,
              "k4_bwd_cases": k4b, "k5_bwd_cases": k5b,
              "k3_cases": k3, "k3b": k3b, "launch_floor": floor,
              "topk_tie_check": topk,
              "main_path": main, "kernels": kernels,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "wall_s": time.perf_counter() - t_start}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(record, indent=1, default=str))
    log(f"total wall time {record['wall_s']:.1f} s; peak device memory "
        f"since the last training phase began "
        f"{record['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    log(f"launch floor (fill_ of one element, device ms): "
        f"{floor['device_ms']:.5f}")
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
