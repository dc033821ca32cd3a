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

Between those two, ``rec-stream`` streams into rec-train's persisted
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
``rec-workflow`` (RecommendationEvaluation over the reference grid, rank
16/32 × 10/20 iterations, 3 folds: 12 fits on the card, FastEvalEngine's
one read and one prepare, Precision@10 beside chance, variant 0 again on
the CPU), ``seq-eval`` after ``seq-workflow`` (SequentialEvaluation at the
sequential training width, epochs 1/2 × learning rate 1e-3/5e-3: K4
forward and backward in every fold's fit, the held-out queries checked
against the sessions, 16 queries with the kernels against the plain
attention) and ``cls-eval`` after ``cls-workflow`` (CompleteEvaluation:
accuracy and each label's precision, ``best.json``, variant 0 on the CPU).

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
the one-process output. ``rec-launch-eval`` runs ``launch -n 2 eval`` on
rec-workflow's stored events (sharded folds, data-parallel fits, one
EVALCOMPLETED row by process 0, each fold's query set against the one
computed from the events); ``seq-launch``, after ``seq-eval``, runs
``launch -n 2 train`` of the sequential template on seq-workflow's stored
sessions at its full width (K4 forward and backward in both processes,
one all-reduce of the gradients a step), replays both shards' batches in
one process (split into the processes' local batches, twice: two
identical fits on the card must end bitwise; and whole) against the
launched model, and serves it through K4 against the plain attention.

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
import contextlib
import dataclasses
import gc
import json
import logging
import os
import re
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
                scores = (ue[uidx].float() @ item_t + item_b[None, :]
                          + ub[uidx][:, None] + model.mean + mask[None, :])
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
#: the sequential phases' lengths, and the reference's other shapes
K4_SHAPES = ((1, 8, 512, 64), (8, 8, 512, 64), (64, 8, 512, 64),
             (3, 8, 128, 128), (8, 8, 192, 64))
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
#: a ragged last 128-row query tile
K4_BWD_SHAPES = ((64, 8, 512, 64), (3, 8, 128, 128), (8, 8, 192, 64))
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
    """POST each payload; returns (bodies, latencies in s). All must be 200."""
    async def one(p):
        t0 = time.perf_counter()
        async with session.post(url, json=p) as resp:
            body = await resp.json()
            check(resp.status == 200, f"status {resp.status} for {p}: {body}")
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


def check_against_plain(model, payloads, bodies):
    """The served answers (kernel attention) against the same model's
    forward with the plain attention version, on the card: every served
    score within :data:`SEQ_SCORE_TOL` of the plain score of that item, and
    the ids equal up to near-ties at the last place (the scores are bf16
    values, so ties are common). Where one bf16 step at the score's
    magnitude is larger than :data:`SEQ_SCORE_TOL` (scores of 4 and more,
    0.03125), one step is the band: the two fp32 sums then round to
    neighbouring bf16 values. Returns the largest score difference and the
    counts of equal id sets and orders."""
    from incubator_predictionio_tpu_torch.models.transformer import (
        TransformerRecommender,
    )
    from incubator_predictionio_tpu_torch.parallel.ring import (
        causal_attention_reference,
    )
    from incubator_predictionio_tpu_torch.templates.sequential import (
        encode_session,
    )

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
                  f"top-{num} differs from the plain path beyond a near-tie: "
                  f"{got} vs {want}")
        for x in body["itemScores"]:
            plain = float(s[model.item_map[x["item"]]])
            diff = abs(x["score"] - plain)
            worst = max(worst, diff)
            check(diff <= max(SEQ_SCORE_TOL, bf16_ulp(plain)),
                  f"score {x} vs plain {plain}")
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
            os.environ["PIO_STREAM_FUSED"] = "device"
            try:
                t0 = time.perf_counter()
                out = await loop.run_in_executor(None, up.run_once)
                device_s = time.perf_counter() - t0
            finally:
                del os.environ["PIO_STREAM_FUSED"]
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
    t0 = time.perf_counter()
    model = rec_fit(ctx, data, seed=1)
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    one = rec_fit(ctx, data, seed=1, epochs=1)
    loss_1 = one.final_loss
    del one
    steps, flops, nbytes = two_tower_flops_bytes(
        REC_EVENTS, REC_RANK, REC_BATCH, REC_EPOCHS, REC_USERS, REC_ITEMS,
        moment_bytes=2 if REC_MOMENTS == "bfloat16" else 4)
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
           "peak_device_bytes": peak}
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
            s0 = time.perf_counter()
            out = run(["train", "-v", variant_path, "--device", str(ctx.device)])
            rec["train_s"] = time.perf_counter() - s0
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


#: seq-workflow: bench_sequential's widths (bench.py:897-899) trained from
#: events in the store; 2,048 users' cycle sessions of 16-128 items (~150k
#: view events: the session count is the cut, for the import's time at
#: ~58 µs an event)
SEQ_WF_USERS, SEQ_WF_LENGTHS, SEQ_WF_MAX_LEN = 2048, (16, 128), 512


async def seq_workflow_body(sessions_, session, url, server):
    """16 ``{"user": U}`` singles against 16 ``recentItems`` singles of the
    same users' last 512 items: the same top-10, scores within 1e-4; then a
    burst of 64 user queries. The trained loss falls over the 2 epochs."""
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
    batch 64, 2 epochs), the sessions read back from the store held against
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
              "epochs": TRAIN_EPOCHS}
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
           "batch": TRAIN_BATCH, "epochs": TRAIN_EPOCHS}
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


class RecEvalGrid:
    """rec-eval's EngineParamsGenerator (the CLI loads it by class path):
    the reference RecommendationEvaluation's grid, rank 16 / 32 ×
    ``num_iterations`` 10 / 20, on rec-workflow's app ``ml1m``."""

    def __init__(self):
        from incubator_predictionio_tpu_torch.core import EngineParams
        from incubator_predictionio_tpu_torch.templates import recommendation as trec

        self.engine_params_list = [
            EngineParams.create(
                data_source=trec.DataSourceParams(app_name="ml1m", eval_k=EVAL_K),
                algorithms=[("als", trec.ALSAlgorithmParams(
                    rank=rank, num_iterations=it))])
            for rank in (16, 32) for it in (10, 20)]


class SeqEvalGrid:
    """seq-eval's generator at seq-workflow's full width (d_model 512, 6
    layers, 8 heads of 64, ``max_len`` 512, batch 64): epochs 1 / 2 ×
    learning rate 1e-3 / 5e-3. The reference SequentialEvaluation's own
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
            for epochs in (1, 2) for lr in (1e-3, 5e-3)]


class ClsEvalGrid:
    """cls-eval's generator: the reference ``_classification_grid`` (hidden
    (16,) / (32, 32) × learning rate 1e-2 / 3e-2, 60 epochs) on
    cls-workflow's app ``cls``."""

    def __init__(self):
        from incubator_predictionio_tpu_torch.templates import classification as tcl

        self.engine_params_list = tcl._classification_grid("cls", EVAL_K)


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
    with :class:`RecEvalGrid` (4 variants × 3 folds = 12 fits on the card;
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
    log(f"[rec-eval] Precision@10 of rank 16/32 × 10/20 iterations "
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
        self.process_index = index
        self.process_count = len(script[0])
        self.device = device
        self._script = list(script)

    def allgather_obj(self, obj):
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
    rng = np.random.default_rng(23)
    users = rng.integers(0, LAUNCH_USERS, LAUNCH_EVENTS)
    items = np.concatenate([rng.permutation(LAUNCH_ITEMS), rng.integers(
        0, LAUNCH_ITEMS, LAUNCH_EVENTS - LAUNCH_ITEMS)])
    ratings = (1.0 + 4.0 * rng.random(LAUNCH_EVENTS)).astype(np.float32)
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


# -- phase: launch -n 2 eval of the recommendation template ------------------

class RecLaunchEvalGrid:
    """rec-launch-eval's EngineParamsGenerator (each launched process loads
    it as ``chip_smoke:RecLaunchEvalGrid``): rank 16 / 32, 10 iterations,
    on rec-workflow's app ``ml1m``, 3 folds."""

    def __init__(self):
        from incubator_predictionio_tpu_torch.core import EngineParams
        from incubator_predictionio_tpu_torch.templates import recommendation as trec

        self.engine_params_list = [
            EngineParams.create(
                data_source=trec.DataSourceParams(app_name="ml1m", eval_k=EVAL_K),
                algorithms=[("als", trec.ALSAlgorithmParams(
                    rank=rank, num_iterations=10))])
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
    check(len(fits[0]) == len(fits[1]) == 2 * EVAL_K,
          f"[rec-launch-eval] {[len(f) for f in fits]} fits, want {2 * EVAL_K}")
    check(all(a[3] == b[3] for a, b in zip(*fits)),
          "[rec-launch-eval] a fit's replica digests differ across processes")
    res = json.loads(inst.evaluator_results_json)
    scores = [r["score"] for r in res["results"]]
    check(len(scores) == 2 and all(np.isfinite(scores))
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


async def seq_launch_body(sessions_, session, url, server, lat):
    """Bursts of 64 ``recentItems`` queries (prefixes of the stored
    sessions) through the launched model's K4 forward; the last burst held
    against the plain attention forward on the card."""
    rng = np.random.default_rng(41)
    bodies = payloads = None
    lat["burst64"] = []
    for _ in range(3):
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
    layers of 8 heads of 64, batch 64: 32 a process, 2 epochs), both
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
    (4 variants × 3 folds = 12 fits, K4 forward and backward in each,
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
    log(f"[seq-eval] HitRate@10 of epochs 1/2 × lr 1e-3/5e-3 "
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
            def allgather_obj(self, obj):
                return group._meet(index, obj, lambda parts: parts)

            def all_gather(self, t):
                return group._meet(index, t.contiguous(), torch.stack)

            def all_reduce_sum(self, t):
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
    (16,), learning rate 1e-2, 60 epochs), 3 folds, on cls-workflow's app
    ``cls``; one variant keeps the phase inside its time."""

    def __init__(self):
        from incubator_predictionio_tpu_torch.templates import classification as tcl

        self.engine_params_list = tcl._classification_grid("cls", EVAL_K)[:1]


def tpl_launch_specs():
    """(tag, the workflow phase's store, app, factory, algorithms, serving,
    16 queries) of each template's launch, at the workflow phases' widths."""
    rng = np.random.default_rng(43)
    item_ids = [f"i{j}" for j in range(SIM_ITEMS)]
    cls_rows = np.random.default_rng(44).normal(size=(80, 3)) * [1.0, 2.0, 0.5] \
        + [0.0, 3.0, -1.0]
    two = {"numIterations": 10, "seed": 1}
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
          {"name": "mlp", "params": {"hiddenDims": [64, 64], "epochs": 20}}],
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
                            ("ckpt_resume", ckpt_resume_phase)):
            t0 = time.perf_counter()
            counts, main[name] = phase(ctx, tmp)
            main[name]["phase_s"] = time.perf_counter() - t0
            log(f"[{name}] phase {main[name]['phase_s']:.1f} s")
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
                 "score_catalog_quantized"]}},
        entry("score_centroids_quantized", "retrieval.cu",
              "incubator_predictionio_tpu/ops/retrieval.py:188", k2,
              next(c for c in k2 if c["B"] == 64)),
        {**entry("adam_rows", "sparse_update.cu",
                 "incubator_predictionio_tpu/ops/sparse_update.py:93", k3,
                 next(c for c in k3 if (c["R"], c["D"]) == K3_MAIN)),
         "host_fused_ms": next(c for c in k3 if "ms" in c)["host_fused_ms"],
         "device_engine_ms": next(c for c in k3 if "ms" in c)["device_engine_ms"],
         "k3b_device_ms": k3b["device_ms"], "k3b_plain_ms": k3b["plain_ms"],
         "d129": {k: v for k, v in next(
             c for c in k3 if (c["R"], c["D"]) == K3_REC).items()
             if k in ("max_abs_err", "max_ulps", "bitwise_plain", "ms",
                      "device_ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_by", "host_fused_ms", "device_engine_ms")}},
        {**entry("causal_mha_small_head", "attention.cu",
                 "incubator_predictionio_tpu/ops/attention.py:122", k4,
                 next(c for c in k4 if c["B"] == 64)),
         "seq_launch_process_launches": [
             c["causal_mha_small_head"] for c in seq_children]},
        {**bwd_entry("causal_mha_small_head_bwd", "attention.cu",
                     "incubator_predictionio_tpu/ops/attention.py:136", k4b),
         "seq_launch_process_launches": [
             c["causal_mha_small_head_bwd"] for c in seq_children]},
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
