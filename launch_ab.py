#!/usr/bin/env python3
"""Four choices of the training paths, each held against its alternative:
timed on the card in alternating turns, or counted on the CPU.

Run from the repo root on a machine with an NVIDIA card and PyTorch built
for CUDA::

    python3 launch_ab.py [--out chiprun_out/launch_ab.json]
    python3 launch_ab.py --seq [--out chiprun_out/seq_det.json]

``--small`` runs them at toy sizes, on the CPU where there is no card (a
check that the script runs; its times mean nothing). ``--cpu-repeats N``
runs only part 3, which needs no card; ``--seq`` runs only part 4.

1. The scatter of a step's row gradients into the dense table gradients:
   ``index_put_(accumulate=True)`` ("sorted": a stable sort of the indices,
   each row's duplicates summed in that order, the same sums every run)
   against ``index_add_`` ("atomic": atomic adds, whose order among a row's
   duplicates varies from run to run). At rec-train's shape (1,000,000
   users x 100,000 items, rank 128, batch 65,536, bf16 adam moments) and
   at rec-launch's (100,000 x 100,000, rank 128, the global batch 65,536,
   fp32 moments), over batches staged by ``_stage_batches`` (each sorted
   by user): a whole step (``_row_grads``, both scatters, ``adam_apply``)
   and the two scatters alone, timed with CUDA events in turns in the
   order sorted, atomic, atomic, sorted (twice), after one untimed turn of
   each. Beside the times: each variant run twice over the same steps from
   the same tables, and the largest difference between the two runs.
2. rec-launch's sharded read, ``assemble_triples(n_shards=2,
   shard_index=0)`` on a sqlite store of 400,000 rate events made as
   ``chip_smoke.py``'s phase makes them: the sqlite backend's read, which
   selects the shard in SQL (``SqliteEvents._find_shard``), against the
   base class's, which decodes every event and keeps its shard's
   (``EventStore._find_shard``), on the host clock, in the order SQL,
   scan, scan, SQL. The two reads must return the same triples.
3. Adam's square root on the CPU (``--cpu-repeats N [--load L]``): N fresh
   processes for each root, taken in turns, each running the
   single-process loop twice from the same tables at a toy shape (3,000 x
   3,000, rank 16, 30,000 rows, 2 epochs) while L busy loops load the
   CPU. Counted: the processes whose first fit differs from their second,
   with numpy's root (``utils/optim.py:_sqrt_``) and with PyTorch's
   (``torch._foreach_sqrt_``), and how far PyTorch's first roots lie from
   the correctly rounded ones, in float32 ulps.
4. The sequential training step (``--seq``) at ``seq-launch``'s global
   batch (64 rows of 512 tokens, d_model 512, 6 layers of 8 heads, vocab
   10,000): (a) the same step from the same parameters three times, with
   the attention kernels and with the plain attention, each parameter's
   gradient compared bitwise with the first run's, and every aten op of
   two runs traced (a dispatch mode digesting each op's inputs and
   outputs) to name the first op whose results differ; (b) the step
   under ``torch.use_deterministic_algorithms(True)`` with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in a process of its own (a
   diagnosis only); (c) the step's time with the embedding lookups'
   backward as ``F.embedding``'s against the port's ``_lookup`` (a sorted
   float64 scan), in turns, and two runs of 8 steps each, how far apart.

Prints the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``) and,
last, one JSON object with every number.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from incubator_predictionio_tpu_torch.models import two_tower as tt  # noqa: E402
from incubator_predictionio_tpu_torch.utils.optim import (  # noqa: E402
    adam_apply,
    adam_tree_init,
)

LR, REG = 1e-2, 1e-4


def scatter_sorted(grad, idx, rows):
    grad.index_put_((idx.long(),), rows, accumulate=True)


def scatter_atomic(grad, idx, rows):
    grad.index_add_(0, idx, rows)


SCATTERS = {"sorted": scatter_sorted, "atomic": scatter_atomic}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(dev, fn) -> float:
    """Seconds of ``fn()``: CUDA events on the card, the host clock else."""
    if dev.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def scatter_case(dev, name, n_users, n_items, rank, batch, n_batches,
                 moments, seed=7) -> dict:
    rng = np.random.default_rng(seed)
    n = batch * n_batches
    cfg = tt.TwoTowerConfig(rank=rank, batch_size=batch, seed=seed)
    staged = tt._stage_batches(
        cfg, rng.integers(0, n_users, n).astype(np.int32),
        rng.integers(0, n_items, n).astype(np.int32),
        (1.0 + 4.0 * rng.random(n)).astype(np.float32))
    ub, ib, rb, wb = (torch.from_numpy(a).to(dev) for a in staged[:4])
    init = tt._init_tables(cfg, n_users, n_items, dev,
                           torch.Generator(device=dev).manual_seed(seed))

    def fresh():
        tables = [t.clone() for t in init]
        return tables, [torch.empty_like(t) for t in tables], \
            adam_tree_init(tables, moments)

    def steps(scatter, tables, grads, state):
        for b in range(n_batches):
            gu, gi, _ = tt._row_grads(tables, ub[b], ib[b], rb[b], wb[b], REG,
                                      wb[b].sum().clamp(min=1.0))
            for g, idx, rows in ((grads[0], ub[b], gu), (grads[1], ib[b], gi)):
                g.zero_()
                scatter(g, idx, rows)
            adam_apply(tables, grads, state, LR)

    # the scatters alone: one batch's row gradients, scattered again and again
    tables, grads, _ = fresh()
    gu, gi, _ = tt._row_grads(tables, ub[0], ib[0], rb[0], wb[0], REG,
                              wb[0].sum().clamp(min=1.0))
    reps = 20

    def scatters(scatter):
        for _ in range(reps):
            for g, idx, rows in ((grads[0], ub[0], gu), (grads[1], ib[0], gi)):
                g.zero_()
                scatter(g, idx, rows)

    step_ms = {k: [] for k in SCATTERS}
    scatter_ms = {k: [] for k in SCATTERS}
    for k in SCATTERS:  # untimed turns
        steps(SCATTERS[k], *fresh())
        scatters(SCATTERS[k])
    sync(dev)
    order = ["sorted", "atomic", "atomic", "sorted"] * 2
    for k in order:
        state = fresh()
        sync(dev)
        step_ms[k].append(timed(dev, lambda: steps(SCATTERS[k], *state))
                          * 1e3 / n_batches)
        scatter_ms[k].append(timed(dev, lambda: scatters(SCATTERS[k]))
                             * 1e3 / reps)
    rerun = {}
    for k in SCATTERS:
        outs = []
        for _ in range(2):
            tables, grads, state = fresh()
            steps(SCATTERS[k], tables, grads, state)
            outs.append([t.cpu() for t in tables])
        rerun[k] = max(float((a - b).abs().max()) for a, b in zip(*outs))
    out = {"shape": {"users": n_users, "items": n_items, "rank": rank,
                     "batch": batch, "batches": n_batches, "moments": moments},
           "step_ms": step_ms, "scatter_ms": scatter_ms,
           "step_ms_median": {k: statistics.median(v) for k, v in step_ms.items()},
           "scatter_ms_median": {k: statistics.median(v)
                                 for k, v in scatter_ms.items()},
           "rerun_max_abs_diff": rerun}
    med = out["step_ms_median"]
    print(f"[scatter {name}] step ms: sorted {med['sorted']:.4f}, atomic "
          f"{med['atomic']:.4f} ({med['sorted'] / med['atomic']:.3f}x); the "
          f"scatters alone: sorted {out['scatter_ms_median']['sorted']:.4f}, "
          f"atomic {out['scatter_ms_median']['atomic']:.4f}; two runs differ "
          f"by {rerun}", flush=True)
    return out


def read_case(n_users, n_items, n_events) -> dict:
    from incubator_predictionio_tpu_torch.data import event as tevent
    from incubator_predictionio_tpu_torch.data.storage import base as tbase
    from incubator_predictionio_tpu_torch.data.storage import registry as treg

    rng = np.random.default_rng(23)  # chip_smoke.py's rec-launch events
    users = rng.integers(0, n_users, n_events)
    items = np.concatenate([rng.permutation(n_items), rng.integers(
        0, n_items, n_events - n_items)])
    ratings = (1.0 + 4.0 * rng.random(n_events)).astype(np.float32)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    with tempfile.TemporaryDirectory() as tmp:
        conf = {"PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
                "PIO_STORAGE_SOURCES_SQLITE_PATH": os.path.join(tmp, "pio.db")}
        storage = treg.Storage(conf)
        app_id = storage.get_meta_data_apps().insert(tbase.App(0, "ab"))
        ev = storage.get_events()
        ev.init(app_id)
        t = time.perf_counter()
        chunk = 20_000
        for lo in range(0, n_events, chunk):
            ev.insert_batch([tevent.Event.from_json_dict({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "properties": {"rating": float(r)},
                "eventTime": (t0 + dt.timedelta(seconds=lo + j)).isoformat()})
                for j, (u, i, r) in enumerate(zip(
                    users[lo:lo + chunk].tolist(), items[lo:lo + chunk].tolist(),
                    ratings[lo:lo + chunk].tolist()))], app_id)
        insert_s = time.perf_counter() - t
        sql_find = ev._find_shard
        scan_find = types.MethodType(tbase.EventStore._find_shard, ev)
        times = {"sql": [], "scan": []}
        results = {}
        for k in ("sql", "scan", "scan", "sql"):
            ev._find_shard = sql_find if k == "sql" else scan_find
            t = time.perf_counter()
            res = ev.assemble_triples(
                app_id, None, None, None, "user", ("rate", "buy"), "item",
                "rating", {"buy": 4.0}, 0.0, True, n_shards=2, shard_index=0)
            times[k].append(time.perf_counter() - t)
            results.setdefault(k, res)
        same = all(np.array_equal(a, b) for a, b in zip(results["sql"],
                                                         results["scan"]))
        storage.close()
    if not same:
        raise SystemExit("the SQL-selected shard and the scanned shard differ")
    out = {"events": n_events, "insert_s": insert_s, "rows": len(results["sql"][4]),
           "read_s": times, "read_s_median": {k: statistics.median(v)
                                              for k, v in times.items()}}
    med = out["read_s_median"]
    print(f"[read] {n_events} events inserted in {insert_s:.2f} s; shard 0 of 2 "
          f"({out['rows']} rows): SQL {times['sql']} s, scan {times['scan']} s "
          f"(scan / SQL {med['scan'] / med['sql']:.3f}x); equal triples", flush=True)
    return out


REPEAT_CHILD = r"""
import sys
import numpy as np
import torch
from incubator_predictionio_tpu_torch.models import two_tower as tt
from incubator_predictionio_tpu_torch.utils import optim

ulps = 0
if sys.argv[1] == "torch":
    def torch_sqrt(tensors):
        global ulps
        src = [t.clone() for t in tensors]
        torch._foreach_sqrt_(tensors)
        for t, x in zip(tensors, src):
            want = np.sqrt(x.numpy().astype(np.float64)).astype(np.float32)
            got = t.numpy().view(np.int32).astype(np.int64)
            ulps = max(ulps, int(np.abs(got - want.view(np.int32)).max()))
    optim._sqrt_ = torch_sqrt
rng = np.random.default_rng(1)
n, nu, ni = 30_000, 3_000, 3_000
cfg = tt.TwoTowerConfig(rank=16, batch_size=8192, epochs=2, seed=0)
staged = tt._stage_batches(cfg, rng.integers(0, nu, n).astype(np.int32),
                           rng.integers(0, ni, n).astype(np.int32),
                           (1 + 4 * rng.random(n)).astype(np.float32))
batches = [torch.from_numpy(a) for a in staged[:4]]
out = []
for _ in range(2):
    tables = list(tt._init_tables(cfg, nu, ni, torch.device("cpu"),
                                  torch.Generator().manual_seed(0)))
    tt._train_epochs(tables, [torch.empty_like(t) for t in tables],
                     optim.adam_tree_init(tables, "float32"), *batches,
                     3e-2, 1e-4, 2)
    out.append(torch.cat(tables).numpy().copy())
print(float(np.abs(out[0] - out[1]).max()), ulps)
"""


def repeat_case(n_procs: int, load: int) -> dict:
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(load)]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    res = {k: {"differ": 0, "max_abs_diff": 0.0, "max_ulps": 0}
           for k in ("numpy", "torch")}
    try:
        for _ in range(n_procs):
            for k in res:
                out = subprocess.run([sys.executable, "-c", REPEAT_CHILD, k],
                                     capture_output=True, text=True, env=env,
                                     timeout=300, check=True)
                diff, ulps = out.stdout.split()
                r = res[k]
                r["differ"] += float(diff) > 0
                r["max_abs_diff"] = max(r["max_abs_diff"], float(diff))
                r["max_ulps"] = max(r["max_ulps"], int(ulps))
    finally:
        for p in busy:
            p.kill()
            p.wait()
    print(f"[cpu sqrt] {n_procs} processes each, {load} busy loops: first fit "
          f"differs from the second in {res['numpy']['differ']} with numpy's "
          f"root, {res['torch']['differ']} with PyTorch's (its roots up to "
          f"{res['torch']['max_ulps']} ulps off)", flush=True)
    return {"processes": n_procs, "load": load, **res}


SEQ_SHAPE = {"rows": 64, "max_len": 512, "d_model": 512, "n_layers": 6,
             "n_heads": 8, "vocab": 10_000}
SEQ_SHAPE_SMALL = {"rows": 4, "max_len": 64, "d_model": 64, "n_layers": 2,
                   "n_heads": 2, "vocab": 300}


def seq_batch(shape, seed=31):
    """One global batch of ``seq-launch``'s sessions (chip_smoke.py's
    ``cycle_sessions``: a random start over the vocabulary's items, lengths
    16 to 128, each item followed by the next of the cycle), left-padded
    to ``max_len + 1`` tokens as ``encode_session`` pads them."""
    rng = np.random.default_rng(seed)
    rows, max_len, n_items = shape["rows"], shape["max_len"], shape["vocab"] - 1
    starts = rng.integers(0, n_items, rows)
    lengths = rng.integers(16, 129, rows)
    seqs = np.zeros((rows, max_len + 1), np.int64)
    for r, (s0, m) in enumerate(zip(starts, lengths)):
        toks = (1 + (s0 + np.arange(m)) % n_items)[-(max_len + 1):]
        seqs[r, -len(toks):] = toks
    tokens, targets = seqs[:, :-1], seqs[:, 1:]
    weights = ((targets != 0) & (tokens != 0)).astype(np.float32)
    return tokens, targets, weights


def seq_setup(dev, shape):
    from incubator_predictionio_tpu_torch.models import transformer as ttr

    cfg = ttr.TransformerConfig(
        vocab_size=shape["vocab"], max_len=shape["max_len"],
        d_model=shape["d_model"], n_heads=shape["n_heads"],
        n_layers=shape["n_layers"], batch_size=shape["rows"], seed=0)
    init = ttr._init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens, targets, weights = seq_batch(shape)
    pos = np.broadcast_to(np.arange(shape["max_len"]), tokens.shape)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in (tokens, pos, targets, weights))
    return cfg, init, batch


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A position-weighted sum of ``t``'s bit patterns (int64, on its
    device): equal for bitwise-equal tensors, different otherwise in all
    but a negligible share of cases."""
    t = t.detach().contiguous().reshape(-1)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16, torch.float64: torch.int64}
    v = t.view(ints[t.dtype]) if t.dtype in ints else t
    v = v.to(torch.int64)
    w = torch.arange(1, v.numel() + 1, device=v.device, dtype=torch.int64) % 1_000_003
    return (v * (w + 1)).sum()


def _op_trace_mode():
    """A dispatch mode that logs every aten op of a step (forward and
    backward) with the bit digests of its tensor inputs and outputs. A
    hand-written kernel is no aten op: its outputs show as the inputs of
    the ops that read them."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class OpTrace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [_bits(a) for a in tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor) and a.numel()]
            # an empty tensor's bytes are whatever the allocator held
            outs = [] if "empty" in str(func) else [
                _bits(a) for a in tree_leaves(out)
                if isinstance(a, torch.Tensor) and a.numel()]
            self.ops.append((str(func), ins, outs))
            return out

    return OpTrace()


def seq_grads(cfg, init, batch, dev, attention=None, trace=None):
    """One training step's loss and gradients (the fit's ``train_loss`` and
    autograd) from a fresh net on ``init``; with ``trace``, under it."""
    from incubator_predictionio_tpu_torch.models import transformer as ttr
    from incubator_predictionio_tpu_torch.parallel.ring import causal_attention

    net = ttr.TransformerNet(init, cfg, dev, trainable=True)
    params = list(net.parameters())
    names = [n for n, _ in net.named_parameters()]
    att = attention or causal_attention
    if trace is None:
        loss = ttr.train_loss(net, *batch, attention=att)
        grads = torch.autograd.grad(loss, params)
    else:
        with trace:
            loss = ttr.train_loss(net, *batch, attention=att)
            grads = torch.autograd.grad(loss, params)
    sync(dev)
    return names, loss.detach().cpu(), [g.detach().cpu() for g in grads]


def first_difference(a, b) -> Optional[dict]:
    """The first op of two traces whose inputs or outputs differ."""
    for k, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0]:
            return {"index": k, "op": x[0], "other_op": y[0], "what": "op order"}
        xi, yi = torch.stack(x[1]).cpu() if x[1] else None, \
            torch.stack(y[1]).cpu() if y[1] else None
        xo, yo = torch.stack(x[2]).cpu() if x[2] else None, \
            torch.stack(y[2]).cpu() if y[2] else None
        ins_differ = xi is not None and not torch.equal(xi, yi)
        outs_differ = xo is not None and not torch.equal(xo, yo)
        if ins_differ or outs_differ:
            return {"index": k, "op": x[0], "inputs_differ": ins_differ,
                    "outputs_differ": outs_differ,
                    "before": [o[0] for o in a[max(0, k - 6):k]]}
    return None


def seq_determinism(dev, shape, runs: int = 3) -> dict:
    """Part 4a: the same training step from the same parameters, ``runs``
    times, with the attention kernels and with the plain attention; each
    parameter's gradient compared bitwise with the first run's (in the
    backward's order: the last parameters first), and every aten op of the
    step traced to name the first one whose inputs or outputs differ."""
    from incubator_predictionio_tpu_torch.parallel.ring import (
        causal_attention_reference,
    )

    cfg, init, batch = seq_setup(dev, shape)
    out = {"shape": shape}
    for label, att in (("kernels", None), ("plain", causal_attention_reference)):
        base = seq_grads(cfg, init, batch, dev, att)
        differ = []
        for _ in range(runs - 1):
            names, loss, grads = seq_grads(cfg, init, batch, dev, att)
            differ.append({
                "loss_equal": bool(torch.equal(loss, base[1])),
                "grads_differ": [n for n, g, h in zip(names, grads, base[2])
                                 if not torch.equal(g, h)][::-1]})
        traces = []
        for _ in range(2):
            tr = _op_trace_mode()
            seq_grads(cfg, init, batch, dev, att, tr)
            traces.append(tr.ops)
        out[label] = {"runs": differ, "ops": len(traces[0]),
                      "first_op_difference": first_difference(*traces)}
        print(f"[seq determinism {label}] {differ}; {len(traces[0])} ops; first "
              f"difference {out[label]['first_op_difference']}", flush=True)
        del traces
    return out


def seq_step_case(dev, shape, steps: int = 8) -> dict:
    """Part 4c: the training step (forward, backward, adam) with the two
    embedding lookups' backward as ``F.embedding``'s ("embedding") and as
    the port's ``models/transformer.py:_lookup`` ("sorted_scan"), timed
    with CUDA events in turns in the order embedding, sorted_scan,
    sorted_scan, embedding (twice), after one untimed turn of each; and
    each run twice for ``steps`` steps from the same parameters, the
    largest difference between the two runs' parameters."""
    import torch.nn.functional as F

    from incubator_predictionio_tpu_torch.models import transformer as ttr
    from incubator_predictionio_tpu_torch.utils.optim import adam_init

    cfg, init, batch = seq_setup(dev, shape)
    ours = ttr._lookup
    variants = {"embedding": lambda idx, table: F.embedding(idx, table),
                "sorted_scan": ours}

    def fit(name, n):
        ttr._lookup = variants[name]
        net = ttr.TransformerNet(init, cfg, dev, trainable=True)
        opt = adam_init(list(net.parameters()))
        sync(dev)
        sec = timed(dev, lambda: [ttr.train_step(net, opt, batch, 1e-3)
                                  for _ in range(n)])
        return sec * 1e3 / n, [p.detach().cpu() for p in net.parameters()]

    try:
        for k in variants:
            fit(k, 2)
        step_ms = {k: [] for k in variants}
        for k in ["embedding", "sorted_scan", "sorted_scan", "embedding"] * 2:
            step_ms[k].append(fit(k, steps)[0])
        rerun = {}
        for k in variants:
            a, b = fit(k, steps)[1], fit(k, steps)[1]
            rerun[k] = max(float((x - y).abs().max()) for x, y in zip(a, b))
    finally:
        ttr._lookup = ours
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    print(f"[seq step] ms a step: embedding {med['embedding']:.4f}, sorted_scan "
          f"{med['sorted_scan']:.4f} ({med['sorted_scan'] / med['embedding']:.4f}x); "
          f"two {steps}-step runs differ by {rerun}", flush=True)
    return {"shape": shape, "steps": steps, "step_ms": step_ms,
            "step_ms_median": med, "rerun_max_abs_diff": rerun}


SEQ_DET_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import launch_ab as ab
torch.use_deterministic_algorithms(True)
dev = torch.device("cuda")
shape = json.loads(sys.argv[2])
cfg, init, batch = ab.seq_setup(dev, shape)
try:
    a = ab.seq_grads(cfg, init, batch, dev)
    b = ab.seq_grads(cfg, init, batch, dev)
    print(json.dumps({"error": None, "grads_differ": [
        n for n, g, h in zip(a[0], a[2], b[2]) if not torch.equal(g, h)]}))
except RuntimeError as e:
    print(json.dumps({"error": str(e)[:600]}))
"""


def seq_deterministic_child(shape) -> dict:
    """Part 4b: the step under ``torch.use_deterministic_algorithms(True)``
    with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, in a process of its own (a
    diagnosis only: the program sets neither): the op that refuses, or
    whether two steps are then bitwise."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    res = subprocess.run(
        [sys.executable, "-c", SEQ_DET_CHILD,
         os.path.dirname(os.path.abspath(__file__)), json.dumps(shape)],
        capture_output=True, text=True, env=env, timeout=600)
    lines = res.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if lines else {"error": res.stderr[-2000:]}
    print(f"[seq determinism, deterministic algorithms] {out}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="toy sizes (on the CPU where there is no card)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--cpu-repeats", type=int, default=0,
                    help="run only part 3, with this many processes a root")
    ap.add_argument("--seq", action="store_true",
                    help="run only part 4, the sequential step")
    ap.add_argument("--load", type=int, default=3,
                    help="busy loops beside part 3's processes")
    args = ap.parse_args()
    if args.cpu_repeats:
        print(json.dumps({"cpu_sqrt": repeat_case(args.cpu_repeats, args.load)}))
        return 0
    if not args.small and not torch.cuda.is_available():
        print("launch_ab.py: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        smi = "no nvidia-smi"
    print(smi, flush=True)
    if args.seq:
        shape = SEQ_SHAPE_SMALL if args.small else SEQ_SHAPE
        out = {"device": smi, "torch": torch.__version__,
               "seq_determinism": seq_determinism(dev, shape),
               "seq_step": seq_step_case(dev, shape)}
        if dev.type == "cuda":
            out["seq_deterministic_algorithms"] = seq_deterministic_child(shape)
        line = json.dumps(out)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                f.write(line + "\n")
        print(line)
        return 0
    if args.small:
        cases = [("rec-train", 2_000, 500, 16, 512, 4, "bfloat16"),
                 ("rec-launch", 800, 800, 16, 512, 4, "float32")]
        read = (300, 300, 3_000)
    else:
        cases = [("rec-train", 1_000_000, 100_000, 128, 65_536, 8, "bfloat16"),
                 ("rec-launch", 100_000, 100_000, 128, 65_536, 7, "float32")]
        read = (100_000, 100_000, 400_000)
    out = {"device": smi, "torch": torch.__version__,
           "scatter": {c[0]: scatter_case(dev, *c) for c in cases}}
    out["read"] = read_case(*read)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
