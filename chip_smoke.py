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
import gc
import json
import os
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
#: an H100 SXM's published peaks (NVIDIA data sheet, dense), at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
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
    """The device's busy share of a profiled wall time, and the ``top``
    names by device ms."""
    busy = sum(by_name.values())
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3),
            "top_device_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])}


def device_busy(fn, calls: int = 3):
    """Device time per call of everything ``fn`` runs on the card (every
    kernel and copy), from ``torch.profiler``, and the time by name."""
    fn()
    torch.cuda.synchronize()
    with cuda_profile() as by_name:
        for _ in range(calls):
            fn()
    by_name = {n: t / calls for n, t in by_name.items()}
    return sum(by_name.values()), by_name


def device_ms(fn, kernel: str, calls: int = 20):
    """Device time a call of the CUDA kernels whose names contain
    ``kernel`` (a wrapper may launch more than one), from ``torch.profiler``
    — without the host time of the Python wrapper that back-to-back timing
    of a tiny kernel measures. None when the profiler recorded no such
    kernel."""
    _, by_name = device_busy(fn, calls)
    hits = [t for n, t in by_name.items() if kernel in n]
    return sum(hits) if hits else None


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
        q, items_q, scales, bias, mask, row_mask), "score_catalog_kernel")
    out["plain_ms"] = time_ms(lambda: R.score_catalog_reference(
        q, items_q, scales, bias, mask, row_mask))
    # library yardstick: one fp32 matmul over the dequantized operands
    qf = q.to(torch.bfloat16).float()
    deq_t = (items_q.float() * scales[:, None]).T.contiguous()
    out["library_ms"] = time_ms(lambda: torch.matmul(qf, deq_t))
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
        f"plain_ms={out['plain_ms']:.4f} matmul_ms={out['library_ms']:.4f} "
        f"bound_ms={out['bound_ms']:.4f}")
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
           "bitwise_equal": bool(torch.equal(got, want))}
    out["ms"] = time_ms(lambda: R.score_centroids_quantized(q_q, q_s, cq, cs, cb))
    out["device_ms"] = device_ms(lambda: R.score_centroids_quantized(
        q_q, q_s, cq, cs, cb), "score_centroids_kernel")
    out["plain_ms"] = time_ms(lambda: R.score_centroids_reference(
        q_q, q_s, cq, cs, cb))
    qf, cf_t = q_q.float(), cq.float().T.contiguous()
    out["library_ms"] = time_ms(lambda: torch.matmul(qf, cf_t))
    nbytes = b * d + b * 4 + c * d + 2 * c * 4 + b * c * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * c * d / INT8_OPS_PER_S * 1e3
    out["bound_ms"] = max(t_bytes, t_ops)
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"K2 B={b:<4d} C={c} D={d:<3d} max_abs_err={err:.3e} "
        f"(rtol {K2_RTOL}, atol {K2_ATOL}) bitwise={out['bitwise_equal']} "
        f"ms={out['ms']:.4f} device_ms={fmt(out['device_ms'])} "
        f"plain_ms={out['plain_ms']:.4f} matmul_ms={out['library_ms']:.4f} "
        f"bound_ms={out['bound_ms']:.6f}")
    return out


def kernel_checks(R, user, item, item_bias, ivf, dev):
    """K1 at the exact path's shapes (D 32, N 1,000,448, B 1/8/64/128 and
    the row-mask variant at B 8) and at the recommendation_scaled width
    (D 128, N 100,352); K2 at the coarse probe's (D 32, C 1024, B 8/64/128).
    The catalog is the served one, quantized on the card."""
    items_q, scales, bias, mask = R.quantize_catalog_device(
        torch.from_numpy(item).to(dev), torch.from_numpy(item_bias).to(dev))
    hq, hs = R.quantize_rows(item)
    check(np.array_equal(items_q[:N_ITEMS].cpu().numpy(), hq)
          and np.array_equal(scales[:N_ITEMS].cpu().numpy(), hs),
          "device quantization differs from quantize_rows")
    log("quantize_catalog_device == quantize_rows bitwise on the served catalog")
    users = torch.from_numpy(user[:128]).to(dev)
    k1 = []
    for b in (1, 8, 64, 128):
        k1.append(k1_case(R, users[:b].contiguous(), items_q, scales, bias, mask))
    rng = np.random.default_rng(5)
    rm = np.zeros((8, items_q.shape[0]), np.float32)
    rm[np.arange(8)[:, None], rng.integers(0, N_ITEMS, (8, 16))] = -np.inf
    k1.append(k1_case(R, users[:8].contiguous(), items_q, scales, bias, mask,
                      torch.from_numpy(rm).to(dev)))
    n128, d128 = 100_000, 128
    it128 = rng.standard_normal((n128, d128)).astype(np.float32)
    q128 = torch.from_numpy(rng.standard_normal((64, d128)).astype(np.float32)).to(dev)
    k1.append(k1_case(R, q128, *R.quantize_catalog_device(
        torch.from_numpy(it128).to(dev),
        torch.from_numpy(rng.standard_normal(n128).astype(np.float32)).to(dev))))
    cent_q, cent_s = R.quantize_rows(np.asarray(ivf.centroids[:, :-1], np.float32))
    cq, cs, cb = (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for v in R.pad_centroids(
                      cent_q, cent_s, np.asarray(ivf.centroids[:, -1], np.float32)))
    k2 = []
    for b in (8, 64, 128):
        q_q, q_s = R.quantize_rows(user[:b])
        k2.append(k2_case(R, torch.from_numpy(q_q).to(dev),
                          torch.from_numpy(q_s).to(dev), cq, cs, cb))
    del items_q, scales, bias, mask
    return k1, k2


#: (B, H, L, D) of each attention case: the serving batches (1, 8, 64) at
#: the sequential phases' lengths, and the reference's other shapes
K4_SHAPES = ((1, 8, 512, 64), (8, 8, 512, 64), (64, 8, 512, 64),
             (3, 8, 128, 128))
K5_SHAPES = ((64, 8, 1024, 64), (8, 8, 768, 64), (8, 8, 640, 32),
             (8, 8, 512, 32))


def attention_case(A, name, shape, seed):
    """One attention kernel against its plain version on the same bf16
    tensors of the card (tolerance :data:`ATT_TOL`, absolute and relative,
    as the reference's kernel tests), with its times beside the bound and
    ``scaled_dot_product_attention`` as the library yardstick."""
    from incubator_predictionio_tpu_torch.parallel.ring import flash_block_size

    b, h, l, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    if name == "causal_mha_small_head":
        kernel = lambda: A.causal_mha_small_head(q, k, v)  # noqa: E731
        plain = lambda: A.causal_mha_small_head_reference(q, k, v)  # noqa: E731
    else:
        block = flash_block_size(l)
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
    out["ms"] = time_ms(kernel, reps=5, inner=3)
    out["device_ms"] = device_ms(kernel, "causal_attention_kernel", calls=5)
    out["plain_ms"] = time_ms(plain, reps=3, inner=2, warm=1)
    out["library_ms"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=5, inner=3)
    # the causal half: q·kᵀ and p·v over L²/2 entries
    t_ops = 4.0 * b * h * l * l * d / 2 / BF16_OPS_PER_S * 1e3
    t_bytes = 4.0 * b * h * l * d * 2 / HBM_BYTES_PER_S * 1e3
    out["bound_ms"] = max(t_ops, t_bytes)
    out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"{name:<22s} B={b:<3d} H={h} L={l:<5d} D={d:<4d} max_abs_err={err:.3e} "
        f"(tol {ATT_TOL}) ms={out['ms']:.4f} device_ms={fmt(out['device_ms'])} "
        f"plain_ms={out['plain_ms']:.4f} sdpa_ms={out['library_ms']:.4f} "
        f"bound_ms={out['bound_ms']:.4f}")
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
#: reference's other head width
K4_BWD_SHAPES = ((64, 8, 512, 64), (3, 8, 128, 128))
K5_BWD_SHAPES = ((64, 8, 1024, 64, 512), (2, 8, 256, 128, 256))


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
                        plain, "attention_bwd_", 7 * bhld * 2 + 2 * bhl * 4, 5 * bhl2d)}
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
                "attention_bwd_dkv_kernel", 6 * bhld * 2 + stats, 4 * bhl2d),
            "flash_causal_attention_bwd_dq": (
                lambda: A.flash_causal_attention_bwd_dq(*args),
                lambda: A.flash_causal_attention_bwd_dq_reference(*args),
                "attention_bwd_dq_kernel", 5 * bhld * 2 + stats, 3 * bhl2d)}
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
    for part, (fn, part_plain, kname, n_bytes, n_ops) in parts.items():
        rec = {"ms": time_ms(fn, reps=5, inner=3),
               "device_ms": device_ms(fn, kname, calls=5),
               # one kernel's part alone: no library call computes only it
               "plain_ms": (out["plain_ms"] if len(parts) == 1
                            else time_ms(part_plain, reps=3, inner=1, warm=1)),
               "library_ms": out["library_ms"] if len(parts) == 1 else None}
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, n_ops)
        out["kernels"][part] = rec
        log(f"{part:<31s} B={b:<3d} H={h} L={l:<5d} D={d:<4d} "
            + " ".join(f"{n}_err={e:.3e}({r:.1e})" for n, (e, r) in errs.items())
            + f" ms={rec['ms']:.4f} device_ms={fmt(rec['device_ms'])} "
            f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
            f"({rec['bound_by']})")
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
        f"(share {w['device_busy_share']:.4f}); top device ms: "
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


async def main_path(R, variant_path, storage, ctx, model_arrays, eval_users):
    from incubator_predictionio_tpu_torch.models.two_tower import (
        TwoTowerConfig,
        TwoTowerMF,
        TwoTowerModel,
    )

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
        cpu = TwoTowerModel(user_emb=user, item_emb=item, user_bias=user_bias,
                            item_bias=item_bias, mean=3.0,
                            config=TwoTowerConfig(rank=RANK))
        cpu.prepare_for_serving(quantize=True, host_max_elements=0,
                                device="cpu", build_index=False)
        # top-12 on the CPU: an id may cross the 10th place only through a
        # near-tie (the two sum in different orders, fp32 roundoff)
        ci, cs = TwoTowerMF.recommend_batch(
            cpu, np.asarray(eval_users[:16], np.int32), 12)
        same_order = same_set = 0
        for r, body in enumerate(b_single):
            got = ids_of(body)
            want = [f"i{i}" for i in ci[r][:10]]
            cpu_score = dict(zip([f"i{i}" for i in ci[r]], cs[r].tolist()))
            for iid in set(got) ^ set(want):
                check(iid in cpu_score
                      and abs(cpu_score[iid] - float(cs[r][9])) <= 1e-4,
                      f"top-10 differs from the CPU path for u{eval_users[r]} "
                      f"beyond a near-tie: {got} vs {want}")
            for s in body["itemScores"]:
                check(abs(s["score"] - cpu_score[s["item"]]) <= 1e-4,
                      f"score {s} vs CPU {cpu_score[s['item']]}")
            same_set += set(got) == set(want)
            same_order += got == want
        log(f"[exact] top-10 of 16 users vs the plain CPU path: same ids for "
            f"{same_set}/16, same order for {same_order}/16, scores within 1e-4")
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


def check_against_plain(model, payloads, bodies):
    """The served answers (kernel attention) against the same model's
    forward with the plain attention version, on the card: every served
    score within :data:`SEQ_SCORE_TOL` of the plain score of that item, and
    the ids equal up to near-ties at the last place (the scores are bf16
    values, so ties are common). Returns the largest score difference and
    the counts of equal id sets and orders."""
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
            s[model.item_map[iid]] = -np.inf
        num = p["num"]
        top = np.argsort(-s, kind="stable")[:num]
        want = [inv[int(t)] for t in top]
        got = ids_of(body)
        for iid in set(got) ^ set(want):
            check(abs(float(s[model.item_map[iid]]) - float(s[top[-1]]))
                  <= SEQ_SCORE_TOL,
                  f"top-{num} differs from the plain path beyond a near-tie: "
                  f"{got} vs {want}")
        for x in body["itemScores"]:
            diff = abs(x["score"] - float(s[model.item_map[x["item"]]]))
            worst = max(worst, diff)
            check(diff <= SEQ_SCORE_TOL,
                  f"score {x} vs plain {float(s[model.item_map[x['item']]])}")
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

def cycle_sessions(rng, n: int, max_len: int):
    """Sessions with something to learn: over the 9,999 items, a random
    start and a length of 5 to ``max_len + 1``, each item followed by the
    next of the cycle, ``next(i_k) = i_{k+1 mod 9999}``."""
    n_items = SEQ_VOCAB - 1
    starts = rng.integers(0, n_items, n)
    lengths = rng.integers(5, max_len + 2, n)
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
        f"{w['device_busy_ms']:.3f} ms (share {w['device_busy_share']:.4f}); top "
        "device ms: " + ", ".join(f"{k[:60]}={v:.3f}" for k, v in w["top_device_ms"].items()))
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
    for n in ("retrieval", "attention"):
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
    k4, k5 = attention_checks(A)
    k4b, k5b = attention_bwd_checks(A)

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
    del user, item, user_bias, item_bias, ivf, storage
    gc.collect()
    torch.cuda.empty_cache()
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
    launches.update(att_launches)
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the main path")

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
                "shape": {k: main_case[k] for k in main_case
                          if k in ("B", "H", "L", "N", "C", "D")}}

    def bwd_entry(name, replaces, cases, grads=("dq", "dk", "dv")):
        main_case = cases[0]  # the training shape
        e = entry(name, "attention.cu", replaces, cases,
                  {**main_case, **main_case["kernels"][name]})
        e["max_abs_err"] = max(c["errors"][g]["max_abs_err"]
                               for c in cases for g in grads)
        return e

    kernels = [
        entry("score_catalog_quantized", "retrieval.cu",
              "incubator_predictionio_tpu/ops/retrieval.py:97", k1,
              next(c for c in k1 if c["B"] == 64 and c["D"] == RANK)),
        entry("score_centroids_quantized", "retrieval.cu",
              "incubator_predictionio_tpu/ops/retrieval.py:188", k2,
              next(c for c in k2 if c["B"] == 64)),
        entry("causal_mha_small_head", "attention.cu",
              "incubator_predictionio_tpu/ops/attention.py:122", k4,
              next(c for c in k4 if c["B"] == 64)),
        bwd_entry("causal_mha_small_head_bwd",
                  "incubator_predictionio_tpu/ops/attention.py:136", k4b),
        entry("flash_causal_attention", "attention.cu",
              "incubator_predictionio_tpu/parallel/ring.py:201", k5,
              next(c for c in k5 if c["B"] == 64)),
        bwd_entry("flash_causal_attention_bwd_dkv",
                  "jax/experimental/pallas/ops/tpu/flash_attention.py:1121", k5b,
                  ("dk", "dv")),
        bwd_entry("flash_causal_attention_bwd_dq",
                  "jax/experimental/pallas/ops/tpu/flash_attention.py:1456", k5b,
                  ("dq",)),
    ]
    record = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "k1_cases": k1, "k2_cases": k2, "k4_cases": k4, "k5_cases": k5,
              "k4_bwd_cases": k4b, "k5_bwd_cases": k5b,
              "main_path": main, "kernels": kernels,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "wall_s": time.perf_counter() - t_start}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(record, indent=1, default=str))
    log(f"total wall time {record['wall_s']:.1f} s; peak device memory "
        f"since the last training phase began "
        f"{record['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
