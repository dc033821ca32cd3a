#!/usr/bin/env python3
"""Sharded serving on the card, outside the whole smoke run.

Run from the repo root on a machine with NVIDIA cards and PyTorch built for
CUDA::

    python3 shard_ab.py --probe          # ~15 s of command
    python3 shard_ab.py [--full]         # ~2.5 min; prints FAILS n

1. ``--probe``: is an fp32 product of one shard's columns bitwise the same
   columns of the whole catalog's product? ``q [b, rank] @ item_t [rank,
   n]`` against ``q @ item_t[:, s·n/S : (s+1)·n/S]`` (a contiguous copy, and
   a view) at rank 32 × 150,000 items and rank 128 × 100,352, for S 2, 4,
   5, 8 and the serving buckets b 1–256, bf16-rounded random values from a
   seed: the count of differing scores a case, and the full product's time.
   This is why the exact path's product runs in float64
   (``models/two_tower.py:_catalog_product``).
2. Otherwise: ``chip_smoke.py``'s ``rec-train`` (its CPU parity checks
   skipped unless ``--full``) and then its ``rec-shard`` phase, with every
   check logged instead of raised, and ``FAILS n`` at the end. With ≥ 2
   cards ``rec-shard`` runs its multi-card pass (each card's scoring ms and
   the merge ms by CUDA events). The record lands in
   ``chiprun_out/shard_ab.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch

OUT = os.path.join("chiprun_out", "shard_ab.json")


def probe() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(torch.__version__, torch.version.cuda, torch.cuda.device_count(),
          "allow_tf32", torch.backends.cuda.matmul.allow_tf32)
    out = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for rank, n in ((32, 150_000), (128, 100_352)):
        it = torch.randn(rank, n, device="cuda", generator=g).bfloat16().float()
        for s in (2, 4, 5, 8):
            rps = -(-n // s)
            parts = [it[:, i * rps:(i + 1) * rps].contiguous() for i in range(s)]
            for b in (1, 2, 4, 8, 16, 32, 64, 128, 256):
                q = torch.randn(b, rank, device="cuda",
                                generator=g).bfloat16().float()
                full = q @ it
                copy = sum(int((q @ p != full[:, i * rps:i * rps + p.shape[1]]
                                ).sum()) for i, p in enumerate(parts))
                view = sum(int((q @ it[:, i * rps:(i + 1) * rps]
                                != full[:, i * rps:(i + 1) * rps]).sum())
                           for i in range(s))
                out[f"r{rank}_s{s}_b{b}"] = (copy, view)
        print(rank, n, {k: v for k, v in out.items() if k.startswith(f"r{rank}_")},
              flush=True)
    for rank, n in ((32, 150_000), (128, 100_352)):
        it = torch.randn(rank, n, device="cuda").bfloat16().float()
        q = torch.randn(64, rank, device="cuda").bfloat16().float()
        for _ in range(3):
            q @ it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            q @ it
        torch.cuda.synchronize()
        print("full product ms, b 64, rank", rank,
              (time.perf_counter() - t0) / 50 * 1e3)
    print(json.dumps({"mismatch": {k: v for k, v in out.items() if v != (0, 0)}}))
    return 0


def phases(full: bool) -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as C
    from incubator_predictionio_tpu_torch.ops import _build
    from incubator_predictionio_tpu_torch.ops import retrieval as R
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

    fails = []

    def check(cond, msg):
        if not cond:
            fails.append(msg)
            print("CHECK FAILED:", msg[:400], flush=True)

    C.check = check
    torch.backends.cuda.matmul.allow_tf32 = False
    print(C.smi_name_power(), torch.cuda.device_count(), flush=True)
    t0 = time.time()
    _build.library("retrieval")
    print("build", time.time() - t0, flush=True)
    if not full:
        C.rec_step_parity = lambda dev: {}
        C.rec_fit_parity = lambda dev: {}
    ctx = DeviceContext.create()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        _, rec = C.rec_train_phase(R, ctx, tmp)
        print("rec-train", time.time() - t0, flush=True)
        try:
            _, out["rec_shard"] = C.rec_shard_phase(R, ctx, tmp,
                                                    rec["persisted"])
        except Exception:  # noqa: BLE001 - logged, then counted
            traceback.print_exc()
            fails.append("exception")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"fails": fails, **out}, f, indent=1, default=str)
    print("FAILS", len(fails))
    for msg in fails:
        print(" -", msg[:300])
    return 1 if fails else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("shard_ab: CUDA is not available", file=sys.stderr)
        return 1
    if "--probe" in sys.argv:
        return probe()
    return phases("--full" in sys.argv)


if __name__ == "__main__":
    sys.exit(main())
