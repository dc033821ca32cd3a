#!/usr/bin/env python3
"""Two builds of kernels K2 and K3 on one card, timed in alternating turns.

Run from the repo root on a machine with an NVIDIA card, the CUDA toolkit
and PyTorch built for CUDA::

    mkdir -p build/old && git archive <commit> incubator_predictionio_tpu_torch/csrc \\
        | tar -x -C build/old --strip-components=2
    python3 kernel_ab.py --old build/old

``--old`` names a directory holding an older copy of the port's
``csrc/retrieval.cu`` and ``csrc/sparse_update.cu`` (and the headers they
include). Both copies build with the flags of ``ops/_build.py`` plus
``-Xptxas -v`` (each kernel's registers, shared memory and spills are
printed); the checkout's own build is the one its wrappers load. At the
main path's shapes (K2: a probe bucket of 64 queries against 1024
centroids of 32 dims; K3: a fold micro-batch of 512 rows of 33) and beside
them (K2 at buckets 8 and 256; K3 at 37 x 17 and 4096 x 33) it checks both
builds against the plain PyTorch versions, bit for bit, then reads each
build's device time from ``torch.profiler`` in the order old, new, new,
old (each turn a profiled run of 20 launches). Around the kernels it times
the old design's host code against the new one on the same inputs, with
the old build's kernel inside the old design:

- the device engine of the streaming fold: pageable copies each way and
  a pass over the rows a distinct step count for the bias corrections
  (old) against one pinned buffer each way and one gather
  (``fused_adam_rows_device``), and the host fused pass of each, on the
  host's clock, the calls interleaved;
- the table-resident form (K3b): gathers, a stack, K3, three clones and
  three ``index_copy_`` (old) against three copies and one indexed K3
  launch (``fused_gather_adam_scatter``): device time of everything a call
  runs, the number of device activities a call, and CUDA-event time;
- the coarse probe: two pageable copies up and a strided copy down (old)
  against one pinned copy up and one contiguous copy down
  (``IVFIndex._probe_cuda``), on the host's clock, the calls interleaved.

It also reads the card's launch floor: the device time of a ``fill_`` of a
one-element tensor. It prints the card's name and power limit and one JSON
record, and writes the record to ``chiprun_out/kernel_ab.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "kernel_ab.json"
AB_DIR = ROOT / "build" / "ab"
SOURCES = ("retrieval", "sparse_update")
K2_SHAPES = ((64, 1024, 32), (8, 1024, 32), (128, 1024, 32), (256, 1024, 32))
K3_SHAPES = ((512, 33), (37, 17), (4096, 33))
LR = cs.STREAM_LR


def start_nvcc(src: Path, out: Path, shared: bool):
    from incubator_predictionio_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS if shared or f not in ("-shared",)]
    cmd = [_build.nvcc(), *flags, "-Xptxas", "-v", "-I", str(src.parent),
           *([] if shared else ["-c"]), "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def ptxas_lines(log: str, symbols) -> list[str]:
    """The ``-Xptxas -v`` lines of the kernels whose mangled names hold one
    of ``symbols``: the function line and the register line after it."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(s in line for s in symbols):
            out += [line.strip()] + [x.strip() for x in lines[i + 1:i + 3]
                                     if "registers" in x or "spill" in x]
    return out


def load_old(path: Path, sig_source: str) -> ctypes.CDLL:
    from incubator_predictionio_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in _build.SIGNATURES[sig_source].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def stream_of(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def profile_counts(fn, calls: int = 10):
    """Device ms a call of everything ``fn`` runs, and device activities
    (kernels and copies) a call, from one profiled run."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if ev:
            break
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3 / calls
    names: dict[str, int] = {}
    for e in ev:
        names[e.name[:48]] = names.get(e.name[:48], 0) + 1
    return busy, len(ev) / calls, {n: c / calls for n, c in names.items()}


def host_interleaved(fns: dict, reps: int = 400, warm: int = 20) -> dict:
    """Host-clock ms a call of each of ``fns``, the calls interleaved (one
    of each in turn, the order reversed every other round, so that drift of
    the shared host falls on all alike): for each, the median over the
    first half of the rounds and over the second."""
    for _ in range(warm):
        for fn in fns.values():
            fn()
    times = {k: [] for k in fns}
    keys = list(fns)
    for i in range(reps):
        for k in (keys if i % 2 == 0 else keys[::-1]):
            t0 = time.perf_counter()
            fns[k]()
            times[k].append((time.perf_counter() - t0) * 1e3)
    h = reps // 2
    return {k: [float(np.median(v[:h])), float(np.median(v[h:]))]
            for k, v in times.items()}


def turns(fns: dict, measure, order=("old", "new", "new", "old")) -> dict:
    """``measure(fns[k])`` in the given order; each version's readings."""
    out = {k: [] for k in fns}
    for k in order:
        out[k].append(measure(fns[k]))
    return out


def k2_ab(old, R, dev) -> list[dict]:
    rng = np.random.default_rng(21)
    res = []
    for b, c, d in K2_SHAPES:
        q_q, q_s = R.quantize_rows(rng.normal(size=(b, d)).astype(np.float32))
        cq, cscale = R.quantize_rows(rng.normal(size=(c, d)).astype(np.float32))
        cb = rng.normal(size=c).astype(np.float32)
        T = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (q_q, q_s, cq, cscale, cb)]
        want = R.score_centroids_reference(*T)
        out_old = torch.empty((b, c), device=dev)

        def run_old():
            err = old.pio_score_centroids(
                *(t.data_ptr() for t in T), out_old.data_ptr(), b, c, d,
                stream_of(dev))
            cs.check(err == 0, f"old K2 launch error {err}")
            return out_old

        def run_new():
            return R.score_centroids_quantized(*T)

        bitwise = {}
        for k, fn in (("old", run_old), ("new", run_new)):
            got = fn()
            torch.cuda.synchronize()
            bitwise[k] = got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()
            cs.check(bitwise[k], f"{k} K2 B={b}: not bitwise its plain version")
        ms = turns({"old": run_old, "new": run_new},
                   lambda fn: cs.device_ms(fn, "score_centroids_kernel", calls=20))
        rec = {"B": b, "C": c, "D": d, "bitwise": bitwise, "device_ms": ms}
        cs.log(f"K2 B={b} C={c} D={d}: device ms old {ms['old']} new {ms['new']}")
        res.append(rec)
    return res


def k3_ab(old, S, dev) -> list[dict]:
    res = []
    for i, (r, d) in enumerate(K3_SHAPES):
        rows, m, v, g, t = cs.adam_problem(r, d, 900 + i)
        bc1, bc2 = S.adam_bias_corrections(t)
        stack = torch.from_numpy(np.stack([rows, m, v, g])).to(dev)
        bc = torch.from_numpy(np.stack([bc1, bc2])).to(dev)
        host = np.stack(S.fused_adam_rows(rows, m, v, g, t, LR))
        out_old = torch.empty((3, r, d), device=dev)
        scal = (float(LR), S.ADAM_B1, 1.0 - S.ADAM_B1, S.ADAM_B2,
                1.0 - S.ADAM_B2, S.ADAM_EPS)

        def run_old():
            err = old.pio_adam_rows(stack.data_ptr(), bc.data_ptr(),
                                    out_old.data_ptr(), r, d, *scal,
                                    stream_of(dev))
            cs.check(err == 0, f"old K3 launch error {err}")
            return out_old

        def run_new():
            return S.adam_rows(stack, bc, LR)

        bitwise = {}
        for k, fn in (("old", run_old), ("new", run_new)):
            got = fn().cpu().numpy()
            bitwise[k] = got.tobytes() == host.tobytes()
            cs.check(bitwise[k], f"{k} K3 R={r} D={d}: not bitwise the host pass")
        ms = turns({"old": run_old, "new": run_new},
                   lambda fn: cs.device_ms(fn, "adam_rows_kernel", calls=20))
        rec = {"R": r, "D": d, "bitwise_host": bitwise, "device_ms": ms}
        if (r, d) == cs.K3_MAIN:
            rec["engine_ms"] = engine_ab(old, S, dev, rows, m, v, g, t, scal)
        cs.log(f"K3 R={r} D={d}: device ms old {ms['old']} new {ms['new']}")
        res.append(rec)
    return res


def engine_ab(old, S, dev, rows, m, v, g, t, scal) -> dict:
    """The fold's device engine, the old design (pageable copies, the old
    build's K3) against ``fused_adam_rows_device``, beside the host pass:
    host-clock ms a call, in turns."""
    r, d = rows.shape
    n = r * d

    def old_bias_corrections():
        """The old design's: one pass over the rows a distinct step count."""
        bc1, bc2 = np.empty(r, np.float32), np.empty(r, np.float32)
        for tv in np.unique(t):
            sel = t == tv
            bc1[sel] = np.float32(1.0 - S.ADAM_B1 ** int(tv))
            bc2[sel] = np.float32(1.0 - S.ADAM_B2 ** int(tv))
        return bc1, bc2

    def old_host():
        bc1, bc2 = old_bias_corrections()
        m2 = S.ADAM_B1 * m + (1.0 - S.ADAM_B1) * g
        v2 = S.ADAM_B2 * v + (1.0 - S.ADAM_B2) * (g * g)
        return (rows - LR * (m2 / bc1[:, None])
                / (np.sqrt(v2 / bc2[:, None]) + S.ADAM_EPS)), m2, v2

    def old_engine():
        bc1, bc2 = old_bias_corrections()
        buf = np.empty(4 * n + 2 * r, np.float32)
        for j, a in enumerate((rows, m, v, g)):
            buf[j * n:(j + 1) * n] = a.reshape(-1)
        buf[4 * n:4 * n + r] = bc1
        buf[4 * n + r:] = bc2
        packed = torch.from_numpy(buf).to(dev)
        out = torch.empty((3, r, d), device=dev)
        err = old.pio_adam_rows(packed.data_ptr(), packed[4 * n:].data_ptr(),
                                out.data_ptr(), r, d, *scal, stream_of(dev))
        cs.check(err == 0, f"old K3 launch error {err}")
        out = out.cpu().numpy()
        return out[0], out[1], out[2]

    def new_engine():
        return S.fused_adam_rows_device(rows, m, v, g, t, LR, device=dev)

    def host():
        return S.fused_adam_rows(rows, m, v, g, t, LR)

    want = np.stack(host())
    for k, fn in (("old", old_engine), ("new", new_engine),
                  ("old host pass", old_host)):
        cs.check(np.stack(fn()).tobytes() == want.tobytes(),
                 f"{k} is not bitwise the host pass")
    ms = host_interleaved({"old": old_engine, "new": new_engine,
                           "host_old": old_host, "host": host})
    cs.log(f"device engine R={r} D={d} (host ms a call): old {ms['old']} "
           f"new {ms['new']}; host pass old {ms['host_old']} new {ms['host']}")
    return ms


def k3b_ab(old, S, dev) -> dict:
    rng = np.random.default_rng(7)
    n, d, r = 100_000, cs.RANK + 1, 512
    tabs = [rng.normal(size=(n, d)).astype(np.float32),
            (rng.normal(size=(n, d)) * 0.01).astype(np.float32),
            np.abs(rng.normal(size=(n, d)) * 1e-4).astype(np.float32)]
    idx = np.sort(rng.choice(n, r, replace=False))
    g = rng.normal(size=(r, d)).astype(np.float32)
    bc1, bc2 = S.adam_bias_corrections(rng.integers(1, 501, r))
    T = [torch.from_numpy(a).to(dev) for a in (*tabs, idx, g, bc1, bc2)]
    scal = (float(LR), S.ADAM_B1, 1.0 - S.ADAM_B1, S.ADAM_B2,
            1.0 - S.ADAM_B2, S.ADAM_EPS)

    def run_old():
        table, m_tab, v_tab, ix, gg, b1, b2 = T
        ix = ix.to(torch.int64)
        stack = torch.stack([table[ix], m_tab[ix], v_tab[ix], gg]).contiguous()
        bc = torch.stack([b1, b2]).contiguous()
        out = torch.empty((3, r, d), device=dev)
        err = old.pio_adam_rows(stack.data_ptr(), bc.data_ptr(),
                                out.data_ptr(), r, d, *scal, stream_of(dev))
        cs.check(err == 0, f"old K3 launch error {err}")
        return (table.clone().index_copy_(0, ix, out[0]),
                m_tab.clone().index_copy_(0, ix, out[1]),
                v_tab.clone().index_copy_(0, ix, out[2]))

    def run_new():
        return S.fused_gather_adam_scatter(*T, lr=LR)

    a, b = run_old(), run_new()
    for x, y in zip(a, b):
        cs.check(torch.equal(x, y), "old and new K3b differ")
    del a, b
    prof = turns({"old": run_old, "new": run_new}, profile_counts)
    ev = turns({"old": run_old, "new": run_new}, cs.time_ms)
    rec = {"N": n, "D": d, "R": r,
           "device_ms": {k: [p[0] for p in v] for k, v in prof.items()},
           "activities_a_call": {k: v[0][1] for k, v in prof.items()},
           "activities_by_name": {k: v[0][2] for k, v in prof.items()},
           "event_ms": ev}
    cs.log(f"K3b N={n} D={d} R={r}: device ms old {rec['device_ms']['old']} "
           f"new {rec['device_ms']['new']}; activities a call "
           f"{rec['activities_a_call']}; event ms old {ev['old']} new {ev['new']}")
    return rec


def probe_ab(old, R, dev) -> dict:
    """The coarse probe around K2 at bucket 64 (50 queries): the old host
    code and build against ``IVFIndex._probe_cuda``."""
    from incubator_predictionio_tpu_torch.serving import ann

    rng = np.random.default_rng(31)
    items = rng.normal(size=(200_000, cs.RANK)).astype(np.float32)
    key = {**ann.build_key(200_000), "n_partitions": 1000}
    ivf = ann.build_ivf(items, rng.normal(size=200_000).astype(np.float32), key=key)
    ivf.device = dev
    q_q, q_s = R.quantize_rows(rng.normal(size=(50, cs.RANK)).astype(np.float32))
    b = q_q.shape[0]
    new = ivf._probe_cuda(q_q, q_s)  # uploads the centroid table once
    cq, cscale, cb = ivf._cent_device
    c = cq.shape[0]

    def run_old():
        bp = 1 << max(3, (b - 1).bit_length())
        qq = np.zeros((bp, q_q.shape[1]), np.int8)
        qq[:b] = q_q
        qs = np.zeros(bp, np.float32)
        qs[:b] = q_s
        qq_d, qs_d = torch.from_numpy(qq).to(dev), torch.from_numpy(qs).to(dev)
        out = torch.empty((bp, c), device=dev)
        err = old.pio_score_centroids(
            qq_d.data_ptr(), qs_d.data_ptr(), cq.data_ptr(), cscale.data_ptr(),
            cb.data_ptr(), out.data_ptr(), bp, c, q_q.shape[1], stream_of(dev))
        cs.check(err == 0, f"old K2 launch error {err}")
        return out[:b, :ivf.n_partitions].cpu().numpy()

    def run_new():
        return ivf._probe_cuda(q_q, q_s)

    cs.check(run_old().tobytes() == new.tobytes(), "old and new probes differ")
    ms = host_interleaved({"old": run_old, "new": run_new})
    cs.log(f"coarse probe B={b} C={c} (host ms a call): old {ms['old']} new {ms['new']}")
    return {"B": b, "C": c, "host_ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory with the older retrieval.cu and sparse_update.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available; this script runs on a card "
              "only", file=sys.stderr)
        return 1
    from incubator_predictionio_tpu_torch.ops import _build
    from incubator_predictionio_tpu_torch.ops import retrieval as R
    from incubator_predictionio_tpu_torch.ops import sparse_update as S

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.smi_name_power()
    cs.log(f"card: {smi}  torch {torch.__version__} cuda {torch.version.cuda}")
    AB_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        procs[f"old {name}"] = start_nvcc(args.old / f"{name}.cu",
                                          AB_DIR / f"lib{name}-old.so", True)
        procs[f"new {name}"] = start_nvcc(_build.CSRC / f"{name}.cu",
                                          AB_DIR / f"{name}-new.o", False)
    _build.library("sparse_update")
    _build.library("retrieval")
    ptxas = {}
    for k, p in procs.items():
        log, _ = p.communicate()
        cs.check(p.returncode == 0, f"nvcc {k} failed:\n{log}")
        ptxas[k] = ptxas_lines(log, ("score_centroids", "adam_rows"))
        for line in ptxas[k]:
            cs.log(f"ptxas {k}: {line}")
    cs.log(f"builds {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    old_r = load_old(AB_DIR / "libretrieval-old.so", "retrieval")
    old_s = load_old(AB_DIR / "libsparse_update-old.so", "sparse_update")
    record = {"card": smi, "torch": torch.__version__, "ptxas": ptxas,
              "k2": k2_ab(old_r, R, dev), "k3": k3_ab(old_s, S, dev),
              "k3b": k3b_ab(old_s, S, dev), "probe": probe_ab(old_r, R, dev),
              "launch_floor": cs.launch_floor()}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(record, indent=1, default=str))
    print(f"nvidia-smi: {smi}")
    print(json.dumps(record, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
