"""chip_smoke.py's telemetry checks alone, on one card.

Builds the kernels, then runs chip_smoke.py's ``stream`` phase (its
``stream.fold`` reading under ``PIO_STREAM_FUSED=device``), ``rec-obs``
twice on the main path's instance A, ``rec-train`` (the MFU gauge),
``rec-shard`` (``shard.search``) and ``rec-workflow`` (``train
--profile-dir``). The checks are logged instead of raised; the last lines
say ``FAILS n`` and list them. The records land in
``chiprun_out/obs_probe.json``. Run from the repo root::

    python3 obs_probe.py [obs] [stream] [train] [shard] [workflow]

(no argument: all of them; ~3 min of command on an H100).
"""
import asyncio
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402

FAILS = []


def check(cond, msg):
    if not cond:
        FAILS.append(msg)
        print("CHECK-FAIL:", msg[:1500], flush=True)


cs.check = check


def main():
    from incubator_predictionio_tpu_torch import convert
    from incubator_predictionio_tpu_torch.ops import _build
    from incubator_predictionio_tpu_torch.ops import retrieval as R
    from incubator_predictionio_tpu_torch.ops import sparse_update as S
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
    from incubator_predictionio_tpu_torch.serving import ann
    from incubator_predictionio_tpu_torch.utils import jitstats

    only = set(sys.argv[1:]) or {"obs", "stream", "train", "shard", "workflow"}
    t0 = time.perf_counter()
    smi = cs.smi_name_power()
    print("card", smi, flush=True)
    _build.build_all()
    for n in ("retrieval", "sparse_update"):
        _build.library(n)
    print(f"build {time.perf_counter() - t0:.1f} s; jitstats {jitstats.top_compiles()}",
          flush=True)
    ctx = DeviceContext.create()
    out = {}
    user, item, ub, ib, eval_users = cs.towers()
    ivf = ann.build_ivf(item, ib, key=ann.build_key(cs.N_ITEMS))
    rec = convert.rec_model_from_arrays(
        user, item, ub, ib, 3.0, cs.RANK, [f"u{i}" for i in range(cs.N_USERS)],
        [f"i{i}" for i in range(cs.N_ITEMS)])
    rec.mf._ivf = ivf
    with tempfile.TemporaryDirectory() as tmp:
        storage, variant = cs.deploy_storage(cs.FACTORY, {"rank": cs.RANK}, "als",
                                             rec, tmp)
        del rec
        if "stream" in only:
            try:
                with cs.retrieval_mode("auto"):
                    _, out["stream"] = asyncio.run(cs.stream_phase(
                        R, S, variant, storage, ctx, tmp,
                        cs.CodecLog(os.path.join(tmp, "live.piolog"))))
            except Exception:
                traceback.print_exc()
                FAILS.append("stream raised")
        if "obs" in only:
            for i in range(2):
                try:
                    _, out[f"obs{i}"] = asyncio.run(cs.obs_phase(
                        R, (user, item, ub, ib), eval_users, storage, variant,
                        ctx, tmp, smi))
                except Exception:
                    traceback.print_exc()
                    FAILS.append("obs raised")
    del user, item, ub, ib, ivf
    with tempfile.TemporaryDirectory() as tmp:
        if "train" in only or "shard" in only:
            try:
                _, out["rec_train"] = cs.rec_train_phase(R, ctx, tmp)
            except Exception:
                traceback.print_exc()
                FAILS.append("rec-train raised")
        if "shard" in only and "rec_train" in out:
            try:
                _, out["rec_shard"] = cs.rec_shard_phase(
                    R, ctx, tmp, out["rec_train"]["persisted"])
            except Exception:
                traceback.print_exc()
                FAILS.append("rec-shard raised")
        if "workflow" in only:
            try:
                _, out["rec_workflow"] = cs.rec_workflow_phase(R, ctx, tmp)
            except Exception:
                traceback.print_exc()
                FAILS.append("rec-workflow raised")
    os.makedirs("chiprun_out", exist_ok=True)
    Path("chiprun_out/obs_probe.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(f"total {time.perf_counter() - t0:.1f} s")
    print("FAILS", len(FAILS))
    for f in FAILS:
        print(" -", f[:300])


if __name__ == "__main__":
    main()
