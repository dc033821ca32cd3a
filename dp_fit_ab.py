#!/usr/bin/env python3
"""The two-tower data-parallel fit of two trees held against each other:
``launch -n 2 train`` of the recommendation template on the store
``chip_smoke.py``'s rec-launch phase builds (400,000 rate events, 100,000
users x 100,000 items, rank 128, global batch 65,536, 4 epochs), two
processes sharing one card over gloo, in the order other, this, this,
other; each launch's processes' train seconds, exchange ms a step, loss
and replica digest (equal digests: the same tables, bitwise).

Run from the repo root on a machine with an NVIDIA card, after unpacking
the other tree (a commit) into ``build/parent``::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 dp_fit_ab.py

Writes ``chiprun_out/dp_fit_ab.json``; exits 1 if a launch failed."""
import datetime as dt
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as C  # noqa: E402

LINE = re.compile(r"data-parallel fit: process (\d+) of \d+ .*?train ([\d.]+) s, "
                  r"exchange ([\d.]+) ms a step; loss (\S+); replica digest (\w+)")
trees = {"other": os.path.join(HERE, "build", "parent"), "this": HERE}
out = {"card": C.smi_name_power(), "runs": []}
print(out["card"], flush=True)
with tempfile.TemporaryDirectory() as tmp:
    root = os.path.join(tmp, "rec-launch")
    users, items, ratings = C.launch_arrays()
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    dicts = ({"event": "rate", "entityType": "user", "entityId": f"u{u}",
              "targetEntityType": "item", "targetEntityId": f"i{i}",
              "properties": {"rating": float(r)},
              "eventTime": (t0 + dt.timedelta(seconds=j)).isoformat()}
             for j, (u, i, r) in enumerate(zip(users.tolist(), items.tolist(),
                                               ratings.tolist())))
    with C.cli_storage(root) as registry:
        C.cli_app_import("ab", root, "launch", dicts)
        variant = C.write_variant(
            os.path.join(root, "engine.json"), C.FACTORY, "launch",
            [{"name": "als", "params": {
                "rank": C.LAUNCH_RANK, "numIterations": C.LAUNCH_EPOCHS,
                "batchSize": C.LAUNCH_BATCH}}])
        for name in ("other", "this", "this", "other"):
            tree = trees[name]
            s = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
                 "launch", "-n", "2", "--timeout", "600", "train", "-v", variant],
                cwd=tree, env={**os.environ, "PYTHONPATH": tree,
                               "CUDA_VISIBLE_DEVICES": "0"},
                capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - s
            procs = [{"process": int(m[0]), "train_s": float(m[1]),
                      "exchange_ms": float(m[2]), "loss": m[3], "digest": m[4]}
                     for m in LINE.findall(r.stdout + r.stderr)]
            rec = {"tree": name, "rc": r.returncode, "wall_s": wall, "procs": procs}
            out["runs"].append(rec)
            print(json.dumps(rec), flush=True)
            if r.returncode or len(procs) != 2:
                print((r.stdout + r.stderr)[-4000:], flush=True)
os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
with open(os.path.join(HERE, "chiprun_out", "dp_fit_ab.json"), "w") as f:
    json.dump(out, f, indent=1)
digests = {p["digest"] for run in out["runs"] for p in run["procs"]}
print("digests", digests)
sys.exit(0 if all(run["rc"] == 0 and len(run["procs"]) == 2 for run in out["runs"]) else 1)
