#!/usr/bin/env python3
"""How close the supervised members' heartbeat leases come to expiring:
``chip_smoke.py``'s rec-supervised chaos run (``train --distributed`` of
the recommendation template as 2 members under a ``Supervisor`` on one
card over gloo, rec-launch's store of 400,000 rate events, the highest
rank SIGKILLed once 2 epochs are committed), repeated ``RUNS`` times.

Each member logs the longest gap between two lease renewals when it
stops. Prints, for each run, its verdict and wall, and every member's
longest gap.

Run from the repo root on a machine with an NVIDIA card::

    python3 dist_lease_probe.py [RUNS]

Writes ``chiprun_out/dist_lease_probe.json`` and the members' logs under
``chiprun_out/dist_lease_probe/``; exits 1 if any run did not end with
one recovery in generation 2."""
import datetime as dt
import json
import os
import re
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as C  # noqa: E402

RUNS = int(sys.argv[1]) if len(sys.argv) > 1 else 4
GAP = re.compile(r"dist member (\d+): lease renewed at most ([\d.]+) ms apart")
OUT = os.path.join(HERE, "chiprun_out", "dist_lease_probe")


def main() -> int:
    from incubator_predictionio_tpu_torch.distributed.supervisor import Supervisor

    os.makedirs(OUT, exist_ok=True)
    out = {"card": C.smi_name_power(), "runs": []}
    print(out["card"], flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "rec-launch")
        users, items, ratings = C.launch_arrays()
        t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
        dicts = ({"event": "rate", "entityType": "user", "entityId": f"u{u}",
                  "targetEntityType": "item", "targetEntityId": f"i{i}",
                  "properties": {"rating": float(r)},
                  "eventTime": (t0 + dt.timedelta(seconds=j)).isoformat()}
                 for j, (u, i, r) in enumerate(zip(
                     users.tolist(), items.tolist(), ratings.tolist())))
        with C.cli_storage(root):
            C.cli_app_import("probe", root, "launch", dicts)
            env = {"PYTHONPATH": HERE, "CUDA_VISIBLE_DEVICES": "0"}
            for n in range(RUNS):
                ck_dir = os.path.join(root, f"ck-{n}")
                state_dir = os.path.join(root, f"mesh-{n}")
                variant = C.write_variant(
                    os.path.join(root, f"probe-{n}.json"), C.FACTORY, "launch",
                    [{"name": "als", "params": {
                        "rank": C.LAUNCH_RANK, "numIterations": C.SUP_EPOCHS,
                        "batchSize": C.LAUNCH_BATCH, "checkpointDir": ck_dir,
                        "checkpointEvery": 1}}])
                s = time.perf_counter()
                try:
                    C.supervised_run(f"probe{n}", variant, state_dir, ck_dir,
                                     env, kill=True)
                    verdict = "ok"
                except Exception as e:  # noqa: BLE001 — recorded, run goes on
                    verdict = f"{type(e).__name__}: {str(e)[:600]}"
                    ok = False
                rec = {"run": n, "verdict": verdict,
                       "wall_s": time.perf_counter() - s, "members": []}
                logs = os.path.join(state_dir, "logs")
                for name in sorted(os.listdir(logs)):
                    text = open(os.path.join(logs, name), errors="replace").read()
                    with open(os.path.join(OUT, f"run{n}.{name}"), "w") as f:
                        f.write(text)
                    rec["members"].append({
                        "log": name,
                        "gaps_ms": [float(g) for _, g in GAP.findall(text)]})
                out["runs"].append(rec)
                print(json.dumps(rec, indent=1), flush=True)
    with open(os.path.join(HERE, "chiprun_out", "dist_lease_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
