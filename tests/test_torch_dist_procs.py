"""PyTorch port, fault-tolerant multi-process training with real processes
on the CPU (gloo):

- one supervised 2-member two-tower fit (``distributed/supervisor.py``)
  whose rank 1 SIGKILLs itself at the epoch-3 chunk boundary of
  generation 1, so the kill does not depend on timing: the supervisor
  recovers once, generation 2 resumes from a committed epoch, and the
  committed leaves of the last epoch are **bitwise** those of an
  uninterrupted supervised control run (the same code on the same rows);
  a zombie of generation 1 is fenced; ``dist status`` reads the mesh;
- an uninterrupted ``launch -n 2 train`` with ``checkpointDir`` of the
  recommendation and the sequential template, through the plain
  multi-process checkpoint path (``utils/checkpoint.py``: the primary
  writes ``step-<n>.pt``, every process waits).

The reference's twin is tests/test_chaos_procs.py:2226 (the CLI under
the supervisor, ``slow``). Every subprocess has its own deadline.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu_torch.data import event as tevent  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.distributed.checkpoint import (  # noqa: E402
    DistSliceCheckpointer,
)
from incubator_predictionio_tpu_torch.distributed.errors import (  # noqa: E402
    FencedGenerationError,
)
from incubator_predictionio_tpu_torch.distributed.meshdir import MeshDirectory  # noqa: E402
from incubator_predictionio_tpu_torch.distributed.supervisor import Supervisor  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import launcher  # noqa: E402
from incubator_predictionio_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

from tests.test_torch_evaluation import APPS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: each supervised run's and each launch's own deadline
RUN_TIMEOUT = 120.0
EPOCHS = 6

#: one member of the supervised job: the port's data-parallel fit under
#: maybe_wrap_distributed, every process holding every triple; rank 1 of
#: generation 1 kills itself at the epoch-3 chunk boundary when asked to
MEMBER = """
import logging, os, signal, sys
import numpy as np
from incubator_predictionio_tpu_torch.distributed.context import (
    DistContext, maybe_wrap_distributed)
from incubator_predictionio_tpu_torch.models import two_tower as ttt
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

ckpt_dir, kill = sys.argv[1], sys.argv[2] == "kill"
on_chunk = DistContext.on_chunk


def dying_on_chunk(self, epoch):
    if kill and self.generation == 1 and self.process_index == 1 and epoch == 3:
        os.kill(os.getpid(), signal.SIGKILL)
    on_chunk(self, epoch)


DistContext.on_chunk = dying_on_chunk
logging.basicConfig(level=logging.INFO)
ctx = maybe_wrap_distributed(DeviceContext.create("cpu", distributed=True))
rng = np.random.default_rng(17)
n = 1200
users = rng.integers(0, 90, n).astype(np.int32)
items = rng.integers(0, 70, n).astype(np.int32)
ratings = (1 + 4 * rng.random(n)).astype(np.float32)
cfg = ttt.TwoTowerConfig(rank=8, batch_size=256, epochs=%d, seed=3,
                         checkpoint_dir=ckpt_dir, checkpoint_every=1,
                         gather="host")
try:
    ttt.TwoTowerMF(cfg).fit(ctx, users, items, ratings, 90, 70)
finally:
    ctx.stop()
""" % EPOCHS


def _supervise(tmp_path, tag, kill):
    script = tmp_path / "member.py"
    script.write_text(MEMBER)
    ckpt_dir = str(tmp_path / f"ck-{tag}")
    sup = Supervisor(
        [], 2, str(tmp_path / f"mesh-{tag}"), heartbeat_ms=5000,
        max_recoveries=2, env={"PYTHONPATH": REPO}, timeout=RUN_TIMEOUT,
        command=[sys.executable, str(script), ckpt_dir,
                 "kill" if kill else "run"])
    return sup.run(), ckpt_dir


def test_supervised_fit_recovers_from_a_killed_member_bitwise(tmp_path, capsys):
    control, ck_a = _supervise(tmp_path, "control", kill=False)
    assert control.ok, control.logs_text()[-4000:]
    assert control.recoveries == 0 and control.generation == 1
    steps = ckpt.committed_steps(ck_a)
    assert steps[-1] == EPOCHS, steps
    manifests = [ckpt.read_member_slice(ck_a, EPOCHS, m)[0] for m in (0, 1)]
    assert len(manifests[0]["entries"]) == 8 and manifests[1]["entries"] == []

    chaos, ck_b = _supervise(tmp_path, "chaos", kill=True)
    assert chaos.ok, chaos.logs_text()[-4000:]
    assert chaos.recoveries == 1 and chaos.generation == 2, chaos
    assert len(chaos.mttr_s) == 1 and 0.0 <= chaos.mttr_s[0] < 60.0
    logs = chaos.logs_text()
    resumed = [int(e) for e in re.findall(r"resuming from epoch (\d+)", logs)]
    assert len(resumed) == 2 and resumed[0] == resumed[1] >= 2, logs[-4000:]
    assert ckpt.committed_steps(ck_b)[-1] == EPOCHS
    want = ckpt.assemble_committed_step(ck_a, EPOCHS)
    got = ckpt.assemble_committed_step(ck_b, EPOCHS)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()

    md = MeshDirectory(str(tmp_path / "mesh-chaos"))
    assert md.read_generation() == (2, 2)
    assert md.last_commit()["step"] == EPOCHS
    assert md.last_commit()["generation"] == 2
    zombie = DistSliceCheckpointer(
        ck_b, members=2, member=0, generation=1, meshdir=md,
        slice_fn=lambda i, leaf, m, n: [(leaf, None)])
    with pytest.raises(FencedGenerationError):
        zombie.save(EPOCHS + 1, {"w": torch.zeros(2)})
    assert ckpt.committed_steps(ck_b)[-1] == EPOCHS

    from incubator_predictionio_tpu_torch.tools import cli

    capsys.readouterr()
    rc = cli.main(["dist", "status", "--state-dir", md.state_dir, "--json"])
    snap = json.loads(capsys.readouterr().out)
    # finished members drop their leases: no member is alive any more
    assert (snap["generation"], snap["expectedMembers"], snap["aliveMembers"],
            snap["members"], snap["degraded"], rc) == (2, 2, 0, [], True, 1)
    assert snap["lastCommit"]["step"] == EPOCHS


# -- launch -n 2 train with checkpointDir: the plain multi-process path ------

def _store(tmp_path, app, dicts):
    path = str(tmp_path / "pio.db")
    config = {"PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
              "PIO_STORAGE_SOURCES_SQLITE_PATH": path}
    storage = treg.Storage(config)
    app_id = storage.get_meta_data_apps().insert(tbase.App(0, app))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(
        [tevent.Event.from_json_dict(d) for d in dicts], app_id)
    storage.close()
    env = dict(os.environ)
    env.update(config)
    env.update({"PIO_FS_BASEDIR": str(tmp_path / "fs"), "PYTHONPATH": REPO})
    return env, config


TEMPLATES = {
    "rec": ("recommendation.RecommendationEngine", {}, "als",
            {"rank": 8, "numIterations": 4, "batchSize": 64}),
    "seq": ("sequential.SequentialEngine", {"maxLen": 8}, "transformer",
            {"maxLen": 8, "dModel": 16, "nHeads": 2, "nLayers": 1,
             "batchSize": 16, "epochs": 4}),
}


@pytest.mark.parametrize("template", sorted(TEMPLATES))
def test_launch_two_process_train_with_checkpoints(tmp_path, template):
    """Both fits checkpoint a 2-process ``launch`` through the plain path:
    the primary's ``step-<n>.pt`` files (the newest three of 4 epochs),
    one COMPLETED instance; a second launch on the same directory finds
    the completed run's state stale and trains again from scratch."""
    env, config = _store(tmp_path, template, APPS[template]())
    factory, ds_params, algo, params = TEMPLATES[template]
    ck_dir = tmp_path / "ck"
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": f"ckpt-{template}", "version": "1",
        "engineFactory": f"incubator_predictionio_tpu_torch.templates.{factory}",
        "datasource": {"params": {"appName": template, **ds_params}},
        "algorithms": [{"name": algo, "params": {
            **params, "checkpointDir": str(ck_dir), "checkpointEvery": 1}}]}))
    for run in range(2):
        out = subprocess.run(
            [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
             "launch", "-n", "2", "--cpu-devices-per-process", "1",
             "--coordinator-port", str(launcher.free_port()),
             "--timeout", str(RUN_TIMEOUT), "train", "-v", str(variant)],
            capture_output=True, text=True, env=env,
            timeout=RUN_TIMEOUT + 30)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "replica digest" in out.stdout
        assert "resuming from epoch" not in out.stdout
        assert ("stale completed-run state" in out.stdout) == (run == 1)
        assert sorted(os.listdir(ck_dir)) == ["step-2.pt", "step-3.pt",
                                              "step-4.pt"]
    storage = treg.Storage(config)
    try:
        insts = storage.get_meta_data_engine_instances().get_all()
        assert [i.status for i in insts] == ["COMPLETED"] * 2
    finally:
        storage.close()
