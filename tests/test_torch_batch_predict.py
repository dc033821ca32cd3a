"""PyTorch port, batch prediction on the CPU: ``core/workflow/batch_predict.py``
(``run_batch_predict``, ``part_path``, the per-process slices and the
stale-part barrier), the CLI ``batchpredict`` verb and ``launch -n 2
batchpredict`` over gloo — against the JAX package's ``run_batch_predict``
on the same recommendation model (its arrays crossed through
``convert.py``) and the same input file.

Tolerances: none. The output lines are the JAX package's byte for byte
(the same host numpy scoring of the same fp32 arrays, the same JSON
encoding), and the slices of P processes concatenated are the
one-process output byte for byte (the same model scores the same queries).
"""

import datetime as dt
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu.core.workflow import batch_predict as jbp  # noqa: E402
from incubator_predictionio_tpu.data import storage as jstorage  # noqa: E402
from incubator_predictionio_tpu.utils.serialization import (  # noqa: E402
    serialize_model as jserialize,
)
from incubator_predictionio_tpu_torch.core.workflow import batch_predict as tbp  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import (  # noqa: E402
    EngineInstance,
    Model,
    Storage,
)
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import launcher  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.tools import cli  # noqa: E402
from incubator_predictionio_tpu_torch.utils.serialization import (  # noqa: E402
    serialize_model,
)

from tests.test_torch_distributed_eval import Lockstep  # noqa: E402
from tests.test_torch_query_server import (  # noqa: E402
    N_ITEMS,
    N_USERS,
    RANK,
    _jax_model,
    _port_model,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = DeviceContext.create(device="cpu")
UTC = dt.timezone.utc
FACTORY = "incubator_predictionio_tpu_torch.templates.recommendation.RecommendationEngine"
JFACTORY = "incubator_predictionio_tpu.templates.recommendation.RecommendationEngine"
LAUNCH_TIMEOUT = 180.0


def _queries(n=47, seed=11):
    """Known users with several ``num``, black-lists (with an id the
    catalog lacks), unknown users with and without a black-list."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        q = {"user": f"u{int(rng.integers(0, N_USERS))}",
             "num": int(rng.integers(1, 15))}
        if j % 4 == 1:
            q["blackList"] = [f"i{int(i)}" for i in rng.integers(0, N_ITEMS, 5)] + ["nope"]
        if j % 9 == 4:
            q["user"] = f"stranger{j}"
        out.append(q)
    return out


def _write_input(path, queries):
    with open(path, "w") as f:
        for j, q in enumerate(queries):
            f.write(json.dumps(q) + "\n")
            if j % 10 == 3:
                f.write("\n")  # blank lines are skipped
    return str(path)


def _variant(path, factory):
    with open(path, "w") as f:
        json.dump({"id": "default", "version": "1", "engineFactory": factory,
                   "algorithms": [{"name": "als", "params": {"rank": RANK}}]}, f)
    return str(path)


def _persist(storage, variant_path, factory, blob, base):
    now = dt.datetime.now(UTC)
    iid = storage.get_meta_data_engine_instances().insert(base.EngineInstance(
        id="", status="COMPLETED", start_time=now, end_time=now,
        engine_id="default", engine_version="1",
        engine_variant=os.path.abspath(variant_path), engine_factory=factory))
    storage.get_model_data_models().insert(base.Model(iid, blob))


class _PortBase:
    EngineInstance, Model = EngineInstance, Model


def _port_storage(tmp_path, jm, sqlite=False):
    """The port's storage (memory, or one sqlite file the launched processes
    open) holding the converted model as a COMPLETED instance."""
    config = ({"PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
               "PIO_STORAGE_SOURCES_SQLITE_PATH": str(tmp_path / "pio.db")}
              if sqlite else {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    storage = Storage(config)
    variant = _variant(tmp_path / "engine.json", FACTORY)
    _persist(storage, variant, FACTORY, serialize_model([_port_model(jm)]), _PortBase)
    return storage, variant, config


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


@pytest.fixture()
def exact(monkeypatch):
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")


@pytest.mark.parametrize("chunk", [1024, 7])
def test_run_batch_predict_matches_jax(tmp_path, exact, chunk):
    """The same input file through both packages' ``run_batch_predict``
    (one process; chunks of 1024, and of 7 so that a file spans several
    dispatches): one answer a non-blank line, in order."""
    jm = _jax_model(seed=5)
    queries = _queries()
    inp = _write_input(tmp_path / "in.json", queries)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jvariant = _variant(jdir / "engine.json", JFACTORY)
    js = jstorage.Storage({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    _persist(js, jvariant, JFACTORY, jserialize([jm]), jstorage)
    n = jbp.run_batch_predict(jbp.BatchPredictConfig(
        engine_variant=jvariant, input_path=inp,
        output_path=str(tmp_path / "jax.out"), query_chunk=chunk), js)
    storage, variant, _ = _port_storage(tmp_path, jm)
    got_n = tbp.run_batch_predict(tbp.BatchPredictConfig(
        engine_variant=variant, input_path=inp,
        output_path=str(tmp_path / "port.out"), query_chunk=chunk), storage, CPU)
    assert got_n == n == len(queries)
    got, want = _lines(tmp_path / "port.out"), _lines(tmp_path / "jax.out")
    assert got == want
    # unknown users get the reference's empty answer; no black-listed id
    for q, line in zip(queries, got):
        ids = [s["item"] for s in json.loads(line)["itemScores"]]
        if q["user"].startswith("stranger"):
            assert ids == []
        else:
            assert len(ids) == q["num"]
            assert not set(ids) & set(q.get("blackList", ()))


def test_part_path_is_the_references():
    for pid in (0, 7, 12345):
        assert tbp.part_path("out.json", pid) == jbp.part_path("out.json", pid)
    assert tbp.part_path("a/b.json", 3) == "a/b.json.part-00003"


@pytest.mark.parametrize("procs", [2, 3])
def test_slices_concatenated_are_the_one_process_output(tmp_path, exact, procs):
    """P processes (threads in lockstep) each score the contiguous slice
    ``round(i·total/P)`` of the non-blank lines and write their part; the
    primary first removes the parts of an earlier run with more processes;
    the parts in order are the one-process output, byte for byte."""
    jm = _jax_model(seed=6)
    queries = _queries(n=50, seed=3)
    inp = _write_input(tmp_path / "in.json", queries)
    storage, variant, _ = _port_storage(tmp_path, jm)
    one = str(tmp_path / "one.out")
    tbp.run_batch_predict(tbp.BatchPredictConfig(
        engine_variant=variant, input_path=inp, output_path=one,
        query_chunk=8), storage, CPU)
    out = str(tmp_path / "many.out")
    stale = [tbp.part_path(out, pid) for pid in range(procs + 2)]
    for path in stale:
        with open(path, "w") as f:
            f.write("stale\n")
    counts = Lockstep(procs).run(lambda ctx: tbp.run_batch_predict(
        tbp.BatchPredictConfig(engine_variant=variant, input_path=inp,
                               output_path=out, query_chunk=8), storage, ctx))
    bounds = [round(i * len(queries) / procs) for i in range(procs + 1)]
    assert counts == [bounds[i + 1] - bounds[i] for i in range(procs)]
    for path in stale[procs:]:
        assert not os.path.exists(path)  # removed before any write
    parts = []
    for pid in range(procs):
        parts += _lines(tbp.part_path(out, pid))
    assert parts == _lines(one)
    assert not os.path.exists(out)


def test_a_failed_cleanup_raises_on_every_process(tmp_path, exact):
    """A stale part the primary cannot remove (a directory) fails every
    process after the barrier — none waits for a peer that raised."""
    storage, variant, _ = _port_storage(tmp_path, _jax_model(seed=6))
    inp = _write_input(tmp_path / "in.json", _queries(n=6))
    out = str(tmp_path / "o.out")
    os.makedirs(tbp.part_path(out, 9))
    errors = []

    def run(ctx):
        try:
            tbp.run_batch_predict(tbp.BatchPredictConfig(
                engine_variant=variant, input_path=inp, output_path=out),
                storage, ctx)
        except RuntimeError as e:
            errors.append((ctx.process_index, str(e)))

    Lockstep(2).run(run)
    assert sorted(p for p, _ in errors) == [0, 1]
    assert all("stale part cleanup failed on the primary" in m for _, m in errors)
    assert not os.path.exists(tbp.part_path(out, 0))


def test_cli_batchpredict(tmp_path, exact, capsys):
    """The verb in-process on the process storage, ``--device cpu``."""
    jm = _jax_model(seed=7)
    queries = _queries(n=20)
    inp = _write_input(tmp_path / "in.json", queries)
    storage, variant, _ = _port_storage(tmp_path, jm)
    out = str(tmp_path / "cli.out")
    prev = treg.use_storage(storage)
    try:
        assert cli.main(["batchpredict", "--input", inp, "--output", out,
                         "-v", variant, "--device", "cpu",
                         "--query-partitions", "6"]) == 0
    finally:
        treg.use_storage(prev)
    assert f"Batch predict completed: 20 predictions written to {out}" in \
        capsys.readouterr().out
    ref = str(tmp_path / "ref.out")
    tbp.run_batch_predict(tbp.BatchPredictConfig(
        engine_variant=variant, input_path=inp, output_path=ref), storage, CPU)
    assert _lines(out) == _lines(ref)


def test_cli_launch_two_process_batchpredict(tmp_path, exact):
    """``launch -n 2 batchpredict`` over gloo on the CPU: two part files
    whose concatenation is the one-process output."""
    jm = _jax_model(seed=8)
    queries = _queries(n=31, seed=5)
    inp = _write_input(tmp_path / "in.json", queries)
    storage, variant, config = _port_storage(tmp_path, jm, sqlite=True)
    one = str(tmp_path / "one.out")
    tbp.run_batch_predict(tbp.BatchPredictConfig(
        engine_variant=variant, input_path=inp, output_path=one), storage, CPU)
    storage.close()
    env = dict(os.environ)
    env.update(config)
    env.update({"PYTHONPATH": REPO, "PIO_FS_BASEDIR": str(tmp_path / "fs")})
    out = str(tmp_path / "launched.out")
    res = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
         "launch", "-n", "2", "--cpu-devices-per-process", "1",
         "--coordinator-port", str(launcher.free_port()),
         "--timeout", str(LAUNCH_TIMEOUT), "batchpredict", "--input", inp,
         "--output", out, "-v", variant],
        capture_output=True, text=True, env=env, timeout=LAUNCH_TIMEOUT + 30)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "backend gloo, device cpu" in res.stdout
    for pid, n in ((0, 16), (1, 15)):
        assert (f"Batch predict completed: {n} predictions written to "
                f"{tbp.part_path(out, pid)} (slice {pid + 1}/2)") in res.stdout
    parts = _lines(tbp.part_path(out, 0)) + _lines(tbp.part_path(out, 1))
    assert parts == _lines(one)
