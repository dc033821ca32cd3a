"""PyTorch port, the telemetry that reads the card, on the CPU, against the
JAX package: ``obs/trace.py``, ``obs/profile.py``, ``utils/jitstats.py``,
``utils/tracing.py`` and the phase buckets the port's layers record.

Each module scenario runs the same script through both packages and
compares what comes out, exactly: the phase aggregates on a ``FakeClock``
(tests/test_profiler.py's conservation scenario), ``record_phases``, the
MFU of ``record_training_step`` with an injected peak, the stack sampler
over synthetic frames, ``configure_profiler_from_env``, the dispatch
accounting and its first-seen window, and ``parse_header`` over a table of
well-formed, malformed and non-ASCII values. Then what differs by design:
the H100 peak table, the fence, the device-memory report that never starts
CUDA (here, on a CPU-only process, it gives the reference's CPU answer),
``torch.profiler`` traces, the kernel build clock, and the four phase
buckets of the layers (``train.fit`` of one small fit in each package on
the same numpy data, ``stream.fold``, ``shard.search``).
"""

import glob
import json
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from incubator_predictionio_tpu.models import two_tower as jtt  # noqa: E402
from incubator_predictionio_tpu.obs import metrics as jmetrics  # noqa: E402
from incubator_predictionio_tpu.obs import profile as jprof  # noqa: E402
from incubator_predictionio_tpu.obs import trace as jtrace  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.resilience import clock as jclock  # noqa: E402
from incubator_predictionio_tpu.utils import jitstats as jjit  # noqa: E402
from incubator_predictionio_tpu_torch.models import two_tower as ttt  # noqa: E402
from incubator_predictionio_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from incubator_predictionio_tpu_torch.obs import profile as tprof  # noqa: E402
from incubator_predictionio_tpu_torch.obs import trace as ttrace  # noqa: E402
from incubator_predictionio_tpu_torch.ops import _build  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.resilience import clock as tclock  # noqa: E402
from incubator_predictionio_tpu_torch.utils import jitstats as tjit  # noqa: E402
from incubator_predictionio_tpu_torch.utils import tracing as ttracing  # noqa: E402

CPU = DeviceContext.create(device="cpu")
#: one package's telemetry modules, behind one set of names
SIDES = {
    "jax": types.SimpleNamespace(prof=jprof, trace=jtrace, jit=jjit,
                                 clock=jclock, metrics=jmetrics),
    "port": types.SimpleNamespace(prof=tprof, trace=ttrace, jit=tjit,
                                  clock=tclock, metrics=tmetrics),
}


@pytest.fixture(autouse=True)
def _fresh():
    for side in SIDES.values():
        side.prof.reset_phases()
        side.jit.reset()
        side.prof.close_profiler()
    yield
    for side in SIDES.values():
        side.prof.reset_phases()
        side.jit.reset()
        side.prof.close_profiler()


def _both(script):
    got = {name: script(side) for name, side in SIDES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# -- phase timers -------------------------------------------------------------------

def _conservation_script(side):
    """A fit-shaped scope: h2d, three compute/gather rounds, a tail the
    phases do not cover (tests/test_profiler.py's contract: the phases
    conserve the wall within 10%)."""
    clk = side.clock.FakeClock(1000.0)
    P = side.prof
    with P.step_scope("fit", clock=clk):
        with P.phase_scope("fit", "h2d", clock=clk):
            clk.advance(0.25)
        for i in range(3):
            with P.phase_scope("fit", "compute", clock=clk):
                clk.advance(1.0 + 0.125 * i)
            with P.phase_scope("fit", "gather", clock=clk):
                clk.advance(0.0625)
        clk.advance(0.05)  # unattributed
    with P.step_scope("fit", clock=clk):
        with P.phase_scope("fit", "compute", clock=clk):
            clk.advance(0.5)
    snap = P.phase_snapshot()
    e = snap["fit"]
    covered = sum(p["seconds"] for p in e["phases"].values())
    assert abs(covered - e["wall_seconds"]) <= 0.1 * e["wall_seconds"]
    return snap


def test_phase_conservation_on_a_fake_clock_is_the_references():
    snap = _both(_conservation_script)
    assert snap["fit"]["count"] == 2
    assert snap["fit"]["phases"]["compute"]["count"] == 4


def test_phase_scope_bills_an_escaping_exception():
    def script(side):
        clk = side.clock.FakeClock()
        with pytest.raises(ValueError):
            with side.prof.phase_scope("s", "compute", clock=clk):
                clk.advance(0.5)
                raise ValueError("boom")
        return side.prof.phase_snapshot()

    assert _both(script)["s"]["phases"]["compute"]["seconds"] == 0.5


def test_record_phases_is_the_references():
    def script(side):
        P = side.prof
        before = P.SCOPES_TOTAL.labels(scope="serve.batch").value
        P.record_phases("serve.batch", {"assemble": 0.001, "mask": 0.0,
                                        "dispatch": 0.004, "merge": 0.0005})
        P.record_phases("serve.batch", {"assemble": 0.002, "dispatch": 0.003,
                                        "merge": -1.0})
        P.record_phases("train.fit", {"h2d": 0.5, "compute": 2.0},
                        wall_seconds=3.0)
        return (P.phase_snapshot(),
                P.SCOPES_TOTAL.labels(scope="serve.batch").value - before)

    snap, scopes = _both(script)
    assert scopes == 2
    assert snap["serve.batch"]["phases"]["merge"]["count"] == 2
    assert snap["train.fit"]["wall_seconds"] == 3.0


def test_record_training_step_with_an_injected_peak_is_the_references():
    def script(side):
        P = side.prof
        n0 = P.STEP_SECONDS._default().snapshot()[2]
        out = [P.record_training_step(1.5e15, 2.0, peak_flops=989e12),
               P.MFU_GAUGE.value,
               P.record_training_step(1e12, 0.0, peak_flops=989e12),
               P.record_training_step(1e12, 1.0, peak_flops=0.0)]
        return out, P.STEP_SECONDS._default().snapshot()[2] - n0

    (mfu, gauge, none_zero_time, none_no_peak), observed = _both(script)
    assert mfu == pytest.approx(1.5e15 / 2.0 / 989e12) and gauge == mfu
    assert none_zero_time is None and none_no_peak is None and observed == 2


# -- the wall-stack sampler ------------------------------------------------------------

def _frames():
    """Synthetic thread frames: two threads in the same leaf, one in
    another; each a chain of (name, file, line) frames."""
    def chain(*specs):
        frame = None
        for name, path, line in reversed(specs):
            frame = types.SimpleNamespace(
                f_code=types.SimpleNamespace(co_name=name, co_filename=path),
                f_lineno=line, f_back=frame)
        return frame

    hot = [("score", "/srv/app/models/two_tower.py", 1010),
           ("predict_batch", "/srv/app/server/query_server.py", 400),
           ("run", "/usr/lib/python3.12/threading.py", 1010)]
    return {101: chain(*hot), 102: chain(*hot),
            103: chain(("fold", "/srv/app/streaming/trainer.py", 240))}


def test_stack_sampler_is_the_references():
    def script(side):
        s = side.prof.StackSampler(hz=5, topn=3, depth=2)
        for _ in range(3):
            s.sample_once(_frames())
        return s.samples, s.top(), s.top(1)

    samples, top, top1 = _both(script)
    assert samples == 3 and top[0]["samples"] == 6 and len(top1) == 1
    assert top[0]["stack"] == ["score (models/two_tower.py:1010)",
                               "predict_batch (server/query_server.py:400)"]


@pytest.mark.parametrize("hz, topn", [("", None), ("0", None), ("abc", None),
                                      ("20", "4"), ("7.5", None)])
def test_configure_profiler_from_env_is_the_references(monkeypatch, hz, topn):
    monkeypatch.setenv("PIO_PROFILE_HZ", hz)
    if topn is None:
        monkeypatch.delenv("PIO_PROFILE_TOPN", raising=False)
    else:
        monkeypatch.setenv("PIO_PROFILE_TOPN", topn)

    def script(side):
        s = side.prof.configure_profiler_from_env("svc")
        try:
            doc = side.prof.profile_payload()
            return (None if s is None else (s.hz, s.topn, s._thread.daemon),
                    side.prof.active_sampler() is s, doc["service"],
                    None if doc["sampler"] is None else doc["sampler"]["hz"])
        finally:
            side.prof.close_profiler()
            assert side.prof.active_sampler() is None

    got = _both(script)
    assert (got[0] is None) == (hz in ("", "0", "abc"))


# -- dispatch accounting ----------------------------------------------------------------

def test_jitstats_attribution_and_first_seen_window_are_the_references():
    def script(side):
        J = side.jit
        fresh = [J.record(("two_tower_topk_int8", 64, 16, 1000, 64, False),
                          now=100.0),
                 J.record(("two_tower_topk_int8", 64, 16, 1000, 64, False),
                          now=101.0),
                 J.record(("ivf_coarse_int8", 8, 256), now=150.0),
                 J.record("retrieval", now=155.0)]
        J.observe_compile(("two_tower_topk_int8", 64), 0.25)
        J.observe_compile(("two_tower_topk_int8", 128), 0.5)
        J.observe_compile("retrieval", 30.0)
        J.observe_compile(("ivf_coarse_int8", 8), -1.0)
        window = (J.recent_count(60.0, now=200.0),
                  J.recent_count(60.0, now=155.0),
                  J.recent_count(60.0, now=1000.0))
        with J.dispatch_timer(("two_tower_topk", 8, 10, 1000, 64, True)):
            pass
        with J.dispatch_timer(("two_tower_topk", 8, 10, 1000, 64, True)):
            pass
        return (fresh, J.count(), window, len(J.snapshot()),
                [(n, s, c) for n, s, c in J.top_compiles()
                 if n != "two_tower_topk"],
                [c for n, _, c in J.top_compiles() if n == "two_tower_topk"],
                J.executable_name(("x", 1)), J.executable_name(7),
                J.compile_seconds_total() >= 30.75)

    got = _both(script)
    assert got[0] == [True, False, True, True] and got[1] == 4
    assert got[2] == (2, 3, 0) and got[3] == 4
    assert got[4][0] == ("retrieval", 30.0, 1) and got[5] == [1]


def test_kernel_build_books_its_wall_under_the_library_name(tmp_path):
    """``ops/_build.py`` books each nvcc build's wall time through
    ``observe_compile`` under the library's name (a stand-in process: no
    nvcc here)."""
    class Done:
        returncode = 0

        def communicate(self):
            return "", None

    tmp, out = tmp_path / "lib.tmp", tmp_path / "lib.so"
    tmp.write_bytes(b"\0")
    import time

    _build._finish("retrieval", (Done(), tmp, out, time.perf_counter() - 2.0))
    assert out.exists()
    (name, sec, n), = tjit.top_compiles()
    assert name == "retrieval" and n == 1 and sec >= 2.0
    fam = tmetrics.REGISTRY.get("pio_jit_compile_seconds_total")
    assert fam.labels(executable="retrieval").value >= 2.0


# -- X-PIO-Trace ---------------------------------------------------------------------------

HEADERS = [None, "", "abc123", "abc123:def456", "abc123:def456:s=0",
           "abc123:def456:s=1", "abc123::s=0", " abc123:def456 ",
           "abc123:def456:s=0:future=1", "abc123:def456:s=2", ":def456",
           "abc-123:def456", "abc123:d€f456", "ünïcode:def456", "a" * 64,
           "a" * 65, "abc123:" + "b" * 65, "ABCdef0123456789",
           "١٢٣:def456", "abc123:def456:"]


def test_parse_header_is_the_references():
    def script(side):
        out = []
        for v in HEADERS:
            ctx = side.trace.parse_header(v)
            out.append(None if ctx is None
                       else (ctx.trace_id, ctx.span_id, ctx.sampled))
        return out

    got = _both(script)
    assert got[5] == ("abc123", "def456", True) and got[4][2] is False
    assert got[12] is None and got[13] is None and got[18] is None


def test_spans_nest_and_propagate_as_the_references_do():
    def script(side):
        T = side.trace
        buf = T.TraceBuffer(capacity=8)
        with T.trace_scope(T.parse_header("feedbeef:cafe0001:s=0")):
            with T.span("outer", service="q", buffer=buf) as outer:
                hv = T.header_value()
                headers = {}
                T.inject(headers)
                with pytest.raises(KeyError):
                    with T.span("inner", buffer=buf):
                        raise KeyError("x")
        spans = buf.spans()
        traces = buf.traces(limit=5)
        return (outer.parent_id, hv.split(":")[0], hv.endswith(":s=0"),
                headers[T.TRACE_HEADER] == hv,
                [(s["name"], s["status"], s["sampled"]) for s in spans],
                traces[0]["complete"], buf.traces(limit=0),
                T.keep_reason(False, "ok", 1.0, 0.5),
                T.keep_reason(False, "error:X", 0.0, None),
                T.keep_reason(True, "http401", 0.0, None),
                T.keep_reason(False, "ok", 0.0, None))

    got = _both(script)
    assert got[0] == "cafe0001" and got[1] == "feedbeef"
    assert got[4] == [("inner", "error:KeyError", False),
                      ("outer", "ok", False)]
    assert got[5] is False  # the remote parent is not in this ring


def test_exemplars_carry_the_active_trace():
    h = tmetrics.MetricsRegistry().histogram("pio_x_seconds", "x")
    with ttrace.span("req", buffer=ttrace.TraceBuffer()) as sp:
        h.observe_exemplar(0.003)
    ex = h._default().exemplars()
    assert [v[1] for v in ex.values()] == [sp.trace_id]


# -- what the card changes -----------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda as an initialized process would see it, without a card:
    ``cards`` devices of which those in ``with_context`` hold a context."""
    state = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3", cards=2,
                                  with_context={1}, queried=[])
    tprof._peak_cache.clear()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: state.cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: state.name)
    monkeypatch.setattr(torch._C, "_cuda_hasPrimaryContext",
                        lambda d: d in state.with_context, raising=False)

    def mem(kind):
        def read(d):
            state.queried.append((kind, d))
            return {"alloc": 3 << 30, "peak": 5 << 30}[kind]
        return read

    monkeypatch.setattr(torch.cuda, "memory_allocated", mem("alloc"))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", mem("peak"))

    def mem_get_info(d):
        state.queried.append(("info", d))
        return 1 << 30, 80 << 30

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    yield state
    tprof._peak_cache.clear()


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA A100-SXM4-80GB", None), ("NVIDIA H200", None)])
def test_the_peak_is_keyed_on_the_cards_name(fake_card, name, peak):
    fake_card.name = name
    assert tprof.detected_peak_flops() == peak
    mfu = tprof.record_training_step(peak or 1e12, 2.0)
    assert mfu == (0.5 if peak else None)


def test_the_memory_report_reads_only_cards_with_a_context(fake_card):
    rows = ttracing.device_memory_report()
    assert rows == [{"device": "cuda:1", "platform": "gpu",
                     "bytes_in_use": 3 << 30, "bytes_limit": 80 << 30,
                     "peak_bytes_in_use": 5 << 30}]
    assert {d for _, d in fake_card.queried} == {1}
    tmetrics.REGISTRY.expose()  # the watermark collector
    assert tprof.DEVICE_PEAK.labels(device="cuda:1").value >= 5 << 30
    assert {d for _, d in fake_card.queried} == {1}
    assert "cuda:1" in tprof.profile_payload()["deviceWatermark"]


def test_a_cpu_process_never_starts_cuda():
    """The reference's CPU answer, and a scrape, a profile document, a
    fence and the peak leave ``torch.cuda.is_initialized()`` False."""
    assert not torch.cuda.is_initialized()
    want = jax.devices("cpu")[0]
    (row,) = ttracing.device_memory_report()
    ref = [r for r in __import__(
        "incubator_predictionio_tpu.utils.tracing",
        fromlist=["device_memory_report"]).device_memory_report()
        if r["platform"] == want.platform]
    assert ref and all(sorted(r) == sorted(row) for r in ref)
    assert row["platform"] == "cpu"
    assert all(row[k] is None and r[k] is None for r in ref
               for k in ("bytes_in_use", "bytes_limit", "peak_bytes_in_use"))
    text = tmetrics.REGISTRY.expose()
    tmetrics.parse_prometheus_text(text)
    doc = tprof.profile_payload()
    tprof.fence(torch.ones(3), [torch.zeros(2), None], np.ones(2), 7)
    assert tprof.detected_peak_flops() is None
    assert tprof.record_training_step(1e12, 1.0) is None
    assert doc["training"]["peak_flops"] is None
    assert not torch.cuda.is_initialized()


def test_fence_waits_on_each_fenced_devices_own_stream(monkeypatch):
    """One synchronize a device, of that device's current stream, for
    tensors nested in lists and tuples; host values pass; never
    ``torch.cuda.synchronize``."""
    synced = []

    class Stream:
        def __init__(self, dev):
            self.dev = dev

        def synchronize(self):
            synced.append(self.dev)

    class FakeCuda(torch.Tensor):
        pass

    def cuda_like(index):
        t = torch.zeros(1).as_subclass(FakeCuda)
        t._dev = torch.device("cuda", index)
        return t

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream(d))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("a device-wide synchronize"))
    monkeypatch.setattr(FakeCuda, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(FakeCuda, "device", property(lambda self: self._dev))
    tprof.fence([cuda_like(0), (cuda_like(2), None)], cuda_like(0),
                torch.ones(1), "host")
    assert sorted(d.index for d in synced) == [0, 2]


def test_profile_trace_on_the_cpu_writes_a_trace(tmp_path):
    with ttracing.profile_trace(str(tmp_path)):
        with ttracing.annotate("serve.batch"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with ttracing.step_annotation("train_epochs", 3):
            torch.ones(8).sum()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"serve.batch", "train_epochs#3"} <= names
    assert not torch.cuda.is_initialized()


# -- the layers' phase buckets ---------------------------------------------------------------

N_USERS, N_ITEMS, RANK = 120, 80, 8


def _triples(seed=5, n=1500):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_USERS, n).astype(np.int32),
            rng.integers(0, N_ITEMS, n).astype(np.int32),
            (1.0 + 4.0 * rng.random(n)).astype(np.float32))


def test_train_fit_phases_and_flops_are_the_references(monkeypatch):
    """One small fit in each package on the same numpy data: the same
    ``train.fit`` phase names and the same analytic flops handed to
    ``record_training_step``."""
    handed = {}
    for name, side in SIDES.items():
        real = side.prof.record_training_step

        def spy(flops, seconds, peak_flops=None, name=name, real=real):
            handed[name] = flops
            return real(flops, seconds, peak_flops)

        monkeypatch.setattr(side.prof, "record_training_step", spy)
    users, items, ratings = _triples()
    cfg = dict(rank=RANK, epochs=2, batch_size=512, seed=3, gather="host")
    jtt.TwoTowerMF(jtt.TwoTowerConfig(**cfg)).fit(
        MeshContext.create(devices=jax.devices()[:1]), users, items, ratings,
        N_USERS, N_ITEMS)
    ttt.TwoTowerMF(ttt.TwoTowerConfig(**cfg)).fit(
        CPU, users, items, ratings, N_USERS, N_ITEMS)
    assert handed["port"] == handed["jax"] > 0
    snaps = {name: side.prof.phase_snapshot()["train.fit"]
             for name, side in SIDES.items()}
    assert sorted(snaps["port"]["phases"]) == sorted(snaps["jax"]["phases"]) \
        == ["compute", "gather", "h2d", "init"]
    assert snaps["port"]["count"] == snaps["jax"]["count"] == 1


def test_a_fit_under_profile_trace_names_each_epoch_chunk(tmp_path):
    users, items, ratings = _triples()
    cfg = ttt.TwoTowerConfig(rank=RANK, epochs=2, batch_size=512, seed=3,
                             gather="host",
                             checkpoint_dir=str(tmp_path / "ckpt"),
                             checkpoint_every=1)
    with ttracing.profile_trace(str(tmp_path / "trace")):
        ttt.TwoTowerMF(cfg).fit(CPU, users, items, ratings, N_USERS, N_ITEMS)
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"train_epochs#0", "train_epochs#1"} <= names


def test_stream_fold_phases_are_the_references(monkeypatch):
    """The same two folds by each package's ``DeltaTrainer`` (the port's
    under ``PIO_STREAM_FUSED=device``, K3's route, here its plain version
    on the CPU) land in ``stream.fold`` with the same phase names and
    counts."""
    from tests.test_torch_sparse_update import _fold_both

    _fold_both(monkeypatch, "device")
    counts = {name: {p: v["count"] for p, v in side.prof.phase_snapshot()[
        "stream.fold"]["phases"].items()} for name, side in SIDES.items()}
    assert counts["port"] == counts["jax"] == {
        "assemble": 2, "compute": 2, "gather": 2}


@pytest.mark.parametrize("two_stage", [False, True])
def test_shard_search_phases_are_the_references(monkeypatch, two_stage):
    """A host-sharded search in each package (5 shards; exact, or the
    composed two-stage form): the ``shard.search`` buckets carry the same
    phase names and counts, and conserve their wall."""
    from tests.test_torch_sharding import _host

    for var in ("PIO_SHARD_HBM_BUDGET", "PIO_STREAM_STALE_REBUILD_FRAC"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PIO_SHARD_SERVE", "1")
    monkeypatch.setenv("PIO_SHARD_SERVE_SHARDS", "5")
    monkeypatch.setenv("PIO_RETRIEVAL_MODE",
                       "two_stage" if two_stage else "exact")
    monkeypatch.setenv("PIO_RETRIEVAL_NPROBE", "16")
    monkeypatch.setenv("PIO_RETRIEVAL_QUANTIZE", "0")
    t, j = _host(ttt), _host(jtt)
    t.prepare_for_serving(device="cpu")
    j.prepare_for_serving()
    users = np.arange(0, 130, 10, dtype=np.int32)
    ttt.TwoTowerMF.recommend_batch(t, users, 10)
    jtt.TwoTowerMF.recommend_batch(j, users, 10)
    snaps = {name: side.prof.phase_snapshot()["shard.search"]
             for name, side in SIDES.items()}
    counts = {name: {p: v["count"] for p, v in s["phases"].items()}
              for name, s in snaps.items()}
    assert counts["port"] == counts["jax"] == {"compute": 1, "merge": 1}
    for s in snaps.values():
        covered = sum(p["seconds"] for p in s["phases"].values())
        assert covered == pytest.approx(s["wall_seconds"])


def test_the_ports_families_are_the_references():
    """Every family the port registers exists in the reference's registry
    with the same kind, labels, buckets and help text (the port adds no
    family); the modules that register them are imported on both sides."""
    import importlib

    for mod in ("obs.profile", "obs.http", "utils.jitstats",
                "streaming.stream_metrics", "sharding.shard_metrics",
                "distributed.dist_metrics", "serving.cache",
                "server.query_server", "resilience.admission",
                "resilience.breaker"):
        importlib.import_module(f"incubator_predictionio_tpu.{mod}")
        importlib.import_module(f"incubator_predictionio_tpu_torch.{mod}")
    port = tmetrics.REGISTRY._families
    ref = jmetrics.REGISTRY._families
    assert len(port) >= 50
    for name, fam in sorted(port.items()):
        want = ref.get(name)
        assert want is not None, f"{name}: the reference has no such family"
        assert (fam.kind, fam.labelnames, fam.help, fam._buckets) == (
            want.kind, want.labelnames, want.help, want._buckets), name


def test_watermark_and_sampler_threads_stop():
    s = tprof.StackSampler(hz=200, topn=2)
    s.start()
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, args=(5,))
    t.start()
    try:
        for _ in range(200):
            if s.samples >= 2:
                break
            stop.wait(0.01)
        assert s.samples >= 2 and s.top()
    finally:
        stop.set()
        s.stop()
        t.join()
    assert not s._thread.is_alive()
