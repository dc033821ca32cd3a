"""PyTorch port, the serving safety tier's building blocks against the JAX
package: the circuit breaker and its registry, the deadline half of the
policy engine, the admission layer (rate estimator, ``Retry-After``,
token bucket, fairness and in-flight gates, the adaptive limiter, the
admission controller), the drain lifecycle, the plugin registries and the
metrics registry.

Each case feeds one seeded script (numpy ``default_rng``) of successes,
failures, completion latencies, queue depths and clock steps to the JAX
package's class on its ``FakeClock`` and to the port's on its own, and
holds every decision, limit, ``Retry-After`` and ``snapshot()`` equal.
No case sleeps: time is the fake clocks'.
"""

import asyncio
import os
import signal

import numpy as np
import pytest

pytest.importorskip("torch")

from incubator_predictionio_tpu.obs import metrics as jmetrics  # noqa: E402
from incubator_predictionio_tpu.resilience import admission as jadm  # noqa: E402
from incubator_predictionio_tpu.resilience import breaker as jbrk  # noqa: E402
from incubator_predictionio_tpu.resilience import clock as jclock  # noqa: E402
from incubator_predictionio_tpu.resilience import policy as jpol  # noqa: E402
from incubator_predictionio_tpu.server import lifecycle as jlife  # noqa: E402
from incubator_predictionio_tpu.server import plugins as jplug  # noqa: E402
from incubator_predictionio_tpu_torch import resilience as tres  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage.base import (  # noqa: E402
    StorageError,
)
from incubator_predictionio_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from incubator_predictionio_tpu_torch.resilience import admission as tadm  # noqa: E402
from incubator_predictionio_tpu_torch.resilience import breaker as tbrk  # noqa: E402
from incubator_predictionio_tpu_torch.resilience import clock as tclock  # noqa: E402
from incubator_predictionio_tpu_torch.resilience import policy as tpol  # noqa: E402
from incubator_predictionio_tpu_torch.server import lifecycle as tlife  # noqa: E402
from incubator_predictionio_tpu_torch.server import plugins as tplug  # noqa: E402

#: both packages' modules, side by side: (JAX, port)
SIDES = (
    {"brk": jbrk, "adm": jadm, "pol": jpol, "clock": jclock,
     "life": jlife, "plug": jplug, "metrics": jmetrics},
    {"brk": tbrk, "adm": tadm, "pol": tpol, "clock": tclock,
     "life": tlife, "plug": tplug, "metrics": tmetrics},
)


def both(run):
    """``run(side)`` on the JAX package and on the port; returns both
    traces."""
    return [run(side) for side in SIDES]


def same(run):
    jax_trace, port_trace = both(run)
    assert port_trace == jax_trace
    return port_trace


# -- the circuit breaker --------------------------------------------------------

@pytest.mark.parametrize("seed,threshold,reset,half_open", [
    (1, 3, 10.0, 1), (2, 1, 0.5, 1), (6, 5, 2.0, 2), (4, 0, 1.0, 1),
    (5, 2, 30.0, 3)])
def test_breaker_scripts_match_jax(seed, threshold, reset, half_open):
    ops = np.random.default_rng(seed).choice(
        7, 400, p=[0.3, 0.25, 0.08, 0.07, 0.15, 0.1, 0.05])
    steps = np.random.default_rng(seed + 100).exponential(reset / 3, 400)

    def run(m):
        clk = m["clock"].FakeClock()
        b = m["brk"].CircuitBreaker("b", failure_threshold=threshold,
                                    reset_timeout=reset,
                                    half_open_max=half_open, clock=clk)
        trace = []
        for op, dt in zip(ops, steps):
            if op == 0:
                trace.append(("allow", b.allow()))
            elif op == 1:
                b.record_failure()
            elif op == 2:
                b.record_success()
            elif op == 3:
                b.release_probe()
            elif op == 4:
                clk.advance(float(dt))
            elif op == 5:
                trace.append(("retry", b.retry_after(), b.state))
            trace.append(("snap", b.snapshot()))
        return trace

    trace = same(run)
    states = {t[1]["state"] for t in trace if t[0] == "snap"}
    if threshold > 0:
        assert states == {"closed", "open", "half_open"}


def test_breaker_registry_and_open_error_match_jax():
    def run(m):
        clk = m["clock"].FakeClock()
        reg = m["brk"].BreakerRegistry()
        a = reg.get_or_create("a", failure_threshold=1, clock=clk)
        assert reg.get_or_create("a") is a
        reg.get_or_create("b", failure_threshold=2, clock=clk)
        a.record_failure()
        clk.advance(3.0)
        snap = reg.snapshot()
        reg.reset()
        err = m["brk"].CircuitOpenError("a", 1.25)
        return snap, reg.snapshot(), str(err), err.breaker_name, err.retry_after

    same(run)
    assert issubclass(tbrk.CircuitOpenError, StorageError)
    assert tres.BREAKERS is tbrk.BREAKERS


def test_breaker_metrics_publish_like_jax():
    def run(m):
        name = "resilience-test-breaker"
        m["brk"].publish_breaker_metrics(
            {name: {"state": "half_open", "rejectedCalls": 7}})
        text = m["metrics"].REGISTRY.expose()
        return sorted(line for line in text.splitlines() if name in line)

    lines = same(run)
    assert any("pio_breaker_state" in line and line.endswith(" 1")
               for line in lines)


# -- deadlines ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deadlines_match_jax(seed):
    rng = np.random.default_rng(seed)
    budgets = [None if b < 0.2 else float(b) for b in rng.random(12) * 3]
    steps = rng.random(12)

    def run(m):
        clk = m["clock"].FakeClock(start=5.0)
        pol = m["pol"]
        trace = []
        for budget, dt in zip(budgets, steps):
            d = pol.Deadline.after(budget, clk)
            t = d.tightened(0.5)
            clk.advance(float(dt))
            trace.append((d.expires_at, d.remaining(), d.expired(),
                          d.attempt_timeout(2.0), t.expires_at, t.expired()))
        with pol.deadline_scope(2.0, clk) as outer:
            with pol.deadline_scope(1.0, clk) as inner:
                trace.append((outer.expires_at, inner.expires_at,
                              pol.current_deadline().expires_at))
            with pol.deadline_scope(5.0, clk) as loose:
                trace.append(loose.expires_at)
        trace.append(pol.current_deadline())
        got = pol.run_with_deadline(
            None, lambda x: (x, pol.current_deadline().expires_at), 3)
        trace.append(got)
        return trace

    same(run)


def test_failure_vocabulary_matches_jax():
    for name in ("TransientError", "DeadlineExceeded", "ServingUnavailable"):
        assert issubclass(getattr(tpol, name), StorageError)
        assert getattr(tpol, name).__mro__[1].__name__ == \
            getattr(jpol, name).__mro__[1].__name__
    assert tpol.TransientError.no_retry is jpol.TransientError.no_retry is False
    assert tpol.TRANSIENT_HTTP_CODES == jpol.TRANSIENT_HTTP_CODES
    assert tpol.TRANSIENT_HTTP_CODES_WITH_500 == jpol.TRANSIENT_HTTP_CODES_WITH_500
    assert set(tres.__all__) <= set(
        __import__("incubator_predictionio_tpu.resilience",
                   fromlist=["__all__"]).__all__)


# -- the admission layer ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rate_estimator_and_retry_after_match_jax(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, 300)
    steps = rng.exponential(0.4, 300)
    depths = rng.integers(0, 400, 300)

    def run(m):
        clk = m["clock"].FakeClock()
        est = m["adm"].RateEstimator(window_sec=3.0, clock=clk)
        trace = []
        for n, dt, depth in zip(counts, steps, depths):
            if n:
                est.record(int(n))
            clk.advance(float(dt))
            rate = est.rate()
            trace.append((rate, m["adm"].derive_retry_after(
                int(depth), rate, 5)))
        return trace

    same(run)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_and_fairness_gate_match_jax(seed):
    rng = np.random.default_rng(seed)
    keys = [f"key-{k}" if k < 5 else f"a-very-long-access-key-{k}"
            for k in rng.integers(0, 8, 400)]
    costs = rng.integers(1, 12, 400)
    steps = rng.exponential(0.05, 400)

    def run(m):
        clk = m["clock"].FakeClock()
        bucket = m["adm"].TokenBucket(rate=20.0, burst=5.0, clock=clk)
        gate = m["adm"].FairnessGate(rate=10.0, burst=6.0, clock=clk,
                                     max_clients=4)
        off = m["adm"].FairnessGate(rate=0.0, clock=clk)
        trace = []
        for key, cost, dt in zip(keys, costs, steps):
            clk.advance(float(dt))
            trace.append((bucket.try_acquire(float(cost) / 4),
                          bucket.try_charge(2.0, float(cost)),
                          bucket.retry_after(3.0), bucket.idle,
                          bucket.fill(), gate.admit(key, float(cost)),
                          off.admit(key)))
        trace.append((gate.snapshot(), off.snapshot(), gate.per_client(3)))
        return trace

    same(run)


@pytest.mark.parametrize("seed", [0, 1])
def test_inflight_gate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 2, 300)
    keys = [f"c{k}" for k in rng.integers(0, 4, 300)]

    def run(m):
        gate = m["adm"].InflightGate(2)
        off = m["adm"].InflightGate(0)
        trace = []
        for op, key in zip(ops, keys):
            if op:
                trace.append(gate.acquire(key))
                trace.append(off.acquire(key))
            else:
                gate.release(key)
                off.release(key)
            trace.append(gate.snapshot())
        return trace + [off.snapshot()]

    same(run)


@pytest.mark.parametrize("seed,target", [(0, None), (1, 0.02), (2, None),
                                         (3, 0.005)])
def test_adaptive_limiter_matches_jax(seed, target):
    rng = np.random.default_rng(seed)
    # latency regimes: quiet, congested, quiet again
    lat = np.concatenate([rng.gamma(4, 0.002, 200), rng.gamma(4, 0.01, 200),
                          rng.gamma(4, 0.002, 200)])
    steps = rng.exponential(0.02, 600)

    def run(m):
        clk = m["clock"].FakeClock()
        lim = m["adm"].AdaptiveConcurrencyLimiter(
            min_limit=1, max_limit=6, target_sec=target, window=16,
            cooldown_sec=0.25, clock=clk)
        trace = []
        for i, (x, dt) in enumerate(zip(lat, steps)):
            clk.advance(float(dt))
            trace.append((lim.observe(float(x)), lim.limit,
                          lim.current_target()))
            if i == 450:
                trace.append(lim.set_bounds(2, 4))
        return trace + [lim.changes]

    trace = same(run)
    assert trace[-1] > 0  # the script moved the limit


@pytest.mark.parametrize("seed,deadline,adaptive", [
    (0, None, False), (1, 0.5, False), (2, 0.5, True), (6, 2.0, True),
    (4, None, True)])
def test_admission_controller_matches_jax(seed, deadline, adaptive):
    rng = np.random.default_rng(seed)
    n = 600
    ops = rng.integers(0, 6, n)
    # a depth walk that crosses the brownout and reject thresholds
    depths = np.clip(np.cumsum(rng.integers(-3, 4, n)), 0, 40)
    lat = rng.gamma(3, 0.01, n)
    steps = rng.exponential(0.15, n)

    def run(m):
        clk = m["clock"].FakeClock()
        ctrl = m["adm"].AdmissionController(m["adm"].AdmissionConfig(
            max_queue=32, deadline_sec=deadline, adaptive=adaptive,
            max_inflight=4, brownout_enter_frac=0.5, brownout_enter_sec=1.0,
            brownout_exit_sec=2.0), clock=clk, server="resilience-test")
        trace = []
        for op, depth, x, dt in zip(ops, depths, lat, steps):
            depth = int(depth)
            if op <= 1:
                trace.append(ctrl.decide(depth))
            elif op == 2:
                trace.append(ctrl.on_complete(float(x)))
            elif op == 3:
                trace.append(ctrl.on_complete(float(x), observe_latency=False))
            elif op == 4:
                ctrl.on_shed_expired(int(depth % 3) + 1)
            else:
                trace.append(ctrl.retry_after(depth))
            clk.advance(float(dt))
            trace.append((ctrl.snapshot(depth), ctrl.brownout_active,
                          ctrl.service_rate(), ctrl.current_limit()))
        trace.append(ctrl.set_max_inflight(2))
        return trace

    trace = same(run)
    decisions = {t[0] for t in trace if isinstance(t, tuple) and len(t) == 2
                 and t[0] in ("admit", "brownout", "reject")}
    assert {"admit", "reject"} <= decisions


def test_shed_expired_is_the_references_shape():
    assert tadm.ShedExpired.__mro__[1] is Exception
    assert [tadm.ADMIT, tadm.BROWNOUT, tadm.REJECT] == \
        [jadm.ADMIT, jadm.BROWNOUT, jadm.REJECT]
    assert tadm.__all__ == jadm.__all__
    assert tadm.AdmissionConfig() == tadm.AdmissionConfig(
        **{f: getattr(jadm.AdmissionConfig(), f)
           for f in jadm.AdmissionConfig.__dataclass_fields__})


# -- lifecycle ------------------------------------------------------------------

def test_drain_state_matches_jax():
    def run(m):
        st = m["life"].DrainState("drain-test", retry_after_sec=7)
        trace = [st.draining, st.health_status(False), st.health_status(True)]
        st.begin()
        st.begin()
        resp = st.reject_response()
        trace += [st.draining, st.health_status(False), st.health_status(True),
                  resp.status, resp.headers["Retry-After"], resp.text]
        return trace

    same(run)


@pytest.mark.parametrize("value", [None, "3.5", "junk", "0"])
def test_drained_exit_deadline_matches_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("PIO_DRAIN_DEADLINE", raising=False)
    else:
        monkeypatch.setenv("PIO_DRAIN_DEADLINE", value)
    same(lambda m: (m["life"].drained_exit_deadline(),
                    m["life"].drained_exit_deadline(default=4.0)))


def test_wait_for_matches_jax():
    def run(m):
        polls = []

        def pred():
            polls.append(1)
            return len(polls) >= 3

        async def go():
            hit = await m["life"].wait_for(pred, 5.0, poll_sec=0.0)
            never = await m["life"].wait_for(lambda: False, 0.0)
            return hit, never, len(polls)

        return asyncio.run(go())

    assert same(run) == (True, False, 3)


def test_install_signal_drain_matches_jax():
    """The first SIGTERM sets the stop event; a second exits at once."""
    def run(m):
        async def go():
            stop = asyncio.Event()
            m["life"].install_signal_drain(asyncio.get_running_loop(), stop,
                                           "signal-test")
            # never signal a process whose handler did not install
            assert signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL,
                                                            None)
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(200):
                if stop.is_set():
                    break
                await asyncio.sleep(0.005)
            first = stop.is_set()
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(200):
                await asyncio.sleep(0.005)
            return first, "no exit"

        try:
            return asyncio.run(go())
        except SystemExit as e:
            return "exit", e.code

    assert same(run) == ("exit", 1)


# -- plugins --------------------------------------------------------------------

def _plugins(m):
    p = m["plug"]

    class Redact(p.EngineServerPlugin):
        name, description = "redact", "drops scores"
        output_type = p.EngineServerPlugin.OUTPUTBLOCKER

        def process(self, engine_instance, query, prediction, context):
            return {k: v for k, v in prediction.items() if k != "secret"}

    class Sniff(p.EngineServerPlugin):
        name, description = "sniff", "records"
        seen: list = []

        def process(self, engine_instance, query, prediction, context):
            self.seen.append((query, dict(prediction)))
            raise RuntimeError("a sniffer failure never breaks serving")

    class Stamp(p.EventServerPlugin):
        name = "stamp"
        input_type = p.EventServerPlugin.INPUTBLOCKER

        def process(self, event_info, context):
            return {**event_info, "stamped": True}

    class Watch(p.EventServerPlugin):
        name = "watch"

        def process(self, event_info, context):
            return None

    return Redact(), Sniff(), Stamp(), Watch()


def test_plugins_match_jax():
    def run(m):
        p = m["plug"]
        redact, sniff, stamp, watch = _plugins(m)
        try:
            for x in (redact, sniff):
                p.register_engine_server_plugin(x)
            for x in (stamp, watch):
                p.register_event_server_plugin(x)
            out = p.apply_output_plugins(None, {"user": "u1"},
                                         {"items": [1], "secret": 2})
            ev = p.apply_input_plugins({"event": "rate"})
            names = ([x.name for x in p.engine_plugins("outputblocker")],
                     [x.name for x in p.engine_plugins("outputsniffer")],
                     [x.name for x in p.event_plugins("inputblocker")],
                     [x.name for x in p.event_plugins("inputsniffer")])
            return out, ev, names, sniff.seen, redact.handle_rest("/x", {})
        finally:
            for reg, name in ((p.ENGINE_SERVER_PLUGINS, "redact"),
                              (p.ENGINE_SERVER_PLUGINS, "sniff"),
                              (p.EVENT_SERVER_PLUGINS, "stamp"),
                              (p.EVENT_SERVER_PLUGINS, "watch")):
                reg.pop(name, None)

    out, ev, names, seen, rest = same(run)
    assert out == {"items": [1]} and ev == {"event": "rate", "stamped": True}
    assert seen == [({"user": "u1"}, {"items": [1]})] and rest == {}


# -- the metrics registry ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_registry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    xs = rng.gamma(2, 0.01, 200)

    def run(m):
        reg = m["metrics"].MetricsRegistry()
        c = reg.counter("t_total", "a counter", labels=("k",))
        g = reg.gauge("t_gauge", "a gauge")
        h = reg.histogram("t_seconds", "a histogram",
                          buckets=(0.005, 0.01, 0.05))
        res = m["metrics"].LatencyReservoir()
        for i, x in enumerate(xs):
            c.labels(k=f"v{i % 3}").inc()
            g.set(float(x))
            h.observe(float(x))
            res.record(float(x))
        h.observe_exemplar(0.02, trace_id="t-1")
        text = reg.expose()
        parsed = m["metrics"].parse_prometheus_text(
            "\n".join(line.split(" # ")[0] for line in text.splitlines()))
        return (text.replace("t-1", ""), sorted(parsed), res.percentiles(),
                m["metrics"].nearest_rank_percentiles(list(xs)))

    same(run)
