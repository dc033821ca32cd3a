"""PyTorch port, evaluation against the JAX package's on the CPU: the metric
hierarchy, ``MetricEvaluator``, ``Engine.eval``, ``FastEvalEngine``,
``run_evaluation`` / ``create_workflow``, the evaluation instances of the
memory and sqlite stores, the CLI ``eval`` verb, and ``read_eval`` with the
metrics of the recommendation, classification and sequential templates.

Tolerances:

- metrics, the evaluator's one-liner, JSON, HTML and ``best.json``, the
  folds (train arrays, fold-local vocabularies, query and actual pairs in
  order) and the workflow machinery on a pure-numpy engine: bitwise / equal
  (the same host arithmetic in the same order);
- end to end on the reference tests' planted data, where the fits differ
  by torch's and JAX's random numbers: each package clears the reference
  test's floor, and the two scores lie within a band of each other
  (``E2E_BANDS``). Measured on this file's data: Precision@4 0.2748 (JAX)
  against 0.2553 (port), chance ~0.25; accuracy 0.9792 both, each label's
  precision 1.0 / 0.9608 both; HitRate@1 1.0 both.
"""

import dataclasses
import datetime as dt
import json
import math
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu import core as jcore  # noqa: E402
from incubator_predictionio_tpu.core import metric as jmetric  # noqa: E402
from incubator_predictionio_tpu.core.fast_eval import FastEvalEngine as JFastEval  # noqa: E402
from incubator_predictionio_tpu.core.workflow import core_workflow as jwf  # noqa: E402
from incubator_predictionio_tpu.data import event as jevent  # noqa: E402
from incubator_predictionio_tpu.data.storage import base as jbase  # noqa: E402
from incubator_predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.templates import classification as jcl  # noqa: E402
from incubator_predictionio_tpu.templates import recommendation as jrec  # noqa: E402
from incubator_predictionio_tpu.templates import sequential as jseq  # noqa: E402
from incubator_predictionio_tpu_torch import core as tcore  # noqa: E402
from incubator_predictionio_tpu_torch.core import metric as tmetric  # noqa: E402
from incubator_predictionio_tpu_torch.core.fast_eval import FastEvalEngine  # noqa: E402
from incubator_predictionio_tpu_torch.core.workflow import core_workflow as twf  # noqa: E402
from incubator_predictionio_tpu_torch.core.workflow.create_workflow import (  # noqa: E402
    WorkflowConfig,
    create_workflow,
)
from incubator_predictionio_tpu_torch.data import event as tevent  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.templates import classification as tcl  # noqa: E402
from incubator_predictionio_tpu_torch.templates import recommendation as trec  # noqa: E402
from incubator_predictionio_tpu_torch.templates import sequential as tseq  # noqa: E402
from incubator_predictionio_tpu_torch.tools import cli  # noqa: E402

CPU = DeviceContext.create(device="cpu")
MESH = MeshContext.create()
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
#: (floor each package clears — the reference test's own — , band between
#: the two packages' scores)
E2E_BANDS = {"precision_at_4": (0.25, 0.05), "accuracy": (0.75, 0.05),
             "label_precision": (0.7, None), "hit_rate_at_1": (0.5, 0.1)}


def bits(x) -> bytes:
    return struct.pack("<d", float(x))


def _both(fn):
    """``fn`` run on each package's module set: (reference, port)."""
    return fn(jcore, jmetric), fn(tcore, tmetric)


# -- metrics -------------------------------------------------------------------

METRICS = ("AverageMetric", "OptionAverageMetric", "StdevMetric",
           "OptionStdevMetric", "SumMetric", "ZeroMetric")
#: share of rows whose score is None (skipped); "empty" has no rows at all
CASES = {"rows": 0.0, "some_skipped": 0.3, "all_skipped": 1.0, "empty": None}


def _qpa_set(case: str, seed=5):
    share = CASES[case]
    if share is None:
        return [({"fold": 0}, []), ({"fold": 1}, [])]
    rng = np.random.default_rng(seed)
    out = []
    for fold in range(3):
        n = int(rng.integers(20, 40))
        q = rng.integers(0, 1000, n)
        p = rng.standard_normal(n) * 3.0
        a = rng.standard_normal(n)
        skip = rng.random(n) < share
        out.append(({"fold": fold}, [
            (int(qi), float(pi), None if si else float(ai))
            for qi, pi, ai, si in zip(q, p, a, skip)]))
    return out


def _metric(name, mod):
    base = getattr(mod, name)
    if name == "ZeroMetric":
        return base()

    class Err(base):
        def calculate_qpa(self, q, p, a):
            return None if a is None else -abs(p - a) * (1 + q % 7)

    return Err()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", METRICS)
def test_metric_is_bitwise_the_references(name, case):
    data = _qpa_set(case)
    want_m, got_m = _both(lambda core, mod: _metric(name, mod))
    skipped = case in ("some_skipped", "all_skipped")
    if name == "AverageMetric" and skipped:
        with pytest.raises(ValueError) as want_e:
            want_m.calculate(MESH, data)
        with pytest.raises(ValueError) as got_e:
            got_m.calculate(CPU, data)
        assert str(got_e.value) == str(want_e.value)
        return
    want = want_m.calculate(MESH, data)
    got = got_m.calculate(CPU, data)
    assert type(got) is float and bits(got) == bits(want), (got, want)
    if case in ("all_skipped", "empty") and name not in ("SumMetric", "ZeroMetric"):
        assert math.isnan(got)
    if name != "ZeroMetric":
        w, g = want_m._scores(data), got_m._scores(data)
        assert g.dtype == w.dtype == np.float64 and g.tobytes() == w.tobytes()


def test_metric_compare_and_header():
    class Up(tmetric.ZeroMetric):
        pass

    class Down(tmetric.ZeroMetric):
        is_larger_better = False

    class JUp(jmetric.ZeroMetric):
        pass

    class JDown(jmetric.ZeroMetric):
        is_larger_better = False

    pairs = [(0.5, 0.25), (0.25, 0.5), (0.5, 0.5), (float("nan"), 0.5),
             (0.5, float("nan")), (-0.0, 0.0), (float("inf"), 1e300)]
    for got_m, want_m in ((Up(), JUp()), (Down(), JDown())):
        assert [got_m.compare(a, b) for a, b in pairs] == \
            [want_m.compare(a, b) for a, b in pairs]
    assert Up().header == "Up" and Down().header == "Down"
    assert tmetric.QPAMetric.__abstractmethods__ == jmetric.QPAMetric.__abstractmethods__
    assert tmetric.Metric.__abstractmethods__ == jmetric.Metric.__abstractmethods__


def _rec_qpa(pkg, seed=7):
    rng = np.random.default_rng(seed)
    items = [f"i{j}" for j in range(30)]
    out = []
    for fold in range(2):
        qpas = []
        for u in range(40):
            n_pred = int(rng.integers(0, 12))
            pred = rng.choice(items, n_pred, replace=False)
            n_act = int(rng.integers(1, 8))
            act = rng.choice(items, n_act, replace=False)
            ratings = rng.integers(1, 6, n_act).astype(float)
            qpas.append((
                pkg.Query(user=f"u{u}", num=10),
                pkg.PredictedResult(tuple(pkg.ItemScore(str(i), float(s)) for i, s in
                                          zip(pred, rng.random(n_pred)))),
                pkg.ActualResult(tuple(pkg.ItemRating(str(i), float(r))
                                       for i, r in zip(act, ratings)))))
        out.append(({"fold": fold}, qpas))
    return out


def _seq_qpa(pkg, seed=8):
    rng = np.random.default_rng(seed)
    out = []
    for fold in range(3):
        qpas = []
        for _ in range(30):
            n_pred = int(rng.integers(0, 12))
            pred = [f"i{j}" for j in rng.choice(20, n_pred, replace=False)]
            qpas.append((pkg.Query(recent_items=("i1", "i2"), num=10),
                         pkg.PredictedResult(tuple(pkg.ItemScore(i, 0.5) for i in pred)),
                         pkg.ActualResult(f"i{int(rng.integers(0, 20))}")))
        out.append(({"fold": fold}, qpas))
    return out


def _cls_qpa(pkg, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for fold in range(3):
        pred = rng.integers(0, 3, 25).astype(float)
        act = np.where(rng.random(25) < 0.7, pred, rng.integers(0, 3, 25))
        out.append(({"fold": fold}, [
            (pkg.Query((float(j), 1.0, 2.0)), pkg.PredictedResult(label=p), a)
            for j, (p, a) in enumerate(zip(pred, act.astype(float)))]))
    return out


TEMPLATE_METRICS = [
    ("PrecisionAtK(k=1)", "rec", lambda m: m.PrecisionAtK(k=1)),
    ("PrecisionAtK(k=4,4.0)", "rec", lambda m: m.PrecisionAtK(k=4, rating_threshold=4.0)),
    ("PrecisionAtK(k=10)", "rec", lambda m: m.PrecisionAtK(k=10)),
    ("PositiveCount", "rec", lambda m: m.PositiveCount()),
    ("PositiveCount(4.0)", "rec", lambda m: m.PositiveCount(rating_threshold=4.0)),
    ("HitRateAtK(k=1)", "seq", lambda m: m.HitRateAtK(k=1)),
    ("HitRateAtK(k=10)", "seq", lambda m: m.HitRateAtK(k=10)),
    ("Accuracy", "cls", lambda m: m.Accuracy()),
    ("Precision(0.0)", "cls", lambda m: m.Precision(label=0.0)),
    ("Precision(2.0)", "cls", lambda m: m.Precision(label=2.0)),
    ("Precision(42)", "cls", lambda m: m.Precision(label=42)),
]
TEMPLATES = {"rec": (jrec, trec, _rec_qpa), "seq": (jseq, tseq, _seq_qpa),
             "cls": (jcl, tcl, _cls_qpa)}


@pytest.mark.parametrize("label,template,make",
                         TEMPLATE_METRICS, ids=[m[0] for m in TEMPLATE_METRICS])
def test_template_metric_is_bitwise_the_references(label, template, make):
    jpkg, tpkg, data = TEMPLATES[template]
    want_m, got_m = make(jpkg), make(tpkg)
    want = want_m.calculate(MESH, data(jpkg))
    got = got_m.calculate(CPU, data(tpkg))
    assert bits(got) == bits(want), (got, want)
    assert got_m.header == want_m.header
    if label == "Precision(42)":
        assert math.isnan(got)  # a label never predicted: every row skipped


# -- MetricEvaluator -----------------------------------------------------------

def _given(mod, header):
    """A metric whose eval data IS its score (the evaluator's ranking and
    output on chosen scores)."""
    class Given(mod.Metric):
        def calculate(self, ctx, eval_data):
            return eval_data[0] if header == "primary" else eval_data[1]

        @property
        def header(self):
            return header

    return Given()


def _variants(core, pkg, n):
    return [core.EngineParams.create(
        data_source=pkg.DataSourceParams(app_name="rec", eval_k=3),
        algorithms=[("als", pkg.ALSAlgorithmParams(rank=8 * (j + 1),
                                                   num_iterations=j + 1))])
        for j in range(n)]


@pytest.mark.parametrize("scores,larger", [
    ([0.25, 0.5, 0.5, 0.125], True),   # a tie goes to the first
    ([float("nan"), 0.3, 0.1], True),  # a leading NaN never wins
    ([0.4, float("nan"), 0.1], False),
    ([float("nan"), float("nan")], True),
])
def test_metric_evaluator_output_is_the_references(tmp_path, scores, larger):
    out = {}
    for tag, core, mod, pkg, ctx in (("jax", jcore, jmetric, jrec, MESH),
                                     ("torch", tcore, tmetric, trec, CPU)):
        primary = _given(mod, "primary")
        type(primary).is_larger_better = larger
        path = tmp_path / tag / "best.json"
        ev = core.MetricEvaluator(primary, [_given(mod, "other")], str(path))
        data = [(ep, (s, -s / 3)) for ep, s in
                zip(_variants(core, pkg, len(scores)), scores)]
        res = ev.evaluate(ctx, None, data, core.WorkflowParams())
        out[tag] = (res.best_idx, res.to_one_liner(), res.to_json(),
                    res.to_html(), path.read_bytes())
    assert out["torch"] == out["jax"]
    best_idx = out["torch"][0]
    defined = [s for s in scores if s == s]
    if defined:
        best = max(defined) if larger else min(defined)
        assert scores[best_idx] == best and scores.index(best) == best_idx
    with pytest.raises(ValueError, match="no engine params"):
        tcore.MetricEvaluator(_given(tmetric, "primary")).evaluate(CPU, None, [], None)


def test_evaluation_dsl_wires_engine_and_evaluator():
    for core, mod in ((jcore, jmetric), (tcore, tmetric)):
        ev = core.Evaluation()
        engine = core.Engine({}, {}, {}, {})
        metric = _given(mod, "primary")
        ev.engine_metric = (engine, metric)
        assert ev.engine is engine and ev.evaluator.metric is metric
        assert ev.evaluator.other_metrics == [] and ev.evaluator.output_path is None
        assert isinstance(ev.evaluator, core.BaseEvaluator)
        assert isinstance(ev.evaluator.evaluate(None, ev, [(None, (1.0, 0.0))], None),
                          core.BaseEvaluatorResult)
        ev.engine_metrics(engine, metric, [metric], "out.json")
        assert ev.evaluator.other_metrics == [metric]
        assert ev.evaluator.output_path == "out.json"
    assert tcore.BaseEvaluatorResult().no_save is False
    assert tcore.BaseEvaluatorResult().to_json() == ""


# -- the workflow machinery on a pure-numpy engine -----------------------------

def numpy_engine(core, fail=False):
    """A deterministic engine on ``core``'s own controller classes: folds of
    a seeded line fit, a least-squares slope per algorithm, and a
    ``batch_predict`` that answers in reverse order (``Engine.eval`` must
    regroup by query index)."""

    @dataclasses.dataclass(frozen=True)
    class DSParams(core.Params):
        n: int = 24
        k: int = 3
        seed: int = 0

    @dataclasses.dataclass(frozen=True)
    class AlgoParams(core.Params):
        scale: float = 1.0

    class DataSource(core.PDataSource):
        params_class = DSParams

        def read_training(self, ctx):
            raise AssertionError("evaluation reads folds only")

        def read_eval(self, ctx):
            p = self.params
            rng = np.random.default_rng(p.seed)
            x = rng.standard_normal(p.n)
            y = 2.0 * x + 0.1 * rng.standard_normal(p.n)
            fold_of = np.arange(p.n) % p.k
            return [((x[fold_of != f], y[fold_of != f]), {"fold": f},
                     [(float(q), float(a)) for q, a in
                      zip(x[fold_of == f], y[fold_of == f])])
                    for f in range(p.k)]

    class Algorithm(core.P2LAlgorithm):
        params_class = AlgoParams

        def train(self, ctx, pd):
            if fail:
                raise RuntimeError("planted training failure")
            x, y = pd
            return float(x @ y / (x @ x)) * self.params.scale

        def predict(self, model, query):
            return model * query

        def batch_predict(self, model, queries):
            return [(i, model * q) for i, q in reversed(list(queries))]

    class Serving(core.LServing):
        def serve(self, query, predictions):
            return sum(predictions) / len(predictions)

    class Err(core.AverageMetric):
        def calculate_qpa(self, q, p, a):
            return -abs(p - a)

    engine = core.Engine(DataSource, core.IdentityPreparator,
                         {"a": Algorithm, "b": Algorithm}, Serving)

    def variant(*scales, seed=0):
        return core.EngineParams.create(
            data_source=DSParams(seed=seed),
            algorithms=[(name, AlgoParams(s)) for name, s in zip("ab", scales)])

    return engine, variant, Err()


def test_engine_eval_groups_by_query_index():
    (je, jv, jm), (te, tv, tm) = _both(lambda core, mod: numpy_engine(core))
    want = je.eval(MESH, jv(1.0, 0.5))
    got = te.eval(CPU, tv(1.0, 0.5))
    assert got == want and len(got) == 3
    for ei, qpa in got:
        w = None
        for q, p, a in qpa:
            # two algorithms' slopes (w, w/2) averaged: p = 0.75 w q
            w = p / (0.75 * q) if w is None else w
            assert math.isclose(p, 0.75 * w * q, rel_tol=1e-12)
    assert bits(tm.calculate(CPU, got)) == bits(jm.calculate(MESH, want))
    # the default batch_predict of a P algorithm refuses, as the reference's
    with pytest.raises(NotImplementedError, match="vectorized batch_predict"):
        tcore.PAlgorithm().batch_predict(None, [(0, 1.0)])


def test_fast_eval_caches_prefixes_like_the_reference():
    """test_recommendation_template.py:198's case: two identical variants
    and a third that shares the data source and preparator only."""
    (je, jv, _), (te, tv, _) = _both(lambda core, mod: numpy_engine(core))
    jf, tf = JFastEval.from_engine(je), FastEvalEngine.from_engine(te)
    want = jf.batch_eval(MESH, [jv(1.0), jv(1.0), jv(2.0)], None)
    got = tf.batch_eval(CPU, [tv(1.0), tv(1.0), tv(2.0)], None)
    assert tf.last_cache_stats == jf.last_cache_stats == {"ds": 1, "prep": 1, "algo": 2}
    assert [r for _, r in got] == [r for _, r in want]
    assert [ep for ep, _ in got] == [tv(1.0), tv(1.0), tv(2.0)]
    # the memoized results equal the plain batch_eval's
    assert [r for _, r in te.batch_eval(CPU, [tv(1.0), tv(2.0)], None)] == \
        [got[0][1], got[2][1]]
    tf.batch_eval(CPU, [tv(1.0, seed=1), tv(1.0, 2.0, seed=2)], None)
    assert tf.last_cache_stats == {"ds": 2, "prep": 2, "algo": 3}


def _eval_instance(mod):
    return mod.EvaluationInstance(
        id="", status="INIT", start_time=T0, end_time=None,
        evaluation_class="tests.Eval", batch="b")


@pytest.mark.parametrize("outcome", ["completed", "failed", "no_save"])
def test_run_evaluation_rows_like_the_references(outcome):
    rows = {}
    for tag, core, mod, wf, base, reg, ctx in (
            ("jax", jcore, jmetric, jwf, jbase, jreg, MeshContext.create()),
            ("torch", tcore, tmetric, twf, tbase, treg, CPU)):
        engine, variant, metric = numpy_engine(core, fail=outcome == "failed")
        evaluation = core.Evaluation()
        evaluation.engine = engine
        evaluation.evaluator = core.MetricEvaluator(metric)
        if outcome == "no_save":
            class NoSave(core.MetricEvaluator):
                def evaluate(self, *args):
                    res = super().evaluate(*args)
                    res.no_save = True
                    return res

            evaluation.evaluator = NoSave(metric)
        storage = reg.Storage({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
        ran = []
        wf.CleanupFunctions.add(lambda: ran.append(True))
        try:
            if outcome == "failed":
                with pytest.raises(RuntimeError, match="planted"):
                    wf.run_evaluation(evaluation, [variant(1.0)],
                                      _eval_instance(base), storage=storage, ctx=ctx)
                res = None
            else:
                _, res = wf.run_evaluation(
                    evaluation, [variant(0.5), variant(1.0), variant(1.0, 3.0)],
                    _eval_instance(base), storage=storage, ctx=ctx)
        finally:
            wf.CleanupFunctions.clear()
        assert ran == [True]
        [inst] = storage.get_meta_data_evaluation_instances().get_all()
        rows[tag] = (inst.status, inst.evaluator_results,
                     inst.evaluator_results_json, inst.evaluator_results_html,
                     inst.end_time is None, res and (res.best_idx, res.to_json()))
        storage.close()
    assert rows["torch"] == rows["jax"]
    status = rows["torch"][0]
    assert status == {"completed": "EVALCOMPLETED", "failed": "EVALFAILED",
                      "no_save": "INIT"}[outcome]
    if outcome == "completed":
        assert rows["torch"][-1][0] == 1 and "[" in rows["torch"][1]
        assert json.loads(rows["torch"][2])["bestIdx"] == 1


def test_run_evaluation_needs_engine_and_evaluator():
    with pytest.raises(ValueError, match="engine and evaluator"):
        twf.run_evaluation(tcore.Evaluation(), [], _eval_instance(tbase),
                           storage=treg.Storage({"PIO_STORAGE_SOURCES_M_TYPE": "memory"}),
                           ctx=CPU)


# -- storage --------------------------------------------------------------------

def _meta_client(backend, tmp_path):
    if backend == "memory":
        return treg.Storage({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    return treg.Storage({"PIO_STORAGE_SOURCES_M_TYPE": "sqlite",
                         "PIO_STORAGE_SOURCES_M_PATH": str(tmp_path / "pio.db")})


def t(h):
    return dt.datetime(2026, 1, 1, h, tzinfo=dt.timezone.utc)


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_evaluation_instances_contract(backend, tmp_path):
    """test_storage_contract.py:440 and :466, on the port's backends."""
    storage = _meta_client(backend, tmp_path)
    evi = storage.get_meta_data_evaluation_instances()
    iid = evi.insert(tbase.EvaluationInstance(
        id="", status="EVALCOMPLETED", start_time=t(1), end_time=t(2),
        evaluation_class="pkg.Eval", evaluator_results="score=0.5",
    ))
    assert evi.get(iid).evaluator_results == "score=0.5"
    assert [x.id for x in evi.get_completed()] == [iid]
    i2 = evi.insert(tbase.EvaluationInstance(
        id="", status="EVALCOMPLETED", start_time=t(3), end_time=None,
        env={"PIO_X": "1"}))
    evi.insert(tbase.EvaluationInstance(id="", status="INIT", start_time=t(4),
                                        end_time=None))
    assert [x.id for x in evi.get_completed()] == [i2, iid]  # newest first
    assert evi.get(i2).env == {"PIO_X": "1"} and evi.get(i2).end_time is None
    assert evi.update(dataclasses.replace(evi.get(i2), status="EVALFAILED"))
    assert evi.get(i2).status == "EVALFAILED" and len(evi.get_all()) == 3
    assert evi.delete(iid) and evi.get(iid) is None and not evi.delete(iid)
    missing = tbase.EvaluationInstance(id="missing", status="EVALCOMPLETED",
                                       start_time=t(1), end_time=None)
    assert evi.update(missing) is False and evi.get("missing") is None
    storage.close()


def test_sqlite_evaluation_rows_read_across_packages(tmp_path):
    env = {"PIO_STORAGE_SOURCES_M_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_M_PATH": str(tmp_path / "pio.db")}
    js, ts = jreg.Storage(env), treg.Storage(env)
    fields = dict(status="EVALCOMPLETED", start_time=dt.datetime(
        2026, 3, 1, 12, 0, 0, 123456, tzinfo=dt.timezone.utc), end_time=t(5),
        evaluation_class="a.B", engine_params_generator_class="a.G",
        batch="nightly", env={"PIO_STORAGE_X": "y"}, evaluator_results="[0.5] m",
        evaluator_results_html="<h3>m</h3>",
        evaluator_results_json=json.dumps({"bestScore": float("nan")}))
    jid = js.get_meta_data_evaluation_instances().insert(
        jbase.EvaluationInstance(id="", **fields))
    tid = ts.get_meta_data_evaluation_instances().insert(
        tbase.EvaluationInstance(id="", **fields))
    for iid in (jid, tid):
        want = js.get_meta_data_evaluation_instances().get(iid)
        got = ts.get_meta_data_evaluation_instances().get(iid)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(got) == dict(id=iid, **fields)
    js.close()
    ts.close()


# -- the three templates' folds and end to end ---------------------------------

def _rec_dicts():
    """rate events of 30 users over 20 items, re-rates and buys."""
    rng = np.random.default_rng(2)
    out = []
    for j in range(300):
        out.append({"event": "rate", "entityType": "user",
                    "entityId": f"u{int(rng.integers(0, 30))}",
                    "targetEntityType": "item",
                    "targetEntityId": f"i{int(rng.integers(0, 20))}",
                    "properties": {"rating": float(rng.integers(1, 6))},
                    "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()})
    for j in range(10):
        out.append({"event": "buy", "entityType": "user", "entityId": f"u{j}",
                    "targetEntityType": "item", "targetEntityId": f"i{j + 25}",
                    "eventTime": (T0 + dt.timedelta(seconds=400 + j)).isoformat()})
    return out


def _seq_dicts():
    """view sessions of 40 users, 1-14 items each, over 15 items."""
    rng = np.random.default_rng(4)
    out, j = [], 0
    for u in range(40):
        for _ in range(int(rng.integers(1, 15))):
            out.append({"event": "view", "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "item",
                        "targetEntityId": f"i{int(rng.integers(0, 15))}",
                        "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()})
            j += 1
    return out


def _cls_dicts():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((50, 3))
    return [{"event": "$set", "entityType": "user", "entityId": f"u{j}",
             "properties": {"attr0": float(r[0]), "attr1": float(r[1]),
                            "attr2": float(r[2]), "plan": float(j % 3)},
             "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()}
            for j, r in enumerate(x)]


def _planted_rec_dicts():
    """test_recommendation_template.py:31-59: even users like even items."""
    rng = np.random.default_rng(3)
    out = []
    for u in range(24):
        for i in range(16):
            if rng.random() < 0.6:
                liked = (u % 2) == (i % 2)
                rating = (4.0 + rng.random()) if liked else (1.0 + rng.random())
                out.append({"event": "rate", "entityType": "user", "entityId": f"u{u}",
                            "targetEntityType": "item", "targetEntityId": f"i{i}",
                            "properties": {"rating": rating},
                            "eventTime": (T0 + dt.timedelta(seconds=u * 100 + i)).isoformat()})
    out.append({"event": "buy", "entityType": "user", "entityId": "u0",
                "targetEntityType": "item", "targetEntityId": "i2",
                "eventTime": (T0 + dt.timedelta(days=1)).isoformat()})
    out.append({"event": "rate", "entityType": "user", "entityId": "u0",
                "targetEntityType": "item", "targetEntityId": "i1",
                "properties": {"rating": 1.0},
                "eventTime": (T0 + dt.timedelta(days=2)).isoformat()})
    return out


def _planted_seq_dicts():
    """test_sequential_template.py:25-44: sessions walk a 12-item cycle."""
    rng = np.random.default_rng(9)
    out = []
    for u in range(48):
        start = int(rng.integers(0, 12))
        length = int(rng.integers(5, 12))
        for step in range(length):
            out.append({"event": "view", "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "item",
                        "targetEntityId": f"i{(start + step) % 12}",
                        "eventTime": (T0 + dt.timedelta(seconds=u * 1000 + step)).isoformat()})
    return out


def _planted_cls_dicts():
    """test_classification_template.py:36-58: a linear rule of 3 features."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(96, 3))
    y = (x @ np.array([2.0, -1.0, 0.5]) > 0).astype(int)
    return [{"event": "$set", "entityType": "user", "entityId": f"u{i}",
             "properties": {"attr0": float(x[i, 0]), "attr1": float(x[i, 1]),
                            "attr2": float(x[i, 2]), "plan": int(y[i])},
             "eventTime": T0.isoformat()} for i in range(len(y))]


APPS = {"rec": _rec_dicts, "seq": _seq_dicts, "cls": _cls_dicts,
        "rec-test": _planted_rec_dicts, "seq-test": _planted_seq_dicts,
        "cls-test": _planted_cls_dicts}


def _fill(reg, base, event_mod, path):
    storage = reg.Storage({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                           "PIO_STORAGE_SOURCES_DB_PATH": path})
    for name, dicts in APPS.items():
        app_id = storage.get_meta_data_apps().insert(base.App(0, name))
        events = storage.get_events()
        events.init(app_id)
        events.insert_batch([event_mod.Event.from_json_dict(d) for d in dicts()],
                            app_id)
    return storage


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same events in each package's sqlite store, each the process
    storage of its package for the module's tests."""
    tmp = tmp_path_factory.mktemp("eval")
    js = _fill(jreg, jbase, jevent, str(tmp / "jax.db"))
    ts = _fill(treg, tbase, tevent, str(tmp / "torch.db"))
    prev_j, prev_t = jreg.use_storage(js), treg.use_storage(ts)
    yield js, ts
    jreg.use_storage(prev_j)
    treg.use_storage(prev_t)
    js.close()
    ts.close()


def _rec_fold(fold):
    td, ei, qa = fold
    return (ei, [(n, getattr(td, n).dtype.str, getattr(td, n).tobytes())
                 for n in ("user_idx", "item_idx", "ratings")],
            td.user_vocab.tolist(), td.item_vocab.tolist(),
            [(q.user, q.num, [(r.item, bits(r.rating)) for r in a.ratings])
             for q, a in qa])


def _cls_fold(fold):
    td, ei, qa = fold
    return (ei, td.x.dtype.str, td.x.tobytes(), td.y.dtype.str, td.y.tobytes(),
            [([bits(v) for v in q.features], type(a), a) for q, a in qa])


def _seq_fold(fold):
    td, ei, qa = fold
    return (ei, td.sequences.dtype.str, td.sequences.tobytes(),
            list(td.item_map.items()),
            [(q.recent_items, q.num, q.user, a.next_item) for q, a in qa])


@pytest.mark.parametrize("template,k", [("rec", 3), ("rec", 5), ("cls", 3),
                                        ("cls", 4), ("seq", 3), ("seq", 2)])
def test_read_eval_folds_are_bitwise_the_references(stores, template, k):
    jpkg, tpkg, _ = TEMPLATES[template]
    view = {"rec": _rec_fold, "cls": _cls_fold, "seq": _seq_fold}[template]
    extra = {"seq": {"max_len": 8}}.get(template, {})
    want = jpkg.DataSource(jpkg.DataSourceParams(
        app_name=template, eval_k=k, **extra)).read_eval(MESH)
    got = tpkg.DataSource(tpkg.DataSourceParams(
        app_name=template, eval_k=k, **extra)).read_eval(CPU)
    assert len(got) == len(want) == k
    assert [view(f) for f in got] == [view(f) for f in want]
    for td, _, qa in got:
        td.sanity_check()
        assert qa
    if template == "rec":
        # fold-local vocabularies: a user or item held out of every train
        # row of the fold is genuinely unknown to the fold's model
        full = tpkg.DataSource(tpkg.DataSourceParams(app_name="rec")).read_training(CPU)
        for td, _, qa in got:
            assert set(td.user_vocab) <= set(full.user_vocab)
            assert len(td.user_idx) < len(full.ratings)
            assert td.user_idx.max() == len(td.user_vocab) - 1
    if template == "seq":
        sessions, _ = tpkg.DataSource(tpkg.DataSourceParams(
            app_name="seq"))._collect_sessions(CPU)
        held = sum(len(qa) for _, _, qa in got)
        assert held == sum(1 for s in sessions.values() if len(s) >= 3)
    assert tpkg.DataSource(tpkg.DataSourceParams(app_name=template)).read_eval(CPU) == []


@pytest.mark.parametrize("template,read", [
    ("rec", "read_training"), ("rec", "read_eval"),
    ("seq", "read_training"), ("seq", "read_eval"),
    ("similarproduct", "read_training"), ("recommended_user", "read_training"),
    ("ecommerce", "read_training"), ("classification", "read_training")])
def test_sharded_reads_refuse_naming_item_4(stores, template, read):
    """Every template's sharded reads are ported
    (tests/test_torch_distributed_eval.py,
    tests/test_torch_distributed_templates.py): a context that claims two
    processes without a group refuses at its first collective."""
    two = DeviceContext(torch.device("cpu"), process_index=0, process_count=2)
    if template in ("rec", "seq"):
        tpkg = TEMPLATES[template][1]
        ds = tpkg.DataSource(tpkg.DataSourceParams(app_name=template, eval_k=3))
    else:
        import importlib

        tpkg = importlib.import_module(
            f"incubator_predictionio_tpu_torch.templates.{template}")
        # an app of the store: the reads resolve it before their first
        # collective
        ds = tpkg.DataSource(tpkg.DataSourceParams(
            app_name="cls" if template == "classification" else "rec"))
    with pytest.raises(RuntimeError, match="no process group was joined"):
        getattr(ds, read)(two)


def test_recommendation_eval_end_to_end(stores):
    """test_recommendation_template.py:198 on the same planted events."""
    scores = {}
    for tag, core, pkg, ctx in (("jax", jcore, jrec, MESH), ("torch", tcore, trec, CPU)):
        ep = core.EngineParams.create(
            data_source=pkg.DataSourceParams(app_name="rec-test", eval_k=2),
            algorithms=[("als", pkg.ALSAlgorithmParams(
                rank=8, num_iterations=200, learning_rate=5e-2, batch_size=512))])
        results = pkg.RecommendationEngine().apply().eval(ctx, ep)
        scores[tag] = pkg.PrecisionAtK(k=4, rating_threshold=4.0).calculate(ctx, results)
        assert pkg.PositiveCount(rating_threshold=4.0).calculate(ctx, results) > 0
        for _, qpa in results:
            for q, p, _ in qpa:
                ids = [s.item for s in p.item_scores]
                assert len(ids) <= q.num and len(set(ids)) == len(ids)
    floor, band = E2E_BANDS["precision_at_4"]
    assert min(scores.values()) > floor, scores
    assert abs(scores["torch"] - scores["jax"]) <= band, scores


def test_classification_eval_end_to_end(stores):
    """test_classification_template.py:195-240 on the same planted events."""
    acc, prec = {}, {}
    for tag, core, pkg, ctx in (("jax", jcore, jcl, MESH), ("torch", tcore, tcl, CPU)):
        ep = core.EngineParams.create(
            data_source=pkg.DataSourceParams(app_name="cls-test", eval_k=3),
            algorithms=[("mlp", pkg.MLPAlgorithmParams(
                hidden_dims=(16,), epochs=40, learning_rate=3e-2, batch_size=96))])
        results = pkg.ClassificationEngine().apply().eval(ctx, ep)
        assert len(results) == 3
        acc[tag] = pkg.Accuracy().calculate(ctx, results)
        prec[tag] = [pkg.Precision(label=lb).calculate(ctx, results) for lb in (0, 1)]
        assert math.isnan(pkg.Precision(label=42).calculate(ctx, results))
    floor, band = E2E_BANDS["accuracy"]
    assert min(acc.values()) > floor and abs(acc["torch"] - acc["jax"]) <= band, acc
    assert min(min(p) for p in prec.values()) > E2E_BANDS["label_precision"][0], prec


def test_sequential_eval_end_to_end(stores):
    """test_sequential_template.py:126 on the same planted sessions."""
    top1 = {}
    for tag, core, pkg, ctx in (("jax", jcore, jseq, MESH), ("torch", tcore, tseq, CPU)):
        ep = core.EngineParams.create(
            data_source=pkg.DataSourceParams(app_name="seq-test", max_len=16, eval_k=3),
            algorithms=[("transformer", pkg.TransformerAlgorithmParams(
                app_name="seq-test", max_len=16, d_model=32, n_heads=2,
                n_layers=2, learning_rate=3e-3, batch_size=64, epochs=80))])
        results = pkg.SequentialEngine().apply().eval(ctx, ep)
        assert all(len(td_qa) > 0 for _, td_qa in results)
        top1[tag] = pkg.HitRateAtK(k=1).calculate(ctx, results)
        assert pkg.HitRateAtK(k=10).calculate(ctx, results) >= top1[tag]
    floor, band = E2E_BANDS["hit_rate_at_1"]
    assert min(top1.values()) > floor and abs(top1["torch"] - top1["jax"]) <= band, top1


# -- create_workflow and the CLI -----------------------------------------------

class SmallRecEval(trec.RecommendationEvaluation):
    """RecommendationEvaluation on the module's ``rec`` app, 2 folds."""

    def __init__(self):
        super().__init__(app_name="rec", eval_k=2)


class ScheduleGrid(tcore.EngineParamsGenerator):
    """An EngineParamsGenerator class of its own: two variants."""

    def __init__(self):
        self.engine_params_list = [tcore.EngineParams.create(
            data_source=trec.DataSourceParams(app_name="rec", eval_k=2),
            algorithms=[("als", trec.ALSAlgorithmParams(rank=4, num_iterations=it))])
            for it in (1, 3)]


@pytest.mark.parametrize("argv,fast,algo", [
    ([], True, 4), (["--no-fast-eval"], False, None),
    ([f"{__name__}:ScheduleGrid"], True, 2)])
def test_cli_eval_routes_like_the_reference(stores, monkeypatch, capsys,
                                            argv, fast, algo):
    """test_workflow.py:125: ``eval`` memoizes through FastEvalEngine by
    default; ``--no-fast-eval`` takes ``Engine.batch_eval``."""
    _, ts = stores
    seen = []
    for cls in (tcore.Engine, FastEvalEngine):
        orig = cls.batch_eval

        def spy(self, *a, _orig=orig, **kw):
            out = _orig(self, *a, **kw)
            seen.append((type(self), getattr(self, "last_cache_stats", None)))
            return out

        monkeypatch.setattr(cls, "batch_eval", spy)
    monkeypatch.setattr(cli, "get_storage", lambda: ts)
    path = f"{__name__}:SmallRecEval"
    positional = [a for a in argv if not a.startswith("--")]
    flags = [a for a in argv if a.startswith("--")]
    assert cli.main(["eval", path, *positional, "--device", "cpu", *flags]) == 0
    out = capsys.readouterr().out
    iid = out.split("Instance ID: ")[1].split()[0]
    inst = ts.get_meta_data_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED" and inst.evaluation_class == path
    assert inst.engine_params_generator_class == "".join(positional)
    assert inst.evaluator_results in out and "Precision@K" in inst.evaluator_results
    res = json.loads(inst.evaluator_results_json)
    n = algo or 4
    assert len(res["results"]) == n and res["otherMetricHeaders"] == [
        "PositiveCount (threshold=2.0)"]
    best = max(range(n), key=lambda j: (res["results"][j]["score"], -j))
    assert res["bestIdx"] == best
    if fast:
        assert seen == [(FastEvalEngine, {"ds": 1, "prep": 1, "algo": algo})]
    else:
        assert seen == [(tcore.Engine, None)]


def test_create_workflow_refuses_what_is_not_an_evaluation(stores):
    with pytest.raises(TypeError, match="is not an Evaluation"):
        create_workflow(WorkflowConfig(evaluation_class=f"{__name__}:ScheduleGrid",
                                       device="cpu"))
    with pytest.raises(ValueError, match="requires an EngineParamsGenerator"):
        create_workflow(WorkflowConfig(
            evaluation_class=f"{__name__}:PlainEvaluation", device="cpu"))


class PlainEvaluation(tcore.Evaluation):
    """An Evaluation without a generator mixed in."""
