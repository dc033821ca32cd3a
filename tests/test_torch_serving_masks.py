"""PyTorch port, the rule-filter helpers of the templates against the JAX
package's, on the CPU: ``sample_negatives``, the compiled filter masks
(``CategoryIndex``, ``whitelist_vec``, ``ban_rows``), the TTL +
single-flight constraint cache under a fake clock, and
``PEventStore.aggregate_properties(required=...)`` over the same stored
events.

Tolerances: every comparison is exact (bitwise arrays, equal values and
equal loader-call traces): the port keeps the reference's numpy code.
"""

import datetime as dt
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu.data import event as jevent  # noqa: E402
from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap  # noqa: E402
from incubator_predictionio_tpu.data.storage import base as jbase  # noqa: E402
from incubator_predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from incubator_predictionio_tpu.data.store import PEventStore as JPEventStore  # noqa: E402
from incubator_predictionio_tpu.models.negative_sampling import (  # noqa: E402
    sample_negatives as j_sample_negatives,
)
from incubator_predictionio_tpu.resilience.clock import FakeClock  # noqa: E402
from incubator_predictionio_tpu.serving import cache as jcache  # noqa: E402
from incubator_predictionio_tpu.serving import masks as jmasks  # noqa: E402
from incubator_predictionio_tpu_torch.data import event as tevent  # noqa: E402
from incubator_predictionio_tpu_torch.data.bimap import BiMap as TBiMap  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.data.store import PEventStore as TPEventStore  # noqa: E402
from incubator_predictionio_tpu_torch.models.negative_sampling import (  # noqa: E402
    sample_negatives as t_sample_negatives,
)
from incubator_predictionio_tpu_torch.serving import cache as tcache  # noqa: E402
from incubator_predictionio_tpu_torch.serving import masks as tmasks  # noqa: E402

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


@pytest.mark.parametrize("n_items,k,seed", [(50, 4, 0), (7, 3, 1), (1000, 1, 2)])
def test_sample_negatives_bitwise(n_items, k, seed):
    rng = np.random.default_rng(seed)
    pos_u = rng.integers(0, 30, 400).astype(np.int32)
    pos_i = rng.integers(0, n_items, 400).astype(np.int32)
    want = j_sample_negatives(pos_u, pos_i, n_items, k, np.random.default_rng(seed + 10))
    got = t_sample_negatives(pos_u, pos_i, n_items, k, np.random.default_rng(seed + 10))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _catalog(seed=3, n=60):
    rng = np.random.default_rng(seed)
    ids = [f"i{j}" for j in range(n)]
    cats = {f"i{j}": tuple(f"c{c}" for c in rng.choice(6, rng.integers(0, 3),
                                                          replace=False))
            for j in range(n)}
    return ids, cats


@pytest.mark.parametrize("query", [
    ("c1",), ("c0", "c4"), ("c9",), ("c2", "c2", "c3"), (),
])
def test_category_index_and_masks_bitwise(query):
    ids, cats = _catalog()
    jmap = JBiMap({k: i for i, k in enumerate(ids)})
    tmap = TBiMap({k: i for i, k in enumerate(ids)})
    jidx, tidx = jmasks.CategoryIndex(jmap, cats), tmasks.CategoryIndex(tmap, cats)
    np.testing.assert_array_equal(tidx.rows_with_any(query), jidx.rows_with_any(query))
    for fn in ("allow_vec", "ban_vec"):
        a, b = getattr(tidx, fn)(query), getattr(jidx, fn)(query)
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes(), fn
    white = ["i3", "i7", "nope", "i59"]
    assert (tmasks.whitelist_vec(tmap, white).tobytes()
            == jmasks.whitelist_vec(jmap, white).tobytes())
    black = ["i1", "missing", "i2", "i1"]
    mj, mt = np.zeros(len(ids), np.float32), np.zeros(len(ids), np.float32)
    jmasks.ban_rows(mj, jmap, black)
    tmasks.ban_rows(mt, tmap, black)
    assert mt.tobytes() == mj.tobytes()


def test_has_category_index_memoizes():
    ids, cats = _catalog()

    class M(tmasks.HasCategoryIndex):
        item_map = TBiMap({k: i for i, k in enumerate(ids)})
        categories = cats

    m = M()
    assert m.category_index() is m.category_index()


def _script(cache_mod, clock):
    """One scripted run of a TTL cache: the loader-call trace and every
    returned value, for both packages to replay."""
    trace = []
    state = {"n": 0}

    def loader():
        state["n"] += 1
        trace.append(("load", clock.monotonic()))
        return f"v{state['n']}"

    def failing():
        trace.append(("fail", clock.monotonic()))
        raise RuntimeError("backend down")

    c = cache_mod.TTLCache(2.0, clock=clock)
    out = [c.get("k", loader), c.get("k", loader)]
    clock.advance(1.5)
    out.append(c.get("k", loader))          # still fresh
    clock.advance(1.0)
    out.append(c.get("k", loader))          # expired → reload
    clock.advance(3.0)
    with pytest.raises(RuntimeError):
        c.get("k", failing)                 # failed load caches nothing
    out.append(c.get("k", loader))          # next caller leads again
    c.invalidate("k")
    out.append(c.get("k", loader))
    out.append(c.get("other", loader))
    c.invalidate()
    out.append(c.get("other", loader))
    zero = cache_mod.TTLCache(0.0, clock=clock)
    out += [zero.get("k", loader), zero.get("k", loader)]  # read per query
    return out, trace


def test_ttl_cache_matches_reference_under_fake_clock():
    got = _script(tcache, FakeClock(100.0))
    want = _script(jcache, FakeClock(100.0))
    assert got == want


def test_ttl_cache_single_flight_and_stale_while_revalidate():
    """A cold key: followers wait for the leader's one read. An expired
    key: followers are served the stale value while the refresh is in
    flight. The reference does the same (tests/test_batched_serving.py)."""
    for mod in (tcache, jcache):
        clock = FakeClock()
        c = mod.TTLCache(1.0, clock=clock)
        entered, release, calls = threading.Event(), threading.Event(), []

        def slow(tag):
            def load():
                calls.append(tag)
                entered.set()
                release.wait(5)
                return tag
            return load

        got = {}
        lead = threading.Thread(target=lambda: got.setdefault("lead", c.get("k", slow("a"))))
        lead.start()
        assert entered.wait(5)
        follow = threading.Thread(target=lambda: got.setdefault("follow", c.get("k", slow("b"))))
        follow.start()
        release.set()
        lead.join(5)
        follow.join(5)
        assert calls == ["a"] and got == {"lead": "a", "follow": "a"}, mod
        clock.advance(2.0)
        entered.clear()
        release.clear()
        lead = threading.Thread(target=lambda: got.__setitem__("lead2", c.get("k", slow("c"))))
        lead.start()
        assert entered.wait(5)
        assert c.get("k", slow("d")) == "a"  # stale while the refresh runs
        release.set()
        lead.join(5)
        assert got["lead2"] == "c" and c.get("k", slow("e")) == "c"
        assert calls == ["a", "c"], mod


def test_constraint_ttl_env(monkeypatch):
    for raw, want in ((None, 1.0), ("0", 0.0), ("250", 0.25), ("-5", 0.0), ("x", 1.0)):
        if raw is None:
            monkeypatch.delenv("PIO_SERVING_CONSTRAINT_TTL_MS", raising=False)
        else:
            monkeypatch.setenv("PIO_SERVING_CONSTRAINT_TTL_MS", raw)
        assert tcache.constraint_ttl_sec() == jcache.constraint_ttl_sec() == want


def _prop_events():
    out = []
    rng = np.random.default_rng(4)
    for j in range(40):
        props = {"attr0": float(rng.integers(0, 5)), "plan": int(rng.integers(0, 3))}
        if j % 5 == 0:
            props.pop("plan")
        out.append({"event": "$set", "entityType": "user", "entityId": f"u{j % 25}",
                    "properties": props,
                    "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()})
    out.append({"event": "$unset", "entityType": "user", "entityId": "u3",
                "properties": {"attr0": None},
                "eventTime": (T0 + dt.timedelta(seconds=100)).isoformat()})
    out.append({"event": "$delete", "entityType": "user", "entityId": "u4",
                "eventTime": (T0 + dt.timedelta(seconds=101)).isoformat()})
    out.append({"event": "$set", "entityType": "item", "entityId": "i0",
                "properties": {"categories": ["a"]},
                "eventTime": (T0 + dt.timedelta(seconds=102)).isoformat()})
    out.append({"event": "view", "entityType": "user", "entityId": "u1",
                "targetEntityType": "item", "targetEntityId": "i0",
                "eventTime": (T0 + dt.timedelta(seconds=103)).isoformat()})
    return out


def _fill(reg, base, event_mod, path, dicts):
    storage = reg.Storage({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                           "PIO_STORAGE_SOURCES_DB_PATH": path})
    app_id = storage.get_meta_data_apps().insert(base.App(0, "props"))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([event_mod.Event.from_json_dict(d) for d in dicts], app_id)
    return storage


@pytest.mark.parametrize("required", [None, ["attr0"], ["attr0", "plan"], ["nope"]])
def test_aggregate_properties_required_matches_reference(tmp_path, required):
    dicts = _prop_events()
    js = _fill(jreg, jbase, jevent, str(tmp_path / "j.db"), dicts)
    ts = _fill(treg, tbase, tevent, str(tmp_path / "t.db"), dicts)
    try:
        want = JPEventStore(js).aggregate_properties("props", "user", required=required)
        got = TPEventStore(ts).aggregate_properties("props", "user", required=required)
        assert list(got) == list(want)
        for k in want:
            assert dict(got[k]) == dict(want[k]), k
        # one entity shard's snapshots, and the shard iterators
        # (tests/test_torch_distributed_train.py holds them on both backends)
        for s in range(2):
            want = JPEventStore(js).aggregate_properties(
                "props", "user", required=required, n_shards=2, shard_index=s)
            got = TPEventStore(ts).aggregate_properties(
                "props", "user", required=required, n_shards=2, shard_index=s)
            assert list(got) == list(want)
            assert all(dict(got[k]) == dict(want[k]) for k in want)
        shards = TPEventStore(ts).find_sharded("props", 2)
        assert sum(len(list(it)) for it in shards) == len(list(
            TPEventStore(ts).find("props")))
    finally:
        js.close()
        ts.close()
