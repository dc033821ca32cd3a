"""PyTorch port, the ``eventlog`` storage backend and ``resolve_feed_path``,
held against the JAX package on the CPU.

- The port's counterparts of tests/test_native_eventlog.py (:45, :53,
  :165, :183, :192, :207, :232, :247, :259, :277, :295, :376, :408, :436,
  :472), on the port's backend, which always takes the reference's
  pure-Python path.
- The same events with the same ids, written by both backends, give
  byte-identical log files.
- A log the JAX backend wrote reads the same through the port's backend
  (``find``, ``find_by_entities``, ``assemble_triples``,
  ``aggregate_properties``) as through the JAX backend's own.
- ``resolve_feed_path`` finds the file behind an app and refuses a store
  whose EVENTDATA is not the eventlog backend.
"""

import datetime as dt
import random

import numpy as np
import pytest

pytest.importorskip("torch")

from incubator_predictionio_tpu.data import DataMap as JDataMap  # noqa: E402
from incubator_predictionio_tpu.data import Event as JEvent  # noqa: E402
from incubator_predictionio_tpu.data.storage.eventlog_backend import (  # noqa: E402
    EventLogEvents as JEventLogEvents,
)
from incubator_predictionio_tpu.native import format as jfmt  # noqa: E402
from incubator_predictionio_tpu_torch.data.aggregator import (  # noqa: E402
    aggregate_properties,
)
from incubator_predictionio_tpu_torch.data.event import DataMap, Event  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage.base import (  # noqa: E402
    App,
    Channel,
    StorageError,
)
from incubator_predictionio_tpu_torch.data.storage.eventlog_backend import (  # noqa: E402
    EventLogEvents,
    _Log,
)
from incubator_predictionio_tpu_torch.native import format as fmt  # noqa: E402
from incubator_predictionio_tpu_torch.streaming.feed import (  # noqa: E402
    resolve_feed_path,
)

UTC = dt.timezone.utc
APP = 1


def t(n):
    return dt.datetime(2021, 6, 1, 0, 0, 0, tzinfo=UTC) + dt.timedelta(seconds=n)


def _pair(**kw):
    """The same event in both packages, creation time fixed so the records
    encode alike."""
    kw.setdefault("creation_time", t(10_000))
    props = kw.pop("properties", {})
    return (Event(properties=DataMap(props), **kw),
            JEvent(properties=JDataMap(props), **kw))


def _ev(**kw):
    return _pair(**kw)[0]


@pytest.fixture()
def store(tmp_path):
    s = EventLogEvents(str(tmp_path))
    s.init(APP)
    yield s
    s.close()


# -- the codec (test_native_eventlog.py:45, :53) -------------------------------

@pytest.mark.parametrize("value", [
    None, True, False, 0, -1, 2**62, -(2**63), 2**63 - 1,
    2**80, -(2**90),              # bigint path
    3.5, -0.0, 1e300,
    "", "héllo", "x" * 10_000,
    [], [1, "a", None, [2.5, True]],
    {}, {"a": 1, "b": {"c": [1, 2, {"d": None}]}},
])
def test_tlv_round_trip(value):
    buf = bytearray()
    fmt.encode_tlv(value, buf)
    want = bytearray()
    jfmt.encode_tlv(value, want)
    assert buf == want  # the reference's bytes
    got, pos = fmt.decode_tlv(bytes(buf))
    assert pos == len(buf)
    assert got == value and type(got) is type(value) or got == value


def test_event_round_trip_preserves_everything():
    tz = dt.timezone(dt.timedelta(hours=5, minutes=30))
    e, je = _pair(
        event="$set", entity_type="user", entity_id="ü-1",
        target_entity_type="item", target_entity_id="i/9",
        properties={"a": [1, 2.5, "x"], "big": 2**70},
        event_time=dt.datetime(2021, 1, 2, 3, 4, 5, 678901, tzinfo=tz),
        tags=("t1", "t2"), pr_id="pr9",
        creation_time=dt.datetime(2021, 1, 2, 3, 4, 6, tzinfo=UTC))
    blob = fmt.encode_event(e, "custom-id-1", fmt.Interner())
    assert blob == jfmt.encode_event(je, "custom-id-1", jfmt.Interner())
    buf = fmt.MAGIC + blob
    strings, offsets, dead = fmt.read_log(buf)
    assert list(offsets) == ["custom-id-1"] and not dead
    assert (strings, offsets, dead) == jfmt.read_log(buf)
    recs = {o: p for o, k, p in fmt.iter_records(buf) if k == fmt.KIND_EVENT}
    eid, got = fmt.decode_event_payload(recs[offsets["custom-id-1"]], strings)
    assert eid == "custom-id-1"
    assert got.event == e.event and got.properties == e.properties
    assert got.event_time == e.event_time
    assert got.event_time.utcoffset() == e.event_time.utcoffset()
    assert got.tags == e.tags and got.pr_id == e.pr_id
    assert got.target_entity_type == "item" and got.target_entity_id == "i/9"
    assert fmt.time_to_us(e.event_time) == jfmt.time_to_us(je.event_time)


# -- the fold (:165, :183) ------------------------------------------------------

def _random_stream(rng, n=300):
    """test_native_eventlog.py:81's stream, as (port, JAX) event pairs."""
    names = ["$set", "$unset", "$delete", "rate", "buy"]
    out = []
    for _ in range(n):
        name = rng.choice(names)
        props = {}
        if name in ("$set", "$unset"):
            props = {rng.choice("abcde"): rng.choice([1, 2.5, "v", None, [1, 2], {"x": 1}])
                     for _ in range(rng.randint(0, 3))}
        has_target = rng.random() < 0.5 and name not in ("$set", "$unset", "$delete")
        out.append(_pair(
            event=name, entity_type=rng.choice(["user", "item"]),
            entity_id=f"e{rng.randint(0, 20)}",
            target_entity_type="item" if has_target else None,
            target_entity_id=f"i{rng.randint(0, 5)}" if has_target else None,
            properties=props, event_time=t(rng.randint(0, 100))))
    return out


def test_fold_matches_reference_aggregator(store):
    evs = [e for e, _ in _random_stream(random.Random(99), 400)]
    store.insert_batch(evs, APP)
    for etype in ("user", "item"):
        expected = aggregate_properties(
            e for e in evs
            if e.entity_type == etype and e.event in ("$set", "$unset", "$delete"))
        got = store.aggregate_properties(APP, etype)
        assert set(got) == set(expected)
        for k in got:
            assert got[k].to_dict() == expected[k].to_dict(), k
            assert got[k].first_updated == expected[k].first_updated
            assert got[k].last_updated == expected[k].last_updated


def test_time_range_filter_with_fold(store):
    store.insert(_ev(event="$set", entity_type="user", entity_id="u",
                     properties={"a": 1}, event_time=t(1)), APP)
    store.insert(_ev(event="$set", entity_type="user", entity_id="u",
                     properties={"a": 2}, event_time=t(5)), APP)
    assert store.aggregate_properties(APP, "user", until_time=t(3))["u"].to_dict() == {"a": 1}
    assert store.aggregate_properties(APP, "user", required=["b"]) == {}


# -- durability (:192, :207, :232, :247, :259, :277, :295) ----------------------

def test_torn_tail_is_ignored(store, tmp_path):
    ids = store.insert_batch(
        [_ev(event="rate", entity_type="user", entity_id=f"u{i}", event_time=t(i))
         for i in range(5)], APP)
    assert len(ids) == 5
    with open(store.log_path(APP), "ab") as f:
        f.write(b"\xff\x00\x00\x00\x02partial")  # a header promising more
    store.close()
    reopened = EventLogEvents(str(tmp_path))
    assert len(list(reopened.find(APP))) == 5
    reopened.close()


def test_persistence_across_reopen(store, tmp_path):
    store.insert(_ev(event="$set", entity_type="user", entity_id="u1",
                     properties={"a": 1}, event_time=t(0)), APP)
    eid = store.insert(_ev(event="rate", entity_type="user", entity_id="u2",
                           event_time=t(1)), APP)
    assert store.get(eid, APP).entity_id == "u2"
    assert store.delete(eid, APP) and not store.delete(eid, APP)
    store.close()
    s2 = EventLogEvents(str(tmp_path))
    assert [e.entity_id for e in s2.find(APP)] == ["u1"]
    assert s2.get(eid, APP) is None
    assert s2.aggregate_properties(APP, "user")["u1"].to_dict() == {"a": 1}
    s2.close()


def test_delete_then_reinsert_same_id(store, tmp_path):
    e = _ev(event="rate", entity_type="user", entity_id="u1",
            event_time=t(0), event_id="fixed-id")
    store.insert(e, APP)
    store.delete("fixed-id", APP)
    store.insert(e, APP)
    assert [x.event_id for x in store.find(APP)] == ["fixed-id"]
    store.close()
    reopened = EventLogEvents(str(tmp_path))
    assert reopened.get("fixed-id", APP) is not None
    assert [x.event_id for x in reopened.find(APP)] == ["fixed-id"]
    reopened.close()


def test_duplicate_id_latest_wins(store):
    store.insert(_ev(event="rate", entity_type="user", entity_id="old",
                     event_time=t(0), event_id="dup"), APP)
    store.insert(_ev(event="rate", entity_type="user", entity_id="new",
                     event_time=t(1), event_id="dup"), APP)
    assert [e.entity_id for e in store.find(APP)] == ["new"]


def test_zeroed_tail_is_ignored(store, tmp_path):
    store.insert(_ev(event="rate", entity_type="user", entity_id="u1",
                     event_time=t(0)), APP)
    with open(store.log_path(APP), "ab") as f:
        f.write(b"\x00" * 8)
    assert [e.entity_id for e in store.find(APP)] == ["u1"]
    store.close()
    reopened = EventLogEvents(str(tmp_path))  # open must not crash either
    assert [e.entity_id for e in reopened.find(APP)] == ["u1"]
    reopened.close()


def test_torn_tail_truncated_so_new_appends_survive(store, tmp_path):
    store.insert(_ev(event="rate", entity_type="user", entity_id="u1",
                     event_time=t(0)), APP)
    path = store.log_path(APP)
    store.close()
    with open(path, "ab") as f:
        f.write(b"\x00" * 8)  # crash artifact
    s2 = EventLogEvents(str(tmp_path))
    s2.insert(_ev(event="rate", entity_type="user", entity_id="u2",
                  event_time=t(1)), APP)
    assert [e.entity_id for e in s2.find(APP)] == ["u1", "u2"]
    s2.close()
    s3 = EventLogEvents(str(tmp_path))
    assert [e.entity_id for e in s3.find(APP)] == ["u1", "u2"]
    s3.close()


def test_second_writer_rejected(store, tmp_path):
    store.insert(_ev(event="rate", entity_type="user", entity_id="u1",
                     event_time=t(0)), APP)
    other = EventLogEvents(str(tmp_path))
    with pytest.raises(StorageError, match="read-only"):
        other.insert(_ev(event="buy", entity_type="user", entity_id="u2",
                         event_time=t(1)), APP)
    other.close()
    store.insert(_ev(event="view", entity_type="user", entity_id="u3",
                     event_time=t(2)), APP)
    assert len(list(store.find(APP))) == 2
    with pytest.raises(NotImplementedError, match="item 7"):
        store.ingest_raw(b"{}", True, 1, (), APP)
    with pytest.raises(StorageError, match="not initialized"):
        list(store.find(APP + 1))


# -- triples (:376) and the read-only view (:408, :436, :472) -------------------

def _rating_stream(rng, n=400):
    """test_native_eventlog.py:317's stream, as (port, JAX) event pairs."""
    out = []
    for _ in range(n):
        name = rng.choice(["rate", "buy", "view", "$set"])
        props = {}
        if name == "rate":
            props["rating"] = rng.choice(
                [1.5, 4, True, False, "3.5", " 2.0 ", "oops", None, [1], 2**70,
                 "0x10", "1_000", "Infinity", "-inf", "NaN", "+2e3", "2e",
                 ".5", "5.", "١٢٣", "", "3.5 ", " 1.5"])
            if rng.random() < 0.2:
                props = {}
        has_target = name != "$set"
        out.append(_pair(
            event=name, entity_type="user", entity_id=f"u{rng.randint(0, 15)}",
            target_entity_type="item" if has_target else None,
            target_entity_id=f"i{rng.randint(0, 8)}" if has_target else None,
            properties=props, event_time=t(rng.randint(0, 50))))
    return out


def test_assemble_template_semantics(store):
    """Last-wins dedup, per-event-name defaults, missing rating → 0."""
    evs = [
        _ev(event="rate", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i1",
            properties={"rating": 2.0}, event_time=t(0)),
        _ev(event="buy", entity_type="user", entity_id="u2",
            target_entity_type="item", target_entity_id="i1", event_time=t(1)),
        _ev(event="rate", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i1",
            properties={"rating": 5.0}, event_time=t(2)),
        _ev(event="rate", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i2", event_time=t(3)),
    ]
    store.insert_batch(evs, APP)
    uv, iv, ui, ii, vals = store.assemble_triples(
        APP, entity_type="user", event_names=("rate", "buy"),
        target_entity_type="item", value_property="rating",
        default_values={"buy": 4.0}, dedup=True)
    assert uv.tolist() == ["u1", "u2"] and iv.tolist() == ["i1", "i2"]
    assert ui.tolist() == [0, 1, 0] and ii.tolist() == [0, 0, 1]
    assert vals.tolist() == [5.0, 4.0, 0.0]


def test_read_only_reader_while_writer_locked(store, tmp_path):
    store.insert_batch([e for e, _ in _rating_stream(random.Random(3), 50)], APP)
    reader = EventLogEvents(str(tmp_path))
    try:
        n0 = len(list(reader.find(APP)))
        assert n0 == len(list(store.find(APP)))
        store.insert(_ev(event="rate", entity_type="user", entity_id="uX",
                         target_entity_type="item", target_entity_id="iX",
                         properties={"rating": 3.0}, event_time=t(999)), APP)
        assert len(list(reader.find(APP))) == n0 + 1
        uv, *_ = reader.assemble_triples(
            APP, entity_type="user", event_names=("rate", "buy"),
            target_entity_type="item", value_property="rating",
            default_values={"buy": 4.0}, dedup=True)
        assert "uX" in uv.tolist()
        with pytest.raises(Exception, match="read-only"):
            reader.insert(_ev(event="rate", entity_type="user",
                              entity_id="u", event_time=t(1)), APP)
    finally:
        reader.close()


def _six(path):
    writer = _Log(path)
    cut = None
    for i in range(6):
        writer.append_event(
            _ev(event="rate", entity_type="user", entity_id=f"u{i}",
                properties={"rating": float(i)}, event_time=t(i)), f"e{i}")
        if i == 2:
            cut = writer.f.tell()
    return writer, cut


def test_read_only_reader_recovers_from_file_shrink(tmp_path):
    path = str(tmp_path / "app_1.piolog")
    writer, cut = _six(path)
    reader = _Log(path, read_only=True)
    assert set(reader.index) == {f"e{i}" for i in range(6)}
    writer.close()
    with open(path, "r+b") as f:
        f.truncate(cut)
    writer2 = _Log(path)
    writer2.append_event(
        _ev(event="rate", entity_type="user", entity_id="fresh",
            properties={"rating": 9.0}, event_time=t(100)), "fresh-1")
    writer2.close()
    reader.refresh()
    assert set(reader.index) == {"e0", "e1", "e2", "fresh-1"}
    assert reader.read_at(reader.index["fresh-1"]).entity_id == "fresh"
    reader.close()


def test_read_only_reader_recovers_from_truncate_then_regrow(tmp_path):
    path = str(tmp_path / "app_1.piolog")
    writer, cut = _six(path)
    reader = _Log(path, read_only=True)
    assert len(reader.index) == 6
    writer.close()
    with open(path, "r+b") as f:
        f.truncate(cut)
    writer2 = _Log(path)
    for i in range(10):
        writer2.append_event(
            _ev(event="rate", entity_type="user", entity_id=f"new{i}",
                properties={"rating": 1.0}, event_time=t(200 + i)), f"n{i}")
    writer2.close()
    reader.refresh()
    assert set(reader.index) == {"e0", "e1", "e2"} | {f"n{i}" for i in range(10)}
    assert reader.read_at(reader.index["n9"]).entity_id == "new9"
    reader.close()


# -- against the JAX backend ------------------------------------------------------

def _both_write(tmp_path, pairs, tombstone_every=10):
    """The same events, with the same ids, through both backends (a tenth
    tombstoned); returns (port store, JAX store)."""
    ids = [f"ev{i:05d}" for i in range(len(pairs))]
    port = EventLogEvents(str(tmp_path / "port"))
    jax_ = JEventLogEvents(str(tmp_path / "jax"))
    for s in (port, jax_):
        s.init(APP)
    port.insert_batch([e.with_id(i) for (e, _), i in zip(pairs, ids)], APP)
    jax_.insert_batch([j.with_id(i) for (_, j), i in zip(pairs, ids)], APP)
    for i in ids[::tombstone_every]:
        assert port.delete(i, APP) and jax_.delete(i, APP)
    return port, jax_


def test_both_backends_write_byte_identical_logs(tmp_path):
    port, jax_ = _both_write(tmp_path, _random_stream(random.Random(7))
                             + _rating_stream(random.Random(8), 200))
    with open(port.log_path(APP), "rb") as a, open(jax_.log_path(APP), "rb") as b:
        got, want = a.read(), b.read()
    assert len(got) > 10_000 and got == want
    port.close()
    jax_.close()


def _same(port_events, jax_events):
    assert [e.to_json_dict() for e in port_events] == \
        [e.to_json_dict() for e in jax_events]


FILTERS = [
    {},
    {"start_time": t(20), "until_time": t(60)},
    {"entity_type": "user"},
    {"entity_type": "user", "entity_id": "e3"},
    {"event_names": ["rate", "$set"]},
    {"target_entity_type": None},
    {"target_entity_type": "item", "target_entity_id": "i2"},
    {"limit": 7}, {"limit": 7, "reversed": True},
]


def test_port_reads_a_jax_log_as_the_jax_backend_does(tmp_path):
    """The JAX backend writes; the port's backend, opened on the same
    directory, answers every read as the JAX backend does."""
    _, jax_ = _both_write(tmp_path, _random_stream(random.Random(7))
                          + _rating_stream(random.Random(8), 200))
    jax_.close()
    jax_ = JEventLogEvents(str(tmp_path / "jax"))
    port = EventLogEvents(str(tmp_path / "jax"))
    for f in FILTERS:
        _same(list(port.find(APP, **f)), list(jax_.find(APP, **f)))
    ids = ["e3", "u4", "e7", "missing", "e3"]
    for kw in ({}, {"limit_per_entity": 2, "reversed": True},
               {"event_names": ["rate", "buy"], "target_entity_type": "item"}):
        got = port.find_by_entities(APP, "user", ids, **kw)
        want = jax_.find_by_entities(APP, "user", ids, **kw)
        assert list(got) == list(want)
        for k in got:
            _same(got[k], want[k])
    for dedup in (False, True):
        kw = dict(entity_type="user", event_names=("rate", "buy"),
                  target_entity_type="item", value_property="rating",
                  default_values={"buy": 4.0}, dedup=dedup)
        for a, b in zip(port.assemble_triples(APP, **kw),
                        jax_.assemble_triples(APP, **kw)):
            if a.dtype.kind == "f":
                assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
            else:
                assert a.tolist() == b.tolist()
    for etype in ("user", "item"):
        got = port.aggregate_properties(APP, etype)
        want = jax_.aggregate_properties(APP, etype)
        assert set(got) == set(want)
        for k in got:
            assert got[k].to_dict() == want[k].to_dict()
            assert (got[k].first_updated, got[k].last_updated) == \
                (want[k].first_updated, want[k].last_updated)
    port.close()
    jax_.close()


def test_jax_reads_a_port_log_as_the_port_does(tmp_path):
    port, _ = _both_write(tmp_path, _random_stream(random.Random(5)))
    port.close()
    port = EventLogEvents(str(tmp_path / "port"))
    jax_ = JEventLogEvents(str(tmp_path / "port"))
    for f in FILTERS:
        _same(list(port.find(APP, **f)), list(jax_.find(APP, **f)))
    port.close()
    jax_.close()


# -- resolve_feed_path ---------------------------------------------------------

def _env(tmp_path, eventdata):
    env = {"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
           "PIO_STORAGE_SOURCES_LOG_TYPE": "eventlog",
           "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "logs")}
    for repo, src in (("METADATA", "DB"), ("EVENTDATA", eventdata),
                      ("MODELDATA", "DB")):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = f"pio_{repo.lower()}"
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = src
    return Storage(env)


def test_resolve_feed_path(tmp_path):
    storage = _env(tmp_path, "LOG")
    app_id = storage.get_meta_data_apps().insert(App(0, "shop"))
    ch = storage.get_meta_data_channels().insert(Channel(0, "live", app_id))
    events = storage.get_events()
    assert isinstance(events, EventLogEvents)
    path = resolve_feed_path(storage, "shop")
    assert path == events.log_path(app_id) == str(tmp_path / "logs" / f"app_{app_id}.piolog")
    assert resolve_feed_path(storage, "shop", "live") == events.log_path(app_id, ch)
    # the feed reads what the store writes
    events.insert(_ev(event="rate", entity_type="user", entity_id="u1",
                      target_entity_type="item", target_entity_id="i1",
                      event_time=t(0)), app_id)
    with open(path, "rb") as f:
        assert [k for _, k, _ in fmt.iter_records(f.read())][-1] == fmt.KIND_EVENT
    with pytest.raises(ValueError, match="not found"):
        resolve_feed_path(storage, "nope")
    with pytest.raises(ValueError, match="channel"):
        resolve_feed_path(storage, "shop", "nope")
    storage.close()
    with pytest.raises(ValueError, match="eventlog"):
        resolve_feed_path(_env(tmp_path, "DB"), "shop")
