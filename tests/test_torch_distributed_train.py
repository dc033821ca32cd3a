"""PyTorch port, multi-process training of the recommendation template on
the CPU: ``data/sharded.py``, the sharded store reads, ``_read_sharded``,
``TwoTowerMF._stage_local``, the data-parallel fit over a 2-process gloo
group, the launcher and the CLI ``launch`` verb — against the JAX
package's functions on the same inputs.

The single-process pieces run the reference's functions with a stub
context whose ``allgather_obj`` returns what every shard gives (the
reference's functions read nothing else of a context). The multi-process
pieces run real processes through ``parallel/launcher.py:launch_local``,
each with its own deadline and a ``free_port()``.

Tolerances, with their reasons:
- ``data/sharded.py``, the shard reads, ``_read_sharded`` and
  ``_stage_local``: bitwise (the same numpy and Python code on the same
  rows).
- the 2-process fit against the JAX ``_train_epochs`` run single-process
  on the concatenated global batches from the reference's initial tables:
  tests/test_torch_two_tower_training.py's 3-epoch bands (the last
  epoch's loss 1e-4 relative, each table 1e-2 relative Frobenius; adam
  turns a flipped sign of a near-zero gradient into a step of about ±lr,
  so elementwise bands would be loose).
- the replicas, and the port's own single-process loop over the same
  global batches: bitwise (the same ops on the same rows in the same
  order on the CPU; adam's square root is numpy's there, the same every
  run, see ``utils/optim.py:_sqrt_``).
"""

import datetime as dt
import json
import os
import re
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.data import event as jevent  # noqa: E402
from incubator_predictionio_tpu.data import sharded as jsh  # noqa: E402
from incubator_predictionio_tpu.data.storage import base as jbase  # noqa: E402
from incubator_predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from incubator_predictionio_tpu.models import two_tower as jtt  # noqa: E402
from incubator_predictionio_tpu.templates import recommendation as jrec  # noqa: E402
from incubator_predictionio_tpu.utils import optim as joptim  # noqa: E402
from incubator_predictionio_tpu_torch.data import event as tevent  # noqa: E402
from incubator_predictionio_tpu_torch.data import sharded as tsh  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.distributed.context import (  # noqa: E402
    maybe_wrap_distributed,
)
from incubator_predictionio_tpu_torch.models import two_tower as ttt  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import launcher  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    ServerConfig,
    load_deployed_engine,
)
from incubator_predictionio_tpu_torch.templates import recommendation as trec  # noqa: E402
from incubator_predictionio_tpu_torch.tools import cli  # noqa: E402
from incubator_predictionio_tpu_torch.utils import optim as toptim  # noqa: E402

from tests.test_torch_two_tower_training import _jax_fit  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = DeviceContext.create(device="cpu")
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
LOSS_RTOL, TABLE_RTOL = 1e-4, 1e-2
LAUNCH_TIMEOUT = 120.0


class ShardStub:
    """Process ``index`` of ``len(parts)`` for the single-process tests:
    each ``allgather_obj`` returns the next entry of ``script`` (every
    shard's object for that call, in process order) after checking that
    this process passed its own. ``put_local_batches`` hands the staged
    numpy arrays back (the reference's ``_stage_local`` calls it)."""

    def __init__(self, index, script):
        self.process_index = self.data_index = index
        self.process_count = self.data_size = len(script[0])
        self._script = list(script)

    def allgather_obj(self, obj, axis=None):
        parts = self._script.pop(0)
        assert repr(parts[self.process_index]) == repr(obj)
        return list(parts)

    def pad_to_batch_multiple(self, n):
        k = self.process_count
        return ((n + k - 1) // k) * k

    def put_local_batches(self, a):
        return a


class MirrorContext(DeviceContext):
    """Process 0 of ``process_count`` on the CPU whose peers hold the same
    rows as it: every collective sees that many copies of this process's
    object — a stub group for single-process tests of the data-parallel
    fit (the data axis is every process; any other axis is one)."""

    def allgather_obj(self, obj, axis=None):
        return [obj] * self._line(axis)[1]

    def all_gather(self, t, axis=None):
        return torch.stack([t] * self._line(axis)[1])

    def all_reduce_sum(self, t, axis=None):
        return t * self._line(axis)[1]


def mirror(count=2):
    return MirrorContext(torch.device("cpu"), 0, count, "gloo")


def _bitwise(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


# -- (1) data/sharded.py ------------------------------------------------------

VOCABS = [["u3", "u1"], [], ["u7", "u2", "u9"]]


@pytest.mark.parametrize("index", range(3))
def test_concat_vocab_is_the_references(index):
    got = tsh.concat_vocab(ShardStub(index, [VOCABS]), VOCABS[index])
    want = jsh.concat_vocab(ShardStub(index, [VOCABS]), VOCABS[index])
    _bitwise(got[0], want[0])
    assert got[1] == want[1] == sum(len(v) for v in VOCABS[:index])


def test_concat_vocab_refuses_overlapping_shards_like_the_reference():
    parts = [["a", "b"], ["c"], ["b", "d"]]
    with pytest.raises(ValueError) as want:
        jsh.concat_vocab(ShardStub(0, [parts]), parts[0])
    with pytest.raises(ValueError) as got:
        tsh.concat_vocab(ShardStub(0, [parts]), parts[0])
    assert str(got.value) == str(want.value)
    assert "appears in shards 0 and 2" in str(got.value)


@pytest.mark.parametrize("index", range(3))
def test_union_vocab_is_the_references(index):
    parts = [["i3", "i1"], ["i1", "i2", "i3"], ["i4", "i2"]]
    got = tsh.union_vocab(ShardStub(index, [parts]), parts[index])
    want = jsh.union_vocab(ShardStub(index, [parts]), parts[index])
    for a, b in zip(got, want):
        _bitwise(a, b)
    assert list(got[0]) == ["i3", "i1", "i2", "i4"]  # first seen, process order


@pytest.mark.parametrize("case", ["scalars", "arrays", "tuples", "lists"])
def test_global_sum_is_the_references(case):
    rng = np.random.default_rng(5)
    make = {
        "scalars": lambda p: float(rng.random()) + p,
        "arrays": lambda p: rng.random((3, 4)).astype(np.float32),
        "tuples": lambda p: (int(rng.integers(0, 9)),
                             (rng.random(5), np.float64(rng.random()))),
        "lists": lambda p: [rng.random(2), int(p)],
    }[case]
    parts = [make(p) for p in range(3)]
    got = tsh.global_sum(ShardStub(1, [parts]), parts[1])
    want = jsh.global_sum(ShardStub(1, [parts]), parts[1])
    flat_g, flat_w = _leaves(got), _leaves(want)
    assert type(got) is type(want) and len(flat_g) == len(flat_w)
    for a, b in zip(flat_g, flat_w):
        _bitwise(a, b)
    assert tsh.global_row_count(ShardStub(0, [[3, 0, 5]]), 3) == 8


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def test_union_label_set_is_the_references():
    parts = [[3.0, 1.0, 3.0], [], [2.0, 1.0]]
    got = tsh.union_label_set(ShardStub(2, [[sorted(set(p)) for p in parts]]),
                              parts[2])
    want = jsh.union_label_set(ShardStub(2, [[sorted(set(p)) for p in parts]]),
                               parts[2])
    assert got == want == [1.0, 2.0, 3.0]


# -- (2) sharded reads of the stores ------------------------------------------

def _event_dicts(n=300, seed=4):
    """rate events over 30 users and 20 items, re-rated pairs, buys without
    a rating, a rate without a target and ``$set`` events."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        u, i = int(rng.integers(0, 30)), int(rng.integers(0, 20))
        out.append({"event": "rate", "entityType": "user", "entityId": f"u{u}",
                    "targetEntityType": "item", "targetEntityId": f"i{i}",
                    "properties": {"rating": float(rng.integers(1, 6))},
                    "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()})
    for j in range(10):
        d = dict(out[j * 5])
        d["properties"] = {"rating": 5.0}
        d["eventTime"] = (T0 + dt.timedelta(seconds=n + j)).isoformat()
        out.append(d)
    for j in range(8):
        out.append({"event": "buy", "entityType": "user", "entityId": f"u{j * 3}",
                    "targetEntityType": "item", "targetEntityId": f"i{j + 20}",
                    "eventTime": (T0 + dt.timedelta(seconds=n + 20 + j)).isoformat()})
        out.append({"event": "$set", "entityType": "user", "entityId": f"u{j}",
                    "properties": {"age": j},
                    "eventTime": (T0 + dt.timedelta(seconds=n + 40 + j)).isoformat()})
    out.append({"event": "rate", "entityType": "user", "entityId": "u2",
                "properties": {"rating": 3.0},
                "eventTime": (T0 + dt.timedelta(seconds=n + 60)).isoformat()})
    return out


def _fill(reg, base, event_mod, config, dicts):
    storage = reg.Storage(config)
    events = storage.get_events()
    if config.get("PIO_STORAGE_SOURCES_DB_TYPE") == "sqlite":
        app_id = storage.get_meta_data_apps().insert(base.App(0, "rec"))
    else:
        app_id = 1
    events.init(app_id)
    events.insert_batch([event_mod.Event.from_json_dict(d) for d in dicts], app_id)
    return storage, app_id


def _configs(tmp_path, tag):
    return {"sqlite": {"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                       "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / f"{tag}.db")},
            "memory": {"PIO_STORAGE_SOURCES_DB_TYPE": "memory"}}


READ = dict(entity_type="user", event_names=("rate", "buy"),
            target_entity_type="item", value_property="rating",
            default_values={"buy": 4.0}, dedup=True)


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("backend", ["sqlite", "memory"])
def test_shard_reads_are_the_references(tmp_path, backend, n_shards):
    dicts = _event_dicts()
    js, japp = _fill(jreg, jbase, jevent, _configs(tmp_path, "j")[backend], dicts)
    ts, tapp = _fill(treg, tbase, tevent, _configs(tmp_path, "t")[backend], dicts)
    try:
        jev, tev = js.get_events(), ts.get_events()
        seen_rows, seen_users = 0, set()
        whole = tev.assemble_triples(tapp, **READ)
        for s in range(n_shards):
            want = jev.assemble_triples(japp, n_shards=n_shards, shard_index=s, **READ)
            got = tev.assemble_triples(tapp, n_shards=n_shards, shard_index=s, **READ)
            for a, b in zip(got, want):
                _bitwise(a, b)
            assert {tbase.entity_shard(u, n_shards) for u in got[0]} <= {s}
            seen_rows += len(got[4])
            seen_users |= set(got[0])
        assert seen_rows == len(whole[4]) and seen_users == set(whole[0])
        # the shard iterators (sqlite: indexed bucket ranges) and the
        # per-shard property snapshots
        want_it = jev.find_sharded(japp, n_shards, entity_type="user")
        got_it = tev.find_sharded(tapp, n_shards, entity_type="user")
        assert len(got_it) == n_shards
        for g, w in zip(got_it, want_it):  # event ids are each store's own
            assert [_key(e) for e in g] == [_key(e) for e in w]
        for s in range(n_shards):
            want = jev.aggregate_properties(japp, "user", n_shards=n_shards,
                                            shard_index=s)
            got = tev.aggregate_properties(tapp, "user", n_shards=n_shards,
                                           shard_index=s)
            assert list(got) == list(want)
            assert all(dict(got[k]) == dict(want[k]) for k in want)
    finally:
        js.close()
        ts.close()


def _key(e):
    return (e.event, e.entity_id, e.target_entity_id, e.event_time,
            sorted(dict(e.properties).items()))


@pytest.fixture()
def sqlite_stores(tmp_path):
    dicts = _event_dicts()
    js, _ = _fill(jreg, jbase, jevent, _configs(tmp_path, "j")["sqlite"], dicts)
    ts, _ = _fill(treg, tbase, tevent, _configs(tmp_path, "t")["sqlite"], dicts)
    prev_j, prev_t = jreg.use_storage(js), treg.use_storage(ts)
    yield js, ts
    jreg.use_storage(prev_j)
    treg.use_storage(prev_t)
    js.close()
    ts.close()


def _sharded_read_script(events, n_shards):
    """What each of the ``n_shards`` processes gives the three allgathers
    of ``_read_sharded`` (user vocabulary, item vocabulary, row count)."""
    reads = [events.assemble_triples(1, n_shards=n_shards, shard_index=s,
                                     **dict(READ, default_values={"buy": 4.0}))
             for s in range(n_shards)]
    return [[list(r[0]) for r in reads], [list(r[1]) for r in reads],
            [len(r[4]) for r in reads]]


@pytest.mark.parametrize("n_shards", [2, 3])
def test_read_sharded_is_the_references(sqlite_stores, n_shards):
    js, ts = sqlite_stores
    params = dict(app_name="rec", buy_rating=4.0)
    script = _sharded_read_script(ts.get_events(), n_shards)
    whole = trec.DataSource(trec.DataSourceParams(**params)).read_training(CPU)
    users, pairs = set(), set()
    for s in range(n_shards):
        want = jrec.DataSource(jrec.DataSourceParams(**params))._read_sharded(
            ShardStub(s, script))
        got = trec.DataSource(trec.DataSourceParams(**params))._read_sharded(
            ShardStub(s, script))
        for name in ("user_idx", "item_idx", "ratings", "user_vocab", "item_vocab"):
            _bitwise(getattr(got, name), getattr(want, name), name)
        assert got.rows_are_local and got.n_rows_global == want.n_rows_global
        assert got.n_rows_global == len(whole.ratings)
        got.sanity_check()
        users |= set(got.user_vocab[got.user_idx])
        pairs |= set(zip(got.user_vocab[got.user_idx],
                         got.item_vocab[got.item_idx], got.ratings))
    assert users == set(whole.user_vocab)
    assert pairs == set(zip(whole.user_vocab[whole.user_idx],
                            whole.item_vocab[whole.item_idx], whole.ratings))


# -- (3) per-process staging --------------------------------------------------

def _sharded_triples(n_procs, n=900, n_users=60, n_items=40, seed=8,
                     empty=None):
    """Triples over global indices, split by the entity shard of each
    user's id; ``empty`` names a process whose shard is emptied."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n).astype(np.int32)
    items = rng.integers(0, n_items, n).astype(np.int32)
    ratings = (1.0 + 4.0 * rng.random(n)).astype(np.float32)
    shard = np.array([zlib.crc32(f"u{u}".encode()) % n_procs for u in users])
    if empty is not None:
        shard[shard == empty] = (empty + 1) % n_procs
    return [(users[shard == p], items[shard == p], ratings[shard == p])
            for p in range(n_procs)], (users, items, ratings)


def _stats_script(parts):
    return [[(len(r), float(np.asarray(r, np.float64).sum()))
             for _, _, r in parts]]


@pytest.mark.parametrize("n_procs,empty", [(2, None), (3, None), (2, 1)])
def test_stage_local_is_the_references(n_procs, empty):
    parts, _ = _sharded_triples(n_procs, empty=empty)
    cfg = dict(rank=4, batch_size=128, seed=5)
    script = _stats_script(parts)
    for p in range(n_procs):
        want = jtt.TwoTowerMF(jtt.TwoTowerConfig(**cfg))._stage_local(
            ShardStub(p, script), *parts[p])
        got = ttt.TwoTowerMF(ttt.TwoTowerConfig(**cfg))._stage_local(
            ShardStub(p, script), *parts[p])
        for a, b, name in zip(got[:4], want[:4], ("ub", "ib", "rb", "wb")):
            _bitwise(a, b, name)
        assert got[4] == want[4]
        assert got[0].shape[1] == -(-128 // n_procs)  # padded to the count
        assert got[3].sum() == len(parts[p][0])  # weight 1 a row, 0 a pad


# -- (4) the data-parallel fit, 2 processes over gloo --------------------------

FIT_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    from incubator_predictionio_tpu_torch import convert
    from incubator_predictionio_tpu_torch.models import two_tower as ttt
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

    work = sys.argv[1]
    data = np.load(f"{work}/inputs.npz")
    ctx = DeviceContext.create("cpu", distributed=True)
    p = ctx.process_index
    init = {"ue": data["init_ue"], "ie": data["init_ie"]}
    real = ttt._init_blocks

    def inject(cfg, ctx, nu, ni, gen):  # the whole tables: one block each
        placed = real(cfg, ctx, nu, ni, gen)
        for t, a in zip(placed, convert.two_tower_tables_from_jax(init, ctx.device)):
            t.array = a
        return placed

    ttt._init_blocks = inject
    cfg = ttt.TwoTowerConfig(rank=int(data["rank"]), epochs=int(data["epochs"]),
                             batch_size=int(data["batch"]), seed=int(data["seed"]),
                             gather="host")
    model = ttt.TwoTowerMF(cfg).fit(
        ctx, data[f"users{p}"], data[f"items{p}"], data[f"ratings{p}"],
        int(data["n_users"]), int(data["n_items"]), rows_are_local=True)
    np.savez(f"{work}/out{p}.npz", user_emb=model.user_emb,
             item_emb=model.item_emb, user_bias=model.user_bias,
             item_bias=model.item_bias, mean=model.mean, loss=model.final_loss,
             exchange=model.timings["exchange_sec"])
    ctx.stop()
""")


def test_two_process_fit_matches_jax_on_the_global_batches(tmp_path, monkeypatch):
    n_users, n_items, rank, batch, epochs, seed = 60, 40, 8, 256, 3, 5
    parts, (users, items, ratings) = _sharded_triples(2, n_users=n_users,
                                                      n_items=n_items)
    cfg = dict(rank=rank, batch_size=batch, epochs=epochs, seed=seed,
               gather="host")
    # the reference's initial tables (they depend on the seed and shapes)
    _, seen = _jax_fit(monkeypatch, dict(cfg, epochs=1), users, items, ratings,
                       n_users, n_items)
    init = seen["init"]
    # the reference's per-process staging, concatenated into global batches
    script = _stats_script(parts)
    staged = [jtt.TwoTowerMF(jtt.TwoTowerConfig(**cfg))._stage_local(
        ShardStub(p, script), *parts[p]) for p in range(2)]
    glob = [np.concatenate([s[j] for s in staged], axis=1) for j in range(4)]
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt = joptim.adam_tree_init(params, "float32")
    jp, _, jloss = jtt._train_epochs(
        params, opt, *(jnp.asarray(a) for a in glob), 3e-2, 1e-4, epochs)
    want = {k: np.asarray(v) for k, v in jp.items()}

    work = tmp_path / "fit"
    work.mkdir()
    np.savez(work / "inputs.npz", init_ue=init["ue"], init_ie=init["ie"],
             rank=rank, epochs=epochs, batch=batch, seed=seed,
             n_users=n_users, n_items=n_items,
             **{f"{k}{p}": a for p in range(2)
                for k, a in zip(("users", "items", "ratings"), parts[p])})
    script_path = tmp_path / "fit_child.py"
    script_path.write_text(FIT_CHILD)
    res = launcher.launch_local(
        [], 2, coordinator_port=launcher.free_port(), timeout=LAUNCH_TIMEOUT,
        env={"PYTHONPATH": REPO},
        command=[sys.executable, str(script_path), str(work)])
    assert res.ok, res.outputs
    outs = [np.load(work / f"out{p}.npz") for p in range(2)]
    names = ("user_emb", "item_emb", "user_bias", "item_bias")
    for name in names + ("loss", "mean"):  # the replicas, bitwise
        _bitwise(outs[0][name], outs[1][name], name)
    got = outs[0]
    assert float(got["mean"]) == staged[0][4]
    np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=LOSS_RTOL)
    k = rank
    ref = {"user_emb": want["ue"][:n_users, :k], "item_emb": want["ie"][:n_items, :k],
           "user_bias": want["ue"][:n_users, k], "item_bias": want["ie"][:n_items, k]}
    for name in names:
        rel = np.linalg.norm(got[name] - ref[name]) / np.linalg.norm(ref[name])
        assert rel <= TABLE_RTOL, (name, rel)
    assert np.abs(got["user_emb"] - init["ue"][:n_users, :k]).max() > 3e-2
    assert float(got["exchange"]) > 0
    # the port's single-process loop on the same global batches from the
    # same tables: bitwise the launched fit
    tables = [torch.from_numpy(np.array(init[t], np.float32)) for t in ("ue", "ie")]
    state = toptim.adam_tree_init(tables, "float32")
    tstaged = [ttt.TwoTowerMF(ttt.TwoTowerConfig(**cfg))._stage_local(
        ShardStub(p, script), *parts[p]) for p in range(2)]
    tglob = [torch.from_numpy(np.concatenate([s[j] for s in tstaged], axis=1))
             for j in range(4)]
    loss = ttt._train_epochs(tables, [torch.empty_like(t) for t in tables],
                             state, *tglob, 3e-2, 1e-4, epochs)
    ue, ie = (t.numpy() for t in tables)
    _bitwise(ue[:n_users, :k], got["user_emb"], "replay user_emb")
    _bitwise(ie[:n_items, k], got["item_bias"], "replay item_bias")
    np.testing.assert_allclose(float(loss), float(got["loss"]), rtol=1e-6)


def test_replicated_rows_fit_is_the_single_process_loop_on_global_batches():
    """``rows_are_local=False`` under several processes: every process
    stages the global batches and trains on its slice of each (the
    reference's global arrays sharded over the data axis); with mirrored
    peers the result is the single-process loop over those batches."""
    _, (users, items, ratings) = _sharded_triples(2)
    cfg = ttt.TwoTowerConfig(rank=4, batch_size=200, epochs=2, seed=2,
                             gather="host")
    got = ttt.TwoTowerMF(cfg).fit(mirror(), users, items, ratings, 60, 40)
    ub, ib, rb, wb, mean = ttt._stage_batches(cfg, users, items, ratings,
                                              mirror().pad_to_batch_multiple)
    half = ub.shape[1] // 2
    glob = [torch.from_numpy(np.concatenate([a[:, :half]] * 2, axis=1))
            for a in (ub, ib, rb, wb)]
    tables = list(ttt._init_tables(cfg, 60, 40, torch.device("cpu"),
                                   torch.Generator().manual_seed(2)))
    ttt._train_epochs(tables, [torch.empty_like(t) for t in tables],
                      toptim.adam_tree_init(tables, "float32"), *glob,
                      cfg.learning_rate, cfg.reg, cfg.epochs)
    _bitwise(got.user_emb, tables[0][:, :4].numpy())
    _bitwise(got.item_bias, tables[1][:, 4].numpy())
    assert got.mean == mean and set(got.timings) >= {"exchange_sec"}


# -- (5) the CLI: launch -n 2 train on a sqlite app ----------------------------

def _seed_app(tmp_path):
    env = dict(os.environ)
    env.update({"PIO_FS_BASEDIR": str(tmp_path / "fs"),
                "PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
                "PIO_STORAGE_SOURCES_SQLITE_PATH": str(tmp_path / "pio.db"),
                "PYTHONPATH": REPO})
    storage = treg.Storage({"PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
                            "PIO_STORAGE_SOURCES_SQLITE_PATH": str(tmp_path / "pio.db")})
    app_id = storage.get_meta_data_apps().insert(tbase.App(0, "launchapp"))
    ev = storage.get_events()
    ev.init(app_id)
    ev.insert_batch([tevent.Event.from_json_dict({
        "event": "rate", "entityType": "user", "entityId": str(i % 12),
        "targetEntityType": "item", "targetEntityId": str(i % 9),
        "properties": {"rating": float(1 + i % 5)},
        "eventTime": (T0 + dt.timedelta(seconds=i)).isoformat()})
        for i in range(200)], app_id)
    storage.close()
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "launch-test", "version": "1",
        "engineFactory": "incubator_predictionio_tpu_torch.templates."
                         "recommendation.RecommendationEngine",
        "datasource": {"params": {"appName": "launchapp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 8, "numIterations": 2, "batchSize": 64}}]}))
    return env, variant


def test_cli_launch_two_process_train_then_deploy(tmp_path):
    """Reference tests/test_launcher.py:22-146, the sqlite case: each
    process reads a proper subset of the store, only process 0 writes the
    instance and the model, and the model answers a query."""
    env, variant = _seed_app(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
         "launch", "-n", "2", "--cpu-devices-per-process", "1",
         "--coordinator-port", str(launcher.free_port()),
         "--timeout", str(LAUNCH_TIMEOUT), "train", "-v", str(variant)],
        capture_output=True, text=True, env=env, timeout=LAUNCH_TIMEOUT + 30)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "Training completed. Engine instance ID" in out.stdout
    assert "secondary process" in out.stdout
    assert "backend gloo, device cpu" in out.stdout
    reads = re.findall(r"sharded read: (\d+) of (\d+) rows \(shard (\d+)/2\)",
                       out.stdout)
    assert sorted(s for _, _, s in reads) == ["0", "1"], out.stdout
    total = {int(t) for _, t, _ in reads}
    assert len(total) == 1
    total = total.pop()
    locals_ = [int(n) for n, _, _ in reads]
    assert sum(locals_) == total == 36 and all(0 < n < total for n in locals_)
    digests = re.findall(r"replica digest (\w+), equal", out.stdout)
    assert len(digests) == 2 and digests[0] == digests[1]

    storage = treg.Storage({"PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
                            "PIO_STORAGE_SOURCES_SQLITE_PATH": str(tmp_path / "pio.db")})
    try:
        insts = storage.get_meta_data_engine_instances().get_all()
        assert [i.status for i in insts] == ["COMPLETED"]
        assert storage.get_model_data_models().get(insts[0].id) is not None
        deployed = load_deployed_engine(ServerConfig(engine_variant=str(variant)),
                                        storage, ctx=CPU, warmup=False)
        model = deployed.models[0]
        assert len(model.user_map) == 12 and len(model.item_map) == 9
        res = deployed.predict({"user": "3", "num": 4})
        assert len(res.item_scores) == 4
        assert all(np.isfinite(s.score) for s in res.item_scores)
    finally:
        storage.close()


def test_cli_launch_refuses_what_is_not_ported(capsys):
    """Only the three workflow verbs join a job (``eval`` and
    ``batchpredict`` under launch: tests/test_torch_distributed_eval.py and
    tests/test_torch_batch_predict.py)."""
    assert cli.main(["launch", "-n", "2", "deploy"]) == 2
    assert "only the train/eval/batchpredict" in capsys.readouterr().out
    assert cli.main(["launch", "-n", "2"]) == 2
    assert "no verb given" in capsys.readouterr().out
    with pytest.raises(ValueError, match="one device a process"):
        launcher.launch_local(["train"], 2, cpu_devices_per_process=2)


# -- (6) the launcher's deadline and a failed peer -----------------------------

def test_launch_deadline_kills_the_job_and_keeps_the_logs():
    res = launcher.launch_local(
        [], 2, timeout=3.0,
        command=[sys.executable, "-c",
                 "import os, time; print('started', os.environ["
                 "'PIO_DIST_PROCESS_ID'], flush=True); time.sleep(60)"])
    assert res.timed_out and not res.ok
    assert res.returncodes == [124, 124]
    assert [o.strip() for o in res.outputs] == ["started 0", "started 1"]


def test_a_peer_that_dies_fails_the_launch():
    """Process 1 exits before the first collective: process 0's collective
    raises instead of hanging, and the launch is not ok."""
    child = textwrap.dedent("""
        import sys
        from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
        ctx = DeviceContext.create("cpu", distributed=True)
        if ctx.process_index == 1:
            sys.exit(3)
        ctx.allgather_obj("hello")
        print("unreachable")
    """)
    res = launcher.launch_local(
        [], 2, timeout=LAUNCH_TIMEOUT, env={"PYTHONPATH": REPO},
        command=[sys.executable, "-c", child])
    assert not res.ok and not res.timed_out, res.outputs
    assert res.returncodes[1] == 3 and res.returncodes[0] != 0
    assert "unreachable" not in res.outputs[0]


# -- the context ---------------------------------------------------------------

def test_context_without_a_group_refuses_collectives():
    two = DeviceContext(torch.device("cpu"), process_index=1, process_count=2)
    assert not two.is_primary and two.pad_to_batch_multiple(7) == 8
    for call in (lambda: two.allgather_obj(1),
                 lambda: two.all_gather(torch.zeros(2)),
                 lambda: two.all_reduce_sum(torch.zeros(2))):
        with pytest.raises(RuntimeError, match="no process group was joined"):
            call()
    # one process: identities
    assert CPU.allgather_obj("x") == ["x"]
    t = torch.arange(3.0)
    assert torch.equal(CPU.all_gather(t), t[None]) and torch.equal(CPU.all_reduce_sum(t), t)
    assert CPU.pad_to_batch_multiple(7) == 7


def test_backend_rule(monkeypatch):
    assert tmesh.pick_backend("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.pick_backend("cuda", 2) == "gloo"  # two processes, one card
    assert tmesh.pick_backend("cuda", 1) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.pick_backend("cuda", 4) == "nccl"
    monkeypatch.delenv("PIO_DIST_COORDINATOR", raising=False)
    with pytest.raises(RuntimeError, match="PIO_DIST_COORDINATOR"):
        tmesh.init_distributed_from_env("cpu")


def test_maybe_wrap_distributed(monkeypatch, tmp_path):
    """Identity without ``PIO_DIST_STATE_DIR``; with it, a supervised
    member's ``DistContext`` that delegates to the context it wraps and
    announces its generation in the coordination directory."""
    from incubator_predictionio_tpu_torch.distributed.context import DistContext
    from incubator_predictionio_tpu_torch.distributed.meshdir import MeshDirectory

    monkeypatch.delenv("PIO_DIST_STATE_DIR", raising=False)
    assert maybe_wrap_distributed(CPU) is CPU
    monkeypatch.setenv("PIO_DIST_STATE_DIR", str(tmp_path))
    monkeypatch.setenv("PIO_DIST_GENERATION", "3")
    ctx = maybe_wrap_distributed(CPU)
    assert isinstance(ctx, DistContext) and ctx.dist_hooks is ctx
    assert ctx.device == CPU.device and ctx.process_count == 1 and ctx.is_primary
    assert ctx.generation == 3 and ctx.allgather_obj("x") == ["x"]
    md = MeshDirectory(str(tmp_path))
    assert md.read_generation() == (3, 1)
    assert [(m.rank, m.generation) for m in md.members()] == [(0, 3)]
    ctx.stop()
