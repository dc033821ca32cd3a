"""PyTorch port, sharding/ (sharded serving): the same numpy towers go into
the JAX package and the port, on the reference's geometry
(tests/test_sharding.py:44-58), and the port must answer as the reference
does:

- ``ShardSpec``, ``parse_bytes``, ``requires_sharding`` and
  ``check_budget``: the reference's values and error texts; a fit under
  ``PIO_SHARD_HBM_BUDGET`` raises where the reference's does;
- host-sharded exact: ids and scores bitwise the JAX package's
  host-sharded answers and (batches of more than one row) the port's
  single-host answers;
- device-sharded exact on CPU shards: bitwise the port's single-device
  bf16 path, ids equal to the JAX package's single-device exact path with
  scores within 1e-4 (exact products, sums in another order);
- per-shard IVF: partitions bitwise the reference's, two-stage answers
  bitwise the JAX package's host-mode sharded answers, the 0.95 recall
  floor, the counted fallback;
- deltas routed to the owning shard, the receiver untouched, zero
  full-table gathers on a device-sharded model;
- persistence, reporting (``shard_info``, ``format_shard_stats``,
  ``/health``), and the degradation registry.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu.models import two_tower as jtt  # noqa: E402
from incubator_predictionio_tpu.sharding import serve as jserve  # noqa: E402
from incubator_predictionio_tpu.sharding import table as jtable  # noqa: E402
from incubator_predictionio_tpu_torch.models import two_tower as ttt  # noqa: E402
from incubator_predictionio_tpu_torch.sharding import degrade  # noqa: E402
from incubator_predictionio_tpu_torch.sharding import serve as tserve  # noqa: E402
from incubator_predictionio_tpu_torch.sharding import shard_metrics as M  # noqa: E402
from incubator_predictionio_tpu_torch.sharding import table as ttable  # noqa: E402

RANK = 16
DEVICE_TOL = 1e-4
MASK_KINDS = ("none", "exclude", "row_mask", "both")


@pytest.fixture
def shard_env(monkeypatch):
    """Clean PIO_SHARD_* env; returns monkeypatch so tests set the knobs
    they pin (the reference's fixture, tests/conftest.py:51)."""
    for var in ("PIO_SHARD_SERVE", "PIO_SHARD_SERVE_SHARDS",
                "PIO_SHARD_HBM_BUDGET", "PIO_STREAM_STALE_REBUILD_FRAC"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")
    return monkeypatch


@pytest.fixture
def two_stage_env(shard_env):
    shard_env.setenv("PIO_RETRIEVAL_MODE", "two_stage")
    shard_env.setenv("PIO_RETRIEVAL_NPROBE", "16")
    shard_env.setenv("PIO_SHARD_SERVE", "1")
    shard_env.setenv("PIO_SHARD_SERVE_SHARDS", "4")
    shard_env.setenv("PIO_RETRIEVAL_QUANTIZE", "0")
    return shard_env


def _towers(seed=1, n_users=160, n_items=6000, rank=RANK, n_concepts=64,
            sigma=0.5):
    """Mixture-of-concepts towers (tests/test_sharding.py:45)."""
    rng = np.random.default_rng(seed)
    concepts = rng.standard_normal((n_concepts, rank)).astype(np.float32)
    item = concepts[rng.integers(0, n_concepts, n_items)] \
        + sigma * rng.standard_normal((n_items, rank)).astype(np.float32)
    user = concepts[rng.integers(0, n_concepts, n_users)] \
        + sigma * rng.standard_normal((n_users, rank)).astype(np.float32)
    return (user.astype(np.float32), item.astype(np.float32),
            (rng.standard_normal(n_users) * 0.1).astype(np.float32),
            (rng.standard_normal(n_items) * 0.1).astype(np.float32))


def _host(pkg, seed=1, n_users=160, n_items=6000):
    """A host model of ``pkg`` (jtt or ttt) over fresh copies of the towers."""
    user, item, ub, ib = _towers(seed, n_users, n_items)
    return pkg.TwoTowerModel(user_emb=user, item_emb=item, user_bias=ub,
                             item_bias=ib, mean=3.0,
                             config=pkg.TwoTowerConfig(rank=RANK))


def _resident(seed=1, n_users=160, n_items=6000, pad=0):
    """A port model whose fused tables are resident on the CPU device
    (``pad`` extra zero rows, as a table padded to a shard multiple)."""
    user, item, ub, ib = _towers(seed, n_users, n_items)
    m = ttt.TwoTowerModel(mean=3.0, config=ttt.TwoTowerConfig(rank=RANK))

    def fused(e, b):
        t = np.concatenate([e, b[:, None]], 1)
        return torch.from_numpy(np.pad(t, ((0, pad), (0, 0))))

    m._tables = {"ue": fused(user, ub), "ie": fused(item, ib)}
    m._n_users, m._n_items = n_users, n_items
    return m


def _masks(rng, b, n_items, kind):
    """One of the rule-mask kinds (tests/test_sharding.py:68)."""
    exclude = row_mask = None
    if kind in ("exclude", "both"):
        exclude = rng.choice(n_items, max(20, n_items // 50),
                             replace=False).astype(np.int64)
    if kind in ("row_mask", "both"):
        row_mask = np.zeros((b, n_items), np.float32)
        hits = max(50, b * n_items // 400)
        row_mask[rng.integers(0, b, hits),
                 rng.integers(0, n_items, hits)] = -np.inf
    return exclude, row_mask


def _bitwise(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(
        np.asarray(a[1], np.float32).view(np.int32),
        np.asarray(b[1], np.float32).view(np.int32))


def _recall(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)])


def _rec(m, users, num, exclude=None, row_mask=None):
    return ttt.TwoTowerMF.recommend_batch(m, users, num, exclude, row_mask)


# -- layout / budget ---------------------------------------------------------

@pytest.mark.parametrize("n_rows,width,n_shards", [
    (103, 17, 4), (10, 17, 1), (40, 17, 7), (1, 33, 8), (0, 9, 3),
    (1_000_000, 129, 8), (150_000, 33, 3), (7, 5, 8)])
def test_shard_spec_matches_reference(n_rows, width, n_shards):
    t = ttable.ShardSpec("ie", n_rows, width, n_shards)
    j = jtable.ShardSpec("ie", n_rows, width, n_shards)
    assert t.to_dict() == j.to_dict()
    assert t.train_bytes_per_shard("bfloat16") == j.train_bytes_per_shard(
        "bfloat16")
    for s in range(n_shards):
        assert t.shard_bounds(s) == j.shard_bounds(s)
    for row in range(0, n_rows, max(1, n_rows // 17)):
        assert t.owner_of(row) == j.owner_of(row)
    for bad in (lambda x: x.owner_of(n_rows), lambda x: x.shard_bounds(n_shards),
                lambda x: x.owner_of(-1)):
        with pytest.raises(ValueError) as te:
            bad(t)
        with pytest.raises(ValueError) as je:
            bad(j)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        ttable.ShardSpec("ie", 5, 3, 0)


@pytest.mark.parametrize("text", ["1024", "64KB", "1.5MiB", "2g", " 3 t ",
                                  "512b", "7kib", "lots", "", "1.5.2MB"])
def test_parse_bytes_matches_reference(text):
    try:
        want = jtable.parse_bytes(text)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            ttable.parse_bytes(text)
        assert str(te.value) == str(e)
    else:
        assert ttable.parse_bytes(text) == want


@pytest.mark.parametrize("budget", [None, "1MB", "64KB", "2GB", "0"])
@pytest.mark.parametrize("n_rows,n_shards", [(10_000, 1), (10_000, 4),
                                             (1_000, 1), (2_000, 4)])
def test_budget_matches_reference(budget, n_rows, n_shards, shard_env):
    if budget is not None:
        shard_env.setenv("PIO_SHARD_HBM_BUDGET", budget)
    assert ttable.hbm_budget() == jtable.hbm_budget()
    for moments in ("float32", "bfloat16"):
        assert ttable.requires_sharding(n_rows, RANK + 1, moments) == \
            jtable.requires_sharding(n_rows, RANK + 1, moments)
        errs = []
        for mod in (ttable, jtable):
            try:
                mod.check_budget(mod.ShardSpec("ie", n_rows, RANK + 1,
                                               n_shards), moments)
                errs.append(None)
            except mod.HBMBudgetExceeded as e:
                errs.append(str(e))
        assert errs[0] == errs[1]
    if budget == "1MB" and (n_rows, n_shards) == (10_000, 1):
        assert "'model' mesh axis" in errs[0]


def test_fit_under_budget_raises_like_reference(shard_env):
    """A fit whose one-card tables exceed PIO_SHARD_HBM_BUDGET raises
    HBMBudgetExceeded in both packages; a fit that fits records the layout
    (the reference's device-resident fit records it too)."""
    from incubator_predictionio_tpu.parallel.mesh import MeshContext
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

    rng = np.random.default_rng(0)
    n, n_users, n_items = 512, 300, 2000
    args = (rng.integers(0, n_users, n).astype(np.int32),
            rng.integers(0, n_items, n).astype(np.int32),
            (1 + 4 * rng.random(n)).astype(np.float32))
    shard_env.setenv("PIO_SHARD_HBM_BUDGET", "64KB")  # 2000×17×12 B > 64 KiB
    jcfg = jtt.TwoTowerConfig(rank=RANK, epochs=1, batch_size=256,
                              gather="device")
    tcfg = ttt.TwoTowerConfig(rank=RANK, epochs=1, batch_size=256,
                              gather="device")
    with pytest.raises(jtable.HBMBudgetExceeded) as je:
        jtt.TwoTowerMF(jcfg).fit(MeshContext.create(axes={"data": 8}), *args,
                                 n_users=n_users, n_items=n_items)
    with pytest.raises(ttable.HBMBudgetExceeded) as te:
        ttt.TwoTowerMF(tcfg).fit(DeviceContext.create("cpu"), *args,
                                 n_users=n_users, n_items=n_items)
    assert str(te.value) == str(je.value)
    shard_env.setenv("PIO_SHARD_HBM_BUDGET", "1MB")
    m = ttt.TwoTowerMF(tcfg).fit(DeviceContext.create("cpu"), *args,
                                 n_users=n_users, n_items=n_items)
    assert m.device_resident
    assert {k: v.to_dict() for k, v in m._shard_spec.items()} == {
        k: jtable.ShardSpec(k, n, RANK + 1, 1).to_dict()
        for k, n in (("ue", n_users), ("ie", n_items))}
    info = m.shard_info()
    assert not info["sharded"] and info["hbm_budget"] == 1 << 20


def test_sharded_table_waits_for_model_axis_training():
    """Model-axis training is ported (tests/test_torch_model_axis.py):
    init_train builds the block of the process's model coordinate."""
    assert ttable.array_model_shards(torch.zeros(4, 3)) == 1
    assert ttable.array_model_shards([torch.zeros(2, 3)] * 3) == 3
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

    ctx = DeviceContext(torch.device("cpu"), 1, 2, axes={"model": 2})
    t = ttable.ShardedTable.init_train(ctx, "ue", 10, RANK,
                                       torch.Generator().manual_seed(0), 0.25)
    assert (t.shard, t.axis, tuple(t.array.shape)) == (1, "model", (5, RANK + 1))
    assert ttable.array_model_shards(t) == 2


# -- host-sharded exact ------------------------------------------------------

@pytest.mark.parametrize("kind", MASK_KINDS)
def test_host_sharded_exact_bitwise(kind, shard_env):
    """5 uneven host shards: ids and scores bitwise the JAX package's
    host-sharded answers (batches of 1 and 13) and the port's single-host
    answers (13 rows, the reference's case: a one-row numpy product is a
    matrix-vector product, whose sums follow the width, here and in the
    JAX package alike)."""
    single = _host(ttt)
    single.prepare_for_serving(device="cpu")
    assert single._host_items is not None
    shard_env.setenv("PIO_SHARD_SERVE", "1")
    shard_env.setenv("PIO_SHARD_SERVE_SHARDS", "5")
    t, j = _host(ttt), _host(jtt)
    t.prepare_for_serving(device="cpu")
    j.prepare_for_serving()
    assert t.serving_info()["path"] == "sharded-host-numpy"
    assert j.serving_info()["path"] == "sharded-host-numpy"
    rng = np.random.default_rng(5)
    for b in (1, 13):
        users = rng.integers(0, 160, b).astype(np.int32)
        exclude, row_mask = _masks(rng, b, 6000, kind)
        got = _rec(t, users, 10, exclude, row_mask)
        _bitwise(got, jtt.TwoTowerMF.recommend_batch(j, users, 10, exclude,
                                                     row_mask))
        if b > 1:
            _bitwise(got, _rec(single, users, 10, exclude, row_mask))


def test_host_sharded_num_edge_cases(shard_env):
    shard_env.setenv("PIO_SHARD_SERVE", "1")
    shard_env.setenv("PIO_SHARD_SERVE_SHARDS", "7")
    t, j = _host(ttt, n_items=40), _host(jtt, n_items=40)
    t.prepare_for_serving(device="cpu")
    j.prepare_for_serving()
    users = np.arange(3, dtype=np.int32)
    for num in (25, 100, 6, 1):  # over rows_per_shard (6) and the catalog
        got = _rec(t, users, num)
        assert got[0].shape == (3, min(num, 40)) and len(set(got[0][0])) == \
            min(num, 40)
        _bitwise(got, jtt.TwoTowerMF.recommend_batch(j, users, num))
    for num in (0, -2):
        assert _rec(t, users, num)[0].shape == (3, 0)


# -- device-sharded exact ----------------------------------------------------

@pytest.mark.parametrize("shards", ["4", "8"])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_device_sharded_exact_bitwise(kind, shards, shard_env):
    """Device shards on the CPU: bitwise the port's single-device bf16 path
    (every batch bucket from 1 up), ids equal to the JAX package's
    single-device exact path, scores within 1e-4."""
    single = _resident()
    single.prepare_for_serving(host_max_elements=0, device="cpu")
    assert single.serving_info()["path"] == "device-bf16"
    j = _host(jtt)
    j.prepare_for_serving(host_max_elements=0)
    assert j._device_items is not None
    shard_env.setenv("PIO_SHARD_SERVE", "1")
    shard_env.setenv("PIO_SHARD_SERVE_SHARDS", shards)
    m = _resident()
    m.prepare_for_serving(host_max_elements=0, device="cpu")
    info = m.serving_info()
    assert info["path"] == "sharded-device-bf16"
    assert info["sharding"]["n_shards"] == int(shards)
    assert info["sharding"]["devices"] == ["cpu"] * int(shards)
    rng = np.random.default_rng(4)
    for b in (1, 2, 9):
        users = rng.integers(0, 160, b).astype(np.int32)
        exclude, row_mask = _masks(rng, b, 6000, kind)
        for num in (7, 130):  # under and over serve_k (128)
            got = _rec(m, users, num, exclude, row_mask)
            _bitwise(got, _rec(single, users, num, exclude, row_mask))
            wi, ws = jtt.TwoTowerMF.recommend_batch(j, users, num, exclude,
                                                    row_mask)
            finite = np.isfinite(np.asarray(ws))
            np.testing.assert_array_equal(np.isfinite(got[1]), finite)
            np.testing.assert_array_equal(got[0][finite],
                                          np.asarray(wi)[finite])
            np.testing.assert_allclose(got[1][finite], np.asarray(ws)[finite],
                                       rtol=DEVICE_TOL, atol=DEVICE_TOL)


def test_device_sharded_ties_resolve_to_lowest_id(shard_env):
    """Constructed ties across shard boundaries: the merge takes the lowest
    global ids first, as a top-k over the full score row does; the padded
    rows of the last shard are never returned."""
    n_items, k = 37, 4  # 8 shards of 5 rows: the last holds 2 real, 3 padding
    rng = np.random.default_rng(3)
    items = rng.integers(-1, 2, (n_items, k)).astype(np.float32)
    items[::3] = items[0]  # a row repeated across every shard
    bias = np.zeros(n_items, np.float32)
    users = rng.integers(-2, 3, (6, k)).astype(np.float32)

    def model():
        m = ttt.TwoTowerModel(mean=0.5, config=ttt.TwoTowerConfig(rank=k))
        m._tables = {
            "ue": torch.from_numpy(np.concatenate(
                [users, np.full((6, 1), 0.25, np.float32)], 1)),
            "ie": torch.from_numpy(np.concatenate([items, bias[:, None]], 1))}
        m._n_users, m._n_items = 6, n_items
        return m

    single = model()
    single.prepare_for_serving(host_max_elements=0, device="cpu")
    shard_env.setenv("PIO_SHARD_SERVE", "1")
    shard_env.setenv("PIO_SHARD_SERVE_SHARDS", "8")
    m = model()
    m.prepare_for_serving(host_max_elements=0, device="cpu")
    assert m._sharded.spec.rows_per_shard == 5
    uid = np.arange(6, dtype=np.int32)
    scores = users @ items.T + 0.25 + 0.5
    order = np.lexsort((np.tile(np.arange(n_items), (6, 1)), -scores), axis=1)
    excl = np.asarray([0, 3, 30])
    for num in (3, 12, 37):
        got = _rec(m, uid, num)
        _bitwise(got, _rec(single, uid, num))
        np.testing.assert_array_equal(got[0], order[:, :num])
        # everything but 5 items masked: the -inf tail is the lowest ids
        rm = np.full((6, n_items), -np.inf, np.float32)
        rm[:, [2, 9, 17, 26, 35]] = 0.0
        got = _rec(m, uid, num, exclude=excl, row_mask=rm)
        _bitwise(got, _rec(single, uid, num, exclude=excl, row_mask=rm))
        assert got[0].max() < n_items


def test_serve_fewer_shards_than_table_padding(shard_env):
    """Tables padded to 8 training shards served over 4: re-padded to the
    serve layout, bitwise the single-device path on the same rows
    (tests/test_sharding.py:416)."""
    single = _resident(n_users=90, n_items=100)
    single.prepare_for_serving(host_max_elements=0, device="cpu")
    sh = tserve.ShardedServing.build_device(
        _resident(n_users=90, n_items=100, pad=4)._tables, 90, 100, RANK, 3.0,
        10, 4, device=torch.device("cpu"))
    assert sh.device.n_p == 100 and sh.device.u_p == 92
    m = _resident(n_users=90, n_items=100, pad=4)
    m._sharded, m._serve_k = sh, 10
    users = np.arange(5, dtype=np.int32)
    got = _rec(m, users, 10)
    assert got[0].shape == (5, 10) and int(got[0].max()) < 100
    _bitwise(got, _rec(single, users, 10))


def test_device_shards_need_their_cards(shard_env):
    """A device-sharded layout over more cards than exist raises; it does
    not fall back to host blocks."""
    with pytest.raises(ValueError, match="local devices exist"):
        tserve._serve_devices(2, torch.device("cuda", 0))


# -- per-shard IVF -----------------------------------------------------------

@pytest.mark.parametrize("quantize", ["0", "1"], ids=["fp32", "int8"])
def test_shard_ivf_and_two_stage_bitwise_reference(quantize, two_stage_env):
    """Per-shard partitions bitwise the reference's (same shard_build_key
    seeds), and host-mode sharded two-stage answers bitwise the JAX
    package's."""
    two_stage_env.setenv("PIO_RETRIEVAL_QUANTIZE", quantize)
    t, j = _host(ttt, n_items=20_000), _host(jtt, n_items=20_000)
    t.prepare_for_serving(device="cpu")
    j.prepare_for_serving()
    assert len(t._shard_ivf) == len(j._shard_ivf) == 4
    for s, (ti, ji) in enumerate(zip(t._shard_ivf, j._shard_ivf)):
        assert ti.key == ji.key == jserve.shard_build_key(5000, s)
        assert ti.key == tserve.shard_build_key(5000, s)
        np.testing.assert_array_equal(ti.centroids, ji.centroids)
        np.testing.assert_array_equal(ti.member_ids, ji.member_ids)
        np.testing.assert_array_equal(ti.offsets, ji.offsets)
        assert ti.device == torch.device("cpu")
    rng = np.random.default_rng(6)
    users = rng.integers(0, 160, 32).astype(np.int32)
    for kind in MASK_KINDS:
        exclude, row_mask = _masks(rng, 32, 20_000, kind)
        _bitwise(_rec(t, users, 10, exclude, row_mask),
                 jtt.TwoTowerMF.recommend_batch(j, users, 10, exclude,
                                                row_mask))


@pytest.mark.parametrize("quantize", ["0", "1"], ids=["fp32", "int8"])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_sharded_ivf_recall_floor(kind, quantize, two_stage_env):
    """Per-shard IVF prune + merge rerank on a device-sharded model holds
    recall@10 ≥ 0.95 against the exact oracle, with zero full gathers."""
    two_stage_env.setenv("PIO_RETRIEVAL_QUANTIZE", quantize)
    two_stage_env.setenv("PIO_SHARD_SERVE", "0")
    two_stage_env.setenv("PIO_RETRIEVAL_MODE", "exact")
    oracle = _host(ttt, n_items=20_000)
    oracle.prepare_for_serving(device="cpu")
    two_stage_env.setenv("PIO_SHARD_SERVE", "1")
    two_stage_env.setenv("PIO_RETRIEVAL_MODE", "two_stage")
    gathers = M.FULL_GATHERS.value
    m = _resident(n_items=20_000)
    m.prepare_for_serving(device="cpu")
    assert m._shard_ivf is not None and len(m._shard_ivf) == 4
    assert all(i.quantized == (quantize == "1") for i in m._shard_ivf)
    rng = np.random.default_rng(6)
    users = rng.integers(0, 160, 32).astype(np.int32)
    exclude, row_mask = _masks(rng, 32, 20_000, kind)
    batches = M.SHARD_BATCHES.value
    oi, _ = _rec(oracle, users, 10, exclude, row_mask)
    gi, gs = _rec(m, users, 10, exclude, row_mask)
    assert _recall(oi, gi) >= 0.95
    assert np.isfinite(gs).all()
    assert M.SHARD_BATCHES.value > batches
    assert M.FULL_GATHERS.value == gathers
    if exclude is not None:
        assert not np.isin(gi, exclude).any()
    if row_mask is not None:
        assert np.all(row_mask[np.arange(32)[:, None], gi] == 0.0)
    if quantize == "1":
        info = m.shard_info()
        assert info["quantized"] and info["rerank_bytes_saved"] > 0


def test_sharded_ivf_undercoverage_falls_back_to_exact(two_stage_env):
    m = _host(ttt, n_items=20_000)
    m.prepare_for_serving(device="cpu")
    rng = np.random.default_rng(7)
    users = rng.integers(0, 160, 4).astype(np.int32)
    keep = np.arange(100, 112)
    row_mask = np.full((4, 20_000), -np.inf, np.float32)
    row_mask[:, keep] = 0.0
    before = M.SHARD_FALLBACKS.value
    gi, gs = _rec(m, users, 10, row_mask=row_mask)
    assert M.SHARD_FALLBACKS.value > before
    assert np.isin(gi, keep).all() and np.isfinite(gs).all()
    two_stage_env.setenv("PIO_SHARD_SERVE", "0")
    two_stage_env.setenv("PIO_RETRIEVAL_MODE", "exact")
    oracle = _host(ttt, n_items=20_000)
    oracle.prepare_for_serving(device="cpu")
    _bitwise((gi, gs), _rec(oracle, users, 10, row_mask=row_mask))


# -- deltas ------------------------------------------------------------------

def test_delta_routes_to_owning_shard(two_stage_env):
    """Host blocks and device blocks: only the owner's tensors are rebuilt,
    the others shared; the IVF overlay lands on the owner; the receiver
    keeps its answers; bad rows are refused."""
    boost = np.concatenate([np.full(RANK, 5.0), [3.0]]).astype(np.float32)
    target = 7  # owned by shard 0
    users = np.arange(6, dtype=np.int32)
    for m in (_host(ttt, n_items=20_000), _resident(n_items=20_000)):
        m.prepare_for_serving(device="cpu")
        sh = m._sharded
        before = _rec(m, users, 5)
        routed = M.DELTA_ROUTED.value
        new = m.with_row_updates(item_rows={target: boost},
                                 user_rows={100: boost})
        assert M.DELTA_ROUTED.value == routed + (1 if sh.device is None else 2)
        owner = sh.spec.owner_of(target)
        for s in range(sh.n_shards):
            if sh.device is None:
                same = new._sharded.blocks[s].bias is sh.blocks[s].bias
            else:
                same = new._sharded.device.item_t[s] is sh.device.item_t[s]
                assert (new._sharded.device.bias[s] is sh.device.bias[s]) == same
                assert new._sharded.device.base_mask[s] is sh.device.base_mask[s]
                assert (new._sharded.device.users[s] is sh.device.users[s]) == \
                    (s != sh.spec_users.owner_of(100))
            assert same == (s != owner)
            assert new._sharded.ivf[s].stale_count == (1 if s == owner else 0)
        assert (_rec(new, users, 5)[0] == target).any()
        _bitwise(_rec(m, users, 5), before)  # the receiver is untouched
        with pytest.raises(ValueError):
            m.with_row_updates(item_rows={20_000: boost})
        with pytest.raises(ValueError, match=r"shape|width"):
            m.with_row_updates(item_rows={1: np.ones(RANK, np.float32)})


def test_stale_overlay_reclusters_past_threshold(two_stage_env):
    two_stage_env.setenv("PIO_STREAM_STALE_REBUILD_FRAC", "0.001")
    for m in (_host(ttt, n_items=20_000), _resident(n_items=20_000)):
        m.prepare_for_serving(device="cpu")
        assert m._sharded.spec.rows_per_shard == 5000
        new = m.with_row_updates(
            item_rows={i: np.ones(RANK + 1, np.float32) for i in range(10)})
        assert new._sharded.ivf[0].stale_count == 0      # re-clustered
        assert new._sharded.ivf[0] is not m._sharded.ivf[0]
        assert new._sharded.ivf[1] is m._sharded.ivf[1]  # untouched, shared
        assert new._shard_ivf is new._sharded.ivf


def test_device_delta_bitwise_fresh_prepare_zero_gathers(shard_env):
    """A device-sharded model through prepare, warmup, queries and a delta:
    no full-table gather, the receiver untouched, and the delta-applied
    model bitwise a fresh sharded prepare of the updated tables
    (tests/test_sharding.py:261)."""
    shard_env.setenv("PIO_SHARD_SERVE", "1")
    shard_env.setenv("PIO_SHARD_SERVE_SHARDS", "4")
    gathers = M.FULL_GATHERS.value
    m = _resident()
    m.prepare_for_serving(host_max_elements=0, device="cpu")
    assert m.warmup(max_batch=8) == 4
    users = np.arange(12, dtype=np.int32)
    before = _rec(m, users, 10)
    rng = np.random.default_rng(2)
    new = m.with_row_updates(
        user_rows={int(u): rng.standard_normal(RANK + 1).astype(np.float32)
                   for u in (3, 80, 159)},
        item_rows={int(i): rng.standard_normal(RANK + 1).astype(np.float32)
                   for i in (17, 2999, 5999)})
    assert new.prepared and new.serving_info()["path"] == "sharded-device-bf16"
    fresh = ttt.TwoTowerModel(mean=new.mean, config=new.config)
    fresh._tables = dict(new._tables)
    fresh._n_users, fresh._n_items = new.n_users, new.n_items
    fresh.prepare_for_serving(host_max_elements=0, device="cpu")
    for num in (10, 200):
        _bitwise(_rec(new, users, num), _rec(fresh, users, num))
    _bitwise(_rec(m, users, 10), before)
    np.testing.assert_array_equal(new._tables["ie"][17].numpy()[:RANK],
                                  fresh._tables["ie"][17].numpy()[:RANK])
    assert not torch.equal(new._tables["ie"], m._tables["ie"])
    assert M.FULL_GATHERS.value == gathers
    assert m.user_emb is None and m.item_emb is None


def test_device_delta_keeps_whole_catalog_ivf(shard_env):
    from incubator_predictionio_tpu_torch.serving import ann

    m = _resident()
    m._ivf = ann.build_ivf(*m._host_item_table(), key=ann.build_key(m.n_items))
    shard_env.setenv("PIO_SHARD_SERVE", "1")
    m.prepare_for_serving(host_max_elements=0, device="cpu")
    assert m._sharded is not None and m._sharded.device is not None
    new = m.with_row_updates(item_rows={5: np.ones(RANK + 1, np.float32)})
    assert new._ivf is not None and new._ivf.stale_count == 1


# -- persistence -------------------------------------------------------------

def test_restore_shards_clamps_forced_count(shard_env):
    """A forced count above the local devices clamps on restore, as at
    build; on the CPU the port counts the reference's 8 devices."""
    shard_env.setenv("PIO_SHARD_SERVE", "1")
    shard_env.setenv("PIO_SHARD_SERVE_SHARDS", "16")
    assert tserve.local_device_count("cpu") == tserve.CPU_SERVE_DEVICES == 8
    assert tserve.restore_shards(1_000_000, RANK, trained_shards=8,
                                 device_type="cpu") == \
        jserve.restore_shards(1_000_000, RANK, trained_shards=8) == 8
    for mode, budget in (("0", None), ("auto", None), ("auto", "1MB")):
        shard_env.setenv("PIO_SHARD_SERVE", mode)
        if budget:
            shard_env.setenv("PIO_SHARD_HBM_BUDGET", budget)
        for n_items, trained in ((1_000_000, 1), (100, 1), (1_000_000, 4)):
            assert tserve.restore_shards(n_items, RANK, trained, "cpu") == \
                jserve.restore_shards(n_items, RANK, trained)


def test_recmodel_save_load_sharded_serve(shard_env, tmp_path, monkeypatch):
    """RecModel.save writes the shard sidecar keys; load restores onto the
    context's device and the sharded deploy answers bitwise as before the
    save, with no full-table gather."""
    from incubator_predictionio_tpu_torch.data.bimap import BiMap
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
    from incubator_predictionio_tpu_torch.templates.recommendation import (
        RecModel,
    )

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    shard_env.setenv("PIO_SHARD_SERVE", "1")
    shard_env.setenv("PIO_SHARD_SERVE_SHARDS", "4")
    ctx = DeviceContext.create("cpu")
    mf = _resident()
    mf._shard_spec = {"ue": ttable.ShardSpec("ue", 160, RANK + 1, 1),
                      "ie": ttable.ShardSpec("ie", 6000, RANK + 1, 1)}
    maps = (BiMap({f"u{i}": i for i in range(160)}),
            BiMap({f"i{i}": i for i in range(6000)}))
    assert RecModel(mf, *maps).save("shard_inst", None, ctx) is True
    mf.prepare_for_serving(host_max_elements=0, device="cpu")
    gathers = M.FULL_GATHERS.value
    loaded = RecModel.load("shard_inst", None, ctx)
    assert loaded.restore_shards == 4
    assert loaded.mf.device_resident and loaded.mf._shard_spec is not None
    loaded.prepare_for_serving(ctx)
    assert loaded.mf.serving_info()["path"] == "sharded-device-bf16"
    assert loaded.shard_info()["n_shards"] == 4
    users = np.arange(8, dtype=np.int32)
    _bitwise(_rec(mf, users, 5), _rec(loaded.mf, users, 5))
    # a streaming delta through the template: the delta-applied model
    # arrives prepared, its non-owner shards shared with the live one
    from incubator_predictionio_tpu_torch.streaming.delta import ModelDelta

    row = np.full(RANK + 1, 0.5, np.float32)
    new = loaded.apply_delta(ModelDelta(
        base_instance="shard_inst", chain_base=0, from_seq=0, to_seq=1,
        user_rows={2: row}, item_rows={4500: row}))
    sh, nsh = loaded.mf._sharded, new.mf._sharded
    assert new.prepare_for_serving(ctx).mf._sharded is nsh
    assert [nsh.device.item_t[s] is sh.device.item_t[s]
            for s in range(4)] == [True, True, True, False]
    assert [nsh.device.users[s] is sh.device.users[s]
            for s in range(4)] == [False, True, True, True]
    fresh = ttt.TwoTowerModel(mean=new.mf.mean, config=new.mf.config)
    fresh._tables = dict(new.mf._tables)
    fresh._n_users, fresh._n_items = 160, 6000
    fresh.prepare_for_serving(host_max_elements=0, device="cpu")
    _bitwise(_rec(new.mf, users, 5), _rec(fresh, users, 5))
    assert M.FULL_GATHERS.value == gathers


def test_persisted_shard_ivf_skips_recluster(two_stage_env, tmp_path,
                                             monkeypatch):
    """Pickled (host) and saved (resident) models keep the slim per-shard
    clustering; a fresh prepare rehydrates it when the keys match."""
    from incubator_predictionio_tpu_torch.data.bimap import BiMap
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
    from incubator_predictionio_tpu_torch.templates.recommendation import (
        RecModel,
    )

    m = _host(ttt, n_items=20_000)
    m.prepare_for_serving(device="cpu")
    keys = [i.key for i in m._shard_ivf]
    back = pickle.loads(pickle.dumps(m))
    assert back._sharded is None and back._shard_ivf is not None
    assert all(not i.hydrated and i.device is None for i in back._shard_ivf)
    slim = list(back._shard_ivf)
    back.prepare_for_serving(device="cpu")
    assert [i.key for i in back._shard_ivf] == keys
    assert all(a is b for a, b in zip(slim, back._sharded.ivf))
    users = np.arange(4, dtype=np.int32)
    _bitwise(_rec(m, users, 10), _rec(back, users, 10))

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    ctx = DeviceContext.create("cpu")
    r = _resident(n_items=20_000)
    r._device = ctx.device
    r._prepare_index()  # as ALSAlgorithm.train: the train-time build
    assert len(r._shard_ivf) == 4 and r._sharded is None
    maps = (BiMap({f"u{i}": i for i in range(160)}),
            BiMap({f"i{i}": i for i in range(20_000)}))
    assert RecModel(r, *maps).save("ivf_inst", None, ctx)
    loaded = RecModel.load("ivf_inst", None, ctx)
    slim = list(loaded.mf._shard_ivf)
    assert all(not i.hydrated for i in slim)
    loaded.prepare_for_serving(ctx)
    assert all(a is b for a, b in zip(slim, loaded.mf._sharded.ivf))


# -- reporting ---------------------------------------------------------------

def test_shard_info_and_cli_formatting(two_stage_env):
    """shard_info, and format_shard_stats giving the reference's lines on
    the same info; the unsharded plan and budget verdict."""
    from incubator_predictionio_tpu.tools import cli as jcli
    from incubator_predictionio_tpu_torch.tools import cli as tcli

    m = _host(ttt, n_items=20_000)
    m.prepare_for_serving(device="cpu")
    info = m.shard_info()
    assert info["sharded"] and info["n_shards"] == 4 and info["mode"] == "host"
    assert info["items"]["n_rows"] == 20_000
    assert info["merge_fanin"] == 4 * min(m._serve_k,
                                          info["items"]["rows_per_shard"])
    j = _host(jtt, n_items=20_000)
    j.prepare_for_serving()
    jinfo = j.shard_info()
    for key in ("n_shards", "mode", "items", "users", "merge_fanin",
                "serve_k", "hbm_budget", "quantized", "rerank_bytes",
                "rerank_bytes_saved"):
        assert info[key] == jinfo[key], key

    class Rec:
        def __init__(self, i):
            self.i = i

        def shard_info(self):
            return self.i

    lines = tcli.format_shard_stats([Rec(info), object()])
    assert lines == jcli.format_shard_stats([Rec(info), object()])
    assert "SHARDED ×4" in "\n".join(lines)
    assert any("per-shard IVF" in ln for ln in lines)
    two_stage_env.setenv("PIO_SHARD_SERVE", "0")
    two_stage_env.setenv("PIO_SHARD_HBM_BUDGET", "1MB")
    u = _host(ttt, n_items=20_000).shard_info()
    assert not u["sharded"] and u["requires_sharding"]
    lines = tcli.format_shard_stats([Rec(u)])
    assert lines == jcli.format_shard_stats([Rec(u)])
    assert any("EXCEEDS one chip" in ln for ln in lines)


def test_health_sharding_summary(two_stage_env):
    from incubator_predictionio_tpu_torch.server.query_server import (
        QueryServer,
    )

    m = _host(ttt, n_items=20_000)
    m.prepare_for_serving(device="cpu")

    class Deployed:
        models = [type("R", (), {"serving_info": staticmethod(
            lambda: m.serving_info())})(), object()]

    qs = QueryServer.__new__(QueryServer)
    qs.deployed = Deployed()
    assert qs._sharding_summary() == [
        {"nShards": 4, "mode": "host",
         "mergeFanin": m._sharded.info()["merge_fanin"],
         "shardIds": [0, 1, 2, 3],
         "rows": [[0, 5000], [5000, 10000], [10000, 15000], [15000, 20000]]},
        None]


def test_auto_mode_stays_off_for_small_and_unsharded(shard_env):
    m = _host(ttt, n_items=300)
    m.prepare_for_serving(device="cpu")
    assert m._sharded is None and m._host_items is not None
    info = m.shard_info()
    assert not info["sharded"] and not info["requires_sharding"]
    r = _resident()
    r.prepare_for_serving(host_max_elements=0, device="cpu")
    assert r._sharded is None and r.serving_info()["path"] == "device-bf16"
    assert tserve.serve_mode() == "auto"
    shard_env.setenv("PIO_SHARD_SERVE", "sometimes")
    with pytest.raises(ValueError, match="want auto"):
        tserve.serve_mode()


def test_degrade_registry_warns_once(caplog):
    degrade.reset()
    with caplog.at_level("WARNING"):
        for _ in range(3):
            rec = degrade.record_axis_degradation(
                "transformer", "expert", 4, ("data",), "experts replicated")
        degrade.record_axis_degradation(
            "transformer", "model", "tp", ("data",), "replicated")
    assert rec["count"] == 3
    assert len([r for r in caplog.records if "expert" in r.message]) == 1
    got = degrade.degradations()
    assert [(d["axis"], d["count"]) for d in got] == [("expert", 3),
                                                      ("model", 1)]
    got[0]["count"] = 99  # copies: the registry is not mutated
    assert degrade.degradations()[0]["count"] == 3
    degrade.reset()
    assert degrade.degradations() == []
