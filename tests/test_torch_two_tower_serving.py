"""PyTorch port, models/two_tower.py + serving/ann.py: the same numpy towers
go into the JAX package's TwoTowerModel and the port's, and
``recommend_batch`` must answer the same on every serving path — host numpy,
the bf16 device path and the int8 path (kernel K1's plain version on the
CPU) — and through the two-stage IVF path (kernel K2's host twin).

Ids must be equal; scores agree within 1e-5 on the host path (the same
numpy code) and 1e-4 on the device paths (exact products, fp32 sums in
another order). The towers are continuous random numbers, so exact ties
have probability ~0; where a result runs into -inf (masked) entries, the
set of masked ids must match, not their order (``lax.top_k`` and
``torch.topk`` order ties differently).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu.models import two_tower as jtt  # noqa: E402
from incubator_predictionio_tpu.ops.retrieval import quantize_rows  # noqa: E402
from incubator_predictionio_tpu_torch.models import two_tower as ttt  # noqa: E402

HOST_TOL = 1e-5
DEVICE_TOL = 1e-4

PATHS = {
    # name: (prepare kwargs, score tolerance)
    "host": ({}, HOST_TOL),
    "bf16": ({"host_max_elements": 0}, DEVICE_TOL),
    "int8": ({"quantize": True, "host_max_elements": 0}, DEVICE_TOL),
}


def _towers(seed, n_users, n_items, rank, clustered=False):
    rng = np.random.default_rng(seed)
    if clustered:
        concepts = rng.standard_normal((64, rank)).astype(np.float32)
        item = concepts[rng.integers(0, 64, n_items)] \
            + 0.5 * rng.standard_normal((n_items, rank)).astype(np.float32)
        user = concepts[rng.integers(0, 64, n_users)] \
            + 0.5 * rng.standard_normal((n_users, rank)).astype(np.float32)
    else:
        item = rng.normal(size=(n_items, rank)).astype(np.float32)
        user = rng.normal(size=(n_users, rank)).astype(np.float32)
    return dict(
        user_emb=user, item_emb=item,
        user_bias=(rng.standard_normal(n_users) * 0.1).astype(np.float32),
        item_bias=(rng.standard_normal(n_items) * 0.1).astype(np.float32),
        mean=3.0, rank=rank)


def _pair(towers):
    """(JAX model, port model) over copies of the same arrays."""
    kw = {k: v for k, v in towers.items() if k != "rank"}
    j = jtt.TwoTowerModel(**copy.deepcopy(kw),
                          config=jtt.TwoTowerConfig(rank=towers["rank"]))
    t = ttt.TwoTowerModel(**copy.deepcopy(kw),
                          config=ttt.TwoTowerConfig(rank=towers["rank"]))
    return j, t


def _assert_same_answer(got, want, tol):
    (gi, gs), (wi, ws) = got, want
    assert gi.shape == wi.shape and gs.shape == ws.shape
    finite = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), finite)
    np.testing.assert_array_equal(gi[finite], wi[finite])
    np.testing.assert_allclose(gs[finite], ws[finite], rtol=tol, atol=tol)
    for r in range(wi.shape[0]):  # masked tails: same ids, any order
        assert set(gi[r][~finite[r]].tolist()) == set(wi[r][~finite[r]].tolist())


@pytest.mark.parametrize("rank", [32, 128])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_recommend_batch_matches_jax(path, rank, monkeypatch):
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")
    n_users, n_items = 40, 700
    j, t = _pair(_towers(rank, n_users, n_items, rank))
    kw, tol = PATHS[path]
    j.prepare_for_serving(serve_k=16, **kw)
    t.prepare_for_serving(serve_k=16, device="cpu", **kw)
    expect_path = {"host": "host-numpy", "bf16": "device-bf16",
                   "int8": "device-int8"}[path]
    assert t.serving_info()["path"] == expect_path
    rng = np.random.default_rng(7)
    for b in (1, 3, 9, 16):  # buckets 1, 4, 16, 16
        users = rng.integers(0, n_users, b).astype(np.int32)
        excl = rng.choice(n_items, 5, replace=False)
        rm = np.zeros((b, n_items), np.float32)
        rm[np.arange(b), rng.integers(0, n_items, b)] = -np.inf
        for num in (1, 10, 16, 40):  # under and over serve_k
            for kwargs in ({}, {"exclude": excl}, {"row_mask": rm},
                           {"exclude": excl, "row_mask": rm}):
                _assert_same_answer(
                    ttt.TwoTowerMF.recommend_batch(t, users, num, **kwargs),
                    jtt.TwoTowerMF.recommend_batch(j, users, num, **kwargs),
                    tol)
        # num > n_items clamps to the catalog (masked tail included)
        _assert_same_answer(
            ttt.TwoTowerMF.recommend_batch(t, users, n_items + 9, exclude=excl),
            jtt.TwoTowerMF.recommend_batch(j, users, n_items + 9, exclude=excl),
            tol)
        # num <= 0 answers empty on every path
        for num in (0, -3):
            gi, gs = ttt.TwoTowerMF.recommend_batch(t, users, num)
            assert gi.shape == (b, 0) and gs.shape == (b, 0)
    gi, gs = ttt.TwoTowerMF.recommend(t, 5, 12)
    wi, ws = jtt.TwoTowerMF.recommend(j, 5, 12)
    _assert_same_answer((gi[None], gs[None]), (wi[None], ws[None]), tol)


@pytest.mark.parametrize("path", ["bf16", "int8"])
def test_warmup_matches_jax_bucket_count(path, monkeypatch):
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")
    j, t = _pair(_towers(3, 20, 600, 32))
    kw, _ = PATHS[path]
    j.prepare_for_serving(serve_k=8, **kw)
    t.prepare_for_serving(serve_k=8, device="cpu", **kw)
    assert t.warmup(max_batch=16) == j.warmup(max_batch=16) == 5


def test_row_mask_shape_is_checked():
    _, t = _pair(_towers(4, 10, 600, 32))
    t.prepare_for_serving(host_max_elements=0, device="cpu")
    with pytest.raises(ValueError, match="row_mask"):
        ttt.TwoTowerMF.recommend_batch(
            t, np.arange(3), 5, row_mask=np.zeros((2, 600), np.float32))


@pytest.mark.parametrize("quantize", ["1", "0"], ids=["int8", "fp32"])
def test_two_stage_matches_jax(quantize, monkeypatch):
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "two_stage")
    monkeypatch.setenv("PIO_RETRIEVAL_NPROBE", "8")
    monkeypatch.setenv("PIO_RETRIEVAL_QUANTIZE", quantize)
    n_users, n_items = 64, 4000
    j, t = _pair(_towers(11, n_users, n_items, 32, clustered=True))
    j.prepare_for_serving(serve_k=10)
    t.prepare_for_serving(serve_k=10, device="cpu")
    assert t.serving_info()["retrieval_mode"] == "two_stage"
    # the same catalog and seeds give the same partition
    ji, ti = j._ivf, t._ivf
    np.testing.assert_array_equal(ti.centroids, ji.centroids)
    np.testing.assert_array_equal(ti.member_ids, ji.member_ids)
    np.testing.assert_array_equal(ti.offsets, ji.offsets)
    rng = np.random.default_rng(5)
    users = rng.integers(0, n_users, 16).astype(np.int32)
    q = t.user_emb[users]
    q_quant = quantize_rows(q) if quantize == "1" else None
    np.testing.assert_array_equal(
        np.sort(ti.probe(q, 8, q_quant=q_quant), axis=1),
        np.sort(ji.probe(q, 8, q_quant=q_quant), axis=1))
    excl = rng.choice(n_items, 20, replace=False)
    rm = np.zeros((16, n_items), np.float32)
    rm[:, rng.choice(n_items, 50, replace=False)] = -np.inf
    for kwargs in ({}, {"exclude": excl}, {"row_mask": rm}):
        got = ttt.TwoTowerMF.recommend_batch(t, users, 10, **kwargs)
        want = jtt.TwoTowerMF.recommend_batch(j, users, 10, **kwargs)
        _assert_same_answer(got, want, HOST_TOL)
    # the fallback (probe under-covers num) answers from the exact path
    got = ttt.TwoTowerMF.recommend_batch(t, users[:3], 3000)
    want = jtt.TwoTowerMF.recommend_batch(j, users[:3], 3000)
    _assert_same_answer(got, want, HOST_TOL)


def test_coarse_kernel_path_pads_and_matches_host_probe(monkeypatch):
    """``IVFIndex._probe_cuda`` (the bucket padding around kernel K2) run on
    CPU tensors, where K2's wrapper takes its plain version: the coarse
    scores equal the host twin's bit for bit, for every batch size."""
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "two_stage")
    _, t = _pair(_towers(12, 40, 3000, 32, clustered=True))
    t.prepare_for_serving(device="cpu")
    idx = t._ivf
    idx.device = torch.device("cpu")
    from incubator_predictionio_tpu_torch.ops.retrieval import (
        int8_matmul_exact,
    )

    # the first probe of a fresh index quantizes the centroids itself; it
    # used to take the index lock twice (a deadlock) — bound it with a join
    import threading

    first = threading.Thread(
        target=idx._probe_cuda, args=quantize_rows(t.user_emb[:3]), daemon=True)
    first.start()
    first.join(timeout=30)
    assert not first.is_alive(), "first _probe_cuda call deadlocked"
    cent_q, cent_s = idx._coarse_quant()
    for b in (1, 5, 8, 9, 33):
        q_q, q_s = quantize_rows(t.user_emb[:b])
        got = idx._probe_cuda(q_q, q_s)
        host = (int8_matmul_exact(q_q, cent_q)
                * (q_s[:, None] * cent_s[None, :]) + idx.centroids[:, -1][None, :])
        assert got.shape == (b, idx.n_partitions)
        np.testing.assert_array_equal(got, host)


def test_pickling_drops_serving_state(monkeypatch):
    import pickle

    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "two_stage")
    _, t = _pair(_towers(13, 30, 2500, 16, clustered=True))
    t.prepare_for_serving(quantize=True, host_max_elements=0, device="cpu")
    t._ivf.device = torch.device("cpu")
    back = pickle.loads(pickle.dumps(t))
    assert back._device_items_q is None and back._device_users is None
    assert back._ivf is not None and not back._ivf.hydrated
    assert back._ivf.device is None
    back.prepare_for_serving(quantize=True, host_max_elements=0, device="cpu")
    users = np.arange(6, dtype=np.int32)
    _assert_same_answer(ttt.TwoTowerMF.recommend_batch(back, users, 7),
                        ttt.TwoTowerMF.recommend_batch(t, users, 7), 0.0)
