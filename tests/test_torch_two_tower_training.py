"""PyTorch port, the two-tower trainer on the CPU: ``models/two_tower.py``
``_sort_batches_by_entity``, the staging, the step and ``TwoTowerMF.fit``
against the JAX package's, fed the same numpy triples.

The JAX side runs on one CPU device (``MeshContext`` over the first of
tests/conftest.py's 8), so both packages stage the same batches: the
permutation and the padding come from ``default_rng(seed)`` in numpy. The
port starts from the reference's own initial tables (captured from its
``_train_epochs`` and injected through ``convert.two_tower_tables_from_jax``
and ``_init_tables``): from different draws the planted fit's final loss
spreads widely across seeds in either package, so only a shared init can
hold it to a band.

Tolerances, with their reasons:
- staging: bitwise (the same numpy code on the same seed).
- one step's dense gradients: within 4e-3 of each table's max abs. The backward rounds the prediction's and the
  embeddings' cotangents to bf16 as JAX's does; a 1-ulp fp32 difference
  upstream (XLA and torch sum in other orders) can flip one of those
  roundings.
- 3 epochs: the last epoch's loss within 1e-4 relative, each table within
  1e-2 relative Frobenius error. Adam turns a flipped sign of a near-zero
  gradient into a step of about ±lr, so elementwise bands would be loose;
  the norms hold the trajectory.
- planted low-rank fit (30 epochs) and the sparse fits: final loss within
  5% (and top-8 overlap > 0.8), the reference's own bands for fp32
  against bf16 moments (tests/test_optim_parity.py:95-105).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.models import two_tower as jtt  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.utils import optim as joptim  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.models import two_tower as ttt  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.utils import optim as toptim  # noqa: E402

CPU = DeviceContext.create(device="cpu")
N_USERS, N_ITEMS, RANK = 300, 120, 8
CFG = dict(rank=RANK, epochs=3, batch_size=1024, seed=3, gather="host")
GRAD_TOL = 4e-3
LOSS_RTOL = 1e-4
TABLE_RTOL = 1e-2
MOMENTS = ["float32", "bfloat16"]


def _jax_ctx():
    return MeshContext.create(devices=jax.devices()[:1])


def _triples(seed=11, n=4500):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, N_USERS, n).astype(np.int32)
    items = rng.integers(0, N_ITEMS, n).astype(np.int32)
    ratings = (1.0 + 4.0 * rng.random(n)).astype(np.float32)
    return users, items, ratings


def _jax_fit(monkeypatch, cfg, users, items, ratings, n_users=N_USERS,
             n_items=N_ITEMS):
    """The JAX fit, with its staged batches and initial tables captured
    from its ``_train_epochs`` call."""
    seen = {}
    real = jtt._train_epochs

    def capture(p, o, ub, ib, rb, wb, lr, reg, n_epochs):
        seen.setdefault("init", {k: np.array(v) for k, v in p.items()})
        seen["batches"] = tuple(np.asarray(a) for a in (ub, ib, rb, wb))
        return real(p, o, ub, ib, rb, wb, lr, reg, n_epochs)

    monkeypatch.setattr(jtt, "_train_epochs", capture)
    model = jtt.TwoTowerMF(jtt.TwoTowerConfig(**cfg)).fit(
        _jax_ctx(), users, items, ratings, n_users, n_items)
    monkeypatch.setattr(jtt, "_train_epochs", real)
    return model, seen


def _inject(monkeypatch, init):
    """The port's fit starts from the reference's initial tables."""
    monkeypatch.setattr(ttt, "_init_tables", lambda cfg, nu, ni, device, gen: (
        convert.two_tower_tables_from_jax(init, device)))


def test_sort_batches_by_entity_is_the_reference():
    rng = np.random.default_rng(4)
    order = rng.permutation(96)
    w = (rng.random(96) < 0.8).astype(np.float32)
    users = rng.integers(0, 7, 96).astype(np.int32)  # many ties: stability
    got = ttt._sort_batches_by_entity(order, w, users, 3, 32)
    want = jtt._sort_batches_by_entity(order, w, users, 3, 32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_staged_batches_are_the_references(monkeypatch):
    """4,500 triples at batch 1,024: five batches, the last padded with
    620 weight-0 rows — the reference's arrays bitwise, and its mean."""
    users, items, ratings = _triples()
    want_model, seen = _jax_fit(monkeypatch, dict(CFG, epochs=1),
                                users, items, ratings)
    ub, ib, rb, wb, mean = ttt._stage_batches(
        ttt.TwoTowerConfig(**dict(CFG, epochs=1)), users, items, ratings)
    for got, want in zip((ub, ib, rb, wb), seen["batches"]):
        assert got.dtype == want.dtype and got.shape == want.shape == (5, 1024)
        np.testing.assert_array_equal(got, want)
    assert mean == want_model.mean
    assert wb.sum() == len(users)


def _jax_step_grads(monkeypatch, init, batch, reg):
    """The reference's loss and dense gradients of the last (padded)
    batch: its own
    ``_train_epochs`` body (unjitted) with ``adam_apply`` replaced by one
    that returns the gradients as the new parameters."""
    monkeypatch.setattr(joptim, "adam_apply", lambda p, g, o, lr: (g, o))
    p = {k: jnp.asarray(v) for k, v in init.items()}
    o = joptim.adam_tree_init(p, "float32")
    grads, _, loss = jtt._train_epochs.__wrapped__(
        p, o, *(jnp.asarray(a[-1:]) for a in batch), 3e-2, reg, 1)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("moments", MOMENTS)
def test_one_step_gradients_match_jax(monkeypatch, moments):
    users, items, ratings = _triples()
    _, seen = _jax_fit(monkeypatch, dict(CFG, epochs=1, adam_moments_dtype=moments),
                       users, items, ratings)
    reg = 1e-4
    want_loss, want = _jax_step_grads(monkeypatch, seen["init"], seen["batches"], reg)
    tables = list(convert.two_tower_tables_from_jax(seen["init"]))
    grads = [torch.empty_like(t) for t in tables]
    bu, bi, br, bw = (a[-1] for a in seen["batches"])
    batch = [torch.from_numpy(a.copy()) for a in (bu, bi, br, bw)]
    loss = ttt._loss_and_grads(tables, grads, *batch, reg)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    for g, k in zip(grads, ("ue", "ie")):
        scale = np.abs(want[k]).max()
        assert scale > 0
        err = np.abs(g.numpy() - want[k]).max() / scale
        assert err <= GRAD_TOL, (k, err)
    # the weight-0 padding rows count in the L2 term: a user that only a
    # padding row of this batch touches gets the L2 gradient on its
    # embedding and none on its bias
    pad_only = np.setdiff1d(bu[bw == 0], bu[bw == 1])
    assert len(pad_only)
    g_ue = grads[0].numpy()
    assert (np.abs(g_ue[pad_only, :RANK]).max(axis=1) > 0).all()
    np.testing.assert_array_equal(g_ue[pad_only, RANK], 0.0)
    # then one step of the dense adam moves every row the batch touched
    state = toptim.adam_tree_init(tables, moments)
    before = tables[0].clone()
    toptim.adam_apply(tables, grads, state, 3e-2)
    moved = (tables[0] != before).any(dim=1).numpy()
    assert moved[np.unique(bu)].all()


@pytest.mark.parametrize("moments", MOMENTS)
def test_three_epochs_match_jax_from_its_initial_tables(monkeypatch, moments):
    users, items, ratings = _triples()
    cfg = dict(CFG, adam_moments_dtype=moments)
    want, seen = _jax_fit(monkeypatch, cfg, users, items, ratings)
    _inject(monkeypatch, seen["init"])
    got = ttt.TwoTowerMF(ttt.TwoTowerConfig(**cfg)).fit(
        CPU, users, items, ratings, N_USERS, N_ITEMS)
    assert not got.device_resident  # gather="host"
    assert np.isfinite(got.final_loss)
    np.testing.assert_allclose(got.final_loss, want.final_loss, rtol=LOSS_RTOL)
    assert got.mean == want.mean
    for name in ("user_emb", "item_emb", "user_bias", "item_bias"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.shape == b.shape and a.dtype == np.float32
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= TABLE_RTOL, (name, rel)
    init_ue = seen["init"]["ue"][:N_USERS, :RANK]
    assert np.abs(got.user_emb - init_ue).max() > 3e-2  # it trained
    assert set(got.timings) == {"stage_sec", "init_sec", "train_sec", "gather_sec"}


def _planted(seed=11, n=6000):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, N_USERS, n).astype(np.int32)
    items = rng.integers(0, N_ITEMS, n).astype(np.int32)
    uf = rng.normal(size=(N_USERS, 4))
    vf = rng.normal(size=(N_ITEMS, 4))
    return users, items, (uf[users] * vf[items]).sum(1).astype(np.float32)


@pytest.mark.parametrize("moments", MOMENTS)
def test_planted_low_rank_fit_converges_like_jax(monkeypatch, moments):
    """test_optim_parity.py:_fit's problem (rank 8, 30 epochs, batch
    1,024), from the reference's initial tables."""
    users, items, ratings = _planted()
    cfg = dict(rank=RANK, epochs=30, batch_size=1024, seed=0, gather="host",
               adam_moments_dtype=moments)
    want, seen = _jax_fit(monkeypatch, cfg, users, items, ratings)
    _inject(monkeypatch, seen["init"])
    got = ttt.TwoTowerMF(ttt.TwoTowerConfig(**cfg)).fit(
        CPU, users, items, ratings, N_USERS, N_ITEMS)
    assert np.isfinite(got.final_loss)
    assert got.final_loss == pytest.approx(want.final_loss, rel=0.05)

    def top8(m):
        s = np.asarray(m.user_emb) @ np.asarray(m.item_emb).T \
            + np.asarray(m.item_bias)[None, :]
        return np.argsort(-s, axis=1)[:, :8]

    overlap = np.mean([len(set(a) & set(b)) / 8.0
                       for a, b in zip(top8(got), top8(want))])
    assert overlap > 0.8, overlap


@pytest.mark.parametrize("rank,rises", [(128, True), (32, False)])
def test_sparse_fit_loss_moves_like_jax(monkeypatch, rank, rises):
    """Four events a user over 62 batches an epoch (the density of
    bench_recommendation_scaled, cut to 10,000 users, 1,000 items and
    40,000 events): at rank 128 the reference's own training loss RISES
    from the first epoch to the fourth (the dense adam keeps moving rows
    touched once in ~15 steps on their decaying momentum), at rank 32 it
    falls. The port does the same, each epoch count's loss within 5% of
    JAX's (the reference's fp32-vs-bf16 band), from JAX's initial tables."""
    n_users, n_items, n = 10_000, 1_000, 40_000
    rng = np.random.default_rng(9)
    users = rng.integers(0, n_users, n).astype(np.int32)
    items = rng.integers(0, n_items, n).astype(np.int32)
    ratings = (1.0 + 4.0 * rng.random(n)).astype(np.float32)
    losses = {}
    for epochs in (1, 4):
        cfg = dict(rank=rank, batch_size=-(-n // 62), epochs=epochs, seed=1,
                   adam_moments_dtype="bfloat16", gather="host")
        want, seen = _jax_fit(monkeypatch, cfg, users, items, ratings,
                              n_users, n_items)
        _inject(monkeypatch, seen["init"])
        got = ttt.TwoTowerMF(ttt.TwoTowerConfig(**cfg)).fit(
            CPU, users, items, ratings, n_users, n_items)
        assert got.final_loss == pytest.approx(want.final_loss, rel=0.05)
        losses[epochs] = (got.final_loss, want.final_loss)
    for i in range(2):
        assert (losses[4][i] > losses[1][i]) == rises, losses


def test_fit_keeps_large_catalogs_on_the_device(monkeypatch):
    """gather="auto" keeps the tables resident when the catalog passes
    HOST_SERVE_MAX_ELEMENTS (here lowered); the resident model serves,
    pickles through its host views, and takes row updates through them
    (the reference's ensure_host, two_tower.py:481): the updated model is
    a host model."""
    monkeypatch.setattr(ttt, "HOST_SERVE_MAX_ELEMENTS", 100)
    users, items, ratings = _triples(n=600)
    cfg = ttt.TwoTowerConfig(rank=RANK, epochs=1, batch_size=256)
    model = ttt.TwoTowerMF(cfg).fit(CPU, users, items, ratings, N_USERS, N_ITEMS)
    assert model.device_resident and model.user_emb is None
    assert (model.n_users, model.n_items) == (N_USERS, N_ITEMS)
    model.prepare_for_serving(quantize=True, device="cpu", build_index=False)
    assert model.serving_info()["path"] == "device-int8"
    assert model.user_emb is None  # prepared device to device
    idx, _ = ttt.TwoTowerMF.recommend_batch(model, np.arange(4, dtype=np.int32), 5)
    assert idx.shape == (4, 5)
    row = np.arange(RANK + 1, dtype=np.float32)
    new = model.with_row_updates({0: row})
    assert not new.device_resident and model.device_resident
    np.testing.assert_array_equal(new.user_emb[0], row[:RANK])
    assert new.user_bias[0] == row[RANK]
    np.testing.assert_array_equal(
        new.user_emb[1:], model._tables["ue"][1:N_USERS, :RANK].numpy())
    import pickle

    host = pickle.loads(pickle.dumps(model))
    assert not host.device_resident
    np.testing.assert_array_equal(
        host.user_emb, model._tables["ue"][:N_USERS, :RANK].numpy())


def test_fit_refuses_what_is_not_ported(tmp_path):
    """Per-process staging of entity-sharded rows is ported
    (tests/test_torch_distributed_train.py) and so are mid-training
    checkpoints of one process (tests/test_torch_checkpoint.py); the
    checkpoints of a multi-process fit wait for the sharding slice, and a
    context that claims two processes without a group refuses at its first
    collective."""
    users, items, ratings = _triples(n=100)
    two = DeviceContext(torch.device("cpu"), process_index=0, process_count=2)
    with pytest.raises(NotImplementedError, match="item 4"):
        ttt.TwoTowerMF(ttt.TwoTowerConfig(
            checkpoint_every=1, checkpoint_dir=str(tmp_path))).fit(
            two, users, items, ratings, N_USERS, N_ITEMS, rows_are_local=True)
    with pytest.raises(RuntimeError, match="no process group was joined"):
        ttt.TwoTowerMF(ttt.TwoTowerConfig(checkpoint_every=1)).fit(
            two, users, items, ratings, N_USERS, N_ITEMS, rows_are_local=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceContext.create()
