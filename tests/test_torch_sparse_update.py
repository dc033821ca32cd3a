"""PyTorch port, kernel K3 and the streaming fold (ops/sparse_update.py,
streaming/trainer.py) held against the JAX package on the CPU.

The same inputs, made with numpy from a seed, go through both packages:

- the host engine (``adam_bias_corrections``, ``fused_adam_rows``) is
  bitwise the JAX package's;
- K3's plain version (``fused_adam_rows_device(device="cpu")``) is held to
  the JAX Pallas kernel in interpret mode within the reference's band for
  its compiled engines (rtol 2e-5, atol 1e-7, tests/test_sparse_update.py:
  62-70), and to the host pass bitwise;
- the fold in every ``PIO_STREAM_FUSED`` mode on a CPU trainer against the
  JAX ``DeltaTrainer`` (bitwise for ``0``, ``1``, ``auto``; the band and
  exact step counts for ``device``), and a stream carried across from the
  JAX trainer with ``convert.trainer_state_from_reference``.

K3 itself runs only on the card; ``chip_smoke.py`` holds it to its plain
version there, and the ``cuda`` test below does when a card is present.
"""

import datetime as dt

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu.data import DataMap as JDataMap  # noqa: E402
from incubator_predictionio_tpu.data import Event as JEvent  # noqa: E402
from incubator_predictionio_tpu.ops import sparse_update as jsu  # noqa: E402
from incubator_predictionio_tpu.streaming import trainer as jtr  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.data.event import (  # noqa: E402
    DataMap,
    Event,
)
from incubator_predictionio_tpu_torch.ops import sparse_update as tsu  # noqa: E402
from incubator_predictionio_tpu_torch.streaming import (  # noqa: E402
    stream_metrics,
)
from incubator_predictionio_tpu_torch.streaming import trainer as ttr  # noqa: E402

UTC = dt.timezone.utc
T0 = dt.datetime(2023, 5, 1, tzinfo=UTC)
#: the reference's contract for its compiled adam engines
RTOL, ATOL = 2e-5, 1e-7
#: (R, D) of the reference's _stack_problem cases and the fold's widest
#: micro-batch at rank 32 (256 events touch at most 512 rows of D 33)
SHAPES = ((37, 17), (265, 8), (512, 33))


def _stack_problem(r=37, d=17, seed=0):
    """tests/test_sparse_update.py:43: heterogeneous step counts, fresh rows
    (t = 1) next to well-trained ones."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(r, d)).astype(np.float32)
    m = (rng.normal(size=(r, d)) * 0.01).astype(np.float32)
    v = np.abs(rng.normal(size=(r, d)) * 1e-4).astype(np.float32)
    g = rng.normal(size=(r, d)).astype(np.float32)
    t = rng.integers(1, 500, r).astype(np.int64)
    t[:3] = 1
    return rows, m, v, g, t


def _bitwise(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()


def _band(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_host_engine_bitwise_jax(shape):
    rows, m, v, g, t = _stack_problem(*shape)
    for got, want in zip(tsu.adam_bias_corrections(t),
                         jsu.adam_bias_corrections(t)):
        assert got.tobytes() == want.tobytes()
    _bitwise(tsu.fused_adam_rows(rows, m, v, g, t, lr=0.05),
             jsu.fused_adam_rows(rows, m, v, g, t, lr=0.05))
    # the inputs are never mutated
    r2, m2, *_ = _stack_problem(*shape)
    np.testing.assert_array_equal(rows, r2)
    np.testing.assert_array_equal(m, m2)


@pytest.mark.parametrize("r", [0, 1, 512, 4096])
def test_bias_corrections_bitwise_jax(r):
    """The per-row bias corrections (one scalar double ``**`` per distinct
    step count, spread by a gather) equal the JAX package's, dtype and
    bytes, from no rows to many distinct step counts."""
    t = np.random.default_rng(r).integers(1, 501, r)
    for got, want in zip(tsu.adam_bias_corrections(t),
                         jsu.adam_bias_corrections(t)):
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (r,)
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_device_engine_plain_vs_pallas_interpret(shape):
    """The port's device engine on CPU tensors (K3's plain version) against
    the JAX Pallas kernel in interpret mode — padded lanes included — and
    against the host pass, which it matches bit for bit."""
    rows, m, v, g, t = _stack_problem(*shape, seed=1)
    before = tsu.adam_rows.launches
    got = tsu.fused_adam_rows_device(rows, m, v, g, t, lr=0.05, device="cpu")
    assert tsu.adam_rows.launches == before  # the plain version: no launch
    want = jsu.fused_adam_rows_device(rows, m, v, g, t, lr=0.05,
                                      interpret=True)
    _band(got, want)
    _bitwise(got, tsu.fused_adam_rows(rows, m, v, g, t, lr=0.05))


def test_adam_rows_checks_shapes_and_routes_by_device():
    rows, m, v, g, t = _stack_problem(5, 4)
    bc1, bc2 = tsu.adam_bias_corrections(t)
    stack = torch.from_numpy(np.stack([rows, m, v, g]))
    bc = torch.from_numpy(np.stack([bc1, bc2]))
    out = tsu.adam_rows(stack, bc, 0.05)
    assert tuple(out.shape) == (3, 5, 4)
    _bitwise(out.numpy(), tsu.fused_adam_rows(rows, m, v, g, t, lr=0.05))
    with pytest.raises(ValueError, match="bc shape"):
        tsu.adam_rows(stack, bc[:, :4], 0.05)
    with pytest.raises(ValueError, match="stack shape"):
        tsu.adam_rows(stack[:3], bc, 0.05)
    # a CUDA tensor never takes the plain version: the kernel or an error
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            tsu._launch_adam_rows(stack, bc, 0.05, 0.9, 0.999, 1e-8)


def test_fused_gather_adam_scatter_vs_jax():
    """Touched rows within the band of the JAX table-resident engine (and
    bitwise the host pass), untouched rows and the inputs byte-identical."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    n, d, r = 64, 9, 12
    table = rng.normal(size=(n, d)).astype(np.float32)
    m_tab = (rng.normal(size=(n, d)) * 0.01).astype(np.float32)
    v_tab = np.abs(rng.normal(size=(n, d)) * 1e-4).astype(np.float32)
    idx = rng.choice(n, r, replace=False).astype(np.int32)
    g = rng.normal(size=(r, d)).astype(np.float32)
    t = rng.integers(1, 40, r).astype(np.int64)
    bc1, bc2 = tsu.adam_bias_corrections(t)
    T = torch.from_numpy
    nt, nm, nv = (a.numpy() for a in tsu.fused_gather_adam_scatter(
        T(table), T(m_tab), T(v_tab), T(idx), T(g), T(bc1), T(bc2), lr=0.05))
    jt, jm, jv = (np.asarray(a) for a in jsu.fused_gather_adam_scatter(
        jnp.asarray(table), jnp.asarray(m_tab), jnp.asarray(v_tab),
        jnp.asarray(idx), jnp.asarray(g), jnp.asarray(bc1), jnp.asarray(bc2),
        lr=0.05))
    _band((nt[idx], nm[idx], nv[idx]), (jt[idx], jm[idx], jv[idx]))
    _bitwise((nt[idx], nm[idx], nv[idx]), tsu.fused_adam_rows(
        table[idx], m_tab[idx], v_tab[idx], g, t, lr=0.05))
    untouched = np.setdiff1d(np.arange(n), idx)
    for new, old in ((nt, table), (nm, m_tab), (nv, v_tab)):
        assert new[untouched].tobytes() == old[untouched].tobytes()
    rng2 = np.random.default_rng(4)
    assert table.tobytes() == rng2.normal(size=(n, d)).astype(np.float32).tobytes()


#: (N, D, R, idx dtype) of the table-resident form: the reference test's
#: shape, and the fold's widest micro-batch at rank 32 against a table
INDEXED = ((64, 9, 12, np.int32), (1000, 33, 512, np.int64),
           (300, 17, 37, np.int64))


@pytest.mark.parametrize("n,d,r,idx_dtype", INDEXED,
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_indexed_plain_vs_jax_interpret(n, d, r, idx_dtype):
    """K3's indexed entry on CPU tensors (its plain version, through
    ``fused_gather_adam_scatter``) against the JAX table-resident engine
    with its Pallas kernel in interpret mode: touched rows bitwise, else
    within the reference's band; untouched rows and the inputs unchanged."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n + d)
    tabs = [rng.normal(size=(n, d)).astype(np.float32),
            (rng.normal(size=(n, d)) * 0.01).astype(np.float32),
            np.abs(rng.normal(size=(n, d)) * 1e-4).astype(np.float32)]
    keep = [a.copy() for a in tabs]
    idx = rng.choice(n, r, replace=False).astype(idx_dtype)
    g = rng.normal(size=(r, d)).astype(np.float32)
    bc1, bc2 = tsu.adam_bias_corrections(rng.integers(1, 500, r))
    T = torch.from_numpy
    before = tsu.adam_rows.launches
    got = [a.numpy() for a in tsu.fused_gather_adam_scatter(
        *map(T, tabs), T(idx), T(g), T(bc1), T(bc2), lr=0.05)]
    assert tsu.adam_rows.launches == before  # the plain version: no launch
    want = [np.asarray(a) for a in jsu.fused_gather_adam_scatter(
        *map(jnp.asarray, (*tabs, idx, g, bc1, bc2)), lr=0.05,
        interpret=True)]
    touched = [a[idx] for a in got]
    if any(a.tobytes() != b[idx].tobytes() for a, b in zip(touched, want)):
        _band(touched, [b[idx] for b in want])
    untouched = np.setdiff1d(np.arange(n), idx)
    for new, old, w in zip(got, keep, want):
        assert new[untouched].tobytes() == old[untouched].tobytes()
        assert w[untouched].tobytes() == old[untouched].tobytes()
    for a, b in zip(tabs, keep):
        assert a.tobytes() == b.tobytes()  # the inputs are never mutated


def test_indexed_writes_only_its_rows_and_checks_shapes():
    """``adam_rows_indexed`` writes the touched rows into ``out`` and
    nothing else; the rows equal the stacked step on the gathered rows, bit
    for bit; shapes are checked, and a CPU tensor never reaches the
    launcher."""
    rng = np.random.default_rng(9)
    n, d, r = 40, 6, 7
    tabs = [torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
            for _ in range(3)]
    tabs[2] = tabs[2].abs()
    idx = torch.from_numpy(rng.choice(n, r, replace=False))
    g = torch.from_numpy(rng.normal(size=(r, d)).astype(np.float32))
    bc1, bc2 = (torch.from_numpy(a) for a in
                tsu.adam_bias_corrections(rng.integers(1, 9, r)))
    out = [torch.full((n, d), 7.0) for _ in range(3)]
    tsu.adam_rows_indexed(tabs, idx, g, bc1, bc2, out, 0.05)
    direct = tsu.adam_rows(torch.stack([t[idx] for t in tabs] + [g]),
                           torch.stack([bc1, bc2]), 0.05)
    rest = torch.ones(n, dtype=torch.bool)
    rest[idx] = False
    for o, x in zip(out, direct):
        assert o[idx].numpy().tobytes() == x.numpy().tobytes()
        assert bool((o[rest] == 7.0).all())
    with pytest.raises(ValueError, match="g shape"):
        tsu.adam_rows_indexed(tabs, idx, g[:, :3], bc1, bc2, out, 0.05)
    with pytest.raises(ValueError, match="bc2 shape"):
        tsu.adam_rows_indexed(tabs, idx, g, bc1, bc2[:3], out, 0.05)
    with pytest.raises(ValueError, match="m_out shape"):
        tsu.adam_rows_indexed(tabs, idx, g, bc1, bc2,
                              (out[0], out[1][:5], out[2]), 0.05)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            tsu._launch_adam_rows_indexed(tabs, idx, g, bc1, bc2, out,
                                          0.05, 0.9, 0.999, 1e-8)


def test_device_engine_staging_bitwise_and_reused(monkeypatch):
    """The device engine on ``device="cpu"`` through its staging buffers:
    bitwise the host pass at growing and shrinking sizes; the buffers grow
    on demand and are reused, and a result never aliases them (an earlier
    result survives the next call)."""
    monkeypatch.setattr(tsu, "_STAGING", {})
    results = []
    for i, shape in enumerate(((5, 4), (512, 33), (37, 17), (512, 33))):
        rows, m, v, g, t = _stack_problem(*shape, seed=10 + i)
        got = tsu.fused_adam_rows_device(rows, m, v, g, t, lr=0.05,
                                         device="cpu")
        want = tsu.fused_adam_rows(rows, m, v, g, t, lr=0.05)
        _bitwise(got, want)
        results.append((got, [a.copy() for a in want]))
        st = tsu._STAGING[torch.device("cpu")]
        r, d = shape
        assert st.up.numel() >= 4 * r * d + 2 * r
        assert st.down.numel() >= 3 * r * d
        assert st.dev is None  # no device buffer for the CPU
        if i == 1:
            grown = (st.up.data_ptr(), st.down.data_ptr())
        if i > 1:  # smaller and equal sizes reuse the grown buffers
            assert (st.up.data_ptr(), st.down.data_ptr()) == grown
    for got, want in results:
        _bitwise(got, want)


# -- the fold, both packages on the same events -----------------------------------


def _tables(n_users=6, n_items=8, rank=4, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n_users, rank)) * 0.3).astype(np.float32),
            np.zeros(n_users, np.float32),
            (rng.normal(size=(n_items, rank)) * 0.3).astype(np.float32),
            np.zeros(n_items, np.float32),
            2.5,
            {f"u{i}": i for i in range(n_users)},
            {f"i{j}": j for j in range(n_items)})


def _port_trainer(**kw):
    return ttr.DeltaTrainer(*_tables(), learning_rate=0.05, reg=1e-4,
                            device="cpu", **kw)


def _jax_trainer(**kw):
    return jtr.DeltaTrainer(*_tables(), learning_rate=0.05, reg=1e-4, **kw)


def _events(cls, data_map, spec):
    return [cls(event="rate", entity_type="user", entity_id=u,
                target_entity_type="item", target_entity_id=i,
                properties=data_map({"rating": r}),
                event_time=T0 + dt.timedelta(minutes=k))
            for k, (u, i, r) in enumerate(spec)]


#: duplicate keys inside a batch (u0 twice, i1 twice), a poison event, and
#: a second fold that re-touches rows so their step counts pass 1
FOLD1 = [("u0", "i1", 4.0), ("u0", "i2", 2.0), ("u1", "i3", "five stars"),
         ("u3", "i1", 5.0), ("u2", "i7", 1.0)]
FOLD2 = [("u0", "i1", 3.0), ("u5", "i6", 4.0)]


def _fold_both(monkeypatch, port_mode, jax_mode="0", micro_batch=256):
    out = {}
    for name, make, cls, dm in (("port", _port_trainer, Event, DataMap),
                                ("jax", _jax_trainer, JEvent, JDataMap)):
        monkeypatch.setenv("PIO_STREAM_FUSED",
                           port_mode if name == "port" else jax_mode)
        tr = make(micro_batch=micro_batch)
        r1, p1 = tr.fold(_events(cls, dm, FOLD1))
        r2, p2 = tr.fold(_events(cls, dm, FOLD2))
        out[name] = (tr, (r1, p1, r2, p2))
    return out["port"], out["jax"]


@pytest.mark.parametrize("mode", ["0", "1", "auto"])
def test_fold_modes_bitwise_jax(mode, monkeypatch):
    (pt, (pr1, pp1, pr2, _)), (jt, (jr1, jp1, jr2, _)) = _fold_both(
        monkeypatch, mode)
    assert len(pp1) == len(jp1) == 1  # the bad apple dead-letters
    assert pr1.n_folded == jr1.n_folded == 4
    assert pr1.max_event_time_us == jr1.max_event_time_us
    assert set(pt.rows) == set(jt.rows)
    assert pt.t == jt.t and any(t == 2 for t in pt.t.values())
    for key in jt.rows:
        for got, want in ((pt.rows, jt.rows), (pt.m, jt.m), (pt.v, jt.v)):
            assert got[key].tobytes() == want[key].tobytes(), key
    for side in ("user_rows", "item_rows"):
        got, want = getattr(pr2, side), getattr(jr2, side)
        assert set(got) == set(want)
        for idx in want:
            assert got[idx].tobytes() == want[idx].tobytes()
    assert set(pt.last_phases) == {"assemble", "compute", "gather"}


def test_fold_device_mode_cpu_band_and_t_exact(monkeypatch):
    """``device`` on a CPU trainer runs K3's plain version: within the
    band of the JAX per-row loop (bitwise in fact), step counts exact."""
    (pt, _), (jt, _) = _fold_both(monkeypatch, "device", micro_batch=2)
    assert set(pt.rows) == set(jt.rows)
    assert pt.t == jt.t
    for key in jt.rows:
        _band((pt.rows[key], pt.m[key], pt.v[key]),
              (jt.rows[key], jt.m[key], jt.v[key]))


def test_auto_resolves_by_the_trainers_device(monkeypatch):
    """``auto`` (the default) is the host fused pass on any trainer device,
    a CUDA trainer included, as in the JAX trainer; ``device`` takes the
    device engine (stubbed onto the CPU here)."""
    monkeypatch.delenv("PIO_STREAM_FUSED", raising=False)
    assert ttr.fused_fold_mode() == "auto"
    calls = []
    real = tsu.fused_adam_rows_device
    monkeypatch.setattr(tsu, "fused_adam_rows_device",
                        lambda *a, **k: calls.append(k["device"]) or real(
                            *a, **{**k, "device": "cpu"}))
    host = []
    real_host = tsu.fused_adam_rows
    monkeypatch.setattr(tsu, "fused_adam_rows",
                        lambda *a, **k: host.append(1) or real_host(*a, **k))
    before = stream_metrics.FUSED_STEPS.value
    tr = _port_trainer()
    tr.fold(_events(Event, DataMap, [("u0", "i1", 4.0)]))
    assert calls == [] and host == [1]
    assert stream_metrics.FUSED_STEPS.value == before + 1
    tr.device = torch.device("cuda")  # a CUDA trainer: still the host pass
    tr.fold(_events(Event, DataMap, [("u0", "i1", 4.0)]))
    assert calls == [] and host == [1, 1]
    monkeypatch.setenv("PIO_STREAM_FUSED", "auto")
    tr.fold(_events(Event, DataMap, [("u0", "i1", 4.0)]))
    assert calls == [] and host == [1, 1, 1]
    monkeypatch.setenv("PIO_STREAM_FUSED", "device")
    tr.fold(_events(Event, DataMap, [("u0", "i1", 4.0)]))
    assert calls == [torch.device("cuda")] and host == [1, 1, 1]
    monkeypatch.setenv("PIO_STREAM_FUSED", "0")
    tr.fold(_events(Event, DataMap, [("u0", "i1", 4.0)]))
    assert stream_metrics.FUSED_STEPS.value == before + 4
    monkeypatch.setenv("PIO_STREAM_FUSED", "turbo")
    with pytest.raises(ValueError, match="PIO_STREAM_FUSED"):
        ttr.fused_fold_mode()


def test_auto_folds_like_the_jax_trainer_on_a_cuda_trainer(monkeypatch):
    """A CUDA-labelled trainer under ``auto`` folds bitwise as the JAX
    trainer under ``auto`` (its host pass) and never calls the device
    engine."""
    monkeypatch.setattr(tsu, "fused_adam_rows_device", lambda *a, **k: (
        pytest.fail("auto took the device engine")))
    monkeypatch.delenv("PIO_STREAM_FUSED", raising=False)
    pt = _port_trainer()
    pt.device = torch.device("cuda")
    jt = _jax_trainer()
    for tr, cls, dm in ((pt, Event, DataMap), (jt, JEvent, JDataMap)):
        tr.fold(_events(cls, dm, FOLD1))
        tr.fold(_events(cls, dm, FOLD2))
    assert pt.t == jt.t and set(pt.rows) == set(jt.rows)
    for key in jt.rows:
        for got, want in ((pt.rows, jt.rows), (pt.m, jt.m), (pt.v, jt.v)):
            assert got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("coldstart", ["off", "hash"])
def test_state_carried_across_from_the_jax_trainer(coldstart, monkeypatch):
    """Fold N events in the JAX trainer, carry its state to the port with
    ``convert.trainer_state_from_reference``, fold M more in both: every
    row, moment and step count bitwise; cold-start buckets included."""
    monkeypatch.setenv("PIO_STREAM_FUSED", "1")
    monkeypatch.setenv("PIO_COLDSTART_MODE", coldstart)
    first = [("u0", "i1", 4.0), ("stranger", "i2", 3.0), ("u2", "new", 2.0),
             ("u1", "i4", 5.0)]
    then = [("u0", "i1", 1.0), ("stranger", "i4", 4.5), ("u3", "i5", 3.0)]
    jt = _jax_trainer()
    jt.fold(_events(JEvent, JDataMap, first))
    pt = _port_trainer()
    pt.load_state(convert.trainer_state_from_reference(jt.to_state()))
    jr, _ = jt.fold(_events(JEvent, JDataMap, then))
    pr, _ = pt.fold(_events(Event, DataMap, then))
    assert pt.n_folded == jt.n_folded
    assert pt.t == jt.t and set(pt.rows) == set(jt.rows)
    for key in jt.rows:
        for got, want in ((pt.rows, jt.rows), (pt.m, jt.m), (pt.v, jt.v)):
            assert got[key].tobytes() == want[key].tobytes(), key
    for side in ("user_rows", "item_rows", "cold_user_rows", "cold_item_rows"):
        assert {k: v.tobytes() for k, v in getattr(pr, side).items()} == \
            {k: v.tobytes() for k, v in getattr(jr, side).items()}
    if coldstart == "hash":
        assert pr.cold_user_rows and pt.coldstart is not jt.coldstart
        assert pt.coldstart.user_rows.tobytes() == jt.coldstart.user_rows.tobytes()
    else:
        assert pt.coldstart is None


@pytest.mark.cuda
def test_k3_on_the_card_matches_its_plain_version():
    """K3 against its plain version on the card (bitwise, or the band)."""
    if not torch.cuda.is_available():
        pytest.skip("K3 runs on an NVIDIA card only; chip_smoke.py checks it")
    for shape in ((1, 33), *SHAPES, (4096, 33)):
        rows, m, v, g, t = _stack_problem(*shape, seed=2)
        before = tsu.adam_rows.launches
        got = tsu.fused_adam_rows_device(rows, m, v, g, t, lr=0.05)
        assert tsu.adam_rows.launches == before + 1
        _band(got, tsu.fused_adam_rows(rows, m, v, g, t, lr=0.05))


@pytest.mark.cuda
def test_k3_indexed_on_the_card_matches_its_plain_version():
    """K3's indexed entry (``fused_gather_adam_scatter``) on the card
    against the same call on CPU tensors: one launch, the new tables
    bitwise (or in the band), the inputs untouched."""
    if not torch.cuda.is_available():
        pytest.skip("K3 runs on an NVIDIA card only; chip_smoke.py checks it")
    for n, d, r, idx_dtype in INDEXED:
        rng = np.random.default_rng(n)
        tabs = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(3)]
        tabs[2] = np.abs(tabs[2])
        idx = rng.choice(n, r, replace=False).astype(idx_dtype)
        g = rng.normal(size=(r, d)).astype(np.float32)
        bc = tsu.adam_bias_corrections(rng.integers(1, 500, r))
        args = (*tabs, idx, g, *bc)
        want = tsu.fused_gather_adam_scatter(*map(torch.from_numpy, args), lr=0.05)
        dev = [torch.from_numpy(a).cuda() for a in args]
        before = tsu.adam_rows.launches
        got = tsu.fused_gather_adam_scatter(*dev, lr=0.05)
        assert tsu.adam_rows.launches == before + 1
        _band([a.cpu().numpy() for a in got], [a.numpy() for a in want])
        for t, a in zip(dev, tabs):
            assert t.cpu().numpy().tobytes() == a.tobytes()
