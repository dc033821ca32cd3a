"""PyTorch port, ring attention over the ``seq`` mesh axis on the CPU: every
test of tests/test_ring_attention.py held to the port's ring
(``parallel/ring.py``) on ``ThreadMesh({"data": 2, "seq": 4})``, the port's
ring against the JAX package's ``ring_attention_sharded`` on the 8-device
CPU mesh, ``DeviceContext.ppermute`` and its backward over real gloo
processes, the ring fit on ``{"data": 2, "seq": 2}`` against the JAX fit
on the same mesh, a ring fit resumed from its checkpoints, and ``launch -n
2 train --mesh-axes '{"seq": 2}'`` through the CLI, which refuses with the
reference's text.

The in-process cases run the processes of a mesh as threads
(tests/test_torch_tensor_parallel.py's ``ThreadMesh``, whose ``ppermute``
hands each member what the member ``shift`` places back on its line sent).

Tolerances, with their reasons:
- the ring against the single-device oracle (``causal_attention_reference``):
  2e-2, the reference's own band (test_ring_attention.py:32-33): the
  online softmax rounds p to bf16 unnormalised, the oracle normalised.
- the port's ring against the JAX ring, the same arithmetic in another
  summation order: the output within 1e-3 (measured at most 2.4e-7 at L
  32; 1.7e-4 at L 512, in 37 of 65,536 elements, where a p rounds to the
  other neighbouring bf16 value) and each gradient within 1e-3 of its max
  abs (measured at most 2.2e-4, the same rounding in a cotangent). A ring
  that rotates the wrong way misses by 2.2; one that masks its own chunk
  fully gives NaN (the reference's arithmetic: its guard keeps alpha
  finite, not p, so a row with nothing to attend divides 0 by 0).
- the gradients against the oracle's: 5e-2, the reference's band
  (test_ring_attention.py:68).
- the ring fit against the JAX ring fit on ``{"data": 2, "seq": 2}``,
  from one initial tree with random biases and norms: every step's loss
  1e-4 relative (the band of tests/test_torch_tensor_parallel.py and
  tests/test_torch_moe.py; measured at most 5.7e-5), every parameter within
  0.3 of the JAX fit's update (measured 0.081, a layer norm's gain: adam's
  first steps move an element by about ``lr·sign(g)``, so a gradient near
  0 may step either way in either package). A fit whose ring masks its own
  chunk fully trains to NaN.
- the ring fit against a one-process fit with ``attention="local"`` on
  the plain attention (the comparison ``chip_smoke.py`` makes on the
  card): every step's loss 1e-3 relative (measured 5.2e-5: the ring rounds
  p to bf16 unnormalised, the plain attention normalised).
"""

import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.models import transformer as jtr  # noqa: E402
from incubator_predictionio_tpu.parallel import ring as jring  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu_torch.models import transformer as ttr  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import launcher  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import ring as tring  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import (  # noqa: E402
    DeviceContext,
    ppermute,
)

from tests.test_torch_dist_procs import _store  # noqa: E402
from tests.test_torch_evaluation import APPS  # noqa: E402
from tests.test_torch_tensor_parallel import (  # noqa: E402
    ThreadMesh,
    _random_biases,
    _sequences,
)

CPU = DeviceContext.create(device="cpu")
AXES = {"data": 2, "seq": 4}
ORACLE_TOL = 2e-2
ORACLE_GRAD_TOL = 5e-2
JAX_TOL = 1e-3
JAX_GRAD_TOL = 1e-3
FIT_LOSS_RTOL = 1e-4
FIT_UPDATE_RTOL = 0.3
LOCAL_LOSS_RTOL = 1e-3
LAUNCH_TIMEOUT = 120.0


def make_qkv(b=4, l=32, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, l, h, d)).astype(np.float32)
                 for _ in range(3))


def _blocks(axes, b, l):
    """Each member's ``(rows, positions)`` slices of ``[b, l]``."""
    dp, sp = axes.get("data", 1), axes.get("seq", 1)

    def of(ctx):
        d, s = ctx.axis_index("data"), ctx.axis_index("seq")
        return (slice(d * b // dp, (d + 1) * b // dp),
                slice(s * l // sp, (s + 1) * l // sp))

    return of


def port_ring(q, k, v, axes=AXES, grad=False):
    """The port's ring on ``axes`` (threads as processes), each member on
    its block of the numpy ``[B, L, H, D]`` inputs; the blocks joined.
    With ``grad``: also the gradients of ``Σ out²`` (each member's share)
    w.r.t. q, k, v."""
    b, l = q.shape[:2]
    block = _blocks(axes, b, l)

    def member(ctx):
        rows, cols = block(ctx)
        qc, kc, vc = (torch.from_numpy(np.ascontiguousarray(x[rows, cols]))
                      .requires_grad_(grad) for x in (q, k, v))
        out = tring.ring_attention_sharded(qc, kc, vc, ctx)
        grads = None
        if grad:
            (out ** 2).sum().backward()
            grads = [x.grad.numpy() for x in (qc, kc, vc)]
        return rows, cols, out.detach().numpy(), grads

    out = np.zeros_like(q)
    grads = [np.zeros_like(q) for _ in range(3)]
    for rows, cols, o, g in ThreadMesh(axes).run(member):
        out[rows, cols] = o
        for whole, part in zip(grads, g or []):
            whole[rows, cols] = part
    return (out, grads) if grad else out


def jax_ring(q, k, v, axes=AXES):
    ctx = MeshContext.create(axes=axes, devices=jax.devices()[:8])
    sh = ctx.sharding("data", "seq", None, None)
    return jring.ring_attention_sharded(
        *(jax.device_put(jnp.asarray(x), sh) for x in (q, k, v)), ctx.mesh)


def jax_ring_grads(q, k, v, axes=AXES):
    ctx = MeshContext.create(axes=axes, devices=jax.devices()[:8])
    sh = ctx.sharding("data", "seq", None, None)

    @jax.jit
    def loss(q, k, v):
        return jnp.sum(jring.ring_attention_sharded(q, k, v, ctx.mesh) ** 2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jax.device_put(jnp.asarray(x), sh) for x in (q, k, v)))]


def oracle(q, k, v):
    return tring.causal_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v))).numpy()


def test_matches_reference():
    """test_ring_attention.py:24: the ring against the single-device
    oracle, and against the JAX ring on the same mesh."""
    q, k, v = make_qkv()
    got = port_ring(q, k, v)
    np.testing.assert_allclose(got, oracle(q, k, v), rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ring(q, k, v)),
                               rtol=JAX_TOL, atol=JAX_TOL)


def test_causality():
    """test_ring_attention.py:35: changing future tokens does not change
    past outputs."""
    q, k, v = make_qkv(seed=1)
    out1 = port_ring(q, k, v)
    k2, v2 = k.copy(), v.copy()
    k2[:, 20:] = 99.0
    v2[:, 20:] = -7.0
    out2 = port_ring(q, k2, v2)
    np.testing.assert_allclose(out1[:, :20], out2[:, :20], rtol=1e-5, atol=1e-5)
    assert not np.allclose(out1[:, 21:], out2[:, 21:])


def test_first_token_attends_itself():
    q, k, v = make_qkv(seed=2)
    out = port_ring(q, k, v)
    np.testing.assert_allclose(out[:, 0], v[:, 0], rtol=1e-2, atol=1e-2)


def test_gradients_match_the_jax_ring_and_the_oracle():
    """test_ring_attention.py:52: the ring is differentiable (the K/V
    rotations' backward is the reverse shift); its gradients against the
    JAX ring's and the oracle's."""
    q, k, v = make_qkv(b=2, l=16, h=1, d=4, seed=3)
    _, got = port_ring(q, k, v, grad=True)
    want = jax_ring_grads(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (tring.causal_attention_reference(qt, kt, vt) ** 2).sum().backward()
    for g, w, ref in zip(got, want, (qt.grad, kt.grad, vt.grad)):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= JAX_GRAD_TOL * np.abs(w).max()
        np.testing.assert_allclose(g, ref.numpy(), rtol=ORACLE_GRAD_TOL,
                                   atol=ORACLE_GRAD_TOL)


def test_long_context_matches_reference():
    """test_ring_attention.py:71: L 512 over a 4-way seq axis (chunks of
    128), against the oracle and the JAX ring."""
    q, k, v = make_qkv(b=2, l=512, h=4, d=16, seed=3)
    got = port_ring(q, k, v)
    np.testing.assert_allclose(got, oracle(q, k, v), rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ring(q, k, v)),
                               rtol=JAX_TOL, atol=JAX_TOL)


def _own_chunk_masked(real):
    """``_chunk_attend`` with the own chunk's causal mask made all -inf (a
    planted fault)."""
    def attend(q, k, v, mask, m, l, o):
        inf = torch.isinf(mask)
        if bool(inf.any()) and not bool(inf.all()):
            mask = torch.full_like(mask, -torch.inf)
        return real(q, k, v, mask, m, l, o)

    return attend


def test_planted_faults_miss_the_band(monkeypatch):
    """A ring that rotates the wrong way lands far outside the band against
    the JAX ring; one that masks its own chunk fully gives NaN (a row with
    nothing to attend: the reference's arithmetic guards alpha, not p)."""
    q, k, v = make_qkv(seed=4)
    want = np.asarray(jax_ring(q, k, v))
    real = tring.ppermute
    monkeypatch.setattr(tring, "ppermute", lambda mesh, t, axis, shift=1, cyclic=True:
                        real(mesh, t, axis, -shift, cyclic))
    assert np.abs(port_ring(q, k, v) - want).max() > 100 * JAX_TOL
    monkeypatch.setattr(tring, "ppermute", real)
    monkeypatch.setattr(tring, "_chunk_attend", _own_chunk_masked(tring._chunk_attend))
    assert not np.isfinite(port_ring(q, k, v)).all()


def test_without_a_seq_axis_raises_naming_it():
    q, k, v = (torch.from_numpy(x) for x in make_qkv())
    with pytest.raises(ValueError, match="'seq' axis"):
        tring.ring_attention_sharded(q, k, v, CPU)
    with pytest.raises(ValueError, match="'seq' axis"):
        ttr.TransformerRecommender(ttr.TransformerConfig(
            vocab_size=16, max_len=8, d_model=16, n_layers=1, batch_size=8,
            epochs=1, attention="ring")).fit(CPU, np.ones((8, 9), np.int32), None)


# -- ppermute ---------------------------------------------------------------

@pytest.mark.parametrize("shift,cyclic", [(1, True), (-1, True), (2, True),
                                          (1, False), (-1, False)])
def test_ppermute_peers(shift, cyclic):
    """Every process's peers on a ``{"data": 2, "seq": 3}`` mesh: along
    its ``seq`` line (global ranks 3d … 3d + 2), the ring ``[(i, (i +
    shift) % 3)]``, or its partial form, as ``jax.lax.ppermute``'s."""
    for rank in range(6):
        ctx = DeviceContext(torch.device("cpu"), rank, 6,
                            axes={"data": 2, "seq": 3})
        d, i = divmod(rank, 3)
        to, frm = ctx.ppermute_peers("seq", shift, cyclic)
        if cyclic:
            assert (to, frm) == (3 * d + (i + shift) % 3, 3 * d + (i - shift) % 3)
        else:
            assert to == (3 * d + i + shift if 0 <= i + shift < 3 else None)
            assert frm == (3 * d + i - shift if 0 <= i - shift < 3 else None)
    assert torch.equal(CPU.ppermute(torch.arange(3.0), "seq"), torch.arange(3.0))


def _ppermute_worker(rank, port, out):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    try:
        ctx = DeviceContext(torch.device("cpu"), rank, 4, "gloo",
                            {"data": 2, "seq": 2})
        ctx._init_groups()
        t = torch.full((2, 3), float(rank), dtype=torch.bfloat16)
        got = {"seq": ctx.ppermute(t, "seq").float().tolist(),
               "data_open": ctx.ppermute(t, "data", 1, cyclic=False).float().tolist()}
        x = torch.full((2,), float(rank + 1), requires_grad=True)
        y = ppermute(ctx, x, "seq")
        (y * (10.0 * (rank + 1))).sum().backward()
        got["value"] = y.detach().tolist()
        got["grad"] = x.grad.tolist()
        out.put((rank, got))
    finally:
        dist.destroy_process_group()


def test_ppermute_over_gloo():
    """``DeviceContext.ppermute`` between four gloo processes on a
    ``{"data": 2, "seq": 2}`` mesh (the lines' subgroups): along ``seq``
    each process gets its line partner's bf16 tensor; along ``data``
    without wrap-around the first row of the mesh gets zeros; the
    differentiable form's gradient comes back the way the value came."""
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    port = launcher.free_port()
    mp.start_processes(_ppermute_worker, args=(port, queue), nprocs=4,
                       start_method="spawn")
    got = dict(queue.get() for _ in range(4))
    partner = {0: 1, 1: 0, 2: 3, 3: 2}  # rank -> its seq-line partner
    for r in range(4):
        g = got[r]
        assert g["seq"] == [[float(partner[r])] * 3] * 2
        below = r - 2 if r >= 2 else None  # the data line: ranks r % 2, r % 2 + 2
        assert g["data_open"] == [[float(below if below is not None else 0)] * 3] * 2
        assert g["value"] == [float(partner[r] + 1)] * 2
        # x's value went to the partner, whose loss weighs it 10·(partner+1)
        assert g["grad"] == [10.0 * (partner[r] + 1)] * 2


# -- the ring fit -------------------------------------------------------------

def _fit_cfg(**kw):
    base = dict(vocab_size=64, max_len=8, d_model=16, n_heads=2, n_layers=2,
                batch_size=16, epochs=3, seed=0, learning_rate=5e-3)
    base.update(kw)
    return base


def _same_init(monkeypatch, cfg):
    init = _random_biases(ttr.init_params_numpy(ttr.TransformerConfig(**cfg), 5), 7)
    monkeypatch.setattr(jtr, "_jit_init_fn", lambda c: (
        lambda key: jax.tree.map(jnp.asarray, init)))
    monkeypatch.setattr(ttr, "_init_params", lambda c, generator, device: init)
    return init


def _ring_fit(axes, cfg, seqs):
    return ThreadMesh(axes).run(lambda ctx: ttr.TransformerRecommender(
        ttr.TransformerConfig(**cfg)).fit(ctx, seqs, None))


def test_ring_fit_matches_the_jax_fit(monkeypatch):
    """The ring fit over ``{"data": 2, "seq": 2}`` (threads as processes;
    ``attention="auto"`` takes the ring on a seq axis) against the JAX
    package's fit on its mesh of the same axes, from one initial tree:
    every step's loss, the parameters, the processes' models equal; the
    one-process fit with local attention; a planted fault (the own chunk
    masked fully) trains to NaN."""
    cfg = _fit_cfg()
    init = _same_init(monkeypatch, cfg)
    seqs = _sequences()[:16]  # one batch of 16: a step an epoch
    seqs[:5, :3] = 0
    models = _ring_fit({"data": 2, "seq": 2}, cfg, seqs)
    got = models[0]
    for other in models[1:]:
        for a, b in zip(ttr._leaves(got.params), ttr._leaves(other.params)):
            np.testing.assert_array_equal(a, b)
    assert got.timings["rotation_sec"] >= 0
    mesh = MeshContext.create(axes={"data": 2, "seq": 2}, devices=jax.devices()[:4])
    for epochs in (1, 2, 3):
        want = jtr.TransformerRecommender(jtr.TransformerConfig(
            **{**cfg, "epochs": epochs})).fit(mesh, seqs, None)
        np.testing.assert_allclose(got.step_losses[epochs - 1, 0],
                                   want.final_loss, rtol=FIT_LOSS_RTOL,
                                   err_msg=f"step {epochs}")
    jflat, jtree = jax.tree.flatten(jax.tree.map(np.asarray, want.params))
    tflat, ttree = jax.tree.flatten(got.params)
    assert jtree == ttree
    for a, b, p0 in zip(tflat, jflat, jax.tree.flatten(init)[0]):
        moved = np.linalg.norm((b - p0).astype(np.float64))
        assert moved > 0
        assert np.linalg.norm((a - b).astype(np.float64)) <= FIT_UPDATE_RTOL * moved
    local = ttr.TransformerRecommender(ttr.TransformerConfig(
        **cfg, attention="local")).fit(CPU, seqs, None)
    np.testing.assert_allclose(got.step_losses, local.step_losses,
                               rtol=LOCAL_LOSS_RTOL)
    monkeypatch.setattr(tring, "_chunk_attend", _own_chunk_masked(tring._chunk_attend))
    bad = _ring_fit({"data": 2, "seq": 2}, cfg, seqs)[0]
    assert not np.isfinite(bad.step_losses).all()


def test_ring_fit_resumes_from_its_checkpoints(tmp_path):
    """A ring fit keeps replicated parameters, so its checkpoints take the
    plain multi-process path (the primary writes): a fit of 1 epoch, then
    the same fit of 3 epochs resumed from its checkpoint, ends bitwise the
    uninterrupted 3-epoch fit."""
    cfg = _fit_cfg(checkpoint_every=1)
    seqs = _sequences()[:16]
    straight = _ring_fit({"seq": 2}, cfg, seqs)[0]
    ck = str(tmp_path / "ck")
    _ring_fit({"seq": 2}, {**cfg, "epochs": 1, "checkpoint_dir": ck}, seqs)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir())
    resumed = _ring_fit({"seq": 2}, {**cfg, "checkpoint_dir": ck}, seqs)
    assert resumed[0].step_losses.shape[0] == 2  # epochs 2 and 3 ran
    np.testing.assert_array_equal(resumed[0].step_losses, straight.step_losses[1:])
    for m in resumed:
        for a, b in zip(ttr._leaves(m.params), ttr._leaves(straight.params)):
            np.testing.assert_array_equal(a, b)


def test_ring_choice_and_refusals():
    """``_use_ring`` (reference :416-421) and the refusals: per-process rows
    with the ring raise the reference's ValueError; a mixture of experts
    with the ring is not ported."""
    seq = DeviceContext(torch.device("cpu"), 0, 2, axes={"seq": 2})
    rec = ttr.TransformerRecommender
    assert rec(ttr.TransformerConfig(attention="auto"))._use_ring(seq)
    assert not rec(ttr.TransformerConfig(attention="local"))._use_ring(seq)
    assert rec(ttr.TransformerConfig(attention="ring"))._use_ring(CPU)
    assert not rec(ttr.TransformerConfig(attention="auto"))._use_ring(CPU)
    rows = np.ones((8, 9), np.int32)
    cfg = ttr.TransformerConfig(**_fit_cfg())
    with pytest.raises(ValueError, match=r"^rows_are_local training does not "
                       r"compose with ring \(sequence-parallel\) attention; use "
                       r"attention='local'$"):
        rec(cfg).fit(seq, rows, None, rows_are_local=True)
    with pytest.raises(NotImplementedError, match="mixture of experts with ring"):
        rec(ttr.TransformerConfig(**_fit_cfg(n_experts=2))).fit(seq, rows, None)


def test_cli_launch_seq_axis_refuses_per_process_rows(tmp_path):
    """``launch -n 2 train --mesh-axes '{"seq": 2}'`` of the sequential
    template: the launched read gives each process its rows, and the ring
    refuses them with the reference's ValueError (reference
    transformer.py:467-474), where the port used to train every member of
    the seq line on the same batches with full local attention."""
    env, _ = _store(tmp_path, "seq", APPS["seq"]())
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "seq", "version": "1",
        "engineFactory": "incubator_predictionio_tpu_torch.templates."
                         "sequential.SequentialEngine",
        "datasource": {"params": {"appName": "seq", "maxLen": 8}},
        "algorithms": [{"name": "transformer", "params": {
            "maxLen": 8, "dModel": 16, "nHeads": 2, "nLayers": 1,
            "batchSize": 16, "epochs": 1}}]}))
    out = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
         "launch", "-n", "2", "--cpu-devices-per-process", "1",
         "--coordinator-port", str(launcher.free_port()),
         "--timeout", str(LAUNCH_TIMEOUT), "train", "-v", str(variant),
         "--mesh-axes", '{"seq": 2}'],
        capture_output=True, text=True, env=env, timeout=LAUNCH_TIMEOUT + 30)
    assert out.returncode != 0
    text = out.stdout + out.stderr
    assert ("ValueError: rows_are_local training does not compose with ring "
            "(sequence-parallel) attention; use attention='local'") in text
    assert "data-parallel fit: process" not in text
