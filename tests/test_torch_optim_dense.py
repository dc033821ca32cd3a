"""PyTorch port, the two-tower trainer's dense adam on the CPU:
``utils/optim.py:adam_tree_init`` / ``adam_apply`` against the JAX
package's, 25 steps on the same numpy gradients, fp32 and bf16 moments.

Tolerances, with their reasons:
- parameters: rtol 2e-6 / atol 2e-7, the reference's own band for its
  adam against optax (tests/test_optim_parity.py:44). Both run the same
  fp32 operations in the same order; the bias corrections ``1 - b^t``
  come from numpy's ``powf`` in the port and XLA's ``pow`` in JAX, which
  may differ by an ulp.
- moments: fp32 moments within the same band; bf16 moments bitwise equal
  or within 1 bf16 ulp (an ulp-level difference in the fp32 value can
  flip its round-to-nearest-even).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.utils import optim as joptim  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.utils import optim as toptim  # noqa: E402

SHAPES = {"ue": (17, 5), "ie": (9, 5)}
LR = 3e-2


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in bf16 ulps between two bf16-valued fp32 arrays."""
    ia = (a.astype(np.float32).view(np.int32) >> 16).astype(np.int64)
    ib = (b.astype(np.float32).view(np.int32) >> 16).astype(np.int64)
    # order-preserving map of sign-magnitude onto a line
    ia = np.where(ia < 0, -(ia & 0x7FFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFF), ib)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adam_apply_matches_jax_adam_apply(moments):
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = joptim.adam_tree_init(jp, moments)
    tp = [torch.from_numpy(init[k].copy()) for k in ("ue", "ie")]
    tstate = toptim.adam_tree_init(tp, moments)
    want_dtype = torch.bfloat16 if moments == "bfloat16" else torch.float32
    assert all(m.dtype == want_dtype for m in tstate.m + tstate.v)
    for step in range(25):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
        jp, jstate = joptim.adam_apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                       jstate, LR)
        toptim.adam_apply(tp, [torch.from_numpy(g[k].copy()) for k in ("ue", "ie")],
                          tstate, LR)
        assert tstate.count == int(jstate[0]) == step + 1
        for i, k in enumerate(("ue", "ie")):
            np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]),
                                       rtol=2e-6, atol=2e-7,
                                       err_msg=f"step {step} {k}")
            for name, got, want in (("m", tstate.m[i], jstate[1][k]),
                                    ("v", tstate.v[i], jstate[2][k])):
                got = got.float().numpy()
                want = np.asarray(want, np.float32)
                if moments == "float32":
                    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7,
                                               err_msg=f"step {step} {k} {name}")
                else:
                    assert _bf16_ulps(got, want) <= 1, (step, k, name)
    # the state converts across: the port continues from the JAX state
    conv = convert.adam_state_from_jax(
        (np.asarray(jstate[0]), {k: np.asarray(v) for k, v in jstate[1].items()},
         {k: np.asarray(v) for k, v in jstate[2].items()}))
    assert conv.count == 25
    for i, k in enumerate(("ue", "ie")):
        assert conv.m[i].dtype == want_dtype
        np.testing.assert_array_equal(conv.m[i].float().numpy(),
                                      np.asarray(jstate[1][k], np.float32))


def test_adam_apply_updates_in_place_and_keeps_its_scratch():
    """The tables, the moments and the scratch buffers are the same
    tensors after a step: no table is allocated anew."""
    p = [torch.zeros(6, 3), torch.zeros(4, 3)]
    state = toptim.adam_tree_init(p, "bfloat16")
    ptrs = [t.data_ptr() for t in p + state.m + state.v]
    toptim.adam_apply(p, [torch.ones(6, 3), torch.ones(4, 3)], state, 1e-2)
    scratch = [t.data_ptr() for buf in state.scratch for t in buf]
    toptim.adam_apply(p, [torch.ones(6, 3), torch.ones(4, 3)], state, 1e-2)
    assert [t.data_ptr() for t in p + state.m + state.v] == ptrs
    assert [t.data_ptr() for buf in state.scratch for t in buf] == scratch
    assert len(state.scratch) == 2  # bf16 moments: two fp32 work buffers
    # every element moved by about lr: adam's first steps on a unit gradient
    np.testing.assert_allclose(p[0].numpy(), -2e-2, rtol=1e-3)


def test_adam_tree_init_refuses_an_unknown_dtype():
    with pytest.raises(ValueError, match="adam_moments_dtype"):
        toptim.adam_tree_init([torch.zeros(2)], "float16")
