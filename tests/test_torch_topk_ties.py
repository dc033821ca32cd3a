"""PyTorch port, models/two_tower.py: the device paths' top-k answers what
``jax.lax.top_k`` answers when scores tie — the k largest by score
descending, then index ascending, and where entries tie at the k-th score
the lowest indices are the ones taken (-inf entries, masked items,
included).

The port's ``_topk_quantized`` (int8 catalog, kernel K1's plain version on
the CPU) and ``_topk_scores`` (bf16 catalog) run beside the JAX package's
on the same numpy inputs. The inputs are small integers and dyadic
fractions, so every score is exact in fp32 whatever the order of the sums:
ids must be equal and scores bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.models import two_tower as jtt  # noqa: E402
from incubator_predictionio_tpu_torch.models import two_tower as ttt  # noqa: E402

N, D, B = 1024, 16, 6  # the int8 catalog pads to 512-row blocks


def _inputs(case: str, seed: int = 0):
    """Towers, mask, row mask and num of one constructed tie case."""
    rng = np.random.default_rng(seed)
    users = rng.integers(-2, 3, (B, D)).astype(np.float32)
    ub = rng.integers(-2, 3, B).astype(np.float32) / 8
    items = rng.integers(-3, 4, (N, D)).astype(np.int8)
    scales = np.full(N, 0.5, np.float32)
    bias = rng.integers(-4, 5, N).astype(np.float32) / 8
    mask = np.zeros(N, np.float32)
    row_mask = None
    num = 12
    if case == "duplicate_rows":
        # a few distinct rows, each many times: ties straddle every place
        distinct = rng.integers(0, 40, N)
        items, bias = items[distinct], bias[distinct]
    elif case == "all_equal":
        items[:] = 1
        bias[:] = 0.25
    elif case == "exclude_beyond_unmasked":
        mask[:] = -np.inf
        mask[rng.choice(N, 5, replace=False)] = 0.0
        num = 20
    elif case == "row_mask":
        row_mask = np.zeros((B, N), np.float32)
        row_mask[rng.random((B, N)) < 0.5] = -np.inf
        row_mask[0, 3:] = -np.inf  # one row with 3 items left for a top-12
        items[:, 1:] = 0           # scores of 7 distinct values only
    return dict(users=users, ub=ub, items=items, scales=scales, bias=bias,
                mask=mask, row_mask=row_mask, num=num)


CASES = ["duplicate_rows", "all_equal", "exclude_beyond_unmasked", "row_mask"]


def _jax(path: str, x):
    uidx = jnp.arange(B, dtype=jnp.int32)
    ue = jnp.asarray(x["users"]).astype(jnp.bfloat16)
    rm = None if x["row_mask"] is None else jnp.asarray(x["row_mask"])
    if path == "int8":
        idx, val = jtt._topk_quantized(
            uidx, ue, jnp.asarray(x["ub"]), jnp.asarray(x["items"]),
            jnp.asarray(x["scales"]), jnp.asarray(x["bias"]),
            jnp.asarray(x["mask"]), rm, 3.0, x["num"])
    else:
        item_t = jnp.asarray((x["items"].astype(np.float32) * x["scales"][:, None]).T
                             ).astype(jnp.bfloat16)
        idx, val = jtt._topk_scores(
            uidx, ue, jnp.asarray(x["ub"]), item_t, jnp.asarray(x["bias"]), 3.0,
            jnp.asarray(x["mask"]), rm, x["num"])
    return np.asarray(idx), np.asarray(val)


def _port(path: str, x):
    uidx = torch.arange(B)
    ue = torch.from_numpy(x["users"]).to(torch.bfloat16)
    rm = None if x["row_mask"] is None else torch.from_numpy(x["row_mask"])
    ub, mask = torch.from_numpy(x["ub"]), torch.from_numpy(x["mask"])
    if path == "int8":
        idx, val = ttt._topk_quantized(
            uidx, ue, ub, torch.from_numpy(x["items"]), torch.from_numpy(x["scales"]),
            torch.from_numpy(x["bias"]), mask, rm, 3.0, x["num"], N)
    else:
        item_t = torch.from_numpy(
            (x["items"].astype(np.float32) * x["scales"][:, None]).T.copy())
        idx, val = ttt._topk_scores(uidx, ue, ub, item_t, torch.from_numpy(x["bias"]),
                                    3.0, mask, rm, x["num"])
    return idx.numpy(), val.numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("path", ["int8", "bf16"])
def test_device_topk_matches_lax_top_k_under_ties(path, case):
    x = _inputs(case)
    gi, gv = _port(path, x)
    wi, wv = _jax(path, x)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))  # bitwise


@pytest.mark.parametrize("case", CASES)
def test_constructed_cases_do_tie_at_the_kth_place(case):
    """Each case has a row where entries beyond the k-th tie with it, so a
    tie order other than the lowest index would show."""
    x = _inputs(case)
    _, wv = _jax("int8", x)
    idx, _ = _port("int8", x)
    deq = x["items"].astype(np.float32) * x["scales"][:, None]
    s = (x["users"] @ deq.T + x["bias"] + x["ub"][:, None] + 3.0 + x["mask"])
    if x["row_mask"] is not None:
        s = s + x["row_mask"]
    kth = wv[:, -1:]
    assert ((s == kth).sum(axis=1) > (wv == kth).sum(axis=1)).any()
    assert idx.shape == (B, x["num"])


def test_straddling_tie_takes_the_lowest_indices():
    scores = torch.tensor([[1.0, 5.0, 3.0, 0.0, 3.0, 3.0, 3.0, 7.0],
                           [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                           [-np.inf, 4.0, -np.inf, -np.inf, 4.0, -np.inf, 1.0, 4.0]])
    vals, idx = ttt._top_k(scores, 4)
    assert idx.tolist() == [[7, 1, 2, 4], [0, 1, 2, 3], [1, 4, 7, 6]]
    assert vals.tolist() == [[7.0, 5.0, 3.0, 3.0], [2.0] * 4, [4.0, 4.0, 4.0, 1.0]]
    vals, idx = ttt._top_k(scores, 6)
    assert idx[2].tolist() == [1, 4, 7, 6, 0, 2]  # the -inf ties, lowest first


@pytest.mark.parametrize("seed", range(4))
def test_top_k_is_lax_top_k_on_random_ties(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(-3, 3, (5, 300)).astype(np.float32)
    s[rng.random(s.shape) < 0.3] = -np.inf
    k = int(rng.integers(1, 300))
    vals, idx = ttt._top_k(torch.from_numpy(s), k)
    wv, wi = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))
    for r in range(s.shape[0]):  # and a lexsort on (-score, index)
        np.testing.assert_array_equal(
            idx[r].numpy(), np.lexsort((np.arange(s.shape[1]), -s[r]))[:k])
