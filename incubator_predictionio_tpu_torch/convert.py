"""Carry a model's weights across from the JAX package.

The port cannot unpickle the JAX package's model blobs (they name its
classes), and it imports nothing of that package. So weights cross as plain
numpy, with the id lists of the model's BiMaps in index order:

- :func:`rec_model_from_arrays`: the reference ``RecModel``'s towers
  (``mf.user_emb``, ``item_emb``, ``user_bias``, ``item_bias``, ``mean``,
  ``config.rank``) → the port's ``RecModel``;
- :func:`transformer_model_from_params`: the reference
  ``TransformerModel``'s parameter pytree → the port's ``TransformerModel``;
- :func:`trainer_state_from_reference`: the reference streaming
  ``DeltaTrainer.to_state()`` → a state the port's ``DeltaTrainer.load_state``
  takes, so a stream continues in the port where it stopped;
- :func:`two_tower_tables_from_jax`: the two-tower trainer's fused
  ``{"ue", "ie"}`` ``[N, rank+1]`` tables → the port's table tensors;
- :func:`adam_state_from_jax`: its adam state ``(count, m, v)`` → the
  port's ``utils/optim.py:AdamTreeState``;
- :func:`mlp_params_from_jax`: the reference ``MLPModel.params`` (a list
  of ``{"w", "b"}``) → the port's parameter list, which ``MLPModel`` and
  ``MLPNet`` take;
- :func:`item_sim_model_from_arrays`, :func:`similar_user_model_from_arrays`
  and :func:`ecomm_model_from_arrays`: the similarproduct,
  recommended-user and e-commerce models over numpy tables.

Both packages then serve (and stream into, and train on from) the same
model.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerModel,
)
from incubator_predictionio_tpu_torch.models.two_tower import (
    TwoTowerConfig,
    TwoTowerModel,
)
from incubator_predictionio_tpu_torch.templates.ecommerce import ECommModel
from incubator_predictionio_tpu_torch.templates.recommendation import RecModel
from incubator_predictionio_tpu_torch.templates.recommended_user import (
    SimilarUserModel,
)
from incubator_predictionio_tpu_torch.templates.similarproduct import ItemSimModel


def rec_model_from_arrays(
    user_emb: np.ndarray,
    item_emb: np.ndarray,
    user_bias: np.ndarray,
    item_bias: np.ndarray,
    mean: float,
    rank: int,
    user_ids: Sequence[str],
    item_ids: Sequence[str],
    learning_rate: float = 3e-2,
    reg: float = 1e-4,
) -> RecModel:
    """The port's RecModel over the given towers; ``user_ids[i]`` names row
    ``i`` of ``user_emb`` (likewise items). ``learning_rate`` and ``reg``
    are the reference config's, which the streaming fold trains with."""
    user_emb = np.ascontiguousarray(user_emb, np.float32)
    item_emb = np.ascontiguousarray(item_emb, np.float32)
    user_bias = np.ascontiguousarray(user_bias, np.float32)
    item_bias = np.ascontiguousarray(item_bias, np.float32)
    if user_emb.shape != (len(user_ids), rank) or \
            item_emb.shape != (len(item_ids), rank):
        raise ValueError(
            f"tower shapes {user_emb.shape}, {item_emb.shape} do not match "
            f"{len(user_ids)} users / {len(item_ids)} items at rank {rank}")
    if user_bias.shape != (len(user_ids),) or item_bias.shape != (len(item_ids),):
        raise ValueError("bias lengths do not match the id lists")
    mf = TwoTowerModel(
        user_emb=user_emb, item_emb=item_emb,
        user_bias=user_bias, item_bias=item_bias,
        mean=float(mean),
        config=TwoTowerConfig(rank=int(rank), learning_rate=float(learning_rate),
                              reg=float(reg)),
    )
    return RecModel(
        mf,
        BiMap({u: i for i, u in enumerate(user_ids)}),
        BiMap({t: i for i, t in enumerate(item_ids)}),
    )


_LAYER_MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2")


def transformer_model_from_params(params: dict, item_ids: Sequence[str],
                                  **config) -> TransformerModel:
    """The port's TransformerModel over the reference's dense parameter
    pytree (``models/transformer.py:84 _init_params``: ``item_emb``,
    ``pos_emb``, ``ln_f{g,b}`` and ``layers[i]{ln1, wq, wk, wv, wo, ln2, w1,
    b1, w2, b2}``) as numpy arrays. ``item_ids[j]`` is the item of token
    ``j + 1`` (token 0 is padding). ``vocab_size``, ``max_len``, ``d_model``
    and ``n_layers`` come from the arrays; ``config`` gives the rest of
    :class:`TransformerConfig` (``n_heads`` at least)."""
    f32 = np.float32
    item_emb = np.ascontiguousarray(params["item_emb"], f32)
    pos_emb = np.ascontiguousarray(params["pos_emb"], f32)
    vocab, d = item_emb.shape
    if vocab != len(item_ids) + 1:
        raise ValueError(f"item_emb has {vocab} rows; {len(item_ids)} item "
                         f"ids + the padding token make {len(item_ids) + 1}")
    if pos_emb.shape[1] != d:
        raise ValueError(f"pos_emb width {pos_emb.shape[1]} != d_model {d}")

    def norm(p):
        return {"g": np.ascontiguousarray(p["g"], f32),
                "b": np.ascontiguousarray(p["b"], f32)}

    layers = []
    for i, layer in enumerate(params["layers"]):
        if "w1" not in layer:
            raise ValueError(f"layer {i} has no dense FFN (w1/w2): "
                             "mixture-of-experts layers are not ported yet")
        out = {name: np.ascontiguousarray(layer[name], f32)
               for name in (*_LAYER_MATRICES, "b1", "b2")}
        out["ln1"], out["ln2"] = norm(layer["ln1"]), norm(layer["ln2"])
        for name in ("wq", "wk", "wv", "wo"):
            if out[name].shape != (d, d):
                raise ValueError(f"layer {i} {name} shape {out[name].shape} "
                                 f"!= ({d}, {d})")
        layers.append(out)
    cfg = TransformerConfig(vocab_size=vocab, max_len=pos_emb.shape[0],
                            d_model=d, n_layers=len(layers), **config)
    if d % cfg.n_heads:
        raise ValueError(f"d_model {d} does not split into {cfg.n_heads} heads")
    return TransformerModel(
        {"item_emb": item_emb, "pos_emb": pos_emb,
         "ln_f": norm(params["ln_f"]), "layers": layers},
        BiMap({iid: j + 1 for j, iid in enumerate(item_ids)}),
        cfg)


def _tensor(a, device, dtype=None):
    """A numpy array (bf16 ones from ml_dtypes included) as a torch tensor
    on ``device``; a bf16 array stays bf16 (widened to fp32 and back,
    both exact)."""
    import torch

    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(a, np.float32, copy=True)).to(device)
    if dtype is not None:
        return t.to(dtype)
    return t.to(torch.bfloat16) if bf16 else t


def two_tower_tables_from_jax(tables: dict, device="cpu") -> tuple:
    """The reference's fused tables (``{"ue": [n_users, rank+1], "ie":
    [n_items, rank+1]}``, the bias in the last column, as numpy) → the
    port's ``(ue, ie)`` fp32 tensors on ``device``, the layout
    ``models/two_tower.py:_init_tables`` returns."""
    import torch

    ue, ie = (_tensor(tables[k], device, torch.float32) for k in ("ue", "ie"))
    if ue.shape[1] != ie.shape[1]:
        raise ValueError(f"table widths differ: ue {tuple(ue.shape)}, "
                         f"ie {tuple(ie.shape)}")
    return ue, ie


def adam_state_from_jax(state, device="cpu"):
    """The reference's ``utils/optim.py`` adam state ``(count, m, v)``,
    ``m`` and ``v`` dicts ``{"ue", "ie"}`` of numpy arrays in the moments'
    storage dtype → the port's ``AdamTreeState`` (moments ``[ue, ie]``)."""
    from incubator_predictionio_tpu_torch.utils.optim import AdamTreeState

    count, m, v = state
    return AdamTreeState(
        int(np.asarray(count)),
        [_tensor(m[k], device) for k in ("ue", "ie")],
        [_tensor(v[k], device) for k in ("ue", "ie")])


def trainer_state_from_reference(state: dict) -> dict:
    """The reference ``DeltaTrainer.to_state()`` (``rows``, ``m``, ``v``:
    ``{(kind, index): [rank+1] f32}``; ``t``: ``{key: int}``; ``n_folded``;
    ``coldstart``: its ``ColdStartBuckets`` or None) → the dict the port's
    ``DeltaTrainer.load_state`` takes. Arrays are copied as float32; the
    cold-start buckets, a class of the other package, are rebuilt from
    their ``user_rows``, ``item_rows`` and ``seed``."""
    from incubator_predictionio_tpu_torch.streaming.coldstart import (
        ColdStartBuckets,
    )

    def rows(d: dict) -> dict:
        return {(str(k[0]), int(k[1])): np.array(v, np.float32, copy=True)
                for k, v in d.items()}

    cs = state.get("coldstart")
    if cs is not None:
        cs = ColdStartBuckets(
            user_rows=np.array(cs.user_rows, np.float32, copy=True),
            item_rows=np.array(cs.item_rows, np.float32, copy=True),
            seed=int(cs.seed))
    return {
        "rows": rows(state["rows"]), "m": rows(state["m"]),
        "v": rows(state["v"]),
        "t": {(str(k[0]), int(k[1])): int(t) for k, t in state["t"].items()},
        "n_folded": int(state["n_folded"]),
        "coldstart": cs,
    }


def _id_map(ids: Sequence[str]) -> BiMap:
    return BiMap({k: i for i, k in enumerate(ids)})


def mlp_params_from_jax(params) -> list[dict[str, np.ndarray]]:
    """The reference ``MLPModel.params`` (``[{"w": [d_in, d_out], "b":
    [d_out]}, …]`` as numpy) → the port's parameter list (fp32 copies),
    checked layer to layer."""
    out = []
    for i, layer in enumerate(params):
        w = np.array(layer["w"], np.float32, copy=True)
        b = np.array(layer["b"], np.float32, copy=True)
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: w {w.shape} and b {b.shape} do not "
                             "make a dense layer")
        if out and out[-1]["w"].shape[1] != w.shape[0]:
            raise ValueError(f"layer {i} takes {w.shape[0]} inputs; layer "
                             f"{i - 1} gives {out[-1]['w'].shape[1]}")
        out.append({"w": w, "b": b})
    return out


def item_sim_model_from_arrays(item_vecs: np.ndarray, item_ids: Sequence[str],
                               categories: dict) -> ItemSimModel:
    """The similarproduct model over L2-normalized item rows
    (``item_ids[i]`` names row ``i``) and the item → categories map."""
    vecs = np.ascontiguousarray(item_vecs, np.float32)
    if vecs.shape[0] != len(item_ids):
        raise ValueError(f"{vecs.shape[0]} rows for {len(item_ids)} item ids")
    return ItemSimModel(vecs, _id_map(item_ids),
                        {k: tuple(v) for k, v in categories.items()})


def similar_user_model_from_arrays(user_vecs: np.ndarray,
                                   user_ids: Sequence[str]) -> SimilarUserModel:
    """The recommended-user model over L2-normalized followed-user rows."""
    vecs = np.ascontiguousarray(user_vecs, np.float32)
    if vecs.shape[0] != len(user_ids):
        raise ValueError(f"{vecs.shape[0]} rows for {len(user_ids)} user ids")
    return SimilarUserModel(vecs, _id_map(user_ids))


def ecomm_model_from_arrays(
    user_emb, item_emb, user_bias, item_bias, mean: float, rank: int,
    user_ids: Sequence[str], item_ids: Sequence[str], categories: dict,
    popularity: np.ndarray, item_vecs_norm: np.ndarray,
) -> ECommModel:
    """The e-commerce model: the towers as :func:`rec_model_from_arrays`
    takes them, the catalog's categories, the popularity counts and the
    L2-normalized item rows of predictSimilar."""
    rec = rec_model_from_arrays(user_emb, item_emb, user_bias, item_bias,
                                mean, rank, user_ids, item_ids)
    pop = np.array(popularity, np.float32, copy=True)
    norm = np.array(item_vecs_norm, np.float32, copy=True)
    if pop.shape != (len(item_ids),) or norm.shape != (len(item_ids), rank):
        raise ValueError("popularity / item_vecs_norm do not match the catalog")
    return ECommModel(mf=rec.mf, user_map=rec.user_map, item_map=rec.item_map,
                      categories={k: tuple(v) for k, v in categories.items()},
                      popularity=pop, item_vecs_norm=norm)
