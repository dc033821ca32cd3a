"""ShardSpec — the row layout of sharded embedding tables, and the HBM budget.

Counterpart of ``incubator_predictionio_tpu/sharding/table.py``, with its
arithmetic and error texts:

- **Layout** (:class:`ShardSpec`): rows padded to a whole number of equal
  shards; shard ``s`` owns global rows ``[s·rows_per_shard,
  (s+1)·rows_per_shard)``; an entity row's owner is ``row //
  rows_per_shard``. The fused ``rank+1``-wide row (bias as the last
  column) rides along from the trainer.
- **Budget** (``PIO_SHARD_HBM_BUDGET``): a simulated per-card memory bound.
  A layout whose per-shard training bytes (table + both adam moments)
  exceed it raises :class:`HBMBudgetExceeded`, so a CPU run can prove the
  doesn't-fit-one-card case.

The reference's ``ShardedTable`` places a table row-sharded over a
``model`` mesh axis and initializes it with per-shard ``fold_in`` keys.
The port's counterpart (:meth:`ShardedTable.init_train`) builds, on each
process, only the block its ``model`` coordinate owns, drawn from a
``torch.Generator`` of its own whose seed is :func:`fold_in` of the fit's
seed, the table's name and the shard; one shard keeps the one-card draw
(``models/two_tower.py:_init_tables``, the one-card draw), bitwise. Serving places its own
per-shard blocks (``sharding/serve.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
from typing import Any, Optional

#: f32 table bytes per element; the adam moments ride the moments dtype.
_F32 = 4
_BYTES_FOR_DTYPE = {"float32": 4, "bfloat16": 2}


class HBMBudgetExceeded(RuntimeError):
    """A table layout needs more per-chip HBM than ``PIO_SHARD_HBM_BUDGET``."""


def parse_bytes(text: str) -> int:
    """``"256MB"`` / ``"1.5GiB"`` / ``"64kb"`` / plain ints → bytes."""
    s = str(text).strip()
    m = re.fullmatch(
        r"(?i)\s*([0-9]+(?:\.[0-9]+)?)\s*([kmgt]?i?b?)?\s*", s)
    if not m:
        raise ValueError(f"unparseable byte size {text!r}")
    value = float(m.group(1))
    unit = (m.group(2) or "").lower().rstrip("b").rstrip("i")
    mult = {"": 1, "k": 1 << 10, "m": 1 << 20,
            "g": 1 << 30, "t": 1 << 40}[unit]
    return int(value * mult)


def hbm_budget() -> Optional[int]:
    """The simulated per-chip HBM byte budget, or None when unbounded."""
    raw = os.environ.get("PIO_SHARD_HBM_BUDGET", "").strip()
    if not raw:
        return None
    b = parse_bytes(raw)
    return b if b > 0 else None


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Pure layout: which global rows live on which shard.

    ``width`` is the fused row width (``rank + 1``; bias is the last
    column). ``n_rows`` is the REAL row count; the padded tail rows exist
    only to make the shards equal and never hold entities.
    """

    name: str
    n_rows: int
    width: int
    n_shards: int

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")

    @property
    def padded_rows(self) -> int:
        return -(-max(self.n_rows, 1) // self.n_shards) * self.n_shards

    @property
    def rows_per_shard(self) -> int:
        return self.padded_rows // self.n_shards

    def shard_bounds(self, shard: int) -> tuple[int, int]:
        """Global ``[lo, hi)`` of shard ``shard``'s REAL rows (hi clipped
        to ``n_rows`` — the last shard may own padding-only tail rows)."""
        if not (0 <= shard < self.n_shards):
            raise ValueError(f"shard {shard} outside [0, {self.n_shards})")
        lo = shard * self.rows_per_shard
        return min(lo, self.n_rows), min(lo + self.rows_per_shard, self.n_rows)

    def owner_of(self, row: int) -> int:
        """Which shard owns global row ``row`` (streaming deltas route
        updated rows here)."""
        if not (0 <= row < self.n_rows):
            raise ValueError(f"row {row} outside [0, {self.n_rows})")
        return row // self.rows_per_shard

    def shard_row_counts(self) -> list[int]:
        return [hi - lo for lo, hi in
                (self.shard_bounds(s) for s in range(self.n_shards))]

    # -- byte accounting ---------------------------------------------------
    def table_bytes(self) -> int:
        """f32 bytes of the full padded table."""
        return self.padded_rows * self.width * _F32

    def shard_table_bytes(self) -> int:
        return self.rows_per_shard * self.width * _F32

    def serve_bytes_int8(self) -> int:
        """Bytes of the full padded table in the int8 serving layout
        (ops/retrieval.quantize_rows): 1 byte per embedding coordinate +
        one f32 dequant scale and one f32 bias per row."""
        return self.padded_rows * ((self.width - 1) + 2 * _F32)

    def shard_serve_bytes_int8(self) -> int:
        """Per-shard bytes of the int8 serving layout."""
        return self.rows_per_shard * ((self.width - 1) + 2 * _F32)

    def train_bytes_per_shard(self, moments_dtype: str = "float32") -> int:
        """Per-card training residency: the row block + BOTH adam moments
        (utils/optim.py stores m and v in ``moments_dtype``)."""
        mb = _BYTES_FOR_DTYPE.get(moments_dtype, _F32)
        return self.rows_per_shard * self.width * (_F32 + 2 * mb)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "n_rows": int(self.n_rows),
            "width": int(self.width),
            "n_shards": int(self.n_shards),
            "padded_rows": int(self.padded_rows),
            "rows_per_shard": int(self.rows_per_shard),
            "shard_rows": self.shard_row_counts(),
            "table_bytes": int(self.table_bytes()),
            "table_bytes_int8": int(self.serve_bytes_int8()),
            "shard_serve_bytes_int8": int(self.shard_serve_bytes_int8()),
            "train_bytes_per_shard": int(self.train_bytes_per_shard()),
        }


def requires_sharding(n_rows: int, width: int,
                      moments_dtype: str = "float32",
                      budget: Optional[int] = None) -> bool:
    """Would the SINGLE-CHIP (unsharded) training layout blow the budget?
    When True, only a sharded layout can train the table."""
    budget = hbm_budget() if budget is None else budget
    if budget is None:
        return False
    one = ShardSpec("single", n_rows, width, 1)
    return one.train_bytes_per_shard(moments_dtype) > budget


def check_budget(spec: ShardSpec, moments_dtype: str = "float32",
                 budget: Optional[int] = None) -> None:
    """Raise :class:`HBMBudgetExceeded` when ``spec``'s PER-SHARD training
    bytes exceed the simulated card budget (what a real card answers with
    an out-of-memory error)."""
    budget = hbm_budget() if budget is None else budget
    if budget is None:
        return
    need = spec.train_bytes_per_shard(moments_dtype)
    if need > budget:
        hint = ("" if spec.n_shards > 1 else
                " — shard the table over a 'model' mesh axis "
                "(docs/sharding.md)")
        raise HBMBudgetExceeded(
            f"table {spec.name!r}: {need} bytes/chip "
            f"({spec.rows_per_shard}×{spec.width} rows + adam moments over "
            f"{spec.n_shards} shard(s)) exceeds PIO_SHARD_HBM_BUDGET="
            f"{budget}{hint}")


def fold_in(seed: int, *data) -> int:
    """A 63-bit generator seed from ``seed`` and ``data`` (the port's
    counterpart of ``jax.random.fold_in``): the first 8 bytes of the
    blake2b digest of ``"seed/d0/d1/..."``, little-endian, top bit
    cleared. Any process computes the same seed for the same inputs."""
    text = "/".join(str(x) for x in (int(seed), *data)).encode()
    digest = hashlib.blake2b(text, digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def draw_block(rows: int, rank: int, generator, scale: float, device):
    """``[rows, rank+1]`` fp32 on ``device``: columns ``:rank`` normal ×
    ``scale`` from ``generator``, the bias column zero (the reference's
    table.py:247-270 block)."""
    import torch

    t = torch.zeros(rows, rank + 1, dtype=torch.float32, device=device)
    t[:, :rank] = torch.randn(rows, rank, generator=generator, device=device,
                              dtype=torch.float32) * scale
    return t


def init_block(spec: ShardSpec, shard: int, rank: int, seed: int,
               scale: float, device):
    """Block ``shard`` of a table laid out by ``spec`` (``rows_per_shard``
    rows, the padding rows included), drawn from a generator seeded
    ``fold_in(seed, spec.name, shard)``: what the process owning that
    block builds, and what a one-process replay rebuilds."""
    import torch

    gen = torch.Generator(device=device).manual_seed(
        fold_in(seed, spec.name, shard))
    return draw_block(spec.rows_per_shard, rank, gen, scale, device)


@dataclasses.dataclass
class ShardedTable:
    """A placed table: layout + the rows this process holds — the whole
    table with one shard, else the block its ``model`` coordinate owns
    (the reference's global ``jax.Array`` row-sharded over ``model``)."""

    spec: ShardSpec
    array: Any                 # torch.Tensor [rows_per_shard, width]
    axis: Optional[str]        # mesh axis the rows shard over (None = one)
    shard: int = 0             # the block ``array`` is

    @staticmethod
    def init_train(ctx, name: str, n_rows: int, rank: int, key,
                   scale: float, moments_dtype: str = "float32",
                   ) -> "ShardedTable":
        """A training table in its sharded layout (reference
        table.py:239-282), on ``ctx.device``. ``key`` is the fit's
        ``torch.Generator``. With one shard (no ``model`` axis) the table
        is drawn from ``key`` itself, advancing it: the fit's two tables
        come from one stream in order, as ``_init_tables`` draws them.
        With ``n`` shards this process builds only the block of its
        ``model`` coordinate, from its own generator
        (:func:`init_block`, seeded ``fold_in(key.initial_seed(), name,
        shard)``). ``PIO_SHARD_HBM_BUDGET`` is enforced on the per-shard
        spec first — the simulated equivalent of a card's out-of-memory
        error."""
        n_shards = ctx.axis_size_or("model")
        spec = ShardSpec(name, n_rows, rank + 1, n_shards)
        check_budget(spec, moments_dtype)
        if n_shards == 1:
            return ShardedTable(spec, draw_block(
                spec.rows_per_shard, rank, key, scale, ctx.device), None)
        shard = ctx.axis_index("model")
        return ShardedTable(spec, init_block(
            spec, shard, rank, key.initial_seed(), scale, ctx.device),
            "model", shard)


def array_model_shards(arr) -> int:
    """How many shards hold a placed table's rows: a training table's
    shard count (:class:`ShardedTable`), the length of a list of
    per-shard serving blocks (``sharding/serve.py``), 1 for a tensor on one
    device. The reference reads the count off a ``jax.Array``'s sharding."""
    if isinstance(arr, ShardedTable):
        return arr.spec.n_shards
    if isinstance(arr, (list, tuple)):
        return len(arr)
    return 1
