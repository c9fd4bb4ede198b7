"""Relational operators over dense columnar tables (paper §3.2, §4.2).

REX supports standard relational operators — selection, projection,
``applyFunction`` (UDF map), ``group by`` with UDAs, joins, ``rehash`` — all
pipelined and delta-aware.  A relation is a struct of dense columns plus a
validity mask (deleted/filtered rows stay in place as masked slots: static
shapes).  Stateless operators propagate annotations untouched (paper
rule); stateful operators use the Aggregator handlers.

Each op is a plain function of torch tensors; none needs a kernel of its
own.  The frontend's compiled strata run ``select`` and
``apply_function``; the rest serve the non-recursive side (OLAP-style
pipelines and the logical plans of core/plan.py).

Out-of-range keys follow the reference's scatters, which write into an
array of ``n_keys + 1`` slots (the last one a spare that is sliced away)
with JAX's index rules: a negative key ``k`` is read as ``k + n_keys + 1``
(so -1 lands in the spare slot and is dropped, and ``-n_keys - 1 <= k <=
-2`` lands in key ``k + n_keys + 1``); a key still outside ``[0, n_keys +
1)`` is dropped.  Torch's index ops would raise or wrap differently, so
:func:`_slots` computes that mapping explicitly.  Where several rows set
one slot (``group_by``'s ``last``/``median``, ``fk_join``'s build side),
the last of them in row order wins (``core/delta._last_writer_mask``); the
reference leaves that winner to XLA's scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.delta import _i32, _last_writer_mask, _scatter_minmax
from repro_torch.core.handlers import BUILTIN_UDAS


@dataclasses.dataclass(frozen=True)
class Table:
    """Dense columnar relation with a validity mask; ``valid=None`` means
    every row is valid (no mask is allocated until an op needs one)."""

    columns: Dict[str, torch.Tensor]
    valid: Optional[torch.Tensor] = None  # bool[N]

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    def count(self) -> torch.Tensor:
        if self.valid is None:
            first = next(iter(self.columns.values()))
            return torch.full((), first.shape[0], dtype=torch.int32,
                              device=first.device)
        return _i32(self.valid.sum())

    def mask(self) -> torch.Tensor:
        """bool[N]: the validity mask, materialised when ``valid`` is None."""
        if self.valid is not None:
            return self.valid
        first = next(iter(self.columns.values()))
        return torch.ones((first.shape[0],), dtype=torch.bool,
                          device=first.device)

    def column(self, name: str) -> torch.Tensor:
        return self.columns[name]

    @staticmethod
    def from_columns(**columns: torch.Tensor) -> "Table":
        """Every row valid."""
        return Table(columns=dict(columns))


def _slots(keys: torch.Tensor, valid: torch.Tensor, n_keys: int
           ) -> torch.Tensor:
    """int64 slot in ``[0, n_keys]`` of each row, ``n_keys`` (the spare)
    for invalid rows and dropped keys: the reference's scatter into
    ``n_keys + 1`` slots (see the module docstring)."""
    size = n_keys + 1
    k = keys.to(torch.int32).to(torch.int64)
    k = torch.where(k < 0, k + size, k)
    keep = valid & (k >= 0) & (k < size)
    return torch.where(keep, k, n_keys)


def _touched(slots: torch.Tensor, valid: torch.Tensor, n_keys: int
             ) -> torch.Tensor:
    """bool[n_keys]: a valid row landed in the slot."""
    hit = torch.zeros((n_keys + 1,), dtype=torch.int32, device=slots.device)
    hit.index_add_(0, slots, valid.to(torch.int32))
    return hit[:n_keys] > 0


# ---------------------------------------------------------------------------
# Stateless operators: selection / projection / applyFunction.
# Annotations (delta-ness) ride along untouched — here the validity mask is
# the only "annotation" these operators manipulate.
# ---------------------------------------------------------------------------

def select(table: Table, predicate: Callable[[Table], torch.Tensor]
           ) -> Table:
    """σ — mask rows failing the predicate (UDF or built-in comparison)."""
    keep = predicate(table)
    if table.valid is None:
        if keep.shape != (table.capacity,):
            keep = torch.broadcast_to(keep, (table.capacity,))
        return Table(columns=table.columns, valid=keep)
    return Table(columns=table.columns, valid=table.valid & keep)


def project(table: Table, names: Tuple[str, ...]) -> Table:
    return Table(columns={n: table.columns[n] for n in names},
                 valid=table.valid)


def apply_function(table: Table,
                   fn: Callable[..., Mapping[str, torch.Tensor]],
                   in_cols: Tuple[str, ...]) -> Table:
    """applyFunction — vectorized UDF producing new column(s): the batch is
    the whole column."""
    outs = fn(*[table.columns[c] for c in in_cols])
    cols = dict(table.columns)
    cols.update(outs)
    return Table(columns=cols, valid=table.valid)


# ---------------------------------------------------------------------------
# Stateful: group by with UDAs.
# ---------------------------------------------------------------------------

def group_by(table: Table, key_col: str,
             aggs: Mapping[str, Tuple[str, str]], n_keys: int) -> Table:
    """γ — segment-aggregate valid rows into a keyed result table.

    aggs: out_name -> (uda_name, in_col).  Each UDA's scatter combine is the
    AGGSTATE fold; the returned table is the AGGRESULT at end of stratum.
    ``average`` composes sum+count (pre-aggregate pair, paper §3.3/§5.2).
    A ``replace`` UDA (``last``, ``median``) keeps the last valid row of
    each key.
    """
    valid = table.mask()
    dev = valid.device
    slots = _slots(table.columns[key_col], valid, n_keys)
    out_cols: Dict[str, torch.Tensor] = {
        "key": torch.arange(n_keys, dtype=torch.int32, device=dev)}

    def full(fill):
        return torch.full((n_keys + 1,), fill, dtype=torch.float32,
                          device=dev)

    for out_name, (uda_name, in_col) in aggs.items():
        uda = BUILTIN_UDAS[uda_name]
        if uda_name == "count":
            vals = valid.to(torch.float32)
        else:
            vals = table.columns[in_col].to(torch.float32)
        if uda_name == "average":
            s = full(0.0).index_add_(0, slots, torch.where(valid, vals, 0.0))
            c = full(0.0).index_add_(0, slots, valid.to(torch.float32))
            out_cols[out_name] = s[:n_keys] / torch.clamp(c[:n_keys], min=1.0)
            continue
        if uda.combiner == "add":
            res = full(0.0).index_add_(0, slots,
                                       torch.where(valid, vals, 0.0))
        elif uda.combiner in ("min", "max"):
            fill = float("inf") if uda.combiner == "min" else float("-inf")
            res = _scatter_minmax(full(fill), slots,
                                  torch.where(valid, vals, fill),
                                  uda.combiner)
        else:  # replace: the last valid row of each key
            win = _last_writer_mask(slots, slots < n_keys, n_keys + 1)
            res = full(0.0)
            res[slots[win]] = vals[win]
        out_cols[out_name] = res[:n_keys]
    return Table(columns=out_cols, valid=_touched(slots, valid, n_keys))


def group_by_uda(table: Table, key_col: str, in_cols: Tuple[str, ...],
                 uda_apply: Callable, uda_result: Callable, n_keys: int,
                 state_width: int) -> Table:
    """γ with a fully user-defined aggregator (AGGSTATE/AGGRESULT pair).

    uda_apply(state[f32; n_keys, W], keys, cols..., valid) -> state'
    uda_result(state') -> dict of output columns (each [n_keys])
    """
    valid = table.mask()
    dev = valid.device
    keys = table.columns[key_col].to(torch.int32)
    state = torch.zeros((n_keys, state_width), dtype=torch.float32,
                        device=dev)
    state = uda_apply(state, keys, *[table.columns[c] for c in in_cols],
                      valid)
    slots = _slots(keys, valid, n_keys)
    cols = dict(uda_result(state))
    cols["key"] = torch.arange(n_keys, dtype=torch.int32, device=dev)
    return Table(columns=cols, valid=_touched(slots, valid, n_keys))


# ---------------------------------------------------------------------------
# Joins.
# ---------------------------------------------------------------------------

def fk_join(left: Table, right: Table, left_key: str, right_key: str,
            n_keys: int, suffix: str = "_r") -> Table:
    """Key–foreign-key equi-join (right side unique on its key).

    Dense-index build on the right (the pipelined hash join's bucket array),
    gather-probe from the left — the common shape for joining facts against
    a keyed dimension (or Δ tuples against keyed state).  Output has left's
    capacity; unmatched rows are masked out.  A key the right side repeats
    joins its last row.
    """
    lvalid = left.mask()
    dev = lvalid.device
    rslots = _slots(right.columns[right_key], right.mask(), n_keys)
    win = _last_writer_mask(rslots, rslots < n_keys, n_keys + 1)
    row_of_key = torch.full((n_keys + 1,), -1, dtype=torch.int32,
                            device=dev)
    row_of_key[rslots[win]] = torch.arange(
        right.capacity, dtype=torch.int32, device=dev)[win]
    lkeys = left.columns[left_key].to(torch.int32)
    safe = (lkeys >= 0) & (lkeys < n_keys) & lvalid
    rrow = torch.where(safe, row_of_key[lkeys.clamp(0, n_keys - 1).long()],
                       -1)
    matched = safe & (rrow >= 0)
    gather = rrow.clamp(0, right.capacity - 1).long()
    cols = dict(left.columns)
    for name, col in right.columns.items():
        out_name = name if name not in cols else name + suffix
        cols[out_name] = col[gather]
    return Table(columns=cols, valid=matched)


def theta_join_counts(left: Table, right: Table, left_key: str,
                      right_key: str, n_keys: int) -> torch.Tensor:
    """count(*) per key on the right — the optimizer-inserted cardinality
    input for the multiplicative-join compensation (paper §5.2)."""
    slots = _slots(right.columns[right_key], right.mask(), n_keys)
    counts = torch.zeros((n_keys + 1,), dtype=torch.int32,
                         device=slots.device)
    counts.index_add_(0, slots, torch.ones_like(slots, dtype=torch.int32))
    return counts[:n_keys]
