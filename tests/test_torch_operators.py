"""The port's relational Table ops against ``repro.core.operators``.

The same seeded numpy inputs go through both packages and every output
column, mask and count must be equal, bit for bit.  The inputs carry
invalid rows, duplicate keys and keys outside ``[0, n_keys)`` on both
sides of zero, whose handling the reference fixes through its scatters
(negative keys read modulo ``n_keys + 1``, the rest dropped).  Where
several rows set one slot (``last``/``median``, a repeated build key of
``fk_join``) the reference leaves the winner to XLA; the port takes the
last row, which is checked against a plain numpy loop.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from repro.core import operators as J

from repro_torch.core import operators as T

N_KEYS = 16
UDAS = ("sum", "count", "min", "max", "average")


def inputs(seed, rows=64, lo=-N_KEYS - 4, hi=N_KEYS + 4):
    """Seeded (keys int32, values float32, valid bool) with duplicates,
    invalid rows and out-of-range keys."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(lo, hi, rows).astype(np.int32)
    vals = rng.standard_normal(rows).astype(np.float32)
    valid = rng.random(rows) < 0.8
    return keys, vals, valid


def tables(keys, vals, valid, **extra):
    """The same relation in both packages."""
    cols = dict(k=keys, v=vals, **extra)
    j = J.Table(columns={n: jnp.asarray(c) for n, c in cols.items()},
                valid=jnp.asarray(valid))
    t = T.Table(columns={n: torch.from_numpy(np.array(c))
                         for n, c in cols.items()},
                valid=torch.from_numpy(np.array(valid)))
    return j, t


def assert_tables_equal(j, t):
    assert set(j.columns) == set(t.columns)
    for name in j.columns:
        a, b = np.asarray(j.columns[name]), t.columns[name].numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(np.asarray(j.valid), t.mask().numpy())


def test_table_basics():
    keys, vals, valid = inputs(0)
    j, t = tables(keys, vals, valid)
    assert t.capacity == j.capacity == len(keys)
    assert t.count().dtype == torch.int32
    assert int(t.count()) == int(j.count()) == int(valid.sum())
    f = T.Table.from_columns(a=torch.arange(5), b=torch.zeros(5))
    assert f.valid is None and f.capacity == 5
    assert f.mask().dtype == torch.bool and bool(f.mask().all())
    assert f.count().dtype == torch.int32 and int(f.count()) == 5
    assert torch.equal(f.column("a"), torch.arange(5))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unmasked_table_matches_reference(seed):
    """A Table built with ``from_columns`` carries no mask; every op reads
    it as the reference reads its all-true mask."""
    keys, vals, _ = inputs(seed)
    j = J.Table.from_columns(k=jnp.asarray(keys), v=jnp.asarray(vals))
    t = T.Table.from_columns(k=torch.from_numpy(keys),
                             v=torch.from_numpy(vals))
    assert int(t.count()) == int(j.count()) == len(keys)
    assert_tables_equal(J.select(j, lambda r: r.columns["v"] > 0),
                        T.select(t, lambda r: r.columns["v"] > 0))
    assert_tables_equal(J.apply_function(j, lambda v: {"w": v * 2}, ("v",)),
                        T.apply_function(t, lambda v: {"w": v * 2}, ("v",)))
    aggs = {u: (u, "v") for u in UDAS}
    assert_tables_equal(J.group_by(j, "k", aggs, N_KEYS),
                        T.group_by(t, "k", aggs, N_KEYS))
    np.testing.assert_array_equal(
        np.asarray(J.theta_join_counts(j, j, "k", "k", N_KEYS)),
        T.theta_join_counts(t, t, "k", "k", N_KEYS).numpy())


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10 ** 6))
def test_stateless_ops(seed):
    keys, vals, valid = inputs(seed)
    j, t = tables(keys, vals, valid, w=vals * 2)
    assert_tables_equal(J.select(j, lambda x: x.column("v") > 0.1),
                        T.select(t, lambda x: x.column("v") > 0.1))
    assert_tables_equal(J.project(j, ("k", "w")), T.project(t, ("k", "w")))
    assert_tables_equal(
        J.apply_function(j, lambda v, w: {"s": 0.5 * v + w, "v": v / 3.0},
                         ("v", "w")),
        T.apply_function(t, lambda v, w: {"s": 0.5 * v + w, "v": v / 3.0},
                         ("v", "w")))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10 ** 6), rows=st.sampled_from([1, 7, 64, 300]))
def test_group_by_matches_reference(seed, rows):
    keys, vals, valid = inputs(seed, rows)
    j, t = tables(keys, vals, valid)
    aggs = {f"o_{u}": (u, "v") for u in UDAS}
    assert_tables_equal(J.group_by(j, "k", aggs, N_KEYS),
                        T.group_by(t, "k", aggs, N_KEYS))


@pytest.mark.parametrize("key", [-1, -2, -N_KEYS, -N_KEYS - 1, -N_KEYS - 2,
                                 N_KEYS, N_KEYS + 1, 10 ** 6, -10 ** 6])
def test_out_of_range_key_lands_where_the_reference_puts_it(key):
    """One valid row at an out-of-range key beside in-range rows: every
    UDA, the touched mask and the join counts follow the reference."""
    keys = np.array([0, key, 3, N_KEYS - 1], np.int32)
    vals = np.array([1.0, 10.0, 2.0, 4.0], np.float32)
    j, t = tables(keys, vals, np.ones(4, bool))
    aggs = {f"o_{u}": (u, "v") for u in UDAS}
    assert_tables_equal(J.group_by(j, "k", aggs, N_KEYS),
                        T.group_by(t, "k", aggs, N_KEYS))
    np.testing.assert_array_equal(
        np.asarray(J.theta_join_counts(j, j, "k", "k", N_KEYS)),
        T.theta_join_counts(t, t, "k", "k", N_KEYS).numpy())


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10 ** 6))
def test_replace_udas_keep_the_last_valid_row(seed):
    keys, vals, valid = inputs(seed, lo=-3, hi=N_KEYS + 2)
    _, t = tables(keys, vals, valid)
    got = T.group_by(t, "k", {"l": ("last", "v"), "m": ("median", "v")},
                     N_KEYS)
    want = np.zeros(N_KEYS + 1, np.float32)
    for k, v, ok in zip(keys, vals, valid):
        slot = k + N_KEYS + 1 if k < 0 else k
        if ok and 0 <= slot < N_KEYS:
            want[slot] = v
    np.testing.assert_array_equal(got.column("l").numpy(), want[:N_KEYS])
    np.testing.assert_array_equal(got.column("m").numpy(), want[:N_KEYS])


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10 ** 6))
def test_group_by_uda_matches_reference(seed):
    """A user aggregator of (Σv, Σv²) over the valid in-range rows."""
    keys, vals, valid = inputs(seed)

    def j_apply(state, k, v, ok):
        k = jnp.where(ok & (k >= 0) & (k < N_KEYS), k, N_KEYS)
        add = jnp.stack([v, v * v], -1) * ok[:, None]
        return state.at[k].add(add, mode="drop")

    def t_apply(state, k, v, ok):
        keep = ok & (k >= 0) & (k < N_KEYS)
        return state.index_add_(0, k[keep].long(),
                                torch.stack([v, v * v], -1)[keep])

    def result(state):
        return {"s": state[:, 0], "q": state[:, 1]}

    j, t = tables(keys, vals, valid)
    assert_tables_equal(
        J.group_by_uda(j, "k", ("v",), j_apply, result, N_KEYS, 2),
        T.group_by_uda(t, "k", ("v",), t_apply, result, N_KEYS, 2))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10 ** 6))
def test_fk_join_and_counts_match_reference(seed):
    rng = np.random.default_rng(seed)
    lkeys, lvals, lvalid = inputs(seed)
    # A dimension unique on its slots, keyed by negative keys (which the
    # reference reads modulo N_KEYS + 1) and keys out of range, with a few
    # invalid rows.
    rkeys = rng.permutation(np.r_[np.arange(-N_KEYS - 1, -1),
                                  np.arange(N_KEYS, N_KEYS + 3)]
                            ).astype(np.int32)
    rvalid = rng.random(rkeys.size) < 0.8
    rvals = rng.standard_normal(rkeys.size).astype(np.float32)
    jl, tl = tables(lkeys, lvals, lvalid)
    jr, tr = tables(rkeys, rvals, rvalid, d=rvals * 3)
    assert_tables_equal(J.fk_join(jl, jr, "k", "k", N_KEYS),
                        T.fk_join(tl, tr, "k", "k", N_KEYS))
    got = T.theta_join_counts(tl, tl, "k", "k", N_KEYS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        np.asarray(J.theta_join_counts(jl, jl, "k", "k", N_KEYS)),
        got.numpy())


def test_fk_join_repeated_build_key_takes_the_last_row():
    lk = np.array([2, 5, 2, 9], np.int32)
    rk = np.array([2, 5, 2, 2], np.int32)
    rv = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    rvalid = np.array([True, True, True, False])
    _, tl = tables(lk, np.zeros(4, np.float32), np.ones(4, bool))
    _, tr = tables(rk, rv, rvalid)
    out = T.fk_join(tl, tr, "k", "k", N_KEYS)
    np.testing.assert_array_equal(out.valid.numpy(),
                                  [True, True, True, False])
    np.testing.assert_array_equal(out.column("v_r").numpy()[:3],
                                  [3.0, 2.0, 3.0])
