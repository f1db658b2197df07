"""Unit tests of the sparse cross-order transport primitives (ops/sparse.py)
against numpy oracles — in particular compact_positions' ``offset`` round
extraction, the primitive behind the sparse-apply drain loops
(engine/fastpath.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from epidemicsimulator_tpu.ops.sparse import (
    compact_from_ranks,
    compact_positions,
    mask_ranks,
    scatter_bits,
)


def _oracle(mask, k, offset=0):
    pos_all = np.flatnonzero(mask)
    n = mask.shape[0]
    sel = pos_all[offset : offset + k]
    pos = np.full(k, n, np.int32)
    pos[: sel.shape[0]] = sel
    live = np.zeros(k, bool)
    live[: sel.shape[0]] = True
    return pos, live, pos_all.shape[0]


@pytest.mark.parametrize("seed,n,density,k", [
    (0, 10_000, 0.001, 64),
    (1, 10_000, 0.2, 128),
    (2, 333_333, 0.0003, 256),   # odd size exercises block padding
    (3, 5_000, 0.0, 32),         # empty mask
    (4, 2_049, 1.0, 64),         # saturated mask, overflow regime
])
def test_compact_positions_matches_oracle(seed, n, density, k):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < density
    pos, live, total = jax.jit(
        lambda m: compact_positions(m, k)
    )(jnp.asarray(mask))
    opos, olive, ototal = _oracle(mask, k)
    assert int(total) == ototal
    np.testing.assert_array_equal(np.asarray(live), olive)
    # dead slots are clamped to n by contract; compare live slots exactly
    np.testing.assert_array_equal(np.asarray(pos)[olive], opos[olive])
    assert (np.asarray(pos)[~olive] == n).all()


@pytest.mark.parametrize("offset", [0, 1, 7, 63, 64, 65, 1000])
def test_compact_positions_offset_skips_leading_bits(offset):
    rng = np.random.default_rng(11)
    n, k = 50_000, 64
    mask = rng.random(n) < 0.004  # ~200 set bits
    pos, live, total = jax.jit(
        lambda m, o: compact_positions(m, k, offset=o)
    )(jnp.asarray(mask), jnp.int32(offset))
    opos, olive, _ = _oracle(mask, k, offset)
    np.testing.assert_array_equal(np.asarray(live)[olive], olive[olive])
    np.testing.assert_array_equal(np.asarray(pos)[olive], opos[olive])
    # slots past the remaining bits are dead and clamped
    assert (np.asarray(pos)[~olive] == n).all()


def test_compact_positions_drain_rounds_cover_all_bits():
    """The fastpath drain pattern: while-loop rounds of k slots at
    offset=drained must enumerate every set bit exactly once."""
    rng = np.random.default_rng(5)
    n, k = 20_000, 37
    mask = jnp.asarray(rng.random(n) < 0.01)  # ~200 bits, ~6 rounds

    def round_fn(c):
        done, acc = c
        pos, live, _ = compact_positions(mask, k, offset=done)
        acc = acc.at[jnp.where(live, pos, n)].set(True, mode="drop")
        return done + jnp.sum(live.astype(jnp.int32)), acc

    _, total = mask_ranks(mask)
    done, acc = jax.lax.while_loop(
        lambda c: c[0] < total, round_fn,
        (jnp.int32(0), jnp.zeros((n,), bool)),
    )
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(mask))
    assert int(done) == int(np.asarray(mask).sum())


def test_compact_from_ranks_matches_hierarchical():
    rng = np.random.default_rng(9)
    n, k = 65_537, 128
    mask = rng.random(n) < 0.001
    rank, count = mask_ranks(jnp.asarray(mask))
    pos_a, live_a = compact_from_ranks(rank, count, k)
    pos_b, live_b, total = compact_positions(jnp.asarray(mask), k)
    assert int(count) == int(total)
    np.testing.assert_array_equal(np.asarray(live_a), np.asarray(live_b))
    np.testing.assert_array_equal(
        np.asarray(pos_a)[np.asarray(live_a)],
        np.asarray(pos_b)[np.asarray(live_b)],
    )


def test_scatter_bits_roundtrip():
    rng = np.random.default_rng(3)
    n, k = 9_999, 64
    mask = rng.random(n) < 0.003
    pos, live, _ = compact_positions(jnp.asarray(mask), k)
    lane = scatter_bits(n, pos, live)
    np.testing.assert_array_equal(np.asarray(lane), mask)
