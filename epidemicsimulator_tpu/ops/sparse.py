"""Sparse cross-order transport: move a few set bits between citizen order,
work order and rider order without N-sized sorts.

The replicated-order fast path (engine/fastpath.py) maintains disease state
in three static orders and communicates only the per-step *changes* (new
exposures, vaccinations, work-side hits) — typically tens to a few thousand
elements out of millions.  Scatters cost per *update* element and
gathers per *query* element, so a K-bounded transport is:

    rank  = inclusive cumsum of the hit mask          (one scan pass)
    pos_j = searchsorted(rank, j+1)  for j < K         (~log2(N) gather rounds
                                                        of K elements)
    scatter the <=K positions through a static permutation lane

Overflow (count > K) falls back to the dense permutation sort at the call
site — never wrong, just slower, and only big-epidemic peaks hit it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def mask_ranks(mask):
    """Inclusive-cumsum ranks of a bool lane and the total count."""
    rank = jnp.cumsum(mask.astype(jnp.int32))
    n = mask.shape[0]
    return rank, rank[n - 1]


def compact_from_ranks(rank, count, k_slots: int):
    """Positions of the first ``k_slots`` set bits given inclusive ranks.

    Returns ``(pos, live)``: ``pos[j]`` is the index of the (j+1)-th set bit
    (== N for j >= count), ``live[j] = j < count``.  Exact for
    ``count <= k_slots``; callers must branch to a dense path otherwise.
    """
    tgt = jnp.arange(1, k_slots + 1, dtype=jnp.int32)
    pos = jnp.searchsorted(rank, tgt, side="left").astype(jnp.int32)
    live = tgt <= count
    return pos, live


def scatter_bits(n_out: int, dest_idx, live):
    """(n_out,) bool lane with ``dest_idx[live]`` set (K-sized updates)."""
    return (
        jnp.zeros((n_out,), bool)
        .at[jnp.where(live, dest_idx, n_out)]
        .set(True, mode="drop")
    )


def block_hierarchy(mask, *, block: int = 1024):
    """One-time per-lane prep for multi-round compaction: the reshaped
    mask tiles and their per-block counts.

    ``compact_positions`` recomputes this full-lane pass (pad + reshape +
    reduce) on EVERY call; XLA does not hoist it out of
    drain while-loops even though the mask is loop-invariant.  Callers
    that drain many rounds build the hierarchy once and pass it to
    :func:`compact_from_hierarchy` — each round then costs only the
    K-row gathers."""
    n = mask.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    m = mask.astype(jnp.int8)
    if pad:
        m = jnp.concatenate([m, jnp.zeros((pad,), jnp.int8)])
    m2 = m.reshape(nb, block)
    bs = m2.astype(jnp.int32).sum(axis=1)
    total = jnp.sum(bs)
    return m2, bs, total


def compact_from_hierarchy(h, k_slots: int, offset=0, *, n: int, sb=256):
    """Round extraction off a prebuilt :func:`block_hierarchy` — identical
    results to ``compact_positions(mask, k_slots, offset=offset)``.

    Per-slot cost is ``sb + block`` elements of vectorized compare/cumsum
    work; heavy extractions (the sortless work branch at UK scale) shrink
    both (block=128, sb=128) to halve it — the choice never changes
    results."""
    m2, bs, total = h
    nb, block = m2.shape
    k_slots = min(k_slots, n)
    tgt = jnp.asarray(offset, jnp.int32) + jnp.arange(
        1, k_slots + 1, dtype=jnp.int32
    )
    SB = sb
    nsb = -(-nb // SB)
    bs_p = bs
    if nsb * SB != nb:
        bs_p = jnp.concatenate(
            [bs, jnp.zeros((nsb * SB - nb,), jnp.int32)]
        )
    bs_sq = bs_p.reshape(nsb, SB)
    sbp = jnp.cumsum(bs_sq.sum(axis=1))
    sb_idx = jnp.minimum(
        (sbp[None, :] < tgt[:, None]).sum(axis=1), nsb - 1
    ).astype(jnp.int32)
    prior_sb = jnp.where(sb_idx > 0, jnp.take(sbp, sb_idx - 1), 0)
    sb_rows = jnp.take(bs_sq, sb_idx, axis=0)
    local_bp = jnp.cumsum(sb_rows, axis=1)
    resid_sb = tgt - prior_sb
    lt = local_bp < resid_sb[:, None]
    within_sb = jnp.sum(lt, axis=1).astype(jnp.int32)
    prior_in_sb = jnp.max(jnp.where(lt, local_bp, 0), axis=1)
    blk_safe = jnp.minimum(sb_idx * SB + within_sb, nb - 1)
    resid = tgt - prior_sb - prior_in_sb

    rows = jnp.take(m2, blk_safe, axis=0)
    local = jnp.cumsum(rows.astype(jnp.int32), axis=1)
    within = (local < resid[:, None]).sum(axis=1).astype(jnp.int32)

    live = tgt <= total
    pos = jnp.where(live, blk_safe * block + within, n).astype(jnp.int32)
    return pos, live, total


def compact_positions(mask, k_slots: int, *, block: int = 1024, offset=0):
    """Positions of the first ``k_slots`` set bits of ``mask`` — WITHOUT an
    N-sized cumsum.  ``offset`` (static or traced int32) skips that many
    leading set bits: slot j yields the (offset+j+1)-th set bit — the
    round-extraction primitive for the sparse apply path
    (engine/fastpath.py), whose while-loop pulls ``k_slots`` hits per
    iteration until the exact popcount is drained.

    The rank machinery above pays one full-lane cumsum plus a
    searchsorted over the N-lane.  This
    form is hierarchical and pure XLA:

      1. per-block counts via one reshape-reduce (bandwidth pass),
      2. tiny cross-block prefix,
      3. per-slot block via searchsorted over the (N/block,) prefix,
      4. row-gather of the K owning blocks, local per-row cumsum,
      5. within-row searchsorted for the residual rank.

    Returns ``(pos, live, total)``: ``pos[j]`` = index of the (j+1)-th set
    bit (== N for dead slots), ``live[j] = j < total``, ``total`` = exact
    popcount.  Exact while ``total <= k_slots`` — callers branch to dense
    paths past that.  Bitwise-identical to ``mask_ranks`` +
    :func:`compact_from_ranks`.
    """
    # Owning block per slot.  A searchsorted over the (nb,) prefix costs
    # ~16 dependent rounds of K gathers — instead, two levels of
    # vectorized compare+reduce: superblocks of SB blocks, then a K-row
    # gather of the owning superblock's counts (compact_from_hierarchy).
    return compact_from_hierarchy(
        block_hierarchy(mask, block=block), k_slots, offset,
        n=mask.shape[0],
    )
