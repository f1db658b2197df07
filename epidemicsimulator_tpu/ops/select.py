"""Exact k-th-smallest selection over hash score streams.

The vaccination program needs the exact k-th smallest uint32 score among
the eligible pool every step (engine/fastpath.py §11; simulator.rs:524-553
semantics).  The straightforward bitwise bisection costs 32 masked
reduction passes over the score lane.  :func:`kth_threshold` replaces it
with a
sampling-accelerated EXACT search:

1. score a strided 1-in-``stride`` sample directly from the hash stream
   (no read of the big lane), sort it, and bound the k-th population score
   between two sample order statistics ``[a, b]`` with a generous margin;
2. one fused pass counts ``eligible & score < a`` and builds the in-band
   mask; the band members are compacted via cumsum ranks + searchsorted
   (ops/sparse.py machinery) into K slots;
3. the answer is the ``(k - count_below_a)``-th smallest of the (tiny)
   band — one K-sized sort.

If the band overflows K, the margin missed (never observed; probability
falls off exponentially in the margin), or the pool is smaller than the
sample can see, a ``lax.cond`` falls back to the 32-pass bisection.
Both paths return the identical exact threshold, so trajectories are
bitwise-independent of which branch ran.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .hashrng import hash_bits

_U32_MAX = np.uint32(0xFFFFFFFF)

#: population sizes below this just run the plain bisection (the sampled
#: machinery needs a meaningful stride to pay off)
MIN_SAMPLED_N = 1 << 22
_SAMPLE_LOG2 = 20  # sample size 1M
# Band compaction slots (not yet tuned on the GPU).
_BAND_SLOTS = 8192


def bisect_threshold(scores_u32, eligible, k):
    """Smallest uint32 t with |{eligible & score <= t}| >= k — 32
    compare+reduce passes (the classic form).  :func:`radix_threshold`
    returns the identical value in 8 passes; the engine keeps the
    bisection."""

    # Straight-line unroll (NOT lax.while_loop): a while construct costs a
    # loop-predicate round trip per pass, and the unroll lets XLA pipeline
    # the 32 reduce passes; bitwise-identical either way.
    lo = jnp.uint32(0)
    hi = _U32_MAX
    for _ in range(32):
        mid = lo + (hi - lo) // jnp.uint32(2)
        cnt = jnp.sum((eligible & (scores_u32 <= mid)).astype(jnp.int32))
        hit = cnt >= k
        lo = jnp.where(hit, lo, mid + jnp.uint32(1))
        hi = jnp.where(hit, mid, hi)
    return lo


def radix_threshold(scores_u32, eligible, k):
    """Identical result to :func:`bisect_threshold` in 8 passes instead
    of 32: resolve the k-th smallest eligible score one nibble at a time.

    Each round counts, for the 15 candidate nibble boundaries ``v`` at the
    current bit position, how many eligible scores fall strictly below
    ``prefix + (v << shift)`` — a broadcast-compare reduction over the
    lane.  The resolved nibble is the number of boundaries whose count is
    < k.  Kept as a tested alternative formulation, not wired into the
    engine (XLA may materialise the (N, 15) compare instead of fusing it
    into the reduction; not yet measured on the GPU).
    """
    k = jnp.asarray(k, jnp.int32)
    v = jnp.arange(1, 16, dtype=jnp.uint32)  # (15,) nibble boundaries

    def round_body(r, p):
        shift = (28 - 4 * r).astype(jnp.uint32)
        # count(score <= p + (v<<shift) - 1) == count(score < p + (v<<shift))
        t = p + (v << shift)  # (15,); no overflow: high nibbles above
        # shift are resolved in p, so p + (15 << shift) <= 2^32 - ... fits
        below = (scores_u32[:, None] < t[None, :]) & eligible[:, None]
        cnts = jnp.sum(below.astype(jnp.int32), axis=0)  # (15,)
        nib = jnp.sum((cnts < k).astype(jnp.uint32))
        return p + (nib << shift)

    return jax.lax.fori_loop(0, 8, round_body, jnp.uint32(0))


def bisect_threshold_psum(scores_u32, eligible, k, axis):
    """Sharded :func:`bisect_threshold`: the count is psum'd over ``axis``
    each round, so every shard resolves the identical global threshold.
    32 sequential collective rounds — the multi-chip latency this form
    costs is why :func:`kth_threshold_sharded` exists; kept as its exact
    fallback and for tiny shards."""
    lo = jnp.uint32(0)
    hi = _U32_MAX
    for _ in range(32):
        mid = lo + (hi - lo) // jnp.uint32(2)
        cnt = jax.lax.psum(
            jnp.sum((eligible & (scores_u32 <= mid)).astype(jnp.int32)), axis
        )
        hit = cnt >= k
        lo = jnp.where(hit, lo, mid + jnp.uint32(1))
        hi = jnp.where(hit, mid, hi)
    return lo


def kth_threshold_sharded(scores_u32, eligible, k, n_eligible, *, axis,
                          force_sampled: bool | None = None,
                          sample_log2: int = 17,
                          band_slots: int = 4096):
    """Exact GLOBAL k-th smallest eligible score under ``shard_map``
    (vaccination exact-k, parallel/fastmesh.py §11).

    The sampled-band design of :func:`kth_threshold` adapted to a device
    mesh: every shard contributes a strided sample of its local score
    lane, ONE ``all_gather`` + replicated sort bounds the global k-th
    score between two sample order statistics, one local pass counts
    below-band and compacts the in-band members, ONE packed ``psum``
    globalises (count-below, band-count, overflow), and ONE ``all_gather``
    of the tiny per-shard bands feeds a replicated K-sized sort that
    reads off the exact answer.  3 collective rounds + ~2 full-lane
    passes, vs the bisection's 32 sequential psum rounds (multi-chip
    latency) and 32 compare+reduce passes (single-chip time).  Band
    overflow or a too-small pool falls back to
    :func:`bisect_threshold_psum` via ``lax.cond`` on a replicated
    predicate — both paths return the identical exact threshold, so
    trajectories are bitwise-independent of which branch ran
    (tests/test_fastmesh.py).
    """
    S = scores_u32.shape[0]
    m_loc = 1 << sample_log2
    stride = S // m_loc
    # Auto rule mirrors the single-device selector: sampled only for
    # shards >= MIN_SAMPLED_N — large shards, and meshes where 32
    # SEQUENTIAL psum rounds are pure interconnect latency (a rule not yet
    # measured on a GPU mesh).
    sampled = (
        (stride >= 4 and S >= MIN_SAMPLED_N)
        if force_sampled is None else force_sampled
    )
    if not sampled or stride < 1:
        return bisect_threshold_psum(scores_u32, eligible, k, axis)

    sub = jax.lax.slice(scores_u32, (0,), (m_loc * stride,), (stride,))
    sub_elig = jax.lax.slice(eligible, (0,), (m_loc * stride,), (stride,))
    masked = jnp.where(sub_elig, sub, _U32_MAX)
    allsamp = jax.lax.all_gather(masked, axis).reshape(-1)
    ssorted = jax.lax.sort(allsamp)
    # MAX-valued eligible scores drop out of the sample statistics (same
    # approximation as kth_threshold); the margin + fallback absorb it.
    m_elig = jnp.sum((allsamp != _U32_MAX).astype(jnp.int32))
    m = ssorted.shape[0]

    n_el = jnp.maximum(jnp.asarray(n_eligible, jnp.int32), 1)
    ratio = m_elig.astype(jnp.float32) / n_el.astype(jnp.float32)
    r = jnp.floor(jnp.asarray(k, jnp.float32) * ratio).astype(jnp.int32)
    marg = (
        8.0 * jnp.sqrt(jnp.maximum(r.astype(jnp.float32), 1.0)) + 32.0
    ).astype(jnp.int32)
    lo_i = jnp.clip(r - marg, 0, m - 1)
    hi_i = jnp.clip(r + marg, 0, m - 1)
    a = jnp.where(lo_i > 0, ssorted[lo_i], jnp.uint32(0))
    b = ssorted[hi_i]

    below_a = eligible & (scores_u32 < a)
    in_band = eligible & (scores_u32 >= a) & (scores_u32 <= b)
    c_below_loc = jnp.sum(below_a.astype(jnp.int32))

    from .sparse import compact_positions

    pos, live, cnt = compact_positions(in_band, band_slots)
    band = jnp.where(
        live, jnp.take(scores_u32, jnp.minimum(pos, S - 1)), _U32_MAX
    )
    packed = jax.lax.psum(
        jnp.stack([
            c_below_loc,
            jnp.minimum(cnt, band_slots),
            (cnt > band_slots).astype(jnp.int32),
        ]),
        axis,
    )
    c_below, band_cnt, overflow = packed[0], packed[1], packed[2]
    bands = jax.lax.all_gather(band, axis).reshape(-1)
    band_sorted = jax.lax.sort(bands)
    j = jnp.asarray(k, jnp.int32) - c_below  # 1-indexed global band rank
    tau_fast = band_sorted[jnp.clip(j - 1, 0, bands.shape[0] - 1)]

    ok = (overflow == 0) & (j >= 1) & (j <= band_cnt)
    return jax.lax.cond(
        ok,
        lambda _: tau_fast,
        lambda _: bisect_threshold_psum(scores_u32, eligible, k, axis),
        None,
    )


def kth_threshold(seed_u32, eligible, k, n_eligible, *,
                  force_sampled: bool | None = None,
                  sample_log2: int = _SAMPLE_LOG2,
                  band_slots: int = _BAND_SLOTS):
    """Exact k-th smallest of ``hash_bits(seed_u32, arange(n))`` over the
    ``eligible`` pool (k >= 1; returns 0 when k <= 0).

    ``n_eligible`` must equal ``sum(eligible)`` (callers already have it).
    ``force_sampled`` pins the strategy (tests); default: sampled for
    n >= MIN_SAMPLED_N.
    """
    n = eligible.shape[0]
    idx = jnp.arange(n, dtype=jnp.uint32)
    scores = hash_bits(seed_u32, idx)
    sampled = n >= MIN_SAMPLED_N if force_sampled is None else force_sampled
    if not sampled:
        return bisect_threshold(scores, eligible, k)

    m = 1 << sample_log2
    stride = n // m  # >= 4 given MIN_SAMPLED_N (tests shrink sample_log2)
    if stride < 1:
        return bisect_threshold(scores, eligible, k)
    sub_idx = jnp.arange(m, dtype=jnp.uint32) * jnp.uint32(stride)
    sub_scores = hash_bits(seed_u32, sub_idx)
    sub_elig = jax.lax.slice(eligible, (0,), (m * stride,), (stride,))
    ssorted = jax.lax.sort(jnp.where(sub_elig, sub_scores, _U32_MAX))
    m_elig = jnp.sum(sub_elig.astype(jnp.int32))

    # expected sample rank of the k-th population score, with a margin of
    # 8 sigma + 32 (binomial tail; generous, and the overflow cond is the
    # real safety net).  f32 ratio math: r < m = 2^20 < 2^24 stays exact
    # enough, and the margin + cond absorb rounding.
    n_el = jnp.maximum(jnp.asarray(n_eligible, jnp.int32), 1)
    ratio = m_elig.astype(jnp.float32) / n_el.astype(jnp.float32)
    r = jnp.floor(jnp.asarray(k, jnp.float32) * ratio).astype(jnp.int32)
    marg = (
        8.0 * jnp.sqrt(jnp.maximum(r.astype(jnp.float32), 1.0)) + 32.0
    ).astype(jnp.int32)
    lo_i = jnp.clip(r - marg, 0, m - 1)
    hi_i = jnp.clip(r + marg, 0, m - 1)
    a = jnp.where(lo_i > 0, ssorted[lo_i], jnp.uint32(0))
    b = ssorted[hi_i]
    # sample exhausted (pool mostly outside the sample's view) → b may
    # be MAX; the band-overflow cond handles it

    below_a = eligible & (scores < a)
    in_band = eligible & (scores >= a) & (scores <= b)
    c_below = jnp.sum(below_a.astype(jnp.int32))

    from .sparse import compact_positions

    pos, live, cnt = compact_positions(in_band, band_slots)
    band = jnp.where(
        live,
        hash_bits(seed_u32, jnp.minimum(pos, n - 1).astype(jnp.uint32)),
        _U32_MAX,
    )
    band_sorted = jax.lax.sort(band)
    j = jnp.asarray(k, jnp.int32) - c_below  # 1-indexed rank inside band
    tau_fast = band_sorted[jnp.clip(j - 1, 0, band.shape[0] - 1)]

    ok = (cnt <= band.shape[0]) & (j >= 1) & (j <= cnt)
    return jax.lax.cond(
        ok,
        lambda _: tau_fast,
        lambda _: bisect_threshold(scores, eligible, k),
        None,
    )
