"""Device-side consensus column vote (consensus.cpp:162-230 as one jitted
scatter-add kernel over flat alignment rows).

The reference walks each read's full alignment string, chops 100 columns at
both ends (chop_end, consensus.cpp:28-45), and tallies per-contig-position
match/insertion votes into five-way tables.  The device shape processes
EVERY read's rows at once as one flat column vector per chunk:

  * chop_end's leading-gap skip is a rank query into the running non-gap
    count (one searchsorted instead of a per-read while loop),
  * each read's kept column range becomes a +1/-1 boundary scatter and a
    cumulative sum (no per-read control flow),
  * contig positions are a second cumulative sum plus a per-segment affine
    offset rethreaded through a difference scatter,
  * the vote tables are four scatter-adds with out-of-range drop semantics.

Integer-exact: the device tables equal stages/consensus.py's numpy
`_vote_tallies` bit-for-bit, so consensus FASTA byte parity is preserved on
either path.  Chunks are independent reads, so multi-chip sharding is data
parallelism over chunks with a psum of the tables (see `sharded` arg of
vote_tallies_device and __graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

GAP = np.uint8(4)


@functools.partial(__import__("jax").jit, static_argnames=("chop",),
                   donate_argnums=(0, 1, 2, 3))
def _vote_chunk_kernel(scores, cov, ins_score, ins_scores,
                       flat_a, flat_b, seg_off, pos0, alen, *, chop: int):
    """One chunk's vote, accumulated into the running tables.

    scores/ins_scores int32 [ALEN_PAD*5]; cov/ins_score int32 [ALEN_PAD];
    flat_a/flat_b uint8 [CHUNK] (padding columns = GAP); seg_off int32
    [NSEG+1] (column starts, padded segments empty); pos0 int32 [NSEG];
    alen traced scalar.  Returns the four updated tables."""
    import jax.numpy as jnp

    chunk = flat_a.shape[0]
    i32 = jnp.int32
    a_nogap = flat_a != GAP
    an32 = a_nogap.astype(i32)
    # P[j] = non-gaps strictly before column j (exclusive prefix)
    P = jnp.concatenate([jnp.zeros(1, i32), jnp.cumsum(an32)])
    seg_start = seg_off[:-1]
    seg_len = seg_off[1:] - seg_start

    # chop_end: first column >= chop with A non-gap, else seg_len
    s = seg_start + jnp.minimum(i32(chop), seg_len)
    # first j whose inclusive non-gap count reaches P[s]+1 (counts only
    # advance past s, so j >= s automatically)
    j = jnp.searchsorted(P[1:], P[s] + 1, side="left").astype(i32)
    hit = j < seg_off[1:]
    first_k = jnp.where(hit, j - seg_start, seg_len)
    big = seg_len >= 2 * chop + 10
    start_k = jnp.where(big, first_k, 0)
    end_k = jnp.where(big, seg_len - chop, seg_len)
    offset = P[seg_start + start_k] - P[seg_start]

    # kept range per segment -> boundary scatter + cumsum
    lo = seg_start + start_k
    hi = seg_start + jnp.maximum(end_k, start_k)
    d = jnp.zeros(chunk + 1, i32).at[lo].add(1).at[hi].add(-1)
    keep = jnp.cumsum(d[:chunk]) > 0

    x = a_nogap & keep
    C = jnp.concatenate([jnp.zeros(1, i32), jnp.cumsum(x.astype(i32))])
    base = C[seg_start]  # kept non-gaps before each segment
    A = pos0 + offset - base
    Aprev = jnp.concatenate([jnp.zeros(1, i32), A[:-1]])
    da = jnp.zeros(chunk, i32).at[seg_start].add(A - Aprev, mode="drop")
    # pos[j] = segment's affine constant + kept non-gaps strictly before j
    pos = jnp.cumsum(da) + C[:-1]

    in_range = keep & (pos < alen)
    b32 = flat_b.astype(i32)
    sentinel = scores.shape[0]  # one past the table: dropped by mode="drop"
    idx_m = jnp.where(x & in_range, pos * 5 + b32, sentinel)
    m_ins = (~a_nogap) & (flat_b != GAP) & in_range
    idx_i = jnp.where(m_ins, pos * 5 + b32, sentinel)
    pos_m = jnp.where(x & in_range, pos, cov.shape[0])
    pos_i = jnp.where(m_ins, pos, cov.shape[0])
    one = jnp.ones((), i32)
    scores = scores.at[idx_m].add(one, mode="drop")
    cov = cov.at[pos_m].add(one, mode="drop")
    ins_score = ins_score.at[pos_i].add(one, mode="drop")
    ins_scores = ins_scores.at[idx_i].add(one, mode="drop")
    return scores, cov, ins_score, ins_scores


def sharded_vote_tallies(
    mesh, flat_a: np.ndarray, flat_b: np.ndarray, seg_len: np.ndarray,
    pos0: np.ndarray, alen: int, chop: int = 100,
    alen_bucket: int = 1 << 14,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Multi-chip consensus vote: reads split into one chunk per device
    (data parallelism — chunks are independent reads), each device tallies
    its chunk locally with _vote_chunk_kernel, and the four tables combine
    with ONE psum over the mesh (an ICI all-reduce of the [alen,5] tables).
    Bit-identical to stages/consensus._vote_tallies."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    axes = tuple(mesh.axis_names)
    n_dev = int(np.prod([mesh.shape[a] for a in axes]))
    n = int(seg_len.size)
    seg_len = np.asarray(seg_len, np.int64)
    seg_off = np.zeros(n + 1, np.int64)
    np.cumsum(seg_len, out=seg_off[1:])
    total = int(seg_off[-1])
    # split segments into n_dev column-balanced contiguous groups
    cuts = [0]
    for d_i in range(1, n_dev):
        cuts.append(int(np.searchsorted(seg_off, d_i * total // n_dev, "left")))
    cuts.append(n)
    cpad = _pad_pow2(max(
        (int(seg_off[b] - seg_off[a]) for a, b in zip(cuts[:-1], cuts[1:])),
        default=1) or 1, lo=256)
    npad = _pad_pow2(max(
        (b - a for a, b in zip(cuts[:-1], cuts[1:])), default=1) or 1, lo=16)
    fa = np.full((n_dev, cpad), GAP, np.uint8)
    fb = np.full((n_dev, cpad), GAP, np.uint8)
    so = np.zeros((n_dev, npad + 1), np.int32)
    p0 = np.zeros((n_dev, npad), np.int32)
    for d_i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        lo_c, hi_c = int(seg_off[a]), int(seg_off[b])
        fa[d_i, : hi_c - lo_c] = flat_a[lo_c:hi_c]
        fb[d_i, : hi_c - lo_c] = flat_b[lo_c:hi_c]
        so[d_i, :] = hi_c - lo_c
        so[d_i, : b - a + 1] = (seg_off[a : b + 1] - lo_c).astype(np.int32)
        p0[d_i, : b - a] = pos0[a:b]

    alen_pad = ((alen + alen_bucket - 1) // alen_bucket) * alen_bucket
    alen_t = jnp.int32(alen)

    def body(fa, fb, so, p0):
        z5 = jnp.zeros(alen_pad * 5, jnp.int32)
        z1 = jnp.zeros(alen_pad, jnp.int32)
        s, c, i1, i5 = _vote_chunk_kernel(
            z5, z1, z1, z5, fa[0], fb[0], so[0], p0[0], alen_t, chop=chop)
        return tuple(jax.lax.psum(t, axes) for t in (s, c, i1, i5))

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes),) * 4,
        out_specs=(P(),) * 4, check_vma=False,
    ))
    s, c, i1, i5 = fn(fa, fb, so, p0)
    return (np.asarray(s)[: alen * 5].reshape(alen, 5),
            np.asarray(c)[:alen], np.asarray(i1)[:alen],
            np.asarray(i5)[: alen * 5].reshape(alen, 5))


def _pad_pow2(n: int, lo: int = 1024) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def vote_tallies_device(
    flat_a: np.ndarray, flat_b: np.ndarray, seg_len: np.ndarray,
    pos0: np.ndarray, alen: int, chop: int = 100,
    chunk_cols: int = 1 << 23, alen_bucket: int = 1 << 20,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Device-accumulated vote tables (scores[alen,5], cov, ins_score,
    ins_scores) — same contract as stages/consensus._vote_tallies.  Chunks
    of ~chunk_cols whole reads stream through _vote_chunk_kernel with
    shape-bucketed padding (pow2 segment counts, fixed chunk width)."""
    import jax
    import jax.numpy as jnp

    n = int(seg_len.size)
    alen_pad = ((alen + alen_bucket - 1) // alen_bucket) * alen_bucket
    scores = jnp.zeros(alen_pad * 5, jnp.int32)
    cov = jnp.zeros(alen_pad, jnp.int32)
    ins_score = jnp.zeros(alen_pad, jnp.int32)
    ins_scores = jnp.zeros(alen_pad * 5, jnp.int32)
    seg_len = np.asarray(seg_len, np.int64)
    seg_off = np.zeros(n + 1, np.int64)
    np.cumsum(seg_len, out=seg_off[1:])
    alen_t = jnp.int32(alen)

    # ONE static kernel shape per (chunk_cols, alen_pad): chunks cut at both
    # a column budget and a fixed segment budget, so each shape compiles
    # exactly once
    nseg_cap = max(256, chunk_cols // 4096)
    s0 = 0
    while s0 < n:
        s1 = int(np.searchsorted(seg_off, seg_off[s0] + chunk_cols, "right")) - 1
        s1 = min(max(s1, s0 + 1), s0 + nseg_cap, n)
        lo, hi = int(seg_off[s0]), int(seg_off[s1])
        ncols, nseg = hi - lo, s1 - s0
        # single oversize read: fall through with a chunk sized to it
        cpad = chunk_cols if ncols <= chunk_cols else _pad_pow2(ncols)
        npad = nseg_cap if cpad == chunk_cols else _pad_pow2(nseg, lo=256)
        fa = np.full(cpad, GAP, np.uint8)
        fb = np.full(cpad, GAP, np.uint8)
        fa[:ncols] = flat_a[lo:hi]
        fb[:ncols] = flat_b[lo:hi]
        so = np.full(npad + 1, ncols, np.int32)
        so[: nseg + 1] = (seg_off[s0 : s1 + 1] - lo).astype(np.int32)
        p0 = np.zeros(npad, np.int32)
        p0[:nseg] = pos0[s0:s1]
        scores, cov, ins_score, ins_scores = _vote_chunk_kernel(
            scores, cov, ins_score, ins_scores,
            jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(so),
            jnp.asarray(p0), alen_t, chop=chop)
        s0 = s1
    return (np.asarray(scores)[: alen * 5].reshape(alen, 5),
            np.asarray(cov)[:alen], np.asarray(ins_score)[:alen],
            np.asarray(ins_scores)[: alen * 5].reshape(alen, 5))
