"""Device all-vs-all minimizer overlap join — bit-exact, OPT-IN.

The overlap stage is the last host-only hot path (native/io_native.cpp's
hash-histogram join).  This module moves
the whole chain — rolling-hash minimizer extraction, index build, seed-hit
join, diagonal-band chaining, greedy anchor thinning, and trace-point
emission — onto the accelerator as dense XLA programs, uploading only the
2-bit-packed read codes (~bases/4 bytes) and downloading only the
surviving records + traces.

It is NOT the production path: the join needs ~12 random gather/scatter
passes per seed hit, so its cost is bound by the device's random-access
rate, and whether it beats the C join on the GPU has not been measured
(see device_join_available()).  It remains the bit-parity reference
implementation, CPU-tested on every commit.

Records are BIT-IDENTICAL to the native C path (mapper._native_map_block +
emit_records): every ordering, tie-break, subsampling and rounding rule of
io_native.cpp's chain_read_range/emit_records is replicated (the trace
interpolation is integer-exact round-half-even on BOTH sides, introduced
for exactly this cross-backend guarantee).  tests/test_device_join.py
asserts store equality against the C oracle on simulated workloads.

Design notes (why it looks the way it does):
  * every lookup is a hand-rolled bounded binary search (plain gathers) over the sorted
    index, pruned by a radix-prefix table, the device analogue of the C
    path's `pre[]` bucket table (io_native.cpp:728-735).
  * the (read, target, strand, band) grouping that C does with a per-read
    hash table becomes two global stable sorts.
  * The greedy sub_gap thinning (io_native.cpp:671-696) is a sequential
    per-row scan in C; here each anchor's successor (`first hit >=
    sub_gap bases later in the row`) forms a functional graph whose orbit
    from the row head is exactly the greedy emission set — marked in
    O(log n) pointer-doubling rounds, no sequential scan.
  * Everything runs under a local enable_x64 scope: the 64-bit minimizer
    hash order (splitmix finalizer, mapper._kmer_hash) and the
    integer-exact trace interpolation need real uint64/int64; all arrays
    are explicitly dtyped so nothing else changes width.

Shapes are static per cap-tuple (pow2 buckets derived from the workload)
so each geometry compiles once; compiled programs land in the persistent
compilation cache (utils/compile_cache.py).  Any capacity overflow raises a flag
on device and the caller falls back to the C path (bit-identical output
either way).
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import List, Optional

import numpy as np

from hinge_tpu.data.overlaps import OverlapStore, ReadStore

BANDBITS = 12          # band_rel field width in the 32-bit group key
MAX_TID = 1 << 18      # key packs tid into 31-(1+BANDBITS) = 18 bits
INVALID_RID = 1 << 29  # sorts rejected hits behind every real read
N_FLAGS = 8            # overflow flag vector length (see _make_join_fn)


def _enable_x64():
    from jax._src import config as _jcfg

    return _jcfg.enable_x64(True)


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# small vectorized primitives (shared by the jitted bodies)
# ---------------------------------------------------------------------------


def _compact(mask, dst_cap, *cols):
    """Stable masked compaction: rows where `mask` move to the front of
    `dst_cap`-sized outputs (order preserved); returns (count, outs).
    Rows past dst_cap are dropped — callers must check count <= cap."""
    import jax.numpy as jnp

    dst = jnp.cumsum(mask.astype(jnp.int32)) - 1
    cnt = dst[-1] + 1
    idx = jnp.where(mask, dst, dst_cap)
    outs = []
    for col, fill in cols:
        buf = jnp.full((dst_cap,), fill, dtype=col.dtype)
        outs.append(buf.at[idx].set(col, mode="drop"))
    return cnt, outs


def _segment_ids(starts_mask):
    import jax.numpy as jnp

    return jnp.cumsum(starts_mask.astype(jnp.int32)) - 1


def _bsearch(keys, lo, hi, target, steps, upper):
    """Vectorized bounded binary search as a fori_loop (an unrolled
    version makes a much larger HLO graph that compiles for minutes — the
    loop form keeps it small at identical semantics).
    upper=False: first index with keys[i] >= target in [lo, hi);
    upper=True:  first index with keys[i] >  target."""
    import jax
    import jax.numpy as jnp

    lo = lo.astype(jnp.int32)
    hi = hi.astype(jnp.int32)
    n = keys.shape[0]

    def body(_, lh):
        lo, hi = lh
        cont = lo < hi
        mid = (lo + hi) >> 1
        kv = keys[jnp.clip(mid, 0, n - 1)]
        go_right = (kv <= target) if upper else (kv < target)
        return (jnp.where(cont & go_right, mid + 1, lo),
                jnp.where(cont & ~go_right, mid, hi))

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return lo


def _lower_bound(keys, lo, hi, target, steps):
    return _bsearch(keys, lo, hi, target, steps, upper=False)


def _upper_bound(keys, lo, hi, target, steps):
    return _bsearch(keys, lo, hi, target, steps, upper=True)


# ---------------------------------------------------------------------------
# jit A: per-block minimizer extraction (+ index contribution)
# ---------------------------------------------------------------------------

_FN_CACHE: dict = {}


def _minimizer_fn(k: int, w: int, bcap: int, mcap: int, icap: int,
                  nstream_cap: int):
    """Block kernel: unpack 2-bit codes, build the [fwd, rc]* working
    array, rolling k-mer hash (mapper._kmer_hash bit-for-bit), sliding
    first-tie window-argmin (the numpy/native minimizer semantics), and
    compact query minimizers + forward-stream index entries.

    Stream layout in the working array X (length bcap): for each read of
    the block, its forward codes then its reverse-complement codes,
    back-to-back.  The k-1 tail positions of every stream are invalid
    k-mer starts; since w <= k no w-window can touch two streams' valid
    regions, so no physical pad slots are needed — a window covering any
    invalid slot resolves to its pad key (h=0, pos=-1) and is discarded,
    exactly reproducing per-stream windows."""
    key = ("mini", k, w, bcap, mcap, icap, nstream_cap)
    if key in _FN_CACHE:
        return _FN_CACHE[key]
    import jax
    import jax.numpy as jnp

    M1 = np.uint64(0xBF58476D1CE4E5B9)
    M2 = np.uint64(0x94D049BB133111EB)
    kmask = np.uint64((1 << (2 * k)) - 1) if k < 32 else np.uint64(2**64 - 1)

    def tmin(a, b):
        ah, ap = a
        bh, bp = b
        take_a = (ah < bh) | ((ah == bh) & (ap <= bp))
        return jnp.where(take_a, ah, bh), jnp.where(take_a, ap, bp)

    def shift(arr, s, fill):
        return jnp.concatenate([arr[s:], jnp.full((s,), fill, arr.dtype)])

    @jax.jit
    def fn(packed, code_off, lens, stream_start, n_streams, r0):
        pos = jnp.arange(bcap, dtype=jnp.int32)
        marks = jnp.zeros(bcap, jnp.bool_).at[stream_start].set(
            True, mode="drop")
        sid = jnp.clip(_segment_ids(marks), 0, nstream_cap)
        # stream_start carries a leading 0 AND a trailing sentinel (=used
        # length), so positions past the last stream get sid == n_streams
        in_stream = sid < n_streams
        rd_local = sid >> 1
        is_rc = sid & 1
        rd = r0 + rd_local
        rdc = jnp.clip(rd, 0, lens.shape[0] - 1)
        L = lens[rdc]
        off_in = pos - stream_start[jnp.clip(sid, 0, nstream_cap)]
        src_off = jnp.where(is_rc == 1, L - 1 - off_in, off_in)
        src = code_off[rdc] + jnp.clip(src_off, 0, None)
        byte = packed[jnp.clip(src >> 2, 0, packed.shape[0] - 1)]
        code = (byte >> ((src & 3) * 2).astype(jnp.uint8)) & np.uint8(3)
        code = jnp.where(is_rc == 1, np.uint8(3) - code, code)

        v = jnp.zeros(bcap, jnp.uint64)
        for i in range(k):
            ci = shift(code, i, np.uint8(0)) if i else code
            v = (v << np.uint64(2)) | ci.astype(jnp.uint64)
        v &= kmask
        h = v
        h = (h ^ (h >> np.uint64(30))) * M1
        h = (h ^ (h >> np.uint64(27))) * M2
        h = h ^ (h >> np.uint64(31))

        valid = in_stream & (off_in >= 0) & (off_in <= L - k)
        hkey = jnp.where(valid, h, np.uint64(0))
        pkey = jnp.where(valid, pos, jnp.int32(-1))

        # sliding (h, pos) min over windows of w via a sparse table
        mins = {1: (hkey, pkey)}
        s = 1
        while s < w:
            prev = mins[s]
            mins[2 * s] = tmin(prev, (shift(prev[0], s, np.uint64(0)),
                                      shift(prev[1], s, jnp.int32(-1))))
            s *= 2
        p2 = 1 << (w.bit_length() - 1)
        if p2 == w:
            wh, wp = mins[p2]
        else:
            p2b = _pow2(w - p2)
            wh, wp = tmin(mins[p2],
                          (shift(mins[p2b][0], w - p2b, np.uint64(0)),
                           shift(mins[p2b][1], w - p2b, jnp.int32(-1))))
        del wh
        sel = jnp.zeros(bcap, jnp.bool_).at[
            jnp.where(wp >= 0, wp, bcap)].set(True, mode="drop")

        qpos = (pos - stream_start[jnp.clip(sid, 0, nstream_cap)]).astype(
            jnp.int32)
        mcount, (mh, mpos, msid) = _compact(
            sel, mcap, (h, np.uint64(0)), (qpos, jnp.int32(0)),
            (sid.astype(jnp.int32), jnp.int32(0)))

        fsel = sel & (is_rc == 0)
        icount, (ih, itid, ipos) = _compact(
            fsel, icap, (h, np.uint64(0)),
            (rd.astype(jnp.int32), jnp.int32(MAX_TID)),
            (qpos, jnp.int32(0)))
        return mcount, mh, mpos, msid, icount, ih, itid, ipos

    _FN_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# jit B: global index finalize (sort + bucket filter + prefix table)
# ---------------------------------------------------------------------------


def _index_fn(iglob: int, pre_bits: int, max_bucket: int):
    key = ("index", iglob, pre_bits, max_bucket)
    if key in _FN_CACHE:
        return _FN_CACHE[key]
    import jax
    import jax.numpy as jnp

    pre_shift = np.uint64(64 - pre_bits)

    @jax.jit
    def fn(ih, itid, ipos, n_real):
        pad = jnp.arange(iglob, dtype=jnp.int32) >= n_real
        ih = jnp.where(pad, np.uint64(2**64 - 1), ih)
        itid = jnp.where(pad, jnp.int32(MAX_TID), itid)
        sh, stid, spos = jax.lax.sort((ih, itid, ipos), num_keys=1,
                                      is_stable=True)
        real = stid < MAX_TID  # real entries occupy sorted [0, n_real)
        newb = jnp.ones(iglob, jnp.bool_)
        newb = newb.at[1:].set(sh[1:] != sh[:-1])
        bid = _segment_ids(newb)
        cnts = jnp.zeros(iglob + 1, jnp.int32).at[bid].add(
            jnp.where(real, 1, 0), mode="drop")
        entry_valid = real & (cnts[bid] <= max_bucket)
        pref = (sh >> pre_shift).astype(jnp.int32)
        table = jnp.zeros((1 << pre_bits) + 1, jnp.int32)
        table = table.at[jnp.where(real, pref + 1, (1 << pre_bits) + 1)].add(
            1, mode="drop")
        pre = jnp.cumsum(table)
        return sh, stid, spos, entry_valid, pre

    _FN_CACHE[key] = fn
    return fn


def _scatter_fn(iglob: int, icap: int):
    key = ("scatter", iglob, icap)
    if key in _FN_CACHE:
        return _FN_CACHE[key]
    import jax
    import jax.numpy as jnp

    @jax.jit
    def fn(gh, gtid, gpos, bh, btid, bpos, cnt, off):
        idx = jnp.where(jnp.arange(icap, dtype=jnp.int32) < cnt,
                        off + jnp.arange(icap, dtype=jnp.int32), iglob)
        return (gh.at[idx].set(bh, mode="drop"),
                gtid.at[idx].set(btid, mode="drop"),
                gpos.at[idx].set(bpos, mode="drop"))

    _FN_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# jit C: join + chain + thin + emit for one query block
# ---------------------------------------------------------------------------


def _join_fns(k: int, band_width: int, min_hits: int, sub_gap: int,
              min_span: int, min_cnt: int, tspace: int,
              mcap: int, hcap: int, bandcap: int, rowcap: int,
              kcap: int, tbcap: int, trcap: int, pre_bits: int):
    """The per-block join pipeline as FOUR separate jits (p1..p4) with
    device-resident intermediates.  One fused program compiles for many
    minutes; the split phases compile in a fraction of that and cache
    independently per geometry."""
    key = ("join", k, band_width, min_hits, sub_gap, min_span, min_cnt,
           tspace, mcap, hcap, bandcap, rowcap, kcap, tbcap, trcap, pre_bits)
    if key in _FN_CACHE:
        return _FN_CACHE[key]
    import jax
    import jax.numpy as jnp

    pre_shift = np.uint64(64 - pre_bits)
    B30 = jnp.int32(1 << 30)
    idx_steps = 17     # bounded search inside one prefix bucket
    row_steps = 21     # bounded search inside one row's hit segment
    acap = hcap        # accepted hits can approach the raw hit count

    @jax.jit
    def p1(idx_h, idx_tid, idx_pos, entry_valid, pre,
           mh, mpos, msid, mcount, r0, band_off, half_pairs):
        """Bucket lookup, hit expansion, band key, (rid, key) sort."""
        iglob = idx_h.shape[0]
        qvalid = jnp.arange(mcap, dtype=jnp.int32) < mcount

        pb = (mh >> pre_shift).astype(jnp.int32)
        lo0 = pre[pb]
        hi0 = pre[jnp.clip(pb + 1, 0, pre.shape[0] - 1)]
        steps_ovf = jnp.max(jnp.where(qvalid, hi0 - lo0, 0)) > (1 << idx_steps)
        lo = _lower_bound(idx_h, lo0, hi0, mh, idx_steps)
        hi = _upper_bound(idx_h, lo, hi0, mh, idx_steps)
        cnt = jnp.where(qvalid, hi - lo, 0)

        offs = jnp.cumsum(cnt) - cnt
        total_hits = offs[-1] + cnt[-1]
        hit_ovf = total_hits > hcap
        # hit j -> owning query minimizer: scatter qm+1 at each span start
        # (queries with cnt == 0 leave holes, so a plain 1s-cumsum would
        # count spans, not identify them), then running max
        startmark = jnp.zeros(hcap + 2, jnp.int32)
        startmark = startmark.at[jnp.where(cnt > 0, offs, hcap + 1)].max(
            jnp.arange(mcap, dtype=jnp.int32) + 1, mode="drop")
        qm = jnp.clip(jax.lax.cummax(startmark[:hcap]) - 1, 0, mcap - 1)
        j = jnp.arange(hcap, dtype=jnp.int32)
        in_tot = j < jnp.minimum(total_hits, hcap)
        entry = jnp.clip(lo[qm] + (j - offs[qm]), 0, iglob - 1)

        g_rid = r0 + (msid[qm] >> 1)
        strand = msid[qm] & 1
        q = mpos[qm]
        tid = idx_tid[entry]
        t = idx_pos[entry]
        ok_h = in_tot & entry_valid[entry]
        ok_h &= (half_pairs == 0) | (tid >= g_rid)

        band = (t - q + B30) // jnp.int32(band_width)
        band_rel = band - band_off[jnp.clip(g_rid - r0, 0,
                                            band_off.shape[0] - 1)]
        band_ovf = jnp.any(ok_h & ((band_rel < 0) |
                                   (band_rel >= (1 << BANDBITS))))
        gkey = (((tid << 1) | strand) << BANDBITS) | jnp.clip(
            band_rel, 0, (1 << BANDBITS) - 1)
        rid_k = jnp.where(ok_h, g_rid, jnp.int32(INVALID_RID))

        # stable sort by (rid, key); ties keep flat order (== C's per-read
        # stream-then-bucket "buf" order)
        rid_s, key_s, q_s, t_s = jax.lax.sort(
            (rid_k, gkey, q, t), num_keys=2, is_stable=True)
        flags1 = jnp.stack([hit_ovf.astype(jnp.int32),
                            band_ovf.astype(jnp.int32),
                            steps_ovf.astype(jnp.int32)])
        return rid_s, key_s, q_s, t_s, flags1

    @jax.jit
    def p2(rid_s, key_s, q_s, t_s):
        """Band run-lengths, best adjacent pair per group, accepted rows,
        accepted-hit compaction + (row, q, t) sort."""
        valid_s = rid_s < INVALID_RID

        newband = jnp.ones(hcap, jnp.bool_)
        newband = newband.at[1:].set((rid_s[1:] != rid_s[:-1]) |
                                     (key_s[1:] != key_s[:-1]))
        newband &= valid_s
        band_id_raw = _segment_ids(newband)
        nband = jnp.max(jnp.where(valid_s, band_id_raw + 1, 0))
        band_ovf = nband > bandcap
        band_id = jnp.where(valid_s, jnp.clip(band_id_raw, 0, bandcap),
                            bandcap)
        bidx = jnp.arange(hcap, dtype=jnp.int32)
        b_start = jnp.full(bandcap + 1, hcap, jnp.int32).at[band_id].min(
            bidx, mode="drop")[:bandcap]
        b_end = jnp.zeros(bandcap + 1, jnp.int32).at[band_id].max(
            bidx + 1, mode="drop")[:bandcap]
        b_cnt = jnp.maximum(b_end - b_start, 0)
        b_rid = jnp.full(bandcap + 1, INVALID_RID, jnp.int32).at[band_id].min(
            rid_s, mode="drop")[:bandcap]
        b_key = jnp.zeros(bandcap + 1, jnp.int32).at[band_id].max(
            key_s, mode="drop")[:bandcap]
        b_real = b_rid < INVALID_RID

        b_grp = b_key >> BANDBITS
        newgrp = jnp.ones(bandcap, jnp.bool_)
        newgrp = newgrp.at[1:].set((b_rid[1:] != b_rid[:-1]) |
                                   (b_grp[1:] != b_grp[:-1]))
        newgrp &= b_real
        grp_id = jnp.clip(_segment_ids(newgrp), 0, bandcap - 1)
        next_same = jnp.zeros(bandcap, jnp.bool_)
        next_same = next_same.at[:-1].set(
            b_real[1:] & b_real[:-1] & (b_rid[1:] == b_rid[:-1]) &
            (b_key[1:] == b_key[:-1] + 1))
        pair_cnt = b_cnt + jnp.where(
            next_same,
            jnp.concatenate([b_cnt[1:], jnp.zeros(1, jnp.int32)]), 0)
        g_best = jnp.zeros(bandcap, jnp.int32).at[
            jnp.where(b_real, grp_id, bandcap - 1)].max(
            jnp.where(b_real, pair_cnt, 0), mode="drop")
        is_best = b_real & (pair_cnt == g_best[grp_id])
        g_besti = jnp.full(bandcap, bandcap, jnp.int32).at[
            jnp.where(is_best, grp_id, bandcap)].min(
            jnp.arange(bandcap, dtype=jnp.int32), mode="drop")

        g_accept = newgrp & (g_best[grp_id] >= min_hits)
        row_of = jnp.cumsum(g_accept.astype(jnp.int32)) - 1
        n_rows = row_of[-1] + 1
        row_ovf = n_rows > rowcap
        ridx = jnp.where(g_accept, jnp.clip(row_of, 0, rowcap), rowcap)
        row_rid = jnp.zeros(rowcap + 1, jnp.int32).at[ridx].max(
            b_rid, mode="drop")[:rowcap]
        row_key = jnp.zeros(rowcap + 1, jnp.int32).at[ridx].max(
            b_grp, mode="drop")[:rowcap]

        accepted_b = b_real & (g_best[grp_id] >= min_hits)
        bi = g_besti[grp_id]
        arange_b = jnp.arange(bandcap, dtype=jnp.int32)
        sel_best = accepted_b & (arange_b == bi)
        sel_next = accepted_b & (arange_b == bi + 1) & \
            next_same[jnp.clip(bi, 0, bandcap - 1)]
        grp_row = jnp.clip(row_of, 0, rowcap - 1)
        row_at = jnp.where(sel_best | sel_next, grp_row, -1)

        hit_row = jnp.where(valid_s & (band_id < bandcap),
                            row_at[jnp.clip(band_id, 0, bandcap - 1)], -1)
        acc_cnt, (a_row, a_q, a_t) = _compact(
            hit_row >= 0, acap,
            (jnp.clip(hit_row, 0, rowcap - 1).astype(jnp.int32),
             jnp.int32(rowcap)),
            (q_s, jnp.int32(0)), (t_s, jnp.int32(0)))
        acc_ovf = acc_cnt > acap
        a_row, a_q, a_t = jax.lax.sort((a_row, a_q, a_t), num_keys=3)
        flags2 = jnp.stack([band_ovf.astype(jnp.int32),
                            row_ovf.astype(jnp.int32),
                            acc_ovf.astype(jnp.int32)])
        return (a_row, a_q, a_t, row_rid, row_key >> 1, row_key & 1,
                n_rows, flags2)

    @jax.jit
    def p3(a_row, a_q, a_t, n_rows):
        """Greedy sub_gap thinning (orbit walk), monotone-t filter, and
        per-row span statistics."""
        a_real = a_row < rowcap
        a_rowc = jnp.clip(a_row, 0, rowcap - 1)
        aidx = jnp.arange(acap, dtype=jnp.int32)
        r_start = jnp.full(rowcap + 1, acap, jnp.int32).at[
            jnp.where(a_real, a_row, rowcap)].min(aidx, mode="drop")[:rowcap]
        r_end = jnp.zeros(rowcap + 1, jnp.int32).at[
            jnp.where(a_real, a_row, rowcap)].max(
            aidx + 1, mode="drop")[:rowcap]
        steps_ovf = jnp.max(jnp.maximum(r_end - r_start, 0)) > (1 << row_steps)

        nxt = _lower_bound(a_q, jnp.minimum(aidx + 1, acap),
                           jnp.where(a_real, r_end[a_rowc], 0),
                           a_q + jnp.int32(sub_gap), row_steps)
        nxt = jnp.where(a_real & (nxt < r_end[a_rowc]), nxt, acap)
        Jext = jnp.array([acap], jnp.int32)

        def orbit_body(_, sj):
            S32, Jmp = sj
            S32 = jnp.maximum(
                S32, jnp.zeros(acap + 1, jnp.int32).at[Jmp].max(
                    S32, mode="drop")[:acap])
            Jmp = jnp.concatenate([Jmp, Jext])[jnp.clip(Jmp, 0, acap)]
            return S32, Jmp

        S32, _ = jax.lax.fori_loop(
            0, row_steps + 2, orbit_body,
            ((a_real & (aidx == r_start[a_rowc])).astype(jnp.int32), nxt))
        S = S32 > 0
        q_emit_max = jnp.zeros(rowcap + 1, jnp.int32).at[
            jnp.where(S, a_row, rowcap)].max(a_q, mode="drop")[:rowcap]
        is_last = a_real & (aidx == r_end[a_rowc] - 1)
        S = S | (is_last & (a_q != q_emit_max[a_rowc]))

        kn, (k_row, k_q, k_t) = _compact(
            S, kcap, (a_row, jnp.int32(rowcap)), (a_q, jnp.int32(0)),
            (a_t, jnp.int32(0)))
        thin_ovf = kn > kcap
        k_real = k_row < rowcap

        kk = (k_row.astype(jnp.int64) << 25) | k_t.astype(jnp.int64)
        run = jax.lax.cummax(jnp.where(k_real, kk, jnp.int64(-1)))
        prev = jnp.concatenate([jnp.array([-1], jnp.int64), run[:-1]])
        prev_row = (prev >> 25).astype(jnp.int32)
        prev_t = (prev & ((1 << 25) - 1)).astype(jnp.int32)
        keep = k_real & ((prev_row != k_row) | (k_t >= prev_t))

        _, (f_row, f_q, f_t) = _compact(
            keep, kcap, (k_row, jnp.int32(rowcap)), (k_q, jnp.int32(0)),
            (k_t, jnp.int32(0)))
        f_real = f_row < rowcap
        fidx = jnp.arange(kcap, dtype=jnp.int32)
        fr_start = jnp.full(rowcap + 1, kcap, jnp.int32).at[
            jnp.where(f_real, f_row, rowcap)].min(fidx, mode="drop")[:rowcap]
        fr_end = jnp.zeros(rowcap + 1, jnp.int32).at[
            jnp.where(f_real, f_row, rowcap)].max(
            fidx + 1, mode="drop")[:rowcap]
        m = jnp.maximum(fr_end - fr_start, 0)
        has = m > 0
        sidxr = jnp.clip(fr_start, 0, kcap - 1)
        eidxr = jnp.clip(fr_end - 1, 0, kcap - 1)
        Q0 = jnp.where(has, f_q[sidxr], 0)
        T0 = jnp.where(has, f_t[sidxr], 0)
        Q1 = jnp.where(has, f_q[eidxr] + k, 0)
        T1 = jnp.where(has, f_t[eidxr] + k, 0)
        row_in = jnp.arange(rowcap, dtype=jnp.int32) < n_rows
        okr = row_in & (m >= min_cnt) & (Q1 - Q0 >= min_span) & \
            (T1 - T0 >= min_span)
        n_int = jnp.maximum((T1 - 1) // tspace - T0 // tspace, 0)
        nb = jnp.where(okr, n_int + 2, 0)
        flags3 = jnp.stack([thin_ovf.astype(jnp.int32),
                            steps_ovf.astype(jnp.int32)])
        return (f_q, f_t, fr_start, fr_end, Q0, Q1, T0, T1, okr, nb,
                flags3)

    @jax.jit
    def p4(f_q, f_t, fr_start, fr_end, Q0, Q1, T0, T1, okr, nb):
        """Trace-point grid bounds, integer-exact interpolation, remainder
        fold, and flat trace assembly."""
        boff = jnp.cumsum(nb) - nb
        tb_total = boff[-1] + nb[-1]
        tb_ovf = tb_total > tbcap
        bmark = jnp.zeros(tbcap + 2, jnp.int32)
        bmark = bmark.at[jnp.where(nb > 0, boff, tbcap + 1)].max(
            jnp.arange(rowcap, dtype=jnp.int32) + 1, mode="drop")
        row_b = jnp.clip(jax.lax.cummax(bmark[:tbcap]) - 1, 0, rowcap - 1)
        bj = jnp.arange(tbcap, dtype=jnp.int32)
        in_b = bj < jnp.minimum(tb_total, tbcap)
        jj = bj - boff[row_b]
        last_j = nb[row_b] - 1
        T0b = T0[row_b]
        bval = (T0b // tspace + jj) * tspace
        bval = jnp.where(jj == 0, T0b,
                         jnp.where(jj == last_j, T1[row_b], bval))

        ub = _upper_bound(f_t, fr_start[row_b], fr_end[row_b], bval,
                          row_steps)
        jh = jnp.clip(ub - 1, fr_start[row_b], jnp.maximum(
            fr_end[row_b] - 1, fr_start[row_b]))
        has_next = jh < fr_end[row_b] - 1
        jhc = jnp.clip(jh, 0, kcap - 1)
        jn = jnp.clip(jh + 1, 0, kcap - 1)
        denom = jnp.maximum(f_t[jn] - f_t[jhc], 1).astype(jnp.int64)
        dy = (f_q[jn] - f_q[jhc]).astype(jnp.int64)
        num = f_q[jhc].astype(jnp.int64) * denom + jnp.where(
            has_next, (bval - f_t[jhc]).astype(jnp.int64) * dy,
            jnp.int64(0))
        qd = num // denom
        r2 = 2 * (num - qd * denom)
        qd += ((r2 > denom) | ((r2 == denom) & ((qd & 1) == 1))).astype(
            jnp.int64)
        bar = jnp.where(jj == 0, Q0[row_b].astype(jnp.int64),
                        jnp.where(jj == last_j,
                                  Q1[row_b].astype(jnp.int64), qd))

        nxt_bar = jnp.concatenate([bar[1:], jnp.zeros(1, jnp.int64)])
        is_d = in_b & (jj < last_j)
        d = jnp.where(is_d, jnp.clip(nxt_bar - bar, 0, 65534), 0).astype(
            jnp.int32)
        dsum = jnp.zeros(rowcap + 1, jnp.int64).at[
            jnp.where(is_d, row_b, rowcap)].add(
            d.astype(jnp.int64), mode="drop")[:rowcap]
        delta = jnp.where(okr, (Q1 - Q0).astype(jnp.int64) - dsum,
                          jnp.int64(0))
        is_lastd = is_d & (jj == last_j - 1)
        newlast = d.astype(jnp.int64) + delta[row_b]
        d = jnp.where(is_lastd & (newlast >= 0) & (newlast < 65535),
                      newlast.astype(jnp.int32), d)

        tlen_row = jnp.where(okr, 2 * (nb - 1), 0)
        toff = jnp.cumsum(tlen_row) - tlen_row
        tr_total = toff[-1] + tlen_row[-1]
        tr_ovf = tr_total > trcap
        tpos_ = toff[row_b] + 2 * jj + 1
        trace = jnp.zeros(trcap, jnp.int32).at[
            jnp.where(is_d, tpos_, trcap)].max(d, mode="drop")
        flags4 = jnp.stack([tb_ovf.astype(jnp.int32),
                            tr_ovf.astype(jnp.int32)])
        return trace.astype(jnp.uint16), tr_total, flags4

    fns = (p1, p2, p3, p4)
    _FN_CACHE[key] = fns
    return fns


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------


def device_join_available() -> bool:
    """True only when HINGE_DEVICE_JOIN=1 forces the device path.

    The path is bit-identical to the C join but off by default: its ~12
    random gather/scatter passes per seed hit (field expansion, band
    grouping, thinning orbit, interpolation) over hundreds of millions of
    seed hits are bound by the device's random-access rate, against ~2
    cache-resident probes per hit in the C hash histogram.  Which one wins
    on the GPU has not been measured (ROADMAP A3).  The path stays
    maintained and bit-parity-tested (the CPU-backend test suite runs it
    on every commit)."""
    return os.environ.get("HINGE_DEVICE_JOIN", "") == "1"


def _debug_log():
    """Phase-timing logger: HINGE_DEVICE_JOIN_LOG=<path> appends stamped
    lines (per-phase walls; HINGE_DEVICE_JOIN_SYNC=1 adds fetch barriers so
    each phase's wall includes its device time)."""
    p = os.environ.get("HINGE_DEVICE_JOIN_LOG", "")
    if not p:
        return lambda *a: None
    f = open(p, "a", buffering=1)
    t0 = time.time()

    def log(*a):
        print(f"[djoin +{time.time() - t0:7.1f}s]", *a, file=f)

    return log


def _pack_codes(rs: ReadStore) -> np.ndarray:
    c = np.ascontiguousarray(rs.bases, dtype=np.uint8)
    n = len(c)
    pad = (-n) % 4
    if pad:
        c = np.concatenate([c, np.zeros(pad, np.uint8)])
    quads = c.reshape(-1, 4)
    return (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
            | (quads[:, 3] << 6)).astype(np.uint8)


def overlap_base_records(
    rs: ReadStore,
    k: int = 15,
    w: int = 12,
    min_span: int = 1000,
    min_hits: int = 4,
    band_width: int = 500,
    tspace: int = 100,
    sub_gap: int = 32,
    max_bucket: int = 64,
    min_cnt: int = 2,
    block_bases: int = 1 << 23,
) -> Optional[OverlapStore]:
    """All-vs-all half-pairs base records on the accelerator; None when
    the device path is unavailable or a capacity/shape gate fails (caller
    falls back to the C path — outputs are bit-identical either way)."""
    if rs.bases is None or rs.n_reads == 0:
        return None
    lens = rs.length.astype(np.int64)
    if (rs.n_reads >= MAX_TID or int(lens.max()) >= (1 << 24)
            or int(lens.min()) < k + w or w > k):
        return None
    # band_rel must fit BANDBITS for every (read, target) pair
    if (2 * int(lens.max())) // band_width + 2 >= (1 << BANDBITS):
        return None

    import jax
    import jax.numpy as jnp

    from hinge_tpu.overlap import mapper as _mapper

    dbg = _debug_log()
    with _enable_x64():
        packed = _pack_codes(rs)
        code_off32 = rs.bases_off.astype(np.int32)
        dbg(f"packed {len(packed)} bytes, {rs.n_reads} reads")

        # ---- block partition by X length (fwd+rc codes per read) ----
        blocks = []  # (r0, r1, x_len)
        r0 = 0
        cur = 0
        for r in range(rs.n_reads):
            xl = 2 * int(lens[r])
            if cur and cur + xl > block_bases:
                blocks.append((r0, r, cur))
                r0, cur = r, 0
            cur += xl
        blocks.append((r0, rs.n_reads, cur))
        bcap = _pow2(max(x for _, _, x in blocks))
        max_reads_blk = max(r1 - b0 for b0, r1, _ in blocks)
        nstream_cap = _pow2(2 * max_reads_blk + 2)
        mcap = max(bcap // 4, 1 << 12)
        icap = max(bcap // 8, 1 << 11)

        d_packed = jax.device_put(jnp.asarray(packed))
        d_off = jax.device_put(jnp.asarray(code_off32))
        d_lens = jax.device_put(jnp.asarray(rs.length.astype(np.int32)))

        mini = _minimizer_fn(k, w, bcap, mcap, icap, nstream_cap)
        block_q = []
        idx_parts = []
        icounts = []
        for b0, r1, _ in blocks:
            nr = r1 - b0
            ll = lens[b0:r1]
            inter = np.empty(2 * nr, np.int64)
            inter[0::2] = ll
            inter[1::2] = ll
            ss = np.zeros(nstream_cap + 1, np.int32)
            np.cumsum(inter, out=ss[1 : 2 * nr + 1])
            ss[2 * nr + 1 :] = ss[2 * nr]
            t0 = time.time()
            out = mini(d_packed, d_off, d_lens, jnp.asarray(ss),
                       jnp.int32(2 * nr), jnp.int32(b0))
            mcount, mh, mpos, msid, icount, ih, itid, ipos = out
            mc = int(mcount)
            ic = int(icount)
            dbg(f"block {b0}-{r1}: minimizers={mc} idx={ic} "
                f"({time.time()-t0:.1f}s)")
            if mc > mcap or ic > icap:
                return None
            block_q.append((mh, mpos, msid, mc, b0, r1))
            idx_parts.append((ih, itid, ipos, ic))
            icounts.append(ic)

        # ---- global index ----
        n_idx = sum(icounts)
        iglob = _pow2(max(n_idx, 1 << 12))
        pre_bits = max(8, min(24, (n_idx // 2).bit_length()))
        gh = jnp.full((iglob,), np.uint64(2**64 - 1), jnp.uint64)
        gtid = jnp.full((iglob,), jnp.int32(MAX_TID), jnp.int32)
        gpos = jnp.zeros((iglob,), jnp.int32)
        scat = _scatter_fn(iglob, icap)
        off = 0
        for ih, itid, ipos, ic in idx_parts:
            gh, gtid, gpos = scat(gh, gtid, gpos, ih, itid, ipos,
                                  jnp.int32(ic), jnp.int32(off))
            off += ic
        del idx_parts
        t0 = time.time()
        idxf = _index_fn(iglob, pre_bits, max_bucket)
        sh, stid, spos, entry_valid, pre = idxf(gh, gtid, gpos,
                                                jnp.int32(n_idx))
        pre.block_until_ready()
        del gh, gtid, gpos
        dbg(f"index: n={n_idx} iglob={iglob} pre_bits={pre_bits} "
            f"({time.time()-t0:.1f}s)")

        # ---- join per block ----
        # 16x minimizer cap: the 4.6Mb/30x workload measures ~12 hits per
        # query minimizer (535M hits / 44M lookups), so 8x overflowed and
        # forced a mid-run recompile; 16x holds with margin
        hcap = _pow2(max(1 << 16, 16 * mcap))
        bandcap = max(hcap // 16, 1 << 12)
        rowcap = max(hcap // 64, 1 << 12)
        kcap = max(hcap // 4, 1 << 12)
        tbcap = max(rowcap * 32, 1 << 14)
        trcap = 2 * tbcap
        stores: List[OverlapStore] = []
        for bi_ in range(len(block_q)):
            mh, mpos, msid, mc, b0, r1 = block_q[bi_]
            block_q[bi_] = None  # free this block's query arrays after use
            band_off_np = ((-(lens[b0:r1] - k)) + (1 << 30)) // band_width
            boff_pad = np.zeros(_pow2(max_reads_blk), np.int32)
            boff_pad[: r1 - b0] = band_off_np.astype(np.int32)
            attempt = 0
            while True:
                p1, p2, p3, p4 = _join_fns(
                    k, band_width, min_hits, sub_gap, min_span, min_cnt,
                    tspace, mcap, hcap, bandcap, rowcap, kcap, tbcap,
                    trcap, pre_bits)
                sync = os.environ.get("HINGE_DEVICE_JOIN_SYNC") == "1"
                t0 = time.time()
                rid_s, key_s, q_s, t_s, fl1 = p1(
                    sh, stid, spos, entry_valid, pre,
                    mh, mpos, msid, jnp.int32(mc), jnp.int32(b0),
                    jnp.asarray(boff_pad), jnp.int32(1))
                if sync:
                    np.asarray(fl1)
                dbg(f"block {b0}: p1 ({time.time()-t0:.1f}s)")
                t0 = time.time()
                (a_row, a_q, a_t, row_rid, row_tid, row_strand,
                 n_rows, fl2) = p2(rid_s, key_s, q_s, t_s)
                del rid_s, key_s, q_s, t_s
                if sync:
                    np.asarray(fl2)
                dbg(f"block {b0}: p2 ({time.time()-t0:.1f}s)")
                t0 = time.time()
                (f_q, f_t, fr_start, fr_end, Q0, Q1, T0, T1, okr, nb,
                 fl3) = p3(a_row, a_q, a_t, n_rows)
                del a_row, a_q, a_t
                if sync:
                    np.asarray(fl3)
                dbg(f"block {b0}: p3 ({time.time()-t0:.1f}s)")
                t0 = time.time()
                trace, tr_total, fl4 = p4(f_q, f_t, fr_start, fr_end,
                                          Q0, Q1, T0, T1, okr, nb)
                del f_q, f_t, fr_start, fr_end
                if sync:
                    np.asarray(fl4)
                dbg(f"block {b0}: p4 ({time.time()-t0:.1f}s)")
                f1, f2, f3, f4 = (np.asarray(fl1), np.asarray(fl2),
                                  np.asarray(fl3), np.asarray(fl4))
                if not (f1.any() or f2.any() or f3.any() or f4.any()):
                    break
                if f1[1] or f1[2] or f3[1]:
                    return None  # key-packing/search-depth gates: no retry
                attempt += 1
                if attempt > 3:
                    return None
                # grow whichever capacity overflowed and retry the block
                if f1[0] or f2[2]:
                    hcap *= 2
                if f2[0]:
                    bandcap *= 2
                if f2[1]:
                    rowcap *= 2
                    tbcap = max(tbcap, rowcap * 32)
                    trcap = 2 * tbcap
                if f3[0]:
                    kcap *= 2
                if f4[0] or f4[1]:
                    tbcap *= 2
                    trcap = 2 * tbcap
            nr = int(n_rows)
            if nr == 0:
                continue
            tt = int(tr_total)
            t_fetch = time.time()
            rid = np.asarray(row_rid[:nr])
            strand = np.asarray(row_strand[:nr])
            tid = np.asarray(row_tid[:nr])
            ok = np.asarray(okr[:nr]).astype(bool)
            q0 = np.asarray(Q0[:nr]).astype(np.int64)
            q1 = np.asarray(Q1[:nr]).astype(np.int64)
            t0 = np.asarray(T0[:nr]).astype(np.int64)
            t1 = np.asarray(T1[:nr]).astype(np.int64)
            nbv = np.asarray(nb[:nr]).astype(np.int64)
            tr = np.asarray(trace[:tt])
            dbg(f"block {b0}: fetched rows={nr} trace={tt} "
                f"({time.time()-t_fetch:.1f}s)")
            acc = np.nonzero(ok)[0]
            if len(acc) == 0:
                continue
            rida, strda, tida = rid[acc], strand[acc], tid[acc]
            blen = rs.length[rida].astype(np.int64)
            alen = rs.length[tida].astype(np.int64)
            b_start = np.where(strda == 0, q0[acc], blen - q1[acc])
            b_end = np.where(strda == 0, q1[acc], blen - q0[acc])
            stores.append(OverlapStore.from_arrays(
                tspace=tspace, trace=tr,
                a_id=tida, b_id=rida,
                a_len=alen, b_len=blen,
                a_start=t0[acc], a_end=t1[acc],
                b_start=b_start, b_end=b_end,
                rc=strda, diffs=np.zeros(len(acc), dtype=np.int64),
                tlen=2 * (nbv[acc] - 1),
            ).sort_by_a())
        if not stores:
            return _mapper._empty(tspace)
        if len(stores) == 1:
            return stores[0]
        return _mapper._concat(stores, tspace)
