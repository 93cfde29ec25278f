"""Batched anti-diagonal wavefront aligner — DW_banded.c on the device.

The draft ladder consensus aligns thousands of ~tspace-bp window pairs with
the vendored FALCON banded O(ND) aligner (`src/lib/DW_banded.c:_align`).
`ops/myers.py` transcribes it scalar-exactly and `io_native.cpp
myers_align_batch` is its multithreaded C batch form; THIS module is the
device form: the d-loop stays sequential (it is a true dependence) but
every diagonal lane of every window in the batch advances in parallel — (B, lanes) furthest-reaching updates per step, snake extension as
chunked vector compares, adaptive band maintenance as masked reductions.

Exactness: identical tie-breaking (`k == min_k || (k != max_k && V[k-1] <
V[k+1])`, DW_banded.c:140-147), identical adaptive band pruning
(best_m - band_tolerance, :188-201), identical termination (first k in
ascending order reaching an end, :169-180; max_d = 0.3*(m+n) cap and
band_size overflow abort, :131-137).  The forward pass records the
band-relative V history; the traceback re-derives each predecessor choice
from that history on device; row emission is one flat vectorized pass.
Every output is asserted byte-identical to `myers.align_pair` (the scalar
oracle) in tests/test_wavefront.py.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

GAP = 4
_PAD_Q = 4  # pad codes chosen so q-pad never equals t-pad nor a real base
_PAD_T = 5


# ---------------------------------------------------------------------------
# forward wave
# ---------------------------------------------------------------------------


def _snake_batch(q, t, x0, y0, active0, chunk: int):
    """Vectorized greedy snake: run lengths of maximal match runs starting
    at (x0, y0) per lane (DW_banded.c:158-165).  Chunked compares — most
    runs resolve in one chunk; perfect windows loop L/chunk times."""
    B, KB = x0.shape
    L = q.shape[1]
    coff = jnp.arange(chunk, dtype=jnp.int32)
    qf = q.reshape(-1)
    tf = t.reshape(-1)
    base = (jnp.arange(B, dtype=jnp.int32) * L)[:, None, None]

    def cond(st):
        run, active = st
        return active.any()

    def body(st):
        run, active = st
        xi = jnp.clip(x0 + run, 0, L - 1)[..., None] + coff
        yi = jnp.clip(y0 + run, 0, L - 1)[..., None] + coff
        qc = jnp.take(qf, base + jnp.clip(xi, 0, L - 1))
        tc = jnp.take(tf, base + jnp.clip(yi, 0, L - 1))
        eq = qc == tc
        all_eq = eq.all(axis=-1)
        inc = jnp.where(all_eq, chunk, jnp.argmin(eq, axis=-1).astype(jnp.int32))
        run = run + jnp.where(active, inc, 0)
        return run, active & all_eq

    run0 = jnp.zeros_like(x0)
    run, _ = jax.lax.while_loop(cond, body, (run0, active0))
    return run


@functools.partial(jax.jit, static_argnames=("max_d", "kb", "chunk"))
def _wave_forward(q, t, m, n, band_tolerance, *, max_d: int, kb: int,
                  chunk: int = 16):
    """Forward DW wave over a padded batch.

    q, t: uint8 [B, L] (q padded with 4, t with 5 so pads never match);
    m, n: int32 [B] true lengths.  Returns the per-d band-relative history
    (Vh int16 [B, max_d, kb], minkh/maxkh int16 [B, max_d]) plus terminal
    state (aligned, d_fin, k_fin, x_fin).
    """
    B, L = q.shape
    K0 = max_d
    KW = 2 * max_d + 2
    band_size = band_tolerance * 2
    lane = jnp.arange(kb, dtype=jnp.int32)
    bidx = jnp.arange(B, dtype=jnp.int32)[:, None]

    dmax = (0.3 * (m + n)).astype(jnp.int32)  # int cast like the oracle

    def body(d, st):
        (V, U, best_m, min_k, max_k, done, aligned, d_fin, k_fin, x_fin,
         Vh, minkh, maxkh) = st
        live = (~done) & (d < dmax)
        overflow = (max_k - min_k) > band_size  # DW_banded.c:131-137
        done = done | (live & overflow)
        live = live & ~overflow

        k = min_k[:, None] + 2 * lane[None, :]
        lane_ok = (2 * lane[None, :] <= (max_k - min_k)[:, None]) & live[:, None]
        idx = k + K0
        gidx = jnp.clip(idx, 1, KW - 2)
        Vm1 = jnp.take_along_axis(V, gidx - 1, axis=1)
        Vp1 = jnp.take_along_axis(V, gidx + 1, axis=1)
        take_right = (k == min_k[:, None]) | (
            (k != max_k[:, None]) & (Vm1 < Vp1)
        )
        x0 = jnp.where(take_right, Vp1, Vm1 + 1)
        y0 = x0 - k
        run = _snake_batch(
            q, t, x0, y0,
            lane_ok & (x0 < m[:, None]) & (y0 < n[:, None]), chunk,
        )
        x = x0 + run
        y = y0 + run

        # history (band-relative lanes)
        Vh = Vh.at[:, d, :].set(jnp.where(lane_ok, x, 0).astype(jnp.int16))
        minkh = minkh.at[:, d].set(
            jnp.where(live, min_k, 0).astype(jnp.int16))
        maxkh = maxkh.at[:, d].set(
            jnp.where(live, max_k, 0).astype(jnp.int16))

        # masked write-back of V / U (out-of-range index drops padded lanes)
        sidx = jnp.where(lane_ok, idx, KW)
        V = V.at[bidx, sidx].set(x, mode="drop")
        U = U.at[bidx, sidx].set(x + y, mode="drop")

        # termination: FIRST k ascending with x >= m or y >= n (:169-180)
        fin = lane_ok & ((x >= m[:, None]) | (y >= n[:, None]))
        any_fin = fin.any(axis=1)
        flane = jnp.argmax(fin, axis=1)
        hit = live & any_fin
        aligned = aligned | hit
        done = done | hit
        d_fin = jnp.where(hit, d, d_fin)
        k_fin = jnp.where(hit, min_k + 2 * flane, k_fin)
        x_fin = jnp.where(hit, x[bidx[:, 0], flane], x_fin)

        # band update for live windows that did not finish (:188-201)
        upd = live & ~any_fin
        u_val = x + y
        best_m2 = jnp.maximum(
            best_m, jnp.where(lane_ok, u_val, -(1 << 30)).max(axis=1)
        )
        keep = lane_ok & (u_val >= (best_m2 - band_tolerance)[:, None])
        new_min = jnp.where(keep, k, 1 << 30).min(axis=1)
        new_max = jnp.where(keep, k, -(1 << 30)).max(axis=1)
        new_min = jnp.where(keep.any(axis=1), new_min, max_k)  # :188 defaults
        new_max = jnp.where(keep.any(axis=1), new_max, min_k)
        min_k = jnp.where(upd, new_min - 1, min_k)
        max_k = jnp.where(upd, new_max + 1, max_k)
        best_m = jnp.where(upd, best_m2, best_m)
        return (V, U, best_m, min_k, max_k, done, aligned, d_fin, k_fin,
                x_fin, Vh, minkh, maxkh)

    z = jnp.zeros((B,), jnp.int32)
    st = (
        jnp.zeros((B, KW), jnp.int32), jnp.zeros((B, KW), jnp.int32),
        jnp.full((B,), -1, jnp.int32), z, z,
        jnp.zeros((B,), bool), jnp.zeros((B,), bool), z, z, z,
        jnp.zeros((B, max_d, kb), jnp.int16),
        jnp.zeros((B, max_d), jnp.int16), jnp.zeros((B, max_d), jnp.int16),
    )
    st = jax.lax.fori_loop(0, max_d, body, st)
    (V, U, best_m, min_k, max_k, done, aligned, d_fin, k_fin, x_fin,
     Vh, minkh, maxkh) = st
    return Vh, minkh, maxkh, aligned, d_fin, k_fin, x_fin


# ---------------------------------------------------------------------------
# traceback
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("max_d",))
def _wave_backtrack(Vh, minkh, maxkh, aligned, d_fin, k_fin, x_fin,
                    *, max_d: int):
    """Path points from the V history: pts[2d] = snake start of step d,
    pts[2d+1] = snake end; valid for d <= d_fin (aligned windows only).
    The predecessor choice is re-derived with the forward tie rule from
    row d-1 of the history (so no per-cell pre_k storage is needed)."""
    B = Vh.shape[0]
    bb = jnp.arange(B, dtype=jnp.int32)
    px = jnp.zeros((B, 2 * max_d + 2), jnp.int32)
    py = jnp.zeros((B, 2 * max_d + 2), jnp.int32)

    def body(i, st):
        px, py, k, x2 = st
        d = d_fin - i  # walk d_fin .. 0
        on = aligned & (d >= 0)
        dm1 = jnp.maximum(d - 1, 0)
        mk1 = minkh[bb, dm1].astype(jnp.int32)
        xk1 = maxkh[bb, dm1].astype(jnp.int32)
        lm = jnp.clip((k - 1 - mk1) // 2, 0, Vh.shape[2] - 1)
        lp = jnp.clip((k + 1 - mk1) // 2, 0, Vh.shape[2] - 1)
        Vm1 = Vh[bb, dm1, lm].astype(jnp.int32)
        Vp1 = Vh[bb, dm1, lp].astype(jnp.int32)
        mk = minkh[bb, d].astype(jnp.int32)
        xk = maxkh[bb, d].astype(jnp.int32)
        take_right = (k == mk) | ((k != xk) & (Vm1 < Vp1))
        x1 = jnp.where(d == 0, 0, jnp.where(take_right, Vp1, Vm1 + 1))
        y1 = x1 - k
        pos = jnp.clip(2 * d, 0, px.shape[1] - 2)
        px = px.at[bb, pos].set(jnp.where(on, x1, px[bb, pos]))
        py = py.at[bb, pos].set(jnp.where(on, y1, py[bb, pos]))
        px = px.at[bb, pos + 1].set(jnp.where(on, x2, px[bb, pos + 1]))
        py = py.at[bb, pos + 1].set(jnp.where(on, x2 - k, py[bb, pos + 1]))
        # step to predecessor: its post-snake x is the value we chose from
        pre_k = jnp.where(take_right, k + 1, k - 1)
        x2p = jnp.where(take_right, Vp1, Vm1)
        k = jnp.where(on & (d > 0), pre_k, k)
        x2 = jnp.where(on & (d > 0), x2p, x2)
        return px, py, k, x2

    px, py, _, _ = jax.lax.fori_loop(
        0, max_d + 1, body, (px, py, k_fin, x_fin))
    return px, py


# ---------------------------------------------------------------------------
# row emission (host, one flat vectorized pass)
# ---------------------------------------------------------------------------


def _emit_rows_batch(qs, ts, px, py, npts, aligned):
    """Aligned rows per window from path points (align_pair's backtrack
    emission: vertical -> q gaps, horizontal -> t gaps, diagonal -> both).
    Returns list[(q_aln, t_aln)]; unaligned windows get empty rows
    (align_exact semantics)."""
    B = len(qs)
    out: List = [None] * B
    for i in range(B):
        if not aligned[i]:
            out[i] = (np.zeros(0, np.uint8), np.zeros(0, np.uint8))
            continue
        np_i = int(npts[i])
        cx = px[i, :np_i]
        cy = py[i, :np_i]
        dq = np.diff(cx.astype(np.int64))
        dt = np.diff(cy.astype(np.int64))
        keep = (dq > 0) | (dt > 0)
        dq, dt = dq[keep], dt[keep]
        sx, sy = cx[:-1][keep], cy[:-1][keep]
        cols = np.maximum(dq, dt)
        totc = int(cols.sum())
        off = np.cumsum(cols) - cols
        rows_r = np.repeat(np.arange(len(cols)), cols)
        inner = np.arange(totc, dtype=np.int64) - off[rows_r]
        q_row = np.full(totc, GAP, np.uint8)
        t_row = np.full(totc, GAP, np.uint8)
        qm = dq[rows_r] > 0
        tm = dt[rows_r] > 0
        q_row[qm] = qs[i][(sx[rows_r] + inner)[qm]]
        t_row[tm] = ts[i][(sy[rows_r] + inner)[tm]]
        out[i] = (q_row, t_row)
    return out


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def align_exact_batch_device(
    qs: Sequence[np.ndarray],
    ts: Sequence[np.ndarray],
    band_tolerance: int = 150,
    max_batch: int = 256,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """DW_banded-exact rows for a batch of windows, computed on the default
    JAX device.  Byte-identical to myers.align_exact /
    the native myers_align_batch."""
    B = len(qs)
    if B == 0:
        return []
    out: List = [None] * B
    # bucket by size so padding (and max_d) stays tight
    lens = np.array([len(qs[i]) + len(ts[i]) for i in range(B)])
    order = np.argsort(lens, kind="stable")
    for blk in range(0, B, max_batch):
        sel = order[blk : blk + max_batch]
        res = _align_block([qs[i] for i in sel], [ts[i] for i in sel],
                           band_tolerance)
        for j, i in enumerate(sel):
            out[i] = res[j]
    return out


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _align_block(qs, ts, band_tolerance):
    B = len(qs)
    m = np.array([len(q) for q in qs], np.int32)
    n = np.array([len(t) for t in ts], np.int32)
    # empty-vs-empty windows: align_pair returns empty rows, aligned=True
    Lmax = max(1, int(max(m.max(), n.max())))
    chunk = 16
    L = _round_up(Lmax + chunk, 128)
    q = np.full((B, L), _PAD_Q, np.uint8)
    t = np.full((B, L), _PAD_T, np.uint8)
    for i in range(B):
        q[i, : m[i]] = qs[i]
        t[i, : n[i]] = ts[i]
    max_d = max(2, int(0.3 * int((m + n).max())))
    kb = band_tolerance + 2
    Vh, minkh, maxkh, aligned, d_fin, k_fin, x_fin = _wave_forward(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(m), jnp.asarray(n),
        jnp.int32(band_tolerance), max_d=max_d, kb=kb, chunk=chunk,
    )
    px, py = _wave_backtrack(Vh, minkh, maxkh, aligned, d_fin, k_fin, x_fin,
                             max_d=max_d)
    px = np.asarray(px)
    py = np.asarray(py)
    aligned_h = np.asarray(aligned)
    npts = 2 * (np.asarray(d_fin) + 1)
    # zero-length pair: scalar align_pair short-circuits to aligned/empty
    both_empty = (m == 0) & (n == 0)
    aligned_h = aligned_h | both_empty
    npts = np.where(both_empty, 0, npts)
    return _emit_rows_batch(qs, ts, px, py, npts, aligned_h)
