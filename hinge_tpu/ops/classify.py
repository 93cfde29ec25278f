"""Overlap trimming, classification, and trace-point coordinate walks.

Reference: `LOverlap::trim_overlap` (LAInterface.cpp:4552-4683),
`LOverlap::AddTypesAsymmetric` (:4721-4806),
`LOverlap::GetMatchingPosition` (:4498-4546) — all scalar walks over the
DALIGNER trace-point lattice, called once per overlap.

Device formulation: the per-overlap walk becomes dense ops over a *flat
point array* covering all overlaps at once.  An overlap with P trace pairs
has P+1 lattice points; point k has an analytic A coordinate

    A_0 = a_start,  A_k = (a_start//tspace + k) * tspace,  A_P = a_end

and a B coordinate from a segmented prefix-sum of the trace displacements.
"First/last point satisfying a predicate" (trim) is a masked segment-min/max;
GetMatchingPosition is a closed-form index computation + one gather.  No
sequential loops, so XLA lays everything out as a handful of fused passes.

MatchType codes (shared with tests/oracles.py) follow the reference enum
order (LAInterface.h:30-45).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# MatchType enum (LAInterface.h:30-32)
FORWARD = 0
BACKWARD = 1
ACOVERB = 2
BCOVERA = 3
UNDEFINED = 4

#: Reference quirk: LOverlap::trim_overlap (LAInterface.cpp:4583-4589) and
#: GetMatchingPosition (:4523-4529) walk the trace lattice on a HARDCODED
#: 100-base grid — `% 100`, `ceil(x/100.0)*100`, `+= 100` — regardless of
#: the .las file's actual trace spacing.  At tspace > 100 the walk
#: misaligns with the stored displacements and trim/classification degrade
#: exactly as the reference's do (pinned at tspace=150 by
#: tests/test_reference_parity.py profile 92).  Every trim/classify/
#: matching-position call site must pass this, NOT ov.tspace; only trace
#: RECOVERY (recoverAlignment -> Compute_Trace_PTS, ops/dalign_trace.py)
#: uses the true spacing.
TRIM_GRID = 100
INTERNAL = 5
NOT_ACTIVE = 6
FORWARD_INTERNAL = 12
BACKWARD_INTERNAL = 13


class TraceWalk(NamedTuple):
    """Host-prepped flat lattice arrays for a batch of overlaps."""

    npairs: np.ndarray  # int32 [n_ov] trace pairs per overlap (tlen//2)
    pair_off: np.ndarray  # int64 [n_ov] first pair index in disp/cum arrays
    disp: np.ndarray  # int32 [total_pairs] b-displacement per pair
    cum: np.ndarray  # int32 [total_pairs] inclusive prefix sum within overlap


def build_trace_walk(ov) -> TraceWalk:
    """Extract displacement prefix-sums from an OverlapStore (host, one pass).

    Avoids materializing a segment-id array: local pair indices come from an
    in-place subtraction of the repeated offsets, and the segmented prefix
    sum subtracts repeated segment baselines (2 CPUs here — every pass over
    the ~#records*~50 flat pair array counts).
    """
    npairs = (ov.tlen // 2).astype(np.int32)
    pair_off = np.zeros(ov.n, dtype=np.int64)
    np.cumsum(npairs[:-1], out=pair_off[1:])
    total = int(npairs.sum())
    # src = trace_off[seg] + 2*(k - pair_off[seg]) + 1, built in place
    src = np.arange(total, dtype=np.int64)
    src -= np.repeat(pair_off, npairs)  # local pair index k
    src <<= 1
    src += 1
    src += np.repeat(ov.trace_off, npairs)
    disp = ov.trace[src].astype(np.int32)
    csum = np.cumsum(disp, dtype=np.int64)
    seg_start = csum[pair_off] - disp[pair_off]
    cum = csum
    cum -= np.repeat(seg_start, npairs)
    return TraceWalk(npairs=npairs, pair_off=pair_off, disp=disp, cum=cum.astype(np.int32))


@jax.jit
def _lattice_points(
    a_start, a_end, b_start, b_end, rc, npairs, pair_off, cum, seg_id, k_local, tspace
):
    """Flat lattice point coordinates (A_k, W_k) for all overlaps.

    seg_id/k_local index the flat point array (one overlap has npairs+1
    points). Returns (A, W) int32 flat arrays.
    """
    a0 = a_start[seg_id]
    npr = npairs[seg_id]
    interior = (jnp.floor_divide(a0, tspace) + k_local) * tspace
    A = jnp.where(k_local == 0, a0, jnp.where(k_local == npr, a_end[seg_id], interior))
    sign = 1 - 2 * rc[seg_id]
    w0 = jnp.where(rc[seg_id] == 1, b_end[seg_id], b_start[seg_id])
    wend = jnp.where(rc[seg_id] == 1, b_start[seg_id], b_end[seg_id])
    # W_k = w0 + sign * sum(disp[0..k-1]) = w0 + sign * cum[pair_off + k - 1]
    cidx = pair_off[seg_id] + jnp.maximum(k_local - 1, 0)
    csum = jnp.where(k_local == 0, 0, cum[cidx])
    W = jnp.where(k_local == npr, wend, w0 + sign * csum)
    return A.astype(jnp.int32), W.astype(jnp.int32)


def make_point_index(npairs: np.ndarray):
    """Host helper: flat (seg_id, k_local, point_off) for npairs+1 points."""
    npts = npairs.astype(np.int64) + 1
    point_off = np.zeros(len(npairs), dtype=np.int64)
    np.cumsum(npts[:-1], out=point_off[1:])
    total = int(npts.sum())
    seg_id = np.repeat(np.arange(len(npairs), dtype=np.int32), npts)
    k_local = np.arange(total, dtype=np.int64)
    k_local -= np.repeat(point_off, npts)
    return seg_id, k_local.astype(np.int32), point_off


@functools.partial(jax.jit, static_argnames=("tspace",))
def trim_overlaps(
    a_start, a_end, b_start, b_end, rc,
    eff_a_read_start, eff_a_read_end, eff_b_read_start, eff_b_read_end,
    npairs, pair_off, cum, seg_id, k_local,
    *,
    tspace: int,
):
    """Batched LOverlap::trim_overlap.

    eff_*_read_* are the per-overlap *read* masks (already gathered for the
    A/B read of each overlap). Returns (eff_a_match_start, eff_a_match_end,
    eff_b_match_start, eff_b_match_end, active).
    """
    n_ov = a_start.shape[0]
    A, W = _lattice_points(
        a_start, a_end, b_start, b_end, rc, npairs, pair_off, cum, seg_id, k_local, tspace
    )
    eas = eff_a_read_start[seg_id]
    eae = eff_a_read_end[seg_id]
    ebs = eff_b_read_start[seg_id]
    ebe = eff_b_read_end[seg_id]
    rcs = rc[seg_id]
    # start predicate: rc=0 -> A>=eas & W>=ebs ; rc=1 -> A>=eas & W<=ebe
    start_ok = (A >= eas) & jnp.where(rcs == 1, W <= ebe, W >= ebs)
    # end predicate:   rc=0 -> A<=eae & W<=ebe ; rc=1 -> A<=eae & W>=ebs
    end_ok = (A <= eae) & jnp.where(rcs == 1, W >= ebs, W <= ebe)

    BIG = jnp.int32(1 << 30)
    first_k = jax.ops.segment_min(
        jnp.where(start_ok, k_local, BIG), seg_id, num_segments=n_ov
    )
    last_k = jax.ops.segment_max(
        jnp.where(end_ok, k_local, -1), seg_id, num_segments=n_ov
    )
    npts = npairs + 1  # points per overlap; "not found" start idx = npts
    sidx = jnp.where(first_k >= BIG, npts, first_k)
    eidx = jnp.where(last_k < 0, 0, last_k)

    # gather selected point coords (safe index when not found)
    pt_off = jnp.zeros_like(pair_off)
    # point offsets: pair_off + overlap index (each overlap adds one extra pt)
    pt_off = pair_off + jnp.arange(n_ov, dtype=pair_off.dtype)
    sA = A[pt_off + jnp.clip(sidx, 0, npairs)]
    sW = W[pt_off + jnp.clip(sidx, 0, npairs)]
    eA = A[pt_off + jnp.clip(eidx, 0, npairs)]
    eW = W[pt_off + jnp.clip(eidx, 0, npairs)]

    found_s = first_k < BIG
    found_e = last_k >= 0
    eff_a_ms = jnp.where(found_s, sA, a_start)
    eff_a_me = jnp.where(found_e, eA, a_end)
    # rc=0: start point carries (ams,bms), end point (ame,bme)
    # rc=1: start point carries (ams,bme), end point (ame,bms)
    eff_b_ms = jnp.where(
        rc == 1, jnp.where(found_e, eW, b_start), jnp.where(found_s, sW, b_start)
    )
    eff_b_me = jnp.where(
        rc == 1, jnp.where(found_s, sW, b_end), jnp.where(found_e, eW, b_end)
    )
    active = sidx < eidx  # (LAInterface.cpp:4667-4670)
    return eff_a_ms, eff_a_me, eff_b_ms, eff_b_me, active


@jax.jit
def add_types_asymmetric(
    eff_a_match_start, eff_a_match_end, eff_b_match_start, eff_b_match_end,
    eff_a_read_start, eff_a_read_end, eff_b_read_start, eff_b_read_end,
    rc, max_overhang, min_overhang,
):
    """Batched LOverlap::AddTypesAsymmetric (LAInterface.cpp:4721-4806)."""
    oal = eff_a_match_start - eff_a_read_start
    oar = eff_a_read_end - eff_a_match_end
    obl0 = eff_b_match_start - eff_b_read_start
    obr0 = eff_b_read_end - eff_b_match_end
    obl = jnp.where(rc == 1, obr0, obl0)
    obr = jnp.where(rc == 1, obl0, obr0)

    t = jnp.full(oal.shape, UNDEFINED, dtype=jnp.int32)
    c_bcovera = (jnp.maximum(oal, oar) < max_overhang) & (jnp.minimum(obl, obr) > min_overhang)
    c_acoverb = (jnp.maximum(obl, obr) < max_overhang) & (jnp.minimum(oal, oar) > min_overhang)
    c_internal = jnp.minimum(oal, oar) > max_overhang
    c_left = oal <= max_overhang
    c_bwd = (obr <= max_overhang) & (obl >= max_overhang)
    c_bwd_int = (obr >= max_overhang) & (obl >= max_overhang)
    c_right = oar <= max_overhang
    c_fwd = (obl <= max_overhang) & (obr >= max_overhang)
    c_fwd_int = (obl >= max_overhang) & (obr >= max_overhang)

    # mirror the if/else-if cascade in priority order; note the reference's
    # asymmetry: the BACKWARD branch leaves UNDEFINED untouched when neither
    # sub-case fires, while the FORWARD branch has an explicit else.
    t = jnp.where(
        c_bcovera, BCOVERA,
        jnp.where(
            c_acoverb, ACOVERB,
            jnp.where(
                c_internal, INTERNAL,
                jnp.where(
                    c_left,
                    jnp.where(c_bwd, BACKWARD, jnp.where(c_bwd_int, BACKWARD_INTERNAL, UNDEFINED)),
                    jnp.where(
                        c_right,
                        jnp.where(c_fwd, FORWARD, jnp.where(c_fwd_int, FORWARD_INTERNAL, UNDEFINED)),
                        UNDEFINED,
                    ),
                ),
            ),
        ),
    )
    return t.astype(jnp.int32)


def add_types_asymmetric_np(
    eff_a_match_start, eff_a_match_end, eff_b_match_start, eff_b_match_end,
    eff_a_read_start, eff_a_read_end, eff_b_read_start, eff_b_read_end,
    rc, max_overhang, min_overhang,
):
    """Numpy mirror of add_types_asymmetric (same cascade, same outputs) —
    used by the host fast path in ops/pairs.process_alignments; cross-pinned
    against the jitted kernel in tests/test_classify_ops.py."""
    oal = eff_a_match_start - eff_a_read_start
    oar = eff_a_read_end - eff_a_match_end
    obl0 = eff_b_match_start - eff_b_read_start
    obr0 = eff_b_read_end - eff_b_match_end
    obl = np.where(rc == 1, obr0, obl0)
    obr = np.where(rc == 1, obl0, obr0)

    c_bcovera = (np.maximum(oal, oar) < max_overhang) & (np.minimum(obl, obr) > min_overhang)
    c_acoverb = (np.maximum(obl, obr) < max_overhang) & (np.minimum(oal, oar) > min_overhang)
    c_internal = np.minimum(oal, oar) > max_overhang
    c_left = oal <= max_overhang
    c_bwd = (obr <= max_overhang) & (obl >= max_overhang)
    c_bwd_int = (obr >= max_overhang) & (obl >= max_overhang)
    c_right = oar <= max_overhang
    c_fwd = (obl <= max_overhang) & (obr >= max_overhang)
    c_fwd_int = (obl >= max_overhang) & (obr >= max_overhang)

    t = np.where(
        c_bcovera, BCOVERA,
        np.where(
            c_acoverb, ACOVERB,
            np.where(
                c_internal, INTERNAL,
                np.where(
                    c_left,
                    np.where(c_bwd, BACKWARD, np.where(c_bwd_int, BACKWARD_INTERNAL, UNDEFINED)),
                    np.where(
                        c_right,
                        np.where(c_fwd, FORWARD, np.where(c_fwd_int, FORWARD_INTERNAL, UNDEFINED)),
                        UNDEFINED,
                    ),
                ),
            ),
        ),
    )
    return t.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("tspace",))
def matching_position(
    ov_idx,  # int32 [m] overlap row per query
    pos_a,  # int32 [m] A position per query
    a_start, a_end, b_start, b_end, rc,
    npairs, pair_off, cum,
    *,
    tspace: int,
):
    """Batched LOverlap::GetMatchingPosition (LAInterface.cpp:4498-4546).

    Closed form: the scalar loop returns W_j + (pos - A_j) for the smallest
    j in [0, P-1] with A_{j+1} >= pos; after the loop (j = P-1 reached with
    A_{P-1} < pos) the same formula applies, else -2.  Out-of-match pos
    returns -1.
    """
    a0 = a_start[ov_idx]
    P = npairs[ov_idx]
    base = jnp.floor_divide(a0, tspace)
    sign = 1 - 2 * rc[ov_idx]
    w0 = jnp.where(rc[ov_idx] == 1, b_end[ov_idx], b_start[ov_idx])

    # smallest j >= 0 with A_{j+1} = (base+j+1)*tspace >= pos
    j_raw = jnp.floor_divide(pos_a + tspace - 1, tspace) - base - 1
    # exhausted = the scalar loop ran out: no j in [0, P-2] qualifies.  P=1
    # runs zero iterations, so it is ALWAYS exhausted — even when j_raw is
    # -1 (pos == a_start on a tspace multiple), found by property fuzzing
    exhausted = (j_raw > P - 2) | (P <= 1)
    j = jnp.clip(jnp.where(exhausted, P - 1, jnp.maximum(j_raw, 0)), 0, None)
    A_j = jnp.where(j == 0, a0, (base + j) * tspace)
    cidx = pair_off[ov_idx] + jnp.maximum(j - 1, 0)
    W_j = w0 + sign * jnp.where(j == 0, 0, cum[cidx])
    res = W_j + pos_a - A_j
    # after-loop fallthrough: return only if cur_a < pos, else -2
    res = jnp.where(exhausted & (A_j >= pos_a), -2, res)
    out_of_range = (pos_a < a0) | (pos_a > a_end[ov_idx])
    return jnp.where(out_of_range, -1, res).astype(jnp.int32)
