"""Device-side hinge calling (filter.cpp:838-1070 as one jitted kernel).

The reference walks, per read and per repeat annotation, the read's non-self
pileup: counts supporting matches whose A-end (out-hinge, gradient -1) or
A-start (in-hinge, +1) lands within HINGE_TOLERANCE_LENGTH of the annotation
and whose far-side B overhang exceeds THETA, then decides bridged/unbridged
by scanning the supporters' other ends sorted by (coordinate, overhang)
(pairAscend/pairDescend, filter.cpp:914-1065).

Device shape: every (read, annotation) pair becomes one row of a padded
[T, P] batch (P = padded pileup width, bucketed to powers of two).  The
sequential early-exit scan is value-deterministic after the sort, so it
reduces to cumulative counts + a first-trigger-index comparison:

  fail_idx  = first index where an extending/short-overhang supporter trips
              the unbridged condition (extending > HRUT, or considered >
              HRUT with spread > HBL)
  succ_idx  = first index where a long-overhang supporter sits in a pileup
              window of > HBPT entries (bin width HBL)
  bridged   = not (fail_idx < succ_idx)     [scan default: bridged]

Elements with overhang == THETA are walked over without counting, exactly
like the reference's if/elif chain.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.int32(1) << 29  # > any read coordinate/overhang; non-supporters sort last


@functools.partial(
    jax.jit,
    static_argnames=("theta", "htl", "hbl", "hrut", "hbpt"),
)
def _hinge_kernel(
    pos_a, grad, m0, m1, rid,
    ams, ame, lov, rov, valid,
    ordidx=None,
    *, theta: int, htl: int, hbl: int, hrut: int, hbpt: int,
):
    """tasks: pos_a/grad/m0/m1/rid int32 [T]; per-read padded rows
    ams/ame/lov/rov int32 [R, P], valid bool [R, P].

    ordidx (optional) int32 [T, P]: per-task scan order — each row lists
    the pileup indices of the task's supporters in the REFERENCE's exact
    std::sort(pairAscend/pairDescend) order (computed host-side with the
    libstdc++ introsort oracle; entries >= P are padding).  Without it
    the kernel uses a deterministic (first, second) lexicographic order —
    equivalent except on exact .first ties, where the reference's
    introsort permutation is unspecified-but-replicable (found by the
    sweep's dense-profile reference-parity column, r5).
    Returns (bridged bool [T], support int32 [T])."""
    A0 = ams[rid]   # [T, P] A-start
    A1 = ame[rid]   # A-end
    LO = lov[rid]   # left overhang
    RO = rov[rid]   # right overhang
    VV = valid[rid]
    pos = pos_a[:, None]
    is_out = (grad == -1)[:, None]

    # supporters (filter.cpp:874-898)
    near_out = (A1 > pos - htl) & (A1 < pos + htl) & (RO > theta) & VV
    near_in = (A0 > pos - htl) & (A0 < pos + htl) & (LO > theta) & VV
    near = jnp.where(is_out, near_out, near_in)
    support = near.sum(axis=1).astype(jnp.int32)

    # scan elements: (first, second) = (A-start, left ovh) ascending for
    # out-hinges, (A-end, right ovh) descending for in-hinges.
    # Lexicographic order via two stable int32 argsorts (LSD radix over the
    # two keys) — a single packed first*2^21+second key needs 42 bits and
    # silently wrapped in int32 before x64-less jax, reordering supporters
    # (found by adversarial fuzz, round 3).
    first = jnp.where(is_out, A0, A1)
    second = jnp.where(is_out, LO, RO)
    tk = jnp.take_along_axis
    if ordidx is not None:
        P_ = first.shape[1]
        in_range = ordidx < P_
        order = jnp.clip(ordidx, 0, P_ - 1)
        firs = tk(first, order, axis=1)
        secs = tk(second, order, axis=1)
        vals = tk(near, order, axis=1) & in_range
    else:
        k2 = jnp.where(near, jnp.where(is_out, second, -second), _BIG)
        o1 = jnp.argsort(k2, axis=1, stable=True)
        k1 = jnp.where(near, jnp.where(is_out, first, -first), _BIG)
        o2 = jnp.argsort(jnp.take_along_axis(k1, o1, axis=1), axis=1,
                         stable=True)
        order = jnp.take_along_axis(o1, o2, axis=1)
        firs = tk(first, order, axis=1)
        secs = tk(second, order, axis=1)
        vals = tk(near, order, axis=1)

    mask_ref = jnp.where(is_out, m0[:, None], m1[:, None])
    dist = jnp.where(is_out, firs - mask_ref, mask_ref - firs)
    a_flag = vals & (dist < hbl)
    b_flag = vals & ~a_flag & (secs < theta)
    c_flag = vals & ~a_flag & (secs > theta)

    considered = jnp.cumsum((a_flag | b_flag | c_flag).astype(jnp.int32), axis=1)
    extending = jnp.cumsum(a_flag.astype(jnp.int32), axis=1)
    first0 = firs[:, :1]
    spread = jnp.where(is_out, firs - first0, first0 - firs)
    fail = (a_flag | b_flag) & (
        (extending > hrut) | ((considered > hrut) & (spread > hbl))
    )

    # pileup window size at each element (same direction as the sort):
    # out: count of j >= idx with firs[j] - firs[idx] < hbl
    # in : count of j >= idx with firs[idx] - firs[j] < hbl
    # The primary sort key (±first, BIG for non-supporters) is non-decreasing
    # along each row, so the window is contiguous from idx and one
    # searchsorted per row replaces the old [T, P, P] pairwise matrix
    # (134MB of intermediates that thrashed the allocator when this kernel
    # interleaved with the 20M-point trim lattice).
    g = jnp.where(vals, jnp.where(is_out, firs, -firs), _BIG)
    # non-decreasing along each row: supporters are in ±first-ascending
    # order (both the lexicographic and the introsort paths), pads at BIG
    upto = jax.vmap(lambda row, q: jnp.searchsorted(row, q, side="left"))(
        g, g + hbl
    )
    pileup_len = upto.astype(jnp.int32) - jnp.arange(
        g.shape[1], dtype=jnp.int32
    )[None, :]
    succ = c_flag & (pileup_len > hbpt)

    P = firs.shape[1]
    idxs = jnp.arange(P, dtype=jnp.int32)[None, :]
    fail_idx = jnp.min(jnp.where(fail, idxs, P), axis=1)
    succ_idx = jnp.min(jnp.where(succ, idxs, P), axis=1)
    bridged = ~(fail_idx < succ_idx)
    return bridged, support


def introsort_perm(keys: np.ndarray, descending: bool) -> np.ndarray:
    """The EXACT std::sort permutation (libstdc++ introsort) for a
    single-key comparator — the tie arrangement the reference's
    pairAscend/pairDescend/compare_overlap sorts produce.  Falls back to
    a stable argsort when the native oracle is unavailable (deviation
    only on exact key ties; documented in docs/DESIGN.md)."""
    import ctypes

    from hinge_tpu.native import get_lib

    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if not descending:
        keys = -keys
    lib = get_lib()
    if lib is None or not hasattr(lib, "stdsort_desc_perm"):
        return np.argsort(-keys, kind="stable")
    out = np.zeros(len(keys), np.int32)
    lib.stdsort_desc_perm(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(keys)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def task_scan_orders(
    tasks, pos_a, grad, read_rows, P: int,
    theta: int, htl: int,
) -> np.ndarray:
    """Per-task supporter scan order [T, P]: the reference filters the
    (compare_overlap-ordered) pileup to supporters and std::sorts their
    other ends with pairAscend (out-hinges, .first ascending) or
    pairDescend (in-hinges, descending) — comparators on .first ONLY, so
    the tie arrangement is introsort's (filter.cpp:914, :1010).  Entries
    >= P mark padding."""
    T = len(pos_a)
    out = np.full((T, P), P, np.int32)
    for t in range(T):
        r = int(tasks[t][0])
        a0, a1, lo, ro = read_rows[r]
        pos = int(pos_a[t])
        if int(grad[t]) == -1:
            near = (a1 > pos - htl) & (a1 < pos + htl) & (ro > theta)
            first = a0
            desc = False
        else:
            near = (a0 > pos - htl) & (a0 < pos + htl) & (lo > theta)
            first = a1
            desc = True
        idx = np.nonzero(near)[0]
        if len(idx):
            perm = introsort_perm(first[idx], descending=desc)
            out[t, : len(idx)] = idx[perm]
    return out


def call_hinges_device(
    tasks: np.ndarray,      # [T, 2]: (read id, annotation index within read)
    pos_a: np.ndarray,      # [T]
    grad: np.ndarray,       # [T]
    m0: np.ndarray, m1: np.ndarray,  # [T] mask ends of the read
    read_rows: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    theta: int, htl: int, hbl: int, hrut: int, hbpt: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad each task's read pileup into a [R, P] bucket and run the kernel.

    read_rows maps read id -> (ams, ame, left_ovh, right_ovh) arrays IN
    THE REFERENCE'S PILEUP ORDER (compare_overlap introsort — the caller
    applies it); the per-task supporter scan order is computed here with
    the same oracle (task_scan_orders) and passed to the kernel.
    Returns (bridged bool [T], support int32 [T]).
    """
    T = len(pos_a)
    if T == 0:
        return np.zeros(0, bool), np.zeros(0, np.int32)
    rids_unique = sorted({int(r) for r, _ in tasks})
    rmap = {r: k for k, r in enumerate(rids_unique)}
    pmax = max(len(read_rows[r][0]) for r in rids_unique)
    P = 8
    while P < pmax:
        P *= 2
    R = len(rids_unique)
    ams = np.zeros((R, P), np.int32)
    ame = np.zeros((R, P), np.int32)
    lov = np.zeros((R, P), np.int32)
    rov = np.zeros((R, P), np.int32)
    valid = np.zeros((R, P), bool)
    for r in rids_unique:
        k = rmap[r]
        a0, a1, lo, ro = read_rows[r]
        n = len(a0)
        ams[k, :n] = a0
        ame[k, :n] = a1
        lov[k, :n] = lo
        rov[k, :n] = ro
        valid[k, :n] = True
    rid = np.array([rmap[int(r)] for r, _ in tasks], np.int32)
    ordidx = task_scan_orders(tasks, pos_a, grad, read_rows, P,
                              theta=theta, htl=htl)
    bridged, support = _hinge_kernel(
        jnp.asarray(pos_a, jnp.int32), jnp.asarray(grad, jnp.int32),
        jnp.asarray(m0, jnp.int32), jnp.asarray(m1, jnp.int32),
        jnp.asarray(rid),
        jnp.asarray(ams), jnp.asarray(ame), jnp.asarray(lov),
        jnp.asarray(rov), jnp.asarray(valid),
        jnp.asarray(ordidx),
        theta=theta, htl=htl, hbl=hbl, hrut=hrut, hbpt=hbpt,
    )
    return np.asarray(bridged), np.asarray(support)
