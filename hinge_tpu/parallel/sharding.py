"""Multi-chip sharding of the record-stream kernels.

The reference's only parallelism notion is `.las` partitioning by A-read id
(--mlas, filter.cpp:35-63) on one host.  This design shards the
same way but across a device mesh (SURVEY.md §2.3):

    mesh axes:  ('reads', 'recs')
      reads — data-parallel over contiguous A-read ranges (the --mlas axis)
      recs  — parallel over overlap records *within* a read range

Each device scatter-adds its record shard into a local (reads_chunk, bins)
grid; a `psum` over 'recs' merges the partial pileups (the scatter-add is
associative); the bin-axis cumsum, mask runs, and repeat annotation then run
data-parallel over 'reads' with no further communication.  The per-read mask
table — needed globally for B-side overhang lookups during hinge calling —
is `all_gather`ed over 'reads' at the end.  XLA hands the collectives to
NCCL (NVLink between the cards of a host); nothing else crosses shard
boundaries.

Beyond the filter pileups, the classify/trim lattice kernels
(`ops/classify.py`), GetMatchingPosition queries, and the per-(A,B) top-k
selection all shard the same way — by contiguous A-read/record ranges, the
reference's own --mlas partitioning (filter.cpp:35-63).  Trim/classify and
matching-position are per-overlap segment ops with no cross-shard term at
all (the per-overlap effective-mask values are gathered host-side before
placement, exactly like the single-device path), so the shard_map bodies
are pure data parallelism; only the filter chain needs psum/all_gather.

Works identically on a mesh of GPUs and on the CPU backend with
`--xla_force_host_platform_device_count` virtual devices.  The mesh is a
plain reshape of the device list (make_mesh): every card of a host reaches
every other at the same rate, so no topology enters it.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hinge_tpu.ops import coverage as C


def make_mesh(n_devices: Optional[int] = None, rec_axis: Optional[int] = None) -> Mesh:
    """2D ('reads', 'recs') mesh over the available devices."""
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    if rec_axis is None:
        # favor the reads axis; use a recs axis when n has a factor of 2
        rec_axis = 2 if n % 2 == 0 and n > 2 else 1
    reads_axis = n // rec_axis
    mesh_devs = np.array(devs[:n]).reshape(reads_axis, rec_axis)
    return Mesh(mesh_devs, ("reads", "recs"))


def shard_records(
    a_id: np.ndarray,
    a_start: np.ndarray,
    a_end: np.ndarray,
    n_reads: int,
    mesh: Mesh,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Partition records into (reads_shards, recs_shards, pad) blocks.

    Records go to the reads-shard owning their A read (contiguous read
    ranges), then round-robin over recs-shards; every block is padded to the
    max block size with sentinel rows (a_rel = reads_chunk, dropped by the
    kernels' scatter mode='drop').  Returns (a_rel, a_start, a_end) with
    shape (R, S, pad) plus the per-shard read-chunk size.
    """
    R = mesh.shape["reads"]
    S = mesh.shape["recs"]
    reads_chunk = -(-n_reads // R)
    shard_of_read = np.minimum(a_id // reads_chunk, R - 1)
    blocks = [[None] * S for _ in range(R)]
    maxlen = 1
    for r in range(R):
        rows = np.nonzero(shard_of_read == r)[0]
        for s in range(S):
            sel = rows[s::S]
            blocks[r][s] = sel
            maxlen = max(maxlen, len(sel))
    a_rel = np.full((R, S, maxlen), reads_chunk, dtype=np.int32)  # pad row
    a_s = np.zeros((R, S, maxlen), dtype=np.int32)
    a_e = np.zeros((R, S, maxlen), dtype=np.int32)
    for r in range(R):
        base = r * reads_chunk
        for s in range(S):
            sel = blocks[r][s]
            a_rel[r, s, : len(sel)] = a_id[sel] - base
            a_s[r, s, : len(sel)] = a_start[sel]
            a_e[r, s, : len(sel)] = a_end[sel]
    return a_rel, a_s, a_e, reads_chunk


def sharded_filter_step(
    mesh: Mesh,
    *,
    reads_chunk: int,
    nb: int,
    reso: int = 40,
    cut_off: int = 300,
    min_cov: int = 5,
    coverage_fraction: int = 3,
    min_thresh: int = 10,
    max_thresh: int = 20,
    no_hinge_region: int = 500,
):
    """Build the jitted multi-chip filter step.

    Input arrays have shape (R, S, pad) sharded P('reads','recs'); read
    tables (lengths) have shape (R, reads_chunk) sharded P('reads').
    Returns (coverage [reads sharded], masks [replicated], annotations
    [reads sharded]).
    """

    def local_grid(a_rel, a_start, a_end, cutoff):
        sb = C.event_bins(a_start + cutoff, reso, nb)
        eb = C.event_bins(a_end - cutoff, reso, nb)
        grid = jnp.zeros(((reads_chunk + 1) * (nb + 1),), dtype=jnp.int32)
        grid = grid.at[a_rel * (nb + 1) + sb].add(1, mode="drop")
        grid = grid.at[a_rel * (nb + 1) + eb].add(-1, mode="drop")
        return grid.reshape(reads_chunk + 1, nb + 1)[:reads_chunk, :nb]

    def step(a_rel, a_start, a_end, read_len):
        # block-local views (shard_map passes per-device blocks)
        a_rel = a_rel.reshape(-1)
        a_start = a_start.reshape(-1)
        a_end = a_end.reshape(-1)
        read_len = read_len.reshape(-1)

        # partial pileup grids + psum over the record axis
        g0 = local_grid(a_rel, a_start, a_end, 0)
        gc = local_grid(a_rel, a_start, a_end, cut_off)
        g0 = jax.lax.psum(g0, "recs")
        gc = jax.lax.psum(gc, "recs")
        cov = jnp.cumsum(g0, axis=1, dtype=jnp.int32)
        cov_cut = jnp.cumsum(gc, axis=1, dtype=jnp.int32)

        # per-read n_entries from the psum'd record stats
        me = jnp.zeros((reads_chunk + 1,), dtype=jnp.int32).at[a_rel].max(
            a_end, mode="drop"
        )[:reads_chunk]
        mstart = jnp.full((reads_chunk + 1,), jnp.iinfo(jnp.int32).min,
                          dtype=jnp.int32).at[a_rel].max(a_start, mode="drop")[:reads_chunk]
        cnt = jnp.zeros((reads_chunk + 1,), dtype=jnp.int32).at[a_rel].add(
            1, mode="drop"
        )[:reads_chunk]
        me = jax.lax.pmax(me, "recs")
        mstart = jax.lax.pmax(mstart, "recs")
        cnt = jax.lax.psum(cnt, "recs")
        ne = C.n_entries_from_max_event(me, cnt, reso)
        # clipped profile: start+cutoff events can exceed every end-cutoff
        ne_cut = C.n_entries_from_max_event(
            jnp.maximum(me - cut_off, mstart + cut_off), cnt, reso)

        reduced = jnp.maximum(cov_cut - min_cov, 0)
        ms, mev, _, _ = C.coverage_mask(reduced, ne_cut, reso=reso)
        masks = jnp.stack([ms, mev], axis=1)

        ann = C.repeat_annotation_mask(
            cov, ne, ms, mev, jnp.int32(min_cov),
            reso=reso, coverage_fraction=coverage_fraction,
            min_thresh=min_thresh, max_thresh=max_thresh,
            no_hinge_region=no_hinge_region,
        )
        # global mask table for B-side overhang lookups (hinge calling)
        all_masks = jax.lax.all_gather(masks, "reads", axis=0, tiled=True)
        return cov, all_masks, ann

    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P("reads", "recs"), P("reads", "recs"), P("reads", "recs"), P("reads")),
        out_specs=(P("reads"), P(None), P("reads")),
        check_vma=False,
    )
    return jax.jit(fn)


def run_sharded_filter(
    a_id: np.ndarray,
    a_start: np.ndarray,
    a_end: np.ndarray,
    read_len: np.ndarray,
    mesh: Mesh,
    nb: Optional[int] = None,
    **params,
):
    """Host-side wrapper: shard, place, and execute one filter step."""
    n_reads = len(read_len)
    reso = params.get("reso", 40)
    if nb is None:
        nb = int(read_len.max()) // reso + 3
    a_rel, a_s, a_e, reads_chunk = shard_records(a_id, a_start, a_end, n_reads, mesh)
    R = mesh.shape["reads"]
    pad_reads = R * reads_chunk - n_reads
    rl = np.concatenate([read_len, np.zeros(pad_reads, read_len.dtype)]).reshape(
        R, reads_chunk
    )
    step = sharded_filter_step(mesh, reads_chunk=reads_chunk, nb=nb, **params)
    sh3 = NamedSharding(mesh, P("reads", "recs"))
    sh1 = NamedSharding(mesh, P("reads"))
    args = (
        jax.device_put(a_rel, sh3),
        jax.device_put(a_s, sh3),
        jax.device_put(a_e, sh3),
        jax.device_put(rl, sh1),
    )
    cov, masks, ann = step(*args)
    return cov, masks, ann, reads_chunk


def run_sharded_profiles(
    a_rel: np.ndarray, a_start: np.ndarray, a_end: np.ndarray,
    n_reads: int, mesh: Mesh,
    *, nb: int, reso: int, cut_off: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The filter stage's raw device profiles — (cov, cov_cut, ne, ne_cut)
    per read — computed over the mesh (record-scatter + psum/pmax).  The
    scatter-adds are integer and associative, so results are bit-identical
    to the single-device `stages.filter._device_profiles`; used when
    HINGE_SHARDED=1 routes stage internals through the mesh."""

    def step(a_rel, a_s, a_e, _):
        a_rel = a_rel.reshape(-1)
        a_s = a_s.reshape(-1)
        a_e = a_e.reshape(-1)

        def grid(cutoff):
            sb = C.event_bins(a_s + cutoff, reso, nb)
            eb = C.event_bins(a_e - cutoff, reso, nb)
            g = jnp.zeros(((reads_chunk + 1) * (nb + 1),), dtype=jnp.int32)
            g = g.at[a_rel * (nb + 1) + sb].add(1, mode="drop")
            g = g.at[a_rel * (nb + 1) + eb].add(-1, mode="drop")
            return jax.lax.psum(
                g.reshape(reads_chunk + 1, nb + 1)[:reads_chunk, :nb],
                "recs")

        cov = jnp.cumsum(grid(0), axis=1, dtype=jnp.int32)
        cov_cut = jnp.cumsum(grid(cut_off), axis=1, dtype=jnp.int32)
        me = jnp.zeros((reads_chunk + 1,), dtype=jnp.int32).at[a_rel].max(
            a_e, mode="drop")[:reads_chunk]
        mstart = jnp.full((reads_chunk + 1,), jnp.iinfo(jnp.int32).min,
                          dtype=jnp.int32).at[a_rel].max(
            a_s, mode="drop")[:reads_chunk]
        cnt = jnp.zeros((reads_chunk + 1,), dtype=jnp.int32).at[a_rel].add(
            1, mode="drop")[:reads_chunk]
        me = jax.lax.pmax(me, "recs")
        mstart = jax.lax.pmax(mstart, "recs")
        cnt = jax.lax.psum(cnt, "recs")
        ne = C.n_entries_from_max_event(me, cnt, reso)
        ne_cut = C.n_entries_from_max_event(
            jnp.maximum(me - cut_off, mstart + cut_off), cnt, reso)
        return cov, cov_cut, ne, ne_cut

    a_rel3, a_s3, a_e3, reads_chunk = shard_records(
        a_rel, a_start, a_end, n_reads, mesh)
    R = mesh.shape["reads"]
    rl = np.zeros((R, reads_chunk), np.int32)
    fn = jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("reads", "recs"),) * 3 + (P("reads"),),
        out_specs=(P("reads"), P("reads"), P("reads"), P("reads")),
        check_vma=False,
    ))
    sh3 = NamedSharding(mesh, P("reads", "recs"))
    sh1 = NamedSharding(mesh, P("reads"))
    cov, cov_cut, ne, ne_cut = fn(
        jax.device_put(a_rel3, sh3), jax.device_put(a_s3, sh3),
        jax.device_put(a_e3, sh3), jax.device_put(rl, sh1))
    return (np.asarray(cov)[:n_reads], np.asarray(cov_cut)[:n_reads],
            np.asarray(ne)[:n_reads], np.asarray(ne_cut)[:n_reads])


def stage_mesh():
    """The mesh stage internals use when HINGE_SHARDED=1 — None otherwise
    or when only one device is present."""
    import os

    if os.environ.get("HINGE_SHARDED", "0") != "1":
        return None
    if len(jax.devices()) < 2:
        return None
    return make_mesh()


# ---------------------------------------------------------------------------
# Sharded classify / trim lattice kernels (maximal + layout device portion)
# ---------------------------------------------------------------------------


def _flat_mesh_spec(mesh: Mesh):
    """PartitionSpec flattening every mesh axis onto the leading dim."""
    return P(tuple(mesh.axis_names))


def _shard_overlap_tables(cols: dict, tw, n_dev: int):
    """Partition a batch of overlaps (+ flat trace-walk) into n_dev blocks.

    `cols` maps name -> int32 [n] per-overlap column.  Each shard gets
    `chunk` real/zero-padded overlap rows plus ONE sentinel row (index
    `chunk`) that absorbs flat-point padding, so every shard has identical
    static shapes: rows = chunk+1, points = pad_pts, pairs = pad_pts-chunk-1
    (each row contributes npairs+1 points).  Returns (tables, meta) where
    tables holds (n_dev, ...) arrays ready for device_put.
    """
    from hinge_tpu.ops import classify as CL

    n = len(next(iter(cols.values())))
    chunk = max(1, -(-n // n_dev))
    npairs = tw.npairs
    total_pairs_at = np.append(tw.pair_off, tw.pair_off[-1] + npairs[-1]) if n else np.zeros(1, np.int64)

    # per-shard real counts and point totals
    n_real = np.array([max(0, min(n - r * chunk, chunk)) for r in range(n_dev)])
    pts_real = np.zeros(n_dev, dtype=np.int64)
    for r in range(n_dev):
        r0, r1 = r * chunk, r * chunk + n_real[r]
        if n_real[r]:
            pts_real[r] = int(npairs[r0:r1].sum()) + n_real[r]
    # zero-filled rows contribute 1 point each; +1 so sentinel has >=1 point
    pad_pts = int((pts_real + (chunk - n_real)).max()) + 1
    pad_pairs = pad_pts - (chunk + 1)

    names = list(cols)
    out = {k: np.zeros((n_dev, chunk + 1), dtype=np.int32) for k in names}
    np_l = np.zeros((n_dev, chunk + 1), dtype=np.int32)
    po_l = np.zeros((n_dev, chunk + 1), dtype=np.int64)
    cum_l = np.zeros((n_dev, max(pad_pairs, 1)), dtype=np.int32)
    seg_l = np.zeros((n_dev, pad_pts), dtype=np.int32)
    k_l = np.zeros((n_dev, pad_pts), dtype=np.int32)

    for r in range(n_dev):
        r0 = r * chunk
        m = n_real[r]
        if m:
            for k in names:
                out[k][r, :m] = cols[k][r0 : r0 + m]
            np_l[r, :m] = npairs[r0 : r0 + m]
            gp0 = tw.pair_off[r0]
            gp1 = total_pairs_at[r0 + m]
            po_l[r, :m] = tw.pair_off[r0 : r0 + m] - gp0
            cum_l[r, : gp1 - gp0] = tw.cum[gp0:gp1]
            real_pairs = int(gp1 - gp0)
        else:
            real_pairs = 0
        # sentinel row absorbs remaining points
        sent_pts = pad_pts - (int(np_l[r, :chunk].sum()) + chunk)
        np_l[r, chunk] = sent_pts - 1
        po_l[r, chunk] = real_pairs
        seg_id, k_local, _ = CL.make_point_index(np_l[r])
        seg_l[r] = seg_id
        k_l[r] = k_local

    tables = dict(out)
    tables.update(npairs=np_l, pair_off=po_l, cum=cum_l, seg_id=seg_l, k_local=k_l)
    return tables, dict(n=n, chunk=chunk, n_dev=n_dev)


@functools.lru_cache(maxsize=8)
def _classify_step(mesh: Mesh, tspace: int, aln_threshold: int, theta: int, theta2: int):
    from hinge_tpu.ops import classify as CL

    spec = _flat_mesh_spec(mesh)

    def step(a_s, a_e, b_s, b_e, rc, ears, eare, ebrs, ebre,
             npairs, pair_off, cum, seg_id, k_local):
        (a_s, a_e, b_s, b_e, rc, ears, eare, ebrs, ebre, npairs, cum,
         seg_id, k_local) = (
            x.reshape(-1) for x in (
                a_s, a_e, b_s, b_e, rc, ears, eare, ebrs, ebre, npairs, cum,
                seg_id, k_local)
        )
        pair_off = pair_off.reshape(-1)
        eams, eame, ebms, ebme, act = CL.trim_overlaps(
            a_s, a_e, b_s, b_e, rc, ears, eare, ebrs, ebre,
            npairs, pair_off, cum, seg_id, k_local, tspace=tspace,
        )
        too_short = ((ebme - ebms) < aln_threshold) | ((eame - eams) < aln_threshold)
        active = act & ~too_short
        mtype = CL.add_types_asymmetric(
            eams, eame, ebms, ebme, ears, eare, ebrs, ebre, rc, theta, theta2
        )
        mtype = jnp.where(active, mtype, CL.NOT_ACTIVE).astype(jnp.int32)
        return (eams[None], eame[None], ebms[None], ebme[None],
                active[None], mtype[None])

    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(spec,) * 14,
        out_specs=(spec,) * 6,
        check_vma=False,
    )
    return jax.jit(fn)


def run_sharded_classify(
    a_start, a_end, b_start, b_end, rc,
    ears, eare, ebrs, ebre,
    tw,
    mesh: Mesh,
    *,
    tspace: int,
    aln_threshold: int,
    theta: int,
    theta2: int,
):
    """Sharded batched ProcessAlignment (trim_overlap + AddTypesAsymmetric +
    length filter, maximal.cpp:65-134) over the full device mesh.

    eff-mask values (`ears..ebre`) are per-overlap gathers done host-side.
    Returns numpy (eams, eame, ebms, ebme, active, mtype) in input order,
    bit-identical to the single-device kernels.
    """
    n_dev = int(np.prod(list(mesh.shape.values())))
    cols = dict(
        a_s=a_start, a_e=a_end, b_s=b_start, b_e=b_end, rc=rc,
        ears=ears, eare=eare, ebrs=ebrs, ebre=ebre,
    )
    tables, meta = _shard_overlap_tables(cols, tw, n_dev)
    step = _classify_step(mesh, tspace, aln_threshold, theta, theta2)
    sh = NamedSharding(mesh, _flat_mesh_spec(mesh))
    order = ("a_s", "a_e", "b_s", "b_e", "rc", "ears", "eare", "ebrs", "ebre",
             "npairs", "pair_off", "cum", "seg_id", "k_local")
    args = tuple(jax.device_put(tables[k], sh) for k in order)
    outs = step(*args)
    n, chunk = meta["n"], meta["chunk"]
    return tuple(
        np.asarray(o).reshape(n_dev, chunk + 1)[:, :chunk].reshape(-1)[:n]
        for o in outs
    )


@functools.lru_cache(maxsize=8)
def _matchpos_step(mesh: Mesh, tspace: int):
    from hinge_tpu.ops import classify as CL

    spec = _flat_mesh_spec(mesh)

    def step(ov_idx, pos_a, a_s, a_e, b_s, b_e, rc, npairs, pair_off, cum):
        (ov_idx, pos_a, a_s, a_e, b_s, b_e, rc, npairs, cum) = (
            x.reshape(-1)
            for x in (ov_idx, pos_a, a_s, a_e, b_s, b_e, rc, npairs, cum)
        )
        pair_off = pair_off.reshape(-1)
        res = CL.matching_position(
            ov_idx, pos_a, a_s, a_e, b_s, b_e, rc, npairs, pair_off, cum,
            tspace=tspace,
        )
        return res[None]

    fn = jax.shard_map(
        step, mesh=mesh, in_specs=(spec,) * 10, out_specs=spec, check_vma=False
    )
    return jax.jit(fn)


def run_sharded_matching_position(
    ov_idx, pos_a,
    a_start, a_end, b_start, b_end, rc,
    tw,
    mesh: Mesh,
    *,
    tspace: int,
):
    """Sharded batched GetMatchingPosition (LAInterface.cpp:4498-4546).

    Overlap tables shard by contiguous row ranges; each query is routed to
    the shard owning its overlap and its `ov_idx` remapped to a local index.
    Returns int32 results in the input query order, bit-identical to
    `ops.classify.matching_position`.
    """
    n_dev = int(np.prod(list(mesh.shape.values())))
    cols = dict(a_s=a_start, a_e=a_end, b_s=b_start, b_e=b_end, rc=rc)
    tables, meta = _shard_overlap_tables(cols, tw, n_dev)
    chunk = meta["chunk"]

    nq = len(ov_idx)
    owner = np.minimum(np.asarray(ov_idx, dtype=np.int64) // chunk, n_dev - 1)
    per = np.bincount(owner, minlength=n_dev)
    qpad = max(1, int(per.max()))
    q_idx = np.full((n_dev, qpad), chunk, dtype=np.int32)  # sentinel row
    q_pos = np.zeros((n_dev, qpad), dtype=np.int32)
    slot_src = np.zeros((n_dev, qpad), dtype=np.int64)
    fill = np.zeros(n_dev, dtype=np.int64)
    for qi in range(nq):
        r = owner[qi]
        s = fill[r]
        q_idx[r, s] = ov_idx[qi] - r * chunk
        q_pos[r, s] = pos_a[qi]
        slot_src[r, s] = qi
        fill[r] = s + 1

    step = _matchpos_step(mesh, tspace)
    sh = NamedSharding(mesh, _flat_mesh_spec(mesh))
    order = ("a_s", "a_e", "b_s", "b_e", "rc", "npairs", "pair_off", "cum")
    args = (jax.device_put(q_idx, sh), jax.device_put(q_pos, sh)) + tuple(
        jax.device_put(tables[k], sh) for k in order
    )
    res = np.asarray(step(*args))
    out = np.zeros(nq, dtype=np.int32)
    for r in range(n_dev):
        m = int(fill[r])
        out[slot_src[r, :m]] = res[r, :m]
    return out


def run_sharded_hinge_call(
    pos_a, grad, m0, m1, rid,
    ams, ame, lov, rov, valid,
    mesh: Mesh,
    *, theta: int, htl: int, hbl: int, hrut: int, hbpt: int,
):
    """Sharded hinge-calling (filter.cpp:838-1070): the (read, annotation)
    task rows shard over the flat mesh; the per-read padded pileup tables
    are replicated (every task reads only its own read's row, so there is
    no cross-shard term).  Bit-identical to ops.hinge_call._hinge_kernel."""
    from hinge_tpu.ops.hinge_call import _hinge_kernel

    spec = _flat_mesh_spec(mesh)
    n_dev = int(np.prod(list(mesh.shape.values())))
    T = len(pos_a)
    tpad = ((T + n_dev - 1) // n_dev) * n_dev
    chunk = tpad // n_dev

    def _pad2(x, fill=0):
        out = np.full(tpad, fill, np.asarray(x).dtype)
        out[:T] = x
        return out.reshape(n_dev, chunk)

    def step(pos_a, grad, m0, m1, rid, ams, ame, lov, rov, valid):
        b, s = _hinge_kernel(
            pos_a.reshape(-1), grad.reshape(-1), m0.reshape(-1),
            m1.reshape(-1), rid.reshape(-1),
            ams, ame, lov, rov, valid,
            theta=theta, htl=htl, hbl=hbl, hrut=hrut, hbpt=hbpt,
        )
        return b[None], s[None]

    fn = jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(spec,) * 5 + (P(),) * 5,
        out_specs=(spec, spec), check_vma=False,
    ))
    b, s = fn(
        _pad2(np.asarray(pos_a, np.int32)), _pad2(np.asarray(grad, np.int32)),
        _pad2(np.asarray(m0, np.int32)), _pad2(np.asarray(m1, np.int32)),
        _pad2(np.asarray(rid, np.int32)),
        jnp.asarray(ams), jnp.asarray(ame), jnp.asarray(lov),
        jnp.asarray(rov), jnp.asarray(valid),
    )
    return np.asarray(b).reshape(-1)[:T], np.asarray(s).reshape(-1)[:T]


def sharded_top_k_per_pair(ov, k: int, n_shards: int) -> np.ndarray:
    """Per-(A,B) top-k selection partitioned at A-read boundaries.

    Mirrors the reference's --mlas sharding (records sorted by a_id,
    processed part by part): shard boundaries snap to a_id changes so no
    read's pair groups split, making per-shard `top_k_per_pair` results
    concatenate into exactly the global emission order (a ascending, then
    per-a unordered_map order — both shard-local properties).
    """
    from hinge_tpu.ops.pairs import top_k_per_pair

    n = ov.n
    if n == 0 or n_shards <= 1:
        return top_k_per_pair(ov, k)
    cuts = [0]
    for s in range(1, n_shards):
        c = s * n // n_shards
        # snap forward to the next a_id boundary
        while c < n and c > 0 and ov.a_id[c] == ov.a_id[c - 1]:
            c += 1
        if c > cuts[-1]:
            cuts.append(c)
    cuts.append(n)
    parts = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        if hi <= lo:
            continue
        sub = ov.take(np.arange(lo, hi))
        parts.append(top_k_per_pair(sub, k) + lo)
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)


def run_sharded_wave_align(mesh: Mesh, qs, ts, band_tolerance: int = 150):
    """Draft-stage window aligner with the window batch sharded over the
    mesh — pure data parallelism on the batch axis of the DW_banded-exact
    device wave (ops/wavefront.py): the batch is padded to a multiple of
    the device count, q/t/m/n land with a NamedSharding over every mesh
    axis, and GSPMD partitions the forward wave + backtrack per device (no
    cross-window communication exists, so no collectives are inserted).
    Rows come back byte-identical to align_exact_batch_device.
    """
    import jax

    from hinge_tpu.ops import wavefront as W

    B = len(qs)
    if B == 0:
        return []
    n_dev = int(np.prod(list(mesh.shape.values())))
    pad = (-B) % n_dev
    qs_p = list(qs) + [np.zeros(0, np.uint8)] * pad
    ts_p = list(ts) + [np.zeros(0, np.uint8)] * pad
    m = np.array([len(q) for q in qs_p], np.int32)
    n = np.array([len(t) for t in ts_p], np.int32)
    Lmax = max(1, int(max(m.max(), n.max())))
    chunk = 16
    L = -(-(Lmax + chunk) // 128) * 128
    q = np.full((len(qs_p), L), W._PAD_Q, np.uint8)
    t = np.full((len(ts_p), L), W._PAD_T, np.uint8)
    for i in range(len(qs_p)):
        q[i, : m[i]] = qs_p[i]
        t[i, : n[i]] = ts_p[i]
    max_d = max(2, int(0.3 * int((m + n).max())))
    kb = band_tolerance + 2
    sh = NamedSharding(mesh, _flat_mesh_spec(mesh))
    qd = jax.device_put(q, sh)
    td = jax.device_put(t, sh)
    md = jax.device_put(m, sh)
    nd = jax.device_put(n, sh)
    Vh, minkh, maxkh, aligned, d_fin, k_fin, x_fin = W._wave_forward(
        qd, td, md, nd, jnp.int32(band_tolerance),
        max_d=max_d, kb=kb, chunk=chunk,
    )
    px, py = W._wave_backtrack(Vh, minkh, maxkh, aligned, d_fin, k_fin,
                               x_fin, max_d=max_d)
    px = np.asarray(px)
    py = np.asarray(py)
    aligned_h = np.asarray(aligned)
    npts = 2 * (np.asarray(d_fin) + 1)
    both_empty = (m == 0) & (n == 0)
    aligned_h = aligned_h | both_empty
    npts = np.where(both_empty, 0, npts)
    rows = W._emit_rows_batch(qs_p, ts_p, px, py, npts, aligned_h)
    return rows[:B]


def run_sharded_falcon_tally(mesh: Mesh, rows: np.ndarray, t_len: int):
    """The device-shardable half of the falcon consensus vote: per-column
    coverage tallies of one window's align-tag rows (falcon.c:346-352),
    rows sharded over the mesh, per-device one-hot count, table psum'd
    across devices.  The link DP that consumes the tallies is sequential
    per column (strict `>` tie-break over stream-ordered links,
    falcon.c:366-520) and stays host-side by design — this covers the
    O(rows) half that scales with pileup depth.
    """
    import jax

    n_dev = int(np.prod(list(mesh.shape.values())))
    d0 = rows[rows[:, 1] == 0, 0]
    d0 = d0[(d0 >= 0) & (d0 < t_len)].astype(np.int32)
    pad = (-len(d0)) % max(n_dev, 1)
    d0p = np.concatenate([d0, np.full(pad, -1, np.int32)])
    sh = NamedSharding(mesh, _flat_mesh_spec(mesh))
    spec = _flat_mesh_spec(mesh)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(spec,), out_specs=P(),
    )
    def tally(d0_local):
        cov = jnp.zeros(t_len, jnp.int32).at[d0_local].add(
            (d0_local >= 0).astype(jnp.int32), mode="drop")
        return jax.lax.psum(cov, tuple(mesh.axis_names))

    return np.asarray(tally(jax.device_put(d0p, sh))).astype(np.int64)
