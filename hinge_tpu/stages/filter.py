"""Stage 1 — reads filtering: chimera masking + hinge detection.

Reference: `src/filter/filter.cpp` (Reads_filter binary).  Produces, for
prefix X: X.mas X.cmas X.coverage.txt X.repeat.txt X.hinges.txt X.cov.flag
X.self.flag X.homologous.txt (empty) — byte-identical formats.

Device decomposition:
  * pileup coverage (both cutoffs), mask runs, QV mask, repeat-annotation
    thresholds: dense kernels over (read, bin) grids (hinge_tpu.ops.coverage),
    chunked over read ranges so memory stays bounded and shards map to the
    reference's --mlas A-id partitioning;
  * coverage estimation, annotation merging, and the hinge bridged/unbridged
    scan: small sequential host logic mirroring filter.cpp exactly
    (the scans have early-exit data dependence and touch only reads that
    carry repeat annotations).

Multi-part quirks preserved: MIN_COV is raised per part and carries over
(filter.cpp:677-678 runs inside the part loop); maskvec persists across
parts so later parts see earlier parts' masks and zeros for future reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import jax.numpy as jnp
import numpy as np

from hinge_tpu.config import Config
from hinge_tpu.data.overlaps import OverlapStore, ReadStore
from hinge_tpu.ops import coverage as C


@dataclasses.dataclass
class FilterResult:
    maskvec: np.ndarray  # int32 [n_reads, 2]
    cmask: np.ndarray  # int32 [n_reads, 2] (mask coords in bins)
    repeat_annotation: List[List[Tuple[int, int]]]
    hinges: Dict[int, List[Tuple[int, int]]]
    cov_flag: List[int]
    self_flag: List[int]
    min_cov_final: int
    cov_est: int
    coverages_txt: Optional[List[str]] = None
    # per-part SNAPSHOT lines for the stage files: the reference writes
    # X.mas/X.cmas inside each part's mask loop (filter.cpp:775-787),
    # X.repeat.txt only during part 1 (rep.close() at :1085 runs inside
    # the part loop, so later parts write to a closed stream), and
    # X.hinges.txt per part over [r_begin, r_end) — on multi-part input
    # the files carry boundary-read duplicates with the PART-TIME values,
    # not the final state
    mas_lines: Optional[List[str]] = None
    cmas_lines: Optional[List[str]] = None
    repeat_lines: Optional[List[str]] = None
    hinges_lines: Optional[List[str]] = None


def qv_masks_all(rs: ReadStore, tspace: int, threshold: int = 40) -> np.ndarray:
    """QV mask for every read (filter.cpp:343-369). Returns [n,2] int32."""
    n = rs.n_reads
    out = np.zeros((n, 2), dtype=np.int32)
    if not rs.has_qv():
        return out
    nseg = np.diff(rs.qv_off).astype(np.int64)
    max_seg = int(nseg.max()) if n else 0
    good = np.zeros((n, max_seg), dtype=bool)
    seg_id = np.repeat(np.arange(n), nseg)
    col = np.arange(int(nseg.sum())) - np.repeat(rs.qv_off[:-1], nseg)
    good[seg_id, col] = rs.qv_val < threshold
    # host path: the grid is reads x ~190 bools, too small to be worth a
    # device round trip (the equivalent device kernel C.qv_mask stays for
    # the mesh tests)
    ms, me = C.qv_mask_np(good, nseg.astype(np.int32), tspace=tspace)
    out[:, 0] = ms
    out[:, 1] = me
    return out


def _self_match_reads(ov: OverlapStore, rs: ReadStore) -> Set[int]:
    """Reads with heavy self-alignment (filter.cpp:537-561)."""
    sel = ov.a_id == ov.b_id
    if not sel.any():
        return set()
    ids = ov.a_id[sel]
    span = (ov.a_end[sel] - ov.a_start[sel]) + (ov.b_end[sel] - ov.b_start[sel])
    tot = np.zeros(rs.n_reads, dtype=np.int64)
    np.add.at(tot, ids, span)
    covs = tot / np.maximum(rs.length, 1)
    return set(np.nonzero((covs > 4.5) & (rs.length > 10000))[0].tolist())


#: reads per device block — bounds the coverage grid to
#: CHUNK_READS x nb x 4B (~25MB at nb=750); larger read sets stream through
#: fixed-shape kernel invocations (one compile per nb).
CHUNK_READS = 8192


class _ResidentProfiles:
    """Per-chunk coverage grids held ON DEVICE between the profile, mask,
    and annotation phases — each grid is downloaded at most once and never
    re-uploaded, keeping host<->device transfer volume and the number of
    dispatch/sync points to a minimum."""

    def __init__(self, chunks):
        # chunks: list of (base, hi, cov_dev, cov_cut_dev, ne_dev, ne_cut_dev)
        self.chunks = chunks
        self._cov_np = None
        self._cov_cut_np = None

    def masks(self, min_cov, n_chunk, reso):
        """coverage_mask over the resident cut grids (filter.cpp:696-755)."""
        ms = np.zeros(n_chunk, np.int32)
        me = np.zeros(n_chunk, np.int32)
        msc = np.zeros(n_chunk, np.int32)
        mec = np.zeros(n_chunk, np.int32)
        for base, hi, _, cov_cut_dev, _, ne_cut_dev in self.chunks:
            r = C.coverage_mask(
                jnp.maximum(cov_cut_dev - jnp.int32(min_cov), 0),
                ne_cut_dev, reso=reso)
            span = hi - base
            ms[base:hi] = np.asarray(r[0])[:span]
            me[base:hi] = np.asarray(r[1])[:span]
            msc[base:hi] = np.asarray(r[2])[:span]
            mec[base:hi] = np.asarray(r[3])[:span]
        return ms, me, msc, mec

    def annotation(self, m0, m1, min_cov, n_chunk, nb, f, reso):
        """repeat_annotation_mask over the resident base grids."""
        ann = np.zeros((n_chunk, nb - 1), np.int8)
        for base, hi, cov_dev, _, ne_dev, _ in self.chunks:
            span = hi - base
            m0p = np.zeros(CHUNK_READS, np.int32)
            m1p = np.zeros(CHUNK_READS, np.int32)
            m0p[:span] = m0[base:hi]
            m1p[:span] = m1[base:hi]
            ann[base:hi] = np.asarray(
                C.repeat_annotation_mask(
                    cov_dev, ne_dev, jnp.asarray(m0p), jnp.asarray(m1p),
                    jnp.int32(min_cov), reso=reso,
                    coverage_fraction=f.coverage_frac_repeat_annotation,
                    min_thresh=f.min_repeat_annotation_threshold,
                    max_thresh=f.max_repeat_annotation_threshold,
                    no_hinge_region=f.no_hinge_region,
                )
            )[:span]
        return ann

    def cov_np(self, n_chunk, nb):
        """The base coverage grid, downloaded once (coverage.txt lines,
        hinge gating, coverage estimation)."""
        if self._cov_np is None:
            out = np.zeros((n_chunk, nb), np.int32)
            for base, hi, cov_dev, _, _, _ in self.chunks:
                out[base:hi] = np.asarray(cov_dev)[: hi - base]
            self._cov_np = out
        return self._cov_np

    def cov_cut_np(self, n_chunk, nb):
        """The cutoff grid, downloaded once (telomere flag sums only)."""
        if self._cov_cut_np is None:
            out = np.zeros((n_chunk, nb), np.int32)
            for base, hi, _, cov_cut_dev, _, _ in self.chunks:
                out[base:hi] = np.asarray(cov_cut_dev)[: hi - base]
            self._cov_cut_np = out
        return self._cov_cut_np


def _device_profiles(ov, sel, r_begin, n_chunk, nb, reso, cut_off):
    """Coverage grids for a contiguous read range, chunked over reads so
    device memory stays bounded.  Returns (profiles, ne, ne_cut) where
    `profiles` keeps the grids device-resident (_ResidentProfiles).

    HINGE_SHARDED=1 routes the scatter/cumsum chain over the device mesh
    (psum/pmax collectives) — bit-identical outputs, so the stage files
    byte-match the single-device run (tests/test_sharded_stage_parity.py)."""
    a_rel_all = (ov.a_id[sel] - r_begin).astype(np.int32)
    a_s_all = ov.a_start[sel].astype(np.int32)
    a_e_all = ov.a_end[sel].astype(np.int32)

    from hinge_tpu.parallel.sharding import run_sharded_profiles, stage_mesh

    mesh = stage_mesh()
    if mesh is not None:
        cov, cov_cut, ne, ne_cut = run_sharded_profiles(
            a_rel_all, a_s_all, a_e_all, n_chunk, mesh,
            nb=nb, reso=reso, cut_off=cut_off)
        chunks = []
        for base in range(0, n_chunk, CHUNK_READS):
            hi = min(base + CHUNK_READS, n_chunk)
            cpad = np.zeros((CHUNK_READS, nb), np.int32)
            cpad[: hi - base] = cov[base:hi]
            ccpad = np.zeros((CHUNK_READS, nb), np.int32)
            ccpad[: hi - base] = cov_cut[base:hi]
            npad = np.zeros(CHUNK_READS, np.int32)
            npad[: hi - base] = ne[base:hi]
            ncpad = np.zeros(CHUNK_READS, np.int32)
            ncpad[: hi - base] = ne_cut[base:hi]
            chunks.append((base, hi, jnp.asarray(cpad), jnp.asarray(ccpad),
                           jnp.asarray(npad), jnp.asarray(ncpad)))
        prof = _ResidentProfiles(chunks)
        prof._cov_np = cov
        prof._cov_cut_np = cov_cut
        return prof, ne, ne_cut

    ne = np.zeros(n_chunk, dtype=np.int32)
    ne_cut = np.zeros(n_chunk, dtype=np.int32)
    chunks = []
    # rows are sorted by a_id: binary-search the chunk boundaries
    for base in range(0, n_chunk, CHUNK_READS):
        hi = min(base + CHUNK_READS, n_chunk)
        lo_row = np.searchsorted(a_rel_all, base, side="left")
        hi_row = np.searchsorted(a_rel_all, hi, side="left")
        a_rel = jnp.asarray(a_rel_all[lo_row:hi_row] - base)
        a_s = jnp.asarray(a_s_all[lo_row:hi_row])
        a_e = jnp.asarray(a_e_all[lo_row:hi_row])
        span = hi - base
        cov_dev = C.profile_coverage(a_rel, a_s, a_e, jnp.int32(0),
                                     n_reads=CHUNK_READS, nb=nb, reso=reso)
        cov_cut_dev = C.profile_coverage(a_rel, a_s, a_e, jnp.int32(cut_off),
                                         n_reads=CHUNK_READS, nb=nb, reso=reso)
        me, ms, cnt = C.pileup_stats(a_rel, a_s, a_e, n_reads=CHUNK_READS, nb=1, reso=reso)
        ne_dev = C.n_entries_from_max_event(me, cnt, reso)
        # clipped profile: start+cutoff events can exceed every end-cutoff
        ne_cut_dev = C.n_entries_from_max_event(
            jnp.maximum(me - cut_off, ms + cut_off), cnt, reso)
        ne[base:hi] = np.asarray(ne_dev)[:span]
        ne_cut[base:hi] = np.asarray(ne_cut_dev)[:span]
        chunks.append((base, hi, cov_dev, cov_cut_dev, ne_dev, ne_cut_dev))
    return _ResidentProfiles(chunks), ne, ne_cut


def run_filter(
    rs: ReadStore,
    parts: Sequence[OverlapStore],
    cfg: Config,
    out_prefix: Optional[str] = None,
    reads_to_keep: Optional[Set[int]] = None,
    has_qv: Optional[bool] = None,
    collect_coverage_txt: bool = False,
) -> FilterResult:
    f = cfg.filter
    reso = f.reso
    n_read = rs.n_reads
    if has_qv is None:
        has_qv = rs.has_qv()
    use_qv_mask = f.use_qv and has_qv
    use_coverage_mask = f.coverage
    # filter.cpp:406 reads the SINGULAR "del_telomere" key (hinging/clip use
    # the plural) — the yeast demo ini sets only the singular
    delete_telomere = cfg.layout.del_telomere

    tspace = parts[0].tspace if parts else 100
    QV_mask = qv_masks_all(rs, tspace, f.qv_threshold) if has_qv else np.zeros((n_read, 2), np.int32)

    maskvec = np.zeros((n_read, 2), dtype=np.int32)
    cmask = np.zeros((n_read, 2), dtype=np.int32)
    repeat_annotation: List[List[Tuple[int, int]]] = [[] for _ in range(n_read)]
    hinges: Dict[int, List[Tuple[int, int]]] = {}
    cov_flag: List[int] = []
    self_flag: List[int] = []
    coverage_lines: List[str] = [] if collect_coverage_txt or out_prefix else None

    MIN_COV = f.min_cov
    cov_est = 0
    mas_lines: List[str] = []
    cmas_lines: List[str] = []
    repeat_lines: List[str] = []
    hinges_lines: List[str] = []
    part_idx = -1

    # neighbor expansion for restrictreads (filter.cpp:680-694): all B
    # partners of the initially selected reads
    if reads_to_keep:
        reads_to_keep = set(reads_to_keep)
        initial = set(reads_to_keep)
        for part in parts:
            m = np.isin(part.a_id, list(initial))
            reads_to_keep |= set(part.b_id[m].tolist())

    maxlen = int(rs.length.max()) if n_read else 0
    nb = maxlen // reso + 3

    for part in parts:
        if part.n == 0:
            continue
        part_idx += 1
        r_begin = int(part.a_id[0])
        r_end = int(part.a_id[-1])
        n_chunk = r_end - r_begin + 1

        self_reads = _self_match_reads(part, rs)
        nonself = part.a_id != part.b_id  # self matches excluded from pileups

        prof, ne, ne_cut = _device_profiles(
            part, nonself, r_begin, n_chunk, nb, reso, f.cut_off
        )
        cov = prof.cov_np(n_chunk, nb)  # one download; grids stay resident

        # ---- coverage estimate (filter.cpp:633-673) ----
        lens = rs.length[r_begin : r_end + 1]
        rowsum = cov.sum(axis=1, dtype=np.int64)
        eligible = lens >= 5000
        read_cov = rowsum[eligible]
        read_slot = ne[eligible]
        mean_read_cov = read_cov // np.maximum(1, read_slot)
        total_cov = int(read_cov.sum())
        num_slot = int(read_slot.sum())
        if len(mean_read_cov) == 0:
            raise ValueError("no reads >= 5000bp for coverage estimation")
        median_id = len(mean_read_cov) // 2
        if median_id > 0:
            cov_est = int(np.partition(mean_read_cov, median_id)[median_id])
        else:
            cov_est = int(mean_read_cov[0])
        if f.est_cov != 0:
            cov_est = f.est_cov
        if MIN_COV < cov_est // 3:
            MIN_COV = cov_est // 3

        # ---- masks (filter.cpp:696-789) over the RESIDENT cut grids ----
        ms, me_, msc, mec = prof.masks(MIN_COV, n_chunk, reso)

        # telomere flags need start/end coverage of the max run (only this
        # path reads the cutoff grid host-side; downloaded lazily, once)
        if delete_telomere:
            reduced = np.maximum(
                prof.cov_cut_np(n_chunk, nb) - MIN_COV, 0).astype(np.int32)
            for ri in range(n_chunk):
                i = r_begin + ri
                a, b = int(msc[ri]), int(mec[ri])
                span = b - a + 1
                vals = reduced[ri]
                if span > 20:
                    sc = int(vals[a : a + 10].sum() + 10 * MIN_COV) // 10
                    ec = int(vals[b - 9 : b + 1].sum() + 10 * MIN_COV) // 10
                else:
                    limit = (b - a) // 2
                    if limit == 0:
                        sc = ec = 0
                    else:
                        sc = int(vals[a : a + limit].sum() + limit * MIN_COV) // limit
                        ec = int(vals[b - limit + 1 : b + 1].sum() + limit * MIN_COV) // limit
                if sc >= 10 * ec or ec >= 10 * sc:
                    cov_flag.append(i)
                if i in self_reads:
                    self_flag.append(i)

        for ri in range(n_chunk):
            i = r_begin + ri
            maxstart, maxend = int(ms[ri]), int(me_[ri])
            if reads_to_keep and i not in reads_to_keep:
                maxend = maxstart
                QV_mask[i, 1] = QV_mask[i, 0]
            cmask[i] = (msc[ri], mec[ri])
            if use_qv_mask and use_coverage_mask:
                maskvec[i] = (
                    max(maxstart, QV_mask[i, 0]),
                    min(maxend, QV_mask[i, 1]),
                )
            elif use_coverage_mask:
                maskvec[i] = (maxstart, maxend)
            else:
                maskvec[i] = (QV_mask[i, 0], QV_mask[i, 1])

        # ---- repeat annotation (filter.cpp:796-829), resident grids ----
        ann_grid = prof.annotation(
            maskvec[r_begin : r_end + 1, 0], maskvec[r_begin : r_end + 1, 1],
            MIN_COV, n_chunk, nb, f, reso)
        for ri in range(n_chunk):
            i = r_begin + ri
            nz = np.nonzero(ann_grid[ri])[0]
            anno = [(int(j) * reso, int(ann_grid[ri, j])) for j in nz]
            repeat_annotation[i] = _merge_annotations(anno, f.repeat_annotation_gap_threshold)

        # ---- hinge calling (filter.cpp:838-1070, device kernel) ----
        _call_hinges_device(
            part, nonself, rs, maskvec, cov, ne, r_begin, r_end,
            repeat_annotation, hinges, f, reso,
        )

        # ---- per-part stage-file snapshots (see FilterResult fields) ----
        for i in range(r_begin, r_end + 1):
            cmas_lines.append(f"{i} {cmask[i, 0]} {cmask[i, 1]}")
            mas_lines.append(f"{i} {maskvec[i, 0]} {maskvec[i, 1]}")
        if part_idx == 0:
            for i in range(r_begin, r_end + 1):
                body = "".join(f"{p} {t} " for p, t in repeat_annotation[i])
                repeat_lines.append(f"{i} {body}")
        # reference quirk: the hinges loop is `i < r_end` (skips the last)
        for i in range(r_begin, r_end):
            body = "".join(f"{p} {t} " for p, t in hinges.get(i, []))
            hinges_lines.append(f"{i} {body}")

        # ---- coverage.txt lines (filter.cpp:599-602) ----
        if coverage_lines is not None:
            native = _native_coverage_lines(cov, ne, reso, r_begin)
            if native is not None:
                coverage_lines.extend(native)
            else:
                for ri in range(n_chunk):
                    i = r_begin + ri
                    vals = cov[ri, : ne[ri]]
                    body = "".join(f"{j*reso},{int(v)} " for j, v in enumerate(vals))
                    coverage_lines.append(f"read {i} {body}")

    res = FilterResult(
        maskvec=maskvec,
        cmask=cmask,
        repeat_annotation=repeat_annotation,
        hinges=hinges,
        cov_flag=cov_flag,
        self_flag=self_flag,
        mas_lines=mas_lines,
        cmas_lines=cmas_lines,
        repeat_lines=repeat_lines,
        hinges_lines=hinges_lines,
        min_cov_final=MIN_COV,
        cov_est=cov_est,
        coverages_txt=coverage_lines,
    )
    if out_prefix is not None:
        write_filter_outputs(res, out_prefix, n_read, delete_telomere, parts)
    return res


def _native_coverage_lines(cov, ne, reso, r_begin):
    """coverage.txt body via native/sweeps.cpp::format_coverage_lines (the
    Python f-string pass was ~2s of the stage at 4.6Mb); returns a list of
    lines (sans trailing newline, matching the Python builder) or None."""
    import ctypes

    from hinge_tpu.native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "format_coverage_lines"):
        return None
    lib.format_coverage_lines.restype = ctypes.c_int64
    c = np.ascontiguousarray(cov, np.int32)
    n = np.ascontiguousarray(ne, np.int32)
    cap = int(c.shape[0]) * 32 + int(np.minimum(n, c.shape[1]).sum()) * 20
    buf = ctypes.create_string_buffer(cap)
    w = lib.format_coverage_lines(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(c.shape[0]), ctypes.c_int64(c.shape[1]),
        ctypes.c_int32(reso), ctypes.c_int64(r_begin),
        buf, ctypes.c_int64(cap),
    )
    if w < 0:
        return None
    return buf.raw[:w].decode().split("\n")[:-1]


def _merge_annotations(anno: List[Tuple[int, int]], gap: int) -> List[Tuple[int, int]]:
    """filter.cpp:817-829: in-place merge of nearby same-sign annotations."""
    a = list(anno)
    i = 0
    while i < len(a):
        if i + 1 < len(a):
            if a[i][1] == 1 and a[i + 1][1] == 1 and a[i + 1][0] - a[i][0] < gap:
                del a[i + 1]
            elif a[i][1] == -1 and a[i + 1][1] == -1 and a[i + 1][0] - a[i][0] < gap:
                del a[i]
            else:
                i += 1
        else:
            i += 1
    return a


def _call_hinges_device(
    part, nonself, rs, maskvec, cov, ne, r_begin, r_end,
    repeat_annotation, hinges, f, reso,
):
    """filter.cpp:838-1070 on device: per-read gating stays host-side (it
    reads ragged coverage vectors); support counting and the bridged scans
    run as ONE jitted [tasks, pileup] kernel (ops/hinge_call.py), which the
    host oracle `_call_hinges` pins in tests/test_filter_ops.py."""
    from hinge_tpu.ops.hinge_call import call_hinges_device

    sel_idx = np.nonzero(nonself)[0]
    a_ids = part.a_id[sel_idx]
    order = np.argsort(a_ids, kind="stable")
    sel_idx = sel_idx[order]
    a_ids = a_ids[order]
    bounds = np.searchsorted(a_ids, np.arange(r_begin, r_end + 2))
    NHR = f.no_hinge_region

    tasks: list = []
    t_pos: list = []
    t_grad: list = []
    t_m0: list = []
    t_m1: list = []
    read_rows: dict = {}
    for i in range(r_begin, r_end + 1):
        hinges[i] = []
        anns = repeat_annotation[i]
        # average coverage near mask ends (filter.cpp:842-865)
        m0, m1 = int(maskvec[i, 0]), int(maskvec[i, 1])
        nloc = int(ne[i - r_begin])
        pos = np.arange(nloc) * reso
        vals = cov[i - r_begin, :nloc]
        s_sel = (pos >= m0) & (pos <= m0 + NHR)
        e_sel = (pos >= m1 - NHR) & (pos <= m1)
        n_s, n_e = int(s_sel.sum()), int(e_sel.sum())
        if n_s > 0 and n_e > 0:
            avg_s = float(vals[s_sel].sum()) / n_s
            avg_e = float(vals[e_sel].sum()) / n_e
            if abs(avg_e - avg_s) < 10:
                continue
        # (num==0 -> NaN in C, comparison false -> proceed)
        if not anns:
            continue
        if i not in read_rows:
            lo, hi = bounds[i - r_begin], bounds[i - r_begin + 1]
            rows = sel_idx[lo:hi]
            # reference pileup order: std::sort(compare_overlap) over the
            # las-order rows — descending summed match length with the
            # introsort tie arrangement (ops.hinge_call.introsort_perm)
            from hinge_tpu.ops.hinge_call import introsort_perm

            mlen = ((part.a_end[rows] - part.a_start[rows])
                    + (part.b_end[rows] - part.b_start[rows]))
            rows = rows[introsort_perm(mlen, descending=True)]
            b_ids = part.b_id[rows]
            rcs = part.rc[rows]
            bms = part.b_start[rows]
            bme = part.b_end[rows]
            bm0 = maskvec[b_ids, 0]
            bm1 = maskvec[b_ids, 1]
            right_ovh = np.where(rcs == 0, np.maximum(bm1 - bme, 0),
                                 np.maximum(bms - bm0, 0))
            left_ovh = np.where(rcs == 0, np.maximum(bms - bm0, 0),
                                np.maximum(bm1 - bme, 0))
            read_rows[i] = (
                part.a_start[rows].astype(np.int32),
                part.a_end[rows].astype(np.int32),
                left_ovh.astype(np.int32),
                right_ovh.astype(np.int32),
            )
        for ai, (pos_a, grad) in enumerate(anns):
            tasks.append((i, ai))
            t_pos.append(pos_a)
            t_grad.append(grad)
            t_m0.append(m0)
            t_m1.append(m1)

    if not tasks:
        return
    bridged, support = call_hinges_device(
        tasks, np.asarray(t_pos, np.int32), np.asarray(t_grad, np.int32),
        np.asarray(t_m0, np.int32), np.asarray(t_m1, np.int32), read_rows,
        theta=f.theta, htl=f.hinge_tolerance_length, hbl=f.hinge_bin,
        hrut=f.hinge_unbridged, hbpt=f.hinge_min_pileup,
    )
    HMS = f.hinge_min_support
    for t, (i, ai) in enumerate(tasks):
        if int(support[t]) < HMS:
            continue
        if (not bool(bridged[t])) and int(support[t]) > HMS:
            pos_a, grad = repeat_annotation[i][ai]
            hinges[i].append((pos_a, grad))


def _call_hinges(
    part, nonself, rs, maskvec, cov, ne, r_begin, r_end,
    repeat_annotation, hinges, f, reso,
):
    """filter.cpp:838-1070 — support counting + bridged/unbridged decision.

    Pileup iteration order is compare_overlap (descending summed match
    length); the reference's std::sort is unstable on ties, we pin
    stable-descending for determinism.
    """
    # build per-read row slices of the non-self pileup (las order)
    sel_idx = np.nonzero(nonself)[0]
    a_ids = part.a_id[sel_idx]
    order = np.argsort(a_ids, kind="stable")
    sel_idx = sel_idx[order]
    a_ids = a_ids[order]
    bounds = np.searchsorted(a_ids, np.arange(r_begin, r_end + 2))

    THETA = f.theta
    HTL = f.hinge_tolerance_length
    HBL = f.hinge_bin  # = 2*HTL
    HMS = f.hinge_min_support
    HRUT = f.hinge_unbridged
    HBPT = f.hinge_min_pileup
    NHR = f.no_hinge_region

    for i in range(r_begin, r_end + 1):
        hinges[i] = []
        anns = repeat_annotation[i]
        lo, hi = bounds[i - r_begin], bounds[i - r_begin + 1]
        rows = sel_idx[lo:hi]
        # std::sort(compare_overlap): descending summed match length with
        # the reference's introsort tie arrangement
        from hinge_tpu.ops.hinge_call import introsort_perm

        mlen = (part.a_end[rows] - part.a_start[rows]) + (part.b_end[rows] - part.b_start[rows])
        rows = rows[introsort_perm(mlen, descending=True)]

        # average coverage near mask ends (filter.cpp:842-865)
        m0, m1 = int(maskvec[i, 0]), int(maskvec[i, 1])
        nloc = int(ne[i - r_begin])
        pos = np.arange(nloc) * reso
        vals = cov[i - r_begin, :nloc]
        s_sel = (pos >= m0) & (pos <= m0 + NHR)
        e_sel = (pos >= m1 - NHR) & (pos <= m1)
        n_s, n_e = int(s_sel.sum()), int(e_sel.sum())
        if n_s > 0 and n_e > 0:
            avg_s = float(vals[s_sel].sum()) / n_s
            avg_e = float(vals[e_sel].sum()) / n_e
            if abs(avg_e - avg_s) < 10:
                continue
        # (num==0 -> NaN in C, comparison false -> proceed)

        if not anns:
            continue

        b_ids = part.b_id[rows]
        rcs = part.rc[rows]
        ams = part.a_start[rows]
        ame = part.a_end[rows]
        bms = part.b_start[rows]
        bme = part.b_end[rows]
        bm0 = maskvec[b_ids, 0]
        bm1 = maskvec[b_ids, 1]
        right_ovh = np.where(rcs == 0, np.maximum(bm1 - bme, 0), np.maximum(bms - bm0, 0))
        left_ovh = np.where(rcs == 0, np.maximum(bms - bm0, 0), np.maximum(bm1 - bme, 0))

        for pos_a, grad in anns:
            if grad == -1:
                near = (ame > pos_a - HTL) & (ame < pos_a + HTL) & (right_ovh > THETA)
                support = int(near.sum())
                if support < HMS:
                    continue
                # std::sort(pairAscend): .first ONLY — introsort tie order
                other = np.stack([ams[near], left_ovh[near]], axis=1)
                other = other[introsort_perm(other[:, 0], descending=False)]
                bridged = _bridged_scan_out(other, m0, HBL, THETA, HRUT, HBPT)
                if (not bridged) and support > HMS:
                    hinges[i].append((pos_a, -1))
            else:
                near = (ams > pos_a - HTL) & (ams < pos_a + HTL) & (left_ovh > THETA)
                support = int(near.sum())
                if support < HMS:
                    continue
                # std::sort(pairDescend): .first ONLY — introsort tie order
                other = np.stack([ame[near], right_ovh[near]], axis=1)
                other = other[introsort_perm(other[:, 0], descending=True)]
                bridged = _bridged_scan_in(other, m1, HBL, THETA, HRUT, HBPT)
                if (not bridged) and support > HMS:
                    hinges[i].append((pos_a, 1))


def _bridged_scan_out(other, mask_start, HBL, THETA, HRUT, HBPT):
    """filter.cpp:916-963 (out-hinge branch)."""
    bridged = True
    considered = 0
    extending = 0
    n = len(other)
    for idx in range(n):
        first, second = int(other[idx, 0]), int(other[idx, 1])
        if first - mask_start < HBL:
            considered += 1
            extending += 1
            if extending > HRUT or (
                considered > HRUT and first - int(other[0, 0]) > HBL
            ):
                bridged = False
                break
        elif second < THETA:
            considered += 1
            if extending > HRUT or (
                considered > HRUT and first - int(other[0, 0]) > HBL
            ):
                bridged = False
                break
        elif second > THETA:
            considered += 1
            pileup_len = 1
            id1 = idx + 1
            while id1 < n and int(other[id1, 0]) - first < HBL:
                pileup_len += 1
                id1 += 1
            if pileup_len > HBPT:
                bridged = True
                break
    return bridged


def _bridged_scan_in(other, mask_end, HBL, THETA, HRUT, HBPT):
    """filter.cpp:1019-1062 (in-hinge branch; descending order)."""
    bridged = True
    considered = 0
    extending = 0
    n = len(other)
    for idx in range(n):
        first, second = int(other[idx, 0]), int(other[idx, 1])
        if mask_end - first < HBL:
            considered += 1
            extending += 1
            if extending > HRUT or (
                considered > HRUT and int(other[0, 0]) - first > HBL
            ):
                bridged = False
                break
        elif second < THETA:
            considered += 1
            if extending > HRUT or (
                considered > HRUT and int(other[0, 0]) - first > HBL
            ):
                bridged = False
                break
        elif second > THETA:
            considered += 1
            pileup_len = 1
            id1 = idx + 1
            while id1 < n and first - int(other[id1, 0]) < HBL:
                pileup_len += 1
                id1 += 1
            if pileup_len > HBPT:
                bridged = True
                break
    return bridged


def write_filter_outputs(res: FilterResult, prefix: str, n_read: int, delete_telomere: bool, parts):
    """Write the reference's nine output files with identical formats."""
    ranges = []
    for part in parts:
        if part.n:
            ranges.append((int(part.a_id[0]), int(part.a_id[-1])))

    # per-part snapshot lines (the reference writes these files inside the
    # part loop; see the FilterResult field comments) with a final-state
    # fallback for callers that built a FilterResult by hand
    if res.mas_lines is not None:
        with open(prefix + ".mas", "w") as mas:
            mas.write("".join(line + "\n" for line in res.mas_lines))
        with open(prefix + ".cmas", "w") as cmas:
            cmas.write("".join(line + "\n" for line in res.cmas_lines))
        with open(prefix + ".repeat.txt", "w") as rep:
            rep.write("".join(line + "\n" for line in res.repeat_lines))
        with open(prefix + ".hinges.txt", "w") as hg:
            hg.write("".join(line + "\n" for line in res.hinges_lines))
    else:
        with open(prefix + ".mas", "w") as mas, \
                open(prefix + ".cmas", "w") as cmas:
            for r_begin, r_end in ranges:
                for i in range(r_begin, r_end + 1):
                    cmas.write(f"{i} {res.cmask[i,0]} {res.cmask[i,1]}\n")
                    mas.write(f"{i} {res.maskvec[i,0]} {res.maskvec[i,1]}\n")
        with open(prefix + ".repeat.txt", "w") as rep:
            for r_begin, r_end in ranges:
                for i in range(r_begin, r_end + 1):
                    body = "".join(
                        f"{p} {t} " for p, t in res.repeat_annotation[i])
                    rep.write(f"{i} {body}\n")
        with open(prefix + ".hinges.txt", "w") as hg:
            for r_begin, r_end in ranges:
                # reference quirk: `i < r_end`, the last read is skipped
                for i in range(r_begin, r_end):
                    body = "".join(
                        f"{p} {t} " for p, t in res.hinges.get(i, []))
                    hg.write(f"{i} {body}\n")

    with open(prefix + ".cov.flag", "w") as fcov:
        for i in res.cov_flag:
            fcov.write(f"{i}\n")
    with open(prefix + ".self.flag", "w") as fself:
        for i in res.self_flag:
            fself.write(f"{i}\n")
    open(prefix + ".homologous.txt", "w").close()
    open(prefix + ".filtered.fasta", "w").close()
    if res.coverages_txt is not None:
        with open(prefix + ".coverage.txt", "w") as f:
            for line in res.coverages_txt:
                f.write(line + "\n")
