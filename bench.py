"""Benchmark: overlap-pileup records/s on one GPU, plus one FASTA -> GFA run.

Primary metric — overlap-pileup records/s over the filter stage's device
scope (filter.cpp:585-1070): pileup coverage x2 + n_entries + masks +
repeat annotation + the hinge-calling kernel (ops/hinge_call.py).  The
trim/classify lattice is not in the chain: production runs it as the
native C trace walk (native/sweeps.cpp::trim_overlaps_batch).
vs_baseline compares against a vectorized-numpy implementation of the
coverage core, standing in for the reference's scalar C++ event loops.

Every device number comes from a child interpreter that runs on the GPU;
the parent never initializes a JAX backend, and the children run one after
another, so one process holds the card at a time.  Without a GPU the
benchmark prints nothing to stdout and exits 1.

Output: stdout carries only compact JSON lines.  The primary line is
printed first (flush=True) and again as the last line; the e2e breakdown
also goes to BENCH_DETAIL.json.  HINGE_BENCH_BUDGET caps the total seconds
(default 420).
"""

import json
import os
import sys
import time

import numpy as np

N_READS = 16_384
N_OV = 2_000_000
N_TASKS = 2_048       # (read, annotation) hinge-calling tasks
PILEUP_W = 128        # padded pileup width per hinge task
MAXLEN = 30_000
RESO = 40
CUT_OFF = 300
MIN_COV = 5

_HERE = os.path.dirname(os.path.abspath(__file__))


def synth(seed=0):
    rng = np.random.default_rng(seed)
    a_id = np.sort(rng.integers(0, N_READS, N_OV)).astype(np.int32)
    read_len = rng.integers(MAXLEN // 2, MAXLEN, N_READS).astype(np.int32)
    lo = rng.integers(0, MAXLEN // 2, N_OV)
    span = rng.integers(1000, MAXLEN // 2, N_OV)
    a_start = lo.astype(np.int32)
    a_end = np.minimum(lo + span, read_len[a_id]).astype(np.int32)
    return a_id, a_start, a_end, read_len


def synth_hinge(seed=2):
    """Padded (read, annotation) hinge-calling batch (filter.cpp:838-1070)."""
    rng = np.random.default_rng(seed)
    R = 512  # distinct reads carrying annotations
    ams = rng.integers(0, MAXLEN // 2, (R, PILEUP_W)).astype(np.int32)
    ame = (ams + rng.integers(500, MAXLEN // 2, (R, PILEUP_W))).astype(np.int32)
    lov = rng.integers(0, 4000, (R, PILEUP_W)).astype(np.int32)
    rov = rng.integers(0, 4000, (R, PILEUP_W)).astype(np.int32)
    valid = rng.random((R, PILEUP_W)) < 0.9
    rid = rng.integers(0, R, N_TASKS).astype(np.int32)
    pos_a = rng.integers(500, MAXLEN - 500, N_TASKS).astype(np.int32)
    grad = rng.choice(np.array([-1, 1], np.int32), N_TASKS)
    m0 = rng.integers(0, 500, N_TASKS).astype(np.int32)
    m1 = (pos_a + rng.integers(500, 5000, N_TASKS)).astype(np.int32)
    return dict(pos_a=pos_a, grad=grad, m0=m0, m1=m1, rid=rid,
                ams=ams, ame=ame, lov=lov, rov=rov, valid=valid)


def bench_device(a_id, a_start, a_end, read_len, iters=10):
    import jax
    import jax.numpy as jnp

    from hinge_tpu.ops import coverage as C
    from hinge_tpu.ops.hinge_call import _hinge_kernel

    nb = MAXLEN // RESO + 3

    # the chain runs as the stage runs it: each kernel is jitted at its def
    # site, and the small glue (n_entries, maximum, sums) dispatches eagerly
    @jax.jit
    def _finish(cov, ms, mev, ann, bridged, support):
        return (cov.sum(), ms, mev, ann.astype(jnp.int32).sum(),
                bridged.sum(), support.sum())

    hg = {k: jnp.asarray(v) for k, v in synth_hinge().items()}

    def step(a_id, a_start, a_end):
        cov = C.profile_coverage(
            a_id, a_start, a_end, jnp.int32(0), n_reads=N_READS, nb=nb, reso=RESO
        )
        cov_cut = C.profile_coverage(
            a_id, a_start, a_end, jnp.int32(CUT_OFF), n_reads=N_READS, nb=nb, reso=RESO
        )
        me, mst, cnt = C.pileup_stats(a_id, a_start, a_end, n_reads=N_READS, nb=1, reso=RESO)
        ne = C.n_entries_from_max_event(me, cnt, RESO)
        ne_cut = C.n_entries_from_max_event(
            jnp.maximum(me - CUT_OFF, mst + CUT_OFF), cnt, RESO)
        ms, mev, _, _ = C.coverage_mask(
            jnp.maximum(cov_cut - MIN_COV, 0), ne_cut, reso=RESO
        )
        ann = C.repeat_annotation_mask(
            cov, ne, ms, mev, jnp.int32(MIN_COV),
            reso=RESO, coverage_fraction=3, min_thresh=10, max_thresh=20,
            no_hinge_region=500,
        )
        # hinge calling (bridged/unbridged scan) per (read, annotation) task
        bridged, support = _hinge_kernel(
            hg["pos_a"], hg["grad"], hg["m0"], hg["m1"], hg["rid"],
            hg["ams"], hg["ame"], hg["lov"], hg["rov"], hg["valid"],
            theta=300, htl=300, hbl=200, hrut=6, hbpt=7,
        )
        return _finish(cov, ms, mev, ann, bridged, support)

    args = (jnp.asarray(a_id), jnp.asarray(a_start), jnp.asarray(a_end))
    out = step(*args)  # compile
    jax.block_until_ready(out)
    # warm-up and calibrate the iteration count for ~1s of device time
    t0 = time.perf_counter()
    jax.block_until_ready(step(*args))
    probe = time.perf_counter() - t0
    iters = max(3, int(1.0 / max(probe, 1e-4)))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return N_OV / dt, dt


def byte_account(n_ov=N_OV, n_reads=N_READS, nb=None, n_tasks=N_TASKS,
                 pileup_w=PILEUP_W):
    """Device-memory bytes the benchmark's chain must move per iteration
    (the byte model for a later roofline against the card's peak).

    Counts the bytes each kernel MUST move through device memory per benchmark
    iteration, assuming perfect fusion of elementwise work into its
    producing pass (credit the hardware with the best possible schedule —
    that is what makes the ceiling a ceiling):

      * profile_coverage x2: read the 3 record columns (12B/rec), scatter
        +1/-1 into the grid (2 read-modify-write int32 = 16B/rec), then
        one read+write cumsum pass over the (reads x nb) grid.
      * pileup_stats: record columns + 3 segment-reduce RMWs/record.
      * n_entries / masks / annotation: per-read vectors are negligible;
        the mask + annotation kernels each make one read pass over a
        grid (annotation reads both grids and writes an int8 mask).
      * hinge_call: n_tasks x pileup_w int32 columns, ~5 arrays.
      * final reductions: one read pass over the base grid.

    Returns the per-iteration and per-record byte counts and the
    component breakdown (so a reader can re-derive every term from the
    kernel shapes)."""
    if nb is None:
        nb = MAXLEN // RESO + 3
    grid = n_reads * nb * 4  # one (reads x nb) int32 grid pass, bytes
    comp = {
        "record_columns_reads": 3 * 4 * n_ov * 3,  # 2 profiles + stats
        "scatter_rmw": (2 * 8) * n_ov * 2,         # 2 events x RMW x 2 grids
        "stats_rmw": 3 * 8 * n_ov,                 # max/min/count segments
        "cumsum_grid_passes": 2 * 2 * grid,        # rw over both grids
        "mask_grid_read": grid,
        "annotation_grid_reads": 2 * grid + n_reads * (nb - 1),
        "hinge_call": 5 * 4 * n_tasks * pileup_w,
        "final_reductions": grid,
    }
    total = sum(comp.values())
    return {
        "bytes_per_iter": int(total),
        "bytes_per_record": round(total / n_ov, 1),
        "components_bytes": {k: int(v) for k, v in comp.items()},
    }


def bench_numpy_baseline(a_id, a_start, a_end, read_len, iters=1):
    """Same computation, vectorized numpy on host (reference-CPU stand-in)."""
    nb = MAXLEN // RESO + 3

    def step():
        cov = np.zeros((N_READS, nb + 1), dtype=np.int32)
        for cutoff, arr in ((0, None), (CUT_OFF, None)):
            grid = np.zeros((N_READS, nb + 1), dtype=np.int32)
            sb = np.clip((a_start + cutoff) // RESO + 1, 0, nb)
            eb = np.clip((a_end - cutoff) // RESO + 1, 0, nb)
            np.add.at(grid, (a_id, sb), 1)
            np.add.at(grid, (a_id, eb), -1)
            c = np.cumsum(grid[:, :nb], axis=1)
            if cutoff == 0:
                cov0 = c
            else:
                covc = c
        red = np.maximum(covc - MIN_COV, 0)
        pos = red > 0
        # longest-run scan (vectorized flush detection)
        prev = np.zeros_like(pos)
        prev[:, 1:] = pos[:, :-1]
        flush = (~pos) & prev
        return cov0.sum() + int(flush.sum())

    t0 = time.perf_counter()
    for _ in range(iters):
        s = step()
    dt = (time.perf_counter() - t0) / iters
    return N_OV / dt, dt


def _child(code, timeout_s, tag):
    """Run a bench snippet in a clean child interpreter; parse its tag line."""
    import subprocess

    try:
        r = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True, text=True, timeout=timeout_s, cwd=_HERE,
        )
        for line in r.stdout.splitlines():
            if line.startswith(tag + " "):
                return json.loads(line[len(tag) + 1 :])
    except subprocess.TimeoutExpired:
        pass
    return None


_CACHE_PRELUDE = (
    "import jax\n"
    "from hinge_tpu.utils.compile_cache import enable_compile_cache\n"
    "enable_compile_cache()\n"
)


def _device_bench(timeout_s):
    """Device microbench in a child process.  Returns the child's report:
    backend, device kind and count, and records/s when the backend is
    the GPU."""
    code = (
        _CACHE_PRELUDE
        + "import json\n"
        "from bench import synth, bench_device\n"
        "out = {'backend': jax.default_backend(),\n"
        "       'device_kind': jax.devices()[0].device_kind,\n"
        "       'device_count': len(jax.devices())}\n"
        "if out['backend'] == 'gpu':\n"
        "    out['rps'], _ = bench_device(*synth())\n"
        "print('BENCH_RESULT ' + json.dumps(out))\n"
    )
    return _child(code, timeout_s, "BENCH_RESULT")


def run_e2e(genome_len, coverage, seed=0):
    """FASTA→consensus assemble() on a synthetic workload.

    Runs in a child interpreter; prints a BENCH_E2E line with wall seconds,
    the per-stage timer breakdown, and reconstruction quality.
    """
    import tempfile

    import jax

    from hinge_tpu.data.simulator import SimParams, simulate
    from hinge_tpu.io.fasta import write_fasta
    from hinge_tpu.pipeline import assemble
    from hinge_tpu.utils.log import timings

    with tempfile.TemporaryDirectory() as tmp:
        p = SimParams(genome_len=genome_len, coverage=coverage, seed=seed)
        genome, reads, rs, ov = simulate(p)
        fasta = os.path.join(tmp, "reads.fasta")
        write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
        del reads, rs, ov
        t0 = time.perf_counter()
        res = assemble(fasta=fasta, workdir=tmp, log=lambda *a: None)
        wall = time.perf_counter() - t0
        longest = max((len(s) for _, s in res["contigs"]), default=0)
        out = {
            "wall_s": round(wall, 1),
            "stages": {k: round(v, 1) for k, v in timings().items()},
            "n_reads": sum(1 for line in open(fasta) if line.startswith(">")),
            "genome_mb": round(genome_len / 1e6, 2),
            "coverage_x": coverage,
            "n_contigs": len(res["contigs"]),
            "longest_contig_frac": round(longest / genome_len, 3),
            "platform": jax.default_backend(),
            "device_kind": jax.devices()[0].device_kind,
        }
        print("BENCH_E2E " + json.dumps(out))


def _e2e(timeout_s):
    if os.environ.get("HINGE_BENCH_E2E", "1") == "0" or timeout_s < 60:
        return None
    glen = int(os.environ.get("HINGE_BENCH_E2E_GENOME", 1_200_000))
    cov = float(os.environ.get("HINGE_BENCH_E2E_COV", 25.0))
    code = _CACHE_PRELUDE + f"from bench import run_e2e\nrun_e2e({glen}, {cov})\n"
    return _child(code, timeout_s, "BENCH_E2E")


def comms_model(n_devices: int, reads_chunk: int, nb: int, rec_axis=None):
    """Analytic per-step collective volume of sharded_filter_step (bytes
    MOVED per device, ring-collective accounting): the psum'd pileup grids
    and record stats ride the 'recs' axis, the mask all_gather rides
    'reads'.  This is the documented model a reader can check against the
    kernel (parallel/sharding.py:97-180); the measured numbers below are
    records/s at honest device counts."""
    if rec_axis is None:
        rec_axis = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    R = n_devices // rec_axis
    S = rec_axis
    b = 0
    # psum over 'recs': 2 grids (reads_chunk x nb int32) + 3 stat vectors
    if S > 1:
        ring = 2 * (S - 1) / S  # ring all-reduce traffic factor
        b += ring * (2 * reads_chunk * nb + 3 * reads_chunk) * 4
    # all_gather masks over 'reads': (reads_chunk, 2) int32 per device
    if R > 1:
        b += (R - 1) * reads_chunk * 2 * 4
    return int(b)


def main():
    budget = float(os.environ.get("HINGE_BENCH_BUDGET", 420))
    t0 = time.perf_counter()
    left = lambda: budget - (time.perf_counter() - t0)

    dev = _device_bench(timeout_s=max(60, 0.7 * budget))
    if dev is None or dev.get("backend") != "gpu" or "rps" not in dev:
        print(f"bench.py: no GPU measurement (child reported {dev})",
              file=sys.stderr)
        sys.exit(1)
    rps = dev["rps"]
    a_id, a_start, a_end, read_len = synth()
    base_rps, _ = bench_numpy_baseline(a_id, a_start, a_end, read_len)
    primary = {
        "metric": "overlap_pileup_records_per_s",
        "value": round(rps),
        "unit": "records/s",
        "vs_baseline": round(rps / base_rps, 2),
        "platform": dev["backend"],
        "device_kind": dev["device_kind"],
        "device_count": dev["device_count"],
        "chain": "coverage+masks+annotation+hinge_call (trim/classify is native-C in production)",
    }
    # the headline lands NOW — a driver timeout past this point still
    # captures the primary number
    print(json.dumps(primary), flush=True)

    e2e = _e2e(timeout_s=left() - 30)
    enriched = dict(primary, byte_account=byte_account())
    if e2e is not None:
        enriched["e2e"] = e2e
        primary["e2e_wall_s"] = e2e.get("wall_s")
    try:
        with open(os.path.join(_HERE, "BENCH_DETAIL.json"), "w") as f:
            json.dump(enriched, f, indent=1)
    except OSError:
        pass
    # LAST stdout line = the same compact primary object (tail-parse safe)
    print(json.dumps(primary), flush=True)


if __name__ == "__main__":
    main()
