"""Smoke run of the assembler's main path on an NVIDIA GPU.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards: the mesh path only

One card, three phases, one line each:

  device   the GPU backend, the card's name and power limit, and the
           native host library (its silent numpy fallback would hide a
           broken build);
  kernels  the filter, hinge-calling and matching-position device kernels
           at the filter's real shapes, on the GPU and on the CPU backend:
           every output must be bit-identical (all of it is integer work);
  e2e      a simulated 4.6 Mb genome at 30x (the E. coli demo shape)
           assembled FASTA -> GFA through `hinge_tpu.cli assemble` on the
           GPU, checked against the simulator's genome, then assembled again
           on the CPU backend: stage files, consensus FASTA and GFA must be
           byte-equal.

With --four only the four-card path runs: the sharded filter/maximal/layout
stage files (HINGE_SHARDED=1) must byte-match a one-card run of the same
input, and `__graft_entry__.dryrun_multichip(4)` must pass.

The last line is {"ok": true, "device": {...}}.  Any failure prints its
reason and exits non-zero without that line; so does a run without a GPU.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

os.environ["JAX_PLATFORMS"] = "cuda,cpu"  # CPU only for the comparisons

GENOME_LEN, COVERAGE = 4_600_000, 30
FOUR_GENOME_LEN, FOUR_COVERAGE = 1_200_000, 25
STAGE_FILES = [
    "asm.mas", "asm.cmas", "asm.repeat.txt", "asm.hinges.txt", "asm.cov.flag",
    "asm.self.flag", "asm.coverage.txt",                        # filter
    "asm.max", "asm.contained.txt",                             # maximal
    "asm.edges.hinges", "asm.edges.hinges2", "asm.hinge.list",  # layout
]
E2E_FILES = STAGE_FILES + ["asm.consensus.fasta", "asm_consensus.gfa"]


def phase(name, fn):
    try:
        return fn()
    except Exception as err:  # report and stop: no phase failure passes
        traceback.print_exc()
        print(f"[{name}] FAILED: {type(err).__name__}: {err}", flush=True)
        sys.exit(1)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------------
# phase: device
# --------------------------------------------------------------------------


def device_phase():
    import jax

    from hinge_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    check(jax.default_backend() == "gpu",
          f"no GPU backend (default backend is {jax.default_backend()!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi gave nothing")
    for line in smi.stdout.strip().splitlines():
        print(line, flush=True)
    from hinge_tpu.native import get_lib

    check(get_lib() is not None, "native host library did not build or load")
    dev = jax.devices()[0]
    print(f"[device] kind={dev.device_kind} count={len(jax.devices())} "
          f"jax={jax.__version__} native_lib=loaded cache={cache}", flush=True)
    return dev


# --------------------------------------------------------------------------
# phase: kernels
# --------------------------------------------------------------------------


def _filter_inputs(rng, n_reads, n_ov, maxlen):
    """Random overlap records, plus on every 8th read a pile of 40 records
    that start at one position: a coverage step, like a repeat boundary."""
    import numpy as np

    a_id = rng.integers(0, n_reads, n_ov)
    read_len = rng.integers(maxlen // 2, maxlen, n_reads)
    lo = rng.integers(0, maxlen // 2, n_ov)
    a_e = np.minimum(lo + rng.integers(1000, maxlen // 2, n_ov), read_len[a_id])
    step = np.repeat(np.arange(0, n_reads, 8), 40)
    a_id = np.concatenate([a_id, step])
    a_s = np.concatenate([lo, np.full(len(step), maxlen // 4)])
    a_e = np.concatenate([a_e, read_len[step]])
    order = np.argsort(a_id, kind="stable")
    return tuple(x[order].astype(np.int32) for x in (a_id, a_s, a_e))


def _hinge_inputs(rng, n_reads=512, n_tasks=2048, maxlen=30_000):
    import numpy as np

    read_rows = {}
    for r in range(n_reads):
        k = int(rng.integers(1, 128))
        ams = rng.integers(0, maxlen // 2, k).astype(np.int32)
        ame = (ams + rng.integers(500, maxlen // 2, k)).astype(np.int32)
        read_rows[r] = (ams, ame, rng.integers(0, 4000, k).astype(np.int32),
                        rng.integers(0, 4000, k).astype(np.int32))
    tasks = np.stack([rng.integers(0, n_reads, n_tasks),
                      np.zeros(n_tasks, np.int64)], axis=1)
    pos_a = rng.integers(500, maxlen - 500, n_tasks).astype(np.int32)
    grad = rng.choice(np.array([-1, 1], np.int32), n_tasks)
    m0 = rng.integers(0, 500, n_tasks).astype(np.int32)
    m1 = (pos_a + rng.integers(500, 5000, n_tasks)).astype(np.int32)
    return tasks, pos_a, grad, m0, m1, read_rows


def kernels_phase():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _synth_traced_batch
    from hinge_tpu.ops import classify as CL
    from hinge_tpu.ops import coverage as C
    from hinge_tpu.ops.hinge_call import call_hinges_device
    from hinge_tpu.stages.filter import CHUNK_READS

    reso, cut_off, min_cov, maxlen = 40, 300, 10, 30_000
    nb = maxlen // reso + 3
    rng = np.random.default_rng(0)
    a_id, a_s, a_e = _filter_inputs(rng, CHUNK_READS, 600_000, maxlen)
    hinge_in = _hinge_inputs(rng)
    tr = _synth_traced_batch(n_reads=2048, n_ov=16_384, maxlen=maxlen)
    tw = tr["tw"]
    ov_idx = rng.integers(0, len(tr["a_id"]), 65_536).astype(np.int32)
    pos = rng.integers(tr["a_start"][ov_idx], tr["a_end"][ov_idx] + 1).astype(np.int32)

    def filter_chain(a_id, a_s, a_e):
        cov = C.profile_coverage(a_id, a_s, a_e, jnp.int32(0),
                                 n_reads=CHUNK_READS, nb=nb, reso=reso)
        cov_cut = C.profile_coverage(a_id, a_s, a_e, jnp.int32(cut_off),
                                     n_reads=CHUNK_READS, nb=nb, reso=reso)
        me, ms, cnt = C.pileup_stats(a_id, a_s, a_e, n_reads=CHUNK_READS,
                                     nb=1, reso=reso)
        ne = C.n_entries_from_max_event(me, cnt, reso)
        ne_cut = C.n_entries_from_max_event(
            jnp.maximum(me - cut_off, ms + cut_off), cnt, reso)
        masks = C.coverage_mask(jnp.maximum(cov_cut - min_cov, 0), ne_cut,
                                reso=reso)
        ann = C.repeat_annotation_mask(
            cov, ne, masks[0], masks[1], jnp.int32(min_cov), reso=reso,
            coverage_fraction=3, min_thresh=10, max_thresh=20,
            no_hinge_region=500)
        return dict(profile_coverage=cov, profile_coverage_cut=cov_cut,
                    pileup_stats=(me, ms, cnt), coverage_mask=masks,
                    repeat_annotation_mask=ann)

    def run_all():
        out = {k: jax.tree.map(np.asarray, v)
               for k, v in filter_chain(a_id, a_s, a_e).items()}
        out["call_hinges_device"] = call_hinges_device(
            *hinge_in, theta=300, htl=300, hbl=200, hrut=6, hbpt=7)
        out["matching_position"] = np.asarray(CL.matching_position(
            ov_idx, pos, tr["a_start"], tr["a_end"], tr["b_start"],
            tr["b_end"], tr["rc"], tw.npairs, tw.pair_off, tw.cum,
            tspace=100))
        return out

    gpu = run_all()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = run_all()
    bad = []
    for name in gpu:
        g, c = jax.tree.leaves(gpu[name]), jax.tree.leaves(cpu[name])
        if not all(x.dtype == y.dtype and x.shape == y.shape
                   and np.array_equal(x, y) for x, y in zip(g, c)):
            bad.append(name)
    check(not bad, f"GPU != CPU for {bad}")
    check(int(gpu["profile_coverage"].sum()) > 0 and gpu["repeat_annotation_mask"].any()
          and gpu["call_hinges_device"][1].any(), "kernel outputs are all zero")
    mem = jax.jit(filter_chain).lower(a_id, a_s, a_e).compile().memory_analysis()
    mem_s = ", ".join(f"{k}={getattr(mem, k)}" for k in (
        "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(mem, k))
    print(f"[kernels] bit-identical GPU==CPU: {', '.join(gpu)} "
          f"(reads={CHUNK_READS} nb={nb} records={len(a_id)} "
          f"hinge_tasks={len(hinge_in[1])} queries={len(ov_idx)}); "
          f"filter chain memory_analysis: {mem_s}", flush=True)


# --------------------------------------------------------------------------
# phase: e2e
# --------------------------------------------------------------------------


def _simulate_fasta(tmp, genome_len, coverage):
    """The reads of `simulate(SimParams(...))`, without its exact overlaps
    (the pipeline computes its own)."""
    import numpy as np

    from hinge_tpu.data.simulator import (
        SimParams, make_genome, make_read_store, sample_reads,
    )
    from hinge_tpu.io.fasta import write_fasta

    p = SimParams(genome_len=genome_len, coverage=coverage, seed=0)
    rng = np.random.default_rng(p.seed)
    genome = make_genome(p, rng)
    rs = make_read_store(sample_reads(p, rng, genome), p, rng)
    fasta = os.path.join(tmp, "reads.fasta")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    return genome, fasta, rs.n_reads


def _genome_share(genome_codes, contig: str, k=32, stride=2000) -> float:
    """Share of the genome's sampled k-mers found in `contig` (either
    strand)."""
    from hinge_tpu.data.overlaps import codes_to_str, revcomp_codes, str_to_codes

    g = codes_to_str(genome_codes)
    rc = codes_to_str(revcomp_codes(str_to_codes(contig)))
    probes = [g[i:i + k] for i in range(0, len(g) - k, stride)]
    return sum(1 for p in probes if p in contig or p in rc) / len(probes)


def _diff_files(d1, d2, names):
    differ = []
    for n in names:
        p1, p2 = os.path.join(d1, n), os.path.join(d2, n)
        if not (os.path.exists(p1) and os.path.exists(p2)):
            differ.append(n + " (missing)")
        elif open(p1, "rb").read() != open(p2, "rb").read():
            differ.append(n)
    return differ


def e2e_phase():
    import jax

    from hinge_tpu import cli
    from hinge_tpu.io.fasta import iter_fastx
    from hinge_tpu.pipeline import assemble
    from hinge_tpu.utils.log import timings

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        genome, fasta, n_reads = _simulate_fasta(tmp, GENOME_LEN, COVERAGE)
        t_sim = time.perf_counter() - t0
        gdir, cdir = os.path.join(tmp, "gpu"), os.path.join(tmp, "cpu")

        before = timings()
        t0 = time.perf_counter()
        rc = cli.main(["assemble", "--fasta", fasta, "--workdir", gdir])
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli assemble returned {rc}")
        stages = {k: round(v - before.get(k, 0.0), 2) for k, v in timings().items()}

        contigs = [s for _, s, _ in iter_fastx(
            os.path.join(gdir, "asm.consensus.fasta"))]
        check(contigs, "no consensus contigs")
        longest = max(contigs, key=len)
        share = len(longest) / GENOME_LEN
        covered = _genome_share(genome, longest)
        check(covered >= 0.95, f"longest contig covers {covered:.3f} of the genome")

        t0 = time.perf_counter()
        with jax.default_device(jax.devices("cpu")[0]):
            assemble(fasta=fasta, workdir=cdir, log=lambda *a: None)
        cpu_wall = time.perf_counter() - t0
        differ = _diff_files(gdir, cdir, E2E_FILES)
        check(not differ, f"GPU and CPU runs differ in {differ}")
        print(f"[e2e] genome={GENOME_LEN} coverage={COVERAGE} reads={n_reads} "
              f"simulate_s={t_sim:.1f} gpu_wall_s={wall:.2f} stages_s={json.dumps(stages)} "
              f"contigs={len(contigs)} longest_share={share:.4f} "
              f"longest_covers={covered:.4f} cpu_backend_wall_s={cpu_wall:.2f} "
              f"byte-equal GPU==CPU: {len(E2E_FILES)} files", flush=True)


# --------------------------------------------------------------------------
# --four: the mesh path
# --------------------------------------------------------------------------


def four_phase():
    import jax

    from __graft_entry__ import dryrun_multichip
    from hinge_tpu.parallel.sharding import stage_mesh
    from hinge_tpu.pipeline import assemble

    devs = jax.devices()
    check(len(devs) == 4 and all(d.platform == "gpu" for d in devs),
          f"need four GPUs, have {devs}")
    with tempfile.TemporaryDirectory() as tmp:
        _, fasta, n_reads = _simulate_fasta(tmp, FOUR_GENOME_LEN, FOUR_COVERAGE)
        d4, d1 = os.path.join(tmp, "mesh4"), os.path.join(tmp, "one")
        # sharded run first, so each card's peak memory shows its own share
        os.environ["HINGE_SHARDED"] = "1"
        mesh = stage_mesh()
        check(mesh is not None and len({d.id for d in mesh.devices.flat}) == 4,
              f"stage mesh is {mesh}")
        t0 = time.perf_counter()
        assemble(fasta=fasta, workdir=d4, log=lambda *a: None)
        t4 = time.perf_counter() - t0
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) for d in devs]
        check(all(p > 0 for p in peaks), f"a card did no work: peaks {peaks}")
        del os.environ["HINGE_SHARDED"]
        t0 = time.perf_counter()
        assemble(fasta=fasta, workdir=d1, log=lambda *a: None)
        t1 = time.perf_counter() - t0
        differ = _diff_files(d4, d1, STAGE_FILES)
        check(not differ, f"sharded and one-card stage files differ in {differ}")
    dryrun_multichip(4)
    print(f"[four] mesh {dict(mesh.shape)} over GPUs "
          f"{[d.id for d in mesh.devices.flat]}, peak bytes per card {peaks}; "
          f"genome={FOUR_GENOME_LEN} coverage={FOUR_COVERAGE} reads={n_reads} "
          f"sharded_wall_s={t4:.2f} one_card_wall_s={t1:.2f}; "
          f"{len(STAGE_FILES)} stage files byte-equal; dryrun_multichip(4) ok",
          flush=True)


# --------------------------------------------------------------------------


class _CompileCounter:
    """Persistent-cache hits and misses, from JAX's monitoring events."""

    def __init__(self):
        import jax

        self.hits = self.misses = 0
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1


def main():
    four = "--four" in sys.argv[1:]
    t0 = time.perf_counter()
    dev = phase("device", device_phase)
    counter = _CompileCounter()
    if four:
        phase("four", four_phase)
    else:
        phase("kernels", kernels_phase)
        phase("e2e", e2e_phase)
    import jax

    print(f"[total] wall_s={time.perf_counter() - t0:.1f} "
          f"compile_cache hits={counter.hits} misses={counter.misses}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
