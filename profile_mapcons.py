"""Profile the consensus-phase (map + consensus) in isolation.

Mirrors pipeline._assemble_body's tail: contigs = [genome fwd, genome rc]
(the draft emits contig + revcomp adjacently), map reads onto them, then
run_consensus.  Coarse timers + cProfile of the two stages.
"""
import cProfile
import os
import pstats
import sys
import time

# host profiler: pin the numpy vote unless --device asks for the device kernel
if "--device" not in sys.argv:
    os.environ.setdefault("HINGE_DEVICE_VOTE", "0")

import numpy as np

from hinge_tpu.config import nominal_config
from hinge_tpu.data import simulator as S
from hinge_tpu.data.overlaps import revcomp_codes
from hinge_tpu.overlap.mapper import map_reads_to_targets
from hinge_tpu.stages.consensus import run_consensus
from hinge_tpu.stages.draft import codes_to_text

GLEN = int(sys.argv[1]) if len(sys.argv) > 1 else 4_600_000
COV = 30.0
PROF = "--prof" in sys.argv

p = S.SimParams(genome_len=GLEN, coverage=COV, seed=0)
rng = np.random.default_rng(p.seed)
genome = S.make_genome(p, rng)
reads = S.sample_reads(p, rng, genome)
rs = S.make_read_store(reads, p, rng)
print(f"{rs.n_reads} reads, genome {GLEN}", flush=True)

targets = [genome, revcomp_codes(genome)]
contigs = [("Draft0", codes_to_text(genome)),
           ("Draft1", codes_to_text(revcomp_codes(genome)))]

t0 = time.time()
if PROF:
    pr = cProfile.Profile()
    pr.enable()
aln = map_reads_to_targets(targets, rs)
t_map = time.time() - t0
print(f"map: {t_map:.1f}s, {aln.n} records", flush=True)

t0 = time.time()
cfg = nominal_config()
cons = run_consensus(contigs, rs, aln, cfg)
t_cons = time.time() - t0
if PROF:
    pr.disable()
    st = pstats.Stats(pr)
    st.sort_stats("cumulative").print_stats(30)
print(f"consensus: {t_cons:.1f}s, lens {[len(s) for _, s in cons]}", flush=True)
