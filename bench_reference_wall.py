"""Time the REAL reference stage binaries vs hinge_tpu's stages on
identical inputs (BASELINE.md row 2: "beat reference CPU pipeline").

4.6Mb/30x seed-0 workload (the E. coli demo shape); both sides consume
the same X.db/X.las (exact simulator overlaps), the reference binaries
built by refbuild/build.sh (the actual Reads_filter/get_maximal_reads/
hinging/draft_assembly/consensus from /root/reference, spdlog+Boost shims
only).  hinge_tpu stages run in child interpreters on the CPU backend so
the comparison is host-for-host.  The reference's clip/draft-path are py2-only
and its overlapper is external DALIGNER, so both sides share hinge_tpu's
edges.list and mapper .las exactly as tests/test_reference_parity.py does.

Prints one "RESULT {json}" line with the per-stage walls of both sides.

  python bench_reference_wall.py [genome_len] [coverage]
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
BIN = os.path.join(_HERE, "refbuild", "bin")
REF_INI = "/root/reference/utils/nominal.ini"

GLEN = int(sys.argv[1]) if len(sys.argv) > 1 else 4_600_000
COV = float(sys.argv[2]) if len(sys.argv) > 2 else 30.0

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from hinge_tpu.data.simulator import SimParams, simulate  # noqa: E402
from hinge_tpu.io.dazz_db import write_db  # noqa: E402
from hinge_tpu.io.las import write_las  # noqa: E402

ref_t = {}
my_t = {}


def run_ref(tag, cwd, argv, timeout=900):
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=cwd, capture_output=True, text=True,
                       timeout=timeout)
    dt = time.perf_counter() - t0
    assert r.returncode == 0, (tag, r.stdout[-1500:], r.stderr[-1500:])
    ref_t[tag] = round(dt, 1)
    print(f"ref  {tag}: {dt:.1f}s", flush=True)


def run_mine(tag, cwd, argv, timeout=900):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_HERE)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "hinge_tpu.cli", *argv],
                       cwd=cwd, capture_output=True, text=True,
                       timeout=timeout, env=env)
    dt = time.perf_counter() - t0
    assert r.returncode == 0, (tag, r.stdout[-1500:], r.stderr[-1500:])
    my_t[tag] = round(dt, 1)
    print(f"mine {tag}: {dt:.1f}s", flush=True)


with tempfile.TemporaryDirectory() as base:
    ref_dir = os.path.join(base, "ref")
    my_dir = os.path.join(base, "mine")
    os.makedirs(ref_dir)
    os.makedirs(my_dir)
    t0 = time.perf_counter()
    p = SimParams(genome_len=GLEN, coverage=COV, seed=0)
    genome, reads, rs, ov = simulate(p)
    write_db(os.path.join(ref_dir, "X.db"), rs)
    write_las(os.path.join(ref_dir, "X.las"), ov)
    shutil.copy(REF_INI, os.path.join(ref_dir, "nominal.ini"))
    n_reads, n_ov = rs.n_reads, ov.n
    del genome, reads, rs, ov
    for f in os.listdir(ref_dir):
        os.link(os.path.join(ref_dir, f), os.path.join(my_dir, f))
    print(f"sim {n_reads} reads / {n_ov} records ({time.perf_counter()-t0:.1f}s)",
          flush=True)

    std = ["--db", "X", "--las", "X.las", "-x", "X", "--config", "nominal.ini"]
    run_ref("filter", ref_dir, [os.path.join(BIN, "Reads_filter"), *std])
    run_mine("filter", my_dir, ["filter", "--db", "X", "--las", "X.las",
                                "--prefix", "X", "--config", "nominal.ini"])
    run_ref("maximal", ref_dir, [os.path.join(BIN, "get_maximal_reads"), *std])
    run_mine("maximal", my_dir, ["maximal", "--db", "X", "--las", "X.las",
                                 "--prefix", "X", "--config", "nominal.ini"])
    run_ref("layout", ref_dir, [os.path.join(BIN, "hinging"), *std, "-o", "X"])
    run_mine("layout", my_dir, ["layout", "--db", "X", "--las", "X.las",
                                "--prefix", "X", "--config", "nominal.ini",
                                "--out", "X"])

    # shared graph stages (reference's are py2-only): hinge_tpu's edges.list
    run_mine("clip", my_dir, ["clip", "X.edges.hinges", "X.hinge.list", "1"])
    run_mine("draft_path", my_dir,
             ["draft-path", ".", "X", "X1.G2.graphml", "--db", "X"])
    shutil.copy(os.path.join(my_dir, "X.edges.list"),
                os.path.join(ref_dir, "X.edges.list"))
    run_ref("draft", ref_dir, [os.path.join(BIN, "draft_assembly"), *std,
                               "--out", "X.draft", "--path", "X.edges.list"])
    run_mine("draft", my_dir, ["draft", "--db", "X", "--las", "X.las",
                               "--prefix", "X", "--config", "nominal.ini",
                               "--out", "X.draft"])

    # shared mapper las (reference runs external DALIGNER here)
    run_mine("map", my_dir, ["map", "X.draft.fasta", "--db", "X",
                             "--out", "draft.X.las"])
    from hinge_tpu.io.fasta import read_fasta
    contigs = read_fasta(os.path.join(my_dir, "X.draft.fasta"))
    write_db(os.path.join(ref_dir, "draft.db"), contigs)
    shutil.copy(os.path.join(my_dir, "draft.X.las"),
                os.path.join(ref_dir, "draft.X.las"))
    run_ref("consensus", ref_dir,
            [os.path.join(BIN, "consensus"), "draft", "X", "draft.X.las",
             "X.consensus.fasta", "nominal.ini"])
    run_mine("consensus", my_dir,
             ["consensus", "X.draft.fasta", "X.db", "draft.X.las",
              "X.consensus.fasta", "nominal.ini"])
    same = (open(os.path.join(ref_dir, "X.consensus.fasta"), "rb").read()
            == open(os.path.join(my_dir, "X.consensus.fasta"), "rb").read())

entry = {
    "date": time.strftime("%Y-%m-%d"),
    "kind": "reference_stage_wall",
    "workload": {"genome_mb": round(GLEN / 1e6, 2), "coverage_x": COV,
                 "n_reads": n_reads, "n_records": n_ov},
    "reference_binaries_s": ref_t,
    "hinge_tpu_cpu_s": my_t,
    "reference_total_s": round(sum(ref_t.values()), 1),
    "hinge_tpu_cpu_total_s": round(sum(my_t.values()), 1),
    # apples-to-apples: only the five stages the reference side also runs
    # (clip/draft-path/map are ours on BOTH sides and excluded from
    # reference_total_s, so the all-stage total above overstates our side)
    "hinge_tpu_cpu_5stage_s": round(sum(
        my_t.get(k, 0.0)
        for k in ("filter", "maximal", "layout", "draft", "consensus")), 1),
    "consensus_fasta_identical": bool(same),
    "notes": ("identical X.db/X.las inputs; reference binaries from "
              "refbuild/build.sh; clip/draft-path (py2-only upstream) and "
              "the mapper las are hinge_tpu's on both sides; hinge_tpu side "
              "forced to the CPU backend (host-for-host)"),
}
print("RESULT " + json.dumps(entry), flush=True)
