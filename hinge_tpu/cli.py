"""Unified `hinge` command-line interface.

Mirrors the reference dispatcher (`src/hinge:8-58`):

    hinge {filter,maximal,layout,clip,clip-nanopore,draft-path,draft,
           correct-head,consensus,fasta2q,gfa,visualize,condense,split_las}

with the reference binaries' flags (--db/--las | --fasta/--paf, --config,
--prefix, --out, --mlas, --restrictreads).  Additional subcommands beyond
the reference surface: `map` (built-in read-to-contig mapper replacing the
external DALIGNER run of the consensus phase) and `assemble` (one-shot
end-to-end pipeline).

Run as `python -m hinge_tpu.cli <subcommand> ...` or via the `hinge-tpu`
entry point.
"""

from __future__ import annotations

import argparse
import glob as _glob
import os
import sys
from typing import List, Optional, Tuple

import numpy as np


def _load_reads(args) -> "ReadStore":
    from hinge_tpu.io.dazz_db import read_db
    from hinge_tpu.io.fasta import read_fasta

    if getattr(args, "db", None):
        return read_db(args.db)
    if getattr(args, "fasta", None):
        return read_fasta(args.fasta)
    raise SystemExit("Pass in either a db and a las or a fasta and a paf")


def _las_parts(args) -> List[str]:
    """--mlas: X.1.las, X.2.las, ... (reference glob loop, filter.cpp:35-63)."""
    if getattr(args, "mlas", False):
        out = []
        i = 1
        while True:
            cand = f"{args.las}.{i}.las"
            if os.path.exists(cand):
                out.append(cand)
                i += 1
            else:
                break
        return out
    las = args.las
    if las and not las.endswith(".las"):
        las = las + ".las"
    return [las] if las else []


def _load_overlap_parts(args, rs) -> List["OverlapStore"]:
    from hinge_tpu.io.las import read_las
    from hinge_tpu.io.paf import read_paf

    if getattr(args, "las", None):
        return [read_las(p, read_lengths=rs.length) for p in _las_parts(args)]
    if getattr(args, "paf", None):
        return [read_paf(args.paf)]
    raise SystemExit("Need to provide either las and db or paf and fasta")


def _config(args) -> "Config":
    from hinge_tpu.config import Config, nominal_config

    if getattr(args, "config", None):
        return Config.from_ini(args.config)
    # no ini: use the reference's nominal.ini values (every reference demo
    # passes it; the bare call-site defaults of -1 make stages inert)
    return nominal_config()


def _add_io_flags(sp, need_out=False):
    sp.add_argument("--db", "-b", default="")
    sp.add_argument("--las", "-l", default="")
    sp.add_argument("--paf", "-p", default="")
    sp.add_argument("--fasta", "-f", default="")
    sp.add_argument("--config", "-c", default="")
    sp.add_argument("--prefix", "-x", default="out")
    sp.add_argument("--restrictreads", "-r", default="")
    sp.add_argument("--log", "-g", default="log")
    sp.add_argument("--mlas", action="store_true")
    sp.add_argument("--debug", action="store_true")
    if need_out:
        sp.add_argument("--out", "-o", required=True)


def cmd_filter(args):
    from hinge_tpu.stages.filter import run_filter

    rs = _load_reads(args)
    parts = _load_overlap_parts(args, rs)
    cfg = _config(args)
    keep = None
    if args.restrictreads:
        with open(args.restrictreads) as f:
            keep = {int(line.split()[0]) for line in f if line.strip()}
    run_filter(rs, parts, cfg, out_prefix=args.prefix, reads_to_keep=keep)
    print(f"[filter] wrote {args.prefix}.mas / .repeat.txt / .hinges.txt")


def cmd_maximal(args):
    from hinge_tpu.stages.maximal import read_mas, run_maximal

    rs = _load_reads(args)
    parts = _load_overlap_parts(args, rs)
    cfg = _config(args)
    eff_s, eff_e = read_mas(args.prefix + ".mas", rs.n_reads)
    res = run_maximal(
        rs, parts, cfg, eff_s, eff_e, out_prefix=args.prefix, has_db=bool(args.db)
    )
    print(f"[maximal] {int(res.active.sum())}/{rs.n_reads} maximal reads -> {args.prefix}.max")


def cmd_layout(args):
    from hinge_tpu.stages.layout import load_marked, run_layout
    from hinge_tpu.stages.maximal import read_mas

    rs = _load_reads(args)
    parts = _load_overlap_parts(args, rs)
    cfg = _config(args)
    eff_s, eff_e = read_mas(args.prefix + ".mas", rs.n_reads)
    maximal = np.zeros(rs.n_reads, dtype=bool)
    with open(args.prefix + ".max") as f:
        for line in f:
            maximal[int(line.split()[0])] = True
    res = run_layout(
        rs, parts, cfg, eff_s, eff_e, maximal,
        load_marked(args.prefix + ".repeat.txt"),
        load_marked(args.prefix + ".hinges.txt"),
        out_prefix=args.out, filter_prefix=args.prefix, has_db=bool(args.db),
    )
    print(f"[layout] {len(res.edges_hinges)} edges -> {args.out}.edges.hinges")


def cmd_clip(args, nanopore=False):
    from hinge_tpu.stages.clip import run_clip

    cfg = _config(args)
    run_clip(args.edges, args.hinge_list, args.suffix, cfg, nanopore=nanopore,
             mapping_json=args.json)
    prefix = args.edges.split(".")[0]
    print(f"[clip] wrote {prefix}{args.suffix}.G0/G1/G2.graphml")


def cmd_draft_path(args):
    from hinge_tpu.graph.digraph import read_graphml
    from hinge_tpu.stages.draft_path import run_draft_path

    rs = _load_reads(args)
    g = read_graphml(args.graphml)
    out_edges = os.path.join(args.filedir, args.filename + ".edges.list")
    out_gml = os.path.join(args.filedir, args.filename + "_draft.graphml")
    lines, _ = run_draft_path(g, rs.length, out_edges_list=out_edges, out_graphml=out_gml)
    print(f"[draft-path] {sum(1 for l in lines if l.startswith('>'))} contigs -> {out_edges}")


def cmd_draft(args):
    from hinge_tpu.stages.draft import run_draft

    rs = _load_reads(args)
    parts = _load_overlap_parts(args, rs)
    cfg = _config(args)
    maximal = np.zeros(rs.n_reads, dtype=bool)
    with open(args.prefix + ".max") as f:
        for line in f:
            maximal[int(line.split()[0])] = True
    contigs = run_draft(
        rs, parts, cfg, maximal, args.prefix + ".edges.list",
        out_fasta=args.out + ".fasta",
    )
    print(f"[draft] {len(contigs)} contigs -> {args.out}.fasta")


def cmd_correct_head(args):
    from hinge_tpu.io.fasta import correct_head

    correct_head(args.input, args.output, args.lookup)
    print(f"[correct-head] -> {args.output}, map {args.lookup}")


def cmd_map(args):
    from hinge_tpu.io.fasta import read_fasta
    from hinge_tpu.io.las import write_las
    from hinge_tpu.data.overlaps import str_to_codes
    from hinge_tpu.overlap.mapper import map_reads_to_targets

    contigs = read_fasta(args.contigs)
    rs = _load_reads(args)
    targets = [contigs.get_bases(i) for i in range(contigs.n_reads)]
    aln = map_reads_to_targets(targets, rs, min_span=args.min_span)
    write_las(args.out, aln)
    print(f"[map] {aln.n} alignments -> {args.out}")


def cmd_consensus(args):
    from hinge_tpu.config import Config, nominal_config
    from hinge_tpu.io.fasta import iter_fastx, read_fasta
    from hinge_tpu.io.las import read_las
    from hinge_tpu.stages.consensus import run_consensus

    contigs_rs = read_fasta(args.db1)
    rs = _load_reads_from_path(args.db2)
    cfg = Config.from_ini(args.config) if args.config else nominal_config()
    contigs = [(contigs_rs.names[i], contigs_rs.get_seq(i)) for i in range(contigs_rs.n_reads)]
    aln = read_las(args.las, read_lengths=None)
    # fill lengths: A = contigs, B = reads.  The 2-DB las indexes two id
    # spaces, so the reader ran without lengths and derived rc rows'
    # forward-strand b coords with b_len = 0 (b_start = -be_frame,
    # b_end = -bb_frame); shifting by the true b_len completes the
    # complement-frame -> forward conversion.
    aln.a_len = contigs_rs.length[aln.a_id].astype(np.int32)
    blen = rs.length[aln.b_id].astype(np.int32)
    aln.b_len = blen
    rcm = aln.rc == 1
    aln.b_start = np.where(rcm, blen + aln.b_start, aln.b_start).astype(aln.b_start.dtype)
    aln.b_end = np.where(rcm, blen + aln.b_end, aln.b_end).astype(aln.b_end.dtype)
    res = run_consensus(contigs, rs, aln, cfg, out_fasta=args.out)
    print(f"[consensus] {len(res)} contigs -> {args.out}")


def _load_reads_from_path(path):
    from hinge_tpu.io.dazz_db import read_db
    from hinge_tpu.io.fasta import read_fasta

    if path.endswith(".db") or os.path.exists(path + ".db"):
        return read_db(path)
    return read_fasta(path)


def cmd_gfa(args):
    from hinge_tpu.stages.gfa import run_gfa

    in_gml = os.path.join(args.filedir, args.filename + "_draft.graphml")
    map_path = os.path.join(args.filedir, "draft_map.txt")
    out = os.path.join(args.filedir, args.filename + "_consensus.gfa")
    run_gfa(in_gml, map_path, args.consensus, out_gfa=out)
    print(f"[gfa] -> {out}")


def cmd_condense(args):
    from hinge_tpu.graph.condense import condense_graph
    from hinge_tpu.graph.digraph import read_graphml, write_graphml

    g = read_graphml(args.graphml)
    h = condense_graph(g)
    out = args.out or (args.graphml.replace(".graphml", "") + ".condensed.graphml")
    write_graphml(h, out)
    print(f"[condense] {len(g)} -> {len(h)} nodes, {out}")


def cmd_visualize(args):
    from hinge_tpu.graph.digraph import DiGraph, write_graphml

    G = DiGraph()
    with open(args.edges) as f:
        for line in f:
            t = line.split()
            if len(t) >= 2:
                G.add_edge(t[0], t[1])
    write_graphml(G, args.out)
    print(f"[visualize] -> {args.out}")


def cmd_split_las(args):
    from hinge_tpu.io.las import read_las, split_las, write_las

    ov = read_las(args.las)
    n_reads = int(ov.a_id.max()) + 1 if ov.n else 0
    parts = split_las(ov, n_reads, max_records=args.max_records)
    base = args.las[:-4] if args.las.endswith(".las") else args.las
    for i, p in enumerate(parts):
        write_las(f"{base}.{i+1}.las", p)
    print(f"[split_las] {len(parts)} parts")


def cmd_merge_las(args):
    """LAmerge equivalent: merge sorted .las parts into one
    (reference README.md:101)."""
    from hinge_tpu.io.las import merge_las

    merged = merge_las(args.parts, out_path=args.out)
    print(f"[merge_las] {len(args.parts)} parts -> {args.out} "
          f"({merged.n} records)")


def cmd_fasta2q(args):
    from hinge_tpu.io.fasta import iter_fastx

    with open(args.output, "w") as out:
        for name, seq, _ in iter_fastx(args.input):
            out.write(f"@{name}\n{seq}\n+\n{'l' * len(seq)}\n")
    print(f"[fasta2q] -> {args.output}")


def cmd_overlap(args):
    """All-vs-all read overlapping with the built-in minimizer overlapper
    (standalone replacement for the external DALIGNER run)."""
    from hinge_tpu.io.las import write_las
    from hinge_tpu.overlap.mapper import overlap_reads

    rs = _load_reads(args)
    ov = overlap_reads(rs, min_span=args.min_span)
    write_las(args.out, ov)
    print(f"[overlap] {ov.n} overlaps -> {args.out}")


def cmd_gt(args):
    """Ground-truth mapping: reads vs reference -> mapping.json
    (replaces scripts/run_mapping.py's LA4Awesome run)."""
    from hinge_tpu.graph.groundtruth import run_mapping
    from hinge_tpu.io.fasta import read_fasta

    rs = _load_reads(args)
    ref = read_fasta(args.reference)
    run_mapping(rs, ref, out_json=args.out)
    print(f"[gt] mapping -> {args.out}")


def cmd_n50(args):
    """N50 report (scripts/compute_n50_from_draft.py): draft graphml or
    FASTA input."""
    from hinge_tpu.graph.analysis import n50_from_draft_graphml, n50_from_fasta

    if args.input.endswith((".graphml", ".gml")):
        stats = n50_from_draft_graphml(args.input)
    else:
        stats = n50_from_fasta(args.input)
    for k, v in stats.items():
        print(f"{k}\t{v}")


def cmd_unitig(args):
    """Unitig path extraction (scripts/unitig.py)."""
    from hinge_tpu.graph.analysis import write_unitig_edges
    from hinge_tpu.graph.digraph import read_graphml

    g = read_graphml(args.graphml)
    out = args.out or (args.graphml.split(".")[0] + ".edges.list")
    n = write_unitig_edges(g, out)
    print(f"[unitig] {n} unitigs -> {out}")


def cmd_fasta2fastq(args):
    from hinge_tpu.io.fasta import fasta_to_fastq

    n = fasta_to_fastq(args.input, args.output)
    print(f"[fasta2fastq] {n} records -> {args.output}")


def cmd_clip_ends(args):
    from hinge_tpu.utils.smalltools import clip_ends

    kept = clip_ends(args.ground_truth, args.edges, args.out)
    print(f"[clip-ends] {kept} edges kept -> {args.out or args.edges + '.clipped'}")


def cmd_bandage(args):
    from hinge_tpu.utils.smalltools import create_bandage_file

    n = create_bandage_file(args.edges, args.out)
    print(f"[bandage] {n} nodes -> {args.out}")


def cmd_condense_gfa(args):
    from hinge_tpu.graph.condense import condense_gfa_n50

    n50, g = condense_gfa_n50(args.edges, mapping_json=args.json,
                              out_prefix=args.out_prefix)
    print(f"[condense-gfa] {len(g)} nodes, N50 = {n50}")


def cmd_draw(args):
    """Pile-o-gram of one read's overlaps (scripts/draw2.py)."""
    from hinge_tpu.io.las import read_las
    from hinge_tpu.utils.draw import plot_pileup

    rs = _load_reads(args)
    ov = read_las(args.las, read_lengths=rs.length)
    out = args.out or f"read_{args.read}.png"
    n = plot_pileup(ov, rs, args.read, out)
    print(f"[draw] read {args.read}: {n} partners -> {out}")


def cmd_hgraph(args):
    """Hinge-graph file -> graphml (scripts/create_hgraph[_nogt].py)."""
    import json

    from hinge_tpu.graph.analysis import create_hgraph

    gt = None
    if args.gt:
        with open(args.gt) as f:
            gt = json.load(f)
    _, n_weak, n_strong = create_hgraph(args.hgraph, gt=gt, out_graphml=args.out)
    print(n_weak)
    print(n_strong)


def cmd_connected(args):
    """Iterated in-degree-0 trim of a `u->v` edge list (scripts/connected.py)."""
    from hinge_tpu.graph.analysis import connected_trim
    from hinge_tpu.graph.digraph import weakly_connected_components

    g = connected_trim(args.edges, args.dfs_out, out_graphml=args.out,
                       n_iter=args.iters)
    comps = [len(c) for c in weakly_connected_components(g)]
    print(f"[connected] {g.number_of_nodes()} nodes "
          f"{g.number_of_edges()} edges, components {sorted(comps, reverse=True)}")


def cmd_repeat_annotate(args):
    """Annotate ground-truth rows with a repeat flag
    (scripts/repeat_annotate_reads.py, internal repeat finder)."""
    from hinge_tpu.utils.smalltools import repeat_annotate_reads

    n = repeat_annotate_reads(args.fasta, args.gt, args.out,
                              min_len=args.min_len, repeats_out=args.repeats)
    print(f"[repeat-annotate] {n} rows -> {args.out}")


def cmd_merge_hinges(args):
    """Alternative hinge-merged layout post-processing
    (scripts/merge_hinges.py)."""
    from hinge_tpu.graph.merge_hinges import merge_hinges_run

    out = merge_hinges_run(
        args.edges, args.hgraph, args.hinges,
        gt_file=args.gt or None, prefix=args.prefix or None, seed=args.seed,
    )
    for name, g in out.items():
        print(f"[merge-hinges] {name}: {g.number_of_nodes()} nodes "
              f"{g.number_of_edges()} edges")


def cmd_single_strand(args):
    """Keep one strand per contig pair (get_draft_path_norevcomp.py /
    get_single_strand.py)."""
    from hinge_tpu.io.fasta import select_single_strand

    n = select_single_strand(args.input, args.output, mode=args.mode)
    print(f"[single-strand] {n} records -> {args.output}")


def cmd_assemble(args):
    """One-shot pipeline: overlaps -> consensus GFA (our extension)."""
    from hinge_tpu.pipeline import assemble

    assemble(
        fasta=args.fasta, paf=args.paf, db=args.db, las=args.las,
        config=args.config, workdir=args.workdir, nanopore=args.nanopore,
        norevcomp=args.norevcomp, trace_dir=args.trace,
    )
    if args.timings:
        from hinge_tpu.utils.log import timings

        for name, dt in timings().items():
            print(f"[timing] {name}: {dt:.2f}s")


def cmd_sweep(args):
    """Accuracy sweep: the NCTC-batch-report equivalent on the simulator."""
    from hinge_tpu.utils.sweep import run_sweep

    run_sweep(genome_len=args.genome_len, seed=args.seed,
              out_prefix=args.out, ref_parity=not args.no_ref_parity)


def main(argv: Optional[List[str]] = None) -> int:
    from hinge_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="hinge-tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("filter")
    _add_io_flags(sp)
    sp.set_defaults(func=cmd_filter)

    sp = sub.add_parser("maximal")
    _add_io_flags(sp)
    sp.set_defaults(func=cmd_maximal)

    sp = sub.add_parser("layout")
    _add_io_flags(sp, need_out=True)
    sp.set_defaults(func=cmd_layout)

    for name, nano in (("clip", False), ("clip-nanopore", True)):
        sp = sub.add_parser(name)
        sp.add_argument("edges")
        sp.add_argument("hinge_list")
        sp.add_argument("suffix")
        sp.add_argument("config", nargs="?", default="")
        sp.add_argument("json", nargs="?", default=None)
        sp.set_defaults(func=lambda a, _n=nano: cmd_clip(a, nanopore=_n))

    sp = sub.add_parser("draft-path")
    sp.add_argument("filedir")
    sp.add_argument("filename")
    sp.add_argument("graphml")
    sp.add_argument("--db", default="")
    sp.add_argument("--fasta", default="")
    sp.set_defaults(func=cmd_draft_path)

    sp = sub.add_parser("draft")
    _add_io_flags(sp, need_out=True)
    sp.set_defaults(func=cmd_draft)

    sp = sub.add_parser("correct-head", aliases=["correct_head"])
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("lookup")
    sp.set_defaults(func=cmd_correct_head)

    sp = sub.add_parser("map")
    sp.add_argument("contigs")
    sp.add_argument("--db", default="")
    sp.add_argument("--fasta", default="")
    sp.add_argument("--out", "-o", required=True)
    sp.add_argument("--min-span", type=int, default=1000)
    sp.set_defaults(func=cmd_map)

    sp = sub.add_parser("consensus")
    sp.add_argument("db1")  # draft contigs (fasta or db)
    sp.add_argument("db2")  # raw reads
    sp.add_argument("las")
    sp.add_argument("out")
    sp.add_argument("config", nargs="?", default="")
    sp.set_defaults(func=cmd_consensus)

    sp = sub.add_parser("gfa")
    sp.add_argument("filedir")
    sp.add_argument("filename")
    sp.add_argument("consensus")
    sp.set_defaults(func=cmd_gfa)

    sp = sub.add_parser("condense")
    sp.add_argument("graphml")
    sp.add_argument("--out", default=None)
    sp.set_defaults(func=cmd_condense)

    sp = sub.add_parser("visualize", aliases=["visualise"])
    sp.add_argument("edges")
    sp.add_argument("out")
    sp.set_defaults(func=cmd_visualize)

    sp = sub.add_parser("split_las")
    sp.add_argument("las")
    sp.add_argument("--max-records", type=int, default=1_000_000)
    sp.set_defaults(func=cmd_split_las)

    sp = sub.add_parser("merge_las", aliases=["merge-las"])
    sp.add_argument("out")
    sp.add_argument("parts", nargs="+")
    sp.set_defaults(func=cmd_merge_las)

    sp = sub.add_parser("fasta2q")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.set_defaults(func=cmd_fasta2q)

    sp = sub.add_parser("overlap")
    sp.add_argument("--db", default="")
    sp.add_argument("--fasta", default="")
    sp.add_argument("--out", "-o", required=True)
    sp.add_argument("--min-span", type=int, default=1000)
    sp.set_defaults(func=cmd_overlap)

    sp = sub.add_parser("gt")
    sp.add_argument("reference")
    sp.add_argument("--db", default="")
    sp.add_argument("--fasta", default="")
    sp.add_argument("--out", "-o", required=True)
    sp.set_defaults(func=cmd_gt)

    sp = sub.add_parser("n50")
    sp.add_argument("input", help="draft graphml or fasta")
    sp.set_defaults(func=cmd_n50)

    sp = sub.add_parser("unitig")
    sp.add_argument("graphml")
    sp.add_argument("--out", default=None)
    sp.set_defaults(func=cmd_unitig)

    sp = sub.add_parser("fasta2fastq")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.set_defaults(func=cmd_fasta2fastq)

    sp = sub.add_parser("clip-ends")
    sp.add_argument("ground_truth")
    sp.add_argument("edges")
    sp.add_argument("--out", default=None)
    sp.set_defaults(func=cmd_clip_ends)

    sp = sub.add_parser("bandage")
    sp.add_argument("edges")
    sp.add_argument("out")
    sp.set_defaults(func=cmd_bandage)

    sp = sub.add_parser("condense-gfa")
    sp.add_argument("edges")
    sp.add_argument("--json", default=None)
    sp.add_argument("--out-prefix", default=None)
    sp.set_defaults(func=cmd_condense_gfa)

    sp = sub.add_parser("draw")
    sp.add_argument("las")
    sp.add_argument("read", type=int)
    sp.add_argument("--db", default="")
    sp.add_argument("--fasta", default="")
    sp.add_argument("--out", default=None)
    sp.set_defaults(func=cmd_draw)

    sp = sub.add_parser("hgraph", aliases=["create-hgraph"])
    sp.add_argument("hgraph", help="X.hgraph")
    sp.add_argument("--gt", default="", help="X.mapping.json ground truth")
    sp.add_argument("--out", default=None)
    sp.set_defaults(func=cmd_hgraph)

    sp = sub.add_parser("connected")
    sp.add_argument("edges", help="edge file of 'u->v' lines")
    sp.add_argument("dfs_out", help="output DFS edge list")
    sp.add_argument("--out", default=None, help="output graphml")
    sp.add_argument("--iters", type=int, default=15)
    sp.set_defaults(func=cmd_connected)

    sp = sub.add_parser("repeat-annotate", aliases=["repeat_annotate"])
    sp.add_argument("fasta", help="genome multifasta (headers = 1-based chr)")
    sp.add_argument("gt", help="ground-truth file: read chr start end ...")
    sp.add_argument("out")
    sp.add_argument("--min-len", type=int, default=1000)
    sp.add_argument("--repeats", default=None, help="write discovered repeats")
    sp.set_defaults(func=cmd_repeat_annotate)

    sp = sub.add_parser("merge-hinges", aliases=["merge_hinges"])
    sp.add_argument("edges", help="X.edges.hinges2")
    sp.add_argument("hgraph", help="X.hgraph")
    sp.add_argument("hinges", help="X.hinge.list")
    sp.add_argument("--gt", default="", help="X.mapping.json ground truth")
    sp.add_argument("--prefix", default="")
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(func=cmd_merge_hinges)

    sp = sub.add_parser("single-strand", aliases=["norevcomp"])
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("--mode", choices=["even", "first"], default="even")
    sp.set_defaults(func=cmd_single_strand)

    sp = sub.add_parser("assemble")
    sp.add_argument("--fasta", default="")
    sp.add_argument("--paf", default="")
    sp.add_argument("--db", default="")
    sp.add_argument("--las", default="")
    sp.add_argument("--config", "-c", default="")
    sp.add_argument("--workdir", "-w", default=".")
    sp.add_argument("--nanopore", action="store_true")
    sp.add_argument("--norevcomp", action="store_true")
    sp.add_argument("--trace", default="",
                    help="write a JAX profiler (Perfetto) trace to this dir")
    sp.add_argument("--timings", action="store_true",
                    help="print per-stage wall times at the end")
    sp.set_defaults(func=cmd_assemble)

    sp = sub.add_parser(
        "sweep", help="accuracy sweep over simulated genomes (repeat "
        "structure x coverage x read length) -> JSON+markdown report")
    sp.add_argument("--genome-len", type=int, default=400_000)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out", default="accuracy_sweep",
                    help="output prefix (<out>.json, <out>.md)")
    sp.add_argument("--no-ref-parity", action="store_true",
                    help="skip the per-profile reference-binary parity "
                    "column (needs the refbuild toolchain)")
    sp.set_defaults(func=cmd_sweep)

    args = ap.parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
