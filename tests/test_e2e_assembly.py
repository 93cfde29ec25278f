"""Full-pipeline end-to-end: reads -> filter -> maximal -> layout -> clip ->
draft-path -> draft -> (map) -> consensus -> gfa, on a simulated circular
genome.  The decisive check: the assembled contig must reconstruct the
genome (a rotation of it, possibly reverse-complemented)."""

import os

import numpy as np
import pytest

from hinge_tpu.config import nominal_config
from hinge_tpu.data.overlaps import codes_to_str, revcomp_codes, str_to_codes
from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.stages.clip import run_clip
from hinge_tpu.stages.consensus import run_consensus
from hinge_tpu.stages.draft import run_draft
from hinge_tpu.stages.draft_path import run_draft_path
from hinge_tpu.stages.filter import run_filter
from hinge_tpu.stages.gfa import run_gfa
from hinge_tpu.stages.layout import load_marked, run_layout
from hinge_tpu.stages.maximal import run_maximal
from hinge_tpu.io.fasta import correct_head, write_fasta


@pytest.fixture(scope="module")
def assembly(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    p = SimParams(
        genome_len=50_000, coverage=18.0, mean_read_len=5000, std_read_len=1000,
        seed=21,
    )
    genome, reads, rs, ov = simulate(p)
    cfg = nominal_config()
    prefix = str(tmp / "eco")

    fres = run_filter(rs, [ov], cfg, out_prefix=prefix)
    eff_s = fres.maskvec[:, 0].astype(np.int32)
    eff_e = fres.maskvec[:, 1].astype(np.int32)
    mres = run_maximal(rs, [ov], cfg, eff_s, eff_e, out_prefix=prefix)
    run_layout(
        rs, [ov], cfg, eff_s, eff_e, mres.active,
        load_marked(prefix + ".repeat.txt"), load_marked(prefix + ".hinges.txt"),
        out_prefix=prefix, filter_prefix=prefix,
    )
    graphs = run_clip(prefix + ".edges.hinges", prefix + ".hinge.list", "1", cfg,
                      write_viz=False)
    lines, out_graph = run_draft_path(
        graphs["G2"], rs.length,
        out_edges_list=prefix + ".edges.list",
        out_graphml=prefix + "_draft.graphml",
    )
    contigs = run_draft(rs, [ov], cfg, mres.active, lines,
                        out_fasta=prefix + ".draft.fasta")
    return dict(
        tmp=tmp, genome=genome, rs=rs, ov=ov, cfg=cfg, prefix=prefix,
        mres=mres, edges_list=lines, contigs=contigs, graphs=graphs,
    )


def _is_rotation_of(contig: str, genome: str, probe=64):
    """contig should be a rotation slice of genome (fwd or rc) up to
    isolated single-base artifacts: the faithfully-replicated falcon.c
    backtrack quirk rewrites the LAST base of every multi-segment ladder
    consensus with the best column's link index (falcon.c:456-460), so even
    error-free reads yield ~1 mismatch per draft tspace (~900bp) ladder.
    Anchors the rotation with clean probes, then bounds the mismatch count
    by the possible artifact density."""
    # triple-tile so a circular-overhang contig (len > genome) still gets a
    # full-length comparison window from any rotation offset
    g3 = genome.upper() * 3
    grc = codes_to_str(revcomp_codes(str_to_codes(genome))).upper()
    g3rc = grc * 3
    c = contig.upper()
    budget = len(c) // 500 + 5  # >= one artifact per ladder, with slack
    for ref0, ref2 in ((genome.upper(), g3), (grc, g3rc)):
        for s in range(0, max(len(c) - probe, 1), 997):
            k = ref2.find(c[s : s + probe])
            if k < 0:
                continue
            start = (k - s) % len(ref0)
            window = ref2[start : start + len(c)]
            if len(window) < len(c):
                continue
            mism = sum(1 for a, b in zip(c, window) if a != b)
            if mism <= budget:
                return True
    return False


def test_draft_path_outputs(assembly):
    lines = assembly["edges_list"]
    assert any(l.startswith(">Unitig") for l in lines)
    tags = {l.split()[0] for l in lines if not l.startswith(">")}
    assert tags <= {"O", "D", "S", "T", "E"}
    # circular single contig: expect S, T..., E records
    assert os.path.exists(assembly["prefix"] + "_draft.graphml")


def test_draft_contig_reconstructs_genome(assembly):
    contigs = assembly["contigs"]
    assert len(contigs) >= 2  # contig + its reverse complement
    genome_str = codes_to_str(assembly["genome"])
    name, seq = max(contigs, key=lambda c: len(c[1]))
    # error-free reads: the draft must be a (near-)exact rotation slice
    assert len(seq) > 0.85 * len(genome_str), (len(seq), len(genome_str))
    assert _is_rotation_of(seq, genome_str), "draft does not match genome"


def test_consensus_polishes(assembly):
    from hinge_tpu.overlap.mapper import map_reads_to_targets

    rs = assembly["rs"]
    cfg = assembly["cfg"]
    contigs = assembly["contigs"]
    genome_str = codes_to_str(assembly["genome"])
    targets = [str_to_codes(seq) for _, seq in contigs]
    aln = map_reads_to_targets(targets, rs)
    assert aln.n > 0
    res = run_consensus(contigs, rs, aln, cfg,
                        out_fasta=assembly["prefix"] + ".consensus.fasta")
    assert len(res) == len(contigs)
    name, seq = max(res, key=lambda c: len(c[1]))
    assert len(seq) > 0.85 * len(genome_str)
    assert _is_rotation_of(seq, genome_str), "consensus does not match genome"


def test_gfa_output(assembly):
    prefix = assembly["prefix"]
    # correct-head produces the draft_map
    correct_head(prefix + ".draft.fasta", prefix + ".draft.pb.fasta",
                 str(assembly["tmp"] / "draft_map.txt"))
    if not os.path.exists(prefix + ".consensus.fasta"):
        pytest.skip("consensus test must run first")
    lines = run_gfa(
        prefix + "_draft.graphml",
        str(assembly["tmp"] / "draft_map.txt"),
        prefix + ".consensus.fasta",
        out_gfa=prefix + "_consensus.gfa",
    )
    assert lines[0] == "H\tVN:Z:1.0"
    s_lines = [l for l in lines if l.startswith("S\t")]
    assert len(s_lines) >= 1
    # every S line has a sequence
    for l in s_lines:
        assert len(l.split("\t")[2]) > 0


def test_consensus_emission_vectorized_matches_scalar():
    """The vectorized emission must reproduce consensus.cpp:231-269."""
    rng = np.random.default_rng(7)
    alen = 500
    scores = rng.integers(0, 10, (alen, 5)).astype(np.int32)
    cov = rng.integers(0, 12, alen).astype(np.int32)
    ins_score = rng.integers(0, 8, alen).astype(np.int32)
    ins_scores = rng.integers(0, 5, (alen, 5)).astype(np.int32)
    draft_text = "".join("ACGT"[c] for c in rng.integers(0, 4, alen))

    # scalar transcription
    out = []
    for j in range(alen):
        if cov[j] < 3:
            out.append(draft_text[j].lower())
            continue
        if ins_score[j] > cov[j] // 2:
            mi = 0
            for b in range(1, 4):
                if ins_scores[j][b] > ins_scores[j][mi]:
                    mi = b
            out.append("ACGT"[mi])
        mb = 0
        for b in range(1, 5):
            if scores[j][b] > scores[j][mb]:
                mb = b
        if mb < 4:
            out.append("ACGT"[mb])
    want = "".join(out)

    # vectorized emission (same code path as run_consensus)
    lowmask = cov < 3
    max_base = np.argmax(scores, axis=1)
    ins_emit = (ins_score > cov // 2) & ~lowmask
    max_ins = np.argmax(ins_scores[:, :4], axis=1)
    draft_bytes = np.frombuffer(draft_text.encode(), dtype=np.uint8)[:alen]
    upper = np.frombuffer(b"ACGT", dtype=np.uint8)
    to_lower = draft_bytes | 0x20
    col0 = np.where(ins_emit, upper[max_ins], 0).astype(np.uint8)
    base_byte = np.where(
        lowmask, to_lower,
        np.where(max_base < 4, upper[np.minimum(max_base, 3)], 0),
    ).astype(np.uint8)
    interleaved = np.empty(2 * alen, dtype=np.uint8)
    interleaved[0::2] = col0
    interleaved[1::2] = base_byte
    got = interleaved[interleaved != 0].tobytes().decode()
    assert got == want
