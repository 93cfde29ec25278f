"""Ground-truth mapping + graph annotation path."""

import json

import numpy as np

from hinge_tpu.config import nominal_config
from hinge_tpu.data.overlaps import INT, ReadStore
from hinge_tpu.graph.digraph import DiGraph
from hinge_tpu.graph.groundtruth import add_groundtruth, run_mapping


def _ref_store(genome):
    return ReadStore(
        length=np.array([len(genome)], dtype=INT),
        bases_off=np.array([0, len(genome)], dtype=np.int64),
        bases=genome,
        names=["ref"],
    )


def test_run_mapping_and_annotation(small_sim, tmp_path):
    rs = small_sim["read_store"]
    genome = small_sim["genome"]
    ref = _ref_store(genome)
    out = str(tmp_path / "X.mapping.json")
    mapping = run_mapping(rs, ref, out_json=out)
    # most reads should map to the single reference contig
    assert len(mapping) > 0.8 * rs.n_reads
    loaded = json.loads(open(out).read())
    any_read = next(iter(loaded))
    assert loaded[any_read][0][2] == 0  # chr index

    # annotate a small graph
    g = DiGraph()
    ids = sorted(int(k) for k in loaded.keys())[:4]
    for a, b in zip(ids, ids[1:]):
        g.add_edge(f"{a}_0", f"{b}_0")
        g.add_edge(f"{b}_1", f"{a}_1")
    add_groundtruth(g, loaded, set(), set())
    for n in g.nodes():
        assert "chr" in g.nodes[n] and "color" in g.nodes[n]
        assert g.nodes[n]["chr"] == 1
    for e in g.edges():
        assert "false_positive" in g.edges[e]


def test_clip_with_mapping_json(tmp_path, small_sim):
    """run_clip with mapping_json annotates nodes before pruning."""
    import numpy as np

    from hinge_tpu.stages.clip import run_clip
    from hinge_tpu.stages.filter import run_filter
    from hinge_tpu.stages.layout import load_marked, run_layout
    from hinge_tpu.stages.maximal import run_maximal

    rs, ov = small_sim["read_store"], small_sim["overlaps"]
    genome = small_sim["genome"]
    cfg = nominal_config()
    prefix = str(tmp_path / "gt")
    fres = run_filter(rs, [ov], cfg, out_prefix=prefix)
    eff_s = fres.maskvec[:, 0].astype(np.int32)
    eff_e = fres.maskvec[:, 1].astype(np.int32)
    mres = run_maximal(rs, [ov], cfg, eff_s, eff_e, out_prefix=prefix)
    run_layout(
        rs, [ov], cfg, eff_s, eff_e, mres.active,
        load_marked(prefix + ".repeat.txt"), load_marked(prefix + ".hinges.txt"),
        out_prefix=prefix, filter_prefix=prefix,
    )
    mapping_path = str(tmp_path / "gt.mapping.json")
    run_mapping(rs, _ref_store(genome), out_json=mapping_path)
    out = run_clip(
        prefix + ".edges.hinges", prefix + ".hinge.list", "1", cfg,
        write_viz=False, mapping_json=mapping_path,
    )
    g2 = out["G2"]
    annotated = [n for n in g2.nodes() if "chr" in g2.nodes[n]]
    assert len(annotated) == len(g2)
