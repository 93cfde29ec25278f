"""Hinge-based repeat resolution on a long (unbridgeable) repeat.

A 25kb exact repeat much longer than any read: no read crosses it, so the
coverage-gradient hinges at its boundaries must survive the extension-kill
and connected-component filters (hinging.cpp:1262-1321, 1644-1675), and the
layout must emit hinged FORWARD_INTERNAL/BACKWARD_INTERNAL edges landing on
those hinges — HINGE's core mechanism (README.md:14-47 of the reference).
"""

import collections

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from hinge_tpu.config import nominal_config
from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.stages.clip import run_clip
from hinge_tpu.stages.filter import run_filter
from hinge_tpu.stages.layout import load_marked, run_layout
from hinge_tpu.stages.maximal import run_maximal


@pytest.fixture(scope="module")
def repeat_pipeline(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rep")
    p = SimParams(
        genome_len=300_000, coverage=50.0, mean_read_len=9000, std_read_len=4000,
        min_read_len=2000, repeats=((40_000, 180_000, 25_000),), seed=9,
    )
    genome, reads, rs, ov = simulate(p)
    cfg = nominal_config()
    prefix = str(tmp / "X")
    fres = run_filter(rs, [ov], cfg, out_prefix=prefix)
    eff_s = fres.maskvec[:, 0].astype(np.int32)
    eff_e = fres.maskvec[:, 1].astype(np.int32)
    mres = run_maximal(rs, [ov], cfg, eff_s, eff_e, out_prefix=prefix)
    lres = run_layout(
        rs, [ov], cfg, eff_s, eff_e, mres.active,
        load_marked(prefix + ".repeat.txt"), load_marked(prefix + ".hinges.txt"),
        out_prefix=prefix, filter_prefix=prefix,
    )
    return dict(prefix=prefix, fres=fres, lres=lres, cfg=cfg)


def test_hinges_called_at_boundaries(repeat_pipeline):
    fres = repeat_pipeline["fres"]
    n = sum(len(v) for v in fres.hinges.values())
    assert n > 50  # both boundaries, many supporting reads


def test_hinges_survive_filtering(repeat_pipeline):
    lres = repeat_pipeline["lres"]
    assert len(lres.hinge_list) >= 1


def test_layout_emits_hinged_edges(repeat_pipeline):
    lres = repeat_pipeline["lres"]
    hinged = [l for l in lres.edges_hinges2 if l.split()[5] in ("1", "-1")]
    assert len(hinged) >= 1
    # the hinge position field is a real coordinate, not -1
    for l in hinged:
        assert int(l.split()[6]) > 0


def test_clip_graph_has_repeat_structure(repeat_pipeline):
    out = run_clip(
        repeat_pipeline["prefix"] + ".edges.hinges",
        repeat_pipeline["prefix"] + ".hinge.list",
        "1", repeat_pipeline["cfg"], write_viz=False,
    )
    G2 = out["G2"]
    assert len(G2) > 0
    # a traversable graph: interior nodes are (1,1); the repeat pinch (if the
    # hinge edge survived pruning) shows as in- or out-degree 2 somewhere
    deg = collections.Counter((G2.in_degree(x), G2.out_degree(x)) for x in G2)
    assert deg[(1, 1)] > 0.8 * len(G2)
