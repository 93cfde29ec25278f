"""Config-profile paths: nanopore clip, telomere deletion, aggressive
pruning (the yeast_W303 profile: del_telomere=1, aggressive_pruning=1,
draft-path consumes G3 — demo/yeast_W303_demo)."""

import os

import numpy as np
import pytest

from hinge_tpu.config import Config
from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.stages.clip import run_clip
from hinge_tpu.stages.filter import run_filter
from hinge_tpu.stages.layout import load_marked, run_layout
from hinge_tpu.stages.maximal import run_maximal

YEAST_INI = """\
[filter]
length_threshold = 1000;
aln_threshold = 1000;
min_cov = 5;
cut_off = 300;
theta = 300;

[layout]
hinge_slack = 1000
min_connected_component_size = 8
del_telomere = 1
del_telomeres = 1
aggressive_pruning = 1

[draft]
tspace = 900;
edge_safe = 100;
min_cov = 10;

[consensus]
min_length = 4000;
"""


@pytest.fixture(scope="module")
def linear_pipeline(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("yeast")
    # linear genome -> real telomeres (coverage falls off at the ends)
    p = SimParams(genome_len=80_000, circular=False, coverage=20.0,
                  mean_read_len=6000, std_read_len=1500, seed=15)
    genome, reads, rs, ov = simulate(p)
    cfg = Config.from_ini(YEAST_INI, is_text=True)
    assert cfg.layout.del_telomeres and cfg.layout.aggressive_pruning
    prefix = str(tmp / "Y")
    fres = run_filter(rs, [ov], cfg, out_prefix=prefix)
    eff_s = fres.maskvec[:, 0].astype(np.int32)
    eff_e = fres.maskvec[:, 1].astype(np.int32)
    mres = run_maximal(rs, [ov], cfg, eff_s, eff_e, out_prefix=prefix)
    lres = run_layout(
        rs, [ov], cfg, eff_s, eff_e, mres.active,
        load_marked(prefix + ".repeat.txt"), load_marked(prefix + ".hinges.txt"),
        out_prefix=prefix, filter_prefix=prefix,
    )
    return dict(tmp=tmp, prefix=prefix, cfg=cfg, fres=fres, lres=lres, rs=rs)


def test_cov_flag_written(linear_pipeline):
    # del_telomere=1 -> cov.flag/self.flag emitted (filter.cpp:757-765)
    assert os.path.exists(linear_pipeline["prefix"] + ".cov.flag")
    assert os.path.exists(linear_pipeline["prefix"] + ".self.flag")


def test_aggressive_pruning_writes_g3(linear_pipeline):
    out = run_clip(
        linear_pipeline["prefix"] + ".edges.hinges",
        linear_pipeline["prefix"] + ".hinge.list",
        "1", linear_pipeline["cfg"], write_viz=False,
    )
    assert "G3" in out
    assert os.path.exists(linear_pipeline["prefix"] + "1.G3.graphml")
    # linear genome: G3 should be two mirror simple paths
    G3 = out["G3"]
    from hinge_tpu.graph.digraph import weakly_connected_components

    comps = list(weakly_connected_components(G3))
    assert len(comps) >= 2


def test_nanopore_clip_uses_wider_thresholds(tmp_path, linear_pipeline):
    """clip-nanopore always uses bubble(20)+dead_end(20)
    (pruning_and_clipping_nanopore.py:1466-67)."""
    from hinge_tpu.config import nominal_config

    out = run_clip(
        linear_pipeline["prefix"] + ".edges.hinges",
        linear_pipeline["prefix"] + ".hinge.list",
        "2", nominal_config(), nanopore=True, write_viz=False,
    )
    assert os.path.exists(linear_pipeline["prefix"] + "2.G2.graphml")
    assert len(out["G2"]) > 0
