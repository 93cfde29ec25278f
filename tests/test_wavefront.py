"""Device wavefront aligner (ops/wavefront.py) vs the scalar DW_banded
oracle (ops/myers.align_exact): byte-identical rows across fuzz + edge
cases.  Runs on the CPU backend in CI; the same jitted code runs on the
GPU."""

import numpy as np
import pytest

from hinge_tpu.ops import myers as MY
from hinge_tpu.ops.wavefront import align_exact_batch_device


def _make_pair(rng, n, err):
    t = rng.integers(0, 4, n).astype(np.uint8)
    q = []
    for b in t:
        r = rng.random()
        if r < err * 0.4:
            continue
        if r < err * 0.8:
            q.append(int(rng.integers(0, 4)))
        else:
            q.append(int(b))
        if rng.random() < err * 0.3:
            q.append(int(rng.integers(0, 4)))
    return np.array(q, np.uint8), t


def _check(qs, ts):
    got = align_exact_batch_device(qs, ts)
    for i, (q, t) in enumerate(zip(qs, ts)):
        qa, ta = MY.align_exact(q, t)
        np.testing.assert_array_equal(got[i][0], qa, err_msg=f"q row {i}")
        np.testing.assert_array_equal(got[i][1], ta, err_msg=f"t row {i}")


def test_fuzz_rows_match_oracle():
    rng = np.random.default_rng(11)
    pairs = [
        _make_pair(rng, int(rng.integers(40, 350)),
                   float(rng.uniform(0.02, 0.35)))
        for _ in range(48)
    ]
    _check([p[0] for p in pairs], [p[1] for p in pairs])


def test_edge_cases_match_oracle():
    rng = np.random.default_rng(5)
    t0 = rng.integers(0, 4, 300).astype(np.uint8)
    cases = [
        (t0.copy(), t0),  # identical: one giant snake
        (np.zeros(0, np.uint8), rng.integers(0, 4, 40).astype(np.uint8)),
        (rng.integers(0, 4, 40).astype(np.uint8), np.zeros(0, np.uint8)),
        (np.zeros(0, np.uint8), np.zeros(0, np.uint8)),
        # unrelated randoms: adaptive band overflow -> unaligned, empty rows
        (rng.integers(0, 4, 400).astype(np.uint8),
         rng.integers(0, 4, 400).astype(np.uint8)),
        (np.array([1], np.uint8), np.array([2], np.uint8)),
        # strongly asymmetric lengths
        (rng.integers(0, 4, 50).astype(np.uint8),
         rng.integers(0, 4, 300).astype(np.uint8)),
    ]
    _check([c[0] for c in cases], [c[1] for c in cases])


def test_mixed_size_bucketing():
    """Batches mixing tiny and big windows must route through size buckets
    and come back in input order."""
    rng = np.random.default_rng(9)
    sizes = [5, 300, 12, 250, 90, 7, 180]
    pairs = [_make_pair(rng, s, 0.15) for s in sizes]
    _check([p[0] for p in pairs], [p[1] for p in pairs])
