"""Device (XLA) overlap join vs the native C oracle — bit parity.

The device join (overlap/device_join.py) must reproduce the production C
path (mapper._native_map_block + emit_records) record-for-record and
trace-byte-for-trace-byte: same minimizer set, same band selection and
tie-breaks, same greedy sub_gap thinning, same integer-exact trace
interpolation.  These tests force the device path on the CPU backend
(HINGE_DEVICE_JOIN=1) — XLA integer semantics are identical across
backends, so CPU parity here implies GPU parity."""

import numpy as np
import pytest

from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.overlap import device_join as DJ
from hinge_tpu.overlap import mapper as M


def _c_base_records(rs, **kw):
    """The production C half-pairs records (device path disabled)."""
    import os

    os.environ["HINGE_DEVICE_JOIN"] = "0"
    try:
        targets = [rs.get_bases(i) for i in range(rs.n_reads)]
        return M.map_reads_to_targets(targets, rs, half_pairs=True, **kw)
    finally:
        os.environ.pop("HINGE_DEVICE_JOIN", None)


def _assert_stores_equal(a, b):
    assert a.n == b.n, f"record count {a.n} != {b.n}"
    for f in ("a_id", "b_id", "a_len", "b_len", "a_start", "a_end",
              "b_start", "b_end", "rc", "tlen"):
        np.testing.assert_array_equal(
            getattr(a, f), getattr(b, f), err_msg=f"column {f}")
    np.testing.assert_array_equal(a.trace_off, b.trace_off)
    np.testing.assert_array_equal(a.trace, b.trace, err_msg="trace bytes")
    assert a.tspace == b.tspace


@pytest.fixture(scope="module")
def sim_mid():
    genome, reads, rs, ov = simulate(
        SimParams(genome_len=120_000, coverage=14, seed=11))
    return rs


def test_device_join_bit_parity(sim_mid, monkeypatch):
    rs = sim_mid
    ref = _c_base_records(rs)
    assert ref.n > 50, "oracle produced too few records to be meaningful"
    dev = DJ.overlap_base_records(rs)
    assert dev is not None, "device path unavailable (gates tripped?)"
    _assert_stores_equal(dev, ref)


def test_device_join_multi_block_parity(sim_mid):
    """Blocking must not change the record stream (order invariance)."""
    rs = sim_mid
    ref = _c_base_records(rs)
    total_x = 2 * int(rs.length.sum())
    dev = DJ.overlap_base_records(rs, block_bases=max(total_x // 5, 1 << 16))
    assert dev is not None
    _assert_stores_equal(dev, ref)


def test_overlap_reads_routes_device(sim_mid, monkeypatch):
    """overlap_reads end-to-end (dedup + mirrors) via the device join ==
    the C-path result byte-for-byte."""
    rs = sim_mid
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "0")
    ref = M.overlap_reads(rs)
    monkeypatch.setenv("HINGE_DEVICE_JOIN", "1")
    dev = M.overlap_reads(rs)
    _assert_stores_equal(dev, ref)


def test_gates_return_none():
    # reads shorter than k+w have no windows on the device layout
    rs_short = simulate(SimParams(genome_len=20_000, coverage=4, seed=1))[2]
    short = type(rs_short)(
        length=np.array([10, 12], np.int32),
        bases_off=np.array([0, 10, 22], np.int64),
        bases=np.zeros(22, np.uint8))
    assert DJ.overlap_base_records(short) is None


def test_repeat_workload_parity():
    """A repeat-heavy genome stresses big buckets + adjacent-band ties."""
    genome, reads, rs, ov = simulate(
        SimParams(genome_len=60_000, coverage=10, seed=5,
                  repeats=((5_000, 40_000, 6_000),)))
    ref = _c_base_records(rs)
    dev = DJ.overlap_base_records(rs)
    assert dev is not None
    _assert_stores_equal(dev, ref)
