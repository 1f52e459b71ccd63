"""The roofline counts give PERF.md's kernel table's bounds at its shapes,
and a hand count of mamba2-130m's forward operations a token."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness  # noqa: E402

PEAKS = harness.peaks()


@pytest.mark.parametrize("name,shape,us", [
    ("cox_coord", {"n": 262144}, 1.25),
    ("revcumsum", {"n": 262144, "m": 256}, 160.26),
    ("revcumsum", {"n": 65536, "m": 1000}, 156.50),
    ("revcumsum", {"n": 65536}, 0.157),
])
def test_kernel_bounds_match_the_kernel_table(name, shape, us):
    got = harness.roofline(name).bound_s(PEAKS, **shape) * 1e6
    assert round(got, 3 if us < 1 else 2) == us


def test_mamba2_130m_forward_flops_by_hand():
    cfg = harness.load_json(harness.HERE / "configs" / "mamba2-130m.json")
    d, di, n, h = 768, 1536, 128, 24
    layer = (2 * d * (2 * di + 2 * n + h)   # in projection: 5,148,672
             + 2 * 4 * (di + 2 * n)         # conv: 14,336
             + 5 * di * n                   # SSD recurrence: 983,040
             + 8 * di                       # skip, gate, gated norm
             + 2 * di * d                   # out projection: 2,359,296
             + 4 * d)                       # layer norm
    assert layer == 8_520_704
    want = 24 * layer + 5 * d
    assert want == 204_500_736
    assert harness.roofline("mamba2_forward").flops_per_token(cfg) == want


def test_fit_and_search_counts():
    bs = harness.roofline("beam_search")
    # a coordinate: 5 float32 vectors of n at 3.35 TB/s
    assert bs.coordinate_s(PEAKS, 262144) == pytest.approx(
        5 * 262144 * 4 / 3.35e12)
    assert bs.finetune_s(PEAKS, 262144, 3, 60) == pytest.approx(
        180 * bs.coordinate_s(PEAKS, 262144)
        + (262144 * 3 + 2 * 262144 + 6) * 4 / 3.35e12)
    assert bs.scans_bytes(262144, 1000, 4) == 9 * 2 * 262144 * 1000 * 4
    assert bs.score_s(PEAKS, 262144, 1000, 4) == pytest.approx(
        5 * (262144 * 1000 + 3 * 262144) * 4 / 3.35e12)
