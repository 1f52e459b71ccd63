"""The per-layer metrics that read the program's own spans: a traced run
of each cell on the CPU at a test's sizes (the span metrics read there,
the device-trace ones are absent), and the idle time inside annotations
and the device time a unit on hand-made traces and spans."""
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness, spans, tiny  # noqa: E402

NEW = ("coord_step_us.select", "finetune_idle_pct.select",
       "score_idle_pct.select", "ssd_scan_ms.featurize",
       "ssm_proj_ms.featurize")


@pytest.mark.parametrize("name", ("appc-select-beam",
                                  "mamba2-featurize-512"))
def test_a_traced_cpu_run_reads_the_span_metrics(name):
    bench = harness.benchmark()
    c = tiny.cell(name)
    c.trace = True
    line = tiny.run_module().execute(c, 0.3, bench)
    assert line["correct"], line["checks"]
    got = {m: line["metrics"][m]["value"] for m in NEW
           if m in line["metrics"]}
    if name == "appc-select-beam":
        assert set(got) == {"coord_step_us.select"}
        assert math.isfinite(got["coord_step_us.select"])
        assert got["coord_step_us.select"] > 0
    else:
        # no device trace and no card's time on the CPU
        assert got == {}


class _Profile:
    def __init__(self, dev, host, window_us):
        self.dev = sorted(dev)
        self.host = sorted(host)
        self.window_us = window_us


def test_idle_inside_annotations():
    dev = [(0.0, 10.0, "k"), (12.0, 30.0, "k"), (5.0, 11.0, "k"),
           (50.0, 55.0, "k"), (58.0, 90.0, "long")]
    host = [(2.0, 20.0, "beam.score"), (40.0, 60.0, "beam.score"),
            (45.0, 50.0, "beam.score"),      # nested: counted once
            (20.0, 40.0, "beam.finetune"), (0.0, 100.0, "aten::add")]
    prof = _Profile(dev, host, (0.0, 70.0))
    # score: [2, 20] idle 11-12 (1 us); [40, 60] idle 40-50, 55-58 (13 us)
    assert spans.idle_inside(prof, "beam.score") == (14.0, 38.0)
    assert spans.idle_pct_inside(prof, "beam.score") == \
        pytest.approx(100 * 14 / 38)
    assert spans.idle_pct_inside(prof, "beam.finetune") == \
        pytest.approx(100 * 10 / 20)
    assert spans.idle_inside(prof, "beam.search") is None
    assert spans.idle_pct_inside(None, "beam.score") is None
    # clipped to the window
    assert spans.idle_inside(_Profile(dev, host, (0.0, 45.0)),
                             "beam.score") == (6.0, 23.0)


def test_device_time_a_unit():
    def rec(name, dev_s=None):
        r = {"name": name, "dur_s": 1.0}
        if dev_s is not None:
            r["dev_s"] = dev_s
        return r

    recs = [rec("featurize.batch", 1.0), rec("ssm.in", 0.1),
            rec("ssm.scan", 0.3), rec("ssm.out", 0.2),
            rec("featurize.batch", 1.0), rec("ssm.in", 0.1),
            rec("ssm.scan", 0.5), rec("ssm.out", 0.2)]
    w = harness.Window({"window_s": 2.0}, recs)
    assert spans.dev_ms_per(w, ("ssm.scan",), "featurize.batch") == \
        pytest.approx(400.0)
    assert spans.dev_ms_per(w, ("ssm.in", "ssm.out"),
                            "featurize.batch") == pytest.approx(300.0)
    recs[2] = rec("ssm.scan")
    w = harness.Window({"window_s": 2.0}, recs)
    assert spans.dev_ms_per(w, ("ssm.scan",), "featurize.batch") is None
    assert spans.dev_ms_per(harness.Window({"window_s": 1.0}),
                            ("ssm.scan",), "featurize.batch") is None
