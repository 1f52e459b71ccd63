"""The harness: BENCHMARK.json against the contract, discovery of a cell,
configuration, traffic mix, driver and per-layer metric by file name, the
result's line, the trace reduction, and the imports a run may hold."""
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness, tiny  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_benchmark_json_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[section]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    assert 1 <= cells <= 24
    assert sum(w["chips"] == 4 for w in bench["workloads"]) == 0
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_finds_its_files(bench):
    """Each cell's workload, configuration, traffic and driver file, each
    configuration used by a cell, each metric's reader, and each cell
    reporting setup_s, another end-to-end metric and a per-layer one."""
    e2e = {m["name"] for m in bench["end_to_end"]}
    used = set()
    for w in bench["workloads"]:
        c = harness.cell(w["name"], 1, device="cpu")
        assert c.workload["config"] == w["config"]
        assert c.workload["traffic"] == w["traffic"]
        assert c.config["name"] == w["config"]
        harness.driver(c.traffic["driver"])
        used.add(w["config"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        mine = {m["name"] for m in harness.cell_metrics(bench, w["name"],
                                                        "end_to_end")}
        assert "setup_s" in mine and len(mine & e2e) >= 2
        layer = harness.cell_metrics(bench, w["name"], "per_layer")
        assert layer and all(m["moves"] in mine for m in layer)
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert harness.load_json(ROOT / c["file"])["source"] == c["source"]
    for m in bench["per_layer"]:
        assert hasattr(harness.metric_reader(m["name"]), "read")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


DRIVER = '''
from perfbench import harness


class State:
    pass


def setup(cell):
    st = State()
    st.cell, st.done = cell, 0
    return st


def window(st, seconds):
    st.done = int(st.cell.traffic["units"])
    return {"window_s": 0.5, "units": st.done, "attempted": st.done,
            "failed": 0, "e2e": {"widgets_per_s": st.done / 0.5},
            "work": {"widgets": st.done}}


def outputs(st):
    return {"done": st.done}


def release(st):
    pass


def reference(st, dtype=None, program=None):
    return {"done": int(st.cell.traffic["units"])}


def check(st, out, ref):
    return [harness.Check("gap", abs(out["done"] - ref["done"]),
                          st.cell.limits["gap"])]
'''


def _throwaway(tmp_path: Path) -> Path:
    """A benchmark folder that holds one new cell, configuration, traffic
    mix, driver and per-layer metric, each a file of its own."""
    base = tmp_path / "bench"
    for d in ("configs", "traffic", "workloads", "drivers", "metrics",
              "roofline"):
        (base / d).mkdir(parents=True)
    (base / "roofline" / "h100.json").write_text(
        (harness.HERE / "roofline" / "h100.json").read_text())
    (base / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "source": "a test", "dtype": "float32",
         "reduced": []}))
    (base / "traffic" / "steady.json").write_text(json.dumps(
        {"driver": "toy", "units": 7}))
    (base / "workloads" / "toy.steady.json").write_text(json.dumps(
        {"config": "toy", "traffic": "steady", "trace_seconds": 1,
         "limits": {"gap": 0}}))
    (base / "drivers" / "toy.py").write_text(DRIVER)
    (base / "metrics" / "widget_ms.toy.py").write_text(
        "def read(ctx):\n    return 1e3 * ctx.main.window_s / "
        "ctx.main.work['widgets']\n")
    return base


def test_a_new_cell_is_found_by_file_name(tmp_path):
    base = _throwaway(tmp_path)
    c = harness.cell("toy.steady", 5, device="cpu", base=base)
    assert c.traffic["units"] == 7 and c.config["name"] == "toy"
    drv = harness.driver(c.traffic["driver"], base)
    st = drv.setup(c)
    win = drv.window(st, 0.5)
    ctx = harness.Context(c, harness.Window(win), base=base)
    assert harness.metric_reader("widget_ms.toy", base).read(ctx) == \
        pytest.approx(1e3 * 0.5 / 7)
    assert ctx.peaks["hbm_byte_per_s"] == 3.35e12


def test_result_line_of_a_new_cell(tmp_path):
    """A whole run of the throwaway cell, its files found by name, gives
    the contract's line: correct, attempted, failed, metrics, device, and
    the checks last."""
    base = _throwaway(tmp_path)
    run = tiny.run_module()
    bench = {"end_to_end": [
        {"name": "widgets_per_s", "unit": "1/s", "workloads": ["toy.steady"]},
        {"name": "setup_s", "unit": "s"}], "per_layer": [
        {"name": "widget_ms.toy", "unit": "ms",
         "workloads": ["toy.steady"]}]}
    c = harness.cell("toy.steady", 5, device="cpu", base=base)
    line = run.execute(c, 0.5, bench)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] == 7
    assert set(line["metrics"]) == {"widgets_per_s", "setup_s"}
    assert line["metrics"]["widgets_per_s"] == {"value": 14.0, "unit": "1/s"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"] == {"gap": {"value": 0, "limit": 0}}
    json.dumps(line)
    c.trace = True
    line = run.execute(c, 0.5, bench)
    assert line["metrics"] == {"widget_ms.toy": {
        "value": pytest.approx(1e3 * 0.5 / 7), "unit": "ms"}}


def test_trace_reduction():
    dev = [(0.0, 10.0, "void k1<float>(float*)"), (5.0, 20.0, "k2"),
           (40.0, 50.0, "k1<float>(float*)")]
    host = [(15.0, 60.0, "aten::add"), (25.0, 30.0, "aten::mul")]
    assert harness.busy_us(dev) == 30.0
    assert harness.idle_gaps(dev, 0.0, 60.0) == [(20.0, 40.0), (50.0, 60.0)]
    br = harness.breakdown(dev, host, 0.0, 60.0)
    assert br["device_ops"][0] == ["k1<float>", pytest.approx(20e-6)]
    assert dict(br["idle_gaps"]) == {"aten::add": pytest.approx(30e-6)}
    assert harness.kernel_seconds(dev, ("k2",)) == pytest.approx(15e-6)


def test_banned_modules_by_whole_top_level_name(monkeypatch):
    before = set(harness.banned_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike",
                        types.ModuleType("repro_torch_lookalike"))
    assert set(harness.banned_modules()) == before
    # names no real import makes, under banned top-level names (other
    # tests in this process may have loaded jax or repro themselves)
    probes = {"repro._perfbench_probe", "jaxlib._perfbench_probe"}
    for name in probes:
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(harness.banned_modules()) - before == probes


def test_a_run_imports_neither_jax_nor_the_jax_package():
    """Everything a run loads, in a process of its own: the harness, every
    driver, reference, reader and count, and the program they call."""
    code = (
        "import sys, importlib; sys.path[:0] = ['src', '.']\n"
        "from perfbench import harness, tiny\n"
        "import json\n"
        "b = harness.benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = harness.cell(w['name'], 1, device='cpu')\n"
        "    harness.driver(c.traffic['driver'])\n"
        "for m in b['per_layer']:\n"
        "    harness.metric_reader(m['name'])\n"
        "for f in sorted((harness.HERE / 'roofline').glob('*.py')):\n"
        "    harness.roofline(f.stem)\n"
        "tiny.run_module()\n"
        "import repro_torch.core.beam, repro_torch.serving, "
        "repro_torch.survival.deep, repro_torch.models\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & set(harness.BANNED)


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "appc-select-beam",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
