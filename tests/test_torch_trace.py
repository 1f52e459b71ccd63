"""The port's spans (``obs/trace.py`` through ``obs/events.JsonlSink``):
records held in memory until a flush, a full buffer written out, each
record's start, the spans as torch.profiler annotations only while a
profiler records, the card's time only where CUDA is initialised, the
shared no-op when tracing is off; and the spans at the port's layer
boundaries (a finetune's sweeps, the SSD mixer, a featurizer batch, the
engine's score)."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import report  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import beam, cox  # noqa: E402
from repro_torch.data.synthetic import make_tied_survival  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import events, trace  # noqa: E402
from repro_torch.serving import ScoringEngine, fit_survival_model  # noqa: E402
from repro_torch.survival import deep  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def sinks_off():
    """Both global sinks off for the test, and after it."""
    events.configure(None)
    trace.configure(None)
    yield
    events.configure(None)
    trace.configure(None)


@pytest.fixture
def spans(tmp_path, sinks_off):
    """Spans on into a file of the test's own; ``read()`` turns them off
    (writing out what is held) and returns the file's span records."""
    path = tmp_path / "spans.jsonl"
    trace.configure(str(path))

    class Spans:
        def __init__(self):
            self.path = path

        def lines(self):
            return [json.loads(s) for s in path.read_text().splitlines()]

        def read(self):
            trace.configure(None)
            return [r for r in self.lines() if r["kind"] == "span"]

    return Spans()


def _tree(recs):
    return {r["span_id"]: r for r in recs}


# ---------------------------------------------------------------------------
# the tracing module
# ---------------------------------------------------------------------------

def test_records_are_held_until_a_flush(spans):
    for i in range(5):
        with trace.span("held", i=i):
            trace.emit_span("held.retro", 1e-3)
    assert spans.lines() == []
    trace.flush()
    first = spans.lines()
    assert len(first) == 10
    with trace.span("after"):
        pass
    assert len(spans.lines()) == 10
    recs = spans.read()
    assert [r["name"] for r in recs[10:]] == ["after"]
    ids = [r["span_id"] for r in recs]
    assert len(recs) == 11 and len(set(ids)) == 11
    assert [r["attrs"]["i"] for r in recs if r["name"] == "held"] == \
        list(range(5))


def test_a_full_buffer_is_written_out(tmp_path, sinks_off, monkeypatch):
    monkeypatch.setattr(events, "BUFFER", 8)
    path = tmp_path / "spans.jsonl"
    trace.configure(str(path))
    for _ in range(7):
        with trace.span("s"):
            pass
    assert path.read_text() == ""
    with trace.span("s"):
        pass
    assert len(path.read_text().splitlines()) == 8
    trace.configure(None)


class _Pending:
    """A record's pending device time, ready or not."""

    def __init__(self, ready):
        self.is_ready = ready

    def ready(self):
        return self.is_ready

    def finish(self, rec):
        rec["done"] = True


def test_a_full_buffer_waits_only_at_twice_its_size(tmp_path, monkeypatch):
    """A record whose device time is not ready holds back itself and what
    follows it, until twice the buffer is held."""
    monkeypatch.setattr(events, "BUFFER", 4)
    path = tmp_path / "sink.jsonl"
    sink = events.JsonlSink(str(path))
    sink.defer({"n": 0}, _Pending(True))
    sink.defer({"n": 1}, _Pending(False))
    for n in range(2, 4):
        sink.defer({"n": n})
    # the first is ready and written; the second holds the rest back
    assert [json.loads(s) for s in path.read_text().splitlines()] == \
        [{"n": 0, "done": True}]
    for n in range(4, 9):
        sink.defer({"n": n})
    got = [json.loads(s) for s in path.read_text().splitlines()]
    assert [r["n"] for r in got] == list(range(9))
    assert got[1]["done"] is True
    sink.close()


def test_start_and_parent_place_a_child_inside_its_parent(spans):
    with trace.span("parent"):
        with trace.span("child"):
            sum(range(1000))
        with trace.span("child2"):
            pass
    recs = spans.read()
    by_name = {r["name"]: r for r in recs}
    parent = by_name["parent"]
    for name in ("child", "child2"):
        c = by_name[name]
        assert c["parent_id"] == parent["span_id"]
        assert c["trace_id"] == parent["trace_id"]
        assert parent["start_s"] <= c["start_s"]
        assert c["start_s"] + c["dur_s"] <= \
            parent["start_s"] + parent["dur_s"]
    assert by_name["child"]["start_s"] + by_name["child"]["dur_s"] <= \
        by_name["child2"]["start_s"]


def test_emit_span_ends_now(spans):
    with trace.span("root"):
        trace.emit_span("waited", 0.5, rid=3)
    recs = _tree(spans.read())
    waited = next(r for r in recs.values() if r["name"] == "waited")
    root = recs[waited["parent_id"]]
    assert waited["dur_s"] == 0.5 and waited["attrs"] == {"rid": 3}
    assert waited["start_s"] + 0.5 >= root["start_s"]


def test_a_span_under_the_profiler_is_a_user_annotation(spans, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("layer.work"):
            y = x.add(1.0).mul(2.0)
    assert float(y.sum()) == 1024.0
    out = tmp_path / "chrome.json"
    prof.export_chrome_trace(str(out))
    evs = [e for e in json.loads(out.read_text())["traceEvents"]
           if e.get("ph") == "X"]
    marks = [e for e in evs if e.get("cat") == "user_annotation"
             and e["name"] == "layer.work"]
    assert len(marks) == 1
    a, b = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    ops_ = [e for e in evs if e.get("cat") == "cpu_op"
            and e["name"] in ("aten::add", "aten::mul")]
    assert len(ops_) == 2
    assert all(a <= e["ts"] and e["ts"] + e["dur"] <= b for e in ops_)
    assert [r["name"] for r in spans.read()] == ["layer.work"]


def test_no_profiler_makes_no_annotation(spans, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("quiet"):
        with trace.span("quiet.child", device_time=True):
            pass
    assert [r["name"] for r in spans.read()] == ["quiet.child", "quiet"]


def test_device_time_on_the_cpu_writes_no_dev_s(spans, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA event made without CUDA")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.cuda.is_initialized()
    with trace.span("cpu.work", device_time=True):
        pass
    (rec,) = spans.read()
    assert "dev_s" not in rec


class _FakeEvent:
    """A timing event on a fake card: the clock is a counter of records."""

    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self):
        _FakeEvent.clock += 2.5
        self.at = _FakeEvent.clock

    def query(self):
        return self.at is not None

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return end.at - self.at      # milliseconds


def test_device_time_is_read_at_write_out(spans, monkeypatch):
    """With CUDA initialised, the span records an event at entry and at
    exit, and its record gets their elapsed time once written out."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    with trace.span("card.outer", device_time=True):
        with trace.span("card.inner", device_time=True):
            pass
        with trace.span("host.only"):
            pass
    recs = {r["name"]: r for r in spans.read()}
    # inner: one record between its events; outer: inner's two and its own
    assert recs["card.inner"]["dev_s"] == pytest.approx(2.5e-3)
    assert recs["card.outer"]["dev_s"] == pytest.approx(7.5e-3)
    assert "dev_s" not in recs["host.only"]


def test_the_off_path_returns_the_shared_noop(sinks_off, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("made on the off path")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        sp = trace.span("off", device_time=True, x=1)
        assert sp is trace._NOOP and sp is trace.span("other")
        with sp as s:
            assert s.set(y=2) is sp
    assert not trace.enabled()
    trace.emit_span("off.retro", 0.1)
    trace.flush()


def test_spans_held_at_exit_are_written(tmp_path):
    path = tmp_path / "exit.jsonl"
    code = ("import sys; sys.path[:0] = ['src']\n"
            "from repro_torch.obs import trace\n"
            f"trace.configure({str(path)!r})\n"
            "for i in range(3):\n"
            "    with trace.span('at.exit', i=i):\n"
            "        pass\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    recs = [json.loads(s) for s in path.read_text().splitlines()]
    assert [r["attrs"]["i"] for r in recs] == [0, 1, 2]


def test_spans_reach_the_shared_event_sink(tmp_path, sinks_off):
    """Without a span file, spans go to the event sink, held as there;
    ``trace.configure(None)`` writes them out."""
    path = tmp_path / "events.jsonl"
    events.configure(str(path))
    events.emit("first")
    with trace.span("to.events"):
        pass
    assert [r["kind"] for r in events.read_jsonl(str(path))] == ["first"]
    trace.configure(None)
    assert [r["kind"] for r in events.read_jsonl(str(path))] == \
        ["first", "span"]


# ---------------------------------------------------------------------------
# the layer boundaries
# ---------------------------------------------------------------------------

def test_finetune_steps_count_the_coordinate_steps(spans):
    """A search's ``finetune.sweeps`` steps sum to its ``cox_coord``
    dispatches (the plain route on the CPU)."""
    x, t, delta = make_tied_survival(n=120, p=9, seed=3)
    data = cox.prepare(x, t, delta, device="cpu")
    before = ops._M_DISPATCH.value(kernel="cox_coord", route="plain")
    beam.beam_search(data, k=3, beam_width=2, n_expand=3,
                     finetune_sweeps=4, device="cpu")
    coords = ops._M_DISPATCH.value(kernel="cox_coord",
                                   route="plain") - before
    recs = spans.read()
    sweeps = [r for r in recs if r["name"] == "finetune.sweeps"]
    assert sweeps and sum(r["attrs"]["steps"] for r in sweeps) == coords
    finetunes = {r["span_id"]: r for r in recs
                 if r["name"] == "beam.finetune"}
    assert all(r["parent_id"] in finetunes for r in sweeps)
    # the candidates of a size are finetuned in one batched call
    assert len(sweeps) == len(finetunes)
    assert sum(r["attrs"]["candidates"] for r in sweeps) == \
        sum(r["attrs"]["n_candidates"] for r in finetunes.values())


@pytest.mark.parametrize("use_kernel", [True, False])
def test_finetune_sweeps_carry_candidates_and_their_steps(spans,
                                                          use_kernel):
    """Each ``finetune.sweeps`` span carries its ``candidates`` C and its
    ``steps`` C x size x sweeps: one span a support size through the
    kernels' entry (every candidate at once), one a candidate on the plain
    route."""
    x, t, delta = make_tied_survival(n=120, p=9, seed=3)
    data = cox.prepare(x, t, delta, device="cpu")
    res = beam.beam_search(data, k=3, beam_width=2, n_expand=3,
                           finetune_sweeps=4, use_kernel=use_kernel,
                           device="cpu")
    recs = spans.read()
    tree = _tree(recs)
    sizes = {r["span_id"]: r["attrs"]["size"] for r in recs
             if r["name"] == "beam.size"}
    n_cands = {}
    for r in recs:
        if r["name"] == "beam.finetune":
            n_cands[sizes[r["parent_id"]]] = r["attrs"]["n_candidates"]
    assert sorted(n_cands) == [1, 2, 3] and n_cands[1] == 3
    seen = dict.fromkeys(n_cands, 0)
    for r in recs:
        if r["name"] != "finetune.sweeps":
            continue
        size = sizes[tree[r["parent_id"]]["parent_id"]]
        c = r["attrs"]["candidates"]
        assert c == (n_cands[size] if use_kernel else 1)
        assert r["attrs"]["steps"] == c * size * 4
        seen[size] += c
    assert seen == n_cands
    assert [len(s) for s in res.supports] == [1, 2, 3]


def test_a_featurizer_batch_holds_three_mixer_spans_a_layer(spans):
    cfg = reduced_config(get_config("mamba2-130m"))
    model = build_model(cfg, device="cpu")
    deep.init_state(model, 0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    risk, feats = deep.make_featurizer(model)({"tokens": tokens})
    assert risk.shape == (2,) and feats.shape == (2, cfg.d_model)
    recs = spans.read()
    (batch,) = [r for r in recs if r["name"] == "featurize.batch"]
    assert batch["attrs"] == {"tokens": 32} and batch["parent_id"] is None
    mixer = [r for r in recs if r["name"].startswith("ssm.")]
    assert len(mixer) == 3 * cfg.n_layers
    assert [r["name"] for r in mixer] == \
        ["ssm.in", "ssm.scan", "ssm.out"] * cfg.n_layers
    assert all(r["parent_id"] == batch["span_id"] for r in mixer)
    assert not any("dev_s" in r for r in recs)


def test_the_engine_row_of_the_latency_table(spans):
    x, t, delta = make_tied_survival(n=120, p=6, seed=1)
    beta = np.linspace(-0.3, 0.3, 6).astype(np.float32)
    engine = ScoringEngine(fit_survival_model(x, t, delta, beta,
                                              device="cpu"), device="cpu")
    engine.score(x[:5])
    engine.risk_scores(x[:3])
    recs = spans.read()
    assert [r["name"] for r in recs] == ["engine.score"] * 2
    assert not any("dev_s" in r for r in recs)
    table = report.latency_breakdown_table(str(spans.path))
    assert "| engine.score | 2 |" in table


def test_ids_are_unique_without_a_system_call_a_span(spans, monkeypatch):
    """Ids are this process's prefix and a count: 16 hex digits, unique,
    with no ``os.urandom`` once the prefix is drawn."""
    trace.new_trace_id()

    def refuse(n):
        raise AssertionError("os.urandom called for a span id")

    monkeypatch.setattr(trace.os, "urandom", refuse)
    for _ in range(50):
        with trace.span("id.root"):
            with trace.span("id.child"):
                pass
    ids = [r["span_id"] for r in spans.read()] + [trace.new_trace_id()]
    assert len(set(ids)) == len(ids) == 101
    assert all(len(i) == 16 and int(i, 16) >= 0 for i in ids)
    assert len({i[:8] for i in ids}) == 1
