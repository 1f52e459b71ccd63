"""The port's launch counts under threads, and obs/profile.py's
torch.profiler capture under $REPRO_PROFILE_DIR."""
import json
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.obs import events, profile  # noqa: E402


def test_launch_counts_lose_nothing_across_threads():
    """Eight threads count 10,000 launches each through the helper every
    wrapper calls after its launch: ops reads every one of them."""
    ops.reset_launch_counts()
    start = threading.Barrier(8)

    def count():
        start.wait(60.0)
        for _ in range(10_000):
            _build.LAUNCHES.add("survival_curves")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # switch threads as often as possible
    try:
        threads = [threading.Thread(target=count) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    counts = ops.launch_counts()
    assert counts["survival_curves"] == 80_000
    assert sum(counts.values()) == 80_000
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.fixture
def sink(tmp_path):
    """The event sink, pointed at a file of the test's own."""
    path = tmp_path / "events.jsonl"
    events.configure(str(path))
    try:
        yield path
    finally:
        events.configure(None)


def test_maybe_profile_is_a_noop_without_the_env_var(sink, monkeypatch,
                                                     tmp_path):
    monkeypatch.delenv(profile.ENV_VAR, raising=False)
    with profile.maybe_profile("serve"):
        torch.ones(4).sum()
    assert events.read_jsonl(str(sink)) == []
    assert not (tmp_path / "serve").exists()


def test_maybe_profile_writes_a_trace_and_emits_capture(sink, monkeypatch,
                                                        tmp_path):
    base = tmp_path / "profiles"
    monkeypatch.setenv(profile.ENV_VAR, str(base))
    with profile.maybe_profile("serve/b 64"):
        (torch.arange(64.0) * 2).sum()
    target = base / "serve" / "b_64"
    trace = target / profile.TRACE_FILE
    assert trace.is_file()
    assert "traceEvents" in json.loads(trace.read_text())
    recs = events.read_jsonl(str(sink))
    assert [r["kind"] for r in recs] == ["profile.capture"]
    assert recs[0]["dir"] == str(target) and recs[0]["file"] == str(trace)


def test_maybe_profile_degrades_to_an_error_event(sink, monkeypatch,
                                                  tmp_path):
    def refuse(*args, **kwargs):
        raise RuntimeError("profiler busy")

    monkeypatch.setenv(profile.ENV_VAR, str(tmp_path / "profiles"))
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    ran = []
    with profile.maybe_profile("serve"):
        ran.append(True)
    assert ran == [True]
    recs = events.read_jsonl(str(sink))
    assert [r["kind"] for r in recs] == ["profile.error"]
    assert "profiler busy" in recs[0]["error"]


def test_maybe_profile_lets_the_block_raise(sink, monkeypatch, tmp_path):
    monkeypatch.setenv(profile.ENV_VAR, str(tmp_path / "profiles"))
    with pytest.raises(ValueError, match="the block's own"):
        with profile.maybe_profile("serve"):
            raise ValueError("the block's own")
    assert [r["kind"] for r in events.read_jsonl(str(sink))] == [
        "profile.capture"]
