"""The port's twins of ``examples/quickstart.py``, ``scenario_fleet.py``,
``expert_placement.py`` and ``serve_lm.py`` (``repro_torch.examples``) on
the CPU at a tiny budget, against the reference scripts run at the same
budget (their training calls cut down in place): the same lines, numbers
aside, and the same numbers where no draw enters them (the topology, the
Storm default and round-robin latencies, the detected stragglers, the
served requests' lengths)."""
import importlib.util
import pathlib
import re
import sys

import numpy as np
import pytest

from test_torch_parity import torch

from repro_torch.examples import expert_placement, quickstart, scenario_fleet, serve_lm


def _reference(name: str):
    """The reference script ``examples/<name>.py``, loaded from its file."""
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jquick, jexpert, jfleet, jserve = (_reference(n) for n in (
    "quickstart", "expert_placement", "scenario_fleet", "serve_lm"))

TINY = dict(offline_samples=30, offline_updates=5, epochs=6)
NUMBER = re.compile(r"[+-]?\d+(\.\d+)?")


def _cut(monkeypatch, module, **budget):
    """Run ``module``'s offline pretraining and online run at ``budget``."""
    def small(fn, **kw):
        return lambda *a, **k: fn(*a, **{**k, **kw})
    monkeypatch.setattr(module, "offline_pretrain", small(
        module.offline_pretrain, n_samples=budget["offline_samples"],
        n_updates=budget["offline_updates"]))
    monkeypatch.setattr(module, "run_online_agent", small(
        module.run_online_agent, T=budget["epochs"]))


def _lines(text: str) -> list[str]:
    """The printed lines with every number masked."""
    return [NUMBER.sub("#", line) for line in text.splitlines()]


def _value(text: str, label: str) -> str:
    line = next(x for x in text.splitlines() if x.startswith(label))
    return line[len(label):]


def test_quickstart_prints_the_references_lines(monkeypatch, capsys):
    _cut(monkeypatch, jquick, **TINY)
    jquick.main()
    want = capsys.readouterr().out
    res = quickstart.run(**TINY, device="cpu")
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    # the topology and the Storm default's latency draw nothing
    assert got.split("offline")[0] == want.split("offline")[0]
    assert (_value(got, "Storm default scheduler :")
            == _value(want, "Storm default scheduler :"))
    hist = res["history"]
    assert hist.rewards.shape == (TINY["epochs"],)
    assert hist.final_assignment.shape == (20, 10)
    assert np.array_equal(hist.final_assignment.sum(-1), np.ones(20))
    assert np.isfinite(res["learned"]) and res["learned"] > 0


def test_expert_placement_prints_the_references_lines(monkeypatch, capsys):
    _cut(monkeypatch, jexpert, **TINY)
    jexpert.main()
    want = capsys.readouterr().out
    res = expert_placement.run(**TINY, device="cpu")
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    for label in ("placing", "round-robin placement :", "detected stragglers:"):
        assert _value(got, label) == _value(want, label)
    assert res["stragglers"] == [5]
    X = res["reassignment"]
    assert X.shape == (16, 16) and (X.sum(-1) == 1).all()
    assert 0 <= res["moved"] <= 16 and np.isfinite(res["after"])


def test_scenario_fleet_prints_the_references_lines(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["scenario_fleet.py", "--fleet", "3",
                                      "--epochs", "4"])
    jfleet.main()
    want = capsys.readouterr().out
    res = scenario_fleet.main(["--fleet", "3", "--epochs", "4", "--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    assert res["history"].latencies.shape == res["shifted"].latencies.shape == (3, 4)
    # the +50% shift raises every lane's mean latency
    assert (res["shifted"].latencies.mean(-1) > res["history"].latencies.mean(-1)).all()


def test_serve_lm_prints_the_references_lines_and_serves_every_request(capsys):
    jserve.main()
    want = capsys.readouterr().out
    res = serve_lm.run(device="cpu")
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    assert res["tokens"].shape == (4, 16) and res["tokens"].dtype == torch.int32
    done = res["done"]
    assert sorted(r.rid for r in done) == list(range(8))
    assert all(len(r.out) == 4 + r.rid % 3 for r in done)
    assert "served 8 requests with 3 slots" in got


@pytest.mark.parametrize("twin", [quickstart, expert_placement, scenario_fleet, serve_lm])
def test_twins_need_a_gpu_unless_asked_for_the_cpu(twin, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.run()
