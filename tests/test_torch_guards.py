"""The port's runtime guards (repro_torch.diagnostics): the non-finite sweep
against the reference's on converted states, the sweep at the fleet
runners' chunk boundaries, the sync-debug mode's nesting and restore, and
the counting of synchronizing calls by site.  The guards on the card
(``"disallow"`` raising, ``"log"`` counting real syncs) are in
tests/test_torch_cuda.py."""
import importlib
import re
import sys
import warnings

import jax
import numpy as np
import pytest

from test_torch_parity import carried_fleet, cfg_pair, env_pair, torch

from repro.diagnostics import NonFiniteError as JNonFiniteError
from repro.diagnostics import guards as jguards
from repro.diagnostics import maybe_check_finite as jmaybe_check_finite
from repro_torch.checkpoint import FleetCheckpoint
from repro_torch.core import make_agent, run_online_fleet
from repro_torch.diagnostics import (NonFiniteError, active, guards, lifted,
                                     maybe_check_finite, steady)
from repro_torch.fleet import StopRule, run_online_fleet_elastic

guards_mod = importlib.import_module("repro_torch.diagnostics.guards")


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------
def test_the_sweep_is_a_noop_outside_a_region():
    tree = {"x": torch.tensor([float("nan")]), "y": torch.tensor([float("inf")])}
    maybe_check_finite(tree, "nowhere")                     # no region
    with guards(nan_check=False):
        maybe_check_finite(tree, "unarmed")                 # region, no sweep
    with guards() as g:
        with pytest.raises(NonFiniteError, match="x .1/1 non-finite.; y"):
            maybe_check_finite(tree, "epoch 7")
    assert g.nonfinite == ["epoch 7: x (1/1 non-finite)",
                           "epoch 7: y (1/1 non-finite)"]
    with guards():                                          # ints never trip it
        maybe_check_finite({"i": torch.arange(3)}, "ints")
    assert active() is None


def _names(message: str) -> list[tuple[str, str]]:
    """(leaf name, count) pairs of a NonFiniteError's message, the
    reference's ``[0].critic.weights[1]`` written as ``0.critic.weights.1``."""
    body = message.split(": ", 1)[1]
    out = []
    for part in body.split("; "):
        name, count = re.fullmatch(r"(.*) \((\d+/\d+) non-finite\)", part).groups()
        name = name.replace("[", ".").replace("]", "").replace("'", "").lstrip(".")
        out.append((name, count))
    return out


def test_the_sweep_names_the_leaves_the_reference_names():
    """A DDPG fleet state converted from the reference's, with NaN and inf
    planted at the same places on both sides: both sweeps name the same
    leaves, in the same order, with the same counts."""
    jenv, _ = env_pair()
    jcfg, _ = cfg_pair(jenv, k_nn=4)
    js, ts = carried_fleet(jcfg, 2)
    js = jax.tree.map(np.array, js)
    js.critic.weights[1][1, 3, 5] = np.nan
    js.target_actor.biases[2][0, :4] = np.inf
    js.replay.rewards[1, 7] = -np.inf
    js.r_mean[1] = np.nan
    with torch.no_grad():
        ts.critic.weights[1][1, 3, 5] = float("nan")
        ts.target_actor.biases[2][0, :4] = float("inf")
        ts.replay.rewards[1, 7] = float("-inf")
        ts.r_mean[1] = float("nan")
    rewards = np.array([[0.5, np.nan, 1.0]], np.float32)
    with jguards(transfer="allow"), pytest.raises(JNonFiniteError) as jerr:
        jmaybe_check_finite((js, rewards), "epoch 4")
    with guards(transfer="allow"), pytest.raises(NonFiniteError) as terr:
        maybe_check_finite((ts, torch.as_tensor(rewards)), "epoch 4")
    want = _names(str(jerr.value))
    assert want == [("0.critic.weights.1", "1/4096"),
                    ("0.target_actor.biases.2", "4/400"),
                    ("0.replay.rewards", "1/2000"), ("0.r_mean", "1/2"),
                    ("1", "1/3")]
    assert _names(str(terr.value)) == want


class _Cadence:
    """A checkpoint stub: the chunk cadence, and the epochs it was asked to
    save."""

    def __init__(self, every):
        self.every, self.saved = every, []

    def save(self, epoch, *args, **kw):
        self.saved.append(epoch)


def _diverging(env):
    """Round-robin with a float [F] state multiplied by 10 each epoch from
    1e36: finite for 2 epochs, inf from the third on."""
    rr = make_agent("round_robin", env)
    return rr._replace(
        name="diverging",
        init_fn=lambda gen, cfg, fleet, device, params: torch.full((fleet,), 1e36),
        tick_fn=lambda cfg, state: state * 10.0)


@pytest.mark.parametrize("elastic", [False, True])
def test_the_runners_raise_at_the_chunk_boundary_of_a_divergence(elastic):
    """The carry overflows in epoch 3; cut every 2 epochs, the sweep after
    epoch 4 raises, before that chunk's save; outside a region the same
    run ends normally."""
    _, env = env_pair()
    agent = _diverging(env)

    def run(ck):
        states = agent.init_fleet(None, 2, "cpu")
        if elastic:
            return run_online_fleet_elastic(0, env, agent, states, 6,
                                            rule=StopRule(), checkpoint=ck)
        return run_online_fleet(0, env, agent, states, 6, checkpoint=ck)

    ck = _Cadence(2)
    with guards() as g, pytest.raises(NonFiniteError, match="epoch 4: 0 .2/2"):
        run(ck)
    assert ck.saved == [2]
    assert g.nonfinite == [f"run_online_fleet{'_elastic' if elastic else ''} "
                           "epoch 4: 0 (2/2 non-finite)"]
    assert g.steady_steps == 4
    ck = _Cadence(2)
    run(ck)
    assert ck.saved == [2, 4, 6]


def test_a_divergence_stops_a_real_checkpointed_run_before_its_save(tmp_path):
    _, env = env_pair()
    agent = _diverging(env)
    ck = FleetCheckpoint(tmp_path, every=2, use_async=False)
    with guards(transfer="log"), pytest.raises(NonFiniteError):
        run_online_fleet(0, env, agent, agent.init_fleet(None, 2, "cpu"), 6,
                         checkpoint=ck)
    assert ck.all_epochs() == [2]


# --------------------------------------------------------------------------
# the sync debug mode
# --------------------------------------------------------------------------
@pytest.fixture
def fake_mode(monkeypatch):
    """torch.cuda's sync debug mode as a plain integer, as on a machine
    with a card."""
    mode = [0]
    names = {"default": 0, "warn": 1, "error": 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(0, names[m]))
    return mode


def test_regions_nest_and_restore_the_mode(fake_mode):
    with guards(transfer="log") as outer:
        assert fake_mode == [1] and active() is outer
        with guards(transfer="disallow") as inner:
            assert fake_mode == [2] and active() is inner
            with lifted():
                assert fake_mode == [0]
                with steady(3):
                    assert fake_mode == [2]
                assert fake_mode == [0]
            assert fake_mode == [2] and inner.steady_steps == 3
        assert fake_mode == [1] and active() is outer
        with pytest.raises(KeyError):
            with guards(transfer="allow"):
                assert fake_mode == [0]
                raise KeyError("restored on the way out")
        assert fake_mode == [1]
        assert outer.steady_steps == 0
    assert fake_mode == [0] and active() is None
    with lifted(), steady():                # no region: nothing is touched
        assert fake_mode == [0]
    with pytest.raises(ValueError, match="transfer"):
        with guards(transfer="sometimes"):
            pass


def test_the_runners_arm_the_mode_over_the_epochs_alone(fake_mode):
    """Inside a region a runner lifts the mode for its own set-up and
    boundary work and re-arms it for each chunk's epochs, which it counts."""
    _, env = env_pair()
    rr = make_agent("round_robin", env)
    seen = []
    probe = rr._replace(tick_fn=lambda cfg, s: seen.append(fake_mode[0]) or s + 1)
    ck = _Cadence(2)
    ck.save = lambda epoch, *a, **k: seen.append(("save", fake_mode[0]))
    with guards(transfer="log") as g:
        run_online_fleet(0, env, probe, probe.init_fleet(None, 2, "cpu"), 5,
                         checkpoint=ck)
        assert fake_mode == [1]
    assert seen == [1, 1, ("save", 0), 1, 1, ("save", 0), 1, ("save", 0)]
    assert g.steady_steps == 5 and fake_mode == [0]


def test_log_counts_every_sync_warning_by_site_and_passes_others_on():
    with guards(transfer="log") as g:
        line = sys._getframe().f_lineno + 2
        for _ in range(3):
            warnings.warn("called a synchronizing CUDA operation")
        with steady(2):
            pass
        with pytest.warns(UserWarning, match="something else"):
            warnings.warn("something else")
    site = f"test_torch_guards.py:{line}"
    assert dict(g.syncs) == {site: 3} and g.n_syncs == 3
    assert g.sync_report() == ("1.5 synchronizing calls per steady-state epoch "
                               f"(3 over 2): {site} ×3")
    # a sync raised inside torch's own Python code is put on its caller
    line, got = sys._getframe().f_lineno, guards_mod._site(torch.__file__, 1)
    assert got == f"test_torch_guards.py:{line}"
