"""The paper's evaluation in the port (``repro_torch.figures``) against the
reference's ``benchmarks/paper_*.py`` and ``examples/drl_storm_control.py``
on the CPU, at a tiny budget, with the reference's draws replayed: its
initial states from ``init_fleet(PRNGKey(seed), F)`` carried across, the
online draws of ``split(PRNGKey(seed + 1 | seed + 2 | seed + 7), F)``, the
offline draws of ``split(PRNGKey(seed + 1), F)`` and the model-based fit's
of ``PRNGKey(seed)``.

The reference's pieces run once each (module fixture ``ref``); its
``compare_all`` and Fig 12 ``run`` are then called with those pieces
memoized, so that their own code composes the outputs the port is held
to."""
import json
import pathlib

import jax
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, jax_epoch_draws,
                               jax_fit_draws, jax_offline_draws,
                               jax_tree_numpy, to_torch, torch)

from benchmarks import paper_common as jpc
from benchmarks import paper_fig12 as jfig12
from repro.core import make_agent as jax_make_agent
from repro.core.agent import greedy_assignment_ddpg as jax_greedy_ddpg
from repro_torch.core import greedy_assignment_ddpg
from repro_torch.core.convert import ddpg_state_from_numpy, dqn_state_from_numpy
from repro_torch.figures import common, fig6, fig8_10, fig12, reward, storm_control

REPO = pathlib.Path(__file__).resolve().parents[1]
SEED = 0
APP = "cq_small"
# rewards, latencies and deployed latencies: the discrete choices are
# exact, and the simulator's float32 sums run in another order than XLA's
RTOL = 1e-5
# the model-based latency: the ridge solve is ill-conditioned (C4)
MB_RTOL = 1e-4


def tiny(cls):
    return cls(offline_samples=60, offline_updates=10, online_epochs=6,
               updates_per_epoch=2, mb_samples=60, k_nn=4, n_seeds=2)


TINY = tiny(common.Budget)
JTINY = tiny(jpc.Budget)
F, T, U = TINY.n_seeds, TINY.online_epochs, TINY.updates_per_epoch
T_SHIFT = max(T // 3, 40)


def _memoized(monkeypatch, module, env, pieces):
    """Point ``module``'s make_env and run_* at the reference pieces already
    run on ``env`` (each deterministic in its seed)."""
    monkeypatch.setattr(module, "make_env", lambda app: env)
    for name, value in pieces.items():
        monkeypatch.setattr(module, name,
                            lambda *a, value=value, **k: value)


@pytest.fixture(scope="module")
def ref():
    """The reference's pieces at the tiny budget on cq_small, its
    compare_all and its Fig 12 run composed from them."""
    env = jpc.make_env(APP)
    out = dict(env=env, default=jpc.run_default(env),
               model_based=jpc.run_model_based(env, JTINY, SEED),
               dqn=jpc.run_dqn(env, JTINY, SEED),
               ac=jpc.run_actor_critic(env, JTINY, SEED))
    with pytest.MonkeyPatch.context() as mp:
        _memoized(mp, jpc, env, {"run_model_based": out["model_based"],
                                 "run_dqn": out["dqn"],
                                 "run_actor_critic": out["ac"]})
        out["compare_all"] = jpc.compare_all(APP, JTINY, SEED, verbose=False)
        _memoized(mp, jfig12, env, {"run_model_based": out["model_based"],
                                    "run_actor_critic": out["ac"]})
        out["fig12"] = jfig12.run(APP, JTINY, SEED)
    return out


def _draws(jenv, jcfg, seed: int, T: int, epoch0: int = 0, size0: int = 0):
    return jax_epoch_draws(jax.random.split(jax.random.PRNGKey(seed), F), T=T,
                           U=U, B=jcfg.batch, N=jenv.N, M=jenv.M,
                           S=jenv.workload.num_spouts, eps=jcfg.eps,
                           epoch0=epoch0, size0=size0, cap=jcfg.buffer)


@pytest.fixture(scope="module")
def port(ref):
    """The port's pieces on the reference's draws."""
    jenv = ref["env"]
    env = common.make_env(APP, "cpu")
    A, Z = jax_fit_draws(jax.random.PRNGKey(SEED), TINY.mb_samples, jenv.N, jenv.M)
    out = dict(env=env, fit_draws=(A, Z), default=common.run_default(env),
               model_based=common.run_model_based(env, TINY, SEED,
                                                  assignments=A, meas_z=Z))
    # DQN: the reference's fresh lanes and online draws
    jagent = jax_make_agent("dqn", jenv, eps=jpc.EpsilonSchedule(
        decay_epochs=max(T * 2 // 3, 1)))
    js = jagent.init_fleet(jax.random.PRNGKey(SEED), F)
    out["dqn_draws"] = _draws(jenv, jagent.cfg, SEED + 1, T)
    out["dqn"] = common.run_dqn(
        env, TINY, SEED, states=dqn_state_from_numpy(jax_tree_numpy(js), "cpu"),
        draws=out["dqn_draws"])
    out["dqn_init"] = js
    # DDPG: fresh lanes, offline and online draws
    jagent = jax_make_agent("ddpg", jenv, k_nn=TINY.k_nn, eps=jpc.EpsilonSchedule(
        decay_epochs=max(T * 2 // 3, 1)))
    jcfg = jagent.cfg
    js = jagent.init_fleet(jax.random.PRNGKey(SEED), F)
    out["ac_offline_draws"] = jax_offline_draws(
        jax.random.split(jax.random.PRNGKey(SEED + 1), F), n=TINY.offline_samples,
        n_updates=TINY.offline_updates, B=jcfg.batch, N=jenv.N, M=jenv.M,
        S=jenv.workload.num_spouts, cap=jcfg.buffer)
    size0 = min(TINY.offline_samples, jcfg.buffer)
    out["ac_draws"] = _draws(jenv, jcfg, SEED + 2, T, size0=size0)
    out["ac_init"] = js
    out["ac"] = common.run_actor_critic(
        env, TINY, SEED, states=ddpg_state_from_numpy(jax_tree_numpy(js), "cpu"),
        draws=out["ac_draws"], offline_draws=out["ac_offline_draws"])
    out["shift_draws"] = _draws(jenv, jcfg, SEED + 7, T_SHIFT, epoch0=T,
                                size0=size0 + T)
    return out


def _assert_history(got, want):
    assert_exact(got.moved, want.moved)
    assert_exact(got.final_assignment, want.final_assignment)
    assert_f32(got.rewards, want.rewards, rtol=RTOL)
    assert_f32(got.latencies, want.latencies, rtol=RTOL)


# --------------------------------------------------------------------------
# the harness's pieces
# --------------------------------------------------------------------------
def test_run_model_based_matches_the_reference_on_its_fit_draws(ref, port):
    lat, X = port["model_based"]
    jlat, jX = ref["model_based"]
    assert_f32(lat, jlat, rtol=MB_RTOL)
    assert_exact(X, jX)
    assert_f32(port["default"], ref["default"], rtol=RTOL)


def test_run_dqn_matches_the_reference_on_its_draws(ref, port):
    lats, hist = port["dqn"]
    jlats, jhist = ref["dqn"]
    _assert_history(hist, jhist)
    assert hist.moved.sum() > 0
    assert len(lats) == F
    assert_f32(np.asarray(lats), np.asarray(jlats), rtol=RTOL)


def test_run_actor_critic_matches_the_reference_on_its_draws(ref, port):
    lats, hist, (states, cfg) = port["ac"]
    jlats, jhist, (jstates, jcfg) = ref["ac"]
    _assert_history(hist, jhist)
    assert hist.moved.sum() > 0
    assert (cfg.k_nn, cfg.eps.decay_epochs) == (jcfg.k_nn, jcfg.eps.decay_epochs)
    assert len(lats) == F
    assert_f32(np.asarray(lats), np.asarray(jlats), rtol=RTOL)
    assert_exact(states.epoch, jstates.epoch)


def test_deploy_false_returns_an_empty_list_and_the_same_history(ref, port):
    env = port["env"]
    lats, hist = common.run_dqn(
        env, TINY, SEED, deploy=False, draws=port["dqn_draws"],
        states=dqn_state_from_numpy(jax_tree_numpy(port["dqn_init"]), "cpu"))
    assert lats == []
    _assert_history(hist, ref["dqn"][1])
    lats, hist, (states, _) = common.run_actor_critic(
        env, TINY, SEED, deploy=False, draws=port["ac_draws"],
        offline_draws=port["ac_offline_draws"],
        states=ddpg_state_from_numpy(jax_tree_numpy(port["ac_init"]), "cpu"))
    assert lats == []
    _assert_history(hist, ref["ac"][1])
    assert states.fleet == F


def test_greedy_assignment_ddpg_matches_the_reference(ref, port):
    """Deploy-time action of the trained lanes, from each lane's final
    assignment: the port's fleet call against the reference's per lane."""
    jenv, env = ref["env"], port["env"]
    _, jhist, (jstates, jcfg) = ref["ac"]
    _, _, (_, cfg) = port["ac"]
    states = ddpg_state_from_numpy(jax_tree_numpy(jstates), "cpu")
    X = to_torch(jhist.final_assignment)
    got = greedy_assignment_ddpg(env, cfg, states, env.reset(F)._replace(X=X))
    assert got.shape == (F, env.N, env.M)
    for f in range(F):
        state_f = jax.tree.map(lambda x, f=f: x[f], jstates)
        s = jenv.reset(jax.random.PRNGKey(0))._replace(X=jhist.final_assignment[f])
        assert_exact(got[f], jax_greedy_ddpg(jax.random.PRNGKey(f), jenv, jcfg,
                                             state_f, s))


def test_compare_all_keys_and_values_follow_the_reference(ref, port, monkeypatch):
    """The port's compare_all composed from its pieces on the reference's
    draws equals the reference's: every key, every value."""
    env = port["env"]
    monkeypatch.setattr(common, "make_env", lambda app, device=None: env)
    for name, piece in (("run_model_based", "model_based"), ("run_dqn", "dqn"),
                        ("run_actor_critic", "ac")):
        monkeypatch.setattr(common, name, lambda *a, value=port[piece], **k: value)
    got = common.compare_all(APP, TINY, SEED, verbose=False)
    want = ref["compare_all"]
    assert list(got) == list(want)
    for key in want:
        if key == "seconds":
            continue
        if key.startswith("_"):
            _assert_history(got[key], want[key])
        elif isinstance(want[key], str) or key == "n_seeds":
            assert got[key] == want[key]
        else:
            assert_f32(np.asarray(got[key], np.float64),
                       np.asarray(want[key], np.float64), rtol=MB_RTOL, atol=1e-4)


# --------------------------------------------------------------------------
# Fig 12
# --------------------------------------------------------------------------
def test_fig12_shift_and_refit_match_the_reference(ref, port):
    """The shifted run from the reference's trained lanes carried across
    (``run_shifted`` updates its states in place), on its draws."""
    env, cfg = port["env"], port["ac"][2][1]
    states = ddpg_state_from_numpy(jax_tree_numpy(ref["ac"][2][0]), "cpu")
    after, hist = fig12.run_shifted(env, cfg, states, TINY, SEED,
                                    draws=port["shift_draws"])
    want = ref["fig12"]
    assert hist.rewards.shape == (F, T_SHIFT)
    assert_f32(np.asarray(after), np.asarray(want["ac_after_seeds"]), rtol=RTOL)
    A, Z = port["fit_draws"]
    mb_after = fig12.refit_model_based(env, TINY, SEED, assignments=A, meas_z=Z)
    assert_f32(mb_after, want["mb_after_shift"], rtol=MB_RTOL)
    # the whole run, from the port's pieces, keyed as the reference's
    got = {"app": APP, "n_seeds": F,
           "ac_before": float(np.mean(port["ac"][0])),
           "ac_before_std": float(np.std(port["ac"][0])),
           "mb_before": port["model_based"][0],
           "ac_after_shift": float(np.mean(after)),
           "ac_after_shift_std": float(np.std(after)),
           "ac_after_seeds": after, "mb_after_shift": mb_after,
           "shift_factor": 1.5}
    assert list(got) == list(want)
    for key in ("ac_before", "ac_after_shift", "mb_before", "mb_after_shift"):
        assert_f32(got[key], want[key], rtol=MB_RTOL)


# --------------------------------------------------------------------------
# the scripts' mains: the reference's JSON keys, from the port's own draws
# --------------------------------------------------------------------------
@pytest.fixture
def tiny_mains(monkeypatch, tmp_path):
    monkeypatch.setattr(common.Budget, "quick", classmethod(lambda cls: tiny(cls)))
    for module in (reward, fig6, fig8_10, fig12):
        monkeypatch.setattr(module, "ART", tmp_path)
    return tmp_path


def test_reward_main_writes_the_references_keys(tiny_mains):
    reward.main(["--app", APP, "--epochs", "20", "--device", "cpu"])
    got = json.loads((tiny_mains / f"reward_{APP}.json").read_text())
    want = json.loads((REPO / "artifacts" / "paper" / "reward_cq_small.json")
                      .read_text())
    assert list(got) == list(want)
    assert got["epochs"] == 20 and len(got["ac_smoothed_mean"]) == 20
    assert np.isfinite(got["ac_final_avg"]) and np.isfinite(got["dqn_final_avg"])


@pytest.mark.parametrize("module,name,apps", [
    (fig6, "fig6.json", fig6.APPS), (fig8_10, "fig8_10.json", fig8_10.APPS)])
def test_compare_all_mains_write_the_references_keys(ref, tiny_mains, module,
                                                     name, apps):
    module.main(["--device", "cpu"])
    got = json.loads((tiny_mains / name).read_text())
    keys = [k for k in ref["compare_all"] if not k.startswith("_")]
    assert [r["app"] for r in got] == list(apps)
    for r in got:
        assert list(r) == keys
        for key in ("default", "model_based", "dqn", "actor_critic"):
            assert np.isfinite(r[key]) and r[key] > 0


def test_fig12_main_writes_the_references_keys(ref, tiny_mains):
    fig12.main(["--apps", APP, "--device", "cpu"])
    got = json.loads((tiny_mains / "fig12.json").read_text())
    assert len(got) == 1 and list(got[0]) == list(ref["fig12"])
    assert len(got[0]["ac_after_seeds"]) == F


def test_storm_control_main_runs_at_the_tiny_budget(tiny_mains, capsys):
    storm_control.main(["--app", APP, "--quick", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[{APP}] default=" in out
    assert "actor-critic after shift" in out and "model-based after shift" in out
