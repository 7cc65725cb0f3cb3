"""The elastic lane lifecycle in the port (repro_torch.fleet.lifecycle)
against the reference's (repro.fleet.lifecycle): the plateau rule, the
forced-stop run on the reference's draws, compaction of every state the
port carries, lane maps, kill-and-resume of a compacted run (on explicit
draws and from the generator), the no-stop contract, the scenario search,
and the launcher's --early-stop / --scenario-search / --guards."""
import copy
import dataclasses
import json

import jax
import numpy as np
import pytest

from test_torch_checkpoint import assert_leaves_equal
from test_torch_parity import (assert_exact, assert_f32, carried_fleet,
                               cfg_pair, env_pair, jax_epoch_draws,
                               numpy_epoch_draws, torch)

from repro.core import make_agent as jax_make_agent
from repro.dsdps import SchedulingEnv as JaxEnv
from repro.dsdps import apps as japps
from repro.dsdps import scenarios as jscen
from repro.fleet import lifecycle as jlc
from repro_torch.checkpoint import FleetCheckpoint
from repro_torch.core import convert, make_agent, run_online_fleet
from repro_torch.dsdps import SchedulingEnv, apps, scenarios
from repro_torch.fleet import (StopRule, compact_lanes, plateau_converged,
                               restore_elastic, run_online_fleet_elastic,
                               search_scenarios, take_lanes)
from repro_torch.fleet.lifecycle import _draw_rows
from repro_torch.launch import drl_control


def stop_at(epoch: int, *lanes: int):
    """A ``stop_fn`` that stops the live rows ``lanes`` at the boundary
    after ``epoch`` epochs of the call."""
    def stop(rewards_so_far, t):
        done = np.zeros(rewards_so_far.shape[0], bool)
        if t == epoch:
            done[list(lanes)] = True
        return done
    return stop


# --------------------------------------------------------------------------
# the plateau rule
# --------------------------------------------------------------------------
def test_plateau_verdicts_match_the_references():
    """Flat, improving, degrading, noisy and tied lanes under three rules,
    as [F, 2W] and as one lane; the tie ``last - prev == rel_tol * scale``
    (exact in float32) converges on both sides."""
    rng = np.random.default_rng(0)
    for rule in (StopRule(window=4, rel_tol=0.01), StopRule(window=2),
                 StopRule(window=4, rel_tol=0.5)):
        W = rule.window
        recent = np.zeros((6, 2 * W), np.float32)
        recent[0] = -2.0
        recent[1] = np.linspace(-3.0, -1.0, 2 * W)
        recent[2] = np.linspace(-1.0, -3.0, 2 * W)
        recent[3] = rng.normal(-2.0, 0.3, 2 * W)
        recent[4, :W], recent[4, W:] = -2.0, -2.0 + 2.0 * rule.rel_tol
        recent[5] = rng.normal(0.0, 1e-12, 2 * W)
        jrule = jlc.StopRule(*rule)
        want = np.asarray(jlc.plateau_converged(jax.numpy.asarray(recent), jrule))
        got = plateau_converged(recent, rule).numpy()
        assert_exact(got, want)
        if rule.rel_tol == 0.5:
            assert got[4]                         # the tie converges
        assert bool(plateau_converged(recent[1], rule)) == bool(want[1])
    tie = np.array([-2.0, -2.0, -1.0, -1.0], np.float32)   # +1.0 == 0.5 × 2
    assert bool(plateau_converged(tie, StopRule(window=2, rel_tol=0.5)))
    assert bool(jlc.plateau_converged(jax.numpy.asarray(tie),
                                      jlc.StopRule(window=2, rel_tol=0.5)))


@pytest.mark.parametrize("window,min_epochs", [(8, 4), (2, 10), (8, 16), (1, 0)])
def test_stoprule_warmup(window, min_epochs):
    got = StopRule(window=window, min_epochs=min_epochs).warmup
    assert got == jlc.StopRule(window=window, min_epochs=min_epochs).warmup
    assert got == max(min_epochs, 2 * window)


# --------------------------------------------------------------------------
# the forced-stop run against the reference's
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def forced_stop():
    """The reference test's setup (tests/test_lifecycle.py: DDPG with K-NN 4,
    cq_small, F=3, T=12, one_slow_machine single-copy where invariant, lane
    1 stopped at 4) run by the reference, then by the port on the
    reference's draws, elastic and fixed-grid."""
    jenv, tenv = env_pair()
    jcfg, tcfg = cfg_pair(jenv, k_nn=4)
    F, T, stop = 3, 12, 4
    jp = jscen.build("one_slow_machine", jenv, F, broadcast_invariant=True)
    tp = scenarios.build("one_slow_machine", tenv, F, broadcast_invariant=True)
    jstates, _ = carried_fleet(jcfg, F, seed=2)
    keys = jax.random.split(jax.random.PRNGKey(3), F)
    jagent = jax_make_agent("ddpg", jenv, cfg=jcfg)
    jres = jlc.run_online_fleet_elastic(keys, jenv, jagent, jstates, T,
                                        rule=jlc.StopRule(check_every=stop),
                                        env_params=jp, stop_fn=stop_at(stop, 1))
    draws = jax_epoch_draws(keys, T=T, U=1, B=jcfg.batch, N=jenv.N, M=jenv.M,
                            S=jenv.workload.num_spouts, eps=jcfg.eps, cap=jcfg.buffer)
    agent = make_agent("ddpg", tenv, cfg=tcfg)
    init = convert.ddpg_state_from_numpy(jax.tree.map(np.asarray, jstates), "cpu")
    tres = run_online_fleet_elastic(0, tenv, agent, copy.deepcopy(init), T,
                                    rule=StopRule(check_every=stop), env_params=tp,
                                    draws=draws, stop_fn=stop_at(stop, 1))
    fixed = run_online_fleet(0, tenv, agent, copy.deepcopy(init), T, env_params=tp,
                             draws=draws)
    return dict(jres=jres, tres=tres, fixed=fixed, F=F, T=T, stop=stop)


def test_forced_stop_run_matches_the_references(forced_stop):
    """epochs_run, executed lane-epochs and moves exact; rewards and
    latencies at float32 tolerance (rtol 1e-4: twelve epochs of learning
    summed in another order); the stopped lane's padding exact."""
    jres, tres = forced_stop["jres"], forced_stop["tres"]
    T, stop = forced_stop["T"], forced_stop["stop"]
    assert tres.epochs_run.tolist() == jres.epochs_run.tolist() == [T, stop, T]
    assert tres.executed_lane_epochs == jres.executed_lane_epochs == 3 * stop + 2 * (T - stop)
    assert tres.fixed_grid_lane_epochs == jres.fixed_grid_lane_epochs
    assert tres.savings == jres.savings
    assert_exact(tres.lane_ids, jres.lane_ids)
    th, jh = tres.history, jres.history
    assert_exact(th.moved, jh.moved)
    assert th.moved.sum() > 0
    assert_exact(th.final_assignment, jh.final_assignment)
    assert_f32(th.rewards, jh.rewards, rtol=1e-4)
    assert_f32(th.latencies, jh.latencies, rtol=1e-4)
    # the stopped lane repeats its last epoch's reward and latency, moves 0
    assert_exact(th.rewards[1, stop:], np.repeat(th.rewards[1, stop - 1], T - stop))
    assert_exact(th.latencies[1, stop:], np.repeat(th.latencies[1, stop - 1], T - stop))
    assert_exact(th.moved[1, stop:], np.zeros(T - stop))
    # the final states come back in the original lane order
    got = convert.ddpg_state_to_numpy(tres.states)
    want = jax.tree.map(np.asarray, jres.states)
    assert_exact(got.epoch, want.epoch)
    assert_exact(got.replay.ptr, want.replay.ptr)
    assert_exact(got.replay.actions, want.replay.actions)


def test_compacted_lanes_bitmatch_the_fixed_grid_run(forced_stop):
    """The port against itself on the same draws: the survivors' traces and
    final states (updated after the compaction, so the Adam moments stayed
    aligned with their nets) equal the fixed-grid run's bit for bit, and
    the stopped lane's prefix and state at its stop equal the fixed grid's
    prefix."""
    tres, (s_fix, h_fix) = forced_stop["tres"], forced_stop["fixed"]
    stop = forced_stop["stop"]
    for lane in (0, 2):
        for field in ("rewards", "latencies", "moved", "final_assignment"):
            assert_exact(getattr(tres.history, field)[lane], getattr(h_fix, field)[lane])
    assert_leaves_equal(take_lanes(tres.states, [0, 2]), take_lanes(s_fix, [0, 2]))
    for field in ("rewards", "latencies", "moved"):
        assert_exact(getattr(tres.history, field)[1, :stop],
                     getattr(h_fix, field)[1, :stop])
    assert int(tres.states.epoch[1]) == stop and int(s_fix.epoch[1]) == forced_stop["T"]


# --------------------------------------------------------------------------
# compaction
# --------------------------------------------------------------------------
def test_all_lanes_stopping_ends_the_run():
    _, env = env_pair()
    rr = make_agent("round_robin", env)
    res = run_online_fleet_elastic(5, env, rr, rr.init_fleet(None, 2, "cpu"), 20,
                                   rule=StopRule(check_every=5),
                                   stop_fn=lambda r, t: np.ones(r.shape[0], bool))
    assert res.epochs_run.tolist() == [5, 5]
    assert res.executed_lane_epochs == 10 and res.savings == 0.75
    assert res.history.rewards.shape == (2, 20)
    assert_exact(res.states, torch.tensor([5, 5], dtype=torch.int32))


def test_compact_lanes_keeps_broadcast_invariant_leaves_single_copy():
    _, env = env_pair()
    ref = env.default_params()
    params = scenarios.build("one_slow_machine", env, 4, broadcast_invariant=True)
    states = torch.arange(4.0)
    s2, e2, p2 = compact_lanes([0, 2], states, env.reset(4, params), params, ref)
    assert_exact(s2, torch.tensor([0.0, 2.0]))
    assert e2.X.shape[0] == 2 and e2.speed.shape[0] == 2
    assert p2.speed.shape == (2,) + ref.speed.shape
    assert p2.routing.shape == ref.routing.shape and p2.routing is params.routing
    assert_exact(p2.speed, params.speed[[0, 2]])


@pytest.mark.parametrize("agent", ["ddpg", "dqn", "graph_policy", "model_based",
                                   "round_robin", "stream_ac", "stream_q"])
def test_take_lanes_gathers_every_agent_state(agent):
    """Lanes [2, 0] of each agent's fleet state equal those lanes leaf by
    leaf, on copies: nets are fresh modules with their parameters' grad
    flags, target nets stay copies (an in-place update of the online net
    leaves them alone), nothing aliases the source."""
    _, env = env_pair()
    params = scenarios.build("one_slow_machine", env, 3)
    ag = make_agent(agent, env, **({"k_nn": 4, "batch": 8} if agent == "ddpg" else {}))
    states = ag.init_fleet(torch.Generator().manual_seed(0), 3, "cpu", env_params=params)
    got = take_lanes(states, [2, 0])
    from repro_torch.checkpoint import named_leaves
    src = dict(named_leaves(states))
    for name, leaf in named_leaves(got):
        assert_exact(leaf, src[name][[2, 0]])
        assert leaf.requires_grad == src[name].requires_grad, name
        assert leaf.data_ptr() != src[name].data_ptr(), name
    if agent == "ddpg":
        assert got.target_actor is not got.actor
        assert [p.requires_grad for p in got.target_critic.parameters()] == [False] * 6
        with torch.no_grad():
            got.actor.weights[0].add_(1.0)
        assert_exact(got.target_actor.weights[0], states.target_actor.weights[0][[2, 0]])
        assert len(got.opt_actor.mu) == len(list(got.actor.parameters()))
        for m, p in zip(got.opt_actor.mu, got.actor.parameters()):
            assert m.shape == p.shape


def test_structural_params_compact():
    from repro_torch.dsdps import StructuralSchedulingEnv
    env = StructuralSchedulingEnv(apps.structural_topologies(), device="cpu")
    ref = env.default_params()
    params = scenarios.build("dag_shapes", env, 3)
    _, _, got = compact_lanes([2, 1], torch.zeros(3), env.reset(3, params), params, ref)
    for p, g, r in zip(params, got, ref):
        assert_exact(g, p[[2, 1]] if p.dim() == r.dim() + 1 else p)


# --------------------------------------------------------------------------
# checkpoints of a compacted fleet
# --------------------------------------------------------------------------
def test_each_snapshot_names_its_original_lanes(tmp_path):
    """The reference test's round-robin run (F=3, T=12, every 4, lane 0
    stopped at 4): snapshots at 4, 8 and 12; the epoch-4 one holds all
    three lanes, the later ones the compacted [1, 2]."""
    _, env = env_pair()
    rr = make_agent("round_robin", env)
    ck = FleetCheckpoint(tmp_path, every=4, keep=10)
    run_online_fleet_elastic(7, env, rr, rr.init_fleet(None, 3, "cpu"), 12,
                             rule=StopRule(check_every=4), checkpoint=ck,
                             stop_fn=stop_at(4, 0))
    ck.wait()
    assert ck.all_epochs() == [4, 8, 12]
    maps = {}
    for epoch, width in ((4, 3), (8, 2), (12, 2)):
        *_, lanes = ck.restore(torch.zeros(width, dtype=torch.int32), env.reset(width),
                               torch.Generator(), epoch=epoch, with_lane_map=True)
        maps[epoch] = lanes.tolist()
    assert maps == {4: [0, 1, 2], 8: [1, 2], 12: [1, 2]}
    ck.close()


@pytest.mark.parametrize("explicit", [True, False])
def test_kill_and_resume_of_a_compacted_run_equals_the_uninterrupted(tmp_path, explicit):
    """DDPG, one_slow_machine, F=3, T=12, lane 1 stopped at 4, saved every 4,
    killed after 8: restored through restore_elastic into fresh full-width
    templates (cut to the snapshot's 2 lanes), resumed with the original
    lane ids.  Bit for bit against the uninterrupted elastic run, on
    explicit draws (rows of the survivors) and from the generator."""
    _, env = env_pair()
    F, T, cut = 3, 12, 8
    params = scenarios.build("one_slow_machine", env, F, broadcast_invariant=True)
    ref = env.default_params()
    ag = make_agent("ddpg", env, k_nn=4, batch=8)
    init = ag.init_fleet(torch.Generator().manual_seed(8), F, "cpu", env_params=params)
    draws = (numpy_epoch_draws(np.random.default_rng(9), F, T, 1, 8, env.N, env.M,
                               env.workload.num_spouts) if explicit else None)

    def elastic(states, n, gen, **kw):
        return run_online_fleet_elastic(gen, env, ag, states, n,
                                        rule=StopRule(check_every=4),
                                        stop_fn=stop_at(4, 1), **kw)

    ck = FleetCheckpoint(tmp_path / "full", every=4, keep=10, use_async=False)
    full = elastic(copy.deepcopy(init), T, torch.Generator().manual_seed(1),
                   env_params=params, checkpoint=ck, draws=draws)
    assert full.epochs_run.tolist() == [T, 4, T]
    assert ck.has_lane_map(epoch=cut)

    epoch, states, env_state, gen, r_params, ids = restore_elastic(
        FleetCheckpoint(tmp_path / "full"), copy.deepcopy(init), env.reset(F, params),
        torch.Generator(), env_params=params, ref=ref, epoch=cut)
    assert epoch == cut and ids.tolist() == [0, 2]
    assert_exact(r_params.speed, params.speed[[0, 2]])
    assert r_params.routing is params.routing
    ck2 = FleetCheckpoint(tmp_path / "resumed", every=4, keep=10, use_async=False)
    res = elastic(states, T - cut, gen, env_params=r_params, env_state=env_state,
                  start_epoch=epoch, lane_ids=ids, checkpoint=ck2,
                  draws=None if draws is None else [_draw_rows(d, ids) for d in draws[cut:]])
    assert res.lane_ids.tolist() == [0, 2]
    assert res.epochs_run.tolist() == [T - cut, T - cut]
    for field in ("rewards", "latencies", "moved"):
        assert_exact(getattr(res.history, field), getattr(full.history, field)[[0, 2], cut:])
    assert_exact(res.history.final_assignment, full.history.final_assignment[[0, 2]])
    assert_leaves_equal(res.states, take_lanes(full.states, [0, 2]))
    *_, lanes = ck2.restore(take_lanes(init, [0, 1]), env.reset(2), torch.Generator(),
                            with_lane_map=True)
    assert lanes.tolist() == [0, 2] and ck2.latest_epoch() == T


def test_no_stop_equals_the_fixed_grid_run_from_the_generator():
    """Contract (a): a rule that never fires leaves the elastic run equal to
    run_online_fleet from the same seed, bit for bit, chunks and all."""
    _, env = env_pair()
    params = scenarios.build("mixed", env, 3)
    ag = make_agent("ddpg", env, k_nn=4, batch=8)
    init = ag.init_fleet(torch.Generator().manual_seed(4), 3, "cpu", env_params=params)
    s_fix, h_fix = run_online_fleet(5, env, ag, copy.deepcopy(init), 10, env_params=params)
    res = run_online_fleet_elastic(5, env, ag, copy.deepcopy(init), 10, env_params=params,
                                   rule=StopRule(window=2, min_epochs=4, rel_tol=-1e9,
                                                 check_every=3))
    assert res.executed_lane_epochs == res.fixed_grid_lane_epochs == 30
    for field in ("rewards", "latencies", "moved", "final_assignment"):
        assert_exact(getattr(res.history, field), getattr(h_fix, field))
    assert_leaves_equal(res.states, s_fix)
    # run_online_fleet(lifecycle=) is the same run
    s_lc, h_lc = run_online_fleet(5, env, ag, copy.deepcopy(init), 10, env_params=params,
                                  lifecycle=StopRule(window=2, min_epochs=4,
                                                     rel_tol=-1e9, check_every=3))
    assert_exact(h_lc.rewards, h_fix.rewards)
    assert_leaves_equal(s_lc, s_fix)


# --------------------------------------------------------------------------
# the scenario search
# --------------------------------------------------------------------------
def test_search_scenarios_leaderboard_matches_the_references():
    """Round-robin on cq_small with measurement noise and rate jitter 0 on
    both sides, one_slow_machine candidates and the same refills (a
    perturb that hands out copies of one fixed list): the same candidates,
    rungs, epochs and cuts, scores at 1e-5."""
    jt, tt = japps.ALL_APPS["cq_small"](), apps.ALL_APPS["cq_small"]()
    jenv = JaxEnv(jt, dataclasses.replace(japps.default_workload(jt), jitter=0.0),
                  noise_sigma=0.0)
    tenv = SchedulingEnv(tt, dataclasses.replace(apps.default_workload(tt), jitter=0.0),
                         noise_sigma=0.0, device="cpu")
    refills = [jax.tree.map(np.asarray, jscen.sample_perturbed(jenv, jax.random.PRNGKey(i)))
               for i in range(4)]
    jit, tit = iter(refills), iter(refills)
    kw = dict(scenario="one_slow_machine", fleet=4, rungs=(3, 3, 2), eval_window=2)
    want = jlc.search_scenarios(jenv, jax_make_agent("round_robin", jenv),
                                perturb=lambda key: next(jit), **kw)
    got = search_scenarios(tenv, make_agent("round_robin", tenv),
                           perturb=lambda gen: convert.env_params_from_numpy(next(tit), "cpu"),
                           **kw)
    assert [(e.cand, e.rung, e.epochs, e.survived) for e in got.entries] == \
        [(e.cand, e.rung, e.epochs, e.survived) for e in want.entries]
    assert_f32([e.score for e in got.entries], [e.score for e in want.entries], rtol=1e-5)
    assert got.total_lane_epochs == want.total_lane_epochs == 4 * 8
    assert got.rungs == want.rungs and got.fleet == want.fleet
    assert sorted(got.params) == sorted(want.params) == list(range(8))
    js = got.to_json()
    assert js.keys() == want.to_json().keys() and len(js["leaderboard"]) == 8


def test_search_from_the_generator_and_its_refusal():
    _, env = env_pair()
    rr = make_agent("round_robin", env)
    lb = search_scenarios(env, rr, fleet=4, rungs=(3, 3), eval_window=2, seed=0)
    assert len(lb.entries) == 6 and lb.total_lane_epochs == 24
    scores = [e.score for e in lb.entries]
    assert scores == sorted(scores, reverse=True) and np.isfinite(scores).all()
    pruned = [e for e in lb.entries if not e.survived]
    assert len(pruned) == 2 and all(e.rung == 1 for e in pruned)
    again = search_scenarios(env, rr, fleet=4, rungs=(3, 3), eval_window=2, seed=0)
    assert again.to_json() == lb.to_json()
    with pytest.raises(ValueError, match="fleet >= 2"):
        search_scenarios(env, rr, fleet=1, rungs=(2,))


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
LAUNCH = ["--device", "cpu", "--app", "cq_small", "--fleet", "2", "--offline", "50",
          "--offline-updates", "5"]


@pytest.mark.parametrize("flags,message", [
    (["--scenario-search", "--checkpoint-dir", "CK"], "does not support --checkpoint-dir"),
    (["--scenario-search", "--checkpoint-dir", "CK", "--resume"],
     "does not support --checkpoint-dir"),
    (["--scenario-search", "--early-stop"], "does not support --early-stop"),
    (["--scenario-search", "--fleet", "1"], "needs --fleet >= 2"),
    (["--search-rungs", "3,0"], "--search-rungs must be positive"),
])
def test_launcher_refusals(tmp_path, capsys, flags, message):
    flags = [str(tmp_path) if f == "CK" else f for f in flags]
    with pytest.raises(SystemExit):
        drl_control.main(LAUNCH + ["--epochs", "2"] + flags)
    assert message in capsys.readouterr().err
    assert (drl_control.refusal("cq_small", "ddpg", fleet=1, scenario_search=True)
            == "--scenario-search needs --fleet >= 2")
    with pytest.raises(ValueError, match="does not support --resume"):
        drl_control.run(device="cpu", fleet=2, scenario_search=True, resume=True)


def test_launcher_early_stop_guards_and_search(tmp_path, capsys):
    res = drl_control.main(LAUNCH + ["--epochs", "20", "--early-stop", "--guards"])
    out = capsys.readouterr().out
    e = res["elastic"]
    assert "early stopping: per-lane epochs" in out and "lane-epochs executed" in out
    assert "synchronizing calls per steady-state epoch" in out
    assert "no non-finite carries" in out
    assert e.epochs_run.min() >= StopRule().warmup and res["lane_epochs"] == \
        e.executed_lane_epochs
    # the guard counts the epochs the compacting fleet ran
    assert res["guards"].steady_steps == e.epochs_run.max()
    assert res["history"].rewards.shape == (2, 20)
    path = tmp_path / "lb.json"
    res = drl_control.main(["--device", "cpu", "--app", "cq_small", "--agent",
                            "round_robin", "--fleet", "4", "--scenario-search",
                            "--search-rungs", "3,3", "--search-json", str(path)])
    out = capsys.readouterr().out
    assert "total lane-epochs executed: 24" in out
    saved = json.loads(path.read_text())
    assert saved == res["leaderboard"].to_json() and saved["rungs"] == [3, 3]


def test_launcher_resumes_an_elastic_run(tmp_path, capsys):
    """--early-stop saving every 2 for 4 epochs, then --resume --early-stop
    to 6 equals an uninterrupted --early-stop run of 6, bit for bit; the
    first run's lane map makes --resume without --early-stop a refusal."""
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2", "--early-stop"]
    drl_control.main(LAUNCH + ck + ["--epochs", "4"])
    assert FleetCheckpoint(tmp_path).has_lane_map()
    res = drl_control.main(LAUNCH + ck + ["--epochs", "6", "--resume"])
    full = drl_control.main(LAUNCH + ["--epochs", "6", "--early-stop"])
    assert "resumed a compacted elastic fleet from epoch 4" in capsys.readouterr().out
    assert res["lane_ids"].tolist() == [0, 1] and res["start_epoch"] == 4
    for field in ("rewards", "latencies", "moved"):
        assert_exact(getattr(res["history"], field), getattr(full["history"], field)[:, 4:])
    assert_leaves_equal(res["states"], full["states"])
    with pytest.raises(SystemExit):
        drl_control.main(LAUNCH + ["--epochs", "8", "--resume", "--checkpoint-dir",
                                   str(tmp_path)])
    assert "resume with --early-stop" in capsys.readouterr().err
