"""The port's structural fleets against the reference: topology graph
observations, the envelope-padded env (GraphEnvParams, the dense-relaxation
latency model, step), the dag_shapes scenario, the graph policy on a
structural fleet (against the reference's run_online_fleet, and lane by
lane against single runs) and the launcher's ``--app structural``."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, assert_tree_f32,
                               assert_tree_scaled, jax_epoch_draws,
                               jax_tree_numpy, numpy_epoch_draws, to_numpy,
                               to_torch, torch)
from test_torch_streaming import cfg_pair

from repro.core import graph_policy as jgp
from repro.core import make_agent as jax_make_agent
from repro.core.agent import run_online_fleet as jax_run_online_fleet
from repro.dsdps import apps as japps
from repro.dsdps import scenarios as jscen
from repro.dsdps.structural import StructuralSchedulingEnv as JStructEnv
from repro.launch import drl_control as jax_drl_control
from repro_torch.core import EpochDraws, make_agent, run_online_fleet
from repro_torch.core import convert
from repro_torch.core import graph_policy as tgp
from repro_torch.dsdps import (Envelope, GraphEnvParams, SchedulingEnv,
                               StructuralSchedulingEnv, apps, lane_params,
                               params_in_axes, scenarios, stack_env_params)
from repro_torch.dsdps import simulator as tsim
from repro_torch.dsdps.apps import default_workload
from repro_torch.launch import drl_control

# float32 sums in another order than XLA's dots (weights and traces:
# assert_tree_scaled's leaf-scaled slack)
RTOL = 1e-5


@pytest.fixture(scope="module")
def topo():
    return apps.continuous_queries("small")


@pytest.fixture(scope="module")
def structural():
    """(reference env, port env on the CPU) over the default DAG shapes."""
    return (JStructEnv(japps.structural_topologies()),
            StructuralSchedulingEnv(apps.structural_topologies(), device="cpu"))


def padded(topo):
    return StructuralSchedulingEnv(
        [topo], envelope=Envelope(max_execs=29, max_edges=151, max_spouts=5,
                                  max_components=8), device="cpu")


# --------------------------------------------------------------------------
# graph observations and params
# --------------------------------------------------------------------------
@pytest.mark.parametrize("app", ["cq_small", "diamond", "wide_fanout"])
def test_graph_obs_padding_matches_reference(app):
    t, jt = apps.ALL_APPS[app](), japps.ALL_APPS[app]()
    n = t.num_executors
    e = int(np.count_nonzero(t.routing_matrix(0)))
    for max_execs, max_edges in ((n, e), (n + 7, e + 30)):
        got = t.to_graph_obs(max_execs, max_edges)
        want = jt.to_graph_obs(max_execs, max_edges)
        for f in got._fields:
            g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype, f
            assert_exact(g, w)
        assert (got.edge_src[e:] == max_execs).all()         # sacrificial index
        assert (got.edge_w[e:] == 0).all() and (got.node_mask[n:] == 0).all()
    with pytest.raises(ValueError, match=t.name):
        t.to_graph_obs(n - 1, e)
    with pytest.raises(ValueError, match="max_edges"):
        t.to_graph_obs(n, e - 1)


def test_params_for_matches_reference(structural):
    jenv, tenv = structural
    assert tenv.envelope == Envelope(**jenv.envelope.__dict__)
    assert (tenv.N, tenv.M, tenv.state_dim) == (jenv.N, jenv.M, jenv.state_dim)
    for jt, tt in zip(jenv.topologies, tenv.topologies):
        got, want = tenv.params_for(tt), jenv.params_for(jt)
        for f in GraphEnvParams._fields:
            g, w = to_numpy(getattr(got, f)), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype and g.shape == w.shape, f
            assert_f32(g, w, rtol=1e-6)
        back = convert.graph_env_params_from_numpy(jax_tree_numpy(want), "cpu")
        assert all(torch.equal(a, b) for a, b in zip(back, got))


def test_params_for_refuses_a_too_small_envelope(topo):
    small = StructuralSchedulingEnv(
        [topo], envelope=Envelope(max_execs=topo.num_executors - 1,
                                  max_edges=500, max_spouts=4,
                                  max_components=6), device="cpu")
    with pytest.raises(ValueError, match=topo.name):
        small.params_for(topo)
    few = StructuralSchedulingEnv(
        [topo], envelope=Envelope(max_execs=40, max_edges=500, max_spouts=1,
                                  max_components=6), device="cpu")
    with pytest.raises(ValueError, match="max_spouts"):
        few.params_for(topo)


def test_dag_shapes_is_structural_only(topo, structural):
    plain = SchedulingEnv(topo, default_workload(topo), device="cpu")
    with pytest.raises(TypeError, match="StructuralSchedulingEnv"):
        scenarios.build_for(plain, "dag_shapes", 3)
    with pytest.raises(TypeError, match="StructuralSchedulingEnv"):
        scenarios.build("dag_shapes", plain, 3)
    assert "dag_shapes" not in scenarios.scenario_names(plain)
    jenv, tenv = structural
    assert scenarios.scenario_names(tenv) == jscen.scenario_names(jenv)
    assert "dag_shapes" in scenarios.scenario_names(tenv)


def test_dag_shapes_and_numeric_scenarios_match_reference(structural):
    jenv, tenv = structural
    for name, kw in (("dag_shapes", {}), ("one_slow_machine", {}),
                     ("diurnal_rate", {"amplitude": 0.3})):
        got = scenarios.build_for(tenv, name, 4, **kw)
        want = jscen.build_for(jenv, name, 4, **kw)
        assert isinstance(got, GraphEnvParams)
        for f in GraphEnvParams._fields:
            assert_f32(getattr(got, f), getattr(want, f), rtol=1e-6)
    # the stack helpers keep the type and the int32 edge indices
    p = scenarios.build("dag_shapes", tenv, 3)
    assert p.edge_src.dtype == torch.int32 and p.edge_src.shape == (3, tenv.envelope.max_edges)
    axes = params_in_axes(p, tenv.default_params())
    assert isinstance(axes, GraphEnvParams) and axes.edge_src and axes.routing
    lane = lane_params(p, tenv.default_params(), 1)
    assert isinstance(lane, GraphEnvParams)
    assert torch.equal(lane.edge_src, tenv.params_for(tenv.topologies[1]).edge_src)
    same = stack_env_params([tenv.default_params()] * 2, broadcast_invariant=True)
    assert isinstance(same, GraphEnvParams) and params_in_axes(
        same, tenv.default_params()) is None
    slow = tsim.with_straggler(lane, 3, 0.5)
    assert float(slow.speed[3]) == 0.5 and isinstance(slow, GraphEnvParams)
    z = torch.ones(tenv.N)
    bumped = tsim.perturb_service(lane, z, 0.1)
    assert (bumped.service_ms[lane.node_mask == 0] == 0).all()


# --------------------------------------------------------------------------
# the padded latency model and the env
# --------------------------------------------------------------------------
@pytest.mark.parametrize("app", ["cq_small", "diamond", "wide_fanout"])
def test_padded_latency_matches_plain_env(app):
    """The dense relaxation at any envelope equals the plain env's
    reverse-topological recursion (rtol 1e-6, as the reference holds it)."""
    t = apps.ALL_APPS[app]()
    plain = SchedulingEnv(t, default_workload(t), device="cpu")
    rng = np.random.default_rng(1)
    X = np.eye(plain.M, dtype=np.float32)[rng.integers(0, plain.M, (4, plain.N))]
    X[0] = to_numpy(plain.round_robin_assignment())
    w = plain.default_params().base_rates
    want = plain.evaluate(to_torch(X), w)
    n, s = t.num_executors, len(t.spout_executors)
    for env in (StructuralSchedulingEnv([t], device="cpu"), padded(t),
                StructuralSchedulingEnv(apps.structural_topologies(), device="cpu")):
        p = env.params_for(t)
        X_pad = torch.zeros(4, env.N, env.M)
        X_pad[:, :n] = to_torch(X)
        w_pad = torch.zeros(env.envelope.max_spouts)
        w_pad[:s] = w
        assert_f32(env.evaluate(X_pad, w_pad, params=p), want, rtol=1e-6)


def test_structural_evaluate_and_step_match_reference(structural):
    """A dag_shapes fleet of 3: evaluate at random assignments, and one
    step from reset with the reference's noise and rate draws replayed."""
    jenv, tenv = structural
    F = 3
    jp = jscen.build_for(jenv, "dag_shapes", F)
    tp = convert.graph_env_params_from_numpy(jax_tree_numpy(jp), "cpu")
    rng = np.random.default_rng(2)
    X = np.eye(tenv.M, dtype=np.float32)[rng.integers(0, tenv.M, (F, tenv.N))]
    w = to_numpy(tp.base_rates)
    got = tenv.evaluate(to_torch(X), tp.base_rates, params=tp)
    for f in range(F):
        jpf = jax.tree.map(lambda x: x[f], jp)
        assert_f32(got[f], jenv.evaluate(jnp.asarray(X[f]), jnp.asarray(w[f]),
                                         params=jpf), rtol=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(3), F)
    state = tenv.reset(F, tp)
    meas, rate = [], []
    for f in range(F):
        k_noise, k_w = jax.random.split(keys[f])
        meas.append(np.asarray(jax.random.normal(k_noise, (5,))))
        rate.append(np.asarray(jax.random.normal(k_w, (tenv.envelope.max_spouts,))))
    out = tenv.step(state, to_torch(X), tp, meas_z=to_torch(np.stack(meas)),
                    rate_z=to_torch(np.stack(rate)))
    for f in range(F):
        jpf = jax.tree.map(lambda x: x[f], jp)
        js = jenv.reset(keys[f], jpf)
        assert_exact(state.X[f], js.X)
        jo = jenv.step(keys[f], js, jnp.asarray(X[f]), jpf)
        assert_f32(out.latency_ms[f], jo.latency_ms, rtol=1e-6)
        assert_f32(out.state.w[f], jo.state.w, rtol=1e-6)
        assert_exact(out.state.X[f], jo.state.X)
        assert int(out.moved[f]) == int(jo.moved)
    # the padded spouts read exactly 0 in the state vector
    s_vec = tenv.state_vector(out.state, tp)
    pad = (tp.base_rates == 0)
    assert (s_vec[:, tenv.N * tenv.M:][pad] == 0).all()


def test_moved_never_counts_padded_rows(structural):
    """Flipping a padded row of the action is no move and changes nothing."""
    _, env = structural
    t = env.topologies[1]                                  # diamond: n < N
    p = env.params_for(t)
    n = t.num_executors
    assert n < env.N
    state = env.reset(1, p)
    action = state.X.clone()
    action[0, n, 0] = 1.0                                  # "move" a padded row
    z, rz = torch.zeros(1, 5), torch.zeros(1, env.envelope.max_spouts)
    out_pad = env.step(state, action, p, meas_z=z, rate_z=rz)
    out_same = env.step(state, state.X, p, meas_z=z, rate_z=rz)
    assert int(out_pad.moved[0]) == 0
    assert torch.equal(out_pad.latency_ms, out_same.latency_ms)
    assert (out_pad.state.X[0, n:] == 0).all()


# --------------------------------------------------------------------------
# the graph policy on structural fleets
# --------------------------------------------------------------------------
def test_graph_policy_structural_fleet_matches_reference(structural):
    """dag_shapes, F=3 (one lane a DAG), T=5, from carried weights with the
    reference's draws replayed: moves and assignments exact; latencies,
    rewards, weights, traces and reward statistics at float32 tolerance."""
    jenv, tenv = structural
    jcfg, tcfg = cfg_pair("graph_policy", jenv)
    F, T = 3, 5
    jp = jscen.build_for(jenv, "dag_shapes", F)
    tp = convert.graph_env_params_from_numpy(jax_tree_numpy(jp), "cpu")
    js = jgp.init_fleet(jax.random.PRNGKey(5), jcfg, F)
    ts = convert.graph_policy_state_from_numpy(jax_tree_numpy(js), "cpu")
    keys = jax.random.split(jax.random.PRNGKey(6), F)
    js_end, jh = jax_run_online_fleet(keys, jenv,
                                      jax_make_agent("graph_policy", jenv, cfg=jcfg),
                                      js, T=T, env_params=jp)
    draws = jax_epoch_draws(keys, T=T, U=1, B=1, N=jenv.N, M=jenv.M,
                            S=jenv.envelope.max_spouts, eps=jcfg.eps,
                            gumbel="rand")
    ts_end, th = run_online_fleet(0, tenv, make_agent("graph_policy", tenv, cfg=tcfg),
                                  ts, T, env_params=tp, draws=draws)
    assert_exact(th.moved, jh.moved)
    assert_exact(th.final_assignment, jh.final_assignment)
    assert th.moved.sum() > 0
    assert_f32(th.latencies, jh.latencies, rtol=RTOL)
    assert_f32(th.rewards, jh.rewards, rtol=RTOL)
    got, want = convert.graph_policy_state_to_numpy(ts_end), jax_tree_numpy(js_end)
    assert_exact(got.r_count, want.r_count)
    assert_tree_scaled(got, want, rtol=RTOL)


def test_structural_lane_equals_single_run(structural):
    """Lane f of a dag_shapes fleet equals a fleet of one under lane f's
    DAG from lane f's weights, bit for bit; each lane keeps its padded rows
    empty."""
    _, env = structural
    F, T = 3, 5
    params = scenarios.build("dag_shapes", env, F)
    agent = make_agent("graph_policy", env)
    init = convert.graph_policy_state_to_numpy(
        agent.init_fleet(torch.Generator().manual_seed(0), F, "cpu"))
    draws = numpy_epoch_draws(np.random.default_rng(9), F, T, 1, 1, env.N, env.M,
                              env.envelope.max_spouts)
    st, fleet = run_online_fleet(0, env, agent,
                                 convert.graph_policy_state_from_numpy(init, "cpu"),
                                 T, env_params=params, draws=draws)
    assert fleet.moved.sum() > 0
    for f in range(F):
        lane_p = lane_params(params, env.default_params(), f)
        st1, one = run_online_fleet(
            0, env, agent, convert.graph_policy_state_from_numpy(
                convert.lane_arrays(init, f), "cpu"), T, env_params=lane_p,
            draws=[EpochDraws(*(x[f:f + 1] for x in d)) for d in draws])
        assert_exact(fleet.rewards[f], one.rewards[0])
        assert_exact(fleet.moved[f], one.moved[0])
        assert_exact(fleet.final_assignment[f], one.final_assignment[0])
        assert_tree_f32(convert.lane_arrays(convert.graph_policy_state_to_numpy(st), f),
                        convert.graph_policy_state_to_numpy(st1), rtol=0)
        n = env.topologies[f].num_executors
        assert (fleet.final_assignment[f, n:] == 0).all()


def test_greedy_select_is_invariant_under_padding(topo):
    """The same weights on a tight and a padded envelope pick the same
    greedy move (the flat index i·M + j does not depend on the envelope)."""
    tight, pad = StructuralSchedulingEnv([topo], device="cpu"), padded(topo)
    a_t, a_p = make_agent("graph_policy", tight), make_agent("graph_policy", pad)
    st_t = a_t.init_fleet(torch.Generator().manual_seed(0), 2, "cpu")
    st_p = a_p.init_fleet(torch.Generator().manual_seed(0), 2, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tgp.leaves(st_t.qnet),
                                                 tgp.leaves(st_p.qnet)))
    n = topo.num_executors
    out = []
    for env, ag, st in ((tight, a_t, st_t), (pad, a_p, st_p)):
        p = env.default_params()
        es = env.reset(2, p)
        act, aux = ag.select_fn(ag.cfg, st, env.state_vector(es, p), es, p,
                                False, None, None)
        out.append((act, aux[0]))
    assert_exact(out[0][1], out[1][1])
    assert_exact(out[0][0][:, :n], out[1][0][:, :n])
    assert (out[1][0][:, n:] == 0).all()


def test_graph_policy_needs_a_topology():
    class NoTopo:
        N, M, state_dim = 4, 2, 10
    with pytest.raises(TypeError, match="topology-bearing"):
        make_agent("graph_policy", NoTopo())


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_launcher_runs_a_structural_dag_shapes_fleet(capsys):
    res = drl_control.main(["--device", "cpu", "--app", "structural", "--agent",
                            "graph_policy", "--scenario", "dag_shapes",
                            "--fleet", "3", "--epochs", "4"])
    out = capsys.readouterr().out
    assert "final latency" in out and "round-robin" in out
    env, params, hist = res["env"], res["env_params"], res["history"]
    assert isinstance(env, StructuralSchedulingEnv)
    assert hist.rewards.shape == (3, 4) and np.isfinite(hist.latencies).all()
    rr = env.round_robin_assignment()
    for f in range(3):
        lane_p = lane_params(params, env.default_params(), f)
        assert res["rrs"][f] == float(env.evaluate(rr, lane_p.base_rates,
                                                   params=lane_p))
        assert res["finals"][f] == float(env.evaluate(
            torch.as_tensor(hist.final_assignment[f]), lane_p.base_rates,
            params=lane_p))
    # each lane scored under its own DAG: three shapes, three round-robins
    assert len(set(res["rrs"])) == 3


@pytest.mark.parametrize("agent", ["stream_q", "stream_ac", "graph_policy"])
def test_launcher_runs_the_streaming_agents(capsys, agent):
    res = drl_control.main(["--device", "cpu", "--app", "cq_small", "--agent",
                            agent, "--scenario", "one_slow_machine", "--fleet",
                            "2", "--epochs", "3"])
    out = capsys.readouterr().out
    assert "final latency" in out and "offline" not in out
    assert res["agent"].name == agent and np.isfinite(res["finals"]).all()


@pytest.mark.parametrize("argv,message", [
    (["--app", "cq_small", "--scenario", "dag_shapes"], "not defined for --app cq_small"),
    (["--app", "structural", "--agent", "round_robin", "--serve", "4"],
     "not --app structural"),
])
def test_launcher_refuses(capsys, argv, message):
    with pytest.raises(SystemExit):
        drl_control.main(["--device", "cpu", "--fleet", "2", "--epochs", "2", *argv])
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("agent,message", [
    ("ddpg", "offline pretraining draws random assignments"),
    ("model_based", "model_based fits its latency model on random assignments"),
])
def test_launcher_refuses_structural_setups_that_crash(capsys, monkeypatch, agent,
                                                       message):
    """Two setups the structural env cannot run: DDPG's offline pretraining
    (random assignments, which the padded envelope does not define) and
    the model-based fit.  The port refuses both at argparse and in
    ``run``; the reference's launcher takes them and raises AttributeError
    on the same arguments (both draw random assignments: the offline
    samples, the model's profiling samples)."""
    args = ["--app", "structural", "--agent", agent, "--fleet", "1", "--epochs",
            "1", "--offline", "4", "--offline-updates", "1"]
    with pytest.raises(SystemExit):
        drl_control.main(["--device", "cpu", *args])
    assert message in capsys.readouterr().err
    with pytest.raises(ValueError, match=message):
        drl_control.run(app="structural", agent=agent, fleet=1, epochs=1,
                        offline=4, offline_updates=1, device="cpu")
    monkeypatch.setattr(sys, "argv", ["drl_control", *args])
    with pytest.raises(AttributeError, match="random_assignment"):
        jax_drl_control.main()


def test_launcher_runs_structural_ddpg_without_offline_pretraining(capsys):
    """What the refusal advises: ``--offline 0`` runs DDPG on the
    structural env, every lane scored under its own DAG."""
    res = drl_control.main(["--device", "cpu", "--app", "structural", "--agent",
                            "ddpg", "--offline", "0", "--scenario", "dag_shapes",
                            "--fleet", "3", "--epochs", "2", "--k", "4"])
    assert "final latency" in capsys.readouterr().out
    assert res["seconds"]["offline"] < 1.0 and np.isfinite(res["finals"]).all()
    assert len(set(res["rrs"])) == 3
