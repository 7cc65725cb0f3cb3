"""The port's scenario layer against the reference: the perturbation
helpers, the named scenario fleets, lane-stacked EnvParams through the
simulator and the env, and scenario fleets through the online loop."""
import jax
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, carried_fleet,
                               cfg_pair, env_pair, jax_epoch_draws,
                               jax_tree_numpy, numpy_epoch_draws, to_numpy,
                               to_torch, torch)

from repro.core import make_agent as jax_make_agent
from repro.core.agent import run_online_fleet as jax_run_online_fleet
from repro.dsdps import scenarios as jscen
from repro.dsdps import simulator as jsim
from repro_torch.core import EpochDraws, make_agent, run_online_fleet
from repro_torch.core.convert import env_params_from_numpy
from repro_torch.dsdps import scenarios as tscen
from repro_torch.dsdps import simulator as tsim
from repro_torch.dsdps.workload import step_rates

# the builders' float32 products and sines: exp and sin of XLA and of
# torch may differ in the last ulp
RTOL = 1e-6
NAMES = sorted(tscen.SCENARIOS)


@pytest.fixture(scope="module")
def envs():
    return env_pair("cq_small")


def assert_params(got, want, rtol=RTOL):
    """Every field: same shape and dtype, values at ``rtol``."""
    for f in tsim.EnvParams._fields:
        g, w = to_numpy(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w.shape and g.dtype == w.dtype, f
        np.testing.assert_allclose(g, w, rtol=rtol, err_msg=f)


def mixed_draws(seed, fleet, N, S):
    """The reference mixed()'s per-lane draws: fold_in(PRNGKey(seed), i)
    split into (service key, rate key)."""
    svc, rate = [], []
    for i in range(fleet):
        k_svc, k_rate = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), i))
        svc.append(np.asarray(jax.random.normal(k_svc, (N,))))
        rate.append(np.asarray(jax.random.normal(k_rate, (S,))))
    return to_torch(np.stack(svc)), to_torch(np.stack(rate))


def test_perturb_helpers_match_reference(envs):
    jenv, tenv = envs
    jp, tp = jenv.default_params(), tenv.default_params()
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    z_svc = jax.random.normal(k1, (jenv.N,))
    z_rate = jax.random.normal(k2, (jenv.workload.num_spouts,))
    assert_params(tsim.perturb_service(tp, to_torch(z_svc), 0.2),
                  jsim.perturb_service(jp, k1, 0.2))
    assert_params(tsim.perturb_rates(tp, to_torch(z_rate)),
                  jsim.perturb_rates(jp, k2))
    # drawn from a generator: the mean-1 lognormal of the given sigma
    g = torch.Generator().manual_seed(0)
    tp1 = tsim.perturb_service(tp, sigma=0.1, gen=g)
    ratio = to_numpy(tp1.service_ms / tp.service_ms)
    assert np.all(ratio > 0) and not np.allclose(ratio, 1.0)


@pytest.mark.parametrize("broadcast_invariant", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_scenario_builders_match_reference(envs, name, broadcast_invariant):
    jenv, tenv = envs
    F = 5
    kwargs = {}
    if name == "mixed":
        svc, rate = mixed_draws(3, F, jenv.N, jenv.workload.num_spouts)
        kwargs = dict(service_z=svc, rate_z=rate)
        want = jscen.build(name, jenv, F, broadcast_invariant, seed=3)
    else:
        want = jscen.build(name, jenv, F, broadcast_invariant)
    got = tscen.build(name, tenv, F, broadcast_invariant, **kwargs)
    assert_params(got, want)
    # the same fields stay single-copy on both sides
    assert (tsim.params_in_axes(got, tenv.default_params()) is None) == (
        jsim.params_in_axes(want, jenv.default_params()) is None)


def test_scenario_options_and_names(envs):
    jenv, tenv = envs
    assert_params(tscen.build("one_slow_machine", tenv, 3, factor=0.25),
                  jscen.build("one_slow_machine", jenv, 3, factor=0.25))
    assert_params(tscen.build("diurnal_rate", tenv, 4, amplitude=0.2),
                  jscen.build("diurnal_rate", jenv, 4, amplitude=0.2))
    assert_params(tscen.build("high_noise", tenv, 2, sigma=0.3),
                  jscen.build("high_noise", jenv, 2, sigma=0.3))
    assert_params(tscen.workload_shift(tenv, 1.5), jscen.workload_shift(jenv, 1.5))
    assert tscen.scenario_names(tenv) == jscen.scenario_names(jenv)
    with pytest.raises(KeyError, match="unknown scenario"):
        tscen.build("nope", tenv, 2)
    # mixed from a generator: seeded, reproducible, lanes differ
    a = tscen.build("mixed", tenv, 4, seed=1)
    b = tscen.build("mixed", tenv, 4, seed=1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.service_ms[0], a.service_ms[1])


def test_params_in_axes_and_lane_params(envs):
    """Per-field broadcast stacking: invariant fields stay single-copy, the
    axes helper says which fields are stacked, and lane extraction gives
    a whole single scenario (the reference's test_core_api :165)."""
    _, env = envs
    p = env.default_params()
    lanes = [tsim.with_straggler(p, i % env.M, 0.5 + 0.1 * i) for i in range(3)]
    full = tsim.stack_env_params(lanes)
    bc = tsim.stack_env_params(lanes, broadcast_invariant=True)
    assert tsim.params_in_axes(p, p) is None and not tsim.params_stacked(p, p)
    assert all(tsim.params_in_axes(full, p))
    ax = tsim.params_in_axes(bc, p)
    assert ax.speed and not ax.routing and not ax.flow_solve
    assert bc.routing.shape == p.routing.shape
    assert bc.speed.shape == (3, env.M)
    assert tsim.params_stacked(bc, p)
    assert tsim.params_lanes(bc, p) == 3 and tsim.params_lanes(p, p) is None
    for params in (full, bc):
        lp = tsim.lane_params(params, p, 1)
        assert_exact(lp.speed, lanes[1].speed)
        assert_exact(lp.routing, p.routing)
        assert all(a.shape == b.shape for a, b in zip(lp, p))
    assert_exact(tsim.lane_params(p, p, 0).speed, p.speed)
    with pytest.raises(ValueError, match="disagree"):
        tsim.params_lanes(bc._replace(noise_sigma=torch.ones(2)), p)


def test_env_params_from_numpy_takes_a_stacked_reference(envs):
    """The reference's broadcast-invariant stack carries across as is, and
    equals the port's own stack of the same scenario."""
    jenv, tenv = envs
    jp = jscen.build("one_slow_machine", jenv, 4, broadcast_invariant=True)
    tp = env_params_from_numpy(jax_tree_numpy(jp), "cpu")
    assert tp.routing.shape == (jenv.N, jenv.N) and tp.speed.shape == (4, jenv.M)
    ours = tscen.build("one_slow_machine", tenv, 4, broadcast_invariant=True)
    for a, b in zip(tp, ours):
        assert_exact(a, b)


def _varied_lanes(env, F):
    """F single scenarios, each field that a scenario can vary varied."""
    p = env.default_params()
    g = torch.Generator().manual_seed(7)
    lanes = []
    for i in range(F):
        lane = tsim.perturb_rates(tsim.perturb_service(p, sigma=0.2, gen=g),
                                  sigma=0.2, gen=g)
        lane = tsim.with_straggler(lane, i % env.M, 0.3 + 0.1 * i)
        lane = tsim.with_noise_sigma(lane, 0.02 + 0.03 * i)
        lane = lane._replace(rate_jitter=torch.tensor(0.02 * (i + 1)),
                             rate_revert=torch.tensor(0.1 * (i + 1)),
                             shift_epoch=torch.tensor(i, dtype=torch.int32),
                             shift_factor=torch.tensor(1.0 + 0.2 * i))
        lanes.append(lane)
    return lanes


@pytest.mark.parametrize("broadcast_invariant", [False, True])
def test_env_reads_stacked_fields_lane_by_lane(envs, broadcast_invariant):
    """reset, state_vector, evaluate, step and step_rates under a stack of
    5 lanes equal each lane run alone under its own scenario, exactly."""
    _, env = envs
    F = 5
    lanes = _varied_lanes(env, F)
    params = tsim.stack_env_params(lanes, broadcast_invariant)
    rng = np.random.default_rng(0)
    X = to_torch(np.eye(env.M, dtype=np.float32)[rng.integers(0, env.M, (F, env.N))])
    meas_z = to_torch(rng.normal(size=(F, 5)).astype(np.float32))
    rate_z = to_torch(rng.normal(size=(F, env.workload.num_spouts)).astype(np.float32))
    s = env.reset(F, params)
    s = s._replace(epoch=torch.arange(F, dtype=torch.int32) + 1)
    out = env.step(s, X, params, meas_z=meas_z, rate_z=rate_z)
    vec = env.state_vector(out.state, params)
    ev = env.evaluate(X, s.w, params=params)
    w_next = step_rates(s.w, s.epoch, params.base_rates, params.rate_jitter,
                        params.rate_revert, params.shift_epoch,
                        params.shift_factor, rate_z)
    for f, lane in enumerate(lanes):
        s1 = env.reset(1, lane)
        assert_exact(s.w[f], s1.w[0])
        assert_exact(s.speed[f], s1.speed[0])
        s1 = s1._replace(epoch=s.epoch[f:f + 1])
        o1 = env.step(s1, X[f:f + 1], lane, meas_z=meas_z[f:f + 1],
                      rate_z=rate_z[f:f + 1])
        assert_exact(out.latency_ms[f], o1.latency_ms[0])
        assert_exact(out.state.w[f], o1.state.w[0])
        assert_exact(vec[f], env.state_vector(o1.state, lane)[0])
        assert_exact(ev[f], env.evaluate(X[f], s.w[f], params=lane))
        assert_exact(w_next[f], step_rates(
            s.w[f:f + 1], s.epoch[f:f + 1], lane.base_rates, lane.rate_jitter,
            lane.rate_revert, lane.shift_epoch, lane.shift_factor,
            rate_z[f:f + 1])[0])


def test_noise_sigma_per_lane_at_five_lanes(envs):
    """Five lanes with five measurement noises: lane f's readings are
    scaled by its own sigma, not by the sigma of measurement f (at F = 5
    the two broadcasts have the same shape)."""
    _, env = envs
    p = env.default_params()
    sigmas = [0.01, 0.05, 0.1, 0.2, 0.4]
    params = tsim.stack_env_params([tsim.with_noise_sigma(p, s) for s in sigmas],
                                   broadcast_invariant=True)
    assert params.noise_sigma.shape == (5,) and params.routing.dim() == 2
    X = env.round_robin_assignment().expand(5, env.N, env.M)
    w = p.base_rates.expand(5, -1)
    z = to_torch(np.random.default_rng(1).normal(size=(5, 5)).astype(np.float32))
    got = tsim.measured_latency_from_params(X, w, params, env.params,
                                            env.cluster, z)
    base = env.evaluate(X[0], w[0])
    for f, s in enumerate(sigmas):
        one = tsim.measured_latency_from_params(
            X[f], w[f], tsim.with_noise_sigma(p, s), env.params, env.cluster,
            z[f])
        assert_exact(got[f], one)
        assert_f32(got[f], base * torch.exp(z[f] * s).mean(), rtol=1e-6)


def _lane_state(agent, states, f):
    """Lane f of a fleet's initial state as a fleet of one (a copy)."""
    if isinstance(states, torch.Tensor):
        return states[f:f + 1].clone()
    from repro_torch.core import convert
    to_np, from_np = {"ddpg": (convert.ddpg_state_to_numpy,
                               convert.ddpg_state_from_numpy),
                      "dqn": (convert.dqn_state_to_numpy,
                              convert.dqn_state_from_numpy)}[agent.name]
    return from_np(jax.tree.map(lambda x: x[f:f + 1], to_np(states)), "cpu")


AGENT_OVERRIDES = {"ddpg": dict(k_nn=6, batch=8), "dqn": dict(batch=8),
                   "round_robin": {}, "model_based": dict(fit_samples=40)}


@pytest.mark.parametrize("name", sorted(AGENT_OVERRIDES))
def test_heterogeneous_fleet_lane_equals_single_run(envs, name):
    """Lane f of a 5-lane fleet under five different scenarios equals a
    fleet of one run with lane f's scenario, state and draws, exactly
    (the reference's test_core_api :132)."""
    _, env = envs
    F, T, U = 5, 6, 1
    lanes = _varied_lanes(env, F)
    params = tsim.stack_env_params(lanes, broadcast_invariant=True)
    agent = make_agent(name, env, **AGENT_OVERRIDES[name])
    B = getattr(agent.cfg, "batch", 1)
    draws = numpy_epoch_draws(np.random.default_rng(3), F, T, U, B, env.N, env.M,
                   env.workload.num_spouts)
    init = agent.init_fleet(torch.Generator().manual_seed(2), F, "cpu",
                            env_params=params)
    singles = [_lane_state(agent, init, f) for f in range(F)]
    _, fleet = run_online_fleet(0, env, agent, init, T, updates_per_epoch=U,
                                env_params=params, draws=draws)
    for f in range(F):
        _, one = run_online_fleet(
            0, env, agent, singles[f], T, updates_per_epoch=U,
            env_params=lanes[f],
            draws=[EpochDraws(*(x[f:f + 1] for x in d)) for d in draws])
        np.testing.assert_array_equal(fleet.latencies[f], one.latencies[0])
        np.testing.assert_array_equal(fleet.rewards[f], one.rewards[0])
        np.testing.assert_array_equal(fleet.moved[f], one.moved[0])
        np.testing.assert_array_equal(fleet.final_assignment[f],
                                      one.final_assignment[0])
    # the scenarios really differ
    assert len({fleet.latencies[f].tobytes() for f in range(F)}) == F


@pytest.mark.parametrize("name", ["ddpg", "dqn", "model_based"])
def test_broadcast_invariant_fleet_equals_full_stack(envs, name):
    """The single-copy fields broadcast to the same traces, bit for bit,
    as the fully stacked fleet (the reference's test_core_api :198, where
    XLA's two lowerings differ in the last ulp; here they do not)."""
    _, env = envs
    F, T = 3, 6
    full = tscen.build("one_slow_machine", env, F)
    bc = tscen.build("one_slow_machine", env, F, broadcast_invariant=True)
    assert full.routing.dim() == 3 and bc.routing.dim() == 2
    agent = make_agent(name, env, **AGENT_OVERRIDES[name])
    B = getattr(agent.cfg, "batch", 1)
    draws = numpy_epoch_draws(np.random.default_rng(4), F, T, 1, B, env.N, env.M,
                   env.workload.num_spouts)
    runs = []
    for params in (full, bc):
        states = agent.init_fleet(torch.Generator().manual_seed(0), F, "cpu",
                                  env_params=params)
        runs.append(run_online_fleet(0, env, agent, states, T,
                                     env_params=params, draws=draws)[1])
    for attr in ("rewards", "latencies", "moved", "final_assignment"):
        np.testing.assert_array_equal(getattr(runs[0], attr),
                                      getattr(runs[1], attr))


def test_mixed_fleet_matches_reference_run_online_fleet(envs):
    """DDPG under the reference's mixed scenario fleet (broadcast-invariant,
    carried across), cq_small, F=4, T=6, from carried init states with the
    reference's draws replayed: the slice's path against the reference's
    run_online_fleet with env_params."""
    jenv, tenv = envs
    jcfg, tcfg = cfg_pair(jenv)
    F, T = 4, 6
    jparams = jscen.build("mixed", jenv, F, broadcast_invariant=True)
    tparams = env_params_from_numpy(jax_tree_numpy(jparams), "cpu")
    js, ts = carried_fleet(jcfg, F, seed=5)
    keys = jax.random.split(jax.random.PRNGKey(12), F)
    _, jh = jax_run_online_fleet(keys, jenv, jax_make_agent("ddpg", jenv, cfg=jcfg),
                                 js, T=T, env_params=jparams)
    draws = jax_epoch_draws(keys, T=T, U=1, B=jcfg.batch, N=jenv.N, M=jenv.M,
                            S=jenv.workload.num_spouts, eps=jcfg.eps,
                            cap=jcfg.buffer)
    _, th = run_online_fleet(0, tenv, make_agent("ddpg", tenv, cfg=tcfg), ts, T,
                             env_params=tparams, draws=draws)
    assert_exact(th.moved, jh.moved)
    assert_exact(th.final_assignment, jh.final_assignment)
    # rtol 1e-4 as the uniform loop's test: six epochs of learning
    # compound the float32 reduction-order differences
    assert_f32(th.latencies, jh.latencies, rtol=1e-4)
    # every lane ran its own scenario: the lanes' first latencies differ
    assert len(set(np.round(th.latencies[:, 0], 6))) == F
