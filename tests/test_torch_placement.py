"""The port's expert-placement env against the reference: the cost model,
``step`` on the reference's draws, the scenario helpers and fleets,
``sample_perturbed``, the lane-stacked params helpers, every agent the
reference's launcher runs on it through ``run_online_fleet`` (and DDPG's
offline pretraining) from carried states with the reference's draws
replayed, a scenario lane against its single run, and the launcher with
its refusals beside the reference's."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, assert_tree_f32,
                               assert_tree_scaled, jax_epoch_draws,
                               jax_offline_draws, jax_tree_numpy,
                               numpy_epoch_draws, to_torch, torch)

from repro.core import ddpg as jddpg
from repro.core import dqn as jdqn
from repro.core import exploration as jexpl
from repro.core import make_agent as jax_make_agent
from repro.core import placement as jpl
from repro.core import stream_ac as jac
from repro.core import stream_q as jsq
from repro.core.agent import run_online_fleet as jax_run_online_fleet
from repro.dsdps import scenarios as jscen
from repro.dsdps import simulator as jsim
from repro.launch import drl_control as jax_drl_control
from repro_torch.core import (EpochDraws, ExpertPlacementEnv, PlacementParams,
                              jamba_placement_env, make_agent,
                              run_online_fleet)
from repro_torch.core import convert
from repro_torch.core import ddpg as tddpg
from repro_torch.core import dqn as tdqn
from repro_torch.core import exploration as texpl
from repro_torch.core import placement as tpl
from repro_torch.core import stream_ac as tac
from repro_torch.core import stream_q as tsq
from repro_torch.dsdps import (lane_params, params_in_axes, scenarios,
                               stack_env_params)
from repro_torch.dsdps.simulator import params_lanes
from repro_torch.launch import drl_control

# the cost model is a few float32 products and sums of up to 16 terms
# (1.2 GFLOP a token times up to 65,536 tokens): computed in the
# reference's order, within a few ulps
COST_RTOL = 1e-6
# learning loops: forward and backward passes reduce in another order
# than XLA's (the rule of the other loop tests)
RTOL = 1e-5
PARAM_ATOL = 0.02 * 1e-3
AGENTS = ("ddpg", "dqn", "round_robin", "stream_q", "stream_ac")
PLACEMENT_NAMES = ("mixed", "one_slow_device", "skewed_routing",
                   "traffic_surge", "uniform")


@pytest.fixture(scope="module")
def envs():
    """(reference env, port env on the CPU) of Jamba-1.5-large's 16
    experts on 16 devices."""
    return jpl.jamba_placement_env(), jamba_placement_env(device="cpu")


def _onehot(rng, shape, M):
    return np.eye(M, dtype=np.float32)[rng.integers(0, M, shape)]


def _skew_z(seed: int, fleet: int, E: int) -> torch.Tensor:
    """The reference's per-lane skew draws of a named fleet: lane i from
    ``fold_in(PRNGKey(seed), i)``."""
    key = jax.random.PRNGKey(seed)
    return to_torch(np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (E,))) for i in range(fleet)]))


# --------------------------------------------------------------------------
# the env
# --------------------------------------------------------------------------
def test_base_load_and_default_params_match_reference(envs):
    jenv, tenv = envs
    assert (tenv.N, tenv.M, tenv.state_dim, tenv.action_dim) == (
        jenv.N, jenv.M, jenv.state_dim, jenv.action_dim) == (16, 16, 272, 256)
    assert_exact(tenv._base_load, jenv._base_load)
    assert_tree_f32(convert.placement_params_to_numpy(tenv.default_params()),
                    jax_tree_numpy(jenv.default_params()), rtol=0)
    assert tpl.PEAK_FLOPS == jpl.PEAK_FLOPS and tpl.ICI_BW == jpl.ICI_BW
    assert_exact(tenv.round_robin_assignment(), jenv.round_robin_assignment())
    # a small env of another size and skew, from another seed
    small = dict(num_experts=6, num_devices=4, flops_per_token=3e6,
                 bytes_per_token=64, tokens_per_step=4096, skew=1.3, seed=5)
    assert_exact(ExpertPlacementEnv(**small, device="cpu")._base_load,
                 jpl.ExpertPlacementEnv(**small)._base_load)


def test_cost_model_matches_reference_on_random_assignments(envs):
    """state_vector, step_time_ms and evaluate on random one-hot X, random
    loads and speeds with stragglers, lane by lane against the reference;
    the max runs over each lane's devices, never across lanes."""
    jenv, tenv = envs
    rng = np.random.default_rng(0)
    F = 6
    X = _onehot(rng, (F, jenv.N), jenv.M)
    w = (np.asarray(jenv._base_load) * rng.uniform(0.2, 3.0, (F, jenv.N))
         ).astype(np.float32)
    speed = np.ones((F, jenv.M), np.float32)
    speed[np.arange(F), rng.integers(0, jenv.M, F)] = rng.uniform(0.2, 0.9, F)
    state = tpl.PlacementState(X=to_torch(X), w=to_torch(w),
                               epoch=torch.zeros(F, dtype=torch.int32),
                               speed=to_torch(speed))
    sv = tenv.state_vector(state)
    got_t = tenv.step_time_ms(to_torch(X), to_torch(w), to_torch(speed))
    got_e = tenv.evaluate(to_torch(X), to_torch(w), to_torch(speed))
    got_nominal = tenv.evaluate(to_torch(X), to_torch(w))
    for f in range(F):
        js = jpl.PlacementState(X=jnp.asarray(X[f]), w=jnp.asarray(w[f]),
                                epoch=jnp.zeros((), jnp.int32),
                                speed=jnp.asarray(speed[f]))
        assert_f32(sv[f], jenv.state_vector(js), rtol=COST_RTOL)
        want = jenv.step_time_ms(jnp.asarray(X[f]), jnp.asarray(w[f]),
                                 jnp.asarray(speed[f]))
        assert_f32(got_t[f], want, rtol=COST_RTOL)
        assert_f32(got_e[f], want, rtol=COST_RTOL)
        assert_f32(got_nominal[f], jenv.evaluate(jnp.asarray(X[f]),
                                                 jnp.asarray(w[f])),
                   rtol=COST_RTOL)
        # one lane alone gives what it gives in the batch
        assert_exact(tenv.step_time_ms(to_torch(X[f]), to_torch(w[f]),
                                       to_torch(speed[f])), got_t[f])
    # a straggler lane's speeds read through the params
    p = tpl.with_device_straggler(tenv.default_params(), 3, 0.25)
    jp = jpl.with_device_straggler(jenv.default_params(), 3, 0.25)
    assert_f32(tenv.evaluate(to_torch(X), to_torch(w), params=p),
               [jenv.evaluate(jnp.asarray(x), jnp.asarray(v), params=jp)
                for x, v in zip(X, w)], rtol=COST_RTOL)
    # with_straggler on a state slows the same device of every lane
    slow = tenv.with_straggler(tenv.reset(2), 5, 0.3)
    want = jenv.with_straggler(jenv.reset(jax.random.PRNGKey(0)), 5, 0.3)
    for f in range(2):
        assert_exact(slow.speed[f], want.speed)


def test_step_matches_reference_on_its_draws(envs):
    """From random states under stacked one_slow_device params, ``step``
    with the reference's (noise, drift) draws: moves and ``moved`` exact,
    step times, rewards and the next loads within COST_RTOL."""
    jenv, tenv = envs
    rng = np.random.default_rng(1)
    F = 4
    jparams = jpl.build_scenario("one_slow_device", jenv, F)
    tparams = convert.placement_params_from_numpy(jax_tree_numpy(jparams), "cpu")
    X0 = _onehot(rng, (F, jenv.N), jenv.M)
    A = X0.copy()
    A[:, :5] = _onehot(rng, (F, 5), jenv.M)              # re-place a few
    keys = jax.random.split(jax.random.PRNGKey(3), F)
    meas, drift = [], []
    for k in keys:
        k_noise, k_w = jax.random.split(k)
        meas.append(np.asarray(jax.random.normal(k_noise, ())))
        drift.append(np.asarray(jax.random.normal(k_w, (jenv.N,))))
    ts = tenv.reset(F, tparams, X0=None)._replace(X=to_torch(X0))
    out = tenv.step(ts, to_torch(A), tparams, meas_z=to_torch(np.stack(meas)),
                    rate_z=to_torch(np.stack(drift)))
    assert out.moved.sum() > 0
    for f in range(F):
        jp = jsim.lane_params(jparams, jenv.default_params(), f)
        js = jenv.reset(keys[f], jp, X0=jnp.asarray(X0[f]))
        jo = jenv.step(keys[f], js, jnp.asarray(A[f]), jp)
        assert_exact(out.moved[f], jo.moved)
        assert_exact(out.state.X[f], jo.state.X)
        assert_exact(out.state.epoch[f], jo.state.epoch)
        assert_exact(out.state.speed[f], jo.state.speed)
        assert_f32(out.latency_ms[f], jo.latency_ms, rtol=COST_RTOL)
        assert_f32(out.reward[f], jo.reward, rtol=COST_RTOL)
        assert_f32(out.state.w[f], jo.state.w, rtol=COST_RTOL)


def test_step_draws_from_a_generator_in_order(envs):
    """Without passed draws ``step`` takes the noise [F] and then the drift
    [F, E] from the generator: the same as passing those two draws."""
    _, env = envs
    s = env.reset(3)
    a = env.random_assignment(3, torch.Generator().manual_seed(1))
    got = env.step(s, a, gen=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(2)
    meas = torch.randn(3, generator=g)
    drift = torch.randn(3, env.N, generator=g)
    want = env.step(s, a, meas_z=meas, rate_z=drift)
    assert_exact(got.latency_ms, want.latency_ms)
    assert_exact(got.state.w, want.state.w)


# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", PLACEMENT_NAMES)
@pytest.mark.parametrize("broadcast_invariant", [False, True])
def test_scenario_fleets_match_reference(envs, name, broadcast_invariant):
    """Every named fleet, stacked or broadcast-invariant, against the
    reference's; skewed_routing and mixed on the reference's fold_in
    draws."""
    jenv, tenv = envs
    F = 5
    kw = ({"skew_z": _skew_z(0, F, jenv.N)}
          if name in ("skewed_routing", "mixed") else {})
    want = jax_tree_numpy(jpl.build_scenario(
        name, jenv, F, broadcast_invariant=broadcast_invariant))
    got = scenarios.build_for(tenv, name, F,
                              broadcast_invariant=broadcast_invariant, **kw)
    assert isinstance(got, PlacementParams)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert_f32(g, w, rtol=COST_RTOL)


def test_scenario_helpers_match_reference(envs):
    jenv, tenv = envs
    jp, tp = jenv.default_params(), tenv.default_params()
    pairs = [
        (tpl.with_device_straggler(tp, 7, 0.4), jpl.with_device_straggler(jp, 7, 0.4)),
        (tpl.scale_load(tp, 1.3), jpl.scale_load(jp, 1.3)),
        (tpl.with_placement_noise(tp, 0.05), jpl.with_placement_noise(jp, 0.05)),
    ]
    for got, want in pairs:
        assert_tree_f32(convert.placement_params_to_numpy(got),
                        jax_tree_numpy(want), rtol=0)
    key = jax.random.PRNGKey(9)
    got = tpl.perturb_skew(tp, to_torch(np.asarray(jax.random.normal(
        key, (jenv.N,)))), 0.3)
    assert_f32(got.base_load, jpl.perturb_skew(jp, key, 0.3).base_load,
               rtol=COST_RTOL)
    # a generator's draw, the same one twice
    a = tpl.perturb_skew(tp, gen=torch.Generator().manual_seed(4))
    b = tpl.perturb_skew(tp, to_torch(torch.randn(
        jenv.N, generator=torch.Generator().manual_seed(4))))
    assert_exact(a.base_load, b.base_load)
    assert_exact(tp.base_load, jenv.default_params().base_load)  # not mutated


def _reference_sample_draws(jenv, key, straggler_prob=0.25):
    k_skew, k_load, k_slow, k_d = jax.random.split(key, 4)
    return dict(skew_z=to_torch(np.asarray(jax.random.normal(k_skew, (jenv.N,)))),
                load_z=to_torch(np.asarray(jax.random.normal(k_load))),
                straggler=bool(jax.random.bernoulli(k_slow, straggler_prob)),
                device=int(jax.random.randint(k_d, (), 0, jenv.M)))


def test_sample_perturbed_matches_reference_on_its_draws(envs):
    """Twelve keys, some with a straggler and some without: the port's
    sample on the reference's four draws equals the reference's sample;
    ``perturb_sampler`` curries the same."""
    jenv, tenv = envs
    coins = []
    sampler = scenarios.perturb_sampler(tenv, straggler_factor=0.3)
    for i in range(12):
        key = jax.random.PRNGKey(100 + i)
        d = _reference_sample_draws(jenv, key)
        coins.append(d["straggler"])
        want = jax_tree_numpy(jscen.sample_perturbed(jenv, key))
        got = scenarios.sample_perturbed(tenv, **d)
        for g, w in zip(got, want):
            assert_f32(g, w, rtol=COST_RTOL)
        want = jax_tree_numpy(jscen.perturb_sampler(
            jenv, straggler_factor=0.3)(key))
        for g, w in zip(sampler(**d), want):
            assert_f32(g, w, rtol=COST_RTOL)
    assert any(coins) and not all(coins)
    # the draws from a generator, in order (skew, load, coin, device)
    g1 = scenarios.sample_perturbed(tenv, gen=torch.Generator().manual_seed(3),
                                    straggler_prob=1.0)
    g = torch.Generator().manual_seed(3)
    skew, load = torch.randn(jenv.N, generator=g), torch.randn((), generator=g)
    torch.rand((), generator=g)
    dev = int(torch.randint(0, jenv.M, (), generator=g))
    g2 = scenarios.sample_perturbed(tenv, skew_z=skew, load_z=load, straggler=True,
                                    device=dev)
    for a, b in zip(g1, g2):
        assert_exact(a, b)


def test_scenario_names_and_dag_shapes_refusal_match_reference(envs):
    jenv, tenv = envs
    assert scenarios.scenario_names(tenv) == jscen.scenario_names(jenv) == \
        PLACEMENT_NAMES
    with pytest.raises(KeyError, match="unknown placement scenario 'dag_shapes'"):
        jscen.build_for(jenv, "dag_shapes", 2)
    with pytest.raises(KeyError, match="unknown placement scenario 'dag_shapes'"):
        scenarios.build_for(tenv, "dag_shapes", 2)


def test_stacking_helpers_take_placement_params(envs):
    """stack_env_params, params_in_axes, params_lanes and lane_params on
    PlacementParams: the scalar noise levels stack to [F], and a
    broadcast-invariant stack keeps the fields no lane changes single."""
    jenv, tenv = envs
    F = 3
    ref = tenv.default_params()
    lanes = tpl._pl_mixed(tenv, F, skew_z=_skew_z(0, F, jenv.N))
    full = stack_env_params(lanes)
    assert [tuple(x.shape) for x in full] == [(F, 16), (F, 16), (F,), (F,)]
    bi = stack_env_params(lanes, broadcast_invariant=True)
    assert tuple(params_in_axes(bi, ref)) == (True, True, True, False)
    jbi = jpl.build_scenario("mixed", jenv, F, broadcast_invariant=True)
    assert tuple(x.ndim for x in bi) == tuple(np.ndim(x) for x in jbi)
    assert params_lanes(full, ref) == params_lanes(bi, ref) == F
    assert params_in_axes(ref, ref) is None and params_lanes(ref, ref) is None
    for f in range(F):
        for a, b, c in zip(lane_params(full, ref, f), lane_params(bi, ref, f),
                           lanes[f]):
            assert_exact(a, c)
            assert_exact(b, c)
    # the env reads both forms alike
    s = tenv.reset(F, full)
    a = tenv.random_assignment(F, torch.Generator().manual_seed(0))
    draws = dict(meas_z=torch.randn(F, generator=torch.Generator().manual_seed(1)),
                 rate_z=torch.randn(F, 16, generator=torch.Generator().manual_seed(2)))
    o1 = tenv.step(s, a, full, **draws)
    o2 = tenv.step(tenv.reset(F, bi), a, bi, **draws)
    assert_exact(o1.latency_ms, o2.latency_ms)
    assert_exact(o1.state.w, o2.state.w)


def test_converters_carry_params_and_states(envs):
    jenv, tenv = envs
    jp = jpl.build_scenario("mixed", jenv, 3, broadcast_invariant=True)
    tp = convert.placement_params_from_numpy(jax_tree_numpy(jp), "cpu")
    assert_tree_f32(convert.placement_params_to_numpy(tp), jax_tree_numpy(jp),
                    rtol=0)
    js = jenv.reset(jax.random.PRNGKey(0), jsim.lane_params(
        jp, jenv.default_params(), 1))
    ts = convert.placement_state_from_numpy(jax_tree_numpy(js), "cpu")
    assert ts.fleet == 1 and ts.epoch.dtype == torch.int32
    assert_exact(ts.X[0], js.X)
    assert_exact(ts.w[0], js.w)
    assert_exact(tenv.state_vector(ts, lane_params(tp, tenv.default_params(), 1))[0],
                 jenv.state_vector(js, jsim.lane_params(jp, jenv.default_params(), 1)))


# --------------------------------------------------------------------------
# the agents: against the reference's run_online_fleet
# --------------------------------------------------------------------------
def agent_pair(name, env):
    """(reference config, port config, reference fleet init, port state
    from numpy) of ``name`` at small sizes and short schedules."""
    kw = dict(n_executors=env.N, n_machines=env.M, state_dim=env.state_dim)
    if name == "ddpg":
        return (jddpg.DDPGConfig(**kw, k_nn=8, batch=8),
                tddpg.DDPGConfig(**kw, k_nn=8, batch=8),
                jddpg.init_fleet, convert.ddpg_state_from_numpy)
    if name == "dqn":
        return (jdqn.DQNConfig(**kw, batch=8,
                               eps=jexpl.EpsilonSchedule(decay_epochs=10)),
                tdqn.DQNConfig(**kw, batch=8,
                               eps=texpl.EpsilonSchedule(decay_epochs=10)),
                jdqn.init_fleet, convert.dqn_state_from_numpy)
    if name == "stream_q":
        return (jsq.StreamQConfig(**kw, eps=jexpl.EpsilonSchedule(decay_epochs=4)),
                tsq.StreamQConfig(**kw, eps=texpl.EpsilonSchedule(decay_epochs=4)),
                jsq.init_fleet, convert.stream_q_state_from_numpy)
    if name == "stream_ac":
        return (jac.StreamACConfig(**kw, temp_decay_epochs=4),
                tac.StreamACConfig(**kw, temp_decay_epochs=4),
                jac.init_fleet, convert.stream_ac_state_from_numpy)
    jcfg = jax_make_agent("round_robin", env).cfg
    return (jcfg, make_agent("round_robin", env).cfg,
            lambda key, cfg, F: jnp.zeros((F,), jnp.int32),
            lambda x, device: to_torch(x).to(device))


TO_NUMPY = {"ddpg": convert.ddpg_state_to_numpy, "dqn": convert.dqn_state_to_numpy,
            "stream_q": convert.stream_q_state_to_numpy,
            "stream_ac": convert.stream_ac_state_to_numpy,
            "round_robin": lambda s: s.numpy()}


@pytest.mark.parametrize("name", AGENTS)
def test_fleet_matches_reference_run_online_fleet(envs, name):
    """F=2, T=5 under the mixed fleet (the reference's own params), from
    carried init states, with the reference's draws replayed (ε coin,
    exploration noise, random move, Gumbel, step-time noise, load drift,
    replay rows): moves, ``moved`` and final assignments exact; step times
    and rewards at float32 tolerance; the learners' states too."""
    jenv, tenv = envs
    jcfg, tcfg, jinit, from_numpy = agent_pair(name, jenv)
    F, T = 2, 5
    jparams = jpl.build_scenario("mixed", jenv, F, broadcast_invariant=True)
    tparams = convert.placement_params_from_numpy(jax_tree_numpy(jparams), "cpu")
    js = jinit(jax.random.PRNGKey(4), jcfg, F)
    ts = from_numpy(jax_tree_numpy(js), "cpu")
    keys = jax.random.split(jax.random.PRNGKey(6), F)
    js_end, jh = jax_run_online_fleet(keys, jenv,
                                      jax_make_agent(name, jenv, cfg=jcfg),
                                      js, T=T, env_params=jparams)
    draws = jax_epoch_draws(keys, T=T, U=1, B=getattr(jcfg, "batch", 1),
                            N=jenv.N, M=jenv.M, S=jenv.N,
                            eps=getattr(jcfg, "eps", None),
                            cap=getattr(jcfg, "buffer", 1000), meas_shape=())
    ts_end, th = run_online_fleet(0, tenv, make_agent(name, tenv, cfg=tcfg), ts,
                                  T, env_params=tparams, draws=draws)
    assert_exact(th.moved, jh.moved)
    assert_exact(th.final_assignment, jh.final_assignment)
    assert_f32(th.latencies, jh.latencies, rtol=RTOL)
    assert_f32(th.rewards, jh.rewards, rtol=RTOL)
    if name == "round_robin":
        assert (th.moved == 0).all()
        return
    assert th.moved.sum() > 0
    got, want = TO_NUMPY[name](ts_end), jax_tree_numpy(js_end)
    assert_exact(got.epoch, want.epoch)
    if name in ("ddpg", "dqn"):
        assert_exact(got.replay.actions, want.replay.actions)
        assert_exact(got.replay.ptr, want.replay.ptr)
        nets = ("actor", "critic") if name == "ddpg" else ("qnet", "target")
        for part in nets:
            assert_tree_f32(getattr(got, part), getattr(want, part), rtol=1e-4,
                            atol=PARAM_ATOL)
    else:
        assert_tree_scaled(got, want, rtol=RTOL)


def test_offline_pretrain_matches_reference_on_placement(envs):
    """DDPG's offline pretraining on the placement env (random assignments,
    the env's own step draws), with the reference's draws replayed."""
    jenv, tenv = envs
    jcfg, tcfg, jinit, from_numpy = agent_pair("ddpg", jenv)
    F, n, U = 2, 24, 2
    js = jinit(jax.random.PRNGKey(7), jcfg, F)
    ts = from_numpy(jax_tree_numpy(js), "cpu")
    keys = jax.random.split(jax.random.PRNGKey(8), F)
    draws = jax_offline_draws(keys, n=n, n_updates=U, B=jcfg.batch, N=jenv.N,
                              M=jenv.M, S=jenv.N, cap=jcfg.buffer, meas_shape=())
    assert draws.meas_z.shape == (F, n) and draws.rate_z.shape == (F, n, jenv.N)
    want = jax_tree_numpy(jax.jit(lambda k, s: jddpg.offline_pretrain_fleet(
        k, s, jcfg, jenv, n_samples=n, n_updates=U))(keys, js))
    got = convert.ddpg_state_to_numpy(tddpg.offline_pretrain(
        ts, tcfg, tenv, n_samples=n, n_updates=U, draws=draws))
    assert_exact(got.r_count, want.r_count)
    assert_exact(got.replay.actions, want.replay.actions)
    assert_f32(got.replay.states, want.replay.states, rtol=COST_RTOL)
    assert_f32(got.r_mean, want.r_mean, rtol=RTOL)
    assert_f32(got.replay.rewards, want.replay.rewards, rtol=1e-4, atol=1e-5)
    for part in ("actor", "critic"):
        assert_tree_f32(getattr(got, part), getattr(want, part), rtol=1e-4,
                        atol=PARAM_ATOL)


@pytest.mark.parametrize("name", AGENTS)
def test_scenario_lane_equals_single_run(envs, name):
    """Lane f of a mixed placement fleet equals a fleet of one under lane
    f's scenario from lane f's state: moves and step times bit for bit."""
    _, env = envs
    agent = make_agent(name, env, **({"k_nn": 8, "batch": 8} if name == "ddpg"
                                     else {}))
    F, T = 3, 4
    params = scenarios.build_for(env, "mixed", F, seed=2)
    init = agent.init_fleet(torch.Generator().manual_seed(2), F, "cpu")
    init_np = TO_NUMPY[name](init)
    from_numpy = agent_pair(name, env)[3]
    batch = getattr(agent.cfg, "batch", 1)
    draws = numpy_epoch_draws(np.random.default_rng(8), F, T, 1, batch, env.N,
                              env.M, env.N)
    draws = [d._replace(meas_z=d.meas_z[:, 0]) for d in draws]
    _, fleet = run_online_fleet(0, env, agent, from_numpy(init_np, "cpu"), T,
                                env_params=params, draws=draws)
    for f in range(F):
        lane = (init_np[f:f + 1] if name == "round_robin"
                else convert.lane_arrays(init_np, f))
        _, one = run_online_fleet(
            0, env, agent, from_numpy(lane, "cpu"), T,
            env_params=lane_params(params, env.default_params(), f),
            draws=[EpochDraws(*(x[f:f + 1] for x in d)) for d in draws])
        assert_exact(fleet.moved[f], one.moved[0])
        assert_exact(fleet.latencies[f], one.latencies[0])
        assert_exact(fleet.final_assignment[f], one.final_assignment[0])


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("agent", AGENTS)
def test_launcher_runs_every_agent_on_placement(capsys, agent):
    """``--app placement --scenario mixed`` for each agent the reference's
    launcher runs there; each lane scored under its own params with its
    own base load, round-robin too."""
    res = drl_control.main(["--device", "cpu", "--app", "placement", "--scenario",
                            "mixed", "--agent", agent, "--fleet", "2", "--epochs",
                            "5", "--offline", "40", "--offline-updates", "3"])
    out = capsys.readouterr().out
    assert "final latency" in out and "round-robin" in out
    env, params, hist = res["env"], res["env_params"], res["history"]
    assert isinstance(env, ExpertPlacementEnv) and (env.N, env.M) == (16, 16)
    assert hist.rewards.shape == (2, 5) and np.isfinite(hist.latencies).all()
    rr = env.round_robin_assignment()
    for f in range(2):
        lane_p = lane_params(params, env.default_params(), f)
        assert res["rrs"][f] == float(env.evaluate(rr, lane_p.base_load,
                                                   params=lane_p))
        assert res["finals"][f] == float(env.evaluate(
            torch.as_tensor(hist.final_assignment[f]), lane_p.base_load,
            params=lane_p))
    assert res["rrs"][0] != res["rrs"][1]       # lane 1 slows a device


def test_launcher_scores_a_seed_sweep_as_the_reference_does(envs):
    """No scenario: every lane under the env's own load and unit speeds,
    as the reference scores ``env._base_load`` without params."""
    jenv, _ = envs
    res = drl_control.run(app="placement", agent="round_robin", fleet=2,
                          epochs=2, device="cpu")
    want = float(jenv.evaluate(jenv.round_robin_assignment(), jenv._base_load))
    assert_f32(res["rrs"], [want, want], rtol=COST_RTOL)
    assert_f32(res["finals"], [want, want], rtol=COST_RTOL)


@pytest.mark.parametrize("argv,message", [
    (["--agent", "model_based"], "model_based profiles a DSDPS cluster"),
    (["--agent", "graph_policy"], "graph_policy message-passes over a topology DAG"),
    (["--agent", "ddpg", "--serve", "4"], "--serve drives the DSDPS control plane"),
])
def test_launcher_refuses_what_the_reference_refuses(capsys, monkeypatch, argv,
                                                     message):
    """The reference's three placement refusals, beside the reference's own
    launcher on the same arguments."""
    args = ["--app", "placement", "--fleet", "2", "--epochs", "2", *argv]
    monkeypatch.setattr(sys, "argv", ["drl_control", *args])
    with pytest.raises(SystemExit):
        jax_drl_control.main()
    assert message in capsys.readouterr().err
    with pytest.raises(SystemExit):
        drl_control.main(["--device", "cpu", *args])
    assert message in capsys.readouterr().err
    if "--serve" in argv:
        assert message in drl_control.refusal("placement", "ddpg", serve=4)
    else:
        with pytest.raises(ValueError, match=message):
            drl_control.run(app="placement", agent=argv[1], fleet=2, epochs=2,
                            device="cpu")
