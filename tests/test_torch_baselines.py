"""The port's baselines against the reference: round-robin, the DQN agent
(from reference states carried across, with the reference's draws
replayed) and the model-based scheduler [25] (from a carried theta); the
registry and the launcher with every agent under every scenario."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, assert_tree_f32,
                               env_pair, jax_epoch_draws, jax_fit_draws,
                               jax_tree_numpy,
                               numpy_epoch_draws, to_numpy, to_torch, torch)

from repro.core import dqn as jdqn
from repro.core import exploration as jexpl
from repro.core import make_agent as jax_make_agent
from repro.core import model_based as jmb
from repro.core.round_robin import round_robin as jax_round_robin
from repro.core.agent import run_online_fleet as jax_run_online_fleet
from repro.dsdps import scenarios as jscen
from repro.dsdps.simulator import lane_params as jlane_params
from repro_torch.core import EpochDraws, agent_names, make_agent
from repro_torch.core import dqn as tdqn
from repro_torch.core import model_based as tmb
from repro_torch.core import round_robin as trr
from repro_torch.core import run_online_fleet
from repro_torch.core.convert import (dqn_state_from_numpy, dqn_state_to_numpy,
                                      env_params_from_numpy,
                                      model_based_state_from_numpy)
from repro_torch.core.exploration import epsilon_greedy
from repro_torch.dsdps import lane_params, scenarios
from repro_torch.launch import drl_control

# rtol 1e-5: forward and backward passes reduce in another order than
# XLA's, so losses, gradients and the Adam steps built on them differ in
# the last float32 ulps; PARAM_ATOL as tests/test_torch_ddpg.py: Adam's
# first step lr·g/(|g| + 1e-8) moves by a visible fraction of lr where a
# gradient element is rounding noise around zero (2% of lr = 1e-3)
RTOL = 1e-5
PARAM_ATOL = 0.02 * 1e-3
# the model's features and predictions: float32 sums over executors and
# features in another order than XLA's dots (measured ≤ 1e-6 relative)
MB_RTOL = 1e-5


@pytest.fixture(scope="module")
def envs():
    return env_pair("cq_small")


def dqn_cfg_pair(env, **kw):
    return (jdqn.DQNConfig(n_executors=env.N, n_machines=env.M,
                           state_dim=env.state_dim, **kw),
            tdqn.DQNConfig(n_executors=env.N, n_machines=env.M,
                           state_dim=env.state_dim, **kw))


# --------------------------------------------------------------------------
# round-robin
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,m,alive", [(20, 10, None), (7, 3, None),
                                       (9, 4, [True, False, True, True]),
                                       (3, 5, [False, False, True, False, True])])
def test_round_robin_one_hot_matches_reference(n, m, alive):
    got = trr.round_robin(n, m, None if alive is None else np.asarray(alive),
                          device="cpu")
    assert_exact(got, jax_round_robin(n, m, alive))
    assert got.dtype == torch.float32


def test_round_robin_agent_selects_round_robin(envs):
    _, env = envs
    agent = make_agent("round_robin", env)
    states = agent.init_fleet(None, 3, "cpu")
    _, hist = run_online_fleet(0, env, agent, states, 4)
    X = env.round_robin_assignment().numpy()
    assert all(np.array_equal(x, X) for x in hist.final_assignment)
    assert (hist.moved == 0).all()
    assert_exact(states, torch.zeros(3, dtype=torch.int32))   # not advanced


# --------------------------------------------------------------------------
# DQN
# --------------------------------------------------------------------------
def test_apply_move_and_epsilon_greedy_match_reference(envs):
    jenv, _ = envs
    rng = np.random.default_rng(0)
    F, A = 4, jenv.N * jenv.M
    X = np.eye(jenv.M, dtype=np.float32)[rng.integers(0, jenv.M, (F, jenv.N))]
    moves = rng.integers(0, A, F)
    got = tdqn.apply_move(to_torch(X), to_torch(moves), jenv.M)
    for f in range(F):
        assert_exact(got[f], jdqn.apply_move(jnp.asarray(X[f]),
                                             jnp.asarray(moves[f]), jenv.M))
    q = rng.normal(size=(F, A)).astype(np.float32)
    eps = np.asarray([0.0, 0.3, 0.7, 1.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), F)
    add, rand_a = [], []
    for k, e in zip(keys, eps):          # the reference's split discipline
        k_bern, k_rand = jax.random.split(k)
        add.append(bool(jax.random.bernoulli(k_bern, e)))
        rand_a.append(int(jax.random.randint(k_rand, (), 0, A)))
    got = epsilon_greedy(to_torch(q), to_torch(eps), torch.tensor(add),
                         torch.tensor(rand_a))
    for f in range(F):
        assert_exact(got[f], jexpl.epsilon_greedy(keys[f], jnp.asarray(q[f]),
                                                  jnp.asarray(eps[f])))


def _filled_reference_state(jenv, jcfg, n, seed=0):
    """A reference DQNState after ``n`` stores of random transitions."""
    rng = np.random.default_rng(seed)
    js = jdqn.init_state(jax.random.PRNGKey(seed), jcfg)
    S = jenv.state_dim
    for _ in range(n):
        js = jdqn.store(js, jnp.asarray(rng.uniform(size=S), jnp.float32),
                        jnp.asarray(rng.integers(0, jcfg.num_actions)),
                        jnp.asarray(-rng.uniform(2, 3), jnp.float32),
                        jnp.asarray(rng.uniform(size=S), jnp.float32),
                        reward_scale=jcfg.reward_scale)
    return js


def test_dqn_store_keeps_reward_statistics(envs):
    """Unlike DDPG's, the reference DQN keeps its reward statistics through
    store and update_step; so does the port."""
    jenv, _ = envs
    jcfg, tcfg = dqn_cfg_pair(jenv, batch=8)
    js = _filled_reference_state(jenv, jcfg, 5)
    ts = dqn_state_from_numpy(jax_tree_numpy(js), "cpu")
    rng = np.random.default_rng(9)
    s, sn = (rng.uniform(size=jenv.state_dim).astype(np.float32) for _ in "ab")
    js2 = jdqn.store(js, jnp.asarray(s), jnp.asarray(17), jnp.asarray(-2.5),
                     jnp.asarray(sn), reward_scale=jcfg.reward_scale)
    ts = tdqn.store(ts, to_torch(s[None]), torch.tensor([17]),
                    torch.tensor([-2.5]), to_torch(sn[None]),
                    reward_scale=tcfg.reward_scale)
    got, want = dqn_state_to_numpy(ts), jax.tree.map(lambda x: np.asarray(x)[None],
                                                     jax_tree_numpy(js2))
    assert_exact(got.r_count, want.r_count)
    assert_f32(got.r_mean, want.r_mean, rtol=1e-6)
    assert_f32(got.r_var, want.r_var, rtol=1e-6)
    assert_f32(got.replay.rewards, want.replay.rewards, rtol=1e-6, atol=1e-7)
    assert_exact(got.replay.actions, want.replay.actions)
    k = jax.random.PRNGKey(3)
    js3, _ = jdqn.update_step(k, js2, jcfg)
    idx = jax.random.randint(k, (jcfg.batch,), 0, int(js2.replay.size))
    ts, _ = tdqn.update_step(ts, tcfg, idx=to_torch(np.asarray(idx))[None])
    assert int(js3.r_count) == 6 and int(ts.r_count[0]) == 6
    assert_f32(ts.r_mean, np.asarray(js3.r_mean)[None], rtol=1e-6)


def test_dqn_update_step_matches_reference(envs):
    jenv, _ = envs
    jcfg, tcfg = dqn_cfg_pair(jenv, batch=8)
    js = _filled_reference_state(jenv, jcfg, 12, seed=1)
    ts = dqn_state_from_numpy(jax_tree_numpy(js), "cpu")
    for u in range(3):
        k = jax.random.PRNGKey(10 + u)
        js, jl = jdqn.update_step(k, js, jcfg)
        idx = jax.random.randint(k, (jcfg.batch,), 0, int(js.replay.size))
        ts, tl = tdqn.update_step(ts, tcfg, idx=to_torch(np.asarray(idx))[None])
        assert_f32(tl["loss"][0], jl["loss"], rtol=RTOL)
    want = jax.tree.map(lambda x: np.asarray(x)[None], jax_tree_numpy(js))
    got = dqn_state_to_numpy(ts)
    assert_tree_f32(got.qnet, want.qnet, rtol=RTOL, atol=PARAM_ATOL)
    assert_tree_f32(got.target, want.target, rtol=RTOL, atol=PARAM_ATOL)
    assert_exact(got.opt.step, want.opt.step)


def test_dqn_state_roundtrips_through_numpy(envs):
    jenv, _ = envs
    jcfg, _ = dqn_cfg_pair(jenv)
    js = jdqn.init_fleet(jax.random.PRNGKey(0), jcfg, 2)
    want = jax_tree_numpy(js)
    ts = dqn_state_from_numpy(want, "cpu")
    assert ts.fleet == 2
    assert_tree_f32(dqn_state_to_numpy(ts), want, rtol=0)
    # the target is a copy, not an alias, of the Q-net
    for p, q in zip(ts.qnet.parameters(), ts.target.parameters()):
        assert torch.equal(p, q) and p.data_ptr() != q.data_ptr()
        assert p.requires_grad and not q.requires_grad


def test_dqn_fleet_matches_reference_run_online_fleet(envs):
    """cq_small, F=2, T=8, under a one_slow_machine fleet: the port's DQN
    lanes against the reference's run_online_fleet from carried init
    states, with the reference's draws (ε coin, random move, noise, rate
    walk, replay rows) replayed.  Moves and assignments exact, the Q-nets
    at float32 tolerance after T updates."""
    jenv, tenv = envs
    jcfg, tcfg = dqn_cfg_pair(jenv, batch=8,
                              eps=jexpl.EpsilonSchedule(decay_epochs=10))
    tcfg = tdqn.DQNConfig(**{**tcfg.__dict__,
                             "eps": tdqn.EpsilonSchedule(decay_epochs=10)})
    F, T = 2, 8
    jparams = jscen.build("one_slow_machine", jenv, F, broadcast_invariant=True)
    tparams = env_params_from_numpy(jax_tree_numpy(jparams), "cpu")
    js = jdqn.init_fleet(jax.random.PRNGKey(4), jcfg, F)
    ts = dqn_state_from_numpy(jax_tree_numpy(js), "cpu")
    keys = jax.random.split(jax.random.PRNGKey(6), F)
    js_end, jh = jax_run_online_fleet(keys, jenv,
                                      jax_make_agent("dqn", jenv, cfg=jcfg),
                                      js, T=T, env_params=jparams)
    draws = jax_epoch_draws(keys, T=T, U=1, B=jcfg.batch, N=jenv.N, M=jenv.M,
                            S=jenv.workload.num_spouts, eps=jcfg.eps,
                            cap=jcfg.buffer)
    ts_end, th = run_online_fleet(0, tenv, make_agent("dqn", tenv, cfg=tcfg),
                                  ts, T, env_params=tparams, draws=draws)
    assert_exact(th.moved, jh.moved)
    assert_exact(th.final_assignment, jh.final_assignment)
    assert th.moved.sum() > 0 and (th.moved <= 1).all()
    # rtol 1e-4: eight epochs of learning compound the reduction-order
    # differences, as in the DDPG loop's test
    assert_f32(th.latencies, jh.latencies, rtol=1e-4)
    got, want = dqn_state_to_numpy(ts_end), jax_tree_numpy(js_end)
    assert_exact(got.replay.actions, want.replay.actions)
    assert_tree_f32(got.qnet, want.qnet, rtol=1e-4, atol=PARAM_ATOL)
    assert_tree_f32(got.target, want.target, rtol=1e-4, atol=PARAM_ATOL)


# --------------------------------------------------------------------------
# model-based [25]
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mb(envs):
    """A reference fit on a one_slow_machine fleet's lane 1 (60 samples),
    and its theta carried across."""
    jenv, tenv = envs
    jparams = jscen.build("one_slow_machine", jenv, 3, broadcast_invariant=True)
    tparams = env_params_from_numpy(jax_tree_numpy(jparams), "cpu")
    jp1 = jlane_params(jparams, jenv.default_params(), 1)
    tp1 = lane_params(tparams, tenv.default_params(), 1)
    key = jax.random.PRNGKey(4)
    jtheta = jmb.fit_theta(key, jenv, 60, 1e-3, jp1)
    return dict(jparams=jparams, tparams=tparams, jp1=jp1, tp1=tp1, key=key,
                jtheta=jtheta, ttheta=to_torch(np.asarray(jtheta)))


def test_features_and_predict_latency_match_reference(envs, mb):
    jenv, tenv = envs
    rng = np.random.default_rng(2)
    X = np.eye(jenv.M, dtype=np.float32)[rng.integers(0, jenv.M, (16, jenv.N))]
    w = np.asarray(mb["jp1"].base_rates) * rng.uniform(
        0.7, 1.3, (16, jenv.workload.num_spouts)).astype(np.float32)
    for jp, tp in ((None, None), (mb["jp1"], mb["tp1"])):
        jf = jax.vmap(lambda x, ww: jmb.features(jenv, x, ww, jp))(
            jnp.asarray(X), jnp.asarray(w))
        assert_f32(tmb.features(tenv, to_torch(X), to_torch(w), tp), jf,
                   rtol=MB_RTOL, atol=1e-7)
        jpred = jax.vmap(lambda x, ww: jmb.predict_latency(
            jenv, mb["jtheta"], x, ww, jp))(jnp.asarray(X), jnp.asarray(w))
        assert_f32(tmb.predict_latency(tenv, mb["ttheta"], to_torch(X),
                                       to_torch(w), tp), jpred, rtol=MB_RTOL)
    # a lane-stacked scenario: lane f reads its own fields and theta
    thetas = torch.stack([mb["ttheta"], 2 * mb["ttheta"], -mb["ttheta"]])
    got = tmb.predict_latency(tenv, thetas, to_torch(X[:3]), to_torch(w[:3]),
                              mb["tparams"])
    for f in range(3):
        jp = jlane_params(mb["jparams"], jenv.default_params(), f)
        want = jmb.predict_latency(jenv, jnp.asarray(to_numpy(thetas[f])),
                                   jnp.asarray(X[f]), jnp.asarray(w[f]), jp)
        assert_f32(got[f], want, rtol=MB_RTOL)


def test_fit_theta_from_the_same_samples(envs, mb):
    """The same 60 samples (the reference's draws passed in): features at
    float32 tolerance, and the two fits' predictions on the sample set
    within 1e-4 relative.  theta itself is not compared: the ridge solve
    is ill-conditioned (5M + 8 = 58 unknowns from 60 samples), and the
    two float32 solves differ by ~0.3% of |theta| there."""
    jenv, tenv = envs
    A, Z = jax_fit_draws(mb["key"], 60, jenv.N, jenv.M)
    ttheta = tmb.fit_theta(tenv, 60, 1e-3, mb["tp1"], assignments=A, meas_z=Z)
    assert ttheta.shape == (5 * jenv.M + 8,)
    X = np.eye(jenv.M, dtype=np.float32)[to_numpy(A)]
    w = mb["jp1"].base_rates
    jf = jax.vmap(lambda x: jmb.features(jenv, x, w, mb["jp1"]))(jnp.asarray(X))
    assert_f32(tmb.features(tenv, to_torch(X), mb["tp1"].base_rates, mb["tp1"]),
               jf, rtol=MB_RTOL, atol=1e-7)
    jpred = jax.vmap(lambda x: jmb.predict_latency(
        jenv, mb["jtheta"], x, w, mb["jp1"]))(jnp.asarray(X))
    tpred = tmb.predict_latency(tenv, ttheta, to_torch(X), mb["tp1"].base_rates,
                                mb["tp1"])
    assert_f32(tpred, jpred, rtol=1e-4)
    # the scheduler object fits the same model from the same draws
    sched = tmb.ModelBasedScheduler(tenv, env_params=mb["tp1"]).fit(
        n_samples=60, assignments=A, meas_z=Z)
    assert_exact(sched.theta, ttheta)


def assert_same_choice(t_preds, j_preds, what):
    """The port's argmin equals the reference's, or the two candidates are
    within float32 tolerance of each other under the reference's model (a
    near-tie, where either argmin is right).  Returns the port's index and
    whether it was a near-tie."""
    t_preds, j_preds = to_numpy(t_preds), np.asarray(j_preds)
    t, j = int(t_preds.argmin()), int(j_preds.argmin())
    if t == j:
        return t, False
    np.testing.assert_allclose(j_preds[t], j_preds[j], rtol=MB_RTOL,
                               err_msg=f"{what}: port chose {t}, reference {j}")
    return t, True


def test_sweep_schedule_from_a_carried_theta(envs, mb):
    """The greedy local search from the reference's theta: each step's
    choice equals the reference's (replayed step by step on the
    reference's path), and the final assignment is exact unless a step
    met a near-tie, where the two assignments' predictions are held."""
    jenv, tenv = envs
    jp, tp, jth, tth = mb["jp1"], mb["tp1"], mb["jtheta"], mb["ttheta"]
    w = jp.base_rates
    X = np.asarray(jenv.round_robin_assignment())
    eye = np.eye(jenv.M, dtype=np.float32)
    jpred = jax.jit(jax.vmap(lambda x: jmb.predict_latency(jenv, jth, x, w, jp)))
    ties = 0
    for sweep in range(3):
        for i in range(jenv.N):
            cand = np.repeat(X[None], jenv.M, 0)
            cand[:, i] = eye
            j_preds = jpred(jnp.asarray(cand))
            _, tie = assert_same_choice(
                tmb.predict_latency(tenv, tth, to_torch(cand), tp.base_rates, tp),
                j_preds, f"sweep {sweep} executor {i}")
            ties += tie
            X = cand[int(np.argmin(j_preds))]
    want = jmb.sweep_schedule(jenv.round_robin_assignment(), w, jth, jenv, jp, 3)
    got = tmb.sweep_schedule(tenv.round_robin_assignment(), tp.base_rates, tth,
                             tenv, tp, 3)
    if ties == 0:
        assert_exact(got, want)
    else:
        assert_f32(tmb.predict_latency(tenv, tth, got, tp.base_rates, tp),
                   jmb.predict_latency(jenv, jth, want, w, jp), rtol=MB_RTOL)
    # the fleet search under a lane-stacked scenario: each lane as alone
    thetas = torch.stack([tth, tth * 1.1, tth * 0.9])
    X0 = tenv.round_robin_assignment().expand(3, jenv.N, jenv.M)
    ws = mb["tparams"].base_rates.expand(3, -1)
    fleet = tmb.sweep_schedule_fleet(X0, ws, thetas, tenv, mb["tparams"], 2)
    for f in range(3):
        assert_exact(fleet[f], tmb.sweep_schedule(
            X0[f], ws[f], thetas[f], tenv,
            lane_params(mb["tparams"], tenv.default_params(), f), 2))


def test_model_based_select_from_a_carried_theta(envs, mb):
    """One select of every lane of a one_slow_machine fleet from carried
    thetas, on a random assignment: the best of the N·M moves equals the
    reference's, or (a near-tie) is within float32 tolerance of it."""
    from repro.core.model_based import ModelBasedAgentConfig
    jenv, tenv = envs
    rng = np.random.default_rng(5)
    F = 3
    thetas = np.stack([np.asarray(mb["jtheta"]) * s for s in (1.0, 1.05, 0.95)])
    X = np.eye(jenv.M, dtype=np.float32)[rng.integers(0, jenv.M, (F, jenv.N))]
    w = np.asarray(mb["jparams"].base_rates) * rng.uniform(
        0.8, 1.2, (F, jenv.workload.num_spouts)).astype(np.float32)
    tagent = make_agent("model_based", tenv)
    env_state = tenv.reset(F, mb["tparams"])._replace(X=to_torch(X), w=to_torch(w))
    got, _ = tagent.select_fn(tagent.cfg, model_based_state_from_numpy(thetas, "cpu"),
                              None, env_state, mb["tparams"], True, None, None)
    cand = tmb._candidate_moves(to_torch(X))
    t_preds = tmb.predict_latency(tenv, to_torch(thetas), cand, to_torch(w)[:, None],
                                  mb["tparams"])
    jcfg = ModelBasedAgentConfig(env=jenv)
    for f in range(F):
        jp = jlane_params(mb["jparams"], jenv.default_params(), f)
        j_state = jenv.reset(jax.random.PRNGKey(0), jp)._replace(
            X=jnp.asarray(X[f]), w=jnp.asarray(w[f]))
        want, _ = jmb._agent_select(jax.random.PRNGKey(0), jcfg,
                                    jnp.asarray(thetas[f]), None, j_state, jp, True)
        j_preds = jax.vmap(lambda x: jmb.predict_latency(
            jenv, jnp.asarray(thetas[f]), x, jnp.asarray(w[f]), jp))(
            jnp.asarray(to_numpy(cand[f])))
        _, tie = assert_same_choice(t_preds[f], j_preds, f"lane {f}")
        if not tie:
            assert_exact(got[f], want)
    assert_exact(got.sum(-1), np.ones((F, jenv.N)))


def test_model_based_fleet_is_params_aware(envs):
    """In a straggler fleet every lane fits and searches its own cluster:
    the lanes' thetas differ, and lane f of the fleet equals a fleet of one
    run under lane f's scenario from lane f's theta, exactly (the
    reference's test_core_api :228)."""
    _, env = envs
    F, T = 3, 6
    params = scenarios.build("one_slow_machine", env, F, factor=0.3)
    agent = make_agent("model_based", env, fit_samples=60)
    thetas = agent.init_fleet(torch.Generator().manual_seed(0), F, "cpu",
                              env_params=params)
    assert thetas.shape == (F, 5 * env.M + 8)
    assert not torch.allclose(thetas[0], thetas[1])
    assert not torch.allclose(thetas[1], thetas[2])
    draws = numpy_epoch_draws(np.random.default_rng(1), F, T, 1, 1, env.N,
                              env.M, env.workload.num_spouts)
    _, fleet = run_online_fleet(0, env, agent, thetas.clone(), T,
                                env_params=params, draws=draws)
    for f in range(F):
        lane_p = lane_params(params, env.default_params(), f)
        _, one = run_online_fleet(
            0, env, agent, thetas[f:f + 1].clone(), T, env_params=lane_p,
            draws=[EpochDraws(*(x[f:f + 1] for x in d)) for d in draws])
        np.testing.assert_array_equal(fleet.latencies[f], one.latencies[0])
        np.testing.assert_array_equal(fleet.final_assignment[f],
                                      one.final_assignment[0])
    # the straggler lanes move executors off their own slow machine
    assert fleet.moved.sum() > 0


@pytest.mark.parametrize("name", ["ddpg", "dqn", "round_robin", "model_based"])
def test_registry_agent_runs_five_epochs(envs, name):
    _, env = envs
    overrides = {"model_based": {"fit_samples": 40},
                 "ddpg": {"k_nn": 4}}.get(name, {})
    agent = make_agent(name, env, **overrides)
    assert agent.name == name
    F = 2
    states = agent.init_fleet(torch.Generator().manual_seed(0), F, "cpu")
    _, hist = run_online_fleet(1, env, agent, states, T=5)
    assert hist.rewards.shape == (F, 5)
    assert np.isfinite(hist.rewards).all()
    assert np.array_equal(hist.final_assignment.sum(-1), np.ones((F, env.N)))


def test_registry_lists_builtins_and_rejects_unknown(envs):
    _, env = envs
    assert agent_names() == ("ddpg", "dqn", "graph_policy", "model_based",
                             "round_robin", "stream_ac", "stream_q")
    with pytest.raises(KeyError, match="unknown agent"):
        make_agent("nope", env)
    with pytest.raises(ValueError, match="lanes"):
        run_online_fleet(0, env, make_agent("round_robin", env),
                         torch.zeros(2, dtype=torch.int32), 1,
                         env_params=scenarios.build("one_slow_machine", env, 3))


# --------------------------------------------------------------------------
# the launcher: every agent under every scenario, each lane scored under
# its own scenario
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", sorted(scenarios.SCENARIOS))
@pytest.mark.parametrize("agent", ["ddpg", "dqn", "round_robin", "model_based"])
def test_launcher_runs_every_agent_under_every_scenario(agent, scenario):
    res = drl_control.run(app="cq_small", agent=agent, fleet=2, offline=20,
                          offline_updates=2, epochs=3, k=4, device="cpu",
                          scenario=scenario)
    env, params = res["env"], res["env_params"]
    hist = res["history"]
    assert hist.rewards.shape == (2, 3) and np.isfinite(hist.latencies).all()
    rr = env.round_robin_assignment()
    for f in range(2):
        lane_p = lane_params(params, env.default_params(), f)
        assert res["rrs"][f] == float(env.evaluate(rr, lane_p.base_rates,
                                                   params=lane_p))
        assert res["finals"][f] == float(env.evaluate(
            torch.as_tensor(hist.final_assignment[f]), lane_p.base_rates,
            params=lane_p))
    assert res["best"] == int((res["finals"] / res["rrs"]).argmin())
    if agent == "round_robin":
        np.testing.assert_array_equal(res["finals"], res["rrs"])


@pytest.mark.parametrize("argv", [
    ["--agent", "model_based", "--scenario", "one_slow_machine"],
    ["--agent", "dqn"],
    ["--agent", "dqn", "--k", "5", "--scenario", "mixed",
     "--broadcast-invariant"],
])
def test_launcher_prints_the_final_latency_line_for_baselines(capsys, argv):
    res = drl_control.main(["--device", "cpu", "--app", "cq_small",
                            "--fleet", "2", "--epochs", "3", *argv])
    out = capsys.readouterr().out
    assert "final latency" in out and "round-robin" in out
    assert "improvement" in out and "best assignment" in out
    assert "offline" not in out               # DDPG alone pretrains
    assert res["seconds"]["offline"] < 1.0
    assert res["agent"].name == argv[1]
