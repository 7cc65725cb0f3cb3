"""The port's replay-free streaming agents against the reference: the
building blocks (sparse init, Welford, reward statistics, traces, ObGD),
the Gumbel draw that replays ``jax.random.categorical``, each agent's
select from carried states, and Stream Q(λ), Stream AC(λ) and the graph
policy (on a plain env's static graph) through ``run_online_fleet`` from
carried states with the reference's draws replayed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, assert_tree_f32,
                               assert_tree_scaled,
                               env_pair, jax_epoch_draws, jax_tree_numpy,
                               numpy_epoch_draws, to_numpy, to_torch, torch)

from repro.core import exploration as jexpl
from repro.core import graph_policy as jgp
from repro.core import make_agent as jax_make_agent
from repro.core import networks as jnets
from repro.core import stream_ac as jac
from repro.core import stream_q as jsq
from repro.core import streaming as jstr
from repro.core.agent import run_online_fleet as jax_run_online_fleet
from repro.dsdps import scenarios as jscen
from repro_torch.core import EpochDraws, make_agent, run_online_fleet
from repro_torch.core import convert
from repro_torch.core import exploration as texpl
from repro_torch.core import graph_policy as tgp
from repro_torch.core import networks as tnets
from repro_torch.core import stream_ac as tac
from repro_torch.core import stream_q as tsq
from repro_torch.core import streaming as tstr
from repro_torch.dsdps import lane_params, scenarios

NAMES = ("stream_q", "stream_ac", "graph_policy")
# float32 sums and products in another order than XLA's (forward, backward,
# the trace L1 norms): measured within a few ulps; rtol 1e-5 as the other
# loop tests (weights and traces: assert_tree_scaled's leaf-scaled slack)
RTOL = 1e-5
# a choice the two packages may make apart: the reference's two values
# within 1e-5 of each other (the rule of the model-based argmin, PR 16)
TIE_RTOL = 1e-5
# short schedules, so five epochs see greedy and random moves and low
# temperatures alike
DECAY = 4


@pytest.fixture(scope="module")
def envs():
    return env_pair("cq_small")


def cfg_pair(name, env):
    """Equal configs of ``name`` on both sides, with the short schedules."""
    if name == "stream_q":
        kw = dict(n_executors=env.N, n_machines=env.M, state_dim=env.state_dim)
        return (jsq.StreamQConfig(**kw, eps=jexpl.EpsilonSchedule(decay_epochs=DECAY)),
                tsq.StreamQConfig(**kw, eps=texpl.EpsilonSchedule(decay_epochs=DECAY)))
    if name == "stream_ac":
        kw = dict(n_executors=env.N, n_machines=env.M, state_dim=env.state_dim,
                  temp_decay_epochs=DECAY)
        return jac.StreamACConfig(**kw), tac.StreamACConfig(**kw)
    jc = jax_make_agent("graph_policy", env).cfg
    fields = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "eps"}
    return (jgp.GraphPolicyConfig(**fields, eps=jexpl.EpsilonSchedule(decay_epochs=DECAY)),
            tgp.GraphPolicyConfig(**fields, eps=texpl.EpsilonSchedule(decay_epochs=DECAY)))


JAX_MODULES = {"stream_q": jsq, "stream_ac": jac, "graph_policy": jgp}
FROM_NUMPY = {"stream_q": convert.stream_q_state_from_numpy,
              "stream_ac": convert.stream_ac_state_from_numpy,
              "graph_policy": convert.graph_policy_state_from_numpy}
TO_NUMPY = {"stream_q": convert.stream_q_state_to_numpy,
            "stream_ac": convert.stream_ac_state_to_numpy,
            "graph_policy": convert.graph_policy_state_to_numpy}


def carried(name, jcfg, fleet, seed=0):
    """A reference fleet state of ``name`` and the port's copy of it."""
    js = JAX_MODULES[name].init_fleet(jax.random.PRNGKey(seed), jcfg, fleet)
    return js, FROM_NUMPY[name](jax_tree_numpy(js), "cpu")


_WARMED = {}


def warmed(name, jcfg, jenv, fleet=6):
    """A reference fleet state after a few random observes (non-zero traces,
    normalizer and reward statistics), and the port's copy; made once per
    agent for this module's tests."""
    if name not in _WARMED:
        _WARMED[name] = _warm(name, jcfg, fleet, np.random.default_rng(4), jenv)
    js, _ = _WARMED[name]
    return js, FROM_NUMPY[name](jax_tree_numpy(js), "cpu")


def _warm(name, jcfg, fleet, rng, jenv):
    js, _ = carried(name, jcfg, fleet)
    mod = JAX_MODULES[name]
    p = jenv.default_params()
    if name == "stream_ac":
        obs = jax.jit(jax.vmap(lambda st, a, b, x, y: mod.observe(jcfg, st, a, x, b, y)))
        upd = jax.jit(jax.vmap(lambda st: mod.update(st, jcfg)))
    elif name == "stream_q":
        obs = jax.jit(jax.vmap(lambda st, a, b, m, g, y: mod.observe(
            jcfg, st, a, (m, g), b, y)))
        upd = jax.jit(jax.vmap(lambda st: mod.update(st, jcfg)))
    else:
        obs = jax.jit(jax.vmap(lambda st, a, b, m, g, y: mod._agent_observe(
            jcfg, st, a, (m, g, p), b, y)))
        upd = jax.jit(jax.vmap(lambda st: mod._agent_update(None, jcfg, st)))
    for _ in range(3):
        s = rng.uniform(size=(fleet, jenv.state_dim)).astype(np.float32)
        sn = rng.uniform(size=(fleet, jenv.state_dim)).astype(np.float32)
        r = -rng.uniform(2, 3, size=fleet).astype(np.float32)
        if name == "stream_ac":
            aux = (jnp.asarray(rng.integers(0, jenv.M, (fleet, jenv.N))),)
        else:
            aux = (jnp.asarray(rng.integers(0, jcfg.num_actions, fleet)),
                   jnp.asarray(rng.integers(0, 2, fleet).astype(np.float32)))
        js = upd(obs(js, jnp.asarray(s), jnp.asarray(r), *aux, jnp.asarray(sn)))
    return js, FROM_NUMPY[name](jax_tree_numpy(js), "cpu")


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9])
def test_sparse_init_zero_count_per_column(sparsity):
    sizes = (202, 8, 8, 5)
    net = tnets.sparse_init(sizes, 3, sparsity=sparsity,
                            gen=torch.Generator().manual_seed(0), device="cpu")
    for w, din in zip(net.weights, sizes[:-1]):
        zeros = (w == 0).sum(1)                                 # [F, dout]
        assert (zeros == round(sparsity * din)).all()
        assert float(w.detach().abs().max()) <= 1.0 / np.sqrt(din)
    assert all((b == 0).all() for b in net.biases)
    assert not torch.equal(net.weights[0][0], net.weights[0][1])   # lanes differ
    # the reference's counts at the same sizes
    jp = jnets.sparse_init(jax.random.PRNGKey(0), sizes, sparsity=sparsity)
    for w, jw in zip(net.weights, jp.weights):
        assert_exact((w[0] == 0).sum(0), (np.asarray(jw) == 0).sum(0))
    with pytest.raises(ValueError, match="sparsity"):
        tnets.sparse_init(sizes, 1, sparsity=1.0, device="cpu")


def test_welford_normalizer_matches_numpy_and_reference():
    rng = np.random.default_rng(0)
    xs = rng.normal(3.0, 2.5, size=(50, 2, 7)).astype(np.float32)
    norm = tstr.norm_init(7, 2, "cpu")
    jnorm = jax.vmap(lambda _: jstr.norm_init(7))(jnp.arange(2))
    # the first two observations: unit variance, centred only
    for t, x in enumerate(xs):
        if t < 2:
            assert_f32(tstr.norm_apply(norm, to_torch(x)),
                       jax.vmap(jstr.norm_apply)(jnorm, jnp.asarray(x)), rtol=1e-6)
        norm = tstr.norm_update(norm, to_torch(x))
        jnorm = jax.vmap(jstr.norm_update)(jnorm, jnp.asarray(x))
    assert_exact(norm.count, [50.0, 50.0])
    assert_f32(norm.mean, xs.mean(0), rtol=1e-5)
    assert_f32(norm.m2 / 50, xs.var(0), rtol=1e-4)
    assert_tree_f32(tuple(map(to_numpy, norm)), tuple(jnorm), rtol=1e-6)
    z = tstr.norm_apply(norm, to_torch(xs[0]))
    assert_f32(z, jax.vmap(jstr.norm_apply)(jnorm, jnp.asarray(xs[0])), rtol=1e-6,
               atol=1e-7)
    want = np.clip((xs[0] - xs.mean(0)) / np.sqrt(xs.var(0) + 1e-8), -10, 10)
    assert_f32(z, want, rtol=1e-3, atol=1e-5)


def test_reward_norm_update_matches_reference():
    rng = np.random.default_rng(1)
    mean, var, count = torch.zeros(3), torch.ones(3), torch.zeros(3, dtype=torch.int32)
    jm, jv, jc = jnp.zeros(3), jnp.ones(3), jnp.zeros(3, jnp.int32)
    for _ in range(60):                     # past alpha's 0.02 floor
        r = -rng.uniform(1, 4, 3).astype(np.float32)
        r_std, mean, var, count = tstr.reward_norm_update(to_torch(r), mean, var,
                                                          count, scale=0.25)
        jr, jm, jv, jc = jax.vmap(
            lambda a, b, c, d: jstr.reward_norm_update(a, b, c, d, scale=0.25))(
                jnp.asarray(r), jm, jv, jc)
        assert_f32(r_std, jr, rtol=1e-5, atol=1e-6)
    assert_exact(count, jc)
    assert_f32(mean, jm, rtol=1e-6)
    assert_f32(var, jv, rtol=1e-5)


def test_obgd_zero_delta_is_a_bit_exact_noop_and_the_step_is_bounded():
    F = 3
    net = tnets.init_mlp((6, 4, 3), F, torch.Generator().manual_seed(0), "cpu")
    params = [p.detach().clone() for p in net.parameters()]
    before = [p.clone() for p in params]
    traces = [torch.full_like(p, 2.0) for p in params]
    tstr.obgd_step(params, traces, torch.zeros(F), lr=1.0, kappa=2.0)
    for p, q in zip(params, before):
        assert torch.equal(p.view(torch.int32), q.view(torch.int32))
    # a huge TD error cannot move a lane past the overshoot bound:
    # α_eff·|δ|·‖z‖₁ ≤ 1/κ; lanes are bounded each on its own traces
    traces[0][1] *= 10.0
    kappa = 2.0
    tstr.obgd_step(params, traces, torch.tensor([1e6, -1e6, 0.5]), lr=1.0,
                   kappa=kappa)
    moved = sum((p - q).abs().flatten(1).sum(1) for p, q in zip(params, before))
    assert (moved[:2] <= 1.0 / kappa + 1e-5).all()
    # lane 2 (|δ| ≤ 1): the plain step α·δ·z, throttled by its own ‖z‖₁
    jp = jnets.MLPParams(tuple(to_numpy(b[2]) for b in before[:2]),
                         tuple(to_numpy(b[2]) for b in before[2:]))
    jz = jnets.MLPParams(tuple(to_numpy(z[2]) for z in traces[:2]),
                         tuple(to_numpy(z[2]) for z in traces[2:]))
    want = jstr.obgd_step(jp, jz, jnp.asarray(0.5), lr=1.0, kappa=kappa)
    assert_tree_f32([p[2] for p in params], (*want.weights, *want.biases),
                    rtol=1e-6)


def test_trace_decay_add_per_lane():
    rng = np.random.default_rng(2)
    z = [to_torch(rng.normal(size=(2, 4, 3)).astype(np.float32))]
    g = [to_torch(rng.normal(size=(2, 4, 3)).astype(np.float32))]
    want = 0.891 * to_numpy(z[0][0]) + to_numpy(g[0][0])
    out = [x.clone() for x in z]
    tstr.trace_decay_add(out, g, torch.tensor([0.891, 0.0]))       # in place
    assert_f32(out[0][0], want, rtol=1e-6)
    assert torch.equal(out[0][1], g[0][1])                       # the Watkins cut
    out = [x.clone() for x in z]
    tstr.trace_decay_add(out, g, 0.5)
    assert_f32(out[0], 0.5 * to_numpy(z[0]) + to_numpy(g[0]), rtol=1e-6)


def test_gumbel_argmax_is_jax_categorical():
    """``jax.random.categorical(key, logits)`` is ``argmax(gumbel(key,
    logits.shape) + logits)``, so the replayed Gumbel draws reproduce it."""
    rng = np.random.default_rng(3)
    for i, shape in enumerate([(20, 10), (7,), (100, 10), (3, 5)]):
        key = jax.random.PRNGKey(i)
        logits = jnp.asarray(rng.normal(size=shape).astype(np.float32) * 3)
        want = jax.random.categorical(key, logits, axis=-1)
        g = jax.random.gumbel(key, shape)
        assert_exact(jnp.argmax(g + logits, axis=-1), want)
        assert_exact((to_torch(g) + to_torch(logits)).argmax(-1), want)
    # masked logits (graph_policy's random valid move)
    flat = np.where(rng.uniform(size=50) < 0.3, -np.inf, 0.0).astype(np.float32)
    key = jax.random.PRNGKey(9)
    g = jax.random.gumbel(key, (50,))
    assert_exact((to_torch(g) + to_torch(flat)).argmax(-1),
                 jax.random.categorical(key, jnp.asarray(flat)))
    assert np.isfinite(flat[int(jnp.argmax(g + flat))])
    # the port's own Gumbel draws: finite, the standard distribution's mean
    d = tstr.gumbel((200_000,), torch.Generator().manual_seed(0), "cpu")
    assert torch.isfinite(d).all() and abs(float(d.mean()) - 0.5772) < 0.01


def test_streaming_states_are_replay_free(envs):
    _, env = envs
    for name in NAMES:
        st = make_agent(name, env).init_fleet(torch.Generator().manual_seed(0),
                                              2, "cpu")
        assert st.fleet == 2
        assert not any(hasattr(st, f) for f in ("replay", "target", "opt"))


@pytest.mark.parametrize("name", NAMES)
def test_state_roundtrips_through_numpy(envs, name):
    jenv, _ = envs
    jcfg, _ = cfg_pair(name, jenv)
    js, ts = warmed(name, jcfg, jenv)
    want = jax_tree_numpy(js)
    assert_tree_f32(TO_NUMPY[name](ts), want, rtol=0)
    one = jax.tree.map(lambda x: np.asarray(x)[1], want)           # one lane
    ts1 = FROM_NUMPY[name](one, "cpu")
    assert ts1.fleet == 1
    assert_tree_f32(jax.tree.map(lambda x: x[0], TO_NUMPY[name](ts1)), one, rtol=0)


# --------------------------------------------------------------------------
# one select of every lane from carried states, against the reference's
# --------------------------------------------------------------------------
def _reference_scores(name, jcfg, js, s, draws, f, jp):
    """Lane f's reference choice and the values it chose among: Q over the
    moves (greedy), or gumbel + logits per row (Stream AC)."""
    st = jax.tree.map(lambda x: x[f], js)
    x = jnp.asarray(s[f])
    if name == "stream_q":
        return np.asarray(jnets.apply_qnet(st.qnet, jstr.norm_apply(st.norm, x)))
    if name == "stream_ac":
        logits = jac._logits(st.actor, jcfg, jstr.norm_apply(st.norm, x),
                             jcfg.temperature(st.epoch))
        return np.asarray(logits) + to_numpy(draws.explore_gumbel[f])
    graph = jgp._graph_arrays(jcfg, jp)
    feat = jgp._features(jcfg, x, jp, graph)
    return np.asarray(jgp._masked(jgp.apply_qnet(st.qnet, feat, graph, jcfg),
                                  graph)).reshape(-1)


@pytest.mark.parametrize("name", NAMES)
def test_select_from_carried_states_matches_reference(envs, name):
    """Warmed lanes on random states: the port's choice equals the
    reference's, or the reference's values of the two choices lie within
    TIE_RTOL of each other (counted).  Greedy selects for the Q agents,
    Gumbel samples for Stream AC(λ)."""
    jenv, tenv = envs
    jcfg, tcfg = cfg_pair(name, jenv)
    F = 6
    rng = np.random.default_rng(5)
    js, ts = warmed(name, jcfg, jenv, F)
    agent = make_agent(name, tenv, cfg=tcfg)
    s = rng.uniform(size=(F, jenv.state_dim)).astype(np.float32)
    draws = numpy_epoch_draws(rng, F, 1, 1, 1, jenv.N, jenv.M,
                              jenv.workload.num_spouts)[0]
    X = np.eye(jenv.M, dtype=np.float32)[rng.integers(0, jenv.M, (F, jenv.N))]
    env_state = tenv.reset(F)._replace(X=to_torch(X))
    explore = name == "stream_ac"
    _, aux = agent.select_fn(tcfg, ts, to_torch(s), env_state,
                             tenv.default_params(), explore, draws, None)
    got = to_numpy(aux if name == "stream_ac" else aux[0])
    ties = 0
    for f in range(F):
        vals = _reference_scores(name, jcfg, js, s, draws, f, jenv.default_params())
        want = vals.argmax(-1)
        for g, w, v in zip(np.atleast_1d(got[f]), np.atleast_1d(want),
                           np.atleast_2d(vals)):
            if g != w:
                np.testing.assert_allclose(v[g], v[w], rtol=TIE_RTOL)
                ties += 1
    assert ties == 0, f"{ties} near-ties"      # none at these seeds


# --------------------------------------------------------------------------
# the loop: against the reference's run_online_fleet
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_fleet_matches_reference_run_online_fleet(envs, name):
    """cq_small, F=2, T=5, under a one_slow_machine fleet, from carried
    init states with the reference's draws replayed (ε coin, random move,
    Gumbel, noise, rate walk): moves and assignments exact; rewards,
    latencies, weights, traces, ObsNorm and reward statistics at float32
    tolerance.  graph_policy runs on the plain env's static graph."""
    jenv, tenv = envs
    jcfg, tcfg = cfg_pair(name, jenv)
    F, T = 2, 5
    jparams = jscen.build("one_slow_machine", jenv, F, broadcast_invariant=True)
    tparams = convert.env_params_from_numpy(jax_tree_numpy(jparams), "cpu")
    js, ts = carried(name, jcfg, F, seed=4)
    keys = jax.random.split(jax.random.PRNGKey(6), F)
    js_end, jh = jax_run_online_fleet(keys, jenv,
                                      jax_make_agent(name, jenv, cfg=jcfg),
                                      js, T=T, env_params=jparams)
    eps = getattr(jcfg, "eps", None)
    draws = jax_epoch_draws(keys, T=T, U=1, B=1, N=jenv.N, M=jenv.M,
                            S=jenv.workload.num_spouts, eps=eps,
                            gumbel="rand" if name == "graph_policy" else "act")
    ts_end, th = run_online_fleet(0, tenv, make_agent(name, tenv, cfg=tcfg), ts,
                                  T, env_params=tparams, draws=draws)
    assert_exact(th.moved, jh.moved)
    assert_exact(th.final_assignment, jh.final_assignment)
    assert th.moved.sum() > 0
    assert_f32(th.latencies, jh.latencies, rtol=RTOL)
    assert_f32(th.rewards, jh.rewards, rtol=RTOL)
    got, want = TO_NUMPY[name](ts_end), jax_tree_numpy(js_end)
    assert_exact(got.epoch, want.epoch)
    assert_exact(got.r_count, want.r_count)
    assert_tree_scaled(got, want, rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_update_applies_each_transition_once(envs, name):
    """``update`` consumes the pending TD error, so three updates an epoch
    give exactly what one gives."""
    _, env = envs
    agent = make_agent(name, env)
    F, T = 2, 4
    draws = numpy_epoch_draws(np.random.default_rng(7), F, T, 3, 1, env.N,
                              env.M, env.workload.num_spouts)
    init = TO_NUMPY[name](agent.init_fleet(torch.Generator().manual_seed(1), F,
                                           "cpu"))
    out = {}
    for U in (1, 3):
        st, h = run_online_fleet(0, env, agent, FROM_NUMPY[name](init, "cpu"), T,
                                 updates_per_epoch=U, draws=draws)
        out[U] = (TO_NUMPY[name](st), h)
    assert_tree_f32(out[1][0], out[3][0], rtol=0)
    assert_exact(out[1][1].rewards, out[3][1].rewards)
    assert_exact(out[1][1].final_assignment, out[3][1].final_assignment)


@pytest.mark.parametrize("name", NAMES)
def test_scenario_fleet_lane_equals_single_run(envs, name):
    """Lane f of a mixed scenario fleet equals a fleet of one run under
    lane f's scenario from lane f's state, bit for bit."""
    _, env = envs
    agent = make_agent(name, env)
    F, T = 3, 4
    params = scenarios.build("mixed", env, F, seed=2)
    init = TO_NUMPY[name](agent.init_fleet(torch.Generator().manual_seed(2), F,
                                           "cpu"))
    draws = numpy_epoch_draws(np.random.default_rng(8), F, T, 1, 1, env.N, env.M,
                              env.workload.num_spouts)
    st, fleet = run_online_fleet(0, env, agent, FROM_NUMPY[name](init, "cpu"), T,
                                 env_params=params, draws=draws)
    for f in range(F):
        lane = convert.lane_arrays(init, f)
        st1, one = run_online_fleet(
            0, env, agent, FROM_NUMPY[name](lane, "cpu"), T,
            env_params=lane_params(params, env.default_params(), f),
            draws=[EpochDraws(*(x[f:f + 1] for x in d)) for d in draws])
        assert_exact(fleet.latencies[f], one.latencies[0])
        assert_exact(fleet.final_assignment[f], one.final_assignment[0])
        assert_tree_f32(convert.lane_arrays(TO_NUMPY[name](st), f),
                        TO_NUMPY[name](st1), rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_generator_draws_run_and_reproduce(envs, name):
    """Without passed draws every draw comes from the generator: finite,
    one-hot, the same from the same seed."""
    _, env = envs
    agent = make_agent(name, env)
    hists = [run_online_fleet(
        3, env, agent, agent.init_fleet(torch.Generator().manual_seed(0), 2, "cpu"),
        6)[1] for _ in range(2)]
    assert np.isfinite(hists[0].latencies).all()
    assert_exact(hists[0].latencies, hists[1].latencies)
    assert np.array_equal(hists[0].final_assignment.sum(-1), np.ones((2, env.N)))
