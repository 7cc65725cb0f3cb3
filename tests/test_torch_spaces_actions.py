"""The port's action-space registry, decision semantics (rate control,
auto-tuning), the two serving-only policies and ``sample_perturbed``,
against the reference on the same numpy inputs.

One-hot actions are held exactly.  ``auto_tune`` ranks six queueing-model
latencies that can lie within an ulp of each other: its choice must be
the reference's, or the two latencies must agree to 1e-5 under the
reference's model (a near-tie, where either argmin is right)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, env_pair, to_numpy,
                               to_torch, torch)

from repro.core import make_agent as jmake_agent
from repro.core import spaces as jspaces
from repro.dsdps import actions as jact
from repro.dsdps import scenarios as jscen
from repro_torch.core import agent_names, make_agent, make_epoch_step
from repro_torch.core import spaces as tspaces
from repro_torch.core.convert import env_params_from_numpy
from repro_torch.dsdps import actions as tact
from repro_torch.dsdps import scenarios as tscen
from repro_torch.dsdps import simulator as tsim
from repro_torch.launch import drl_control

TUNE_RTOL = 1e-5


@pytest.fixture(scope="module", params=["cq_small", "cq_large"])
def envs(request):
    return env_pair(request.param)


@pytest.fixture(scope="module")
def small():
    return env_pair("cq_small")


def _params(jp):
    """A reference EnvParams (single or stacked) as the port's, on the CPU."""
    return env_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _perturbed(jenv, n, seed=0):
    """n reference sample_perturbed clusters (their keys split off one)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return [jscen.sample_perturbed(jenv, k) for k in keys]


def _state_vectors(env, n, seed=0):
    """launch/serve_control.synthetic_requests' state vectors."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        X = np.eye(env.M, dtype=np.float32)[rng.integers(0, env.M, env.N)]
        w = np.exp(rng.normal(0.0, 0.25, env.workload.num_spouts))
        out.append(np.concatenate([X.reshape(-1), w.astype(np.float32)]))
    return np.stack(out)


def _one_hots(rng, lead, k):
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, lead)]


# --------------------------------------------------------------------------
# the registry and the space helpers
# --------------------------------------------------------------------------
def test_action_space_registry_matches_reference(envs):
    jenv, tenv = envs
    assert tspaces.action_space_names() == jspaces.action_space_names() == (
        "auto_tune", "placement", "rate_control")
    for name in tspaces.action_space_names():
        t, j = tspaces.action_space(name), jspaces.action_space(name)
        assert t.name == j.name and t.default_agent == j.default_agent
        assert t.shape_fn(tenv) == j.shape_fn(jenv)
    assert tspaces.action_space("placement").shape_fn(tenv) == (tenv.N, tenv.M)
    assert tspaces.action_space("rate_control").shape_fn(tenv) == (
        tenv.workload.num_spouts, len(tact.RATE_LEVELS))
    assert tspaces.action_space("auto_tune").shape_fn(tenv) == (len(tact.TUNE_GRID),)
    with pytest.raises(KeyError, match="unknown action space"):
        tspaces.action_space("no_such_space")


def test_space_helpers_match_reference():
    rng = np.random.default_rng(0)
    a, b = _one_hots(rng, 20, 10), _one_hots(rng, 20, 10)
    for x in (a, a * 0.5, a + 1e-3, np.zeros_like(a)):
        assert bool(tspaces.is_feasible(to_torch(x))) == bool(
            jspaces.is_feasible(jnp.asarray(x)))
    assert_exact(tspaces.assignment_to_machines(to_torch(a)),
                 jspaces.assignment_to_machines(jnp.asarray(a)))
    m = rng.integers(0, 10, 20)
    assert_exact(tspaces.machines_to_assignment(to_torch(m), 10),
                 jspaces.machines_to_assignment(jnp.asarray(m), 10))
    assert int(tspaces.hamming_moves(to_torch(a), to_torch(b))) == int(
        jspaces.hamming_moves(jnp.asarray(a), jnp.asarray(b)))
    assert tspaces.action_space_size(20, 10) == jspaces.action_space_size(20, 10)


def test_serving_only_agents_stay_off_the_env_paths(small):
    _, tenv = small
    assert agent_names() == ("ddpg", "dqn", "graph_policy", "model_based",
                             "round_robin", "stream_ac", "stream_q")
    for name in ("rate_control", "auto_tune"):
        agent = make_agent(name, tenv)
        assert agent.name == name
        with pytest.raises(ValueError, match="serving-only"):
            make_epoch_step(tenv, agent)
        with pytest.raises(SystemExit):
            drl_control.main(["--device", "cpu", "--agent", name])


# --------------------------------------------------------------------------
# dsdps/actions.py, on one EnvParams and on a stacked one
# --------------------------------------------------------------------------
def test_rate_and_tune_helpers_match_reference(envs):
    jenv, tenv = envs
    rng = np.random.default_rng(1)
    S, L, K = tenv.workload.num_spouts, len(tact.RATE_LEVELS), len(tact.TUNE_GRID)
    jp = _perturbed(jenv, 1)[0]
    tp = _params(jp)
    rate = _one_hots(rng, S, L)
    assert_exact(tact.rate_multipliers(to_torch(rate)),
                 jact.rate_multipliers(jnp.asarray(rate)))
    got, want = (tact.apply_rate_action(tp, to_torch(rate)),
                 jact.apply_rate_action(jp, jnp.asarray(rate)))
    assert_exact(got.base_rates, want.base_rates)
    for k in range(K):
        tune = np.eye(K, dtype=np.float32)[k]
        for g, w in zip(tact.tune_settings(to_torch(tune)),
                        jact.tune_settings(jnp.asarray(tune))):
            assert_exact(g, w)
        got, want = (tact.apply_config_action(tp, to_torch(tune)),
                     jact.apply_config_action(jp, jnp.asarray(tune)))
        assert_exact(got.acker_ms, want.acker_ms)
        assert_exact(got.tuple_bytes, want.tuple_bytes)
        assert got.tuple_bytes.shape == tp.tuple_bytes.shape


@pytest.mark.parametrize("broadcast_invariant", [False, True])
def test_actions_on_stacked_params_act_row_by_row(envs, broadcast_invariant):
    """A batch of R actions on an EnvParams stacked on [R] (or on one
    EnvParams) equals the reference's action on each row's own params."""
    jenv, tenv = envs
    R = 4
    rng = np.random.default_rng(2)
    S, L, K = tenv.workload.num_spouts, len(tact.RATE_LEVELS), len(tact.TUNE_GRID)
    jlanes = _perturbed(jenv, R, seed=3)
    stacked = tsim.stack_env_params([_params(p) for p in jlanes],
                                    broadcast_invariant=broadcast_invariant)
    rate = _one_hots(rng, (R, S), L)
    tune = _one_hots(rng, R, K)
    got_rate = tact.apply_rate_action(stacked, to_torch(rate))
    got_tune = tact.apply_config_action(stacked, to_torch(tune))
    single = _params(jenv.default_params())
    on_single = tact.apply_config_action(single, to_torch(tune))
    assert on_single.tuple_bytes.shape == (R, tenv.N)
    s_vec = _state_vectors(tenv, R, seed=4)
    X, w = tact.decode_state(tenv, to_torch(s_vec), stacked)
    assert X.shape == (R, tenv.N, tenv.M) and w.shape == (R, S)
    for r, jp in enumerate(jlanes):
        want = jact.apply_rate_action(jp, jnp.asarray(rate[r]))
        assert_exact(got_rate.base_rates[r], want.base_rates)
        want = jact.apply_config_action(jp, jnp.asarray(tune[r]))
        assert_exact(got_tune.acker_ms[r], want.acker_ms)
        assert_exact(got_tune.tuple_bytes[r], want.tuple_bytes)
        want = jact.apply_config_action(jenv.default_params(), jnp.asarray(tune[r]))
        assert_exact(on_single.tuple_bytes[r], want.tuple_bytes)
        jX, jw = jact.decode_state(jenv, jnp.asarray(s_vec[r]), jp)
        assert_exact(X[r], jX)
        assert_exact(w[r], jw)


def test_decode_state_inverts_state_vector(small):
    jenv, tenv = small
    jp = _perturbed(jenv, 1, seed=5)[0]
    tp = _params(jp)
    st = tenv.reset(1, tp)
    s_vec = tenv.state_vector(st, tp)[0]
    X, w = tact.decode_state(tenv, s_vec, tp)
    assert_exact(X, st.X[0])
    assert_f32(w, st.w[0], rtol=1e-6)
    jX, jw = jact.decode_state(jenv, jnp.asarray(to_numpy(s_vec)), jp)
    assert_exact(X, jX)
    assert_exact(w, jw)


# --------------------------------------------------------------------------
# the serving-only policies
# --------------------------------------------------------------------------
def test_rate_control_select_matches_reference(envs):
    jenv, tenv = envs
    jagent, tagent = jmake_agent("rate_control", jenv), make_agent("rate_control", tenv)
    js = jagent.init(jax.random.PRNGKey(0))
    ts = tagent.init_fleet(None, 1, "cpu")
    s_vec = _state_vectors(tenv, 12, seed=6)
    # loads spread over every level, and all-overloaded spouts
    s_vec[:, -tenv.workload.num_spouts:] *= np.linspace(0.2, 5.0, 12)[:, None]
    got, idx = tagent.select_fn(tagent.cfg, ts, to_torch(s_vec)[None], None,
                                None, False, None, None)
    assert got.shape == (1, 12, tenv.workload.num_spouts, len(tact.RATE_LEVELS))
    levels_seen = set()
    for r in range(12):
        want, jidx = jagent.select(jax.random.PRNGKey(r), js, jnp.asarray(s_vec[r]),
                                   None, jenv.default_params(), explore=False)
        assert_exact(got[0, r], want)
        assert_exact(idx[0, r], jidx)
        assert bool(tspaces.is_feasible(got[0, r]))
        levels_seen |= set(to_numpy(idx[0, r]).tolist())
    assert levels_seen == set(range(len(tact.RATE_LEVELS)))


def test_auto_tune_select_matches_reference_per_cluster(envs):
    """Each row decided under its own cluster's params (stacked, gathered
    by row): the same choice as the reference's single select on that
    cluster, or a near-tie at 1e-5."""
    jenv, tenv = envs
    R = 8
    jagent, tagent = jmake_agent("auto_tune", jenv), make_agent("auto_tune", tenv)
    js = jagent.init(jax.random.PRNGKey(0))
    ts = tagent.init_fleet(None, 1, "cpu")
    jlanes = _perturbed(jenv, R, seed=7)
    stacked = tsim.stack_env_params([_params(p) for p in jlanes],
                                    broadcast_invariant=True)
    s_vec = _state_vectors(tenv, R, seed=8)
    got, lats = tagent.select_fn(tagent.cfg, ts, to_torch(s_vec)[None], None,
                                 stacked, False, None, None)
    assert got.shape == (1, R, len(tact.TUNE_GRID))
    select = jax.jit(lambda s, p: jagent.select(jax.random.PRNGKey(0), js, s,
                                                None, p, explore=False))
    for r, jp in enumerate(jlanes):
        want, jlats = select(jnp.asarray(s_vec[r]), jp)
        assert_f32(lats[0, r], jlats, rtol=TUNE_RTOL)
        t, j = int(got[0, r].argmax()), int(np.asarray(want).argmax())
        if t != j:
            np.testing.assert_allclose(np.asarray(jlats)[t], np.asarray(jlats)[j],
                                       rtol=TUNE_RTOL)
        assert bool(tspaces.is_feasible(got[0, r]))
        # one row alone, on its own unstacked params, decides the same
        alone, _ = tagent.select_fn(tagent.cfg, ts, to_torch(s_vec[r]), None,
                                    _params(jp), False, None, None)
        assert_exact(alone, got[0, r])


# --------------------------------------------------------------------------
# sample_perturbed
# --------------------------------------------------------------------------
def _reference_draws(jenv, key):
    """sample_perturbed's four draws from its key, as the reference makes
    them."""
    k_svc, k_rate, k_slow, k_m = jax.random.split(key, 4)
    return dict(service_z=to_torch(jax.random.normal(k_svc, (jenv.N,))),
                rate_z=to_torch(jax.random.normal(k_rate,
                                                  (jenv.workload.num_spouts,))),
                straggler=bool(jax.random.bernoulli(k_slow, 0.25)),
                machine=int(jax.random.randint(k_m, (), 0, jenv.M)))


@pytest.mark.parametrize("seed", range(6))
def test_sample_perturbed_fed_the_reference_draws(small, seed):
    jenv, tenv = small
    key = jax.random.PRNGKey(seed)
    draws = _reference_draws(jenv, key)
    want = jscen.sample_perturbed(jenv, key)
    for got in (tscen.sample_perturbed(tenv, **draws),
                tscen.perturb_sampler(tenv)(**draws)):
        for f in tsim.EnvParams._fields:
            g, w = to_numpy(getattr(got, f)), np.asarray(getattr(want, f))
            assert g.shape == w.shape and g.dtype == w.dtype, f
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f)


def test_sample_perturbed_from_a_generator(small):
    _, tenv = small
    a = tscen.sample_perturbed(tenv, gen=torch.Generator().manual_seed(0))
    b = tscen.sample_perturbed(tenv, gen=torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    gen = torch.Generator().manual_seed(1)
    lanes = [tscen.sample_perturbed(tenv, gen=gen, straggler_prob=0.5)
             for _ in range(16)]
    p = tenv.default_params()
    assert len({float(x.service_ms.sum()) for x in lanes}) == 16
    slowed = [bool((x.speed != p.speed).any()) for x in lanes]
    assert any(slowed) and not all(slowed)
    for x in lanes:
        assert int((x.speed != p.speed).sum()) <= 1
        ratio = to_numpy(x.base_rates / p.base_rates)
        assert np.all(ratio > 0) and not np.allclose(ratio, 1.0)
    base = tsim.scale_rates(p, 2.0)
    around = tscen.perturb_sampler(tenv, base=base, rate_sigma=0.0)(
        gen=torch.Generator().manual_seed(2), straggler=False)
    assert torch.equal(around.base_rates, base.base_rates)
