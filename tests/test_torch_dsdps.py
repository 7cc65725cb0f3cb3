"""The port's DSDPS simulator against the reference (repro/dsdps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, env_pair,
                               jax_epoch_draws, to_numpy, to_torch, torch)

from repro.dsdps import simulator as jsim
from repro.dsdps import topology as jtopo
from repro.dsdps.workload import step_rates as jax_step_rates
from repro_torch.core.convert import env_params_from_numpy
from repro_torch.dsdps import simulator as tsim
from repro_torch.dsdps import topology as ttopo
from repro_torch.dsdps.apps import ALL_APPS
from repro_torch.dsdps.workload import step_rates

# rtol 1e-5: both sides compute in float32, but the order of the
# reductions over executors (matmuls in the reference, elementwise sums
# here) differs, which moves the last few ulps of the latency
RTOL = 1e-5


def _random_one_hot(rng, n_lanes, N, M):
    return np.eye(M, dtype=np.float32)[rng.integers(0, M, (n_lanes, N))]


@pytest.mark.parametrize("app", sorted(ALL_APPS))
def test_env_params_identical_to_reference(app):
    jenv, tenv = env_pair(app)
    jp, tp = jenv.default_params(), tenv.default_params()
    for field in jsim.EnvParams._fields:
        got, want = to_numpy(getattr(tp, field)), np.asarray(getattr(jp, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    np.testing.assert_array_equal(tenv.params.routing, jenv.params.routing)
    assert tenv.params.rev_schedule == jenv.params.rev_schedule
    assert tenv.params.comp_members == jenv.params.comp_members


@pytest.mark.parametrize("app", sorted(ALL_APPS))
def test_latency_matches_reference_on_random_assignments(app):
    jenv, tenv = env_pair(app)
    rng = np.random.default_rng(sorted(ALL_APPS).index(app))
    X = _random_one_hot(rng, 20, jenv.N, jenv.M)
    w = np.asarray(jenv.default_params().base_rates) * rng.uniform(
        0.6, 1.4, size=(20, jenv.workload.num_spouts)).astype(np.float32)
    want = jax.jit(jax.vmap(jenv.evaluate))(jnp.asarray(X), jnp.asarray(w))
    got = tenv.evaluate(to_torch(X), to_torch(w))
    assert_f32(got, want, rtol=RTOL)
    # one assignment at a time gives the batch's values exactly
    for i in (0, 7):
        assert_exact(tenv.evaluate(to_torch(X[i]), to_torch(w[i])), got[i])


@pytest.mark.parametrize("app", ["cq_small", "log_stream"])
def test_storm_default_and_sim_params_paths(app):
    """The Storm-default per-process path and the SimParams path."""
    jenv, tenv = env_pair(app)
    jX, jsp, jnp_ = jenv.storm_default_assignment()
    tX, tsp, tnp_ = tenv.storm_default_assignment()
    for a, b in ((tX, jX), (tsp, jsp), (tnp_, jnp_)):
        assert_exact(a, b)
    w = jenv.default_params().base_rates
    want = jax.jit(lambda X, sp, n: jenv.evaluate(X, w, same_proc=sp,
                                                  n_procs=n))(jX, jsp, jnp_)
    got = tenv.evaluate(tX, to_torch(w), same_proc=tsp, n_procs=tnp_)
    assert_f32(got, want, rtol=RTOL)
    speed = np.linspace(0.7, 1.1, jenv.M).astype(np.float32)
    want = jax.jit(lambda X, sp: jsim.average_tuple_time_ms(
        X, w, jenv.params, jenv.cluster, speed=sp))(jX, jnp.asarray(speed))
    got = tsim.average_tuple_time_ms(tX, to_torch(w), tenv.params,
                                     tenv.cluster, speed=to_torch(speed))
    assert_f32(got, want, rtol=RTOL)


def test_env_params_carry_across_from_numpy():
    jenv, tenv = env_pair("diamond")
    tree = jax.tree.map(np.asarray, jsim.with_straggler(jenv.default_params(),
                                                       2, 0.5))
    got = env_params_from_numpy(tree, "cpu")
    for field in jsim.EnvParams._fields:
        assert_exact(getattr(got, field), getattr(tree, field))
        assert getattr(got, field).dtype == getattr(
            tenv.default_params(), field).dtype
    X = tenv.round_robin_assignment()
    assert float(tenv.evaluate(X, got.base_rates, params=got)) > float(
        tenv.evaluate(X, got.base_rates))


def test_param_helpers_match_reference():
    jenv, tenv = env_pair()
    jp, tp = jenv.default_params(), tenv.default_params()
    pairs = [
        (jsim.with_noise_sigma(jp, 0.2), tsim.with_noise_sigma(tp, 0.2)),
        (jsim.with_speed(jp, np.full(jenv.M, 0.9)),
         tsim.with_speed(tp, np.full(jenv.M, 0.9))),
        (jsim.with_straggler(jp, 3, 0.4), tsim.with_straggler(tp, 3, 0.4)),
        (jsim.scale_rates(jp, 1.5), tsim.scale_rates(tp, 1.5)),
    ]
    X = jenv.round_robin_assignment()
    for jq, tq in pairs:
        for field in jsim.EnvParams._fields:
            assert_exact(getattr(tq, field), getattr(jq, field))
        assert_f32(tenv.evaluate(to_torch(X), tq.base_rates, params=tq),
                   jenv.evaluate(X, jq.base_rates, params=jq), rtol=RTOL)
    # the helpers copy: the defaults are untouched
    assert float(tp.speed[3]) == float(jp.speed[3])


def test_step_with_injected_draws_matches_reference():
    jenv, tenv = env_pair()
    F, T = 3, 4
    keys = jax.random.split(jax.random.PRNGKey(5), F)
    draws = jax_epoch_draws(keys, T=T, U=1, B=2, N=jenv.N, M=jenv.M,
                            S=jenv.workload.num_spouts)
    rng = np.random.default_rng(2)
    actions = _random_one_hot(rng, T * F, jenv.N, jenv.M).reshape(
        T, F, jenv.N, jenv.M)
    ts = tenv.reset(F)
    js = [jenv.reset(k) for k in keys]
    lane_keys = [jax.random.split(k)[1] for k in keys]
    for t in range(T):
        out = tenv.step(ts, to_torch(actions[t]), meas_z=draws[t].meas_z,
                        rate_z=draws[t].rate_z)
        for f in range(F):
            lane_keys[f], _, k_step, _ = jax.random.split(lane_keys[f], 4)
            jo = jenv.step(k_step, js[f], jnp.asarray(actions[t, f]))
            assert_exact(out.moved[f], jo.moved)
            assert_exact(out.state.X[f], jo.state.X)
            assert_exact(out.state.epoch[f], jo.state.epoch)
            assert_f32(out.reward[f], jo.reward, rtol=RTOL)
            assert_f32(out.latency_ms[f], jo.latency_ms, rtol=RTOL)
            assert_f32(out.state.w[f], jo.state.w, rtol=RTOL)
            assert_f32(tenv.state_vector(out.state)[f],
                       jenv.state_vector(jo.state), rtol=RTOL)
            js[f] = jo.state
        ts = out.state


def test_state_vector_and_reset():
    jenv, tenv = env_pair("word_count")
    ts = tenv.reset(2)
    js = jenv.reset(jax.random.PRNGKey(0))
    for f in range(2):
        assert_exact(ts.X[f], js.X)
        assert_exact(ts.w[f], js.w)
        assert_exact(ts.speed[f], js.speed)
        assert_exact(tenv.state_vector(ts)[f], jenv.state_vector(js))
    assert tenv.state_dim == jenv.state_dim
    assert tenv.action_dim == jenv.action_dim


def test_step_rates_with_shift_matches_reference():
    """The Fig-12 step change: rates jump once epoch >= shift_epoch."""
    base = np.asarray([100.0, 200.0], np.float32)
    w = np.asarray([[90.0, 210.0], [120.0, 180.0]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    z = np.stack([np.asarray(jax.random.normal(k, (2,))) for k in keys])
    epochs = (2, 3)
    got = step_rates(to_torch(w), torch.tensor(epochs, dtype=torch.int32),
                     to_torch(base), torch.tensor(0.05), torch.tensor(0.2),
                     torch.tensor(3), torch.tensor(1.5), to_torch(z))
    for f, epoch in enumerate(epochs):
        want = jax_step_rates(keys[f], jnp.asarray(w[f]), jnp.asarray(epoch),
                              jnp.asarray(base), 0.05, 0.2, 3, 1.5)
        assert_f32(got[f], want, rtol=1e-6)


def _chain(groupings, par, skews):
    names = [f"c{i}" for i in range(len(par))]
    def comps(mod):
        return [mod.Component(n, p, cpu_ms_per_tuple=0.1 * (i + 1),
                              selectivity=0.5 + i, is_spout=(i == 0))
                for i, (n, p) in enumerate(zip(names, par))]
    def edges(mod):
        return [mod.Edge(names[i], names[i + 1], g, skew=s)
                for i, (g, s) in enumerate(zip(groupings, skews))]
    return (ttopo.Topology("chain", comps(ttopo), edges(ttopo)),
            jtopo.Topology("chain", comps(jtopo), edges(jtopo)))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_routing_matrix_bit_identical_for_every_grouping(seed):
    t, j = _chain(["fields", "global", "all", "shuffle", "fields"],
                  [2, 5, 3, 4, 2, 6], [0.8, 0.0, 0.0, 0.0, 1.3])
    np.testing.assert_array_equal(t.routing_matrix(seed), j.routing_matrix(seed))
    np.testing.assert_array_equal(t.service_demand_ms(), j.service_demand_ms())
    np.testing.assert_array_equal(t.tuple_bytes(), j.tuple_bytes())
    np.testing.assert_array_equal(t.spout_executors, j.spout_executors)
    np.testing.assert_array_equal(t.executor_component, j.executor_component)
    assert t.topo_order == j.topo_order
    # the fields split is a property of the edge: every sender of the
    # edge sees the same distribution over the receivers
    R = t.routing_matrix(seed)
    src, dst = list(t.executor_slice("c0")), list(t.executor_slice("c1"))
    fracs = R[np.ix_(src, dst)] / t.component("c0").selectivity
    np.testing.assert_allclose(fracs.sum(1), 1.0, rtol=1e-12)
    np.testing.assert_array_equal(fracs, np.broadcast_to(fracs[:1], fracs.shape))


def test_topology_rejects_what_the_reference_rejects():
    C, E = ttopo.Component, ttopo.Edge
    with pytest.raises(ValueError, match="duplicate"):
        ttopo.Topology("t", [C("a", 1, 0.1), C("a", 1, 0.1)], [])
    with pytest.raises(ValueError, match="unknown component"):
        ttopo.Topology("t", [C("a", 1, 0.1)], [E("a", "b")])
    with pytest.raises(ValueError, match="unknown grouping"):
        ttopo.Topology("t", [C("a", 1, 0.1), C("b", 1, 0.1)], [E("a", "b", "x")])
    with pytest.raises(ValueError, match="cycle"):
        ttopo.Topology("t", [C("a", 1, 0.1), C("b", 1, 0.1)],
                       [E("a", "b"), E("b", "a")])
