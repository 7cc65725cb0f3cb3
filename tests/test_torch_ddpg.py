"""The port's DDPG (core/ddpg.py) against the reference, from reference
states carried across, with the reference's draws replayed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, assert_tree_f32,
                               carried_fleet, cfg_pair, env_pair,
                               jax_offline_draws, jax_tree_numpy, to_torch,
                               torch)

from repro.core import ddpg as jddpg
from repro.core import exploration as jexpl
from repro_torch.core import ddpg as tddpg
from repro_torch.core.convert import ddpg_state_from_numpy, ddpg_state_to_numpy

F = 2
# rtol 1e-5: forward and backward passes reduce in another order than
# XLA's, so losses, gradients and the Adam steps built on them differ in
# the last float32 ulps
RTOL = 1e-5
# Adam's first step is lr·g/(|g| + 1e-8): where a gradient element is
# within a few ulps-of-the-sum of zero, rounding noise moves that step by a
# visible fraction of lr.  Parameters therefore also get an absolute
# tolerance of 2% of the smaller learning rate (2e-4).
PARAM_ATOL = 0.02 * 2e-4


@pytest.fixture(scope="module")
def setup():
    jenv, tenv = env_pair("cq_small")
    jcfg, tcfg = cfg_pair(jenv, k_nn=12, batch=16, buffer=64,
                          eps=jexpl.EpsilonSchedule(decay_epochs=40))
    tcfg = tddpg.DDPGConfig(**{**tcfg.__dict__,
                               "eps": tddpg.EpsilonSchedule(decay_epochs=40)})
    return jenv, tenv, jcfg, tcfg


def _lane(tree, f):
    return jax.tree.map(lambda x: x[f], tree)


def _state_vectors(jenv, n, seed):
    rng = np.random.default_rng(seed)
    X = np.eye(jenv.M, dtype=np.float32)[rng.integers(0, jenv.M, (n, jenv.N))]
    w = rng.uniform(0.8, 1.2, (n, jenv.workload.num_spouts)).astype(np.float32)
    return np.concatenate([X.reshape(n, -1), w], axis=1)


def _filled_state(jenv, jcfg, n_store=40, seed=0):
    """A reference fleet state whose buffers hold ``n_store`` transitions."""
    js, _ = carried_fleet(jcfg, F, seed)
    rng = np.random.default_rng(seed)
    store = jax.jit(jax.vmap(lambda st, s, a, r, sn: jddpg.store(
        st, s, a, r, sn, reward_scale=jcfg.reward_scale)))
    for _ in range(n_store):
        s = _state_vectors(jenv, F, rng.integers(1 << 30)).reshape(F, -1)
        sn = _state_vectors(jenv, F, rng.integers(1 << 30)).reshape(F, -1)
        a = np.eye(jenv.M, dtype=np.float32)[
            rng.integers(0, jenv.M, (F, jenv.N))].reshape(F, -1)
        r = -rng.uniform(2.0, 3.0, F).astype(np.float32)
        js = store(js, jnp.asarray(s), jnp.asarray(a), jnp.asarray(r),
                   jnp.asarray(sn))
    return js


def test_select_action_greedy_picks_the_same_assignment(setup):
    jenv, _, jcfg, tcfg = setup
    js, ts = carried_fleet(jcfg, F, seed=1)
    for seed in range(3):
        s = _state_vectors(jenv, F, seed)
        got = tddpg.select_action(ts, tcfg, to_torch(s), explore=False)
        for f in range(F):
            want = jddpg.select_action_jit(jax.random.PRNGKey(0), _lane(js, f),
                                           jcfg, jnp.asarray(s[f]),
                                           explore=False)
            assert_exact(got[f], want)


def test_select_action_exploring_with_injected_draws(setup):
    jenv, _, jcfg, tcfg = setup
    js, ts = carried_fleet(jcfg, F, seed=2)
    # epoch 20 of a 40-epoch decay: eps ≈ 0.5, so both coin sides occur
    js = js._replace(epoch=jnp.full((F,), 20, jnp.int32))
    ts.epoch = torch.full((F,), 20, dtype=torch.int32)
    eps = jcfg.eps(jnp.asarray(20, jnp.int32))
    coins = []
    for seed in range(4):
        s = _state_vectors(jenv, F, 10 + seed)
        keys = jax.random.split(jax.random.PRNGKey(seed), F)
        add, noise = [], []
        for k in keys:
            k_bern, k_noise = jax.random.split(k)
            add.append(bool(jax.random.bernoulli(k_bern, eps)))
            noise.append(np.asarray(jax.random.uniform(k_noise,
                                                       (jenv.N, jenv.M))))
        coins += add
        got = tddpg.select_action(ts, tcfg, to_torch(s), explore=True,
                                  add=torch.tensor(add),
                                  noise=to_torch(np.stack(noise)))
        for f, k in enumerate(keys):
            want = jddpg.select_action_jit(k, _lane(js, f), jcfg,
                                           jnp.asarray(s[f]), explore=True)
            assert_exact(got[f], want)
    assert any(coins) and not all(coins)


def test_update_step_with_injected_indices_matches_reference(setup):
    jenv, _, jcfg, _ = setup
    _, tcfg = setup[2], setup[3]
    js = _filled_state(jenv, jcfg)
    ts = ddpg_state_from_numpy(jax_tree_numpy(js), "cpu")
    keys = jax.random.split(jax.random.PRNGKey(3), F)
    idx = np.stack([np.asarray(jax.random.randint(
        k, (jcfg.batch,), 0, jnp.maximum(js.replay.size[f], 1)))
        for f, k in enumerate(keys)])
    ts, losses = tddpg.update_step(ts, tcfg, idx=to_torch(idx))
    want = [jddpg.update_step(k, _lane(js, f), jcfg) for f, k in enumerate(keys)]
    want_state = jax.tree.map(lambda *xs: np.stack(xs), *[w[0] for w in want])
    # atol 1e-6: the actor loss is a mean of Q values of both signs, ~0.1
    # each, so its float32 rounding is absolute, not relative to the mean
    for name in ("critic_loss", "actor_loss"):
        assert_f32(losses[name], [float(w[1][name]) for w in want], rtol=RTOL,
                   atol=1e-6)
    got = ddpg_state_to_numpy(ts)
    for part in ("actor", "critic", "target_actor", "target_critic"):
        assert_tree_f32(getattr(got, part), getattr(want_state, part),
                        rtol=RTOL, atol=PARAM_ATOL)
    assert_exact(got.opt_critic.step, want_state.opt_critic.step)
    # the first moment is 0.1·g: float32 rounding of the summed gradients
    # shows in its smallest entries, at ~1e-5 of the largest
    assert_tree_f32(got.opt_critic.mu, want_state.opt_critic.mu,
                    rtol=RTOL, atol=1e-8)
    assert_tree_f32(got.opt_actor.nu, want_state.opt_actor.nu,
                    rtol=RTOL, atol=1e-12)


def test_update_resets_reward_statistics_as_the_reference_does(setup):
    """The reference's update_step drops r_mean/r_var/r_count back to
    (0, 1, 0), so the next store standardizes its reward to exactly 0.  The
    port does the same (a reference fault, ROADMAP queue C)."""
    jenv, _, jcfg, tcfg = setup
    js = _filled_state(jenv, jcfg, n_store=10, seed=7)
    ts = ddpg_state_from_numpy(jax_tree_numpy(js), "cpu")
    assert int(ts.r_count[0]) == 10
    new = jddpg.update_step(jax.random.PRNGKey(0), _lane(js, 0), jcfg)[0]
    assert (float(new.r_mean), float(new.r_var), int(new.r_count)) == (0.0, 1.0, 0)
    s = _state_vectors(jenv, 1, 0)[0]
    stored = jddpg.store(new, jnp.asarray(s), jnp.zeros(jenv.N * jenv.M),
                         jnp.asarray(-2.5), jnp.asarray(s),
                         reward_scale=jcfg.reward_scale)
    assert float(stored.replay.rewards[stored.replay.ptr - 1]) == 0.0
    tddpg.update_step(ts, tcfg, idx=torch.zeros(F, jcfg.batch, dtype=torch.long))
    assert ts.r_mean.tolist() == [0.0] * F and ts.r_var.tolist() == [1.0] * F
    assert ts.r_count.tolist() == [0] * F
    s2 = to_torch(np.stack([s] * F))
    tddpg.store(ts, s2, torch.zeros(F, jenv.N * jenv.M),
                torch.full((F,), -2.5), s2, reward_scale=tcfg.reward_scale)
    ptr = ts.replay.ptr.long() - 1
    assert ts.replay.rewards[torch.arange(F), ptr].tolist() == [0.0] * F


def test_update_step_lanes_are_independent(setup):
    """Lane f of a fleet update equals the same update on lane f alone."""
    jenv, _, jcfg, tcfg = setup
    tree = jax_tree_numpy(_filled_state(jenv, jcfg, n_store=20, seed=4))
    idx = torch.randint(0, 20, (F, jcfg.batch),
                        generator=torch.Generator().manual_seed(0))
    fleet = tddpg.update_step(ddpg_state_from_numpy(tree, "cpu"), tcfg,
                              idx=idx)[0]
    for f in range(F):
        one = tddpg.update_step(ddpg_state_from_numpy(_lane(tree, f), "cpu"),
                                tcfg, idx=idx[f:f + 1])[0]
        for a, b in zip(fleet.actor.parameters(), one.actor.parameters()):
            assert torch.equal(a[f], b[0])
        for a, b in zip(fleet.target_critic.parameters(),
                        one.target_critic.parameters()):
            assert torch.equal(a[f], b[0])


def test_store_matches_reference(setup):
    jenv, _, jcfg, tcfg = setup
    js, ts = carried_fleet(jcfg, F, seed=5)
    rng = np.random.default_rng(5)
    store = jax.jit(jax.vmap(lambda st, s, a, r, sn: jddpg.store(
        st, s, a, r, sn, reward_scale=jcfg.reward_scale)))
    for t in range(70):                      # wraps the 64-slot ring
        s = _state_vectors(jenv, F, 100 + t)
        a = np.eye(jenv.M, dtype=np.float32)[
            rng.integers(0, jenv.M, (F, jenv.N))].reshape(F, -1)
        r = -rng.uniform(2.0, 3.0, F).astype(np.float32)
        js = store(js, jnp.asarray(s), jnp.asarray(a), jnp.asarray(r),
                   jnp.asarray(s))
        tddpg.store(ts, to_torch(s), to_torch(a), to_torch(r), to_torch(s),
                    reward_scale=tcfg.reward_scale)
    got, want = ddpg_state_to_numpy(ts), jax_tree_numpy(js)
    assert_exact(got.r_count, want.r_count)
    assert_f32(got.r_mean, want.r_mean, rtol=1e-6)
    assert_f32(got.r_var, want.r_var, rtol=1e-5)
    assert_exact(got.replay.ptr, want.replay.ptr)
    assert_exact(got.replay.size, want.replay.size)
    assert_exact(got.replay.actions, want.replay.actions)
    assert_f32(got.replay.rewards, want.replay.rewards, rtol=1e-5, atol=1e-6)


def test_offline_pretrain_with_injected_draws_matches_reference(setup):
    jenv, tenv, jcfg, tcfg = setup
    js, ts = carried_fleet(jcfg, F, seed=6)
    keys = jax.random.split(jax.random.PRNGKey(6), F)
    n, U = 50, 3
    draws = jax_offline_draws(keys, n=n, n_updates=U, B=jcfg.batch, N=jenv.N,
                              M=jenv.M, S=jenv.workload.num_spouts,
                              cap=jcfg.buffer)
    want = jax_tree_numpy(jax.jit(
        lambda k, s: jddpg.offline_pretrain_fleet(
            k, s, jcfg, jenv, n_samples=n, n_updates=U))(keys, js))
    got = ddpg_state_to_numpy(tddpg.offline_pretrain(
        ts, tcfg, tenv, n_samples=n, n_updates=U, draws=draws))
    assert_exact(got.r_count, want.r_count)
    assert_f32(got.r_mean, want.r_mean, rtol=RTOL)
    assert_f32(got.r_var, want.r_var, rtol=1e-4)   # a square of a std
    assert_exact(got.replay.ptr, want.replay.ptr)
    assert_exact(got.replay.size, want.replay.size)
    assert_exact(got.replay.actions, want.replay.actions)
    assert_f32(got.replay.states, want.replay.states, rtol=RTOL)
    assert_f32(got.replay.rewards, want.replay.rewards, rtol=1e-4, atol=1e-5)
    for part in ("actor", "critic", "target_actor", "target_critic"):
        assert_tree_f32(getattr(got, part), getattr(want, part), rtol=RTOL,
                        atol=PARAM_ATOL)
