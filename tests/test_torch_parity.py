"""Shared parity helpers for the PyTorch port's tests, and their own tests.

The port (``repro_torch``) and the JAX reference (``repro``) run in one
CPU process on the same numpy inputs.  Torch cannot replay the reference's
threefry draws, so :func:`jax_epoch_draws` / :func:`jax_offline_draws`
replay the reference's key discipline with ``jax.random`` and hand the
resulting numbers to the port as ``EpochDraws`` / ``OfflineDraws`` (and
:func:`jax_fit_draws` the model-based fit's):

  * ``run_online_fleet``: each lane key splits into (reset key, loop key)
    (core/agent.py prepare_fleet); every epoch
    ``key, k_act, k_step, k_upd = split(key, 4)`` (core/api.py);
  * ``split(k_act)`` → ε coin (bernoulli), and from the second key DDPG's
    uniform noise or DQN's random move ``randint(·, (), 0, N·M)``
    (core/exploration.py);
  * the Gumbel draw of a ``jax.random.categorical``: Stream AC(λ)'s
    ``categorical(k_act, logits [N, M])`` draws ``gumbel(k_act, (N, M))``,
    graph_policy's random valid move ``categorical(k_rand, [N·M])`` draws
    ``gumbel(k_rand, (N·M,))`` from the second key of ``split(k_act)``
    (core/stream_ac.py, core/graph_policy.py);
  * ``split(k_step)`` → measurement noise ``normal(·, (5,))``, rate walk
    ``normal(·, (S,))`` (dsdps/env.py, simulator.py, workload.py); on the
    expert-placement env the step-time noise ``normal(·, ())`` and the load
    drift ``normal(·, (E,))`` (core/placement.py): ``meas_shape=()``;
  * ``split(k_upd, U)`` → ``randint(k, (B,), 0, max(size, 1))``
    (core/replay.py);
  * ``offline_pretrain``: ``k_env, k_upd = split(key)``, one
    ``split(k_env, n)`` key per sample, split into (assignment, step), and
    ``split(k_upd, n_updates)`` replay keys (core/ddpg.py);
  * the model-based ``fit_theta``: one ``split(key, n)`` key per sample,
    split into (assignment, measurement) (core/model_based.py).

Other test files import these helpers as ``from test_torch_parity import
...``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import ddpg as jddpg                      # noqa: E402
from repro.core import exploration as jexpl               # noqa: E402
from repro.dsdps import SchedulingEnv as JaxEnv           # noqa: E402
from repro.dsdps import apps as japps                     # noqa: E402
from repro_torch.core import ddpg as tddpg                # noqa: E402
from repro_torch.core.api import EpochDraws               # noqa: E402
from repro_torch.core.convert import (ddpg_state_from_numpy,  # noqa: E402
                                      ddpg_state_to_numpy)
from repro_torch.core.ddpg import OfflineDraws            # noqa: E402
from repro_torch.core.exploration import perturb_proto    # noqa: E402
from repro_torch.dsdps import SchedulingEnv as TorchEnv   # noqa: E402
from repro_torch.dsdps import apps as tapps               # noqa: E402

N_MEAS = 5


# --------------------------------------------------------------------------
# conversion and asserts
# --------------------------------------------------------------------------
def to_torch(x, dtype=None):
    """numpy / jax array → CPU tensor (a copy)."""
    return torch.tensor(np.asarray(x), dtype=dtype)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_exact(got, want):
    """Integer / one-hot / index outputs: identical."""
    np.testing.assert_array_equal(to_numpy(got), to_numpy(want))


def assert_f32(got, want, rtol=1e-5, atol=0.0):
    """float32 outputs at a stated tolerance."""
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=rtol,
                               atol=atol)


def jax_tree_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def assert_tree_f32(got, want, rtol=1e-5, atol=0.0):
    """Every leaf of two numpy pytrees of the same structure."""
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def assert_tree_scaled(got, want, rtol=1e-5, scale_atol=1e-6):
    """Every leaf at ``rtol``, with an absolute slack of ``scale_atol`` times
    the leaf's largest magnitude (at least 1): a trace or a weight element
    is a float32 sum of terms as large as the leaf's largest, so its
    rounding error scales with the leaf, not with the element."""
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        atol = scale_atol * max(1.0, float(np.abs(b).max(initial=0.0)))
        np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# environments and agent states on both sides
# --------------------------------------------------------------------------
def env_pair(app: str = "cq_small"):
    """(reference env, port env on the CPU) of one app."""
    jt, tt = japps.ALL_APPS[app](), tapps.ALL_APPS[app]()
    return (JaxEnv(jt, japps.default_workload(jt)),
            TorchEnv(tt, tapps.default_workload(tt), device="cpu"))


def cfg_pair(env, **overrides):
    """Equal DDPG configs on both sides (the port has no pallas switch)."""
    jc = jddpg.DDPGConfig(n_executors=env.N, n_machines=env.M,
                          state_dim=env.state_dim, **overrides)
    tc = tddpg.DDPGConfig(n_executors=env.N, n_machines=env.M,
                          state_dim=env.state_dim, **overrides)
    return jc, tc


def carried_fleet(jcfg, fleet: int, seed: int = 0):
    """A reference fleet state and the port's copy of it."""
    js = jddpg.init_fleet(jax.random.PRNGKey(seed), jcfg, fleet)
    return js, ddpg_state_from_numpy(jax_tree_numpy(js), "cpu")


# --------------------------------------------------------------------------
# draw replay
# --------------------------------------------------------------------------
def jax_epoch_draws(keys, T: int, U: int, B: int, N: int, M: int, S: int,
                    eps=None, epoch0: int = 0, size0: int = 0,
                    cap: int = 1000, gumbel: str = "act",
                    meas_shape: tuple = (N_MEAS,)):
    """The per-epoch draws ``run_online_fleet(keys, ...)`` makes for every
    lane, as ``T`` port ``EpochDraws``.  ``eps`` is the reference's
    EpsilonSchedule; the replay size before epoch t's update is
    ``min(size0 + t + 1, cap)`` (one store per epoch).  ``gumbel`` names
    the key of the categorical draw: ``"act"`` (Stream AC(λ)) or
    ``"rand"`` (graph_policy's random move, reshaped to ``[N, M]``).
    ``meas_shape`` is one lane's measurement draw: ``(5,)`` on a DSDPS env,
    ``()`` on the expert-placement env (whose ``S`` is its expert count)."""
    eps = jexpl.EpsilonSchedule() if eps is None else eps
    lanes = []
    for lane_key in jnp.asarray(keys):
        _, key = jax.random.split(lane_key)
        per_epoch = []
        for t in range(T):
            key, k_act, k_step, k_upd = jax.random.split(key, 4)
            k_bern, k_noise = jax.random.split(k_act)
            add = jax.random.bernoulli(
                k_bern, eps(jnp.asarray(epoch0 + t, jnp.int32)))
            noise = jax.random.uniform(k_noise, (N, M))
            move = jax.random.randint(k_noise, (), 0, N * M)
            k_meas, k_w = jax.random.split(k_step)
            size = min(size0 + t + 1, cap)
            idx = [jax.random.randint(k, (B,), 0, max(size, 1))
                   for k in jax.random.split(k_upd, U)]
            g = (jax.random.gumbel(k_act, (N, M)) if gumbel == "act" else
                 jax.random.gumbel(k_noise, (N * M,)).reshape(N, M))
            per_epoch.append((add, noise, move,
                              jax.random.normal(k_meas, meas_shape),
                              jax.random.normal(k_w, (S,)), jnp.stack(idx), g))
        lanes.append(per_epoch)
    out = []
    for t in range(T):
        cols = list(zip(*(lane[t] for lane in lanes)))
        out.append(EpochDraws(*(to_torch(np.stack([np.asarray(x) for x in c]))
                                for c in cols)))
    return out


def jax_offline_draws(keys, n: int, n_updates: int, B: int, N: int, M: int,
                      S: int, cap: int = 1000,
                      meas_shape: tuple = (N_MEAS,)) -> OfflineDraws:
    """The draws ``offline_pretrain_fleet(keys, ...)`` makes, per lane
    (``meas_shape`` as in :func:`jax_epoch_draws`)."""
    take = min(n, cap)
    lanes = []
    for key in jnp.asarray(keys):
        k_env, k_upd = jax.random.split(key)
        assign, meas, rate = [], [], []
        for k in jax.random.split(k_env, n):
            k_a, k_step = jax.random.split(k)
            assign.append(jax.random.randint(k_a, (N,), 0, M))
            k_meas, k_w = jax.random.split(k_step)
            meas.append(jax.random.normal(k_meas, meas_shape))
            rate.append(jax.random.normal(k_w, (S,)))
        idx = [jax.random.randint(k, (B,), 0, max(take, 1))
               for k in jax.random.split(k_upd, n_updates)]
        lanes.append([np.stack([np.asarray(x) for x in xs])
                      for xs in (assign, meas, rate, idx)])
    return OfflineDraws(*(to_torch(np.stack(c)) for c in zip(*lanes)))


def jax_fit_draws(key, n, N, M):
    """The model-based ``fit_theta(key, ...)``'s draws: ``split(key, n)``,
    each split into the assignment key and the measurement key.  Returns
    ``(assignments [n, N], meas_z [n, 5])``."""
    A, Z = [], []
    for k in jax.random.split(key, n):
        k_a, k_n = jax.random.split(k)
        A.append(np.asarray(jax.random.randint(k_a, (N,), 0, M)))
        Z.append(np.asarray(jax.random.normal(k_n, (N_MEAS,))))
    return to_torch(np.stack(A)), to_torch(np.stack(Z))


def numpy_epoch_draws(rng, F, T, U, B, N, M, S):
    """``T`` epochs of draws from a numpy generator (the port against
    itself: lanes, devices, stack forms); replay rows ``< t + 1``.  The
    Gumbel draws come last, after every epoch's other draws."""
    draws = [dict(
        explore_add=torch.as_tensor(rng.uniform(size=F) < 0.6),
        explore_noise=torch.as_tensor(rng.uniform(size=(F, N, M)).astype(np.float32)),
        meas_z=torch.as_tensor(rng.normal(size=(F, 5)).astype(np.float32)),
        rate_z=torch.as_tensor(rng.normal(size=(F, S)).astype(np.float32)),
        replay_idx=torch.as_tensor(rng.integers(0, t + 1, (F, U, B))),
        explore_move=torch.as_tensor(rng.integers(0, N * M, F)))
        for t in range(T)]
    return [EpochDraws(**d, explore_gumbel=torch.as_tensor(
        rng.gumbel(size=(F, N, M)).astype(np.float32))) for d in draws]


# --------------------------------------------------------------------------
# the helpers' own tests
# --------------------------------------------------------------------------
def test_ddpg_state_roundtrips_through_numpy():
    jenv, _ = env_pair()
    jcfg, _ = cfg_pair(jenv, k_nn=4)
    js, ts = carried_fleet(jcfg, fleet=2)
    want = jax_tree_numpy(js)
    back = ddpg_state_to_numpy(ts)
    assert_tree_f32(back, want, rtol=0)
    # a single lane gains the fleet axis
    one = jax.tree.map(lambda x: np.asarray(x)[1], want)
    ts1 = ddpg_state_from_numpy(one, "cpu")
    assert ts1.fleet == 1
    assert_tree_f32(jax.tree.map(lambda x: x[0], ddpg_state_to_numpy(ts1)),
                    one, rtol=0)


def test_target_nets_are_copies_not_aliases():
    jenv, _ = env_pair()
    jcfg, _ = cfg_pair(jenv, k_nn=4)
    _, ts = carried_fleet(jcfg, fleet=1)
    for online, target in ((ts.actor, ts.target_actor),
                           (ts.critic, ts.target_critic)):
        for p, q in zip(online.parameters(), target.parameters()):
            assert torch.equal(p, q)
            assert p.data_ptr() != q.data_ptr()
            assert p.requires_grad and not q.requires_grad


def test_epoch_draws_replay_the_reference_exploration():
    """Replayed (coin, noise) reproduce the reference's perturb_proto."""
    N, M, F = 6, 4, 3
    keys = jax.random.split(jax.random.PRNGKey(3), F)
    draws = jax_epoch_draws(keys, T=2, U=2, B=5, N=N, M=M, S=2,
                            eps=jexpl.EpsilonSchedule(decay_epochs=4))
    proto = np.random.default_rng(0).uniform(size=(F, N, M)).astype(np.float32)
    for t, d in enumerate(draws):
        got = perturb_proto(to_torch(proto), None, add=d.explore_add,
                            noise=d.explore_noise)
        for f, lane_key in enumerate(keys):
            key = jax.random.split(lane_key)[1]
            for _ in range(t + 1):
                key, k_act, _, _ = jax.random.split(key, 4)
            eps = jexpl.EpsilonSchedule(decay_epochs=4)(jnp.asarray(t))
            want = jexpl.perturb_proto(k_act, jnp.asarray(proto[f]), eps)
            assert_exact(got[f], want)
        assert d.replay_idx.shape == (F, 2, 5)
        assert int(d.replay_idx.max()) <= t


def test_epoch_draws_replay_the_reference_env_step():
    """Replayed (meas_z, rate_z) reproduce the reference's env.step."""
    jenv, tenv = env_pair()
    F = 2
    keys = jax.random.split(jax.random.PRNGKey(8), F)
    d = jax_epoch_draws(keys, T=1, U=1, B=4, N=jenv.N, M=jenv.M,
                        S=jenv.workload.num_spouts)[0]
    X = np.eye(jenv.M, dtype=np.float32)[
        np.random.default_rng(1).integers(0, jenv.M, (F, jenv.N))]
    ts = tenv.reset(F)
    out = tenv.step(ts, to_torch(X), meas_z=d.meas_z, rate_z=d.rate_z)
    for f, lane_key in enumerate(keys):
        key = jax.random.split(lane_key)[1]
        _, _, k_step, _ = jax.random.split(key, 4)
        jo = jenv.step(k_step, jenv.reset(lane_key), jnp.asarray(X[f]))
        assert_f32(out.latency_ms[f], jo.latency_ms, rtol=1e-5)
        assert_f32(out.state.w[f], jo.state.w, rtol=1e-6)
        assert_exact(out.moved[f], jo.moved)


def test_offline_draws_match_the_reference_random_assignments():
    jenv, _ = env_pair()
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    d = jax_offline_draws(keys, n=4, n_updates=3, B=5, N=jenv.N, M=jenv.M,
                          S=jenv.workload.num_spouts)
    assert d.assignments.shape == (2, 4, jenv.N)
    assert d.replay_idx.shape == (2, 3, 5) and int(d.replay_idx.max()) < 4
    k_env, _ = jax.random.split(keys[1])
    k_a, _ = jax.random.split(jax.random.split(k_env, 4)[2])
    want = jenv.random_assignment(k_a).argmax(-1)
    assert_exact(d.assignments[1, 2], want)
