"""The port's nets, Adam, replay buffer and exploration against the
reference (core/networks.py, train/optimizer.py, core/replay.py,
core/exploration.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, to_numpy, to_torch,
                               torch)

from repro.core import exploration as jexpl
from repro.core import networks as jnets
from repro.core import replay as jreplay
from repro.train import optimizer as joptim
from repro_torch.core import exploration as texpl
from repro_torch.core import networks as tnets
from repro_torch.core import replay as treplay
from repro_torch.train import optimizer as toptim

S_DIM, A_DIM, F = 12, 8, 3


def _fleet_params(init, seed):
    """F reference MLPs (stacked arrays) and the port's FleetMLP of them."""
    keys = jax.random.split(jax.random.PRNGKey(seed), F)
    p = jax.vmap(lambda k: init(k, S_DIM, A_DIM))(keys)
    # non-zero biases, so the bias path is exercised
    p = p._replace(biases=tuple(
        b + 0.1 * jax.random.normal(jax.random.PRNGKey(9 + i), b.shape)
        for i, b in enumerate(p.biases)))
    net = tnets.FleetMLP([to_torch(w) for w in p.weights],
                         [to_torch(b) for b in p.biases])
    return p, net


def test_actor_and_critic_forward_match_reference():
    ja, ta = _fleet_params(jnets.init_actor, 0)
    jc, tc = _fleet_params(jnets.init_critic, 1)
    rng = np.random.default_rng(0)
    s = rng.uniform(size=(F, 5, S_DIM)).astype(np.float32)
    a = rng.uniform(size=(F, 5, A_DIM)).astype(np.float32)
    with torch.no_grad():
        got_a = tnets.apply_actor(ta, to_torch(s))
        got_q = tnets.apply_critic(tc, to_torch(s), to_torch(a))
        # a state [F, 1, S] broadcasts over K candidate actions
        got_qk = tnets.apply_critic(tc, to_torch(s[:, :1]), to_torch(a))
    want_a = jax.vmap(jax.vmap(jnets.apply_actor, (None, 0)))(ja, s)
    want_q = jax.vmap(jax.vmap(jnets.apply_critic, (None, 0, 0)))(jc, s, a)
    want_qk = jax.vmap(jax.vmap(jnets.apply_critic, (None, None, 0)))(
        jc, s[:, 0], a)
    assert_f32(got_a, want_a, rtol=1e-6, atol=1e-6)
    assert_f32(got_q, want_q, rtol=1e-6, atol=1e-6)
    assert_f32(got_qk, want_qk, rtol=1e-6, atol=1e-6)


def test_glorot_init_shapes_and_limits():
    net = tnets.init_critic(S_DIM, A_DIM, F, torch.Generator().manual_seed(0),
                            "cpu")
    sizes = (S_DIM + A_DIM, *tnets.HIDDEN, 1)
    for w, b, din, dout in zip(net.weights, net.biases, sizes[:-1], sizes[1:]):
        w, b = w.detach(), b.detach()
        assert w.shape == (F, din, dout) and b.shape == (F, dout)
        lim = np.sqrt(6.0 / (din + dout))
        assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.5 * lim
        assert float(b.abs().max()) == 0.0
    # lanes are independent draws
    assert not torch.equal(net.weights[0][0], net.weights[0][1])


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_one_adam_step_matches_reference(weight_decay):
    jp, tnet = _fleet_params(jnets.init_actor, 2)
    params = list(tnet.parameters())
    rng = np.random.default_rng(1)
    opt_j = joptim.adamw(1e-3, weight_decay=weight_decay)
    opt_t = toptim.adamw(1e-3, weight_decay=weight_decay)
    # two steps from a non-trivial moment state; lanes at different steps
    js = jax.vmap(opt_j.init)(jp)
    js = js._replace(step=jnp.asarray([0, 3, 7], jnp.int32))
    ts = opt_t.init(params)
    ts.step = to_torch(np.asarray([0, 3, 7], np.int32))
    for _ in range(2):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), jp)
        j_upd, js = jax.vmap(opt_j.update)(grads, js, jp)
        jp = joptim.apply_updates(jp, j_upd)
        t_grads = [to_torch(g) for g in (*grads.weights, *grads.biases)]
        t_upd, ts = opt_t.update(t_grads, ts, params)
        toptim.apply_updates(params, t_upd)
    assert_exact(ts.step, js.step)
    for got, want in zip(params, (*jp.weights, *jp.biases)):
        assert_f32(got, want, rtol=1e-6, atol=1e-6)
    for got, want in zip(ts.nu, (*js.nu.weights, *js.nu.biases)):
        assert_f32(got, want, rtol=1e-6)


def test_soft_update_matches_reference():
    jt, tt = _fleet_params(jnets.init_critic, 3)
    jo, to = _fleet_params(jnets.init_critic, 4)
    want = jnets.soft_update(jt, jo, 0.01)
    tnets.soft_update(tt, to, 0.01)
    for got, w in zip(tt.parameters(), (*want.weights, *want.biases)):
        assert_f32(got, w, rtol=1e-6, atol=1e-7)


def test_replay_add_and_sample_with_injected_indices_including_wraparound():
    cap, B = 5, 4
    rng = np.random.default_rng(2)
    jbufs = [jreplay.replay_init(cap, S_DIM, A_DIM) for _ in range(2)]
    tbuf = treplay.replay_init(2, cap, S_DIM, A_DIM, "cpu")
    for t in range(8):                     # wraps the ring once and more
        s = rng.normal(size=(2, S_DIM)).astype(np.float32)
        a = rng.normal(size=(2, A_DIM)).astype(np.float32)
        r = rng.normal(size=2).astype(np.float32)
        sn = rng.normal(size=(2, S_DIM)).astype(np.float32)
        jbufs = [jreplay.replay_add(b, s[f], a[f], r[f], sn[f])
                 for f, b in enumerate(jbufs)]
        treplay.replay_add(tbuf, to_torch(s), to_torch(a), to_torch(r),
                           to_torch(sn))
        keys = jax.random.split(jax.random.PRNGKey(t), 2)
        idx = np.stack([np.asarray(jax.random.randint(
            k, (B,), 0, jnp.maximum(b.size, 1))) for k, b in zip(keys, jbufs)])
        got = treplay.replay_sample(tbuf, to_torch(idx))
        for f, (k, b) in enumerate(zip(keys, jbufs)):
            want = jreplay.replay_sample(k, b, B)
            for g, w in zip(got, want):
                assert_exact(g[f], w)
    for f, b in enumerate(jbufs):
        assert_exact(tbuf.ptr[f], b.ptr)
        assert_exact(tbuf.size[f], b.size)
        assert_exact(tbuf.states[f], b.states)
        assert_exact(tbuf.rewards[f], b.rewards)


def test_replay_add_many_equals_one_at_a_time():
    rng = np.random.default_rng(3)
    s = to_torch(rng.normal(size=(2, 4, S_DIM)).astype(np.float32))
    a = to_torch(rng.normal(size=(2, 4, A_DIM)).astype(np.float32))
    r = to_torch(rng.normal(size=(2, 4)).astype(np.float32))
    one, many = (treplay.replay_init(2, 6, S_DIM, A_DIM, "cpu") for _ in range(2))
    for buf in (one, many):                 # start mid-ring
        treplay.replay_add(buf, s[:, 0], a[:, 0], r[:, 0], s[:, 0])
        treplay.replay_add(buf, s[:, 1], a[:, 1], r[:, 1], s[:, 1])
        treplay.replay_add(buf, s[:, 2], a[:, 2], r[:, 2], s[:, 2])
    for i in range(4):
        treplay.replay_add(one, s[:, i], a[:, i], r[:, i], s[:, i])
    treplay.replay_add(many, s, a, r, s)
    for x, y in zip((one.states, one.rewards, one.ptr, one.size),
                    (many.states, many.rewards, many.ptr, many.size)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="do not fit"):
        treplay.replay_add(many, s.repeat(1, 2, 1), a.repeat(1, 2, 1),
                           r.repeat(1, 2), s.repeat(1, 2, 1))


def test_generated_replay_indices_stay_in_the_filled_prefix():
    buf = treplay.replay_init(3, 10, 2, 2, "cpu")
    buf.size = torch.tensor([0, 1, 7], dtype=torch.int32)
    idx = treplay.sample_indices(buf, 64, torch.Generator().manual_seed(0))
    assert idx.shape == (3, 64)
    assert int(idx[0].max()) == 0 and int(idx[1].max()) == 0
    assert int(idx[2].max()) <= 6 and int(idx[2].min()) >= 0
    assert len(torch.unique(idx[2])) > 3


def test_epsilon_schedule_matches_reference():
    sched_j = jexpl.EpsilonSchedule(eps_start=0.9, eps_end=0.05, decay_epochs=30)
    sched_t = texpl.EpsilonSchedule(eps_start=0.9, eps_end=0.05, decay_epochs=30)
    epochs = np.asarray([0, 1, 7, 29, 30, 31, 500], np.int32)
    assert_exact(sched_t(to_torch(epochs)), sched_j(jnp.asarray(epochs)))


def test_perturb_proto_with_injected_draws_matches_reference():
    rng = np.random.default_rng(4)
    proto = rng.uniform(size=(F, 6, 4)).astype(np.float32)
    eps = np.asarray([0.0, 0.5, 1.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(6), F)
    add, noise, want = [], [], []
    for f, k in enumerate(keys):
        k_bern, k_noise = jax.random.split(k)
        add.append(bool(jax.random.bernoulli(k_bern, eps[f])))
        noise.append(np.asarray(jax.random.uniform(k_noise, (6, 4))))
        want.append(jexpl.perturb_proto(k, jnp.asarray(proto[f]), eps[f]))
    got = texpl.perturb_proto(to_torch(proto), to_torch(eps),
                              add=torch.tensor(add),
                              noise=to_torch(np.stack(noise)))
    assert_exact(got, np.stack([np.asarray(w) for w in want]))
    assert add[0] is False and add[2] is True
    # drawn from a generator: ε = 0 never perturbs, ε = 1 always does
    g = torch.Generator().manual_seed(0)
    drawn = texpl.perturb_proto(to_torch(proto), to_torch(eps), gen=g)
    assert torch.equal(drawn[0], to_torch(proto[0]))
    assert not torch.equal(drawn[2], to_torch(proto[2]))
    assert to_numpy(drawn[2] - to_torch(proto[2])).min() >= 0.0
