"""The port's ``fault/straggler.py`` against the reference's: the detector on
seeded observation sequences (its straggler lists and float64 speed
factors exact), and ``mitigate_with_drl`` from DDPG states carried across
on the placement env (the re-assignment exact)."""
import jax
import numpy as np
import pytest

from test_torch_parity import assert_exact, jax_tree_numpy, torch

from repro.core import ddpg as jddpg
from repro.core import placement as jpl
from repro.fault import straggler as jst
from repro_torch.core import ddpg as tddpg
from repro_torch.core import jamba_placement_env
from repro_torch.core.convert import ddpg_state_from_numpy
from repro_torch.fault import StragglerDetector, mitigate_with_drl


def _sequence(rng, workers, steps):
    """Seeded (worker, step time) observations: a base time a worker, one
    or two slow workers, noise, and some workers never seen."""
    base = rng.uniform(0.5, 2.0)
    slow = rng.choice(workers, size=rng.integers(1, 3), replace=False)
    unseen = set(rng.choice(workers, size=rng.integers(0, workers // 3 + 1),
                            replace=False).tolist())
    seq = []
    for _ in range(steps):
        for w in rng.permutation(workers):
            if w in unseen:
                continue
            t = base * rng.lognormal(0.0, 0.1) * (rng.uniform(1.4, 3.0)
                                                   if w in slow else 1.0)
            seq.append((int(w), float(t)))
    return seq


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("workers,alpha,threshold",
                         [(4, 0.2, 1.5), (16, 0.2, 1.5), (9, 0.5, 1.2)])
def test_detector_matches_reference(seed, workers, alpha, threshold):
    """After every observation: the same stragglers, and speed factors equal
    in float64 (the same numpy arithmetic)."""
    rng = np.random.default_rng(seed)
    got = StragglerDetector(workers, alpha=alpha, threshold=threshold)
    want = jst.StragglerDetector(workers, alpha=alpha, threshold=threshold)
    assert got.stragglers() == want.stragglers() == []
    np.testing.assert_array_equal(got.speed_factors(), want.speed_factors())
    for w, t in _sequence(rng, workers, steps=5):
        got.observe(w, t)
        want.observe(w, t)
        assert got.stragglers() == want.stragglers()
        f, g = got.speed_factors(), want.speed_factors()
        assert f.dtype == g.dtype == np.float64
        np.testing.assert_array_equal(f, g)
    np.testing.assert_array_equal(got.count, want.count)


@pytest.fixture(scope="module")
def placement():
    """The placement env on both sides, an equal DDPG config and a
    reference state after a short offline pretraining, carried across as a
    fleet of one."""
    jenv, tenv = jpl.jamba_placement_env(), jamba_placement_env(device="cpu")
    kw = dict(n_executors=jenv.N, n_machines=jenv.M, state_dim=jenv.state_dim,
              k_nn=8, batch=8, reward_scale=1.0)
    jcfg, tcfg = jddpg.DDPGConfig(**kw), tddpg.DDPGConfig(**kw)
    js = jddpg.offline_pretrain(jax.random.PRNGKey(1),
                                jddpg.init_state(jax.random.PRNGKey(0), jcfg),
                                jcfg, jenv, n_samples=24, n_updates=4)
    tree = jax_tree_numpy(jax.tree.map(lambda x: x[None], js))
    return jenv, tenv, jcfg, tcfg, js, ddpg_state_from_numpy(tree, "cpu")


@pytest.mark.parametrize("slow,factor", [(5, 2.2), (0, 3.0), (11, 1.6), (None, 1.0)])
def test_mitigate_with_drl_matches_reference(placement, slow, factor):
    """The reference example's detector (8 rounds, one device slow), or
    none slow: the same one-hot re-assignment [E, D]."""
    jenv, tenv, jcfg, tcfg, js, ts = placement
    dets = [jst.StragglerDetector(jenv.M), StragglerDetector(tenv.M)]
    for _ in range(8):
        for d in range(jenv.M):
            for det in dets:
                det.observe(d, factor if d == slow else 1.0)
    want = jst.mitigate_with_drl(dets[0], jenv, js, jcfg, jax.random.PRNGKey(9))
    got = mitigate_with_drl(dets[1], tenv, ts, tcfg,
                            torch.Generator().manual_seed(9))
    assert got.shape == (tenv.N, tenv.M)
    assert_exact(got, want)
    assert (got.sum(-1) == 1).all()


def test_mitigate_with_drl_takes_one_lane(placement):
    _, tenv, _, tcfg, _, _ = placement
    two = tddpg.init_state(torch.Generator().manual_seed(0), tcfg, 2, "cpu")
    with pytest.raises(ValueError, match="one agent lane"):
        mitigate_with_drl(StragglerDetector(tenv.M), tenv, two, tcfg)
