"""The port's reward curves against the reference's committed artifact,
and the harness's pieces that need no training: Storm's default on every
app, and the model-based baseline at cq_large on the reference's draws.

``reward.run("cq_small", Budget.quick() at 60 online epochs, seed=0)``
draws from the port's own generators (C4), so it is held to the
reference's ``artifacts/paper/reward_cq_small.json`` (written by
``benchmarks/paper_reward.py`` at the same budget) in distribution: over
the last fifth of epochs, for actor-critic and DQN, the two seed bands
overlap at every epoch, |mean − mean_ref| ≤ std + std_ref."""
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest

from test_torch_figures import JTINY, MB_RTOL, SEED, TINY
from test_torch_parity import assert_exact, assert_f32, jax_fit_draws, torch

from benchmarks import paper_common as jpc
from repro_torch.figures import common, reward

REPO = pathlib.Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "artifacts" / "paper" / "reward_cq_small.json"
APPS = ("cq_small", "cq_medium", "cq_large", "log_stream", "word_count")


def test_reward_band_overlaps_the_committed_artifact():
    want = json.loads(ARTIFACT.read_text())
    budget = dataclasses.replace(common.Budget.quick(),
                                 online_epochs=want["epochs"])
    got = reward.run("cq_small", budget, seed=0, device="cpu")
    assert list(got) == list(want)
    assert (got["epochs"], got["n_seeds"]) == (want["epochs"], want["n_seeds"])
    last = max(want["epochs"] // 5, 1)
    for name in ("ac", "dqn"):
        mean, std = (np.asarray(got[f"{name}_smoothed_{k}"][-last:])
                     for k in ("mean", "std"))
        mean_ref, std_ref = (np.asarray(want[f"{name}_smoothed_{k}"][-last:])
                             for k in ("mean", "std"))
        assert np.isfinite(mean).all() and (std >= 0).all()
        gap = np.abs(mean - mean_ref) - (std + std_ref)
        assert (gap <= 0).all(), (name, gap.max())


@pytest.mark.parametrize("app", APPS)
def test_run_default_matches_the_reference(app):
    """Storm's EvenScheduler latency, noise-free, at float32 tolerance."""
    got = common.run_default(common.make_env(app, "cpu"))
    assert_f32(got, jpc.run_default(jpc.make_env(app)), rtol=1e-5)


def test_run_model_based_at_cq_large_matches_the_reference():
    """The search at the large topology (100 executors; 58 unknowns fitted
    from 60 samples): the same fit draws give the same schedule, with no
    C5 near tie, and the same latency."""
    jenv, env = jpc.make_env("cq_large"), common.make_env("cq_large", "cpu")
    A, Z = jax_fit_draws(jax.random.PRNGKey(SEED), TINY.mb_samples, jenv.N, jenv.M)
    lat, X = common.run_model_based(env, TINY, SEED, assignments=A, meas_z=Z)
    jlat, jX = jpc.run_model_based(jenv, JTINY, SEED)
    assert_f32(lat, jlat, rtol=MB_RTOL)
    assert_exact(X, jX)


def test_budgets_are_the_references():
    for name in ("quick", "paper", "validated"):
        got = getattr(common.Budget, name)()
        assert vars(got) == vars(getattr(jpc.Budget, name)())


def test_make_env_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.make_env("cq_small")
    assert common.make_env("cq_small", "cpu").device.type == "cpu"
