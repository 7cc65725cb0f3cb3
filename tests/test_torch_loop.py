"""The slice as a whole: the port's online control loop against the
reference's ``run_online_fleet``, the port's own lane invariants, the
launcher, and the package's import boundary."""
import ast
import pathlib

import jax
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, carried_fleet,
                               cfg_pair, env_pair, jax_epoch_draws,
                               numpy_epoch_draws, torch)

from repro.core import make_agent as jax_make_agent
from repro.core.agent import History as JaxHistory
from repro.core.agent import run_online_fleet as jax_run_online_fleet
from repro_torch.core import EpochDraws, make_agent, run_online_fleet
from repro_torch.core.agent import History
from repro_torch.core.convert import ddpg_state_from_numpy, ddpg_state_to_numpy
from repro_torch.dsdps import SchedulingEnv, apps
from repro_torch.launch import drl_control

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_online_fleet_matches_reference_run_online_fleet():
    """cq_small, F=2, T=6, U=1 from carried reference init states, with the
    reference's draws replayed."""
    jenv, tenv = env_pair("cq_small")
    jcfg, tcfg = cfg_pair(jenv)
    F, T = 2, 6
    js, ts = carried_fleet(jcfg, F, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(11), F)
    js_end, jh = jax_run_online_fleet(keys, jenv,
                                      jax_make_agent("ddpg", jenv, cfg=jcfg),
                                      js, T=T, updates_per_epoch=1)
    draws = jax_epoch_draws(keys, T=T, U=1, B=jcfg.batch, N=jenv.N, M=jenv.M,
                            S=jenv.workload.num_spouts, eps=jcfg.eps,
                            cap=jcfg.buffer)
    agent = make_agent("ddpg", tenv, cfg=tcfg)
    ts_end, th = run_online_fleet(0, tenv, agent, ts, T, updates_per_epoch=1,
                                  draws=draws)
    assert th.rewards.shape == (F, T)
    assert_exact(th.moved, jh.moved)
    assert_exact(th.final_assignment, jh.final_assignment)
    # rtol 1e-4: six epochs of learning compound the float32 reduction-
    # order differences of every forward/backward pass
    assert_f32(th.latencies, jh.latencies, rtol=1e-4)
    assert_f32(th.rewards, jh.rewards, rtol=1e-4)
    assert th.moved.sum() > 0
    # the replay buffers the loop wrote, standardized rewards included
    got, want = ddpg_state_to_numpy(ts_end).replay, jax.tree.map(np.asarray,
                                                                 js_end.replay)
    assert_exact(got.ptr, want.ptr)
    assert_exact(got.actions, want.actions)
    assert_f32(got.rewards, want.rewards, rtol=1e-4, atol=1e-6)


def _lane_draws(draws, f):
    return [EpochDraws(*(x[f:f + 1] for x in d)) for d in draws]


def test_a_lane_of_a_fleet_equals_the_single_run_exactly():
    topo = apps.continuous_queries("small")
    env = SchedulingEnv(topo, apps.default_workload(topo), device="cpu")
    agent = make_agent("ddpg", env, k_nn=8, batch=16)
    F, T, U = 3, 5, 2
    init = ddpg_state_to_numpy(agent.init_fleet(torch.Generator().manual_seed(1), F, "cpu"))
    draws = numpy_epoch_draws(np.random.default_rng(2), F, T, U, 16, env.N, env.M,
                         env.workload.num_spouts)
    fleet_states, fleet = run_online_fleet(
        0, env, agent, ddpg_state_from_numpy(init, "cpu"), T,
        updates_per_epoch=U, draws=draws)
    for f in range(F):
        lane_init = jax.tree.map(lambda x, f=f: x[f:f + 1], init)
        one_states, one = run_online_fleet(
            0, env, agent, ddpg_state_from_numpy(lane_init, "cpu"), T,
            updates_per_epoch=U, draws=_lane_draws(draws, f))
        lane = fleet.lane(f)
        np.testing.assert_array_equal(lane.rewards, one.rewards[0])
        np.testing.assert_array_equal(lane.latencies, one.latencies[0])
        np.testing.assert_array_equal(lane.moved, one.moved[0])
        np.testing.assert_array_equal(lane.final_assignment,
                                      one.final_assignment[0])
        for a, b in zip(fleet_states.critic.parameters(),
                        one_states.critic.parameters()):
            assert torch.equal(a[f], b[0])


def test_generator_driven_fleet_is_reproducible_and_finite():
    topo = apps.continuous_queries("small")
    env = SchedulingEnv(topo, apps.default_workload(topo), device="cpu")
    agent = make_agent("ddpg", env, k_nn=8, batch=8)
    runs = []
    for _ in range(2):
        states = agent.init_fleet(torch.Generator().manual_seed(0), 2, "cpu")
        _, h = run_online_fleet(7, env, agent, states, 4)
        runs.append(h)
    np.testing.assert_array_equal(runs[0].rewards, runs[1].rewards)
    assert np.isfinite(runs[0].rewards).all() and (runs[0].latencies > 0).all()
    with pytest.raises(ValueError, match="T must be"):
        run_online_fleet(7, env, agent, states, 0)


def test_history_helpers_equal_the_reference():
    rng = np.random.default_rng(0)
    traces = dict(rewards=-rng.uniform(2, 3, (3, 40)),
                  latencies=rng.uniform(2, 3, (3, 40)),
                  moved=rng.integers(0, 5, (3, 40)),
                  final_assignment=rng.uniform(size=(3, 4, 2)))
    th, jh = History(**traces), JaxHistory(**traces)
    for a, b in zip(th.seed_band(), jh.seed_band()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(th.normalized_rewards(), jh.normalized_rewards())
    short = {k: v[:, :10] if v.ndim == 2 else v for k, v in traces.items()}
    np.testing.assert_array_equal(History(**short).smoothed_rewards(),
                                  JaxHistory(**short).smoothed_rewards())
    assert th.fleet == 3 and th.lane(1).fleet is None
    np.testing.assert_array_equal(th.lane(1).moved, jh.lane(1).moved)


def test_launcher_prints_the_final_latency_line(capsys):
    res = drl_control.main(["--device", "cpu", "--app", "cq_small",
                            "--fleet", "2", "--offline", "50",
                            "--offline-updates", "5", "--epochs", "5"])
    out = capsys.readouterr().out
    assert "final latency" in out and "round-robin" in out
    assert "improvement" in out and "best assignment" in out
    assert res["history"].rewards.shape == (2, 5)
    assert np.isfinite(res["finals"]).all()
    assert set(res["seconds"]) == {"init", "offline", "online", "score"}


def test_entry_points_raise_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = apps.continuous_queries("small")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drl_control.run(offline=0, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drl_control.main(["--offline", "0", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchedulingEnv(topo, apps.default_workload(topo))
    env = SchedulingEnv(topo, apps.default_workload(topo), device="cpu")
    assert env.device.type == "cpu"
    agent = make_agent("ddpg", env, k_nn=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        agent.init_fleet(torch.Generator().manual_seed(0), 1)
    assert agent.init_fleet(torch.Generator().manual_seed(0), 1,
                            "cpu").epoch.device.type == "cpu"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_reference():
    pkg = REPO / "src" / "repro_torch"
    files = sorted(pkg.rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    # the LM serving slice, the baselines, the paper figures, the
    # multi-process fleet, the LM sharding and the dry-run are among the
    # files checked
    names = {p.relative_to(pkg).as_posix() for p in files[:-1]}
    assert {"models/config.py", "models/nn.py", "models/attention.py",
            "models/ffn.py", "models/ssm.py", "models/lm.py",
            "models/convert.py", "configs/__init__.py", "configs/llama3_8b.py",
            "configs/rwkv6_7b.py", "serve/engine.py", "kernels/_build.py",
            "kernels/flash_attention/ops.py", "kernels/flash_attention/ref.py",
            "kernels/rwkv6_scan/ops.py", "kernels/rwkv6_scan/ref.py",
            "core/dqn.py", "core/round_robin.py", "core/model_based.py",
            "dsdps/scenarios.py", "figures/common.py", "figures/reward.py",
            "figures/fig6.py", "figures/fig8_10.py", "figures/fig12.py",
            "figures/storm_control.py", "launch/mesh.py", "sharding/fleet.py",
            "fault/elastic.py", "launch/multihost.py",
            "examples/elastic_restart.py", "sharding/policy.py",
            "sharding/ctx.py", "launch/specs.py", "launch/dryrun.py"} <= names
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "ml_dtypes", "repro",
                               "benchmarks", "examples"), (path, mod)
