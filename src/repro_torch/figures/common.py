"""Shared harness for the paper's evaluation: run all four schedulers on a
topology and report stabilized average tuple processing time (the
quantity plotted in Figs 6/8/10).

Port of ``benchmarks/paper_common.py``.  DRL methods (DQN, actor-critic)
run as a seed FLEET — ``budget.n_seeds`` independent online-learning runs
stepped together (``core/agent.run_online_fleet``) — and report mean ± std
across seeds.  Every run draws from its own ``torch.Generator`` on the
env's device, seeded at the reference's key offsets (``seed`` for the
initial states and the model-based fit, ``seed + 1`` for DQN's online
run and DDPG's offline pretraining, ``seed + 2`` for DDPG's online run,
``seed + 7`` for Fig 12's shifted run); the reference's ``seed + 5`` and
``seed + 6`` keys feed a reset and greedy selects that draw nothing.
The draws may be passed in instead (``states=``, ``draws=``,
``offline_draws=``, ``assignments=``/``meas_z=``), so that the tests can
replay the reference's.  The deploy loops step all lanes at once, lane f
under its own ``lane_params``, as the reference's per-lane loops do.

``SECONDS`` records the wall seconds of each part of the last run of each
function here (the device synchronized at each part's end)."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import EpochDraws, OfflineDraws, make_agent, run_online_fleet
from repro_torch.core import ddpg as ddpg_lib
from repro_torch.core import dqn as dqn_lib
from repro_torch.core.exploration import EpsilonSchedule
from repro_torch.core.model_based import ModelBasedScheduler
from repro_torch.dsdps import SchedulingEnv, apps, lane_params
from repro_torch.dsdps.apps import default_workload

SECONDS: dict[str, float] = {}


@contextlib.contextmanager
def timed(part: str, device: torch.device):
    """Record the wall seconds of the block in ``SECONDS[part]``, the
    device's queue drained at its end."""
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    SECONDS[part] = time.perf_counter() - t0


def _lane_params(env, env_params, lane: int):
    """The EnvParams lane ``lane`` deploys under: lane ``lane`` of a stacked
    scenario fleet (broadcast-invariant stacks included), the shared params
    otherwise (default when None)."""
    p = env.default_params() if env_params is None else env_params
    return lane_params(p, env.default_params(), lane)


def seeded(env, seed: int) -> torch.Generator:
    """A generator on the env's device seeded with ``seed``."""
    return torch.Generator(device=env.device).manual_seed(seed)


@dataclasses.dataclass
class Budget:
    """Training budgets.  `paper()` matches the paper's setup (10k offline
    samples, T=1500–2000 online epochs); `quick()` is benchmark scale."""
    offline_samples: int
    offline_updates: int
    online_epochs: int
    updates_per_epoch: int
    mb_samples: int
    k_nn: int = 12
    n_seeds: int = 4          # fleet width of the DRL seed sweep

    @classmethod
    def quick(cls) -> "Budget":
        return cls(offline_samples=1500, offline_updates=400,
                   online_epochs=250, updates_per_epoch=2, mb_samples=300)

    @classmethod
    def paper(cls) -> "Budget":
        return cls(offline_samples=10_000, offline_updates=3000,
                   online_epochs=2000, updates_per_epoch=1, mb_samples=400,
                   k_nn=16, n_seeds=8)

    @classmethod
    def validated(cls) -> "Budget":
        """The reference's best stable operating point: long online runs at
        paper scale drift (DDPG instability); 600 epochs × 2 updates with
        4k offline samples is the sweet spot on this simulator."""
        return cls(offline_samples=4000, offline_updates=1500,
                   online_epochs=600, updates_per_epoch=2, mb_samples=400,
                   k_nn=16, n_seeds=8)


def make_env(app: str, device: str | torch.device | None = None) -> SchedulingEnv:
    """The app's env on ``device`` (CUDA unless asked otherwise; raises
    without a GPU)."""
    topo = apps.ALL_APPS[app]()
    return SchedulingEnv(topo, default_workload(topo), device=device)


def run_default(env: SchedulingEnv) -> float:
    """Storm's EvenScheduler assignment, noise-free."""
    with timed("default", env.device):
        X, same_proc, n_procs = env.storm_default_assignment()
        w = env.default_params().base_rates
        return float(env.evaluate(X, w, same_proc=same_proc, n_procs=n_procs))


def run_model_based(env: SchedulingEnv, budget: Budget, seed: int = 0,
                    assignments: torch.Tensor | None = None,
                    meas_z: torch.Tensor | None = None):
    """[25]'s fit on ``budget.mb_samples`` random schedules (the draws
    ``assignments [n, N]`` and ``meas_z [n, 5]``, from a generator seeded
    with ``seed`` when not passed), then its greedy search from
    round-robin.  Returns (latency ms, assignment [N, M])."""
    with timed("model_based", env.device):
        sched = ModelBasedScheduler(env).fit(seeded(env, seed),
                                             n_samples=budget.mb_samples,
                                             assignments=assignments,
                                             meas_z=meas_z)
        w = env.default_params().base_rates
        X = sched.schedule(w, sweeps=3)
        return float(env.evaluate(X, w)), X


def _eps(budget: Budget) -> EpsilonSchedule:
    return EpsilonSchedule(decay_epochs=max(budget.online_epochs * 2 // 3, 1))


def run_dqn(env: SchedulingEnv, budget: Budget, seed: int = 0,
            deploy: bool = True, env_params=None, states=None,
            draws: Sequence[EpochDraws] | None = None):
    """Fleet of budget.n_seeds independent DQN runs, from ``states`` (fresh
    lanes when None) and the online ``draws``.

    Returns (per-seed deployed latencies, stacked History); ``deploy=False``
    skips the greedy rollouts (callers that only need the reward
    histories, e.g. the reward figure) and returns an empty latency list."""
    agent = make_agent("dqn", env, eps=_eps(budget))
    cfg = agent.cfg
    F = budget.n_seeds
    with timed("dqn_fleet", env.device):
        if states is None:
            states = agent.init_fleet(seeded(env, seed), F, env.device)
        states, hist = run_online_fleet(
            seed + 1, env, agent, states, T=budget.online_epochs,
            updates_per_epoch=budget.updates_per_epoch, env_params=env_params,
            draws=draws)
    if not deploy:
        return [], hist
    # each trained agent's deployed solution: a greedy move rollout of 2·N
    # steps, scored under the scenario params that lane trained on
    with timed("dqn_deploy", env.device):
        params = env.default_params() if env_params is None else env_params
        s = env.reset(F, params)
        for _ in range(2 * env.N):
            move = dqn_lib.select_move(states, cfg, env.state_vector(s, params),
                                       explore=False)
            s = s._replace(X=dqn_lib.apply_move(s.X, move, env.M))
        lats = []
        for f in range(F):
            p_f = _lane_params(env, env_params, f)
            lats.append(float(env.evaluate(s.X[f], p_f.base_rates, params=p_f)))
    return lats, hist


def run_actor_critic(env: SchedulingEnv, budget: Budget, seed: int = 0,
                     deploy: bool = True, env_params=None, states=None,
                     draws: Sequence[EpochDraws] | None = None,
                     offline_draws: OfflineDraws | None = None):
    """Fleet of budget.n_seeds independent actor-critic runs: offline
    pretraining on ``offline_draws``, then online learning on ``draws``,
    from ``states`` (fresh lanes when None).

    Returns (per-seed deployed latencies, stacked History, (states, cfg));
    ``deploy=False`` skips the wide-K-NN deployment search."""
    agent = make_agent("ddpg", env, k_nn=budget.k_nn, eps=_eps(budget))
    cfg = agent.cfg
    F = budget.n_seeds
    with timed("ac_offline", env.device):
        if states is None:
            states = agent.init_fleet(seeded(env, seed), F, env.device)
        states = ddpg_lib.offline_pretrain(
            states, cfg, env, n_samples=budget.offline_samples,
            n_updates=budget.offline_updates, env_params=env_params,
            draws=offline_draws, gen=seeded(env, seed + 1))
    with timed("ac_online", env.device):
        states, hist = run_online_fleet(
            seed + 2, env, agent, states, T=budget.online_epochs,
            updates_per_epoch=budget.updates_per_epoch, env_params=env_params,
            draws=draws)
    if not deploy:
        return [], hist, (states, cfg)
    # each trained agent's deployed solution (paper: "scheduling solutions
    # given by well-trained DRL agents"): greedy action with a wide exact
    # K-NN (K=256 from the host enumeration), iterated a few epochs as the
    # system re-stabilizes, each lane under its scenario, its best kept
    with timed("ac_deploy", env.device):
        params = env.default_params() if env_params is None else env_params
        s = env.reset(F, params)
        best = [None] * F
        for _ in range(4):
            a = ddpg_lib.select_action(states, cfg, env.state_vector(s, params),
                                       explore=False, exact_host_knn=True,
                                       k_override=256)
            for f in range(F):
                p_f = _lane_params(env, env_params, f)
                lat = float(env.evaluate(a[f], p_f.base_rates, params=p_f))
                if best[f] is None or lat < best[f]:
                    best[f] = lat
            s = s._replace(X=a)
    return best, hist, (states, cfg)


def compare_all(app: str, budget: Budget, seed: int = 0, verbose=True,
                device: str | torch.device | None = None) -> dict:
    """The four schedulers on ``app``: latencies, the DRL methods' seed
    spreads and reward bands, and the actor-critic's improvements."""
    env = make_env(app, device)
    t0 = time.time()
    out: dict = {"app": app, "n_seeds": budget.n_seeds}
    out["default"] = run_default(env)
    out["model_based"], _ = run_model_based(env, budget, seed)
    dqn_lats, dqn_hist = run_dqn(env, budget, seed)
    ac_lats, ac_hist, _ = run_actor_critic(env, budget, seed)
    out["dqn"] = float(np.mean(dqn_lats))
    out["dqn_std"] = float(np.std(dqn_lats))
    out["dqn_seeds"] = dqn_lats
    out["actor_critic"] = float(np.mean(ac_lats))
    out["actor_critic_std"] = float(np.std(ac_lats))
    out["actor_critic_seeds"] = ac_lats
    # seed-averaged online reward curves with variance bands (Figs 7/9/11)
    for name, hist in (("dqn", dqn_hist), ("ac", ac_hist)):
        mean, std = hist.seed_band()
        out[f"{name}_curve_mean"] = np.round(mean, 5).tolist()
        out[f"{name}_curve_std"] = np.round(std, 5).tolist()
    out["imp_vs_default"] = 1 - out["actor_critic"] / out["default"]
    out["imp_vs_model_based"] = 1 - out["actor_critic"] / out["model_based"]
    out["seconds"] = round(time.time() - t0, 1)
    out["_dqn_hist"] = dqn_hist
    out["_ac_hist"] = ac_hist
    if verbose:
        print(f"[{app}] default={out['default']:.2f}ms "
              f"model={out['model_based']:.2f}ms "
              f"dqn={out['dqn']:.2f}±{out['dqn_std']:.2f}ms "
              f"actor-critic={out['actor_critic']:.2f}"
              f"±{out['actor_critic_std']:.2f}ms "
              f"over {budget.n_seeds} seeds "
              f"(+{out['imp_vs_default']:.1%} vs default, "
              f"+{out['imp_vs_model_based']:.1%} vs model-based) "
              f"[{out['seconds']}s]", flush=True)
    return out
