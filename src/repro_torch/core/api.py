"""The pluggable ``Agent`` interface, the fused epoch step and the registry.

Port of ``repro/core/api.py``.  An :class:`Agent` bundles module-level
functions over a config:

    init     (gen, cfg, fleet, device, env_params)           -> agent_state
    select   (cfg, state, s_vec, env_state, env_params,
              explore, draws, gen)                           -> (action, aux)
    observe  (cfg, state, s_vec, aux, reward, s_next)        -> agent_state
    update   (cfg, state, replay_idx, gen)                   -> agent_state
    tick     (cfg, state)                                    -> agent_state

Every tensor carries the fleet axis ``[F]``.  ``draws`` is one epoch's
:class:`EpochDraws`, or None to draw from the ``torch.Generator`` ``gen``.
``env_params`` is one scenario shared by every lane or a lane-stacked
scenario fleet (``dsdps.scenarios.build_for``: EnvParams on a DSDPS env,
PlacementParams on the expert-placement env); learning agents ignore it, the
model-based baseline profiles and searches each lane's own cluster with
it.  Every agent declares the env families (:data:`ENV_FAMILIES`) its
actions are valid for: ``ddpg``, ``dqn``, ``round_robin``, ``stream_ac``
and ``stream_q`` both, ``graph_policy`` and ``model_based`` the DSDPS
``"scheduling"`` family alone, and the serving-only decision policies
``rate_control`` and ``auto_tune`` (``core/control_policies.py``) none:
their actions are not placements and never reach ``env.step``, so
:func:`agent_names` and the fleet runner leave them out, and the serving
control plane (``serve/control.py``) runs them."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class EpochDraws(NamedTuple):
    """Every random draw of one decision epoch, for ``F`` lanes."""

    explore_add: torch.Tensor    # [F] bool — the ε coin (DDPG, DQN, Stream
                                 # Q(λ), graph_policy); or [F] uniform
                                 # [0, 1), the coin lane f < its ε
                                 # (draw_epoch's)
    explore_noise: torch.Tensor  # [F, N, M] uniform [0, 1) (DDPG)
    explore_move: torch.Tensor   # [F] int in [0, N·M) — the random move (DQN,
                                 # Stream Q(λ))
    # the env's draws, standard normal: DSDPS envs take the measurement
    # noise [F, 5] (× noise_sigma) and the rate walk [F, S] (× rate
    # jitter); the expert-placement env the step-time noise [F] (×
    # noise_sigma) and the load drift [F, E] (× load_jitter)
    meas_z: torch.Tensor
    rate_z: torch.Tensor
    replay_idx: torch.Tensor     # [F, U, B] int; or float64 uniform [0,
                                 # 1), scaled by lane f's filled replay
                                 # size as replay.sample_indices scales
                                 # its own (draw_epoch's)
    # [F, N, M] standard Gumbel: a categorical draw is argmax(gumbel +
    # logits), as jax.random.categorical computes it (Stream AC(λ)'s
    # per-row sample; graph_policy's random valid move over the flat N·M)
    explore_gumbel: torch.Tensor

    def to(self, device) -> "EpochDraws":
        return EpochDraws(*(x.to(device) for x in self))


class Agent(NamedTuple):
    """Bundle of control-policy functions (signatures above)."""

    name: str
    cfg: Any
    init_fn: Callable[..., Any]
    select_fn: Callable[..., tuple[torch.Tensor, Any]]
    observe_fn: Callable[..., Any]
    update_fn: Callable[..., Any]
    tick_fn: Callable[..., Any]

    def init_fleet(self, gen: torch.Generator | None, fleet: int,
                   device: str | torch.device | None = None, env_params=None):
        """Independently-initialized lanes, stacked on ``[fleet]``, on
        ``device`` (default CUDA; raises without a GPU).  A lane-stacked
        ``env_params`` initializes each lane under its own scenario (the
        model-based baseline fits the lane's cluster)."""
        return self.init_fn(gen, self.cfg, fleet, device, env_params)


def make_epoch_step(env, agent: Agent, env_params=None,
                    updates_per_epoch: int = 1, explore: bool = True):
    """One online decision epoch for every lane: select → env.step →
    observe → update×U → tick.  ``env_params`` may be lane-stacked; every
    agent takes the epoch's draws, whichever of them it uses.

    Returns ``epoch_step(state, env_state, gen=None, draws=None) ->
    (state, env_state, (reward [F], latency_ms [F], moved [F]))``."""
    if agent.name in _FAMILIES and not _FAMILIES[agent.name]:
        raise ValueError(f"{agent.name} is a serving-only decision policy: its "
                         f"actions are not placements and never step an env "
                         f"(serve it through repro_torch.serve.control)")
    params = env.default_params() if env_params is None else env_params

    def epoch_step(state, env_state, gen: torch.Generator | None = None,
                   draws: EpochDraws | None = None):
        s_vec = env.state_vector(env_state, params)
        action, aux = agent.select_fn(agent.cfg, state, s_vec, env_state,
                                      params, explore, draws, gen)
        out = env.step(env_state, action, params,
                       meas_z=None if draws is None else draws.meas_z,
                       rate_z=None if draws is None else draws.rate_z,
                       gen=gen)
        s_next = env.state_vector(out.state, params)
        state = agent.observe_fn(agent.cfg, state, s_vec, aux, out.reward,
                                 s_next)
        for u in range(updates_per_epoch):
            idx = None if draws is None else draws.replay_idx[:, u]
            state = agent.update_fn(agent.cfg, state, idx, gen)
        state = agent.tick_fn(agent.cfg, state)
        return state, out.state, (out.reward, out.latency_ms, out.moved)

    return epoch_step


def draw_epoch(gen: torch.Generator, env, agent: Agent, fleet: int,
               updates_per_epoch: int = 1) -> EpochDraws:
    """Every draw of one epoch for ``fleet`` lanes of ``agent`` on ``env``,
    from ``gen`` on its device, in a fixed order (the coin, the noise, the
    move, the measurement, the rate walk, the replay rows, the Gumbel
    draw), whichever of them the agent uses.

    The two draws whose law depends on a lane's state come as uniforms in
    [0, 1) that each agent resolves against its own lane, as it resolves its
    generator's draws: the ε coin (``explore_add < ε`` of the lane's epoch)
    and the replay rows (``replay_idx``, float64, scaled by the lane's
    filled size).  So lane f's numbers are the same whichever rows of the
    fleet a caller runs together: a meshed run (``run_online_fleet(...,
    mesh=)``) draws each epoch this way fleet-wide, from a generator every
    process seeds alike, and each block takes its own rows."""
    from repro_torch.core.streaming import gumbel
    from repro_torch.dsdps.env import N_MEASUREMENTS
    dev = gen.device
    N, M = env.N, env.M
    meas = (fleet,) if env.family == "placement" else (fleet, N_MEASUREMENTS)
    batch = getattr(agent.cfg, "batch", 1)
    return EpochDraws(
        explore_add=torch.rand(fleet, generator=gen, device=dev),
        explore_noise=torch.rand(fleet, N, M, generator=gen, device=dev),
        explore_move=torch.randint(0, N * M, (fleet,), generator=gen, device=dev),
        meas_z=torch.randn(meas, generator=gen, device=dev),
        # the rate walk's width: spouts on a DSDPS env (the envelope's on a
        # structural one), experts on the placement env
        rate_z=torch.randn(fleet, env.state_dim - N * M, generator=gen, device=dev),
        replay_idx=torch.rand(fleet, updates_per_epoch, batch, generator=gen,
                              device=dev, dtype=torch.float64),
        explore_gumbel=gumbel((fleet, N, M), gen, dev))


def params_are_stacked(env, env_params) -> bool:
    """True when ``env_params`` carries a leading lane axis (a field with one
    more dimension than in the env's single-scenario defaults)."""
    from repro_torch.dsdps.simulator import params_stacked
    return params_stacked(env_params, env.default_params())


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[..., Agent]] = {}
_FAMILIES: dict[str, tuple[str, ...]] = {}

# the two env families sharing the functional surface (reset / step /
# state_vector / default_params and N / M / state_dim): the DSDPS
# SchedulingEnv, plain or structural, and the expert-placement env.  Each
# env class names its own in a ``family`` class attribute.
ENV_FAMILIES = ("scheduling", "placement")


def register_agent(name: str, factory: Callable[..., Agent],
                   families: tuple[str, ...] = ENV_FAMILIES) -> None:
    """Register ``factory(env, **overrides) -> Agent`` under ``name``.

    ``families`` declares the env families (a subset of
    :data:`ENV_FAMILIES`) the agent's actions are valid for; it is empty for
    a serving-only policy whose actions never reach ``env.step``:
    :func:`make_agent` builds it, but :func:`agent_names` and the fleet
    runner do not offer it."""
    unknown = set(families) - set(ENV_FAMILIES)
    if unknown:
        raise ValueError(f"unknown env families {sorted(unknown)}; "
                         f"known: {ENV_FAMILIES}")
    _REGISTRY[name] = factory
    _FAMILIES[name] = tuple(families)


def _load_builtins() -> None:
    # built-in agents register themselves on import
    import repro_torch.core.control_policies  # noqa: F401
    import repro_torch.core.ddpg         # noqa: F401
    import repro_torch.core.dqn          # noqa: F401
    import repro_torch.core.graph_policy  # noqa: F401
    import repro_torch.core.model_based  # noqa: F401
    import repro_torch.core.round_robin  # noqa: F401
    import repro_torch.core.stream_ac    # noqa: F401
    import repro_torch.core.stream_q     # noqa: F401


def agent_names() -> tuple[str, ...]:
    """Registered agents that step an env (the launcher's ``--agent``
    choices): every name with at least one env family."""
    _load_builtins()
    return tuple(sorted(n for n in _REGISTRY if _FAMILIES[n]))


def agent_families(name: str) -> tuple[str, ...]:
    """Env families ``name`` declared at registration (see
    :func:`register_agent`); empty tuple = serving-only."""
    _load_builtins()
    try:
        return _FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown agent {name!r}; "
                       f"known: {sorted(_REGISTRY)}") from None


def make_agent(name: str, env, **overrides) -> Agent:
    """Construct a registered agent sized for ``env``; ``overrides`` go to
    the agent's config (or pass a ready config as ``cfg=``)."""
    _load_builtins()
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown agent {name!r}; "
                       f"known: {sorted(_REGISTRY)}") from None
    return factory(env, **overrides)
