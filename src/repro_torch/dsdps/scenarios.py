"""Named scenario fleets — lane-stacked EnvParams for heterogeneous lanes.

Port of the scheduling half of ``repro/dsdps/scenarios.py``.  Each builder
returns one EnvParams per lane; :func:`build` stacks them on a leading
``[fleet]`` axis, and ``core.agent.run_online_fleet(...,
env_params=...)`` steps every lane under its own scenario.  The numeric
builders work on ``structural.GraphEnvParams`` alike; ``dag_shapes``
(:data:`STRUCTURAL_SCENARIOS`) varies the topology itself per lane and
needs a ``StructuralSchedulingEnv``:

    from repro_torch.dsdps import scenarios
    params = scenarios.build("one_slow_machine", env, fleet=8)
    states, hist = run_online_fleet(gen, env, agent, states, T=300,
                                    env_params=params)

``broadcast_invariant=True`` keeps fields no lane perturbs (routing,
flow_solve, tuple_bytes, ...) as a single unstacked copy, which the
simulator broadcasts over the lanes with the same result as the full
stack.

``mixed`` takes its per-lane service-time and rate draws passed in, or
from a ``torch.Generator`` seeded with ``seed``: torch cannot replay the
reference's threefry draws (``fold_in(PRNGKey(seed), lane)``).  So does
:func:`sample_perturbed`, the one-scenario sampler the serving launcher
registers its clusters with.

:func:`build_for`, :func:`sample_perturbed` and :func:`scenario_names`
take either env family: a DSDPS env (it has a ``topo``) gets the
EnvParams fleets here, the expert-placement env the PlacementParams
fleets of ``repro_torch.core.placement``."""
from __future__ import annotations

import math

import torch

from repro_torch.dsdps.simulator import (EnvParams, perturb_rates,
                                         perturb_service, scale_rates,
                                         stack_env_params, with_noise_sigma,
                                         with_straggler)


def _diurnal(lane: int, fleet: int, amplitude: float, like: torch.Tensor):
    """1 + amplitude·sin(2π lane/fleet) in float32, as the reference forms it."""
    phase = torch.tensor(2.0 * math.pi * lane / max(fleet, 1),
                         dtype=torch.float32, device=like.device)
    return 1.0 + amplitude * torch.sin(phase)


def uniform(env, fleet: int) -> list[EnvParams]:
    """Every lane runs the env's declared parameters (pure seed sweep)."""
    p = env.default_params()
    return [p] * fleet


def one_slow_machine(env, fleet: int, factor: float = 0.35) -> list[EnvParams]:
    """Lane i slows machine ``i % M`` to ``factor`` of nominal speed — the
    straggler-mitigation stress, one straggler location per lane."""
    p = env.default_params()
    return [with_straggler(p, i % env.M, factor) for i in range(fleet)]


def diurnal_rate(env, fleet: int, amplitude: float = 0.4) -> list[EnvParams]:
    """Lane i's base rates scaled to a point on a daily load curve:
    1 + amplitude·sin(2π i/fleet)."""
    p = env.default_params()
    return [scale_rates(p, _diurnal(i, fleet, amplitude, p.base_rates))
            for i in range(fleet)]


def high_noise(env, fleet: int, sigma: float = 0.12) -> list[EnvParams]:
    """Every lane measures rewards through ``sigma`` lognormal noise —
    4× the paper's telemetry noise; stresses learning robustness."""
    p = env.default_params()
    return [with_noise_sigma(p, sigma)] * fleet


def mixed(env, fleet: int, seed: int = 0,
          service_z: torch.Tensor | None = None,
          rate_z: torch.Tensor | None = None) -> list[EnvParams]:
    """Round-robin over the named regimes plus per-lane service-time and
    rate jitter (σ 0.10 each).  ``service_z [fleet, N]`` and ``rate_z
    [fleet, S]`` are the standard-normal draws; those not passed in come
    from a generator on the env's device seeded with ``seed``."""
    p = env.default_params()
    gen = torch.Generator(device=env.device).manual_seed(seed)
    if service_z is None:
        service_z = torch.randn(fleet, env.N, generator=gen, device=env.device)
    if rate_z is None:
        rate_z = torch.randn(fleet, env.workload.num_spouts, generator=gen,
                             device=env.device)
    lanes = []
    for i in range(fleet):
        lane = perturb_rates(perturb_service(p, service_z[i], 0.10),
                             rate_z[i], 0.10)
        kind = i % 4
        if kind == 1:
            lane = with_straggler(lane, i % env.M, 0.4)
        elif kind == 2:
            lane = scale_rates(lane, _diurnal(i, fleet, 0.4, lane.base_rates))
        elif kind == 3:
            lane = with_noise_sigma(lane, 0.12)
        lanes.append(lane)
    return lanes


def dag_shapes(env, fleet: int) -> list:
    """Structural fleet: lane i runs topology ``i % len(env.topologies)``
    padded into the env's envelope (chain, diamond, wide fan-out, ...).
    Needs a ``StructuralSchedulingEnv``: a plain ``SchedulingEnv`` fixes one
    topology for all its lanes."""
    if not env.structural:
        raise TypeError(
            "scenario 'dag_shapes' varies topology structure per lane and "
            "needs a StructuralSchedulingEnv (repro_torch.dsdps.structural); "
            f"{type(env).__name__} fixes one topology per fleet")
    topos = env.topologies
    return [env.params_for(topos[i % len(topos)]) for i in range(fleet)]


SCENARIOS = {
    "uniform": uniform,
    "one_slow_machine": one_slow_machine,
    "diurnal_rate": diurnal_rate,
    "high_noise": high_noise,
    "mixed": mixed,
}

# structure-varying scenarios: valid only on envelope-padded structural envs
STRUCTURAL_SCENARIOS = {
    "dag_shapes": dag_shapes,
}


def build(name: str, env, fleet: int, broadcast_invariant: bool = False,
          **kwargs) -> EnvParams:
    """Stacked EnvParams (GraphEnvParams on a structural env) for a named
    scenario fleet; ``kwargs`` go to the builder (``factor=``,
    ``amplitude=``, ``sigma=``, ``seed=``, ...)."""
    builder = {**SCENARIOS, **STRUCTURAL_SCENARIOS}.get(name)
    if builder is None:
        raise KeyError(f"unknown scenario {name!r}; known: "
                       f"{sorted(SCENARIOS) + sorted(STRUCTURAL_SCENARIOS)}")
    return stack_env_params(builder(env, fleet, **kwargs),
                            broadcast_invariant=broadcast_invariant)


def build_for(env, name: str, fleet: int, broadcast_invariant: bool = False,
              **kwargs):
    """Scenario fleet for either env family: :func:`build` for a DSDPS env,
    plain or structural (a topology that does not fit a structural env's
    envelope raises ``ValueError`` from ``params_for``), and
    ``placement.build_scenario`` for the expert-placement env."""
    if env.family == "scheduling":
        return build(name, env, fleet, broadcast_invariant=broadcast_invariant,
                     **kwargs)
    from repro_torch.core import placement
    return placement.build_scenario(name, env, fleet,
                                    broadcast_invariant=broadcast_invariant,
                                    **kwargs)


def workload_shift(env, factor: float = 1.5) -> EnvParams:
    """The Fig-12 step change as a single-scenario EnvParams edit: every
    spout's base rate scaled by ``factor`` against the same env spec."""
    return scale_rates(env.default_params(), factor)


def sample_perturbed(env, base=None,
                     service_sigma: float = 0.12, rate_sigma: float = 0.12,
                     straggler_prob: float = 0.25,
                     straggler_factor: float = 0.4,
                     service_z: torch.Tensor | None = None,
                     rate_z: torch.Tensor | None = None,
                     straggler: bool | None = None,
                     machine: int | None = None,
                     gen: torch.Generator | None = None,
                     skew_z: torch.Tensor | None = None,
                     load_z: torch.Tensor | None = None,
                     device: int | None = None):
    """ONE perturbed scenario around ``base`` (default: the env's declared
    parameters), plus, with probability ``straggler_prob``, one machine (or
    device) slowed to ``straggler_factor``.

    On a DSDPS env: lognormal jitter on the true service costs and arrival
    rates; the draws are ``service_z [N]`` and ``rate_z [S]`` (standard
    normal), the straggler coin ``straggler`` and its ``machine`` in ``[0,
    M)``.  On the expert-placement env: lognormal jitter on each expert's
    popularity (σ ``service_sigma``) and on the total load (σ
    ``rate_sigma``); the draws are ``skew_z [E]`` and ``load_z`` (a
    scalar), the coin ``straggler`` and its ``device`` in ``[0, D)``.
    Draws not passed in come from ``gen`` in that order, on the generator's
    device (the reference draws them from four keys split off one).  So a
    CPU generator gives the same scenario on any device."""
    p = env.default_params() if base is None else base
    if env.family != "scheduling":
        return _sample_placement(env, p, service_sigma, rate_sigma,
                                 straggler_prob, straggler_factor, skew_z,
                                 load_z, straggler, device, gen)
    dev = p.base_rates.device if gen is None else gen.device
    if service_z is None:
        service_z = torch.randn(env.N, generator=gen, device=dev)
    if rate_z is None:
        rate_z = torch.randn(env.workload.num_spouts, generator=gen, device=dev)
    if straggler is None:
        straggler = bool(torch.rand((), generator=gen, device=dev)
                         < straggler_prob)
    lane = perturb_rates(perturb_service(p, service_z, service_sigma),
                         rate_z, rate_sigma)
    if straggler:
        if machine is None:
            machine = int(torch.randint(0, env.M, (), generator=gen,
                                        device=dev))
        lane = with_straggler(lane, machine, straggler_factor)
    return lane


def _sample_placement(env, p, skew_sigma, load_sigma, straggler_prob,
                      straggler_factor, skew_z, load_z, straggler, device, gen):
    """The placement half of :func:`sample_perturbed`."""
    from repro_torch.core import placement

    dev = p.base_load.device if gen is None else gen.device
    if skew_z is None:
        skew_z = torch.randn(env.N, generator=gen, device=dev)
    if load_z is None:
        load_z = torch.randn((), generator=gen, device=dev)
    if straggler is None:
        straggler = bool(torch.rand((), generator=gen, device=dev)
                         < straggler_prob)
    lane = placement.perturb_skew(p, skew_z.to(p.base_load.device), skew_sigma)
    load = torch.exp(load_z.to(p.base_load.device) * load_sigma
                     - 0.5 * load_sigma ** 2)
    lane = placement.scale_load(lane, load)
    if straggler:
        if device is None:
            device = int(torch.randint(0, env.M, (), generator=gen, device=dev))
        lane = placement.with_device_straggler(lane, device, straggler_factor)
    return lane


def perturb_sampler(env, base=None, **kwargs):
    """Curry :func:`sample_perturbed` into a ``sample(gen=None, **draws) ->
    params`` callable (``draws``: ``service_z``, ``rate_z``, ``straggler``,
    ``machine`` on a DSDPS env; ``skew_z``, ``load_z``, ``straggler``,
    ``device`` on the placement env)."""
    def sample(gen: torch.Generator | None = None, **draws):
        return sample_perturbed(env, base=base, gen=gen, **kwargs, **draws)
    return sample


def scenario_names(env) -> tuple[str, ...]:
    """Names valid for ``build_for(env, name, ...)``: the structural ones
    only for an env with a padding envelope, the placement ones only (and
    exactly those) for the expert-placement env."""
    if env.family != "scheduling":
        from repro_torch.core import placement
        return tuple(sorted(placement.PLACEMENT_SCENARIOS))
    names = list(SCENARIOS)
    if env.structural:
        names += list(STRUCTURAL_SCENARIOS)
    return tuple(sorted(names))
