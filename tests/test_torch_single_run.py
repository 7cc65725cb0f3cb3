"""The port's single-run entry and the registry's env families against the
reference: ``run_online_agent`` for every agent on each env family it
declares (cq_small and Jamba's expert placement), from the reference's
initial states carried across, with the reference's draws replayed; a lane
of a one-lane fleet against the single run; ``agent_families``,
``register_agent``'s refusal and ``params_are_stacked``; the simulator's
``measured_latency_ms`` and the ``constant`` workload."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, env_pair,
                               jax_epoch_draws, jax_tree_numpy, to_torch,
                               torch)

from repro.core import api as japi
from repro.core import ddpg as jddpg
from repro.core import dqn as jdqn
from repro.core import exploration as jexpl
from repro.core import graph_policy as jgp
from repro.core import make_agent as jax_make_agent
from repro.core import placement as jpl
from repro.core import stream_ac as jac
from repro.core import stream_q as jsq
from repro.core.agent import run_online_agent as jax_run_online_agent
from repro.dsdps import scenarios as jscen
from repro.dsdps import simulator as jsim
from repro.dsdps import workload as jwl
from repro_torch.core import (ENV_FAMILIES, agent_families, agent_names,
                              jamba_placement_env, make_agent,
                              params_are_stacked, register_agent,
                              run_online_agent, run_online_fleet)
from repro_torch.core import api as tapi
from repro_torch.core import convert
from repro_torch.core import ddpg as tddpg
from repro_torch.core import dqn as tdqn
from repro_torch.core import exploration as texpl
from repro_torch.core import graph_policy as tgp
from repro_torch.core import placement as tpl
from repro_torch.core import stream_ac as tac
from repro_torch.core import stream_q as tsq
from repro_torch.dsdps import (constant, lane_params, measured_latency_ms,
                               scenarios)
from repro_torch.dsdps import workload as twl

# rewards and latencies: the discrete choices are exact, the simulator's and
# the nets' float32 sums run in another order than XLA's (the rule of the
# fleet loop tests)
RTOL = 1e-5
T = 5
# a short exploration schedule, so five epochs see greedy and random moves
DECAY = 4
SCHEDULING = ("ddpg", "dqn", "graph_policy", "model_based", "round_robin",
              "stream_ac", "stream_q")
PLACEMENT = ("ddpg", "dqn", "round_robin", "stream_ac", "stream_q")


@pytest.fixture(scope="module")
def envs():
    """(reference env, port env on the CPU) of each family: cq_small and
    Jamba-1.5-large's 16 experts on 16 devices."""
    return {"scheduling": env_pair("cq_small"),
            "placement": (jpl.jamba_placement_env(),
                          jamba_placement_env(device="cpu"))}


def agent_pair(name, jenv, tenv):
    """(reference agent, port agent, port state from the reference's numpy
    fleet state) of ``name``, at small sizes and short schedules."""
    kw = dict(n_executors=jenv.N, n_machines=jenv.M, state_dim=jenv.state_dim)
    if name == "ddpg":
        jc, tc = (m.DDPGConfig(**kw, k_nn=8, batch=8) for m in (jddpg, tddpg))
        from_numpy = convert.ddpg_state_from_numpy
    elif name == "dqn":
        jc = jdqn.DQNConfig(**kw, batch=8, eps=jexpl.EpsilonSchedule(decay_epochs=DECAY))
        tc = tdqn.DQNConfig(**kw, batch=8, eps=texpl.EpsilonSchedule(decay_epochs=DECAY))
        from_numpy = convert.dqn_state_from_numpy
    elif name == "stream_q":
        jc = jsq.StreamQConfig(**kw, eps=jexpl.EpsilonSchedule(decay_epochs=DECAY))
        tc = tsq.StreamQConfig(**kw, eps=texpl.EpsilonSchedule(decay_epochs=DECAY))
        from_numpy = convert.stream_q_state_from_numpy
    elif name == "stream_ac":
        jc, tc = (m.StreamACConfig(**kw, temp_decay_epochs=DECAY) for m in (jac, tac))
        from_numpy = convert.stream_ac_state_from_numpy
    elif name == "graph_policy":
        base = jax_make_agent("graph_policy", jenv).cfg
        fields = {f: getattr(base, f) for f in base.__dataclass_fields__ if f != "eps"}
        jc = jgp.GraphPolicyConfig(**fields, eps=jexpl.EpsilonSchedule(decay_epochs=DECAY))
        tc = tgp.GraphPolicyConfig(**fields, eps=texpl.EpsilonSchedule(decay_epochs=DECAY))
        from_numpy = convert.graph_policy_state_from_numpy
    elif name == "model_based":
        return (jax_make_agent(name, jenv, fit_samples=40),
                make_agent(name, tenv, fit_samples=40),
                lambda x, device: to_torch(x).to(device))
    else:
        return (jax_make_agent(name, jenv), make_agent(name, tenv),
                lambda x, device: to_torch(x).to(device))
    return (jax_make_agent(name, jenv, cfg=jc), make_agent(name, tenv, cfg=tc),
            from_numpy)


def test_the_cases_are_every_agent_on_every_family_it_declares():
    """SCHEDULING here and PLACEMENT in test_torch_single_run_placement.py."""
    want = {(fam, n) for n in agent_names() for fam in agent_families(n)}
    assert {("scheduling", n) for n in SCHEDULING} | {
        ("placement", n) for n in PLACEMENT} == want


def check_run_online_agent(envs, family, name):
    """cq_small or the placement env, T=5, from the reference's initial
    state (its fleet of one, carried across) with its draws replayed:
    ``moved`` and the final assignment exact, rewards and latencies at
    float32 tolerance; the port's History is the single run's."""
    jenv, tenv = envs[family]
    jagent, tagent, from_numpy = agent_pair(name, jenv, tenv)
    js1 = jagent.init_fleet(jax.random.PRNGKey(4), 1)
    ts = from_numpy(jax_tree_numpy(js1), "cpu")
    key = jax.random.PRNGKey(6)
    _, jh = jax_run_online_agent(key, jenv, jagent,
                                 jax.tree.map(lambda x: x[0], js1), T=T)
    cfg = jagent.cfg
    draws = jax_epoch_draws(
        key[None], T=T, U=1, B=getattr(cfg, "batch", 1), N=jenv.N, M=jenv.M,
        S=jenv.workload.num_spouts if family == "scheduling" else jenv.N,
        eps=getattr(cfg, "eps", None), cap=getattr(cfg, "buffer", 1000),
        gumbel="rand" if name == "graph_policy" else "act",
        meas_shape=(5,) if family == "scheduling" else ())
    _, th = run_online_agent(0, tenv, tagent, ts, T, draws=draws)
    assert th.fleet is None
    assert th.rewards.shape == jh.rewards.shape == (T,)
    assert th.final_assignment.shape == (jenv.N, jenv.M)
    assert_exact(th.moved, jh.moved)
    assert_exact(th.final_assignment, jh.final_assignment)
    assert_f32(th.latencies, jh.latencies, rtol=RTOL)
    assert_f32(th.rewards, jh.rewards, rtol=RTOL)
    if name != "round_robin":
        assert th.moved.sum() > 0


@pytest.mark.parametrize("name", SCHEDULING)
def test_run_online_agent_matches_reference(envs, name):
    check_run_online_agent(envs, "scheduling", name)


@pytest.mark.parametrize("name", SCHEDULING)
def test_lane_of_a_one_lane_fleet_equals_the_single_run(envs, name):
    """From the same state and the same seed (every draw from the
    generator), lane 0 of ``run_online_fleet`` at F=1 and
    ``run_online_agent`` give the same traces and state, bit for bit."""
    _, env = envs["scheduling"]
    agent = make_agent(name, env, **{"ddpg": {"k_nn": 4},
                                     "model_based": {"fit_samples": 40}}.get(name, {}))
    init = agent.init_fleet(torch.Generator().manual_seed(3), 1, "cpu")
    s_fleet, fleet = run_online_fleet(9, env, agent, copy.deepcopy(init), 4,
                                      updates_per_epoch=2)
    s_one, one = run_online_agent(9, env, agent, copy.deepcopy(init), 4,
                                  updates_per_epoch=2)
    lane = fleet.lane(0)
    for field in ("rewards", "latencies", "moved", "final_assignment"):
        assert_exact(getattr(one, field), getattr(lane, field))
    for a, b in zip(_tensors(s_fleet), _tensors(s_one)):
        assert torch.equal(a, b)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from (p.detach() for p in tree.parameters())
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def test_run_online_agent_refuses_a_fleet_and_stacked_params(envs):
    """The port refuses a state of two lanes and a lane-stacked scenario
    with a ValueError; the reference fails inside its scan on the latter."""
    jenv, env = envs["scheduling"]
    agent = make_agent("round_robin", env)
    with pytest.raises(ValueError, match="runs one lane"):
        run_online_agent(0, env, agent, torch.zeros(2, dtype=torch.int32), 2)
    stacked = scenarios.build("one_slow_machine", env, 1)
    with pytest.raises(ValueError, match="lane-stacked"):
        run_online_agent(0, env, agent, torch.zeros(1, dtype=torch.int32), 2,
                         env_params=stacked)
    jstacked = jscen.build("one_slow_machine", jenv, 2)
    with pytest.raises(Exception):
        jax_run_online_agent(jax.random.PRNGKey(0), jenv,
                             jax_make_agent("round_robin", jenv),
                             jnp.zeros((), jnp.int32), 2, env_params=jstacked)


def test_run_online_agent_takes_one_scenario(envs):
    """A single perturbed scenario runs, its latencies its own."""
    _, env = envs["scheduling"]
    agent = make_agent("round_robin", env)
    slow = lane_params(scenarios.build("one_slow_machine", env, 2),
                       env.default_params(), 1)
    state = torch.zeros(1, dtype=torch.int32)
    _, plain = run_online_agent(0, env, agent, state.clone(), 3)
    _, one = run_online_agent(0, env, agent, state.clone(), 3, env_params=slow)
    assert one.latencies.shape == (3,) and np.isfinite(one.latencies).all()
    assert not np.allclose(one.latencies, plain.latencies)


# --------------------------------------------------------------------------
# the registry's env families
# --------------------------------------------------------------------------
def test_agent_families_match_reference():
    names = japi.agent_names()              # every name, serving-only ones too
    assert ("rate_control" in names) and ("auto_tune" in names)
    for name in names:
        assert agent_families(name) == japi.agent_families(name), name
    assert ENV_FAMILIES == japi.ENV_FAMILIES
    assert set(agent_names()) == {n for n in names if japi.agent_families(n)}
    for mod in (japi, tapi):
        with pytest.raises(KeyError) as err:
            mod.agent_families("nope")
        assert str(err.value) == str(KeyError(
            f"unknown agent 'nope'; known: {sorted(names)}"))


def test_register_agent_refuses_an_unknown_family():
    for mod in (japi, tapi):
        with pytest.raises(ValueError, match="unknown env families"):
            mod.register_agent("unknown_family_agent", lambda env: None,
                               families=("scheduling", "queueing"))
        with pytest.raises(KeyError, match="unknown agent"):
            mod.agent_families("unknown_family_agent")


def test_a_registered_agent_takes_its_declared_families():
    factory = tapi._REGISTRY["round_robin"]
    try:
        register_agent("placement_only_rr", factory, families=("placement",))
        assert agent_families("placement_only_rr") == ("placement",)
        assert "placement_only_rr" in agent_names()
        register_agent("placement_only_rr", factory, families=())
        assert "placement_only_rr" not in agent_names()
    finally:
        tapi._REGISTRY.pop("placement_only_rr", None)
        tapi._FAMILIES.pop("placement_only_rr", None)


def test_env_family_decides_each_env(envs):
    from repro_torch.dsdps import StructuralSchedulingEnv, apps

    assert envs["scheduling"][1].family == "scheduling"
    assert envs["placement"][1].family == "placement"
    structural = StructuralSchedulingEnv(apps.structural_topologies(), device="cpu")
    assert structural.family == "scheduling" and structural.structural
    assert not envs["scheduling"][1].structural and not envs["placement"][1].structural
    assert {e.family for e in (envs["scheduling"][1], envs["placement"][1])} \
        == set(ENV_FAMILIES)


@pytest.mark.parametrize("family", ENV_FAMILIES)
@pytest.mark.parametrize("broadcast_invariant", [False, True])
def test_params_are_stacked_matches_reference(envs, family, broadcast_invariant):
    jenv, tenv = envs[family]
    assert params_are_stacked(tenv, tenv.default_params()) is False
    assert japi.params_are_stacked(jenv, jenv.default_params()) is False
    name = "mixed"
    if family == "scheduling":
        jp = jscen.build(name, jenv, 3, broadcast_invariant=broadcast_invariant)
        tp = convert.env_params_from_numpy(jax_tree_numpy(jp), "cpu")
    else:
        jp = jpl.build_scenario(name, jenv, 3, broadcast_invariant=broadcast_invariant)
        tp = convert.placement_params_from_numpy(jax_tree_numpy(jp), "cpu")
    assert params_are_stacked(tenv, tp) == japi.params_are_stacked(jenv, jp) is True


# --------------------------------------------------------------------------
# the simulator's measurement and the constant workload
# --------------------------------------------------------------------------
def test_measured_latency_ms_matches_reference_on_its_draws():
    """cq_small, a random assignment and rates; plain, with machine speeds,
    and with Storm's worker processes; two noise levels and counts."""
    jenv, tenv = env_pair("cq_small")
    rng = np.random.default_rng(2)
    _, mask, nproc = jenv.storm_default_assignment()
    X = np.eye(jenv.M, dtype=np.float32)[rng.integers(0, jenv.M, jenv.N)]
    w = (np.asarray(jenv.workload.init())
         * rng.uniform(0.5, 1.5, jenv.workload.num_spouts)).astype(np.float32)
    speed = rng.uniform(0.4, 1.0, jenv.M).astype(np.float32)
    cases = ((dict(), 0.03, 5), (dict(speed=speed), 0.12, 3),
             (dict(same_proc=np.asarray(mask), n_procs=np.asarray(nproc)), 0.03, 5))
    for i, (extra, sigma, n) in enumerate(cases):
        key = jax.random.PRNGKey(i)
        want = jsim.measured_latency_ms(
            key, jnp.asarray(X), jnp.asarray(w), jenv.params, jenv.cluster,
            noise_sigma=sigma, n_measurements=n,
            **{k: jnp.asarray(v) for k, v in extra.items()})
        got = measured_latency_ms(
            to_torch(X), to_torch(w), tenv.params, tenv.cluster,
            noise_sigma=sigma, n_measurements=n,
            z=to_torch(jax.random.normal(key, (n,))),
            **{k: to_torch(v) for k, v in extra.items()})
        assert got.shape == ()
        assert_f32(got, want, rtol=1e-6)


def test_measured_latency_ms_draws_from_a_generator():
    _, env = env_pair("cq_small")
    X = env.round_robin_assignment()
    w = env.default_params().base_rates
    z = torch.randn(5, generator=torch.Generator().manual_seed(1))
    got = measured_latency_ms(X, w, env.params, env.cluster,
                              gen=torch.Generator().manual_seed(1))
    assert torch.equal(got, measured_latency_ms(X, w, env.params, env.cluster, z=z))
    batch = measured_latency_ms(X.expand(3, -1, -1), w, env.params, env.cluster,
                                z=z.expand(3, -1))
    assert batch.shape == (3,) and torch.equal(batch, got.expand(3))


@pytest.mark.parametrize("rates", [(100.0,), (1000.0, 250.5, 3.0)])
def test_constant_workload_matches_reference(rates):
    got, want = constant(rates), jwl.constant(rates)
    assert isinstance(got, twl.WorkloadProcess)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
