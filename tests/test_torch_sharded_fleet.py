"""The port's meshed fleet (``run_online_fleet(..., mesh=)``), in process, on
the CPU: ``fault.elastic.plan_mesh`` and the partition decisions against
the reference's, the divisibility and agent checks, lanes on meshes of 1,
2 and 4 CPU slots (``REPRO_FLEET_SLOTS``) against the unmeshed port and
the reference on the reference's replayed draws, a meshed checkpoint
restored onto another slot count, and the elastic lifecycle padding a
compacted fleet with passenger lanes.

Tolerances: moves, final assignments and lane maps exact; a meshed lane
against the unmeshed port on the same draws bit for bit (the same
operations on the lane's rows); against the reference 1e-5 relative over
six epochs of DDPG or DQN learning (float32 reductions in another order
than XLA's)."""
import jax
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, carried_fleet,
                               cfg_pair, env_pair, jax_epoch_draws,
                               jax_tree_numpy, torch)

from repro.core import dqn as jdqn
from repro.core import exploration as jexpl
from repro.core import make_agent as jax_make_agent
from repro.core.agent import run_online_fleet as jax_run_online_fleet
from repro.dsdps import scenarios as jscen
from repro.fault.elastic import plan_mesh as jax_plan_mesh
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.sharding.fleet import params_partition_specs as jax_specs
from repro_torch.checkpoint import FleetCheckpoint
from repro_torch.core import ddpg as tddpg
from repro_torch.core import dqn as tdqn
from repro_torch.core import make_agent, run_online_fleet
from repro_torch.core.api import draw_epoch
from repro_torch.core.convert import dqn_state_from_numpy, env_params_from_numpy
from repro_torch.fault.elastic import make_mesh, plan_mesh, resume_after_failure
from repro_torch.fleet import run_online_fleet_elastic
from repro_torch.launch.mesh import SLOTS_ENV, make_fleet_mesh, make_host_mesh
from repro_torch.sharding import (REPLICATE, SHARD, FleetBlocks, compaction_size,
                                  fleet_axes, fleet_shardings, fleet_size,
                                  is_spanning, params_partition_specs)

F, T = 4, 6
FIELDS = ("rewards", "latencies", "moved", "final_assignment")


@pytest.fixture(scope="module")
def envs():
    return env_pair("cq_small")


def slots(monkeypatch, n: int):
    """A fleet mesh of ``n`` CPU slots in this process."""
    monkeypatch.setenv(SLOTS_ENV, str(n))
    return make_fleet_mesh(device="cpu")


def assert_same(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


# --------------------------------------------------------------------------
# planning and partition decisions
# --------------------------------------------------------------------------
@pytest.mark.parametrize("model_parallel", [1, 16])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_plan_mesh_matches_reference(model_parallel, multi_pod):
    for alive in range(1, 41):
        got = plan_mesh(alive, model_parallel, multi_pod)
        want = jax_plan_mesh(alive, model_parallel, multi_pod)
        assert (got.shape, got.axes, got.device_count) == \
            (want.shape, want.axes, want.device_count), alive
    with pytest.raises(ValueError):
        plan_mesh(0)


def test_mesh_axes_and_slots(monkeypatch):
    host = make_host_mesh("cpu")
    assert fleet_axes(host) == ("data",) and fleet_size(host) == 1
    assert not is_spanning(host)
    mesh = slots(monkeypatch, 4)
    assert mesh.shape == (4, 1) and fleet_size(mesh) == 4
    assert [s.device.type for s in mesh.slots.flat] == ["cpu"] * 4
    assert make_fleet_mesh(2, device="cpu").size == 2
    with pytest.raises(ValueError):
        make_fleet_mesh(5, device="cpu")
    plan = plan_mesh(4, model_parallel=1, multi_pod=True)
    pod = make_mesh(plan, device="cpu")
    assert pod.axis_names == ("pod", "data", "model") and fleet_size(pod) == 4


def test_params_partition_specs_match_reference(envs):
    """Stacked fields shard, broadcast-invariant ones replicate, field by
    field as the reference's PartitionSpecs on the same scenario fleet."""
    jenv, tenv = envs
    jp = jscen.build("one_slow_machine", jenv, 4, broadcast_invariant=True)
    tp = env_params_from_numpy(jax_tree_numpy(jp), "cpu")
    want = jax_specs(jp, jenv.default_params(), jax_host_mesh())
    got = params_partition_specs(tp, tenv.default_params(), make_host_mesh("cpu"))
    assert got._fields == want._fields
    decided = {f: (SHARD if w == jax.sharding.PartitionSpec(("data",)) else REPLICATE)
               for f, w in zip(want._fields, want)}
    assert dict(zip(got._fields, got)) == decided
    assert SHARD in decided.values() and REPLICATE in decided.values()
    single = params_partition_specs(tenv.default_params(), tenv.default_params(),
                                    make_host_mesh("cpu"))
    assert set(single) == {REPLICATE}


def test_fleet_shardings_and_compaction_size(monkeypatch):
    mesh = slots(monkeypatch, 2)
    tree = {"stacked": torch.zeros(4, 3), "vector": torch.zeros(4),
            "odd": torch.zeros(3), "scalar": torch.tensor(1.0),
            "gen": torch.Generator()}
    assert fleet_shardings(mesh, tree) == {
        "stacked": SHARD, "vector": SHARD, "odd": REPLICATE, "scalar": REPLICATE,
        "gen": REPLICATE}
    assert [compaction_size(n, mesh) for n in range(1, 6)] == [2, 2, 4, 4, 6]
    assert compaction_size(3, None) == 3
    assert compaction_size(3, make_host_mesh("cpu")) == 3


def test_indivisible_fleet_and_bad_agent_raise(envs, monkeypatch):
    _, tenv = envs
    mesh = slots(monkeypatch, 2)
    agent = make_agent("ddpg", tenv, k_nn=4)
    states = agent.init_fleet(torch.Generator().manual_seed(0), 3, "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        run_online_fleet(0, tenv, agent, states, 2, mesh=mesh)
    # mesh= does not loosen the Agent requirement: a bare config is refused
    # before anything is cut
    cfg = tddpg.DDPGConfig(n_executors=tenv.N, n_machines=tenv.M,
                           state_dim=tenv.state_dim, k_nn=4)
    with pytest.raises(TypeError, match="make_agent"):
        run_online_fleet(0, tenv, cfg, states, 2, mesh=mesh)


# --------------------------------------------------------------------------
# lanes on meshes against the unmeshed port and the reference
# --------------------------------------------------------------------------
def _ddpg_case(jenv, tenv):
    jcfg, tcfg = cfg_pair(jenv, k_nn=4, batch=8,
                          eps=jexpl.EpsilonSchedule(decay_epochs=10))
    tcfg = tddpg.DDPGConfig(**{**tcfg.__dict__,
                               "eps": tddpg.EpsilonSchedule(decay_epochs=10)})
    js, _ = carried_fleet(jcfg, F, seed=3)
    return (jax_make_agent("ddpg", jenv, cfg=jcfg), js,
            make_agent("ddpg", tenv, cfg=tcfg),
            lambda: carried_fleet(jcfg, F, seed=3)[1], jcfg)


def _dqn_case(jenv, tenv):
    jcfg = jdqn.DQNConfig(n_executors=jenv.N, n_machines=jenv.M,
                          state_dim=jenv.state_dim, batch=8,
                          eps=jexpl.EpsilonSchedule(decay_epochs=10))
    tcfg = tdqn.DQNConfig(n_executors=tenv.N, n_machines=tenv.M,
                          state_dim=tenv.state_dim, batch=8,
                          eps=tdqn.EpsilonSchedule(decay_epochs=10))
    js = jdqn.init_fleet(jax.random.PRNGKey(4), jcfg, F)
    return (jax_make_agent("dqn", jenv, cfg=jcfg), js,
            make_agent("dqn", tenv, cfg=tcfg),
            lambda: dqn_state_from_numpy(jax_tree_numpy(js), "cpu"), jcfg)


@pytest.mark.parametrize("case", [_ddpg_case, _dqn_case], ids=["ddpg", "dqn"])
def test_meshed_lanes_match_unmeshed_and_reference(envs, monkeypatch, case):
    """cq_small, F=4, T=6 under one_slow_machine, on the reference's replayed
    draws: the port on meshes of 1, 2 and 4 CPU slots equals the unmeshed
    port bit for bit and the reference's run_online_fleet on its host
    mesh (moves and final assignments exact)."""
    jenv, tenv = envs
    jagent, js, tagent, fresh, jcfg = case(jenv, tenv)
    jp = jscen.build("one_slow_machine", jenv, F, broadcast_invariant=True)
    tp = env_params_from_numpy(jax_tree_numpy(jp), "cpu")
    keys = jax.random.split(jax.random.PRNGKey(6), F)
    _, jh = jax_run_online_fleet(keys, jenv, jagent, js, T=T, env_params=jp,
                                 mesh=jax_host_mesh())
    draws = jax_epoch_draws(keys, T=T, U=1, B=jcfg.batch, N=jenv.N, M=jenv.M,
                            S=jenv.workload.num_spouts, eps=jcfg.eps,
                            cap=jcfg.buffer)
    _, plain = run_online_fleet(0, tenv, tagent, fresh(), T, env_params=tp,
                                draws=draws)
    assert_exact(plain.moved, jh.moved)
    assert_exact(plain.final_assignment, jh.final_assignment)
    assert plain.moved.sum() > 0
    assert_f32(plain.latencies, jh.latencies, rtol=1e-5)
    assert_f32(plain.rewards, jh.rewards, rtol=1e-5)
    for n in (1, 2, 4):
        _, h = run_online_fleet(0, tenv, tagent, fresh(), T, env_params=tp,
                                draws=draws, mesh=slots(monkeypatch, n))
        assert_same(h, plain)


def test_generator_draws_do_not_depend_on_the_mesh(envs, monkeypatch):
    """From the generator, lane f of a meshed run is the same on 1, 2 and 4
    slots, and equals the unmeshed run on the draws ``draw_epoch`` makes
    from a generator of the same seed."""
    _, tenv = envs
    agent = make_agent("ddpg", tenv, k_nn=4)
    params = tenv.default_params()

    def fresh():
        return agent.init_fleet(torch.Generator().manual_seed(0), F, "cpu")
    runs = {n: run_online_fleet(7, tenv, agent, fresh(), T,
                                mesh=slots(monkeypatch, n))[1] for n in (1, 2, 4)}
    assert_same(runs[2], runs[1])
    assert_same(runs[4], runs[1])
    gen = torch.Generator().manual_seed(7)
    draws = [draw_epoch(gen, tenv, agent, F) for _ in range(T)]
    _, plain = run_online_fleet(0, tenv, agent, fresh(), T, env_params=params,
                                draws=draws)
    assert_same(plain, runs[1])
    assert runs[1].moved.sum() > 0


# --------------------------------------------------------------------------
# checkpoints and the elastic lifecycle on a mesh
# --------------------------------------------------------------------------
def test_meshed_checkpoint_restores_on_another_slot_count(envs, monkeypatch, tmp_path):
    """A 2-slot run saving every 2 epochs, restored at epoch 4 onto 4 slots
    (``resume_after_failure``) and onto 1, finishes equal to the
    uninterrupted run."""
    _, tenv = envs
    agent = make_agent("ddpg", tenv, k_nn=4)

    def fresh():
        return agent.init_fleet(torch.Generator().manual_seed(0), F, "cpu")
    _, full = run_online_fleet(5, tenv, agent, fresh(), T, mesh=slots(monkeypatch, 4))
    ck = FleetCheckpoint(tmp_path, every=2, use_async=False, keep=5)
    run_online_fleet(5, tenv, agent, fresh(), T, checkpoint=ck,
                     mesh=slots(monkeypatch, 2))
    assert ck.all_epochs() == [2, 4, 6] and not ck.is_multihost()
    monkeypatch.setenv(SLOTS_ENV, "4")
    mesh, epoch, states, env_state, gen = resume_after_failure(
        FleetCheckpoint(tmp_path, every=2, use_async=False), tenv, agent,
        torch.Generator(), fresh())
    assert mesh.size == 4 and isinstance(states, FleetBlocks)
    assert [b.rows for b in states.blocks] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert epoch == 6
    for n in (4, 1):
        ck2 = FleetCheckpoint(tmp_path, every=2, use_async=False)
        mesh = slots(monkeypatch, n)
        epoch, states, env_state, gen = ck2.restore(
            fresh(), tenv.reset(F), torch.Generator(), epoch=4, mesh=mesh)
        _, tail = run_online_fleet(gen, tenv, agent, states, T - epoch,
                                   env_state=env_state, mesh=mesh, start_epoch=epoch)
        for f in ("rewards", "latencies", "moved"):
            np.testing.assert_array_equal(getattr(tail, f), getattr(full, f)[:, epoch:])
        np.testing.assert_array_equal(tail.final_assignment, full.final_assignment)
    # a fleet the mesh does not divide restores replicated, and the runner
    # refuses it as it refuses such a fleet
    epoch, states, _, _ = FleetCheckpoint(tmp_path, use_async=False).restore(
        fresh(), tenv.reset(F), torch.Generator(), mesh=slots(monkeypatch, 3))
    assert states.replicated and [b.rows for b in states.blocks] == [(0, 4)] * 3


def test_elastic_run_pads_with_passengers(envs, monkeypatch, tmp_path):
    """F=6 on 2 slots, lanes 0-2 stopped at epoch 2: the fleet compacts to 4
    rows (3 survivors + the most recent passenger, -1 in the lane map), and
    every survivor's trace equals the meshed fixed-grid run's; the stopped
    lanes' equal it up to their stop."""
    _, tenv = envs
    agent = make_agent("ddpg", tenv, k_nn=4)
    F6 = 6

    def fresh():
        return agent.init_fleet(torch.Generator().manual_seed(1), F6, "cpu")

    def stop_first_three(rewards_so_far, t):
        done = np.zeros(rewards_so_far.shape[0], bool)
        if t == 2:
            done[:3] = True
        return done
    mesh = slots(monkeypatch, 2)
    _, grid = run_online_fleet(3, tenv, agent, fresh(), T, mesh=mesh)
    ck = FleetCheckpoint(tmp_path, every=2, use_async=False, keep=5)
    res = run_online_fleet_elastic(3, tenv, agent, fresh(), T, mesh=mesh,
                                   checkpoint=ck, stop_fn=stop_first_three)
    assert res.epochs_run.tolist() == [2, 2, 2, T, T, T]
    assert res.executed_lane_epochs == F6 * 2 + 4 * (T - 2)
    for f in ("rewards", "latencies", "moved"):
        np.testing.assert_array_equal(getattr(res.history, f)[3:],
                                      getattr(grid, f)[3:])
        np.testing.assert_array_equal(getattr(res.history, f)[:3, :2],
                                      getattr(grid, f)[:3, :2])
    np.testing.assert_array_equal(res.history.final_assignment[3:],
                                  grid.final_assignment[3:])
    _, _, _, _, lanes = ck.restore(*(x for x in (
        agent.init_fleet(None, 4, "cpu"), tenv.reset(4), torch.Generator())),
        with_lane_map=True)
    assert lanes.tolist() == [-1, 3, 4, 5]
