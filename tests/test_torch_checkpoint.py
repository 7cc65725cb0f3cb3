"""Fleet checkpoints in the port: the generic checkpointer (layout, bf16,
keep-k, crc, atomicity, the asynchronous writer and its snapshot), the
on-disk format read across the two packages, template mismatches, the
FleetCheckpoint policy, kill-and-resume against an uninterrupted run for
every agent the port runs, resumed runs against the reference's, and the
launcher's --checkpoint-dir / --checkpoint-every / --resume."""
import copy
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (assert_exact, assert_f32, assert_tree_scaled,
                               cfg_pair, env_pair, jax_epoch_draws,
                               jax_tree_numpy, torch)
from test_torch_streaming import cfg_pair as agent_cfg_pair

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.fleet import FleetCheckpoint as JFleetCheckpoint
from repro.core import graph_policy as jgp
from repro.core import make_agent as jax_make_agent
from repro.core import reset_fleet_states
from repro.core.agent import run_online_fleet as jax_run_online_fleet
from repro.dsdps import apps as japps
from repro.dsdps import scenarios as jscen
from repro.dsdps.structural import StructuralSchedulingEnv as JStructEnv
from repro_torch.checkpoint import (AsyncCheckpointer, Checkpointer,
                                    FleetCheckpoint, named_leaves)
from repro_torch.core import convert, make_agent, run_online_fleet
from repro_torch.core.agent import chunk_schedule
from repro_torch.dsdps import StructuralSchedulingEnv, apps, scenarios
from repro_torch.launch import drl_control


def _state(seed=0):
    """The reference test's state (tests/test_checkpoint_data_fault.py) in
    torch: a float32 matrix, a bfloat16 vector and a 0-d int32 step."""
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "b": torch.randn(8, generator=g).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    return {"params": {k: torch.zeros_like(v) for k, v in tree["params"].items()},
            "step": torch.zeros_like(tree["step"])}


def assert_leaves_equal(got, want):
    """Two torch states leaf by leaf: the same names, bit for bit."""
    g, w = named_leaves(got), named_leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        if isinstance(a, torch.Generator):
            a, b = a.get_state(), b.get_state()
        assert a.dtype == b.dtype and torch.equal(a, b), name


def assert_history_equal(got, want):
    for field in ("rewards", "latencies", "moved", "final_assignment"):
        assert_exact(getattr(got, field), getattr(want, field))


# --------------------------------------------------------------------------
# the generic checkpointer (the reference's tests of it, mirrored)
# --------------------------------------------------------------------------
def test_checkpoint_roundtrip_with_a_bf16_leaf(tmp_path):
    ck = Checkpointer(tmp_path)
    st = _state()
    path = ck.save(7, st)
    manifest = json.loads((path / "manifest.json").read_text())
    assert [e["name"] for e in manifest["leaves"]] == ["params.b", "params.w", "step"]
    assert manifest["leaves"][0]["dtype"] == "bfloat16"
    assert np.load(path / "leaf_00000.npy").dtype == np.uint16
    out = ck.restore(_zeros_like(st))
    assert_leaves_equal(out, st)


def test_checkpoint_keeps_latest_k(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s))
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_detects_corruption(tmp_path):
    ck = Checkpointer(tmp_path)
    path = ck.save(1, _state())
    leaf = next(path.glob("leaf_*.npy"))
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    template = _zeros_like(_state())
    with pytest.raises(IOError, match="corruption"):
        ck.restore(template)
    # nothing was written into the template before the check
    assert_leaves_equal(template, _zeros_like(_state()))


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(tmp_path)
    st = _state()
    ck.save_async(5, st)
    ck.save_async(10, st)
    ck.wait()
    assert ck.all_steps() == [5, 10]
    assert_leaves_equal(ck.restore(_zeros_like(st), step=10), st)
    ck.close()


def test_checkpoint_atomicity(tmp_path):
    """A stale .tmp directory from a crashed writer shadows nothing."""
    ck = Checkpointer(tmp_path)
    (tmp_path / ".tmp_step_00000009").mkdir()
    ck.save(3, _state())
    assert ck.latest_step() == 3


# --------------------------------------------------------------------------
# the on-disk format, read across the two packages
# --------------------------------------------------------------------------
def _reference_state():
    st = _state(3)
    return {"params": {"w": jnp.asarray(st["params"]["w"].numpy()),
                       "b": jnp.asarray(st["params"]["b"].float().numpy(),
                                        jnp.bfloat16)},
            "step": jnp.asarray(7, jnp.int32)}


def test_the_port_reads_the_references_checkpoint(tmp_path):
    """The reference writes ``{"params": {"w", "b" (bf16)}, "step"}``; the
    port reads it bit for bit, bf16 included."""
    ref = _reference_state()
    JCheckpointer(tmp_path).save(7, ref)
    got = Checkpointer(tmp_path).restore(_zeros_like(_state()))
    assert_exact(got["params"]["w"].numpy(), np.asarray(ref["params"]["w"]))
    assert_exact(got["params"]["b"].view(torch.int16).numpy().view(np.uint16),
                 np.asarray(ref["params"]["b"]).view(np.uint16))
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32


def test_the_reference_reads_the_ports_checkpoint(tmp_path):
    """The port writes the same values; the reference reads them bit for
    bit, and both manifests are equal (names, files, shapes, dtypes,
    crc32s)."""
    ref = _reference_state()
    path = Checkpointer(tmp_path / "port").save(7, _state(3))
    JCheckpointer(tmp_path / "ref").save(7, ref)
    got = JCheckpointer(tmp_path / "port").restore(
        jax.tree.map(jnp.zeros_like, ref))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    ours = json.loads((path / "manifest.json").read_text())
    theirs = json.loads((tmp_path / "ref" / "step_00000007" / "manifest.json").read_text())
    assert ours == theirs


# --------------------------------------------------------------------------
# the asynchronous writer: its snapshot, its buffers, its errors
# --------------------------------------------------------------------------
def _ddpg_bundle(F=2):
    env = drl_control.build_env("cq_small", "cpu")
    agent = make_agent("ddpg", env, k_nn=4)
    states = agent.init_fleet(torch.Generator().manual_seed(0), F, "cpu")
    return {"agent": states, "env": env.reset(F), "gen": torch.Generator().manual_seed(5)}


def _clone_bundle(b):
    """An independent copy of a bundle's values (same structure)."""
    out = _ddpg_bundle(b["env"].X.shape[0])
    with torch.no_grad():
        for (_, x), (_, y) in zip(named_leaves(out), named_leaves(b)):
            if isinstance(x, torch.Generator):
                x.set_state(y.get_state())
            else:
                x.copy_(y)
    return out


@pytest.mark.parametrize("overlap_transfer", [True, False])
def test_async_save_snapshots_before_it_returns(tmp_path, overlap_transfer):
    """The loop writes its state in place (replay_add, apply_updates): every
    leaf is mutated, and the generator drawn from, right after save_async
    while the writer is slowed; the file holds the values of the call."""
    ck = AsyncCheckpointer(tmp_path, overlap_transfer=overlap_transfer)
    orig_write = ck._write

    def slow_write(*a, **k):
        time.sleep(0.2)
        return orig_write(*a, **k)

    ck._write = slow_write
    bundle = _ddpg_bundle()
    want = _clone_bundle(bundle)
    ck.save_async(1, bundle)
    with torch.no_grad():
        for _, leaf in named_leaves(bundle):
            if isinstance(leaf, torch.Generator):
                torch.rand(3, generator=leaf)
            else:
                leaf.add_(1)
    ck.wait()
    assert_leaves_equal(ck.restore(_ddpg_bundle()), want)
    ck.close()


def test_async_buffers_reused_across_saves_keep_each_saves_values(tmp_path):
    """Eight saves in a row through the two sets of host buffers (each
    reused once its write is done), with the interpreter switching threads
    every microsecond: each step holds its own values."""
    steps = range(1, 9)
    ck = AsyncCheckpointer(tmp_path, keep=len(steps))
    bundle, wants = _ddpg_bundle(), []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in steps:
            wants.append(_clone_bundle(bundle))
            ck.save_async(step, bundle)
            with torch.no_grad():
                for _, leaf in named_leaves(bundle["agent"]):
                    leaf.add_(step)
    finally:
        sys.setswitchinterval(interval)
        ck.close()
    assert not ck._worker.is_alive()
    assert ck.all_steps() == list(steps)
    for step, want in zip(steps, wants):
        assert_leaves_equal(ck.restore(_ddpg_bundle(), step=step), want)


def test_a_failed_async_write_is_raised_not_swallowed(tmp_path):
    ck = FleetCheckpoint(tmp_path, every=1)

    def broken_write(*a, **k):
        raise OSError("disk full")

    ck._ck._write = broken_write
    b = _ddpg_bundle()
    ck.save(1, b["agent"], b["env"], b["gen"])
    with pytest.raises(OSError, match="disk full"):
        ck.close()
    assert ck.latest_epoch() is None


# --------------------------------------------------------------------------
# templates that do not fit raise before anything is written
# --------------------------------------------------------------------------
def _fleet_state(F, dtype=torch.float32, extra=False):
    st = {"w": torch.arange(F * 3, dtype=dtype).reshape(F, 3) + 1,
          "step": torch.tensor(4, dtype=torch.int32)}
    if extra:
        st["z"] = torch.ones(F)
    return st


@pytest.mark.parametrize("saved,template,match", [
    (_fleet_state(2), _fleet_state(3), r"w is float32\[2, 3\], the template's float32\[3, 3\]"),
    (_fleet_state(1), _fleet_state(2), r"w is float32\[1, 3\]"),     # would broadcast
    (_fleet_state(2, extra=True), _fleet_state(2), r"not in the template \['z'\]"),
    (_fleet_state(2), _fleet_state(2, extra=True), r"not saved \['z'\]"),
    (_fleet_state(2), _fleet_state(2, dtype=torch.float64), r"the template's float64"),
], ids=["shape", "one-lane-into-two", "missing", "extra", "dtype"])
def test_a_template_that_does_not_fit_raises(tmp_path, saved, template, match):
    ck = Checkpointer(tmp_path)
    ck.save(1, saved)
    before = {k: v.clone() for k, v in template.items()}
    with pytest.raises(ValueError, match=match):
        ck.restore(template)
    for k, v in template.items():
        assert torch.equal(v, before[k])


def test_a_generator_restores_only_into_its_device_type(tmp_path):
    """A generator round-trips through its state; a CUDA generator's state
    (16 bytes: seed and Philox offset) does not fit a CPU generator's
    5056-byte Mersenne-Twister state, and the error says why."""
    ck = Checkpointer(tmp_path)
    g = torch.Generator().manual_seed(9)
    ck.save(1, {"gen": g})
    want = torch.rand(4, generator=g)
    got = ck.restore({"gen": torch.Generator()})["gen"]
    assert torch.equal(torch.rand(4, generator=got), want)
    ck.save(2, {"gen": torch.zeros(16, dtype=torch.uint8)})
    with pytest.raises(ValueError, match="same device type"):
        ck.restore({"gen": torch.Generator()}, step=2)


# --------------------------------------------------------------------------
# FleetCheckpoint
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    env = drl_control.build_env("cq_small", "cpu")
    agent = make_agent("ddpg", env, k_nn=4, batch=8)

    def fresh(F=3):
        return agent.init_fleet(torch.Generator().manual_seed(0), F, "cpu")
    return env, agent, fresh


def test_save_cadence_and_epoch_tagging(tmp_path, small):
    env, agent, fresh = small
    assert chunk_schedule(10, 4) == [4, 4, 2] and chunk_schedule(10, None) == [10]
    ck = FleetCheckpoint(tmp_path, every=4, keep=10)
    states, _ = run_online_fleet(1, env, agent, fresh(), T=10, checkpoint=ck)
    ck.wait()
    assert ck.all_epochs() == [4, 8, 10]
    assert ck.latest_epoch() == 10
    ck.close()
    ck.close()                       # closing twice, then reading, is fine
    epoch, got, _, _ = ck.restore(fresh(), env.reset(3), torch.Generator())
    assert epoch == 10
    assert_leaves_equal(got, states)
    with pytest.raises(RuntimeError, match="closed"):
        ck.save(11, states, env.reset(3), torch.Generator())


def test_restore_from_an_empty_directory_and_a_zero_cadence_raise(tmp_path, small):
    env, _, fresh = small
    ck = FleetCheckpoint(tmp_path, every=2, use_async=False)
    with pytest.raises(FileNotFoundError):
        ck.restore(fresh(), env.reset(3), torch.Generator())
    assert not ck.has_lane_map()
    with pytest.raises(ValueError):
        FleetCheckpoint(tmp_path, every=0)


def test_lane_map_roundtrip(tmp_path, small):
    """An elastic run's snapshot: two surviving rows, originally lanes 0
    and 2, restore with their lane map; without with_lane_map the
    template does not fit."""
    env, _, fresh = small
    states, env_state, gen = fresh(2), env.reset(2), torch.Generator().manual_seed(3)
    ck = FleetCheckpoint(tmp_path, every=2, use_async=False)
    ck.save(4, states, env_state, gen, lane_map=np.array([0, 2]))
    assert ck.has_lane_map() and ck.has_lane_map(4)
    epoch, r_states, r_env, r_gen, lanes = ck.restore(
        fresh(2), env.reset(2), torch.Generator(), with_lane_map=True)
    assert epoch == 4
    assert_exact(lanes, np.array([0, 2]))
    assert_leaves_equal(r_states, states)
    assert_leaves_equal({"env": r_env, "gen": r_gen}, {"env": env_state, "gen": gen})
    with pytest.raises(ValueError, match="lanes"):
        ck.restore(fresh(2), env.reset(2), torch.Generator())


# --------------------------------------------------------------------------
# kill and resume == uninterrupted, for every agent the port runs
# --------------------------------------------------------------------------
DSDPS_AGENTS = ("ddpg", "dqn", "graph_policy", "model_based", "round_robin",
                "stream_ac", "stream_q")
PLACEMENT_AGENTS = ("ddpg", "dqn", "round_robin", "stream_ac", "stream_q")
COVERAGE = ([("cq_small", a, "one_slow_machine") for a in DSDPS_AGENTS]
            + [("structural", "graph_policy", "dag_shapes")]
            + [("placement", a, "mixed") for a in PLACEMENT_AGENTS])


@pytest.mark.parametrize("app,agent,scenario", COVERAGE)
def test_kill_and_resume_equals_uninterrupted(tmp_path, app, agent, scenario):
    """Bit for bit on the CPU, from the generator's draws: a run cut every 2
    epochs equals the unchunked run, and a run killed after 4 of 6 epochs
    and resumed from its checkpoint into fresh templates (agent states, env
    state, generator) reaches the same traces, final assignment and state.
    model_based's state is a bare [F, P] tensor, round_robin's a bare [F]
    one, the placement env's a PlacementState; the checkpoint code treats
    none of them specially."""
    F, T, kill, every = 3, 6, 4, 2
    env = drl_control.build_env(app, "cpu")
    params = scenarios.build_for(env, scenario, F)
    ag = make_agent(agent, env, **({"k_nn": 4, "batch": 8} if agent == "ddpg" else {}))
    init = ag.init_fleet(torch.Generator().manual_seed(0), F, "cpu", env_params=params)

    def fresh():
        return copy.deepcopy(init)

    def run(states, T, gen=None, **kw):
        gen = torch.Generator().manual_seed(1) if gen is None else gen
        return run_online_fleet(gen, env, ag, states, T, env_params=params, **kw)

    s_u, h_u = run(fresh(), T)
    assert np.isfinite(h_u.rewards).all()
    ck = FleetCheckpoint(tmp_path / "chunked", every=every)
    s_c, h_c = run(fresh(), T, checkpoint=ck)
    ck.close()
    assert ck.all_epochs() == [2, 4, 6]
    assert_history_equal(h_c, h_u)
    assert_leaves_equal(s_c, s_u)

    ck = FleetCheckpoint(tmp_path / "killed", every=every)
    run(fresh(), kill, checkpoint=ck)
    ck.close()                            # the process dies here
    ck = FleetCheckpoint(tmp_path / "killed", every=every)
    epoch, states, env_state, gen = ck.restore(fresh(), env.reset(F, params),
                                               torch.Generator())
    assert epoch == kill
    s_r, h_r = run(states, T - kill, gen=gen, env_state=env_state,
                   checkpoint=ck, start_epoch=epoch)
    ck.close()
    assert ck.latest_epoch() == T
    for field in ("rewards", "latencies", "moved"):
        assert_exact(getattr(h_r, field), getattr(h_u, field)[:, kill:])
    assert_exact(h_r.final_assignment, h_u.final_assignment)
    assert_leaves_equal(s_r, s_u)


# --------------------------------------------------------------------------
# resumed runs against the reference's
# --------------------------------------------------------------------------
def test_resumed_ddpg_fleet_matches_the_references(tmp_path):
    """The reference test's setup (cq_small, F=3, K-NN 4, T=12, every 4,
    killed after 8): both packages save, restore and resume, the port on
    the reference's draws.  The restored states agree leaf by leaf through
    core/convert.py (integers exact; floats at rtol 1e-4 with a slack of
    1e-5 of the leaf's largest magnitude: eight epochs of float32 learning
    in another summation order), and the resumed traces agree (moves and
    assignments exact; rewards and latencies at rtol 1e-4)."""
    jenv, tenv = env_pair("cq_small")
    jcfg, tcfg = cfg_pair(jenv, k_nn=4)
    F, T, every, kill = 3, 12, 4, 8
    js = jax.tree.map(np.asarray, jax_make_agent("ddpg", jenv, cfg=jcfg).init_fleet(
        jax.random.PRNGKey(0), F))
    keys = jax.random.split(jax.random.PRNGKey(1), F)
    jagent = jax_make_agent("ddpg", jenv, cfg=jcfg)
    jck = JFleetCheckpoint(tmp_path / "ref", every=every, use_async=False)
    jax_run_online_fleet(keys, jenv, jagent, js, T=kill, checkpoint=jck)
    epoch, jstates, jenv_states, jkeys = JFleetCheckpoint(
        tmp_path / "ref", every=every).restore(js, reset_fleet_states(keys, jenv), keys)
    assert epoch == kill
    _, jh = jax_run_online_fleet(jkeys, jenv, jagent, jstates, T=T - kill,
                                 env_states=jenv_states, start_epoch=epoch)

    draws = jax_epoch_draws(keys, T=T, U=1, B=jcfg.batch, N=jenv.N, M=jenv.M,
                            S=jenv.workload.num_spouts, eps=jcfg.eps, cap=jcfg.buffer)
    agent = make_agent("ddpg", tenv, cfg=tcfg)
    ck = FleetCheckpoint(tmp_path / "port", every=every)
    run_online_fleet(0, tenv, agent, convert.ddpg_state_from_numpy(js, "cpu"), kill,
                     draws=draws[:kill], checkpoint=ck)
    ck.close()
    epoch, states, env_state, gen = FleetCheckpoint(tmp_path / "port").restore(
        convert.ddpg_state_from_numpy(js, "cpu"), tenv.reset(F), torch.Generator())
    assert epoch == kill
    got, want = convert.ddpg_state_to_numpy(states), jax_tree_numpy(jstates)
    for name in ("epoch", "r_count"):
        assert_exact(getattr(got, name), getattr(want, name))
    assert_exact(got.replay.ptr, want.replay.ptr)
    assert_exact(got.replay.actions, want.replay.actions)
    assert_exact(got.opt_critic.step, want.opt_critic.step)
    assert_tree_scaled(got, want, rtol=1e-4, scale_atol=1e-5)
    assert_exact(env_state.X.numpy(), np.asarray(jenv_states.X))

    _, th = run_online_fleet(gen, tenv, agent, states, T - kill, draws=draws[kill:],
                             env_state=env_state, start_epoch=epoch)
    assert_exact(th.moved, jh.moved)
    assert_exact(th.final_assignment, jh.final_assignment)
    assert th.moved.sum() > 0
    assert_f32(th.latencies, jh.latencies, rtol=1e-4)
    assert_f32(th.rewards, jh.rewards, rtol=1e-4)


def test_resumed_structural_graph_policy_fleet_matches_the_references(tmp_path):
    """The reference test's structural setup (dag_shapes, F=2, T=6, every
    3): the reference saves, restores without ``mesh=`` (its ``mesh=``
    path fails on its own, ROADMAP C7) and resumes; the port does the same
    on the reference's draws.  Restored states at rtol 1e-5 with a slack of
    1e-6 of each leaf's largest magnitude; the resumed traces' moves and
    assignments exact, rewards and latencies at rtol 1e-5."""
    jenv = JStructEnv(japps.structural_topologies())
    tenv = StructuralSchedulingEnv(apps.structural_topologies(), device="cpu")
    jcfg, tcfg = agent_cfg_pair("graph_policy", jenv)
    F, T, every = 2, 6, 3
    jp = jscen.build_for(jenv, "dag_shapes", F)
    tp = convert.graph_env_params_from_numpy(jax_tree_numpy(jp), "cpu")
    js = jax_tree_numpy(jgp.init_fleet(jax.random.PRNGKey(2), jcfg, F))
    keys = jax.random.split(jax.random.PRNGKey(3), F)
    jagent = jax_make_agent("graph_policy", jenv, cfg=jcfg)
    jck = JFleetCheckpoint(tmp_path / "ref", every=every, use_async=False)
    jax_run_online_fleet(keys, jenv, jagent, js, T=every, env_params=jp, checkpoint=jck)
    epoch, jstates, jenv_states, jkeys = jck.restore(
        js, reset_fleet_states(keys, jenv, jp), keys)
    _, jh = jax_run_online_fleet(jkeys, jenv, jagent, jstates, T=T - epoch,
                                 env_params=jp, env_states=jenv_states,
                                 start_epoch=epoch)

    draws = jax_epoch_draws(keys, T=T, U=1, B=1, N=jenv.N, M=jenv.M,
                            S=jenv.envelope.max_spouts, eps=jcfg.eps, gumbel="rand")
    agent = make_agent("graph_policy", tenv, cfg=tcfg)
    ck = FleetCheckpoint(tmp_path / "port", every=every, use_async=False)
    run_online_fleet(0, tenv, agent, convert.graph_policy_state_from_numpy(js, "cpu"),
                     every, env_params=tp, draws=draws[:every], checkpoint=ck)
    epoch, states, env_state, gen = ck.restore(
        convert.graph_policy_state_from_numpy(js, "cpu"), tenv.reset(F, tp),
        torch.Generator())
    assert epoch == every
    got, want = convert.graph_policy_state_to_numpy(states), jax_tree_numpy(jstates)
    assert_exact(got.r_count, want.r_count)
    assert_tree_scaled(got, want, rtol=1e-5)
    _, th = run_online_fleet(gen, tenv, agent, states, T - epoch, env_params=tp,
                             draws=draws[epoch:], env_state=env_state,
                             start_epoch=epoch)
    assert_exact(th.moved, jh.moved)
    assert_exact(th.final_assignment, jh.final_assignment)
    assert th.moved.sum() > 0
    assert_f32(th.latencies, jh.latencies, rtol=1e-5)
    assert_f32(th.rewards, jh.rewards, rtol=1e-5)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
LAUNCH = ["--device", "cpu", "--app", "cq_small", "--fleet", "2", "--offline", "50",
          "--offline-updates", "5"]


def test_launcher_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """--epochs 4 saving every 2, then --resume --epochs 6, equals an
    uninterrupted --epochs 6, bit for bit; the resumed call skips offline
    pretraining, runs 2 epochs and counts only those."""
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    first = drl_control.main(LAUNCH + ck + ["--epochs", "4"])
    assert first["start_epoch"] == 0 and "flush" in first["seconds"]
    res = drl_control.main(LAUNCH + ck + ["--epochs", "6", "--resume"])
    full = drl_control.main(LAUNCH + ["--epochs", "6"])
    assert "final latency" in capsys.readouterr().out
    assert res["start_epoch"] == 4 and res["history"].rewards.shape == (2, 2)
    assert res["seconds"]["offline"] < full["seconds"]["offline"]
    for field in ("rewards", "latencies", "moved"):
        assert_exact(getattr(res["history"], field), getattr(full["history"], field)[:, 4:])
    assert_exact(res["history"].final_assignment, full["history"].final_assignment)
    assert_leaves_equal(res["states"], full["states"])
    assert_exact(res["finals"], full["finals"])
    assert FleetCheckpoint(tmp_path).all_epochs() == [2, 4, 6]


def test_launcher_resume_needs_a_checkpoint_dir(capsys):
    with pytest.raises(SystemExit):
        drl_control.main(LAUNCH + ["--epochs", "2", "--resume"])
    assert "--resume needs --checkpoint-dir" in capsys.readouterr().err
    with pytest.raises(ValueError, match="checkpoint directory"):
        drl_control.run(device="cpu", offline=0, epochs=2, resume=True)


def test_launcher_resume_at_or_past_epochs_runs_nothing(tmp_path, capsys):
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    drl_control.main(LAUNCH + ck + ["--epochs", "4"])
    capsys.readouterr()
    for epochs in ("4", "3"):
        assert drl_control.main(LAUNCH + ck + ["--epochs", epochs, "--resume"]) is None
        assert "nothing left to run" in capsys.readouterr().out
    assert FleetCheckpoint(tmp_path).all_epochs() == [2, 4]


def test_launcher_refuses_an_elastic_snapshot(tmp_path, small, capsys):
    env, _, fresh = small
    FleetCheckpoint(tmp_path, use_async=False).save(
        2, fresh(2), env.reset(2), torch.Generator(), lane_map=[0, 1])
    with pytest.raises(SystemExit):
        drl_control.main(LAUNCH + ["--epochs", "4", "--resume",
                                   "--checkpoint-dir", str(tmp_path)])
    assert "lane map" in capsys.readouterr().err
    with pytest.raises(ValueError, match="--early-stop"):
        drl_control.run(device="cpu", fleet=2, offline=0, epochs=4,
                        checkpoint_dir=tmp_path, resume=True)
