"""The port's multi-process fleet: gloo worlds in subprocesses on the CPU.

Each world is N localhost worker processes joined through
``repro_torch.launch.mesh.init_distributed`` (``torch.distributed``, gloo),
each placing ``REPRO_FLEET_SLOTS`` slots on the CPU, one fleet cut over
the process-spanning mesh (``make_fleet_mesh(spanning=True)``).  The
workers import torch and the port only.

Pinned contracts:

* 2 processes x 2 slots == 1 process x 4 slots, bit for bit (the lanes are
  independent and drawn fleet-wide from one seed);
* a 2-process elastic run publishes the per-process layout
  (``step_N/proc_P/`` + ``meta.json``), which one process restores with
  ``restore_elastic``, the surviving lanes named by their original ids;
* the supervisor's drill: a worker killed at a published checkpoint, the job
  re-planned and resumed on one process, finishing equal to an
  uninterrupted run (moves and final assignments exact, and the floats
  too: the same operations on the same rows)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.launch.mesh import SLOTS_ENV                  # noqa: E402
from repro_torch.launch.multihost import free_port, worker_env  # noqa: E402

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT_S = 240


def _base_env(extra: dict | None = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"          # N workers share the host's cores
    env.update(extra or {})
    return env


def _launch(script: str, n_procs: int, slots: int,
            extra_env: dict | None = None) -> list[str]:
    """Run ``script`` as ``n_procs`` coordinated workers; every rank must
    exit 0 and print MH_OK.  Returns their outputs."""
    coordinator = f"127.0.0.1:{free_port()}"
    base = _base_env(extra_env)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script],
        env=worker_env(base, coordinator, n_procs, pid, slots),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(n_procs)]
    outs = []
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
            assert p.returncode == 0, f"rank {pid}/{n_procs} failed:\n{out}"
            assert "MH_OK" in out, f"rank {pid}/{n_procs}:\n{out}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


_SETUP = textwrap.dedent("""
    import os
    from repro_torch.launch.mesh import init_distributed, make_fleet_mesh
    pid, n = init_distributed()
    import numpy as np, torch
    from repro_torch.core import make_agent, run_online_fleet
    from repro_torch.dsdps import SchedulingEnv, apps, scenarios
    from repro_torch.dsdps.apps import default_workload

    topo = apps.continuous_queries("small")
    env = SchedulingEnv(topo, default_workload(topo), device="cpu")
    agent = make_agent("ddpg", env, k_nn=4)
    F, T = 4, 6
    params = scenarios.build("one_slow_machine", env, F, broadcast_invariant=True)
    states = agent.init_fleet(torch.Generator().manual_seed(0), F, "cpu",
                              env_params=params)
""")

_FLEET_TRACE_SCRIPT = _SETUP + textwrap.dedent("""
    mesh = make_fleet_mesh(spanning=True, device="cpu")
    assert mesh.size == 4, mesh
    _, h = run_online_fleet(1, env, agent, states, T, env_params=params, mesh=mesh)
    # every process holds the whole traces; rank 0 writes them
    if pid == 0:
        np.savez(os.environ["MH_OUT"], rewards=h.rewards, latencies=h.latencies,
                 moved=h.moved, X=h.final_assignment)
    print("MH_OK")
""")


def test_two_processes_match_one_bit_for_bit(tmp_path):
    """2 processes x 2 slots == 1 process x 4 slots on the same lane grid."""
    one, two = tmp_path / "one.npz", tmp_path / "two.npz"
    _launch(_FLEET_TRACE_SCRIPT, 1, 4, {"MH_OUT": str(one)})
    _launch(_FLEET_TRACE_SCRIPT, 2, 2, {"MH_OUT": str(two)})
    a, b = np.load(one), np.load(two)
    for name in ("rewards", "latencies", "moved", "X"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert a["moved"].sum() > 0


_ELASTIC_SAVE_SCRIPT = _SETUP + textwrap.dedent("""
    from repro_torch.checkpoint import FleetCheckpoint
    from repro_torch.fleet import run_online_fleet_elastic
    assert n == 2
    mesh = make_fleet_mesh(spanning=True, device="cpu")

    def stop_lane0(rewards_so_far, t):
        done = np.zeros(rewards_so_far.shape[0], bool)
        if t == 2:
            done[0] = True            # lane 0 converges at the first cut
        return done

    ck = FleetCheckpoint(os.environ["MH_CK"], every=2, use_async=False)
    res = run_online_fleet_elastic(1, env, agent, states, T, env_params=params,
                                   mesh=mesh, checkpoint=ck, stop_fn=stop_lane0)
    ck.close()
    assert res.epochs_run.tolist() == [2, T, T, T], res.epochs_run
    assert ck.is_multihost() and ck.has_lane_map()
    if pid == 0:
        np.savez(os.environ["MH_OUT"], rewards=res.history.rewards,
                 epochs_run=res.epochs_run, lane_ids=res.lane_ids)
    print("MH_OK")
""")

_ELASTIC_RESTORE_SCRIPT = _SETUP + textwrap.dedent("""
    from repro_torch.checkpoint import FleetCheckpoint
    from repro_torch.fleet import restore_elastic, run_online_fleet_elastic
    assert n == 1
    ck = FleetCheckpoint(os.environ["MH_CK"], every=2, use_async=False)
    assert ck.is_multihost()
    # resume from the mid-run snapshot, so epochs are left to finish here
    epoch, states2, env_state2, gen, params2, ids = restore_elastic(
        ck, states, env.reset(F, params), torch.Generator(), env_params=params,
        ref=env.default_params(), epoch=4)
    # lane 0 stopped in the 2-process run (a passenger since, -1 in the lane
    # map): lanes 1-3 survive, named by their original ids
    assert ids.tolist() == [1, 2, 3], ids
    never = lambda rewards_so_far, t: np.zeros(rewards_so_far.shape[0], bool)
    res = run_online_fleet_elastic(gen, env, agent, states2, T - epoch,
                                   env_params=params2, env_state=env_state2,
                                   start_epoch=epoch, lane_ids=ids, stop_fn=never)
    assert res.lane_ids.tolist() == [1, 2, 3]
    assert res.history.rewards.shape == (3, T - epoch)
    assert np.isfinite(res.history.rewards).all()
    print("MH_OK")
""")


def test_elastic_checkpoint_restores_across_process_counts(tmp_path):
    """A 2-process elastic run writes the per-process layout; one process
    restores it with the lane accounting intact and finishes."""
    ck_dir, out = tmp_path / "mh_ck", tmp_path / "elastic.npz"
    _launch(_ELASTIC_SAVE_SCRIPT, 2, 2, {"MH_CK": str(ck_dir), "MH_OUT": str(out)})
    run = np.load(out)
    assert run["epochs_run"].tolist() == [2, 6, 6, 6]
    assert run["lane_ids"].tolist() == [0, 1, 2, 3]
    steps = sorted(p.name for p in ck_dir.glob("step_*"))
    assert steps == ["step_00000002", "step_00000004", "step_00000006"]
    newest = ck_dir / steps[-1]
    meta = json.loads((newest / "meta.json").read_text())
    assert meta["process_count"] == 2 and meta["epoch"] == 6
    assert sorted(p.name for p in newest.glob("proc_*")) == \
        ["proc_00000", "proc_00001"]
    _launch(_ELASTIC_RESTORE_SCRIPT, 1, 1, {"MH_CK": str(ck_dir)})


# 12 epochs after the kill's epoch 4: the supervisor polls every 0.25 s, and
# a job that publishes its last step before the kill lands has nothing left
# to resume
_WORKER_ARGS = ["--app", "cq_small", "--fleet", "4", "--epochs", "16",
                "--offline", "50", "--offline-updates", "5",
                "--checkpoint-every", "2"]


def test_supervisor_heals_a_killed_worker(tmp_path):
    """The drill: 2 workers x 2 slots, worker 1 SIGKILLed once epoch 4 of 16
    is published, the job re-planned and resumed on 1 process; it exits 0
    and ends equal to an uninterrupted 1-process run of the same seed."""
    healed, whole = tmp_path / "healed.npz", tmp_path / "whole.npz"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost", "--procs", "2",
         "--devices-per-proc", "2", "--device", "cpu",
         "--checkpoint-dir", str(tmp_path / "ck"), "--kill-proc", "1",
         "--kill-at-epoch", "4", "--", *_WORKER_ARGS, "--save-history", str(healed)],
        env=_base_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "killing worker 1 (drill)" in out.stdout
    assert "job complete on 1 process(es)" in out.stdout, out.stdout
    subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.drl_control", "--device", "cpu",
         "--sharded", *_WORKER_ARGS[:-2], "--save-history", str(whole)],
        env=_base_env({SLOTS_ENV: "2"}), check=True, capture_output=True,
        timeout=TIMEOUT_S)
    h, w = np.load(healed), np.load(whole)
    start = int(h["start_epoch"])
    assert 4 <= start < 16
    for name in ("rewards", "latencies", "moved"):
        np.testing.assert_array_equal(h[name], w[name][:, start:], err_msg=name)
    for name in ("final_assignment", "finals"):
        np.testing.assert_array_equal(h[name], w[name], err_msg=name)


def test_worker_env_wiring():
    """worker_env sets the three coordinates init_distributed reads and the
    slot count make_fleet_mesh reads, and keeps the rest."""
    env = worker_env({"KEEP": "1"}, "127.0.0.1:1234", 2, 1, 8)
    assert env["REPRO_COORDINATOR"] == "127.0.0.1:1234"
    assert env["REPRO_NUM_PROCESSES"] == "2"
    assert env["REPRO_PROCESS_ID"] == "1"
    assert env[SLOTS_ENV] == "8" and env["KEEP"] == "1"
