"""Localhost multi-process fleet supervisor: spawn, supervise, heal.

Port of ``repro/launch/multihost.py``.  It launches ``--procs`` worker
processes of the same training command (by default
``repro_torch.launch.drl_control --distributed``), wired together as one
``torch.distributed`` job over localhost:

* each worker gets ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` /
  ``REPRO_PROCESS_ID`` (what ``launch.mesh.init_distributed`` reads) and
  ``REPRO_FLEET_SLOTS`` (``--devices-per-proc`` slots on its device, the
  counterpart of the reference's ``--xla_force_host_platform_device_count``),
  and, for the default worker module, a ``--device`` of its own: with
  ``--device cuda`` rank r takes card ``r % torch.cuda.device_count()``
  (several ranks share a card when there are more ranks than cards; their
  process group is gloo, which allows it), with ``--device cpu`` every
  rank runs on the CPU;
* the supervisor is the Storm-style master: a
  :class:`repro_torch.fault.heartbeat.HeartbeatMonitor` tracks worker
  liveness (a running process is its heartbeat), and when a worker dies
  the surviving job is torn down, the reduced mesh is sized with
  :func:`repro_torch.fault.elastic.plan_mesh` (``model_parallel=1``: fleets
  are data-only), and the job is relaunched on the survivors with
  ``--resume``, so it goes on from the newest published multi-host
  checkpoint;
* ``--kill-proc P --kill-at-epoch E`` injects the failure
  deterministically: once the shared checkpoint directory publishes a step
  at epoch >= E, worker P is SIGKILLed.  A worker that exits non-zero
  after the last restart makes the supervisor exit 1.

Everything after ``--`` goes to the worker module verbatim
(``--distributed``, ``--device`` and the supervisor's ``--checkpoint-dir`` are
appended)::

  PYTHONPATH=src python -m repro_torch.launch.multihost \\
      --procs 2 --devices-per-proc 2 --device cpu --checkpoint-dir build/mh_ck \\
      --kill-proc 1 --kill-at-epoch 4 -- \\
      --app cq_small --fleet 4 --epochs 8 --offline 50 --offline-updates 5 \\
      --checkpoint-every 2
"""
from __future__ import annotations

import argparse
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

from repro_torch.fault.elastic import plan_mesh
from repro_torch.fault.heartbeat import HeartbeatMonitor
from repro_torch.launch.mesh import (COORDINATOR_ENV, NUM_PROCESSES_ENV,
                                     PROCESS_ID_ENV, SLOTS_ENV)

DEFAULT_MODULE = "repro_torch.launch.drl_control"


def free_port() -> int:
    """An OS-assigned free TCP port on localhost (racy in principle, fine for
    a supervisor that binds it again at once)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def published_epochs(checkpoint_dir: str | os.PathLike) -> list[int]:
    """Epochs of the PUBLISHED checkpoints in ``checkpoint_dir``:
    single-process steps (``manifest.json``) and complete multi-host steps
    (``meta.json``), without making a FleetCheckpoint (whose async writer
    thread a peek does not need)."""
    d = pathlib.Path(checkpoint_dir)
    return sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                  if (p / "manifest.json").exists() or (p / "meta.json").exists())


def worker_env(base: dict, coordinator: str, num_processes: int,
               process_id: int, devices_per_proc: int) -> dict:
    """Environment of one localhost worker: the process group's coordinates
    and its slot count."""
    env = dict(base)
    env[COORDINATOR_ENV] = coordinator
    env[NUM_PROCESSES_ENV] = str(num_processes)
    env[PROCESS_ID_ENV] = str(process_id)
    env[SLOTS_ENV] = str(devices_per_proc)
    return env


def worker_device(device: str, rank: int) -> str:
    """The ``--device`` of worker ``rank``: on CUDA card ``rank % count``."""
    if device.startswith("cuda") and ":" not in device:
        import torch
        return f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
    return device


def launch_workers(module: str, worker_args: list[str], n_procs: int,
                   devices_per_proc: int, log_dir: pathlib.Path, attempt: int,
                   device: str | None = None) -> list[subprocess.Popen]:
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    for pid in range(n_procs):
        log = log_dir / f"attempt{attempt}_proc{pid}.log"
        f = open(log, "w")
        args = list(worker_args)
        if device is not None:
            args += ["--device", worker_device(device, pid)]
        p = subprocess.Popen(
            [sys.executable, "-m", module, *args],
            env=worker_env(os.environ, coordinator, n_procs, pid,
                           devices_per_proc),
            stdout=f, stderr=subprocess.STDOUT)
        p._repro_log = log          # type: ignore[attr-defined]
        p._repro_logfile = f        # type: ignore[attr-defined]
        procs.append(p)
    return procs


def _close_logs(procs: list[subprocess.Popen]) -> None:
    for p in procs:
        p._repro_logfile.close()    # type: ignore[attr-defined]


def _terminate(procs: list[subprocess.Popen], grace_s: float = 10.0) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def supervise(procs: list[subprocess.Popen], *,
              checkpoint_dir: str | None,
              kill_proc: int | None, kill_at_epoch: int,
              poll_s: float = 0.25,
              timeout_s: float = 1800.0) -> tuple[bool, set[int]]:
    """Run the job to its end under heartbeat supervision.

    A worker that is still running beats its heartbeat every poll; one that
    exits misses beats and surfaces in ``newly_dead``: a non-zero exit is a
    failure at once, a zero exit counts only once ALL workers finished (a
    collective job cannot half succeed).  Returns ``(ok, dead)``: ``ok``
    when every worker exited 0; ``dead`` the failed worker ids."""
    monitor = HeartbeatMonitor(num_workers=len(procs), timeout_s=3 * poll_s)
    killed: set[int] = set()
    deadline = time.monotonic() + timeout_s
    while True:
        running = [i for i, p in enumerate(procs) if p.poll() is None]
        for i in running:
            monitor.beat(i)
        if (kill_proc is not None and kill_proc not in killed
                and checkpoint_dir is not None
                and procs[kill_proc].poll() is None):
            steps = published_epochs(checkpoint_dir)
            if steps and steps[-1] >= kill_at_epoch:
                print(f"[multihost] checkpoint at epoch {steps[-1]} "
                      f"published; killing worker {kill_proc} (drill)", flush=True)
                procs[kill_proc].send_signal(signal.SIGKILL)
                killed.add(kill_proc)
        # a worker that exited non-zero is dead at once; one that only
        # stopped beating joins it through the heartbeat timeout, but a
        # clean exit 0 a little ahead of the others (workers leave the last
        # barrier in any order) is not a failure
        dead = ({i for i, p in enumerate(procs) if p.poll() not in (None, 0)}
                | {i for i in monitor.newly_dead() if procs[i].poll() != 0})
        if dead:
            _terminate(procs)
            _close_logs(procs)
            return False, dead
        if not running:
            _close_logs(procs)
            return all(p.returncode == 0 for p in procs), set()
        if time.monotonic() > deadline:
            print(f"[multihost] supervision timeout after {timeout_s:.0f}s; "
                  f"tearing the job down", flush=True)
            _terminate(procs)
            _close_logs(procs)
            return False, set(range(len(procs)))
        time.sleep(poll_s)


def _print_log(path: pathlib.Path, header: str, tail: int | None = None) -> None:
    print(f"----- {header} ({path}) -----")
    lines = path.read_text().splitlines()
    for line in (lines[-tail:] if tail else lines):
        print(f"  {line}")


def run(module: str, worker_args: list[str], *, procs: int,
        devices_per_proc: int, checkpoint_dir: str | None,
        kill_proc: int | None = None, kill_at_epoch: int = 0,
        max_restarts: int = 1, log_dir: str | None = None,
        timeout_s: float = 1800.0, device: str | None = None) -> int:
    """Drive the multi-process job, healing through up to ``max_restarts``
    failures; ``device`` (None: the worker's own default) is handed to each
    worker as its ``--device`` (:func:`worker_device`).  Returns a process
    exit code; prints each attempt's wall s."""
    base_args = list(worker_args)
    if checkpoint_dir is not None:
        base_args += ["--checkpoint-dir", checkpoint_dir]
    logs = pathlib.Path(log_dir or checkpoint_dir or ".")
    logs.mkdir(parents=True, exist_ok=True)

    n, attempt = int(procs), 0
    while True:
        resumed = attempt > 0
        args = base_args + (["--resume"] if resumed else [])
        print(f"[multihost] attempt {attempt}: launching {n} worker "
              f"process(es) x {devices_per_proc} device(s) "
              f"({'resuming' if resumed else 'fresh'})", flush=True)
        t0 = time.perf_counter()
        workers = launch_workers(module, args, n, devices_per_proc, logs,
                                 attempt, device)
        ok, dead = supervise(
            workers, checkpoint_dir=checkpoint_dir,
            kill_proc=kill_proc if attempt == 0 else None,
            kill_at_epoch=kill_at_epoch, timeout_s=timeout_s)
        print(f"[multihost] attempt {attempt} wall "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        if ok:
            _print_log(workers[0]._repro_log,  # type: ignore[attr-defined]
                       f"worker 0 attempt {attempt}")
            print(f"[multihost] job complete on {n} process(es)", flush=True)
            return 0
        print(f"[multihost] worker(s) {sorted(dead)} died", flush=True)
        if attempt >= max_restarts or checkpoint_dir is None:
            for w in workers:
                _print_log(w._repro_log,  # type: ignore[attr-defined]
                           "failed worker", tail=30)
            print("[multihost] out of restarts (or no --checkpoint-dir "
                  "to resume from); giving up", flush=True)
            return 1
        # Storm-style recovery: size the reduced mesh over the surviving
        # devices and relaunch the whole collective job on them; the workers
        # restore from the newest published checkpoint
        survivors = max(n - len(dead), 1)   # none left: relaunch locally
        plan = plan_mesh(survivors * devices_per_proc, model_parallel=1)
        n = max(plan.shape[0] // devices_per_proc, 1)
        print(f"[multihost] re-planned mesh {plan.shape} over "
              f"{survivors * devices_per_proc} surviving device(s) -> "
              f"relaunching on {n} process(es) with --resume", flush=True)
        attempt += 1


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="localhost multi-process fleet supervisor "
                    "(spawn, supervise, heal)")
    ap.add_argument("--procs", type=int, default=2,
                    help="worker processes (emulated hosts)")
    ap.add_argument("--devices-per-proc", type=int, default=2,
                    help="fleet slots each worker places on its device "
                         "(REPRO_FLEET_SLOTS)")
    ap.add_argument("--device", default=None,
                    help="the workers' device: cuda (rank r on card r %% the "
                         "card count) or cpu; default: the worker's own "
                         "(cuda)")
    ap.add_argument("--module", default=DEFAULT_MODULE,
                    help="worker module run as `python -m MODULE`")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="shared fleet checkpoint directory (appended to the "
                         "worker args; needed for healing restarts and for "
                         "--kill-at-epoch's trigger)")
    ap.add_argument("--kill-proc", type=int, default=None,
                    help="failure drill: SIGKILL this worker id once the "
                         "checkpoint dir publishes --kill-at-epoch")
    ap.add_argument("--kill-at-epoch", type=int, default=1,
                    help="epoch threshold arming --kill-proc")
    ap.add_argument("--max-restarts", type=int, default=1,
                    help="healing relaunches before giving up")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="per-attempt supervision timeout in seconds")
    ap.add_argument("worker_args", nargs="*",
                    help="arguments after `--` go to the worker module "
                         "(--distributed is appended for the default "
                         "drl_control module)")
    args = ap.parse_args(argv)
    if args.procs < 1:
        ap.error("--procs must be >= 1")
    if args.kill_proc is not None and args.kill_proc >= args.procs:
        ap.error(f"--kill-proc {args.kill_proc} out of range for "
                 f"--procs {args.procs}")
    if args.kill_proc is not None and not args.checkpoint_dir:
        ap.error("--kill-proc needs --checkpoint-dir (the kill triggers on a "
                 "published checkpoint, and recovery resumes from it)")
    worker_args = list(args.worker_args)
    if args.module == DEFAULT_MODULE and "--distributed" not in worker_args:
        worker_args.append("--distributed")
    raise SystemExit(run(
        args.module, worker_args, procs=args.procs,
        devices_per_proc=args.devices_per_proc,
        checkpoint_dir=args.checkpoint_dir, kill_proc=args.kill_proc,
        kill_at_epoch=args.kill_at_epoch, max_restarts=args.max_restarts,
        timeout_s=args.timeout, device=args.device))


if __name__ == "__main__":
    main()
