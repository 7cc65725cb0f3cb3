"""Gloo worlds for the port's meshed LM train step (``trainer.make_train_step(
..., mesh=)``), shared by ``test_torch_sharded_train.py`` and
``test_torch_sharded_train_world4.py``.  Imports nothing of JAX.

``launch(script, n)`` runs ``script`` as ``n`` localhost workers joined
through ``repro_torch.launch.mesh.init_distributed`` (``torch.distributed``
on gloo), each on the CPU; every rank must exit 0 and print ``MH_OK``.
``check_mesh`` is what a worker runs on one mesh: against the one-process
step of the same state and batches, for a float32 smoke config of each
family in ``ARCHS`` (a dense, an MoE and an RWKV id):

* without compression, 3 steps chained on each side: the loss and the
  gradient norm within ``REL`` (1e-5) relative, every leaf of the
  parameters and both moments within ``LEAF`` (2e-5) of its largest
  magnitude.  The mesh sums a microbatch's gradient over its ranks' rows
  and a leaf's square norm over its shards in another order than one
  process does, so float32 differences of ~1e-7 are expected and grow
  with the steps;
* with int8 error feedback, each of 3 steps from the one-process state:
  rounding to int8 is discontinuous, and a difference of ~1e-7 moves an
  element across a rounding half-step about once in 10^5 elements.  Such
  an element's residual differs by one whole quantum (the leaf's scale,
  ``max|g + r| / 127``), and its parameter and moments by what Adam makes
  of it.  So: the loss and norm within ``REL``; every residual element
  within 1e-2 of a quantum of the one-process residual or a whole quantum
  (±5%) from it, those flips at most 1 in 10^3 elements of the tree; every
  other element of the parameters and moments within ``LEAF``;
* each rank's parameters, moments and residuals hold exactly its policy
  shard of the state (the bytes of the full leaf cut by the placements,
  major first), and no more bytes."""
import os
import subprocess
import sys

import torch

from repro_torch.launch.multihost import free_port, worker_env

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "src")
TIMEOUT_S = 240
ARCHS = ("llama3-8b", "granite-moe-3b-a800m", "rwkv6-7b")
REL = 1e-5
LEAF = 2e-5
STEPS = 3


def launch(script: str, n_procs: int) -> list[str]:
    """Run ``script`` as ``n_procs`` coordinated workers (one slot each);
    every rank must exit 0 and print MH_OK.  Returns their outputs."""
    coordinator = f"127.0.0.1:{free_port()}"
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join([_SRC, _HERE, base.get("PYTHONPATH", "")])
    base["OMP_NUM_THREADS"] = "1"          # N workers share the host's cores
    procs = [subprocess.Popen(
        [sys.executable, "-c", script],
        env=worker_env(base, coordinator, n_procs, pid, 1),
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


def mesh_script(shape, names) -> str:
    """The worker of one mesh: ``check_mesh`` on a ``DeviceMesh`` of
    ``shape`` over ``names`` (None: ``make_production_mesh``'s)."""
    return (
        "from repro_torch.launch.mesh import init_distributed\n"
        "init_distributed()\n"
        "import torch_sharded_cases as c\n"
        f"c.check_mesh({shape!r}, {names!r})\n"
        "print('MH_OK')\n")


def policy_slice(full: torch.Tensor, pls, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under the placements ``pls``: each mesh
    dimension that shards tensor dimension d cuts it into equal blocks and
    keeps the block of this rank's coordinate, in mesh order."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            n = full.shape[pl.dim] // mesh.size(i)
            full = full.narrow(pl.dim, coord[i] * n, n)
    return full


def _state_leaves(state):
    from repro_torch.train.optimizer import tree_leaves
    return {"params": tree_leaves(state.params), "mu": tree_leaves(state.opt.mu),
            "nu": tree_leaves(state.opt.nu), "ef": tree_leaves(state.ef_residual)}


def check_shards(sharded, full, mesh) -> None:
    """Each rank holds exactly its policy shard of every leaf."""
    got, want = _state_leaves(sharded), _state_leaves(full)
    for kind in got:
        held = sum(x.to_local().nbytes for x in got[kind])
        expect = 0
        for x, w in zip(got[kind], want[kind]):
            part = policy_slice(w, x.placements, mesh)
            assert torch.equal(x.to_local(), part), kind
            expect += part.nbytes
        assert held == expect, (kind, held, expect)


def _max(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def _close(a: float, b: float, what: str) -> None:
    assert abs(a - b) <= REL * abs(b), f"{what}: {a} vs {b}"


def check_steps_chained(cfg, setup, state, batches, mesh, leaf: float = LEAF,
                        update: float = 0.0) -> None:
    """``batches`` chained on each side; every leaf of the moments within
    ``leaf`` of its largest magnitude, of the parameters within that plus
    ``update`` of the learning rate (a part of one Adam step: where a
    gradient element is rounding-sized, ``m / sqrt(v)`` is a ratio of two
    rounding-sized numbers)."""
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer

    sharded = trainer.shard_train_state(state, ShardingPolicy(mesh, cfg))
    check_shards(sharded, state, mesh)
    step = trainer.make_train_step(cfg, setup)
    mstep = trainer.make_train_step(cfg, setup, mesh)
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        sharded, mm = mstep(sharded, batch)
        for key in ("loss", "grad_norm"):
            _close(float(mm[key]), float(m[key]), f"{cfg.name} step {i} {key}")
        whole = _state_leaves(trainer.unshard_train_state(sharded))
        for kind, leaves in _state_leaves(state).items():
            slack = update * setup.learning_rate if kind == "params" else 0.0
            for a, b in zip(whole[kind], leaves):
                err = float((a - b).abs().max())
                assert err <= leaf * float(b.abs().max()) + slack, (cfg.name, i, kind, err)
    check_shards(sharded, trainer.unshard_train_state(sharded), mesh)


def check_steps_compressed(cfg, setup, state, batches, mesh) -> int:
    """Returns the int8 flips seen."""
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer

    policy = ShardingPolicy(mesh, cfg)
    step = trainer.make_train_step(cfg, setup)
    mstep = trainer.make_train_step(cfg, setup, mesh)
    flips = total = 0
    for i, batch in enumerate(batches):
        sharded = trainer.shard_train_state(state, policy)
        check_shards(sharded, state, mesh)
        new, m = step(state, batch)
        snew, mm = mstep(sharded, batch)
        for key in ("loss", "grad_norm"):
            _close(float(mm[key]), float(m[key]), f"{cfg.name} step {i} {key}")
        got, want = _state_leaves(trainer.unshard_train_state(snew)), _state_leaves(new)
        for j, (r_got, r_want) in enumerate(zip(got["ef"], want["ef"])):
            quantum = 2 * float(r_want.float().abs().max())
            dev = (r_got.float() - r_want.float()).abs() / max(quantum, 1e-30)
            flip = dev > 0.5
            assert _max(dev[~flip]) <= 1e-2, (cfg.name, i, j)
            assert bool(((dev[flip] - 1).abs() <= 0.05).all()), (cfg.name, i, j)
            flips += int(flip.sum())
            total += flip.numel()
            for kind in ("params", "mu", "nu"):
                a, b = got[kind][j], want[kind][j]
                err = _max((a - b).abs()[~flip])
                assert err <= LEAF * float(b.abs().max()), (cfg.name, i, kind, err)
        state = new
    assert flips <= total / 1000, (cfg.name, flips, total)
    return flips


def check_mesh(shape, names) -> None:
    """Every ``ARCHS`` id on one mesh, with and without compression."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_production_mesh, process_index
    from repro_torch.train import trainer
    from torch_lm_cases import train_batch, warm_train_state

    mesh = (make_production_mesh(device="cpu") if shape is None
            else init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names)))
    for arch in ARCHS:
        for compress in (False, True):
            setup = trainer.TrainSetup(micro_batches=2, learning_rate=1e-2, warmup_steps=2,
                                       total_steps=20, compress_grads=compress)
            cfg, state, _ = warm_train_state(arch, setup, 2, seed=0)
            batches = [{k: torch.from_numpy(v)
                        for k, v in train_batch(cfg, 4, 16, seed=10 + i).items()}
                       for i in range(STEPS)]
            if compress:
                flips = check_steps_compressed(cfg, setup, state, batches, mesh)
            else:
                check_steps_chained(cfg, setup, state, batches, mesh)
            if process_index() == 0:
                print(f"{arch} {tuple(mesh.shape)} compress={compress} ok"
                      + (f" ({flips} int8 flips)" if compress else ""), flush=True)
