"""The port's LM train step over a (data, model) mesh of processes, in gloo
worlds of 2 on the CPU (``trainer.shard_train_state``, ``make_train_step(
..., mesh=)``, ``launch.train.run_training(..., mesh=)``).  Worlds of 4 are
in ``test_torch_sharded_train_world4.py``; the checks themselves, and
their tolerances, in ``torch_sharded_cases.py``.

* on a (2, 1) mesh (the batch cut over ``data``, every parameter sharded
  over it where it divides) and on ``make_production_mesh``'s (1, 2) (all
  model axis, the batch replicated), a dense, an MoE and an RWKV smoke
  config train 3 steps equal to one process's, with and without int8
  error feedback, each rank holding only its shards;
* a checkpoint written by a 2-process meshed run (gathered, by rank 0, in
  the unmeshed layout) resumes in one process equal to the uninterrupted
  run; the launcher's ``--mesh production`` runs over the two processes.

Each world has a timeout (``torch_sharded_cases.TIMEOUT_S``)."""
import dataclasses
import textwrap

import numpy as np
import pytest
import torch

from torch_sharded_cases import LEAF, launch, mesh_script

pytestmark = pytest.mark.skipif(not torch.distributed.is_available(),
                                reason="needs torch.distributed")


@pytest.mark.parametrize("shape,names", [((2, 1), ("data", "model")), (None, None)],
                         ids=["data2", "production_1x2"])
def test_meshed_steps_equal_one_process_world2(shape, names):
    outs = launch(mesh_script(shape, names), 2)
    assert outs[0].count(" ok") == 6, outs[0]


_CKPT = textwrap.dedent("""
    from repro_torch.launch.mesh import init_distributed
    rank, world = init_distributed()
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.train.trainer import TrainSetup
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True), dtype="float32")
    setup = TrainSetup(micro_batches=2, learning_rate=1e-3, warmup_steps=1,
                       total_steps=4)
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    whole = train.run_training(cfg, setup, 4, 4, 16, ckpt_dir=WHOLE, ckpt_every=4,
                               mesh=mesh, device="cpu")
    part = train.run_training(cfg, setup, 2, 4, 16, ckpt_dir=PART, ckpt_every=2,
                              mesh=mesh, device="cpu")
    print("WHOLE", *whole["losses"])
    print("PART", *part["losses"])
    train.main(["--device", "cpu", "--mesh", "production", "--arch", "llama3-8b",
                "--smoke", "--steps", "2", "--batch", "4", "--seq", "16"])
    print("MH_OK")
""")


def _losses(out: str, tag: str) -> list[float]:
    line = next(x for x in out.splitlines() if x.startswith(tag + " "))
    return [float(x) for x in line.split()[1:]]


def test_checkpoint_saved_at_world_2_resumes_at_world_1(tmp_path):
    """A 2-process float32 run on a (2, 1) mesh saves at step 2 (gathered,
    rank 0);
    one process resumes it unmeshed to step 4, equal to the 2-process run
    that went on uninterrupted (its losses within 1e-5, its parameters at
    step 4, saved the same way, within ``LEAF`` of each leaf's scale).  The
    launcher's ``--mesh production`` runs over the same two processes
    (plan_mesh(2): (1, 2)), only rank 0 printing."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import TrainSetup, init_train_state

    whole_dir, part_dir = tmp_path / "whole", tmp_path / "part"
    outs = launch(_CKPT.replace("WHOLE,", f"{str(whole_dir)!r},").replace(
        "PART,", f"{str(part_dir)!r},"), 2)
    assert "final loss" in outs[0] and "final loss" not in outs[1]
    assert "mesh {'data': 1, 'model': 2} over 2 process(es)" in outs[0]
    assert Checkpointer(part_dir).all_steps() == [2]
    whole = _losses(outs[0], "WHOLE")
    assert _losses(outs[0], "PART") == whole[:2] == _losses(outs[1], "WHOLE")[:2]

    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True), dtype="float32")
    setup = TrainSetup(micro_batches=2, learning_rate=1e-3, warmup_steps=1, total_steps=4)
    resumed = train.run_training(cfg, setup, 4, 4, 16, ckpt_dir=str(part_dir), device="cpu")
    assert resumed["start_step"] == 2 and int(resumed["state"].step) == 4
    np.testing.assert_allclose(resumed["losses"], whole[2:], rtol=1e-5)
    want = Checkpointer(whole_dir).restore(
        init_train_state(cfg, setup, torch.Generator().manual_seed(0), "cpu"))
    for a, b in zip(tree_leaves(resumed["state"].params), tree_leaves(want.params)):
        assert float((a - b).abs().max()) <= LEAF * float(b.abs().max())
