"""The port's meshed LM train step in gloo worlds of 4 on the CPU: the
(2, 2), (4, 1) and (pod, data, model) = (2, 1, 2) meshes, and
``make_production_mesh``'s (1, 4) (``plan_mesh(4)``: all model axis).  A
dense, an MoE and an RWKV smoke config train 3 steps equal to one
process's, with and without int8 error feedback, each rank holding only
its shards (``torch_sharded_cases.check_mesh``, whose docstring states the
tolerances).  Each world has a timeout."""
import pytest
import torch

from torch_sharded_cases import launch, mesh_script

pytestmark = pytest.mark.skipif(not torch.distributed.is_available(),
                                reason="needs torch.distributed")


@pytest.mark.parametrize("shape,names", [
    ((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
    ((2, 1, 2), ("pod", "data", "model")), (None, None)],
    ids=["data2_model2", "data4", "pod2_data1_model2", "production_1x4"])
def test_meshed_steps_equal_one_process_world4(shape, names):
    outs = launch(mesh_script(shape, names), 4)
    assert outs[0].count(" ok") == 6, outs[0]
