"""The port's tensor-parallel decode on the ``model`` axis: ``lm.serve_step``
on DTensor parameters and a cache cut over the axis, in gloo worlds of 2
and 4 on the CPU (``make_production_mesh``: (1, 2) and (1, 4), all model
axis).  The workers are in ``torch_tp_decode_cases.py``, which states the
tolerances; each world has a timeout (``torch_sharded_cases.TIMEOUT_S``).

* the float32 smoke configs of llama3-8b (its cache cut by kv heads at 2
  ranks, by positions at 4), yi-34b, qwen2-moe, granite-moe, jamba, rwkv6-7b
  (WKV6 on each rank's heads with its carried state), seamless with a
  memory (``prefill_encoder``) and phi-3-vision, prefilled, take 10 decode
  steps on the mesh equal to one process: greedy tokens, logits and every
  cache leaf gathered;
* the decode attention on a cache cut by positions (a partial softmax
  combined over the axis) and on a whole cache equals the reference's
  ``repro.models.attention.decode_attention`` on the same numpy-seeded
  inputs within 1e-5, at a cache length of 1, one inside a rank's rows, one
  across ranks' rows and the whole cache (JAX on the CPU, computed here and
  handed to the workers);
* in this process, on ``make_production_mesh``'s (1, 1) mesh (a gloo world
  of one), the tensor-parallel step of every id's float32 smoke config
  equals the unmeshed step bit for bit: logits of 10 steps and every cache
  leaf (the card's phase 33a holds llama3-8b and rwkv6-7b at full width
  so)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_tp_decode_cases as cases  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from torch_sharded_cases import launch  # noqa: E402

pytestmark = pytest.mark.skipif(not torch.distributed.is_available(),
                                reason="needs torch.distributed")
WORLDS = [2, 4]


@pytest.mark.parametrize("world", WORLDS)
def test_tensor_parallel_decode_equals_one_process(world):
    outs = launch(cases.script("c.check_decode()"), world)
    assert outs[0].count(" ok:") == len(cases.DECODE_ARCHS), outs[0]


@pytest.mark.parametrize("world", WORLDS)
def test_position_cut_decode_attention_equals_the_reference(world, tmp_path):
    from repro.models import attention as jattn

    case = cases.seqpar_case()
    ref = {f"len{n}": np.asarray(jattn.decode_attention(
        jnp.asarray(case["q"]), jnp.asarray(case["k"]), jnp.asarray(case["v"]), n))
        for n in cases.CACHE_LENS}
    path = tmp_path / "reference.npz"
    np.savez(path, **ref)
    outs = launch(cases.script(f"c.check_seqpar({str(path)!r})"), world)
    assert "seqpar decode ok" in outs[0], outs[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_step_on_a_mesh_of_one_is_bit_for_bit(arch):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import lm
    from repro_torch.sharding import ctx
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import tree_leaves

    cfg, params, cache, tok = cases.prefilled(arch)
    step = lm.serve_step(cfg)
    mesh = make_production_mesh(device="cpu")
    try:
        policy = ShardingPolicy(mesh, cfg)
        placed = policy.distribute(params, policy.params_sharding(params))
        tp_cache = trainer.cache_model_shards(
            policy.distribute(cases.clone(cache), policy.cache_sharding(cache)), mesh)
        for _ in range(cases.STEPS):
            want, cache = step(params, cache, tok)
            with ctx.use_mesh(mesh):
                got, tp_cache = step(placed, tp_cache, tok)
            assert type(got) is torch.Tensor and torch.equal(got, want), arch
            tok = want.argmax(-1, keepdim=True).to(torch.int32)
        for a, b in zip(tree_leaves(cache), tree_leaves(tp_cache)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(b.full_tensor(), a), arch
            else:
                assert a == b, arch
    finally:
        dist.destroy_process_group()
