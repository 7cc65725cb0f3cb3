"""The port's tensor-parallel compute on the ``model`` axis, in gloo worlds
of 2 and 4 on the CPU (``make_production_mesh``: (1, 2) and (1, 4), all
model axis).  The workers are in ``torch_tp_cases.py``, which states the
tolerances; each world has a timeout (``torch_sharded_cases.TIMEOUT_S``).

* yi-34b (7 heads: the attention core repeated on the axis), seamless
  (the encoder and cross-attention) and phi-3-vision (``frontend_embeds``
  joined to the embeddings) smoke configs train 3 steps on the mesh equal
  to one process;
* the tensor-parallel ``_run_attn`` (llama's GQA, yi's 7 heads,
  seamless's cross-attention), ``rwkv6_time_mix`` and the vocab-parallel
  chunked cross-entropy, gathered, equal the reference's functions
  (``repro.models.lm._run_attn``, ``repro.models.ssm.rwkv6_time_mix``,
  ``repro.models.lm.chunked_cross_entropy``) on the same numpy-seeded
  float32 inputs, output and every gradient within 1e-5 of the reference's
  scale (JAX on the CPU, computed here and handed to the workers);
* the flash Function on q cut by heads and k, v whole, sliced to each
  rank's kv heads: its output and the q, k, v gradients equal one
  process's;
* in this process, on ``make_production_mesh``'s (1, 1) mesh (a gloo world
  of one), the tensor-parallel step of every id's float32 smoke config
  equals the unmeshed step bit for bit: loss, gradient norm and every leaf
  of the parameters and moments (the card's phase 30b holds llama3-8b at
  full width so)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_tp_cases as cases  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from torch_sharded_cases import launch  # noqa: E402

pytestmark = pytest.mark.skipif(not torch.distributed.is_available(),
                                reason="needs torch.distributed")
WORLDS = [2, 4]


def _vjp(fn, primals: dict, cot):
    """(fn's output, its gradients by primal name) at the cotangent ``cot``
    (a scalar output's gradient when None)."""
    out, pull = jax.vjp(lambda kw: fn(**kw), jax.tree.map(jnp.asarray, primals))
    (grads,) = pull(jnp.ones_like(out) if cot is None else jnp.asarray(cot))
    return out, grads


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@functools.lru_cache(maxsize=None)
def _references() -> dict:
    """The reference's outputs and gradients for every ``check_functions``
    case, keyed as the worker reads them."""
    from repro.configs import get_config
    from repro.models import lm as jlm
    from repro.models import ssm as jssm

    ref = {}
    for arch in cases.ATTN_ARCHS:
        case = cases.attn_case(arch)
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        positions = jnp.arange(cases.S)[None, :]

        def attn(p, x, memory=None):
            return jlm._run_attn(p, x, cfg, positions, memory=memory)
        primals = {"p": {k: {"w": case[k]} for k in ("wq", "wk", "wv", "wo")}, "x": case["x"]}
        if "memory" in case:
            primals["memory"] = case["memory"]
        out, grads = _vjp(attn, primals, case["cot"])
        ref[f"attn_{arch}/out"] = out
        for k, g in _flat(grads["p"]).items():
            ref[f"attn_{arch}/grad/{k}"] = g
        ref[f"attn_{arch}/grad/x"] = grads["x"]
        if "memory" in case:
            ref[f"attn_{arch}/grad/memory"] = grads["memory"]

    case = cases.rwkv_case()
    hs = get_config("rwkv6-7b", smoke=True).rwkv_head_size
    weights = cases.nest({k: v for k, v in case.items() if k not in ("x", "cot")})
    out, grads = _vjp(lambda p, x: jssm.rwkv6_time_mix(p, x, head_size=hs),
                      {"p": weights, "x": case["x"]}, case["cot"])
    ref["rwkv/out"] = out
    ref["rwkv/grad/x"] = grads["x"]
    for k, g in _flat(grads["p"]).items():
        ref[f"rwkv/grad/{k}"] = g

    case = cases.ce_case()
    out, grads = _vjp(lambda x, table: jlm.chunked_cross_entropy(
        x, table.T, jnp.asarray(case["targets"]), jnp.asarray(case["mask"]),
        chunk=cases.CE["chunk"]), {"x": case["x"], "table": case["table"]}, None)
    ref["ce/out"], ref["ce/grad/x"], ref["ce/grad/table"] = out, grads["x"], grads["table"]
    return {k: np.asarray(v, np.float64) for k, v in ref.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_tensor_parallel_steps_equal_one_process(world):
    outs = launch(cases.script("c.check_train()"), world)
    assert outs[0].count(" ok") == len(cases.TRAIN_ARCHS), outs[0]


@pytest.mark.parametrize("world", WORLDS)
def test_tensor_parallel_functions_equal_the_reference(world, tmp_path):
    path = tmp_path / "reference.npz"
    np.savez(path, **_references())
    outs = launch(cases.script(f"c.check_functions({str(path)!r})"), world)
    assert "functions ok" in outs[0], outs[0]


@pytest.mark.parametrize("world", WORLDS)
def test_kv_slicing_gradients_equal_one_process(world):
    outs = launch(cases.script("c.check_kv_slicing()"), world)
    assert "kv slicing ok" in outs[0], outs[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tensor_parallel_step_on_a_mesh_of_one_is_bit_for_bit(arch):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import tree_leaves
    from torch_lm_cases import warm_train_state

    setup = trainer.TrainSetup(micro_batches=2, learning_rate=1e-2, warmup_steps=2,
                               total_steps=20)
    cfg, state, batch = warm_train_state(arch, setup, 0, seed=0)
    want, m = trainer.make_train_step(cfg, setup)(state, batch)
    mesh = make_production_mesh(device="cpu")
    try:
        got, mm = trainer.make_train_step(cfg, setup, mesh)(
            trainer.shard_train_state(state, ShardingPolicy(mesh, cfg)), batch)
        got = trainer.unshard_train_state(got)
    finally:
        dist.destroy_process_group()
    assert (float(mm["loss"]), float(mm["grad_norm"])) == (float(m["loss"]),
                                                          float(m["grad_norm"]))
    for tree in ("params", "mu", "nu"):
        pick = (lambda s: s.params) if tree == "params" else (  # noqa: E731
            lambda s: getattr(s.opt, tree))
        for a, b in zip(tree_leaves(pick(got)), tree_leaves(pick(want))):
            assert torch.equal(a, b), (arch, tree)
