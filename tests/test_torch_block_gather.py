"""Per-block parameter gathering in the port (``sharding/gather.py``): the
meshed train step, ``lm.prefill_forward`` and ``lm.serve_step`` take the
placed tree and gather one block's data-sharded leaves just before the
block runs, as the reference's rematerialized ``lax.scan`` does.  Imports
nothing of JAX.

* gloo worlds of 4 on the (2, 2) and (4, 1) meshes: the prefill and decode
  of a dense, an MoE, a Mamba-hybrid and an encdec smoke config on the
  placed tree equal one process's (``torch_block_gather_cases``, which
  states the tolerances; each world has ``torch_sharded_cases.TIMEOUT_S``).
  The meshed train step's equality is pinned by
  ``test_torch_sharded_train_world4.py``;
* on a fake (4, 4) world on ``meta`` (``launch.dryrun.trace``), a smoke-width
  dense config at 2 and at 8 blocks: the peak of a prefill and of a decode
  step grows by less than 6 gathered blocks (one block's gathered copy is
  live at a time, not the tree's), no all-gather's result is larger than
  the largest gathered leaf of a block, and the train step's all-gathers
  grow by two a data-sharded block leaf a block and microbatch (the
  forward's gather and the recompute's), the block gathers counted
  ``2 · blocks · microbatches``;
* a dense FFN stacked over a number of blocks the model axis divides
  (stored cut by its block dimension) is never gathered whole over the
  model axis: no all-gather larger than a block's gathered leaf, and the
  recut is one all-to-all a leaf and pass;
* on ``make_production_mesh``'s (1, 1) mesh, the prefill of every id's
  float32 smoke config on the placed tree equals the unmeshed prefill bit
  for bit (logits and K/V taps)."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard

import torch_block_gather_cases as cases
from repro_torch.configs import ARCH_IDS, ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.sharding import gather
from repro_torch.train import trainer
from repro_torch.train.optimizer import tree_leaves
from torch_sharded_cases import launch

pytestmark = pytest.mark.skipif(not dist.is_available(), reason="needs torch.distributed")

SHAPES = {"prefill": ShapeSpec("smoke_prefill", 16, 4, "prefill"),
          "decode": ShapeSpec("smoke_decode", 16, 4, "decode"),
          "train": ShapeSpec("smoke_train", 16, 8, "train")}
SETUP = trainer.TrainSetup(micro_batches=2, learning_rate=1e-4, warmup_steps=1,
                           total_steps=10)
MESH = (4, 4)
DEPTHS = (2, 8)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_serving_on_the_placed_tree_equals_one_process(shape):
    outs = launch(cases.script(f"c.check_serving({shape!r})"), 4)
    assert outs[0].count(" ok:") == len(cases.ARCHS), outs[0]


def _smoke(blocks: int):
    """llama3-8b's float32 smoke widths at ``blocks`` blocks, its kv heads
    those of q (so no attention activation is all-gathered on 4 model
    ranks) and a 64-row vocab (so no leaf outside the blocks is gathered
    larger than a block's)."""
    return dataclasses.replace(get_config("llama3-8b", smoke=True), dtype="float32",
                               num_layers=blocks, num_kv_heads=4, vocab_size=64)


def _trace(kind: str, blocks: int) -> tuple[dict, dict]:
    """(the dry-run of rank 0 of a fake (4, 4) world, the placed ``layers``
    of the same config on that mesh, on ``meta``)."""
    from repro_torch.models import lm
    from repro_torch.sharding.policy import ShardingPolicy

    cfg = _smoke(blocks)
    with dryrun.fake_world(MESH[0] * MESH[1]):
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
        gather.COUNTS["blocks"] = 0
        res = dryrun.trace(cfg, SHAPES[kind], mesh, SETUP if kind == "train" else None)
        res["block_gathers"] = gather.COUNTS["blocks"]
        policy = ShardingPolicy(mesh, cfg)
        params = lm.init_params(cfg, None, "meta")
        placed = policy.distribute(params, policy.params_sharding(params))["layers"]
        layers = {"leaves": [(x.shape, x.dtype, tuple(x.placements))
                             for x in tree_leaves(placed)]}
    return res, layers


def _gathered(layers: dict, blocks: int) -> list[int]:
    """Each block leaf's bytes gathered over the data axes: the block's
    share of the leaf, cut by the model axis where the leaf is."""
    out = []
    for shape, dtype, pls in layers["leaves"]:
        whole = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size() // blocks
        out.append(whole // MESH[1] if isinstance(pls[1], Shard) else whole)
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_one_gathered_block_is_live_at_a_time(kind):
    res = {n: _trace(kind, n) for n in DEPTHS}
    block = sum(_gathered(res[2][1], 2))
    largest = max(_gathered(res[2][1], 2))
    grown = res[8][0]["memory"]["peak_bytes_est"] - res[2][0]["memory"]["peak_bytes_est"]
    assert grown < (DEPTHS[1] - DEPTHS[0]) * block, (grown, block)
    for n in DEPTHS:
        r = res[n][0]
        assert r["block_gathers"] == n, (n, r["block_gathers"])
        assert r["collectives"]["all-gather"]["largest_bytes"] <= largest, (n, r["collectives"])


def test_training_gathers_each_block_twice_a_microbatch():
    res = {n: _trace("train", n) for n in DEPTHS}
    micro = SETUP.micro_batches
    for n in DEPTHS:
        r, layers = res[n]
        assert r["block_gathers"] == 2 * n * micro, (n, r["block_gathers"])
        assert r["collectives"]["all-gather"]["largest_bytes"] <= max(_gathered(layers, n))
    # each block leaf stored cut over the data axis is one all-gather a gather
    cut = sum(isinstance(pls[0], Shard) for _, _, pls in res[2][1]["leaves"])
    assert cut == sum(isinstance(pls[0], Shard) for _, _, pls in res[8][1]["leaves"])
    grown = (res[8][0]["collectives"]["all-gather"]["count"]
             - res[2][0]["collectives"]["all-gather"]["count"])
    assert grown == 2 * (DEPTHS[1] - DEPTHS[0]) * micro * cut, (grown, cut)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_a_block_cut_dense_ffn_is_never_gathered_whole(kind):
    r, layers = _trace(kind, 8)
    ffn = [pls for shape, _, pls in layers["leaves"] if len(shape) == 3 and pls[1] == Shard(0)]
    assert len(ffn) == 3, layers           # gate, up and down, cut by blocks
    assert r["collectives"]["all-gather"]["largest_bytes"] <= max(_gathered(layers, 8))
    passes = 2 * SETUP.micro_batches if kind == "train" else 1
    assert r["collectives"]["all-to-all"]["count"] == 3 * passes, r["collectives"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_on_a_mesh_of_one_is_bit_for_bit(arch):
    from torch_lm_cases import frontend_inputs, smoke_lm

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import lm
    from repro_torch.sharding import ctx
    from repro_torch.sharding.policy import ShardingPolicy

    cfg, params = smoke_lm(arch, 0)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 8)).astype(np.int32))}
    batch.update({k: torch.from_numpy(v) for k, v in frontend_inputs(
        cfg, 2, 4, enc_len=12).items()})
    want, want_kv = lm.prefill_forward(cfg)(params, batch)
    mesh = make_production_mesh(device="cpu")
    try:
        policy = ShardingPolicy(mesh, cfg)
        placed = policy.distribute(params, policy.params_sharding(params))
        with ctx.use_mesh(mesh):
            got, got_kv = lm.prefill_forward(cfg)(placed, batch)
    finally:
        dist.destroy_process_group()
    assert type(got) is torch.Tensor and torch.equal(got, want), arch
    for name, kv in want_kv.items():
        for kk, w in kv.items():
            assert torch.equal(got_kv[name][kk], w), (arch, name, kk)
