"""Gloo workers for the port's per-block parameter gathering
(``tests/test_torch_block_gather.py``).  Imports nothing of JAX.

``check_serving(shape)``: on a ``DeviceMesh`` of ``shape`` over ("data",
"model") ((2, 2) or (4, 1)), each of ``ARCHS``' float32 smoke configs runs
``lm.prefill_forward`` and ``lm.serve_step`` on its parameters placed by
the policy (``policy.distribute``: each rank holds only its shards, and the
model gathers one block's at a time, ``gather.BlockShards``), under
``ctx.use_mesh`` and ``ctx.cut_batch`` with this rank's rows, against the
unmeshed functions on the same parameters:

* the prefill of ``PREFILL`` tokens (seamless's over ``ENC_LEN`` frames of
  memory): the last logits of the rank's rows within ``LOGITS`` of their
  largest magnitude, every K/V tap within ``CACHE``;
* ``STEPS`` decode steps from the cache of ``torch_tp_decode_cases.
  prefilled``, placed by ``policy.cache_sharding`` and rewrapped
  (``trainer.cache_model_shards``): the greedy tokens equal, the logits
  within ``LOGITS``, every cache leaf's part on the rank after the last
  step within ``CACHE`` of the whole leaf's largest magnitude.

On (2, 2) llama3-8b's smoke FFN (2 blocks) is stored cut by its block
dimension on the model axis and recut before its blocks are gathered
(``gather._recut_blocks``): its d_ff columns then interleave over the data
ranks, alike in ``gate``, ``up`` and ``down``.  The tolerances are
``torch_tp_decode_cases``': the gathered blocks' products sum in another
order than one process's, so a float32 result differs by a few 1e-7 of its
scale."""
import numpy as np
import torch

from torch_tp_decode_cases import B, CACHE, ENC_LEN, LOGITS, _rel, clone, prefilled

ARCHS = ("llama3-8b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b", "seamless-m4t-medium")
PREFILL, STEPS = 8, 6


def _batch(cfg, seed: int) -> dict:
    from torch_lm_cases import frontend_inputs

    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (B, PREFILL)).astype(np.int32))}
    if cfg.encoder_layers:
        frames = frontend_inputs(cfg, B, seed + 1, enc_len=ENC_LEN)["frames"]
        batch["frames"] = torch.from_numpy(frames)
    return batch


def check_serving(shape) -> None:
    """``check_serving`` of the module docstring on a mesh of ``shape``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.models import lm
    from repro_torch.sharding import ctx
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import tree_leaves

    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=("data", "model"))
    for arch in ARCHS:
        cfg, params, cache, tok = prefilled(arch)
        policy = ShardingPolicy(mesh, cfg)
        placed = policy.distribute(params, policy.params_sharding(params))
        rows, cut = trainer._local_rows(policy, B)
        worst = 0.0

        batch = _batch(cfg, 7)
        want, want_kv = lm.prefill_forward(cfg)(params, batch)
        mine = {k: v[rows] for k, v in batch.items()}
        with ctx.use_mesh(mesh), ctx.cut_batch(cut):
            got, got_kv = lm.prefill_forward(cfg)(placed, mine)
        assert type(got) is torch.Tensor and got.shape == want[rows].shape, arch
        worst = max(worst, _rel(f"{arch} prefill logits", got, want[rows], LOGITS))
        assert got_kv.keys() == want_kv.keys(), arch
        for name, kv in want_kv.items():
            for kk, w in kv.items():
                worst = max(worst, _rel(f"{arch} prefill {name}/{kk}", got_kv[name][kk],
                                        w[:, rows], CACHE))

        tp_cache = trainer.cache_model_shards(
            policy.distribute(clone(cache), policy.cache_sharding(cache)), mesh)
        step = lm.serve_step(cfg)
        for i in range(STEPS):
            want, cache = step(params, cache, tok)
            with ctx.use_mesh(mesh), ctx.cut_batch(cut):
                got, tp_cache = step(placed, tp_cache, tok[rows])
            assert not isinstance(got, DTensor) and got.shape == want[rows].shape
            worst = max(worst, _rel(f"{arch} step {i} logits", got, want[rows], LOGITS))
            greedy = want.argmax(-1, keepdim=True).to(torch.int32)
            assert torch.equal(got.argmax(-1, keepdim=True).to(torch.int32), greedy[rows]), \
                f"{arch} step {i}: greedy tokens differ"
            tok = greedy
        for a, b in zip(tree_leaves(cache), tree_leaves(tp_cache)):
            if isinstance(a, torch.Tensor):
                err = float((b.to_local().double() - _rows_of(a, b, rows).double()).abs().max())
                scale = float(a.double().abs().max())      # the whole leaf's
                assert err <= CACHE * scale, f"{arch} cache leaf: {err} against {scale}"
                worst = max(worst, err / scale if scale else 0.0)
        if dist.get_rank() == 0:
            print(f"{arch} serving {tuple(mesh.shape)} ok: worst {worst:.3g} of the scale",
                  flush=True)


def _rows_of(full: torch.Tensor, held, rows) -> torch.Tensor:
    """The part of the unmeshed cache leaf ``full`` ``[nb, B, ...]`` that
    ``held`` (a leaf of the rewrapped cache) holds on this rank: its rows,
    then its model-axis shard."""
    from torch.distributed.tensor import Shard

    part = full[:, rows]
    pl = held.placements[0]
    if isinstance(pl, Shard):
        mesh = held.device_mesh
        n = part.shape[pl.dim] // mesh.size()
        part = part.narrow(pl.dim, mesh.get_local_rank() * n, n)
    return part


def script(body: str) -> str:
    """A worker: join the gloo world, run ``body`` (this module as ``c``),
    print MH_OK."""
    return ("from repro_torch.launch.mesh import init_distributed\n"
            "init_distributed()\n"
            "import torch_block_gather_cases as c\n"
            f"{body}\n"
            "print('MH_OK')\n")
