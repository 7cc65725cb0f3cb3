"""Gloo workers for the port's tensor-parallel decode on the ``model`` axis
(``tests/test_torch_tp_decode.py``).  Imports nothing of JAX: the
reference's answers are computed by the test in its own process and handed
over in an ``.npz``.

* ``check_decode``: on ``make_production_mesh``'s all-model mesh of the
  world ((1, 2) or (1, 4)), each of ``DECODE_ARCHS``' float32 smoke configs
  is prefilled through the unmeshed step (``PROMPT`` tokens, and seamless's
  memory through ``lm.prefill_encoder``), then takes ``STEPS`` decode steps
  on the mesh: the parameters placed by the policy (the step gathers each
  block over the data axes as it runs, ``sharding.gather``), the cache placed by
  ``policy.cache_sharding`` and rewrapped on the model sub-mesh
  (``trainer.cache_model_shards``).  Each step is held to the unmeshed step
  on the same tokens (the unmeshed run's greedy ones): the greedy tokens
  equal, the logits within ``LOGITS`` of their largest magnitude, and
  after the last step every cache leaf, gathered, within ``CACHE`` of its
  largest magnitude.  At 2 ranks llama3-8b's cache is cut by kv heads, at 4
  by positions (2 kv heads), and every rank past the filled rows adds
  nothing;
* ``check_seqpar``: ``attention.decode_attention`` on a cache cut by
  positions (``Shard(1)``) and on a whole one (``Replicate()``), q
  ``Shard(2)`` over the heads, at ``CACHE_LENS``, gathered, within ``REL``
  of the reference's ``decode_attention`` (its largest magnitude).

The tolerances: the row-parallel products and the partial softmax sum in
another order than one process does, so a float32 result differs from one
process's by a few 1e-7 of its scale, more the deeper a layer sits, and
not growing with the steps.  Measured over the 10 steps at 2 and 4 ranks:
the logits within 1.7e-6 of their scale, the K/V rows and RWKV states
within 1.0e-6, jamba's Mamba states (the last of 8 smoke layers, each a
recurrence over the step) within 2.4e-6.  So ``LOGITS`` 1e-5 and ``CACHE``
5e-6."""
import numpy as np
import torch

DECODE_ARCHS = ("llama3-8b", "yi-34b", "qwen2-moe-a2.7b", "granite-moe-3b-a800m",
                "jamba-1.5-large-398b", "rwkv6-7b", "seamless-m4t-medium",
                "phi-3-vision-4.2b")
B, SMAX, PROMPT, STEPS, ENC_LEN = 4, 32, 5, 10, 12
LOGITS = 1e-5
CACHE = 5e-6
REL = 1e-5
# the position-cut attention's case: GQA, 8 q heads on 2 kv heads, the
# cache cut by positions (or whole) whatever the head counts
SEQ = dict(B=2, H=8, Hkv=2, hd=16, Smax=32)
# 1, a length inside rank 0's rows, one across ranks' rows, every row
CACHE_LENS = (1, 3, 13, 32)


def seqpar_case(seed: int = 4) -> dict:
    """q ``[B, 1, H, hd]`` and a k/v cache ``[B, Smax, Hkv, hd]`` drawn from
    one numpy seed."""
    c = SEQ
    rng = np.random.default_rng(seed)
    return {"q": rng.normal(size=(c["B"], 1, c["H"], c["hd"])).astype(np.float32),
            "k": rng.normal(size=(c["B"], c["Smax"], c["Hkv"], c["hd"])).astype(np.float32),
            "v": rng.normal(size=(c["B"], c["Smax"], c["Hkv"], c["hd"])).astype(np.float32)}


def _mesh():
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(device="cpu")


def clone(tree):
    """A copy of a cache's tensors (a mesh of one would share them)."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _rel(what: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    assert err <= tol * scale, f"{what}: {err} against a scale of {scale} (tolerance {tol})"
    return err / scale if scale else 0.0


def prefilled(arch: str, seed: int = 0):
    """(float32 smoke config, its CPU parameters, a cache of ``SMAX`` rows
    holding ``PROMPT`` seeded tokens stepped through the unmeshed step (and
    seamless's memory of ``ENC_LEN`` frames), the last prompt token)."""
    from repro_torch.models import lm
    from torch_lm_cases import frontend_inputs, smoke_lm

    cfg, params = smoke_lm(arch, seed)
    cache = lm.init_cache(cfg, B, SMAX, "cpu", enc_len=ENC_LEN if cfg.encoder_layers else 0)
    if cfg.encoder_layers:
        frames = frontend_inputs(cfg, B, seed + 1, enc_len=ENC_LEN)["frames"]
        cache = lm.prefill_encoder(cfg, params, cache, torch.from_numpy(frames))
    rng = np.random.default_rng(seed + 2)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, PROMPT)).astype(np.int32))
    step = lm.serve_step(cfg)
    for t in range(PROMPT):
        _, cache = step(params, cache, prompt[:, t:t + 1])
    return cfg, params, cache, prompt[:, -1:]


def check_decode() -> None:
    """Every case of ``check_decode`` in the module docstring."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.models import lm
    from repro_torch.sharding import ctx
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import tree_leaves

    mesh = _mesh()
    n = dist.get_world_size()
    for arch in DECODE_ARCHS:
        cfg, params, cache, tok = prefilled(arch)
        policy = ShardingPolicy(mesh, cfg)
        placed = policy.distribute(params, policy.params_sharding(params))
        tp_cache = trainer.cache_model_shards(
            policy.distribute(clone(cache), policy.cache_sharding(cache)), mesh)
        rows, cut = trainer._local_rows(policy, B)
        step = lm.serve_step(cfg)
        worst = 0.0
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
        assert tp_cache["len"] == cache["len"] == PROMPT + STEPS
        cut_by = set()
        for a, b in zip(tree_leaves(cache), tree_leaves(tp_cache)):
            if not isinstance(a, torch.Tensor):
                continue
            cut_by.add(str(b.placements[0]))
            worst = max(worst, _rel(f"{arch} cache leaf", b.full_tensor(), a, CACHE))
        if "k" in tp_cache.get("pos0", {}) and arch == "llama3-8b":
            want_pl = Shard(3) if cfg.num_kv_heads % n == 0 else Shard(2)
            assert tp_cache["pos0"]["k"].placements == (want_pl,), tp_cache["pos0"]["k"]
        if dist.get_rank() == 0:
            print(f"{arch} decode {tuple(mesh.shape)} ok: cache {sorted(cut_by)}, worst "
                  f"{worst:.3g} of the scale", flush=True)


def check_seqpar(ref_path: str) -> None:
    """``check_seqpar`` of the module docstring; the reference's outputs in
    ``ref_path`` keyed ``len<cache_len>``."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import attention as attn

    ref = np.load(ref_path)
    tp = _mesh()["model"]
    case = {k: torch.from_numpy(v) for k, v in seqpar_case().items()}
    q = distribute_tensor(case["q"], tp, [Shard(2)])
    worst = 0.0
    for route in (Shard(1), Replicate()):
        kc, vc = (distribute_tensor(case[name], tp, [route]) for name in ("k", "v"))
        for n in CACHE_LENS:
            out = attn.decode_attention(q, kc, vc, n)
            assert out.placements == (Shard(2),) or route == Replicate(), out.placements
            worst = max(worst, _rel(f"{route} decode attention at cache_len {n}",
                                    out.full_tensor(), torch.from_numpy(ref[f"len{n}"]), REL))
    if dist.get_rank() == 0:
        print(f"seqpar decode ok over {dist.get_world_size()} ranks: worst {worst:.3g}",
              flush=True)


def script(body: str) -> str:
    """A worker: join the gloo world, run ``body`` (this module as ``c``),
    print MH_OK."""
    return ("from repro_torch.launch.mesh import init_distributed\n"
            "init_distributed()\n"
            "import torch_tp_decode_cases as c\n"
            f"{body}\n"
            "print('MH_OK')\n")
