"""Gloo workers for the port's tensor-parallel compute on the ``model`` axis
(``tests/test_torch_tensor_parallel.py``).  Imports nothing of JAX: the
reference's answers are computed by the test in its own process and handed
over in an ``.npz``.

* ``check_train``: on ``make_production_mesh``'s all-model mesh of the
  world ((1, 2) or (1, 4)), the ``TRAIN_ARCHS`` smoke configs train 3
  steps equal to one process (``torch_sharded_cases.check_steps_chained``
  and its tolerances): yi-34b's 7 heads (the attention core repeated),
  seamless's encoder and cross-attention, phi-3-vision's
  ``frontend_embeds``;
* ``check_functions``: ``lm._run_attn`` (llama's GQA, yi's 7 heads,
  seamless's cross-attention), ``ssm.rwkv6_time_mix`` and the
  vocab-parallel ``lm.chunked_cross_entropy`` on DTensor parameters cut by
  the policy and gathered over the data axes only
  (``trainer.gather_model_shards``): each output and gradient gathered
  whole, and rank 0 holds them to the reference's within ``REL`` of the
  reference's largest magnitude;
* ``check_kv_slicing``: the flash kernel's Function on q cut by heads and
  k, v whole (their heads the axis does not divide, so each rank slices
  its own): the output and the q, k, v gradients, gathered, equal one
  process's within ``REL``."""
import dataclasses

import numpy as np
import torch

REL = 1e-5
TRAIN_ARCHS = ("yi-34b", "seamless-m4t-medium", "phi-3-vision-4.2b")
ATTN_ARCHS = ("llama3-8b", "yi-34b", "seamless-m4t-medium")
B, S = 2, 16
CE = dict(B=2, S=48, d=64, V=512, chunk=16)
# The row-parallel products sum their partials in another order than one
# process does, so a gradient differs from one process's by ~1e-6 of its
# leaf's largest element (seamless's smoke step, measured).  Adam makes the
# relative error of an element whose gradient is that small the relative
# error of its whole update, lr-sized: at 1e-2 (``check_mesh``'s rate) one
# seamless embedding element moves 6.1e-6 off at 2 ranks, against
# ``LEAF``'s 1.9e-6.  At 1e-3 every update is a tenth as large and the
# worst element sits inside ``LEAF``.
TRAIN_LR = 1e-3
RWKV_TIME_MIX = ("mu", "w_base", "w_lora1", "w_lora2", "Wr", "Wk", "Wv", "Wg", "u", "Wo",
                 "ln_x")


def attn_case(arch: str, seed: int = 0) -> dict:
    """The float32 smoke config's attention weights ``[d_in, d_out]`` and an
    input ``x`` (and, for an encdec, a ``memory`` as long: the reference
    reads only its first S rows, ROADMAP C10), and the output's cotangent,
    drawn from one numpy seed."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(seed)
    draw = lambda *s: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)  # noqa: E731
    case = {"wq": draw(d, h * hd), "wk": draw(d, hkv * hd), "wv": draw(d, hkv * hd),
            "wo": draw(h * hd, d), "x": rng.normal(size=(B, S, d)).astype(np.float32),
            "cot": rng.normal(size=(B, S, d)).astype(np.float32)}
    if cfg.encoder_layers:
        case["memory"] = rng.normal(size=(B, S, d)).astype(np.float32)
    return case


def rwkv_case(seed: int = 1) -> dict:
    """rwkv6-7b's float32 smoke time-mix weights (the port's init, ``u``
    drawn at 0.5) flat by path, an input and the output's cotangent."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config("rwkv6-7b", smoke=True)
    p = ssm.rwkv6_init(torch.Generator().manual_seed(seed), cfg.d_model, cfg.d_ff,
                       cfg.rwkv_head_size, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    p["u"] = torch.from_numpy((rng.normal(size=tuple(p["u"].shape)) * 0.5).astype(np.float32))
    case = {}
    for k in RWKV_TIME_MIX:
        if isinstance(p[k], dict):
            case.update({f"{k}/{kk}": v.numpy() for kk, v in p[k].items()})
        else:
            case[k] = p[k].numpy()
    case["x"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    case["cot"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return case


def ce_case(seed: int = 2) -> dict:
    """A final hidden ``x [B, S, d]``, a tied table ``[V, d]``, targets and a
    mask with a masked share, from one numpy seed."""
    c = CE
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(c["B"], c["S"], c["d"])).astype(np.float32),
            "table": (rng.normal(size=(c["V"], c["d"])) * 0.5).astype(np.float32),
            "targets": rng.integers(0, c["V"], (c["B"], c["S"])).astype(np.int32),
            "mask": (rng.random((c["B"], c["S"])) > 0.2).astype(np.float32)}


def nest(flat: dict) -> dict:
    """``{"a/b": x}`` → ``{"a": {"b": x}}``."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _mesh():
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(device="cpu")


def _placed(flat: dict, root: str, mesh) -> tuple[dict, list]:
    """``flat`` (path -> numpy) as the tensor-parallel blocks take it: each
    leaf a DTensor on ``mesh`` by the policy's spec of ``root/path`` (the
    leaves of the gradient), then gathered over the data axes
    (``gather_model_shards``).  Returns (the blocks' tree under ``root``,
    the leaves in ``flat``'s order)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.policy import ShardingPolicy, placements
    from repro_torch.train import trainer

    policy = ShardingPolicy(mesh, None)
    leaves = [distribute_tensor(torch.from_numpy(v), mesh, placements(
        mesh, policy.param_spec(f"{root}/{k}", v.shape))).requires_grad_()
        for k, v in flat.items()]
    tree = nest({f"{root}/{k}": x for k, x in zip(flat, leaves)})
    return trainer.gather_model_shards(tree, mesh)[root], leaves


def _check(what: str, got: torch.Tensor, want: np.ndarray) -> float:
    got = got.detach().double().numpy()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= REL * scale, f"{what}: {err} against a scale of {scale}"
    return err / scale


def _whole(t) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def check_functions(ref_path: str) -> None:
    """Every case of ``check_functions`` in the module docstring; the
    reference's outputs and gradients in ``ref_path``, keyed
    ``<case>/out`` and ``<case>/grad/<input>``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import lm, ssm
    from repro_torch.sharding import ctx

    ref = np.load(ref_path)
    mesh = _mesh()
    worst = 0.0
    with ctx.use_mesh(mesh):
        for arch in ATTN_ARCHS:
            case = attn_case(arch)
            cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
            weights = {f"{k}/w": case[k] for k in ("wq", "wk", "wv", "wo")}
            p, leaves = _placed(weights, "mixer", mesh)
            like = p["wq"]["w"]
            x = torch.from_numpy(case["x"]).requires_grad_()
            inputs = [x]
            memory = None
            if "memory" in case:
                m = torch.from_numpy(case["memory"]).requires_grad_()
                inputs.append(m)
                memory = ctx.enter(m, like)
            positions = torch.arange(S)[None, :]
            out = ctx.local(lm._run_attn(p, ctx.enter(x, like), cfg, positions,
                                         memory=memory))
            loss = (out * torch.from_numpy(case["cot"])).sum()
            grads = torch.autograd.grad(loss, leaves + inputs)
            got = {"out": out, **{f"grad/{k}": _whole(g) for k, g in zip(weights, grads)},
                   "grad/x": grads[len(weights)]}
            if memory is not None:
                got["grad/memory"] = grads[-1]
            for k, v in got.items():
                worst = max(worst, _check(f"{arch} attn {k}", v, ref[f"attn_{arch}/{k}"]))

        case = rwkv_case()
        cfg = get_config("rwkv6-7b", smoke=True)
        weights = {k: v for k, v in case.items() if k not in ("x", "cot")}
        p, leaves = _placed(weights, "mixer", mesh)
        x = torch.from_numpy(case["x"]).requires_grad_()
        out = ctx.local(ssm.rwkv6_time_mix(p, ctx.enter(x, p["Wr"]["w"]),
                                           head_size=cfg.rwkv_head_size))
        loss = (out * torch.from_numpy(case["cot"])).sum()
        grads = torch.autograd.grad(loss, leaves + [x])
        got = {"out": out, "grad/x": grads[-1],
               **{f"grad/{k}": _whole(g) for k, g in zip(weights, grads)}}
        for k, v in got.items():
            worst = max(worst, _check(f"rwkv6 time mix {k}", v, ref[f"rwkv/{k}"]))

        case = ce_case()
        p, (table,) = _placed({"table": case["table"]}, "embed", mesh)
        x = torch.from_numpy(case["x"]).requires_grad_()
        ce = lm.chunked_cross_entropy(ctx.enter(x, p["table"]), p["table"].T,
                                      torch.from_numpy(case["targets"]),
                                      torch.from_numpy(case["mask"]), chunk=CE["chunk"])
        gx, gt = torch.autograd.grad(ce, [x, table])
        for k, v in {"out": ce, "grad/x": gx, "grad/table": _whole(gt)}.items():
            worst = max(worst, _check(f"vocab-parallel CE {k}", v, ref[f"ce/{k}"]))
    if dist.get_rank() == 0:
        print(f"functions ok on {dict(zip(mesh.mesh_dim_names, mesh.shape))}: worst "
              f"{worst:.3g} of the reference's scale", flush=True)


def check_kv_slicing() -> None:
    """q cut by heads over the model axis and k, v whole with kv heads the
    axis does not divide (H = 4, Hkv = 1 at 2 ranks; H = 8, Hkv = 2 at 4):
    the Function's output and gradients equal one process's."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention as attn
    from repro_torch.sharding import ctx

    n = dist.get_world_size()
    H, Hkv, hd = (4, 1, 16) if n == 2 else (8, 2, 16)
    tp = _mesh()["model"]
    rng = np.random.default_rng(3)
    q, k, v, cot = (torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(np.float32))
                    for h in (H, Hkv, Hkv, H))
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = fa_ops.flash_attention(*plain)
    want = torch.autograd.grad((want_out * cot).sum(), plain)
    cut = [distribute_tensor(q, tp, [Shard(2)]).requires_grad_(),
           distribute_tensor(k, tp, [Replicate()]).requires_grad_(),
           distribute_tensor(v, tp, [Replicate()]).requires_grad_()]
    out = attn.flash_attention(*cut)
    assert out.placements == (Shard(2),), out.placements
    got = torch.autograd.grad((ctx.local(out) * cot).sum(), cut)
    worst = _check("kv-sliced flash out", ctx.local(out), want_out.double().detach().numpy())
    for name, g, w in zip("qkv", got, want):
        worst = max(worst, _check(f"kv-sliced flash grad {name}", g.full_tensor(),
                                  w.double().numpy()))
    if dist.get_rank() == 0:
        print(f"kv slicing ok: H {H}, Hkv {Hkv} over {n} ranks, worst {worst:.3g}",
              flush=True)


def check_train() -> None:
    """``TRAIN_ARCHS`` on the all-model production mesh, 3 steps chained,
    equal to one process (``torch_sharded_cases``' tolerances)."""
    import torch.distributed as dist

    from torch_lm_cases import train_batch, warm_train_state
    from torch_sharded_cases import STEPS, check_steps_chained
    from repro_torch.train import trainer

    mesh = _mesh()
    for arch in TRAIN_ARCHS:
        setup = trainer.TrainSetup(micro_batches=2, learning_rate=TRAIN_LR, warmup_steps=2,
                                   total_steps=20)
        cfg, state, _ = warm_train_state(arch, setup, 2, seed=0)
        batches = [{k: torch.from_numpy(v) for k, v in train_batch(cfg, 4, 16, seed=10 + i).items()}
                   for i in range(STEPS)]
        check_steps_chained(cfg, setup, state, batches, mesh)
        if dist.get_rank() == 0:
            print(f"{arch} {tuple(mesh.shape)} ok", flush=True)


def script(body: str) -> str:
    """A worker: join the gloo world, run ``body`` (this module as ``c``),
    print MH_OK."""
    return ("from repro_torch.launch.mesh import init_distributed\n"
            "init_distributed()\n"
            "import torch_tp_cases as c\n"
            f"{body}\n"
            "print('MH_OK')\n")
