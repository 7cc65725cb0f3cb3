"""Gloo workers for the port's expert parallelism and tensor-parallel Mamba
on the ``model`` axis (``tests/test_torch_ep_mamba.py``).  Imports nothing
of JAX: the reference's answers are computed by the test in its own
process and handed over in an ``.npz``.

* ``check_functions``: on ``make_production_mesh``'s all-model mesh of the
  world ((1, 2) or (1, 4)), ``ffn.moe_ffn`` on the smoke widths of
  ``MOE_ARCHS`` (jamba's 4 experts cut by experts at 2 and 4 ranks,
  granite's 5 by d_ff, qwen2-moe's 6 by experts at 2 and by d_ff at 4,
  its shared experts column- then row-parallel), and ``ssm.mamba_forward``
  and ``ssm.mamba_step`` at jamba's smoke widths (cut by d_inner, the
  step's state the rank's channels), their parameters placed by the
  policy and gathered over the data axes (``trainer.gather_model_shards``:
  the Mamba leaves stacked over one block, so they are recut as the
  model's are).  Each output and every gradient, gathered whole, within
  ``REL`` of the reference's largest magnitude; each MoE's route is the
  one its placements name;
* the recut: after ``gather_model_shards`` of jamba's float32 smoke tree,
  and in each block that ``gather.BlockShards`` gathers of its placed
  ``layers`` (the model's per-block route), each rank's ``in_proj`` shard
  holds exactly the x and z columns of its ``d_inner/n`` channels,
  ``x_proj`` its rows of them, and every other Mamba leaf its slice of
  them, the channels that ``cache_model_shards`` gives it of the decode
  state ``h`` and ``conv``;
* ``check_train``: ``TRAIN_ARCHS`` on the all-model mesh train 3 steps
  equal to one process (``torch_sharded_cases.check_steps_chained`` at
  ``torch_tp_cases.TRAIN_LR``): the loss and gradient norm within its
  ``REL``, every leaf of the moments within ``LEAF[arch]`` of its largest
  magnitude, of the parameters within that plus ``UPDATE`` of the
  learning rate.

The train step's tolerances.  The cut experts and channels sum in another
order than one process does.  Granite's and qwen2-moe's moments then
differ from one process's by at most 1.6e-6 of their leaf's scale over
the 3 steps at 2 and 4 ranks (measured), inside the shared ``LEAF``
(2e-5).  jamba's smoke stack (7 Mamba recurrences, 4 MoE layers of 4
experts) is the worst conditioned: in one process its gradients move by a
median 6.7e-6 and at most 2.5e-5 of their leaf's scale when the
parameters move by 1e-7 of themselves (a float32 rounding), and its
meshed moments differ by up to 4.7e-5 (measured), so its ``LEAF`` is
2e-4.  A parameter leaf initialized at zero (qwen2-moe's qkv biases,
Mamba's ``conv_b`` and ``dt_proj.b``) is a few Adam steps' size, and
where one of its gradient elements is rounding-sized Adam's ``m/√v``
is a ratio of rounding-sized numbers: qwen2-moe's biases differ by
2.3e-7, 9.1e-5 of their scale and 2.3e-4 of a step at lr 1e-3, so the
parameters may differ by ``UPDATE`` (1e-2) of the learning rate
besides."""
import numpy as np
import torch

REL = 1e-5
MOE_ARCHS = ("jamba-1.5-large-398b", "granite-moe-3b-a800m", "qwen2-moe-a2.7b")
TRAIN_ARCHS = ("jamba-1.5-large-398b", "qwen2-moe-a2.7b", "granite-moe-3b-a800m")
B, S = 2, 16
LEAF = {"jamba-1.5-large-398b": 2e-4, "qwen2-moe-a2.7b": 2e-5, "granite-moe-3b-a800m": 2e-5}
UPDATE = 1e-2
MAMBA = "jamba-1.5-large-398b"
MAMBA_LEAVES = ("in_proj/w", "conv_w", "conv_b", "x_proj/w", "dt_proj/w", "dt_proj/b",
                "A_log", "D", "out_proj/w")


def moe_case(arch: str, seed: int = 0) -> dict:
    """One MoE layer at ``arch``'s smoke widths, flat by path (the router
    drawn at 0.5, so its top-K is decided well clear of ties), an input
    and the output's cotangent, from one numpy seed."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    rng = np.random.default_rng(seed)
    draw = lambda *s: (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)  # noqa: E731
    case = {"router/w": (rng.normal(size=(d, E)) * 0.5).astype(np.float32),
            "gate": draw(E, d, f), "up": draw(E, d, f), "down": draw(E, f, d)}
    if cfg.num_shared_experts:
        F = cfg.num_shared_experts * f
        case.update({"shared/gate/w": draw(d, F), "shared/up/w": draw(d, F),
                     "shared/down/w": draw(F, d)})
    case["x"] = rng.normal(size=(B, S, d)).astype(np.float32)
    case["cot"] = rng.normal(size=(B, S, d)).astype(np.float32)
    return case


def mamba_case(seed: int = 1) -> dict:
    """jamba's smoke Mamba mixer flat by path, a sequence ``u`` and its
    output's cotangent, and a decode step's input, state and cotangents,
    from one numpy seed."""
    from repro_torch.configs import get_config
    cfg = get_config(MAMBA, smoke=True)
    d, di, ds, dc = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    r = max(d // 16, 1)
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    normal = lambda *s, scale=1.0: f32(rng.normal(size=s) * scale)  # noqa: E731
    return {
        "in_proj/w": normal(d, 2 * di, scale=d ** -0.5),
        "conv_w": normal(dc, di, scale=dc ** -0.5), "conv_b": normal(di, scale=0.1),
        "x_proj/w": normal(di, r + 2 * ds, scale=di ** -0.5),
        "dt_proj/w": normal(r, di, scale=r ** -0.5), "dt_proj/b": normal(di, scale=0.1),
        "A_log": f32(np.log(np.arange(1, ds + 1))[None, :] + rng.normal(size=(di, ds)) * 0.1),
        "D": f32(1 + rng.normal(size=di) * 0.1),
        "out_proj/w": normal(di, d, scale=di ** -0.5),
        "u": normal(B, S, d), "cot": normal(B, S, d),
        "u_t": normal(B, 1, d), "h": normal(B, di, ds), "conv": normal(B, dc - 1, di),
        "cot_t": normal(B, 1, d), "cot_h": normal(B, di, ds),
    }


def _mesh():
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(device="cpu")


def _check(what: str, got, want: np.ndarray) -> float:
    from torch.distributed.tensor import DTensor
    got = (got.full_tensor() if isinstance(got, DTensor) else got).detach().double().numpy()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= REL * scale, f"{what}: {err} against a scale of {scale}"
    return err / scale


def _moe(arch: str, ref, mesh) -> float:
    from torch.distributed.tensor import Shard

    from torch_tp_cases import _placed

    from repro_torch.configs import get_config
    from repro_torch.models import ffn
    from repro_torch.sharding import ctx

    cfg = get_config(arch, smoke=True)
    case = moe_case(arch)
    weights = {k: v for k, v in case.items() if k not in ("x", "cot")}
    p, leaves = _placed(weights, "ffn", mesh)
    ep = cfg.num_experts % mesh["model"].size() == 0
    assert p["gate"].placements == (Shard(0) if ep else Shard(2),), (arch, p["gate"].placements)
    x = torch.from_numpy(case["x"]).requires_grad_()
    out, aux = ffn.moe_ffn(p, ctx.enter(x, p["gate"]), experts_per_token=cfg.experts_per_token,
                           capacity_factor=cfg.capacity_factor,
                           router_aux_coef=cfg.router_aux_coef)
    assert out.placements[0].is_replicate() and not hasattr(aux, "placements")
    loss = (ctx.local(out) * torch.from_numpy(case["cot"])).sum() + aux
    grads = torch.autograd.grad(loss, leaves + [x])
    got = {"out": out, "aux": aux, "grad/x": grads[-1],
           **{f"grad/{k}": g for k, g in zip(weights, grads)}}
    return max(_check(f"{arch} moe {k}", v, ref[f"moe_{arch}/{k}"]) for k, v in got.items())


def _stacked_mixer(flat: dict, mesh):
    """jamba's Mamba leaves ``flat`` stacked over one block at
    ``layers/pos0/mixer``, placed by the policy and gathered
    (``gather_model_shards``): (block 0's tree, the placed leaves)."""
    from torch.distributed.tensor import distribute_tensor

    from torch_tp_cases import nest
    from repro_torch.sharding.policy import ShardingPolicy, placements
    from repro_torch.train import trainer

    policy = ShardingPolicy(mesh, None)
    leaves = [distribute_tensor(torch.from_numpy(v)[None], mesh, placements(
        mesh, policy.param_spec(f"layers/pos0/mixer/{k}", (1, *v.shape)))).requires_grad_()
        for k, v in flat.items()]
    tree = nest({f"layers/pos0/mixer/{k}": x for k, x in zip(flat, leaves)})
    mixer = trainer.gather_model_shards(tree, mesh)["layers"]["pos0"]["mixer"]
    return _first_block(mixer), leaves


def _first_block(tree):
    if isinstance(tree, dict):
        return {k: _first_block(v) for k, v in tree.items()}
    return tree[0]


def _mamba(ref, mesh) -> float:
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.sharding import ctx

    cfg = get_config(MAMBA, smoke=True)
    kw = dict(d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv)
    case = mamba_case()
    weights = {k: case[k] for k in MAMBA_LEAVES}
    p, leaves = _stacked_mixer(weights, mesh)
    like = p["in_proj"]["w"]
    u = torch.from_numpy(case["u"]).requires_grad_()
    out = ssm.mamba_forward(p, ctx.enter(u, like), **kw)
    assert out.placements[0].is_replicate()
    grads = torch.autograd.grad((ctx.local(out) * torch.from_numpy(case["cot"])).sum(),
                                leaves + [u])
    got = {"out": out, "grad/u": grads[-1],
           **{f"grad/{k}": g.full_tensor()[0] for k, g in zip(weights, grads)}}
    worst = max(_check(f"mamba_forward {k}", v, ref[f"mamba/{k}"]) for k, v in got.items())

    tp = mesh["model"]
    u_t = torch.from_numpy(case["u_t"]).requires_grad_()
    state = {name: distribute_tensor(torch.from_numpy(case[name]), tp, [Shard(dim)]
                                     ).requires_grad_() for name, dim in (("h", 1), ("conv", 2))}
    y, new = ssm.mamba_step(p, ctx.enter(u_t, like), state, **kw)
    assert new["h"].placements == (Shard(1),) and new["conv"].placements == (Shard(2),)
    loss = ((ctx.local(y) * torch.from_numpy(case["cot_t"])).sum()
            + (new["h"].full_tensor() * torch.from_numpy(case["cot_h"])).sum())
    grads = torch.autograd.grad(loss, leaves + [u_t, state["h"], state["conv"]])
    got = {"out": y, "h": new["h"], "conv": new["conv"], "grad/u_t": grads[-3],
           "grad/h": grads[-2], "grad/conv": grads[-1],
           **{f"grad/{k}": g.full_tensor()[0] for k, g in zip(weights, grads)}}
    return max(worst, *(_check(f"mamba_step {k}", v, ref[f"mamba_step/{k}"])
                        for k, v in got.items()))


def check_recut(mesh) -> None:
    """The recut of the module docstring, on jamba's smoke tree placed by
    the policy, and its decode cache."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.sharding import gather
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer

    cfg = dataclasses.replace(get_config(MAMBA, smoke=True), dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    policy = ShardingPolicy(mesh, cfg)
    placed = policy.distribute(params, policy.params_sharding(params))
    tp = trainer.gather_model_shards(placed, mesh)
    shards = gather.BlockShards(placed["layers"])
    blocks = [shards.gather(shards.shards(b)) for b in range(cfg.num_blocks)]
    n, r = mesh["model"].size(), mesh["model"].get_local_rank()
    di = cfg.mamba_d_inner
    mine = slice(r * di // n, (r + 1) * di // n)
    cache = lm.init_cache(cfg, 2, 8, "cpu")
    pos = [f"pos{i}" for i, (mixer, _) in enumerate(cfg.block_program()) if mixer == "mamba"]
    for name in pos:
        c = cache[name]
        c["h"].copy_(torch.arange(di, dtype=torch.float32)[:, None].expand(c["h"].shape))
        c["conv"].copy_(torch.arange(di, dtype=torch.float32).expand(c["conv"].shape))
    tp_cache = trainer.cache_model_shards(policy.distribute(cache, policy.cache_sharding(cache)),
                                          mesh)
    channels = torch.arange(di, dtype=torch.float32)[mine]
    for name in pos:
        full, got = params["layers"][name]["mixer"], tp["layers"][name]["mixer"]
        w = full["in_proj"]["w"]
        want = {"in_proj/w": torch.cat([w[..., :di][..., mine], w[..., di:][..., mine]], -1),
                "x_proj/w": full["x_proj"]["w"][:, mine], "conv_w": full["conv_w"][..., mine],
                "conv_b": full["conv_b"][:, mine], "dt_proj/w": full["dt_proj"]["w"][..., mine],
                "dt_proj/b": full["dt_proj"]["b"][:, mine], "A_log": full["A_log"][:, mine],
                "D": full["D"][:, mine], "out_proj/w": full["out_proj"]["w"][:, mine]}
        for path, leaf in want.items():
            held = [got, *(block[name]["mixer"] for block in blocks)]
            for k in path.split("/"):
                held = [h[k] for h in held]
            assert torch.equal(held[0].to_local(), leaf), (name, path)
            for b, h in enumerate(held[1:]):
                assert torch.equal(h.to_local(), leaf[b]), (name, path, b)
        c = tp_cache[name]
        assert torch.equal(c["h"].to_local()[..., :, 0], channels.expand(1, 2, -1)), name
        assert torch.equal(c["conv"].to_local()[..., 0, :], channels.expand(1, 2, -1)), name
    if dist.get_rank() == 0:
        print(f"recut ok: {len(pos)} Mamba positions, {di // n} of {di} channels a rank",
              flush=True)


def check_functions(ref_path: str) -> None:
    """``check_functions`` and the recut of the module docstring; the
    reference's outputs and gradients in ``ref_path``, keyed
    ``<case>/out`` and ``<case>/grad/<input>``."""
    import torch.distributed as dist

    from repro_torch.sharding import ctx

    ref = np.load(ref_path)
    mesh = _mesh()
    with ctx.use_mesh(mesh):
        worst = max(_moe(arch, ref, mesh) for arch in MOE_ARCHS)
        worst = max(worst, _mamba(ref, mesh))
    if dist.get_rank() == 0:
        print(f"functions ok on {dict(zip(mesh.mesh_dim_names, mesh.shape))}: worst "
              f"{worst:.3g} of the reference's scale", flush=True)
    check_recut(mesh)


def check_train() -> None:
    """``TRAIN_ARCHS`` on the all-model production mesh, 3 steps chained,
    equal to one process (``torch_sharded_cases``' tolerances)."""
    import torch.distributed as dist

    from torch_lm_cases import train_batch, warm_train_state
    from torch_sharded_cases import STEPS, check_steps_chained
    from torch_tp_cases import TRAIN_LR
    from repro_torch.train import trainer

    mesh = _mesh()
    for arch in TRAIN_ARCHS:
        setup = trainer.TrainSetup(micro_batches=2, learning_rate=TRAIN_LR, warmup_steps=2,
                                   total_steps=20)
        cfg, state, _ = warm_train_state(arch, setup, 2, seed=0)
        batches = [{k: torch.from_numpy(v) for k, v in train_batch(cfg, 4, 16, seed=10 + i).items()}
                   for i in range(STEPS)]
        check_steps_chained(cfg, setup, state, batches, mesh, leaf=LEAF[arch], update=UPDATE)
        if dist.get_rank() == 0:
            print(f"{arch} {tuple(mesh.shape)} ok", flush=True)


def script(body: str) -> str:
    """A worker: join the gloo world, run ``body`` (this module as ``c``),
    print MH_OK."""
    return ("from repro_torch.launch.mesh import init_distributed\n"
            "init_distributed()\n"
            "import torch_ep_cases as c\n"
            f"{body}\n"
            "print('MH_OK')\n")
