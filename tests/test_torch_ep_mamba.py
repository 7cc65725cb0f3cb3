"""The port's expert parallelism and tensor-parallel Mamba on the ``model``
axis, in gloo worlds of 2 and 4 on the CPU (``make_production_mesh``:
(1, 2) and (1, 4), all model axis).  The workers are in
``torch_ep_cases.py``; each world has a timeout
(``torch_sharded_cases.TIMEOUT_S``).

* the cut ``moe_ffn`` (by experts: jamba's smoke widths, qwen2-moe's at 2
  ranks; by d_ff: granite's, qwen2-moe's at 4, with its shared experts)
  and the cut ``mamba_forward`` and ``mamba_step`` equal the reference's
  (``repro.models.ffn.moe_ffn``, ``repro.models.ssm.mamba_forward``,
  ``mamba_step``) on the same numpy-seeded float32 inputs: output, aux
  loss, new state and every gradient within 1e-5 of the reference's scale
  (JAX on the CPU, computed here and handed to the workers);
* after ``gather_model_shards`` a rank's Mamba leaves hold exactly its
  ``d_inner`` channels (``in_proj`` the x and z columns of them), those
  the decode cache's ``h`` and ``conv`` shards hold (the same launch);
* jamba, qwen2-moe and granite smoke configs train 3 steps on the mesh
  equal to one process;
* in this process, on a (1, 1) mesh, a MoE or a Mamba mixer whose weights
  are not cut as the policy cuts them raises rather than running whole,
  and so does one given an input that is not whole on every rank.

The (1, 1) mesh's bit-for-bit train steps and decodes of all ten ids, the
MoE and jamba among them, are ``test_torch_tensor_parallel.py``'s and
``test_torch_tp_decode.py``'s; the decodes of jamba, qwen2-moe and granite
in worlds of 2 and 4 are ``test_torch_tp_decode.py``'s."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_ep_cases as cases  # noqa: E402
from torch_sharded_cases import launch  # noqa: E402
from torch_tp_cases import nest  # noqa: E402

pytestmark = pytest.mark.skipif(not torch.distributed.is_available(),
                                reason="needs torch.distributed")
WORLDS = [2, 4]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _vjp(fn, primals: tuple, cots: tuple):
    """(fn's outputs, the gradients of ``primals`` at the cotangents
    ``cots``), traced once by ``jax.jit``."""
    def run(primals, cots):
        out, pull = jax.vjp(fn, *primals)
        return out, pull(cots)
    return jax.jit(run)(primals, cots)


@functools.lru_cache(maxsize=None)
def _references() -> dict:
    """The reference's outputs and gradients for every ``check_functions``
    case, keyed as the worker reads them."""
    from repro.configs import get_config
    from repro.models import ffn as jffn
    from repro.models import ssm as jssm

    ref = {}
    for arch in cases.MOE_ARCHS:
        cfg = get_config(arch, smoke=True)
        case = cases.moe_case(arch)
        weights = nest({k: jnp.asarray(v) for k, v in case.items() if k not in ("x", "cot")})

        def moe(p, x):
            return jffn.moe_ffn(p, x, experts_per_token=cfg.experts_per_token,
                                capacity_factor=cfg.capacity_factor,
                                router_aux_coef=cfg.router_aux_coef)
        (out, aux), (gp, gx) = _vjp(moe, (weights, jnp.asarray(case["x"])),
                                    (jnp.asarray(case["cot"]), jnp.ones((), jnp.float32)))
        ref.update({f"moe_{arch}/out": out, f"moe_{arch}/aux": aux, f"moe_{arch}/grad/x": gx,
                    **{f"moe_{arch}/grad/{k}": g for k, g in _flat(gp).items()}})

    cfg = get_config(cases.MAMBA, smoke=True)
    kw = dict(d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv)
    case = {k: jnp.asarray(v) for k, v in cases.mamba_case().items()}
    weights = nest({k: case[k] for k in cases.MAMBA_LEAVES})
    out, (gp, gu) = _vjp(lambda p, u: jssm.mamba_forward(p, u, **kw), (weights, case["u"]),
                         case["cot"])
    ref.update({"mamba/out": out, "mamba/grad/u": gu,
                **{f"mamba/grad/{k}": g for k, g in _flat(gp).items()}})

    def step(p, u_t, h, conv):
        y, new = jssm.mamba_step(p, u_t, {"h": h, "conv": conv}, **kw)
        return y, new["h"], new["conv"]
    (y, h, conv), (gp, gu, gh, gc) = _vjp(
        step, (weights, case["u_t"], case["h"], case["conv"]),
        (case["cot_t"], case["cot_h"], jnp.zeros_like(case["conv"])))
    ref.update({"mamba_step/out": y, "mamba_step/h": h, "mamba_step/conv": conv,
                "mamba_step/grad/u_t": gu, "mamba_step/grad/h": gh,
                "mamba_step/grad/conv": gc,
                **{f"mamba_step/grad/{k}": g for k, g in _flat(gp).items()}})
    return {k: np.asarray(v, np.float64) for k, v in ref.items()}


@functools.lru_cache(maxsize=None)
def _functions(world: int, directory: str) -> str:
    """Rank 0's output of ``check_functions`` in a world of ``world``."""
    path = f"{directory}/reference_{world}.npz"
    np.savez(path, **_references())
    return launch(cases.script(f"c.check_functions({path!r})"), world)[0]


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ep_mamba"))


@pytest.mark.parametrize("world", WORLDS)
def test_cut_moe_and_mamba_equal_the_reference(world, scratch):
    out = _functions(world, scratch)
    assert "functions ok" in out, out


@pytest.mark.parametrize("world", WORLDS)
def test_a_ranks_mamba_leaves_hold_its_channels_as_the_cache_does(world, scratch):
    out = _functions(world, scratch)
    assert "recut ok" in out, out


@pytest.mark.parametrize("world", WORLDS)
def test_expert_parallel_and_mamba_steps_equal_one_process(world):
    outs = launch(cases.script("c.check_train()"), world)
    assert outs[0].count(" ok") == len(cases.TRAIN_ARCHS), outs[0]


@pytest.mark.parametrize("block", ["moe", "mamba"])
def test_a_block_cut_otherwise_raises(block):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import ffn, ssm
    from repro_torch.sharding import ctx

    mesh = make_production_mesh(device="cpu")
    try:
        tp = mesh["model"]
        whole = lambda a: distribute_tensor(torch.from_numpy(a), tp, [Replicate()])  # noqa: E731
        cfg = get_config(cases.MAMBA, smoke=True)
        if block == "moe":
            case = cases.moe_case(cases.MAMBA)
            p = nest({k: whole(v) for k, v in case.items() if k not in ("x", "cot")})
            x = ctx.enter(torch.from_numpy(case["x"]), p["gate"])
            with pytest.raises(ValueError, match="neither by experts nor by d_ff"):
                ffn.moe_ffn(p, x, experts_per_token=cfg.experts_per_token)
        else:
            case = cases.mamba_case()
            p = nest({k: whole(case[k]) for k in cases.MAMBA_LEAVES})
            u = ctx.enter(torch.from_numpy(case["u"]), p["D"])
            with pytest.raises(ValueError, match="not cut by d_inner"):
                ssm.mamba_forward(p, u, d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("block", ["moe", "mamba"])
def test_an_input_not_whole_raises(block):
    """Weights cut as the mixer wants them, on a (1, 1) mesh, and an input
    that is a ``Partial`` sum: the MoE and the Mamba mixer refuse it rather
    than run on part-sums."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import ffn, ssm
    from repro_torch.sharding.policy import MAMBA_CHANNELS

    mesh = make_production_mesh(device="cpu")
    try:
        tp = mesh["model"]
        cut = lambda a, dim: distribute_tensor(torch.from_numpy(a), tp, [Shard(dim)])  # noqa: E731
        part = lambda a: DTensor.from_local(torch.from_numpy(a), tp, [Partial()])  # noqa: E731
        cfg = get_config(cases.MAMBA, smoke=True)
        if block == "moe":
            case = cases.moe_case(cases.MAMBA)
            p = nest({k: cut(v, 0) for k, v in case.items()
                      if k not in ("x", "cot", "router/w")})
            p["router"] = {"w": distribute_tensor(torch.from_numpy(case["router/w"]), tp,
                                                  [Replicate()])}
            with pytest.raises(ValueError, match="the MoE's input is"):
                ffn.moe_ffn(p, part(case["x"]), experts_per_token=cfg.experts_per_token)
        else:
            case = cases.mamba_case()
            p = nest({k: cut(case[k], MAMBA_CHANNELS[k][0]) for k in cases.MAMBA_LEAVES})
            with pytest.raises(ValueError, match="the Mamba input is"):
                ssm.mamba_forward(p, part(case["u"]), d_state=cfg.mamba_d_state,
                                  d_conv=cfg.mamba_d_conv)
    finally:
        dist.destroy_process_group()
