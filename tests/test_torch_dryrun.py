"""The port's dry-run (``repro_torch/launch/dryrun.py``) and the kernels'
``meta`` routes.  Imports nothing of JAX:

* the collectives by kind (count, result bytes, wire bytes) of a smoke
  config's meshed train step on a fake world of 4 ranks equal those the
  same mode counts in a real gloo world of 4 (``torch_sharded_cases.launch``),
  on the production (1, 4) mesh and on (2, 2);
* at a world of one, the dry-run's FLOPs outside the kernels equal
  ``FlopCounterMode``'s over the same step on real CPU tensors, outside
  the plain versions (their forward, and flash's backward, run with the
  counters off);
* the peak tracker gives the exact peak of a function with known
  allocations;
* the flash and WKV6 wrappers' meta routes give the plain versions' output
  shapes and dtypes, raise the card path's errors, and record each call by
  shape; CPU tensors never reach them;
* ``run_cell`` leaves no process group behind and refuses to start while
  one is live; the command writes ``status: ok`` with 256 devices (the
  artifact directory redirected to a temporary one) and records skipped
  cells as the reference does;
* tensor-parallel compute on a fake (1, 16) world: a rank of llama3-8b's
  ``train_4k`` (2 layers by override) computes at most 1.15 × 1/16 of a
  world of one's FLOPs, its flash calls at 2 local q heads against 1 kv
  head; rwkv6-7b (1 layer, at full width over 64 tokens: its WKV6 plain
  backward is a loop over T) likewise, its WKV6 calls at 4 of 64 heads;
* the tensor-parallel decode on a fake (1, 16) world: a rank of llama3-8b's
  ``decode_32k`` (1 layer) computes at most 1.25 × 1/16 of a world of one's
  FLOPs, its cache cut by positions, and its peak stays below one whole
  K leaf (no whole-cache buffer); rwkv6-7b's (1 layer) likewise, its WKV6
  call at 4 of 64 heads with the carried state."""
import json
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._python_dispatch import _disable_current_modes

import torch_lm_cases
import torch_sharded_cases
from repro_torch.configs import ShapeSpec
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import wkv6_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import trainer

SMOKE_SHAPE = ShapeSpec("smoke", 16, 8, "train")
SMOKE_SETUP = trainer.TrainSetup(micro_batches=2, learning_rate=1e-4, warmup_steps=1,
                                 total_steps=10)
MESHES = [None, (2, 2)]                 # None: make_production_mesh's (1, 4)
COLL_ARCHS = ("llama3-8b", "qwen2-moe-a2.7b")


def real_inputs(cfg, seed: int = 0) -> dict:
    state = trainer.init_train_state(cfg, SMOKE_SETUP, torch.Generator().manual_seed(seed),
                                     "cpu")
    batch = torch_lm_cases.train_batch(cfg, SMOKE_SHAPE.global_batch,
                                       SMOKE_SHAPE.seq_len, seed)
    return {"state": state, "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}


def collectives_on(mesh_shape, arch: str, real: bool) -> dict:
    """The collectives of the smoke step of ``arch`` on a mesh of the live
    world (``mesh_shape`` None: the production mesh)."""
    cfg, _ = torch_lm_cases.smoke_lm(arch, 0)
    if mesh_shape is None:
        mesh = make_production_mesh(device="cpu")
    else:
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
    res = dryrun.trace(cfg, SMOKE_SHAPE, mesh, SMOKE_SETUP,
                       inputs=real_inputs(cfg) if real else None)
    return res["collectives"]


_WORKER = """
from repro_torch.launch.mesh import init_distributed
init_distributed()
import json
import torch.distributed as dist
import test_torch_dryrun as t
out = {f"{m}|{a}": t.collectives_on(m, a, real=True) for m in t.MESHES for a in t.COLL_ARCHS}
if dist.get_rank() == 0:
    print("COLL " + json.dumps(out))
print("MH_OK")
"""


def test_collectives_equal_a_real_gloo_world_of_4():
    outs = torch_sharded_cases.launch(_WORKER, 4)
    line = next(x for x in outs[0].splitlines() if x.startswith("COLL "))
    real = json.loads(line[5:])
    with dryrun.fake_world(4):
        fake = {f"{m}|{a}": dryrun.trace(*_smoke(a), _mesh(m), SMOKE_SETUP)["collectives"]
                for m in MESHES for a in COLL_ARCHS}
    assert json.loads(json.dumps(fake)) == real
    # the (2, 2) mesh cuts the batch: gathers, reduce-scatters and the
    # batch sums' all-reduces all cross it; the dense FFN stacked over its
    # 2 blocks, cut by block on the model axis, is recut there by all-to-all
    assert set(real[f"{(2, 2)}|llama3-8b"]) == {"all-gather", "reduce-scatter",
                                                "all-reduce", "all-to-all"}
    assert all(d["count"] > 0 and d["result_bytes"] > 0 for v in real.values()
               for d in v.values())


def _smoke(arch: str):
    return torch_lm_cases.smoke_lm(arch, 0)[0], SMOKE_SHAPE


def _mesh(mesh_shape):
    if mesh_shape is None:
        return make_production_mesh(device="cpu")
    return init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b", "qwen2-moe-a2.7b"])
def test_world_of_one_flops_equal_the_cpu_step(arch, monkeypatch):
    cfg, _ = torch_lm_cases.smoke_lm(arch, 0)
    with dryrun.fake_world(1):
        meta = dryrun.trace(cfg, SMOKE_SHAPE, make_production_mesh(device="cpu"),
                            SMOKE_SETUP)
    for mod, name in ((fa_ops, "_forward"), (wkv_ops, "_forward"), (fa_ops, "_backward")):
        plain = getattr(mod, name)

        def hidden(*args, _plain=plain):
            # the plain version stands where the card runs the kernel:
            # its forward (and flash's backward) is not counted, as the
            # kernel's is not
            with _disable_current_modes():
                return _plain(*args)
        monkeypatch.setattr(mod, name, hidden)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        cpu = dryrun.trace(cfg, SMOKE_SHAPE, make_production_mesh(device="cpu"),
                           SMOKE_SETUP, inputs=real_inputs(cfg))
    finally:
        dist.destroy_process_group()
    assert meta["flops_aten"] == cpu["flops_aten"] > 0
    kernel = "wkv6" if cfg.family == "ssm" else "flash_attention"
    # forward and the rematerialized recompute, a layer and a microbatch
    assert meta["kernels"][kernel]["calls"] == 2 * cfg.num_layers * SMOKE_SETUP.micro_batches
    assert cpu["kernels"] == {}
    assert meta["memory"]["argument_bytes"] == cpu["memory"]["argument_bytes"]


def test_peak_tracker_is_exact():
    counter = dryrun.StepCounter()
    a = torch.empty(1000, device="meta")                    # 4,000 B, an argument
    counter.track(a)
    with counter:
        b = torch.empty(2000, device="meta")                # 12,000 live
        c = b * 2                                           # 20,000: the peak
        v = c.view(20, 100)                                 # no new storage
        del b                                               # 12,000
        d = torch.empty(500, dtype=torch.bfloat16, device="meta")  # 13,000
        e = v.t().contiguous()                              # 21,000: the new peak
        del c, v, e                                         # 5,000
    assert (counter.peak_bytes, counter.live_bytes) == (21_000, 5_000)
    assert counter.collectives == {}
    del a, d


def _qkv(B, S, Skv, H, Hkv, hd, dtype, device):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, H, hd, generator=g).to(dtype)
    k, v = (torch.randn(B, Skv, Hkv, hd, generator=g).to(dtype) for _ in range(2))
    return tuple(t.to(device) for t in (q, k, v))


@pytest.mark.parametrize("case", [(2, 16, 16, 4, 2, 64, torch.bfloat16, True),
                                  (1, 8, 24, 4, 4, 96, torch.float32, False),
                                  (1, 5, 5, 2, 1, 300, torch.float32, True)])
def test_flash_meta_route(case):
    B, S, Skv, H, Hkv, hd, dtype, causal = case
    want = flash_attention_ref(*_qkv(B, S, Skv, H, Hkv, hd, dtype, "cpu"), causal=causal)
    fa_ops.META_CALLS.clear()
    before = (fa_ops.LAUNCHES, dict(fa_ops.LAUNCHES_BY_SHAPE))
    got = fa_ops.flash_attention(*_qkv(B, S, Skv, H, Hkv, hd, dtype, "meta"), causal=causal)
    assert (got.device.type, got.shape, got.dtype) == ("meta", want.shape, want.dtype)
    assert fa_ops.META_CALLS == {(B, S, Skv, H, Hkv, hd, causal, dtype): 1}
    assert (fa_ops.LAUNCHES, fa_ops.LAUNCHES_BY_SHAPE) == before
    # CPU tensors take the plain version and record nothing
    fa_ops.flash_attention(*_qkv(B, S, Skv, H, Hkv, hd, dtype, "cpu"), causal=causal)
    assert sum(fa_ops.META_CALLS.values()) == 1
    fa_ops.META_CALLS.clear()


def test_flash_meta_route_raises_the_card_errors():
    q, k, v = _qkv(1, 8, 8, 4, 2, 64, torch.bfloat16, "meta")
    with pytest.raises(ValueError, match="head_dim axis contiguous"):
        fa_ops.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3), k, v)
    with pytest.raises(ValueError, match="causal attention needs"):
        fa_ops.flash_attention(q, k[:, :4], v[:, :4])
    with pytest.raises(TypeError, match="one dtype"):
        fa_ops.flash_attention(q, k.float(), v)
    fa_ops.META_CALLS.clear()


def _wkv_inputs(B, T, H, hd, dtype, device, carried):
    g = torch.Generator().manual_seed(1)
    w = torch.rand(B, T, H, hd, generator=g) * 0.5 + 0.4
    r, k, v = (torch.randn(B, T, H, hd, generator=g).to(dtype) for _ in range(3))
    u = torch.randn(H, hd, generator=g)
    S0 = torch.randn(B, H, hd, hd, generator=g) if carried else None
    return tuple(None if t is None else t.to(device) for t in (w, r, k, v, u, S0))


@pytest.mark.parametrize("carried", [False, True])
def test_wkv_meta_route(carried):
    want = wkv6_ref(*_wkv_inputs(2, 5, 3, 16, torch.bfloat16, "cpu", carried))
    wkv_ops.META_CALLS.clear()
    launches = wkv_ops.LAUNCHES
    got = wkv_ops.wkv6(*_wkv_inputs(2, 5, 3, 16, torch.bfloat16, "meta", carried))
    for g, w in zip(got, want):
        assert (g.device.type, g.shape, g.dtype) == ("meta", w.shape, w.dtype)
    assert wkv_ops.META_CALLS == {(2, 5, 3, 16, torch.bfloat16, carried): 1}
    assert wkv_ops.LAUNCHES == launches
    wkv_ops.wkv6(*_wkv_inputs(2, 5, 3, 16, torch.bfloat16, "cpu", carried))
    assert sum(wkv_ops.META_CALLS.values()) == 1
    # the card's head dims only (the plain version takes any)
    with pytest.raises(ValueError, match="head_dim in"):
        wkv_ops.wkv6(*_wkv_inputs(1, 3, 2, 20, torch.float32, "meta", carried))
    w, r, k, v, u, S0 = _wkv_inputs(1, 3, 2, 16, torch.float32, "meta", carried)
    with pytest.raises(ValueError, match="head_dim axis contiguous"):
        wkv_ops.wkv6(w, r.transpose(1, 3).contiguous().transpose(1, 3), k, v, u, S0)
    with pytest.raises(TypeError, match="float32"):
        wkv_ops.wkv6(w.bfloat16(), r, k, v, u, S0)
    wkv_ops.META_CALLS.clear()


def test_kernel_formulas():
    # causal: the scores j <= i; full: every (i, j); 2·hd operations each
    # for q·kᵀ and p·v
    assert fa_ops.flops(1, 4, 4, 1, 8, True) == 4 * 8 * 10
    assert fa_ops.flops(2, 3, 5, 4, 8, False) == 4 * 2 * 4 * 8 * 15
    assert fa_ops.bytes_moved(2, 3, 5, 4, 2, 8, torch.bfloat16) == \
        (2 * 2 * 3 * 4 * 8 + 2 * 2 * 5 * 2 * 8) * 2
    assert wkv_ops.flops(2, 3, 4, 8) == 5 * 2 * 3 * 4 * 64
    elems, state = 2 * 3 * 4 * 8, 2 * 4 * 64 * 4
    assert wkv_ops.bytes_moved(2, 3, 4, 8, torch.bfloat16, False) == elems * 14 + state
    assert wkv_ops.bytes_moved(2, 3, 4, 8, torch.float32, True) == elems * 20 + 2 * state


def test_run_cell_leaves_no_process_group_and_refuses_a_live_one():
    res = dryrun.run_cell("llama3-8b", "long_500k", "single")
    assert res["status"] == "skipped" and "sub-quadratic" in res["reason"]
    res = dryrun.run_cell("llama3-8b", "decode_32k", "single", {"num_layers": 1})
    assert res["status"] == "ok" and res["devices"] == 256
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already live"):
            dryrun.run_cell("llama3-8b", "train_4k", "single", {"num_layers": 1})
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_command_writes_the_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "llama3-8b", "--shape",
                                      "train_4k", "--override", "num_layers=1"])
    dryrun.main()
    res = json.loads((tmp_path / "llama3-8b__train_4k__single.json").read_text())
    assert res["status"] == "ok" and res["devices"] == 256
    assert res["mesh_shape"] == {"data": 16, "model": 16}
    assert res["overrides"] == {"num_layers": 1}
    # 8 microbatches, each the layer's forward and its recompute
    assert res["kernels"]["flash_attention"]["by_shape"] == {
        "4096x4096 causal bfloat16": 16}
    for key in ("flops_per_device", "collective_wire_bytes_per_device", "param_count",
                "param_count_active", "trace_s"):
        assert np.isfinite(res[key]) and res[key] >= 0
    assert set(res["memory"]) == {"argument_bytes", "output_bytes", "peak_bytes_est"}
    assert set(res["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter"}
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "llama3-8b", "--shape",
                                      "train_4k"])
    dryrun.main()
    assert "SKIP (cached)" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["dryrun", "--list"])
    dryrun.main()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 40 and sum("SKIP" in x for x in lines) == 8
    assert dryrun.cell_path("a", "b", "single").parent == tmp_path
    assert not dist.is_initialized()


def test_artifacts_live_under_the_ignored_directory():
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    assert dryrun.cell_path("llama3-8b", "train_4k", "multi", "t") == \
        root / "artifacts" / "torch" / "dryrun" / "llama3-8b__train_4k__multi__t.json"
    assert "artifacts/torch/" in (root / ".gitignore").read_text().split()


def test_train_setup_overrides_reach_the_step():
    res = dryrun.run_cell("llama3-8b", "train_4k", "single",
                          {"num_layers": 1, "micro_batches": 2})
    assert res["kernels"]["flash_attention"]["calls"] == 4


@pytest.mark.parametrize("arch,shape,local", [
    ("llama3-8b", "train_4k", {"flash_attention": "q[32,4096,2,128] kv[4096,1] causal bfloat16"}),
    ("rwkv6-7b", ShapeSpec("tp_rwkv", 64, 16, "train"), {"wkv6": "[16,64,4,64] bfloat16"})],
    ids=["llama3-8b", "rwkv6-7b"])
def test_model_axis_cuts_a_ranks_flops_sixteen_ways(arch, shape, local):
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import specs

    cfg = dataclasses.replace(get_config(arch), num_layers=2 if arch == "llama3-8b" else 1)
    shape = SHAPES.get(shape, shape)
    setup = specs.train_setup(cfg, shape)
    res = {}
    for world in (1, 16):
        with dryrun.fake_world(world):
            mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
            res[world] = dryrun.trace(cfg, shape, mesh, setup)
    assert res[16]["flops_per_device"] <= 1.15 * res[1]["flops_per_device"] / 16
    (kernel, key), = local.items()
    calls = res[1]["kernels"][kernel]["calls"]
    assert res[16]["kernels"][kernel]["by_call"] == {key: calls}
    assert res[16]["kernels"][kernel]["flops"] * 16 == res[1]["kernels"][kernel]["flops"]


# llama3-8b's K cache at decode_32k, one layer: 128 rows x 32768 positions x
# 8 kv heads x 128, bfloat16
WHOLE_K = 128 * 32768 * 8 * 128 * 2


@pytest.mark.parametrize("arch,local,whole", [
    ("llama3-8b", None, WHOLE_K),
    ("rwkv6-7b", {"wkv6": "[128,1,4,64] bfloat16"}, None)], ids=["llama3-8b", "rwkv6-7b"])
def test_tensor_parallel_decode_keeps_the_cache_cut(arch, local, whole):
    import dataclasses

    from repro_torch.configs import SHAPES, get_config

    cfg = dataclasses.replace(get_config(arch), num_layers=1)
    res = {}
    for world in (1, 16):
        with dryrun.fake_world(world):
            mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
            res[world] = dryrun.trace(cfg, SHAPES["decode_32k"], mesh)
    assert res[16]["flops_per_device"] <= 1.25 * res[1]["flops_per_device"] / 16
    if whole:
        assert res[16]["memory"]["peak_bytes_est"] < whole
    if local:
        (kernel, key), = local.items()
        assert res[16]["kernels"][kernel]["by_call"] == {key: res[1]["kernels"][kernel]["calls"]}
        assert res[16]["kernels"][kernel]["flops"] * 16 == res[1]["kernels"][kernel]["flops"]
