"""The port's LM sharding policy and activation context against the
reference's, in one process (``repro_torch/sharding/policy.py``,
``sharding/ctx.py``; ``repro/sharding/policy.py``, ``sharding/ctx.py``).

Specs are built on duck-typed meshes with no devices (the reference
tests' ``FakeMesh``), so the (16, 16) and (2, 16, 16) production meshes are
checked on any host:

* every parameter spec of all ten ids equals the reference's, leaf for
  leaf, on both meshes; the decode-cache specs of four ids at batch 128,
  ``max_seq`` 4096; the reference's three fallback cases;
* ``graph_param_specs`` equals the reference's on the host mesh and on a
  (1, 2) mesh;
* ``ctx.constrain``'s spec equals the one the reference's ``constrain``
  hands ``with_sharding_constraint`` (captured by monkeypatching it and
  ``NamedSharding`` in the reference's module, in the test);
* specs turn into DTensor placements, a tuple entry on both of its mesh
  axes, major first;
* ``flash_attention_seqpar`` equals the reference's at S ≤ 1024, causal
  and not, and the ``use_seqpar`` branch of ``lm._run_attn``; past 1024
  keys the reference drops the keys after the last full chunk and the
  port reads them all (ROADMAP C13);
* ``make_production_mesh`` on one process: the reference's cases of
  ``tests/test_fault.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS, get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.sharding import ctx as jctx
from repro.sharding import policy as jpolicy
from repro.treepath import keystr_path as jkeystr
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.sharding import ctx
from repro_torch.sharding.policy import (P, ShardingPolicy, keystr_path, mesh_axis_sizes,
                                         placements)

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


class FakeMesh:
    """Duck-typed mesh: ``.axis_names`` and ``.shape`` (a dict) only."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _ref_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jkeystr(kp, separator="/"): tuple(s) for kp, s in flat}


def _port_specs(tree) -> dict:
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, (*path, k))
        else:
            out[keystr_path(path)] = tuple(node)
    walk(tree, ())
    return out


@pytest.mark.parametrize("mesh_shape,names", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh_shape, names):
    mesh = FakeMesh(mesh_shape, names)
    want = _ref_specs(jpolicy.ShardingPolicy(mesh, jax_get_config(arch)).params_tree(
        jlm.abstract_params(jax_get_config(arch))))
    cfg = get_config(arch)
    got = _port_specs(ShardingPolicy(mesh, cfg).params_tree(lm.init_params(cfg, None, "meta")))
    assert got == want
    assert sum(e is not None for s in got.values() for e in s) > 10


@pytest.mark.parametrize("arch", ["llama3-8b", "jamba-1.5-large-398b", "rwkv6-7b",
                                  "seamless-m4t-medium"])
def test_cache_specs_equal_the_reference(arch):
    mesh = FakeMesh((16, 16), ("data", "model"))
    enc = 1024 if arch == "seamless-m4t-medium" else 0
    jcfg = jax_get_config(arch)
    cache = jax.eval_shape(lambda: jlm.init_cache(jcfg, batch=128, max_seq=4096,
                                                  enc_len=enc))
    jp = jpolicy.ShardingPolicy(mesh, jcfg)
    want = {jkeystr(kp, separator="/"): tuple(jp.cache_spec(jkeystr(kp, separator="/"),
                                                            leaf.shape))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]}
    cfg = get_config(arch)
    policy = ShardingPolicy(mesh, cfg)
    got = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, (*path, k))
        else:
            got[keystr_path(path)] = tuple(policy.cache_spec(
                keystr_path(path), tuple(getattr(node, "shape", ()))))
    walk(lm.init_cache(cfg, 128, 4096, "meta", enc_len=enc), ())
    assert got == want
    assert sum(e is not None for s in got.values() for e in s) > 3


def test_fallbacks_equal_the_reference():
    """granite's 40 experts: d_ff TP'd inside each expert; jamba's 16: true
    EP; yi's 56 heads: parameters still TP'd, its 8-head cache
    sequence-sharded."""
    mesh = FakeMesh((16, 16), ("data", "model"))
    cases = [("granite-moe-3b-a800m", "param", "layers/pos0/ffn/gate", (32, 40, 1536, 512)),
             ("jamba-1.5-large-398b", "param", "layers/pos1/ffn/gate", (9, 16, 8192, 24576)),
             ("yi-34b", "param", "layers/pos0/mixer/wq/w", (60, 7168, 7168)),
             ("yi-34b", "cache", "pos0/k", (60, 128, 32768, 8, 128))]
    for arch, kind, path, shape in cases:
        ref = jpolicy.ShardingPolicy(mesh, jax_get_config(arch))
        port = ShardingPolicy(mesh, get_config(arch))
        fn = "param_spec" if kind == "param" else "cache_spec"
        got = getattr(port, fn)(path, shape)
        assert tuple(got) == tuple(getattr(ref, fn)(path, shape)), (arch, path)
    assert tuple(port.param_spec("layers/pos0/ffn/gate", (32, 40, 1536, 512)))[1] is None
    gr = ShardingPolicy(mesh, get_config("granite-moe-3b-a800m"))
    assert "model" in tuple(gr.param_spec("layers/pos0/ffn/gate", (32, 40, 1536, 512)))
    ja = ShardingPolicy(mesh, get_config("jamba-1.5-large-398b"))
    assert tuple(ja.param_spec("layers/pos1/ffn/gate", (9, 16, 8192, 24576)))[1] == "model"
    cspec = port.cache_spec("pos0/k", (60, 128, 32768, 8, 128))
    assert tuple(cspec)[2] == "model" and tuple(cspec)[3] is None


def test_fsdp_false_never_shards_parameters_over_the_data_axes():
    mesh = FakeMesh((16, 16), ("data", "model"))
    for arch in ("llama3-8b", "granite-moe-3b-a800m"):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        want = _ref_specs(jpolicy.ShardingPolicy(mesh, jcfg, fsdp=False).params_tree(
            jlm.abstract_params(jcfg)))
        got = _port_specs(ShardingPolicy(mesh, cfg, fsdp=False).params_tree(
            lm.init_params(cfg, None, "meta")))
        assert got == want
        assert all(e != ("data",) for s in got.values() for e in s)


@pytest.mark.parametrize("which", ["host", "duck_1x2"])
def test_graph_param_specs_equal_the_reference(which):
    from repro.core import make_agent as jmake_agent
    from repro.core.graph_policy import graph_param_specs as jgraph_param_specs
    from repro.dsdps import apps as japps
    from repro.dsdps.structural import StructuralSchedulingEnv
    from repro.launch.mesh import make_host_mesh as jhost_mesh
    from repro_torch.core import graph_param_specs
    from repro_torch.launch.mesh import make_host_mesh

    env = StructuralSchedulingEnv([japps.continuous_queries("small")])
    qnet = jmake_agent("graph_policy", env).init(jax.random.PRNGKey(0)).qnet
    params = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x).copy()), qnet)
    if which == "host":
        jmesh, mesh = jhost_mesh(), make_host_mesh("cpu")
    else:
        jmesh = mesh = FakeMesh((1, 2), ("data", "model"))
    want = _ref_specs(jgraph_param_specs(qnet, jmesh))
    got = _port_specs(graph_param_specs(params, mesh))
    assert got == want
    assert got["gnn/enc/w"] == (None, "model")
    assert all("data" not in (e if isinstance(e, tuple) else (e,))
               for s in got.values() for e in s)


@pytest.mark.parametrize("mesh_shape,names", [*MESHES, ((1, 2), ("data", "model")),
                                              ((4,), ("data",))])
def test_constrain_spec_equals_the_reference(monkeypatch, mesh_shape, names):
    """The reference's ``constrain`` builds ``NamedSharding(mesh, P(*spec))``
    for ``with_sharding_constraint``; both are replaced in its module to
    capture the spec.  The port's ``constrain_spec`` must give the same,
    and its ``constrain`` returns a plain tensor as it is."""
    captured = []
    monkeypatch.setattr(jctx, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jctx.jax.lax, "with_sharding_constraint",
                        lambda x, spec: captured.append(tuple(spec)) or x)
    mesh = FakeMesh(mesh_shape, names)
    cases = [((32, 2048, 4096), ("dp", None, "tp")),
             ((32, 2048, 32, 128), ("dp", None, "tp", None)),
             ((8, 2048, 56, 128), ("dp", None, "tp", None)),
             ((6, 40, 10, 512), ("dp", "tp", None, None)),
             ((3, 7, 5), ("dp", "tp", None)),
             ((16, 4096, 128256), ("dp", None, "tp"))]
    x = torch.zeros(1)
    for shape, axes in cases:
        with jctx.use_mesh(mesh):
            jctx.constrain(jax.ShapeDtypeStruct(shape, np.float32), *axes)
        with ctx.use_mesh(mesh):
            got = ctx.constrain_spec(shape, *axes)
            assert ctx.constrain(x, *axes[:1]) is x
        assert tuple(got) == captured[-1], (shape, axes)
    assert ctx.constrain_spec((4, 4), "dp", "tp") is None      # no mesh: a no-op
    assert ctx.constrain(x, "dp") is x


def test_axis_sizes_and_placements_on_every_kind_of_mesh():
    """A spec's tuple entry takes ``Shard(d)`` on both of its mesh axes,
    major first; the axis helper reads a duck mesh, the fleet's ``Mesh``
    and ``ctx``'s sizes alike."""
    from repro_torch.launch.mesh import make_fleet_mesh

    duck = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert mesh_axis_sizes(duck) == {"pod": 2, "data": 16, "model": 16}
    assert placements(duck, P(("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert placements(duck, P("model", None)) == (Replicate(), Replicate(), Shard(0))
    assert placements(duck, P()) == (Replicate(),) * 3
    assert mesh_axis_sizes(make_fleet_mesh(device="cpu")) == {"data": 1, "model": 1}
    with ctx.use_mesh(duck):
        assert (ctx.axis_size("dp"), ctx.axis_size("tp")) == (32, 16)
        assert ctx.divides(64, "dp") and not ctx.divides(56, "tp")
        assert ctx.batch_split() == 1
    assert ctx.axis_size("tp") == 1
    pol = ShardingPolicy(duck, get_config("llama3-8b"))
    sh = pol.params_sharding({"embed": {"table": torch.empty(128256, 4096,
                                                              device="meta")}})
    assert sh["embed"]["table"] == (Shard(1), Shard(1), Shard(0))     # P(tp, dp)
    assert pol.batch_spec(64) == P(("pod", "data")) and pol.batch_spec(6) == P(None)
    assert pol.batch_sharding({"tokens": torch.empty(64, 8, device="meta")})["tokens"] \
        == (Shard(0), Shard(0), Replicate())
    assert pol.replicated() == (Replicate(),) * 3


def _qkv(B, S, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, hd)).astype(np.float32) for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("S", [16, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_seqpar_equals_the_reference(S, causal):
    q, k, v = _qkv(2, S, 4, 2, 16, seed=S)
    want = np.asarray(jattn.flash_attention_seqpar(q, k, v, causal=causal))
    got = attn.flash_attention_seqpar(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _softmax_attention(q, k, v, causal, n_keys):
    """Plain numpy GQA attention over the first ``n_keys`` keys."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kk, vv = np.repeat(k[:, :n_keys], G, axis=2), np.repeat(v[:, :n_keys], G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(hd)
    if causal:
        s = np.where(np.arange(S)[:, None] >= np.arange(n_keys)[None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vv)


@pytest.mark.parametrize("causal", [True, False])
def test_c13_seqpar_reads_every_key_past_1024(causal):
    """C13: at S = 1030 the reference visits ``S // 1024`` = 1 chunk, so it
    attends over the first 1024 keys only; the port reads all 1030."""
    S = 1030
    q, k, v = _qkv(1, S, 2, 1, 8, seed=13)
    ref = np.asarray(jattn.flash_attention_seqpar(q, k, v, causal=causal))
    got = attn.flash_attention_seqpar(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal).numpy()
    np.testing.assert_allclose(got, _softmax_attention(q, k, v, causal, S),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ref, _softmax_attention(q, k, v, causal, 1024),
                               rtol=1e-4, atol=1e-5)
    assert np.abs(got - ref).max() > 1e-3
    fa = attn.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, fa, rtol=1e-4, atol=1e-5)


def test_run_attn_takes_the_seqpar_branch_where_heads_do_not_split():
    """Under a mesh whose model axis (3) does not divide the heads (4) and
    ``seqpar_attention`` set, ``_run_attn`` takes the sequence-parallel
    branch (no flash launch, not even its plain version) and gives the
    flash path's answer; without the flag it takes the flash path."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True), dtype="float32",
                              seqpar_attention=True)
    gen = torch.Generator().manual_seed(3)
    p = lm._attn_init(gen, cfg, torch.float32, "cpu")
    x = torch.randn(2, 12, cfg.d_model, generator=gen)
    pos = torch.arange(12)[None, :]
    want = lm._run_attn(p, x, cfg, pos)
    calls = []
    orig = fa_ops.flash_attention
    try:
        fa_ops.flash_attention = lambda *a, **k: calls.append(1) or orig(*a, **k)
        with ctx.use_mesh(FakeMesh((1, 3), ("data", "model"))):
            got = lm._run_attn(p, x, cfg, pos)
            assert calls == []
            lm._run_attn(p, x, dataclasses.replace(cfg, seqpar_attention=False), pos)
            assert calls == [1]
    finally:
        fa_ops.flash_attention = orig
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_production_mesh_on_one_process():
    """The reference's cases (``tests/test_fault.py``): a (data, model) mesh
    no larger than the world, multi-pod degrading to the flat grid; with
    no process group it starts a world of one itself (gloo on the CPU)."""
    from repro_torch.launch.mesh import make_production_mesh

    assert not dist.is_initialized()
    try:
        mesh = make_production_mesh(device="cpu")
        assert set(mesh.mesh_dim_names) == {"data", "model"}
        assert 1 <= mesh.size() <= dist.get_world_size()
        assert dist.get_backend() == "gloo"
        multi = make_production_mesh(multi_pod=True, device="cpu")
        assert multi.mesh_dim_names in (("data", "model"), ("pod", "data", "model"))
        assert multi.size() <= dist.get_world_size()
        assert mesh_axis_sizes(mesh) == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_production_mesh()
        assert not dist.is_initialized()
