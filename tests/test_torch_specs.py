"""The port's shape grid and cell inputs against the reference's, in one
process (``repro_torch/configs/__init__.py``, ``launch/specs.py``;
``repro/configs/__init__.py``, ``repro/launch/specs.py``):

* ``ARCH_IDS``, ``SHAPES``, ``cell_enabled`` and ``all_cells`` equal the
  reference's for all 40 cells;
* for every cell ``all_cells()`` enables, ``train_setup`` equals the
  reference's and every leaf of ``input_specs`` (path, shape, dtype) its
  ``ShapeDtypeStruct``s and ``jax.eval_shape`` of its ``init_cache``.  The
  cache's ``len`` is the one difference: an int32 scalar in the reference,
  a host integer (0) in the port, which indexes the cache without a device
  round trip;
* ``abstract_state_for`` equals the reference's ``abstract_train_state``
  leaf for leaf for all ten ids (``train_4k``'s setup);
* a rank's argument bytes on the ``single`` mesh (a fake world of 256
  ranks, ``launch/dryrun.place``) equal the bytes computed from the
  reference's own ``ShardingPolicy`` specs on a duck-typed 16×16 mesh for
  llama3-8b, rwkv6-7b and qwen2-moe-a2.7b at full width, one block deep;
* ROADMAP C14: the reference's dry-run forces 512 placeholder devices and
  its ``single`` mesh is ``plan_mesh(512, 16)`` = (32, 16), while its
  artifact reports 256 devices; the port's ``single`` is the documented
  (16, 16) over 256 ranks."""
import dataclasses
import math

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.fault.elastic import plan_mesh as jplan_mesh
from repro.launch import specs as jspecs
from repro.sharding.policy import ShardingPolicy as JPolicy
from repro.treepath import keystr_path as jkeystr
from repro_torch import configs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.policy import keystr_path


def _jax_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jkeystr(kp, separator="/"): (tuple(x.shape), np.dtype(x.dtype).name)
            for kp, x in flat}


def _port_leaves(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, (*path, k)))
        return out
    if isinstance(tree, tuple):         # NamedTuples: the reference's field names
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_port_leaves(v, (*path, k)))
        return out
    if isinstance(tree, int):
        return {keystr_path(path): ("host int", tree)}
    return {keystr_path(path): (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


def test_shape_grid_equals_the_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    got = list(configs.all_cells(include_skipped=True))
    assert len(got) == 40
    assert got == list(jconfigs.all_cells(include_skipped=True))
    assert list(configs.all_cells()) == list(jconfigs.all_cells())
    for a in configs.ARCH_IDS:
        for s in configs.SHAPES:
            assert configs.cell_enabled(configs.get_config(a), configs.SHAPES[s]) == \
                jconfigs.cell_enabled(jconfigs.get_config(a), jconfigs.SHAPES[s])


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_setup_and_input_specs_equal_the_reference(arch):
    cells = [s for a, s, ok, _ in configs.all_cells() if a == arch]
    assert cells
    for shape in cells:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        assert dataclasses.asdict(specs.train_setup(cfg, configs.SHAPES[shape])) == \
            dataclasses.asdict(jspecs.train_setup(jcfg, jconfigs.SHAPES[shape]))
        kind, args = specs.input_specs(arch, shape)
        jkind, jargs = jspecs.input_specs(arch, shape)
        assert kind == jkind
        got, want = _port_leaves(args), _jax_leaves(jargs)
        if kind == "decode":
            assert got.pop("cache/len") == ("host int", 0)
            assert want.pop("cache/len") == ((), "int32")
        assert got == want, (arch, shape)
        assert all(x.device.type == "meta" for x in dryrun._tensors(args))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_abstract_state_equals_the_reference(arch):
    shape = configs.SHAPES["train_4k"]
    got = _port_leaves(specs.abstract_state_for(configs.get_config(arch), shape))
    want = _jax_leaves(jspecs.abstract_state_for(jconfigs.get_config(arch),
                                                 jconfigs.SHAPES["train_4k"]))
    assert got == want


class FakeMesh:
    """Duck-typed mesh: ``.axis_names`` and ``.shape`` (a dict) only."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _spec_bytes(shape, dtype, spec, sizes) -> int:
    cut = 1
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                cut *= sizes[ax]
    return math.prod(shape) * np.dtype(dtype).itemsize // cut


def reference_argument_bytes(jcfg, shape_name: str) -> int:
    """A rank's bytes of the reference dry-run's train arguments: the state
    under its ``state_sharding`` (parameters, both moments and per-leaf EF
    residuals by the parameter's spec, scalars replicated) and the batch
    under ``batch_sharding``, on the (16, 16) mesh."""
    mesh = FakeMesh((16, 16), ("data", "model"))
    policy = JPolicy(mesh, jcfg)
    shape = jconfigs.SHAPES[shape_name]
    state = jspecs.abstract_state_for(jcfg, shape)
    specs_tree = policy.params_tree(state.params)
    total = 0
    for tree in (state.params, state.opt.mu, state.opt.nu, state.ef_residual):
        for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
                specs_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
            total += _spec_bytes(leaf.shape, leaf.dtype, spec if leaf.ndim else (), mesh.shape)
    for scalar in (state.step, state.opt.step):
        total += _spec_bytes(scalar.shape, scalar.dtype, (), mesh.shape)
    _, args = jspecs.input_specs(None, shape_name, jcfg)
    for leaf in jax.tree.leaves(args["batch"]):
        spec = (*policy.batch_spec(leaf.shape[0]), *([None] * (leaf.ndim - 1)))
        total += _spec_bytes(leaf.shape, leaf.dtype, spec, mesh.shape)
    return total


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b", "qwen2-moe-a2.7b"])
def test_argument_bytes_equal_the_reference_policy(arch):
    cfg = configs.get_config(arch)
    layers = cfg.block_period
    cfg = dataclasses.replace(cfg, num_layers=layers)
    jcfg = dataclasses.replace(jconfigs.get_config(arch), num_layers=layers)
    shape = configs.SHAPES["train_4k"]
    with dryrun.fake_world(dryrun.WORLD["single"]):
        placed = dryrun.place(cfg, shape, make_production_mesh(device="cpu"),
                              specs.train_setup(cfg, shape))
    assert placed["argument_bytes"] == reference_argument_bytes(jcfg, "train_4k")


def test_c14_single_mesh_is_the_documented_16x16():
    # the reference's dry-run forces 512 devices, so its single mesh is
    # (32, 16), yet its artifact reports 256 devices
    assert tuple(jplan_mesh(512, 16, False).shape) == (32, 16)
    assert tuple(jplan_mesh(256, 16, False).shape) == (16, 16)
    assert dryrun.WORLD == {"single": 256, "multi": 512}
    for kind, want in (("single", {"data": 16, "model": 16}),
                       ("multi", {"pod": 2, "data": 16, "model": 16})):
        with dryrun.fake_world(dryrun.WORLD[kind]):
            mesh = make_production_mesh(multi_pod=kind == "multi", device="cpu")
            assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == want
