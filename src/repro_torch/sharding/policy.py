"""Logical-axis sharding policy with divisibility fallback
(``repro/sharding/policy.py``).

Maps every parameter, batch and decode-cache tensor to a
:class:`PartitionSpec` over the production mesh's axes:

  dp  = ("pod", "data")  (or ("data",) on one pod)  — FSDP / batch
  tp  = "model"                                      — TP / EP / SP

The rules are the reference's, rule for rule and in its order: name-based
on the parameter tree's path (``layers/pos0/ffn/gate``) and shape-aware.
A dimension is sharded only when the axis divides it, otherwise the policy
falls back to the other (contraction) dimension: yi-34b's 56 heads do not
split 16 ways, so its attention projections shard d_model; granite's 40
experts do not, so each expert's FFN shards d_ff instead of the experts.

A spec is the port's own small type: a tuple with one entry per
dimension, each ``None``, an axis name, or a tuple of axis names.  Where
the reference turns a spec into a ``NamedSharding``, the port turns it
into DTensor placements on a ``torch.distributed`` ``DeviceMesh``
(:func:`placements`): one ``Shard(d)`` or ``Replicate()`` per mesh
dimension.  The policy reads a mesh's axis names and sizes through
:func:`mesh_axis_sizes`, which takes a ``DeviceMesh``, the fleet's
``launch.mesh.Mesh`` and a duck-typed mesh with no devices alike, so specs
can be built for a 512-chip mesh on any host."""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from torch import Tensor
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.models.config import ModelConfig


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (not sharded), an axis name,
    or a tuple of axis names (sharded over their product, major first).  A
    tuple of one axis is that axis, as JAX's ``PartitionSpec`` holds it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# where one block's Mamba mixer leaves (the path after ``mixer/``) hold
# d_inner, as (dimension, runs): the dimension the port's tensor-parallel
# mixer computes them cut by on the model axis, whatever the rules store
# them by (``x_proj`` by its output, ``conv_b`` and ``D`` whole); a leaf
# of 2 runs (``in_proj``'s output, x then z) is cut run by run, so a rank
# holds the x and the z of its own channels
MAMBA_CHANNELS = {"in_proj/w": (1, 2), "conv_w": (1, 1), "conv_b": (0, 1),
                  "x_proj/w": (0, 1), "dt_proj/w": (1, 1), "dt_proj/b": (0, 1),
                  "A_log": (0, 1), "D": (0, 1), "out_proj/w": (0, 1)}


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's axis order, for a ``DeviceMesh``
    (``mesh_dim_names``, ``shape``), the fleet's ``Mesh`` (``axis_names``,
    ``shape``) or a duck-typed mesh whose ``shape`` is a dict."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = mesh.shape
    if isinstance(shape, dict):
        return {n: int(shape[n]) for n in names}
    return {n: int(s) for n, s in zip(names, tuple(shape))}


def axis_size(mesh, axes) -> int:
    """The product of ``axes``' sizes (an axis name, a tuple of them, or
    None for 1)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh axis in
    order, ``Shard(d)`` when the spec's dimension ``d`` names the axis
    (alone or in a tuple), else ``Replicate()``.  Two mesh axes sharding one
    dimension split it in mesh order, major first, as JAX orders a tuple
    entry (``("pod", "data")``)."""
    out = []
    for name in mesh_axis_sizes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def keystr_path(path, separator: str = "/") -> str:
    """The simple-form path string the rules match on (``layers/pos0/ffn/
    gate/w``): the keys of nested dicts joined by ``separator``, as the
    reference's ``treepath.keystr_path`` joins a pytree's."""
    return separator.join(str(k) for k in path)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts (parameter, cache and batch
    trees), rebuilt as dicts."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    return fn(path, tree)


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's shape; a host number (a cache's ``len``) is a scalar."""
    return tuple(getattr(leaf, "shape", ()))


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: tuple[str, ...]          # data/FSDP axes, e.g. ("pod", "data")
    tp: str = "model"

    @classmethod
    def from_mesh(cls, mesh) -> "MeshAxes":
        return cls(dp=tuple(n for n in mesh_axis_sizes(mesh) if n != "model"),
                   tp="model")


class ShardingPolicy:
    def __init__(self, mesh, cfg: ModelConfig | None, fsdp: bool = True):
        """``fsdp=False`` replicates parameters across the data axes (pure
        DP + TP): no per-layer weight all-gathers, the gradients all-reduce
        once."""
        self.mesh = mesh
        self.cfg = cfg
        self.fsdp = fsdp
        self.axes = MeshAxes.from_mesh(mesh)
        self.dp_size = axis_size(mesh, self.axes.dp)
        self.tp_size = axis_size(mesh, self.axes.tp)

    # -- helpers -------------------------------------------------------------
    def _fits(self, dim: int, axes) -> bool:
        if axes == self.axes.dp and not self.fsdp:
            return False          # parameters never shard over dp
        return dim % axis_size(self.mesh, axes) == 0

    def _mm(self, shape, out_dim: int, in_dim: int) -> P:
        """Matmul weight ``[*, in, out]``: prefer (in->dp, out->tp); fall
        back to (in->tp, out->dp); else replicate what does not fit."""
        dp, tp = self.axes.dp, self.axes.tp
        lead = (None,) * (len(shape) - 2)
        din, dout = shape[in_dim], shape[out_dim]
        if self._fits(dout, tp) and self._fits(din, dp):
            return P(*lead, dp, tp)
        if self._fits(dout, dp) and self._fits(din, tp):
            return P(*lead, tp, dp)
        if self._fits(dout, tp):
            return P(*lead, None, tp)
        if self._fits(din, tp):
            return P(*lead, tp, None)
        if self._fits(dout, dp):
            return P(*lead, None, dp)
        return P(*lead, None, None)

    def _mm_T(self, shape) -> P:
        """Weight ``[*, in, out]`` whose ``in`` is the wide model dimension
        (down/out projections): prefer (in->tp, out->dp)."""
        dp, tp = self.axes.dp, self.axes.tp
        lead = (None,) * (len(shape) - 2)
        din, dout = shape[-2], shape[-1]
        if self._fits(din, tp) and self._fits(dout, dp):
            return P(*lead, tp, dp)
        if self._fits(din, dp) and self._fits(dout, tp):
            return P(*lead, dp, tp)
        if self._fits(din, tp):
            return P(*lead, tp, None)
        if self._fits(dout, tp):
            return P(*lead, None, tp)
        return P(*lead, None, None)

    def _vec(self, shape) -> P:
        lead = (None,) * (len(shape) - 1)
        if self._fits(shape[-1], self.axes.tp):
            return P(*lead, self.axes.tp)
        return P(*lead, None)

    # -- parameters ------------------------------------------------------------
    def param_spec(self, path: str, shape: tuple[int, ...]) -> P:
        dp, tp = self.axes.dp, self.axes.tp
        lead = (None,) * max(len(shape) - 2, 0)

        if "embed/table" in path:
            # [V, d]: vocab->tp when divisible; replicated otherwise
            if self._fits(shape[0], tp) and self._fits(shape[1], dp):
                return P(tp, dp)
            if self._fits(shape[0], tp):
                return P(tp, None)
            return P(None, None)
        if "lm_head" in path:
            return self._mm(shape, out_dim=-1, in_dim=-2)
        if "gnn/" in path:
            # graph-policy message-passing layers (core/graph_policy.py):
            # matrices over the model axis (the fleet's data axes carry
            # lanes, so the caller passes fsdp=False)
            if len(shape) >= 2:
                return self._mm(shape, out_dim=-1, in_dim=-2)
            return self._vec(shape)
        if path.endswith("/b"):
            return self._vec(shape)
        if "norm" in path or "ln_x" in path:
            return P(*((None,) * len(shape)))
        if "router" in path:
            return P(*((None,) * len(shape)))

        # MoE stacked experts [..., E, in, out] (leading block dimension)
        if (any(k in path for k in ("ffn/gate", "ffn/up", "ffn/down"))
                and "shared" not in path and len(shape) >= 3):
            lead3 = (None,) * (len(shape) - 3)
            E = shape[-3]
            if self._fits(E, tp):
                # expert parallelism: experts over tp, d_ff over dp
                wide = -2 if "down" in path else -1   # the d_ff dimension
                spec = [None, None, None]
                spec[0] = tp
                if self._fits(shape[wide], dp):
                    spec[wide] = dp
                return P(*lead3, *spec)
            # TP fallback inside each expert
            if "down" in path:
                return P(*lead3, None, *self._mm_T(shape[-2:]))
            return P(*lead3, None, *self._mm(shape[-2:], out_dim=-1, in_dim=-2))

        if any(k in path for k in ("/gate/w", "/up/w", "wq/w", "wk/w", "wv/w",
                                   "in_proj/w", "Wr/w", "Wk/w", "Wv/w", "Wg/w",
                                   "Wck/w", "Wcr/w", "x_proj/w", "dt_proj/w",
                                   "w_lora1/w", "cross")):
            if "cross" in path and ("wo/w" in path):
                return self._mm_T(shape)
            return self._mm(shape, out_dim=-1, in_dim=-2)
        if any(k in path for k in ("/down/w", "wo/w", "out_proj/w", "Wo/w",
                                   "Wcv/w", "w_lora2/w")):
            return self._mm_T(shape)
        if "conv_w" in path:
            return P(*lead, None, tp) if self._fits(shape[-1], tp) else \
                P(*((None,) * len(shape)))
        if "A_log" in path or path.endswith("/D"):
            if self._fits(shape[-2] if len(shape) >= 2 else shape[-1], tp):
                return P(*((None,) * (len(shape) - 2)), tp, None) \
                    if len(shape) >= 2 else P(tp)
            return P(*((None,) * len(shape)))
        if path.endswith("/u") or "/mu" in path or "w_base" in path:
            return P(*((None,) * len(shape)))
        # default: replicate
        return P(*((None,) * len(shape)))

    def compute_cut(self, path: str, shape: tuple[int, ...]) -> tuple[int, int] | None:
        """(dimension, runs) that the stacked Mamba leaf ``layers/.../mixer/
        <leaf>`` of ``shape`` is computed cut by on the model axis
        (``MAMBA_CHANNELS``, shifted past the block dimension) when the axis
        divides its d_inner channels; None for any other leaf."""
        head, sep, leaf = path.partition("/mixer/")
        if not (sep and head.startswith("layers/") and leaf in MAMBA_CHANNELS):
            return None
        dim, runs = MAMBA_CHANNELS[leaf]
        return (dim + 1, runs) if self._fits(shape[dim + 1] // runs, self.axes.tp) else None

    def params_tree(self, params) -> Any:
        """The tree of ``params`` with each leaf's spec in its place; leaves
        may be real tensors or ``meta`` ones (only shapes are read)."""
        return tree_map_with_path(
            lambda path, leaf: self.param_spec(keystr_path(path), _shape(leaf)), params)

    def params_sharding(self, params) -> Any:
        """The tree of ``params`` with each leaf's DTensor placements."""
        return tree_map_with_path(lambda path, leaf: placements(
            self.mesh, self.param_spec(keystr_path(path), _shape(leaf))), params)

    # -- batch / activations ----------------------------------------------------
    def batch_spec(self, batch_size: int) -> P:
        if batch_size % self.dp_size == 0:
            return P(self.axes.dp)
        return P(None)

    def batch_sharding(self, batch) -> Any:
        def one(path, leaf):
            shape = _shape(leaf)
            base = self.batch_spec(shape[0])
            return placements(self.mesh, P(*base, *([None] * (len(shape) - 1))))
        return tree_map_with_path(one, batch)

    # -- decode cache -------------------------------------------------------------
    def cache_spec(self, path: str, shape: tuple[int, ...]) -> P:
        """Cache leaves are stacked ``[nb, B, ...]``."""
        dp, tp = self.axes.dp, self.axes.tp
        if path.endswith("len") or len(shape) < 2:
            return P(*([None] * len(shape)))
        batch_ax = dp if shape[1] % self.dp_size == 0 else None
        if any(k in path for k in ("/k", "/v", "/ck", "/cv")):
            nb, B, S, hkv, hd = shape
            if hkv % self.tp_size == 0:
                return P(None, batch_ax, None, tp, None)
            if S % self.tp_size == 0:
                # sequence-sharded cache (flash-decoding style partial softmax)
                return P(None, batch_ax, tp, None, None)
            return P(None, batch_ax, None, None, None)
        if path.endswith("/h"):       # mamba state [nb,B,di,ds]
            return P(None, batch_ax, tp if shape[2] % self.tp_size == 0 else None, None)
        if path.endswith("/conv"):    # [nb,B,dc-1,di]
            return P(None, batch_ax, None, tp if shape[3] % self.tp_size == 0 else None)
        if path.endswith("/S"):       # rwkv state [nb,B,H,hd,hd]
            return P(None, batch_ax, tp if shape[2] % self.tp_size == 0 else None,
                     None, None)
        if "x_tm" in path or "x_cm" in path:
            return P(None, batch_ax, None)
        return P(*([None] * len(shape)))

    def cache_sharding(self, cache) -> Any:
        return tree_map_with_path(lambda path, leaf: placements(
            self.mesh, self.cache_spec(keystr_path(path), _shape(leaf))), cache)

    def distribute(self, tree, shardings) -> Any:
        """Each tensor of ``tree`` as a DTensor on the mesh with its
        placements in ``shardings`` (``params_sharding``'s or
        ``cache_sharding``'s tree); each rank keeps its shard (on a mesh of
        one, the tensor itself).  A host number as it is."""
        if isinstance(tree, dict):
            return {k: self.distribute(v, shardings[k]) for k, v in tree.items()}
        if not isinstance(tree, Tensor):
            return tree
        return distribute_tensor(tree, self.mesh, shardings)

    def replicated(self) -> tuple:
        return placements(self.mesh, P())
