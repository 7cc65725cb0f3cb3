"""Multi-pod dry-run: what one rank of each cell holds, computes and sends
(``repro/launch/dryrun.py``).

For every (architecture × input shape × mesh) cell the reference lowers
and compiles its step under ``NamedSharding``s on 512 placeholder CPU
devices and reads XLA's ``memory_analysis``, ``cost_analysis`` and the
collectives of the optimized HLO.  PyTorch has no compiler to ask, so the
port runs ONE rank's step on ``meta`` tensors in a fake process group of
the cell's world size and counts what that rank allocates, computes and
sends:

* the world: ``torch.distributed`` on the ``"fake"`` backend
  (``torch.testing._internal.distributed.fake_pg.FakeStore``, a private
  module of PyTorch's test suite), rank 0 of 256 ranks for ``single``
  (the documented 16×16) or 512 for ``multi`` (2×16×16), with
  ``launch.mesh.make_production_mesh(device="cpu")`` over it.  Collectives
  return at once with outputs of the right shapes; nothing crosses a wire;
* the step: a ``train`` cell runs the meshed train step
  (``trainer.shard_train_state`` then ``make_train_step(cfg, setup,
  mesh)``, tensor-parallel on the model axis) on the global meta batch;
  ``prefill`` and ``decode`` cells place the parameters and the cache by
  ``policy.params_sharding`` and ``policy.cache_sharding`` (the
  reference's ``in_shardings``) and cut the batch to this rank's rows.  A
  ``prefill`` cell runs ``lm.prefill_forward`` on the placed parameters
  through the same tensor-parallel blocks as the train step: each block's
  leaves gathered over the data axes only just before it runs, the leaves
  outside the blocks once (``sharding/gather.py``), the activations
  DTensors on the model sub-mesh.  A ``decode`` cell runs the
  tensor-parallel ``lm.serve_step`` on the same parameters and on the
  rank's shard of the cache, rewrapped on the model sub-mesh
  (``trainer.cache_model_shards``: K/V cut by kv heads or by positions,
  the RWKV state by heads, the Mamba state by ``d_inner``), which the
  step updates in place; nothing of
  the cache is gathered.  The kernels' wrappers take a ``meta`` route:
  their checks, an empty output, and the call recorded by its local
  shape;
* ``flops_per_device``: the FLOPs of the aten ops this rank runs (the
  matmuls, WKV6's plain backward, the rematerialized recompute), counted
  by ``torch.utils.flop_counter``'s formulas on the local tensors under DTensor (:class:`StepCounter`; ``FlopCounterMode``
  would count a DTensor op at its global shape), plus each recorded kernel
  call at its formula (``ops.flops``; the flash backward's calls, recorded
  apart as ``flash_attention_bwd``, at ``ops.flops_bwd``); both parts are
  kept (``flops_aten``, ``kernels``);
* ``collectives``: a ``TorchDispatchMode`` (:class:`StepCounter`) over the
  ``_c10d_functional``, ``c10d_functional`` and ``c10d`` ops: by the
  reference's kinds, the count, the result bytes, the largest result and
  the wire bytes at the reference's ring factors (``_WIRE_FACTOR``);
* ``memory``: ``argument_bytes`` exactly (this rank's shards of the state,
  parameters and cache, and its rows of the batch, as the reference's
  ``in_shardings`` cut them), ``output_bytes`` (this rank's part of what
  the step returns) and ``peak_bytes_est``: the most bytes of live
  storages during the step, the arguments among them, by the same mode
  (every storage an op creates is counted until it is freed, as the
  card's allocator counts ``max_memory_allocated``).

The numbers are the port's own, not XLA's: they include the
rematerialization's recompute, the compute the model axis still repeats
(the attention core of head counts it does not divide, the MoE's
routing), WKV6's plain float32 backward, and one block's parameters
gathered over the data axes at a time (the forward's and, in training,
the recompute's gather, as the reference's rematerialized scan makes
them).  There is no HLO, so no ``corrected`` trip-count analysis
and no ``bytes_accessed``; ``trace_s`` (the step's wall seconds under the
counters) stands where ``lower_s`` and ``compile_s`` stood.

The dry-run runs on the CPU by design, as the reference's runs on
placeholder devices: it allocates no memory for the tensors and launches
no kernel.  ``run_cell`` refuses to start while a process group is live
and destroys its own when it returns.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh multi
  python -m repro_torch.launch.dryrun --all --mesh single
  python -m repro_torch.launch.dryrun --list

Artifacts: artifacts/torch/dryrun/<arch>__<shape>__<mesh>[__<tag>].json
(incremental: existing artifacts are skipped unless --force)."""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils._pytree import tree_flatten

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "dryrun"
WORLD = {"single": 256, "multi": 512}

# wire-bytes-per-device conventions (ring algorithms, n→large), the
# reference's:
#   all-reduce of shard s      -> 2s        all-gather to size g -> g
#   reduce-scatter of input s  -> s         all-to-all of s      -> s
#   collective-permute of s    -> s
_WIRE_FACTOR = {
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
# an op's name (without its overload) -> its kind; names not here (waits,
# barriers, the autograd wrapper) are not collectives
_KINDS = {
    **{n: "all-reduce" for n in ("all_reduce", "all_reduce_", "all_reduce_coalesced",
                                 "all_reduce_coalesced_", "allreduce_",
                                 "allreduce_coalesced_")},
    **{n: "all-gather" for n in ("all_gather_into_tensor", "all_gather_into_tensor_out",
                                 "all_gather_into_tensor_coalesced", "allgather_",
                                 "_allgather_base_", "allgather_coalesced_",
                                 "allgather_into_tensor_coalesced_")},
    **{n: "reduce-scatter" for n in ("reduce_scatter_tensor",
                                     "reduce_scatter_tensor_coalesced",
                                     "reduce_scatter_", "_reduce_scatter_base_",
                                     "reduce_scatter_tensor_coalesced_")},
    **{n: "all-to-all" for n in ("all_to_all_single", "alltoall_", "alltoall_base_")},
    **{n: "collective-permute" for n in ("broadcast", "broadcast_", "send", "recv_",
                                         "recv_any_source_")},
}


def collective_kind(func) -> str | None:
    """The reference's kind of a dispatched op, None for any other op."""
    if getattr(func, "namespace", None) not in _NAMESPACES:
        return None
    return _KINDS.get(func._opname)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """The bytes of this rank's part of every tensor in ``tree`` (a
    DTensor's local shard), each leaf counted once."""
    return sum(_local(t).nbytes for t in _tensors(tree))


class StepCounter(TorchDispatchMode):
    """Collectives by kind, FLOPs, and the bytes of live storages and their
    peak, over the plain tensors a step dispatches: an op on DTensors
    returns ``NotImplemented`` here, so DTensor desugars it into the local
    ops and collectives this mode then sees, as ``CommDebugMode`` does.
    ``flops`` adds each local op's FLOPs at ``torch.utils.flop_counter``'s
    formula (``FlopCounterMode``'s registry).

    ``track(tree)`` counts the storages of tensors made before the mode
    (the step's arguments); every storage an op makes is counted from the
    op until it is freed."""

    def __init__(self):
        super().__init__()
        self.collectives: dict[str, dict] = {}
        self.live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.flops = 0

    def track(self, tree) -> None:
        for t in _tensors(tree):
            self._see(_local(t))

    def _see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors((args, out))):
            # DTensor's sharding propagation runs an op on fake global-shape
            # tensors to learn its output's shape: not the rank's work
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        kind = collective_kind(func)
        if kind is not None:
            # c10d's all-to-all writes into its first argument and returns
            # only a work handle
            b = sum(t.nbytes for t in _tensors(out)) or _tensors(args[:1])[0].nbytes
            d = self.collectives.setdefault(kind, {"count": 0, "result_bytes": 0,
                                                   "wire_bytes": 0.0, "largest_bytes": 0})
            d["count"] += 1
            d["result_bytes"] += b
            d["largest_bytes"] = max(d["largest_bytes"], b)
            d["wire_bytes"] += b * _WIRE_FACTOR[kind]
        for t in _tensors(out):
            self._see(t)
        return out


def _meta_kernels() -> dict:
    """The LM kernels' meta-call records, by kernel: (``META_CALLS``, a
    recorded key -> (its shape's name, its whole call's name, one call's
    FLOPs))."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6_scan import ops as wkv

    def flash(B, S, Skv, H, Hkv, hd, causal, dt):
        return (fa.shape_key(S, Skv, causal, dt), fa.call_key(B, S, Skv, H, Hkv, hd, causal, dt),
                fa.flops(B, S, Skv, H, hd, causal))

    def flash_bwd(B, S, Skv, H, Hkv, hd, causal, dt):
        return (fa.shape_key(S, Skv, causal, dt), fa.call_key(B, S, Skv, H, Hkv, hd, causal, dt),
                fa.flops_bwd(B, S, Skv, H, hd, causal))

    def wkv6(B, T, H, hd, dt, carried):
        key = wkv.call_key(B, T, H, hd, dt)
        return key, key, wkv.flops(B, T, H, hd)
    return {"flash_attention": (fa.META_CALLS, flash),
            "flash_attention_bwd": (fa.META_CALLS_BWD, flash_bwd),
            "wkv6": (wkv.META_CALLS, wkv6)}


def _kernel_counts() -> dict:
    """The meta calls recorded since the last reset, by kernel: calls, calls
    by shape (the flash key is ``LAUNCHES_BY_SHAPE``'s), by the whole call
    at the rank's local shape (the flash key is ``LAUNCHES_BY_CALL``'s,
    with the head counts) and FLOPs at the kernel's formula."""
    out = {}
    for name, (calls, describe) in _meta_kernels().items():
        if not calls:
            continue
        by_shape: dict = {}
        by_call: dict = {}
        flops = 0
        for key, n in calls.items():
            shape, call, one = describe(*key)
            by_shape[shape] = by_shape.get(shape, 0) + n
            by_call[call] = by_call.get(call, 0) + n
            flops += n * one
        out[name] = {"calls": sum(calls.values()), "by_shape": by_shape, "by_call": by_call,
                     "flops": flops}
    return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on exit.  Raises while another process group is live."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("the dry-run starts a fake process group of its own; a "
                           "process group is already live in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def place(cfg, shape, mesh, setup=None, fsdp: bool = True,
          inputs: dict | None = None) -> dict:
    """The step inputs of the cell (``cfg`` × ``shape``, a
    ``configs.ShapeSpec``) as the policy places them on ``mesh``, and
    ``argument_bytes``: this rank's shards of the state, or of the
    parameters and the cache, and its rows of the batch (``rows``, cut
    over the mesh axes ``cut``).  ``inputs``: ``{"state", "batch"}`` for a
    train cell, ``{"batch"}`` for prefill, ``{"cache", "tokens"}`` for
    decode, unsharded, default ``launch.specs``'s meta inputs (and the
    abstract train state); the parameters of prefill and decode are
    ``init_params(cfg, None, "meta")``."""
    from repro_torch.launch import specs
    from repro_torch.models import lm
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer

    policy = ShardingPolicy(mesh, cfg, fsdp=fsdp)
    if inputs is None:
        inputs = specs.inputs_for(cfg, shape)[1]
        if shape.kind == "train":
            inputs["state"] = trainer.abstract_train_state(cfg, setup)
    out: dict = {"policy": policy}
    if shape.kind == "train":
        out["state"] = trainer.shard_train_state(inputs["state"], policy)
        held = out["state"]
    else:
        params = lm.init_params(cfg, None, "meta")
        out["params"] = policy.distribute(params, policy.params_sharding(params))
        held = out["params"]
    if shape.kind == "decode":
        out["cache"] = policy.distribute(inputs["cache"], policy.cache_sharding(inputs["cache"]))
        out["tokens"] = inputs["tokens"]
        held = (held, out["cache"])
        rows_of = out["tokens"]
    else:
        out["batch"] = inputs["batch"]
        rows_of = out["batch"]["tokens"]
    out["rows"], out["cut"] = trainer._local_rows(policy, rows_of.shape[0])
    mine = (out["tokens"][out["rows"]] if shape.kind == "decode"
            else {k: v[out["rows"]] for k, v in out["batch"].items()})
    out["argument_bytes"] = local_bytes(held) + local_bytes(mine)
    return out


def trace(cfg, shape, mesh, setup=None, fsdp: bool = True, inputs: dict | None = None) -> dict:
    """One rank's step of the cell on ``mesh`` under the counters, in
    whatever process group is live: the fake one of :func:`run_cell`, or a
    real one (the tests count a gloo world's collectives by the same
    mode); ``inputs`` as :func:`place` takes them."""
    from repro_torch.models import lm
    from repro_torch.sharding import ctx
    from repro_torch.train import trainer

    placed = place(cfg, shape, mesh, setup, fsdp, inputs)
    rows, cut = placed["rows"], placed["cut"]
    counter = StepCounter()
    for calls, _ in _meta_kernels().values():
        calls.clear()
    if shape.kind == "train":
        state, batch = placed.pop("state"), placed.pop("batch")
        step = trainer.make_train_step(cfg, setup, mesh)
        counter.track((state, batch))
        t0 = time.perf_counter()
        with counter:
            out = step(state, batch)
        del state
    else:
        params = placed.pop("params")
        if shape.kind == "prefill":
            batch = {k: v[rows] for k, v in placed.pop("batch").items()}
            counter.track((params, batch))
            fn = lm.prefill_forward(cfg)
            t0 = time.perf_counter()
            with counter, ctx.use_mesh(mesh), ctx.cut_batch(cut):
                out = fn(params, batch)
        else:
            cache, tokens = placed.pop("cache"), placed.pop("tokens")[rows]
            counter.track((params, cache, tokens))
            fn = lm.serve_step(cfg)
            t0 = time.perf_counter()
            with counter, ctx.use_mesh(mesh), ctx.cut_batch(cut):
                out = fn(params, trainer.cache_model_shards(cache, mesh), tokens)
            del cache
        del params
    trace_s = time.perf_counter() - t0
    kernels = _kernel_counts()
    aten = counter.flops
    coll = counter.collectives
    return {
        "flops_per_device": aten + sum(k["flops"] for k in kernels.values()),
        "flops_aten": aten,
        "kernels": kernels,
        "memory": {"argument_bytes": placed["argument_bytes"],
                   "output_bytes": local_bytes(out),
                   "peak_bytes_est": counter.peak_bytes},
        "collectives": coll,
        "collective_wire_bytes_per_device": sum(d["wire_bytes"] for d in coll.values()),
        "trace_s": trace_s,
    }


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             overrides: dict | None = None) -> dict:
    """The dry-run of one cell on a fake world of ``WORLD[mesh_kind]`` ranks
    (the module docstring): the reference's artifact keys where the port
    has the quantity."""
    from repro_torch.configs import SHAPES, cell_enabled, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import train_setup
    from repro_torch.sharding.policy import mesh_axis_sizes

    overrides = dict(overrides or {})
    shape = SHAPES[shape_name]
    cfg = get_config(arch_id)
    cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides.items() if hasattr(cfg, k)})
    setup = train_setup(cfg, shape)
    setup = dataclasses.replace(setup, **{k: v for k, v in overrides.items()
                                          if k in ("micro_batches", "compress_grads")})
    ok, why = cell_enabled(cfg, shape)
    if not ok:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    with fake_world(WORLD[mesh_kind]):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="cpu")
        res = trace(cfg, shape, mesh, setup if shape.kind == "train" else None,
                    fsdp=bool(overrides.get("fsdp", True)))
        mesh_shape = mesh_axis_sizes(mesh)
        devices = dist.get_world_size()
    return {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_kind,
        "kind": shape.kind,
        "status": "ok",
        "devices": devices,
        "mesh_shape": mesh_shape,
        "trace_s": round(res.pop("trace_s"), 1),
        "overrides": overrides,
        **res,
        "param_count": cfg.param_count(),
        "param_count_active": cfg.param_count(active_only=True),
    }


def cell_path(arch_id: str, shape_name: str, mesh_kind: str,
              tag: str = "") -> pathlib.Path:
    suffix = f"__{tag}" if tag else ""
    return ART_DIR / f"{arch_id}__{shape_name}__{mesh_kind}{suffix}.json"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="artifact suffix for perf expts")
    ap.add_argument("--override", default="",
                    help="k=v,... ModelConfig/TrainSetup overrides (perf expts)")
    args = ap.parse_args()

    from repro_torch.configs import all_cells

    if args.list:
        for a, s, ok, why in all_cells(include_skipped=True):
            print(f"{a:26s} {s:12s} {'RUN' if ok else 'SKIP  ' + why}")
        return

    overrides = {}
    for kv in filter(None, args.override.split(",")):
        k, v = kv.split("=")
        overrides[k] = (v == "True" if v in ("True", "False")
                        else int(v) if v.isdigit() else v)

    if args.all:
        cells = [(a, s) for a, s, ok, _ in all_cells() if ok]
    else:
        cells = [(args.arch, args.shape)]

    ART_DIR.mkdir(parents=True, exist_ok=True)
    for arch_id, shape_name in cells:
        out = cell_path(arch_id, shape_name, args.mesh, args.tag)
        if out.exists() and not args.force:
            print(f"SKIP (cached) {out.name}")
            continue
        print(f"=== {arch_id} × {shape_name} × {args.mesh} ===", flush=True)
        try:
            res = run_cell(arch_id, shape_name, args.mesh, overrides or None)
        except Exception as e:  # record failures — they are bugs to fix
            res = {"arch": arch_id, "shape": shape_name, "mesh": args.mesh,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        out.write_text(json.dumps(res, indent=2))
        status = res["status"]
        if status == "ok":
            gb = res["memory"]["peak_bytes_est"] / 2**30
            print(f"  ok: {res['flops_per_device']:.3e} flops/dev, "
                  f"peak {gb:.2f} GiB/dev, "
                  f"coll {res['collective_wire_bytes_per_device']:.3e} B/dev, "
                  f"trace {res['trace_s']}s", flush=True)
        else:
            print(f"  {status}: {res.get('error', res.get('reason'))}", flush=True)


if __name__ == "__main__":
    main()
