"""Atomic, integrity-checked, asynchronous checkpoints of torch state.

Port of ``repro/checkpoint/checkpointer.py``, on the reference's layout:

  <dir>/step_%08d/
      manifest.json   {"step", "leaves": [{"name", "file", "shape", "dtype",
                       "crc32"}]}
      leaf_%05d.npy   one file per leaf, written with allow_pickle=False

A step is staged as ``.tmp_step_%08d`` and renamed into place only after
every leaf and the manifest are written, so a write cut off half way never
shadows the newest whole step.  bfloat16 is stored as its raw 16-bit
pattern (numpy ``uint16``) with ``"bfloat16"`` as the manifest's dtype.  The
crc32 of every leaf is checked on load.  Each package reads the other's
directories.

The state is walked as PyTorch holds it, not through a pytree library: a
``Tensor`` is a leaf; a ``torch.Generator`` is a leaf, saved as
``get_state()`` and restored with ``set_state()``; an ``nn.Module`` is
walked through its named parameters, then its named buffers; a dataclass by
its fields in order, a NamedTuple by its fields, a dict by its sorted keys
(JAX's order) and a list or tuple by index; ``None`` holds nothing.  Names
are the keys joined by ``.`` (``agent.actor.weights.0``), as the reference's
``keystr_path(..., separator=".")`` joins them.

:meth:`Checkpointer.restore` writes into the template's own tensors, in
place, on the template's device, so a checkpoint written from the card
restores into a CPU template and the reverse.  A generator is the
exception: its state fits only a generator of the same device type (a CPU
generator's Mersenne-Twister state against a CUDA generator's seed and
Philox offset), and restoring one into the other raises."""
from __future__ import annotations

import copy
import dataclasses
import json
import pathlib
import queue
import shutil
import threading
import zlib

import numpy as np
import torch
from torch import nn

Leaf = torch.Tensor | torch.Generator


def _children(node) -> list[tuple[str, object]] | None:
    """The (key, child) pairs of a container, or None when ``node`` is not
    one."""
    if isinstance(node, nn.Module):
        return [*node.named_parameters(), *node.named_buffers()]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def named_leaves(tree) -> list[tuple[str, Leaf]]:
    """Every tensor and generator of ``tree`` with its ``.``-joined name, in
    the order the checkpoint stores them."""
    out = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, (torch.Tensor, torch.Generator)):
            out.append((".".join(path), node))
            return
        kids = _children(node)
        if kids is None:
            raise TypeError(f"cannot checkpoint {'.'.join(path) or 'the state'}: a "
                            f"{type(node).__name__} is neither a tensor, a "
                            f"generator nor a container of them")
        for key, child in kids:
            walk(child, (*path, key))

    walk(tree, ())
    return out


def map_tensors(fn, tree, *others):
    """``tree`` rebuilt with each tensor ``x`` replaced by ``fn(x, *ys)``, the
    ``ys`` the tensors at the same place in ``others`` (trees of the same
    structure).  Containers are walked as :func:`named_leaves` walks them;
    a module is copied with fresh parameters
    (and buffers) holding the results, each keeping its ``requires_grad``.
    The results never alias the inputs when ``fn`` copies."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            y = fn(tree.detach(), *(o.detach() for o in others))
        return y.requires_grad_(tree.requires_grad)
    if isinstance(tree, nn.Module):
        named = [dict([*o.named_parameters(), *o.named_buffers()]) for o in others]
        memo = {}
        for name, p in tree.named_parameters():
            with torch.no_grad():
                y = fn(p.detach(), *(n[name].detach() for n in named))
            memo[id(p)] = nn.Parameter(y, requires_grad=p.requires_grad)
        for name, b in tree.named_buffers():
            with torch.no_grad():
                memo[id(b)] = fn(b, *(n[name] for n in named))
        return copy.deepcopy(tree, memo)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        new = copy.copy(tree)
        for f in dataclasses.fields(tree):
            object.__setattr__(new, f.name, map_tensors(
                fn, getattr(tree, f.name), *(getattr(o, f.name) for o in others)))
        return new
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, *xs) for xs in zip(tree, *others)))
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, *xs) for xs in zip(tree, *others))
    raise TypeError(f"cannot gather lanes of a {type(tree).__name__}")


def dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _spec(leaf: Leaf) -> tuple[list[int], str]:
    """The shape and dtype name a leaf is stored with."""
    t = leaf.get_state() if isinstance(leaf, torch.Generator) else leaf
    return list(t.shape), dtype_name(t)


def host_copy(leaf: Leaf) -> torch.Tensor:
    """A leaf's value on the host, taken on the caller's thread."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    return leaf.detach().cpu()


def _as_stored(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the numpy array its file holds (bfloat16 as its raw
    ``uint16`` bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr))


def write_leaf(directory: pathlib.Path, index: int, name: str,
               t: torch.Tensor) -> dict:
    """Write the host tensor ``t`` as ``leaf_%05d.npy`` in ``directory``;
    returns its manifest entry."""
    fn = f"leaf_{index:05d}.npy"
    arr = _as_stored(t)
    np.save(directory / fn, arr, allow_pickle=False)
    return {"name": name, "file": fn, "shape": list(t.shape),
            "dtype": dtype_name(t), "crc32": _crc32(arr)}


def read_leaf(d: pathlib.Path, ent: dict) -> torch.Tensor:
    """The tensor of manifest entry ``ent`` in step directory ``d``, its
    crc32 checked (``IOError`` when it differs)."""
    arr = np.load(d / ent["file"], allow_pickle=False)
    crc = _crc32(arr)
    if crc != ent["crc32"]:
        raise IOError(f"checkpoint corruption in {ent['name']}: "
                      f"crc {crc} != {ent['crc32']}")
    if ent["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state) -> pathlib.Path:
        """Write ``state`` as step ``step`` (synchronously: the device-to-host
        copies, the crc and the files all on the caller's thread)."""
        named = named_leaves(state)
        return self._write(step, [n for n, _ in named],
                           [host_copy(leaf) for _, leaf in named])

    def _write(self, step: int, names: list[str],
               host: list[torch.Tensor]) -> pathlib.Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (name, t) in enumerate(zip(names, host)):
            manifest["leaves"].append(write_leaf(tmp, i, name, t))
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        return json.loads((self.dir / f"step_{step:08d}" / "manifest.json").read_text())

    def restore(self, template, step: int | None = None):
        """Load step ``step`` (default: the latest) into ``template``'s own
        tensors and generators, in place, and return ``template``.

        Raises ``ValueError`` before anything is written when a leaf's name,
        shape or dtype differs from the manifest (``copy_`` would otherwise
        broadcast a ``[1, ...]`` leaf into ``[F, ...]`` without a word), and
        ``IOError`` when a file's crc32 differs from the manifest's."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        entries = self.manifest(step)["leaves"]
        named = named_leaves(template)
        saved, want = [e["name"] for e in entries], [n for n, _ in named]
        if saved != want:
            raise ValueError(
                f"checkpoint step {step} in {self.dir} does not fit the template: "
                f"saved but not in the template {sorted(set(saved) - set(want))}, "
                f"in the template but not saved {sorted(set(want) - set(saved))}"
                + ("" if set(saved) != set(want) else " (the same names in "
                   "another order)"))
        for (name, leaf), ent in zip(named, entries):
            shape, dtype = _spec(leaf)
            if shape != ent["shape"] or dtype != ent["dtype"]:
                hint = (" (a generator's state fits only a generator of the "
                        "same device type)"
                        if isinstance(leaf, torch.Generator) else "")
                raise ValueError(
                    f"checkpoint leaf {name} is {ent['dtype']}{ent['shape']}, "
                    f"the template's {dtype}{shape}{hint}")
        values = [read_leaf(d, ent) for ent in entries]
        with torch.no_grad():
            for (_, leaf), value in zip(named, values):
                if isinstance(leaf, torch.Generator):
                    leaf.set_state(value)
                else:
                    leaf.copy_(value)
        return template


class AsyncCheckpointer(Checkpointer):
    """``save_async()``: snapshot now, write in the background.

    ``save_async`` takes the snapshot before it returns, since the caller's
    next epoch writes the live tensors in place.  With
    ``overlap_transfer=True`` (the default) it clones every CUDA leaf on the
    current stream, so each clone is ordered before any later write, and
    records an event after them; the device-to-host copy leaves the
    caller's thread.  The worker thread starts the copies of the clones into
    pinned host buffers on a side stream that waits on that event, calls
    ``record_stream`` so that the caching allocator does not hand a clone's
    memory out while its copy is in flight, waits for the copies, then
    computes the crc and writes.  The pinned buffers, two sets, are reused
    from save to save while the leaves keep their shapes (allocating ~100
    MB of pinned memory takes tens of ms, which the worker pays, once a
    set).  CPU leaves and generator states are copied on the caller's
    thread, as every leaf is with ``overlap_transfer=False``.

    The queue is double-buffered, as the reference's (``max_inflight=1``):
    one snapshot being written and one queued; a third ``save_async`` blocks
    until the oldest write completes.  A write that fails is raised from
    :meth:`wait` or :meth:`close`."""

    def __init__(self, directory, keep: int = 3, overlap_transfer: bool = True):
        super().__init__(directory, keep)
        self.overlap_transfer = overlap_transfer
        self._q: queue.Queue = queue.Queue()
        self._free: queue.Queue = queue.Queue()     # host buffer sets not in flight
        for _ in range(2):
            self._free.put([])
        self._side: torch.cuda.Stream | None = None  # the worker's copy stream
        self._err: list[BaseException] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def save_async(self, step: int, state) -> None:
        if not self._worker.is_alive():
            raise RuntimeError(f"the checkpointer of {self.dir} is closed")
        named = named_leaves(state)
        values, ready = self._snapshot([leaf for _, leaf in named])
        host = self._free.get()              # blocks while two are in flight
        self._q.put((step, [n for n, _ in named], values, ready, host))

    def _snapshot(self, leaves: list[Leaf]):
        """The leaves' values as of now, and the event after the clones
        taken on the card (None when there are none)."""
        values = []
        for leaf in leaves:
            if isinstance(leaf, torch.Generator):
                values.append(leaf.get_state())
            elif leaf.is_cuda and self.overlap_transfer:
                values.append(leaf.detach().clone())
            else:
                values.append(leaf.detach().to("cpu", copy=True))
        on_card = [v for v in values if v.is_cuda]
        if not on_card:
            return values, None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(on_card[0].device))
        return values, ready

    def _run(self) -> None:
        while (item := self._q.get()) is not None:
            step, names, values, ready, host = item
            try:
                self._to_host(values, ready, host)
                self._write(step, names, host)
            except Exception as e:  # raised again from wait()
                self._err.append(e)
            finally:
                self._free.put(host)
                self._q.task_done()
        self._q.task_done()

    def _to_host(self, values: list[torch.Tensor], ready, host: list) -> None:
        """Fill ``host`` with ``values``: the card's clones copied into pinned
        buffers on the side stream after ``ready`` (and waited for), host
        values as they are."""
        del host[len(values):]
        host.extend([None] * (len(values) - len(host)))
        pending = []
        for i, v in enumerate(values):
            if not v.is_cuda:
                host[i] = v
                continue
            buf = host[i]
            if (buf is None or buf.shape != v.shape or buf.dtype != v.dtype
                    or not buf.is_pinned()):
                buf = host[i] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            pending.append((buf, v))
        if not pending:
            return
        if self._side is None:
            self._side = torch.cuda.Stream(pending[0][1].device)
        self._side.wait_event(ready)
        with torch.cuda.stream(self._side):
            for buf, v in pending:
                buf.copy_(v, non_blocking=True)
                v.record_stream(self._side)
        copied = torch.cuda.Event()
        copied.record(self._side)
        copied.synchronize()

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err.pop()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._worker.is_alive():
                self._q.put(None)
                self._worker.join()
