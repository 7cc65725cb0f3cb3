"""Runtime guards for the fleet loops: the device-sync guard and the
chunk-boundary non-finite sweep.

Port of ``repro/diagnostics/guards.py`` by intent.  The reference's
``jax.transfer_guard`` stops implicit host<->device transfers from
serialising the dispatch stream; in eager PyTorch the same hazard is a call
that waits on the device (``.item()``, ``.cpu()``, ``bool(t)``, a
data-dependent shape), which ``torch.cuda.set_sync_debug_mode`` reports.
:func:`guards` maps the reference's transfer levels onto its modes:

* ``"allow"``    → ``"default"``: nothing is reported;
* ``"log"``      → ``"warn"``: every synchronizing call is counted into
  :attr:`GuardState.syncs` under its call site (``repro_torch/core/ddpg.py:123``:
  the line that called the op, or the innermost caller outside torch), a
  repeated site counted each time;
* ``"disallow"`` → ``"error"``: a synchronizing call raises RuntimeError.

The mode is process-global where the reference's region is a ContextVar, so
:func:`guards` restores the mode it found when it exits, nesting included.
On a machine without CUDA the mode is never touched.

The guard is armed only over the steady state: the fleet runners
(``core/agent.py``, ``fleet/lifecycle.py``) run their whole body under
:func:`lifted` and each chunk's epoch steps under :func:`steady`, which
re-arms the innermost region's level and counts the epochs, so a region's
syncs per steady-state epoch are ``state.n_syncs / state.steady_steps``.
The chunk boundary (the traces' pull, the sweep, the stop test,
compaction, the checkpoint save) runs with the mode lifted, as the
reference lifts ``jax.transfer_guard`` there: its host pulls are explicit
and legal.

:func:`maybe_check_finite` is the NaN/Inf sweep the runners call after each
chunk; inside a ``guards(nan_check=True)`` region it raises
:class:`NonFiniteError` naming every floating leaf that holds a NaN or an
inf, by the dotted names a checkpoint gives it.

No ``CompileCounter``: the reference's jit-cache-miss sentinel counts
retraces of jitted programs, and no path of the port calls
``torch.compile``; a recompile counter comes only with a path that
compiles."""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import pathlib
import sys
import warnings

import torch

from repro_torch.checkpoint.checkpointer import named_leaves

_MODES = {"allow": "default", "log": "warn", "disallow": "error"}
_MODE_NAMES = ("default", "warn", "error")     # get_sync_debug_mode's ints
_SYNC_WARNING = "called a synchronizing CUDA operation"
_THIS = pathlib.Path(__file__).resolve()
_PACKAGE = _THIS.parents[1]
_TORCH = pathlib.Path(torch.__file__).resolve().parent
_WARNINGS = pathlib.Path(warnings.__file__).resolve()


class NonFiniteError(RuntimeError):
    """A guarded fleet carry held NaN/Inf at a chunk boundary."""


@dataclasses.dataclass
class GuardState:
    """Live state of an active :func:`guards` region.  ``syncs`` counts the
    synchronizing calls made while the region's level was ``"log"``, by
    call site; ``steady_steps`` the epochs (or steps) run under
    :func:`steady`."""

    transfer: str
    nan_check: bool
    label: str = ""
    nonfinite: list[str] = dataclasses.field(default_factory=list)
    syncs: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    steady_steps: int = 0

    @property
    def n_syncs(self) -> int:
        return sum(self.syncs.values())

    def sync_report(self, per: str = "steady-state epoch") -> str:
        """``"n synchronizing calls per <per> (s over k): site ×c, ..."``."""
        k = self.steady_steps
        rate = f"{self.n_syncs / k:g}" if k else "n/a"
        sites = ", ".join(f"{site} ×{c}" for site, c in self.syncs.most_common())
        return (f"{rate} synchronizing calls per {per} ({self.n_syncs} over {k})"
                + (f": {sites}" if sites else ""))


_ACTIVE: contextvars.ContextVar[GuardState | None] = contextvars.ContextVar(
    "repro_torch_diagnostics_guards", default=None)


def active() -> GuardState | None:
    """The innermost active guard region, or None."""
    return _ACTIVE.get()


def _set_mode(mode: str) -> str:
    """Set the sync debug mode and return the one it replaced (always
    ``"default"`` on a machine without CUDA, where nothing is set)."""
    if not torch.cuda.is_available():
        return "default"
    prev = _MODE_NAMES[torch.cuda.get_sync_debug_mode()]
    torch.cuda.set_sync_debug_mode(mode)
    return prev


def _short(path: pathlib.Path, lineno: int) -> str:
    if path.is_relative_to(_PACKAGE):
        return f"{path.relative_to(_PACKAGE.parent).as_posix()}:{lineno}"
    return f"{path.name}:{lineno}"


def _site(filename: str, lineno: int) -> str:
    """Where a synchronizing call was made: the warning's own location (the
    Python line that called into the op), or, when that line is inside
    torch's Python code, the innermost frame outside torch, ``warnings`` and
    this module — as ``repro_torch/core/ddpg.py:123`` inside this package,
    ``file.py:line`` outside it."""
    path = pathlib.Path(filename).resolve()
    if not path.is_relative_to(_TORCH):
        return _short(path, lineno)
    frame = sys._getframe(1)
    while frame is not None:
        where = pathlib.Path(frame.f_code.co_filename).resolve()
        if not (where.is_relative_to(_TORCH) or where in (_THIS, _WARNINGS)):
            return _short(where, frame.f_lineno)
        frame = frame.f_back
    return _short(path, lineno)


def _count_syncs(state: GuardState) -> None:
    """Inside a ``warnings.catch_warnings()`` block: count the sync debug
    mode's warnings into ``state`` by site, every one of them (``always``),
    and pass every other warning on."""
    show = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING in str(message):
            state.syncs[_site(filename, lineno)] += 1
        else:
            show(message, category, filename, lineno, file, line)

    warnings.showwarning = record
    warnings.filterwarnings("always", message=f".*{_SYNC_WARNING}")


@contextlib.contextmanager
def guards(transfer: str = "disallow", nan_check: bool = True, label: str = ""):
    """Arm the runtime guards for the enclosed region.

    ``transfer`` — ``"allow"``, ``"log"`` or ``"disallow"``, mapped onto
    ``torch.cuda.set_sync_debug_mode`` as the module docstring says; the
    default, as the reference's, aborts on the first synchronizing call.
    ``nan_check`` — arm :func:`maybe_check_finite` at chunk boundaries.

    Yields the :class:`GuardState`, readable after the region exits."""
    if transfer not in _MODES:
        raise ValueError(f"transfer must be one of {sorted(_MODES)}, got {transfer!r}")
    state = GuardState(transfer, nan_check, label)
    token = _ACTIVE.set(state)
    prev = _set_mode(_MODES[transfer])
    try:
        with warnings.catch_warnings():
            if transfer == "log":
                _count_syncs(state)
            yield state
    finally:
        _set_mode(prev)
        _ACTIVE.reset(token)


@contextlib.contextmanager
def lifted():
    """Boundary work: the sync debug mode at ``"default"`` until the block
    ends (a no-op outside a region)."""
    if _ACTIVE.get() is None:
        yield
        return
    prev = _set_mode("default")
    try:
        yield
    finally:
        _set_mode(prev)


@contextlib.contextmanager
def steady(steps: int = 1):
    """The steady state: the innermost region's level armed again until the
    block ends, and ``steps`` epochs (or steps) added to its count (a no-op
    outside a region)."""
    state = _ACTIVE.get()
    if state is None:
        yield
        return
    state.steady_steps += steps
    prev = _set_mode(_MODES[state.transfer])
    try:
        yield
    finally:
        _set_mode(prev)


def maybe_check_finite(tree, where: str = "") -> None:
    """Chunk-boundary NaN/Inf sweep — a no-op unless a ``guards`` region with
    ``nan_check=True`` is active.

    Walks ``tree`` as a checkpoint does (``checkpoint.named_leaves``),
    counts the non-finite elements of every floating tensor (one pull to
    the host per device, with the guard lifted: an explicit pull, as the
    reference's), appends each offending leaf to the region's
    ``nonfinite`` and raises :class:`NonFiniteError` naming them all."""
    state = _ACTIVE.get()
    if state is None or not state.nan_check:
        return
    leaves = [(name, x) for name, x in named_leaves(tree)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    by_device: dict[torch.device, list[int]] = {}
    for i, (_, x) in enumerate(leaves):
        by_device.setdefault(x.device, []).append(i)
    counts = {}
    with lifted():
        for idx in by_device.values():
            n = torch.stack([(~torch.isfinite(leaves[i][1].detach())).sum()
                             for i in idx]).tolist()
            counts.update(zip(idx, n))
    bad = [f"{name} ({counts[i]}/{x.numel()} non-finite)"
           for i, (name, x) in enumerate(leaves) if counts[i]]
    if bad:
        state.nonfinite.extend(f"{where}: {b}" for b in bad)
        raise NonFiniteError(
            f"non-finite values in fleet carry at {where or 'chunk boundary'}: "
            + "; ".join(bad))
