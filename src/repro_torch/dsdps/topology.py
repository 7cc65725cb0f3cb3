"""Storm-like logical topology: spouts, bolts, groupings, executor expansion.

A numpy copy of ``repro/dsdps/topology.py`` (same semantics, same numpy
RNG use, so the routing matrix is bit-identical).  A topology is a DAG of
*components*; each runs as ``parallelism`` executors.  Edge groupings:

  - ``shuffle``: uniform random split (1/P_down each)
  - ``fields``:  hash-partitioned by key -> fixed (possibly skewed) split
  - ``global``:  all tuples to executor 0 of the downstream component
  - ``all``:     every tuple replicated to every downstream executor

``R[i, k]`` is the expected number of tuples forwarded to executor ``k``
per tuple processed at executor ``i`` (selectivity folded in)."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np

SHUFFLE = "shuffle"
FIELDS = "fields"
GLOBAL = "global"
ALL = "all"


class GraphObs(NamedTuple):
    """Padded/masked executor-graph observation of one topology (numpy).

    Node arrays have length ``max_execs``, edge arrays ``max_edges``.
    Padded edges point at the sacrificial node index ``max_execs`` (one past
    the last real slot) with weight 0: a gather reads a zero row there, and a
    scatter over ``max_execs + 1`` segments drops what lands in the last one."""

    service_ms: np.ndarray    # [max_execs] CPU demand per tuple (0 on padding)
    tuple_bytes: np.ndarray   # [max_execs] emitted tuple size (0 on padding)
    is_spout: np.ndarray      # [max_execs] 1.0 on spout executors
    out_mass: np.ndarray      # [max_execs] row sum of R (selectivity x fan-out)
    in_mass: np.ndarray       # [max_execs] column sum of R
    node_mask: np.ndarray     # [max_execs] 1.0 on real executors
    edge_src: np.ndarray      # [max_edges] int32; padded entries = max_execs
    edge_dst: np.ndarray      # [max_edges] int32; padded entries = max_execs
    edge_w: np.ndarray        # [max_edges] R[src, dst]; 0.0 on padding
    edge_mask: np.ndarray     # [max_edges] 1.0 on real edges
    num_executors: int        # real executor count (<= max_execs)
    num_edges: int            # real edge count (<= max_edges)


@dataclasses.dataclass(frozen=True)
class Component:
    """One spout or bolt."""

    name: str
    parallelism: int                 # number of executors
    cpu_ms_per_tuple: float          # mean CPU service demand per tuple
    selectivity: float = 1.0         # tuples emitted per tuple consumed
    tuple_bytes: int = 256           # mean emitted tuple size
    is_spout: bool = False


@dataclasses.dataclass(frozen=True)
class Edge:
    src: str
    dst: str
    grouping: str = SHUFFLE
    # fields-grouping skew: Zipf exponent over downstream executors (0 = even)
    skew: float = 0.0


@dataclasses.dataclass
class Topology:
    """Executor-level expansion of a component DAG."""

    name: str
    components: Sequence[Component]
    edges: Sequence[Edge]

    def __post_init__(self) -> None:
        names = [c.name for c in self.components]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate component names in {self.name}")
        self._index = {c.name: ci for ci, c in enumerate(self.components)}
        for e in self.edges:
            if e.src not in self._index or e.dst not in self._index:
                raise ValueError(f"edge {e.src}->{e.dst} references unknown component")
            if e.grouping not in (SHUFFLE, FIELDS, GLOBAL, ALL):
                raise ValueError(f"unknown grouping {e.grouping!r}")
        starts, n = [], 0
        for c in self.components:
            starts.append(n)
            n += c.parallelism
        self._starts = starts
        self.num_executors = n
        self._validate_dag()

    def component(self, name: str) -> Component:
        return self.components[self._index[name]]

    def executor_slice(self, name: str) -> range:
        ci = self._index[name]
        s = self._starts[ci]
        return range(s, s + self.components[ci].parallelism)

    @property
    def spout_executors(self) -> np.ndarray:
        ids = []
        for c in self.components:
            if c.is_spout:
                ids.extend(self.executor_slice(c.name))
        return np.asarray(ids, dtype=np.int32)

    @property
    def executor_component(self) -> np.ndarray:
        """component index of each executor"""
        out = np.zeros(self.num_executors, dtype=np.int32)
        for ci, c in enumerate(self.components):
            out[list(self.executor_slice(c.name))] = ci
        return out

    def _validate_dag(self) -> None:
        # Kahn's algorithm over components; the order feeds the solver's
        # reverse-topological completion-time recursion
        nc = len(self.components)
        indeg = np.zeros(nc, dtype=np.int64)
        adj: list[list[int]] = [[] for _ in range(nc)]
        for e in self.edges:
            s, d = self._index[e.src], self._index[e.dst]
            adj[s].append(d)
            indeg[d] += 1
        order, queue = [], [i for i in range(nc) if indeg[i] == 0]
        while queue:
            u = queue.pop()
            order.append(u)
            for v in adj[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    queue.append(v)
        if len(order) != nc:
            raise ValueError(f"topology {self.name} has a cycle")
        self.topo_order = order

    def routing_matrix(self, seed: int = 0) -> np.ndarray:
        """R[i, k]: expected tuples forwarded to executor k per tuple
        processed at executor i (selectivity of i folded in)."""
        rng = np.random.default_rng(seed)
        n = self.num_executors
        R = np.zeros((n, n), dtype=np.float64)
        for e in self.edges:
            src_c = self.component(e.src)
            src_ids = list(self.executor_slice(e.src))
            dst_ids = list(self.executor_slice(e.dst))
            p = len(dst_ids)
            if e.grouping == SHUFFLE:
                frac = np.full(p, 1.0 / p)
            elif e.grouping == FIELDS:
                # Zipf-ish key skew, deterministic per (topology, edge, seed)
                w = (np.arange(1, p + 1, dtype=np.float64)) ** (-e.skew)
                w = rng.permutation(w)
                frac = w / w.sum()
            elif e.grouping == GLOBAL:
                frac = np.zeros(p)
                frac[0] = 1.0
            else:  # ALL
                frac = np.ones(p)
            for i in src_ids:
                R[i, dst_ids] += src_c.selectivity * frac
        return R

    def service_demand_ms(self) -> np.ndarray:
        """CPU ms per tuple for each executor."""
        out = np.zeros(self.num_executors, dtype=np.float64)
        for c in self.components:
            out[list(self.executor_slice(c.name))] = c.cpu_ms_per_tuple
        return out

    def tuple_bytes(self) -> np.ndarray:
        out = np.zeros(self.num_executors, dtype=np.float64)
        for c in self.components:
            out[list(self.executor_slice(c.name))] = c.tuple_bytes
        return out

    def to_graph_obs(self, max_execs: int, max_edges: int,
                     seed: int = 0) -> GraphObs:
        """Executor-graph observation padded to a ``(max_execs, max_edges)``
        envelope.  Edges are the nonzero entries of ``routing_matrix(seed)``
        in row-major order (the real-edge prefix is the same at every
        envelope).  Raises ``ValueError`` naming the topology when it does
        not fit: padding never truncates structure."""
        n = self.num_executors
        R = self.routing_matrix(seed)
        src, dst = np.nonzero(R)
        e = len(src)
        if n > max_execs or e > max_edges:
            raise ValueError(
                f"topology {self.name} exceeds graph envelope: "
                f"{n} executors / {e} edges vs max_execs={max_execs} / "
                f"max_edges={max_edges}")

        def pad_nodes(x: np.ndarray) -> np.ndarray:
            out = np.zeros(max_execs, dtype=np.float32)
            out[:n] = x
            return out

        is_spout = np.zeros(n, dtype=np.float32)
        is_spout[self.spout_executors] = 1.0
        edge_src = np.full(max_edges, max_execs, dtype=np.int32)
        edge_dst = np.full(max_edges, max_execs, dtype=np.int32)
        edge_w = np.zeros(max_edges, dtype=np.float32)
        edge_mask = np.zeros(max_edges, dtype=np.float32)
        edge_src[:e] = src
        edge_dst[:e] = dst
        edge_w[:e] = R[src, dst]
        edge_mask[:e] = 1.0
        return GraphObs(
            service_ms=pad_nodes(self.service_demand_ms()),
            tuple_bytes=pad_nodes(self.tuple_bytes()),
            is_spout=pad_nodes(is_spout),
            out_mass=pad_nodes(R.sum(axis=1)),
            in_mass=pad_nodes(R.sum(axis=0)),
            node_mask=pad_nodes(np.ones(n, dtype=np.float32)),
            edge_src=edge_src, edge_dst=edge_dst, edge_w=edge_w,
            edge_mask=edge_mask, num_executors=n, num_edges=e)

    def describe(self) -> str:
        """The topology as text: its executor count, each component's
        parallelism, cost and selectivity, and each edge's grouping."""
        lines = [f"topology {self.name}: {self.num_executors} executors"]
        for c in self.components:
            kind = "spout" if c.is_spout else "bolt"
            lines.append(
                f"  {kind} {c.name}: x{c.parallelism}, {c.cpu_ms_per_tuple}ms/tuple,"
                f" sel={c.selectivity}"
            )
        for e in self.edges:
            lines.append(f"  {e.src} -[{e.grouping}]-> {e.dst}")
        return "\n".join(lines)
