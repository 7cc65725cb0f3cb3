"""The paper's evaluation applications (§4.1) at the paper's executor
counts, plus the two structural topologies — a copy of
``repro/dsdps/apps.py``.

Service demands / tuple sizes / arrival rates are the reference's
calibration constants (round-robin on the large-scale setup reproduces the
paper's measured stabilized latencies)."""
from __future__ import annotations

from repro_torch.dsdps.topology import FIELDS, SHUFFLE, Component, Edge, Topology
from repro_torch.dsdps.workload import WorkloadProcess


def continuous_queries(scale: str = "large") -> Topology:
    """spout -> Query -> File  (select-query over an in-memory table)."""
    counts = {
        "small": (2, 9, 9),
        "medium": (5, 25, 20),
        "large": (10, 45, 45),
    }[scale]
    sp, q, f = counts
    return Topology(
        name=f"continuous_queries_{scale}",
        components=[
            Component("spout", sp, cpu_ms_per_tuple=0.03, selectivity=1.0,
                      tuple_bytes=180, is_spout=True),
            Component("query", q, cpu_ms_per_tuple=0.55, selectivity=0.30,
                      tuple_bytes=320),
            Component("file", f, cpu_ms_per_tuple=0.35, selectivity=0.0,
                      tuple_bytes=64),
        ],
        edges=[
            Edge("spout", "query", SHUFFLE),
            Edge("query", "file", SHUFFLE),
        ],
    )


def log_stream_processing() -> Topology:
    """spout -> LogRules -> {Indexer -> DB_i, Counter -> DB_c} (ack joins)."""
    return Topology(
        name="log_stream_processing",
        components=[
            Component("spout", 10, cpu_ms_per_tuple=0.05, selectivity=1.0,
                      tuple_bytes=900, is_spout=True),
            Component("logrules", 20, cpu_ms_per_tuple=1.10, selectivity=1.0,
                      tuple_bytes=700),
            Component("indexer", 20, cpu_ms_per_tuple=0.90, selectivity=1.0,
                      tuple_bytes=500),
            Component("counter", 20, cpu_ms_per_tuple=0.60, selectivity=1.0,
                      tuple_bytes=96),
            Component("db_index", 15, cpu_ms_per_tuple=1.30, selectivity=0.0,
                      tuple_bytes=64),
            Component("db_count", 15, cpu_ms_per_tuple=0.80, selectivity=0.0,
                      tuple_bytes=64),
        ],
        edges=[
            Edge("spout", "logrules", SHUFFLE),
            Edge("logrules", "indexer", SHUFFLE),
            Edge("logrules", "counter", SHUFFLE),
            Edge("indexer", "db_index", SHUFFLE),
            Edge("counter", "db_count", FIELDS, skew=0.6),
        ],
    )


def word_count() -> Topology:
    """spout -> SplitSentence -> WordCount (fields) -> Database."""
    return Topology(
        name="word_count",
        components=[
            Component("spout", 10, cpu_ms_per_tuple=0.04, selectivity=1.0,
                      tuple_bytes=600, is_spout=True),
            Component("split", 30, cpu_ms_per_tuple=0.28, selectivity=8.0,
                      tuple_bytes=48),
            Component("count", 30, cpu_ms_per_tuple=0.06, selectivity=0.12,
                      tuple_bytes=40),
            Component("db", 30, cpu_ms_per_tuple=0.45, selectivity=0.0,
                      tuple_bytes=40),
        ],
        edges=[
            Edge("spout", "split", SHUFFLE),
            Edge("split", "count", FIELDS, skew=0.8),
            Edge("count", "db", SHUFFLE),
        ],
    )


def diamond(parallelism: int = 4) -> Topology:
    """spout -> fork -> {left, right} -> merge: two parallel branches whose
    completion times max-join at the merge bolt."""
    return Topology(
        name="diamond",
        components=[
            Component("spout", 2, cpu_ms_per_tuple=0.03, selectivity=1.0,
                      tuple_bytes=200, is_spout=True),
            Component("fork", parallelism, cpu_ms_per_tuple=0.30,
                      selectivity=2.0, tuple_bytes=260),
            Component("left", parallelism, cpu_ms_per_tuple=0.55,
                      selectivity=0.5, tuple_bytes=180),
            Component("right", parallelism, cpu_ms_per_tuple=0.40,
                      selectivity=0.5, tuple_bytes=220),
            Component("merge", parallelism, cpu_ms_per_tuple=0.35,
                      selectivity=0.0, tuple_bytes=64),
        ],
        edges=[
            Edge("spout", "fork", SHUFFLE),
            Edge("fork", "left", SHUFFLE),
            Edge("fork", "right", FIELDS, skew=0.5),
            Edge("left", "merge", SHUFFLE),
            Edge("right", "merge", SHUFFLE),
        ],
    )


def wide_fanout(branches: int = 4) -> Topology:
    """spout -> router -> {b0..b(k-1)} -> collector: completion is the max
    over many sibling branches."""
    comps = [
        Component("spout", 2, cpu_ms_per_tuple=0.03, selectivity=1.0,
                  tuple_bytes=240, is_spout=True),
        Component("router", 3, cpu_ms_per_tuple=0.20, selectivity=1.0,
                  tuple_bytes=240),
    ]
    edges = [Edge("spout", "router", SHUFFLE)]
    for b in range(branches):
        comps.append(Component(f"b{b}", 2, cpu_ms_per_tuple=0.35 + 0.05 * b,
                               selectivity=1.0 / branches, tuple_bytes=160))
        edges.append(Edge("router", f"b{b}", SHUFFLE))
        edges.append(Edge(f"b{b}", "collector", SHUFFLE))
    comps.append(Component("collector", 3, cpu_ms_per_tuple=0.25,
                           selectivity=0.0, tuple_bytes=64))
    return Topology(name="wide_fanout", components=comps, edges=edges)


def default_workload(topo: Topology) -> WorkloadProcess:
    """Spout arrival rates (tuples/sec per spout executor) for each app:
    moderate utilization under round-robin (§4.2)."""
    per_spout = {
        "continuous_queries_small": 1500.0,
        "continuous_queries_medium": 1300.0,
        "continuous_queries_large": 1100.0,
        "log_stream_processing": 130.0,
        "word_count": 550.0,
        "diamond": 900.0,
        "wide_fanout": 800.0,
    }[topo.name]
    n_spout = int(len(topo.spout_executors))
    return WorkloadProcess(base_rates=(per_spout,) * n_spout)


ALL_APPS = {
    "cq_small": lambda: continuous_queries("small"),
    "cq_medium": lambda: continuous_queries("medium"),
    "cq_large": lambda: continuous_queries("large"),
    "log_stream": log_stream_processing,
    "word_count": word_count,
    "diamond": diamond,
    "wide_fanout": wide_fanout,
}


# the default structural-fleet topology set: chain (cq_small), diamond and
# wide fan-out, three DAG shapes padded into one envelope
# (dsdps/structural.py and the dag_shapes scenario)
STRUCTURAL_APPS = ("cq_small", "diamond", "wide_fanout")


def structural_topologies() -> list[Topology]:
    return [ALL_APPS[name]() for name in STRUCTURAL_APPS]
