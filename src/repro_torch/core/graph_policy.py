"""Decima-style graph policy: message passing over the topology DAG.

Port of ``repro/core/graph_policy.py``, batched over a fleet of lanes.  The
policy reads the executor graph (per-node features, and the edge index and
weight arrays of the routing matrix R) through a small segment-sum
message-passing network, with a per-executor placement head: ``q[i, j]``
scores moving executor ``i`` to machine ``j``, DQN's move space.

Padding is exact:

  * node embeddings are multiplied by ``node_mask`` after every layer, so
    padded nodes carry zeros;
  * padded edges carry the sacrificial index ``N`` and weight 0: the
    gather reads a zero row appended to each lane (the reference's gather
    clamps the index to ``N − 1``; times weight 0 either gives 0), and the
    scatter runs over ``N + 1`` segments a lane, the extra one dropped;
  * Q rows of padded nodes are ``-inf`` and the ε move is drawn over valid
    moves only.

Lane ``f``'s node ``i`` is row ``f·(N + 1) + i`` of one flat node table,
so a fleet whose lanes carry different DAGs gathers and scatters all its
edges with one ``index_select`` and one ``index_add_``.  On a plain
``SchedulingEnv`` the one graph lives in the config (as tuples); on a
``StructuralSchedulingEnv`` each lane's graph arrives in its
:class:`~repro_torch.dsdps.structural.GraphEnvParams`.  Training is the
Stream Q(λ) recipe (traces, ObGD, running reward statistics, which survive
``update``).  Parameters are a dict of fleet-stacked tensors, updated in
place."""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core.dqn import apply_move
from repro_torch.core.exploration import EpsilonSchedule
from repro_torch.core.streaming import (gumbel, obgd_step,
                                        reward_norm_update, trace_decay_add)
from repro_torch.device import resolve_device
from repro_torch.dsdps.structural import GraphEnvParams


@dataclasses.dataclass(frozen=True)
class GraphPolicyConfig:
    """Sizes, and on a plain env the static graph as tuples (``static_*``
    are None on structural envs, whose lanes carry their graphs)."""

    n_executors: int             # padded envelope size N
    n_machines: int
    n_spouts: int                # padded spout count S
    gamma: float = 0.99
    lam: float = 0.9             # eligibility-trace decay λ
    lr: float = 1.0              # ObGD base stepsize
    kappa: float = 3.0           # ObGD overshoot margin
    hidden: int = 16             # node embedding width
    msg_steps: int = 2           # message-passing rounds
    reward_scale: float = 0.25
    eps: EpsilonSchedule = EpsilonSchedule(decay_epochs=300)
    static_spouts: tuple | None = None       # spout executor ids
    static_edge_src: tuple | None = None     # R edge endpoints ...
    static_edge_dst: tuple | None = None
    static_edge_w: tuple | None = None       # ... and weights R[src, dst]

    @property
    def num_actions(self) -> int:
        return self.n_executors * self.n_machines

    @property
    def n_features(self) -> int:
        # X row + [service, bytes, out_mass, in_mass, spout_rate, is_spout,
        # mask]: per-node widths only, so parameter shapes are the same at
        # every padding envelope
        return self.n_machines + 7

    @functools.cached_property
    def _static_graphs(self) -> dict:
        """The static graph's tensors per device (filled by
        :func:`_graph_arrays`; not part of equality)."""
        return {}


@dataclasses.dataclass
class GraphPolicyState:
    qnet: dict                   # {"gnn": {enc, mp0.., head}}: {"w", "b"} [F, ...]
    z: dict                      # eligibility traces, same structure
    delta: torch.Tensor          # [F] pending TD error
    epoch: torch.Tensor          # [F] int32
    r_mean: torch.Tensor         # [F]
    r_var: torch.Tensor          # [F]
    r_count: torch.Tensor        # [F] int32

    @property
    def fleet(self) -> int:
        return self.epoch.shape[0]


def leaves(tree: dict) -> list[torch.Tensor]:
    """A param dict's tensors in sorted key order (``jax.tree.leaves``'s)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_map(fn, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# Graph plumbing: one view over both param flavours, on the flat node table.
# --------------------------------------------------------------------------
class _Graph(NamedTuple):
    node_mask: torch.Tensor      # [F, N]
    spout_onehot: torch.Tensor   # [S, N] or [F, S, N]
    src: torch.Tensor            # [F·E] int64 rows of the [F·(N + 1)] node table
    dst: torch.Tensor            # [F·E]
    edge_w: torch.Tensor         # [F·E, 1]


def _static_graph(cfg: GraphPolicyConfig, device) -> dict:
    key = str(device)
    cache = cfg._static_graphs
    if key not in cache:
        if cfg.static_edge_src is None:
            raise ValueError(
                "graph_policy built without a static graph needs GraphEnvParams "
                "(StructuralSchedulingEnv) at select/observe time")
        n = cfg.n_executors
        sp = np.zeros((cfg.n_spouts, n), np.float32)
        sp[np.arange(len(cfg.static_spouts)), list(cfg.static_spouts)] = 1.0
        cache[key] = dict(
            node_mask=torch.ones(n, device=device),
            spout_onehot=torch.as_tensor(sp, device=device),
            edge_src=torch.as_tensor(cfg.static_edge_src, dtype=torch.int64,
                                     device=device),
            edge_dst=torch.as_tensor(cfg.static_edge_dst, dtype=torch.int64,
                                     device=device),
            edge_w=torch.as_tensor(cfg.static_edge_w, dtype=torch.float32,
                                   device=device))
    return cache[key]


def _graph_arrays(cfg: GraphPolicyConfig, env_params, fleet: int,
                  device) -> _Graph:
    """The graph each lane runs on: its own GraphEnvParams fields on a
    structural env (one copy or one per lane), the config's on a plain one;
    edges as rows of the flat ``[F·(N + 1)]`` node table."""
    if isinstance(env_params, GraphEnvParams):
        g = dict(node_mask=env_params.node_mask,
                 spout_onehot=env_params.spout_onehot,
                 edge_src=env_params.edge_src, edge_dst=env_params.edge_dst,
                 edge_w=env_params.edge_w)
    else:
        g = _static_graph(cfg, device)
    n = cfg.n_executors
    offset = torch.arange(fleet, device=device)[:, None] * (n + 1)

    def rows(idx):
        return (idx.to(torch.int64) + offset).reshape(-1)

    return _Graph(
        node_mask=g["node_mask"].expand(fleet, n),
        spout_onehot=g["spout_onehot"],
        src=rows(g["edge_src"]), dst=rows(g["edge_dst"]),
        edge_w=g["edge_w"].expand(fleet, -1).reshape(-1, 1))


def _features(cfg: GraphPolicyConfig, s_vec: torch.Tensor, env_params,
              graph: _Graph) -> torch.Tensor:
    """Per-node features ``[F, N, n_features]`` from the flat state vector
    (``concat(X.reshape(-1), w_norm)``) and the params."""
    F = s_vec.shape[0]
    n, m = cfg.n_executors, cfg.n_machines
    X = s_vec[:, : n * m].reshape(F, n, m)
    w_norm = s_vec[:, n * m:]                                  # [F, S], 0 on padding
    node_w = (graph.spout_onehot * w_norm[:, :, None]).sum(1)  # [F, N]
    is_spout = graph.spout_onehot.sum(-2).expand(F, n)
    routing = env_params.routing
    cols = [X] + [c.expand(F, n)[..., None] for c in (
        env_params.service_ms,
        env_params.tuple_bytes / 1024.0,
        routing.sum(-1),                                       # selectivity × fan-out
        routing.sum(-2),                                       # upstream mass
        node_w, is_spout, graph.node_mask)]
    return torch.cat(cols, dim=-1) * graph.node_mask[..., None]


# --------------------------------------------------------------------------
# The Q network: segment-sum message passing + per-executor placement head.
# --------------------------------------------------------------------------
def _linear_init(din: int, dout: int, fleet: int, gen, device,
                 bias: bool = False) -> dict:
    """``w ~ N(0, 1/din)`` (the reference's ``nn.linear_init``), zero bias."""
    p = {"w": torch.randn(fleet, din, dout, generator=gen, device=device)
         / float(np.sqrt(din))}
    if bias:
        p["b"] = torch.zeros(fleet, dout, device=device)
    return p


def init_qnet(cfg: GraphPolicyConfig, fleet: int,
              gen: torch.Generator | None = None,
              device: str | torch.device | None = None) -> dict:
    """Fresh fleet-stacked parameters on ``device`` (default CUDA)."""
    device = resolve_device(device)
    h = cfg.hidden
    gnn = {"enc": _linear_init(cfg.n_features, h, fleet, gen, device)}
    for t in range(cfg.msg_steps):
        gnn[f"mp{t}"] = {k: _linear_init(h, h, fleet, gen, device)
                         for k in ("self", "fwd", "bwd")}
    gnn["head"] = _linear_init(2 * h + cfg.n_machines, cfg.n_machines, fleet,
                               gen, device, bias=True)
    return tree_map(lambda x: x.requires_grad_(True), {"gnn": gnn})


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = torch.bmm(x, p["w"])
    if "b" in p:
        y = y + p["b"][:, None, :]
    return y


def _propagate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               edge_w: torch.Tensor) -> torch.Tensor:
    """``out[f, i] = Σ_{e: dst_e = i} w_e · h[f, src_e]`` for every lane at
    once: rows of the flat node table, a zero row at each lane's index N
    (the sacrificial source), and a dropped segment N (the sacrificial
    destination)."""
    F, n, H = h.shape
    table = torch.cat([h, h.new_zeros(F, 1, H)], 1).reshape(F * (n + 1), H)
    msg = edge_w * table.index_select(0, src)
    out = table.new_zeros(F * (n + 1), H).index_add_(0, dst, msg)
    return out.reshape(F, n + 1, H)[:, :n]


def apply_qnet(params: dict, feat: torch.Tensor, graph: _Graph,
               cfg: GraphPolicyConfig) -> torch.Tensor:
    """Raw per-move scores ``q [F, N, M]`` (unmasked).  Padded nodes stay
    zero through every layer."""
    g = params["gnn"]
    mask = graph.node_mask[..., None]
    h = torch.relu(_linear(g["enc"], feat)) * mask
    for t in range(cfg.msg_steps):
        mp = g[f"mp{t}"]
        fwd = _propagate(h, graph.src, graph.dst, graph.edge_w)
        bwd = _propagate(h, graph.dst, graph.src, graph.edge_w)
        h = torch.relu(_linear(mp["self"], h) + _linear(mp["fwd"], fwd)
                       + _linear(mp["bwd"], bwd)) * mask
    n_real = torch.clamp(graph.node_mask.sum(-1), min=1.0)[:, None]   # [F, 1]
    pooled = h.sum(1) / n_real                                        # [F, H]
    # machine occupancy straight off the (masked) assignment columns
    occ = feat[..., : cfg.n_machines].sum(1) / n_real                 # [F, M]
    ctx = torch.cat([pooled, occ], -1)
    hg = torch.cat([h, ctx[:, None, :].expand(-1, h.shape[1], -1)], -1)
    return _linear(g["head"], hg)                                     # [F, N, M]


def _masked(q: torch.Tensor, graph: _Graph) -> torch.Tensor:
    return torch.where(graph.node_mask[..., None] > 0.5, q, -torch.inf)


# --------------------------------------------------------------------------
# The Agent-interface adapter (Stream Q(λ) training).
# --------------------------------------------------------------------------
def init_state(gen: torch.Generator | None, cfg: GraphPolicyConfig, fleet: int,
               device: str | torch.device | None = None) -> GraphPolicyState:
    device = resolve_device(device)
    q = init_qnet(cfg, fleet, gen, device)
    return GraphPolicyState(
        qnet=q, z=tree_map(lambda x: torch.zeros_like(x, requires_grad=False), q),
        delta=torch.zeros(fleet, device=device),
        epoch=torch.zeros(fleet, dtype=torch.int32, device=device),
        r_mean=torch.zeros(fleet, device=device),
        r_var=torch.ones(fleet, device=device),
        r_count=torch.zeros(fleet, dtype=torch.int32, device=device),
    )


def _agent_init(gen, cfg: GraphPolicyConfig, fleet: int, device, env_params=None):
    return init_state(gen, cfg, fleet, device)


@torch.no_grad()
def _agent_select(cfg: GraphPolicyConfig, state, s_vec, env_state, env_params,
                  explore, draws, gen):
    """Masked ε-greedy: the random move is uniform over valid moves,
    ``argmax(gumbel + where(valid, 0, −inf))`` over the flat ``N·M``."""
    F = s_vec.shape[0]
    graph = _graph_arrays(cfg, env_params, F, s_vec.device)
    feat = _features(cfg, s_vec, env_params, graph)
    flat = _masked(apply_qnet(state.qnet, feat, graph, cfg), graph).reshape(F, -1)
    greedy_move = flat.argmax(-1)
    if explore:
        if draws is not None:
            add, g = draws.explore_add, draws.explore_gumbel.reshape(F, -1)
            if add.is_floating_point():           # draw_epoch's uniform coin
                add = add < cfg.eps(state.epoch)
        else:
            add = torch.rand(F, generator=gen, device=s_vec.device) < cfg.eps(
                state.epoch)
            g = gumbel(flat.shape, gen, s_vec.device)
        rand_move = (g + torch.where(torch.isfinite(flat), 0.0, -torch.inf)).argmax(-1)
        move = torch.where(add, rand_move, greedy_move)
    else:
        move = greedy_move
    greedy = (move == greedy_move).to(torch.float32)
    n, m = cfg.n_executors, cfg.n_machines
    action = apply_move(s_vec[:, : n * m].reshape(F, n, m), move, m)
    # observe needs the graph for Q(s'); aux carries the params to it
    return action, (move, greedy, env_params)


def _agent_observe(cfg: GraphPolicyConfig, state, s_vec, aux, reward, s_next):
    move, greedy, env_params = aux
    F = s_vec.shape[0]
    graph = _graph_arrays(cfg, env_params, F, s_vec.device)
    r_std, state.r_mean, state.r_var, state.r_count = reward_norm_update(
        reward, state.r_mean, state.r_var, state.r_count,
        scale=cfg.reward_scale)
    feat = _features(cfg, s_vec, env_params, graph)
    feat_next = _features(cfg, s_next, env_params, graph)
    params = leaves(state.qnet)
    with torch.no_grad():
        q_next = _masked(apply_qnet(state.qnet, feat_next, graph, cfg),
                         graph).reshape(F, -1).max(-1).values
    with torch.enable_grad():
        q_sa = apply_qnet(state.qnet, feat, graph, cfg).reshape(F, -1).gather(
            -1, move[:, None])[:, 0]
        grads = torch.autograd.grad(q_sa.sum(), params)
    state.delta = r_std + cfg.gamma * q_next - q_sa.detach()
    # Watkins Q(λ): a non-greedy move cuts the trace before accumulation
    trace_decay_add(leaves(state.z), grads, cfg.gamma * cfg.lam * greedy)
    return state


def _agent_update(cfg: GraphPolicyConfig, state, idx, gen):
    obgd_step(leaves(state.qnet), leaves(state.z), state.delta, cfg.lr,
              cfg.kappa)
    state.delta = torch.zeros_like(state.delta)
    return state


def _agent_tick(cfg: GraphPolicyConfig, state):
    state.epoch = state.epoch + 1
    return state


def as_agent(cfg: GraphPolicyConfig) -> api.Agent:
    """The graph policy as a pluggable Agent bundle."""
    return api.Agent(name="graph_policy", cfg=cfg, init_fn=_agent_init,
                     select_fn=_agent_select, observe_fn=_agent_observe,
                     update_fn=_agent_update, tick_fn=_agent_tick)


def agent_factory(env, **overrides) -> api.Agent:
    """Registry hook: a structural env contributes its padding envelope; a
    plain ``SchedulingEnv`` puts its one graph into the config."""
    cfg = overrides.pop("cfg", None)
    family = getattr(env, "family", None)      # None: not an env of ENV_FAMILIES
    if cfg is None:
        if family == "scheduling" and env.structural:
            cfg = GraphPolicyConfig(
                n_executors=env.N, n_machines=env.M,
                n_spouts=env.envelope.max_spouts, **overrides)
        elif family == "scheduling":           # plain SchedulingEnv
            topo = env.topo
            n_edges = int(np.count_nonzero(topo.routing_matrix(env.seed)))
            gobs = topo.to_graph_obs(topo.num_executors, n_edges, seed=env.seed)
            cfg = GraphPolicyConfig(
                n_executors=env.N, n_machines=env.M,
                n_spouts=env.workload.num_spouts,
                static_spouts=tuple(int(i) for i in topo.spout_executors),
                static_edge_src=tuple(int(i) for i in gobs.edge_src),
                static_edge_dst=tuple(int(i) for i in gobs.edge_dst),
                static_edge_w=tuple(float(x) for x in gobs.edge_w),
                **overrides)
        else:
            raise TypeError(
                "graph_policy needs a topology-bearing env (SchedulingEnv "
                f"or StructuralSchedulingEnv); got {type(env).__name__}")
    return as_agent(cfg)


api.register_agent("graph_policy", agent_factory, families=("scheduling",))


def graph_param_specs(params, mesh):
    """Partition specs for a graph-policy parameter tree under the port's
    name-rule sharding policy: the GNN layer matrices land on the mesh's
    "model" axis (``fsdp=False``: the data axes carry fleet lanes, not
    parameter shards).  See ``sharding/policy.py``'s ``gnn/`` rule."""
    from repro_torch.sharding.policy import ShardingPolicy
    return ShardingPolicy(mesh, None, fsdp=False).params_tree(params)
