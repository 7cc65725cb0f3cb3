"""The port's serving control plane (serve/control.py), DDPG's deploy-time
select (``k_override``, ``exact_host_knn``, a batch of slots under one
shared state) and the two serving launchers, against the reference.

The reference's tests/test_control_plane.py cases are mirrored: the
percentile math, FIFO admission under a full slot pool, ``reset_stats``
with requests in flight, batched decisions equal to single selects, the
routing by kind and the error cases.  Across packages the same requests on
the same clusters and carried DDPG weights give the reference's one-hot
actions exactly; ``auto_tune`` may differ only on a near-tie (its two
latencies within 1e-5 under the reference's model)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (assert_exact, env_pair, jax_tree_numpy,
                               to_numpy, to_torch, torch)

from repro.core import ddpg as jddpg
from repro.core import make_agent as jmake_agent
from repro.dsdps import scenarios as jscen
from repro.serve import control as jctl
from repro_torch.core import ddpg as tddpg
from repro_torch.core import convert, make_agent, spaces
from repro_torch.core.convert import (ddpg_state_from_numpy,
                                      env_params_from_numpy)
from repro_torch.dsdps import scenarios as tscen
from repro_torch.launch import drl_control, serve_control
from repro_torch.serve.control import (ControlPlane, ControlService,
                                       DecisionRequest, batched_select,
                                       gather_clusters, latency_stats,
                                       nearest_rank_percentile,
                                       single_select)

TUNE_RTOL = 1e-5
KINDS = ("placement", "rate_control", "auto_tune")


@pytest.fixture(scope="module")
def small():
    return env_pair("cq_small")


@pytest.fixture(scope="module")
def large():
    return env_pair("cq_large")


def _load(env, names, n, seed=0):
    """(rid, cluster, s_vec) synthetic request triples."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        X = np.eye(env.M, dtype=np.float32)[rng.integers(0, env.M, env.N)]
        w = np.exp(rng.normal(0.0, 0.25, env.workload.num_spouts))
        out.append((rid, names[rid % len(names)],
                    np.concatenate([X.reshape(-1), w.astype(np.float32)])))
    return out


def _clusters(jenv, n, seed=1):
    """n reference sample_perturbed clusters and the port's copies."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    jp = [jscen.sample_perturbed(jenv, k) for k in keys]
    return jp, [env_params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
                for p in jp]


def _agents(jenv, tenv, kind, seed=0, **kw):
    """(reference agent, its state, port agent, the carried state)."""
    name = spaces.action_space(kind).default_agent
    ja, ta = jmake_agent(name, jenv, **kw), make_agent(name, tenv, **kw)
    js = ja.init(jax.random.PRNGKey(seed))
    if name == "ddpg":
        ts = ddpg_state_from_numpy(jax_tree_numpy(js), "cpu")
    else:
        ts = ta.init_fleet(None, 1, "cpu")
    return ja, js, ta, ts


def _plane(tenv, kind, n_clusters=3, n_slots=3, seed=0, **kw):
    agent = make_agent(spaces.action_space(kind).default_agent, tenv, **kw)
    plane = ControlPlane(tenv, agent,
                         agent.init_fleet(torch.Generator().manual_seed(seed),
                                          1, "cpu"),
                         kind=kind, n_slots=n_slots)
    gen = torch.Generator().manual_seed(seed + 1)
    for c in range(n_clusters):
        plane.register_cluster(f"c{c}", tscen.sample_perturbed(tenv, gen=gen))
    return plane


def _same_decision(kind, got, want, lats=None):
    """One-hot actions equal; auto_tune may differ on a near-tie only."""
    if kind == "auto_tune" and not np.array_equal(got, want):
        t, j = int(np.argmax(got)), int(np.argmax(want))
        np.testing.assert_allclose(lats[t], lats[j], rtol=TUNE_RTOL)
        return
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# DDPG's deploy-time select
# --------------------------------------------------------------------------
@pytest.mark.parametrize("app", ["cq_small", "cq_large"])
@pytest.mark.parametrize("k_override,exact_host_knn", [
    (None, False), (32, False), (None, True), (32, True)])
def test_ddpg_serving_select_matches_reference(app, k_override, exact_host_knn):
    """Rows [1, R, S] under one carried lane: each row's action equals the
    reference's select_action on it, and the port's select on that row
    alone (batched == single, actions exact)."""
    jenv, tenv = env_pair(app)
    jcfg = jddpg.DDPGConfig(n_executors=jenv.N, n_machines=jenv.M,
                            state_dim=jenv.state_dim, k_nn=8)
    tcfg = tddpg.DDPGConfig(n_executors=tenv.N, n_machines=tenv.M,
                            state_dim=tenv.state_dim, k_nn=8)
    js = jddpg.init_state(jax.random.PRNGKey(3), jcfg)
    ts = ddpg_state_from_numpy(jax_tree_numpy(js), "cpu")
    R = 4
    s = np.stack([sv for _, _, sv in _load(tenv, ("c",), R, seed=4)])
    got = tddpg.select_action(ts, tcfg, to_torch(s)[None], explore=False,
                              exact_host_knn=exact_host_knn,
                              k_override=k_override)
    assert got.shape == (1, R, tenv.N, tenv.M)
    for r in range(R):
        want = jddpg.select_action(jax.random.PRNGKey(0), js, jcfg,
                                   jnp.asarray(s[r]), explore=False,
                                   exact_host_knn=exact_host_knn,
                                   k_override=k_override)
        assert_exact(got[0, r], want)
        alone = tddpg.select_action(ts, tcfg, to_torch(s[r])[None], explore=False,
                                    exact_host_knn=exact_host_knn,
                                    k_override=k_override)
        assert_exact(alone[0], got[0, r])


def test_ddpg_exploring_serving_select_draws_a_coin_per_row(small):
    _, tenv = small
    tcfg = tddpg.DDPGConfig(n_executors=tenv.N, n_machines=tenv.M,
                            state_dim=tenv.state_dim, k_nn=4)
    ts = tddpg.init_state(torch.Generator().manual_seed(0), tcfg, 1, "cpu")
    s = to_torch(np.stack([sv for _, _, sv in _load(tenv, ("c",), 6)]))[None]
    add = torch.tensor([[True, False, True, False, False, True]])
    noise = torch.rand(1, 6, tenv.N, tenv.M, generator=torch.Generator().manual_seed(1))
    got = tddpg.select_action(ts, tcfg, s, explore=True, add=add, noise=noise)
    greedy = tddpg.select_action(ts, tcfg, s, explore=False)
    for r in range(6):
        if not add[0, r]:
            assert_exact(got[0, r], greedy[0, r])
    drawn = tddpg.select_action(ts, tcfg, s, explore=True,
                                gen=torch.Generator().manual_seed(2))
    assert drawn.shape == greedy.shape
    assert torch.equal(drawn.sum(-1), torch.ones(1, 6, tenv.N))


def test_lane_arrays_is_one_lane_of_the_fleet(small):
    _, tenv = small
    tcfg = tddpg.DDPGConfig(n_executors=tenv.N, n_machines=tenv.M,
                            state_dim=tenv.state_dim, k_nn=4)
    fleet = tddpg.init_state(torch.Generator().manual_seed(0), tcfg, 3, "cpu")
    one = convert.ddpg_state_from_numpy(
        convert.lane_arrays(convert.ddpg_state_to_numpy(fleet), 2), "cpu")
    assert one.fleet == 1 and one.replay.states.shape[0] == 1
    s = to_torch(np.stack([sv for _, _, sv in _load(tenv, ("c",), 3)]))
    assert_exact(tddpg.select_action(one, tcfg, s[2:3], explore=False)[0],
                 tddpg.select_action(fleet, tcfg, s, explore=False)[2])
    one.actor.weights[0].data.zero_()           # a copy, not a view
    assert bool(fleet.actor.weights[0][2].abs().sum() > 0)


# --------------------------------------------------------------------------
# nearest-rank percentile math (fixed trace)
# --------------------------------------------------------------------------
def test_nearest_rank_percentile_fixed_trace():
    trace = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert nearest_rank_percentile(trace, 50.0) == 3.0
    assert nearest_rank_percentile(trace, 1.0) == 1.0
    assert nearest_rank_percentile(trace, 99.0) == 5.0
    assert nearest_rank_percentile(trace, 100.0) == 5.0
    t10 = list(range(1, 11))
    assert nearest_rank_percentile(t10, 50.0) == 5
    assert nearest_rank_percentile(t10, 90.0) == 9
    assert nearest_rank_percentile(t10, 91.0) == 10
    with pytest.raises(ValueError):
        nearest_rank_percentile([], 50.0)
    rng = np.random.default_rng(0)
    for n in (1, 7, 256):
        xs = rng.exponential(size=n).tolist()
        for q in (1.0, 50.0, 99.0, 100.0):
            assert nearest_rank_percentile(xs, q) == jctl.nearest_rank_percentile(xs, q)


def test_latency_stats_schema():
    s = latency_stats([2.0, 1.0, 3.0])
    assert s == jctl.latency_stats([2.0, 1.0, 3.0])
    assert s["n"] == 3
    assert s["p50_ms"] == 2.0 and s["p99_ms"] == 3.0
    assert s["mean_ms"] == pytest.approx(2.0)


# --------------------------------------------------------------------------
# FIFO admission / eviction under a full slot pool
# --------------------------------------------------------------------------
def test_fifo_admission_under_full_slot_pool(small):
    jenv, tenv = small
    plane = _plane(tenv, "rate_control", n_slots=2)
    load = _load(tenv, plane.clusters, 7)
    for rid, c, s in load:
        plane.submit(DecisionRequest(rid=rid, cluster=c, s_vec=s))
    assert plane.pending == 7
    batches = []
    while plane.pending:
        batches.append([r.rid for r in plane.step()])
        assert plane.active == 0          # every served slot retires at once
    assert batches == [[0, 1], [2, 3], [4, 5], [6]]
    assert [r.rid for r in plane._finished] == list(range(7))
    assert all(r.done and r.latency_ms > 0.0 for r in plane._finished)
    lats = [r.latency_ms for r in plane._finished]
    assert lats[6] > lats[0]              # queueing delay is billed
    assert plane.decision_stats()["n"] == 7
    # the reference's plane admits the same load in the same batches
    ja = jmake_agent("rate_control", jenv)
    jplane = jctl.ControlPlane(jenv, ja, ja.init(jax.random.PRNGKey(0)),
                               kind="rate_control", n_slots=2, donate=False)
    for c in plane.clusters:
        jplane.register_cluster(c)
    for rid, c, s in load:
        jplane.submit(jctl.DecisionRequest(rid=rid, cluster=c, s_vec=s))
    key, jbatches = jax.random.PRNGKey(0), []
    while jplane.pending:
        key, k = jax.random.split(key)
        jbatches.append([r.rid for r in jplane.step(k)])
    assert jbatches == batches
    assert set(plane.decision_stats()) == set(jplane.decision_stats())


def test_reset_stats_guards_in_flight(small):
    _, tenv = small
    plane = _plane(tenv, "rate_control", n_slots=2)
    rid, c, s = _load(tenv, plane.clusters, 1)[0]
    plane.submit(DecisionRequest(rid=rid, cluster=c, s_vec=s))
    with pytest.raises(RuntimeError):
        plane.reset_stats()
    plane.run()
    plane.reset_stats()
    assert not plane._finished
    with pytest.raises(ValueError):
        plane.decision_stats()                   # empty trace again


# --------------------------------------------------------------------------
# batched decisions equal single selects, and the reference's plane
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind,kw", [
    ("placement", {"k_nn": 4}),
    ("auto_tune", {}),    # params-sensitive: the cluster gather matters
    ("rate_control", {}),
])
def test_batched_bitmatches_single_selects_and_reference(small, kind, kw):
    jenv, tenv = small
    ja, js, ta, ts = _agents(jenv, tenv, kind, seed=4, **kw)
    plane = ControlPlane(tenv, ta, ts, kind=kind, n_slots=3)
    jplane = jctl.ControlPlane(jenv, ja, js, kind=kind, n_slots=3, donate=False)
    jraw, traw = _clusters(jenv, 3, seed=5)
    for c in range(3):
        plane.register_cluster(f"c{c}", traw[c])
        jplane.register_cluster(f"c{c}", jraw[c])
    load = _load(tenv, plane.clusters, 7)
    for rid, c, s in load:
        plane.submit(DecisionRequest(rid=rid, cluster=c, s_vec=s))
        jplane.submit(jctl.DecisionRequest(rid=rid, cluster=c, s_vec=s))
    done = {r.rid: r for r in plane.run()}
    jdone = {r.rid: r for r in jplane.run(jax.random.PRNGKey(6))}
    assert len(done) == len(jdone) == 7
    jsingle = jctl.single_select_program(ja, False)
    for rid, c, s in load:
        got = done[rid].action
        single = to_numpy(single_select(ta, ts, s, traw[int(c[1:])]))
        np.testing.assert_array_equal(got, single)
        assert got.shape == spaces.action_space(kind).shape_fn(tenv)
        assert bool(plane.space.feasible_fn(torch.as_tensor(got)))
        lats = None
        if kind == "auto_tune":
            _, lats = ja.select(jax.random.PRNGKey(0), js, jnp.asarray(s), None,
                                jraw[int(c[1:])], explore=False)
            lats = np.asarray(lats)
        _same_decision(kind, got, np.asarray(jdone[rid].action), lats)
        _same_decision(kind, single,
                       np.asarray(jsingle(jax.random.PRNGKey(7), js, s,
                                          jraw[int(c[1:])])), lats)


def test_gather_clusters_keeps_invariant_fields_single_copy(small):
    _, tenv = small
    plane = _plane(tenv, "auto_tune", n_clusters=4)
    stacked = plane.cluster_params
    idx = torch.tensor([3, 0, 0, 2])
    lanes = gather_clusters(stacked, plane._axes, idx)
    for f, p, s, stacked_field in zip(stacked._fields, lanes, stacked,
                                      plane._axes):
        if stacked_field:
            assert p.shape[0] == 4 and torch.equal(p, s[idx]), f
        else:
            assert p is s, f                     # one copy, not gathered
    assert plane._axes.service_ms and not plane._axes.routing
    # one identical cluster: nothing stacked, the params pass whole
    one = _plane(tenv, "auto_tune", n_clusters=1)
    stacked = one.cluster_params
    assert one._axes is None
    assert gather_clusters(stacked, None, idx) is stacked


def test_batched_select_takes_the_slots_as_rows(large):
    """cq_large placement: 8 slots' selects in one call (the K-NN kernel's
    [8·100, 10] on the card) equal 8 single selects."""
    _, tenv = large
    agent = make_agent("ddpg", tenv, k_nn=8)
    state = agent.init_fleet(torch.Generator().manual_seed(0), 1, "cpu")
    plane = _plane(tenv, "placement", n_clusters=2, k_nn=8)
    s = to_torch(np.stack([sv for _, _, sv in _load(tenv, ("c",), 8)]))
    idx = torch.tensor([0, 1] * 4)
    got = batched_select(agent, state, s, idx, plane.cluster_params, plane._axes)
    assert got.shape == (8, tenv.N, tenv.M)
    for r in range(8):
        assert_exact(got[r], single_select(agent, state, s[r], None))


# --------------------------------------------------------------------------
# multi-kind service routing + error cases
# --------------------------------------------------------------------------
def test_service_routes_kinds_to_planes(small):
    _, tenv = small
    planes = {}
    for kind in KINDS:
        kw = {"k_nn": 4} if kind == "placement" else {}
        agent = make_agent(spaces.action_space(kind).default_agent, tenv, **kw)
        planes[kind] = ControlPlane(tenv, agent,
                                    agent.init_fleet(torch.Generator().manual_seed(10),
                                                     1, "cpu"),
                                    kind=kind, n_slots=2)
    svc = ControlService(planes)
    assert svc.kinds == tuple(sorted(KINDS))
    svc.register_cluster("c0", tenv.default_params())
    svc.register_cluster("c1")
    for rid, c, s in _load(tenv, ("c0", "c1"), 6):
        svc.submit(DecisionRequest(rid=rid, cluster=c, s_vec=s,
                                   kind=KINDS[rid % 3]))
    done = svc.run()
    assert len(done) == 6
    for r in done:
        assert np.asarray(r.action).shape == spaces.action_space(r.kind).shape_fn(tenv)
    stats = svc.decision_stats()
    assert set(stats) == set(KINDS)
    assert all(st["n"] == 2 for st in stats.values())


def test_error_cases(small):
    _, tenv = small
    agent = make_agent("rate_control", tenv)
    state = agent.init_fleet(None, 1, "cpu")
    with pytest.raises(KeyError):
        ControlPlane(tenv, agent, state, kind="no_such_space")
    with pytest.raises(ValueError):
        ControlPlane(tenv, agent, state, kind="rate_control", n_slots=0)
    plane = ControlPlane(tenv, agent, state, kind="rate_control", n_slots=2)
    with pytest.raises(RuntimeError):        # no clusters registered
        plane.cluster_params
    plane.register_cluster("c0")
    with pytest.raises(ValueError):          # duplicate
        plane.register_cluster("c0")
    s = np.zeros(tenv.state_dim, np.float32)
    with pytest.raises(KeyError):            # unregistered cluster
        plane.submit(DecisionRequest(rid=0, cluster="ghost", s_vec=s))
    with pytest.raises(ValueError):          # kind mismatch
        plane.submit(DecisionRequest(rid=0, cluster="c0", s_vec=s,
                                     kind="placement"))
    with pytest.raises(ValueError):          # plane under the wrong key
        ControlService({"placement": plane})
    svc = ControlService({"rate_control": plane})
    with pytest.raises(ValueError):          # service needs kind=
        svc.submit(DecisionRequest(rid=0, cluster="c0", s_vec=s))
    with pytest.raises(KeyError):            # no plane for that kind
        svc.submit(DecisionRequest(rid=0, cluster="c0", s_vec=s,
                                   kind="auto_tune"))


# --------------------------------------------------------------------------
# the whole slice: a three-kind service against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("app,n_clusters,n_requests", [("cq_small", 4, 30),
                                                       ("cq_large", 3, 24)])
def test_service_decisions_match_reference_service(app, n_clusters, n_requests):
    """The same requests on the same clusters, every kind, with the
    placement plane on carried weights (k_nn = 8, as build_service sets
    it): the reference's decisions, request by request."""
    jenv, tenv = env_pair(app)
    jraw, traw = _clusters(jenv, n_clusters, seed=11)
    planes, jplanes, jagents = {}, {}, {}
    for kind in KINDS:
        kw = {"k_nn": 8} if kind == "placement" else {}
        ja, js, ta, ts = _agents(jenv, tenv, kind, seed=12, **kw)
        planes[kind] = ControlPlane(tenv, ta, ts, kind=kind, n_slots=4)
        jplanes[kind] = jctl.ControlPlane(jenv, ja, js, kind=kind, n_slots=4,
                                          donate=False)
        jagents[kind] = (ja, js)
    svc, jsvc = ControlService(planes), jctl.ControlService(jplanes)
    for c in range(n_clusters):
        svc.register_cluster(f"cluster-{c}", traw[c])
        jsvc.register_cluster(f"cluster-{c}", jraw[c])
    reqs = serve_control.synthetic_requests(tenv, svc, n_requests, seed=13)
    for r in reqs:
        svc.submit(r)
        jsvc.submit(jctl.DecisionRequest(rid=r.rid, cluster=r.cluster,
                                         s_vec=r.s_vec, kind=r.kind))
    done = {r.rid: r for r in svc.run()}
    jdone = {r.rid: r for r in jsvc.run(jax.random.PRNGKey(14))}
    assert len(done) == len(jdone) == n_requests
    ja, js = jagents["auto_tune"]
    for r in reqs:
        lats = None
        if r.kind == "auto_tune":
            _, lats = ja.select(jax.random.PRNGKey(0), js, jnp.asarray(r.s_vec),
                                None, jraw[int(r.cluster.split("-")[1])],
                                explore=False)
            lats = np.asarray(lats)
        _same_decision(r.kind, done[r.rid].action,
                       np.asarray(jdone[r.rid].action), lats)
    assert set(svc.decision_stats()) == set(jsvc.decision_stats())


# --------------------------------------------------------------------------
# the launchers, on the CPU at a small size
# --------------------------------------------------------------------------
def test_serve_control_launcher_on_the_cpu(capsys):
    res = serve_control.main(["--device", "cpu", "--clusters", "3",
                              "--requests", "12", "--slots", "2"])
    out = capsys.readouterr().out
    assert "served 12/12 decisions" in out
    assert len(res["served"]) == 12 and len(res["warm"]) == 3 * 2
    assert set(res["stats"]) == set(KINDS)
    assert all(st["n"] == 4 for st in res["stats"].values())
    env = res["env"]
    for r in res["served"]:
        assert r.done and r.action.shape == spaces.action_space(r.kind).shape_fn(env)
        assert bool(spaces.is_feasible(torch.as_tensor(r.action)))
    # seeded: the same launch decides the same, and a kind subset works
    again = serve_control.main(["--device", "cpu", "--clusters", "3",
                                "--requests", "12", "--slots", "2"])
    for a, b in zip(res["served"], again["served"]):
        assert a.rid == b.rid and np.array_equal(a.action, b.action)
    sub = serve_control.main(["--device", "cpu", "--kinds", "rate_control",
                              "--clusters", "1", "--requests", "3"])
    assert set(sub["stats"]) == {"rate_control"}


def test_serve_control_launcher_errors(monkeypatch):
    with pytest.raises(SystemExit):
        serve_control.main(["--device", "cpu", "--kinds", "no_such_kind"])
    with pytest.raises(SystemExit):
        serve_control.main(["--device", "cpu", "--clusters", "0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_control.main(["--clusters", "1", "--requests", "1"])


@pytest.mark.parametrize("agent", ["ddpg", "round_robin"])
def test_drl_control_serves_the_trained_policy(agent, capsys):
    res = drl_control.main(["--device", "cpu", "--app", "cq_small",
                            "--agent", agent, "--fleet", "2", "--offline", "20",
                            "--offline-updates", "2", "--epochs", "3", "--k", "4",
                            "--scenario", "mixed", "--serve", "9"])
    out = capsys.readouterr().out
    assert "serving 9 decision requests" in out
    served = res["serve"]["served"]
    assert len(served) == 9
    svc = res["serve"]["service"]
    assert svc.planes["placement"].clusters == ("lane-0", "lane-1")
    assert set(res["serve"]["stats"]) == set(KINDS)
    # the placement plane answers with the best lane's trained policy
    best = res["best"]
    for r in served:
        if r.kind != "placement":
            continue
        if agent == "ddpg":
            want = tddpg.select_action(res["states"], res["agent"].cfg,
                                       to_torch(np.stack([r.s_vec] * 2)),
                                       explore=False)[best]
        else:
            want = res["env"].round_robin_assignment()
        assert_exact(r.action, want)


def test_drl_control_serve_errors():
    with pytest.raises(SystemExit):
        drl_control.main(["--device", "cpu", "--agent", "dqn", "--serve", "4"])
    with pytest.raises(SystemExit):
        drl_control.main(["--device", "cpu", "--serve", "-1"])
