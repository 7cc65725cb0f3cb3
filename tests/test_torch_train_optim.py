"""The port's tree optimizers, clipping, schedules and int8 error-feedback
compression (``repro_torch/train/optimizer.py``, ``compression.py``)
against the reference's (``repro/train/optimizer.py``,
``compression.py``), on draws from fixed numpy seeds; and the fleet form
of Adam, which the DRL agents use, held to the tree form lane by lane.

Float32 arithmetic is held at 1e-6 relative.  A bfloat16 moment is held
at two bfloat16 steps (2**-7) of its leaf's scale: XLA may keep a
bfloat16 expression in float32 between its operations where torch rounds
after each, and ``b1·m + (1−b1)·g`` then differs by the rounding of its
terms, not of its result."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import to_numpy, torch

from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt

BF16_STEP = 2.0 ** -7


def _tree(seed: int, dtype=np.float32) -> dict:
    """A nested parameter-shaped tree: a vector, matrices and a stacked
    3-d leaf, so the decay mask (ndim >= 2) splits it."""
    rng = np.random.default_rng(seed)
    return {"embed": {"table": rng.normal(size=(12, 6)).astype(dtype)},
            "layers": {"norm": {"scale": (1 + 0.1 * rng.normal(size=(3, 6))).astype(dtype)},
                       "w": rng.normal(size=(3, 6, 5)).astype(dtype)},
            "bias": rng.normal(size=(5,)).astype(dtype)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return topt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(to_numpy(got.double()),
                               np.asarray(want, np.float64), rtol=rtol, atol=atol)


def _close_tree(got, want, scaled_atol=0.0, **kw):
    """Leaf by leaf; ``scaled_atol`` adds that share of the leaf's largest
    magnitude to the absolute tolerance."""
    for g, w in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float64)
        kw_leaf = dict(kw, atol=kw.get("atol", 0.0) + scaled_atol * np.abs(w).max())
        _close(g, w, **kw_leaf)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_tree_adamw_matches_the_reference(moment_dtype, weight_decay):
    """Three steps under a warmup-cosine schedule: updates, moments and the
    step; the decay falls on every leaf with ndim >= 2."""
    sched_j = jopt.warmup_cosine(1e-2, 2, 10)
    sched_t = topt.warmup_cosine(1e-2, 2, 10)
    oj = jopt.adamw(sched_j, b1=0.9, b2=0.95, weight_decay=weight_decay)
    ot = topt.tree_adamw(sched_t, b1=0.9, b2=0.95, weight_decay=weight_decay)
    params = _tree(0)
    jp, tp = _jax(params), _torch(params)
    js, ts = oj.init(jp), ot.init(tp)
    mdt = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}[moment_dtype]
    js = js._replace(mu=jax.tree.map(lambda m: m.astype(mdt[0]), js.mu),
                     nu=jax.tree.map(lambda m: m.astype(mdt[0]), js.nu))
    ts = ts._replace(mu=topt.tree_map(lambda m: m.to(mdt[1]), ts.mu),
                     nu=topt.tree_map(lambda m: m.to(mdt[1]), ts.nu))
    tol = dict(rtol=1e-6, atol=1e-9) if moment_dtype == "float32" else \
        dict(rtol=2 * BF16_STEP, scaled_atol=2 * BF16_STEP)
    for step in range(3):
        grads = _tree(10 + step)
        ju, js = oj.update(_jax(grads), js, jp)
        tu, ts = ot.update(_torch(grads), ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32 and ts.step.shape == ()
        _close_tree(ts.mu, js.mu, **tol)
        _close_tree(ts.nu, js.nu, **tol)
        _close_tree(tu, ju, **tol)
        for leaf in topt.tree_leaves(ts.mu):
            assert leaf.dtype == mdt[1]
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_tree_updates(tp, tu)
        _close_tree(tp, jp, **tol)


def test_tree_adamw_decays_exactly_the_leaves_of_two_or_more_dims():
    """With zero gradients the update is the decay alone: -lr·wd·p on the
    matrices and the stacked leaves, nothing on the vector."""
    ot = topt.tree_adamw(0.5, weight_decay=0.1)
    tp = _torch(_tree(1))
    zeros = topt.tree_map(torch.zeros_like, tp)
    upd, _ = ot.update(zeros, ot.init(tp), tp)
    for u, p in zip(topt.tree_leaves(upd), topt.tree_leaves(tp)):
        want = -0.5 * 0.1 * p if p.dim() >= 2 else torch.zeros_like(p)
        torch.testing.assert_close(u, want, rtol=1e-6, atol=0)


def test_tree_adam_converges_on_quadratic():
    """The reference's test_adamw_converges_on_quadratic, on the tree form."""
    ot = topt.tree_adam(0.1)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = ot.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        upd, state = ot.update(grads, state, params)
        params = topt.apply_tree_updates(params, upd)
    assert float(params["w"].abs().max()) < 1e-2


@pytest.mark.parametrize("lr", [0.05, "schedule"])
def test_sgd_with_momentum_matches_the_reference(lr):
    lr_j = jopt.constant_schedule(0.05) if lr == "schedule" else lr
    lr_t = topt.constant_schedule(0.05) if lr == "schedule" else lr
    oj, ot = jopt.sgd(lr_j, momentum=0.9), topt.sgd(lr_t, momentum=0.9)
    jp, tp = _jax(_tree(2)), _torch(_tree(2))
    js, ts = oj.init(jp), ot.init(tp)
    for step in range(3):
        grads = _tree(20 + step)
        ju, js = oj.update(_jax(grads), js, jp)
        tu, ts = ot.update(_torch(grads), ts, tp)
        _close_tree(ts.momentum, js.momentum)
        _close_tree(tu, ju)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_tree_updates(tp, tu)
    assert int(ts.step) == int(js.step) == 3


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    g = _tree(3)
    jc, jn = jopt.clip_by_global_norm(_jax(g), max_norm)
    tc, tn = topt.clip_by_global_norm(_torch(g), max_norm)
    _close(tn, jn)
    _close_tree(tc, jc)
    # the reference's test_clip_by_global_norm
    clipped, norm = topt.clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    assert float(torch.sqrt(torch.sum(clipped["a"] ** 2))) == pytest.approx(1.0, rel=1e-4)


def test_schedules_match_the_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    for args in [(1.0, 10, 100), (3e-4, 20, 300), (1e-2, 0, 10), (0.5, 5, 5)]:
        js, ts = jopt.warmup_cosine(*args), topt.warmup_cosine(*args)
        want = np.asarray(jax.vmap(js)(jnp.asarray(steps)))
        got = to_numpy(ts(torch.from_numpy(steps)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    got = topt.constant_schedule(0.25)(torch.tensor(7, dtype=torch.int32))
    assert got.dtype == torch.float32 and float(got) == 0.25
    # the reference's test_warmup_cosine_schedule
    sched = topt.warmup_cosine(1.0, warmup_steps=10, total_steps=100)
    assert float(sched(torch.tensor(0))) == pytest.approx(0.0)
    assert float(sched(torch.tensor(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(sched(torch.tensor(100))) == pytest.approx(0.1, rel=1e-2)


def _grad_draw(seed: int, n: int = 256) -> np.ndarray:
    """The reference's int8 test's distribution (a normal vector at a
    scale of 10**k, k in [-3, 3)) from a fixed numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * 10.0 ** rng.integers(-3, 3)).astype(np.float32)


@pytest.mark.parametrize("seeds", [range(0, 50), range(50, 100)],
                         ids=["seeds0-49", "seeds50-99"])
def test_int8_values_and_error_equal_the_references(seeds):
    """On seeds 0-99: the int8 values exactly, the scale, and the round
    trip's relative error, which stays under the reference's 1% bound."""
    for seed in seeds:
        g = _grad_draw(seed)
        jq, js = jcomp.quantize_int8(jnp.asarray(g))
        tq, ts = tcomp.quantize_int8(torch.from_numpy(g))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(to_numpy(tq), np.asarray(jq))
        _close(ts, js)
        je = float(jcomp.compression_error(jnp.asarray(g)))
        te = float(tcomp.compression_error(torch.from_numpy(g)))
        assert te == pytest.approx(je, rel=1e-5, abs=1e-9)
        assert te < 0.01


def test_quantize_int8_range_and_half_to_even():
    q, s = tcomp.quantize_int8(torch.tensor([-3.0, 0.0, 7.0]))
    assert q.dtype == torch.int8 and int(q.max()) == 127
    # halves round to even on both sides: 127·(x/7) at exactly .5
    x = np.asarray([7.0, 0.5 * 7 / 127, 1.5 * 7 / 127, 2.5 * 7 / 127, -2.5 * 7 / 127],
                   np.float32)
    jq, _ = jcomp.quantize_int8(jnp.asarray(x))
    tq, _ = tcomp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(to_numpy(tq), np.asarray(jq))
    zq, zs = tcomp.quantize_int8(torch.zeros(4))
    assert float(zs) == 1.0 and not zq.any()


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_ef_compress_grads_matches_the_reference(grad_dtype):
    """Two rounds of error feedback over a tree with bfloat16 residuals:
    the compressed gradients and the residuals carried between them."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[grad_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[grad_dtype]
    shapes = _tree(4)
    jr = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.bfloat16), shapes)
    tr = topt.tree_map(lambda a: torch.zeros(a.shape, dtype=torch.bfloat16), shapes)
    for rnd in range(2):
        g = _tree(40 + rnd)
        jg, jr = jcomp.ef_compress_grads(jax.tree.map(lambda a: jnp.asarray(a, jdt), g), jr)
        tg, tr = tcomp.ef_compress_grads(
            topt.tree_map(lambda a: torch.from_numpy(a).to(tdt), g), tr)
        for got, want in zip(topt.tree_leaves(tg), jax.tree.leaves(jg)):
            assert got.dtype == tdt
            _close(got.float(), np.asarray(want, np.float32), rtol=1e-6)
        for got, want in zip(topt.tree_leaves(tr), jax.tree.leaves(jr)):
            assert got.dtype == torch.bfloat16
            _close(got.float(), np.asarray(want, np.float32), rtol=BF16_STEP, atol=1e-7)


def test_error_feedback_accumulates_residual():
    """The reference's test_error_feedback_accumulates_residual."""
    g = {"w": torch.tensor([1.0, 1e-4, -1e-4, 0.5])}
    res = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    cg, new_res = tcomp.ef_compress_grads(g, res)
    lost = g["w"] - cg["w"].float()
    np.testing.assert_allclose(to_numpy(new_res["w"].float()), to_numpy(lost), atol=1e-2)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_fleet_adam_is_the_tree_form_lane_by_lane(weight_decay):
    """The fleet form the DRL agents use keeps its numbers: each lane of a
    ``[F, ...]`` list with its own step count equals the tree form on that
    lane's slice (per-lane matrices decay, per-lane vectors do not)."""
    rng = np.random.default_rng(5)
    F = 3
    params = [torch.from_numpy(rng.normal(size=(F, 4, 3)).astype(np.float32)),
              torch.from_numpy(rng.normal(size=(F, 3)).astype(np.float32))]
    fleet = topt.adamw(1e-3, weight_decay=weight_decay)
    fs = fleet.init(params)
    fs.step = torch.tensor([0, 3, 7], dtype=torch.int32)
    tree = topt.tree_adamw(1e-3, weight_decay=weight_decay)
    lanes = [{"w": params[0][f].clone(), "b": params[1][f].clone()} for f in range(F)]
    states = [tree.init(lane)._replace(step=torch.tensor(int(fs.step[f]), dtype=torch.int32))
              for f, lane in enumerate(lanes)]
    for _ in range(2):
        grads = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
                 for p in params]
        upd, fs = fleet.update(grads, fs, params)
        topt.apply_updates(params, upd)
        for f in range(F):
            u, states[f] = tree.update({"w": grads[0][f], "b": grads[1][f]},
                                       states[f], lanes[f])
            lanes[f] = topt.apply_tree_updates(lanes[f], u)
    assert fs.step.tolist() == [2, 5, 9]
    for f in range(F):
        torch.testing.assert_close(params[0][f], lanes[f]["w"], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(params[1][f], lanes[f]["b"], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(fs.nu[0][f], states[f].nu["w"], rtol=1e-6, atol=0)
