#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, checks the K-NN beam and a
short control loop on the card against the CPU, then drives the main path
— ``repro_torch.launch.drl_control.run`` on ``cq_large`` (100 executors ×
10 machines) with a fleet of 8 DDPG lanes — and checks that every select
and every update went through the kernel.  Any failure raises; the last
line of a passing run is ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits non-zero before printing any result.  TF32 is turned
off for matmuls and cuDNN, so float32 products run in full float32."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores

# the main path: the paper's large-scale setup, a fleet of 8 lanes
MAIN = dict(app="cq_large", fleet=8, k=16, offline=1000, offline_updates=100,
            epochs=50)
U = 1                           # the launcher's updates per online epoch


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time per call of ``fn`` called back to back from Python, host
    dispatch included (CUDA events around the whole loop)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 100, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no host
    dispatch sits between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def check_kernel(dev) -> dict:
    """Phase 3: the kernel against its plain version at every shape."""
    from repro_torch.kernels.knn_topk import row_top2_regret, row_top2_regret_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(800, 10), (25600, 10), (3200, 10), (7, 3), (1, 2), (513, 16),
              (300, 33)]
    cases = [torch.rand(s, generator=gen, device=dev) for s in shapes]
    # quantized rows: ties everywhere, incl. a best value held by several
    # columns and rows that are constant
    tied = torch.round(torch.rand(1000, 10, generator=gen, device=dev) * 3) / 3
    tied[:50] = 0.5
    cases.append(tied)
    # a batched [F, B, N, M] proto, noise added as exploration does
    cases.append(torch.rand(2, 16, 25, 10, generator=gen, device=dev) * 2)
    max_err = 0.0
    for proto in cases:
        b, s, r = row_top2_regret(proto)
        rb, rs, rr = row_top2_regret_ref(proto)
        torch.cuda.synchronize()
        if not (torch.equal(b, rb) and torch.equal(s, rs)):
            raise AssertionError(f"kernel indices differ at {tuple(proto.shape)}")
        err = float((r - rr).abs().max())
        if err > 1e-6:
            raise AssertionError(f"kernel regret off by {err} at {tuple(proto.shape)}")
        max_err = max(max_err, err)
    log(f"phase 3 kernel vs plain version: {len(cases)} shapes agree "
        f"(indices exact, max |regret err| {max_err})")

    timings = {}
    for rows in (25600, 800):
        proto = torch.rand(rows, 10, generator=gen, device=dev)
        m = proto.shape[1]

        def library(p=proto):
            v = torch.topk(p, 2).values
            return 2.0 * (v[:, 0] - v[:, 1])

        kernel = lambda p=proto: row_top2_regret(p)             # noqa: E731
        plain = lambda p=proto: row_top2_regret_ref(p)          # noqa: E731
        t = dict(ms=graph_ms(kernel), plain_ms=graph_ms(plain),
                 library_ms=graph_ms(library), eager_ms=eager_ms(kernel),
                 eager_plain_ms=eager_ms(plain),
                 eager_library_ms=eager_ms(library))
        bytes_moved = rows * m * 4 + rows * 12
        ops = rows * 2 * m                      # two compares per element
        t["bound_ms"] = max(bytes_moved / HBM_BYTES_PER_S,
                            ops / F32_OPS_PER_S) * 1e3
        t["bound_by"] = ("bytes" if bytes_moved / HBM_BYTES_PER_S
                         >= ops / F32_OPS_PER_S else "operations")
        timings[rows] = t
        log(f"  [{rows},{m}] device ms per call (CUDA graph): kernel "
            f"{t['ms']:.6f}  plain {t['plain_ms']:.6f}  library (torch.topk "
            f"+ sub) {t['library_ms']:.6f}  bound {t['bound_ms']:.6f} "
            f"({t['bound_by']})")
        log(f"  [{rows},{m}] eager ms per call (host dispatch included): "
            f"kernel {t['eager_ms']:.6f}  plain {t['eager_plain_ms']:.6f}  "
            f"library {t['eager_library_ms']:.6f}")
    return dict(max_abs_err=max_err, timings=timings)


def check_beam(dev) -> None:
    """Phase 4: the K-NN beam on the card equals the beam on the CPU."""
    from repro_torch.core.knn_projection import knn_actions

    rng = np.random.default_rng(4)
    for shape, k, quant in [((8, 100, 10), 16, None), ((8, 32, 100, 10), 16, None),
                            ((2, 20, 10), 12, 4), ((3, 7, 3), 4, 2)]:
        p = rng.uniform(size=shape).astype(np.float32)
        if quant:
            p = np.round(p * quant) / quant
        gpu = knn_actions(torch.as_tensor(p, device=dev), k).cpu()
        cpu = knn_actions(torch.as_tensor(p), k)
        if not torch.equal(gpu, cpu):
            raise AssertionError(f"beam on the card differs from the CPU at {shape}")
    log("phase 4 K-NN beam: card == CPU, bit for bit, on 4 shapes")


def check_loop_vs_cpu(dev) -> None:
    """Phase 5: cq_small, F=2, T=5 with the same draws on the card and CPU."""
    from repro_torch.core import EpochDraws, make_agent, run_online_fleet
    from repro_torch.core.convert import ddpg_state_from_numpy, ddpg_state_to_numpy
    from repro_torch.dsdps import SchedulingEnv, apps
    from repro_torch.dsdps.apps import default_workload

    F, T = 2, 5
    topo = apps.continuous_queries("small")
    histories, init = {}, None
    for where in ("cpu", dev):
        env = SchedulingEnv(topo, default_workload(topo), device=where)
        agent = make_agent("ddpg", env, k_nn=12)
        cfg = agent.cfg
        if init is None:
            init = ddpg_state_to_numpy(
                agent.init_fleet(torch.Generator().manual_seed(5), F, "cpu"))
        states = ddpg_state_from_numpy(init, where)
        rng = np.random.default_rng(6)
        draws = [EpochDraws(
            explore_add=torch.as_tensor(rng.uniform(size=F) < 0.7),
            explore_noise=torch.as_tensor(
                rng.uniform(size=(F, env.N, env.M)).astype(np.float32)),
            meas_z=torch.as_tensor(rng.normal(size=(F, 5)).astype(np.float32)),
            rate_z=torch.as_tensor(
                rng.normal(size=(F, env.workload.num_spouts)).astype(np.float32)),
            replay_idx=torch.as_tensor(rng.integers(0, t + 1, (F, U, cfg.batch))),
        ).to(where) for t in range(T)]
        _, histories[str(where)] = run_online_fleet(
            0, env, agent, states, T, updates_per_epoch=U, draws=draws)
    cpu, gpu = histories["cpu"], histories[str(dev)]
    np.testing.assert_array_equal(gpu.moved, cpu.moved)
    np.testing.assert_array_equal(gpu.final_assignment, cpu.final_assignment)
    np.testing.assert_allclose(gpu.latencies, cpu.latencies, rtol=1e-4)
    log(f"phase 5 cq_small F={F} T={T}: card == CPU (moved exact, latencies "
        f"max rel diff {np.abs(gpu.latencies / cpu.latencies - 1).max():.3g})")


def run_main_path(dev):
    """Phase 6: the launcher's ``run`` at cq_large, fleet 8, on the card."""
    from repro_torch.kernels.knn_topk import ops
    from repro_torch.launch import drl_control

    ops.LAUNCHES = 0
    res = drl_control.run(device=dev, **MAIN)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES

    hist, env = res["history"], res["env"]
    F, T = MAIN["fleet"], MAIN["epochs"]
    if not (np.isfinite(hist.rewards).all() and np.isfinite(hist.latencies).all()):
        raise AssertionError("non-finite rewards or latencies on the main path")
    if hist.rewards.shape != (F, T) or (hist.latencies <= 0).any():
        raise AssertionError(f"bad traces: shape {hist.rewards.shape}")
    X = hist.final_assignment
    if X.shape != (F, env.N, env.M) or not np.array_equal(X.sum(-1), np.ones((F, env.N))):
        raise AssertionError("final assignments are not one-hot per executor")
    if not (np.isfinite(res["finals"]).all() and (res["finals"] > 0).all()):
        raise AssertionError("non-finite final latencies")
    want = MAIN["offline_updates"] + T * (1 + U)
    if launches != want:
        raise AssertionError(f"row_top2_regret launched {launches} times on the "
                             f"main path, expected {want}")
    finals, rrs, s = res["finals"], res["rrs"], res["seconds"]
    log(f"phase 6 main path {MAIN['app']} N={env.N} M={env.M} fleet={F}: "
        f"{launches} kernel launches (= {MAIN['offline_updates']} offline "
        f"updates + {T} epochs x (1 select + {U} update))")
    log(f"  wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in s.items()))
    log(f"  online {res['lane_epochs_per_s']:.1f} lane-epochs/s")
    log(f"  final latency {finals.mean():.4f} ± {finals.std():.4f} ms vs "
        f"round-robin {rrs.mean():.4f} ms (improvement "
        f"{1 - finals.mean() / rrs.mean():.2%} mean, "
        f"{1 - finals[res['best']] / rrs[res['best']]:.2%} best lane)")
    return launches, res


def profile_online(res, epochs: int = 5) -> None:
    """Phase 7: where an online epoch's time goes, on the trained fleet.

    Times ``epochs`` more epochs without and with ``torch.profiler``, and
    reads the kernels' device time from the trace: the device's busy share
    of the wall time, launches per epoch, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import make_agent, run_online_fleet

    env, states = res["env"], res["states"]
    agent = make_agent("ddpg", env, k_nn=MAIN["k"])
    gen = torch.Generator(device=env.device).manual_seed(3)
    run_online_fleet(gen, env, agent, states, 2)             # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_online_fleet(gen, env, agent, states, epochs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / epochs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_online_fleet(gen, env, agent, states, epochs)
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) / epochs
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels) / epochs
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    log(f"phase 7 online epoch, {MAIN['app']} fleet={MAIN['fleet']}: wall "
        f"{wall * 1e3:.3f} ms unprofiled, {wall_prof * 1e3:.3f} ms profiled; "
        f"device busy {busy_us / 1e3:.3f} ms/epoch in "
        f"{len(kernels) / epochs:.0f} kernels/epoch = "
        f"{busy_us / (wall * 1e6):.1%} of unprofiled wall")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    for name, us in top:
        log(f"  {us / epochs:9.1f} us/epoch  {name[:90]}")


def time_critic_head(res) -> None:
    """Phase 8: the critic's 32→1 output layer as ``FleetMLP`` runs it (a
    product and a sum, so that a lane never depends on its batch) against
    one ``bmm``, at the main path's row counts, on the trained weights."""
    from repro_torch.core import ddpg, networks

    critic = res["states"].critic
    w, b = critic.weights[-1].detach(), critic.biases[-1].detach()
    head = networks.FleetMLP([w], [b])
    F, din = w.shape[0], w.shape[1]
    gen = torch.Generator(device=w.device).manual_seed(8)
    B, K = ddpg.DDPGConfig.batch, MAIN["k"]
    for what, rows in (("select", K), ("update", B), ("target", B * K)):
        h = torch.rand(F, rows, din, generator=gen, device=w.device)

        @torch.no_grad()
        def ours(h=h):
            return head(h)

        @torch.no_grad()
        def gemm(h=h):
            return torch.bmm(h, w) + b[:, None, :]

        t_ours, t_gemm = graph_ms(ours), graph_ms(gemm)
        err = float((ours() - gemm()).abs().max())
        log(f"phase 8 critic head [{F},{rows},{din}]x[{F},{din},1] ({what}): "
            f"product+sum {t_ours:.6f} ms, bmm {t_gemm:.6f} ms per call "
            f"(device, CUDA graph); max |diff| {err:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels.knn_topk import build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    card = nvidia_smi()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    log(f"phase 2 build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")

    kernel = check_kernel(dev)
    check_beam(dev)
    check_loop_vs_cpu(dev)
    launches, res = run_main_path(dev)
    profile_online(res)
    time_critic_head(res)

    t = kernel["timings"][25600]
    print(json.dumps({"kernels": [{
        "name": "row_top2_regret",
        "route": "cuda",
        "source": "src/repro_torch/kernels/knn_topk/csrc/knn_topk.cu",
        "replaces": "src/repro/kernels/knn_topk/kernel.py:37",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
