"""The paper's technique on an accelerator fleet: DRL expert->device
placement for the Jamba MoE under skewed routing, plus straggler
mitigation.

Port of ``examples/expert_placement.py``:

  python -m repro_torch.examples.expert_placement [--device cpu]

The reference's key offsets become generator seeds: ``SEED`` for the
initial state, ``SEED + 1`` for offline pretraining, ``SEED + 2`` for the
online run (its ``PRNGKey(9)`` for the mitigation draws nothing)."""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (DDPGConfig, ddpg_init, jamba_placement_env,
                              make_agent, run_online_agent)
from repro_torch.core.ddpg import offline_pretrain
from repro_torch.core.exploration import EpsilonSchedule
from repro_torch.fault.straggler import StragglerDetector, mitigate_with_drl


# the reference's numbers: device STRAGGLER is observed SLOWDOWN x slower
K_NN, EPS_DECAY, UPDATES_PER_EPOCH, SEED = 8, 150, 2, 0
OFFLINE_SAMPLES, OFFLINE_UPDATES, EPOCHS = 800, 300, 200
STRAGGLER, SLOWDOWN = 5, 2.2


def run(offline_samples: int = OFFLINE_SAMPLES,
        offline_updates: int = OFFLINE_UPDATES, epochs: int = EPOCHS,
        device: str | torch.device | None = None) -> dict:
    """The reference's expert placement at its budget (the defaults), then
    the straggler and the trained agent's re-assignment, on ``device``
    (default CUDA).  Prints its lines; returns the step times before and
    after, and the run's History."""
    env = jamba_placement_env(device=device)
    seeded = lambda s: torch.Generator(device=env.device).manual_seed(s)  # noqa: E731
    print(f"placing {env.N} Jamba experts on {env.M} devices "
          f"(skewed token routing, zipf {env.skew})")

    cfg = DDPGConfig(n_executors=env.N, n_machines=env.M,
                     state_dim=env.state_dim, k_nn=K_NN, reward_scale=1.0,
                     eps=EpsilonSchedule(decay_epochs=EPS_DECAY))
    agent = ddpg_init(seeded(SEED), cfg, 1, env.device)
    agent = offline_pretrain(agent, cfg, env, n_samples=offline_samples,
                             n_updates=offline_updates, gen=seeded(SEED + 1))
    agent, hist = run_online_agent(SEED + 2, env,
                                   make_agent("ddpg", env, cfg=cfg),
                                   agent, T=epochs,
                                   updates_per_epoch=UPDATES_PER_EPOCH)

    w = env.reset(1).w[0]
    final = torch.as_tensor(hist.final_assignment, device=env.device)
    rr = float(env.step_time_ms(env.round_robin_assignment(), w))
    learned = float(env.step_time_ms(final, w))
    print(f"\nround-robin placement : {rr:.3f} ms/step (MoE layer)")
    print(f"DRL placement         : {learned:.3f} ms/step "
          f"({1 - learned / rr:+.1%})")

    print("\n== straggler mitigation ==")
    det = StragglerDetector(env.M)
    for _ in range(8):
        for d in range(env.M):
            det.observe(d, 1.0 if d != STRAGGLER else SLOWDOWN)
    print("detected stragglers:", det.stragglers())
    X = mitigate_with_drl(det, env, agent, cfg, seeded(9))
    moved = int((X.argmax(-1) != final.argmax(-1)).sum())
    slow = torch.as_tensor(det.speed_factors()[: env.M], dtype=torch.float32,
                           device=env.device)
    before = float(env.step_time_ms(final, w, slow))
    after = float(env.step_time_ms(X, w, slow))
    print(f"re-assigned {moved} experts; step time with straggler: "
          f"{before:.3f} -> {after:.3f} ms")
    return dict(round_robin=rr, learned=learned, stragglers=det.stragglers(),
                moved=moved, before=before, after=after, reassignment=X,
                history=hist)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
