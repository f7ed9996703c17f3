"""RL throughput benchmark of the port: env-steps/s THROUGH the framework
(the reference's `ray_tpu/rlbench.py`, at its configuration: CartPole-v1,
2 rollout workers x 2 envs, the fcnet of two tanh layers of 64).

The learner runs on the card (without CUDA this raises); the rollout
workers are CPU actors of the port's runtime. It prints each rate, the
learner's grad seconds, its utilization and its memory_allocated; it
writes a file only with --out. `measure` is the one account of the
learner over a window of train() calls, which chip_smoke.py and
profile_step.py read too.

Usage: python -m ray_tpu_torch.rlbench [--seconds 20] [--out FILE]
"""

from __future__ import annotations

import json
import time

from ray_tpu_torch._private.bench_meta import run_metadata as _metadata

# the reference's rlbench.py:30-39 (PPO) and :64-71 (IMPALA)
PPO_BENCH_CONFIG = {
    "env": "CartPole-v1",
    "num_workers": 2,
    "num_envs_per_worker": 2,
    "rollout_fragment_length": 128,
    "train_batch_size": 1024,
    "sgd_minibatch_size": 256,
    "num_sgd_iter": 8,
    "seed": 0,
}
IMPALA_BENCH_CONFIG = {
    "env": "CartPole-v1",
    "num_workers": 2,
    "num_envs_per_worker": 2,
    "rollout_fragment_length": 80,
    "train_batch_size": 800,
    "seed": 0,
}


def measure(trainer, trains: int | None = None,
            seconds: float | None = None) -> tuple[dict, list]:
    """Drive trainer.train() over a window of `trains` calls, or of as
    many as `seconds` holds, and account for the learner over it: env
    steps sampled and trained, its grad seconds and learn_on_batch calls,
    and the rates. IMPALA's LearnerThread keeps running totals, read at
    both ends; PPO's train() reports its own call's, summed. Returns the
    account and each call's metrics."""
    thread = getattr(trainer, "_learner", None)  # IMPALA's LearnerThread

    def totals():
        return (trainer._sampled, thread.num_steps_trained,
                thread.grad_time_s, thread.num_batches_trained)

    before = totals() if thread is not None else None
    summed = (0, 0, 0.0, 0)
    rows = []
    t0 = time.perf_counter()
    while (len(rows) < trains if seconds is None
           else time.perf_counter() - t0 < seconds):
        m = trainer.train()
        rows.append(m)
        if thread is None:  # synchronous: every sampled step trains
            n = m["num_env_steps_trained"]
            summed = tuple(a + b for a, b in zip(summed, (
                n, n, m["learner_grad_time_s"], m["learner_calls"])))
    wall = time.perf_counter() - t0
    if thread is not None:
        summed = tuple(a - b for a, b in zip(totals(), before))
    sampled, trained, grad_s, calls = summed
    return {
        "trains": len(rows),
        "wall_s": wall,
        "env_steps": sampled,
        "per_second": sampled / wall,
        "trained_per_second": trained / wall,
        "learner_utilization": trained / max(sampled, 1),
        "learner_grad_s": grad_s,
        "learner_calls": calls,
        "learner_grad_ms_per_call": 1e3 * grad_s / max(calls, 1),
        "learner_busy_share": grad_s / wall,
    }, rows


def bench(name: str, trainer_cls, config: dict, seconds: float) -> dict:
    """One trainer at its rlbench configuration, the learner on the card:
    a warm-up train() (the actors' start, the learner's first launches),
    then `seconds` of train() calls through `measure`."""
    import torch

    trainer = trainer_cls(config=config)
    try:
        trainer.train()
        window, _ = measure(trainer, seconds=seconds)
        memory = torch.cuda.memory_allocated()
    finally:
        trainer.cleanup()
    return {"name": name, "env": config["env"], **window,
            "learner_memory_allocated": memory}


def main(seconds: float = 20.0) -> dict:
    import ray_tpu_torch
    from ray_tpu_torch._private.device import check_device
    from ray_tpu_torch.rllib.agents.impala import ImpalaTrainer
    from ray_tpu_torch.rllib.agents.ppo import PPOTrainer

    check_device("cuda")
    # logical CPUs: the trainers place 2 rollout workers + a learner
    ray_tpu_torch.init(num_cpus=8)
    try:
        results = [
            bench("ppo_cartpole_env_steps", PPOTrainer, PPO_BENCH_CONFIG,
                  seconds),
            bench("impala_cartpole_env_steps", ImpalaTrainer,
                  IMPALA_BENCH_CONFIG, seconds)]
    finally:
        ray_tpu_torch.shutdown()
    doc = {"metadata": _metadata(), "results": results}
    for r in results:
        print(f"{r['name']} per second {r['per_second']} over "
              f"{r['env_steps']} env steps in {r['wall_s']} s (learner on "
              f"the card: grad {r['learner_grad_s']} s, "
              f"{r['learner_grad_ms_per_call']} ms a call, utilization "
              f"{r['learner_utilization']}, memory_allocated "
              f"{r['learner_memory_allocated']})")
    return doc


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--seconds", type=float, default=20.0)
    args = parser.parse_args()
    doc = main(args.seconds)
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
