#!/usr/bin/env python3
"""Where the time of the port's main paths goes, on one NVIDIA GPU.

Run from the root of a checkout (after, or without, chip_smoke.py):

    python3 profile_step.py [--model resnet50|gpt2|ppo|impala]

It starts the port's runtime and trains the model through
`ray_tpu_torch.train.Trainer` exactly as chip_smoke.py's train phases do
(resnet50: batch 256, 224², bf16, bn_mode="kernel"; gpt2: GPT-2 124M,
batch 12 x 1024 tokens, bf16, ops_mode="kernel", AdamW), warms up, then
traces one epoch of STEPS steps in its worker actor with torch.profiler
(`train(profile_dir=)`, a chrome trace) and prints one JSON line: the wall time
per step (the epoch's own clock, profiler on), the device's busy time per
step (sum of kernel times; one stream) and idle share, device time per
kernel group, and the top kernels by device time. ppo and impala drive
RLlib's trainers at rlbench's configuration, the learner in this process
on the card and two CPU rollout actors, and trace one train() after two
warm-up ones: its wall time, the device's busy time and idle share, and
per learn_on_batch the learner's host wall (its grad time), the device
time, the launches and the groups. Without CUDA it exits 2.
"""

import argparse
import glob
import json
import os
import sys
import tempfile

import torch

STEPS = 5
# kernel-name fragments -> group; first match wins, the rest is "other"
GROUPS = (("bn_bwd_sums", ("partial_sums", "finalize")),
          ("flash_attn_fwd", ("flash_fwd",)),
          ("layernorm", ("norm_packed", "norm_scalar")),
          ("max_pool", ("max_pool",)),
          ("conv", ("conv", "implicit", "cudnn", "nhwc", "dgrad", "wgrad",
                    "fprop")),
          ("matmul", ("gemm", "nvjet", "xmma", "sm90_", "cutlass")),
          ("softmax", ("softmax",)),
          ("reduce", ("reduce",)),
          ("optimizer", ("multi_tensor",)),
          ("copy", ("copy",)),
          ("elementwise", ("elementwise",)))


def group_of(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_events(trace_path):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def by_group(kernels, per):
    """{group: ms} and the top kernels' [name, ms], each divided by per."""
    per_group, per_name = {}, {}
    for e in kernels:
        g = group_of(e["name"])
        per_group[g] = per_group.get(g, 0.0) + e.get("dur", 0)
        per_name[e["name"]] = per_name.get(e["name"], 0.0) + e.get("dur", 0)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:15]
    return ({g: t / 1e3 / per for g, t in sorted(per_group.items(),
                                                  key=lambda kv: -kv[1])},
            [[n[:120], t / 1e3 / per] for n, t in top])


def profile_rl(model):
    """One traced train() of PPO or IMPALA at rlbench's configuration, the
    learner on the card, accounted by rlbench.measure."""
    import ray_tpu_torch
    from ray_tpu_torch import rlbench
    from ray_tpu_torch.rllib.agents.impala import ImpalaTrainer
    from ray_tpu_torch.rllib.agents.ppo import PPOTrainer

    cls, cfg = {"ppo": (PPOTrainer, rlbench.PPO_BENCH_CONFIG),
                "impala": (ImpalaTrainer, rlbench.IMPALA_BENCH_CONFIG)}[model]
    ray_tpu_torch.init(num_cpus=8)
    try:
        trainer = cls(config=cfg)
        try:
            for _ in range(2):  # the actors' start, the first launches
                trainer.train()
            activities = [torch.profiler.ProfilerActivity.CPU,
                          torch.profiler.ProfilerActivity.CUDA]
            with tempfile.TemporaryDirectory(dir=".") as trace_dir:
                with torch.profiler.profile(activities=activities) as prof:
                    window, _ = rlbench.measure(trainer, trains=1)
                    torch.cuda.synchronize()
                path = os.path.join(trace_dir, "trace.json")
                prof.export_chrome_trace(path)
                kernels = device_events(path)
        finally:
            trainer.cleanup()
    finally:
        ray_tpu_torch.shutdown()
    calls = window["learner_calls"]
    wall_ms = window["wall_s"] * 1e3
    busy_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    groups, top = by_group(kernels, calls)
    return {"config": cfg, "wall_ms_per_train": wall_ms,
            "device_busy_ms_per_train": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "learn_calls": calls,
            "learner_wall_ms_per_call": window["learner_grad_ms_per_call"],
            "device_busy_ms_per_call": busy_ms / calls,
            "kernels_per_call": len(kernels) / calls,
            "group_ms_per_call": groups, "top_kernels_ms_per_call": top}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("resnet50", "gpt2", "ppo",
                                            "impala"), default="resnet50")
    model = parser.parse_args().model
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    if model in ("ppo", "impala"):
        print(json.dumps({"phase": "profile", "model": model, "card": smi,
                          **profile_rl(model)}))
        return 0
    import ray_tpu_torch
    from ray_tpu_torch.train import Trainer

    if model == "resnet50":
        torch.backends.cudnn.benchmark = True
        op_cls, batch, per_sample = chip_smoke._operator_cls(), \
            chip_smoke.BATCH, 1
    else:
        op_cls, batch = chip_smoke.gpt2_operator_cls(), chip_smoke.GPT_BATCH
        per_sample = chip_smoke.gpt2_config().max_seq
    ray_tpu_torch.init(object_store_memory=chip_smoke.STORE_BYTES)
    try:
        trainer = Trainer(op_cls, num_workers=1, config={"steps": STEPS},
                          resources_per_worker={"GPU": 1})
        trainer.train(num_steps=chip_smoke.WARMUP)
        with tempfile.TemporaryDirectory(dir=".") as trace_dir:
            # the worker's epoch, its clock and its trace
            result = trainer.train(num_steps=STEPS, profile_dir=trace_dir)
            kernels = device_events(
                glob.glob(os.path.join(trace_dir, "*.json"))[0])
        trainer.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    wall_ms = batch / result["samples_per_s"] * 1e3
    busy_us = sum(e.get("dur", 0) for e in kernels)
    groups, top = by_group(kernels, STEPS)
    print(json.dumps({
        "phase": "profile", "model": model, "card": smi, "steps": STEPS,
        "batch": batch, "wall_ms_per_step": wall_ms,
        "items_per_s": result["samples_per_s"] * per_sample,
        "device_busy_ms_per_step": busy_us / 1e3 / STEPS,
        "idle_share": 1 - busy_us / 1e3 / STEPS / wall_ms,
        "kernels_per_step": len(kernels) / STEPS,
        "group_ms_per_step": groups, "top_kernels_ms_per_step": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
