#!/usr/bin/env python3
"""Where the time of the port's main paths goes, on one NVIDIA GPU.

Run from the root of a checkout (after, or without, chip_smoke.py):

    python3 profile_step.py [--model resnet50|gpt2]

It trains the model through `ray_tpu_torch.train.Trainer` exactly as
chip_smoke.py's train phases do (resnet50: batch 256, 224², bf16,
bn_mode="kernel"; gpt2: GPT-2 124M, batch 12 x 1024 tokens, bf16,
ops_mode="kernel", AdamW), warms up, then traces one epoch of STEPS steps
of its worker with torch.profiler and prints one JSON line: the wall time
per step (the epoch's own clock, profiler on), the device's busy time per
step (sum of kernel times; one stream) and idle share, device time per
kernel group, and the top kernels by device time. Without CUDA it exits 2.
"""

import argparse
import json
import sys

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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("resnet50", "gpt2"),
                        default="resnet50")
    model = parser.parse_args().model
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from ray_tpu_torch.train import Trainer

    if model == "resnet50":
        torch.backends.cudnn.benchmark = True
        op_cls, batch, per_sample = chip_smoke._operator_cls(), \
            chip_smoke.BATCH, 1
    else:
        op_cls, batch = chip_smoke.gpt2_operator_cls(), chip_smoke.GPT_BATCH
        per_sample = chip_smoke.gpt2_config().max_seq
    trainer = Trainer(op_cls, num_workers=1, config={"steps": STEPS},
                      resources_per_worker={"GPU": 1})
    trainer.train(num_steps=chip_smoke.WARMUP)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the worker's epoch: Trainer.train without its state snapshot
        result = trainer.workers[0].train_epoch(STEPS)
    wall_ms = batch / result["samples_per_s"] * 1e3
    trainer.shutdown()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    per_group, per_name = {}, {}
    for e in kernels:
        g = group_of(e.name)
        per_group[g] = per_group.get(g, 0.0) + e.device_time_total
        per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:15]
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(json.dumps({
        "phase": "profile", "model": model, "card": smi, "steps": STEPS,
        "batch": batch, "wall_ms_per_step": wall_ms,
        "items_per_s": result["samples_per_s"] * per_sample,
        "device_busy_ms_per_step": busy_us / 1e3 / STEPS,
        "idle_share": 1 - busy_us / 1e3 / STEPS / wall_ms,
        "kernels_per_step": len(kernels) / STEPS,
        "group_ms_per_step": {g: t / 1e3 / STEPS
                              for g, t in sorted(per_group.items(),
                                                 key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[n[:120], t / 1e3 / STEPS]
                                    for n, t in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
