#!/usr/bin/env python3
"""Where the time of the port's main paths goes, on one NVIDIA GPU.

Run from the root of a checkout (after, or without, chip_smoke.py):

    python3 profile_step.py [--model resnet50|gpt2]

It starts the port's runtime and trains the model through
`ray_tpu_torch.train.Trainer` exactly as chip_smoke.py's train phases do
(resnet50: batch 256, 224², bf16, bn_mode="kernel"; gpt2: GPT-2 124M,
batch 12 x 1024 tokens, bf16, ops_mode="kernel", AdamW), warms up, then
traces one epoch of STEPS steps in its worker actor with torch.profiler
(`train(profile_dir=)`, a chrome trace) and prints one JSON line: the wall time
per step (the epoch's own clock, profiler on), the device's busy time per
step (sum of kernel times; one stream) and idle share, device time per
kernel group, and the top kernels by device time. Without CUDA it exits 2.
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("resnet50", "gpt2"),
                        default="resnet50")
    model = parser.parse_args().model
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
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
            with open(glob.glob(os.path.join(trace_dir, "*.json"))[0]) as f:
                events = json.load(f)["traceEvents"]
        trainer.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    wall_ms = batch / result["samples_per_s"] * 1e3
    kernels = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_us = sum(e.get("dur", 0) for e in kernels)
    per_group, per_name = {}, {}
    for e in kernels:
        g = group_of(e["name"])
        per_group[g] = per_group.get(g, 0.0) + e.get("dur", 0)
        per_name[e["name"]] = per_name.get(e["name"], 0.0) + e.get("dur", 0)
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
