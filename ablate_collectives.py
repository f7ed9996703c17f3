#!/usr/bin/env python3
"""What holds the direct allreduce (B5) and reduce-scatter (B6) back, on
one NVIDIA GPU.

Run from the root of a checkout:

    python3 ablate_collectives.py

It builds the kernel source `ray_tpu_torch/ops/csrc/ring_collectives.cu`
as it is and in variants:

- unroll8: eight 16-byte loads in flight a thread and source, not four;
- no_done: without the closing round of done flags (its results may be
  wrong, since a rank may end before its peers have written its output;
  only its time means something);

and times one call of each (every rank's kernel, w ranks on the card, each
on its own stream) at GPT-2's gradient bucket, at w = 2 and 4, with the
grid at the port's cap (SMs / (2 w) blocks a rank) and at twice it (all
ranks' blocks then still fit on the card at once, as they must: a block
spins on its peers' blocks); beside the allreduce, w plain copies of each
rank's input into its output on the ranks' streams (the same bytes: each
input read once, each output written once, with no protocol). CUDA
events, L2 flushed before each launch, median of 25, the variants in
turns, twice.
Every variant but no_done is held bit for bit against the plain version
first. One JSON line per (kernel, w), then the card's name and power
limit. Without CUDA it exits 2.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

# variant: [(text of the source, its replacement)]
VARIANTS = {
    "kernel": [],
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "no_done": [("  done_round(a, deadline);\n}", "}")],
}
WORLDS = (2, 4)
GRID_FACTORS = (1, 2)


def _variant_source(src, edits):
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"ablate_collectives: the source no longer "
                               f"has {old.strip()!r}; update VARIANTS")
        src = src.replace(old, new)
    return src


def _build(out_dir):
    """{variant: CDLL} built in parallel, one nvcc each."""
    from ray_tpu_torch.ops import _build as build

    src = (build.CSRC / "ring_collectives.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(_variant_source(src, edits))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs


def _call(ops, fn, xs, lib):
    """One call of every rank, its kernels from `lib` (the wrappers load
    their library at each launch)."""
    import chip_smoke
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    pb._build.load = lambda _: lib
    return chip_smoke._ring_call(ops, fn, xs)


def main():
    if not torch.cuda.is_available():
        print("ablate_collectives: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.collective.backends import device_backend as db
    from ray_tpu_torch.collective.backends import pallas_backend as pb
    from ray_tpu_torch.train import sharding

    dev = torch.device("cuda", 0)
    libs = _build(Path(__file__).resolve().parent / "build" / "ablate_ring")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = chip_smoke.flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    load = pb._build.load
    try:
        for w in WORLDS:
            for kind, length in (
                    ("allreduce",
                     w * -(-db._bucket(chip_smoke.GPT2_NUMEL) // w)),
                    ("reducescatter",
                     sharding.padded_numel(chip_smoke.GPT2_NUMEL, w))):
                xs = chip_smoke._ring_inputs("add", torch.float32, length, w,
                                             dev, gen)
                cap = max(1, sms // (2 * w))
                runs, ms = {}, {}
                for name, lib in libs.items():
                    for f in GRID_FACTORS:
                        label = f"{name} x{f}"
                        ops = [col.init_collective_group(
                            w, r, group_name=f"ablate_{w}_{label}")
                            for r in range(w)][0].group.transport._ops
                        ops._max_blocks = cap * f
                        fn, plain, _ = chip_smoke._ring_fns(ops, kind, "add")
                        got = _call(ops, fn, xs, lib)
                        torch.cuda.synchronize()
                        for r in range(w):
                            ops.check(r)
                        if name != "no_done" and not all(
                                torch.equal(g, p)
                                for g, p in zip(got, plain(xs))):
                            raise RuntimeError(f"{kind} w={w} {label} "
                                               "differs from the plain "
                                               "version")
                        runs[label] = (ops, fn, lib)
                        ms[label] = []
                outs = [torch.empty_like(x) for x in xs]
                streams = [torch.cuda.Stream(dev) for _ in range(w)]
                if kind == "allreduce":
                    ms["copies"] = []

                def copies():
                    cur = torch.cuda.current_stream()
                    for s, x, o in zip(streams, xs, outs):
                        s.wait_stream(cur)
                        with torch.cuda.stream(s):
                            o.copy_(x)
                    for s in streams:
                        cur.wait_stream(s)

                for _ in range(2):
                    for label, (ops, fn, lib) in runs.items():
                        ms[label].append(chip_smoke.time_ms(
                            lambda: _call(ops, fn, xs, lib), flush=flush))
                    if kind == "allreduce":
                        ms["copies"].append(chip_smoke.time_ms(copies,
                                                               flush=flush))
                bound_ms, _, _ = chip_smoke._ring_bound(runs["kernel x1"][0],
                                                        kind, length, w, 4)
                print(json.dumps({"kind": kind, "w": w, "length": length,
                                  "blocks_cap": cap, "bound_ms": bound_ms,
                                  "ms": ms}), flush=True)
                for label in runs:
                    col.destroy_collective_group(f"ablate_{w}_{label}")
                del xs, outs, runs
                torch.cuda.empty_cache()
    finally:
        pb._build.load = load
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
