#!/usr/bin/env python3
"""What holds the direct allreduce (B5), the reduce-scatter (B6) and the
quantized allreduce (B8) back, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 ablate_collectives.py [allreduce] [reducescatter] [quantized]
                                  [dp]

(the three kernels without arguments; dp only when named).
It builds the kernel source `ray_tpu_torch/ops/csrc/ring_collectives.cu`
as it is and in variants, each its own library, all built in parallel:

- unroll8: eight 16-byte loads in flight a thread and source, not four
  (B5, B6);
- no_done: without the closing round of done flags (its results may be
  wrong, since a rank may end before its peers have written its output;
  only its time means something);
- q_unroll1: B8 with one quant block in flight a warp in both halves,
  not 4 and 8 (the access of the ring kernel it replaced);
- q_recip: B8 with each x / scale as a product with the rounded
  reciprocal (other bits; only its time means something);
- q_cvt: B8 with its int8 conversions on the card's conversion units
  (rintf, float to int, int to float) instead of FP32 and byte
  arithmetic (the same bits);
- q_shfl: B8 with the quant block's absmax over five shuffles, not one
  redux.sync (the same bits);
- q_regs64: B8 built for two blocks an SM, at most 64 registers a thread
  (the same bits);

and times one call of each (every rank's kernel, w ranks on the card, each
on its own stream) at GPT-2's gradient bucket, at w = 2 and 4, with the
grid at the port's cap (SMs / (2 w) blocks a rank) and at twice it (all
ranks' blocks then still fit on the card at once, as they must: a block
spins on its peers' blocks); beside it, w plain copies of each rank's
input into its output on the ranks' streams (the same f32 bytes: each
input read once, each output written once, with no protocol), and for B8
the same copies plus a copy of half its int8 wire bytes a rank
("copies_wire": the bytes the bound with the wire counts). CUDA events,
L2 flushed before each launch, median of 25, the variants in turns,
twice. Every variant that keeps the bits is held bit for bit against the
plain version first. One JSON line per (kernel, w), then the card's name
and power limit. `dp` times the GPT-2 data-parallel path of
chip_smoke.py (two ranks on the card, 12 x 1024 tokens a rank) with B8
as built and as q_regs64, the exact run beside them, in turns (exact,
kernel, q_regs64, q_regs64, kernel, exact): what a kernel's registers
cost the step while its blocks wait for the peer's backward. Without
CUDA it exits 2.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ray_tpu_torch.ops import _build as _ops_build

_LOAD = _ops_build.load

# variant: [(text of the source, its replacement)]
VARIANTS = {
    "kernel": [],
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "no_done": [("  done_round(a, deadline);\n}", "}")],
    "q_unroll1": [("constexpr int kQUnroll = 4;", "constexpr int kQUnroll = 1;"),
                  ("constexpr int kGUnroll = 8;", "constexpr int kGUnroll = 1;")],
    "q_recip": [("__fdiv_rn(v[j], s)", "__fmul_rn(v[j], __frcp_rn(s))")],
    "q_cvt": [("t[j] = __fadd_rn(fminf(fmaxf(__fdiv_rn(v[j], s), -127.f), "
               "127.f),\n                     kRound);",
               "t[j] = __int_as_float(static_cast<int>(rintf(fminf(fmaxf("
               "__fdiv_rn(v[j], s), -127.f), 127.f))));"),
              ("__fsub_rn(__uint_as_float(__byte_perm(k, 0x4B000000u, "
               "0x7440 + j)),\n                  kBias)",
               "static_cast<float>(static_cast<signed char>(q >> (8 * j)))")],
    "q_regs64": [("__launch_bounds__(kThreads) quantized_allreduce",
                  "__launch_bounds__(kThreads, 2) quantized_allreduce")],
    "q_shfl": [("m = __uint_as_float(__reduce_max_sync(0xffffffffu, "
                "__float_as_uint(m)));",
                "for (int o = 16; o > 0; o >>= 1) "
                "m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));")],
}
# (variant, grid factor) runs of each kernel
RUNS = {
    "allreduce": [(v, f) for v in ("kernel", "unroll8", "no_done")
                  for f in (1, 2)],
    "reducescatter": [(v, f) for v in ("kernel", "unroll8", "no_done")
                      for f in (1, 2)],
    "quantized": [("kernel", 1), ("kernel", 2), ("q_unroll1", 1),
                  ("q_recip", 1), ("q_cvt", 1), ("q_shfl", 1),
                  ("q_regs64", 1), ("no_done", 1)],
}
OTHER_BITS = {"no_done", "q_recip"}
WORLDS = (2, 4)


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


def _use(lib):
    """The collective kernels from `lib` from now on (the wrappers load
    their library at each launch); the other sources as built."""
    from ray_tpu_torch.ops import _build as build

    build.load = lambda name, load=_LOAD: (
        lib if name == "ring_collectives" else load(name))


def _call(ops, fn, xs, lib):
    """One call of every rank, its kernels from `lib`."""
    import chip_smoke

    _use(lib)
    return chip_smoke._ring_call(ops, fn, xs)


def _use_in_worker(trainer, path):
    """_use of the variant library at `path` in every rank's worker
    process (the ranks run there, not in this one)."""
    import ray_tpu_torch

    def setup(ops):
        _use(ctypes.CDLL(path))

    ray_tpu_torch.get([w.run.remote(setup) for w in trainer.workers])


def _dp(libs):
    """The int8 DP path with B8 as built and as q_regs64, the exact run
    beside them, in turns; one JSON line each."""
    import chip_smoke
    import ray_tpu_torch
    from ray_tpu_torch.models import transformer

    params = transformer.params_to_jax(
        transformer.GPT(chip_smoke.gpt2_config(), seed=0))
    ray_tpu_torch.init(object_store_memory=chip_smoke.STORE_BYTES)
    try:
        for label, name, kwargs in (
                ("exact", "kernel", {}),
                ("int8", "kernel", {"quantize": "int8"}),
                ("int8", "q_regs64", {"quantize": "int8"}),
                ("int8", "q_regs64", {"quantize": "int8"}),
                ("int8", "kernel", {"quantize": "int8"}),
                ("exact", "kernel", {})):
            trainer = chip_smoke._dp_trainer(
                params, chip_smoke.GPT_BATCH, torch.bfloat16,
                chip_smoke._adamw, chip_smoke.WARMUP + chip_smoke.DP_STEPS
                + chip_smoke.DP_PROFILE_STEPS, **kwargs)
            _use_in_worker(trainer, libs[name]._name)
            fields, _, _ = chip_smoke._dp_measure(trainer, label)
            print(json.dumps({"dp": label, "b8": name, **{
                k: fields[k] for k in ("tokens_s",
                                       "collective_share_of_device_time",
                                       "device_busy_ms_per_step",
                                       "wall_ms_per_step_profiled")}}),
                  flush=True)
    finally:
        ray_tpu_torch.shutdown()


def _copies(xs, wire_bytes):
    """Each rank's input into an output on its own stream, and (wire_bytes)
    a uint8 copy of that many bytes a rank beside it."""
    dev = xs[0].device
    outs = [torch.empty_like(x) for x in xs]
    streams = [torch.cuda.Stream(dev) for _ in xs]
    extra = [(torch.empty(wire_bytes, dtype=torch.uint8, device=dev),
              torch.empty(wire_bytes, dtype=torch.uint8, device=dev))
             for _ in xs] if wire_bytes else []

    def run():
        cur = torch.cuda.current_stream()
        for i, (s, x, o) in enumerate(zip(streams, xs, outs)):
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                o.copy_(x)
                if extra:
                    extra[i][1].copy_(extra[i][0])
        for s in streams:
            cur.wait_stream(s)

    return run


def main():
    if not torch.cuda.is_available():
        print("ablate_collectives: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.collective.backends import device_backend as db
    from ray_tpu_torch.train import sharding

    dev = torch.device("cuda", 0)
    libs = _build(Path(__file__).resolve().parent / "build" / "ablate_ring")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = chip_smoke.flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    kinds = [k for k in sys.argv[1:] if k != "dp"] or (
        [] if sys.argv[1:] else ["allreduce", "reducescatter", "quantized"])
    n = chip_smoke.GPT2_NUMEL
    try:
        for w in WORLDS:
            for kind, length in (
                    ("allreduce", w * -(-db._bucket(n) // w)),
                    ("reducescatter", sharding.padded_numel(n, w)),
                    ("quantized", db._qring_pad(n, w))):
                if kind not in kinds:
                    continue
                xs = chip_smoke._ring_inputs("add", torch.float32, length, w,
                                             dev, gen)
                cap = max(1, sms // (2 * w))
                runs, ms = {}, {}
                for name, f in RUNS[kind]:
                    label = f"{name} x{f}"
                    ops = [col.init_collective_group(
                        w, r, backend="xla",
                        group_name=f"ablate_{kind}_{w}_{label}")
                        for r in range(w)][0].group.transport._ops
                    ops._max_blocks = cap * f
                    fn, plain, _ = chip_smoke._ring_fns(ops, kind, "add")
                    got = _call(ops, fn, xs, libs[name])
                    torch.cuda.synchronize()
                    for r in range(w):
                        ops.check(r)
                    if name not in OTHER_BITS and not all(
                            torch.equal(g, p)
                            for g, p in zip(got, plain(xs))):
                        raise RuntimeError(f"{kind} w={w} {label} differs "
                                           "from the plain version")
                    del got
                    runs[label] = (ops, fn, libs[name])
                    ms[label] = []
                copies = {}
                if kind != "reducescatter":
                    copies["copies"] = _copies(xs, 0)
                if kind == "quantized":
                    copies["copies_wire"] = _copies(
                        xs, chip_smoke._qwire_bytes(length, w) // (2 * w))
                ms.update({k: [] for k in copies})
                for _ in range(2):
                    for label, (ops, fn, lib) in runs.items():
                        ms[label].append(chip_smoke.time_ms(
                            lambda: _call(ops, fn, xs, lib), flush=flush))
                    for label, run in copies.items():
                        ms[label].append(chip_smoke.time_ms(run,
                                                            flush=flush))
                bound_ms, _, _ = chip_smoke._ring_bound(
                    len({d.index for d in runs["kernel x1"][0].devices}),
                    kind, length, w, 4)
                row = {"kind": kind, "w": w, "length": length,
                       "blocks_cap": cap, "bound_ms": bound_ms, "ms": ms}
                if kind == "quantized":
                    row["bound_wire_ms"] = chip_smoke._qbound_wire_ms(length,
                                                                      w)
                print(json.dumps(row), flush=True)
                for label in runs:
                    col.destroy_collective_group(
                        f"ablate_{kind}_{w}_{label}")
                del xs, runs, copies
                torch.cuda.empty_cache()
        if "dp" in sys.argv[1:]:
            del flush
            torch.cuda.empty_cache()
            _dp(libs)
    finally:
        _ops_build.load = _LOAD
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
