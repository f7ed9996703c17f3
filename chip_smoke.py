#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port, ray_tpu_torch, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds every kernel under ray_tpu_torch/ops/csrc/ with nvcc, holds each
against its plain PyTorch version at the shapes of the main paths,
starts the port's runtime (`ray_tpu_torch.init()`) on the card, and
drives the main paths through `ray_tpu_torch.train.Trainer`, each of
whose ranks runs in a TrainWorker actor, a process of its own on the
card: ResNet-50 training at batch 256, 224², bf16, with the batchnorm
backward sums in the hand-written kernel; GPT-2 124M training at batch 12
x 1024 tokens, bf16, with every layernorm and flash-attention forward in
the hand-written kernels; ViT-B/16 and BERT-base the same way; the same
GPT-2 data-parallel over two ranks in two processes that share the card
(min(4, cards) ranks, a card each, on a machine with more), with the
gradient collectives in the hand-written ring kernels across the
processes. The parallel axes (ring attention, Ulysses, expert routing,
the pipeline) and the MoE transformer run SPMD on rank actors, a card a
rank; Serve decodes with its KV arena on the card; RLlib's PPO and
IMPALA learn CartPole with the learner on the card, fed by CPU rollout
actors. Each phase prints one JSON line:

1. device: nvidia-smi's name and power limit, torch, CUDA and nvcc.
2. build: nvcc of every source, one process each, all started together.
3. kernels: each kernel against its plain version: error, bit-identity of
   two runs, and times (CUDA events, median of 25, L2 flushed before
   each) beside the bound and the library call that computes the same
   function (timed as a yardstick only, never called by the port).
   bn_bwd_sums at each of ResNet-50's batchnorm shapes (taken from a
   forward pass of the model) and one ragged shape; layernorm and rmsnorm
   at GPT-2's [12288, 768] and a ragged [1000, 100]; flash attention at
   GPT-2's shape (causal), a BERT-base shape (not causal), one
   single-block shape and two float32 shapes (head dims 64 and 16).
4. resnet50_step: one step of bn_mode="kernel" against "plain" from the
   same weights and batch: float32 (TF32 off) at batch 32, and bf16 at
   batch 64.
5. gpt2_step: one loss and gradient of ops_mode="kernel" against "plain"
   from the same weights and tokens: float32 (TF32 off) at batch 2 x 1024,
   and bf16 at batch 12 x 1024, each kernel call also held against its
   plain version on its own inputs.
6. runtime: the cluster's GPU count against nvidia-smi's; a num_gpus=1
   actor in a process and CUDA context of its own (CUDA_VISIBLE_DEVICES,
   the card's name); a 256 MB bf16 tensor from the driver to it through
   put, summed on its card, and back bit-equal, twice (put, round-trip
   and get ms); /dev/shm and the object store.
   The train phases run in the worker actors: every kernel counter is set
   to 0 in each worker and in the driver just before the measured
   train(), each rank's are read through read_counter from its own
   worker just after, and the driver's must still be 0. Each prints framework_fraction (the
   worker's throughput against the raw loop, run in the driver after the
   trainer's shutdown) and the driver's wall time per train(), which
   holds the actor boundary and the state_dict that comes back after
   each epoch.
7. train: the ResNet-50 main path, with the raw-loop control and the
   launch count; train_gpt2: the GPT-2 main path, with the raw-loop
   control, tokens/s and the launches per step.
8. collectives (run after kernels): the collective kernels B5-B8 (B5-B7
   direct; B8 the int8 allreduce, its reduce half the ring's hops, its
   gather direct) against their plain versions, which run the
   reference's ring schedule, bit for bit, at w = 2, 3, 4 ranks on the
   card (one stream each), at 4096 f32 (16 KB), 16 MB, a ragged 10,007
   and GPT-2's gradient bucket (every kernel at w = 2; the f32 allreduce
   add, the reduce-scatter, the allgather and B8 add at w = 3 and 4 too);
   every op and dtype the kernels are built for (B8: add, max, min); 200
   back-to-back calls of each kernel with a random skew a rank; a
   withheld rank that must raise TimeoutError naming it (B5-B8 at w = 2,
   3, 4; B8 through a group made with quantize="int8"); times of one
   call (every rank's kernel) beside the bound, B8's also beside a bound
   that counts its int8 wire, and one PyTorch call over the ranks'
   tensors.
9. collectives_procs (run after runtime): B5-B8 as the main path runs
   them, a rank a process: rank actors joined to one per-process
   HostGroup (transport "pallas"), w = 2 and 4 on one card ({"GPU": 1/w}
   each) or, on a machine with more cards, w = 2 and min(4, cards) a card
   each: every built op and dtype at a ragged 10,007 and the four kernels
   at GPT-2's bucket, each rank's output's sha256 against the plain
   version's, which this process computes from the same seeded inputs;
   the group's route of each case as the reference's size gate picks it
   (ranks sharing a card: the kernels at every size; a card a rank: the
   kernels up to 64 KB and for int8 at every size, NCCL above for the
   rest, where the kernels are held through their transport alone);
   every rank's launches counted in its own process and none here; a
   withheld rank that each peer names in a TimeoutError; the ms of one
   call (every rank's phases and copies) beside the bound and the copies'
   ms; where every rank holds a card of its own, the NCCL tier's sum and
   ms and the crossover table (one f32 sum through the group by NCCL and
   by the kernels at 16 KB, 64 KB, 256 KB, 1 MB and the bucket), else the
   NCCL tier's vote of 0 and a forced "device" group's RuntimeError.
10. train_gpt2_dp: GPT-2 124M through Trainer(num_workers=2 (one card) or
   min(4, cards), collective_transport="pallas") at 12 x 1024 tokens a
   rank, a worker process a rank, exact, quantize="int8" and
   sharded=True: tokens/s over the ranks beside the in-process layout's
   earlier tokens/s, ring launches of each rank read from its own worker
   (one card: the kernels carry every bucket; a card a rank: the size
   gate sends the unquantized bucket to NCCL, and the device tier's ops
   are counted instead, while B8 keeps the int8 one), each tier's ops,
   the collectives' share of device time, peak memory, losses (the
   device times from every rank's train(profile_dir=) chrome trace); the
   ranks bit-identical (a digest of each rank's parameters), in distinct
   processes, sharded bit-identical to exact on one card (a card a rank:
   within DP_SHARDED_TOL by relative L2, and a sharded run on half the
   batch beyond it), int8 within a band of exact with its saved bytes
   counted, and a float32 DP step (and, a card a rank, a sharded one)
   against a single-worker step at the combined batch.
11. train_gpt2_elastic: the Trainer's fault tolerance on GPT-2 124M's
   widths at 6 of its 12 layers, sharded over the same ranks, every rank
   the same tokens, 6 steps an epoch: an uninterrupted control of 3 epochs in one generation,
   gang-reserved (ICI_RING, placed as PACK); an elastic run (epoch 1,
   save, epoch 2 with rank 1's process SIGKILLed by a driver timer
   halfway through, so train() re-gangs at full size and retries it, a
   resize to one rank, epoch 3); a fresh one-rank trainer that loads the
   epoch-1 checkpoint and trains epoch 2. Both equal the control bit for
   bit (losses by ==, a digest of every rank's parameters); B6 and B7 launch
   in every generation's ranks (none at one rank) and never in the
   driver; the reservation is CREATED and gone after shutdown; no
   segment of the dead generation is left. It prints the re-gang's
   seconds (the death to the next generation restored), sync_state's,
   save's and load's, and the checkpoint's bytes.
12. train_ingest (after train): ResNet-50 as phase train runs it, fed by
   Trainer(ingest=IngestSpec(depth 2)) from a DatasetShard actor that
   streams host batches, a distinct one each step, through the object
   store, and an in-memory control of the same batches, cuDNN
   deterministic in both: img/s of both beside phase train's and the raw
   loop's, train.ingest_wait_s p50 and p99 of the measured epoch (from
   the worker), the worker's B1 launches, the two arms' losses (bit for
   bit).
13. train_gpt2_mesh (after train_gpt2_dp): GPT-2 124M under
   config={"multihost": True} on min(4, cards) ranks, a card a rank:
   mesh_mode="fsdp" (the table's (w, 1): data parallel) and an explicit
   (1, w) ('data','fsdp') mesh with its parameters sharded: tokens/s of
   each timed epoch, peak memory a rank, the relative L2 of the second's
   parameters against the first's (within MESH_TOL, and the first's one
   step later beyond it), B2 and B3 in every rank's process; ProcessMeshGroup's
   allreduce (SUM, MAX), broadcast, allgather, reducescatter and
   shift_right bit for bit against their plain versions. On one card one
   worker with mesh_mode="fsdp" (a (1, 1) mesh), and a multihost trainer
   of two ranks must raise (NCCL refuses two ranks on one card). On every
   card shift_right on the in-process group (the allgather kernel).
14. train_vit, train_bert (after train_gpt2): ViT-B/16 (224², patch 16,
   12 x 768, 1000 classes; batch 64) and BERT-base (12 x 768, T 512,
   vocab 30522; batch 8, two segments, no pad mask), bf16, AdamW, through
   Trainer (one worker, {"GPU": 1}) beside the raw loop: img/s or seq/s
   and tokens/s, framework_fraction, launches a step (ViT: 49 layernorm,
   its 197 tokens on the dense attention route as in the reference;
   BERT: 49 layernorm and 24 non-causal flash); one step of
   ops_mode="kernel" (every call checked) against "plain" on the same
   weights and batch, and its control (layernorm weights off by
   FAMILY_FAULT) beyond the limit; BERT also one padded batch in the
   worker (dense masked_attention, no flash launch) whose [CLS] logits
   the padded tokens may not move.
15. parallel: on w = min(4, cards) rank actors, a card each, in one
   multihost runtime (one card: the w = 1 mesh through the same code),
   at the MoE model's shapes (4 x 4096 tokens, 8 heads of 64, d 512,
   8 experts of 1024; f32, TF32 off): shard_map of ring attention
   (causal, full) and Ulysses with a replicated weight, moe_apply with
   no token dropped, and pipeline_apply of GPT-2's twelve blocks over
   pp = w stages, each against its dense or sequential control on the
   same card, forward and gradients, each with controls that must fail.
   On four cards also the MoE transformer (the default widths, f32, 2 x
   1024 tokens) on (tp 2, sp 2) and on (pp 2, sp 2), each against the
   same weights on (sp 2, ep 2): logits, aux, loss and every gradient,
   with each rank's gradients left un-summed over tp or pp as the
   control.
16. train_moe: the default MoETransformerConfig() (ring, bf16) at 4 x
   4096 tokens on the same ranks, (1, 1, 1, 1, 1) on one card and sp = 2
   x ep = 2 on four: AdamW steps, tokens/s, aux in (0.5, 4.0), the
   layernorm launches in every rank's process, ring against Ulysses
   logits on the same weights (the logits one step later beyond it).
17. serve (after the rank actors' release): serve.start() and the
   reference's integer ShardedTokenLM (vocab 32, hidden 8, inner 1024)
   deployed with its paged KV arena on the card (kv_backend="torch",
   2 GiB a rank, pages of 16, prefix sharing, 32 sequences a decode
   batch): num_shards=1, then num_shards=2 with both members on this
   card. Each takes 128 streams through the handle, 32 in flight
   (prompts of 32-96 tokens, half behind one 64-token prefix, 32-96 new
   tokens), and four sessions' second turns: tokens/s, TTFT and
   decode-step p50 / p99 from the engine's histograms, prefix hits and
   tokens saved, each rank's arena bytes and memory_allocated; every
   stream equal to ShardedTokenLM.generate, and after the traffic only
   the four retained sessions hold pages (pages in use equal to the
   pages of their tables), no leak, and the same tables on every rank
   of the gang. Then a follower of the gang is
   killed mid-decode: its 8 open streams end in ReplicaGroupDied within
   the group timeout, the dead leader holds no page, and the restarted
   gang decodes exactly. Also the arena's one-row and 64-row append and
   gather_sum ms on the card. Serve shuts down and its processes are
   gone before the next phase.
18. rllib (after serve): RLlib's on-policy path. PPO's learner on the
   card (TF32 off) against the CPU from the same weights and a 256-step
   CartPole batch: compute_gradients, each leaf within RL_STEP_TOL by
   relative L2, then one learn_on_batch: the weights and the update
   within it, the loss and its terms within it of the loss. Then
   PPOTrainer and ImpalaTrainer at rlbench's configuration (CartPole-v1,
   2 CPU rollout actors x 2 envs, the fcnet), the learner in this
   process on the card: PPO past RL_BAR after 8 train()s, IMPALA's best
   past it in 20, each actor's weights equal to the learner's after
   PPO's broadcast, each actor with no card (CUDA_VISIBLE_DEVICES empty,
   its policy on the CPU); over the train()s after the first (7 and 19,
   rlbench.measure): env-steps/s, the learner's grad s and ms a
   learn_on_batch, its busy share and utilization, and its
   memory_allocated. The path launches no hand-written kernel.
Then each phase's seconds (phase_seconds, with release_par_ranks: the
rank actors of 15-16 killed, their processes gone and their cards free
again), the card's name and power
limit, the kernels summary line and, last,
{"ok": true, "device": {...}}. `--only collectives_procs,train_gpt2_dp`
runs the device and build phases and then only the named ones, the
runtime started as in a whole run where one of them needs it, and prints
no result line. A failed phase raises: the script exits
non-zero and prints no result. Without CUDA it exits 2 at once.
"""

import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

# Peak rates of an H100 SXM for the bounds (NVIDIA data sheet, at its
# 700 W limit): memory bytes/s, float32 operations/s outside the tensor
# cores. The card's name and limit print beside every result.
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67.0e12
PEAK_BF16_OPS_S = 989.0e12  # dense, tensor cores
NVLINK_BYTES_S = 450.0e9  # one H100's NVLink, each way

BATCH, HW, STEPS, WARMUP = 256, 224, 30, 3
# kernel vs plain sums: |kernel − plain| per channel over Σ|term| of that
# channel. Both sum f32 values in another order; the kernel's longest
# serial run is about a hundred terms, so the error is below
# 100 · 2^-24 ≈ 6e-6 of Σ|term|.
SUMS_TOL = 1e-4
# kernel vs plain ResNet-50 step, relative L2 error ||k − p|| / ||p|| of
# the loss, of each running statistic, of each gradient ("grad") and of
# all gradients together ("grads_all").
# float32, TF32 off: both backwards do the same f32 math in another order
# (1.5e-5 per gradient on the CPU at 128², batch 8).
# bfloat16: the two backwards round the bf16 map dx = a·(dy − k1 −
# (x − mu)·k2) at other places (the kernel path after each op, autograd
# split into bf16 and f32 parts), 2^-9 relative per rounding, and a
# random-init ResNet-50 amplifies such differences through 53 layers: all
# gradients together differ by 9.97e-2 on an H100 (3.5e-2 on the CPU at
# 128², batch 8), a sum with heavy cancellation (stem_bn.bias) by 0.89.
# So bf16 gates all gradients together at 0.25, and holds the kernel
# itself sharply at every layer of the step: its sums against the plain
# sums on the same (x, dy) ("layer_sums", normalized as SUMS_TOL).
STEP_TOL = {"float32": {"loss": 1e-5, "state": 1e-4, "grad": 1e-3,
                        "grads_all": 1e-4, "layer_sums": SUMS_TOL},
            "bfloat16": {"loss": 1e-3, "state": 1e-2, "grads_all": 0.25,
                         "layer_sums": SUMS_TOL}}
STEP_BATCH = {"float32": 32, "bfloat16": 64}

# GPT-2 124M main path: nanoGPT's config/train_gpt2.py micro-batch
# (batch_size = 12, block_size = 1024) and its AdamW settings.
GPT_BATCH, GPT_SEQ = 12, 1024
# ViT-B/16 at 224² and BERT-base at 512 tokens (bf16, the same AdamW)
VIT_BATCH, BERT_BATCH = 64, 8
GPT_STEP_BATCH = {"float32": 2, "bfloat16": 12}
# layernorm/rmsnorm kernel vs plain, in units of the allowed difference
# (pass at <= 1): bf16, one bf16 ulp of the plain value plus 1e-6 of the
# largest |value| (both cast one f32 value at the store, and the f32
# values differ by the order of the row sums, which can move a value
# across a bf16 rounding boundary; near 0, where y·w + b cancels, that
# f32 difference exceeds the element's own ulp); f32, 1e-5 of the
# largest |value|.
NORM_TOL = 1.0
# flash kernel vs plain, per element of o, in units of the allowed
# difference (pass at <= 1), scaled by the largest |value| of the
# element's row (one query of one head, D values), never by the whole
# output's. bf16: one bf16 ulp of the plain value plus 2^-8 of its row's
# largest |value|. Both cast the f32 o / l once at the store, which
# differs by at most one ulp where the two f32 values straddle a rounding
# boundary; and both cast p to bf16 before p·V, so where the f32 scores
# (tensor-core sums vs f32 matmuls, in another order) move one p_j across
# a bf16 boundary, o moves by 2^-8·(p_j / l)·|v_j| at most, which the
# row term holds. f32: 1e-5 of the row's largest |value|, the same f32
# arithmetic in another order.
FLASH_TOL = 1.0
# kernel vs plain GPT-2 step, relative L2 error of the loss, of each
# gradient ("grad") and of all gradients together ("grads_all"); every
# layernorm and flash call of the kernel step is also held against its
# plain version on its own inputs ("layers", in units of the allowed
# difference of NORM_TOL and FLASH_TOL: pass at <= 1).
# float32, TF32 off: the same f32 math in another order.
# bfloat16: the kernels round like the plain versions but differ by a
# bf16 ulp where their f32 sums straddle a rounding boundary; twelve
# blocks at random init carry such differences into every gradient.
GPT_STEP_TOL = {"float32": {"loss": 1e-5, "grad": 1e-3, "grads_all": 1e-4,
                            "layers": 1.0},
                "bfloat16": {"loss": 1e-2, "grads_all": 5e-2,
                             "layers": 1.0}}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def flush_buffer(dev):
    """512 MB to overwrite before each timed launch: ten times the 50 MB
    L2. Its memset (about 0.17 ms at the memory rate) also keeps the card
    busy while the host runs a kernel's wrapper up to the launch: were the
    memset shorter than that host time, the card would idle between the
    start event and the kernel, and a slow host would add to a short
    kernel's time."""
    return torch.empty(128 << 20, device=dev)


def time_ms(fn, iters=25, warmup=3, flush=None):
    """Median ms of fn over iters launches, CUDA events around each, the
    L2 cache flushed before each when a flush buffer is given."""
    pairs = []
    for i in range(warmup + iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        if i >= warmup:
            pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_device():
    from ray_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc.strip().splitlines()[-1])
    return smi


def _ptxas_table(log):
    """{kernel: {registers, smem, spill_stores, spill_loads}} from one
    nvcc -Xptxas -v log (smem: static bytes; the flash kernel's tiles are
    dynamic)."""
    import re
    import shutil

    table, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            table[name] = {}
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            table[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            smem = re.search(r"(\d+) bytes smem", ln)
            table[name].update(registers=int(regs.group(1)),
                               smem=int(smem.group(1)) if smem else 0)
    if shutil.which("c++filt") and table:
        names = subprocess.run(["c++filt"], input="\n".join(table),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(table):
            table = dict(zip(names, table.values()))
    return table


def _sass_counts(name, ops):
    """Occurrences of each SASS opcode in ops in the built library."""
    from pathlib import Path

    from ray_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build._target(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return {op: sass.count(op) for op in ops}


def phase_build():
    """Builds every source; prints each kernel instance's registers, static
    shared memory and spills from ptxas, and the wgmma (HGMMA) and TMA
    load (UTMALDG) instructions in the flash library's SASS. Fails on a
    spill in the flash or ring kernels or on a flash library without
    either instruction."""
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: _ptxas_table(log) for name, log in logs.items()}
    sass = _sass_counts("flash_attn_fwd", ("HGMMA", "UTMALDG"))
    # every instance of the flash and ring kernels; the other sources in sum
    shown = {name: (table if name in ("flash_attn_fwd", "ring_collectives")
                    else {"instances": len(table),
                          "max_registers": max(v["registers"]
                                               for v in table.values()),
                          "spill_bytes": sum(v["spill_stores"]
                                             + v["spill_loads"]
                                             for v in table.values())})
             for name, table in ptxas.items() if table}
    emit("build", seconds=seconds, sources=sorted(logs),
         build_dir=str(_build.BUILD_DIR), ptxas=shown, flash_sass=sass)
    spills = {k: v for name in ("flash_attn_fwd", "ring_collectives")
              for k, v in ptxas.get(name, {}).items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills or not all(sass.values()):
        raise RuntimeError(f"build: spills {spills}, flash SASS {sass}")


def resnet50_bn_shapes(dev):
    """(M, C) of every batchnorm of ResNet-50 at the main path's batch and
    size, from forward hooks on one forward pass."""
    from ray_tpu_torch.models import resnet

    model = resnet.ResNet(resnet.resnet50(bn_mode="kernel")).to(dev)
    shapes = []

    def hook(mod, inp, out):
        n, c, h, w = inp[0].shape
        shapes.append((n * h * w, c))

    for mod in model.modules():
        if isinstance(mod, resnet.BatchNorm):
            mod.register_forward_hook(hook)
    x = torch.zeros((BATCH, HW, HW, 3), device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        model(x)
    if len(shapes) != resnet.num_bn_layers(model):
        raise RuntimeError(f"hooks saw {len(shapes)} batchnorm calls")
    return shapes


def _library(x, dy, mean, inv, sums, flush):
    """(ms, max |difference| from the given sums) of the one PyTorch call
    that computes the same two sums: aten's batch_norm_backward_reduce,
    whose grad_bias is Σdy and grad_weight Σdy·(x−mean)·inv. A yardstick,
    never called by the port; (None, error text) where it refuses."""
    lib = torch.ops.aten.batch_norm_backward_reduce
    ones = torch.ones(x.shape[1], device=x.device)
    try:
        out = lib(dy, x, mean, inv, ones, False, True, True)
    except RuntimeError as e:
        return None, f"{type(e).__name__}: {str(e)[:200]}"
    err = max(float((out[3] - sums[0]).abs().max()),
              float((out[2] - sums[1]).abs().max()))
    ms = time_ms(lambda: lib(dy, x, mean, inv, ones, False, True, True),
                 flush=flush)
    return ms, err


def phase_kernels(dev):
    from ray_tpu_torch.ops import batchnorm as bn

    bytes_s, flops_s = PEAK_BYTES_S, PEAK_F32_OPS_S
    counts = collections.Counter(resnet50_bn_shapes(dev))
    ragged = (100003, 99)  # M and C multiples of neither 8 nor 32
    flush = flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for (m, c), count in sorted(counts.items()) + [(ragged, 0)]:
        x = torch.randn((m, c), generator=gen, device=dev,
                        dtype=torch.bfloat16) * 2 + 0.5
        dy = torch.randn((m, c), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        xf = x.float()
        mean = xf.mean(0)
        inv = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
        del xf
        got = bn.bn_bwd_sums(x, dy, mean, inv)
        again = bn.bn_bwd_sums(x, dy, mean, inv)
        norm_err, max_abs = _sums_error(got, x, dy, mean, inv)
        identical = all(torch.equal(a, b) for a, b in zip(got, again))
        if norm_err > SUMS_TOL or not identical:
            raise RuntimeError(f"bn_bwd_sums at ({m}, {c}): error "
                               f"{norm_err} (tol {SUMS_TOL}), bit-identical "
                               f"repeat {identical}")
        lib_ms, lib_err = _library(x, dy, mean, inv, got, flush)
        n_bytes = 2 * m * c * x.element_size() + 4 * c * 4
        n_ops = 5 * m * c
        rows.append({
            "M": m, "C": c, "count": count, "max_abs_err": max_abs,
            "norm_err": norm_err, "bit_identical": identical,
            "ms": time_ms(lambda: bn.bn_bwd_sums(x, dy, mean, inv),
                          flush=flush),
            "plain_ms": time_ms(lambda: bn.bn_bwd_sums_plain(x, dy, mean,
                                                             inv),
                                flush=flush),
            "library_ms": lib_ms, "library_max_abs_diff": lib_err,
            "bound_ms": max(n_bytes / bytes_s, n_ops / flops_s) * 1e3,
            "bound_by": ("bytes" if n_bytes / bytes_s >= n_ops / flops_s
                         else "operations")})
        del x, dy, got, again
    per_step = {k: sum(r[k] * r["count"] for r in rows)
                for k in ("ms", "plain_ms", "bound_ms")}
    lib_rows = [r["library_ms"] for r in rows]
    per_step["library_ms"] = (None if None in lib_rows else
                              sum(r["library_ms"] * r["count"] for r in rows))
    emit("kernels", kernel="bn_bwd_sums", tol=SUMS_TOL,
         launches_per_step=sum(counts.values()), per_step_ms=per_step,
         peaks={"bytes_per_s": bytes_s, "f32_ops_per_s": flops_s},
         shapes=rows)
    torch.cuda.empty_cache()
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in rows) else "operations"),
            **per_step}


def _bf16_ulp(t):
    """One bf16 ulp at each value of t (7 stored mantissa bits)."""
    mag = t.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def norm_err(got, want):
    """|kernel − plain| in units of the allowed difference (NORM_TOL)."""
    diff = (got.double() - want.double()).abs()
    scale = float(want.double().abs().max())
    if want.dtype == torch.bfloat16:
        return float((diff / (_bf16_ulp(want) + 1e-6 * scale)).max())
    return float(diff.max()) / (1e-5 * scale)


def flash_err(got, want):
    """|kernel − plain| in units of the allowed difference (FLASH_TOL);
    got and want [B, T, H, D]."""
    diff = (got.double() - want.double()).abs()
    row = want.double().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    if want.dtype == torch.bfloat16:
        return float((diff / (_bf16_ulp(want) + 2.0 ** -8 * row)).max())
    return float((diff / (1e-5 * row)).max())


def _bound(n_bytes, n_ops, ops_per_s):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _kernel_row(fwd, plain, lib, err_fn, tol, n_bytes, n_ops, ops_per_s,
                flush, **shape):
    """Holds fwd() against plain() (error, bit-identity of two runs) and
    times fwd, plain and the library call lib; raises past tol."""
    got, again, want = fwd(), fwd(), plain()
    err, identical = err_fn(got, want), torch.equal(got, again)
    if err > tol or not identical:
        raise RuntimeError(f"kernel at {shape}: error {err} (tol {tol}), "
                           f"bit-identical repeat {identical}")
    lib_out = lib()
    lib_diff = float((lib_out.float() - want.float()).abs().max())
    bound_ms, bound_by = _bound(n_bytes, n_ops, ops_per_s)
    return {**shape, "err": err, "tol": tol, "bit_identical": identical,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": time_ms(fwd, flush=flush),
            "plain_ms": time_ms(plain, flush=flush),
            "library_ms": time_ms(lib, flush=flush),
            "library_max_abs_diff": lib_diff, "bound_ms": bound_ms,
            "bound_by": bound_by}


# (N, D, dtype, layernorm launches per step on its main path); rmsnorm is
# on no model's path. The first row is the summary's basis (GPT-2).
NORM_SHAPES = (((12288, 768), torch.bfloat16, 49),               # GPT-2
               ((VIT_BATCH * 197, 768), torch.bfloat16, 49),     # ViT-B/16
               ((BERT_BATCH * 512, 768), torch.bfloat16, 49),    # BERT-base
               ((4 * 4096, 512), torch.bfloat16, 9),             # MoE model
               ((1000, 100), torch.bfloat16, 0),
               ((1000, 100), torch.float32, 0))
# (B, T, H, D, causal, dtype, launches per step on its main path)
FLASH_SHAPES = ((12, 1024, 12, 64, True, torch.bfloat16, 24),   # GPT-2
                (8, 512, 12, 64, False, torch.bfloat16, 24),    # BERT-base
                (4, 128, 12, 64, True, torch.bfloat16, 0),      # one block
                (2, 256, 12, 64, True, torch.float32, 0),       # float32
                (2, 128, 4, 16, True, torch.float32, 0))        # TINY's


def _norm_kernels(dev, flush):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import layernorm as ln

    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for kind in ("layernorm", "rmsnorm"):
        rows = []
        for (n, d), dtype, count in NORM_SHAPES:
            x = (torch.randn((n, d), generator=gen, device=dev) * 2
                 + 0.5).to(dtype)
            w = (torch.randn(d, generator=gen, device=dev) + 1).to(dtype)
            b = torch.randn(d, generator=gen, device=dev).to(dtype)
            elt = x.element_size()
            if kind == "layernorm":
                fns = (lambda: ln.layernorm_fwd(x, w, b),
                       lambda: ln.layernorm_plain(x, w, b),
                       lambda: F.layer_norm(x, (d,), w, b, 1e-5))
                n_bytes, n_ops = 2 * n * d * elt + 2 * d * elt, 8 * n * d
            else:
                count = 0
                fns = (lambda: ln.rmsnorm_fwd(x, w),
                       lambda: ln.rmsnorm_plain(x, w),
                       lambda: F.rms_norm(x, (d,), w, 1e-6))
                n_bytes, n_ops = 2 * n * d * elt + d * elt, 5 * n * d
            rows.append({"count": count, **_kernel_row(
                *fns, norm_err, NORM_TOL, n_bytes, n_ops, PEAK_F32_OPS_S,
                flush, N=n, D=d, dtype=str(dtype))})
            del x, w, b
        out[kind] = rows
    return out


def _flash_kernels(dev, flush):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as att

    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for b, t, h, d, causal, dtype, count in FLASH_SHAPES:
        # q, k, v as the model hands them over: views into one qkv
        qkv = torch.randn((b, t, 3 * h * d), generator=gen,
                          device=dev).to(dtype)
        q, k, v = (z.view(b, t, h, d) for z in qkv.split(h * d, dim=-1))
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        scale = d ** -0.5
        pairs = t * (t + 1) // 2 if causal else t * t
        rows.append({"count": count, **_kernel_row(
            lambda: att.flash_attention_fwd(q, k, v, causal, scale, 128,
                                            128),
            lambda: att.flash_attention_plain(q, k, v, causal, scale, 128,
                                              128),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal).transpose(1, 2),
            flash_err, FLASH_TOL, 4 * b * t * h * d * q.element_size(),
            4 * d * pairs * b * h,
            PEAK_BF16_OPS_S if dtype == torch.bfloat16 else PEAK_F32_OPS_S,
            flush, B=b, T=t, H=h, D=d, causal=causal, dtype=str(dtype))})
        del qkv, q, k, v, qt, kt, vt
    return rows


def _summary(rows, basis):
    """The summary fields of one kernel: max_abs_err over its shapes, and
    ms, plain_ms, bound_ms, library_ms on `basis` ("step": summed over the
    launches of one GPT-2 step; "launch": one launch at the first shape)."""
    main = rows[0]
    k = main["count"] if basis == "step" else 1
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "bound_by": main["bound_by"],
            **{key: main[key] * k for key in ("ms", "plain_ms", "bound_ms",
                                              "library_ms")}}


def phase_transformer_kernels(dev):
    flush = flush_buffer(dev)
    norms = _norm_kernels(dev, flush)
    flash = _flash_kernels(dev, flush)
    for kind, tol in (("layernorm", NORM_TOL), ("rmsnorm", NORM_TOL)):
        emit("kernels", kernel=kind, tol=tol, shapes=norms[kind])
    emit("kernels", kernel="flash_attn_fwd", tol=FLASH_TOL, shapes=flash)
    del flush
    torch.cuda.empty_cache()
    return {"layernorm": _summary(norms["layernorm"], "step"),
            "rmsnorm": _summary(norms["rmsnorm"], "launch"),
            "flash_attn_fwd": _summary(flash, "step")}


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _sums_error(got, x, dy, mean, inv):
    """max |kernel − plain| of both sums, over Σ|term| per channel; and
    the largest absolute difference."""
    from ray_tpu_torch.ops import batchnorm as bn

    want = bn.bn_bwd_sums_plain(x, dy, mean, inv)
    dyf = dy.float()
    scale = (dyf.abs().sum(0), (dyf * (x.float() - mean) * inv).abs().sum(0))
    norm = max(float(((g - w).abs() / s).max())
               for g, w, s in zip(got, want, scale))
    return norm, max(float((g - w).abs().max()) for g, w in zip(got, want))


def _one_step(dev, bn_mode, dtype, batch, layer_errs=None):
    """loss, running statistics and gradients of one ResNet-50 step. With
    layer_errs (a list), every bn_bwd_sums call of the backward is also
    held against the plain sums on the same inputs, errors appended."""
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.ops import batchnorm as bn

    model = resnet.ResNet(resnet.resnet50(bn_mode=bn_mode, dtype=dtype),
                          seed=0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((batch, HW, HW, 3), generator=gen, device=dev)
    labels = torch.randint(0, 1000, (batch,), generator=gen, device=dev)
    loss = resnet.loss_fn(model, x, labels)
    kernel = bn.bn_bwd_sums

    def checked(*args):
        got = kernel(*args)
        layer_errs.append(_sums_error(got, *args)[0])
        return got

    if layer_errs is not None:
        bn.bn_bwd_sums = checked  # BNTrain.backward looks it up per call
    try:
        loss.backward()
    finally:
        bn.bn_bwd_sums = kernel
    torch.cuda.synchronize()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    state = {n: b.clone() for n, b in model.named_buffers()}
    return loss.item(), state, grads


def phase_resnet50_step(dev):
    from ray_tpu_torch.ops import batchnorm as bn

    # float32 convolutions and matmuls in full float32, not TF32
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for key, batch in STEP_BATCH.items():
        dtype, tol = getattr(torch, key), STEP_TOL[key]
        before, layer_errs = bn.LAUNCHES, []
        lk, sk, gk = _one_step(dev, "kernel", dtype, batch, layer_errs)
        launches = bn.LAUNCHES - before
        lp, sp, gp = _one_step(dev, "plain", dtype, batch)
        errs = {
            "loss": abs(lk - lp) / abs(lp),
            "state": max(_rel_l2(sk[n], sp[n]) for n in sp),
            "grad": max(_rel_l2(gk[n], gp[n]) for n in gp),
            "grads_all": _rel_l2(torch.cat([g.flatten() for g in gk.values()]),
                                 torch.cat([g.flatten() for g in gp.values()])),
            "layer_sums": max(layer_errs)}
        worst = max(gp, key=lambda n: _rel_l2(gk[n], gp[n]))
        out[key] = {"batch": batch, "loss_kernel": lk, "loss_plain": lp,
                    "errors": errs, "tol": tol, "worst_grad": worst,
                    "kernel_launches": launches}
        if (launches != 53 or len(layer_errs) != 53
                or not all(errs[k] <= tol[k] for k in tol)):
            emit("resnet50_step", failed=key, **out)
            raise RuntimeError(f"resnet50_step {key}: {errs} vs {tol}, "
                               f"{launches} launches")
        del sk, gk, sp, gp
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    emit("resnet50_step", **out)


class _Repeat:
    """Synthetic loader: yields the same device-resident batch n times."""

    def __init__(self, batch, n):
        self.batch, self.n = batch, n

    def __iter__(self):
        for _ in range(self.n):
            yield self.batch


def _synthetic_batch(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn((BATCH, HW, HW, 3), generator=gen, device=dev,
                         dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    return images, labels


def _sgd(params):
    return torch.optim.SGD(params, lr=0.1, momentum=0.9)


def _operator_cls():
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.train import TrainingOperator

    class Op(TrainingOperator):
        def setup(self, config):
            # the worker's process picks its convolutions as the raw
            # loop's (a local import: cloudpickle cannot pickle the
            # cudnn module object a by-value class would reference)
            from torch.backends import cudnn

            cudnn.benchmark = True
            model = resnet.ResNet(resnet.resnet50(bn_mode="kernel"), seed=0)
            self.register(
                model=model, optimizer=_sgd,
                loss_fn=lambda m, b: resnet.loss_fn(m, b[0], b[1]),
                to_tree=resnet.params_to_jax,
                from_tree=resnet.load_jax_params)
            self.register_data(train_loader=_Repeat(
                _synthetic_batch(self.device), config["steps"] + WARMUP))

    return Op


def _raw_img_s(dev):
    """The same step without the framework: the overhead denominator."""
    from ray_tpu_torch.models import resnet

    model = resnet.ResNet(resnet.resnet50(bn_mode="kernel"), seed=0).to(dev)
    opt = _sgd(model.parameters())
    images, labels = _synthetic_batch(dev)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = resnet.loss_fn(model, images, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = torch.stack([step() for _ in range(STEPS)]).tolist()
    dt = time.perf_counter() - t0
    return BATCH * STEPS / dt, losses


# ---------------------------------------------------------------------------
# the main paths through the runtime: Trainer -> TrainWorker actor
# ---------------------------------------------------------------------------

# The object store of the runtime: the GPT-2 state_dict that comes back
# after each train() (124.4M parameters and AdamW's two moments, f32:
# 1.5 GB) and the DP trainer's weights (0.5 GB in each worker's
# arguments, held while the worker lives: 2 GB for four ranks) must fit
# at once, with room to spare (8 GiB ran out at four ranks).
STORE_BYTES = 16 << 30
# the runtime phase's payload: 256 MB of bf16
RUNTIME_NUMEL = 128 << 20


class _Probe:
    """A num_gpus=1 actor of the runtime phase."""

    def whoami(self):
        import os

        import torch

        x = torch.ones(1, device="cuda")  # this process's own context
        return {"pid": os.getpid(),
                "cuda_visible_devices": os.environ["CUDA_VISIBLE_DEVICES"],
                "device_count": torch.cuda.device_count(),
                "name": torch.cuda.get_device_name(),
                "context": bool(torch.cuda.is_initialized()
                                and x.is_cuda)}

    def round_trip(self, t):
        """The tensor to the card, summed there, and back."""
        import torch

        on_card = t.to("cuda")
        total = on_card.float().sum().item()
        torch.cuda.synchronize()
        return on_card, total


def phase_runtime(dev, smi):
    """ray_tpu_torch.init() on the card: the GPU count, a num_gpus=1
    actor in a process of its own, and a 256 MB bf16 tensor from the
    driver to it through put, summed on its card, and back."""
    import shutil

    import ray_tpu_torch
    from ray_tpu_torch._private import global_state

    t0 = time.perf_counter()
    info = ray_tpu_torch.init(object_store_memory=STORE_BYTES)
    init_s = time.perf_counter() - t0
    smi_gpus = len(subprocess.run(
        ["nvidia-smi", "-L"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines())
    resources = ray_tpu_torch.cluster_resources()
    probe = ray_tpu_torch.remote(num_gpus=1)(_Probe).remote()
    t0 = time.perf_counter()
    who = ray_tpu_torch.get(probe.whoami.remote(), timeout=300)
    actor_start_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(RUNTIME_NUMEL, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    want_sum = x.float().sum().item()
    torch.cuda.synchronize()
    # two rounds: the first writes store pages never touched before, the
    # second reuses the arena the first freed
    put_ms, actor_ms, get_ms, bit_equal, sums = [], [], [], True, []
    for _ in range(2):
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(x)
        put_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        back_ref = probe.round_trip.remote(ref)
        ready, _ = ray_tpu_torch.wait([back_ref], timeout=300)
        actor_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        back, got_sum = ray_tpu_torch.get(back_ref)
        get_ms.append((time.perf_counter() - t0) * 1e3)
        bit_equal = bool(bit_equal and ready and back.dtype == x.dtype
                         and back.shape == x.shape
                         and torch.equal(back.view(torch.int16),
                                         x.cpu().view(torch.int16)))
        sums.append(got_sum)
        del ref, back_ref, back
    ray_tpu_torch.kill(probe)
    store = global_state.get_core_worker().store
    shm = shutil.disk_usage("/dev/shm") if os.path.isdir("/dev/shm") else None
    df = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                        text=True, timeout=60).stdout.strip()
    fields = {
        "nvidia_smi": smi, "init_s": init_s, "session": info["session_dir"],
        "cluster_gpus": resources.get("GPU", 0), "nvidia_smi_gpus": smi_gpus,
        "driver_pid": os.getpid(), "actor": who,
        "actor_start_s": actor_start_s, "bytes": x.numel() * x.element_size(),
        "put_ms": put_ms, "actor_round_trip_ms": actor_ms, "get_ms": get_ms,
        "bit_equal": bit_equal, "sum_driver": want_sum, "sum_actor": sums,
        "store_root": store.root,
        "store": store.stats() if hasattr(store, "stats") else "files",
        "dev_shm_free": shm.free if shm else None, "df_dev_shm": df}
    emit("runtime", **fields)
    ok = (resources.get("GPU", 0) == smi_gpus and who["pid"] != os.getpid()
          and who["device_count"] == 1 and who["context"]
          and who["cuda_visible_devices"] != ""
          and who["name"] == torch.cuda.get_device_name(0)
          and bit_equal and sums == [want_sum] * 2)
    if not ok:
        raise RuntimeError(f"runtime: {fields}")


def zero_counts():
    """Sets every kernel's launch counter of this process to 0 (the
    driver's, or, run through TrainWorker.run, the worker's)."""
    import importlib

    from ray_tpu_torch.train.trainer import KERNEL_COUNTERS

    for module, attr in KERNEL_COUNTERS.values():
        setattr(importlib.import_module(module), attr, 0)


def local_counts():
    """This process's kernel launch counters, by name."""
    import importlib

    from ray_tpu_torch.train.trainer import KERNEL_COUNTERS

    return {name: getattr(importlib.import_module(module), attr)
            for name, (module, attr) in KERNEL_COUNTERS.items()}


def _worker_reset(ops):
    """Run in the worker before a measured epoch: its work done, its
    peak memory and its kernel counters from 0."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()


def _worker_peak(ops):
    return torch.cuda.max_memory_allocated()


def measured_train(trainer, steps, **kw):
    """One train() of the main path with every count set to 0 just
    before: every rank's counters (read back through read_counter from
    the rank's own worker; summed, and by rank), the driver's (which must
    stay 0: no rank runs here), the ranks' peak memory; and the driver's
    wall time of the call, which holds the actor boundary and the
    state_dict that comes back after the epoch."""
    import ray_tpu_torch
    from ray_tpu_torch.train.trainer import KERNEL_COUNTERS

    workers = trainer.workers
    ray_tpu_torch.get([w.run.remote(_worker_reset) for w in workers])
    zero_counts()
    t0 = time.perf_counter()
    result = trainer.train(num_steps=steps, **kw)
    wall = time.perf_counter() - t0
    by_rank = [dict(zip(KERNEL_COUNTERS, ray_tpu_torch.get(
        [w.read_counter.remote(n) for n in KERNEL_COUNTERS])))
        for w in workers]
    counts = {n: sum(c[n] for c in by_rank) for n in KERNEL_COUNTERS}
    driver = local_counts()
    if any(driver.values()):
        raise RuntimeError(f"the driver launched kernels of the main path: "
                           f"{driver}")
    peak = max(ray_tpu_torch.get([w.run.remote(_worker_peak)
                                  for w in workers]))
    return result, counts, {"driver_wall_s_per_train": wall,
                            "driver_counts": driver,
                            "rank_counts": by_rank,
                            "max_memory_allocated": peak}


# phase train's img/s and its raw loop's, printed beside train_ingest's
TRAIN_FIELDS = {}


def phase_train(dev):
    import ray_tpu_torch
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.train import Trainer

    torch.backends.cudnn.benchmark = True
    trainer = Trainer(_operator_cls(), num_workers=1,
                      config={"steps": STEPS},
                      resources_per_worker={"GPU": 1})
    n_bn = ray_tpu_torch.get(trainer.workers[0].run.remote(
        lambda ops: resnet.num_bn_layers(ops[0].model)))
    t0 = time.perf_counter()
    trainer.train(num_steps=WARMUP)
    warm_wall = time.perf_counter() - t0
    result, counts, meta = measured_train(trainer, STEPS)
    trainer.shutdown()
    del trainer
    torch.cuda.empty_cache()
    raw_img_s, raw_losses = _raw_img_s(dev)
    img_s = result["samples_per_s"]
    launches = int(counts["bn_bwd_sums"])
    fields = {"img_s": img_s, "raw_img_s": raw_img_s,
              "framework_fraction": img_s / raw_img_s, "batch": BATCH,
              "steps": STEPS, "last_train_loss": result["last_train_loss"],
              "train_loss": result["train_loss"],
              "raw_last_loss": raw_losses[-1], "bn_layers": n_bn,
              "bn_bwd_sums_launches": launches,
              "dy_relayouts_per_step": counts["bn_dy_relayouts"] / STEPS,
              "worker_s_per_epoch": BATCH * STEPS / img_s,
              "driver_wall_s_per_warmup_train": warm_wall, **meta}
    emit("train", **fields)
    finite = all(math.isfinite(v) for v in (result["train_loss"],
                                            result["last_train_loss"]))
    if launches != n_bn * STEPS or n_bn != 53 or not finite:
        raise RuntimeError(f"train: {launches} launches for {STEPS} steps "
                           f"of {n_bn} batchnorm layers, loss finite "
                           f"{finite}")
    TRAIN_FIELDS.update(img_s=img_s, raw_img_s=raw_img_s)
    return launches


def gpt2_config(dtype=torch.bfloat16, ops_mode="kernel"):
    from ray_tpu_torch.models import transformer

    return dataclasses.replace(transformer.GPT2_SMALL, dtype=dtype,
                               ops_mode=ops_mode)


def gpt2_launches_per_step(cfg):
    """(layernorm, flash) launches of one training step: two layernorms a
    block and the final one, one attention a block, and the block's
    forward again in the backward under remat."""
    again = cfg.n_layers if cfg.remat else 0
    return 2 * (cfg.n_layers + again) + 1, cfg.n_layers + again


def _gpt_tokens(dev, batch, cfg, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq),
                         generator=gen, device=dev)


def _gpt_one_step(dev, cfg, tokens, layer_errs=None):
    """loss and gradients of one GPT-2 step. With layer_errs (a dict of
    lists), the model runs an Ops that holds every layernorm and flash
    kernel call against its plain version on the same inputs, errors
    appended in units of its tolerance."""
    from ray_tpu_torch.models import transformer

    if layer_errs is not None:
        cfg = dataclasses.replace(cfg, ops_mode=_checked_ops(layer_errs))
    model = transformer.GPT(cfg, seed=0).to(dev)
    loss = transformer.loss_fn(model, tokens)
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    return loss.item(), grads


def phase_gpt2_step(dev):
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for key, batch in GPT_STEP_BATCH.items():
        dtype, tol = getattr(torch, key), GPT_STEP_TOL[key]
        cfg = gpt2_config(dtype, "kernel")
        tokens = _gpt_tokens(dev, batch, cfg, seed=1)
        layer_errs = {"layernorm": [], "flash_attn_fwd": []}
        zero_counts()
        lk, gk = _gpt_one_step(dev, cfg, tokens, layer_errs)
        launches = {k: v for k, v in local_counts().items()
                    if k in ("layernorm", "flash_attn_fwd",
                             "flash_dense_routes")}
        lp, gp = _gpt_one_step(dev, gpt2_config(dtype, "plain"), tokens)
        errs = {
            "loss": abs(lk - lp) / abs(lp),
            "grad": max(_rel_l2(gk[n], gp[n]) for n in gp),
            "grads_all": _rel_l2(torch.cat([g.flatten() for g in gk.values()]),
                                 torch.cat([g.flatten() for g in gp.values()])),
            "layers": max(max(v) for v in layer_errs.values())}
        worst = max(gp, key=lambda n: _rel_l2(gk[n], gp[n]))
        n_ln, n_flash = gpt2_launches_per_step(cfg)
        out[key] = {"batch": batch, "seq": cfg.max_seq, "loss_kernel": lk,
                    "loss_plain": lp, "errors": errs, "tol": tol,
                    "worst_grad": worst, "launches": launches,
                    "layer_err_max": {k: max(v)
                                      for k, v in layer_errs.items()}}
        ok = (launches["layernorm"] == n_ln
              and launches["flash_attn_fwd"] == n_flash
              and launches["flash_dense_routes"] == 0
              and all(errs[k] <= tol[k] for k in tol))
        if not ok:
            emit("gpt2_step", failed=key, **out)
            raise RuntimeError(f"gpt2_step {key}: {errs} vs {tol}, "
                               f"launches {launches}, want {n_ln} "
                               f"layernorm and {n_flash} flash")
        del gk, gp, tokens
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    emit("gpt2_step", **out)


def _adamw(params):
    return torch.optim.AdamW(params, lr=6e-4, betas=(0.9, 0.95),
                             weight_decay=0.1)


def gpt2_operator_cls():
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.train import TrainingOperator

    class Op(TrainingOperator):
        def setup(self, config):
            from torch.backends import cudnn

            cudnn.benchmark = True
            cfg = gpt2_config()
            self.register(
                model=transformer.GPT(cfg, seed=0), optimizer=_adamw,
                loss_fn=transformer.loss_fn,
                to_tree=lambda m: (transformer.params_to_jax(m), None),
                from_tree=lambda m, params, _: transformer.load_jax_params(
                    m, params))
            self.register_data(train_loader=_Repeat(
                _gpt_tokens(self.device, GPT_BATCH, cfg, seed=0),
                config["steps"] + WARMUP))

    return Op


def _raw_tokens_s(dev):
    """The same GPT-2 step without the framework."""
    from ray_tpu_torch.models import transformer

    cfg = gpt2_config()
    model = transformer.GPT(cfg, seed=0).to(dev)
    opt = _adamw(model.parameters())
    tokens = _gpt_tokens(dev, GPT_BATCH, cfg, seed=0)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = transformer.loss_fn(model, tokens)
        loss.backward()
        opt.step()
        return loss.detach()

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = torch.stack([step() for _ in range(STEPS)]).tolist()
    dt = time.perf_counter() - t0
    return GPT_BATCH * cfg.max_seq * STEPS / dt, losses


def phase_train_gpt2(dev):
    import ray_tpu_torch
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.train import Trainer

    cfg = gpt2_config()
    trainer = Trainer(gpt2_operator_cls(), num_workers=1,
                      config={"steps": STEPS},
                      resources_per_worker={"GPU": 1})
    n_params = ray_tpu_torch.get(trainer.workers[0].run.remote(
        lambda ops: transformer.num_params(ops[0].model)))
    t0 = time.perf_counter()
    trainer.train(num_steps=WARMUP)
    warm_wall = time.perf_counter() - t0
    result, counts, meta = measured_train(trainer, STEPS)
    trainer.shutdown()
    del trainer
    torch.cuda.empty_cache()
    raw_tokens_s, raw_losses = _raw_tokens_s(dev)
    tokens_s = result["samples_per_s"] * cfg.max_seq
    n_ln, n_flash = gpt2_launches_per_step(cfg)
    launches = {k: int(counts[k]) for k in ("layernorm", "rmsnorm",
                                            "flash_attn_fwd",
                                            "flash_dense_routes")}
    emit("train_gpt2", tokens_s=tokens_s, raw_tokens_s=raw_tokens_s,
         framework_fraction=tokens_s / raw_tokens_s, batch=GPT_BATCH,
         seq=cfg.max_seq, steps=STEPS, params=n_params,
         last_train_loss=result["last_train_loss"],
         train_loss=result["train_loss"], raw_last_loss=raw_losses[-1],
         launches_per_step={k: v / STEPS for k, v in launches.items()},
         worker_s_per_epoch=GPT_BATCH * cfg.max_seq * STEPS / tokens_s,
         driver_wall_s_per_warmup_train=warm_wall, **meta)
    finite = all(math.isfinite(v) for v in (result["train_loss"],
                                            result["last_train_loss"]))
    if (launches["layernorm"] != n_ln * STEPS
            or launches["flash_attn_fwd"] != n_flash * STEPS
            or launches["flash_dense_routes"] != 0 or not finite):
        raise RuntimeError(f"train_gpt2: launches {launches} in {STEPS} "
                           f"steps, want {n_ln} layernorm and {n_flash} "
                           f"flash a step and no dense route; loss finite "
                           f"{finite}")
    return launches


# ---------------------------------------------------------------------------
# the fused ring collectives (B5-B8)
# ---------------------------------------------------------------------------

# GPT-2 124M's gradient bucket: the port's GPT(GPT2_SMALL) parameter count
GPT2_NUMEL = 124402944
# payloads in elements: the 16 KB latency class (ray_tpu/microbenchmark.py
# :578-582), 16 MB (microbenchmark.py:502), a ragged size
RING_SIZES = (4096, 4 << 20, 10007)
RING_WORLDS = (2, 3, 4)
STRESS_CALLS = 200
RING_TIMEOUT_S = 2.0


def _ring_cases(w):
    """(kernel, combine, dtype, padded payload per rank, n) of one world
    size: each payload padded as the collective layer pads it on the main
    path (allreduce and allgather to _bucket(n); the reduce-scatter to the
    sharded layout, padded_numel; the quantized allreduce to _qring_pad).
    GPT-2's bucket: every kernel at w = 2; the f32 allreduce add, the
    reduce-scatter, the allgather and the quantized add at every w."""
    from ray_tpu_torch.collective.backends import device_backend as db
    from ray_tpu_torch.train import sharding

    cases = []
    if w != 2:
        cases += [("allreduce", "add", torch.float32,
                   w * -(-db._bucket(GPT2_NUMEL) // w), GPT2_NUMEL),
                  ("reducescatter", "add", torch.float32,
                   sharding.padded_numel(GPT2_NUMEL, w), GPT2_NUMEL),
                  ("allgather", "add", torch.float32, db._bucket(
                      sharding.padded_numel(GPT2_NUMEL, w) // w),
                   GPT2_NUMEL),
                  ("quantized", "add", torch.float32,
                   db._qring_pad(GPT2_NUMEL, w), GPT2_NUMEL)]
    for n in RING_SIZES + ((GPT2_NUMEL,) if w == 2 else ()):
        # the allreduce wrapper pads _bucket(n) to w chunks; so does this,
        # for the plain version
        b = w * -(-db._bucket(n) // w)
        cases += [("allreduce", c, torch.float32, b, n)
                  for c in ("add", "max", "min", "mul")]
        if n != GPT2_NUMEL:
            cases += [("allreduce", "add", torch.bfloat16, b, n),
                      ("allreduce", "add", torch.int32, b, n)]
        cases += [("reducescatter", "add", torch.float32,
                   sharding.padded_numel(n, w), n),
                  ("allgather", "add", torch.float32,
                   db._bucket(sharding.padded_numel(n, w) // w), n)]
        cases += [("quantized", c, torch.float32, db._qring_pad(n, w), n)
                  for c in ("add", "max", "min")]
    return cases


def _ring_inputs(combine, dtype, length, w, dev, gen):
    if dtype == torch.int32:
        return [torch.randint(-1000, 1000, (length,), generator=gen,
                              device=dev, dtype=dtype) for _ in range(w)]
    xs = [torch.randn(length, generator=gen, device=dev) for _ in range(w)]
    if combine == "mul":
        xs = [1 + 0.01 * x for x in xs]
    return [x.to(dtype) for x in xs]


_RING_OPS = {"add": "sum", "max": "max", "min": "min", "mul": "product"}


def _ring_fns(ops, kind, combine):
    """(kernel call of rank r, plain version over all ranks, one PyTorch
    call that computes the same function: the yardstick, or None)."""
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    op = _RING_OPS[combine]
    if kind == "allreduce":
        lib = {"add": lambda s: s.sum(0), "max": lambda s: s.amax(0),
               "min": lambda s: s.amin(0), "mul": lambda s: s.prod(0)}[combine]
        return (lambda r, x: ops.allreduce(r, x, op),
                lambda xs: pb.allreduce_plain(xs, op),
                lambda xs: lib(torch.stack(xs)))
    if kind == "reducescatter":
        return (ops.reducescatter_even, pb.reducescatter_plain,
                lambda xs: torch.stack(xs).sum(0).chunk(len(xs))[0])
    if kind == "allgather":
        return ops.allgather, pb.allgather_plain, lambda xs: torch.cat(xs)
    return (lambda r, x: ops.allreduce_quantized(r, x, op),
            lambda xs: pb.allreduce_quantized_plain(xs, op), None)


def _on_ranks(ops, xs):
    """Rank r's copy of xs[r] on its card (the same tensor on one card)."""
    return [x.to(d) for x, d in zip(xs, ops.devices)]


def _on_dev(ts, dev):
    return [t.to(dev) for t in ts]


def _sync_all():
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def _ring_call(ops, fn, xs, skews=None):
    """One collective: rank r's kernel on rank r's stream, each stream
    after the current one (where xs were made); the current stream then
    waits for every rank. skews: cycles each rank's stream sleeps before
    its launch."""
    cur = torch.cuda.current_stream()
    outs = []
    for r, x in enumerate(xs):
        s = ops.streams[r]
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            if skews is not None and skews[r]:
                torch.cuda._sleep(skews[r])
            outs.append(fn(r, x))
    for s in ops.streams:
        cur.wait_stream(s)
    return outs


def _ring_bytes(kind, length, w, elt):
    """Bytes the call must move through device memory: each rank's input
    read once and its output written once (the allgather's w chunks of an
    output land there from w ranks, the same bytes)."""
    out = {"allreduce": length, "quantized": length,
           "reducescatter": length // w, "allgather": w * length}[kind]
    return w * (length + out) * elt


def _ring_bound(cards, kind, length, w, elt):
    """(bound ms, "bytes", basis) of one call. All ranks on one card: every
    rank's bytes through its one memory at PEAK_BYTES_S. Ranks on c cards:
    the larger of a card's share of those bytes at PEAK_BYTES_S and the
    bytes that must leave a rank's card at NVLINK_BYTES_S (the allgather
    its chunk to w - 1 peers; the allreduce 2(w - 1)/w of its payload:
    its reduced chunk to w - 1 peers and the w - 1 chunks of its input
    that they read; the reduce-scatter half that; the int8 ring a quarter
    of those bytes and its scales)."""
    t_mem = _ring_bytes(kind, length, w, elt) / cards / PEAK_BYTES_S
    if cards == 1:
        return (t_mem * 1e3, "bytes",
                "one card: every rank's input and output through its memory")
    sent = {"allgather": (w - 1) * length * elt,
            "allreduce": 2 * (w - 1) * length // w * elt,
            "reducescatter": (w - 1) * length // w * elt,
            "quantized": 2 * (w - 1) * length // w
            * (1 + 4 / 256)}[kind]
    t_link = sent / NVLINK_BYTES_S
    return (max(t_mem, t_link) * 1e3, "bytes",
            f"{cards} cards: " + ("each card's memory" if t_mem >= t_link
                                  else "each rank's NVLink sends"))


def _qwire_bytes(length, w):
    """Bytes B8's int8 wire moves in one call, over all ranks: each rank's
    w - 1 hop partials written into its right neighbour's slot and read
    there, and its reduced chunk written once into its staging buffer and
    read by the w - 1 peers; a chunk of C values is C int8 and C / 256
    f32 scales."""
    c = length // w
    return w * (3 * w - 2) * (c + 4 * (c // 256))


def _qbound_wire_ms(length, w):
    """B8's bound with its int8 wire, on one card: every rank's f32 input
    and output and the wire's bytes through its memory."""
    return ((_ring_bytes("quantized", length, w, 4) + _qwire_bytes(length, w))
            / PEAK_BYTES_S * 1e3)


def _ring_blocks(ops, kind, dtype, length, w):
    """CUDA blocks a rank's kernel ran with (the group's buffers of the
    class hold the count)."""
    chunk = {"allreduce": length // w, "reducescatter": length // w,
             "allgather": length, "quantized": length // w}[kind]
    return ops._bufs[(kind, dtype, chunk)][0]["nblocks"]


def _check_ring_case(ops, kind, combine, dtype, length, w, dev, gen, flush,
                     timed):
    fn, plain, lib = _ring_fns(ops, kind, combine)
    xs = _ring_inputs(combine, dtype, length, w, dev, gen)
    ranked = _on_ranks(ops, xs)
    got = _on_dev(_ring_call(ops, fn, ranked), dev)
    again = _on_dev(_ring_call(ops, fn, ranked), dev)
    want = plain(xs)
    _sync_all()
    for r in range(w):
        ops.check(r)
    same = all(torch.equal(g, p) for g, p in zip(got, want))
    repeat = all(torch.equal(g, a) for g, a in zip(got, again))
    agree = kind == "reducescatter" or all(torch.equal(got[0], g)
                                           for g in got)
    err = max(float((g.double() - p.double()).abs().max())
              for g, p in zip(got, want))
    row = {"kind": kind, "combine": combine, "dtype": str(dtype),
           "w": w, "length": length, "bit_identical": same,
           "repeat_identical": repeat, "ranks_agree": agree,
           "max_abs_err": err, "blocks_per_rank": _ring_blocks(
               ops, kind, dtype, length, w)}
    if not (same and repeat and agree):
        emit("collectives", failed=row)
        raise RuntimeError(f"ring {kind} {combine} {dtype} w={w} "
                           f"[{length}]: {row}")
    if timed:
        bound_ms, bound_by, basis = _ring_bound(
            len({d.index for d in ops.devices}), kind, length, w,
            xs[0].element_size())
        row.update(
            ms=time_ms(lambda: _ring_call(ops, fn, ranked), flush=flush),
            plain_ms=time_ms(lambda: plain(xs), flush=flush),
            library_ms=(time_ms(lambda: lib(xs), flush=flush)
                        if lib is not None else None),
            bound_ms=bound_ms, bound_by=bound_by, bound_basis=basis)
        if kind == "quantized":
            row.update(
                wire_bytes=_qwire_bytes(length, w),
                bound_wire_ms=_qbound_wire_ms(length, w),
                bound_wire_basis="one card: every rank's input and output "
                "and the int8 wire (hop slots written and read, each "
                "reduced chunk staged once and read by w - 1 peers) "
                "through its memory")
    del xs, ranked, got, again, want
    return row


def _stress(ops, w, dev, gen):
    """STRESS_CALLS back-to-back calls of each kernel at 64K elements, each
    rank's stream sleeping a random number of cycles before its launch,
    inputs cycling over four sets; every output against the plain
    version's for its inputs."""
    from ray_tpu_torch.collective.backends import device_backend as db
    from ray_tpu_torch.train import sharding

    n = 1 << 16
    rng = torch.Generator().manual_seed(w)
    out = {}
    for kind, combine, length in (
            ("allreduce", "add", w * -(-db._bucket(n) // w)),
            ("reducescatter", "add", sharding.padded_numel(n, w)),
            ("allgather", "add", db._bucket(n)),
            ("quantized", "add", db._qring_pad(n, w))):
        fn, plain, _ = _ring_fns(ops, kind, combine)
        inputs = [_ring_inputs(combine, torch.float32, length, w, dev, gen)
                  for _ in range(4)]
        wants = [plain(xs) for xs in inputs]
        ranked = [_on_ranks(ops, xs) for xs in inputs]
        results = []
        for i in range(STRESS_CALLS):
            skews = torch.randint(0, 50000, (w,), generator=rng).tolist()
            results.append(_ring_call(ops, fn, ranked[i % 4], skews))
        _sync_all()
        for r in range(w):
            ops.check(r)
        bad = [i for i, got in enumerate(results)
               if not all(torch.equal(g, p) for g, p in
                          zip(_on_dev(got, dev), wants[i % 4]))]
        out[kind] = {"calls": STRESS_CALLS, "mismatched": len(bad)}
        if bad:
            emit("collectives", failed="stress", kind=kind, w=w,
                 mismatched_calls=bad[:20])
            raise RuntimeError(f"ring {kind} at w={w}: {len(bad)} of "
                               f"{STRESS_CALLS} skewed calls differ")
    return out


def _withhold(dev, kind, w, quantize=None):
    """One call that the last of w ranks withholds: every other rank's
    kernel gives up after the group's timeout, and the group raises a
    TimeoutError at each of them that names the withheld rank (a group
    with quantize="int8" sends the allreduce to B8)."""
    import re

    from ray_tpu_torch import collective as col

    name = f"withheld_{kind}_{w}_{quantize}"
    handles = [col.init_collective_group(w, r, backend="xla",
                                         group_name=name,
                                         timeout=RING_TIMEOUT_S,
                                         quantize=quantize)
               for r in range(w)]
    x = torch.ones(12288, device=dev)  # splits evenly over 2, 3, 4 ranks
    cur = torch.cuda.current_stream()
    t0 = time.perf_counter()
    for h in handles[:-1]:
        h.stream.wait_stream(cur)
        with torch.cuda.stream(h.stream):
            getattr(h, kind)(x)
    messages = []
    for h in handles[:-1]:
        try:
            h.check()
        except TimeoutError as e:
            messages.append(str(e))
        else:
            raise RuntimeError(f"a withheld rank did not time out ({kind}, "
                               f"w={w})")
    waited = time.perf_counter() - t0
    col.destroy_collective_group(name)
    named = [int(m.group(1)) for m in
             (re.search(r"(?:of|from) rank (\d+)", e) for e in messages)
             if m]
    if waited > RING_TIMEOUT_S + 10 or named != [w - 1] * (w - 1):
        raise RuntimeError(f"{kind} w={w}: raised after {waited} s (timeout "
                           f"{RING_TIMEOUT_S}), naming {named}: {messages}")
    return {"raised_after_s": waited, "errors": messages}


def _timeout_check(dev):
    """The withheld rank, for the allreduce, the reduce-scatter, the
    allgather and the quantized allreduce at w = 2, 3, 4; then a new group
    works."""
    from ray_tpu_torch import collective as col

    cases = {f"{kind} w={w}": _withhold(dev, kind, w)
             for kind in ("allreduce", "reducescatter", "allgather")
             for w in RING_WORLDS}
    cases.update({f"quantized w={w}": _withhold(dev, "allreduce", w,
                                                quantize="int8")
                  for w in RING_WORLDS})
    x = torch.ones(4096, device=dev)
    handles = [col.init_collective_group(2, r, backend="xla",
                                         group_name="after",
                                         timeout=RING_TIMEOUT_S)
               for r in range(2)]
    ops = handles[0].group.transport._ops
    outs = _ring_call(ops, lambda r, t: handles[r].allreduce(t),
                      _on_ranks(ops, [x, 2 * x]))
    _sync_all()
    for h in handles:
        h.check()
    col.destroy_collective_group("after")
    if not all(torch.equal(o, 3 * x) for o in _on_dev(outs, dev)):
        raise RuntimeError("the group after a timeout computed wrong sums")
    return {"timeout_s": RING_TIMEOUT_S, "cases": cases,
            "next_group_ok": True}


def phase_collectives(dev):
    """B5-B8 against their plain versions, bit for bit, at w = 2, 3, 4
    ranks, one stream each, rank r on cuda:(r % device_count) (all on
    the one card as the script runs by default); stress; timeout; times
    (one call: every rank's kernel) beside the bound and the yardstick."""
    from ray_tpu_torch import collective as col

    flush = flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    rows, stress = [], {}
    for w in RING_WORLDS:
        name = f"ring{w}"
        handles = [col.init_collective_group(w, r, backend="xla",
                                             group_name=name,
                                             timeout=RING_TIMEOUT_S * 5)
                   for r in range(w)]
        ops = handles[0].group.transport._ops
        for kind, combine, dtype, length, n in _ring_cases(w):
            timed = dtype == torch.float32 and combine == "add" and (
                n != 10007)
            rows.append({"n": n, **_check_ring_case(
                ops, kind, combine, dtype, length, w, dev, gen, flush,
                timed)})
        stress[w] = _stress(ops, w, dev, gen)
        col.destroy_collective_group(name)
        torch.cuda.empty_cache()
    timeout = _timeout_check(dev)
    del flush
    torch.cuda.empty_cache()
    emit("collectives", cards=torch.cuda.device_count(), cases=len(rows),
         all_bit_identical=True,
         stress=stress, timeout=timeout,
         timed=[r for r in rows if "ms" in r],
         blocks_per_rank={f"{r['kind']} w={r['w']} n={r['n']}":
                          r["blocks_per_rank"] for r in rows
                          if r["combine"] == "add"
                          and r["dtype"] == "torch.float32"})
    summary = {}
    for name, kind in (("ring_allreduce", "allreduce"),
                       ("ring_reducescatter", "reducescatter"),
                       ("ring_allgather", "allgather"),
                       ("quantized_allreduce", "quantized")):
        main = next(r for r in rows if r["kind"] == kind and "ms" in r
                    and r["n"] == GPT2_NUMEL)
        summary[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kind"] == kind),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}}
    return summary


# ---------------------------------------------------------------------------
# collectives_procs: B5-B8 launched by ranks in processes of their own
# ---------------------------------------------------------------------------

PROC_ITERS = 10  # back-to-back calls a timed case, every rank at once
# what the numbers of B5-B8's rows in the kernels line measure
PROCS_BASIS = {"ms": "one call through the per-process group, a rank a "
               "process, hub vote included, where the group routes it to "
               "the kernel (ranks sharing a card); else one call of the "
               "kernels' transport alone (collectives_procs, first run)",
               "bound_ms": "the same call's bytes or operations",
               "plain_ms": "the plain version over every rank's tensor in "
               "one process (collectives)",
               "library_ms": "one PyTorch call over every rank's tensor in "
               "one process (collectives)"}
NCCL_TOL = 1e-6  # NCCL's sum against the plain ring's, relative L2
# the size gate (HostGroup.PALLAS_MAX_BYTES, the reference's 64 KB) and
# the crossover's f32 sizes: 16 KB, 64 KB, 256 KB, 1 MB, GPT-2's bucket
GATE_BYTES = 64 << 10
CROSSOVER_FLOATS = (4096, 16384, 65536, 262144, 124402944)


def _proc_cases(w):
    """(kind, combine, dtype, padded payload per rank, n) of the
    cross-process phase: every built op and dtype at the ragged 10,007,
    padded as the collective layer pads it; the four kernels at GPT-2's
    bucket (f32, add), timed."""
    return [c for c in _ring_cases(w)
            if c[4] == 10007 or (c[4] == GPT2_NUMEL and c[1] == "add"
                                 and c[2] == torch.float32)]


def _elt(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _digest(t):
    """sha256 of a tensor's bytes: outputs are held bit for bit."""
    import hashlib

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def _rank_actor_cls():
    from ray_tpu_torch.collective import CollectiveActorMixin

    class CollectiveRank(CollectiveActorMixin):
        """One rank of the cross-process phase, in a process of its own
        on its leased card (cuda:0 of its view)."""

        def info(self):
            props = torch.cuda.get_device_properties(0)
            return {"pid": os.getpid(), "uuid": str(props.uuid),
                    "cuda_visible_devices":
                        os.environ.get("CUDA_VISIBLE_DEVICES")}

        def case(self, group, kind, combine, dtype, length, w, seed):
            """The rank's input of the case (rank r's of the w made from
            the seed, as the driver makes them), through the kernels twice:
            through the group where it routes to them, else (a payload
            over the size gate where every rank holds a card of its own,
            which the group sends to NCCL) through the transport alone;
            the output's digest; the group's route (`routed`: the tier that
            carried one call through it); the ms of one call through the
            group as the main path makes it (`ms`: the hub vote, then the
            phases and the copies into and out of the mapped buffers, or
            NCCL) and of one call of the kernels' transport alone
            (`transport_ms`: no vote), PROC_ITERS calls back to back after
            a barrier each."""
            from ray_tpu_torch import collective as col
            from ray_tpu_torch.collective import metrics

            dev = torch.device("cuda", 0)
            g = col.get_group(group)
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = _ring_inputs(combine, dtype, length, w, dev, gen)[g.rank]
            op = _RING_OPS[combine]
            gated = (g._device_shaped and kind != "quantized"
                     and x.numel() * x.element_size() > g.PALLAS_MAX_BYTES)

            def call(t):
                if kind == "allreduce":
                    return t.allreduce(x, op)
                if kind == "quantized":
                    return t.allreduce(x, op, quantize="int8")
                if kind == "reducescatter":
                    return t.reducescatter(x)
                return torch.stack(t.allgather(x))

            before = metrics.tier_counts()
            routed = call(g)
            g.check()
            after = metrics.tier_counts()
            del routed
            kernels = g._ensure_pallas() if gated else g
            out = call(kernels)
            again = call(kernels)
            g.check()
            row = {"digest": _digest(out), "gated": gated,
                   "routed": [t for t in after if after[t] > before[t]],
                   "repeat_identical": bool(torch.equal(out, again))}
            del out, again
            for key, t in (("ms", g), ("transport_ms", g._pallas)):
                col.barrier(group)
                torch.cuda.synchronize()
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                for _ in range(PROC_ITERS):
                    call(t)
                t1.record()
                g.check()
                row[key] = t0.elapsed_time(t1) / PROC_ITERS
            col.barrier(group)
            row["copy_ms"] = time_ms(lambda: x.clone(), iters=10)
            return row

        def nccl(self, group, length, w, seed, rs_length, ag_length):
            """The DEVICE tier's f32 sum at `length` (NCCL: a card a
            rank), its result and its ms; then NCCL's own
            reduce_scatter_tensor at `rs_length` and
            all_gather_into_tensor at `ag_length` (the process group's
            _reduce_scatter_base and _allgather_base, which those calls
            run), B6's and B7's yardsticks, each input made from
            seed + 1 and seed + 2 as the driver makes it: the
            reduce-scatter's result, the allgather's digest, the ms of
            each."""
            from ray_tpu_torch import collective as col

            dev = torch.device("cuda", 0)
            g = col.get_group(group)
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = _ring_inputs("add", torch.float32, length, w, dev, gen)[
                g.rank]
            out = g.allreduce(x)
            pg = g._device._ops.pg

            def timed(fn):
                col.barrier(group)
                torch.cuda.synchronize()
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                for _ in range(PROC_ITERS):
                    fn()
                t1.record()
                torch.cuda.synchronize()
                return t0.elapsed_time(t1) / PROC_ITERS

            row = {"out": out.cpu(), "ms": timed(lambda: g._device.allreduce(
                x))}
            del x, out
            gen = torch.Generator(device=dev).manual_seed(seed + 1)
            x = _ring_inputs("add", torch.float32, rs_length, w, dev, gen)[
                g.rank]
            out = x.new_empty(rs_length // w)
            pg._reduce_scatter_base(out, x).wait()
            row["rs_out"] = out.cpu()
            row["rs_ms"] = timed(
                lambda: pg._reduce_scatter_base(out, x).wait())
            del x, out
            gen = torch.Generator(device=dev).manual_seed(seed + 2)
            x = _ring_inputs("add", torch.float32, ag_length, w, dev, gen)[
                g.rank]
            out = x.new_empty((w, ag_length))
            pg._allgather_base(out, x).wait()
            row["ag_digest"] = _digest(out)
            row["ag_ms"] = timed(lambda: pg._allgather_base(out, x).wait())
            from ray_tpu_torch.collective import metrics

            row["device_ops"] = metrics.DEVICE_OPS
            return row

        def crossover(self, group, sizes, seed):
            """ms of one f32 sum through the group at each size in floats,
            by each route where every rank holds a card of its own: the
            group's PALLAS route (the gate lifted) and NCCL (the gate
            shut), in turns (pallas, nccl, nccl, pallas), PROC_ITERS
            calls back to back after a barrier each; and the route the
            reference's gate picks at each size."""
            from ray_tpu_torch import collective as col

            dev = torch.device("cuda", 0)
            g = col.get_group(group)
            gate, out = g.PALLAS_MAX_BYTES, []
            for n in sizes:
                gen = torch.Generator(device=dev).manual_seed(seed)
                x = torch.randn(n, generator=gen, device=dev)
                ms = {"pallas": [], "nccl": []}
                for arm in ("pallas", "nccl", "nccl", "pallas"):
                    g.PALLAS_MAX_BYTES = 1 << 62 if arm == "pallas" else -1
                    g.allreduce(x)  # this arm's route, warm
                    col.barrier(group)
                    torch.cuda.synchronize()
                    t0, t1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    t0.record()
                    for _ in range(PROC_ITERS):
                        g.allreduce(x)
                    t1.record()
                    g.check()
                    ms[arm].append(t0.elapsed_time(t1) / PROC_ITERS)
                g.PALLAS_MAX_BYTES = gate
                out.append({"floats": n, "bytes": 4 * n,
                            "pallas_ms": ms["pallas"], "nccl_ms": ms["nccl"],
                            "gate_route": ("pallas" if 4 * n <= gate
                                           else "device")})
            return out

        def tiers(self, group):
            """Which device tiers the group may vote for, and what a forced
            DEVICE tier does with a CUDA payload."""
            from ray_tpu_torch import collective as col

            g = col.get_group(group)
            return {"pallas_shaped": g._pallas_shaped,
                    "device_shaped": g._device_shaped,
                    "blocks": g._blocks}

        def forced_device(self, group):
            from ray_tpu_torch import collective as col

            try:
                col.allreduce(torch.ones(4, device="cuda"), group)
            except RuntimeError as e:
                return str(e)
            return None

        def withhold(self, group, kind, withheld):
            """A call of the transport (no vote) that rank `withheld` does
            not make, after one that every rank made: every other rank's
            host gives up waiting for its event after the timeout and
            raises naming the withheld rank."""
            from ray_tpu_torch import collective as col

            g = col.get_group(group)
            x = torch.ones(12288, device="cuda")  # even over 2, 3, 4

            def call():
                if kind == "allreduce":
                    return g._pallas.allreduce(x)
                if kind == "quantized":
                    return g._pallas.allreduce(x, quantize="int8")
                if kind == "reducescatter":
                    return g._pallas.reducescatter(x)
                return g._pallas.allgather(x)

            col.allreduce(x, group)  # builds the transport
            call()
            g.check()
            col.barrier(group)
            if g.rank == withheld:
                return None
            t0 = time.perf_counter()
            try:
                call()
                g.check()
            except TimeoutError as e:
                return {"raised_after_s": time.perf_counter() - t0,
                        "error": str(e)}
            return {"error": None}

        def counts(self):
            return local_counts()

    return CollectiveRank


def _proc_world(cards):
    """The cross-process runs, (ranks, cards they use): on a one-card
    machine w = 2 and w = 4 on card 0 (B8's hops among more than two
    processes); with two or more cards, w = 2 and w = min(4, cards), a
    card a rank."""
    if cards == 1:
        return [(2, 1), (4, 1)]
    return list(dict.fromkeys([(2, 2), (min(4, cards), min(4, cards))]))


def _proc_group(actors, name, **kwargs):
    from ray_tpu_torch import collective as col

    col.create_collective_group(actors, len(actors), list(range(len(actors))),
                                group_name=name, **kwargs)


def phase_collectives_procs(dev):
    """B5-B8 through the per-process HostGroup (transport "pallas"), its
    ranks in actors of their own: every case bit for bit against the plain
    version, which this process computes from the same seeded inputs,
    through the group where it routes to the kernels (every size where the
    ranks share a card; up to the 64 KB gate where each holds its own,
    whose larger unquantized payloads go to NCCL, as the reference's gate
    sends them, and are checked through the transport alone); each rank's
    launches counted in its own process; a withheld rank; the ms of one
    call beside the bound; the NCCL tier and the crossover table (NCCL
    against the group's PALLAS route, 16 KB to the bucket) where there are
    two or more cards, else its vote of 0."""
    import ray_tpu_torch
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    cards = torch.cuda.device_count()
    base = _rank_actor_cls()

    class Rank(base):
        def destroy(self, name):
            from ray_tpu_torch import collective as col

            col.destroy_collective_group(name)

        def reset(self):
            zero_counts()

    runs, summary = [], {}
    for w, used in _proc_world(cards):
        share = used / w  # a card a rank, or w ranks on one card
        actors = [ray_tpu_torch.remote(num_gpus=share)(Rank).remote()
                  for _ in range(w)]
        infos = ray_tpu_torch.get([a.info.remote() for a in actors],
                                  timeout=300)
        name = f"procs{w}"
        _proc_group(actors, name, transport="pallas",
                    timeout=RING_TIMEOUT_S * 5)
        tiers = ray_tpu_torch.get(actors[0].tiers.remote(name))
        ray_tpu_torch.get([a.reset.remote() for a in actors])
        zero_counts()
        rows = []
        for i, (kind, combine, dtype, length, n) in enumerate(_proc_cases(w)):
            seed = 1000 + i
            got = ray_tpu_torch.get([a.case.remote(
                name, kind, combine, dtype, length, w, seed)
                for a in actors], timeout=600)
            gen = torch.Generator(device=dev).manual_seed(seed)
            xs = _ring_inputs(combine, dtype, length, w, dev, gen)
            want = [_digest(t) for t in _plain_of(kind, combine)(xs)]
            del xs
            gated = got[0]["gated"]
            row = {"kind": kind, "combine": combine, "dtype": str(dtype),
                   "w": w, "n": n, "length": length, "gated": gated,
                   "routed": got[0]["routed"],
                   "bit_identical": [g["digest"] for g in got] == want,
                   "repeat_identical": all(g["repeat_identical"]
                                           for g in got),
                   # the size gate: a card a rank sends an unquantized
                   # payload over 64 KB to NCCL; a shared card, and an
                   # int8 op (NCCL has no int8 wire), keep every size on
                   # the kernels
                   "routed_as_the_reference": all(
                       g["routed"] == (["device"] if gated else ["pallas"])
                       and g["gated"] == gated for g in got)
                   and gated == (tiers["device_shaped"]
                                 and kind != "quantized"
                                 and length * _elt(dtype) > GATE_BYTES)}
            if "ms" in got[0]:
                bound_ms, bound_by, basis = _ring_bound(
                    used, kind, length, w, 4)
                row.update(ms=max(g["ms"] for g in got),
                           rank_ms=[g["ms"] for g in got],
                           transport_ms=max(g["transport_ms"] for g in got),
                           copy_ms=max(g["copy_ms"] for g in got),
                           bound_ms=bound_ms, bound_by=bound_by,
                           bound_basis=basis)
            rows.append(row)
            if not (row["bit_identical"] and row["repeat_identical"]
                    and row["routed_as_the_reference"]):
                emit("collectives_procs", failed=row)
                raise RuntimeError(f"collectives_procs: {row}")
            torch.cuda.empty_cache()
        counts = ray_tpu_torch.get([a.counts.remote() for a in actors])
        driver = local_counts()
        launched = {k: [c[k] for c in counts] for k in RING_COUNTERS}
        if any(driver[k] for k in RING_COUNTERS) or not all(
                all(v > 0 for v in launched[k]) for k in RING_COUNTERS):
            raise RuntimeError(f"collectives_procs launches: ranks "
                               f"{launched}, driver {driver}")
        withheld = {}
        for kind in ("allreduce", "reducescatter", "allgather",
                     "quantized"):
            wname = f"withheld_{kind}_{w}"
            _proc_group(actors, wname, transport="pallas",
                        timeout=RING_TIMEOUT_S)
            res = ray_tpu_torch.get([a.withhold.remote(wname, kind, w - 1)
                                     for a in actors], timeout=300)
            ray_tpu_torch.get([a.destroy.remote(wname) for a in actors])
            errors = [r["error"] for r in res[:-1]]
            named = all(e and f"rank {w - 1}" in e for e in errors)
            withheld[kind] = {"errors": errors, "raised_after_s": [
                r.get("raised_after_s") for r in res[:-1]]}
            if not named:
                raise RuntimeError(f"withheld {kind} w={w}: {res}")
        nccl = crossover = None
        if tiers["device_shaped"]:
            cross = ray_tpu_torch.get([a.crossover.remote(
                name, CROSSOVER_FLOATS, 11) for a in actors], timeout=600)
            crossover = [{**c, "pallas_ms": [max(r[i]["pallas_ms"][j]
                                                 for r in cross)
                                             for j in range(2)],
                          "nccl_ms": [max(r[i]["nccl_ms"][j] for r in cross)
                                      for j in range(2)]}
                         for i, c in enumerate(cross[0])]
            emit("collectives_procs_crossover", w=w, cards_used=used,
                 gate_bytes=GATE_BYTES, sizes=crossover,
                 basis="one f32 sum through the group a rank a card, the "
                 "slowest rank's, two turns each (pallas, nccl, nccl, "
                 "pallas)")
            dname = f"nccl{w}"
            _proc_group(actors, dname, transport="device",
                        timeout=RING_TIMEOUT_S * 30)
            # the lengths of B5's, B6's and B7's cases at GPT-2's bucket
            length, rs_length, ag_length = (
                next(c[3] for c in _proc_cases(w)
                     if c[0] == kind and c[4] == GPT2_NUMEL)
                for kind in ("allreduce", "reducescatter", "allgather"))
            res = ray_tpu_torch.get([a.nccl.remote(
                dname, length, w, 7, rs_length, ag_length)
                for a in actors], timeout=600)
            ray_tpu_torch.get([a.destroy.remote(dname) for a in actors])
            gen = torch.Generator(device=dev).manual_seed(7)
            xs = _ring_inputs("add", torch.float32, length, w, dev, gen)
            want = pb.allreduce_plain(xs, "sum")[0]
            err = max(_rel_l2(r["out"].to(dev), want) for r in res)
            gen = torch.Generator(device=dev).manual_seed(8)
            xs = _ring_inputs("add", torch.float32, rs_length, w, dev, gen)
            want = pb.reducescatter_plain(xs)
            rs_err = max(_rel_l2(r["rs_out"].to(dev), want[i])
                         for i, r in enumerate(res))
            gen = torch.Generator(device=dev).manual_seed(9)
            xs = _ring_inputs("add", torch.float32, ag_length, w, dev, gen)
            ag_exact = all(r["ag_digest"] == _digest(t) for r, t in
                           zip(res, pb.allgather_plain(xs)))
            del xs, want
            nccl = {"ms": max(r["ms"] for r in res), "rel_l2": err,
                    "tol": NCCL_TOL,
                    "reduce_scatter_tensor_ms": max(r["rs_ms"] for r in res),
                    "reduce_scatter_rel_l2": rs_err,
                    "all_gather_into_tensor_ms": max(r["ag_ms"]
                                                     for r in res),
                    "all_gather_bit_identical": ag_exact,
                    "lengths": [length, rs_length, ag_length],
                    "device_ops": [r["device_ops"] for r in res]}
            if max(err, rs_err) > NCCL_TOL or not ag_exact:
                raise RuntimeError(f"NCCL tier: {nccl}")
        else:
            fname = f"forced_device{w}"
            _proc_group(actors, fname, transport="device",
                        timeout=RING_TIMEOUT_S * 5)
            msgs = ray_tpu_torch.get([a.forced_device.remote(fname)
                                      for a in actors])
            ray_tpu_torch.get([a.destroy.remote(fname) for a in actors])
            nccl = {"voted": 0, "why": "ranks share a card: NCCL refuses "
                    "two ranks on one device", "forced_device_errors": msgs}
            if not all(m and "forced collective transport 'device'" in m
                       for m in msgs):
                raise RuntimeError(f"forced device on one card: {msgs}")
        ray_tpu_torch.get([a.destroy.remote(name) for a in actors])
        for a in actors:
            ray_tpu_torch.kill(a)
        run = {"w": w, "cards_used": used, "ranks": infos, "tiers": tiers,
               "cases": len(rows), "all_bit_identical": True,
               "timed": [r for r in rows if "ms" in r],
               "launches_per_rank": launched, "driver_launches": {
                   k: driver[k] for k in RING_COUNTERS},
               "withheld": withheld, "nccl": nccl, "crossover": crossover}
        emit("collectives_procs", **run)
        runs.append(run)
    for name, kind in (("ring_allreduce", "allreduce"),
                       ("ring_reducescatter", "reducescatter"),
                       ("ring_allgather", "allgather"),
                       ("quantized_allreduce", "quantized")):
        row = next(r for r in runs[0]["timed"]
                   if r["kind"] == kind and r["n"] == GPT2_NUMEL)
        summary[name] = {k: row[k] for k in ("bound_ms", "copy_ms")}
        # a card a rank sends the bucket to NCCL: the kernel's own ms is
        # its transport's
        summary[name]["ms"] = row["transport_ms" if row["gated"] else "ms"]
        summary[name]["basis"] = PROCS_BASIS
    return summary


def _plain_of(kind, combine):
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    op = _RING_OPS[combine]
    return {"allreduce": lambda xs: pb.allreduce_plain(xs, op),
            "reducescatter": pb.reducescatter_plain,
            "allgather": pb.allgather_plain,
            "quantized": lambda xs: pb.allreduce_quantized_plain(xs, op)
            }[kind]


def _bucket_of(n):
    from ray_tpu_torch.collective.backends import device_backend as db

    return db._bucket(n)


# GPT-2 124M data-parallel, a rank a process, each at the single-GPU main
# path's 12 x 1024 tokens: two ranks sharing a one-card machine's card,
# or min(4, cards) ranks with a card each
DP_STEPS, DP_PROFILE_STEPS = 6, 2
# the tokens/s of the layout with every rank in one process, measured on
# an H100 80GB HBM3 at 700 W (PERF.md section 5: two ranks on one card;
# four cards, a rank a card), printed beside this run's
DP_IN_PROCESS_TOKENS_S = {1: (55629, 63639), 4: (57482, 57482)}


def dp_workers():
    cards = torch.cuda.device_count()
    return 2 if cards == 1 else min(4, cards)
# the int8 run's mean and last loss of the timed epoch against the exact
# run's: within 2% (the quantized wire rounds each gradient element to
# 1/254 of its 256-block's largest value, twice a hop)
DP_INT8_LOSS_BAND = 0.02
# one float32 DP step (TF32 off, 2 x 1024 tokens a rank) against one
# single-worker step at 4 x 1024 from the same weights: relative L2 of
# each gradient and of all together. The same f32 arithmetic, with the
# batch mean taken as a mean of two means and the matmuls at other
# shapes (another summation order), as gpt2_step's f32 kernel check.
# Where each rank holds a card of its own (sharded is not bit for bit
# with exact there), a sharded=True arm takes the same step: rank 0's
# span of the averaged gradient (reduce-scattered, divided by w) against
# the same span of the single-worker gradient, at the all-gradients limit
# (an un-averaged sum would read w - 1).
DP_F32_TOL = {"grad": 1e-3, "grads_all": 1e-4, "sharded_span": 1e-4}
DP_F32_BATCH = 2
# sharded against exact where each rank holds a card of its own: NCCL's
# reduce-scatter and allreduce fold in orders of their own, and AdamW's
# normalised update turns a last-bit difference in a near-zero gradient
# into a step of its learning rate, so rank 0's parameters after the
# runs are held by relative L2. Its control must exceed the limit: a
# sharded run over half the ranks, trained on half the batch. On four
# H100 80GB HBM3 at 700 W, a card a rank, after the 11 steps of a run:
# sharded 6.65e-5 from exact, the control 0.0818 (after 15 steps:
# 1.20e-4 and 0.103). Where ranks share a card, bit for bit.
DP_SHARDED_TOL = 1e-3


def gpt2_dp_operator_cls():
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.train import TrainingOperator

    class Op(TrainingOperator):
        def setup(self, config):
            # the worker's process: TF32 as the caller's check asks
            from torch.backends import cuda, cudnn

            cuda.matmul.allow_tf32 = cudnn.allow_tf32 = config["tf32"]
            cfg = dataclasses.replace(gpt2_config(config["dtype"]),
                                      n_layers=config.get("n_layers", 12))
            self.register(
                model=transformer.params_from_jax(config["params"], cfg),
                optimizer=config["optimizer"], loss_fn=transformer.loss_fn,
                to_tree=lambda m: (transformer.params_to_jax(m), None),
                from_tree=lambda m, params, _: transformer.load_jax_params(
                    m, params))
            # each rank its own tokens, from a seed of its rank, unless
            # the config names one seed for every rank
            seed = config.get("token_seed", 10 + self.world_rank)
            self.register_data(train_loader=_Repeat(
                _gpt_tokens(self.device, config["batch"], cfg, seed=seed),
                config["steps"]))

    return Op


def _dp_trainer(params, batch, dtype, optimizer, steps, tf32=True,
                workers=None, **kwargs):
    from ray_tpu_torch.train import Trainer

    return Trainer(gpt2_dp_operator_cls(),
                   num_workers=workers or dp_workers(),
                   collective_transport="pallas",
                   resources_per_worker={"GPU": 1},
                   config={"params": params, "batch": batch, "dtype": dtype,
                           "optimizer": optimizer, "steps": steps,
                           "tf32": tf32}, **kwargs)


RING_COUNTERS = ("ring_allreduce", "ring_reducescatter", "ring_allgather",
                 "quantized_allreduce")


# the collective kernels' names in a profiler trace (csrc
# ring_collectives.cu, and NCCL's, which carries the bucket a card a rank)
COLLECTIVE_KERNEL_NAMES = ("direct_reduce", "direct_allgather",
                           "quantized_allreduce", "nccl")


def _param_digest(ops):
    """sha256 of a rank's parameters, in order (run in its worker)."""
    import hashlib

    h = hashlib.sha256()
    for p in ops[0].model.parameters():
        h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _rank0_flat_params(ops):
    return torch.cat([p.detach().reshape(-1).cpu() for p in
                      ops[0].model.parameters()])


def _rank0_grads(ops):
    """Rank 0's .grad of every parameter (the averaged gradient that
    _apply_grads leaves there), on the host."""
    return {n: p.grad.detach().cpu() for n, p in
            ops[0].model.named_parameters()}


def _rank0_shard_grad(ops):
    """Rank 0's averaged gradient span under sharded_update, and where it
    lies in the flat bucket."""
    op = ops[0]
    return op._param_shard.grad.detach().cpu(), op._shard_lo, op._shard_hi


def device_times_us(trace_path):
    """(busy, collective) microseconds of the device in a torch.profiler
    chrome trace: every kernel, memcpy and memset, and the collective
    kernels among them."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e.get("dur", 0) for e in device)
    ring = sum(e.get("dur", 0) for e in device
               if any(k in e.get("name", "") for k in COLLECTIVE_KERNEL_NAMES))
    return busy, ring


def _dp_run(params, label, **kwargs):
    """One run of the DP main path on a trainer of its own (_dp_measure)."""
    return _dp_measure(
        _dp_trainer(params, GPT_BATCH, torch.bfloat16, _adamw,
                    WARMUP + DP_STEPS + DP_PROFILE_STEPS, **kwargs), label)


def _dp_half_batch_weights(params):
    """The sharded check's control: a sharded run over half the ranks
    (ranks 0 to w/2 - 1's tokens, so half the batch), as many steps as a
    measured run; rank 0's weights."""
    import ray_tpu_torch

    steps = WARMUP + DP_STEPS + DP_PROFILE_STEPS
    trainer = _dp_trainer(params, GPT_BATCH, torch.bfloat16, _adamw, steps,
                          workers=max(1, dp_workers() // 2), sharded=True)
    trainer.train(num_steps=steps)
    weights = ray_tpu_torch.get(trainer.workers[0].run.remote(
        _rank0_flat_params)).to("cuda")
    trainer.shutdown()
    return weights


def _dp_measure(trainer, label):
    """Warm-up, a timed epoch with launches counted in each rank's
    worker, an epoch profiled in every worker (train(profile_dir=): one
    trace a rank, each of its own process's kernels); returns its fields
    and rank 0's weights, and shuts the trainer down."""
    import glob
    import tempfile

    import ray_tpu_torch

    cfg = gpt2_config()
    ranks = trainer.num_workers
    warm = trainer.train(num_steps=WARMUP)
    result, counts, meta = measured_train(trainer, DP_STEPS)
    launches = {k: int(counts[k]) for k in (*RING_COUNTERS, "layernorm",
                                            "flash_attn_fwd",
                                            "flash_dense_routes")}
    saved = counts["collective.quantized_bytes_saved_total"]
    with tempfile.TemporaryDirectory(dir=".") as trace_dir:
        profiled = trainer.train(num_steps=DP_PROFILE_STEPS,
                                 profile_dir=trace_dir)
        traces = [device_times_us(p) for p in
                  sorted(glob.glob(os.path.join(trace_dir, "*.json")))]
    busy, ring = (sum(t[i] for t in traces) for i in (0, 1))
    digests = ray_tpu_torch.get([w.run.remote(_param_digest)
                                 for w in trainer.workers])
    # on the card: a host tensor from get() would pin its store block
    weights = ray_tpu_torch.get(trainer.workers[0].run.remote(
        _rank0_flat_params)).to("cuda")
    pids = list(trainer._pids)
    trainer.shutdown()
    del trainer
    per_rank_step = ranks * DP_STEPS
    cards = torch.cuda.device_count()
    fields = {
        "run": label, "tokens_s": result["samples_per_s"] * cfg.max_seq,
        "tokens_s_in_process_before": DP_IN_PROCESS_TOKENS_S.get(cards),
        "ranks": ranks, "cards": cards, "rank_pids": pids,
        "tokens_per_rank_step": GPT_BATCH * cfg.max_seq, "steps": DP_STEPS,
        "launches_per_rank_step": {k: v / per_rank_step
                                   for k, v in launches.items()},
        "ring_launches_by_rank": [{k: int(c[k]) for k in RING_COUNTERS}
                                  for c in meta["rank_counts"]],
        "tier_ops_by_rank": [{k: int(v) for k, v in c.items()
                              if k.endswith("_ops_total")}
                             for c in meta.pop("rank_counts")],
        "collective_share_of_device_time": (ring / busy if busy
                                            else None),
        "device_busy_ms_per_step": busy / 1e3 / DP_PROFILE_STEPS,
        "wall_ms_per_step_profiled": (ranks * GPT_BATCH
                                      / profiled["samples_per_s"] * 1e3),
        "worker_s_per_epoch": (ranks * GPT_BATCH * DP_STEPS
                               / result["samples_per_s"]),
        "warmup_last_loss": warm["last_train_loss"],
        "train_loss": result["train_loss"],
        "last_train_loss": result["last_train_loss"],
        "quant_saved_bytes_per_rank_step": saved / per_rank_step,
        "ranks_bit_identical": len(set(digests)) == 1,
        "distinct_rank_processes": len(set(pids)) == ranks, **meta}
    return fields, launches, weights


def _dp_f32_check(dev, params, sharded):
    """One float32 DP step's averaged gradient against one single-worker
    step at the combined batch, from the same weights (TF32 off); with
    `sharded`, the same for rank 0's span of a sharded=True step."""
    from ray_tpu_torch.models import transformer

    import ray_tpu_torch

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = _dp_trainer(params, DP_F32_BATCH, torch.float32,
                          lambda ps: torch.optim.SGD(ps, lr=0.0), 1,
                          tf32=False)
    trainer.train(num_steps=1)
    dp = {n: g.to(dev) for n, g in ray_tpu_torch.get(
        trainer.workers[0].run.remote(_rank0_grads)).items()}
    trainer.shutdown()
    if sharded:
        trainer = _dp_trainer(params, DP_F32_BATCH, torch.float32,
                              lambda ps: torch.optim.SGD(ps, lr=0.0), 1,
                              tf32=False, sharded=True)
        trainer.train(num_steps=1)
        span, lo, hi = ray_tpu_torch.get(trainer.workers[0].run.remote(
            _rank0_shard_grad))
        trainer.shutdown()
    cfg = gpt2_config(torch.float32)
    model = transformer.params_from_jax(params, cfg).to(dev)
    tokens = torch.cat([_gpt_tokens(dev, DP_F32_BATCH, cfg, seed=10 + r)
                        for r in range(dp_workers())])
    transformer.loss_fn(model, tokens).backward()
    one = {n: p.grad for n, p in model.named_parameters()}
    errs = {"grad": max(_rel_l2(dp[n], one[n]) for n in one),
            "grads_all": _rel_l2(torch.cat([g.flatten() for g in dp.values()]),
                                 torch.cat([g.flatten()
                                            for g in one.values()]))}
    if sharded:
        flat = torch.cat([g.flatten() for g in one.values()])
        flat = torch.cat([flat, flat.new_zeros(max(0, hi - flat.numel()))])
        errs["sharded_span"] = _rel_l2(span.to(dev), flat[lo:hi])
        del flat, span
    worst = max(one, key=lambda n: _rel_l2(dp[n], one[n]))
    del model, dp, one
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"batch_per_rank": DP_F32_BATCH, "errors": errs,
            "tol": DP_F32_TOL, "worst_grad": worst}


def phase_train_gpt2_dp(dev):
    """GPT-2 124M through Trainer(num_workers=dp_workers(),
    collective_transport="pallas"), a rank a worker process: exact,
    quantize="int8" and sharded=True."""
    from ray_tpu_torch.collective.backends import device_backend as db
    from ray_tpu_torch.models import transformer

    cfg = gpt2_config()
    model = transformer.GPT(cfg, seed=0)
    params, numel = transformer.params_to_jax(model), transformer.num_params(
        model)
    del model
    if numel != GPT2_NUMEL:
        raise RuntimeError(f"GPT-2 has {numel} parameters, not {GPT2_NUMEL}")
    n_ln, n_flash = gpt2_launches_per_step(cfg)
    runs, total = {}, collections.Counter()
    # B8 is w + 1 phase launches a call across processes. A card a rank:
    # the size gate sends every unquantized bucket to the DEVICE tier
    # (NCCL), so B5-B7 do not launch there and the device tier counts the
    # ops; the int8 bucket stays on B8 (NCCL has no int8 wire)
    own_cards = torch.cuda.device_count() > 1
    want_ring = {"exact": {"ring_allreduce": 1},
                 "int8": {"quantized_allreduce": dp_workers() + 1},
                 "sharded": {"ring_reducescatter": 1, "ring_allgather": 1}}
    want_device = {"exact": 0, "int8": 0, "sharded": 0}
    if own_cards:
        want_ring.update(exact={}, sharded={})
        want_device.update(exact=1, sharded=2)
    weights = {}
    for label, kwargs in (("exact", {}), ("int8", {"quantize": "int8"}),
                          ("sharded", {"sharded": True})):
        fields, launches, weights[label] = _dp_run(params, label, **kwargs)
        runs[label] = fields
        total.update(launches)
        emit("train_gpt2_dp", **fields)
        per = fields["launches_per_rank_step"]
        ok = (all(per[k] == want_ring[label].get(k, 0)
                  for k in RING_COUNTERS)
              and all(c[k] == DP_STEPS * want_ring[label].get(k, 0)
                      for c in fields["ring_launches_by_rank"]
                      for k in RING_COUNTERS)
              and all(c["collective.device_ops_total"]
                      == DP_STEPS * want_device[label]
                      for c in fields["tier_ops_by_rank"])
              and fields["distinct_rank_processes"]
              and per["layernorm"] == n_ln
              and per["flash_attn_fwd"] == n_flash
              and launches["flash_dense_routes"] == 0
              and fields["ranks_bit_identical"]
              and all(math.isfinite(fields[k]) for k in
                      ("train_loss", "last_train_loss")))
        if not ok:
            raise RuntimeError(f"train_gpt2_dp {label}: {fields}")
    exact, int8 = runs["exact"], runs["int8"]
    w = dp_workers()
    saved = db._qring_saved_bytes(db._qring_pad(GPT2_NUMEL, w), w,
                                  torch.float32, "sum")
    diff = (weights["sharded"] - weights["exact"]).abs()
    half = _dp_half_batch_weights(params) if own_cards else None
    checks = {
        "bucket_route": ({"exact": "device (NCCL)", "int8": "pallas (B8)",
                          "sharded": "device (NCCL)"} if own_cards
                         else "pallas"),
        "sharded_bit_identical_to_exact": bool(
            torch.equal(weights["sharded"], weights["exact"])),
        "sharded_max_abs_diff": float(diff.max()),
        "sharded_params_rel_l2": _rel_l2(weights["sharded"],
                                         weights["exact"]),
        "sharded_params_tol": DP_SHARDED_TOL if own_cards else 0.0,
        "half_batch_params_rel_l2": (None if half is None else
                                     _rel_l2(half, weights["exact"])),
        "sharded_loss_rel_diff": max(
            abs(runs["sharded"][k] - exact[k]) / abs(exact[k])
            for k in ("train_loss", "last_train_loss")),
        "int8_loss_rel_diff": max(abs(int8[k] - exact[k]) / abs(exact[k])
                                  for k in ("train_loss", "last_train_loss")),
        "int8_loss_band": DP_INT8_LOSS_BAND,
        "int8_saved_bytes_per_rank_step": int8[
            "quant_saved_bytes_per_rank_step"],
        "qring_saved_bytes": saved,
        "f32": _dp_f32_check(dev, params, sharded=own_cards)}
    emit("train_gpt2_dp", checks=checks)
    f32 = checks["f32"]
    del diff, half, weights
    torch.cuda.empty_cache()
    # a card a rank: sharded within DP_SHARDED_TOL of exact, and the
    # half-batch control beyond it
    if not ((checks["sharded_params_rel_l2"] <= DP_SHARDED_TOL
             < checks["half_batch_params_rel_l2"] if own_cards
             else checks["sharded_bit_identical_to_exact"])
            and checks["int8_loss_rel_diff"] <= DP_INT8_LOSS_BAND
            and checks["int8_saved_bytes_per_rank_step"] == saved
            and all(err <= DP_F32_TOL[k]
                    for k, err in f32["errors"].items())):
        raise RuntimeError(f"train_gpt2_dp checks: {checks}")
    return {k: total[k] for k in RING_COUNTERS}


# train_gpt2_elastic: steps an epoch, epochs of the control, and the
# collective timeout of its trainers (how long a survivor waits for a
# dead rank before its collective raises)
ELASTIC_STEPS, ELASTIC_EPOCHS, ELASTIC_TIMEOUT_S = 6, 3, 10.0
# GPT-2 124M's widths cut to 6 of its 12 layers: the phase checks
# recovery bit for bit, which does not depend on depth, and its time is
# generation starts and state moved, which depth scales
ELASTIC_LAYERS = 6
# where in the epoch the driver's timer kills rank 1: this share of the
# control's steady epoch
ELASTIC_KILL_AT = 0.5


def _elastic_trainer(params, ranks):
    """A sharded GPT-2 trainer of the elastic phase: every rank the same
    tokens (seed 10), so the trajectory does not depend on the world
    size."""
    from ray_tpu_torch.train import Trainer

    return Trainer(gpt2_dp_operator_cls(), num_workers=ranks, sharded=True,
                   resources_per_worker={"GPU": 1},
                   collective_timeout=ELASTIC_TIMEOUT_S, max_retries=2,
                   config={"params": params, "batch": GPT_BATCH,
                           "dtype": torch.bfloat16, "optimizer": _adamw,
                           "steps": ELASTIC_STEPS, "tf32": True,
                           "token_seed": 10, "n_layers": ELASTIC_LAYERS})


def _generation(trainer):
    """The trainer's generation as it stands: its number, world size,
    collective group, rank pids, whether its gang is reserved, and each
    rank's B6 and B7 launches (read from the rank's own process)."""
    import ray_tpu_torch

    names = ("ring_reducescatter", "ring_allgather")
    return {"generation": trainer._generation,
            "world": trainer.num_workers, "group": trainer._group_name,
            "pids": list(trainer._pids), "gang": trainer._pg is not None,
            "b6_b7_by_rank": [[int(c) for c in ray_tpu_torch.get(
                [w.read_counter.remote(n) for n in names])]
                for w in trainer.workers]}


def _digests(trainer):
    import ray_tpu_torch

    return ray_tpu_torch.get([w.run.remote(_param_digest)
                              for w in trainer.workers])


def phase_train_gpt2_elastic(dev, smi):
    """GPT-2 124M's widths at ELASTIC_LAYERS layers, sharded over
    dp_workers() ranks, through the Trainer's fault tolerance: an uninterrupted control of ELASTIC_EPOCHS epochs;
    an elastic run (epoch 1, save, epoch 2 with rank 1's process
    SIGKILLed by a timer partway through, so train() re-gangs, a resize
    to one rank, epoch 3); and a fresh one-rank trainer that loads the
    epoch-1 checkpoint and trains epoch 2. Both must equal the control
    bit for bit."""
    import signal
    import tempfile
    import threading

    import ray_tpu_torch
    from ray_tpu_torch._private import global_state
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.native.store.segment import segment_dir
    from ray_tpu_torch.train import sharding
    from ray_tpu_torch.util import placement_group_table

    cfg = dataclasses.replace(gpt2_config(), n_layers=ELASTIC_LAYERS)
    model = transformer.GPT(cfg, seed=0)
    params = transformer.params_to_jax(model)
    del model
    ranks = dp_workers()
    cw = global_state.get_core_worker()

    def fallbacks():
        snap = cw._io.run(cw.gcs.call(
            "get_metric", {"name": "gcs.placement_topology_fallbacks_total"}))
        return snap["value"] if snap else 0.0

    zero_counts()
    reshards, fallbacks_before = sharding.RESHARDS, fallbacks()

    # the control: ELASTIC_EPOCHS epochs, one generation
    control = _elastic_trainer(params, ranks)
    pg = control._pg
    rec = placement_group_table()[pg.id.hex()] if pg is not None else {}
    gang = {"reserved": pg is not None, "state": rec.get("state"),
            "strategy": rec.get("strategy"),
            "topology_plan": rec.get("topology_plan"),
            "nodes": len({b["node_id"] for b in rec.get("bundles", [])}),
            "bundles": [b["resources"] for b in rec.get("bundles", [])]}
    control_losses, epoch_s = [], []
    for epoch in range(ELASTIC_EPOCHS):
        r = control.train()
        control_losses.append(r["train_loss"])
        epoch_s.append(r["num_samples"] / r["samples_per_s"])
        if epoch == 1:  # where the loaded trainer ends
            epoch2_digests = _digests(control)
    control_gen = _generation(control)
    control_digests = _digests(control)
    control.shutdown()
    gang["after_shutdown"] = (pg is not None
                              and pg.id.hex() in placement_group_table())
    gang["topology_fallbacks"] = fallbacks() - fallbacks_before

    with tempfile.TemporaryDirectory(dir=".") as ckpt_dir:
        path = os.path.join(ckpt_dir, "ckpt")
        tr = _elastic_trainer(params, ranks)
        losses = [tr.train()["train_loss"]]
        gens = [_generation(tr)]
        t0 = time.perf_counter()
        tr.save(path)
        save_s = time.perf_counter() - t0
        ckpt_bytes = {f: os.path.getsize(os.path.join(ckpt_dir, f))
                      for f in sorted(os.listdir(ckpt_dir))}
        # epoch 2: a timer kills rank 1 partway through it
        death = {}
        kill_after = ELASTIC_KILL_AT * statistics.median(epoch_s[1:])

        def kill():
            death["at"] = time.monotonic()
            os.kill(gens[0]["pids"][1], signal.SIGKILL)

        timer = threading.Timer(kill_after, kill)
        started = time.monotonic()
        timer.start()
        losses.append(tr.train()["train_loss"])
        timer.join()
        regangs = list(tr._regangs)
        segs = (sorted(os.listdir(segment_dir()))
                if os.path.isdir(segment_dir()) else [])
        dead = [s for s in segs if gens[0]["group"] in s or any(
            f"ring_events_{p}_" in s for p in gens[0]["pids"])]
        gens.append(_generation(tr))
        tr._num_workers = 1
        tr._resize_worker_group()
        losses.append(tr.train()["train_loss"])
        gens.append(_generation(tr))
        elastic_digests = _digests(tr)
        tr.shutdown()

        loaded = _elastic_trainer(params, 1)
        t0 = time.perf_counter()
        loaded.load(path)
        load_s = time.perf_counter() - t0
        loaded_losses = [loaded.train()["train_loss"]]
        loaded_gen = _generation(loaded)
        loaded_digests = _digests(loaded)
        loaded.shutdown()

    driver = local_counts()
    regang = regangs[0] if regangs else {}
    fields = {
        "nvidia_smi": smi, "ranks": ranks, "steps_per_epoch": ELASTIC_STEPS,
        "tokens_per_rank_step": GPT_BATCH * cfg.max_seq,
        "collective_timeout_s": ELASTIC_TIMEOUT_S,
        "control_epoch_s": epoch_s, "control_losses": control_losses,
        "control_generation": control_gen, "gang": gang,
        "elastic_losses": losses, "elastic_generations": gens,
        "loaded_losses": loaded_losses, "loaded_generation": loaded_gen,
        "kill_into_epoch_s": death.get("at", started) - started,
        "regangs": len(regangs),
        "regang_world": regang.get("world_size"),
        # the death to the driver's hearing of it, and to the next
        # generation restored (the retried epoch's first step follows)
        "death_to_failure_s": regang.get("failed_at", 0) - death.get("at", 0),
        "regang_s": regang.get("restored_at", 0) - death.get("at", 0),
        # of it: the old generation killed (its processes gone, its
        # leases and gang returned), the new one started (processes,
        # group, operators), its state restored (sync_state and the
        # optimizer shards)
        "kill_s": regang.get("started_at", 0) - regang.get("resize_at", 0),
        "start_s": (regang.get("restored_at", 0)
                    - regang.get("started_at", 0)
                    - regang.get("restore_s", 0)),
        "restore_s": regang.get("restore_s"),
        "sync_state_s": regang.get("sync_state_s"),
        "save_s": save_s, "load_s": load_s, "checkpoint_bytes": ckpt_bytes,
        "reshards": sharding.RESHARDS - reshards,
        "dead_generation_segments": dead, "segments_after_regang": segs,
        "driver_counts": {k: v for k, v in driver.items() if v},
        "elastic_equals_control": elastic_digests[0] == control_digests[0],
        "loaded_equals_control": loaded_digests[0] == epoch2_digests[0],
        "ranks_bit_identical": len(set(control_digests + elastic_digests))
        == 1}
    emit("train_gpt2_elastic", **fields)
    steps = ELASTIC_STEPS

    # a card a rank: the size gate sends the bucket to NCCL
    kernels = torch.cuda.device_count() == 1

    def launched(gen, epochs):
        want = ([epochs * steps] * 2 if gen["world"] > 1 and kernels
                else [0, 0])
        return all(c == want for c in gen["b6_b7_by_rank"])

    ok = (control_gen["generation"] == 1
          and launched(control_gen, ELASTIC_EPOCHS)
          and [g["generation"] for g in gens] == [1, 2, 3]
          and [g["world"] for g in gens] == [ranks, ranks, 1]
          and launched(gens[0], 1) and launched(gens[1], 1)
          and launched(gens[2], 1) and loaded_gen["generation"] == 1
          and launched(loaded_gen, 1)
          and all(g["gang"] for g in (control_gen, *gens[:2]))
          and gang["state"] == "CREATED" and gang["strategy"] == "ICI_RING"
          and gang["topology_plan"] is None and gang["nodes"] == 1
          and gang["after_shutdown"] is False
          and gang["topology_fallbacks"] >= 1
          and len(regangs) == 1 and regang["world_size"] == ranks
          and regang["sync_state_s"] is not None
          and losses == control_losses
          and loaded_losses == control_losses[1:2]
          and fields["elastic_equals_control"]
          and fields["loaded_equals_control"]
          and fields["ranks_bit_identical"]
          and fields["reshards"] == 2 and not dead and not any(driver.values())
          and all(math.isfinite(v) for v in control_losses))
    if not ok:
        raise RuntimeError(f"train_gpt2_elastic: {fields}")


# train_ingest: ResNet-50 as phase train runs it, fed by a DatasetShard
# actor through the object store at prefetch depth 2, against an
# in-memory control of the same batches, a distinct one each step (so a
# dropped, repeated or reordered batch changes the losses). cuDNN is
# deterministic in both arms (benchmark off), and the two arms' losses
# are held bit for bit.
INGEST_DEPTH = 2


def _host_batches():
    """ResNet-50's synthetic batches, made on the host from a seed: STEPS
    of them, step i's the seeded images rolled by i rows with labels of
    seed i, the bytes both arms of train_ingest train on (every epoch
    replays them from the first)."""
    gen = torch.Generator().manual_seed(0)
    images = torch.randn((BATCH, HW, HW, 3), generator=gen).to(
        torch.bfloat16)
    return [(images.roll(i, 0), torch.randint(
        0, 1000, (BATCH,), generator=torch.Generator().manual_seed(i)))
        for i in range(STEPS)]


def _ingest_dataset(shard_index, num_shards, config):
    """The DatasetShard's source: the host batches."""
    return _host_batches()


def _ingest_operator_cls():
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.train import TrainingOperator

    class Op(TrainingOperator):
        def setup(self, config):
            from torch.backends import cudnn

            cudnn.benchmark = False
            cudnn.deterministic = True
            model = resnet.ResNet(resnet.resnet50(bn_mode="kernel"), seed=0)
            self.register(
                model=model, optimizer=_sgd,
                loss_fn=lambda m, b: resnet.loss_fn(m, b[0], b[1]),
                to_tree=resnet.params_to_jax,
                from_tree=resnet.load_jax_params)
            if config.get("in_memory"):
                self.register_data(train_loader=[
                    (images.to(self.device), labels.to(self.device))
                    for images, labels in _host_batches()])

    return Op


def _hist_delta(after, before):
    """The observations a histogram took between two snapshots."""
    if not before:
        return after
    return {**after, "count": after["count"] - before["count"],
            "counts": [a - b for a, b in zip(after["counts"],
                                             before["counts"])]}


def phase_train_ingest(dev):
    """ResNet-50 through Trainer(ingest=IngestSpec(depth 2)): img/s beside
    an in-memory control's (both cuDNN-deterministic), phase train's and
    the raw loop's; train.ingest_wait_s p50 and p99 of the measured epoch,
    read from the worker; the worker's B1 launches; the losses of the two
    arms."""
    import ray_tpu_torch
    from ray_tpu_torch.train import Trainer
    from ray_tpu_torch.train.ingest import IngestSpec, hist_quantile

    arms, launches = {}, 0
    for label, kwargs in (
            ("ingest", {"config": {"steps": STEPS}, "ingest": IngestSpec(
                _ingest_dataset, prefetch_depth=INGEST_DEPTH)}),
            ("in_memory", {"config": {"steps": STEPS, "in_memory": True}})):
        trainer = Trainer(_ingest_operator_cls(), num_workers=1,
                          resources_per_worker={"GPU": 1}, **kwargs)
        worker = trainer.workers[0]
        warm = trainer.train(num_steps=WARMUP)
        before = ray_tpu_torch.get(
            worker.read_metric.remote("train.ingest_wait_s"))
        step_before = ray_tpu_torch.get(
            worker.read_metric.remote("train.step_s"))
        result, counts, meta = measured_train(trainer, STEPS)
        wait = _hist_delta(ray_tpu_torch.get(
            worker.read_metric.remote("train.ingest_wait_s")), before)
        step = _hist_delta(ray_tpu_torch.get(
            worker.read_metric.remote("train.step_s")), step_before)
        actors = len(trainer._ingest_actors)
        trainer.shutdown()
        del trainer
        arms[label] = {
            "img_s": result["samples_per_s"], "ingest_actors": actors,
            "losses": [warm["train_loss"], warm["last_train_loss"],
                       result["train_loss"], result["last_train_loss"]],
            "bn_bwd_sums_launches": int(counts["bn_bwd_sums"]),
            "step_s_p50": hist_quantile(step, 0.5),
            "step_s_p99": hist_quantile(step, 0.99),
            "ingest_wait_count": wait["count"] if wait else 0,
            "ingest_wait_s_p50": hist_quantile(wait, 0.5) if wait else None,
            "ingest_wait_s_p99": hist_quantile(wait, 0.99) if wait else None,
            "max_memory_allocated": meta["max_memory_allocated"],
            "driver_wall_s_per_train": meta["driver_wall_s_per_train"]}
        if label == "ingest":
            launches = int(counts["bn_bwd_sums"])
        torch.cuda.empty_cache()
    ing, mem = arms["ingest"], arms["in_memory"]
    fields = {
        "img_s": ing["img_s"], "img_s_in_memory": mem["img_s"],
        "ingest_over_in_memory": ing["img_s"] / mem["img_s"],
        "train_img_s": TRAIN_FIELDS.get("img_s"),
        "raw_img_s": TRAIN_FIELDS.get("raw_img_s"),
        "batch_bytes": BATCH * HW * HW * 3 * 2 + BATCH * 8,
        "prefetch_depth": INGEST_DEPTH, "steps": STEPS,
        "losses_bit_identical": ing["losses"] == mem["losses"],
        "distinct_batches": STEPS,
        "cudnn": "deterministic, benchmark off (both arms)", "arms": arms}
    emit("train_ingest", **fields)
    ok = (launches == 53 * STEPS and ing["ingest_actors"] == 1
          and ing["ingest_wait_count"] == STEPS
          and fields["losses_bit_identical"]
          and all(math.isfinite(v) for v in ing["losses"]))
    if not ok:
        raise RuntimeError(f"train_ingest: {fields}")


# train_gpt2_mesh: GPT-2 124M under config={"multihost": True}, a card a
# rank, 12 x 1024 tokens a rank: mesh_mode="fsdp" (the table's (w, 1),
# data parallel) and an explicit (1, w) ('data','fsdp') mesh whose
# parameters are sharded; MESH_WARMUP steps, then MESH_WINDOWS timed
# epochs of MESH_STEPS steps each, the parameters compared after them
# (relative L2, MESH_TOL: NCCL's allreduce and reduce-scatter fold in
# orders of their own, and AdamW's normalised update turns a last-bit
# difference in a near-zero gradient into a step of its learning rate).
# Its control must exceed the limit: the first run's parameters one step
# later (PERF.md section 6 has both readings).
MESH_WARMUP, MESH_STEPS, MESH_WINDOWS, MESH_TOL = 1, 4, 2, 1e-3
# ProcessMeshGroup's payload: floats a rank, divisible by 2, 3 and 4
MESH_COLL_N = 12 << 16


def gpt2_mesh_operator_cls():
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.train import TrainingOperator

    class Op(TrainingOperator):
        def setup(self, config):
            from torch.backends import cudnn
            from torch.distributed.device_mesh import DeviceMesh

            from ray_tpu_torch.parallel import mesh as meshlib

            cudnn.benchmark = True
            cfg = gpt2_config()
            model = transformer.GPT(cfg, seed=0)
            kw = {}
            if config.get("explicit"):
                w = self.world_size
                mesh = DeviceMesh("cuda", torch.arange(w).reshape(1, w),
                                  mesh_dim_names=("data", "fsdp"))
                kw = dict(mesh=mesh, param_spec=meshlib.fsdp_param_specs(
                    dict(model.named_parameters()), mesh),
                    batch_spec=meshlib.P(("data", "fsdp")))
            self.register(
                model=model, optimizer=_adamw, loss_fn=transformer.loss_fn,
                to_tree=lambda m: (transformer.params_to_jax(m), None),
                from_tree=lambda m, params, _: transformer.load_jax_params(
                    m, params), **kw)
            self.register_data(train_loader=_Repeat(
                _gpt_tokens(self.device, GPT_BATCH, cfg,
                            seed=10 + self.world_rank),
                MESH_STEPS))

    return Op


def _layout(ops):
    """(elements sharded, elements in all) of a rank's mesh layout."""
    entries = ops[0]._layout._entries
    return (sum(math.prod(shape) for _, shape, _, sh in entries
                if sh is not None),
            sum(math.prod(shape) for _, shape, _, _ in entries))


def _flat_state(trainer):
    """The trainer's parameters (state_dict: a collective on every rank of
    a mesh), flattened in name order on the host."""
    params = trainer.state_dict()["params"]
    return torch.cat([torch.from_numpy(a).reshape(-1) for a in (
        [params[k] for k in sorted(params) if k != "blocks"]
        + [params["blocks"][k] for k in sorted(params["blocks"])])])


def _mesh_run(label, ranks, control=False, **kwargs):
    """One mesh trainer: warm-up, MESH_WINDOWS timed epochs; its fields
    and its parameters, and with `control` its parameters one step later
    too."""
    import ray_tpu_torch
    from ray_tpu_torch.train import Trainer

    cfg = gpt2_config()
    trainer = Trainer(gpt2_mesh_operator_cls(), num_workers=ranks,
                      resources_per_worker={"GPU": 1}, **kwargs)
    layout = ray_tpu_torch.get(trainer.workers[0].run.remote(_layout))
    trainer.train(num_steps=MESH_WARMUP)
    windows = [measured_train(trainer, MESH_STEPS)
               for _ in range(MESH_WINDOWS)]
    peaks = ray_tpu_torch.get([w.run.remote(_worker_peak)
                               for w in trainer.workers])
    flat = _flat_state(trainer)
    later = None
    if control:
        trainer.train(num_steps=1)
        later = _flat_state(trainer)
    pids = list(trainer._pids)
    trainer.shutdown()
    result = windows[-1][0]
    fields = {"run": label, "ranks": ranks, "rank_pids": pids,
              "tokens_s_by_window": [r["samples_per_s"] * cfg.max_seq
                                     for r, _, _ in windows],
              "tokens_per_rank_step": GPT_BATCH * cfg.max_seq,
              "steps": MESH_STEPS, "windows": MESH_WINDOWS,
              "sharded_elements": layout[0],
              "elements": layout[1], "peak_memory_by_rank": peaks,
              "launches_by_rank": [{k: int(c[k]) for k in (
                  "layernorm", "flash_attn_fwd", "flash_dense_routes")}
                  for _, _, meta in windows for c in meta["rank_counts"]],
              "train_loss": result["train_loss"],
              "last_train_loss": result["last_train_loss"],
              "driver_wall_s_per_train": [meta["driver_wall_s_per_train"]
                                          for _, _, meta in windows]}
    return fields, flat, later


class _MeshRank:
    """A process of a multihost runtime (NCCL, its own card) with a
    collective group of backend "xla" over it: a ProcessMeshGroup."""

    def __init__(self, name, w, rank):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.parallel import multihost

        multihost.initialize(name, w, rank)
        col.init_collective_group(w, rank, backend="xla",
                                  group_name=name + "_x")
        self.name, self.w, self.rank = name, w, rank

    def run(self, seed):
        """Each op through the group on this rank's input of the w made
        from the seed (as the driver makes them): the outputs' digests."""
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective import ReduceOp

        g = col.get_group(self.name + "_x")
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(seed)
        ints, floats = _mesh_coll_inputs(self.w, dev, gen)
        i, f = ints[self.rank], floats[self.rank]
        out = {"group": type(g).__name__,
               "sum": _digest(g.allreduce(i)),
               "max": _digest(g.allreduce(f, ReduceOp.MAX)),
               "broadcast": _digest(g.broadcast(f, 1)),
               "allgather": _digest(torch.stack(g.allgather(f))),
               "reducescatter": _digest(g.reducescatter(i)),
               "shift_right": _digest(g.shift_right(f))}
        torch.cuda.synchronize()
        return out


def _mesh_coll_inputs(w, dev, gen):
    """Every rank's int32 and float32 payload: integer sums are exact in
    any order, and MAX, the allgather, the broadcast and the shift move
    bytes."""
    ints = [torch.randint(-1000, 1000, (MESH_COLL_N,), generator=gen,
                          device=dev, dtype=torch.int32) for _ in range(w)]
    floats = [torch.randn(MESH_COLL_N, generator=gen, device=dev)
              for _ in range(w)]
    return ints, floats


def _in_process_shift(dev):
    """shift_right on the in-process group (backend "xla": every rank in
    this process, rank r on cuda:(r % cards), the allgather kernel B7
    carrying it) at w = 2, bit for bit."""
    import uuid

    from ray_tpu_torch import collective as col

    name = f"shift_{uuid.uuid4().hex[:6]}"
    hs = [col.init_collective_group(2, r, backend="xla", group_name=name)
          for r in range(2)]
    try:
        xs = [torch.randn(MESH_COLL_N, device=h.device,
                          generator=torch.Generator(device=h.device)
                          .manual_seed(20 + r)) for r, h in enumerate(hs)]
        torch.cuda.synchronize()
        outs = []
        for h, x in zip(hs, xs):
            with torch.cuda.stream(h.stream):
                outs.append(h.shift_right(x))
        for h in hs:
            h.check()
        return all(torch.equal(o.cpu(), xs[(r - 1) % 2].cpu())
                   for r, o in enumerate(outs))
    finally:
        col.destroy_collective_group(name)


def phase_train_gpt2_mesh(dev):
    """GPT-2 124M under config={"multihost": True} on w = min(4, cards)
    ranks, a card a rank: (a) mesh_mode="fsdp", (b) an explicit (1, w)
    mesh with fsdp_param_specs. Tokens/s and peak memory a rank of both,
    the relative L2 of (b)'s parameters against (a)'s, B2 and B3 launched
    in every rank's process; ProcessMeshGroup's ops bit for bit against
    their plain versions; shift_right on the in-process group. On one card
    one worker with mesh_mode="fsdp" (a (1, 1) mesh), and a multihost
    trainer of two ranks must raise."""
    import uuid

    import ray_tpu_torch
    from ray_tpu_torch.collective.backends import pallas_backend as pb
    from ray_tpu_torch.train import Trainer

    cfg = gpt2_config()
    n_ln, n_flash = gpt2_launches_per_step(cfg)
    cards = torch.cuda.device_count()
    w = min(4, cards)
    fields = {"cards": cards, "in_process_shift_bit_identical":
              _in_process_shift(dev)}
    if w == 1:
        run, _, _ = _mesh_run("fsdp", 1, mesh_mode="fsdp")
        runs = [run]
        try:
            Trainer(gpt2_mesh_operator_cls(), num_workers=2,
                    mesh_mode="fsdp", config={"multihost": True},
                    resources_per_worker={"GPU": 1})
            refused = None
        except ValueError as e:
            refused = str(e)
        fields.update(mesh_across_ranks="needs a card a rank: NCCL refuses "
                      "two ranks on one card", multihost_refused=refused)
        ok = bool(refused and "NCCL refuses" in refused)
    else:
        a, pa, pa_later = _mesh_run("fsdp", w, control=True,
                                    mesh_mode="fsdp",
                                    config={"multihost": True})
        torch.cuda.empty_cache()
        b, pb_, _ = _mesh_run("explicit_1xw", w,
                              config={"multihost": True, "explicit": True})
        runs = [a, b]
        rel = _rel_l2(pb_, pa)
        control = _rel_l2(pa_later, pa)
        name = f"mesh_{uuid.uuid4().hex[:6]}"
        ranks = [ray_tpu_torch.remote(num_gpus=1)(_MeshRank).remote(
            name, w, r) for r in range(w)]
        got = ray_tpu_torch.get([r.run.remote(5) for r in ranks],
                                timeout=300)
        for r in ranks:
            ray_tpu_torch.kill(r)
        gen = torch.Generator(device=dev).manual_seed(5)
        ints, floats = _mesh_coll_inputs(w, dev, gen)
        want = {"sum": [_digest(t) for t in pb.allreduce_plain(ints, "sum")],
                "max": [_digest(t) for t in pb.allreduce_plain(floats,
                                                               "max")],
                "broadcast": [_digest(floats[1])] * w,
                "allgather": [_digest(torch.stack(floats))] * w,
                "reducescatter": [_digest(t)
                                  for t in pb.reducescatter_plain(ints)],
                "shift_right": [_digest(floats[(r - 1) % w])
                                for r in range(w)]}
        coll = {op: [g[op] for g in got] == digests
                for op, digests in want.items()}
        fields.update(params_rel_l2=rel, params_tol=MESH_TOL,
                      one_step_later_rel_l2=control,
                      process_mesh_group=[g["group"] for g in got],
                      process_mesh_bit_identical=coll)
        ok = (rel <= MESH_TOL < control and all(coll.values())
              and all(g["group"] == "ProcessMeshGroup" for g in got)
              and b["sharded_elements"] > 0)
    fields["runs"] = runs
    emit("train_gpt2_mesh", **fields)
    ok = (ok and fields["in_process_shift_bit_identical"]
          and all(c == {"layernorm": n_ln * MESH_STEPS,
                        "flash_attn_fwd": n_flash * MESH_STEPS,
                        "flash_dense_routes": 0}
                  for run in runs for c in run["launches_by_rank"])
          and all(math.isfinite(run[k]) for run in runs
                  for k in ("train_loss", "last_train_loss")))
    if not ok:
        raise RuntimeError(f"train_gpt2_mesh: {fields}")


# ---------------------------------------------------------------------------
# the rest of the transformer family: ViT-B/16 and BERT-base
# ---------------------------------------------------------------------------

# steps of each measured train() of ViT-B/16 and BERT-base (after WARMUP)
FAMILY_STEPS = 10
# kernel vs plain step of ViT-B/16 and BERT-base (one loss and gradient
# from the same weights and batch, bf16): relative L2 of the loss and of
# all gradients together, every layernorm and flash call of the kernel
# step also held against its plain version on its own inputs ("layers",
# in units of NORM_TOL and FLASH_TOL). The kernels round like the plain
# versions and differ by a bf16 ulp where their f32 sums straddle a
# rounding boundary (GPT_STEP_TOL's reasoning). The control must exceed
# grads_all: the plain step with every layernorm weight scaled by
# 1 + FAMILY_FAULT (PERF.md section 6 has both readings).
FAMILY_STEP_TOL = {"loss": 1e-2, "grads_all": 5e-2, "layers": 1.0}
FAMILY_FAULT = 2.0 ** -4
# the pad-mask invariance of tests/test_models.py:101 (absolute, on the
# [CLS] logits): padded tokens may not move them; without the mask they do
PAD_TOL = 1e-5


def _checked_ops(layer_errs):
    """An Ops that runs the kernels and holds every call against its
    plain version on the same inputs, errors appended to layer_errs in
    units of their tolerance."""
    from ray_tpu_torch.models import transformer

    kernel, plain = transformer.OPS["kernel"], transformer.OPS["plain"]

    def checked_ln(*args):
        got = kernel.layernorm(*args)
        layer_errs["layernorm"].append(
            norm_err(got, plain.layernorm(*args)) / NORM_TOL)
        return got

    def checked_flash(*args):
        got = kernel.flash_attention(*args)
        layer_errs["flash_attn_fwd"].append(
            flash_err(got, plain.flash_attention(*args)) / FLASH_TOL)
        return got

    return transformer.Ops(checked_ln, checked_flash)


def _faulty_ops():
    """The plain forwards with every layernorm weight scaled by
    1 + FAMILY_FAULT: the control a step tolerance must catch."""
    from ray_tpu_torch.models import transformer

    plain = transformer.OPS["plain"]
    return transformer.Ops(
        lambda x, w, b, eps: plain.layernorm(x, w * (1 + FAMILY_FAULT), b,
                                             eps),
        plain.flash_attention)


def _vit_batch(dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn((VIT_BATCH, 224, 224, 3), generator=gen,
                         device=dev, dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (VIT_BATCH,), generator=gen, device=dev)
    return images, labels


def _bert_batch(dev, seed=0):
    """(tokens, labels, token types), no pad mask: the first 256 tokens of
    each row segment 0, the rest segment 1."""
    from ray_tpu_torch.models import bert

    cfg = bert.bert_base()
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (BERT_BATCH, cfg.max_seq),
                           generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (BERT_BATCH,), generator=gen,
                           device=dev)
    types = (torch.arange(cfg.max_seq, device=dev) >= cfg.max_seq // 2).to(
        torch.int64).expand(BERT_BATCH, -1)
    return tokens, labels, types


FAMILY = {  # name: (model module, its config function, batch, batch size)
    "vit": ("vit", "vit_b16", _vit_batch, VIT_BATCH),
    "bert": ("bert", "bert_base", _bert_batch, BERT_BATCH),
}


def _family(name, ops_mode="kernel"):
    """(module, config) of a family model with ops_mode."""
    import importlib

    mod_name, cfg_fn = FAMILY[name][:2]
    mod = importlib.import_module(f"ray_tpu_torch.models.{mod_name}")
    return mod, dataclasses.replace(getattr(mod, cfg_fn)(),
                                    ops_mode=ops_mode)


def _family_model(name, dev, ops_mode="kernel"):
    mod, cfg = _family(name, ops_mode)
    return (mod.ViT(cfg, seed=0, device=dev) if name == "vit"
            else mod.Bert(cfg, seed=0, device=dev))


def family_operator_cls(name):
    from ray_tpu_torch.train import TrainingOperator

    class Op(TrainingOperator):
        def setup(self, config):
            from torch.backends import cudnn

            cudnn.benchmark = True
            mod, _ = _family(name)
            self.register(
                model=_family_model(name, self.device), optimizer=_adamw,
                loss_fn=mod.loss_fn,
                to_tree=lambda m: (mod.params_to_jax(m), None),
                from_tree=lambda m, params, _: mod.load_jax_params(m,
                                                                   params))
            self.register_data(train_loader=_Repeat(
                FAMILY[name][2](self.device), config["steps"] + WARMUP))

    return Op


def _raw_samples_s(name, dev):
    """The same step without the framework."""
    mod, _ = _family(name)
    model = _family_model(name, dev)
    opt = _adamw(model.parameters())
    batch = FAMILY[name][2](dev)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = mod.loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = torch.stack([step() for _ in range(FAMILY_STEPS)]).tolist()
    dt = time.perf_counter() - t0
    return FAMILY[name][3] * FAMILY_STEPS / dt, losses


def _family_step(name, dev, ops_mode):
    """loss and gradients of one step from seed 0's weights on the main
    path's batch, ops_mode a name or an Ops. ViT's head, zero at init as
    the reference's, is drawn from a seed here, so that the encoder gets a
    gradient."""
    mod, _ = _family(name)
    model = _family_model(name, dev, ops_mode)
    if name == "vit":
        gen = torch.Generator(device=dev).manual_seed(4)
        with torch.no_grad():
            model.head_w.copy_(torch.randn(
                model.head_w.shape, generator=gen, device=dev)
                * model.head_w.shape[0] ** -0.5)
    loss = mod.loss_fn(model, FAMILY[name][2](dev))
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {n: p.grad.float()
                         for n, p in model.named_parameters()}


def _step_errs(lk, gk, lp, gp):
    return {"loss": abs(lk - lp) / abs(lp),
            "grads_all": _rel_l2(
                torch.cat([g.flatten() for g in gk.values()]),
                torch.cat([g.flatten() for g in gp.values()]))}


def _family_step_check(name, dev):
    """One step of ops_mode="kernel" (every call checked) against "plain",
    and the faulty control against "plain"."""
    layer_errs = {"layernorm": [], "flash_attn_fwd": []}
    zero_counts()
    lk, gk = _family_step(name, dev, _checked_ops(layer_errs))
    step_counts = local_counts()
    lp, gp = _family_step(name, dev, "plain")
    errs = _step_errs(lk, gk, lp, gp)
    errs["layers"] = max(max(v) for v in layer_errs.values() if v)
    del gk
    lf, gf = _family_step(name, dev, _faulty_ops())
    control = _step_errs(lf, gf, lp, gp)
    del gp, gf
    torch.cuda.empty_cache()
    return {"loss_kernel": lk, "loss_plain": lp, "errors": errs,
            "tol": FAMILY_STEP_TOL, "control_fault": FAMILY_FAULT,
            "control_errors": control,
            "checked_calls": {k: len(v) for k, v in layer_errs.items()},
            "step_launches": {k: step_counts[k] for k in (
                "layernorm", "flash_attn_fwd", "flash_dense_routes")}}


def _bert_padded(ops):
    """In the worker: one loss and gradient of a padded BERT-base batch
    (rows of 512, 384, 256 and 128 real tokens, twice) through the
    trainer's model, the dense masked attention; its launches; and the
    [CLS] logits' move when the padded tokens change (they must not)."""
    from ray_tpu_torch.models import bert

    model = ops[0].model
    dev = next(model.parameters()).device
    tokens, labels, types = _bert_batch(dev, seed=3)
    lengths = torch.tensor([512, 384, 256, 128] * (BERT_BATCH // 4),
                           device=dev)
    mask = torch.arange(tokens.shape[1], device=dev)[None] < lengths[:, None]
    torch.cuda.synchronize()
    zero_counts()
    loss = bert.loss_fn(model, (tokens, labels, types, mask))
    loss.backward()
    torch.cuda.synchronize()
    counts = local_counts()
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        base = model(tokens, types, mask)[0].float()
        scrambled = torch.where(mask, tokens, (tokens + 7)
                                % bert.bert_base().vocab_size)
        moved = model(scrambled, types, mask)[0].float()
        unmasked = model(scrambled, types)[0].float()
    return {"loss": loss.item(),
            "launches": {k: counts[k] for k in (
                "layernorm", "flash_attn_fwd", "flash_dense_routes")},
            "masked_move": float((moved - base).abs().max()),
            "unmasked_move": float((unmasked - base).abs().max())}


def family_launches_per_step(name):
    """(layernorm, flash, dense-route) calls of one training step: two
    layernorms a block and the final one, one attention a block, the
    blocks' forwards again under remat; ViT's 197 tokens take the dense
    route (not tile-aligned, as in the reference), BERT's 512 the flash
    kernel."""
    _, cfg = _family(name)
    enc = cfg.encoder_config()
    n_ln, n_att = gpt2_launches_per_step(enc)
    return (n_ln, 0, n_att) if name == "vit" else (n_ln, n_att, 0)


def phase_train_family(name, dev):
    """ViT-B/16 or BERT-base through Trainer (one worker, {"GPU": 1}),
    its raw-loop control, launches a step; one kernel step against the
    plain one (and the faulty control); BERT also one padded batch."""
    import ray_tpu_torch
    from ray_tpu_torch.train import Trainer

    torch.backends.cudnn.benchmark = True
    _, cfg = _family(name)
    trainer = Trainer(family_operator_cls(name), num_workers=1,
                      config={"steps": FAMILY_STEPS},
                      resources_per_worker={"GPU": 1})
    n_params = ray_tpu_torch.get(trainer.workers[0].run.remote(
        lambda ops: sum(p.numel() for p in ops[0].model.parameters())))
    trainer.train(num_steps=WARMUP)
    result, counts, meta = measured_train(trainer, FAMILY_STEPS)
    padded = None
    if name == "bert":
        padded = ray_tpu_torch.get(trainer.workers[0].run.remote(
            _bert_padded))
    trainer.shutdown()
    del trainer
    torch.cuda.empty_cache()
    raw, raw_losses = _raw_samples_s(name, dev)
    step = _family_step_check(name, dev)
    launches = {k: int(counts[k]) for k in ("layernorm", "flash_attn_fwd",
                                            "flash_dense_routes")}
    want = dict(zip(("layernorm", "flash_attn_fwd", "flash_dense_routes"),
                    family_launches_per_step(name)))
    rate = result["samples_per_s"]
    unit = "img_s" if name == "vit" else "seq_s"
    fields = {unit: rate, f"raw_{unit}": raw,
              "framework_fraction": rate / raw, "params": n_params,
              "batch": FAMILY[name][3], "steps": FAMILY_STEPS,
              "last_train_loss": result["last_train_loss"],
              "train_loss": result["train_loss"],
              "raw_last_loss": raw_losses[-1],
              "launches_per_step": {k: v / FAMILY_STEPS
                                    for k, v in launches.items()},
              "step_check": step, **meta}
    if name == "bert":
        fields["tokens_s"] = rate * cfg.max_seq
        fields["padded"] = padded
    emit(f"train_{name}", **fields)
    tol = FAMILY_STEP_TOL
    ok = (all(launches[k] == v * FAMILY_STEPS for k, v in want.items())
          and step["step_launches"] == want
          and all(step["errors"][k] <= tol[k] for k in tol)
          and step["control_errors"]["grads_all"] > tol["grads_all"]
          and all(math.isfinite(result[k])
                  for k in ("train_loss", "last_train_loss")))
    if name == "bert":
        pad_want = dict(zip(("layernorm", "flash_attn_fwd",
                             "flash_dense_routes"),
                            (want["layernorm"], 0, 0)))
        ok = ok and (padded["launches"] == pad_want
                     and math.isfinite(padded["loss"])
                     and padded["masked_move"] <= PAD_TOL
                     < padded["unmasked_move"])
    if not ok:
        raise RuntimeError(f"train_{name}: {fields}, want {want} a step")
    return launches


# ---------------------------------------------------------------------------
# the parallel axes, a card a rank: shard_map, ring, Ulysses, MoE, pipeline
# ---------------------------------------------------------------------------

# the MoE model's attention and expert shapes (MoETransformerConfig()):
# batch 4 x 4096 tokens, 8 heads of 64, d 512, 8 experts of d_ff 1024
PAR_B, PAR_T, PAR_H, PAR_D = 4, 4096, 8, 64
PAR_MODEL, PAR_FF, PAR_EXPERTS = 512, 1024, 8
# capacity for moe_apply's check against the dense top-1 computation: no
# token dropped (asserted from the routing's loads)
PAR_CAPACITY = 2.0
# the pipeline: GPT-2 124M's twelve blocks over pp = w stages, float32
# (TF32 off), batch 8 x 1024 in 4 microbatches
PIPE_BATCH, PIPE_MICRO = 8, 4
# each case against its control on the same card (float32, TF32 off):
# outputs max |got − want| / max |want|, gradients Σ|got − want| / Σ|want|
# per tensor. Each case has a control that must exceed its limit: the
# dense control with the causal mask flipped (ring, Ulysses), the dense
# top-1 MoE with the tokens of half the experts dropped, the sequential
# blocks with the stages in reverse order; with w > 1 also the ring with
# K/V sent two ranks on (a stride-2 permutation) and each rank's gradient
# of the replicated weight left un-summed (PERF.md section 6 has the
# readings).
PAR_TOL = {"out": 1e-4, "grad": 1e-4}


def _par_rank_cls():
    class ParallelRank:
        """A rank of the parallel phases: a process of its own on its
        card, in a multihost runtime of w ranks (NCCL; one card, w = 1)."""

        def __init__(self, name, w, rank):
            from ray_tpu_torch.parallel import multihost

            multihost.initialize(name, w, rank)
            self.w, self.rank = w, rank

        def run(self, fn, *args):
            out = fn(self.rank, self.w, *args)
            torch.cuda.synchronize()
            return out

        def pid(self):
            return os.getpid()

    return ParallelRank


_PAR_RANKS = []


def par_ranks():
    """The phases' rank actors (min(4, cards), a card each), started
    once."""
    import uuid

    import ray_tpu_torch

    if not _PAR_RANKS:
        w = min(4, torch.cuda.device_count())
        name = f"par_{uuid.uuid4().hex[:6]}"
        cls = ray_tpu_torch.remote(num_gpus=1)(_par_rank_cls())
        _PAR_RANKS.extend(cls.remote(name, w, r) for r in range(w))
    return _PAR_RANKS


def _running(pid):
    """Whether the process pid is there and not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def release_par_ranks(timeout=60.0):
    """Kills the rank actors and waits until their processes are gone and
    the cluster has their cards back, so that the phases after them can
    lease the cards."""
    import ray_tpu_torch

    pids = ray_tpu_torch.get([r.pid.remote() for r in _PAR_RANKS])
    for r in _PAR_RANKS:
        ray_tpu_torch.kill(r)
    _PAR_RANKS.clear()
    want = ray_tpu_torch.cluster_resources().get("GPU", 0)
    deadline = time.monotonic() + timeout
    while (ray_tpu_torch.available_resources().get("GPU", 0) < want
           or any(_running(p) for p in pids)):
        if time.monotonic() > deadline:
            raise TimeoutError("the parallel phases' rank actors still hold "
                               f"cards after {timeout} s")
        time.sleep(0.2)


def par_run(fn, *args, timeout=600):
    """fn(rank, w, *args) on every rank at once; their results."""
    import ray_tpu_torch

    return ray_tpu_torch.get([r.run.remote(fn, *args) for r in par_ranks()],
                             timeout=timeout)


def _rel_max(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _rel_l1(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().sum() / want.abs().sum().clamp_min(
        1e-30))


def _par_attention(rank, w, kind, causal, device=None):
    """shard_map(ring_attention or ulysses_attention of q · wq, k, v) on a
    (sp = w) mesh, q, k, v sharded over sp and wq [D] replicated, against
    dense attention on this card: output, and the gradients of q, k, v
    and wq for one cotangent."""
    from ray_tpu_torch.parallel import mesh as M
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel.ring_attention import (reference_attention,
                                                       ring_attention)
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    # TF32 off (not through torch.backends: a by-value function that
    # names it cannot be pickled to the ranks)
    torch.set_float32_matmul_precision("highest")
    mesh = M.MeshSpec(sp=w).build(device)
    dev = M.mesh_device(mesh)
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (PAR_B, PAR_T, PAR_H, PAR_D)
    q, k, v, cot = (torch.randn(shape, generator=gen, device=dev)
                    for _ in range(4))
    wq = 1 + 0.2 * torch.randn(PAR_D, generator=gen, device=dev)
    body = ring_attention if kind == "ring" else ulysses_attention
    spec = M.P("dp", "sp", None, None)

    def grads(fn):
        args = [t.clone().requires_grad_() for t in (q, k, v, wq)]
        out = fn(*args)
        (out * cot).sum().backward()
        return out.detach(), [a.grad for a in args]

    t0 = time.perf_counter()
    out, g = grads(M.shard_map(
        lambda q, k, v, wq: body(q * wq, k, v, causal=causal), mesh,
        (spec, spec, spec, M.P()), spec))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want, gw = grads(lambda q, k, v, wq: reference_attention(
        q * wq, k, v, causal=causal))
    res = {"out": _rel_max(out, want),
           **{f"d{n}": _rel_l1(a, b) for n, a, b in zip(
               ("q", "k", "v", "wq"), g, gw)},
           "seconds_fwd_bwd": seconds}
    del g, out
    flipped, _ = grads(lambda q, k, v, wq: reference_attention(
        q * wq, k, v, causal=not causal))
    res["control_causal_flipped_out"] = _rel_max(flipped, want)
    if w > 1:
        controls = {}
        if kind == "ring":
            # K/V sent two places on: some blocks visited twice, others
            # never (the full ring's order does not matter, its blocks do)
            send = spmd.ppermute
            spmd.ppermute = lambda x, a, perm: send(
                x, a, [(s, (s + 2) % w) for s, _ in perm])
            try:
                wrong, _ = grads(M.shard_map(
                    lambda q, k, v, wq: body(q * wq, k, v, causal=causal),
                    mesh, (spec, spec, spec, M.P()), spec))
            finally:
                spmd.ppermute = send
            controls["perm_stride2_out"] = _rel_max(wrong, want)
        # this rank's own gradient of wq, not summed over the mesh
        local = wq.clone().requires_grad_()
        with M.manual(mesh):
            lay = M.current_layout()
            qs, ks, vs, cs = (spmd._block(t, lay, ("sp",), 1)
                              for t in (q, k, v, cot))
            (body(qs * local, ks, vs, causal=causal) * cs).sum().backward()
        controls["unsummed_dwq"] = _rel_l1(local.grad, gw[3])
        res["controls"] = controls
    return res


def _dense_top1(x, router_w, w_in, w_out, experts):
    """out_i = p_i,e · gelu(x_i W_in[e]) W_out[e] for each token's top-1
    expert e, over the experts in `experts` (the others' tokens give 0),
    and the Switch aux loss: the function moe_apply computes when no token
    is dropped."""
    import torch.nn.functional as F

    e_total = router_w.shape[1]
    probs = torch.softmax(x @ router_w, dim=-1)
    top = probs.argmax(-1)
    gate = probs.gather(-1, top[:, None])[:, 0]
    out = torch.zeros_like(x)
    for e in experts:
        idx = (top == e).nonzero()[:, 0]
        h = F.gelu(x[idx] @ w_in[e], approximate="tanh")
        out = out.index_put((idx,), gate[idx, None] * (h @ w_out[e]))
    density = F.one_hot(top, e_total).to(probs.dtype).mean(0)
    aux = (density * probs.mean(0)).sum() * e_total
    return out, aux, torch.bincount(top, minlength=e_total)


def _par_moe(rank, w, device=None):
    """moe_apply on an (ep = w) mesh (experts sharded over ep, tokens and
    the router replicated) at the MoE model's shapes, against the dense
    top-1 computation: output, aux and the gradients of x, router_w,
    w_in, w_out."""
    from ray_tpu_torch.parallel import mesh as M
    from ray_tpu_torch.parallel import moe

    # TF32 off (not through torch.backends: a by-value function that
    # names it cannot be pickled to the ranks)
    torch.set_float32_matmul_precision("highest")
    mesh = M.MeshSpec(ep=w).build(device)
    dev = M.mesh_device(mesh)
    gen = torch.Generator(device=dev).manual_seed(8)
    n, d, f, e = PAR_B * PAR_T, PAR_MODEL, PAR_FF, PAR_EXPERTS
    x = torch.randn((n, d), generator=gen, device=dev)
    router_w = torch.randn((d, e), generator=gen, device=dev) * d ** -0.5
    w_in = torch.randn((e, d, f), generator=gen, device=dev) * d ** -0.5
    w_out = torch.randn((e, f, d), generator=gen, device=dev) * f ** -0.5
    cot = torch.randn((n, d), generator=gen, device=dev)

    def grads(fn):
        args = [t.clone().requires_grad_() for t in (x, router_w, w_in,
                                                     w_out)]
        out, aux = fn(*args)[:2]
        ((out * cot).sum() + aux).backward()
        return out.detach(), aux.item(), [a.grad for a in args]

    t0 = time.perf_counter()
    out, aux, g = grads(lambda *a: moe.moe_apply(
        *a, mesh=mesh, capacity_factor=PAR_CAPACITY))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want, aux_want, gw = grads(lambda *a: _dense_top1(*a, range(e)))
    loads = _dense_top1(x, router_w, w_in, w_out, ())[2]
    capacity = max(1, int(PAR_CAPACITY * n / e))
    half, _, _ = grads(lambda *a: _dense_top1(*a, range(e // 2)))
    return {"out": _rel_max(out, want), "aux": abs(aux - aux_want) / aux_want,
            **{f"d{k}": _rel_l1(a, b) for k, a, b in zip(
                ("x", "router_w", "w_in", "w_out"), g, gw)},
            "capacity": capacity, "max_load": int(loads.max()),
            "control_half_experts_out": _rel_max(half, want),
            "seconds_fwd_bwd": seconds}


def _par_pipeline(rank, w, device=None):
    """pipeline_apply of GPT-2 124M's twelve blocks over pp = w stages,
    float32, against the blocks applied in order on this card: output and
    the gradients of x (replicated over pp) and of every stacked block
    parameter (sharded over pp)."""
    import types

    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.parallel import mesh as M
    from ray_tpu_torch.parallel import pipeline

    # TF32 off (not through torch.backends: a by-value function that
    # names it cannot be pickled to the ranks)
    torch.set_float32_matmul_precision("highest")
    mesh = M.MeshSpec(pp=w).build(device)
    dev = M.mesh_device(mesh)
    cfg = dataclasses.replace(gpt2_config(torch.float32), remat=False)
    per = cfg.n_layers // w
    gpt = transformer.GPT(cfg, seed=0)
    keys = transformer._BLOCK_KEYS
    stacked = {k: torch.stack([torch.stack([
        getattr(gpt.blocks[s * per + i], k).detach() for i in range(per)])
        for s in range(w)]).to(dev) for k in keys}
    del gpt
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((PIPE_BATCH, cfg.max_seq, cfg.d_model), generator=gen,
                    device=dev)
    cot = torch.randn(x.shape, generator=gen, device=dev)

    def stage_fn(params, h):
        for i in range(per):
            blk = types.SimpleNamespace(**{k: params[k][i] for k in keys})
            h = transformer._block(h, blk, cfg)
        return h

    def sequential(params, h, order):
        for s in order:
            h = stage_fn({k: v[s] for k, v in params.items()}, h)
        return h

    def grads(fn):
        ps = {k: v.clone().requires_grad_() for k, v in stacked.items()}
        xs = x.clone().requires_grad_()
        out = fn(ps, xs)
        (out * cot).sum().backward()
        return out.detach(), xs.grad, {k: v.grad for k, v in ps.items()}

    t0 = time.perf_counter()
    out, dx, dp = grads(lambda ps, xs: pipeline.pipeline_apply(
        stage_fn, ps, xs, mesh=mesh, num_microbatches=PIPE_MICRO))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want, dx_w, dp_w = grads(lambda ps, xs: sequential(ps, xs, range(w)))
    res = {"out": _rel_max(out, want), "dx": _rel_l1(dx, dx_w),
           "dparams_max": max(_rel_l1(dp[k], dp_w[k]) for k in keys),
           "seconds_fwd_bwd": seconds, "stages": w, "blocks_a_stage": per}
    del dp, dp_w
    order = list(range(w))[::-1] if w > 1 else None
    if order is None:  # one stage: its blocks in reverse order
        rev = {k: v.flip(1) for k, v in stacked.items()}
        with torch.no_grad():
            wrong = sequential(rev, x, range(1))
    else:
        with torch.no_grad():
            wrong = sequential(stacked, x, order)
    res["control_reversed_out"] = _rel_max(wrong, want)
    return res


# the MoE transformer on the layouts with tp or pp > 1 (C2): each against
# the same weights on (sp 2, ep 2), which splits the tokens the same way
# over (dp, sp) and so routes with the same capacity; float32, TF32 off,
# the default widths at C2_BATCH x C2_SEQ tokens
C2_LAYOUTS = {"moe_tp2_sp2": {"tp": 2, "sp": 2},
              "moe_pp2_sp2": {"pp": 2, "sp": 2}}
C2_CONTROL_MESH = {"sp": 2, "ep": 2}
C2_BATCH, C2_SEQ = 2, 1024


def _par_moe_layout(rank, w, shape, device=None):
    """The MoE transformer on `shape` against the same weights and
    tokens on C2_CONTROL_MESH: the logits, aux and loss, and every
    parameter's gradient (the experts' gathered over ep). Its control:
    the same run with each rank's parameter gradients left un-summed
    over the layout's tp or pp axis."""
    from ray_tpu_torch.models import moe_transformer as M
    from ray_tpu_torch.parallel import mesh as meshlib
    from ray_tpu_torch.parallel import spmd

    # TF32 off (not through torch.backends: a by-value function that
    # names it cannot be pickled to the ranks)
    torch.set_float32_matmul_precision("highest")
    cfg = dataclasses.replace(M.MoETransformerConfig(), dtype=torch.float32,
                              max_seq=C2_SEQ)
    axis = "tp" if shape.get("tp", 1) > 1 else "pp"

    def run(mesh_shape, unsummed=None):
        mesh = meshlib.MeshSpec(**mesh_shape).build(device)
        dev = meshlib.mesh_device(mesh)
        model = M.MoETransformer(cfg, mesh, seed=0)
        gen = torch.Generator(device=dev).manual_seed(12)
        tokens = torch.randint(0, cfg.vocab_size, (C2_BATCH, C2_SEQ),
                               generator=gen, device=dev)
        summed = spmd._PVary.apply
        if unsummed:
            def apply(x, lay, axes):
                kept = tuple(a for a in axes if a != unsummed)
                return summed(x, lay, kept) if kept else x
            spmd._PVary.apply = apply
        try:
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, aux = M.apply(model, tokens)
            loss, _ = M.loss_fn(model, tokens)
            loss.backward()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            spmd._PVary.apply = summed
        lay = meshlib.layout(mesh)
        grads = {n: (spmd._all_gather(p.grad, lay, ("ep",), 0)
                     if n.rsplit(".", 1)[-1] in M._EXPERT_KEYS else p.grad)
                 for n, p in model.named_parameters()}
        return logits, aux.detach(), loss.detach(), grads, seconds

    logits, aux, loss, grads, seconds = run(shape)
    want, aux_w, loss_w, grads_w, _ = run(C2_CONTROL_MESH)
    _, _, _, wrong, _ = run(shape, unsummed=axis)
    return {"mesh": shape, "against_mesh": C2_CONTROL_MESH,
            "out": _rel_max(logits, want),
            "aux": float(abs(aux - aux_w) / aux_w),
            "loss": float(abs(loss - loss_w) / loss_w),
            "dparams_max": max(_rel_l1(grads[n], grads_w[n])
                               for n in grads_w),
            "control_unsummed_dparams": max(_rel_l1(wrong[n], grads_w[n])
                                            for n in grads_w),
            "unsummed_axis": axis, "seconds_fwd_bwd": seconds}


def _par_case_ok(r, w):
    """One rank's readings of a parallel case within PAR_TOL, its
    controls beyond it."""
    outs = [v for k, v in r.items() if k in ("out", "aux", "loss")]
    grads = [v for k, v in r.items() if k.startswith("d")
             and not k.startswith("dparams")] + (
        [r["dparams_max"]] if "dparams_max" in r else [])
    controls = [v for k, v in r.items() if k.startswith("control_")]
    if w > 1 and "controls" in r:
        controls += [r["controls"].get("perm_stride2_out", math.inf)]
    return (all(v <= PAR_TOL["out"] for v in outs)
            and all(v <= PAR_TOL["grad"] for v in grads)
            and all(v > PAR_TOL["out"] for v in controls)
            and (w == 1 or "controls" not in r
                 or r["controls"]["unsummed_dwq"] > PAR_TOL["grad"])
            and r.get("max_load", 0) <= r.get("capacity", 1))


def phase_parallel(dev):
    """Ring attention (causal and full), Ulysses, moe_apply and the
    pipeline on w = min(4, cards) ranks, a card each (one card: the w = 1
    mesh through the same code), each against its dense or sequential
    control on the same card, forward and gradients, with its controls."""
    cards = torch.cuda.device_count()
    w = min(4, cards)
    cases = {
        "ring_causal": (_par_attention, "ring", True),
        "ring_full": (_par_attention, "ring", False),
        "ulysses_causal": (_par_attention, "ulysses", True),
        "moe_apply": (_par_moe,),
        "pipeline": (_par_pipeline,),
    }
    if w == 4:
        cases.update({name: (_par_moe_layout, shape)
                      for name, shape in C2_LAYOUTS.items()})
    fields = {"ranks": w, "cards": cards, "tol": PAR_TOL,
              "mesh_note": None if w > 1 else (
                  "one card: the w = 1 mesh through the same code; NCCL "
                  "refuses two ranks on one card; the MoE model's tp and "
                  "pp layouts need four cards")}
    failed = []
    for name, (fn, *args) in cases.items():
        # every rank assembles the global outputs and gradients itself:
        # each rank's readings are held to the limits
        got = par_run(fn, *args)
        fields[name] = got[0] if w == 1 else {"by_rank": got}
        if not all(_par_case_ok(r, w) for r in got):
            failed.append(name)
        torch.cuda.empty_cache()
    emit("parallel", failed=failed, **fields)
    if failed:
        raise RuntimeError(f"parallel: {failed} failed: {fields}")


# ---------------------------------------------------------------------------
# the MoE transformer (MoETransformerConfig(): ring, bf16) on the ranks
# ---------------------------------------------------------------------------

MOE_BATCH, MOE_STEPS = 4, 4
# ring against Ulysses logits on the same weights and tokens (bf16 model,
# f32 logits), relative L2: both attend in f32 and cast once to bf16, in
# another order; its control must exceed it: the ring logits one AdamW
# step later (PERF.md section 6 has both readings)
MOE_RING_ULYSSES_TOL = 1e-2
# the aux loss's range, tests/test_models.py:209
MOE_AUX = (0.5, 4.0)


def _moe_mesh_shape(w):
    return {"sp": 2, "ep": 2} if w == 4 else ({"ep": w} if w > 1 else {})


def _moe_train(rank, w, device=None):
    """The MoE transformer on this rank's part of the mesh: AdamW steps
    (one warm-up, MOE_STEPS timed, every count from 0 just before), the
    aux of each, the launches of the timed steps in this process; ring
    against Ulysses logits on the same weights, then one more step."""
    from ray_tpu_torch.models import moe_transformer as M
    from ray_tpu_torch.parallel import mesh as meshlib

    mesh = meshlib.MeshSpec(**_moe_mesh_shape(w)).build(device)
    dev = meshlib.mesh_device(mesh)
    cfg = M.MoETransformerConfig()
    model = M.MoETransformer(cfg, mesh, seed=0)
    opt = _adamw(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, cfg.max_seq),
                           generator=gen, device=dev)

    def step():
        opt.zero_grad(set_to_none=True)
        loss, aux = M.loss_fn(model, tokens)
        loss.backward()
        opt.step()
        return loss.detach(), aux

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = [step() for _ in range(MOE_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = local_counts()
    with torch.no_grad():
        ring, _ = M.apply(model, tokens)
        uly, _ = M.apply(model, tokens, "ulysses")
    step()
    with torch.no_grad():
        later, _ = M.apply(model, tokens)
    return {"tokens_s": MOE_BATCH * cfg.max_seq * MOE_STEPS / dt,
            "mesh": meshlib.axis_sizes(mesh), "steps": MOE_STEPS,
            "losses": [float(l) for l, _ in out],
            "aux": [float(a) for _, a in out],
            "params": M.num_params(model),
            "launches": {k: counts[k] for k in (
                "layernorm", "flash_attn_fwd", "flash_dense_routes")},
            "ring_vs_ulysses_rel_l2": _rel_l2(uly, ring),
            "control_one_step_later_rel_l2": _rel_l2(later, ring),
            "logits_finite": bool(torch.isfinite(ring).all()),
            "peak_memory": torch.cuda.max_memory_allocated()}


def phase_train_moe(dev):
    """The default MoETransformerConfig() (vocab 32000, 4 layers, d 512,
    8 heads, 8 experts of d_ff 1024, capacity 1.25, bf16, ring) at
    MOE_BATCH x 4096 tokens on the ranks: (1, 1, 1, 1, 1) on one card,
    sp = 2 x ep = 2 on four; tokens/s, aux in MOE_AUX, ring against
    Ulysses, the layernorm launches counted in every rank's process."""
    from ray_tpu_torch.models import moe_transformer as M

    got = par_run(_moe_train)
    r = got[0]
    cfg = M.MoETransformerConfig()
    n_ln = (2 * cfg.n_layers + 1) * MOE_STEPS
    fields = {"ranks": len(got), "by_rank": got, "tokens_s": r["tokens_s"],
              "tol": MOE_RING_ULYSSES_TOL, "aux_range": MOE_AUX}
    emit("train_moe", **fields)
    ok = all(g["launches"] == {"layernorm": n_ln, "flash_attn_fwd": 0,
                               "flash_dense_routes": 0}
             and all(MOE_AUX[0] < a < MOE_AUX[1] for a in g["aux"])
             and all(math.isfinite(l) for l in g["losses"])
             and g["logits_finite"]
             and g["ring_vs_ulysses_rel_l2"] <= MOE_RING_ULYSSES_TOL
             < g["control_one_step_later_rel_l2"] for g in got)
    if not ok:
        raise RuntimeError(f"train_moe: {fields}")
    return {"layernorm": sum(g["launches"]["layernorm"] for g in got)}


# ---------------------------------------------------------------------------
# Serve: the streaming tier with its KV arena on the card
# ---------------------------------------------------------------------------

# the reference's serve model (integer weights) at inner 1024, so that a
# rank's KV row is 1024 / num_shards f32 wide
SERVE_MODEL = {"vocab": 32, "hidden": 8, "inner": 1024}
SERVE_SEED = 17
SERVE_STREAMS, SERVE_INFLIGHT, SERVE_SESSIONS = 128, 32, 4
SERVE_PREFIX = 64
# prompt + max_tokens <= 192 keeps every logit an integer below
# 8 · hidden · inner · 192 ≈ 1.26e7 < 2^24: the decode is exact in f32
SERVE_MAX_LEN = 192
SERVE_PAGE, SERVE_ARENA_BYTES = 16, 2 << 30
SERVE_GROUP_TIMEOUT_S = 5.0
SERVE_KILL_STREAMS = 8


def _serve_traffic(rng):
    """SERVE_STREAMS requests: prompts of 32-96 tokens, half of them
    behind one SERVE_PREFIX-token prefix (a system prompt), max_tokens
    32-96 within SERVE_MAX_LEN; SERVE_SESSIONS of them open a session
    (short enough for a second turn within SERVE_MAX_LEN)."""
    vocab = SERVE_MODEL["vocab"]
    prefix = rng.integers(0, vocab, SERVE_PREFIX).tolist()
    reqs = []
    for i in range(SERVE_STREAMS):
        session = f"s{i}" if i < SERVE_SESSIONS else None
        if session:
            n, m = int(rng.integers(32, 49)), int(rng.integers(32, 49))
            prompt = rng.integers(0, vocab, n).tolist()
        elif i % 2:
            n = int(rng.integers(SERVE_PREFIX, 97))
            prompt = prefix + rng.integers(0, vocab, n - SERVE_PREFIX).tolist()
        else:
            n = int(rng.integers(32, 97))
            prompt = rng.integers(0, vocab, n).tolist()
        if not session:
            m = int(rng.integers(32, min(96, SERVE_MAX_LEN - n) + 1))
        req = {"prompt": prompt, "max_tokens": m}
        if session:
            req["session"] = session
        reqs.append(req)
    return reqs


def _serve_stream(handle, req):
    """(tokens, seconds to the first token, seconds) of one stream."""
    t0 = time.perf_counter()
    toks, first = [], None
    for tok in handle.stream(req, timeout=120.0):
        if first is None:
            first = time.perf_counter() - t0
        toks.append(tok)
    return toks, first, time.perf_counter() - t0


def _serve_members(client, name, shards):
    """The deployment's ranks: every gang member, or the replica."""
    import ray_tpu_torch

    if shards > 1:
        gangs = ray_tpu_torch.get(
            client._controller.get_gang_members.remote(name), timeout=60)
        return gangs[0]
    state = ray_tpu_torch.get(
        client._controller.get_routing_state.remote(name), timeout=60)
    return list(state["backends"][name]["replicas"])


def _hist_ms(snap):
    """p50, p99 (bucket bounds) and the mean of a histogram, in ms."""
    from ray_tpu_torch._private import stats

    return {"p50_ms": stats.percentile(snap, 0.5) * 1e3,
            "p99_ms": stats.percentile(snap, 0.99) * 1e3,
            "mean_ms": snap["sum"] / max(snap["count"], 1) * 1e3,
            "count": snap["count"]}


def _serve_deployment(client, shards, model, reqs, want, pids):
    """One deployment of the model on the card: SERVE_STREAMS streams,
    SERVE_INFLIGHT in flight, then the sessions' second turns; its
    readings and whether every stream decoded exactly and every rank
    ended with only the retained sessions' pages in use, the same
    tables as the other ranks and no leak."""
    from concurrent.futures import ThreadPoolExecutor

    import ray_tpu_torch
    from ray_tpu_torch import serve

    name = f"lm{shards}"
    width = SERVE_MODEL["inner"] // shards
    pages = SERVE_ARENA_BYTES // (SERVE_PAGE * width * 4)
    t0 = time.perf_counter()
    client.create_backend(name, type(model), model.embed, model.w_up,
                          model.w_out, config=serve.BackendConfig(
                              streaming=True, num_shards=shards,
                              kv_backend="torch",
                              num_gpus_per_shard=1.0 / (2 * shards)
                              if shards > 1 else 1.0,
                              kv_page_size=SERVE_PAGE, kv_pages_total=pages,
                              prefix_sharing=True, max_decode_batch=32,
                              max_waiting_sequences=2 * SERVE_INFLIGHT,
                              shard_group_timeout_s=SERVE_GROUP_TIMEOUT_S))
    client.create_endpoint(name, backend=name)
    handle = client.get_handle(name)
    members = _serve_members(client, name, shards)
    ray_tpu_torch.get([m.engine_state.remote() for m in members],
                      timeout=300)  # every rank up, its arena allocated
    deploy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_INFLIGHT) as pool:
        got = list(pool.map(lambda r: _serve_stream(handle, r), reqs))
    wall = time.perf_counter() - t0
    turns = [{"prompt": [5, 7, 11, 13], "max_tokens": 16,
              "session": r["session"]} for r in reqs if r.get("session")]
    with ThreadPoolExecutor(len(turns)) as pool:
        second = list(pool.map(lambda r: _serve_stream(handle, r), turns))
    first_turn = {r["session"]: r["prompt"] + got[i][0]
                  for i, r in enumerate(reqs) if r.get("session")}
    want2 = [model.generate(first_turn[t["session"]] + t["prompt"],
                            t["max_tokens"]) for t in turns]
    exact = ([g[0] for g in got] == want
             and [g[0] for g in second] == want2)
    sessions = {f"sess:{t['session']}" for t in turns}
    deadline = time.monotonic() + 30.0
    while True:  # the last retirements may trail the streams' ends
        states = ray_tpu_torch.get(
            [m.engine_state.remote() for m in members], timeout=60)
        if (all(set(st["kv"]["owners"]) == sessions for st in states)
                or time.monotonic() > deadline):
            break
        time.sleep(0.1)
    pids.update(st["pid"] for st in states)
    snap = ray_tpu_torch.get(members[0].stats_snapshot.remote(), timeout=60)
    tokens = sum(len(g[0]) for g in got)
    ttft = sorted(g[1] for g in got)
    fields = {
        "num_shards": shards, "deploy_s": deploy_s, "streams": len(got),
        "second_turns": len(second), "wall_s": wall, "tokens": tokens,
        "tokens_s": tokens / wall,
        "ttft": _hist_ms(snap["serve.ttft_s"]),
        "decode_step": _hist_ms(snap["serve.decode_step_s"]),
        "client_ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
        "client_ttft_p99_ms": ttft[int(0.99 * (len(ttft) - 1))] * 1e3,
        "prefix": states[0]["kv"]["prefix"],
        "ranks": [{"pid": st["pid"], "device": st["kv"].get("device"),
                   "arena_bytes": st["kv"]["arena_bytes"],
                   "cuda_memory_allocated":
                       st["kv"].get("cuda_memory_allocated"),
                   "pages_total": st["kv"]["pages_total"],
                   "width": st["kv"]["width"], "steps": st["steps"]}
                  for st in states],
        "after": [{"pages_in_use": st["kv"]["pages_in_use"],
                   "owners": st["kv"]["owners"],
                   "kv_leaked": st["kv_leaked"]} for st in states],
        "exact": exact}
    ok = (exact and all(st["kv"]["backend"] == "torch"
                        and st["kv"]["device"].startswith("cuda")
                        and st["kv"]["arena_bytes"] >= SERVE_ARENA_BYTES
                        for st in states)
          # only the retained sessions hold pages, none shared between
          # them, no leak, and every rank of a gang holds the same tables
          and all(set(a["owners"]) == sessions
                  and a["pages_in_use"] == sum(a["owners"].values())
                  and a["kv_leaked"] == [] for a in fields["after"])
          and all(a["owners"] == fields["after"][0]["owners"]
                  for a in fields["after"])
          and fields["prefix"]["hits"] > 0)
    return name, members, fields, ok


def _serve_kill(client, name, model, pids):
    """A follower of the gang killed mid-decode (serve.decode_step=exit
    armed in its process): every open stream ends in ReplicaGroupDied
    within the group timeout, the dead leader's engine holds no page, and
    a fresh stream on the restarted gang decodes exactly with no page
    left in use."""
    import threading

    import ray_tpu_torch
    from ray_tpu_torch import exceptions as exc

    old = _serve_members(client, name, 2)
    handle = client.get_handle(name)
    errors, started = [], threading.Barrier(SERVE_KILL_STREAMS + 1)

    def one(i):
        try:
            gen = handle.stream({"prompt": [i + 1] * 32, "max_tokens": 150},
                                timeout=120.0)
            next(gen)
            started.wait(60)
            for _ in gen:
                pass
            errors.append(None)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(SERVE_KILL_STREAMS)]
    for t in threads:
        t.start()
    started.wait(60)
    t_arm = time.perf_counter()
    ray_tpu_torch.get(old[1].arm_failpoint.remote(
        "serve.decode_step", "exit", nth=2), timeout=60)
    for t in threads:
        t.join(120)
    to_error_s = time.perf_counter() - t_arm
    dead = ray_tpu_torch.get(old[0].engine_state.remote(), timeout=60)
    deadline = time.monotonic() + 120
    while True:
        try:
            out = [tok for tok in handle.stream(
                {"prompt": [3, 5, 9], "max_tokens": 40}, timeout=30.0)]
            break
        except (exc.ReplicaGroupDied, exc.ActorDiedError,
                exc.ActorUnavailableError, exc.SequenceAborted,
                TimeoutError, RuntimeError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)
    restart_s = time.perf_counter() - t_arm
    fresh = _serve_members(client, name, 2)
    states = ray_tpu_torch.get([m.engine_state.remote() for m in fresh],
                               timeout=60)
    pids.update(st["pid"] for st in states)
    fields = {"streams": SERVE_KILL_STREAMS,
              "errors": sorted({type(e).__name__ for e in errors
                                if e is not None}),
              "unfinished": sum(e is None for e in errors),
              "arm_to_errors_s": to_error_s,
              "group_timeout_s": SERVE_GROUP_TIMEOUT_S,
              "dead_leader": {"dead": dead["dead"][:200],
                              "pages_in_use": dead["kv"]["pages_in_use"],
                              "kv_leaked": dead["kv_leaked"],
                              "owners": dead["kv"]["owners"]},
              "restart_to_exact_s": restart_s,
              "fresh_exact": out == model.generate([3, 5, 9], 40),
              "fresh_ranks": [{"pages_in_use": st["kv"]["pages_in_use"],
                               "kv_leaked": st["kv_leaked"]}
                              for st in states],
              "fresh_is_new": fresh[0] != old[0]}
    ok = (len(errors) == SERVE_KILL_STREAMS
          and all(isinstance(e, exc.ReplicaGroupDied) for e in errors)
          and to_error_s <= SERVE_GROUP_TIMEOUT_S + 2.0
          and "ReplicaGroupDied" in dead["dead"]
          and dead["kv"]["pages_in_use"] == 0 and not dead["kv_leaked"]
          and not dead["kv"]["owners"]
          and fields["fresh_exact"] and fields["fresh_is_new"]
          and all(r["pages_in_use"] == 0 and r["kv_leaked"] == []
                  for r in fields["fresh_ranks"]))
    return fields, ok


def _kv_write_ms(dev):
    """The torch arena's writes and read on the card at a num_shards=2
    rank's shape (SERVE_ARENA_BYTES, rows 512 f32): ms of one decode
    step's one-row append, of a 64-row prefill append and of one
    gather_sum, each a host wall time that ends with the card synced
    (medians of 200, 50 and 200)."""
    import numpy as np

    from ray_tpu_torch.serve.kv_cache import PagedKVCache

    width = SERVE_MODEL["inner"] // 2
    pages = SERVE_ARENA_BYTES // (SERVE_PAGE * width * 4)
    kv = PagedKVCache(pages, SERVE_PAGE, width, backend="torch")
    rows = np.ones((64, width), np.float32)

    def med(fn, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    try:
        kv.alloc_table("w")
        kv.append("w", rows[:1])
        torch.cuda.synchronize()
        one = med(lambda: kv.append("w", rows[0]), 200)
        kv.alloc_table("p")
        prefill = med(lambda: kv.append("p", rows), 50)
        read = med(lambda: kv.gather_sum("w"), 200)
        return {"arena_bytes": kv.nbytes, "device": str(kv._pages.device),
                "row_f32": width, "append_1_row_ms": one,
                "append_64_rows_ms": prefill, "gather_sum_ms": read,
                "gather_sum_rows": kv.length("w")}
    finally:
        kv.close()
        del kv
        torch.cuda.empty_cache()


def phase_serve(dev):
    """Serve on the card through the handle: the reference's
    ShardedTokenLM at SERVE_MODEL, its KV arena a tensor on the card
    (kv_backend="torch", SERVE_ARENA_BYTES a rank), num_shards=1 and then
    num_shards=2 (both members on this card), SERVE_STREAMS streams each;
    every stream equal to ShardedTokenLM.generate; then a follower killed
    mid-decode. Serve shuts down and its processes are gone, their cards
    free, before the next phase."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.engine import ShardedTokenLM

    model = ShardedTokenLM.make(SERVE_SEED, **SERVE_MODEL)
    reqs = _serve_traffic(np.random.default_rng(SERVE_SEED))
    t0 = time.perf_counter()
    want = [model.generate(r["prompt"], r["max_tokens"]) for r in reqs]
    reference_s = time.perf_counter() - t0
    fields = {"model": SERVE_MODEL, "reference_generate_s": reference_s,
              "kv_write": _kv_write_ms(dev)}
    pids, oks = set(), []
    client = serve.start()
    try:
        for shards in (1, 2):
            name, _, got, ok = _serve_deployment(client, shards, model,
                                                 reqs, want, pids)
            fields[f"shards_{shards}"] = got
            oks.append(ok)
            if shards == 2:
                fields["kill"], ok = _serve_kill(client, name, model, pids)
                oks.append(ok)
            client.delete_endpoint(name)
            client.delete_backend(name)
    finally:
        t0 = time.perf_counter()
        client.shutdown()
        want_gpus = ray_tpu_torch.cluster_resources().get("GPU", 0)
        deadline = time.monotonic() + 60
        while (ray_tpu_torch.available_resources().get("GPU", 0) < want_gpus
               or any(_running(p) for p in pids)):
            if time.monotonic() > deadline:
                fields["left_running"] = [p for p in pids if _running(p)]
                emit("serve", **fields)
                raise TimeoutError("serve's processes still hold the card "
                                   "60 s after its shutdown")
            time.sleep(0.2)
        fields["shutdown_s"] = time.perf_counter() - t0
    emit("serve", **fields)
    if not all(oks):
        raise RuntimeError(f"serve: {oks}: {fields}")


RL_STEP_TOL = 1e-5  # the card's gradients and step against the CPU's
RL_BAR = 60.0  # episode_reward_mean: the bar of the reference's own tests
RL_PPO_TRAINS = 8  # tests/test_rllib.py:68-89: > 60 after 8 train()s
RL_IMPALA_STEPS = 20  # tests/test_rllib_agents.py:142-166: within 20


def _rl_whoami(worker):
    """Run in a rollout actor: what it sees of the cards."""
    return {"pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda_available": torch.cuda.is_available(),
            "policy_device": str(worker.policy.device)}


def _rl_flat(weights):
    from ray_tpu_torch.rllib.policy.torch_policy import tree_leaves

    return torch.cat([torch.tensor(v).reshape(-1).double()
                      for v in tree_leaves(weights)])


def _rl_step_check():
    """PPO's learner on the card (TF32 off) against the CPU, from the same
    weights and the same batch (256 CartPole steps sampled on the CPU,
    GAE included): first compute_gradients, each leaf by relative L2,
    then one learn_on_batch: the weights after it, the update itself (w
    - w0: Adam's first step is about lr * sign(g), so a gradient of the
    wrong size but the right sign shows only in the gradients), the loss
    and its metrics."""
    import cloudpickle

    from ray_tpu_torch.rllib.agents.ppo import PPOPolicy
    from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker
    from ray_tpu_torch.rllib.policy.torch_policy import tree_leaves
    from ray_tpu_torch.rlbench import PPO_BENCH_CONFIG

    cfg = {**PPO_BENCH_CONFIG, "device": "cpu", "rollout_fragment_length": 256}
    worker = RolloutWorker("CartPole-v1", cloudpickle.dumps(PPOPolicy), cfg)
    try:
        batch = worker.sample()
    finally:
        worker.stop()
    env = worker.envs[0]
    cpu = PPOPolicy(env.observation_space, env.action_space, cfg)
    card = PPOPolicy(env.observation_space, env.action_space,
                     {**cfg, "device": "cuda"})
    before = cpu.get_weights()
    card.set_weights(before)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (want_g, _), (got_g, _) = (p.compute_gradients(batch)
                                   for p in (cpu, card))
        want_info = cpu.learn_on_batch(batch)
        got_info = card.learn_on_batch(batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    grad_errs = [_rel_l2(torch.tensor(g), torch.tensor(w)) for g, w in
                 zip(tree_leaves(got_g), tree_leaves(want_g), strict=True)]
    w0, want, got = (_rl_flat(w) for w in (before, cpu.get_weights(),
                                            card.get_weights()))
    weights_err = _rel_l2(got, want)
    update_err = _rel_l2(got - w0, want - w0)
    # the loss and each of its terms, against the loss's size: PPO's
    # policy term is about 0 at its first step (the ratio is 1 and the
    # advantages are normalised), so its own relative error means nothing
    scale = abs(want_info["total_loss"])
    info_err = max(abs(got_info[k] - v) / scale for k, v in want_info.items())
    return {"rows": batch.count, "grad_rel_l2_by_leaf": grad_errs,
            "weights_rel_l2": weights_err, "update_rel_l2": update_err,
            "info_rel_err": info_err, "info_card": got_info,
            "info_cpu": want_info, "tol": RL_STEP_TOL,
            "policy_device": str(card.device)}, (
        max(grad_errs) <= RL_STEP_TOL and weights_err <= RL_STEP_TOL
        and update_err <= RL_STEP_TOL and info_err <= RL_STEP_TOL
        and card.device.type == "cuda")


def _rl_actors(trainer):
    """Each rollout actor: no card seen, its policy on the CPU."""
    import ray_tpu_torch

    who = ray_tpu_torch.get([w.apply.remote(_rl_whoami)
                             for w in trainer.workers.remote_workers],
                            timeout=120)
    ok = (len(who) == trainer.config["num_workers"]
          and len({w["pid"] for w in who} | {os.getpid()}) == len(who) + 1
          and all(w["cuda_visible_devices"] == "" and not w["cuda_available"]
                  and w["policy_device"] == "cpu" for w in who))
    return who, ok


def _rl_ppo(trainer, base_mem):
    """PPO at rlbench's configuration, the learner on the card: 8
    train()s, the rates over the 7 after the first (rlbench.measure); the
    actors' weights against the learner's after the last broadcast."""
    import ray_tpu_torch
    from ray_tpu_torch.rlbench import measure

    t0 = time.perf_counter()
    first = trainer.train()  # the learner's first launches
    first_s = time.perf_counter() - t0
    window, rows = measure(trainer, trains=RL_PPO_TRAINS - 1)
    rewards = [m["episode_reward_mean"] for m in [first] + rows]
    learner = trainer.get_policy()
    want = _rl_flat(learner.get_weights())
    synced = all(torch.equal(_rl_flat(w), want) for w in ray_tpu_torch.get(
        [w.get_weights.remote() for w in trainer.workers.remote_workers],
        timeout=120))
    who, actors_ok = _rl_actors(trainer)
    fields = {
        "reward_means": rewards, "first_train_s": first_s,
        "env_steps_per_s_first": first["num_env_steps_trained"] / first_s,
        **window,
        "learner_device": str(learner.device),
        "learner_memory_allocated": torch.cuda.memory_allocated() - base_mem,
        "actors": who, "actors_synced": synced}
    ok = (rewards[-1] > RL_BAR and synced and actors_ok
          and learner.device.type == "cuda")
    return fields, ok


def _rl_impala(trainer, base_mem):
    """IMPALA at rlbench's configuration, the LearnerThread on the card:
    RL_IMPALA_STEPS train()s, the best episode_reward_mean among them
    past RL_BAR; the rates over the calls after the first
    (rlbench.measure)."""
    from ray_tpu_torch.rlbench import measure

    first = trainer.train()  # the actors' first fragments, first launches
    window, rows = measure(trainer, trains=RL_IMPALA_STEPS - 1)
    rewards = [m["episode_reward_mean"] for m in [first] + rows]
    best = max((r for r in rewards if r == r), default=0.0)
    who, actors_ok = _rl_actors(trainer)
    device = trainer.get_policy().device
    fields = {
        "reward_means": rewards, "best": best, **window,
        "env_steps_sampled": trainer._sampled,
        "env_steps_trained": trainer._learner.num_steps_trained,
        "learner_device": str(device),
        "learner_memory_allocated": torch.cuda.memory_allocated() - base_mem,
        "actors": who}
    return fields, best > RL_BAR and actors_ok and device.type == "cuda"


def phase_rllib(dev, smi):
    """RLlib's on-policy path (needs the runtime): the learner's step on
    the card against the CPU's, then PPO and IMPALA at rlbench's
    configuration through their trainers, the learner on the card and
    two CPU rollout actors each."""
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    from ray_tpu_torch.rllib.agents.impala import ImpalaTrainer
    from ray_tpu_torch.rllib.agents.ppo import PPOTrainer
    from ray_tpu_torch.rlbench import IMPALA_BENCH_CONFIG, PPO_BENCH_CONFIG

    fields = {"nvidia_smi": smi, "ppo_config": PPO_BENCH_CONFIG,
              "impala_config": IMPALA_BENCH_CONFIG}
    with contextlib.ExitStack() as trainers:
        # both trainers first: their four actors start at once (IMPALA's
        # each sample one fragment, then wait for its train())
        t0 = time.perf_counter()
        ppo = PPOTrainer(config={**PPO_BENCH_CONFIG, "device": "cuda"})
        trainers.callback(ppo.cleanup)
        impala = ImpalaTrainer(config={**IMPALA_BENCH_CONFIG,
                                       "device": "cuda"})
        trainers.callback(impala.cleanup)
        fields["trainers_s"] = time.perf_counter() - t0
        fields["step"], step_ok = _rl_step_check()
        fields["ppo"], ppo_ok = _rl_ppo(ppo, base_mem)
        fields["impala"], impala_ok = _rl_impala(impala, base_mem)
    fields["learner_peak_memory"] = (torch.cuda.max_memory_allocated()
                                     - base_mem)
    fields["kernel_launches"] = local_counts()  # the RL path has none
    emit("rllib", **fields)
    if not (step_ok and ppo_ok and impala_ok):
        raise RuntimeError(f"rllib: step {step_ok}, ppo {ppo_ok}, impala "
                           f"{impala_ok}: {fields}")


KERNELS = {  # name: (source, the TPU kernel it replaces)
    "bn_bwd_sums": ("ray_tpu_torch/ops/csrc/bn_bwd_sums.cu",
                    "ray_tpu/ops/batchnorm.py:43"),
    "layernorm": ("ray_tpu_torch/ops/csrc/layernorm.cu",
                  "ray_tpu/ops/layernorm.py:18"),
    "rmsnorm": ("ray_tpu_torch/ops/csrc/layernorm.cu",
                "ray_tpu/ops/layernorm.py:26"),
    "flash_attn_fwd": ("ray_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                       "ray_tpu/ops/attention.py:24"),
    "ring_allreduce": ("ray_tpu_torch/ops/csrc/ring_collectives.cu",
                       "ray_tpu/collective/backends/pallas_backend.py:143"),
    "ring_reducescatter": ("ray_tpu_torch/ops/csrc/ring_collectives.cu",
                           "ray_tpu/collective/backends/pallas_backend.py"
                           ":183"),
    "ring_allgather": ("ray_tpu_torch/ops/csrc/ring_collectives.cu",
                       "ray_tpu/collective/backends/pallas_backend.py:206"),
    "quantized_allreduce": ("ray_tpu_torch/ops/csrc/ring_collectives.cu",
                         "ray_tpu/collective/backends/pallas_backend.py:227"),
}


# the phases that need the runtime (phase_runtime starts it)
RUNTIME_PHASES = ("runtime", "collectives_procs", "train", "train_ingest",
                  "train_gpt2", "train_vit", "train_bert", "parallel",
                  "train_moe", "serve", "rllib", "train_gpt2_dp",
                  "train_gpt2_mesh", "train_gpt2_elastic")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--only", help="comma-separated phases to run after "
                        "device and build (no result line)")
    only = parser.parse_args().only
    phases = None if only is None else set(only.split(","))

    def run(name):
        return phases is None or name in phases

    import ray_tpu_torch  # noqa: F401  (fails outside a checkout)

    import ray_tpu_torch

    dev = torch.device("cuda", 0)
    started = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        """fn(*args), its seconds kept under name (printed at the end)."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    smi = timed("device", phase_device)
    timed("build", phase_build)
    summary = collections.defaultdict(dict)
    launches = collections.Counter()

    def add_launches(counts):
        """A main path's launches, added to the kernels line's."""
        launches.update({k: v for k, v in counts.items() if k in KERNELS})
    if run("kernels"):
        summary["bn_bwd_sums"] = timed("kernels", phase_kernels, dev)
        summary.update(timed("transformer_kernels",
                             phase_transformer_kernels, dev))
    if run("collectives"):
        summary.update(timed("collectives", phase_collectives, dev))
    if run("resnet50_step"):
        timed("resnet50_step", phase_resnet50_step, dev)
    if run("gpt2_step"):
        timed("gpt2_step", phase_gpt2_step, dev)
    torch.cuda.empty_cache()
    try:
        if any(run(p) for p in RUNTIME_PHASES):
            timed("runtime", phase_runtime, dev, smi)
        if run("collectives_procs"):
            # B5-B8 as the main path runs them: a rank a process
            for name, row in timed("collectives_procs",
                                   phase_collectives_procs, dev).items():
                summary[name].update(row)
        if run("train"):
            add_launches({"bn_bwd_sums": timed("train", phase_train, dev)})
        if run("train_ingest"):
            timed("train_ingest", phase_train_ingest, dev)
        if run("train_gpt2"):
            add_launches(timed("train_gpt2", phase_train_gpt2, dev))
        for name in ("vit", "bert"):
            if run(f"train_{name}"):
                add_launches(timed(f"train_{name}", phase_train_family,
                                   name, dev))
        if run("parallel"):
            timed("parallel", phase_parallel, dev)
        if run("train_moe"):
            add_launches(timed("train_moe", phase_train_moe, dev))
        if _PAR_RANKS:
            timed("release_par_ranks", release_par_ranks)
        if run("serve"):
            timed("serve", phase_serve, dev)
        if run("rllib"):
            timed("rllib", phase_rllib, dev, smi)
        if run("train_gpt2_dp"):
            add_launches(timed("train_gpt2_dp", phase_train_gpt2_dp, dev))
        if run("train_gpt2_mesh"):
            timed("train_gpt2_mesh", phase_train_gpt2_mesh, dev)
        if run("train_gpt2_elastic"):
            timed("train_gpt2_elastic", phase_train_gpt2_elastic, dev, smi)
    finally:
        ray_tpu_torch.shutdown()
    emit("phase_seconds", total=time.perf_counter() - started, **seconds)
    print(smi)
    if phases is not None:
        return 0
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        **{k: summary[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
        **({"basis": summary[name]["basis"]} if "basis" in summary[name]
           else {})}
        for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
