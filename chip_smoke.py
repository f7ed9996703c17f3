#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port, ray_tpu_torch, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds every kernel under ray_tpu_torch/ops/csrc/ with nvcc, holds each
against its plain PyTorch version at the shapes of the main path, and
drives the main path: ResNet-50 training through
`ray_tpu_torch.train.Trainer` at batch 256, 224², bf16, with the
batchnorm backward sums in the hand-written kernel. Each phase prints
one JSON line:

1. device: nvidia-smi's name and power limit, torch, CUDA and nvcc.
2. build: nvcc of every source, one process each, all started together.
3. kernels: bn_bwd_sums against bn_bwd_sums_plain at each of ResNet-50's
   batchnorm shapes (taken from a forward pass of the model) and one
   ragged shape: error, bit-identity of two runs, and times (CUDA events,
   median of 25, L2 flushed before each) beside the bound and the
   library call that computes the same sums (timed as a yardstick only).
4. resnet50_step: one step of bn_mode="kernel" against "plain" from the
   same weights and batch: float32 (TF32 off) at batch 32, and bf16 at
   batch 64.
5. train: the main path, with the raw-loop control and the launch count.
Then the card's name and power limit, the kernels summary line and, last,
{"ok": true, "device": {...}}. A failed phase raises: the script exits
non-zero and prints no result. Without CUDA it exits 2 at once.
"""

import collections
import json
import math
import statistics
import subprocess
import sys
import time

import torch

# Peak rates of an H100 SXM for the bounds (NVIDIA data sheet, at its
# 700 W limit): memory bytes/s, float32 operations/s outside the tensor
# cores. The card's name and limit print beside every result.
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67.0e12

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


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def phase_build():
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(logs),
         build_dir=str(_build.BUILD_DIR), ptxas=ptxas)


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
    flush = torch.empty(32 << 20, device=dev)  # 128 MB > 50 MB of L2
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


def phase_train(dev):
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.ops import batchnorm as bn
    from ray_tpu_torch.train import Trainer

    torch.backends.cudnn.benchmark = True
    trainer = Trainer(_operator_cls(), num_workers=1,
                      config={"steps": STEPS},
                      resources_per_worker={"GPU": 1})
    n_bn = resnet.num_bn_layers(trainer.workers[0].operator.model)
    trainer.train(num_steps=WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bn.LAUNCHES = 0
    bn.RELAYOUTS = 0
    result = trainer.train(num_steps=STEPS)
    launches, relayouts = bn.LAUNCHES, bn.RELAYOUTS
    peak = torch.cuda.max_memory_allocated()
    trainer.shutdown()
    del trainer
    torch.cuda.empty_cache()
    raw_img_s, raw_losses = _raw_img_s(dev)
    img_s = result["samples_per_s"]
    fields = {"img_s": img_s, "raw_img_s": raw_img_s,
              "framework_fraction": img_s / raw_img_s, "batch": BATCH,
              "steps": STEPS, "last_train_loss": result["last_train_loss"],
              "train_loss": result["train_loss"],
              "raw_last_loss": raw_losses[-1],
              "max_memory_allocated": peak, "bn_layers": n_bn,
              "bn_bwd_sums_launches": launches,
              "dy_relayouts_per_step": relayouts / STEPS}
    emit("train", **fields)
    finite = all(math.isfinite(v) for v in (result["train_loss"],
                                            result["last_train_loss"]))
    if launches != n_bn * STEPS or n_bn != 53 or not finite:
        raise RuntimeError(f"train: {launches} launches for {STEPS} steps "
                           f"of {n_bn} batchnorm layers, loss finite "
                           f"{finite}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    import ray_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    summary = phase_kernels(dev)
    phase_resnet50_step(dev)
    launches = phase_train(dev)
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "bn_bwd_sums", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/bn_bwd_sums.cu",
        "replaces": "ray_tpu/ops/batchnorm.py:43",
        "launches": launches, "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"], "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"], "bound_by": summary["bound_by"],
        "library_ms": summary["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
