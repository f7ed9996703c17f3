"""Training-mode batchnorm whose backward reductions run in a CUDA kernel.

Port of ray_tpu/ops/batchnorm.py. The kernel, `csrc/bn_bwd_sums.cu`,
replaces the TPU kernel `ray_tpu/ops/batchnorm.py::_sums_kernel`: per
channel, Σdy and Σdy·x̂ (x̂ = (x − mean)·inv) from one read of x and dy,
accumulated in f32. It is bound by bytes (one read of x and dy); its design
answers that with 16-byte loads coalesced along C and a two-stage split of
M that fills the card even at C = 64 (see the source's header).

`bn_bwd_sums` launches the kernel for CUDA tensors and raises on what it
does not take; CPU tensors go to `bn_bwd_sums_plain`. There is no other
path. The dx map after the sums stays plain PyTorch elementwise code, as
the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

# Launches of the CUDA kernel; the wrapper adds one per launch and nowhere
# else, so a run can show that its path went through the kernel.
LAUNCHES = 0
# Contiguous copies BNTrain made of an x or dy it was handed in another
# layout (for example a dy that is not channels-last). Each is one extra
# read and write of the tensor.
RELAYOUTS = 0

_THREADS = 256          # threads per block (csrc: kThreads)
_TARGET_BLOCKS = 1056   # 132 SMs x 8 resident blocks of 256 threads
_MIN_ROW_STEPS = 4      # rows each thread walks, at least, in a slab


def bn_bwd_sums_plain(x2: torch.Tensor, dy2: torch.Tensor,
                      mean: torch.Tensor, inv: torch.Tensor):
    """x2, dy2: [M, C]; mean, inv: [C] f32 -> (Σdy, Σdy·x̂), two [C] f32."""
    xf = x2.float()
    dyf = dy2.float()
    xhat = (xf - mean) * inv
    return dyf.sum(0), (dyf * xhat).sum(0)


def _launch_geometry(m: int, c: int, elem_bytes: int, aligned: bool):
    """(vec, tx, n_ctiles, n_slabs, rows_per_slab) for the kernel.

    vec channels per thread make one 16-byte load when C allows it; tx
    threads (a power of two, at most a warp) cover a channel tile and the
    rest of the block's 256 threads walk rows. Slabs split M so that the
    grid holds about _TARGET_BLOCKS blocks, but no slab is so short that a
    thread walks fewer than _MIN_ROW_STEPS rows."""
    vec = 16 // elem_bytes
    if not aligned or c % vec:
        vec = 1
    packs = c // vec
    tx = 1
    while tx < packs and tx < 32:
        tx *= 2
    ty = _THREADS // tx
    n_ctiles = -(-packs // tx)
    n_slabs = max(1, min(-(-_TARGET_BLOCKS // n_ctiles),
                         -(-m // (ty * _MIN_ROW_STEPS))))
    rows_per_slab = -(-m // n_slabs)
    n_slabs = -(-m // rows_per_slab)
    return vec, tx, n_ctiles, n_slabs, rows_per_slab


def _kernel():
    lib = _build.load("bn_bwd_sums")
    fn = lib.bn_bwd_sums_launch
    if fn.argtypes is None:  # first use: declare the C signature
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.bn_bwd_sums_error_string.argtypes = [ctypes.c_int]
        lib.bn_bwd_sums_error_string.restype = ctypes.c_char_p
    return lib


def bn_bwd_sums(x2: torch.Tensor, dy2: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor):
    """(Σdy, Σdy·x̂) over rows of [M, C] x2 and dy2, as two [C] f32.

    CPU tensors take the plain version. CUDA tensors launch the kernel:
    x2 and dy2 contiguous, both bf16 or both f32; mean and inv contiguous
    [C] f32; all on one device. Anything else raises."""
    global LAUNCHES
    if x2.device.type == "cpu":
        return bn_bwd_sums_plain(x2, dy2, mean, inv)
    if x2.device.type != "cuda":
        raise ValueError(f"bn_bwd_sums: unsupported device {x2.device}")
    if x2.dim() != 2 or dy2.shape != x2.shape:
        raise ValueError(f"bn_bwd_sums: x2 {tuple(x2.shape)} and dy2 "
                         f"{tuple(dy2.shape)} must be one [M, C] shape")
    m, c = x2.shape
    if m == 0 or c == 0:
        raise ValueError(f"bn_bwd_sums: empty input {tuple(x2.shape)}")
    if x2.dtype not in (torch.bfloat16, torch.float32) or dy2.dtype != x2.dtype:
        raise TypeError(f"bn_bwd_sums: x2 {x2.dtype} and dy2 {dy2.dtype} "
                        "must both be bfloat16 or both float32")
    for name, v in (("mean", mean), ("inv", inv)):
        if v.dtype != torch.float32 or v.shape != (c,):
            raise ValueError(f"bn_bwd_sums: {name} must be [{c}] float32, "
                             f"got {tuple(v.shape)} {v.dtype}")
    tensors = (x2, dy2, mean, inv)
    if any(t.device != x2.device for t in tensors):
        raise ValueError("bn_bwd_sums: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bn_bwd_sums: inputs must be contiguous")

    elem = x2.element_size()
    aligned = x2.data_ptr() % 16 == 0 and dy2.data_ptr() % 16 == 0
    vec, tx, n_ctiles, n_slabs, rows = _launch_geometry(m, c, elem, aligned)
    part = torch.empty((2, n_slabs, c), dtype=torch.float32,
                       device=x2.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    lib = _kernel()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.bn_bwd_sums_launch(
            x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), m, c, int(x2.dtype == torch.bfloat16), vec,
            tx, n_ctiles, n_slabs, rows, stream)
    if rc != 0:
        msg = lib.bn_bwd_sums_error_string(rc).decode()
        raise RuntimeError(f"bn_bwd_sums launch failed: {msg} (M={m}, "
                           f"C={c}, vec={vec}, tx={tx}, grid={n_ctiles}x"
                           f"{n_slabs})")
    LAUNCHES += 1
    return out[0], out[1]


def batch_stats(x2: torch.Tensor):
    """Training statistics of [M, C] rows in f32: (mean, var), var one-pass
    E[x²]−E[x]² clamped at 0, as ray_tpu/ops/batchnorm.py computes them.

    Σx reduces the input dtype in f32 without an f32 copy; Σx² squares an
    f32 copy in place (one copy of the activation, freed at return)."""
    m = x2.shape[0]
    mean = torch.sum(x2, 0, dtype=torch.float32) / m
    sq = torch.sum(x2.to(torch.float32, copy=True).square_(), 0) / m
    var = torch.clamp_min(sq - torch.square(mean), 0.0)
    return mean, var


def normalize(x: torch.Tensor, mean, var, scale, bias, eps: float):
    """y = x·a + offset over the last dim, with a = rsqrt(var+eps)·scale and
    offset = bias − mean·a formed in f32 and cast to x.dtype first."""
    a = torch.rsqrt(var + eps) * scale
    offset = bias - mean * a
    return x * a.to(x.dtype) + offset.to(x.dtype)


class BNTrain(torch.autograd.Function):
    """Training batchnorm over all dims but the last (C). Forward as
    ray_tpu's `_bn_fwd_math`; backward through `bn_bwd_sums`."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        global RELAYOUTS
        if not x.is_contiguous():
            x = x.contiguous()
            RELAYOUTS += 1
        c = x.shape[-1]
        mean, var = batch_stats(x.reshape(-1, c))
        y = normalize(x, mean, var, scale, bias, eps)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, mean, inv, scale)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _g_mean, _g_var):
        global RELAYOUTS
        x, mean, inv, scale = ctx.saved_tensors
        if not dy.is_contiguous():
            # the caller's grad came in another layout (a conv backward can
            # hand one over); the kernel reads [M, C] rows, so copy once
            dy = dy.contiguous()
            RELAYOUTS += 1
        c = x.shape[-1]
        m = x.numel() // c
        sdy, sdyx = bn_bwd_sums(x.reshape(m, c), dy.reshape(m, c), mean, inv)
        # dx = inv·scale · (dy − Σdy/M − x̂·Σ(dy·x̂)/M): a plain map in
        # x.dtype, with every per-channel factor cast to it first
        dt = x.dtype
        a = (inv * scale).to(dt)
        k1 = (sdy / m).to(dt)
        k2 = (sdyx / m * inv).to(dt)
        mu = mean.to(dt)
        dx = a * (dy - k1 - (x - mu) * k2)
        return dx, sdyx, sdy, None


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-5):
    """x [..., C] (C last, any float dtype), scale/bias [C] f32 ->
    (y [..., C] in x.dtype, mean [C] f32, var [C] f32).

    mean and var carry no gradient: they feed the running statistics."""
    return BNTrain.apply(x, scale, bias, eps)
