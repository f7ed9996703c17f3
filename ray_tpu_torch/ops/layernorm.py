"""LayerNorm and RMSNorm whose forwards run in CUDA kernels.

Port of ray_tpu/ops/layernorm.py. The kernels, both in
`csrc/layernorm.cu`, replace the TPU kernels
`ray_tpu/ops/layernorm.py::_layernorm_kernel` and `::_rmsnorm_kernel`:
per row of [N, D], in f32, the mean and the two-pass variance
E[(x − mean)²] (or the mean of x²), rsqrt, the affine map with the weight
and bias in their own dtype promoted to f32, and one cast to x.dtype at
the store. They are bound by bytes (one read and one write of x); the
design, one warp per row with the row held in registers, is in the
source's header.

`layernorm_fwd` and `rmsnorm_fwd` launch the kernels for CUDA tensors and
raise on what they do not take; CPU tensors go to `layernorm_plain` and
`rmsnorm_plain`. There is no other path. The backwards are the
reference's analytic formulas in plain PyTorch (`_layernorm_bwd`,
`_rmsnorm_bwd` there), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

# Launches of each CUDA kernel; the wrappers add one per launch and
# nowhere else, so a run can show that its path went through the kernels.
LAYERNORM_LAUNCHES = 0
RMSNORM_LAUNCHES = 0

_ROWS_PER_BLOCK = 4  # one warp per row (csrc: kWarps)


def layernorm_plain(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's forward: f32 mean, two-pass variance, rsqrt,
    y·w + b with w and b promoted from their dtype, cast to x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """The reference's forward: f32 mean of x², x·rsqrt(ms + eps)·w, cast
    to x.dtype."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * weight).to(x.dtype)


def _kernel():
    lib = _build.load("layernorm")
    if lib.layernorm_launch.argtypes is None:  # first use: C signatures
        for fn in (lib.layernorm_launch, lib.rmsnorm_launch):
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_float, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.layernorm_error_string.argtypes = [ctypes.c_int]
        lib.layernorm_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None, eps: float) -> torch.Tensor:
    """Checks the inputs and launches `<name>_launch` over x's rows."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be bfloat16 or float32, "
                        f"got {x.dtype}")
    if x.dim() == 0 or x.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    d = x.shape[-1]
    params = (weight,) if bias is None else (weight, bias)
    for p in params:
        if p.shape != (d,) or p.dtype != x.dtype:
            raise ValueError(f"{name}: weight and bias must be [{d}] "
                             f"{x.dtype} (the caller casts them), got "
                             f"{tuple(p.shape)} {p.dtype}")
        if p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name}: weight and bias must be contiguous "
                             f"on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    n = x.numel() // d
    out = torch.empty_like(x)
    vec = 16 // x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out, *params))
    packs = d // vec if aligned and d % vec == 0 else 0
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            x.data_ptr(), weight.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(), n, d,
            eps, int(x.dtype == torch.bfloat16), packs, stream)
    if rc != 0:
        msg = lib.layernorm_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (N={n}, D={d}, "
                           f"{x.dtype}, packs={packs})")
    return out


def layernorm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm forward over the last dim. CPU tensors take the plain
    version. CUDA tensors launch the kernel: x contiguous, bf16 or f32;
    weight and bias contiguous [D] in x.dtype. Anything else raises."""
    global LAYERNORM_LAUNCHES
    if x.device.type == "cpu":
        return layernorm_plain(x, weight, bias, eps)
    out = _launch("layernorm", x, weight, bias, eps)
    LAYERNORM_LAUNCHES += 1
    return out


def rmsnorm_fwd(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm forward over the last dim; takes what layernorm_fwd takes."""
    global RMSNORM_LAUNCHES
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    out = _launch("rmsnorm", x, weight, None, eps)
    RMSNORM_LAUNCHES += 1
    return out


def _layernorm_bwd(x, weight, g, eps):
    """ray_tpu/ops/layernorm.py::_layernorm_bwd, in f32."""
    xf, gf = x.float(), g.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    gw = gf * weight.float()
    dx = inv * (gw - gw.mean(-1, keepdim=True)
                - xhat * (gw * xhat).mean(-1, keepdim=True))
    red = tuple(range(x.dim() - 1))
    dw = (gf * xhat).sum(red)
    db = gf.sum(red)
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def _rmsnorm_bwd(x, weight, g, eps):
    """ray_tpu/ops/layernorm.py::_rmsnorm_bwd, in f32."""
    xf, gf = x.float(), g.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    inv = torch.rsqrt(ms + eps)
    gw = gf * weight.float()
    d = x.shape[-1]
    dx = inv * gw - xf * (inv ** 3) * (gw * xf).sum(-1, keepdim=True) / d
    red = tuple(range(x.dim() - 1))
    dw = (gf * xf * inv).sum(red)
    return dx.to(x.dtype), dw.to(weight.dtype)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, fwd):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return (*_layernorm_bwd(x, weight, g, ctx.eps), None, None)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps, fwd):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return (*_rmsnorm_bwd(x, weight, g, ctx.eps), None, None)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5, fwd=None) -> torch.Tensor:
    """x [..., D], weight and bias [D] -> [..., D] in x.dtype, with the
    reference's analytic backward. fwd is the forward to run:
    `layernorm_fwd` (the kernel's wrapper) by default; `layernorm_plain`
    holds the kernel against its plain version under the same backward."""
    return _LayerNorm.apply(x, weight, bias, eps, fwd or layernorm_fwd)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            fwd=None) -> torch.Tensor:
    """x [..., D], weight [D] -> [..., D] in x.dtype; fwd as for
    `layernorm` (`rmsnorm_fwd` by default, or `rmsnorm_plain`)."""
    return _RMSNorm.apply(x, weight, eps, fwd or rmsnorm_fwd)
