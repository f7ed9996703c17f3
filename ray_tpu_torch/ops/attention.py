"""Flash attention whose forward runs in a CUDA kernel.

Port of ray_tpu/ops/attention.py. The kernel, `csrc/flash_attn_fwd.cu`,
replaces the TPU kernel `ray_tpu/ops/attention.py::_flash_kernel`: for
q, k, v [B, T, H, D], K and V in blocks, an online softmax with f32
running max, denominator and accumulator, the causal scan stopping at the
last block a query tile can see, NEG_INF = −1e30 for masked scores, p cast
to v's dtype before the p·V product, and o / l with an l > 0 guard. It
reads q, k and v through their strides (in bf16 by TMA, through tensor
maps over those strides), so views into one qkv tensor need no copy (the
reference transposes to [B·H, T, D] first). It sits at the ridge of the
roofline at GPT-2's shape; the source's header has the design.

`flash_attention_fwd` launches the kernel for CUDA tensors and raises on
what it does not take; CPU tensors go to `flash_attention_plain`, the
kernel's arithmetic in PyTorch. Shapes the reference keeps off its kernel
(`_flash_aligned`) take the dense route instead, counted in
DENSE_ROUTES. The backward is the reference's blockwise recompute
(`_bwd`): dense attention per Q block against the full K and V, dk and dv
summed in f32. It is plain framework code in JAX and plain PyTorch here;
its dense matmuls run in float32 on the exact f32 images of the inputs,
which is what the reference's f32-accumulated einsums compute.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

# Launches of the CUDA kernel; the wrapper adds one per launch and nowhere
# else, so a run can show that its path went through the kernel.
LAUNCHES = 0
# Forward calls routed to dense attention because their shape is not
# aligned for the flash route (`_flash_aligned`).
DENSE_ROUTES = 0

# The kernel's instances (csrc: kHeadDimBf16, kBlockK), those that
# chip_smoke.py holds against the plain version on the card.
_BF16_HEAD_DIM = 64
_BLOCK_K = 128
_F32_MAX_HEAD_DIM = 128


def _flash_aligned(t: int, d: int, block_q: int, block_k: int) -> bool:
    """The reference's condition for its flash route; other shapes take
    the dense route."""
    block_q = min(block_q, t)
    block_k = min(block_k, t)
    return (t % block_q == 0 and t % block_k == 0
            and block_q % 8 == 0 and block_k % 8 == 0 and d % 8 == 0)


def _dense_attention(q, k, v, causal, scale, q_offset=0, pad_mask=None):
    """Dense attention in f32 on [B, T, H, D]: the reference's route for
    unaligned shapes and its blockwise backward. q_offset shifts the causal
    mask; pad_mask [B, Tk] bool, True = real token. No cast of p before
    p·V (the reference's einsum promotes v to f32), one cast at the end."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qpos = q_offset + torch.arange(tq, device=q.device)
        mask = qpos[:, None] >= torch.arange(tk, device=q.device)[None, :]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    if pad_mask is not None:
        scores = torch.where(pad_mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def masked_attention(q, k, v, pad_mask, causal=False, scale=None):
    """Attention with a key padding mask (BERT-style batches). pad_mask:
    [B, T] bool. Dense, as the reference: padded batches are short."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _dense_attention(q, k, v, causal, scale, pad_mask=pad_mask)


def flash_attention_plain(q, k, v, causal, scale, block_q, block_k):
    """The kernel's arithmetic in PyTorch, block by block as the reference
    kernel: q, k, v [B, T, H, D] with T a multiple of both blocks."""
    b, t, h, d = q.shape
    bq, bk = min(block_q, t), min(block_k, t)
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))  # [B, H, T, D]
    num_k = t // bk
    out = torch.empty_like(qh)
    for qi in range(t // bq):
        qb = qh[:, :, qi * bq:(qi + 1) * bq].float()
        o = torch.zeros((b, h, bq, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, bq), dtype=torch.float32, device=q.device)
        n_active = num_k
        if causal:
            n_active = min(num_k, (qi + 1) * bq // bk + (bq % bk != 0))
        q_pos = qi * bq + torch.arange(bq, device=q.device)[:, None]
        for ki in range(n_active):
            kb = kh[:, :, ki * bk:(ki + 1) * bk]
            vb = vh[:, :, ki * bk:(ki + 1) * bk]
            s = (qb @ kb.float().transpose(-1, -2)) * scale
            if causal:
                k_pos = ki * bk + torch.arange(bk, device=q.device)[None, :]
                s = torch.where(q_pos >= k_pos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = p.to(v.dtype).float() @ vb.float()
            o = o * corr[..., None] + pv
            m = m_new
        denom = torch.where(l > 0, l, 1.0)
        out[:, :, qi * bq:(qi + 1) * bq] = (o / denom[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3)


def _kernel():
    lib = _build.load("flash_attn_fwd")
    fn = lib.flash_attn_fwd_launch
    if fn.argtypes is None:  # first use: declare the C signature
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attn_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_fwd_error_string.restype = ctypes.c_char_p
    return lib


def check_kernel_args(shapes, dtypes, strides, ptrs, block_k, scale):
    """Raises on what the CUDA kernel does not take. A pure function of the
    shapes, dtypes, element strides and data pointers of q, k, v (in that
    order), the key block and the scale: one [B, T, H, D] shape and one
    dtype, the last dim contiguous; min(block_k, T) = 128 and dividing T;
    bf16 with D = 64 and a positive scale, q, k and v 16-byte aligned with
    every stride a multiple of 16 bytes (the conditions of the TMA loads);
    or f32 with D <= 128."""
    shape = tuple(shapes[0])
    if len(shape) != 4 or any(tuple(x) != shape for x in shapes):
        raise ValueError(f"flash_attention: q, k, v shapes "
                         f"{[tuple(x) for x in shapes]} must be one "
                         "[B, T, H, D] shape")
    if dtypes[0] not in (torch.bfloat16, torch.float32) or \
            any(x != dtypes[0] for x in dtypes):
        raise TypeError(f"flash_attention: q, k, v must all be bfloat16 or "
                        f"all float32, got {list(dtypes)}")
    b, t, h, d = shape
    if b * t * h * d == 0:
        raise ValueError(f"flash_attention: empty input {shape}")
    bk = min(block_k, t)
    if bk != _BLOCK_K or t % bk:
        raise ValueError(f"flash_attention: block_k {bk} must be {_BLOCK_K} "
                         f"and divide T = {t}")
    if d > 1 and any(st[3] != 1 for st in strides):
        raise ValueError("flash_attention: the last dim of q, k, v must be "
                         "contiguous")
    if dtypes[0] == torch.float32:
        if d > _F32_MAX_HEAD_DIM:
            raise ValueError(f"flash_attention: f32 head dim {d} must be at "
                             f"most {_F32_MAX_HEAD_DIM}")
        return
    if d != _BF16_HEAD_DIM:
        raise ValueError(f"flash_attention: bf16 head dim {d} must be "
                         f"{_BF16_HEAD_DIM}")
    if not scale > 0:
        raise ValueError(f"flash_attention: bf16 scale {scale} must be "
                         "positive")
    if any(p % 16 for p in ptrs):
        raise ValueError("flash_attention: bf16 q, k, v must start 16-byte "
                         "aligned (TMA)")
    if any(x * 2 % 16 for st in strides for x in st[:3]):
        raise ValueError("flash_attention: bf16 strides of q, k, v must be "
                         "multiples of 16 bytes (TMA)")


def flash_attention_fwd(q, k, v, causal, scale, block_q, block_k):
    """The flash forward on [B, T, H, D]. CPU tensors take the plain
    version. CUDA tensors launch the kernel, on one device and within
    `check_kernel_args`; anything else raises. block_q is the reference's
    Q tiling; it does not change the result, and the kernel tiles Q its
    own way."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, block_q,
                                     block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one device")
    qkv = (q, k, v)
    check_kernel_args([x.shape for x in qkv], [x.dtype for x in qkv],
                      [x.stride() for x in qkv],
                      [x.data_ptr() for x in qkv], block_k, scale)
    b, t, h, d = q.shape
    bk = min(block_k, t)
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    strides = [s for x in (*qkv, out) for s in x.stride()[:3]]
    lib = _kernel()
    st = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t,
            h, d, st, scale, int(causal), bk, int(bf16), stream)
    if rc != 0:
        msg = lib.flash_attn_fwd_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} (B={b}, "
                           f"T={t}, H={h}, D={d}, {q.dtype}, block_k={bk})")
    LAUNCHES += 1
    return out


def _flash_fwd_impl(q, k, v, causal, scale, block_q, block_k, fwd):
    global DENSE_ROUTES
    _, t, _, d = q.shape
    if not _flash_aligned(t, d, block_q, block_k):
        DENSE_ROUTES += 1
        return _dense_attention(q, k, v, causal, scale)
    return fwd(q, k, v, causal, scale, block_q, block_k)


def _dense_grads(q, k, v, g, causal, scale, q_offset=0):
    """vjp of _dense_attention at (q, k, v) for the cotangent g."""
    with torch.enable_grad():
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out = _dense_attention(q, k, v, causal, scale, q_offset=q_offset)
        return torch.autograd.grad(out, (q, k, v), g)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k, fwd):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale, ctx.block_q = causal, scale, block_q
        return _flash_fwd_impl(q, k, v, causal, scale, block_q, block_k, fwd)

    @staticmethod
    def backward(ctx, g):
        """The reference's `_bwd`: scan Q blocks, recompute dense attention
        of each against the full K and V, accumulate dk and dv in f32."""
        q, k, v = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        b, t, h, d = q.shape
        bq = min(ctx.block_q, t)
        if t % bq:
            # unaligned: one dense block
            return (*_dense_grads(q, k, v, g, causal, scale),
                    None, None, None, None, None)
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(t // bq):
            rows = slice(i * bq, (i + 1) * bq)
            dq_i, dk_i, dv_i = _dense_grads(q[:, rows], k, v, g[:, rows],
                                            causal, scale, q_offset=i * bq)
            dq[:, rows] = dq_i
            dk += dk_i
            dv += dv_i
        return (dq, dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None,
                    block_q: int = 128, block_k: int = 128, fwd=None):
    """q, k, v: [B, T, H, D] -> [B, T, H, D], with the reference's
    blockwise-recompute backward. scale defaults to D^-½. fwd is the flash
    forward to run: `flash_attention_fwd` (the kernel's wrapper) by
    default; `flash_attention_plain` holds the kernel against its plain
    version under the same routing and backward."""
    actual_scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, actual_scale, block_q,
                                 block_k, fwd or flash_attention_fwd)
