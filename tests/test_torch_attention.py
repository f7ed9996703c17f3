"""Port check: ray_tpu_torch.ops.attention against ray_tpu.ops.attention.

The same numpy inputs, made from a seed, go through the JAX functions
(the Pallas flash kernel in interpret mode, which ray_tpu picks by itself
on the CPU, its dense route, and its custom-vjp blockwise backward) and
through the port on the CPU, where the flash wrapper takes the plain
version of the kernel. Every result is computed once, in the module's
fixture, and each quantity is its own case.

Tolerances, max |port − jax| / max |jax|:
- float32, forward and gradients: 1e-5. Both sides do the same f32
  arithmetic block by block; the matmuls and softmax sums run in another
  order.
- bfloat16 forward (flash route, one case): 1e-2, with 1e-5 on the f32
  images of the same inputs above. Both cast p to bf16 before p·V, but p
  carries the f32 differences above into that rounding, and the output is
  rounded to bf16 (2^-8 relative) at the end.

The last test holds the GPU check's own flash tolerance (chip_smoke.py's
flash_err, per element, pass at <= 1) to its purpose on the CPU: it
passes f32 rounding differences and fails small faults.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt

# name: (B, T, H, D, block_q, block_k, causal)
FLASH = {
    "causal-16x16": (2, 64, 2, 16, 16, 16, True),
    "full-16x16": (1, 64, 2, 16, 16, 16, False),
    "causal-8x16": (2, 32, 2, 16, 8, 16, True),
    "full-8x16": (1, 32, 3, 16, 8, 16, False),
}
# T = 20 is not a multiple of 8: both packages take the dense route, and
# the backward takes the single-block route (T % block_q != 0).
DENSE = {"causal-t20": (2, 20, 2, 16, 16, 16, True)}
F32_TOL = 1e-5
BF16_TOL = 1e-2


def _qkvg(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax_flash_vjp(q, k, v, g, bq, bk, causal):
    """(output, (dq, dk, dv)) of the reference for the cotangent g."""
    out, vjp = jax.vjp(lambda q, k, v: jatt.flash_attention(
        q, k, v, causal, None, bq, bk), q, k, v)
    return out, vjp(g)


def _port_flash_vjp(q, k, v, g, bq, bk, causal):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tatt.flash_attention(*leaves, causal, None, bq, bk)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach(), [x.grad for x in leaves]


def _inputs():
    cases = {name: _qkvg(cfg[:4], i)
             for i, (name, cfg) in enumerate({**FLASH, **DENSE}.items())}
    cases["bf16"] = _qkvg(FLASH["causal-16x16"][:4], 10)[:3]
    q, k, v, _ = _qkvg((2, 24, 2, 16), 11)
    mask = np.ones((2, 24), bool)  # the last keys of each row padded out
    mask[0, 19:] = False
    mask[1, 9:] = False
    cases["masked"] = [q, k, v, mask]
    return cases


def _jax_all(cases):
    """Every reference result, in one jit."""
    out = {name: _jax_flash_vjp(*cases[name], *cfg[4:])
           for name, cfg in {**FLASH, **DENSE}.items()}
    _, _, _, _, bq, bk, causal = FLASH["causal-16x16"]
    q, k, v = (a.astype(jnp.bfloat16) for a in cases["bf16"])
    out["bf16"] = jatt.flash_attention(q, k, v, causal, None, bq,
                                       bk).astype(jnp.float32)
    for causal in (False, True):
        out[f"masked-causal{causal}"] = jatt.masked_attention(
            *cases["masked"], causal=causal)
    return out


@pytest.fixture(scope="module")
def results():
    cases = _inputs()
    want = jax.jit(_jax_all)(jax.tree.map(jnp.asarray, cases))
    out = {}
    for name, cfg in {**FLASH, **DENSE}.items():
        routes = tatt.DENSE_ROUTES
        po, pg = _port_flash_vjp(*cases[name], *cfg[4:])
        jo, jg = want[name]
        out[name] = {"out": (po.numpy(), np.asarray(jo)),
                     "dense_routes": tatt.DENSE_ROUTES - routes}
        for n, a, w in zip("qkv", pg, jg):
            out[name]["d" + n] = (a.numpy(), np.asarray(w))
    _, _, _, _, bq, bk, causal = FLASH["causal-16x16"]
    po = tatt.flash_attention(*(torch.from_numpy(a).bfloat16()
                                for a in cases["bf16"]), causal, None, bq, bk)
    out["bf16"] = (po.float().numpy(), np.asarray(want["bf16"]))
    q, k, v, mask = (torch.from_numpy(a) for a in cases["masked"])
    for causal in (False, True):
        name = f"masked-causal{causal}"
        po = tatt.masked_attention(q, k, v, mask, causal=causal)
        out[name] = (po.numpy(), np.asarray(want[name]))
    return out


def _rel_max(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("quantity", ["out", "dq", "dk", "dv"])
@pytest.mark.parametrize("case", list(FLASH) + list(DENSE))
def test_flash_attention_matches_jax(results, case, quantity):
    err = _rel_max(*results[case][quantity])
    assert err <= F32_TOL, err


@pytest.mark.parametrize("case", list(FLASH) + list(DENSE))
def test_unaligned_shapes_take_the_dense_route(results, case):
    assert results[case]["dense_routes"] == (1 if case in DENSE else 0)


def test_flash_attention_bf16_matches_jax(results):
    err = _rel_max(*results["bf16"])
    assert err <= BF16_TOL, err


@pytest.mark.parametrize("causal", [False, True])
def test_masked_attention_matches_jax(results, causal):
    err = _rel_max(*results[f"masked-causal{causal}"])
    assert err <= F32_TOL, err


def test_plain_version_equals_dense_attention():
    """The blockwise online softmax of the plain version is dense
    attention (f32, 1e-5), with the causal scan stop included."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvg((1, 48, 2, 8), 12))
    for causal in (False, True):
        got = tatt.flash_attention_plain(q, k, v, causal, 8 ** -0.5, 16, 8)
        want = tatt._dense_attention(q, k, v, causal, 8 ** -0.5)
        assert _rel_max(got.numpy(), want.numpy()) <= F32_TOL


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvg((1, 32, 2, 8), 13))
    before = tatt.LAUNCHES
    got = tatt.flash_attention_fwd(q, k, v, True, 0.3, 16, 16)
    assert torch.equal(got, tatt.flash_attention_plain(q, k, v, True, 0.3,
                                                       16, 16))
    assert tatt.LAUNCHES == before


def test_other_devices_raise():
    q = torch.empty(1, 32, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.flash_attention_fwd(q, q, q, True, 0.25, 16, 16)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cast_p_attention(q, k, v, scale, visible):
    """Attention on [B, T, H, D] bf16 with p cast to bf16 before p·V, as
    the kernel; visible [T, T] bool (query, key)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(torch.where(visible, s, tatt.NEG_INF), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(),
                        v.float()).to(q.dtype)


@pytest.mark.parametrize("fault", ["f32-noise", "scale+1%", "mask+1",
                                   "no-diag"])
def test_gpu_check_of_flash_flags_small_faults(fault):
    """chip_smoke.py's flash check (flash_err, in units of FLASH_TOL) at
    GPT-2's head dim and T = 512: the plain version with its scores moved
    by f32 rounding (scale · (1 + 2^-22)), as the kernel's tensor-core sums
    move them, passes; a scale 1% off, a causal mask one key too wide, or
    the diagonal key dropped from the later half of the rows fails."""
    cs = _chip_smoke()
    t, scale = 512, 64 ** -0.5
    gen = torch.Generator().manual_seed(21)
    q, k, v = (torch.randn((1, t, 2, 64), generator=gen).to(torch.bfloat16)
               for _ in range(3))
    want = tatt.flash_attention_plain(q, k, v, True, scale, 128, 128)
    i, j = torch.arange(t)[:, None], torch.arange(t)[None, :]
    if fault in ("f32-noise", "scale+1%"):
        moved = scale * (1 + 2.0 ** -22 if fault == "f32-noise" else 1.01)
        got = tatt.flash_attention_plain(q, k, v, True, moved, 128, 128)
    else:
        visible = (i + 1 >= j if fault == "mask+1"
                   else (i >= j) & ~((i >= t // 2) & (i == j)))
        got = _cast_p_attention(q, k, v, scale, visible)
    err = cs.flash_err(got, want)
    assert (err <= cs.FLASH_TOL) == (fault == "f32-noise"), err


# The CUDA wrapper's argument checks, as pure data: GPT-2's q, k, v as
# views into one qkv tensor [B, T, 3·H·D] (element strides, byte pointers).
_GPT2 = {"shapes": [(12, 1024, 12, 64)] * 3,
         "dtypes": [torch.bfloat16] * 3,
         "strides": [(1024 * 2304, 2304, 64, 1)] * 3,
         "ptrs": [1 << 20, (1 << 20) + 1536, (1 << 20) + 3072],
         "block_k": 128, "scale": 0.125}


def _with(**changes):
    return {**_GPT2, **changes}


@pytest.mark.parametrize("args,match", [
    (_with(ptrs=[(1 << 20) + 2, (1 << 20) + 1536, (1 << 20) + 3072]),
     "16-byte aligned"),
    (_with(strides=[(1025 * 2304, 2305, 64, 1)] * 3), "multiples of 16"),
    (_with(shapes=[(12, 1024, 12, 32)] * 3,
           strides=[(1024 * 1152, 1152, 32, 1)] * 3), "head dim 32"),
    (_with(shapes=[(12, 1000, 12, 64)] * 3), "divide T = 1000"),
    (_with(scale=-0.125), "positive"),
    (_with(dtypes=[torch.bfloat16, torch.float32, torch.bfloat16]),
     "all be bfloat16"),
    (_with(strides=[(1024 * 2304, 2304, 1, 12)] * 3), "contiguous"),
], ids=["misaligned-base", "odd-row-stride", "bf16-d32", "t-1000",
        "negative-scale", "mixed-dtypes", "last-dim-strided"])
def test_kernel_args_refuse_what_the_kernel_does_not_take(args, match):
    with pytest.raises((ValueError, TypeError), match=match):
        tatt.check_kernel_args(**args)


@pytest.mark.parametrize("args", [
    _GPT2,
    _with(shapes=[(2, 256, 12, 64)] * 3, dtypes=[torch.float32] * 3,
          strides=[(256 * 2304, 2304, 64, 1)] * 3,
          ptrs=[4, 8, 12]),  # f32: no TMA, so no alignment condition
], ids=["gpt2-bf16-qkv-views", "f32"])
def test_kernel_args_take_the_main_path_shapes(args):
    tatt.check_kernel_args(**args)


def test_gpu_build_check_reads_registers_and_spills():
    """chip_smoke.py's build phase fails the run on a ptxas spill in the
    flash or ring kernels: its parser reads each kernel's registers, static
    shared memory and spill bytes from nvcc -Xptxas -v."""
    log = "\n".join([
        "ptxas info    : Function properties for _Z4tiledv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 122 registers, used 1 barriers, 16 bytes smem",
        "ptxas info    : Function properties for _Z5spillyv",
        "    16 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers"])
    table = _chip_smoke()._ptxas_table(log)
    assert sorted(table.values(), key=lambda v: v["registers"]) == [
        {"spill_stores": 0, "spill_loads": 0, "registers": 122, "smem": 16},
        {"spill_stores": 16, "spill_loads": 8, "registers": 168, "smem": 0}]
