"""Port check: ray_tpu_torch.ops.layernorm against ray_tpu.ops.layernorm.

The same numpy inputs, made from a seed, go through the JAX functions
(the Pallas kernels in interpret mode, which ray_tpu picks by itself on
the CPU) and through the port on the CPU, where the wrappers take the
plain versions. Every result is computed once, in the module's fixture,
and each quantity is its own case.

Tolerances:
- forward, float32: max |port − jax| ≤ 1e-6 · max |jax|. Both sides do
  the same f32 arithmetic; only the order of the row sums differs.
- forward, bfloat16 (x, weight and bias in bf16, as the model calls it):
  every element within one bf16 ulp of the reference's, plus 1e-6 ·
  max |jax|. The f32 values before the one cast at the store differ by the
  f32 rounding above, which can move a value across a bf16 rounding
  boundary, never further; where y·w + b cancels to near 0 (2.8e-6 at one
  element), that f32 rounding is larger than the element's own ulp, hence
  the second term.
- backward, float32: Σ|port − jax| / Σ|jax| ≤ 1e-5 for dx, dw and db
  against jax.grad through the reference's custom vjp: the same analytic
  formulas, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import layernorm as jln
from ray_tpu_torch.ops import layernorm as tln

# (4, 16, 128): N = 64 rows, D a multiple of 8; (5, 7, 100): N = 35 and
# D = 100, multiples of neither the reference's 256-row block nor 8.
SHAPES = {"aligned": (4, 16, 128), "unaligned": (5, 7, 100)}
KINDS = ("layernorm", "rmsnorm")
DTYPES = ("float32", "bfloat16")
F32_FWD_TOL = 1e-6
BWD_TOL = 1e-5


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    return {"x": (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32),
            "w": (rng.standard_normal(d) + 1.0).astype(np.float32),
            "b": rng.standard_normal(d).astype(np.float32),
            "g": rng.standard_normal(shape).astype(np.float32)}


def _jax_fn(kind):
    if kind == "layernorm":
        return lambda x, w, b: jln.layernorm(x, w, b)
    return lambda x, w, b: jln.rmsnorm(x, w)


def _port_fn(kind):
    if kind == "layernorm":
        return lambda x, w, b: tln.layernorm(x, w, b)
    return lambda x, w, b: tln.rmsnorm(x, w)


def _jax_all(inputs):
    """Every reference result, in one jit: forwards in both dtypes, and
    the f32 gradients of Σ(norm(x)·g)."""
    out = {}
    for sname, a in inputs.items():
        for kind in KINDS:
            fn = _jax_fn(kind)
            for dtype in DTYPES:
                args = (a[k].astype(getattr(jnp, dtype)) for k in "xwb")
                out[("fwd", kind, sname, dtype)] = fn(*args).astype(
                    jnp.float32)
            grads = jax.grad(lambda x, w, b: (fn(x, w, b) * a["g"]).sum(),
                             (0, 1, 2))(a["x"], a["w"], a["b"])
            for name, grad in zip("xwb", grads):
                out[("bwd", kind, sname, name)] = grad
    return out


@pytest.fixture(scope="module")
def results():
    inputs = {sname: _inputs(shape, i)
              for i, (sname, shape) in enumerate(SHAPES.items())}
    want = jax.jit(_jax_all)(jax.tree.map(jnp.asarray, inputs))
    out = {}
    for sname, a in inputs.items():
        for kind in KINDS:
            for dtype in DTYPES:
                got = _port_fn(kind)(*(torch.from_numpy(a[k]).to(
                    getattr(torch, dtype)) for k in "xwb"))
                key = ("fwd", kind, sname, dtype)
                out[key] = (got.float().numpy(), np.asarray(want[key]))
            leaves = [torch.from_numpy(a[k]).requires_grad_() for k in "xwb"]
            (_port_fn(kind)(*leaves) * torch.from_numpy(a["g"])).sum(
                ).backward()
            for leaf, name in zip(leaves, "xwb"):
                if leaf.grad is not None:  # rmsnorm has no bias
                    key = ("bwd", kind, sname, name)
                    out[key] = (leaf.grad.numpy(), np.asarray(want[key]))
    return out


def _bf16_ulp(ref):
    """One bf16 ulp at each value of ref (7 stored mantissa bits)."""
    mag = np.maximum(np.abs(ref.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(results, kind, shape, dtype):
    got, want = results[("fwd", kind, shape, dtype)]
    assert got.shape == want.shape
    if dtype == "float32":
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= F32_FWD_TOL, err
    else:
        limit = _bf16_ulp(want) + F32_FWD_TOL * np.abs(want).max()
        excess = np.abs(got.astype(np.float64) - want) / limit
        assert excess.max() <= 1.0, excess.max()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind,grad", [("layernorm", "x"), ("layernorm", "w"),
                                       ("layernorm", "b"), ("rmsnorm", "x"),
                                       ("rmsnorm", "w")])
def test_backward_matches_jax_grad(results, kind, grad, shape):
    got, want = results[("bwd", kind, shape, grad)]
    assert got.shape == want.shape
    err = np.abs(got - want).sum() / np.abs(want).sum()
    assert err <= BWD_TOL, err


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_tensors_take_the_plain_version_without_launching(kind):
    x = torch.randn(6, 40)
    w, b = torch.randn(40), torch.randn(40)
    before = (tln.LAYERNORM_LAUNCHES, tln.RMSNORM_LAUNCHES)
    if kind == "layernorm":
        got, want = tln.layernorm_fwd(x, w, b), tln.layernorm_plain(x, w, b)
    else:
        got, want = tln.rmsnorm_fwd(x, w), tln.rmsnorm_plain(x, w)
    assert torch.equal(got, want)
    assert (tln.LAYERNORM_LAUNCHES, tln.RMSNORM_LAUNCHES) == before


@pytest.mark.parametrize("kind", KINDS)
def test_other_devices_raise(kind):
    x = torch.empty(4, 8, device="meta")
    w = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if kind == "layernorm":
            tln.layernorm_fwd(x, w, w)
        else:
            tln.rmsnorm_fwd(x, w)
