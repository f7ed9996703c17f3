"""Port check: ray_tpu_torch.ops.batchnorm against ray_tpu.ops.batchnorm.

The same numpy inputs, made from a seed, go through the JAX functions
(the Pallas sums kernel in interpret mode, which ray_tpu picks by itself
on the CPU, or its XLA fallback at the unaligned shape) and through the
port on the CPU, where its wrapper takes the plain version. Every result
is computed once, when the module's fixture is set up, and each quantity
is its own case, so each test itself takes microseconds.

Tolerances are on the L1 error relative to the reference's L1 norm,
Σ|port − jax| / Σ|jax|:
- float32: 1e-5. Both sides do the same f32 arithmetic; only the order
  of the sums differs (about 1e-7 observed).
- bfloat16, the sums and the statistics (sdy, sdyx, mean, var): 1e-5,
  as for float32. They are f32 work on identical bf16 values.
- bfloat16, what follows the elementwise maps (y, dx, the loss value and
  the scale/bias gradients, which follow dy = cos(y)): 2e-2. XLA fuses a
  bf16 map and computes it in f32 inside the fusion, torch rounds to bf16
  after every op, so each rounding (2^-9 relative) lands elsewhere, and
  dx = a·(dy − k1 − (x − mu)·k2) cancels. Up to 7.5e-3 observed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import batchnorm as jbn
from ray_tpu_torch.ops import batchnorm as tbn

# (4,8,8,128) aligned; (2,8,8,64) C=64; (2,4,4,256) two channel blocks;
# (3,5,5,24) unaligned: ray_tpu takes its XLA fallback, the port does not.
SHAPES = [(4, 8, 8, 128), (2, 8, 8, 64), (2, 4, 4, 256), (3, 5, 5, 24)]
DTYPES = ["float32", "bfloat16"]
EXACT_IN_BF16 = ("sdy", "sdyx", "mean", "var")


def _tol(dtype, quantity):
    if dtype == "float32" or quantity in EXACT_IN_BF16:
        return 1e-5
    return 2e-2


def _rel_l1(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30))


def _jnp(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _inputs(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2.0 + 0.5
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, dy


@pytest.fixture(scope="module")
def results():
    """(shape, dtype) -> {"jax": {...}, "port": {...}}."""
    out = {}
    for shape in SHAPES:
        for dtype in DTYPES:
            ref = _run_jax(shape, dtype)
            out[shape, dtype] = {"jax": ref,
                                 "port": _run_port(shape, dtype, ref)}
    return out


def _run_jax(shape, dtype):
    x, scale, bias, dy = _inputs(shape)
    c = shape[-1]
    xj = _jnp(x, dtype)
    x2 = xj.reshape(-1, c)
    mean = jnp.mean(x2.astype(jnp.float32), 0)
    inv = jax.lax.rsqrt(jnp.var(x2.astype(jnp.float32), 0) + 1e-5)
    sums = jax.jit(lambda *a: jbn._bn_bwd_sums(*a, interpret=True))
    sdy, sdyx = sums(x2, _jnp(dy, dtype).reshape(-1, c), mean, inv)

    def loss(x, s, b):
        y, m, v = jbn.bn_train(x, s, b)
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), (y, m, v)

    (value, (y, m, v)), (gx, gs, gb) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(xj, jnp.asarray(scale),
                                                 jnp.asarray(bias))
    out = {"sdy": sdy, "sdyx": sdyx, "mean_in": mean, "inv_in": inv,
           "value": value, "y": y, "mean": m, "var": v, "dx": gx,
           "dscale": gs, "dbias": gb}
    return {k: _np(t) for k, t in out.items()}


def _run_port(shape, dtype, ref):
    x, scale, bias, dy = _inputs(shape)
    c = shape[-1]
    xt = _torch(x, dtype)
    # the same f32 mean and inv that the JAX side fed its sums kernel
    sdy, sdyx = tbn.bn_bwd_sums(xt.reshape(-1, c),
                                _torch(dy, dtype).reshape(-1, c),
                                torch.tensor(ref["mean_in"]),
                                torch.tensor(ref["inv_in"]))
    xg = xt.clone().requires_grad_()
    s = torch.from_numpy(scale).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    y, m, v = tbn.bn_train(xg, s, b)
    value = torch.sin(y.float()).sum()
    value.backward()
    out = {"sdy": sdy, "sdyx": sdyx, "value": value, "y": y, "mean": m,
           "var": v, "dx": xg.grad, "dscale": s.grad, "dbias": b.grad}
    return {k: _np(t) for k, t in out.items()}


@pytest.mark.parametrize("quantity", ["sdy", "sdyx"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bn_bwd_sums_matches_jax(results, shape, dtype, quantity):
    r = results[shape, dtype]
    err = _rel_l1(r["port"][quantity], r["jax"][quantity])
    assert err <= _tol(dtype, quantity), err


@pytest.mark.parametrize(
    "quantity", ["value", "y", "mean", "var", "dx", "dscale", "dbias"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bn_train_matches_jax(results, shape, dtype, quantity):
    r = results[shape, dtype]
    got, want = r["port"][quantity], r["jax"][quantity]
    if quantity == "value":
        got, want = np.atleast_1d(got), np.atleast_1d(want)
    err = _rel_l1(got, want)
    assert err <= _tol(dtype, quantity), err


def test_bn_train_mean_var_carry_no_grad():
    x = torch.randn(2, 3, 3, 8, requires_grad=True)
    y, mean, var = tbn.bn_train(x, torch.ones(8), torch.zeros(8))
    assert y.requires_grad
    assert not mean.requires_grad and not var.requires_grad


@pytest.mark.parametrize("m,c,elem", [
    (3211264, 64, 2), (802816, 256, 2), (12544, 2048, 2), (50176, 1024, 2),
    (100003, 99, 2), (75, 24, 4), (7, 3, 2), (1, 1, 4)])
def test_launch_geometry_covers_every_element(m, c, elem):
    """The kernel's grid, from the wrapper's geometry, reaches every row
    and channel, with a legal block and grid."""
    vec, tx, n_ctiles, n_slabs, rows = tbn._launch_geometry(m, c, elem, True)
    assert c % vec == 0 and 16 % (vec * elem) == 0
    assert tx & (tx - 1) == 0 and 1 <= tx <= 32
    assert n_ctiles * tx * vec >= c > (n_ctiles - 1) * tx * vec
    assert n_slabs * rows >= m > (n_slabs - 1) * rows
    assert 1 <= n_slabs <= 65535


def test_wrapper_rejects_bad_inputs_before_launch():
    """Checks that sit in front of the CUDA launch raise on the CPU too
    when the tensor is not a CPU tensor the plain version can take."""
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbn.bn_bwd_sums(x, x, torch.zeros(8), torch.ones(8))
