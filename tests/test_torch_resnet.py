"""Port check: ray_tpu_torch.models.resnet against ray_tpu.models.resnet.

One set of weights, in the JAX package's pytree layout, goes to both
sides: the port's init from a seed, through `params_to_jax`, with numpy
noise on every batchnorm scale, bias and running statistic. The port
takes it back through `params_from_jax`; that the tree has the JAX init's
keys and shapes is its own case. Images and labels are numpy arrays from
a seed. Both sides compute in float32 on the CPU. Configurations:
- a tiny bottleneck ResNet (stages (1, 1), width 8) with the standard
  stem: the 7x7/2 conv pads SAME asymmetrically (2, 3) at 32², the
  max-pool (0, 1) with -inf, and stage 1 has the 3x3/2 conv and the
  projection; at 33² the same layers pad symmetrically;
- resnet18 with the CIFAR stem at width 8.
Every result is computed once, when the module's fixture is set up, and
each quantity is its own case, so each test itself is quick.

Tolerances, on Σ|port − jax| / Σ|jax| per tensor: 1e-5 for the loss,
2e-5 for logits and running statistics, 1e-4 for each gradient (up to
3e-5 observed). Both sides are float32, but the convolutions come from
different libraries (XLA's CPU convolutions, oneDNN) that sum in
different orders. The gradient is not continuous where a ReLU input is
0: with batchnorm biases at exactly 0 (the bare JAX init) one resnet18
ReLU input sits within float rounding of 0, and a 1e-6 change of the
input moves the stem_bn.bias gradient by 2e-2. The noisy biases keep
ReLU inputs away from 0, so the comparison measures the arithmetic.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import resnet as jres
from ray_tpu_torch.models import resnet as tres

BATCH = 4
CONFIGS = {
    "bottleneck-32": ("bottleneck", 32),
    "bottleneck-33": ("bottleneck", 33),
    "resnet18-cifar-32": ("resnet18", 32),
}
TOL = {"loss": 1e-5, "logits": 2e-5, "state": 2e-5, "eval_logits": 2e-5,
       "grads": 1e-4}


def _cfgs(name):
    """(JAX config, port config) for one architecture, both float32."""
    if name == "bottleneck":
        kw = dict(stage_sizes=(1, 1), bottleneck=True, width=8,
                  num_classes=10)
        return (jres.ResNetConfig(dtype=jnp.float32, **kw),
                tres.ResNetConfig(dtype=torch.float32, **kw))
    return (jres.resnet18(num_classes=10, small_images=True, width=8,
                          dtype=jnp.float32),
            tres.resnet18(num_classes=10, small_images=True, width=8,
                          dtype=torch.float32))


def _rel_l1(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def _port_grads(model):
    """Parameter gradients keyed and laid out as the JAX pytree's."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        out[name] = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
    return out


def _port_state(model):
    return {n: b.numpy().copy() for n, b in model.named_buffers()}


def _worst(got: dict, want: dict):
    assert got.keys() == want.keys()
    errs = {k: _rel_l1(got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


@pytest.fixture(scope="module")
def results():
    """config id -> {"jax": {...}, "plain": {...}, "kernel": {...}}."""
    return {cid: _run(*args) for cid, args in CONFIGS.items()}


def _weights(tcfg, seed):
    """(params, state) pytrees: the port's init with numpy noise on every
    batchnorm scale, bias and running statistic."""
    params, state = tres.params_to_jax(tres.ResNet(tcfg, seed=seed))
    rng = np.random.default_rng(seed)

    def noisy(tree, name):
        if isinstance(tree, dict):
            return {k: noisy(v, k) for k, v in tree.items()}
        noise = 0.1 * rng.standard_normal(tree.shape)
        if name in ("scale", "var"):
            return (tree * (1.0 + noise)).astype(np.float32)
        if name in ("bias", "mean"):
            return (tree + noise).astype(np.float32)
        return tree

    return noisy(params, ""), noisy(state, "")


def _run(arch, hw):
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(hw)
    x = rng.standard_normal((BATCH, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, 10, BATCH).astype(np.int32)
    params, state = _weights(tcfg, seed=hw)

    @jax.jit
    def jax_step(params, state, x, labels):
        logits, _ = jres.apply(params, state, x, jcfg, train=True)
        (loss, new_state), grads = jax.value_and_grad(
            jres.loss_fn, has_aux=True)(params, state, x, labels, jcfg)
        eval_logits, _ = jres.apply(params, new_state, x, jcfg, train=False)
        return logits, loss, new_state, grads, eval_logits

    logits, loss, new_state, grads, eval_logits = jax_step(
        params, state, x, labels)
    ref = {"logits": np.asarray(logits), "loss": np.asarray([loss]),
           "state": _flatten(new_state), "grads": _flatten(grads),
           "eval_logits": np.asarray(eval_logits)}

    xt = torch.from_numpy(x)
    lt = torch.from_numpy(labels.astype(np.int64))
    out = {"params": params, "state": state, "tcfg": tcfg}
    for mode in ("plain", "kernel"):
        cfg = tres.ResNetConfig(**{**tcfg.__dict__, "bn_mode": mode})
        with torch.no_grad():
            logits_t = tres.params_from_jax(params, state, cfg)(xt)
        model = tres.params_from_jax(params, state, cfg)
        loss_t = tres.loss_fn(model, xt, lt)
        loss_t.backward()
        model.eval()
        with torch.no_grad():
            eval_t = model(xt)
        out[mode] = {"logits": logits_t.numpy(),
                     "loss": np.asarray([loss_t.item()]),
                     "state": _port_state(model),
                     "grads": _port_grads(model),
                     "eval_logits": eval_t.numpy()}
    out["jax"] = ref
    return out


QUANTITIES = ["logits", "loss", "state", "grads", "eval_logits"]


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("cid", list(CONFIGS))
def test_port_matches_jax(results, cid, quantity):
    r = results[cid]
    got, want = r["plain"][quantity], r["jax"][quantity]
    if isinstance(want, dict):
        err, where = _worst(got, want)
    else:
        err, where = _rel_l1(got, want), quantity
    assert err <= TOL[quantity], (where, err)


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("cid", list(CONFIGS))
def test_kernel_bn_matches_plain(results, cid, quantity):
    """bn_mode="kernel" (BNTrain with bn_bwd_sums) against "plain"
    (autograd through the same forward) inside the port."""
    r = results[cid]
    got, want = r["kernel"][quantity], r["plain"][quantity]
    if isinstance(want, dict):
        err, where = _worst(got, want)
    else:
        err, where = _rel_l1(got, want), quantity
    assert err <= TOL[quantity], (where, err)


@pytest.mark.parametrize("cid", list(CONFIGS))
def test_params_round_trip(results, cid):
    r = results[cid]
    params, state = tres.params_to_jax(
        tres.params_from_jax(r["params"], r["state"], r["tcfg"]))
    for mine, theirs in ((params, r["params"]), (state, r["state"])):
        a, b = _flatten(mine), _flatten(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)), (32, 7, 2, (2, 3)), (33, 7, 2, (3, 3)),
    (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)), (17, 3, 2, (1, 1)),
    (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)), (7, 1, 1, (0, 0))])
def test_same_pads_match_xla(size, k, stride, pads):
    assert tres.same_pads(size, k, stride) == pads


@pytest.mark.parametrize("arch", ["bottleneck", "resnet18"])
def test_pytree_matches_jax_init(arch):
    """params_to_jax gives the JAX init's keys, shapes and dtypes."""
    jcfg, tcfg = _cfgs(arch)

    def layout(tree):
        return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)

    want = jax.eval_shape(lambda key: jres.init(key, jcfg), jax.random.key(0))
    got = tres.params_to_jax(tres.ResNet(tcfg))
    assert layout(got) == layout(want)


def test_num_bn_layers_resnet50():
    assert tres.num_bn_layers(tres.ResNet(tres.resnet50())) == 53


def test_params_from_jax_rejects_mismatched_tree(results):
    r = results["bottleneck-32"]
    params = dict(r["params"])
    params.pop("fc_b")
    with pytest.raises(ValueError, match="missing"):
        tres.params_from_jax(params, r["state"], r["tcfg"])


# ---------------------------------------------------------------------------
# the space-to-depth stem (ResNetConfig(stem_mode="s2d"))
# ---------------------------------------------------------------------------

S2D_TOL = 1e-5  # max |port - jax| / max |jax|: two float32 convolutions


def _s2d_inputs(hw):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 3, 8)) * 0.1).astype(np.float32)
    return x, w


def _port_stem(x, w, mode):
    """The port's stem on NHWC numpy x and HWIO numpy w, back to NHWC."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    with torch.no_grad():
        y = (tres._stem_s2d(xt, wt) if mode == "s2d"
             else tres._conv(xt, wt, 2))
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("hw", [32, 30])
def test_s2d_stem_matches_jax(hw):
    """The port's s2d stem against the JAX package's `_stem_s2d` on the
    same input and weights (float32)."""
    x, w = _s2d_inputs(hw)
    want = np.asarray(jres._stem_s2d(jnp.asarray(x), jnp.asarray(w),
                                     jnp.float32))
    got = _port_stem(x, w, "s2d")
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= S2D_TOL * np.abs(want).max()


def test_s2d_stem_is_equivalent():
    """As tests/test_models.py::test_resnet_s2d_stem_is_equivalent: the
    s2d stem computes the standard 7x7/2 stem (atol 1e-4), and a model
    with it gives the standard model's logits from the same parameters
    (atol 3e-3), at a small bottleneck ResNet; odd sizes raise."""
    x, w = _s2d_inputs(32)
    np.testing.assert_allclose(_port_stem(x, w, "s2d"),
                               _port_stem(x, w, "standard"), atol=1e-4)
    cfg = tres.ResNetConfig((1, 1), True, 10, width=8, dtype=torch.float32)
    std = tres.ResNet(cfg, seed=2).eval()
    s2d = tres.params_from_jax(*tres.params_to_jax(std),
                               dataclasses.replace(cfg, stem_mode="s2d"))
    images = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(s2d.eval()(images).numpy(),
                                   std(images).numpy(), atol=3e-3)
        with pytest.raises(ValueError, match="even input"):
            s2d(images[:, :31, :31])
