"""Port check: ray_tpu_torch.models.vit and .bert against ray_tpu.models.vit
and .bert, the logical axes of every transformer-family model, and
ray_tpu_torch.parallel.sharding against ray_tpu.parallel.sharding.

ViT TINY (32², patch 8, 2 layers, d 64, 10 classes) at batch 2 and BERT
TINY (2 layers, d 64, vocab 256) at batch 2 x 32 tokens. Both sides get
one set of weights in the JAX params layout: the JAX init with numpy
noise on every leaf (so that ViT's zero head and the layernorms' ones
and zeros do not hide a gradient), moved with `params_from_jax`, and the
same numpy images, tokens, token types and labels. The port runs on the
CPU (`device="cpu"`), where its kernel wrappers take the plain versions.
ViT's 17 tokens are not tile-aligned and take the dense attention route
on both sides; BERT's 32 take the flash route (the Pallas kernel in
interpret mode on the JAX side, the kernel's plain version in the port),
and with `pad_mask` the dense masked attention. Every result is computed
once, in the module's fixtures; JAX's in one jit a model.

Tolerances:
- float32 logits (and BERT's sequence output) and loss: max |port − jax|
  / max |jax| <= 1e-5; the same f32 arithmetic summed in another order
  (the patch embedding: XLA's convolution against oneDNN's).
- float32 gradients, per leaf of the params tree: Σ|port − jax| / Σ|jax|
  <= 1e-4.
- bfloat16 logits: 3e-2 of max |jax| (tests/test_torch_transformer.py's
  bound: XLA rounds once per fusion, torch after each op).
- the pad-mask invariance (tests/test_models.py:101): scrambling the
  masked tail moves the logits by at most 1e-5; without the mask they
  move by more than that.
- params round trip, logical axes and sharding functions: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import bert as jbert
from ray_tpu.models import moe_transformer as jmoe
from ray_tpu.models import transformer as jtr
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import sharding as jsh
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models import moe_transformer as tmoe
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel import sharding as tsh

B, T = 2, 32
F32_TOL, GRAD_TOL, BF16_LOGITS_TOL, PAD_TOL = 1e-5, 1e-4, 3e-2, 1e-5
JVIT = dataclasses.replace(jvit.TINY, dtype=jnp.float32)
TVIT = dataclasses.replace(tvit.TINY, dtype=torch.float32)
JBERT = dataclasses.replace(jbert.TINY, dtype=jnp.float32)
TBERT = dataclasses.replace(tbert.TINY, dtype=torch.float32)


def _leaves(tree, prefix=""):
    """{dotted path: leaf} of a nest of dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _noisy(params, rng):
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + rng.normal(
        0, 0.05, np.shape(a))).astype(np.float32), params)


def _grads_to_jax(model, to_jax):
    """The model's gradients in the JAX params layout: to_jax of a copy of
    the model whose parameters are the gradients."""
    with torch.no_grad():
        saved = [p.detach().clone() for p in model.parameters()]
        for p in model.parameters():
            p.copy_(p.grad)
        tree = to_jax(model)
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    return tree


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    key = jax.random.PRNGKey(0)
    vit_params = _noisy(jvit.init(key, JVIT), rng)
    bert_params = _noisy(jbert.init(key, JBERT), rng)
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    vit_labels = np.array([3, 7], np.int32)
    tokens = rng.integers(0, JBERT.vocab_size, (B, T)).astype(np.int32)
    types = rng.integers(0, 2, (B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[:, 20:] = False
    scrambled = tokens.copy()
    scrambled[:, 20:] = (scrambled[:, 20:] + 7) % JBERT.vocab_size
    return {"vit": vit_params, "bert": bert_params, "images": images,
            "vit_labels": vit_labels, "tokens": tokens, "types": types,
            "mask": mask, "scrambled": scrambled,
            "bert_labels": np.array([0, 1], np.int32)}


@pytest.fixture(scope="module")
def jax_results(data):
    img, lab = jnp.asarray(data["images"]), jnp.asarray(data["vit_labels"])

    @jax.jit
    def vit_all(p):
        loss, grads = jax.value_and_grad(
            lambda p: jvit.loss_fn(p, img, lab, JVIT))(p)
        return (jvit.apply(p, img, JVIT), loss, grads,
                jvit.apply(p, img, jvit.TINY))

    tok, typ = jnp.asarray(data["tokens"]), jnp.asarray(data["types"])
    mask, blab = jnp.asarray(data["mask"]), jnp.asarray(data["bert_labels"])

    @jax.jit
    def bert_all(p):
        out = {}
        for name, pm in (("nomask", None), ("mask", mask)):
            loss, grads = jax.value_and_grad(lambda p: jbert.loss_fn(
                p, tok, blab, JBERT, typ, pm))(p)
            logits, seq = jbert.apply(p, tok, JBERT, typ, pm)
            out[name] = {"logits": logits, "seq": seq, "loss": loss,
                         "grads": grads}
        out["logits16"] = jbert.apply(p, tok, jbert.TINY, typ)[0]
        return out

    v = jax.tree.map(np.asarray, vit_all(data["vit"]))
    b = jax.tree.map(np.asarray, bert_all(data["bert"]))
    return {"vit": {"logits": v[0], "loss": float(v[1]), "grads": v[2],
                    "logits16": v[3]},
            "bert": b}


@pytest.fixture(scope="module")
def port_results(data):
    out = {}
    model = tvit.params_from_jax(data["vit"], TVIT, device="cpu")
    img = torch.from_numpy(data["images"])
    lab = torch.from_numpy(data["vit_labels"])
    loss = tvit.loss_fn(model, (img, lab))
    loss.backward()
    with torch.no_grad():
        logits16 = tvit.params_from_jax(data["vit"], tvit.TINY,
                                        device="cpu")(img).float()
        out["vit"] = {"logits": model(img).numpy(), "loss": loss.item(),
                      "grads": _grads_to_jax(model, tvit.params_to_jax),
                      "logits16": logits16.numpy()}
    tok, typ = (torch.from_numpy(data[k]) for k in ("tokens", "types"))
    mask, blab = (torch.from_numpy(data[k]) for k in ("mask", "bert_labels"))
    out["bert"] = {}
    for name, pm in (("nomask", None), ("mask", mask)):
        model = tbert.params_from_jax(data["bert"], TBERT, device="cpu")
        loss = tbert.loss_fn(model, (tok, blab, typ, pm))
        loss.backward()
        with torch.no_grad():
            logits, seq = model(tok, typ, pm)
        out["bert"][name] = {
            "logits": logits.numpy(), "seq": seq.numpy(),
            "loss": loss.item(),
            "grads": _grads_to_jax(model, tbert.params_to_jax)}
    with torch.no_grad():
        model = tbert.params_from_jax(data["bert"], TBERT, device="cpu")
        scr = torch.from_numpy(data["scrambled"])
        out["bert"]["pad"] = {"base": model(tok, None, mask)[0].numpy(),
                              "scrambled": model(scr, None, mask)[0].numpy(),
                              "no_mask": model(scr)[0].numpy()}
        out["bert"]["logits16"] = tbert.params_from_jax(
            data["bert"], tbert.TINY, device="cpu")(tok, typ)[0].float(
        ).numpy()
    return out


def _rel_max(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_l1(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30))


VIT_LEAVES = sorted(_leaves(jax.eval_shape(
    lambda: jvit.init(jax.random.PRNGKey(0), jvit.TINY))))
BERT_LEAVES = sorted(_leaves(jax.eval_shape(
    lambda: jbert.init(jax.random.PRNGKey(0), jbert.TINY))))


def test_vit_logits_and_loss_match_jax(jax_results, port_results):
    got, want = port_results["vit"], jax_results["vit"]
    assert _rel_max(got["logits"], want["logits"]) <= F32_TOL
    assert abs(got["loss"] - want["loss"]) <= F32_TOL * abs(want["loss"])


def test_vit_logits_match_jax_bf16(jax_results, port_results):
    err = _rel_max(port_results["vit"]["logits16"],
                   jax_results["vit"]["logits16"])
    assert err <= BF16_LOGITS_TOL, err


@pytest.mark.parametrize("leaf", VIT_LEAVES)
def test_vit_grads_match_jax(jax_results, port_results, leaf):
    err = _rel_l1(_leaves(port_results["vit"]["grads"])[leaf],
                  _leaves(jax_results["vit"]["grads"])[leaf])
    assert err <= GRAD_TOL, (leaf, err)


@pytest.mark.parametrize("mask", ["nomask", "mask"])
def test_bert_outputs_match_jax(jax_results, port_results, mask):
    got, want = port_results["bert"][mask], jax_results["bert"][mask]
    assert _rel_max(got["logits"], want["logits"]) <= F32_TOL
    assert _rel_max(got["seq"], want["seq"]) <= F32_TOL
    assert abs(got["loss"] - want["loss"]) <= F32_TOL * abs(want["loss"])


def test_bert_logits_match_jax_bf16(jax_results, port_results):
    err = _rel_max(port_results["bert"]["logits16"],
                   jax_results["bert"]["logits16"])
    assert err <= BF16_LOGITS_TOL, err


@pytest.mark.parametrize("mask", ["nomask", "mask"])
@pytest.mark.parametrize("leaf", BERT_LEAVES)
def test_bert_grads_match_jax(jax_results, port_results, mask, leaf):
    err = _rel_l1(_leaves(port_results["bert"][mask]["grads"])[leaf],
                  _leaves(jax_results["bert"][mask]["grads"])[leaf])
    assert err <= GRAD_TOL, (leaf, err)


def test_bert_pad_mask_invariance(port_results):
    """tests/test_models.py:101 on the port: padded positions do not move
    the [CLS] logits; without the mask they do."""
    pad = port_results["bert"]["pad"]
    assert np.abs(pad["base"] - pad["scrambled"]).max() <= PAD_TOL
    assert np.abs(pad["base"] - pad["no_mask"]).max() > PAD_TOL


@pytest.mark.parametrize("model", ["vit", "bert"])
def test_params_round_trip_bit_exact(data, model):
    mod = {"vit": (tvit, TVIT), "bert": (tbert, TBERT)}[model]
    back = mod[0].params_to_jax(mod[0].params_from_jax(
        data[model], mod[1], device="cpu"))
    want, got = _leaves(data[model]), _leaves(back)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("model", ["vit", "bert"])
def test_params_from_jax_rejects_a_foreign_tree(data, model):
    mod = {"vit": (tvit, TVIT), "bert": (tbert, TBERT)}[model]
    with pytest.raises(ValueError, match="keys"):
        mod[0].params_from_jax(dict(data[model], extra=np.zeros(3)), mod[1],
                               device="cpu")


@pytest.mark.parametrize("model", ["vit", "bert"])
def test_models_refuse_the_cpu_unless_asked(data, model):
    """Without CUDA a model's default device raises: nothing falls back
    to the CPU unless device="cpu" is given."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    mod = {"vit": (tvit, TVIT), "bert": (tbert, TBERT)}[model]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod[0].params_from_jax(data[model], mod[1])


# ---------------------------------------------------------------------------
# logical axes and the sharding functions
# ---------------------------------------------------------------------------

LOGICAL = {
    "gpt": (lambda: jtr.logical_axes(jtr.TINY),
            lambda: ttr.logical_axes(ttr.TINY)),
    "gpt-untied": (
        lambda: jtr.logical_axes(dataclasses.replace(
            jtr.TINY, tie_embeddings=False)),
        lambda: ttr.logical_axes(dataclasses.replace(
            ttr.TINY, tie_embeddings=False))),
    "vit": (lambda: jvit.logical_axes(jvit.TINY),
            lambda: tvit.logical_axes(tvit.TINY)),
    "bert": (lambda: jbert.logical_axes(jbert.TINY),
             lambda: tbert.logical_axes(tbert.TINY)),
    "moe": (lambda: jmoe.logical_axes(jmoe.TINY_MOE),
            lambda: tmoe.logical_axes(tmoe.TINY_MOE)),
}


@pytest.mark.parametrize("model", list(LOGICAL))
def test_logical_axes_match_the_reference(model):
    want, got = (f() for f in LOGICAL[model])
    assert got == want


@pytest.mark.parametrize("model", ["gpt", "vit", "bert"])
def test_named_axes_cover_the_port_parameters(model):
    """named_axes maps the logical tree onto every parameter of the
    port's model, one axis per dimension (each block its own slice)."""
    if model == "gpt":
        mod, axes = ttr.GPT(ttr.TINY), ttr.named_axes(
            ttr.logical_axes(ttr.TINY), ttr.TINY.n_layers)
    elif model == "vit":
        mod, axes = tvit.ViT(tvit.TINY, device="cpu"), tvit.named_axes(
            tvit.TINY)
    else:
        mod, axes = tbert.Bert(tbert.TINY, device="cpu"), tbert.named_axes(
            tbert.TINY)
    shapes = {n: tuple(p.shape) for n, p in mod.named_parameters()}
    assert sorted(axes) == sorted(shapes)
    for name, shape in shapes.items():
        assert len(axes[name]) == len(shape), (name, axes[name], shape)


RULES = [None, {"embed": "tp"}, {"heads": None, "expert": "dp"}]
AXES_CASES = [("batch", "seq", "embed"), ("layers", "embed", "mlp"),
              ("expert", None, "vocab"), ("stage", "kv", "heads"), ()]


@pytest.mark.parametrize("rules", RULES, ids=str)
@pytest.mark.parametrize("axes", AXES_CASES, ids=str)
def test_spec_for_matches_the_reference(axes, rules):
    assert tuple(tsh.spec_for(axes, rules)) == tuple(jsh.spec_for(axes,
                                                                  rules))
    assert isinstance(tsh.spec_for(axes, rules), tsh.P)


@pytest.mark.parametrize("model", ["moe", "bert"])
def test_tree_shardings_match_the_reference(model):
    """The port's NamedShardings carry the reference's specs (the mesh is
    a stand-in object: the specs do not depend on it)."""
    jmesh = MeshSpec().build(jax.devices()[:1])
    want_tree, got_tree = (f() for f in LOGICAL[model])
    rules = {"mlp": "tp", "embed": None}
    want = _leaves(jax.tree.map(
        lambda s: tuple(s.spec), jsh.tree_shardings(jmesh, want_tree, rules),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))
    mesh = object()
    got_sh = tsh.tree_shardings(mesh, got_tree, rules)
    got = {k: tuple(v.spec) for k, v in _port_shardings(got_sh).items()}
    assert got == {k: tuple(v) for k, v in want.items()}
    assert all(s.mesh is mesh for s in _port_shardings(got_sh).values())


def _port_shardings(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_shardings(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("dim,n", [(8, 2), (10, 4), (7, 7), (5, 3)])
def test_shard_bounds_and_slices_match_the_reference(dim, n):
    w = np.arange(dim * (dim + 1), dtype=np.float32).reshape(dim + 1, dim)
    r = np.arange(dim * 3, dtype=np.float32).reshape(dim, 3)
    for rank in range(n):
        assert tsh.shard_bounds(dim, rank, n) == jsh.shard_bounds(dim, rank,
                                                                  n)
        assert tsh.kv_slice(dim, rank, n) == jsh.kv_slice(dim, rank, n)
        got = tsh.column_shard(torch.from_numpy(w), rank, n).numpy()
        assert np.array_equal(got, np.asarray(jsh.column_shard(w, rank, n)))
        got = tsh.row_shard(torch.from_numpy(r), rank, n).numpy()
        assert np.array_equal(got, np.asarray(jsh.row_shard(r, rank, n)))


@pytest.mark.parametrize("args", [(3, 3, 3), (3, -1, 3), (2, 0, 3)])
def test_shard_bounds_rejects_what_the_reference_rejects(args):
    with pytest.raises(ValueError) as want:
        jsh.shard_bounds(*args)
    with pytest.raises(ValueError) as got:
        tsh.shard_bounds(*args)
    assert str(got.value) == str(want.value)


def test_infer_param_logical_axes_matches_the_reference(data):
    tree = {"token_embedding": np.zeros((10, 4), np.float32),
            "enc": {"EmbeddingTable": np.zeros((6, 4), np.float32),
                    "w": np.zeros((4, 4), np.float32),
                    "b": np.zeros((4,), np.float32),
                    "step": np.float32(0)},
            "bert": data["bert"]}
    assert tsh.infer_param_logical_axes(tree) == \
        jsh.infer_param_logical_axes(tree)
    module = torch.nn.ModuleDict({"embedding": torch.nn.Embedding(10, 4),
                                  "proj": torch.nn.Linear(4, 2)})
    want = jsh.infer_param_logical_axes(
        {"embedding": {"weight": np.zeros((10, 4))},
         "proj": {"weight": np.zeros((2, 4)), "bias": np.zeros(2)}})
    assert tsh.infer_param_logical_axes(module) == {
        "embedding.weight": want["embedding"]["weight"],
        "proj.weight": want["proj"]["weight"],
        "proj.bias": want["proj"]["bias"]}


def test_with_logical_axes_wraps_the_initializer():
    w = tsh.WithLogicalAxes(lambda n: torch.zeros(n), ("embed",))
    assert w.logical_axes == ("embed",) and tuple(w(3).shape) == (3,)
