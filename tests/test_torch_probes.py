"""The paper's figure probes in the port against the JAX package, on the CPU:
ResNet-18 (Fig. 5), the two-layer linear LM and its data (Fig. 7), the
init schemes (Fig. 9), per-layer SNR (Fig. 30), the metadata helpers and
gpt_medium's specs.

Forward passes start from JAX-initialised parameters carried across by
``repro_torch.convert``. Tolerances, relative to each output's largest
magnitude: ResNet logits, loss and gradients 1e-4 (convolution sums run in
another order), the linear LM and per-layer SNR 1e-5. Init schemes are
compared by statistics: the packages draw different random bits.
"""
import math
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, flat_numpy
from repro.configs import get_config as jax_config, get_reduced as jax_reduced
from repro.core import measure_leaf_snr_per_layer as jax_snr_per_layer
from repro.core.labels import ParamMeta as JaxParamMeta, flatten_with_names as jax_flatten, \
    path_str as jax_path_str, validate_meta as jax_validate_meta
from repro.data import linear_model_batches as jax_linear_batches
from repro.data.pipeline import byte_corpus as jax_byte_corpus
from repro.models import linear_lm as jax_linear_lm, resnet as jax_resnet
from repro.train.loss import cross_entropy as jax_cross_entropy
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import measure_leaf_snr_per_layer, path_str, validate_meta
from repro_torch.core.labels import ParamMeta, flatten_with_names
from repro_torch.data import byte_corpus, linear_model_batches
from repro_torch.models import LinearLM, LinearLMConfig, ResNet, ResNetConfig, Transformer, resnet
from repro_torch.train.loss import cross_entropy

TOL_RESNET = 1e-4
TOL = 1e-5


def _spec_rows(flat):
    return [(name, tuple(s.shape), s.axes, s.role, s.fan_in, s.fan_out) for name, s in flat]


def _jax_spec_rows(spec_tree):
    from repro.models.common import ParamSpec as JaxParamSpec

    leaves = jax.tree_util.tree_flatten_with_path(spec_tree, is_leaf=lambda x: isinstance(x, JaxParamSpec))[0]
    return _spec_rows([(jax_path_str(p), s) for p, s in leaves])


# -- ResNet-18 ----------------------------------------------------------------


@pytest.mark.parametrize("cfg_kw", [dict(classes=100), dict(stages=(1, 1), width=8, classes=10)])
def test_resnet_specs_match_jax(cfg_kw):
    want = _jax_spec_rows(jax_resnet.ResNetConfig(**cfg_kw).specs())
    got = _spec_rows(flatten_with_names(ResNetConfig(**cfg_kw).specs()))
    assert got == want
    if cfg_kw.get("classes") == 100 and "stages" not in cfg_kw:
        assert sum(math.prod(r[1]) for r in got) == 11_218_240


def _resnet_pair(size, batch=4, seed=0):
    jcfg = jax_resnet.ResNetConfig(stages=(1, 1), width=8, classes=10)
    jparams, _ = jcfg.init(jax.random.PRNGKey(seed))
    arrays = {n: np.asarray(x) for n, x in jax_flatten(jparams)[0]}
    model = ResNet(ResNetConfig(stages=(1, 1), width=8, classes=10), device="cpu")
    model.load_params(params_from_numpy(arrays, "cpu"))
    rng = np.random.default_rng(seed + 5)
    images = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=batch).astype(np.int32)
    return jcfg, jparams, model, images, labels


@pytest.mark.parametrize("size", [8, 9, 32])
def test_resnet_forward_loss_and_gradients_match_jax(size):
    """Stage 1's first block convolves at stride 2 (and its 1x1 proj): on an
    even input XLA's SAME pads 0 before and 1 after, on an odd one 1 and 1."""
    jcfg, jparams, model, images, labels = _resnet_pair(size)

    def jax_loss(p):
        lg, _ = jax_resnet.forward(jcfg, p, {"images": jnp.asarray(images)})
        return jax_cross_entropy(lg[:, None, :], jnp.asarray(labels)[:, None]), lg

    (jl, jlogits), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(jparams)
    batch = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}
    logits, aux = model(batch)
    loss = cross_entropy(logits[:, None, :], batch["labels"][:, None])
    grads = dict(zip(model.names, torch.autograd.grad(loss, list(model.leaves))))
    assert float(aux) == 0.0 and logits.shape == (4, 10)
    assert_close(logits.detach(), np.asarray(jlogits), TOL_RESNET, "logits")
    assert_close(loss.detach(), np.asarray(jl), TOL_RESNET, "loss")
    for name, g in flat_numpy(jgrads).items():
        assert_close(grads[name], g, TOL_RESNET, f"grad {name}")


@pytest.mark.parametrize("stride,size,k", [(2, 32, 3), (2, 31, 3), (2, 32, 1), (1, 32, 3), (1, 9, 1)])
def test_resnet_same_padding_matches_xla(stride, size, k):
    rng = np.random.default_rng(stride * 100 + size + k)
    x = rng.standard_normal((2, size, size, 8)).astype(np.float32)
    w = rng.standard_normal((k, k, 8, 5)).astype(np.float32)
    want = jax_resnet._conv(jnp.asarray(x), jnp.asarray(w), stride)
    got = resnet._conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w), stride).permute(0, 2, 3, 1)
    assert_close(got, np.asarray(want), TOL_RESNET, f"conv k{k} s{stride} n{size}")


def test_synthetic_cifar_shapes_and_means():
    batch = resnet.synthetic_cifar(torch.Generator().manual_seed(0), 512, 10, size=8)
    assert batch["images"].shape == (512, 8, 8, 3) and batch["labels"].shape == (512,)
    assert int(batch["labels"].min()) >= 0 and int(batch["labels"].max()) < 10
    means = torch.randn((10, 3), generator=torch.Generator().manual_seed(7)) * 0.5
    centred = batch["images"] - means[batch["labels"]][:, None, None, :]
    assert float(centred.std()) == pytest.approx(0.3, rel=0.02)


# -- the linear LM and its data ------------------------------------------------


@pytest.mark.parametrize("vocab,d", [(64, 8), (2048, 32)])
def test_linear_lm_forward_matches_jax(vocab, d):
    jcfg = jax_linear_lm.LinearLMConfig(vocab_size=vocab, d_model=d)
    jparams, jmeta = jcfg.init(jax.random.PRNGKey(1))
    model = LinearLM(LinearLMConfig(vocab_size=vocab, d_model=d), device="cpu")
    assert _spec_rows(flatten_with_names(model.cfg.specs())) == _jax_spec_rows(jcfg.specs())
    assert model.meta == {n: ParamMeta(m.axes, m.role, m.fan_in, m.fan_out) for n, m in jax_flatten(jmeta)[0]}
    model.load_params(params_from_numpy({n: np.asarray(x) for n, x in jax_flatten(jparams)[0]}, "cpu"))
    batch = jax_linear_batches(vocab, seq_len=16, batch=4, seed=2).batch(3)
    want, _ = jax_linear_lm.forward(jcfg, jparams, {"tokens": jnp.asarray(batch["tokens"])})
    got, aux = model({"tokens": torch.from_numpy(batch["tokens"])})
    assert float(aux) == 0.0
    assert_close(got.detach(), np.asarray(want), TOL, "logits")


def test_linear_lm_own_init_statistics():
    cfg = LinearLMConfig(vocab_size=49152, d_model=32)
    params = {k: p.detach() for k, p in LinearLM(cfg, device="cpu").params.items()}
    # N(0, 1) truncated at +-2: std 0.8796
    for name, std in (("embed", 1.0), ("head", 32 ** -0.5)):
        p = params[name]
        assert float(p.abs().max()) <= 2 * std + 1e-6, name
        assert float(p.std()) == pytest.approx(0.8796 * std, rel=0.02), name
        assert float(p.mean()) == pytest.approx(0.0, abs=0.02 * std), name


@pytest.mark.parametrize("vocab", [4, 16, 50, 1000])
def test_byte_corpus_matches_jax(vocab):
    ids, v = byte_corpus(vocab, 32)
    want, wv = jax_byte_corpus(vocab, 32)
    assert v == wv and ids.dtype == want.dtype
    np.testing.assert_array_equal(ids, want)


@pytest.mark.parametrize("vocab,step", [(64, 0), (1024, 5), (49152, 2)])
def test_linear_model_batches_match_jax(vocab, step):
    got = linear_model_batches(vocab, seq_len=32, batch=8, seed=1).batch(step)
    want = jax_linear_batches(vocab, seq_len=32, batch=8, seed=1).batch(step)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# -- per-layer SNR, metadata helpers --------------------------------------------


@pytest.mark.parametrize("arch", ["gpt_small", "falcon_mamba_7b"])
def test_measure_leaf_snr_per_layer_matches_jax(arch):
    _, jmeta = jax_reduced(arch).abstract()
    specs = dict(flatten_with_names(get_reduced(arch).specs()))
    rng = np.random.default_rng(4)
    for name, jm in jax_flatten(jmeta)[0]:
        v = (rng.standard_normal(specs[name].shape) ** 2 + 1e-3).astype(np.float32)
        want = jax_snr_per_layer(jnp.asarray(v), jm)
        got = measure_leaf_snr_per_layer(torch.from_numpy(v), specs[name].meta())
        assert got.keys() == want.keys(), name
        for label in want:
            assert tuple(got[label].shape) == tuple(np.shape(want[label])), (name, label)
            assert_close(got[label], np.asarray(want[label]), TOL, f"{name} {label}")


def test_path_str_matches_jax():
    Pair = namedtuple("Pair", "left right")
    tree = {"blocks": {"slot_0": [np.zeros(1), Pair(np.zeros(1), {"x": np.zeros(1)})]}, "embed": np.zeros(1)}
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [path_str(p) for p in paths] == [jax_path_str(p) for p in paths] == [
        "blocks.slot_0.0", "blocks.slot_0.1.left", "blocks.slot_0.1.right.x", "embed"]
    assert path_str(("blocks", "slot_0", 3, "wq")) == "blocks.slot_0.3.wq"


_M2 = dict(axes=("embed", "mlp"), role="mlp_up", fan_in=("embed",), fan_out=("mlp",))
_M1 = dict(axes=("embed",), role="norm")
META_CASES = {   # (parameter shapes, meta fields or a stray leaf)
    "ok": ({"a": {"w": (4, 6)}, "b": (4,)}, {"a": {"w": _M2}, "b": _M1}),
    "missing leaf": ({"a": {"w": (4, 6)}, "b": (4,), "c": (2,)}, {"a": {"w": _M2}, "b": _M1}),
    "wrong ndim": ({"a": {"w": (4, 6, 2)}, "b": (4,)}, {"a": {"w": _M2}, "b": _M1}),
    "not a ParamMeta": ({"a": {"w": (4, 6)}, "b": (4,)}, {"a": {"w": _M2}, "b": "norm"}),
}


@pytest.mark.parametrize("case", list(META_CASES))
def test_validate_meta_raises_where_jax_raises(case):
    shapes, fields = META_CASES[case]

    def tree(node, leaf):
        if isinstance(node, dict) and "axes" not in node:
            return {k: tree(v, leaf) for k, v in node.items()}
        return leaf(node)

    outcomes = []
    for fn, zeros, meta_cls in ((jax_validate_meta, jnp.zeros, JaxParamMeta), (validate_meta, torch.zeros, ParamMeta)):
        try:
            fn(tree(shapes, zeros), tree(fields, lambda f: meta_cls(**f) if isinstance(f, dict) else f))
            outcomes.append(None)
        except (ValueError, TypeError) as e:
            outcomes.append(type(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (case == "ok")


@pytest.mark.parametrize("full", [True, False])
def test_gpt_medium_specs_and_meta_match_jax(full):
    jcfg = jax_config("gpt_medium") if full else jax_reduced("gpt_medium")
    cfg = get_config("gpt_medium") if full else get_reduced("gpt_medium")
    assert _spec_rows(flatten_with_names(cfg.specs())) == _jax_spec_rows(jcfg.specs())
    if full:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size) == (24, 1024, 16, 4096, 50304)
        assert cfg.param_count() == sum(math.prod(row[1]) for row in _jax_spec_rows(jcfg.specs())) == 354_599_936
    else:
        model = Transformer(cfg, device="cpu")
        validate_meta(model.params, model.meta)


# -- init schemes ------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["normal", "torch_default"])
def test_init_scheme_statistics_match_jax(scheme):
    """Full-width gpt_small under ``scheme``: per leaf, the port's mean and
    std within 2 % of the JAX package's draw (means against its std); every
    torch_default entry within +-1/sqrt(fan_in), fan_in the product of the
    per-layer shape's dims but the last."""
    import dataclasses

    jcfg = dataclasses.replace(jax_config("gpt_small"), init_scheme=scheme)
    jparams, _ = jcfg.init(jax.random.PRNGKey(0))
    want = {n: np.asarray(x) for n, x in jax_flatten(jparams)[0]}
    del jparams
    cfg = dataclasses.replace(get_config("gpt_small"), init_scheme=scheme)
    specs = dict(flatten_with_names(cfg.specs()))
    gen = torch.Generator().manual_seed(0)
    for name, spec in specs.items():
        p = spec.init(gen, spec.shape, spec.dtype)
        w = want[name]
        assert tuple(p.shape) == w.shape, name
        if name.endswith("scale"):
            assert torch.equal(p, torch.ones_like(p)) and np.all(w == 1), name
            continue
        jstd = float(w.std())
        assert float(p.std()) == pytest.approx(jstd, rel=0.02), name
        assert abs(float(p.mean()) - float(w.mean())) <= 0.02 * jstd, name
        if scheme == "torch_default":
            layer_shape = spec.shape[1:] if spec.axes[0] == "layers" else spec.shape
            bound = 1 / math.sqrt(math.prod(layer_shape[:-1]))
            assert float(p.abs().max()) <= bound * (1 + 1e-6), name
            assert float(np.abs(w).max()) <= bound * (1 + 1e-6), name
        else:
            assert jstd == pytest.approx(0.02, rel=0.02), name
