"""The rest of the dense zoo in the port against the JAX package on the CPU:
qwen15_32b (qkv biases), command_r_35b (LayerNorm, tied), deepseek_67b,
internvl2_26b (a VLM: frontend embeddings prepended), hubert_xlarge (an
encoder over frame embeddings) and vit_small (an encoder over patches),
from the JAX-initialised parameters carried across by
``repro_torch.convert``, in f32 on the reduced configs:

* the registry (all 13 architectures, the shape cells, the skip rules,
  ``input_specs``), the configs field for field, and every full config's
  abstract tree (names, shapes, dtypes, meta, ``param_count``) built on the
  ``meta`` device;
* forward logits, the loss and every leaf's gradient, one Table-3 SlimAdam
  update, the VLM's loss slice and the z-loss (1e-5 of each output's
  largest magnitude);
* ``flash_attention``'s output and gradients against JAX's custom VJP under
  ``jax.grad``, ``chunked_attention``, and whole models above a lowered
  ``attn_dense_threshold``, which take the flash path (1e-5);
* decode against JAX's decode and against the forward, the int8 KV cache
  against JAX's (logits 1e-5; quantized rows equal) and by the JAX test's
  two bars against the forward, the paged and legacy engines' greedy tokens
  against the JAX engine's (equal), and the serve and launch CLIs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, flat_numpy, jax_params
from repro import configs as jconfigs
from repro.core import rules_as_tree as jax_rules_as_tree, table3_rules as jax_table3
from repro.core.labels import flatten_with_names as jflat
from repro.core.slim_adam import slim_adam as jax_slim_adam
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serve import Engine as JaxEngine, Request as JaxRequest, ServeConfig as JaxServeConfig
from repro.train.loss import cross_entropy as jax_cross_entropy, lm_loss as jax_lm_loss
from repro_torch import configs
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import rules_as_tree, table3_rules
from repro_torch.core.slim_adam import slim_adam
from repro_torch.models import Transformer, attention as tattn, forward
from repro_torch.models import transformer as ttf
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.train.loss import cross_entropy, lm_loss

ARCHS = ("qwen15_32b", "command_r_35b", "deepseek_67b", "internvl2_26b", "hubert_xlarge", "vit_small")
DECODERS = ("qwen15_32b", "command_r_35b", "deepseek_67b", "internvl2_26b")
ENCODERS = ("hubert_xlarge", "vit_small")
TOL = 1e-5
LR = 3e-3


def _port(arch, **overrides):
    jcfg, jparams, jmeta, arrays = jax_params(seed=0, arch=arch)
    cfg = get_reduced(arch)
    if overrides:
        jcfg, cfg = dataclasses.replace(jcfg, **overrides), dataclasses.replace(cfg, **overrides)
    return jcfg, jparams, jmeta, cfg, params_from_numpy(arrays, "cpu")


def _batch(cfg, seed=3, b=2, s=24):
    """One numpy batch of the model's input kind: tokens (and the VLM's
    frontend embeddings), patches, or frame embeddings, with labels."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    if cfg.embed_inputs:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
        if cfg.extra_embed_len:
            batch["frontend_embeds"] = rng.standard_normal((b, cfg.extra_embed_len, cfg.d_model)).astype(np.float32)
    elif cfg.input_proj_dim:
        batch["patches"] = rng.standard_normal((b, s, cfg.input_proj_dim)).astype(np.float32)
    else:
        batch["frontend_embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()}, {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# Registry, configs and specs
# ---------------------------------------------------------------------------


def test_registry_equals_jax():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS and len(configs.ARCH_IDS) == 13
    assert configs.SHAPES == jconfigs.SHAPES
    assert configs.SSM_OR_HYBRID == jconfigs.SSM_OR_HYBRID and configs.ENCODER_ONLY == jconfigs.ENCODER_ONLY
    for arch in configs.ARCH_IDS:
        for shape in configs.SHAPES:
            assert configs.cell_supported(arch, shape) == jconfigs.cell_supported(arch, shape), (arch, shape)
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("gpt_large")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_equal_jax(arch):
    for shape, (_, _, kind) in configs.SHAPES.items():
        if kind == "decode":
            with pytest.raises(ValueError):
                configs.input_specs(get_config(arch), shape)
            continue
        got = configs.input_specs(get_config(arch), shape)
        want = jconfigs.input_specs(jconfigs.get_config(arch), shape)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == (want[k].shape, jnp.dtype(want[k].dtype).name)


def _fields_equal(mine, theirs):
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name, f.name
        elif f.name == "pattern":
            assert [(s.mixer, s.ffn) for s in a] == [(s.mixer, s.ffn) for s in b]
        else:
            assert a == b, (f.name, a, b)
    assert dataclasses.asdict(mine.attn_cfg()) == dataclasses.asdict(theirs.attn_cfg())


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax_field_for_field(arch):
    _fields_equal(get_config(arch), jconfigs.get_config(arch))
    _fields_equal(get_reduced(arch), jconfigs.get_reduced(arch))
    if arch == "qwen15_32b":
        from repro.configs import qwen15_32b as jq
        from repro_torch.configs import qwen15_32b as tq

        _fields_equal(tq.optimized(), jq.optimized())
        assert tq.optimized().kv_quant


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_full_abstract_trees_equal_jax(arch):
    """The whole configuration's tree on the meta device: names, shapes,
    dtypes, meta and the parameter count, with nothing allocated."""
    jtree, jmeta = jconfigs.get_config(arch).abstract()
    tree, meta = get_config(arch).abstract()
    want = jflat(jtree)[0]
    assert [(n, tuple(t.shape), str(t.dtype).split(".")[-1]) for n, t in tree.items()] == \
        [(n, tuple(a.shape), jnp.dtype(a.dtype).name) for n, a in want]
    assert all(t.device.type == "meta" for t in tree.values())
    assert [dataclasses.astuple(m) for m in meta.values()] == [dataclasses.astuple(m) for _, m in jflat(jmeta)[0]]
    assert get_config(arch).param_count() == jconfigs.get_config(arch).param_count()
    counts = {"deepseek_67b": 67_425_001_472, "hubert_xlarge": 944_487_680, "vit_small": 85_237_248}
    if arch in counts:
        assert get_config(arch).param_count() == counts[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_match_jax(arch):
    _, _, jmeta, arrays = jax_params(seed=0, arch=arch)
    model = Transformer(get_reduced(arch), device="cpu")
    assert list(model.names) == list(arrays)
    assert [tuple(p.shape) for p in model.params.values()] == [a.shape for a in arrays.values()]
    assert ([dataclasses.astuple(m) for m in model.meta.values()]
            == [dataclasses.astuple(m) for _, m in jflat(jmeta)[0]])
    new = {"qwen15_32b": {"blocks.slot_0.attn.bq", "blocks.slot_0.attn.bk", "blocks.slot_0.attn.bv"},
           "vit_small": {"input_proj", "pos_embed", "lm_head"}, "hubert_xlarge": {"lm_head"},
           "command_r_35b": {"embed"}, "internvl2_26b": {"embed", "lm_head"}}.get(arch, set())
    assert new <= set(model.names)
    assert ("embed" in model.names) == get_reduced(arch).embed_inputs
    assert ("lm_head" in model.names) == (arch != "command_r_35b")
    if arch == "qwen15_32b":
        assert model.meta["blocks.slot_0.attn.bq"].role == "attn_qkv_bias"
        assert all(not model.params[f"blocks.slot_0.attn.b{x}"].any() for x in "qkv")   # zero-initialised


# ---------------------------------------------------------------------------
# Forward, loss, gradients, one optimizer step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    jcfg, jparams, _, cfg, params = _port(arch)
    jb, tb = _both(_batch(cfg))
    jl, _ = jtf.forward(jcfg, jparams, {k: v for k, v in jb.items() if k != "labels"})
    tl, taux = forward(cfg, params, {k: v for k, v in tb.items() if k != "labels"})
    expect_s = 24 + (cfg.extra_embed_len if cfg.embed_inputs else 0)
    assert tuple(tl.shape) == (2, expect_s, cfg.vocab_size) and float(taux) == 0.0
    assert_close(tl.detach(), jl, TOL, "logits")


def _value_and_grads(arch):
    jcfg, jparams, _, cfg, params = _port(arch)
    jb, tb = _both(_batch(cfg, seed=4))
    (jloss, _), jgrads = jax.value_and_grad(lambda p: jax_lm_loss(jcfg, p, jb, jtf.forward), has_aux=True)(jparams)
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = lm_loss(cfg, params, tb, forward)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    return float(jloss), flat_numpy(jgrads), float(loss.detach()), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jloss, want, loss, grads = _value_and_grads(arch)
    np.testing.assert_allclose(loss, jloss, rtol=TOL)
    assert list(grads) == list(want)
    for name, g in grads.items():
        assert_close(g.numpy(), want[name], TOL, name)
    if arch == "qwen15_32b":
        assert all(float(grads[f"blocks.slot_0.attn.b{x}"].abs().max()) > 0 for x in "qkv")
    if arch == "vit_small":
        assert float(grads["input_proj"].abs().max()) > 0 and float(grads["pos_embed"][24:].abs().max()) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_one_table3_slim_step_matches_jax(arch):
    jcfg, jparams, jmeta, cfg, params = _port(arch)
    meta = Transformer(cfg, device="cpu").meta
    rules = table3_rules(meta)
    assert rules == dict(jax_table3(jmeta))
    jtx = jax_slim_adam(LR, jax_rules_as_tree(jax_table3(jmeta), jparams, jmeta), backend="jnp")
    ttx = slim_adam(LR, rules_as_tree(rules, params, meta), backend="fused")
    rng = np.random.default_rng(7)
    g = {k: (0.05 * rng.standard_normal(tuple(p.shape))).astype(np.float32) for k, p in params.items()}
    jgrads = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jparams), [jnp.asarray(g[k]) for k in params])
    jupd, _ = jtx.update(jgrads, jtx.init(jparams), jparams)
    with torch.no_grad():
        tupd, _ = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ttx.init(params), params)
    for k, u in flat_numpy(jupd).items():
        assert_close(tupd[k], u, TOL, f"update {k}")


def test_vlm_loss_scores_only_the_text_positions():
    jcfg, jparams, _, cfg, params = _port("internvl2_26b")
    jb, tb = _both(_batch(cfg, seed=6))
    logits, _ = forward(cfg, params, {k: v for k, v in tb.items() if k != "labels"})
    assert logits.shape[1] == cfg.extra_embed_len + tb["labels"].shape[1]
    loss, metrics = lm_loss(cfg, params, tb, forward)
    np.testing.assert_allclose(float(loss), float(cross_entropy(logits[:, cfg.extra_embed_len:], tb["labels"])),
                               rtol=1e-6)
    jloss, _ = jax_lm_loss(jcfg, jparams, jb, jtf.forward)
    np.testing.assert_allclose(float(metrics["ce"]), float(jloss), rtol=TOL)


def test_lm_loss_keeps_a_classifiers_labels():
    """The VLM slice applies to sequences only: ResNet's (B, classes)
    logits with (B,) labels still train through ``make_train_step``."""
    from repro_torch.models import resnet
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    cfg = resnet.ResNetConfig(stages=(1, 1), width=8, classes=10)
    model = resnet.ResNet(cfg, device="cpu")
    batch = resnet.synthetic_cifar(torch.Generator().manual_seed(1), 4, 10, size=8)
    loss, _ = lm_loss(cfg, model.params, batch, resnet.forward)
    logits, _ = resnet.forward(cfg, model.params, batch)
    np.testing.assert_allclose(float(loss), float(cross_entropy(logits, batch["labels"])), rtol=1e-6)
    tx = adamw(1e-3)
    step = make_train_step(model, tx, forward_fn=resnet.forward)
    _, metrics = step(tx.init(model.params), batch)
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("z_coef", [0.0, 1e-4, 0.1])
def test_cross_entropy_z_loss_matches_jax(z_coef):
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((2, 5, 17))).astype(np.float32)
    labels = rng.integers(0, 17, (2, 5), dtype=np.int32)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), z_coef=z_coef)
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_coef=z_coef)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


# ---------------------------------------------------------------------------
# Chunked and flash attention
# ---------------------------------------------------------------------------


def _qkv(seed, b=2, s=40, h=4, kv=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


@pytest.mark.parametrize("pref,block", [(16, 10), (9, 8), (40, 40), (64, 40), (7, 5)])
def test_largest_block_equals_jax(pref, block):
    assert tattn._largest_block(40, pref) == jattn._largest_block(40, pref) == block
    assert tattn._largest_block(4352, 1024) == jattn._largest_block(4352, 1024) == 544


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pref", [16, 9])
@pytest.mark.parametrize("kv", [4, 2, 1])
def test_flash_attention_and_its_gradients_match_jax(causal, pref, kv):
    """Output and dq/dk/dv of ``flash_attention`` over K/V repeated to the
    query heads (GQA), against JAX's custom VJP under ``jax.grad``."""
    q, k, v = _qkv(11 + kv, kv=kv)
    rep = 4 // kv
    block = tattn._largest_block(40, pref)
    w = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jattn.flash_attention(q_, jattn._repeat_kv(k_, rep), jattn._repeat_kv(v_, rep), causal, block)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tattn.flash_attention(tq, tattn._repeat_kv(tk, rep), tattn._repeat_kv(tv, rep), causal, block)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    assert_close(out.detach(), jout, TOL, "out")
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        assert_close(g, jg, TOL, name)
    dense = tattn.dense_attention(tq, tattn._repeat_kv(tk, rep), tattn._repeat_kv(tv, rep), causal=causal)
    assert_close(out.detach(), dense.detach(), TOL, "flash against dense")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_block", [8, 40, 64])
def test_chunked_attention_matches_jax(causal, kv_block):
    q, k, v = _qkv(5, kv=4)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal, kv_block=kv_block)
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, kv_block=kv_block)
    assert_close(got, want, TOL, "chunked")
    with pytest.raises(ValueError, match="divisible"):
        tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, kv_block=12)


@pytest.mark.parametrize("arch", ["qwen15_32b", "hubert_xlarge", "internvl2_26b"])
def test_models_above_the_dense_threshold_take_the_flash_path(arch, monkeypatch):
    """A reduced model at S = 40 with ``attn_dense_threshold`` 16 and
    ``attn_kv_block`` 16: logits, loss and gradients against JAX's on the
    same overrides, every attention layer through ``flash_attention``."""
    calls = {"flash": 0, "dense": 0}
    flash, dense = tattn.flash_attention, tattn.dense_attention

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tattn, "flash_attention", count("flash", flash))
    monkeypatch.setattr(tattn, "dense_attention", count("dense", dense))
    jloss, want, loss, grads = _flash_model(arch)
    assert calls == {"flash": get_reduced(arch).n_layers, "dense": 0}
    np.testing.assert_allclose(loss, jloss, rtol=TOL)
    for name, g in grads.items():
        assert_close(g.numpy(), want[name], TOL, name)


def _flash_model(arch):
    over = dict(attn_dense_threshold=16, attn_kv_block=16)
    jcfg, jparams, _, cfg, params = _port(arch, **over)
    jb, tb = _both(_batch(cfg, seed=8, s=40 - (cfg.extra_embed_len if cfg.embed_inputs else 0)))
    (jloss, _), jgrads = jax.value_and_grad(lambda p: jax_lm_loss(jcfg, p, jb, jtf.forward), has_aux=True)(jparams)
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = lm_loss(cfg, params, tb, forward)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    return float(jloss), flat_numpy(jgrads), float(loss.detach()), grads


# ---------------------------------------------------------------------------
# Decode, the int8 cache, serving
# ---------------------------------------------------------------------------


def _decode_run(mod, cfg, params, tokens, dtype, **kw):
    cache = mod.init_decode_cache(cfg, tokens.shape[0], 16, dtype, **kw)
    out = []
    for t in range(tokens.shape[1]):
        step = tokens[:, t:t + 1]
        lg, cache = mod.decode_step(cfg, params, cache, jnp.asarray(step) if mod is jtf else torch.from_numpy(step))
        out.append(np.asarray(lg) if mod is jtf else lg.numpy())
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_jax_and_the_forward(arch):
    jcfg, jparams, _, cfg, params = _port(arch)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 10), dtype=np.int32)
    want = _decode_run(jtf, jcfg, jparams, tokens, jnp.float32)
    got = _decode_run(ttf, cfg, params, tokens, torch.float32)
    assert_close(got, want, TOL, "decode")
    batch = {"tokens": torch.from_numpy(tokens)}
    if cfg.extra_embed_len:     # the text alone, as the decode step sees it
        batch["frontend_embeds"] = torch.zeros((3, 0, cfg.d_model))
    full, _ = forward(cfg, params, batch)
    assert_close(got, full.detach(), TOL, "decode against the forward")


def test_int8_cache_quantizes_as_jax_does():
    x = np.random.default_rng(3).standard_normal((2, 3, 4, 16)).astype(np.float32) * 2.5
    x[0, 0, 0] = 0.0
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    tq, ts = tattn._quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (2, 3, 4)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    cache = tattn.init_kv_cache(2, 8, 4, 16, quant=True)
    assert cache.quantized and cache.k.dtype == torch.int8 and tuple(cache.k_scale.shape) == (2, 8, 4)
    assert not tattn.init_kv_cache(2, 8, 4, 16, torch.float32).quantized


def test_int8_cache_decode_matches_jax_and_the_forward():
    """qwen15_32b's ``optimized()`` cache on the reduced model: decode
    logits against JAX's ``attention_decode`` on its quantized cache (1e-5),
    and against the forward by the JAX test's bars (within 5 % of max|logit|,
    greedy agreement above 95 %)."""
    jcfg, jparams, _, cfg, params = _port("qwen15_32b", kv_quant=True)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    want = _decode_run(jtf, jcfg, jparams, tokens, jnp.float32)
    got = _decode_run(ttf, cfg, params, tokens, torch.float32)
    assert_close(got, want, TOL, "int8 decode")
    full, _ = forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    full = full.detach().numpy()
    rel = np.abs(got - full).max() / np.abs(full).max()
    agree = np.mean(got.argmax(-1) == full.argmax(-1))
    assert rel < 0.05 and agree > 0.95, (rel, agree)
    cache = ttf.init_decode_cache(cfg, 2, 16, torch.float32)
    assert cache.slots["slot_0"].k.dtype == torch.int8 and not ttf.supports_paged(cfg)


def test_paged_support_follows_jax():
    for arch in configs.ARCH_IDS:
        for cfg, jcfg in ((get_reduced(arch), jconfigs.get_reduced(arch)),
                          (get_config(arch), jconfigs.get_config(arch))):
            assert ttf.supports_paged(cfg) == jtf.supports_paged(jcfg), arch
    assert ttf.supports_paged(get_config("internvl2_26b"))
    assert not any(ttf.supports_paged(get_config(a)) for a in ENCODERS)


@pytest.mark.parametrize("arch", ENCODERS)
def test_encoders_take_no_serving_path(arch):
    cfg = get_reduced(arch)
    params = Transformer(cfg, device="cpu").params
    eng = Engine(cfg, params, ServeConfig(max_seq=32), device="cpu")
    with pytest.raises(NotImplementedError, match="paged fast path"):
        eng.submit(Request(prompt=np.arange(4, dtype=np.int32)))
    with pytest.raises(NotImplementedError, match="encoder-only"):
        eng.generate(np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="outside the paged serving path"):
        Engine(cfg, params, ServeConfig(max_seq=32, paged=True), device="cpu")
    from repro_torch.serve.__main__ import main as serve_cli

    with pytest.raises(NotImplementedError, match="encoder-only"):
        serve_cli(["--arch", arch, "--device", "cpu"])


@pytest.mark.parametrize("arch", DECODERS)
def test_paged_engine_tokens_match_the_jax_engine(arch):
    jcfg, jparams, _, cfg, params = _port(arch)
    kw = dict(max_seq=32, max_new_tokens=4, max_slots=2, page_size=8)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32) for n in rng.integers(3, 12, 4)]
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    jrids = [jeng.submit(JaxRequest(prompt=p)) for p in prompts]
    jdone = jeng.run_until_drained()
    eng = Engine(cfg, params, ServeConfig(**kw), device="cpu")
    rids = [eng.submit(Request(prompt=p)) for p in prompts]
    done = eng.run_until_drained()
    for jr, r in zip(jrids, rids):
        np.testing.assert_array_equal(done[r].tokens, jdone[jr].tokens)


def test_int8_legacy_loop_tokens_match_the_jax_engine():
    jcfg, jparams, _, cfg, params = _port("qwen15_32b", kv_quant=True)
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (3, 7), dtype=np.int32)
    want = JaxEngine(jcfg, jparams, JaxServeConfig(max_seq=24, max_new_tokens=6)).generate(jnp.asarray(prompts))
    eng = Engine(cfg, params, ServeConfig(max_seq=24, max_new_tokens=6), device="cpu")
    got = eng.generate(prompts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert eng.decode_steps == 7 + 5


@pytest.mark.parametrize("arch,flags,legacy", [("qwen15_32b", [], False), ("qwen15_32b", ["--optimized"], True),
                                               ("command_r_35b", [], False), ("deepseek_67b", [], False),
                                               ("internvl2_26b", [], False)])
def test_serve_cli_serves_the_dense_decoders(arch, flags, legacy, capsys):
    from repro_torch.serve.__main__ import main as serve_cli

    out = serve_cli(["--arch", arch, "--device", "cpu", "--requests", "2", "--new-tokens", "3"] + flags)
    text = capsys.readouterr().out
    assert ("legacy loop" in text) == legacy and f"arch={arch}_reduced" in text
    if legacy:
        assert out.shape == (2, 8 + 3)
    else:
        assert all(len(c.tokens) == 3 and c.finish_reason == "length" for c in out.values())


def test_get_optimized_is_the_arch_modules_variant():
    """``get_optimized``: qwen15_32b's ``optimized()`` whole, and its change
    (the int8 KV cache) applied to ``reduced()``; an architecture without the
    variant raises, as JAX's dry-run does, and so does the serve CLI."""
    from repro_torch.configs import get_optimized, qwen15_32b as tq
    from repro_torch.serve.__main__ import main as serve_cli

    assert get_optimized("qwen15_32b") == tq.optimized()
    assert get_optimized("qwen15_32b", reduced=True) == dataclasses.replace(get_reduced("qwen15_32b"), kv_quant=True)
    for arch in ("command_r_35b", "hubert_xlarge"):
        with pytest.raises(ValueError, match="optimized"):
            get_optimized(arch)
    with pytest.raises(ValueError, match="optimized"):
        serve_cli(["--arch", "command_r_35b", "--optimized", "--device", "cpu"])


def test_launch_cli_trains_reduced_qwen_and_refuses_the_frontends(capsys):
    from repro_torch.launch.train import main as launch_main

    launch_main(["--arch", "qwen15_32b", "--reduced", "--device", "cpu", "--steps", "3", "--seq", "16",
                 "--batch", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss ")[1].split()[0]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses)), out
    for arch in ENCODERS + ("internvl2_26b",):
        with pytest.raises(ValueError, match="token"):
            launch_main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1"])
