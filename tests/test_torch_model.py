"""The port's gpt_small forward, loss and gradients against the JAX model, at
reduced size in f32, from the JAX-initialised parameters carried across by
``repro_torch.convert``. Tolerances: logits and loss within 1e-5 relative
(to the largest magnitude); every gradient within 1e-4 of its tensor's
largest magnitude (backward sums run in a different order). The port's own
initialiser is compared by statistics only: the two packages draw different
random bits from one seed.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, flat_numpy, jax_params
from repro.configs import get_config as jax_config
from repro.core.labels import flatten_with_names as jflat
from repro.data import DataConfig as JaxDataConfig, ZipfLM as JaxZipfLM
from repro.models.transformer import forward as jax_forward
from repro.train.loss import lm_loss as jax_lm_loss
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.labels import flatten_with_names
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import DataConfig, ZipfLM
from repro_torch.models import Transformer, forward
from repro_torch.train.loss import lm_loss


def _setup():
    jcfg, jparams, _, arrays = jax_params(seed=0)
    model = Transformer(get_reduced("gpt_small"), device="cpu")
    model.load_params(params_from_numpy(arrays, "cpu"))
    batch = JaxZipfLM(JaxDataConfig(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=2)).batch(3)
    return jcfg, jparams, model, batch


def test_param_tree_matches_jax_names_shapes_and_order():
    _, _, _, arrays = jax_params()
    model = Transformer(get_reduced("gpt_small"), device="cpu")
    assert list(model.names) == list(arrays)
    assert [tuple(p.shape) for p in model.params.values()] == [a.shape for a in arrays.values()]
    back = params_to_numpy(params_from_numpy(arrays, "cpu"))
    assert list(back) == list(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a)


def test_full_width_tree_and_meta_match_jax():
    jparams, jmeta = jax_config("gpt_small").abstract()
    cfg = get_config("gpt_small")
    specs = dict(flatten_with_names(cfg.specs()))
    want = [(n, tuple(p.shape)) for n, p in jflat(jparams)[0]]
    assert [(n, s.shape) for n, s in specs.items()] == want
    assert ([dataclasses.astuple(s.meta()) for s in specs.values()]
            == [dataclasses.astuple(m) for _, m in jflat(jmeta)[0]])
    assert cfg.param_count() == 124_373_760


def test_data_batches_match_jax():
    want = JaxZipfLM(JaxDataConfig(vocab_size=211, seq_len=16, global_batch=3, seed=4)).batch(7)
    got = ZipfLM(DataConfig(vocab_size=211, seq_len=16, global_batch=3, seed=4)).batch(7)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_forward_and_loss_match_jax():
    jcfg, jparams, model, batch = _setup()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = jax_forward(jcfg, jparams, jbatch)
    jloss, _ = jax_lm_loss(jcfg, jparams, jbatch, jax_forward)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = model(tbatch)
        loss, _ = lm_loss(model.cfg, model.params, tbatch, forward)
    assert_close(logits, jlogits, 1e-5, "logits")
    assert_close(loss, jloss, 1e-5, "loss")


def test_gradients_match_jax():
    jcfg, jparams, model, batch = _setup()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = flat_numpy(jax.grad(lambda p: jax_lm_loss(jcfg, p, jbatch, jax_forward)[0])(jparams))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = lm_loss(model.cfg, model.params, tbatch, forward)
    grads = torch.autograd.grad(loss, list(model.params.values()))
    assert list(jgrads) == list(model.names)
    for name, g in zip(model.names, grads):
        assert_close(g, jgrads[name], 1e-4, name)


def test_remat_leaves_forward_and_gradients_unchanged():
    _, _, model, batch = _setup()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(model.cfg, remat=remat)
        loss, _ = lm_loss(cfg, model.params, tbatch, forward)
        out.append([loss] + list(torch.autograd.grad(loss, list(model.params.values()))))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_own_init_statistics():
    cfg = get_reduced("gpt_small")
    params = Transformer(cfg, device="cpu", gen=torch.Generator().manual_seed(3)).params
    params = {k: p.detach() for k, p in params.items()}
    resid = 0.02 / math.sqrt(2 * cfg.n_layers)
    for name, p in params.items():
        if name.endswith("scale"):
            assert torch.equal(p, torch.ones_like(p)), name
            continue
        want = resid if name.endswith(("attn.wo", "mlp.w_down")) else 0.02
        assert float(p.mean()) == pytest.approx(0.0, abs=0.05 * want), name
        assert float(p.std()) == pytest.approx(want, rel=0.05), name
