"""The port's SSM slice (the selective scan's plain twin, the Mamba block,
the falcon_mamba_7b model's forward and decode step) against the JAX package
on the CPU, at reduced size in f32 (4 layers, d_model 64, d_state 4), from
the JAX-initialised parameters carried across by ``repro_torch.convert``.

Tolerances, relative to each output's largest magnitude: 2e-6 for the scan
against the Pallas kernel in interpret mode (the same sequential recurrence;
the N-term sum of y runs in another order) and 2e-5 against the JAX model's
chunked associative scan (a differently structured sum); 1e-5 for the Mamba
block, the model's logits and the decode caches, and for the scan's
gradients against ``jax.grad`` through the JAX package's custom VJP and
against autograd through the plain forward. ``a_log`` must be bit-equal.
On the CPU the scan's wrappers run their plain twins.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, jax_params
from repro.configs import get_config as jax_config
from repro.core.labels import flatten_with_names as jflat
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro.models import ssm as jssm, transformer as jtf
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.labels import flatten_with_names
from repro_torch.data import DataConfig, ZipfLM
from repro_torch.kernels import ssm_scan as tscan
from repro_torch.models import Transformer, forward
from repro_torch.models import ssm as tssm, transformer as ttf
from repro_torch.train.step import make_eval_step

SCAN_KERNEL = 2e-6
SCAN_ORACLE = 2e-5
MODEL = 1e-5
ARCH = "falcon_mamba_7b"


def _scan_inputs(b, s, d, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)))).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal((d, n))).astype(np.float32)
    b_t = rng.standard_normal((b, s, n)).astype(np.float32)
    c_t = rng.standard_normal((b, s, n)).astype(np.float32)
    d_skip = rng.standard_normal((d,)).astype(np.float32)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32)
    return x, dt, a, b_t, c_t, d_skip, h0


# tests/test_kernels.py's three shapes, plus the decode form (S = 1).
@pytest.mark.parametrize("shape", [(2, 24, 8, 4), (1, 64, 16, 16), (2, 32, 10, 3), (4, 1, 16, 4)])
def test_ssm_scan_plain_matches_jax_kernel_and_oracle(shape):
    b, s, d, n = shape
    args = _scan_inputs(b, s, d, n, b * s + d)
    y, h = tscan.ssm_scan(*map(torch.from_numpy, args))
    y_k, h_k = jax_ssm_scan(*map(jnp.asarray, args), chunk=8, d_tile=4)
    assert_close(y, y_k, SCAN_KERNEL, "y vs Pallas")
    assert_close(h, h_k, SCAN_KERNEL, "h vs Pallas")
    y_o, h_o = jssm.selective_scan(*map(jnp.asarray, args), 8)
    assert_close(y, y_o, SCAN_ORACLE, "y vs selective_scan")
    assert_close(h, h_o, SCAN_ORACLE, "h vs selective_scan")


def test_selective_scan_casts_y():
    args = [torch.from_numpy(a) for a in _scan_inputs(1, 5, 8, 4, 1)]
    y, h = tssm.selective_scan(args[0].to(torch.bfloat16), args[1], args[2], args[3].to(torch.bfloat16),
                               args[4].to(torch.bfloat16), args[5], args[6])
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


# -- the scan's gradients ------------------------------------------------------
# ``ssm_scan_bwd`` (the plain twin on the CPU) and ``selective_scan``'s
# backward against jax.grad through the JAX package's custom VJP (its
# chunked replay at the chunk given) and torch.autograd through the plain
# forward, each gradient within GRAD of its largest magnitude, in f32; bf16
# operands reach JAX as the f32 values of their bf16 rounding.
GRAD = 1e-5
GRAD_NAMES = ("dx", "ddt", "da", "db", "dc", "dd_skip", "dh0")


def _grad_case(b, s, d, n, dtype, dh_random, seed):
    """Numpy operands (bf16 ones rounded through torch), their torch twins,
    dy in the operands' dtype and dh_final (zero or random)."""
    arrays = list(_scan_inputs(b, s, d, n, seed))
    rng = np.random.default_rng(seed + 1)
    ts = [torch.from_numpy(v) for v in arrays]
    dy = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(dtype)
    for i in (0, 3, 4):
        ts[i] = ts[i].to(dtype)
    dhf = rng.standard_normal((b, d, n)).astype(np.float32) if dh_random else np.zeros((b, d, n), np.float32)
    return [t.float().numpy() for t in ts], ts, dy, torch.from_numpy(dhf)


def _jax_grads(arrays, dy, dhf, chunk):
    def loss(*args):
        y, h = jssm.selective_scan(*args, chunk)
        return jnp.sum(y * dy) + jnp.sum(h * dhf)

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, arrays))]


# (b, s, d, n, the JAX scan's chunk): S = 1, 17 and 300; N = 1, 3 and 16;
# one chunk, chunks that divide S and a chunk of 1 step (S = 17 is prime).
GRAD_SHAPES = [(2, 1, 8, 3, 8), (1, 17, 5, 16, 8), (2, 17, 6, 1, 32), (1, 300, 4, 3, 64), (2, 300, 3, 16, 8)]


@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh_random", [False, True], ids=["dh0", "dh"])
def test_scan_gradients_match_jax_custom_vjp(shape, dtype, dh_random):
    b, s, d, n, chunk = shape
    arrays, ts, dy, dhf = _grad_case(b, s, d, n, dtype, dh_random, b * s + d + n)
    want = _jax_grads(arrays, dy.float().numpy(), dhf.numpy(), chunk)
    plain = tscan.ssm_scan_bwd_plain(*ts, dy, dhf if dh_random else None)
    got = tscan.ssm_scan_bwd(*ts, dy, dhf if dh_random else None)
    for name, p, g, w in zip(GRAD_NAMES, plain, got, want):
        assert p.dtype == torch.float32 and tuple(p.shape) == w.shape, name
        assert_close(p, w, GRAD, f"{name} vs jax.grad")
        # the wrapper on CPU tensors: the twin's values, dx in x's dtype as the kernel stores it
        assert g.dtype == (ts[0].dtype if name == "dx" else torch.float32), name
        assert torch.equal(g, p.to(g.dtype)), name
    # the model's autograd function: the same gradients, cast to each input's dtype
    leaves = [t.clone().requires_grad_(True) for t in ts]
    y, h = tssm.selective_scan(*leaves)
    torch.autograd.backward([y, h] if dh_random else [y], [dy, dhf] if dh_random else [dy])
    for name, t, g in zip(GRAD_NAMES, leaves, got):
        assert t.grad.dtype == t.dtype, name
        assert torch.equal(t.grad, g.to(t.dtype)), name


@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=str)
def test_scan_gradients_match_autograd_through_the_plain_forward(shape):
    b, s, d, n, _ = shape
    _, ts, dy, dhf = _grad_case(b, s, d, n, torch.float32, True, 7 * s + n)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    y, h = tscan.ssm_scan_plain(*leaves)
    ((y * dy).sum() + (h * dhf).sum()).backward()
    got = tscan.ssm_scan_bwd_plain(*ts, dy, dhf)
    for name, t, g in zip(GRAD_NAMES, leaves, got):
        assert_close(g, t.grad, GRAD, f"{name} vs autograd")


def test_selective_scan_backward_takes_only_the_cotangents_it_gets():
    """h_final ignored (as ``ssm_forward`` does): dh_final is None and the
    backward equals one given zeros; y ignored: dy is zero."""
    _, ts, dy, dhf = _grad_case(2, 9, 4, 3, torch.float32, True, 0)
    grads = []
    for use_h in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in ts]
        y, h = tssm.selective_scan(*leaves)
        ((y * dy).sum() + (h * 0.0).sum() if use_h else (y * dy).sum()).backward()
        grads.append([t.grad for t in leaves])
    for g0, g1 in zip(*grads):
        assert torch.equal(g0, g1)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    _, h = tssm.selective_scan(*leaves)
    (h * dhf).sum().backward()
    want = tscan.ssm_scan_bwd_plain(*ts, torch.zeros_like(dy), dhf)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def _port(arch=ARCH):
    jcfg, jparams, _, arrays = jax_params(seed=0, arch=arch)
    return jcfg, jparams, get_reduced(arch), params_from_numpy(arrays, "cpu")


def test_param_tree_matches_jax_and_loads_through_convert():
    jcfg, jparams, cfg, params = _port()
    model = Transformer(cfg, device="cpu")
    _, _, _, arrays = jax_params(seed=0, arch=ARCH)
    assert list(model.names) == list(arrays)
    assert [tuple(p.shape) for p in model.params.values()] == [a.shape for a in arrays.values()]
    model.load_params(params)
    for name, a in params_to_numpy(model.params).items():
        np.testing.assert_array_equal(a, arrays[name])
    # the full-width tree, meta and count
    jfull, jmeta = jax_config(ARCH).abstract()
    full = get_config(ARCH)
    specs = dict(flatten_with_names(full.specs()))
    assert [(n, s.shape) for n, s in specs.items()] == [(n, tuple(p.shape)) for n, p in jflat(jfull)[0]]
    assert ([dataclasses.astuple(s.meta()) for s in specs.values()]
            == [dataclasses.astuple(m) for _, m in jflat(jmeta)[0]])
    assert full.param_count() == 7_006_326_784


def test_deterministic_inits_equal_jax():
    """a_log (S4D-real), d_skip, dt_bias and the biases are deterministic:
    bit-equal to JAX's; the random leaves match its distributions' bounds."""
    _, _, cfg, jax_side = _port()
    mine = Transformer(cfg, device="cpu", gen=torch.Generator().manual_seed(3)).params
    for leaf in ("a_log", "d_skip", "dt_bias", "conv_b"):
        name = f"blocks.slot_0.ssm.{leaf}"
        np.testing.assert_array_equal(mine[name].detach().numpy(), jax_side[name].numpy(), err_msg=leaf)
    bound = cfg.ssm_cfg().rank ** -0.5
    dt_proj = mine["blocks.slot_0.ssm.dt_proj"].detach()
    assert float(dt_proj.abs().max()) <= bound and float(dt_proj.abs().max()) > 0.5 * bound


def test_cpu_generator_gives_the_same_weights_as_before():
    """Initializers now draw on the generator's device; a CPU generator must
    still give gpt_small's and smollm_135m's full-size weights bit for bit
    (SHA-256 over names and bytes, recorded from the tree before the change)."""
    want = {"gpt_small": "8965c681b36e409dbb3b9f78a3380bd1f6cc416b3dffd9987e0dee4ec5a85bac",
            "smollm_135m": "eb9a3a647887e6ea115f33298cf3a5ce62f315ac51c56d9575e1474665dae82c"}
    for arch, digest in want.items():
        params = get_config(arch).init(torch.Generator().manual_seed(0), "cpu")[0]
        h = hashlib.sha256()
        for name, t in params.items():
            h.update(name.encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
        assert h.hexdigest() == digest, arch


def _block_params(params, layer):
    prefix = "blocks.slot_0.ssm."
    return {k[len(prefix):]: v[layer] for k, v in params.items() if k.startswith(prefix)}


def test_ssm_forward_and_decode_match_jax():
    jcfg, jparams, cfg, params = _port()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["slot_0"]["ssm"])
    tp = _block_params(params, 1)
    scfg = cfg.ssm_cfg()
    want = jssm.ssm_forward(jp, jnp.asarray(x), jcfg.ssm_cfg())
    assert_close(tssm.ssm_forward(tp, torch.from_numpy(x), scfg), want, MODEL, "ssm_forward")
    # decode from a random cache, three steps
    conv = rng.standard_normal((2, scfg.d_conv - 1, scfg.d_inner)).astype(np.float32)
    h = rng.standard_normal((2, scfg.d_inner, scfg.d_state)).astype(np.float32)
    jc = jssm.SSMCache(conv=jnp.asarray(conv), h=jnp.asarray(h))
    tc = tssm.SSMCache(conv=torch.from_numpy(conv), h=torch.from_numpy(h))
    for t in range(3):
        jy, jc = jssm.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg.ssm_cfg())
        ty, tc = tssm.ssm_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc, scfg)
        assert_close(ty, jy, MODEL, f"decode y {t}")
        assert_close(tc.conv, jc.conv, MODEL, f"decode conv {t}")
        assert_close(tc.h, jc.h, MODEL, f"decode h {t}")


def test_forward_logits_match_jax():
    jcfg, jparams, cfg, params = _port()
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
    want, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert_close(got, want, MODEL, "logits")
    plain, _ = forward(cfg, params, {"tokens": torch.from_numpy(tokens)}, ssm_impl="plain")
    assert torch.equal(plain, got)   # on the CPU the kernel's wrapper runs the twin


def test_decode_steps_match_jax_logits_and_caches():
    jcfg, jparams, cfg, params = _port()
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 8), dtype=np.int32)
    jcache = jtf.init_decode_cache(jcfg, 3, 16, dtype=jnp.float32)
    tcache = ttf.init_decode_cache(cfg, 3, 16, torch.float32)
    for t in range(8):
        jl, jcache = jtf.decode_step(jcfg, jparams, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = ttf.decode_step(cfg, params, tcache, torch.from_numpy(tokens[:, t:t + 1]))
        assert_close(tl, jl, MODEL, f"logits {t}")
        jc, tc = jcache.slots["slot_0"], tcache.slots["slot_0"]
        assert_close(tc.conv, jc.conv, MODEL, f"conv cache {t}")
        assert_close(tc.h, jc.h, MODEL, f"state cache {t}")
    assert tcache.step == int(jcache.step) == 8
    # the decode steps' last logits equal the forward's
    full, _ = forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert_close(tl[:, 0], full[:, -1], MODEL, "decode vs forward")


def test_eval_step_matches_jax():
    """make_eval_step on falcon_mamba_7b: the JAX loss from the same weights
    and ZipfLM batch."""
    from repro.train.loss import lm_loss as jax_lm_loss

    jcfg, jparams, cfg, params = _port()
    model = Transformer(cfg, device="cpu")
    model.load_params(params)
    batch = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=1)).batch(0)
    metrics = make_eval_step(model)({k: torch.from_numpy(v) for k, v in batch.items()})
    jloss, _ = jax_lm_loss(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jtf.forward)
    assert_close(metrics["loss"].detach().numpy(), np.asarray(jloss), MODEL, "loss")
    assert np.isfinite(float(metrics["loss"]))
