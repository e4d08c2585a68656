"""The port's remaining serving functions against the JAX package on the
CPU: ``configs.decode_input_specs`` and ``transformer.abstract_decode_cache``
(every architecture at each decode shape ``cell_supported`` admits: shapes
and dtypes equal, the port's on the ``meta`` device), ``kvpool.pool_shape``,
``paged_fits`` (the JAX VMEM contract, as a query), ``KVPool.reserve`` /
``unreserve`` sequences, ``train.make_serve_step`` on reduced smollm_135m and
reduced jamba_v01_52b (next tokens equal, logits within 1e-5 of the largest
magnitude), and the serving CLI's depth cut.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, jax_params
from repro.configs import SHAPES as JAX_SHAPES, cell_supported as jax_cell_supported, \
    decode_input_specs as jax_decode_input_specs, get_config as jax_config, get_reduced as jax_reduced
from repro.kernels import PAGED_ATTN_BUFS as JAX_BUFS, paged_fits as jax_paged_fits
from repro.models import transformer as jtf
from repro.serve.kvpool import KVPool as JaxKVPool, PoolExhausted as JaxPoolExhausted, pool_shape as jax_pool_shape
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, decode_input_specs, get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import transformer as ttf
from repro_torch.serve.__main__ import main as serve_cli
from repro_torch.serve.kvpool import RESERVED_RID, KVPool, PoolExhausted, pool_shape
from repro_torch.train import make_serve_step

LOGITS = 1e-5
DECODE_CELLS = [(arch, shape) for arch in ARCH_IDS for shape, (_, _, kind) in SHAPES.items()
                if kind == "decode" and cell_supported(arch, shape)[0]]


def test_decode_cells_are_jax_cells():
    assert SHAPES == JAX_SHAPES
    want = [(a, s) for a in ARCH_IDS for s, (_, _, k) in JAX_SHAPES.items()
            if k == "decode" and jax_cell_supported(a, s)[0]]
    assert DECODE_CELLS == want and len(DECODE_CELLS) == 13


def _torch_dtype(jdtype) -> torch.dtype:
    return getattr(torch, jnp.dtype(jdtype).name)


def _assert_cache_like(cache, jcache, what):
    assert set(cache.slots) == set(jcache.slots), what
    for key, jslot in jcache.slots.items():
        slot = cache.slots[key]
        assert type(slot).__name__ == type(jslot).__name__ and slot._fields == jslot._fields, (what, key)
        for field, t, j in zip(slot._fields, slot, jslot):
            assert t.device.type == "meta", (what, key, field)
            assert tuple(t.shape) == tuple(j.shape), (what, key, field, tuple(t.shape), j.shape)
            assert t.dtype == _torch_dtype(j.dtype), (what, key, field, t.dtype, j.dtype)
    # the port's cache counts its fill as a Python int, JAX's as a 0-d int32
    assert cache.step == 0 and jcache.step.shape == () and jcache.step.dtype == jnp.int32


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_input_specs_match_jax(arch, shape):
    got = decode_input_specs(get_config(arch), shape)
    want = jax_decode_input_specs(jax_config(arch), shape)
    assert set(got) == set(want) == {"tokens", "cache"}
    tok = got["tokens"]
    assert tok.device.type == "meta" and tok.dtype == torch.int32
    assert tuple(tok.shape) == tuple(want["tokens"].shape) == (SHAPES[shape][1], 1)
    _assert_cache_like(got["cache"], want["cache"], f"{arch} {shape}")


def test_decode_input_specs_reject_other_kinds():
    cfg = get_config("smollm_135m")
    for shape in ("train_4k", "prefill_32k"):
        with pytest.raises(AssertionError):
            decode_input_specs(cfg, shape)


@pytest.mark.parametrize("arch", ["smollm_135m", "jamba_v01_52b", "falcon_mamba_7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_abstract_decode_cache_matches_jax(arch, dtype):
    """Reduced configs, so the port's cache can also be allocated: the
    abstract one is init_decode_cache's, tensor for tensor."""
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    got = ttf.abstract_decode_cache(cfg, 3, 40, getattr(torch, dtype))
    want = jtf.abstract_decode_cache(jcfg, 3, 40, getattr(jnp, dtype))
    _assert_cache_like(got, want, arch)
    real = ttf.init_decode_cache(cfg, 3, 40, getattr(torch, dtype), device="cpu")
    for key, slot in real.slots.items():
        for t, m in zip(slot, got.slots[key]):
            assert t.shape == m.shape and t.dtype == m.dtype and not t.any()


def test_full_jamba_decode_cache_is_sized_not_allocated():
    """The whole 32-layer jamba at decode_32k: 4 attention layers' bf16 K/V
    over 128 x 32768 positions and 28 Mamba layers' states, on ``meta``."""
    cfg = get_config("jamba_v01_52b")
    cache = decode_input_specs(cfg, "decode_32k")["cache"]
    nbytes = sum(t.numel() * t.element_size() for slot in cache.slots.values() for t in slot)
    kv = 4 * 2 * 128 * 32768 * cfg.n_kv_heads * cfg.hd * 2
    ssm = 28 * 128 * (cfg.ssm_conv - 1) * cfg.ssm_expand * cfg.d_model * 2 \
        + 28 * 128 * cfg.ssm_expand * cfg.d_model * cfg.ssm_state * 4
    assert nbytes == kv + ssm + 4 * (2 * 4 + 4)     # the (1,) scale placeholders and the 0-d index
    jcache = jax_decode_input_specs(jax_config("jamba_v01_52b"), "decode_32k")["cache"]
    assert nbytes == sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(jcache.slots))


def test_pool_shape_matches_jax():
    for args in [(2, 1, 1, 16), (13, 4, 3, 64), (800, 16, 8, 128)]:
        assert pool_shape(*args) == jax_pool_shape(*args)
    cfg = get_reduced("gpt_small")
    pools = ttf.init_paged_pools(cfg, 9, 4, torch.float32)
    assert all(tuple(p.shape[1:]) == pool_shape(9, 4, cfg.n_kv_heads, cfg.hd) for p in pools.values())


def test_paged_fits_matches_jax():
    assert pa.PAGED_ATTN_BUFS == JAX_BUFS and kernels.paged_fits is pa.paged_fits
    verdicts = []
    for chunk in (1, 8, 128, 512):
        for heads in (4, 16, 64):
            for hd in (64, 128, 256):
                for page in (4, 16, 64):
                    for kv2 in (2, 16, 80):
                        got = pa.paged_fits(chunk, heads, hd, page, kv2)
                        assert got == jax_paged_fits(chunk, heads, hd, page, kv2), (chunk, heads, hd, page, kv2)
                        assert pa.paged_fits(chunk, heads, hd, page, kv2, itemsize=2) \
                            == jax_paged_fits(chunk, heads, hd, page, kv2, itemsize=2)
                        verdicts.append(got)
    assert any(verdicts) and not all(verdicts)


@pytest.mark.parametrize("seed", range(4))
def test_reserve_unreserve_sequences_match_jax(seed):
    """Random alloc / release / reserve / unreserve sequences on both pools:
    the same pages handed out, the same refusals, the same counters."""
    rng = np.random.default_rng(seed)
    pools = (KVPool(12, 4), JaxKVPool(12, 4))
    owned = {}        # rid -> pages
    reserved = []     # page lists from reserve()
    for step in range(60):
        op = rng.integers(0, 4)
        if op == 0:
            rid, n = int(rng.integers(0, 5)), int(rng.integers(1, 6))
            outs = []
            for p, exc in zip(pools, (PoolExhausted, JaxPoolExhausted)):
                try:
                    outs.append(p.alloc(n, rid))
                except exc:
                    outs.append("exhausted")
            assert outs[0] == outs[1], step
            if outs[0] != "exhausted":
                owned.setdefault(rid, []).extend(outs[0])
        elif op == 1 and owned:
            rid = sorted(owned)[int(rng.integers(0, len(owned)))]
            for p in pools:
                p.release(owned[rid], rid)
            del owned[rid]
        elif op == 2:
            n = int(rng.integers(0, 8))
            outs = [p.reserve(n) for p in pools]
            assert outs[0] == outs[1], step
            assert all(pools[0].owner(pg) == RESERVED_RID for pg in outs[0])
            reserved.append(outs[0])
        elif op == 3 and reserved:
            pages = reserved.pop(int(rng.integers(0, len(reserved))))
            for p in pools:
                p.unreserve(pages)
        a, b = pools
        assert (a.free_pages, a.used_pages, a.alloc_count, a.free_count, a.high_water) \
            == (b.free_pages, b.used_pages, b.alloc_count, b.free_count, b.high_water), step
    for p in pools:
        with pytest.raises(ValueError):
            p.unreserve([p.n_pages])        # never reserved
        assert p.reserve(0) == []


@pytest.mark.parametrize("arch", ["smollm_135m", "jamba_v01_52b"])
def test_make_serve_step_matches_jax(arch):
    """A 12-token prompt fed through the serve step, then 8 greedy steps on
    its own output, both packages from the same weights."""
    jcfg, jparams, _, arrays = jax_params(seed=0, arch=arch)
    cfg, params = get_reduced(arch), params_from_numpy(arrays, "cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 12), dtype=np.int32)
    jstep, step = jax.jit(jax_make_serve_step(jcfg)), make_serve_step(cfg)
    jcache = jtf.init_decode_cache(jcfg, 3, 32, dtype=jnp.float32)
    cache = ttf.init_decode_cache(cfg, 3, 32, torch.float32, device="cpu")
    jtok, tok = None, None
    for t in range(tokens.shape[1] + 8):
        if t < tokens.shape[1]:
            jtok, tok = jnp.asarray(tokens[:, t:t + 1]), torch.from_numpy(tokens[:, t:t + 1])
        jnext, jlogits, jcache = jstep(jparams, jcache, jtok)
        nxt, logits, cache = step(params, cache, tok)
        assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (3, 1)
        assert_close(logits, jlogits, LOGITS, f"{arch} step {t}")
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext), err_msg=f"{arch} step {t}")
        jtok, tok = jnext, nxt
    assert cache.step == tokens.shape[1] + 8


def test_serve_cli_cuts_depth_to_whole_periods(capsys):
    out = serve_cli(["--arch", "jamba_v01_52b", "--device", "cpu", "--layers", "8", "--requests", "2",
                     "--new-tokens", "4"])
    assert tuple(out.shape) == (2, 8 + 4)
    assert "legacy loop" in capsys.readouterr().out
    with pytest.raises(ValueError, match="4-layer pattern"):
        serve_cli(["--arch", "jamba_v01_52b", "--device", "cpu", "--layers", "6"])
