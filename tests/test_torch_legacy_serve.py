"""The port's legacy serving loop (``Engine.generate`` over
``transformer.decode_step`` and the dense per-row caches) against the JAX
engine on the CPU, from the JAX-initialised parameters carried across by
``repro_torch.convert``: reduced falcon_mamba_7b (the SSM family, which
only this loop serves) and, with ``paged=False``, reduced smollm_135m and
gpt_small. Greedy tokens must be equal, and the port's legacy tokens equal
its paged ones; the truncation warning, the "no room" error, the wall-clock
budget and the request API's refusal behave as the JAX tests check them
(tests/test_substrate.py:274-327, tests/test_serve_paged.py:194-198).
"""
import time

import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_params
from repro.serve import Engine as JaxEngine, ServeConfig as JaxServeConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.__main__ import main as serve_cli


def _port(arch):
    jcfg, jparams, _, arrays = jax_params(seed=0, arch=arch)
    return jcfg, jparams, get_reduced(arch), params_from_numpy(arrays, "cpu")


def _prompts(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


@pytest.mark.parametrize("arch,paged", [("falcon_mamba_7b", None), ("smollm_135m", False), ("gpt_small", False)])
def test_greedy_generate_matches_jax(arch, paged):
    jcfg, jparams, cfg, params = _port(arch)
    kw = dict(max_new_tokens=8, max_seq=32, paged=paged)
    prompts = _prompts(cfg.vocab_size, 3, 5, 1)
    want = JaxEngine(jcfg, jparams, JaxServeConfig(**kw)).generate(jax.numpy.asarray(prompts))
    eng = Engine(cfg, params, ServeConfig(**kw), device="cpu")
    got = eng.generate(prompts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # prefill 5 positions, then a step per sampled token but the last
    assert eng.decode_steps == 5 + 7 and eng.tokens_out == 3 * 8


@pytest.mark.parametrize("arch", ["smollm_135m", "gpt_small"])
@pytest.mark.parametrize("page_size", [4, 16])
def test_legacy_tokens_equal_paged_tokens(arch, page_size):
    _, _, cfg, params = _port(arch)
    kw = dict(max_new_tokens=8, max_seq=32, page_size=page_size)
    prompts = _prompts(cfg.vocab_size, 3, 5, 2)
    paged = Engine(cfg, params, ServeConfig(**kw), device="cpu").generate(prompts)
    legacy = Engine(cfg, params, ServeConfig(paged=False, **kw), device="cpu").generate(prompts)
    np.testing.assert_array_equal(paged.numpy(), legacy.numpy())


def test_eos_stops_the_loop_and_pins_finished_rows():
    _, _, cfg, params = _port("falcon_mamba_7b")
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=16, max_seq=32), device="cpu")
    prompts = np.array([[1, 2, 3]], np.int32)
    free = eng.generate(prompts)
    assert free.shape == (1, 3 + 16)
    eos = int(free[0, 3])
    out = eng.generate(prompts, eos_id=eos)
    assert out.shape == (1, 4) and int(out[0, -1]) == eos


@pytest.mark.parametrize("arch,paged", [("falcon_mamba_7b", None), ("smollm_135m", None), ("smollm_135m", False)])
def test_cache_overflow_truncates_with_warning(arch, paged):
    _, _, cfg, params = _port(arch)
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=64, max_seq=8, paged=paged), device="cpu")
    prompts = _prompts(cfg.vocab_size, 2, 4, 1)
    with pytest.warns(UserWarning, match="truncating max_new_tokens"):
        out = eng.generate(prompts)
    assert out.shape == (2, 8)  # 4 prompt + 4 generated = max_seq
    assert eng.metrics().truncated_max_new >= 1


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "smollm_135m"])
def test_prompt_filling_cache_rejected(arch):
    _, _, cfg, params = _port(arch)
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=4, max_seq=4), device="cpu")
    with pytest.raises(ValueError, match="no room"):
        eng.generate(np.zeros((1, 6), np.int32))


def test_request_api_unavailable_on_legacy_arch():
    _, _, cfg, params = _port("falcon_mamba_7b")
    eng = Engine(cfg, params, ServeConfig(max_seq=32), device="cpu")
    with pytest.raises(NotImplementedError, match="generate"):
        eng.submit(Request(prompt=np.array([1, 2], np.int32)))
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, params, ServeConfig(paged=True), device="cpu")


def test_wall_clock_budget_in_prefill_returns_the_prompt():
    _, _, cfg, params = _port("falcon_mamba_7b")
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=8, max_seq=32, max_wall_s=0.0), device="cpu")
    prompts = np.array([[1, 2, 3, 4]], np.int32)
    with pytest.warns(UserWarning, match="wall-clock budget.*prefill"):
        out = eng.generate(prompts)
    np.testing.assert_array_equal(out.numpy(), prompts)
    assert eng.metrics().budget_truncated == 1


def test_wall_clock_budget_truncates_decode():
    _, _, cfg, params = _port("falcon_mamba_7b")
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=32, max_seq=64), device="cpu")
    prompts = np.array([[1, 2]], np.int32)
    real_decode = eng._decode

    def slow_decode(params, cache, tok):
        time.sleep(0.05)
        return real_decode(params, cache, tok)

    eng._decode = slow_decode
    eng.sc.max_wall_s = 0.5
    with pytest.warns(UserWarning, match="wall-clock budget"):
        out = eng.generate(prompts)
    assert 2 < out.shape[1] < 2 + 32
    assert eng.metrics().budget_truncated == 1


def test_sampling_is_seeded():
    _, _, cfg, params = _port("falcon_mamba_7b")
    prompts = _prompts(cfg.vocab_size, 2, 3, 3)
    outs = [Engine(cfg, params, ServeConfig(max_new_tokens=6, max_seq=16, temperature=0.9, seed=s),
                   device="cpu").generate(prompts) for s in (7, 7, 8)]
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    assert not np.array_equal(outs[0].numpy(), outs[2].numpy())


def test_cli_serves_falcon_mamba_through_the_legacy_loop(capsys):
    out = serve_cli(["--arch", "falcon_mamba_7b", "--device", "cpu", "--requests", "2", "--new-tokens", "3"])
    assert out.shape == (2, 8 + 3)
    text = capsys.readouterr().out
    assert "legacy loop" in text and "decode_steps=10" in text
