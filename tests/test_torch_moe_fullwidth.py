"""olmoe_1b_7b's first MoE layer at full width (d_model 2048, 64 experts
of d_ff 1024, top-8, vocab 50304; depth cut to one layer) routed by the
port and by the JAX package on the CPU, from the JAX package's own
initialisation and one ZipfLM batch of 2 x 2048 tokens, in f32: the
training geometry whose capacity (640 slots an expert for 4096 x 8
choices) drops routing choices at init.

Both packages run the layer's input through the embedding, the attention
block and the FFN's norm, then route it: the FFN inputs agree to 1e-5 of
their largest magnitude, each token's expert ids agree except where two
probabilities tie to within the two routers' rounding, and the dropped
choices agree to within the choices those near ties move. The test prints
each package's drop count and the share of the choices it is, beside the
port's share with the attention block's output left out of the FFN input
and with uniformly drawn tokens in place of ZipfLM's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_close
from repro.configs import get_config as jax_config
from repro.core.labels import flatten_with_names as jflat
from repro.data import DataConfig as JaxDataConfig, ZipfLM as JaxZipfLM
from repro.models import attention as jattn, mlp_moe as jmoe, transformer as jtf
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn, mlp_moe as tmoe, transformer as ttf

ARCH = "olmoe_1b_7b"
ROWS, SEQ = 2, 2048
TOL = 1e-5
# Expert ids may differ where a token's k-th and (k+1)-th probabilities lie
# within the routers' f32 rounding of each other; at most this share of
# the choices.
FLIP_SHARE = 1e-3


def _jax_route(cfg, params, tokens):
    """(FFN input (n, d), expert ids (n, k), dropped choices) by the JAX package."""
    p = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["slot_0"])
    x = jnp.take(params["embed"], tokens, axis=0).astype(cfg.dtype)
    x = x + jattn.attention_forward(p["attn"], jtf._norm(cfg, p["mixer_norm"], x), cfg.attn_cfg())
    u = jtf._norm(cfg, p["ffn_norm"], x).reshape(-1, cfg.d_model)
    mcfg = cfg.moe_cfg()
    probs = jax.nn.softmax(u.astype(jnp.float32) @ p["moe"]["router"].astype(jnp.float32), axis=-1)
    gates, eidx = jax.lax.top_k(probs, mcfg.top_k)
    gates = gates / jnp.sum(gates, axis=-1, keepdims=True)
    n = u.shape[0]
    cap = int(max(1, round(n * mcfg.top_k / mcfg.n_experts * mcfg.capacity_factor)))
    _, _, _, valid = jmoe._dispatch_group(u, gates, eidx, mcfg.n_experts, mcfg.top_k, cap, cfg.dtype)
    return np.asarray(u), np.asarray(eidx), n * mcfg.top_k - int(valid.sum())


def _port_drops(cfg, p, u):
    """(expert ids (n, k), dropped choices) of the port's route of u (n, d)."""
    mcfg = cfg.moe_cfg()
    _, _, _, eidx = tmoe._router(u, p["moe"]["router"], mcfg.top_k)
    dp = tmoe._dispatch_group(u, eidx, mcfg.n_experts, mcfg.top_k, tmoe.moe_capacity(u.shape[0], mcfg))
    return eidx, int((~dp.keep).sum())


def _port_route(cfg, params, tokens):
    """(FFN input (n, d), expert ids (n, k), dropped choices, dropped choices
    of the embedding alone) by the port."""
    (_, _, _, p), = ttf._layers(cfg, params)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    u = ttf._norm(cfg, p["ffn_norm"], x + tattn.attention_forward(p["attn"], ttf._norm(cfg, p["mixer_norm"], x),
                                                                  cfg.attn_cfg()))
    eidx, drops = _port_drops(cfg, p, u.reshape(-1, cfg.d_model))
    _, embed_drops = _port_drops(cfg, p, ttf._norm(cfg, p["ffn_norm"], x).reshape(-1, cfg.d_model))
    return u.reshape(-1, cfg.d_model).numpy(), eidx.numpy(), drops, embed_drops


def test_full_width_routing_and_drops_match_jax():
    jcfg = dataclasses.replace(jax_config(ARCH), n_layers=1, dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(get_config(ARCH), n_layers=1, dtype=torch.float32, remat=False)
    tokens = JaxZipfLM(JaxDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ, global_batch=ROWS,
                                     seed=0)).batch(0)["tokens"]
    jparams, _ = jcfg.init(jax.random.PRNGKey(0))
    with torch.no_grad():
        tparams = params_from_numpy({name: np.asarray(leaf) for name, leaf in jflat(jparams)[0]
                                     if name == "embed" or name.startswith("blocks.")}, "cpu")
        tu, tids, tdrops, embed_drops = _port_route(tcfg, tparams, torch.from_numpy(np.asarray(tokens)))
        uniform = torch.randint(0, tcfg.vocab_size, (ROWS, SEQ), generator=torch.Generator().manual_seed(0))
        _, _, uniform_drops, _ = _port_route(tcfg, tparams, uniform)
    del tparams
    ju, jids, jdrops = _jax_route(jcfg, jparams, jnp.asarray(tokens))
    del jparams

    assert_close(tu, ju, TOL, "FFN input")
    n, k = jids.shape
    assert (n, k) == (ROWS * SEQ, 8) and tmoe.moe_capacity(n, tcfg.moe_cfg()) == 640
    flipped = int(np.sum(np.sort(tids, axis=1) != np.sort(jids, axis=1)))
    share = {what: d / (n * k) for what, d in (("port", tdrops), ("JAX", jdrops), ("embedding alone", embed_drops),
                                               ("uniform tokens", uniform_drops))}
    print(f"\n{ARCH} layer 0 at full width, {n} tokens x top-{k}: dropped choices port {tdrops}, JAX {jdrops}; "
          f"expert ids differing {flipped}; shares " + ", ".join(f"{w} {v:.4%}" for w, v in share.items()))
    assert flipped <= FLIP_SHARE * n * k, flipped
    assert abs(tdrops - jdrops) <= flipped, (tdrops, jdrops, flipped)
    # Where the drops come from: the attention block's output, alike across the
    # tokens of a ZipfLM batch, dominates the FFN input at init.
    assert 0 < embed_drops < tdrops and uniform_drops < tdrops, share
