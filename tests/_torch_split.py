"""The split form of the port's tensor-parallel regions: every model rank's
partial sum (``_mlp_shard``, ``_attention_shard``, ``_ssm_shard_in`` /
``_ssm_shard_out``) computed in one process and added in rank order in the
activations' dtype, as the mesh's reduce-scatter adds them. No collective
runs, so beside the mesh it isolates the collectives and the layout, and in
f32 beside the unsharded port it checks the shard bodies. A reference for
the tests and ``chip_smoke.py``; imports no JAX.

``split_regions(n, rows)`` makes the dense MLP, attention and Mamba mixer
take the split form over ``n`` model ranks wherever JAX's conditions for its
explicit tensor-parallel region hold (rows divisible by ``rows``, the batch
axes' product; the sequence by ``n``; the layer's own), for calls through
the layer modules and through ``models.transformer``.
"""
from __future__ import annotations

import contextlib


def _sum(parts):
    out = None
    for part in parts:
        out = part if out is None else out + part
    return out


def mlp(p, x, gated: bool, n: int):
    from repro_torch.models.mlp_moe import _mlp_shard

    return _sum(_mlp_shard(p, x, gated, i, n) for i in range(n))


def attention(p, x, cfg, n: int):
    from repro_torch.models.attention import _attention_shard

    return _sum(_attention_shard(p, x, cfg, i, n) for i in range(n))


def ssm(p, x, cfg, n: int, impl: str):
    from repro_torch.models.ssm import _ssm_shard_in, _ssm_shard_out

    ins = [_ssm_shard_in(p, x, cfg, i, n) for i in range(n)]
    proj = _sum(part for _, _, part, _ in ins)
    return _sum(_ssm_shard_out(p, xb, z, proj, cfg, i, n, impl, x.dtype)[0] for i, (xb, z, _, _) in enumerate(ins))


@contextlib.contextmanager
def split_regions(n: int, rows: int = 1):
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import mlp_moe, ssm as ssm_mod, transformer

    orig = {"mlp_forward": mlp_moe.mlp_forward, "attention_forward": attn_mod.attention_forward,
            "ssm_forward": ssm_mod.ssm_forward}

    def fits(x):
        return x.ndim == 3 and x.shape[0] % rows == 0 and x.shape[1] % n == 0

    def mlp_forward(p, x, *, gated):
        if fits(x) and p["w_up"].shape[1] % n == 0:
            return mlp(p, x, gated, n)
        return orig["mlp_forward"](p, x, gated=gated)

    def attention_forward(p, x, cfg):
        if fits(x) and cfg.n_heads % n == 0 and not cfg.qkv_bias:
            return attention(p, x, cfg, n)
        return orig["attention_forward"](p, x, cfg)

    def ssm_forward(p, x, cfg, *, impl="kernel"):
        if fits(x) and cfg.d_inner % n == 0:
            return ssm(p, x, cfg, n, impl)
        return orig["ssm_forward"](p, x, cfg, impl=impl)

    new = {"mlp_forward": mlp_forward, "attention_forward": attention_forward, "ssm_forward": ssm_forward}
    homes = {"mlp_forward": mlp_moe, "attention_forward": attn_mod, "ssm_forward": ssm_mod}
    try:
        for name, fn in new.items():
            setattr(homes[name], name, fn)
            setattr(transformer, name, fn)
        yield
    finally:
        for name, fn in orig.items():
            setattr(homes[name], name, fn)
            setattr(transformer, name, fn)
