"""Serving CLI, the port's counterpart of ``examples/serve_llm.py``.

    PYTHONPATH=src python -m repro_torch.serve --arch smollm_135m --preset reduced --device cpu
    PYTHONPATH=src python -m repro_torch.serve --arch smollm_135m --preset full --requests 16
    PYTHONPATH=src python -m repro_torch.serve --arch falcon_mamba_7b --preset full --requests 4
    PYTHONPATH=src python -m repro_torch.serve --arch olmoe_1b_7b --preset full --requests 8
    PYTHONPATH=src python -m repro_torch.serve --arch qwen15_32b --optimized --device cpu
    PYTHONPATH=src python -m repro_torch.serve --arch jamba_v01_52b --preset full --layers 8 --requests 4

Serves random weights made from seed 0 (no pretrained weights ship with the
repository) on prompts drawn from seed 1, and prints each completion and the
engine's metrics. An attention model (the MoE ones too) goes through the
paged engine; an architecture outside the paged path (falcon_mamba_7b,
jamba_v01_52b, or qwen15_32b with ``--optimized``, its ``optimized()``
variant with the int8 KV cache) through ``Engine.generate``'s legacy loop, one
batch of equal-length prompts. The encoders (hubert_xlarge, vit_small) have
no decode step and raise. Runs on the GPU unless ``--device`` names another
device; there the weights are drawn on the card (a full-size
falcon_mamba_7b is 28 GB in f32, olmoe_1b_7b 27.7 GB). ``--layers N`` cuts
the depth to N layers, whole periods of the architecture's layer pattern,
widths unchanged: jamba_v01_52b's 32 layers (51.6 B parameters, 192 GiB in
f32) do not fit one card, one 8-layer period (13.3 B, 49.5 GiB) does.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..configs import ARCH_IDS, get_config, get_optimized, get_reduced
from ..models import Transformer
from ..models.transformer import supports_paged
from .engine import Engine, Request, ServeConfig

# (ServeConfig, prompt length) per preset: the reduced one is examples/serve_llm.py's
# geometry, the full one the chip smoke run's.
PRESETS = {
    "reduced": (dict(max_seq=64, page_size=8, max_slots=4, prefill_chunk=8), 8),
    "full": (dict(max_seq=2048, page_size=16, max_slots=16, prefill_chunk=128), 256),
}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--arch", default="smollm_135m", choices=ARCH_IDS)
    ap.add_argument("--preset", choices=tuple(PRESETS), default="reduced")
    ap.add_argument("--device", default=None, help="default: the GPU (raises when there is none)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--optimized", action="store_true",
                    help="the architecture's optimized() variant (qwen15_32b: the int8 KV cache, served through "
                         "the legacy loop); raises where there is none")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (whole periods of the layer pattern; widths unchanged)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.optimized:
        cfg = get_optimized(args.arch, reduced=args.preset != "full")
    else:
        cfg = get_config(args.arch) if args.preset == "full" else get_reduced(args.arch)
    if args.layers is not None:
        if args.layers < 1 or args.layers % len(cfg.pattern):
            raise ValueError(f"--layers {args.layers} is not a whole number of {cfg.name}'s "
                             f"{len(cfg.pattern)}-layer pattern")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    sc_kw, prompt_len = PRESETS[args.preset]
    model = Transformer(cfg, device=device, gen=torch.Generator(device=device).manual_seed(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (args.requests, prompt_len), dtype=np.int32)
    if not supports_paged(cfg):
        sc = ServeConfig(max_seq=prompt_len + args.new_tokens, max_new_tokens=args.new_tokens,
                         temperature=args.temperature)
        eng = Engine(cfg, model.params, sc, device=device)
        del model
        out = eng.generate(prompts)
        print(f"arch={cfg.name} device={device} legacy loop: {args.requests} rows x {prompt_len} prompt tokens, "
              f"decode_steps={eng.decode_steps} tokens_out={eng.tokens_out}")
        for i, row in enumerate(out):
            print(f"  req{i}: prompt={list(map(int, row[:8]))}... -> generated={list(map(int, row[prompt_len:]))}")
        print("metrics:", eng.metrics().to_dict())
        return out
    eng = Engine(cfg, model.params, ServeConfig(**sc_kw), device=device)
    rids = [eng.submit(Request(prompt=p, max_new_tokens=args.new_tokens, temperature=args.temperature, seed=i))
            for i, p in enumerate(prompts)]
    done = eng.run_until_drained()
    print(f"arch={cfg.name} device={device} pool={eng.pool.n_pages}x{eng.pool.page_size} "
          f"high_water={eng.pool.high_water} prefill_chunks={eng.prefill_chunks} decode_steps={eng.decode_steps}")
    for i, rid in enumerate(rids):
        c = done[rid]
        print(f"  req{i}: prompt={list(map(int, c.prompt[:8]))}... -> generated={list(map(int, c.tokens))} "
              f"[{c.finish_reason}, ttft={c.ttft_s * 1e3:.0f}ms]")
    print("metrics:", eng.metrics().to_dict())
    return done


if __name__ == "__main__":
    main()
