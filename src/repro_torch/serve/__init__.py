"""Serving (port of ``repro/serve``): the request-level engine over a paged
KV pool with continuous batching, paged path only.

Each attention layer keeps its KV cache in a shared page pool
``(n_pages, page_size, 2 * kv_heads, head_dim)`` (K on even, V on odd head
rows; page 0 the null page) addressed through a ``(max_slots, max_pages)``
page table. Decode and chunked prefill both reduce through the hand-written
paged-attention kernel (``repro_torch.kernels.paged_attention``); the
scheduler admits queued requests when their pages fit, grows one page per
crossed boundary, preempts the youngest request when the pool runs out
(recompute on re-admission), and frees a finished request's pages at once.

    eng = Engine(cfg, params, ServeConfig(max_seq=256, page_size=16))
    rid = eng.submit(Request(prompt=toks, max_new_tokens=64, eos_id=2))
    for c in eng.run_until_drained().values():
        print(c.finish_reason, c.ttft_s, c.tokens)

CLI: ``python -m repro_torch.serve --arch smollm_135m --preset full`` (on
the GPU; ``--device cpu`` runs the kernels' plain twins on the CPU).
"""
from .engine import Completion, Engine, Request, ServeConfig
from .kvpool import KVPool, PoolExhausted
from .metrics import LivelockError, Rejected, ServeCounters, ServeMetrics
from .scheduler import Scheduler

__all__ = ["Engine", "ServeConfig", "Request", "Completion", "KVPool", "PoolExhausted", "Scheduler",
           "ServeMetrics", "ServeCounters", "Rejected", "LivelockError"]
