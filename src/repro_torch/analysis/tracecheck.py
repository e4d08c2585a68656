"""tracecheck — the guarded train step's controls contract (the counterpart
of ``repro/analysis/tracecheck.py``).

The JAX step takes the guard's policy as traced operands (``controls =
{'lr_scale': f32, 'grad_scale': f32}``) so that a backoff never
recompiles, and its pass checks that the step traces once. The port runs
eagerly, so "traces once" becomes three checks:

  * **controls-used** — the guarded step applies the controls as the JAX
    step does (``repro/train/step.py:104-108``): the gradients times
    ``grad_scale`` and the updates times ``lr_scale``, each control rounded
    to f32 and then to the tensor's dtype, one multiply in that dtype. Held
    bit for bit against that rule, computed here from the same gradients
    and optimizer, on reduced gpt_small in f32 and in bf16 (where rounding
    the control differently shows), the parameters updated by
    ``optim.base.apply_updates`` (which ``tests/test_torch_analysis.py``
    holds to JAX's step bit for bit, with the rule); the update must also
    move with the control (a step that ignores it fails).
  * **aval-stable** — the controls the ``Guard`` hands the step keep the
    same keys, types and dtypes across a spike and its backoff.
  * **launch-stable** — the kernel wrappers launch as often with controls
    of 1.0 as with 0.5: no kernel path branches on a control. It counts
    real launches, so it runs on the card (the ``launch-stable`` pass of
    ``python -m repro_torch.analysis``); :func:`check_launch_stable` takes
    any step that reports its counts.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from .report import PassResult

_A = {"lr_scale": 1.0, "grad_scale": 1.0}
_B = {"lr_scale": 0.05, "grad_scale": 0.5}
# A grad_scale no bf16 number equals, so that a control rounded otherwise
# than JAX rounds it shows on bf16 gradients (0.5 is exact in every dtype).
_C = {"lr_scale": 0.05, "grad_scale": 0.3}


def jax_rule(tree: Dict[str, torch.Tensor], value: float) -> Dict[str, torch.Tensor]:
    """``tree`` times a control as ``repro/train/step.py:104-108`` does it:
    ``x * jnp.asarray(value, float32).astype(x.dtype)``, always."""
    c32 = torch.tensor(value, dtype=torch.float32)
    return {k: x * c32.to(x.dtype) for k, x in tree.items()}


def reduced_setup(dtype: torch.dtype = torch.float32, device: str = "cpu", seed: int = 0):
    """(model, optimizer, batch) of reduced gpt_small with Table-3 SlimAdam
    on the fused backend, emitting health as the guarded trainer's does."""
    import dataclasses

    from ..configs import get_reduced
    from ..core import rules_as_tree, table3_rules
    from ..core.slim_adam import slim_adam
    from ..models.transformer import Transformer

    cfg = dataclasses.replace(get_reduced("gpt_small"), param_dtype=dtype)
    model = Transformer(cfg, device=torch.device(device), gen=torch.Generator().manual_seed(seed))
    dims = rules_as_tree(table3_rules(model.meta), model.params, model.meta)
    tx = slim_adam(3e-3, dims, backend="fused", emit_health=True)
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    batch = {"tokens": tokens.to(device), "labels": torch.roll(tokens, -1, 1).to(device)}
    return model, tx, batch


def _snapshot(model) -> Dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in model.params.items()}


def _restore(model, saved: Dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for k, p in model.params.items():
            p.copy_(saved[k])


def check_controls_used(step_factory: Callable, model, tx, batch, result: PassResult, where: str,
                        controls: Dict[str, float] = _B) -> None:
    """controls-used on one model: the step ``step_factory(model, tx)``
    returns (as ``make_train_step(..., guard=True)``) against the JAX rule
    applied to the same gradients and optimizer."""
    from ..optim.base import apply_updates
    from ..train.step import make_grad_fn

    result.checks += 1
    p0 = _snapshot(model)
    state = tx.init(model.params)
    grads, _ = make_grad_fn(model)(batch)
    with torch.no_grad():
        updates, _ = tx.update(jax_rule(grads, controls["grad_scale"]), state, model.params)
        apply_updates(model.params, jax_rule(updates, controls["lr_scale"]))
    want = _snapshot(model)
    _restore(model, p0)
    step = step_factory(model, tx)
    out_state, metrics = step(tx.init(model.params), batch, dict(controls))
    got = _snapshot(model)
    _restore(model, p0)
    step(tx.init(model.params), batch, dict(_A))
    plain = _snapshot(model)
    _restore(model, p0)
    if float(metrics["step_skipped"]):
        result.add("controls-used", where, "the guarded step skipped a finite step")
        return
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if differ:
        worst = max(float((got[k].float() - want[k].float()).abs().max()) for k in differ)
        result.add("controls-used", where,
                   f"{len(differ)} of {len(want)} parameters differ from the JAX step's rule (a control rounded to "
                   f"f32 and to the tensor's dtype, then one multiply), by up to {worst:.3e}: first {differ[0]}")
    if all(torch.equal(got[k], plain[k]) for k in got):
        result.add("controls-used", where, f"controls {controls} move no parameter away from the step with "
                                           f"controls of 1: the step ignores them")
    del out_state


def check_guard_controls(result: PassResult, where: str = "Guard.controls") -> None:
    """aval-stable across an actual guard backoff."""
    from ..train.guard import Guard, GuardConfig

    result.checks += 1
    guard = Guard(GuardConfig(min_history=2))
    before = guard.controls()
    for loss in (1.0, 1.01, 0.99, 1.0, 50.0):   # the last one is a spike
        guard.observe(loss)
    after = guard.controls()
    if guard.lr_scale >= 1.0:
        result.add("aval-stable", where, "the guard did not react to a 50x loss spike: the transition this check "
                                         "exercises no longer exists")
        return

    def kinds(c):
        return {k: (type(v).__name__, getattr(v, "dtype", None), tuple(getattr(v, "shape", ())))
                for k, v in c.items()}

    if kinds(before) != kinds(after):
        result.add("aval-stable", where, f"the controls changed keys, types or dtypes across a backoff "
                                         f"({kinds(before)} -> {kinds(after)})")


def check_launch_stable(run: Callable[[Dict[str, float]], Dict[str, int]], result: PassResult,
                        where: str = "guarded_train_step") -> None:
    """launch-stable: ``run(controls)`` performs one guarded step and
    returns its kernel launches by wrapper; controls of 1.0 and 0.5 must
    launch alike."""
    result.checks += 1
    one = run({"lr_scale": 1.0, "grad_scale": 1.0})
    half = run({"lr_scale": 0.5, "grad_scale": 0.5})
    if one != half:
        result.add("launch-stable", where, f"kernel launches differ with the controls: {one} at 1.0, {half} at "
                                           f"0.5: a kernel path branches on a control")
    elif not sum(one.values()):
        result.add("launch-stable", where, "the step launched no kernel: nothing was checked")


def card_launch_counter():
    """A ``run`` for :func:`check_launch_stable`: reduced gpt_small's
    guarded step on the card, the wrappers' launches counted around it."""
    from .. import kernels
    from ..train.step import make_train_step

    model, tx, batch = reduced_setup(torch.float32, "cuda")
    step = make_train_step(model, tx, guard=True)
    p0 = _snapshot(model)

    def run(controls):
        _restore(model, p0)
        before = kernels.launch_counts()
        step(tx.init(model.params), batch, controls)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        return {k: after[k] - before[k] for k in after if after[k] != before[k]}

    return run


def run() -> PassResult:
    """controls-used (f32 and bf16) and aval-stable, on the CPU."""
    from ..train.step import make_train_step

    t0 = time.monotonic()
    result = PassResult("tracecheck")
    factory = lambda model, tx: make_train_step(model, tx, guard=True)   # noqa: E731
    for dtype, controls in ((torch.float32, _B), (torch.bfloat16, _B), (torch.bfloat16, _C)):
        model, tx, batch = reduced_setup(dtype)
        check_controls_used(factory, model, tx, batch, result,
                            f"guarded_train_step[{str(dtype)[6:]}, grad_scale {controls['grad_scale']}]", controls)
    check_guard_controls(result)
    result.seconds = time.monotonic() - t0
    return result


def run_launch_stable() -> PassResult:
    """launch-stable on the card."""
    t0 = time.monotonic()
    result = PassResult("launch-stable")
    check_launch_stable(card_launch_counter(), result)
    result.seconds = time.monotonic() - t0
    return result
