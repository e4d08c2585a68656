"""Deterministic fault-injection hook registry shared by train and serve
(port of ``repro/injection.py``; the port keeps its own registry, so a hook
installed in one package never fires in the other).

Conventions:

* Hook points are dotted strings owned by the firing module. The port
  fires ``"checkpoint.io"`` (``repro_torch.checkpoint.store``),
  ``"optim.kernel"`` (``repro_torch.optim.fused``), and the serving points
  ``"serve.kernel"``, ``"serve.logits"``, ``"serve.clock"`` and
  ``"serve.step"`` (``repro_torch.serve.engine``; the hooks that drive them
  are ``repro_torch.serve.faults``).
* :func:`fire` is a no-op (returns ``None``) when nothing is installed, so
  instrumentation costs one dict lookup on the hot path.
* A hook simulates a fault either by **raising** (IO failure, kernel
  failure — the caller's normal exception handling is what's under test) or
  by **returning** a value the call site interprets (a clock skew, a
  poison verdict).
* Everything is deterministic: hooks key off the step/call counters their
  installer closes over, never wall clock or global RNG —
  :func:`call_counter` is the shared "fail on the nth call" helper.
* Install/uninstall nests: :func:`installed` restores whatever hook was
  previously registered, so drills can stack injections.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def install(point: str, hook: Optional[Callable[..., Any]]) -> None:
    """Register ``hook`` at ``point`` (``None`` uninstalls). Prefer the
    :func:`installed` context manager, which restores the previous hook."""
    if hook is None:
        _REGISTRY.pop(point, None)
    else:
        _REGISTRY[point] = hook


def get(point: str) -> Optional[Callable[..., Any]]:
    return _REGISTRY.get(point)


def fire(point: str, *args: Any, **kwargs: Any) -> Any:
    """Call the hook installed at ``point`` (if any) and return its value.
    Exceptions propagate to the firing site — that is the injection."""
    hook = _REGISTRY.get(point)
    if hook is None:
        return None
    return hook(*args, **kwargs)


@contextlib.contextmanager
def installed(point: str, hook: Callable[..., Any]):
    """Install ``hook`` at ``point`` for the scope, restoring the previously
    installed hook (or the empty slot) on exit."""
    prev = _REGISTRY.get(point)
    _REGISTRY[point] = hook
    try:
        yield hook
    finally:
        if prev is None:
            _REGISTRY.pop(point, None)
        else:
            _REGISTRY[point] = prev


def call_counter(fail_on: Tuple[int, ...],
                 make_exc: Callable[[int], BaseException]):
    """Build a (hook, state) pair that raises ``make_exc(n)`` on the nth
    call (1-based) for n in ``fail_on`` — the deterministic "fail the nth
    write/launch" schedule both train and serve injections use. ``state``
    exposes ``calls``/``failed`` counters so drills can assert the
    injection actually happened."""
    state = {"calls": 0, "failed": 0}

    def hook(*_args: Any, **_kwargs: Any) -> None:
        state["calls"] += 1
        if state["calls"] in fail_on:
            state["failed"] += 1
            raise make_exc(state["calls"])

    return hook, state
