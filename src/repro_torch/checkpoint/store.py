"""Checkpointing: atomic, checksummed, keep-last-k, with torn-write fallback
(port of ``repro/checkpoint/store.py``).

Layout (one directory per step), the JAX package's format byte for byte:

    ckpt_dir/
      step_00000100/
        manifest.json        # step, leaf shapes/dtypes/crc32s, extra
        arrays.npz           # flat leaf name -> full array
      step_00000200/ ...
      LATEST                 # atomic pointer file

Leaf names are the JAX package's ``flatten_with_names`` names: dict keys
sorted level by level, NamedTuple fields in order, sequence items by index,
joined with dots, and ``None`` contributing no leaf. A port state
``{"params": {...}, "opt": ChainState(...)}`` therefore names its leaves
``params.<name>`` and ``opt.inner_states.<i>.<field>...`` exactly as the
JAX trainer's state does, and a checkpoint of either package restores into
the other.

* saves stage into a ``step-<n>.tmp`` dir and ``os.replace`` into place —
  the dash keeps every ``step_*`` consumer (``_gc``, ``latest_step``'s
  fallback scan, a concurrent restore) from ever observing a half-written
  checkpoint, and a preemption mid-save leaves only the tmp dir behind;
* every leaf carries a crc32 in the manifest; ``restore()`` verifies them
  and, when asked for the newest step, falls back to the newest *valid*
  one instead of crashing on a torn/corrupt write.

A sharded run checkpoints whole arrays, in the same format: the trainer
gathers its shards and rank 0 writes (``repro_torch.train.Trainer
.checkpoint``; parameter-shard storage gathers its parameters too,
:func:`gather_to_host`). ``restore(..., shardings=...)`` cuts each rank's shard of
every sharded leaf out of the whole array it reads, so a checkpoint of
either package, from a sharded run or not, restores onto any mesh.
"""
from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
import time
import warnings
import weakref
import zipfile
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import injection

# Fired with the step number at the top of every save() attempt through the
# shared registry (repro_torch.injection; see repro_torch.train.faults
# .inject_checkpoint_io_failure).
IO_FAULT_POINT = "checkpoint.io"


class ChecksumError(ValueError):
    """A stored leaf's bytes don't match its manifest crc32 (torn write or
    bit rot). Subclasses ValueError so strict callers can catch broadly."""


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _dict_items(d: dict):
    """A dict's items in JAX's order: keys sorted by their dotted parts, so
    a flat dict with dotted keys orders as the nested tree would."""
    return sorted(d.items(), key=lambda kv: str(kv[0]).split("."))


def _walk(tree: Any, prefix: str, fn: Callable[[str, Any], Any]):
    """Rebuild ``tree`` with each leaf replaced by ``fn(name, leaf)``,
    visiting leaves in JAX's flatten order."""
    join = (lambda k: f"{prefix}.{k}") if prefix else (lambda k: str(k))
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _walk(v, join(k), fn) for k, v in _dict_items(tree)}
        return {k: out[k] for k in tree}           # keep the caller's key order
    if _is_namedtuple(tree):
        return type(tree)(*(_walk(getattr(tree, f), join(f), fn) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, join(i), fn) for i, v in enumerate(tree))
    return fn(prefix, tree)


def map_leaves(tree: Any, fn: Callable[[str, Any], Any]) -> Any:
    """``tree`` with each leaf replaced by ``fn(dotted name, leaf)``."""
    return _walk(tree, "", fn)


def named_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """[(dotted name, leaf)] in JAX's flatten order (``None`` has no leaf)."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", lambda name, leaf: out.append((name, leaf)))
    return out


def _host(leaf: Any, *, copy: bool = False) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.to("cpu", copy=True) if copy else t.cpu()).numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def gather_to_host(tree: Any, shardings: Any, *, keep: bool = True) -> Any:
    """The tree as whole host arrays, as a checkpoint holds it: each leaf
    that ``shardings`` (a like-named tree of ``repro_torch.launch.mesh
    .NamedSharding``s, e.g. ``{"params": ..., "opt": ...}``) names is this
    rank's shard, gathered whole and copied to the host at once, leaf by
    leaf, so one whole leaf is live on the device at a time. A collective:
    every rank calls it; ranks with ``keep=False`` drop each leaf and get
    None."""
    by_name = dict(named_leaves(shardings))

    def leaf(name, x):
        whole = by_name[name].gather(x) if name in by_name else x
        return _host(whole, copy=True) if keep else None

    out = _walk(tree, "", leaf)
    return out if keep else None


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save(ckpt_dir: str | Path, step: int, tree: Any, *, extra: Optional[Dict[str, Any]] = None,
         keep: int = 3) -> Path:
    """Blocking save. Returns the checkpoint path.

    Atomic: everything is staged under ``step-<n>.tmp`` (the dash can never
    match the ``step_*`` glob) and published with one ``os.replace``; on any
    failure the tmp dir is removed and no ``step_*`` dir was touched."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    injection.fire(IO_FAULT_POINT, step)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step-{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    try:
        arrays = {}
        manifest = {"step": step, "leaves": {}, "extra": extra or {}}
        for name, leaf in named_leaves(tree):
            arr = _host(leaf)
            arrays[name] = arr
            manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": str(arr.dtype), "crc32": _crc(arr)}
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    ptr_tmp = ckpt_dir / ".LATEST.tmp"
    ptr_tmp.write_text(final.name)
    os.replace(ptr_tmp, ckpt_dir / "LATEST")
    _gc(ckpt_dir, keep)
    return final


class AsyncCheckpointer:
    """Fire-and-forget background saves (writes serialize behind a lock —
    last writer wins on LATEST).

    ``save`` copies every leaf to host memory before it returns, so the
    caller may update its tensors in place at once. Every in-flight thread
    is tracked: ``wait()`` joins them all, and a module-level ``atexit``
    hook flushes every live checkpointer.

    Fault handling: retryable IO errors (``OSError``) are retried with
    exponential backoff (warning per retry); a save that still fails — or
    fails with any other exception — is recorded, and the first such
    failure is re-raised as a ``RuntimeError`` naming the failing step on
    the next ``save()``/``wait()`` call."""

    def __init__(self, max_retries: int = 2, backoff_s: float = 0.05):
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._io_lock = threading.Lock()       # serializes the actual writes
        self._reg_lock = threading.Lock()      # guards in-flight list + failure
        self._threads: List[threading.Thread] = []
        self._failure: Optional[tuple] = None  # (step, exception)
        _live_checkpointers.add(self)

    def _record_failure(self, step, exc):
        with self._reg_lock:
            if self._failure is None:          # first failure wins
                self._failure = (step, exc)

    def _raise_pending(self):
        with self._reg_lock:
            failure, self._failure = self._failure, None
        if failure is not None:
            step, exc = failure
            raise RuntimeError(f"async checkpoint save for step {step} failed: {exc!r}") from exc

    def save(self, ckpt_dir, step, tree, **kw):
        self._raise_pending()
        host_tree = _walk(tree, "", lambda name, leaf: _host(leaf, copy=True))

        def work():
            with self._io_lock:
                delay = self.backoff_s
                for attempt in range(self.max_retries + 1):
                    try:
                        save(ckpt_dir, step, host_tree, **kw)
                        return
                    except OSError as e:
                        if attempt == self.max_retries:
                            self._record_failure(step, e)
                            return
                        warnings.warn(f"checkpoint save for step {step} hit {e!r}; retrying in {delay:.2f}s "
                                      f"({attempt + 1}/{self.max_retries})")
                        time.sleep(delay)
                        delay *= 2
                    except Exception as e:     # non-retryable: recorded, re-raised on the next call
                        self._record_failure(step, e)
                        return

        t = threading.Thread(target=work, daemon=True)
        with self._reg_lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
            t.start()

    def wait(self):
        """Block until every save issued so far has hit disk; re-raise the
        first recorded worker failure, if any."""
        with self._reg_lock:
            pending = list(self._threads)
        for t in pending:
            t.join()
        with self._reg_lock:
            self._threads = [t for t in self._threads if t.is_alive()]
        self._raise_pending()


_live_checkpointers: "weakref.WeakSet[AsyncCheckpointer]" = weakref.WeakSet()


def _flush_live_checkpointers():
    for acp in list(_live_checkpointers):
        try:
            acp.wait()
        except RuntimeError as e:
            # interpreter exit: surface the failure without aborting the
            # remaining flushes
            warnings.warn(str(e))


atexit.register(_flush_live_checkpointers)


def _step_dirs(ckpt_dir: Path) -> List[Path]:
    """All ``step_*`` checkpoint dirs, oldest first."""
    return sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())


def _shallow_valid(path: Path) -> bool:
    return (path / "manifest.json").exists() and (path / "arrays.npz").exists()


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """Newest step that at least *looks* complete (manifest + arrays on
    disk; ``restore`` does the deep checksum verification). Prefers the
    LATEST pointer, falls back to scanning ``step_*`` dirs newest-first when
    the pointer is missing, stale, or names a torn dir."""
    ckpt_dir = Path(ckpt_dir)
    ptr = ckpt_dir / "LATEST"
    if ptr.exists():
        name = ptr.read_text().strip()
        if _shallow_valid(ckpt_dir / name):
            return int(name.split("_")[1])
    for path in reversed(_step_dirs(ckpt_dir)):
        if _shallow_valid(path):
            return int(path.name.split("_")[1])
    return None


def _read_verified(path: Path) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Read manifest + every array and verify the per-leaf crc32s. Raises
    OSError / BadZipFile / JSONDecodeError / ChecksumError on torn or
    corrupt data — the errors the newest-valid fallback treats as 'try the
    previous step'."""
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as data:
        arrays = {name: data[name] for name in data.files}
    for name, arr in arrays.items():
        want = manifest.get("leaves", {}).get(name, {}).get("crc32")
        if want is None:
            continue  # pre-checksum checkpoint: readable == valid
        got = _crc(arr)
        if got != want:
            raise ChecksumError(f"{path.name}: leaf {name!r} crc32 {got:#010x} != manifest {want:#010x} "
                                f"(torn write or corruption)")
    return arrays, manifest


# Errors _read_verified can raise for bad storage (vs a mismatched `like`
# template, which always raises through).
_STORAGE_ERRORS = (OSError, zipfile.BadZipFile, json.JSONDecodeError, zlib.error, ChecksumError, EOFError)


def restore(ckpt_dir: str | Path, like: Any, *, step: Optional[int] = None,
            shardings: Optional[Any] = None) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (a tree of tensors or numpy
    arrays). Each restored leaf takes its prototype's dtype and, for a
    tensor, its device.

    ``shardings``: a tree whose leaves are ``repro_torch.launch.mesh
    .NamedSharding``s, named like the leaves of ``like`` they lay out (a
    subtree of it, e.g. ``{"opt": ...}``). Each such leaf of ``like`` is
    this rank's shard: the stored whole array is cut to it (the elastic
    path: a checkpoint restores onto whatever mesh the job has).

    Every leaf is checksum-verified against the manifest. With
    ``step=None`` a torn/corrupt newest checkpoint is skipped with a
    warning and the next-newest valid one restored; an explicit ``step``
    raises instead. Template mismatches (wrong shape, missing leaf) always
    raise — they mean ``like`` doesn't match this run, not that storage is
    bad."""
    ckpt_dir = Path(ckpt_dir)
    cut = dict(named_leaves(shardings)) if shardings is not None else {}
    if step is not None:
        arrays, manifest = _read_verified(ckpt_dir / f"step_{step:08d}")
        return _build_tree(arrays, manifest, like, cut)
    candidates = list(reversed(_step_dirs(ckpt_dir)))
    if not candidates:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    last_err: Optional[Exception] = None
    for path in candidates:
        try:
            arrays, manifest = _read_verified(path)
        except _STORAGE_ERRORS as e:
            warnings.warn(f"checkpoint {path.name} unreadable ({e}); falling back to the previous step")
            last_err = e
            continue
        return _build_tree(arrays, manifest, like, cut)
    raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir} ({len(candidates)} torn/corrupt candidates; "
                            f"last error: {last_err!r})")


def _build_tree(arrays: Dict[str, np.ndarray], manifest: Dict[str, Any], like: Any,
                cut: Dict[str, Any]) -> Tuple[Any, Dict[str, Any]]:
    def leaf(name, proto):
        if name not in arrays:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = arrays[name]
        if name in cut:
            arr = cut[name].shard(torch.from_numpy(np.asarray(arr, order="C"))).numpy()
        if tuple(arr.shape) != tuple(proto.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != expected {tuple(proto.shape)}")
        if isinstance(proto, torch.Tensor):
            return torch.from_numpy(np.asarray(arr, order="C")).to(device=proto.device, dtype=proto.dtype)
        return arr.astype(proto.dtype)

    return _walk(like, "", leaf), manifest.get("extra", {})


def _gc(ckpt_dir: Path, keep: int):
    steps = _step_dirs(ckpt_dir)
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)
