"""Repo lint — AST rules for the contracts grep cannot check (JAX's
RPR001-RPR004, ``repro/analysis/lint.py``, restated for the port and
walking ``src/repro_torch``):

  * **RPR001** — CUDA sources (``*.cu``, ``*.cuh``) live under
    ``kernels/csrc/`` and the kernels' library is loaded only under
    ``kernels/`` (``ctypes`` loading, ``cpp_extension`` builds, and
    ``build.library`` / ``build.entry``): a kernel outside the package
    would dodge the registry and so kernelcheck, races and the golden
    signatures.
  * **RPR002** — no host read of a device tensor in a kernel wrapper (the
    functions of the wrapper modules under ``kernels/`` other than the
    plain twins, ``*_plain``): no ``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, and no ``float`` / ``int`` / ``bool`` of a value that may
    be a tensor (a parameter, a call's result, or a subscript of either).
    Each such read waits for the device and breaks the wrappers' promise of
    no host sync. A hit whose value is known to live on the host is
    declared in :data:`RPR002_DECLARED` with its reason.
  * **RPR003** — optional fields of ``*State`` NamedTuples default to
    ``None``, so plain states keep their layout (and checkpoints theirs).
  * **RPR004** — checkpoint modules publish atomically: no ``os.rename``
    or ``shutil.move``, ``os.replace`` only from a staged tmp path, and no
    write of the ``LATEST`` pointer in place.

``lint_source(text, path)`` lints one buffer (the seeded-regression tests);
``run()`` walks ``src/repro_torch``.
"""
from __future__ import annotations

import ast
import time
from pathlib import Path
from typing import Dict, List, Set, Tuple

from .report import PassResult

SRC_ROOT = Path(__file__).resolve().parents[2]  # .../src

LintHit = Tuple[str, int, str]  # (rule, lineno, message)

# Wrapper modules RPR002 reads: the kernels' Python side, less the build
# (no tensor), the plain references and the tiling arithmetic.
_NOT_WRAPPERS = {"build.py", "ref.py", "tiling.py", "__init__.py"}
# Calls whose result is a host value whatever their arguments.
_HOST_CALLS = {"len", "all", "any", "isinstance", "min", "max", "abs", "round", "sum", "range", "getattr"}
# {(path under src/repro_torch, function): reason}: reads that touch no
# device tensor.
RPR002_DECLARED: Dict[Tuple[str, str], str] = {
    ("kernels/fused_adam.py", "host_bias_corrections"):
        "count is the step count of the parameter-writing entries, a Python int by their contract; bc1 and bc2 are "
        "CPU tensors made from it here: no device tensor is read",
}
_LOADERS = {"CDLL", "LoadLibrary", "load_inline"}


def _in(path: str, part: str) -> bool:
    return part in Path(path).parts


def _call_name(node: ast.Call) -> str:
    return ast.unparse(node.func)


def _is_loader(node: ast.Call) -> bool:
    name = _call_name(node)
    last = name.split(".")[-1]
    return (last in _LOADERS or name.startswith(("ctypes.cdll", "cdll.")) or name.endswith("cpp_extension.load")
            or name in ("build.library", "build.entry"))


def _tainted(fn: ast.FunctionDef) -> Set[str]:
    """Names that may hold a tensor: the parameters and every name bound
    from a call (other than a host-valued builtin) or a subscript of a
    tainted name, in source order."""
    args = fn.args
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    names |= {a.arg for a in (args.vararg, args.kwarg) if a is not None}

    def may_tensor(e: ast.AST) -> bool:
        if isinstance(e, ast.Call):
            return not (isinstance(e.func, ast.Name) and e.func.id in _HOST_CALLS)
        if isinstance(e, ast.Name):
            return e.id in names
        if isinstance(e, ast.Subscript):
            return may_tensor(e.value)
        if isinstance(e, (ast.Tuple, ast.List)):
            return any(may_tensor(x) for x in e.elts)
        if isinstance(e, ast.BinOp):
            return may_tensor(e.left) or may_tensor(e.right)
        return False

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and may_tensor(node.value):
            for tgt in node.targets:
                for n in (tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
    return names


def _check_host_reads(fn: ast.FunctionDef) -> List[LintHit]:
    hits: List[LintHit] = []
    tainted = _tainted(fn)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in ("item", "tolist", "cpu", "numpy") and not node.args:
            hits.append(("RPR002", node.lineno, f"`.{f.attr}()` in kernel wrapper `{fn.name}`: a host read of a "
                                                f"tensor waits for the device"))
        elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool") and len(node.args) == 1:
            a = node.args[0]
            inner = a.value if isinstance(a, ast.Subscript) else a
            suspicious = ((isinstance(inner, ast.Name) and inner.id in tainted)
                          or (isinstance(inner, ast.Call)
                              and not (isinstance(inner.func, ast.Name) and inner.func.id in _HOST_CALLS)))
            if suspicious:
                hits.append(("RPR002", node.lineno, f"`{f.id}({ast.unparse(a)})` in kernel wrapper `{fn.name}`: if "
                                                    f"that is a device tensor, the host waits for the device"))
    return hits


def _check_state_defaults(cls: ast.ClassDef) -> List[LintHit]:
    hits: List[LintHit] = []
    for st in cls.body:
        if not isinstance(st, ast.AnnAssign) or "Optional" not in ast.unparse(st.annotation):
            continue
        if not (isinstance(st.value, ast.Constant) and st.value.value is None):
            hits.append(("RPR003", st.lineno, f"optional field `{ast.unparse(st.target)}` of `{cls.name}` must "
                                              f"default to None so plain states keep their layout"))
    return hits


def _check_checkpoint_calls(tree: ast.AST) -> List[LintHit]:
    hits: List[LintHit] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name == "os.rename":
            hits.append(("RPR004", node.lineno, "os.rename in a checkpoint module: publish with os.replace"))
        elif name == "shutil.move":
            hits.append(("RPR004", node.lineno, "shutil.move in a checkpoint module: it can degrade to copy and "
                                                "delete across filesystems; stage and os.replace instead"))
        elif name == "os.replace" and node.args:
            src = ast.unparse(node.args[0])
            if "tmp" not in src.lower():
                hits.append(("RPR004", node.lineno, f"os.replace from `{src}`: the source of a publish must be a "
                                                    f"staged tmp path"))
        elif name == "open" or name.endswith((".write_text", ".write_bytes")):
            src = ast.unparse(node)
            writes = name != "open" or any(
                isinstance(a, ast.Constant) and isinstance(a.value, str) and any(m in a.value for m in "wax")
                for a in list(node.args[1:2]) + [kw.value for kw in node.keywords if kw.arg == "mode"])
            if writes and "'LATEST'" in src.replace('"', "'") and "tmp" not in src.lower():
                hits.append(("RPR004", node.lineno, "in-place write to the LATEST pointer: write a .tmp sibling and "
                                                    "os.replace it into place"))
    return hits


def lint_source(text: str, path: str) -> List[LintHit]:
    """Lint one Python source buffer (``path`` relative to ``src``, e.g.
    ``repro_torch/kernels/x.py``); returns (rule, lineno, message) hits."""
    tree = ast.parse(text, filename=path)
    hits: List[LintHit] = []
    in_kernels = _in(path, "kernels")
    wrapper_module = in_kernels and Path(path).name not in _NOT_WRAPPERS
    rel = "/".join(Path(path).parts[1:]) if Path(path).parts[:1] == ("repro_torch",) else path
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and not in_kernels and _is_loader(node):
            hits.append(("RPR001", node.lineno, f"`{_call_name(node)}` loads kernels outside repro_torch/kernels/: "
                                                f"kernels live in the kernel package so the analysis registry "
                                                f"covers them"))
        elif isinstance(node, ast.FunctionDef) and wrapper_module and not node.name.endswith("_plain"):
            if (rel, node.name) not in RPR002_DECLARED:
                hits.extend(_check_host_reads(node))
        elif isinstance(node, ast.ClassDef) and node.name.endswith("State"):
            hits.extend(_check_state_defaults(node))
    if _in(path, "checkpoint") or "checkpoint" in Path(path).stem:
        hits.extend(_check_checkpoint_calls(tree))
    return hits


def lint_tree(root: Path) -> List[Tuple[str, str, int, str]]:
    """(rule, path, line, message) of every hit under ``root`` (a package
    directory): the Python sources, and CUDA sources outside
    ``kernels/csrc/``."""
    out = []
    for f in sorted(root.rglob("*")):
        rel = f.relative_to(root.parent)
        if f.suffix in (".cu", ".cuh") and rel.parts[1:3] != ("kernels", "csrc"):
            out.append(("RPR001", str(rel), 1, "a CUDA source outside repro_torch/kernels/csrc/"))
        elif f.suffix == ".py":
            try:
                hits = lint_source(f.read_text(), str(rel))
            except SyntaxError as e:
                out.append(("parse", str(rel), 0, f"does not parse: {e}"))
                continue
            out.extend((rule, str(rel), line, msg) for rule, line, msg in hits)
    return out


def run() -> PassResult:
    t0 = time.monotonic()
    result = PassResult("lint")
    root = SRC_ROOT / "repro_torch"
    files = [f for f in root.rglob("*") if f.suffix in (".py", ".cu", ".cuh")]
    result.checks += len(files)
    for rule, rel, line, message in lint_tree(root):
        result.add(rule, f"{rel}:{line}", message)
    result.detail = f"{len(files)} files, {len(RPR002_DECLARED)} declared host reads"
    result.seconds = time.monotonic() - t0
    return result
