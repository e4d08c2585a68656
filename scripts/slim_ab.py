"""Time B1 (``mega_slim_update_batched``), B7 (``slim_update_batched``), B10
(``slim_partial_stats_batched``), B12 (``mega_slim_partial_stats_batched``)
and B13 (``mega_slim_finalize_batched``) of this tree beside an earlier
commit's, in turns on one card.

The earlier commit's ``mega_slim.cu``, ``slim_finalize.cu`` and
``common.cuh`` are taken from git, in a checkout with its history (a copy
without ``.git`` cannot):

    python3 scripts/slim_ab.py --fetch --rev HEAD~

which writes them under ``build/slim_ab/<rev>/``. On the card,

    python3 scripts/slim_ab.py --rev HEAD~

builds them with nvcc into a library of their own and times the earlier
kernel ("parent") and this tree's wrapper ("change") as parent / change /
change / parent:
- B1 on every slim group of chip_smoke.py's plans: full-width gpt_small
  under Table 3 and the four baseline rule sets (AdaLayer, AdaLayer-LN-TL,
  Adam-mini v1 and v2; phases 2 and 9a) and ResNet-18 under Table 3 (phase
  9c), without the flags and with both (``with_snr`` and ``with_health``);
- B7 on gpt_small's 7 Table-3 compressed leaves (phase 8's
  ``slim_update_nd`` views), opt_speed's 4096 x 8192 tensor on both axes,
  AdaLayer's 38,633,472-element embedding line, a (data=2, model=2) rank's
  9,658,368-element embedding shard line and ResNet-18's (1, 4608, 1536)
  axis-0 group (phase 9a), f32 p and g, wd 0.1;
- B12 on the 3 psum groups of phase 6a (rank-local shapes of gpt_small's
  Table-3 plan on the (data=2, model=2) mesh) and the same three long views,
  without the flags and with both;
- B10 on phase 6a's 7 psum leaves (the same plan's rank-local views, 5
  distinct) and the long views, f32 and bf16 g, without the flags and with
  both;
- B13 on phase 6a's 3 psum groups and the long views, in the ek and the
  owner form, with bias corrections a line; a device copy of m' into u
  (the bytes it streams) is timed beside it.
Inputs are drawn as chip_smoke's ``hold_group`` draws them. Each time is
``chip_smoke.Timer``'s (median of ``--reps``, L2 flushed, a device-side wait
first); both versions are held to the plain twin first. An earlier entry
point is called with the signature it has: with the plan's arguments
(from this tree's ``plan_slim``) where its source takes them, else with the
signature it had before them (``_parent_argtypes``); an earlier B13 through
the group entry ``repro_slim_finalize`` where its source has one, else
through the flat walk's entry with this tree's signature. It prints the
card's ``nvidia-smi`` line, a line per case (with the form this tree's
wrapper took: ``megaplan.last_plans``, or B13's ``finalize_plan``) and one
JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/csrc"
FILES = ("mega_slim.cu", "slim_finalize.cu", "common.cuh")
KW = dict(b1=0.9, b2=0.95, eps=1e-8)
STEP = dict(lr=1e-3, wd=0.1, count=3)
FLAG_SETS = {"base": dict(), "flags": dict(with_snr=True, with_health=True)}
ENTRIES = {"B1": "repro_mega_slim_update", "B7": "repro_slim_update", "B10": "repro_slim_partial_stats",
           "B12": "repro_mega_slim_partial_stats"}
WRAPPERS = {"B1": "mega_slim_update_batched", "B7": "slim_update_batched", "B10": "slim_partial_stats_batched",
            "B12": "mega_slim_partial_stats_batched"}
DTYPES = ("f32", "bf16")
LONG_VIEWS = {"embedding line": (1, 1, 50304 * 768, 1), "shard line": (1, 1, 25152 * 384, 1),
              "resnet18 widest": (1, 4608, 1536, 0)}


def _argtypes():
    """This tree's signature of each entry point, and where in it the plan's
    six arguments start (right after the view's axis)."""
    from repro_torch.kernels import megaplan, slim_update

    return {"B1": (megaplan._SLIM_ARGTYPES, 16), "B7": (slim_update._UPDATE_ARGTYPES, 13),
            "B10": (slim_update._PARTIAL_ARGTYPES, 15), "B12": (megaplan._PARTIAL_ARGTYPES, 13)}


def _b13_argtypes(build):
    """The group entry ``repro_slim_finalize`` of the commits before B13
    took the flat walk: m', v, ek, bc1, bc2, u, v', the view, the axis, b2,
    1 - b2, eps and the stream."""
    return [build.PTR] * 7 + [build.SIZE] * 3 + [build.INT] + [build.F32] * 3 + [build.PTR]


def _parent_argtypes(kernel: str, planned: bool, combined: bool):
    """The earlier entry point's signature: this tree's where it takes the
    plan's arguments, else this tree's without them; B10's and B12's
    without the combine's grid after them where it does not take that
    (``combined``)."""
    types, at = _argtypes()[kernel]
    if kernel in ("B10", "B12") and not combined:
        types = types[:at + 6] + types[at + 7:]
    return types if planned else types[:at] + types[at + 6:]


def fetch(rev: str, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for name in FILES:
        text = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"], cwd=ROOT, capture_output=True, text=True,
                              check=True).stdout
        (out / name).write_text(text)
    print(f"wrote {', '.join(FILES)} of {rev} to {out}")


def slim_groups(torch):
    """{(batch, rows, cols, axis): [plan labels]} over chip_smoke's plans."""
    from repro_torch.configs import get_config
    from repro_torch.core import baselines, rules_to_dims, table3_rules
    from repro_torch.core.labels import flatten_with_names
    from repro_torch.kernels import megaplan
    from repro_torch.models import ResNetConfig

    out = {}
    for model, spec in (("gpt_small", get_config("gpt_small").specs()), ("resnet18", ResNetConfig().specs())):
        specs = dict(flatten_with_names(spec))
        meta = {k: s.meta() for k, s in specs.items()}
        sets = {"table3": table3_rules(meta)}
        if model == "gpt_small":
            sets.update({n: getattr(baselines, f"{n}_rules")(meta)
                         for n in ("adalayer", "adalayer_ln_tl", "adam_mini_v1", "adam_mini_v2")})
        for label, rules in sets.items():
            dims = rules_to_dims(rules, meta)
            plan = megaplan.plan_megagroups([s.shape for s in specs.values()], [torch.float32] * len(specs),
                                            [dims[k] for k in specs])
            for g in plan.groups:
                if g.kind != "dense":
                    out.setdefault((g.batch, g.rows, g.cols, g.axis), []).append(f"{model}:{label}")
    return out


def write_views(torch):
    """{(batch, rows, cols, axis): [labels]}: B7's canonical views of
    gpt_small's Table-3 compressed leaves, opt_speed's tensor and the long
    views."""
    from repro_torch.configs import get_config
    from repro_torch.core import rules_to_dims, table3_rules
    from repro_torch.core.labels import flatten_with_names
    from repro_torch.kernels import ops

    specs = dict(flatten_with_names(get_config("gpt_small").specs()))
    meta = {k: s.meta() for k, s in specs.items()}
    dims = rules_to_dims(table3_rules(meta), meta)
    out = {}
    for name, s in specs.items():
        plan = ops.leaf_plan(tuple(s.shape), torch.float32, dims[name])
        if plan.route == "slim":
            cn = plan.cn
            out.setdefault((cn.batch, cn.rows, cn.cols, cn.axis), []).append(f"gpt_small:{name}")
    for axis in (1, 0):
        out.setdefault((1, 4096, 8192, axis), []).append("opt_speed")
    for label, view in LONG_VIEWS.items():
        out.setdefault(view, []).append(label)
    return out


def _psum_plans(torch):
    """gpt_small's Table-3 plan on a (data=2, model=2) mesh at a rank's
    local shapes: (psum leaf items as the grouped route groups them, the
    leaves' plans)."""
    from repro_torch.configs import get_config
    from repro_torch.core import rules_to_dims, table3_rules
    from repro_torch.core.labels import flatten_with_names
    from repro_torch.sharding import ShardingContext, param_specs, use_sharding
    from repro_torch.sharding.shardspec import SpecMesh, plan_sharded_tree

    specs = dict(flatten_with_names(get_config("gpt_small").specs()))
    meta = {k: s.meta() for k, s in specs.items()}
    mesh = SpecMesh({"data": 2, "model": 2})
    with use_sharding(ShardingContext(mesh)):
        pspecs = param_specs(meta, {k: torch.empty(s.shape, device="meta") for k, s in specs.items()})
    dims = rules_to_dims(table3_rules(meta), meta)
    names = list(specs)
    plans = plan_sharded_tree([tuple(specs[k].shape) for k in names], [torch.float32] * len(names),
                              [tuple(dims[k]) for k in names], [pspecs[k] for k in names], mesh)
    items = [(i, pl.local_shape, tuple(1 if d in dims[names[i]] else s for d, s in enumerate(pl.local_shape)),
              dims[names[i]], pl.cn) for i, pl in enumerate(plans) if pl.regime == "psum"]
    return items, plans, names


def psum_views(torch):
    """{(batch, rows, cols, axis): [labels]}: the psum groups of gpt_small's
    Table-3 plan on a (data=2, model=2) mesh at a rank's local shapes (phase
    6a's B12 and B13 groups, owner and plain forms apart), and the long
    views."""
    from repro_torch.kernels import megaplan

    items, plans, _ = _psum_plans(torch)
    out = {}
    for form in ("owner", "plain"):
        for grp in megaplan.groups_from_plans([it for it in items if bool(plans[it[0]].owner) == (form == "owner")]):
            out.setdefault((grp.batch, grp.rows, grp.cols, grp.axis), []).append(
                f"6a {form} {grp.kind}[{len(grp.segments)}]")
    for label, view in LONG_VIEWS.items():
        out.setdefault(view, []).append(label)
    return out


def psum_leaf_views(torch):
    """{(batch, rows, cols, axis): [labels]}: the same plan's 7 psum leaves
    at a rank's local canonical views (phase 6a's B10 views), and the long
    views."""
    items, _, names = _psum_plans(torch)
    out = {}
    for i, _, _, _, cn in items:
        out.setdefault((cn.batch, cn.rows, cn.cols, cn.axis), []).append(f"6a {names[i]}")
    for label, view in LONG_VIEWS.items():
        out.setdefault(view, []).append(label)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rev", default="HEAD~", help="the earlier commit (a git revision)")
    ap.add_argument("--fetch", action="store_true", help="only write the earlier commit's sources (needs git)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--kernels", default="B1,B7,B10,B12,B13", help="which of B1, B7, B10, B12, B13 to time")
    cli = ap.parse_args()
    old_dir = ROOT / "build" / "slim_ab" / re.sub(r"[^\w.-]", "_", cli.rev)
    if cli.fetch:
        fetch(cli.rev, old_dir)
        return 0
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels import build, megaplan, slim_update
    from repro_torch.kernels.fused_adam import host_bias_corrections
    from repro_torch.optim.fused import bias_corrections

    if not torch.cuda.is_available():
        print("slim_ab: no CUDA device", file=sys.stderr)
        return 2
    if not all((old_dir / name).exists() for name in FILES):
        print(f"slim_ab: run with --fetch --rev {cli.rev} in a git checkout first", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    lib_path = old_dir / "libold.so"
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
                    str(lib_path), str(old_dir / "mega_slim.cu"), str(old_dir / "slim_finalize.cu")], check=True)
    old = ctypes.CDLL(str(lib_path))
    source = (old_dir / "mega_slim.cu").read_text()
    finalize_source = (old_dir / "slim_finalize.cu").read_text()
    fns, planned, combined = {}, {}, {}
    for kernel, entry in ENTRIES.items():
        sig = re.search(rf'extern "C" int {entry}\((.*?)\)\s*{{', source, re.S).group(1)
        planned[kernel] = "int form" in sig
        combined[kernel] = "combine_blocks" in sig
        argtypes = _parent_argtypes(kernel, planned[kernel], combined[kernel])
        if sig.count(",") + 1 != len(argtypes):
            raise SystemExit(f"slim_ab: the earlier {entry} has another signature; compare with git instead")
        fns[kernel] = getattr(old, entry)
        fns[kernel].argtypes, fns[kernel].restype = argtypes, ctypes.c_int
    group_entry = 'extern "C" int repro_slim_finalize(' in finalize_source
    if group_entry:
        fns["B13"] = old.repro_slim_finalize
        fns["B13"].argtypes = _b13_argtypes(build)
    else:
        sig = re.search(r'extern "C" int repro_slim_finalize_flat\((.*?)\)\s*{', finalize_source, re.S).group(1)
        if sig.count(",") + 1 != len(slim_update._FLAT_ARGTYPES):
            raise SystemExit("slim_ab: the earlier repro_slim_finalize_flat has another signature")
        fns["B13"] = old.repro_slim_finalize_flat
        fns["B13"].argtypes = slim_update._FLAT_ARGTYPES
    fns["B13"].restype = ctypes.c_int
    print(f"earlier entry points take the plan's arguments: {planned}; earlier B13 through the group entry: "
          f"{group_entry}", flush=True)
    dev = torch.device("cuda")

    def walk(kernel, g, m, axis, flags, p=None):
        """The plan's arguments where the earlier entry point takes them."""
        if not planned[kernel]:
            return (), None
        args, work = megaplan.slim_walk(kernel, g, m, axis, p=p, **{k: flags.get(k, False)
                                                                   for k in ("with_snr", "with_health")})
        if combined.get(kernel):
            args += (megaplan.last_plans[kernel].combine_blocks,)
        return args, work

    def b1_parent(g, m, v, bc1, bc2, axis, with_snr=False, with_health=False):
        b, r, c = g.shape
        u, m_out, v_out = torch.empty_like(g), torch.empty_like(g), torch.empty_like(v)
        snr = tuple(torch.empty_like(v) for _ in range(2)) if with_snr else (None, None)
        health = tuple(torch.empty_like(v) for _ in range(2)) if with_health else (None, None)
        plan, work = walk("B1", g, m, axis, dict(with_snr=with_snr, with_health=with_health))
        build.launch("mega_slim_update_batched (earlier)", fns["B1"], dev,
                     *(t.data_ptr() for t in (g, m, v, bc1, bc2, u, m_out, v_out)), *map(build.ptr, snr + health),
                     b, r, c, axis, *plan, 1.0 / (c if axis == 1 else r), KW["b1"], 1.0 - KW["b1"], KW["b2"],
                     1.0 - KW["b2"], KW["eps"])
        return (u, m_out, v_out) + (snr if with_snr else ()) + (health if with_health else ())

    def b1_change(g, m, v, bc1, bc2, axis, **flags):
        return megaplan.mega_slim_update_batched(g, m, v, bc1, bc2, axis=axis, **flags, **KW)

    c1, c2 = host_bias_corrections(KW["b1"], KW["b2"], STEP["count"])

    def b7_parent(p, g, m, v, axis):
        b, r, c = p.shape
        p_out, m_out, v_out = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
        plan, work = walk("B7", g, m, axis, {}, p=p)
        build.launch("slim_update_batched (earlier)", fns["B7"], dev, p.data_ptr(), 0, g.data_ptr(), 0,
                     m.data_ptr(), v.data_ptr(), p_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(), b, r, c, axis,
                     *plan, 1.0 / (c if axis == 1 else r), STEP["lr"], STEP["wd"], c1, c2, KW["b1"], 1.0 - KW["b1"],
                     KW["b2"], 1.0 - KW["b2"], KW["eps"])
        return p_out, m_out, v_out

    def b7_change(p, g, m, v, axis):
        return slim_update.slim_update_batched(p, g, m, v, axis=axis, **STEP, **KW)

    def b12_parent(g, m, axis, with_snr=False, with_health=False):
        b, r, c = g.shape
        line = (b, r, 1) if axis == 1 else (b, 1, c)
        m_out = torch.empty_like(g)
        part = torch.empty(line, dtype=torch.float32, device=dev)
        snr = tuple(torch.empty_like(part) for _ in range(3)) if with_snr else (None,) * 3
        health = tuple(torch.empty_like(part) for _ in range(2)) if with_health else (None, None)
        plan, work = walk("B12", g, m, axis, dict(with_snr=with_snr, with_health=with_health))
        build.launch("mega_slim_partial_stats_batched (earlier)", fns["B12"], dev, g.data_ptr(), m.data_ptr(),
                     m_out.data_ptr(), part.data_ptr(), *map(build.ptr, snr + health), b, r, c, axis, *plan,
                     KW["b1"], 1.0 - KW["b1"])
        return (m_out, part) + (snr if with_snr else ()) + (health if with_health else ())

    def b12_change(g, m, axis, **flags):
        return megaplan.mega_slim_partial_stats_batched(g, m, axis=axis, b1=KW["b1"], **flags)

    def b10_parent(g, m, axis, with_snr=False, with_health=False):
        b, r, c = g.shape
        line = (b, r, 1) if axis == 1 else (b, 1, c)
        m_out = torch.empty(g.shape, dtype=torch.float32, device=dev)
        part = torch.empty(line, dtype=torch.float32, device=dev)
        snr = tuple(torch.empty_like(part) for _ in range(3)) if with_snr else (None,) * 3
        lines = tuple(torch.empty_like(part) for _ in range(2)) if with_health else (None, None)
        health = torch.empty(2, dtype=torch.float32, device=dev) if with_health else None
        plan, work = walk("B10", g, m, axis, dict(with_snr=with_snr, with_health=with_health))
        build.launch("slim_partial_stats_batched (earlier)", fns["B10"], dev, g.data_ptr(),
                     int(g.dtype == torch.bfloat16), m.data_ptr(), m_out.data_ptr(), part.data_ptr(),
                     *map(build.ptr, (*snr, *lines, health)), b, r, c, axis, *plan, KW["b1"], 1.0 - KW["b1"])
        return (m_out, part) + (snr if with_snr else ()) + ((health,) if with_health else ())

    def b10_change(g, m, axis, **flags):
        return slim_update.slim_partial_stats_batched(g, m, axis=axis, b1=KW["b1"], **flags)

    def b13_parent(m_new, v, ek, l1, l2, axis):
        b, r, c = m_new.shape
        u = torch.empty_like(m_new)
        v_out = torch.empty_like(v) if ek is not None else None
        if group_entry:
            build.launch("mega_slim_finalize_batched (earlier)", fns["B13"], dev, m_new.data_ptr(), v.data_ptr(),
                         build.ptr(ek), l1.data_ptr(), l2.data_ptr(), u.data_ptr(), build.ptr(v_out), b, r, c,
                         axis, KW["b2"], 1.0 - KW["b2"], KW["eps"])
        else:
            plan = slim_update.finalize_plan(m_new, axis, (v, ek, l1, l2))
            build.launch("mega_slim_finalize_batched (earlier)", fns["B13"], dev, m_new.data_ptr(), v.data_ptr(),
                         build.ptr(ek), l1.data_ptr(), l2.data_ptr(), u.data_ptr(), build.ptr(v_out), None, 0, 1.0,
                         1.0, 0.0, KW["b2"], 1.0 - KW["b2"], KW["eps"], b, r, c, axis, plan.vec, int(plan.wide),
                         plan.blocks)
        return u if ek is None else (u, v_out)

    def b13_change(m_new, v, ek, l1, l2, axis):
        return megaplan.mega_slim_finalize_batched(m_new, v, l1, l2, axis=axis, ek=ek, b2=KW["b2"], eps=KW["eps"])

    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device=dev).manual_seed(0)
    bc1, bc2 = bias_corrections(0.9, 0.95, torch.tensor(3, dtype=torch.int32, device=dev))

    def cases():
        """(kernel, view, labels, flag label, versions, operands, twin) for each case."""
        wanted = set(cli.kernels.split(","))
        if "B1" in wanted:
            for (b, r, c, axis), labels in sorted(slim_groups(torch).items()):
                line = (b, r, 1) if axis == 1 else (b, 1, c)
                g = 1e-3 * torch.randn((b, r, c), generator=gen, device=dev)
                m = 1e-4 * torch.randn((b, r, c), generator=gen, device=dev)
                v = 1e-6 * torch.rand(line, generator=gen, device=dev)
                ops = (g, m, v, bc1.expand(line).contiguous(), bc2.expand(line).contiguous(), axis)
                for label, flags in FLAG_SETS.items():
                    yield ("B1", (b, r, c, axis), labels, label, (b1_parent, b1_change), ops, flags,
                           lambda flags=flags, ops=ops: megaplan.mega_slim_update_batched_plain(
                               *ops[:5], axis=ops[5], **flags, **KW))
        if "B7" in wanted:
            for (b, r, c, axis), labels in sorted(write_views(torch).items()):
                line = (b, r, 1) if axis == 1 else (b, 1, c)
                p = 0.02 * torch.randn((b, r, c), generator=gen, device=dev)
                g = 1e-3 * torch.randn((b, r, c), generator=gen, device=dev)
                m = 1e-4 * torch.randn((b, r, c), generator=gen, device=dev)
                v = 1e-6 * torch.rand(line, generator=gen, device=dev)
                ops = (p, g, m, v, axis)
                yield ("B7", (b, r, c, axis), labels, "base", (b7_parent, b7_change), ops, {},
                       lambda ops=ops: slim_update.slim_update_batched_plain(
                           *ops[:4], axis=ops[4], lr=STEP["lr"], wd=STEP["wd"], bc1=c1, bc2=c2, **KW))
        if "B12" in wanted:
            for (b, r, c, axis), labels in sorted(psum_views(torch).items()):
                g = 1e-3 * torch.randn((b, r, c), generator=gen, device=dev)
                m = 1e-4 * torch.randn((b, r, c), generator=gen, device=dev)
                ops = (g, m, axis)
                for label, flags in FLAG_SETS.items():
                    yield ("B12", (b, r, c, axis), labels, label, (b12_parent, b12_change), ops, flags,
                           lambda flags=flags, ops=ops: megaplan.mega_slim_partial_stats_batched_plain(
                               *ops[:2], axis=ops[2], b1=KW["b1"], **flags))
        if "B10" in wanted:
            for (b, r, c, axis), labels in sorted(psum_leaf_views(torch).items()):
                g = 1e-3 * torch.randn((b, r, c), generator=gen, device=dev)
                m = 1e-4 * torch.randn((b, r, c), generator=gen, device=dev)
                for dt in DTYPES:
                    ops = (g if dt == "f32" else g.to(torch.bfloat16), m, axis)
                    for label, flags in FLAG_SETS.items():
                        yield ("B10", (b, r, c, axis), labels, f"{dt} {label}", (b10_parent, b10_change), ops,
                               flags, lambda flags=flags, ops=ops: slim_update.slim_partial_stats_batched_plain(
                                   *ops[:2], axis=ops[2], b1=KW["b1"], **flags))
        if "B13" in wanted:
            for (b, r, c, axis), labels in sorted(psum_views(torch).items()):
                line = (b, r, 1) if axis == 1 else (b, 1, c)
                m_new = 1e-4 * torch.randn((b, r, c), generator=gen, device=dev)
                v = 1e-6 * torch.rand(line, generator=gen, device=dev) + 1e-8
                ek = 1e-6 * torch.rand(line, generator=gen, device=dev)
                l1, l2 = bc1.expand(line).contiguous(), bc2.expand(line).contiguous()
                for form, e in (("ek", ek), ("owner", None)):
                    ops = (m_new, v, e, l1, l2, axis)
                    yield ("B13", (b, r, c, axis), labels, form, (b13_parent, b13_change), ops, {},
                           lambda ops=ops: slim_update.slim_finalize_batched_plain(
                               *ops[:2], *ops[3:5], b2=KW["b2"], eps=KW["eps"], ek=ops[2]))

    rows = []
    for kernel, (b, r, c, axis), labels, label, (parent, change), ops, flags, twin in cases():
        versions = {"parent": parent, "change": change}
        want = twin()
        want = want if isinstance(want, tuple) else (want,)
        errs = {}
        for name, fn in versions.items():
            got = fn(*ops, **flags)
            got = got if isinstance(got, tuple) else (got,)
            errs[name] = max(chip_smoke.max_err(a.float().nan_to_num(), w.float().nan_to_num())[1]
                             for a, w in zip(got, want))
            if errs[name] > chip_smoke.TOL_LINE:
                raise AssertionError(f"slim_ab: {kernel} {name} on {(b, r, c)} axis {axis} {label} is "
                                     f"{errs[name]:.3e} from the twin")
        if kernel == "B13":
            form = slim_update.finalize_plan(ops[0], ops[5], ops[1:5]).describe()
        else:
            form = megaplan.last_plans[WRAPPERS[kernel]].describe()   # the plan of the change's call just made
        del want
        times = {name: [] for name in versions}
        for name in ("parent", "change", "change", "parent"):
            times[name].append(timer(lambda: versions[name](*ops, **flags), reps=cli.reps))
        med = {name: statistics.median(t) for name, t in times.items()}
        row = dict(kernel=kernel, shape=[b, r, c], axis=axis, flags=label, form=form, labels=labels,
                   parent_ms=med["parent"], change_ms=med["change"], ratio=med["change"] / med["parent"],
                   max_rel_err=errs, blocks=times)
        copy = ""
        if kernel == "B13":   # the yardstick: a device copy of m' into u
            u = torch.empty_like(ops[0])
            row["copy_ms"] = timer(lambda: u.copy_(ops[0]), reps=cli.reps)
            copy = f"  copy {row['copy_ms']:.4f} ms"
            del u
        rows.append(row)
        print(f"  {kernel} ({b}, {r}, {c}) axis {axis} {label}: parent {med['parent']:.4f} ms  change "
              f"{med['change']:.4f} ms  ({row['ratio']:.3f}x){copy}  [{form}]  {', '.join(labels)}", flush=True)
    print(json.dumps(dict(device=smi, rev=cli.rev, reps=cli.reps, planned=planned, cases=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
