"""Logical-axis sharding: one rule table maps model axis names to mesh axes
(port of ``repro/sharding/logical.py``).

Models name each parameter dim with a logical axis ('embed', 'mlp',
'heads', ...; ``ParamMeta.axes``). A :class:`ShardingContext` installed
with :func:`use_sharding` resolves them to :class:`PartitionSpec`s for its
mesh; the trainer reads it to shard the optimizer state and the SNR pass.

Divisibility guard: a logical axis whose dim does not divide the mapped
mesh-axis size falls back to replication for that dim, so one rule table
serves every architecture.

On a process mesh (``repro_torch.launch.mesh.Mesh``) with a ``model``
axis the forward runs as the JAX package's does under a mesh, with the
layout made explicit instead of constrained: each rank holds the rows of
its batch-axis block (``pod``, ``data``) and, between blocks, its
contiguous ``1/tp`` of the sequence (the ``seq_sp`` layout); the tensor-,
sequence- and expert-parallel regions of ``repro_torch.models`` gather the
sequence over ``model`` on entry, compute with this rank's slice of each
(whole) weight, and reduce-scatter on exit. A :class:`Layout` says which
layout a forward runs in; :func:`region` counts each region taken in its
parallel form against the whole-region fallback (JAX's GSPMD path), by
layer kind. :func:`constrain` stays a no-op: the JAX model's constraints
became that layout (``repro/models/transformer.py:240, :261``: the
residual stream in ``seq_sp``, which
:func:`repro_torch.models.transformer.forward` cuts after the embedding),
the gather before the head (``:270-275``: the port computes the head and
the loss on each rank's own positions instead, see
``repro_torch.train.loss.lm_loss``), and the regions' own in/out specs
(``mlp_moe.py``, ``attention.py``, ``ssm.py``). Under a device-free
``SpecMesh`` the forward runs unsharded; only the MoE's dispatch groups
(:attr:`Layout.groups`) follow the mesh's batch axes.

A one-token decode step runs in the decode layout (:func:`decode_layout`,
JAX's ``make_serve_step`` under ``repro/launch/dryrun.py:204-217``): a
length-1 sequence does not split, so the residual stream is whole on every
rank of a model group, and each region takes its all-reduce form: the
rank's heads, columns, channels or experts, a partial sum completed by a
``psum`` over ``model``, no gather or reduce-scatter of the sequence. The
decode caches lie as ``decode_cache_specs`` cuts them: rows over the batch
axes, each model rank a contiguous block of the KV cache's positions
(``seq_kv``) and of the SSM state's channels (``d_inner``), a dim ``tp``
does not divide whole on every rank (:meth:`Layout.block`). Stored shards
are read there through :func:`dot` and :func:`lookup`, which gather no
weight: the activations move instead.

Parameter storage. The regions read every weight through :func:`weight`:
from a whole weight (a plain dict) it narrows to the region's slice; from
:class:`Weights`, each rank's stored shards under the parameter specs (as
``repro/launch/train.py`` stores them: ``embed`` over ``data``, the wide
dims over ``model``), it keeps a dim whose slice is the stored block and
all-gathers the others, the FSDP gather over ``data`` that JAX's
``shard_map`` entries make (``repro/models/ssm.py:349-350``). Leaves used
outside a region (the embedding, the head, norms, the router) are
gathered whole at their point of use, so one layer's gathered weights are
live at a time (the forward rematerializes each layer over stored shards).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from .shardspec import PartitionSpec as P, even_spec, spec_entries

MeshAxes = Union[None, str, Tuple[str, ...]]

_ctx = threading.local()


def default_rules(mesh) -> Dict[str, MeshAxes]:
    """The production rule table (FSDP x TP x EP (+ pod DP))."""
    has_pod = "pod" in mesh.axis_names
    batch: MeshAxes = ("pod", "data") if has_pod else ("data",)
    return {
        # activations
        "batch": batch,
        "seq": None,
        "seq_sp": "model",
        "seq_kv": "model",
        "act_embed": None,
        "act_mlp": "model",
        "act_heads": "model",
        # parameters
        "embed": "data",      # FSDP axis
        "vocab": "model",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "experts": "model",   # EP
        "layers": None,
        "d_inner": "model",
        "state": None,
        "conv_w": None,
        "dt_rank": None,
        "frame": None,
        "patch": None,
        "pos": None,
    }


class ShardingContext:
    """A mesh (``repro_torch.launch.mesh.Mesh`` or a device-free
    ``SpecMesh``) plus the rule table, ``default_rules`` updated by
    ``rules``."""

    def __init__(self, mesh, rules: Optional[Mapping[str, MeshAxes]] = None):
        self.mesh = mesh
        self.rules = dict(default_rules(mesh))
        if rules:
            self.rules.update(rules)

    def spec_for(self, logical_axes: Sequence[Optional[str]], shape: Optional[Sequence[int]] = None,
                 *, allow_pad: bool = False) -> P:
        """PartitionSpec for logical axes, with the divisibility fallback
        (``allow_pad`` keeps an uneven split where the dim is at least the
        axis size, as the JAX package allows for intermediates)."""
        entries = []
        used: set = set()
        for i, name in enumerate(logical_axes):
            mesh_axes = self.rules.get(name) if name else None
            if mesh_axes is None:
                entries.append(None)
                continue
            axes_t = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
            # a mesh axis may appear at most once in a PartitionSpec
            axes_t = tuple(a for a in axes_t if a not in used and a in self.mesh.axis_names)
            if not axes_t:
                entries.append(None)
                continue
            size = math.prod(int(self.mesh.shape[a]) for a in axes_t)
            if shape is not None and shape[i] % size != 0:
                if allow_pad and shape[i] >= size:
                    used.update(axes_t)
                    entries.append(axes_t if len(axes_t) > 1 else axes_t[0])
                else:
                    entries.append(None)
                continue
            used.update(axes_t)
            entries.append(axes_t if len(axes_t) > 1 else axes_t[0])
        return P(*entries)


def current() -> Optional[ShardingContext]:
    return getattr(_ctx, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingContext]):
    prev = getattr(_ctx, "ctx", None)
    _ctx.ctx = ctx
    try:
        yield ctx
    finally:
        _ctx.ctx = prev


def constrain(x: Any, *logical_axes: Optional[str]) -> Any:
    """The JAX package's activation sharding constraint. A no-op in the
    port, whose layout is explicit (see the module docstring)."""
    return x


def is_process_mesh(mesh: Any) -> bool:
    """A mesh of ranks with collectives (``launch.mesh.Mesh``), not the
    device-free ``SpecMesh``."""
    return hasattr(mesh, "device_mesh")


def batch_axes(mesh: Any, rules: Optional[Mapping[str, MeshAxes]] = None) -> Tuple[str, ...]:
    """The mesh axes the batch splits over: the ``batch`` rule of ``rules``,
    by default the active context's where it is on ``mesh`` (a config's
    ``sharding_overrides`` may add ``model``), else the production table's
    (``pod``, ``data``)."""
    if rules is None:
        ctx = current()
        rules = ctx.rules if ctx is not None and ctx.mesh is mesh else default_rules(mesh)
    rule = rules.get("batch")
    axes = (rule,) if isinstance(rule, str) else tuple(rule or ())
    return tuple(a for a in axes if a in mesh.axis_names)


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a forward's activations lie on the mesh. ``ctx``: the sharding
    context it was captured from (None: one device). On a process mesh with
    a ``model`` axis of ``tp > 1`` ranks, ``sp`` says whether the residual
    stream is cut along the sequence (``seq_sp``: the length divides by
    ``tp``) or every rank of a model group holds it whole. Either way each
    rank *owns* a contiguous part of the positions (:meth:`own`): the loss
    and the MoE's load-balance statistics read only those, so a value the
    model group computes alike reaches the loss once."""

    ctx: Optional[ShardingContext] = None
    sp: bool = False
    decode: bool = False
    seq_kv: int = 0   # decode: the caches' global positions (0: as many as a rank holds)

    @property
    def mesh(self):
        return self.ctx.mesh if self.ctx is not None else None

    @property
    def process(self) -> bool:
        return self.ctx is not None and is_process_mesh(self.ctx.mesh)

    @property
    def tp(self) -> int:
        """The tensor-parallel degree: the ``model`` axis, unless the rules
        spend it on the batch (pure data parallelism)."""
        if not self.process or "model" not in self.mesh.axis_names \
                or "model" in batch_axes(self.mesh, self.ctx.rules):
            return 1
        return int(self.mesh.shape["model"])

    @property
    def idx(self) -> int:
        return self.mesh.axis_index("model") if self.tp > 1 else 0

    @property
    def groups(self) -> int:
        """The MoE's dispatch groups, JAX's G: the product of the batch axes
        (the caller falls back to 1 when the global batch does not divide)."""
        if self.ctx is None:
            return 1
        return math.prod(int(self.mesh.shape[a]) for a in batch_axes(self.mesh, self.ctx.rules))

    def own(self, s: int) -> Tuple[int, int]:
        """(start, length) of the positions of a length-``s`` sequence this
        rank owns: its model index's part of ``tensor_split``."""
        if self.tp == 1:
            return 0, s
        q, r = divmod(s, self.tp)
        i = self.idx
        return i * q + min(i, r), q + (1 if i < r else 0)

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence of a residual-stream tensor (B, S_l, ...)."""
        if not self.sp:
            return x
        from ..launch.mesh import all_gather

        return all_gather(x, self.mesh, "model", 1)

    def keep_own(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's part, in the layout, of a whole-sequence result."""
        if not self.sp:
            return y
        start, n = self.own(y.shape[1])
        return y.narrow(1, start, n)

    def whole(self, fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """JAX's fallback for a region: gather the sequence, compute the
        region whole, keep this rank's part."""
        return self.keep_own(fn(self.gather_seq(x)))

    def block(self, name: str, size: int) -> Tuple[int, int]:
        """(start, length) of this rank's part of a length-``size`` dim
        named by the logical axis ``name`` (``seq_kv``, ``d_inner``,
        ``vocab``): its model index's contiguous ``size/tp`` where
        ``spec_for`` cuts the dim over ``model``, else the whole dim, as
        JAX's ``spec_for`` falls back."""
        if self.tp > 1 and spec_entries(self.ctx.spec_for((name,), (size,)), 1)[0] == ("model",):
            n = size // self.tp
            return self.idx * n, n
        return 0, size

    def count(self, kind: str, parallel: bool) -> None:
        """:func:`region` of ``kind``, a decode form counted as
        ``decode_<kind>`` beside the training forms."""
        region(f"decode_{kind}" if self.decode else kind, parallel)


_layout = threading.local()


def capture_layout(seq_len: Optional[int] = None) -> Layout:
    """The layout of a forward over ``seq_len`` positions under the active
    context: ``sp`` where a process mesh's ``model`` axis divides it (with
    ``seq_len`` None: the layout a region called directly takes, ``sp`` on
    any such mesh)."""
    ctx = current()
    lay = Layout(ctx, False)
    if lay.tp > 1:
        lay = Layout(ctx, seq_len is None or seq_len % lay.tp == 0)
    return lay


def active_layout() -> Layout:
    """The layout set by :func:`use_layout`, else the one captured from the
    active context."""
    lay = getattr(_layout, "lay", None)
    return lay if lay is not None else capture_layout()


@contextlib.contextmanager
def use_layout(lay: Optional[Layout]):
    """Run the block in ``lay`` (a remat recompute re-enters the layout its
    forward captured, whatever context is active when it runs)."""
    prev = getattr(_layout, "lay", None)
    _layout.lay = lay
    try:
        yield lay
    finally:
        _layout.lay = prev


LOCAL = Layout(None, False)


def decode_layout(seq_kv: int) -> Layout:
    """The layout of a one-token decode step over caches of ``seq_kv``
    global positions (0: as many as each rank holds, the caches whole): on a
    process mesh under the active context, the
    decode layout (the residual stream whole on every rank of a model
    group; with ``tp > 1`` each region's all-reduce form); otherwise
    :data:`LOCAL`, one device as before."""
    ctx = current()
    if ctx is None or not is_process_mesh(ctx.mesh):
        return LOCAL
    return Layout(ctx, False, True, int(seq_kv))


_regions: Dict[str, Dict[str, int]] = {}


def region(kind: str, parallel: bool) -> None:
    """Count one forward of a ``kind`` region ('mlp', 'attn', 'ssm', 'moe';
    a decode step's 'decode_mlp', 'decode_attn', 'decode_ssm',
    'decode_moe', 'decode_embed', 'decode_head', see :meth:`Layout.count`)
    on a process mesh with ``tp > 1``: in its parallel form, or by the
    whole-region fallback."""
    row = _regions.setdefault(kind, {"parallel": 0, "fallback": 0})
    row["parallel" if parallel else "fallback"] += 1


def region_counts(reset: bool = False) -> Dict[str, Dict[str, int]]:
    """``{kind: {'parallel': n, 'fallback': n}}`` since the last reset."""
    out = {k: dict(v) for k, v in _regions.items()}
    if reset:
        _regions.clear()
    return out


def _cut(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor under ``spec`` (entries that do
    not divide replicate), by differentiable narrows."""
    spec = even_spec(tuple(x.shape), spec, mesh)
    for d, axes in enumerate(spec_entries(spec, x.ndim)):
        if axes:
            n = math.prod(int(mesh.shape[a]) for a in axes)
            blk = x.shape[d] // n
            x = x.narrow(d, mesh.group_index(axes) * blk, blk)
    return x


def _cut_tree(tree, specs, mesh):
    """:func:`_cut` over a (nested) dict of tensors; ``specs`` a dict of the
    same keys or one PartitionSpec for the whole subtree."""
    if isinstance(tree, dict):
        return {k: _cut_tree(v, specs[k] if isinstance(specs, dict) else specs, mesh) for k, v in tree.items()}
    return _cut(tree, specs, mesh) if isinstance(tree, torch.Tensor) else tree


def shard_map(f: Callable, mesh, in_specs, out_specs) -> Callable:
    """``jax.shard_map`` over whole inputs: the returned function cuts each
    whole input (a tensor, or a nested dict of them with a PartitionSpec per
    leaf or one for a whole subtree) to this rank's block by its spec,
    differentiably, and runs ``f`` on the blocks. ``out_specs`` documents
    the layout of ``f``'s local outputs, which are returned as they are
    (every rank computes its own block; nothing is gathered)."""
    del out_specs

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map: {len(args)} inputs, {len(in_specs)} in_specs")
        return f(*(_cut_tree(a, s, mesh) for a, s in zip(args, in_specs)))

    return run


def shardings_for_tree(meta: Mapping[str, Any], params: Mapping[str, Any]) -> Dict[str, Any]:
    """``{name: NamedSharding}`` of a parameter dict under the active
    context (raises without one)."""
    from ..launch.mesh import NamedSharding

    ctx = current()
    if ctx is None:
        raise RuntimeError("shardings_for_tree requires an active ShardingContext")
    return {k: NamedSharding(ctx.mesh, ctx.spec_for(meta[k].axes, tuple(p.shape))) for k, p in params.items()}


class Weights(dict):
    """Parameters stored as this rank's shards (parameter-shard storage,
    JAX's ``launch/train.py`` layout): a dict of shard tensors, or of nested
    :class:`Weights`, with ``specs`` (the PartitionSpec each tensor is a
    shard under, by key) and the ``mesh``. The model code reads a leaf
    through :func:`weight`, which gathers what the stored shard lacks; a
    plain dict of whole tensors reads through the same calls unchanged."""

    def __init__(self, tensors: Mapping[str, Any], specs: Mapping[str, Any], mesh):
        super().__init__(tensors)
        self.specs = dict(specs)
        self.mesh = mesh

    @staticmethod
    def nest(tensors: Mapping[str, Any], specs: Mapping[str, Any], mesh) -> "Weights":
        """A nested dict of tensors and its like-shaped dict of specs as
        nested :class:`Weights`."""
        return Weights({k: Weights.nest(v, specs[k], mesh) if isinstance(v, dict) else v
                        for k, v in tensors.items()},
                       {k: v for k, v in specs.items() if not isinstance(v, dict)}, mesh)


Cut = Union[Tuple[int, int], Sequence[Tuple[int, int]]]


def whole_shape(p: Mapping[str, Any], name: str) -> Tuple[int, ...]:
    """The whole (global) shape of ``p[name]``, stored whole or as a shard."""
    w = p[name]
    if isinstance(p, Weights):
        from .shardspec import global_shape

        return global_shape(tuple(w.shape), p.specs[name], p.mesh)
    return tuple(w.shape)


def weight(p: Mapping[str, Any], name: str, cuts: Optional[Mapping[int, Cut]] = None) -> torch.Tensor:
    """The weight a region computes with: ``p[name]`` cut by ``cuts``, which
    maps a dim of the whole weight to ``(start, length)``, or to several
    such ranges taken in order and concatenated (the SSM's ``[x_k | z_k]``
    columns of ``in_proj``). Dims not named stay whole.

    From a plain dict (the weight whole): its narrows. From
    :class:`Weights` (this rank's stored shard): a split dim whose cut is
    exactly the stored block stays as stored; every other split dim is
    all-gathered over its mesh axes (``launch.mesh.all_gather``, whose
    backward reduce-scatters the gradient onto the shard), then cut. So a
    rank's gradient of its shard sums every rank's contribution over the
    axes the region gathered; the step completes it over the axes the spec
    does not use (``train.step``)."""
    w = p[name]
    cuts = dict(cuts or {})
    if isinstance(p, Weights):
        from ..launch.mesh import all_gather

        mesh = p.mesh
        for d, axes in enumerate(spec_entries(p.specs[name], w.ndim)):
            if not axes:
                continue
            blk = w.shape[d]
            if cuts.get(d) == (mesh.group_index(axes) * blk, blk):
                del cuts[d]
                continue
            w = all_gather(w, mesh, axes, d)
    for d, cut in sorted(cuts.items()):
        if isinstance(cut[0], int):
            w = w.narrow(d, *cut)
        else:
            w = torch.cat([w.narrow(d, *c) for c in cut], dim=d)
    return w


def dot(eq: str, x: torch.Tensor, p: Mapping[str, Any], name: str, cuts: Optional[Mapping[int, Cut]] = None, *,
        rows: int = 0, dtype=None) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` with ``w`` :func:`weight`'s ``p[name]`` cut
    by ``cuts`` (one ``(start, length)`` a dim) and cast to ``dtype`` (x's by
    default).

    In the decode layout on stored shards (:class:`Weights`) the weight is
    never gathered: its stored shard stays where it is and the activations
    move. A dim the cuts keep as stored is the region's own slice; any other
    dim split over mesh axes is handled by where its letter goes. Over axes
    whose ranks hold other rows of ``x`` (the batch axes; dim ``rows`` of
    x), x's rows are first all-gathered over them. A contracted dim (the
    ``embed`` dim over ``data``): x's block of it times the shard, the
    partial sums kept in f32 and completed by a reduce-scatter of the rows
    over those axes (by a ``psum`` over axes whose ranks hold the same
    rows), then rounded to ``dtype`` once. An output dim:
    the shard's block of the output, all-gathered along it (and this rank's
    rows kept). Bytes moved are the activations', never the weight's."""
    dtype = x.dtype if dtype is None else dtype
    lay = active_layout()
    if not (lay.decode and isinstance(p, Weights)):
        return torch.einsum(eq, x, weight(p, name, cuts).to(dtype))
    from ..launch.mesh import all_gather, psum, psum_scatter

    mesh = p.mesh
    ins, out = eq.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    w = p[name]
    cuts = dict(cuts or {})
    moves = []   # (letter, axes, start, length) of each split dim the cuts do not keep as stored
    for d, axes in enumerate(spec_entries(p.specs[name], w.ndim)):
        if not axes:
            continue
        blk = w.shape[d]
        start = mesh.group_index(axes) * blk
        if cuts.get(d) == (start, blk):
            del cuts[d]
        elif d in cuts:
            w = all_gather(w, mesh, axes, d)
        else:
            moves.append((ws[d], axes, start, blk))
    for d, (start, length) in cuts.items():
        w = w.narrow(d, start, length)
    row_axes = set(batch_axes(mesh, lay.ctx.rules))
    by_rows = [m[1] for m in moves if set(m[1]) <= row_axes]
    if len(by_rows) > 1:
        raise ValueError(f"dot {name}: more than one dim split over the rows' axes ({by_rows})")
    xg = all_gather(x, mesh, by_rows[0], rows) if by_rows else x
    for letter, _, start, blk in moves:
        if letter not in out:
            xg = xg.narrow(xs.index(letter), start, blk)
    # partial sums over a contracted split dim stay f32 until they are
    # complete, so the product rounds to ``dtype`` once, as unsharded
    part = torch.float32 if any(m[0] not in out for m in moves) else dtype
    y = torch.einsum(eq, xg.to(dtype).to(part), w.to(dtype).to(part))
    o_rows = out.index(xs[rows])
    for letter, axes, _, _ in moves:
        if letter not in out:
            y = psum_scatter(y, mesh, axes, o_rows) if by_rows and axes == by_rows[0] else psum(y, mesh, axes)
    y = y.to(dtype)
    for letter, axes, _, _ in moves:
        if letter in out:
            y = all_gather(y, mesh, axes, out.index(letter))
            if by_rows and axes == by_rows[0]:
                n = x.shape[rows]
                y = y.narrow(o_rows, mesh.group_index(axes) * n, n)
    return y


def lookup(p: Mapping[str, Any], name: str, ids: torch.Tensor, block: Optional[Tuple[int, int]] = None,
           dtype=None) -> torch.Tensor:
    """Rows ``ids`` (B, ...) of the table ``p[name]``, in ``dtype`` (the
    table's by default). ``block``: (start, length) of the rows to read
    (the vocabulary a model rank holds): ids outside it look up zeros, and a
    ``psum`` over ``model`` completes every row exactly (one non-zero term).
    In the decode layout on stored shards (:class:`Weights`) the table is
    never gathered: rows outside ``block``'s stored shard are, and a column
    dim split over the batch axes (``embed`` over ``data``) stays split:
    the ids are all-gathered over those axes, each rank looks up its block
    of every row, the blocks are all-gathered back and this rank's rows
    kept. Elsewhere the table is read through :func:`weight`."""
    from ..launch.mesh import all_gather, psum

    lay = active_layout()
    cut = {0: block} if block else None
    cols: Tuple[str, ...] = ()
    if lay.decode and isinstance(p, Weights):
        tbl = p[name]
        cols = spec_entries(p.specs[name], tbl.ndim)[1]
        tbl = weight(Weights({name: tbl}, {name: P(spec_entries(p.specs[name], tbl.ndim)[0] or None, None)},
                             p.mesh), name, cut)
    else:
        tbl = weight(p, name, cut)
    by_rows = bool(cols) and set(cols) <= set(batch_axes(lay.mesh, lay.ctx.rules))
    g = all_gather(ids, lay.mesh, cols, 0) if by_rows else ids
    dtype = tbl.dtype if dtype is None else dtype
    if block is None:
        out = tbl[g].to(dtype)
    else:
        local = g - block[0]
        hit = (local >= 0) & (local < block[1])
        out = psum(torch.where(hit[..., None], tbl[local.clamp(0, block[1] - 1)].to(dtype), 0), lay.mesh, "model")
    if cols:
        out = all_gather(out, lay.mesh, cols, out.ndim - 1)
        if by_rows:
            n = ids.shape[0]
            out = out.narrow(0, lay.mesh.group_index(cols) * n, n)
    return out


def gathered(p: Mapping[str, Any]) -> Dict[str, Any]:
    """Every leaf of ``p`` (nested dicts included) whole, through
    :func:`weight`: a region's whole-region fallback on stored shards."""
    return {k: gathered(v) if isinstance(v, dict) else weight(p, k) for k, v in p.items()}


def param_specs(meta: Mapping[str, Any], params: Mapping[str, Any]) -> Dict[str, P]:
    """``{name: PartitionSpec}`` for a parameter dict from its ``{name:
    ParamMeta}`` dict, under the active context (``P()`` without one)."""
    ctx = current()
    return {k: (ctx.spec_for(meta[k].axes, tuple(p.shape)) if ctx is not None else P())
            for k, p in params.items()}
