"""Mamba-1 selective scan, forward (port of ``repro/kernels/ssm_scan.py``
``ssm_scan``) and backward (``ssm_scan_bwd``, which replaces no TPU kernel:
the JAX package's backward is the plain-jnp custom VJP
``repro/models/ssm.py:170 _selective_scan_bwd``).

Kernel: ``csrc/ssm_scan.cu`` replaces the Pallas kernel at
``repro/kernels/ssm_scan.py:58`` (body ``_ssm_kernel`` :27, ``pallas_call``
:77). At the model's shapes it is bound by its exponentials (one per
timestep, channel and state) more than by its bytes. Where the TPU kernel
carried the state across a sequential grid axis, :func:`plan_scan` (pure
integer arithmetic on the shapes and the SM count, tested on the CPU) picks
one of two forms and its grid: a lean one-token form for S = 1 (every
decode step), and for longer sequences a chunked form that walks chunks of
the sequence in parallel, composes their carries in order and replays each
chunk from its true carry-in; the source note says why.

In the model (``repro_torch.models.ssm.selective_scan``) it takes the place
of the JAX package's chunked associative scan: both compose chunks, but the
kernel's chunks and exponentials differ, so the two agree to f32 rounding,
not bit for bit.

Backward kernel: ``csrc/ssm_scan_bwd.cu``. The JAX package gets its
backward's speed from ``lax.associative_scan``, which PyTorch lacks; the
kernel walks each (row, channel) in reverse over 16-step tiles, replaying
each tile once from the state the forward kept at its start
(``ssm_scan(..., keep_bounds=True)`` returns those states) in B15's
operation order, with one exponential an element, and sums the gradients
that reduce over channels, rows and steps in a fixed order.
:func:`plan_scan_bwd` plans it (pure integer arithmetic, tested on the
CPU); :func:`ssm_scan_bwd_plain` is its plain twin, the reverse recurrence
one step at a time.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from . import build

_IN_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([build.PTR, build.INT] + [build.PTR] * 11 + [build.SIZE] * 3 + [build.INT] * 2 + [build.SIZE]
             + [build.INT] * 2 + [build.PTR])
_BWD_ARGTYPES = [build.PTR, build.INT] + [build.PTR] * 19 + [build.SIZE] * 3 + [build.INT] * 4 + [build.PTR]

# The planner's geometry; the kernel's constants in csrc/ssm_scan.cu match.
FORM_TOKEN, FORM_SEQ = 0, 1
SEQ_THREADS = 128          # sequence form: channels per block, one a thread
SEQ_BLOCKS_PER_SM = 4      # what the walk's __launch_bounds__ guarantees
TILE = 16                  # steps a tile: chunks are multiples of it
TOKEN_THREADS, LANES = 256, 4   # one-token form: threads per block, lanes per channel
CARRY_THREADS = 256
MIN_CHUNKS = 3             # fewer chunks than this gain nothing (see plan_scan)
MAX_CHUNKS = 64            # the carry launch walks the chunks in series
# The backward's geometry (csrc/ssm_scan_bwd.cu).
BWD_CHANNELS = 32          # a block of the walk: 32 channels, N / 4 lanes (4 states each) a channel
BWD_TILE = 16              # steps a tile: the forward keeps each tile's start state, the walk replays it once
BWD_STAGES = 2             # x, dt, dy tiles in shared memory (the cp.async double buffer)
BWD_WARPS_PER_SM = 16      # what the walk's __launch_bounds__ makes room for (128 registers a lane)
BWD_COMBINE_THREADS = 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """The grid of one B15 call. FORM_TOKEN: a (``tiles``, batch) grid of
    TOKEN_THREADS threads, LANES per (row, channel). FORM_SEQ: the sequence
    cut into ``chunks`` chunks of ``chunk`` steps (the last one shorter),
    ``tiles`` tiles of SEQ_THREADS channels; with more than one chunk, the
    carry walk runs chunks 0..chunks-2 and the carry launch composes their
    end states before the output walk runs every chunk."""
    form: int
    batch: int
    seq: int
    dim: int
    n: int
    states: int     # N padded to 4, 8 or 16
    chunk: int      # steps per chunk (FORM_SEQ); 1 for FORM_TOKEN
    chunks: int     # 1 for FORM_TOKEN
    tiles: int

    @property
    def walk_grid(self) -> Optional[Tuple[int, int, int]]:
        """Launch 1's (x, y, z) grid, or None when it does not run."""
        return (self.tiles, self.chunks - 1, self.batch) if self.form == FORM_SEQ and self.chunks > 1 else None

    @property
    def carry_blocks(self) -> int:
        """Launch 2's blocks (0: no launch; slot 0 is already true)."""
        return _cdiv(self.batch * self.dim * self.n, CARRY_THREADS) if self.chunks > 2 else 0

    @property
    def out_grid(self) -> Tuple[int, int, int]:
        """The grid of the launch that writes y: the output walk's, or the
        one-token form's (x, y, 1)."""
        if self.form == FORM_TOKEN:
            return (self.tiles, self.batch, 1)
        return (self.tiles, self.chunks, self.batch)

    def steps(self, k: int) -> Tuple[int, int]:
        """[start, stop) of chunk ``k``."""
        return k * self.chunk, min(self.seq, (k + 1) * self.chunk)


@functools.lru_cache(maxsize=None)
def plan_scan(b: int, s: int, d: int, n: int, *, sms: int) -> ScanPlan:
    """The form and grid of a (B=b, S=s, D=d, N=n) scan on a card with
    ``sms`` SMs. S = 1 takes the one-token form. Longer sequences take the
    sequence form with the most chunks K (at most MAX_CHUNKS, each a
    multiple of TILE steps) whose output walk, B x tiles x K blocks, still
    fits SEQ_BLOCKS_PER_SM blocks on every SM. A block's walk is a chain of
    dependent steps, so an SM with fewer blocks runs no faster; the carry
    walk and the output walk each take about a chunk's time, so K below
    MIN_CHUNKS gains nothing over one chunk, and K = 1 is taken then. Pure
    integer arithmetic: it reads no tensor and makes no CUDA call (and is
    cached, as the wrapper asks for every launch)."""
    if not (1 <= n <= 16 and 1 <= b <= 65535 and s >= 1 and d >= 1):
        raise ValueError(f"plan_scan: the kernel takes N in 1..16 and 1..65535 rows, got B={b}, S={s}, D={d}, "
                         f"N={n}")
    states = 4 if n <= 4 else 8 if n <= 8 else 16
    if s == 1:
        return ScanPlan(FORM_TOKEN, b, s, d, n, states, 1, 1, _cdiv(d, TOKEN_THREADS // LANES))
    tiles = _cdiv(d, SEQ_THREADS)
    k = min(SEQ_BLOCKS_PER_SM * sms // (b * tiles), MAX_CHUNKS, _cdiv(s, TILE))
    chunk = _cdiv(_cdiv(s, k), TILE) * TILE if k >= MIN_CHUNKS else _cdiv(s, TILE) * TILE
    return ScanPlan(FORM_SEQ, b, s, d, n, states, chunk, _cdiv(s, chunk), tiles)


def _check(x, dt, a, b_t, c_t, d_skip, h0) -> torch.device:
    if x.ndim != 3 or a.ndim != 2:
        raise ValueError(f"ssm_scan: want x (B, S, D) and a (D, N); got {tuple(x.shape)}, {tuple(a.shape)}")
    bsz, s, d = x.shape
    n = a.shape[1]
    want = {"dt": (bsz, s, d), "a": (d, n), "b_t": (bsz, s, n), "c_t": (bsz, s, n), "d_skip": (d,),
            "h0": (bsz, d, n)}
    got = {"dt": dt, "a": a, "b_t": b_t, "c_t": c_t, "d_skip": d_skip, "h0": h0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"ssm_scan: {name} is {tuple(got[name].shape)}, want {shape}")
    if not (x.dtype == b_t.dtype == c_t.dtype):
        raise TypeError(f"ssm_scan: x, b_t and c_t must share a dtype, got {x.dtype}, {b_t.dtype}, {c_t.dtype}")
    return build.check_operands("ssm_scan", dtypes={"x": _IN_DTYPES, "b_t": _IN_DTYPES, "c_t": _IN_DTYPES},
                                x=x, dt=dt, a=a, b_t=b_t, c_t=c_t, d_skip=d_skip, h0=h0)


def ssm_scan_plain(x, dt, a, b_t, c_t, d_skip, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ssm_scan`: the sequential recurrence
    of ``_ssm_kernel`` (``repro/kernels/ssm_scan.py:36-46``), one timestep
    at a time, in f32 and in the kernel's operation order."""
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf = b_t.float(), c_t.float()
    dsk = d_skip.float()
    h = h0.float().clone()
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dtf[:, t, :, None] * af)                       # (B, D, N)
        h = decay * h + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(-1) + dsk * xf[:, t])
    return torch.stack(ys, dim=1), h


def keep_form(plan: ScanPlan) -> ScanPlan:
    """The plan of a forward that keeps its tile states: ``plan`` itself,
    but a one-token step (S = 1) in the sequence form, one chunk of one
    tile, whose output walk can store the state."""
    if plan.form != FORM_TOKEN:
        return plan
    return dataclasses.replace(plan, form=FORM_SEQ, chunk=TILE, tiles=_cdiv(plan.dim, SEQ_THREADS))


def kept_states_shape(b: int, s: int, d: int, n: int) -> Tuple[int, int, int, int]:
    """The shape of the tile states the forward keeps for the backward:
    (B, ceil(S / BWD_TILE), D, NP), f32, NP = N padded to 4, 8 or 16."""
    return (b, _cdiv(s, BWD_TILE), d, 4 if n <= 4 else 8 if n <= 8 else 16)


def ssm_scan(x, dt, a, b_t, c_t, d_skip, h0, *, keep_bounds: bool = False):
    """x: (B, S, D); dt: (B, S, D) f32; a: (D, N) f32; b_t, c_t: (B, S, N);
    d_skip: (D,) f32; h0: (B, D, N) f32. x, b_t and c_t are f32 or bf16, one
    dtype for the three. Returns (y (B, S, D) f32, h_final (B, D, N) f32),
    as ``repro/kernels/ssm_scan.py:58-67`` does. CUDA tensors launch the
    kernel (1 <= N <= 16) in the form :func:`plan_scan` picks, one count
    per call however many CUDA launches it makes; CPU tensors take the
    plain version.

    ``keep_bounds=True`` (training: a gradient is wanted) returns (y,
    h_final, states) for the backward, as the JAX forward keeps
    ``h_bounds``: ``states`` (:func:`kept_states_shape`, f32) holds the
    state at the start of every BWD_TILE-step tile, stored by the output
    walk as it passes (padded states 0); S = 1 then takes the sequence form
    (one chunk of one tile), which can keep it. On the CPU ``states`` is
    None: the plain backward needs none. ``ssm_scan.form_launches`` counts
    the calls of each form: ``token``, ``seq`` and ``seq_keep``;
    ``ssm_scan.channel_launches`` the calls by channel count D."""
    device = _check(x, dt, a, b_t, c_t, d_skip, h0)
    s = x.shape[1]
    if device.type == "cpu":
        y, h_out = ssm_scan_plain(x, dt, a, b_t, c_t, d_skip, h0)
        return (y, h_out, None) if keep_bounds else (y, h_out)
    bsz, _, d = x.shape
    n = a.shape[1]
    if device.type == "meta":
        outs = (build.meta_empty((bsz, s, d)), build.meta_empty((bsz, d, n)))
        if keep_bounds:
            outs = outs + (build.meta_empty(kept_states_shape(bsz, s, d, n)),)
        return build.on_meta(ssm_scan, outs)
    if not (1 <= n <= 16 and 1 <= bsz <= 65535):
        raise ValueError(f"ssm_scan: the kernel takes N in 1..16 and 1..65535 rows, got N={n}, B={bsz}")
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=device)
    h_out = torch.empty((bsz, d, n), dtype=torch.float32, device=device)
    if y.numel() == 0:
        return (y, h0.clone(), None) if keep_bounds else (y, h0.clone())
    plan = plan_scan(bsz, s, d, n, sms=build.sm_count(device))
    keep = None
    if keep_bounds:
        plan = keep_form(plan)
        keep = torch.empty(kept_states_shape(bsz, s, d, n), dtype=torch.float32, device=device)
    carry = dt_sum = None
    if plan.chunks > 1:
        carry = torch.empty((bsz, plan.chunks - 1, d, n), dtype=torch.float32, device=device)
        dt_sum = torch.empty((bsz, plan.chunks - 1, d), dtype=torch.float32, device=device)
    vec = all(t.data_ptr() % 16 == 0 for t in (x, dt, a, h0, h_out))
    build.launch("ssm_scan", _entry(), device, x.data_ptr(), int(x.dtype == torch.bfloat16), dt.data_ptr(),
                 a.data_ptr(), b_t.data_ptr(), c_t.data_ptr(), d_skip.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 h_out.data_ptr(), build.ptr(carry), build.ptr(dt_sum), build.ptr(keep), bsz, s, d, n, plan.form,
                 plan.chunk, plan.chunks, int(vec))
    ssm_scan.launches += 1
    ssm_scan.form_launches["seq_keep" if keep is not None else "token" if plan.form == FORM_TOKEN else "seq"] += 1
    ssm_scan.channel_launches[d] = ssm_scan.channel_launches.get(d, 0) + 1
    return (y, h_out, keep) if keep_bounds else (y, h_out)


@dataclasses.dataclass(frozen=True)
class ScanBwdPlan:
    """The grid of one backward call. The walk: a (``blocks``, batch) grid
    of ``warps`` warps each, BWD_CHANNELS channels a block, ``lanes`` lanes
    per (row, channel) with 4 states each, over ``tiles`` tiles of BWD_TILE
    steps in reverse; the combine: ``combine_blocks`` blocks of
    BWD_COMBINE_THREADS, a thread per output of db, dc, da and dd."""
    batch: int
    seq: int
    dim: int
    n: int
    states: int        # N padded to 4, 8 or 16
    tiles: int         # ceil(S / BWD_TILE): the kept states' depth
    blocks: int        # channel blocks: the db/dc partials' depth

    @property
    def lanes(self) -> int:
        return self.states // 4

    @property
    def warps(self) -> int:
        """Warps a block: BWD_CHANNELS channels of ``lanes`` lanes."""
        return BWD_CHANNELS * self.lanes // 32

    @property
    def channels(self) -> int:
        """Channels a warp."""
        return 32 // self.lanes

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def blocks_per_sm(self) -> int:
        """What the walk's launch bound makes room for."""
        return BWD_WARPS_PER_SM // self.warps

    @property
    def walk_grid(self) -> Tuple[int, int]:
        return (self.blocks, self.batch)

    @property
    def combine_blocks(self) -> int:
        return _cdiv(self.batch * self.seq * 2 * self.n + self.dim * self.n + self.dim, BWD_COMBINE_THREADS)

    def steps(self, i: int) -> Tuple[int, int]:
        """[start, stop) of tile ``i``."""
        return i * BWD_TILE, min(self.seq, (i + 1) * BWD_TILE)

    def shared_bytes(self, itemsize: int) -> int:
        """The walk's shared memory a block (``itemsize``: x's bytes an
        element): each warp's replayed states (16 float4 a lane) and the
        A_t of a tile's first 8 / itemsize steps (a float4 a lane each), the
        x, dt and dy double buffer, B and C's double buffer and the dx, ddt
        tile, as ``Shared`` in the source lays them out."""
        rows = BWD_TILE * BWD_CHANNELS
        return (self.warps * (BWD_TILE + 8 // itemsize) * 32 * 16 + BWD_STAGES * rows * (2 * itemsize + 4)
                + 2 * 2 * BWD_TILE * self.states * 4 + rows * (4 + itemsize))

    def workspace_shapes(self):
        """{name: shape} of the f32 workspaces the wrapper allocates."""
        b, d = self.batch, self.dim
        return {"ws_bc": (b, self.seq, self.blocks, 2 * self.states), "ws_a": (b, d, self.n), "ws_d": (b, d)}


@functools.lru_cache(maxsize=None)
def plan_scan_bwd(b: int, s: int, d: int, n: int) -> ScanBwdPlan:
    """The grid of the backward of a (B=b, S=s, D=d, N=n) scan. The walk
    takes BWD_TILE-step tiles from the states the forward kept at their
    starts (:func:`kept_states_shape`), whatever chunks the forward walked.
    Pure integer arithmetic: it reads no tensor and makes no CUDA call."""
    if not (1 <= n <= 16 and 1 <= b <= 65535 and s >= 1 and d >= 1):
        raise ValueError(f"plan_scan_bwd: the kernel takes N in 1..16 and 1..65535 rows, got B={b}, S={s}, D={d}, "
                         f"N={n}")
    states = 4 if n <= 4 else 8 if n <= 8 else 16
    return ScanBwdPlan(b, s, d, n, states, _cdiv(s, BWD_TILE), _cdiv(d, BWD_CHANNELS))


def ssm_scan_bwd_plain(x, dt, a, b_t, c_t, d_skip, h0, dy, dh_final=None):
    """Plain PyTorch version of :func:`ssm_scan_bwd`: the forward recurrence
    of :func:`ssm_scan_plain` keeping every state, then the reverse
    recurrence of ``_selective_scan_bwd`` (``repro/models/ssm.py:196-239``)
    one timestep at a time, in f32: dh_t = dy_t C_t + exp(dt_t a) dh_{t+1}.
    Needs no chunk boundaries. Returns (dx, ddt, da, db, dc, dd_skip, dh0),
    all f32."""
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf, dyf = b_t.float(), c_t.float(), dy.float()
    h = h0.float()
    hs = [h]
    for t in range(x.shape[1]):
        h = torch.exp(dtf[:, t, :, None] * af) * h + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        hs.append(h)
    carry = torch.zeros_like(h) if dh_final is None else dh_final.float().clone()
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(af)
    for t in reversed(range(x.shape[1])):
        decay = torch.exp(dtf[:, t, :, None] * af)                       # A_t (B, D, N)
        dh = dyf[:, t, :, None] * cf[:, t, None, :] + carry              # dh_t
        dlog = dh * hs[t] * decay                                        # dlogA_t
        ddtx = (dh * bf[:, t, None, :]).sum(-1)
        db[:, t] = (dh * (dtf[:, t] * xf[:, t])[:, :, None]).sum(1)
        dc[:, t] = (hs[t + 1] * dyf[:, t, :, None]).sum(1)
        ddt[:, t] = ddtx * xf[:, t] + (dlog * af).sum(-1)
        dx[:, t] = ddtx * dtf[:, t] + dyf[:, t] * d_skip.float()
        da = da + (dlog * dtf[:, t, :, None]).sum(0)
        carry = decay * dh
    return dx, ddt, da, db, dc, (dyf * xf).sum((0, 1)), carry


def ssm_scan_bwd(x, dt, a, b_t, c_t, d_skip, h0, dy, dh_final=None, *, states=None, with_final: bool = False):
    """The selective scan's gradients. The forward's operands as
    :func:`ssm_scan` takes them; dy: (B, S, D) in x's dtype; dh_final: (B,
    D, N) f32 or None (zero); ``states``: the tile states
    ``ssm_scan(..., keep_bounds=True)`` returned (the kernel needs them).
    Returns (dx, ddt (B, S, D), da (D, N), db, dc (B, S, N), dd_skip (D,),
    dh0 (B, D, N)) as ``_selective_scan_bwd`` (``repro/models/ssm.py:170``):
    dx in x's dtype (the kernel rounds it once as it stores it, as that
    function's cast does), the rest f32, as that function has them before
    its other casts; ``with_final=True`` appends the final state the kernel
    replayed (B, D, N), which equals the forward's h_final bit for bit. CUDA
    tensors launch the kernel (two CUDA launches, one count); CPU tensors
    take the plain version, which needs no states (and replays nothing:
    ``with_final`` is for the card)."""
    device = _check(x, dt, a, b_t, c_t, d_skip, h0)
    extra = {"dy": dy} if dh_final is None else {"dy": dy, "dh_final": dh_final}
    if states is not None:
        extra["states"] = states
    build.check_operands("ssm_scan_bwd", dtypes={"x": _IN_DTYPES, "dy": (x.dtype,)}, x=x, **extra)
    bsz, s, d = x.shape
    n = a.shape[1]
    if tuple(dy.shape) != (bsz, s, d) or (dh_final is not None and tuple(dh_final.shape) != (bsz, d, n)):
        raise ValueError(f"ssm_scan_bwd: dy {tuple(dy.shape)} / dh_final "
                         f"{None if dh_final is None else tuple(dh_final.shape)} do not match x {tuple(x.shape)}")
    if device.type == "cpu":
        if with_final:
            raise ValueError("ssm_scan_bwd: with_final is the card kernel's replayed state")
        dx, *rest = ssm_scan_bwd_plain(x, dt, a, b_t, c_t, d_skip, h0, dy, dh_final)
        return (dx.to(x.dtype), *rest)
    if device.type == "meta":
        outs = (build.meta_empty((bsz, s, d), x.dtype), build.meta_empty((bsz, s, d)), build.meta_empty((d, n)),
                build.meta_empty((bsz, s, n)), build.meta_empty((bsz, s, n)), build.meta_empty((d,)),
                build.meta_empty((bsz, d, n)))
        return build.on_meta(ssm_scan_bwd, outs + ((build.meta_empty((bsz, d, n)),) if with_final else ()))
    plan = plan_scan_bwd(bsz, s, d, n)
    want = kept_states_shape(bsz, s, d, n)
    if states is None or tuple(states.shape) != want:
        raise ValueError(f"ssm_scan_bwd: the kernel replays from the forward's tile states {want} "
                         f"(ssm_scan(..., keep_bounds=True)), got {None if states is None else tuple(states.shape)}")
    f32 = dict(dtype=torch.float32, device=device)
    dx, ddt = torch.empty((bsz, s, d), dtype=x.dtype, device=device), torch.empty((bsz, s, d), **f32)
    db, dc = torch.empty((bsz, s, n), **f32), torch.empty((bsz, s, n), **f32)
    da, dd = torch.empty((d, n), **f32), torch.empty((d,), **f32)
    dh0 = torch.empty((bsz, d, n), **f32)
    h_last = torch.empty((bsz, d, n), **f32) if with_final else None
    ws = {k: torch.empty(shape, **f32) for k, shape in plan.workspace_shapes().items()}
    vec = all(t.data_ptr() % 16 == 0 for t in (x, dt, dy, dx, ddt))
    build.launch("ssm_scan_bwd", _entry_bwd(), device, x.data_ptr(), int(x.dtype == torch.bfloat16), dt.data_ptr(),
                 a.data_ptr(), b_t.data_ptr(), c_t.data_ptr(), d_skip.data_ptr(), states.data_ptr(), dy.data_ptr(),
                 build.ptr(dh_final), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
                 dd.data_ptr(), dh0.data_ptr(), build.ptr(h_last), ws["ws_bc"].data_ptr(), ws["ws_a"].data_ptr(),
                 ws["ws_d"].data_ptr(), bsz, s, d, n, plan.tiles, plan.blocks, int(vec))
    ssm_scan_bwd.launches += 1
    ssm_scan_bwd.channel_launches[d] = ssm_scan_bwd.channel_launches.get(d, 0) + 1
    out = (dx, ddt, da, db, dc, dd, dh0)
    return out + (h_last,) if with_final else out


@functools.lru_cache(maxsize=None)
def _entry():
    return build.entry("repro_ssm_scan", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _entry_bwd():
    return build.entry("repro_ssm_scan_bwd", _BWD_ARGTYPES)


ssm_scan.launches = 0
ssm_scan.form_launches = {"token": 0, "seq": 0, "seq_keep": 0}
# launches by channel count D (a tensor-parallel rank scans d_inner / tp)
ssm_scan.channel_launches = {}
ssm_scan_bwd.launches = 0
ssm_scan_bwd.channel_launches = {}
