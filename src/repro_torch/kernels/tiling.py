"""What the port's CUDA kernels may hold on chip on an H100, and the fit
gates that follow from it (the counterpart of ``repro/kernels/tiling.py``,
re-derived for Hopper).

The JAX package's strip kernels hold each reduction line whole in a TPU
core's VMEM, so its gate (``VMEM_BUDGET = 8 << 20`` charged at a 4-byte
compute itemsize, ``repro/kernels/tiling.py:33,43``) sends a leaf whose line
outruns that budget to plain jnp. On Hopper the scarce resources are another
pair: a block's shared memory (:data:`SMEM_BUDGET`, 227 KiB; above 48 KiB
only as dynamic memory a kernel opts in to) and the SM's register file
(:data:`REGISTERS_PER_SM`, at most :data:`MAX_REGISTERS_PER_THREAD` a
thread). What each design keeps on chip decides its gate:

* The split walks of B1, B4, B7, B10 and B12 (``csrc/mega_slim.cu``) and of
  B5, B8 and B9 (``csrc/snr_stats.cu``) never hold a reduction line in
  shared memory. A block streams one piece of a line (at most
  ``megaplan.SLIM_SEG_MAX`` or ``snr_stats.SEG_MAX`` elements, or the
  ROWS form's whole line walked by the block's threads) and keeps its f64
  partial sums in fixed arrays (``csrc/mega_slim.cu:316-344, 663, 803``);
  a longer line is cut into more pieces, whose shares a second launch
  combines in a fixed order. Their shared memory is a constant of the
  kernel whatever the line's length, so :func:`strip_fits` admits every
  line, and no strip narrows for the line's sake (JAX's
  ``fit_strip_block`` has no counterpart). Those constants are held to the budget where they are known: in
  the ptxas report (``repro_torch.analysis.kernelcheck``).
* B14 stages its keys through a ring of tiles, with the queries and the
  softmax rows beside it: :func:`paged_smem_bytes`, set as dynamic shared
  memory at ``csrc/paged_attention.cu:728``.
* B15's chunk walk double-buffers tiles of x, dt, B and C in static shared
  memory (``csrc/ssm_scan.cu:176-179``): :func:`scan_smem_bytes`.
* The scan's backward keeps each warp's replayed states and the tiles it
  streams in dynamic shared memory (``csrc/ssm_scan_bwd.cu:238, 509``):
  :func:`scan_bwd_smem_bytes`.

The JAX module's ``strip_grid``, ``pad_kept`` and ``trim_kept`` have no
counterpart: no port wrapper pads, since every plan masks its own ragged
edge.
"""
from __future__ import annotations

# A block's shared memory on sm_90: 227 KiB, the opt-in maximum.
SMEM_BUDGET = 232_448
# Static shared memory (and dynamic memory without the opt-in) stops here.
SMEM_STATIC_MAX = 48 * 1024
# An SM's shared memory, and what the runtime keeps of it for each block.
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1024
# The register file: 32-bit registers an SM, and the most one thread gets.
REGISTERS_PER_SM = 65_536
MAX_REGISTERS_PER_THREAD = 255
# Registers are handed out a warp at a time, in units of 256.
REGISTER_UNIT = 256
MAX_THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
# Every kernel computes in f32, whatever the stored dtype (kernelcheck's
# ``dtype`` check holds the sources to that).
COMPUTE_ITEMSIZE = 4


def strip_fits(red_size: int) -> bool:
    """Whether the split-walk kernels can serve a reduction line of
    ``red_size`` elements: always. They hold no line on chip (see the
    module docstring): a block streams a piece of bounded length, a longer
    line becomes more pieces, and the shared memory a block uses is fixed
    by the kernel. JAX's ``n_bufs`` and ``itemsize``, which set its VMEM
    charge, and its ``fit_strip_block``, which narrows a strip to that
    charge, have nothing to set here."""
    if red_size < 0:
        raise ValueError(f"strip_fits: want red_size >= 0, got {red_size}")
    return True


def smem_fits(nbytes: int) -> bool:
    """Whether a block's shared memory (static plus dynamic) fits
    :data:`SMEM_BUDGET`."""
    return nbytes <= SMEM_BUDGET


# -- the kernels that stage data in shared memory -------------------------------
# Their layouts, as the sources declare them; kernelcheck holds these counts
# to the ptxas report where the memory is static.

PAGED_KEYS = 32          # keys a ring stage (kKeys in csrc/paged_attention.cu)
PAGED_STAGES = 4         # ring depth (kStages)
PAGED_THREADS = 128      # kThreads; the CUDA-core form with 64 query rows runs twice as many


def paged_threads(form: int, rows: int) -> int:
    """Threads of a B14 block: 256 for the CUDA-core form with 64 query-row
    slots, else 128 (``cores_threads`` in the source)."""
    return 2 * PAGED_THREADS if form == 0 and rows >= 64 else PAGED_THREADS


def paged_smem_bytes(form: int, rows: int, head_dim: int, pool_itemsize: int) -> int:
    """B14's dynamic shared memory a block: the ring of PAGED_STAGES tiles of
    PAGED_KEYS keys (a key's K and V row in the pool's dtype, padded by 16
    bytes), then for the CUDA-core form (``form`` 0) the f32 query rows
    (padded by 4), the probabilities, three values a row and the page ids
    (``cores_smem``), for the tensor-core form (1, bf16 pool) the page ids
    (``mma_smem``)."""
    ring = PAGED_STAGES * PAGED_KEYS * (2 * head_dim * pool_itemsize + 16)
    if form == 1:
        return ring + 4 * PAGED_THREADS
    return ring + 4 * (rows * (head_dim + 4) + rows * (PAGED_KEYS + 1) + 3 * rows) + 4 * paged_threads(form, rows)


SCAN_TILE = 16           # steps a tile (kTile in csrc/ssm_scan.cu)
SCAN_STAGES = 2          # x and dt tiles in flight (kStages)
SCAN_THREADS = 128       # channels a block of the chunk walk (kSeqThreads)


def scan_smem_bytes(itemsize: int, states: int, out: bool) -> int:
    """B15's chunk walk: static shared memory a block. The x tiles (x's
    dtype) and dt tiles (f32) of SCAN_STAGES stages, and two stages of B's
    values, and of C's for the output walk (``out``), ``states`` (N padded
    to 4, 8 or 16) a step. The carry walk's 4-float stand-in for C is never
    read, and ptxas drops it."""
    stage = SCAN_TILE * states
    return SCAN_STAGES * SCAN_TILE * SCAN_THREADS * (itemsize + 4) + 2 * stage * 4 + (2 * stage * 4 if out else 0)


def scan_bwd_smem_bytes(itemsize: int, states: int) -> int:
    """The scan backward's walk: dynamic shared memory a block, as
    ``ScanBwdPlan.shared_bytes`` counts the source's ``Shared`` layout."""
    from .ssm_scan import plan_scan_bwd

    return plan_scan_bwd(1, 1, 1, states).shared_bytes(itemsize)


def blocks_per_sm(threads: int, registers: int, smem_bytes: int) -> int:
    """Blocks of ``threads`` threads using ``registers`` registers a thread
    and ``smem_bytes`` of shared memory that one SM holds at once: the least
    of the thread, register, shared-memory and block limits. Registers go a
    warp at a time in REGISTER_UNIT units; each block also takes
    SMEM_RESERVED_PER_BLOCK of the SM's shared memory."""
    warps = -(-threads // 32)
    warp_regs = -(-max(registers, 1) * 32 // REGISTER_UNIT) * REGISTER_UNIT
    by_regs = (REGISTERS_PER_SM // warp_regs) // warps
    by_smem = SMEM_PER_SM // (smem_bytes + SMEM_RESERVED_PER_BLOCK)
    return min(MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // threads, by_regs, by_smem)
