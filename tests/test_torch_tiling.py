"""The port's tiling limits (``repro_torch.kernels.tiling``) against the JAX
package's (``repro.kernels.tiling``), case for case of ``tests/test_tiling.py``.

Where JAX's VMEM budget does not bind, both gates answer alike. Where it
binds, the port's answer is Hopper's: the split walks hold no reduction
line on chip, so every line fits (and JAX's ``fit_strip_block``, which
narrows a strip to VMEM, has no counterpart), and the kernels that stage
data in shared memory are held to 227 KiB a block. Exact integer
arithmetic: no tolerance.
"""
import pytest

from repro.kernels.tiling import COMPUTE_ITEMSIZE as JAX_ITEMSIZE, VMEM_BUDGET
from repro.kernels.tiling import strip_fits as jax_fits
from repro_torch.kernels import tiling
from repro_torch.kernels.ssm_scan import plan_scan_bwd

# (red_size, n_bufs, itemsize) of tests/test_tiling.py's strip_fits cases
FITS = [(VMEM_BUDGET // (JAX_ITEMSIZE * 4), 4, 4), (VMEM_BUDGET // (JAX_ITEMSIZE * 4) + 1, 4, 4),
        (VMEM_BUDGET // (2 * 4), 4, 2), (VMEM_BUDGET // (2 * 4), 4, 4), (1024, 6, 4)]


def test_constants_are_hoppers():
    assert tiling.SMEM_BUDGET == 232_448 == 227 * 1024
    assert tiling.SMEM_STATIC_MAX == 48 * 1024
    assert tiling.REGISTERS_PER_SM == 65_536 and tiling.MAX_REGISTERS_PER_THREAD == 255
    assert tiling.COMPUTE_ITEMSIZE == JAX_ITEMSIZE == 4


@pytest.mark.parametrize("red,n_bufs,itemsize", FITS)
def test_strip_fits_against_jax(red, n_bufs, itemsize):
    """Equal where JAX's line fits its VMEM; where it does not, the split
    walk still serves the line (True)."""
    want = jax_fits(red, n_bufs, itemsize=itemsize)
    got = tiling.strip_fits(red)
    assert got is True
    assert got == want or not want


def test_strip_fits_admits_the_longest_lines():
    # gpt_small's 38.6 M-element embedding line (K = both axes), far past
    # any on-chip budget: the split walk cuts it into pieces.
    assert not jax_fits(38_597_376, 5)
    assert tiling.strip_fits(38_597_376)
    with pytest.raises(ValueError):
        tiling.strip_fits(-1)


def test_paged_smem_counts_the_sources_layout():
    """B14's dynamic shared memory (csrc/paged_attention.cu cores_smem /
    mma_smem) at its instantiations: all within a block's 227 KiB; the
    largest, the f32 pool at head_dim 128 and 64 query rows."""
    # the ring alone: 4 stages x 32 keys x (K and V rows + 16 B)
    assert tiling.paged_smem_bytes(1, 64, 128, 2) == 4 * 32 * (2 * 128 * 2 + 16) + 4 * 128 == 68_096
    assert tiling.paged_smem_bytes(0, 64, 128, 4) == 133_120 + 4 * (64 * 132 + 64 * 33 + 3 * 64) + 4 * 256 == 177_152
    for hd in (16, 32, 64, 128):
        for rows in (4, 16, 64):
            for itemsize in (2, 4):
                assert tiling.smem_fits(tiling.paged_smem_bytes(0, rows, hd, itemsize))
        assert tiling.smem_fits(tiling.paged_smem_bytes(1, 64, hd, 2))
    assert tiling.paged_threads(0, 64) == 256 and tiling.paged_threads(0, 16) == tiling.paged_threads(1, 64) == 128


def test_scan_smem_counts_the_sources_layout():
    """B15's static tiles and the backward's dynamic layout, as ptxas and
    ScanBwdPlan.shared_bytes count them (the H100 build: 36,864 B for the
    f32 N = 16 output walk)."""
    assert tiling.scan_smem_bytes(4, 16, True) == 36_864
    assert tiling.scan_smem_bytes(4, 16, False) == 34_816
    assert tiling.scan_smem_bytes(2, 4, False) == 25_088
    for np_ in (4, 8, 16):
        for itemsize in (2, 4):
            assert tiling.scan_bwd_smem_bytes(itemsize, np_) == plan_scan_bwd(1, 1, 1, np_).shared_bytes(itemsize)
    assert (tiling.scan_bwd_smem_bytes(2, 16), tiling.scan_bwd_smem_bytes(4, 16)) == (56_320, 57_344)


def test_blocks_per_sm():
    """The occupancy arithmetic: registers a warp in units of 256, 1 KiB of
    an SM's 228 KiB kept a block."""
    assert tiling.blocks_per_sm(256, 64, 8) == 4           # B11: 64 registers x 256 threads
    assert tiling.blocks_per_sm(128, 128, 36_864) == 4     # B15's walk at its launch bound
    assert tiling.blocks_per_sm(128, 128, 57_344) == 4     # the backward's f32 N=16 walk fills the SM exactly
    assert tiling.blocks_per_sm(128, 128, 57_345) == 3     # ... one byte more and a block drops
    assert tiling.blocks_per_sm(256, 80, 177_152) == 1      # B14's largest CUDA-core block
    assert tiling.blocks_per_sm(1024, 32, 256) == 2
    assert tiling.blocks_per_sm(32, 16, 0) == 32           # the block limit
