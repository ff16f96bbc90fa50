"""The one-step LSTM kernel's launch geometry, ``kernel.cell_tiling``, on the
CPU: the tiling the wrapper hands to ``csrc/lstm_cell.cu``.

The kernel's mapping (its design note): block (bx, by) owns batch rows
bx*rows .. bx*rows + rows - 1 and hidden units by*units .. by*units +
units - 1; its thread t owns gate t % 4 of unit t // 4 of that tile for every
row of the block, and the four gates of a unit meet through a shuffle
within the quad of lanes 4u .. 4u + 3.  Here that mapping is laid over each
tiling and checked to cover every (row, unit, gate) exactly once, with the
four gates of each unit in one block and one quad, within the card's 1024
threads a block, with no empty tile, and at one or two blocks on each of
the H100's 132 SMs.  The kernel's sum order is the plain version's (x.wx
then h.wh, k ascending, then b), so ``ref.lstm_cell_ref`` is its plain
version and ``tests/test_torch_lstm_cell.py`` holds that to the reference;
the CUDA kernel itself runs only on the card (``chip_smoke.py``, phase 3).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels.lstm_cell import kernel

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# every shape phase 3 runs on the card, then B = 1 and H on either side of
# the 4H <= 512 switch (128 and 129) and beyond the sequence kernels' reach
SHAPES = sorted({(B, F, H) for B, F, H, _ in smoke.CELL_CASES}
                | {(1, 5, H) for H in (1, 40, 128, 129, 512, 1024)}
                | {(250, 5, H) for H in (1, 128, 129)})


def _owners(B: int, H: int, t: kernel.CellTiling) -> np.ndarray:
    """(block, quad) of each (row, unit, gate) under the kernel's mapping,
    -1 where none; raises where one is owned twice."""
    gx, gy = t.grid
    bx, r, by, p = np.meshgrid(np.arange(gx), np.arange(t.rows),
                               np.arange(gy), np.arange(t.threads),
                               indexing="ij")
    row, unit, gate = bx * t.rows + r, by * t.units + p // 4, p % 4
    live = (row < B) & (unit < H)
    count = np.zeros((B, H, 4), np.int64)
    np.add.at(count, (row[live], unit[live], gate[live]), 1)
    assert count.max(initial=1) == 1, "a (row, unit, gate) owned twice"
    assert count.min(initial=1) == 1, "a (row, unit, gate) owned by none"
    owner = np.full((B, H, 4, 2), -1, np.int64)
    owner[row[live], unit[live], gate[live]] = np.stack(
        [(bx * gy + by)[live], (p // 4)[live]], axis=-1)
    return owner


@pytest.mark.parametrize("B,F,H", SHAPES)
@pytest.mark.parametrize("rows", [None, *kernel.CELL_ROWS])
def test_cell_tiling_covers_every_row_and_unit_once(B, F, H, rows):
    t = kernel.cell_tiling(B, F, H, rows)
    gx, gy = t.grid
    assert t.threads == 4 * t.units <= 4 * kernel.CELL_MAX_UNITS <= 1024
    # no tile is empty: the last row tile and the last unit tile hold work
    assert (gx - 1) * t.rows < B <= gx * t.rows
    assert (gy - 1) * t.units < H <= gy * t.units
    if 4 * H <= 4 * kernel.CELL_MAX_UNITS:
        assert (t.units, gy) == (H, 1)  # the whole of H in one block
    else:
        assert t.units % 8 == 0  # whole warps
    owner = _owners(B, H, t)
    # the four gates of a unit of a row: one block, one quad of lanes
    assert (owner == owner[:, :, :1]).all()


@pytest.mark.parametrize("B,F,H", SHAPES)
def test_cell_tiling_takes_the_fewest_rows_that_fit_its_blocks(B, F, H):
    """Two blocks an SM where the weight column sits in registers (K <=
    CELL_REG_K), one wave where it streams; the most rows past that."""
    t = kernel.cell_tiling(B, F, H)
    most = (2 if F + H <= kernel.CELL_REG_K else 1) * kernel.SMS
    assert t.grid[0] * t.grid[1] <= most or t.rows == kernel.CELL_ROWS[-1]
    for r in (r for r in kernel.CELL_ROWS if r < t.rows):
        assert kernel.cell_tiling(B, F, H, r).grid[0] * t.grid[1] > most


def test_cell_tiling_at_the_serving_step():
    """The scan path's step, (250, 5, 40): one row a block, all 40 units,
    160 threads (five full warps), 250 blocks; the unit tiles above
    4H = 512 split H evenly."""
    assert kernel.cell_tiling(*smoke.CELL_MAIN) == (1, 40, 160, (250, 1))
    assert kernel.cell_tiling(250, 5, 129) == (4, 72, 288, (63, 2))
    assert kernel.cell_tiling(250, 5, 512) == (8, 128, 512, (32, 4))
    assert kernel.cell_tiling(250, 5, 1024) == (8, 128, 512, (32, 8))
    assert kernel.cell_tiling(2048, 5, 40) == (8, 40, 160, (256, 1))
    assert kernel.cell_tiling(0, 5, 40) == (1, 40, 160, (0, 1))


def test_cell_tiling_refuses_what_the_kernel_cannot_launch():
    with pytest.raises(ValueError, match="rows a block"):
        kernel.cell_tiling(250, 5, 40, rows=3)
    with pytest.raises(ValueError, match="H >= 1"):
        kernel.cell_tiling(250, 5, 0)
    with pytest.raises(ValueError, match="B, F >= 0"):
        kernel.cell_tiling(250, -1, 40)
