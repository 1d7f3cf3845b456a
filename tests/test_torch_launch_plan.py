"""The launch plans of the stencil and Jacobi kernels (ops/stencil3d.py::plan,
ops/jacobi.py::plan), checked on the CPU:

* the vector width (elements of X per load) is the widest that the
  columns a point holds, X's row stride and X's address all allow;
* the stencil's tiles, column groups and planes cover every grid point
  and column exactly once: by enumeration on small odd grids, and by
  counting the extents on grids up to 1024^3;
* the grid stays within CUDA's limits, and a grid past them is refused;
* the Jacobi grid reaches every element once, in one pass;
* a shape the kernels do not take raises.

Exact checks: a plan is integer arithmetic."""

import itertools

import numpy as np
import pytest

from primme_tpu_torch.ops import jacobi as JK
from primme_tpu_torch.ops import stencil3d as ST

SIZES = (4, 8)


def _widest(kc, ldx, align, size):
    """The rule, written out: 16, 8 or 4 bytes a load, all three dividing."""
    ok = [w for w in (1, 2, 4) if w * size <= 16 and kc % w == 0
          and ldx % w == 0 and align % (w * size) == 0]
    return max(ok)


@pytest.mark.parametrize("size", SIZES)
def test_vector_width_only_where_allowed(size):
    for k, extra, align in itertools.product(range(1, 18), range(4),
                                             range(0, 16, size)):
        ldx = k + extra
        kc = ST.column_group(k)
        assert k % kc == 0 and kc in (1, 2, 4, 8)
        assert kc == max(c for c in (1, 2, 4, 8) if k % c == 0)
        p = ST.plan(5, 6, 7, k, ldx, align, size)
        q = JK.plan(210, k, ldx, align, size)
        # a stencil point and a Jacobi row group both take kc whole
        assert p.kc == q.kc == kc
        for r in (p, q):
            assert r.vw == _widest(r.kc, ldx, align, size)


def test_vector_path_cases():
    # the solve's slices of a [n, 24] f32 basis: an odd column offset is
    # 4 bytes off 8, so k=2 loads scalars there and pairs at an even one
    assert ST.vector_width(2, 24, 4, 4) == 1
    assert ST.vector_width(2, 24, 8, 4) == 2
    assert ST.vector_width(2, 2, 0, 4) == 2      # contiguous [n, 2]
    assert ST.vector_width(1, 1, 0, 4) == 1      # k=1 has no vector path
    assert ST.vector_width(8, 8, 0, 4) == 4      # 16 bytes a load
    assert ST.vector_width(8, 8, 0, 8) == 2
    assert ST.vector_width(2, 24, 8, 8) == 1     # f64 pairs need 16 bytes
    assert ST.vector_width(4, 6, 0, 4) == 2      # the row stride limits it


def block_extent(p, nx, ny, nz, bx, by, bz):
    """The part block (bx, by, bz) of plan p computes, by the kernel's map:
    l tile bx, j tile by, (plane, column group) pair bz, group fastest.
    Half-open (i, j, l, column) ranges."""
    i, g = divmod(bz, p.groups)
    return ((i, i + 1), (by * p.tj, min(ny, (by + 1) * p.tj)),
            (bx * p.tl, min(nz, (bx + 1) * p.tl)), (g * p.kc, (g + 1) * p.kc))


def _covered(p, nx, ny, nz, k):
    seen = np.zeros((nx, ny, nz, k), np.int32)
    for block in itertools.product(*map(range, p.grid)):
        (i0, i1), (j0, j1), (l0, l1), (c0, c1) = block_extent(
            p, nx, ny, nz, *block)
        assert i1 <= nx and j0 < j1 and l0 < l1 and c1 <= k
        assert j1 - j0 <= p.tj and l1 - l0 <= p.tl <= ST.TILE_L
        seen[i0:i1, j0:j1, l0:l1, c0:c1] += 1
    return seen


@pytest.mark.parametrize("grid", [(1, 1, 1), (3, 5, 7), (17, 33, 65),
                                  (9, 1, 33), (2, 13, 1), (31, 3, 5)])
def test_stencil_plan_covers_each_point_once(grid):
    nx, ny, nz = grid
    # every column group a point may hold, one thread a point or several
    for k, size in itertools.product((1, 2, 3, 4, 8, 13), SIZES):
        for kc in (c for c in (1, 2, 4, 8) if k % c == 0):
            p = ST.plan(nx, ny, nz, k, k, 0, size, kc)
            assert (_covered(p, nx, ny, nz, k) == 1).all(), (grid, k, kc)


def _axis(pieces, dim):
    """Half-open pieces that tile [0, dim) in order, none empty."""
    pos = 0
    for a, b in pieces:
        assert a == pos and b > a
        pos = b
    return pos == dim


@pytest.mark.parametrize("grid", [(64, 64, 64), (128, 128, 128),
                                  (256, 256, 256), (1024, 1024, 1024),
                                  (1000, 7, 1023), (3, 1024, 999)])
def test_stencil_plan_extents_sum_to_n(grid):
    nx, ny, nz = grid
    for k, size in itertools.product((1, 2, 8, 13), SIZES):
        p = ST.plan(nx, ny, nz, k, k, 0, size)
        rows = [(t * p.tj, min(ny, (t + 1) * p.tj)) for t in range(p.tiles_j)]
        lines = [(t * p.tl, min(nz, (t + 1) * p.tl))
                 for t in range(p.grid[0])]
        cols = [(g * p.kc, (g + 1) * p.kc) for g in range(p.groups)]
        assert _axis(rows, ny) and _axis(lines, nz) and _axis(cols, k)
        # one block a (l tile, j tile, plane, column group)
        assert p.grid == (len(lines), len(rows), nx * len(cols))
        # the points the pieces cover sum to n k, with no overlap
        assert nx * sum(b - a for a, b in rows) \
            * sum(b - a for a, b in lines) * sum(b - a for a, b in cols) \
            == nx * ny * nz * k
        for block in {(0, 0, 0), tuple(g - 1 for g in p.grid),
                      (p.grid[0] // 2, p.grid[1] // 2, p.grid[2] // 2)}:
            i, j, l, c = block_extent(p, nx, ny, nz, *block)
            assert l == lines[block[0]] and j == rows[block[1]]
            assert (i, c) == ((block[2] // p.groups, block[2] // p.groups + 1),
                              cols[block[2] % p.groups])


def test_stencil_plan_picks_its_form():
    # one thread a point of up to 16 bytes, 32 points a tile along l;
    # wider points shared by threads, 16 bytes each
    for n in (64, 256):
        for k, size, tl in ((1, 4, 32), (2, 4, 32), (8, 4, 16), (8, 8, 8),
                            (4, 8, 16), (2, 8, 32)):
            p = ST.plan(n, n, n, k, k, 0, size)
            assert p.kc == k and p.tl == tl and p.grid[0] == n // tl
            assert p.grid == (n // tl, n // 8, n) and p.tj == 8
    # the odd-offset slice: the same tile, scalar loads
    s = ST.plan(64, 64, 64, 2, 24, 4, 4)
    assert (s.kc, s.vw, s.tl, s.grid) == (2, 1, 32, (2, 8, 64))
    # f64 k=8 at an odd row stride: four threads a point, two loads each
    o = ST.plan(64, 64, 64, 8, 9, 0, 8)
    assert (o.kc, o.vw, o.tl, o.groups) == (8, 1, 8, 1)
    # k=13: 13 column groups of one, as planes of blocks
    w = ST.plan(5, 6, 7, 13, 13, 0, 4)
    assert (w.kc, w.groups, w.grid) == (1, 13, (1, 1, 65))
    # short j: tiles of 1, 2, 4 rows
    assert [ST.plan(3, ny, 5, 1, 1, 0, 4).tj for ny in (1, 2, 3, 9)] == \
        [1, 2, 4, 8]


def test_stencil_plan_refuses_tall_grids():
    # j tiles or planes x column groups up to gridDim's 65535 launch; one
    # more is refused
    assert ST.plan(65535, 3, 3, 2, 2, 0, 4).grid == (1, 1, 65535)
    assert ST.plan(1, 8 * 65535, 1, 1, 1, 0, 4).grid == (1, 65535, 1)
    assert ST.plan(5041, 4, 4, 13, 13, 0, 8).grid == (1, 1, 65533)
    for args in [(65536, 3, 3, 2), (1, 8 * 65535 + 1, 1, 1),
                 (5042, 4, 4, 13), (8192, 2, 2, 24 * 3)]:
        with pytest.raises(ValueError, match="grid takes"):
            ST.plan(*args, args[3], 0, 4)


@pytest.mark.parametrize("size", SIZES)
def test_stencil_plan_within_cuda_limits(size):
    for grid, k in itertools.product(
            [(1, 1, 1), (2, 65535, 3), (1024, 1024, 1024),
             (1, 8 * 65535, 1), (5041, 1, 1), (1, 1, 2 ** 30)], (1, 8, 13)):
        p = ST.plan(*grid, k, k, 0, size)
        assert 1 <= p.grid[0] <= 2 ** 31 - 1
        assert 1 <= p.grid[1] <= 65535 and 1 <= p.grid[2] <= 65535
        assert 32 <= ST.TILE_L * p.tj <= 256 and p.tj in (1, 2, 4, 8)


def test_stencil_plan_refuses():
    for args in [(0, 4, 4, 2), (4, 4, 4, 0), (2 ** 30 + 1, 4, 4, 2),
                 (4, 2 ** 31, 4, 1), (4, 4, 4, 2 ** 31)]:
        with pytest.raises(ValueError, match="outside"):
            ST.plan(*args, max(args[3], 1), 0, 4)
    # a column group the kernels are not compiled for, or not dividing k
    for k, kc in ((6, 3), (6, 4), (16, 16)):
        with pytest.raises(ValueError, match="columns a point"):
            ST.plan(4, 4, 4, k, k, 0, 4, kc)


def test_jacobi_plan():
    for n, k, ldx in itertools.product(
            (1, 255, 256, 257, 262144, 16777216), (1, 2, 3, 8), (0, 1)):
        p = JK.plan(n, k, k + ldx, 0, 4)
        rows = JK.THREADS // (p.kc // p.vw) * JK.ROWS
        assert p.blocks == -(-n // rows) and k % p.kc == 0
    # every element is reached once: block b, thread t takes vector
    # t % (kc/vw) of rows b R ROWS + u R + t / (kc/vw), u < ROWS, where a
    # run of R = THREADS / (kc/vw) rows is adjacent
    for k, ldx, align in [(1, 1, 0), (2, 2, 0), (2, 24, 4), (8, 8, 0),
                          (8, 9, 0), (6, 6, 8), (13, 13, 0)]:
        p = JK.plan(3000, k, ldx, align, 4)
        parts = p.kc // p.vw
        run = JK.THREADS // parts
        seen = np.zeros((3000, k), np.int32)
        for b, t, u in itertools.product(range(p.blocks), range(JK.THREADS),
                                         range(JK.ROWS)):
            r = b * run * JK.ROWS + u * run + t // parts
            c = (t % parts) * p.vw
            if r < 3000:
                for c0 in range(0, k, p.kc):
                    seen[r, c0 + c:c0 + c + p.vw] += 1
        assert (seen == 1).all(), (k, ldx, align)
    for n, k in [(0, 2), (4, 0), (2 ** 31 - 100, 1), (10, 2 ** 31)]:
        with pytest.raises(ValueError):
            JK.plan(n, k, max(k, 1), 0, 4)
