"""The launch plans of the half kernels (``ops/dia.py::plan`` with half
values, ``ops/stencil3d.py::plan`` in a half type, ``ops/jacobi.py::plan``
over a half diagonal), checked on the CPU:

* every row (grid point) and column is reached exactly once, by the
  kernels' thread maps: two rows 32 apart a DIA thread, or four adjacent
  rows where X is one column; one row a mixed DIA thread; two adjacent
  points along l a stencil thread where they are one aligned run; 16
  bytes of a contiguous block a Jacobi run-kernel thread;
* the loads stay aligned: X's vector loads to their width at every row;
  a run of halves (a DIA thread's values, or its X rows at kc = 1, a
  Jacobi thread's diagonal entries) read by ``csrc/half2.cuh::ld_halves``'
  rule; the stencil's runs of two points at every tap;
* the mixed DIA kernel's 32-bit row shifts (offsets clamped to [-n, n])
  put every row on or off the edge as the 64-bit offsets do;
* the grid stays within CUDA's limits;
* a shape the kernels do not take raises.

Exact checks: a plan is integer arithmetic."""

import itertools

import numpy as np
import pytest

from primme_tpu_torch.ops import dia as DK
from primme_tpu_torch.ops import jacobi as JK
from primme_tpu_torch.ops import stencil3d as ST

# (n, k, ldx, align in bytes): contiguous blocks and slices of wider ones,
# odd n, odd and even strides, every 2-byte alignment
DIA_CASES = [(n, k, ldx, a) for n in (1, 7, 255, 513, 1031)
             for k, ldx in ((1, 1), (1, 3), (2, 2), (2, 24), (3, 3), (4, 4),
                            (8, 8), (8, 9), (6, 6), (13, 13))
             for a in (0, 2, 4, 8)]


def ld_halves(addr, count):
    """The loads ``ld_halves<count>`` issues for ``count`` halves at byte
    address ``addr`` (``csrc/half2.cuh``): (byte address, width) each."""
    if addr % 4 == 0:
        for w in (16, 8):
            if 2 * count >= w and addr % w == 0:
                return [(addr + i * w, w) for i in range(2 * count // w)]
        return [(addr + 4 * i, 4) for i in range(count // 2)]
    return [(addr - 2 + 4 * i, 4) for i in range(count // 2 + 1)]


@pytest.mark.parametrize("count", [2, 4, 8, 16])
def test_ld_halves_rule_aligned_and_covering(count):
    for addr in range(0, 64, 2):
        loads = ld_halves(addr, count)
        got = set()
        for a, w in loads:
            assert a % w == 0 and w in (4, 8, 16), (addr, loads)
            got |= set(range(a, a + w))
        need = set(range(addr, addr + 2 * count))
        assert need <= got
        # what it reads besides lies in the 4-byte words of the range
        assert min(got) >= addr // 4 * 4
        assert max(got) < -(-(addr + 2 * count) // 4) * 4


def _dia_threads(p, n, k):
    """How often DIA plan p reaches each (row, column): thread t (lane t %
    32 of warp t // 32) of the grid and column group g takes columns [g kc,
    + kc) of rows below n: R adjacent rows [R t, R t + R) for the run
    kernel, else rows (t - lane) R + lane + 32 r, r < R, 32 apart (R = 1:
    row t)."""
    seen = np.zeros((n, k), np.int32)
    t, r, g, c = np.meshgrid(np.arange(p.grid[0] * DK.THREADS),
                             np.arange(p.rows), np.arange(p.grid[1]),
                             np.arange(p.kc), indexing="ij")
    if p.kernel == DK.RUN_KERNEL:
        row = t * p.rows + r
    else:
        lane = t % 32
        row = (t - lane) * p.rows + lane + 32 * r
    col = g * p.kc + c
    keep = row < n
    np.add.at(seen, (row[keep], col[keep]), 1)
    return seen


@pytest.mark.parametrize("xsize", [2, 4, 8])
def test_half_dia_plan_covers_each_element_once(xsize):
    """Half values with a half (2), f32 (4) or f64 (8) block, and the
    f32, f64 and complex kernels' plans (one row a thread)."""
    for n, k, ldx, align in DIA_CASES:
        if align % xsize:               # no tensor of this type lies there
            continue
        p = DK.plan(n, k, ldx, align, xsize)
        half = xsize == 2      # a half block holds half values
        run = half and k % 2 == 1 and ldx == 1
        assert p.kc == ST.column_group(k)
        assert p.kernel == (DK.RUN_KERNEL if run else
                            DK.HALF_KERNEL if half else DK.ROW_KERNEL)
        assert p.rows == (DK.RUN_ROWS if run else
                          DK.HALF_ROWS if half else 1)
        assert p.vw == (DK.RUN_ROWS if run else
                        ST.vector_width(p.kc, ldx, align, xsize))
        assert p.grid[0] == -(-n // (DK.THREADS * p.rows))
        assert (_dia_threads(p, n, k) == 1).all(), (n, k, ldx)


@pytest.mark.parametrize("xsize", [2, 4, 8])
def test_half_dia_loads_aligned(xsize):
    """X's vector loads at every row and column group of the plan, and the
    run kernel's loads (a thread's values at any row of any diagonal; X
    one column) by ``ld_halves``' rule."""
    for n, k, ldx, align in DIA_CASES:
        if align % xsize:
            continue
        p = DK.plan(n, k, ldx, align, xsize)
        if p.kernel == DK.RUN_KERNEL:   # rows j0 .. j0 + R - 1, any j0
            assert xsize == 2 and p.kc == 1 and ldx == 1
            assert p.vw == p.rows == DK.RUN_ROWS
            for j0 in range(0, min(n, 40)):
                for a, w in ld_halves(align + 2 * j0, p.rows):
                    assert a % w == 0
            continue
        assert p.vw in (1, 2, 4, 8) and p.vw * xsize <= 16
        assert p.kc % p.vw == 0 and ldx % p.vw == 0
        for row, g, c in itertools.product(range(0, n, 97), range(p.grid[1]),
                                           range(0, p.kc, p.vw)):
            addr = align + xsize * (row * ldx + g * p.kc + c)
            assert addr % (p.vw * xsize) == 0, (n, k, ldx, align)
    # the run kernel's values: vals [B, n] at 256-aligned storage, any b
    # and any (shifted) first row
    for n in (7, 8, 255, 256):
        for b, j0 in itertools.product(range(5), range(0, 24)):
            for a, w in ld_halves(2 * (b * n + j0), DK.RUN_ROWS):
                assert a % w == 0


def test_half_dia_plan_cases():
    half, run = DK.HALF_KERNEL, DK.RUN_KERNEL
    # the smoke's k=2 block at 64^3: two rows a thread, 4-byte row loads
    assert DK.plan(262144, 2, 2, 0, 2) == DK.Plan(2, 2, (512, 1), half)
    # k=1, one column: four adjacent rows a thread, their X one run
    assert DK.plan(262144, 1, 1, 0, 2) == DK.Plan(1, 4, (256, 1), run)
    # k=1 slice of a wider block: scalar loads, two rows a thread paired
    assert DK.plan(262144, 1, 24, 2, 2) == DK.Plan(1, 1, (512, 1), half)
    # the solve's slice at an odd column offset: scalar loads, paired
    assert DK.plan(262144, 2, 24, 2, 2) == DK.Plan(2, 1, (512, 1), half)
    # mixed (an f32 block), f32, f64 and complex: one row a thread
    assert DK.plan(262144, 2, 2, 0, 4) == DK.Plan(2, 2, (1024, 1))
    assert DK.plan(262144, 2, 2, 0, 8).rows == 1


def test_half_dia_plan_within_cuda_limits_and_refuses():
    for n, k, ldx in itertools.product((1, 2 ** 31 - 1), (1, 8, 13),
                                       (0, 1)):
        p = DK.plan(n, k, k + ldx, 0, 2)
        assert 1 <= p.grid[0] <= 2 ** 31 - 1 and 1 <= p.grid[1] <= 65535
        assert p.grid[0] * DK.THREADS * p.rows >= n
    assert DK.plan(5, 65535, 65535, 0, 2).grid == (1, 65535)
    with pytest.raises(ValueError, match="grid takes"):
        DK.plan(5, 65537, 65537, 0, 2)
    for args in [(0, 2), (4, 0), (2 ** 31, 1), (4, 2 ** 31)]:
        with pytest.raises(ValueError, match="outside"):
            DK.plan(*args, max(args[1], 1), 0, 2)


def _stencil_threads(p, nx, ny, nz, k):
    """How often the threads of stencil plan p reach each (i, j, l,
    column): block (bx, by, bz) of 32 x tj threads; thread (x, y) takes
    points l = bx tl + pts x + e (e < pts, l < nz), j = by tj + y, and
    (plane, column group) bz, group fastest. pts = tl / 32 (2 for a half
    type's runs of two points), else 1."""
    seen = np.zeros((nx, ny, nz, k), np.int32)
    pts = p.tl // ST.TILE_L
    assert pts in (1, 2)
    bx, by, bz, x, y, e, c = np.meshgrid(
        *map(np.arange, p.grid), np.arange(ST.TILE_L), np.arange(p.tj),
        np.arange(pts), np.arange(p.kc), indexing="ij")
    i, g = np.divmod(bz, p.groups)
    j, l = by * p.tj + y, bx * p.tl + pts * x + e
    keep = (l < nz) & (j < ny) & (i < nx)
    np.add.at(seen, (i[keep], j[keep], l[keep], (g * p.kc + c)[keep]), 1)
    return seen


@pytest.mark.parametrize("grid", [(1, 1, 1), (3, 5, 7), (2, 3, 64),
                                  (2, 2, 65), (1, 9, 130), (5, 1, 2)])
def test_half_stencil_plan_covers_each_point_once(grid):
    nx, ny, nz = grid
    for k in (1, 2, 3, 4, 8, 13):
        for kc in (c for c in (1, 2, 4, 8) if k % c == 0):
            for ldx, align in ((k, 0), (k + 1, 2), (24, 4)):
                p = ST.plan(nx, ny, nz, k, ldx, align, 2, kc)
                assert p.tl == (2 * ST.TILE_L if p.vw == 2 * kc
                                else ST.TILE_L)
                assert (_stencil_threads(p, nx, ny, nz, k) == 1).all(), (
                    grid, k, kc, ldx)


def test_half_stencil_loads_aligned():
    """Two points a thread (vw = 2 kc, kc <= 4: X's rows kc apart, nz even,
    X aligned to 4 kc bytes): the run of a point pair and of each of its
    i and j taps aligned to 4 kc bytes, the points past either end of the
    run to 2 kc (kc = 1: 4) bytes. Otherwise vector loads of vw halves
    aligned at every point and tap."""
    for (nx, ny, nz), kc, extra, align in itertools.product(
            [(3, 5, 8), (2, 3, 7), (4, 4, 64), (1, 2, 65)], (1, 2, 4, 8),
            (0, 1), (0, 2, 4, 6, 8, 12)):
        ldx = kc + extra
        p = ST.plan(nx, ny, nz, kc, ldx, align, 2)
        paired = kc <= 4 and ldx == kc and nz % 2 == 0 \
            and align % (4 * kc) == 0
        assert (p.vw == 2 * kc) == paired and p.tl == 32 * (1 + paired)
        if paired:
            edge = max(2, kc)
            for i, j, l in itertools.product(range(nx), range(ny),
                                             range(0, nz, 2)):
                row = (i * ny + j) * nz + l
                for d in (0, nz, -nz, ny * nz, -ny * nz):
                    assert (align + 2 * kc * (row + d)) % (4 * kc) == 0
                for h in (kc * row + 2 * kc, kc * row - edge):
                    assert (align + 2 * h) % (2 * edge) == 0
            continue
        assert p.vw * 2 <= 16 and kc % p.vw == 0 and ldx % p.vw == 0
        for row, c in itertools.product(range(60), range(0, kc, p.vw)):
            assert (align + 2 * (row * ldx + c)) % (2 * p.vw) == 0


def test_half_stencil_plan_within_cuda_limits_and_refuses():
    for grid, k in itertools.product(
            [(1, 1, 1), (2, 65535, 3), (1024, 1024, 1024), (1, 1, 2 ** 30),
             (70000, 1, 32)], (1, 2, 13)):
        p = ST.plan(*grid, k, k, 0, 2)
        assert 1 <= p.grid[0] <= 2 ** 31 - 1
        for _, (gx, gy, gz) in p.launches:
            assert gx == p.grid[0] and 1 <= gy <= 65535 and 1 <= gz <= 65535
        assert sum(gz for (y0, _), (_, _, gz) in p.launches if y0 == 0) \
            == p.grid[2]
    assert ST.plan(64, 64, 64, 1, 1, 0, 2).grid == (1, 8, 64)
    assert ST.plan(256, 256, 256, 2, 2, 0, 2).grid == (4, 32, 256)
    assert ST.plan(256, 256, 256, 8, 8, 0, 2).grid == (8, 32, 256)
    for args in [(0, 4, 4, 2), (4, 4, 4, 0), (2 ** 30 + 1, 4, 4, 2)]:
        with pytest.raises(ValueError, match="outside"):
            ST.plan(*args, max(args[3], 1), 0, 2)
    with pytest.raises(ValueError, match="columns a point"):
        ST.plan(4, 4, 4, 6, 6, 0, 2, 4)


# Jacobi over a half diagonal: (n, k, ldx, align in bytes) with a half (2),
# f32 (4) or f64 (8) block
JACOBI_CASES = [(n, k, ldx, a) for n in (1, 7, 255, 1031, 4099)
                for k, ldx in ((1, 1), (2, 2), (4, 4), (3, 3), (8, 8),
                               (2, 24), (1, 24), (6, 6))
                for a in (0, 4, 8)]


def _jacobi_elements(p, n, k):
    """How often Jacobi plan p reaches each (row, column). The run kernel:
    thread t of the grid takes the rows [R t, R t + R) below n, every
    column (R = ``p.rows``, the elements [E t, E t + E) of the block's run
    of n k, E = ``p.cols``); the row-group kernel: block b, thread t takes
    vector t % (kc/vw) of rows b S ROWS + u S + t / (kc/vw), u < ROWS, S =
    THREADS / (kc/vw), in every row group of kc."""
    seen = np.zeros((n, k), np.int32)
    if p.kernel == JK.RUN_KERNEL:
        assert p.cols == p.rows * k and p.kc == k
        t, r, c = np.meshgrid(np.arange(p.blocks * JK.THREADS),
                              np.arange(p.rows), np.arange(k), indexing="ij")
        row = t * p.rows + r
        keep = row < n
        np.add.at(seen, (row[keep], c[keep]), 1)
        return seen
    parts = p.kc // p.vw
    run = JK.THREADS // parts
    b, t, u, g, c = np.meshgrid(np.arange(p.blocks), np.arange(JK.THREADS),
                                np.arange(p.rows), np.arange(k // p.kc),
                                np.arange(p.vw), indexing="ij")
    row = b * run * p.rows + u * run + t // parts
    col = g * p.kc + (t % parts) * p.vw + c
    keep = row < n
    np.add.at(seen, (row[keep], col[keep]), 1)
    return seen


@pytest.mark.parametrize("size", [2, 4, 8])
def test_half_jacobi_plan_covers_each_element_once(size):
    """The run kernel exactly where the diagonal is half, the block
    contiguous (ldx == k) and 16-byte aligned and ``run_rows`` has rows
    (an even number of whole rows in 16 bytes: k = 1, 2, 4 for a half
    block, 1 and 2 for f32, 1 for f64); else the row-group kernel as for
    a diagonal of the block's type."""
    for n, k, ldx, align in JACOBI_CASES:
        if align % size:
            continue
        p = JK.plan(n, k, ldx, align, size, d_size=2)
        runs = ldx == k and align == 0 and JK.run_rows(k, size) > 0
        assert (p.kernel == JK.RUN_KERNEL) == runs, (n, k, ldx, align)
        if runs:
            assert p.rows * k * size == JK.RUN_BYTES and p.rows % 2 == 0
            assert p.blocks == -(-n // (JK.THREADS * p.rows))
        else:
            assert p == JK.plan(n, k, ldx, align, size)
        assert (_jacobi_elements(p, n, k) == 1).all(), (n, k, ldx, align)
    assert [k for k in range(1, 17) if JK.run_rows(k, 2)] == [1, 2, 4]
    assert [k for k in range(1, 17) if JK.run_rows(k, 4)] == [1, 2]
    assert [k for k in range(1, 17) if JK.run_rows(k, 8)] == [1]


@pytest.mark.parametrize("size", [2, 4, 8])
def test_half_jacobi_run_loads_aligned(size):
    """A run-kernel thread whose rows are all below n loads its 16 bytes of
    X in one aligned load and its R diagonal entries by ``ld_halves``'
    rule, at any place of d (an even or odd half); a thread whose rows
    pass n goes element by element (no vector load)."""
    for k in (k for k in (1, 2, 4) if JK.run_rows(k, size)):
        for n in (7, 64, 1031):
            p = JK.plan(n, k, k, 0, size, d_size=2)
            assert p.kernel == JK.RUN_KERNEL
            for t in range(p.blocks * JK.THREADS):
                r0 = t * p.rows
                if r0 + p.rows > n:     # the tail, element by element
                    continue
                assert (size * r0 * k) % JK.RUN_BYTES == 0
                for d_align in (0, 2, 4, 6):
                    for a, w in ld_halves(d_align + 2 * r0, p.rows):
                        assert a % w == 0 and a >= 0


def test_half_jacobi_plan_cases_and_limits():
    run = JK.RUN_KERNEL
    # the smoke's half k=2 block at 64^3: four rows a thread, one 16-byte
    # load of X and one 8-byte run of d
    assert JK.plan(262144, 2, 2, 0, 2) == JK.Plan(2, 8, 256, 8, 4, run)
    # the mixed f32 block at k=2 (a half basis): two rows a thread
    assert JK.plan(262144, 2, 2, 0, 4, d_size=2) == \
        JK.Plan(2, 4, 512, 4, 2, run)
    # an f32 diagonal keeps the row-group kernel
    assert JK.plan(262144, 2, 2, 0, 4).kernel == JK.ROW_KERNEL
    # a slice, an unaligned block, k = 8: the row-group kernel
    for args in [(24, 0), (2, 4)]:
        assert JK.plan(262144, 2, *args, 2).kernel == JK.ROW_KERNEL
    assert JK.plan(262144, 8, 8, 0, 2).kernel == JK.ROW_KERNEL
    for n in (1, 2 ** 31 - 2 ** 12):
        p = JK.plan(n, 1, 1, 0, 2)
        assert p.kernel == run and 1 <= p.blocks <= 2 ** 31 - 1
        assert p.blocks * JK.THREADS * p.rows >= n
    for n, k in [(0, 2), (4, 0), (2 ** 31 - 100, 1)]:
        with pytest.raises(ValueError, match="outside|no element"):
            JK.plan(n, k, max(k, 1), 0, 2)
    with pytest.raises(ValueError, match="not a multiple"):
        JK.plan(100, 2, 2, 1, 2)


@pytest.mark.parametrize("xsize", [4, 8])
def test_mixed_dia_plan_covers_each_element_once(xsize):
    """Half values with an f32 or f64 block: the mixed kernel under the
    f32 and f64 kernels' thread map and load width (one row a thread),
    every element once, X's vector loads aligned."""
    for n, k, ldx, align in DIA_CASES:
        if align % xsize:
            continue
        p = DK.plan(n, k, ldx, align, xsize, vals_size=2)
        assert p == DK.plan(n, k, ldx, align, xsize)._replace(
            kernel=DK.MIXED_KERNEL), (n, k, ldx, align)
        assert p.rows == 1 and p.grid[0] == -(-n // DK.THREADS)
        assert (_dia_threads(p, n, k) == 1).all(), (n, k, ldx)
        for row, g, c in itertools.product(range(0, n, 97), range(p.grid[1]),
                                           range(0, p.kc, p.vw)):
            addr = align + xsize * (row * ldx + g * p.kc + c)
            assert addr % (p.vw * xsize) == 0, (n, k, ldx, align)


def test_mixed_dia_plan_limits():
    mixed = DK.MIXED_KERNEL
    assert DK.plan(262144, 2, 2, 0, 4, vals_size=2) == \
        DK.Plan(2, 2, (1024, 1), mixed)
    assert DK.plan(262144, 2, 24, 4, 8, vals_size=2) == \
        DK.Plan(2, 1, (1024, 1), mixed)
    # rows past 2^30 or a row stride past 2^31: dia_kernel, its 64-bit
    # rows
    assert DK.plan(2 ** 30, 1, 1, 0, 4, vals_size=2).kernel == DK.ROW_KERNEL
    assert DK.plan(2 ** 30 - 1, 1, 1, 0, 4, vals_size=2).kernel == mixed
    assert DK.plan(3, 1, 2 ** 31, 0, 4, vals_size=2).kernel == DK.ROW_KERNEL
    assert DK.plan(3, 1, 2 ** 31 - 1, 0, 4, vals_size=2).kernel == mixed
    # more offsets than 48 KB of shared memory holds: dia_kernel
    for B, kernel in ((DK.MIXED_MAX_B, mixed),
                      (DK.MIXED_MAX_B + 1, DK.ROW_KERNEL)):
        assert DK.plan(300, 2, 2, 0, 4, vals_size=2,
                       diagonals=B).kernel == kernel
    assert 4 * DK.MIXED_MAX_B <= 48 * 1024
    assert DK.plan(5, 65535, 65535, 0, 4, vals_size=2).grid == (1, 65535)
    with pytest.raises(ValueError, match="grid takes"):
        DK.plan(5, 65537, 65537, 0, 4, vals_size=2)
    for args in [(0, 2), (4, 0), (2 ** 31, 1)]:
        with pytest.raises(ValueError, match="outside"):
            DK.plan(*args, max(args[1], 1), 0, 4, vals_size=2)


def test_mixed_dia_shifts_keep_the_edges():
    """The mixed kernel's 32-bit row shift c = clamp(off, -n, n): for every
    row i of [0, n), row i + c (matmat) and i - c (rmatmat) lie in [0, n)
    exactly when i + off and i - off do, and are then the same row; every
    index it forms stays in 32 bits for n < 2^30."""
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 1000, DK.MIXED_MAX_N - 1):
        offs = np.concatenate([
            np.arange(-3, 4), [n - 1, -(n - 1), n, -n, n + 1, -n - 1,
                               2 ** 40, -2 ** 40, 2 ** 63 - 1, -2 ** 63],
            rng.integers(-2 * n, 2 * n + 1, 50)]).astype(np.int64)
        c = np.clip(offs, -n, n)
        rows = np.unique(np.concatenate([
            np.arange(min(n, 50)), n - 1 - np.arange(min(n, 50)),
            rng.integers(0, n, 50)]))
        for sign in (1, -1):
            j64 = rows[:, None].astype(object) + sign * offs[None, :].astype(
                object)
            j32 = rows[:, None] + sign * c[None, :]
            in64 = (j64 >= 0) & (j64 < n)
            in32 = (j32 >= 0) & (j32 < n)
            assert (in64 == in32).all()
            assert (j32[in32] == j64[in64].astype(np.int64)).all()
            assert np.abs(j32).max() < 2 ** 31
