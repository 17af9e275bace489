"""Launch geometry of the port's CUDA kernels, checked on the CPU.

The wrappers choose each kernel's launch in a pure function
(``ops/passport_epilogue.py::epilogue_geometry``,
``ops/fused_augment.py::augment_geometry``) and pass it to the kernel. These
tests walk that geometry the way the kernel's loops walk it, for every shape
``chip_smoke.py`` runs and for ragged ones, and check that each output
element is written exactly once, that the vector paths are taken only where
their alignment and divisibility hold, and that the launch stays within
CUDA's limits. The kernels themselves are held to their plain versions on
the card (tests/test_torch_port_cuda.py).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

from deepipr_tpu_torch.ops import fused_augment as k1
from deepipr_tpu_torch.ops import passport_epilogue as k2

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "deepipr_tpu_torch" / "csrc"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()
MAX_GRID_X, MAX_GRID_Y, MAX_BLOCK = 2**31 - 1, 65535, 1024
# (pointer of y or of the set, pointer of out): aligned, and 4 or 1 bytes off
POINTERS = {"aligned": (0x7F0000000000, 0x7F0000100000),
            "input_off": (0x7F0000000004, 0x7F0000100000),
            "output_off": (0x7F0000000000, 0x7F0000100004)}
# bf16 outputs and y: also 2 and 8 bytes off a 16-byte boundary
POINTERS_BF16 = {**POINTERS,
                 "input_off2": (0x7F0000000002, 0x7F0000100000),
                 "output_off2": (0x7F0000000000, 0x7F0000100002),
                 "output_off8": (0x7F0000000000, 0x7F0000100008)}


def _constant(source: str, name: str) -> int:
    """The value of ``constexpr int name = <product of integers>;``."""
    expr = re.search(rf"constexpr int {name} = ([0-9 *]+);",
                     (CSRC / source).read_text()).group(1)
    return int(np.prod([int(f) for f in expr.split("*")]))


def test_python_limits_match_the_kernels():
    assert _constant("passport_epilogue.cu", "kMaxThreads") == k2.MAX_THREADS
    assert _constant("passport_epilogue.cu", "kStage") == k2.STAGE
    assert _constant("passport_epilogue.cu", "kMaxSmem") == k2.MAX_SMEM
    assert _constant("passport_epilogue.cu", "kBwdUnroll") == k2.BWD_ROWS
    assert _constant("fused_augment.cu", "kMaxThreads") == k1.MAX_THREADS
    assert _constant("fused_augment.cu", "kMaxSmem") == k1.MAX_SMEM


# ------------------------------------------------------------------ K2

EPILOGUE_SHAPES = sorted(set(SMOKE.CHECK_SHAPES) | {
    (3, 40, 5, 3), (1, 1, 1, 1), (5, 7, 1, 1), (2, 1000, 1, 2),
    (300, 64, 2, 2), (1, 3, 50, 50), (9, 17, 23, 29), (4, 2, 64, 72),
    (1, 64, 112, 112)})


def _walk_epilogue(n, c, hw, geo):
    """Count how often the kernel's loops write each element of out, read
    each passport element into the GAP, and write each scale/bias entry;
    check that
    every thread of a tile carries y where the tile has a position for each
    (every vector tile at the main shapes) and that the GAP's stage length
    is the one that fixes its order."""
    vw = 16 // geo.itemsize if geo.vector else 1
    written = np.zeros(n * c * hw, np.int32)
    staged = np.zeros(c * hw, np.int32)
    coefficients = np.zeros(c, np.int32)
    for cy in range(geo.grid[1]):
        c0 = cy * geo.tile_c
        tc = min(geo.tile_c, c - c0)
        assert tc >= 1
        positions = tc * hw // vw
        assert positions * vw == tc * hw
        # row_split groups of span threads; group g on rows g, g + split, ...
        split = geo.row_split
        span_threads = geo.threads // split
        assert split == 1 or span_threads >= geo.tile_c * hw // vw
        groups = [(t // span_threads,
                   np.arange(t % span_threads, positions, span_threads))
                  for t in range(geo.threads)]
        # a full tile puts every thread on y, but for the rounding of a
        # warp: one thread per position, or per STAGE passport floats with
        # the rows split between the groups
        if tc == geo.tile_c:
            assert sum(g >= split or q.size == 0 for g, q in groups) < 32
            if positions >= geo.threads:
                assert all(q.size for _, q in groups)
        for g, p in groups:
            if g >= split or p.size == 0:
                continue
            # a thread's channel is fixed: a vector never straddles two
            assert np.array_equal(p * vw // hw, (p * vw + vw - 1) // hw)
            span = (p[:, None] * vw + np.arange(vw)[None, :]).ravel()
            for rx in range(geo.grid[0]):
                rows = np.arange(rx * geo.tile_rows + g,
                                 min(n, (rx + 1) * geo.tile_rows), split)
                idx = (rows[:, None] * c * hw + c0 * hw
                       + span[None, :]).ravel()
                np.add.at(written, idx, 1)
        for rx in range(geo.grid[0]):
            assert rx * geo.tile_rows < n
            if rx == 0:
                coefficients[c0:c0 + tc] += 1
        # the GAP: G lanes a channel, groups of channels a pass, stages of
        # gap_len positions; lane g reads positions g, g + G, ... of each
        assert geo.gap_len == min(hw, k2.MAX_GAP)
        assert tc == 1 or geo.gap_len == hw
        group = 1
        while group < 32 and k2.STAGE * group < geo.gap_len:
            group *= 2
        for first in range(0, tc, geo.threads // group):
            for t in range(geo.threads):
                ch = first + t // group
                if ch >= tc:
                    continue
                for off in range(0, hw, geo.gap_len):
                    length = min(geo.gap_len, hw - off)
                    j = np.arange(t % group, length, group)
                    np.add.at(staged, (c0 + ch) * hw + off + j, 1)
    return written, staged, coefficients


@pytest.mark.parametrize("pointers", sorted(POINTERS))
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
def test_epilogue_geometry_covers_every_plane_once(shape, pointers):
    n, c, h, w = shape
    geo = k2.epilogue_geometry(n, c, h * w, *POINTERS[pointers])
    written, staged, coefficients = _walk_epilogue(n, c, h * w, geo)
    assert (written == 1).all()
    assert (staged == 1).all()
    assert (coefficients == 1).all()


@pytest.mark.parametrize("pointers", sorted(POINTERS))
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
def test_epilogue_geometry_paths_and_limits(shape, pointers):
    n, c, h, w = shape
    y_ptr, out_ptr = POINTERS[pointers]
    geo = k2.epilogue_geometry(n, c, h * w, y_ptr, out_ptr)
    assert geo.vector == ((h * w) % 4 == 0 and pointers == "aligned")
    assert 32 <= geo.threads <= min(k2.MAX_THREADS, MAX_BLOCK)
    assert geo.threads % 32 == 0
    assert 1 <= geo.grid[0] <= MAX_GRID_X and 1 <= geo.grid[1] <= MAX_GRID_Y
    assert geo.smem_bytes <= k2.MAX_SMEM
    assert geo.smem_bytes == 4 * 4 * geo.tile_c  # the coefficient rows
    # about TARGET_BLOCKS blocks, unless the batch is too small for it
    assert geo.grid[0] * geo.grid[1] <= 2 * k2.TARGET_BLOCKS or \
        geo.tile_rows == 1


@pytest.mark.parametrize("pointers", sorted(POINTERS_BF16))
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
def test_epilogue_geometry_bf16_covers_every_plane_once(shape, pointers):
    """The bf16 form: 8 elements per 16-byte vector, at least one thread per
    STAGE passport floats, the rows split where that leaves threads without
    a position, the same limits."""
    n, c, h, w = shape
    y_ptr, out_ptr = POINTERS_BF16[pointers]
    geo = k2.epilogue_geometry(n, c, h * w, y_ptr, out_ptr, itemsize=2)
    assert geo.itemsize == 2
    assert geo.vector == ((h * w) % 8 == 0 and y_ptr % 16 == 0
                          and out_ptr % 16 == 0)
    assert 32 <= geo.threads <= min(k2.MAX_THREADS, MAX_BLOCK)
    assert geo.threads % 32 == 0 and geo.smem_bytes <= k2.MAX_SMEM
    assert 1 <= geo.grid[0] <= MAX_GRID_X and 1 <= geo.grid[1] <= MAX_GRID_Y
    if geo.vector:  # every thread of a full vector tile carries y
        positions = geo.tile_c * h * w // 8
        assert geo.threads - geo.row_split * positions < 32
    written, staged, coefficients = _walk_epilogue(n, c, h * w, geo)
    assert (written == 1).all()
    assert (staged == 1).all()
    assert (coefficients == 1).all()


def test_epilogue_geometry_bf16_at_the_main_shape():
    """(256, 512, 4, 4) in bf16: the same 32-channel tiles (1 KB a row), 64
    positions of 8 elements, 128 threads for the GAP (4 lanes for each of
    the 32 channels), in two groups of 64 that take the block's 8 rows in
    turn: every thread on y, 4 rows each."""
    geo = k2.epilogue_geometry(256, 512, 16, *POINTERS["aligned"],
                               itemsize=2)
    assert geo == k2.EpilogueGeometry(
        grid=(32, 16), threads=128, tile_c=32, tile_rows=8, gap_len=16,
        smem_bytes=512, vector=True, itemsize=2, row_split=2)


def test_epilogue_geometry_at_the_main_shape():
    """The serving path's (256, 512, 4, 4): 32-channel spans of 2 KB, one
    float4 a thread, 8 rows in flight, 16 x 32 = 512 blocks."""
    geo = k2.epilogue_geometry(256, 512, 16, *POINTERS["aligned"])
    assert geo == k2.EpilogueGeometry(
        grid=(32, 16), threads=128, tile_c=32, tile_rows=8, gap_len=16,
        smem_bytes=512, vector=True)


# -------------------------------------------------------------- K2-bwd

BACKWARD_SHAPES = sorted(set(SMOKE.BWD_SHAPES) | set(EPILOGUE_SHAPES))


def _walk_backward(n, c, hw, geo, order):
    """Count how often the kernel writes each element of dy and each
    (channel, row block) partial; check that the threads its per-channel
    reduction reads for a channel, [ch * per, (ch + 1) * per), are exactly
    the threads whose positions hold that channel (in one warp where the
    shuffle path takes them). Then let each channel tile's blocks arrive in
    ``order`` (a seeded draw) at the tile's counter: the block that sees
    grid[0] - 1 finishes, reads every partial of its channels and writes
    their dkey_out/dskey_out planes, and sets the counter back to 0."""
    vw = 4 if geo.vector else 1
    written = np.zeros(n * c * hw, np.int32)
    partials = np.zeros((c, geo.grid[0]), np.int32)
    planes = np.zeros(c * hw, np.int32)
    per = min(hw // vw, geo.threads)
    for cy in range(geo.grid[1]):
        c0 = cy * geo.tile_c
        tc = min(geo.tile_c, c - c0)
        positions = tc * hw // vw
        assert positions * vw == tc * hw
        assert geo.tile_c == 1 or positions <= geo.threads
        owners = {}
        for t in range(geo.threads):
            chans = {p * vw // hw for p in range(t, positions, geo.threads)}
            assert len(chans) <= 1  # a thread sums one channel
            for ch in chans:
                owners.setdefault(ch, set()).add(t)
        for ch in range(tc):
            read = set(range(ch * per, (ch + 1) * per))
            assert owners[ch] <= read
            # the other threads read hold no position (their sums are 0)
            assert all(not owners[o] & read for o in owners if o != ch)
            if 32 % per == 0:  # the shuffle path: one warp's lanes
                assert ch * per // 32 == ((ch + 1) * per - 1) // 32
        p = np.arange(positions)
        span = (p[:, None] * vw + np.arange(vw)[None, :]).ravel()
        for rx in range(geo.grid[0]):
            rows = np.arange(rx * geo.tile_rows,
                             min(n, (rx + 1) * geo.tile_rows))
            assert rows.size >= 1
            idx = (rows[:, None] * c * hw + c0 * hw + span[None, :]).ravel()
            np.add.at(written, idx, 1)
            partials[c0:c0 + tc, rx] += 1
        counter, finishers = 0, 0
        for rx in order.permutation(geo.grid[0]):
            last = counter == geo.grid[0] - 1
            counter += 1
            if last:
                finishers += 1
                # every partial of the tile is in place before it is read
                assert (partials[c0:c0 + tc] == 1).all()
                planes[c0 * hw:(c0 + tc) * hw] += 1
                counter = 0
        assert finishers == 1 and counter == 0
    return written, partials, planes


@pytest.mark.parametrize("pointers", sorted(POINTERS))
@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
def test_backward_geometry_covers_every_element_once(shape, pointers):
    n, c, h, w = shape
    geo = k2.backward_geometry(n, c, h * w, *POINTERS[pointers])
    assert geo.vector == ((h * w) % 4 == 0 and pointers == "aligned")
    assert 32 <= geo.threads <= min(k2.MAX_THREADS, MAX_BLOCK)
    assert geo.threads % 32 == 0
    assert 1 <= geo.grid[0] <= MAX_GRID_X
    assert 1 <= geo.grid[1] <= min(MAX_GRID_Y, k2.MAX_C_TILES)
    # every thread has BWD_ROWS rows in flight, unless the batch is smaller
    assert geo.tile_rows >= min(n, k2.BWD_ROWS)
    written, partials, planes = _walk_backward(
        n, c, h * w, geo, np.random.default_rng(n * c + h * w))
    assert (written == 1).all()
    assert (partials == 1).all()
    assert (planes == 1).all()


def test_backward_geometry_at_the_attack_batch():
    """The attack CLIs' (64, 512, 4, 4): the forward's 32-channel spans, one
    float4 a thread, 4 rows a block (4 rows x 2 streams x 16 bytes in
    flight a thread), 16 x 16 = 256 blocks."""
    geo = k2.backward_geometry(64, 512, 16, *POINTERS["aligned"])
    assert geo == k2.BackwardGeometry(grid=(16, 16), threads=128, tile_c=32,
                                      tile_rows=4, vector=True)


def test_backward_geometry_at_the_main_shape():
    """(256, 512, 4, 4): 8 rows a block, 32 x 16 = 512 blocks."""
    geo = k2.backward_geometry(256, 512, 16, *POINTERS["aligned"])
    assert geo == k2.BackwardGeometry(grid=(32, 16), threads=128, tile_c=32,
                                      tile_rows=8, vector=True)


# ------------------------------------------------------------------ K1

AUGMENT_SHAPES = sorted({(b, s[1], s[2], s[3])
                         for _, s, b, _ in SMOKE.AUGMENT_SHAPES} | {
    (2, 224, 224, 3), (3, 7, 5, 1), (1, 33, 33, 3), (2, 15, 15, 3),
    (4, 8, 8, 16), (1, 1, 1, 1), (2, 100, 400, 3)})


def _walk_augment(b, h, w, c, geo):  # 4 x a store in either dtype
    """Count how often the kernel's loops write each output element, and
    check that every source row a tile reads lies in its staging area."""
    vw = 4 if geo.vector_store else 1
    written = np.zeros((b, c, h, w), np.int32)
    per_row = w // vw
    for bi in range(geo.grid[0]):
        for t in range(geo.grid[1]):
            y0 = t * geo.tile_rows
            rows = min(geo.tile_rows, h - y0)
            assert rows >= 1
            piece = np.arange(rows * per_row)
            assert np.array_equal(
                np.sort(np.concatenate([np.arange(k, rows * per_row,
                                                  geo.threads)
                                        for k in range(geo.threads)])),
                piece)
            yl = piece // per_row
            x0 = (piece - yl * per_row) * vw
            for k in range(vw):
                np.add.at(written, (bi, slice(None), y0 + yl, x0 + k), 1)
            # any offset in [-pad, pad] reads at most `rows` source rows
            stats = -(-8 * c // 16) * 16
            assert stats + rows * w * c <= geo.smem_bytes
    return written


@pytest.mark.parametrize("pointers", sorted(POINTERS))
@pytest.mark.parametrize("shape", AUGMENT_SHAPES)
def test_augment_geometry_covers_every_output_row_once(shape, pointers):
    geo = k1.augment_geometry(*shape, *POINTERS[pointers])
    assert (_walk_augment(*shape, geo) == 1).all()


@pytest.mark.parametrize("pointers", sorted(POINTERS))
@pytest.mark.parametrize("shape", AUGMENT_SHAPES)
def test_augment_geometry_paths_and_limits(shape, pointers):
    b, h, w, c = shape
    set_ptr, out_ptr = POINTERS[pointers]
    geo = k1.augment_geometry(b, h, w, c, set_ptr, out_ptr)
    assert geo.vector_load == ((w * c) % 16 == 0 and pointers != "input_off")
    assert geo.vector_store == (w % 4 == 0 and pointers != "output_off")
    assert 32 <= geo.threads <= min(k1.MAX_THREADS, MAX_BLOCK)
    assert geo.threads % 32 == 0
    assert geo.grid == (b, -(-h // geo.tile_rows))
    assert geo.grid[0] <= MAX_GRID_X and geo.grid[1] <= MAX_GRID_Y
    assert geo.smem_bytes <= k1.MAX_SMEM
    # an image whose bytes fit beside the statistics is one tile: one block
    if -(-8 * c // 16) * 16 + h * w * c <= k1.MAX_SMEM:
        assert geo.grid[1] == 1


@pytest.mark.parametrize("pointers", sorted(POINTERS_BF16))
@pytest.mark.parametrize("shape", AUGMENT_SHAPES)
def test_augment_geometry_bf16(shape, pointers):
    """The bf16 output: stores of 4 bf16 need 8-byte alignment."""
    b, h, w, c = shape
    set_ptr, out_ptr = POINTERS_BF16[pointers]
    geo = k1.augment_geometry(b, h, w, c, set_ptr, out_ptr, itemsize=2)
    assert geo.vector_store == (w % 4 == 0 and out_ptr % 8 == 0)
    assert geo.vector_load == ((w * c) % 16 == 0 and set_ptr % 16 == 0)
    assert geo.smem_bytes <= k1.MAX_SMEM
    assert (_walk_augment(*shape, geo) == 1).all()


def test_augment_geometry_at_the_training_batch():
    """B = 256 from 32x32x3: one block per image, 3,072 bytes staged with
    16-byte copies, 256 threads of float4 stores (3 per thread)."""
    geo = k1.augment_geometry(256, 32, 32, 3, *POINTERS["aligned"])
    assert geo == k1.AugmentGeometry(
        grid=(256, 1), threads=256, tile_rows=32, smem_bytes=32 + 3072,
        vector_load=True, vector_store=True)


def test_augment_geometry_refuses_rows_beyond_the_staging_area():
    with pytest.raises(ValueError):
        k1.augment_geometry(1, 2, 20000, 3, *POINTERS["aligned"])
