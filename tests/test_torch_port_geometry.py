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
    is the one that fixes its order. The block's threads are walked
    together, as arrays indexed by thread."""
    vw = 16 // geo.itemsize if geo.vector else 1
    written = np.zeros(n * c * hw, np.int32)
    staged = np.zeros(c * hw, np.int32)
    coefficients = np.zeros(c, np.int32)
    # row_split groups of span threads; group g on rows g, g + split, ...
    split = geo.row_split
    span_threads = geo.threads // split
    assert split == 1 or span_threads >= geo.tile_c * hw // vw
    t = np.arange(geo.threads)
    group_of, first_p = t // span_threads, t % span_threads
    # the GAP: G lanes a channel, groups of channels a pass, stages of
    # gap_len positions; lane g reads positions g, g + G, ... of each
    assert geo.gap_len == min(hw, k2.MAX_GAP)
    group = 1
    while group < 32 and k2.STAGE * group < geo.gap_len:
        group *= 2
    for cy in range(geo.grid[1]):
        c0 = cy * geo.tile_c
        tc = min(geo.tile_c, c - c0)
        assert tc >= 1
        positions = tc * hw // vw
        assert positions * vw == tc * hw
        # thread t's positions: first_p, first_p + span_threads, ... (-1:
        # none), for the threads of groups below split
        rounds = np.arange(-(-positions // span_threads))
        owned = first_p[:, None] + span_threads * rounds[None, :]
        owned[(owned >= positions) | (group_of[:, None] >= split)] = -1
        carries = (owned >= 0).any(axis=1)
        # a full tile puts every thread on y, but for the rounding of a
        # warp: one thread per position, or per STAGE passport floats with
        # the rows split between the groups
        if tc == geo.tile_c:
            assert (~carries).sum() < 32
            if positions >= geo.threads:
                assert carries.all()
        # a thread's channel is fixed: a vector never straddles two
        p = owned[owned >= 0]
        assert np.array_equal(p * vw // hw, (p * vw + vw - 1) // hw)
        for g in range(split):
            p = owned[group_of == g]
            p = p[p >= 0]
            span = (p[:, None] * vw + np.arange(vw)[None, :]).ravel()
            rows = np.concatenate([
                np.arange(rx * geo.tile_rows + g,
                          min(n, (rx + 1) * geo.tile_rows), split)
                for rx in range(geo.grid[0])])
            np.add.at(written, (rows[:, None] * c * hw + c0 * hw
                                + span[None, :]).ravel(), 1)
        assert (geo.grid[0] - 1) * geo.tile_rows < n
        coefficients[c0:c0 + tc] += 1  # by the blocks of row range 0
        assert tc == 1 or geo.gap_len == hw
        for first in range(0, tc, geo.threads // group):
            ch = first + t // group
            for off in range(0, hw, geo.gap_len):
                length = min(geo.gap_len, hw - off)
                j = (t % group)[:, None] + group * np.arange(
                    -(-length // group))[None, :]
                read = (j < length) & (ch < tc)[:, None]
                np.add.at(staged, ((c0 + ch)[:, None] * hw + off + j)[read],
                          1)
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


# AlexNet's passport blocks: features_4 (384 channels) and _5/_6 (256) at
# 8x8 (CIFAR, batch 256) and 13x13 (ImageNet, batch 64)
ALEXNET_EPILOGUE = {
    # 8-channel tiles (2 KB of f32 a row), one float4 a thread, 24 or 16
    # rows a block for about 512 blocks; bf16: the 128 threads the GAP
    # wants (4 passport floats each) in two groups over 64 positions
    (256, 384, 8, 8): dict(grid=(11, 48), threads=128, tile_c=8,
                           tile_rows=24, gap_len=64, smem_bytes=128,
                           vector=True),
    (256, 256, 8, 8): dict(grid=(16, 32), threads=128, tile_c=8,
                           tile_rows=16, gap_len=64, smem_bytes=128,
                           vector=True),
    # H*W = 169 is a multiple of neither 4 nor 8: the scalar path, 3
    # channels (507 positions) a tile and a thread each, the GAP's 32 lanes
    # a channel adding 5-6 positions each; 256 channels leave a last tile
    # of one channel
    (64, 384, 13, 13): dict(grid=(4, 128), threads=512, tile_c=3,
                            tile_rows=16, gap_len=169, smem_bytes=48,
                            vector=False),
    (64, 256, 13, 13): dict(grid=(6, 86), threads=512, tile_c=3,
                            tile_rows=11, gap_len=169, smem_bytes=48,
                            vector=False),
}


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", sorted(ALEXNET_EPILOGUE))
def test_epilogue_geometry_at_the_alexnet_shapes(shape, itemsize):
    n, c, h, w = shape
    geo = k2.epilogue_geometry(n, c, h * w, *POINTERS["aligned"],
                               itemsize=itemsize)
    want = ALEXNET_EPILOGUE[shape]
    row_split = 2 if itemsize == 2 and want["vector"] else 1
    assert geo == k2.EpilogueGeometry(**want, itemsize=itemsize,
                                      row_split=row_split)
    if h * w == 169:  # the last tile of 256 channels is one channel
        assert c % geo.tile_c == (1 if c == 256 else 0)
    written, staged, coefficients = _walk_epilogue(n, c, h * w, geo)
    assert (written == 1).all() and (staged == 1).all()
    assert (coefficients == 1).all()


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
    t = np.arange(geo.threads)
    for cy in range(geo.grid[1]):
        c0 = cy * geo.tile_c
        tc = min(geo.tile_c, c - c0)
        positions = tc * hw // vw
        assert positions * vw == tc * hw
        assert geo.tile_c == 1 or positions <= geo.threads
        # thread t's positions t, t + threads, ... and their channels
        p = t[:, None] + geo.threads * np.arange(
            -(-positions // geo.threads))[None, :]
        chans = np.where(p < positions, p * vw // hw, -1)
        owner = chans.max(axis=1)  # the channel a thread sums, or -1
        held = chans >= 0
        assert (np.where(held, chans, owner[:, None]) == owner[:, None]).all()
        # channel ch's sums are read from threads [ch * per, (ch + 1) *
        # per): those are its owners, and no other channel's
        assert sorted(set(owner[owner >= 0])) == list(range(tc))
        assert (t[owner >= 0] // per == owner[owner >= 0]).all()
        if 32 % per == 0:  # the shuffle path: one warp's lanes
            ch = np.arange(tc)
            assert (ch * per // 32 == ((ch + 1) * per - 1) // 32).all()
        q = np.arange(positions)
        span = (q[:, None] * vw + np.arange(vw)[None, :]).ravel()
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


@pytest.mark.parametrize("shape,want", [
    # AlexNet's features_4 and _5/_6 at the attack CLIs' batch: 8-channel
    # tiles, one float4 a thread, 6 and 4 rows a block; the forge attack's
    # batch 1
    ((64, 384, 8, 8), dict(grid=(11, 48), tile_rows=6)),
    ((64, 256, 8, 8), dict(grid=(16, 32), tile_rows=4)),
    ((1, 384, 8, 8), dict(grid=(1, 48), tile_rows=1)),
])
def test_backward_geometry_at_the_alexnet_shapes(shape, want):
    n, c, h, w = shape
    geo = k2.backward_geometry(n, c, h * w, *POINTERS["aligned"])
    assert geo == k2.BackwardGeometry(threads=128, tile_c=8, vector=True,
                                      **want)


def test_backward_geometry_at_the_main_shape():
    """(256, 512, 4, 4): 8 rows a block, 32 x 16 = 512 blocks."""
    geo = k2.backward_geometry(256, 512, 16, *POINTERS["aligned"])
    assert geo == k2.BackwardGeometry(grid=(32, 16), threads=128, tile_c=32,
                                      tile_rows=8, vector=True)


# ------------------------------------------------------------------ K1

AUGMENT_SHAPES = sorted({(b, s[1], s[2], s[3])
                         for _, s, b, *_ in SMOKE.AUGMENT_SHAPES} | {
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
