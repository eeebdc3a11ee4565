"""The depthwise conv kernel's launch plan (ops/depthwise_conv.py::
depthwise_plan), on the CPU: the geometry the wrapper passes to
csrc/depthwise_conv.cu, which the kernel checks and then trusts.

- Every output is covered exactly once: the blocks (image x channel chunk
  x column block x band) and, inside a block, the threads' items (a quad of
  channels x a strip of columns) walking the band's rows tile each axis
  with no gap and no overlap, short last band, strip and chunk included;
  no block and no item is empty; every item has a thread.
- Each block's staged window holds every tap its outputs read.
- Shared memory stays within the H100's 227 KB a block (and within the
  plan's budget of three blocks a SM), and equals rows x columns x pitch.
- At MobileNetV2's 17 depthwise shapes at bs256 and widths 0.5, 1.0 and
  1.4, with XLA's SAME pads (0, 1) and torch's (1, 1) at stride 2, and at
  odd H and W, C = 8 and 20 and N = 1, for the 16-byte and the masked
  variant.
- A tiled emulation in PyTorch ops, which builds every block's window from
  x with the pad value outside the image and 0 past C, and computes the
  block's outputs from that window alone, is bit-equal to
  depthwise_conv_plain for every store at pad values 0 and -9, with the
  plan's bounds lowered so that small shapes cut into many bands, chunks
  and column blocks.
"""
import itertools

import numpy as np
import pytest
import torch

from quantnet_torch.core.types import ActQuant
from quantnet_torch.models.mobilenet import block_widths
from quantnet_torch.ops.conv import _same_pads
from quantnet_torch.ops.depthwise_conv import (
    QUAD,
    SMEM_BUDGET,
    SMEM_MAX,
    STRIP,
    THREADS,
    _out_size,
    depthwise_acc_plain,
    depthwise_conv_plain,
    depthwise_plan,
)
from quantnet_torch.ops.int8_matmul import Epilogue

TORCH_PADS = ((1, 1), (1, 1))


def _cdiv(a, b):
    return -(-a // b)


def _mnv2_shapes(width, batch=256, image=224):
    """MobileNetV2's depthwise convs at `width`: (input NHWC, stride)."""
    _, _, blocks = block_widths(width)
    h = _cdiv(image, 2)  # the stem, 3x3/2
    out = []
    for _, hidden, _, stride in blocks:
        out.append(((batch, h, h, hidden), stride))
        h = _cdiv(h, stride)
    return out


def _blocks(plan, n, ho, wo, c):
    """Every block as the kernel reads its index (bands fastest): (image,
    chunk, band, column block, first output row, rows, first strip, strips,
    first channel, channels)."""
    ng = _cdiv(wo, STRIP)
    for b in range(plan.grid):
        band, rest = b % plan.bands, b // plan.bands
        cb, rest = rest % plan.col_blocks, rest // plan.col_blocks
        ck, nn = rest % plan.chunks, rest // plan.chunks
        ho0, c0, strip0 = band * plan.band_rows, ck * plan.chunk, cb * plan.groups
        yield (nn, ck, band, cb, ho0, min(plan.band_rows, ho - ho0), strip0,
               min(plan.groups, ng - strip0), c0, min(plan.chunk, c - c0))


def check_plan(plan, n, ho, wo, c, stride, budget=SMEM_BUDGET, threads=THREADS):
    """The plan's invariants for an [n, ho, wo, c] output at `stride`."""
    assert plan.strip == STRIP and plan.threads % 32 == 0 and 32 <= plan.threads <= threads
    assert plan.chunk % (16 if plan.vec else QUAD) == 0 and plan.pitch % 16 == 0
    assert plan.pitch >= plan.chunk and plan.pitch - plan.chunk < 16
    assert plan.threads >= plan.chunk // QUAD * plan.groups  # every item has a thread
    assert plan.rows_in == (plan.band_rows - 1) * stride + 3
    assert plan.cols_in == (STRIP * plan.groups - 1) * stride + 3
    assert plan.smem_bytes == plan.rows_in * plan.cols_in * plan.pitch
    assert plan.smem_bytes <= min(budget, SMEM_MAX)
    assert 1 <= plan.band_rows <= ho and 1 <= plan.groups <= _cdiv(wo, STRIP)
    assert plan.grid == n * plan.chunks * plan.bands * plan.col_blocks < 2**31
    # Coverage, axis by axis: the output set is the product of the axes, so
    # each axis tiled exactly once tiles the outputs exactly once.
    rows, cols, chans, images = (np.zeros(k, np.int64) for k in (ho, wo, c, n))
    seen = set()
    for nn, ck, band, cb, ho0, n_rows, strip0, strips, c0, cc in _blocks(plan, n, ho, wo, c):
        assert n_rows >= 1 and strips >= 1 and cc >= 1
        quads = _cdiv(cc, QUAD)
        assert quads * strips <= plan.threads
        key = (ck, band, cb)
        if nn == 0:
            assert key not in seen
            seen.add(key)
        if (nn, ck, cb) == (0, 0, 0):
            rows[ho0:ho0 + n_rows] += 1
        if (nn, ck, band) == (0, 0, 0):
            for s in range(strips):
                wo0 = (strip0 + s) * STRIP
                assert wo0 < wo
                cols[wo0:wo0 + min(STRIP, wo - wo0)] += 1
                # Its taps: staged columns 4 s stride + k, k up to 5 (stride 1)
                # or 8 (stride 2), all inside the window.
                assert STRIP * s * stride + (5 if stride == 1 else 8) < plan.cols_in
        if (nn, band, cb) == (0, 0, 0):
            for q in range(quads):
                chans[c0 + QUAD * q:min(c0 + QUAD * (q + 1), c)] += 1
        if (ck, band, cb) == (0, 0, 0):
            images[nn] += 1
        # The band's last output row reads staged rows up to (rows - 1) s + 2.
        assert (n_rows - 1) * stride + 2 < plan.rows_in
    assert len(seen) == plan.chunks * plan.bands * plan.col_blocks
    for axis in (rows, cols, chans, images):
        assert (axis == 1).all()


@pytest.mark.parametrize("width", [0.5, 1.0, 1.4])
@pytest.mark.parametrize("index", range(17))
def test_mobilenet_plans(width, index):
    """Every depthwise conv of MobileNetV2 at bs256, 224x224, both variants,
    with SAME and torch pads (the pads move the window, not the plan)."""
    shape, stride = _mnv2_shapes(width)[index]
    n, h, w, c = shape
    for pads in (_same_pads(h, w, 3, 3, stride), TORCH_PADS):
        (pt, pb), (pl, pr) = pads
        ho, wo = _out_size(h, pt, pb, 3, stride), _out_size(w, pl, pr, 3, stride)
        assert (ho, wo) == (_cdiv(h, stride), _cdiv(w, stride))
        for vec in ([True, False] if c % 16 == 0 else [False]):
            check_plan(depthwise_plan(n, ho, wo, c, stride, vec), n, ho, wo, c, stride)


@pytest.mark.parametrize("n,ho,wo,c,stride,vec", [
    (1, 7, 7, 960, 1, True),       # N = 1
    (3, 13, 9, 8, 1, False),       # odd H and W, C = 8
    (2, 5, 5, 20, 2, False),       # C = 20, the masked variant
    (1, 29, 31, 48, 2, True),      # odd, stride 2
    (1, 300, 300, 16, 1, True),    # wider than a block: column blocks
    (1, 1, 1, 1, 1, False),        # one output
    (4, 2, 600, 4, 2, False),      # one quad, many column blocks, short bands
    (1, 56, 56, 4096, 1, True),    # many chunks
])
def test_edge_plans(n, ho, wo, c, stride, vec):
    check_plan(depthwise_plan(n, ho, wo, c, stride, vec), n, ho, wo, c, stride)


def test_mobilenet_plans_fit_three_blocks_a_sm():
    """At width 1.0 every plan fits three blocks a SM (228 KB, 1 KB of it
    reserved a block), gives a block at least 96 items of 16 outputs and at
    least 2 output rows, and cuts C into equal chunks that start on 32-byte
    sectors wherever C is a multiple of 32."""
    for (n, h, w, c), stride in _mnv2_shapes(1.0):
        ho, wo = _cdiv(h, stride), _cdiv(w, stride)
        plan = depthwise_plan(n, ho, wo, c, stride)
        assert 3 * (plan.smem_bytes + 1024) <= 228 * 1024
        assert plan.chunk // QUAD * plan.groups >= 96 and plan.band_rows >= 2
        assert c % plan.chunk == 0 and (c % 32 or plan.chunk % 32 == 0)


def test_plan_refuses_other_strides():
    with pytest.raises(ValueError, match="stride 1 or 2"):
        depthwise_plan(1, 8, 8, 16, 3)


def emulate(x, w, stride, pads, pad_value, plan):
    """The kernel's tiling in PyTorch ops: each block's window staged from x
    (the pad value outside the image, 0 past C), the block's outputs summed
    from the window alone over the nine taps. Returns (int32 accumulator,
    times each output was written)."""
    n, h, wd, c = x.shape
    (pt, pb), (pl, pr) = pads
    ho, wo = _out_size(h, pt, pb, 3, stride), _out_size(wd, pl, pr, 3, stride)
    acc = torch.zeros((n, ho, wo, c), dtype=torch.int32)
    count = torch.zeros((n, ho, wo, c), dtype=torch.int32)
    xi, wi = x.to(torch.int32), w.to(torch.int32)
    for nn, ck, band, cb, ho0, n_rows, strip0, strips, c0, cc in _blocks(plan, n, ho, wo, c):
        hi0, wi0 = ho0 * stride - pt, strip0 * STRIP * stride - pl
        win = torch.full((plan.rows_in, plan.cols_in, plan.pitch), int(pad_value), dtype=torch.int32)
        r = torch.arange(plan.rows_in) + hi0
        q = torch.arange(plan.cols_in) + wi0
        ch = torch.arange(plan.pitch) + c0
        rin, qin = (r >= 0) & (r < h), (q >= 0) & (q < wd)
        inside = rin[:, None] & qin[None, :]
        win[inside] = 0  # in the image, past C
        cin = ch < c
        block = xi[nn][r.clamp(0, h - 1)][:, q.clamp(0, wd - 1)][:, :, ch[cin]]
        win[:, :, : int(cin.sum())] = torch.where(inside[:, :, None], block, win[:, :, : int(cin.sum())])
        # The band's outputs over the block's strips, each from the window.
        span = STRIP * strips
        out = torch.zeros((n_rows, span, cc), dtype=torch.int32)
        for kh, kw in itertools.product(range(3), range(3)):
            tap = win[kh:kh + (n_rows - 1) * stride + 1:stride, kw:kw + (span - 1) * stride + 1:stride, :cc]
            out += tap * wi[kh, kw, 0, c0:c0 + cc]
        wo0 = strip0 * STRIP
        keep = min(span, wo - wo0)
        acc[nn, ho0:ho0 + n_rows, wo0:wo0 + keep, c0:c0 + cc] += out[:, :keep]
        count[nn, ho0:ho0 + n_rows, wo0:wo0 + keep, c0:c0 + cc] += 1
    return acc, count


def _epilogues(c, g):
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    cs = torch.rand((c,), generator=g) * 1e-3 + 1e-5
    bias = torch.randn((c,), generator=g)
    zpw = torch.randint(-3000, 3000, (c,), generator=g, dtype=torch.int32)
    return [
        None,
        Epilogue(cs=cs, bias=bias, zpw=zpw, act="relu6", out=torch.int8,
                 out_quant=ActQuant(f32(0.0517), i32(-3))),
        Epilogue(cs=cs, bias=bias, act="relu6", out=torch.bfloat16),
        Epilogue(cs=cs, zpw=zpw),
    ]


# (N, H, W, C, stride, pads, vec, lowered bounds): small shapes cut into
# many blocks.
EMULATED = [
    (2, 16, 16, 32, 1, ((1, 1), (1, 1)), True, dict(threads=32, smem_budget=4096, band_rows=3)),
    (2, 16, 16, 96, 2, ((0, 1), (0, 1)), True, dict(threads=64, smem_budget=8192, band_rows=2)),
    (1, 15, 13, 48, 2, TORCH_PADS, True, dict(threads=32, smem_budget=4096, band_rows=4)),
    (1, 9, 9, 20, 2, ((0, 1), (0, 1)), False, dict(threads=32, smem_budget=2048, band_rows=2)),
    (2, 11, 10, 8, 1, TORCH_PADS, False, dict(threads=32, smem_budget=1024, band_rows=5)),
    (1, 7, 7, 64, 1, TORCH_PADS, True, {}),
    (1, 13, 17, 16, 2, TORCH_PADS, True, dict(threads=32, smem_budget=1024)),
    (1, 4, 4, 7, 2, ((0, 1), (0, 1)), False, {}),
]


@pytest.mark.parametrize("pad_value", [0, -9])
@pytest.mark.parametrize("n,h,w,c,stride,pads,vec,bounds", EMULATED)
def test_tiled_emulation_bit_equal(n, h, w, c, stride, pads, vec, bounds, pad_value):
    g = torch.Generator().manual_seed(n + h + w + c + stride)
    x = torch.randint(-128, 128, (n, h, w, c), generator=g, dtype=torch.int8)
    wt = torch.randint(-128, 128, (3, 3, 1, c), generator=g, dtype=torch.int8)
    (pt, pb), (pl, pr) = pads
    ho, wo = _out_size(h, pt, pb, 3, stride), _out_size(w, pl, pr, 3, stride)
    plan = depthwise_plan(n, ho, wo, c, stride, vec, **bounds)
    check_plan(plan, n, ho, wo, c, stride, budget=bounds.get("smem_budget", SMEM_BUDGET),
               threads=bounds.get("threads", THREADS))
    if bounds:
        assert plan.grid > n  # the bounds cut the image into several blocks
    acc, count = emulate(x, wt, stride, pads, pad_value, plan)
    assert (count == 1).all()
    assert torch.equal(acc, depthwise_acc_plain(x, wt, stride, pads, pad_value))
    bits = {torch.int32: torch.int32, torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int8: torch.int8}
    from quantnet_torch.ops.int8_matmul import apply_epilogue

    for epi in _epilogues(c, g):
        got = acc if epi is None else apply_epilogue(acc, epi)
        ref = depthwise_conv_plain(x, wt, stride, pads, pad_value, epi)
        assert got.dtype == ref.dtype and torch.equal(got.view(bits[got.dtype]), ref.view(bits[ref.dtype]))
