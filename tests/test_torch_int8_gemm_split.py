"""K1's launch plan (ops/int8_matmul.py::k1_plan), on the CPU: the geometry
the wrapper passes to csrc/int8_gemm.cu, which the kernel checks and then
trusts, for its packed-B mode (the s4 runtime) and its grouped-K mode
(W4A8) and, unchanged, its int8-wide normal mode.

- At the W4A8 convnet's K1 calls at bs1 and bs1024 (its convs packed, fc1
  and fc2 grouped), the W4A8 fc of ResNet-50 and MobileNetV2, and fc1 at
  every group the kernel takes: the ranks of a split cover every K row of
  every tile exactly once, a grouped split falls on group boundaries, a
  cluster has at most 8 CTAs, the shared memory (the widened slots and the
  held groups included) equals layout_bytes and stays
  within the H100's 232,448 bytes a block, and the packed launches keep at
  least the int8-wide launch's stages at the five bs1024 convs.
- The int8-wide normal mode's plan is the kernel's own plan() at the four
  models' GEMM shapes, for every store (a transcription of the C code).
- A tiled emulation in PyTorch ops of what each CTA computes (its tile,
  its K stages, zero past K) is bit-equal to int8_gemm_epilogue_plain for
  the f32 and the int8 store: the int32 partials of each CTA's K range
  summed, and in the grouped mode each rank's t_g kept apart and folded in
  rank order onto the handed sum, from 0.0.
- A planted reorder, the same t_g folded pairwise, differs from the plain
  version on inputs whose group scales make the f32 order matter: the
  kernel's check can fail.
"""
import math

import pytest
import torch

from quantnet_torch.core.types import ActQuant, pack_nibbles
from quantnet_torch.models.mobilenet import block_widths
from quantnet_torch.ops.int8_matmul import (
    BK,
    BM,
    GROUP_ALIGN,
    H100_SMEM,
    H100_SMS,
    MAX_SPLIT,
    MAX_STAGES,
    Epilogue,
    apply_epilogue,
    finish_epilogue,
    grouped_order_epilogue,
    int8_gemm_epilogue,
    int8_gemm_epilogue_plain,
    int8_gemm_plain,
    k1_plan,
    launch_plan,
    layout_bytes,
    split_ranges,
)

F32, I8 = 1, 3  # the kernel's store codes
STORES = {"f32": torch.float32, "int8": torch.int8}
# The W4A8 convnet's convs (rows of one image, K, N) and dense layers
# (K, N, store); the W4A8 fc of ResNet-50 (bs128) and MobileNetV2 (bs256).
CONVS = [(1024, 576, 64), (256, 576, 128), (256, 1152, 128), (64, 1152, 256), (64, 2304, 256)]
DENSE = [(4096, 512, I8), (512, 10, F32)]
FCS = [(128, 2048, 1000), (256, 1280, 1000)]
FC1_GROUPS = (32, 64, 128, 256)


def _cdiv(a, b):
    return -(-a // b)


def _launches():
    """(M, K, N, store, group, packed) of every launch the plan is held at."""
    out = []
    for bs in (1, 1024):
        out += [(rows * bs, k, n, I8, None, True) for rows, k, n in CONVS]
        for k, n, store in DENSE:
            out += [(bs, k, n, store, 128, packed) for packed in (False, True)]
        out += [(bs, 4096, 512, I8, g, packed) for g in FC1_GROUPS for packed in (False, True)]
    out += [(m, k, n, F32, 128, packed) for m, k, n in FCS for packed in (False, True)]
    return out


def _rank_rows(plan, m, k, group):
    """Each rank's K rows [kb, ke), as the kernel cuts them."""
    if plan.split == 1:
        return [(0, k)]
    if group is not None:
        unit = group * BK // math.gcd(group, BK)
        return [(lo * unit, hi * unit) for lo, hi in split_ranges(k // unit, plan.split)]
    ksteps = _cdiv(k, BK)
    return [(lo * BK, min(hi * BK, k)) for lo, hi in split_ranges(ksteps, plan.split)]


@pytest.mark.parametrize("launch", _launches(), ids=lambda c: "x".join(map(str, c[:3])) + (
    f"-g{c[4]}" if c[4] else "") + ("-packed" if c[5] else "") + f"-s{c[3]}")
def test_plan_covers_k_and_fits(launch):
    m, k, n, store, group, packed = launch
    p = k1_plan(m, n, k, store, group, packed)
    tiles = _cdiv(m, BM) * _cdiv(n, p.bn)
    assert 2 <= p.stages <= MAX_STAGES and 1 <= p.split <= MAX_SPLIT
    assert p.grid == (tiles * p.split if p.split > 1 else min(tiles, H100_SMS))
    ranges = _rank_rows(p, m, k, group)
    assert len(ranges) == p.split and ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # each K row exactly once
    if group is not None:
        assert p.bn == 64
        assert all(lo % group == 0 and hi % group == 0 for lo, hi in ranges)
        assert all(lo % BK == 0 for lo, _ in ranges)  # whole stages
        held = max([(hi - lo) // group for lo, hi in ranges[1:]], default=0)
        assert p.held >= held and (p.split == 1 or p.held_rows == min(BM, _cdiv(m, 16) * 16))
    else:
        assert all(lo % BK == 0 for lo, _ in ranges)
        assert not p.held and not p.held_rows
    if p.split > 1:
        assert tiles < H100_SMS and p.bn <= 128
    assert p.slots in ((2, 3, 4) if packed else (0,))
    assert p.smem == layout_bytes(p.bn, packed, group is not None, store, p.stages, p.slots, p.split,
                                  p.held, p.held_rows) <= H100_SMEM


@pytest.mark.parametrize("rows,k,n", CONVS)
def test_packed_keeps_the_int8_wide_stages(rows, k, n):
    m = rows * 1024
    wide, packed = k1_plan(m, n, k, I8), k1_plan(m, n, k, I8, packed=True)
    assert packed.bn == wide.bn and packed.split == 1
    assert packed.stages >= wide.stages
    assert wide.stages == {64: 6, 128: 5}[wide.bn] and packed.slots == 4


def _c_plan(m, n, k, store):
    """The kernel's plan() for its int8-wide normal mode, transcribed: tile
    width; stages = (smem - bytes(0)) / stage, at most 8; grid."""
    mt = _cdiv(m, BM)

    def fill(t, sms=H100_SMS):
        return t / (_cdiv(t, sms) * sms)

    if n <= 64:
        bn = 64
    elif n <= 128 or store == I8 or fill(mt * _cdiv(n, 128)) > fill(mt * _cdiv(n, 256)) + 0.15:
        bn = 128
    else:
        bn = 256
    fixed = 1024 + 2 * (2 if bn == 256 else 4) * 64 * 128 + 2 * 8 * 8
    stage = 128 * 128 + bn * 128
    stages = min(8, (H100_SMEM - fixed) // stage)
    return bn, stages, min(mt * _cdiv(n, bn), H100_SMS), fixed + stages * stage


def _model_gemms():
    """(M, K, N) of the int8-wide K1 GEMMs of the four models: the convnet
    at bs1024, ResNet-50 at bs128 and MobileNetV2 1.0 at bs256 (im2col, K
    padded to 16)."""
    out = {(rows * 1024, k, n) for rows, k, n in [(1024, 32, 64)] + CONVS}
    out |= {(1024, 4096, 512), (1024, 512, 10), (32, 4096, 512), (32, 512, 10)}
    h, cin = 56, 64
    for si, (blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for bi in range(blocks):
            ho = h // 2 if (bi == 0 and si > 0) else h
            out |= {(128 * h * h, cin, width), (128 * ho * ho, 9 * width, width),
                    (128 * ho * ho, width, 4 * width), (128 * ho * ho, cin, 4 * width)}
            h, cin = ho, 4 * width
    out.add((128, 2048, 1000))
    stem, head, blocks = block_widths(1.0)
    h, cin = 112, stem
    out.add((256 * h * h, 32, stem))
    for t, hidden, cout, stride in blocks:
        if t != 1:
            out.add((256 * h * h, _cdiv(cin, 16) * 16, hidden))
        h = _cdiv(h, stride)
        out.add((256 * h * h, _cdiv(hidden, 16) * 16, cout))
        cin = cout
    out |= {(256 * h * h, cin, head), (256, head, 1000)}
    return sorted(out)


def test_int8_wide_plan_is_the_kernels():
    for m, k, n in _model_gemms():
        for store in range(4):
            p = k1_plan(m, n, k, store)
            assert (p.bn, p.stages, p.grid, p.smem) == _c_plan(m, n, k, store), (m, k, n, store)
            assert p.split == 1 and not p.slots and not p.held


def _epilogue(g, n, store, group=None, k=None):
    cs = torch.rand((n,), generator=g) * 1e-2 + 1e-4
    bias = torch.randn((n,), generator=g)
    extra = {}
    if group is None:
        extra["zpw"] = torch.randint(-9000, 9000, (n,), generator=g, dtype=torch.int32)
    else:
        extra["group"] = group
        extra["gs"] = torch.rand((k // group, n), generator=g) * 1e-2 + 1e-4
        extra["gzpw"] = torch.randint(-30000, 30000, (k // group, n), generator=g, dtype=torch.int32)
    if store == "int8":
        oq = ActQuant(torch.tensor(0.05), torch.tensor(-7, dtype=torch.int32))
        return Epilogue(cs=cs, bias=bias, act="relu", out=torch.int8, out_quant=oq, **extra)
    return Epilogue(cs=cs, bias=bias, **extra)


def _emulate(a, b, epi, plan):
    """What the kernel computes under `plan`, tile by tile, in PyTorch ops:
    A and B zero-padded to whole stages (TMA's fill); each CTA of a tile's
    cluster its own K rows; the int32 partials summed (normal mode), or each
    group's t_g kept apart by its rank and folded in rank order onto the
    sum handed from the rank before, from 0.0 (grouped mode); then the
    epilogue on the tile."""
    m, k = a.shape
    n = b.shape[0]
    ks = _cdiv(k, BK) * BK
    a = torch.nn.functional.pad(a, (0, ks - k))
    b = torch.nn.functional.pad(b, (0, ks - k))
    out = torch.empty((m, n), dtype=epi.out)
    ranges = _rank_rows(plan, m, k, epi.group)
    for m0 in range(0, m, BM):
        for n0 in range(0, n, plan.bn):
            rows, cols = slice(m0, m0 + BM), slice(n0, n0 + plan.bn)
            at, bt = a[rows], b[cols]
            sub = Epilogue(**{f: (getattr(epi, f)[..., cols] if f in ("cs", "bias", "zpw", "gs", "gzpw")
                                  and getattr(epi, f) is not None else getattr(epi, f))
                              for f in Epilogue.__dataclass_fields__})
            if epi.group is None:
                acc = sum(int8_gemm_plain(at[:, lo:hi], bt[:, lo:hi]) for lo, hi in ranges)
                out[rows, cols] = apply_epilogue(acc, sub)
                continue
            terms = []  # per rank, its t_g in order
            for lo, hi in ranges:
                terms.append([(int8_gemm_plain(at[:, q:q + epi.group], bt[:, q:q + epi.group])
                               - sub.gzpw[q // epi.group]).float() * sub.gs[q // epi.group]
                              for q in range(lo, hi, epi.group)])
            y = torch.zeros((at.shape[0], bt.shape[0]))
            for rank in terms:  # rank 0 folds from 0; each later rank onto the handed sum
                for t in rank:
                    y = y + t
            out[rows, cols] = finish_epilogue(y * sub.cs, sub)
    return out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("store", ["f32", "int8"])
@pytest.mark.parametrize("m,k,n,split,packed", [
    (200, 576, 80, 5, True), (64, 1152, 120, 8, True), (7, 304, 24, 3, True),
    (300, 384, 150, 1, True), (130, 2304, 70, 8, True)])
def test_emulated_split_k_is_bit_equal(m, k, n, split, packed, store):
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-8, 8, (n, k), generator=g, dtype=torch.int8)
    b = pack_nibbles(w)
    epi = _epilogue(g, n, store)
    plan = k1_plan(m, n, _cdiv(k, 32) * 32, 1 if store == "f32" else I8, packed=packed, split=split)
    assert plan.split == split
    ap = torch.nn.functional.pad(a, (0, b.shape[1] * 2 - k))
    want = int8_gemm_epilogue_plain(ap, b, epi)
    assert torch.equal(_bits(_emulate(ap, w if k % 32 == 0 else torch.nn.functional.pad(
        w, (0, ap.shape[1] - k)), epi, plan)), _bits(want))
    assert torch.equal(_bits(int8_gemm_epilogue(a if k % 32 == 0 else ap, b, epi)), _bits(want))


@pytest.mark.parametrize("store", ["f32", "int8"])
@pytest.mark.parametrize("m,k,n,group,split", [
    (1, 4096, 40, 128, 8), (1, 4096, 24, 32, 8), (200, 512, 10, 128, 4), (130, 768, 72, 64, 6),
    (16, 1280, 64, 128, 4), (48, 1024, 64, 256, 4), (70, 512, 64, 128, 1)])
def test_emulated_grouped_split_is_bit_equal(m, k, n, group, split, store):
    g = torch.Generator().manual_seed(m + k + group)
    a = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-8, 8, (n, k), generator=g, dtype=torch.int8)
    epi = grouped_order_epilogue(m, k, n, group, STORES[store], torch.device("cpu"), seed=split)
    plan = k1_plan(m, n, k, 1 if store == "f32" else I8, group, split=split)
    assert plan.split == split and group % GROUP_ALIGN == 0
    want = int8_gemm_epilogue_plain(a, b, epi)
    assert torch.equal(_bits(_emulate(a, b, epi, plan)), _bits(want))
    assert torch.equal(_bits(int8_gemm_epilogue(a, pack_nibbles(b), epi)), _bits(want))


def _pairwise(a, b, epi):
    """The planted reorder: the same t_g summed pairwise, ((t0 + t1) + (t2 +
    t3)) + ..., then the epilogue."""
    ts = [(int8_gemm_plain(a[:, q:q + epi.group], b[:, q:q + epi.group]) - epi.gzpw[q // epi.group]).float()
          * epi.gs[q // epi.group] for q in range(0, a.shape[1], epi.group)]
    while len(ts) > 1:
        ts = [ts[i] + ts[i + 1] if i + 1 < len(ts) else ts[i] for i in range(0, len(ts), 2)]
    return finish_epilogue((torch.zeros_like(ts[0]) + ts[0]) * epi.cs, epi)


@pytest.mark.parametrize("m,k,n,group", [(1, 4096, 512, 128), (64, 4096, 512, 32), (128, 2048, 64, 128)])
def test_planted_pairwise_fold_differs(m, k, n, group):
    g = torch.Generator().manual_seed(k + group)
    a = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-8, 8, (n, k), generator=g, dtype=torch.int8)
    epi = grouped_order_epilogue(m, k, n, group, torch.float32, torch.device("cpu"))
    want = int8_gemm_epilogue_plain(a, b, epi)
    bad = int((_bits(_pairwise(a, b, epi)) != _bits(want)).sum())
    assert bad > want.numel() // 100, f"the pairwise fold differs at only {bad} of {want.numel()}"
    # and the ordinary scales do not hide it either: the check is live there too
    assert torch.equal(_bits(_emulate(a, b, epi, k1_plan(m, n, k, F32, group))), _bits(want))


def test_launch_plan_of_cpu_operands_is_the_h100s():
    a = torch.zeros((64, 2304), dtype=torch.int8)
    b = pack_nibbles(torch.zeros((256, 2304), dtype=torch.int8))
    epi = _epilogue(torch.Generator().manual_seed(0), 256, "int8")
    assert launch_plan(a, b, epi) == k1_plan(64, 256, 2304, I8, packed=True)
    assert launch_plan(a, b, epi).split == 4  # 18 K stages: a quarter of them a rank
