"""int8 GEMM with int32 accumulation (the port of int8_matmul_pallas), and the
same kernel with the layer's epilogue fused into its store.

`int8_gemm(a, b_nk)` is the TPU kernel's own function, int8[M,K] @
int8[N,K]^T -> int32[M,N]. `int8_gemm_epilogue(a, b_nk, epi)` runs the
epilogue that an int8 conv or linear applies to that accumulator (`Epilogue`)
inside the kernel and stores the layer's output type: f32, the bf16 handoff or
the int8 handoff. With `epi.group` set it runs the kernel's grouped-K mode,
W4A8's product (quantnet/ops/linear.py:228-253): one int32 product per group
of K rows, each folded into an f32 sum with its own zero-point correction and
weight scale, in group order. Both launch the hand-written CUDA kernel
(csrc/int8_gemm.cu) on a CUDA tensor and run their plain version on a CPU
tensor; there is no other route. `int8_gemm.launches` counts every launch of
the kernel, whatever it stores, `int8_gemm.grouped_launches` those of them
in the grouped-K mode and `int8_gemm.packed_launches` those in the packed-B
mode.

Packed-B mode (the s4 runtime, quantize/common.py::s4_runtime_tree): B may
be a 4-bit weight nibble-packed along K, uint8[N, K'/2] (core/types.py::
pack_nibbles: two's-complement nibbles, the even k low, K' a multiple of
PACK_ALIGN = 32 so that its rows are whole 16-byte TMA strides). The kernel
then loads half the weight bytes and widens them in shared memory; every
store is the same integers' and so bit-equal to the int8-wide launch. The
wrappers zero-pad A's K to K' (exact: zero nibbles). The grouped mode takes
K' = K (a group that is a multiple of 32). The plain version widens B with
torch ops.

Every launch carries its plan (`k1_plan`, `launch_plan`): tile width, ring
stages, grid and shared memory bytes (the int8-wide normal mode's are the
kernel's own, which it checks for equality); for the packed and grouped
modes also the number of widened B slots, a split of each
tile's K over a thread-block cluster where the tiles number fewer than the
SMs, and the groups a grouped rank holds. The kernel checks the plan and
refuses one it does not take.

B is taken as int8[N, K], K contiguous: weights are transposed once at
quantize time (`QTensor.nk`), so both operands stream along K. The kernel's
TMA loads take rows of a multiple of 16 bytes from 16-byte-aligned bases: the
wrappers zero-pad K to a multiple of `K_ALIGN` where it is not (exact for an
integer product; the ops layer hands over operands padded already) and raise
on operands that are not contiguous or not aligned.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from quantnet_torch import _build
from quantnet_torch.core.quantize import clip, quantize_affine
from quantnet_torch.core.types import PACK_ALIGN, ActQuant, unpack_nibbles

K_ALIGN = 16
# The kernel's store codes (csrc/int8_gemm.cu, enum Store) and activation
# codes (csrc/epilogue.cuh, enum Act).
_STORES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2, torch.int8: 3}
ACTS = {None: 0, "relu": 1, "relu6": 2}
# The grouped mode's group is a whole number of the kernel's k32 steps.
GROUP_ALIGN = 32


def activation(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The epilogue's activation in PyTorch ops, as the kernels compute it:
    relu, or relu6 = jnp.clip(y, 0, 6) as XLA runs it. Both give +0 for -0
    (the `+ 0.0`; XLA's max and clamp do the same) and pass NaN."""
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y) + 0.0
    if act == "relu6":
        # jnp.clip's gradient (0.5 at 0 and 6) where one is asked for.
        return clip(y, 0.0, 6.0) + 0.0
    raise ValueError(f"unknown activation {act!r}")


@dataclass(frozen=True)
class Epilogue:
    """What an int8 layer does to its int32 accumulator, in this order:
    acc - zpw (int32), float(acc) * s with s = cs, or rs[:, None] * cs, + bias,
    the activation (None, "relu" or "relu6"), then the store in `out`: f32,
    bf16, or int8 requantized into `out_quant`'s domain.

    cs:   f32[N], the activation scale times the weight scale per column (the
          activation scale alone in the grouped mode)
    bias: f32[N] or None
    zpw:  int32[N] (the static path's zero_point * colsum(w)) or None
    rs:   f32[M], a per-row activation scale (the dynamic linear), or None
    group, gs, gzpw: the grouped-K mode (W4A8), else None: K splits into
          G = K / group products; the accumulator is then the f32 sum over
          the groups, in order, of float(acc_g - gzpw[g]) * gs[g], with gs
          f32[G, N] the weight scale and gzpw int32[G, N] the zero point
          times the colsum of each group (no zpw, no rs; stores f32 or int8)
    """

    cs: torch.Tensor
    bias: Optional[torch.Tensor] = None
    zpw: Optional[torch.Tensor] = None
    rs: Optional[torch.Tensor] = None
    act: Optional[str] = None
    out: torch.dtype = torch.float32
    out_quant: Optional[ActQuant] = None
    group: Optional[int] = None
    gs: Optional[torch.Tensor] = None
    gzpw: Optional[torch.Tensor] = None

    def check(self, m: int, n: int, k: int, a: torch.Tensor) -> None:
        """Raises unless the epilogue fits an [M, K] x [K, N] product of
        operands like `a`."""
        if self.out not in (torch.float32, torch.bfloat16, torch.int8):
            raise ValueError(f"the epilogue stores f32, bf16 or int8, not {self.out}")
        if (self.out == torch.int8) != (self.out_quant is not None):
            raise ValueError("an int8 store needs out_quant, and only an int8 store takes it")
        if self.act not in ACTS:
            raise ValueError(f"unknown activation {self.act!r}")
        vectors = [("cs", self.cs, torch.float32, (n,)), ("bias", self.bias, torch.float32, (n,)),
                   ("zpw", self.zpw, torch.int32, (n,)), ("rs", self.rs, torch.float32, (m,))]
        if (self.group is None) != (self.gs is None) or (self.group is None) != (self.gzpw is None):
            raise ValueError("the grouped mode takes group, gs and gzpw together")
        if self.group is not None:
            if self.group <= 0 or k % self.group:
                raise ValueError(f"group {self.group} does not divide K = {k}")
            if self.zpw is not None or self.rs is not None or self.out == torch.bfloat16:
                raise ValueError("the grouped mode takes no zpw and no rs, and stores f32 or int8")
            g = k // self.group
            vectors += [("gs", self.gs, torch.float32, (g, n)), ("gzpw", self.gzpw, torch.int32, (g, n))]
        dev = a.get_device()
        for name, t, dtype, shape in vectors:
            if t is None:
                continue
            if t.dtype != dtype or t.shape != shape:
                raise ValueError(f"epilogue {name} must be {dtype}{list(shape)}, got {t.dtype}{tuple(t.shape)}")
            if t.get_device() != dev or not t.is_contiguous() or t.data_ptr() % 8:
                raise ValueError(f"epilogue {name} must be contiguous and 8-byte aligned on {a.device}")


# The kernel's launch geometry (csrc/int8_gemm.cu): output tiles of BM rows,
# K staged BK bytes at a time through a ring of at most MAX_STAGES stages,
# clusters of at most MAX_SPLIT CTAs; the H100's SMs and the shared memory a
# block may opt in to.
BM, BK, MAX_STAGES, MAX_SPLIT, ALIGN, OUT_BUF = 128, 128, 8, 8, 1024, 64 * 128
H100_SMS, H100_SMEM = 132, 232448
STORE_INT8 = _STORES[torch.int8]


@dataclass(frozen=True)
class Plan:
    """How one K1 launch is laid out: tile width, ring stages, grid, dynamic
    shared memory bytes; the CTAs of a cluster that split one tile's K
    (`split`); the packed-B mode's widened weight slots (`slots`); the groups
    a rank of a grouped split holds, of `held_rows` rows each."""

    bn: int
    stages: int
    grid: int
    smem: int
    split: int = 1
    slots: int = 0
    held: int = 0
    held_rows: int = 0

    def args(self) -> Tuple[int, ...]:
        """The kernel's plan arguments, in its C signature's order."""
        return (self.bn, self.stages, self.grid, self.smem, self.split, self.slots, self.held,
                self.held_rows)

    def __str__(self) -> str:
        where = f"{self.slots} widened slots" if self.slots else ""
        if self.split > 1:
            where = (f"{where}, " if where else "") + f"split {self.split} (cluster of {self.split})" + (
                f", {self.held} groups x {self.held_rows} rows held" if self.held else "")
        return (f"BN {self.bn}, {self.stages} stages, grid {self.grid}, {self.smem} B"
                + (f", {where}" if where else ", split 1"))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wave_fill(tiles: int, sms: int) -> float:
    """The share of the SMs busy over the waves of a persistent grid."""
    return tiles / (_cdiv(tiles, sms) * sms)


def out_bufs(bn: int, store: int, packed: bool, grouped: bool) -> int:
    """A consumer's TMA store staging buffers: two at BN = 256 and for the
    packed and grouped modes' int8 store, else four."""
    return 2 if bn == 256 or ((packed or grouped) and store == STORE_INT8) else 4


def layout_bytes(bn: int, packed: bool, grouped: bool, store: int, stages: int, slots: int = 0,
                 split: int = 1, held: int = 0, held_rows: int = 0) -> int:
    """The kernel's dynamic shared memory (csrc/int8_gemm.cu, make_layout):
    alignment slack; the ring (A, then B: int8 BN x 128 or packed BN x 64
    bytes a stage); the packed mode's `slots` widened B slots; a packed
    split's int32 partials; a grouped split's held t_g; both consumers'
    staging buffers; the barriers."""
    stage = BM * BK + (bn * BK // 2 if packed else bn * BK)
    wide = slots * bn * BK if packed else 0
    reduce = 2 * 64 * bn * 4 if packed and not grouped and split > 1 else 0
    held_b = held * held_rows * bn * 4 if grouped and split > 1 else 0
    staging = 2 * out_bufs(bn, store, packed, grouped) * OUT_BUF
    bars = 2 * MAX_STAGES * 8 if not packed and split == 1 else 256
    return ALIGN + stages * stage + wide + reduce + held_b + staging + bars


def split_ranges(units: int, split: int):
    """The contiguous [lo, hi) of `units` that each of `split` ranks takes,
    as the kernel cuts them."""
    return [(units * r // split, units * (r + 1) // split) for r in range(split)]


def k1_plan(m: int, n: int, k: int, store: int, group: Optional[int] = None, packed: bool = False,
            sms: int = H100_SMS, smem: int = H100_SMEM, split: Optional[int] = None,
            slots: Optional[int] = None, clusters_fit=None) -> Plan:
    """The launch plan the kernel takes (csrc/int8_gemm.cu checks it).

    The tile: the narrowest that covers N, up to 256 (A is read once). Past
    128, 128-wide tiles for the int8 store and where 256-wide ones would
    leave much of the last wave idle; the grouped mode takes 64-wide tiles.
    As many ring stages as fit, and one persistent block per SM (the
    int8-wide normal mode: exactly the kernel's own plan()).

    The packed mode widens B into the most slots, of 4, 3 and 2, that leave
    the ring the int8-wide launch's stages (else 2; 2 in a normal-mode
    split).

    A cluster of `split` CTAs per tile where the tiles number fewer than the
    SMs and a split measured faster on an H100 (PERF.md §6): the packed
    normal mode at 16 K stages or more, a quarter of them a rank; the
    grouped mode at M <= 64 (16 rows held a warp) and 8 units of
    lcm(group, BK) rows or more, two a rank. At most MAX_SPLIT, as many as fill the SMs, with at least
    two ring stages beside the groups a grouped rank holds (`held` of
    `held_rows` rows: capped by shared memory, never spilled), and
    `clusters_fit(bn, store, grouped, split, smem)` (the card's
    cudaOccupancyMaxActiveClusters) where given. `split` and `slots` force a
    choice (for measuring one against another); the kernel still checks the
    plan."""
    grouped = group is not None
    mt = _cdiv(m, BM)
    if n <= 64 or grouped:
        bn = 64
    elif n <= 128 or store == STORE_INT8 or (
            wave_fill(mt * _cdiv(n, 128), sms) > wave_fill(mt * _cdiv(n, 256), sms) + 0.15):
        bn = 128
    else:
        bn = 256
    tiles, ksteps = mt * _cdiv(n, bn), _cdiv(k, BK)

    def fit(s=1, held=0, held_rows=0, n_slots=0):
        fixed = layout_bytes(bn, packed, grouped, store, 0, n_slots, s, held, held_rows)
        stage = layout_bytes(bn, packed, grouped, store, 1, n_slots, s, held, held_rows) - fixed
        stages = min(MAX_STAGES, (smem - fixed) // stage)
        return Plan(bn, stages, tiles * s if s > 1 else min(tiles, sms),
                    fixed + stages * stage, s, n_slots, held, held_rows)

    if not (packed or grouped):
        return fit()
    n_slots = 0 if not packed else slots if slots is not None else next(
        (c for c in (4, 3) if fit(n_slots=c).stages >= k1_plan(m, n, k, store, group, sms=sms, smem=smem,
                                                               split=1).stages), 2)
    if split is not None:
        want = split
    elif tiles >= sms:
        want = 1
    elif grouped:
        want = sms // tiles if m <= 64 else 1
    else:
        want = min(sms // tiles, ksteps // 4) if ksteps >= 16 else 1
    if grouped:
        unit = group * BK // math.gcd(group, BK)
        units = k // unit if k % unit == 0 else 0
        top = min(want, MAX_SPLIT, units if split is not None else units // 2 if units >= 8 else 1)
        for s in range(top, 1, -1):
            held = max((hi - lo) * (unit // group) for lo, hi in split_ranges(units, s)[1:])
            p = fit(s, held, BM if m >= BM else _cdiv(m, 16) * 16, n_slots)
            if p.stages >= 2 and (clusters_fit is None or clusters_fit(bn, store, True, s, p.smem)):
                return p
    elif bn <= 128:
        for s in range(min(want, MAX_SPLIT, ksteps), 1, -1):
            # Two slots beside the partials' area: a rank has few stages.
            p = fit(s, n_slots=slots if slots is not None else 2)
            if p.stages >= 2 and (clusters_fit is None or clusters_fit(bn, store, False, s, p.smem)):
                return p
    if split not in (None, 1):
        raise ValueError(f"no split of {split} fits {m}x{k}x{n}")
    return fit(n_slots=n_slots)


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> Tuple[int, int]:
    """(SMs, shared memory a block may opt in to) of a CUDA device."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, getattr(props, "shared_memory_per_block_optin", H100_SMEM)


@functools.lru_cache(maxsize=None)
def _clusters_fit(index: int, packed: bool, bn: int, store: int, grouped: bool, split: int,
                  smem: int) -> bool:
    """Whether the card runs clusters of `split` CTAs of this instantiation
    with `smem` bytes each (cudaOccupancyMaxActiveClusters >= 1)."""
    fn = _build.function("int8_gemm_packed" if packed else "int8_gemm", "int8_gemm_max_clusters",
                         [ctypes.c_int] * 5)
    with torch.cuda.device(index):
        return fn(bn, store, int(grouped), split, smem) >= 1


@functools.lru_cache(maxsize=4096)
def _plan(index: int, m: int, n: int, k: int, store: int, group: Optional[int], packed: bool) -> Plan:
    if index < 0:
        return k1_plan(m, n, k, store, group, packed)
    sms, smem = _device_limits(index)
    return k1_plan(m, n, k, store, group, packed, sms, smem,
                   clusters_fit=functools.partial(_clusters_fit, index, packed))


def launch_plan(a: torch.Tensor, b_nk: torch.Tensor, epi: Optional[Epilogue] = None) -> Plan:
    """The plan of the launch that `int8_gemm(_epilogue)` makes for these
    operands (an H100's for CPU tensors)."""
    packed = is_packed(b_nk)
    k = gemm_width(b_nk) if packed else _cdiv(a.shape[1], K_ALIGN) * K_ALIGN
    return _plan(a.get_device(), a.shape[0], b_nk.shape[0], k, 0 if epi is None else _STORES[epi.out],
                 None if epi is None else epi.group, packed)


def is_packed(b_nk: torch.Tensor) -> bool:
    """Whether a B operand is nibble-packed (the s4 runtime's uint8[N, K'/2])."""
    return b_nk.dtype == torch.uint8


def gemm_width(b_nk: torch.Tensor) -> int:
    """The K that a B operand spans: its width, twice that when packed."""
    return b_nk.shape[1] * (2 if is_packed(b_nk) else 1)


def int8_gemm_plain(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """int8[M,K] @ int8[N,K]^T -> int32[M,N], exact on any device (B packed:
    widened with torch ops to A's K first).

    Every product and partial sum of int8 values is an integer below 2**53 for
    K < 2**38, so a float64 product is exact whatever its summation order
    (CUDA has no integer matmul).
    """
    if is_packed(b_nk):
        b_nk = unpack_nibbles(b_nk, a.shape[1])
    return (a.double() @ b_nk.double().t()).to(torch.int32)


def finish_epilogue(y: torch.Tensor, epi: Epilogue) -> torch.Tensor:
    """The epilogue after the scale: + bias, the activation, the store."""
    if epi.bias is not None:
        y = y + epi.bias
    y = activation(y, epi.act)
    if epi.out == torch.int8:
        return quantize_affine(y, epi.out_quant.scale, epi.out_quant.zero_point)
    return y.to(epi.out)


def apply_epilogue(acc: torch.Tensor, epi: Epilogue) -> torch.Tensor:
    """The epilogue on an int32 accumulator in PyTorch ops, as the ops layer
    ran it before the kernel took it over."""
    if epi.zpw is not None:
        acc = acc - epi.zpw
    scale = epi.cs if epi.rs is None else epi.rs[:, None] * epi.cs
    return finish_epilogue(acc.float() * scale, epi)


def grouped_accumulate(acc_of_group, k: int, epi: Epilogue) -> torch.Tensor:
    """The grouped mode's f32 accumulator from each group's int32 product
    (`acc_of_group(lo, hi)`, the product over K rows lo..hi): the sum over
    the groups in order, from 0, of float(acc_g - gzpw[g]) * gs[g], as the
    JAX package's jnp.sum(acc.astype(f32) * w_scale, axis=0) adds them."""
    y = None
    for g in range(k // epi.group):
        t = (acc_of_group(g * epi.group, (g + 1) * epi.group) - epi.gzpw[g]).float() * epi.gs[g]
        y = (torch.zeros_like(t) if y is None else y) + t
    return y


def int8_gemm_epilogue_plain(a: torch.Tensor, b_nk: torch.Tensor, epi: Epilogue) -> torch.Tensor:
    """The int8 GEMM, then `apply_epilogue`: the function the kernel must
    match bit for bit. In the grouped mode each group's product is the int8
    GEMM of its K-slice of both operands."""
    if epi.group is None:
        return apply_epilogue(int8_gemm_plain(a, b_nk), epi)
    if is_packed(b_nk):
        b_nk = unpack_nibbles(b_nk, a.shape[1])
    y = grouped_accumulate(lambda lo, hi: int8_gemm_plain(a[:, lo:hi], b_nk[:, lo:hi]),
                           a.shape[1], epi)
    return finish_epilogue(y * epi.cs, epi)


def pad_k(a: torch.Tensor, b_nk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both operands with K zero-padded to a multiple of K_ALIGN (unchanged
    where it is one already): the same product, in rows TMA can load. A
    packed B is padded already: A is padded to its K'."""
    if is_packed(b_nk):
        pad = gemm_width(b_nk) - a.shape[1]
        return (F.pad(a, (0, pad)) if pad else a), b_nk
    pad = -a.shape[1] % K_ALIGN
    if pad == 0:
        return a, b_nk
    return F.pad(a, (0, pad)), F.pad(b_nk, (0, pad))


def _operands(a: torch.Tensor, b_nk: torch.Tensor, pad: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Checks both operands and returns them K-padded for the kernel (as
    they are with `pad` False: the grouped mode's K is whole groups)."""
    packed = is_packed(b_nk)
    if a.dtype != torch.int8 or not (b_nk.dtype == torch.int8 or packed):
        raise TypeError(f"int8_gemm takes int8 operands (B may be nibble-packed uint8), got "
                        f"{a.dtype} and {b_nk.dtype}")
    width = gemm_width(b_nk) if b_nk.ndim == 2 else -1
    fits = a.shape[1] <= width < a.shape[1] + PACK_ALIGN if packed else a.shape[1] == width
    if a.ndim != 2 or b_nk.ndim != 2 or not fits or (packed and width % PACK_ALIGN):
        raise ValueError(
            f"int8_gemm takes a[M,K] and b[N,K] (packed: uint8[N,K'/2], K' = K rounded up to "
            f"{PACK_ALIGN}), got {tuple(a.shape)} and {b_nk.dtype}{tuple(b_nk.shape)}"
        )
    if not (a.is_cuda or a.is_cpu):
        raise ValueError(f"int8_gemm runs on cuda or cpu tensors, got {a.device}")
    if a.get_device() != b_nk.get_device() or a.is_cuda != b_nk.is_cuda:
        raise ValueError(f"operands on different devices: {a.device} and {b_nk.device}")
    if not (a.is_contiguous() and b_nk.is_contiguous()):
        raise ValueError("int8_gemm takes contiguous operands")
    if (a.data_ptr() | b_nk.data_ptr()) % 16:
        raise ValueError("int8_gemm takes 16-byte-aligned operands")
    return pad_k(a, b_nk) if pad else (a, b_nk)


def _launch(a: torch.Tensor, b: torch.Tensor, epi: Optional[Epilogue],
            plan: Optional[Plan] = None) -> torch.Tensor:
    """Runs the kernel, with `plan` or launch_plan's, into a new [M, N]
    tensor of the store's type. Its rows are allocated a multiple of 16
    bytes wide (TMA's row stride); where N falls short of that, the result
    is a view of the first N columns."""
    m, k = a.shape
    n = b.shape[0]
    dtype = torch.int32 if epi is None else epi.out
    per_row = 16 // dtype.itemsize
    ldc = -(-n // per_row) * per_row
    out = a.new_empty((m, ldc), dtype=dtype)
    if m == 0 or n == 0:
        return out[:, :n]
    grouped = (None, None, 0)
    if epi is None:
        store, ptrs, act, out_s, out_zp = 0, (None,) * 4, 0, 0.0, 0.0
    else:
        ptrs = tuple(None if t is None else t.data_ptr() for t in (epi.cs, epi.rs, epi.bias, epi.zpw))
        store, act = _STORES[epi.out], ACTS[epi.act]
        out_s, out_zp = epi.out_quant.host_scalars() if epi.out_quant is not None else (0.0, 0.0)
        if epi.group is not None:
            grouped = (epi.gs.data_ptr(), epi.gzpw.data_ptr(), epi.group)
    packed = is_packed(b)
    fn = _build.kernel("int8_gemm_packed" if packed else "int8_gemm")
    plan = launch_plan(a, b, epi) if plan is None else plan
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, ldc, store, *ptrs, act, out_s,
            out_zp, *grouped, *plan.args())
    dev = a.get_device()
    # The raw current device and stream: torch.cuda.current_stream() builds
    # a Stream object, several microseconds of host time on every launch.
    if dev == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    _build.check(err, "int8_gemm")
    int8_gemm.launches += 1
    if epi is not None and epi.group is not None:
        int8_gemm.grouped_launches += 1
    if packed:
        int8_gemm.packed_launches += 1
    return out if ldc == n else out[:, :n]


def int8_gemm(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """int8[M,K] @ int8[N,K]^T -> int32[M,N], exact: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    a, b_nk = _operands(a, b_nk)
    if a.device.type == "cpu":
        return int8_gemm_plain(a, b_nk)
    return _launch(a, b_nk, None)


def int8_gemm_epilogue(a: torch.Tensor, b_nk: torch.Tensor, epi: Epilogue,
                       plan: Optional[Plan] = None) -> torch.Tensor:
    """The int8 GEMM with `epi` fused into the kernel's store -> epi.out[M,N]:
    the kernel on a CUDA tensor, the plain version on a CPU tensor. The
    kernel's grouped mode takes a group that is a multiple of GROUP_ALIGN.
    `plan` replaces launch_plan's (k1_plan with a forced split or slot
    count, to measure one layout against another); the kernel checks it."""
    a, b_nk = _operands(a, b_nk, pad=epi.group is None)
    epi.check(a.shape[0], b_nk.shape[0], a.shape[1], a)
    if a.device.type == "cpu":
        return int8_gemm_epilogue_plain(a, b_nk, epi)
    if epi.group is not None and epi.group % GROUP_ALIGN:
        raise ValueError(f"the int8 GEMM kernel's grouped mode takes a group that is a multiple "
                         f"of {GROUP_ALIGN}, got group {epi.group}")
    if epi.group is not None and gemm_width(b_nk) != a.shape[1]:
        raise ValueError(f"the grouped mode takes a packed B of exactly K = {a.shape[1]}, "
                         f"got K' = {gemm_width(b_nk)}")
    return _launch(a, b_nk, epi, plan)


def requantize(y: torch.Tensor, out_quant: ActQuant) -> torch.Tensor:
    """The int8 store's requantize alone, elementwise on a CUDA f32 tensor:
    the kernel's division and rounding, to be held against quantize_affine
    (its plain version) on inputs that a GEMM seldom produces."""
    if not (y.is_cuda and y.dtype == torch.float32 and y.is_contiguous()):
        raise ValueError("requantize takes a contiguous f32 CUDA tensor")
    q = torch.empty(y.shape, dtype=torch.int8, device=y.device)
    if y.numel():
        fn = _build.function("int8_gemm", "int8_requantize", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p])
        with torch.cuda.device(y.device):
            stream = torch.cuda.current_stream(y.device).cuda_stream
            _build.check(fn(y.data_ptr(), q.data_ptr(), y.numel(), *out_quant.host_scalars(), stream),
                         "int8_requantize")
    return q


def requantize_cases(scale: float, device) -> torch.Tensor:
    """f32 inputs for holding `requantize` against quantize_affine: random
    magnitudes over 2^-120 .. 2^120 (past the fast division's range too),
    normal values, zeros, and values within 16 ulps of every half-integer
    multiple of `scale` from -130.5 to 130.5, where the rounding of
    y / scale decides the int8 result."""
    g = torch.Generator(device=device).manual_seed(7)
    n = 1 << 20
    mant = torch.rand((n,), generator=g, device=device) + 1.0
    expo = torch.randint(-120, 121, (n,), generator=g, device=device).float()
    sign = torch.randint(0, 2, (n,), generator=g, device=device).float() * 2 - 1
    near = torch.randn((n,), generator=g, device=device) * (60.0 * scale)
    halves = ((torch.arange(-130, 131, device=device, dtype=torch.float64) + 0.5) * scale).float()
    steps = torch.arange(-16, 17, device=device, dtype=torch.int32)
    ties = (halves.view(torch.int32)[:, None] + steps).view(torch.float32).reshape(-1)
    return torch.cat([sign * mant * torch.exp2(expo), near, ties, torch.zeros(64, device=device)])


def grouped_order_epilogue(m: int, k: int, n: int, group: int, out: torch.dtype, device,
                           seed: int = 0) -> Epilogue:
    """A grouped-mode epilogue on whose inputs the f32 fold's order shows:
    each group's weight scale 2^e (1 + u), e uniform in -14..14, so the t_g
    of one column span some 2^28 and a sum taken in another order rounds
    otherwise; zero-point corrections of +-30000; cs = 2^-30 brings y to
    O(1) (f32 store, or relu and the int8 store)."""
    g = torch.Generator(device=device).manual_seed(seed)
    groups = k // group
    e = torch.randint(-14, 15, (groups, n), generator=g, device=device).float()
    gs = torch.exp2(e) * (1.0 + torch.rand((groups, n), generator=g, device=device))
    gzpw = torch.randint(-30000, 30000, (groups, n), generator=g, device=device, dtype=torch.int32)
    cs = torch.full((n,), 2.0 ** -30, device=device)
    bias = torch.randn((n,), generator=g, device=device)
    if out == torch.int8:
        oq = ActQuant(torch.tensor(0.05, device=device), torch.tensor(-3, dtype=torch.int32, device=device))
        return Epilogue(cs=cs, bias=bias, act="relu", out=torch.int8, out_quant=oq, group=group, gs=gs,
                        gzpw=gzpw)
    return Epilogue(cs=cs, bias=bias, group=group, gs=gs, gzpw=gzpw)


int8_gemm.launches = 0
int8_gemm.grouped_launches = 0  # of them, the grouped-K mode's (W4A8)
int8_gemm.packed_launches = 0  # of them, the packed-B mode's (the s4 runtime)
