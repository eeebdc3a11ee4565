"""The port's kernel modules against the Pallas kernels they replace.

On the CPU each wrapper runs its kernel's plain PyTorch version; the Pallas
originals run in interpret mode, as tests/test_pallas_kernels.py runs them.
The CUDA kernels themselves are held against the same plain versions on the
card (chip_smoke.py, tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from quantnet.core.quantize import quantize_symmetric as j_quantize_symmetric
from quantnet.ops.pallas_matmul import dynamic_int8_matmul_fused, int8_matmul_pallas
from quantnet_torch import _build
from quantnet_torch.ops.fused_dynamic_matmul import (
    block_k_for,
    fused_dynamic_gemm,
    fused_dynamic_gemm_plain,
)
from quantnet_torch.ops.int8_matmul import int8_gemm, int8_gemm_plain

# Reference test shapes (tests/test_pallas_kernels.py:25-46) and a conv-like
# im2col GEMM (conv1 of a 2x8x8x3 input: M = 128, K = 27, N = 64).
INT8_SHAPES = [(48, 200, 136), (7, 33, 5), (128, 27, 64)]
# One K-block, several K-blocks, a ragged K (two blocks, the second 88 wide).
FUSED_SHAPES = [(32, 256, 128), (64, 1024, 128), (7, 600, 10), (16, 4096, 32)]
# f32 x: the kernel's contract. The interpret-mode original and the plain
# version differ only in float order: at most 1.9e-6 absolute at |y| <= 22 on
# these shapes (and <= 3.1e-5 at |y| ~ 10 on others), well inside the bound.
FUSED_ATOL, FUSED_RTOL = 1e-4, 1e-5


def _int8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_gemm_plain_matches_pallas_exactly(m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(int8_matmul_pallas(jnp.asarray(a), jnp.asarray(b)))
    got = int8_gemm(torch.from_numpy(a), torch.from_numpy(b).t().contiguous())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_int8_gemm_plain_exact_past_float32():
    """Sums beyond 2**24 stay exact (an f32 product would round them)."""
    k = 2304
    a = torch.full((4, k), 127, dtype=torch.int8)
    b = torch.full((3, k), 127, dtype=torch.int8)
    b[0, 0] = 126
    got = int8_gemm_plain(a, b)
    assert got[0, 1].item() == 127 * 127 * k > 2**24
    assert got[0, 0].item() == 127 * 127 * k - 127


def _fused_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    qw = j_quantize_symmetric(jnp.asarray(w), axis=1)
    bias = rng.standard_normal(n).astype(np.float32)
    return x, np.array(qw.values), np.array(qw.scale).reshape(-1), bias


@pytest.mark.parametrize("m,k,n", FUSED_SHAPES)
def test_fused_dynamic_gemm_plain_matches_pallas(m, k, n):
    x, qw, ws, bias = _fused_operands(m, k, n, m + k + n)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(
            dynamic_int8_matmul_fused(
                jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws), jnp.asarray(bias)
            )
        )
    got = fused_dynamic_gemm(
        torch.from_numpy(x),
        torch.from_numpy(qw).t().contiguous(),
        torch.from_numpy(ws),
        torch.from_numpy(bias),
    )
    np.testing.assert_allclose(got.numpy(), ref, atol=FUSED_ATOL, rtol=FUSED_RTOL)


@pytest.mark.parametrize(
    "k,bk", [(27, 128), (256, 256), (512, 512), (600, 512), (1024, 512), (4096, 512)]
)
def test_block_k_rule_matches_pallas(k, bk):
    """bk = min(512, round_up(K, 128)) (pallas_matmul.py:166-174)."""
    assert block_k_for(k) == bk


def test_fused_blocks_differ_from_per_row_when_k_exceeds_block():
    """With K > 512 the per-(row, K-block) scales give another result than one
    scale per row: the block rule is observable, so it has to be kept."""
    x, qw, ws, bias = _fused_operands(8, 1024, 16, 5)
    x[:, :512] *= 50.0  # the first block's absmax dwarfs the second's
    w_nk = torch.from_numpy(qw).t().contiguous()
    tx, tws, tb = torch.from_numpy(x), torch.from_numpy(ws), torch.from_numpy(bias)
    blocked = fused_dynamic_gemm_plain(tx, w_nk, tws, tb)
    from quantnet_torch.core.quantize import dynamic_quantize

    q, s = dynamic_quantize(tx, axis=0)
    per_row = int8_gemm_plain(q, w_nk).float() * (s * tws) + tb
    assert not torch.allclose(blocked, per_row, atol=1e-3)


def test_wrappers_reject_bad_operands():
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        int8_gemm(a.float(), a)
    with pytest.raises(ValueError):
        int8_gemm(a, torch.zeros((4, 9), dtype=torch.int8))
    x = torch.zeros((4, 8))
    w = torch.zeros((3, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        fused_dynamic_gemm(x.double(), w, torch.ones(3), torch.zeros(3))
    with pytest.raises(ValueError):
        fused_dynamic_gemm(x, w, torch.ones(4), torch.zeros(3))
    with pytest.raises(ValueError):
        fused_dynamic_gemm(x, w, torch.ones(3), torch.zeros(3, dtype=torch.float64))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    int8_gemm.launches = fused_dynamic_gemm.launches = 0
    a = torch.ones((5, 16), dtype=torch.int8)
    np.testing.assert_array_equal(int8_gemm(a, a).numpy(), np.full((5, 5), 16))
    fused_dynamic_gemm(torch.ones((5, 16)), a, torch.ones(5), torch.zeros(5))
    assert int8_gemm.launches == 0 and fused_dynamic_gemm.launches == 0


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    """The library name carries a hash of the sources: editing a source gives a
    new name, so a stale build is never loaded."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._library_path("int8_gemm")
    assert before.parent == _build.BUILD_DIR and before.suffix == ".so"
    assert _build._library_path("int8_gemm") == before
    (tmp_path / "wgmma_s8.cuh").write_text("// edited\n")
    assert _build._library_path("int8_gemm") != before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_launch_error_raises():
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _build.check(1, "int8_gemm")
    _build.check(0, "int8_gemm")


def test_every_kernel_has_a_source_and_signature():
    for name, (fn, argtypes) in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {fn}(' in src
        assert "cudaGetLastError()" in src
        assert "use_fast_math" not in " ".join(_build.NVCC_FLAGS)
        assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


# fc1's depth (K = 4096, 8 K-blocks) cut to a few rows, and two smaller ones.
BF16_SHAPES = [(8, 4096, 512), (7, 600, 10), (32, 256, 128)]


@pytest.mark.parametrize("m,k,n", BF16_SHAPES)
def test_fused_dynamic_gemm_plain_matches_pallas_on_bf16(m, k, n):
    """bf16 x, as the dynamic model feeds fc1: the port rounds where XLA
    rounds in the Pallas body (quantnet_torch/ops/fused_dynamic_matmul.py),
    and agrees with the interpret-mode original to float order (measured
    1.5e-5 at |y| ~ 30 at fc1's shape, from two FMA contractions XLA makes).
    Upcasting x to f32 first, as the port once did, misses by ~1."""
    x, qw, ws, bias = _fused_operands(m, k, n, 7 * m + k)
    x[:, ::7] = np.abs(x[:, ::7]) * 3
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(
            dynamic_int8_matmul_fused(xb, jnp.asarray(qw), jnp.asarray(ws), jnp.asarray(bias))
        )
    tx = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    args = (torch.from_numpy(qw).t().contiguous(), torch.from_numpy(ws), torch.from_numpy(bias))
    got = fused_dynamic_gemm(tx, *args)
    np.testing.assert_allclose(got.numpy(), ref, atol=FUSED_ATOL, rtol=FUSED_RTOL)
    if k == 4096:
        upcast = fused_dynamic_gemm(tx.float(), *args)
        assert np.abs(upcast.numpy() - ref).max() > 100 * FUSED_ATOL
