"""The int8 GEMM kernel's fused epilogue, on the CPU: its plain version
against the JAX package's conv and linear epilogues, the kernel wrappers'
K padding, and what the wrappers refuse.

`int8_gemm_epilogue_plain` is the function the CUDA kernel must match bit for
bit on the card (tests/test_torch_cuda.py, chip_smoke.py). Here it is held
against the JAX layers that own the same epilogue (quantnet/ops/conv.py:289-309,
quantnet/ops/linear.py:218-226,255-257), jitted as the JAX package runs them
and compiled without XLA's fusion pass: XLA's CPU backend would contract
acc * scale + b into an FMA, which neither the TPU nor the kernel does
(tests/test_torch_jit_parity.py). The JAX int8 products run on the exact
`xla` backend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.core.quantize import quantize_symmetric as j_quantize_symmetric
from quantnet.core.types import ActQuant as JActQuant
from quantnet.core.types import DynamicActQuant as JDynamicActQuant
from quantnet.ops import conv as jconv
from quantnet.ops import linear as jlinear
from quantnet.quantize.common import weight_colsum as j_weight_colsum
from quantnet_torch import interop
from quantnet_torch.core.quantize import dynamic_quantize
from quantnet_torch.core.types import ActQuant, DynamicActQuant, QTensor
from quantnet_torch.ops import conv as tconv
from quantnet_torch.ops.int8_matmul import (
    K_ALIGN,
    Epilogue,
    int8_gemm,
    int8_gemm_epilogue,
    int8_gemm_epilogue_plain,
    int8_gemm_plain,
    pad_k,
)
from quantnet_torch.ops.linear import gemm_constants, int8_epilogue
from test_torch_convnet import jit_unfused

# (store, scheme): the f32 store, the dynamic bf16 handoff, the int8 handoff.
STORES = [("f32", "static"), ("int8", "static"), ("f32", "dynamic"), ("bf16", "dynamic"),
          ("int8", "dynamic")]


@pytest.fixture(autouse=True)
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


def _layer(w_shape, scheme, store, bias, seed):
    """The same layer for both packages: int8 weights, f32 bias, and the
    input domain (static: zero point -9, so zpw is non-zero)."""
    r = np.random.default_rng(seed)
    w = (r.standard_normal(w_shape) * 0.1).astype(np.float32)
    qw = j_quantize_symmetric(jnp.asarray(w), axis=len(w_shape) - 1)
    jl = {"w": qw}
    if bias:
        jl["b"] = jnp.asarray((r.standard_normal(w_shape[-1]) * 0.5).astype(np.float32))
    if scheme == "static":
        jl["aq"] = JActQuant(scale=jnp.float32(0.021), zero_point=jnp.int32(-9))
        jl["wsum"] = j_weight_colsum(qw)
    else:
        jl["aq"] = JDynamicActQuant(handoff="bfloat16" if store == "bf16" else None)
    out_q = (0.037, 5) if store == "int8" else None
    tl = interop.from_jax_qparams({"l": jax.tree.map(np.asarray, jl)}, device="cpu")["l"]
    jout = None if out_q is None else JActQuant(scale=jnp.float32(out_q[0]), zero_point=jnp.int32(out_q[1]))
    tout = None if out_q is None else ActQuant(torch.tensor(out_q[0]), torch.tensor(out_q[1], dtype=torch.int32))
    return jl, tl, jout, tout


def _input(shape, scheme, seed):
    r = np.random.default_rng(seed)
    if scheme == "static":
        return r.integers(-128, 128, shape).astype(np.int8)  # already in the layer's domain
    return (r.standard_normal(shape) * 2.0).astype(np.float32)


def _assert_same(got: torch.Tensor, ref, store):
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[store]
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("store,scheme", STORES)
def test_linear_epilogue_equals_jax(store, scheme, bias, relu):
    """int8_gemm_epilogue_plain with the epilogue the linear builds against
    the JAX linear (per-row dynamic quant on the `xla` backend; static with
    - zp * wsum), K = 200 off the 16-byte step."""
    jl, tl, jout, tout = _layer((200, 24), scheme, store, bias, seed=1)
    x = _input((9, 200), scheme, seed=2)
    act = "relu" if relu else None
    ref = jit_unfused(lambda l, xx: jlinear.linear(l, xx, activation=act, out_quant=jout), jl, jnp.asarray(x))
    tx = torch.from_numpy(x)
    if scheme == "static":
        qx, epi = tx, int8_epilogue(tl, activation=act, out_quant=tout)
        assert epi.zpw is not None and bool(epi.zpw.ne(0).any())
    else:
        qx, x_scale = dynamic_quantize(tx, axis=0)
        epi = int8_epilogue(tl, x_scale, activation=act, out_quant=tout, per_row=True)
        assert epi.zpw is None and epi.rs is not None
    a, b = pad_k(qx, tl["w"].nk())
    _assert_same(int8_gemm_epilogue_plain(a, b, epi), ref, store)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("store,scheme", STORES)
def test_conv_epilogue_equals_jax(store, scheme, bias, relu):
    """The conv (zero or zero-point pre-pad, im2col padded to K_ALIGN, the
    int8 GEMM with its epilogue, which on a CPU tensor is
    int8_gemm_epilogue_plain) against the JAX conv; K = 3*3*3 = 27."""
    jl, tl, jout, tout = _layer((3, 3, 3, 16), scheme, store, bias, seed=3)
    x = _input((2, 7, 6, 3), scheme, seed=4)
    act = "relu" if relu else None
    ref = jit_unfused(lambda l, xx: jconv.conv2d(l, xx, stride=2, activation=act, out_quant=jout),
                      jl, jnp.asarray(x))
    got = tconv.conv2d(tl, torch.from_numpy(x), stride=2, activation=act, out_quant=tout)
    _assert_same(got, ref, store)


def test_k_padding_is_exact_at_k27():
    r = np.random.default_rng(5)
    a = torch.from_numpy(r.integers(-128, 128, (33, 27)).astype(np.int8))
    b = torch.from_numpy(r.integers(-127, 128, (10, 27)).astype(np.int8))
    ap, bp = pad_k(a, b)
    assert ap.shape == (33, 32) and bp.shape == (10, 32) and K_ALIGN == 16
    assert not ap[:, 27:].any() and not bp[:, 27:].any()
    ref = int8_gemm_plain(a, b)
    assert torch.equal(int8_gemm(a, b), ref)
    epi = Epilogue(cs=torch.full((10,), 0.5), zpw=torch.arange(10, dtype=torch.int32))
    assert torch.equal(int8_gemm_epilogue(a, b, epi), (ref - epi.zpw).float() * 0.5)
    # The ops layer pads in its own copies: the weight once, where the tree is
    # built (gemm_constants), the patches in im2col.
    w = QTensor(values=torch.from_numpy(r.integers(-127, 128, (3, 3, 3, 10)).astype(np.int8)),
                scale=torch.ones(1, 1, 1, 10))
    g = gemm_constants({"w": w, "aq": DynamicActQuant()})
    assert g.b_nk.shape == (10, 32) and not g.b_nk[:, 27:].any()
    assert torch.equal(g.b_nk[:, :27], w.nk()) and g.w_nk is None  # a conv: K1 only
    # A dense layer with K aligned already: one copy serves both GEMM kernels.
    d = QTensor(values=torch.from_numpy(r.integers(-127, 128, (32, 10)).astype(np.int8)),
                scale=torch.ones(1, 10))
    g = gemm_constants({"w": d, "aq": DynamicActQuant()})
    assert g.b_nk is d.nk() and g.w_nk is d.nk()
    x = torch.from_numpy(r.integers(-128, 128, (2, 5, 5, 3)).astype(np.int8))
    patches = tconv._im2col(x, 3, 3, 1, K_ALIGN)
    assert patches.shape == (2, 3, 3, 32) and not patches[..., 27:].any()
    assert torch.equal(patches[..., :27], tconv._im2col(x, 3, 3, 1))


def test_wrappers_refuse_what_the_kernel_cannot_take():
    buf = torch.zeros(8 * 32 + 16, dtype=torch.int8)
    a = buf[:256].view(8, 32)
    b = torch.zeros((4, 32), dtype=torch.int8)
    epi = Epilogue(cs=torch.ones(4))
    for fn, args in ((int8_gemm, ()), (int8_gemm_epilogue, (epi,))):
        with pytest.raises(ValueError, match="aligned"):
            fn(buf[1:257].view(8, 32), b, *args)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros((8, 64), dtype=torch.int8)[:, ::2], b, *args)
        with pytest.raises(TypeError):
            fn(a.float(), b, *args)
        with pytest.raises(ValueError):
            fn(a, torch.zeros((4, 16), dtype=torch.int8), *args)
    with pytest.raises(ValueError, match="out_quant"):
        int8_gemm_epilogue(a, b, Epilogue(cs=torch.ones(4), out=torch.int8))
    with pytest.raises(ValueError, match="cs"):
        int8_gemm_epilogue(a, b, Epilogue(cs=torch.ones(5)))
    with pytest.raises(ValueError, match="zpw"):
        int8_gemm_epilogue(a, b, Epilogue(cs=torch.ones(4), zpw=torch.ones(4)))
    with pytest.raises(ValueError, match="stores"):
        int8_gemm_epilogue(a, b, Epilogue(cs=torch.ones(4), out=torch.float16))
