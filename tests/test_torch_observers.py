"""The port's histogram and MSE observers against the JAX package's.

The same numpy batches go through both. The JAX observers run as
calibration runs them (update and qparams jitted), compiled without XLA's
fusion pass (`jit_unfused`): with fusion, XLA's CPU backend contracts the
bucket grid's `lo + (hi - lo) * frac` into an FMA, which moves a scale by an
ulp (ROADMAP Queue 3 item 1). Bounds: counts, range and qparams bit-equal
wherever the JAX counts are exact (below 2^24 in a bin of one batch).
Through `static.calibrate` the layer inputs themselves differ in the last
places (fp32 convs sum in other orders), so there the bound is the one
`test_calibrate_matches_jax` uses: zero points equal, scales within 4e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import observers as jobservers
from quantnet.models import convnet as jconvnet
from quantnet.quantize import fold as jfold
from quantnet.quantize import static as jstatic
from quantnet_torch import interop
from quantnet_torch.core import observers as tobservers
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.quantize import static as tstatic
from test_torch_convnet import jit_unfused

KINDS = ["histogram", "mse"]


def _rng(seed):
    return np.random.default_rng(seed)


CASES = {
    "several_updates": lambda: [(_rng(i).standard_normal((4, 64)) * (i + 1)).astype(np.float32)
                                for i in range(3)],
    "all_negative": lambda: [(-np.abs(_rng(10 + i).standard_normal((4, 64))) - 0.5).astype(np.float32)
                             for i in range(2)],
    "constant": lambda: [np.full((4, 64), 0.7, np.float32)],
    "relu_like": lambda: [np.maximum(_rng(20 + i).standard_normal((8, 512)), 0).astype(np.float32)
                          for i in range(3)],
    "beyond_first_range": lambda: [_rng(30).standard_normal((4, 64)).astype(np.float32),
                                   (_rng(31).standard_normal((4, 64)) * 20).astype(np.float32)],
    "large": lambda: [_rng(40 + i).standard_normal((16, 20000)).astype(np.float32) for i in range(2)],
}


def _observe(kind, batches, **kwargs):
    jo = jobservers.make_observer(kind, **kwargs)
    to = tobservers.make_observer(kind, **kwargs)
    for b in batches:
        jo = jit_unfused(lambda o, x: o.update(x), jo, jnp.asarray(b))
        to.update(torch.from_numpy(b))
    return jo, to


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_observer_matches_jax(kind, case):
    jo, to = _observe(kind, CASES[case]())
    np.testing.assert_array_equal(to.counts.numpy(), np.asarray(jo.counts))
    assert float(to.lo) == float(jo.lo) and float(to.hi) == float(jo.hi)
    js, jz = jit_unfused(lambda o: o.qparams(), jo)
    ts, tz = to.qparams()
    assert ts.dtype == torch.float32 and tz.dtype == torch.int32
    assert int(tz) == int(jz)
    assert float(ts) == float(js)


@pytest.mark.parametrize("kind,kwargs", [("histogram", {"bins": 100, "percentile": 0.99}),
                                         ("mse", {"bins": 300, "num_candidates": 10})])
def test_observer_options_match_jax(kind, kwargs):
    """Bin counts that are no power of two, another percentile and another
    number of MSE candidates."""
    jo, to = _observe(kind, CASES["several_updates"](), **kwargs)
    js, jz = jit_unfused(lambda o: o.qparams(), jo)
    ts, tz = to.qparams()
    assert int(tz) == int(jz) and float(ts) == float(js)


def test_mse_candidates_are_jax_linspace():
    for n in (2, 10, 64):
        got = tobservers._linspace_f32(1.0, 1.0 / n, n).numpy()
        want = np.asarray(jax.jit(lambda: jnp.linspace(1.0, 1.0 / n, n))())
        np.testing.assert_array_equal(got, want)


def test_counts_saturate_in_jax_only():
    """The JAX package counts a batch with a scatter-add of 1.0 into f32,
    which stops at 2^24 in one bin; the port counts exactly. Equal up to
    2^24 in a bin, apart from 2^24 + 2 on (ROADMAP Queue 3)."""
    for n, equal in ((2**24, True), (2**24 + 2, False)):
        x = np.zeros(n + 2, np.float32)
        x[-2:] = (-1.0, 1.0)
        jo = jax.jit(lambda o, x: o.update(x))(jobservers.make_observer("histogram"), jnp.asarray(x))
        to = tobservers.make_observer("histogram").update(torch.from_numpy(x))
        jc, tc = np.asarray(jo.counts), to.counts.numpy()
        assert tc.max() == float(n)
        assert np.array_equal(jc, tc) == equal
        if not equal:
            assert jc.max() == 2.0**24


@pytest.fixture(scope="module")
def folded():
    params, state = jconvnet.init(jax.random.PRNGKey(0), image_size=16)
    pn, sn = jax.tree.map(np.array, params), jax.tree.map(np.array, state)
    jf, _ = jfold.fold_model_jit(jax.tree.map(jnp.asarray, pn), jax.tree.map(jnp.asarray, sn))
    calib = [_rng(1 + i).standard_normal((4, 16, 16, 3)).astype(np.float32) for i in range(2)]
    return jf, calib


@pytest.mark.parametrize("kind", KINDS)
def test_calibrate_matches_jax(folded, kind):
    """static.calibrate with each observer over two batches, against the
    JAX package's calibrate on the same folded convnet."""
    jf, calib = folded
    act = jstatic.calibrate(jconvnet.apply, jf, {}, calib, observer=kind)
    tf = interop.from_jax_params(jax.tree.map(np.asarray, jf), {}, device="cpu")[0]
    got = tstatic.calibrate(tconvnet.apply, tf, {}, [torch.from_numpy(c) for c in calib], observer=kind)
    assert set(got) == set(act) == set(tconvnet.QUANT_LAYERS)
    for key, (js, jz) in act.items():
        ts, tz = got[key]
        assert int(tz) == int(jz), key
        np.testing.assert_allclose(float(ts), float(js), rtol=4e-6, err_msg=key)
