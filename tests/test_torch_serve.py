"""The port's continuous-batching engine on the CPU: the counterparts of
tests/test_serve.py (all but the mesh case), and the engine against the JAX
package's engine on the same artifact.

The artifact is the JAX package's static-INT8 SimpleConvNet at 16x16
(int8 stem, min-max calibration on one seeded batch), carried over with
interop. Its rows are independent of their batch-mates and its int8 path is
exact, so the port's engine gives the bits of a direct forward whatever the
batching, and the bits of the JAX engine where the JAX engine runs its `xla`
int8 backends compiled without XLA's fusion pass (XLA's CPU backend would
otherwise contract multiply-adds into FMAs, which neither the TPU nor the
port does: ROADMAP Queue 3 item 1). The u8 wire's normalization is held to
the same bits: x * f32(1/255) - mean, then * f32(1/std), as jitted XLA
computes it. Every future is awaited with a timeout and every engine closed
by `with`, so a hang fails the test.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.models import convnet as jconvnet
from quantnet.quantize import fold as jfold
from quantnet.quantize import static as jstatic
from quantnet.serve import InferenceEngine as JaxEngine
from quantnet_torch import interop
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.serve import InferenceEngine

IMAGE = 16
SHAPE = (IMAGE, IMAGE, 3)
MEAN = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
STD = np.asarray([0.2470, 0.2435, 0.2616], np.float32)
T = 120  # seconds a future may take


@pytest.fixture(scope="module")
def artifact():
    params, state = jconvnet.init(jax.random.PRNGKey(0), image_size=IMAGE)
    jf, _ = jfold.fold_model_jit(params, state)
    calib = np.random.default_rng(1).standard_normal((4, *SHAPE)).astype(np.float32)
    act = jstatic.calibrate(jconvnet.apply, jf, {}, [calib])
    jq, _ = jstatic.bake(jf, {}, act)
    tq = interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu")
    return jq, tq


@pytest.fixture
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


def _engine(tq, **kw):
    kw.setdefault("precompile", False)
    return InferenceEngine(tconvnet.apply, tq, {}, image_shape=SHAPE, device="cpu", **kw)


def _direct(tq, imgs):
    return tconvnet.apply(tq, {}, torch.from_numpy(imgs))[0].numpy()


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal((n, *SHAPE)).astype(np.float32)


class _Unfused:
    """A JAX engine's jitted forward, compiled per input shape without XLA's
    fusion pass (as `jit_unfused` in test_torch_convnet.py)."""

    def __init__(self, jitted):
        self.fn = jitted.__wrapped__
        self.compiled = {}

    def __call__(self, p, s, x):
        key = (x.shape, x.dtype)
        if key not in self.compiled:
            self.compiled[key] = jax.jit(self.fn).lower(p, s, x).compile({"xla_disable_hlo_passes": "fusion"})
        return self.compiled[key](p, s, x)


def _jax_engine(jq, **kw):
    eng = JaxEngine(jconvnet.apply, jq, {}, image_shape=SHAPE, precompile=False, **kw)
    eng._fwd = _Unfused(eng._fwd)  # before any request reaches the dispatcher
    return eng


def _serve(eng, imgs):
    futs = [eng.submit(img) for img in imgs]
    return np.stack([f.result(timeout=T) for f in futs])


def test_single_request_matches_direct_forward(artifact):
    _, tq = artifact
    img = _images(1, 0)
    with _engine(tq, buckets=(1, 4)) as eng:
        got = eng.predict(img[0], timeout=T)
    np.testing.assert_array_equal(got, _direct(tq, img)[0])


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_engine_matches_jax_engine(xla, artifact, wire):
    """The same requests through both engines: the same logits, bit for bit."""
    jq, tq = artifact
    if wire == "uint8":
        imgs = np.random.default_rng(5).integers(0, 256, (6, *SHAPE)).astype(np.uint8)
        kw = {"wire_dtype": "uint8", "normalize": (MEAN, STD)}
    else:
        imgs, kw = _images(6, 5), {}
    with _engine(tq, buckets=(1, 4, 8), max_wait_ms=50, **kw) as eng:
        got = _serve(eng, imgs)
    with _jax_engine(jq, buckets=(1, 4, 8), max_wait_ms=50, **kw) as jeng:
        want = _serve(jeng, imgs)
    np.testing.assert_array_equal(got, want)


def test_uint8_wire_normalizes_as_jitted_jax(artifact):
    """The engine's on-device normalization, alone: XLA's bits."""
    _, tq = artifact
    x = np.concatenate([np.arange(256, dtype=np.uint8).repeat(3).reshape(1, IMAGE, IMAGE, 3),
                        np.random.default_rng(0).integers(0, 256, (3, *SHAPE)).astype(np.uint8)])
    m, s = jnp.asarray(MEAN), jnp.asarray(STD)
    compiled = jax.jit(lambda x: (x.astype(jnp.float32) / 255.0 - m) / s).lower(
        jnp.asarray(x)).compile({"xla_disable_hlo_passes": "fusion"})
    want = np.asarray(compiled(jnp.asarray(x)))
    seen = {}

    def apply_fn(p, s, x):
        seen["x"] = x.clone()
        return tconvnet.apply(p, s, x)

    with InferenceEngine(apply_fn, tq, {}, image_shape=SHAPE, device="cpu", buckets=(4,),
                         precompile=False, max_wait_ms=50, wire_dtype="uint8",
                         normalize=(MEAN, STD)) as eng:
        _serve(eng, x)
    np.testing.assert_array_equal(seen["x"].numpy(), want)


def test_concurrent_requests_batched(artifact):
    _, tq = artifact
    imgs = _images(12, 1)
    with _engine(tq, buckets=(1, 4, 16), max_wait_ms=50) as eng:
        got = _serve(eng, imgs)
        stats = dict(eng.stats)
    np.testing.assert_array_equal(got, _direct(tq, imgs))
    assert stats["requests"] == 12
    assert stats["batches"] < 12


def test_rejects_wrong_shape_and_dtype(artifact):
    _, tq = artifact
    with _engine(tq, buckets=(1,)) as eng:
        with pytest.raises(ValueError):
            eng.submit(np.zeros((8, 8, 3), np.float32))
        with pytest.raises(TypeError):
            eng.submit(np.zeros(SHAPE, np.uint8))
    with _engine(tq, buckets=(1,), wire_dtype="uint8", normalize=(MEAN, STD)) as eng:
        with pytest.raises(TypeError):
            eng.submit(np.zeros(SHAPE, np.float32))


def test_uint8_wire_requires_normalize(artifact):
    _, tq = artifact
    with pytest.raises(ValueError):
        _engine(tq, buckets=(1,), wire_dtype="uint8")
    with pytest.raises(ValueError):
        _engine(tq, buckets=(1,), wire_dtype="float16")


def test_occupancy_accounting(artifact):
    _, tq = artifact
    with _engine(tq, buckets=(4,), max_wait_ms=1) as eng:
        eng.predict(np.zeros(SHAPE, np.float32), timeout=T)
        assert eng.stats["padded_rows"] == 3
        assert 0.0 < eng.occupancy() <= 0.25 + 1e-6


def test_error_reaches_every_waiter_and_serving_continues(artifact):
    """A batch whose forward raises fails each of its requests; the next
    batch is served."""
    _, tq = artifact
    calls = {"n": 0}

    def flaky(p, s, x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return tconvnet.apply(p, s, x)

    imgs = _images(3, 4)
    with InferenceEngine(flaky, tq, {}, image_shape=SHAPE, device="cpu", buckets=(4,),
                         precompile=False, max_wait_ms=200) as eng:
        futs = [eng.submit(img) for img in imgs]
        for f in futs:
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=T)
        got = eng.predict(imgs[0], timeout=T)
        assert eng.stats["requests"] == 1
    np.testing.assert_array_equal(got, _direct(tq, imgs[:1])[0])


def test_eager_drain_after_slow_batch(artifact):
    """With max_wait_ms=0 every deadline has passed at once, so only the
    eager drain can form batches of several requests."""
    _, tq = artifact
    with _engine(tq, buckets=(1, 4, 64), max_wait_ms=0.0) as eng:
        _serve(eng, _images(48, 2))
        stats = dict(eng.stats)
    assert stats["requests"] == 48
    assert stats["batches"] <= 10, stats


def test_latency_stats_populated(artifact):
    _, tq = artifact
    with _engine(tq, buckets=(1, 8)) as eng:
        _serve(eng, _images(12, 1))
        stats = eng.latency_stats()
    assert stats["n"] == 12
    assert 0 < stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"]
    assert stats["mean_ms"] > 0


def test_dispatch_overlaps_completion(artifact):
    """Many queued requests coalesce instead of going one at a time."""
    _, tq = artifact
    with _engine(tq, buckets=(1, 16), max_wait_ms=0.0, precompile=True) as eng:
        _serve(eng, _images(64, 2))
        batches = eng.stats["batches"]
    assert batches < 64, f"no coalescing: {batches} batches for 64 requests"


def test_burst_slo_occupancy_and_p95(artifact):
    """Under bursts the engine keeps batch occupancy above one half and p95
    within a small multiple of one batch's time: one-at-a-time dispatch
    would take about 90 batch times."""
    _, tq = artifact
    xb = torch.from_numpy(_images(32, 3))
    tconvnet.apply(tq, {}, xb)
    t0 = time.perf_counter()
    for _ in range(3):
        tconvnet.apply(tq, {}, xb)
    t_batch = (time.perf_counter() - t0) / 3
    rng = np.random.default_rng(3)
    with _engine(tq, buckets=(1, 8, 32), max_wait_ms=1.0, precompile=True) as eng:
        futs = []
        for _ in range(3):
            futs += [eng.submit(rng.standard_normal(SHAPE).astype(np.float32)) for _ in range(32)]
            time.sleep(0.005)
        for f in futs:
            f.result(timeout=T)
        stats = eng.latency_stats()
        occ = eng.occupancy()
    assert stats["n"] == 96
    assert occ >= 0.5, f"burst occupancy collapsed: {occ:.2f}"
    bound_ms = 12 * t_batch * 1e3 + 100.0
    assert stats["p95_ms"] <= bound_ms, (stats, t_batch)


def test_cuda_engine_needs_a_card(artifact):
    """The engine defaults to the card and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card tests cover the CUDA engine")
    _, tq = artifact
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tconvnet.apply, tq, {}, image_shape=SHAPE, buckets=(1,))
