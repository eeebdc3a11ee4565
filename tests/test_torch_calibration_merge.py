"""The observers' cross-process merge and cross-process calibration
(counterpart of tests/test_calibration_merge.py and the calibration half of
tests/mp_eval_worker.py).

`merge_all` of the port is held bit for bit to the JAX package's eager
`merge_all` on the same per-process states, for all four observers: the
merged statistics, and the qparams the merged observer gives. Then one
spawned two-process gloo run (tests/torch_calibration_worker.py): each rank
calibrates the static convnet on its own slice of the calibration batches
with `cross_process=True`; both ranks must bake bit-identical trees, equal
to `merge_all` of the two ranks' observers done in this process, and the
min-max scales must equal one process's calibration over the union (exact,
as in tests/test_calibration_merge.py). Tolerance: none, everything bit for
bit (the JAX qparams jitted without XLA's fusion pass, as
tests/test_torch_observers.py runs them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import observers as jobs
from quantnet_torch.core import observers as tobs
from test_torch_convnet import jit_unfused
from torch_ranks import spawn_pair

def _fed(kind, chunks, **kw):
    o = tobs.make_observer(kind, **kw)
    for c in chunks:
        o.update(torch.from_numpy(c))
    return o


def _to_jax(o):
    """The JAX package's observer holding the port observer's statistics."""
    f32 = lambda t: jnp.asarray(t.numpy(), jnp.float32)  # noqa: E731
    if isinstance(o, tobs.MinMaxObserver):
        return jobs.MinMaxObserver(min=f32(o.min), max=f32(o.max))
    if isinstance(o, tobs.MovingAvgMinMaxObserver):
        return jobs.MovingAvgMinMaxObserver(min=f32(o.min), max=f32(o.max),
                                            initialized=jnp.array(o.initialized), momentum=o.momentum)
    fields = dict(counts=f32(o.counts), lo=f32(o.lo), hi=f32(o.hi),
                  initialized=jnp.array(o.initialized), bins=o.bins)
    if isinstance(o, tobs.MSEObserver):
        return jobs.MSEObserver(num_candidates=o.num_candidates, **fields)
    return jobs.HistogramObserver(percentile=o.percentile, **fields)


def _fields(o):
    names = {"MinMaxObserver": ("min", "max"), "MovingAvgMinMaxObserver": ("min", "max", "initialized")}
    keys = names.get(type(o).__name__, ("counts", "lo", "hi", "initialized"))
    return {k: np.asarray(getattr(o, k)) for k in keys}


def _chunks(seed, n=2048, scale=1.0, shift=0.0):
    r = np.random.default_rng(seed)
    return [(r.standard_normal((n,)) * scale + shift).astype(np.float32)]


CASES = {
    "two": lambda: [_chunks(0), _chunks(1, scale=3.0, shift=1.0)],
    "one_empty": lambda: [_chunks(2), []],
    "empty_first": lambda: [[], _chunks(3, scale=0.5)],
    "three": lambda: [_chunks(4), _chunks(5, scale=2.0, shift=-3.0), _chunks(6, shift=4.0)],
    "relu": lambda: [[np.maximum(c, 0) for c in _chunks(7)], [np.maximum(c, 0) for c in _chunks(8, scale=2.0)]],
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["minmax", "moving_average", "histogram", "mse"])
def test_merge_all_bit_equal_to_jax(kind, case):
    kw = {"bins": 512} if kind in ("histogram", "mse") else {}
    states = [_fed(kind, chunks, **kw) for chunks in CASES[case]()]
    got = type(states[0]).merge_all(states)
    want = type(_to_jax(states[0])).merge_all([_to_jax(s) for s in states])
    for k, v in _fields(want).items():
        np.testing.assert_array_equal(np.asarray(_fields(got)[k]), v, err_msg=k)
    # The merged observer's qparams, against the JAX package's jitted ones
    # (without XLA's fusion pass, which contracts the bucket grid into an
    # FMA on the CPU: ROADMAP Queue 3 item 1).
    ws, wz = jit_unfused(lambda o: o.qparams(), want)
    gs, gz = got.qparams()
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gz.numpy(), np.asarray(wz))


@pytest.mark.parametrize("kind", ["histogram", "mse"])
def test_histogram_rebin_adds_in_state_then_bin_order(kind):
    """Counts that f32 cannot add exactly (past 2^24, fractions), several
    source buckets landing in one target bucket: the order of the adds
    shows, and must be the JAX package's."""
    r = np.random.default_rng(11)
    states = []
    for i, (lo, hi) in enumerate([(-1.0, 1.0), (-8.0, 3.0), (-0.25, 30.0)]):
        o = tobs.make_observer(kind, bins=256)
        o.counts = torch.from_numpy((r.random(256) * 3e7 + r.random(256)).astype(np.float32))
        o.lo, o.hi, o.initialized = torch.tensor(lo), torch.tensor(hi), True
        states.append(o)
    got = type(states[0]).merge_all(states)
    want = type(_to_jax(states[0])).merge_all([_to_jax(s) for s in states])
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    # Summed in another order, the counts differ: the test can see the order.
    other = type(states[0]).merge_all(states[::-1])
    assert not np.array_equal(other.counts.numpy(), np.asarray(want.counts))


def test_merged_observer_lies_on_the_first_states_device():
    states = [_fed("minmax", _chunks(0)), _fed("minmax", _chunks(1))]
    assert type(states[0]).merge_all(states).min.device == states[0].min.device


def test_calibrate_single_process_unaffected_by_flag():
    """cross_process is a no-op in one process: the same qparams."""
    from quantnet_torch.models import convnet
    from quantnet_torch.quantize import static
    from quantnet_torch.quantize.fold import fold_model

    p, s = convnet.init(torch.Generator().manual_seed(0), image_size=8, device="cpu")
    fp, fs = fold_model(p, s)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8, 8, 3)).astype(np.float32))
    a = static.calibrate(convnet.apply, fp, fs, [x], cross_process=True)
    b = static.calibrate(convnet.apply, fp, fs, [x], cross_process=False)
    assert all(torch.equal(a[k][0], b[k][0]) and torch.equal(a[k][1], b[k][1]) for k in a)


# ---------------------------------------------------------------------------
# Two ranks over gloo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("calib_mp")
    logs = spawn_pair("torch_calibration_worker.py", out)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)], logs


def test_ranks_print_the_gloo_backend(ranks):
    _, logs = ranks
    assert all("backend gloo (the CPU)" in log for log in logs)


@pytest.mark.parametrize("observer", ["minmax", "histogram"])
def test_cross_process_calibration_is_bit_identical(ranks, observer):
    """Both ranks' qparams and baked trees' ActQuant scales are the same
    bits, and are merge_all of the two ranks' own observers here."""
    (r0, r1), _ = ranks
    a, b = r0[observer], r1[observer]
    assert list(a["qparams"]) == list(b["qparams"])
    for k in a["qparams"]:
        for x, y in zip(a["qparams"][k], b["qparams"][k]):
            assert torch.equal(x, y), k
    assert torch.equal(a["baked_scales"], b["baked_scales"])
    assert torch.equal(a["logits"], b["logits"])
    for k, (scale, zp) in a["qparams"].items():
        local = [a["observers"][k], b["observers"][k]]
        ms, mz = type(local[0]).merge_all(local).qparams()
        assert torch.equal(ms, scale) and torch.equal(mz, zp), k
    # Without the merge the ranks' own observers disagree: the merge did work.
    assert any(not torch.equal(a["observers"][k].qparams()[0], b["observers"][k].qparams()[0])
               for k in a["qparams"])


def test_minmax_merge_equals_union_calibration(ranks):
    """Min-max over two ranks' slices equals one process over the union."""
    (r0, _), _ = ranks
    got, want = r0["minmax"]["qparams"], r0["union_minmax"]
    for k in want:
        assert torch.equal(got[k][0], want[k][0]) and torch.equal(got[k][1], want[k][1]), k
