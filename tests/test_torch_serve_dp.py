"""Data-parallel serving on the CPU (counterpart of tests/test_serve.py:77-95):
the engine over a local mesh of [cpu, cpu] against the one-replica engine,
and the buckets against the JAX engine's on a mesh of the virtual CPU
devices.

The artifact is the port's static-INT8 convnet at 16x16 (int8 stem,
min-max calibration on one seeded batch: an exact int8 path whose rows are
independent of their batch-mates): every response of the two-shard engine
must be the one-replica engine's bits, on the f32 and the u8 wire.
Tolerance: none.
"""
import jax
import numpy as np
import pytest
import torch

from quantnet.models import convnet as jconvnet
from quantnet.parallel import mesh as jmesh
from quantnet.serve import InferenceEngine as JaxEngine
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.parallel.mesh import make_mesh
from quantnet_torch.quantize import static
from quantnet_torch.serve import InferenceEngine
from test_torch_serve import IMAGE, MEAN, SHAPE, STD, T, _images

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def artifact():
    """(the fp32 params as numpy, for the JAX engine's buckets; the port's
    static-INT8 convnet)."""
    p, s = tconvnet.init(torch.Generator().manual_seed(0), image_size=IMAGE, device="cpu")
    calib = torch.from_numpy(_images(4, 1))
    tq, _ = static.quantize(p, s, tconvnet.apply, [calib])
    return jax.tree.map(lambda t: t.numpy(), p), tq


def _serve(eng, imgs):
    futs = [eng.submit(img) for img in imgs]
    return np.stack([f.result(timeout=T) for f in futs])


@pytest.mark.parametrize("buckets", [(1, 8, 32, 128), (1, 3, 5), (2, 6)])
@pytest.mark.parametrize("n", [2, 4])
def test_buckets_round_as_the_jax_engine(artifact, buckets, n):
    jq, tq = artifact
    jax_eng = JaxEngine(jconvnet.apply, jq, {}, image_shape=SHAPE, buckets=buckets, precompile=False,
                        mesh=jmesh.make_mesh(n, 1))
    with jax_eng, InferenceEngine(tconvnet.apply, tq, {}, image_shape=SHAPE, buckets=buckets,
                                  precompile=False, mesh=make_mesh(devices=[CPU] * n)) as eng:
        assert eng.buckets == jax_eng.buckets
        assert all(b % n == 0 for b in eng.buckets)


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_two_shards_bit_equal_to_one_replica(artifact, wire):
    _, tq = artifact
    kw = dict(image_shape=SHAPE, buckets=(2, 8, 32), precompile=True)
    if wire == "uint8":
        kw.update(wire_dtype="uint8", normalize=(MEAN, STD))
        imgs = np.random.default_rng(4).integers(0, 256, (70, *SHAPE), dtype=np.uint8)
    else:
        imgs = _images(70, 4)
    with InferenceEngine(tconvnet.apply, tq, {}, device="cpu", **kw) as one, \
            InferenceEngine(tconvnet.apply, tq, {}, mesh=make_mesh(devices=[CPU, CPU]), **kw) as two:
        want = _serve(one, imgs)
        got = _serve(two, imgs)
        single = np.stack([two.predict(img, timeout=T) for img in imgs[:3]])
        assert two.stats["requests"] == 73 and two.occupancy() <= 1.0
        x = torch.from_numpy(imgs[:8])
        assert torch.equal(two.forward(x), one.forward(x))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(single, want[:3])


def test_the_replicas_are_copies(artifact):
    _, tq = artifact
    with InferenceEngine(tconvnet.apply, tq, {}, image_shape=SHAPE, buckets=(2,), precompile=False,
                         mesh=make_mesh(devices=[CPU, CPU])) as eng:
        (_, a, _), (_, b, _) = eng._shards
        assert a["conv1"]["w"].values.data_ptr() != b["conv1"]["w"].values.data_ptr()
        assert a["conv1"]["w"].values.data_ptr() != tq["conv1"]["w"].values.data_ptr()


def test_a_process_mesh_is_refused(artifact):
    from quantnet_torch.parallel.mesh import Mesh

    _, tq = artifact
    with pytest.raises(ValueError, match="local mesh"):
        InferenceEngine(tconvnet.apply, tq, {}, image_shape=SHAPE, precompile=False,
                        mesh=Mesh("processes", (CPU,), 2, 0))
