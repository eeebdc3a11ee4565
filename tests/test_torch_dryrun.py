"""The port's multi-rank dry run (quantnet_torch/entry.py::dryrun_multichip)
against the JAX package's (__graft_entry__.py:35-180, tests/test_parallel.py:
146-149): four spawned CPU ranks over gloo as a (data 2 x model 2) mesh.

  - its line carries every key of the JAX line, serves every request and
    says that the scaling harness ran correctness-only;
  - the replicated leaves after its train step are bit-identical on all
    four ranks;
  - that step (fc1 / fc2 split over the model axis, the batch over the data
    axis, augmentation on) equals the port's one-process step on the global
    batch within tests/test_torch_parallel.py's bounds.
"""
import inspect
import re

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from quantnet_torch.core.config import TrainConfig
from quantnet_torch.entry import dryrun_multichip
from quantnet_torch.models import convnet
from quantnet_torch.train import trainer as ttrainer
from test_torch_parallel import _assert_tight

N = 4


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_multichip(N, device="cpu")


def _keys(text: str):
    return re.findall(r"(\w+)=", text)


def test_line_has_the_jax_keys(dryrun):
    """The JAX line's keys, read off its print, in order; then the scaling
    field, which on a shared device (as on the JAX virtual mesh) is the
    harness's correctness-only verdict."""
    printed = inspect.getsource(graft.dryrun_multichip).split('f"dryrun_multichip ok:')[1]
    jax_keys = _keys(printed.split("{eff_str}")[0])
    assert jax_keys[0] == "mesh" and jax_keys[-1] == "occupancy" and len(jax_keys) == 9
    line = dryrun["line"]
    assert line.startswith("dryrun_multichip ok: mesh={'data': 2, 'model': 2} ")
    assert _keys(line) == jax_keys + ["scaling_harness"]
    assert "serve_reqs=200/200" in line and "correctness-only" in line
    assert dryrun["mesh"] == {"data": 2, "model": 2} and dryrun["served"] == 200
    for key in ("loss", "qat_w4_step_loss"):
        assert np.isfinite(float(re.search(rf"\b{key}=([-\d.naif]+)", line).group(1))), key


def test_replicated_leaves_bit_identical_on_every_rank(dryrun):
    assert len(dryrun["replicated_digests"]) == N and len(set(dryrun["replicated_digests"])) == 1


def test_step_matches_one_process_on_the_global_batch(dryrun):
    params, state = convnet.init(torch.Generator().manual_seed(0), device="cpu")
    opt = ttrainer.Optimizer(TrainConfig(epochs=1, batch_size=2 * N, lr=0.1), 1)
    p = ttrainer.clone_tree(params, requires_grad=True)
    leaves = ttrainer.tensor_leaves(p)
    new_state, loss, _ = ttrainer.train_step(
        convnet.apply, opt, p, state, opt.init(leaves), leaves, torch.Generator().manual_seed(1),
        torch.zeros((2 * N, 32, 32, 3)), torch.zeros((2 * N,), dtype=torch.int64))
    tree = lambda t: {k: tree(v) if isinstance(v, dict) else torch.from_numpy(v)  # noqa: E731
                      for k, v in t.items()}
    got = {"params": tree(dryrun["params"]), "state": tree(dryrun["state"]),
           "loss": torch.tensor(dryrun["loss"])}
    _assert_tight(got, ttrainer.clone_tree(p), new_state, float(loss))
