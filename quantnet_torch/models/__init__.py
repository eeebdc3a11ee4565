"""The port's models. Each model's `apply` takes an optional `capture` dict,
and `train` / `generator` for the train-mode forward."""
from typing import Optional

from quantnet_torch.ops.layers import batchnorm_apply, batchnorm_train


def capture_input(capture, path: str, x, spec: tuple) -> None:
    """Record a BN-folded layer's input under its path in `capture`, and its
    op spec (kind, stride, padding, activation) in capture["__specs__"] when
    the caller seeded that key: the spec lets the accuracy tools replay the
    layer outside the model (quantize/adaround.py, bias_correct.py). kind is
    "conv", "dwconv" (groups = the input's channels) or "linear"; padding is
    what the model passed to the op. Calibration seeds no specs, so its
    capture holds tensors only."""
    if capture is None:
        return
    capture[path] = x
    specs = capture.get("__specs__")
    if specs is not None:
        specs[path] = spec


def copy_dicts(tree: dict) -> dict:
    """A copy of a tree's dicts (the tensors shared): the new state a train
    forward fills in without touching the caller's."""
    return {k: copy_dicts(v) if isinstance(v, dict) else v for k, v in tree.items()}


def state_slot(new_state: Optional[dict], *path: str) -> Optional[dict]:
    """The dict a train forward writes a layer's new BN statistics into, at
    `path` in `new_state`; None outside train mode (new_state None). A block
    the state lacks gets a dict that is thrown away, as in the JAX package
    (a BN-folded ResNet's new state is {"conv1": {}})."""
    if new_state is None:
        return None
    node = new_state
    for p in path[:-1]:
        node = node.get(p, {})
    return node.setdefault(path[-1], {})


def batchnorm(bn: dict, state: dict, y, slot: Optional[dict]):
    """Inference BN, or with a `slot` train-mode BN, its new statistics
    written into the slot."""
    if slot is None:
        return batchnorm_apply(bn, state, y)
    y, new = batchnorm_train(bn, state, y)
    slot.update(new)
    return y
