"""Inference artifacts (counterpart of quantnet/train/checkpoint.py:50-168).

An artifact is `<path>.npz` (the arrays) beside `<path>.json` (a manifest of
the tree and free-form metadata), in the JAX package's format, so that either
package reads what the other writes. Manifest kinds:

  dict            {"keys": sorted keys}
  array           a tensor; a bf16 one is stored as f32 with "dtype": "bfloat16"
  qtensor         "#values", "#scale" and, with has_zp, "#zp"; axis, bits,
                  group_size; a 4-bit payload packed two values to a byte
                  (+8 bias, the even flat index in the low nibble) with its
                  "shape"
  actquant        "#scale", "#zp"
  dynamic_marker  the handoff dtype name

The GEMM constants under a layer's 'gemm' are not saved: `load_artifact`
makes them again. Training checkpoints come with the training slice.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from quantnet_torch.core.config import resolve_device
from quantnet_torch.core.types import ActQuant, DynamicActQuant, QTensor
from quantnet_torch.ops.linear import with_gemm_constants


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def pack_int4(values: np.ndarray) -> np.ndarray:
    """int4 values in [-7, 7] -> uint8, two to a byte: +8 bias, the even
    flat index in the low nibble; an odd count is padded with a 0 nibble."""
    flat = values.reshape(-1).astype(np.int16) + 8
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.int16)])
    return (flat[0::2] | (flat[1::2] << 4)).astype(np.uint8)


def unpack_int4(packed: np.ndarray, shape) -> np.ndarray:
    packed = np.asarray(packed).astype(np.uint8)
    lo = (packed & 0xF).astype(np.int8) - 8
    hi = (packed >> 4).astype(np.int8) - 8
    flat = np.stack([lo, hi], axis=1).reshape(-1)
    return flat[: int(np.prod(shape))].reshape(shape)


def _flatten(tree: Any, prefix: str, arrays: dict, manifest: dict) -> None:
    if isinstance(tree, dict):
        keys = sorted(k for k in tree if k != "gemm")
        manifest[prefix] = {"kind": "dict", "keys": keys}
        for k in keys:
            _flatten(tree[k], f"{prefix}.{k}" if prefix else str(k), arrays, manifest)
    elif isinstance(tree, QTensor):
        manifest[prefix] = {"kind": "qtensor", "axis": tree.axis,
                            "has_zp": tree.zero_point is not None,
                            "bits": tree.bits, "group_size": tree.group_size}
        values = _numpy(tree.values)
        if tree.bits == 4:
            manifest[prefix]["shape"] = list(values.shape)
            values = pack_int4(values)
        arrays[f"{prefix}#values"] = values
        arrays[f"{prefix}#scale"] = _numpy(tree.scale)
        if tree.zero_point is not None:
            arrays[f"{prefix}#zp"] = _numpy(tree.zero_point)
    elif isinstance(tree, ActQuant):
        manifest[prefix] = {"kind": "actquant"}
        arrays[f"{prefix}#scale"] = _numpy(tree.scale)
        arrays[f"{prefix}#zp"] = _numpy(tree.zero_point)
    elif isinstance(tree, DynamicActQuant):
        manifest[prefix] = {"kind": "dynamic_marker", "handoff": tree.handoff}
    elif isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            # npz has no bfloat16: stored as f32 (exact), narrowed on load.
            manifest[prefix] = {"kind": "array", "dtype": "bfloat16"}
            arrays[prefix] = _numpy(tree.float())
        else:
            manifest[prefix] = {"kind": "array"}
            arrays[prefix] = _numpy(tree)
    else:
        raise TypeError(f"cannot save a {type(tree).__name__} leaf at {prefix!r}")


def _unflatten(prefix: str, arrays: dict, manifest: dict, device) -> Any:
    node = manifest[prefix]
    kind = node["kind"]

    def tensor(key):
        return torch.from_numpy(np.array(arrays[key], copy=True)).to(device)

    if kind == "dict":
        return {
            k: _unflatten(f"{prefix}.{k}" if prefix else str(k), arrays, manifest, device)
            for k in node["keys"]
        }
    if kind == "qtensor":
        bits = node.get("bits", 8)
        values = arrays[f"{prefix}#values"]
        if bits == 4:
            values = unpack_int4(values, tuple(node["shape"]))
        return QTensor(
            values=torch.from_numpy(np.array(values, copy=True)).to(device),
            scale=tensor(f"{prefix}#scale"),
            zero_point=tensor(f"{prefix}#zp") if node["has_zp"] else None,
            axis=node["axis"],
            bits=bits,
            group_size=node.get("group_size"),
        )
    if kind == "actquant":
        return ActQuant(scale=tensor(f"{prefix}#scale"), zero_point=tensor(f"{prefix}#zp"))
    if kind == "dynamic_marker":
        return DynamicActQuant(handoff=node.get("handoff"))
    if kind == "array":
        a = tensor(prefix)
        return a.to(torch.bfloat16) if node.get("dtype") == "bfloat16" else a
    raise ValueError(f"unknown leaf kind {kind!r}")


def save_artifact(path: str, tree: dict, metadata: Optional[dict] = None) -> None:
    """Write an inference tree (dicts of tensors, QTensor, ActQuant and
    DynamicActQuant leaves) to `<path>.npz` and `<path>.json`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays: dict = {}
    manifest: dict = {}
    _flatten(tree, "", arrays, manifest)
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"manifest": manifest, "metadata": metadata or {}}, f)


def load_artifact(path: str, *, device="cuda") -> Tuple[dict, dict]:
    """Read `<path>.npz` / `<path>.json` onto `device`. Returns (tree,
    metadata), every quantized layer's GEMM constants made once here."""
    device = resolve_device(device)
    with open(path + ".json") as f:
        blob = json.load(f)
    with np.load(path + ".npz") as npz:
        arrays = dict(npz)
    tree = _unflatten("", arrays, blob["manifest"], device)
    return with_gemm_constants(tree), blob["metadata"]
