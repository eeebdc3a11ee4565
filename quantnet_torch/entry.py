"""Entry point (counterpart of __graft_entry__.entry): the dynamic-INT8
SimpleConvNet inference step at bs32, with its example inputs.

    fn, args = entry()
    logits = fn(*args)
"""
from __future__ import annotations

import torch

from quantnet_torch.core.config import resolve_device
from quantnet_torch.models import convnet
from quantnet_torch.quantize import dynamic


def entry(device="cuda", batch_size: int = 32):
    """Returns (fn, (qparams, qstate, images)); dynamic INT8 with a bf16
    inter-layer handoff, the same deployment as the JAX package's bench.py."""
    device = resolve_device(device)
    params, state = convnet.init(torch.Generator().manual_seed(0), device=device)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((batch_size, 32, 32, 3), generator=g).to(device)
    qparams, qstate = dynamic.quantize(params, state)

    def fn(qparams, qstate, images):
        logits, _ = convnet.apply(qparams, qstate, images)
        return logits

    return fn, (qparams, qstate, x)
