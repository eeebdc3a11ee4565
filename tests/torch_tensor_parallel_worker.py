"""One rank of the 1x2 tensor-parallel run (tests/test_torch_tensor_parallel.py).

    python tests/torch_tensor_parallel_worker.py RANK WORLD PORT OUT_DIR

Joins a gloo group on the CPU as one rank of a (data 1 x model 2) mesh,
reads OUT_DIR/inputs.pt (the port's trees, made by the parent from the JAX
package's, the images and the train batch) and writes to OUT_DIR/rank<RANK>.pt:

  - logits: each scheme's forward on the mesh (fc1 split by columns, fc2 by
    rows), and the per-row dynamic route (Flags(dynamic_linear="unfused"));
  - fc1: each scheme's fc1 column shard on the same input (its columns);
  - fake_quant: fc2's row shard fake-quantized with the absmax over the
    whole K (per channel, per tensor, and 4-bit groups), and the error of a
    group that the shard's rows split;
  - qat: the QAT trees' forwards (8-bit per channel, W4 g128);
  - step, step_clip: one train step of the fp32 convnet with augmentation
    and dropout (and again with the gradients' global norm clipped): the
    gathered params and state, the loss, and this rank's replicated leaves.
"""
import sys

import torch

from quantnet_torch.core.config import Flags, TrainConfig
from quantnet_torch.core.quantize import fake_quant_weight_ste
from quantnet_torch.models import convnet
from quantnet_torch.ops.linear import linear
from quantnet_torch.parallel import mesh as meshlib
from quantnet_torch.parallel import steps
from quantnet_torch.parallel import tensor
from quantnet_torch.quantize import qat
from quantnet_torch.train import trainer as ttrainer

STEP_SEED = 7
STEP_CFG = dict(epochs=1, batch_size=16, lr=0.05)
CLIP_CFG = dict(STEP_CFG, grad_clip_norm=0.5)
QAT = {"qat8": {}, "qat_w4": {"weight_bits": 4, "weight_group_size": 128}}


def forward(tree, state, x, flags=Flags()):
    return convnet.apply(tree, state, x, flags=flags)[0]


def one_step(mesh, params, state, images, labels, cfg):
    p = tensor.shard_params(mesh, params, model_parallel=True)
    s = tensor.shard_params(mesh, state, model_parallel=True)
    p = ttrainer.clone_tree(p, requires_grad=True)
    leaves = ttrainer.tensor_leaves(p)
    opt = ttrainer.Optimizer(TrainConfig(**cfg), 10)
    gen = torch.Generator().manual_seed(STEP_SEED)
    new_state, loss, _ = steps.train_step(mesh, convnet.apply, opt, p, s, opt.init(leaves), leaves,
                                          gen, images, labels, augment=True, rotation_deg=15.0,
                                          color_jitter=0.2)
    split = tensor.sharded_leaves(p, True)
    return {"params": ttrainer.clone_tree(tensor.gather_params(mesh, p)),
            "state": tensor.gather_params(mesh, new_state), "loss": loss.detach(),
            "replicated": [t.detach().clone() for t, sp in zip(leaves, split) if not sp]}


def main(rank: int, world: int, port: int, out: str) -> None:
    meshlib.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    mesh = meshlib.make_mesh(1, 2)
    inp = torch.load(f"{out}/inputs.pt", weights_only=False)
    x = inp["x"]
    result = {"mesh": (mesh.shape, mesh.rank, mesh.model_rank), "logits": {}, "fc1": {}}
    for name, (tree, state) in inp["trees"].items():
        sharded = tensor.shard_params(mesh, tree, model_parallel=True)
        st = tensor.shard_params(mesh, state, model_parallel=True)
        result["logits"][name] = forward(sharded, st, x)
        if name == "dynamic":
            result["logits"]["dynamic_per_row"] = forward(sharded, st, x, Flags(dynamic_linear="unfused"))
        fc1 = {k: v for k, v in sharded["fc1"].items() if k != "bn"}
        result["fc1"][name] = linear(fc1, inp["fc1_input"])
        if name == "w4a8":
            result["tp_kinds"] = {k: sharded[k]["tp"].kind for k in ("fc1", "fc2")}

    fp, fs = inp["trees"]["fp32"]
    fc2 = tensor.shard_params(mesh, fp, model_parallel=True)["fc2"]
    shard, w = fc2["tp"], fc2["w"]
    result["fake_quant"] = {
        "per_channel": fake_quant_weight_ste(w, True, 8, k=shard.k, reduce_max=shard.max),
        "per_tensor": fake_quant_weight_ste(w, False, 8, k=shard.k, reduce_max=shard.max),
        "grouped": fake_quant_weight_ste(w, True, 4, 128, k=shard.k, reduce_max=shard.max),
    }
    try:
        fake_quant_weight_ste(w, True, 4, shard.k, k=shard.k, reduce_max=shard.max)
    except ValueError as e:
        result["fake_quant"]["split_group"] = str(e)

    result["qat"] = {}
    for name, kw in QAT.items():
        qp, qs = qat.prepare(fp, fs, convnet.apply, [inp["calib"]], skip_first_layer=True, **kw)
        result["qat"][name] = forward(tensor.shard_params(mesh, qp, model_parallel=True),
                                      tensor.shard_params(mesh, qs, model_parallel=True), x)

    images, labels = inp["batch"]
    result["step"] = one_step(mesh, fp, fs, images, labels, STEP_CFG)
    result["step_clip"] = one_step(mesh, fp, fs, images, labels, CLIP_CFG)
    torch.save(result, f"{out}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
