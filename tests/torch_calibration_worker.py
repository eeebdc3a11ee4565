"""One rank of the two-process calibration run (tests/test_torch_calibration_merge.py).

    python tests/torch_calibration_worker.py RANK WORLD PORT OUT_DIR

Joins a gloo group on the CPU, calibrates the static convnet (8x8, seeded
weights) on this rank's slice of each global calibration batch with the
min-max and the histogram observers, merged across the ranks, bakes it, and
writes to OUT_DIR/rank<RANK>.pt: per observer the qparams, this rank's own
observers, the baked tree's ActQuant scales and zero points and its logits
on a fixed batch; and one process's min-max calibration over the union.
"""
import sys

import numpy as np
import torch

from quantnet_torch.core.types import ActQuant
from quantnet_torch.data.datasets import make_synthetic
from quantnet_torch.models import convnet
from quantnet_torch.parallel.mesh import init_distributed, make_mesh
from quantnet_torch.quantize import static
from quantnet_torch.quantize.fold import fold_model

GLOBAL_BS = 16


def main(rank: int, world: int, port: int, out: str) -> None:
    device = init_distributed(f"localhost:{port}", world, rank, device="cpu")
    mesh = make_mesh()
    assert (mesh.kind, mesh.size, mesh.rank) == ("processes", world, rank)
    params, state = convnet.init(torch.Generator().manual_seed(0), image_size=8, device=device)
    fp, fs = fold_model(params, state)
    train, _ = make_synthetic(10, 8, 64, 8, seed=3)
    local = [torch.from_numpy(x) for x, _ in train.batches(GLOBAL_BS, shuffle=True, seed=1,
                                                          drop_remainder=True, process_shard=True)]
    assert all(x.shape[0] == GLOBAL_BS // world for x in local)
    probe = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 8, 8, 3)).astype(np.float32))
    result = {}
    for observer in ("minmax", "histogram"):
        own = static.observe(convnet.apply, fp, fs, local, observer=observer)
        qp = static.calibrate(convnet.apply, fp, fs, local, observer=observer, cross_process=True)
        baked, _ = static.bake(fp, fs, qp)
        scales = [torch.stack([layer["aq"].scale.float(), layer["aq"].zero_point.float()])
                  for _, layer in sorted(baked.items()) if isinstance(layer.get("aq"), ActQuant)]
        result[observer] = {
            "qparams": qp, "observers": own, "baked_scales": torch.cat(scales),
            "logits": convnet.apply(baked, {}, probe)[0],
        }
    union = [torch.from_numpy(x) for x, _ in train.batches(GLOBAL_BS, shuffle=True, seed=1,
                                                          drop_remainder=True)]
    result["union_minmax"] = static.calibrate(convnet.apply, fp, fs, union, cross_process=False)
    torch.save(result, f"{out}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
