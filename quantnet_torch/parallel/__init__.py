"""Parallelism on torch.distributed: meshes, placement and collectives
(`mesh.py`), the model axis's tensor parallelism (`tensor.py`), and the
train and eval steps over a process mesh (`steps.py`)."""
