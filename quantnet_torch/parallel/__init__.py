"""Data parallelism on torch.distributed: meshes, placement and collectives
(`mesh.py`), and the data-parallel train and eval steps (`steps.py`)."""
