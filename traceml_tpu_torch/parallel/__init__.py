"""Device meshes over ``torch.distributed`` (``parallel/mesh.py``)."""
