"""Sharded rendering over torch.distributed ranks (mesh.py) and the local
rank launcher (worker.py)."""
