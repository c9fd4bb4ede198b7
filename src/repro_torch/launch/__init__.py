"""Drivers: the LM serving driver (``python -m repro_torch.launch.serve``),
the shard_map backend's process group (``mesh.py``), and the
multi-process launch: worker processes with leases and acks
(``distributed.py``, ``_worker.py``, ``channel.py``)."""
