"""Parallelism over torch.distributed: the process groups and their
placement (`distributed.py`), the mesh (`mesh.py`), the parameter and
batch layout with GatherShard (`sharding.py`, `spmd_util.py`), the
bucketed dp gradient reducer (`grad_comm.py`), ring and Ulysses
sequence parallelism (`ring_attention.py`, `ulysses.py`), and a local
launcher of rank processes (`launch.py`). Not ported yet: the pipeline
(`parallel/pipeline.py`, ROADMAP item 12's remainder)."""
