"""Process groups over torch.distributed: the part of the JAX package's
`parallel/` that the collective probes and the fabric health plane use
(`distributed.py`). Meshes, sharding and the multi-device training stack
are not ported yet."""
