"""Multi-process parallelism on `torch.distributed`: camera data-parallel
training, tile-stripe and depth-slab sharded rendering.

Port of `dynamic3dgaussians_tpu/parallel/`. What the reference writes as
`shard_map` over a mesh axis is per-rank code here, with explicit
collectives (`collectives.py`) on tensors on the rank's device; a process
group takes the place of the mesh axis (`mesh.py`).
"""
