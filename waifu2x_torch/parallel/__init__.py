"""Work splitting for the port: the single-device block tiler (tiles.py) and
multi-device conversion (the counterparts of the JAX package's
parallel/): mesh.py (the mesh, sharded tensors, shard_map and the halo
exchange), sharded.py (the non-kernel stack), fast_sharded.py (one kernel
step), mesh_pipeline.py (the composed chain that Converter, StreamConverter
and the CLI run) and multihost.py (several processes on torch.distributed).
pipeline.py imports mesh_pipeline only when a mesh is asked for."""
