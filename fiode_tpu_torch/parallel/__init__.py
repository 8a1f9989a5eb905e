"""Device meshes for sharded certification and multi-process training."""
