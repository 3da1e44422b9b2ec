"""Data parallelism on torch.distributed: the mesh (`mesh.make_mesh`) and
the collectives of the data-parallel step (`sharding`). Frame
parallelism and multi-host runs are not ported yet (ROADMAP Queue 1
item 8)."""

from nafae_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
