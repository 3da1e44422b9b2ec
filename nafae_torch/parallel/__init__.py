"""Data and frame parallelism on torch.distributed: the mesh
(`mesh.make_mesh`), the collectives of the data-parallel step
(`sharding`), the halo exchange and online frame softmax of frame
parallelism (`sp`), and runs across hosts (`multihost`)."""

from nafae_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
