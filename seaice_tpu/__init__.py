"""seaice_tpu: a JAX sea-ice dynamical core.

A from-scratch JAX/XLA implementation of the capabilities of
MPAS-Seaice (reference: EarthWorksOrg/mpas-seaice): EVP rheology momentum
solver on the Voronoi cell/vertex dual mesh, incremental-remapping tracer
transport, and column (Icepack-style) thermodynamics, with SPMD mesh
decomposition over a jax device mesh.

Design (vs the Fortran reference):
  - Registry/pool field management  -> typed config dataclasses + State pytree
  - MPAS blocks + MPI halo exchange -> sharded SoA arrays + jax collectives
  - per-cell column physics loops   -> vmapped jit kernels
  - OpenACC GPU offload             -> whole-timestep jit compilation
"""

__version__ = "0.1.0"
