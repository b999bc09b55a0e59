"""fea_tpu — a JAX 2D linear-elasticity FEA + surrogate-training framework.

Re-implements the capabilities of the reference `fea-diffusion` project
(random plate geometries -> unstructured triangle meshes -> incremental-load
FEM solves -> rasterized field images -> conditional FDN-UNet surrogate
training -> application sampling + accuracy metrics) as an idiomatic
JAX / XLA stack with a C++ constrained-Delaunay mesher.

Layers (see SURVEY.md §7):
  geometry  — seeded random plate sampler (convex hulls, unions, holes)
  mesh      — C++ CDT mesher + static-shape bucketing
  fem       — P1 plane-strain elasticity: assembly, BCs, batched PCG solves
  raster    — field/region rasterization straight into device image tensors
  datagen   — orchestrator writing the reference's on-disk dataset contract
  models    — FDN-UNet encoder/decoder/aux (+ attention variant, plain UNet)
  data      — PNG-backed and in-memory dataset pipelines
  train     — DP training over a jax.sharding.Mesh, npz checkpoints, EMA
  metrics   — accuracy vs ground-truth solves
  apps      — cantilever / gusset / shearblade / composite parity configs
"""

__version__ = "0.1.0"
