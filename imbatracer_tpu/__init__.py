"""imbatracer-tpu: a JAX wavefront global-illumination renderer.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
imbatracer reference renderer (interactive GI: PT / LT / BPT / PPM / VCM).

Design stance (vs. the reference's host-shading wavefront architecture,
see the reference's src/imbatracer/render/scheduling/ray_queue.h):
everything stays on-device in a single jitted megastep -- camera ray
generation, a bounce loop over fixed-capacity ray SoA batches with active
masks, stackless threaded-BVH traversal, branchless SoA material shading,
and segment-sum film accumulation. Host Python only loads scenes, builds
BVHs, orchestrates frames and writes images.
"""

__version__ = "0.1.0"
