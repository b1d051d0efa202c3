"""PyTorch and CUDA port of raytracing_rust_tpu, a Monte Carlo path tracer of
the "Ray Tracing in One Weekend / The Next Week" scenes.

The JAX package `raytracing_rust_tpu` is the reference this port is held
against. This package imports torch and numpy, never JAX. Its render path:
`models.builders` (scene tables) → `ops.tracer.render_kernel` (scene and
camera records, sample chunks) → `ops.tracer.trace` (the hand-written CUDA
kernel `csrc/tracer.cu`, or its plain torch version on the CPU) →
`render.finalize_image` → `utils.image_io`. Its training path:
`inverse_render` → `render.camera_lane_rays` + `ops.grad.trace_fast` (the
hand-written CUDA kernels `csrc/grad.cu` K2 forward and K3 backward, or
their plain torch twin on the CPU) → `torch.optim.Adam`.
"""
