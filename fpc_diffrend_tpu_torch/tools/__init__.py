"""Offline result renderers on the device: re-render a fit for inspection.

The port's own copies of ``fpc_diffrend_tpu.tools``' ``simple_render``
(one calibrated view to a PNG) and ``render_result`` (every fitted frame
side by side with, blended over, or gridded beside the reference frames),
with the same functions, arguments and ``main()``, plus ``device`` (CUDA
unless the caller asks for the CPU) and ``route`` (the render's kernels,
``ops.pipeline.render``).
"""
