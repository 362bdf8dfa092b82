"""Offline tools: the port's own copies of ``fpc_diffrend_tpu.tools``, with
the same functions, arguments and ``main()``.

* ``simple_render`` (one calibrated view to a PNG) and ``render_result``
  (every fitted frame side by side with, blended over, or gridded beside
  the reference frames) render on the device, plus ``device`` (CUDA
  unless the caller asks for the CPU) and ``route`` (the render's
  kernels, ``ops.pipeline.render``);
* ``undistort`` (``cv2.undistort``, or a torch remap on the device in
  place of JAX's ``undistort_image_jax``);
* host code: ``comparisons`` (difference heatmaps, crop-mean CSVs),
  ``batchmodify`` (blendshape OBJ sections), ``render_reference`` (a TIF
  sequence to an mp4) and ``calibrate`` (OpenCV circle-grid
  calibration).
"""
