"""Multi-device fit on ``torch.distributed`` (port of
``fpc_diffrend_tpu.parallel``): process-group meshes over the ("frame",
"view", "tile") axes, the row-band render with its antialias seam, and
the sharded train step."""
