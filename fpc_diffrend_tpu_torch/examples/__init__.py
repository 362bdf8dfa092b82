"""The fit examples, run as ``python -m
fpc_diffrend_tpu_torch.examples.<name> [--cpu] ...``: ``fit_cube``,
``fit_rig_synthetic`` and ``convergence_study``, with the synthetic head
and 9-camera rig they share (``rig``). Importing a module runs nothing."""
