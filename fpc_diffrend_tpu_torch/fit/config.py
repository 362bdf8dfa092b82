"""Fit configuration: the port's own copy of ``fpc_diffrend_tpu.fit.config``.

Field names and defaults are the JAX package's, so one config means the
same thing in both packages. ``raster_impl`` and ``aa_max_pairs`` are kept
for that reason: the fit step always renders through the stacked-batch
kernel path with the exact antialias. The single view
(``ops.pipeline.render``, which the result renderers call) is the same
path at a batch of one.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FitConfig:
    # --- optimization ---
    max_iter: int = 80000
    lr_base: float = 1e-3
    lr_tex_coef: float = 0.5
    lr_ramp: float = 0.005
    lr_t: float = 1e-5
    lr_q: float = 1e-5

    # --- data paths ---
    basemeshpath: str = ""
    localblpath: str = ""
    globalblpath: str = ""
    imdir: str = ""
    calibpath: str = ""
    texpath: str = ""
    maskpath: str = ""
    out_dir: str = "out"

    # --- rendering ---
    enable_mip: bool = False
    max_mip_level: int = 6
    texshape: Tuple[int, int, int] = (1024, 1024, 1)
    resolution: Tuple[int, int] = (1600, 1200)

    # --- logging / saving ---
    display_interval: int = 0
    log_interval: int = 50
    mp4_interval: int = 0

    # --- staging ratios ---
    tex_startlearnratio: int = 20
    tex_ramplearnratio: Tuple[float, float] = (2.0, 0.75)
    free_startlearnratio: int = 4

    # --- regularizers ---
    weight_laplacian: float = 0.0
    weight_meshedge: float = 0.0
    meshedge_target: float = 0.05
    weight_normalconsistency: float = 0.0
    regularize_correctives: bool = False
    regularize_prior: bool = False
    weight_temporal: float = 0.0

    # --- scene / mode ---
    cam_idxs: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6, 7, 8)
    whiten_mean: float = 50.0
    whiten_std: float = 25.0
    mode: str = "prior"
    combined_corrective_coefficient: float = 1.0

    # --- batching and run control ---
    batch_size: int = 1
    seed: int = 0
    raster_impl: str = "auto"
    aa_max_pairs: int = 0
    pair_cap: int = 0
    steps_per_dispatch: int = 1
    checkpoint_interval: int = 0
    checkpoint_dir: str = ""
    mesh_axes: Tuple[str, ...] = ()
    mesh_shape: Tuple[int, ...] = ()

    def validate(self) -> None:
        valid_modes = ("prior", "free", "combined")
        if self.mode not in valid_modes:
            raise ValueError(
                f"No valid mode ({self.mode!r}) selected from valid "
                f"configurations {valid_modes}")

    def save(self, path: str) -> None:
        """Dump every field, one ``name: 'value'`` line each (the config.txt
        record of reference fit.py:655-657)."""
        with open(path, "w") as f:
            for k, v in dataclasses.asdict(self).items():
                f.write(f"{k}: '{v}'\n")
