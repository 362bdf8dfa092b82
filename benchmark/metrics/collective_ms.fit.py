"""Device time of the collectives a fit step (ms): the summed time of the
NCCL kernels (names beginning with ``nccl``) in the traced slice, per
step; rank 0's slice, in which every collective also waits for the other
ranks."""


def read(run: dict):
    tl = run.get("timeline")
    if run.get("kind") != "fit" or not tl or not run.get("slice_steps"):
        return None
    t = sum(s for name, s in tl["kernels"].items() if name.startswith("nccl"))
    if t <= 0:
        return None
    return 1e3 * t / run["slice_steps"]
