"""The kernels' share of a fit step's least time (%): the step's least
time (``benchmark.work.step_work``) over the summed device time of every
kernel the traced slice ran, per step."""


def read(run: dict):
    tl = run.get("timeline")
    if (run.get("kind") != "fit" or not tl or tl["kernel_s"] <= 0
            or not run.get("slice_steps")):
        return None
    return 100.0 * run["least"]["s"] / (tl["kernel_s"] / run["slice_steps"])
