"""The kernels' share of a view's least time (%): the view's least time
(``benchmark.work.view_work``) over the summed device time of every
kernel the traced slice ran, per view."""


def read(run: dict):
    tl = run.get("timeline")
    if (run.get("kind") != "view" or not tl or tl["kernel_s"] <= 0
            or not run.get("slice_steps")):
        return None
    return 100.0 * run["least"]["s"] / (tl["kernel_s"] / run["slice_steps"])
