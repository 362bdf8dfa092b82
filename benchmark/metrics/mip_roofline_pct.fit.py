"""The mip kernels' share of their least time (%): K8's and K9's bytes a
step at the card's peak bandwidth (``benchmark.work.mip_kernels_work``
over the step's B H W pixels) over their summed device time a step in the
traced slice (``mip_fwd_kernel*`` + ``mip_bwd_kernel*``)."""

from benchmark import work


def read(run: dict):
    tl = run.get("timeline")
    if run.get("kind") != "fit" or not tl or not run.get("slice_steps"):
        return None
    t = sum(s for name, s in tl["kernels"].items()
            if "mip_fwd_kernel" in name or "mip_bwd_kernel" in name)
    if t <= 0:
        return None
    # a rank's pixels: the traced slice is one rank's
    least = work.mip_kernels_work(
        run["pixels_per_step"] // run.get("count", 1))["s"]
    return 100.0 * least / (t / run["slice_steps"])
