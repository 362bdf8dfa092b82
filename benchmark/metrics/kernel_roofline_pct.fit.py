"""The kernels' share of a fit step's least time (%): the step's least
time (``benchmark.work.step_work``) over the summed device time, per step,
of every kernel the traced slice ran but the collectives (names beginning
with ``nccl``; on more than one card their time is mostly the wait for
the slowest rank, which ``collective_ms.fit`` reads)."""


def read(run: dict):
    tl = run.get("timeline")
    if run.get("kind") != "fit" or not tl or not run.get("slice_steps"):
        return None
    t = tl["kernel_s"] - sum(s for name, s in tl["kernels"].items()
                             if name.startswith("nccl"))
    if t <= 0:
        return None
    return 100.0 * run["least"]["s"] / (t / run["slice_steps"])
