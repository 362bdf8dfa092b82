"""The whole fit step's share of the card's peak (%): the step's least
time (``benchmark.work.step_work``) over the wall time per step of the
unprofiled window (window / completed steps)."""


def read(run: dict):
    win = run.get("window", {})
    if run.get("kind") != "fit" or not win.get("steps"):
        return None
    return 100.0 * run["least"]["s"] / (win["window_s"] / win["steps"])
