"""The whole view's share of the card's peak (%): the view's least time
(``benchmark.work.view_work``) over the wall time per view of the
unprofiled window (window / views rendered)."""


def read(run: dict):
    win = run.get("window", {})
    if run.get("kind") != "view" or not win.get("views"):
        return None
    return 100.0 * run["least"]["s"] / (win["window_s"] / win["views"])
