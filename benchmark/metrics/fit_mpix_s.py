"""Fit throughput (Mpix/s): B H W x the steps completed in the window,
over the whole window, host clock, closed by a synchronize."""


def read(run: dict):
    win = run.get("window", {})
    if run.get("kind") != "fit" or not win.get("steps"):
        return None
    return win["steps"] * run["pixels_per_step"] / win["window_s"] / 1e6
