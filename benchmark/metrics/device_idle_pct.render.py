"""Share of the traced slice of views in which no kernel, copy or set ran
on the device (%): 100 (1 - busy / slice)."""


def read(run: dict):
    tl = run.get("timeline")
    if run.get("kind") != "view" or not tl or tl["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
