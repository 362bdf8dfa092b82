"""Host issue time of a fit step: the harness's host-clock span around
each ``run_fit`` chunk of the unprofiled window, less the time the loss
read waited for the device, per step (ms)."""


def read(run: dict):
    win = run.get("window", {})
    if run.get("kind") != "fit" or not win.get("issue_s"):
        return None
    return 1e3 * sum(win["issue_s"]) / len(win["issue_s"])
