"""95th percentile of every view's latency in the window, from the call to
the image on the host (ms; linear interpolation between ranks)."""

import numpy as np


def read(run: dict):
    win = run.get("window", {})
    if run.get("kind") != "view" or len(win.get("latency_s", ())) < 200:
        return None
    return 1e3 * float(np.percentile(win["latency_s"], 95))
