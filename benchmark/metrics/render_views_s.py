"""Views rendered, each image on the host, over the whole window, in a
closed loop of one viewer (views/s)."""


def read(run: dict):
    win = run.get("window", {})
    if run.get("kind") != "view" or not win.get("views"):
        return None
    return win["views"] / win["window_s"]
