"""From the process's start to the first timed step or request: imports,
the CUDA context, kernel loads (and their build in a fresh checkout),
the inputs, the cap autotune and the warm-up, host clock (s)."""


def read(run: dict):
    return run.get("setup_s")
