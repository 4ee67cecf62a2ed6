"""setup_s: process start to the window's first dispatch: CUDA start-up,
the shards' synthesis and upload, the kernel library's load (its build,
in a checkout's first run), the weights and the five rounds before the
window (host clock)."""

UNIT = "s"


def read(run):
    return run.setup_s
