"""Process start until the window opens: imports, weights drawn on the card, the program's fusion and packs, its
kernel build or load, and the warm-up requests (host clock)."""


def read(run):
    return run.setup_s
