"""Seconds from the start of the process to the window: imports, the
kernels and engine from the checkout's build cache, the inputs, the SRS
built and put on the card, the warm-up."""


def read(run):
    return run.setup_s
