"""The window's seconds over the proves completed in it: a mean over all
the work and all the time of the window (serialisation included)."""


def read(run):
    return run.window_s / len(run.prove_s) if run.prove_s else None
