"""Millions of non-zero signed digits the scheduled Pippenger inserts a
prove: the program's counter ``msm_digits`` (summed from each
``MsmPlan``), its window total (the harness resets the counters as the
window opens) over the window's proves.  None where the program keeps
no such counter."""


def read(run):
    from tnsh_torch.utils import profiling

    totals = getattr(profiling, "counter_totals", None)
    if totals is None or not run.prove_s:
        return None
    digits = totals().get("msm_digits")
    return None if digits is None else digits / 1e6 / len(run.prove_s)
