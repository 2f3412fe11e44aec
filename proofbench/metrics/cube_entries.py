"""Millions of entries a prove in the sound tier's cube tables: the
program's counter ``cube_entries`` (counted where ``_twist_witness``
fills the tables: one in ra a read, one in each of wa and Inc a write,
and one update of Val a write), its window total (the harness resets the
counters as the window opens) over the window's proves.  None where the
program keeps no such counter."""


def read(run):
    from tnsh_torch.utils import profiling

    totals = getattr(profiling, "counter_totals", None)
    if totals is None or not run.prove_s:
        return None
    entries = totals().get("cube_entries")
    return None if entries is None else entries / 1e6 / len(run.prove_s)
