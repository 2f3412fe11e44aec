"""Device milliseconds a prove in the scheduled Pippenger's kernels (the
insertion, the tile fold and the window sums), from the traced window."""

KERNELS = ("msm_insert_kernel", "msm_fold_tiles_kernel",
           "msm_window_sums_kernel")


def read(run):
    tl = run.timeline
    if tl is None or not tl.proves:
        return None
    s = tl.kernel_s(*KERNELS)
    return 1e3 * s / tl.proves if s > 0 else None
