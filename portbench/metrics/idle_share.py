"""Layer device: the share of the profiled span's wall time in which no
operation ran on the device."""


def read(run):
    if run.span is None:
        return None
    return 100.0 * (1.0 - run.span["busy_s"] / run.span["window_s"])
