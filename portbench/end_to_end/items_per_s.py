"""Items (a prompt and its output tokens) of every batch the window returned,
over the window's time (host clock)."""


def read(run):
    return sum(b["n"] for b in run.batches) / run.window_s
