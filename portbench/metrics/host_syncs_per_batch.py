"""Layer model step: the host synchronisations the program counts in a batch
(``last_stats["syncs"]``: the tokens' upload, the MoE dispatch's boolean
index at each MoE layer of the prefill and of every decode step, the tokens'
copy back and the finite flag), the mean over every batch of the window. A
count does not change under the profiler, so the span's batches count too:
the window serves whole passes of a deck that every seed shares, and every
run of a cell reads the same number. Nothing where the program counts no
syncs, and nothing in a CPU rehearsal."""


def read(run):
    bs = run.batches
    if run.device != "cuda" or not bs or any("syncs" not in b for b in bs):
        return None
    return sum(sum(b["syncs"].values()) for b in bs) / len(bs)
