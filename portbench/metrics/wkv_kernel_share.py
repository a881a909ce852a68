"""Layer model step: the token-layers whose WKV recurrence ran through K4
among all the recurrence's token-layers (K4 and the one-step update) of
every batch of the window, in % (``last_stats["wkv_tokens"]``). A count does
not change under the profiler, so the span's batches count too. Nothing
where the program counts no such tokens, and nothing in a CPU rehearsal."""


def read(run):
    bs = run.batches
    if run.device != "cuda" or not bs or any("wkv_tokens" not in b for b in bs):
        return None
    kernel = sum(b["wkv_tokens"]["kernel"] for b in bs)
    total = kernel + sum(b["wkv_tokens"]["step"] for b in bs)
    return 100.0 * kernel / total if total else None
