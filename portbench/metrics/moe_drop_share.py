"""Layer model step: the (token, expert) pairs the program dropped at an
expert's capacity over the pairs it routed to the experts it holds, prefill
and decode, over every batch of the window, in %
(``last_stats["moe_pairs"]``). A count does not change under the profiler,
so the span's batches count too. Nothing where the program counts no pairs,
and nothing in a CPU rehearsal."""


def read(run):
    bs = run.batches
    if run.device != "cuda" or not bs or any("moe_pairs" not in b for b in bs):
        return None
    phases = [p for b in bs for p in b["moe_pairs"].values()]
    held = sum(p["held"] for p in phases)
    return 100.0 * sum(p["dropped"] for p in phases) / held if held else None
