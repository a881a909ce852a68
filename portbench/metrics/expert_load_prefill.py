"""Layer model step: the (token, expert) pairs that one held expert takes in
one prefill call, on the mean over every batch of the window: the pairs the
program routed to the experts it holds in the batch's prefill
(``last_stats["moe_pairs"]["prefill"]["held"]``) over its MoE layers times
the experts held. A count does not change under the profiler, so the span's
batches count too. Nothing where the program counts no pairs, and nothing in
a CPU rehearsal."""


def _moe_layers(sizes: dict) -> int:
    moe = sizes["moe"]
    first = max(moe["first_moe_layer"], sizes.get("num_dense_layers", 0))
    return len(range(first, sizes["num_layers"], moe["moe_every"]))


def read(run):
    bs = run.batches
    if run.device != "cuda" or not bs or any("moe_pairs" not in b for b in bs):
        return None
    slots = sum(_moe_layers(run.levels[b["level"]]) * run.levels[b["level"]]["moe"]["num_experts"]
                for b in bs)
    return sum(b["moe_pairs"]["prefill"]["held"] for b in bs) / slots if slots else None
