"""Layer model step: the model FLOPs of the batches outside the profiled span
(``flops_mla.batch_flops``, from each level's shapes: MLA as the program
runs it, the router at its full width, the shared expert and the held
experts' expected share) over the window's time outside the span, as a share
of the chip's bf16 peak. Nothing for a configuration without MLA."""
from portbench import flops_mla


def read(run):
    if run.peak is None or run.span is None or not run.sizes.get("mla"):
        return None
    bs = [b for b in run.batches if not b["in_span"]]
    work = sum(flops_mla.batch_flops(run.levels[b["level"]], b["n"], b["plen"], b["out"])
               for b in bs)
    elapsed = run.window_s - run.span_wall_s
    return 100.0 * work / (elapsed * run.peak["bf16_flops"])
