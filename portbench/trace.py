"""The profiled span of a traced run: device time by kernel, busy and idle
time, and the longest idle gaps named by what the host was doing.

``torch.profiler`` records the span (CUPTI on the card); its Chrome trace
is read back from a temporary file, which is deleted. Host ranges that the
harness opens with ``record_function`` are named ``portbench.*``.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10
NAME_CHARS = 160         # a device operation's name in the breakdown is cut here


class Span:
    """``start()`` ... ``stop()`` around the profiled batches, inside the
    window; ``summary()`` reads the trace once the window has closed (see
    :func:`summarise`)."""

    def start(self):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()

    def summary(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        del self.prof
        return summarise(events, self.window_s)


def summarise(events: List[dict], window_s: float) -> dict:
    """``window_s`` (host clock, from a synchronised start to a synchronised
    end), ``busy_s`` (the union of the device's operations), ``kernels``
    (each kernel's name and seconds, in start order), ``device_ops`` (seconds
    by name, the longest first) and ``idle_gaps`` (the longest gaps between
    device operations, each named by the host's ranges at its start)."""
    dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"][:NAME_CHARS]] += e["dur"] * 1e-6
    merged = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps = sorted(((b0 - a1, a1) for (_, a1), (b0, _) in zip(merged, merged[1:])),
                  reverse=True)[:TOP]
    namer = _HostNamer(host)
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "kernels": [(e["name"], e["dur"] * 1e-6) for e in dev if e["cat"] == "kernel"],
        "device_ops": sorted(([k, v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": [[namer.at(start), gap * 1e-6] for gap, start in gaps],
    }


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _HostNamer:
    """Names an instant by the innermost ``portbench.*`` range and the
    outermost other host op around it ("python" where none is)."""

    def __init__(self, host: List[dict]):
        self.ev = sorted(host, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.ev]

    def at(self, t: float) -> str:
        ours, op = None, None
        for e in self.ev[:bisect.bisect_right(self.starts, t)]:
            if t > e["ts"] + e["dur"]:
                continue
            if e["name"].startswith("portbench."):
                if ours is None or e["ts"] >= ours["ts"]:
                    ours = e
            elif op is None or e["ts"] < op["ts"]:
                op = e
        return f"{ours['name'] if ours else 'portbench'} > {op['name'] if op else 'python'}"
