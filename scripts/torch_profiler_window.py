#!/usr/bin/env python3
"""Counts the kernels that ``torch.profiler`` drops at the ends of its
window on one NVIDIA card, with and without the pad that the port's
``obs.timing.trace`` holds on each side of its body.

    python scripts/torch_profiler_window.py [--short 150] [--rounds 24]

The profiler keeps only the device activities whose timestamps, moved onto
the host's clock, fall inside its window. Two measurements:

- ``--short`` short sessions, each around four launches of one marker
  kernel and a synchronize, half unpadded and half padded: the marker
  kernels missing from each session's trace, and the least start of a
  kernel minus the start of its launch call (a few microseconds when the
  two clocks agree);
- ``--rounds`` traces of ``chip_smoke.py``'s flagship FedAvg round (ResNet-56
  with its GroupNorm kernels, one ``train_rounds_on_device(1)``), in turns
  unpadded (the profiler alone around the fenced round, as ``trace`` was
  before its pad) and through ``trace`` itself: the GroupNorm kernels by
  name against the launches the round makes, and the kernels in all.

Prints one line a session and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import statistics
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fedml_tpu_torch.obs import RoundTimer, timing  # noqa: E402


def _export(prof):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _lead_us(events):
    """The least (kernel start - its launch call's start), in µs."""
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    leads = [e["ts"] - launch[c] for e in events if e.get("cat") == "kernel"
             for c in [e.get("args", {}).get("correlation")] if c in launch]
    return min(leads) if leads else None


@contextlib.contextmanager
def _unpadded(log_dir):
    """The profiler around the body with no pad, written as ``trace``
    writes its file."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _short(n):
    x = torch.zeros(1 << 20, device="cuda")
    out = {}
    for padded in (False, True):
        lost, leads = 0, []
        for i in range(n // 2):
            torch.cuda.synchronize()
            if i % 3 == 2:
                time.sleep(0.3)  # some sessions start after an idle spell
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                if padded:
                    timing._pad_window(True)
                for _ in range(4):
                    x.add_(1)
                torch.cuda.synchronize()
                if padded:
                    timing._pad_window(True)
            events = _export(prof)
            kept = sum(e.get("cat") == "kernel" for e in events)
            lost += 4 - kept
            leads.append(_lead_us(events))
        seen = [v for v in leads if v is not None]
        key = "padded" if padded else "unpadded"
        out[key] = {"sessions": n // 2, "markers_lost": lost,
                    "sessions_with_none": leads.count(None),
                    "lead_us_min": min(seen), "lead_us_max": max(seen),
                    "lead_us_median": statistics.median(seen)}
        print(f"[short] {key}: {out[key]}", flush=True)
    return out


def _rounds(n):
    import chip_smoke as cs

    cs.phase_build()
    api = cs._flagship_api(None)
    want = (cs.TRAIN_PER_CLIENT // cs.TRAIN_BATCH) * cs.RESNET56_GN
    timer = RoundTimer()
    out = {"unpadded": [], "trace": []}
    for i in range(n):
        key = ("unpadded", "trace")[i % 2]
        with tempfile.TemporaryDirectory(prefix="profiler_window_") as d:
            with (_unpadded(d) if key == "unpadded" else timing.trace(d)):
                timer.fence(api.train_rounds_on_device(1))
            (name,) = os.listdir(d)
            with open(os.path.join(d, name)) as f:
                events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        gn = collections.Counter(
            m.group(1) for m in (re.search(r"\b(gn_\w+_kernel)\b", e["name"])
                                 for e in kernels) if m)
        whole = gn["gn_fwd_kernel"] == gn["gn_bwd_kernel"] == want
        out[key].append({"whole": whole, "kernels": len(kernels),
                         "gn": dict(sorted(gn.items())),
                         "lead_us": _lead_us(events)})
        print(f"[round] {i} {key}: GroupNorm launches held {whole} "
              f"(want {want}); {out[key][-1]}", flush=True)
    return {k: {"traces": len(v), "short": sum(not r["whole"] for r in v),
                "kernels": sorted({r["kernels"] for r in v})}
            for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--short", type=int, default=150)
    ap.add_argument("--rounds", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profiler_window: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs

    card = cs.smi_line()
    print(f"[setup] {card}; pad {timing.TRACE_PAD_S} s a side", flush=True)
    summary = {"card": card, "pad_s": timing.TRACE_PAD_S,
               "short": _short(args.short), "rounds": _rounds(args.rounds)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
