#!/usr/bin/env python3
"""Times the port's f32 flash-attention forward and backward (δ, dq,
dk/dv) from several builds of its kernels on one NVIDIA card, in turns, at
the ViT's launch shape and the f32 adapter step's, beside SDPA's f32
forward and whole f32 backward.

    python scripts/torch_flash_f32_ab.py [--tree NAME=DIR ...] \
        [--part fwd|bwd|both]

The working tree's build (``fedml_tpu_torch/ops/csrc``) is always timed, as
``this``. Each ``--tree`` adds a copy of ``fedml_tpu_torch/ops/csrc`` from
another commit, unpacked for example with

    git archive <commit> fedml_tpu_torch/ops/csrc \\
        | tar -x -C .scratch/parent --strip-components=3

Builds go where ``scripts/torch_gn_fwd_ab.py`` puts its own (git-ignored),
in parallel. Forward: at each shape of ``SHAPES`` (f32) each build's
``flash_fwd`` runs once against the plain twin (o within
``chip_smoke.O_TOL``, lse within ``chip_smoke.LSE_TOL``) and once more for
a bit-equal rerun; then each is timed by ``chip_smoke.time_ms`` (20 calls
an event pair, as the kernels phase times it) and by
``chip_smoke.graph_ms`` (the same call replayed from a CUDA graph, the
device's time without the host's dispatch), the builds in the order A..Z
then Z..A, beside SDPA's f32 forward. Backward: a build whose
``flash_dq`` takes O and returns ``(dq, δ)`` (the split-TF32 kernels) is
timed as the port calls it; an older one (the FMA kernels, ``flash_dq``
taking δ) after δ computed with torch ops, as the port called it then. At
each shape of ``SHAPES`` (f32) each build's backward runs once against the
plain twin (within 1e-4 of max |want|, the kernels' bound in
``chip_smoke.BWD_TOL``) and once more for a bit-equal rerun; then each is
timed (``chip_smoke.time_ms``: dq alone, dk/dv alone, and the whole
backward back to back), the builds in the order A..Z then Z..A. SDPA's
whole backward on the same data is timed once per shape as
``chip_smoke.phase_flash_bwd_kernels`` times it, and its kernels are named
from a ``torch.profiler`` trace of three forward + backward calls. Prints
each build's registers and stack a kernel (``cuobjdump -res-usage``) and
its SASS instruction count with its most frequent opcodes (``cuobjdump
-sass``), each mean and one JSON line. ``--part`` times the forward or the
backward alone.
"""

from __future__ import annotations

import argparse
import collections
import glob
import importlib
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys

import torch

from torch_gn_fwd_ab import ROOT, WORK, _build, _load

# (B, T, H, D, causal): the ViT's launch (8 clients x batch 32, T 64, D 32,
# full) and the f32 adapter step's (T 2048, D 64, causal) at batch 2.
SHAPES = [(256, 64, 4, 32, False), (2, 2048, 8, 64, True)]


def _route(ext):
    """The whole f32 backward of one build: (dq, dk/dv given δ, whole)."""
    folded = "delta [R,B,H,T])" in (ext.flash_dq.__doc__ or "")

    def delta_of(q, k, v, do, o, lse, causal):
        if folded:
            return ext.flash_dq(q, k, v, do, o, lse, causal)[1]
        return (do * o).sum(-1).transpose(-1, -2).contiguous()

    def dq(q, k, v, do, o, lse, delta, causal):
        if folded:
            return ext.flash_dq(q, k, v, do, o, lse, causal)[0]
        return ext.flash_dq(q, k, v, do, lse, delta, causal)

    def dkv(q, k, v, do, lse, delta, causal):
        return ext.flash_dkv(q, k, v, do, lse, delta, causal)

    def whole(q, k, v, do, o, lse, causal):
        if folded:
            d_q, delta = ext.flash_dq(q, k, v, do, o, lse, causal)
        else:
            delta = (do * o).sum(-1).transpose(-1, -2).contiguous()
            d_q = ext.flash_dq(q, k, v, do, lse, delta, causal)
        return (d_q, *ext.flash_dkv(q, k, v, do, lse, delta, causal))

    return delta_of, dq, dkv, whole


F32_KERNEL = re.compile(
    r"flash_(?:fwd|dq|dkv)\w*?_kernel\w*?Li\d+E(?:Li\d+E|Lb[01]E)*")


def _res_usage(name):
    """Registers and stack of each f32 flash kernel of one build, and its
    SASS: the instruction count and the most frequent opcodes."""
    lib = glob.glob(os.path.join(WORK, "build", name, "*.so"))[0]

    def dump(flag):
        return subprocess.run(["/usr/local/cuda/bin/cuobjdump", flag, lib],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout

    fn, ops = None, {}
    for line in dump("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(
            r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            line)
        if fn and m and "sm90" not in fn and F32_KERNEL.search(fn):
            ops.setdefault(fn, collections.Counter())[
                m.group(1).split(".")[0]] += 1
    fn = None
    for line in dump("-res-usage").splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
        res = dict(re.findall(r"(REG|STACK|LOCAL):(\d+)", line))
        kernel = fn and F32_KERNEL.search(fn)
        if kernel and "REG" in res and "sm90" not in fn:
            sass = ops.get(fn, collections.Counter())
            print(f"[ab] {name} {kernel.group(0)}: REG {res['REG']} STACK "
                  f"{res.get('STACK')} LOCAL {res.get('LOCAL')}; "
                  f"{sum(sass.values())} SASS instructions: " + ", ".join(
                      f"{op} {n}" for op, n in sass.most_common(8)),
                  flush=True)
            fn = None


def _device_kernels(run):
    """(name, launches, device ms) of each kernel ``run()`` launches, by
    ``torch.profiler``, the longest first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, ev.count, us / 1e3))
    return sorted(rows, key=lambda r: -r[2])


def _forward(cs, exts, q, k, v, causal, shape):
    """Each build's f32 forward at one shape: held to the twin, rerun
    bit-equal, timed in turns (events and graph replays); SDPA's f32
    forward beside. Returns {build: {"ms", "graph_ms"}, "sdpa_fwd_ms"}."""
    import torch.nn.functional as F

    fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")
    po, plse = fa.flash_attention_plain(q, k, v, causal)
    q5, k5, v5 = (x[None] for x in (q, k, v))
    for name, ext in exts.items():
        o, lse = ext.flash_fwd(q5, k5, v5, causal)
        o2, lse2 = ext.flash_fwd(q5, k5, v5, causal)
        torch.cuda.synchronize()
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        err_o = (o[0] - po).abs().max().item()
        err_lse = (lse[0] - plse).abs().max().item()
        print(f"[ab] {name} forward {shape}: max|o-plain| {err_o:.3e} "
              f"({err_o / po.abs().max().item():.3e} of max|o|), "
              f"max|lse-plain| {err_lse:.3e}; rerun "
              f"{'bit-equal' if same else 'DIFFERS'}", flush=True)
        cs.check(same and err_o <= cs.O_TOL[torch.float32]
                 and err_lse <= cs.LSE_TOL,
                 f"{name}'s forward disagrees with the twin at {shape}: "
                 f"o {err_o}, lse {err_lse}")
    names = list(exts)
    times = {(name, kind): [] for name in names for kind in ("ms", "graph")}
    for name in names + names[::-1]:
        fwd = exts[name].flash_fwd
        times[name, "ms"].append(cs.time_ms(lambda: fwd(q5, k5, v5, causal)))
        times[name, "graph"].append(cs.graph_ms(
            lambda: fwd(q5, k5, v5, causal)))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    row = {"sdpa_fwd_ms": sdpa_ms}
    for name in names:
        row[name] = {"ms": statistics.mean(times[name, "ms"]),
                     "graph_ms": statistics.mean(times[name, "graph"])}
        print(f"[ab] {name} forward {shape}: {row[name]['ms']:.4f} ms (" +
              " / ".join(f"{x:.4f}" for x in times[name, "ms"]) +
              f"), replayed {row[name]['graph_ms']:.4f} ms (" +
              " / ".join(f"{x:.4f}" for x in times[name, "graph"]) +
              f"); SDPA's f32 forward {sdpa_ms:.4f} ms", flush=True)
    return row


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="NAME=DIR: a copy of fedml_tpu_torch/ops/csrc")
    p.add_argument("--part", choices=("fwd", "bwd", "both"), default="both")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_f32_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    import chip_smoke as cs

    fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trees = {"this": os.path.join(ROOT, "fedml_tpu_torch", "ops", "csrc")}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = os.path.abspath(path)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(trees)) as pool:
        for name in pool.imap_unordered(_build, trees.items()):
            print(f"[ab] built {name}", flush=True)
    exts = {name: _load(name, src) for name, src in trees.items()}
    routes = {name: _route(ext) for name, ext in exts.items()}
    names = list(routes)
    for name in names:
        _res_usage(name)
    smi = cs.smi_line()
    print(f"[ab] card {smi}; builds {names}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {"card": smi, "shapes": {}}
    for b, t, h, d, causal in SHAPES:
        q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                       for _ in range(4))
        shape = f"[{b}, {t}, {h}, {d}] f32 {'causal' if causal else 'full'}"
        out["shapes"][shape] = {}
        if args.part != "bwd":
            out["shapes"][shape]["fwd"] = _forward(cs, exts, q, k, v, causal,
                                                   shape)
        if args.part == "fwd":
            continue
        o, lse = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        args5 = [x[None] for x in (q, k, v, do, o)] + [lse[None], causal]
        for name, (_, _, _, whole) in routes.items():
            got = [x[0] for x in whole(*args5)]
            same = all(torch.equal(x[0], y) for x, y in
                       zip(whole(*args5), got))
            torch.cuda.synchronize()
            errs = [cs._scaled_err(a, w) for a, w in zip(got, want)]
            print(f"[ab] {name} {shape}: max|d-plain|/max|plain| dq "
                  f"{errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}; "
                  f"rerun {'bit-equal' if same else 'DIFFERS'}", flush=True)
            cs.check(same and all(e <= cs.BWD_TOL[torch.float32]
                                  for e in errs),
                     f"{name} disagrees with the twin at {shape}: {errs}")
        times = {(name, kind): [] for name in names
                 for kind in ("dq", "dkv", "whole")}
        for name in names + names[::-1]:
            delta_of, dq, dkv, whole = routes[name]
            delta = delta_of(*args5)
            q5, k5, v5, do5, o5, lse5, c = args5
            times[name, "dq"].append(cs.time_ms(
                lambda: dq(q5, k5, v5, do5, o5, lse5, delta, c)))
            times[name, "dkv"].append(cs.time_ms(
                lambda: dkv(q5, k5, v5, do5, lse5, delta, c)))
            times[name, "whole"].append(cs.time_ms(lambda: whole(*args5)))
        qr, kr, vr = (x.transpose(1, 2).detach().clone().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def lib_fwd():
            return F.scaled_dot_product_attention(qr, kr, vr,
                                                  is_causal=causal)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), (qr, kr, vr), dot)

        library_ms = cs.graph_ms(lib_fwd_bwd) - cs.graph_ms(lib_fwd)
        kernels = _device_kernels(lambda: [lib_fwd_bwd() for _ in range(3)])
        print(f"[ab] SDPA forward + backward x 3 at {shape}, device ms by "
              "kernel: " + "; ".join(f"{ms:.3f} x{n} {name[:100]}"
                                     for name, n, ms in kernels[:3]),
              flush=True)
        row = out["shapes"][shape]
        row.update(sdpa_bwd_ms=library_ms,
                   sdpa_kernels=[k[0] for k in kernels[:3]])
        for name in names:
            row[name] = {kind: statistics.mean(times[name, kind])
                         for kind in ("dq", "dkv", "whole")}
            print(f"[ab] {name} {shape}: dq {row[name]['dq']:.4f} ms, dk/dv "
                  f"{row[name]['dkv']:.4f} ms, whole backward (δ + dq + "
                  f"dk/dv) {row[name]['whole']:.4f} ms (" + " / ".join(
                      f"{x:.4f}" for x in times[name, "whole"])
                  + f"); SDPA's whole backward {library_ms:.4f} ms",
                  flush=True)
        del q, k, v, do, o, lse, want, args5, qr, kr, vr, dot
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
