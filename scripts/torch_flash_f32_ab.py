#!/usr/bin/env python3
"""Times the port's f32 flash-attention backward (δ, dq, dk/dv) from
several builds of its kernels on one NVIDIA card, in turns, at the ViT's
launch shape, beside SDPA's whole f32 backward.

    python scripts/torch_flash_f32_ab.py [--tree NAME=DIR ...]

The working tree's build (``fedml_tpu_torch/ops/csrc``) is always timed, as
``this``. Each ``--tree`` adds a copy of ``fedml_tpu_torch/ops/csrc`` from
another commit, unpacked for example with

    git archive <commit> fedml_tpu_torch/ops/csrc \\
        | tar -x -C .scratch/parent --strip-components=3

Builds go where ``scripts/torch_gn_fwd_ab.py`` puts its own (git-ignored),
in parallel. A build whose ``flash_dq`` takes O and returns ``(dq, δ)``
(the split-TF32 kernels) is timed as the port calls it; an older one (the
FMA kernels, ``flash_dq`` taking δ) after δ computed with torch ops, as the
port called it then. At each shape of ``SHAPES`` (f32) each build's
backward runs once against the plain twin (within 1e-4 of max |want|, the
kernels' bound in ``chip_smoke.BWD_TOL``) and once more for a bit-equal
rerun; then each is timed (``chip_smoke.time_ms``: dq alone, dk/dv alone,
and the whole backward back to back), the builds in the order A..Z then
Z..A. SDPA's whole backward on the same data is timed once per shape as
``chip_smoke.phase_flash_bwd_kernels`` times it, and its kernels are named
from a ``torch.profiler`` trace of three forward + backward calls. Prints
each build's registers and stack a kernel (``cuobjdump -res-usage``), each
mean and one JSON line.
"""

from __future__ import annotations

import argparse
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


def _res_usage(name):
    """Registers and stack of each f32 backward kernel of one build."""
    lib = glob.glob(os.path.join(WORK, "build", name, "*.so"))[0]
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-res-usage",
                          lib], capture_output=True, text=True, timeout=300,
                         check=True).stdout
    fn = None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
        res = dict(re.findall(r"(REG|STACK|LOCAL):(\d+)", line))
        kernel = fn and re.search(
            r"flash_d(?:q|kv)\w*?_kernel\w*?Li\d+E(?:Li\d+E|Lb[01]E)*", fn)
        if kernel and "REG" in res and "sm90" not in fn:
            print(f"[ab] {name} {kernel.group(0)}: REG {res['REG']} STACK "
                  f"{res.get('STACK')} LOCAL {res.get('LOCAL')}", flush=True)
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="NAME=DIR: a copy of fedml_tpu_torch/ops/csrc")
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
    routes = {name: _route(_load(name, src)) for name, src in trees.items()}
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
        o, lse = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        args5 = [x[None] for x in (q, k, v, do, o)] + [lse[None], causal]
        shape = f"[{b}, {t}, {h}, {d}] f32 {'causal' if causal else 'full'}"
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
        out["shapes"][shape] = row = {"sdpa_bwd_ms": library_ms,
                                      "sdpa_kernels": [k[0] for k in
                                                       kernels[:3]]}
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
