#!/usr/bin/env python3
"""Times GroupNorm's streamed route (a sample past a cluster of 8 blocks)
from several builds of the port's kernels on one NVIDIA card, in turns, at
FedSeg's U-Net shapes, beside ``F.group_norm``.

    python scripts/torch_gn_streamed_ab.py [--tree NAME=DIR ...]

The working tree's build (``fedml_tpu_torch/ops/csrc``) is always timed, as
``this``. Each ``--tree`` adds a copy of ``fedml_tpu_torch/ops/csrc`` from
another commit, unpacked for example with

    git archive <commit> fedml_tpu_torch/ops/csrc \\
        | tar -x -C .scratch/parent --strip-components=3

Builds go where ``scripts/torch_gn_fwd_ab.py`` puts its own (git-ignored),
in parallel.
At each shape of ``SHAPES`` (f32, 8 clients' rows of 8 samples, x and dy
interleaved as the vmapped convs hand them over) each build's forward and
backward (the per-sample kernel and the dγ/dβ reduce) run once against
the plain twins (``chip_smoke._gn_err`` for y and dx, the sum-order bound
for dγ/dβ) and twice more for bit-equal reruns; then each is timed as a
replayed CUDA graph (``chip_smoke.graph_ms``), the builds in the order
A..Z then Z..A, beside ``F.group_norm``'s forward and backward on the same
data in NCHW (``chip_smoke._gn_nchw_ms``). Prints the working tree's streamed plan, each time beside
its bound, and one JSON line of the means.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import sys

import torch

from torch_gn_fwd_ab import ROOT, _build, _load

# FedSeg's U-Net at 256² (base 16): level 0 and level 1, 8 clients x 8.
SHAPES = [((64, 65536, 16), 16), ((64, 16384, 32), 32)]
ROWS = 8


def _runs(ext, eps):
    """(forward, backward with the reduce) of one build."""
    def fwd(x, g, b, grp):
        return ext.group_norm_fwd(x, g, b, grp, eps)[0]

    def bwd(x, dy, g, grp):
        dx, part_g, part_b, _ = ext.group_norm_bwd(x, dy, g, grp, eps)
        return (dx, *ext.group_norm_reduce(part_g, part_b, x.shape[0]))

    return fwd, bwd


def _hold(name, fwd, bwd, x, dy, gamma, beta, groups, want):
    """One build against the twins, reruns bit-equal."""
    import chip_smoke as cs
    from fedml_tpu_torch.ops import group_norm as gn

    want_y, (want_dx, want_dg, want_db) = want
    y, grads = fwd(x, gamma, beta, groups), bwd(x, dy, gamma, groups)
    same = (torch.equal(y, fwd(x, gamma, beta, groups))
            and all(torch.equal(a, b) for a, b in
                    zip(grads, bwd(x, dy, gamma, groups))))
    torch.cuda.synchronize()
    ey, ok_y = cs._gn_err(y, want_y, torch.float32)
    edx, ok_dx = cs._gn_err(grads[0], want_dx, torch.float32)
    r, m, s, c = x.shape
    chain = s + m + 64
    mu, rstd = gn._stats(x.float(), groups, gn.EPS)
    lim_g = chain * 2.0 ** -24 * (dy * (x - mu) * rstd).abs().sum(
        dim=(1, 2)) + 1e-7
    lim_b = chain * 2.0 ** -24 * dy.abs().sum(dim=(1, 2)) + 1e-7
    edg, edb = (grads[1] - want_dg).abs(), (grads[2] - want_db).abs()
    ok_p = bool((edg <= lim_g).all() and (edb <= lim_b).all())
    print(f"[ab] {name} [{r}x{m}, {s}, {c}] g{groups}: max|y-plain| "
          f"{ey:.3e}, max|dx-plain| {edx:.3e}, max|dgamma-plain| "
          f"{edg.max().item():.3e}, max|dbeta-plain| "
          f"{edb.max().item():.3e}; reruns "
          f"{'bit-equal' if same else 'DIFFER'}", flush=True)
    cs.check(ok_y and ok_dx and ok_p and same,
             f"{name} disagrees with the twins at {[r, m, s, c]}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="NAME=DIR: a copy of fedml_tpu_torch/ops/csrc")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_gn_streamed_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from fedml_tpu_torch.ops import group_norm as gn

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
    runs = {name: _runs(_load(name, src), gn.EPS)
            for name, src in trees.items()}
    names = list(runs)
    smi = cs.smi_line()
    peaks = cs.peaks_for(smi.split(",")[0])[1]
    print(f"[ab] card {smi}; builds {names}", flush=True)
    ext = _load("this", trees["this"])
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {"card": smi, "shapes": {}}
    for (n, s, c), groups in SHAPES:
        fwd, bwd = (ext.group_norm_plan(s, c, False, k) for k in (1, 2))
        print(f"[ab] streamed plan [{s}, {c}] f32: CL {fwd[4]}, {fwd[5]} rows "
              f"a block; forward {fwd[6]} resident, {fwd[8]} B; backward x "
              f"{bwd[6]} and dy {bwd[7]} resident, {bwd[8]} B; {fwd[9]} "
              "clusters at once", flush=True)
        x, dy, gamma, beta = cs._gn_inputs((n, s, c), ROWS, torch.float32,
                                           gen, True)
        want = (gn.group_norm_fwd_plain(x, gamma, beta, groups),
                gn.group_norm_bwd_plain(x, dy, gamma, groups))
        for name, (fwd, bwd) in runs.items():
            _hold(name, fwd, bwd, x, dy, gamma, beta, groups, want)
        del want
        times = {(name, kind): [] for name in names for kind in ("fwd",
                                                                 "bwd")}
        for name in names + names[::-1]:
            fwd, bwd = runs[name]
            times[name, "fwd"].append(cs.graph_ms(
                lambda: fwd(x, gamma, beta, groups)))
            times[name, "bwd"].append(cs.graph_ms(
                lambda: bwd(x, dy, gamma, groups)))
        lib = cs._gn_nchw_ms(x, dy, gamma, beta, groups)
        shape = f"[{ROWS}x{n // ROWS}, {s}, {c}]"
        out["shapes"][shape] = row = {}
        for i, kind in enumerate(("fwd", "bwd")):
            bound = cs._gn_bound(kind, x, peaks)[0]
            mean = {name: statistics.mean(times[name, kind])
                    for name in names}
            row[kind] = {"bound_ms": bound, "library_ms": lib[i], **{
                f"{name}_ms": mean[name] for name in names}}
            print(f"[ab] {kind} {shape} g{groups} f32 interleaved, bound "
                  f"{bound:.4f} ms, F.group_norm {lib[i]:.4f} ms: " + ", ".join(
                      f"{name} {mean[name]:.4f} ({bound / mean[name]:.2f} of "
                      "the bound; " + " / ".join(
                          f"{t:.4f}" for t in times[name, kind]) + ")"
                      for name in names), flush=True)
        del x, dy, gamma, beta
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
