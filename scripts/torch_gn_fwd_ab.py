#!/usr/bin/env python3
"""Times the port's GroupNorm forward from several builds of its kernels
on one NVIDIA card, in turns, at the shapes of ResNet-56's training path.

    python scripts/torch_gn_fwd_ab.py [--tree NAME=DIR ...] \
        [--target-kb KB ...]

The working tree's build (``fedml_tpu_torch/ops/csrc``) is always timed, as
``this``. Each ``--tree`` adds a copy of ``fedml_tpu_torch/ops/csrc`` from
another commit, unpacked for example with

    git archive <commit> fedml_tpu_torch/ops/csrc \\
        | tar -x -C .scratch/parent --strip-components=3

and each ``--target-kb`` a copy of the working sources whose cluster
planner aims at that many KB of x per block (``kTargetBytes``). Copies
and builds go under ``.scratch/gn_fwd_ab/`` (git-ignored), built in
parallel. Each build's forward runs once against the plain twin (bf16
bound: 2^-8 relative + 1e-5 of the scale), then is timed as a replayed
CUDA graph (``chip_smoke.graph_ms``) at ``[256, 1024, 64]`` bf16 g32 with
one row of γ/β and at every ``chip_smoke.GN_STEP`` shape with 8 clients'
rows in the training path's interleaved layout, the builds in the order
A..Z then Z..A. Prints each shape's mean per build beside its bound, and
the sum of launches x ms per local step.
"""

from __future__ import annotations

import argparse
import glob
import multiprocessing
import os
import re
import shutil
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, ".scratch", "gn_fwd_ab")
TARGET = re.compile(r"constexpr size_t kTargetBytes = \d+ \* 1024;")


def _load(name, src):
    from torch.utils.cpp_extension import load

    out = os.path.join(WORK, "build", name)
    os.makedirs(out, exist_ok=True)
    return load(name=f"gn_fwd_ab_{name}",
                sources=sorted(glob.glob(os.path.join(src, "*.cpp"))
                               + glob.glob(os.path.join(src, "*.cu"))),
                build_directory=out,
                extra_cuda_cflags=["-O3",
                                   "-gencode=arch=compute_90a,code=sm_90a"])


def _build(item):
    _load(*item)
    return item[0]


def _trees(args):
    """{name: csrc directory}, making the planner copies."""
    here = os.path.join(ROOT, "fedml_tpu_torch", "ops", "csrc")
    trees = {"this": here}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = os.path.abspath(path)
    for kb in args.target_kb:
        dst = os.path.join(WORK, f"t{kb}")
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(here, dst)
        path = os.path.join(dst, "group_norm.cu")
        with open(path) as f:
            src, n = TARGET.subn(
                f"constexpr size_t kTargetBytes = {kb} * 1024;", f.read())
        if n != 1:
            raise SystemExit(f"no kTargetBytes line in {path}")
        with open(path, "w") as f:
            f.write(src)
        trees[f"t{kb}"] = dst
    return trees


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="NAME=DIR: a copy of fedml_tpu_torch/ops/csrc")
    p.add_argument("--target-kb", type=int, nargs="*", default=[])
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_gn_fwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from fedml_tpu_torch.ops import group_norm as gn

    trees = _trees(args)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(trees)) as pool:
        for name in pool.imap_unordered(_build, trees.items()):
            print(f"[ab] built {name}", flush=True)
    exts = {name: _load(name, src) for name, src in trees.items()}

    def fwd(ext):  # an earlier binding returns y, a later (y, streamed)
        def run(x, g, b, grp):
            out = ext.group_norm_fwd(x, g, b, grp, gn.EPS)
            return out[0] if isinstance(out, tuple) else out
        return run

    runs = {name: fwd(ext) for name, ext in exts.items()}
    names = list(runs)
    smi = cs.smi_line()
    peaks = cs.peaks_for(smi.split(",")[0])[1]
    print(f"[ab] card {smi}; builds {names}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cases = [(cs.GN_MAIN[0], cs.GN_MAIN[1], 0, 1, False)] + [
        (shape, grp, n, 8, True) for shape, grp, n in cs.GN_STEP]
    step = dict.fromkeys(names, 0.0)
    step_bound = 0.0
    for shape, grp, per_step, rows, inter in cases:
        x, _, gamma, beta = cs._gn_inputs(shape, rows, torch.bfloat16, gen,
                                          inter)
        want = gn.group_norm_fwd_plain(x.float(), gamma, beta, grp)
        bound = cs._gn_bound("fwd", x, peaks)[0]
        step_bound += per_step * bound
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            run = runs[name]
            y = run(x, gamma, beta, grp)
            torch.cuda.synchronize()
            err, ok = cs._gn_err(y, want, torch.bfloat16)
            cs.check(ok, f"{name} disagrees with the twin at {shape}: {err}")
            times[name].append(cs.graph_ms(
                lambda: run(x, gamma, beta, grp)))
        mean = {name: sum(t) / len(t) for name, t in times.items()}
        for name in names:
            step[name] += per_step * mean[name]
        print(f"[ab] {list(shape)} g{grp} R{rows}"
              f"{' interleaved' if inter else ''}, {per_step} per step, "
              f"bound {bound:.4f} ms: " + ", ".join(
                  f"{name} {mean[name]:.4f} ("
                  + " / ".join(f"{t:.4f}" for t in times[name]) + ")"
                  for name in names), flush=True)
        del x, gamma, beta, want
    print(f"[ab] per local step, sum of launches x ms (bound "
          f"{step_bound:.4f} ms): " + ", ".join(
              f"{name} {v:.4f}" for name, v in step.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
