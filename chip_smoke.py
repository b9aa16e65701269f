#!/usr/bin/env python3
"""Drives the PyTorch/H100 port (fedml_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. build   — compiles the CUDA kernels from fedml_tpu_torch/ops/csrc.
2. kernels — each kernel against its plain PyTorch twin on the card, at
             the serving shape and two extra cases; times the kernel, the
             twin and one PyTorch library call of the same function, and
             computes the card's bound for the same work.
3. serve   — the serving path at full width: transformer_lm d_model 512,
             8 heads, 4 layers, T 2048 (flash attention), rank-8 adapters
             over all projections, a PersonalAdapterStore of 512 clients,
             16 requests through ServeManager with decode. Launch counts
             are zeroed just before and read just after; one batch's
             prefill is re-run with the plain attention and held to a
             bf16 bound.
4. report  — a ``kernels`` JSON line, the card's name and power limit,
             and as the last line ``{"ok": true, "device": {...}}``.

Weights are random, made from fixed seeds. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# Serving configuration: the width of bench.py's transformer section with
# the adapter rank docs/SERVING.md drives, at the flash crossover length.
VOCAB, D_MODEL, N_HEADS, N_LAYERS, SEQ_LEN, N_NEW = 10004, 512, 8, 4, 2048, 8
MAX_BATCH, N_CLIENTS, N_PERSONAL, N_REQUESTS = 8, 512, 128, 16
# Kernel-vs-plain bounds: o in the input dtype against the f32 twin; the
# kernel rounds P to bf16 before P·V (as the TPU kernel does).
O_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-3
# Served logits, flash kernel vs plain attention, both bf16 end to end
# over 4 layers: a few bf16 ulps (2^-6 at |logit| in [2, 4)) per layer.
LOGITS_TOL = 0.25

# Published dense peaks by SKU (NVIDIA data sheets): bf16 tensor-core
# FLOP/s, fp32 non-tensor FLOP/s, HBM bytes/s.
PEAKS = {
    "H100 80GB HBM3": (989e12, 67e12, 3.35e12),  # SXM
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
    "H200": (989e12, 67e12, 4.8e12),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for sku, peaks in PEAKS.items():
        if sku in name:
            return sku, peaks
    raise SmokeFailure(f"no published peaks for {name!r}")


def time_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median CUDA-event time of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build():
    from fedml_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.extension()
    print(f"[build] extension built in {time.perf_counter() - t0:.1f} s "
          f"from {build.CSRC}", flush=True)


def phase_kernels(peaks):
    """Flash forward vs its plain twin; returns the kernels-line entry."""
    import torch.nn.functional as F

    from fedml_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(8, 2048, 8, 64, torch.bfloat16, True),
             (8, 2048, 8, 64, torch.bfloat16, False),
             (2, 1000, 8, 64, torch.float32, True)]
    main = None
    for b, t, h, d, dtype, causal in cases:
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g)
                   .to(dtype) for _ in range(3))
        o, lse = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        po, plse = flash_attention_plain(q.float(), k.float(), v.float(),
                                         causal)
        err_o = (o.float() - po).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        name = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]} causal={causal}"
        print(f"[kernels] flash_fwd {name}: max|o-plain| {err_o:.3e} "
              f"(tol {O_TOL[dtype]:.0e}), max|lse-plain| {err_lse:.3e} "
              f"(tol {LSE_TOL:.0e})", flush=True)
        check(math.isfinite(err_o) and err_o <= O_TOL[dtype],
              f"flash_fwd o disagrees with plain: {err_o} ({name})")
        check(math.isfinite(err_lse) and err_lse <= LSE_TOL,
              f"flash_fwd lse disagrees with plain: {err_lse} ({name})")
        if main is None:
            main = (q, k, v, err_o)
    q, k, v, err_o = main
    b, t, h, d = q.shape
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    pairs = t * (t + 1) // 2  # causal (query, key) pairs per head
    flops = 4 * b * h * d * pairs  # Q·Kᵀ and P·V, 2 FLOP per multiply-add
    nbytes = 4 * q.numel() * q.element_size() + b * h * t * 4
    bf16_peak, _, hbm = peaks
    t_ops, t_bytes = flops / bf16_peak * 1e3, nbytes / hbm * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"[kernels] flash_fwd B={b} T={t} H={h} D={d} bf16 causal: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms; {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB -> bound {bound_ms * 1e3:.2f} us "
          f"(ops {t_ops * 1e3:.2f} us, bytes {t_bytes * 1e3:.2f} us); "
          f"kernel at {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "fedml_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "fedml_tpu/ops/flash_attention.py:78",
            "launches": None, "max_abs_err": err_o, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def _random_adapters(model, gen):
    """Adapters with non-zero A and B (flax's init has B = 0)."""
    def fill(tree):
        return {k: fill(v) if isinstance(v, dict)
                else (torch.randn(v.shape, generator=gen) * 0.02).to(v.device)
                for k, v in tree.items()}

    return fill(model.init_adapters(gen))


def phase_serve():
    """The serving path end to end; returns {kernel name: launches}."""
    from fedml_tpu_torch.core.flat import tree_to_vector_np
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.adapter import (PersonalAdapterStore,
                                                adapter_model_fns)
    from fedml_tpu_torch.obs import trace as obs_trace
    from fedml_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from fedml_tpu_torch.serve import (AdapterDecoder, ServeForward,
                                       ServeManager, pick_attention)

    kw = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=N_HEADS,
              n_layers=N_LAYERS, max_len=SEQ_LEN + N_NEW, dtype="bf16",
              adapter_rank=8, adapter_scope="all")
    gen = torch.Generator().manual_seed(SEED)
    attn = pick_attention(SEQ_LEN)
    check(attn == "flash", f"pick_attention({SEQ_LEN}) gave {attn}")
    model = create_model("transformer_lm", attn=attn, generator=gen, **kw)
    fns = adapter_model_fns(model)
    glob = _random_adapters(model, gen)
    store = PersonalAdapterStore(N_CLIENTS, glob)
    rng = np.random.default_rng(SEED)
    glob_vec = tree_to_vector_np(glob)
    store.scatter(np.arange(N_PERSONAL), glob_vec[None] + rng.normal(
        0, 0.02, (N_PERSONAL, store.dim)).astype(np.float32))
    fwd = ServeForward(fns, glob)
    dec = AdapterDecoder(model, fns, glob)
    print(f"[serve] transformer_lm d_model {D_MODEL}, {N_HEADS} heads, "
          f"{N_LAYERS} layers, vocab {VOCAB}, T {SEQ_LEN}, attn {attn}, "
          f"bf16; adapters rank 8 scope all, dim {store.dim}; store "
          f"{N_CLIENTS} clients ({N_PERSONAL} personalized)", flush=True)

    # Requests: even i full length, odd i shorter; the first half on
    # personalized ids, the second half on never-personalized ids.
    reqs_in = []
    for i in range(N_REQUESTS):
        n = SEQ_LEN if i % 2 == 0 else int(rng.integers(SEQ_LEN // 4,
                                                         SEQ_LEN))
        cid = (int(rng.integers(0, N_PERSONAL)) if i < N_REQUESTS // 2
               else int(rng.integers(N_PERSONAL, N_CLIENTS)))
        reqs_in.append((cid, rng.integers(0, VOCAB, n).astype(np.int32)))

    # Warm-up outside the counted run (cuBLAS handles, allocator).
    warm = np.zeros((MAX_BATCH, SEQ_LEN), np.int32)
    st = fwd.stacked_tree(np.tile(glob_vec, (MAX_BATCH, 1)))
    fwd.batched(st, warm)
    dec.generate(st, warm, 1)
    torch.cuda.synchronize()

    mgr = ServeManager(fwd, store, glob, seq_len=SEQ_LEN,
                       max_batch=MAX_BATCH, deadline_s=0.01, decoder=dec)
    tracer = obs_trace.SpanTracer()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    with obs_trace.using(tracer), mgr:
        reqs = [mgr.submit(cid, toks, max_new_tokens=N_NEW)
                for cid, toks in reqs_in]
        results = [r.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches}
    stats = mgr.stats()
    batches = int(stats["serve/batch_fill_count"])
    print(f"[serve] {N_REQUESTS} requests in {batches} batches, "
          f"{wall:.3f} s wall; flash_fwd launches {launches['flash_fwd']} "
          f"(expected {N_LAYERS} x {batches})", flush=True)
    check(stats.get("serve/served") == N_REQUESTS,
          f"served {stats.get('serve/served')} of {N_REQUESTS}")
    check(launches["flash_fwd"] == N_LAYERS * batches,
          f"flash_fwd launched {launches['flash_fwd']} times, expected "
          f"{N_LAYERS * batches}")
    for (cid, toks), (logits, generated) in zip(reqs_in, results):
        check(logits.shape == (len(toks), VOCAB),
              f"logits shape {logits.shape} for a {len(toks)}-token prompt")
        check(bool(np.isfinite(logits).all()), "non-finite served logits")
        check(generated.shape == (N_NEW,)
              and bool(((generated >= 0) & (generated < VOCAB)).all()),
              f"generated tokens out of the vocab: {generated}")
    print(f"[serve] stats: latency p50 {stats['serve/latency_ms_p50']} ms, "
          f"p95 {stats['serve/latency_ms_p95']} ms, batch fill mean "
          f"{stats['serve/batch_fill_mean']} of {MAX_BATCH}", flush=True)
    spans = {}
    for ev in tracer.events():
        spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    print("[serve] spans (host clock, ms per batch): " + ", ".join(
        f"{name} {' / '.join(f'{d:.1f}' for d in durs)}"
        for name, durs in sorted(spans.items())), flush=True)

    # One batch's prefill again, flash kernel vs the plain attention.
    tokens = np.zeros((MAX_BATCH, SEQ_LEN), np.int32)
    lens = np.array([len(t) for _, t in reqs_in[:MAX_BATCH]])
    for i, (_, toks) in enumerate(reqs_in[:MAX_BATCH]):
        tokens[i, :len(toks)] = toks
    vecs = store.gather([c for c, _ in reqs_in[:MAX_BATCH]], glob)
    twin = create_model(
        "transformer_lm", generator=None,
        attn_fn=lambda q, k, v, causal: flash_attention_plain(
            q, k, v, causal)[0], **kw)
    twin.load_state_dict(model.state_dict())
    twin_fwd = ServeForward(adapter_model_fns(twin), glob)
    got = fwd.prefill(vecs, tokens)
    want = twin_fwd.prefill(vecs, tokens)
    err = max((got[i, :n] - want[i, :n]).abs().max().item()
              for i, n in enumerate(lens))
    scale = max(want[i, :n].abs().max().item() for i, n in enumerate(lens))
    print(f"[serve] prefill logits flash vs plain attention (bf16): "
          f"max|diff| {err:.4e} (tol {LOGITS_TOL}), max|logit| "
          f"{scale:.3f}", flush=True)
    check(math.isfinite(err) and err <= LOGITS_TOL,
          f"flash prefill logits disagree with plain: {err}")
    del twin, twin_fwd, want

    st = fwd.stacked_tree(vecs)
    prefill_ms = time_ms(lambda: fwd.batched(st, tokens), warmup=1, reps=5)
    d2h_ms = time_ms(lambda: fwd.batched(st, tokens).cpu(), warmup=1,
                     reps=5) - prefill_ms
    dec_prefill_ms = time_ms(lambda: dec.prefill(st, tokens, lens=lens),
                             warmup=1, reps=3)
    _, cache = dec.prefill(st, tokens, lens=lens)
    nxt = torch.zeros(MAX_BATCH, dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_NEW):
        logits, cache = dec.step(st, nxt, cache)
        nxt = logits.argmax(-1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / N_NEW
    print(f"[serve] prefill (batched forward, {MAX_BATCH} x {SEQ_LEN}) "
          f"{prefill_ms:.3f} ms, + {d2h_ms:.3f} ms to copy its logits to "
          f"the host; decoder's own dense prefill {dec_prefill_ms:.3f} ms; "
          f"decode {step_ms:.3f} ms per step of "
          f"{MAX_BATCH} rows = {MAX_BATCH * 1e3 / step_ms:.1f} tokens/s",
          flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    smi = smi_line()
    sku, peaks = peaks_for(smi.split(",")[0])
    print(f"[setup] card {smi}; peaks for {sku}: bf16 {peaks[0] / 1e12:.0f}"
          f" TFLOP/s, fp32 {peaks[1] / 1e12:.0f} TFLOP/s, HBM "
          f"{peaks[2] / 1e12:.2f} TB/s", flush=True)
    phase_build()
    entry = phase_kernels(peaks)
    launches = phase_serve()
    entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": [entry]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
