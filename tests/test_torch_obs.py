"""The port's observability and utility layer against the JAX package's:
``utils``, ``obs.logger``, ``obs.trace``'s ``tracing_to`` and
``FlightRecorder``, ``obs.timing``, ``obs.flops`` and ``obs.sanitizer``.

- the stdlib copies (the metrics logger and its sinks, ``tracing_to``,
  the flight recorder, ``RoundTimer`` on an injected clock) give the same
  rows, summaries, files and dumps as JAX's for the same calls, ``ts``
  present in every row;
- ``trace`` warns once and runs its body untraced when the profiler cannot
  start or stop, and writes a Chrome trace on the CPU;
- ``model_cost``: ``params`` equal to JAX's; ``flops`` of ``lr``, ``cnn``
  and a small ``transformer_lm`` (dense and flash attention) in the
  analytic band of ``tests/test_obs.py`` (analytic ≤ got ≤ 1.35 ×
  analytic) and within a stated ratio of JAX's XLA count; the flash and
  GroupNorm flop formulas counted, and missed without them;
- ``sanitized``'s strict and non-strict contract through
  ``CapturedStep.captures``, ``planned_transfer``'s nesting and threads on
  a recorded sync mode (the trap itself is inert without a card, and is
  held on the card by ``tests/test_torch_cuda.py``), ``DonationAudit``'s
  counting, and a FedAvg loop's steady state.
"""

import json
import logging
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import flop_counter

from fedml_tpu import utils as jutils
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.obs import flops as jflops
from fedml_tpu.obs import logger as jlogger
from fedml_tpu.obs import sanitizer as jsan
from fedml_tpu.obs import timing as jtiming
from fedml_tpu.obs import trace as jtrace
from fedml_tpu_torch import obs, utils
from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
from fedml_tpu_torch.core.graph import CapturedStep
from fedml_tpu_torch.data import build_federated_arrays, partition_homo
from fedml_tpu_torch.data.synthetic import make_classification
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs import flops, logger, sanitizer, timing
from fedml_tpu_torch.obs import trace as ttrace
from fedml_tpu_torch.ops.group_norm import group_norm
from fedml_tpu_torch.trainer.local import NetState


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_clock(values):
    it = iter(values)
    return lambda: next(it)


# --- utils and the metrics logger --------------------------------------------

def test_utils_match_jax(tmp_path, caplog):
    """``rss_mb`` reads the same live RSS as JAX's (one process, a few MB
    apart at most); ``raise_error`` logs the traceback and re-raises;
    ``get_lock`` holds the lock for its body; the sweep fifo without a
    reader returns."""
    assert abs(utils.rss_mb() - jutils.rss_mb()) < 50
    assert utils.rss_mb() > 1
    with caplog.at_level(logging.ERROR):
        with pytest.raises(ValueError):
            with utils.raise_error(logging.getLogger("t")):
                raise ValueError("boom")
    assert "ValueError: boom" in caplog.text
    lock = threading.Lock()
    with utils.get_lock(lock) as held:
        assert held is lock and lock.locked()
    assert not lock.locked()
    utils.post_complete_message_to_sweep_process(
        {"model": "lr"}, pipe_path=str(tmp_path / "sub" / "nobody"))
    assert os.path.exists(tmp_path / "sub" / "nobody")


def _log_calls(mod, run_dir):
    lg = mod.MetricsLogger.for_run(run_dir=run_dir, stdout=False)
    lg.log({"loss": 1.0}, step=0)
    lg.log({"evictions": 2, "retries": 0}, step=0, prefix="ctrl")
    lg.log({"loss": 0.5, "acc": 0.7}, step=1)
    lg.close()
    rows = [json.loads(line) for line in open(os.path.join(run_dir,
                                                           "metrics.jsonl"))]
    return lg, rows


def _no_ts(row):
    assert isinstance(row["ts"], float)
    return {k: v for k, v in row.items() if k != "ts"}


def test_metrics_logger_rows_and_summary_match_jax(tmp_path):
    got, got_rows = _log_calls(logger, str(tmp_path / "port"))
    want, want_rows = _log_calls(jlogger, str(tmp_path / "jax"))
    assert [_no_ts(r) for r in got.history] == [
        _no_ts(r) for r in want.history]
    assert [_no_ts(r) for r in got_rows] == [_no_ts(r) for r in want_rows]
    for row, hist in zip(got_rows, got.history):
        assert row["ts"] == hist["ts"]
    assert _no_ts(got.summary()) == _no_ts(want.summary())
    assert got.summary()["ctrl/evictions"] == 2


def test_metrics_logger_sinks_match_jax(caplog):
    """stdout on and a W&B project asked for: wandb is absent, so both
    packages warn and keep the stdout sink alone; the stdout sink logs the
    row."""
    with caplog.at_level(logging.INFO):
        got = logger.MetricsLogger.for_run(stdout=True, wandb_project="p")
        want = jlogger.MetricsLogger.for_run(stdout=True,
                                             wandb_project="p")
        got.log({"loss": 1.5}, step=3)
    assert [type(s).__name__ for s in got.sinks] == [
        type(s).__name__ for s in want.sinks] == ["StdoutSink"]
    assert "wandb unavailable" in caplog.text
    assert '"loss": 1.5' in caplog.text
    with pytest.raises(ImportError):
        logger.WandbSink("p")


# --- tracing_to and the flight recorder --------------------------------------

def test_tracing_to_files_match_jax(tmp_path):
    """The same spans on the same injected clock: both packages write
    ``trace<suffix>.chrome.json`` and ``.jsonl``, byte for byte equal, and
    restore the null tracer; a falsy directory writes nothing."""
    for mod, sub in ((ttrace, "port"), (jtrace, "jax")):
        run_dir = str(tmp_path / sub)
        with mod.tracing_to(run_dir, clock=_fake_clock(range(100)),
                            suffix=".rank1") as tr:
            assert mod.active() is tr
            with tr.span("round", corr={"round": 3}, clients=8):
                tr.instant("beat", sender=2)
            tr.complete("wire", 1.0, cat="wire", sender=1)
        assert mod.active() is mod.NULL
        with mod.tracing_to(None) as tr:
            assert tr is mod.NULL
    for name in ("trace.rank1.chrome.json", "trace.rank1.jsonl"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes()
    events = json.loads((tmp_path / "port" / "trace.rank1.chrome.json"
                         ).read_text())["traceEvents"]
    assert [e["name"] for e in events] == ["beat", "round", "wire"]


def test_flight_recorder_matches_jax(tmp_path, caplog):
    """A ring of 3 over 5 records, its dump byte-equal to JAX's; a dump
    with no path is None; a dump into a path under a regular file fails
    with a warning and returns None in both."""
    blocker = tmp_path / "file"
    blocker.write_text("x")
    for mod, sub in ((ttrace, "port"), (jtrace, "jax")):
        fr = mod.FlightRecorder(capacity=3, clock=_fake_clock(range(100)),
                                path=str(tmp_path / sub / "fr.jsonl"))
        for i in range(5):
            fr.record("beat", sender=i, epoch=1)
        assert [e["sender"] for e in fr.snapshot()] == [2, 3, 4]
        assert fr.dump() == str(tmp_path / sub / "fr.jsonl")
        assert mod.FlightRecorder().dump() is None
        with caplog.at_level(logging.WARNING):
            assert fr.dump(str(blocker / "fr.jsonl")) is None
    assert ((tmp_path / "port" / "fr.jsonl").read_bytes()
            == (tmp_path / "jax" / "fr.jsonl").read_bytes())
    assert caplog.text.count("flight recorder dump to") == 2


# --- RoundTimer and trace ----------------------------------------------------

def _timed(mod, monkeypatch, fence_arg):
    monkeypatch.setattr(mod.time, "perf_counter",
                        _fake_clock([0.0, 1.0, 1.5, 3.5, 4.0, 4.25, 5.0,
                                     5.5]))
    t = mod.RoundTimer()
    with t.phase("train"):
        t.fence(fence_arg)
    t.mark()
    with t.phase("train"):
        pass
    first = t.flat_metrics()
    with t.phase("eval"):
        pass
    t.mark()
    with t.phase("train"):
        pass
    return t.summary(), first, t.flat_metrics()


def test_round_timer_matches_jax(monkeypatch):
    """Phases on an injected clock: the summary (mean, total, n, last),
    and ``flat_metrics`` after ``mark`` reporting only the phases recorded
    since, as JAX's; ``fence`` of a CPU tree returns at once."""
    tree = {"w": torch.ones(3), "s": NetState({"b": torch.zeros(2)}, {}),
            "n": [1, None]}
    got = _timed(timing, monkeypatch, tree)
    want = _timed(jtiming, monkeypatch, {"w": jnp.ones(3)})
    assert got == want
    assert got[0]["train"] == {"mean_s": 3.5 / 3, "total_s": 3.5, "n": 3,
                               "last_s": 0.5}
    assert got[2] == {"time/train_s": 0.5}


def test_trace_warns_once_and_runs_untraced(monkeypatch, caplog):
    """A profiler that cannot start: the body runs, one warning for two
    uses; one whose stop fails: warned once as well (JAX's contract)."""
    import torch.profiler as tp

    monkeypatch.setattr(timing, "_WARNED", set())

    def boom(*a, **kw):
        raise RuntimeError("no profiler on this box")

    monkeypatch.setattr(tp, "profile", boom)
    ran = []
    with caplog.at_level(logging.WARNING, logger="fedml_tpu_torch.obs.timing"):
        with timing.trace("/nonexistent/a"):
            ran.append(1)
        with timing.trace("/nonexistent/a"):
            ran.append(2)
    assert ran == [1, 2]
    warns = [r for r in caplog.records if "start_trace failed" in r.message]
    assert len(warns) == 1 and "no profiler on this box" in warns[0].message

    class StopFails:
        def __init__(self, **_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            raise RuntimeError("stop failed")

    monkeypatch.setattr(timing, "_WARNED", set())
    monkeypatch.setattr(tp, "profile", StopFails)
    with caplog.at_level(logging.WARNING, logger="fedml_tpu_torch.obs.timing"):
        for _ in range(2):
            with timing.trace("/nonexistent/b"):
                pass
    stops = [r for r in caplog.records if "stop_trace failed" in r.message]
    assert len(stops) == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    with timing.trace(str(tmp_path / "prof")):
        a = torch.ones(16, 16)
        (a @ a).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].startswith("trace_")
    events = json.loads((tmp_path / "prof" / files[0]).read_text())[
        "traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_pads_its_window_only_on_a_card(tmp_path, monkeypatch):
    # The pad that keeps a card's kernels inside the profiler's window is
    # not paid by a CPU-only trace: a pad of 30 s would show in the time.
    monkeypatch.setattr(timing, "TRACE_PAD_S", 30.0)
    t0 = time.perf_counter()
    with timing.trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert time.perf_counter() - t0 < 30.0
    assert len(os.listdir(tmp_path / "prof")) == 1


# --- model_cost --------------------------------------------------------------

def _taps(n, k=5):
    half = k // 2
    return n * k - 2 * sum(range(1, half + 1))


LM = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, max_len=64)

# name: (port model, JAX model, sample, analytic flops) — the analytic
# counts of tests/test_obs.py (matrix products and convolutions, two
# flops a MAC; the CNN's at XLA's true taps, below the padded count).
B = 4
COST_CASES = {
    "lr": (lambda: create_model("lr", in_features=16, num_classes=4,
                                device="cpu"),
           lambda: jax_create_model("lr", num_classes=4),
           np.zeros((8, 16), np.float32), 8 * 16 * 4 * 2),
    "cnn": (lambda: create_model("cnn", num_classes=62, dropout=False,
                                 device="cpu"),
            lambda: jax_create_model("cnn", num_classes=62, dropout=False),
            np.zeros((B, 28, 28, 1), np.float32),
            B * 2 * (_taps(28) * _taps(28) * 1 * 32
                     + _taps(14) * _taps(14) * 32 * 64
                     + 7 * 7 * 64 * 512 + 512 * 62)),
    "transformer_lm": (
        lambda: create_model("transformer_lm", device="cpu", **LM),
        lambda: jax_create_model("transformer_lm", **LM),
        np.ones((B, 64), np.int32),
        B * 64 * 2 * (2 * (12 * 64 * 64 + 2 * 64 * 64) + 64 * 256)),
    "transformer_lm_flash": (
        lambda: create_model("transformer_lm", device="cpu", attn="flash",
                             **LM),
        lambda: jax_create_model("transformer_lm", attn="flash", **LM),
        np.ones((B, 64), np.int32),
        B * 64 * 2 * (2 * (12 * 64 * 64 + 2 * 64 * 64) + 64 * 256)),
}

# port / JAX flops: FlopCounterMode counts the products alone (the padded
# taps of a SAME convolution); XLA adds the elementwise work and counts a
# convolution's true taps.
JAX_RATIO = (0.75, 1.2)


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_model_cost_matches_jax_and_the_analytic_count(case):
    build, jbuild, x, analytic = COST_CASES[case]
    got = flops.model_cost(build(), x)
    want = jflops.model_cost(jbuild(), x)
    assert got["params"] == want["params"]
    assert analytic <= got["flops"] <= 1.35 * analytic, (got, analytic)
    ratio = got["flops"] / want["flops"]
    assert JAX_RATIO[0] <= ratio <= JAX_RATIO[1], (got, want)
    # Unfused: at least every parameter and the input read once.
    assert got["bytes_accessed"] >= 4 * got["params"] + x.nbytes
    assert flops.flops_str(got).endswith(" M params")


def _without(packet):
    class Popped:
        def __enter__(self):
            self.formula = flop_counter.flop_registry.pop(packet)

        def __exit__(self, *a):
            flop_counter.flop_registry[packet] = self.formula

    return Popped()


def test_flash_flop_formula_is_counted():
    """The flash forward's formula adds 4·B·H·T²·D a layer (the full
    square): the flash model counts as the dense one does, and without the
    formula the attention products are missed."""
    model = create_model("transformer_lm", device="cpu", attn="flash", **LM)
    x = np.ones((B, 64), np.int32)
    with_f = flops.model_cost(model, x)["flops"]
    with _without(torch.ops.fedml_tpu_torch.flash_fwd):
        without = flops.model_cost(model, x)["flops"]
    d = LM["d_model"]
    assert with_f - without == LM["n_layers"] * 4 * B * 64 * 64 * d


def test_group_norm_flop_formula_is_counted():
    """7 flops an element of the GroupNorm forward's input, and none
    without the formula; a GroupNorm ResNet counts more with it."""

    class Net(torch.nn.Module):
        def forward(self, x):
            return group_norm(x, torch.ones(8), torch.zeros(8), 4)

    x = np.zeros((2, 4, 4, 8), np.float32)
    assert flops.model_cost(Net(), x)["flops"] == 7 * x.size
    with _without(torch.ops.fedml_tpu_torch.group_norm_fwd):
        assert flops.model_cost(Net(), x)["flops"] == 0
    resnet = create_model("resnet20", num_classes=10, device="cpu")
    xr = np.zeros((2, 32, 32, 3), np.float32)
    with_f = flops.model_cost(resnet, xr)["flops"]
    with _without(torch.ops.fedml_tpu_torch.group_norm_fwd):
        assert flops.model_cost(resnet, xr)["flops"] < with_f


def test_count_params_and_flops_str_match_jax():
    tree = {"a": {"w": np.zeros((3, 4)), "b": np.zeros(4)}, "c": np.zeros(5)}
    assert flops.count_params(tree) == jflops.count_params(tree) == 21
    cost = {"flops": 3.0e9, "params": 1.5e6}
    assert flops.flops_str(cost) == jflops.flops_str(cost)


# --- the sanitizer -----------------------------------------------------------

def test_sanitized_strict_contract_through_captures(monkeypatch):
    """A capture in a strict region raises ``SanitizerError`` (an
    ``AssertionError``, as JAX's) naming bucket churn; none passes; the
    report reads the running count inside the region."""
    monkeypatch.setattr(CapturedStep, "captures", CapturedStep.captures)
    assert sanitizer.compile_count() == CapturedStep.captures
    with obs.sanitized() as rep:
        assert rep.compiles_so_far() == 0
    assert rep.compiles == 0 and rep.transfer == "disallow"
    with pytest.raises(sanitizer.SanitizerError, match="bucket churn"):
        with obs.sanitized():
            CapturedStep.captures += 1
    assert issubclass(sanitizer.SanitizerError, AssertionError)
    assert issubclass(jsan.SanitizerError, AssertionError)
    with obs.sanitized(max_compiles=1) as rep:
        CapturedStep.captures += 1
        assert rep.compiles_so_far() == 1
    assert rep.compiles == 1


def test_sanitized_non_strict_reports_and_jax_agrees(monkeypatch):
    """Non-strict: the region's captures are reported, nothing raised;
    JAX's non-strict region reports its compile the same way."""
    monkeypatch.setattr(CapturedStep, "captures", CapturedStep.captures)
    with obs.sanitized(transfer="allow", strict=False) as rep:
        CapturedStep.captures += 2
    assert (rep.compiles, rep.transfer, rep.max_compiles) == (2, "allow", 0)
    with pytest.raises(sanitizer.SanitizerError):
        rep.assert_clean()
    with jsan.sanitized(transfer="allow", strict=False) as jrep:
        jax.jit(lambda a: a * 3 + 1)(jnp.arange(7.0)).block_until_ready()
    assert jrep.compiles >= 1
    with pytest.raises(ValueError, match="transfer"):
        with obs.sanitized(transfer="forbid"):
            pass


class _RecordedModes:
    """A stand-in for the card's process-wide sync debug mode."""

    def __init__(self, monkeypatch):
        self.mode, self.sets = 0, []
        names = {"default": 0, "warn": 1, "error": 2}
        monkeypatch.setattr(sanitizer._SyncGuard, "armed",
                            staticmethod(lambda: True))
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                            lambda: self.mode)

        def set_mode(m):
            self.mode = names.get(m, m)
            self.sets.append(self.mode)

        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)


def test_planned_transfer_nests_inside_a_region(monkeypatch):
    """``disallow`` sets "error"; a planned block sets "default", a
    nested one keeps it, the outer one restores "error", the region's end
    the level before it, also when the body raises; ``log`` is "warn";
    outside any region a planned block sets nothing."""
    modes = _RecordedModes(monkeypatch)
    with obs.planned_transfer():
        pass
    assert modes.sets == []
    with obs.sanitized():
        assert modes.mode == 2
        with obs.planned_transfer():
            assert modes.mode == 0
            with obs.planned_transfer():
                assert modes.mode == 0
            assert modes.mode == 0
        assert modes.mode == 2
        with obs.sanitized(transfer="log"):
            assert modes.mode == 1
        assert modes.mode == 2
    assert modes.mode == 0
    with pytest.raises(RuntimeError):
        with obs.sanitized():
            raise RuntimeError("called a synchronizing CUDA operation")
    assert modes.mode == 0
    # A region that opens or closes while a planned block is open leaves
    # the block at "default" and applies its own level after it.
    with obs.planned_transfer():
        with obs.sanitized():
            assert modes.mode == 0
        assert modes.mode == 0
    assert modes.mode == 0
    with obs.planned_transfer():
        region = obs.sanitized()
        region.__enter__()
    assert modes.mode == 2
    region.__exit__(None, None, None)
    assert modes.mode == 0
    assert sanitizer.SYNC_MODES == {"disallow": "error", "log": "warn",
                                    "allow": "default"}


def test_planned_transfer_from_many_threads(monkeypatch):
    """Planned blocks opened and closed by 8 threads at once inside one
    region: the region's level holds after all of them, never a stale
    "default" (the count, not each block, restores it)."""
    import sys

    modes = _RecordedModes(monkeypatch)
    errors = []

    def work():
        try:
            for _ in range(200):
                with obs.planned_transfer():
                    assert modes.mode == 0
        except AssertionError as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.sanitized():
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert modes.mode == 2
    finally:
        sys.setswitchinterval(interval)
    assert not errors and modes.mode == 0


def test_sync_trap_is_inert_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py holds it")
    with obs.sanitized():
        assert torch.ones(2).sum().item() == 2.0
        with obs.planned_transfer():
            pass


def test_donation_audit_counts_copies_once_per_buffer():
    """The template alone is one copy; a clone adds one, another handle
    or a view of the same buffer adds nothing, a tensor of another shape
    nothing; ``peak`` keeps the most."""
    template = NetState({"w": torch.randn(4, 3), "b": torch.randn(3)},
                        {"s": torch.zeros(3)})
    with obs.donation_audit(template) as audit:
        assert audit.sample() == pytest.approx(1.0)
        alias = template.params["w"].view(4, 3)
        other = torch.randn(5, 7)
        assert audit.sample() == pytest.approx(1.0)
        copy = {k: v.clone() for k, v in template.params.items()}
        n = audit.sample()
        # The params are 15 of the template's 18 elements.
        assert n == pytest.approx(1.0 + 15 / 18)
        del copy
        assert audit.sample() == pytest.approx(1.0)
    assert audit.peak == pytest.approx(1.0 + 15 / 18)
    assert alias.shape == (4, 3) and other.shape == (5, 7)


def test_fedavg_loop_steady_under_the_sanitizer():
    """Pipelined FedAvg rounds after a warm-up, in a strict region under
    the donation audit (the pin of ``tests/test_layout.py``): no capture,
    and the live model copies stay within 0.25 of the baseline."""
    x, y = make_classification(96, n_features=6, n_classes=3)
    fed = build_federated_arrays(x, y, partition_homo(96, 6), 8,
                                 device="cpu")
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=3,
                    comm_round=10, epochs=1, batch_size=8, lr=0.1)
    api = FedAvgAPI(create_model("lr", in_features=6, num_classes=3,
                                 device="cpu"), fed, None, cfg, device="cpu")
    api.train_rounds_pipelined(2)
    with obs.sanitized() as rep:
        with obs.donation_audit(api.net) as audit:
            baseline = audit.sample()
            for r in range(2, 6):
                api.train_rounds_pipelined(1, start_round=r)
                audit.sample()
    assert rep.compiles == 0
    assert baseline >= 1.0
    assert audit.peak <= baseline + 0.25, (audit.peak, baseline)
