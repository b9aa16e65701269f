"""The port's experiment CLI (``fedml_tpu_torch/exp``) against the JAX
package's (``fedml_tpu/exp``).

The flags are JAX's plus ``--device`` (``cuda`` by default), so one argv
gives both packages the same ``FedConfig``; ``round_lr`` is the same
schedule; ``create_model_for`` builds each supported (model, dataset) pair
with JAX's parameter count, the registry holds every name of JAX's (an
unknown one raises JAX's ``KeyError``); every flag the port has not
ported is refused by name with its ROADMAP.md queue, and the guards that
JAX's runner raises itself keep JAX's words. ``run`` over ``--model lr
--dataset synthetic_1_1`` with full participation and a batch that holds
each client whole (the epoch shuffles then only reorder a sum) gives JAX's
history within 1e-5, starting from JAX's weights (``create_model_for`` is
patched in the test to carry them across), and again under ``--dp_clip``
with JAX's noise carried through the trainer's ``dp_noise`` seam. One
subprocess runs ``python -m fedml_tpu_torch.exp.main_fedavg ... --device
cpu`` and prints its JSON last line; without ``--device`` and with no card
the run raises.
"""

import argparse
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.exp.args as jax_args
import fedml_tpu.exp.setup as jax_setup
import fedml_tpu_torch.algos.fedavg as port_fedavg
import fedml_tpu_torch.exp.args as port_args
import fedml_tpu_torch.exp.setup as port_setup
from fedml_tpu_torch.convert import from_jax_params
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.exp import main_centralized, main_extra
from fedml_tpu_torch.trainer import local as port_local
from test_torch_privacy import _jax_draws, _port_noise_keys, noise_seam

# The packages' ``exp.run`` attribute is the function run(): the modules
# are imported by name.
jax_run = importlib.import_module("fedml_tpu.exp.run")
port_run = importlib.import_module("fedml_tpu_torch.exp.run")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR_ARGV = ["--model", "lr", "--dataset", "synthetic_1_1",
           "--client_num_in_total", "5", "--client_num_per_round", "5",
           "--batch_size", "384", "--lr", "0.1", "--epochs", "2",
           "--comm_round", "3", "--frequency_of_the_test", "1",
           "--seed", "3"]


@pytest.mark.parametrize("argv", [
    [],
    ["--model", "resnet56", "--dataset", "cifar10", "--partition_method",
     "hetero", "--partition_alpha", "0.5", "--client_num_in_total", "10",
     "--batch_size", "64", "--lr", "0.03", "--epochs", "5",
     "--comm_round", "100"],
    ["--dp_clip", "1.0", "--dp_noise_multiplier", "1.1", "--remat",
     "--client_optimizer", "adam", "--wd", "0.001", "--lr_schedule",
     "cosine", "--grad_clip", "5", "--compress", "q8",
     "--client_selection", "pow_d", "--pow_d_candidates", "16",
     "--aggregator", "krum1", "--client_step_dtype", "bf16",
     "--adapter_rank", "8", "--adapter_scope", "all",
     "--checkpoint_frequency", "2", "--trace", "--server_optimizer", "adam",
     "--server_lr", "0.05", "--fedprox_mu", "0.01"],
])
def test_config_from_args_equals_jax(argv):
    got = port_args.config_from_args(port_args.parse_args(argv))
    want = jax_args.config_from_args(jax_args.parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_flags_are_jax_flags_and_device():
    def flags(mod):
        parser = argparse.ArgumentParser()
        mod.add_args(parser)
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}

    port, jax_flags = flags(port_args), flags(jax_args)
    assert port.pop("device") == "cuda"
    assert port == jax_flags


@pytest.mark.parametrize("schedule", ["none", "cosine", "step"])
def test_round_lr_equals_jax(schedule):
    for r in range(0, 120, 7):
        for total in (1, 10, 100):
            assert port_run.round_lr(0.03, schedule, r, total) \
                == jax_run.round_lr(0.03, schedule, r, total)
    with pytest.raises(ValueError, match="lr_schedule"):
        port_run.round_lr(0.1, "linear", 0, 10)


def _port_count(model):
    return sum(p.numel() for p in model.parameters())


def _jax_count(module, x0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + tuple(x0.shape[1:]),
                                      jnp.asarray(x0).dtype))
    return sum(int(np.prod(s.shape))
               for s in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("model,dataset", [
    ("lr", "synthetic_1_1"), ("lr", "mnist"), ("resnet10_gn", "fed_cifar100"),
    ("cnn", "femnist"), ("rnn", "shakespeare"), ("rnn", "fed_shakespeare"),
    ("rnn_stackoverflow", "stackoverflow_nwp"), ("resnet56", "cifar10"),
    ("resnet20", "cifar100"), ("resnet18_gn", "fed_cifar100"),
    ("transformer_lm", "shakespeare"), ("mobilenet", "cifar10"),
    ("mobilenet_v3", "cifar100"), ("efficientnet", "cinic10"),
    ("vgg11", "cifar10"), ("vgg16_bn", "cifar10"), ("vgg19_gn", "cifar100")])
def test_create_model_for_counts_jax_params(model, dataset):
    argv = ["--model", model, "--dataset", dataset, "--device", "cpu",
            "--synthetic_samples", "64", "--client_num_in_total", "3"]
    args = port_args.parse_args(argv)
    fed = port_setup.load_data(args)
    x0 = fed.train_data_global[0][0]
    port = port_setup.create_model_for(args, fed)
    jargs = jax_args.parse_args(argv[:4] + argv[6:])
    jmodule = jax_setup.create_model_for(jargs, fed)
    assert _port_count(port) == _jax_count(jmodule, x0)
    assert next(port.parameters()).device.type == "cpu"


def _refused(argv, match, runner=None):
    with pytest.raises(NotImplementedError, match=match):
        (runner or (lambda a: port_run.run(port_args.parse_args(a))))(argv)


@pytest.mark.parametrize("flag,value,label", [
    ("--num_devices", "8", "A11"), ("--dcn_hosts", "2", "A11"),
    ("--group_reduce", None, "A11"), ("--wire_codec", "int8", "A10"),
    ("--ingest_workers", "2", "A10")])
def test_unported_flags_refused_by_name(flag, value, label):
    argv = LR_ARGV + ["--device", "cpu", flag] + ([value] if value else [])
    if label == "A10":
        # Ported since A10a landed, on the cross-silo CLI: the simulator
        # runner refuses the flag in the JAX package's words.
        jargv = LR_ARGV + [flag] + ([value] if value else [])
        with pytest.raises((NotImplementedError, SystemExit)) as want:
            jax_run.run(jax_args.parse_args(jargv))
        with pytest.raises(type(want.value)) as got:
            port_run.run(port_args.parse_args(argv))
        assert str(got.value) == str(want.value)
        return
    match = rf"{flag} .*ROADMAP\.md {label}"
    _refused(argv, match)
    if flag not in ("--group_reduce", "--dcn_hosts"):
        # The centralized baseline refuses the pod plane with JAX's words
        # first, then the rest by queue.
        _refused(argv, match, main_centralized.main)


def test_registry_holds_every_jax_name():
    import fedml_tpu.models.registry as jax_registry
    import fedml_tpu_torch.models.registry as port_registry

    for reg in (jax_registry, port_registry):
        with pytest.raises(KeyError):
            reg.create_model("no such model")
    assert sorted(port_registry._REGISTRY) == sorted(jax_registry._REGISTRY)


def test_unknown_model_vgg_raises_jax_key_error():
    """``--model vgg`` (no such registry name: VGG registers ``vgg11`` …
    ``vgg19_gn``) fails in both packages with the same ``KeyError``."""
    argv = ["--model", "vgg", "--dataset", "cifar10", "--synthetic_samples",
            "64", "--client_num_in_total", "3"]
    args = port_args.parse_args(argv + ["--device", "cpu"])
    fed = port_setup.load_data(args)
    with pytest.raises(KeyError) as want:
        jax_setup.create_model_for(jax_args.parse_args(argv), fed)
    with pytest.raises(KeyError) as got:
        port_setup.create_model_for(args, fed)
    assert "unknown model 'vgg'" in str(want.value)
    assert str(got.value) == str(want.value)
    with pytest.raises(KeyError) as run_got:
        port_run.run(args)
    assert str(run_got.value) == str(want.value)


@pytest.mark.parametrize("extra", [
    ["--backend", "loopback"], ["--buffer_k", "3"], ["--serve"],
    ["--secagg"], ["--controller", "adaptive"], ["--agg_shards", "2"],
    ["--fedasync_alpha", "0.5"], ["--adapter_rank", "4"]])
def test_jax_guards_keep_jax_words(extra):
    argv = LR_ARGV + extra
    with pytest.raises((NotImplementedError, SystemExit)) as want:
        jax_run.run(jax_args.parse_args(argv))
    with pytest.raises(type(want.value)) as got:
        port_run.run(port_args.parse_args(argv + ["--device", "cpu"]))
    assert str(got.value).replace("fedml_tpu_torch", "fedml_tpu") \
        .split(" (not ported yet")[0] == str(want.value)


def test_main_extra_refuses_the_message_passing_runners():
    """The message-passing runners are ported (the asynchronous tiers),
    and take the adaptive controller: ``--controller adaptive`` runs
    FedAsync and FedBuff to ``--comm_round`` versions; an unknown
    controller kind exits in JAX's words."""
    assert main_extra.UNPORTED_RUNNERS == ()
    for algo in ("FedAsync", "FedBuff", "BaseFramework"):
        assert algo in main_extra.RUNNERS
    argv = LR_ARGV + ["--device", "cpu", "--client_num_per_round", "2",
                      "--controller", "adaptive"]
    for algo in ("FedAsync", "FedBuff"):
        history = main_extra.main(["--algorithm", algo] + argv)
        assert history[-1]["version"] == 3
    from fedml_tpu import ctrl as jctrl
    from fedml_tpu_torch import ctrl as pctrl

    flags = type("Flags", (), {"controller": "bandit"})()
    with pytest.raises(SystemExit) as want:
        jctrl.controller_from_args(flags)
    with pytest.raises(SystemExit) as got:
        pctrl.controller_from_args(flags)
    assert str(got.value) == str(want.value)


def _jax_init(seed, d, k):
    module = jax_setup.create_model_for(
        jax_args.parse_args(["--model", "lr", "--dataset", "synthetic_1_1"]),
        type("F", (), {"class_num": k,
                       "train_data_global": [(np.zeros((1, d)),)]})())
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    return module.init(init_rng, jnp.zeros((1, d)))["params"]


def _carry_jax_weights(monkeypatch, jparams):
    real = port_setup.create_model_for

    def carried(args, fed):
        model = real(args, fed)
        state, _ = from_jax_params(jax.tree.map(np.asarray, jparams))
        model.load_state_dict(state)
        return model

    monkeypatch.setattr(port_setup, "create_model_for", carried)


def _history_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        for k in ("train_loss", "loss", "accuracy", "num"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("dp", [False, True], ids=["plain", "dp"])
def test_run_matches_jax_history(monkeypatch, dp):
    argv = LR_ARGV + (["--dp_clip", "0.5", "--dp_noise_multiplier", "1.1"]
                      if dp else [])
    _, want = jax_run.run(jax_args.parse_args(argv))
    jparams = _jax_init(3, 60, 10)
    _carry_jax_weights(monkeypatch, jparams)
    if dp:
        # JAX's draws of every round, client and epoch (one step each),
        # keyed by the port's noise key of the same step.
        jrng = jax.random.split(jax.random.PRNGKey(3))[0]
        prng = keys.split(keys.key(3))[0]
        table_keys, trees = [], []
        for _ in range(3):
            jrng, jrnd = jax.random.split(jrng)
            pair = keys.split(prng)
            prng, prnd = pair[0], pair[1]
            for c in range(5):
                pk = _port_noise_keys(keys.fold_in(prnd, c), 2, 1)
                for e, s, tree in _jax_draws(jax.random.fold_in(jrnd, c), 2,
                                             1, jparams):
                    table_keys.append(pk[e, s])
                    trees.append(tree)
        seam = noise_seam(torch.stack(table_keys), trees)
        monkeypatch.setattr(
            port_fedavg, "make_local_train_fn_from_cfg",
            lambda *a, **kw: port_local.make_local_train_fn_from_cfg(
                *a, dp_noise=seam, **kw))
    api, got = port_run.run(port_args.parse_args(argv + ["--device", "cpu"]))
    assert api.local_train.dp_clip == (0.5 if dp else 0.0)
    _history_close(got, want)


def test_main_centralized_trains_dp_through_its_config(capsys):
    trainer, hist = main_centralized.main(
        ["--model", "lr", "--dataset", "synthetic_1_1", "--batch_size", "64",
         "--comm_round", "2", "--dp_clip", "0.5", "--dp_noise_multiplier",
         "1.1", "--remat", "--device", "cpu"])
    assert trainer.train_fn.dp_clip == 0.5 and trainer.train_fn.remat
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == hist[-1] and np.isfinite(last["train_loss"])


@pytest.mark.parametrize("algo", ["Decentralized", "VFL"])
def test_main_extra_runs(algo, capsys):
    hist = main_extra.main(["--algorithm", algo, "--dataset",
                            "synthetic_1_1", "--client_num_in_total", "4",
                            "--batch_size", "32", "--comm_round", "2",
                            "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(last["train_loss"]) and len(hist) == 2


def test_without_device_and_card_the_run_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_run.run(port_args.parse_args(LR_ARGV))


def test_main_fedavg_subprocess_prints_json_last():
    out = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.exp.main_fedavg",
         *LR_ARGV[:-4], "--comm_round", "1", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["round"] == 0 and np.isfinite(last["train_loss"])
