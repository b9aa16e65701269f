"""Per-rank cross-silo FedAvg entry (port of
``fedml_tpu/exp/main_cross_silo.py``) — the reference's mpirun story with
separate OS processes over the native TCP transport.

The reference launches `mpirun -np W+1 python main_fedavg.py` and every rank
runs the same program (run_fedavg_distributed_pytorch.sh:21). Here each silo
process runs:

    python -m fedml_tpu_torch.exp.main_cross_silo --rank 0 --size 3 \
        --host_table hosts.csv --model lr --dataset mnist ...   # server
    python -m fedml_tpu_torch.exp.main_cross_silo --rank 1 --size 3 ...
    python -m fedml_tpu_torch.exp.main_cross_silo --rank 2 --size 3 ...

``--host_table`` is the grpc_ipconfig.csv-format rank→host[,port] table
(defaults: every rank on 127.0.0.1 with port ``--port_base``+rank). Every
rank loads the dataset with identical flags/seed (as the reference does,
main_fedavg.py:133 — "every rank loads the full dataset"), so client shards
agree across processes without shipping data.

Each rank runs on ``--device`` (``cuda`` by default; ``cpu`` as the tests
ask): a silo trains there through one captured local step, the server
folds and evaluates there. The server prints one JSON line with the final
test metrics, ``health()`` and the ingest profile when done; a silo
prints its rank and the launches of the hand-written kernels it ran.
``--secagg`` (with ``--ingest_workers`` > 0 on rank 0) masks every silo's
upload (comm/secagg.py). ``--comm_backend GRPC`` and ``TRPC`` are not
ported yet (ROADMAP.md A10d).
"""

from __future__ import annotations

import argparse
import json
import logging
import time

from fedml_tpu_torch.algos.fedavg_distributed import (
    FedAVGAggregator,
    FedAVGClientManager,
    FedAVGServerManager,
)
from fedml_tpu_torch.exp.args import add_args
from fedml_tpu_torch.trainer.local import (
    make_client_optimizer,
    make_eval_fn,
    make_local_train_fn_from_cfg,
    model_fns,
    softmax_ce,
)

DEFAULT_PORT_BASE = 50100

log = logging.getLogger(__name__)


def build_host_table(args):
    if args.host_table:
        from fedml_tpu_torch.comm.tcp import read_ip_config

        return read_ip_config(args.host_table, base_port=args.port_base)
    return {r: ("127.0.0.1", args.port_base + r) for r in range(args.size)}


def kernel_launches():
    """The launch counters of the hand-written kernels (GroupNorm's and
    flash attention's), by ``<wrapper>.<counter>``."""
    from fedml_tpu_torch.core import graph
    from fedml_tpu_torch.ops import flash_attention, group_norm  # noqa: F401

    return {f"{owner.__name__}.{name}": int(getattr(owner, name))
            for owner, name in graph._COUNTERS}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--size", type=int, required=True,
                        help="total processes = 1 server + W silos")
    parser.add_argument("--host_table", type=str, default=None,
                        help="grpc_ipconfig.csv-format rank,host[,port] table")
    parser.add_argument("--port_base", type=int, default=DEFAULT_PORT_BASE)
    parser.add_argument("--comm_backend", type=str, default="TCP",
                        choices=["TCP", "GRPC", "TRPC"],
                        help="cross-silo transport: native C++ msgnet TCP "
                             "(GRPC and TRPC: ROADMAP.md A10d)")
    # --compress comes from the shared add_args flag set: here it is the
    # legacy codec (none | topk<ratio> with error feedback | q<bits>
    # stochastic quantization), decoded by the server per frame.
    # --wire_codec (also shared) is the NEGOTIATED wire codec
    # (comm/codec.py), mutually exclusive with --compress.
    # --ingest_workers (also shared) arms the server's parallel ingest
    # pool (comm/ingest.py; rank 0 only — silos ignore it).
    # --secagg / --secagg_t (also shared) arm dropout-robust secure
    # aggregation (comm/secagg.py): pairwise-masked int64 uploads that
    # cancel exactly in the pool's fixed-point fold, with t-of-n Shamir
    # seed reveal on eviction. Sync tier only; the rank-0 manager reads
    # both through cfg (and refuses without an ingest pool).
    parser.add_argument("--aggregate_k", type=int, default=0,
                        help="straggler-tolerant first-k rounds: aggregate "
                             "as soon as k fresh uploads arrive (0 = wait "
                             "for all silos)")
    # Control plane: --round_timeout_s / --heartbeat_interval_s come from
    # the shared flag set; --checkpoint_frequency + --run_dir arm the
    # server's crash-resume checkpoints (kill rank 0, rerun the same
    # command: it restores the latest checkpoint, bumps its epoch, and the
    # federation continues).
    parser.add_argument("--idle_timeout_s", type=float, default=0.0,
                        help="silo self-termination bound: exit after this "
                             "many seconds without server contact (0 = "
                             "wait forever)")
    add_args(parser)
    args = parser.parse_args(argv)
    if not 0 <= args.rank < args.size:
        raise SystemExit(f"--rank {args.rank} outside [0, {args.size})")
    if args.comm_backend != "TCP":
        raise NotImplementedError(
            f"--comm_backend {args.comm_backend} is not ported yet to the "
            "PyTorch federation plane (ROADMAP.md A10d); use TCP")
    if args.client_selection != "random":
        raise SystemExit(
            f"--client_selection {args.client_selection} is a simulator "
            "feature; the cross-silo server samples uniformly (it has no "
            "access to silo-local losses before assignment)")
    from fedml_tpu_torch.exp.args import (reject_adapter_flags,
                                          reject_agg_shards_flag,
                                          reject_async_tier_flags,
                                          reject_controller_flags,
                                          reject_fedavg_family_flags,
                                          reject_pod_plane_flags,
                                          reject_serve_flags)

    # The cross-silo server reduces with FedAVGAggregator-parity math —
    # the simulator's pluggable aggregator/corruption drill would be
    # silently inert here, and the barrier rounds have no staleness
    # stream for the async-tier knobs to act on.
    reject_fedavg_family_flags(args, "the cross-silo pipeline")
    reject_async_tier_flags(args, "the cross-silo pipeline")
    # Silos shard by RANK, not by mesh, and the silo trainers are built
    # directly from fns.apply — none of the pod compute-plane knobs reach
    # this path.
    reject_pod_plane_flags(args, "the cross-silo pipeline")
    # Ditto the frozen-base adapter knobs.
    reject_adapter_flags(args, "the cross-silo pipeline")
    # The sharded aggregation plane needs M extra shard ranks between
    # server and silos — a topology the rank-per-process CLI does not
    # launch.
    reject_agg_shards_flag(args, "the cross-silo pipeline")
    # No serving plane on the rank-per-process CLI either.
    reject_serve_flags(args, "the cross-silo pipeline")
    # The adaptive controller is not threaded through to the rank-0
    # manager: the flag would be silently inert here.
    reject_controller_flags(args, "the cross-silo pipeline")

    logging.basicConfig(
        level=logging.INFO,
        format=f"[cross-silo rank {args.rank}] %(asctime)s %(message)s")

    from fedml_tpu_torch.core.device import resolve_device
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.exp.setup import setup_standard

    args.device = str(resolve_device(args.device))
    t0 = time.perf_counter()
    # Client silos never evaluate and shard clients by rank, not by mesh —
    # skip the global test-set concat (rank 0 only) and mesh build.
    fed, arrays, test, model, cfg, _ = setup_standard(
        args, need_test=(args.rank == 0), need_mesh=False)
    log.info("data and model on %s in %.1f s", args.device,
             time.perf_counter() - t0)
    worker_num = args.size - 1
    if worker_num > fed.client_num:
        raise SystemExit(
            f"--size {args.size} needs {worker_num} clients but the dataset "
            f"has only {fed.client_num}; reduce --size or raise "
            "--client_num_in_total")
    cfg.client_num_per_round = worker_num
    fns = model_fns(model)

    class NetArgs:
        pass

    net_args = NetArgs()
    net_args.host_table = build_host_table(args)

    # --trace: each rank traces its own half of the upload lifecycle and
    # dumps rank-suffixed artifacts into the shared run_dir.
    from fedml_tpu_torch.exp.args import trace_dir_from
    from fedml_tpu_torch.obs import trace as obs_trace

    trace_dir = trace_dir_from(args)
    if args.rank == 0:
        import os

        net0 = fns.init()
        eval_fn = make_eval_fn(fns.apply) if test is not None else None
        aggregator = FedAVGAggregator(net0, worker_num, cfg, eval_fn, test,
                                      device=args.device)
        checkpoint_dir = None
        metrics = None
        if args.run_dir:
            from fedml_tpu_torch.obs import MetricsLogger

            metrics = MetricsLogger.for_run(run_dir=args.run_dir,
                                            stdout=False)
            if args.checkpoint_frequency or args.resume:
                checkpoint_dir = os.path.join(args.run_dir, "ckpt")
        server = FedAVGServerManager(net_args, aggregator, cfg, args.size,
                                     backend=args.comm_backend,
                                     compress=args.compress,
                                     aggregate_k=args.aggregate_k,
                                     checkpoint_dir=checkpoint_dir,
                                     metrics=metrics, flight_dir=trace_dir)
        t0 = time.perf_counter()
        with obs_trace.tracing_to(trace_dir, suffix=".rank0"):
            server.run()
        log.info("federation of %d rounds in %.1f s", cfg.comm_round,
                 time.perf_counter() - t0)
        if metrics is not None:
            metrics.close()
        final = aggregator.test_history[-1] if aggregator.test_history else {}
        print(json.dumps({"rank": 0, **final, **server.health(),
                          "ingest": server.ingest_profile()}))
    else:
        optimizer = make_client_optimizer(cfg.client_optimizer, cfg.lr, cfg.wd,
                                          cfg.grad_clip)
        local_train = CapturedStep(make_local_train_fn_from_cfg(
            fns.apply, optimizer, cfg, loss_fn=softmax_ce), args.device,
            lambda: [])
        client = FedAVGClientManager(net_args, args.rank, args.size, arrays,
                                     local_train, cfg,
                                     backend=args.comm_backend,
                                     compress=args.compress,
                                     wire_codec_spec=args.wire_codec,
                                     idle_timeout_s=args.idle_timeout_s)
        t0 = time.perf_counter()
        with obs_trace.tracing_to(trace_dir, suffix=f".rank{args.rank}"):
            client.run()
        log.info("silo run in %.1f s (local step captured in %s ms)",
                 time.perf_counter() - t0, local_train.capture_ms)
        print(json.dumps({"rank": args.rank, "status": "done",
                          "launches": kernel_launches()}))


if __name__ == "__main__":
    main()
