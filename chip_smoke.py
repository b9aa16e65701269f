#!/usr/bin/env python3
"""Drives the PyTorch/H100 port (fedml_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. build   — compiles the CUDA kernels from fedml_tpu_torch/ops/csrc and
             reads, from the built library, each flash and GroupNorm
             kernel's registers, stack and local memory and its count of
             wgmma (HGMMA) instructions; every head dim of the three
             tensor-core flash kernels must have wgmma and no spills, and
             no GroupNorm kernel of the main path may spill. Prints the
             GroupNorm kernels' cluster plans (blocks per sample, shared
             memory per block).
2. kernels — each kernel against its plain PyTorch twin on the card:
             the flash forward (bf16: the tensor-core kernel; f32: the
             split-TF32 one, one tile a head and a walk) at the serving
             shape (B 8, T 2048, 8 heads, D 64) causal and full, at a
             ragged T, at D 16, 32 and 128, and in f32 (one tile and a
             walk at D 16 and 128 too); the
             flash backward (bf16: the tensor-core kernels; f32: the
             split-TF32 ones) at the FedAdapter slice's shape (8 clients x
             batch 2, T 2048, 8 heads, D 64, bf16, causal), in f32 at T
             2048 and 1000, without the mask, at a ragged T, at D 16, 32
             and 128 (f32 too at D 16 and 128), on views
             of one qkv buffer and under vmap with the clients next to T
             (the trainer's layout); the GroupNorm forward and backward at
             the eight shapes that ResNet-56's training path gives them,
             with 8 rows of γ/β, in the training path's layout (8 clients'
             rows, x a strided view) at one shape per stage, in f32 on a
             ragged shape and on a 2-D input, at an S the forward's
             cluster does not divide and at a sample that takes 8 blocks
             (the forward on its cluster route, reruns bit-equal), and
             the forward's streamed route on a sample past a cluster's
             shared memory; the split family's f32 shapes (resnet56_server
             at batch 32, the stump under the FedGKT client phase's vmap);
             ResNet-18-GN's four f32 shapes at 10 clients' rows of 20
             samples (64 to 512 channels in 32 groups, 32² to 4²), in both
             layouts; the f32 flash forward, dq with δ folded in and
             dk/dv (the split-TF32 kernels) at the ViT drive's
             [256, 64, 4, 32] non-causal, and the forward also at the f32
             adapter step's [2, 2048, 8, 64] causal, timed against their
             bounds (bytes or 3 TF32 passes of operations; the
             backward's also beside the bound with its products on the
             FP32 pipes), their twins and SDPA's f32 forward and whole
             backward;
             the streamed route past a cluster of 8 blocks (clusters of
             16 where the card schedules them), backward and forward, at
             FedSeg's UNet shapes at 256 x 256 in f32, one bf16 shape, one
             sample alone, a ragged S, vectors of 1 and 2 and 4096
             channels, reruns bit-equal, counted once a launch, timed at
             the path's levels 0 and 1 beside F.group_norm; GroupNorm's
             second derivative through the kernels against the twin's.
             Times each kernel (the flash forward at B 8
             and B 16), its twin and one PyTorch library call of the same
             function (many calls per CUDA event pair; a library backward
             and the GroupNorm kernels as replayed CUDA graphs), and
             computes the card's bound for the same work; times the
             GroupNorm kernels at each training shape in the path's
             layout and sums launches x ms per local step against
             launches x bound, and the same per resnet56_server step and
             per resnet18_gn local step in f32, with F.group_norm at
             ResNet-18-GN's [10x20, 1024, 64].
3. serve   — the serving path at full width: transformer_lm d_model 512,
             8 heads, 4 layers, T 2048 (flash attention), rank-8 adapters
             over all projections, a PersonalAdapterStore of 512 clients,
             16 requests through ServeManager with decode. Launch counts
             and copies are zeroed just before and read just after (no
             copy); one batch's prefill is re-run with the plain attention
             and held to a bf16 bound. The rollout gate over the same
             plane: a candidate published under epoch 1, one mirrored
             batch (the flash forward for the batch and for each arm),
             promoted, then rolled back bit-equal; a NaN candidate
             blocked; a coordinator restarted from its directory resumes
             mid-promotion, refuses a publish under the dead epoch and
             promotes; 36 flash launches counted.
4. train   — the flagship training path at full width and depth:
             FedAvgAPI over resnet56 (GroupNorm, bf16 compute), 128
             clients x 256 CIFAR-shaped samples from seed 0, batch 32, 8
             clients per round, 1 local epoch, sgd lr 0.1. One eager
             warm-up round (run_round + _server_update, the reference
             procedure), which tallies the forward's shapes; (a) from one
             start, key and cohort, the captured fused round
             (train_one_round, whose first call captures a CUDA graph)
             held to one eager round, bit-equal; 3 timed train_one_round
             rounds,
             replayed, with the GroupNorm launch counts zeroed just before
             and read just after (58 forward, 58 backward and 58 reduce
             launches per local step, no forward streamed), and 3
             train_rounds_pipelined rounds timed together; (b) a warm
             train_rounds_on_device(3) call, which captures, held to one
             loop of 3 eager host-loop rounds fed the same on-device
             cohorts (bit-equal), then 3
             timed calls (bench.py's timing), counted the same way. From
             one start, the kernel path against the plain GroupNorm twin:
             one local step in f32 and in bf16, and one round in f32 at lr
             1e-3, which must also tell a planted fault (the dγ/dβ reduce
             skipping one sample per client) from the twin. One on-device
             round and one replayed fused round under the profiler give
             the device busy time and idle share; the latter the device
             time by kernel, and shows, by name, that every forward ran on
             the cluster kernel.
5. obs     — the observability layer on the main paths, and FedAvg
             over StackOverflow-NWP at reference scale. (a) model_cost of
             resnet56 bf16 (the GroupNorm kernels), the FEMNIST cnn, the
             vit of vit_cifar_shaped (the f32 flash kernels) and
             transformer_lm at d_model 512, 8 heads, 4 layers, bf16, T
             2048 (the bf16 flash forward), each against a count by hand
             within [1, 1.35] x, and counted again without its kernel's
             flop formula (the difference equal to the formula's count by
             hand, the kernel launched both times); (b) on the train
             phase's api: RoundTimer around 8 fenced on-device rounds,
             each phase within 5% or 1 ms of CUDA events around it, and
             trace() around 1 round, its Chrome trace naming
             gn_fwd_kernel, gn_bwd_kernel and gn_reduce_kernel 464 times a
             round each; (c) 4 pipelined rounds in a strict sanitized()
             region (no capture, no implicit host sync) under (d) the
             donation audit, its peak within 0.25 of its baseline, and a
             .item() in a region that must raise; (e) bench.py's
             stackoverflow_342k, nothing cut: 342,477 clients'
             make_stackoverflow_nwp in a FederatedStore, FedAvg over
             RNNStackOverflow (embed 96, LSTM 670, vocab 10,004), 50 a
             round, batch 16, lr 10^-0.5: every step bucket warmed (the
             last in a strict region, which must raise SanitizerError),
             4 synced and 4 windowed rounds from one start bit-equal,
             round 0's loss within 0.5 of ln 10004, 16 synced and 16
             windowed rounds (W 8) timed in strict regions, the host
             gather, the RSS and the store's MB; (f) bench.py's
             synthetic_1m: 1,048,576 clients in 64 memmapped shards
             (make_stackoverflow_shard, seed 10,000 + s) in a temporary
             directory, removed after, 16 synced rounds, rps_vs_342k and
             peak_rss_ratio against (e). The store phase holds (c) on its
             warm loops too: the FEMNIST-3400 synced and windowed loops
             and FedOpt and SCAFFOLD windowed, each again in a strict
             region.
6. algos   — the algorithms on FedAvg's round at the train phase's
             configuration with 64 samples a client (2 local steps;
             since PR 18, as in the custom and zoo phases), every pin
             (a) and (b) from one eager run and bit-equal: FedOptAPI
             adam (server lr 0.05): (a) with the server optimizer state
             held too, (b) with the carried step
             count advanced by the rounds, and 3 timed
             train_rounds_on_device(2) calls (the api is kept for ckpt);
             FedProxAPI (mu 0.01): (a) and 2 replayed rounds;
             FedAvgRobustAPI (norm bound 5, the
             scale drill on one adversary forced into every round) with
             coord_median ((a) and 2 replayed rounds), trimmed_mean0.2,
             krum1 and geometric_median8 (each (a)), one profiled replayed
             round each, and each aggregator's device ms as the launches
             its round has beyond a mean round's (same clip and drill) at
             each kernel's mean time; FedNovaAPI on partition_dirichlet(
             alpha 0.5) of the same samples (gamma must change per round):
             train_rounds_pipelined(2) against one loop of 2 eager
             rounds, then 2 counted replayed rounds, and
             train_rounds_on_device refused with its capability record's
             message. The GroupNorm launches are counted under replay (58
             per local step each) and added to the kernels line.
7. custom  — the "custom" carry protocol at the same configuration:
             FedAvgAPI's replayed rounds as the call's baseline (kept for
             the zoo phase; SCAFFOLD's api kept for ckpt), then
             ScaffoldAPI (server lr 1), FedDynAPI (alpha 0.01), DittoAPI
             (lambda 0.1) and FedBNAPI, each with (a) against its
             published step run uncaptured once (bit-equal) and 3
             counted replayed rounds;
             SCAFFOLD and FedDyn also 3 train_rounds_pipelined rounds
             bit-equal to the replayed ones from one start, and the server
             state equal to the mean of the client stack; Ditto's global
             model bit-equal to FedAvg's after 3 and 6 rounds (116
             GroupNorm launches per local step: two trainings), the
             personal nets of unsampled clients unchanged and one
             evaluate_personalized; FedBN's global norm leaves unchanged,
             the unsampled clients' norms unchanged and the sampled ones
             moved, and one evaluate_personalized; each class's on-device
             tier refused with its record's message; a line per class with
             its replayed round ms and samples/s beside FedAvg's, the
             capture ms, the peak memory and the card's name and power
             limit. No GroupNorm operand copied.
8. zoo     — the rest of the FedAvg-round family at the same
             configuration: the custom phase's FedAvg replayed rounds and
             the train phase's on-device rounds as the call's baseline;
             FedAcAPI (gamma 2) and ServerAvgAPI (beta 0.5), each (a) and
             (b) (one round) from one eager run (bit-equal) and 3 timed
             train_rounds_on_device(2) calls, FedAc at gamma 1 (an eager
             round) within 1e-6 of FedAvg's round and ServerAvg at beta 0
             bit-equal to FedAvg's after 3 rounds; QFedAvgAPI (q 1): (a)
             from one eager round, 2 counted
             replayed rounds and the on-device tier with 928 GroupNorm
             forwards against 464 backwards a round (F_global's forward-
             only pass), F_global against an eager loss of the broadcast
             net; HierarchicalFedAvgAPI (groups client % 4, 2 inner
             rounds): 2 timed rounds over captured group steps (one per
             padded size, none captured while timed), one group against
             FedAvg's round, a coord_median round, krum refused, the
             pipelined and on-device tiers refused with the record's
             message; TurboAggregateAPI (3 share groups): 3 traced rounds
             split into device training, D2H and host MPC ms, the MPC
             aggregate against the f64 weighted mean of the same client
             stack (and with a client dropped); DecentralizedAPI dsgd and
             pushsum over the first 32 clients: (a) against the eager
             gossip round, 2 counted replayed rounds with the clients'
             spread around the consensus net, the push weights' sum, and
             train_rounds_pipelined(2) and train_rounds_on_device(2)
             bit-equal to them from one start. A line per class beside
             FedAvg's with the capture, the peak memory, the GroupNorm
             launches a round and the card's name and power limit.
9. split   — the model-split family at full width on the same data (the
             first 32 of its clients x 256 samples, batch 32, 1 local
             epoch, lr 0.1), f32:
             FedGKTAPI over resnet5_56 + resnet56_server (T 3, server
             Adam lr 1e-3): (a) the captured client phase against two
             eager client phases from one start (stumps, losses, client
             logits, the 2 GiB of features), (b) the first 16 replayed
             server steps against the eager step (tail, Adam state with
             its count, loss sums), a warm round that captures the
             relabel step, (c) round 1's client loss with the teacher
             against the same replay with have_teacher forced to 0, and 1
             timed round split into client phase, server phase and
             relabel by CUDA events, with the GroupNorm launches counted
             against the models' reckoning (29,232 forwards and 14,616
             backwards a round), none captured, none streamed;
             SplitNNAPI over resnet_split_bottom + resnet56_server: client
             0's captured segment against two eager ones, the other rows
             of the stack unchanged by it, a warm cycle after which every
             row moved and a timed cycle (15,360 GroupNorm launches of
             each kind); VflAPI at the NUS-WIDE shape (634 + 1000
             features, 1,280 samples, batch 64, 5 epochs): per-batch
             losses within 1e-5 relative of its own CPU run from the same
             params, the accuracy risen.
10. extra  — the rest of the simulator zoo (exp/main_extra.py) at full
             model width, f32: FedNASAPI over the DARTS search net (c 16,
             3 layers, 4 steps, multiplier 4; 275
             GroupNorms a forward) on
             32 x 32 x 3, 16 clients x 128 samples, batch 32, 8 a round:
             (a) the captured round against an eager round from one
             start under cuDNN's deterministic mode, bit-equal, at 2
             layers (the cut of the host's work: a normal cell and a
             reduction); the full net captured once by
             train_rounds_on_device, 1 replayed on-device round by CUDA
             events with the GroupNorm launches counted against the
             model's reckoning, the genotype; the unrolled arch gradient
             through the kernels against the plain twin's (and the
             first-order one's distance from it), one unrolled round at 1
             client. FedSegAPI
             over UNet (21 classes, base 16, 3 levels) on 256 x 256 x 3
             with ignored pixels, 16 clients x 32, batch 8, 8 a round:
             (a), a counted replayed round whose streamed GroupNorm
             launches (forward and backward) match group_norm_plan's,
             timed beside the single-block streamed kernels' round, a
             focal round, evaluate on 64 images with its confusion matrix
             against a numpy bincount of the same predictions. FedGanAPI
             over the MNIST GAN (latent 100, LayerNorm), 16 clients x 640,
             batch 64, 8 a round: (a), a replayed round, one on-device
             round, generate(16) in [-1, 1].
11. models — the model zoo's first half. FedAvgAPI over resnet18_gn at
             fed_cifar100's config (500 clients x 100 random 32 x 32 x 3
             samples, 100 classes, 10 a round, batch 20, 1 epoch, sgd lr
             0.1), built on the card by default: (a) bit-equal under
             cuDNN's deterministic mode, a replayed round counted against
             100 GroupNorm forwards and 100 backwards, 3 pipelined rounds,
             a warm train_rounds_on_device(3) call (its capture apart) and
             3 timed calls, counted. resnet56(norm="bn", dtype="bf16")
             FedAvg at the primary config: the running stats after the
             captured round bit-equal to the eager round's, moved from
             their init, and equal to the sample-weighted mean of the
             cohort's trained stats; one FedBNAPI round whose state stack
             moves in the sampled rows only. The FEMNIST CNN (cnn with
             dropout, 3400 clients x 40, batch 20, lr 0.1) and the
             Shakespeare LSTM (rnn, 715 clients x 8 sequences of T 80,
             batch 4, lr 1.0, pad id -1): each (a) and 2 replayed rounds.
             The GroupNorm kernels' holds and times at ResNet-18-GN's f32
             shapes run in the kernels phase.
12. cv     — the cross-silo CV zoo (BASELINE.md:30-42): FedAvgAPI over
             mobilenet (alpha 1), vgg11_gn (classifier 4096),
             mobilenet_v3 (LARGE) and efficientnet (b0), each f32 with
             GroupNorm at full width, built on the card by default; 10
             clients x 128 seeded 32 x 32 x 3 samples (cut from ~5,000),
             10 classes, all 10 a round, batch 64 (2 steps), sgd lr
             0.001. Each: (a) bit-equal under cuDNN's deterministic mode,
             a replayed round counted against 2 x its GroupNorms
             (operand copies printed), one forward + backward through the
             kernels against the plain twin with the same weights (the
             logits within 1e-4, the gradient within twice the twin's own
             move under a 1e-7 input perturbation), a warm
             train_rounds_on_device(3) call (its capture and peak memory
             apart) and 3 timed calls, counted; MobileNet's layouts
             probed and one on-device call profiled (idle share, its five
             costliest kernels). The GroupNorm kernels at these models'
             new shapes are held in the kernels phase.
13. adapter — the FedAdapter training path at full width: FedAdapterAPI
             over transformer_lm vocab 10004, d_model 512, 8 heads, 4
             layers, bf16, flash attention, LoRA rank 16 on the attention
             projections, T 2048; 16 clients x 8 random-token sequences,
             batch 2, 8 clients per round, 1 local epoch (4 steps), sgd lr
             0.1, seq_softmax_ce. As in the train phase: an eager warm-up
             round, (a), 3 timed replayed rounds with the flash launch
             counts zeroed just before and read just after (16 per round
             of each of the three kernels, 0 copies), 3 pipelined rounds,
             (b) and 3 timed on-device calls; the frozen base bitwise unchanged and the
             adapters moved; from one start, one local step in f32
             through the split-TF32 backward kernels against the plain
             twin, and one in bf16 through the tensor-core kernels held to the f32 twin's
             step beside the bf16 twin's, each of which must also tell a
             planted fault (dk/dv skipping the last Q tile) from the twin;
             one personalize_cohort of a round's clients and
             evaluate_personalized on them. The profiled rounds as in the
             train phase; by name, the forward and backward ran on the
             tensor-core kernels only.
14. vit    — FedAvgAPI over the ViT (bench.py's vit_cifar_shaped:
             patch 4, d_model 128, 4 heads, 4 layers, f32, 64 clients x
             256 CIFAR-shaped class-conditional samples, batch 32, 8 a
             round, sgd lr 0.01) with the f32 flash kernels as its
             attention: an eager warm-up round, (a) and (b) bit-equal to
             one eager run, 3 counted replayed rounds, 3 pipelined, 3
             timed on-device calls (32 launches of each flash kernel a
             round, one for all 8 clients), the replays' training loss
             falling, a profiled round showing the f32 kernels by name
             (the split-TF32 forward, dq and dk/dv; no bf16 tensor-core
             kernel and no FMA kernel).
15. ckpt   — run checkpoints at full width, each resume bit-equal to
             the straight run, restored into a fresh api and into the
             captured one: FedAdam (the algos phase's api) on
             train_rounds_on_device and on train_one_round, SCAFFOLD (the
             custom phase's; its control stack) and FedAdapter (the
             adapter phase's, a personalized cohort in its store); the
             save, snapshot and restore ms and the bytes written.
16. store  — the host-resident client store and the windowed tier. (a)
             bench.py's FEMNIST-3400 streaming configuration, nothing cut:
             the cnn over 3,400 writers (lognormal counts and U[0, 1)
             samples from seed 0), 10 a round, batch 20, lr 0.1, in three
             arms from one start and key, 32 rounds each for the pin and
             16 timed: the resident layout (27 steps a writer, 5.8 GB on
             the card) through train_rounds_pipelined, a FederatedStore
             through train_rounds_pipelined with the cohort prefetcher,
             and train_rounds_windowed at W 16; the three bit-equal (under
             cuDNN's deterministic mode), each arm's rounds/s, real
             samples/s, captures (one a step bucket, none after its
             first), the data on the card, the H2D a window and the idle
             share of a profiled window. (d) The same federation in 8
             memmapped shards: a window byte-equal to the flat store's,
             16 windowed rounds bit-equal to (a)'s, the RSS of each store.
             (c) The windowed zoo (bench.py:688-797), each arm windowed
             (W 16) against its own host loop, 32 rounds, params and
             carry bit-equal: FedOpt adam over the cnn on 600 writers,
             FedNova over lr on 300, FedDyn and SCAFFOLD over lr on 64.
             (b) The flagship (train's config) from a store:
             train_rounds_windowed(16, window=8) bit-equal to the resident
             train_rounds_pipelined(16), the GroupNorm launches counted
             in both (58 a local step of each kernel). (e) FedAdapter
             (adapter's config) from a store: train_rounds_windowed(8,
             window=4) bit-equal to the resident pipelined rounds, 16
             launches of each flash kernel a round, no copy, the base
             frozen.
17. knobs  — BatchNorm's last refusals and FedAvgAPI's knobs.
             (a) norm="bn" where the port refused it before: FedGKT over
             resnet5_56 + resnet56_server and SplitNN over
             resnet_split_bottom + resnet56_server (f32, 8 clients),
             DecentralizedAPI (DSGD, 16 clients) and TurboAggregate (8 a
             round) over resnet56 bf16, FedNAS over the DARTS search net
             at the extra phase's pin size (2 cells)
             and FedGAN's BatchNorm1d generator at its sizes: each captured
             step bit-equal to its uncaptured run from one start under
             cuDNN's deterministic mode, every running-stat buffer moved.
             (b) On the flagship (train's config): pow_d over 16
             candidates, 3 rounds resident and 3 from a FederatedStore,
             bit-equal, each cohort the 8 highest losses of a plain
             (uncaptured) eval, GroupNorm launches counted (the captured
             eval's forwards beside the round's); oort, 4 rounds through
             the host round (the round captured as its own step, the
             server update and the utilities on the host), utilities
             written for the cohort only, round 1 exploiting, a run
             checkpoint after round 1 resumed bit-equal; the pipelined,
             windowed and on-device tiers refused. (c) topk0.05 and q8: 2
             train_one_round rounds fed the on-device tier's cohorts
             bit-equal to train_rounds_on_device(2); topk1.0 bit-equal
             to plain FedAvg; a round's q8 client deltas on their
             255-level grids; FedAdapter (adapter's config) under pow_d
             (16 candidates) and topk0.05, 2 rounds with the flash
             launches counted. (d) The physical widths of the card's
             layout policy and of JAX's; bench.py's cnn_mfu_levers (16 x
             64, batch 16, 8 a round, 10 accuracy rounds; fp32, bf16 and
             im2col arms: samples/s, accuracy, final loss, deltas) and
             layout_fused_round (64 x 128, batch 20, 10 a round, cnn
             widths 120/120: auto against none), nothing cut; a
             GroupNorm CifarResNet at widths 20/40/80, stem 20 (resnet20
             depth, f32, lr 1e-3) under compute_layout="auto" against
             "none": the GroupNorm launches at the padded widths counted,
             the logical params within LAYOUT_F32_TOL, the physical
             client nets' pad entries exactly 0; the GroupNorm kernels at
             its padded widths (cluster and streamed routes) against the
             logical call and the plain twin, pad channels exactly 0.
18. dp     — DP-SGD and remat at full width. First the cli phase's
             files are written and its north-star command started as a
             subprocess, which runs beside this phase (host-bound
             captures) and the cli phase's in-process runs; every timed
             replay of both phases waits until it has ended. (a) The
             flagship (train's config at 64 samples a client, 2 local
             steps) under DP-SGD (clip 1.0, noise
             multiplier 1.1): the captured round against one eager round
             from one start under cuDNN's deterministic mode, bit-equal;
             one step of the round-0 cohort's per-example gradients under
             vmap (R = 256 single-sample GroupNorm rows): each clipped
             norm at most clip x (1 + 1e-3), their noiseless mean within
             2e-2 of the plain batch gradient; the GroupNorm kernels
             against their twins at ResNet-56's eight shapes with R = 256
             single-sample rows; later a counted replayed round (58
             launches of each GroupNorm kernel a local step) with its
             ms. (b) The flagship with remat and without, from one start
             under deterministic cuDNN: each captured with its peak
             memory and graph pool; later their second rounds replayed
             and timed, bit-equal, 116 GroupNorm forwards a local step
             against 58. (c) FedAdapter (adapter's config) under DP-SGD:
             captured, the same per-step holds through the flash kernels;
             later a counted replayed round (16 launches of each flash
             kernel).
19. cli    — the experiment CLI. (a) CIFAR-10 python-pickle batches of
             seeded random uint8 images at the real size (50,000 +
             10,000) in a temporary directory; (b) the north-star
             command ``python -m fedml_tpu_torch.exp.main_fedavg --model
             resnet56 --dataset cifar10 --partition_method hetero
             --partition_alpha 0.5 --client_num_in_total 10
             --client_num_per_round 10 --batch_size 64 --lr 0.03`` with
             ``--epochs 5 -> 1`` and ``--comm_round 100 -> 2`` as a
             subprocess (started by the dp phase), its last line parsed
             and train_loss finite; (e) beside it, the cross-silo
             MobileNet row ``--model mobilenet --dataset cifar10
             --partition_method hetero --partition_alpha 0.5
             --client_num_in_total 10 --client_num_per_round 10
             --batch_size 64 --lr 0.001`` with ``--epochs 20 -> 1`` and
             ``--comm_round 100 -> 1`` on the same files, the same way;
             (c) in process, through
             ``main(argv)``, exp.run's FedAvg with ``--dp_clip 1.0
             --dp_noise_multiplier 1.1 --remat`` on the same files (1,000
             clients of 50, 2 a round, 1 round) and ``main_centralized``
             with ``--dp_clip`` on 1,280 + 256 images; (d) the GroupNorm
             launches of (b) and (e) (written by the subprocesses at exit)
             and of (c); then the dp phase's timed replays.
20. fed    — the federation plane (algos/fedavg_distributed.py, comm/,
             ROADMAP.md A10a). (a) FedML_FedAvg_distributed over the
             loopback transport with every message through the tensor
             wire, at the flagship's config (resnet56 bf16 compute, 128
             clients of 256 seeded CIFAR-shaped samples, 8 silos a
             round, batch 32, 1 epoch, lr 0.1, 3 rounds, eval on 1,024
             samples), each arm of FED_ARMS (wire codec none, bf16,
             topk0.01+int8; ingest workers 0 and 4): round ms, the silo
             step replayed, bytes a upload on the wire, the
             ingest profile, GroupNorm launches (> 0), finite losses;
             then one round's real uploads folded by the streaming f32
             mean and by the int64 pool at 1 and 4 workers (bit-equal,
             within 1e-6 of the f32 mean). (b) The control plane on the
             lr model: a silo cut off by a ChaosSpec partition is
             evicted and the run ends; a server crash after round 2
             restarted from its checkpoint ends on the uninterrupted
             run's net bit for bit (ingest pool, deterministic cuDNN).
             (c) ``python -m fedml_tpu_torch.exp.main_cross_silo
             --model resnet56 --dataset cifar10`` as 3 processes over
             TCP on 50,000 + 10,000 seeded images (2 silos of 128
             clients, 1 round), started first and run beside (a) and
             (b): the server's accuracy and health, each silo's
             GroupNorm launches (> 0). Then (a)'s first arm again for 2
             rounds alone on the card over its captured silo step: the
             round ms and the silo step (replayed and eager) without
             (c)'s three processes beside.
21. async  — the federation plane's asynchronous tiers
             (algos/fedasync.py, algos/fedbuff.py, ROADMAP.md A10b). (a)
             FedML_FedAsync_distributed at the flagship's config (the
             fed phase's data and model, 8 workers, alpha 0.6,
             staleness exponent 0.5, 24 versions, bf16 wire codec, 4
             ingest workers, eval on 1,024 samples at the end): ms a
             version, staleness, bytes a upload, occupancy, GroupNorm
             launches (> 0), a finite eval loss; 8 uploads of its
             captured step at staleness 0..7 mixed inline and through
             the pool's decode, bit-equal. (b) FedML_FedBuff_distributed
             over the adapter phase's transformer (bf16, flash at T
             2048, LoRA rank 16 on attention), 8 workers, buffer_k 4,
             3 aggregations, topk0.01+int8 adapter deltas: bytes a
             upload against the tree's and the model's, the flash
             launches of each kind (> 0), the frozen base bit-equal;
             one worker's captured step against the plain twin by the
             adapter phase's bf16 rule; 64 requests served on the
             trained global through main_extra's --serve path. (c) On
             FED_SMALL's lr: coord_median over FedBuff's buffer against
             a worker uploading NaNs (guard drops counted, the global
             finite), and FedAsync with a worker cut off by a ChaosSpec
             partition (evicted, the run ends). (d) main_extra's
             FedAsync, FedBuff --serve and BaseFramework runners in
             process at the JAX package's test sizes, each last line
             parsed.
22. plane  — the federation plane's secure, sharded and simulated
             tiers (comm/secagg.py, comm/shardplane.py, sim/,
             ctrl/policy.py) at the flagship's config (the fed phase's
             data and model), under deterministic cuDNN, every
             federation over one captured silo step. (a)
             FedML_FedAvg_distributed with cfg.secagg, 4 silos, 2
             ingest workers, 3 rounds: each round's merged total (after
             mask cancellation) equal to the clear fold of the silos'
             own contributions, recorded before masking, its weight sum
             to the silos' quantized sample counts, and the global to
             the fold's mean, bit for bit; no masked frame equal to its
             clear contribution; then a drill whose silo 1 dies in round
             1: evicted, t = 3 shares revealed, the correction folded,
             round 1's total equal to the survivors' clear fold. (b)
             agg_shards 2 over 4 silos, 3 rounds: each round's merged
             shard partials equal to the single pool's fold of the same
             uploads (agg_shards 0's path), the global to its mean; a
             drill whose shard 2 dies after round 0 commits over the
             survivor's partial. (c) FleetSimulator over a seeded
             FleetSpec of 32 devices and a 3,600 s horizon: FedBuff
             (buffer_k 4, 10 aggregations) and sync first-k (k 8, 2
             rounds), each twice with event logs (every delivery's
             virtual time, type, sender, receiver) identical; sync with
             secagg over the spec's churn-free twin, 1 round, its total
             the clear fold. (d) controller_from_args's adaptive
             controller on (c)'s FedBuff runs (actuation logs
             identical), the same object on a loopback FedBuff run; a
             controller of no policies against none, bit-equal (5
             aggregations each). GroupNorm
             launches counted over (a)-(d) (> 0). (e) main_extra
             --algorithm FedBuff --controller adaptive at --model lr, in
             process, the attached controller read back.
23. report — each phase's seconds, a ``kernels`` JSON line (each flash
             kernel with its ``vit_f32`` route's numbers), the card's
             name and power limit, and as the last line ``{"ok": true,
             "device": {...}}``.

Weights are random, made from fixed seeds. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import faulthandler
import functools
import importlib
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import time
import types

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

# Training configuration: bench.py's primary (bench_cifar_resnet56).
TRAIN_CLIENTS, TRAIN_PER_CLIENT, TRAIN_BATCH, TRAIN_PER_ROUND = 128, 256, 32, 8
TRAIN_LR, TRAIN_ROUNDS = 0.1, 3
# The algos, custom and zoo phases' samples a client (2 local steps).
FAMILY_PER_CLIENT = 64
# ResNet-56's GroupNorms at 8 clients x 32 samples: (shape [N, S, C],
# groups, forward (and backward) launches per local step), as the train
# phase tallies them in its warm-up round.
GN_STEP = [((256, 1024, 16), 16, 13), ((256, 1024, 64), 32, 7),
           ((256, 1024, 32), 32, 1), ((256, 256, 32), 32, 11),
           ((256, 256, 128), 32, 7), ((256, 256, 64), 32, 1),
           ((256, 64, 64), 32, 11), ((256, 64, 256), 32, 7)]
RESNET56_GN = sum(n for _, _, n in GN_STEP)  # 58
# The split family's f32 GroupNorms: resnet56_server's 57 a step at batch
# 32 (shape [N, S, C], groups, launches a step), and the stump's under the
# FedGKT client phase's vmap (SPLIT_CLIENTS clients' rows of 32 samples, x
# interleaved as the vmapped conv hands it over; 3 a step).
SPLIT_TAIL_STEP = [((32, 1024, 16), 16, 12), ((32, 1024, 64), 32, 7),
                   ((32, 1024, 32), 32, 1), ((32, 256, 32), 32, 11),
                   ((32, 256, 128), 32, 7), ((32, 256, 64), 32, 1),
                   ((32, 64, 64), 32, 11), ((32, 64, 256), 32, 7)]
# The split phase's cohort: the first 32 of the flagship's 128 clients (the
# cut that pays for the knobs phase; FedGKT's server phase replays its step
# once per client batch).
SPLIT_CLIENTS = 32
SPLIT_STUMP = ((SPLIT_CLIENTS * 32, 1024, 16), 16, SPLIT_CLIENTS)
# The simulator zoo's f32 GroupNorms on the cluster route, 8 clients' rows
# (shape [N, S, C], groups as norm_groups gives them): the DARTS search net
# at batch 32 on 32 x 32 (the stem's 48 channels in 24 groups of 2, the
# cells' one-channel groups at 16 and 32 channels, 64 channels in 32
# groups), and UNet at batch 8 on 256 x 256, levels 2 and 3 (levels 0 and
# 1 stream: GN_BWD_STREAMED).
ZOO_GN = [((256, 1024, 48), 24), ((256, 1024, 16), 16),
          ((256, 1024, 32), 32), ((256, 256, 32), 32),
          ((256, 256, 64), 32), ((256, 64, 64), 32),
          ((64, 4096, 64), 32), ((64, 1024, 128), 32)]
# GroupNorm kernels vs the f32 twin: (shape [N, S, C], groups, rows, dtype,
# interleaved). The first eight are GN_STEP's shapes; "interleaved" lays x
# and dy out as the vmapped conv hands them over: [M, S, R, C] memory seen
# as [R, M, S, C]. Then a ragged S that the forward's cluster does not
# divide (CL 4 of 251 rows; CL 8 in f32), a sample that takes CL 8 in
# bf16, the split family's f32 shapes, and ZOO_GN's in both layouts the
# kernels get on those paths: [R, M, S, C] (most of their convs hand x
# over channels-first, which the wrapper copies so, counted in
# group_norm.copies) and interleaved.
GN_MAIN = ((256, 1024, 64), 32)
GN_CASES = [(shape, groups, 1, torch.bfloat16, False)
            for shape, groups, _ in GN_STEP] + [
            ((256, 1024, 64), 32, 8, torch.bfloat16, False),
            ((256, 1024, 16), 16, 8, torch.bfloat16, True),
            ((256, 1024, 64), 32, 8, torch.bfloat16, True),
            ((256, 256, 128), 32, 8, torch.bfloat16, True),
            ((256, 64, 256), 32, 8, torch.bfloat16, True),
            ((6, 49, 48), 8, 1, torch.float32, False),
            ((9, 1, 16), 4, 1, torch.float32, False),
            ((3, 1001, 64), 32, 1, torch.bfloat16, False),
            ((3, 1001, 64), 32, 1, torch.float32, False),
            ((4, 1024, 128), 32, 1, torch.bfloat16, False)] + [
            (shape, groups, 1, torch.float32, False)
            for shape, groups, _ in SPLIT_TAIL_STEP] + [
            (SPLIT_STUMP[0], SPLIT_STUMP[1], SPLIT_STUMP[2], torch.float32,
             True)] + [
            (shape, groups, 8, torch.float32, interleaved)
            for shape, groups in ZOO_GN for interleaved in (False, True)]
# A sample whose x is more than a cluster of 8 blocks holds (2 MB): the
# forward's streamed route.
GN_STREAMED = ((2, 8192, 64), 32, torch.float32)
# The backward's streamed route (one block per sample, x read three times
# and dy twice), held to the twin with reruns bit-equal: FedSeg's UNet at
# 256 x 256, level 0 (S 65,536, 16 channels, 4 MB of x a sample) and level
# 1 (16,384 x 32, 2 MB), in f32 as the model runs, and one bf16 sample
# past a cluster (65,536 x 32, 4 MB). (shape [N, S, C], groups, rows,
# dtype, interleaved); the last is the level-0 shape in the path's layout,
# 8 clients' rows of 8 samples, which is timed.
GN_BWD_STREAMED = [((16, 65536, 16), 16, 1, torch.float32, False),
                   ((16, 16384, 32), 32, 1, torch.float32, False),
                   ((4, 65536, 32), 32, 1, torch.bfloat16, False),
                   ((64, 65536, 16), 16, 8, torch.float32, True)]
# The streamed route's edges, held as GN_BWD_STREAMED is: one sample alone
# (every block of the cluster on it), an S that the cluster's granules of
# rows do not divide, 17 channels (vectors of 1), a client-interleaved
# view of 18 channels (vectors of 2), and 4096 channels, of which a block
# holds 4 rows.
GN_STREAMED_EDGES = [((1, 65536, 16), 16, 1, torch.float32, False),
                     ((2, 30001, 16), 16, 1, torch.float32, False),
                     ((2, 32768, 17), 17, 1, torch.float32, False),
                     ((4, 32768, 18), 6, 2, torch.float32, True),
                     ((2, 128, 4096), 32, 1, torch.float32, False)]
# FedSeg's two streamed shapes in the path's layout (8 clients' rows of 8
# samples, interleaved), timed beside F.group_norm: ([N, S, C], groups).
GN_STREAMED_TIMED = [((64, 65536, 16), 16), ((64, 16384, 32), 32)]
# FedSeg's replayed round with the single-block streamed kernels that the
# cluster route past 8 blocks replaced (ms; H100 80GB HBM3 at 700 W), for
# the drive's comparison line.
FEDSEG_ROUND_BEFORE_MS = (897.9, 911.7)
# GroupNorm's second derivative through the kernels against the plain
# twin's (f32, DARTS's one-channel groups at 32 x 32): max |d| over max
# |want|, other summation orders (2.5e-7 on the CPU twin).
GN_GRAD2_SHAPE, GN_GRAD2_GROUPS, GN_GRAD2_TOL = (64, 32, 32, 16), 16, 1e-4
# GroupNorm kernel vs plain twin in training, same start and keys, as the
# share of the update's norm (update = new params - start) by which they
# differ. One local step in f32 (cuDNN without TF32, the two paths on
# other conv kernels; 6.4e-4 measured on an H100): 5e-3. In bf16 every
# layer rounds activations and gradients to 8 bits, and the two paths round
# in other places (the twin's layouts send the convs to other cuDNN
# kernels), so the bf16 step is held to the f32 twin's step: the kernel's
# distance at most 1.5x the twin's + 1e-2. A round at lr 0.1 cannot be held
# to a bound that fails a wrong kernel: its 8 SGD steps amplify rounding to
# ~50% of the update in bf16 and ~28% in f32. So the round runs in f32 at
# lr 1e-3, where on an H100 the kernel read 1.7e-3 from the twin and a
# planted fault (the reduce skipping one sample per client) 8.5e-3: the
# bound is 4e-3, and the planted fault must read above it.
STEP_F32_TOL, STEP_BF16_SLACK, ROUND_F32_TOL = 5e-3, 1e-2, 4e-3
ROUND_LR = 1e-3

# FedAdapter configuration: bench.py's transformer_fed_mfu width
# (bench.py:2951-2958) with flash attention at the model's max_len.
ADAPTER_RANK, ADAPTER_CLIENTS, ADAPTER_PER_CLIENT = 16, 16, 8
ADAPTER_BATCH, ADAPTER_PER_ROUND, ADAPTER_LR, ADAPTER_ROUNDS = 2, 8, 0.1, 3
# The ViT drive's flash shape as one launch sees it: 8 clients x batch 32
# (vmapped into the kernels' R), T 64 (32 x 32 at patch 4), 4 heads, D 32,
# f32 (the split-TF32 kernels of flash_fwd.cu and flash_bwd.cu),
# non-causal.
VIT_FLASH = (256, 64, 4, 32, torch.float32, False)
# Flash backward kernels vs the f32 twin on the same inputs, as a share of
# max |want|: bf16 2e-2 (the kernels round dS and P to bf16 before the
# products, as the TPU kernels do, and write bf16), f32 1e-4 (another
# summation order). Cases: (B, T, H, D, dtype, causal); the first is the
# slice's shape, 8 clients x batch 2.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
BWD_CASES = [(16, 2048, 8, 64, torch.bfloat16, True),
             VIT_FLASH,
             (2, 2048, 8, 64, torch.float32, True),
             (2, 2048, 8, 64, torch.bfloat16, False),
             (2, 1000, 8, 64, torch.float32, True),
             (2, 77, 3, 16, torch.float32, False),
             (2, 200, 2, 128, torch.float32, True),
             (2, 1000, 8, 64, torch.bfloat16, True),
             (2, 1024, 8, 16, torch.bfloat16, True),
             (2, 1024, 8, 32, torch.bfloat16, True),
             (2, 1024, 4, 128, torch.bfloat16, True),
             (2, 1000, 4, 128, torch.bfloat16, False)]
# One local step of the FedAdapter cohort in f32, kernels vs the plain
# twin, same start and keys, as |update diff| / |update|. The bound is
# picked from readings of the sound kernels and of a planted fault (dk/dv
# skipping the last 64-row Q tile), PERF.md §6.
ADAPTER_STEP_TOL = 1e-3
# The same step in bf16 (the main path's tensor-core kernels), held to the
# f32 twin's step as the train phase's bf16 step is: the kernels' distance
# at most FACTOR x the bf16 twin's + SLACK. On an H100 the kernels read
# 9.56e-3, the bf16 twin 9.41e-3 (bound 2.41e-2) and the planted fault
# 1.45e-1.
ADAPTER_BF16_FACTOR, ADAPTER_BF16_SLACK = 1.5, 1e-2

# The algorithms on the training configuration: FedAdam's server lr (as
# tests/test_algos.py uses it), FedProx's mu, the robust clip's bound, the
# robust aggregators, FedNova's Dirichlet alpha, rounds per drive.
ALGO_SERVER_LR, ALGO_PROX_MU, ALGO_NORM_BOUND = 0.05, 0.01, 5.0
ALGO_AGGREGATORS = ("coord_median", "trimmed_mean0.2", "krum1",
                    "geometric_median8")
NOVA_ALPHA, ALGO_ROUNDS = 0.5, 2
# The "custom"-protocol algorithms at the JAX package's defaults: FedDyn's
# alpha and Ditto's lambda (SCAFFOLD runs at server lr 1).
CUSTOM_ALPHA, CUSTOM_LAM = 0.01, 0.1
# The rest of the round family: FedAc's gamma and ServerAvg's beta (the
# JAX package's defaults), q-FedAvg's q, hierarchical FL's groups (client %
# 4) and inner rounds, TurboAggregate's share groups, the gossip's clients
# (the first 32, every one every round), rounds per drive and per pin (b)
# (its two host loops of eager rounds are the phase's dearest part). FedAc
# at gamma 1 and one-group hierarchical FL are held to FedAvg's round
# within 1e-6 relative (max over leaves); F_global to an eager loss of the
# same net within 1e-2 relative (bf16 logits, the cohort vmapped against
# one client's forward).
ZOO_FEDAC_GAMMA, ZOO_SAVG_BETA, ZOO_Q = 2.0, 0.5, 1.0
ZOO_GROUPS, ZOO_GROUP_ROUNDS, ZOO_TA_GROUPS = 4, 2, 3
ZOO_GOSSIP_CLIENTS, ZOO_ROUNDS, ZOO_PIN_ROUNDS = 16, 2, 1
ZOO_REL_TOL, ZOO_FGLOBAL_TOL = 1e-6, 1e-2
# The model-split family at the JAX package's defaults (temperature 3,
# server Adam lr 1e-3, one server epoch) on the training data; pin (b)'s
# server steps; VFL at the NUS-WIDE shape of load_two_party_nus_wide
# (634 + 1000 features), its CPU run's per-batch losses within VFL_TOL
# relative.
GKT_T, GKT_SERVER_LR, GKT_PIN_STEPS, GKT_TIMED = 3.0, 1e-3, 16, 1
VFL_DIMS, VFL_N, VFL_BATCH, VFL_REP, VFL_EPOCHS = (634, 1000), 1280, 64, 32, 5
VFL_LR, VFL_TOL = 0.01, 1e-5
# The rest of the simulator zoo (exp/main_extra.py's algorithms), each at
# its model's full width in f32 as the JAX models run. FedNAS: the DARTS
# search net (c 16, NAS_LAYERS layers, 4 steps, multiplier 4: 275
# GroupNorms a forward, a normal cell and two reductions; the depth cut
# from 8 to 5 to pay for the knobs phase, and to 3 for the cv phase)
# on 32 x 32 x 3, 10 classes, 16 clients x 64 samples, batch 32
# (2 packed steps: h 1), 8 a round, weights lr 0.025, alphas lr 3e-4; the
# unrolled (second-order) round with xi 0.025 at 1 client a round (cut
# from 2 to pay for the fed phase) of 64 samples, one search step, at
# NAS_PIN_LAYERS cells (the cuts: its
# lookahead keeps ~3x the first-order round's activations, 47 GiB at 2
# clients and 8 cells; its eager round is the host's dispatch of ~45 s at
# 8 cells on an H100 host). That round runs eagerly only: a
# capture runs the step twice more (warm-up and capture, ~2.5x the eager
# round's host time, past the phase's budget); the captured unrolled round
# is held bit-equal to its eager round on a small DARTS net by
# tests/test_torch_cuda.py. Its
# arch gradient through the kernels against the plain twin's on the card:
# within NAS_GRAD2_TOL of the largest, and below a tenth of the
# first-order gradient's own distance from it (so a second derivative
# lost to zero cannot pass). On the CPU the same route through the twins
# reads 1.1e-3 from plain autograd in f32 and 6.6e-16 in f64: f32
# rounding, amplified through the GroupNorms of one-channel groups.
# The phase's host time is bounded by cuts (an eager round or a capture
# of the full net is the host's dispatch of ~30k ops a search step, ~3x
# that for the second-order one, whatever the client count): 64 samples
# a client, one search step a round (the train batch and the valid
# batch); pin (a), captured against eager under cuDNN's deterministic
# mode, and the unrolled (second-order) drives, the arch gradient's hold
# and the eager round, at NAS_PIN_LAYERS cells (2: a normal cell and a
# reduction, every op and edge kind); the full net
# captured once, by the on-device tier, whose replays are counted and
# timed.
NAS_CLIENTS, NAS_PER_CLIENT, NAS_BATCH, NAS_PER_ROUND = 16, 64, 32, 8
NAS_LR, NAS_ARCH_LR, NAS_XI, NAS_UNROLLED_PER_ROUND = 0.025, 3e-4, 0.025, 1
NAS_UNROLLED_PER_CLIENT, NAS_PIN_LAYERS, NAS_LAYERS = 64, 2, 3
NAS_GN, NAS_GRAD2_TOL, NAS_REPLAYS = 275, 3e-2, 1
# FedSeg: UNet (21 classes, base 16, 3 levels: 14 GroupNorms a forward) on
# 256 x 256 x 3 with 10% of the label pixels 255 (ignored), 16 clients x
# 32 samples, batch 8, 8 a round, lr 0.01; evaluate on 64 test images.
SEG_CLIENTS, SEG_PER_CLIENT, SEG_BATCH, SEG_PER_ROUND = 16, 32, 8, 8
SEG_SIDE, SEG_CLASSES, SEG_TEST, SEG_LR, SEG_IGNORED = 256, 21, 64, 0.01, 0.1
# FedGAN: the MNIST GAN (latent 100, LayerNorm) on 28 x 28 x 1, 16 clients
# x 640 samples, batch 64, 8 a round, the two Adams' lr 2e-4.
GAN_CLIENTS, GAN_PER_CLIENT, GAN_BATCH, GAN_PER_ROUND, GAN_LR = (16, 640, 64,
                                                                 8, 2e-4)

# The model zoo's first half. ResNet-18-GN FedAvg at fed_cifar100's
# published config (BASELINE.md:23, scripts/reproduce_baselines.sh:89-93):
# 500 clients x 100 random 32 x 32 x 3 samples, 100 classes, 10 a round,
# batch 20, 1 epoch (5 steps), sgd lr 0.1. Its GroupNorms at 10 clients x
# 20 samples, f32, 32 groups: (shape [N, S, C], launches a forward) — the
# stem and stage 1's four at 64 channels, then each stage's four and its
# downsample's: 20 a forward, 100 forwards and 100 backwards a round.
R18_CLIENTS, R18_PER_CLIENT, R18_BATCH, R18_PER_ROUND = 500, 100, 20, 10
R18_LR, R18_CLASSES = 0.1, 100
R18_GN = [((200, 1024, 64), 5), ((200, 256, 128), 5), ((200, 64, 256), 5),
          ((200, 16, 512), 5)]
R18_GN_FWD = sum(n for _, n in R18_GN)  # 20
# Its shapes join the GroupNorm holds against the twin, f32, 10 clients'
# rows, in both layouts (x interleaved as the vmapped conv hands it over,
# and [R, M, S, C]).
GN_CASES += [(shape, 32, 10, torch.float32, interleaved)
             for shape, _ in R18_GN for interleaved in (True, False)]
# The FEMNIST CNN (scripts/reproduce_baselines.sh:83-87: cnn, 3400
# clients, 10 a round, batch 20, lr 0.1) on random 28 x 28 single-channel
# images, 62 classes; cut to 40 samples a client (2 steps; FEMNIST's
# clients hold ~226). The Shakespeare LSTM (:95-99: rnn, 715 clients, 10 a
# round, batch 4, lr 1.0) on random ids of vocab 90 at T 80, labels with
# LEAF's pad id -1 on the last 8 positions of every third sequence; cut to
# 8 sequences a client (2 steps): its cell is ~10 launches a position and
# layer, ~5,000 a step forward and backward, which the host dispatches
# eagerly and the capture records.
FEMNIST_CLIENTS, FEMNIST_PER_CLIENT, FEMNIST_BATCH = 3400, 40, 20
FEMNIST_PER_ROUND, FEMNIST_LR, FEMNIST_CLASSES = 10, 0.1, 62
SHAKE_CLIENTS, SHAKE_PER_CLIENT, SHAKE_BATCH, SHAKE_PER_ROUND = 715, 8, 4, 10
SHAKE_LR, SHAKE_T, SHAKE_VOCAB, SHAKE_PAD = 1.0, 80, 90, -1
# The cross-silo CV zoo (BASELINE.md:30-42, the reference's
# benchmark/README.md:103-111): LDA alpha 0.5, 10 clients, all 10 a round,
# batch 64, sgd lr 0.001; each model at full width, f32, norm "gn", on
# seeded CIFAR-10-shaped [32, 32, 3] samples with 10 classes. Cut to 128
# samples a client (2 steps; a client holds ~5,000), 1 epoch (20), equal
# clients (no LDA split) and 1 captured + 3 x 3 timed rounds (100).
CV_MODELS = ("mobilenet", "vgg11_gn", "mobilenet_v3", "efficientnet")
CV_CLIENTS, CV_PER_CLIENT, CV_BATCH, CV_LR = 10, 128, 64, 1e-3
CV_CUTS = ("128 samples a client (~5,000), 1 epoch (20), equal clients "
           "(LDA alpha 0.5), 1 + 9 timed rounds (100)")
# Their GroupNorms a forward (each one launch for the cohort under vmap).
CV_NORMS = {"mobilenet": 27, "vgg11_gn": 8, "mobilenet_v3": 47,
            "efficientnet": 49}
# One forward + backward through the kernels against the same weights on
# the plain twin: the logits and the gradient as one vector, |d| / |want|.
# The two sum each GroupNorm's statistics in other orders (~1e-6
# relative). The logits are held within CV_TWIN_TOL; the gradient within
# CV_SPREAD x the twin's own move under a 1e-7 (relative) perturbation of
# the input, and at least CV_TWIN_TOL: MobileNet's f32 gradient is
# ill-conditioned (its stem's 32 one-channel groups; on the CPU the twin's
# f32 gradient lies 1.2e-3 from its f64 one and moves 4.7e-3 under such a
# perturbation), as the split family's holds found for their nets.
CV_TWIN_TOL, CV_SPREAD = 1e-4, 2.0
# The GroupNorm shapes these models bring, f32, the cohort's 10 rows of
# 64 samples, in both layouts: (S, C, groups).
CV_GN = [(1024, 96, 32), (256, 72, 24), (64, 88, 22), (16, 480, 32),
         (16, 672, 32), (4, 960, 32), (4, 1280, 32)]
GN_CASES += [((640, s, c), groups, 10, torch.float32, interleaved)
             for s, c, groups in CV_GN for interleaved in (True, False)]

# The ViT drive: bench.py's vit_cifar_shaped (bench.py:2096-2107 and
# _scan_bench's timing): vit patch 4, d_model 128, 4 heads, 4 layers, f32,
# 10 classes, 64 clients x 256 CIFAR-shaped samples, batch 32 (8 local
# steps), 8 clients a round, 1 epoch, sgd lr 0.01; the flash kernels as
# its attention (flash_attention_out). The samples are class-conditional
# Gaussian images (data/synthetic.py make_image_classification) rather
# than bench.py's noise, so that the training loss can fall.
VIT_CLIENTS, VIT_PER_CLIENT, VIT_BATCH, VIT_PER_ROUND = 64, 256, 32, 8
VIT_LR, VIT_D, VIT_HEADS, VIT_LAYERS, VIT_PATCH, VIT_ROUNDS = (0.01, 128, 4,
                                                               4, 4, 3)
# The store phase: bench.py's FEMNIST-3400 streaming configuration
# (_synthetic_femnist_store, _femnist_3400_setup, bench_store_windowed;
# bench.py:494-537, 644-686): the cnn (CNNDropOut, 62 classes) over 3,400
# writers with lognormal(3.6, 0.7) sample counts from seed 0 (152,363
# samples, 28 x 28 x 1 f32), 10 writers a round, batch 20, 1 epoch, sgd lr
# 0.1, window 16; nothing cut. Each arm runs STORE_ROUNDS rounds for the
# pin and STORE_TIMED more, timed.
STORE_CLIENTS, STORE_BATCH, STORE_PER_ROUND, STORE_LR = 3400, 20, 10, 0.1
STORE_WINDOW, STORE_ROUNDS, STORE_TIMED, STORE_SHARDS = 16, 32, 16, 8
# Rounds of the resident arm under the profiler (27 local steps each).
STORE_PROFILED = 4
# The windowed zoo (bench.py:688-797): FedOpt (server adam, lr 0.01) over
# the cnn on 600 writers from seed 1; FedNova over lr on 300 writers from
# seed 2; FedDyn (alpha 0.05) and SCAFFOLD over lr on 64 writers from seed
# 3, at lr 0.05.
ZOO_STORE = (("FedOpt", "cnn", 600, 1, 0.1), ("FedNova", "lr", 300, 2, 0.1),
             ("FedDyn", "lr", 64, 3, 0.05), ("SCAFFOLD", "lr", 64, 3, 0.05))
# The flagship and FedAdapter from a store: windows of 8 and 4 (the
# flagship's 16 rounds cut to one window for the cv phase).
FLAGSHIP_STORE_ROUNDS, FLAGSHIP_WINDOW = 8, 8
ADAPTER_STORE_ROUNDS, ADAPTER_WINDOW = 8, 4

# The obs phase. (a) model_cost at OBS_COST_BATCH samples (the LM at
# OBS_LM_BATCH sequences of T 2048), held to a count by hand within
# analytic <= got <= OBS_COST_BAND x analytic (tests/test_obs.py's band).
# (b) RoundTimer around OBS_TIMER_ROUNDS fenced on-device flagship rounds,
# each phase within OBS_TIMER_REL or OBS_TIMER_MS of its CUDA events; the
# profiler's trace around OBS_TRACE_ROUNDS. (c)/(d) OBS_SAN_ROUNDS
# pipelined flagship rounds in a strict sanitized() region under the
# donation audit, its peak within OBS_AUDIT_SLACK of the baseline.
OBS_COST_BATCH, OBS_LM_BATCH, OBS_COST_BAND = 8, 2, 1.35
# One traced round: the profiler has dropped the tail of a 2-round
# trace's ~116,000 events on the card.
OBS_TIMER_ROUNDS, OBS_TRACE_ROUNDS, OBS_SAN_ROUNDS = 8, 1, 4
OBS_TIMER_REL, OBS_TIMER_MS, OBS_AUDIT_SLACK = 0.05, 1.0, 0.25
# (e) bench.py's stackoverflow_342k (bench.py:1960-1986), nothing cut:
# make_stackoverflow_nwp(342,477, T 20, vocab 10,004) in a FederatedStore,
# FedAvg over RNNStackOverflow (embed 96, LSTM 670), 50 clients a round,
# batch 16, sgd lr 10^-0.5, seq_softmax_ce at pad id 0. The pin: SO_PIN
# rounds synced against SO_PIN windowed from one start, bit-equal; then
# SO_TIMED rounds of the synced loop and SO_TIMED of the windowed loop at
# W SO_WINDOW (bench.py times 5 windows of >= 6 s); the host gather's ms
# the median of SO_PROBES synchronous gathers of unvisited rounds. The
# first round's mean loss within SO_LOSS_TOL of ln(vocab).
# (f) bench.py's synthetic_1m (bench.py:2012-2094): 2^20 clients in 64
# memmap-spilled shards, shard s made by make_stackoverflow_shard(seed
# 10,000 + s), the model and round of (e), SO_TIMED synced rounds.
SO_CLIENTS, SO_T, SO_VOCAB, SO_PER_ROUND, SO_BATCH = 342_477, 20, 10004, 50, 16
SO_LR, SO_PIN, SO_TIMED, SO_WINDOW, SO_PROBES = 10 ** -0.5, 4, 16, 8, 10
SO_LOSS_TOL, SO_1M_CLIENTS, SO_1M_SHARDS, SO_1M_SEED = (0.5, 1_048_576, 64,
                                                         10_000)

# The rollout drill's gate: a candidate N(0, ROLLOUT_NOISE) from the live
# adapters mirrors within the relative tolerance; min shadow tokens as the
# coordinator's default.
ROLLOUT_NOISE, ROLLOUT_TOL = 1e-3, 0.02

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


def time_ms(fn, warmup: int = 3, reps: int = 15, inner: int = 20) -> float:
    """Median CUDA-event time of one call of ``fn`` after warm-up: each of
    ``reps`` event pairs brackets ``inner`` back-to-back calls and is
    divided by ``inner``, so the host's dispatch in front of one call
    overlaps the card's work on the others instead of being timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn) -> float:
    """``time_ms`` of ``fn`` captured once as a CUDA graph and replayed: for
    a library call whose host time (autograd, dispatch) exceeds its device
    time, so that many back-to-back calls would still time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay)


SM90_KERNELS = ("flash_fwd_sm90_kernel", "flash_dq_sm90_kernel",
                "flash_dkv_sm90_kernel")
# The f32 route: the split-TF32 forward, dq and dk/dv (mma.sync m16n8k8,
# SASS HMMA.1688.F32.TF32); the FMA kernels they replaced.
F32_KERNELS = ("flash_fwd_tf32_kernel", "flash_dq_tf32_kernel",
               "flash_dkv_tf32_kernel")
OLD_F32_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")


def phase_build():
    """Builds the extension; prints, from the built library, each flash and
    GroupNorm kernel's registers, stack and local memory (``cuobjdump
    -res-usage``) and its count of HGMMA (``wgmma``) instructions
    (``cuobjdump -sass``), and fails unless each of the four head dims of
    every tensor-core kernel has HGMMA, and of each split-TF32 kernel
    ``HMMA.1688.F32.TF32``, and neither stack nor local memory (no
    spills), nor any GroupNorm kernel (the streamed ones included), and
    unless the FMA kernels are gone;
    prints the GroupNorm kernels' cluster plans at the training path's
    shapes and the streamed route's plans at FedSeg's (CL, resident rows a
    block, shared memory), each within the card's opt-in."""
    from fedml_tpu_torch.ops import build

    from fedml_tpu_torch.native import load_msgnet

    t0 = time.perf_counter()
    build.extension()
    print(f"[build] extension built in {time.perf_counter() - t0:.1f} s "
          f"from {build.CSRC}", flush=True)
    t0 = time.perf_counter()
    load_msgnet()  # the TCP transport's host library, for the fed phase
    print(f"[build] msgnet (host TCP transport) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lib = os.path.join(build.BUILD_DIR, "fedml_tpu_torch_kernels.so")
    tool = "/usr/local/cuda/bin/cuobjdump"

    def dump(flag):
        return subprocess.run([tool, flag, lib], capture_output=True,
                              text=True, timeout=300, check=True).stdout

    hgmma, hmma, fn = {}, {}, None
    for line in dump("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and "HGMMA" in line:
            hgmma[fn] = hgmma.get(fn, 0) + 1
        elif fn and "HMMA.1688.F32.TF32" in line:
            hmma[fn] = hmma.get(fn, 0) + 1
    fn, spills = None, {}  # -res-usage prints "Function <name>:", then usage
    for line in dump("-res-usage").splitlines():
        m = re.search(r"Function (\S+):", line)
        res = dict(re.findall(r"(REG|STACK|LOCAL):(\d+)", line))
        if m:
            fn = m.group(1)
        kernel = fn and re.search(
            r"(?:flash|gn)_\w+?_kernel(?:\w*?Li\d+E(?:Li\d+E|Lb[01]E)*)?", fn)
        if kernel and "REG" in res:
            print(f"[build] {kernel.group(0)}: REG {res['REG']} STACK "
                  f"{res.get('STACK')} LOCAL {res.get('LOCAL')}; HGMMA "
                  f"{hgmma.get(fn, 0)}, HMMA.1688.F32.TF32 "
                  f"{hmma.get(fn, 0)}", flush=True)
            spills[fn] = int(res.get("STACK", 0)) + int(res.get("LOCAL", 0))
            fn = None
    for kernel in SM90_KERNELS:
        counts = [n for f, n in hgmma.items() if kernel in f]
        check(len(counts) == 4 and all(n > 0 for n in counts),
              f"{kernel}: HGMMA counts {counts} in {lib}, expected four "
              "instantiations with wgmma")
        spilled = [f for f, n in spills.items() if kernel in f and n]
        check(not spilled, f"{kernel}: stack or local memory (spills) in "
              f"{spilled}")
    for kernel in F32_KERNELS:  # one tile a head, or a walk; 4 head dims
        counts = [n for f, n in hmma.items() if kernel in f]
        dims = {m.group(1) for f in hmma if kernel in f
                for m in [re.search(rf"{kernel}ILi(\d+)E", f)] if m}
        check(len(counts) == 8 and all(n > 0 for n in counts)
              and dims == {"16", "32", "64", "128"},
              f"{kernel}: HMMA.1688.F32.TF32 counts {counts} (head dims "
              f"{sorted(dims)}) in {lib}, expected eight instantiations on "
              "the tensor cores")
        spilled = [f for f, n in spills.items() if kernel in f and n]
        check(not spilled, f"{kernel}: stack or local memory (spills) in "
              f"{spilled}")
    stale = [f for f in spills if any(k in f for k in OLD_F32_KERNELS)]
    check(not stale, f"the FMA kernels are still built: {stale}")
    spilled = [f for f, n in spills.items() if n and any(
        k in f for k in ("gn_fwd_kernel", "gn_bwd_kernel", "gn_reduce",
                         "gn_fwd_streamed_kernel", "gn_bwd_streamed_kernel"))]
    check(not spilled, f"the main path's GroupNorm kernels with stack or "
          f"local memory (spills): {spilled}")
    # The GroupNorm kernels' dynamic shared memory per block is the
    # cluster plan's, chosen per shape.
    ext = build.extension()
    for (_, s, c), _, _ in GN_STEP:
        fwd, bwd = (ext.group_norm_plan(s, c, True, n) for n in (1, 2))
        print(f"[build] group_norm plan [{s}, {c}] bf16: gn_fwd_kernel CL "
              f"{fwd[0]} x {fwd[1]} rows, {fwd[3]} B shared memory per "
              f"block; gn_bwd_kernel CL {bwd[0]} x {bwd[1]} rows, {bwd[2]} "
              f"tensors resident, {bwd[3]} B", flush=True)
    optin = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", 232448)
    for (_, s, c), _, _, dtype, _ in GN_BWD_STREAMED[:3]:
        bf16 = dtype == torch.bfloat16
        fwd, bwd = (ext.group_norm_plan(s, c, bf16, n) for n in (1, 2))
        print(f"[build] group_norm streamed plan [{s}, {c}] "
              f"{'bf16' if bf16 else 'f32'}: gn_fwd_streamed_kernel CL "
              f"{fwd[4]}, {fwd[6]} of {fwd[5]} rows a block resident, "
              f"{fwd[8]} B shared memory; gn_bwd_streamed_kernel CL "
              f"{bwd[4]}, x {bwd[6]} and dy {bwd[7]} rows resident, {bwd[8]} "
              f"B (opt-in {optin} B); {fwd[9]} clusters at once", flush=True)
        check(fwd[0] == bwd[0] == 0 and fwd[4] in (8, 16)
              and fwd[4:6] == bwd[4:6] and fwd[5] * fwd[4] >= s
              and 0 <= bwd[7] <= bwd[6] == fwd[6] <= fwd[5]
              and 0 < bwd[8] <= optin and 0 < fwd[8] <= optin
              and fwd[9] >= 1,
              f"group_norm streamed plans at [{s}, {c}]: {fwd}, {bwd}")


# Flash forward cases (B, T, H, D, dtype, causal): bf16 reaches the
# tensor-core kernel, f32 the split-TF32 one (one tile a head at T <= 64,
# else a walk). The first is the serving prefill's shape; the slice's
# FedAdapter shape is B 16.
FWD_CASES = [(8, 2048, 8, 64, torch.bfloat16, True),
             (8, 2048, 8, 64, torch.bfloat16, False),
             (2, 1000, 8, 64, torch.bfloat16, True),
             (2, 1000, 8, 64, torch.bfloat16, False),
             (2, 1024, 8, 16, torch.bfloat16, True),
             (2, 1024, 8, 32, torch.bfloat16, False),
             (2, 1024, 4, 128, torch.bfloat16, True),
             (2, 1000, 4, 128, torch.bfloat16, False),
             (2, 1000, 8, 64, torch.float32, True),
             VIT_FLASH,
             (2, 64, 4, 16, torch.float32, False),
             (2, 50, 4, 128, torch.float32, True),
             (2, 130, 2, 16, torch.float32, False),
             (2, 200, 2, 128, torch.float32, True)]
# The f32 forward timed at the ViT drive's launch and at the f32 adapter
# step's (FedAdapter's T 2048, D 64, causal, at batch 2).
F32_FWD_TIMED = [VIT_FLASH[:4] + (False,), (2, 2048, 8, 64, True)]


def _vit_flash_inputs(g):
    b, t, h, d, dtype, _ = VIT_FLASH
    return [torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype)
            for _ in range(4)]


def _vit_bytes_ops(peaks, nbytes, flops):
    """The least time of an f32 flash kernel: bytes over HBM against the
    operations, the larger of the two. The split-TF32 kernels do each
    product in 3 TF32 passes, over the TF32 rate, half the bf16 rate on
    Hopper (495 of 989 TFLOP/s on the SXM part)."""
    bf16_peak, _, hbm = peaks
    t_ops = 3 * flops / (bf16_peak / 2) * 1e3
    t_bytes = nbytes / hbm * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def phase_kernels(peaks):
    """Flash forward vs its plain twin at every case of FWD_CASES; times
    the main path's route (bf16: ``flash_fwd_sm90``) at B 8 and B 16 beside
    its twin and SDPA's forward. Returns the kernels-line entry (at B 16,
    the FedAdapter shape, where most of its launches are)."""
    import torch.nn.functional as F

    from fedml_tpu_torch.ops.build import extension
    from fedml_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    main_err = None
    for b, t, h, d, dtype, causal in FWD_CASES:
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
        main_err = err_o if main_err is None else main_err
        del q, k, v, o, lse, po, plse

    # The kernel alone (one event pair around 20 launches, so the host's
    # dispatch overlaps the card's work), the twin and SDPA's forward.
    ext = extension()
    bf16_peak, _, hbm = peaks
    entry = None
    for b in (8, 16):
        t, h, d = 2048, 8, 64
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(3))
        q5, k5, v5 = (x[None] for x in (q, k, v))
        ms = time_ms(lambda: ext.flash_fwd_sm90(q5, k5, v5, True))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, True),
                           warmup=1, reps=5, inner=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        pairs = t * (t + 1) // 2  # causal (query, key) pairs per head
        flops = 4 * b * h * d * pairs  # Q·Kᵀ and P·V, 2 FLOP per multiply-add
        nbytes = 4 * q.numel() * q.element_size() + b * h * t * 4
        t_ops, t_bytes = flops / bf16_peak * 1e3, nbytes / hbm * 1e3
        bound_ms = max(t_ops, t_bytes)
        print(f"[kernels] flash_fwd_sm90 B={b} T={t} H={h} D={d} bf16 causal:"
              f" kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, sdpa forward {library_ms:.4f} ms "
              f"({ms / library_ms:.2f}x); {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB -> bound {bound_ms * 1e3:.2f} us "
              f"(ops {t_ops * 1e3:.2f} us, bytes {t_bytes * 1e3:.2f} us)",
              flush=True)
        entry = {"name": "flash_fwd", "route": "cuda",
                 "source": "fedml_tpu_torch/ops/csrc/flash_fwd_sm90.cu",
                 "replaces": "fedml_tpu/ops/flash_attention.py:78",
                 "launches": None, "max_abs_err": main_err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                 "library_ms": library_ms}
        del q, k, v, q5, k5, v5, qt, kt, vt

    # The f32 route (the split-TF32 kernel) at the ViT drive's shape, full,
    # and at the f32 adapter step's, causal: the kernel (also replayed from
    # a CUDA graph: the card's time without the host's dispatch), the twin
    # and SDPA's f32 forward (a yardstick only).
    for b, t, h, d, causal in F32_FWD_TIMED:
        if (b, t, h, d) == VIT_FLASH[:4]:
            q, k, v, _ = _vit_flash_inputs(g)
        else:
            q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g)
                       for _ in range(3))
        q5, k5, v5 = (x[None] for x in (q, k, v))
        o, lse = ext.flash_fwd(q5, k5, v5, causal)
        o2, lse2 = ext.flash_fwd(q5, k5, v5, causal)
        po, plse = flash_attention_plain(q, k, v, causal)
        err = (o[0] - po).abs().max().item()
        check(err <= O_TOL[torch.float32] and (lse[0] - plse).abs().max()
              .item() <= LSE_TOL, f"flash_fwd f32 disagrees with plain at "
              f"{(b, t, h, d, causal)}: o {err}")
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"flash_fwd f32 reruns differ at {(b, t, h, d, causal)}")
        del o, lse, o2, lse2, po, plse
        ms = time_ms(lambda: ext.flash_fwd(q5, k5, v5, causal))
        replay_ms = graph_ms(lambda: ext.flash_fwd(q5, k5, v5, causal))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal),
                           warmup=1, reps=5, inner=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        flops = 4 * b * h * d * (t * (t + 1) // 2 if causal else t * t)
        nbytes = 4 * q.numel() * 4 + b * h * t * 4
        bound_ms, by, t_ops, t_bytes = _vit_bytes_ops(peaks, nbytes, flops)
        print(f"[kernels] flash_fwd_tf32_kernel B={b} T={t} H={h} D={d} f32 "
              f"{'causal' if causal else 'full'}: kernel {ms:.4f} ms "
              f"(replayed {replay_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
              f"forward {library_ms:.4f} ms; max|o-plain| {err:.3e}; "
              f"{flops / 1e9:.3f} GFLOP in 3 TF32 passes, "
              f"{nbytes / 1e6:.2f} MB -> bound {bound_ms * 1e3:.2f} us by "
              f"{by} (ops {t_ops * 1e3:.2f} us, bytes {t_bytes * 1e3:.2f} "
              f"us); {bound_ms / ms:.2f} of the bound; card {smi_line()}",
              flush=True)
        row = {"source": "fedml_tpu_torch/ops/csrc/flash_fwd.cu",
               "shape": [b, t, h, d], "causal": causal, "max_abs_err": err,
               "ms": ms, "replay_ms": replay_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": by,
               "library_ms": library_ms}
        entry["vit_f32" if (b, t, h, d) == VIT_FLASH[:4] else
              "adapter_f32"] = row
        del q, k, v, q5, k5, v5, qt, kt, vt
    return entry


def _scaled_err(got, want):
    """max |Δ| as a share of max |want| (f32 want)."""
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def _check_bwd(name, got, want, dtype):
    """Holds (dq, dk, dv) to the bound; returns their max |Δ|."""
    errs = [_scaled_err(a, w) for a, w in zip(got, want)]
    absd = [(a.float() - w).abs().max().item() for a, w in zip(got, want)]
    print(f"[kernels] flash_bwd {name}: max|d-plain|/max|plain| dq "
          f"{errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} "
          f"(tol {BWD_TOL[dtype]:.0e}); max|d-plain| {absd[0]:.3e}, "
          f"{absd[1]:.3e}, {absd[2]:.3e}", flush=True)
    check(all(math.isfinite(e) and e <= BWD_TOL[dtype] for e in errs),
          f"flash backward disagrees with plain: {errs} ({name})")
    return absd


def phase_flash_bwd_kernels(peaks):
    """flash_dq and flash_dkv vs the plain backward twin; returns their two
    kernels-line entries (launches filled in by the adapter phase)."""
    import torch.nn.functional as F
    from torch.func import vmap

    fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(b, t, h, d, dtype, causal):
        q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=g)
                       .to(dtype) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, causal=causal)
        return q, k, v, o, lse, do

    def plain(q, k, v, o, lse, do, causal):
        return fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                            o.float(), lse, do.float(),
                                            causal)

    main_errs = vit_errs = None
    for b, t, h, d, dtype, causal in BWD_CASES:
        q, k, v, o, lse, do = inputs(b, t, h, d, dtype, causal)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        name = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]} causal={causal}"
        errs = _check_bwd(name, got, plain(q, k, v, o, lse, do, causal),
                          dtype)
        main_errs = main_errs or errs
        if (b, t, h, d, dtype, causal) == VIT_FLASH:
            vit_errs = errs
        del q, k, v, o, lse, do, got

    # q, k, v as views of one [B, T, 3·H·D] buffer (what MHA passes), and
    # under vmap with the clients next to T as the trainer lays tokens out:
    # [B, C, T, 3·H·D] memory, the client dim folded into the kernels' R.
    for clients in (None, 8):
        shape = (2, 2048, 3 * 512) if clients is None else (2, clients, 2048,
                                                            3 * 512)
        qkv = torch.randn(shape, device="cuda", generator=g).to(
            torch.bfloat16)
        q, k, v = (z.unflatten(-1, (8, 64)) for z in qkv.split(512, dim=-1))
        do = torch.randn(q.shape, device="cuda", generator=g).to(
            torch.bfloat16)
        counts = (fa.flash_attention_bwd.dq_launches,
                  fa.flash_attention_bwd.dkv_launches,
                  fa.flash_attention.copies)
        if clients is None:
            o, lse = fa.flash_attention(q, k, v, causal=True)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
            want = plain(q, k, v, o, lse, do, True)
            name = "B=2 T=2048 H=8 D=64 bf16 causal, qkv views"
        else:
            fwd = vmap(lambda q, k, v: fa.flash_attention(q, k, v, True),
                       in_dims=1)
            o, lse = fwd(q, k, v)
            got = vmap(lambda *a: fa.flash_attention_bwd(*a, causal=True),
                       in_dims=(1, 1, 1, 0, 0, 1))(q, k, v, o, lse, do)
            flat = [x.movedim(1, 0).flatten(0, 1) for x in (q, k, v)]
            want = plain(*flat, o.flatten(0, 1), lse.flatten(0, 1),
                         do.movedim(1, 0).flatten(0, 1), True)
            got = [x.flatten(0, 1) for x in got]
            name = (f"{clients} clients x B=2 T=2048 H=8 D=64 bf16 causal, "
                    "vmapped, clients next to T")
        torch.cuda.synchronize()
        after = (fa.flash_attention_bwd.dq_launches,
                 fa.flash_attention_bwd.dkv_launches,
                 fa.flash_attention.copies)
        _check_bwd(name, got, want, torch.bfloat16)
        check(tuple(a - c for a, c in zip(after, counts)) == (1, 1, 0),
              f"{name}: launches/copies {after} from {counts}, expected "
              "one launch of each kernel and no copy")
        del qkv, q, k, v, o, lse, do, got, want

    # Times at the slice's shape: each kernel alone (δ made once), the
    # plain twin and the library's backward, which both compute dq, dk and
    # dv together.
    b, t, h, d, dtype, _ = BWD_CASES[0]
    q, k, v, o, lse, do = inputs(b, t, h, d, dtype, True)
    ext = fa.extension()
    q5, k5, v5, do5 = (x[None] for x in (q, k, v, do))
    lse5 = lse[None]
    delta = (do5.float() * o.float()[None]).sum(-1).transpose(-1, -2)
    delta = delta.contiguous()
    args = (q5, k5, v5, do5, lse5, delta, True)
    dq_ms = time_ms(lambda: ext.flash_dq_sm90(*args))
    dkv_ms = time_ms(lambda: ext.flash_dkv_sm90(*args))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, True), warmup=1, reps=5, inner=1)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))

    def lib_fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (qr, kr, vr), dot)

    library_ms = graph_ms(lib_fwd_bwd) - graph_ms(lib_fwd)
    pairs = t * (t + 1) // 2
    bf16_peak, _, hbm = peaks
    elem = b * t * h * d * q.element_size()
    rows = 2 * b * h * t * 4  # lse and delta, f32
    entries = []
    for kind, ms, products, nbytes, line in (
            ("dq", dq_ms, 3, 5 * elem + rows, 157),
            ("dkv", dkv_ms, 4, 6 * elem + rows, 195)):
        flops = 2 * products * b * h * d * pairs
        t_ops, t_bytes = flops / bf16_peak * 1e3, nbytes / hbm * 1e3
        bound_ms = max(t_ops, t_bytes)
        print(f"[kernels] flash_{kind} B={b} T={t} H={h} D={d} bf16 causal: "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"plain backward {plain_ms:.4f} ms, sdpa backward "
              f"{library_ms:.4f} ms; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB -> bound {bound_ms * 1e3:.2f} us (ops "
              f"{t_ops * 1e3:.2f} us, bytes {t_bytes * 1e3:.2f} us)",
              flush=True)
        entries.append({
            "name": f"flash_{kind}", "route": "cuda",
            "source": "fedml_tpu_torch/ops/csrc/flash_bwd_sm90.cu",
            "replaces": f"fedml_tpu/ops/flash_attention.py:{line}",
            "launches": None,
            "max_abs_err": main_errs[0] if kind == "dq" else max(main_errs[1:]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms})
    print(f"[kernels] flash dq + dk/dv B={b} T={t} H={h} D={d} bf16 causal: "
          f"{dq_ms + dkv_ms:.4f} ms, {(dq_ms + dkv_ms) / library_ms:.2f}x "
          "sdpa's backward",
          flush=True)

    # The ViT drive's f32 route (the split-TF32 kernels) at its shape,
    # non-causal: dq with δ folded in, dk/dv fed that δ, and the two as the
    # whole f32 backward, against the twin and SDPA's whole backward.
    b, t, h, d, dtype, _ = VIT_FLASH
    q, k, v, do = _vit_flash_inputs(g)
    o, lse = fa.flash_attention(q, k, v, causal=False)
    q5, k5, v5, do5, o5 = (x[None] for x in (q, k, v, do, o))
    lse5 = lse[None]
    _, delta = ext.flash_dq(q5, k5, v5, do5, o5, lse5, False)
    dq_ms = time_ms(lambda: ext.flash_dq(q5, k5, v5, do5, o5, lse5, False))
    dkv_ms = time_ms(lambda: ext.flash_dkv(q5, k5, v5, do5, lse5, delta,
                                           False))
    whole_ms = time_ms(lambda: ext.flash_dkv(
        q5, k5, v5, do5, lse5,
        ext.flash_dq(q5, k5, v5, do5, o5, lse5, False)[1], False))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, False), warmup=1, reps=5, inner=1)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))

    def vit_fwd():
        return F.scaled_dot_product_attention(qr, kr, vr)

    def vit_fwd_bwd():
        torch.autograd.grad(vit_fwd(), (qr, kr, vr), dot)

    library_ms = graph_ms(vit_fwd_bwd) - graph_ms(vit_fwd)
    elem = b * t * h * d * 4
    rows = 2 * b * h * t * 4  # lse and δ, f32
    for entry, kind, ms, products, nbytes in (
            (entries[0], "dq", dq_ms, 3, 6 * elem + rows),
            (entries[1], "dkv", dkv_ms, 4, 6 * elem + rows)):
        flops = 2 * products * b * h * d * t * t
        bound_ms, by, t_ops, t_bytes = _vit_bytes_ops(peaks, nbytes, flops)
        fp32_ms = max(flops / peaks[1] * 1e3, t_bytes)
        print(f"[kernels] flash_{kind}_tf32_kernel B={b} T={t} H={h} D={d} "
              f"f32 full (the ViT's{', with δ' if kind == 'dq' else ''}): "
              f"kernel {ms:.4f} ms, plain backward {plain_ms:.4f} ms, sdpa "
              f"backward {library_ms:.4f} ms; {flops / 1e9:.3f} GFLOP in 3 "
              f"TF32 passes, {nbytes / 1e6:.2f} MB -> bound "
              f"{bound_ms * 1e3:.2f} us by {by} (3 x ops at the TF32 rate "
              f"{t_ops * 1e3:.2f} us, bytes {t_bytes * 1e3:.2f} us); "
              f"{bound_ms / ms:.2f} of the bound; the bound with the "
              f"products on the FP32 pipes {fp32_ms * 1e3:.2f} us",
              flush=True)
        entry["vit_f32"] = {
            "source": "fedml_tpu_torch/ops/csrc/flash_bwd.cu",
            "shape": [b, t, h, d],
            "max_abs_err": vit_errs[0] if kind == "dq" else max(vit_errs[1:]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms}
    print(f"[kernels] the whole f32 backward (δ + dq + dk/dv) B={b} T={t} "
          f"H={h} D={d} full: {whole_ms:.4f} ms back to back ({dq_ms:.4f} + "
          f"{dkv_ms:.4f} alone) against SDPA's whole backward "
          f"{library_ms:.4f} ms: {library_ms / whole_ms:.2f}x; card "
          f"{smi_line()}", flush=True)
    entries[0]["vit_f32"]["whole_bwd_ms"] = whole_ms
    return entries


def _gn_inputs(shape, rows, dtype, gen, interleaved=False):
    n, s, c = shape
    m = n // rows
    phys = (m, s, rows, c) if interleaved else (rows, m, s, c)
    x = torch.randn(phys, device="cuda", generator=gen) * 2 + 0.5
    dy = torch.randn(phys, device="cuda", generator=gen)
    gamma = torch.rand(rows, c, device="cuda", generator=gen) + 0.5
    beta = torch.randn(rows, c, device="cuda", generator=gen)
    x, dy = x.to(dtype), dy.to(dtype)
    if interleaved:
        x, dy = x.permute(2, 0, 1, 3), dy.permute(2, 0, 1, 3)
    return x, dy, gamma, beta


def _gn_err(got, want, dtype):
    """max |Δ| and whether it is inside the bound: one bf16 rounding of the
    f32 value (2^-8 relative) plus 1e-5 of the scale, or 1e-5 in f32."""
    err = (got.float() - want).abs()
    if dtype == torch.bfloat16:
        lim = want.abs() * 2.0 ** -8 + 1e-5 * want.abs().max()
    else:
        lim = 1e-5 * (1 + want.abs())
    return err.max().item(), bool((err <= lim).all())


def _gn_bound(kind, x, peaks):
    """The least time of one GroupNorm launch on ``x [R, M, S, C]`` (bf16
    or f32; γ/β f32 [R, C]): (bound ms, "bytes" or "operations", bytes,
    flops, bytes ms, ops ms). The forward reads x, γ, β once and writes y;
    the backward reads x, dy, γ and writes dx, dγ, dβ. ~8 and ~20 flops per
    element, against the fp32 peak."""
    _, fp32_peak, hbm = peaks
    r, _, _, c = x.shape
    elems, esz = x.numel(), x.element_size()
    tensors, rows, flops = ((2, 2, 8 * elems) if kind == "fwd"
                            else (3, 3, 20 * elems))
    nbytes = tensors * elems * esz + rows * r * c * 4
    t_bytes, t_ops = nbytes / hbm * 1e3, flops / fp32_peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops, t_bytes, t_ops)


def _gn_nchw_ms(x, dy, gamma, beta, groups):
    """F.group_norm's forward and backward ms (replayed graphs) on ``x``/
    ``dy [R, M, S, C]`` laid out NCHW (S a square), with row 0's γ/β: the
    library yardstick of the streamed route."""
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import group_norm as gn

    r, m, s, c = x.shape
    side = math.isqrt(s)

    def nchw(t):
        return t.permute(1, 0, 2, 3).reshape(m * r, side, side, c).permute(
            0, 3, 1, 2).contiguous()

    xl, dyl = nchw(x), nchw(dy)
    w, b = gamma[0].clone(), beta[0].clone()
    lib_f = graph_ms(lambda: F.group_norm(xl, groups, w, b, gn.EPS))
    xr, wr, br = (t.clone().requires_grad_() for t in (xl, w, b))

    def fwd_bwd():
        yl = F.group_norm(xr, groups, wr, br, gn.EPS)
        torch.autograd.grad(yl, (xr, wr, br), dyl)

    lib_b = graph_ms(fwd_bwd) - graph_ms(
        lambda: F.group_norm(xr, groups, wr, br, gn.EPS))
    return lib_f, lib_b


def _gn_streamed_holds(g, peaks):
    """The streamed route (a sample past a cluster of 8 blocks) at every
    GN_BWD_STREAMED and GN_STREAMED_EDGES case: the backward against the f32
    twin (dx within the bounds of ``_gn_err``, dγ/dβ within the sum-order
    bound) and the forward (y within ``_gn_err``), each twice: chosen by
    shape, counted once a launch as streamed, reruns bit-equal. Then times
    both kernels at GN_STREAMED_TIMED (FedSeg's path) beside their bounds
    and F.group_norm on the same data in NCHW. Returns {"fwd": [(ms, bound
    ms, library ms) per timed shape], "bwd": [...], "shapes": [...]}."""
    from fedml_tpu_torch.ops import group_norm as gn

    for shape, groups, rows, dtype, inter in GN_BWD_STREAMED + \
            GN_STREAMED_EDGES:
        x, dy, gamma, beta = _gn_inputs(shape, rows, dtype, g, inter)
        before = (gn.group_norm_bwd.launches, gn.group_norm_bwd.streamed,
                  gn.group_norm_fwd.launches, gn.group_norm_fwd.streamed)
        dx, dgamma, dbeta = gn.group_norm_bwd(x, dy, gamma, groups)
        again = gn.group_norm_bwd(x, dy, gamma, groups)
        y = gn.group_norm_fwd(x, gamma, beta, groups)
        y_again = gn.group_norm_fwd(x, gamma, beta, groups)
        torch.cuda.synchronize()
        after = (gn.group_norm_bwd.launches, gn.group_norm_bwd.streamed,
                 gn.group_norm_fwd.launches, gn.group_norm_fwd.streamed)
        want_dx, want_dg, want_db = gn.group_norm_bwd_plain(
            x.float(), dy.float(), gamma, groups)
        edx, ok_dx = _gn_err(dx, want_dx, dtype)
        ey, ok_y = _gn_err(y, gn.group_norm_fwd_plain(x.float(), gamma, beta,
                                                      groups), dtype)
        r, m, s, c = x.shape
        chain = s + m + 64
        mu, rstd = gn._stats(x.float(), groups, gn.EPS)
        d32 = dy.float()
        lim_g = chain * 2.0 ** -24 * (d32 * (x.float() - mu) * rstd).abs(
        ).sum(dim=(1, 2)) + 1e-7
        lim_b = chain * 2.0 ** -24 * d32.abs().sum(dim=(1, 2)) + 1e-7
        edg, edb = (dgamma - want_dg).abs(), (dbeta - want_db).abs()
        ok_p = bool((edg <= lim_g).all() and (edb <= lim_b).all())
        same = torch.equal(y, y_again) and all(
            torch.equal(a, b) for a, b in zip((dx, dgamma, dbeta), again))
        name = (f"[{r}x{m}, {s}, {c}] g{groups} "
                f"{str(dtype).split('.')[-1]}"
                f"{' interleaved' if inter else ''}")
        mib = s * c * x.element_size() / 2**20
        print(f"[kernels] group_norm streamed {name} ({mib:.1f} MiB of x a "
              f"sample): bwd launches/streamed {before[:2]} -> {after[:2]}, "
              f"fwd {before[2:]} -> {after[2:]}; max|dx-plain| {edx:.3e}, "
              f"max|dgamma-plain| {edg.max().item():.3e}, max|dbeta-plain| "
              f"{edb.max().item():.3e}, max|y-plain| {ey:.3e}; reruns "
              f"{'bit-equal' if same else 'DIFFER'}", flush=True)
        check(after == tuple(v + 2 for v in before),
              f"group_norm streamed routes not taken ({name}): {before} -> "
              f"{after}")
        check(ok_dx and ok_p and ok_y and same,
              f"group_norm streamed routes disagree with plain ({name})")
        del x, dy, dx, y, again, y_again

    timed = {"fwd": [], "bwd": [], "shapes": []}
    for shape, groups in GN_STREAMED_TIMED:
        x, dy, gamma, beta = _gn_inputs(shape, 8, torch.float32, g, True)
        lib = _gn_nchw_ms(x, dy, gamma, beta, groups)
        r, m, s, c = x.shape
        for i, (kind, fn) in enumerate((
                ("fwd", lambda: gn.group_norm_fwd(x, gamma, beta, groups)),
                ("bwd", lambda: gn.group_norm_bwd(x, dy, gamma, groups)))):
            ms, bound = graph_ms(fn), _gn_bound(kind, x, peaks)[0]
            timed[kind].append((ms, bound, lib[i]))
            print(f"[kernels] group_norm_{kind} streamed [{r}x{m}, {s}, {c}] "
                  f"g{groups} f32 interleaved (FedSeg's path): {ms:.4f} ms "
                  f"(bound {bound:.4f} ms, {bound / ms:.2f} of it); "
                  f"F.group_norm {lib[i]:.4f} ms (NCHW)", flush=True)
        timed["shapes"].append([r, m, s, c])
        del x, dy, gamma, beta
    return timed


def _gn_grad2_hold(g):
    """GroupNorm's second derivative through the kernels (the backward op
    differentiated by ``_GroupNormBackward``) against ordinary autograd
    through the plain twin, f32 on the card: every term of the double
    backward, within GN_GRAD2_TOL of the largest."""
    from torch.func import grad

    from fedml_tpu_torch.ops import group_norm as gn

    shape, groups = GN_GRAD2_SHAPE, GN_GRAD2_GROUPS
    c = shape[-1]
    x = torch.randn(shape, device="cuda", generator=g) * 2 + 0.5
    t, w = (torch.randn(shape, device="cuda", generator=g) for _ in range(2))
    gam = torch.rand(c, device="cuda", generator=g) + 0.5
    bet = torch.randn(c, device="cuda", generator=g)

    def second(fn):
        def loss(x, g_, b_):
            return ((fn(x, g_, b_, groups) - t) ** 3).sum()

        def inner(x, g_, b_):
            gx, gg, gb = grad(loss, argnums=(0, 1, 2))(x, g_, b_)
            return (gx * w).sum() + (gg * g_).sum() + (gb * b_ * g_).sum()

        return grad(inner, argnums=(0, 1, 2))(x, gam, bet)

    launches = gn.group_norm_bwd.launches
    got = second(gn.group_norm)
    launches = gn.group_norm_bwd.launches - launches
    want = second(gn.group_norm_plain)
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(got, want)]
    print(f"[kernels] group_norm second derivative {list(shape)} g{groups} "
          f"f32 through the kernels ({launches} backward launches) vs the "
          f"plain twin's autograd: max|d|/max|want| x {rel[0]:.3e}, gamma "
          f"{rel[1]:.3e}, beta {rel[2]:.3e} (bound {GN_GRAD2_TOL:.0e}); "
          f"|want_x| {want[0].norm().item():.4e}", flush=True)
    check(max(rel) <= GN_GRAD2_TOL and launches >= 3,
          f"group_norm second derivative: {rel}, {launches} launches")


def phase_gn_kernels(peaks):
    """GroupNorm forward/backward kernels vs their plain twins at every case
    of GN_CASES (the forward on the cluster route, reruns bit-equal), the
    forward's streamed route at GN_STREAMED and both streamed kernels at
    their cases (``_gn_streamed_holds``); times both at the main
    shape and at each GN_STEP shape in the training path's layout, and sums
    launches x ms per local step against launches x bound. Returns the two
    kernels-line entries (launches filled in by the train phase)."""
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    for shape, groups, rows, dtype, interleaved in GN_CASES:
        x, dy, gamma, beta = _gn_inputs(shape, rows, dtype, g, interleaved)
        streamed = gn.group_norm_fwd.streamed
        y = gn.group_norm_fwd(x, gamma, beta, groups)
        rerun = gn.group_norm_fwd(x, gamma, beta, groups)
        dx, dgamma, dbeta = gn.group_norm_bwd(x, dy, gamma, groups)
        torch.cuda.synchronize()
        want_y = gn.group_norm_fwd_plain(x.float(), gamma, beta, groups)
        want_dx, want_dg, want_db = gn.group_norm_bwd_plain(
            x.float(), dy.float(), gamma, groups)
        ey, ok_y = _gn_err(y, want_y, dtype)
        edx, ok_dx = _gn_err(dx, want_dx, dtype)
        # dγ/dβ: f32 sums of the same terms in other orders; recursive
        # summation bounds the gap by chain·2^-24·Σ|terms| per channel.
        r, m, s, c = x.shape
        chain = s + m + 64
        mu, rstd = gn._stats(x.float(), groups, gn.EPS)
        d32 = dy.float()
        lim_g = chain * 2.0 ** -24 * (d32 * (x.float() - mu) * rstd).abs(
        ).sum(dim=(1, 2)) + 1e-7
        lim_b = chain * 2.0 ** -24 * d32.abs().sum(dim=(1, 2)) + 1e-7
        edg = (dgamma - want_dg).abs()
        edb = (dbeta - want_db).abs()
        ok_p = bool((edg <= lim_g).all() and (edb <= lim_b).all())
        name = (f"[{r}x{m}, {s}, {c}] g{groups} R{r} "
                f"{str(dtype).split('.')[-1]}"
                f"{' interleaved' if interleaved else ''}")
        print(f"[kernels] group_norm {name}: max|y-plain| {ey:.3e}, "
              f"max|dx-plain| {edx:.3e}, max|dgamma-plain| "
              f"{edg.max().item():.3e}, max|dbeta-plain| "
              f"{edb.max().item():.3e} (bf16: 2^-8 rel + 1e-5 of scale; "
              f"f32: 1e-5; dgamma/dbeta: sum-order bound)", flush=True)
        check(ok_y and ok_dx and ok_p,
              f"group_norm kernels disagree with plain ({name})")
        check(gn.group_norm_fwd.streamed == streamed,
              f"group_norm_fwd took the streamed route ({name})")
        check(torch.equal(y, rerun), f"group_norm_fwd reruns differ ({name})")
        if (shape, groups) == GN_MAIN and rows == 1 and not interleaved:
            errs = {"fwd": ey, "bwd": max(edx, edg.max().item(),
                                           edb.max().item())}

    # The streamed route: chosen by shape, counted, held to the twin.
    shape, groups, dtype = GN_STREAMED
    x, _, gamma, beta = _gn_inputs(shape, 1, dtype, g)
    counts = (gn.group_norm_fwd.launches, gn.group_norm_fwd.streamed)
    y = gn.group_norm_fwd(x, gamma, beta, groups)
    torch.cuda.synchronize()
    after = (gn.group_norm_fwd.launches, gn.group_norm_fwd.streamed)
    ey, ok_y = _gn_err(y, gn.group_norm_fwd_plain(x.float(), gamma, beta,
                                                  groups), dtype)
    print(f"[kernels] group_norm_fwd {list(shape)} g{groups} "
          f"{str(dtype).split('.')[-1]} (x past a cluster's shared memory): "
          f"streamed route, launches/streamed {counts} -> {after}; "
          f"max|y-plain| {ey:.3e} (tol 1e-5)", flush=True)
    check(ok_y and after == (counts[0] + 1, counts[1] + 1),
          f"the streamed forward: counts {counts} -> {after}, error {ey}")
    del x, y, gamma, beta

    streamed = _gn_streamed_holds(g, peaks)
    _gn_grad2_hold(g)

    # The kernels' device time as a replayed CUDA graph (where the
    # wrapper's host work outlasts a kernel, back-to-back calls time the
    # host), and through the wrapper, as the earlier records timed them.
    shape, groups = GN_MAIN
    x, dy, gamma, beta = _gn_inputs(shape, 1, torch.bfloat16, g)
    fwd_ms = graph_ms(lambda: gn.group_norm_fwd(x, gamma, beta, groups))
    bwd_ms = graph_ms(lambda: gn.group_norm_bwd(x, dy, gamma, groups))
    fwd_call = time_ms(lambda: gn.group_norm_fwd(x, gamma, beta, groups))
    bwd_call = time_ms(lambda: gn.group_norm_bwd(x, dy, gamma, groups))
    bwd_alone = graph_ms(lambda: gn.extension().group_norm_bwd(
        x, dy, gamma, groups, gn.EPS))

    # The training path: every GN_STEP shape with 8 clients' rows, x and dy
    # interleaved, weighted by its launches per local step.
    path = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}  # Σ n·ms, Σ n·bound
    for (n, s, c), grp, per_step in GN_STEP:
        xi, dyi, gi, bi = _gn_inputs((n, s, c), 8, torch.bfloat16, g, True)
        line = []
        for kind, fn in (
                ("fwd", lambda: gn.group_norm_fwd(xi, gi, bi, grp)),
                ("bwd", lambda: gn.group_norm_bwd(xi, dyi, gi, grp))):
            ms, bound = graph_ms(fn), _gn_bound(kind, xi, peaks)[0]
            path[kind][0] += per_step * ms
            path[kind][1] += per_step * bound
            line.append(f"{kind} {ms:.4f} ms (bound {bound:.4f} ms, "
                        f"{bound / ms:.2f} of it)")
        print(f"[kernels] group_norm path [8x{n // 8}, {s}, {c}] g{grp} bf16 "
              f"interleaved, {per_step} launches per step: "
              + ", ".join(line), flush=True)
        del xi, dyi, gi, bi
    for kind, (ms, bound) in path.items():
        print(f"[kernels] group_norm_{kind} per local step ({RESNET56_GN} "
              f"launches): sum of launches x ms {ms:.4f} ms against sum of "
              f"launches x bound {bound:.4f} ms ({bound / ms:.2f} of it)",
              flush=True)
    # The split family's f32 path: resnet56_server's shapes at batch 32
    # (one plain call, x contiguous) weighted by their launches a server
    # step, and the stump's shape under the client phase's vmap.
    split = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    cases = [(shape, grp, 1, False, n) for shape, grp, n in SPLIT_TAIL_STEP]
    cases.append((SPLIT_STUMP[0], SPLIT_STUMP[1], SPLIT_STUMP[2], True, 0))
    for (n, s, c), grp, rows, inter, per_step in cases:
        xi, dyi, gi, bi = _gn_inputs((n, s, c), rows, torch.float32, g,
                                     inter)
        line = []
        for kind, fn in (
                ("fwd", lambda: gn.group_norm_fwd(xi, gi, bi, grp)),
                ("bwd", lambda: gn.group_norm_bwd(xi, dyi, gi, grp))):
            ms, bound = graph_ms(fn), _gn_bound(kind, xi, peaks)[0]
            split[kind][0] += per_step * ms
            split[kind][1] += per_step * bound
            line.append(f"{kind} {ms:.4f} ms (bound {bound:.4f} ms, "
                        f"{bound / ms:.2f} of it)")
        where = (f"{per_step} launches per server step" if per_step else
                 "the stump under vmap, 3 launches per client step")
        print(f"[kernels] group_norm split path [{rows}x{n // rows}, {s}, "
              f"{c}] g{grp} f32{' interleaved' if inter else ''}, {where}: "
              + ", ".join(line), flush=True)
        del xi, dyi, gi, bi
    n_tail = sum(n for _, _, n in SPLIT_TAIL_STEP)
    for kind, (ms, bound) in split.items():
        print(f"[kernels] group_norm_{kind} f32 per resnet56_server step "
              f"({n_tail} launches): sum of launches x ms {ms:.4f} ms "
              f"against sum of launches x bound {bound:.4f} ms "
              f"({bound / ms:.2f} of it)", flush=True)
    # ResNet-18-GN's f32 path: each shape with 10 clients' rows, x and dy
    # interleaved, weighted by its launches a forward (a local step runs
    # each once forward and once backward); the first shape also through
    # F.group_norm on the same data in NCHW.
    r18 = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    r18_main = {}
    for (n, s, c), per_fwd in R18_GN:
        xi, dyi, gi, bi = _gn_inputs((n, s, c), 10, torch.float32, g, True)
        line = []
        for kind, fn in (
                ("fwd", lambda: gn.group_norm_fwd(xi, gi, bi, 32)),
                ("bwd", lambda: gn.group_norm_bwd(xi, dyi, gi, 32))):
            ms, bound = graph_ms(fn), _gn_bound(kind, xi, peaks)[0]
            r18[kind][0] += per_fwd * ms
            r18[kind][1] += per_fwd * bound
            line.append(f"{kind} {ms:.4f} ms (bound {bound:.4f} ms, "
                        f"{bound / ms:.2f} of it)")
            if (n, s, c) == R18_GN[0][0]:
                r18_main[kind] = (ms, bound)
        if (n, s, c) == R18_GN[0][0]:
            lib_f, lib_b = _gn_nchw_ms(xi, dyi, gi, bi, 32)
            r18_main["lib"] = (lib_f, lib_b)
            line.append(f"F.group_norm fwd {lib_f:.4f} ms, bwd {lib_b:.4f} "
                        "ms (NCHW)")
        print(f"[kernels] group_norm resnet18_gn path [10x{n // 10}, {s}, "
              f"{c}] g32 f32 interleaved, {per_fwd} launches a forward: "
              + ", ".join(line), flush=True)
        del xi, dyi, gi, bi
    for kind, (ms, bound) in r18.items():
        print(f"[kernels] group_norm_{kind} f32 per resnet18_gn local step "
              f"({R18_GN_FWD} launches): sum of launches x ms {ms:.4f} ms "
              f"against sum of launches x bound {bound:.4f} ms "
              f"({bound / ms:.2f} of it)", flush=True)
    fwd_plain = time_ms(lambda: gn.group_norm_fwd_plain(x, gamma, beta,
                                                        groups))
    bwd_plain = time_ms(lambda: gn.group_norm_bwd_plain(x, dy, gamma,
                                                        groups))
    # Library yardstick: F.group_norm on the same data in NCHW (its CUDA
    # kernel wants γ/β in x's dtype).
    n, s, c = shape
    side = int(math.isqrt(s))
    xl = x.reshape(n, side, side, c).permute(0, 3, 1, 2).contiguous()
    dyl = dy.reshape(n, side, side, c).permute(0, 3, 1, 2).contiguous()
    w, b = gamma[0].to(x.dtype), beta[0].to(x.dtype)
    lib_fwd = graph_ms(lambda: F.group_norm(xl, groups, w, b, gn.EPS))
    xr, wr, br = (t.clone().requires_grad_() for t in (xl, w, b))

    def lib_fwd_bwd():
        yl = F.group_norm(xr, groups, wr, br, gn.EPS)
        torch.autograd.grad(yl, (xr, wr, br), dyl)

    lib_bwd = graph_ms(lib_fwd_bwd) - graph_ms(
        lambda: F.group_norm(xr, groups, wr, br, gn.EPS))
    entries = []
    for kind, ms, call_ms, plain_ms, lib_ms in (
            ("fwd", fwd_ms, fwd_call, fwd_plain, lib_fwd),
            ("bwd", bwd_ms, bwd_call, bwd_plain, lib_bwd)):
        bound_ms, bound_by, nbytes, flops, t_bytes, t_ops = _gn_bound(
            kind, x, peaks)
        alone = (f", of which gn_bwd_kernel alone {bwd_alone:.4f} ms"
                 if kind == "bwd" else "")
        print(f"[kernels] group_norm_{kind} [{n}, {s}, {c}] g{groups} bf16: "
              f"kernel {ms:.4f} ms (graph{alone}; through the wrapper "
              f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms, F.group_norm "
              f"{lib_ms:.4f} ms; {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e6:.1f} MFLOP -> bound {bound_ms * 1e3:.2f} us "
              f"(bytes {t_bytes * 1e3:.2f} us, ops {t_ops * 1e3:.2f} us); "
              f"kernel at {nbytes / ms / 1e9:.3f} TB/s", flush=True)
        entries.append({
            "name": f"group_norm_{kind}", "route": "cuda",
            "source": "fedml_tpu_torch/ops/csrc/group_norm.cu",
            "replaces": ("fedml_tpu/ops/group_norm.py:102" if kind == "fwd"
                         else "fedml_tpu/ops/group_norm.py:115"),
            "launches": None, "max_abs_err": errs[kind], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "path_ms_per_step": path[kind][0],
            "path_bound_ms_per_step": path[kind][1],
            "split_ms_per_server_step": split[kind][0],
            "split_bound_ms_per_server_step": split[kind][1],
            "streamed_ms": streamed[kind][0][0],
            "streamed_bound_ms": streamed[kind][0][1],
            "streamed_library_ms": streamed[kind][0][2],
            "streamed_shape": streamed["shapes"][0],
            "streamed_l1_ms": streamed[kind][1][0],
            "streamed_l1_bound_ms": streamed[kind][1][1],
            "streamed_l1_library_ms": streamed[kind][1][2],
            "streamed_l1_shape": streamed["shapes"][1],
            "r18_shape": "[10x20, 1024, 64] f32 interleaved",
            "r18_ms": r18_main[kind][0], "r18_bound_ms": r18_main[kind][1],
            "r18_library_ms": r18_main["lib"][0 if kind == "fwd" else 1],
            "r18_ms_per_step": r18[kind][0],
            "r18_bound_ms_per_step": r18[kind][1]})
    return entries


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
    flash_attention.launches = flash_attention.copies = 0
    t0 = time.perf_counter()
    with obs_trace.using(tracer), mgr:
        reqs = [mgr.submit(cid, toks, max_new_tokens=N_NEW)
                for cid, toks in reqs_in]
        results = [r.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches}
    copies = flash_attention.copies
    stats = mgr.stats()
    batches = int(stats["serve/batch_fill_count"])
    print(f"[serve] {N_REQUESTS} requests in {batches} batches, "
          f"{wall:.3f} s wall; flash_fwd launches {launches['flash_fwd']} "
          f"(expected {N_LAYERS} x {batches}), copies {copies}", flush=True)
    check(copies == 0, f"{copies} copies on the way to the flash kernel")
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
    prefill_ms = time_ms(lambda: fwd.batched(st, tokens), warmup=1, reps=5,
                         inner=1)
    d2h_ms = time_ms(lambda: fwd.batched(st, tokens).cpu(), warmup=1,
                     reps=5, inner=1) - prefill_ms
    dec_prefill_ms = time_ms(lambda: dec.prefill(st, tokens, lens=lens),
                             warmup=1, reps=3, inner=1)
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
    launches["flash_fwd"] += _rollout_drill(fwd, store, glob, reqs_in)
    return launches


def _rollout_drill(fwd, store, glob, reqs_in):
    """The rollout gate over the serving plane at T 2048: a candidate
    published under epoch 1, shadow traffic mirrored through the plane
    (the flash forward for the batch and for each arm), promoted, rolled
    back bit-equal; a NaN candidate blocked; a coordinator restarted from
    its directory resumes mid-promotion and refuses the dead epoch.
    Returns the flash forward launches of the mirrored batches."""
    import tempfile

    from fedml_tpu_torch.core.flat import vector_to_tree_np
    from fedml_tpu_torch.ops.flash_attention import flash_attention
    from fedml_tpu_torch.serve import (RolloutCoordinator, ServeManager,
                                       StaleEpochError)

    t0 = time.perf_counter()
    batch = reqs_in[:MAX_BATCH]

    def manager():
        return ServeManager(fwd, store, glob, seq_len=SEQ_LEN,
                            max_batch=MAX_BATCH)

    def drive(mgr):
        """One mirrored micro-batch, served synchronously."""
        reqs = [mgr.submit(cid, toks) for cid, toks in batch]
        mgr.serve_batch([mgr._q.get_nowait() for _ in reqs])
        for r in reqs:
            r.result(timeout=600)

    def live(mgr):
        return mgr._vec(mgr.live_adapters())

    def tree(vec):
        return vector_to_tree_np(vec, fwd.spec)

    flash_attention.launches = flash_attention.copies = 0
    with tempfile.TemporaryDirectory() as directory:
        mgr = manager()
        co = RolloutCoordinator(mgr, directory=directory,
                                regression_tol=ROLLOUT_TOL)
        live0 = live(mgr).copy()
        cand = live0 + np.random.default_rng(SEED + 1).normal(
            0, ROLLOUT_NOISE, live0.shape).astype(np.float32)
        v1 = co.publish(tree(cand), epoch=1)
        drive(mgr)
        verdict = co.try_promote()
        print(f"[serve/rollout] candidate v{v1} (live + N(0, "
              f"{ROLLOUT_NOISE})) under epoch 1, one mirrored batch: "
              f"{verdict}", flush=True)
        check(verdict["promoted"] and np.array_equal(live(mgr), cand),
              f"the candidate did not go live: {verdict}")
        t1 = time.perf_counter()
        back = co.rollback()
        rollback_ms = (time.perf_counter() - t1) * 1e3
        same = np.array_equal(live(mgr), live0)
        print(f"[serve/rollout] rollback to v{back} in {rollback_ms:.1f} ms"
              f": live vector {'bit-equal' if same else 'DIFFERENT'} to the"
              f" one before ({live0.size} f32)", flush=True)
        check(back == 0 and same, "the rollback is not bit-equal")
        co.publish(tree(np.full_like(live0, np.nan)), epoch=2)
        drive(mgr)
        verdict = co.try_promote()
        print(f"[serve/rollout] NaN candidate under epoch 2: {verdict}",
              flush=True)
        check(not verdict["promoted"]
              and verdict["reason"] == "candidate_ce_not_finite"
              and np.array_equal(live(mgr), live0),
              f"the poisoned candidate was not blocked: {verdict}")
        co.discard()
        v3 = co.publish(tree(cand), epoch=3)
        co.close()  # dies mid-promotion
        mgr2 = manager()
        co2 = RolloutCoordinator(mgr2, directory=directory,
                                 regression_tol=ROLLOUT_TOL)
        staged = mgr2.shadow_scores()["candidate_version"]
        check(co2.fence_epoch == 3 and co2.cand_version == v3 == staged,
              f"restart: fence {co2.fence_epoch}, candidate "
              f"{co2.cand_version}, staged {staged}; expected 3, v{v3}")
        try:
            co2.publish(tree(cand), epoch=3)
        except StaleEpochError as exc:
            print(f"[serve/rollout] restarted coordinator: fence epoch 3, "
                  f"v{v3} staged again; a publish under epoch 3 refused: "
                  f"{exc}", flush=True)
        else:
            raise SmokeFailure("a publish under the dead epoch went through")
        drive(mgr2)
        verdict = co2.try_promote()
        check(verdict["promoted"] and np.array_equal(live(mgr2), cand),
              f"the resumed promotion failed: {verdict}")
        co2.close()
    launches, copies = flash_attention.launches, flash_attention.copies
    want = 3 * 3 * N_LAYERS  # 3 mirrored batches: the batch and 2 arms
    print(f"[serve/rollout] resumed promotion of v{v3}: live bit-equal to "
          f"the candidate; flash_fwd launches {launches} (expected {want}),"
          f" copies {copies}; drill {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(launches == want and copies == 0,
          f"rollout flash launches {launches}, copies {copies}")
    return launches


def _gn_counts():
    from fedml_tpu_torch.ops import group_norm as gn

    return (gn.group_norm_fwd.launches, gn.group_norm_bwd.launches,
            gn.group_norm_bwd.reduce_launches, gn.group_norm.copies,
            gn.group_norm_fwd.streamed)


def _zero_gn_counts():
    from fedml_tpu_torch.ops import group_norm as gn

    gn.group_norm_fwd.launches = gn.group_norm_bwd.launches = 0
    gn.group_norm_bwd.reduce_launches = gn.group_norm.copies = 0
    gn.group_norm_fwd.streamed = 0


def _pad_profile():
    """Holds a profiler's window open, the card idle, for the port's
    ``TRACE_PAD_S`` (``obs/timing.py``): the profiler drops the kernels
    whose timestamps it moves outside its window, and the launch counts
    read from a profile are held exact."""
    from fedml_tpu_torch.obs.timing import TRACE_PAD_S

    torch.cuda.synchronize()
    time.sleep(TRACE_PAD_S)


def _profile_round(run, label, tag="train", kernels=("gn_",),
                   what="GroupNorm kernels", top=12):
    """``run()`` — one replayed round — under torch.profiler, which names
    a graph's kernels on this stack: device time by kernel (the ``top``
    rows), the share of the kernels whose names contain one of
    ``kernels``, and the device idle share of the round (1 - busy / wall,
    busy the union of the kernels' intervals on the timeline: kernels of a
    graph may overlap, so their summed time can exceed the wall time).
    Returns (kernel name, launches, ms) of every kernel with device time,
    or [] if the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profile()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        _pad_profile()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    summed = sum(r[0] for r in rows)
    if not rows:
        print(f"[{tag}] profiler: no device time recorded; device time by "
              "kernel not measured", flush=True)
        return []
    rows.sort(reverse=True)
    own_ms = sum(r[0] for r in rows if any(k in r[2] for k in kernels))
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.time_range.end > ev.time_range.start)
    busy_us, end = 0.0, -math.inf
    for lo, hi in spans:  # the union of the kernels' intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    busy = (f"device busy {busy_us / 1e3:.1f} ms (idle share "
            f"{1 - busy_us / 1e3 / wall_ms:.3f})" if spans else
            "device busy and idle not measured (no kernel intervals)")
    print(f"[{tag}] profiled {label}: wall "
          f"{wall_ms:.1f} ms, {busy}; kernel time summed "
          f"{summed:.1f} ms; {what} {own_ms:.1f} ms "
          f"({own_ms / summed:.3f} of the summed kernel time)", flush=True)
    for ms, count, key in rows[:top]:
        print(f"[{tag}]   {ms:9.2f} ms  x{count:<6d} {key[:110]}",
              flush=True)
    return [(key, count, ms) for ms, count, key in rows]


def _eager_round(api, round_idx):
    """The reference procedure: one eager ``run_round`` and the server
    update, or for a "custom"-protocol class its published step through
    the same cohort gather, uncaptured; returns the round's loss (a device
    tensor)."""
    if api.window_protocol == "custom":
        return api._train_round_fused(round_idx, api._gather_step())
    avg, loss = api.run_round(round_idx)
    api.net = api._server_update(api.net, avg)
    return loss


def _net_copy(net):
    from fedml_tpu_torch.core.tree import tree_map
    from fedml_tpu_torch.trainer.local import NetState

    return NetState(tree_map(torch.clone, net.params),
                    tree_map(torch.clone, net.model_state))


def _net_vec(net):
    """The params and the trained state (BatchNorm's running stats) as one
    f32 vector."""
    from fedml_tpu_torch.core.tree import tree_leaves

    return torch.cat([t.float().flatten() for t in
                      tree_leaves(net.params) + tree_leaves(net.model_state)])


def _snapshot(api):
    """The round state a pin starts each run from: the net, the key and
    the algorithm's carry (FedOpt's server optimizer state)."""
    from fedml_tpu_torch.core.graph import _map

    return (_net_copy(api.net), api.rng.clone(),
            _map(torch.clone, api._window_carry_init()))


def _restore(api, snap):
    from fedml_tpu_torch.core.graph import _map

    net, key, carry = snap
    api.net, api.rng = _net_copy(net), key.clone()
    api._window_carry_commit(_map(torch.clone, carry))


def _state_vec(api):
    """The params and the carry as one f32 vector."""
    from fedml_tpu_torch.core.graph import _leaves

    return torch.cat([_net_vec(api.net)] + [
        t.float().flatten() for t in _leaves(api._window_carry_init())])


def _spread(runs):
    """max |Δ| of the params and of the losses between two runs, each a
    (param vector, [losses]) pair."""
    (pa, la), (pb, lb) = runs
    return ((pa - pb).abs().max().item(),
            max(abs(a - b) for a, b in zip(la, lb)))


def _hold_captured_round(api, round_idx, tag, runs=2):
    """Pin (a): from one start, key and cohort, two eager rounds (the
    reference procedure) give the eager-versus-eager spread, and the
    captured fused round (``train_one_round``, whose first call warms up
    and captures) must lie within it of the first eager round, params and
    carry: bit-equal when the eager rounds are. ``runs=1`` (under cuDNN's
    deterministic mode, where the spread is 0) asks for bit-equality from
    one eager round. Leaves ``api`` after the captured round."""
    from fedml_tpu_torch.core.graph import CapturedStep

    start = _snapshot(api)
    eager, eager_ms = [], []
    for _ in range(runs):
        _restore(api, start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _eager_round(api, round_idx).item()  # .item() syncs
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        eager.append((_state_vec(api), [loss]))
    _restore(api, start)
    captures = CapturedStep.captures
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = api.train_one_round(round_idx)["train_loss"]
    first_ms = (time.perf_counter() - t0) * 1e3
    graph = api._graphs["fused"]
    spread, loss_spread = _spread(eager) if runs > 1 else (0.0, 0.0)
    dist, loss_dist = _spread([eager[0], (_state_vec(api), [loss])])
    ref = ("published step run uncaptured" if api.window_protocol
           == "custom" else "run_round + _server_update")
    print(f"[{tag}] eager rounds ({ref}, the host dispatching every op): "
          f"{' / '.join(f'{t:.1f}' for t in eager_ms)} ms", flush=True)
    print(f"[{tag}] fused round captured: first call {first_ms:.1f} ms, of "
          f"which warm-up + capture {graph.capture_ms:.1f} ms; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print(f"[{tag}] (a) captured fused round vs eager {ref}, one "
          f"start, key and cohort: max|dparam| (params and carry) "
          f"{dist:.3e}, |dloss| {loss_dist:.3e}; eager vs eager "
          f"{spread:.3e}, {loss_spread:.3e} (must be within it; "
          f"{'bit-equal' if dist == loss_dist == 0 else 'not bit-equal'})",
          flush=True)
    check(CapturedStep.captures == captures + 1,
          f"{CapturedStep.captures - captures} captures of the fused round")
    check(dist <= spread and loss_dist <= loss_spread,
          f"the captured round is {dist}, {loss_dist} from the eager one, "
          f"the eager rounds {spread}, {loss_spread} from each other")


def _hold_on_device_rounds(api, n, tag, loops=2):
    """Pin (b): ``train_rounds_on_device(n)`` — its first call warms up and
    captures — against ``n`` eager host-loop rounds fed the same cohorts,
    drawn from the same key chain, within the spread of two such host
    loops (bit-equal when they are). ``loops=1`` asks for bit-equality
    with one host loop."""
    from fedml_tpu_torch.core import keys

    start = _snapshot(api)
    rng, cohorts = start[1].clone(), []
    everyone = torch.arange(api.train_fed.num_clients, device=rng.device)
    for _ in range(n):
        pair = keys.split(rng)
        rng = pair[0]
        cohort = api._device_cohort(pair[1])  # None: full participation
        cohorts.append(everyone if cohort is None else cohort)
    host = []
    for _ in range(loops):
        _restore(api, start)
        api.sample_round = lambda r: cohorts[r]
        try:
            losses = [_eager_round(api, r).item() for r in range(n)]
        finally:
            del api.sample_round
        host.append((_state_vec(api), losses))
    _restore(api, start)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = api.train_rounds_on_device(n).tolist()
    first_ms = (time.perf_counter() - t0) * 1e3
    graph = api._graphs["on_device"]
    spread, loss_spread = _spread(host) if loops > 1 else (0.0, 0.0)
    dist, loss_dist = _spread([host[0], (_state_vec(api), losses)])
    print(f"[{tag}] train_rounds_on_device({n}) warm call (captures): "
          f"{first_ms:.1f} ms, of which warm-up + capture "
          f"{graph.capture_ms:.1f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; cohorts "
          f"{[c.tolist() for c in cohorts]}",
          flush=True)
    print(f"[{tag}] (b) on-device rounds vs {n} eager host-loop rounds fed "
          f"the same cohorts: max|dparam| (params and carry) {dist:.3e}, "
          f"max|dloss| "
          f"{loss_dist:.3e}; host loop vs host loop {spread:.3e}, "
          f"{loss_spread:.3e}{' (one loop)' if loops == 1 else ''} (must "
          f"be within it; "
          f"{'bit-equal' if dist == loss_dist == 0 else 'not bit-equal'})",
          flush=True)
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(dist <= spread and loss_dist <= loss_spread,
          f"the on-device rounds are {dist}, {loss_dist} from the host "
          f"loop, two host loops {spread}, {loss_spread} from each other")


def _time_pipelined(api, n, tag, per_round, unit):
    """``train_rounds_pipelined(n)``: n replayed fused rounds with no sync
    between them, timed to its return (it fetches the losses once)."""
    from fedml_tpu_torch.core.graph import CapturedStep

    replays = CapturedStep.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = api.train_rounds_pipelined(n, start_round=2)
    ms = (time.perf_counter() - t0) * 1e3 / n
    replays = CapturedStep.replays - replays
    print(f"[{tag}] train_rounds_pipelined({n}): {ms:.2f} ms a round = "
          f"{per_round / ms * 1e3:.1f} {unit}/s; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; {replays} replays",
          flush=True)
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(replays == n, f"{replays} replays in {n} pipelined rounds")


def _time_on_device(api, n, tag, per_round, unit, zero, counts):
    """Three timed calls of ``train_rounds_on_device(n)``, each synced by
    fetching its losses (bench.py's timing); the counts are zeroed just
    before and returned as read just after, with the median round ms."""
    from fedml_tpu_torch.core.graph import CapturedStep

    zero()
    replays = CapturedStep.replays
    call_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses = api.train_rounds_on_device(n).tolist()
        call_ms.append((time.perf_counter() - t0) * 1e3)
    got = counts()
    replays = CapturedStep.replays - replays
    med = statistics.median(call_ms) / n
    print(f"[{tag}] train_rounds_on_device({n}), 3 timed calls: "
          f"{' / '.join(f'{t:.1f}' for t in call_ms)} ms; median round "
          f"{med:.2f} ms = {per_round / med * 1e3:.1f} {unit}/s, "
          f"{1e3 / med:.3f} rounds/s; last losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; {replays} replays",
          flush=True)
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(replays == 3 * n, f"{replays} replays in {3 * n} rounds")
    return got, med


class _ShapeTally:
    """The extension, tallying the (S, C) of every GroupNorm forward."""

    def __init__(self, ext):
        self._ext = ext
        self.shapes = {}

    def __getattr__(self, name):
        return getattr(self._ext, name)

    def group_norm_fwd(self, x, *args):
        key = tuple(x.shape[2:])
        self.shapes[key] = self.shapes.get(key, 0) + 1
        return self._ext.group_norm_fwd(x, *args)


class _SkipOneSamplePerRow:
    """Planted fault for the round check: the extension with its dγ/dβ
    reduce leaving out the last sample of every row (1 of 32 per client)."""

    def __init__(self, ext):
        self._ext = ext

    def __getattr__(self, name):
        return getattr(self._ext, name)

    def group_norm_reduce(self, part_g, part_b, rows):
        dg, db = self._ext.group_norm_reduce(part_g, part_b, rows)
        last = part_g.shape[0] // rows - 1
        return (dg - part_g.view(rows, last + 1, -1)[:, last],
                db - part_b.view(rows, last + 1, -1)[:, last])


@functools.lru_cache(maxsize=1)
def _cifar_samples():
    """The primary config's data: 128 x 256 CIFAR-shaped samples and
    labels from the seed (bench.py _synthetic_cifar_fed), made once for
    the eight phases that build on them (~3 s each time otherwise) and
    read-only."""
    rng = np.random.RandomState(SEED)
    x = rng.randn(TRAIN_CLIENTS * TRAIN_PER_CLIENT, 32, 32, 3).astype(
        np.float32)
    y = rng.randint(0, 10, size=len(x)).astype(np.int32)
    x.flags.writeable = y.flags.writeable = False
    return x, y


def _family_samples():
    """The round-family phases' data (algos, custom, zoo): the primary
    config's first FAMILY_PER_CLIENT samples of each of its 128 clients'
    shares (2 local steps a round at batch 32 instead of 8; cut in PR 18
    to pay for the dp and cli phases: a capture and an eager round cost
    host dispatch per step)."""
    x, y = _cifar_samples()
    n = TRAIN_CLIENTS * FAMILY_PER_CLIENT
    return x[:n], y[:n]


def phase_train(shared=None):
    """ResNet-56-GN FedAvg through FedAvgAPI at the primary config;
    returns {kernel name: launches in the timed rounds}. The median
    on-device round ms goes to ``shared["fedavg_on_device_ms"]``, the zoo
    phase's baseline, when ``shared`` is given."""
    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data import (build_federated_arrays, gather_clients,
                                      partition_homo)
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import group_norm as gn
    from fedml_tpu_torch.trainer.local import NetState

    t0 = time.perf_counter()
    x, y = _cifar_samples()
    fed = build_federated_arrays(x, y, partition_homo(len(x), TRAIN_CLIENTS),
                                 TRAIN_BATCH, device="cuda")
    del x, y
    cfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                    client_num_per_round=TRAIN_PER_ROUND, comm_round=1,
                    epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED)

    def build(gn_fn=None, dtype="bf16", lr=TRAIN_LR):
        model = create_model("resnet56", num_classes=10, dtype=dtype,
                             gn_fn=gn_fn, device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
        return FedAvgAPI(model, fed, None, dataclasses.replace(cfg, lr=lr),
                         device="cuda")

    api = build()
    n_params = sum(v.numel() for v in api.net.params.values())
    steps = fed.steps_per_epoch * cfg.epochs
    print(f"[train] resnet56 GroupNorm bf16 ({n_params} params), "
          f"{TRAIN_CLIENTS} clients x {TRAIN_PER_CLIENT} samples [32, 32, "
          f"3], batch {TRAIN_BATCH}, {TRAIN_PER_ROUND} clients per round, "
          f"{steps} local steps per round, sgd lr {TRAIN_LR}; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # The eager warm-up round (the reference procedure) tallies the
    # forward's shapes against GN_STEP.
    ext = gn.extension
    tally = _ShapeTally(ext())
    gn.extension = lambda: tally
    t0 = time.perf_counter()
    try:
        warm = _eager_round(api, 0).item()
    finally:
        gn.extension = ext
    print(f"[train] eager warm-up round: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, loss {warm:.4f}; "
          f"GroupNorm forwards by (S, C): {tally.shapes}", flush=True)
    want_shapes = {(s, c): steps * n for (_, s, c), _, n in GN_STEP}
    check(tally.shapes == want_shapes,
          f"GroupNorm forward shapes {tally.shapes}, expected {want_shapes}")

    # (a) The captured fused round against the eager one; its first call
    # captures the graph that train_one_round replays from then on.
    _hold_captured_round(api, 1, "train", runs=1)

    samples = TRAIN_PER_ROUND * TRAIN_PER_CLIENT * cfg.epochs
    _zero_gn_counts()
    replays = CapturedStep.replays
    round_ms, losses = [], []
    for r in range(2, TRAIN_ROUNDS + 2):
        t0 = time.perf_counter()
        out = api.train_one_round(r)  # float(loss) syncs the round
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(out["train_loss"])
    fwd, bwd, red, copies, streamed = _gn_counts()
    replays = CapturedStep.replays - replays
    want = TRAIN_ROUNDS * steps * RESNET56_GN
    med = statistics.median(round_ms)
    print(f"[train] train_one_round (replayed fused round) "
          f"{' / '.join(f'{t:.1f}' for t in round_ms)} ms (median "
          f"{med:.1f} ms = {samples / med * 1e3:.1f} samples/s, "
          f"{steps / med * 1e3:.2f} steps/s); losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; {replays} replays",
          flush=True)
    print(f"[train] GroupNorm launches in the replayed rounds: fwd {fwd}, "
          f"bwd {bwd}, reduce {red} (expected {want} each = {TRAIN_ROUNDS} "
          f"rounds x {steps} steps x {RESNET56_GN}); forwards on the "
          f"streamed route {streamed}; copies of an operand {copies} "
          f"({copies / (TRAIN_ROUNDS * steps):.1f} per step)", flush=True)
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(replays == TRAIN_ROUNDS, f"{replays} replays in {TRAIN_ROUNDS} "
          "rounds")
    check(fwd == bwd == red == want,
          f"GroupNorm launches fwd {fwd} bwd {bwd} reduce {red}, "
          f"expected {want}")
    check(streamed == 0, f"{streamed} GroupNorm forwards streamed")
    _time_pipelined(api, TRAIN_ROUNDS, "train", samples, "samples")

    # (b) train_rounds_on_device: its first call captures (bench.py's warm
    # call) and is held to the host loop fed the same cohorts; then three
    # timed calls, each synced by fetching the losses.
    _hold_on_device_rounds(api, TRAIN_ROUNDS, "train", loops=1)
    launches, on_device_ms = _time_on_device(
        api, TRAIN_ROUNDS, "train", samples, "samples", _zero_gn_counts,
        _gn_counts)
    if shared is not None:
        shared["fedavg_on_device_ms"] = on_device_ms
        shared["flagship"] = api  # the obs phase's, its graphs captured
    fwd, bwd, red, copies, streamed = launches
    want = 3 * TRAIN_ROUNDS * steps * RESNET56_GN
    print(f"[train] GroupNorm launches in the timed on-device calls: fwd "
          f"{fwd}, bwd {bwd}, reduce {red} (expected {want} each = 3 calls x "
          f"{TRAIN_ROUNDS} rounds x {steps} steps x {RESNET56_GN}); streamed "
          f"{streamed}; copies {copies}", flush=True)
    check(fwd == bwd == red == want,
          f"on-device GroupNorm launches fwd {fwd} bwd {bwd} reduce {red}, "
          f"expected {want}")
    check(streamed == 0, f"{streamed} GroupNorm forwards streamed")

    # Kernel vs plain twin from the same start and keys: one local step of
    # a sampled cohort (well conditioned) in f32 and in bf16, then one
    # whole round in f32 at ROUND_LR, with and without a planted fault in
    # the kernel path.
    start = {k: v.clone() for k, v in api.net.params.items()}
    key = api.rng.clone()
    twin = build(gn_fn=gn.group_norm_plain)
    api32 = build(dtype=None)
    twin32 = build(gn_fn=gn.group_norm_plain, dtype=None)
    api32r = build(dtype=None, lr=ROUND_LR)
    twin32r = build(gn_fn=gn.group_norm_plain, dtype=None, lr=ROUND_LR)
    sub = gather_clients(fed, sample_clients(TRAIN_ROUNDS + 1, TRAIN_CLIENTS,
                                             TRAIN_PER_ROUND))
    net0 = NetState(start, {})
    rngs = torch.arange(TRAIN_PER_ROUND, device="cuda")
    one = (sub.x[:, :1], sub.y[:, :1], sub.mask[:, :1])

    def updates(a, b):
        return torch.cat([(a[k] - b[k]).flatten() for k in b])

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def step(a):
        return updates(a.local_train.run_clients(net0, *one, rngs)[0].params,
                       start)

    step_k, step_t = step(api), step(twin)
    step_k32, step_t32 = step(api32), step(twin32)
    rel_f32 = rel(step_k32, step_t32)
    rel_k, rel_t = rel(step_k, step_t32), rel(step_t, step_t32)

    def round_from(a):
        a.net, a.rng = NetState(dict(start), {}), key.clone()
        a.train_one_round(TRAIN_ROUNDS + 1)
        return updates(a.net.params, start)

    round_k, round_t = round_from(api32r), round_from(twin32r)
    # The fault goes into a fresh api: api32r replays the graph it
    # captured with the sound kernels.
    api32f = build(dtype=None, lr=ROUND_LR)
    ext = gn.extension
    gn.extension = lambda: _SkipOneSamplePerRow(ext())
    try:
        round_f = round_from(api32f)
    finally:
        gn.extension = ext
    rel_round, rel_fault = rel(round_k, round_t), rel(round_f, round_t)
    print(f"[train] GroupNorm kernel vs plain twin, same start and keys, "
          f"|update diff|/|update|: one local step in f32 {rel_f32:.4e} "
          f"(tol {STEP_F32_TOL}); in bf16, kernel {rel_k:.4e} and twin "
          f"{rel_t:.4e} from the f32 twin's step (tol: kernel <= 1.5 x "
          f"twin + {STEP_BF16_SLACK}); one round in f32 at lr {ROUND_LR} "
          f"{rel_round:.4e} "
          f"(tol {ROUND_F32_TOL}), and with the planted fault (reduce "
          f"skips one sample per client) {rel_fault:.4e} (must exceed the "
          f"tol); |round update| {round_t.norm().item():.4f}", flush=True)
    check(math.isfinite(rel_f32) and rel_f32 <= STEP_F32_TOL,
          f"f32 kernel step disagrees with the plain twin: {rel_f32}")
    check(math.isfinite(rel_k) and rel_k <= 1.5 * rel_t + STEP_BF16_SLACK,
          f"bf16 kernel step is {rel_k} from f32, the twin {rel_t}")
    check(math.isfinite(rel_round) and rel_round <= ROUND_F32_TOL,
          f"f32 kernel round disagrees with the plain twin: {rel_round}")
    check(not rel_fault <= ROUND_F32_TOL,
          f"the round check passed a planted fault: {rel_fault}")
    del twin, api32, twin32, api32r, twin32r, api32f
    names = ("gn_fwd_kernel", "gn_fwd_streamed_kernel", "gn_bwd_kernel",
             "gn_reduce_kernel")
    _profile_round(lambda: api.train_rounds_on_device(1).tolist(),
                   "on-device round (train_rounds_on_device(1))", top=0)
    rows = _profile_round(lambda: api.train_one_round(TRAIN_ROUNDS + 2),
                          "replayed fused round (train_one_round)")
    if rows:  # every forward on the cluster-resident kernel
        ran = {n: sum(c for key, c, _ in rows if n in key) for n in names}
        dev = {n: round(sum(ms for key, _, ms in rows if n in key), 3)
               for n in names}
        print(f"[train] profiled round, GroupNorm launches by kernel name: "
              f"{ran}; device ms: {dev}", flush=True)
        check(ran["gn_fwd_kernel"] == steps * RESNET56_GN
              and ran["gn_fwd_streamed_kernel"] == 0,
              f"the profiled round's GroupNorm forwards: {ran}")
    return {"group_norm_fwd": fwd, "group_norm_bwd": bwd}


def _free():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _replayed_rounds(api, rounds, tag, steps, samples):
    """``train_one_round`` for ``rounds`` (already captured), the GroupNorm
    counts zeroed just before and read just after: 58 launches of each
    kernel per local step, no forward streamed. Returns (fwd, bwd, median
    round ms, losses, copies)."""
    from fedml_tpu_torch.core.graph import CapturedStep

    _zero_gn_counts()
    replays = CapturedStep.replays
    round_ms, losses = [], []
    for r in rounds:
        t0 = time.perf_counter()
        losses.append(api.train_one_round(r)["train_loss"])  # syncs
        round_ms.append((time.perf_counter() - t0) * 1e3)
    fwd, bwd, red, copies, streamed = _gn_counts()
    replays = CapturedStep.replays - replays
    want = len(rounds) * steps * RESNET56_GN
    med = statistics.median(round_ms)
    print(f"[{tag}] train_one_round (replayed) "
          f"{' / '.join(f'{t:.1f}' for t in round_ms)} ms (median {med:.1f}"
          f" ms = {samples / med * 1e3:.1f} samples/s); losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; {replays} replays; "
          f"GroupNorm launches fwd {fwd}, bwd {bwd}, reduce {red} (expected "
          f"{want} each = {len(rounds)} rounds x {steps} steps x "
          f"{RESNET56_GN}), streamed {streamed}, copies {copies}",
          flush=True)
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(replays == len(rounds), f"{replays} replays in {len(rounds)} "
          "rounds")
    check(fwd == bwd == red == want,
          f"GroupNorm launches fwd {fwd} bwd {bwd} reduce {red}, expected "
          f"{want}")
    check(streamed == 0, f"{streamed} GroupNorm forwards streamed")
    return fwd, bwd, med, losses, copies


def _added_ms(rows, base):
    """Device ms of the launches a profiled round has beyond a baseline
    round: per kernel name, the extra launches at that kernel's mean
    time. Returns (ms, launches)."""
    have = {key: (count, ms) for key, count, ms in base}
    ms = launches = 0
    for key, count, t in rows:
        extra = count - have.get(key, (0, 0.0))[0]
        if extra > 0:
            ms += t / count * extra
            launches += extra
    return ms, launches


def phase_algos(shared=None):
    """The algorithms on FedAvg's round at the primary config (ResNet-56-GN
    bf16, 128 x 64 samples, batch 32, 8 per round, sgd lr 0.1): FedAdam,
    FedProx, FedAvgRobust with each robust aggregator and the attack
    drill, and FedNova on a Dirichlet split; the pins hold the captured
    rounds bit-equal to one eager run each. Returns {kernel name:
    launches in its counted rounds}; FedAdam's api goes to
    ``shared["fedadam"]`` when ``shared`` is given."""
    from fedml_tpu_torch.algos import (FedAvgRobustAPI, FedConfig,
                                       FedNovaAPI, FedOptAPI, FedProxAPI)
    from fedml_tpu_torch.algos.capability import refusal
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.data import (build_federated_arrays,
                                      partition_dirichlet, partition_homo)
    from fedml_tpu_torch.models import create_model

    t_phase = time.perf_counter()
    x, y = _family_samples()
    fed = build_federated_arrays(x, y, partition_homo(len(x), TRAIN_CLIENTS),
                                 TRAIN_BATCH, device="cuda")
    cfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                    client_num_per_round=TRAIN_PER_ROUND, comm_round=1,
                    epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED)
    steps = fed.steps_per_epoch * cfg.epochs
    samples = TRAIN_PER_ROUND * FAMILY_PER_CLIENT * cfg.epochs
    counted = {"group_norm_fwd": 0, "group_norm_bwd": 0}

    def count(fwd, bwd):
        counted["group_norm_fwd"] += fwd
        counted["group_norm_bwd"] += bwd

    def build(cls, data=fed, **kw):
        model = create_model("resnet56", num_classes=10, dtype="bf16",
                             device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
        return cls(model, data, None, dataclasses.replace(cfg, **kw),
                   device="cuda")

    # 1. FedAdam: pins (a) and (b), each from one eager run (bit-equal),
    # the step count carried, three timed on-device calls. The api is kept
    # for the ckpt phase's resume pin.
    tag = "algos/fedadam"
    api = build(FedOptAPI, server_optimizer="adam", server_lr=ALGO_SERVER_LR)

    def adam_count():
        return int(api.server_opt_state["0"]["count"])

    print(f"[{tag}] FedOptAPI adam, server lr {ALGO_SERVER_LR}", flush=True)
    _hold_captured_round(api, 0, tag, runs=1)
    check(adam_count() == 1, f"step count {adam_count()} after 1 round")
    before = adam_count()
    _hold_on_device_rounds(api, ALGO_ROUNDS, tag, loops=1)
    check(adam_count() == before + ALGO_ROUNDS,
          f"step count {adam_count()} after {ALGO_ROUNDS} on-device rounds "
          f"from {before}")
    before = adam_count()
    (fwd, bwd, red, copies, streamed), _ = _time_on_device(
        api, ALGO_ROUNDS, tag, samples, "samples", _zero_gn_counts,
        _gn_counts)
    want = 3 * ALGO_ROUNDS * steps * RESNET56_GN
    print(f"[{tag}] GroupNorm launches in the timed on-device calls: fwd "
          f"{fwd}, bwd {bwd}, reduce {red} (expected {want} each); streamed "
          f"{streamed}; step count {before} -> {adam_count()}", flush=True)
    check(fwd == bwd == red == want, f"on-device GroupNorm launches fwd "
          f"{fwd} bwd {bwd} reduce {red}, expected {want}")
    check(streamed == 0, f"{streamed} GroupNorm forwards streamed")
    check(adam_count() == before + 3 * ALGO_ROUNDS,
          f"step count {adam_count()} after {3 * ALGO_ROUNDS} rounds from "
          f"{before}")
    count(fwd, bwd)
    if shared is not None:
        shared["fedadam"] = api
    del api
    _free()

    # 2. FedProx: pin (a), three replayed rounds.
    tag = "algos/fedprox"
    api = build(FedProxAPI, fedprox_mu=ALGO_PROX_MU)
    print(f"[{tag}] FedProxAPI mu {ALGO_PROX_MU}", flush=True)
    _hold_captured_round(api, 0, tag, runs=1)
    count(*_replayed_rounds(api, range(1, 1 + ALGO_ROUNDS), tag, steps,
                            samples)[:2])
    del api
    _free()

    # 3. FedAvgRobust: norm clip, the scale drill on one adversary in every
    # round, and each robust aggregator; a mean round with the same clip
    # and drill is the profile's baseline.
    drill = dict(robust_norm_bound=ALGO_NORM_BOUND, corrupt_mode="scale",
                 attack_num_adversaries=1, attack_freq=1)
    profiles = {}
    for spec in ("mean",) + ALGO_AGGREGATORS:
        tag = f"algos/robust-{spec}"
        api = build(FedAvgRobustAPI, aggregator=spec, **drill)
        if spec == "mean":
            api.train_one_round(0)  # captures
        else:
            print(f"[{tag}] FedAvgRobustAPI aggregator {spec}, norm bound "
                  f"{ALGO_NORM_BOUND}, corrupt_mode scale x"
                  f"{api.cfg.corrupt_scale}, adversary "
                  f"{api.adversary_clients.tolist()} in every round; "
                  f"cohort of round 0 {api.sample_round(0).tolist()}",
                  flush=True)
            _hold_captured_round(api, 0, tag, runs=1)
        if spec == ALGO_AGGREGATORS[0]:
            count(*_replayed_rounds(api, range(1, 1 + ALGO_ROUNDS), tag,
                                    steps, samples)[:2])
        profiles[spec] = _profile_round(
            lambda: api.train_one_round(ALGO_ROUNDS + 1),
            f"replayed round, aggregator {spec}", tag=tag, top=0)
        del api
        _free()
    for spec in ALGO_AGGREGATORS:
        if profiles[spec] and profiles["mean"]:
            ms, n = _added_ms(profiles[spec], profiles["mean"])
            print(f"[algos/robust-{spec}] aggregator in the profiled round: "
                  f"{ms:.3f} ms device time over {n} launches beyond the "
                  f"mean round's (same clip and drill)", flush=True)
        else:
            print(f"[algos/robust-{spec}] aggregator device ms: not "
                  "measured (no profiler device time)", flush=True)
    del fed
    _free()

    # 4. FedNova on a Dirichlet split of the same samples: unequal client
    # sizes, so tau, q and gamma change from round to round.
    tag = "algos/fednova"
    parts = partition_dirichlet(y, TRAIN_CLIENTS, NOVA_ALPHA, seed=SEED)
    sizes = sorted(len(v) for v in parts.values())
    nfed = build_federated_arrays(x, y, parts, TRAIN_BATCH, device="cuda")
    del x, y
    nsteps = nfed.steps_per_epoch * cfg.epochs
    api = build(FedNovaAPI, data=nfed)
    gammas = [float(api._round_aux(r, api.sample_round(r))[1])
              for r in range(ALGO_ROUNDS)]
    print(f"[{tag}] FedNovaAPI on partition_dirichlet(alpha {NOVA_ALPHA}): "
          f"client sizes {sizes[0]}..{sizes[-1]} (median "
          f"{sizes[len(sizes) // 2]}), {nsteps} packed steps per epoch; "
          f"gamma of rounds 0-{ALGO_ROUNDS - 1}: {gammas}", flush=True)
    check(len(set(gammas)) == ALGO_ROUNDS and 1.0 not in gammas,
          f"FedNova's gamma does not change per round: {gammas}")
    start = _snapshot(api)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [_eager_round(api, r).item() for r in range(ALGO_ROUNDS)]
    host_ms = [(time.perf_counter() - t0) * 1e3 / ALGO_ROUNDS]
    host = [(_state_vec(api), losses)]
    _restore(api, start)
    replays = CapturedStep.replays
    t0 = time.perf_counter()
    losses = api.train_rounds_pipelined(ALGO_ROUNDS)
    first_ms = (time.perf_counter() - t0) * 1e3
    spread, loss_spread = 0.0, 0.0  # one eager loop: bit-equal
    dist, loss_dist = _spread([host[0], (_state_vec(api), losses)])
    print(f"[{tag}] eager rounds {' / '.join(f'{t:.1f}' for t in host_ms)} "
          f"ms each; train_rounds_pipelined({ALGO_ROUNDS}) first call "
          f"(captures) {first_ms:.1f} ms, of which warm-up + capture "
          f"{api._graphs['fused'].capture_ms:.1f} ms; vs the eager rounds: "
          f"max|dparam| {dist:.3e}, max|dloss| {loss_dist:.3e} (one eager "
          f"loop: must be 0, {spread:.0e}, {loss_spread:.0e}; "
          f"{'bit-equal' if dist == loss_dist == 0 else 'not bit-equal'})",
          flush=True)
    check(CapturedStep.replays - replays == ALGO_ROUNDS,
          f"{CapturedStep.replays - replays} replays in {ALGO_ROUNDS} rounds")
    check(dist <= spread and loss_dist <= loss_spread,
          f"the pipelined FedNova rounds are {dist}, {loss_dist} from the "
          f"eager ones, two eager loops {spread}, {loss_spread} apart")
    _zero_gn_counts()
    t0 = time.perf_counter()
    losses = api.train_rounds_pipelined(ALGO_ROUNDS, start_round=ALGO_ROUNDS)
    ms = (time.perf_counter() - t0) * 1e3 / ALGO_ROUNDS
    fwd, bwd, red, copies, streamed = _gn_counts()
    want = ALGO_ROUNDS * nsteps * RESNET56_GN
    print(f"[{tag}] train_rounds_pipelined({ALGO_ROUNDS}) replayed: {ms:.1f}"
          f" ms a round; losses {' '.join(f'{v:.4f}' for v in losses)}; "
          f"GroupNorm launches fwd {fwd}, bwd {bwd}, reduce {red} (expected "
          f"{want} each = {ALGO_ROUNDS} rounds x {nsteps} steps x "
          f"{RESNET56_GN}), streamed {streamed}", flush=True)
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(fwd == bwd == red == want, f"FedNova GroupNorm launches fwd {fwd}"
          f" bwd {bwd} reduce {red}, expected {want}")
    check(streamed == 0, f"{streamed} GroupNorm forwards streamed")
    count(fwd, bwd)
    want_msg = refusal(FedNovaAPI, "train_rounds_on_device")
    try:
        api.train_rounds_on_device(1)
    except NotImplementedError as exc:
        check(str(exc) == want_msg, f"FedNova's on-device refusal: {exc}")
        print(f"[{tag}] train_rounds_on_device refused: {exc}", flush=True)
    else:
        raise SmokeFailure("FedNova's on-device tier ran; its record "
                           "refuses it")
    del api, nfed
    _free()
    print(f"[algos] phase took {time.perf_counter() - t_phase:.1f} s; "
          f"GroupNorm launches counted {counted}", flush=True)
    return counted


def _client_rows_equal(before, after, clients):
    """Whether every leaf's row of each client in ``clients`` is bitwise
    the same in two ``{name: [N, ...]}`` stacks."""
    return all(torch.equal(before[k][c], after[k][c])
               for k in before for c in clients)


def _mean_invariant(server, rows):
    """max |s - mean_k s_k| over the leaves, and max |s_k|."""
    err = max((server[k] - rows[k].mean(0)).abs().max().item()
              for k in server)
    scale = max(rows[k].abs().max().item() for k in rows)
    return err, scale


def _fedavg_baseline(fed, cfg, tag, count):
    """FedAvg from the seed at the round-family config, the baseline of
    the "custom" and zoo phases: round 0 captures, rounds 1-2 replay,
    rounds 3-5 replay counted and timed, then a warm and 3 timed
    ``train_rounds_on_device(ZOO_ROUNDS)`` calls. Returns the nets after
    rounds 0, 2 and 5 (``r0``, ``r2``, ``r5``), the replayed and the
    on-device median ms and the capture ms; ``count(fwd, bwd)`` takes the
    GroupNorm launches."""
    from fedml_tpu_torch.algos import FedAvgAPI
    from fedml_tpu_torch.models import create_model

    model = create_model("resnet56", num_classes=10, dtype="bf16",
                         device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    api = FedAvgAPI(model, fed, None, cfg, device="cuda")
    api.train_one_round(0)  # warm-up and capture
    out = {"r0": _net_copy(api.net)}
    for r in (1, 2):
        api.train_one_round(r)
    out["r2"] = _net_copy(api.net)
    steps = fed.steps_per_epoch * cfg.epochs
    samples = TRAIN_PER_ROUND * FAMILY_PER_CLIENT * cfg.epochs
    fwd, bwd, med, _, copies = _replayed_rounds(api, range(3, 6), tag, steps,
                                                samples)
    check(copies == 0, f"{copies} GroupNorm operand copies")
    count(fwd, bwd)
    out.update(r5=_net_copy(api.net), replayed=med,
               capture_ms=api._graphs["fused"].capture_ms)
    api.train_rounds_on_device(ZOO_ROUNDS)  # warm-up and capture
    (fwd, bwd, _, _, _), out["on_device"] = _time_on_device(
        api, ZOO_ROUNDS, tag, samples, "samples", _zero_gn_counts,
        _gn_counts)
    count(fwd, bwd)
    del api
    _free()
    return out


def phase_custom(shared=None):
    """The "custom" carry protocol at the primary config (ResNet-56-GN
    bf16, 128 x 64 samples, batch 32, 8 per round, 1 epoch, sgd lr 0.1):
    FedAvg's replayed rounds as the baseline of the same call, then
    SCAFFOLD, FedDyn, Ditto and FedBN, each with pin (a) against its
    published step run eagerly, replayed rounds counted and timed, and its
    own pins. Returns {kernel name: launches in its counted rounds}; the
    FedAvg baseline (``shared["fedavg"]``, which the zoo phase reuses) and
    SCAFFOLD's api (``shared["scaffold"]``, for the ckpt phase) go to
    ``shared`` when it is given."""
    from fedml_tpu_torch.algos import (DittoAPI, FedBNAPI, FedConfig,
                                       FedDynAPI, ScaffoldAPI)
    from fedml_tpu_torch.algos.capability import refusal
    from fedml_tpu_torch.algos.fedbn import norm_mask
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model

    t_phase = time.perf_counter()
    card = smi_line()
    x, y = _family_samples()
    fed = build_federated_arrays(x, y, partition_homo(len(x), TRAIN_CLIENTS),
                                 TRAIN_BATCH, device="cuda")
    del x, y
    cfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                    client_num_per_round=TRAIN_PER_ROUND, comm_round=1,
                    epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED)
    steps = fed.steps_per_epoch * cfg.epochs
    samples = TRAIN_PER_ROUND * FAMILY_PER_CLIENT * cfg.epochs
    counted = {"group_norm_fwd": 0, "group_norm_bwd": 0}
    summary = {}

    def build(cls, **kw):
        model = create_model("resnet56", num_classes=10, dtype="bf16",
                             device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
        return cls(model, fed, None, cfg, device="cuda", **kw)

    def replay(api, rounds, tag, trainings=1):
        fwd, bwd, med, losses, copies = _replayed_rounds(
            api, rounds, tag, trainings * steps, samples)
        check(copies == 0, f"{copies} GroupNorm operand copies")
        counted["group_norm_fwd"] += fwd
        counted["group_norm_bwd"] += bwd
        return med, losses

    def captured(api, tag):
        _hold_captured_round(api, 0, tag, runs=1)
        return (api._graphs["fused"].capture_ms,
                torch.cuda.max_memory_allocated() / 2**30)

    def refuses_on_device(api, tag):
        want = refusal(type(api), "train_rounds_on_device")
        try:
            api.train_rounds_on_device(1)
        except NotImplementedError as exc:
            check(str(exc) == want, f"on-device refusal: {exc}")
            print(f"[{tag}] train_rounds_on_device refused: {exc}",
                  flush=True)
        else:
            raise SmokeFailure(f"{tag}: the on-device tier ran; its record "
                               "refuses it")

    def sampled(api, rounds):
        return {int(i) for r in rounds for i in api.sample_round(r)}

    # 0. FedAvg from the same seed: the baseline of the call, and the
    # global rounds Ditto must reproduce bit for bit.
    def count(fwd, bwd):
        counted["group_norm_fwd"] += fwd
        counted["group_norm_bwd"] += bwd

    fedavg = _fedavg_baseline(fed, cfg, "custom/fedavg", count)
    if shared is not None:
        shared["fedavg"] = fedavg
    fedavg_vec3 = _net_vec(fedavg["r2"])
    fedavg_vec6 = _net_vec(fedavg["r5"])
    summary["FedAvgAPI"] = (fedavg["replayed"], fedavg["capture_ms"], None)

    # 1-2. SCAFFOLD and FedDyn: (a), 3 replayed rounds and the same 3
    # rounds pipelined from one start, bit-equal; the server state is the
    # mean of the client states; the on-device refusal.
    for cls, kw, server, rows_of in (
            (ScaffoldAPI, dict(server_lr=1.0), "server_control",
             "client_controls"),
            (FedDynAPI, dict(alpha=CUSTOM_ALPHA), "server_h",
             "client_grads")):
        tag = f"custom/{cls.__name__}"
        api = build(cls, **kw)
        print(f"[{tag}] {cls.__name__} {kw}; client stack "
              f"{sum(t.numel() for t in getattr(api, rows_of).values())} "
              "f32 values", flush=True)
        capture_ms, peak = captured(api, tag)
        start = _snapshot(api)
        med, losses = replay(api, range(1, 4), tag)
        want = _state_vec(api)
        _restore(api, start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        piped = api.train_rounds_pipelined(3, start_round=1)
        pipe_ms = (time.perf_counter() - t0) * 1e3 / 3
        same = piped == losses and torch.equal(_state_vec(api), want)
        print(f"[{tag}] train_rounds_pipelined(3) {pipe_ms:.1f} ms a round; "
              f"vs 3 train_one_round from one start: "
              f"{'bit-equal' if same else 'DIFFERENT'} (losses {piped})",
              flush=True)
        check(same, f"{tag}: pipelined rounds differ from train_one_round")
        err, scale = _mean_invariant(getattr(api, server),
                                     getattr(api, rows_of))
        print(f"[{tag}] {server} = mean_k {rows_of}[k] after 4 rounds: "
              f"max|diff| {err:.3e} (bound {1e-6 * max(1.0, scale):.1e}; "
              f"max|state| {scale:.3e})", flush=True)
        check(0 < scale and err <= 1e-6 * max(1.0, scale),
              f"{tag}: server state {err} from the clients' mean")
        refuses_on_device(api, tag)
        summary[cls.__name__] = (med, capture_ms, peak)
        if shared is not None and cls is ScaffoldAPI:
            shared["scaffold"] = api
        del api, start
        _free()

    # 3. Ditto: (a); its global model bit-equal to FedAvg's after 3 and 6
    # rounds; the personal nets of clients never sampled unchanged.
    tag = "custom/DittoAPI"
    api = build(DittoAPI, lam=CUSTOM_LAM)
    init = {k: v.clone() for k, v in api.net.params.items()}
    capture_ms, peak = captured(api, tag)
    replay(api, (1, 2), tag, trainings=2)
    same3 = torch.equal(_net_vec(api.net), fedavg_vec3)
    med, _ = replay(api, range(3, 6), tag, trainings=2)
    same6 = torch.equal(_net_vec(api.net), fedavg_vec6)
    print(f"[{tag}] global model vs FedAvg's replayed rounds from the same "
          f"seed: after 3 rounds {'bit-equal' if same3 else 'DIFFERENT'}, "
          f"after 6 {'bit-equal' if same6 else 'DIFFERENT'}", flush=True)
    check(same3 and same6, "Ditto's global model differs from FedAvg's")
    rows = api.personal_nets.params
    seen = sampled(api, range(6))
    unseen = set(range(TRAIN_CLIENTS)) - seen
    start_rows = {k: v.unsqueeze(0).expand_as(rows[k]) for k, v in
                  init.items()}
    moved = [c for c in seen if not _client_rows_equal(start_rows, rows,
                                                       [c])]
    print(f"[{tag}] personal nets: {len(unseen)} clients never sampled, "
          f"all unchanged: {_client_rows_equal(start_rows, rows, unseen)}; "
          f"{len(moved)} of {len(seen)} sampled moved", flush=True)
    check(_client_rows_equal(start_rows, rows, unseen),
          "an unsampled client's personal net changed")
    check(len(moved) == len(seen), "a sampled client's personal net did "
          "not move")
    t0 = time.perf_counter()
    ev = api.evaluate_personalized()
    print(f"[{tag}] evaluate_personalized over {TRAIN_CLIENTS} clients "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms: {ev}", flush=True)
    check(all(math.isfinite(v) for v in ev.values()), f"non-finite {ev}")
    refuses_on_device(api, tag)
    summary["DittoAPI"] = (med, capture_ms, peak)
    del api
    _free()

    # 4. FedBN: (a); the global norm leaves unchanged from init; the
    # unsampled clients' norms unchanged, the sampled ones moved.
    tag = "custom/FedBNAPI"
    api = build(FedBNAPI)
    mask = norm_mask(api.net.params)
    init = {k: v.clone() for k, v in api.net.params.items() if mask[k]}
    print(f"[{tag}] {len(init)} norm leaves, "
          f"{sum(v.numel() for v in init.values())} values per client",
          flush=True)
    capture_ms, peak = captured(api, tag)
    med, _ = replay(api, range(1, 4), tag)
    kept = all(torch.equal(api.net.params[k], v) for k, v in init.items())
    rows = api.local_norms
    seen = sampled(api, range(4))
    unseen = set(range(TRAIN_CLIENTS)) - seen
    start_rows = {k: v.unsqueeze(0).expand_as(rows[k]) for k, v in
                  init.items()}
    moved = [c for c in seen if not _client_rows_equal(start_rows, rows,
                                                       [c])]
    print(f"[{tag}] global norm leaves unchanged from init: {kept}; "
          f"{len(unseen)} clients never sampled, norms unchanged: "
          f"{_client_rows_equal(start_rows, rows, unseen)}; {len(moved)} "
          f"of {len(seen)} sampled moved", flush=True)
    check(kept, "FedBN's global norm leaves changed")
    check(_client_rows_equal(start_rows, rows, unseen),
          "an unsampled client's norms changed")
    check(len(moved) == len(seen), "a sampled client's norms did not move")
    t0 = time.perf_counter()
    ev = api.evaluate_personalized()
    print(f"[{tag}] evaluate_personalized over {TRAIN_CLIENTS} clients "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms: {ev}", flush=True)
    check(all(math.isfinite(v) for v in ev.values()), f"non-finite {ev}")
    refuses_on_device(api, tag)
    summary["FedBNAPI"] = (med, capture_ms, peak)
    del api, fed
    _free()

    base = summary["FedAvgAPI"][0]
    for name, (med, capture_ms, peak) in summary.items():
        extra = (f"; capture {capture_ms:.1f} ms, peak device memory "
                 f"{peak:.2f} GiB" if peak is not None else "")
        print(f"[custom] {name}: replayed round median {med:.1f} ms = "
              f"{samples / med * 1e3:.1f} samples/s ({med - base:+.1f} ms "
              f"beside FedAvg's {base:.1f} ms in this call){extra}; card "
              f"{card}", flush=True)
    print(f"[custom] phase took {time.perf_counter() - t_phase:.1f} s; "
          f"GroupNorm launches counted {counted}", flush=True)
    return counted


def _rel(a, b):
    """max over leaves of max|a - b| / max|b| (two {name: tensor} trees)."""
    return max(((a[k].float() - b[k].float()).abs().max()
                / b[k].float().abs().max().clamp(min=1e-30)).item()
               for k in b)


def _refused(api, tier, call, tag):
    """``call()`` must raise the record's refusal of ``tier``, which for a
    class that opts out quotes its ``window_exclusion``."""
    from fedml_tpu_torch.algos.capability import refusal

    want = refusal(type(api), tier)
    try:
        call()
    except NotImplementedError as exc:
        check(str(exc) == want, f"{tag}: {tier} refusal: {exc}")
        quoted = getattr(type(api), "window_exclusion", None)
        check(quoted is None or quoted in str(exc),
              f"{tag}: the refusal does not quote the window_exclusion")
        print(f"[{tag}] {tier} refused: {exc}", flush=True)
    else:
        raise SmokeFailure(f"{tag}: {tier} ran; its record refuses it")


def _counted(run, tag, want_fwd, want_bwd):
    """``run()`` with the GroupNorm counts zeroed just before and read just
    after: ``want_fwd`` forward and ``want_bwd`` backward and reduce
    launches, none streamed, no operand copied. Returns (fwd, bwd, what
    ``run`` returned)."""
    _zero_gn_counts()
    out = run()
    fwd, bwd, red, copies, streamed = _gn_counts()
    print(f"[{tag}] GroupNorm launches fwd {fwd}, bwd {bwd}, reduce {red} "
          f"(expected {want_fwd}, {want_bwd}, {want_bwd}), streamed "
          f"{streamed}, copies {copies}", flush=True)
    check(fwd == want_fwd and bwd == red == want_bwd,
          f"{tag}: GroupNorm launches fwd {fwd} bwd {bwd} reduce {red}, "
          f"expected {want_fwd}, {want_bwd}")
    check(streamed == 0 and copies == 0,
          f"{tag}: {streamed} forwards streamed, {copies} operand copies")
    return fwd, bwd, out


def _timed_rounds(api, rounds, tag, samples):
    """``train_one_round`` for ``rounds`` (each ends in a sync: its loss),
    timed on the host: (median ms, losses)."""
    round_ms, losses = [], []
    for r in rounds:
        t0 = time.perf_counter()
        losses.append(api.train_one_round(r)["train_loss"])
        round_ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(round_ms)
    print(f"[{tag}] train_one_round {' / '.join(f'{t:.1f}' for t in round_ms)}"
          f" ms (median {med:.1f} ms = {samples / med * 1e3:.1f} samples/s);"
          f" losses {' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    return med, losses


def phase_zoo(shared=None):
    """The rest of the FedAvg-round family at the primary config
    (ResNet-56-GN bf16, 128 x 64 samples, batch 32, 8 per round, 1 epoch,
    sgd lr 0.1): FedAvg's replayed rounds as the call's baseline (the
    "custom" phase's, ``shared["fedavg"]``, when given; its on-device
    round the train phase's, ``shared["fedavg_on_device_ms"]``), then
    FedAc, ServerAvg, q-FedAvg, hierarchical FL, TurboAggregate, and DSGD
    and PushSum over the first 32 clients, each with its pins (bit-equal
    to one eager run), counted rounds and a line beside FedAvg's. Returns
    {kernel name: launches in its counted rounds}."""
    from fedml_tpu_torch.algos import (DecentralizedAPI, FedAcAPI,
                                       FedConfig, HierarchicalFedAvgAPI,
                                       QFedAvgAPI,
                                       ServerAvgAPI, TurboAggregateAPI)
    from fedml_tpu_torch.algos.qfedavg import make_loss_at_global
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.core.topology import (AsymmetricTopologyManager,
                                               SymmetricTopologyManager)
    from fedml_tpu_torch.core.tree import tree_map
    from fedml_tpu_torch.data import (build_federated_arrays, gather_clients,
                                      partition_homo)
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.obs import trace
    from fedml_tpu_torch.trainer.local import NetState

    t_phase = time.perf_counter()
    card = smi_line()
    x, y = _family_samples()
    parts = partition_homo(len(x), TRAIN_CLIENTS)
    fed = build_federated_arrays(x, y, parts, TRAIN_BATCH, device="cuda")
    fed32 = build_federated_arrays(
        x, y, {c: parts[c] for c in range(ZOO_GOSSIP_CLIENTS)}, TRAIN_BATCH,
        device="cuda")
    del x, y
    cfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                    client_num_per_round=TRAIN_PER_ROUND, comm_round=1,
                    epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED)
    steps = fed.steps_per_epoch * cfg.epochs
    per_round = steps * RESNET56_GN  # GroupNorm launches a cohort training
    samples = TRAIN_PER_ROUND * FAMILY_PER_CLIENT * cfg.epochs
    counted = {"group_norm_fwd": 0, "group_norm_bwd": 0}
    summary = {}  # class: (tier, median round ms, samples, capture ms,
    #                       peak GiB, GroupNorm fwd / bwd a round)
    base = {}

    def count(fwd, bwd):
        counted["group_norm_fwd"] += fwd
        counted["group_norm_bwd"] += bwd

    def model():
        return create_model("resnet56", num_classes=10, dtype="bf16",
                            device="cuda",
                            generator=torch.Generator().manual_seed(SEED))

    def build(cls, c=cfg, **kw):
        return cls(model(), fed, None, c, device="cuda", **kw)

    def peak():
        return torch.cuda.max_memory_allocated() / 2**30

    def api_cohort(r):
        return sample_clients(r, TRAIN_CLIENTS, TRAIN_PER_ROUND)

    # 0. FedAvg from the same seed: the baseline of the call, and the
    # rounds that FedAc at gamma 1, ServerAvg at beta 0 and one-group
    # hierarchical FL are held to.
    shared = {} if shared is None else shared
    fedavg = shared.get("fedavg") or _fedavg_baseline(
        fed, cfg, "zoo/FedAvgAPI", count)
    fedavg_r0, fedavg_r2 = fedavg["r0"].params, fedavg["r2"].params
    base["replayed"] = fedavg["replayed"]
    base["on-device"] = fedavg["on_device"]

    # 1-2. FedAc (gamma 2) and ServerAvg (beta 0.5, avg_start 0): (a), (b)
    # and three timed on-device calls.
    for cls, kw in ((FedAcAPI, dict(gamma=ZOO_FEDAC_GAMMA)),
                    (ServerAvgAPI, dict(avg_coef=ZOO_SAVG_BETA,
                                        avg_start=0))):
        tag = f"zoo/{cls.__name__}"
        api = build(cls, **kw)
        print(f"[{tag}] {cls.__name__} {kw}", flush=True)
        _hold_captured_round(api, 0, tag, runs=1)
        capture_ms = api._graphs["fused"].capture_ms
        _hold_on_device_rounds(api, ZOO_PIN_ROUNDS, tag, loops=1)
        mem = peak()
        (fwd, bwd, red, copies, streamed), med = _time_on_device(
            api, ZOO_ROUNDS, tag, samples, "samples", _zero_gn_counts,
            _gn_counts)
        want = 3 * ZOO_ROUNDS * per_round
        print(f"[{tag}] GroupNorm launches in the timed on-device calls: "
              f"fwd {fwd}, bwd {bwd}, reduce {red} (expected {want} each), "
              f"streamed {streamed}, copies {copies}", flush=True)
        check(fwd == bwd == red == want and streamed == copies == 0,
              f"{tag}: on-device GroupNorm launches {fwd} {bwd} {red}, "
              f"{streamed} streamed, {copies} copies")
        count(fwd, bwd)
        summary[cls.__name__] = ("on-device", med, samples, capture_ms, mem,
                                 fwd // (3 * ZOO_ROUNDS),
                                 bwd // (3 * ZOO_ROUNDS))
        del api
        _free()

    # FedAc at gamma 1 is FedAvg's round up to md - (md - avg) (its round
    # eager: no capture for one round); ServerAvg at beta 0 is FedAvg's
    # rounds bit for bit.
    tag = "zoo/FedAcAPI"
    api = build(FedAcAPI, gamma=1.0)
    _eager_round(api, 0)
    rel = _rel(api.net.params, fedavg_r0)
    print(f"[{tag}] gamma 1 (alpha {api.alpha}, beta {api.beta}): eager "
          f"round 0 vs FedAvg's captured one from the same start, key and "
          f"cohort: max over "
          f"leaves of max|d| / max|p| {rel:.3e} (bound {ZOO_REL_TOL:.0e}; "
          f"{'bit-equal' if rel == 0 else 'not bit-equal'})", flush=True)
    check(rel <= ZOO_REL_TOL, f"FedAc at gamma 1 is {rel} from FedAvg")
    del api
    _free()
    tag = "zoo/ServerAvgAPI"
    api = build(ServerAvgAPI, avg_coef=0.0)
    for r in range(3):
        api.train_one_round(r)
    same = all(torch.equal(api.net.params[k], v)
               for k, v in fedavg_r2.items())
    print(f"[{tag}] beta 0: after 3 replayed rounds vs FedAvg's: "
          f"{'bit-equal' if same else 'DIFFERENT'}; running mean over "
          f"{float(api._savg_state[1]):.0f} globals", flush=True)
    check(same, "ServerAvg at beta 0 differs from FedAvg")
    del api, fedavg_r2
    _free()

    # 3. q-FedAvg (q 1): (a), 3 counted replayed rounds (F_global's
    # forward-only pass doubles the GroupNorm forwards), an on-device call
    # that captures and a counted one; F_global against an eager loss.
    tag = "zoo/QFedAvgAPI"
    api = build(QFedAvgAPI, q=ZOO_Q)
    print(f"[{tag}] QFedAvgAPI q {ZOO_Q}, L = 1/lr = {1 / TRAIN_LR:g}",
          flush=True)
    _hold_captured_round(api, 0, tag, runs=1)
    capture_ms, mem = api._graphs["fused"].capture_ms, peak()
    fwd, bwd, (med, _) = _counted(
        lambda: _timed_rounds(api, range(1, 4), tag, samples), tag,
        3 * 2 * per_round, 3 * per_round)
    count(fwd, bwd)
    print(f"[{tag}] a round: {fwd // 3} GroupNorm forwards against "
          f"{bwd // 3} backwards ({fwd // 3 - bwd // 3} of them F_global's)",
          flush=True)
    t0 = time.perf_counter()
    losses = api.train_rounds_on_device(ZOO_ROUNDS).tolist()
    print(f"[{tag}] train_rounds_on_device({ZOO_ROUNDS}) warm call "
          f"(captures) {(time.perf_counter() - t0) * 1e3:.1f} ms; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    t0 = time.perf_counter()
    fwd, bwd, losses = _counted(
        lambda: api.train_rounds_on_device(ZOO_ROUNDS).tolist(), tag,
        ZOO_ROUNDS * 2 * per_round, ZOO_ROUNDS * per_round)
    dev_ms = (time.perf_counter() - t0) * 1e3 / ZOO_ROUNDS
    print(f"[{tag}] train_rounds_on_device({ZOO_ROUNDS}) replayed: "
          f"{dev_ms:.1f} ms a round = {samples / dev_ms * 1e3:.1f} "
          f"samples/s; losses {' '.join(f'{v:.4f}' for v in losses)}",
          flush=True)
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    count(fwd, bwd)
    sub = gather_clients(fed, api._cohort_on_device(api.sample_round(7)))
    F = make_loss_at_global(api.fns.apply, api._loss_fn)(
        api.net, sub.x, sub.y, sub.mask)
    eager = torch.stack([api.eval_fn(api.net, sub.x[c], sub.y[c],
                                     sub.mask[c])["loss"]
                         for c in range(sub.x.shape[0])])
    err = ((F - eager).abs() / eager.abs()).max().item()
    print(f"[{tag}] F_global of round 7's cohort (the vmapped forward-only "
          f"pass) vs an eager loss of the broadcast net on each client's "
          f"shard: {' '.join(f'{v:.4f}' for v in F.tolist())}; max "
          f"relative diff {err:.3e} (bound {ZOO_FGLOBAL_TOL:.0e})",
          flush=True)
    check(err <= ZOO_FGLOBAL_TOL, f"F_global {err} from the eager loss")
    summary["QFedAvgAPI"] = ("replayed", med, samples, capture_ms, mem,
                             fwd // ZOO_ROUNDS, bwd // ZOO_ROUNDS)
    del api, sub, F, eager
    _free()

    # 4. Hierarchical FL: groups client % 4, group_comm_round 2; one
    # captured inner round per padded group size.
    tag = "zoo/HierarchicalFedAvgAPI"
    gids = np.arange(TRAIN_CLIENTS) % ZOO_GROUPS
    hcfg = dataclasses.replace(cfg, group_comm_round=ZOO_GROUP_ROUNDS)
    api = build(HierarchicalFedAvgAPI, c=hcfg, group_ids=gids)

    def padded(r):
        """The padded group sizes of round ``r`` (powers of two)."""
        idx = api.sample_round(r)
        return {1 << (int((gids[idx] == g).sum()) - 1).bit_length()
                for g in np.unique(gids[idx])}

    captures = CapturedStep.captures
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for r in range(3):
        api.train_one_round(r)
    warm_ms = (time.perf_counter() - t0) * 1e3
    mem = peak()
    sizes = {int(k[5:]) for k in api._graphs}
    capture_ms = sum(g.capture_ms for g in api._graphs.values())
    print(f"[{tag}] groups client % {ZOO_GROUPS}, group_comm_round "
          f"{ZOO_GROUP_ROUNDS}; warm-up rounds 0-2 {warm_ms:.1f} ms with "
          f"{CapturedStep.captures - captures} captures (padded group sizes "
          f"{sorted(sizes)}; warm-up + capture {capture_ms / 1e3:.2f} s)",
          flush=True)
    # Timed: the first ZOO_ROUNDS later rounds whose padded sizes are
    # captured.
    rounds = [r for r in range(3, 200) if padded(r) <= sizes][:ZOO_ROUNDS]
    groups = [len(np.unique(gids[api.sample_round(r)])) for r in rounds]
    captures = CapturedStep.captures
    want = sum(groups) * ZOO_GROUP_ROUNDS * per_round
    trained = TRAIN_PER_ROUND * FAMILY_PER_CLIENT * ZOO_GROUP_ROUNDS
    fwd, bwd, (med, _) = _counted(
        lambda: _timed_rounds(api, rounds, tag, trained), tag, want, want)
    count(fwd, bwd)
    check(CapturedStep.captures == captures, "a timed round captured")
    print(f"[{tag}] rounds {rounds}: groups per round {groups} (x "
          f"{ZOO_GROUP_ROUNDS} inner rounds), 0 captures; samples/s counts "
          f"each client's {ZOO_GROUP_ROUNDS} trainings", flush=True)
    _refused(api, "train_rounds_pipelined",
             lambda: api.train_rounds_pipelined(1), tag)
    _refused(api, "train_rounds_on_device",
             lambda: api.train_rounds_on_device(1), tag)
    summary["HierarchicalFedAvgAPI"] = (
        "host loop", med, trained, capture_ms, mem,
        fwd // len(rounds), bwd // len(rounds))
    del api
    _free()
    api = build(HierarchicalFedAvgAPI, group_ids=np.zeros(TRAIN_CLIENTS, int))
    api.train_one_round(0)
    rel = _rel(api.net.params, fedavg_r0)
    print(f"[{tag}] one group, group_comm_round 1: round 0 vs FedAvg's "
          f"from the same start, key and cohort: max over leaves of "
          f"max|d| / max|p| {rel:.3e} (bound {ZOO_REL_TOL:.0e}; "
          f"{'bit-equal' if rel == 0 else 'not bit-equal'})", flush=True)
    check(rel <= ZOO_REL_TOL, f"one-group hierarchical is {rel} from FedAvg")
    del api, fedavg_r0
    _free()
    # coord_median over two groups of 4 of round 0's cohort: one capture.
    halves = np.zeros(TRAIN_CLIENTS, int)
    halves[api_cohort(0)[TRAIN_PER_ROUND // 2:]] = 1
    api = build(HierarchicalFedAvgAPI,
                c=dataclasses.replace(hcfg, aggregator="coord_median"),
                group_ids=halves)
    out = api.train_one_round(0)
    finite = all(torch.isfinite(v).all().item()
                 for v in api.net.params.values())
    print(f"[{tag}] aggregator coord_median (within each of 2 groups of "
          f"{TRAIN_PER_ROUND // 2} and across the group partials): round 0 "
          f"loss {out['train_loss']:.4f}, params finite {finite}",
          flush=True)
    check(finite and math.isfinite(out["train_loss"]),
          "the coord_median hierarchical round is not finite")
    del api
    _free()
    try:
        build(HierarchicalFedAvgAPI,
              c=dataclasses.replace(hcfg, aggregator="krum1"),
              group_ids=gids)
    except NotImplementedError as exc:
        check("krum1" in str(exc) and "does not compose group-wise"
              in str(exc), f"krum's refusal: {exc}")
        print(f"[{tag}] krum1 refused: {exc}", flush=True)
    else:
        raise SmokeFailure("hierarchical FL accepted krum")
    _free()

    # 5. TurboAggregate (3 groups): the cohort trained on the card, the
    # stack copied to the host once, the MPC there.
    tag = "zoo/TurboAggregateAPI"
    api = build(TurboAggregateAPI, n_groups=ZOO_TA_GROUPS)
    torch.cuda.reset_peak_memory_stats()
    api.train_one_round(0)  # warm-up and capture
    capture_ms, mem = api._graphs["local_batch"].capture_ms, peak()
    tracer = trace.SpanTracer()

    def traced():
        with trace.using(tracer):
            return _timed_rounds(api, range(1, 4), tag, samples)

    fwd, bwd, (med, _) = _counted(traced, tag, 3 * per_round, 3 * per_round)
    count(fwd, bwd)
    spans = {}
    for ev in tracer.events():
        spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    n_values = sum(v.numel() for v in api.net.params.values())
    for r in range(3):
        print(f"[{tag}] round {r + 1}: device training "
              f"{spans['turbo.train'][r]:.1f} ms, D2H of the {TRAIN_PER_ROUND}"
              f" x {n_values} stack {spans['turbo.d2h'][r]:.1f} ms, host MPC "
              f"({ZOO_TA_GROUPS} groups) {spans['turbo.mpc'][r]:.1f} ms",
              flush=True)
    for r, dropped in ((4, None), (5, [0])):
        api.set_dropout(dropped)
        seen = {}
        train = api._train_clients

        def record(idx, key):
            params, losses = train(idx, key)
            seen["w"] = fed.counts.cpu().numpy()[idx].astype(np.float64)
            seen["stack"] = {k: v.double() for k, v in params.items()}
            return params, losses

        api._train_clients = record
        api.train_one_round(r)
        del api._train_clients
        w = seen["w"]
        if dropped:
            w[dropped] = 0.0
        w = torch.tensor(w / w.sum(), dtype=torch.float64, device="cuda")
        worst = 0.0
        for k, p in seen["stack"].items():
            mean = torch.einsum("c,c...->...", w, p)
            bound = TRAIN_PER_ROUND * 0.5 / 2**16 + mean.abs() * 2.0**-23
            worst = max(worst, ((api.net.params[k].double() - mean).abs()
                                / bound).max().item())
        print(f"[{tag}] round {r}"
              f"{' with client 0 dropped' if dropped else ''}: the MPC "
              f"aggregate vs the f64 weighted mean of the same client stack"
              f": max |d| / bound {worst:.3f} (must be <= 1; bound "
              f"{TRAIN_PER_ROUND} x 0.5/2^16 + the f32 cast)", flush=True)
        check(worst <= 1.0, f"{tag}: MPC aggregate off by {worst} bounds")
    api.set_dropout(None)
    _refused(api, "train_rounds_pipelined",
             lambda: api.train_rounds_pipelined(1), tag)
    _refused(api, "train_rounds_on_device",
             lambda: api.train_rounds_on_device(1), tag)
    summary["TurboAggregateAPI"] = ("host loop", med, samples, capture_ms,
                                    mem, fwd // 3, bwd // 3)
    del api
    _free()

    # 6. DSGD and PushSum over the first 32 clients, every client every
    # round.
    gsamples = ZOO_GOSSIP_CLIENTS * FAMILY_PER_CLIENT * cfg.epochs
    gcfg = dataclasses.replace(cfg, client_num_in_total=ZOO_GOSSIP_CLIENTS,
                               client_num_per_round=ZOO_GOSSIP_CLIENTS)
    for mode, topo in (
            ("dsgd", SymmetricTopologyManager(ZOO_GOSSIP_CLIENTS,
                                              neighbor_num=4, seed=SEED)),
            ("pushsum", AsymmetricTopologyManager(ZOO_GOSSIP_CLIENTS,
                                                  neighbor_num=2,
                                                  seed=SEED))):
        tag = f"zoo/DecentralizedAPI-{mode}"
        api = DecentralizedAPI(model(), fed32, None, gcfg, topo, mode=mode,
                               device="cuda")

        def snap():
            return (NetState(tree_map(torch.clone, api.nets.params), {}),
                    api.push_weights.clone(), api.rng.clone())

        def restore(s):
            api.nets = NetState(tree_map(torch.clone, s[0].params), {})
            api.push_weights, api.rng = s[1].clone(), s[2].clone()

        def state():
            return torch.cat([api.push_weights] + [
                p.float().flatten() for p in api.nets.params.values()])

        start = snap()
        api._round_step = api._gossip_step  # the uncaptured round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = api.train_one_round(0)["train_loss"]
        eager_ms = (time.perf_counter() - t0) * 1e3
        del api._round_step
        eager = (state(), [loss])
        restore(start)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = api.train_one_round(0)["train_loss"]
        first_ms = (time.perf_counter() - t0) * 1e3
        capture_ms, mem = api._step.capture_ms, peak()
        dist, loss_dist = _spread([eager, (state(), [loss])])
        print(f"[{tag}] {ZOO_GOSSIP_CLIENTS} clients x {FAMILY_PER_CLIENT} "
              f"samples, {type(topo).__name__}({ZOO_GOSSIP_CLIENTS}, "
              f"neighbor_num={topo.neighbor_num}, seed={SEED}); eager round "
              f"{eager_ms:.1f} ms; the captured round's first call "
              f"{first_ms:.1f} ms, of which warm-up + capture "
              f"{capture_ms:.1f} ms; peak device memory {mem:.2f} GiB",
              flush=True)
        print(f"[{tag}] (a) captured round vs the eager round from one "
              f"start and key: max|d| (stacks and push weights) {dist:.3e}, "
              f"|dloss| {loss_dist:.3e} (must be bit-equal)", flush=True)
        check(dist == loss_dist == 0, f"{tag}: captured round {dist}, "
              f"{loss_dist} from the eager one")
        one = snap()
        spreads = []

        def timed():
            round_ms, losses = [], []
            for r in range(1, 1 + ZOO_ROUNDS):
                t0 = time.perf_counter()
                losses.append(api.train_one_round(r)["train_loss"])
                round_ms.append((time.perf_counter() - t0) * 1e3)
                cons = api.consensus_net().params
                debiased = api._debiased().params
                spreads.append(max((debiased[k] - v[None]).abs().max().item()
                                   for k, v in cons.items()))
            return statistics.median(round_ms), round_ms, losses

        fwd, bwd, (med, round_ms, want_losses) = _counted(
            timed, tag, ZOO_ROUNDS * per_round, ZOO_ROUNDS * per_round)
        count(fwd, bwd)
        want = state()
        wsum = float(api.push_weights.sum())
        print(f"[{tag}] train_one_round (replayed) "
              f"{' / '.join(f'{t:.1f}' for t in round_ms)} ms (median "
              f"{med:.1f} ms = {gsamples / med * 1e3:.1f} samples/s); "
              f"losses {' '.join(f'{v:.4f}' for v in want_losses)}; the "
              f"clients' max |x_i - consensus| after each round "
              f"{' '.join(f'{s:.3e}' for s in spreads)}; push weights sum "
              f"{wsum:.6f}", flush=True)
        check(abs(wsum - ZOO_GOSSIP_CLIENTS) <= 1e-4,
              f"{tag}: push weights sum {wsum}")
        restore(one)
        piped = api.train_rounds_pipelined(ZOO_ROUNDS, start_round=1)
        same_p = piped == want_losses and torch.equal(state(), want)
        restore(one)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = api.train_rounds_on_device(ZOO_ROUNDS).tolist()
        dev_ms = (time.perf_counter() - t0) * 1e3 / ZOO_ROUNDS
        same_d = dev == want_losses and torch.equal(state(), want)
        print(f"[{tag}] from one start, against {ZOO_ROUNDS} "
              f"train_one_round: train_rounds_pipelined({ZOO_ROUNDS}) "
              f"{'bit-equal' if same_p else 'DIFFERENT'}, "
              f"train_rounds_on_device({ZOO_ROUNDS}) "
              f"{'bit-equal' if same_d else 'DIFFERENT'} ({dev_ms:.1f} ms a "
              f"round = {gsamples / dev_ms * 1e3:.1f} samples/s)", flush=True)
        check(same_p and same_d, f"{tag}: the pipelined or on-device rounds "
              "differ from train_one_round")
        summary[f"DecentralizedAPI {mode}"] = (
            "replayed", med, gsamples, capture_ms, mem, fwd // ZOO_ROUNDS,
            bwd // ZOO_ROUNDS)
        del api, start, one, eager
        _free()
    del fed, fed32
    _free()

    on_dev = base["on-device"]
    print(f"[zoo] FedAvgAPI: replayed round {base['replayed']:.1f} ms = "
          f"{samples / base['replayed'] * 1e3:.1f} samples/s, on-device "
          + (f"{on_dev:.2f} ms = {samples / on_dev * 1e3:.1f} samples/s"
             if on_dev else "not measured in this call")
          + f"; card {card}", flush=True)
    for name, (tier, med, n, capture_ms, mem, fwd, bwd) in summary.items():
        kind = "on-device" if tier == "on-device" else "replayed"
        ref = base[kind]
        beside = (f"{med - ref:+.2f} ms beside FedAvg's {ref:.2f} ms {kind}"
                  " in this call" if ref else f"FedAvg's {kind} round not "
                  "measured in this call")
        print(f"[zoo] {name}: {tier} round {med:.2f} ms = "
              f"{n / med * 1e3:.1f} samples/s ({beside}); capture "
              f"{capture_ms / 1e3:.2f} s, peak "
              f"device memory {mem:.2f} GiB; GroupNorm launches a round fwd "
              f"{fwd}, bwd {bwd}, none streamed, no operand copied; card "
              f"{card}", flush=True)
    print(f"[zoo] phase took {time.perf_counter() - t_phase:.1f} s; "
          f"GroupNorm launches counted {counted}", flush=True)
    return counted


def _tree_vec(tree):
    """Every tensor leaf of a tree as one f32 vector."""
    from fedml_tpu_torch.core.graph import _leaves

    return torch.cat([t.float().flatten() for t in _leaves(tree)])


def _norm_count(module):
    """The GroupNorms of a model (each one launch a forward)."""
    from fedml_tpu_torch.models.resnet import Norm

    return sum(isinstance(m, Norm) and m.kind != "none"
               for m in module.modules())


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN in deterministic mode for a pin: its f32 backwards otherwise
    add with atomics, and the split family's f32 chains (8 steps at lr 0.1,
    16 Adam steps) amplify that to the order of the update itself, so two
    eager runs would bound nothing."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def _hold_pin(tag, what, eager, got):
    """``got`` against the first of the ``eager`` runs (one or two), each
    a list of tensors: within the eager runs' own spread, which under
    ``_cudnn_deterministic`` is 0, so bit-equal (one run: bit-equal).
    Returns the distance."""
    spread = (max((a - b).abs().max().item() for a, b in zip(*eager))
              if len(eager) > 1 else 0.0)
    dist = max((a - b).abs().max().item() for a, b in zip(eager[0], got))
    print(f"[{tag}] {what}: captured vs eager max|d| {dist:.3e}; eager vs "
          f"eager {spread:.3e} (must be within it; "
          f"{'bit-equal' if dist == 0 else 'not bit-equal'})", flush=True)
    check(dist <= spread, f"{tag}: {what} is {dist} from the eager run, "
          f"the eager runs {spread} from each other")
    return dist


def _gkt_pins(api, tag, runs=2):
    """FedGKT's pins (a) and (b) from the api's state: (a) the captured
    client phase against ``runs`` eager ones from one start (stumps,
    losses, client logits, the features), (b) the first GKT_PIN_STEPS
    replayed server steps on those features against the eager step (the
    tail, the Adam state and its count, the loss sums). ``runs=1`` asks
    for bit-equality with one eager run."""
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.graph import CapturedStep, _map

    clone = lambda tree: _map(torch.clone, tree)  # noqa: E731
    # (a)
    start = clone(api.client_nets)
    key = keys.fold_in(api.rng, 0xA)
    phase = api._build_client_phase()
    eager, feats0 = [], None
    for run in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nets, losses = phase(clone(start), api._flags[0], key)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if feats0 is None:
            feats0 = api.feats.clone()
        eager.append([_tree_vec(nets), losses.clone(),
                      api.client_logits.clone(),
                      (api.feats - feats0).abs().amax().reshape(1)])
        print(f"[{tag}] eager client phase {run}: {ms:.1f} ms", flush=True)
    api.client_nets = clone(start)
    captures = CapturedStep.captures
    losses = api._run_client_phase(key)
    got = [_tree_vec(api.client_nets), losses.clone(),
           api.client_logits.clone(),
           (api.feats - feats0).abs().amax().reshape(1)]
    _hold_pin(tag, "(a) client phase (stumps, losses, client logits, "
              "features)", eager, got)
    check(CapturedStep.captures == captures + 1, "client phase captures")
    del feats0, eager, got

    # (b) the first GKT_PIN_STEPS replayed server steps against the eager
    # step from one start (the features above).
    sstart = (clone(api.server_net), clone(api.server_state),
              torch.zeros(2, device="cuda"),
              torch.zeros((), dtype=torch.int64, device="cuda"),
              keys.fold_in(api.rng, 0xB))
    sstep = api._build_server_step()
    eager = []
    for _ in range(runs):
        carry = clone(sstart)
        for _ in range(GKT_PIN_STEPS):
            carry, _ = sstep(carry)
        eager.append([_tree_vec(carry)])
    step = api._captured("server", api._build_server_step)
    carry = clone(sstart)
    for _ in range(GKT_PIN_STEPS):
        carry, _ = step(carry)
    _hold_pin(tag, f"(b) {GKT_PIN_STEPS} replayed server steps (tail, "
              "Adam state, loss sums)", eager, [_tree_vec(carry)])
    count = int(carry[1]["0"]["count"])
    check(count == GKT_PIN_STEPS and int(carry[3]) == GKT_PIN_STEPS,
          f"{tag}: Adam count {count}, step index {int(carry[3])} after "
          f"{GKT_PIN_STEPS} replays")


def phase_split():
    """The model-split family at full width on the training data (the first
    SPLIT_CLIENTS clients x 256 CIFAR-shaped samples, batch 32, 1 local
    epoch, lr 0.1):
    FedGKTAPI over resnet5_56 + resnet56_server (f32, GroupNorm) with its
    pins and timed rounds, SplitNNAPI over resnet_split_bottom +
    resnet56_server with its pins and a timed cycle, and VflAPI at the
    NUS-WIDE shape against its own CPU run. Returns {kernel name: launches
    in the counted rounds}."""
    from fedml_tpu_torch.algos import (FedConfig, FedGKTAPI, SplitNNAPI,
                                       VflAPI)
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.graph import CapturedStep, _map
    from fedml_tpu_torch.core.tree import client_rows
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.local import NetState

    t_phase = time.perf_counter()
    card = smi_line()
    x, y = _cifar_samples()
    m = SPLIT_CLIENTS * TRAIN_PER_CLIENT
    fed = build_federated_arrays(x[:m], y[:m], partition_homo(m,
                                                              SPLIT_CLIENTS),
                                 TRAIN_BATCH, device="cuda")
    del x, y
    cfg = FedConfig(client_num_in_total=SPLIT_CLIENTS,
                    client_num_per_round=SPLIT_CLIENTS, comm_round=1,
                    epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED)
    n_c, n_s = fed.num_clients, fed.steps_per_epoch
    cs = n_c * n_s
    samples = cs * TRAIN_BATCH  # a pass over the clients' data
    counted = {"group_norm_fwd": 0, "group_norm_bwd": 0}
    clone = lambda tree: _map(torch.clone, tree)  # noqa: E731

    def models(bottom):
        gen = torch.Generator().manual_seed(SEED)
        kw = dict(device="cuda", generator=gen)
        first = (create_model(bottom, **kw) if bottom == "resnet_split_bottom"
                 else create_model(bottom, num_classes=10, **kw))
        return first, create_model("resnet56_server", num_classes=10, **kw)

    # --- FedGKT ---------------------------------------------------------
    tag = "split/FedGKTAPI"
    stump, tail = models("resnet5_56")
    n_stump, n_tail = _norm_count(stump), _norm_count(tail)
    api = FedGKTAPI(stump, tail, fed, None, cfg, temperature=GKT_T,
                    epochs_server=1, server_lr=GKT_SERVER_LR, device="cuda")
    # A round's forwards: the stump's training and sweep, the tail's
    # training and relabel; backwards: the two trainings.
    want_fwd = n_s * (cfg.epochs + 1) * n_stump + 2 * cs * n_tail
    want_bwd = n_s * cfg.epochs * n_stump + cs * n_tail
    print(f"[{tag}] resnet5_56 ({n_stump} GroupNorms) + resnet56_server "
          f"({n_tail}), f32, {n_c} clients x {n_s} steps of {TRAIN_BATCH}, "
          f"T {GKT_T}, server Adam lr {GKT_SERVER_LR}; features "
          f"{list(api.feats.shape)} f32 ({api.feats.numel() * 4 / 2**30:.2f}"
          f" GiB), read by a device index; GroupNorm launches a round by the "
          f"models: fwd {want_fwd}, bwd {want_bwd} (reckoned 29232, "
          f"14616)", flush=True)

    # Pins (a) and (b) under cuDNN's deterministic mode; their captures
    # are then dropped, and the warm round captures the steps anew in
    # the default mode, which the timed rounds replay.
    start = clone(api.client_nets.params)
    with _cudnn_deterministic():
        _gkt_pins(api, tag)
    api._graphs.clear()
    api.client_nets = NetState(clone(start), {})
    torch.cuda.reset_peak_memory_stats()

    # The warm round (captures the relabel step), then pin (c): round 1's
    # client phase with the teacher against the same replay with
    # have_teacher forced to 0.
    t0 = time.perf_counter()
    warm = api.train_one_round(0)
    warm_ms = (time.perf_counter() - t0) * 1e3
    client_capture, server_capture, relabel_capture = (
        api._graphs[k].capture_ms for k in ("client", "server", "relabel"))
    check(api.have_teacher and api.server_logits.abs().max().item() > 0,
          f"{tag}: no teacher after round 0")
    mid = clone(api.client_nets.params)
    key = keys.split(api.rng, 3)[1]
    with_t = api._run_client_phase(key).mean().item()
    api.client_nets = NetState(clone(mid), {})
    api.have_teacher = False
    without = api._run_client_phase(key).mean().item()
    api.have_teacher = True
    api.client_nets = NetState(mid, {})
    print(f"[{tag}] warm round {warm_ms:.1f} ms (captures its three "
          f"steps): {warm}; (c) round 1's client loss "
          f"with the teacher {with_t:.6f}, with have_teacher forced to 0 "
          f"{without:.6f}", flush=True)
    check(with_t != without, f"{tag}: the teacher did not change the loss")

    # GKT_TIMED timed rounds: the phases by CUDA events recorded behind
    # each, the round by the host clock (it ends in a sync).
    marks = []

    def marked(fn):
        def run(*args):
            out = fn(*args)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            return out
        return run

    for name in ("_run_client_phase", "_run_server_phase", "_run_relabel"):
        setattr(api, name, marked(getattr(api, name)))
    _zero_gn_counts()
    captures, replays = CapturedStep.captures, CapturedStep.replays
    rows = []
    for r in range(1, 1 + GKT_TIMED):
        marks.clear()
        begin = torch.cuda.Event(enable_timing=True)
        begin.record()
        t0 = time.perf_counter()
        m = api.train_one_round(r)
        round_ms = (time.perf_counter() - t0) * 1e3
        ends = [begin] + marks
        phases = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        rows.append((round_ms, *phases))
        print(f"[{tag}] round {r}: {round_ms:.1f} ms (host clock) = client "
              f"phase {phases[0]:.1f} + server phase {phases[1]:.1f} + "
              f"relabel {phases[2]:.1f} ms (device events); client "
              f"{samples / phases[0] * 1e3:.1f} samples/s, server "
              f"{samples / phases[1] * 1e3:.1f} samples/s, round "
              f"{2 * samples / round_ms * 1e3:.1f} samples/s; client_loss "
              f"{m['client_loss']:.4f}, server_loss {m['server_loss']:.4f}",
              flush=True)
        check(math.isfinite(m["client_loss"]) and
              math.isfinite(m["server_loss"]), f"{tag}: non-finite {m}")
    fwd, bwd, red, copies, streamed = _gn_counts()
    captures = CapturedStep.captures - captures
    replays = CapturedStep.replays - replays
    print(f"[{tag}] {GKT_TIMED} timed round(s): {replays} replays, "
          f"{captures} captures; GroupNorm launches fwd {fwd}, bwd {bwd}, "
          f"reduce {red} (expected {GKT_TIMED * want_fwd}, "
          f"{GKT_TIMED * want_bwd}, {GKT_TIMED * want_bwd}), streamed "
          f"{streamed}, copies {copies}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; captures: "
          f"client phase {client_capture:.1f} ms, server step "
          f"{server_capture:.1f} ms, relabel {relabel_capture:.1f} ms; "
          f"{card}", flush=True)
    check(captures == 0 and replays == GKT_TIMED * (1 + 2 * cs),
          f"{tag}: {captures} captures, {replays} replays in {GKT_TIMED} "
          "rounds")
    check(fwd == GKT_TIMED * want_fwd and bwd == red == GKT_TIMED * want_bwd,
          f"{tag}: GroupNorm launches fwd {fwd} bwd {bwd} reduce {red}")
    check(streamed == 0, f"{tag}: {streamed} GroupNorm forwards streamed")
    counted["group_norm_fwd"] += fwd
    counted["group_norm_bwd"] += bwd
    gkt = [statistics.median(col) for col in zip(*rows)]
    # Where a server step's time goes: 16 replays under the profiler.
    n_prof = min(16, cs)
    step = api._graphs["server"]
    carry = (api.server_net, api.server_state,
             torch.zeros(2, device="cuda"),
             torch.zeros((), dtype=torch.int64, device="cuda"),
             keys.fold_in(api.rng, 0xD))

    def server_steps():
        c = carry
        for _ in range(n_prof):
            c, _ = step(c)

    _profile_round(server_steps, f"{n_prof} replayed server steps", tag)
    del step, carry
    del api, stump, tail, start, mid
    _free()

    # --- SplitNN --------------------------------------------------------
    tag = "split/SplitNNAPI"
    bottom, tail = models("resnet_split_bottom")
    per_step = _norm_count(bottom) + _norm_count(tail)
    api = SplitNNAPI(bottom, tail, fed, None, cfg, device="cuda")
    start = (clone(api.client_nets), clone(api.client_opts),
             clone(api.server_net), clone(api.server_opt),
             torch.zeros((), device="cuda"))
    key = keys.split(keys.fold_in(api.rng, 0xC), n_c)[0]
    seg = api._build_segment()

    def row0(carry):
        nets, opts, top, opt_t, loss = carry
        return [_tree_vec(_map(lambda t: t[0], nets)),
                _tree_vec(_map(lambda t: t[0], opts)), _tree_vec(top),
                _tree_vec(opt_t), loss.reshape(1)]

    eager = []
    with _cudnn_deterministic():
        for _ in range(2):
            carry, _ = seg(clone(start), api._ids[0], key)
            eager.append(row0(carry))
        step = api._segment_step()
        carry, _ = step(clone(start), api._ids[0], key)
    _hold_pin(tag, "client 0's segment (its bottom and momentum, the top "
              "and its momentum, the loss)", eager, row0(carry))
    others = all(torch.equal(carry[0].params[k][1:], start[0].params[k][1:])
                 for k in start[0].params)
    print(f"[{tag}] rows 1..{n_c} of the stack (the dustbin too) unchanged "
          f"by client 0's segment: {others}", flush=True)
    check(others, f"{tag}: a segment wrote another client's row")
    api._graphs.clear()
    del eager, carry, step
    init_rows = clone(client_rows(api.client_nets.params))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = api.train_one_epoch(0)
    warm_ms = (time.perf_counter() - t0) * 1e3
    seg_capture = api._graphs["segment"].capture_ms
    moved = [any(not torch.equal(v[c], init_rows[k][c])
                 for k, v in api.client_nets.params.items())
             for c in range(n_c)]
    check(all(moved), f"{tag}: {moved.count(False)} rows unchanged after "
          "a cycle")
    _zero_gn_counts()
    replays = CapturedStep.replays
    t0 = time.perf_counter()
    m = api.train_one_epoch(1)
    cycle_ms = (time.perf_counter() - t0) * 1e3
    fwd, bwd, red, copies, streamed = _gn_counts()
    replays = CapturedStep.replays - replays
    want = cs * per_step
    print(f"[{tag}] resnet_split_bottom + resnet56_server ({per_step} "
          f"GroupNorms a joint step), lr {TRAIN_LR}: warm cycle "
          f"{warm_ms:.1f} ms ({warm['train_loss']:.4f}), every row moved; "
          f"timed cycle {cycle_ms:.1f} ms = {samples / cycle_ms * 1e3:.1f} "
          f"samples/s, loss {m['train_loss']:.4f}; {replays} replays; "
          f"GroupNorm launches fwd {fwd}, bwd {bwd}, reduce {red} (expected "
          f"{want} each; reckoned 15360), streamed {streamed}, copies "
          f"{copies}; segment captured in {seg_capture:.1f} ms; peak device "
          f"memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}",
          flush=True)
    check(math.isfinite(m["train_loss"]), f"{tag}: non-finite {m}")
    check(replays == n_c, f"{tag}: {replays} replays in a cycle")
    check(fwd == bwd == red == want and streamed == 0,
          f"{tag}: GroupNorm launches fwd {fwd} bwd {bwd} reduce {red}, "
          f"{streamed} streamed")
    counted["group_norm_fwd"] += fwd
    counted["group_norm_bwd"] += bwd
    del api, bottom, tail, start, init_rows, fed
    _free()

    # --- vertical FL ----------------------------------------------------
    tag = "split/VflAPI"
    rng = np.random.RandomState(SEED)
    xs = [rng.randn(VFL_N, d).astype(np.float32) for d in VFL_DIMS]
    w = [rng.randn(d) / math.sqrt(d) for d in VFL_DIMS]
    yv = ((xs[0] @ w[0] + xs[1] @ w[1]) > 0).astype(np.int32)
    card_api = VflAPI(list(VFL_DIMS), rep_dim=VFL_REP, lr=VFL_LR, seed=SEED,
                      device="cuda")
    host_api = VflAPI(list(VFL_DIMS), rep_dim=VFL_REP, lr=VFL_LR, seed=SEED,
                      device="cpu")
    acc0 = card_api.evaluate(xs, yv)["accuracy"]
    t0 = time.perf_counter()
    got = card_api.fit(xs, yv, epochs=VFL_EPOCHS, batch_size=VFL_BATCH)
    fit_ms = (time.perf_counter() - t0) * 1e3
    want = host_api.fit(xs, yv, epochs=VFL_EPOCHS, batch_size=VFL_BATCH)
    acc1 = card_api.evaluate(xs, yv)["accuracy"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"[{tag}] parties {VFL_DIMS}, {VFL_N} samples, batch {VFL_BATCH}, "
          f"rep {VFL_REP}, {VFL_EPOCHS} epochs ({len(got)} batches), lr "
          f"{VFL_LR}: fit {fit_ms:.1f} ms on the card; per-batch losses vs "
          f"the CPU run max relative {rel:.3e} (bound {VFL_TOL:.0e}); loss "
          f"{got[0]:.4f} -> {got[-1]:.4f}; accuracy {acc0:.4f} -> "
          f"{acc1:.4f}", flush=True)
    check(len(got) == len(want) and rel <= VFL_TOL,
          f"{tag}: losses {rel} from the CPU run")
    check(acc1 > acc0, f"{tag}: accuracy {acc0} -> {acc1}")

    print(f"[split] FedGKT round {gkt[0]:.1f} ms (client {gkt[1]:.1f}, "
          f"server {gkt[2]:.1f}, relabel {gkt[3]:.1f}); SplitNN cycle "
          f"{cycle_ms:.1f} ms; VFL fit {fit_ms:.1f} ms; phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return counted


def _zoo_counts(run):
    """``run()`` with the GroupNorm counts zeroed just before; returns
    (fwd, bwd, reduce, fwd streamed, bwd streamed, copies, what ``run``
    returned)."""
    from fedml_tpu_torch.ops import group_norm as gn

    _zero_gn_counts()
    gn.group_norm_bwd.streamed = 0
    out = run()
    fwd, bwd, red, copies, fwd_s = _gn_counts()
    return fwd, bwd, red, fwd_s, gn.group_norm_bwd.streamed, copies, out


def _event_rounds(api, rounds, tag, samples):
    """``train_one_round`` for ``rounds`` (captured already), each
    bracketed by CUDA events: (median event ms, median host ms, losses)."""
    ev_ms, host_ms, losses = [], [], []
    for r in rounds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = api.train_one_round(r)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(start.elapsed_time(end))
        losses.append(out["train_loss"])
    med = statistics.median(ev_ms)
    print(f"[{tag}] train_one_round x{len(rounds)} (replayed): "
          f"{' / '.join(f'{t:.1f}' for t in ev_ms)} ms by CUDA events "
          f"(host {' / '.join(f'{t:.1f}' for t in host_ms)} ms); median "
          f"{med:.1f} ms = {samples / med * 1e3:.1f} samples/s; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    check(all(math.isfinite(v) for v in losses), f"{tag}: non-finite "
          f"{losses}")
    return med, statistics.median(host_ms), losses


def _on_device_once(api, tag, samples):
    """One ``train_rounds_on_device(1)`` call (its first: it captures),
    timed by the host clock; the capture's ms and the loss."""
    t0 = time.perf_counter()
    loss = api.train_rounds_on_device(1).tolist()
    ms = (time.perf_counter() - t0) * 1e3
    cap = api._graphs["on_device"].capture_ms
    print(f"[{tag}] train_rounds_on_device(1): {ms:.1f} ms, of which warm-up "
          f"+ capture {cap:.1f} ms; loss {loss[0]:.4f}", flush=True)
    check(all(math.isfinite(v) for v in loss), f"{tag}: non-finite {loss}")
    return ms, cap


def _on_device_replayed(api, tag, samples):
    """One more ``train_rounds_on_device(1)`` call, a replay of its graph,
    bracketed by CUDA events: the round's device ms."""
    from fedml_tpu_torch.core.graph import CapturedStep

    captures = CapturedStep.captures
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loss = api.train_rounds_on_device(1)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    print(f"[{tag}] train_rounds_on_device(1) replayed (captured in cuDNN's "
          f"default mode): {ms:.1f} ms by CUDA events = "
          f"{samples / ms * 1e3:.1f} samples/s; loss {loss.item():.4f}",
          flush=True)
    check(CapturedStep.captures == captures and math.isfinite(loss.item()),
          f"{tag}: on-device replay captured again or lost {loss}")
    return ms


def _alpha_free_norms(model):
    """The search net's GroupNorms whose input does not depend on the
    alphas: the stem, cell 0's preprocessing and its edges out of its two
    inputs, cell 1's preprocessing of its first input (the stem's output)
    and the edges out of it. A gradient in the alphas alone skips their
    backward."""
    from fedml_tpu_torch.models.darts import MixedOp

    cell0, cell1 = model.SearchCell_0, model.SearchCell_1
    mods = [model.Norm_0, getattr(cell0, cell0.pre[0]),
            getattr(cell0, cell0.pre[1]), getattr(cell1, cell1.pre[0])]
    for cell, inputs in ((cell0, (0, 1)), (cell1, (0,))):
        offset = 0
        for i in range(cell.steps):
            for j in range(2 + i):
                if j in inputs:
                    mods.append(getattr(cell, cell.edges[offset + j]))
            offset += 2 + i
    check(all(isinstance(m, MixedOp) for m in mods[4:]), "edges")
    return sum(_norm_count(m) for m in mods)


def _fednas_drives(card):
    """FedNAS at the DARTS search net's full width: the first-order search
    (pin (a) under cuDNN's deterministic mode at NAS_PIN_LAYERS cells, the
    full net's on-device round captured once and 2 replays counted against
    NAS_GN GroupNorm forwards and backwards per search pass and timed, the
    genotype), the unrolled arch gradient through the kernels against the
    plain twin's, and one unrolled round. Returns the counted launches."""
    from fedml_tpu_torch.algos import FedConfig, FedNASAPI
    from fedml_tpu_torch.algos.fednas import make_fednas_local_search
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.group_norm import group_norm_plain
    from fedml_tpu_torch.trainer.local import model_fns

    tag = "extra/FedNASAPI"
    rng = np.random.RandomState(SEED)
    x = rng.randn(NAS_CLIENTS * NAS_PER_CLIENT, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, len(x)).astype(np.int32)
    fed = build_federated_arrays(x, y, partition_homo(len(x), NAS_CLIENTS),
                                 NAS_BATCH, device="cuda")

    def darts(**kw):
        return create_model("darts", num_classes=10, device="cuda",
                            generator=torch.Generator().manual_seed(SEED),
                            **kw)

    def cfg(per_round):
        return FedConfig(client_num_in_total=NAS_CLIENTS,
                         client_num_per_round=per_round, comm_round=3,
                         epochs=1, batch_size=NAS_BATCH, lr=NAS_LR,
                         seed=SEED)

    # Pin (a) at NAS_PIN_LAYERS cells: the captured round bit-equal to the
    # eager one under cuDNN's deterministic mode.
    small = darts(layers=NAS_PIN_LAYERS)
    api = FedNASAPI(small, fed, None, cfg(NAS_PER_ROUND),
                    arch_lr=NAS_ARCH_LR, device="cuda")
    print(f"[{tag}] pin (a) at darts c 16, {NAS_PIN_LAYERS} layers "
          f"({_norm_count(small)} GroupNorms a forward; the cut of the "
          f"host's eager round and capture)", flush=True)
    with _cudnn_deterministic():
        _hold_captured_round(api, 0, tag, runs=1)
    del api, small
    _free()

    model = darts(layers=NAS_LAYERS)
    n_gn, frozen = _norm_count(model), _alpha_free_norms(model)
    half = fed.steps_per_epoch // 2
    # A search step runs the net forward and backward twice (the arch
    # step on the valid batch, the weight step on the train batch); the
    # arch step's gradient is in the alphas alone, so autograd skips the
    # backward of the GroupNorms whose input does not depend on them.
    want_fwd = 2 * half * n_gn
    want_bwd = half * (2 * n_gn - frozen)
    samples = NAS_PER_ROUND * 2 * half * NAS_BATCH
    print(f"[{tag}] darts c 16, {NAS_LAYERS} layers, 4 steps ({n_gn} GroupNorms a "
          f"forward, reckoned {NAS_GN}; {frozen} of them before the alphas' "
          f"first use), {NAS_CLIENTS} clients x {NAS_PER_CLIENT} samples, "
          f"batch {NAS_BATCH} ({half} search steps a round), {NAS_PER_ROUND} "
          f"a round, lr {NAS_LR}, arch lr {NAS_ARCH_LR}; GroupNorm launches "
          f"a round by the model: fwd {want_fwd}, bwd {want_bwd}",
          flush=True)
    check(n_gn == NAS_GN, f"{tag}: {n_gn} GroupNorms, reckoned {NAS_GN}")
    api = FedNASAPI(model, fed, None, cfg(NAS_PER_ROUND),
                    arch_lr=NAS_ARCH_LR, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    # The full net captured once (cuDNN's default mode), by the on-device
    # tier; its replays are counted and timed.
    dev_ms, _ = _on_device_once(api, tag, samples)
    fwd, bwd, red, fs, bs, copies, times = _zoo_counts(
        lambda: [_on_device_replayed(api, tag, samples)
                 for _ in range(NAS_REPLAYS)])
    dev_med = statistics.median(times)
    print(f"[{tag}] {NAS_REPLAYS} replayed on-device round(s): GroupNorm "
          f"launches fwd {fwd}, bwd {bwd}, reduce {red} (expected "
          f"{NAS_REPLAYS * want_fwd}, {NAS_REPLAYS * want_bwd}, "
          f"{NAS_REPLAYS * want_bwd}), streamed {fs}/{bs}, operand "
          f"copies {copies}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(fwd == NAS_REPLAYS * want_fwd
          and bwd == red == NAS_REPLAYS * want_bwd and fs == bs == 0,
          f"{tag}: GroupNorm launches fwd {fwd} bwd {bwd} reduce {red} "
          f"streamed {fs}/{bs}")
    print(f"[{tag}] genotype from the averaged alphas: {api.genotype()}",
          flush=True)
    counted = [fwd, bwd]
    del api
    _free()

    # The unrolled arch gradient through the kernels against the plain
    # twin's on one client's batches, beside the first-order gradient.
    tag = "extra/FedNASAPI unrolled"
    plain = darts(gn_fn=group_norm_plain, layers=NAS_PIN_LAYERS)
    model = darts(layers=NAS_PIN_LAYERS)
    check(all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), plain.state_dict().values())),
          f"{tag}: the twin's model has other weights")
    batches = [(fed.x[0, i], fed.y[0, i], fed.mask[0, i]) for i in (0, half)]
    grads = {}
    t0 = time.perf_counter()
    for name, m, unrolled in (("kernels", model, True), ("plain", plain, True),
                              ("first-order", plain, False)):
        fns = model_fns(m)
        search = make_fednas_local_search(fns.apply, NAS_LR, NAS_ARCH_LR,
                                          NAS_XI, 1, unrolled)
        net = fns.init()
        grads[name] = search.arch_grad(net.params, net.model_state,
                                       *batches[0], *batches[1])
    torch.cuda.synchronize()

    def dist(a, b):
        top = max(grads[b][k].abs().max().item() for k in grads[b])
        return max((grads[a][k] - grads[b][k]).abs().max().item()
                   for k in grads[b]) / top

    rel, fo = dist("kernels", "plain"), dist("first-order", "plain")
    print(f"[{tag}] arch gradient (xi {NAS_XI}, darts at {NAS_PIN_LAYERS} "
          f"cells, {_norm_count(model)} GroupNorms a forward, one client's "
          f"batch of {NAS_BATCH}; the three in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms): kernels vs the "
          f"plain twin max|d|/max {rel:.3e} "
          f"(bound {NAS_GRAD2_TOL:.0e}, and below a tenth of the "
          f"first-order gradient's distance from it, {fo:.3e})", flush=True)
    check(rel <= NAS_GRAD2_TOL and rel < 0.1 * fo,
          f"{tag}: arch gradient {rel} from the twin's (first order {fo})")
    del plain, grads
    _free()
    del fed
    _free()
    n = NAS_CLIENTS * NAS_UNROLLED_PER_CLIENT
    fed = build_federated_arrays(x[:n], y[:n], partition_homo(n, NAS_CLIENTS),
                                 NAS_BATCH, device="cuda")
    api = FedNASAPI(model, fed, None, cfg(NAS_UNROLLED_PER_ROUND),
                    arch_lr=NAS_ARCH_LR, xi=NAS_XI, unrolled=True,
                    device="cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd, bwd, red, fs, bs, copies, loss = _zoo_counts(
        lambda: _eager_round(api, 0).item())
    ms = (time.perf_counter() - t0) * 1e3
    print(f"[{tag}] {NAS_UNROLLED_PER_ROUND} clients a round of "
          f"{NAS_UNROLLED_PER_CLIENT} samples at {NAS_PIN_LAYERS} cells (the "
          f"cuts: one search step, the depth), "
          f"one eager round (run_round + _server_update; eager only, see "
          f"NAS_UNROLLED_PER_CLIENT): {ms:.1f} ms, loss "
          f"{loss:.4f}; GroupNorm launches fwd {fwd}, bwd {bwd} (the double "
          f"backward launches the backward kernel twice more for each "
          f"GroupNorm it passes), streamed {fs}/{bs}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}",
          flush=True)
    check(math.isfinite(loss) and bwd > fwd, f"{tag}: loss {loss}, "
          f"GroupNorm launches fwd {fwd} bwd {bwd}")
    del api, model, fed
    _free()
    return counted, (dev_med, dev_ms, samples)


def _unet_gn_plan(side, levels, base):
    """UNet's GroupNorm (S, C) shapes a forward, from its architecture:
    two per ConvBlock, levels down, the bottleneck, levels up."""
    shapes = []
    for i in range(levels):
        shapes += [((side >> i) ** 2, base << i)] * 2
    shapes += [((side >> levels) ** 2, base << levels)] * 2
    for i in reversed(range(levels)):
        shapes += [((side >> i) ** 2, base << i)] * 2
    return shapes


def _fedseg_drives(card):
    """FedSeg over UNet at 256 x 256: pin (a), a counted replayed round
    (the streamed GroupNorm routes on the path: their launches against
    ``group_norm_plan``'s), a focal round, ``evaluate`` and its confusion
    matrix against a numpy bincount of the same predictions."""
    from fedml_tpu_torch.algos import FedConfig, FedSegAPI
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.data.batching import batch_global
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.build import extension
    from fedml_tpu_torch.trainer.local import NetState

    tag = "extra/FedSegAPI"
    rng = np.random.RandomState(SEED)
    n = SEG_CLIENTS * SEG_PER_CLIENT + SEG_TEST
    x = rng.randn(n, SEG_SIDE, SEG_SIDE, 3).astype(np.float32)
    y = rng.randint(0, SEG_CLASSES, (n, SEG_SIDE, SEG_SIDE)).astype(np.int32)
    y[rng.rand(*y.shape) < SEG_IGNORED] = 255
    ntr = SEG_CLIENTS * SEG_PER_CLIENT
    fed = build_federated_arrays(x[:ntr], y[:ntr],
                                 partition_homo(ntr, SEG_CLIENTS), SEG_BATCH,
                                 device="cuda")
    test = batch_global(x[ntr:], y[ntr:], SEG_BATCH, device="cuda")
    del x, y
    cfg = FedConfig(client_num_in_total=SEG_CLIENTS,
                    client_num_per_round=SEG_PER_ROUND, comm_round=3,
                    epochs=1, batch_size=SEG_BATCH, lr=SEG_LR, seed=SEED)

    def unet():
        return create_model("unet", num_classes=SEG_CLASSES, base=16,
                            levels=3, device="cuda",
                            generator=torch.Generator().manual_seed(SEED))

    model = unet()
    shapes = _unet_gn_plan(SEG_SIDE, 3, 16)
    ext = extension()
    fwd_s = sum(ext.group_norm_plan(s_, c, False, 1)[0] == 0
                for s_, c in shapes)
    bwd_s = sum(ext.group_norm_plan(s_, c, False, 2)[0] == 0
                for s_, c in shapes)
    steps = fed.steps_per_epoch
    samples = SEG_PER_ROUND * steps * SEG_BATCH
    print(f"[{tag}] unet 21 classes, base 16, 3 levels ({_norm_count(model)} "
          f"GroupNorms a forward: {shapes}), {SEG_SIDE}x{SEG_SIDE}, "
          f"{SEG_CLIENTS} clients x {SEG_PER_CLIENT}, batch {SEG_BATCH} "
          f"({steps} steps), {SEG_PER_ROUND} a round, lr {SEG_LR}; past a "
          f"cluster by group_norm_plan: {fwd_s} forwards and {bwd_s} "
          f"backwards a pass (reckoned 8 and 8)", flush=True)
    check(len(shapes) == _norm_count(model) == 14 and fwd_s == bwd_s == 8,
          f"{tag}: GroupNorms {len(shapes)}, streamed {fwd_s}/{bwd_s}")
    api = FedSegAPI(model, fed, test, cfg, num_classes=SEG_CLASSES,
                    loss_mode="ce", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with _cudnn_deterministic():
        _hold_captured_round(api, 0, tag, runs=1)
    api._graphs.clear()
    api.train_one_round(1)  # captures anew in cuDNN's default mode
    fwd, bwd, red, fs, bs, copies, (med, _, _) = _zoo_counts(
        lambda: _event_rounds(api, (2,), tag, samples))
    want = steps * len(shapes)
    print(f"[{tag}] replayed round: GroupNorm launches fwd {fwd}, bwd {bwd}, "
          f"reduce {red} (expected {want} each), streamed fwd {fs}, bwd {bs} "
          f"(expected {steps * fwd_s}, {steps * bwd_s}), operand copies "
          f"{copies}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(fwd == bwd == red == want and fs == steps * fwd_s
          and bs == steps * bwd_s,
          f"{tag}: GroupNorm launches fwd {fwd} bwd {bwd} reduce {red} "
          f"streamed {fs}/{bs}")
    counted = [fwd, bwd, fs, bs]
    lo, hi = FEDSEG_ROUND_BEFORE_MS
    print(f"[{tag}] replayed round {med:.1f} ms with the streamed route's "
          f"clusters, against {lo}-{hi} ms with its single-block kernels "
          f"(H100 80GB HBM3, 700 W); {card}", flush=True)

    focal = FedSegAPI(unet(), fed, test, cfg, num_classes=SEG_CLASSES,
                      loss_mode="focal", device="cuda")
    focal.net = NetState(dict(api.net.params), {})
    t0 = time.perf_counter()
    out = focal.train_one_round(3)
    print(f"[{tag}] focal round (captures): {out}, "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    check(math.isfinite(out["train_loss"]), f"{tag}: focal {out}")
    del focal

    t0 = time.perf_counter()
    scores = api.evaluate()
    eval_ms = (time.perf_counter() - t0) * 1e3
    tx, ty, tm = test
    cm = api._eval_cm(api.net, tx, ty, tm).cpu().numpy()
    preds = []
    with torch.no_grad():
        for bx in tx:
            preds.append(api.fns.apply(api.net, bx)[0].argmax(-1).cpu())
    pred = torch.stack(preds).numpy().reshape(-1)
    lab = torch.where(tm[:, :, None, None] > 0, ty, 255).cpu().numpy()
    lab = lab.reshape(-1)
    ok = lab < SEG_CLASSES
    want_cm = np.bincount(lab[ok] * SEG_CLASSES + pred[ok],
                          minlength=SEG_CLASSES ** 2).reshape(
        SEG_CLASSES, SEG_CLASSES)
    print(f"[{tag}] evaluate on {SEG_TEST} images: {scores} in "
          f"{eval_ms:.1f} ms; confusion matrix of {int(cm.sum())} pixels "
          f"{'equal to' if np.array_equal(cm, want_cm) else 'DIFFERS from'} "
          f"a numpy bincount of the same predictions; {card}", flush=True)
    check(np.array_equal(cm, want_cm) and all(
        0.0 <= v <= 1.0 for v in scores.values()),
          f"{tag}: confusion matrix or scores {scores}")
    del api, model, fed, test
    _free()
    return counted, (med, samples)


def _fedgan_drives(card):
    """FedGAN over the MNIST GAN: pin (a) under cuDNN's deterministic mode,
    a round replayed from a capture in the default mode, one on-device
    round, ``generate(16)``."""
    from fedml_tpu_torch.algos import FedConfig, FedGanAPI
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model

    tag = "extra/FedGanAPI"
    rng = np.random.RandomState(SEED)
    n = GAN_CLIENTS * GAN_PER_CLIENT
    x = np.tanh(rng.randn(n, 28, 28, 1)).astype(np.float32)
    fed = build_federated_arrays(x, np.zeros(n, np.int32),
                                 partition_homo(n, GAN_CLIENTS), GAN_BATCH,
                                 device="cuda")
    cfg = FedConfig(client_num_in_total=GAN_CLIENTS,
                    client_num_per_round=GAN_PER_ROUND, comm_round=3,
                    epochs=1, batch_size=GAN_BATCH, lr=GAN_LR, seed=SEED)
    model = create_model("mnist_gan", device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    api = FedGanAPI(model, fed, cfg, device="cuda")
    steps = fed.steps_per_epoch
    samples = GAN_PER_ROUND * steps * GAN_BATCH
    print(f"[{tag}] mnist_gan (latent 100, LayerNorm), {GAN_CLIENTS} clients "
          f"x {GAN_PER_CLIENT}, batch {GAN_BATCH} ({steps} D+G steps), "
          f"{GAN_PER_ROUND} a round, Adam lr {GAN_LR}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    with _cudnn_deterministic():
        _hold_captured_round(api, 0, tag, runs=1)
    api._graphs.clear()
    api.train_one_round(1)  # captures anew in cuDNN's default mode
    med, _, _ = _event_rounds(api, (2,), tag, samples)
    dev_ms, _ = _on_device_once(api, tag, samples)
    img = api.generate(16)
    print(f"[{tag}] generate(16): {tuple(img.shape)}, values in "
          f"[{img.min().item():.4f}, {img.max().item():.4f}]; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{card}", flush=True)
    check(tuple(img.shape) == (16, 28, 28, 1) and bool(
        torch.isfinite(img).all()) and img.abs().max().item() <= 1.0,
          f"{tag}: generate {tuple(img.shape)}")
    del api, model, fed
    _free()
    return med, dev_ms, samples


def phase_extra():
    """The rest of the simulator zoo at full model width (FedNAS, FedSeg,
    FedGAN; see the constants). Returns {kernel name: launches in the
    counted rounds}."""
    t_phase = time.perf_counter()
    card = smi_line()
    nas, nas_t = _fednas_drives(card)
    seg, seg_t = _fedseg_drives(card)
    gan_t = _fedgan_drives(card)
    print(f"[extra] FedNAS round {nas_t[0]:.1f} ms on-device, replayed "
          f"({nas_t[2] / nas_t[0] * 1e3:.1f} samples/s), on-device call "
          f"{nas_t[1]:.1f} ms with its capture; FedSeg round {seg_t[0]:.1f} "
          f"ms ({seg_t[1] / seg_t[0] * 1e3:.1f} samples/s); FedGAN round "
          f"{gan_t[0]:.1f} ms ({gan_t[2] / gan_t[0] * 1e3:.1f} samples/s); "
          f"GroupNorm launches counted: fwd {nas[0] + seg[0]} (streamed "
          f"{seg[2]}), bwd {nas[1] + seg[1]} (streamed {seg[3]}); phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return {"group_norm_fwd": nas[0] + seg[0],
            "group_norm_bwd": nas[1] + seg[1],
            "streamed": {"group_norm_fwd": seg[2], "group_norm_bwd": seg[3]}}


def _r18_drive(card):
    """ResNet-18-GN FedAvg at fed_cifar100's config, on the card by
    default (``device=None``): pin (a) under cuDNN's deterministic mode
    from one eager round, a replayed round counted against 100 GroupNorm
    forwards and backwards, 3 pipelined rounds on the same graph, a warm
    ``train_rounds_on_device(3)`` call in cuDNN's default mode (its capture
    timed apart) and 3 timed calls, counted. Returns (fwd, bwd) launches
    and (on-device round ms, samples a round)."""
    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model

    tag = "models/resnet18_gn FedAvg"
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    n = R18_CLIENTS * R18_PER_CLIENT
    x = rng.randn(n, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, R18_CLASSES, n).astype(np.int32)
    fed = build_federated_arrays(x, y, partition_homo(n, R18_CLIENTS),
                                 R18_BATCH, device="cuda")
    del x, y
    model = create_model("resnet18_gn", num_classes=R18_CLASSES,
                         generator=torch.Generator().manual_seed(SEED))
    check(next(model.parameters()).is_cuda,
          f"{tag}: create_model(device=None) did not build on cuda")
    cfg = FedConfig(client_num_in_total=R18_CLIENTS,
                    client_num_per_round=R18_PER_ROUND, comm_round=3,
                    epochs=1, batch_size=R18_BATCH, lr=R18_LR, seed=SEED)
    api = FedAvgAPI(model, fed, None, cfg)
    steps = fed.steps_per_epoch
    want = steps * R18_GN_FWD
    samples = R18_PER_ROUND * R18_PER_CLIENT
    print(f"[{tag}] resnet18_gn f32 "
          f"({sum(v.numel() for v in api.net.params.values())} params, "
          f"{_norm_count(model)} GroupNorms a forward), {R18_CLIENTS} clients "
          f"x {R18_PER_CLIENT} samples [32, 32, 3], {R18_CLASSES} classes, "
          f"batch {R18_BATCH} ({steps} steps), {R18_PER_ROUND} a round, sgd "
          f"lr {R18_LR}; GroupNorm launches a round by the model: fwd "
          f"{want}, bwd {want}; set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(_norm_count(model) == R18_GN_FWD and steps == 5,
          f"{tag}: {_norm_count(model)} GroupNorms, {steps} steps")
    torch.cuda.reset_peak_memory_stats()
    with _cudnn_deterministic():
        _hold_captured_round(api, 0, tag, runs=1)
        fwd, bwd, (med, _, _) = _counted(
            lambda: _event_rounds(api, (1,), tag, samples), tag, want, want)
        _time_pipelined(api, 3, tag, samples, "samples")
    # Timed as PERF.md §2 says: a warm call that captures, then the median
    # of three calls of 3 rounds; in cuDNN's default mode.
    t0 = time.perf_counter()
    api.train_rounds_on_device(3).tolist()
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"[{tag}] train_rounds_on_device(3) warm call {warm_ms:.1f} ms, of "
          f"which warm-up + capture "
          f"{api._graphs['on_device'].capture_ms:.1f} ms", flush=True)
    counts, dev_ms = _time_on_device(api, 3, tag, samples, "samples",
                                     _zero_gn_counts, _gn_counts)
    check(counts[0] == counts[1] == counts[2] == 9 * want
          and counts[3] == counts[4] == 0,
          f"{tag}: on-device GroupNorm launches (fwd, bwd, reduce, copies, "
          f"streamed) {counts}, expected {9 * want} a kind")
    print(f"[{tag}] on-device round {dev_ms:.2f} ms = "
          f"{samples / dev_ms * 1e3:.1f} samples/s (replayed, deterministic "
          f"mode: {med:.1f} ms); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}",
          flush=True)
    del api, model, fed
    _free()
    return (fwd + counts[0], bwd + counts[1]), (dev_ms, samples)


def _bn_drives(card):
    """``resnet56(norm="bn", dtype="bf16")`` FedAvg at the primary config:
    the running stats after the captured round bit-equal to an eager
    round's (pin (a) under cuDNN's deterministic mode, params and stats),
    moved from their init and equal to the sample-weighted mean of the
    cohort's trained stats; then one FedBN round: the sampled clients'
    rows of the state stack move, no other row does."""
    from fedml_tpu_torch.algos import FedAvgAPI, FedBNAPI, FedConfig
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.tree import client_rows, tree_weighted_mean
    from fedml_tpu_torch.data import (build_federated_arrays, gather_clients,
                                      partition_homo)
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.parallel.shard import client_rngs

    tag = "models/resnet56 BN FedAvg"
    x, y = _cifar_samples()
    fed = build_federated_arrays(x, y, partition_homo(len(x), TRAIN_CLIENTS),
                                 TRAIN_BATCH, device="cuda")
    del x, y
    cfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                    client_num_per_round=TRAIN_PER_ROUND, comm_round=1,
                    epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED)

    def model():
        return create_model("resnet56", num_classes=10, norm="bn",
                            dtype="bf16", device="cuda",
                            generator=torch.Generator().manual_seed(SEED))

    api = FedAvgAPI(model(), fed, None, cfg, device="cuda")
    init = {k: v.clone() for k, v in api.net.model_state.items()}
    print(f"[{tag}] resnet56 BatchNorm bf16 ({len(init) // 2} BatchNorms, "
          f"{sum(v.numel() for v in init.values())} running-stat values), "
          f"{TRAIN_CLIENTS} clients x {TRAIN_PER_CLIENT}, batch "
          f"{TRAIN_BATCH}, {TRAIN_PER_ROUND} a round, sgd lr {TRAIN_LR}",
          flush=True)
    with _cudnn_deterministic():
        # The cohort's trained stats from the round's start, key and cohort.
        rnd = keys.split(api.rng)[1]
        sub = gather_clients(fed, api._cohort_on_device(api.sample_round(0)))
        trained, _ = api.local_train.run_clients(
            api.net, sub.x, sub.y, sub.mask,
            client_rngs(rnd, sub.x.shape[0], 0))
        mean = tree_weighted_mean(trained.model_state, sub.counts.float())
        del trained
        _hold_captured_round(api, 0, tag, runs=1)
    state = api.net.model_state
    moved = sum(not torch.equal(state[k], v) for k, v in init.items())
    off = max((state[k] - mean[k]).abs().max().item() for k in state)
    print(f"[{tag}] running stats after the replayed round: {moved} of "
          f"{len(init)} moved from their init; max|stats - the cohort's "
          f"sample-weighted mean of its trained stats| {off:.3e} (must be "
          f"0); {card}", flush=True)
    check(moved == len(init) and off == 0.0,
          f"{tag}: {moved} of {len(init)} stats moved, {off} from the mean")
    with _cudnn_deterministic():
        bn_ms, _, _ = _event_rounds(api, (1,), tag, TRAIN_PER_ROUND
                                    * TRAIN_PER_CLIENT)
    del api
    _free()

    tag = "models/resnet56 BN FedBN"
    api = FedBNAPI(model(), fed, None, cfg, device="cuda")
    before = {k: v.clone() for k, v in client_rows(api._states).items()}
    idx = sorted(int(i) for i in api.sample_round(0))
    t0 = time.perf_counter()
    loss = api.train_one_round(0)["train_loss"]
    ms = (time.perf_counter() - t0) * 1e3
    after = client_rows(api._states)
    changed = {c for k, v in after.items() for c in range(TRAIN_CLIENTS)
               if not torch.equal(v[c], before[k][c])}
    every = all(not torch.equal(v[c], before[k][c])
                for k, v in after.items() for c in idx)
    print(f"[{tag}] one round (captures; {ms:.1f} ms), loss {loss:.4f}: "
          f"state-stack rows moved {sorted(changed)}, sampled {idx}; every "
          f"stat of every sampled row moved: {every}", flush=True)
    check(changed == set(idx) and every and math.isfinite(loss),
          f"{tag}: rows {sorted(changed)} moved, sampled {idx}")
    del api, fed
    _free()
    return bn_ms


def _small_model_drive(tag, build, fed, cfg, samples, card, **kw):
    """Pin (a) under cuDNN's deterministic mode from one eager round (its
    ms and the capture's printed), then 2 replayed rounds by CUDA
    events. Returns the replayed round's median ms."""
    from fedml_tpu_torch.algos import FedAvgAPI

    api = FedAvgAPI(build(), fed, None, cfg, device="cuda", **kw)
    with _cudnn_deterministic():
        _hold_captured_round(api, 0, tag, runs=1)
        med, _, _ = _event_rounds(api, (1, 2), tag, samples)
    print(f"[{tag}] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}",
          flush=True)
    del api
    _free()
    return med


def phase_models():
    """The model zoo's first half on the card: ResNet-18-GN FedAvg at
    fed_cifar100's config through the GroupNorm kernels, BatchNorm's
    trained state through FedAvg and FedBN, the FEMNIST CNN and the
    Shakespeare LSTM (see the constants). Returns {kernel name: launches
    in the counted rounds}."""
    import functools

    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.local import seq_softmax_ce

    t_phase = time.perf_counter()
    card = smi_line()
    (fwd, bwd), (r18_ms, r18_samples) = _r18_drive(card)
    bn_ms = _bn_drives(card)

    rng = np.random.RandomState(SEED)
    n = FEMNIST_CLIENTS * FEMNIST_PER_CLIENT
    fed = build_federated_arrays(
        rng.randn(n, 28, 28).astype(np.float32),
        rng.randint(0, FEMNIST_CLASSES, n).astype(np.int32),
        partition_homo(n, FEMNIST_CLIENTS), FEMNIST_BATCH, device="cuda")
    cfg = FedConfig(client_num_in_total=FEMNIST_CLIENTS,
                    client_num_per_round=FEMNIST_PER_ROUND, comm_round=3,
                    epochs=1, batch_size=FEMNIST_BATCH, lr=FEMNIST_LR,
                    seed=SEED)
    tag = "models/cnn FEMNIST"
    print(f"[{tag}] cnn (CNNDropOut, 62 classes), {FEMNIST_CLIENTS} clients "
          f"x {FEMNIST_PER_CLIENT} [28, 28] (cut from ~226), batch "
          f"{FEMNIST_BATCH}, {FEMNIST_PER_ROUND} a round, lr {FEMNIST_LR}",
          flush=True)
    cnn_ms = _small_model_drive(
        tag, lambda: create_model("cnn", num_classes=FEMNIST_CLASSES,
                                  device="cuda", generator=torch.Generator()
                                  .manual_seed(SEED)),
        fed, cfg, FEMNIST_PER_ROUND * FEMNIST_PER_CLIENT, card)
    del fed

    n = SHAKE_CLIENTS * SHAKE_PER_CLIENT
    ids = rng.randint(0, SHAKE_VOCAB, (n, SHAKE_T + 1)).astype(np.int32)
    labels = ids[:, 1:].copy()
    labels[::3, -8:] = SHAKE_PAD
    fed = build_federated_arrays(ids[:, :-1], labels,
                                 partition_homo(n, SHAKE_CLIENTS),
                                 SHAKE_BATCH, device="cuda")
    cfg = FedConfig(client_num_in_total=SHAKE_CLIENTS,
                    client_num_per_round=SHAKE_PER_ROUND, comm_round=3,
                    epochs=1, batch_size=SHAKE_BATCH, lr=SHAKE_LR, seed=SEED)
    tag = "models/rnn Shakespeare"
    print(f"[{tag}] rnn (embed 8, 2 x LSTM 256, vocab {SHAKE_VOCAB}), "
          f"{SHAKE_CLIENTS} clients x {SHAKE_PER_CLIENT} sequences of T "
          f"{SHAKE_T} (cut), batch {SHAKE_BATCH}, {SHAKE_PER_ROUND} a round, "
          f"lr {SHAKE_LR}, seq_softmax_ce with pad id {SHAKE_PAD}",
          flush=True)
    rnn_ms = _small_model_drive(
        tag, lambda: create_model("rnn", device="cuda",
                                  generator=torch.Generator()
                                  .manual_seed(SEED)),
        fed, cfg, SHAKE_PER_ROUND * SHAKE_PER_CLIENT, card,
        loss_fn=functools.partial(seq_softmax_ce, pad_id=SHAKE_PAD),
        pad_id=SHAKE_PAD)
    del fed
    _free()
    print(f"[models] ResNet-18-GN on-device round {r18_ms:.2f} ms "
          f"({r18_samples / r18_ms * 1e3:.1f} samples/s); ResNet-56-BN bf16 "
          f"round {bn_ms:.1f} ms replayed in deterministic mode; FEMNIST CNN "
          f"round "
          f"{cnn_ms:.1f} ms; Shakespeare LSTM round {rnn_ms:.1f} ms; "
          f"GroupNorm launches counted fwd {fwd}, bwd {bwd}; phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return {"group_norm_fwd": fwd, "group_norm_bwd": bwd}


def _cv_twin_hold(tag, name, model, fed, card):
    """One forward and backward on client 0's first batch through the
    kernels, against the same weights with ``gn_fn`` = the plain twin, and
    the twin again on that batch perturbed by 1e-7 (relative): |d| / |want|
    of the logits and of the gradient, each as one vector. Uncounted (the
    counts are zeroed before each counted run)."""
    import torch.nn.functional as F
    from torch.func import functional_call, grad_and_value

    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.group_norm import group_norm_plain

    twin = create_model(name, num_classes=10,
                        generator=torch.Generator().manual_seed(SEED),
                        gn_fn=group_norm_plain)
    twin.load_state_dict(model.state_dict())
    x, y = fed.x[0, 0], fed.y[0, 0].long()
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    nudged = x * (1 + 1e-7 * torch.randn(x.shape, generator=g,
                                         device="cuda"))
    key = torch.zeros((), dtype=torch.int64, device="cuda")
    out = {}
    with _cudnn_deterministic():
        for arm, m, xb in (("kernels", model, x), ("twin", twin, x),
                           ("nudged", twin, nudged)):
            m.train()
            kw = {"rng": key} if getattr(m, "takes_rng", False) else {}
            params = dict(m.named_parameters())

            def loss(p, m=m, kw=kw, xb=xb):
                logits = functional_call(m, p, (xb,), kw)
                return F.cross_entropy(logits, y), logits

            grads, (_, logits) = grad_and_value(loss, has_aux=True)(params)
            out[arm] = (logits.detach(), torch.cat(
                [t.flatten() for t in grads.values()]))
    torch.cuda.synchronize()

    def rel(a, i):
        return ((out[a][i] - out["twin"][i]).norm()
                / out["twin"][i].norm()).item()

    d_logits, d_grad, spread = rel("kernels", 0), rel("kernels", 1), rel(
        "nudged", 1)
    lim = max(CV_TWIN_TOL, CV_SPREAD * spread)
    print(f"[{tag}] one forward + backward on a batch of {x.shape[0]}: "
          f"kernels vs the plain twin, same weights, |d| / |want| logits "
          f"{d_logits:.3e} (tol {CV_TWIN_TOL:.0e}), gradient {d_grad:.3e} "
          f"(tol {lim:.3e}: the twin's gradient moves {spread:.3e} under a "
          f"1e-7 input perturbation, logits {rel('nudged', 0):.3e})",
          flush=True)
    check(d_logits <= CV_TWIN_TOL and d_grad <= lim,
          f"{tag}: kernels {d_logits}, {d_grad} from the plain twin (gradient "
          f"tol {lim})")
    del twin
    return d_logits, d_grad, spread


def _cv_layouts(tag, model, fed):
    """Which memory format reaches the GroupNorms: the NHWC input's NCHW
    view, after flax's SAME pad (``models/layers.pad_same``), after the
    stem conv and after a depthwise conv fed a channels-last input
    (channels-last: the kernels read it with no copy)."""
    from fedml_tpu_torch.models.layers import pad_same

    cl = torch.channels_last
    x = fed.x[0, 0].permute(0, 3, 1, 2)
    dw = model.DepthwiseSeparable_0.Conv_0
    h = torch.randn(x.shape[0], dw.weight.shape[0], 32, 32,
                    device="cuda").to(memory_format=cl)
    with torch.no_grad():
        got = [x, pad_same(x, 3), model.Conv_0(x), dw(h)]
    cl_in, cl_pad, cl_stem, cl_dw = (t.is_contiguous(memory_format=cl)
                                     for t in got)
    print(f"[{tag}] channels-last? input {cl_in}, after the SAME pad "
          f"{cl_pad}, the stem conv's output {cl_stem}, a depthwise conv's "
          f"output from a channels-last input {cl_dw}", flush=True)


def _cv_drive(name, fed, cfg, card, profile=False):
    """FedAvg over one CV model on the card by default (``device=None``):
    pin (a) under cuDNN's deterministic mode from one eager round, a
    replayed round counted against the model's GroupNorms (their operand
    copies printed), the kernels against the plain twin, a warm ``train_rounds_on_device(3)`` in cuDNN's
    default mode (its capture timed apart) and 3 timed calls, counted; with
    ``profile``, one profiled on-device call. Returns (fwd, bwd) launches
    and the numbers of the summary line."""
    from fedml_tpu_torch.algos import FedAvgAPI
    from fedml_tpu_torch.models import create_model

    tag = f"cv/{name} FedAvg"
    model = create_model(name, num_classes=10,
                         generator=torch.Generator().manual_seed(SEED))
    check(next(model.parameters()).is_cuda,
          f"{tag}: create_model(device=None) did not build on cuda")
    api = FedAvgAPI(model, fed, None, cfg)
    steps = fed.steps_per_epoch
    norms = _norm_count(model)
    want = steps * norms
    samples = CV_CLIENTS * CV_PER_CLIENT
    params = sum(v.numel() for v in api.net.params.values())
    print(f"[{tag}] {name} f32 ({params} params, {norms} GroupNorms a "
          f"forward), {CV_CLIENTS} clients x {CV_PER_CLIENT} [32, 32, 3], 10 "
          f"classes, batch {CV_BATCH} ({steps} steps), all {CV_CLIENTS} a "
          f"round, sgd lr {CV_LR}; GroupNorm launches a round by the model: "
          f"fwd {want}, bwd {want}", flush=True)
    check(norms == CV_NORMS[name] and steps == 2,
          f"{tag}: {norms} GroupNorms, {steps} steps")
    with _cudnn_deterministic():
        _hold_captured_round(api, 0, tag, runs=1)
        capture_ms = api._graphs["fused"].capture_ms
        _zero_gn_counts()
        med, _, _ = _event_rounds(api, (1,), tag, samples)
    fwd, bwd, red, copies, streamed = _gn_counts()
    print(f"[{tag}] replayed round: GroupNorm launches fwd {fwd}, bwd {bwd}, "
          f"reduce {red} (expected {want} each), streamed {streamed}, "
          f"operand copies {copies}", flush=True)
    check(fwd == bwd == red == want and streamed == 0,
          f"{tag}: GroupNorm launches fwd {fwd} bwd {bwd} reduce {red} "
          f"streamed {streamed}, expected {want}")
    if profile:
        _cv_layouts(tag, model, fed)
    twin = _cv_twin_hold(tag, name, model, fed, card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api.train_rounds_on_device(3).tolist()
    warm_ms = (time.perf_counter() - t0) * 1e3
    od_capture_ms = api._graphs["on_device"].capture_ms
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] train_rounds_on_device(3) warm call {warm_ms:.1f} ms, "
          f"of which warm-up + capture {od_capture_ms:.1f} ms; peak device "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    counts, dev_ms = _time_on_device(api, 3, tag, samples, "samples",
                                     _zero_gn_counts, _gn_counts)
    print(f"[{tag}] GroupNorm launches in the 9 timed rounds: fwd "
          f"{counts[0]}, bwd {counts[1]}, reduce {counts[2]}, copies "
          f"{counts[3]}, streamed {counts[4]} (expected {9 * want} a kind)",
          flush=True)
    check(counts[0] == counts[1] == counts[2] == 9 * want
          and counts[3] == 9 * copies and counts[4] == 0,
          f"{tag}: on-device GroupNorm launches (fwd, bwd, reduce, copies, "
          f"streamed) {counts}, expected {9 * want} a kind and "
          f"{9 * copies} copies")
    if profile:
        _profile_round(lambda: api.train_rounds_on_device(3),
                       f"{name} train_rounds_on_device(3) (3 rounds, "
                       "captured in cuDNN's default mode)", tag, top=5)
    row = dict(params=params, round_ms=dev_ms,
               samples_s=samples / dev_ms * 1e3, replayed_ms=med,
               capture_ms=capture_ms, on_device_capture_ms=od_capture_ms,
               peak_gib=peak / 2**30, twin=twin)
    print(f"[{tag}] on-device round {dev_ms:.2f} ms = "
          f"{row['samples_s']:.1f} samples/s (replayed, deterministic mode: "
          f"{med:.1f} ms); captures {capture_ms:.1f} ms (fused round) and "
          f"{od_capture_ms:.1f} ms (3 on-device rounds); peak device memory "
          f"{row['peak_gib']:.2f} GiB; {card}", flush=True)
    del api, model
    _free()
    return (fwd + counts[0], bwd + counts[1]), row


def phase_cv():
    """The cross-silo CV zoo on the card: FedAvg over MobileNet, VGG-11-GN,
    MobileNetV3 (LARGE) and EfficientNet-b0 at BASELINE.md's cross-silo
    config (see the constants), each through ``_cv_drive``; MobileNet's
    round profiled (its depthwise convs are grouped convs of 10 x C
    groups under the round's vmap). Returns {kernel name: launches in the
    counted rounds}."""
    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo

    t_phase = time.perf_counter()
    card = smi_line()
    rng = np.random.RandomState(SEED)
    n = CV_CLIENTS * CV_PER_CLIENT
    fed = build_federated_arrays(
        rng.randn(n, 32, 32, 3).astype(np.float32),
        rng.randint(0, 10, n).astype(np.int32),
        partition_homo(n, CV_CLIENTS), CV_BATCH, device="cuda")
    cfg = FedConfig(client_num_in_total=CV_CLIENTS,
                    client_num_per_round=CV_CLIENTS, comm_round=3, epochs=1,
                    batch_size=CV_BATCH, lr=CV_LR, seed=SEED)
    print(f"[cv] BASELINE.md:30-33's cross-silo config, cut: {CV_CUTS}",
          flush=True)
    fwd = bwd = 0
    rows = {}
    for name in CV_MODELS:
        (f, b), rows[name] = _cv_drive(name, fed, cfg, card,
                                       profile=name == "mobilenet")
        fwd, bwd = fwd + f, bwd + b
    del fed
    _free()
    print("[cv] summary (on-device round ms, samples/s, capture ms of the "
          "fused round, peak GiB, params): " + "; ".join(
              f"{k} {r['round_ms']:.2f} ms, {r['samples_s']:.1f}/s, "
              f"{r['capture_ms']:.1f} ms, {r['peak_gib']:.2f} GiB, "
              f"{r['params']}" for k, r in rows.items())
          + f"; GroupNorm launches counted fwd {fwd}, bwd {bwd}; phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return {"group_norm_fwd": fwd, "group_norm_bwd": bwd}


class _SkipLastQTile:
    """Planted fault for the adapter step checks: the extension with its
    dk/dv kernels (the split-TF32 one for f32, the tensor-core one for
    bf16) fed a dO whose last 64 rows are zero, as if the kernel had
    skipped the last Q tile."""

    def __init__(self, ext):
        self._ext = ext

    def __getattr__(self, name):
        return getattr(self._ext, name)

    def flash_dkv(self, q, k, v, do, lse, delta, causal):
        return self._ext.flash_dkv(q, k, v, self._cut(do), lse, delta, causal)

    def flash_dkv_sm90(self, q, k, v, do, lse, delta, causal):
        return self._ext.flash_dkv_sm90(q, k, v, self._cut(do), lse, delta,
                                        causal)

    @staticmethod
    def _cut(do):
        do = do.clone()
        do[:, :, -64:] = 0
        return do


def _flash_counts():
    fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")

    return (fa.flash_attention.launches, fa.flash_attention_bwd.dq_launches,
            fa.flash_attention_bwd.dkv_launches, fa.flash_attention.copies)


def _zero_flash_counts():
    fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")

    fa.flash_attention.launches = fa.flash_attention.copies = 0
    fa.flash_attention_bwd.dq_launches = 0
    fa.flash_attention_bwd.dkv_launches = 0


def _adapter_setup():
    """The FedAdapter drive's data and config on the card, and
    ``build(dtype, attn_fn)`` of its api over a new frozen-base model."""
    import functools

    from fedml_tpu_torch.algos import FedAdapterAPI, FedConfig
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.local import seq_softmax_ce

    rng = np.random.RandomState(SEED)  # bench.py _token_fed
    seqs = rng.randint(1, VOCAB, size=(ADAPTER_CLIENTS * ADAPTER_PER_CLIENT,
                                       SEQ_LEN + 1))
    x, y = seqs[:, :SEQ_LEN].astype(np.int32), seqs[:, 1:].astype(np.int32)
    fed = build_federated_arrays(x, y, partition_homo(len(x),
                                                      ADAPTER_CLIENTS),
                                 ADAPTER_BATCH, device="cuda")
    cfg = FedConfig(client_num_in_total=ADAPTER_CLIENTS,
                    client_num_per_round=ADAPTER_PER_ROUND, comm_round=1,
                    epochs=1, batch_size=ADAPTER_BATCH, lr=ADAPTER_LR,
                    seed=SEED, adapter_rank=ADAPTER_RANK)
    loss_fn = functools.partial(seq_softmax_ce, pad_id=0)

    def build(dtype="bf16", attn_fn=None):
        model = create_model(
            "transformer_lm", vocab_size=VOCAB, d_model=D_MODEL,
            n_heads=N_HEADS, n_layers=N_LAYERS, max_len=SEQ_LEN, dtype=dtype,
            attn="flash", attn_fn=attn_fn, adapter_rank=ADAPTER_RANK,
            adapter_scope="attn", device="cuda",
            generator=torch.Generator().manual_seed(SEED))
        return FedAdapterAPI(model, fed, None, cfg, loss_fn=loss_fn,
                             device="cuda")

    return fed, cfg, build


def phase_adapter(shared=None):
    """FedAdapter training through FedAdapterAPI at the slice's config;
    returns {kernel name: launches in the timed rounds}. The api, with its
    personalized cohort, goes to ``shared["adapter"]`` (the ckpt phase's
    FedAdapter resume) when ``shared`` is given."""
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.core.tree import tree_leaves, tree_map
    from fedml_tpu_torch.data import gather_clients
    from fedml_tpu_torch.trainer.local import NetState

    fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")

    t0 = time.perf_counter()
    fed, cfg, build = _adapter_setup()
    api = build()
    prof = api.adapter_profile()
    steps = fed.steps_per_epoch * cfg.epochs
    tokens = ADAPTER_PER_ROUND * ADAPTER_PER_CLIENT * SEQ_LEN * cfg.epochs
    print(f"[adapter] transformer_lm d_model {D_MODEL}, {N_HEADS} heads, "
          f"{N_LAYERS} layers, vocab {VOCAB}, T {SEQ_LEN}, bf16, flash; LoRA "
          f"rank {ADAPTER_RANK} on attn: {prof['adapter_params']} adapter "
          f"params over a frozen base of {prof['base_params']}; "
          f"{ADAPTER_CLIENTS} clients x {ADAPTER_PER_CLIENT} sequences, "
          f"batch {ADAPTER_BATCH}, {ADAPTER_PER_ROUND} clients per round, "
          f"{steps} local steps per round, sgd lr {ADAPTER_LR}; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    base0 = {k: v.clone() for k, v in api.base.state_dict().items()}
    start = tree_map(torch.clone, api.net.params)
    t0 = time.perf_counter()
    warm = _eager_round(api, 0).item()
    print(f"[adapter] eager warm-up round: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, loss {warm:.4f}",
          flush=True)
    # (a) The captured fused round against the eager one.
    _hold_captured_round(api, 1, "adapter")

    _zero_flash_counts()
    replays = CapturedStep.replays
    round_ms, losses = [], []
    for r in range(2, ADAPTER_ROUNDS + 2):
        t0 = time.perf_counter()
        out = api.train_one_round(r)  # float(loss) syncs the round
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(out["train_loss"])
    fwd, dq, dkv, copies = _flash_counts()
    replays = CapturedStep.replays - replays
    want = ADAPTER_ROUNDS * steps * N_LAYERS
    med = statistics.median(round_ms)
    print(f"[adapter] train_one_round (replayed fused round) "
          f"{' / '.join(f'{t:.1f}' for t in round_ms)} ms (median "
          f"{med:.1f} ms = {tokens / med * 1e3:.0f} tokens/s); losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; {replays} replays",
          flush=True)
    print(f"[adapter] flash launches in the replayed rounds: fwd {fwd}, dq "
          f"{dq}, dkv {dkv} (expected {want} each = {ADAPTER_ROUNDS} rounds "
          f"x {steps} steps x {N_LAYERS} layers, one launch for all "
          f"{ADAPTER_PER_ROUND} clients); copies {copies}", flush=True)
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(replays == ADAPTER_ROUNDS, f"{replays} replays in "
          f"{ADAPTER_ROUNDS} rounds")
    check(fwd == dq == dkv == want,
          f"flash launches fwd {fwd} dq {dq} dkv {dkv}, expected {want}")
    check(copies == 0, f"{copies} copies on the way to the flash kernels")
    _time_pipelined(api, ADAPTER_ROUNDS, "adapter", tokens, "tokens")

    # (b) train_rounds_on_device: the warm call captures; three timed calls.
    _hold_on_device_rounds(api, ADAPTER_ROUNDS, "adapter")
    (fwd, dq, dkv, copies), _ = _time_on_device(
        api, ADAPTER_ROUNDS, "adapter", tokens, "tokens", _zero_flash_counts,
        _flash_counts)
    want = 3 * ADAPTER_ROUNDS * steps * N_LAYERS
    print(f"[adapter] flash launches in the timed on-device calls: fwd "
          f"{fwd}, dq {dq}, dkv {dkv} (expected {want} each = 3 calls x "
          f"{ADAPTER_ROUNDS} rounds x {steps} steps x {N_LAYERS} layers); "
          f"copies {copies}", flush=True)
    check(fwd == dq == dkv == want,
          f"on-device flash launches fwd {fwd} dq {dq} dkv {dkv}, expected "
          f"{want}")
    check(copies == 0, f"{copies} copies on the way to the flash kernels")
    after = api.base.state_dict()
    check(all(torch.equal(v, after[k]) for k, v in base0.items()),
          "the frozen base changed in training")
    moved = max((a - b).abs().max().item() for a, b in zip(
        tree_leaves(api.net.params), tree_leaves(start)))
    print(f"[adapter] frozen base bitwise unchanged over "
          f"{4 * ADAPTER_ROUNDS + 6} rounds (eager, replayed fused and "
          f"on-device); adapters moved by up to {moved:.4e}", flush=True)
    check(moved > 0, "the adapters did not move")

    # Kernels vs the plain twin from one start and keys: one local step of
    # a sampled cohort in f32 (the f32 kernels) and in bf16 (the tensor-core
    # kernels, the main path's), each again with a fault planted in dk/dv.
    def twin_fn(q, k, v, causal):
        return fa.flash_attention_plain(q, k, v, causal)[0]

    api32, twin32 = build(dtype=None), build(dtype=None, attn_fn=twin_fn)
    twin16 = build(attn_fn=twin_fn)
    net0 = NetState(tree_map(torch.clone, start), {})
    sub = gather_clients(fed, sample_clients(ADAPTER_ROUNDS + 1,
                                             ADAPTER_CLIENTS,
                                             ADAPTER_PER_ROUND))
    one = (sub.x[:, :1], sub.y[:, :1], sub.mask[:, :1])
    rngs = torch.arange(ADAPTER_PER_ROUND, device="cuda")

    def step(a):
        new = a.local_train.run_clients(net0, *one, rngs)[0].params
        return torch.cat([(v - s[None]).flatten() for v, s in zip(
            tree_leaves(new), tree_leaves(start))])

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def faulty_step(a):
        ext = fa.extension
        fa.extension = lambda: _SkipLastQTile(ext())
        try:
            return step(a)
        finally:
            fa.extension = ext

    step_t = step(twin32)
    rel_k, rel_fault = rel(step(api32), step_t), rel(faulty_step(api32), step_t)
    rel_k16, rel_t16 = rel(step(api), step_t), rel(step(twin16), step_t)
    rel_f16 = rel(faulty_step(api), step_t)
    bound16 = ADAPTER_BF16_FACTOR * rel_t16 + ADAPTER_BF16_SLACK
    print(f"[adapter] flash kernels vs plain twin, one local step in f32 from "
          f"one start and keys, |update diff|/|update|: {rel_k:.4e} (tol "
          f"{ADAPTER_STEP_TOL}); with the planted fault (dk/dv skip the last "
          f"Q tile) {rel_fault:.4e} (must exceed the tol); |update| "
          f"{step_t.norm().item():.4e}", flush=True)
    print(f"[adapter] the same step in bf16, distance from the f32 twin's "
          f"step: tensor-core kernels {rel_k16:.4e}, plain twin in bf16 "
          f"{rel_t16:.4e} (tol: kernels <= {ADAPTER_BF16_FACTOR} x twin + "
          f"{ADAPTER_BF16_SLACK} = {bound16:.4e}); with the planted fault "
          f"{rel_f16:.4e} (must exceed the tol)", flush=True)
    check(math.isfinite(rel_k) and rel_k <= ADAPTER_STEP_TOL,
          f"f32 kernel step disagrees with the plain twin: {rel_k}")
    check(not rel_fault <= ADAPTER_STEP_TOL,
          f"the step check passed a planted fault: {rel_fault}")
    check(math.isfinite(rel_k16) and rel_k16 <= bound16,
          f"bf16 kernel step is {rel_k16} from f32, the twin {rel_t16}")
    check(not rel_f16 <= bound16,
          f"the bf16 step check passed a planted fault: {rel_f16}")
    del api32, twin32, twin16, step_t

    cohort = api.sample_round(ADAPTER_ROUNDS)
    t0 = time.perf_counter()
    p_losses = api.personalize_cohort(cohort)
    pm = api.evaluate_personalized(clients=cohort)
    seen = api.personal_store().seen
    print(f"[adapter] personalize_cohort of clients {cohort.tolist()} "
          f"+ evaluate_personalized: {time.perf_counter() - t0:.1f} s; "
          f"losses {' '.join(f'{v:.4f}' for v in p_losses)}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in pm.items()), flush=True)
    check(bool(np.isfinite(p_losses).all())
          and all(math.isfinite(v) for v in pm.values()),
          f"non-finite personalization {p_losses} {pm}")
    check(bool(seen[cohort].all()) and int(seen.sum()) == len(cohort),
          f"personal store rows seen {np.flatnonzero(seen)}, expected "
          f"{sorted(cohort)}")
    f32 = F32_KERNELS + OLD_F32_KERNELS
    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    _profile_round(lambda: api.train_rounds_on_device(1).tolist(),
                   "on-device round (train_rounds_on_device(1))", "adapter",
                   flash, "flash kernels", top=0)
    rows = _profile_round(lambda: api.train_one_round(ADAPTER_ROUNDS + 2),
                          "replayed fused round (train_one_round)",
                          "adapter", flash, "flash kernels")
    if rows:  # the bf16 round reaches the tensor-core kernels, never f32's
        ran = {n: sum(c for key, c, _ in rows if n in key)
               for n in SM90_KERNELS + f32}
        dev = {n: round(sum(ms for key, _, ms in rows if n in key), 3)
               for n in SM90_KERNELS + f32}
        print(f"[adapter] profiled round, launches by kernel name: {ran}; "
              f"device ms: {dev}", flush=True)
        check(all(ran[n] == steps * N_LAYERS for n in SM90_KERNELS)
              and not any(ran[n] for n in f32),
              f"the profiled round's flash kernels: {ran}")
    if shared is not None:
        shared["adapter"], shared["adapter_build"] = api, build
    return {"flash_fwd": fwd, "flash_dq": dq, "flash_dkv": dkv}


def phase_vit():
    """FedAvg over the ViT through the f32 flash kernels at bench.py's
    vit_cifar_shaped config; returns {kernel name: launches in the counted
    rounds}."""
    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.data import (build_federated_arrays,
                                      make_image_classification,
                                      partition_homo)
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.transformer import flash_attention_out

    tag = "vit"
    t0 = time.perf_counter()
    x, y = make_image_classification(VIT_CLIENTS * VIT_PER_CLIENT,
                                     (32, 32, 3), 10, seed=SEED)
    fed = build_federated_arrays(x, y, partition_homo(len(x), VIT_CLIENTS),
                                 VIT_BATCH, device="cuda")
    del x, y
    cfg = FedConfig(client_num_in_total=VIT_CLIENTS,
                    client_num_per_round=VIT_PER_ROUND, comm_round=1,
                    epochs=1, batch_size=VIT_BATCH, lr=VIT_LR, seed=SEED)
    model = create_model("vit", num_classes=10, patch=VIT_PATCH,
                         d_model=VIT_D, n_heads=VIT_HEADS,
                         n_layers=VIT_LAYERS, attn_fn=flash_attention_out,
                         device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    api = FedAvgAPI(model, fed, None, cfg, device="cuda")
    steps = fed.steps_per_epoch * cfg.epochs
    per_round = steps * VIT_LAYERS  # launches of each flash kernel
    samples = VIT_PER_ROUND * VIT_PER_CLIENT * cfg.epochs
    n_params = sum(v.numel() for v in api.net.params.values())
    print(f"[{tag}] vit patch {VIT_PATCH}, d_model {VIT_D}, {VIT_HEADS} "
          f"heads (D {VIT_D // VIT_HEADS}), {VIT_LAYERS} layers, T "
          f"{(32 // VIT_PATCH) ** 2}, f32, flash ({n_params} params); "
          f"{VIT_CLIENTS} clients x {VIT_PER_CLIENT} samples, batch "
          f"{VIT_BATCH}, {VIT_PER_ROUND} a round, {steps} local steps, sgd "
          f"lr {VIT_LR}; set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    warm = _eager_round(api, 0).item()
    print(f"[{tag}] eager warm-up round {(time.perf_counter() - t0) * 1e3:.1f}"
          f" ms, loss {warm:.4f}", flush=True)
    # (a) The captured fused round bit-equal to its eager round (the flash
    # kernels add without atomics).
    _hold_captured_round(api, 1, tag, runs=1)
    capture_ms = api._graphs["fused"].capture_ms

    _zero_flash_counts()
    replays = CapturedStep.replays
    round_ms, losses = [], []
    for r in range(2, VIT_ROUNDS + 2):
        t0 = time.perf_counter()
        losses.append(api.train_one_round(r)["train_loss"])  # syncs
        round_ms.append((time.perf_counter() - t0) * 1e3)
    fwd, dq, dkv, copies = _flash_counts()
    replays = CapturedStep.replays - replays
    want = VIT_ROUNDS * per_round
    print(f"[{tag}] train_one_round (replayed) "
          f"{' / '.join(f'{t:.1f}' for t in round_ms)} ms (median "
          f"{statistics.median(round_ms):.1f} ms); losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; {replays} replays; "
          f"flash launches fwd {fwd}, dq {dq}, dkv {dkv} (expected {want} "
          f"each = {VIT_ROUNDS} rounds x {steps} steps x {VIT_LAYERS} "
          f"layers, one launch for all {VIT_PER_ROUND} clients), copies "
          f"{copies}", flush=True)
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(replays == VIT_ROUNDS, f"{replays} replays in {VIT_ROUNDS} rounds")
    check(fwd == dq == dkv == want and copies == 0,
          f"flash launches fwd {fwd} dq {dq} dkv {dkv}, copies {copies}; "
          f"expected {want} each and no copy")
    counted = {"flash_fwd": fwd, "flash_dq": dq, "flash_dkv": dkv}
    _time_pipelined(api, VIT_ROUNDS, tag, samples, "samples")
    # (b) The on-device rounds bit-equal to the eager host loop fed the
    # same cohorts; three timed calls, counted.
    _hold_on_device_rounds(api, 2, tag, loops=1)
    (fwd, dq, dkv, copies), med = _time_on_device(
        api, VIT_ROUNDS, tag, samples, "samples", _zero_flash_counts,
        _flash_counts)
    last = api.train_rounds_on_device(VIT_ROUNDS).tolist()
    want = 3 * VIT_ROUNDS * per_round
    print(f"[{tag}] flash launches in the timed on-device calls: fwd {fwd}, "
          f"dq {dq}, dkv {dkv} (expected {want} each), copies {copies}; "
          f"training loss of the replays: {losses[0]:.4f} (the first "
          f"replayed round) -> {last[-1]:.4f} (the last on-device round)",
          flush=True)
    check(fwd == dq == dkv == want and copies == 0,
          f"on-device flash launches fwd {fwd} dq {dq} dkv {dkv}, copies "
          f"{copies}; expected {want}")
    check(all(math.isfinite(v) for v in last) and last[-1] < losses[0],
          f"the replays' training loss did not fall: {losses[0]} -> {last}")
    for name, n in zip(("flash_fwd", "flash_dq", "flash_dkv"),
                       (fwd, dq, dkv)):
        counted[name] += n
    torch.cuda.reset_peak_memory_stats()
    api.train_rounds_on_device(1)
    print(f"[{tag}] on-device round {med:.2f} ms = "
          f"{samples / med * 1e3:.1f} samples/s; capture (fused) "
          f"{capture_ms:.1f} ms, (on-device) "
          f"{api._graphs['on_device'].capture_ms:.1f} ms; peak device "
          f"memory of a round {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; card {smi_line()}", flush=True)
    rows = _profile_round(lambda: api.train_rounds_on_device(1).tolist(),
                          "on-device round (train_rounds_on_device(1))", tag,
                          ("flash_",), "flash kernels", top=8)
    if rows:  # f32 reaches the f32 kernels, never the tensor-core or old ones
        ran = {n: sum(c for key, c, _ in rows if n in key)
               for n in F32_KERNELS + SM90_KERNELS + OLD_F32_KERNELS}
        print(f"[{tag}] profiled round, launches by kernel name: {ran}",
              flush=True)
        check(all(ran[n] == per_round for n in F32_KERNELS)
              and not any(ran[n] for n in SM90_KERNELS + OLD_F32_KERNELS),
              f"the profiled round's flash kernels: {ran}")
    del api, fed
    _free()
    return counted


def _run_leaves(api):
    """What a resume must restore, as tensors: the net, the key, the
    server optimizer state and the run state (client rows, not the
    dustbin row)."""
    from fedml_tpu_torch.core.graph import _leaves

    extra = {k: v for k, v in api.checkpoint_extra_state().items()
             if k not in ("personal_vecs", "personal_seen")}
    return _leaves((api.net, api.rng, getattr(api, "server_opt_state", None),
                    extra))


def _same_run(a_leaves, api):
    b_leaves = _run_leaves(api)
    return len(a_leaves) == len(b_leaves) and all(
        torch.equal(u, v) for u, v in zip(a_leaves, b_leaves))


def _resume_pin(tag, api, fresh, tier, rounds=4):
    """``rounds`` rounds of ``tier`` straight from ``api``'s state, against
    half of them + save_run + restore_run into ``fresh()`` (a new api) and
    into ``api`` itself (its captured static buffers) + the other half:
    every leaf bit-equal. Returns (save ms with the write, snapshot ms of
    an async save, restore ms, bytes)."""
    import tempfile

    from fedml_tpu_torch.obs import CheckpointManager, restore_run, save_run

    def run(a, lo, hi):
        if tier == "on_device":
            a.train_rounds_on_device(hi - lo).tolist()
        else:
            for r in range(lo, hi):
                a.train_one_round(r)

    half = rounds // 2
    start = _snapshot(api)
    store = (api.personal_store().state_dict()
             if getattr(api, "_personal_store", None) is not None else None)
    run(api, 0, rounds)
    want = [t.clone() for t in _run_leaves(api)]
    want_store = (api.personal_store().state_dict() if store is not None
                  else None)
    _restore(api, start)
    if store is not None:
        api.personal_store().load_state_dict(store)
    run(api, 0, half)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_run(mgr, api, half - 1, wait=False)
        snap_ms = (time.perf_counter() - t0) * 1e3
        mgr.wait()
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = os.path.getsize(os.path.join(d, str(half - 1), "state.pt"))
        results = []
        for label, target in (("a fresh api", fresh()), ("the api", api)):
            if target is api:  # its static buffers move past the step
                run(api, half, half + 1)
            if store is not None:
                target.personal_store()  # the template of the store
            t0 = time.perf_counter()
            nxt = restore_run(mgr, target)
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            check(nxt == half, f"{tag}: restore_run gave round {nxt}")
            run(target, half, rounds)
            same = _same_run(want, target)
            if store is not None:
                got = target.personal_store().state_dict()
                same = same and all(np.array_equal(got[k], want_store[k])
                                    for k in got)
            results.append((label, same, restore_ms))
            del target
        mgr.close()
    print(f"[{tag}] {tier}: {rounds} rounds straight vs {half} + save_run + "
          f"restore_run + {half}: "
          + "; ".join(f"into {label} {'bit-equal' if same else 'DIFFERENT'}"
                      f" (restore {ms:.1f} ms)" for label, same, ms in results)
          + f"; save {save_ms:.1f} ms with the write ({snap_ms:.1f} ms to "
          f"the async save's return: the host snapshot), {nbytes} bytes",
          flush=True)
    check(all(same for _, same, _ in results),
          f"{tag}: the resumed run differs from the straight one")
    return save_ms, snap_ms, results[0][2], nbytes


def phase_ckpt(shared=None):
    """Run checkpoints at full width: (a) FedAdam on ResNet-56-GN bf16 at
    the primary config on train_rounds_on_device and train_one_round, (b)
    SCAFFOLD (its control stacks) on train_one_round, (c) FedAdapter at
    its drive with a personalized cohort in the store; each bit-equal
    after a resume. Reuses the algos, custom and adapter phases' apis from
    ``shared`` (their captured tiers), else builds them."""
    from fedml_tpu_torch.algos import (FedAdapterAPI, FedConfig, FedOptAPI,
                                       ScaffoldAPI)
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model

    shared = {} if shared is None else shared

    def resnet56():
        return create_model("resnet56", num_classes=10, dtype="bf16",
                            device="cuda",
                            generator=torch.Generator().manual_seed(SEED))

    def primary(cls, **kw):
        x, y = _family_samples()
        fed = build_federated_arrays(x, y, partition_homo(
            len(x), TRAIN_CLIENTS), TRAIN_BATCH, device="cuda")
        cfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                        client_num_per_round=TRAIN_PER_ROUND, comm_round=1,
                        epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                        seed=SEED, **kw)
        return cls(resnet56(), fed, None, cfg, device="cuda")

    def fresh_like(api):
        return lambda: type(api)(resnet56(), api.train_fed, None, api.cfg,
                                 device="cuda")

    rows = []
    api = shared.pop("fedadam", None) or primary(
        FedOptAPI, server_optimizer="adam", server_lr=ALGO_SERVER_LR)
    for tier in ("on_device", "fused"):
        rows.append(("FedAdam " + tier, *_resume_pin(
            "ckpt/fedadam", api, fresh_like(api), tier)))
    del api
    _free()
    api = shared.pop("scaffold", None) or primary(ScaffoldAPI)
    rows.append(("SCAFFOLD fused", *_resume_pin(
        "ckpt/scaffold", api, fresh_like(api), "fused")))
    del api
    _free()
    api, build = shared.pop("adapter", None), shared.pop("adapter_build",
                                                          None)
    if api is None:
        build = _adapter_setup()[2]
        api = build()
        api.personalize_cohort(api.sample_round(0))
    seen = int(api.personal_store().seen.sum())
    rows.append((f"FedAdapter fused ({seen} personalized)", *_resume_pin(
        "ckpt/fedadapter", api, build, "fused")))
    del api, build
    _free()
    for name, save_ms, snap_ms, restore_ms, nbytes in rows:
        print(f"[ckpt] {name}: save {save_ms:.1f} ms ({snap_ms:.1f} ms "
              f"host snapshot), restore {restore_ms:.1f} ms, "
              f"{nbytes / 1e6:.2f} MB written", flush=True)
    return {}


def _synthetic_femnist(n_clients, seed):
    """bench.py's _synthetic_femnist_store data: lognormal(3.6, 0.7) sample
    counts (at least 1) from ``seed``, U[0, 1) 28 x 28 x 1 f32 samples, 62
    classes; returns (x, y, client index lists)."""
    rng = np.random.RandomState(seed)
    counts = np.maximum(1, rng.lognormal(3.6, 0.7, n_clients).astype(int))
    tot = int(counts.sum())
    x = rng.rand(tot, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 62, tot).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    return x, y, {c: np.arange(edges[c], edges[c + 1])
                  for c in range(n_clients)}


def _cohort_mb(store, steps, k, rounds=1):
    """Device MB of ``rounds`` cohorts of ``k`` clients at ``steps`` from
    the store: x, int64 labels, the f32 mask and the int32 counts."""
    per = (int(np.prod(store._sample_shape)) * store._sample_dtype.itemsize
           + 8 + 4)
    return rounds * (k * steps * store.batch_size * per + 4 * k) / 1e6


def _real_samples(api, start, n):
    counts = api._host_counts()
    return api.cfg.epochs * sum(
        int(counts[np.asarray(api.sample_round(r))].sum())
        for r in range(start, start + n))


def _graph_stats(api):
    return [g for step in api._graphs.values() for g in step.graph_stats()]


def _idle_share(run, label, tag):
    """``run()`` under torch.profiler recording the device only: the wall
    time, the device's busy time (the union of its kernels' and copies'
    intervals, read from the profiler's raw events) and the idle share
    1 - busy / wall. Returns the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _pad_profile()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        _pad_profile()
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and e.duration_ns() > 0)
    busy_ns, end = 0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy_ns += hi - max(lo, end)
            end = hi
    check(spans, f"{tag}: the profiler recorded no device activity")
    idle = 1 - busy_ns / 1e6 / wall_ms
    print(f"[{tag}] profiled {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ns / 1e6:.1f} ms over {len(spans)} kernels and copies "
          f"(idle share {idle:.3f})", flush=True)
    return idle


def _store_arm(tag, label, api, run, n_pin, n_timed):
    """One arm: ``run(start, n)`` trains rounds start..start+n-1. The pin's
    rounds 0..n_pin-1 (the captures among them), then n_timed rounds timed
    by the host clock to the losses' fetch (with ``n_timed`` 0, the pin's
    rounds are timed, less the captures' ms). Fails if any graph was
    captured more than once (a capture after its bucket's first). Returns
    (params and carry after the pin, rounds/s, the losses)."""
    from fedml_tpu_torch.core.graph import CapturedStep

    c0 = CapturedStep.captures
    t0 = time.perf_counter()
    losses = run(0, n_pin)
    pin_s = time.perf_counter() - t0
    state = _state_vec(api)
    stats = _graph_stats(api)
    if n_timed:
        samples = _real_samples(api, n_pin, n_timed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = run(n_pin, n_timed)
        dt = time.perf_counter() - t0
        stats = _graph_stats(api)
    else:
        n_timed, timed = n_pin, losses
        samples = _real_samples(api, 0, n_pin)
        dt = pin_s - sum(g["capture_ms"] for g in stats) / 1e3
    captures = CapturedStep.captures - c0
    check(all(math.isfinite(v) for v in losses + timed),
          f"{tag} {label}: non-finite losses")
    check(captures == len(stats), f"{tag} {label}: {captures} captures for "
          f"{len(stats)} graphs: a spec was captured again")
    graphs = ", ".join(
        f"S {g['args'][0][1] if len(g['args'][0]) > 1 else '-'}: "
        f"{g['capture_ms']:.0f} ms, {g['reserved'] / 2**20:.0f} MiB, "
        f"{g['replays']} replays" for g in stats)
    how = " (the pin less its captures)" if timed is losses else ""
    print(f"[{tag}] {label}: pin {n_pin} rounds {pin_s:.2f} s; timed "
          f"{n_timed} rounds {dt * 1e3:.1f} ms{how} = {n_timed / dt:.2f} "
          f"rounds/s, "
          f"{samples / dt:.1f} real samples/s; {captures} captures, one per "
          f"graph ({graphs}); last losses "
          f"{' '.join(f'{v:.4f}' for v in timed[-3:])}", flush=True)
    return state, n_timed / dt, losses


def _sanitized_rerun(tag, label, run):
    """The obs phase's (c) on a store loop: ``run()`` replays rounds whose
    step buckets are captured already, in a strict sanitized() region
    (transfer 'disallow'): no capture and no implicit host sync, or the
    drive fails."""
    from fedml_tpu_torch.obs import sanitized

    t0 = time.perf_counter()
    with sanitized() as rep:
        losses = run()
    print(f"[obs/sanitized] {tag} {label}: {len(losses)} rounds again in a "
          f"strict sanitized() region: {rep.compiles} captures, no implicit "
          f"host sync, {time.perf_counter() - t0:.2f} s", flush=True)
    check(all(math.isfinite(v) for v in losses), f"{tag}: non-finite")


def _femnist_store_arms(card):
    """(a) FEMNIST-3400: resident, store synced and store windowed from one
    start and key, bit-equal after STORE_ROUNDS rounds; then (d) the same
    federation in a sharded, memmapped store. Under cuDNN's deterministic
    mode (f32 convolutions)."""
    import tempfile

    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data import build_federated_arrays
    from fedml_tpu_torch.data.directory import ShardedFederatedStore
    from fedml_tpu_torch.data.store import FederatedStore
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.utils import rss_mb

    tag = "store/femnist3400"
    t0 = time.perf_counter()
    x, y, parts = _synthetic_femnist(STORE_CLIENTS, SEED)
    rss_data = rss_mb()
    store = FederatedStore(x, y, parts, STORE_BATCH, device="cuda")
    rss_flat = rss_mb() - rss_data
    cfg = FedConfig(client_num_in_total=STORE_CLIENTS,
                    client_num_per_round=STORE_PER_ROUND, comm_round=100_000,
                    epochs=1, batch_size=STORE_BATCH, lr=STORE_LR, seed=SEED)

    def build(fed):
        model = create_model("cnn", num_classes=62, device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
        return FedAvgAPI(model, fed, None, cfg, device="cuda")

    n_all = STORE_ROUNDS + STORE_TIMED + STORE_WINDOW
    cohorts = [sample_clients(r, STORE_CLIENTS, STORE_PER_ROUND)
               for r in range(n_all)]
    buckets = [store.cohort_steps(c) for c in cohorts]
    wins = [max(buckets[lo:lo + STORE_WINDOW])
            for lo in range(0, n_all, STORE_WINDOW)]
    steps_res = -(-int(store.counts.max()) // STORE_BATCH)
    print(f"[{tag}] cnn (CNNDropOut, 62 classes), {STORE_CLIENTS} writers, "
          f"{int(store.counts.sum())} samples (max {int(store.counts.max())} "
          f"a writer), {STORE_PER_ROUND} a round, batch {STORE_BATCH}, lr "
          f"{STORE_LR}, window {STORE_WINDOW}; host store "
          f"{store.nbytes() / 1e6:.1f} MB (RSS +{rss_flat:.0f} MB); the "
          f"rounds' buckets "
          f"{dict(sorted(collections.Counter(buckets).items()))}, the "
          f"windows' {wins}; resident layout {steps_res} steps a writer; "
          f"set-up {time.perf_counter() - t0:.1f} s; cuDNN deterministic",
          flush=True)
    n_pin, n_timed = STORE_ROUNDS, STORE_TIMED
    out = {}
    with _cudnn_deterministic():
        t0 = time.perf_counter()
        fed = build_federated_arrays(x, y, parts, STORE_BATCH, device="cuda")
        res_mb = sum(t.numel() * t.element_size() for t in
                     (fed.x, fed.y, fed.mask, fed.counts)) / 1e6
        print(f"[{tag}] resident layout built in "
              f"{time.perf_counter() - t0:.1f} s: {res_mb:.1f} MB on the "
              f"card", flush=True)
        api = build(fed)

        def pipelined(start, n):
            return api.train_rounds_pipelined(n, start_round=start)

        out["resident"] = _store_arm(tag, "resident, train_rounds_pipelined",
                                     api, pipelined, n_pin, n_timed)
        idle = {"resident": _idle_share(
            lambda: pipelined(n_pin + n_timed, STORE_PROFILED),
            f"resident: {STORE_PROFILED} pipelined rounds", tag)}
        del api, fed
        _free()
        api = build(store)
        out["synced"] = _store_arm(tag, "store synced, train_rounds_pipelined"
                                   " with the cohort prefetcher", api,
                                   pipelined, n_pin, n_timed)
        synced_mb = np.mean([_cohort_mb(store, b, STORE_PER_ROUND)
                             for b in buckets[n_pin:n_pin + n_timed]])
        idle["synced"] = _idle_share(
            lambda: pipelined(n_pin + n_timed, STORE_WINDOW),
            f"store synced: {STORE_WINDOW} rounds", tag)
        _sanitized_rerun(tag, "store synced", lambda: pipelined(
            0, STORE_WINDOW))
        del api
        _free()
        api = build(store)
        snap = {}

        def windowed(start, n):
            got = []
            for lo in range(start, start + n, STORE_WINDOW):
                got += api.train_rounds_windowed(STORE_WINDOW,
                                                 start_round=lo,
                                                 window=STORE_WINDOW)
                if lo == 0:
                    snap["w16"] = _state_vec(api)
            return got

        out["windowed"] = _store_arm(tag, f"store windowed, W {STORE_WINDOW}",
                                     api, windowed, n_pin, n_timed)
        win_mb = _cohort_mb(store, max(wins), STORE_PER_ROUND, STORE_WINDOW)
        idle["windowed"] = _idle_share(
            lambda: windowed(n_pin + n_timed, STORE_WINDOW),
            f"store windowed: one window of {STORE_WINDOW}", tag)
        _sanitized_rerun(tag, f"store windowed, W {STORE_WINDOW}",
                         lambda: api.train_rounds_windowed(
                             STORE_WINDOW, window=STORE_WINDOW))
        del api
        _free()
        ref = out["resident"][0]
        for arm in ("synced", "windowed"):
            d = (out[arm][0] - ref).abs().max().item()
            print(f"[{tag}] pin: {arm} vs resident params after {n_pin} "
                  f"rounds max|d| {d:.3e} "
                  f"({'bit-equal' if d == 0 else 'NOT bit-equal'})",
                  flush=True)
            check(torch.equal(out[arm][0], ref),
                  f"{tag}: the {arm} arm is {d} from the resident arm")
        rps = {arm: out[arm][1] for arm in out}
        print(f"[{tag}] rounds/s resident {rps['resident']:.2f}, synced "
              f"{rps['synced']:.2f}, windowed {rps['windowed']:.2f} "
              f"(windowed / synced {rps['windowed'] / rps['synced']:.3f}); "
              f"idle shares "
              f"{json.dumps({k: round(v, 3) for k, v in idle.items()})}; "
              f"data on the card: resident {res_mb:.1f} MB, a synced cohort "
              f"{synced_mb:.2f} MB, the window's superbatch {win_mb:.1f} MB "
              f"(= its H2D a window; synced: {synced_mb * STORE_WINDOW:.1f} "
              f"MB a window of rounds); host store {store.nbytes() / 1e6:.1f}"
              f" MB; {card}", flush=True)

        # (d) The same federation in 8 memmapped shards.
        rss0 = rss_mb()
        with tempfile.TemporaryDirectory(prefix="store_shards_") as tmp:
            t0 = time.perf_counter()
            sh = ShardedFederatedStore.from_flat(
                x, y, parts, STORE_BATCH, num_shards=STORE_SHARDS,
                spill_dir=tmp, device="cuda")
            build_s = time.perf_counter() - t0
            rss1 = rss_mb()
            idx2d = np.stack(cohorts[:STORE_WINDOW])
            steps = wins[0]
            a = sh.gather_window(idx2d, steps)
            rss2 = rss_mb()
            b = store.gather_window(idx2d, steps)
            same = all(torch.equal(getattr(a, f), getattr(b, f))
                       for f in ("x", "y", "mask", "counts"))
            check(same, f"{tag}: the sharded window differs from the flat "
                  "store's")
            del a, b
            api = build(sh)
            t0 = time.perf_counter()
            api.train_rounds_windowed(STORE_WINDOW, window=STORE_WINDOW)
            torch.cuda.synchronize()
            sh_s = time.perf_counter() - t0
            d = (_state_vec(api) - snap["w16"]).abs().max().item()
            print(f"[{tag}] sharded store ({STORE_SHARDS} memmapped shards, "
                  f"built in {build_s:.1f} s): gather_window of "
                  f"[{STORE_WINDOW}, {STORE_PER_ROUND}] at S {steps} "
                  f"byte-equal to the flat store's; {STORE_WINDOW} windowed "
                  f"rounds {sh_s:.2f} s (its capture included), params max|d|"
                  f" {d:.3e} from the flat windowed arm's after "
                  f"{STORE_WINDOW} rounds; RSS: the flat store +{rss_flat:.0f}"
                  f" MB, the sharded store +{rss1 - rss0:.0f} MB built and "
                  f"+{rss2 - rss0:.0f} MB after one window's gather (its "
                  f"{_cohort_mb(sh, steps, STORE_PER_ROUND, STORE_WINDOW):.0f}"
                  f" MB of pinned staging included)", flush=True)
            check(d == 0, f"{tag}: the sharded store's rounds are {d} from "
                  "the flat store's")
            del api, sh
            _free()
    return rps


def _zoo_store_arms(card):
    """(c) The windowed zoo: each arm's windowed rounds against its own host
    loop (train_rounds_pipelined) from one start, params and carry
    bit-equal."""
    from fedml_tpu_torch.algos import (FedConfig, FedDynAPI, FedNovaAPI,
                                       FedOptAPI, ScaffoldAPI)
    from fedml_tpu_torch.data.store import FederatedStore
    from fedml_tpu_torch.models import create_model

    classes = {"FedOpt": (FedOptAPI, {}, dict(server_optimizer="adam",
                                              server_lr=0.01)),
               "FedNova": (FedNovaAPI, {}, {}),
               "FedDyn": (FedDynAPI, dict(alpha=0.05), {}),
               "SCAFFOLD": (ScaffoldAPI, {}, {})}
    rps = {}
    for name, model_name, n_clients, seed, lr in ZOO_STORE:
        tag = f"store/{name}"
        cls, kw, cfg_kw = classes[name]
        x, y, parts = _synthetic_femnist(n_clients, seed)
        cfg = FedConfig(client_num_in_total=n_clients,
                        client_num_per_round=STORE_PER_ROUND,
                        comm_round=100_000, epochs=1,
                        batch_size=STORE_BATCH, lr=lr, seed=SEED, **cfg_kw)

        def build():
            gen = torch.Generator().manual_seed(SEED)
            model = (create_model("cnn", num_classes=62, device="cuda",
                                  generator=gen) if model_name == "cnn" else
                     create_model("lr", in_features=784, num_classes=62,
                                  device="cuda", generator=gen))
            return cls(model, FederatedStore(x, y, parts, STORE_BATCH,
                                             device="cuda"),
                       None, cfg, device="cuda", **kw)

        print(f"[{tag}] {model_name} over {n_clients} writers from seed "
              f"{seed}, lr {lr}, {kw or cfg_kw or ''}; window {STORE_WINDOW}",
              flush=True)
        with _cudnn_deterministic():
            host, win = build(), build()
            sh, rh, _ = _store_arm(
                tag, "host loop", host,
                lambda s, n: host.train_rounds_pipelined(n, start_round=s),
                STORE_ROUNDS, 0)
            sw, rw, _ = _store_arm(
                tag, f"windowed, W {STORE_WINDOW}", win,
                lambda s, n: win.train_rounds_windowed(
                    n, start_round=s, window=STORE_WINDOW),
                STORE_ROUNDS, 0)
            if name in ("FedOpt", "SCAFFOLD"):
                _sanitized_rerun(tag, f"windowed, W {STORE_WINDOW}",
                                 lambda: win.train_rounds_windowed(
                                     STORE_WINDOW, window=STORE_WINDOW))
        d = (sh - sw).abs().max().item()
        print(f"[{tag}] pin: params and carry ({sh.numel()} values) max|d| "
              f"{d:.3e} ({'bit-equal' if d == 0 else 'NOT bit-equal'}); "
              f"windowed / host-loop rounds/s {rw / rh:.3f}; {card}",
              flush=True)
        check(d == 0, f"{tag}: windowed rounds {d} from the host loop's")
        rps[name] = (rh, rw)
        del host, win, x, y
        _free()
    return rps


def _flagship_store(card):
    """(b) The flagship from a store: ResNet-56-GN bf16 at the primary
    config, windowed (W 8) against the resident pipelined rounds from one
    start, bit-equal; the GroupNorm launches counted in both."""
    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.data.store import FederatedStore
    from fedml_tpu_torch.models import create_model

    tag = "store/flagship"
    x, y = _cifar_samples()
    parts = partition_homo(len(x), TRAIN_CLIENTS)
    cfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                    client_num_per_round=TRAIN_PER_ROUND, comm_round=100_000,
                    epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED)

    def build(fed):
        model = create_model("resnet56", num_classes=10, dtype="bf16",
                             device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
        return FedAvgAPI(model, fed, None, cfg, device="cuda")

    store = FederatedStore(x, y, parts, TRAIN_BATCH, device="cuda")
    steps = TRAIN_PER_CLIENT // TRAIN_BATCH
    n = FLAGSHIP_STORE_ROUNDS
    samples = n * TRAIN_PER_ROUND * TRAIN_PER_CLIENT
    counted = [0, 0]
    states, rate = {}, {}
    for arm, fed, run in (
            ("resident pipelined",
             build_federated_arrays(x, y, parts, TRAIN_BATCH, device="cuda"),
             lambda api: api.train_rounds_pipelined(n)),
            (f"store windowed W {FLAGSHIP_WINDOW}", store,
             lambda api: api.train_rounds_windowed(n,
                                                   window=FLAGSHIP_WINDOW))):
        api = build(fed)
        _zero_gn_counts()
        c0 = CapturedStep.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = run(api)
        dt = time.perf_counter() - t0
        fwd, bwd, red, copies, streamed = _gn_counts()
        caps = CapturedStep.captures - c0
        want = (n + caps) * steps * RESNET56_GN
        states[arm] = _net_vec(api.net)
        rate[arm] = samples / dt
        print(f"[{tag}] {arm}: {n} rounds {dt:.2f} s with {caps} capture(s) "
              f"({samples / dt:.1f} samples/s, capture included); losses "
              f"{losses[0]:.4f} .. {losses[-1]:.4f}; GroupNorm launches fwd "
              f"{fwd}, bwd {bwd}, reduce {red} (expected {want} = ({n} rounds"
              f" + {caps} warm-up) x {steps} steps x {RESNET56_GN}), streamed"
              f" {streamed}, copies {copies}", flush=True)
        check(all(math.isfinite(v) for v in losses), f"{tag}: non-finite")
        check(fwd == bwd == red == want, f"{tag} {arm}: GroupNorm launches "
              f"{fwd} {bwd} {red}, expected {want}")
        check(streamed == 0, f"{tag}: {streamed} forwards streamed")
        counted[0] += fwd
        counted[1] += bwd
        del api, fed
        _free()
    a, b = states.values()
    d = (a - b).abs().max().item()
    print(f"[{tag}] pin: windowed vs resident params after {n} rounds "
          f"max|d| {d:.3e} ({'bit-equal' if d == 0 else 'NOT bit-equal'}); "
          f"{card}", flush=True)
    check(d == 0, f"{tag}: the store's windowed rounds are {d} from the "
          "resident pipelined rounds")
    return {"group_norm_fwd": counted[0], "group_norm_bwd": counted[1]}


def _adapter_store(card):
    """(e) FedAdapter from a store at the adapter phase's config,
    windowed (W 4) against the resident pipelined rounds from one start,
    bit-equal; the flash launches counted in both."""

    from fedml_tpu_torch.algos import FedAdapterAPI, FedConfig
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.data.store import FederatedStore
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.local import seq_softmax_ce

    tag = "store/adapter"
    rng = np.random.RandomState(SEED)
    seqs = rng.randint(1, VOCAB, size=(ADAPTER_CLIENTS * ADAPTER_PER_CLIENT,
                                       SEQ_LEN + 1))
    x, y = seqs[:, :SEQ_LEN].astype(np.int32), seqs[:, 1:].astype(np.int32)
    parts = partition_homo(len(x), ADAPTER_CLIENTS)
    cfg = FedConfig(client_num_in_total=ADAPTER_CLIENTS,
                    client_num_per_round=ADAPTER_PER_ROUND,
                    comm_round=100_000, epochs=1, batch_size=ADAPTER_BATCH,
                    lr=ADAPTER_LR, seed=SEED, adapter_rank=ADAPTER_RANK)

    def build(fed):
        model = create_model(
            "transformer_lm", vocab_size=VOCAB, d_model=D_MODEL,
            n_heads=N_HEADS, n_layers=N_LAYERS, max_len=SEQ_LEN,
            dtype="bf16", attn="flash", adapter_rank=ADAPTER_RANK,
            adapter_scope="attn", device="cuda",
            generator=torch.Generator().manual_seed(SEED))
        return FedAdapterAPI(model, fed, None, cfg, device="cuda",
                             loss_fn=functools.partial(seq_softmax_ce,
                                                       pad_id=0))

    steps = ADAPTER_PER_CLIENT // ADAPTER_BATCH
    n = ADAPTER_STORE_ROUNDS
    tokens = n * ADAPTER_PER_ROUND * ADAPTER_PER_CLIENT * SEQ_LEN
    counted = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    states = {}
    for arm, fed, run in (
            ("resident pipelined",
             build_federated_arrays(x, y, parts, ADAPTER_BATCH,
                                    device="cuda"),
             lambda api: api.train_rounds_pipelined(n)),
            (f"store windowed W {ADAPTER_WINDOW}",
             FederatedStore(x, y, parts, ADAPTER_BATCH, device="cuda"),
             lambda api: api.train_rounds_windowed(n,
                                                   window=ADAPTER_WINDOW))):
        api = build(fed)
        base0 = [t.clone() for t in api.base.state_dict().values()]
        _zero_flash_counts()
        c0 = CapturedStep.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = run(api)
        dt = time.perf_counter() - t0
        fwd, dq, dkv, copies = _flash_counts()
        caps = CapturedStep.captures - c0
        want = (n + caps) * steps * N_LAYERS
        states[arm] = _net_vec(api.net)
        frozen = all(torch.equal(a, b) for a, b in
                     zip(base0, api.base.state_dict().values()))
        print(f"[{tag}] {arm}: {n} rounds {dt:.2f} s with {caps} capture(s) "
              f"({tokens / dt:.0f} tokens/s, capture included); losses "
              f"{losses[0]:.4f} .. {losses[-1]:.4f}; flash launches fwd "
              f"{fwd}, dq {dq}, dkv {dkv} (expected {want} = ({n} rounds + "
              f"{caps} warm-up) x {steps} steps x {N_LAYERS} layers), copies "
              f"{copies}; frozen base unchanged: {frozen}", flush=True)
        check(all(math.isfinite(v) for v in losses), f"{tag}: non-finite")
        check(fwd == dq == dkv == want, f"{tag} {arm}: flash launches "
              f"{fwd} {dq} {dkv}, expected {want}")
        check(copies == 0 and frozen, f"{tag}: {copies} copies, frozen "
              f"base unchanged {frozen}")
        for k, v in zip(("flash_fwd", "flash_dq", "flash_dkv"),
                        (fwd, dq, dkv)):
            counted[k] += v
        del api, fed
        _free()
    a, b = states.values()
    d = (a - b).abs().max().item()
    print(f"[{tag}] pin: windowed vs resident adapters after {n} rounds "
          f"max|d| {d:.3e} ({'bit-equal' if d == 0 else 'NOT bit-equal'}); "
          f"{card}", flush=True)
    check(d == 0, f"{tag}: the store's windowed rounds are {d} from the "
          "resident pipelined rounds")
    return counted


def phase_store():
    """The host-resident client store and the windowed tier (see the
    constants): (a) FEMNIST-3400's three arms and (d) its sharded store,
    (c) the windowed zoo, (b) the flagship and (e) FedAdapter from a
    store. Returns {kernel name: launches counted in (b) and (e)}."""
    t_phase = time.perf_counter()
    card = smi_line()
    launches = {}
    times = {}
    for name, fn in (("a+d", _femnist_store_arms), ("c", _zoo_store_arms),
                     ("b", _flagship_store), ("e", _adapter_store)):
        t0 = time.perf_counter()
        got = fn(card)
        times[name] = time.perf_counter() - t0
        if name in ("b", "e"):
            launches.update(got)
    secs = json.dumps({k: round(v, 1) for k, v in times.items()})
    print(f"[store] drives' seconds {secs}; phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return launches


def _resnet56_flops(b):
    """Two flops a MAC of every convolution of CifarResNet's ResNet-56 at
    32 x 32 (the stem, each bottleneck's 1x1, 3x3 and 1x1 and its
    downsample; full 3x3 taps, as FlopCounterMode counts them) and the
    Dense head, for ``b`` samples."""
    macs = 32 * 32 * 3 * 16 * 9
    cin, h = 16, 32
    for stage, planes in enumerate((16, 32, 64)):
        for j in range(6):
            stride = 2 if stage > 0 and j == 0 else 1
            ho = h // stride
            macs += h * h * cin * planes + ho * ho * planes * planes * 9
            macs += ho * ho * planes * 4 * planes
            if stride != 1 or cin != 4 * planes:
                macs += ho * ho * cin * 4 * planes
            cin, h = 4 * planes, ho
    return 2 * b * (macs + cin * 10)


def _transformer_flops(b, t, d, layers, tail):
    """Two flops a MAC of a pre-LN transformer of ``layers`` blocks at
    width ``d`` over ``b`` x ``t`` tokens: the qkv and out projections
    (4d²), the 4x MLP (8d²) and attention's two products (2td) a token and
    layer, plus ``tail`` MACs a token (the LM head's d·V)."""
    return 2 * b * t * (layers * (12 * d * d + 2 * t * d) + tail)


def _obs_costs(card):
    """(a) model_cost of four models on the card, each held to its count
    by hand, and counted again without the flop formula of its kernel:
    returns the flash forward's launches."""
    from torch.utils import flop_counter

    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.transformer import flash_attention_out
    from fedml_tpu_torch.obs import flops_str, model_cost
    from fedml_tpu_torch.ops import group_norm as gn

    fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")
    flash_op = torch.ops.fedml_tpu_torch.flash_fwd
    gn_op = torch.ops.fedml_tpu_torch.group_norm_fwd
    b, lb, t = OBS_COST_BATCH, OBS_LM_BATCH, SEQ_LEN
    gen = torch.Generator().manual_seed(SEED)
    vit_t, vit_d = (32 // VIT_PATCH) ** 2, VIT_D
    gn_elems = b * sum(n * s * c for (_, s, c), _, n in GN_STEP)
    cases = [
        ("resnet56 bf16 (GroupNorm kernels)",
         lambda: create_model("resnet56", num_classes=10, dtype="bf16",
                              device="cuda", generator=gen),
         np.zeros((b, 32, 32, 3), np.float32), _resnet56_flops(b), gn_op,
         7 * gn_elems, lambda: gn.group_norm_fwd.launches, RESNET56_GN),
        ("cnn at FEMNIST's shape",
         lambda: create_model("cnn", num_classes=62, device="cuda",
                              generator=gen),
         np.zeros((b, 28, 28, 1), np.float32),
         2 * b * (26 * 26 * 32 * 9 + 24 * 24 * 64 * 32 * 9
                  + 12 * 12 * 64 * 128 + 128 * 62), None, 0, None, 0),
        (f"vit (vit_cifar_shaped, f32 flash kernels, T {vit_t})",
         lambda: create_model("vit", num_classes=10, patch=VIT_PATCH,
                              d_model=VIT_D, n_heads=VIT_HEADS,
                              n_layers=VIT_LAYERS,
                              attn_fn=flash_attention_out, device="cuda",
                              generator=gen),
         np.zeros((b, 32, 32, 3), np.float32),
         _transformer_flops(b, vit_t, vit_d, VIT_LAYERS,
                            3 * VIT_PATCH ** 2 * vit_d) + 2 * b * vit_d * 10,
         flash_op, VIT_LAYERS * 4 * b * vit_t * vit_t * vit_d,
         lambda: fa.flash_attention.launches, VIT_LAYERS),
        (f"transformer_lm (transformer_fed_mfu's width, bf16 flash, T {t})",
         lambda: create_model("transformer_lm", vocab_size=VOCAB,
                              d_model=D_MODEL, n_heads=N_HEADS,
                              n_layers=N_LAYERS, max_len=t, dtype="bf16",
                              attn="flash", device="cuda", generator=gen),
         np.ones((lb, t), np.int32),
         _transformer_flops(lb, t, D_MODEL, N_LAYERS, D_MODEL * VOCAB),
         flash_op, N_LAYERS * 4 * lb * t * t * D_MODEL,
         lambda: fa.flash_attention.launches, N_LAYERS),
    ]
    flash = 0
    for label, build, x, analytic, op, op_flops, launches, per_fwd in cases:
        model = build()
        n0 = launches() if launches else 0
        t0 = time.perf_counter()
        cost = model_cost(model, x)
        ms = (time.perf_counter() - t0) * 1e3
        got = cost["flops"]
        line = (f"[obs/cost] {label}: {flops_str(cost)}, {got:.6e} flops "
                f"({got / analytic:.4f} x the count by hand {analytic:.6e}, "
                f"band [1, {OBS_COST_BAND}]), {cost['bytes_accessed']:.4e} "
                f"bytes unfused; {ms:.0f} ms")
        check(analytic <= got <= OBS_COST_BAND * analytic,
              f"{label}: model_cost {got} outside [{analytic}, "
              f"{OBS_COST_BAND} x] of the count by hand")
        if op is not None:
            ran = launches() - n0
            formula = flop_counter.flop_registry.pop(op)
            try:
                without = model_cost(model, x)["flops"]
            finally:
                flop_counter.flop_registry[op] = formula
            ran2 = launches() - n0 - ran
            line += (f"; without {op._qualified_op_name}'s flop formula "
                     f"{without:.6e} (the formula's {got - without:.6e}, "
                     f"by hand {op_flops:.6e}); kernel launches {ran} and "
                     f"{ran2} (expected {per_fwd} a forward)")
            check(got - without == op_flops,
                  f"{label}: the formula counted {got - without}, by hand "
                  f"{op_flops}")
            check(ran == ran2 == per_fwd,
                  f"{label}: {ran}, {ran2} launches, expected {per_fwd}")
            if op is flash_op:
                flash += ran + ran2
        print(line + f"; {card}", flush=True)
        del model
    _free()
    return flash


def _flagship_api(shared):
    """The train phase's FedAvg api (its fused and on-device rounds
    captured), or one built and warmed here when the phase runs alone."""
    if shared is not None and "flagship" in shared:
        return shared.pop("flagship")
    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model

    x, y = _cifar_samples()
    fed = build_federated_arrays(x, y, partition_homo(len(x), TRAIN_CLIENTS),
                                 TRAIN_BATCH, device="cuda")
    cfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                    client_num_per_round=TRAIN_PER_ROUND, comm_round=1,
                    epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED)
    model = create_model("resnet56", num_classes=10, dtype="bf16",
                         device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    api = FedAvgAPI(model, fed, None, cfg, device="cuda")
    api.train_one_round(0)
    api.train_rounds_on_device(1)
    return api


def _obs_flagship(api, card):
    """(b) RoundTimer against CUDA events and the profiler's trace, (c) the
    pipelined rounds in a strict sanitized() region with (d) the donation
    audit, and the negative control of an implicit sync. Returns the
    GroupNorm launches counted."""
    import tempfile

    from fedml_tpu_torch.obs import RoundTimer, donation_audit, sanitized
    from fedml_tpu_torch.obs.timing import trace

    tag = "obs/flagship"
    steps = TRAIN_PER_CLIENT // TRAIN_BATCH
    _zero_gn_counts()
    timer, ev_ms, host_ms = RoundTimer(), [], []
    torch.cuda.synchronize()  # each round's phase starts on an idle card
    for _ in range(OBS_TIMER_ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with timer.phase("on_device_round"):
            start.record()
            losses = api.train_rounds_on_device(1)
            end.record()
            timer.fence(losses)
        ev_ms.append(start.elapsed_time(end))
        host_ms.append(timer.summary()["on_device_round"]["last_s"] * 1e3)
    summ = timer.summary()["on_device_round"]
    worst = max(abs(h - e) - max(OBS_TIMER_REL * e, OBS_TIMER_MS)
                for h, e in zip(host_ms, ev_ms))
    print(f"[{tag}] RoundTimer over {OBS_TIMER_ROUNDS} fenced on-device "
          f"rounds: phase ms {' '.join(f'{v:.2f}' for v in host_ms)}; CUDA "
          f"events ms {' '.join(f'{v:.2f}' for v in ev_ms)}; summary mean "
          f"{summ['mean_s'] * 1e3:.2f} ms, total {summ['total_s'] * 1e3:.1f}"
          f" ms, n {summ['n']}; flat_metrics {timer.flat_metrics()}; worst "
          f"excess over max({OBS_TIMER_REL:.0%}, {OBS_TIMER_MS} ms) "
          f"{worst:.3f} ms; {card}", flush=True)
    check(summ["n"] == OBS_TIMER_ROUNDS and worst <= 0,
          f"{tag}: RoundTimer phases {host_ms} vs CUDA events {ev_ms}")
    with tempfile.TemporaryDirectory(prefix="obs_trace_") as log_dir:
        t0 = time.perf_counter()
        with trace(log_dir):
            timer.fence(api.train_rounds_on_device(OBS_TRACE_ROUNDS))
        files = os.listdir(log_dir)
        check(len(files) == 1, f"{tag}: trace wrote {files}")
        path = os.path.join(log_dir, files[0])
        mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        secs = time.perf_counter() - t0
    names = collections.Counter(
        m.group(1) for m in (re.search(r"\b(gn_\w+_kernel)\b",
                                       e.get("name", ""))
                             for e in events if e.get("cat") == "kernel")
        if m)
    want = OBS_TRACE_ROUNDS * steps * RESNET56_GN
    print(f"[{tag}] trace(log_dir) around {OBS_TRACE_ROUNDS} on-device "
          f"rounds: one Chrome trace of {mb:.1f} MB, {len(events)} events "
          f"({secs:.1f} s with the export and the read); GroupNorm kernels "
          f"by name {dict(sorted(names.items()))} (expected {want} of "
          f"gn_fwd_kernel, gn_bwd_kernel and gn_reduce_kernel)", flush=True)
    check(names["gn_fwd_kernel"] == names["gn_bwd_kernel"] == want,
          f"{tag}: the trace's GroupNorm kernels {dict(names)}")

    with sanitized() as rep:
        with donation_audit(api.net) as audit:
            base = audit.sample()
            for r in range(OBS_SAN_ROUNDS):
                api.train_rounds_pipelined(1, start_round=100 + r)
                audit.sample()
    print(f"[{tag}] {OBS_SAN_ROUNDS} train_rounds_pipelined rounds in a "
          f"strict sanitized() region (transfer 'disallow'): "
          f"{rep.compiles} captures, no implicit host sync; donation audit "
          f"peak {audit.peak:.3f} model copies against the baseline "
          f"{base:.3f} (pin: baseline + {OBS_AUDIT_SLACK}; the copies: the "
          f"fused and on-device graphs' static carries, one of them "
          f"api.net, and the module's own parameters)", flush=True)
    check(rep.compiles == 0 and audit.peak <= base + OBS_AUDIT_SLACK,
          f"{tag}: {rep.compiles} captures, audit peak {audit.peak} vs "
          f"baseline {base}")
    fwd, bwd = _gn_counts()[:2]
    want = (OBS_TIMER_ROUNDS + OBS_TRACE_ROUNDS + OBS_SAN_ROUNDS) * steps \
        * RESNET56_GN
    check(fwd == bwd == want, f"{tag}: GroupNorm launches {fwd}, {bwd}, "
          f"expected {want}")
    t = torch.ones(4, device="cuda")
    try:
        with sanitized():
            t.sum().item()
    except RuntimeError as e:
        print(f"[{tag}] negative control: .item() in a sanitized() region "
              f"raised RuntimeError ({str(e).splitlines()[0][:80]}); sync "
              f"mode after it {torch.cuda.get_sync_debug_mode()}",
              flush=True)
    else:
        raise SmokeFailure(f"{tag}: .item() passed a sanitized() region")
    check(torch.cuda.get_sync_debug_mode() == 0,
          f"{tag}: the sync debug mode was not restored")
    return {"group_norm_fwd": fwd, "group_norm_bwd": bwd}


def _so_api(store, n_clients):
    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.local import seq_softmax_ce

    cfg = FedConfig(client_num_in_total=n_clients,
                    client_num_per_round=SO_PER_ROUND, comm_round=100_000,
                    epochs=1, batch_size=SO_BATCH, lr=SO_LR, seed=SEED)
    model = create_model("rnn_stackoverflow", vocab_size=SO_VOCAB,
                         device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    return FedAvgAPI(model, store, None, cfg, device="cuda",
                     loss_fn=functools.partial(seq_softmax_ce, pad_id=0),
                     pad_id=0)


def _warm_buckets(api, store, tag, strict_last=False):
    """bench.py's _warm_store_buckets: one round of the store's captured
    step per step bucket a client can reach (a cohort of one client of
    that bucket, repeated), so no capture lands in a timed loop. With
    ``strict_last``, the largest bucket is warmed inside a strict
    sanitized() region, which must raise SanitizerError (the negative
    control of a new bucket in a steady loop). Returns {bucket: ms}."""
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.data.store import bucket_steps_for_counts
    from fedml_tpu_torch.obs import SanitizerError, sanitized

    buckets = bucket_steps_for_counts(store.counts, store.batch_size)
    step = api._stored_round_step()
    key = keys.key(SEED, device="cuda")  # its H2D copy outside the region
    out = {}
    levels = sorted(set(buckets.tolist()))
    for i, bkt in enumerate(levels):
        idx = np.full(SO_PER_ROUND, int(np.argmax(buckets == bkt)))

        def warm():
            sub = store.gather_cohort(idx)
            carry = (api.net, api._window_carry_init())
            (api.net, extra), loss = step(carry, sub.x, sub.y, sub.mask,
                                          sub.counts, key)
            api._window_carry_commit(extra)

        t0 = time.perf_counter()
        if strict_last and i == len(levels) - 1:
            try:
                with sanitized():
                    warm()
            except SanitizerError as e:
                print(f"[{tag}] negative control: bucket {bkt} captured in "
                      f"a strict sanitized() region raised SanitizerError "
                      f"({str(e)[:96]}...)", flush=True)
            else:
                raise SmokeFailure(f"{tag}: a new bucket passed a strict "
                                   "sanitized() region")
        else:
            warm()
        torch.cuda.synchronize()
        out[bkt] = (time.perf_counter() - t0) * 1e3
    return out


def _so_timed(api, store, tag, label, run, start, n):
    """``run(start, n)`` in a strict sanitized() region, timed by the host
    clock to its losses' fetch: (rounds/s, real samples/s, losses)."""
    from fedml_tpu_torch.obs import sanitized

    samples = sum(int(store.counts[np.asarray(api.sample_round(r))].sum())
                  for r in range(start, start + n))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sanitized() as rep:
        losses = run(start, n)
    dt = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in losses), f"{tag}: non-finite loss")
    print(f"[{tag}] {label}: {n} rounds {dt * 1e3:.1f} ms = {n / dt:.2f} "
          f"rounds/s, {samples / dt:.1f} real samples/s ({samples} "
          f"sentences); strict sanitized(): {rep.compiles} captures, no "
          f"implicit host sync; losses {losses[0]:.4f} .. {losses[-1]:.4f}",
          flush=True)
    return n / dt, samples / dt


def _gather_probe(api, store):
    """bench.py's _gather_overlap_probe: the median ms of a synchronous
    cohort gather and copy of rounds the loops never visit."""
    ts = []
    for r in range(90_001, 90_001 + SO_PROBES):
        idx = np.asarray(api.sample_round(r))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.gather_cohort(idx)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _so_captures(api):
    return {g["args"][0][1]: (round(g["capture_ms"]), g["replays"])
            for g in _graph_stats(api)}


def _so_342k(card):
    """(e) bench.py's stackoverflow_342k on the card."""
    from fedml_tpu_torch.data.store import FederatedStore
    from fedml_tpu_torch.data.synthetic import make_stackoverflow_nwp
    from fedml_tpu_torch.utils import rss_mb

    tag = "obs/so342k"
    rss0 = rss_mb()
    t0 = time.perf_counter()
    x, y, parts = make_stackoverflow_nwp(SO_CLIENTS, seq_len=SO_T,
                                         vocab=SO_VOCAB)
    store = FederatedStore(x, y, parts, SO_BATCH, device="cuda")
    del x, y, parts
    build_s = time.perf_counter() - t0
    api = _so_api(store, SO_CLIENTS)
    n_params = sum(v.numel() for v in api.net.params.values())
    warm = _warm_buckets(api, store, tag, strict_last=True)
    print(f"[{tag}] RNNStackOverflow (embed 96, LSTM 670, vocab {SO_VOCAB}; "
          f"{n_params} params) over {store.num_clients} clients, "
          f"{int(store.counts.sum())} sentences of T {SO_T} (at most "
          f"{int(store.counts.max())} a client), {SO_PER_ROUND} a round, "
          f"batch {SO_BATCH}, lr {SO_LR:.4f}; store built in {build_s:.1f} "
          f"s, {store.nbytes() / 1e6:.1f} MB on the host; buckets warmed "
          f"(ms, each a capture) {warm}; RSS {rss0:.0f} MB before the data",
          flush=True)
    snap = _snapshot(api)
    synced = api.train_rounds_pipelined(SO_PIN)
    a = _state_vec(api)
    _restore(api, snap)
    windowed = api.train_rounds_windowed(SO_PIN, window=SO_PIN)
    b = _state_vec(api)
    d = (a - b).abs().max().item()
    first = synced[0]
    print(f"[{tag}] pin: {SO_PIN} synced vs {SO_PIN} windowed rounds (W "
          f"{SO_PIN}) from one start: params max|d| {d:.3e} "
          f"({'bit-equal' if d == 0 else 'NOT bit-equal'}), losses "
          f"{synced} / {windowed}; round 0's mean loss {first:.4f} against "
          f"ln {SO_VOCAB} = {math.log(SO_VOCAB):.4f}", flush=True)
    check(d == 0 and synced == windowed,
          f"{tag}: windowed rounds {d} from the synced ones")
    check(math.isfinite(first)
          and abs(first - math.log(SO_VOCAB)) <= SO_LOSS_TOL,
          f"{tag}: round 0's loss {first}")
    rps, sps = _so_timed(api, store, tag, "synced loop "
                         "(train_rounds_pipelined, cohort prefetcher)",
                         lambda s, n: api.train_rounds_pipelined(
                             n, start_round=s), SO_PIN, SO_TIMED)
    wrps, wsps = _so_timed(api, store, tag, f"windowed loop, W {SO_WINDOW}",
                           lambda s, n: api.train_rounds_windowed(
                               n, start_round=s, window=SO_WINDOW),
                           SO_PIN + SO_TIMED, SO_TIMED)
    gather_ms = _gather_probe(api, store)
    rss1 = rss_mb()
    print(f"[{tag}] rounds/s synced {rps:.2f}, windowed {wrps:.2f} "
          f"(windowed / synced {wrps / rps:.3f}); host gather {gather_ms:.2f}"
          f" ms a round (x rounds/s = {gather_ms * rps / 1e3:.3f} of a synced"
          f" round); RSS {rss0:.0f} -> {rss1:.0f} MB; host store "
          f"{store.nbytes() / 1e6:.1f} MB; captures by bucket (ms, replays) "
          f"{_so_captures(api)}; {card}", flush=True)
    del api, store
    _free()
    return {"rps": rps, "rss": rss1, "sps": sps}


def _so_1m(card, ref):
    """(f) bench.py's synthetic_1m on the card: 2^20 clients in 64
    memmapped shards in a temporary directory, removed afterwards."""
    import shutil
    import tempfile

    from fedml_tpu_torch.data.directory import ShardedFederatedStore
    from fedml_tpu_torch.data.synthetic import make_stackoverflow_shard
    from fedml_tpu_torch.utils import rss_mb

    tag = "obs/so1m"
    c, g = SO_1M_CLIENTS, SO_1M_SHARDS
    sizes = [c // g + (1 if s < c % g else 0) for s in range(g)]
    spill = tempfile.mkdtemp(prefix="so1m_")
    try:
        rss0 = rss_mb()
        t0 = time.perf_counter()
        store = ShardedFederatedStore.from_shard_builder(
            lambda s: make_stackoverflow_shard(sizes[s], seq_len=SO_T,
                                               vocab=SO_VOCAB,
                                               seed=SO_1M_SEED + s),
            g, batch_size=SO_BATCH, spill_dir=spill, device="cuda")
        build_s, build_rss = time.perf_counter() - t0, rss_mb()
        dir_mb = sum(os.path.getsize(os.path.join(spill, f))
                     for f in os.listdir(spill)) / 1e6
        api = _so_api(store, c)
        warm = _warm_buckets(api, store, tag)
        rps, sps = _so_timed(api, store, tag, "synced loop "
                             "(train_rounds_pipelined, cohort prefetcher)",
                             lambda s, n: api.train_rounds_pipelined(
                                 n, start_round=s), 0, SO_TIMED)
        gather_ms = _gather_probe(api, store)
        rss1 = rss_mb()
        print(f"[{tag}] {store.num_clients} clients in {g} memmapped shards"
              f" ({int(store.counts.sum())} sentences), built in "
              f"{build_s:.1f} s, build RSS {build_rss:.0f} MB (+"
              f"{build_rss - rss0:.0f}); disk {store.nbytes() / 1e6:.1f} MB "
              f"(spill directory {dir_mb:.1f} MB), directory "
              f"{store.directory.nbytes() / 1e6:.2f} MB; buckets warmed "
              f"{warm}; rounds/s {rps:.2f} (rps_vs_342k "
              f"{rps / ref['rps']:.3f}), {sps:.1f} real samples/s; "
              f"peak_rss_ratio {rss1 / ref['rss']:.3f} ({rss1:.0f} / "
              f"{ref['rss']:.0f} MB); host gather {gather_ms:.2f} ms a "
              f"round; captures by bucket {_so_captures(api)}; {card}",
              flush=True)
        check(store.num_clients == c and store.memmapped,
              f"{tag}: {store.num_clients} clients, memmapped "
              f"{store.memmapped}")
        del api, store
        _free()
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    check(not os.path.exists(spill), f"{tag}: {spill} left behind")


def phase_obs(shared=None):
    """The observability layer on the main paths, and StackOverflow-NWP
    FedAvg at 342,477 and 1,048,576 clients (see the constants): (a) the
    model costs, (b)-(d) on the flagship (the train phase's api from
    ``shared``, else built here), (e) and (f). Returns {kernel name:
    launches counted}."""
    t_phase = time.perf_counter()
    card = smi_line()
    times = {}
    t0 = time.perf_counter()
    flash = _obs_costs(card)
    times["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    api = _flagship_api(shared)
    launches = _obs_flagship(api, card)
    del api
    _free()
    times["b-d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = _so_342k(card)
    times["e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _so_1m(card, ref)
    times["f"] = time.perf_counter() - t0
    launches["flash_fwd"] = flash
    secs = json.dumps({k: round(v, 1) for k, v in times.items()})
    print(f"[obs] parts' seconds {secs}; phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return launches


# --- knobs: BatchNorm's last refusals and FedAvgAPI's knobs ---------------
# (a) the A2 tail's drives: the split family at 8 clients of
# FAMILY_PER_CLIENT samples (2 local steps, cut from 256 to pay for the
# fed phase; the split phase takes 32 of 256), DecentralizedAPI over 16
# of the flagship's
# clients (the zoo phase takes 32), TurboAggregate at the flagship's 8 a
# round, FedNAS at the extra phase's pin net (NAS_PIN_LAYERS cells) and
# FedGAN at its sizes, all with norm="bn".
KNOB_SPLIT_CLIENTS, KNOB_GOSSIP_CLIENTS = 8, 16
# (b) selection on the flagship: pow_d over 16 candidates, 3 rounds
# resident and 3 from the store; oort 4 rounds, checkpointed after 2.
KNOB_POW_D, KNOB_POW_D_ROUNDS, KNOB_OORT_ROUNDS = 16, 3, 4
# (c) compression: 2 rounds of each codec on both tiers.
KNOB_COMPRESS, KNOB_COMPRESS_ROUNDS = ("topk0.05", "q8"), 2
# (d) bench.py's cnn_mfu_levers (bench.py:2290-2367: 16 clients x 64, batch
# 16, 8 a round, 10 accuracy rounds, lr 0.1) and layout_fused_round
# (bench.py:2388: 64 x 128, batch 20, 10 a round, widths 120/120, lr 0.05),
# nothing cut but the timing: each arm timed over KNOB_TIMED synced rounds
# (20 before the cv phase). The
# mis-sized GroupNorm ResNet of tests/test_layout.py (widths 20/40/80, stem
# 20; depth resnet20's 2-2-2), f32 at ROUND_LR on the flagship data.
LEVERS = dict(clients=16, per_client=64, batch=16, per_round=8,
              acc_rounds=10, lr=0.1)
LAYOUT_BENCH = dict(clients=64, per_client=128, batch=20, per_round=10,
                    widths=(120, 120), lr=0.05)
KNOB_TIMED = 10
MIS_WIDTHS, MIS_STEM, MIS_LAYERS = (20, 40, 80), 20, (2, 2, 2)
# The mis-sized ResNet's logical params under compute_layout="auto" against
# "none" after 2 f32 rounds at lr 1e-3: cuDNN may pick other convolution
# algorithms at the padded widths, which sum in other orders; 1e-5 of the
# params' scale (the two rounds move them by ~1e-3).
LAYOUT_F32_TOL = 1e-5


def _bit_equal(tag, what, want, got):
    """Two lists of tensors, bit for bit."""
    dist = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(want, got))
    print(f"[{tag}] {what}: max|d| {dist:.3e} (must be bit-equal)",
          flush=True)
    check(dist == 0, f"{tag}: {what} is {dist} apart")


def _stats_moved(tag, before, after, rows=None):
    """Every running-stat buffer moved from ``before`` (each of ``rows``
    client rows, when given)."""
    moved = 0
    for k, v in before.items():
        now = after[k]
        if rows is None:
            moved += not torch.equal(v, now)
        else:
            moved += all(not torch.equal(v[c], now[c]) for c in range(rows))
    print(f"[{tag}] running stats moved from their init: {moved} of "
          f"{len(before)} buffers{'' if rows is None else f' (every one of {rows} client rows)'}",
          flush=True)
    check(before and moved == len(before),
          f"{tag}: {len(before) - moved} buffers did not move")


def _clone_state(state):
    return {k: v.clone() for k, v in state.items()}


def _knob_split(card, x, y):
    """FedGKT over resnet5_56 + resnet56_server and SplitNN over
    resnet_split_bottom + resnet56_server, all norm="bn", f32, at
    KNOB_SPLIT_CLIENTS clients of the flagship data."""
    from fedml_tpu_torch.algos import FedConfig, FedGKTAPI, SplitNNAPI
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.graph import _leaves, _map
    from fedml_tpu_torch.core.tree import client_rows
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.local import NetState

    n = KNOB_SPLIT_CLIENTS
    m = n * FAMILY_PER_CLIENT
    fed = build_federated_arrays(x[:m], y[:m], partition_homo(m, n),
                                 TRAIN_BATCH, device="cuda")
    cfg = FedConfig(client_num_in_total=n, client_num_per_round=n,
                    comm_round=1, epochs=1, batch_size=TRAIN_BATCH,
                    lr=TRAIN_LR, seed=SEED)
    clone = lambda tree: _map(torch.clone, tree)  # noqa: E731

    def models(stump):
        gen = torch.Generator().manual_seed(SEED)
        return (create_model(stump, num_classes=10, norm="bn",
                             device="cuda", generator=gen),
                create_model("resnet56_server", num_classes=10, norm="bn",
                             device="cuda", generator=gen))

    tag = "knobs/FedGKTAPI-bn"
    api = FedGKTAPI(*models("resnet5_56"), fed, None, cfg,
                    temperature=GKT_T, server_lr=GKT_SERVER_LR,
                    device="cuda")
    c0 = _clone_state(api.client_nets.model_state)
    s0 = _clone_state(api.server_net.model_state)
    print(f"[{tag}] {n} clients x {FAMILY_PER_CLIENT} (the split phase "
          f"takes {SPLIT_CLIENTS}), resnet5_56 + resnet56_server, "
          f"norm='bn', f32; {len(c0)} stump buffers a client, {len(s0)} "
          f"tail buffers", flush=True)
    with _cudnn_deterministic():
        _gkt_pins(api, tag, runs=1)
        api.client_nets = NetState(api.client_nets.params, clone(c0))
        api.server_net = NetState(api.server_net.params, clone(s0))
        out = api.train_one_round(0)
    print(f"[{tag}] round 0: client loss {out['client_loss']:.4f}, server "
          f"loss {out['server_loss']:.4f}", flush=True)
    _stats_moved(tag, c0, api.client_nets.model_state, rows=n)
    _stats_moved(tag, s0, api.server_net.model_state)
    del api
    _free()

    tag = "knobs/SplitNNAPI-bn"
    api = SplitNNAPI(*models("resnet_split_bottom"), fed, None, cfg,
                     device="cuda")
    c0 = _clone_state(api.client_nets.model_state)
    s0 = _clone_state(api.server_net.model_state)
    start = (clone(api.client_nets), clone(api.client_opts),
             clone(api.server_net), clone(api.server_opt),
             torch.zeros((), device="cuda"))
    key = keys.split(keys.fold_in(api.rng, 0xC), n)[0]
    with _cudnn_deterministic():
        want, _ = api._build_segment()(clone(start), api._ids[0], key)
        got, _ = api._segment_step()(clone(start), api._ids[0], key)
        _bit_equal(tag, "client 0's segment captured vs eager (the "
                   "stacks' params, running stats and momenta, the top)",
                   _leaves(want), _leaves(got))
        api._graphs.clear()
        loss = api.train_one_epoch(0)["train_loss"]
    print(f"[{tag}] one relay cycle over {n} clients: loss {loss:.4f}; "
          f"{card}", flush=True)
    check(math.isfinite(loss), f"{tag}: loss {loss}")
    _stats_moved(tag, {k: v[:n] for k, v in c0.items()},
                 client_rows(api.client_nets.model_state), rows=n)
    _stats_moved(tag, s0, api.server_net.model_state)
    del api
    _free()


def _knob_zoo_bn(card, x, y):
    """DecentralizedAPI (DSGD) over resnet56(norm="bn", bf16) at
    KNOB_GOSSIP_CLIENTS clients and TurboAggregate at the flagship's 8 a
    round: each captured round bit-equal to its uncaptured one from one
    start, the running stats moved."""
    from fedml_tpu_torch.algos import (DecentralizedAPI, FedConfig,
                                       TurboAggregateAPI)
    from fedml_tpu_torch.core.graph import _leaves, _map
    from fedml_tpu_torch.core.topology import SymmetricTopologyManager
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model

    def model():
        return create_model("resnet56", num_classes=10, norm="bn",
                            dtype="bf16", device="cuda",
                            generator=torch.Generator().manual_seed(SEED))

    clone = lambda tree: _map(torch.clone, tree)  # noqa: E731
    n = KNOB_GOSSIP_CLIENTS
    m = n * TRAIN_PER_CLIENT
    fed = build_federated_arrays(x[:m], y[:m], partition_homo(m, n),
                                 TRAIN_BATCH, device="cuda")
    cfg = FedConfig(client_num_in_total=n, client_num_per_round=n,
                    comm_round=1, epochs=1, batch_size=TRAIN_BATCH,
                    lr=TRAIN_LR, seed=SEED)
    tag = "knobs/DecentralizedAPI-dsgd-bn"
    api = DecentralizedAPI(model(), fed, None, cfg,
                           SymmetricTopologyManager(n, neighbor_num=4,
                                                    seed=SEED),
                           device="cuda")
    start = (clone(api.nets), api.push_weights.clone(), api.rng.clone())
    with _cudnn_deterministic():
        api._round_step = api._gossip_step  # the uncaptured round
        eager_loss = api.train_one_round(0)["train_loss"]
        del api._round_step
        want = _leaves(api.nets) + [api.push_weights]
        api.nets, api.push_weights, api.rng = (clone(start[0]),
                                               start[1].clone(),
                                               start[2].clone())
        loss = api.train_one_round(0)["train_loss"]
    _bit_equal(tag, f"the captured round vs the uncaptured one ({n} "
               "clients' params and running stats, push weights)",
               want + [torch.tensor(eager_loss)],
               _leaves(api.nets) + [api.push_weights, torch.tensor(loss)])
    _stats_moved(tag, start[0].model_state, api.nets.model_state, rows=n)
    del api
    _free()

    fed = build_federated_arrays(x, y, partition_homo(len(x), TRAIN_CLIENTS),
                                 TRAIN_BATCH, device="cuda")
    tcfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                     client_num_per_round=TRAIN_PER_ROUND, comm_round=1,
                     epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                     seed=SEED)
    tag = "knobs/TurboAggregateAPI-bn"
    apis = [TurboAggregateAPI(model(), fed, None, tcfg,
                              n_groups=ZOO_TA_GROUPS, device="cuda")
            for _ in range(2)]
    apis[0]._local_batch = apis[0]._cohort_training  # uncaptured
    s0 = _clone_state(apis[1].net.model_state)
    with _cudnn_deterministic():
        losses = [a.train_one_round(0)["train_loss"] for a in apis]
    _bit_equal(tag, "the round with its cohort training captured vs "
               "uncaptured (the MPC aggregate of params and running stats)",
               _leaves(apis[0].net) + [torch.tensor(losses[0])],
               _leaves(apis[1].net) + [torch.tensor(losses[1])])
    _stats_moved(tag, s0, apis[1].net.model_state)
    print(f"[{tag}] round 0 loss {losses[1]:.4f}; {card}", flush=True)
    del apis
    _free()


def _knob_extra_bn(card):
    """FedNAS over darts(norm="bn") at NAS_PIN_LAYERS cells and FedGAN with
    the BatchNorm1d generator at the extra phase's sizes: pin (a) from one
    eager run under cuDNN's deterministic mode, the stats moved."""
    from fedml_tpu_torch.algos import FedConfig, FedGanAPI, FedNASAPI
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model

    rng = np.random.RandomState(SEED)
    x = rng.randn(NAS_CLIENTS * NAS_PER_CLIENT, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, len(x)).astype(np.int32)
    fed = build_federated_arrays(x, y, partition_homo(len(x), NAS_CLIENTS),
                                 NAS_BATCH, device="cuda")
    tag = "knobs/FedNASAPI-bn"
    model = create_model("darts", num_classes=10, norm="bn",
                         layers=NAS_PIN_LAYERS, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    api = FedNASAPI(model, fed, None, FedConfig(
        client_num_in_total=NAS_CLIENTS, client_num_per_round=NAS_PER_ROUND,
        comm_round=3, epochs=1, batch_size=NAS_BATCH, lr=NAS_LR, seed=SEED),
        arch_lr=NAS_ARCH_LR, device="cuda")
    s0 = _clone_state(api.net.model_state)
    print(f"[{tag}] darts c 16, {NAS_PIN_LAYERS} layers, norm='bn' "
          f"({len(s0)} buffers), {NAS_CLIENTS} clients x {NAS_PER_CLIENT}, "
          f"batch {NAS_BATCH}, {NAS_PER_ROUND} a round", flush=True)
    with _cudnn_deterministic():
        _hold_captured_round(api, 0, tag, runs=1)
    _stats_moved(tag, s0, api.net.model_state)
    del api, model, fed
    _free()

    tag = "knobs/FedGanAPI-bn"
    n = GAN_CLIENTS * GAN_PER_CLIENT
    gx = np.tanh(rng.randn(n, 28, 28, 1)).astype(np.float32)
    fed = build_federated_arrays(gx, np.zeros(n, np.int32),
                                 partition_homo(n, GAN_CLIENTS), GAN_BATCH,
                                 device="cuda")
    api = FedGanAPI(create_model("mnist_gan", norm="bn", device="cuda",
                                 generator=torch.Generator()
                                 .manual_seed(SEED)),
                    fed, FedConfig(client_num_in_total=GAN_CLIENTS,
                                   client_num_per_round=GAN_PER_ROUND,
                                   comm_round=3, epochs=1,
                                   batch_size=GAN_BATCH, lr=GAN_LR,
                                   seed=SEED), device="cuda")
    s0 = _clone_state(api.net.model_state)
    with _cudnn_deterministic():
        _hold_captured_round(api, 0, tag, runs=1)
    _stats_moved(tag, s0, api.net.model_state)
    img = api.generate(16)
    check(bool(torch.isfinite(img).all()), f"{tag}: generate not finite")
    print(f"[{tag}] generate(16) in eval mode (the running stats): "
          f"{tuple(img.shape)}; {card}", flush=True)
    del api, fed
    _free()


def _flagship_build(fed, **kw):
    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.models import create_model

    cfg = FedConfig(**{**dict(client_num_in_total=TRAIN_CLIENTS,
                              client_num_per_round=TRAIN_PER_ROUND,
                              comm_round=100, epochs=1,
                              batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                              seed=SEED), **kw})
    model = create_model("resnet56", num_classes=10, dtype="bf16",
                         device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    return FedAvgAPI(model, fed, None, cfg, device="cuda")


def _refused_with(tag, what, call, want):
    try:
        call()
    except NotImplementedError as exc:
        check(want in str(exc), f"{tag}: {what} refusal: {exc}")
        print(f"[{tag}] {what} refused: {exc}", flush=True)
    else:
        raise SmokeFailure(f"{tag}: {what} ran")


def _knob_selection(card, fed, store):
    """(b) pow_d and oort on the flagship. Returns the GroupNorm launches
    counted in the resident pow_d rounds."""
    import tempfile

    from fedml_tpu_torch.core.sampling import sample_clients_weighted
    from fedml_tpu_torch.obs.checkpoint import (CheckpointManager,
                                                restore_run, save_run)

    tag = "knobs/pow_d"
    runs = {}
    counted = [0, 0]
    for arm, data in (("resident", fed), ("store", store)):
        api = _flagship_build(data, client_selection="pow_d",
                              pow_d_candidates=KNOB_POW_D)
        cohorts, losses, held = [], [], 0
        with _cudnn_deterministic():
            for r in range(KNOB_POW_D_ROUNDS):
                if arm == "resident":
                    cand = sample_clients_weighted(
                        r, TRAIN_CLIENTS, KNOB_POW_D, api._host_counts())
                    _, plain = api._eval_losses_step(False)(
                        api.net, torch.as_tensor(cand, device="cuda").long())
                    plain = plain.double().cpu().numpy()
                    want = set(cand[np.argsort(-plain, kind="stable")[
                        :TRAIN_PER_ROUND]].tolist())
                if arm == "resident" and r > 0:
                    _zero_gn_counts()
                t0 = time.perf_counter()
                losses.append(api.train_one_round(r)["train_loss"])
                ms = (time.perf_counter() - t0) * 1e3
                if arm == "resident" and r > 0:
                    fwd, bwd, red, copies, streamed = _gn_counts()
                    counted[0] += fwd
                    counted[1] += bwd
                    print(f"[{tag}] {arm} round {r}: {ms:.1f} ms; "
                          f"GroupNorm launches fwd {fwd}, bwd {bwd}, reduce "
                          f"{red} (the candidates' eval, then the round: "
                          f"fwd = 2 x bwd), streamed {streamed}", flush=True)
                    check(fwd == 2 * bwd == 2 * red and streamed == 0
                          and copies == 0, f"{tag}: GroupNorm launches "
                          f"{fwd}/{bwd}/{red}")
                got = [int(i) for i in api._sample_cache[1]]
                cohorts.append(got)
                if arm == "resident":
                    check(set(got) == want, f"{tag}: round {r} cohort {got}"
                          f", the plain eval's top {sorted(want)}")
                    held += 1
        runs[arm] = (cohorts, losses, _net_vec(api.net))
        print(f"[{tag}] {arm}: cohorts {cohorts}; losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}"
              + (f"; each cohort the {TRAIN_PER_ROUND} highest losses of "
                 f"the {KNOB_POW_D} candidates by a plain (uncaptured) eval"
                 if held else ""), flush=True)
        _refused_with(tag, "train_rounds_pipelined",
                      lambda: api.train_rounds_pipelined(1), "pow_d")
        if arm == "resident":
            _refused_with(tag, "train_rounds_on_device",
                          lambda: api.train_rounds_on_device(1),
                          "loss-biased selection (pow_d/oort) needs the "
                          "host loop")
        else:
            _refused_with(tag, "train_rounds_windowed",
                          lambda: api.train_rounds_windowed(2, window=2),
                          "only seeded-random selection permits")
        del api
        _free()
    (ca, la, va), (cb, lb, vb) = runs["resident"], runs["store"]
    check(ca == cb, f"{tag}: store cohorts {cb}, resident {ca}")
    _bit_equal(tag, "store vs resident after 3 rounds (params, losses)",
               [va, torch.tensor(la)], [vb, torch.tensor(lb)])

    tag = "knobs/oort"
    api = _flagship_build(fed, client_selection="oort")
    with _cudnn_deterministic():
        api.train_one_round(0)
        first = [int(i) for i in api._sample_cache[1]]
        seen = set(np.flatnonzero(api._oort_last >= 0).tolist())
        check(seen == set(first) and bool(
            (api._oort_utility[first] > 0).all()) and not bool(
            api._oort_utility[api._oort_last < 0].any()),
              f"{tag}: utilities written outside the cohort {first}")
        api.train_one_round(1)
        second = [int(i) for i in api._sample_cache[1]]
        exploited = len(set(second) & set(first))
        print(f"[{tag}] round 0 cohort {first} (explored; utilities written "
              f"for these {len(first)} only), round 1 cohort {second} "
              f"({exploited} exploited)", flush=True)
        check(exploited >= TRAIN_PER_ROUND - math.ceil(
            api.cfg.oort_epsilon * TRAIN_PER_ROUND),
              f"{tag}: round 1 exploited {exploited}")
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            save_run(mgr, api, 1)
            t0 = time.perf_counter()
            straight = [api.train_one_round(r)["train_loss"]
                        for r in range(2, KNOB_OORT_ROUNDS)]
            oort_ms = ((time.perf_counter() - t0) * 1e3
                       / (KNOB_OORT_ROUNDS - 2))
            want = [_net_vec(api.net), torch.tensor(straight),
                    torch.from_numpy(api._oort_utility.copy()),
                    torch.from_numpy(api._oort_last.copy())]
            check(restore_run(mgr, api) == 2, f"{tag}: resume round")
            mgr.close()
            again = [api.train_one_round(r)["train_loss"]
                     for r in range(2, KNOB_OORT_ROUNDS)]
    host = api._graphs["host"]
    print(f"[{tag}] {KNOB_OORT_ROUNDS} rounds through the host round (its "
          f"step captured once: {host.capture_ms:.1f} ms of warm-up + "
          f"capture; the server update and the utilities on the host); "
          f"losses {' '.join(f'{v:.4f}' for v in straight)} after the "
          f"checkpoint, {oort_ms:.1f} ms a round (host clock, synced by "
          f"its loss and the utilities' fetch; cuDNN deterministic)",
          flush=True)
    _bit_equal(tag, "rounds 2-3 resumed from the run checkpoint after "
               "round 1 vs straight (params, losses, utilities, last seen)",
               want, [_net_vec(api.net), torch.tensor(again),
                      torch.from_numpy(api._oort_utility.copy()),
                      torch.from_numpy(api._oort_last.copy())])
    _refused_with(tag, "train_rounds_pipelined",
                  lambda: api.train_rounds_pipelined(1),
                  "oort updates per-client utilities after every round")
    _refused_with(tag, "train_rounds_on_device",
                  lambda: api.train_rounds_on_device(1),
                  "loss-biased selection (pow_d/oort) needs the host loop")
    del api
    _free()
    sapi = _flagship_build(store, client_selection="oort")
    _refused_with(tag, "train_rounds_windowed",
                  lambda: sapi.train_rounds_windowed(2, window=2),
                  "only seeded-random selection permits")
    del sapi
    print(f"[knobs] selection done; {card}", flush=True)
    return counted


def _knob_compress(card, fed):
    """(c) topk0.05 and q8 on the flagship: train_one_round fed the
    on-device tier's cohorts vs train_rounds_on_device from one start, bit
    for bit; topk1.0 vs plain FedAvg; q8 deltas on their grid."""
    from torch.func import vmap

    from fedml_tpu_torch.core import compression as tc
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.data import gather_clients
    from fedml_tpu_torch.parallel.shard import client_rngs
    from fedml_tpu_torch.trainer.local import NetState

    n = KNOB_COMPRESS_ROUNDS
    for comp in KNOB_COMPRESS:
        tag = f"knobs/compress-{comp}"
        api = _flagship_build(fed, compress=comp)
        start = _snapshot(api)
        rng, cohorts = start[1].clone(), []
        for _ in range(n):
            pair = keys.split(rng)
            rng = pair[0]
            cohorts.append(api._device_cohort(pair[1]))
        with _cudnn_deterministic():
            api.sample_round = lambda r: cohorts[r]
            host, host_ms = [], []
            try:
                for r in range(n):
                    t0 = time.perf_counter()
                    host.append(api.train_one_round(r)["train_loss"])
                    host_ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                del api.sample_round
            want = [_net_vec(api.net), torch.tensor(host)]
            _restore(api, start)
            dev = api.train_rounds_on_device(n).tolist()
        _bit_equal(tag, f"{n} train_one_round rounds fed the on-device "
                   f"cohorts {[c.tolist() for c in cohorts]} vs "
                   f"train_rounds_on_device({n}) (params, losses)", want,
                   [_net_vec(api.net), torch.tensor(dev)])
        print(f"[{tag}] train_one_round {' / '.join(f'{t:.1f}' for t in host_ms)}"
              f" ms (the first captures; host clock, synced by its loss; "
              f"cuDNN deterministic); losses "
              f"{' '.join(f'{v:.4f}' for v in host)}", flush=True)
        if comp.startswith("q"):
            idx = cohorts[0]
            sub = gather_clients(fed, idx)
            key = keys.split(start[1])[1]
            trained, _ = api.local_train.run_clients(
                api.net, sub.x, sub.y, sub.mask, client_rngs(key, len(idx)))
            transform = api._client_transform()
            qkeys = keys.fold_in(client_rngs(key, len(idx)), 0x7F)
            with torch.no_grad():
                out = vmap(lambda p, s, k: transform(
                    api.net, NetState(p, s), k).params)(
                    trained.params, trained.model_state, qkeys)
            g = tc.tree_to_vector(api.net.params)
            worst, n_levels = 0.0, 0
            for c in range(len(idx)):
                delta = tc.tree_to_vector({k: v[c] for k, v in out.items()}
                                          ) - g
                levels = delta / (delta.abs().max() / 127)
                worst = max(worst, (levels - levels.round()).abs().max()
                            .item())
                n_levels = max(n_levels, int(levels.round().unique().numel()))
            print(f"[{tag}] the {len(idx)} client deltas of a round on "
                  f"their 255-level grids: max |level - round(level)| "
                  f"{worst:.3e} (f32 rounding of g + q·s), at most "
                  f"{n_levels} distinct levels", flush=True)
            check(worst < 0.05 and n_levels <= 255,
                  f"{tag}: deltas off the grid by {worst}")
        del api
        _free()
    tag = "knobs/compress-topk1.0"
    outs = []
    with _cudnn_deterministic():
        for comp in ("none", "topk1.0"):
            api = _flagship_build(fed, compress=comp)
            loss = _eager_round(api, 0)
            outs.append([_net_vec(api.net), loss])
            del api
            _free()
    _bit_equal(tag, "topk1.0 vs plain FedAvg, one eager round from one "
               "start (params, loss)", *outs)
    print(f"[knobs] compression done; {card}", flush=True)


def _knob_adapter(card):
    """FedAdapter at transformer_fed_mfu's width under pow_d (d 16) and
    topk0.05: a warm round, then 2 rounds with the flash launches
    counted."""
    import functools

    from fedml_tpu_torch.algos import FedAdapterAPI, FedConfig
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.local import seq_softmax_ce

    tag = "knobs/FedAdapter-pow_d-topk"
    rng = np.random.RandomState(SEED)
    seqs = rng.randint(1, VOCAB, size=(ADAPTER_CLIENTS * ADAPTER_PER_CLIENT,
                                       SEQ_LEN + 1))
    fed = build_federated_arrays(seqs[:, :SEQ_LEN].astype(np.int32),
                                 seqs[:, 1:].astype(np.int32),
                                 partition_homo(len(seqs), ADAPTER_CLIENTS),
                                 ADAPTER_BATCH, device="cuda")
    cfg = FedConfig(client_num_in_total=ADAPTER_CLIENTS,
                    client_num_per_round=ADAPTER_PER_ROUND, comm_round=100,
                    epochs=1, batch_size=ADAPTER_BATCH, lr=ADAPTER_LR,
                    seed=SEED, adapter_rank=ADAPTER_RANK,
                    client_selection="pow_d", pow_d_candidates=KNOB_POW_D,
                    compress="topk0.05")
    model = create_model(
        "transformer_lm", vocab_size=VOCAB, d_model=D_MODEL,
        n_heads=N_HEADS, n_layers=N_LAYERS, max_len=SEQ_LEN, dtype="bf16",
        attn="flash", adapter_rank=ADAPTER_RANK, adapter_scope="attn",
        device="cuda", generator=torch.Generator().manual_seed(SEED))
    api = FedAdapterAPI(model, fed, None, cfg,
                        loss_fn=functools.partial(seq_softmax_ce, pad_id=0),
                        device="cuda")
    api.train_one_round(0)  # captures the round and the candidates' eval
    _zero_flash_counts()
    t0 = time.perf_counter()
    losses = [api.train_one_round(r)["train_loss"] for r in (1, 2)]
    round_ms = (time.perf_counter() - t0) * 1e3 / 2
    fwd, dq, dkv, copies = _flash_counts()
    steps = ADAPTER_PER_CLIENT // ADAPTER_BATCH
    want_train = 2 * steps * N_LAYERS
    print(f"[{tag}] d_model {D_MODEL}, {N_HEADS} heads, {N_LAYERS} layers, "
          f"bf16, rank {ADAPTER_RANK} on attn, T {SEQ_LEN}, pow_d over "
          f"{KNOB_POW_D} candidates, topk0.05: 2 rounds, {round_ms:.1f} ms a "
          f"round (host clock, the candidates' eval and the fetch of their "
          f"losses included), losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; flash launches fwd "
          f"{fwd}, dq {dq}, dkv {dkv} (expected dq = dkv = {want_train}, fwd "
          f"= {want_train} + the candidates' eval {want_train}), copies "
          f"{copies}; {card}", flush=True)
    check(dq == dkv == want_train and fwd == 2 * want_train and copies == 0,
          f"{tag}: flash launches {fwd}/{dq}/{dkv}, copies {copies}")
    check(all(math.isfinite(v) for v in losses), f"{tag}: {losses}")
    del api, model, fed
    _free()
    return {"flash_fwd": fwd, "flash_dq": dq, "flash_dkv": dkv}


def _levers_data():
    """bench.py:2318-2335: the brighter-blob task, train and test."""
    rng = np.random.RandomState(11)
    n = LEVERS["clients"] * LEVERS["per_client"]
    b = LEVERS["batch"]
    x = rng.rand(n, 28, 28, 1).astype(np.float32) * 0.1
    y = rng.randint(0, 2, n).astype(np.int32)
    for i in range(n):
        r0 = 4 if y[i] == 0 else 18
        x[i, r0:r0 + 6, 8:20, 0] += 1.0
    xt = rng.rand(256, 28, 28, 1).astype(np.float32) * 0.1
    yt = rng.randint(0, 2, 256).astype(np.int32)
    for i in range(256):
        r0 = 4 if yt[i] == 0 else 18
        xt[i, r0:r0 + 6, 8:20, 0] += 1.0
    test = (torch.from_numpy(xt.reshape(-1, b, 28, 28, 1)).cuda(),
            torch.from_numpy(yt.reshape(-1, b)).long().cuda(),
            torch.ones(256 // b, b, device="cuda"))
    return x, y, test


def _timed_sps(api, r0, samples_per_round):
    """KNOB_TIMED synced train_one_round rounds after r0: samples/s by the
    host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(r0, r0 + KNOB_TIMED):
        api.train_one_round(r)
    return KNOB_TIMED * samples_per_round / (time.perf_counter() - t0)


def _knob_layouts(card, fed):
    """(d) the CNN levers, the layout A/B, the padded GroupNorm ResNet and
    the GroupNorm kernels at its padded widths. Returns the GroupNorm
    launches counted."""
    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.data import (build_federated_arrays, gather_clients,
                                      partition_homo)
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg
    from fedml_tpu_torch.models.resnet import CifarResNet
    from fedml_tpu_torch.ops import group_norm as gn
    from fedml_tpu_torch.parallel import layout as tl
    from fedml_tpu_torch.parallel.shard import client_rngs

    # The policies' physical widths.
    jax_pol = tl.LayoutPolicy()
    card_pol = tl.LayoutPolicy(lane=tl.CARD_LANE, sublane=tl.CARD_SUBLANE)
    for name, widths in (("flagship resnet56 (stem 16)", (16, 16, 32, 64)),
                         ("cnn", (32, 64)), ("cnn widths", (120, 120)),
                         ("mis-sized resnet (stem 20)", (20, 20, 40, 80))):
        print(f"[knobs/layout] {name} {widths}: the card's policy (lane "
              f"{card_pol.lane}, sublane {card_pol.sublane}) "
              f"{tuple(tl.pad_width(c, card_pol) for c in widths)}, JAX's "
              f"(lane {jax_pol.lane}) "
              f"{tuple(tl.pad_width(c, jax_pol) for c in widths)} (before "
              f"GroupNorm quanta)", flush=True)
    flagship = tl.compute_layout(create_model(
        "resnet56", device="cuda"), torch.zeros(2, 32, 32, 3))
    check(flagship.is_identity, "the flagship's layout pads")

    # bench.py's cnn_mfu_levers.
    tag = "knobs/cnn_mfu_levers"
    x, y, test = _levers_data()
    lfed = build_federated_arrays(x, y, partition_homo(len(x),
                                                       LEVERS["clients"]),
                                  LEVERS["batch"], device="cuda")
    spr = LEVERS["per_round"] * LEVERS["per_client"]
    arms = {}
    for arm, kw in (("fp32", {}), ("bf16", {"client_step_dtype": "bf16"}),
                    ("im2col", {"compute_layout": "im2col"})):
        cfg = FedConfig(client_num_in_total=LEVERS["clients"],
                        client_num_per_round=LEVERS["per_round"],
                        comm_round=100_000, epochs=1,
                        batch_size=LEVERS["batch"], lr=LEVERS["lr"],
                        frequency_of_the_test=1000, seed=SEED, **kw)
        model = CNNOriginalFedAvg(num_classes=2, generator=torch.Generator()
                                  .manual_seed(SEED)).cuda()
        api = FedAvgAPI(model, lfed, test, cfg, device="cuda")
        for r in range(LEVERS["acc_rounds"]):
            loss = api.train_one_round(r)["train_loss"]
        acc = api.evaluate()["accuracy"]
        sps = _timed_sps(api, LEVERS["acc_rounds"], spr)
        arms[arm] = (sps, acc, loss)
        print(f"[{tag}] {arm}: {sps:.1f} samples/s over {KNOB_TIMED} synced "
              f"rounds, accuracy {acc:.4f} after {LEVERS['acc_rounds']} "
              f"rounds, final train loss {loss:.5f}", flush=True)
        check(math.isfinite(loss), f"{tag}: {arm} loss {loss}")
        del api, model
        _free()
    for arm in ("bf16", "im2col"):
        print(f"[{tag}] {arm} vs fp32: speedup "
              f"{arms[arm][0] / arms['fp32'][0]:.3f}, accuracy delta "
              f"{arms[arm][1] - arms['fp32'][1]:+.4f}, loss delta "
              f"{arms[arm][2] - arms['fp32'][2]:+.5f}; {card}", flush=True)

    # bench.py's layout_fused_round: the layout A/B.
    tag = "knobs/layout_fused_round"
    lb = LAYOUT_BENCH
    rng = np.random.RandomState(3)
    lx = rng.rand(lb["clients"] * lb["per_client"], 28, 28, 1).astype(
        np.float32)
    ly = rng.randint(0, 62, len(lx)).astype(np.int32)
    lfed = build_federated_arrays(lx, ly, partition_homo(len(lx),
                                                         lb["clients"]),
                                  lb["batch"], device="cuda")
    rate = {}
    for arm in ("none", "auto"):
        cfg = FedConfig(client_num_in_total=lb["clients"],
                        client_num_per_round=lb["per_round"],
                        comm_round=100_000, epochs=1, batch_size=lb["batch"],
                        lr=lb["lr"], compute_layout=arm, seed=SEED)
        model = CNNOriginalFedAvg(num_classes=62, widths=lb["widths"],
                                  generator=torch.Generator()
                                  .manual_seed(SEED)).cuda()
        api = FedAvgAPI(model, lfed, None, cfg, device="cuda")
        if arm == "auto":
            check(api._layout is not None
                  and api._layout.physical_model.widths == (128, 128),
                  f"{tag}: the layout's widths")
        api.train_one_round(0)
        rate[arm] = _timed_sps(api, 1, lb["per_round"] * lb["per_client"])
        del api, model
        _free()
    print(f"[{tag}] cnn widths {lb['widths']} -> (128, 128): none "
          f"{rate['none']:.1f}, auto {rate['auto']:.1f} samples/s (ratio "
          f"{rate['auto'] / rate['none']:.3f}; f32, TF32 off); {card}",
          flush=True)

    # The mis-sized GroupNorm ResNet through the kernels at padded widths.
    tag = "knobs/layout-gn"
    cfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                    client_num_per_round=TRAIN_PER_ROUND, comm_round=100,
                    epochs=1, batch_size=TRAIN_BATCH, lr=ROUND_LR, seed=SEED)
    outs, counted = {}, [0, 0]
    for arm in ("none", "auto"):
        model = CifarResNet(layers=MIS_LAYERS, num_classes=10,
                            widths=MIS_WIDTHS, stem_width=MIS_STEM,
                            generator=torch.Generator().manual_seed(SEED)
                            ).cuda()
        n_gn = _norm_count(model)
        api = FedAvgAPI(model, fed, None, dataclasses.replace(
            cfg, compute_layout=arm), device="cuda")
        start = _net_copy(api.net)
        with _cudnn_deterministic():
            api.train_one_round(0)
            _zero_gn_counts()
            loss = api.train_one_round(1)["train_loss"]
            fwd, bwd, red, copies, streamed = _gn_counts()
        steps = fed.steps_per_epoch
        print(f"[{tag}] {arm}: round 1 (replayed) loss {loss:.6f}; "
              f"GroupNorm launches fwd {fwd}, bwd {bwd}, reduce {red} "
              f"(expected {steps * n_gn} each), streamed {streamed}, copies "
              f"{copies}", flush=True)
        check(fwd == bwd == red == steps * n_gn and streamed == copies == 0,
              f"{tag}: {arm} GroupNorm launches {fwd}/{bwd}/{red}")
        counted[0] += fwd
        counted[1] += bwd
        outs[arm] = (_net_vec(api.net), _net_vec(start), loss)
        if arm == "auto":
            lay = api._layout
            phys = lay.physical_model
            widths = (phys.Norm_0.GroupNorm_0.weight.shape[0],
                      *(getattr(phys, f"BottleneckBlock_{i}").Norm_0
                        .GroupNorm_0.weight.shape[0]
                        for i in range(0, 6, 2)))
            groups = (phys.Norm_0.num_groups,
                      *(getattr(phys, f"BottleneckBlock_{i}").Norm_0
                        .num_groups for i in range(0, 6, 2)))
            print(f"[{tag}] the card's policy pads stem/stages "
                  f"{(MIS_STEM, *MIS_WIDTHS)} -> {widths}, GroupNorm groups "
                  f"{groups} (the logical groups' size kept)", flush=True)
            idx = torch.arange(TRAIN_PER_ROUND, device="cuda")
            sub = gather_clients(fed, idx)
            with _cudnn_deterministic():
                pnet, _ = api.local_train.inner.run_clients(
                    lay.pad(api.net), sub.x, sub.y, sub.mask,
                    client_rngs(api.rng, TRAIN_PER_ROUND))
            again = lay.pad(lay.unpad(pnet))
            zero = all(torch.equal(pnet.params[k], again.params[k])
                       for k in pnet.params)
            print(f"[{tag}] the physical client nets after a local epoch of "
                  f"{TRAIN_PER_ROUND} clients: every pad entry exactly 0: "
                  f"{zero}", flush=True)
            check(zero, f"{tag}: a pad entry moved")
        del api, model
        _free()
    (va, sa, la), (vb, sb, lb_) = outs["none"], outs["auto"]
    check(torch.equal(sa, sb), f"{tag}: the two arms start apart")
    dist = (va - vb).abs().max().item()
    scale = va.abs().max().item()
    upd = (va - sa).abs().max().item()
    print(f"[{tag}] auto vs none after 2 f32 rounds at lr {ROUND_LR}: "
          f"max|dparam| {dist:.3e} (params' scale {scale:.3f}, the rounds' "
          f"largest update {upd:.3e}; bound {LAYOUT_F32_TOL:.0e} x scale; "
          f"{'bit-equal' if dist == 0 else 'not bit-equal'}), losses "
          f"{la:.6f} / {lb_:.6f}", flush=True)
    check(dist <= LAYOUT_F32_TOL * scale, f"{tag}: auto is {dist} from none")

    # The GroupNorm kernels at the padded widths: the logical channels
    # against the logical call, the pad channels exactly 0, against the
    # plain twins; the cluster route (CIFAR 32²) and the streamed one.
    tag = "knobs/gn-padded"
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for n, s, c, cp, groups, dtype in (
            (256, 1024, 20, 24, 20, torch.bfloat16),
            (256, 64, 80, 96, 20, torch.bfloat16),
            (256, 1024, 20, 24, 20, torch.float32),
            (2, 65536, 20, 24, 20, torch.float32)):
        x = torch.randn(1, n, s, c, generator=g, device="cuda").to(dtype)
        dy = torch.randn(1, n, s, c, generator=g, device="cuda").to(dtype)
        gam = torch.rand(1, c, generator=g, device="cuda") + 0.5
        bet = torch.randn(1, c, generator=g, device="cuda")
        pad = cp - c
        xp, dyp, gp, bp = (torch.nn.functional.pad(t, (0, pad))
                           for t in (x, dy, gam, bet))
        gpad = cp // (c // groups)
        fs, bs = gn.group_norm_fwd.streamed, gn.group_norm_bwd.streamed
        y = gn.group_norm_fwd(xp, gp, bp, gpad)
        dx, dgam, dbet = gn.group_norm_bwd(xp, dyp, gp, gpad)
        streamed = (gn.group_norm_fwd.streamed - fs,
                    gn.group_norm_bwd.streamed - bs)
        y0 = gn.group_norm_fwd(x, gam, bet, groups)
        dx0, dg0, db0 = gn.group_norm_bwd(x, dy, gam, groups)
        pad_zero = all(not t[..., c:].any() for t in (y, dx, dgam, dbet))
        same = [torch.equal(a[..., :c], b) for a, b in
                ((y, y0), (dx, dx0), (dgam, dg0), (dbet, db0))]
        diff = max((a[..., :c].float() - b.float()).abs().max().item()
                   for a, b in ((y, y0), (dx, dx0)))
        wy = gn.group_norm_fwd_plain(xp.float(), gp, bp, gpad)
        wdx, _, _ = gn.group_norm_bwd_plain(xp.float(), dyp.float(), gp,
                                            gpad)
        tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
        err = max(((a.float() - b) / b.abs().max()).abs().max().item()
                  for a, b in ((y, wy), (dx, wdx)))
        print(f"[{tag}] [{n}, {s}, {c} -> {cp}] {str(dtype)[6:]}, groups "
              f"{groups} -> {gpad}: streamed launches fwd/bwd {streamed}; "
              f"pad channels of y, dx, dgamma, dbeta exactly 0: {pad_zero}; "
              f"logical channels bit-equal to the logical call (y, dx, "
              f"dgamma, dbeta): {same} (max|d| {diff:.3e}); vs the plain "
              f"twin max|d|/max {err:.3e} (bound {tol:.0e})", flush=True)
        check(pad_zero and err <= tol, f"{tag}: padded GroupNorm")
        check((s > 4096) == (streamed[0] > 0) == (streamed[1] > 0),
              f"{tag}: routes {streamed}")
    print(f"[knobs] layouts done; {card}", flush=True)
    return counted


def phase_knobs():
    """FedAvgAPI's knobs and BatchNorm's last refusals (see the
    constants): (a) the A2 tail's six drives, (b) selection, (c)
    compression and FedAdapter under pow_d + topk, (d) layouts and the
    bf16 step. Returns {kernel name: launches counted}."""
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.data.store import FederatedStore

    t_phase = time.perf_counter()
    card = smi_line()
    times = {}
    x, y = _cifar_samples()
    t0 = time.perf_counter()
    _knob_split(card, x, y)
    _knob_zoo_bn(card, x, y)
    _knob_extra_bn(card)
    times["a"] = time.perf_counter() - t0
    # (b)-(d) at the round family's depth (2 local steps; PR 18's cut).
    x, y = _family_samples()
    fed = build_federated_arrays(x, y, partition_homo(len(x), TRAIN_CLIENTS),
                                 TRAIN_BATCH, device="cuda")
    store = FederatedStore(x, y, partition_homo(len(x), TRAIN_CLIENTS),
                           TRAIN_BATCH, device="cuda")
    t0 = time.perf_counter()
    gn_b = _knob_selection(card, fed, store)
    times["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _knob_compress(card, fed)
    launches = _knob_adapter(card)
    times["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gn_d = _knob_layouts(card, fed)
    times["d"] = time.perf_counter() - t0
    launches["group_norm_fwd"] = gn_b[0] + gn_d[0]
    launches["group_norm_bwd"] = gn_b[1] + gn_d[1]
    secs = json.dumps({k: round(v, 1) for k, v in times.items()})
    print(f"[knobs] parts' seconds {secs}; phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return launches


# DP-SGD, remat and the experiment CLI (the dp and cli phases): DP at the
# JAX package's CLI example (clip 1.0, noise multiplier 1.1).
DP_CLIP, DP_NOISE = 1.0, 1.1
# A noiseless DP step (no clip, no noise) is the plain step but for
# rounding, so the mean of one step's per-example gradients is held to the
# batch gradient at the same params: in bf16 each per-example weight
# gradient is rounded to bf16 before the f32 sum, where the batch
# gradient is rounded once (a resnet20 at widths 8/16/32 on the CPU read
# up to 7.6e-3 a leaf). Whole rounds cannot be held so: at lr 1e-3 an
# update is below a bf16 ulp of most weights, and rounding flips in the
# bf16 weights then decide the next step (0.15 of the update after 2 such
# steps on the CPU, 0.92 after a round on the card).
DP_NOISELESS_TOL = 2e-2
# Each clipped example's norm: at most clip, up to the f32 rounding of
# the factor clip / ||g|| and of the norm itself.
DP_NORM_SLACK = 1e-3
# The documented north-star command (fedml_tpu_torch/exp/__init__.py)
# with --epochs 5 -> 1 and --comm_round 100 -> 2 (the cuts), on CIFAR-10
# python-pickle batches of seeded random uint8 images at the real size.
CLI_TRAIN, CLI_TEST = 50000, 10000
CLI_NORTH_STAR = ["--model", "resnet56", "--dataset", "cifar10",
                  "--partition_method", "hetero", "--partition_alpha", "0.5",
                  "--client_num_in_total", "10",
                  "--client_num_per_round", "10", "--batch_size", "64",
                  "--lr", "0.03", "--epochs", "1", "--comm_round", "2"]
CLI_CUTS = {"--epochs": (5, 1), "--comm_round": (100, 2)}
# The cross-silo MobileNet row of BASELINE.md:30-42 through the same CLI
# and files, run beside the north-star command: 20 epochs -> 1 and 100
# rounds -> 1 (the cuts).
CLI_MOBILENET = ["--model", "mobilenet", "--dataset", "cifar10",
                 "--partition_method", "hetero", "--partition_alpha", "0.5",
                 "--client_num_in_total", "10",
                 "--client_num_per_round", "10", "--batch_size", "64",
                 "--lr", "0.001", "--epochs", "1", "--comm_round", "1"]
CLI_MOBILENET_CUTS = {"--epochs": (20, 1), "--comm_round": (100, 1)}
# The in-process runs: exp.run's DP + remat FedAvg over the same files at
# 1,000 clients of 50 (2 steps of batch 32, 2 a round, 1 round), and the
# centralized baseline under DP on 1,280 + 256 images (20 steps of 64).
CLI_DP_RUN = ["--model", "resnet56", "--dataset", "cifar10",
              "--partition_method", "homo", "--client_num_in_total", "1000",
              "--client_num_per_round", "2", "--batch_size", "32",
              "--lr", "0.03", "--epochs", "1", "--comm_round", "1",
              "--dp_clip", str(DP_CLIP), "--dp_noise_multiplier",
              str(DP_NOISE), "--remat"]
CLI_CENTRAL_TRAIN, CLI_CENTRAL_TEST = 1280, 256
CLI_CENTRAL = ["--model", "resnet56", "--dataset", "cifar10",
               "--batch_size", "64", "--lr", "0.03", "--epochs", "1",
               "--comm_round", "1", "--dp_clip", str(DP_CLIP),
               "--dp_noise_multiplier", str(DP_NOISE)]
# Runs the north-star module as ``python -m`` does and, at exit, writes
# the process's GroupNorm launch counts to stderr (stdout's last line
# stays the run's JSON).
CLI_WRAPPER = (
    "import atexit, json, runpy, sys\n"
    "from fedml_tpu_torch.ops import group_norm as gn\n"
    "atexit.register(lambda: print('GN_COUNTS ' + json.dumps(["
    "gn.group_norm_fwd.launches, gn.group_norm_bwd.launches, "
    "gn.group_norm_bwd.reduce_launches]), file=sys.stderr, flush=True))\n"
    "runpy.run_module('fedml_tpu_torch.exp.main_fedavg', "
    "run_name='__main__', alter_sys=True)\n")


def _write_cifar(root, n_train, n_test, seed):
    """CIFAR-10's python-pickle batches (data_batch_1..5, test_batch) of
    seeded random uint8 images; returns the bytes written."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    sizes = [n_train // 5] * 5 + [n_test]
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    total = 0
    for name, n in zip(names, sizes):
        data = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump({b"data": data,
                         b"labels": rng.integers(0, 10, n).tolist()}, f)
        total += data.nbytes
    return total


def _start_north_star(tag):
    """(a) and the start of (b) and (e): the CIFAR-10 files in a temporary
    directory, the north-star command and the cross-silo MobileNet row as
    subprocesses. Returns the run's state (directory, files, processes,
    start time)."""
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cifar_")
    data_dir = os.path.join(tmp, "cifar-10-batches-py")
    nbytes = _write_cifar(data_dir, CLI_TRAIN, CLI_TEST, SEED)
    small_dir = os.path.join(tmp, "cifar-small")
    _write_cifar(small_dir, CLI_CENTRAL_TRAIN, CLI_CENTRAL_TEST, SEED + 1)
    print(f"[{tag}] (a) CIFAR-10 pickles: {CLI_TRAIN} + {CLI_TEST} seeded "
          f"uint8 images ({nbytes / 2**20:.1f} MiB) in "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms", flush=True)
    run = {"tmp": tmp, "data_dir": data_dir, "small_dir": small_dir,
           "procs": {}}
    for label, argv, cut in (("(b)", CLI_NORTH_STAR, CLI_CUTS),
                             ("(e)", CLI_MOBILENET, CLI_MOBILENET_CUTS)):
        argv = argv + ["--data_dir", data_dir]
        cuts = ", ".join(f"{k} {a} -> {b}" for k, (a, b) in cut.items())
        print(f"[{tag}] {label} python -m fedml_tpu_torch.exp.main_fedavg "
              f"{' '.join(argv)} (cut from the documented command: {cuts}); "
              "it runs beside the dp phase's captures and holds and the cli "
              "phase's in-process runs, and the timed replays wait for it",
              flush=True)
        run["procs"][label] = subprocess.Popen(
            [sys.executable, "-c", CLI_WRAPPER] + argv,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    run["t0"] = time.perf_counter()
    return run


def _finish_north_star(run, tag):
    """(b)'s and (e)'s end: waits for each subprocess, parses its last line
    (the last round's metrics) and its GroupNorm counts. Returns (fwd,
    bwd) summed over both."""
    total_fwd = total_bwd = 0
    while run["procs"]:
        label, proc = next(iter(run["procs"].items()))
        out, err = proc.communicate(timeout=900)
        del run["procs"][label]
        sub_s = time.perf_counter() - run["t0"]
        lines = out.strip().splitlines()
        print(f"[{tag}] {label} exit {proc.returncode} after {sub_s:.1f} s; "
              "its last lines:", flush=True)
        for line in lines[-3:]:
            print(f"[{tag}]   {line[:400]}", flush=True)
        if proc.returncode != 0:
            print(err[-4000:], flush=True)
        check(proc.returncode == 0 and lines,
              f"{tag}: the command {label} exited {proc.returncode}")
        last = json.loads(lines[-1])
        counts = [json.loads(line.split(" ", 1)[1])
                  for line in err.splitlines()
                  if line.startswith("GN_COUNTS ")]
        check(len(counts) == 1, f"{tag}: no GroupNorm counts from {label}")
        fwd, bwd, red = counts[0]
        print(f"[{tag}] {label} train_loss {last['train_loss']:.4f}, test "
              f"loss {last.get('loss')}, accuracy {last.get('accuracy')}, "
              f"round {last.get('time/round_s')} s; GroupNorm launches fwd "
              f"{fwd}, bwd {bwd}, reduce {red}", flush=True)
        check(math.isfinite(last["train_loss"]),
              f"{tag}: {label} train_loss {last['train_loss']}")
        check(fwd > 0 and bwd > 0, f"{tag}: the command {label} launched no "
              "GroupNorm kernel")
        total_fwd, total_bwd = total_fwd + fwd, total_bwd + bwd
    return total_fwd, total_bwd


def _stop_north_star(run):
    import shutil

    for proc in run.pop("procs", {}).values():
        proc.kill()
        proc.communicate()
    shutil.rmtree(run["tmp"], ignore_errors=True)


def _rel_tree(a, b):
    """|a - b| / |b| over every leaf of two trees."""
    from fedml_tpu_torch.core.tree import tree_leaves

    num = sum(float(((x.float() - y.float()) ** 2).sum())
              for x, y in zip(tree_leaves(a), tree_leaves(b)))
    den = sum(float((y.float() ** 2).sum()) for y in tree_leaves(b))
    return math.sqrt(num / max(den, 1e-30))


def _dp_step_holds(api, tag, what, clip=True):
    """One local step of the round-0 cohort at the api's params, the
    clients under ``vmap`` as the round runs them: each example's
    gradient (``dp_per_example``, through the kernels at their
    per-example shapes), then (1) each clipped norm at most clip x (1 +
    DP_NORM_SLACK) and (2) their noiseless mean against the plain batch
    gradient (``_grad`` of a LocalTrain without DP) within
    DP_NOISELESS_TOL. These launches hold the path, and are not counted
    in the kernels line."""
    from torch.func import vmap

    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.tree import tree_leaves, tree_map
    from fedml_tpu_torch.trainer.local import make_local_train_fn

    lt, net, fed = api.local_train, api.net, api.train_fed
    plain = make_local_train_fn(lt.apply_fn, lt.optimizer, 1, lt.loss_fn)
    idx = torch.as_tensor(api.sample_round(0), device=api.device)
    xb, yb, mb = fed.x[idx, 0], fed.y[idx, 0], fed.mask[idx, 0]
    rngs = keys.fold_in(keys.key(SEED, api.device),
                        torch.arange(len(idx), device=api.device))

    def one(x, y, m, rng):
        per, _ = lt.dp_per_example(net.params, net.model_state, x, y, rng)
        norm = torch.sqrt(sum(g.flatten(1).float().square().sum(1)
                              for g in tree_leaves(per)))
        mean = tree_map(lambda g: torch.tensordot(m, g, dims=1)
                        / torch.clamp(m.sum(), min=1.0), per)
        batch, _, _ = plain._grad(net.params, net.model_state, x, y, m, rng)
        return lt.dp_clip_scale(per, m) * norm, norm, mean, batch

    gn0, fl0 = _gn_counts()[:2], _flash_counts()[:3]
    clipped, raw, mean, batch = vmap(one)(xb, yb, mb, rngs)
    launches = tuple(b - a for a, b in zip(gn0 + fl0, _gn_counts()[:2]
                                           + _flash_counts()[:3]))
    d = _rel_tree(mean, batch)
    top = clipped.max().item()
    print(f"[{tag}] {what}: one step's per-example gradients, "
          f"{len(idx)} clients x {xb.shape[1]} examples under vmap: raw "
          f"norms {raw.min().item():.3f}..{raw.max().item():.3f}, clipped "
          f"max {top:.6f} (clip {lt.dp_clip}); their noiseless mean vs the "
          f"batch gradient |d| / |g| {d:.3e} (tol {DP_NOISELESS_TOL}); "
          f"launches GroupNorm fwd/bwd {launches[:2]}, flash fwd/dq/dkv "
          f"{launches[2:]}", flush=True)
    if clip:
        check(top <= lt.dp_clip * (1 + DP_NORM_SLACK),
              f"{tag}: a clipped example norm {top} exceeds {lt.dp_clip}")
    check(d <= DP_NOISELESS_TOL, f"{tag}: {what}: the noiseless DP step is "
          f"{d} from the plain step")


def _dp_gn_rows_hold(tag):
    """The GroupNorm kernels against their plain twins at ResNet-56's
    eight shapes as the DP step hands them over: R = 256 single-sample
    rows (8 clients x 32 examples, each row its client's gamma/beta),
    bf16."""
    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(SEED + 18)
    worst = 0.0
    for (n, s, c), groups, _ in GN_STEP:
        x, dy, gamma, beta = _gn_inputs((n, s, c), n, torch.bfloat16, g)
        y = gn.group_norm_fwd(x, gamma, beta, groups)
        dx, dgamma, dbeta = gn.group_norm_bwd(x, dy, gamma, groups)
        torch.cuda.synchronize()
        want_y = gn.group_norm_fwd_plain(x.float(), gamma, beta, groups)
        want_dx, want_dg, want_db = gn.group_norm_bwd_plain(
            x.float(), dy.float(), gamma, groups)
        ey, ok_y = _gn_err(y, want_y, torch.bfloat16)
        edx, ok_dx = _gn_err(dx, want_dx, torch.bfloat16)
        mu, rstd = gn._stats(x.float(), groups, gn.EPS)
        chain = s + 64
        lim_g = chain * 2.0 ** -24 * (dy.float() * (x.float() - mu) * rstd
                                      ).abs().sum(dim=(1, 2)) + 1e-7
        lim_b = chain * 2.0 ** -24 * dy.float().abs().sum(dim=(1, 2)) + 1e-7
        ok_p = bool(((dgamma - want_dg).abs() <= lim_g).all()
                    and ((dbeta - want_db).abs() <= lim_b).all())
        worst = max(worst, ey, edx)
        check(ok_y and ok_dx and ok_p, f"{tag}: group_norm kernels disagree "
              f"with plain at [{n}x1, {s}, {c}] R{n}")
    print(f"[{tag}] group_norm fwd/bwd vs plain at the 8 ResNet-56 shapes "
          f"with R = 256 single-sample rows (bf16): max|d| {worst:.3e} "
          f"within 2^-8 rel + 1e-5 of scale, dgamma/dbeta within the "
          f"sum-order bound", flush=True)


def _adapter_build(**kw):
    """A FedAdapterAPI at the adapter phase's configuration, with ``kw``
    replacing config fields."""
    import functools

    from fedml_tpu_torch.algos import FedAdapterAPI
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.local import seq_softmax_ce

    fed, cfg, _ = _adapter_setup()
    model = create_model(
        "transformer_lm", vocab_size=VOCAB, d_model=D_MODEL,
        n_heads=N_HEADS, n_layers=N_LAYERS, max_len=SEQ_LEN, dtype="bf16",
        attn="flash", adapter_rank=ADAPTER_RANK, adapter_scope="attn",
        device="cuda", generator=torch.Generator().manual_seed(SEED))
    return FedAdapterAPI(model, fed, None, dataclasses.replace(cfg, **kw),
                         loss_fn=functools.partial(seq_softmax_ce, pad_id=0),
                         device="cuda")


def phase_dp():
    """DP-SGD and remat at full width, with the north-star CLI command
    started as a subprocess first (the cli phase waits for it): (a) the
    flagship under DP-SGD, (b) under remat, (c) FedAdapter under DP-SGD,
    their captures and holds. The timed replays run in the cli phase
    after the subprocess ended. Returns the state the cli phase takes."""
    state = {"card": smi_line(), "launches": collections.Counter()}
    state["cli"] = _start_north_star("cli")
    try:
        _dp_captures(state)
    except BaseException:
        _stop_north_star(state["cli"])
        raise
    return state


def _dp_captures(state):
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo

    tag = "dp"
    x, y = _cifar_samples()
    fed = build_federated_arrays(x, y, partition_homo(len(x), TRAIN_CLIENTS),
                                 TRAIN_BATCH, device="cuda")
    x, y = _family_samples()
    family = build_federated_arrays(
        x, y, partition_homo(len(x), TRAIN_CLIENTS), TRAIN_BATCH,
        device="cuda")
    del x, y
    # (a) DP-SGD on the flagship at the round family's depth
    # (FAMILY_PER_CLIENT samples a client, 2 local steps, cut from 8 to
    # pay for the fed phase: the per-example eager round and its capture
    # are host dispatch per step): pin (a) under deterministic cuDNN (its
    # peak over warm-up and capture printed), the per-step holds.
    api = _flagship_build(family, dp_clip=DP_CLIP,
                          dp_noise_multiplier=DP_NOISE)
    with _cudnn_deterministic():
        _hold_captured_round(api, 0, tag, runs=1)
    state["dp_api"] = api
    _dp_step_holds(api, tag, "flagship DP-SGD")
    _dp_gn_rows_hold(tag)
    # (b) remat: the plain and the remat api captured from one start under
    # deterministic cuDNN; their second rounds replay in the cli phase.
    with _cudnn_deterministic():
        for name, kw in (("plain", {}), ("remat", {"remat": True})):
            api = _flagship_build(fed, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            api.train_one_round(0)
            peak = torch.cuda.max_memory_allocated()
            print(f"[remat] {name}: round 0 captured in "
                  f"{api._graphs['fused'].capture_ms:.1f} ms; peak memory "
                  f"over warm-up + capture {peak / 2**30:.2f} GiB",
                  flush=True)
            state[name + "_api"] = api
            state[name + "_peak"] = peak
    # (c) DP-SGD on FedAdapter: round 0 captured, the per-step holds (the
    # flash kernels under the per-example vmap).
    api = _adapter_build(dp_clip=DP_CLIP, dp_noise_multiplier=DP_NOISE)
    t0 = time.perf_counter()
    api.train_one_round(0)
    print(f"[{tag}] FedAdapter DP-SGD (clip {DP_CLIP}, z {DP_NOISE}): round "
          f"0 (capture) {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    _dp_step_holds(api, tag, "FedAdapter DP-SGD")
    state["adapter_api"] = api


def _dp_timed(state):
    """The dp phase's timed replays, after the north-star subprocess
    ended: the DP flagship round (58 launches of each GroupNorm kernel a
    local step), remat's and the plain round's second rounds (bit-equal;
    116 forwards a step against 58), the FedAdapter DP round (16 launches
    of each flash kernel)."""
    card, launches = state["card"], state["launches"]
    steps = TRAIN_PER_CLIENT // TRAIN_BATCH
    api = state.pop("dp_api")
    fwd, bwd, med, _, copies = _replayed_rounds(
        api, [1], "dp", FAMILY_PER_CLIENT // TRAIN_BATCH,
        TRAIN_PER_ROUND * FAMILY_PER_CLIENT)
    launches.update(group_norm_fwd=fwd, group_norm_bwd=bwd)
    print(f"[dp] DP-SGD flagship (clip {DP_CLIP}, z {DP_NOISE}): replayed "
          f"round {med:.1f} ms, GroupNorm operand copies {copies} a round; "
          f"{card}", flush=True)
    del api
    out = {}
    for name in ("plain", "remat"):
        api = state.pop(name + "_api")
        _zero_gn_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = api.train_one_round(1)["train_loss"]
        ms = (time.perf_counter() - t0) * 1e3
        fwd, bwd, red, copies, streamed = _gn_counts()
        peak = state.pop(name + "_peak")
        out[name] = (_net_vec(api.net).clone(), ms, fwd, bwd, loss)
        print(f"[remat] {name}: replayed round {ms:.1f} ms, loss "
              f"{loss:.4f}; GroupNorm launches fwd {fwd} ({fwd // steps} a "
              f"step), bwd {bwd}, reduce {red}, streamed {streamed}; peak "
              f"memory over warm-up + capture {peak / 2**30:.2f} GiB; "
              f"{card}", flush=True)
        check(streamed == 0, f"remat: {streamed} forwards streamed")
        launches.update(group_norm_fwd=fwd, group_norm_bwd=bwd)
        del api
    dist = (out["plain"][0] - out["remat"][0]).abs().max().item()
    print(f"[remat] remat vs plain after 2 rounds from one start: max|d| "
          f"{dist:.3e} ({'bit-equal' if dist == 0 else 'NOT bit-equal'}); "
          f"round {out['remat'][1]:.1f} / {out['plain'][1]:.1f} ms = "
          f"{out['remat'][1] / out['plain'][1]:.3f}x; GroupNorm forwards a "
          f"step {out['remat'][2] // steps} / {out['plain'][2] // steps}",
          flush=True)
    check(dist == 0 and out["remat"][4] == out["plain"][4],
          f"remat: {dist} from the plain round")
    check(out["remat"][2] == 2 * out["plain"][2] == 2 * steps * RESNET56_GN
          and out["remat"][3] == out["plain"][3] == steps * RESNET56_GN,
          f"remat: GroupNorm launches remat {out['remat'][2:4]}, plain "
          f"{out['plain'][2:4]}")
    api = state.pop("adapter_api")
    _zero_flash_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = api.train_one_round(1)["train_loss"]
    ms = (time.perf_counter() - t0) * 1e3
    fwd, dq, dkv, copies = _flash_counts()
    want = ADAPTER_PER_CLIENT // ADAPTER_BATCH * N_LAYERS
    print(f"[dp] FedAdapter DP-SGD: replayed round {ms:.1f} ms, loss "
          f"{loss:.4f}; flash launches fwd {fwd}, dq {dq}, dkv {dkv} "
          f"(expected {want} each), copies {copies}; {card}", flush=True)
    check(math.isfinite(loss), f"dp: non-finite adapter loss {loss}")
    check(fwd == dq == dkv == want and copies == 0,
          f"dp: flash launches {fwd}, {dq}, {dkv}, copies {copies}")
    launches.update(flash_fwd=fwd, flash_dq=dq, flash_dkv=dkv)
    del api
    _free()


def phase_cli(state):
    """The experiment CLI on the card: (c) exp.run's DP + remat FedAvg and
    the DP centralized baseline in process, through main(argv), while (b)
    the north-star subprocess (started by the dp phase) runs; then (b)'s
    result and (d) the GroupNorm launches of (b) and (c); then the dp
    phase's timed replays. Returns {kernel name: launches of both
    phases}."""
    from fedml_tpu_torch.exp import main_centralized

    # ``fedml_tpu_torch.exp.run`` the attribute is the function run();
    # the module is imported by name.
    exp_run = importlib.import_module("fedml_tpu_torch.exp.run")

    tag, run, launches = "cli", state["cli"], state["launches"]
    try:
        _zero_gn_counts()
        t0 = time.perf_counter()
        hist = exp_run.main(CLI_DP_RUN + ["--data_dir", run["data_dir"]],
                            algorithm="FedAvg")
        fwd, bwd, *_ = _gn_counts()
        print(f"[{tag}] (c) exp.run --algorithm FedAvg "
              f"{' '.join(CLI_DP_RUN)}: {time.perf_counter() - t0:.1f} s, "
              f"last round {hist[-1]}; GroupNorm launches fwd {fwd}, bwd "
              f"{bwd}", flush=True)
        check(math.isfinite(hist[-1]["train_loss"]),
              f"{tag}: exp.run DP loss {hist[-1]}")
        check(fwd > 0 and bwd > 0, f"{tag}: exp.run launched no GroupNorm "
              "kernel")
        launches.update(group_norm_fwd=fwd, group_norm_bwd=bwd)
        _zero_gn_counts()
        t0 = time.perf_counter()
        _, chist = main_centralized.main(CLI_CENTRAL
                                         + ["--data_dir", run["small_dir"]])
        fwd, bwd, *_ = _gn_counts()
        print(f"[{tag}] (c) main_centralized {' '.join(CLI_CENTRAL)} on "
              f"{CLI_CENTRAL_TRAIN} + {CLI_CENTRAL_TEST} images: "
              f"{time.perf_counter() - t0:.1f} s, {chist[-1]}; GroupNorm "
              f"launches fwd {fwd}, bwd {bwd}", flush=True)
        check(math.isfinite(chist[-1]["train_loss"]),
              f"{tag}: centralized DP loss {chist[-1]}")
        check(fwd > 0 and bwd > 0, f"{tag}: the centralized run launched no "
              "GroupNorm kernel")
        launches.update(group_norm_fwd=fwd, group_norm_bwd=bwd)
        fwd, bwd = _finish_north_star(run, tag)
        launches.update(group_norm_fwd=fwd, group_norm_bwd=bwd)
    finally:
        _stop_north_star(run)
    _dp_timed(state)
    return dict(launches)


# The federation plane (the fed phase): the flagship's resnet56 (bf16
# compute, GroupNorm kernels) at the primary config through
# FedML_FedAvg_distributed on the loopback transport, every message
# round-tripped through the tensor wire. Each arm is (wire codec, ingest
# workers); the fold check runs the pool at 1 and 4 workers on one
# round's real uploads.
FED_ROUNDS, FED_EVAL = 3, 1024
FED_ARMS = (("none", 0), ("none", 4), ("bf16", 0), ("topk0.01+int8", 4))
FED_STEP_REPS = 5
# (a)'s first arm once more after (c) has ended, alone on the card, over
# its captured silo step: two steady rounds.
FED_ROUNDS_ALONE = 2
# (b) the control plane on the lr model: 6 clients of 64 8x8x3 samples,
# 3 a round; a silo cut off by a two-way ChaosSpec partition, and a
# server crash after round 2 resumed from its checkpoint.
FED_SMALL = dict(client_num_in_total=6, client_num_per_round=3, epochs=1,
                 batch_size=16, lr=0.3, frequency_of_the_test=1, seed=SEED)
# (c) the cross-silo CLI as 3 processes over TCP on the CIFAR-10-sized
# pickles (50,000 + 10,000 images): 2 silos of 128 clients (~390 samples,
# 2 steps of batch 256; the server's eager eval of the 10,000 test images
# takes 40 batches: batch 128's 79 and its silos' 4-step captures held
# the phase past 60 s on a slow host), 1 round.
FED_CLI = ["--size", "3", "--model", "resnet56", "--dataset", "cifar10",
           "--client_num_in_total", "128", "--batch_size", "256", "--lr",
           "0.03", "--epochs", "1", "--comm_round", "1",
           "--frequency_of_the_test", "1"]
# (c)'s ranks must all have exited this long after their start (they take
# ~50 s); a rank that exits with an error ends the wait at once.
FED_CLI_DEADLINE_S = 240.0


class _RoundClock:
    """A metrics sink for the server manager: the host time of each round
    commit (its ``ctrl/`` row)."""

    def __init__(self):
        self.t = [time.perf_counter()]

    def log(self, row, step=None, prefix=None):
        self.t.append(time.perf_counter())


def _fed_cli_start(tag):
    """(c)'s start: the CIFAR-10 pickles and the three ranks of
    ``python -m fedml_tpu_torch.exp.main_cross_silo`` as subprocesses on
    the card. Returns the run's state."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fed_")
    data_dir = os.path.join(tmp, "cifar-10-batches-py")
    _write_cifar(data_dir, CLI_TRAIN, CLI_TEST, SEED)
    port_base = _free_port_base(3)
    argv = FED_CLI + ["--data_dir", data_dir, "--port_base", str(port_base)]
    print(f"[{tag}] (c) python -m fedml_tpu_torch.exp.main_cross_silo "
          f"{' '.join(FED_CLI)} --rank 0|1|2 over TCP (ports {port_base}-"
          f"{port_base + 2}) on {CLI_TRAIN} + {CLI_TEST} seeded images; it "
          "runs beside (a) and (b)", flush=True)
    # Each rank writes to files: the wait below polls, so no pipe fills.
    files = [(os.path.join(tmp, f"rank{r}.out"),
              os.path.join(tmp, f"rank{r}.err")) for r in range(3)]
    procs = []
    for r, (out, err) in enumerate(files):
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "fedml_tpu_torch.exp.main_cross_silo",
                 "--rank", str(r)] + argv, stdout=fo, stderr=fe,
                cwd=os.path.dirname(os.path.abspath(__file__))))
    return {"tmp": tmp, "procs": procs, "files": files,
            "t0": time.perf_counter()}


def _free_port_base(n):
    """A base port below Linux's ephemeral range with the ``n`` ports from
    it free to bind (as msgnet binds: any address, SO_REUSEADDR)."""
    import socket

    for i in range(3000):
        base = 20000 + ((os.getpid() + i) % 3000) * 4
        socks = []
        try:
            for r in range(n):
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                socks.append(sock)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                sock.bind(("", base + r))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise SmokeFailure(f"no {n} free ports from 20000 to 32000")


def _fed_cli_finish(run, tag):
    """(c)'s end: each rank's exit and last line; the server's accuracy
    and health, each silo's GroupNorm launches. The wait is bounded by
    FED_CLI_DEADLINE_S and ends at the first rank that fails, with every
    rank's standard error printed."""
    procs, ended = run["procs"], [None] * len(run["procs"])
    while True:
        now = time.perf_counter() - run["t0"]
        for r, proc in enumerate(procs):
            if ended[r] is None and proc.poll() is not None:
                ended[r] = now
        failed = [r for r, p in enumerate(procs)
                  if p.returncode not in (None, 0)]
        if failed or now > FED_CLI_DEADLINE_S:
            _fed_stop_procs(run)
            for r, (_, err) in enumerate(run["files"]):
                with open(err) as f:
                    print(f"[{tag}] (c) rank {r} (exit "
                          f"{procs[r].returncode}) stderr:\n"
                          f"{f.read()[-4000:]}", file=sys.stderr, flush=True)
            check(False, f"{tag}: cross-silo ranks {failed} failed" if failed
                  else f"{tag}: cross-silo ranks still running after "
                  f"{FED_CLI_DEADLINE_S:.0f} s (ended {ended})")
        if all(t is not None for t in ended):
            break
        time.sleep(0.2)
    outs = []
    for proc, (out, err) in zip(procs, run["files"]):
        with open(out) as fo, open(err) as fe:
            outs.append((proc.returncode, fo.read(), fe.read()))
    print(f"[{tag}] (c) ranks 0, 1, 2 collected after "
          f"{', '.join(f'{t:.1f}' for t in ended)} s", flush=True)
    for r, (rc, out, err) in enumerate(outs):
        for line in err.splitlines():
            if line.startswith("[cross-silo rank") and " in " in line:
                print(f"[{tag}] (c)   {line}", flush=True)
        if rc != 0 or not out.strip():
            print(err[-4000:], flush=True)
        check(rc == 0 and out.strip(), f"{tag}: cross-silo rank {r} exited "
              f"{rc}")
        last = json.loads(out.strip().splitlines()[-1])
        check(last.get("rank") == r, f"{tag}: rank {r}'s line {last}")
        if r == 0:
            print(f"[{tag}] (c) server: accuracy {last.get('accuracy')}, "
                  f"loss {last.get('loss')}, members {last.get('members')}, "
                  f"evictions {last.get('evictions')}, bytes_tx "
                  f"{last.get('bytes_tx')}, bytes_rx {last.get('bytes_rx')}; "
                  f"ingest {json.dumps(last.get('ingest'))[:300]}",
                  flush=True)
            check(math.isfinite(last.get("accuracy", float("nan")))
                  and math.isfinite(last.get("loss", float("nan")))
                  and last.get("members") == 2,
                  f"{tag}: cross-silo server line {last}")
            continue
        n = last.get("launches", {})
        fwd, bwd = (n.get("group_norm_fwd.launches", 0),
                    n.get("group_norm_bwd.launches", 0))
        print(f"[{tag}] (c) silo {r}: GroupNorm launches fwd {fwd}, bwd "
              f"{bwd}, reduce {n.get('group_norm_bwd.reduce_launches')}",
              flush=True)
        check(fwd > 0 and bwd > 0, f"{tag}: silo {r} launched no GroupNorm "
              "kernel")


def _fed_stop_procs(run):
    for proc in run.get("procs", []):
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _fed_stop_cli(run):
    import shutil

    _fed_stop_procs(run)
    shutil.rmtree(run["tmp"], ignore_errors=True)


def _fed_fold_check(tag, agg, fed, cfg):
    """One round's real uploads (the captured silo step from the arm's
    final net, the 8 clients of round FED_ROUNDS) folded three ways: the
    streaming f32 mean on the card, and the int64 pool at 1 and at 4
    workers (in another arrival order). The pools must agree bit for bit
    and sit within 1e-6 (relative) of the f32 mean."""
    from fedml_tpu_torch.algos.fedavg_distributed import FedAVGAggregator
    from fedml_tpu_torch.comm import pytree
    from fedml_tpu_torch.comm.ingest import IngestPool
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.core.tree import sorted_leaves

    start = pytree.to_device(pytree.host_tree(agg.net), "cuda")
    counts = fed.counts.cpu().numpy()
    clients = sample_clients(FED_ROUNDS, TRAIN_CLIENTS, TRAIN_PER_ROUND)
    uploads = []
    for c in clients:
        rng = keys.fold_in(keys.fold_in(keys.key(SEED, "cuda"), FED_ROUNDS),
                           int(c))
        net, _ = agg.local_train(start, fed.x[c], fed.y[c], fed.mask[c], rng)
        uploads.append((pytree.host_tree(net), float(counts[c])))
    stream = FedAVGAggregator(start, len(uploads), cfg, device="cuda")
    for i, (up, w) in enumerate(uploads):
        stream.add_local_trained_result(i, up, w)
    want = stream.aggregate_from(range(len(uploads)))
    pooled = []
    for workers, order in ((1, range(len(uploads))),
                           (4, reversed(range(len(uploads))))):
        pool = IngestPool(workers)
        for i in order:
            up, w = uploads[i]
            pool.submit(lambda up=up, w=w: (
                [pytree.np_leaf(l) for l in sorted_leaves(up)], w))
        check(not pool.drain(), f"{tag}: a pooled fold failed")
        fold = FedAVGAggregator(start, len(uploads), cfg, device="cuda")
        pooled.append(fold.aggregate_pooled(range(len(uploads)), pool))
        pool.close()
    same = all(torch.equal(a, b) for a, b in zip(
        sorted_leaves(pooled[0]), sorted_leaves(pooled[1])))
    num = max((a.float() - b.float()).abs().max().item() for a, b in zip(
        sorted_leaves(pooled[1]), sorted_leaves(want)))
    den = max(b.float().abs().max().item() for b in sorted_leaves(want))
    print(f"[{tag}] (a) fold of round {FED_ROUNDS}'s {len(uploads)} uploads: "
          f"pool 1 worker vs 4 workers (reversed arrivals) "
          f"{'bit-equal' if same else 'NOT bit-equal'}; pooled vs streaming "
          f"f32 mean max|d| {num:.3e} over max|mean| {den:.3e} = "
          f"{num / den:.3e}", flush=True)
    check(same, f"{tag}: the pool at 1 and 4 workers differ")
    check(num <= 1e-6 * den, f"{tag}: pooled mean {num / den:.3e} from the "
          "streaming f32 mean")


def _fed_silo_step_ms(agg, fed, eager):
    """The captured silo step replayed (FED_STEP_REPS synced calls after
    a warm one) and, with ``eager``, the same step eager (one synced
    call: ~1.2 s of host dispatch), ms a call, from the arm's final
    net."""
    from fedml_tpu_torch.comm import pytree
    from fedml_tpu_torch.core import keys

    lt = agg.local_train
    start = pytree.to_device(pytree.host_tree(agg.net), "cuda")
    rng = keys.key(SEED, "cuda")

    def timed(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(start, fed.x[0], fed.y[0], fed.mask[0], rng)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    timed(lt, 1)
    return (timed(lt, FED_STEP_REPS),
            timed(lt.step, 1) if eager else float("nan"))


def _fed_data():
    """(a)'s clients (the train phase's 128 x 256 CIFAR-shaped samples)
    and its eval batches, on the card."""
    from fedml_tpu_torch.data import (batch_global, build_federated_arrays,
                                      partition_homo)

    x, y = _cifar_samples()
    fed = build_federated_arrays(x, y, partition_homo(len(x), TRAIN_CLIENTS),
                                 TRAIN_BATCH, device="cuda")
    return fed, batch_global(x[:FED_EVAL], y[:FED_EVAL], 256, device="cuda")


def _fed_managers(model, fed, test, cfg, clock, local_train):
    """What FedML_FedAvg_distributed runs (loopback, the tensor wire, no
    codec), its silos on an already captured ``local_train``: every round
    steady. Returns the aggregator, stamped as the entry point stamps
    it."""
    from fedml_tpu_torch.algos.fedavg_distributed import (
        FedAVGAggregator, FedAVGClientManager, FedAVGServerManager,
        build_federation_setup)
    from fedml_tpu_torch.comm.loopback import run_workers
    from fedml_tpu_torch.trainer.local import softmax_ce

    size, net0, _, eval_fn, args = build_federation_setup(
        model, fed, test, cfg, "LOOPBACK", softmax_ce,
        loopback_wire="tensor")
    agg = FedAVGAggregator(net0, size - 1, cfg, eval_fn, test,
                           device="cuda")
    server = FedAVGServerManager(args, agg, cfg, size, metrics=clock)
    clients = [FedAVGClientManager(args, rank, size, fed, local_train, cfg)
               for rank in range(1, size)]
    run_workers([server.run] + [c.run for c in clients])
    agg.final_health = server.health()
    agg.ingest_profile = server.ingest_profile()
    agg.local_train = local_train
    return agg


def _fed_arm(tag, card, fed, test, codec, workers, rounds, reuse=None):
    """One arm of (a): ``rounds`` rounds of FedML_FedAvg_distributed at
    the flagship's config; its round ms, silo step, bytes, ingest profile
    and GroupNorm launches printed and checked. With ``reuse`` (an
    earlier arm's captured silo step) the arm runs alone on the card
    after (c), through the same managers over that step, so every round
    is steady, and times the step eager too: the host-bound figures are
    the ones (c)'s three processes inflate. Returns (the aggregator, the
    launches)."""
    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.algos.fedavg_distributed import (
        FedML_FedAvg_distributed)
    from fedml_tpu_torch.models import create_model

    cfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                    client_num_per_round=TRAIN_PER_ROUND, comm_round=rounds,
                    epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED,
                    frequency_of_the_test=1, ingest_workers=workers)
    model = create_model("resnet56", num_classes=10, dtype="bf16",
                         device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    clock = _RoundClock()
    _zero_gn_counts()
    t0 = time.perf_counter()
    if reuse is None:
        agg = FedML_FedAvg_distributed(
            model, fed, test, cfg, wire_codec=codec, loopback_wire="tensor",
            metrics=clock, device="cuda")
    else:
        check(codec == "none", f"{tag}: a reused step runs codec none")
        agg = _fed_managers(model, fed, test, cfg, clock, reuse)
    run_s = time.perf_counter() - t0
    fwd, bwd, red, copies, streamed = _gn_counts()
    rounds_ms = [(b - a) * 1e3 for a, b in zip(clock.t, clock.t[1:])]
    health, prof = agg.final_health, agg.ingest_profile
    uploads = rounds * TRAIN_PER_ROUND
    losses = [h["loss"] for h in agg.test_history]
    replayed, eager = _fed_silo_step_ms(agg, fed, reuse is not None)
    where, capture = (
        ("beside (c)'s three processes", "round 0 with the silo step's "
         f"capture {agg.local_train.capture_ms:.0f} ms") if reuse is None
        else ("alone on the card, after (c)", "an earlier arm's captured "
              "silo step: no capture"))
    print(f"[{tag}] (a) wire_codec {codec}, ingest_workers {workers}, "
          f"{where}: {rounds} rounds in {run_s:.1f} s, round ms "
          f"{[round(r, 1) for r in rounds_ms]} ({capture}); silo "
          f"step {replayed:.2f} ms replayed, {eager:.2f} ms eager "
          f"({TRAIN_PER_CLIENT // TRAIN_BATCH} local steps); bytes a "
          f"upload on the wire {health['bytes_rx'] / uploads:.0f} "
          f"(payload {prof.get('bytes_per_upload_mean')}), broadcast "
          f"bytes {health['bytes_tx']}; eval losses "
          f"{[round(l, 4) for l in losses]}; GroupNorm launches fwd "
          f"{fwd}, bwd {bwd}, reduce {red}, copies {copies}; {card}",
          flush=True)
    print(f"[{tag}] (a) ingest_profile {json.dumps(prof)}", flush=True)
    check(fwd > 0 and bwd > 0, f"{tag}: arm {codec}/{workers} launched "
          "no GroupNorm kernel")
    check(len(losses) == rounds and all(math.isfinite(l) for l in losses),
          f"{tag}: arm {codec}/{workers} eval losses {losses}")
    check(health["members"] == TRAIN_PER_ROUND
          and health["codec_refusals"] == 0,
          f"{tag}: arm {codec}/{workers} health {health}")
    del model
    return agg, {"group_norm_fwd": fwd, "group_norm_bwd": bwd}


def _fed_small():
    from fedml_tpu_torch.data import (batch_global, build_federated_arrays,
                                      partition_homo)
    from fedml_tpu_torch.data.synthetic import make_image_classification
    from fedml_tpu_torch.models import create_model

    x, y = make_image_classification(6 * 64 + 64, (8, 8, 3), 4, seed=SEED)
    fed = build_federated_arrays(x[:384], y[:384], partition_homo(384, 6),
                                 16, device="cuda")
    test = batch_global(x[384:], y[384:], 32, device="cuda")

    def model():
        return create_model("lr", num_classes=4, in_features=192,
                            device="cuda",
                            generator=torch.Generator().manual_seed(SEED))

    return fed, test, model


def _fed_control(tag, card):
    """(b): a silo cut off by ChaosSpec is evicted and the run ends; a
    server crash after round 2, resumed from its checkpoint, ends on the
    uninterrupted run's net bit for bit."""
    import tempfile
    import threading

    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.algos.fedavg_distributed import (
        FedAVGAggregator, FedAVGClientManager, FedAVGServerManager,
        FedML_FedAvg_distributed, build_federation_setup)
    from fedml_tpu_torch.comm.resilience import ChaosSpec
    from fedml_tpu_torch.core.tree import sorted_leaves
    from fedml_tpu_torch.trainer.local import softmax_ce

    fed, test, model = _fed_small()
    cfg = FedConfig(comm_round=3, round_timeout_s=2.0,
                    heartbeat_interval_s=0.2, **FED_SMALL)
    chaos = ChaosSpec(seed=SEED, partitions={(3, 0), (0, 3)})
    t0 = time.perf_counter()
    agg = FedML_FedAvg_distributed(model(), fed, test, cfg, chaos=chaos,
                                   idle_timeout_s=5.0, device="cuda")
    h = agg.final_health
    print(f"[{tag}] (b) silo 3 cut off by ChaosSpec: the run ended in "
          f"{time.perf_counter() - t0:.1f} s after {len(agg.test_history)} "
          f"rounds, evictions {h['evictions']}, members {h['members']}, "
          f"chaos counts {chaos.counts}; accuracy "
          f"{agg.test_history[-1]['accuracy']:.4f}", flush=True)
    check(h["evictions"] >= 1 and h["members"] == 2
          and len(agg.test_history) == 3,
          f"{tag}: the chaos drill's health {h}")

    ckpt_rounds = 4
    with _cudnn_deterministic():
        cfg = FedConfig(comm_round=ckpt_rounds, checkpoint_every=1,
                        ingest_workers=2, **FED_SMALL)
        clean = FedML_FedAvg_distributed(model(), fed, test, cfg,
                                         device="cuda")

        class Crash(Exception):
            pass

        class CrashingServer(FedAVGServerManager):
            def _complete_round(self):
                super()._complete_round()
                if self.round_idx == 2:
                    raise Crash("kill -9 after round 2")

        ckpt = tempfile.mkdtemp(prefix="chip_smoke_fedckpt_")
        try:
            size, net0, local_train, eval_fn, args = build_federation_setup(
                model(), fed, test, cfg, "LOOPBACK", softmax_ce)
            server1 = CrashingServer(
                args, FedAVGAggregator(net0, size - 1, cfg, eval_fn, test,
                                       device="cuda"),
                cfg, size, checkpoint_dir=ckpt)
            clients = [FedAVGClientManager(args, r, size, fed, local_train,
                                           cfg, idle_timeout_s=60.0)
                       for r in range(1, size)]
            crashed = []

            def run1():
                try:
                    server1.run()
                except Crash:
                    crashed.append(True)

            threads = [threading.Thread(target=run1, daemon=True)] + [
                threading.Thread(target=c.run, daemon=True) for c in clients]
            for t in threads:
                t.start()
            threads[0].join(timeout=120)
            check(crashed, f"{tag}: the server did not crash as scripted")
            server1._pool.close()
            if server1._ckpt is not None:
                server1._ckpt.wait()
            agg2 = FedAVGAggregator(net0, size - 1, cfg, eval_fn, test,
                                    device="cuda")
            server2 = FedAVGServerManager(args, agg2, cfg, size,
                                          checkpoint_dir=ckpt)
            restored = server2.round_idx
            t2 = threading.Thread(target=server2.run, daemon=True)
            t2.start()
            t2.join(timeout=120)
            for t in threads[1:]:
                t.join(timeout=60)
            check(not t2.is_alive() and not any(t.is_alive()
                                                for t in threads[1:]),
                  f"{tag}: the resumed federation did not end")
        finally:
            import shutil

            shutil.rmtree(ckpt, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(
        sorted_leaves(agg2.net), sorted_leaves(clean.net)))
    h2 = server2.health()
    print(f"[{tag}] (b) server crash after round 2, restart from its "
          f"checkpoint (restored at round {restored}, epoch {h2['epoch']}, "
          f"epoch drops {h2['epoch_drops']}): final net vs the "
          f"uninterrupted run {'bit-equal' if same else 'NOT bit-equal'} "
          f"(ingest_workers 2, deterministic cuDNN); {card}", flush=True)
    check(same and 0 < restored <= 2 and h2["epoch"] == 1,
          f"{tag}: the resumed run (restored at {restored}, health {h2})")


def phase_fed():
    """The federation plane on the card: (c) the cross-silo CLI's three
    TCP ranks started first as subprocesses; beside them (a)'s loopback
    flagship arms with the fold check, and (b) the control-plane drills;
    then (c)'s results; last, (a)'s first arm again for FED_ROUNDS_ALONE
    steady rounds over its captured silo step, alone on the card, for the
    round and silo-step times (eager too) without (c)'s contention. Returns {kernel name: GroupNorm
    launches of (a)}."""
    tag, card = "fed", smi_line()
    t_phase = time.perf_counter()
    launches = collections.Counter()
    run = _fed_cli_start(tag)
    try:
        fed, test = _fed_data()
        for codec, workers in FED_ARMS:
            agg, n = _fed_arm(tag, card, fed, test, codec, workers,
                              FED_ROUNDS)
            launches.update(n)
            if (codec, workers) == FED_ARMS[0]:
                _fed_fold_check(tag, agg, fed, agg.cfg)
                step = agg.local_train
            del agg
            _free()
        _fed_control(tag, card)
        _fed_cli_finish(run, tag)
    finally:
        _fed_stop_cli(run)
    codec, workers = FED_ARMS[0]
    agg, n = _fed_arm(tag, card, fed, test, codec, workers,
                      FED_ROUNDS_ALONE, reuse=step)
    launches.update(n)
    del agg, step, fed, test
    _free()
    print(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s; {card}",
          flush=True)
    return dict(launches)


# The asynchronous tiers (the async phase). (a) FedAsync at the flagship's
# config (the fed phase's data and model, 8 workers) for 24 server
# versions at the JAX runner's alpha 0.6 and staleness exponent 0.5, bf16
# wire codec, 4 ingest workers, eval on 1,024 samples at the end; then
# ASYNC_REPLAY uploads of its captured step at staleness 0..7 mixed by
# an inline and a pooled server, bit for bit. (b) FedBuff over the
# adapter phase's transformer (bf16, flash at T 2048, LoRA rank 16 on
# attention), 16 clients of 8 sequences, 8 workers, buffer_k 4, alpha 1,
# 3 aggregations, topk0.01+int8 deltas with error feedback, 4 ingest
# workers; one worker's step held to the plain twin by the adapter
# phase's bf16 rule; BUFF_SERVE_REQUESTS requests served on its global.
# (c) FED_SMALL's lr: coord_median over a buffer of 3 with worker 1
# uploading NaNs, and FedAsync with worker 3 cut off by a ChaosSpec
# partition (done deadline 2 s). (d) main_extra in process at the JAX
# package's test sizes (tests/test_exp_extra.py:11-16).
ASYNC_VERSIONS, ASYNC_ALPHA, ASYNC_STALENESS_EXP = 24, 0.6, 0.5
ASYNC_CODEC, ASYNC_INGEST, ASYNC_REPLAY = "bf16", 4, 8
BUFF_K, BUFF_AGGS, BUFF_CODEC, BUFF_INGEST = 4, 3, "topk0.01+int8", 4
BUFF_SERVE_REQUESTS, ASYNC_DONE_S = 64, 2.0
ASYNC_CLI_BASE = ["--client_num_in_total", "4", "--client_num_per_round",
                  "4", "--batch_size", "8", "--comm_round", "2",
                  "--epochs", "1", "--lr", "0.05", "--device", "cuda"]
ASYNC_CLI = (
    ("FedAsync", ["--dataset", "cifar10", "--model", "resnet56", "--ci", "1",
                  "--synthetic_samples", "96", "--partition_method", "homo"]),
    ("FedBuff", ["--dataset", "shakespeare", "--model", "transformer_lm",
                 "--adapter_rank", "8", "--serve", "--serve_requests",
                 "32"]),
    ("BaseFramework", ["--dataset", "cifar10", "--model", "resnet56"]))


def _async_flagship(tag, card):
    """(a): FedML_FedAsync_distributed at the flagship's config; then the
    captured step's uploads mixed inline and pooled. Returns the
    GroupNorm launches."""
    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.algos import fedasync as fa
    from fedml_tpu_torch.comm import codec as wire_codec
    from fedml_tpu_torch.comm import pytree
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.core.tree import sorted_leaves
    from fedml_tpu_torch.models import create_model

    fed, test = _fed_data()
    cfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                    client_num_per_round=TRAIN_PER_ROUND,
                    comm_round=ASYNC_VERSIONS, epochs=1,
                    batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED,
                    frequency_of_the_test=ASYNC_VERSIONS,
                    ingest_workers=ASYNC_INGEST)
    model = create_model("resnet56", num_classes=10, dtype="bf16",
                         device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    clock = _RoundClock()
    _zero_gn_counts()
    t0 = time.perf_counter()
    srv = fa.FedML_FedAsync_distributed(
        model, fed, test, cfg, alpha=ASYNC_ALPHA,
        staleness_exp=ASYNC_STALENESS_EXP, wire_codec=ASYNC_CODEC,
        loopback_wire="tensor", metrics=clock, device="cuda")
    run_s = time.perf_counter() - t0
    fwd, bwd, red, copies, _ = _gn_counts()
    ms = [(b - a) * 1e3 for a, b in zip(clock.t, clock.t[1:])]
    prof, health = srv.ingest_profile(), srv.final_health
    dense = 4 * sum(int(np.prod(np.shape(l)))
                    for l in sorted_leaves(srv.net))
    pool = prof.get("ingest_pool", {})
    losses = [h["loss"] for h in srv.test_history]
    print(f"[{tag}] (a) FedAsync, resnet56 bf16, {TRAIN_PER_ROUND} workers, "
          f"alpha {ASYNC_ALPHA}, staleness exp {ASYNC_STALENESS_EXP}, wire "
          f"codec {ASYNC_CODEC}, ingest workers {ASYNC_INGEST}: "
          f"{srv.version} versions in {run_s:.1f} s; ms a version "
          f"{[round(m, 1) for m in ms]} (the first with the step's capture "
          f"{srv.local_train.capture_ms:.0f} ms; median after it "
          f"{statistics.median(ms[1:]):.1f} ms); staleness "
          f"{srv.staleness_history}; bytes a upload "
          f"{prof.get('bytes_per_upload_mean')} (f32 tree {dense}), on the "
          f"wire {health['bytes_rx']} in all; dispatch occupancy "
          f"{prof.get('ingest_occupancy')}, pool occupancy "
          f"{pool.get('occupancy_per_worker')}; eval loss {losses}; GroupNorm "
          f"launches fwd {fwd}, bwd {bwd}, reduce {red}, copies {copies}; "
          f"{card}", flush=True)
    check(fwd > 0 and bwd > 0, f"{tag}: FedAsync launched no GroupNorm "
          f"kernel ({fwd}, {bwd})")
    check(srv.version == ASYNC_VERSIONS and losses
          and all(math.isfinite(l) for l in losses)
          and health["codec_refusals"] == 0 and health["members"]
          == TRAIN_PER_ROUND, f"{tag}: FedAsync {srv.version} versions, "
          f"losses {losses}, health {health}")

    # The same recorded uploads (the captured step from the final net,
    # ASYNC_REPLAY clients, bf16 frames) mixed by an inline and a pooled
    # server at staleness 0..7: bit-equal nets.
    start = pytree.to_device(pytree.host_tree(srv.net), "cuda")
    codec = wire_codec.make_wire_codec(ASYNC_CODEC)
    ups = []
    for i, c in enumerate(sample_clients(ASYNC_VERSIONS, TRAIN_CLIENTS,
                                         ASYNC_REPLAY)):
        rng = keys.fold_in(keys.fold_in(keys.key(SEED, "cuda"), i), 1)
        net, _ = srv.local_train(start, fed.x[c], fed.y[c], fed.mask[c],
                                 rng)
        ups.append(codec.encode(pytree.host_tree(net), None, i)[0])
    nets = []
    for workers in (0, ASYNC_INGEST):
        args = type("A", (), {"chaos": None})()
        from fedml_tpu_torch.comm.loopback import LoopbackNetwork

        args.network = LoopbackNetwork(ASYNC_REPLAY + 1)
        rcfg = FedConfig(client_num_in_total=TRAIN_CLIENTS,
                         client_num_per_round=ASYNC_REPLAY, comm_round=10 ** 6,
                         ingest_workers=workers)
        rsrv = fa.FedAsyncServerManager(args, start, rcfg, ASYNC_REPLAY + 1,
                                        alpha=ASYNC_ALPHA, device="cuda")
        for i, payload in enumerate(ups):
            m = Message(3, i + 1, 0)
            m.add(Message.MSG_ARG_KEY_MODEL_PARAMS, payload)
            m.add(wire_codec.CODEC_KEY, ASYNC_CODEC)
            m.add(fa.MSG_ARG_KEY_MODEL_VERSION, rsrv.version - i)
            m.add(fa.MSG_ARG_KEY_TASK_SEQ, 0)
            rsrv.handle_upload(m)
        rsrv.finish()
        nets.append((rsrv.net, list(rsrv.staleness_history)))
    same = all(torch.equal(a, b) for a, b in zip(
        sorted_leaves(nets[0][0]), sorted_leaves(nets[1][0])))
    print(f"[{tag}] (a) {ASYNC_REPLAY} recorded uploads at staleness "
          f"{nets[0][1]} mixed inline and through the pool's decode "
          f"({ASYNC_INGEST} workers): {'bit-equal' if same else 'NOT '
          'bit-equal'}", flush=True)
    check(same and nets[0][1] == list(range(ASYNC_REPLAY)),
          f"{tag}: the pooled decode's mix differs from the inline one")
    del srv, model, fed, test, start
    return {"group_norm_fwd": fwd, "group_norm_bwd": bwd}


def _async_adapter(tag, card):
    """(b): FedML_FedBuff_distributed over the FedAdapter model at full
    width; the step held to its twin; the serving plane on its global.
    Returns the flash launches."""
    import functools

    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.algos import fedbuff as fb
    from fedml_tpu_torch.algos.fedavg_distributed import (
        build_federation_setup)
    from fedml_tpu_torch.comm import pytree
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.tree import sorted_leaves
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.exp.main_extra import _serve_fedbuff_global
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.local import seq_softmax_ce

    fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")
    rng = np.random.RandomState(SEED)  # the adapter phase's data
    seqs = rng.randint(1, VOCAB, size=(ADAPTER_CLIENTS * ADAPTER_PER_CLIENT,
                                       SEQ_LEN + 1))
    fed = build_federated_arrays(
        seqs[:, :SEQ_LEN].astype(np.int32), seqs[:, 1:].astype(np.int32),
        partition_homo(len(seqs), ADAPTER_CLIENTS), ADAPTER_BATCH,
        device="cuda")
    cfg = FedConfig(client_num_in_total=ADAPTER_CLIENTS,
                    client_num_per_round=ADAPTER_PER_ROUND,
                    comm_round=BUFF_AGGS, epochs=1, batch_size=ADAPTER_BATCH,
                    lr=ADAPTER_LR, seed=SEED, adapter_rank=ADAPTER_RANK,
                    ingest_workers=BUFF_INGEST)
    loss_fn = functools.partial(seq_softmax_ce, pad_id=0)

    def build(dtype="bf16", attn_fn=None):
        return create_model(
            "transformer_lm", vocab_size=VOCAB, d_model=D_MODEL,
            n_heads=N_HEADS, n_layers=N_LAYERS, max_len=SEQ_LEN, dtype=dtype,
            attn="flash", attn_fn=attn_fn, adapter_rank=ADAPTER_RANK,
            adapter_scope="attn", device="cuda",
            generator=torch.Generator().manual_seed(SEED))

    model = build()
    base0 = {k: v.clone() for k, v in model.state_dict().items()}
    clock = _RoundClock()
    _zero_flash_counts()
    t0 = time.perf_counter()
    srv = fb.FedML_FedBuff_distributed(
        model, fed, None, cfg, loss_fn=loss_fn, alpha=1.0, buffer_k=BUFF_K,
        wire_codec=BUFF_CODEC, loopback_wire="tensor", metrics=clock,
        device="cuda")
    run_s = time.perf_counter() - t0
    fwd, dq, dkv, copies = _flash_counts()
    ms = [(b - a) * 1e3 for a, b in zip(clock.t, clock.t[1:])]
    prof, health = srv.ingest_profile(), srv.final_health
    tree_bytes = 4 * sum(int(l.numel()) for l in sorted_leaves(srv.net))
    model_bytes = 4 * sum(int(v.numel()) for v in base0.values())
    now = model.state_dict()
    same_base = all(torch.equal(v, now[k]) for k, v in base0.items())
    finite = all(bool(torch.isfinite(l).all())
                 for l in sorted_leaves(srv.net))
    print(f"[{tag}] (b) FedBuff over transformer_lm d_model {D_MODEL}, "
          f"{N_LAYERS} layers, bf16, flash at T {SEQ_LEN}, LoRA rank "
          f"{ADAPTER_RANK} on attn; {ADAPTER_PER_ROUND} workers, buffer_k "
          f"{BUFF_K}, alpha 1, wire codec {BUFF_CODEC}, ingest workers "
          f"{BUFF_INGEST}: {srv.version} aggregations in {run_s:.1f} s; ms "
          f"an aggregation {[round(m, 1) for m in ms]} (the first with the "
          f"step's capture {srv.local_train.capture_ms:.0f} ms); staleness "
          f"{srv.staleness_history}; bytes a upload "
          f"{prof.get('bytes_per_upload_mean')} against the adapter tree's "
          f"{tree_bytes} and the dense model's {model_bytes}; occupancy "
          f"{prof.get('ingest_occupancy')}; flash launches fwd {fwd}, dq "
          f"{dq}, dkv {dkv}, copies {copies}; the frozen base "
          f"{'bit-equal' if same_base else 'CHANGED'}; {card}", flush=True)
    check(fwd > 0 and dq > 0 and dkv > 0, f"{tag}: FedBuff's adapter "
          f"federation launched fwd {fwd}, dq {dq}, dkv {dkv}")
    check(same_base, f"{tag}: the frozen base changed")
    check(srv.version == BUFF_AGGS and finite
          and health["codec_refusals"] == 0,
          f"{tag}: FedBuff {srv.version} aggregations, health {health}")

    # One worker's captured step from the trained global and one key, the
    # kernels against the plain twin by the adapter phase's bf16 rule.
    def twin_fn(q, k, v, causal):
        return fa.flash_attention_plain(q, k, v, causal)[0]

    start = pytree.to_device(pytree.host_tree(srv.net), "cuda")
    key = keys.fold_in(keys.fold_in(keys.key(SEED, "cuda"), 0), 1)
    one = (fed.x[0], fed.y[0], fed.mask[0], key)

    def delta(step):
        new = step(start, *one)[0]
        return torch.cat([(a - b).float().flatten() for a, b in zip(
            sorted_leaves(new), sorted_leaves(start))])

    step_k = delta(srv.local_train)
    steps = {}
    for name, dtype in (("twin16", "bf16"), ("twin32", None)):
        lt = build_federation_setup(build(dtype, twin_fn), fed, None, cfg,
                                    "LOOPBACK", loss_fn)[2]
        steps[name] = delta(lt.step)
        del lt
    want = steps["twin32"]
    rel_k = ((step_k - want).norm() / want.norm()).item()
    rel_t = ((steps["twin16"] - want).norm() / want.norm()).item()
    bound = ADAPTER_BF16_FACTOR * rel_t + ADAPTER_BF16_SLACK
    print(f"[{tag}] (b) one worker's step ({fed.steps_per_epoch} local "
          f"steps) from the trained global, distance from the f32 twin's "
          f"step: the captured step's kernels {rel_k:.4e}, the bf16 twin "
          f"{rel_t:.4e} (tol: kernels <= {ADAPTER_BF16_FACTOR} x twin + "
          f"{ADAPTER_BF16_SLACK} = {bound:.4e}); |update| "
          f"{want.norm().item():.4e}", flush=True)
    check(math.isfinite(rel_k) and rel_k <= bound,
          f"{tag}: the worker's step is {rel_k} from the f32 twin's, the "
          f"bf16 twin {rel_t}")

    # The serving plane on the trained global (main_extra's --serve path).
    t0 = time.perf_counter()
    args = types.SimpleNamespace(serve_max_batch=32, serve_deadline_ms=5.0,
                                 serve_port=0, device="cuda",
                                 serve_requests=BUFF_SERVE_REQUESTS)
    stats = _serve_fedbuff_global(args, model, srv)
    print(f"[{tag}] (b) serving {BUFF_SERVE_REQUESTS} requests on the "
          f"trained global (seq_len 32, 2 new tokens each) in "
          f"{time.perf_counter() - t0:.1f} s: {json.dumps(stats)}",
          flush=True)
    check(stats.get("serve_served") == BUFF_SERVE_REQUESTS,
          f"{tag}: served {stats}")
    del srv, model, fed, start, step_k, steps, want
    return {"flash_fwd": fwd, "flash_dq": dq, "flash_dkv": dkv}


def _async_control(tag, card):
    """(c): coord_median against a NaN-uploading worker, and a worker cut
    off by a ChaosSpec partition, on FED_SMALL's lr."""
    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.algos.fedasync import FedML_FedAsync_distributed
    from fedml_tpu_torch.algos.fedbuff import FedML_FedBuff_distributed
    from fedml_tpu_torch.comm.resilience import ChaosSpec
    from fedml_tpu_torch.core.faults import UpdateCorruptor

    fed, test, model = _fed_small()
    cfg = FedConfig(comm_round=6, **FED_SMALL)
    srv = FedML_FedBuff_distributed(
        model(), fed, test, cfg, buffer_k=3, aggregator="coord_median",
        corrupt_ranks=(1,), corruptor=UpdateCorruptor("nan", seed=SEED),
        device="cuda", idle_timeout_s=30.0)
    bad = sum(1 for w, _ in srv.arrival_log if w == 1)
    finite = all(bool(torch.isfinite(v).all())
                 for v in srv.net.params.values())
    print(f"[{tag}] (c) FedBuff coord_median, buffer 3, worker 1 uploading "
          f"NaNs: {srv.version} aggregations, guard drops "
          f"{srv.guard_drops} of worker 1's {bad} uploads, global "
          f"{'finite' if finite else 'NOT finite'}, accuracy "
          f"{srv.test_history[-1]['accuracy']:.4f}", flush=True)
    check(finite and bad > 0 and srv.guard_drops == bad
          and srv.version == 6, f"{tag}: the robust arm {srv.final_health}")
    cfg = FedConfig(comm_round=6, heartbeat_interval_s=0.2, **FED_SMALL)
    chaos = ChaosSpec(seed=SEED, partitions={(3, 0), (0, 3)})
    t0 = time.perf_counter()
    srv = FedML_FedAsync_distributed(
        model(), fed, test, cfg, chaos=chaos, done_timeout_s=ASYNC_DONE_S,
        idle_timeout_s=5.0, device="cuda")
    took = time.perf_counter() - t0
    h = srv.final_health
    print(f"[{tag}] (c) FedAsync with worker 3 cut off by ChaosSpec: "
          f"{srv.version} versions, the run ended in {took:.1f} s (done "
          f"deadline {ASYNC_DONE_S} s, the cut worker's idle quit 5 s), "
          f"evictions {h['evictions']}, members {h['members']}, chaos "
          f"counts {chaos.counts}; {card}", flush=True)
    check(srv.version == 6 and h["evictions"] >= 1 and 3 not in srv._members
          and took < 60.0, f"{tag}: the partition drill {h}, {took:.1f} s")


def _async_cli(tag):
    """(d): main_extra's FedAsync, FedBuff (--serve) and BaseFramework
    runners in this process; each last line parsed. Returns the kernels'
    launches."""
    import io

    from fedml_tpu_torch.exp import main_extra

    launches = collections.Counter()
    for algo, extra in ASYNC_CLI:
        _zero_gn_counts()
        _zero_flash_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main_extra.main(["--algorithm", algo] + ASYNC_CLI_BASE + extra)
        took = time.perf_counter() - t0
        gn = _gn_counts()
        fl = _flash_counts()
        n = {"group_norm_fwd": gn[0], "group_norm_bwd": gn[1],
             "flash_fwd": fl[0], "flash_dq": fl[1], "flash_dkv": fl[2]}
        launches.update(n)
        last = json.loads(out.getvalue().strip().splitlines()[-1])
        print(f"[{tag}] (d) main_extra --algorithm {algo} "
              f"{' '.join(extra)}: {took:.1f} s; last line "
              f"{json.dumps(last)[:400]}; launches {n}", flush=True)
        if algo == "BaseFramework":
            check(last.get("aggregate") == 8.0, f"{tag}: {algo} {last}")
            continue
        check(math.isfinite(last.get("loss", float("nan")))
              and last.get("version") == 2, f"{tag}: {algo} {last}")
        if algo == "FedAsync":
            check(n["group_norm_fwd"] > 0 and n["group_norm_bwd"] > 0,
                  f"{tag}: {algo} launched {n}")
        else:  # the CLI's transformer_lm attends densely, as JAX's does
            check(last.get("serve_served") == 32, f"{tag}: {algo} {last}")
    return launches


def phase_async():
    """The federation plane's asynchronous tiers on the card: (a)
    FedAsync at the flagship's config, (b) FedBuff's adapter federation
    at full width with its serving plane, (c) the robust arm and a
    partition drill, (d) main_extra's runners. Returns {kernel name:
    launches}."""
    tag, card = "async", smi_line()
    t_phase = time.perf_counter()
    launches = collections.Counter()
    for name, fn in (("a", _async_flagship), ("b", _async_adapter)):
        t0 = time.perf_counter()
        launches.update(fn(tag, card))
        _free()
        print(f"[{tag}] ({name}) {time.perf_counter() - t0:.1f} s",
              flush=True)
    t0 = time.perf_counter()
    _async_control(tag, card)
    print(f"[{tag}] (c) {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(_async_cli(tag))
    _free()
    print(f"[{tag}] (d) {time.perf_counter() - t0:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return dict(launches)


# The secure, sharded and simulated plane (the plane phase), at the
# flagship's config (the fed phase's data and model: resnet56 bf16
# compute, 128 clients of 256 seeded CIFAR-shaped samples, batch 32, 1
# epoch, lr 0.1), every federation over ONE captured silo step (the
# entry points build theirs through build_federation_setup, which
# _plane_step hands the first one's), under deterministic cuDNN.
# (a) secagg: PLANE_SILOS silos, PLANE_INGEST ingest workers,
# PLANE_ROUNDS rounds; then a dropout drill of 2 rounds whose silo 1
# dies in round 1. (b) agg_shards PLANE_SHARDS over PLANE_SILOS silos;
# then a drill of PLANE_ROUNDS rounds whose shard 2 dies after round 0.
# (c) FleetSimulator over PLANE_SPEC: FedBuff (buffer_k 4, PLANE_VERSIONS
# aggregations, eval every PLANE_EVAL_EVERY) and sync first-k (aggregate_k
# 8, PLANE_SYNC_ROUNDS rounds), each twice; sync with secagg over the
# churn-free twin of the spec (all 32 online from t 0) for
# PLANE_SECAGG_ROUNDS round: each upload expands 31 pair masks of the
# 591,322-leaf tree on the host, ~0.3 s, so one round. (d)
# controller_from_args's adaptive controller on (c)'s FedBuff runs, then
# a loopback FedBuff run; a controller of no policies against none
# (FedBuff, PLANE_VERSIONS // 2 aggregations). (e) main_extra FedBuff
# --controller adaptive at --model lr.
PLANE_SILOS, PLANE_INGEST, PLANE_ROUNDS, PLANE_SHARDS = 4, 2, 3, 2
PLANE_SPEC = dict(n_devices=32, seed=SEED, horizon_s=3600.0)
PLANE_VERSIONS, PLANE_BUFF_K, PLANE_EVAL_EVERY = 10, 4, 3
PLANE_SYNC_K, PLANE_SYNC_ROUNDS, PLANE_SECAGG_ROUNDS = 8, 2, 1
# (d)'s loopback FedBuff run: 8 workers, PLANE_LOOP_AGGS aggregations.
PLANE_LOOP_AGGS = 4
PLANE_CTRL = types.SimpleNamespace(controller="adaptive",
                                   controller_interval=1,
                                   controller_band_lo=2.0,
                                   controller_band_hi=6.0)
PLANE_CLI = ["--algorithm", "FedBuff", "--dataset", "synthetic_1_1",
             "--model", "lr", "--client_num_in_total", "8",
             "--client_num_per_round", "4", "--comm_round", "6",
             "--buffer_k", "2", "--frequency_of_the_test", "1",
             "--controller", "adaptive", "--device", "cuda"]


def _plane_cfg(**kw):
    from fedml_tpu_torch.algos import FedConfig

    base = dict(client_num_in_total=TRAIN_CLIENTS,
                client_num_per_round=PLANE_SILOS, comm_round=PLANE_ROUNDS,
                epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED,
                frequency_of_the_test=10 ** 6)
    base.update(kw)
    return FedConfig(**base)


def _plane_model():
    from fedml_tpu_torch.models import create_model

    return create_model("resnet56", num_classes=10, dtype="bf16",
                        device="cuda",
                        generator=torch.Generator().manual_seed(SEED))


@contextlib.contextmanager
def _plane_step(step):
    """Hands ``step`` (a captured silo step of the phase's model and
    config) to every federation the entry points build meanwhile: the
    three tiers and the simulator build the silos' step through
    fedavg_distributed.build_federation_setup, looked up in its module at
    each call, which would capture a new one (~2.5 s warm) each time."""
    from fedml_tpu_torch.algos import fedavg_distributed as fd

    orig = fd.build_federation_setup

    def setup(*a, **kw):
        out = list(orig(*a, **kw))
        out[2] = step
        return tuple(out)

    fd.build_federation_setup = setup
    try:
        yield
    finally:
        fd.build_federation_setup = orig


class _MaskSpy:
    """Records, while active, each silo's clear fixed-point contribution
    (a copy taken before masking), its masked frame and the sample count
    it weighs its upload by, keyed by (rank, round), and each merged
    total the server audits between mask cancellation and its division,
    keyed by round."""

    def __enter__(self):
        from fedml_tpu_torch.algos.fedavg_distributed import (
            FedAVGClientManager, FedAVGServerManager)
        from fedml_tpu_torch.comm import secagg

        self.clear, self.masked, self.weights, self.totals = {}, {}, {}, {}
        self._mask = mask = secagg.SecAggClient.mask
        self._check = check_ = FedAVGServerManager._secagg_envelope_check
        self._body = body = FedAVGClientManager._masked_contribution
        spy = self

        def body_spy(mgr, host, global_net, c, codec):
            spy.weights[(mgr.rank, int(mgr.round_idx))] = float(
                mgr._counts[c])
            return body(mgr, host, global_net, c, codec)

        def mask_spy(client, leaves, round_idx, roster):
            key = (client.rank, int(round_idx))
            spy.clear[key] = [np.array(l, np.int64, copy=True)
                              for l in leaves]
            out = mask(client, leaves, round_idx, roster)
            spy.masked[key] = [np.array(l, np.int64, copy=True)
                               for l in out]
            return out

        def check_spy(server, total):
            spy.totals[server.round_idx] = (
                [np.array(l, np.int64, copy=True) for l in total.leaves],
                int(total.wsum), int(total.count))
            return check_(server, total)

        secagg.SecAggClient.mask = mask_spy
        FedAVGServerManager._secagg_envelope_check = check_spy
        FedAVGClientManager._masked_contribution = body_spy
        return self

    def __exit__(self, *exc):
        from fedml_tpu_torch.algos.fedavg_distributed import (
            FedAVGClientManager, FedAVGServerManager)
        from fedml_tpu_torch.comm import secagg

        secagg.SecAggClient.mask = self._mask
        FedAVGServerManager._secagg_envelope_check = self._check
        FedAVGClientManager._masked_contribution = self._body

    def clear_fold(self, round_idx, ranks):
        """The wrapped int64 sum of ``ranks``' clear contributions."""
        sums = None
        for r in ranks:
            leaves = [l.view(np.uint64) for l in self.clear[(r, round_idx)]]
            sums = ([l.copy() for l in leaves] if sums is None
                    else [np.add(a, b, out=a) for a, b in zip(sums, leaves)])
        return [s.view(np.int64) for s in sums]


def _plane_hold_rounds(tag, what, spy, rounds, ranks_of):
    """Each round's merged total against the clear fold of the ranks
    that ``ranks_of(round)`` names, its weight sum against their
    quantized sample counts; the masked frames against their clear
    contributions. Returns the last round's (clear fold, the silos' weight
    sum, count)."""
    from fedml_tpu_torch.comm.ingest import quantize_weight

    for r in rounds:
        check(r in spy.totals, f"{tag}: {what}: round {r} never merged")
        got, wsum, count = spy.totals[r]
        ranks = ranks_of(r)
        want = spy.clear_fold(r, ranks)
        want_wsum = sum(quantize_weight(spy.weights[(k, r)]) for k in ranks)
        same = all(np.array_equal(a, b) for a, b in zip(got, want))
        check(same and count == len(ranks) and wsum == want_wsum,
              f"{tag}: {what}: round {r}'s merged total is not the clear "
              f"fold of ranks {ranks} (count {count}, wsum {wsum} against "
              f"the silos' {want_wsum})")
    hidden = all(any(not np.array_equal(a, b) for a, b in zip(
        spy.masked[k], spy.clear[k])) for k in spy.clear)
    check(hidden, f"{tag}: {what}: a masked frame equals its clear "
          "contribution")
    return want, want_wsum, count


def _plane_global_holds(tag, what, agg, leaves, wsum, count):
    """The committed global against finalize_partial_mean of a clear
    total (leaves, wsum, count): bit-equal."""
    from fedml_tpu_torch.comm.ingest import (PartialAccumulator,
                                             finalize_partial_mean)
    from fedml_tpu_torch.core.tree import sorted_leaves

    total = PartialAccumulator()
    total.leaves, total.wsum, total.count = leaves, wsum, count
    mean, _ = finalize_partial_mean(total, agg.net)
    same = all(torch.equal(a, b) for a, b in zip(sorted_leaves(mean),
                                                  sorted_leaves(agg.net)))
    check(same, f"{tag}: {what}: the committed global is not the clear "
          "fold's mean")
    return same


def _plane_secagg(tag, card, fed, test):
    """(a): the masked federation against the clear fold of its own
    uploads; the dropout drill against the survivors' clear fold.
    Returns the captured silo step."""
    from fedml_tpu_torch.algos.fedavg_distributed import (
        FedAVGAggregator, FedAVGClientManager, FedAVGServerManager,
        FedML_FedAvg_distributed, build_federation_setup)
    from fedml_tpu_torch.comm.loopback import run_workers
    from fedml_tpu_torch.core.tree import sorted_leaves
    from fedml_tpu_torch.trainer.local import softmax_ce

    cfg = _plane_cfg(secagg=True, ingest_workers=PLANE_INGEST,
                     frequency_of_the_test=PLANE_ROUNDS - 1)
    clock = _RoundClock()
    t0 = time.perf_counter()
    with _MaskSpy() as spy:
        agg = FedML_FedAvg_distributed(
            _plane_model(), fed, test, cfg, loopback_wire="tensor",
            metrics=clock, device="cuda")
    run_s = time.perf_counter() - t0
    step = agg.local_train
    h, prof = agg.final_health, agg.ingest_profile
    ms = [(b - a) * 1e3 for a, b in zip(clock.t, clock.t[1:])]
    silos = list(range(1, PLANE_SILOS + 1))
    leaves, wsum, count = _plane_hold_rounds(
        tag, "secagg", spy, range(PLANE_ROUNDS), lambda r: silos)
    _plane_global_holds(tag, "secagg", agg, leaves, wsum, count)
    dense = 4 * sum(l.numel() for l in sorted_leaves(agg.net))
    print(f"[{tag}] (a) secagg over {PLANE_SILOS} silos, ingest workers "
          f"{PLANE_INGEST}, {PLANE_ROUNDS} rounds in {run_s:.1f} s (round "
          f"ms {[round(m, 1) for m in ms]}, the first with the pk/share "
          f"handshake and the step's capture {step.capture_ms} ms): "
          f"every round's merged total = the clear fold of its "
          f"{PLANE_SILOS} uploads, its weight sum = theirs, the global = "
          f"its mean, bit-equal; no "
          f"masked frame equals its clear contribution; bytes a masked "
          f"upload {prof.get('bytes_per_upload_mean')} (int64 leaves; the "
          f"f32 tree {dense}), on the wire {h['bytes_rx']} in all; "
          f"reveals {h['seed_reveals']}, saturated "
          f"{h['ingest_saturated']}; eval {agg.test_history[-1]}; {card}",
          flush=True)
    check(h["seed_reveals"] == 0 and h["codec_refusals"] == 0
          and h["members"] == PLANE_SILOS, f"{tag}: secagg health {h}")
    del agg

    # The dropout drill: silo 1 dies in round 1 after its roster was
    # stamped; the watchdog evicts it, the survivors reveal t shares of
    # its secret, the orphaned masks are corrected away.
    cfg = _plane_cfg(secagg=True, ingest_workers=PLANE_INGEST, comm_round=2,
                     heartbeat_interval_s=0.1)

    class Victim(FedAVGClientManager):
        def _train(self, global_net, client_index):
            if self.round_idx >= 1:
                self.finish()  # dies mid-round: no upload, beats stop
                return
            super()._train(global_net, client_index)

    t0 = time.perf_counter()
    with _MaskSpy() as spy:
        size, net0, _, eval_fn, args = build_federation_setup(
            _plane_model(), fed, None, cfg, "LOOPBACK", softmax_ce)
        agg = FedAVGAggregator(net0, size - 1, cfg, eval_fn, None,
                               device="cuda")
        srv = FedAVGServerManager(args, agg, cfg, size, round_timeout_s=5.0,
                                  heartbeat_timeout_s=1.0)
        clients = [(Victim if r == 1 else FedAVGClientManager)(
            args, r, size, fed, step, cfg, idle_timeout_s=60.0)
            for r in range(1, size)]
        run_workers([srv.run] + [c.run for c in clients])
    run_s = time.perf_counter() - t0
    h = srv.health()
    survivors = list(range(2, PLANE_SILOS + 1))
    leaves, wsum, count = _plane_hold_rounds(
        tag, "the dropout drill", spy, (0, 1),
        lambda r: silos if r == 0 else survivors)
    _plane_global_holds(tag, "the dropout drill", agg, leaves, wsum, count)
    reveal = srv._h_reveal.snapshot()
    kinds = collections.Counter(e["kind"] for e in srv.flight.snapshot())
    print(f"[{tag}] (a) dropout drill: silo 1 died in round 1 of 2; "
          f"{run_s:.1f} s; evictions {h['evictions']}, seed reveals "
          f"{h['seed_reveals']} (t {srv.secagg.t} of {PLANE_SILOS}, reveal "
          f"ms {reveal.get('max')}), corrections "
          f"{kinds['secagg_correction']}; round 1's merged total (after "
          f"the correction) = the clear fold of survivors {survivors}, "
          f"bit-equal, the global = its mean; silo 1 released "
          f"(compromised {srv.secagg.compromised(1)})", flush=True)
    check(not srv.aborted and srv.round_idx == 2 and h["seed_reveals"] == 1
          and h["evictions"] >= 1 and srv.secagg.compromised(1)
          and kinds["secagg_correction"] == 1,
          f"{tag}: the dropout drill {h}, flight {dict(kinds)}")
    del agg, srv, clients
    return step


def _plane_shards(tag, card, fed, test, step):
    """(b): agg_shards PLANE_SHARDS against the single pool's fold of the
    same uploads; a shard killed mid-federation."""
    from fedml_tpu_torch.algos.fedavg_distributed import (
        FedAVGAggregator, FedAVGClientManager, FedML_FedAvg_distributed,
        build_federation_setup)
    from fedml_tpu_torch.comm import pytree
    from fedml_tpu_torch.comm import shardplane as sp
    from fedml_tpu_torch.comm.ingest import PartialAccumulator
    from fedml_tpu_torch.comm.loopback import run_workers
    from fedml_tpu_torch.core.tree import sorted_leaves
    from fedml_tpu_torch.trainer.local import softmax_ce

    uploads, totals = collections.defaultdict(list), {}
    submit, finalize = (sp.AggregatorShardManager._submit_upload,
                        sp.finalize_partial_mean)

    def submit_spy(shard, sender, t, msg):
        uploads[t].append((sender, shard.rank, msg.get(
            sp.MSG_ARG_KEY_MODEL_PARAMS), float(msg.get(
                sp.MSG_ARG_KEY_NUM_SAMPLES))))
        return submit(shard, sender, t, msg)

    def finalize_spy(total, ref):
        totals[len(totals)] = ([np.array(l, np.int64, copy=True)
                                for l in total.leaves], total.wsum,
                               total.count)
        return finalize(total, ref)

    cfg = _plane_cfg()
    t0 = time.perf_counter()
    sp.AggregatorShardManager._submit_upload = submit_spy
    sp.finalize_partial_mean = finalize_spy
    try:
        with _plane_step(step):
            agg = FedML_FedAvg_distributed(
                _plane_model(), fed, test, cfg, agg_shards=PLANE_SHARDS,
                loopback_wire="tensor", device="cuda")
    finally:
        sp.AggregatorShardManager._submit_upload = submit
        sp.finalize_partial_mean = finalize
    run_s = time.perf_counter() - t0
    h = agg.final_health
    routed = {}
    for r in range(PLANE_ROUNDS):
        single = PartialAccumulator()
        for sender, shard, payload, w in sorted(uploads[r],
                                                key=lambda u: u[0]):
            routed[sender] = shard
            single.add([pytree.np_leaf(l) for l in sorted_leaves(payload)],
                       w)
        got, wsum, count = totals[r]
        same = (all(np.array_equal(a, b) for a, b in zip(got, single.leaves))
                and wsum == single.wsum and count == single.count
                == PLANE_SILOS)
        check(same, f"{tag}: round {r}'s merged shard partials differ from "
              "the single pool's fold of the same uploads")
    _plane_global_holds(tag, "agg_shards", agg, single.leaves, single.wsum,
                        single.count)
    print(f"[{tag}] (b) agg_shards {PLANE_SHARDS} over {PLANE_SILOS} silos, "
          f"{PLANE_ROUNDS} rounds in {run_s:.1f} s (silo -> shard "
          f"{dict(sorted(routed.items()))}): each round's merged partials = "
          f"the single pool's fold of the same uploads (agg_shards 0's "
          f"path), the global = its mean, bit-equal; health shards "
          f"{h['shards']}, bytes_rx {h['bytes_rx']} (the shard hops "
          f"included); {card}", flush=True)
    check(h["shards"] == PLANE_SHARDS and h["shard_evictions"] == 0
          and len(set(routed.values())) == PLANE_SHARDS,
          f"{tag}: agg_shards health {h}, routing {routed}")
    del agg

    cfg = _plane_cfg(heartbeat_interval_s=0.1,
                     frequency_of_the_test=PLANE_ROUNDS - 1)
    t0 = time.perf_counter()
    size, net0, _, eval_fn, args = build_federation_setup(
        _plane_model(), fed, test, cfg, "LOOPBACK", softmax_ce,
        extra_ranks=PLANE_SHARDS)
    agg = FedAVGAggregator(net0, size - 1 - PLANE_SHARDS, cfg, eval_fn,
                           test, device="cuda")
    srv = sp.ShardedFedAVGServerManager(
        args, agg, cfg, size, PLANE_SHARDS, round_timeout_s=8.0,
        heartbeat_timeout_s=1.0)
    shards = [sp.AggregatorShardManager(args, r, size, cfg, net0)
              for r in range(1, PLANE_SHARDS + 1)]
    clients = [FedAVGClientManager(args, r, size, fed, step, cfg,
                                   idle_timeout_s=60.0)
               for r in range(PLANE_SHARDS + 1, size)]

    def killer():
        deadline = time.monotonic() + 60.0
        while srv.round_idx < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        shards[-1].finish()  # its receive loop and beats stop

    run_workers([srv.run] + [s.run for s in shards]
                + [c.run for c in clients] + [killer])
    run_s = time.perf_counter() - t0
    h = srv.health()
    kinds = collections.Counter(e["kind"] for e in srv.flight.snapshot())
    losses = [m["loss"] for m in agg.test_history]
    print(f"[{tag}] (b) shard {PLANE_SHARDS} killed after round 0: "
          f"{srv.round_idx} rounds in {run_s:.1f} s, shard evictions "
          f"{h['shard_evictions']}, live shards {h['shards']}, commits "
          f"over the survivor's partial {kinds['round_commit']}, eval "
          f"losses {losses}; {card}", flush=True)
    check(srv.round_idx == PLANE_ROUNDS and not srv.aborted
          and h["shard_evictions"] >= 1 and h["shards"] == PLANE_SHARDS - 1
          and losses and all(math.isfinite(l) for l in losses),
          f"{tag}: the shard drill {h}, flight {dict(kinds)}")
    del agg, srv, shards, clients


class _SimLog:
    """Every delivery of the SIM fabric while active: (virtual s, message
    type, sender, receiver) in event order."""

    def __enter__(self):
        from fedml_tpu_torch.sim import transport

        self.events = []
        self._deliver = deliver = transport.SimNetwork._deliver
        log = self.events

        def spy(network, msg, t_sent=0.0, blob=None):
            log.append((network.events.clock.now, int(msg.get_type()),
                        int(msg.get_sender_id()),
                        int(msg.get_receiver_id())))
            return deliver(network, msg, t_sent, blob)

        transport.SimNetwork._deliver = spy
        return self

    def __exit__(self, *exc):
        from fedml_tpu_torch.sim import transport

        transport.SimNetwork._deliver = self._deliver


def _plane_sim(mode, fed, test, spec, controller=None, **kw):
    """One FleetSimulator run; returns (result, event log, final net,
    uploads, seconds)."""
    from fedml_tpu_torch.algos.fedavg_distributed import (
        MSG_TYPE_C2S_SEND_MODEL_TO_SERVER)
    from fedml_tpu_torch.sim import FleetSimulator, make_fleet_trace

    cfg_kw = kw.pop("cfg", {})
    cfg = _plane_cfg(client_num_per_round=spec.n_devices, **cfg_kw)
    t0 = time.perf_counter()
    with _SimLog() as log:
        sim = FleetSimulator(_plane_model(), fed, test, cfg,
                             make_fleet_trace(spec), mode=mode,
                             controller=controller, device="cuda", **kw)
        res = sim.run()
    took = time.perf_counter() - t0
    net = sim.aggregator.net if mode == "sync" else sim.server.net
    ups = sum(1 for e in log.events
              if e[1] == MSG_TYPE_C2S_SEND_MODEL_TO_SERVER)
    return res, log.events, net, ups, took


def _same_net(a, b):
    from fedml_tpu_torch.core.tree import sorted_leaves

    return all(torch.equal(x, y) for x, y in zip(sorted_leaves(a),
                                                  sorted_leaves(b)))


def _plane_fleet(tag, card, fed, test, step):
    """(c) and (d): the simulator's FedBuff and sync first-k runs twice
    each, the sync mode with secagg, the controllers."""
    from fedml_tpu_torch.algos.fedbuff import FedML_FedBuff_distributed
    from fedml_tpu_torch.ctrl import (FederationController,
                                      controller_from_args)
    from fedml_tpu_torch.sim import FleetSpec

    spec = FleetSpec(**PLANE_SPEC)
    buff = dict(buffer_k=PLANE_BUFF_K,
                cfg=dict(comm_round=PLANE_VERSIONS,
                         frequency_of_the_test=PLANE_EVAL_EVERY))
    # The controller-off pair needs equality, not actuations: half depth.
    off = dict(buff, cfg=dict(buff["cfg"], comm_round=PLANE_VERSIONS // 2))
    ctrl = controller_from_args(PLANE_CTRL)
    names = [p.name for p in ctrl.policies]
    check(names == ["window_schedule", "timeout_autoscale",
                    "staleness_admission"],
          f"{tag}: controller_from_args built {names}")
    with _plane_step(step):
        runs = {}
        for name, mode, ctl, kw in (
                ("fedbuff", "fedbuff", ctrl, buff),
                ("fedbuff again", "fedbuff", ctrl, buff),
                ("fedbuff, no controller", "fedbuff", None, off),
                ("fedbuff, a controller of no policies", "fedbuff",
                 FederationController([]), off),
                ("sync first-k", "sync", None,
                 dict(aggregate_k=PLANE_SYNC_K,
                      cfg=dict(comm_round=PLANE_SYNC_ROUNDS))),
                ("sync first-k again", "sync", None,
                 dict(aggregate_k=PLANE_SYNC_K,
                      cfg=dict(comm_round=PLANE_SYNC_ROUNDS)))):
            res, events, net, ups, took = _plane_sim(mode, fed, test, spec,
                                                     controller=ctl, **kw)
            log = list(ctl.actuation_log) if ctl is not None else None
            runs[name] = (res, events, net, log)
            s = res.summary()
            print(f"[{tag}] (c) FleetSimulator {name}: {took:.1f} s wall, "
                  f"{ups} uploads, {len(events)} deliveries, virtual s "
                  f"{s['virtual_s']}, updates {s['updates']}, completed "
                  f"{s['completed']}, evictions {s['evictions']}, "
                  f"readmissions {s['readmissions']}, churn-killed "
                  f"{s['churn_killed_uploads']}, staleness p95 "
                  f"{s.get('staleness_p95')}, accuracy "
                  f"{s['final_accuracy']}"
                  + (f"; actuations {len(log)}" if log else ""), flush=True)
            check(res.completed and ups > 0, f"{tag}: sim {name}: {s}")
        for a, b in (("fedbuff", "fedbuff again"),
                     ("sync first-k", "sync first-k again")):
            ra, ea, na, la = runs[a]
            rb, eb, nb, lb = runs[b]
            same = (ea == eb and ra.completion_times == rb.completion_times
                    and ra.arrival_log == rb.arrival_log and la == lb)
            print(f"[{tag}] (c) {a} twice: event logs "
                  f"{'identical' if ea == eb else 'DIFFERENT'} "
                  f"({len(ea)} deliveries), actuation logs "
                  f"{'identical' if la == lb else 'DIFFERENT'}, final nets "
                  f"{'bit-equal' if _same_net(na, nb) else 'NOT bit-equal'}",
                  flush=True)
            check(same, f"{tag}: two {a} runs of one seed differ")
        check(runs["fedbuff"][3], f"{tag}: the controller never actuated")
        print(f"[{tag}] (d) the adaptive controller's actuations: "
              f"{json.dumps(runs['fedbuff'][3])[:1500]}", flush=True)
        off, empty = runs["fedbuff, no controller"], runs[
            "fedbuff, a controller of no policies"]
        inert = off[1] == empty[1] and _same_net(off[2], empty[2])
        print(f"[{tag}] (d) no controller vs a controller of no policies: "
              f"{'bit-equal' if inert else 'DIFFERENT'} (event log and "
              "final net)", flush=True)
        check(inert, f"{tag}: an attached controller that proposes nothing "
              "changed the run")

        # The sync mode with secagg over the churn-free twin of the spec.
        calm = FleetSpec(**dict(PLANE_SPEC, mean_online=1.0,
                                arrival_spread_s=0.0))
        with _MaskSpy() as spy:
            res, events, net, ups, took = _plane_sim(
                "sync", fed, test, calm,
                cfg=dict(comm_round=PLANE_SECAGG_ROUNDS, secagg=True,
                         ingest_workers=PLANE_INGEST,
                         round_timeout_s=10.0 ** 6))
        devices = list(range(1, calm.n_devices + 1))
        leaves, wsum, count = _plane_hold_rounds(
            tag, "the sim's secagg", spy, range(PLANE_SECAGG_ROUNDS),
            lambda r: sorted(d for d in devices if (d, r) in spy.clear))
        print(f"[{tag}] (c) FleetSimulator sync with secagg, 32 devices "
              f"online throughout: {took:.1f} s wall, {ups} uploads, "
              f"{res.updates} rounds, reveals {res.health['seed_reveals']}; "
              f"each round's merged total = the clear fold of its "
              f"{count} uploads, bit-equal", flush=True)
        check(res.completed and count == calm.n_devices,
              f"{tag}: the sim's secagg run {res.summary()}")

        # The same controller object, bound anew, on a loopback run.
        t0 = time.perf_counter()
        srv = FedML_FedBuff_distributed(
            _plane_model(), fed, test,
            _plane_cfg(client_num_per_round=8, comm_round=PLANE_LOOP_AGGS,
                       frequency_of_the_test=1),
            buffer_k=PLANE_BUFF_K, controller=ctrl, loopback_wire="tensor",
            device="cuda")
        print(f"[{tag}] (d) the same controller on a loopback FedBuff run "
              f"(8 workers, {PLANE_LOOP_AGGS} aggregations) in "
              f"{time.perf_counter() - t0:.1f} s: actuations "
              f"{json.dumps(ctrl.actuation_log)[:600]}; knobs "
              f"{srv.ctrl.values()}", flush=True)
        check(srv.version == PLANE_LOOP_AGGS and srv._controller is ctrl,
              f"{tag}: the loopback run with the controller")
        del srv, runs


def _plane_cli(tag):
    """(e): main_extra FedBuff --controller adaptive at --model lr, in
    process; the attached controller's actuation log read back."""
    import io

    from fedml_tpu_torch.comm.managers import ServerManager
    from fedml_tpu_torch.exp import main_extra

    attached = []
    attach = ServerManager.attach_controller

    def attach_spy(mgr, controller):
        attached.append(controller)
        return attach(mgr, controller)

    out = io.StringIO()
    t0 = time.perf_counter()
    ServerManager.attach_controller = attach_spy
    try:
        with contextlib.redirect_stdout(out):
            main_extra.main(PLANE_CLI)
    finally:
        ServerManager.attach_controller = attach
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    ctl = attached[0] if attached else None
    print(f"[{tag}] (e) main_extra {' '.join(PLANE_CLI)}: "
          f"{time.perf_counter() - t0:.1f} s; last line {json.dumps(last)}; "
          f"controller {type(ctl).__name__}, actuations "
          f"{len(ctl.actuation_log) if ctl else None}", flush=True)
    check(ctl is not None and last.get("version") == 6
          and math.isfinite(last.get("loss", float("nan"))),
          f"{tag}: main_extra --controller {last}")


def phase_plane():
    """The federation plane's secure, sharded and simulated tiers on the
    card at the flagship's width: (a) secagg and its dropout drill, (b)
    agg_shards and a shard drill, (c) the fleet simulator, (d) the
    controllers, (e) main_extra --controller. Returns {kernel name:
    GroupNorm launches}."""
    tag, card = "plane", smi_line()
    t_phase = time.perf_counter()
    fed, test = _fed_data()
    _zero_gn_counts()
    with _cudnn_deterministic():
        t0 = time.perf_counter()
        step = _plane_secagg(tag, card, fed, test)
        print(f"[{tag}] (a) {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        _plane_shards(tag, card, fed, test, step)
        print(f"[{tag}] (b) {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        _plane_fleet(tag, card, fed, test, step)
        print(f"[{tag}] (c, d) {time.perf_counter() - t0:.1f} s", flush=True)
    fwd, bwd, red, copies, streamed = _gn_counts()
    print(f"[{tag}] GroupNorm launches of (a)-(d): fwd {fwd}, bwd {bwd}, "
          f"reduce {red}, copies {copies}, streamed {streamed}; silo step "
          f"replays {step.replays}", flush=True)
    check(fwd > 0 and bwd > 0 and red > 0, f"{tag}: the plane launched "
          f"GroupNorm fwd {fwd}, bwd {bwd}, reduce {red}")
    del step, fed, test
    _free()
    t0 = time.perf_counter()
    _plane_cli(tag)
    print(f"[{tag}] (e) {time.perf_counter() - t0:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return {"group_norm_fwd": fwd, "group_norm_bwd": bwd}


# The whole script's limit: past it every thread's stack goes to stderr
# and the script exits with 1 (a hang names itself before the runner's
# 1,200 s cut).
WATCHDOG_S = 1150


def main() -> int:
    faulthandler.enable()  # a crash in native code prints the Python stack
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
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
    seconds = {}

    def timed(name, fn, *args):
        print(f"[phase] {name}: start", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[phase] {name}: {seconds[name]:.1f} s", flush=True)
        return out

    timed("build", phase_build)
    entries = ([timed("kernels", phase_kernels, peaks)]
               + timed("flash_bwd", phase_flash_bwd_kernels, peaks)
               + timed("gn", phase_gn_kernels, peaks))
    launches = timed("serve", phase_serve)
    # What a later phase reuses: the FedAvg baselines, and the apis (their
    # captured tiers) that the ckpt phase resumes.
    shared = {}
    launches.update(timed("train", phase_train, shared))
    for name, n in timed("obs", phase_obs, shared).items():
        launches[name] += n
    for phase, fn, args in (("algos", phase_algos, (shared,)),
                            ("custom", phase_custom, (shared,)),
                            ("zoo", phase_zoo, (shared,)),
                            ("split", phase_split, ())):
        for name, n in timed(phase, fn, *args).items():
            launches[name] += n
    extra = timed("extra", phase_extra)
    streamed = extra.pop("streamed")
    for name, n in extra.items():
        launches[name] += n
    for name, n in timed("models", phase_models).items():
        launches[name] += n
    for name, n in timed("cv", phase_cv).items():
        launches[name] += n
    adapter = timed("adapter", phase_adapter, shared)
    vit = timed("vit", phase_vit)
    timed("ckpt", phase_ckpt, shared)
    store = timed("store", phase_store)
    knobs = timed("knobs", phase_knobs)
    dp = timed("dp", phase_dp)
    cli = timed("cli", phase_cli, dp)
    for name, n in timed("fed", phase_fed).items():
        launches[name] += n
    asyn = timed("async", phase_async)
    for name, n in timed("plane", phase_plane).items():
        launches[name] += n
    print(f"[report] flash launches: serve fwd {launches['flash_fwd']}, "
          f"adapter {adapter}, vit {vit}, store {store}, knobs {knobs}, "
          f"dp and cli {cli}, async {asyn}", flush=True)
    adapter["flash_fwd"] += launches["flash_fwd"]
    launches.update(adapter)
    for name, n in (list(vit.items()) + list(store.items())
                    + list(knobs.items()) + list(cli.items())
                    + list(asyn.items())):
        launches[name] += n
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
        if entry["name"] in vit and "vit_f32" in entry:
            entry["vit_f32"]["launches"] = vit[entry["name"]]
        if entry["name"] in streamed:
            entry["streamed_launches"] = streamed[entry["name"]]
    print(f"[phase] seconds: {json.dumps(seconds)}; total "
          f"{sum(seconds.values()):.1f} s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi_line())
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
