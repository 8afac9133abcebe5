"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py                      # the full check, one card
    python3 chip_smoke.py --n-requests 30000   # Fig. 5 cut to 30,000
    python3 chip_smoke.py --profile            # + a torch.profiler phase

Phases, each printing one JSON line; any failure exits non-zero:

1. ``device``    the card's name and power limit (nvidia-smi).
2. ``build``     nvcc builds every kernel source of ``src/repro_torch/csrc``
                 into ``build/kernels/`` (seconds, ptxas report).
3. ``kernel``    each kernel against its plain PyTorch version on the
                 card, at the main path's shapes and beyond. FRP: index
                 exact, f32 weight within rtol 1e-6, f64 bitwise (also
                 with ESFF-H's cold-aware term). The
                 serving kernels (flash and decode attention, RMSNorm
                 with and without the residual add) at Qwen3-4B's
                 shapes in bf16 (RMSNorm also at Mamba2-780M's and
                 Zamba2-2.7B's widths, at decode rows, and through its
                 general body), each within its own limit (KERNEL_TOL;
                 the residual output bitwise), and each case with a
                 planted fault that the limit must reject. Times (CUDA
                 events, back to back, and the device time from
                 torch.profiler) for the kernel, the plain version, one
                 PyTorch call computing the same (a yardstick the port
                 never calls) and the bound. K2 also at a ragged S =
                 2000 and at B = 2, K3 at B = 2, both at head_dim 80
                 (Zamba2-2.7B's shared block, MHA); K2 with a sliding
                 window (WINDOW_CASES, bf16 and f32; its planted faults
                 the band one key too wide and the far edge's 64 keys
                 dropped; SDPA with the band as a boolean mask beside
                 it); K2 at DeepSeek-V3's MLA head dims (q/k 192, v 128,
                 H = KVH = 128) at S = 512 and 2048, bf16 and f32, its
                 planted fault v's last 64 dims dropped; K3-mla
                 (mla_decode.cu, the MLA decode over the latent cache:
                 H = 128, R = 512, DR = 64) at length 0, 511, 2559 of
                 T = 2560 and at B = 2, bf16 and f32, its planted faults
                 the mask one position off and the rope term dropped,
                 with SDPA over the one shared latent head beside it;
                 each row names its body (bf16: the tensor-core body,
                 f32: the CUDA-core body) and holds a repeated call
                 bitwise equal; the bf16 B = 1, length 2559 row is also
                 held and timed on the CUDA-core body; the ptxas report
                 of both bodies.
                 K5 (ssd_chunk)
                 at Mamba2-780M's (S = 2048) and Zamba2-2.7B's (S =
                 1024) full-width shapes, a ragged S = 2000 and g = 8:
                 in the served dtypes (x, B, C bf16: its wgmma body)
                 and with B and C in f32 (x bf16 or f32: its CUDA-core
                 body), within its own limit, each case with two
                 planted faults, the body that ran each case and the
                 ptxas report of both bodies; each body called
                 SSD_REPEATS times on the same inputs, bitwise equal.
                 The backward kernels
                 (training): K2's (flash_attention_bwd.cu) at Qwen3-4B's
                 shapes at B = 4, S = 1024 and a ragged S = 1000 in bf16,
                 at Zamba2-2.7B's shared block (H = KVH = 32, D = 80) in
                 bf16 and at D = 32 and 80 in f32; K5's
                 (ssd_chunk_bwd.cu) at Mamba2-780M's and Zamba2-2.7B's
                 training shapes (B = 4, S = 1024) in bf16, a ragged S =
                 1000 and g = 8 (its wgmma body) and f32 (its CUDA-core
                 body), each row naming its body, with the design's
                 floor beside the bound; K4a's and K4b's (rmsnorm_bwd.cu)
                 at (4096, 2560) and the qk-norm's (131072, 128) rows,
                 with and without the residual's gradient, and in f32:
                 each against the plain backward within its limit, a
                 planted fault rejected, two runs bitwise equal; K2's
                 forward log-sum-exp against torch.logsumexp; times
                 beside the autograd backward of SDPA / F.rms_norm (a
                 yardstick) and the bound.
4. ``main_path`` `repro_torch.api.run_experiment` on the paper's Fig. 5
                 grid (F = 200 functions, the paper's N = 60,000
                 Azure-like requests, the six policies x C = 8..32: 42
                 lanes, queue_cap QUEUE_CAP), with the kernels' launch
                 counts set to 0 just before and read just after. Each
                 policy's lanes are one launch of its variant of the
                 event-loop kernel K0 (one a lane chunk): six launches,
                 K1's own entry never (its FRP scan runs inline in the
                 ESFF variants, one a completion), no built-in policy on
                 the eager loop; the central queue's head scans and
                 OpenWhisk-v2's timer events are counted too. Every
                 lane is held bitwise against the JAX package's own
                 results (scripts/k0_expected.json; ``--n-requests
                 30000`` has constants too). Then each policy's K0
                 alone by CUDA events on the same inputs (ms a launch,
                 us an event on its longest lane), its outputs held
                 bitwise to the runner's launch, and ESFF's at the
                 former queue_cap of 4096, held bitwise to the grid's.
   ``fig6``      Fig. 6: the trace's arrivals scaled by 0.6..1.4
                 (`TraceSource.scaled`) x the six policies at C = 16, at
                 the same N and queue_cap: six launches, bitwise the JAX
                 package's constants.
   ``eager_card`` the eager loop, K0's plain version, on the card (its
                 whole run and ms an event step) and K0 on the same
                 inputs, held bitwise to each other, for every policy at
                 N = EAGER_N (30).
   ``wide``      the same trace with seeds 0-7 x C = 8..32 (200 lanes,
                 ESFF, one lane chunk) at N = 30,000: wall time, req/s,
                 us an event; the seed-0 lanes at Fig. 5's capacities
                 must be bitwise ESFF's constants at N = 30,000.
   ``options``   the engine options: the Fig. 5 trace at C = 16, the six
                 policies (one launch each), with the minute timeline
                 (``tl_bins`` over the trace's minutes, 60 s bins) and a
                 0.35 s deadline, bitwise the JAX package's constants
                 (scripts/cluster_expected.json: counters, sums,
                 histogram, ``tl_*``, ``deadline_miss``,
                 ``slo_attainment``), a planted one-ulp fault in one
                 ``tl_resp_sum`` bin rejected; again at ``window=4096``,
                 bitwise the ``window=0`` run; a Fig. 8 row (ESFF over
                 ``head(20000)`` at C = 16: the three panels' sums,
                 bitwise its constants); each policy's K0 with the
                 options on, timed on the Fig. 5 inputs beside main_path's
                 times with them off, its outputs held bitwise to the
                 runner's launch with those options over Fig. 5's
                 capacities (whose C = 16 cell is the one held above).
   ``static_cluster`` benchmarks/fig_cluster.py's static half: routers
                 hash and round_robin at K = 1..32 nodes of 32 / K slots
                 and K = 64 of one slot, ESFF and SFF, ``queue_cap``
                 32768; every (entry, node) sub-stream a lane (ragged
                 ``n_live``) of one launch a policy and spec; the merged
                 metrics and ``node_done`` bitwise the JAX constants, a
                 planted one-ulp fault in a merged ``resp_sum`` rejected;
                 launches, wall s, req/s, each policy's K0 alone on the
                 runner's own launch operands (`static_calls`; ms, us an
                 event on the longest lane), its lanes merged as the
                 runner merges them and held bitwise to its cells.
   ``dynamic_cluster`` benchmarks/fig_cluster.py's dynamic half: routers
                 jsq2 and cold_aware at K = 1..32 nodes of 32 / K slots
                 and K = 64 of one slot, ESFF and SFF, ``queue_cap``
                 32768, through the K-node variant of K0
                 (`kernels.event_loop.cluster_loop`): every entry a lane
                 (its own K, capacities, router, seed) of one launch a
                 policy and spec; all 28 cells and ``node_done`` bitwise
                 the JAX constants, a planted one-ulp fault in a cell's
                 ``resp_sum`` rejected; the launches by variant; each
                 policy's K-node launch alone on the runner's own operands
                 (`dynamic_calls`; ms, us an event on the longest lane),
                 held bitwise to the runner's cells; its K = 1 lanes
                 bitwise the single-node K0 on the same trace and
                 capacity; the eager K-node loop (its plain version) on
                 the card at N = CLUSTER_EAGER_N beside the kernel, bitwise.
   ``churn``     benchmarks/fig_churn.py at full size: routers jsq2,
                 cold_aware and slo_aware x K = 2, 4, 8 nodes of 32 / K
                 slots, nodes 1..K-1 on `PeriodicChurn` (60 s, duty 0.7,
                 phases staggered), delays 0.004 i / (K - 1), a 0.35 s
                 deadline, ``queue_cap`` 32768, ESFF and SFF; and the
                 leo-delay spec (K = 4 nodes of 8 slots whose links 1..3
                 follow a `DelaySchedule` swinging 5 ms <-> 80 ms every
                 30 s: jsq2, slo_aware, and slo_aware with fig_churn's
                 churn on top). Every entry a lane of one K-node launch a
                 policy and spec (churn and the schedule are lane flags);
                 every cell, node_done, deadline_miss and slo_attainment
                 bitwise the JAX constants (`--part churn` of
                 scripts/cluster_expected.py), a planted one-ulp fault
                 rejected; done == N, no overflow or stall, node_done
                 summing to N; every churn lane with toggles and
                 re-routes; each policy's launch alone on the runner's
                 operands (ms, us an event, each lane's events, toggles
                 and re-routes, the bound with the drains' work), held
                 bitwise to the runner's; the eager K-node loop on the
                 card beside the kernel on two K = 4 churn lanes at N =
                 CLUSTER_EAGER_N (explicit windows), bitwise.
   ``resilience`` the resilience layer (failure injection, timeouts,
                 retries with backoff, shedding, the circuit breaker; a
                 launch flag of the K-node variant, which also runs the
                 single node and the static tier's sub-streams as K = 1
                 lanes): benchmarks/fig_resilience.py at full size (ESFF,
                 jsq2 at K = 1, 4, 8 nodes of 32 / K slots, fail_prob 0,
                 0.05, 0.15, 0.3 x no_retry, retry3, retry3_jitter,
                 shedding at queue_cap 32768, a 0.35 s deadline: twelve
                 specs, one launch each), its breaker row (K = 4 x 8,
                 retry3) at fail_prob 0.15 and 0.6, and resil-tiers (the
                 five policies without timers at C = 32 under fail_prob
                 0.2, timeouts 2 s, RetryPolicy(3, 0.05, 1, 0.3) and
                 shed_oldest at queue_cap 64: the single node, hash K =
                 4 x 8, slo_aware with delays, cold_aware with
                 fig_churn's churn: three launches a policy). Every cell
                 bitwise `--part resilience` of
                 scripts/cluster_expected.py, conserving its requests
                 (done + shed + failed_exhausted == N) without a stall,
                 the counters each spec must show above 0, a planted
                 one-ulp fault rejected; each launch's lanes (events,
                 retries, sheds, trips) and wall, and the heaviest
                 fig_resilience spec's, the breaker's and resil-tiers'
                 dynamic launches alone on the runner's operands by
                 events (ms, us an event), held bitwise to the runner's;
                 the eager K-node loop on the card beside the kernel (a
                 K = 1 lane and a K = 4 lane with an all-down window
                 under resil-tiers' faults, a K = 4 breaker lane at
                 fail_prob 0.6; N = RESIL_EAGER_N), bitwise.
   ``telemetry`` the trace rail (ExperimentSpec(trace_events=True)):
                 the five cases of scripts/telemetry_expected.py
                 (tests/test_telemetry.py's K = 4 churn + retry spec; the
                 single node, six policies; the static tier, hash K = 3;
                 slo_aware K = 4 with delays; SFF's bulk re-routes under
                 periodic churn) through the traced forms of
                 K0 (csrc/event_loop_traced.cu,
                 csrc/event_loop_cluster_traced_*.cu), with the counts
                 set to 0 just before and read just after: every cell's
                 stream bitwise the JAX package's (record count, kinds,
                 SHA-256 of its columns), the results bitwise the
                 untraced run's; each case cut to TELEMETRY_EAGER_N
                 through the traced eager loops on the card beside the
                 traced kernels, bitwise; Fig. 5's ESFF and SFF lanes
                 traced at full size (records = n_events, ARRIVAL = N,
                 completing EXEC = done, COLD = cold starts, the span
                 responses' sum = mean response x N within 1e-9, results
                 bitwise the main path's), traced and untraced launches
                 timed, relaunches counted; the churn case's Perfetto
                 export validated; a planted fault in one record of a
                 copy of its stream rejected.
   ``scale_out`` the experiment API's scale-out: the Fig. 6 grid as
                 three host shards (``host_shard=(i, 3)``, one launch a
                 chunk a shard keeps), their computed masks disjoint,
                 merged (`ResultSet.merge`) bitwise fig6's ResultSet;
                 ``devices=1`` bitwise too; ``devices`` beyond the host's
                 cards refused (a one-card host cannot run two devices:
                 ``devices >= 2`` is not verified there); each shard's wall.
   ``reference`` K0 on the card against the port's Python reference
                 cluster on the host (`repro_torch.cluster.
                 simulate_cluster_reference`), request for request at
                 tests/test_churn.py's bar (responses within 1e-9,
                 cold starts, node_done and the fault counters exact):
                 jsq2 under periodic churn, slo_aware under a delay
                 schedule, the breaker under faults (the K-node variant),
                 the static tier (hash, mixed capacities and delays),
                 F = 12, N = 400; a planted 1e-6 fault in a response
                 rejected.
   ``audit``     every gate of `repro_torch.analysis` on the card: the
                 carry budget and dtypes of the eager loops' state and
                 K0's buffers, the f32 scan of each event-loop unit's
                 machine code (``cuobjdump -sass``, counts by unit), the
                 grid's launches and forms, K4a/K4b's pinned geometries,
                 the rail's absence from the untraced units, the lint; a
                 failing gate fails the run.
5. ``parity``    the Fig. 5 spec (OpenWhisk-v2 at 50), the options
                 spec, the static cluster's two specs and the dynamic
                 cluster's K = 4 entries (both routers, ESFF and SFF) at
                 N = 100, the churn phase's
                 two specs (cycles scaled to SPAN / 3) and resil-tiers
                 (ESFF and SFF, its cycle scaled alike) at N = 60, on
                 the card (K0 and its K-node variant) and on the CPU (the
                 eager loops), bitwise on every metric; a planted one-ulp
                 fault in ``resp_sum`` must be rejected.
                 The CPU sides run in six worker processes (one thread
                 each, one policy of a spec a job), started in this
                 phase, after every phase whose times are reported.
6. ``model_parity`` the smoke() configs of qwen3-4b, mamba2-780m,
                 zamba2-2.7b and deepseek-moe-16b in f32 on the card, on
                 weights and a prompt made with numpy, through prefill
                 and 8 greedy decode steps, against the JAX package's
                 tokens and logits (the constants below and
                 scripts/model_parity_expected.json: also the MoE
                 capacity path dropping choices, their count exact, and
                 zamba2 with a prompt past its cache); then the same in
                 bf16 (and Mamba2 at head dim 64, so that K5's wgmma
                 body runs; and the MoE model), fed the JAX tokens, each
                 step's logits within 5e-2 of its largest |logit|, with
                 the greedy-token agreement. deepseek-v3-671b (MLA) at
                 the smoke size with its published head dims, f32 with
                 the dense oracle and with the capacity path dropping,
                 and bf16 (its bound plus the JAX package's own bf16
                 distance from its f32 run on the same weights).
7. ``serve``     `repro_torch.serving.EdgeServingEngine` (ESFF, 2 slots)
                 serves 8 requests from three full-width Qwen3-4B
                 functions (SERVE_CATALOGUE); cold starts, executions
                 and responses are measured on the card, and the
                 serving kernels' launch counts, set to 0 just before
                 the run, read just after. Then one warm instance per
                 function splits prefill tok/s from decode ms/token.
8. ``serve_ssm`` the same engine, 2 slots and 6 requests over four
                 full-width functions of the ssm and hybrid families
                 (SERVE_SSM_CATALOGUE: Mamba2-780M chat and summarize,
                 Zamba2-2.7B chat and long: a prompt of 6000 into a
                 cache of 4096); K5 must launch exactly once a layer
                 a prefill of the run, every time through its wgmma
                 body, K2 and K3 (head_dim 80) once a shared-block
                 application, K2 always with the window of the cache.
8b. ``serve_moe`` the same engine on 1 slot, 4 requests over two
                 DeepSeek-MoE-16B functions at published widths and
                 full depth (SERVE_MOE_CATALOGUE); K2 and K3 once a
                 layer a prefill and a decode step; peak memory.
8c. ``serve_mla`` the same engine on 1 slot, 4 requests over two
                 DeepSeek-V3-671B functions at published widths cut to
                 4 layers (3 dense + 1 MoE, MTP's parameters held:
                 SERVE_MLA_CATALOGUE); K2 at head dims (192, 128) once a
                 layer a prefill, K3-mla once a layer a decode step,
                 every time through its tensor-core body, K3 never; peak
                 memory.
9. ``train``     training (TRAIN_FULL and the notes above it), for each
                 of qwen3-4b (dense), mamba2-780m (ssm) and zamba2-2.7b
                 (hybrid): (a) the smoke config in f32 on numpy
                 weights, 5 steps of `repro_torch.launch.train`, each
                 step's loss and grad norm against the JAX package's
                 (scripts/train_expected.json); (b) the full width cut
                 to 2 layers (Zamba2-2.7B to one Mamba2 layer and one
                 shared block: TRAIN_ARCHS), bf16,
                 B = 2, S = 1024: one loss and backward through the
                 kernels (K2, K4a, K4b, K5) and their backward kernels
                 against the plain path, and its launches against the
                 count from the code; for Zamba2-2.7B also at 6 layers
                 (a whole group at attn_every 6) in f32 (TRAIN_DEEP),
                 with a bf16 control that must miss its limit; (c) the full width (36, 48 and 54
                 layers), bf16, f32 moments, global batch 4, S = 1024,
                 6 steps: losses finite and falling by at least 0.5, s
                 a step, tokens/s, peak memory, the model-FLOPs share
                 (``mfu``) and each kernel's launches a step against the
                 count from the code, set to 0 just before the run and
                 read after each step; then (d) crash (``fail_at``)
                 after a checkpoint and restart at Qwen3-4B's (b) size,
                 the resumed run's parameters bitwise the uninterrupted
                 run's.
10. ``profile``  (``--profile`` only) torch.profiler over the Fig. 5
                 run (each policy's K0 device time a launch, the device
                 busy share)
                 and over one served request of each function of both
                 serving phases (busy share, the serving kernels'
                 device time per launch, K5's among them, and the SM
                 clock sampled by nvidia-smi).

Then the card's name and power limit as nvidia-smi prints them, one
``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from dataclasses import replace
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))

# The JAX package's results for the Fig. 5 and Fig. 6 grids, every
# policy, are in scripts/k0_expected.json, made on the CPU with
# (PYTHONPATH=src, JAX_PLATFORMS=cpu)
#   python scripts/k0_expected.py --n 60000 --queue-cap 8192 \
#       --out scripts/k0_expected.json        # and again with --n 30000
# which runs, for each policy, the engine call of
# repro.api.run_experiment (repro.core.jax_engine._simulate over the
# grid's lanes) and keeps the counters, n_events (n_requests +
# cold_starts + the timer events, which the ResultSet does not carry),
# the means as sum * (1 / N) (XLA's spelling of the ResultSet's sum / N)
# and max_response, floats as their repr.
EXPECTED_FILE = os.path.join(HERE, "scripts", "k0_expected.json")
# The JAX package's results for the options, static_cluster,
# dynamic_cluster, churn and resilience phases (the engine options, a Fig.
# 8 row, fig_cluster's two halves, fig_churn and leo-delay,
# fig_resilience and resil-tiers), made on the CPU with
# (PYTHONPATH=src, JAX_PLATFORMS=cpu)
#   python scripts/cluster_expected.py --n 60000 \
#       --out scripts/cluster_expected.json
# whose spec builders the phases share (the script imports JAX only in
# its main).
CLUSTER_EXPECTED_FILE = os.path.join(HERE, "scripts",
                                     "cluster_expected.json")
# the card-vs-CPU parities' N (Fig. 5's and the options'; 2,000 until the
# resilience phase needed the room, 1,000 until the ssm and hybrid train
# runs did: the parity phase took 59.2 s of a 429.9 s smoke at 1,000 on
# an H100 at 700 W; 500 until serve_moe, the window rows and
# hybrid-long needed the room: 44.7 s of a smoke past 500 s on a slow
# host); their CPU sides run in worker processes after the card's timed
# phases
PARITY_N = 100
# Fig. 5's OpenWhisk-v2 parity job runs at half of PARITY_N: at 2,000 its
# timers made it the parity phase's floor (123.3 s of CPU), at 1,000 it
# still took 54 s of the smoke's run (250 until the MoE and window
# phases)
PARITY_N_OWV2 = 50
# the dynamic cluster's parity: N = 100 (1,000 until the ssm and hybrid
# train runs needed the room, 500 until the MoE and window phases), K =
# 4 nodes of 8 slots under both dynamic routers (the CPU side is the
# eager K-node loop)
DYNAMIC_PARITY = dict(n_requests=100, ks=(4,))
# the churn parity: both churn specs at N = 60 (1,000 until the
# resilience phase needed the room: its jobs took ~40 s of CPU each; 500
# until the ssm and hybrid train runs did, 250 until the MoE and window
# phases), their churn cycles and delay swings SPAN / 3 of that trace's
# span, so that outages fall in it
CHURN_PARITY_N = 60
# the static cluster's parity at PARITY_N (2,000 until the resilience
# phase needed the room: its jobs took ~46 s of CPU each)
STATIC_PARITY_N = PARITY_N
# the resilience parity: resil-tiers (ESFF and SFF) at N = 60 (500 until
# the ssm and hybrid train runs, 250 until the MoE and window phases),
# its churn cycle SPAN / 3 of that trace's span
RESIL_PARITY_N = 60
# the K-node variant's plain version on the card: the eager K-node loop
# at this N over the AGG = 32 spec's K = 4 lanes, beside the kernel (100
# until the resilience phase needed the room, 60 until the ssm and hybrid
# train runs did; both churn lanes still re-route at 30: 5 and 8 times)
CLUSTER_EAGER_N = 30
# ... and in the resilience phase at this N (ESFF and SFF; its breaker
# lane trips once at 30, never at 20), and for the K-node variants that
# only that phase runs (ESFF-H, OpenWhisk, FaasCache) at
# RESIL_EAGER_N_OTHERS (15 until the ssm and hybrid train runs; at 8 each
# lane still retries 2 requests and the churn lane re-routes one:
# `resil_eager_quiet` holds every lane to acting)
RESIL_EAGER_N = 30
RESIL_EAGER_N_OTHERS = 8
# the resilience specs whose launches are also timed alone by events
# (each policy's): the heaviest fig_resilience spec, both breaker specs
# and resil-tiers; every other spec's launch is timed by the host clock
# around the runner (one launch a spec)
RESIL_TIMED = ("fp0.3/retry3", "breaker/fp0.15", "breaker/fp0.6",
               "resil-tiers")
PARITY_WORKERS = 6
# K0's launches timed alone by events a case (the median of 3 until the
# MoE and window phases needed the room: the main path's OpenWhisk-v2
# launch alone takes ~2.9 s)
TIMED_REPS = 1
# The JAX package's traced runs (event counts by kind, record counts and
# the SHA-256 of each cell's int32 and f64 columns) for the telemetry
# phase's cases, made on the CPU with (PYTHONPATH=src, JAX_PLATFORMS=cpu)
#   python scripts/telemetry_expected.py
# whose spec builder the phase shares (the script imports JAX only in its
# main).
TELEMETRY_EXPECTED_FILE = os.path.join(HERE, "scripts",
                                       "telemetry_expected.json")
# the telemetry phase: the traced eager loops on the card beside the traced
# kernels on each case cut to this N (40 until the ssm and hybrid train
# runs needed the room, 20 until the MoE and window phases did; at 20
# every case wrote 49-142 records), and the Fig. 5 lanes traced at full
# size for these policies
TELEMETRY_EAGER_N = 12
TELEMETRY_FULL = ("esff", "sff")
POLICIES = ("esff", "esff_h", "sff", "openwhisk", "faascache",
            "openwhisk_v2")
CAPACITIES = (8, 12, 16, 20, 24, 28, 32)
N_REQUESTS = 60000
# Fig. 6 (benchmarks/fig6_intensity.py): the trace's arrivals scaled
# (TraceSource.scaled), at one capacity
RATIOS = (0.6, 0.8, 1.0, 1.2, 1.4)
FIG6_CAPACITY = 16
# OpenWhisk-v2 overruns a queue_cap of 4096 at N = 60,000 in the JAX
# package itself (overflow 1,252 to 2,291 a lane, stalled 1); 8192 is the
# smallest power of two at which every policy of both grids, at N =
# 60,000 and 30,000, ends with overflow 0 and stalled 0 there. It only
# bounds a backlog: a run that never reaches it gives the same results at
# any larger value (main_path holds ESFF's lanes at 4096, the former
# setting, bitwise to those at 8192).
QUEUE_CAP = 8192
# the wide row (ESFF): seeds x capacities as one lane chunk
WIDE = dict(seeds=tuple(range(8)), capacities=tuple(range(8, 33)),
            n_requests=30000)
# the metrics held against the JAX constants
HELD = ("done", "overflow", "stalled", "cold_starts", "evictions",
        "n_events", "mean_response", "mean_slowdown", "max_response")
# the eager loop on the card (eager_card): every policy at N = 30 (a step
# costs ~8-12 ms there; cut from 150 to 100 to make room for the dense
# train phase, to 50 for the ssm and hybrid ones and to 30 for the
# MoE and window phases: the smoke keeps under 450 s)
EAGER_N = 30
# each policy's kernel instantiation: event_loop_kernel<Policy<kind, lru,
# cold_aware, sff>, false> of csrc/event_loop.cu, and its K-node variant
# event_loop_cluster_kernel<..., true>, and how their mangled names
# (ptxas) spell them
POLICY_ARGS = {"esff": (0, 0, 0, 0), "esff_h": (0, 1, 1, 0),
               "sff": (1, 0, 0, 1), "openwhisk": (1, 0, 0, 0),
               "faascache": (2, 0, 0, 0), "openwhisk_v2": (3, 0, 0, 0)}
PTXAS_NAME = {p: "PolicyILi{}ELb{}ELb{}ELb{}EEELb0E".format(*a)
              for p, a in POLICY_ARGS.items()}
PTXAS_NAME_CLUSTER = {p: "PolicyILi{}ELb{}ELb{}ELb{}EEELb1E".format(*a)
                      for p, a in POLICY_ARGS.items()}
# the policies of benchmarks/fig_cluster.py (the static and dynamic halves)
CLUSTER_POLICIES = ("esff", "sff")
# the JAX policy kernel each variant carries out
POLICY_SOURCE = {"esff": "src/repro/core/jax_policies.py:59",
                 "esff_h": "src/repro/core/jax_policies.py:59",
                 "sff": "src/repro/core/jax_policies.py:149",
                 "openwhisk": "src/repro/core/jax_policies.py:149",
                 "faascache": "src/repro/core/jax_policies.py:242",
                 "openwhisk_v2": "src/repro/core/jax_policies.py:295"}
TRACE_KW = dict(utilization=0.2, exec_median=0.1, exec_sigma=1.4,
                burst_frac=0.3)
RTOL = 1e-9

# NVIDIA H100 SXM data sheet: HBM3 rate, f32 and f64 rates outside the
# tensor cores, dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12, "bf16": 989e12}

# The serving path: three Qwen3-4B functions at full width (36 layers,
# d 2560, 32 heads, 8 kv heads, head_dim 128, d_ff 9728, bf16), random
# weights seeded by the function's id; (name, prompt, new tokens,
# max_len). ESFF on a 2-slot server, 8 requests over 5 s (12 until the
# MLA phase needed the room).
SERVE_ARCH = "qwen3-4b"
SERVE_CATALOGUE = (("chat", 512, 32, 1024), ("summarize", 2048, 8, 2560),
                   ("classify", 256, 1, 512))
SERVE_REQUESTS = dict(n=8, duration=5.0, seed=0)
# the decode steps a warm instance's prefill / decode split times (the
# function's own new tokens, at least 8, until the MoE and window phases
# needed the room)
SERVE_SPLIT_STEPS = 4
# The ssm and hybrid serving path (serve_ssm): Mamba2-780M (48 layers, d
# 1536, 48 SSM heads of 64, state 128, chunk 256, bf16) and Zamba2-2.7B
# (54 Mamba2 layers at d 2560, 80 heads of 64, state 64, a shared MHA
# block of 32 heads of 80 every 6 layers) at full width, random weights
# seeded by the function's id; (name, arch, prompt, new tokens,
# max_len). The prompt of 2000 pads its last chunk (8 chunks of 256).
# hybrid-long sends Zamba2 a prompt of 6000 into a cache of 4096 (its
# long_context_window): the shared block's K2 runs with the sliding
# window W = 4096 (S % W = 1904), the cache keeps the last 4096 keys and
# decode writes the ring (summarizing a long document on an edge server
# that bounds its cache). ESFF on a 2-slot server, 6 requests in 5 s (12
# until the MoE and window phases needed the room).
SERVE_SSM_CATALOGUE = (("ssm-chat", "mamba2-780m", 512, 32, 1024),
                       ("ssm-summarize", "mamba2-780m", 2000, 8, 2048),
                       ("hybrid-chat", "zamba2-2.7b", 1024, 16, 1280),
                       ("hybrid-long", "zamba2-2.7b", 6000, 8, 4096))
SERVE_SSM_REQUESTS = dict(n=6, duration=5.0, seed=0)
# The MoE serving path (serve_moe): DeepSeek-MoE-16B at published widths
# and full depth (28 layers, the first dense at d_ff 10944, then 64
# routed experts top-6 + 2 shared of d_ff 1408, 16 MHA heads of 128,
# vocab 102400; 16.4 B parameters, 32.8 GB in bf16), random weights
# seeded by the function's id; (name, arch, prompt, new tokens, max_len).
# ESFF on a 1-slot server (one 32.8 GB instance warm: every switch of
# function is a cold start and an eviction), 4 requests in 5 s (6 at seed
# 0 until the MLA phase needed the room; seed 2's four reach both
# functions, seed 0's go to the first alone). Users: a sparse 16 B model
# served on one edge card, ~2.8 B parameters active a token.
SERVE_MOE_CATALOGUE = (("moe-chat", "deepseek-moe-16b", 512, 32, 1024),
                       ("moe-summarize", "deepseek-moe-16b", 2048, 8, 2560))
SERVE_MOE = dict(capacity=1, requests=dict(n=4, duration=5.0, seed=2))
# The MLA serving path (serve_mla): DeepSeek-V3-671B at published widths
# (d 7168, 128 heads of MLA: q_lora 1536, kv_lora 512, q/k heads of 128
# + 64 rotary dims, v heads of 128; 256 routed experts top-8 + 1 shared
# of d_ff 2048; dense d_ff 18432; vocab 129280) cut in depth to 4 layers,
# the published 3 dense and 1 MoE, with MTP's parameters held (15.8 B
# parameters, ~31.6 GB in bf16; two MoE layers would be 54.6 GB), random
# weights seeded by the function's id; (name, arch, prompt, new tokens,
# max_len). ESFF on a 1-slot server, 4 requests in 5 s (seed 2: the
# first function, the second, the first twice: two switches, each a
# cold start and an eviction). Users: DeepSeek-
# V3's attention and routing at full width on one edge card, its latent
# cache 1,152 bytes a token a layer where MHA's would take 64 KB.
SERVE_MLA_CATALOGUE = (("mla-chat", "deepseek-v3-671b", 512, 32, 1024),
                       ("mla-summarize", "deepseek-v3-671b", 2048, 8, 2560))
SERVE_MLA = dict(capacity=1, requests=dict(n=4, duration=5.0, seed=2))
SERVE_MLA_LAYERS = 4
# The limit of each bf16 serving kernel against its plain version on
# the card, elementwise |kernel - plain| <= atol + rtol * |plain|. Both
# sides compute in f32 and round the output to bf16 once, so they may
# differ by one bf16 ulp of the output (at most 2^-7 of it: rtol 1e-2)
# plus what the order of the f32 sums adds (atol, far below the
# outputs: ~0.03 for decode at length 2559, ~0.1-1 for the others):
# - flash_attention: the tensor-core body also rounds each weight p to
#   bf16 for the value product, a relative error of at most 2^-8 a
#   weight; so its limit adds 2^-8 sum_j p_ij |v_j| / l_i to each
#   element (``p_round``; the plain attention of |v|), which bounds
#   that rounding's effect;
# - decode_attention: f32 throughout, split over blocks (the ranges
#   merged in f32);
# - rmsnorm, rmsnorm_residual: one f32 sum of squares per row.
# - mla_decode_attention (K3-mla): f32 products and softmax, split over
#   blocks and merged in f32 (decode_attention's terms), and in bf16 the
#   softmax weights rounded to bf16 for the product with c_kv on both
#   sides, but at two scales: the plain version (the JAX package's order)
#   rounds the normalized weights, the kernel each block's weights under
#   its running max, so the two roundings of one weight differ by at
#   most 2^-8 of it; its limit adds 2^-8 sum_t p_t |c_kv_t| (``p_round``
#   times the attention of |c_kv|), as K2's ``p_round`` bounds its own
#   rounding. f32 rows are held to the same limit (no rounding of the
#   weights there: the term is slack).
# Every case also holds the kernel against a planted fault in the plain
# version (FAULTS) and fails unless the limit rejects it, so a limit
# that would let a wrong kernel through fails the run.
# - ssd_chunk (K5): inputs widened exactly (x, B and C may be bf16) and
#   f32 outputs on both sides, so only the order of the f32 sums differs
#   (over up to c n products for a score and c for an output); measured
#   at 3.8e-6 on y (mean |y| 2.3) and 3.6e-7 on the states (mean 0.21)
#   at Mamba2-780M's and Zamba2-2.7B's shapes by the CUDA-core body, so
#   atol 3e-5 (8x that) plus rtol 1e-5. The wgmma body is held to the
#   same limit: its products are exact and its weights carry ~24 bits
#   (three bf16 parts); it uses 0.06-0.19 of the limit on y and ~0.01
#   on the states at the same shapes.
# The backward kernels (training), bf16, against the plain backward on
# f32 copies of the same inputs, each output rounded once by the kernel
# (half a bf16 ulp: rtol 1e-2) after f32 sums in another order (atol):
# - flash_attention_backward also reads the forward's output o, rounded
#   to bf16 (2^-9 of it), in Dl = rowsum(do * o); its limit adds 2^-9
#   times what that can move dq and dk (``o_round``,
#   `kernels.flash_attention.backward_o_terms`); dv does not read o. Its
#   bf16 body (tensor cores) also rounds the weights P and their
#   gradients dS to bf16 for dv = P^T do, dk = scale dS^T q and dq =
#   scale dS k, at most 2^-8 of each term; its limit adds 2^-8 times the
#   sums of those terms' magnitudes (``p_round``,
#   `kernels.flash_attention.backward_round_terms`), as the forward's
#   ``p_round`` bounds its rounding of P;
# - rmsnorm_backward, rmsnorm_residual_backward: one f32 sum of squares
#   and one of g w s a row, dw a two-stage f32 sum over the rows.
# In f32 all three are held to F32_GRAD_TOL (tests/test_kernels.py's f32
# TOL).
# - ssd_chunk_backward (K5-bwd), bf16 and f32 inputs alike: both sides
#   widen the same inputs exactly and sum in f32, so only the order of the
#   f32 sums differs (over up to c n products a term, and c terms a sum);
#   an output in bf16 (dx, dB and dC of bf16 inputs) is rounded once on
#   each side, so the two may be one bf16 ulp apart (``out_round``: 2^-7
#   of the value: the limit ``out_round`` |plain| holds one ulp below
#   it, so a bf16 case's use of the limit reaches ~0.95 by design). The
#   f32 outputs' sums reach ~1e2 at the training shapes (mean |ddt| ~147,
#   |dcum| ~21, |dx| ~2); measured at 4.6e-4 at most on Mamba2-780M's
#   shape in f32 (an H100 at 700 W), so atol 2e-3
#   (4.4x that) plus rtol 1e-5.
KERNEL_TOL = {"flash_attention": dict(rtol=1e-2, atol=1e-3,
                                      p_round=2.0 ** -8),
              "decode_attention": dict(rtol=1e-2, atol=1e-3),
              "mla_decode_attention": dict(rtol=1e-2, atol=1e-3,
                                           p_round=2.0 ** -8),
              "rmsnorm": dict(rtol=1e-2, atol=1e-3),
              "rmsnorm_residual": dict(rtol=1e-2, atol=1e-3),
              "ssd_chunk": dict(rtol=1e-5, atol=3e-5),
              "flash_attention_backward": dict(rtol=1e-2, atol=1e-3,
                                               o_round=2.0 ** -9,
                                               p_round=2.0 ** -8),
              "rmsnorm_backward": dict(rtol=1e-2, atol=1e-3),
              "rmsnorm_residual_backward": dict(rtol=1e-2, atol=1e-3),
              "ssd_chunk_backward": dict(rtol=1e-5, atol=2e-3,
                                         out_round=2.0 ** -7)}
F32_GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
# the planted faults: attention without one tile of 64 kv positions (or,
# with a single valid position, with one position too many); RMSNorm
# with the last eighth of each row left out of the sum of squares
FAULTS = {"flash_attention": "kv tile [S/2, S/2 + 64) dropped",
          "flash_attention_mla": "v's last 64 dims dropped (a kernel "
                                 "that reads only Dv = 64)",
          "mla_decode_attention": "the mask one position too long (at "
                                  "length T - 1, one too short); the "
                                  "rope term dropped",
          "decode_attention": "kv tile of 64 around length/2 dropped "
                              "(length 0: position 1 attended too)",
          "rmsnorm": "last D/8 of the row left out of the sum of squares",
          "rmsnorm_residual": "last D/8 of the row left out of the sum "
                              "of squares",
          "ssd_chunk": "y: the diagonal term s = t left out; states: the "
                       "last position t = c - 1 left out",
          "flash_attention_backward": "the gradient of attention without "
                                      "the kv tile [S/2, S/2 + 64)",
          "rmsnorm_backward": "the gradient of RMSNorm with the last D/8 "
                              "of the row left out of the sum of squares",
          "rmsnorm_residual_backward": "the gradient of RMSNorm with the "
                                       "last D/8 of the row left out of "
                                       "the sum of squares",
          "ssd_chunk_backward": "the gradient of K5 without the causal "
                                "tile pair s in [64, 128), t in [0, 64)"}

# K2's window rows (S, W, H, KVH, D), in bf16 and f32: Zamba2-2.7B's
# shared block with a prompt of 6000 into its cache of 4096 (the
# serve_ssm hybrid-long function), Qwen3-4B's heads at W 1000, and
# windows of 63 and 64 keys, where one key is a large share of a row
WINDOW_CASES = ((6000, 4096, 32, 32, 80), (2048, 1000, 32, 8, 128),
                (512, 63, 32, 8, 128), (512, 64, 32, 8, 128))
# K2's MLA rows (S, H = KVH, D, Dv), bf16 and f32: DeepSeek-V3's prefill
# of the serve_mla functions' prompts; K3-mla's rows (B, T, length) at
# H = 128, (R, DR) = (512, 64), bf16 and f32
MLA_FLASH_CASES = ((512, 128, 192, 128), (2048, 128, 192, 128))
MLA_DECODE_CASES = ((1, 2560, 0), (1, 2560, 511), (1, 2560, 2559),
                    (2, 2560, 2559))
# the serving kernels in the `kernels` line: (name, the TPU kernel it
# replaces, the kernel-phase case whose times the line carries: the
# serving path's largest)
SERVING_KERNELS = (
    ("flash_attention", "flash_attention.cu",
     "src/repro/kernels/flash_attention.py:79", "causal S=2048"),
    ("decode_attention", "decode_attention.cu",
     "src/repro/kernels/decode_attention.py:66", "T=2560 length=2559"),
    ("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:34",
     "(2048, 2560)"),
    ("rmsnorm_residual", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:59",
     "(2048, 2560)"),
    ("ssd_chunk", "ssd_chunk.cu", "src/repro/kernels/ssd_chunk.py:54",
     "mamba2-780m S=2048 bf16"),
    ("mla_decode_attention", "mla_decode.cu",
     "src/repro/models/model.py:970", "mla B=1 T=2560 length=2559 bf16"),
)
# the backward kernels in the `kernels` line: (name, source, what they
# replace: the JAX package has no backward Pallas kernel, and jax.grad
# differentiates the plain attention and norm of its model; the
# kernel-phase case whose times the line carries: the train phase's
# full-width shapes)
TRAINING_KERNELS = (
    ("flash_attention_backward", "flash_attention_bwd.cu",
     "src/repro/models/layers.py:251", "jax.grad of chunked_attention",
     "bf16 B=4 S=1024"),
    ("rmsnorm_backward", "rmsnorm_bwd.cu", "src/repro/models/layers.py:70",
     "jax.grad of rms_norm", "(4096, 2560)"),
    ("rmsnorm_residual_backward", "rmsnorm_bwd.cu",
     "src/repro/models/layers.py:70",
     "jax.grad of rms_norm after the residual add", "(4096, 2560) gres"),
    ("ssd_chunk_backward", "ssd_chunk_bwd.cu",
     "src/repro/models/mamba.py:50",
     "jax.grad of ssd_chunked (its intra-chunk block)",
     "mamba2-780m bf16 B=4 S=1024"),
)
# the backward kernels' instances whose ptxas lines the `kernels` line
# carries: the bf16 bodies at the train phase's shapes (K2-bwd at D 128;
# the norms' vector body with bf16 x and weight)
TRAINING_PTXAS = {
    "flash_attention_bwd": ("dkdv_wgmma_kernelILi128E",
                            "dq_wgmma_kernelILi128E",
                            "delta_kernelI13__nv_bfloat16Li128ELb1E",
                            "dkdv_wgmma_kernelILi80E",
                            "dq_wgmma_kernelILi80E",
                            "delta_kernelI13__nv_bfloat16Li80ELb1E"),
    # K5-bwd's wgmma body at n = 128 (Mamba2) and 64 (Zamba2), its group
    # and split passes; the CUDA-core body's f32 instance at n = 128
    "ssd_chunk_bwd": ("ssd_bwd_main_kernelILi2E",
                      "ssd_bwd_main_kernelILi1E",
                      "ssd_bwd_group_kernel", "ssd_bwd_split_kernel",
                      "ssd_chunk_bwd_kernelIffLi2E"),
    "rmsnorm_bwd": ("rmsnorm_bwd_vector_kernelI13__nv_bfloat16S1_Li1E",
                    "dw_kernelI13__nv_bfloat16E")}
# The train phase. (a) the qwen3-4b smoke config in f32 on
# `parity_weights`, held step by step to the JAX package's losses and
# grad norms (scripts/train_expected.json, made by
# scripts/train_expected.py, which also holds the run's settings): the
# first loss within TRAIN_RTOL_FIRST, every later number within
# TRAIN_RTOL. (b) TRAIN_CUT: Qwen3-4B at full width cut to 2 layers, bf16,
# B = 2, S = 1024, one loss and backward through the kernels against the
# same with the kernels swapped for their plain versions (autograd through
# them: the plain backwards), the loss and each gradient's norm-wise
# relative error within the bf16 rtol of KERNEL_TOL. (c) TRAIN_FULL: Qwen3-4B
# at full width (36 layers), bf16, f32 moments, `launch.train` for
# ``steps`` steps; the losses finite and falling by TRAIN_LOSS_DROP
# (tests/test_train.py::test_loss_decreases' bar). (d) crash and restart
# at TRAIN_CUT's size: ``fail_at`` after a checkpoint at ``ckpt_every``,
# resumed, bitwise the uninterrupted run; its moments in bf16 (AdamW's
# ``moment_dtype``), which halves the bytes a checkpoint of its ~1 B
# parameters writes (the vocabulary's two 389 M-entry tables dominate).
TRAIN_EXPECTED_FILE = os.path.join(HERE, "scripts", "train_expected.json")
TRAIN_RTOL_FIRST = 1e-5
TRAIN_RTOL = 1e-3
TRAIN_CUT = dict(n_layers=2, global_batch=2, seq_len=1024)
# the trained families: arch -> (b)'s cut of the depth (the dense family's
# TRAIN_CUT; Mamba2-780M at 2 layers; Zamba2-2.7B at one Mamba2 layer and
# one shared-block application, K2 and K2-bwd at head dim 80, after it);
# (a), (b) and (c) each run for every arch, (c) at TRAIN_FULL's batch,
# length, steps and lr. Gate (b) compares two bf16 paths whose roundings
# differ, so it can only be as tight as the plain path's gradients are
# determined: scripts/train_grad_breakdown.py --perturb-ssd multiplies
# K5's output by 1 + 1e-6 z on the plain path and measures the
# gradients' move. For Zamba2-2.7B cut to 6 layers (a group of 6, then
# the shared block) that move is 5.7-7.5 % and the kernel path's 5.0-5.7
# %, at 2 layers 1.0 % and 0.95 %, at 1 layer 0.71 % and 0.72 % (an H100
# at 700 W). Each bf16 Mamba2 layer compounds the plain path's rounding,
# so the bf16 cut keeps one layer and the 1 % limit stays; the served
# group size is held in f32 (TRAIN_DEEP).
TRAIN_ARCHS = {"qwen3-4b": dict(n_layers=TRAIN_CUT["n_layers"]),
               "mamba2-780m": dict(n_layers=2),
               "zamba2-2.7b": dict(n_layers=1, attn_every=1)}
# (b) deep: the hybrid family at its served group size, Zamba2-2.7B cut to
# 6 layers (one whole group at attn_every 6, then the shared block on
# concat(h, h0)), in f32, where the plain path is determined: the kernel
# path against the plain path, loss and each gradient norm-wise within
# TRAIN_DEEP_RTOL. The kernel path read 6.5e-5 there (its worst gradient,
# A_log; scripts/train_grad_breakdown.py --perturb-ssd, an H100 at 700 W),
# the limit is ~8x that. The control: the bf16 kernel path on the same
# weights (rounded) and batch, against the same f32 plain path, must miss
# the limit (it reads 28.8 %, its worst gradient w_bc), so that the
# limit is shown to see an error of bf16's size.
TRAIN_DEEP = dict(arch="zamba2-2.7b", n_layers=6, attn_every=6)
TRAIN_DEEP_RTOL = 5e-4
# (c) runs 6 steps (10 until the MLA phase needed the room: the full-width
# losses fell 2.8-3.7 by step 5 on an H100 at 700 W, TRAIN_LOSS_DROP 0.5)
TRAIN_FULL = dict(arch="qwen3-4b", steps=6, global_batch=4, seq_len=1024,
                  lr=3e-4, seed=0)
TRAIN_LOSS_DROP = 0.5
TRAIN_RESTART = dict(steps=4, ckpt_every=2, fail_at=3, seed=5,
                     moment_dtype="bfloat16")

# model_parity: the smoke() configs of qwen3-4b, mamba2-780m and
# zamba2-2.7b in f32, weights and prompt from numpy (`parity_weights`,
# `parity_tokens`), greedy decoding. The JAX package's result, computed
# on the CPU with (PYTHONPATH=src:., JAX_PLATFORMS=cpu; the same weights
# through its parameter tree), for each arch of PARITY_CASES:
#   import jax, jax.numpy as jnp, numpy as np, chip_smoke as cs
#   from repro.configs.registry import get_arch
#   from repro.models import build_model
#   case = cs.PARITY_CASES[arch]
#   cfg = get_arch(arch).smoke(); m = build_model(cfg)
#   abstract = m.init_abstract()[0]
#   flat = {".".join(k.key for k in path): leaf.shape for path, leaf
#           in jax.tree_util.tree_flatten_with_path(abstract)[0]}
#   w = cs.parity_weights(np, flat)
#   params = jax.tree_util.tree_map_with_path(lambda path, leaf:
#       jnp.asarray(w[".".join(k.key for k in path)]), abstract)
#   toks = cs.parity_tokens(np, cfg.vocab_size, case["prompt_len"])
#   cache = m.cache_spec(1, case["max_len"]).zeros()
#   logits, cache = m.prefill(params, {"tokens": jnp.asarray(toks)}, cache)
#   out = [int(jnp.argmax(logits[0, -1]))]
#   for _ in range(cs.PARITY["steps"]):
#       logits, cache = m.decode_step(params, jnp.asarray([[out[-1]]]),
#                                     cache)
#       out.append(int(jnp.argmax(logits[0, -1])))
#   last = np.asarray(logits[0, -1], np.float64)
#   tokens = out; head = last[:16].tolist()
#   l2 = float(np.linalg.norm(last)); top5 = np.argsort(-last)[:5].tolist()
# Held at rtol = atol = 2e-4 (tests/test_kernels.py's f32 TOL); tokens
# exact. The ssm and hybrid prompts span several chunks (80 positions at
# the smoke chunk of 32), and their A_log, dt_bias and D are drawn so
# that the SSM state carries across them (`parity_weights`).
PARITY = dict(seed=0, steps=8)
PARITY_CASES = {
    "qwen3-4b": dict(prompt_len=16, max_len=32, expected=dict(
        tokens=[109, 109, 109, 109, 197, 109, 197, 499, 109],
        head=[0.379649817943573, 0.20407500863075256, -1.714565634727478,
              -0.757085382938385, -0.9032574892044067, 0.9934298396110535,
              -0.32991284132003784, 0.024288363754749298,
              -1.0093311071395874, 0.5340211391448975, 0.8158217072486877,
              -0.031137609854340553, -0.3577105402946472,
              -2.7966647148132324, 1.069676160812378, 0.5712822675704956],
        l2=22.92498078263572, top5=[109, 499, 207, 417, 459])),
    "mamba2-780m": dict(prompt_len=80, max_len=96, expected=dict(
        tokens=[96, 322, 269, 142, 15, 145, 87, 198, 54],
        head=[-0.3030654191970825, 0.3607064187526703, 0.27357152104377747,
              0.33041974902153015, 0.4164256453514099, -0.8068743944168091,
              2.6302826404571533, 0.9608327746391296, 0.4020775258541107,
              -0.5312789678573608, 1.3507639169692993, 2.0768024921417236,
              -1.5179356336593628, 0.30655622482299805, 0.7198376655578613,
              0.6450364589691162],
        l2=22.064299519144427, top5=[54, 64, 6, 391, 326])),
    "zamba2-2.7b": dict(prompt_len=80, max_len=96, expected=dict(
        tokens=[20, 199, 42, 106, 504, 176, 388, 378, 12],
        head=[-0.8232154846191406, 1.0594764947891235, -0.7592185139656067,
              -0.0631871446967125, -0.266035795211792, -0.7335025668144226,
              0.7261479496955872, 0.029081862419843674, -0.9029608964920044,
              0.1253446787595749, -1.5731626749038696, -0.906587541103363,
              2.591974973678589, 0.35452720522880554, 0.4741246700286865,
              1.6971371173858643],
        l2=22.521312696958773, top5=[12, 504, 199, 121, 44])),
}
PARITY_TOL = dict(rtol=2e-4, atol=2e-4)
# More rows, made by scripts/model_parity_expected.py (its docstring has
# the recipe; rerun it after touching `parity_weights`): the MoE family's
# smoke config in f32 (the dense oracle; then the capacity dispatch at a
# capacity factor where the prefill drops choices, the count held
# exactly) and in bf16, Zamba2's smoke config with a prompt of 80 into a
# cache of 48 (the sliding window, S % W = 32), and DeepSeek-V3's (MLA)
# smoke config at its published head dims (q/k 192 = 128 + 64 rotary,
# v 128, kv_lora 512: K2 at (192, 128), K3-mla at (512, 64)) in f32 with
# both impls and in bf16 (its bound widened by the JAX package's own
# bf16 distance from f32, ``own``).
PARITY_EXPECTED_FILE = os.path.join(HERE, "scripts",
                                    "model_parity_expected.json")
# The bf16 rows of model_parity: the same smoke() configs (and Mamba2-780M's
# at head dim 64, state 64 and chunk 64, so that its prefill takes K5's
# wgmma body) with params and activations in bf16, on the same weights
# cast to bf16. The port is fed the JAX package's greedy tokens, and each
# step's logits are held at PARITY_BF16_TOL of that step's largest
# |logit| (the bound of the tier-1 bf16 tests, test_torch_model.py and
# test_torch_mamba.py) at the JAX top-5 and at logits[:8]; greedy-token
# agreement is reported, and a token that differs where the JAX top-2 gap
# exceeds the bound fails the row. The JAX package's steps, computed on
# the CPU with (PYTHONPATH=src:., JAX_PLATFORMS=cpu), for each row:
#   case = cs.PARITY_BF16_CASES[row]
#   cfg = get_arch(case["arch"]).smoke().replace(**case["config"])
#   m = build_model(cfg); abstract, flat, w as for f32 above
#   params = jax.tree_util.tree_map_with_path(lambda path, leaf:
#       jnp.asarray(w[".".join(k.key for k in path)], cfg.pdtype), abstract)
#   toks = cs.parity_tokens(np, cfg.vocab_size, case["prompt_len"])
#   cache = m.cache_spec(1, case["max_len"]).zeros()
#   logits, cache = m.prefill(params, {"tokens": jnp.asarray(toks)}, cache)
#   steps = []
#   for i in range(cs.PARITY["steps"] + 1):
#       steps.append(cs.parity_step(np, np.asarray(logits[0, -1],
#                                                  np.float64)))
#       if i < cs.PARITY["steps"]:
#           logits, cache = m.decode_step(
#               params, jnp.asarray([[steps[-1][0]]]), cache)
PARITY_BF16_TOL = 5e-2
_BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
PARITY_BF16_CASES = {
    "qwen3-4b smoke bf16": dict(arch="qwen3-4b", config=_BF16,
                                prompt_len=16, max_len=32, steps=[
        (109, 3.3281, 0.5938, [109, 34, 459, 499, 207],
         [3.1094, 2.5156, 2.3594, 2.2812, 2.2656],
         [0.3828, 0.2969, -1.3359, -0.4648,
          -1.5, 1.4297, -0.5156, -0.334]),
        (109, 3.5938, 0.125, [109, 463, 132, 31, 72],
         [2.5312, 2.4062, 2.3438, 2.25, 2.2344],
         [-0.0718, 0.3262, -1.2422, -0.377,
          -0.8945, 1.0312, 0.4316, -0.5234]),
        (109, 3.5, 0.2188, [109, 463, 197, 31, 132],
         [2.6406, 2.4219, 2.3594, 2.2969, 2.1875],
         [0.0194, 0.4512, -1.3438, -0.3789,
          -0.8828, 1.1562, 0.5078, -0.6523]),
        (109, 3.5469, 0.0625, [109, 197, 463, 31, 499],
         [2.7031, 2.6406, 2.3281, 2.2344, 2.2344],
         [0.2617, 0.5234, -1.3906, -0.2969,
          -0.8242, 1.3203, 0.6445, -0.8164]),
        (197, 3.5938, 0.1562, [197, 109, 499, 463, 202],
         [2.8438, 2.6875, 2.3125, 2.125, 2.125],
         [0.5508, 0.625, -1.4219, -0.1963,
          -0.7539, 1.4766, 0.8125, -1.0859]),
        (109, 3.2656, 0.1406, [109, 499, 72, 34, 207],
         [2.7344, 2.5938, 2.4688, 2.3906, 2.2031],
         [0.625, 0.1562, -1.6797, -0.0304,
          -0.9102, 1.3984, 0.0126, -0.2754]),
        (197, 3.5781, 0.2656, [197, 109, 499, 72, 215],
         [2.8281, 2.5625, 2.3594, 2.1562, 2.1406],
         [0.5898, 0.6797, -1.4375, -0.1494,
          -0.6758, 1.2969, 0.7852, -1.1328]),
        (499, 3.5625, 0.2812, [499, 109, 72, 207, 463],
         [2.9062, 2.625, 2.4062, 2.1562, 2.0781],
         [0.6367, 0.3652, -1.625, -0.2539,
          -0.6055, 1.25, -0.0698, -0.2207]),
        (109, 3.1875, 0.4375, [109, 499, 207, 417, 459],
         [3.0312, 2.5938, 2.2969, 2.1562, 2.1094],
         [0.3848, 0.2178, -1.7188, -0.7656,
          -0.8945, 0.9805, -0.3105, 0.0117]),
    ]),
    "mamba2-780m smoke bf16": dict(arch="mamba2-780m", config=_BF16,
                                   prompt_len=80, max_len=96, steps=[
        (96, 2.7969, 0.0625, [96, 435, 473, 263, 160],
         [2.7656, 2.7031, 2.5938, 2.375, 2.375],
         [-0.5859, -0.3906, -0.0405, -1.5312,
          1.3594, -1.5469, -0.3789, 1.7188]),
        (322, 3.1406, 0.0469, [322, 122, 30, 87, 494],
         [2.8438, 2.7969, 2.6406, 2.5312, 2.4844],
         [1.5781, -0.1592, -0.5938, 0.793,
          0.5234, -0.7383, 0.8008, 0.5]),
        (269, 3.5938, 0.0781, [269, 404, 463, 26, 198],
         [2.4219, 2.3438, 2.2188, 2.1719, 2.0938],
         [1.3281, 0.8516, -0.3965, 0.1689,
          -0.1543, -1.4453, -1.4375, 0.793]),
        (142, 4.0, 1.0, [142, 238, 270, 198, 156],
         [4.0, 3.0, 2.5469, 2.3906, 2.2812],
         [0.3203, 0.0021, -0.5117, 0.168,
          -1.2266, 0.0684, 2.0625, 0.248]),
        (15, 3.2031, 0.5625, [15, 193, 73, 370, 291],
         [3.2031, 2.6406, 2.5156, 2.5156, 2.375],
         [-0.334, 0.543, -0.793, -0.9492,
          0.2734, 1.5703, 1.5391, 0.3398]),
        (145, 3.2344, 0.1562, [145, 263, 287, 73, 341],
         [3.2344, 3.0781, 2.8594, 2.7188, 2.5312],
         [-1.6172, 0.6641, -1.5, 1.2344,
          -1.0781, 0.0085, 1.1562, -2.2969]),
        (87, 3.375, 0.2812, [87, 431, 507, 420, 207],
         [3.3281, 3.0469, 2.8125, 2.5781, 2.4688],
         [-0.0737, 0.6602, -1.1172, -0.3926,
          -0.0383, -0.5586, -0.2598, 0.1001]),
        (198, 4.125, 1.1719, [198, 276, 143, 28, 404],
         [4.125, 2.9531, 2.6875, 2.3906, 2.3438],
         [1.5859, 0.21, 1.3906, -0.2695,
          -0.9023, 0.8711, -1.7734, 0.5]),
        (54, 3.2344, 0.0312, [54, 64, 6, 391, 326],
         [2.7344, 2.7031, 2.6562, 2.5312, 2.3125],
         [-0.2363, 0.3535, 0.2354, 0.2539,
          0.3828, -0.7539, 2.6562, 1.0]),
    ]),
    "zamba2-2.7b smoke bf16": dict(arch="zamba2-2.7b", config=_BF16,
                                   prompt_len=80, max_len=96, steps=[
        (20, 3.2656, 0.0156, [20, 59, 388, 154, 170],
         [3.2656, 3.25, 2.9844, 2.4219, 2.4062],
         [-1.2578, 1.2266, -1.3672, -0.3164,
          -0.8867, -1.3594, 0.2793, 1.4766]),
        (199, 3.2188, 0.2969, [199, 419, 44, 187, 12],
         [3.2188, 2.9219, 2.3125, 2.2812, 2.25],
         [-2.375, 0.9805, 0.2188, -0.4062,
          0.0065, 0.8203, 0.0815, 0.5039]),
        (42, 3.4375, 0.5625, [42, 261, 403, 208, 102],
         [3.3438, 2.7812, 2.5312, 2.3281, 2.1875],
         [-0.6328, 0.3379, -1.2969, -1.0547,
          -1.1016, 0.2578, 0.4395, -0.3555]),
        (106, 3.75, 0.0156, [106, 42, 326, 102, 177],
         [2.1719, 2.1562, 2.0938, 2.0469, 1.9922],
         [-0.3672, 0.2812, -1.1484, -1.2812,
          -1.7422, 1.0938, 0.0918, 0.1445]),
        (504, 3.3281, 0.4062, [504, 285, 262, 431, 401],
         [3.3281, 2.9219, 2.5, 2.4844, 2.4062],
         [-1.3203, 0.4023, -1.3438, -0.832,
          -1.3516, 0.6445, 1.0859, -0.0981]),
        (176, 2.7969, 0.2031, [176, 170, 361, 400, 504],
         [2.7656, 2.5625, 2.5, 2.4531, 2.2656],
         [-0.8359, 1.1562, -1.5703, -0.3184,
          -1.0, 0.2676, -0.6719, -0.1396]),
        (388, 3.2812, 0.1562, [388, 500, 298, 44, 467],
         [2.5938, 2.4375, 2.2344, 2.2031, 2.1875],
         [0.875, 0.0757, -0.0791, 0.668,
          -1.5938, -0.2969, -0.1494, 0.0312]),
        (378, 2.7344, 0.1719, [378, 503, 401, 197, 20],
         [2.6875, 2.5156, 2.3594, 2.0469, 2.0],
         [-0.7461, 0.1143, -1.5781, -0.3906,
          -0.9922, -0.0134, -0.8203, 0.0299]),
        (12, 2.6719, 0.0, [12, 504, 199, 121, 44],
         [2.5469, 2.5469, 2.4844, 2.3438, 2.25],
         [-0.832, 1.0781, -0.7461, -0.0488,
          -0.2578, -0.7305, 0.7461, 0.0757]),
    ]),
    "mamba2-780m smoke bf16 p64 n64 chunk64": dict(
        arch="mamba2-780m", config=dict(_BF16, ssm_headdim=64, ssm_state=64,
                                        ssm_chunk=64),
        prompt_len=80, max_len=96, k5_body="wgmma", steps=[
        (321, 4.1562, 0.2969, [321, 360, 378, 294, 119],
         [3.4531, 3.1562, 2.7969, 2.5781, 2.5312],
         [-0.5703, -0.0615, 1.7031, -0.5078,
          -0.6797, 0.4277, 0.1777, 0.3379]),
        (466, 3.3281, 0.2344, [466, 381, 288, 272, 329],
         [2.7969, 2.5625, 2.3438, 2.25, 2.25],
         [-1.3047, -1.7344, 0.377, -0.9336,
          0.127, -0.582, -0.6094, 1.1797]),
        (112, 3.4219, 0.6719, [112, 257, 288, 128, 180],
         [3.4219, 2.75, 2.6719, 2.4375, 2.2344],
         [-0.7383, -0.5625, -0.7383, -0.9453,
          0.9375, -0.1006, -0.0161, -0.007]),
        (467, 3.2188, 0.5, [467, 53, 316, 477, 465],
         [3.2188, 2.7188, 2.6562, 2.5781, 2.5781],
         [-0.1133, 0.8945, -0.1162, -1.4297,
          -0.2109, -0.3457, -1.0078, -0.0275]),
        (317, 3.2031, 0.6406, [317, 39, 355, 23, 280],
         [3.2031, 2.5625, 2.5, 2.4688, 2.2656],
         [-0.8789, -0.8125, 0.9883, -0.6445,
          0.2559, -0.6094, -2.0, -0.4238]),
        (107, 3.3438, 0.3281, [107, 212, 301, 408, 41],
         [2.7812, 2.4531, 2.4219, 2.2031, 2.1406],
         [0.2715, 0.1602, 0.2168, -2.0312,
          -0.4414, -1.2969, 0.9648, -1.4531]),
        (292, 2.7188, 0.0312, [292, 96, 427, 418, 81],
         [2.25, 2.2188, 2.1719, 2.125, 2.125],
         [0.5781, -0.3242, 0.8594, -0.3203,
          -1.5469, 1.3281, 0.3477, -0.0339]),
        (270, 3.1094, 0.2188, [270, 369, 206, 10, 173],
         [3.1094, 2.8906, 2.8438, 2.8438, 2.625],
         [-0.0537, 0.2559, -1.1875, -0.9453,
          -0.7539, -0.7812, 0.4219, 0.248]),
        (380, 4.0, 0.0938, [380, 467, 469, 245, 327],
         [2.9219, 2.8281, 2.5156, 2.4375, 2.375],
         [-0.0981, -2.0312, 0.0297, -0.0708,
          0.7305, 0.8125, -0.5781, 0.0549]),
    ]),
}


def parity_step(np, logits):
    """What a bf16 row keeps of one step's logits (f64, over the vocab):
    (the greedy token, the largest |logit|, the top-2 gap, the top-5
    ids, their logits, logits[:8]), rounded to 4 decimals."""
    top = np.argsort(-logits)[:5]
    r = lambda a: [round(float(v), 4) for v in a]  # noqa: E731
    return (int(top[0]), round(float(np.abs(logits).max()), 4),
            round(float(logits[top[0]] - logits[top[1]]), 4),
            [int(i) for i in top], r(logits[top]), r(logits[:8]))


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(torch, fn, reps: int = 200, trials: int = 7) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up."""
    return time_in_turns(torch, [fn], reps, trials)[0]


def time_in_turns(torch, fns, reps: int = 200, trials: int = 7):
    """`time_ms` of each of ``fns``, which take turns inside every trial
    (the first of a trial rotating), so that a slow spell of the host or
    the card falls on all of them alike; 5 warm-up calls each first (20
    until the MoE and window phases needed the room)."""
    for fn in fns:
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    ts = [[] for _ in fns]
    for t in range(trials):
        for k in range(len(fns)):
            i = (t + k) % len(fns)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fns[i]()
            e1.record()
            e1.synchronize()
            ts[i].append(e0.elapsed_time(e1) / reps)
    return [sorted(x)[len(x) // 2] for x in ts]


def device_split(torch, fn, reps: int = 20):
    """Device ms of one call of ``fn`` by kernel name (torch.profiler):
    for each kernel it launches, the mean device time of the records the
    profiler kept, times the launches a call makes (its records / reps,
    rounded, at least 1). The profiler can drop records; dividing its
    total by ``reps`` would then read low."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / e.count
            * max(1, round(e.count / reps)) / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count}


def device_ms(torch, fn, reps: int = 10):
    """Device time of one call of ``fn`` over ``reps`` calls (20 until the
    MoE and window phases needed the room): the sum of `device_split`'s
    kernels; None when it records no device activity."""
    ms = sum(device_split(torch, fn, reps).values())
    return ms if ms > 0 else None


def bound_ms(n_bytes: int, n_ops: int, kind: str):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ------------------------------------------------------------ phase 3
def frp_inputs(np, F, seed, *, lanes=None):
    """Random FRP inputs in the ranges of tests/test_kernels.py."""
    r = np.random.default_rng(seed)
    shape = (F,) if lanes is None else (lanes, F)
    return dict(t_e=r.uniform(0.001, 10, shape), t_l=r.uniform(0.5, 1.5,
                shape), t_v=r.uniform(0.5, 1.5, shape),
                n_w=r.integers(0, 5, shape), K=r.integers(0, 3, shape))


def phase_kernel(torch, np, fs):
    dev = torch.device("cuda")
    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    res = {"phase": "kernel", "f32": [], "lanes": None}

    # f32 contract (the TPU kernel's own): random rows, an all-invalid
    # row and a tie
    cases = []
    for F, seed in ((200, 0), (65536, 1)):
        a = frp_inputs(np, F, seed)
        cases.append((f"random F={F}", a, 1.0, 3))
    a = frp_inputs(np, 200, 2)
    a["n_w"][:] = 0
    cases.append(("all invalid F=200", a, 1.0, 3))
    a = frp_inputs(np, 200, 3)
    a["n_w"][:] = 0
    for f in (17, 42, 150):   # three identical valid candidates
        a["t_e"][f], a["t_l"][f], a["t_v"][f] = 2.0, 1.0, 1.0
        a["n_w"][f], a["K"][f] = 3, 1
    cases.append(("tie F=200", a, 1.0, 3))
    for name, a, tv_j, self_idx in cases:
        args = [torch.tensor(a[k], dtype=f32, device=dev)
                for k in ("t_e", "t_l", "t_v")]
        args += [torch.tensor(a[k], dtype=i32, device=dev)
                 for k in ("n_w", "K")]
        kw, ki = fs.frp_select(*args, tv_j, self_idx)
        pw, pi = fs.frp_select_plain(*args, tv_j, self_idx)
        torch.cuda.synchronize()
        kw, ki, pw, pi = float(kw), int(ki), float(pw), int(pi)
        need(ki == pi, f"frp_select {name}: index {ki} != plain {pi}")
        if name.startswith("all invalid"):
            need(ki == -1, f"frp_select {name}: index {ki} != -1")
        if name.startswith("tie"):
            need(ki == 17, f"frp_select {name}: index {ki} != 17")
        if ki >= 0:
            need(math.isclose(kw, pw, rel_tol=1e-6, abs_tol=0.0),
                 f"frp_select {name}: weight {kw!r} vs plain {pw!r}")
        row = dict(case=name, index=ki, weight=kw,
                   abs_err=abs(kw - pw) if ki >= 0 else 0.0)
        if name.startswith("random"):
            F = a["t_e"].shape[0]
            b, by = bound_ms(F * 20 + 8, F * 15, "f32")
            row.update(ms=time_ms(torch, lambda: fs.frp_select(
                *args, tv_j, self_idx)),
                plain_ms=time_ms(torch, lambda: fs.frp_select_plain(
                    *args, tv_j, self_idx)),
                bound_ms=b, bound_by=by)
        res["f32"].append(row)

    # f64 engine contract at the main path's shape (7 lanes x F = 200)
    L, F = len(CAPACITIES), 200
    a = frp_inputs(np, F, 4, lanes=L)
    r = np.random.default_rng(5)
    jc = r.integers(0, F, L)
    lanes = [torch.tensor(a[k], dtype=f64, device=dev)
             for k in ("t_e", "t_l", "t_v")]
    lanes += [torch.tensor(a[k], dtype=i32, device=dev)
              for k in ("n_w", "K")]
    lanes += [lanes[2][torch.arange(L, device=dev),
                       torch.tensor(jc, device=dev)].contiguous(),
              torch.tensor(jc, dtype=i32, device=dev),
              torch.tensor(r.uniform(0.5, 2.0, L), dtype=f64, device=dev)]
    kw, ki = fs.frp_select_lanes(*lanes)
    pw, pi = fs.frp_select_lanes_plain(*lanes)
    torch.cuda.synchronize()
    need(torch.equal(ki, pi), f"frp_select_lanes: index {ki.tolist()} "
         f"!= plain {pi.tolist()}")
    need(torch.equal(kw, pw), "frp_select_lanes: weights not bitwise "
         f"equal to the plain version ({kw.tolist()} vs {pw.tolist()})")
    # ESFF-H's cold-aware term: the COLD slots a function (at most K)
    coldK = torch.minimum(lanes[4], torch.tensor(
        r.integers(0, 3, (L, F)), dtype=i32, device=dev)).contiguous()
    cw, ci = fs.frp_select_lanes(*lanes, coldK)
    cpw, cpi = fs.frp_select_lanes_plain(*lanes, coldK)
    torch.cuda.synchronize()
    need(torch.equal(ci, cpi) and torch.equal(cw, cpw),
         "frp_select_lanes with coldK: not bitwise the plain version "
         f"({ci.tolist()} vs {cpi.tolist()})")
    b, by = bound_ms(L * F * 32 + L * 32, L * F * 15, "f64")
    res["lanes"] = dict(
        shape=[L, F], index=ki.tolist(), cold_aware_index=ci.tolist(),
        max_abs_err=max(float((kw - pw).abs().max()),
                        float((cw - cpw).abs().max())),
        ms=time_ms(torch, lambda: fs.frp_select_lanes(*lanes)),
        plain_ms=time_ms(torch, lambda: fs.frp_select_lanes_plain(*lanes)),
        bound_ms=b, bound_by=by)
    res["library_ms"] = None
    res["library_note"] = "no single PyTorch call computes FRP selection"
    emit(res)
    return res


# --------------------------------------------------------- phases 4, 5
def load_expected():
    with open(EXPECTED_FILE) as f:
        exp = json.load(f)
    need(exp["queue_cap"] == QUEUE_CAP,
         f"{EXPECTED_FILE}: made at queue_cap {exp['queue_cap']}, the "
         f"grids run at {QUEUE_CAP}")
    return exp


def fig5_spec(api, n_requests: int, device: str, policies=POLICIES, **kw):
    src = api.SyntheticTrace.make(n_functions=200, n_requests=n_requests,
                                  seed=0, **TRACE_KW)
    kw.setdefault("capacities", CAPACITIES)
    return api.ExperimentSpec(traces=[src], policies=policies,
                              queue_cap=QUEUE_CAP, device=device, **kw)


def fig6_spec(api, n_requests: int, device: str):
    src = api.SyntheticTrace.make(n_functions=200, n_requests=n_requests,
                                  seed=0, **TRACE_KW)
    return api.ExperimentSpec(traces=[src.scaled(r) for r in RATIOS],
                              policies=POLICIES,
                              capacities=(FIG6_CAPACITY,),
                              queue_cap=QUEUE_CAP, device=device)


def lanes_of(rs, metric, policy):
    """A policy's lanes of a ResultSet, in the engine's lane order
    (trace, then capacity), as Python numbers."""
    pi = rs.coords["policy"].index(policy)
    return rs[metric][pi].reshape(-1).tolist()


def held_against(exp, got, labels):
    """The mismatches of ``got`` (metric -> per-lane values) against the
    constants ``exp``: integers exact, floats within RTOL, and whether
    every value was bitwise equal."""
    mismatch, bitwise = [], True
    for k in HELD:
        for lab, g, w in zip(labels, got[k], exp[k]):
            bitwise &= g == w
            ok = (g == w if isinstance(w, int)
                  else math.isclose(g, w, rel_tol=RTOL, abs_tol=0.0))
            if not ok:
                mismatch.append(f"{k}[{lab}]: {g!r} != {w!r}")
    return mismatch, bitwise


def fig5_inputs(torch, api, n_requests, dev, queue_cap=QUEUE_CAP):
    """`engine.simulate`'s inputs for the Fig. 5 lanes, as the runner
    lowers them (one trace, one lane a capacity)."""
    a = fig5_spec(api, n_requests, "cpu").expanded_traces()[0].arrays()
    f64 = torch.float64
    t = {k: torch.tensor(a[k], dtype=torch.int64 if k == "fn_id"
                         else f64, device=dev)[None]
         for k in ("fn_id", "arrival", "exec_time", "cold_start", "evict")}
    C, L = max(CAPACITIES), len(CAPACITIES)
    masks = torch.tensor([[i < c for i in range(C)] for c in CAPACITIES],
                         device=dev)
    args = (t["fn_id"], t["arrival"], t["exec_time"], t["cold_start"],
            t["evict"], torch.zeros(L, dtype=torch.int64, device=dev), masks,
            torch.ones(L, dtype=f64, device=dev), 0.1)
    return args, dict(n_fns=len(a["cold_start"]), capacity=C,
                      queue_cap=queue_cap, stream=True)


def with_beta(torch, args, kernel):
    """``args`` with every lane's beta set to the policy's default, as
    the runner sets it."""
    beta = torch.full_like(args[7], kernel.default_beta)
    return args[:7] + (beta,) + args[8:]


# the raw outputs of a K0 launch that a ResultSet also carries
K0_KEYS = ("done", "n_events", "resp_sum", "slow_sum", "max_response",
           "resp_hist", "cold_starts", "cold_time", "evictions",
           "overflow", "stalled")
# and those of the engine options (timeline, deadlines)
OPTION_OUT = ("tl_count", "tl_resp_sum", "tl_exec_sum", "deadline_miss")


def k0_differs(np, out, want, policy=None, keys=K0_KEYS):
    """The ``keys`` in which K0's raw outputs ``out`` differ at all from
    ``want``: another launch's outputs, or a ResultSet of the Fig. 5
    lanes (``policy``'s, trace 0, every capacity, beta 0)."""
    def lanes(v):
        if hasattr(v, "cpu"):
            return v.cpu().numpy()
        return v[want.coords["policy"].index(policy), 0, :, 0]
    return [k for k in keys
            if not np.array_equal(lanes(out[k]), lanes(want[k]))]


def k0_timed(torch, K0, kernel, args, kw, reps=TIMED_REPS):
    """K0 alone on ``args`` by CUDA events (not counted in a path's
    launches): the median time (ms), the last launch's outputs and its
    (L, 3) policy counts (FRP scans, head scans, timer events)."""
    ms = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = K0.event_loop(*args, kernel=kernel, **kw)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    variant = K0.variant_of(kernel)
    return (sorted(ms)[reps // 2], out,
            K0.event_loop.last_by_variant[variant].tolist())


def k0_bound(n_requests, n_fns, lanes, n_events, counts, timers_pick):
    """K0's least time on the card for this run's work: the trace read
    once (fn_id, arrival, exec_time, pos_rids: 32 B a request; pos_off,
    t_cold, t_evict by function) and the results written once (counters,
    sums, histogram, policy counts), against the f64 operations: ~12 a
    function an FRP scan (the mean, Eq. 7, Eq. 10, the compare), ~4 a
    function a head scan (the mean, the compare), 2 a function an event
    for OpenWhisk-v2's pick over its timer rail (``timers_pick``), and
    ~20 an event (the pick, the handlers, the fold). ``counts`` holds
    each lane's (FRP scans, head scans, timer events)."""
    n_bytes = (32 * n_requests + 8 * (n_fns + 1) + 16 * n_fns
               + lanes * (9 * 8 + 6 * 8 + 64 * 4 + 3 * 8))
    events = sum(n_events)
    n_ops = (12 * n_fns * sum(c[0] for c in counts)
             + 4 * n_fns * sum(c[1] for c in counts)
             + (2 * n_fns * events if timers_pick else 0) + 20 * events)
    return bound_ms(n_bytes, n_ops, "f64")


def reset_counts(fs, K0):
    fs.frp_select.launches = 0
    fs.frp_select_lanes.launches = 0
    for entry in (K0.event_loop, K0.cluster_loop):
        entry.launches = 0
        entry.variant_launches = {}
        entry.traced_launches = {}
        entry.last_by_variant = {}


def check_counts(K0, phase, kernels, lanes, n_requests, got, counts):
    """Each policy's policy counts of its launch: one FRP scan a
    completion in the ESFF variants (none elsewhere), head scans in the
    central queue's, and the timer events (the events that are neither
    a slot's nor an arrival) in OpenWhisk-v2's."""
    for p, kernel in kernels.items():
        v = K0.variant_of(kernel)
        c = counts[v]
        frp = [x[0] for x in c]
        head = [x[1] for x in c]
        tmr = [x[2] for x in c]
        timers = [e - n_requests - d - k for e, d, k in
                  zip(got[p]["n_events"], got[p]["done"],
                      got[p]["cold_starts"])]
        need(frp == (got[p]["done"] if v.startswith("esff")
                     else [0] * lanes),
             f"{phase}: {p}: inline FRP scans {frp}, not one a completion "
             "in an ESFF variant and none elsewhere")
        central = v in ("sff", "fifo", "faascache")
        need(all((h > 0) == central for h in head),
             f"{phase}: {p}: head scans {head}")
        need(tmr == (timers if v == "openwhisk_v2" else [0] * lanes),
             f"{phase}: {p}: timer events {tmr}, expected {timers}")


def run_grid(torch, api, fs, K0, spec):
    """One run of ``spec`` on the card with the launch counts set to 0
    just before and read just after: the ResultSet, the wall time, the
    launches (all, by variant, K1's own entry, the eager loop's) and
    each variant's policy counts."""
    for src in spec.expanded_traces():
        src.arrays()                      # trace generation is set-up
    reset_counts(fs, K0)
    plain0 = K0.event_loop.plain_calls + K0.cluster_loop.plain_calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = api.run_experiment(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(event_loop=K0.event_loop.launches,
                    by_variant=dict(K0.event_loop.variant_launches),
                    cluster_loop=K0.cluster_loop.launches,
                    cluster_by_variant=dict(K0.cluster_loop.variant_launches),
                    frp_select=fs.frp_select_lanes.launches,
                    plain_calls=(K0.event_loop.plain_calls
                                 + K0.cluster_loop.plain_calls - plain0))
    counts = {v: c.tolist() for v, c in K0.event_loop.last_by_variant.items()}
    counts.update({f"cluster:{v}": c.tolist() for v, c in
                   K0.cluster_loop.last_by_variant.items()})
    return rs, wall, launches, counts


def check_grid(K0, phase, rs, launches, counts, exp, labels, n_requests):
    """The launches and policy counts of a grid's run, and each policy's
    lanes against its JAX constants ``exp`` (None: not held): (per-policy
    results, mismatches, bitwise)."""
    from repro_torch.core.policies import KERNELS
    kernels = {p: KERNELS[p] for p in POLICIES}
    rs.check()
    chunks = -(-len(labels) // rs.meta["lane_chunk"])
    want = {K0.variant_of(k): chunks for k in kernels.values()}
    need(launches["event_loop"] == len(POLICIES) * chunks
         and launches["by_variant"] == want,
         f"{phase}: event_loop launched {launches['by_variant']}, not once "
         f"a policy a lane chunk ({want})")
    need(launches["frp_select"] == 0,
         f"{phase}: frp_select_lanes launched {launches['frp_select']} "
         "times: K1 runs inline in K0 on this path")
    need(launches["plain_calls"] == 0,
         f"{phase}: a built-in policy took the eager loop "
         f"({launches['plain_calls']} calls)")
    got = {p: {k: lanes_of(rs, k, p) for k in HELD} for p in POLICIES}
    check_counts(K0, phase, kernels, len(labels), n_requests, got, counts)
    mismatch, bitwise = [], exp is not None
    for p in POLICIES if exp is not None else ():
        mm, bw = held_against(exp[p], got[p], labels)
        mismatch += [f"{p}: {m}" for m in mm]
        bitwise &= bw
    return got, mismatch, bitwise


def phase_main_path(torch, np, api, fs, K0, exp_all, n_requests):
    from repro_torch.core.policies import KERNELS
    spec = fig5_spec(api, n_requests, "cuda")
    rs, wall, launches, counts = run_grid(torch, api, fs, K0, spec)
    exp = exp_all["fig5"].get(str(n_requests))
    labels = [f"C={c}" for c in CAPACITIES]
    got, mismatch, bitwise = check_grid(K0, "main_path", rs, launches,
                                        counts, exp, labels, n_requests)
    # each policy's K0 alone by events on the Fig. 5 inputs lowered
    # again, held bitwise to the runner's launch above, so the timed
    # work is its
    args, kw = fig5_inputs(torch, api, n_requests, torch.device("cuda"))
    per = {}
    for p in POLICIES:
        kernel = KERNELS[p]
        v = K0.variant_of(kernel)
        k0_ms, out, pc = k0_timed(torch, K0, kernel,
                                  with_beta(torch, args, kernel), kw)
        differs = k0_differs(np, out, rs, p)
        need(not differs and pc == counts[v],
             f"main_path: {p}: the timed K0 launches differ from the "
             f"runner's in {differs} (policy counts {pc} vs {counts[v]})")
        steps = max(got[p]["n_events"])
        b, by = k0_bound(n_requests, kw["n_fns"], len(CAPACITIES),
                         got[p]["n_events"], pc, v == "openwhisk_v2")
        per[p] = dict(variant=v, k0_ms=k0_ms, n_events=got[p]["n_events"],
                      longest_lane_events=steps,
                      k0_us_per_event=1e3 * k0_ms / steps,
                      bound_ms=b, bound_by=by,
                      mean_response=got[p]["mean_response"],
                      cold_starts=got[p]["cold_starts"],
                      policy_counts=[sum(x[i] for x in pc)
                                     for i in range(3)])
    # queue_cap only bounds a backlog: ESFF's lanes at the former 4096
    # are bitwise the runner's at QUEUE_CAP
    args4, kw4 = fig5_inputs(torch, api, n_requests, torch.device("cuda"),
                             queue_cap=4096)
    _, out4, _ = k0_timed(torch, K0, KERNELS["esff"],
                          with_beta(torch, args4, KERNELS["esff"]), kw4,
                          reps=1)
    cap_differs = k0_differs(np, out4, rs, "esff")
    need(not cap_differs, f"main_path: ESFF at queue_cap 4096 differs from "
         f"{QUEUE_CAP} in {cap_differs}")
    res = dict(phase="main_path", n_requests=n_requests,
               capacities=list(CAPACITIES), policies=list(POLICIES),
               queue_cap=QUEUE_CAP, wall_s=wall,
               req_per_s=len(POLICIES) * len(CAPACITIES) * n_requests / wall,
               events_total=sum(sum(got[p]["n_events"]) for p in POLICIES),
               k0_ms_total=sum(r["k0_ms"] for r in per.values()),
               per_policy=per, launches=launches,
               esff_queue_cap_4096_bitwise=True,
               held_against_jax=exp is not None, bitwise_vs_jax=bitwise,
               mismatch=mismatch)
    emit(res)
    need(not mismatch, "main_path: differs from the JAX package: "
         + "; ".join(mismatch))
    need(exp is None or bitwise,
         "main_path: within RTOL of the JAX package but not bitwise")
    return res, rs


def phase_fig6(torch, api, fs, K0, exp_all, n_requests):
    spec = fig6_spec(api, n_requests, "cuda")
    rs, wall, launches, counts = run_grid(torch, api, fs, K0, spec)
    exp = exp_all["fig6"].get(str(n_requests))
    need(exp is not None, f"fig6: no JAX constants at N = {n_requests}")
    labels = [f"ratio={r:g}" for r in RATIOS]
    got, mismatch, bitwise = check_grid(K0, "fig6", rs, launches, counts,
                                        exp, labels, n_requests)
    res = dict(phase="fig6", n_requests=n_requests, ratios=list(RATIOS),
               capacity=FIG6_CAPACITY, queue_cap=QUEUE_CAP, wall_s=wall,
               launches=launches,
               mean_response={p: got[p]["mean_response"] for p in POLICIES},
               n_events={p: got[p]["n_events"] for p in POLICIES},
               bitwise_vs_jax=bitwise, mismatch=mismatch)
    emit(res)
    need(not mismatch, "fig6: differs from the JAX package: "
         + "; ".join(mismatch))
    need(bitwise, "fig6: within RTOL of the JAX package but not bitwise")
    return res, rs


def phase_eager_card(torch, np, api, K0):
    """The plain version of K0, the eager loop, on the card (every op of
    a step its own launch, K1 its own kernel) and K0 on the same inputs,
    for every policy: each one's time, held bitwise to each other."""
    from repro_torch.core import engine as E
    from repro_torch.core.policies import KERNELS
    rows = {}
    for p in POLICIES:
        n = EAGER_N
        kernel = KERNELS[p]
        args, kw = fig5_inputs(torch, api, n, torch.device("cuda"))
        args = with_beta(torch, args, kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = E.simulate_eager(*args, kernel=kernel, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k0_ms, out, _ = k0_timed(torch, K0, kernel, args, kw)
        differs = k0_differs(np, out, eager)
        # the loop runs whole segments of SEG steps until every lane is
        # done
        steps = -(-int(eager["n_events"].max()) // E.SEG) * E.SEG
        rows[p] = dict(n_requests=n, plain_ms=1e3 * wall, event_steps=steps,
                       plain_ms_per_step=1e3 * wall / steps, k0_ms=k0_ms,
                       k0_differs=differs)
    emit(dict(phase="eager_card", rows=rows))
    bad = {p: r["k0_differs"] for p, r in rows.items() if r["k0_differs"]}
    need(not bad, f"eager_card: K0 and the eager loop differ in {bad}")
    return rows


def phase_wide(torch, api, K0, exp_all):
    spec = fig5_spec(api, WIDE["n_requests"], "cuda", policies=("esff",),
                     seeds=WIDE["seeds"], capacities=WIDE["capacities"],
                     lane_chunk=256)
    for src in spec.expanded_traces():
        src.arrays()                      # set-up
    K0.event_loop.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = api.run_experiment(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rs.check()
    lanes = len(WIDE["seeds"]) * len(WIDE["capacities"])
    ix = [WIDE["capacities"].index(c) for c in CAPACITIES]
    got = {k: [rs[k][0, 0, i, 0].item() for i in ix] for k in HELD}
    mismatch, bitwise = held_against(
        exp_all["fig5"][str(WIDE["n_requests"])]["esff"], got,
        [f"C={c}" for c in CAPACITIES])
    ev = rs["n_events"]
    emit(dict(phase="wide", lanes=lanes, n_requests=WIDE["n_requests"],
              launches=K0.event_loop.launches, wall_s=wall,
              req_per_s=lanes * WIDE["n_requests"] / wall,
              events_total=int(ev.sum()), max_lane_events=int(ev.max()),
              us_per_event=1e6 * wall / int(ev.max()),
              bitwise_vs_jax=bitwise, mismatch=mismatch))
    need(K0.event_loop.launches == 1,
         f"wide: {K0.event_loop.launches} launches, not one lane chunk")
    need(bitwise, "wide: seed-0 Fig. 5 lanes differ from the JAX "
         "package: " + "; ".join(mismatch))


def parity_failures(np, card, cpu):
    """Metrics in which two runs' metric dicts differ at all (bitwise),
    or that only one of them has."""
    return sorted(set(card) ^ set(cpu)) + [
        k for k in sorted(set(card) & set(cpu))
        if not np.array_equal(card[k], cpu[k])]


def parity_specs(api, part, device, n_requests=None):
    """The specs that a phase's card-vs-CPU parity runs, each at its N
    (``n_requests`` overrides it; Fig. 5's OpenWhisk-v2 spec keeps
    PARITY_N_OWV2): the Fig. 5 grid (``fig5``: the five other policies,
    then OpenWhisk-v2), the options phase's spec, the static cluster's
    two specs, the dynamic cluster's K = 4 entries, the churn phase's two
    specs with their cycles scaled to the trace, or resil-tiers (ESFF and
    SFF) with its cycle scaled alike."""
    CE = cluster_expected()
    if part == "fig5":
        return [fig5_spec(api, n_requests or PARITY_N, device,
                          policies=POLICIES[:-1]),
                fig5_spec(api, PARITY_N_OWV2, device,
                          policies=POLICIES[-1:])]
    if part == "options":
        return [CE.option_spec(api, n_requests or PARITY_N, device=device)]
    if part == "dynamic_cluster":
        n = n_requests or DYNAMIC_PARITY["n_requests"]
        spec = CE.cluster_specs(api, n, CE.CLUSTER["dynamic_routers"],
                                device=device)[0]
        return [replace(spec, cluster=CE.cluster_entries(
            api, DYNAMIC_PARITY["ks"], CE.CLUSTER["agg"],
            CE.CLUSTER["dynamic_routers"]))]
    if part == "churn":
        n = n_requests or CHURN_PARITY_N
        span = float(CE.trace(api, n).arrays()["arrival"].max())
        return CE.churn_specs(api, n, period=span / 3, device=device)
    if part == "resilience":
        n = n_requests or RESIL_PARITY_N
        span = float(CE.trace(api, n).arrays()["arrival"].max())
        tiers = dict(CE.resilience_specs(api, n, period=span / 3,
                                         device=device))["resil-tiers"]
        return [replace(tiers, policies=CLUSTER_POLICIES)]
    return CE.cluster_specs(api, n_requests or STATIC_PARITY_N,
                            device=device)


def cpu_results(part, index, policy):
    """The CPU side of a parity (the eager loop) for one policy of one of
    the part's specs, as a metric dict, and the seconds it took. Runs in
    a worker process (one thread) while the card's phases run."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    torch.set_num_threads(1)
    from repro_torch import api
    spec = parity_specs(api, part, "cpu")[index]
    t0 = time.perf_counter()
    out = dict(api.run_experiment(replace(spec, policies=(policy,))).data)
    return out, time.perf_counter() - t0


PARITY_PARTS = ("fig5", "options", "static_cluster", "dynamic_cluster",
                "churn", "resilience")


def phase_parity(np, api):
    """The six parities: at N = PARITY_N the Fig. 5 grid (OpenWhisk-v2 at
    PARITY_N_OWV2), the options phase's spec, the static cluster's two
    specs and the dynamic cluster's K = 4 entries, at CHURN_PARITY_N and
    RESIL_PARITY_N the churn phase's two
    specs and resil-tiers (ESFF and SFF), each
    on the card (K0 and its K-node variant)
    against the CPU (the eager loops), bitwise on every metric; a planted
    one-ulp fault in one Fig. 5 lane's ``resp_sum`` must be rejected. The
    CPU sides run in PARITY_WORKERS processes (one thread each, one
    policy of a spec a job), started here, after every phase whose times
    the smoke reports; Fig. 5's OpenWhisk-v2 job (its timers) goes first,
    then the rest in part order. Returns each part's largest absolute
    difference a policy."""
    jobs = [(part, i, p) for part in PARITY_PARTS
            for i, spec in enumerate(parity_specs(api, part, "cpu"))
            for p in spec.policies]
    jobs.sort(key=lambda j: j[::2] != ("fig5", "openwhisk_v2"))
    with multiprocessing.get_context("spawn").Pool(PARITY_WORKERS) as pool:
        pending = {(part, i, p): pool.apply_async(
            cpu_results, (part, i, p)) for part, i, p in jobs}
        return parity_checks(np, api, pending)


def parity_checks(np, api, pending):
    """Each parity's card side and its checks against the workers' CPU
    results ``pending`` ({(part, spec index, policy): AsyncResult})."""
    out, bad, max_abs = {}, [], {}
    fault = None
    for part in PARITY_PARTS:
        t0 = time.perf_counter()
        card = [api.run_experiment(s)
                for s in parity_specs(api, part, "cuda")]
        card_s = time.perf_counter() - t0
        cpu_s, errs, job_s = 0.0, {}, {}
        for i, rs in enumerate(card):
            for p in rs.coords["policy"]:
                cpu, sec = pending[(part, i, p)].get(timeout=1200)
                cpu_s += sec
                job_s[f"{i}:{p}"] = sec
                mine = rs.sel(policy=p).data
                bad += [f"{part}[{i}] {p}: {k}"
                        for k in parity_failures(np, mine, cpu)]
                errs[p] = max([errs.get(p, 0.0)] + [
                    float(np.abs(mine[k].astype(np.float64)
                                 - cpu[k].astype(np.float64)).max())
                    for k in cpu])
                if part == "fig5" and fault is None:
                    # a planted fault: one ulp off in one lane's resp_sum
                    data = dict(mine, resp_sum=mine["resp_sum"].copy())
                    v = data["resp_sum"].reshape(-1)
                    v[3] = np.nextafter(v[3], np.inf)
                    fault = parity_failures(np, data, cpu)
        max_abs[part] = errs
        out[part] = dict(n_requests=[rs.meta["n_requests"] for rs in card],
                         card_s=card_s,
                         cpu_s_total=cpu_s, cpu_s_by_job=job_s,
                         metrics=sorted(card[0].data))
    emit(dict(phase="parity", n_requests=PARITY_N, parts=out, failed=bad,
              max_abs_err=max_abs, planted_fault_caught=fault))
    need(not bad, f"parity: card and CPU differ in {bad}")
    need(fault == ["resp_sum"], f"parity: the planted one-ulp fault in "
         f"resp_sum was not rejected alone ({fault})")
    return max_abs


# ------------------------------------------------ the engine options
def cluster_expected():
    """scripts/cluster_expected.py: the specs of the options and
    static_cluster phases, shared with the script that made their JAX
    constants (it imports JAX only in its main)."""
    import importlib.util
    path = os.path.join(HERE, "scripts", "cluster_expected.py")
    spec = importlib.util.spec_from_file_location("cluster_expected", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cluster_expected():
    with open(CLUSTER_EXPECTED_FILE) as f:
        return json.load(f)


def cell_of(np, rs, keys, **which):
    """One cell's metrics as Python numbers (lists for vector metrics),
    as scripts/cluster_expected.py keeps them."""
    out = {}
    for k in keys:
        v = rs.value(k, **which)
        out[k] = np.asarray(v).tolist() if np.ndim(v) else v
    return out


def held_exact(exp, got):
    """The keys of a cell in which ``got`` differs from the JAX constants
    ``exp`` at all (bitwise), each with its first differing index."""
    bad = []
    for k, w in exp.items():
        if k not in got:
            continue
        g = got[k]
        if isinstance(w, list):
            diff = [i for i, (a, b) in enumerate(zip(g, w)) if a != b]
            if diff or len(g) != len(w):
                bad.append(f"{k}[{diff[0] if diff else len(g)}]")
        elif g != w:
            bad.append(k)
    return bad


def check_launches(phase, launches, want, cluster_want=None):
    need(launches["by_variant"] == want,
         f"{phase}: event_loop launched {launches['by_variant']}, not "
         f"{want}")
    need(launches["cluster_by_variant"] == (cluster_want or {}),
         f"{phase}: its K-node variant launched "
         f"{launches['cluster_by_variant']}, not {cluster_want or {}}")
    need(launches["frp_select"] == 0,
         f"{phase}: frp_select_lanes launched {launches['frp_select']} "
         "times: K1 runs inline in K0 on this path")
    need(launches["plain_calls"] == 0,
         f"{phase}: an option or static-tier run took the eager loop "
         f"({launches['plain_calls']} calls)")


def phase_options(torch, np, api, fs, K0, cexp, n_requests, main, main_rs):
    """The engine options on the card: the Fig. 5 trace at C = 16 with the
    minute timeline and a 0.35 s deadline, the six policies (one launch
    each), bitwise the JAX constants; the same at window=4096, bitwise
    the window=0 run; a Fig. 8 row; each policy's K0 with the options on,
    timed on the Fig. 5 inputs (main_path timed it with them off). Its
    card-vs-CPU parity at N = PARITY_N is in the parity phase."""
    from repro_torch.core.policies import KERNELS
    CE = cluster_expected()
    exp = cexp["options"].get(str(n_requests))
    need(exp is not None, f"options: no JAX constants at N = {n_requests}")
    spec = CE.option_spec(api, n_requests, device="cuda")
    need(spec.tl_bins == exp["tl_bins"], f"options: {spec.tl_bins} bins, "
         f"the constants have {exp['tl_bins']}")
    rs, wall, launches, counts = run_grid(torch, api, fs, K0, spec)
    rs.check()
    check_launches("options", launches,
                   {K0.variant_of(KERNELS[p]): 1 for p in POLICIES})
    mismatch = []
    got = {p: cell_of(np, rs, CE.OPTION_KEYS, policy=p) for p in POLICIES}
    for p in POLICIES:
        mismatch += [f"{p}: {m}" for m in held_exact(exp["policies"][p],
                                                     got[p])]
    # a planted one-ulp fault in the busiest minute's response sum
    bad = dict(got["esff"])
    i = int(np.argmax(bad["tl_count"]))
    bad["tl_resp_sum"] = list(bad["tl_resp_sum"])
    bad["tl_resp_sum"][i] = float(np.nextafter(bad["tl_resp_sum"][i],
                                               np.inf))
    fault = held_exact(exp["policies"]["esff"], bad)
    # window=4096: bitwise the window=0 run, on the card, one launch a
    # policy
    rs_w, _, launches_w, _ = run_grid(torch, api, fs, K0, CE.option_spec(
        api, n_requests, device="cuda", window=4096))
    check_launches("options window=4096", launches_w,
                   {K0.variant_of(KERNELS[p]): 1 for p in POLICIES})
    window_differs = parity_failures(np, rs_w.data, rs.data)
    # the Fig. 8 row: ESFF over head(20000) at C = 16
    f8 = cexp["fig8"].get(str(n_requests))
    need(f8 is not None, f"options: no Fig. 8 constants at N = {n_requests}")
    rs8, wall8, launches8, _ = run_grid(torch, api, fs, K0,
                                        CE.fig8_spec(api, n_requests,
                                                     device="cuda"))
    check_launches("options fig8", launches8, {"esff": 1})
    got8 = cell_of(np, rs8, CE.FIG8_KEYS, policy="esff")
    mismatch += [f"fig8: {m}" for m in held_exact(f8["esff"], got8)]
    cnt = np.asarray(got8["tl_count"])
    fig8 = dict(minutes=len(cnt), busy_minutes=int((cnt > 0).sum()),
                tl_count_sum=int(cnt.sum()),
                tl_exec_sum=float(np.sum(got8["tl_exec_sum"])),
                tl_resp_sum=float(np.sum(got8["tl_resp_sum"])),
                peak_minute_requests=int(cnt.max()),
                peak_minute_mean_response=float(max(
                    r / c for r, c in zip(got8["tl_resp_sum"], cnt) if c)),
                wall_s=wall8, launches=launches8["event_loop"],
                launches_by_variant=launches8["by_variant"])
    # each policy's K0 with the options on, timed on the Fig. 5 inputs and
    # held bitwise to the runner's launch with the same options over the
    # same capacities, whose C = 16 lane is the cell held above
    rs7 = api.run_experiment(replace(spec, capacities=CAPACITIES))
    c16 = rs7.sel(capacity=exp["capacity"])
    runner_differs = parity_failures(np, c16.data, rs.data)
    args, kw = fig5_inputs(torch, api, n_requests, torch.device("cuda"))
    kw_on = dict(kw, tl_bins=exp["tl_bins"], tl_bucket=exp["tl_bucket"],
                 deadlines=torch.full((kw["n_fns"],), exp["deadline"],
                                      dtype=torch.float64, device="cuda"))
    per = {}
    for p in POLICIES:
        k0_ms, out, _ = k0_timed(torch, K0, KERNELS[p],
                                 with_beta(torch, args, KERNELS[p]), kw_on)
        off = main["per_policy"][p]["k0_ms"]
        per[p] = dict(k0_ms_options_on=k0_ms, k0_ms_options_off=off,
                      overhead_pct=100.0 * (k0_ms - off) / off,
                      differs_from_runner=k0_differs(
                          np, out, rs7, p, K0_KEYS + OPTION_OUT),
                      differs_from_fig5=k0_differs(np, out, main_rs, p))
    res = dict(phase="options", n_requests=n_requests,
               capacity=exp["capacity"], queue_cap=exp["queue_cap"],
               tl_bins=exp["tl_bins"], tl_bucket=exp["tl_bucket"],
               deadline=exp["deadline"], wall_s=wall, launches=launches,
               window_4096_launches=launches_w,
               window_4096_differs=window_differs,
               runner_c16_differs=runner_differs,
               mean_response={p: got[p]["mean_response"] for p in POLICIES},
               slo_attainment={p: got[p]["slo_attainment"]
                               for p in POLICIES},
               per_policy=per, fig8=fig8, bitwise_vs_jax=not mismatch,
               mismatch=mismatch, planted_fault_caught=fault)
    emit(res)
    need(not mismatch, "options: differs from the JAX package: "
         + "; ".join(mismatch))
    need(fault == [f"tl_resp_sum[{i}]"], f"options: the planted one-ulp "
         f"fault in tl_resp_sum[{i}] was not rejected alone ({fault})")
    need(not window_differs,
         f"options: window=4096 differs from window=0 in {window_differs}")
    need(not runner_differs, f"options: the runner's C = "
         f"{exp['capacity']} lane over Fig. 5's capacities differs from "
         f"its own run in {runner_differs}")
    bad_k0 = {p: r["differs_from_runner"] + r["differs_from_fig5"]
              for p, r in per.items()
              if r["differs_from_runner"] or r["differs_from_fig5"]}
    need(not bad_k0, f"options: K0 with the options on differs from the "
         f"runner's launch or (in the options-off outputs) from the Fig. 5 "
         f"run in {bad_k0}")
    return res


def phase_static_cluster(torch, np, api, fs, K0, cexp, n_requests):
    """benchmarks/fig_cluster.py's static half on the card: routers hash
    and round_robin at K = 1..32 (AGG = 32) and K = 64 (AGG = 64), ESFF
    and SFF, every (entry, node) a lane of one launch a policy and spec;
    the merged metrics and node_done bitwise the JAX constants; each
    policy's K0 alone on the packed lanes by events. Its card-vs-CPU
    parity at N = STATIC_PARITY_N is in the parity phase."""
    from repro_torch.api.runner import _lower_grid
    from repro_torch.cluster.static import merge_static_lanes, static_calls
    from repro_torch.core.policies import KERNELS
    CE = cluster_expected()
    exp = cexp["static_cluster"].get(str(n_requests))
    need(exp is not None,
         f"static_cluster: no JAX constants at N = {n_requests}")
    dev = torch.device("cuda")
    specs, mismatch, fault = [], [], None
    for spec in CE.cluster_specs(api, n_requests, device="cuda"):
        rs, wall, launches, counts = run_grid(torch, api, fs, K0, spec)
        rs.check()
        lanes = sum(e.n_nodes for e in spec.cluster)
        chunks = -(-lanes // rs.meta["lane_chunk"])
        check_launches("static_cluster", launches,
                       {K0.variant_of(KERNELS[p]): chunks
                        for p in spec.policies})
        for p in spec.policies:
            for e in spec.cluster:
                got = cell_of(np, rs, CE.CLUSTER_KEYS, policy=p,
                              cluster=e.label)
                want = exp["cells"][p][e.label]
                mismatch += [f"{p} {e.label}: {m}"
                             for m in held_exact(want, got)]
                if fault is None and e.n_nodes == 4:
                    # a planted one-ulp fault in a merged resp_sum
                    bad = dict(got, resp_sum=float(np.nextafter(
                        got["resp_sum"], np.inf)))
                    fault = held_exact(want, bad)
        # each policy's K0 alone on the runner's own launch operands
        # (`static_calls`), by events, its lanes merged as the runner
        # merges them and held bitwise to the runner's cells
        _, stacked, F, N = _lower_grid(spec)
        entries = list(spec.cluster)
        kernels = {p: KERNELS[p] for p in spec.policies}
        betas = {p: [KERNELS[p].default_beta] for p in spec.policies}
        calls, _, layout = static_calls(
            spec, entries, stacked, F, kernels, betas, None, dev,
            rs.meta["lane_chunk"])
        need(len(calls) == len(spec.policies),
             f"static_cluster: {len(calls)} engine calls for "
             f"{len(spec.policies)} policies, not one lane chunk each")
        per = {}
        for p, _, _, cargs, ckw in calls:
            ekw = {k: v for k, v in ckw.items()
                   if k not in ("kernel", "keep_responses", "window")}
            k0_ms, out, pc = k0_timed(torch, K0, KERNELS[p], cargs[:9],
                                      dict(ekw, threshold=cargs[9]))
            merged = merge_static_lanes(
                spec, layout, {k: v.cpu().numpy() for k, v in out.items()},
                N)
            differs = []
            for e, m in zip(entries, merged):
                for k in CE.CLUSTER_KEYS + ("n_events",):
                    # (T, KC, B, ...) -> the ResultSet's (P, T, KC, B,
                    # cluster, ...), node_done padded to the widest entry
                    got = np.expand_dims(m[k][None], 4)
                    want = rs.sel(policy=p, cluster=e.label)[k]
                    if k == "node_done":
                        want = want[..., :e.n_nodes]
                    if not np.array_equal(got, want):
                        differs.append(f"{e.label} {k}")
            need(not differs, f"static_cluster: {p}: the timed K0 launch "
                 f"differs from the runner's in {differs}")
            ev = out["n_events"].tolist()
            b, by = k0_bound(N, F, len(ev), ev, pc, False)
            per[p] = dict(k0_ms=k0_ms, lanes=len(ev), events_total=sum(ev),
                          longest_lane_events=max(ev),
                          k0_us_per_event=1e3 * k0_ms / max(ev),
                          bound_ms=b, bound_by=by,
                          held_to_runner=True)
        specs.append(dict(agg=spec.capacities[0],
                          entries=[e.label for e in spec.cluster],
                          lanes=lanes, wall_s=wall, launches=launches,
                          req_per_s=(len(spec.policies) * len(spec.cluster)
                                     * n_requests / wall),
                          per_policy=per))
    res = dict(phase="static_cluster", n_requests=n_requests,
               queue_cap=exp["queue_cap"], specs=specs,
               wall_s=sum(x["wall_s"] for x in specs),
               launches=sum(x["launches"]["event_loop"] for x in specs),
               bitwise_vs_jax=not mismatch, mismatch=mismatch,
               planted_fault_caught=fault)
    emit(res)
    need(not mismatch, "static_cluster: differs from the JAX package: "
         + "; ".join(mismatch))
    need(fault == ["resp_sum"], f"static_cluster: the planted one-ulp "
         f"fault in a merged resp_sum was not rejected alone ({fault})")
    return res


def cluster_timed(torch, K0, args, kw, reps=TIMED_REPS):
    """The K-node variant alone on ``args`` by CUDA events: the median
    time (ms), the last launch's outputs and its (L, 3) policy counts."""
    ms = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = K0.cluster_loop(*args, **kw)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    variant = K0.variant_of(kw["kernel"])
    return (sorted(ms)[reps // 2], out,
            K0.cluster_loop.last_by_variant[variant].tolist())


def cluster_bound(n_requests, n_fns, lanes, n_events, counts, route_ops,
                  extra_bytes=0, extra_ops=0):
    """The K-node variant's least time on the card for this run's work:
    the trace read once (fn_id, arrival, exec_time: 24 B a request;
    t_cold, t_evict by function) and the results written once (counters,
    sums, histogram, policy counts, node_done), against the f64
    operations: `k0_bound`'s per scan and per event, plus the router's
    (``route_ops``: its operations over every lane's arrivals), plus
    ``extra_bytes`` and ``extra_ops`` (churn's operands and drains)."""
    n_bytes = (24 * n_requests + 16 * n_fns
               + lanes * (9 * 8 + 6 * 8 + 64 * 4 + 3 * 8 + 64 * 4)
               + extra_bytes)
    events = sum(n_events)
    n_ops = (12 * n_fns * sum(c[0] for c in counts)
             + 4 * n_fns * sum(c[1] for c in counts) + 20 * events
             + route_ops + extra_ops)
    return bound_ms(n_bytes, n_ops, "f64")


def route_cost(e):
    """One routing decision of entry ``e``: cold_aware and slo_aware ~8
    operations a slot and ~12 a node, JSQ(2) ~4 a slot of its two draws
    and ~12 a draw; none at K = 1 (the pick is node 0)."""
    K, C = e.n_nodes, max(e.node_caps(0))
    if K == 1:
        return 0
    return (K * (8 * C + 12) if e.router in ("cold_aware", "slo_aware")
            else 2 * (4 * C + 12))


def route_ops(entries, n_requests):
    """The router's operations over every arrival of ``entries`` (one
    lane each)."""
    return sum(n_requests * route_cost(e) for e in entries)


# the metrics a timed K-node launch is held to the runner's in, by cell
CLUSTER_SPLIT_KEYS = ("done", "n_events", "resp_sum", "slow_sum",
                      "max_response", "resp_hist", "cold_starts",
                      "cold_time", "evictions", "overflow", "stalled",
                      "node_done")


def cluster_calls(torch, spec, chunk, entries=None):
    """The runner's own K-node calls for ``spec``'s dynamic ``entries``
    (all of its entries by default; `dynamic_calls`, one a policy when a
    chunk holds every lane, with the resilience operands when the spec
    has faults) on the card, with the trace's catalogue size F and
    length N."""
    from repro_torch.api.runner import _lower_grid
    from repro_torch.cluster.runner import dynamic_calls
    from repro_torch.core.policies import KERNELS
    _, stacked, F, N = _lower_grid(spec)
    rs = ()
    if hasattr(spec, "resilience_ops"):   # a checkout with the layer
        from repro_torch.api.runner import lower_resilience
        stacked, rs = lower_resilience(spec, stacked, F)
        rs = (rs,)
    dev = torch.device("cuda")
    kernels = {p: KERNELS[p] for p in spec.policies}
    betas = {p: [KERNELS[p].default_beta] for p in spec.policies}
    dl = spec.deadline_ops(F)
    dl = None if dl is None else torch.as_tensor(dl, device=dev)
    calls, _ = dynamic_calls(spec, list(entries or spec.cluster), stacked,
                             F, kernels, betas, dl, dev, chunk, *rs)
    return calls, stacked, F, N


def cluster_phase(torch, np, api, fs, K0, phase, named_specs, exp, keys,
                  plant, eager):
    """A grid of the dynamic tier on the card, ``named_specs`` ((name,
    spec) pairs), every entry a lane of one launch of K0's K-node variant
    a policy and spec: every cell's ``keys`` bitwise the JAX constants
    ``exp``, a planted one-ulp fault (in the first cell whose entry
    ``plant`` picks) rejected alone; every cell done == N without
    overflow or stall, its node_done summing to N; each policy's launch
    alone on the runner's own operands by events (ms, us an event on the
    longest lane, each lane's events and, under churn, its toggles and
    re-routes, both of which must be > 0), split into cells as the
    runner splits them and held bitwise to the runner's; its K = 1 lanes
    bitwise the single-node K0; and ``eager()`` (`eager_vs_kernel`'s
    rows), the plain version beside the kernel on the card, bitwise."""
    from repro_torch.cluster.runner import horizon_of, split_dynamic_lanes
    from repro_torch.core.policies import KERNELS
    dev = torch.device("cuda")
    specs, mismatch, fault, unfit, k1_differs = [], [], None, [], []
    for name, spec in named_specs:
        rs, wall, launches, counts = run_grid(torch, api, fs, K0, spec)
        rs.check()
        lanes = len(spec.cluster)
        chunks = -(-lanes // rs.meta["lane_chunk"])
        check_launches(phase, launches, {},
                       {K0.variant_of(KERNELS[p]): chunks
                        for p in spec.policies})
        calls, stacked, F, N = cluster_calls(torch, spec,
                                             rs.meta["lane_chunk"])
        for p in spec.policies:
            for e in spec.cluster:
                got = cell_of(np, rs, keys, policy=p, cluster=e.label)
                want = exp["cells"][p][e.label]
                mismatch += [f"{p} {e.label}: {m}"
                             for m in held_exact(want, got)]
                if (got["done"] != N or got["overflow"] or got["stalled"]
                        or sum(got["node_done"]) != N):
                    unfit.append(f"{p} {e.label}")
                if fault is None and plant(e):
                    bad = dict(got, resp_sum=float(np.nextafter(
                        got["resp_sum"], np.inf)))
                    fault = held_exact(want, bad)
        entries = list(spec.cluster)
        horizon = horizon_of(stacked)
        churny = [e.churn_operand(horizon) is not None for e in entries]
        need(len(calls) == len(spec.policies),
             f"{phase}: {len(calls)} engine calls for "
             f"{len(spec.policies)} policies, not one lane chunk each")
        split_keys = CLUSTER_SPLIT_KEYS + (
            ("deadline_miss",) if spec.deadlines is not None else ())
        per = {}
        for p, _, _, cargs, ckw in calls:
            ekw = {k: v for k, v in ckw.items() if k != "keep_responses"}
            ms, out, pc = cluster_timed(torch, K0, cargs[:9],
                                        dict(ekw, threshold=cargs[9]))
            split = split_dynamic_lanes(
                spec, entries, {k: v.cpu().numpy() for k, v in out.items()
                                if k not in ("toggles", "reroutes")}, 1)
            differs = []
            for e, m in zip(entries, split):
                for k in split_keys:
                    got = np.expand_dims(m[k][None], 4)
                    want = rs.sel(policy=p, cluster=e.label)[k]
                    if k == "node_done":
                        want = want[..., :e.n_nodes]
                    if not np.array_equal(got, want):
                        differs.append(f"{e.label} {k}")
            need(not differs, f"{phase}: {p}: the timed K-node launch "
                 f"differs from the runner's in {differs}")
            # its K = 1 lanes against the single-node K0 on the same trace
            # and capacity
            one = [i for i, e in enumerate(entries) if e.n_nodes == 1]
            if one:
                C1 = entries[one[0]].node_caps(0)[0]
                single = K0.event_loop(
                    *cargs[:5], cargs[5][:1],
                    torch.ones((1, C1), dtype=torch.bool, device=dev),
                    cargs[7][:1], cargs[8], kernel=KERNELS[p], n_fns=F,
                    capacity=C1, queue_cap=spec.queue_cap, stream=True,
                    threshold=cargs[9])
                for i in one:
                    k1_differs += [f"{p} {entries[i].label}: {k}"
                                   for k in K0_KEYS if not torch.equal(
                                       out[k][i:i + 1], single[k])]
            labels = [e.label for e in entries]
            ev = out["n_events"].tolist()
            longest = int(np.argmax(ev))
            row = dict(ms=ms, lanes=len(ev), events_total=sum(ev),
                       longest_lane=labels[longest],
                       longest_lane_events=max(ev),
                       us_per_event=1e3 * ms / max(ev),
                       lane_events=dict(zip(labels, ev)))
            extra_bytes = extra_ops = 0
            if "toggles" in out:
                tg = out["toggles"].tolist()
                rr = out["reroutes"].tolist()
                idle = [e.label for e, c, t, r in zip(entries, churny, tg, rr)
                        if c and not (t > 0 and r > 0)]
                need(not idle, f"{phase}: {p}: churn lanes without a toggle "
                     f"or a re-route: {idle}")
                extra_bytes = sum(
                    x.numel() * x.element_size() for k, x in ekw.items()
                    if k in ("churn_t", "dtimes", "dvals", "dper"))
                extra_ops = churn_ops(entries, F, tg, rr)
                row.update(toggles=dict(zip(labels, tg)),
                           reroutes=dict(zip(labels, rr)))
            b, by = cluster_bound(N, F, len(ev), ev, pc,
                                  route_ops(entries, N), extra_bytes,
                                  extra_ops)
            per[p] = dict(row, bound_ms=b, bound_by=by, policy_counts=pc,
                          held_to_runner=True)
        row = dict(spec=name, entries=[e.label for e in entries],
                   lanes=lanes, wall_s=wall, launches=launches,
                   req_per_s=len(spec.policies) * lanes * N / wall,
                   per_policy=per)
        if spec.deadlines is not None:
            row["slo_attainment"] = {
                p: {e.label: rs.value("slo_attainment", policy=p,
                                      cluster=e.label) for e in entries}
                for p in spec.policies}
        specs.append(row)
    rows = eager()
    res = dict(phase=phase, n_requests=N, queue_cap=exp["queue_cap"],
               specs=specs, wall_s=sum(x["wall_s"] for x in specs),
               launches=sum(x["launches"]["cluster_loop"] for x in specs),
               eager_card=rows, bitwise_vs_jax=not mismatch,
               mismatch=mismatch, planted_fault_caught=fault,
               unfit_cells=unfit, k1_differs_from_single_node=k1_differs)
    emit(res)
    need(not mismatch, f"{phase}: differs from the JAX package: "
         + "; ".join(mismatch))
    need(fault == ["resp_sum"], f"{phase}: the planted one-ulp fault in a "
         f"cell's resp_sum was not rejected alone ({fault})")
    need(not unfit, f"{phase}: cells not done once each without overflow "
         f"or stall: {unfit}")
    need(not k1_differs, f"{phase}: a K = 1 lane differs from the "
         f"single-node K0 in {k1_differs}")
    bad = {p: r["differs"] for p, r in rows.items() if r["differs"]}
    need(not bad, f"{phase}: the eager K-node loop and the kernel differ "
         f"on the card in {bad}")
    idle = {p: r["reroutes"] for p, r in rows.items()
            if "reroutes" in r and not all(x > 0 for x in r["reroutes"])}
    need(not idle, f"{phase}: eager-card lanes without a re-route: {idle}")
    return res


def eager_vs_kernel(torch, K0, spec):
    """The K-node variant's plain version, the eager K-node loop, on the
    card (every op its own launch) and the kernel on the runner's own
    operands for ``spec``: each policy's whole run and ms an event step,
    the two held bitwise (the same outputs, equal), and on churn lanes
    their toggles and re-routes."""
    from repro_torch.cluster.engine import simulate_cluster_eager
    from repro_torch.core import engine as E
    calls, _, _, N = cluster_calls(torch, spec, 256)
    rows = {}
    for p, _, _, cargs, ckw in calls:
        kw = {k: v for k, v in ckw.items() if k != "keep_responses"}
        kw["threshold"] = cargs[9]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = simulate_cluster_eager(*cargs[:9], **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms, out, _ = cluster_timed(torch, K0, cargs[:9], kw)
        steps = -(-int(eager["n_events"].max()) // E.SEG) * E.SEG
        rows[p] = dict(n_requests=N, entries=[e.label for e in spec.cluster],
                       plain_ms=1e3 * wall, event_steps=steps,
                       plain_ms_per_step=1e3 * wall / steps, ms=ms,
                       max_abs_err=max(
                           float((eager[k].double() - out[k].double()).abs()
                                 .max()) for k in eager if k in out),
                       differs=sorted(set(eager) ^ set(out)) + [
                           k for k in eager if k in out
                           and not torch.equal(eager[k], out[k])])
        for k in ("toggles", "reroutes", "retried", "shed",
                  "breaker_trips"):
            if k in eager:
                rows[p][k] = eager[k].tolist()
    return rows


def phase_dynamic_cluster(torch, np, api, fs, K0, cexp, n_requests):
    """benchmarks/fig_cluster.py's dynamic half on the card: routers jsq2
    and cold_aware at K = 1..32 (AGG = 32) and K = 64 (AGG = 64), ESFF and
    SFF, held as `cluster_phase` holds a grid (the fault planted in a
    K = 4 cell), with the eager K-node loop beside the kernel on the
    AGG = 32 spec's K = 4 entries of both routers at N = CLUSTER_EAGER_N.
    Its card-vs-CPU parity is in the parity phase."""
    CE = cluster_expected()
    exp = cexp["dynamic_cluster"].get(str(n_requests))
    need(exp is not None,
         f"dynamic_cluster: no JAX constants at N = {n_requests}")
    specs = CE.cluster_specs(api, n_requests, CE.CLUSTER["dynamic_routers"],
                             device="cuda")
    eager = parity_specs(api, "dynamic_cluster", "cuda", CLUSTER_EAGER_N)[0]
    return cluster_phase(
        torch, np, api, fs, K0, "dynamic_cluster",
        [(f"AGG={x.capacities[0]}", x) for x in specs], exp,
        CE.CLUSTER_KEYS, lambda e: e.n_nodes == 4,
        lambda: eager_vs_kernel(torch, K0, eager))


def churn_ops(entries, n_fns, toggles, reroutes):
    """Churn's work beyond `cluster_bound`'s per event: a drain or a
    re-arm a toggle (each busy slot against every slot of its node, each
    function's queue, the node's reset: ~C^2 + 2 F + C) and a routing
    decision a re-route."""
    ops = 0
    for e, tg, rr in zip(entries, toggles, reroutes):
        C = max(e.node_caps(0))
        ops += tg * (C * C + 2 * n_fns + C) + rr * route_cost(e)
    return ops


def phase_churn(torch, np, api, fs, K0, cexp, n_requests):
    """benchmarks/fig_churn.py at full size on the card (jsq2, cold_aware
    and slo_aware x K = 2, 4, 8 nodes of 32 / K slots, nodes 1..K-1 on a
    60 s cycle up 70 % of it, delays 0.004 i / (K - 1), a 0.35 s deadline,
    ESFF and SFF) and the leo-delay spec (K = 4 nodes of 8 slots whose
    links 1..3 swing 5 ms <-> 80 ms: jsq2 and slo_aware, and slo_aware
    with fig_churn's churn on top), held as `cluster_phase` holds a grid
    (deadline_miss and slo_attainment too, the fault planted in a churn
    cell), with the eager K-node loop beside the kernel on
    `churn_eager_spec`'s two lanes. Its card-vs-CPU parity is in the
    parity phase."""
    CE = cluster_expected()
    exp = cexp.get("churn", {}).get(str(n_requests))
    need(exp is not None, f"churn: no JAX constants at N = {n_requests}")
    specs = CE.churn_specs(api, n_requests, device="cuda")
    eager = churn_eager_spec(np, api, CE)
    return cluster_phase(
        torch, np, api, fs, K0, "churn",
        list(zip(("fig_churn", "leo-delay"), specs)), exp, CE.CHURN_KEYS,
        lambda e: e.has_churn(), lambda: eager_vs_kernel(torch, K0, eager))


def churn_eager_spec(np, api, CE):
    """Two K = 4 churn lanes at N = CLUSTER_EAGER_N, with explicit windows
    so that an outage falls in so short a trace: every node down over the
    30 % to 45 % quantiles of the arrivals under jsq2 with fig_churn's
    delays (the arrivals inside park), and every node down from just
    after the longest request of that stretch lands to the 60 % quantile
    under slo_aware on leo-delay's swinging links (its node drains it);
    ESFF and SFF. Both lanes must re-route."""
    src = CE.trace(api, CLUSTER_EAGER_N)
    arr = src.arrays()["arrival"]
    span = float(arr.max())
    q30, q45, q60 = (float(np.quantile(arr, x)) for x in (0.3, 0.45, 0.6))
    mid = np.flatnonzero((arr >= q30) & (arr <= q45))
    longest = mid[np.argmax(src.arrays()["exec_time"][mid])]
    ds = api.DelaySchedule(times=(0.0, span / 6), values=CE.LEO["values"],
                           period=span / 3)
    caps = (CE.LEO["slots"],) * 4
    entries = [api.ClusterSpec(
        n_nodes=4, router="jsq2", node_capacity=caps,
        net_delay=tuple(CE.CHURN["delay_step"] * i / 3 for i in range(4)),
        churn=(((q30, q45),),) * 4),
        api.ClusterSpec(n_nodes=4, router="slo_aware", node_capacity=caps,
                        net_delay=CE.LEO["net_delay"],
                        delay_schedule=(None, ds, ds, ds),
                        churn=(((float(arr[longest]) + 0.02, q60),),) * 4)]
    return api.ExperimentSpec(
        traces=[src], policies=CE.CHURN["policies"],
        capacities=(sum(caps),), queue_cap=CE.CHURN["queue_cap"],
        deadlines=CE.CHURN["deadline"], cluster=entries, device="cuda")


def resil_ops(entries, retried, completions):
    """The resilience layer's work beyond `cluster_bound`'s per event: a
    backoff (~10 operations) and a routing decision a retry, and the
    outcome test and breaker window (~8) a completion."""
    return sum(r * (10 + route_cost(e)) + 8 * c
               for e, r, c in zip(entries, retried, completions))


# the resilience layer's counters a cell must carry under faults
RESIL_COUNTERS = ("done", "failed", "timed_out", "retried", "shed",
                  "failed_exhausted")


def resil_required(name, spec, sums):
    """What each resilience spec must show summed over its lanes (a
    policy's): fig_resilience with faults fails and exhausts requests
    (and retries them under a retry policy), resil-tiers sheds, times
    out and retries, a breaker trips."""
    want = []
    if name.startswith("fp") and spec.fail_prob > 0:
        want += ["failed", "failed_exhausted"]
        if spec.retry.max_attempts > 1:
            want.append("retried")
    if name == "resil-tiers":
        want += ["shed", "timed_out", "retried"]
    if name.startswith("breaker"):
        want.append("breaker_trips")
    return [k for k in want if not sums.get(k, 0) > 0]


def tier_launches(spec):
    """The K-node launches of one policy of ``spec`` (its lanes fit one
    chunk): one for the single node (K = 1 lanes), one for the static
    tier's sub-streams, one for the dynamic entries."""
    kinds = {"none" if e is None else
             ("dynamic" if e.get_router().dynamic else "static")
             for e in spec.cluster}
    return len(kinds)


def phase_resilience(torch, np, api, fs, K0, cexp, n_requests):
    """The resilience layer on the card (`--part resilience` of
    scripts/cluster_expected.py): benchmarks/fig_resilience.py at full
    size (ESFF, jsq2 at K = 1, 4, 8 nodes of 32 / K slots, fail_prob 0 to
    0.3 x three retry policies, shedding; twelve specs of one K-node
    launch), its breaker row at fail_prob 0.15 and 0.6, and resil-tiers
    (the five policies that admit the layer under one set of faults, with
    timeouts and shed_oldest, on the single node, the static tier, and
    the dynamic tier with delay and with churn: three K-node launches a
    policy, the single node and the static sub-streams as K = 1 lanes).
    Every cell bitwise the JAX constants, conserving its requests
    without a stall, each spec's counters above 0 where `resil_required`
    says, a planted one-ulp fault rejected; each launch's lanes (events,
    retries, sheds, trips) and bound from the runner's results, its time
    by the runner's wall, and for RESIL_TIMED's specs each dynamic launch
    alone on the runner's operands by events (ms, us an event), held
    bitwise to the runner's cells; and the eager K-node loop beside the
    kernel on the card (`resil_eager_specs`), bitwise."""
    from repro_torch.cluster.runner import split_dynamic_lanes
    from repro_torch.core.policies import KERNELS
    CE = cluster_expected()
    exp = cexp.get("resilience", {}).get(str(n_requests))
    need(exp is not None, f"resilience: no JAX constants at N = "
         f"{n_requests}")
    specs, mismatch, fault, unfit, missing = [], [], None, [], []
    for name, spec in CE.resilience_specs(api, n_requests, device="cuda"):
        rs, wall, launches, counts = run_grid(torch, api, fs, K0, spec)
        rs.check()
        labels = rs.coords["cluster"]
        check_launches("resilience", launches, {},
                       {K0.variant_of(KERNELS[p]): tier_launches(spec)
                        for p in spec.policies})
        want_all = exp["cells"][name]
        sums = {}
        for p in spec.policies:
            for lab in labels:
                want = want_all[p][lab]
                got = cell_of(np, rs, list(want), policy=p, cluster=lab)
                mismatch += [f"{name} {p} {lab}: {m}"
                             for m in held_exact(want, got)]
                if (got["done"] + got["shed"] + got["failed_exhausted"]
                        != n_requests or got["stalled"]):
                    unfit.append(f"{name} {p} {lab}")
                for k in RESIL_COUNTERS + ("breaker_trips",):
                    if k in got:
                        sums.setdefault(p, {})[k] = (
                            sums.get(p, {}).get(k, 0) + got[k])
                if fault is None:
                    bad = dict(got, resp_sum=float(np.nextafter(
                        got["resp_sum"], np.inf)))
                    fault = held_exact(want, bad)
            missing += [f"{name} {p}: {k}"
                        for k in resil_required(name, spec, sums[p])]
        dyn = [e for e in spec.cluster
               if e is not None and e.get_router().dynamic]
        lab = [e.label for e in dyn]
        per = {}
        for p in spec.policies:
            # the dynamic launch's lanes as the runner left them
            ev = [int(rs.value("n_events", policy=p, cluster=x))
                  for x in lab]
            per[p] = dict(lanes=len(ev), events_total=sum(ev),
                          longest_lane=lab[int(np.argmax(ev))],
                          longest_lane_events=max(ev),
                          lane_events=dict(zip(lab, ev)),
                          **{k: {x: int(rs.value(k, policy=p, cluster=x))
                                 for x in lab}
                             for k in ("done", "retried", "shed",
                                       "breaker_trips") if k in rs.data})
            if name not in RESIL_TIMED:
                # the spec's one launch: its wall and policy counts are
                # the runner's
                per[p].update(wall_ms=1e3 * wall,
                              us_per_event_wall=1e6 * wall / max(ev),
                              policy_counts=counts[
                                  f"cluster:{K0.variant_of(KERNELS[p])}"])
        calls = (cluster_calls(torch, spec, rs.meta["lane_chunk"], dyn)[0]
                 if name in RESIL_TIMED else ())
        for p, _, _, cargs, ckw in calls:
            ekw = {k: v for k, v in ckw.items() if k != "keep_responses"}
            ms, out, pc = cluster_timed(torch, K0, cargs[:9],
                                        dict(ekw, threshold=cargs[9]), reps=1)
            split = split_dynamic_lanes(
                replace(spec, cluster=tuple(dyn)), dyn,
                {k: v.cpu().numpy() for k, v in out.items()}, 1)
            differs = []
            for e, m in zip(dyn, split):
                for k in CLUSTER_SPLIT_KEYS + RESIL_COUNTERS[1:] + (
                        "deadline_miss",):
                    got = np.expand_dims(m[k][None], 4)
                    want = rs.sel(policy=p, cluster=e.label)[k]
                    if k == "node_done":
                        want = want[..., :e.n_nodes]
                    if not np.array_equal(got, want):
                        differs.append(f"{e.label} {k}")
            need(not differs, f"resilience: {name} {p}: the timed K-node "
                 f"launch differs from the runner's in {differs}")
            per[p].update(ms=ms, us_per_event=1e3 * ms / max(
                out["n_events"].tolist()), policy_counts=pc,
                held_to_runner=True)
        for p, r in per.items():
            b, by = cluster_bound(
                n_requests, rs.meta["n_functions"], r["lanes"],
                list(r["lane_events"].values()), r["policy_counts"],
                route_ops(dyn, n_requests), 9 * n_requests,
                resil_ops(dyn, list(r["retried"].values()),
                          list(r["done"].values())))
            r.update(bound_ms=b, bound_by=by)
        specs.append(dict(spec=name, entries=labels, wall_s=wall,
                          launches=launches, per_policy=per,
                          sums=sums, goodput={
                              p: {lab: rs.value("goodput", policy=p,
                                                cluster=lab)
                                  for lab in labels}
                              for p in spec.policies}))
    rows = {}
    for eager in resil_eager_specs(np, api, CE):
        for p, r in eager_vs_kernel(torch, K0, eager).items():
            rows.setdefault(p, []).append(r)
    res = dict(phase="resilience", n_requests=n_requests, specs=specs,
               wall_s=sum(x["wall_s"] for x in specs),
               launches=sum(x["launches"]["cluster_loop"] for x in specs),
               eager_card=rows, bitwise_vs_jax=not mismatch,
               mismatch=mismatch, planted_fault_caught=fault,
               unfit_cells=unfit, counters_missing=missing)
    emit(res)
    need(not mismatch, "resilience: differs from the JAX package: "
         + "; ".join(mismatch[:20]))
    need(fault == ["resp_sum"], f"resilience: the planted one-ulp fault in "
         f"a cell's resp_sum was not rejected alone ({fault})")
    need(not unfit, f"resilience: cells not conserving their requests or "
         f"stalled: {unfit}")
    need(not missing, f"resilience: counters that must be > 0 are not: "
         f"{missing}")
    bad = {p: [r["differs"] for r in x if r["differs"]]
           for p, x in rows.items()}
    need(not any(bad.values()), f"resilience: the eager K-node loop and the "
         f"kernel differ on the card in {bad}")
    quiet = resil_eager_quiet(rows)
    need(not quiet, f"resilience: eager K-node lanes on which the "
         f"resilience layer did nothing: {quiet}")
    return res


def resil_eager_quiet(rows):
    """The eager K-node lanes (``eager_vs_kernel``'s rows by policy) on
    which the layer never acted, so that a bitwise match would not show
    it: every lane must retry or shed a request, a lane with churn
    toggles must re-route one, and a breaker lane must trip."""
    quiet = []
    for p, x in rows.items():
        for r in x:
            for i, lab in enumerate(r["entries"]):
                def of(k):
                    return (r.get(k) or [0] * len(r["entries"]))[i]
                if of("retried") + of("shed") == 0:
                    quiet.append(f"{p} N={r['n_requests']} {lab}: no "
                                 "retry or shed")
                if of("toggles") and not of("reroutes"):
                    quiet.append(f"{p} N={r['n_requests']} {lab}: no "
                                 "re-route")
                if lab.startswith("breaker") and not of("breaker_trips"):
                    quiet.append(f"{p} N={r['n_requests']} {lab}: no trip")
    return quiet


def resil_eager_specs(np, api, CE):
    """The eager K-node loop's specs beside the kernel: resil-tiers'
    faults on a K = 1 lane (the single node) and a K = 4 jsq2 lane with
    every node down over the 30 % to 45 % quantiles of the arrivals, ESFF
    and SFF at N = RESIL_EAGER_N and resil-tiers' three other policies at
    N = RESIL_EAGER_N_OTHERS; and a K = 4 breaker lane at fail_prob 0.6,
    ESFF and SFF at N = RESIL_EAGER_N."""
    def lanes(n, policies):
        arr = CE.trace(api, n).arrays()["arrival"]
        q30, q45 = (float(np.quantile(arr, x)) for x in (0.3, 0.45))
        tiers = dict(CE.resilience_specs(api, n, device="cuda"))[
            "resil-tiers"]
        k = CE.TIERS["n_nodes"]
        return replace(tiers, policies=policies, cluster=(
            api.ClusterSpec(n_nodes=1, router="jsq2"),
            api.ClusterSpec(n_nodes=k, router="jsq2",
                            node_capacity=(CE.TIERS["slots"],) * k,
                            churn=(((q30, q45),),) * k)))
    brk = dict(CE.resilience_specs(api, RESIL_EAGER_N, device="cuda"))[
        "breaker/fp0.6"]
    others = tuple(p for p in CE.TIERS["policies"]
                   if p not in CLUSTER_POLICIES)
    return [lanes(RESIL_EAGER_N, CLUSTER_POLICIES),
            lanes(RESIL_EAGER_N_OTHERS, others),
            replace(brk, policies=CLUSTER_POLICIES)]


# ------------------------------------------------ the telemetry phase
def telemetry_module():
    """scripts/telemetry_expected.py: the telemetry phase's specs and the
    digest of a stream, shared with the script that made their JAX
    constants (it imports JAX only in its main)."""
    import importlib.util
    path = os.path.join(HERE, "scripts", "telemetry_expected.py")
    spec = importlib.util.spec_from_file_location("telemetry_expected", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digests_differ(exp, got):
    """The cells of a case whose digest differs from the JAX constants."""
    return sorted(k for k in set(exp) | set(got) if exp.get(k) != got.get(k))


def same_streams(np, a, b):
    """The (cell, field) pairs in which two TraceRuns' streams differ."""
    bad = [(k, "cell") for k in set(a.cells) ^ set(b.cells)]
    for k in set(a.cells) & set(b.cells):
        bad += [(k, f) for f in a.cells[k]
                if not np.array_equal(a.cells[k][f], b.cells[k][f])]
    return bad


def same_data(np, a, b):
    return sorted(m for m in set(a.data) | set(b.data)
                  if m not in a.data or m not in b.data
                  or not np.array_equal(a.data[m], b.data[m],
                                        equal_nan=True))


def max_abs_err(np, a, b):
    """The largest absolute difference between two traced runs: their
    streams' ``t`` and ``dt`` columns and every result metric (the
    integer columns are held equal apart)."""
    errs = [0.0]
    for k in set(a.trace.cells) & set(b.trace.cells):
        for f in ("t", "dt"):
            x, y = a.trace.cells[k][f], b.trace.cells[k][f]
            if x.shape == y.shape and x.size:
                errs.append(float(np.max(np.abs(x - y))))
    for m in set(a.data) & set(b.data):
        x = np.asarray(a.data[m], dtype=np.float64)
        y = np.asarray(b.data[m], dtype=np.float64)
        fin = np.isfinite(x) & np.isfinite(y)
        if x.shape == y.shape and fin.any():
            errs.append(float(np.max(np.abs(x[fin] - y[fin]))))
    return max(errs)


def traced_launches(K0):
    return dict(single=dict(K0.event_loop.traced_launches),
                cluster=dict(K0.cluster_loop.traced_launches),
                untraced=(K0.event_loop.launches + K0.cluster_loop.launches
                          - sum(K0.event_loop.traced_launches.values())
                          - sum(K0.cluster_loop.traced_launches.values())))


def response_sum(np, ev, TraceKind):
    """The sum of the span responses of a stream (each completing EXEC's
    time less its request's ARRIVAL), vectorised: what
    `assemble_spans` sums over a Fig. 5 lane's 60,000 spans."""
    kind, rid, aux = ev["kind"], ev["rid"], ev["aux"]
    arr = np.full(int(rid.max()) + 1, np.nan)
    am = kind == TraceKind.ARRIVAL
    arr[rid[am]] = ev["t"][am]
    ok = (kind == TraceKind.EXEC) & ((aux & 3) == 0)
    return float(np.sum(ev["t"][ok] - arr[rid[ok]]))


def phase_telemetry(torch, np, api, fs, K0, exp_all, n_requests, main_rs):
    """The trace rail on the card: the five cases of
    scripts/telemetry_expected.py through the traced forms of K0 (the
    path, with the counts set to 0 just before and read just after),
    every cell's stream bitwise the JAX constants and the results bitwise
    the untraced run's; the traced eager loops on the card beside the
    traced kernels on each case cut to TELEMETRY_EAGER_N, bitwise; Fig.
    5's lanes of TELEMETRY_FULL traced at full size (records = n_events,
    ARRIVAL = N, completing EXEC = done, COLD = cold starts, span
    responses = mean response x N within 1e-9, results bitwise the main
    path's), traced and untraced launches timed; the Perfetto export of
    the churn case validated, and a planted fault in a copy of its stream
    rejected."""
    from repro_torch.core.policies import KERNELS
    from repro_torch.telemetry import (TraceKind, assemble_spans,
                                       call_breakdown, events_to_trace,
                                       rail, validate_trace)
    tm = telemetry_module()
    with open(TELEMETRY_EXPECTED_FILE) as f:
        texp = json.load(f)["cases"]
    specs = {c: tm.build_spec(api, c) for c in tm.CASES}
    for spec in specs.values():
        for src in spec.expanded_traces():
            src.arrays()
    # the path: every case traced on the card
    reset_counts(fs, K0)
    plain0 = K0.event_loop.plain_calls + K0.cluster_loop.plain_calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traced = {c: api.run_experiment(spec, device="cuda")
              for c, spec in specs.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = traced_launches(K0)
    launches["plain_calls"] = (K0.event_loop.plain_calls
                               + K0.cluster_loop.plain_calls - plain0)
    need(launches["untraced"] == 0 and launches["plain_calls"] == 0,
         f"telemetry: a traced case took an untraced launch or the eager "
         f"loop ({launches})")
    cases = {}
    for c, rs in traced.items():
        got = tm.case_digests(rs.trace)
        bad = digests_differ(texp[c], got)
        need(not bad, f"telemetry: {c}: cells {bad} differ from the JAX "
             "package's traced run")
        plain = api.run_experiment(replace(specs[c], trace_events=False),
                                   device="cuda")
        differs = same_data(np, rs, plain)
        need(not differs and plain.trace is None,
             f"telemetry: {c}: tracing changed {differs}")
        cases[c] = dict(cells=len(got),
                        records=sum(d["records"] for d in got.values()),
                        kinds=[sum(d["kinds"][i] for d in got.values())
                               for i in range(8)])
    # a planted fault: one record of a copy of the churn case's stream
    ev = traced["churn_retry_k4"].trace.events()
    bad_ev = {k: v.copy() for k, v in ev.items()}
    bad_ev["aux"][len(bad_ev["aux"]) // 2] ^= 2
    need(tm.digest(bad_ev) != texp["churn_retry_k4"]["0,0,0,0,0"],
         "telemetry: a planted fault in one record was not rejected")
    n_trace_events = validate_trace(events_to_trace(ev))
    spans = assemble_spans(ev)
    need(sum(s.completion >= 0 for s in spans.values())
         == int(traced["churn_retry_k4"].value("done")),
         "telemetry: the churn case's spans do not complete done requests")
    # the traced eager loops on the card beside the traced kernels, each
    # case cut to TELEMETRY_EAGER_N; each (case, policy) alone, so that
    # each variant's kernel and plain version are timed apart
    eager = {}
    orig = K0.has_device_loop
    for c in tm.CASES:
        for p in specs[c].policies:
            cut = replace(tm.build_spec(api, c, TELEMETRY_EAGER_N),
                          policies=(p,))
            for src in cut.expanded_traces():
                src.arrays()
            t0 = time.perf_counter()
            card = api.run_experiment(cut, device="cuda")
            torch.cuda.synchronize()
            k_ms = (time.perf_counter() - t0) * 1e3
            K0.has_device_loop = lambda kernel: False
            try:
                t0 = time.perf_counter()
                ref = api.run_experiment(cut, device="cuda")
                torch.cuda.synchronize()
                e_ms = (time.perf_counter() - t0) * 1e3
            finally:
                K0.has_device_loop = orig
            bad = same_streams(np, card.trace, ref.trace)
            differs = same_data(np, card, ref)
            need(not bad and not differs,
                 f"telemetry: {c}/{p} at N = {TELEMETRY_EAGER_N}: the "
                 f"traced kernel differs from the traced eager loop "
                 f"({bad[:3]}, {differs})")
            eager[f"{c}/{p}"] = dict(plain_ms=e_ms, ms=k_ms,
                                     records=card.trace.n_events,
                                     max_abs_err=max_abs_err(np, card, ref))
    # each (case, policy)'s traced launches timed at the case's size
    per_case = {}
    for c in tm.CASES:
        for p in specs[c].policies:
            one = replace(specs[c], policies=(p,))
            api.run_experiment(one, device="cuda")   # warm
            reset_counts(fs, K0)
            br = call_breakdown(api.run_experiment, one, device="cuda")
            pi = specs[c].policies.index(p)
            per_case[f"{c}/{p}"] = dict(
                launch_ms=br["launch_s"] * 1e3, copy_ms=br["copy_s"] * 1e3,
                pack_ms=br["pack_s"] * 1e3, total_ms=br["total_s"] * 1e3,
                launches=traced_launches(K0),
                records=sum(len(ev["kind"]) for key, ev
                            in traced[c].trace.cells.items()
                            if key[0] == pi))
    # Fig. 5's lanes traced at full size, beside their untraced launch
    args, kw = fig5_inputs(torch, api, n_requests, torch.device("cuda"))
    exp = exp_all["fig5"].get(str(n_requests))
    full = {}
    for p in TELEMETRY_FULL:
        kernel = KERNELS[p]
        a = with_beta(torch, args, kernel)
        un_ms, _, _ = k0_timed(torch, K0, kernel, a, kw, reps=3)
        with rail.collect() as sink:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = K0.event_loop(*a, kernel=kernel, trace=True, **kw)
            e1.record()
            e1.synchronize()
        tr_ms = e0.elapsed_time(e1)
        last = dict(K0.event_loop.last_trace)
        br = call_breakdown(K0.event_loop, *a, kernel=kernel, trace=True,
                            **kw)
        differs = k0_differs(np, out, main_rs, p)
        need(not differs, f"telemetry: {p}: the traced Fig. 5 launch "
             f"differs from the main path's in {differs}")
        pi = main_rs.coords["policy"].index(p)
        lanes = []
        for j in range(len(CAPACITIES)):
            ev = sink.lane_events(j)
            kind = ev["kind"]
            done = int(main_rs["done"][pi, 0, j, 0])
            cold = int(main_rs["cold_starts"][pi, 0, j, 0])
            mean = float(main_rs["mean_response"][pi, 0, j, 0])
            n_ev = (exp[p]["n_events"][j] if exp is not None
                    else int(out["n_events"][j]))
            rsum = response_sum(np, ev, TraceKind)
            ok = (len(kind) == n_ev
                  and int((kind == TraceKind.ARRIVAL).sum()) == n_requests
                  and int(((kind == TraceKind.EXEC)
                           & ((ev["aux"] & 3) == 0)).sum()) == done
                  and int((kind == TraceKind.COLD).sum()) == cold
                  and math.isclose(rsum, mean * n_requests, rel_tol=1e-9))
            need(ok, f"telemetry: {p} C={CAPACITIES[j]}: the traced lane "
                 f"does not conserve ({len(kind)} records, n_events "
                 f"{n_ev}; response sum {rsum!r} vs {mean * n_requests!r})")
            lanes.append(dict(records=len(kind), n_events=n_ev))
        events = sum(x["records"] for x in lanes)
        full[p] = dict(traced_ms=tr_ms, untraced_ms=un_ms,
                       traced_over_untraced=tr_ms / un_ms,
                       launch_ms=br["launch_s"] * 1e3,
                       copy_ms=br["copy_s"] * 1e3,
                       relaunches=last["relaunches"],
                       capacity=last["capacity"], records=events,
                       record_mb=events * 52 / 1e6,
                       longest_lane_events=max(x["records"] for x in lanes))
    res = dict(phase="telemetry", wall_s=wall, launches=launches,
               case_n=tm.TRACE["n_requests"],
               cases=cases, eager_card=eager, per_case=per_case,
               fig5_full=full, eager_n=TELEMETRY_EAGER_N,
               perfetto_events=n_trace_events, planted_fault="rejected",
               bitwise_vs_jax=True)
    emit(res)
    return res


def traced_kernel_rows(K0, KERNELS, tele, n_requests):
    """The ``kernels`` line's rows of the traced forms of K0 that the
    telemetry phase's path launched: launches from that path, ms from
    each variant's traced launch (Fig. 5's full-size lanes for
    TELEMETRY_FULL on one node, else its case's), the plain version the
    traced eager loop on the card at TELEMETRY_EAGER_N, max_abs_err the
    largest difference from it over the cases that launched the variant
    (their streams' t and dt, their metrics), the bound from the records
    written (52 B each) and ~20 f64 operations an event."""
    from repro_torch.kernels import _build
    report = "\n".join(_build.BUILD_INFO.get(s, {}).get("ptxas", "")
                       for s in _build.TRACED_UNITS
                       + _build.CLUSTER_TRACED_UNITS)
    rows = []
    for form in ("single", "cluster"):
        for v, n in sorted(tele["launches"][form].items()):
            p = next(q for q in POLICIES
                     if K0.variant_of(KERNELS[q]) == v)
            runs = {k: r for k, r in tele["per_case"].items()
                    if r["launches"][form].get(v)}
            case, r = next(iter(runs.items()))
            ms = r["launch_ms"] / r["launches"][form][v]
            records = r["records"]
            n_req = tele["case_n"]
            at = f"({case}, N = {n_req})"
            if form == "single" and p in tele["fig5_full"]:
                full = tele["fig5_full"][p]
                ms, records = full["traced_ms"], full["records"]
                n_req = n_requests
                at = (f"(Fig. 5's {len(CAPACITIES)} lanes traced, N = "
                      f"{n_requests}, F = 200)")
            e = tele["eager_card"][case]
            b, by = bound_ms(52 * records + 32 * n_req, 20 * records,
                             "f64")
            cl = form == "cluster"
            unit = (K0.CLUSTER_TRACED_SOURCE[v] if cl
                    else K0.TRACED_SOURCE)
            rows.append(dict(
                name=f"event_loop{'_cluster' if cl else ''}_traced[{p}]",
                entry="cluster_loop" if cl else "event_loop",
                trace=True, variant=v, route="cuda",
                source=f"src/repro_torch/csrc/{unit}.cu",
                replaces=("src/repro/cluster/engine.py:413" if cl
                          else "src/repro/core/jax_engine.py:1001"),
                policy_kernel=POLICY_SOURCE[p], pallas=False,
                note="engine work with no Pallas twin: K0's traced form "
                "(the trace rail of "
                + ("cluster/engine.py:1278-1345" if cl
                   else "jax_engine.py:1432-1478") + " compiled in)",
                launches=n,
                max_abs_err=max(tele["eager_card"][k]["max_abs_err"]
                                for k in runs),
                ms=ms,
                plain_ms=e["plain_ms"], plain_n_requests=TELEMETRY_EAGER_N,
                ms_at_plain_n=e["ms"],
                plain_note="the traced eager loop's run (the runner's "
                "wall) at N = TELEMETRY_EAGER_N of the same case; "
                "ms_at_plain_n is the traced kernel's run there",
                bound_ms=b, bound_by=by, library_ms=None,
                ptxas=ptxas_lines(report, (PTXAS_NAME_CLUSTER if cl
                                           else PTXAS_NAME)[p]),
                check="passed", at=at))
    return rows


def same_results(np, a, b):
    """`same_data`, and ``computed`` when the computed masks differ."""
    return same_data(np, a, b) + (
        ["computed"] if not np.array_equal(a.computed, b.computed) else [])


def phase_scale_out(torch, np, api, fs, K0, n_requests, fig6_rs):
    """The experiment API's scale-out on the card: the Fig. 6 grid as
    three host shards (``host_shard=(i, 3)``), each with the launch counts
    set to 0 just before and read just after (one launch a chunk it
    keeps), their computed masks disjoint, merged bitwise the ResultSet of
    the fig6 phase; ``devices=1`` bitwise too; ``devices`` beyond the
    host's cards raises."""
    spec = fig6_spec(api, n_requests, "cuda")
    parts, shards = [], []
    for i in range(3):
        rs, wall, launches, _ = run_grid(torch, api, fs, K0,
                                         replace(spec, host_shard=(i, 3)))
        chunks = int(rs.computed.sum()) // len(RATIOS)   # one a policy
        need(launches["event_loop"] == chunks and launches["plain_calls"]
             == 0, f"scale_out: shard {i} launched "
             f"{launches['by_variant']} for {chunks} chunks")
        need(rs.meta["host_shard"] == [i, 3] and rs.meta["n_devices"] == 1,
             f"scale_out: shard {i}'s meta {rs.meta['host_shard']}, "
             f"{rs.meta['n_devices']} devices")
        parts.append(rs)
        shards.append(dict(host_shard=[i, 3], wall_s=wall,
                           cells=int(rs.computed.sum()),
                           launches=launches["by_variant"]))
    overlap = [(a, b) for a in range(3) for b in range(a + 1, 3)
               if (parts[a].computed & parts[b].computed).any()]
    need(not overlap, f"scale_out: shards {overlap} computed a cell twice")
    merged = parts[0].merge(*parts[1:])
    differs = same_results(np, merged, fig6_rs)
    need(not differs, f"scale_out: the merged shards differ from fig6's "
         f"ResultSet in {differs}")
    one, wall1, launches1, _ = run_grid(torch, api, fs, K0,
                                        replace(spec, devices=1))
    need(one.meta["n_devices"] == 1 and not same_results(np, one, fig6_rs),
         "scale_out: devices=1 differs from fig6's ResultSet in "
         f"{same_results(np, one, fig6_rs)}")
    n_cards = torch.cuda.device_count()
    try:
        api.run_experiment(replace(spec, devices=n_cards + 1))
        refused = None
    except ValueError as e:
        refused = str(e)
    need(refused is not None and "local device" in refused,
         f"scale_out: devices={n_cards + 1} on a host of {n_cards} card(s) "
         "did not raise")
    res = dict(phase="scale_out", n_requests=n_requests,
               grid="fig6 (ratios 0.6..1.4 x six policies at C = 16)",
               shards=shards, merged_bitwise_fig6=True,
               devices_1=dict(wall_s=wall1, n_devices=one.meta["n_devices"],
                              bitwise_fig6=True,
                              launches=launches1["by_variant"]),
               n_devices_present=n_cards,
               devices_refused=dict(devices=n_cards + 1, message=refused),
               devices_2_verified=False if n_cards < 2 else None,
               launches=sum(sum(x["launches"].values()) for x in shards))
    emit(res)
    return res


REFERENCE_TRACE = dict(n_functions=12, n_requests=400, seed=3,
                       utilization=0.25)
REFERENCE_FAULTS = dict(fail_prob=0.6, timeouts=8.0, on_overflow="shed",
                        fail_seed=99)
REFERENCE_RETRY = dict(max_attempts=3, base=0.05, cap=1.0, jitter=0.3)


def reference_cases(api):
    """The reference phase's clusters, tests/test_torch_reference.py's:
    (name, policy, ClusterSpec, fault knobs or None), over the F = 12,
    N = 400 trace."""
    arr = api.SyntheticTrace.make(**REFERENCE_TRACE).arrays()["arrival"]
    span = float(arr.max())
    churn = (None, api.PeriodicChurn(span / 3, duty=0.7),
             api.PeriodicChurn(span / 3, duty=0.7, phase=span / 9),
             api.PeriodicChurn(span / 3, duty=0.7, phase=2 * span / 9))
    sched = api.DelaySchedule(times=(0.0, span / 4), values=(0.005, 0.08),
                              period=span / 2)
    return [
        ("jsq2-churn", "esff",
         api.ClusterSpec(n_nodes=4, router="jsq2", churn=churn), None),
        ("slo_aware-schedule", "esff",
         api.ClusterSpec(n_nodes=3, router="slo_aware",
                         net_delay=(0.0, 0.01, 0.0),
                         delay_schedule=(None, None, sched)), None),
        ("breaker-faults", "esff",
         api.ClusterSpec(n_nodes=4, router="breaker"), REFERENCE_FAULTS),
        ("hash-static", "sff",
         api.ClusterSpec(n_nodes=3, router="hash", node_capacity=(4, 2, 3),
                         net_delay=(0.0, 0.05, 0.1)), None),
    ]


def reference_mismatch(np, resp, cold, node_done, ref, counts=None):
    """tests/test_churn.py's bar against the reference's ``ref``:
    responses within rtol 1e-9 and atol 1e-9 (NaNs equal), cold starts,
    each node's completions and the fault counters ``counts`` exact."""
    bad = []
    if not np.allclose(resp, ref["response"], rtol=1e-9, atol=1e-9,
                       equal_nan=True):
        d = np.abs(np.nan_to_num(resp) - np.nan_to_num(ref["response"]))
        bad.append(f"response (largest difference {float(d.max())!r})")
    if cold != ref["cold_starts"]:
        bad.append(f"cold_starts {cold} != {ref['cold_starts']}")
    if not np.array_equal(node_done, ref["node_done"]):
        bad.append(f"node_done {list(node_done)} != "
                   f"{list(ref['node_done'])}")
    for k, v in (counts or {}).items():
        if v != int(ref[k]):
            bad.append(f"{k} {v} != {int(ref[k])}")
    return bad


def phase_reference(torch, np, api, fs, K0):
    """K0 on the card against the port's Python reference cluster on the
    host (`repro_torch.cluster.simulate_cluster_reference`), request for
    request: jsq2 under periodic churn, slo_aware under a delay schedule,
    the breaker under faults (K0's K-node variant) and the static tier
    (hash, mixed capacities and delays: K0's single-node form), exact
    mode, each run with the counts set to 0 just before and read just
    after; a planted fault in one response must be rejected."""
    from repro_torch.cluster import simulate_cluster_reference
    from repro_torch.core.resilience import RetryPolicy
    src = api.SyntheticTrace.make(**REFERENCE_TRACE)
    rows, fault_seen = [], None
    for name, policy, cs, faults in reference_cases(api):
        kw = {}
        if faults:
            kw = dict(faults, retry=RetryPolicy(**REFERENCE_RETRY))
        spec = api.ExperimentSpec(
            traces=[src], policies=(policy,), capacities=(3,),
            queue_cap=64 if faults else 256, stream=False,
            keep_per_request=True, cluster=[cs], device="cuda", **kw)
        rs, wall, launches, _ = run_grid(torch, api, fs, K0, spec)
        rs.check()
        dynamic = cs.get_router().dynamic
        need(launches["plain_calls"] == 0
             and launches["cluster_loop" if dynamic else "event_loop"] == 1
             and launches["event_loop" if dynamic else "cluster_loop"] == 0,
             f"reference: {name}: launches {launches}, not one launch of "
             f"K0's {'K-node' if dynamic else 'single-node'} form")
        t0 = time.perf_counter()
        ref = simulate_cluster_reference(
            src.to_trace(), policy, cs, capacity=3,
            **(dict(kw, queue_cap=64) if faults else {}))
        ref_s = time.perf_counter() - t0
        resp = np.asarray(rs.value("response", policy=policy))
        cold = int(rs.value("cold_starts", policy=policy))
        nd = np.asarray(rs.value("node_done", policy=policy))
        counts = ({k: int(rs.value(k, policy=policy))
                   for k in ("done", "failed", "timed_out", "retried", "shed",
                             "failed_exhausted", "breaker_trips")}
                  if faults else None)
        bad = reference_mismatch(np, resp, cold, nd, ref, counts)
        need(not bad, f"reference: {name}: K0 differs from the reference "
             f"in {bad}")
        if faults:
            need(counts["breaker_trips"] > 0,
                 f"reference: {name}: the breaker never tripped")
        if fault_seen is None:
            planted = resp.copy()
            i = int(np.flatnonzero(np.isfinite(planted))[0])
            planted[i] *= 1 + 1e-6
            fault_seen = reference_mismatch(np, planted, cold, nd, ref)
            need(fault_seen, "reference: a response off by 1e-6 was not "
                 "rejected")
        finite = np.isfinite(resp)
        rows.append(dict(case=name, policy=policy, router=cs.router,
                         form="K-node" if dynamic else "single-node",
                         launches=(launches["cluster_by_variant"] if dynamic
                                   else launches["by_variant"]),
                         card_s=wall, reference_s=ref_s,
                         max_abs_err=float(np.abs(
                             resp[finite] - ref["response"][finite]).max()),
                         done=int(rs.value("done", policy=policy)),
                         counts=counts))
    res = dict(phase="reference", n_requests=REFERENCE_TRACE["n_requests"],
               n_functions=REFERENCE_TRACE["n_functions"], cases=rows,
               tolerance=dict(rtol=1e-9, atol=1e-9),
               planted_fault_rejected=fault_seen)
    emit(res)
    return res


def phase_audit(torch):
    """Every gate of `repro_torch.analysis` on the card, the SASS scan of
    each event-loop unit among them; a failing gate fails the run."""
    from repro_torch.analysis import run_gates
    rep = run_gates(device=torch.device("cuda"))
    gates = rep["gates"]
    sass = gates["f32_sass"]["entries"][0]
    grid = next(e for e in gates["recompilation"]["entries"]
                if e["entry"] == "experiment_grid")
    plans = next(e for e in gates["recompilation"]["entries"]
                 if e["entry"] == "rmsnorm_plans")
    res = dict(phase="audit", passed=rep["passed"], wall_s=rep["wall_s"],
               gates={g: v["passed"] for g, v in gates.items()},
               gate_s={g: v.get("wall_s") for g, v in gates.items()},
               sass_dump_s=sass.get("dump_s"),
               problems={g: v["problems"][:5] for g, v in gates.items()
                         if v["problems"]},
               sass_run=sass.get("run"), cuobjdump=sass.get("cuobjdump"),
               f32_by_unit=sass.get("f32_by_unit"),
               div_sites_by_unit={u: {k: v["div_sites"] for k, v in ks.items()}
                                  for u, ks in (sass.get("by_unit")
                                                or {}).items()},
               grid_launches=grid["calls"], grid_forms=grid["forms"],
               rmsnorm_plans=plans["plans"],
               not_applicable=sorted(rep["not_applicable"]))
    emit(res)
    need(rep["passed"], "audit: gates failed: "
         + "; ".join(f"{g}: {v['problems'][:3]}" for g, v in gates.items()
                     if not v["passed"]))
    need(sass.get("run") is True, "audit: the SASS scan did not run")
    return res


def phase_profile(torch, api, n_requests):
    """K0's device time and the device busy share, from torch.profiler
    over the main path's run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec = fig5_spec(api, n_requests, "cuda")
    spec.expanded_traces()[0].arrays()
    api.run_experiment(spec)            # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.run_experiment(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): an aten op's row also
    # carries the device time of the kernels it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in rows)
    # one row a K0 variant (a policy), named by its instantiation
    # (demangled, or not)
    spell = {p: (PTXAS_NAME[p], "Policy<{}, {}, {}, {}>, false>".format(
        a[0], *("true" if x else "false" for x in a[1:])))
        for p, a in POLICY_ARGS.items()}
    k0 = {p: e.self_device_time_total / e.count / 1e3
          for e in rows if "event_loop" in e.key
          for p, names in spell.items() if any(n in e.key for n in names)}
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    emit(dict(phase="profile", n_requests=n_requests, wall_s=wall,
              device_busy_s=dev_us * 1e-6,
              device_busy_share=dev_us * 1e-6 / wall,
              device_ops=sum(e.count for e in rows),
              event_loop_device_ms=k0,
              top=[dict(name=e.key[:80], count=e.count,
                        device_us=e.self_device_time_total)
                   for e in top]))


class SmClock:
    """nvidia-smi's SM clock (MHz), sampled every 20 ms while entered
    (the sampler is stopped on exit)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.mhz = [int(v) for v in out.split() if v.isdigit()]

    def summary(self):
        m = sorted(self.mhz)
        return dict(samples=len(m), min=m[0] if m else None,
                    median=m[len(m) // 2] if m else None,
                    max=m[-1] if m else None)


def phase_profile_serving(torch):
    """Device busy share of one served request of each function of
    SERVE_CATALOGUE and SERVE_SSM_CATALOGUE on a warm instance, and the
    serving kernels' device time per launch at the path's own shapes,
    from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.instance import ModelInstance

    def is_kernel(name, key):
        # K4a and K4b are the instances of rmsnorm_vector_kernel and
        # rmsnorm_scalar_kernel (the general body) whose last template
        # argument, RESIDUAL, is false and true; K2 has a CUDA-core
        # (f32) and a TMA + wgmma (flash_attention_wgmma_kernel, bf16)
        # body; K3 is one kernel, one launch a call
        if name.startswith("rmsnorm"):
            flag = "true>" if name == "rmsnorm_residual" else "false>"
            return (("rmsnorm_vector_kernel<" in key
                     or "rmsnorm_scalar_kernel<" in key) and flag in key)
        return f"::{name}_" in key

    out = []
    fns = serve_catalogue([(name, SERVE_ARCH, p, g, m)
                           for name, p, g, m in SERVE_CATALOGUE]
                          + list(SERVE_SSM_CATALOGUE))
    for fn in fns:
        inst = ModelInstance(fn)
        inst.cold_start()
        inst.execute(seed=1)            # warm-up
        with SmClock() as clock, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            wall = inst.execute(seed=2)
        inst.evict()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        dev_us = sum(e.self_device_time_total for e in rows)
        kernels = {}
        for k in ("flash_attention", "decode_attention", "rmsnorm",
                  "rmsnorm_residual", "ssd_chunk"):
            hit = [e for e in rows if is_kernel(k, e.key)]
            n = sum(e.count for e in hit)
            kernels[k] = dict(launches=n, device_us_per_launch=(
                sum(e.self_device_time_total for e in hit) / n
                if n else None))
        top = sorted(rows, key=lambda e: -e.self_device_time_total)[:10]
        out.append(dict(
            function=fn.name, arch=fn.cfg.name, prompt=fn.prompt_len,
            gen_tokens=fn.gen_tokens, wall_s=wall,
            device_busy_s=dev_us * 1e-6,
            device_busy_share=dev_us * 1e-6 / wall,
            device_ops=sum(e.count for e in rows), kernels=kernels,
            sm_clock_mhz=clock.summary(),
            top=[dict(name=e.key[:80], count=e.count,
                      device_us=e.self_device_time_total) for e in top]))
    emit(dict(phase="profile_serving", requests=out))

# ----------------------------------------- phase 3b: the serving kernels
def _tol_use(got, want, tol, abs_v=None):
    """max |got - want| / limit, with the limit atol + rtol |want| (+
    p_round * abs_v, the plain attention of |v|, where the kernel rounds
    its weights): at most 1 within the limit."""
    g, w = got.float(), want.float()
    lim = tol["atol"] + tol["rtol"] * w.abs()
    if "p_round" in tol:
        lim = lim + tol["p_round"] * abs_v
    return ((g - w).abs() / lim).max().item()


def _close(torch, name, case, got, want, fault, abs_v=None, what=None):
    """Hold ``got`` within KERNEL_TOL[name] of the plain version
    ``want``, and make sure the same check fails for the planted fault
    ``fault`` (FAULTS[what or name]) in its place. Returns the numbers
    the kernel row carries."""
    tol = KERNEL_TOL[name]
    err = (got.float() - want.float()).abs().max().item()
    need(bool(torch.isfinite(got.float()).all()),
         f"{name} {case}: non-finite output")
    use = _tol_use(got, want, tol, abs_v)
    need(use <= 1.0, f"{name} {case}: max |kernel - plain| = {err} "
         f"beyond {tol} ({use:.3g} of the limit)")
    # the same check on a kernel whose output were the fault
    caught = _tol_use(fault, want, tol, abs_v)
    need(caught > 1.0, f"{name} {case}: the limit {tol} does not reject "
         f"the planted fault ({FAULTS[what or name]}): {caught:.3g} of the "
         "limit")
    return dict(max_abs_err=err, tol_use=use, fault_ratio=caught,
                typical_abs=want.float().abs().mean().item())


def attention_f32(torch, q, k, v, allowed):
    """Softmax attention in f32 over the key positions ``allowed`` (an
    (S, T) bool mask), GQA by repeating kv heads, the output in q's
    dtype: the planted faults of the attention kernels."""
    g = q.shape[2] // k.shape[2]
    kf = k.repeat_interleave(g, dim=2).float()
    vf = v.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bshd,bthd->bhst", q.float(), kf) / math.sqrt(
        q.shape[-1])
    p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)


def mla_f32(torch, q_abs, q_rope, c_kv, k_rope, allowed, scale,
            value=None, rope=True):
    """The MLA decode attention in f32 over the positions ``allowed`` (a
    (T,) bool mask), the rope term left out when not ``rope``, the
    weights applied to ``value`` (default c_kv), the result in q_abs's
    dtype: the planted faults of K3-mla and (``value`` |c_kv|) the
    attention of |c_kv| its limit's ``p_round`` term takes."""
    c = c_kv.float()
    s = torch.einsum("bshr,btr->bhst", q_abs.float(), c)
    if rope:
        s = s + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             k_rope.float())
    p = torch.softmax((s * scale).masked_fill(~allowed, float("-inf")),
                      dim=-1)
    v = c if value is None else value.float()
    return torch.einsum("bhst,btr->bshr", p, v).to(q_abs.dtype)


def rmsnorm_fault(torch, s, w, eps, dtype):
    """RMSNorm of the rows ``s`` (f32) with the last eighth of each row
    left out of the sum of squares, cast to ``dtype`` (the planted fault
    of K4a and K4b)."""
    D = s.shape[-1]
    var = s[..., :D - D // 8].square().sum(-1, keepdim=True) / D
    return (s * torch.rsqrt(var + eps) * w.float()).to(dtype)


def phase_serving_kernels(torch, FA, DA, RN):
    """K2, K3, K4a and K4b against their plain versions on the card, at
    the serving path's shapes (B = 1, H = 32, KVH = 8, D = 128, d 2560,
    bf16; K4a and K4b also at Mamba2-780M's and Zamba2-2.7B's widths and
    at decode rows, and through their general body at an odd width and
    a view off 16 bytes), with the kernel's, the plain version's and one
    PyTorch call's times (the yardstick; the port never calls it; for
    K4b the two calls it fuses, as ``fused_pair``) and the bound."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    H, KVH, D, d = 32, 8, 128, 2560
    # calls a trial and trials (20 and 5 until the MoE and window phases
    # needed the room)
    timing = dict(reps=10, trials=3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    def row(kernel, case, check, call, plain, library, n_bytes, n_ops,
            kind, pair=None, timing=timing, old_body=None):
        """The case's row: the kernel, its plain version, the library call,
        (K4b) the ``pair`` of calls it fuses and (K3-mla) the kernel on
        its ``old_body``, the CUDA-core one, timed in turns."""
        b, by = bound_ms(n_bytes, n_ops, kind)
        timed = [f for f in (call, plain, library, pair, old_body)
                 if f is not None]
        ms = dict(zip(timed, time_in_turns(torch, timed, **timing)))
        out = dict(kernel=kernel, case=case, **check, ms=ms[call],
                   plain_ms=ms[plain], library_ms=ms.get(library),
                   device_ms=device_ms(torch, call),
                   plain_device_ms=device_ms(torch, plain),
                   library_device_ms=(None if library is None
                                      else device_ms(torch, library)),
                   bound_ms=b, bound_by=by, bytes=n_bytes, ops=n_ops)
        if pair is not None:
            out.update(fused_pair_ms=ms[pair],
                       fused_pair_device_ms=device_ms(torch, pair),
                       fused_pair_note="two PyTorch calls, torch.add then "
                                       "F.rms_norm: not a one-call library "
                                       "time")
        if old_body is not None:
            out.update(cuda_core_ms=ms[old_body],
                       cuda_core_device_ms=device_ms(torch, old_body))
        return out

    rows = []

    def flash_case(case, B, S, Hq, KVHq, Dq):
        """K2 causal at (B, S, Hq, KVHq, Dq), its fault a dropped kv tile
        of 64 at S/2; SDPA (with enable_gqa where Hq > KVHq) beside it."""
        q = randn(B, S, Hq, Dq)
        k, v = randn(B, S, KVHq, Dq), randn(B, S, KVHq, Dq)
        call = partial(FA.flash_attention, q, k, v, causal=True)
        plain = partial(FA.flash_attention_plain, q, k, v, causal=True)
        pos = torch.arange(S, device=dev)
        allowed = (pos[:, None] >= pos[None, :]) & ~(
            (pos >= S // 2) & (pos < S // 2 + 64))[None, :]
        check = _close(torch, "flash_attention", case, call(), plain(),
                       attention_f32(torch, q, k, v, allowed),
                       FA.flash_attention_plain(q.float(), k.float(),
                                                v.float().abs()))
        rows.append(row(
            "flash_attention", case, check, call, plain,
            partial(F.scaled_dot_product_attention,
                    *(x.transpose(1, 2) for x in (q, k, v)),
                    is_causal=True, enable_gqa=Hq > KVHq),
            2 * B * (2 * S * Hq * Dq + 2 * S * KVHq * Dq),
            4 * B * Hq * Dq * S * (S + 1) // 2, "bf16"))

    def decode_case(case, q, kc, vc, length):
        """K3 at ``length``, its fault a dropped kv tile of 64 around
        length/2 (length 0: position 1 attended too)."""
        B, T, KVHq, Dq = kc.shape
        Hq, n = q.shape[2], length + 1
        call = partial(DA.decode_attention, q, kc, vc, length)
        plain = partial(DA.decode_attention_plain, q, kc, vc, length)
        pos = torch.arange(T, device=dev)
        if length == 0:
            allowed = pos <= 1
        else:
            t0 = length // 2 // 64 * 64
            allowed = (pos <= length) & ~((pos >= t0) & (pos < t0 + 64))
        check = _close(torch, "decode_attention", case, call(), plain(),
                       attention_f32(torch, q, kc, vc, allowed[None, :]))
        rows.append(row(
            "decode_attention", case, check, call, plain,
            partial(F.scaled_dot_product_attention, q.transpose(1, 2),
                    kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2),
                    enable_gqa=Hq > KVHq),
            2 * B * (2 * Hq * Dq + 2 * n * KVHq * Dq), 4 * B * Hq * Dq * n,
            "bf16"))

    def window_case(S, W, Hq, KVHq, Dq, dtype):
        """K2 with the sliding window W (row i sees keys i - W..i), its
        fault the band one key too wide; at W >= 64 also the 64 keys at
        the band's far edge dropped (both must be rejected); SDPA with
        the band as a boolean mask beside it."""
        case = f"window W={W} S={S} H={Hq} KVH={KVHq} D={Dq} " + (
            "bf16" if dtype == bf16 else "f32")
        q = randn(1, S, Hq, Dq).to(dtype)
        k, v = randn(1, S, KVHq, Dq).to(dtype), randn(1, S, KVHq, Dq).to(
            dtype)
        call = partial(FA.flash_attention, q, k, v, window=W)
        plain = partial(FA.flash_attention_plain, q, k, v, window=W)
        band = FA.band_mask(S, S, W, dev)
        pos = torch.arange(S, device=dev)
        d = pos[:, None] - pos[None, :]
        want = plain()
        abs_v = FA.flash_attention_plain(q.float(), k.float(),
                                         v.float().abs(), window=W)
        check = _close(torch, "flash_attention", case, call(), want,
                       attention_f32(torch, q, k, v,
                                     (d >= 0) & (d <= W + 1)), abs_v)
        if W >= 64:
            edge = attention_f32(torch, q, k, v, (d >= 0) & (d <= W - 64))
            check["fault_edge_ratio"] = _tol_use(
                edge, want, KERNEL_TOL["flash_attention"], abs_v)
            need(check["fault_edge_ratio"] > 1.0,
                 f"flash_attention {case}: the limit does not reject the "
                 "band's far 64 keys dropped")
            check["fault_ratio"] = min(check["fault_ratio"],
                                       check["fault_edge_ratio"])
        del want, abs_v
        keys = int(torch.clamp(pos, max=W).sum()) + S   # visible pairs
        size = 2 if dtype == bf16 else 4
        rows.append(dict(row(
            "flash_attention", case, check, call, plain,
            partial(F.scaled_dot_product_attention,
                    *(x.transpose(1, 2) for x in (q, k, v)),
                    attn_mask=band, enable_gqa=Hq > KVHq),
            size * (2 * S * Hq * Dq + 2 * S * KVHq * Dq),
            4 * Hq * Dq * keys, "bf16" if dtype == bf16 else "f32",
            timing=dict(reps=5, trials=3)), window=W))

    for S in (256, 512, 2048):
        flash_case(f"causal S={S}", 1, S, H, KVH, D)
    flash_case("causal S=2000", 1, 2000, H, KVH, D)     # a ragged q tile
    flash_case("causal B=2 S=2000", 2, 2000, H, KVH, D)
    # Zamba2-2.7B's shared block: MHA, 32 heads of 80, prompt 1024
    H8, D8 = 32, 80
    flash_case("D=80 causal S=1024", 1, 1024, H8, H8, D8)
    # the window (ROADMAP Queue 1, item 6.2): Zamba2's shared block past
    # its cache of 4096, Qwen3's widths at W 1000, and small windows
    t_win = time.perf_counter()
    for dtype in (bf16, torch.float32):
        for S, W, Hq, KVHq, Dq in WINDOW_CASES:
            window_case(S, W, Hq, KVHq, Dq, dtype)
    t_win = time.perf_counter() - t_win
    T = 1280
    kc, vc = randn(1, T, H8, D8), randn(1, T, H8, D8)
    q = randn(1, 1, H8, D8)
    for length in (0, 1039):
        decode_case(f"D=80 T={T} length={length}", q, kc, vc, length)
    T = 2560
    kc, vc = randn(1, T, KVH, D), randn(1, T, KVH, D)
    q = randn(1, 1, H, D)
    for length in (0, 1000, T - 1):
        decode_case(f"T={T} length={length}", q, kc, vc, length)
    decode_case(f"B=2 T={T} length={T - 1}", randn(2, 1, H, D),
                randn(2, T, KVH, D), randn(2, T, KVH, D), T - 1)

    def mla_flash_case(S, Hm, Dq, Dv, dtype):
        """K2 at MLA's head dims (q/k Dq, v Dv), H = KVH, causal, scale
        1/sqrt(Dq); its fault v's last 64 dims dropped; SDPA beside it."""
        case = f"mla causal S={S} H={Hm} D={Dq} Dv={Dv} " + (
            "bf16" if dtype == bf16 else "f32")
        q, k = randn(1, S, Hm, Dq).to(dtype), randn(1, S, Hm, Dq).to(dtype)
        v = randn(1, S, Hm, Dv).to(dtype)
        scale = 1.0 / math.sqrt(Dq)
        call = partial(FA.flash_attention, q, k, v, scale=scale)
        plain = partial(FA.flash_attention_plain, q, k, v, scale=scale)
        want = plain()
        abs_v = FA.flash_attention_plain(q.float(), k.float(),
                                         v.float().abs(), scale=scale)
        short = v.clone()
        short[..., 64:] = 0
        check = _close(torch, "flash_attention", case, call(), want,
                       FA.flash_attention_plain(q, k, short, scale=scale),
                       abs_v, what="flash_attention_mla")
        del want, abs_v, short
        size = 2 if dtype == bf16 else 4
        rows.append(dict(row(
            "flash_attention", case, check, call, plain,
            partial(F.scaled_dot_product_attention,
                    *(x.transpose(1, 2) for x in (q, k, v)),
                    is_causal=True, scale=scale),
            size * S * Hm * (2 * Dq + 2 * Dv),
            Hm * (Dq + Dv) * S * (S + 1), "bf16" if dtype == bf16 else "f32",
            timing=dict(reps=5, trials=3)), mla=True))

    def mla_decode_case(B, Tm, length, dtype):
        """K3-mla at H 128, (R, DR) = (512, 64), scale 1/sqrt(128 + 64);
        its faults the mask one position too long (at length T - 1 one
        too short) and the rope term dropped (not at length 0: a single
        position takes all the weight whatever its score); SDPA over the
        one shared latent head (k = [c_kv, k_rope], v = c_kv, every
        query head its group) beside it."""
        Hm, R, DR = 128, 512, 64
        case = f"mla B={B} T={Tm} length={length} " + (
            "bf16" if dtype == bf16 else "f32")
        q_abs, q_rope = randn(B, 1, Hm, R).to(dtype), randn(
            B, 1, Hm, DR).to(dtype)
        c_kv, k_rope = randn(B, Tm, R).to(dtype), randn(B, Tm, DR).to(dtype)
        scale = 1.0 / math.sqrt(128 + DR)
        args = (q_abs, q_rope, c_kv, k_rope, length)
        call = partial(DA.mla_decode_attention, *args, scale=scale)
        plain = partial(DA.mla_decode_attention_plain, *args, scale=scale)
        pos = torch.arange(Tm, device=dev)
        seen = pos <= length
        off = pos <= length + 1 if length + 1 < Tm else pos < length
        want = plain()
        f = partial(mla_f32, torch, q_abs, q_rope, c_kv, k_rope,
                    scale=scale)
        abs_v = f(seen, value=c_kv.abs()).float()
        # the body the rule picks (bf16: the tensor cores), by the counts,
        # and a repeated call bitwise equal
        body = "mma" if dtype == bf16 else "cuda_core"
        before = dict(DA.mla_decode_attention.body_launches)
        got, again = call(), call()
        torch.cuda.synchronize()
        need(DA.mla_decode_attention.body_launches == {
            k: v + 2 * (k == body) for k, v in before.items()},
            f"mla_decode_attention {case}: did not run twice on the {body} "
            "body")
        need(torch.equal(got, again),
             f"mla_decode_attention {case}: two calls differ bitwise")
        check = _close(torch, "mla_decode_attention", case, got, want,
                       f(off), abs_v)
        tol = KERNEL_TOL["mla_decode_attention"]
        check.update(body=body, bitwise_repeat=True)
        # the served row in bf16: the CUDA-core body on the same inputs,
        # held to the same limit and timed beside the tensor-core one
        old_body = None
        if dtype == bf16 and (B, length) == (1, Tm - 1):
            old_body = partial(call, body="cuda_core")
            check["cuda_core_tol_use"] = _tol_use(old_body(), want, tol,
                                                  abs_v)
            need(check["cuda_core_tol_use"] <= 1.0,
                 f"mla_decode_attention {case}: the CUDA-core body is "
                 f"{check['cuda_core_tol_use']:.3g} of the limit")
        check["fault_rope_ratio"] = None
        if length > 0:
            check["fault_rope_ratio"] = _tol_use(f(seen, rope=False), want,
                                                 tol, abs_v)
            need(check["fault_rope_ratio"] > 1.0,
                 f"mla_decode_attention {case}: the limit does not reject "
                 "the rope term dropped")
            check["fault_ratio"] = min(check["fault_ratio"],
                                       check["fault_rope_ratio"])
        del want, abs_v
        n = min(length + 1, Tm)
        kq = torch.cat([q_abs, q_rope], -1).transpose(1, 2)
        kk = torch.cat([c_kv, k_rope], -1)[:, None, :n]
        kv = c_kv[:, None, :n]
        size = 2 if dtype == bf16 else 4
        rows.append(dict(row(
            "mla_decode_attention", case, check, call, plain,
            partial(F.scaled_dot_product_attention, kq, kk, kv,
                    scale=scale, enable_gqa=True),
            size * B * (Hm * (R + DR) + n * (R + DR) + Hm * R),
            2 * B * Hm * n * (2 * R + DR),
            "bf16" if dtype == bf16 else "f32", old_body=old_body),
            mla=True))

    # MLA (DeepSeek-V3): K2 at head dims (192, 128) and K3-mla
    t_mla = time.perf_counter()
    for dtype in (bf16, torch.float32):
        for S, Hm, Dq, Dv in MLA_FLASH_CASES:
            mla_flash_case(S, Hm, Dq, Dv, dtype)
        for B, Tm, length in MLA_DECODE_CASES:
            mla_decode_case(B, Tm, length, dtype)
    t_mla = time.perf_counter() - t_mla
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count

    def norm_body(x, extra, w, want):
        """The body `_plan` gives these inputs, held to ``want``."""
        ptrs = [t.data_ptr() for t in (x, w, *extra)]
        aligned = not any(p & 15 for p in ptrs)
        R, Dn = x.numel() // x.shape[-1], x.shape[-1]
        body = RN._plan(R, Dn, x.dtype, w.dtype, aligned, n_sms).body
        need(body == want, f"rmsnorm ({R}, {Dn}): _plan chose the {body} "
             f"body, not the {want} one")
        return body

    def inputs(R, Dn, offset):
        """x (R, Dn) ``offset`` elements into its buffer (1: off 16 bytes),
        and the timing: decode-sized calls are host-bound, so more calls
        a trial and more trials."""
        x = randn(R * Dn + offset)[offset:].view(R, Dn)
        small = R * Dn <= 1 << 16
        return x, dict(reps=200, trials=15) if small else timing

    def norm_case(R, Dn, body="vector", offset=0):
        """K4a at (R, Dn), bf16, F.rms_norm beside it."""
        x, times = inputs(R, Dn, offset)
        w = (1.0 + 0.1 * randn(Dn)).to(bf16)
        case = f"({R}, {Dn})" + (f" offset {offset}" if offset else "")
        call = partial(RN.rmsnorm, x, w, eps=1e-6)
        plain = partial(RN.rmsnorm_plain, x, w, 1e-6)
        got = call()
        norm_body(x, [got], w, body)
        check = _close(torch, "rmsnorm", case, got, plain(),
                       rmsnorm_fault(torch, x.float(), w, 1e-6, bf16))
        rows.append(dict(row(
            "rmsnorm", case, check, call, plain,
            partial(F.rms_norm, x, (Dn,), w, eps=1e-6),
            2 * (2 * R * Dn + Dn), 4 * R * Dn, "f32", timing=times),
            body=body))

    def residual_case(R, Dn, body="vector", offset=0):
        """K4b at (R, Dn), bf16, its residual bitwise the plain one's;
        the two PyTorch calls it fuses (torch.add, then F.rms_norm)
        timed beside it as ``fused_pair``."""
        x, times = inputs(R, Dn, offset)
        r, w = randn(R, Dn), (1.0 + 0.1 * randn(Dn)).to(bf16)
        case = f"({R}, {Dn})" + (f" offset {offset}" if offset else "")
        call = partial(RN.rmsnorm_residual, x, r, w, eps=1e-6)
        plain = partial(RN.rmsnorm_residual_plain, x, r, w, 1e-6)
        (kn, kr), (pn, pr) = call(), plain()
        norm_body(x, [r, kn, kr], w, body)
        check = _close(torch, "rmsnorm_residual", case, kn, pn,
                       rmsnorm_fault(torch, x.float() + r.float(), w, 1e-6,
                                     bf16))
        need(torch.equal(kr, pr), f"rmsnorm_residual {case}: the "
             "residual is not bitwise the plain version's")

        def pair():
            return F.rms_norm(torch.add(x, r), (Dn,), w, eps=1e-6)
        rows.append(dict(row(
            "rmsnorm_residual", case, check, call, plain, None,
            2 * (4 * R * Dn + Dn), 5 * R * Dn, "f32", pair=pair,
            timing=times), body=body))

    # K4a: Qwen3-4B's prefill hidden norm and q-norm (the kernels line's
    # case first), a decode step's hidden norm and q-norm, Mamba2-780M's
    # gate norm over 2,000 tokens, Zamba2-2.7B's decode gate norm; then
    # the general body at an odd width and at a view off 16 bytes
    t_norm = time.perf_counter()
    for R, Dn in ((2048, d), (2048 * H, D), (1, d), (32, D), (2000, 3072),
                  (1, 5120)):
        norm_case(R, Dn)
    norm_case(7, 1001, "general")
    norm_case(64, d, "general", offset=1)
    # K4b: Qwen3-4B's prefill and decode, Mamba2-780M's prefill; general
    for R, Dn in ((2048, d), (1, d), (2048, 1536)):
        residual_case(R, Dn)
    residual_case(7, 1001, "general")
    residual_case(64, d, "general", offset=1)
    t_norm = time.perf_counter() - t_norm
    emit(dict(phase="kernel", serving=rows, rmsnorm_cases_s=t_norm,
              window_cases_s=t_win, mla_cases_s=t_mla,
              mla_ptxas=mla_ptxas()))
    return rows


def mla_ptxas():
    """The ptxas lines of K3-mla's two bodies (registers, spills; the
    CUDA-core body's bf16 and f32 instances)."""
    from repro_torch.kernels import _build
    report = _build.BUILD_INFO.get("mla_decode", {}).get("ptxas", "")
    return dict(mma=ptxas_lines(report, "mla_decode_mma_kernel"),
                cuda_core=ptxas_lines(report, "17mla_decode_kernel"))


# --------------------------------------- phase 3d: the backward kernels
def _grads_close(torch, name, case, gots, wants, faults, extras, tol):
    """Hold each output of a backward kernel (``gots``) within ``tol`` of
    the plain backward's (``wants``), the limit atol + rtol |want| plus
    ``extras`` (None or a tensor, already scaled), and make sure the same
    limit rejects the planted fault (``faults``) in at least one output.
    Returns the numbers the kernel row carries."""
    uses, caught, errs = [], [], []
    for g, w, f, x in zip(gots, wants, faults, extras):
        g, w, f = g.float(), w.float(), f.float()
        need(bool(torch.isfinite(g).all()), f"{name} {case}: non-finite "
             "output")
        lim = tol["atol"] + tol["rtol"] * w.abs()
        if x is not None:
            lim = lim + x
        uses.append(((g - w).abs() / lim).max().item())
        caught.append(((f - w).abs() / lim).max().item())
        errs.append((g - w).abs().max().item())
    need(max(uses) <= 1.0, f"{name} {case}: max |kernel - plain| = "
         f"{max(errs)} beyond {tol} ({max(uses):.3g} of the limit)")
    need(max(caught) > 1.0, f"{name} {case}: the limit {tol} does not "
         f"reject the planted fault ({FAULTS[name]}): {max(caught):.3g}")
    return dict(max_abs_err=max(errs), tol_use=max(uses),
                fault_ratio=max(caught), tol_use_by_output=uses,
                max_abs_err_by_output=errs,
                typical_abs=[w.float().abs().mean().item() for w in wants])


def phase_training_kernels(torch, np, FA, RN, K5):
    """The backward kernels against their plain backwards on the card, at
    the train phase's full-width shapes (Qwen3-4B: B = 4, S = 1024, H =
    32, KVH = 8, D = 128; Zamba2-2.7B's shared block at H = KVH = 32, D =
    80; the norms' rows (4096, 2560) and the qk-norm's (4096 x 32, 128);
    K5-bwd at Mamba2-780M's and Zamba2-2.7B's training shapes, B = 4, S =
    1024, on its wgmma body), bf16, and in f32 at small shapes (K5-bwd on
    its CUDA-core body, each row naming its body): each within its limit, a
    planted fault rejected, two runs bitwise equal; K2's forward
    log-sum-exp against torch.logsumexp, the forward timed with and
    without it; the kernel's, the plain backward's and one PyTorch call's
    times (the autograd backward of F.scaled_dot_product_attention or
    F.rms_norm: a yardstick the port never calls; none computes K5's
    backward) and the bound."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(1)
    timing = dict(reps=10, trials=3)   # 5 trials before the MoE phases
    rows = []

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def grads_of(fn, inputs, g):
        """autograd of fn(*inputs) for the output gradient g (a tuple for
        a tuple of outputs), on f32 copies."""
        xs = [x.detach().float().requires_grad_() for x in inputs]
        gs = tuple(t.float() for t in g) if isinstance(g, tuple) else \
            g.float()
        with torch.enable_grad():
            return torch.autograd.grad(fn(*xs), xs, gs)

    def timed_row(name, case, check, call, plain, library, n_bytes, n_ops,
                  kind, **extra):
        b, by = bound_ms(n_bytes, n_ops, kind)
        timed = [f for f in (call, plain, library) if f is not None]
        ms = dict(zip(timed, time_in_turns(torch, timed, **timing)))
        rows.append(dict(kernel=name, case=case, **check, ms=ms[call],
                         plain_ms=ms[plain], library_ms=ms.get(library),
                         device_ms=device_ms(torch, call, reps=5),
                         bound_ms=b, bound_by=by, bytes=n_bytes, ops=n_ops,
                         **extra))

    def attn_case(case, B, S, H, KVH, D, dtype):
        q, do = randn(B, S, H, D, dtype=dtype), randn(B, S, H, D, dtype=dtype)
        k, v = (randn(B, S, KVH, D, dtype=dtype) for _ in range(2))
        scale = 1.0 / math.sqrt(D)
        # the plain forward's output, rounded once; the kernel's LSE
        o = FA.flash_attention_plain(q, k, v).contiguous()
        _, lse = FA._forward(q, k, v, True, None, True)
        g = H // KVH
        s = torch.einsum("bshd,bthd->bhst", q.float(),
                         k.repeat_interleave(g, 2).float()) * scale
        pos = torch.arange(S, device=dev)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), float("-inf"))
        want_lse = torch.logsumexp(s, -1)
        lse_err = (lse - want_lse).abs().max().item()
        need(lse_err <= 1e-5 * (1.0 + want_lse.abs().max().item()),
             f"flash_attention {case}: the log-sum-exp is {lse_err} off")
        del s
        call = partial(FA.flash_attention_backward, q, k, v, o, do, lse)
        got, again = call(), call()
        need(all(torch.equal(a, b) for a, b in zip(got, again)),
             f"flash_attention_backward {case}: two runs differ")
        want = grads_of(partial(FA.flash_attention_plain, causal=True),
                        (q, k, v), do)
        allowed = (pos[:, None] >= pos[None, :]) & ~(
            (pos >= S // 2) & (pos < S // 2 + 64))[None, :]
        fault = grads_of(lambda a, b, c: attention_f32(torch, a, b, c,
                                                       allowed),
                         (q, k, v), do)
        if dtype == bf16:
            tol = KERNEL_TOL["flash_attention_backward"]
            extras = [tol["o_round"] * t + tol["p_round"] * u
                      for t, u in zip(FA.backward_o_terms(q, k, v, o, do),
                                      FA.backward_round_terms(q, k, v, do))]
        else:
            tol, extras = F32_GRAD_TOL, [None] * 3
        check = _grads_close(torch, "flash_attention_backward", case, got,
                             want, fault, extras, tol)
        del fault, extras
        plain = partial(FA.flash_attention_backward_plain, q, k, v, do)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        with torch.enable_grad():
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                enable_gqa=H > KVH)
        dot = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                       retain_graph=True)
        fwd = 4 * B * H * D * S * (S + 1) // 2
        es = q.element_size()
        fwd_ms, fwd_lse_ms = time_in_turns(torch, [
            partial(FA.flash_attention, q, k, v),
            partial(FA._forward, q, k, v, True, None, True)], **timing)
        kind = "bf16" if dtype == bf16 else "f32"
        timed_row("flash_attention_backward", case, check, call, plain,
                  library, es * (2 * 3 * B * S * H * D + 2 * 2 * B * S * KVH
                                 * D) + 4 * B * H * S,
                  int(2.5 * fwd), kind,
                  deterministic=True, lse_max_abs_err=lse_err,
                  forward_ms=fwd_ms, forward_lse_ms=fwd_lse_ms,
                  # the design's own floor: with the scores and do . v
                  # formed in both passes, 3.5 times the forward's work
                  design_bound_ms=1e3 * 3.5 * fwd / PEAK_OPS_PER_S[kind],
                  device_ms_by_kernel=device_split(torch, call, reps=5))

    def norm_case(name, case, R, D, dtype, residual, with_gres):
        x, g = randn(R, D, dtype=dtype), randn(R, D, dtype=dtype)
        w = (1.0 + 0.1 * randn(D)).to(dtype)
        r = randn(R, D, dtype=dtype) if residual else None
        gres = randn(R, D, dtype=dtype) if with_gres else None
        eps = 1e-6
        if residual:
            call = partial(RN.rmsnorm_residual_backward, x, r, w, g, gres,
                           eps=eps)
            plain = partial(RN.rmsnorm_residual_backward_plain, x, r, w, g,
                            gres, eps)
        else:
            call = partial(RN.rmsnorm_backward, x, w, g, eps=eps)
            plain = partial(RN.rmsnorm_backward_plain, x, w, g, eps)
        got, again = call(), call()
        need(all(torch.equal(a, b) for a, b in zip(got, again)),
             f"{name} {case}: two runs differ")
        s = x.float() + (0.0 if r is None else r.float())
        sd, wd = s.detach().requires_grad_(), w.detach().float() \
            .requires_grad_()
        with torch.enable_grad():
            dsf, dwf = torch.autograd.grad(
                rmsnorm_fault(torch, sd, wd, eps, f32), (sd, wd), g.float())
        if gres is not None:
            dsf = dsf + gres.float()
        tol = KERNEL_TOL[name] if dtype == bf16 else F32_GRAD_TOL
        check = _grads_close(torch, name, case, got, plain(), (dsf, dwf),
                             (None, None), tol)
        library = None
        if not residual:
            xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
            with torch.enable_grad():
                y = F.rms_norm(xr, (D,), wr, eps=eps)

            def library():
                return torch.autograd.grad(y, (xr, wr), g,
                                           retain_graph=True)
        es = x.element_size()
        reads = 2 + int(residual) + int(with_gres)
        timed_row(name, case, check, call, plain, library,
                  es * ((reads + 1) * R * D + 2 * D), 10 * R * D, "f32",
                  deterministic=True,
                  **({} if library else dict(
                      library_note="no single PyTorch call")))

    def ssd_case(case, shape, xd, bcd, valid=None):
        b, nc, c, h, p, n, g = shape
        args = ssd_inputs(torch, np, b, nc, c, h, p, n, g, xd, bcd,
                          seed=len(rows), valid=valid)
        r = np.random.default_rng(len(rows) + 100)
        dy = torch.tensor(r.normal(size=(b, nc, c, h, p)), dtype=f32,
                          device=dev)
        dS = torch.tensor(r.normal(size=(b, nc, h, p, n)), dtype=f32,
                          device=dev)
        call = partial(K5.ssd_chunk_backward, *args, dy, dS)
        body = K5.body_for(args[0], args[3], args[4])
        want_body = "wgmma" if xd == bf16 and bcd == bf16 else "cuda_core"
        before = dict(K5.ssd_chunk_backward.body_launches)
        got, again = call(), call()
        need(body == want_body and K5.ssd_chunk_backward.body_launches == {
            k: v + 2 * (k == want_body) for k, v in before.items()},
            f"ssd_chunk_backward {case}: ran on {body}, not {want_body}")
        need(all(torch.equal(a, b) for a, b in zip(got, again)),
             f"ssd_chunk_backward {case}: two runs differ")
        plain = partial(K5.ssd_chunk_backward_plain, *args, dy, dS)
        want = plain()
        fault = grads_of(lambda *a: ssd_fault_forward(torch, *a), args,
                         (dy, dS))
        tol = KERNEL_TOL["ssd_chunk_backward"]
        extras = [tol["out_round"] * w.float().abs()
                  if w.dtype == bf16 else None for w in want]
        check = _grads_close(torch, "ssd_chunk_backward", case, got, want,
                             fault, extras, tol)
        del fault, extras, want, again
        # the bound at the card's rate for the operands' type: x, B and
        # C in bf16 at the tensor cores' rate (the weights split in three
        # bf16 parts), else at the f32 CUDA-core rate; the f32 CUDA-core
        # bound of the same work beside it (the rate this body runs at)
        n_bytes, f32_ops, tc_ops = ssd_bwd_work(args[0], args[3])
        b_f32, by_f32 = bound_ms(n_bytes, f32_ops, "f32")
        tc = body == "wgmma"
        timed_row("ssd_chunk_backward", case, check, call, plain, None,
                  n_bytes, tc_ops if tc else f32_ops, "bf16" if tc else
                  "f32", deterministic=True,
                  library_note="no single PyTorch call", body=body,
                  **ssd_bwd_floor(args[0], args[3], body),
                  bound_f32_ms=b_f32, bound_f32_by=by_f32,
                  f32_ops=f32_ops, tc_ops=tc_ops,
                  device_ms_by_kernel=device_split(torch, call, reps=5))

    attn_case("f32 B=2 S=200 D=32", 2, 200, 4, 2, 32, f32)
    attn_case("bf16 B=4 S=1024", 4, 1024, 32, 8, 128, bf16)
    attn_case("bf16 B=2 S=1000", 2, 1000, 32, 8, 128, bf16)  # ragged tile
    # Zamba2-2.7B's shared block (MHA, D = 80) at the train phase's B
    attn_case("bf16 B=4 S=1024 D=80", 4, 1024, 32, 32, 80, bf16)
    attn_case("f32 B=1 S=200 D=80", 1, 200, 4, 4, 80, f32)
    torch.cuda.empty_cache()
    dtypes = dict(bf16=bf16, f32=f32)
    for case, shape, xd, bcd, valid in SSD_BWD_CASES:
        ssd_case(case, shape, dtypes[xd], dtypes[bcd], valid=valid)
    torch.cuda.empty_cache()
    norm_case("rmsnorm_backward", "(4096, 2560)", 4096, 2560, bf16, False,
              False)
    norm_case("rmsnorm_backward", "(131072, 128)", 4096 * 32, 128, bf16,
              False, False)
    norm_case("rmsnorm_backward", "(32768, 128)", 4096 * 8, 128, bf16,
              False, False)
    norm_case("rmsnorm_backward", "f32 (7, 1001)", 7, 1001, f32, False,
              False)
    norm_case("rmsnorm_residual_backward", "(4096, 2560) gres", 4096, 2560,
              bf16, True, True)
    norm_case("rmsnorm_residual_backward", "(4096, 2560)", 4096, 2560, bf16,
              True, False)
    norm_case("rmsnorm_residual_backward", "f32 (33, 1001) gres", 33, 1001,
              f32, True, True)
    emit(dict(phase="kernel", training=rows))
    return rows


# K5-bwd's cases in the kernel phase: (name, (b, nc, c, h, p, n, g), x
# dtype, B and C dtype, valid length): the training shapes (B 4, S 1024:
# 4 chunks of 256), a ragged S 1000 and g 8 on the wgmma body; f32 on the
# CUDA-core body
_MAMBA_BWD, _ZAMBA_BWD = (4, 4, 256, 48, 64, 128, 1), (4, 4, 256, 80, 64,
                                                       64, 1)
SSD_BWD_CASES = (
    ("mamba2-780m bf16 B=4 S=1024", _MAMBA_BWD, "bf16", "bf16", None),
    ("zamba2-2.7b bf16 B=4 S=1024", _ZAMBA_BWD, "bf16", "bf16", None),
    ("mamba2-780m bf16 B=1 S=1000 ragged", (1,) + _MAMBA_BWD[1:], "bf16",
     "bf16", 1000),
    ("g=8 bf16 B=1 S=1024", (1,) + _MAMBA_BWD[1:6] + (8,), "bf16", "bf16",
     None),
    ("mamba2-780m f32 B=1 S=1024", (1,) + _MAMBA_BWD[1:], "f32", "f32",
     None),
)


# ------------------------------------------------ phase 3c: K5, ssd_chunk
def ssd_inputs(torch, np, b, nc, c, h, p, n, g, xdtype, bcdtype, seed,
               valid=None):
    """K5's inputs on the card, made with numpy: mild decay (dt in [0.01,
    0.2], A in [-2, -0.5], as tests/test_kernels.py) so that every (s, t)
    term counts; x in ``xdtype``, B and C in ``bcdtype``; ``valid`` < nc
    * c zero-pads the tail as `ssd_chunked` pads a ragged length (x, dt,
    B, C zero there, cum flat)."""
    r = np.random.default_rng(seed)
    L = nc * c
    x = r.normal(size=(b, L, h, p))
    dt = r.uniform(0.01, 0.2, (b, L, h))
    A = -r.uniform(0.5, 2.0, (h,))
    B, C = r.normal(size=(2, b, L, g, n))
    if valid is not None:
        for a in (x, dt, B, C):
            a[:, valid:] = 0.0
    cum = np.cumsum((dt * A).reshape(b, nc, c, h), axis=2)
    f32 = torch.float32
    mk = lambda a, shape, d=f32: torch.tensor(  # noqa: E731
        a.reshape(shape), dtype=d, device="cuda")
    return (mk(x, (b, nc, c, h, p), xdtype), mk(dt, (b, nc, c, h)),
            mk(cum, (b, nc, c, h)), mk(B, (b, nc, c, g, n), bcdtype),
            mk(C, (b, nc, c, g, n), bcdtype))


def ssd_faults(torch, x, dt, cum, B, C, y, S):
    """The planted faults of K5 from the plain outputs (y, S): y without
    its diagonal term (C[s] . B[s]) dt[s] x[s], and the states without
    the last position's B[c-1] dt[c-1] (x) x[c-1] (decay exp(0) = 1)."""
    b, nc, c, h, p = x.shape
    g = B.shape[3]
    rep = lambda a: a.float().repeat_interleave(h // g, dim=3)  # noqa
    xf = x.float()
    diag = (rep(C) * rep(B)).sum(-1) * dt                   # (b,nc,c,h)
    y_fault = y - diag[..., None] * xf
    last = (rep(B)[:, :, -1] * dt[:, :, -1, :, None])       # (b,nc,h,n)
    S_fault = S - xf[:, :, -1, :, :, None] * last[:, :, :, None, :]
    return y_fault, S_fault


def ssd_work(x, B):
    """(bytes, f32 operations, tensor-core operations) of one K5 call:
    each input read once at its element size and each output written
    once; the f32 count is the s >= t scores and products, the weights
    (difference, exponent, two products) and the states with their
    decay; the tensor-core count is the wgmma body's passes: one for the
    scores, three (the weight's bf16 parts) for y and for the states."""
    b, nc, c, h, p = x.shape
    g, n = B.shape[3], B.shape[4]
    cells = b * nc * h
    tri = c * (c + 1) // 2
    n_bytes = (x.element_size() * cells * c * p + 4 * 2 * b * nc * c * h
               + B.element_size() * 2 * b * nc * c * g * n
               + 4 * cells * c * p + 4 * cells * p * n)
    f32_ops = cells * (2 * tri * (n + p) + 4 * tri + 2 * c * p * n
                       + 3 * c * n)
    tc_ops = cells * (2 * tri * n + 3 * 2 * tri * p + 3 * 2 * c * p * n)
    return n_bytes, f32_ops, tc_ops


def ssd_fault_forward(torch, x, dt, cum, B, C):
    """K5's plain forward (f32) without the causal tile pair s in [64,
    128), t in [0, 64): the planted fault of K5-bwd, by autograd."""
    c, h, g = x.shape[2], x.shape[3], B.shape[3]
    keep = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    keep[64:128, :64] = False
    Bh, Ch = (a.repeat_interleave(h // g, 3) for a in (B, C))
    diff = (cum[:, :, :, None] - cum[:, :, None]).masked_fill(
        ~keep[:, :, None], float("-inf"))
    sc = torch.einsum("bcshn,bcthn->bcsth", Ch, Bh)
    y = torch.einsum("bcsth,bcth,bcthp->bcshp", sc * torch.exp(diff), dt, x)
    w = torch.exp(cum[:, :, -1:] - cum) * dt
    return y, torch.einsum("bcthn,bcth,bcthp->bchpn", Bh, w, x)


def ssd_bwd_work(x, B):
    """(bytes, f32 operations, tensor-core operations) of one K5-bwd
    call: x, dt, cum, B, C, dy and dS read once and dx, ddt, dcum, dB and
    dC written once, at their element sizes; the operations the gradient
    needs over s >= t: once a (chunk, group), since B and C are the
    group's, the scores C B^T and G's two products, dC = G B and dB =
    G^T C (G = dM L dt summed over the group's heads first); once a
    head, dM = dy x^T, dx's M^T dy, the state's B dS^T and dS^T x, and
    the weights (exponent, products). The tensor-core count takes the
    same products at the bf16 rate under the f32 contract of K5's wgmma
    bodies: a product of two bf16 operands (the scores) one pass, an f32
    operand in three bf16 parts against a bf16 one (dy in dM, G against
    B and C, dS in the state terms) three, M^T dy (both f32) the six kept
    cross terms. What a body adds (the scores in both of its kinds of
    block and in every slice of heads, the scratch) is
    `ssd_bwd_floor`'s."""
    b, nc, c, h, p = x.shape
    g, n = B.shape[3], B.shape[4]
    cells, groups = b * nc * h, b * nc * g
    tri = c * (c + 1) // 2
    xs, bs = x.element_size(), B.element_size()
    n_bytes = (2 * xs * cells * c * p + 4 * 4 * b * nc * c * h
               + 2 * 2 * bs * b * nc * c * g * n + 4 * cells * c * p
               + 4 * cells * p * n)
    f32_ops = (cells * (2 * tri * 2 * p + 4 * c * p * n + 8 * tri)
               + groups * 2 * tri * 3 * n)
    tc_ops = (cells * (2 * tri * (3 + 6) * p + 3 * 2 * 2 * c * p * n)
              + groups * 2 * tri * (1 + 3 * 2) * n)
    return n_bytes, f32_ops, tc_ops


def ssd_bwd_floor(x, B, body):
    """The design's floor of one K5-bwd call on ``body``: the larger of
    the operations that body performs, at the peak rate of its operands'
    type, and the bytes it moves (the bound's plus its scratch, each
    written once and read once) at 3.35 TB/s. The wgmma body (see
    ``csrc/ssd_chunk_bwd.cu``): a dx block a head forms u (three passes)
    and, for each tile pair, the scores and the six-term dx; a G block a
    slice forms the scores a pair, dM (three passes) a head and pair and
    the state term (three passes) a head; the group pass G's three parts
    against B and C. Its scratch: dy's and dS's three bf16 parts, the
    slices' G tiles and state terms, the column and row sums, dw. The
    CUDA-core body forms, a head, the scores and dM in both roles, M^T
    dy, dM C and dM^T B, and the state terms (f32), and passes each
    head's dB and dC through f32 scratch."""
    b, nc, c, h, p = x.shape
    g, n = B.shape[3], B.shape[4]
    bnc, cells = b * nc, b * nc * h
    n_bytes = ssd_bwd_work(x, B)[0]
    nt = -(-c // 64)
    if body == "cuda_core":
        tri = c * (c + 1) // 2
        ops = cells * (2 * tri * (4 * n + 3 * p) + 4 * c * p * n + 8 * tri)
        scratch = 2 * (2 * 4 * cells * c * n + 4 * cells * nt)
        kind = "f32"
    else:
        cp, pairs, tile = 64 * nt, nt * (nt + 1) // 2, 64 * 64
        nsl = g * -(-(h // g) // 8)
        ops = bnc * (h * (12 * cp * p * n + pairs * tile * (2 * n + 18 * p))
                     + nsl * pairs * tile * 2 * n
                     + g * pairs * tile * 12 * n)
        scratch = 2 * (6 * bnc * c * h * p + 6 * cells * p * n
                       + 4 * bnc * nsl * (pairs * tile + cp * n)
                       + 4 * cells * (pairs * 64 + 2 * cp + nt))
        kind = "bf16"
    ms, by = bound_ms(n_bytes + scratch, ops, kind)
    return dict(floor_ms=ms, floor_by=by, design_ops=ops,
                design_bytes=n_bytes + scratch, scratch_bytes=scratch)


def ptxas_lines(report, *names):
    """The lines of an nvcc -Xptxas -v report about the kernels whose
    mangled names hold one of ``names``: each function's line and the
    register / shared memory / spill lines after it."""
    out, keep = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            keep = any(n in line for n in names)
        if keep:
            out.append(line.strip())
    return out


# K5's cases: (name, (b, nc, c, h, p, n, g), x dtype, B and C dtype,
# valid length, the body that must run it). The served dtypes (x, B, C
# bf16) take the wgmma body at the served widths and the CUDA-core body
# at the smoke models' (p = n = 16, chunk 32) and other ragged widths;
# PR 13's cases (B and C f32) the CUDA-core body.
SSD_CASES = (
    ("mamba2-780m S=2048 bf16", (1, 8, 256, 48, 64, 128, 1), "bf16",
     "bf16", None, "wgmma"),
    ("zamba2-2.7b S=1024 bf16", (1, 4, 256, 80, 64, 64, 1), "bf16", "bf16",
     None, "wgmma"),
    ("mamba2-780m S=2000 ragged bf16", (1, 8, 256, 48, 64, 128, 1), "bf16",
     "bf16", 2000, "wgmma"),
    ("g=8 S=2048 bf16", (1, 8, 256, 48, 64, 128, 8), "bf16", "bf16", None,
     "wgmma"),
    ("smoke widths bf16", (1, 2, 32, 4, 16, 16, 1), "bf16", "bf16", None,
     "cuda_core"),
    ("ragged widths g=3 bf16", (1, 2, 100, 6, 40, 72, 3), "bf16", "bf16",
     None, "cuda_core"),
    ("mamba2-780m S=2048 bf16 x, f32 B/C", (1, 8, 256, 48, 64, 128, 1),
     "bf16", "f32", None, "cuda_core"),
    ("zamba2-2.7b S=1024 bf16 x, f32 B/C", (1, 4, 256, 80, 64, 64, 1),
     "bf16", "f32", None, "cuda_core"),
    ("mamba2-780m S=2048 f32", (1, 8, 256, 48, 64, 128, 1), "f32", "f32",
     None, "cuda_core"),
    ("mamba2-780m S=2000 ragged bf16 x, f32 B/C",
     (1, 8, 256, 48, 64, 128, 1), "bf16", "f32", 2000, "cuda_core"),
    ("g=8 S=2048 bf16 x, f32 B/C", (1, 8, 256, 48, 64, 128, 8), "bf16",
     "f32", None, "cuda_core"),
)


# calls of each K5 body on the same inputs that must agree bitwise
SSD_REPEATS = 20


def phase_ssd_kernel(torch, np, K5):
    """K5 against its plain version on the card at Mamba2-780M's (S =
    2048) and Zamba2-2.7B's (S = 1024) full-width shapes, a ragged S =
    2000 padded to 2048 and g > 1: in the served dtypes (x, B, C bf16:
    the wgmma body; at the smoke models' widths the CUDA-core body) and
    with B and C in f32 (x bf16 or f32: the CUDA-core body); each case within KERNEL_TOL["ssd_chunk"], with its two planted
    faults rejected, and run by the body its dtypes name. Times as the
    serving kernels' (no library call computes the intra-chunk SSD);
    the bound of a wgmma case counts its tensor-core passes, with the
    f32 CUDA-core bound beside it."""
    from repro_torch.kernels import _build
    # 20 calls, 5 trials before the MoE and window phases
    timing = dict(reps=10, trials=3)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    rows = []
    for i, (case, shape, xd, bcd, valid, body) in enumerate(SSD_CASES):
        args = ssd_inputs(torch, np, *shape, dtypes[xd], dtypes[bcd],
                          seed=i, valid=valid)
        call = partial(K5.ssd_chunk, *args)
        plain = partial(K5.ssd_chunk_plain, *args)
        before = dict(K5.ssd_chunk.body_launches)
        (ky, ks), (py, ps) = call(), plain()
        ran = [k for k, v in K5.ssd_chunk.body_launches.items()
               if v != before[k]]
        need(ran == [body], f"ssd_chunk {case}: ran the {ran} body, not "
             f"the {body} one")
        fy, fs_ = ssd_faults(torch, *args, py, ps)
        cy = _close(torch, "ssd_chunk", f"{case} y", ky, py, fy)
        cs = _close(torch, "ssd_chunk", f"{case} states", ks, ps, fs_)
        check = dict(max_abs_err=max(cy["max_abs_err"], cs["max_abs_err"]),
                     tol_use=max(cy["tol_use"], cs["tol_use"]),
                     tol_use_y=cy["tol_use"], tol_use_states=cs["tol_use"],
                     fault_ratio=min(cy["fault_ratio"], cs["fault_ratio"]),
                     typical_abs_y=cy["typical_abs"],
                     typical_abs_states=cs["typical_abs"])
        n_bytes, f32_ops, tc_ops = ssd_work(args[0], args[3])
        b_f32, by_f32 = bound_ms(n_bytes, f32_ops, "f32")
        if ran == ["wgmma"]:
            bnd, by = bound_ms(n_bytes, tc_ops, "bf16")
        else:
            bnd, by = b_f32, by_f32
        ms, plain_ms = time_in_turns(torch, [call, plain], **timing)
        rows.append(dict(kernel="ssd_chunk", case=case, body=ran[0],
                         **check, ms=ms, plain_ms=plain_ms,
                         library_ms=None, device_ms=device_ms(torch, call),
                         plain_device_ms=device_ms(torch, plain),
                         library_device_ms=None, bound_ms=bnd, bound_by=by,
                         bound_f32_ms=b_f32, bound_f32_by=by_f32,
                         bytes=n_bytes, ops=f32_ops, tc_ops=tc_ops))
    # the repeat check (ROADMAP Queue 3, the f32 chunked SSD's miss): each
    # body called SSD_REPEATS times on the same inputs gives the same bits
    repeat = {}
    for case, xd in (("mamba2-780m S=2000 ragged f32", "f32"),
                     ("mamba2-780m S=2000 ragged bf16", "bf16")):
        args = ssd_inputs(torch, np, 1, 8, 256, 48, 64, 128, 1,
                          dtypes[xd], dtypes[xd], seed=0, valid=2000)
        first = [o.clone() for o in K5.ssd_chunk(*args)]
        body = K5.body_for(args[0], args[3], args[4])
        differ = 0
        for _ in range(SSD_REPEATS - 1):
            differ += not all(torch.equal(a, b) for a, b in
                              zip(K5.ssd_chunk(*args), first))
        torch.cuda.synchronize()
        repeat[case] = dict(body=body, calls=SSD_REPEATS,
                            not_bitwise_first=differ)
        need(differ == 0, f"ssd_chunk {case}: {differ} of {SSD_REPEATS} "
             f"calls on the {body} body differ bitwise from the first")
    report = _build.BUILD_INFO.get("ssd_chunk", {}).get("ptxas", "")
    emit(dict(phase="kernel", ssd_chunk=rows, repeat=repeat, ptxas=dict(
        wgmma=ptxas_lines(report, "ssd_chunk_wgmma_kernel"),
        cuda_core=ptxas_lines(report, "16ssd_chunk_kernel"))))
    return rows


# -------------------------------------------------- phase 6: model_parity
def parity_weights(np, shapes):
    """Weights for the model_parity phase from numpy: {dotted name of a
    leaf of the JAX parameter tree (= the port's state-dict name): f32
    array}, drawn in sorted name order, one N(0, 1) array z a leaf. Norm
    weights (gate_norm too) 1 + 0.1 z; the Mamba2 leaves A_log = log U
    (0.01, 0.1) (a second, uniform draw), dt_bias -3 + 0.1 z, D = z and
    conv_b 0.1 z, so that the SSM state decays slowly and every skip
    and bias counts; everything else z / sqrt(fan-in): the first dim of
    the leaf's own shape (after the layer axis of a stacked block's), and
    for the MoE experts' (L, E, d_in, d_out) weights d_in, not E. MLA
    (DeepSeek-V3): its norms ``q_a_norm`` and ``kv_a_norm`` as the other
    norms; ``wq_b`` (qr, h, .) and ``wk_b`` / ``wv_b`` (kvr, h, .) take
    their first dim (qr, kvr) by that rule, and its ``wo`` (h, dv, d)
    h dv, the JAX init's scale."""
    r = np.random.default_rng(PARITY["seed"])
    out = {}
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        z = r.standard_normal(shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("final_norm", "norm1", "norm2", "q_norm", "k_norm",
                    "gate_norm", "q_a_norm", "kv_a_norm"):
            a = 1.0 + 0.1 * z
        elif leaf == "A_log":
            a = np.log(r.uniform(0.01, 0.1, shape))
        elif leaf == "dt_bias":
            a = -3.0 + 0.1 * z
        elif leaf in ("D", "conv_b"):
            a = z if leaf == "D" else 0.1 * z
        else:
            stacked = name.split(".", 1)[0] in ("blocks", "dense_blocks",
                                                "moe_blocks")
            expert = leaf in ("we_gate", "we_up", "we_down")
            fan = shape[int(stacked) + int(expert)]
            if leaf == "wo" and name[:-2] + "wv_b" in shapes:
                fan *= shape[int(stacked) + 1]    # MLA's wo: h dv
            a = z / math.sqrt(fan)
        out[name] = a.astype(np.float32)
    return out


def parity_tokens(np, vocab_size, prompt_len):
    r = np.random.default_rng(PARITY["seed"] + 1)
    return r.integers(0, vocab_size, (1, prompt_len))


def parity_model(torch, np, cfg, dev="cuda"):
    """The port's model of ``cfg`` on the card with the parity weights
    (`parity_weights`, cast to the config's dtype)."""
    from repro_torch.models import build_model
    from repro_torch.models.convert import from_jax_params
    model = build_model(cfg, dev)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(from_jax_params(cfg, parity_weights(np, shapes)))
    return model


def load_parity_expected():
    """The rows of `scripts/model_parity_expected.py` (the MoE family and
    the hybrid prompt past its cache): {"f32": {row: case}, "bf16": {row:
    case}}."""
    with open(PARITY_EXPECTED_FILE) as f:
        return json.load(f)


class CountDropped:
    """Counts the MoE choices dropped by the port's capacity dispatch
    (`layers.moe_dispatch_indices`) while it is entered."""

    def __init__(self):
        from repro_torch.models import layers
        self.mod, self.dropped = layers, 0

    def __enter__(self):
        orig = self.orig = self.mod.moe_dispatch_indices

        def counting(top_e, top_p, n_experts, capacity):
            slot, w = orig(top_e, top_p, n_experts, capacity)
            self.dropped += int((slot == capacity).sum())
            return slot, w
        self.mod.moe_dispatch_indices = counting
        return self

    def __exit__(self, *exc):
        self.mod.moe_dispatch_indices = self.orig


def model_parity_f32(torch, np, row, case, dev="cuda"):
    """One f32 row: the greedy run against the JAX package's tokens,
    last-step logits[:16], L2 and top-5 (PARITY_TOL, tokens exact); a
    case with ``prefill_dropped`` (the MoE capacity dispatch) must drop
    as many choices in the prefill as the JAX package."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as DA
    mla_before = dict(DA.mla_decode_attention.body_launches)
    cfg = get_arch(case["arch"]).smoke().replace(**case.get("config", {}))
    model = parity_model(torch, np, cfg, dev)
    toks = torch.tensor(parity_tokens(np, cfg.vocab_size,
                                      case["prompt_len"]), device=dev)
    cache = model.cache_spec(1, case["max_len"]).zeros(dev)
    with CountDropped() as drops:
        logits, cache = model.prefill({"tokens": toks}, cache)
    out = [int(logits[0, -1].argmax())]
    for _ in range(PARITY["steps"]):
        tok = torch.tensor([[out[-1]]], device=dev)
        logits, cache = model.decode_step(tok, cache)
        out.append(int(logits[0, -1].argmax()))
    last = logits[0, -1].double().cpu().numpy()
    exp = case["expected"]
    got = dict(tokens=out, head=last[:16].tolist(),
               l2=float(np.linalg.norm(last)),
               top5=np.argsort(-last)[:5].tolist())
    head_err = float(np.abs(last[:16] - np.asarray(exp["head"])).max())
    mla = mla_bodies_since(DA, mla_before, "cuda_core", row)
    emit(dict(phase="model_parity", arch=row, tokens=out,
              expected_tokens=exp["tokens"], head_max_abs_err=head_err,
              l2=got["l2"], expected_l2=exp["l2"], top5=got["top5"],
              expected_top5=exp["top5"], prefill_dropped=drops.dropped,
              expected_prefill_dropped=case.get("prefill_dropped"),
              mla_launches_by_body=mla))
    need(bool(np.isfinite(last).all()),
         f"model_parity {row}: non-finite logits")
    need(out == exp["tokens"], f"model_parity {row}: greedy tokens "
         f"{out} != the JAX package's {exp['tokens']}")
    need(got["top5"] == exp["top5"],
         f"model_parity {row}: top-5 logits differ")
    need(np.allclose(last[:16], exp["head"], **PARITY_TOL)
         and math.isclose(got["l2"], exp["l2"], rel_tol=PARITY_TOL["rtol"]),
         f"model_parity {row}: last-step logits beyond {PARITY_TOL} "
         f"of the JAX package's (head err {head_err}, l2 {got['l2']} "
         f"vs {exp['l2']})")
    if case.get("prefill_dropped") is not None:
        need(drops.dropped == case["prefill_dropped"],
             f"model_parity {row}: the prefill dropped {drops.dropped} "
             f"MoE choices, the JAX package's {case['prefill_dropped']}")


def mla_bodies_since(DA, before, body, row):
    """K3-mla's launches by body since ``before``; fails unless every one
    took ``body`` (the rule's for the row's dtype)."""
    got = {k: v - before[k]
           for k, v in DA.mla_decode_attention.body_launches.items()}
    need(sum(got.values()) == got[body], f"model_parity {row}: K3-mla ran "
         f"{got} times by body, not all on its {body} body")
    return got


def phase_model_parity(torch, np):
    """The port's models on the card against the JAX package's own
    output (PARITY_CASES' expected and the f32 rows of
    `scripts/model_parity_expected.json`, computed on the CPU), in f32;
    then in bf16 (PARITY_BF16_CASES and that file's bf16 rows), fed the
    JAX package's tokens."""
    more = load_parity_expected()
    cases = {f"{arch} smoke f32": dict(case, arch=arch)
             for arch, case in PARITY_CASES.items()}
    for row, case in dict(cases, **more["f32"]).items():
        model_parity_f32(torch, np, row, case)
    for row, case in dict(PARITY_BF16_CASES, **more["bf16"]).items():
        model_parity_bf16(torch, np, row, case)


def model_parity_bf16(torch, np, row, case, dev="cuda"):
    """One bf16 row: prefill and decode fed the JAX package's greedy
    tokens, each step's logits within PARITY_BF16_TOL of its largest
    |logit| at the JAX top-5 and at logits[:8] (plus, for a row with
    ``own``, that step's distance of the JAX package's bf16 logits from
    its f32 run on the same weights: scripts/model_parity_expected.py);
    a greedy token that differs from the JAX one where the JAX top-2 gap
    exceeds that bound is a fault of the port. A row with ``k5_body``
    must run K5's prefill launches through that body."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ssd_chunk as K5
    before = dict(K5.ssd_chunk.body_launches)
    mla_before = dict(DA.mla_decode_attention.body_launches)
    cfg = get_arch(case["arch"]).smoke().replace(**case["config"])
    model = parity_model(torch, np, cfg, dev)
    toks = torch.tensor(parity_tokens(np, cfg.vocab_size,
                                      case["prompt_len"]), device=dev)
    cache = model.cache_spec(1, case["max_len"]).zeros(dev)
    logits, cache = model.prefill({"tokens": toks}, cache)
    steps = case["steps"]
    own = case.get("own", [0.0] * len(steps))
    mine, worst = [], 0.0
    for i, (tok, amax, gap, ids, vals, head) in enumerate(steps):
        last = logits[0, -1].double().cpu().numpy()
        need(bool(np.isfinite(last).all()),
             f"model_parity {row}: non-finite logits at step {i}")
        bound = PARITY_BF16_TOL * amax + own[i]
        err = max(np.abs(last[ids] - vals).max(),
                  np.abs(last[:len(head)] - head).max())
        worst = max(worst, err / bound)
        mine.append(int(last.argmax()))
        need(err <= bound, f"model_parity {row}: step {i}'s logits "
             f"{err:.4g} off the JAX package's, beyond {bound:.4g}")
        need(mine[-1] == tok or gap <= bound,
             f"model_parity {row}: step {i} picks {mine[-1]}, the JAX "
             f"package {tok} by a top-2 gap {gap} over the bound {bound:.4g}")
        if i + 1 < len(steps):
            logits, cache = model.decode_step(
                torch.tensor([[tok]], device=dev), cache)
    want = [s[0] for s in steps]
    bodies = {k: v - before[k]
              for k, v in K5.ssd_chunk.body_launches.items()}
    mla = mla_bodies_since(DA, mla_before, "mma", row)
    emit(dict(phase="model_parity", arch=row, tokens=mine,
              expected_tokens=want,
              token_agreement=sum(a == b for a, b in zip(mine, want)),
              steps=len(steps), tol_use=worst, tol=PARITY_BF16_TOL,
              k5_launches_by_body=bodies, mla_launches_by_body=mla))
    if "k5_body" in case:
        need(bodies[case["k5_body"]] == cfg.n_layers
             and sum(bodies.values()) == cfg.n_layers,
             f"model_parity {row}: K5 ran {bodies}, not once a layer "
             f"through its {case['k5_body']} body")


# --------------------------------------------------------- phase 7: serve
def serve_catalogue(catalogue, **over):
    """ServedFunctions of a catalogue of (name, arch, prompt, new
    tokens, max_len), each config with the fields ``over`` (a depth cut);
    function i's weights are seeded by i."""
    from repro_torch.configs import get_arch
    from repro_torch.serving import ServedFunction
    return [ServedFunction(i, get_arch(arch).replace(**over), prompt_len=p,
                           gen_tokens=g, max_len=m, name=name)
            for i, (name, arch, p, g, m) in enumerate(catalogue)]


class CountModelCalls:
    """Counts `Model.prefill` and `Model.decode_step` calls by model name
    while it is entered (the serving engine builds its models itself)."""

    def __init__(self):
        from repro_torch.models.model import Model
        self.cls, self.counts = Model, {}

    def _wrap(self, kind, orig):
        def call(model, *a, **kw):
            keys = [(kind, model.cfg.name)]
            if kind == "prefill" and "k" in a[1] and \
                    a[0]["tokens"].shape[1] > a[1]["k"].shape[2]:
                # a prompt longer than the attention cache
                keys.append(("prefill_past_cache", model.cfg.name))
            for key in keys:
                self.counts[key] = self.counts.get(key, 0) + 1
            return orig(model, *a, **kw)
        return call

    def __enter__(self):
        self.orig = (self.cls.prefill, self.cls.decode_step)
        self.cls.prefill = self._wrap("prefill", self.orig[0])
        self.cls.decode_step = self._wrap("decode", self.orig[1])
        return self

    def __exit__(self, *exc):
        self.cls.prefill, self.cls.decode_step = self.orig

    def get(self, kind, name):
        return self.counts.get((kind, name), 0)


def serve_run(torch, np, phase, fns, kernels, calls=None, capacity=2,
              requests=SERVE_REQUESTS):
    """`repro_torch.serving.EdgeServingEngine` with ESFF on ``capacity``
    slots serving ``fns`` the ``requests`` (n, duration, seed): cold
    starts, executions and responses measured on the card, with the
    launch counts of ``kernels`` ({name: wrapper})
    set to 0 just before the run and read just after (and, with
    ``calls``, the run's prefill and decode calls counted). Then one
    warm instance per function splits prefill tok/s from decode
    ms/token. Emits the phase's line and returns (launches, line)."""
    from repro_torch.serving import EdgeServingEngine
    from repro_torch.serving.instance import ModelInstance
    eng = EdgeServingEngine(fns, capacity=capacity, policy="esff")
    reqs = eng.make_requests(requests["n"], duration=requests["duration"],
                             seed=requests["seed"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # set-up: one throwaway instance a function measures its cold start
    # and execution (the engine's FunctionProfile)
    t0 = time.perf_counter()
    profiles = {i: (p.cold_start, p.true_mean_exec)
                for i, p in eng.warm_profile().items()}
    profile_s = time.perf_counter() - t0
    for f in kernels.values():
        f.launches = 0
        if hasattr(f, "body_launches"):
            f.body_launches = dict.fromkeys(f.body_launches, 0)
        if hasattr(f, "window_launches"):
            f.window_launches = 0
        if hasattr(f, "value_dim_launches"):
            f.value_dim_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if calls is None:
        res = eng.run(reqs)
    else:
        with calls:
            res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in kernels.items()}
    by_body = {k: dict(f.body_launches) for k, f in kernels.items()
               if hasattr(f, "body_launches")}
    windowed = {k: f.window_launches for k, f in kernels.items()
                if hasattr(f, "window_launches")}
    value_dim = {k: f.value_dim_launches for k, f in kernels.items()
                 if hasattr(f, "value_dim_launches")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fn_of = np.array([r.fn_id for r in reqs])
    per_fn = []
    for fn in fns:
        ex = res.exec_times[fn_of == fn.fn_id]   # reqs are in order
        per_fn.append(dict(name=fn.name, arch=fn.cfg.name,
                           prompt=fn.prompt_len,
                           gen_tokens=fn.gen_tokens, max_len=fn.max_len,
                           requests=int((fn_of == fn.fn_id).sum()),
                           profiled_cold_s=profiles[fn.fn_id][0],
                           profiled_exec_s=profiles[fn.fn_id][1],
                           exec_s_mean=float(ex.mean()) if len(ex) else None))
    stats = dict(mean_response=res.mean_response,
                 max_response=float(res.responses.max()),
                 p95_response=res.percentile(95),
                 cold_starts=res.server.cold_starts,
                 evictions=res.server.evictions,
                 cold_time=res.server.cold_time)
    done, responses = len(res.responses), res.responses
    # the run's replicas stay reachable from its server's hooks: drop
    # them before the warm instances (a 1-slot MoE server holds 32.8 GB)
    del res, eng
    gc.collect()
    torch.cuda.empty_cache()
    # prefill / decode split and the output's shape, one warm instance
    # per function, each dropped before the next is built
    for fn, row in zip(fns, per_fn):
        inst = ModelInstance(fn)
        row["cold_s"] = inst.cold_start()
        model, batch = inst.model, inst._dummy_batch(1)
        pre, dec = [], []
        for _ in range(3):
            cache = model.cache_spec(1, fn.max_len).zeros("cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, cache = model.prefill(batch, cache)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            tok = logits[:, -1].argmax(-1)[:, None]
            steps = SERVE_SPLIT_STEPS
            for _ in range(steps):
                logits, cache = model.decode_step(tok, cache)
                tok = logits[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            pre.append(t2 - t1)
            dec.append((time.perf_counter() - t2) / steps)
        need(tuple(logits.shape) == (1, 1, fn.cfg.padded_vocab)
             and bool(torch.isfinite(logits).all()),
             f"{phase} {fn.name}: logits {tuple(logits.shape)} not finite "
             "or of the wrong shape")
        row["prefill_s"] = sorted(pre)[1]
        row["prefill_tok_per_s"] = fn.prompt_len / row["prefill_s"]
        row["decode_ms_per_token"] = 1e3 * sorted(dec)[1]
        inst.evict()
        del model, cache, logits, tok
        torch.cuda.empty_cache()
    line = dict(phase=phase, archs=sorted({fn.cfg.name for fn in fns}),
                policy="esff", capacity=capacity,
                n_requests=len(reqs), profile_s=profile_s, wall_s=wall,
                **stats, peak_mem_gb=peak_gb,
                launches=launches, launches_by_body=by_body,
                window_launches=windowed, value_dim_launches=value_dim,
                functions=per_fn)
    if calls is not None:
        line["model_calls"] = {f"{k}:{n}": c
                               for (k, n), c in sorted(calls.counts.items())}
    emit(line)
    need(done == len(reqs), f"{phase}: not every request done")
    need(bool(np.isfinite(responses).all() and (responses > 0).all()),
         f"{phase}: bad response times")
    need(stats["cold_starts"] >= 1 and stats["evictions"] >= 1,
         f"{phase}: no cold start or no eviction")
    for k, n in launches.items():
        need(n > 0, f"{phase}: {k} was never launched")
    return launches, line


def phase_serve(torch, np, FA, DA, RN):
    """SERVE_CATALOGUE's Qwen3-4B functions at full width, with the
    dense serving kernels' launch counts."""
    kernels = {"flash_attention": FA.flash_attention,
               "decode_attention": DA.decode_attention,
               "rmsnorm": RN.rmsnorm,
               "rmsnorm_residual": RN.rmsnorm_residual}
    fns = serve_catalogue((name, SERVE_ARCH, p, g, m)
                          for name, p, g, m in SERVE_CATALOGUE)
    return serve_run(torch, np, "serve", fns, kernels)[0]


def phase_serve_ssm(torch, np, FA, DA, RN, K5):
    """SERVE_SSM_CATALOGUE's Mamba2-780M and Zamba2-2.7B functions at
    full width. K5 must have launched exactly once a layer a prefill of
    the run (warm-ups of its live cold starts included), every time
    through its wgmma body (x, B and C in bf16); K2 and K3 (at
    head_dim 80: the only attention here is Zamba2's shared block) once
    a shared-block application a hybrid prefill and decode step."""
    kernels = {"flash_attention": FA.flash_attention,
               "decode_attention": DA.decode_attention,
               "rmsnorm": RN.rmsnorm,
               "rmsnorm_residual": RN.rmsnorm_residual,
               "ssd_chunk": K5.ssd_chunk}
    fns = serve_catalogue(SERVE_SSM_CATALOGUE)
    calls = CountModelCalls()
    launches, line = serve_run(torch, np, "serve_ssm", fns, kernels, calls,
                               requests=SERVE_SSM_REQUESTS)
    windowed = line["window_launches"]["flash_attention"]
    cfgs = {fn.cfg.name: fn.cfg for fn in fns}
    want_k5 = sum(c.n_layers * calls.get("prefill", n)
                  for n, c in cfgs.items())
    need(launches["ssd_chunk"] == want_k5,
         f"serve_ssm: ssd_chunk launched {launches['ssd_chunk']} times, "
         f"not once a layer a prefill ({want_k5})")
    k5_bodies = line["launches_by_body"]["ssd_chunk"]
    need(k5_bodies["wgmma"] == want_k5,
         f"serve_ssm: ssd_chunk ran {k5_bodies} times by body, not every "
         f"one of the {want_k5} launches on the wgmma body (the served "
         "dtypes are bf16)")
    hyb = [c for c in cfgs.values() if c.family == "hybrid"]
    want_k2 = sum(c.n_layers // c.attn_every * calls.get("prefill", c.name)
                  for c in hyb)
    want_k3 = sum(c.n_layers // c.attn_every * calls.get("decode", c.name)
                  for c in hyb)
    need(all(c.head_dim_ == 80 for c in hyb) and want_k2 > 0
         and (launches["flash_attention"], launches["decode_attention"])
         == (want_k2, want_k3),
         f"serve_ssm: K2 / K3 launched {launches['flash_attention']} / "
         f"{launches['decode_attention']} times at head_dim 80, not "
         f"{want_k2} / {want_k3}")
    # every hybrid prefill attends through the window of its cache's
    # length, and hybrid-long's prompt is longer than that cache
    long = sum(calls.get("prefill_past_cache", c.name) for c in hyb)
    emit(dict(phase="serve_ssm_window", window_launches=windowed,
              want=want_k2, prefills_past_cache=long))
    need(windowed == want_k2 and long >= 1,
         f"serve_ssm: K2 launched {windowed} times with a window, not once "
         f"a shared-block application a hybrid prefill ({want_k2}), or no "
         f"prompt past its cache was served ({long})")
    launches["flash_attention_window"] = windowed
    return launches


def phase_serve_moe(torch, np, FA, DA, RN):
    """SERVE_MOE_CATALOGUE's DeepSeek-MoE-16B functions at published
    widths and full depth on a 1-slot server: every request served, K2
    once a layer a prefill and K3 once a layer a decode step of the run
    (warm-ups of its live cold starts included), K4a and K4b counted,
    peak memory, cold start, prefill tokens/s and decode ms/token."""
    kernels = {"flash_attention": FA.flash_attention,
               "decode_attention": DA.decode_attention,
               "rmsnorm": RN.rmsnorm,
               "rmsnorm_residual": RN.rmsnorm_residual}
    fns = serve_catalogue(SERVE_MOE_CATALOGUE)
    calls = CountModelCalls()
    launches, line = serve_run(torch, np, "serve_moe", fns, kernels, calls,
                               **SERVE_MOE)
    cfg = fns[0].cfg
    want = (cfg.n_layers * calls.get("prefill", cfg.name),
            cfg.n_layers * calls.get("decode", cfg.name))
    need((launches["flash_attention"], launches["decode_attention"])
         == want and want[0] > 0,
         f"serve_moe: K2 / K3 launched {launches['flash_attention']} / "
         f"{launches['decode_attention']} times, not {cfg.n_layers} a "
         f"prefill and a decode step ({want[0]} / {want[1]})")
    return launches


def phase_serve_mla(torch, np, FA, DA, RN):
    """SERVE_MLA_CATALOGUE's DeepSeek-V3-671B functions at published
    widths, cut to SERVE_MLA_LAYERS layers, on a 1-slot server: every
    request served, K2 at head dims (192, 128) once a layer a prefill
    and K3-mla once a layer a decode step of the run (warm-ups of its
    live cold starts included), K3 never, K4a and K4b counted; peak
    memory, cold start, prefill tokens/s and decode ms/token."""
    kernels = {"flash_attention": FA.flash_attention,
               "mla_decode_attention": DA.mla_decode_attention,
               "rmsnorm": RN.rmsnorm,
               "rmsnorm_residual": RN.rmsnorm_residual}
    fns = serve_catalogue(SERVE_MLA_CATALOGUE, n_layers=SERVE_MLA_LAYERS)
    cfg = fns[0].cfg
    need(cfg.mla and cfg.mtp and cfg.first_dense_layers == 3
         and cfg.n_layers == SERVE_MLA_LAYERS,
         f"serve_mla: the config is not DeepSeek-V3's cut to "
         f"{SERVE_MLA_LAYERS} layers: {cfg}")
    calls = CountModelCalls()
    dense_before = DA.decode_attention.launches
    launches, line = serve_run(torch, np, "serve_mla", fns, kernels, calls,
                               **SERVE_MLA)
    want = (cfg.n_layers * calls.get("prefill", cfg.name),
            cfg.n_layers * calls.get("decode", cfg.name))
    got = (launches["flash_attention"], launches["mla_decode_attention"])
    value_dim = line["value_dim_launches"]["flash_attention"]
    need(got == want and want[0] > 0 and value_dim == want[0],
         f"serve_mla: K2 / K3-mla launched {got} times ({value_dim} of K2's "
         f"at head dims (192, 128)), not {cfg.n_layers} a prefill and a "
         f"decode step ({want})")
    need(DA.decode_attention.launches == dense_before,
         "serve_mla: the dense decode kernel K3 ran")
    bodies = line["launches_by_body"]["mla_decode_attention"]
    need(bodies == {"cuda_core": 0, "mma": want[1]},
         f"serve_mla: K3-mla ran {bodies} times by body, not every one of "
         f"the {want[1]} launches on the tensor-core (mma) body")
    return dict(launches, mla_decode_attention_by_body=bodies)


# ------------------------------------------------------- phase 10: train
def train_counts(FA, RN, K5):
    """The eight training-path counts: K2, K2-bwd, K4a, K4a-bwd, K4b,
    K4b-bwd, K5, K5-bwd launches."""
    return (FA.flash_attention.launches,
            FA.flash_attention_backward.launches, RN.rmsnorm.launches,
            RN.rmsnorm_backward.launches, RN.rmsnorm_residual.launches,
            RN.rmsnorm_residual_backward.launches, K5.ssd_chunk.launches,
            K5.ssd_chunk_backward.launches)


TRAIN_COUNT_NAMES = ("flash_attention", "flash_attention_backward",
                     "rmsnorm", "rmsnorm_backward", "rmsnorm_residual",
                     "rmsnorm_residual_backward", "ssd_chunk",
                     "ssd_chunk_backward")


def train_counts_want(n_layers, family="dense", attn_every=0):
    """A step's launches from the code (`Model.loss` under per-layer
    checkpointing, tests/test_torch_train.py). Dense: K2 forward twice a
    layer (the forward, the recomputation), backward once; K4a the first
    norm1 and the q- and k-norms, twice, backward once; K4b each norm2
    and each later norm1 twice and the final norm once, backward once
    each. ssm and hybrid, with A = n_layers // attn_every shared-block
    applications (not checkpointed; 0 for ssm): K5 twice a layer and its
    backward once; K2 and K2-bwd A; K4a the first norm1 and each gate norm
    twice and the shared norm1 once, backward once each; K4b each later
    norm1 twice, the shared norm2 and the final norm once, backward once
    each."""
    L = n_layers
    if family == "dense":
        return (2 * L, L, 2 * (1 + 2 * L), 1 + 2 * L, 2 * (2 * L - 1) + 1,
                2 * L, 0, 0)
    A = L // attn_every if family == "hybrid" else 0
    return (A, A, 2 * (1 + L) + A, 1 + L + A, 2 * (L - 1) + A + 1, L + A,
            2 * L, L)


@contextlib.contextmanager
def plain_kernels():
    """The model's kernels (K2 and K4a in `repro_torch.models.layers`, K4b
    in `repro_torch.models.model`, K5 in `repro_torch.models.mamba`)
    swapped for their plain versions; autograd through those is their
    plain backward."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_chunk as K5
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as MB
    from repro_torch.models import model as M
    saved = (L.flash_attention, L.rmsnorm, M.rmsnorm_residual, MB.ssd_chunk)
    L.flash_attention = (lambda q, k, v, causal=True, scale=None,
                         window=None: FA.flash_attention_plain(
                             q, k, v, causal=causal, scale=scale,
                             window=window))
    L.rmsnorm = lambda x, w, eps=1e-6: RN.rmsnorm_plain(x, w, eps)
    M.rmsnorm_residual = (lambda x, r, w, eps=1e-6:
                          RN.rmsnorm_residual_plain(x, r, w, eps))
    MB.ssd_chunk = K5.ssd_chunk_plain
    try:
        yield
    finally:
        (L.flash_attention, L.rmsnorm, M.rmsnorm_residual,
         MB.ssd_chunk) = saved


def train_flops(cfg, n_params, batch, seq_len):
    """Model FLOPs of one training step: 6 x parameters x tokens, plus,
    three times (forward and backward), the products that no parameter
    counts: the causal attention's (4 B H D S (S + 1) / 2 a layer, or a
    shared-block application of the hybrid family) and the SSD block's
    (a cell of chunk c: the scores and y over s >= t, 2 c (c + 1) / 2 (n
    + p), the chunk state and the inter-chunk term, 4 c p n)."""
    S = seq_len
    flops = 6 * n_params * batch * S
    apps = {"dense": cfg.n_layers, "ssm": 0,
            "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}[cfg.family]
    if apps:
        flops += 3 * apps * 4 * batch * cfg.n_heads * cfg.head_dim_ * S * (
            S + 1) // 2
    if cfg.family != "dense":
        c = cfg.ssm_chunk
        cells = batch * (-(-S // c)) * cfg.ssm_heads
        p, n = cfg.ssm_headdim, cfg.ssm_state
        flops += 3 * cfg.n_layers * cells * (c * (c + 1) * (n + p)
                                             + 4 * c * p * n)
    return flops


def train_jax_parity(torch, np, arch, exp, counts):
    """(a): the smoke config of ``arch`` in f32 on `parity_weights`,
    `launch.train` step by step against the JAX package's losses and
    grad norms ``exp`` (scripts/train_expected.json)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    cfg = get_arch(arch).smoke()
    shapes = {k: tuple(v.shape) for k, v in
              build_model(cfg, "cpu").state_dict().items()}
    got = []
    c0 = counts()
    t0 = time.perf_counter()
    train(arch, steps=exp["steps"], global_batch=exp["global_batch"],
          seq_len=exp["seq_len"], lr=exp["lr"], seed=exp["seed"],
          params=parity_weights(np, shapes), device="cuda",
          on_step=lambda s, m: got.append(m), log_every=1 << 30)
    a_s = time.perf_counter() - t0
    bad = []
    for i, m in enumerate(got):
        for key in ("loss", "grad_norm"):
            rtol = TRAIN_RTOL_FIRST if (i, key) == (0, "loss") else \
                TRAIN_RTOL
            if not abs(m[key] - exp[key][i]) <= rtol * abs(exp[key][i]):
                bad.append((i, key, m[key], exp[key][i]))
    out = dict(
        arch=arch, seq_len=exp["seq_len"], steps=len(got),
        loss=[m["loss"] for m in got],
        grad_norm=[m["grad_norm"] for m in got],
        loss_rel_err=[abs(m["loss"] / exp["loss"][i] - 1)
                      for i, m in enumerate(got)],
        grad_norm_rel_err=[abs(m["grad_norm"] / exp["grad_norm"][i] - 1)
                           for i, m in enumerate(got)],
        launches=dict(zip(TRAIN_COUNT_NAMES, (b - a for a, b in zip(
            c0, counts())))), seconds=a_s,
        step_seconds=[m["seconds"] for m in got])
    need(len(got) == exp["steps"] and not bad, f"train (a) {arch}: the f32 "
         f"smoke training differs from the JAX package's: {bad}")
    return out


def loss_and_grads(model, batch):
    """One loss and backward of ``model`` on ``batch``: the loss and each
    parameter's gradient in f32."""
    for p in model.parameters():
        p.grad = None
    loss, _ = model.loss(batch)
    loss.backward()
    return loss.item(), {n: p.grad.float() for n, p in
                         model.named_parameters()}


def train_kernel_vs_plain(torch, arch, cut_to, counts):
    """(b): ``arch`` at full width cut as ``cut_to`` says (config
    overrides: the depth, and the hybrid family's group size), bf16, B =
    2, S = 1024: one loss and backward through the kernels against the
    same with the kernels swapped for their plain versions; the launches
    against the count from the code."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train.data import synthetic_lm_batch
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cut = get_arch(arch).replace(**cut_to)
    model = build_model(cut, dev, trainable=True)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.as_tensor(v).long().to(dev) for k, v in
             synthetic_lm_batch(cut, TRAIN_CUT["global_batch"],
                                TRAIN_CUT["seq_len"], 0).items()}

    c0 = counts()
    lk, gk = loss_and_grads(model, batch)
    c1 = counts()
    with plain_kernels():
        lp, gp = loss_and_grads(model, batch)
    need(counts() == c1, f"train (b) {arch}: a kernel launched on the "
         "plain path")
    rel = {n: ((gk[n] - gp[n]).norm() / gp[n].norm()).item() for n in gk}
    rtol = KERNEL_TOL["flash_attention"]["rtol"]
    launches = tuple(b - a for a, b in zip(c0, c1))
    want = train_counts_want(cut.n_layers, cut.family, cut.attn_every)
    out = dict(
        config=f"{arch} full width, {cut.n_layers} layers"
        + (f" (attn_every {cut.attn_every})" if cut.attn_every else "")
        + f", bf16, B={TRAIN_CUT['global_batch']}, "
        f"S={TRAIN_CUT['seq_len']}",
        loss_kernel=lk, loss_plain=lp, loss_rel_err=abs(lk / lp - 1),
        grad_rel_err=rel, grad_rel_err_max=max(rel.values()), rtol=rtol,
        launches=dict(zip(TRAIN_COUNT_NAMES, launches)),
        seconds=time.perf_counter() - t0)
    del model, gk, gp, batch
    gc.collect()
    torch.cuda.empty_cache()
    need(abs(lk / lp - 1) <= rtol and max(rel.values()) <= rtol,
         f"train (b) {arch}: kernel and plain paths differ beyond rtol "
         f"{rtol}: loss {lk} vs {lp}, gradients {rel}")
    need(launches == want, f"train (b) {arch}: launches {launches}, the "
         f"code gives {want}")
    return out


def train_deep_hybrid(torch, counts):
    """(b) deep (TRAIN_DEEP): the hybrid family cut to one whole group at
    its served size, f32, B = 2, S = 1024: the kernel path against the
    plain path within TRAIN_DEEP_RTOL, the launches against the count
    from the code; then the bf16 kernel path on the same weights and
    batch, which must miss that limit against the f32 plain path."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train.data import synthetic_lm_batch
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    arch = TRAIN_DEEP["arch"]
    cut = get_arch(arch).replace(
        n_layers=TRAIN_DEEP["n_layers"], attn_every=TRAIN_DEEP["attn_every"])
    f32 = cut.replace(param_dtype="float32", compute_dtype="float32")
    model = build_model(f32, dev, trainable=True)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.as_tensor(v).long().to(dev) for k, v in
             synthetic_lm_batch(f32, TRAIN_CUT["global_batch"],
                                TRAIN_CUT["seq_len"], 0).items()}

    def rel(g, ref):
        return {n: ((g[n] - ref[n]).norm() / ref[n].norm()).item()
                for n in g}
    c0 = counts()
    lk, gk = loss_and_grads(model, batch)
    c1 = counts()
    with plain_kernels():
        lp, gp = loss_and_grads(model, batch)
    need(counts() == c1, f"train (b) deep {arch}: a kernel launched on the "
         "plain path")
    err = rel(gk, gp)
    del gk
    launches = tuple(b - a for a, b in zip(c0, c1))
    want = train_counts_want(cut.n_layers, cut.family, cut.attn_every)
    m16 = build_model(cut.replace(param_dtype="bfloat16",
                                  compute_dtype="bfloat16"), dev,
                      trainable=True)
    with torch.no_grad():
        src = dict(model.named_parameters())
        for n, p in m16.named_parameters():
            p.copy_(src[n])
    del model, src
    l16, g16 = loss_and_grads(m16, batch)
    control = rel(g16, gp)
    del m16, g16, gp, batch
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(
        config=f"{arch} full width, {cut.n_layers} layers (attn_every "
        f"{cut.attn_every}), f32, B={TRAIN_CUT['global_batch']}, "
        f"S={TRAIN_CUT['seq_len']}",
        loss_kernel=lk, loss_plain=lp, loss_rel_err=abs(lk / lp - 1),
        grad_rel_err=err, grad_rel_err_max=max(err.values()),
        worst=max(err, key=err.get), rtol=TRAIN_DEEP_RTOL,
        control_bf16_loss_rel_err=abs(l16 / lp - 1),
        control_bf16_grad_rel_err_max=max(control.values()),
        control_bf16_worst=max(control, key=control.get),
        launches=dict(zip(TRAIN_COUNT_NAMES, launches)),
        seconds=time.perf_counter() - t0)
    need(out["loss_rel_err"] <= TRAIN_DEEP_RTOL
         and out["grad_rel_err_max"] <= TRAIN_DEEP_RTOL,
         f"train (b) deep {arch}: kernel and plain paths differ in f32 "
         f"beyond rtol {TRAIN_DEEP_RTOL}: loss {lk} vs {lp}, gradients "
         f"{err}")
    need(out["control_bf16_grad_rel_err_max"] > TRAIN_DEEP_RTOL,
         f"train (b) deep {arch}: the bf16 control is within rtol "
         f"{TRAIN_DEEP_RTOL} of the f32 plain path")
    need(launches == want, f"train (b) deep {arch}: launches {launches}, "
         f"the code gives {want}")
    return out


def train_full_run(torch, arch, counts):
    """(c): ``arch`` at full width, bf16, f32 moments, random weights,
    TRAIN_FULL's global batch, length, steps and lr, through
    `repro_torch.launch.train`; losses finite and falling by
    TRAIN_LOSS_DROP, each kernel's launches a step against the count from
    the code (set to 0 just before the run, read after each step)."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssd_chunk as K5
    from repro_torch.launch.train import train
    full = get_arch(arch)
    bwd_before = dict(K5.ssd_chunk_backward.body_launches)
    per_step, steps = [], []
    last = [None]

    def on_step(s, m):
        now = counts()
        per_step.append(tuple(b - a for a, b in zip(last[0], now)))
        last[0] = now
        steps.append(dict(step=s, loss=m["loss"], grad_norm=m["grad_norm"],
                          seconds=m["seconds"]))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last[0] = counts()
    params, losses = train(
        arch, smoke=False, steps=TRAIN_FULL["steps"],
        global_batch=TRAIN_FULL["global_batch"],
        seq_len=TRAIN_FULL["seq_len"], lr=TRAIN_FULL["lr"],
        seed=TRAIN_FULL["seed"], on_step=on_step, log_every=1 << 30)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    bwd_bodies = {k: v - bwd_before[k]
                  for k, v in K5.ssd_chunk_backward.body_launches.items()}
    n_params = sum(p.numel() for p in params.values())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    secs = sorted(x["seconds"] for x in steps[1:])
    step_s = secs[len(secs) // 2]
    tokens = TRAIN_FULL["global_batch"] * TRAIN_FULL["seq_len"]
    flops = train_flops(full, n_params, TRAIN_FULL["global_batch"],
                        TRAIN_FULL["seq_len"])
    want = train_counts_want(full.n_layers, full.family, full.attn_every)
    if full.family == "dense":
        widths = (f"{full.n_heads} / {full.n_kv_heads} heads of "
                  f"{full.head_dim_}, d_ff {full.d_ff}")
    else:
        widths = (f"{full.ssm_heads} SSM heads of {full.ssm_headdim}, "
                  f"state {full.ssm_state}, chunk {full.ssm_chunk}")
        if full.family == "hybrid":
            widths += (f", a shared block of {full.n_heads} heads of "
                       f"{full.head_dim_} every {full.attn_every} layers")
    out = dict(
        config=f"{arch} full width ({full.n_layers} layers, d "
        f"{full.d_model}, {widths}, vocab {full.vocab_size}), bf16, f32 "
        "moments", n_params=n_params, **dict(TRAIN_FULL, arch=arch),
        losses=losses, loss_drop=losses[0] - losses[-1], step_log=steps,
        s_per_step=step_s, tokens_per_s=tokens / step_s,
        max_memory_allocated_gib=peak / 2 ** 30,
        model_flops_per_step=flops,
        mfu_bf16_989=flops / step_s / PEAK_OPS_PER_S["bf16"],
        launches_per_step=dict(zip(TRAIN_COUNT_NAMES, per_step[0])),
        launches_per_step_want=dict(zip(TRAIN_COUNT_NAMES, want)),
        launches=dict(zip(TRAIN_COUNT_NAMES, (sum(x) for x in
                                               zip(*per_step)))),
        ssd_chunk_backward_by_body=bwd_bodies, wall_s=wall)
    need(bwd_bodies["cuda_core"] == 0, f"train (c) {arch}: K5-bwd ran "
         f"{bwd_bodies} times by body; bf16 at full width takes the wgmma "
         "body")
    need(all(math.isfinite(x) for x in losses), f"train (c) {arch}: a loss "
         f"is not finite: {losses}")
    need(losses[0] - losses[-1] >= TRAIN_LOSS_DROP, f"train (c) {arch}: the "
         f"loss fell by {losses[0] - losses[-1]} < {TRAIN_LOSS_DROP}: "
         f"{losses}")
    need(all(x == want for x in per_step), f"train (c) {arch}: launches a "
         f"step {per_step}, the code gives {want}")
    return out


def phase_train(torch, np, FA, RN, K5):
    """Training on the card (see TRAIN_FULL and the notes above it): for
    each of TRAIN_ARCHS, (a) f32 against the JAX package's constants, (b)
    the kernel path against the plain path at full width, cut in depth
    (and for the hybrid family also at its served group size in f32:
    TRAIN_DEEP), (c) the full-width run through `repro_torch.launch.train`; then (d)
    crash and restart (the dense family's: the checkpointer does not
    depend on the family)."""
    import shutil

    from repro_torch.optim import AdamWConfig
    from repro_torch.launch.train import train
    counts = partial(train_counts, FA, RN, K5)
    with open(TRAIN_EXPECTED_FILE) as f:
        exp = json.load(f)
    res = {"phase": "train", "families": {}}
    for arch, cut_to in TRAIN_ARCHS.items():
        t0 = time.perf_counter()
        fam = dict(jax_parity=train_jax_parity(torch, np, arch, exp[arch],
                                               counts),
                   kernel_vs_plain=train_kernel_vs_plain(
                       torch, arch, cut_to, counts))
        if arch == TRAIN_DEEP["arch"]:
            fam["kernel_vs_plain_deep"] = train_deep_hybrid(torch, counts)
        fam["full"] = train_full_run(torch, arch, counts)
        fam["seconds"] = time.perf_counter() - t0
        emit(dict(phase="train", arch=arch, **fam))
        if arch == TRAIN_FULL["arch"]:
            res.update(fam)
        else:
            res["families"][arch] = fam

    # (d) crash and restart at (b)'s size
    out = os.path.join(HERE, "build", "train_restart")
    shutil.rmtree(out, ignore_errors=True)
    kw = dict(smoke=False, steps=TRAIN_RESTART["steps"],
              global_batch=TRAIN_CUT["global_batch"],
              seq_len=TRAIN_CUT["seq_len"], seed=TRAIN_RESTART["seed"],
              overrides=dict(n_layers=TRAIN_CUT["n_layers"]),
              optimizer=AdamWConfig(
                  lr=TRAIN_FULL["lr"],
                  moment_dtype=TRAIN_RESTART["moment_dtype"]),
              log_every=1 << 30)
    arch = TRAIN_FULL["arch"]
    t0 = time.perf_counter()
    try:
        train(arch, ckpt_every=TRAIN_RESTART["ckpt_every"],
              fail_at=TRAIN_RESTART["fail_at"], out=os.path.join(out, "a"),
              **kw)
        crashed = False
    except RuntimeError as e:
        crashed = "injected failure" in str(e)
    need(crashed, "train (d): the run did not fail at fail_at")
    resumed, r_losses = train(arch, ckpt_every=TRAIN_RESTART[
        "ckpt_every"], out=os.path.join(out, "a"), **kw)
    restart_s = time.perf_counter() - t0
    clean, c_losses = train(arch, **kw)
    diff = [n for n in clean if not torch.equal(resumed[n], clean[n])]
    res["restart"] = dict(
        **TRAIN_RESTART, resumed_losses=r_losses, clean_losses=c_losses,
        bitwise=not diff, differing=diff, crash_and_resume_s=restart_s,
        checkpoint_gib=sum(
            os.path.getsize(os.path.join(d, f)) for d, _, fs in
            os.walk(os.path.join(out, "a")) for f in fs) / 2 ** 30,
        seconds=time.perf_counter() - t0)
    shutil.rmtree(out, ignore_errors=True)
    need(len(r_losses) == TRAIN_RESTART["steps"] - TRAIN_RESTART["ckpt_every"]
         - 1, f"train (d): the resumed run ran {len(r_losses)} steps, not "
         "from the checkpoint")
    need(not diff, f"train (d): the resumed run's parameters differ from "
         f"the uninterrupted run's in {diff}")
    emit(dict(phase="train", restart=res["restart"]))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-requests", type=int, default=N_REQUESTS,
                    help="Fig. 5 trace length (the paper's, 60000, by "
                    "default)")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import numpy as np
        import torch

        from repro_torch import api
        from repro_torch.kernels import _build
        from repro_torch.kernels import decode_attention as DA
        from repro_torch.kernels import event_loop as K0
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import frp_select as fs
        from repro_torch.kernels import rmsnorm as RN
        from repro_torch.kernels import ssd_chunk as K5
        from repro_torch.core.policies import KERNELS
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            phase_s[name] = time.perf_counter() - t0
            print(f"chip_smoke: phase {name} {phase_s[name]:.1f} s",
                  file=sys.stderr, flush=True)

    try:
        smi = smi_line()
        kind = torch.cuda.get_device_name(0)
        emit(dict(phase="device", name=kind, nvidia_smi=smi,
                  count=torch.cuda.device_count(),
                  torch=torch.__version__, cuda=torch.version.cuda))
        timed("build", _build.build)
        emit(dict(phase="build", seconds=phase_s["build"],
                  sources=list(_build.SOURCES),
                  per_source_s={k: v["seconds"] for k, v in
                                _build.BUILD_INFO.items()},
                  ptxas={k: v["ptxas"] for k, v in
                         _build.BUILD_INFO.items()}))
        kres = timed("kernel", phase_kernel, torch, np, fs)
        srows = timed("kernel_serving", phase_serving_kernels, torch, FA,
                      DA, RN)
        srows += timed("kernel_ssd", phase_ssd_kernel, torch, np, K5)
        trows = timed("kernel_training", phase_training_kernels, torch, np,
                      FA, RN, K5)
        cexp = load_cluster_expected()
        exp = load_expected()
        main, main_rs = timed("main_path", phase_main_path, torch, np, api,
                              fs, K0, exp, args.n_requests)
        _, fig6_rs = timed("fig6", phase_fig6, torch, api, fs, K0, exp,
                           args.n_requests)
        eager = timed("eager_card", phase_eager_card, torch, np, api, K0)
        timed("wide", phase_wide, torch, api, K0, exp)
        opts = timed("options", phase_options, torch, np, api, fs, K0, cexp,
                     args.n_requests, main, main_rs)
        static = timed("static_cluster", phase_static_cluster, torch, np,
                       api, fs, K0, cexp, args.n_requests)
        dynamic = timed("dynamic_cluster", phase_dynamic_cluster, torch, np,
                        api, fs, K0, cexp, args.n_requests)
        churn = timed("churn", phase_churn, torch, np, api, fs, K0, cexp,
                      args.n_requests)
        resil = timed("resilience", phase_resilience, torch, np, api, fs, K0,
                      cexp, args.n_requests)
        tele = timed("telemetry", phase_telemetry, torch, np, api, fs, K0,
                     exp, args.n_requests, main_rs)
        scale = timed("scale_out", phase_scale_out, torch, np, api, fs, K0,
                      args.n_requests, fig6_rs)
        refc = timed("reference", phase_reference, torch, np, api, fs, K0)
        audit = timed("audit", phase_audit, torch)
        parity_err = timed("parity", phase_parity, np, api)
        timed("model_parity", phase_model_parity, torch, np)
        by_path = {"serve": timed("serve", phase_serve, torch, np, FA, DA,
                                  RN),
                   "serve_ssm": timed("serve_ssm", phase_serve_ssm, torch,
                                      np, FA, DA, RN, K5),
                   "serve_moe": timed("serve_moe", phase_serve_moe, torch,
                                      np, FA, DA, RN),
                   "serve_mla": timed("serve_mla", phase_serve_mla, torch,
                                      np, FA, DA, RN)}
        tr = timed("train", phase_train, torch, np, FA, RN, K5)
        by_path["train"] = tr["full"]["launches"]
        for arch, fam in tr["families"].items():
            by_path[f"train {arch}"] = fam["full"]["launches"]
        if args.profile:
            timed("profile", phase_profile, torch, api, args.n_requests)
            timed("profile_serving", phase_profile_serving, torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    lanes = kres["lanes"]
    report = "\n".join(_build.BUILD_INFO.get(s, {}).get("ptxas", "")
                       for s in ("event_loop",) + _build.CLUSTER_UNITS)
    kernels = []
    static_launches = {}
    for x in static["specs"]:
        for v, c in x["launches"]["by_variant"].items():
            static_launches[v] = static_launches.get(v, 0) + c
    for p in POLICIES:
        m, e = main["per_policy"][p], eager[p]
        v = m["variant"]
        on = opts["per_policy"][p]
        kernels.append(dict(
            name=f"event_loop[{p}]", entry="event_loop", variant=m["variant"],
            route="cuda", source="src/repro_torch/csrc/event_loop.cu",
            replaces="src/repro/core/jax_engine.py:1001",
            policy_kernel=POLICY_SOURCE[p], pallas=False,
            note="engine work with no Pallas twin (K0): the XLA while_loop "
            "of _simulate with this policy's hooks"
            + (", K1 inline" if m["variant"].startswith("esff") else ""),
            launches=main["launches"]["by_variant"][m["variant"]],
            launches_by_phase=dict(
                main_path=main["launches"]["by_variant"][v],
                options=opts["launches"]["by_variant"][v],
                options_window_4096=opts["window_4096_launches"][
                    "by_variant"].get(v, 0),
                fig8=opts["fig8"]["launches_by_variant"].get(v, 0),
                static_cluster=static_launches.get(v, 0),
                scale_out=sum(x["launches"].get(v, 0)
                              for x in scale["shards"])
                + scale["devices_1"]["launches"].get(v, 0),
                reference=sum(r["launches"].get(v, 0) for r in refc["cases"]
                              if r["form"] == "single-node")),
            ms_options_on=on["k0_ms_options_on"],
            options_overhead_pct=on["overhead_pct"],
            static_cluster={f"AGG={x['agg']}": x["per_policy"][p]
                            for x in static["specs"]
                            if p in x["per_policy"]},
            max_abs_err=max(e.get(p, 0.0) for e in parity_err.values()),
            ms=m["k0_ms"],
            us_per_event=m["k0_us_per_event"],
            longest_lane_events=m["longest_lane_events"],
            plain_ms=e["plain_ms"], plain_n_requests=e["n_requests"],
            plain_ms_per_step=e["plain_ms_per_step"],
            ms_at_plain_n=e["k0_ms"],
            plain_note=f"the eager loop's run at N = {e['n_requests']} (the "
            f"main path's N = {main['n_requests']} would take minutes to "
            "hours); ms_at_plain_n is K0 on those same inputs",
            bound_ms=m["bound_ms"], bound_by=m["bound_by"],
            library_ms=None, ptxas=ptxas_lines(report, PTXAS_NAME[p]),
            check="passed",
            at=f"(7 lanes, N = {main['n_requests']}, F = 200)"))
    kernels.append(dict(
        name="frp_select", entry="frp_select_lanes", route="cuda",
        source="src/repro_torch/csrc/frp_select.cu",
        replaces="src/repro/kernels/sched_weights.py:68",
        launches=main["launches"]["frp_select"], inlined_in="event_loop",
        inline_scans=sum(main["per_policy"][p]["policy_counts"][0]
                         for p in POLICIES),
        max_abs_err=lanes["max_abs_err"],
        ms=lanes["ms"], plain_ms=lanes["plain_ms"],
        bound_ms=lanes["bound_ms"], bound_by=lanes["bound_by"],
        library_ms=None, check="passed",
        at="(7, 200) f64 lanes, with and without ESFF-H's coldK"))
    dyn_launches, churn_launches, resil_launches = {}, {}, {}
    for phase, tally in ((dynamic, dyn_launches), (churn, churn_launches),
                         (resil, resil_launches)):
        for x in phase["specs"]:
            for v, c in x["launches"]["cluster_by_variant"].items():
                tally[v] = tally.get(v, 0) + c
    tiers = next(x for x in resil["specs"] if x["spec"] == "resil-tiers")
    for p in CLUSTER_POLICIES:
        v = K0.variant_of(KERNELS[p])
        big = dynamic["specs"][0]["per_policy"][p]
        e = dynamic["eager_card"][p]
        ce = churn["eager_card"][p]
        fc = churn["specs"][0]["per_policy"][p]
        kernels.append(dict(
            name=f"event_loop_cluster[{p}]", entry="cluster_loop",
            variant=v, route="cuda",
            source="src/repro_torch/csrc/event_loop.cu",
            replaces="src/repro/cluster/engine.py:413",
            policy_kernel=POLICY_SOURCE[p], pallas=False,
            note="engine work with no Pallas twin: the K-node variant of K0 "
            "(the XLA while_loop of _simulate_cluster with this policy's "
            "hooks and the dynamic routers"
            + (", K1 inline)" if v.startswith("esff") else ")"),
            launches=(dyn_launches.get(v, 0) + churn_launches.get(v, 0)
                      + resil_launches.get(v, 0)),
            launches_by_phase=dict(
                dynamic_cluster=dyn_launches.get(v, 0),
                churn=churn_launches.get(v, 0),
                resilience=resil_launches.get(v, 0),
                reference=sum(r["launches"].get(v, 0) for r in refc["cases"]
                              if r["form"] == "K-node")),
            launches_by_spec={x["spec"]:
                              x["launches"]["cluster_by_variant"].get(v, 0)
                              for x in dynamic["specs"]},
            max_abs_err=max(parity_err["dynamic_cluster"].get(p, 0.0),
                            parity_err["churn"].get(p, 0.0),
                            parity_err["resilience"].get(p, 0.0)),
            ms=big["ms"], us_per_event=big["us_per_event"],
            longest_lane=big["longest_lane"],
            longest_lane_events=big["longest_lane_events"],
            per_spec={x["spec"]: x["per_policy"][p]
                      for x in dynamic["specs"]},
            plain_ms=e["plain_ms"], plain_n_requests=e["n_requests"],
            plain_ms_per_step=e["plain_ms_per_step"], ms_at_plain_n=e["ms"],
            plain_note=f"the eager K-node loop's run at N = "
            f"{e['n_requests']} over {e['entries']} (the main path's N "
            f"would take hours); ms_at_plain_n is the kernel on those "
            "same inputs",
            bound_ms=big["bound_ms"], bound_by=big["bound_by"],
            churn=dict(ms=fc["ms"], us_per_event=fc["us_per_event"],
                       longest_lane=fc["longest_lane"],
                       longest_lane_events=fc["longest_lane_events"],
                       bound_ms=fc["bound_ms"], bound_by=fc["bound_by"],
                       per_spec={x["spec"]: x["per_policy"][p]
                                 for x in churn["specs"]},
                       plain_ms=ce["plain_ms"],
                       plain_n_requests=ce["n_requests"],
                       plain_ms_per_step=ce["plain_ms_per_step"],
                       ms_at_plain_n=ce["ms"],
                       at=f"({fc['lanes']} lanes: "
                       f"{churn['specs'][0]['entries']}, N = "
                       f"{churn['n_requests']}, F = 200)"),
            resilience=dict(per_spec={x["spec"]: x["per_policy"][p]
                                      for x in resil["specs"]
                                      if p in x["per_policy"]},
                            eager_card=resil["eager_card"][p]),
            library_ms=None,
            ptxas=ptxas_lines(report, PTXAS_NAME_CLUSTER[p]),
            check="passed",
            at=f"({big['lanes']} lanes: {dynamic['specs'][0]['entries']}, "
            f"N = {dynamic['n_requests']}, F = 200)"))
    # the K-node variants that only the resilience phase runs (resil-tiers'
    # three other policies): timed on its dynamic launch, their plain
    # version the eager K-node loop beside them at N = RESIL_EAGER_N_OTHERS
    for p in tiers["per_policy"]:
        if p in CLUSTER_POLICIES:
            continue
        v = K0.variant_of(KERNELS[p])
        r, e = tiers["per_policy"][p], resil["eager_card"][p][0]
        kernels.append(dict(
            name=f"event_loop_cluster[{p}]", entry="cluster_loop",
            variant=v, route="cuda",
            source="src/repro_torch/csrc/event_loop.cu",
            replaces="src/repro/cluster/engine.py:413",
            policy_kernel=POLICY_SOURCE[p], pallas=False,
            note="engine work with no Pallas twin: the K-node variant of K0 "
            "under the resilience layer (its single node and static tier "
            "as K = 1 lanes)" + (", K1 inline" if v.startswith("esff")
                                 else ""),
            launches=resil_launches.get(v, 0),
            launches_by_phase=dict(resilience=resil_launches.get(v, 0)),
            max_abs_err=e["max_abs_err"], ms=r["ms"],
            us_per_event=r["us_per_event"], longest_lane=r["longest_lane"],
            longest_lane_events=r["longest_lane_events"],
            plain_ms=e["plain_ms"], plain_n_requests=e["n_requests"],
            plain_ms_per_step=e["plain_ms_per_step"], ms_at_plain_n=e["ms"],
            plain_note=f"the eager K-node loop's run at N = "
            f"{e['n_requests']} over {e['entries']}; ms_at_plain_n is the "
            "kernel on those same inputs; max_abs_err is theirs",
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            ptxas=ptxas_lines(report, PTXAS_NAME_CLUSTER[p]),
            check="passed",
            at=f"(resil-tiers' dynamic launch, {r['lanes']} lanes, N = "
            f"{resil['n_requests']}, F = 200)"))
    kernels += traced_kernel_rows(K0, KERNELS, tele, main["n_requests"])
    for name, source, replaces, at in SERVING_KERNELS:
        mine = [r for r in srows if r["kernel"] == name]
        rep = next(r for r in mine if r["case"] == at)
        # launches: the serving path that carries the kernel's timed case
        # (serve for K2-K4 at Qwen3-4B's shapes, serve_ssm for K5,
        # serve_mla for K3-mla); the counts of every serving path beside
        # them
        main = {"ssd_chunk": "serve_ssm",
                "mla_decode_attention": "serve_mla"}.get(name, "serve")
        kernels.append(dict(
            name=name, entry=name, route="cuda",
            source=f"src/repro_torch/csrc/{source}",
            replaces=replaces, launches=by_path[main][name],
            **({"pallas": False, "note": "no Pallas twin: the attention "
                "einsums of the JAX package's _decode_mla (MLA decode "
                "with weight absorption)", "body": rep["body"],
                "cuda_core_ms": rep["cuda_core_ms"],
                "cuda_core_device_ms": rep["cuda_core_device_ms"],
                "launches_by_body": by_path["serve_mla"][
                    "mla_decode_attention_by_body"],
                "ptxas": mla_ptxas(),
                "cases": [
                    {k: r[k] for k in ("case", "body", "ms", "device_ms",
                                       "plain_ms", "library_ms", "bound_ms",
                                       "bound_by", "max_abs_err", "tol_use",
                                       "fault_ratio", "bitwise_repeat")}
                    for r in mine]}
               if name == "mla_decode_attention" else {}),
            launches_by_path={k: v.get(name, 0) for k, v in by_path.items()},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=rep["ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep["library_ms"], device_ms=rep["device_ms"],
            **({"fused_pair_ms": rep["fused_pair_ms"]}
               if "fused_pair_ms" in rep else {}),
            **({k: rep[k] for k in ("body", "bound_f32_ms")}
               if name == "ssd_chunk" else {}),
            **({"window_cases": [
                {k: r[k] for k in ("case", "window", "ms", "device_ms",
                                   "plain_ms", "library_ms", "bound_ms",
                                   "bound_by", "max_abs_err", "tol_use",
                                   "fault_ratio")}
                for r in mine if "window" in r],
                "window_launches": by_path["serve_ssm"][
                    "flash_attention_window"],
                "window_library_note": "SDPA with the band as a boolean "
                "mask",
                "mla_cases": [
                    {k: r[k] for k in ("case", "ms", "device_ms",
                                       "plain_ms", "library_ms", "bound_ms",
                                       "bound_by", "max_abs_err", "tol_use",
                                       "fault_ratio")}
                    for r in mine if r.get("mla")],
                "mla_launches": by_path["serve_mla"]["flash_attention"]}
               if name == "flash_attention" else {}),
            tol=KERNEL_TOL[name],
            tol_use=max(r["tol_use"] for r in mine),
            fault_ratio_min=min(r["fault_ratio"] for r in mine),
            check="passed", at=at))
    for name, source, replaces, derived, at in TRAINING_KERNELS:
        mine = [r for r in trows if r["kernel"] == name]
        rep = next(r for r in mine if r["case"] == at)
        unit = source[:-len(".cu")]
        kernels.append(dict(
            name=name, entry=name, route="cuda",
            source=f"src/repro_torch/csrc/{source}", replaces=replaces,
            pallas=False, note=f"no Pallas twin: {derived} (the JAX "
            "package has no backward kernel)",
            # the full-width training runs of every family, and each run
            # of the train phase beside them
            launches=sum(v.get(name, 0) for k, v in by_path.items()
                         if k.startswith("train")),
            launches_by_path=dict(
                {k: v.get(name, 0) for k, v in by_path.items()
                 if k.startswith("train")},
                train_f32_parity=tr["jax_parity"]["launches"][name],
                train_kernel_vs_plain=tr["kernel_vs_plain"]["launches"][
                    name],
                **{f"{part} {arch}": fam[part]["launches"][name]
                   for arch, fam in tr["families"].items()
                   for part in ("jax_parity", "kernel_vs_plain",
                                "kernel_vs_plain_deep") if part in fam}),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=rep["ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep["library_ms"], device_ms=rep["device_ms"],
            **{k: rep[k] for k in ("design_bound_ms", "device_ms_by_kernel",
                                   "bound_f32_ms", "library_note", "body",
                                   "floor_ms", "floor_by", "scratch_bytes")
               if k in rep},
            ptxas=ptxas_lines(_build.BUILD_INFO.get(unit, {}).get(
                "ptxas", ""), *TRAINING_PTXAS[unit]),
            tol=KERNEL_TOL[name],
            tol_use=max(r["tol_use"] for r in mine),
            fault_ratio_min=min(r["fault_ratio"] for r in mine),
            check="passed", at=at))
    emit(dict(phase="done", total_s=time.perf_counter() - t_start,
              phase_s=phase_s, audit_passed=audit["passed"]))
    print(smi, flush=True)
    emit(dict(kernels=kernels))
    emit(dict(ok=True, device=dict(platform="gpu", kind=kind,
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
