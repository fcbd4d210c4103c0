#!/usr/bin/env python3
"""chip_smoke — drive the PyTorch/CUDA port's serving, training and node
health paths on one GPU.

  python3 chip_smoke.py          # from the root of a checkout, one H100

  python3 chip_smoke.py k4 [--batch B] [--seq S] [ROOT ...]
  python3 chip_smoke.py bwd [--batch B] [--seq S] [--train] [ROOT ...]
  python3 chip_smoke.py decode [--tick] [--prefill] [ROOT ...]
  python3 chip_smoke.py k2 [--int8] [ROOT ...]
  python3 chip_smoke.py training
  python3 chip_smoke.py node
  python3 chip_smoke.py doctor
  python3 chip_smoke.py vision
  python3 chip_smoke.py telemetry
  python3 chip_smoke.py moe

`k4` times K4 alone beside SDPA's forward in the k4_* cases, B 4 x S
2048 unless asked otherwise, one JSON line. `bwd` times K5 and K6 (and
K4) in the same cases beside SDPA's backward, whole and with only q
requiring grad, one JSON line; with --train also the train phase's
8-layer llama3_8b step (median ms, device-busy ms, the flash kernels'
device ms a step from torch.profiler). `decode` times K1 and K3 in
every k1_* and k3_* case on bf16, int8 and int4 caches, one JSON line;
with --tick also the paged decode tick on llama3_8b (wall and
device-busy ms) and the paged engine's own tick at 8 slots (the median
gap between a streamed request's token events), with --prefill one
llama3_8b prefill of 2 x 512 tokens through decode_step (wall and
device-busy ms, K1's ms and share of the busy time). `k2` times K2 in
every k2_* case beside its library call, and K7 beside torch.mul in
turns, one JSON line; with --int8 also
llama3_8b's prefill of 8 x 128 and decode step at batch 8 on bf16
weights and on their int8 copy (wall ms, device-busy ms, K2's ms and
the top kernels of each). Each ROOT, a checkout such as a `git archive` of a
parent unpacked under checkout_proof/, is timed in a process of its own
that imports the port from there, in the order given (parent, change,
change, parent), so that two versions compare within one call on one
card. `training` runs the build and the training path's phases alone
(train through serve_ckpt below), `node` the build and the node phase,
`doctor` the build and the doctor phase, `vision` the build and the
vision phase, `telemetry` the build and the telemetry phase, `moe` the
build and the moe phase.

Phases, one JSON line each:
  device   the card's name and power limit (nvidia-smi);
  build    compile the port's CUDA kernels from this checkout;
  k1_*     kernels/decode_attention.cu (contiguous) against
           decode_attention_plain at Llama-3-8B widths, timed beside the
           plain version and F.scaled_dot_product_attention (timing only);
           every k1_* and k3_* line (all KV modes) names the body that ran
           (decode_split_kernel, or prefill_mma_kernel for prefill),
           its key-range splits, and its registers and spill bytes from
           ptxas's report;
  k2_*     kernels/int8_matmul.cu against int8_matmul_plain (and its
           bits repeated) at every call llama3_8b makes: the seven
           projections and the f32 lm_head at T 8, and prefill at T 1024
           and 512; timed cold (copies rotated past the L2) beside
           torch.matmul on the dequantized weight (timing only); each
           line names the body that ran, its token tile and splits of D,
           and its registers and spill bytes (none may spill);
  k3_*     the paged entry of kernels/decode_attention.cu against
           paged_decode_attention_plain at 8B widths and page 128, timed
           beside the plain version, K1 on a contiguous copy of the same
           keys, and SDPA on that copy (timing only);
  k1_int8_*, k1_int4_*, k3_int8_*, k3_int4_*  K1 and K3 on int8 and int4
           caches (the k1_* and k3_* cases) against their plain quantized
           versions, timed beside the plain version, the bf16 kernel on
           the same keys dequantized, and dequantize + SDPA (timing only);
  serve    llama3_8b at full width and depth, random bf16 weights from a
           seed, behind BatchingEngine + make_server on an ephemeral
           port: concurrent requests in two buckets plus one streamed;
           then decode ms per step at batch 8 and a torch.profiler
           breakdown of the device time of a decode step;
  int8     the same weights through quantize_llama_params and generate,
           the prefill logits against the plain path; then the prefill
           of 8 x 128 and the decode step at batch 8 on bf16 and int8
           weights: wall ms, device-busy ms, K2's ms, top kernels;
  paged    the same weights behind PagedContinuousEngine + make_server:
           one request that leaves a 256-token prefix in the prefix
           cache, then a concurrent burst of short, prefix-sharing, long
           (two prefill chunks) and streamed requests; then the paged
           decode tick at 8 slots and its torch.profiler breakdown;
  paged_preempt  a second paged engine with a pool of 8 usable pages and
           3 requests that need 12: requests are preempted and requeued;
  continuous  ContinuousEngine (slot cache, K1 with per-slot lengths)
           behind make_server on a burst of short and streamed requests;
  kv_quant the same weights on int8 and int4 KV caches: bytes per cached
           token of each layout; the paged phase's burst behind
           make_server (leak check, tokens/s, stream TTFT); the paged
           decode tick at 8 slots; one decode step's logits on the kernel
           path against the plain path on the same quantized cache, and
           the drift from bf16; paged_preempt's load on pools of the
           bf16 pool's bytes; a continuous-engine burst in each mode;
  observe  the serving observability path: PagedContinuousEngine at 16
           slots, page 128, max_len 2048, on a pool of 2048 pages (32
           GiB) behind make_server, with a RequestRecorder, its
           ServeMetricsExporter on an ephemeral port, the flight
           recorder and every request traced; cli/loadgen as a process
           of its own sends 64 streamed requests of multi-tenant chat
           traffic (4 tenants, a 256-token system prompt each, 128-token
           turns and 1024-token documents, 64 new tokens, 16 at a time).
           Checks: no loadgen error; the scrape counts 64 requests and
           64 TTFTs; the tokens counted equal the answers'; no page
           leaked; a prefix hit; host_gap_fraction in [0, 1]; every host
           phase has samples; the trace dump's spans in order for every
           request; /debugz?kv=1's census sums to the pool with every
           page's tenant; the HbmPoller's bytes in use within 1% of
           mem_get_info. Then 32 requests of the same traffic on the int8
           copy of the weights (K2's two bodies) on a pool of the same
           size. One line a run: TTFT, TPOT and queue-wait p50/p99,
           tokens/s, host_gap_fraction, each host phase's p50, the
           thermal census's ms a call at the full pool, nvidia-smi;
  moe      (after the serving phases, the 8B weights freed) a mixture of
           experts: Llama-3-8B's attention and vocabulary with
           Mixtral-8x7B's FFN (8 experts of d_ff 14336, top-2, dropless),
           random bf16 weights from the seed, cut to 16 of 32 layers (32
           need ~95 GB). (a) The window, continuous and paged engines,
           then the paged one with ngram speculation (k 4), each behind
           make_server answering 8 requests of 64-512 tokens, 32 greedy
           new tokens, held against decode.generate at batch 1 by the
           divergence rule with D and R (a row may also part where a
           router's k-th and (k+1)-th probabilities lie within 2 R, R
           measured as D is); K1 and K3 launched; the prefill logits
           against forward (K4) row by row; the paged tick at 8 slots
           and a 512-token prefill, wall and busy ms and the MoE FFN's
           share; plan_serving beside the peak. (b) plan_training, then
           2 layers trained 4 steps at B 2 x 1024 under 'dots', dropless
           and with capacity: losses, aux, dropped_fraction, step ms,
           MFU (one FFN a token), busy share, K4-K6 launched. (c) A
           4-expert llama_tiny fit 2 steps with a checkpoint, served by
           cli/serve.py --checkpoint as a process (2 requests against
           generate in this process), and --weight-dtype int8 refused;
  k4_*, k5_*, k6_*  kernels/flash_attention.cu (forward, dq, dk/dv)
           against flash_fwd_plain, flash_bwd_dq_plain and
           flash_bwd_dkv_plain at the training shapes (B 4, S 2048, 32 q
           heads, 8 KV heads, D 128; causal, segmented and non-causal),
           timed beside the plain versions and SDPA's forward and
           backward (timing only; K5 beside the backward with only q
           requiring grad; the segmented case with the
           segment-and-causal boolean mask), naming SDPA's backend;
           each kernel's registers and spill bytes from ptxas's report
           on the library loaded (none may spill); k5_k6_* sets the
           pair's ms beside SDPA's whole backward;
  train    llama3_8b at full width and 8 of its 32 layers, random f32
           masters from a seed, trained for 6 steps at batch 4 x 2048 by
           fit (synthetic data, make_optimizer, 'dots' remat): step ms,
           tokens/s, MFU, peak memory, losses, launches per step, and a
           torch.profiler breakdown of one more step; then the same 6
           steps under 'dots_save_attn' (K4 8 a step, not 16);
  train_parity  llama3_8b widths at 2 layers, batch 1 x 512: one
           make_train_step on the kernel path and on the plain path from
           the same weights, and the kernel path under 'none', 'dots',
           'full' and 'dots_save_attn' remat, which must give identical
           gradients ('dots_save_attn' with one K4 launch a layer);
  train_cli  cli.train --preset tiny --steps 3 on the card;
  ckpt     checkpoint and resume at full width, 2 layers in /dev/shm
           (ckpt_room: the machine caps a call's disk writes), batch
           2 x 1024: fit for 2 steps saving every 2, a second fit
           resuming at 2 to 4, held against an uninterrupted 4-step run
           (CKPT_RESUME_RTOL); the same with async saves (the steps'
           extra seconds against the uninterrupted run's, beside the sync
           save's; bytes, save and restore GB/s);
           then the newest step truncated, quarantined, and the run
           resumed from the step before;
  observe_train  fit at 2 layers with /metrics on an ephemeral port, the
           JSONL step log, a heartbeat dir and the hang watchdog (2 s),
           a 5 s data stall (training/dataset.inject_stall): the scrape's
           tokens/s, MFU and goodput families, one JSONL line a step,
           the heartbeat moving, train_stalled raised, the stall in the
           `stalled` bucket; the recorder's MFU beside the log fences';
  eval     cli/eval.py on the ckpt phase's checkpoint and a token file,
           against loss_fn on the same weights and batches (K4 counted);
  serve_ckpt  load_model(<ckpt dir>) behind make_server on the paged
           engine, one request, against generate on the same weights
           (divergence rule, SERVE_CKPT_D); the same on int8 weights
           (K2); cli/generate.py --checkpoint prints generate's tokens;
  health   the node health path: K7 (kernels/scale_demo.cu) as the
           node's workload; then K7 built with the whole [4096, 4096]
           array as one shared-memory tile (refused by ptxas), an
           allocation larger than the card and a benign bf16 matmul, each
           in a process of its own, their stderr the runtime log that a
           TPUHealthChecker over a TPUManager of the host's /dev scrapes
           (VMEM_OOM and HBM_OOM, every device still Healthy); then
           cli.inject_fault's HBM_ECC_UNCORRECTABLE for card 0 (nvidia0
           Unhealthy, one Warning Event, the node condition); K7 against
           x * 2.0 (exact), timed in turns with torch.mul (5 each);
  node     the node layer, no model: NVML's cards and driver version,
           each /dev/nvidia<N> (opens, NVML's identity, torch's card); a
           dev root of links to the nodes NVML names where a node does
           not open or NVML does not name it; cli/device_plugin_main.py
           as a process (metrics every 0.5 s, health on) registering
           with a kubelet stub; ListAndWatch equal to discovery,
           GetPreferredAllocation, Allocate for torch's card (its node,
           the control nodes, the driver mount, CUDA_VISIBLE_DEVICES its
           UUID); a process with exactly those envs running K4 for 6 s
           beside an 8 GiB allocation (one card, that UUID); /metrics'
           NVML duty cycle (> 50%, within 15 points of nvidia-smi) and
           memory (within 512 MiB of nvidia-smi, above 8 GiB) on
           nvidia<N> and on the PodResources stub's ns/pod/ctr, the
           health families, then the duty cycle falling once the K4 loop
           ends; an injected HBM_ECC_UNCORRECTABLE Unhealthy on the open
           stream (within one of the health checker's default 5 s polls,
           plus 5 s); re-registration after the socket is removed and after a
           kubelet restart (10 s each); partition_tpu and runtime_ready
           on the served root; read_driver_version beside nvidia-smi;
           SIGTERM (10 s, socket removed); then the NRI device injector
           (nri/daemon.py) as a process against a fake runtime on a
           socket of the run's: RegisterPlugin (timed), Configure,
           Synchronize, CreateContainer for a pod annotated with
           /dev/nvidia<N> (torch's card), /dev/nvidiactl and
           /dev/nvidia-uvm (each a char device with os.stat's major,
           minor, uid and gid), and an absent node (an RPC error); and
           the topology scheduler, which touches no device: the labeler
           from a local metadata stub onto this machine's node in a
           local API stub (nvidia.com/gpu: the plugin's cards), two
           labelled fake nodes beside it, run_once ungating a gang of 2
           (this node and its slice neighbour);
  vision   the vision training demos: mnist.train 200 steps (accuracy >
           0.9) and resnet.train on resnet_tiny 60 steps (> 0.5), the
           demo Jobs' contracts; resnet50() in f32 at batch 2, 224^2 on
           the card against the CPU on the same variables, TF32 off
           (logits within 1e-3 of max |logit|, eval and train mode), and
           the card's bf16 logits beside its f32 ones; then ResNet-50
           v1.5 at full width and depth (stages 3/4/6/3, width 64,
           bottlenecks, 1000 classes, bf16 compute, f32 BN statistics and
           masters, channels_last) trained by Adam at batch 256 x 224^2
           on 4 batches staged on the card: 2 warmup and 10 timed steps
           (median ms, images/s, MFU from the conv and fc FLOPs with the
           backward at twice the forward), a torch.profiler step (busy
           share, top kernels), peak memory, every running statistic
           moved and finite, finite eval logits;
  telemetry  device telemetry, the card only: (a) cli/collective_bench
           --collective all -b 1M -e 512M -f 2 -w 5 --iters 20 --json as
           a process on a one-rank NCCL group (JAX's keys on every line,
           time_us > 0, busBW exactly 0 for the four collectives whose
           factor is 0 at n = 1, ppermute's time at 512 MiB beside the
           copy's byte bound) and each probe's output against its plain
           version; (b) cli/serve.py as a process, llama3_8b at full width
           and depth on the paged engine at 8 slots on int8 weights (K2,
           K3), with --fabric-health (0.5 s sweeps), --doctor,
           --fault-listen and --metrics-port: requests answered while 16
           sweeps build the baseline, no incident; `inject_fault --kind
           fabric-slow --axis dp --rank 0 --factor 8 --seconds 15`:
           fabric_health_score{dp} <= 0.2 and fabric_degraded 1 on
           /metrics, the /debugz?state=1 fabric block degraded with
           slow_rank 0, fabric_degraded once for dp (its latency from the
           command), requests answered; the window over, the verdict
           clears; `--kind hbm-climb`: oom_precursor carries the launch's
           plan_serving budget; the plan beside the process's peak
           allocation, the NCCL group's start time and memory; (c)
           cli/train.py at full width, 2 layers, 6 steps with
           --fabric-health --fabric-health-every 2 and TPU_PROFILE_DIR:
           sweeps at steps 2, 4, 6, the capture's train/step and
           train/fabric_sweep regions and K4-K6 by name, the flight
           recorder's train/* spans and profile/start|stop; (d)
           metrics.fabric --health as a process, one scrape: each NIC's
           counters, tpu_ici_error_count from NVML (or NVML's answer),
           the probe hook's busBW gauge; (e) annotate's µs a region with
           the bus off and on beside the paged tick at 8 slots. The
           subprocesses' launches are read from them (serve's state
           snapshot, train's last line);
  doctor   the doctor and the fleet plane, modelled on the JAX package's
           chaos scenarios (its schedules declared here). Each fault goes
           through cli/inject_fault (a process) into a FaultListener and
           a live Doctor in this process (chaos timescales: the
           scenario's window, 0.25 s period, episode re-arm off, SLOs
           off), with no incident allowed in the clean warmup before it.
           On llama3_8b at full width and depth (bf16, random weights
           from the seed), behind make_server, with a ServeMetricsExporter
           polling the card's memory every 0.25 s and cli/loadgen as a
           process: engine-hang (the continuous engine, K1: `--kind
           hang` 5 s against hang_after_s 2 s, engine_hang once, every
           stream finishes); worker-kill (the supervised paged engine,
           K3: structured errors, no hung stream, pages back to 0, no
           incident); prefill-pool-kill (2 prefill workers, page 32, a
           4-tenant mix: every request answers, the worker replaced, no
           incident); hbm-exhaustion twice on the idle engine (`--kind
           hbm-climb` on injected:0; then this process allocating 4 GiB
           of card memory every 0.5 s until an allocation fails:
           oom_precursor once for cuda:0, its projected time to
           exhaustion beside the real one); health-storm (`--kind
           health-tail` over a feed `inject_fault --kind health`
           fills: health_storm once for HBM_ECC_UNCORRECTABLE). Then the
           8B weights freed: data-stall (fit at full width and 2 layers,
           K4-K6, `--kind data-stall` 4 s: the steps done, >= 3 s
           stalled, data/stall on the timeline, no incident); straggler
           (two cli/train processes, RANK 0 and 1, full width, 2 layers,
           one heartbeat dir, rank 1 slowed 12 s every batch: rank 0's
           `--doctor` names process-1 once, never process-0; both
           finish); replica-kill (cli/fleet.py --replicas 2 serving an HF
           export of the weights' first 4 layers from /dev/shm, started
           before data-stall so that the replicas load meanwhile; fleetmon
           --doctor over both, loadgen --targets, r1 SIGKILLed
           mid-stream: replica_down once for r1, up 1 / down 1, the
           survivor answers, the card's memory back, and fleetmon's dump
           through `trace merge` and `trace doctor` gives the live
           verdicts). The subprocesses' kernel launches are not counted.
Then each phase's seconds, the kernels line (launches on the main path,
errors, times and bounds) and, last, {"ok": true, "device": {...}}. Any
failure exits non-zero before that line. Without CUDA, or outside a
checkout of the repository, it exits non-zero at once.

Times come from CUDA events around a run of launches that the host
queued while the card was held busy, so they are the card's time, not
the host's. Bounds use the H100 SXM's published rates.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import gc
import inspect
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
PEAK_FLOPS = {"bf16": 989e12,    # dense tensor-core rate
              "f32": 67e12}      # CUDA cores
SEED = 0

K1_SOURCE = "container_engine_accelerators_tpu_torch/kernels/decode_attention.cu"
K2_SOURCE = "container_engine_accelerators_tpu_torch/kernels/int8_matmul.cu"
K3_SOURCE = K1_SOURCE
K1_REPLACES = "container_engine_accelerators_tpu/ops/decode_attention.py:282"
K2_REPLACES = "container_engine_accelerators_tpu/ops/quant.py:214"
K3_REPLACES = "container_engine_accelerators_tpu/ops/decode_attention.py:391"
KV_MODES = ("int8", "int4")
# Cache bytes of one token at llama3_8b widths (32 layers, 8 KV heads,
# head_dim 128, K and V): bf16 2 bytes a value; int8 1 byte plus a 4-byte
# scale per (layer, head); int4 half a byte plus the same scales.
KV_BYTES_PER_TOKEN = {"bf16": 131072, "int8": 67584, "int4": 34816}
# paged_preempt's pool of 9 pages (8 usable), and pools of the same
# bytes in the quantized layouts (rounded down).
PREEMPT_POOL_PAGES = {"bf16": 9, "int8": 17, "int4": 33}
K7_SOURCE = "container_engine_accelerators_tpu_torch/kernels/scale_demo.cu"
K7_REPLACES = "demo/tpu-error/real-fault/provoke_vmem_oom.py:24"
FLASH_SOURCE = "container_engine_accelerators_tpu_torch/kernels/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "container_engine_accelerators_tpu/ops/flash_attention.py:231",
    "flash_bwd_dq": "container_engine_accelerators_tpu/ops/flash_attention.py:475",
    "flash_bwd_dkv": "container_engine_accelerators_tpu/ops/flash_attention.py:523",
}
# K1, per output row: bf16 output, f32 math on both sides, so a
# different summation order moves an element by at most one bf16 ulp,
# 2^-7 of the row's largest |o|. Held per row, since a long cache
# averages |o| down and one absolute bound would hide dropped keys.
K1_ROW_RTOL, K1_ROW_ATOL = 2 ** -7, 1e-6
K2_TOL = {"bf16": 2 ** -8, "f32": 1e-4}   # relative to max |y|
LOGITS_RTOL = 5e-2   # kernel path vs plain path, relative to max |logit|
# K4-K6 hold outputs and gradients per row of D values: K4's output as
# K1's (one bf16 ulp, 2^-7 of the row's max), the gradients within 2^-6,
# since they round twice (ds to bf16 before its product, then the sum),
# and both plus an absolute 2^-14 of the tensor's largest |x|: ds =
# p * (dp - delta) cancels where dp is close to delta (always, in a
# causal row's first query), and the two versions' f32 dp differ by
# ~1e-6 of |do||v|. lse (f32, m + log l) within 1e-4.
FLASH_GRAD_ROW_RTOL, FLASH_TENSOR_ATOL, LSE_ATOL = 2 ** -6, 2 ** -14, 1e-4
# Train step, kernel path vs plain path (bf16 activations, 2 layers): the
# two part by bf16 ulps in the attention outputs and gradients, so the
# loss within 1e-2 relative and each weight's gradient within 5e-2 of
# its norm.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-2, 5e-2
# 8 layers: 'dots' replays K4 in the backward, 'dots_save_attn' keeps its
# residuals and does not.
TRAIN_LAUNCHES_PER_STEP = {
    "dots": {"flash_fwd": 16, "flash_bwd_dq": 8, "flash_bwd_dkv": 8},
    "dots_save_attn": {"flash_fwd": 8, "flash_bwd_dq": 8,
                       "flash_bwd_dkv": 8}}
# ckpt: the state is 12 bytes a parameter (f32 masters, two f32 Adam
# moments), 17.8 GB a step at full width and 2 layers. The phase saves 7
# times (2 + 1 sync, 2 + 1 async, 1 after the torn step), 125 GB, and
# the card's machine ends a call past 45 GiB of disk writes, so the
# steps live in RAM-backed /dev/shm (8 layers would need 90 GB there).
# It holds at most 2.7 steps at once (two and a torn one); beside them
# the host holds one pinned async snapshot (1.1 steps, the pinned
# allocator rounds up) and some room (ckpt_room).
CKPT_N_LAYERS, CKPT_SHM = 2, "/dev/shm"
CKPT_BYTES_PER_PARAM, CKPT_PEAK_STEPS, CKPT_HOST_STEPS = 12, 2.7, 4.2
# Steps a ckpt run saves after (and the resumed run runs on to twice
# that): 5 saves in the phase, each a full-width step.
CKPT_STEPS = 2
CKPT_ROOT_PREFIX = "chip_smoke_ckpt-"
# A resumed run against the uninterrupted one: identical bits expected
# (every kernel on the step is deterministic); the bound holds the last
# loss and each master weight within 1e-5 of its largest |x| in case the
# embedding backward's atomics reorder a sum.
CKPT_RESUME_RTOL = 1e-5
# cli/eval.py against loss_fn on the same weights and batches: the same
# launches on the same inputs, so equal; 1e-6 relative.
EVAL_RTOL = 1e-6
# serve --checkpoint against generate on the same weights: the paged
# engine (K3, 8 slots) and generate (K1, one row) sum in other orders,
# so a row may part from generate only at a top-two margin within 2 D,
# D = 0.09, the largest such logit gap the spec phase has measured at 8B
# bf16 on the H100 (PERF.md).
SERVE_CKPT_D = 0.09
# The train step's device time by kind of kernel, from the kernel names
# torch.profiler reports (cuBLAS's are nvjet_* or *gemm*).
STEP_KERNEL_KINDS = {"matmul": ("nvjet", "gemm", "cutlass"),
                     "flash_attention": ("flash_",),
                     "copy": ("Memcpy", "Memset"),
                     "reduction": ("reduce_kernel",),
                     "elementwise": ("elementwise_kernel",),
                     "softmax_cross_entropy": ("softmax", "SoftMax",
                                               "nll_loss"),
                     "embedding": ("embedding",)}


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms: the launches are queued while a
    sleep kernel holds the card, so host overhead does not show."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def _row_errors(got, want, d: int, what: str, rtol: float = K1_ROW_RTOL,
                atol: float = K1_ROW_ATOL) -> tuple[float, float]:
    """(max |diff|, worst row's max |diff| / (max |o| + atol / rtol)).
    Fails unless each output row is within `rtol` of its own max |o|
    plus `atol`."""
    row_err = (got.float() - want.float()).abs().reshape(-1, d).amax(-1)
    row_scale = want.float().abs().reshape(-1, d).amax(-1)
    rel = (row_err / (row_scale + atol / rtol)).max().item()
    require(bool((row_err <= rtol * row_scale + atol).all()),
            f"{what}: a row's max|diff| exceeds {rtol} of its "
            f"max|o| + {atol} (worst {rel})")
    return row_err.max().item(), rel


def _kv_row_bytes(d: int, mode: str) -> int:
    """Bytes of one cached (token, KV head) row of K or V: the payload,
    plus its f32 scale in the quantized modes."""
    return {"bf16": 2 * d, "int8": d + 4, "int4": d // 2 + 4}[mode]


def _attention_work(torch, lens_b, t: int, max_len: int, b: int, hq: int,
                    hkv: int, d: int, mode: str = "bf16"
                    ) -> tuple[float, float, object]:
    """(bytes, flops, mask) of attention these inputs need: q and out
    once, the live K/V rows (and scales) once, 4*D flops per (query row,
    visible key); and the SDPA mask [B, 1, T, max_len] of the same
    function."""
    key_pos = torch.arange(max_len, device=lens_b.device)
    t_idx = torch.arange(t, device=lens_b.device)
    live = (lens_b + t).clamp(max=max_len)
    mask = ((key_pos[None, None, :] < live[:, None, None])
            & (key_pos[None, None, :]
               <= lens_b[:, None, None] + t_idx[None, :, None]))
    n_live = live.sum().item()
    visible = torch.minimum(lens_b[:, None] + t_idx[None, :] + 1,
                            live[:, None]).sum().item()
    n_bytes = 2 * (2 * b * t * hq * d) + 2 * n_live * hkv * _kv_row_bytes(
        d, mode)
    return n_bytes, 4 * d * hq * visible, mask[:, None]


def _sdpa(F, q, k, v, mask):
    """One PyTorch call computing the same attention on a contiguous
    cache: the library yardstick (timing only; the port never calls
    it)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  enable_gqa=True)


def decode_kernel_info(torch, dev, payload: str, keys: str, t: int, b: int,
                       hq: int, hkv: int, max_len: int) -> dict:
    """Which body of kernels/decode_attention.cu a K1/K3 call takes at
    head_dim 128, its key-range splits (ops/decode_attention.split_plan
    on this card's SM count) and its registers and spill bytes from
    ptxas's report."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.ops import (
        decode_attention as da,
    )

    n_rows = t * (hq // hkv)
    kernel = ("decode_split_kernel" if n_rows <= da.DECODE_ROWS
              else "prefill_mma_kernel")
    report = ptxas_report(kernel, f"{payload}Payload", "Li128E",
                          f"{keys}Keys")
    return {"kernel": kernel, "splits": da.split_plan(
        b, hkv, n_rows, max_len, kernels.sm_count(dev)),
        "registers": report["registers"],
        "spill_bytes": report["spill_bytes"]}


# ---------------------------------------------------------------- K1

K1_SHAPE = (32, 8, 128, 2048)     # Hq, Hkv, D, max_len
# The paged tick's short rows: 8 slots of 128-160 cached keys.
TICK_LENGTHS = [128, 132, 136, 140, 145, 150, 155, 160]
# A speculative verify at 16 slots: T = k + 1 = 5 new queries a row over
# rows of the tick's kind, each at its own length.
VERIFY_LENGTHS = TICK_LENGTHS + [n + 40 for n in TICK_LENGTHS]
K1_CASES = [                      # (name, T, B, cache lengths)
    ("decode_slots", 1, 8, [0, 1, 127, 128, 129, 2047, 1000, 513]),
    ("decode_scalar", 1, 8, 1500),
    ("decode_tick", 1, 8, TICK_LENGTHS),
    ("prefill_128", 128, 8, 0),
    ("prefill_512", 512, 2, [0, 1024]),
    ("verify_k4", 5, 16, VERIFY_LENGTHS),
]


def _k1_args(torch, dev, gen, t: int, b: int, lens, mode: str) -> tuple:
    """decode_attention_cuda's arguments in a k1_* case: a cache of
    max_len 2048 from `gen`, bf16 or quantized."""
    hq, hkv, d, max_len = K1_SHAPE
    q = torch.randn(b, t, hq, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, max_len, hkv, d, generator=gen, device=dev)
            for _ in range(2))
    cache_len = (torch.tensor(lens, dtype=torch.int32, device=dev)
                 if isinstance(lens, list) else lens)
    if mode == "bf16":
        return q, k.bfloat16(), v.bfloat16(), cache_len
    (k, ks), (v, vs) = _quantized(torch, k, mode), _quantized(torch, v, mode)
    return q, k, v, cache_len, ks, vs, mode == "int4"


def _decode_steps(kernel, q, cache, lens, tail=()):
    """The T single-token launches that score q's T rows one at a time
    (a plain tick's attention for each verified position): row j at
    lengths lens + j."""
    steps = [lens + j for j in range(q.shape[1])]

    def run():
        for j, n in enumerate(steps):
            kernel(q[:, j:j + 1], *cache, n, *tail)
    return run


def k1_phase(torch, dev) -> dict:
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
    )

    hq, hkv, d, max_len = K1_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    for name, t, b, lens in K1_CASES:
        q, k, v, cache_len = _k1_args(torch, dev, gen, t, b, lens, "bf16")
        got = decode_attention_cuda(q, k, v, cache_len)
        torch.cuda.synchronize()
        want = decode_attention_plain(q, k, v, cache_len)
        err, rel = _row_errors(got, want, d, f"K1 {name}")
        lens_b = (torch.as_tensor(lens, device=dev).reshape(-1)
                  .expand(b).long())
        n_bytes, flops, mask = _attention_work(torch, lens_b, t, max_len, b,
                                               hq, hkv, d)
        ms = device_ms(torch, lambda: decode_attention_cuda(q, k, v,
                                                            cache_len))
        plain_ms = device_ms(torch, lambda: decode_attention_plain(
            q, k, v, cache_len), iters=5)
        library_ms = device_ms(torch, _sdpa(F, q, k, v, mask), iters=5)
        bms, by = bound_ms(n_bytes, flops, "bf16")
        results[name] = {"max_abs_err": err, "max_row_rel_err": rel,
                         "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bms,
                         "bound_by": by}
        if name.startswith("verify"):
            results[name]["decode_steps_ms"] = device_ms(
                torch, _decode_steps(decode_attention_cuda, q, (k, v),
                                     cache_len))
        emit({"phase": f"k1_{name}", "T": t, "B": b, "Hq": hq, "Hkv": hkv,
              "D": d, "max_len": max_len, "lengths": lens,
              "row_rtol": K1_ROW_RTOL, "row_atol": K1_ROW_ATOL,
              **results[name],
              **decode_kernel_info(torch, dev, "Bf16", "Contiguous", t, b,
                                   hq, hkv, max_len)})
        del q, k, v, got, want, mask
    return results


# ---------------------------------------------------------------- K2

# The calls K2 serves on llama3_8b (models/decode.py _proj): each of a
# layer's seven projections and the f32 lm_head at decode (8 rows), and
# prefill at 8 x 128 tokens (1024) and a 512-token paged chunk.
K2_CASES = [                 # (name, T, D, F, x dtype)
    ("wq_t8", 8, 4096, 4096, "bf16"), ("wk_t8", 8, 4096, 1024, "bf16"),
    ("wv_t8", 8, 4096, 1024, "bf16"), ("wo_t8", 8, 4096, 4096, "bf16"),
    ("w_gate_t8", 8, 4096, 14336, "bf16"),
    ("w_up_t8", 8, 4096, 14336, "bf16"),
    ("w_down_t8", 8, 14336, 4096, "bf16"),
    ("lm_head_t8", 8, 4096, 128256, "f32"),
    ("w_gate_t1024", 1024, 4096, 14336, "bf16"),
    ("wk_t1024", 1024, 4096, 1024, "bf16"),
    ("lm_head_t1024", 1024, 4096, 128256, "f32"),
    ("w_gate_t512", 512, 4096, 14336, "bf16"),
    # A verify pass at 16 slots: 16 x (k + 1) = 80 rows.
    ("w_gate_t80", 80, 4096, 14336, "bf16"),
    ("lm_head_t80", 80, 4096, 128256, "f32"),
]
# Weights are timed cold, as a decode step finds them: calls rotate over
# copies that together exceed the 50 MB L2.
K2_ROTATE_BYTES = 128 << 20


def k2_kernel_info(dev, t: int, d: int, f: int, kind: str) -> dict:
    """The body of kernels/int8_matmul.cu a K2 call runs, its token tile
    and splits of D (ops/quant.plan on this card's SM count), and its
    registers and spill bytes from ptxas's report."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.ops import quant

    p = quant.plan(t, d, f, kernels.sm_count(dev), kind == "bf16")
    xt = "13__nv_bfloat16" if kind == "bf16" else "f"
    report = (ptxas_report(p.body) if p.body == "int8_wgmma_kernel"
              else ptxas_report(p.body, f"ILi{p.tokens}E{xt}E"))
    return {"kernel": p.body, "tokens": p.tokens, "splits": p.splits,
            "registers": report["registers"],
            "spill_bytes": report["spill_bytes"],
            "ptxas_serialized_wgmma": report["ptxas_serialized_wgmma"]}


def _k2_inputs(torch, dev, gen, t, d, f, kind) -> tuple:
    """(x, QuantWeights): enough copies of a random [d, f] weight to
    exceed K2_ROTATE_BYTES between two uses of one."""
    from container_engine_accelerators_tpu_torch.ops.quant import (
        QuantWeight,
        quantize_weights,
    )

    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    x = torch.randn(t, d, generator=gen, device=dev).to(dtype)
    qw = quantize_weights(
        torch.randn(d, f, generator=gen, device=dev) * d ** -0.5)
    copies = -(-K2_ROTATE_BYTES // (d * f))
    return x, [qw] + [QuantWeight(qw.values.clone(), qw.scales.clone())
                      for _ in range(copies - 1)]


def _rotating(fn, items):
    """A call of fn on the next of `items` each time."""
    state = {"i": 0}

    def call():
        item = items[state["i"] % len(items)]
        state["i"] += 1
        return fn(item)
    return call


def k2_times(torch, dev, x, qws) -> dict:
    """K2's device ms and torch.matmul's on the dequantized weight (the
    library call, x's dtype), each over rotating cold copies."""
    from container_engine_accelerators_tpu_torch.ops.quant import (
        dequantize,
        int8_matmul_cuda,
    )

    ms = device_ms(torch, _rotating(lambda qw: int8_matmul_cuda(x, qw), qws))
    deq = [dequantize(qw, x.dtype) for qw in qws]
    library_ms = device_ms(torch, _rotating(lambda w: torch.matmul(x, w),
                                            deq))
    del deq
    return {"ms": ms, "library_ms": library_ms}


def k2_phase(torch, dev) -> dict:
    from container_engine_accelerators_tpu_torch.ops.quant import (
        int8_matmul_cuda,
        int8_matmul_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    results = {}
    for name, t, d, f, kind in K2_CASES:
        x, qws = _k2_inputs(torch, dev, gen, t, d, f, kind)
        qw = qws[0]
        got = int8_matmul_cuda(x, qw)
        torch.cuda.synchronize()
        want = int8_matmul_plain(x, qw)
        err = (got.float() - want.float()).abs().max().item()
        tol = K2_TOL[kind] * want.float().abs().max().item()
        require(err <= tol, f"K2 {name}: max|diff| {err} > {tol}")
        again = int8_matmul_cuda(x, qw)
        require(torch.equal(got, again), f"K2 {name}: bits changed")
        del got, want, again
        info = k2_kernel_info(dev, t, d, f, kind)
        require(info["spill_bytes"] == 0, f"K2 {name} spills: {info}")
        times = k2_times(torch, dev, x, qws)
        plain_ms = device_ms(torch, lambda: int8_matmul_plain(x, qw),
                             iters=5)
        item = x.element_size()
        n_bytes = t * d * item + d * f + 4 * f + t * f * item
        # One product at the bf16 tensor-core rate, f32 x too: the kernel
        # runs f32 x as two bf16 products (its own floor is twice this).
        bms, by = bound_ms(n_bytes, 2 * t * d * f, "bf16")
        results[name] = {"max_abs_err": err, **times, "plain_ms": plain_ms,
                         "bound_ms": bms, "bound_by": by}
        emit({"phase": f"k2_{name}", "T": t, "D": d, "F": f,
              "x_dtype": kind, "tol": tol, **results[name],
              "share_of_bound": bms / times["ms"],
              "over_library": times["ms"] / times["library_ms"], **info})
        del x, qws, qw
    return results


# ---------------------------------------------------------------- K3

K3_SHAPE = (32, 8, 128, 128, 16)  # Hq, Hkv, D, page, max_pages
K3_CASES = [                      # (name, T, cache lengths)
    ("decode", 1, [0, 1, 127, 128, 129, 2047, 1000, 513]),
    ("decode_tick", 1, TICK_LENGTHS),
    ("prefill_chunk_512", 512, [512]),
    ("prefix_suffix_128", 128, [256]),
    ("verify_k4", 5, VERIFY_LENGTHS),
]


def _page_pool(torch, dev, gen, lens, t, page, max_pages, hkv, d):
    """(k_pool, v_pool, tables): each slot's live pages at permuted pool
    rows, and table entries past them 0 or out-of-range garbage."""
    live_pages = [-(-(n + t) // page) for n in lens]
    n_pages = sum(live_pages) + 8
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = torch.randint(-3, n_pages + 3, (len(lens), max_pages),
                           generator=gen, device=dev, dtype=torch.int32)
    tables[:, ::2] = 0
    used = 0
    for i, n in enumerate(live_pages):
        tables[i, :n] = perm[used:used + n].int()
        used += n
    shape = (n_pages, page, hkv, d)
    k_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    return k_pool, v_pool, tables


def _k3_args(torch, dev, gen, t: int, lens: list, mode: str) -> tuple:
    """paged_decode_attention_cuda's arguments in a k3_* case."""
    hq, hkv, d, page, max_pages = K3_SHAPE
    k_pool, v_pool, tables = _page_pool(torch, dev, gen, lens, t, page,
                                        max_pages, hkv, d)
    q = torch.randn(len(lens), t, hq, d, generator=gen,
                    device=dev).bfloat16()
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    if mode == "bf16":
        return q, k_pool, v_pool, lens_t, tables
    (kp, ksp), (vp, vsp) = (_quantized(torch, x.float(), mode)
                            for x in (k_pool, v_pool))
    return q, kp, vp, lens_t, tables, ksp, vsp, mode == "int4"


def k3_phase(torch, dev) -> dict:
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        paged_decode_attention_cuda,
        paged_decode_attention_plain,
    )

    hq, hkv, d, page, max_pages = K3_SHAPE
    max_len = page * max_pages
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    results = {}
    for name, t, lens in K3_CASES:
        b = len(lens)
        q, k_pool, v_pool, lens_t, tables = _k3_args(torch, dev, gen, t,
                                                     lens, "bf16")
        got = paged_decode_attention_cuda(q, k_pool, v_pool, lens_t, tables)
        torch.cuda.synchronize()
        want = paged_decode_attention_plain(q, k_pool, v_pool, lens_t,
                                            tables)
        err, rel = _row_errors(got, want, d, f"K3 {name}")
        # The same keys in a contiguous cache: K1 there shows what the
        # paging costs, and SDPA there is the library yardstick (no one
        # PyTorch call computes paged attention).
        rows = tables.long().clamp(0, k_pool.shape[0] - 1)
        k = k_pool[rows].reshape(b, max_len, hkv, d).contiguous()
        v = v_pool[rows].reshape(b, max_len, hkv, d).contiguous()
        n_bytes, flops, mask = _attention_work(torch, lens_t.long(), t,
                                               max_len, b, hq, hkv, d)
        n_bytes += tables.numel() * 4 + lens_t.numel() * 4
        ms = device_ms(torch, lambda: paged_decode_attention_cuda(
            q, k_pool, v_pool, lens_t, tables))
        plain_ms = device_ms(torch, lambda: paged_decode_attention_plain(
            q, k_pool, v_pool, lens_t, tables), iters=5)
        k1_ms = device_ms(torch, lambda: decode_attention_cuda(q, k, v,
                                                               lens_t))
        library_ms = device_ms(torch, _sdpa(F, q, k, v, mask), iters=5)
        bms, by = bound_ms(n_bytes, flops, "bf16")
        results[name] = {"max_abs_err": err, "max_row_rel_err": rel,
                         "ms": ms, "plain_ms": plain_ms,
                         "k1_contiguous_ms": k1_ms,
                         "library_ms": library_ms,
                         "library": "SDPA on a contiguous copy",
                         "bound_ms": bms, "bound_by": by}
        if name.startswith("verify"):
            results[name]["decode_steps_ms"] = device_ms(
                torch, _decode_steps(paged_decode_attention_cuda, q,
                                     (k_pool, v_pool), lens_t, (tables,)))
        emit({"phase": f"k3_{name}", "T": t, "slots": b, "Hq": hq,
              "Hkv": hkv, "D": d, "page": page, "max_pages": max_pages,
              "n_pages": k_pool.shape[0], "lengths": lens,
              "row_rtol": K1_ROW_RTOL, "row_atol": K1_ROW_ATOL,
              **results[name],
              **decode_kernel_info(torch, dev, "Bf16", "Paged", t, b, hq,
                                   hkv, max_len)})
        del q, k, v, k_pool, v_pool, got, want, mask
    return results


# ------------------------------------------------- K1, K3 on int8/int4 KV

def _quantized(torch, x, mode: str):
    """(payload, contiguous head-major scales) of a cache, as the port's
    decode step writes it."""
    from container_engine_accelerators_tpu_torch.ops import quant

    fn = quant.quantize_kv_int4 if mode == "int4" else quant.quantize_kv
    payload, scales = fn(x)
    return payload, scales.contiguous()


def _dequantized(torch, payload, scales, mode: str):
    """The same cache dequantized to bf16 (the inputs of the bf16 kernel
    and of SDPA, for timing)."""
    from container_engine_accelerators_tpu_torch.ops import quant

    fn = quant.dequantize_kv_int4 if mode == "int4" else quant.dequantize_kv
    return fn(payload, scales, torch.bfloat16)


def _quant_case_result(torch, got, want, d, what, kernel, plain, bf16_kernel,
                       library, n_bytes, flops) -> dict:
    err, rel = _row_errors(got, want, d, what)
    bms, by = bound_ms(n_bytes, flops, "bf16")
    return {"max_abs_err": err, "max_row_rel_err": rel,
            "ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, plain, iters=5),
            "bf16_kernel_ms": device_ms(torch, bf16_kernel),
            "library_ms": device_ms(torch, library, iters=5),
            "library": "dequantize to bf16 + SDPA",
            "bound_ms": bms, "bound_by": by}


def k1_quant_phase(torch, dev, mode: str) -> dict:
    """K1's cases on an int8 or int4 cache."""
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
    )

    hq, hkv, d, max_len = K1_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    results = {}
    for name, t, b, lens in K1_CASES:
        args = _k1_args(torch, dev, gen, t, b, lens, mode)
        q, k, v, cache_len, ks, vs, _ = args
        got = decode_attention_cuda(*args)
        torch.cuda.synchronize()
        want = decode_attention_plain(*args)
        lens_b = (torch.as_tensor(lens, device=dev).reshape(-1)
                  .expand(b).long())
        n_bytes, flops, mask = _attention_work(torch, lens_b, t, max_len, b,
                                               hq, hkv, d, mode)
        k_bf = _dequantized(torch, k, ks, mode)
        v_bf = _dequantized(torch, v, vs, mode)
        sdpa = _sdpa(F, q, k_bf, v_bf, mask)
        res = _quant_case_result(
            torch, got, want, d, f"K1 {mode} {name}",
            lambda: decode_attention_cuda(*args),
            lambda: decode_attention_plain(*args),
            lambda: decode_attention_cuda(q, k_bf, v_bf, cache_len),
            lambda: (_dequantized(torch, k, ks, mode),
                     _dequantized(torch, v, vs, mode), sdpa()),
            n_bytes, flops)
        results[name] = res
        emit({"phase": f"k1_{mode}_{name}", "T": t, "B": b, "Hq": hq,
              "Hkv": hkv, "D": d, "max_len": max_len, "lengths": lens,
              "row_rtol": K1_ROW_RTOL, "row_atol": K1_ROW_ATOL, **res,
              **decode_kernel_info(torch, dev, mode.capitalize(),
                                   "Contiguous", t, b, hq, hkv, max_len)})
        del q, k, v, ks, vs, k_bf, v_bf, got, want, mask, sdpa, args
    return results


def k3_quant_phase(torch, dev, mode: str) -> dict:
    """K3's cases on an int8 or int4 page pool (the k3_* pools,
    quantized); the library yardstick runs on a contiguous copy."""
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.ops.decode_attention import (
        paged_decode_attention_cuda,
        paged_decode_attention_plain,
    )

    hq, hkv, d, page, max_pages = K3_SHAPE
    max_len = page * max_pages
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    results = {}
    for name, t, lens in K3_CASES:
        b = len(lens)
        args = _k3_args(torch, dev, gen, t, lens, mode)
        q, kp, vp, lens_t, tables, ksp, vsp, _ = args
        got = paged_decode_attention_cuda(*args)
        torch.cuda.synchronize()
        want = paged_decode_attention_plain(*args)
        kp_bf = _dequantized(torch, kp, ksp, mode)
        vp_bf = _dequantized(torch, vp, vsp, mode)
        rows = tables.long().clamp(0, kp.shape[0] - 1)
        k = kp[rows].reshape(b, max_len, hkv, -1).contiguous()
        v = vp[rows].reshape(b, max_len, hkv, -1).contiguous()
        ks = ksp[rows].transpose(1, 2).reshape(b, hkv, max_len).contiguous()
        vs = vsp[rows].transpose(1, 2).reshape(b, hkv, max_len).contiguous()
        n_bytes, flops, mask = _attention_work(torch, lens_t.long(), t,
                                               max_len, b, hq, hkv, d, mode)
        n_bytes += tables.numel() * 4 + lens_t.numel() * 4
        sdpa = _sdpa(F, q, _dequantized(torch, k, ks, mode),
                     _dequantized(torch, v, vs, mode), mask)
        res = _quant_case_result(
            torch, got, want, d, f"K3 {mode} {name}",
            lambda: paged_decode_attention_cuda(*args),
            lambda: paged_decode_attention_plain(*args),
            lambda: paged_decode_attention_cuda(q, kp_bf, vp_bf, lens_t,
                                                tables),
            lambda: (_dequantized(torch, k, ks, mode),
                     _dequantized(torch, v, vs, mode), sdpa()),
            n_bytes, flops)
        res["library"] = "dequantize to bf16 + SDPA, on a contiguous copy"
        results[name] = res
        emit({"phase": f"k3_{mode}_{name}", "T": t, "slots": b, "Hq": hq,
              "Hkv": hkv, "D": d, "page": page, "max_pages": max_pages,
              "n_pages": kp.shape[0], "lengths": lens,
              "row_rtol": K1_ROW_RTOL, "row_atol": K1_ROW_ATOL, **res,
              **decode_kernel_info(torch, dev, mode.capitalize(), "Paged", t,
                                   b, hq, hkv, max_len)})
        del q, kp, vp, ksp, vsp, kp_bf, vp_bf, k, v, ks, vs, got, want
        del mask, sdpa, args
    return results


# ---------------------------------------------------------------- serve

def _post(url: str, body: dict) -> tuple[dict | list, float, float]:
    """(answer, sent, done): the JSON answer, or a stream's events, and
    the monotonic clock when the request went out and when its answer
    was in. The server runs in this process, so its events' `ts` are on
    the same clock."""
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode())
    sent = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as resp:
        text = resp.read().decode()
    done = time.monotonic()
    if body.get("stream"):
        events = [json.loads(line[len("data: "):])
                  for line in text.split("\n\n") if line]
        return events, sent, done
    return json.loads(text), sent, done


def _check_answer(tokens: list, prompt: list, n_new: int, vocab: int,
                  what: str) -> None:
    require(len(tokens) == len(prompt) + n_new,
            f"{what}: {len(tokens)} tokens, want {len(prompt) + n_new}")
    require(tokens[:len(prompt)] == prompt, f"{what}: prompt not echoed")
    require(all(0 <= tok < vocab for tok in tokens[len(prompt):]),
            f"{what}: token outside the vocabulary")


def _answer_tokens(req: dict, ans) -> list:
    """The tokens of one answer; a stream's token events must be its
    done tokens."""
    if req.get("stream"):
        require("done" in ans[-1], f"stream did not finish: {ans[-1]}")
        toks = ans[-1]["tokens"]
        require([e["token"] for e in ans[:-1]]
                == toks[len(req["tokens"]):], "stream tokens")
        return toks
    require("tokens" in ans, f"request failed: {ans}")
    return ans["tokens"]


def _check_burst(requests: list, answers: list, vocab: int,
                 what: str) -> int:
    """Check every answer of a burst; returns the tokens generated."""
    generated = 0
    for req, (ans, _, _) in zip(requests, answers):
        _check_answer(_answer_tokens(req, ans), req["tokens"],
                      req["max_new_tokens"], vocab, what)
        generated += req["max_new_tokens"]
    return generated


def _stream_ttft_s(requests: list, answers: list) -> list:
    """Per streamed request: its first token event's `ts` minus the time
    it was sent (one monotonic clock, the server is in-process)."""
    return [ans[0]["ts"] - sent
            for req, (ans, sent, _) in zip(requests, answers)
            if req.get("stream")]


def _time_generate(torch, generate, model, prompt, cfg, n_new) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(model, prompt, cfg, n_new)
    torch.cuda.synchronize()
    del out
    return time.perf_counter() - t0


def step_times_ms(torch, generate, model, prompt, cfg) -> tuple[float, float]:
    """(prefill ms, decode ms per step): the time of generate with one
    new token (the prefill and its pick), and (time with 33 new tokens -
    with 1) / 32."""
    _time_generate(torch, generate, model, prompt, cfg, 2)   # warm
    short = _time_generate(torch, generate, model, prompt, cfg, 1)
    long = _time_generate(torch, generate, model, prompt, cfg, 33)
    return short * 1e3, (long - short) / 32 * 1e3


def profile_steps(torch, step, steps: int = 4, top: int = 6,
                  cpu: bool = True) -> dict:
    """Device time of `steps` calls of step() by kernel, from
    torch.profiler: the busy time per step, the `top` kernels that take
    most of it, and the device-side spans of record_function ranges
    (the optimizer's step, for one), which cover kernels counted on
    their own and so are kept out of the busy time. None where the
    profiler saw no device activity. `cpu=False` traces the card alone
    (no spans): a long run's host events make the trace slow to read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    spans = [e for e in device if getattr(e, "is_user_annotation", False)]
    kernels = {}
    for e in device:
        if e not in spans:
            kernels[e.key] = (kernels.get(e.key, 0.0)
                              + e.self_device_time_total / steps / 1e3)
    if not sum(kernels.values()):
        return {"busy_ms_per_step": None, "top": None, "spans": None,
                "span_kernels": None, "kernels": None}
    # Names cut to 60 characters, summed: many kernels share a prefix.
    short: dict = {}
    for name, ms in kernels.items():
        short[name[:60]] = short.get(name[:60], 0.0) + ms
    return {"busy_ms_per_step": sum(kernels.values()),
            "top": dict(sorted(short.items(), key=lambda kv: -kv[1])[:top]),
            "spans": {e.key[:60]: e.device_time_total / steps / 1e3
                      for e in spans},
            # A span's device time runs from its first kernel's start to
            # its last's end, gaps included; the host side of the same
            # range sums the kernels launched inside it.
            "span_kernels": {e.key[:60]: e.device_time_total / steps / 1e3
                             for e in prof.key_averages()
                             if e.device_type == DeviceType.CPU
                             and e.key in {s.key for s in spans}},
            "kernels": kernels}


def profile_decode(torch, dev, decode, model, cfg, batch,
                   steps: int = 4) -> dict:
    """profile_steps over decode steps of the contiguous cache at the
    batch's prompt length."""
    cache = decode.init_cache(cfg, batch.shape[0], batch.shape[1] + steps + 1,
                              dev)
    logits, cache = decode.decode_step(model, cache, batch, cfg)
    tok = logits[:, -1].argmax(dim=-1)

    def step():
        nonlocal cache, tok
        logits, cache = decode.decode_step(model, cache, tok[:, None], cfg)
        tok = logits[:, -1].argmax(dim=-1)

    return profile_steps(torch, step, steps)


@contextlib.contextmanager
def serving(engine):
    """make_server(engine) on an ephemeral port, in a thread; yields its
    URL. On exit the server and the engine stop, and their threads are
    joined."""
    from container_engine_accelerators_tpu_torch.cli.serve import (
        make_server,
    )

    srv = make_server(engine, 0)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    try:
        yield f"http://localhost:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
        engine.thread.join(timeout=60)
        server_thread.join(timeout=60)
    require(not engine.thread.is_alive(), "engine worker did not stop")


def burst(url: str, requests: list) -> tuple[list, float, float]:
    """Send all requests at once; (answers, start, end of the last)."""
    t_start = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
        answers = list(pool.map(lambda r: _post(url, r), requests))
    return answers, t_start, max(done for _, _, done in answers)


def healthz(url: str) -> dict:
    with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
        return json.loads(resp.read())


def serve_phase(torch, dev, np) -> tuple[dict, object, object]:
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        BatchingEngine,
    )
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.models.llama import (
        init_params,
        llama3_8b,
    )

    cfg = llama3_8b()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == cfg.num_params(), "8B parameter count")
    rs = np.random.RandomState(SEED)

    def prompt(n):
        return rs.randint(0, cfg.vocab_size, size=n).tolist()

    requests = ([{"tokens": prompt(128), "max_new_tokens": 32}
                 for _ in range(8)]
                + [{"tokens": prompt(512), "max_new_tokens": 16}
                   for _ in range(2)]
                + [{"tokens": prompt(64), "max_new_tokens": 8,
                    "stream": True}])

    engine = BatchingEngine(model, cfg, max_batch=8, window_ms=250.0,
                            engine_core="async")
    with serving(engine) as url:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        answers, t_start, t_end = burst(url, requests)
        # A repeated greedy request answers the same tokens.
        repeat = {"tokens": requests[0]["tokens"], "max_new_tokens": 32}
        again = [_post(url, repeat)[0]["tokens"] for _ in range(2)]
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        health = healthz(url)

    generated = _check_burst(requests, answers, cfg.vocab_size, "serve")
    require(again[0] == again[1], "repeated greedy request changed")
    _check_answer(again[0], repeat["tokens"], 32, cfg.vocab_size, "repeat")
    require(health["requests"] == len(requests) + 2 and
            health["worker_alive"], f"healthz {health}")
    require(launches.get("decode_attention", 0) > 0,
            "serve path launched no decode_attention kernel")

    # Prefill logits: kernel path against the plain path on the card.
    p = torch.tensor([requests[0]["tokens"]], device=dev)
    logits = {}
    for plain in (False, True):
        cache = decode.init_cache(cfg, 1, 160, dev)
        logits[plain], _ = decode.decode_step(model, cache, p, cfg,
                                              plain=plain)
    diff = (logits[False] - logits[True]).abs().max().item()
    scale = logits[True].abs().max().item()
    require(diff <= LOGITS_RTOL * scale,
            f"prefill logits kernel vs plain {diff} > {LOGITS_RTOL} * {scale}")
    # Random weights leave near-ties at the top of a 128k vocabulary: a
    # first-token margin below `diff` lets the two paths pick apart.
    top2 = logits[True][0, -1].topk(2).values
    margin = (top2[0] - top2[1]).item()
    del logits
    kern = decode.generate(model, p, cfg, 16)
    plain_out = decode.generate(model, p, cfg, 16, plain=True)
    match = int((kern[0, 128:] == plain_out[0, 128:]).sum().item())

    batch = torch.tensor([r["tokens"] for r in requests[:8]], device=dev)
    prefill_ms, step_ms = step_times_ms(torch, decode.generate, model, batch,
                                        cfg)
    profile = profile_decode(torch, dev, decode, model, cfg, batch)
    result = {
        "phase": "serve", "model": "llama3_8b", "n_layers": cfg.n_layers,
        "params": n_params, "init_s": init_s,
        "requests": len(requests), "batches": health["batches"],
        "time_to_first_batch_s": min(d for _, _, d in answers) - t_start,
        "burst_s": t_end - t_start,
        "generated_tokens_per_s": generated / (t_end - t_start),
        "prefill_ms_b8_t128": prefill_ms,
        "decode_ms_per_step_b8": step_ms,
        "device_busy_ms_per_step_b8": profile["busy_ms_per_step"],
        "device_idle_share": (None if profile["busy_ms_per_step"] is None
                              else 1 - profile["busy_ms_per_step"] / step_ms),
        "top_kernels_ms_per_step": profile["top"],
        "max_memory_allocated_bytes": peak,
        "launches": launches,
        "prefill_logits_max_abs_diff": diff, "prefill_logits_max_abs": scale,
        "logits_rtol": LOGITS_RTOL,
        "greedy_tokens_matching_plain": f"{match}/16",
        "plain_first_token_top2_margin": margin,
    }
    emit(result)
    return result, model, cfg


# K2's kernels as torch.profiler names them: this checkout's two bodies
# and an older checkout's int8_matmul_partial/_finish.
K2_KERNELS = ("int8_mma_kernel", "int8_wgmma_kernel", "int8_matmul")


def k2_ms(profile: dict) -> float | None:
    """The device ms of K2's kernels in a profile_steps result."""
    if profile["kernels"] is None:
        return None
    return sum(ms for name, ms in profile["kernels"].items()
               if any(k in name for k in K2_KERNELS))


def model_step_profile(torch, dev, decode, model, cfg, batch) -> dict:
    """torch.profiler over a prefill of `batch` from an empty cache
    (decode_step) and over decode steps after it (profile_decode): the
    device-busy ms of each, their top kernels, and K2's ms of each."""
    cache = decode.init_cache(cfg, batch.shape[0], batch.shape[1], dev)

    def prefill():
        decode.decode_step(model, cache, batch, cfg)

    prefill()
    pre = profile_steps(torch, prefill, steps=2)
    dec = profile_decode(torch, dev, decode, model, cfg, batch)
    return {"prefill_device_busy_ms": pre["busy_ms_per_step"],
            "prefill_k2_ms": k2_ms(pre),
            "prefill_top_kernels_ms": pre["top"],
            "decode_device_busy_ms_per_step": dec["busy_ms_per_step"],
            "decode_k2_ms_per_step": k2_ms(dec),
            "decode_top_kernels_ms_per_step": dec["top"]}


def int8_timing(torch, dev, model, qmodel, cfg, batch) -> dict:
    """The bf16 weights and their int8 copy on the same batch: prefill
    and decode-step wall ms (generate), and model_step_profile's
    device-busy ms and top kernels of each."""
    from container_engine_accelerators_tpu_torch.models import decode

    res = {}
    for name, m in (("bf16", model), ("int8", qmodel)):
        prefill_ms, step_ms = step_times_ms(torch, decode.generate, m, batch,
                                            cfg)
        res[name] = {"prefill_ms_b8_t128": prefill_ms,
                     "decode_ms_per_step_b8": step_ms,
                     **model_step_profile(torch, dev, decode, m, cfg, batch)}
    res["int8_prefill_over_bf16"] = (res["int8"]["prefill_ms_b8_t128"]
                                     / res["bf16"]["prefill_ms_b8_t128"])
    return res


def _int8_batch(torch, dev, np, cfg):
    rs = np.random.RandomState(SEED + 2)
    return torch.tensor(rs.randint(0, cfg.vocab_size, size=(8, 128)),
                        device=dev)


def int8_phase(torch, dev, np, model, cfg) -> dict:
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.ops.quant import (
        quantize_llama_params,
    )

    qmodel = quantize_llama_params(model)
    batch = _int8_batch(torch, dev, np, cfg)
    kernels.reset_launches()
    out = decode.generate(qmodel, batch, cfg, 16)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    require(out.shape == (8, 144), f"int8 generate shape {out.shape}")
    require(torch.equal(out[:, :128], batch), "int8 prompt not echoed")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            "int8 token outside the vocabulary")
    for name in ("decode_attention", "int8_matmul"):
        require(launches.get(name, 0) > 0, f"int8 path launched no {name}")

    cache = decode.init_cache(cfg, 1, 128, dev)
    kern, _ = decode.decode_step(qmodel, cache, batch[:1], cfg)
    cache = decode.init_cache(cfg, 1, 128, dev)
    plain, _ = decode.decode_step(qmodel, cache, batch[:1], cfg, plain=True)
    diff = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    require(diff <= LOGITS_RTOL * scale,
            f"int8 prefill logits kernel vs plain {diff} > "
            f"{LOGITS_RTOL} * {scale}")
    del kern, plain
    timing = int8_timing(torch, dev, model, qmodel, cfg, batch)
    result = {"phase": "int8", "model": "llama3_8b", "batch": 8,
              "prompt": 128, "new_tokens": 16, "launches": launches,
              "prefill_logits_max_abs_diff": diff,
              "prefill_logits_max_abs": scale,
              "prefill_ms_b8_t128": timing["int8"]["prefill_ms_b8_t128"],
              "decode_ms_per_step_b8":
                  timing["int8"]["decode_ms_per_step_b8"],
              **timing}
    emit(result)
    return result


# ---------------------------------------------------------------- engines

def _prompts(np, cfg, seed):
    rs = np.random.RandomState(seed)
    return lambda n: rs.randint(0, cfg.vocab_size, size=n).tolist()


def paged_tick(torch, dev, np, model, cfg, ticks: int = 16) -> dict:
    """The paged decode tick at 8 active slots (page 128, the default
    pool of 65 pages): each slot prefilled with 128 tokens, then ticks
    of decode_step_paged + argmax. Wall ms per tick, device-synchronised
    around `ticks` ticks, the kernel launches per tick, and the
    torch.profiler breakdown of 4 more."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models import decode

    slots, page, max_pages, n_pages = 8, 128, 16, 65
    cache = decode.init_paged_cache(cfg, slots, n_pages, page, max_pages,
                                    dev)
    prompt = _prompts(np, cfg, SEED + 5)
    for s in range(slots):
        rows = [1 + 2 * s, 2 + 2 * s] + [0] * (max_pages - 2)
        decode.set_slot_pages(cache, s, torch.tensor(rows, dtype=torch.int32,
                                                     device=dev), 0)
        _, cache = decode.prefill_suffix_paged(
            model, cache, s, torch.tensor(prompt(128), device=dev), 128, cfg)
    active = torch.ones(slots, dtype=torch.bool, device=dev)
    tok = torch.zeros(slots, dtype=torch.long, device=dev)

    def tick():
        nonlocal cache, tok
        logits, cache = decode.decode_step_paged(model, cache, tok, active,
                                                 cfg)
        tok = logits.argmax(dim=-1)

    for _ in range(4):
        tick()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(ticks):
        tick()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / ticks * 1e3
    per_tick = {name: n / ticks for name, n in kernels.launches.items()}
    profile = profile_steps(torch, tick)
    busy = profile["busy_ms_per_step"]
    return {"paged_decode_tick_ms_8_slots": tick_ms,
            "launches_per_tick": per_tick,
            "tick_cache_lengths": [128 + 4, 128 + 4 + ticks + 4],
            "device_busy_ms_per_tick": busy,
            "device_idle_share": None if busy is None else 1 - busy / tick_ms,
            "top_kernels_ms_per_tick": profile["top"],
            "span_kernels_ms_per_tick": profile["span_kernels"]}


def _paged_requests(np, cfg) -> tuple[dict, list, list]:
    """(warm-up, prefix hits, burst) of the paged phase: the warm-up
    leaves a 256-token prefix in the prefix cache, the burst holds 8
    short requests, 3 that share the prefix, 2 streamed and, last (so
    the slots they join are decoding), 2 of 1024 tokens."""
    prompt = _prompts(np, cfg, SEED + 3)
    prefix = prompt(256)
    warm = {"tokens": prefix + prompt(128), "max_new_tokens": 16}
    hits = [{"tokens": prefix + prompt(128), "max_new_tokens": 16}
            for _ in range(3)]
    requests = ([{"tokens": prompt(128), "max_new_tokens": 32}
                 for _ in range(8)] + hits
                + [{"tokens": prompt(64), "max_new_tokens": 16,
                    "stream": True} for _ in range(2)]
                + [{"tokens": prompt(1024), "max_new_tokens": 16}
                   for _ in range(2)])
    return warm, hits, requests


def paged_engine(model, cfg):
    """The paged phase's engine: 8 slots, max_len 2048, page 128, the
    default pool of 65 pages, prefix cap 256, chunk 512."""
    from container_engine_accelerators_tpu_torch.cli.serve import (
        PagedContinuousEngine,
    )

    return PagedContinuousEngine(model, cfg, max_slots=8, max_len=2048,
                                 page=128, prefix_cap=256, prefill_chunk=512,
                                 engine_core="async")


def paged_burst(torch, np, engine, cfg, what: str) -> tuple[dict, list]:
    """The paged phase's warm-up and burst behind make_server on
    `engine`: answers checked, no page leaked. (result, burst answers)."""
    from container_engine_accelerators_tpu_torch import kernels

    warm, _, requests = _paged_requests(np, cfg)
    with serving(engine) as url:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        first = _post(url, warm)
        answers, t_start, t_end = burst(url, requests)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        health = healthz(url)
    _check_answer(_answer_tokens(warm, first[0]), warm["tokens"], 16,
                  cfg.vocab_size, f"{what} warm-up")
    generated = _check_burst(requests, answers, cfg.vocab_size, what)
    require(health["requests"] == 1 + len(requests) and
            health["worker_alive"], f"{what}: healthz {health}")
    require(engine.pages_in_use == engine.prefix_index.pages_held(),
            f"{what}: leaked pages: {engine.pages_in_use} in use, "
            f"{engine.prefix_index.pages_held()} held by the prefix index")
    return {"model": "llama3_8b", "max_slots": 8, "max_len": 2048,
            "page": 128, "pool_pages": engine.pool_pages,
            "prefill_chunk": 512, "requests": 1 + len(requests),
            "burst_requests": len(requests), "burst_s": t_end - t_start,
            "generated_tokens_per_s": generated / (t_end - t_start),
            "stream_ttft_s": _stream_ttft_s(requests, answers),
            "decode_steps": health["batches"],
            "no_page_leaked": True,
            "max_memory_allocated_bytes": peak,
            "launches": launches}, answers


def paged_phase(torch, dev, np, model, cfg) -> dict:
    from container_engine_accelerators_tpu_torch.models import decode

    _, hits, _ = _paged_requests(np, cfg)
    engine = paged_engine(model, cfg)
    # Every prefill chunk as (request id, start, new_len, steps_run).
    chunks = []
    run_chunk = engine._run_chunk

    def logged_chunk(slot, tokens, start, new_len):
        chunks.append((engine._slots[slot]["rid"], start, new_len,
                       engine.steps_run))
        return run_chunk(slot, tokens, start, new_len)

    engine._run_chunk = logged_chunk
    served, answers = paged_burst(torch, np, engine, cfg, "paged")
    require(engine.prefix_pages_reused >= 6,
            f"prefix pages reused {engine.prefix_pages_reused} < 6")
    require([c[3] for c in chunks] == engine.prefill_chunk_trace,
            "chunk log disagrees with prefill_chunk_trace")
    by_rid: dict = {}
    for rid, start, new_len, steps in chunks:
        by_rid.setdefault(rid, []).append((start, new_len, steps))
    split = [c for c in by_rid.values() if len(c) > 1]
    require(len(split) == 2 and all(
        [c[:2] for c in cs] == [(0, 512), (512, 1024)] and cs[1][2] > cs[0][2]
        for cs in split),
        f"1024-token prompts: want two chunks with decode steps between, "
        f"got {split}")
    require(served["launches"].get("paged_decode_attention", 0) > 0,
            "paged path launched no paged_decode_attention kernel")
    # Not gated: with random 8B weights, near-ties let bf16 paths part.
    matches = []
    for req, (ans, _, _) in zip(hits, answers[8:11]):
        n = len(req["tokens"])
        ref = decode.generate(model, torch.tensor([req["tokens"]],
                                                  device=dev), cfg, 16)
        matches.append(sum(a == b for a, b in
                           zip(ans["tokens"][n:], ref[0, n:].tolist())))
    counters = {name: getattr(engine, name) for name in (
        "prefix_pages_reused", "prefills_run", "prefill_chunks_run",
        "prefill_tokens_run", "preemptions")}
    del engine, chunks
    result = {
        "phase": "paged", **served, **counters,
        "long_prompt_chunks": split,
        "prefix_hit_tokens_matching_generate": [f"{m}/16" for m in matches],
        **paged_tick(torch, dev, np, model, cfg),
    }
    emit(result)
    return result


def preempt_run(torch, np, model, cfg, pool_pages: int) -> dict:
    """paged_preempt's load, 3 slots and 3 x 200 / 250 tokens, on a pool
    of `pool_pages` pages (the trash row included): answers checked, no
    page leaked, and the preemptions it took."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        PagedContinuousEngine,
    )

    prompt = _prompts(np, cfg, SEED + 6)
    n_new = 250
    prompts = [prompt(200) for _ in range(3)]
    engine = PagedContinuousEngine(model, cfg, max_slots=3, max_len=2048,
                                   page=128, pool_pages=pool_pages,
                                   prefill_chunk=512, engine_core="async")
    try:
        kernels.reset_launches()
        t0 = time.monotonic()
        futs = [engine.submit(p, n_new, 0.0) for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        seconds = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
    finally:
        engine.stop()
        engine.thread.join(timeout=60)
    require(not engine.thread.is_alive(), "engine worker did not stop")
    for p, out in zip(prompts, outs):
        _check_answer(out, p, n_new, cfg.vocab_size, "paged_preempt")
    require(engine.requests_served == 3, "not every request finished")
    require(engine.pages_in_use == engine.prefix_index.pages_held(),
            "leaked pages after preemption")
    return {"max_slots": 3, "pool_pages": pool_pages, "prompt": 200,
            "new_tokens": n_new, "preemptions": engine.preemptions,
            "prefills_run": engine.prefills_run, "seconds": seconds,
            "generated_tokens_per_s": 3 * n_new / seconds,
            "launches": launches}


def paged_preempt_phase(torch, dev, np, model, cfg) -> dict:
    # 8 usable pages; each request grows to 450 tokens, 4 pages: 12.
    result = {"phase": "paged_preempt",
              **preempt_run(torch, np, model, cfg, PREEMPT_POOL_PAGES["bf16"])}
    require(result["preemptions"] > 0, "no request was preempted")
    require(result["launches"].get("paged_decode_attention", 0) > 0,
            "preempt path launched no paged_decode_attention kernel")
    emit(result)
    return result


def continuous_burst(torch, np, model, cfg) -> dict:
    """ContinuousEngine (8 slots, max_len 2048, chunk 512) behind
    make_server on 8 x 128 / 32 and 2 streamed 64 / 16: answers checked."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        ContinuousEngine,
    )

    prompt = _prompts(np, cfg, SEED + 7)
    requests = ([{"tokens": prompt(128), "max_new_tokens": 32}
                 for _ in range(8)]
                + [{"tokens": prompt(64), "max_new_tokens": 16,
                    "stream": True} for _ in range(2)])
    engine = ContinuousEngine(model, cfg, max_slots=8, max_len=2048,
                              prefill_chunk=512, engine_core="async")
    with serving(engine) as url:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        answers, t_start, t_end = burst(url, requests)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        health = healthz(url)
    generated = _check_burst(requests, answers, cfg.vocab_size,
                             "continuous")
    require(health["requests"] == len(requests) and health["worker_alive"],
            f"healthz {health}")
    return {"model": "llama3_8b", "max_slots": 8, "max_len": 2048,
            "requests": len(requests), "burst_s": t_end - t_start,
            "generated_tokens_per_s": generated / (t_end - t_start),
            "stream_ttft_s": _stream_ttft_s(requests, answers),
            "decode_steps": health["batches"],
            "max_memory_allocated_bytes": peak, "launches": launches}


def continuous_phase(torch, dev, np, model, cfg) -> dict:
    result = {"phase": "continuous",
              **continuous_burst(torch, np, model, cfg)}
    require(result["launches"].get("decode_attention", 0) > 0,
            "continuous path launched no decode_attention kernel")
    emit(result)
    return result


def _cache_bytes_per_token(torch, dev, cfg) -> float:
    """Bytes of the tensors init_paged_cache allocates in cfg's layout,
    over the tokens they hold."""
    from container_engine_accelerators_tpu_torch.models import decode

    n_pages, page = 2, 128
    cache = decode.init_paged_cache(cfg, 1, n_pages, page, 1, dev)
    tensors = (cache.k_pool, cache.v_pool, cache.k_scales, cache.v_scales)
    return sum(x.numel() * x.element_size() for x in tensors
               if x is not None) / (n_pages * page)


def _quant_logits(torch, dev, np, model, cfgs) -> dict:
    """Per mode: one decode step after a 128-token prefill, on the kernel
    path and on the plain path over two copies of the same quantized
    cache (held within LOGITS_RTOL); and the prefill logits' drift from
    the bf16 cache's (reported, not held: random weights set no
    contract)."""
    import dataclasses

    from container_engine_accelerators_tpu_torch.models import decode

    rs = np.random.RandomState(SEED + 12)
    prompt = torch.tensor(
        [rs.randint(0, cfgs["bf16"].vocab_size, size=128).tolist()],
        device=dev)
    prefill, out = {}, {}
    for mode, cfg in cfgs.items():
        cache = decode.init_cache(cfg, 1, 160, dev)
        prefill[mode], cache = decode.decode_step(model, cache, prompt, cfg)
        if mode == "bf16":
            continue
        twin = dataclasses.replace(
            cache, **{name: getattr(cache, name).clone()
                      for name in ("k", "v", "k_scales", "v_scales")})
        tok = prefill[mode][:, -1:].argmax(-1)
        kern, _ = decode.decode_step(model, cache, tok, cfg)
        plain, _ = decode.decode_step(model, twin, tok, cfg, plain=True)
        diff = (kern - plain).abs().max().item()
        scale = plain.abs().max().item()
        require(diff <= LOGITS_RTOL * scale,
                f"kv_quant {mode}: decode logits kernel vs plain {diff} > "
                f"{LOGITS_RTOL} * {scale}")
        ref = prefill["bf16"]
        out[mode] = {
            "decode_logits_max_abs_diff_kernel_vs_plain": diff,
            "decode_logits_max_abs": scale,
            "prefill_logits_max_abs_diff_vs_bf16":
                (prefill[mode] - ref).abs().max().item(),
            "prefill_logits_rel_mse_vs_bf16":
                ((prefill[mode] - ref) ** 2).mean().item()
                / (ref ** 2).mean().item(),
            "last_token_argmax_equals_bf16": bool(
                prefill[mode][0, -1].argmax() == ref[0, -1].argmax())}
        del cache, twin, kern, plain
    return out


def kv_quant_phase(torch, dev, np, model, cfg, preempt_bf16) -> dict:
    """The serving engines on int8 and int4 KV caches (see the module
    docstring). Main-path launches: the paged bursts, the preemption
    runs and the continuous bursts."""
    import dataclasses

    cfgs = {mode: dataclasses.replace(cfg, kv_cache_dtype=mode)
            for mode in ("bf16",) + KV_MODES}
    per_token = {mode: _cache_bytes_per_token(torch, dev, c)
                 for mode, c in cfgs.items()}
    require(per_token == KV_BYTES_PER_TOKEN,
            f"cache bytes per token {per_token}, want {KV_BYTES_PER_TOKEN}")
    pool_bytes = {mode: PREEMPT_POOL_PAGES[mode] * 128 * per_token[mode]
                  for mode in cfgs}
    result = {"phase": "kv_quant", "model": "llama3_8b",
              "cache_bytes_per_token": per_token,
              "preempt_pool_pages": PREEMPT_POOL_PAGES,
              "preempt_pool_bytes": pool_bytes,
              "logits": _quant_logits(torch, dev, np, model, cfgs)}
    launches: dict = {}
    preemptions = {"bf16": preempt_bf16["preemptions"]}
    for mode in KV_MODES:
        c = cfgs[mode]
        require(pool_bytes[mode] <= pool_bytes["bf16"],
                f"{mode} pool larger than bf16's")
        paged, _ = paged_burst(torch, np, paged_engine(model, c), c,
                               f"kv_quant {mode} paged")
        tick = paged_tick(torch, dev, np, model, c)
        per_tick = tick["launches_per_tick"].get(
            f"paged_decode_attention_{mode}")
        require(per_tick == c.n_layers,
                f"{mode} paged tick: {per_tick} K3 launches, want "
                f"{c.n_layers}")
        preempt = preempt_run(torch, np, model, c, PREEMPT_POOL_PAGES[mode])
        preemptions[mode] = preempt["preemptions"]
        cont = continuous_burst(torch, np, model, c)
        for run, name in ((paged, f"paged_decode_attention_{mode}"),
                          (preempt, f"paged_decode_attention_{mode}"),
                          (cont, f"decode_attention_{mode}")):
            require(run["launches"].get(name, 0) > 0,
                    f"kv_quant {mode}: a run launched no {name}")
            for key, n in run["launches"].items():
                launches[key] = launches.get(key, 0) + n
        result[mode] = {"paged": {**paged, **tick}, "preempt": preempt,
                        "continuous": cont}
    result["preemptions_same_pool_bytes"] = preemptions
    result["launches"] = launches
    emit(result)
    return result


# ---------------------------------------------------------------- observe

OBSERVE_SLOTS = 16
OBSERVE_POOL_PAGES = 2048       # 16 MiB a page at llama3_8b: 32 GiB
OBSERVE_REQUESTS = {"bf16": 64, "int8": 32}
# Multi-tenant chat traffic: a shared 256-token system prompt a tenant,
# 128-token turns for the even (chat) tenants, 1024-token documents for
# the odd (batch) ones, 64 new tokens, every request traced.
LOADGEN_FLAGS = ["--concurrency", "16", "--tenants", "4",
                 "--tenant-prefix-len", "256", "--prompt-len", "128",
                 "--long-prompt-len", "1024", "--max-new-tokens", "64",
                 "--stream", "--trace-sample-rate", "1.0"]
SPAN_ORDER = ("req/queue", "req/prefill", "req/prefill_chunk", "req/fetch",
              "req/stream")


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def _scrape(text: str) -> dict:
    """Sample name{labels} -> value of a /metrics scrape."""
    from prometheus_client.parser import text_string_to_metric_families

    return {s.name + "".join(f"{{{k}={v}}}" for k, v in
                             sorted(s.labels.items())): s.value
            for fam in text_string_to_metric_families(text)
            for s in fam.samples}


def _spans_in_order(dump: dict, n_requests: int) -> int:
    """Every traced request's first req/queue, req/prefill,
    req/prefill_chunk, req/fetch and req/stream begin, in that order;
    returns the requests traced."""
    first: dict = {}
    for i, e in enumerate(dump["traceEvents"]):
        if e.get("cat") == "req" and e["ph"] == "b":
            first.setdefault(e["id"], {}).setdefault(e["name"], i)
    require(len(first) == n_requests,
            f"observe: {len(first)} traced requests, want {n_requests}")
    for rid, names in first.items():
        idx = [names.get(n) for n in SPAN_ORDER]
        require(None not in idx and idx == sorted(idx),
                f"observe: request {rid} spans out of order: {names}")
    return len(first)


def census_ms(engine, calls: int = 10) -> float:
    """thermal_census's host ms a call with every page of the pool
    allocated and owned (the engine stopped): its O(pages) cost at the
    pool's full size."""
    alloc = engine._alloc
    rows = alloc.alloc(alloc.free_pages)
    alloc.set_owner(rows, "0", "chat")
    t0 = time.perf_counter()
    for _ in range(calls):
        census = engine.thermal_census()
    ms = (time.perf_counter() - t0) / calls * 1e3
    require(census["pages_in_use"] == alloc.n_pages - 1,
            "census at a full pool")
    alloc.free(rows)
    return ms


def observe_run(torch, dev, model, cfg, weights: str, tmp_dir: str) -> dict:
    """One loadgen run (a process of its own) against make_server over a
    PagedContinuousEngine of OBSERVE_SLOTS slots on a pool of
    OBSERVE_POOL_PAGES pages, with a RequestRecorder, its exporter on an
    ephemeral port, the flight recorder and every request traced; the
    checks of the module docstring, then the run's numbers."""
    import container_engine_accelerators_tpu_torch as port
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        PagedContinuousEngine,
    )
    from container_engine_accelerators_tpu_torch.metrics import (
        events,
        trace,
    )
    from container_engine_accelerators_tpu_torch.metrics.request_metrics import (  # noqa: E501
        HOST_PHASES,
        RequestRecorder,
        ServeMetricsExporter,
        percentile,
    )

    n = OBSERVE_REQUESTS[weights]
    events.get_bus().clear()
    events.enable(capacity=1 << 18, dump_path=tmp_dir + os.sep,
                  signals=False, process_name=f"observe-{weights}")
    trace.configure(sample_rate=1.0)
    recorder = RequestRecorder()
    engine = PagedContinuousEngine(
        model, cfg, max_slots=OBSERVE_SLOTS, max_len=2048, page=128,
        pool_pages=OBSERVE_POOL_PAGES, max_prompt_len=2048 - 64,
        prefill_chunk=512, engine_core="async", recorder=recorder)
    answered: list = []
    submit = engine.submit

    def counted(tokens, *args, **kw):
        fut = submit(tokens, *args, **kw)
        fut.add_done_callback(lambda f: answered.append(
            len(f.result()) - len(tokens) if not f.exception() else None))
        return fut

    engine.submit = counted
    census_calls: list = []
    thermal_census = engine.thermal_census

    def timed_census(*args, **kw):
        t0 = time.perf_counter()
        out = thermal_census(*args, **kw)
        census_calls.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.thermal_census = timed_census
    exporter = ServeMetricsExporter(recorder, port=0, host="127.0.0.1")
    exporter.kv_provider = engine.thermal_census
    exporter.start_background()
    metrics_url = f"http://127.0.0.1:{exporter.bound_port}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))
    try:
        with serving(engine) as url:
            kernels.reset_launches()
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-m",
                 "container_engine_accelerators_tpu_torch.cli.loadgen",
                 "--url", url, "--requests", str(n), *LOADGEN_FLAGS],
                capture_output=True, text=True, timeout=900, cwd=root,
                env=dict(os.environ, PYTHONPATH=root))
            wall = time.monotonic() - t0
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
            require(proc.returncode == 0,
                    f"observe {weights}: loadgen rc {proc.returncode}: "
                    f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
            summary = json.loads(proc.stdout.strip().splitlines()[-1])
            deadline = time.monotonic() + 60
            while (recorder.registry.get_sample_value("serve_active_slots")
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            time.sleep(0.2)   # an idle iteration refreshes the gauges
            scrape = _scrape(_get(metrics_url + "/metrics"))
            kv = json.loads(_get(metrics_url + "/debugz?kv=1"))["kv"]
            rows = exporter.hbm_poller.poll_once()
            free, total = torch.cuda.mem_get_info(dev)
        held = engine.prefix_index.pages_held()
        in_use = engine.pages_in_use
        full_pool_ms = census_ms(engine)
        engine.prefix_index.clear()
        drained = engine.pages_in_use
    finally:
        exporter.stop()
    dump_path = events.dump_now(os.path.join(tmp_dir,
                                             f"observe-{weights}.json"))
    with open(dump_path) as f:
        dump = json.load(f)
    events.disable(clear=True)

    want_tokens = n * 64
    require(summary["errors"] == 0 and summary["requests_ok"] == n,
            f"observe {weights}: loadgen {summary}")
    require(scrape['serve_requests_total{outcome=ok}'] == n
            and scrape["serve_ttft_seconds_count"] == n,
            f"observe {weights}: scrape counts {n}? "
            f"{scrape.get('serve_requests_total{outcome=ok}')}, "
            f"{scrape.get('serve_ttft_seconds_count')}")
    counted_tokens = (scrape["serve_ttft_seconds_count"]
                      + scrape["serve_tpot_seconds_count"])
    require(len(answered) == n and sum(answered) == want_tokens
            and counted_tokens == want_tokens,
            f"observe {weights}: tokens counted {counted_tokens}, in the "
            f"answers {sum(a or 0 for a in answered)}, want {want_tokens}")
    require(in_use == held and drained == 0,
            f"observe {weights}: leaked pages: {in_use} in use, {held} "
            f"held by the prefix index, {drained} after clearing it")
    require(scrape["serve_prefix_hits_total"] >= 1,
            f"observe {weights}: no prefix hit")
    gap = recorder.host_gap()
    require(gap is not None and 0.0 <= gap <= 1.0,
            f"observe {weights}: host_gap_fraction {gap}")
    phases = recorder.host_phase_ms((50, 99))
    require(set(phases) == set(HOST_PHASES),
            f"observe {weights}: host phases with samples {sorted(phases)}")
    require(dump["otherData"]["dropped"] == 0,
            f"observe {weights}: the ring dropped events")
    traced = _spans_in_order(dump, n)
    counts = {k: kv[k] for k in ("buckets", "pages_in_use", "free_pages",
                                 "pages_total")}
    require(sum(kv["buckets"].values()) == kv["pages_in_use"]
            and kv["pages_in_use"] + kv["free_pages"] == kv["pages_total"]
            == OBSERVE_POOL_PAGES - 1,
            f"observe {weights}: census does not sum to the pool: {counts}")
    require("unowned" not in kv["tenants"]
            and sum(t["pages"] for t in kv["tenants"].values())
            == kv["pages_in_use"],
            f"observe {weights}: pages without a tenant: {kv['tenants']}")
    used = rows[0]["bytes_in_use"]
    require(abs(used - (total - free)) <= 0.01 * (total - free),
            f"observe {weights}: HbmPoller {used} B in use, mem_get_info "
            f"{total - free}")
    name = "int8_matmul" if weights == "int8" else "paged_decode_attention"
    for kernel in ("paged_decode_attention", name):
        require(launches.get(kernel, 0) > 0,
                f"observe {weights}: launched no {kernel}")

    def pct(kind):
        return recorder.pct_ms(kind, (50, 99))

    # The tick's host time by phase: each phase's seconds summed over the
    # run over the ticks committed (a tick has several schedule slices,
    # so a phase's p50 alone hides where a tick goes), and the share of
    # each phase that ran exposed (the card idle).
    ticks = len(recorder._host_ticks)
    per_tick, exposed = {}, {}
    for p, samples in recorder.host_samples.items():
        spent = sum(sec for sec, _ in samples)
        per_tick[p] = spent / ticks * 1e3
        exposed[p] = (sum(sec for sec, hidden in samples if not hidden)
                      / spent if spent else None)
    tick_wall_ms = sum(w for _, w in recorder._host_ticks) / ticks * 1e3

    return {"weights": weights, "requests": n, "slots": OBSERVE_SLOTS,
            "pool_pages": OBSERVE_POOL_PAGES, "page": 128,
            "loadgen": summary, "wall_s": wall,
            "generated_tokens_per_s": want_tokens / wall,
            "ttft_ms": pct("ttft"), "tpot_ms": pct("tpot"),
            "queue_wait_ms": pct("queue_wait"),
            "decode_step_ms": pct("decode_step"),
            "host_gap_fraction": gap,
            "host_phase_ms_p50": {p: v["p50"] for p, v in phases.items()},
            "host_phase_ms_per_tick": per_tick,
            "host_phase_exposed_share": exposed,
            "host_ticks": ticks, "tick_wall_ms_mean": tick_wall_ms,
            "host_phase_ms": phases,
            "host_phase_samples": {p: len(recorder.host_samples[p])
                                   for p in HOST_PHASES},
            "prefix_hits": scrape["serve_prefix_hits_total"],
            "prefix_lookups": scrape["serve_prefix_lookups_total"],
            "preemptions": scrape["serve_preemptions_total"],
            "census_ms_full_pool": full_pool_ms,
            "census_ms_in_run": {
                "calls": len(census_calls),
                "p50": percentile(census_calls, 50),
                "max": max(census_calls, default=None)},
            "census_after_drain": {k: kv[k] for k in (
                "pages_total", "pages_in_use", "buckets", "tenants")},
            "hbm_bytes_in_use": used, "mem_get_info_used": total - free,
            "traced_requests": traced,
            "trace_events": dump["otherData"]["emitted"],
            "launches": launches, "nvidia_smi": nvidia_smi_line()}


def observe_phase(torch, dev, np, model, cfg) -> dict:
    """The serving observability path at full width (see the module
    docstring): the bf16 run, then the int8 copy of the weights on a
    pool of the same size."""
    from container_engine_accelerators_tpu_torch.ops.quant import (
        quantize_llama_params,
    )

    result = {"phase": "observe", "model": "llama3_8b", "launches": {}}
    with tempfile.TemporaryDirectory() as tmp_dir:
        for weights in ("bf16", "int8"):
            m = model if weights == "bf16" else quantize_llama_params(model)
            run = observe_run(torch, dev, m, cfg, weights, tmp_dir)
            del m
            gc.collect()
            torch.cuda.empty_cache()
            for key, count in run["launches"].items():
                result["launches"][key] = (result["launches"].get(key, 0)
                                           + count)
            emit({"phase": f"observe_{weights}",
                  **{k: run[k] for k in (
                      "ttft_ms", "tpot_ms", "queue_wait_ms",
                      "generated_tokens_per_s", "host_gap_fraction",
                      "host_phase_ms_p50", "host_phase_ms_per_tick",
                      "tick_wall_ms_mean", "census_ms_full_pool",
                      "nvidia_smi")}})
            result[weights] = run
    emit(result)
    return result


# ------------------------------------------- spec, pools and supervise

SPEC_K, SPEC_DRAFT_LAYERS = 4, 2
SPEC_SLOTS, SPEC_NEW_TOKENS = 16, 32
POOLS_NEW_TOKENS = 32


def _pattern_prompts(np, cfg, seed: int, n: int, length: int = 128,
                     period: int = 16) -> list:
    """n prompts of `length` tokens, each a seeded `period`-token
    pattern repeated: prompt lookup finds what follows."""
    rs = np.random.RandomState(seed)
    prompts = []
    for _ in range(n):
        pattern = rs.randint(0, cfg.vocab_size, size=period).tolist()
        prompts.append((pattern * -(-length // period))[:length])
    return prompts


def _cache_copy(torch, cache):
    """The cache with every tensor cloned."""
    import dataclasses

    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).clone()
        for f in dataclasses.fields(cache)
        if isinstance(getattr(cache, f.name), torch.Tensor)})


def verify_drift(torch, dev, model, cfg, prefix, window,
                 paged: bool) -> float:
    """D: the largest |verify logits - the logits of k+1 single-token
    steps| from the same cache, which holds `prefix` [B, T0] (T0 a
    multiple of 128); `window` [B, k+1] are the verified tokens. The two
    sum in different orders (the prefill body against the split decode
    body), so their logits part in the last bits; the tokens may part
    only where the plain run's top two lie within 2 D. A contiguous slot
    cache, or a page pool at 128."""
    verify, single = verify_and_steps(torch, dev, model, cfg, prefix,
                                      window, paged)
    return (verify - single).abs().max().item()


def verify_and_steps(torch, dev, model, cfg, prefix, window, paged: bool):
    """verify_drift's two runs: (the verify logits, the single steps'
    logits), each [B, k+1, vocab]."""
    from container_engine_accelerators_tpu_torch.models import decode

    b, t0 = prefix.shape
    k1 = window.shape[1]
    on = torch.ones(b, dtype=torch.bool, device=dev)
    if paged:
        page = 128
        max_pages = -(-(t0 + k1) // page)
        cache = decode.init_paged_cache(cfg, b, b * max_pages + 1, page,
                                        max_pages, dev)
        for s in range(b):
            rows = torch.arange(1 + s * max_pages, 1 + (s + 1) * max_pages,
                                dtype=torch.int32, device=dev)
            decode.set_slot_pages(cache, s, rows, 0)
            _, cache = decode.prefill_suffix_paged(model, cache, s,
                                                   prefix[s], t0, cfg)
    else:
        cache = decode.init_slot_cache(cfg, b, t0 + k1, dev)
        _, cache = decode.verify_step(model, cache, prefix, on, cfg)
        cache = decode.advance_lengths(
            cache, torch.full((b,), t0, dtype=torch.int32, device=dev), on)
    steps = _cache_copy(torch, cache)
    verify, _ = decode.verify_step(model, cache, window, on, cfg)
    single = []
    for j in range(k1):
        logits, steps = decode.decode_step(model, steps, window[:, j:j + 1],
                                           cfg, active=on)
        single.append(logits[:, 0])
    return verify, torch.stack(single, dim=1)


def plain_margins(torch, dev, model, cfg, prompts: list,
                  answers: list) -> list:
    """The plain decode path's top-two logit margin at each generated
    position of each answer, teacher-forced: every prompt prefilled into
    its slot, then the answers' tokens one step at a time (T 1, the
    decode body) in one batch. margins[i][j] is the margin where row i's
    generated token j was picked."""
    from container_engine_accelerators_tpu_torch.models import decode

    b = len(prompts)
    n_new = len(answers[0]) - len(prompts[0])
    bucket = 128
    max_len = max(-(-len(p) // bucket) * bucket for p in prompts) + n_new
    cache = decode.init_slot_cache(cfg, b, max_len, dev)
    last = []
    for i, p in enumerate(prompts):
        padded = p + [0] * (-len(p) % bucket)
        logits, cache = decode.prefill_slot(
            model, cache, i, torch.tensor(padded, device=dev), len(p), cfg)
        last.append(logits)
    logits = torch.stack(last)
    on = torch.ones(b, dtype=torch.bool, device=dev)
    margins = []
    for j in range(n_new):
        top = logits.topk(2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
        if j + 1 < n_new:
            tok = torch.tensor([a[len(p) + j] for p, a in
                                zip(prompts, answers)], device=dev)
            logits, cache = decode.decode_step_slots(model, cache, tok, on,
                                                     cfg)
    return torch.stack(margins, dim=1).tolist()


def divergence_rule(plain: list, got: list, prompts: list, margins: list,
                    d: float, what: str, flips: list | None = None,
                    r: float | None = None) -> dict:
    """Hold `got` to the plain run's tokens: where a row first parts from
    them, the plain run's top-two margin there must lie within 2 D (a
    near tie the two summation orders may resolve either way); after
    that the contexts differ and nothing more is compared. For a mixture
    of experts, `flips[i]` lists the primary routing flips on row i's
    path before it parts (moe_route_check, which holds each within 2 R):
    a row may also part after one, since a flipped expert moves the
    logits by far more than D. Every divergence is reported with its
    margin and the first flip before it."""
    diverged = []
    for i, (ref, out) in enumerate(zip(plain, got)):
        n0 = len(prompts[i])
        require(len(out) == len(ref) and out[:n0] == ref[:n0],
                f"{what}: row {i} is malformed")
        for j in range(n0, len(ref)):
            if out[j] != ref[j]:
                m = margins[i][j - n0]
                at = {"row": i, "token": j - n0, "margin": m}
                ok = m <= 2 * d
                if flips is not None:
                    before = [f for f in flips[i] if f["position"] < j]
                    at["flip"] = before[0] if before else None
                    ok = ok or bool(before)
                diverged.append(at)
                require(ok, f"{what}: row {i} parts from the plain run at "
                        f"generated token {j - n0}, where its top-two "
                        f"margin {m} exceeds 2 D = {2 * d}" + (
                            "" if flips is None else
                            " and no routing on its path flipped"))
                break
    out = {"D": d, "two_D": 2 * d, "rows": len(plain),
           "divergences": len(diverged), "diverged_at": diverged}
    if r is not None:
        out.update({"R": r, "two_R": 2 * r})
    return out


def spec_generate_run(torch, dev, np, model, cfg) -> dict:
    """(a): generate at batch 2 on prompts of a repeated 16-token
    pattern, 32 new tokens, speculation off, ngram and draft (k 4, 2
    draft layers): wall and device-busy ms, the speculative counts, and
    the speculative tokens held to the plain run by the divergence
    rule."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models import decode

    prompts = _pattern_prompts(np, cfg, SEED + 20, 2)
    p = torch.tensor(prompts, device=dev)
    runs, launches = {}, {}
    for mode in ("off", "ngram", "draft"):
        def run(stats=None):
            return decode.generate(model, p, cfg, SPEC_NEW_TOKENS,
                                   speculate=mode, spec_k=SPEC_K,
                                   draft_layers=SPEC_DRAFT_LAYERS,
                                   spec_stats=stats)

        run()   # warm
        stats: dict = {}
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = run(stats)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        for name, n in kernels.launches.items():
            launches[name] = launches.get(name, 0) + n
        busy = profile_steps(torch, run, steps=1,
                             cpu=False)["busy_ms_per_step"]
        runs[mode] = {"tokens": out.tolist(), "wall_ms": wall,
                      "device_busy_ms": busy, **stats}
        if stats:
            runs[mode]["acceptance_rate"] = (stats["accepted"]
                                             / stats["drafted"])
            runs[mode]["tokens_per_verify"] = (stats["committed"]
                                               / stats["verifies"])
            require(stats["verifies"] > 0, f"spec generate {mode}: no "
                    "verify ran")
    plain = runs["off"]["tokens"]
    window = torch.tensor([r[128:128 + SPEC_K + 1] for r in plain],
                          device=dev)
    d = verify_drift(torch, dev, model, cfg, p, window, paged=False)
    margins = plain_margins(torch, dev, model, cfg, prompts, plain)
    for mode in ("ngram", "draft"):
        runs[mode]["rule"] = divergence_rule(
            plain, runs[mode]["tokens"], prompts, margins, d,
            f"spec generate {mode}")
    for r in runs.values():
        del r["tokens"]
    return {"batch": 2, "prompt": 128, "new_tokens": SPEC_NEW_TOKENS,
            "spec_k": SPEC_K, "draft_layers": SPEC_DRAFT_LAYERS,
            **runs, "launches": launches}


def spec_tick_timing(torch, dev, np, model, cfg, ticks: int = 16) -> dict:
    """The paged verify tick beside the plain tick at 16 slots (page 128,
    each slot prefilled with 128 tokens): the plain tick is
    decode_step_paged + argmax, the verify tick verify_step over k+1
    tokens + argmax + a commit of one token. Wall ms a tick around
    `ticks` ticks (synchronised at the end), device-busy ms a tick from
    torch.profiler."""
    from container_engine_accelerators_tpu_torch.models import decode

    slots, page, max_pages = SPEC_SLOTS, 128, 16
    per_slot = 3
    cache = decode.init_paged_cache(cfg, slots, slots * per_slot + 1, page,
                                    max_pages, dev)
    prompt = _prompts(np, cfg, SEED + 22)
    for s in range(slots):
        rows = ([1 + per_slot * s + i for i in range(per_slot)]
                + [0] * (max_pages - per_slot))
        decode.set_slot_pages(cache, s, torch.tensor(
            rows, dtype=torch.int32, device=dev), 0)
        _, cache = decode.prefill_suffix_paged(
            model, cache, s, torch.tensor(prompt(128), device=dev), 128, cfg)
    active = torch.ones(slots, dtype=torch.bool, device=dev)
    one = torch.ones(slots, dtype=torch.int32, device=dev)
    window = torch.tensor([prompt(SPEC_K + 1) for _ in range(slots)],
                          device=dev)
    tok = torch.zeros(slots, dtype=torch.long, device=dev)

    def plain_tick():
        nonlocal cache, tok
        logits, cache = decode.decode_step_paged(model, cache, tok, active,
                                                 cfg)
        tok = logits.argmax(dim=-1)

    def verify_tick():
        nonlocal cache
        logits, cache = decode.verify_step(model, cache, window, active,
                                           cfg)
        logits.argmax(dim=-1)
        cache = decode.advance_lengths(cache, one, active)

    out = {}
    for name, tick in (("plain", plain_tick), ("verify", verify_tick)):
        for _ in range(2):
            tick()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            tick()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / ticks * 1e3
        busy = profile_steps(torch, tick)["busy_ms_per_step"]
        out[f"{name}_tick_ms"] = wall
        out[f"{name}_device_busy_ms"] = busy
    return out


def _count_bodies(decode, da):
    """Wrap models.decode's paged attention entry to count its calls by
    the body they take (a call is one launch); returns (counts, undo)."""
    counts: dict = {}
    inner = decode.paged_decode_attention

    def counted(q, k_pool, *args, **kw):
        rows = q.shape[1] * (q.shape[2] // k_pool.shape[2])
        body = ("decode_split_kernel" if rows <= da.DECODE_ROWS
                else "prefill_mma_kernel")
        key = f"{body} T{q.shape[1]}"
        counts[key] = counts.get(key, 0) + 1
        return inner(q, k_pool, *args, **kw)

    decode.paged_decode_attention = counted

    def undo():
        decode.paged_decode_attention = inner
    return counts, undo


def spec_engine_run(torch, dev, np, model, cfg, speculate: str) -> dict:
    """(b) and (c): PagedContinuousEngine at 16 slots, page 128, max_len
    2048 behind make_server on 16 concurrent requests of a repeated
    16-token pattern (128 tokens, 32 new), with speculation off and then
    `speculate`: the tokens held by the divergence rule, no page leaked,
    the serve_spec_* scrape against the engine's own counts, the
    engine's tick beside the plain engine's, and K3 launches by body."""
    from prometheus_client import generate_latest

    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        PagedContinuousEngine,
    )
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.ops import (
        decode_attention as da,
    )

    prompts = _pattern_prompts(np, cfg, SEED + 21, SPEC_SLOTS)
    requests = [{"tokens": t, "max_new_tokens": SPEC_NEW_TOKENS}
                for t in prompts]
    runs, launches = {}, {}
    for mode in ("off", speculate):
        engine = PagedContinuousEngine(
            model, cfg, max_slots=SPEC_SLOTS, max_len=2048, page=128,
            prefill_chunk=512, engine_core="async", speculate=mode,
            spec_k=SPEC_K, draft_layers=SPEC_DRAFT_LAYERS)
        verifies = []          # decoding slots of each verify pass
        if mode != "off":
            verify = engine._verify

            def counted_verify(tokens, active, engine=engine,
                               verify=verify, verifies=verifies):
                verifies.append(sum(sl is not None and not sl["pending"]
                                    for sl in engine._slots))
                return verify(tokens, active)

            engine._verify = counted_verify
        bodies, undo = _count_bodies(decode, da)
        try:
            with serving(engine) as url:
                kernels.reset_launches()
                bodies.clear()
                answers, t_start, t_end = burst(url, requests)
                torch.cuda.synchronize()
                run_launches = dict(kernels.launches)
                by_body = dict(bodies)
                scrape = _scrape(generate_latest(
                    engine.recorder.registry).decode())
                health = healthz(url)
        finally:
            undo()
        for name, n in run_launches.items():
            launches[name] = launches.get(name, 0) + n
        generated = _check_burst(requests, answers, cfg.vocab_size,
                                 f"spec {mode}")
        require(engine.pages_in_use == engine.prefix_index.pages_held(),
                f"spec {mode}: leaked pages")
        require(sum(by_body.values())
                == run_launches.get("paged_decode_attention", 0),
                f"spec {mode}: K3 calls by body {by_body} against "
                f"{run_launches}")
        step = engine.recorder.pct_ms("decode_step", (50, 99))
        run = {"tokens": [_answer_tokens(r, a) for r, (a, _, _)
                          in zip(requests, answers)],
               "burst_s": t_end - t_start,
               "generated_tokens_per_s": generated / (t_end - t_start),
               "ticks": health["batches"], "engine_tick_ms": step,
               "k3_launches_by_body": by_body, "launches": run_launches}
        if mode != "off":
            n_verifies = scrape["serve_spec_verifies_total"]
            spec = {k: scrape[f"serve_spec_{k}"] for k in (
                "drafted_tokens_total", "accepted_tokens_total",
                "verifies_total", "committed_tokens_total",
                "acceptance_rate", "tokens_per_verify")}
            require(len(verifies) == engine.spec_ticks_run > 0
                    and n_verifies == sum(verifies)
                    and spec["drafted_tokens_total"] == SPEC_K * n_verifies
                    and spec["committed_tokens_total"] >= n_verifies
                    and abs(spec["acceptance_rate"]
                            - spec["accepted_tokens_total"]
                            / spec["drafted_tokens_total"]) < 1e-9
                    and abs(spec["tokens_per_verify"]
                            - spec["committed_tokens_total"]
                            / n_verifies) < 1e-9,
                    f"spec {mode}: scrape {spec} against the engine's "
                    f"{len(verifies)} verify passes over {sum(verifies)} "
                    f"slots, spec ticks {engine.spec_ticks_run}")
            require(scrape["serve_ttft_seconds_count"]
                    + scrape["serve_tpot_seconds_count"] == generated,
                    f"spec {mode}: tokens counted")
            run.update(spec_ticks=engine.spec_ticks_run, scrape=spec)
        runs[mode] = run
        del engine
    plain = runs["off"]["tokens"]
    window = torch.tensor([r[128:128 + SPEC_K + 1] for r in plain[:2]],
                          device=dev)
    d = verify_drift(torch, dev, model, cfg,
                     torch.tensor(prompts[:2], device=dev), window,
                     paged=True)
    margins = plain_margins(torch, dev, model, cfg, prompts, plain)
    runs[speculate]["rule"] = divergence_rule(
        plain, runs[speculate]["tokens"], prompts, margins, d,
        f"spec engine {speculate}")
    require(runs[speculate]["launches"].get("paged_decode_attention", 0)
            > 0, f"spec engine {speculate}: no K3 launch")
    for r in runs.values():
        del r["tokens"]
    return {"slots": SPEC_SLOTS, "page": 128, "max_len": 2048,
            "requests": len(requests), "new_tokens": SPEC_NEW_TOKENS,
            "spec_k": SPEC_K, **runs, "launches": launches,
            **spec_tick_timing(torch, dev, np, model, cfg)}


def spec_phase(torch, dev, np, model, cfg) -> dict:
    """Speculative decoding at full width: (a) generate, (b) the paged
    engine with ngram drafts, (c) the same on the int8 copy of the
    weights with the self-draft (K2 at N 80 in the verify)."""
    from container_engine_accelerators_tpu_torch.ops.quant import (
        quantize_llama_params,
    )

    result = {"phase": "spec", "model": "llama3_8b",
              "n_layers": cfg.n_layers, "launches": {}}
    qmodel = quantize_llama_params(model)
    parts = (
        ("generate", lambda: spec_generate_run(torch, dev, np, model, cfg)),
        ("engine_ngram",
         lambda: spec_engine_run(torch, dev, np, model, cfg, "ngram")),
        ("engine_int8_draft",
         lambda: spec_engine_run(torch, dev, np, qmodel, cfg, "draft")))
    for name, run in parts:
        t0 = time.perf_counter()
        part = run()
        part["seconds"] = time.perf_counter() - t0
        for key, count in part["launches"].items():
            result["launches"][key] = result["launches"].get(key, 0) + count
        result[name] = part
        emit({"phase": f"spec_{name}", **part,
              "nvidia_smi": nvidia_smi_line()})
    require(result["engine_int8_draft"]["draft"]["launches"].get(
        "int8_matmul", 0) > 0, "spec int8: no K2 launch")
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()
    result["nvidia_smi"] = nvidia_smi_line()
    return result


def _pools_requests(np, cfg) -> list:
    """16 requests of multi-tenant traffic: 12 chat turns (a 256-token
    system prompt of 2 tenants plus a 128-token turn) and 4 documents
    of 1024 tokens, 32 new tokens each; documents interleaved."""
    prompt = _prompts(np, cfg, SEED + 23)
    systems = [prompt(256), prompt(256)]
    requests = []
    for i in range(16):
        tokens = (prompt(1024) if i % 4 == 3
                  else systems[i % 2] + prompt(128))
        requests.append({"tokens": tokens,
                         "max_new_tokens": POOLS_NEW_TOKENS})
    return requests


def pools_phase(torch, dev, np, model, cfg) -> dict:
    """The paged engine (16 slots, prefill_chunk 512) with 2 prefill
    workers against the single loop on the same traffic: the tokens by
    the divergence rule (the budget changes the chunks' shapes), decode
    ticks between a document's chunks, the pool depth gauge sampled
    through the run, no page leaked."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        PagedContinuousEngine,
    )

    requests = _pools_requests(np, cfg)
    runs, launches = {}, {}
    for workers in (0, 2):
        engine = PagedContinuousEngine(
            model, cfg, max_slots=16, max_len=2048, page=128,
            prefill_chunk=512, prefill_workers=workers)
        chunks = []            # (request id, start, new_len, steps_run)
        run_chunk = engine._run_chunk

        def logged(slot, tokens, start, new_len, engine=engine,
                   chunks=chunks, run_chunk=run_chunk):
            chunks.append((engine._slots[slot]["rid"], start, new_len,
                           engine.steps_run))
            return run_chunk(slot, tokens, start, new_len)

        engine._run_chunk = logged
        depths = {"prefill": [], "decode": []}
        done = threading.Event()

        def sample(engine=engine, depths=depths, done=done):
            reg = engine.recorder.registry
            while not done.wait(0.01):
                for pool in depths:
                    v = reg.get_sample_value("serve_pool_queue_depth",
                                             {"pool": pool})
                    if v is not None:
                        depths[pool].append(v)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        try:
            with serving(engine) as url:
                kernels.reset_launches()
                answers, t_start, t_end = burst(url, requests)
                torch.cuda.synchronize()
                run_launches = dict(kernels.launches)
                health = healthz(url)
        finally:
            done.set()
            sampler.join(timeout=10)
        for name, n in run_launches.items():
            launches[name] = launches.get(name, 0) + n
        generated = _check_burst(requests, answers, cfg.vocab_size,
                                 f"pools {workers}")
        require(engine.pages_in_use == engine.prefix_index.pages_held(),
                f"pools {workers}: leaked pages")
        by_rid: dict = {}
        for rid, start, new_len, steps in chunks:
            by_rid.setdefault(rid, []).append((start, new_len, steps))
        docs = [c for c in by_rid.values() if c[-1][1] >= 1024]
        run = {"tokens": [_answer_tokens(r, a) for r, (a, _, _)
                          in zip(requests, answers)],
               "burst_s": t_end - t_start,
               "generated_tokens_per_s": generated / (t_end - t_start),
               "ticks": health["batches"],
               "tpot_ms": engine.recorder.pct_ms("tpot", (50, 99)),
               "ttft_ms": engine.recorder.pct_ms("ttft", (50, 99)),
               "document_chunks": docs, "launches": run_launches}
        if workers:
            require(health["prefill_workers"] == 2
                    and health["prefill_workers_alive"] == 2,
                    f"pools: healthz {health}")
            require(any(len(c) > 1 and c[-1][2] > c[0][2] for c in docs),
                    f"pools: no decode tick between a document's chunks: "
                    f"{docs}")
            require(max(depths["prefill"], default=0) > 0
                    and max(depths["decode"], default=0) > 0,
                    "pools: serve_pool_queue_depth never moved")
            run["pool_depth"] = {
                pool: {"samples": len(v), "max": max(v, default=None)}
                for pool, v in depths.items()}
        runs["pools" if workers else "single_loop"] = run
        del engine
    prompts = [r["tokens"] for r in requests]
    plain = runs["single_loop"]["tokens"]
    window = torch.tensor([r[384:384 + SPEC_K + 1] for r in plain[:2]],
                          device=dev)
    d = verify_drift(torch, dev, model, cfg,
                     torch.tensor([p[:384] for p in prompts[:2]],
                                  device=dev), window, paged=True)
    margins = plain_margins(torch, dev, model, cfg, prompts, plain)
    runs["pools"]["rule"] = divergence_rule(
        plain, runs["pools"]["tokens"], prompts, margins, d, "pools")
    for r in runs.values():
        del r["tokens"]
    result = {"phase": "pools", "model": "llama3_8b", "slots": 16,
              "prefill_workers": 2, "prefill_chunk": 512,
              "requests": len(requests), **runs, "launches": launches,
              "nvidia_smi": nvidia_smi_line()}
    emit(result)
    return result


def _wait_for(cond, what: str, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        require(time.monotonic() < deadline, f"timed out: {what}")
        time.sleep(0.02)


def supervise_phase(torch, dev, np, model, cfg) -> dict:
    """EngineSupervisor (backoff 0.05 s) over the paged engine behind
    make_server: a worker killed mid-decode fails its two in-flight
    requests with "supervised recovery", the pages return to baseline,
    serve_worker_restarts reads 1 and a fresh request answers the tokens
    it answered before the kill; then a prefill worker of a pooled engine
    killed mid-prefill fails no request and serve_prefill_worker_restarts
    reads 1."""
    import queue

    from prometheus_client import generate_latest

    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        EngineSupervisor,
        PagedContinuousEngine,
    )

    prompt = _prompts(np, cfg, SEED + 24)
    fresh = {"tokens": prompt(128), "max_new_tokens": 32}
    launches: dict = {}

    def scrape(engine):
        return _scrape(generate_latest(engine.recorder.registry).decode())

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    engine = PagedContinuousEngine(model, cfg, max_slots=8, max_len=2048,
                                   page=128, prefill_chunk=512)
    sup = EngineSupervisor(engine, backoff_base_s=0.05, poll_interval_s=0.05)
    with serving(engine) as url:
        try:
            sup.start()
            kernels.reset_launches()
            before = _answer_tokens(fresh, _post(url, fresh)[0])
            baseline = engine.pages_in_use
            streams = [queue.Queue(), queue.Queue()]
            futs = [engine.submit(prompt(128), 512, 0.0, stream=st)
                    for st in streams]
            for st in streams:
                ev = st.get(timeout=300)
                require("token" in ev, f"supervise: first event {ev}")
            in_use = engine.pages_in_use
            t_kill = time.monotonic()
            engine.fault_kill = True
            errors = []
            for fut in futs:
                try:
                    fut.result(timeout=300)
                    errors.append(None)
                except RuntimeError as e:
                    errors.append(str(e))
            require(all(e and "supervised recovery" in e for e in errors),
                    f"supervise: in-flight requests ended {errors}")
            failed_s = time.monotonic() - t_kill
            _wait_for(lambda: engine.worker_restarts == 1
                      and engine.thread.is_alive(), "the restart")
            restarted_s = time.monotonic() - t_kill
            pages_after = engine.pages_in_use
            restarts = scrape(engine)["serve_worker_restarts_total"]
            after = _answer_tokens(fresh, _post(url, fresh)[0])
            torch.cuda.synchronize()
            add(kernels.launches)
            health = healthz(url)
        finally:
            sup.stop()
    require(pages_after == baseline,
            f"supervise: {pages_after} pages in use after the recovery, "
            f"{baseline} before")
    require(restarts == 1, f"supervise: serve_worker_restarts {restarts}")
    require(after == before, "supervise: the restarted worker answered "
            "other tokens")
    require(health["worker_alive"] and health["worker_restarts"] == 1,
            f"supervise: healthz {health}")
    kill = {"in_flight_errors": errors, "pages_in_use_mid_decode": in_use,
            "pages_in_use_after": pages_after, "baseline": baseline,
            "worker_restarts": restarts, "same_tokens_after": True,
            "requests_failed_after_s": failed_s,
            "worker_back_after_s": restarted_s}
    del engine

    docs = [{"tokens": prompt(1024), "max_new_tokens": 16}
            for _ in range(6)]
    engine = PagedContinuousEngine(model, cfg, max_slots=8, max_len=2048,
                                   page=128, prefill_chunk=512,
                                   prefill_workers=2)
    sup = EngineSupervisor(engine, backoff_base_s=0.05, poll_interval_s=0.05)
    with serving(engine) as url:
        try:
            sup.start()
            _wait_for(lambda: engine.prefill_workers_alive() == 2,
                      "the prefill pool")
            kernels.reset_launches()
            engine.fault_kill_prefill = True
            answers, t_start, t_end = burst(url, docs)
            torch.cuda.synchronize()
            add(kernels.launches)
            _wait_for(lambda: sup.prefill_restarts == 1
                      and engine.prefill_workers_alive() == 2,
                      "the prefill worker's replacement")
            prefill_restarts = scrape(engine)[
                "serve_prefill_worker_restarts_total"]
            health = healthz(url)
        finally:
            sup.stop()
    require(not engine.fault_kill_prefill, "supervise: the prefill kill "
            "was never consumed")
    _check_burst(docs, answers, cfg.vocab_size, "supervise pools")
    require(prefill_restarts == 1 and engine.prefill_worker_restarts == 1,
            f"supervise: serve_prefill_worker_restarts {prefill_restarts}")
    require(health["worker_restarts"] == 0
            and health["prefill_worker_restarts"] == 1,
            f"supervise: healthz {health}")
    require(engine.pages_in_use == engine.prefix_index.pages_held(),
            "supervise pools: leaked pages")
    result = {"phase": "supervise", "model": "llama3_8b",
              "backoff_s": 0.05, "worker_kill": kill,
              "prefill_kill": {"requests": len(docs), "failed": 0,
                               "prefill_worker_restarts": prefill_restarts,
                               "burst_s": t_end - t_start},
              "launches": launches, "nvidia_smi": nvidia_smi_line()}
    emit(result)
    return result


# ---------------------------------------------------------------- K4-K6

# ---------- moe: a mixture of experts at Mixtral-8x7B's FFN widths ----------

# Llama-3-8B's attention and vocabulary with Mixtral-8x7B's FFN: 8
# experts of d_ff 14336, top-2, routed dropless. A layer is 2.82 GB of
# bf16 experts and 0.08 GB of attention, so 32 layers (~95 GB) do not
# fit the card: the serving model is cut to 16 layers (~49.6 GB with
# the f32 lm_head), the training one to 2 (~64 GB of f32 masters,
# gradients and AdamW moments).
MOE_KW = dict(n_experts=8, moe_top_k=2, moe_dropless=True)
MOE_SERVE_LAYERS = 16
MOE_TRAIN_LAYERS = 2
MOE_PROMPT_LENS = (64, 128, 192, 256, 320, 384, 448, 512)
MOE_NEW_TOKENS = 32
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 2, 1024, 4
MOE_CLI_NEW_TOKENS = 16
MOE_SERVE = "container_engine_accelerators_tpu_torch.cli.serve"
MOE_INT8_REFUSAL = "not supported for MoE"
MOE_FFN_TOKENS = (8, 40, 80, 128, 256, 384, 512)
MOE_FFN_RTOL = 1e-2     # bf16 FFN against f32, relative to max |out|


@contextlib.contextmanager
def route_recorder(torch, cfg):
    """Every decode.decode_step call's routings, in any thread: a call
    of all cfg.n_layers layers records its rows' positions [B, T] (as
    decode_step places them), tokens [B, T] and live rows [B], and for
    each layer the chosen experts [B*T, k] and router probabilities
    [B*T, E] that moe._gating returned. Tensors stay on the device:
    nothing syncs. A call of fewer layers (a self-draft) is left out."""
    from container_engine_accelerators_tpu_torch.models import decode, moe

    calls, local = [], threading.local()
    orig_step, orig_gating = decode.decode_step, moe._gating

    def gating(logits, top_k):
        out = orig_gating(logits, top_k)
        layers = getattr(local, "layers", None)
        if layers is not None:
            layers.append((out[2].detach(), out[0].detach()))
        return out

    def step(model, cache, tokens, *args, **kw):
        b, t = tokens.shape
        if isinstance(cache.length, torch.Tensor):
            max_len = (cache.tables.shape[1] * cache.page
                       if isinstance(cache, decode.PagedKVCache)
                       else cache.k.shape[2])
            start = cache.length.clamp(max=max_len - t).long()
        else:
            start = torch.full((b,), cache.length, device=tokens.device)
        active = kw.get("active", args[1] if len(args) > 1 else None)
        rec = {"positions": start[:, None] + torch.arange(
                   t, device=tokens.device),
               "tokens": tokens.clone(),
               "live": (torch.ones(b, dtype=torch.bool) if active is None
                        else active.clone())}
        local.layers = layers = []
        try:
            out = orig_step(model, cache, tokens, *args, **kw)
        finally:
            local.layers = None
        if len(layers) == cfg.n_layers:
            rec["experts"], rec["probs"] = map(list, zip(*layers))
            calls.append(rec)
        return out

    decode.decode_step, moe._gating = step, gating
    try:
        yield calls
    finally:
        decode.decode_step, moe._gating = orig_step, orig_gating


def routes_of(torch, calls: list, seqs: list, prompt_lens: list | None,
              by_row: bool = False) -> list:
    """route_recorder's calls by request: routes[i][(position, layer)]
    lists (experts, sorted; the k-th less the (k+1)-th router
    probability; the probabilities) of each routing of request i's token
    there. A live row belongs to request i where its tokens continue
    seqs[i] at its positions (a one-token row is a decode step, so it
    lies past i's prompt), up to the first that does not (padding, a
    rejected draft); a row that fits no request or two is left out.
    `by_row`: every call's row i is request i, whole."""
    out = [{} for _ in seqs]
    for c in calls:
        pos, tok = c["positions"].tolist(), c["tokens"].tolist()
        live = c["live"].tolist()
        b, t = len(tok), len(tok[0])
        probs = torch.stack(c["probs"]).float()
        n_layers, k = len(c["experts"]), c["experts"][0].shape[-1]
        experts = torch.stack(c["experts"]).sort(dim=-1).values.view(
            n_layers, b, t, k).tolist()
        top = probs.topk(k + 1, dim=-1).values
        margin = (top[..., k - 1] - top[..., k]).view(
            n_layers, b, t).tolist()
        probs = probs.view(n_layers, b, t, -1).tolist()
        for row in range(b):
            p0 = pos[row][0]
            fits = [(row, t)] if by_row else []
            for i, (seq, n0) in enumerate(zip(seqs, prompt_lens or [])):
                n = 0
                while (n < t and p0 + n < len(seq)
                       and tok[row][n] == seq[p0 + n]):
                    n += 1
                if n and not (t == 1 and p0 < n0):
                    fits.append((i, n))
            if not live[row] or len(fits) != 1:
                continue
            i, n = fits[0]
            for j in range(n):
                for li in range(n_layers):
                    out[i].setdefault((p0 + j, li), []).append((
                        tuple(experts[li][row][j]), margin[li][row][j],
                        probs[li][row][j]))
    return out


def route_flips(plain: dict, got: dict, upto: int) -> dict:
    """One request's routings on the engine (`got`) against the plain
    run's (`plain`; routes_of's form) at positions below `upto`, where
    both runs saw the same tokens. A flip is a routing whose experts
    differ. A flip at (p, l) changes the input of every layer above l at
    p and after it, so a flip is primary where no flip lies at an
    earlier-or-equal position in a lower layer: only a primary flip
    comes from rounding alone. `max_prob_gap` is the largest router
    probability change among the routings that no flip reaches."""
    pairs = [(p, li, want, eng) for (p, li), engs in got.items()
             if p < upto and (p, li) in plain
             for want in plain[(p, li)][:1] for eng in engs]
    flips = [(p, li, want, eng) for p, li, want, eng in pairs
             if want[0] != eng[0]]
    first: dict = {}
    for p, li, _, _ in flips:
        first[li] = min(first.get(li, p), p)

    def reached(p, li):
        return any(pf <= p for lf, pf in first.items() if lf < li)

    primary = sorted({(p, li): {
        "position": p, "layer": li, "margin": want[1],
        "engine_margin": eng[1], "experts": list(want[0]),
        "engine_experts": list(eng[0])}
        for p, li, want, eng in flips if not reached(p, li)}.values(),
        key=lambda f: (f["position"], f["layer"]))
    gap = max((max(abs(a - b) for a, b in zip(want[2], eng[2]))
               for p, li, want, eng in pairs
               if want[0] == eng[0] and not reached(p, li)), default=0.0)
    return {"compared": len(pairs), "flips": len(flips), "primary": primary,
            "max_prob_gap": gap}


def moe_route_check(torch, cfg, plain_calls: list, calls: list,
                    plain: list, got: list, prompts: list, r: float,
                    what: str) -> tuple[list, dict]:
    """Each request's engine routings against the plain run's, up to
    where its tokens part (route_flips); at least its prompt's must have
    been seen. Every primary flip must lie at a plain-run router margin
    within 2 R, R measured as D is: else the engine chose other experts
    than rounding explains. Returns (the primary flips by request, for
    divergence_rule; a summary)."""
    lens = [len(p) for p in prompts]
    plain_routes = routes_of(torch, plain_calls, plain, lens)
    got_routes = routes_of(torch, calls, got, lens)
    flips, summary = [], {"routings_compared": 0, "flips": 0,
                          "primary_flips": [], "max_prob_gap": 0.0}
    for i, (ref, out) in enumerate(zip(plain, got)):
        upto = next((j for j, (a, b) in enumerate(zip(ref, out)) if a != b),
                    len(ref))
        f = route_flips(plain_routes[i], got_routes[i], upto)
        require(f["compared"] >= lens[i] * cfg.n_layers,
                f"{what}: row {i}: {f['compared']} routings compared")
        for flip in f["primary"]:
            require(flip["margin"] <= 2 * r,
                    f"{what}: row {i} routes position {flip['position']} "
                    f"layer {flip['layer']} to {flip['engine_experts']} "
                    f"where the plain run chose {flip['experts']} at a "
                    f"router margin {flip['margin']} above 2 R = {2 * r}")
        flips.append(f["primary"])
        summary["routings_compared"] += f["compared"]
        summary["flips"] += f["flips"]
        summary["primary_flips"] += [{"row": i, **x} for x in f["primary"]]
        summary["max_prob_gap"] = max(summary["max_prob_gap"],
                                      f["max_prob_gap"])
    return flips, summary


def moe_references(torch, dev, model, cfg, prompts: list, n_new: int
                   ) -> tuple[list, list, list]:
    """(tokens, logit margins, route_recorder's calls): greedy_margins'
    loop at batch 1 (generate's bits) for each prompt."""
    with route_recorder(torch, cfg) as calls:
        refs, margins = zip(*(greedy_margins(torch, dev, model, cfg, p,
                                             n_new) for p in prompts))
    return list(refs), list(margins), calls


def moe_drift(torch, dev, model, cfg, prefix, window) -> dict:
    """D and R measured as verify_drift measures D (a slot cache), from
    what no routing flip between the verify pass and the single steps
    reaches (route_flips): a flip moves everything above and after it by
    far more than rounding. D is the largest |logit change| at a row's
    positions before its first flip, R the largest router probability
    change among the routings no flip reaches."""
    b, t0 = prefix.shape
    with route_recorder(torch, cfg) as calls:
        verify, single = verify_and_steps(torch, dev, model, cfg, prefix,
                                          window, paged=False)
    seqs = torch.cat([prefix, window], dim=1).tolist()
    steps = routes_of(torch, calls[2:], seqs, None, by_row=True)
    verified = routes_of(torch, calls[1:2], seqs, None, by_row=True)
    diff = (verify - single).abs().amax(dim=-1).tolist()       # [B, k+1]
    d, r, n_pos, flips = 0.0, 0.0, 0, 0
    for i in range(b):
        f = route_flips(steps[i], verified[i], len(seqs[i]))
        clean = min([x["position"] for x in f["primary"]]
                    + [len(seqs[i])]) - t0
        d = max([d] + diff[i][:clean])
        r = max(r, f["max_prob_gap"])
        n_pos += clean
        flips += len(f["primary"])
    # A position before a row's first flip has none of its routings
    # reached, so n_pos > 0 also measured R.
    require(n_pos > 0, f"moe drift: every position of {b} rows is "
            f"reached by a routing flip")
    return {"D": d, "R": r, "rows": b, "positions_measured": n_pos,
            "primary_flips": flips}


@contextlib.contextmanager
def forced_routing(torch, experts: list):
    """moe._gating with its i-th call's experts replaced by experts[i]
    (the gates renormalized from that call's own probabilities); yields
    the list of each call's own (experts, probabilities)."""
    from container_engine_accelerators_tpu_torch.models import moe

    own, orig = [], moe._gating

    def forced(logits, top_k):
        probs, _, idx = orig(logits, top_k)
        own.append((idx.detach(), probs.detach()))
        idx = experts[len(own) - 1].view_as(idx)
        gates = probs.gather(-1, idx)
        return probs, gates / gates.sum(dim=-1, keepdim=True).clamp(
            min=1e-9), idx

    moe._gating = forced
    try:
        yield own
    finally:
        moe._gating = orig


def moe_forward_check(torch, dev, model, cfg, prompt: list, r: float
                      ) -> dict:
    """decode_step's prefill logits against llama.forward's (K4 engages
    at S a multiple of 128 from 256), with forward's routing held to the
    prefill's experts, so a near-tie resolved otherwise moves no row:
    every row agrees within LOGITS_RTOL of the largest |logit| (bf16).
    Every routing where forward's own choice differs must lie at a
    prefill router margin within twice the larger of R and the largest
    router probability change among the routings where both agree (the
    two attention kernels round apart by more than verify and decode
    do)."""
    import dataclasses

    from container_engine_accelerators_tpu_torch.models import decode, llama

    p = torch.tensor([prompt], device=dev)
    k = cfg.moe_top_k
    with torch.no_grad():
        with route_recorder(torch, cfg) as calls:
            dec, _ = decode.decode_step(model, decode.init_cache(
                cfg, 1, p.shape[1], dev), p, cfg)
        with forced_routing(torch, calls[0]["experts"]) as own:
            fwd = llama.forward(model, p, dataclasses.replace(
                cfg, remat_policy="none"))
    require(len(own) == cfg.n_layers, f"moe: forward routed {len(own)} "
            f"of {cfg.n_layers} layers")
    dec_experts = torch.stack(calls[0]["experts"]).sort(-1).values
    dec_probs = torch.stack(calls[0]["probs"])                 # [L, S, E]
    fwd_experts = torch.stack([e.view(-1, k) for e, _ in own]).sort(
        -1).values
    fwd_probs = torch.stack([q.view(-1, q.shape[-1]) for _, q in own])
    top = dec_probs.topk(k + 1, dim=-1).values
    margin = top[..., k - 1] - top[..., k]
    differ = (dec_experts != fwd_experts).any(dim=-1)          # [L, S]
    gap = (dec_probs - fwd_probs).abs().amax(dim=-1)[~differ]
    r_used = max(r, gap.max().item() if gap.numel() else 0.0)
    scale = fwd.abs().max().item()
    row_err = (dec - fwd)[0].abs().amax(dim=-1) / scale
    out = {"tokens": p.shape[1], "logits_rtol": LOGITS_RTOL,
           "max_abs_logit": scale, "R": r, "R_used": r_used,
           "max_row_rel_err": row_err.max().item(),
           "rows_within": int((row_err <= LOGITS_RTOL).sum().item()),
           "routings": differ.numel(),
           "routings_differing": int(differ.sum().item()),
           "max_differing_margin": (margin[differ].max().item()
                                    if differ.any() else None)}
    require(out["rows_within"] == p.shape[1]
            and (out["max_differing_margin"] or 0.0) <= 2 * r_used,
            f"moe: prefill logits part from forward: {out}")
    return out


def moe_ffn_paths(torch, dev, cfg, layer) -> list:
    """The decode FFN's two paths at MOE_FFN_TOKENS tokens, on one
    layer's weights and seeded unit-normal activations: every expert
    for every token (decode.moe_ffn_every_expert) and the routed pairs
    alone (moe.dropless_ffn, one host sync), each held within
    MOE_FFN_RTOL of the largest |out| against an f32 FFN that weights
    every expert's output by its gate (0 where unchosen, the JAX
    package's form), and each timed in wall ms a call over 10 calls."""
    from container_engine_accelerators_tpu_torch.models import decode, moe

    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    xs, routes = {}, {}
    for n in MOE_FFN_TOKENS:
        xs[n] = torch.randn(n, cfg.d_model, generator=gen, device=dev,
                            dtype=torch.float32).to(cfg.dtype)
        routes[n] = moe._gating(moe._router_logits(xs[n], layer),
                                cfg.moe_top_k)[1:]
    want = {n: torch.zeros(n, cfg.d_model, device=dev) for n in xs}
    for e in range(cfg.n_experts):
        w_gate, w_up, w_down = (w[e].float() for w in (
            layer.w_gate, layer.w_up, layer.w_down))
        for n, x in xs.items():
            gates, idx = routes[n]
            weight = (gates * (idx == e)).sum(dim=-1, keepdim=True)
            xf = x.float()
            want[n] += weight * ((torch.nn.functional.silu(xf @ w_gate)
                                  * (xf @ w_up)) @ w_down)
        del w_gate, w_up, w_down
    paths = {"every_expert": decode.moe_ffn_every_expert,
             "routed": lambda x, lp, g, i: moe.dropless_ffn(
                 x, lp, cfg.n_experts, g, i)}
    out = []
    for n, x in xs.items():
        row = {"tokens": n}
        scale = want[n].abs().max().item()
        for name, fn in paths.items():
            got = fn(x, layer, *routes[n])
            err = (got.float() - want[n]).abs().max().item() / scale
            require(err <= MOE_FFN_RTOL, f"moe ffn {name} at {n} tokens: "
                    f"{err} of max |out| exceeds {MOE_FFN_RTOL}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn(x, layer, *routes[n])
            torch.cuda.synchronize()
            row[f"{name}_ms"] = (time.perf_counter() - t0) / 10 * 1e3
            row[f"{name}_rel_err"] = err
        out.append(row)
    return out


@contextlib.contextmanager
def moe_ffn_span(torch):
    """decode._moe_ffn_decode inside a `moe/ffn` profiler range."""
    from container_engine_accelerators_tpu_torch.models import decode

    orig = decode._moe_ffn_decode

    def spanned(*a, **kw):
        with torch.profiler.record_function("moe/ffn"):
            return orig(*a, **kw)

    decode._moe_ffn_decode = spanned
    try:
        yield
    finally:
        decode._moe_ffn_decode = orig


def _ffn_share(profile: dict) -> float | None:
    """The kernels launched inside the `moe/ffn` ranges, as a share of
    the busy time."""
    busy, spans = profile["busy_ms_per_step"], profile["span_kernels"] or {}
    return None if not busy or "moe/ffn" not in spans else (
        spans["moe/ffn"] / busy)


def _launches_into(total: dict, launches: dict) -> None:
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def moe_serve(torch, dev, np, before_timing=None) -> dict:
    """(a): the 16-layer model behind the window, continuous and paged
    engines (then the paged one with ngram speculation, k 4), each
    answering 8 requests of 64-512 tokens, 32 greedy new tokens, held
    against decode.generate at batch 1 by the divergence rule with D,
    and their routings against its routings with R; prefill logits
    against forward; the decode FFN's two paths against f32; the paged
    decode tick at 8 slots and a 512-token prefill, with the MoE FFN's
    share of each. `before_timing` runs before the first timed burst.
    Only the engines' launches count toward the kernels line; those of
    the reference runs, the checks and the timed tick and prefill are
    reported apart."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        BatchingEngine,
        ContinuousEngine,
        PagedContinuousEngine,
    )
    from container_engine_accelerators_tpu_torch.models import decode, llama
    from container_engine_accelerators_tpu_torch.utils.hbm_plan import (
        plan_serving,
    )

    cfg = llama.llama3_8b(n_layers=MOE_SERVE_LAYERS, **MOE_KW)
    # The continuous engine's slots are the largest cache of the phase.
    plan = plan_serving(cfg, max_slots=8, max_len=2048, pool_fraction=1.0,
                        device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == cfg.num_params(), "MoE parameter count")
    rs = np.random.RandomState(SEED + 40)
    prompts = [rs.randint(0, cfg.vocab_size, size=n).tolist()
               for n in MOE_PROMPT_LENS]
    launches, check_launches = {}, {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    refs, margins, ref_calls = moe_references(torch, dev, model, cfg,
                                              prompts, MOE_NEW_TOKENS)
    ref_s = time.perf_counter() - t0
    # Every prompt past 128 + k + 1 tokens.
    long = [p for p in prompts if len(p) > 128 + SPEC_K]
    drift = moe_drift(torch, dev, model, cfg, torch.tensor(
        [p[:128] for p in long], device=dev), torch.tensor(
            [p[128:128 + SPEC_K + 1] for p in long], device=dev))
    d, r = drift["D"], drift["R"]
    _launches_into(check_launches, kernels.launches)
    if before_timing is not None:
        before_timing()

    requests = [{"tokens": p, "max_new_tokens": MOE_NEW_TOKENS}
                for p in prompts]
    engines = {
        "window": lambda: BatchingEngine(model, cfg, max_batch=8,
                                         window_ms=250.0,
                                         engine_core="async"),
        "continuous": lambda: ContinuousEngine(
            model, cfg, max_slots=8, max_len=2048, prefill_chunk=512,
            engine_core="async"),
        "paged": lambda: paged_engine(model, cfg),
        "paged_ngram": lambda: PagedContinuousEngine(
            model, cfg, max_slots=8, max_len=2048, page=128,
            prefill_chunk=512, engine_core="async", speculate="ngram",
            spec_k=SPEC_K),
    }
    runs = {}
    for name, make in engines.items():
        engine = make()
        with serving(engine) as url:
            kernels.reset_launches()
            with route_recorder(torch, cfg) as calls:
                answers, t_start, t_end = burst(url, requests)
                torch.cuda.synchronize()
            run_launches = dict(kernels.launches)
        _launches_into(launches, run_launches)
        generated = _check_burst(requests, answers, cfg.vocab_size,
                                 f"moe {name}")
        got = [_answer_tokens(q, a) for q, (a, _, _) in zip(requests,
                                                            answers)]
        flips, routes = moe_route_check(torch, cfg, ref_calls, calls, refs,
                                        got, prompts, r, f"moe {name}")
        runs[name] = {
            "burst_s": t_end - t_start,
            "generated_tokens_per_s": generated / (t_end - t_start),
            **divergence_rule(refs, got, prompts, margins, d, f"moe {name}",
                              flips=flips, r=r),
            "routes": routes, "launches": run_launches}
        if name.startswith("paged"):
            require(engine.pages_in_use == engine.prefix_index.pages_held(),
                    f"moe {name}: leaked pages")
        if name == "paged_ngram":
            runs[name]["spec_ticks"] = engine.spec_ticks_run
            require(engine.spec_ticks_run > 0, "moe: no verify tick ran")
        del calls
    del ref_calls
    for name, kernel in (("window", "decode_attention"),
                         ("continuous", "decode_attention"),
                         ("paged", "paged_decode_attention"),
                         ("paged_ngram", "paged_decode_attention")):
        require(runs[name]["launches"].get(kernel, 0) > 0,
                f"moe {name}: no {kernel} launch")

    kernels.reset_launches()
    fwd_check = moe_forward_check(torch, dev, model, cfg, prompts[3], r)
    require(kernels.launches.get("flash_fwd", 0) > 0,
            "moe: forward launched no flash_fwd")
    _launches_into(check_launches, kernels.launches)
    ffn_paths = moe_ffn_paths(torch, dev, cfg, model.layers[0])

    with moe_ffn_span(torch):
        kernels.reset_launches()
        tick = paged_tick(torch, dev, np, model, cfg)
        _launches_into(check_launches, kernels.launches)
        long = torch.tensor([prompts[-1]], device=dev)
        cache = decode.init_cache(cfg, 1, long.shape[1], dev)

        def prefill():
            decode.decode_step(model, cache, long, cfg)

        prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            prefill()
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) / 3 * 1e3
        prefill_prof = profile_steps(torch, prefill, steps=2)
    peak = torch.cuda.max_memory_allocated()
    prefill_tokens = long.shape[1]
    # The engines hold the model in reference cycles (threads, bound
    # methods): drop them before the collection frees its 49.6 GB.
    del model, cache, long, engine, engines
    _free_card(torch)
    tick_ms = tick["paged_decode_tick_ms_8_slots"]
    return {
        "model": "llama3_8b widths, Mixtral-8x7B FFN", "n_layers":
        cfg.n_layers, "n_experts": cfg.n_experts, "top_k": cfg.moe_top_k,
        "params": n_params, "init_s": init_s,
        "plan_serving": plan, "max_memory_allocated_bytes": peak,
        "prompt_lens": list(MOE_PROMPT_LENS), "new_tokens": MOE_NEW_TOKENS,
        "reference_s": ref_s, "drift": drift, "engines": runs,
        "prefill_vs_forward": fwd_check, "ffn_paths": ffn_paths,
        "tick_wall_ms_8_slots": tick_ms,
        "tick_busy_ms_8_slots": tick["device_busy_ms_per_tick"],
        "tick_idle_share": tick["device_idle_share"],
        "tick_top_kernels_ms": tick["top_kernels_ms_per_tick"],
        "tick_launches": tick["launches_per_tick"],
        "ffn_share_of_tick": _ffn_share({
            "busy_ms_per_step": tick["device_busy_ms_per_tick"],
            "span_kernels": tick["span_kernels_ms_per_tick"]}),
        "prefill_tokens": prefill_tokens, "prefill_wall_ms": prefill_ms,
        "prefill_busy_ms": prefill_prof["busy_ms_per_step"],
        "prefill_top_kernels_ms": prefill_prof["top"],
        "ffn_share_of_prefill": _ffn_share(prefill_prof),
        "launches": launches, "check_launches": check_launches,
    }


def moe_train_run(torch, dev, np, dropless: bool, n_layers: int) -> dict:
    """(b), one routing: fit for MOE_TRAIN_STEPS steps at batch 2 x 1024
    under 'dots' remat; losses, the aux and dropped_fraction of a forward
    on the first batch, step ms, MFU (one FFN a token), busy share of one
    more step, peak memory and the flash launches."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models import llama, moe
    from container_engine_accelerators_tpu_torch.training.data import (
        synthetic_batches,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        fit,
        make_optimizer,
        make_train_step,
        to_device,
    )

    cfg = llama.llama3_8b(n_layers=n_layers, remat_policy="dots",
                          **{**MOE_KW, "moe_dropless": dropless})
    b, s = MOE_TRAIN_BATCH, MOE_TRAIN_SEQ
    logs = []
    _free_card(torch)
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    state, _ = fit(cfg, make_optimizer(),
                   synthetic_batches(cfg.vocab_size, b, s, seed=SEED),
                   device=dev, max_steps=MOE_TRAIN_STEPS, seed=SEED,
                   log_every=1,
                   log_fn=lambda m: logs.append((time.perf_counter(), m)))
    launches = dict(kernels.launches)
    losses = [float(m.split()[3]) for _, m in logs]
    require(len(losses) == MOE_TRAIN_STEPS
            and all(math.isfinite(x) for x in losses),
            f"moe train: losses {losses}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        require(launches.get(name, 0) > 0, f"moe train: no {name} launch")
    times = [t for t, _ in logs]
    gaps = sorted((b2 - a) * 1e3 for a, b2 in zip(times, times[1:]))
    mfu = _wall_mfu(cfg, times, b * s, s, set(), PEAK_FLOPS["bf16"])

    batch = to_device(next(synthetic_batches(cfg.vocab_size, b, s,
                                             seed=SEED)), dev)
    dropped = []
    orig = moe.moe_mlp_dropless if dropless else moe.moe_mlp
    name = orig.__name__

    def recorded(*a, **kw):
        out, metrics = orig(*a, **kw)
        dropped.append(metrics.dropped_fraction)
        return out, metrics

    setattr(moe, name, recorded)
    try:
        with torch.no_grad():
            _, aux = llama.forward(state.model, batch["inputs"], cfg,
                                   return_aux=True)
    finally:
        setattr(moe, name, orig)
    step = make_train_step(cfg, state.optimizer)
    step(state.model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state.model, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_steps(torch, lambda: step(state.model, batch), steps=1)
    peak = torch.cuda.max_memory_allocated()
    del state, step, batch
    _free_card(torch)
    return {"routing": "dropless" if dropless else "capacity",
            "capacity_factor": None if dropless else cfg.moe_capacity_factor,
            "losses": losses, "aux": aux.item(),
            "dropped_fraction": [x.item() for x in dropped],
            "step_ms_median_fit": gaps[len(gaps) // 2],
            "step_ms": step_ms,
            "busy_ms": prof["busy_ms_per_step"],
            "busy_share": (None if prof["busy_ms_per_step"] is None
                           else prof["busy_ms_per_step"] / step_ms),
            "top_kernels_ms": prof["top"],
            "mfu_one_ffn_a_token": mfu,
            "allocated_before_bytes": allocated_before,
            "max_memory_allocated_bytes": peak, "launches": launches}


def moe_train(torch, dev, np) -> dict:
    """(b): plan_training printed before the steps (a plan that does not
    fit drops the depth to 1 layer), then both routings."""
    from container_engine_accelerators_tpu_torch.models import llama
    from container_engine_accelerators_tpu_torch.utils.hbm_plan import (
        plan_training,
    )

    n_layers = MOE_TRAIN_LAYERS
    plan = plan_training(llama.llama3_8b(n_layers=n_layers, **MOE_KW),
                         batch_size=MOE_TRAIN_BATCH, seq_len=MOE_TRAIN_SEQ,
                         device=dev)
    emit({"phase": "moe_train_plan", "plan_training": plan})
    cut = None
    if not plan["fits"]:
        n_layers, cut = 1, f"plan_training does not fit at 2 layers: {plan}"
    runs = {key: moe_train_run(torch, dev, np, dropless, n_layers)
            for key, dropless in (("dropless", True), ("capacity", False))}
    launches: dict = {}
    for run in runs.values():
        _launches_into(launches, run["launches"])
    return {"n_layers": n_layers, "cut": cut, "batch": MOE_TRAIN_BATCH,
            "seq": MOE_TRAIN_SEQ, "steps": MOE_TRAIN_STEPS,
            "plan_training": plan, **runs, "launches": launches}


@contextlib.contextmanager
def moe_cli_launch(torch, dev, tmp_dir: str, serve_flags=()):
    """(c), first: fit a 4-expert llama_tiny for 2 steps with a
    checkpoint, then start `cli.serve --checkpoint DIR --engine paged`
    and the same command with --weight-dtype int8, each a process. They
    load during (a)'s reference runs (moe_cli_ready); both are stopped
    on exit. Yields what moe_cli needs."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models import llama
    from container_engine_accelerators_tpu_torch.training.data import (
        synthetic_batches,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        fit,
        make_optimizer,
    )

    cfg = llama.llama_tiny(**{**MOE_KW, "n_experts": 4})
    ckpt = os.path.join(tmp_dir, "moe_ckpt")
    kernels.reset_launches()
    fit(cfg, make_optimizer(warmup_steps=1, decay_steps=4),
        synthetic_batches(cfg.vocab_size, 4, 128, seed=SEED), device=dev,
        max_steps=2, log_every=0, ckpt_dir=ckpt, save_every=1)
    launch = {"cfg": cfg, "ckpt": ckpt, "launches": dict(kernels.launches),
              "port": _free_port(),
              "err_path": os.path.join(tmp_dir, "moe_serve.err")}
    root = port_root()
    with open(launch["err_path"], "w") as err:
        launch["serve"] = _popen_port(
            root, MOE_SERVE, "--checkpoint", ckpt, "--engine", "paged",
            "--port", str(launch["port"]), *serve_flags,
            stdout=subprocess.DEVNULL, stderr=err)
    launch["int8"] = _popen_port(
        root, MOE_SERVE, "--checkpoint", ckpt, "--weight-dtype", "int8",
        "--port", str(_free_port()), *serve_flags, stderr=subprocess.PIPE)
    launch["t_launch"] = time.monotonic()
    try:
        yield launch
    finally:
        _stop_procs([launch["serve"], launch["int8"]])


def moe_cli_ready(launch: dict) -> None:
    """(c), waited for before (a)'s timed runs: the served process
    answers /healthz and the int8 command has exited, so no process
    loads beside a timed run (the served one then sits idle)."""
    proc = launch["serve"]
    url = f"http://127.0.0.1:{launch['port']}"

    def ready():
        require(proc.poll() is None, f"moe cli: serve exited "
                f"{proc.returncode}: {_tail(launch['err_path'])}")
        try:
            return healthz(url)
        except OSError:
            return False

    _wait_for(ready, "moe cli: serve --checkpoint ready", 300)
    launch["ready_s"] = time.monotonic() - launch["t_launch"]
    _, launch["int8_err"] = launch["int8"].communicate(timeout=300)


def moe_cli(torch, dev, np, launch: dict) -> dict:
    """(c), then: the served process answers 2 requests over HTTP, held
    against generate on load_model's weights in this process by the
    divergence rule with the tiny model's D (its routings cannot be
    seen from here); the int8 command has exited non-zero with the MoE
    message."""
    from container_engine_accelerators_tpu_torch.models.convert import (
        load_model,
    )

    cfg, proc, int8 = launch["cfg"], launch["serve"], launch["int8"]
    url = f"http://127.0.0.1:{launch['port']}"
    model, cfg2 = load_model(launch["ckpt"], device=dev)
    require(cfg2 == cfg, f"moe cli: checkpoint config {cfg2}")
    rs = np.random.RandomState(SEED + 41)
    prompts = [rs.randint(0, cfg.vocab_size, size=128).tolist()
               for _ in range(2)]
    refs, margins = zip(*(greedy_margins(torch, dev, model, cfg2, p,
                                         MOE_CLI_NEW_TOKENS)
                          for p in prompts))
    d = moe_drift(torch, dev, model, cfg2, torch.tensor(prompts, device=dev),
                  torch.tensor([t[128:128 + SPEC_K + 1] for t in refs],
                               device=dev))["D"]
    require(proc.poll() is None, f"moe cli: serve exited "
            f"{proc.returncode}: {_tail(launch['err_path'])}")
    requests = [{"tokens": p, "max_new_tokens": MOE_CLI_NEW_TOKENS}
                for p in prompts]
    answers, _, _ = burst(url, requests)
    got = [_answer_tokens(q, a) for q, (a, _, _) in zip(requests, answers)]
    rule = divergence_rule(list(refs), got, prompts, list(margins), d,
                           "moe cli serve --checkpoint")
    int8_err = launch["int8_err"]
    require(int8.returncode not in (0, None)
            and MOE_INT8_REFUSAL in int8_err,
            f"moe cli: --weight-dtype int8 exited {int8.returncode}: "
            f"{int8_err[-1500:]}")
    del model
    _free_card(torch)
    return {"model": "llama_tiny, 4 experts, top-2, dropless",
            "fit_steps": 2, "serve_ready_s": launch["ready_s"],
            "tokens_equal_generate": got == list(refs), **rule,
            "int8_exit_code": int8.returncode,
            "int8_message": int8_err.strip().splitlines()[-1],
            "launches": launch["launches"]}


def moe_phase(torch, dev, np, serve_flags=()) -> dict:
    """The mixture of experts on the card: (a) serve, (b) train, (c) the
    serve CLI on a checkpoint of fit (`serve_flags` added to its
    command), whose processes start first and load during (a)'s
    reference runs; (a) waits for them before its timed runs."""
    parts, seconds, launches = {}, {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_dir, \
            moe_cli_launch(torch, dev, tmp_dir, serve_flags) as launch:
        seconds["cli_launch"] = time.perf_counter() - t0
        for part, fn in (
                ("serve", functools.partial(moe_serve, before_timing=(
                    functools.partial(moe_cli_ready, launch)))),
                ("train", moe_train),
                ("cli", functools.partial(moe_cli, launch=launch))):
            t0 = time.perf_counter()
            parts[part] = fn(torch, dev, np)
            seconds[part] = time.perf_counter() - t0
            _launches_into(launches, parts[part]["launches"])
            emit({"phase": f"moe_{part}", **parts[part]})
    result = {"phase": "moe", "seconds": seconds, "launches": launches}
    emit(result)
    return {**result, **parts}


def moe_main(torch) -> int:
    """`chip_smoke.py moe`: the build and the moe phase alone."""
    import numpy as np

    from container_engine_accelerators_tpu_torch import kernels

    try:
        dev = torch.device("cuda", 0)
        smi = nvidia_smi_line()
        emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
              "nvidia_smi": smi})
        require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
        t0 = time.perf_counter()
        kernels.build()
        kernels.load()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        moe_phase(torch, dev, np)
        emit({"phase_seconds": {"build": build_s,
                                "moe": time.perf_counter() - t0}})
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def ptxas_report(kernel: str, *parts: str) -> dict:
    """Registers and spill bytes of a kernel function (the first whose
    mangled name holds `kernel` and every one of `parts`), from ptxas's
    -v report in the build log of the library that kernels.load() loaded
    (the launch's register count: a warp-specialised kernel moves
    registers between its warpgroups with setmaxnreg from there)."""
    from container_engine_accelerators_tpu_torch import kernels

    path = kernels.build_log()
    require(path.exists(), f"no build log {path.name} beside the library")
    log = path.read_text()
    for block in log.split("Compiling entry function")[1:]:
        name = block.split("'")[1]
        if not all(part in name for part in (kernel, *parts)):
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        require(regs is not None and spill is not None,
                f"no ptxas report for {kernel} in {path.name}")
        # ptxas names the function on a line of its own where it had to
        # serialize wgmma products (C7514, C7520).
        serialized = any("serialized" in line and kernel in line
                         for line in log.splitlines())
        return {"registers": int(regs.group(1)),
                "spill_bytes": int(spill.group(1)) + int(spill.group(2)),
                "ptxas_serialized_wgmma": serialized}
    raise SmokeFailure(f"{kernel} {parts} is not in {path.name}")


def _sdpa_backend(torch, q, k, v, kw: dict) -> str:
    """The backend SDPA's dispatcher picks for these inputs and keywords
    (torch._fused_sdp_choice, a private call; "unknown" without it)."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, kw.get("attn_mask"), 0.0, kw.get("is_causal", False),
            scale=kw.get("scale"), enable_gqa=kw.get("enable_gqa", False))
        ).name
    except (AttributeError, TypeError, ValueError, RuntimeError):
        return "unknown"


def _flash_work(torch, seg, b, s, hq, hkv, d, causal) -> dict:
    """Bytes each kernel must move and operations it must do on these
    inputs: each input read once, each output written once; 4, 6 and 8
    flops per (visible query-key pair, head dim) for K4, K5 and K6 (the
    forward's two products; dq's three; dk/dv's four)."""
    if seg is None:
        pairs = b * (s * (s + 1) // 2 if causal else s * s)
    else:
        vis = seg[:, :, None] == seg[:, None, :]
        if causal:
            vis &= torch.ones(s, s, dtype=torch.bool,
                              device=seg.device).tril()
        pairs = int(vis.sum().item())
    qb, kvb = 2 * b * s * hq * d, 2 * b * s * hkv * d
    stat, segb = 4 * b * hq * s, 0 if seg is None else 4 * b * s
    per_pair = d * hq * pairs
    return {"flash_fwd": (2 * qb + 2 * kvb + stat + segb, 4 * per_pair),
            "flash_bwd_dq": (3 * qb + 2 * kvb + 2 * stat + segb,
                             6 * per_pair),
            "flash_bwd_dkv": (2 * qb + 4 * kvb + 2 * stat + segb,
                              8 * per_pair),
            "visible_pairs": pairs}


def _flash_cases(torch, dev, b: int, s: int, hq: int = 32, hkv: int = 8):
    """flash_phase's cases, (case, causal, seg, q, k, v, do) each, on
    inputs from a seed: q pre-scaled, head_dim 128, bf16."""
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as fa,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    pos = torch.arange(s, device=dev)
    packed = ((pos >= s // 3).float() + (pos >= 3 * s // 4).float()).expand(
        b, s).contiguous()    # three packed sequences per row

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    for case, causal, seg in [("main", True, None),
                              ("segmented", True, packed),
                              ("noncausal", False, None)]:
        q = fa._prescale(rnd(b, s, hq, 128))
        k, v = rnd(b, s, hkv, 128), rnd(b, s, hkv, 128)
        do = rnd(b, s, hq, 128)
        yield case, causal, seg, q, k, v, do


def _flash_sdpa(torch, q, k, v, seg, causal):
    """One PyTorch call for the flash kernels' attention (timing only;
    the port never calls it): (SDPA with its keywords, q, k and v in its
    layout, requiring grad). Segmented, SDPA takes the segment-and-causal boolean
    mask, and the KV heads are repeated, so that a backend that takes a
    mask but not GQA may run."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (q, k, v))
    if seg is None:
        return (functools.partial(F.scaled_dot_product_attention,
                                  is_causal=causal, scale=1.0,
                                  enable_gqa=True), qt, kt, vt)
    n_rep, s = q.shape[2] // k.shape[2], q.shape[1]
    kt, vt = (x.detach().repeat_interleave(n_rep, dim=1).requires_grad_()
              for x in (kt, vt))
    vis = (seg[:, :, None] == seg[:, None, :])[:, None]
    if causal:
        vis = vis & torch.ones(s, s, dtype=torch.bool,
                               device=q.device).tril()
    return (functools.partial(F.scaled_dot_product_attention,
                              attn_mask=vis, scale=1.0), qt, kt, vt)


def _sdpa_times(torch, q, k, v, seg, causal, do) -> dict:
    """SDPA's forward and its backward timed two ways (timing only): dq,
    dk and dv in one call, and with only q requiring grad (K5's function:
    whether the backend then computes dq alone shows in the ratio of the
    two); and the backend SDPA's dispatcher picks."""
    sdpa, qt, kt, vt = _flash_sdpa(torch, q, k, v, seg, causal)
    dot = do.transpose(1, 2)
    o = sdpa(qt, kt, vt)
    o_q = sdpa(qt, kt.detach(), vt.detach())
    res = {
        "sdpa_backward_ms": device_ms(
            torch, lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                               retain_graph=True), iters=10),
        "sdpa_backward_dq_only_ms": device_ms(
            torch, lambda: torch.autograd.grad(o_q, (qt,), dot,
                                               retain_graph=True), iters=10),
        "sdpa_backend": _sdpa_backend(torch, qt, kt, vt, sdpa.keywords),
        "sdpa_forward_ms": device_ms(
            torch, functools.partial(sdpa, qt.detach(), kt.detach(),
                                     vt.detach()), iters=10)}
    res["sdpa_dq_only_share"] = (res["sdpa_backward_dq_only_ms"]
                                 / res["sdpa_backward_ms"])
    return res


def flash_phase(torch, dev, b: int = 4, s: int = 2048, hq: int = 32,
                hkv: int = 8) -> dict:
    """K4, K5 and K6 against their plain versions at the train phase's
    attention shapes; the backward kernels take the plain forward's out
    and lse, so each is held alone. Returns {kernel: {case: result}}."""
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as fa,
    )

    d = 128
    results = {name: {} for name in FLASH_REPLACES}
    ptxas = {name: ptxas_report(f"{name}_kernel") for name in FLASH_REPLACES}
    for name, report in ptxas.items():
        require(report["spill_bytes"] == 0, f"{name} spills: {report}")
    for case, causal, seg, q, k, v, do in _flash_cases(torch, dev, b, s, hq,
                                                       hkv):
        work = _flash_work(torch, seg, b, s, hq, hkv, d, causal)
        out, lse = fa.flash_fwd_cuda(q, k, v, seg, causal)
        torch.cuda.synchronize()
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, causal)
        delta = (do.float() * out_p.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, seg, do, lse_p, delta.contiguous(), causal)
        dq = fa.flash_bwd_dq_cuda(*args)
        dk, dv = fa.flash_bwd_dkv_cuda(*args)
        torch.cuda.synchronize()
        dq_p = fa.flash_bwd_dq_plain(*args)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(*args)
        lse_err = (lse - lse_p).abs().max().item()
        require(lse_err <= LSE_ATOL, f"K4 {case}: lse off by {lse_err}")
        def held(got, want, what, rtol=FLASH_GRAD_ROW_RTOL):
            atol = FLASH_TENSOR_ATOL * want.float().abs().max().item()
            return _row_errors(got, want, d, what, rtol=rtol, atol=atol)

        errs = {"flash_fwd": [held(out, out_p, f"K4 {case}", K1_ROW_RTOL)],
                "flash_bwd_dq": [held(dq, dq_p, f"K5 {case}")],
                "flash_bwd_dkv": [held(dk, dk_p, f"K6 {case} dk"),
                                  held(dv, dv_p, f"K6 {case} dv")]}
        del out, out_p, dq, dq_p, dk, dk_p, dv, dv_p
        timed = {
            "flash_fwd": (lambda: fa.flash_fwd_cuda(q, k, v, seg, causal),
                          lambda: fa.flash_fwd_plain(q, k, v, seg, causal)),
            "flash_bwd_dq": (lambda: fa.flash_bwd_dq_cuda(*args),
                             lambda: fa.flash_bwd_dq_plain(*args)),
            "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv_cuda(*args),
                              lambda: fa.flash_bwd_dkv_plain(*args)),
        }
        # SDPA's forward for K4; its backward with only q requiring grad
        # for K5, and dq, dk and dv in one call for K6.
        sdpa = _sdpa_times(torch, q, k, v, seg, causal, do)
        library = {"flash_fwd": sdpa["sdpa_forward_ms"],
                   "flash_bwd_dq": sdpa["sdpa_backward_dq_only_ms"],
                   "flash_bwd_dkv": sdpa["sdpa_backward_ms"]}
        what = {"flash_fwd": "SDPA forward",
                "flash_bwd_dq": "SDPA backward, only q requiring grad",
                "flash_bwd_dkv": "SDPA backward: dq, dk and dv in one call"}
        prefix = {"flash_fwd": "k4", "flash_bwd_dq": "k5",
                  "flash_bwd_dkv": "k6"}
        for name, (kernel, plain) in timed.items():
            n_bytes, flops = work[name]
            bms, by = bound_ms(n_bytes, flops, "bf16")
            res = {"max_abs_err": max(e[0] for e in errs[name]),
                   "max_row_rel_err": max(e[1] for e in errs[name]),
                   "ms": device_ms(torch, kernel),
                   "plain_ms": device_ms(torch, plain, iters=3),
                   "library_ms": library[name],
                   "bound_ms": bms, "bound_by": by, **ptxas[name]}
            res["library"] = (what[name]
                              + ("" if seg is None else
                                 ", boolean mask, KV heads repeated")
                              + f", {sdpa['sdpa_backend']} backend")
            results[name][case] = res
            emit({"phase": f"{prefix[name]}_{case}", "B": b, "S": s,
                  "Hq": hq, "Hkv": hkv, "D": d, "causal": causal,
                  "visible_pairs": work["visible_pairs"],
                  "row_rtol": (K1_ROW_RTOL if name == "flash_fwd"
                               else FLASH_GRAD_ROW_RTOL),
                  "tensor_atol_share": FLASH_TENSOR_ATOL,
                  "lse_max_abs_err": lse_err, **res})
        # The backward pair against SDPA's whole backward: K5 and K6 do
        # seven products where a fused backward does five, the price of
        # summing dq without atomics.
        pair = (results["flash_bwd_dq"][case]["ms"]
                + results["flash_bwd_dkv"][case]["ms"])
        emit({"phase": f"k5_k6_{case}", "pair_ms": pair,
              "pair_bound_ms": (results["flash_bwd_dq"][case]["bound_ms"]
                                + results["flash_bwd_dkv"][case]["bound_ms"]),
              "sdpa_backward_ms": sdpa["sdpa_backward_ms"],
              "pair_over_sdpa": pair / sdpa["sdpa_backward_ms"],
              "sdpa_dq_only_share": sdpa["sdpa_dq_only_share"]})
        del q, k, v, do, lse, lse_p, delta, args, timed
    return results


# ---------------------------------------------------------------- train

def train_phase(torch, dev, np, n_layers: int = 8, batch: int = 4,
                seq: int = 2048, steps: int = 6,
                remat_policy: str = "dots") -> dict:
    """fit() on llama3_8b widths at `n_layers` layers from seed 0 for
    `steps` steps under `remat_policy`, logging every step: the loss
    fetch at each log is a device fence, so the gaps between logs are
    device-synchronised step times, and the launch counts between logs
    are one step's."""
    import re

    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models.llama import (
        llama3_8b,
    )
    from container_engine_accelerators_tpu_torch.training.data import (
        synthetic_batches,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        fit,
        make_optimizer,
        make_train_step,
        to_device,
    )

    cfg = llama3_8b(n_layers=n_layers, remat_policy=remat_policy)
    batches = synthetic_batches(cfg.vocab_size, batch, seq, seed=SEED)
    logs = []

    def log_fn(msg):
        logs.append((time.perf_counter(), msg, dict(kernels.launches)))

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, _ = fit(cfg, make_optimizer(), batches, device=dev,
                   max_steps=steps, seed=SEED, log_every=1, log_fn=log_fn)
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.launches)
    require(state.step == steps and len(logs) == steps,
            f"fit ran {state.step} steps, logged {len(logs)}")
    losses = [float(re.search(r"loss (\S+)", m).group(1))
              for _, m, _ in logs]
    gnorms = [float(re.search(r"grad_norm (\S+)", m).group(1))
              for _, m, _ in logs]
    require(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
            f"train: non-finite loss or grad norm {losses} {gnorms}")
    per_step, prev = [], {}
    for _, _, counts in logs:
        per_step.append({name: counts.get(name, 0) - prev.get(name, 0)
                         for name in FLASH_REPLACES})
        prev = counts
    want = {name: n * n_layers // 8 for name, n in
            TRAIN_LAUNCHES_PER_STEP[remat_policy].items()}
    require(all(step == want for step in per_step),
            f"train: launches per step {per_step}, want {want}")
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(logs, logs[1:])]
    median_ms = float(np.median(step_ms))
    tokens_per_s = batch * seq / (median_ms / 1e3)
    flops_per_token = cfg.train_flops_per_token(seq)

    step_fn = make_train_step(cfg, state.optimizer)
    extra = to_device(next(batches), dev)
    profile = profile_steps(torch, lambda: step_fn(state.model, extra),
                            steps=1, top=12)
    busy = profile["busy_ms_per_step"]
    by_kind: dict = {}
    for name, ms in (profile["kernels"] or {}).items():
        kind = next((k for k, marks in STEP_KERNEL_KINDS.items()
                     if any(m in name for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    del state, step_fn, extra
    result = {
        "phase": "train", "model": "llama3_8b", "n_layers": n_layers,
        "params": cfg.num_params(), "batch": batch, "seq": seq,
        "steps": steps, "remat_policy": cfg.remat_policy,
        "fit_s": fit_s, "step_ms_after_first": step_ms,
        "median_step_ms": median_ms, "tokens_per_s": tokens_per_s,
        "train_flops_per_token": flops_per_token,
        "mfu": tokens_per_s * flops_per_token / PEAK_FLOPS["bf16"],
        "device_busy_ms_per_step": busy,
        "device_busy_share": None if busy is None else busy / median_ms,
        "device_ms_per_step_by_kind": by_kind,
        "flash_ms_per_step": {
            name: sum(ms for kernel, ms in (profile["kernels"] or {}).items()
                      if f"{name}_kernel" in kernel)
            for name in FLASH_REPLACES},
        "top_kernels_ms_per_step": profile["top"],
        "spans_ms_per_step": profile["spans"],
        "max_memory_allocated_bytes": peak,
        "losses": losses, "grad_norms": gnorms,
        "launches_per_step": per_step[0], "launches": launches,
    }
    emit(result)
    return result


def train_parity_phase(torch, dev, np, n_layers: int = 2, seq: int = 512
                       ) -> dict:
    """One make_train_step from the same weights and batch: the kernel
    path against the plain path, and the kernel path under four remat
    policies, which must give identical bits ('dots_save_attn' with one
    K4 launch a layer where 'dots' has two)."""
    import dataclasses

    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models.llama import (
        init_train_params,
        llama3_8b,
    )
    from container_engine_accelerators_tpu_torch.training.data import (
        synthetic_batches,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        make_optimizer,
        make_train_step,
        to_device,
    )

    cfg = llama3_8b(n_layers=n_layers)
    model = init_train_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 9), dev)
    params = list(model.parameters())
    start = [p.detach().clone() for p in params]
    batch = to_device(next(synthetic_batches(cfg.vocab_size, 1, seq,
                                             seed=SEED + 9)), dev)

    def run(plain, policy):
        with torch.no_grad():
            for p, s in zip(params, start):
                p.copy_(s)
        c = dataclasses.replace(cfg, remat_policy=policy)
        kernels.reset_launches()
        metrics = make_train_step(c, make_optimizer()(params),
                                  plain=plain)(model, batch)
        loss = metrics["loss"].item()
        return loss, [p.grad.detach().clone() for p in params], dict(
            kernels.launches)

    loss_k, grads_k, launches_k = run(False, "dots")
    loss_p, grads_p, launches_p = run(True, "dots")
    require(not launches_p, f"plain path launched {launches_p}")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = max(((gk.float() - gp.float()).norm()
                    / gp.float().norm()).item()
                   for gk, gp in zip(grads_k, grads_p))
    del grads_p
    require(np.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_RTOL,
            f"train_parity: loss {loss_k} vs plain {loss_p}")
    require(grad_rel <= TRAIN_GRAD_RTOL,
            f"train_parity: a gradient is {grad_rel} of its norm off plain")
    identical, remat_launches = {}, {"dots": launches_k}
    for policy in ("none", "full", "dots_save_attn"):
        loss, grads, remat_launches[policy] = run(False, policy)
        identical[policy] = loss == loss_k and all(
            torch.equal(a, b) for a, b in zip(grads, grads_k))
        del grads
    del model, params, start, grads_k
    require(all(identical.values()),
            f"train_parity: remat policies gave other gradients {identical}")
    saved = remat_launches["dots_save_attn"]
    require(saved.get("flash_fwd") == n_layers and
            launches_k.get("flash_fwd") == 2 * n_layers and
            all(saved.get(k) == launches_k.get(k)
                for k in ("flash_bwd_dq", "flash_bwd_dkv")),
            f"train_parity: dots_save_attn launched {saved}, dots "
            f"{launches_k}: want K4 once a layer, K5/K6 unchanged")
    result = {"phase": "train_parity", "model": "llama3_8b",
              "n_layers": n_layers, "batch": 1, "seq": seq,
              "loss_kernel": loss_k, "loss_plain": loss_p,
              "loss_rel_diff": loss_rel, "max_grad_rel_diff": grad_rel,
              "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL,
              "remat_identical_to_dots": identical,
              "launches_by_remat": remat_launches}
    emit(result)
    return result


def greedy_margins(torch, dev, model, cfg, prompt: list, n_new: int
                   ) -> tuple[list, list]:
    """(tokens, margins): decode.generate's greedy loop (the same cache
    length, so the same launches and bits), keeping each picked token's
    top-two logit margin."""
    from container_engine_accelerators_tpu_torch.models import decode

    cache = decode.init_cache(cfg, 1, len(prompt) + n_new, dev)
    tok = torch.tensor([prompt], dtype=torch.long, device=dev)
    toks, margins = [], []
    for _ in range(n_new):
        logits, cache = decode.decode_step(model, cache, tok, cfg)
        top = logits[0, -1].topk(2).values
        margins.append(top[0] - top[1])
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        toks.append(tok[0, 0])
    # Read once at the end, as generate's caller does: no step waits.
    return (list(prompt) + torch.stack(toks).tolist(),
            torch.stack(margins).tolist())


def _fit_run(torch, dev, cfg, batch: int, seq: int, steps: int,
             ref: dict | None = None, **kw) -> dict:
    """fit() from seed 0 on the smoke's synthetic stream, logging every
    step; its log lines, last loss (exact) and flash launches, and either
    its final masters (kept on the device) or, given the run `ref` that
    kept them, the comparison with it (_resume_diff)."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.training.data import (
        synthetic_batches,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        fit,
        make_optimizer,
    )

    logs = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, metrics = fit(
        cfg, make_optimizer(),
        synthetic_batches(cfg.vocab_size, batch, seq, seed=SEED),
        device=dev, max_steps=steps, seed=SEED, log_every=1,
        log_fn=lambda m: logs.append((time.perf_counter(), m)), **kw)
    end = time.perf_counter()
    seconds = end - t0
    run = {"step": state.step, "seconds": seconds, "end": end,
           "logs": [m for _, m in logs], "log_times": [t for t, _ in logs],
           "last_loss": metrics["loss"].item(),
           "params": [p.detach().clone() for p in state.model.parameters()],
           "launches": dict(kernels.launches)}
    del state, metrics
    if ref is not None:
        run["diff"] = _resume_diff(run, ref)
        del run["params"]
    _free_card(torch)
    return run


def _free_card(torch) -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _resume_diff(run: dict, ref: dict) -> dict:
    """The resumed run against the uninterrupted one: bit identity of
    the final masters and last loss, and the largest difference of each
    relative to the reference's largest |x|."""
    rel = max(((a - b).abs().max()
               / b.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(run["params"], ref["params"]))
    loss_rel = abs(run["last_loss"] - ref["last_loss"]) / abs(
        ref["last_loss"])
    identical = run["last_loss"] == ref["last_loss"] and all(
        a.equal(b) for a, b in zip(run["params"], ref["params"]))
    return {"bit_identical": identical, "max_param_rel_diff": rel,
            "last_loss_rel_diff": loss_rel,
            "last_loss": run["last_loss"]}


def _mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def sweep_ckpt_roots(shm: str = CKPT_SHM) -> list[str]:
    """Remove the ckpt roots that an earlier smoke left in `shm` when it
    was killed before its cleanup: this user's `<prefix><pid>-*` dirs
    whose process is gone. RAM they hold is not freed until reboot, and
    ckpt_room would find no room. Returns the names removed."""
    removed = []
    for name in sorted(os.listdir(shm)) if os.path.isdir(shm) else ():
        m = re.match(re.escape(CKPT_ROOT_PREFIX) + r"(\d+)-", name)
        path = os.path.join(shm, name)
        if not m or os.stat(path).st_uid != os.getuid():
            continue
        try:
            os.kill(int(m.group(1)), 0)
            continue                        # its smoke still runs
        except ProcessLookupError:
            pass
        except PermissionError:
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed.append(name)
    return removed


def ckpt_room(tmp_dir: str, shm: str = CKPT_SHM) -> dict:
    """The ckpt phase's depth, place and room: CKPT_N_LAYERS at full
    width in `shm`, which must hold CKPT_PEAK_STEPS steps while the
    host's MemAvailable holds CKPT_HOST_STEPS; raises otherwise. The
    temp dir's free space is recorded beside them (the steps cannot go
    there: see CKPT_SHM)."""
    from container_engine_accelerators_tpu_torch.models.llama import (
        llama3_8b,
    )

    step = (llama3_8b(n_layers=CKPT_N_LAYERS).num_params()
            * CKPT_BYTES_PER_PARAM)
    room = {"n_layers": CKPT_N_LAYERS, "where": shm, "state_bytes": step,
            "swept": sweep_ckpt_roots(shm),
            "disk_free_bytes": shutil.disk_usage(tmp_dir).free,
            "shm_free_bytes": (shutil.disk_usage(shm).free
                               if os.path.isdir(shm) else 0),
            "mem_available_bytes": _mem_available_bytes()}
    if (room["shm_free_bytes"] < CKPT_PEAK_STEPS * step
            or room["mem_available_bytes"] < CKPT_HOST_STEPS * step):
        raise SmokeFailure(
            f"ckpt: {shm} must hold {CKPT_PEAK_STEPS} steps and "
            f"MemAvailable {CKPT_HOST_STEPS} of {step} bytes: {room}")
    return room


@contextlib.contextmanager
def _removed_on_sigterm():
    """SIGTERM (a `timeout`) raises SystemExit in the main thread, so the
    `finally` that removes a RAM-backed ckpt root runs."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def stop(signum, frame):
        raise SystemExit(128 + signum)

    previous = signal.signal(signal.SIGTERM, stop)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, previous)


def _step_path_extra(run: dict, ref: dict) -> float:
    """Seconds the steps of `run` took beyond the same steps of the
    uninterrupted `ref`: the fit loop fences and logs every step, so a
    step's time is the gap from the previous step's log line; each step
    whose previous one ran in `run` counts, and so does the time fit took
    after its last step. A save's cost lands in the step that calls it
    and in the steps its write slows, however the save splits it."""
    def times(r):
        return {int(m.split()[1]): t for t, m in zip(r["log_times"],
                                                     r["logs"])
                if m.startswith("step ")}

    mine, base = times(run), times(ref)
    extra = sum((mine[s] - mine[s - 1]) - (base[s] - base[s - 1])
                for s in mine if s - 1 in mine)
    last = max(mine)
    return extra + (run["end"] - mine[last]) - (ref["end"] - base[max(base)])


def ckpt_phase(torch, dev, np, tmp_dir: str, ckpt_root: str, cfg,
               batch: int = 2, seq: int = 1024) -> dict:
    """Checkpoint and resume: fit for CKPT_STEPS steps saving every
    CKPT_STEPS, a second fit on the same directory resuming there and
    running to twice that, held against an uninterrupted run as long;
    the same with async saves; then the newest step torn, quarantined,
    and the run resumed from the step before. Steps go under
    `ckpt_root` (the caller's, from ckpt_room), logs under `tmp_dir`;
    the last checkpoint is left at `<ckpt_root>/ckpt`. At most
    CKPT_PEAK_STEPS are held."""
    from container_engine_accelerators_tpu_torch.metrics.train_metrics import (  # noqa: E501
        TrainRecorder,
        read_metrics_jsonl,
    )
    from container_engine_accelerators_tpu_torch.training import (
        checkpoint,
    )

    saves, restores = [], []
    commit, restore = (checkpoint.CheckpointManager._commit,
                       checkpoint.CheckpointManager.restore)

    def spy_commit(self, *args):
        commit(self, *args)
        saves.append(dict(self.last_save_info, async_mode=self.async_save))

    def spy_restore(self, *args, **kw):
        out = restore(self, *args, **kw)
        if self.last_restore_info:
            restores.append(dict(self.last_restore_info))
        return out

    k = CKPT_STEPS

    def run(steps, ckpt_dir=None, ckpt_async=False):
        """One fit; every run after the first (the uninterrupted one)
        is held against it, and keeps only that comparison."""
        log_path = os.path.join(tmp_dir, f"steps-{len(runs)}.jsonl")
        rec = TrainRecorder(log_path=log_path)
        try:
            out = _fit_run(torch, dev, cfg, batch, seq, steps,
                           ref=runs[0] if runs else None,
                           ckpt_dir=ckpt_dir, save_every=k,
                           ckpt_async=ckpt_async, recorder=rec)
        finally:
            rec.close()
        out["records"] = read_metrics_jsonl(log_path)
        runs.append(out)
        return out

    runs: list = []
    ref = run(2 * k)
    results = {}
    checkpoint.CheckpointManager._commit = spy_commit
    checkpoint.CheckpointManager.restore = spy_restore
    try:
        for mode, is_async in (("sync", False), ("async", True)):
            d = os.path.join(ckpt_root, "ckpt")
            shutil.rmtree(d, ignore_errors=True)
            n_saves = len(saves)
            first = run(k, d, is_async)
            require(checkpoint.step_dirs(d) == [k],
                    f"ckpt {mode}: steps {checkpoint.step_dirs(d)} after {k}")
            second = run(2 * k, d, is_async)
            require(second["logs"][0] == f"resumed from step {k}",
                    f"ckpt {mode}: {second['logs'][:1]}")
            require(second["logs"][1:] == ref["logs"][k:],
                    f"ckpt {mode}: resumed losses {second['logs'][1:]} "
                    f"against {ref['logs'][k:]}")
            diff = second["diff"]
            require(diff["max_param_rel_diff"] <= CKPT_RESUME_RTOL and
                    diff["last_loss_rel_diff"] <= CKPT_RESUME_RTOL,
                    f"ckpt {mode}: resumed run parts from the "
                    f"uninterrupted one: {diff}")
            calls = [r["seconds"] for r in first["records"]
                     + second["records"] if r["kind"] == "ckpt_save"]
            joins = [r["seconds"] for r in first["records"]
                     + second["records"] if r.get("join")]
            mine = saves[n_saves:]
            results[mode] = {
                **diff, "steps_on_disk": checkpoint.step_dirs(d),
                "step_path_s": (_step_path_extra(first, ref)
                                + _step_path_extra(second, ref)),
                "save_call_s": calls, "end_join_s": joins,
                "saves": mine,
                "bytes_per_save": mine[0]["bytes"],
                "save_gb_per_s": [s["bytes"] / (s["snapshot_s"]
                                                + s["write_s"]) / 1e9
                                  for s in mine],
                "restore": restores[-1],
                "restore_gb_per_s": restores[-1]["bytes"]
                / restores[-1]["seconds"] / 1e9,
                "fit_s": [first["seconds"], second["seconds"]],
                "launches": [first["launches"], second["launches"]]}
            del first, second
        # The torn step: cut the newest step's optimizer state in half.
        torn = os.path.join(d, str(2 * k), "state",
                            checkpoint.OPTIMIZER_FILE)
        with open(torn, "r+b") as f:
            f.truncate(os.path.getsize(torn) // 2)
        again = run(2 * k, d)
        require(again["logs"][0] == f"resumed from step {k}" and
                os.path.isdir(os.path.join(d, f"{2 * k}.corrupt")),
                f"ckpt torn: {again['logs'][:1]}, "
                f"{sorted(os.listdir(d))}")
        torn_diff = again["diff"]
        require(torn_diff["max_param_rel_diff"] <= CKPT_RESUME_RTOL,
                f"ckpt torn: {torn_diff}")
        torn_steps = sorted(os.listdir(d))
        shutil.rmtree(os.path.join(d, f"{2 * k}.corrupt"))
    finally:
        checkpoint.CheckpointManager._commit = commit
        checkpoint.CheckpointManager.restore = restore
    launches: dict = {}
    for r in runs:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    del ref["params"]
    result = {
        "phase": "ckpt", "model": "llama3_8b", "n_layers": cfg.n_layers,
        "params": cfg.num_params(), "batch": batch, "seq": seq,
        "resume_rtol": CKPT_RESUME_RTOL,
        "uninterrupted_losses": ref["logs"],
        "sync": results["sync"], "async": results["async"],
        "async_step_path_over_sync": (results["async"]["step_path_s"]
                                      / results["sync"]["step_path_s"]),
        "torn": {"quarantined": f"{2 * k}.corrupt", "resumed_from": k,
                 **torn_diff, "steps_on_disk": torn_steps},
        "ckpt_dir": d, "launches": launches}
    emit(result)
    return result


def _wall_mfu(cfg, log_times: list, tokens_per_step: int, seq: int,
              skip: set, peak: float) -> float:
    """MFU from the log fences' wall clock: every step after the first
    is the gap between its log line and the one before, less any
    stalled step."""
    gaps = [b - a for i, (a, b) in enumerate(zip(log_times, log_times[1:]))
            if i + 2 not in skip]
    return (tokens_per_step * len(gaps) / sum(gaps)
            * cfg.train_flops_per_token(seq) / peak)


def observe_train_phase(torch, dev, np, tmp_dir: str, cfg=None,
                        batch: int = 1, seq: int = 1024, steps: int = 6,
                        threshold_s: float = 2.0,
                        stall_s: float = 5.0) -> dict:
    """The train recorder on the card: a short fit with /metrics on an
    ephemeral port, the JSONL step log, a heartbeat dir and the hang
    watchdog, and a data stall longer than the threshold armed before
    step 4's batch."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.metrics import events
    from container_engine_accelerators_tpu_torch.metrics.train_metrics import (  # noqa: E501
        TrainRecorder,
        detect_peak_flops,
        read_metrics_jsonl,
    )
    from container_engine_accelerators_tpu_torch.models.llama import (
        llama3_8b,
    )
    from container_engine_accelerators_tpu_torch.training import dataset
    from container_engine_accelerators_tpu_torch.training.data import (
        synthetic_batches,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        fit,
        make_optimizer,
    )

    cfg = cfg or llama3_8b(n_layers=2)
    log_path = os.path.join(tmp_dir, "observe_train.jsonl")
    hb_dir = os.path.join(tmp_dir, "hb")
    rec = TrainRecorder(log_path=log_path, heartbeat_dir=hb_dir,
                        process_id=0)
    hb_path = os.path.join(hb_dir, "hb-0")
    hb_before = open(hb_path).read().split()
    scrapes, stop = [], threading.Event()
    logs: list = []

    def log_fn(msg):
        logs.append((time.perf_counter(), msg))
        m = re.match(r"train metrics on :(\d+)/metrics", msg)
        if m:
            threading.Thread(target=scrape_loop, args=(int(m.group(1)),),
                             daemon=True).start()

    def scrape_loop(port):
        url = f"http://localhost:{port}"
        while not stop.is_set():
            try:
                scrapes.append(_scrape(_get(url + "/metrics")))
            except OSError:
                return      # fit stopped its exporter
            stop.wait(0.25)

    def stream():
        for i, b in enumerate(synthetic_batches(cfg.vocab_size, batch, seq,
                                                seed=SEED)):
            yield b
            if i == 2:   # the next fetch, step 4's, stalls
                dataset.inject_stall(once_s=stall_s)

    events.enable(capacity=1 << 16)
    events.get_bus().clear()
    kernels.reset_launches()
    try:
        state, _ = fit(cfg, make_optimizer(), stream(), device=dev,
                       max_steps=steps, seed=SEED, log_every=1,
                       log_fn=log_fn, recorder=rec, metrics_port=0,
                       heartbeat_dir=hb_dir,
                       watchdog_threshold_s=threshold_s)
        stop.set()
        launches = dict(kernels.launches)
        hb_after = open(hb_path).read().split()
        summary = rec.summary()
        instants = [ev[3] for ev in events.get_bus().snapshot()
                    if ev[0] == "i"]
    finally:
        stop.set()
        dataset.clear_stall()
        events.disable(clear=True)
        rec.close()
    del state
    _free_card(torch)
    records = read_metrics_jsonl(log_path)
    step_recs = [r for r in records if r["kind"] == "step"]
    require(len(step_recs) == steps and [r["step"] for r in step_recs]
            == list(range(1, steps + 1)),
            f"observe_train: JSONL steps {[r['step'] for r in step_recs]}")
    require(scrapes, "observe_train: /metrics was never scraped")
    last = scrapes[-1]
    families = ("train_tokens_per_sec", "train_mfu",
                "train_goodput_seconds{bucket=productive}",
                "train_goodput_seconds{bucket=stalled}",
                "train_goodput_fraction", "train_stalled")
    missing = [f for f in families if f not in last]
    require(not missing, f"observe_train: scrape lacks {missing}")
    flagged = max(s.get("train_stalled", 0.0) for s in scrapes)
    require(flagged == 1.0 and "train/stalled" in instants,
            f"observe_train: the watchdog never flagged the stall "
            f"(max train_stalled {flagged}, instants {set(instants)})")
    require(hb_before[1] == "0" and hb_after[1] == str(steps),
            f"observe_train: heartbeat {hb_before} -> {hb_after}")
    stalled = summary["goodput"]["stalled"]
    require(stalled >= stall_s, f"observe_train: stalled bucket {stalled} "
            f"s < the {stall_s} s stall")
    peak = detect_peak_flops(dev)
    wall = (None if peak is None else _wall_mfu(
        cfg, [t for t, m in logs if m.startswith("step ")],
        batch * seq, seq, {4}, peak))
    result = {"phase": "observe_train", "model": "llama3_8b",
              "n_layers": cfg.n_layers, "batch": batch, "seq": seq,
              "steps": steps, "watchdog_threshold_s": threshold_s,
              "stall_s": stall_s, "jsonl_step_lines": len(step_recs),
              "heartbeat": [hb_before[1], hb_after[1]],
              "max_train_stalled": flagged, "scrapes": len(scrapes),
              "scrape_mfu": last["train_mfu"],
              "scrape_tokens_per_sec": last["train_tokens_per_sec"],
              "recorder_mfu": summary["mfu"], "wall_clock_mfu": wall,
              "peak_flops": peak, "summary": summary,
              "launches": launches}
    emit(result)
    return result


def eval_phase(torch, dev, np, ckpt_dir: str, tmp_dir: str,
               batch: int = 2, seq: int = 1024, batches: int = 2) -> dict:
    """cli/eval.py on the ckpt phase's checkpoint and a token file
    written with training/dataset.py, against loss_fn on the same
    weights and batches."""
    import io

    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli import eval as eval_cli
    from container_engine_accelerators_tpu_torch.models.convert import (
        load_model,
    )
    from container_engine_accelerators_tpu_torch.training import dataset
    from container_engine_accelerators_tpu_torch.training.train import (
        loss_fn,
        to_device,
    )

    model, cfg = load_model(ckpt_dir, device=dev)
    path = os.path.join(tmp_dir, "eval_tokens.bin")
    rng = np.random.default_rng(SEED + 13)
    dataset.write_token_file(rng.integers(0, cfg.vocab_size,
                                          size=8 * seq + 1),
                             path, cfg.vocab_size)
    out = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = eval_cli.main(["--checkpoint", ckpt_dir, "--data", path,
                            "--batch-size", str(batch), "--seq-len",
                            str(seq), "--batches", str(batches),
                            "--device", str(dev)])
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    with torch.no_grad():
        want = float(np.mean([
            loss_fn(model, to_device(b, dev), cfg).item()
            for b in dataset.token_file_batches(path, batch, seq,
                                                num_batches=batches)]))
    del model
    _free_card(torch)
    rel = abs(report["eval_loss"] - want) / abs(want)
    require(rc == 0 and report["batches"] == batches and
            math.isfinite(report["eval_loss"]) and rel <= EVAL_RTOL,
            f"eval: {report} against loss_fn {want}")
    require(launches.get("flash_fwd", 0) == cfg.n_layers * batches,
            f"eval: flash_fwd launches {launches}")
    result = {"phase": "eval", **report, "loss_fn": want,
              "rel_diff": rel, "rtol": EVAL_RTOL, "n_layers": cfg.n_layers,
              "batch": batch, "seq": seq, "seconds": seconds,
              "launches": launches}
    emit(result)
    return result


def serve_ckpt_phase(torch, dev, np, ckpt_dir: str, n_new: int = 16
                     ) -> dict:
    """load_model(<ckpt dir>) behind make_server on the paged engine,
    one request, against generate on the same weights (held by the
    divergence rule at SERVE_CKPT_D); the same on the int8 copy of the
    weights (K2); cli/generate.py --checkpoint gives generate's tokens."""
    import io

    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli import (
        generate as generate_cli,
    )
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.models.convert import (
        load_model,
    )
    from container_engine_accelerators_tpu_torch.ops.quant import (
        quantize_llama_params,
    )

    model, cfg = load_model(ckpt_dir, device=dev)
    prompt = _prompts(np, cfg, SEED + 17)(128)
    req = {"tokens": prompt, "max_new_tokens": n_new}
    runs, launches = {}, {}
    for weights in ("bf16", "int8"):
        m = model if weights == "bf16" else quantize_llama_params(model)
        kernels.reset_launches()
        ref, margins = greedy_margins(torch, dev, m, cfg, prompt, n_new)
        gen = decode.generate(m, torch.tensor([prompt], device=dev), cfg,
                              n_new)[0].tolist()
        require(gen == ref, f"serve_ckpt {weights}: generate {gen} "
                            f"against its own loop {ref}")
        with serving(paged_engine(m, cfg)) as url:
            ans, _, _ = _post(url, req)
        torch.cuda.synchronize()
        got = _answer_tokens(req, ans)
        _check_answer(got, prompt, n_new, cfg.vocab_size,
                      f"serve_ckpt {weights}")
        rule = divergence_rule([ref], [got], [prompt], [margins],
                               SERVE_CKPT_D, f"serve_ckpt {weights}")
        runs[weights] = {"tokens_equal_generate": got == ref, **rule,
                         "generate_tokens": ref[len(prompt):],
                         "served_tokens": got[len(prompt):],
                         "launches": dict(kernels.launches)}
        for name, n in kernels.launches.items():
            launches[name] = launches.get(name, 0) + n
        del m
    require(runs["int8"]["launches"].get("int8_matmul", 0) > 0 and
            runs["bf16"]["launches"].get("paged_decode_attention", 0) > 0
            and runs["bf16"]["launches"].get("decode_attention", 0) > 0,
            f"serve_ckpt: launches {runs['bf16']['launches']} "
            f"{runs['int8']['launches']}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = generate_cli.main(["--checkpoint", ckpt_dir, "--prompt-ids",
                                ",".join(map(str, prompt)),
                                "--max-new-tokens", str(n_new),
                                "--device", str(dev)])
    cli_tokens = json.loads(out.getvalue().split("token ids:")[1].strip())
    require(rc == 0 and cli_tokens == prompt + runs["bf16"][
        "generate_tokens"], f"serve_ckpt: generate --checkpoint gave "
                            f"{cli_tokens[len(prompt):]}")
    del model
    _free_card(torch)
    result = {"phase": "serve_ckpt", "n_layers": cfg.n_layers,
              "prompt_len": len(prompt), "new_tokens": n_new,
              "bf16": runs["bf16"], "int8": runs["int8"],
              "cli_generate_equal": True, "launches": launches}
    emit(result)
    return result


def train_cli_phase() -> dict:
    import io

    from container_engine_accelerators_tpu_torch.cli import train

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--preset", "tiny", "--steps", "3"])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    require(rc == 0 and line["final_step"] == 3 and
            math.isfinite(line["loss"]), f"train cli: {rc} {line}")
    result = {"phase": "train_cli", **line}
    emit(result)
    return result


class RecordingK8s:
    """The health checker's duck-typed Kubernetes client, recording what
    it is asked to write."""

    def __init__(self, node_name: str):
        self.events: list = []
        self.nodes = {node_name: {"metadata": {"name": node_name},
                                  "status": {"conditions": []}}}

    def create_event(self, namespace: str, body: dict) -> None:
        self.events.append(body)

    def set_node_condition(self, node_name: str, cond: dict) -> None:
        conds = self.nodes[node_name]["status"]["conditions"]
        conds[:] = [c for c in conds if c["type"] != cond["type"]] + [cond]

    def get_node(self, node_name: str) -> dict:
        return self.nodes[node_name]


def provoke_all() -> dict:
    """The real-fault runs of demo/real_fault/capture.py, each in a
    process of its own and all at once: name -> (exit code, stderr)."""
    from container_engine_accelerators_tpu_torch.demo.real_fault import (
        capture,
    )

    with concurrent.futures.ThreadPoolExecutor(len(capture.RUNS)) as pool:
        futs = {name: pool.submit(capture.provoke, name, 300)
                for name in capture.RUNS}
        return {name: fut.result() for name, fut in futs.items()}


K7_ROUNDS = 5


def k7_times(torch, x) -> dict:
    """K7 and torch.mul(x, 2.0) timed in turns, K7_ROUNDS each: their
    median device ms and every run's."""
    import statistics

    from container_engine_accelerators_tpu_torch.ops.scale_demo import (
        scale_demo_cuda,
    )

    runs = {"ms": [], "library_ms": []}
    for _ in range(K7_ROUNDS):
        runs["ms"].append(device_ms(torch, lambda: scale_demo_cuda(x)))
        runs["library_ms"].append(device_ms(torch,
                                            lambda: torch.mul(x, 2.0)))
    return {**{key: statistics.median(v) for key, v in runs.items()},
            **{f"{key}_runs": v for key, v in runs.items()}}


def health_phase(torch, dev, tmp_dir: str, shape=(4096, 4096)) -> dict:
    """The node health path on the card. The healthy K7 runs as the
    node's workload (the one launch counted); then K7 built with the
    whole array as one shared-memory tile, an allocation larger than the
    card and a benign bf16 matmul run as processes of their own, their
    stderr is the runtime log, and a TPUHealthChecker over a TPUManager
    of the host's real /dev scrapes it: VMEM_OOM and HBM_OOM counted,
    every device still Healthy. Then cli.inject_fault appends
    HBM_ECC_UNCORRECTABLE for card 0 to the checker's JSONL feed: nvidia0
    turns Unhealthy, with one Warning Event and the node condition. Last,
    K7 against its plain version x * 2.0 (exact) and timed."""
    import io

    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli import inject_fault
    from container_engine_accelerators_tpu_torch.deviceplugin import (
        HEALTHY,
        UNHEALTHY,
        SysfsDeviceInfo,
        TPUConfig,
        TPUManager,
    )
    from container_engine_accelerators_tpu_torch.healthcheck import (
        TPUHealthChecker,
    )
    from container_engine_accelerators_tpu_torch.healthcheck.health_checker import (
        NODE_CONDITION_TYPE,
    )
    from container_engine_accelerators_tpu_torch.ops.scale_demo import (
        scale_demo,
        scale_demo_plain,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(shape, generator=g, device=dev)
    runtime_log = os.path.join(tmp_dir, "runtime.log")
    feed = os.path.join(tmp_dir, "errors.jsonl")
    open(feed, "w").close()

    kernels.reset_launches()
    y = scale_demo(x)
    torch.cuda.synchronize()
    runs = provoke_all()
    with open(runtime_log, "w") as f:
        for name in ("smem_oom", "hbm_oom", "benign_success"):
            f.write(runs[name][1])
    cfg = TPUConfig(runtime_log_path=runtime_log)
    cfg.validate()
    manager = TPUManager(cfg, SysfsDeviceInfo())
    manager.discover()
    devices = {d.ID: d.health for d in manager.snapshot()}
    k8s = RecordingK8s("smoke-node")
    checker = TPUHealthChecker(manager, cfg, k8s=k8s,
                               node_name="smoke-node",
                               error_log_path=feed)
    checker.maybe_reset_condition()
    checker.poll_once()
    summary = checker.error_summary()
    health_after_faults = {d.ID: d.health for d in manager.snapshot()}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = inject_fault.main(["--chip", "0",
                                "--error-class", "HBM_ECC_UNCORRECTABLE",
                                "--error-log", feed])
    checker.poll_once()
    launches = dict(kernels.launches)
    health_after_ecc = {d.ID: d.health for d in manager.snapshot()}
    conds = k8s.nodes["smoke-node"]["status"]["conditions"]
    cond = next((c for c in conds if c["type"] == NODE_CONDITION_TYPE), {})

    for name, (code, text) in runs.items():
        require((code != 0) == (name != "benign_success"),
                f"health: {name} exited {code}: {text[-2000:]}")
    require("uses too much shared data" in runs["smem_oom"][1],
            f"health: smem_oom said {runs['smem_oom'][1][-2000:]}")
    require("CUDA out of memory" in runs["hbm_oom"][1],
            f"health: hbm_oom said {runs['hbm_oom'][1][-2000:]}")
    require(len(devices) >= 1, f"health: discovery found {devices}")
    counts = summary["counts"]
    require(counts.get("VMEM_OOM", 0) >= 1 and counts.get("HBM_OOM", 0) >= 1
            and set(counts) == {"VMEM_OOM", "HBM_OOM"}
            and not summary["critical_seen"],
            f"health: the real faults classified as {summary}")
    require(set(health_after_faults.values()) == {HEALTHY},
            f"health: devices after the real faults {health_after_faults}")
    require(rc == 0, f"health: inject_fault exited {rc}")
    backed = {d for d in devices if d == "nvidia0"
              or d.startswith("nvidia0/")}
    require(bool(backed) and all(
        (h == UNHEALTHY) == (d in backed)
        for d, h in health_after_ecc.items()),
        f"health: devices after HBM_ECC_UNCORRECTABLE on card 0 "
        f"{health_after_ecc}")
    warnings = [e for e in k8s.events if e["type"] == "Warning"]
    require(len(warnings) == 1
            and warnings[0]["reason"] == "HBM_ECC_UNCORRECTABLE",
            f"health: events {k8s.events}")
    payload = json.loads(cond.get("message", "{}"))
    require(cond.get("status") == "True"
            and payload.get("errors", {}).get("HBM_ECC_UNCORRECTABLE") == 1
            and payload.get("bootID") == checker.boot_id(),
            f"health: node condition {cond}")
    require(launches.get("scale_demo", 0) >= 1,
            f"health: K7 launches {launches}")

    want = scale_demo_plain(x)
    err = (y - want).abs().max().item()
    require(err == 0.0, f"health: K7 differs from x * 2.0 by {err}")
    n_bytes = 2 * x.numel() * x.element_size()
    bound, bound_by = bound_ms(n_bytes, x.numel(), "f32")
    result = {
        "phase": "health", "shape": list(shape), **k7_times(torch, x),
        "plain_ms": device_ms(torch, lambda: scale_demo_plain(x)),
        "library": "torch.mul(x, 2.0), which is also the plain version",
        "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
        "launches": launches,
        "provocations": {name: {"rc": code, "stderr_tail": text[-300:]}
                         for name, (code, text) in runs.items()},
        "discovered": devices,
        "torch_device_count": torch.cuda.device_count(),
        "chip_generation": manager.device_info.chip_generation(),
        "error_summary": summary, "health_after_ecc": health_after_ecc,
        "events": [(e["type"], e["reason"]) for e in k8s.events],
        "condition": {key: cond.get(key) for key in ("status", "reason",
                                                     "message")},
    }
    emit(result)
    return result


# ---------------------------------------------------------------- node

NODE_CHILD_BYTES = 8 << 30      # the container's extra allocation
NODE_CHILD_SECONDS = 6.0        # its K4 loop
NODE_METRICS_INTERVAL = 0.5     # the daemon's NVML sampling period, s
NODE_DUTY_MIN = 50.0            # % the busy card's duty cycle must pass
NODE_DUTY_GAP = 15.0            # points between /metrics and nvidia-smi
# The busy reading is taken once the loop has run longer than NVML's
# longest utilisation period (1 s) plus one of the daemon's refreshes, so
# neither /metrics nor nvidia-smi averages over the idle time before it.
NODE_DUTY_SETTLE_S = 1.0 + NODE_METRICS_INTERVAL
# Bytes between /metrics and nvidia-smi: nvmlDeviceGetMemoryInfo (the
# reference's call) counts the driver's reserve as used, nvidia-smi does
# not (480 MiB on an H100 with driver 580.159.03: NVML 503316480 bytes
# used on an idle card where nvidia-smi reads 0 MiB).
NODE_MEMORY_GAP = 512 << 20
NODE_FLIP_S = 5.0               # injected fault -> Unhealthy on the stream,
                                # beyond one of the checker's default polls
NODE_REREGISTER_S = 10.0        # a restart trigger -> a new Register
NODE_STOP_S = 10.0              # SIGTERM -> the daemon gone
NODE_POD = {"namespace": "ns", "pod": "pod", "container": "ctr"}

# The allocated container's workload: K4 (ops/flash_attention) at the
# flash phase's shape in a loop, beside an allocation of argv[1] bytes,
# for argv[2] seconds. It prints one line when the loop starts and one
# with its card's UUID, device count and K4 launches at the end.
NODE_CHILD = r"""
import json, os, sys, time
import torch
from container_engine_accelerators_tpu_torch import kernels
from container_engine_accelerators_tpu_torch.ops.flash_attention import (
    flash_attention)
dev = torch.device("cuda", 0)
hold = torch.empty(int(sys.argv[1]), dtype=torch.uint8, device=dev)
g = torch.Generator(device=dev).manual_seed(0)
q = torch.randn(4, 2048, 32, 128, generator=g, device=dev).bfloat16()
k = torch.randn(4, 2048, 8, 128, generator=g, device=dev).bfloat16()
v = torch.randn(4, 2048, 8, 128, generator=g, device=dev).bfloat16()
out = flash_attention(q, k, v, causal=True)
torch.cuda.synchronize()
kernels.reset_launches()
print(json.dumps({"running": True}), flush=True)
t0, iters = time.monotonic(), 0
while time.monotonic() - t0 < float(sys.argv[2]):
    for _ in range(20):
        out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    iters += 20
print(json.dumps({
    "uuid": "GPU-" + str(torch.cuda.get_device_properties(0).uuid),
    "device_count": torch.cuda.device_count(),
    "launches": kernels.launches.get("flash_fwd", 0), "iters": iters,
    "seconds": time.monotonic() - t0,
    "finite": bool(torch.isfinite(out.float()).all()),
    "held_bytes": hold.numel()}), flush=True)
"""


def port_root() -> str:
    """The checkout that holds the port's package."""
    import container_engine_accelerators_tpu_torch as port

    return os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))


def loaded_library_path() -> str | None:
    """The file of the NVML library this process has mapped (after an
    Nvml() over the real library), from /proc/self/maps."""
    try:
        with open("/proc/self/maps") as f:
            for line in f:
                path = line.split()[-1] if line.strip() else ""
                if os.path.basename(path).startswith("libnvidia-ml.so"):
                    return path
    except OSError:
        pass
    return None


def gpu_query(fields: str, card: str) -> list[str]:
    """One card's `nvidia-smi --query-gpu=FIELDS` (no units), the card
    named by UUID."""
    out = subprocess.run(
        ["nvidia-smi", "-i", card, f"--query-gpu={fields}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return [x.strip() for x in out.stdout.strip().splitlines()[0].split(",")]


class KubeletStub:
    """A kubelet's Registration service on a unix socket, recording each
    Register with the time it came."""

    def __init__(self, sock: str):
        import queue

        import grpc

        from container_engine_accelerators_tpu_torch.deviceplugin.api import (
            RegistrationServicer,
            add_registration_servicer,
        )

        from container_engine_accelerators_tpu_torch.deviceplugin.api import (
            deviceplugin_pb2 as pb,
        )

        stub = self

        class Servicer(RegistrationServicer):
            def Register(self, request, context):
                stub.registrations.put((time.monotonic(), request))
                return pb.Empty()

        self.sock = sock
        self.registrations = queue.Queue()
        self.server = grpc.server(concurrent.futures.ThreadPoolExecutor(2))
        add_registration_servicer(Servicer(), self.server)
        self.server.add_insecure_port(f"unix://{sock}")
        self.server.start()

    def wait(self, timeout_s: float, what: str):
        """(time, RegisterRequest) of the next registration."""
        import queue

        try:
            return self.registrations.get(timeout=timeout_s)
        except queue.Empty:
            raise SmokeFailure(f"node: no registration within {timeout_s} s "
                               f"({what})") from None

    def stop(self) -> None:
        self.server.stop(grace=0.2).wait()
        # gRPC unlinks the socket as its listener closes; wait for that,
        # or a later unlink could remove the next stub's socket.
        deadline = time.monotonic() + 5
        while os.path.exists(self.sock) and time.monotonic() < deadline:
            time.sleep(0.01)
        with contextlib.suppress(FileNotFoundError):
            os.unlink(self.sock)


class PodResourcesServer:
    """The kubelet's PodResources service answering one container that
    holds `device_id` of `nvidia.com/gpu`."""

    def __init__(self, sock: str, device_id: str):
        import grpc

        from container_engine_accelerators_tpu_torch import GPU_RESOURCE_NAME
        from container_engine_accelerators_tpu_torch.metrics import (
            podresources_pb2 as pb,
        )
        from container_engine_accelerators_tpu_torch.metrics.devices import (
            add_podresources_servicer,
        )

        answer = pb.ListPodResourcesResponse(pod_resources=[
            pb.PodResources(
                name=NODE_POD["pod"], namespace=NODE_POD["namespace"],
                containers=[pb.ContainerResources(
                    name=NODE_POD["container"], devices=[
                        pb.ContainerDevices(resource_name=GPU_RESOURCE_NAME,
                                            device_ids=[device_id])])])])

        class Servicer:
            def List(self, request, context):
                return answer

        self.server = grpc.server(concurrent.futures.ThreadPoolExecutor(2))
        add_podresources_servicer(Servicer(), self.server)
        self.server.add_insecure_port(f"unix://{sock}")
        self.server.start()

    def stop(self) -> None:
        self.server.stop(grace=0.2).wait()


class PluginProcess:
    """cli/device_plugin_main.py in a process of its own, its output in
    `log_path`; stop() sends SIGTERM."""

    def __init__(self, argv: list[str], log_path: str):
        self.log_path = log_path
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.cli.device_plugin_main",
             *argv], cwd=port_root(), stdout=self._log,
            stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=port_root()))

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self, timeout_s: float) -> int | None:
        """SIGTERM; the exit code, or None if it had to be killed."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            rc = None
        self._log.close()
        return rc

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _opens(path: str) -> bool | str:
    """True if the node opens read-write, else the error."""
    try:
        os.close(os.open(path, os.O_RDWR))
        return True
    except OSError as e:
        return f"{type(e).__name__}: {e.strerror}"


def _lines(stream, out) -> None:
    for line in stream:
        out.put((time.monotonic(), line))


def _watch(call, out) -> None:
    """Each ListAndWatch response as (time, {ID: health}); the error
    that ends the stream last."""
    import grpc

    try:
        for resp in call:
            out.put((time.monotonic(),
                     {d.ID: d.health for d in resp.devices}))
    except grpc.RpcError as e:
        out.put((time.monotonic(), e))


def _next_snapshot(q, timeout_s: float, what: str):
    import queue

    try:
        t, snap = q.get(timeout=timeout_s)
    except queue.Empty:
        raise SmokeFailure(f"node: no ListAndWatch response within "
                           f"{timeout_s} s ({what})") from None
    require(isinstance(snap, dict), f"node: the stream ended: {snap}")
    return t, snap


NRI_REGISTER_S = 30.0           # the injector's start -> RegisterPlugin
NRI_PLUGIN = ("tpu-device-injector", "10")   # nri/daemon.py's defaults


def nri_step(tmp_dir: str, nodes: list[str]) -> dict:
    """The port's NRI device injector (nri/daemon.py) as a process on a
    socket in tmp_dir, against this process's fake runtime on the port's
    ttrpc transport: RegisterPlugin (timed from the start), Configure
    (CreateContainer subscribed), Synchronize, CreateContainer for a pod
    whose devices.gke.io/container.sidecar annotation lists `nodes` (each
    must come back as a char device with the type, major, minor, uid and
    gid os.stat gives), then one listing a node that is not there (an
    RPC error, as in the JAX package)."""
    import queue
    import socket
    import stat

    from container_engine_accelerators_tpu_torch.nri import (
        ANNOTATION_PREFIX,
        ttrpc,
    )
    from container_engine_accelerators_tpu_torch.nri import (
        nri_api_pb2 as api,
    )
    from container_engine_accelerators_tpu_torch.nri.daemon import (
        CREATE_CONTAINER_MASK,
        PLUGIN_SERVICE,
        RUNTIME_SERVICE,
    )

    sock_path = os.path.join(tmp_dir, "nri.sock")
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(sock_path)
    listener.listen(1)
    listener.settimeout(NRI_REGISTER_S)
    registered: queue.Queue = queue.Queue()

    def register(payload):
        registered.put((time.monotonic(),
                        api.RegisterPluginRequest.FromString(payload)))
        return api.Empty().SerializeToString()

    log_path = os.path.join(tmp_dir, "nri.log")
    t_start = time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.nri.daemon",
             "--nri-socket", sock_path], cwd=port_root(), stdout=log,
            stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=port_root()))
    mux = server = None
    try:
        try:
            conn, _ = listener.accept()
        except TimeoutError:
            raise SmokeFailure(f"nri: the injector did not connect in "
                               f"{NRI_REGISTER_S} s") from None
        mux = ttrpc.Mux(conn)
        server = ttrpc.TtrpcServer(mux.conn(ttrpc.RUNTIME_SERVICE_CONN), {
            RUNTIME_SERVICE: {"RegisterPlugin": register}})
        client = ttrpc.TtrpcClient(mux.conn(ttrpc.PLUGIN_SERVICE_CONN))
        try:
            t_reg, req = registered.get(timeout=NRI_REGISTER_S)
        except queue.Empty:
            raise SmokeFailure("nri: no RegisterPlugin") from None
        require((req.plugin_name, req.plugin_idx) == NRI_PLUGIN,
                f"nri: registered {req}")
        conf = api.ConfigureResponse.FromString(client.call(
            PLUGIN_SERVICE, "Configure", api.ConfigureRequest(
                runtime_name="chip_smoke", runtime_version="0")
            .SerializeToString()))
        require(conf.events & CREATE_CONTAINER_MASK,
                f"nri: Configure subscribed {conf.events}")
        client.call(PLUGIN_SERVICE, "Synchronize",
                    api.SynchronizeRequest().SerializeToString())

        def create(paths):
            pod = api.PodSandbox(name="train", namespace="ml")
            pod.annotations[ANNOTATION_PREFIX + "sidecar"] = "".join(
                f"- path: {p}\n" for p in paths)
            return client.call(PLUGIN_SERVICE, "CreateContainer",
                               api.CreateContainerRequest(
                                   pod=pod,
                                   container=api.Container(name="sidecar"))
                               .SerializeToString())

        t0 = time.perf_counter()
        try:
            resp = api.CreateContainerResponse.FromString(create(nodes))
        except RuntimeError as e:
            raise SmokeFailure(f"nri: CreateContainer for {nodes}: {e}") \
                from None
        create_ms = (time.perf_counter() - t0) * 1e3
        injected = []
        for d, path in zip(resp.adjust.linux.devices, nodes):
            st = os.stat(path)
            injected.append({
                "path": d.path, "type": d.type, "major": d.major,
                "minor": d.minor, "uid": d.uid.value, "gid": d.gid.value,
                "file_mode": d.file_mode.value
                if d.HasField("file_mode") else None,
                "stat_mode": oct(st.st_mode)})
            require(stat.S_ISCHR(st.st_mode) and d.path == path
                    and d.type == "c"
                    and (d.major, d.minor) == (os.major(st.st_rdev),
                                               os.minor(st.st_rdev))
                    and (d.uid.value, d.gid.value) == (st.st_uid,
                                                       st.st_gid),
                    f"nri: {path} injected as {d}, stat {st}")
        require(len(injected) == len(nodes),
                f"nri: {len(injected)} devices for {nodes}")
        absent = os.path.join(tmp_dir, "nvidia-absent")
        try:
            create([absent])
            raise SmokeFailure(f"nri: {absent} injected without an error")
        except RuntimeError as e:
            missing_error = str(e)
        require("rpc error 13" in missing_error
                and "cannot inject" in missing_error,
                f"nri: the absent node gave {missing_error}")
    finally:
        if server is not None:
            server.stop()
        if mux is not None:
            mux.close()
        listener.close()
        proc.terminate()
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return {"registration_s": t_reg - t_start, "plugin": list(NRI_PLUGIN),
            "create_container_ms": create_ms, "injected": injected,
            "absent_node_error": missing_error}


class _JsonStub:
    """An HTTP server on 127.0.0.1 in a thread; `handle(method, path,
    query, body)` answers (status, JSON body)."""

    def __init__(self, handle):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _answer(self):
                url = urlparse(self.path)
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n)) if n else None
                status, out = handle(self.command, url.path,
                                     parse_qs(url.query), body,
                                     dict(self.headers))
                data = (out if isinstance(out, bytes)
                        else json.dumps(out).encode())
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_PUT = do_PATCH = do_DELETE = _answer

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = "http://127.0.0.1:%d" % self.server.server_address[1]

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class ApiStub(_JsonStub):
    """The Kubernetes API calls the scheduler and the labeler make, over
    an object store of nodes and pods: list (pods by status.phase), get,
    replace and delete a pod, merge-patch a node."""

    def __init__(self):
        self.nodes: dict = {}
        self.pods: dict = {}
        self.requests: list = []
        super().__init__(self._handle)

    def _handle(self, method, path, query, body, headers):
        self.requests.append((method, path))
        parts = path.strip("/").split("/")
        if path == "/api/v1/nodes" and method == "GET":
            return 200, {"items": list(self.nodes.values())}
        if parts[:3] == ["api", "v1", "nodes"] and method == "PATCH":
            node = self.nodes.setdefault(parts[3], {
                "metadata": {"name": parts[3]}, "status": {}})
            node["metadata"].setdefault("labels", {}).update(
                body.get("metadata", {}).get("labels", {}))
            return 200, node
        if path == "/api/v1/pods" and method == "GET":
            phase = [c.split("=", 1)[1] for c in query.get(
                "fieldSelector", [""])[0].split(",")
                if c.startswith("status.phase=")]
            return 200, {"items": [
                p for p in self.pods.values()
                if not phase or p["status"]["phase"] == phase[0]]}
        if parts[:3] == ["api", "v1", "namespaces"] and parts[4:5] == [
                "pods"] and len(parts) == 6:
            key = (parts[3], parts[5])
            if key not in self.pods:
                return 404, {"message": "not found"}
            if method == "GET":
                return 200, self.pods[key]
            if method == "PUT":
                self.pods[key] = body
                return 200, body
            if method == "DELETE":
                return 200, self.pods.pop(key)
        return 404, {"message": f"{method} {path}"}


class MetadataStub(_JsonStub):
    """The GCE metadata server's instance attributes (403 without the
    Metadata-Flavor header, 404 for an attribute it does not have)."""

    def __init__(self, attrs: dict):
        def handle(method, path, query, body, headers):
            value = attrs.get(path.rsplit("/", 1)[-1])
            if headers.get("Metadata-Flavor") != "Google":
                return 403, b""
            return (200, value.encode()) if value is not None else (404,
                                                                     b"")

        super().__init__(handle)


def scheduler_step(n_cards: int) -> dict:
    """The topology scheduler, which touches no device: the labeler's
    topology_labels from a local metadata stub patched onto this machine's
    node in a local API stub (nvidia.com/gpu allocatable: the device
    plugin's `n_cards`), two labelled fake nodes beside it (one in its
    slice, one in another rack), and schedule_daemon.run_once ungating a
    gang of 2 pods of `n_cards` cards each: this node and its slice
    neighbour, the gates gone, the placement annotated."""
    import socket

    from container_engine_accelerators_tpu_torch import GPU_RESOURCE_NAME
    from container_engine_accelerators_tpu_torch.k8s import K8sClient
    from container_engine_accelerators_tpu_torch.scheduler import (
        label_nodes,
    )
    from container_engine_accelerators_tpu_torch.scheduler import (
        schedule_daemon as sd,
    )
    from container_engine_accelerators_tpu_torch.scheduler import (
        topology as t,
    )

    host = socket.gethostname() or "smoke-node"
    md = MetadataStub({"physical_host": f"/smoke-cluster/rack-0/{host}",
                       "tpu-env-slice-id": "slice-0",
                       "tpu-env-host-coords": "0,0,0"})
    api = ApiStub()
    gate = sd.GATE_PREFIX + "smoke"

    def node(name, labels):
        return {"metadata": {"name": name, "labels": labels},
                "status": {"allocatable": {GPU_RESOURCE_NAME: str(n_cards),
                                           "cpu": "8", "memory": "64Gi"},
                           "conditions": [{"type": "Ready",
                                           "status": "True"}]}}

    try:
        api.nodes[host] = node(host, {})
        k8s = K8sClient(api.url)
        labels = label_nodes.update_node_labels(k8s, host, md.url)
        want = {t.LABEL_CLUSTER: "smoke-cluster", t.LABEL_RACK: "rack-0",
                t.LABEL_HOST: host, t.LABEL_SLICE: "slice-0",
                t.LABEL_ICI_COORDS: "0-0-0"}
        require(labels == want
                and api.nodes[host]["metadata"]["labels"] == want,
                f"scheduler: labels {labels}, want {want}")
        api.nodes["fake-near"] = node("fake-near", {
            **want, t.LABEL_HOST: "fake-near", t.LABEL_ICI_COORDS: "1-0-0"})
        api.nodes["fake-far"] = node("fake-far", {
            t.LABEL_CLUSTER: "smoke-cluster", t.LABEL_RACK: "rack-1",
            t.LABEL_HOST: "fake-far"})
        for i in range(2):
            api.pods[("default", f"smoke-{i}")] = {
                "metadata": {"name": f"smoke-{i}", "namespace": "default",
                             "labels": {"job-name": "smoke"},
                             "annotations": {}},
                "spec": {"schedulingGates": [{"name": gate}],
                         "containers": [{"name": "main", "resources": {
                             "requests": {GPU_RESOURCE_NAME:
                                          str(n_cards)}}}]},
                "status": {"phase": "Pending"}}
        t0 = time.perf_counter()
        scheduled = sd.run_once(k8s)
        run_once_ms = (time.perf_counter() - t0) * 1e3
        placed = {name: sd.assigned_node(p)
                  for (_, name), p in api.pods.items()}
        require(scheduled == 2 and sorted(placed.values()) == sorted(
            [host, "fake-near"]), f"scheduler: run_once {scheduled}, "
            f"placed {placed}")
        for (_, name), p in api.pods.items():
            require(p["spec"]["schedulingGates"] == []
                    and p["metadata"]["annotations"].get(
                        sd.PLACED_ANNOTATION) == gate,
                    f"scheduler: {name} left as {p}")
        puts = sum(1 for m, _ in api.requests if m == "PUT")
        require(puts == 2, f"scheduler: {puts} pod replaces")
    finally:
        md.stop()
        api.stop()
    return {"node": host, "n_cards": n_cards, "labels": labels,
            "placed": placed, "run_once": scheduled,
            "run_once_ms": run_once_ms, "requests": len(api.requests)}


def node_phase(torch, dev, tmp_dir: str, dev_root: str = "/dev",
               child_code: str = NODE_CHILD,
               child_seconds: float = NODE_CHILD_SECONDS,
               child_bytes: int = NODE_CHILD_BYTES,
               nri_nodes: list[str] | None = None) -> dict:
    """The node layer on the card: discovery through NVML and torch's
    card among the /dev nodes; the device plugin daemon
    (cli/device_plugin_main.py, metrics and health on) registering with
    a kubelet stub; Allocate's answer for torch's card started as a
    container (a process with exactly those envs running K4); its NVML
    duty cycle and memory on /metrics, attributed through a PodResources
    stub, beside nvidia-smi; an injected HBM_ECC_UNCORRECTABLE on the
    open ListAndWatch stream; both restart triggers; partition_tpu,
    runtime_ready and the driver version; SIGTERM; then the NRI injector
    granting torch's card's nodes (nri_step; `nri_nodes` in their place
    for a rehearsal) and the topology scheduler (scheduler_step)."""
    import io
    import queue

    import grpc

    from container_engine_accelerators_tpu_torch.cli import (
        inject_fault,
        partition_tpu,
        runtime_ready,
    )
    from container_engine_accelerators_tpu_torch.deviceplugin import (
        HEALTHY,
        UNHEALTHY,
        SysfsDeviceInfo,
        TPUConfig,
        TPUManager,
    )
    from container_engine_accelerators_tpu_torch.deviceplugin import (
        manager as mgr,
    )
    from container_engine_accelerators_tpu_torch.deviceplugin.api import (
        DevicePluginStub,
        deviceplugin_pb2 as pb,
    )
    from container_engine_accelerators_tpu_torch.deviceplugin.devutil import (
        torch_card_minor,
    )
    from container_engine_accelerators_tpu_torch.deviceplugin.version_visibility import (
        read_driver_version,
    )
    from container_engine_accelerators_tpu_torch.healthcheck import (
        TPUHealthChecker,
    )
    from container_engine_accelerators_tpu_torch.utils import nvml

    # The daemon's checker polls at its default: a fault reaches the
    # stream within one poll.
    health_poll_s = inspect.signature(TPUHealthChecker).parameters[
        "poll_interval"].default

    # 1. Discovery: NVML's cards, the /dev nodes, torch's card.
    try:
        session = nvml.Nvml()
        cards = session.cards()
        driver = session.driver_version()
    except nvml.NvmlError as e:
        raise SmokeFailure(f"node: NVML: {e}") from None
    minor = torch_card_minor(torch, 0, cards)
    require(minor is not None,
            f"node: torch's card 0 is none of NVML's cards {cards}")
    card = cards[minor]
    dev_id = f"{mgr.PHYSICAL_PREFIX}{minor}"
    info = SysfsDeviceInfo(dev_root=dev_root, nvml=session)
    nodes = [{"node": os.path.basename(c.dev_path), "minor": c.index,
              "opens": _opens(c.dev_path), "pci_address": c.pci_address,
              "uuid": c.uuid, "in_nvml": c.index in cards,
              "torch_card": c.index == minor} for c in info.discover()]
    require(any(n["torch_card"] for n in nodes),
            f"node: torch's card nvidia{minor} is not under {dev_root}: "
            f"{nodes}")
    generation = info.chip_generation()
    require(generation == card.name != "unknown",
            f"node: chip_generation {generation!r}, NVML {card.name!r}")

    # 2. A node that does not open, or that NVML does not name for this
    # process, would fail runtime_ready and hand a container a card it
    # cannot open: serve a root of links to the nodes NVML names.
    trouble = [n["node"] for n in nodes
               if n["opens"] is not True or not n["in_nvml"]]
    root = dev_root
    if trouble:
        root = os.path.join(tmp_dir, "dev")
        os.makedirs(root)
        for name in [f"{mgr.PHYSICAL_PREFIX}{m}" for m in sorted(cards)] \
                + list(mgr.CONTROL_NODES):
            if os.path.exists(os.path.join(dev_root, name)):
                os.symlink(os.path.join(dev_root, name),
                           os.path.join(root, name))
    control = [n for n in mgr.CONTROL_NODES
               if os.path.exists(os.path.join(root, n))]
    served = TPUManager(TPUConfig(), SysfsDeviceInfo(dev_root=root,
                                                     nvml=session))
    served.discover()
    want_devices = {d.ID: d.health for d in served.snapshot()}

    # 3. Serve: the daemon with metrics and health, a kubelet stub and a
    # PodResources stub that gives torch's card to ns/pod/ctr.
    plugin_dir = os.path.join(tmp_dir, "device-plugin")
    os.makedirs(plugin_dir)
    sock = os.path.join(plugin_dir, mgr.PLUGIN_SOCKET)
    require(len(os.path.join(tmp_dir, "podresources.sock")) < 100,
            f"node: {tmp_dir} is too long a directory for unix sockets")
    kubelet_sock = os.path.join(plugin_dir, mgr.KUBELET_SOCKET)
    kubelet = KubeletStub(kubelet_sock)
    pr_sock = os.path.join(tmp_dir, "podresources.sock")
    pod_resources = PodResourcesServer(pr_sock, dev_id)
    feed = os.path.join(tmp_dir, "errors.jsonl")
    open(feed, "w").close()
    port = _free_port()
    url = f"http://127.0.0.1:{port}/metrics"
    t_start = time.monotonic()
    plugin = PluginProcess([
        "--dev-root", root, "--device-plugin-path", plugin_dir,
        "--config-file", os.path.join(tmp_dir, "absent.json"),
        "--enable-metrics", "--metrics-port", str(port),
        "--metrics-interval", str(NODE_METRICS_INTERVAL),
        "--podresources-socket", pr_sock, "--enable-health-monitoring",
        "--error-log", feed,
        "--wait-for-devices-timeout", "10"],
        os.path.join(tmp_dir, "plugin.log"))
    channel = call = child = None
    try:
        t_reg, req = kubelet.wait(120, "first registration")
        require(req.resource_name == "nvidia.com/gpu"
                and req.version == mgr.DEVICE_PLUGIN_API_VERSION
                and req.endpoint == mgr.PLUGIN_SOCKET,
                f"node: registered {req}")
        channel = grpc.insecure_channel(f"unix://{sock}")
        grpc.channel_ready_future(channel).result(timeout=30)
        client = DevicePluginStub(channel)
        stream = queue.Queue()
        call = client.ListAndWatch(pb.Empty())
        threading.Thread(target=_watch, args=(call, stream),
                         daemon=True).start()
        _, first = _next_snapshot(stream, 10, "first snapshot")
        require(first == want_devices
                and set(first.values()) == {HEALTHY},
                f"node: ListAndWatch {first}, discovered {want_devices}")
        preferred = client.GetPreferredAllocation(
            pb.PreferredAllocationRequest(container_requests=[
                pb.ContainerPreferredAllocationRequest(
                    available_deviceIDs=sorted(first)[::-1],
                    allocation_size=1)]))
        preferred = [list(r.deviceIDs) for r in
                     preferred.container_responses]
        require(len(preferred) == 1 and len(preferred[0]) == 1,
                f"node: GetPreferredAllocation {preferred}")
        t0 = time.perf_counter()
        resp = client.Allocate(pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest(devicesIDs=[dev_id])]))
        allocate_ms = (time.perf_counter() - t0) * 1e3
        cresp = resp.container_responses[0]
        envs = dict(cresp.envs)
        specs = [d.host_path for d in cresp.devices]
        mounts = [(m.container_path, m.host_path, m.read_only)
                  for m in cresp.mounts]
        torch_uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
        require(specs == [os.path.join(root, n) for n in [dev_id, *control]]
                and all(d.permissions == "mrw" for d in cresp.devices),
                f"node: Allocate's device specs {specs}")
        require(mounts == [(mgr.DEFAULT_DRIVER_CONTAINER_DIR,
                            mgr.DEFAULT_DRIVER_HOST_DIR, True)],
                f"node: Allocate's mounts {mounts}")
        require(envs == {"CUDA_VISIBLE_DEVICES": card.uuid,
                         mgr.MODEL_ENV: generation}
                and card.uuid == torch_uuid,
                f"node: Allocate's envs {envs}, torch's card {torch_uuid}")

        # 4. A container on the card: a process with exactly those envs.
        env = {k: v for k, v in os.environ.items()
               if k != "CUDA_VISIBLE_DEVICES"}
        env.update(envs, PYTHONPATH=port_root())
        child = subprocess.Popen(
            [sys.executable, "-c", child_code, str(child_bytes),
             str(child_seconds)], cwd=port_root(), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        lines = queue.Queue()
        threading.Thread(target=_lines, args=(child.stdout, lines),
                         daemon=True).start()
        try:
            t_loop, line = lines.get(timeout=300)
        except queue.Empty:
            raise SmokeFailure("node: the container did not start its "
                               "loop in 300 s") from None
        require(json.loads(line).get("running"),
                f"node: the container said {line}")

        # 5. /metrics while it runs, beside nvidia-smi in the same second.
        def value(values, name, labels):
            return values.get(name + "".join(
                f"{{{k}={v}}}" for k, v in sorted(labels.items())))

        def scrape():
            text = _get(url)
            node = {"tpu_chip": dev_id, "model": generation}
            pod = {**NODE_POD, **node}
            values = _scrape(text)
            return text, {
                "duty_cycle": value(values, "node_duty_cycle", node),
                "memory_used": value(values, "node_memory_used", node),
                "memory_total": value(values, "node_memory_total", node),
                "pod_duty_cycle": value(values, "duty_cycle", pod),
                "pod_memory_used": value(values, "memory_used", pod),
                "request_tpu_chips": value(values, "request_tpu_chips",
                                           NODE_POD)}

        deadline = time.monotonic() + child_seconds
        time.sleep(max(0.0, t_loop + NODE_DUTY_SETTLE_S - time.monotonic()))
        while True:
            text, busy = scrape()
            smi = gpu_query("utilization.gpu,memory.used", card.uuid)
            # A scrape may fall between the exporter's clear and refill.
            if ((busy["duty_cycle"] or 0) > NODE_DUTY_MIN
                    and (busy["memory_used"] or 0) > child_bytes
                    and busy["request_tpu_chips"] == 1) \
                    or time.monotonic() > deadline:
                break
            time.sleep(NODE_METRICS_INTERVAL / 2)
        busy["smi_utilization"] = float(smi[0])
        busy["smi_memory_used"] = float(smi[1]) * (1 << 20)
        require(busy["duty_cycle"] is not None
                and busy["duty_cycle"] > NODE_DUTY_MIN
                and abs(busy["duty_cycle"] - busy["smi_utilization"])
                <= NODE_DUTY_GAP,
                f"node: busy duty cycle {busy}")
        require(busy["memory_used"] > child_bytes
                and abs(busy["memory_used"] - busy["smi_memory_used"])
                <= NODE_MEMORY_GAP, f"node: busy memory {busy}")
        require(busy["pod_duty_cycle"] == busy["duty_cycle"]
                and busy["pod_memory_used"] == busy["memory_used"]
                and busy["request_tpu_chips"] == 1,
                f"node: the pod's attribution {busy}")
        require("# TYPE tpu_health_events_total counter" in text
                and "tpu_health_last_event_timestamp" in _scrape(text),
                "node: the health checker's families are not on /metrics")
        try:
            t_end, line = lines.get(timeout=child_seconds + 120)
        except queue.Empty:
            raise SmokeFailure("node: the container did not finish") \
                from None
        # The fall is timed from the end of the container's loop (its
        # last line), not from its exit, which comes later.
        while True:
            _, idle = scrape()
            if (idle["duty_cycle"] is not None
                    and idle["duty_cycle"] < busy["duty_cycle"] / 2) \
                    or time.monotonic() - t_end > 10:
                break
            time.sleep(NODE_METRICS_INTERVAL / 2)
        idle["fell_after_loop_s"] = time.monotonic() - t_end
        child_rc = child.wait(60)
        require(child_rc == 0, f"node: the container exited {child_rc}: "
                f"{child.stderr.read()[-2000:]}")
        ran = json.loads(line)
        require(ran["uuid"] == envs["CUDA_VISIBLE_DEVICES"]
                and ran["device_count"] == 1 and ran["launches"] > 0
                and ran["finite"], f"node: the container ran {ran}")
        require(idle["duty_cycle"] is not None
                and idle["duty_cycle"] < busy["duty_cycle"] / 2,
                f"node: the duty cycle did not fall: {busy} then {idle}")

        # 6. A fault reaches the open stream.
        while not stream.empty():
            stream.get_nowait()
        t_inject = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = inject_fault.main(["--chip", str(minor), "--error-class",
                                    "HBM_ECC_UNCORRECTABLE",
                                    "--error-log", feed])
        require(rc == 0, f"node: inject_fault exited {rc}")
        while True:
            t_flip, snap = _next_snapshot(
                stream, health_poll_s + NODE_FLIP_S
                - (time.monotonic() - t_inject),
                "the injected fault")
            if snap.get(dev_id) == UNHEALTHY:
                break
        flip_s = t_flip - t_inject
        deadline = time.monotonic() + 5
        while True:
            events = value(_scrape(_get(url)), "tpu_health_events_total",
                           {"error_class": "HBM_ECC_UNCORRECTABLE"})
            if events is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        require(events == 1.0, f"node: tpu_health_events_total {events}")

        # 7. The restart triggers: the socket removed, a kubelet restart.
        call.cancel()
        t0 = time.monotonic()
        os.unlink(sock)
        t_reg2, _ = kubelet.wait(NODE_REREGISTER_S, "after the socket went")
        socket_reregister_s = t_reg2 - t0
        kubelet.stop()
        t0 = time.monotonic()
        kubelet = KubeletStub(kubelet_sock)
        t_reg3, _ = kubelet.wait(NODE_REREGISTER_S, "after a kubelet restart")
        kubelet_reregister_s = t_reg3 - t0

        # 8. Partitioning, readiness and the driver version.
        part_cfg = os.path.join(tmp_dir, "etc", "tpu_config.json")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            part_rc = partition_tpu.main(["--dev-root", root, "--config-file",
                                          part_cfg, "--chips-per-partition",
                                          "1"])
            list_rc = partition_tpu.main(["--dev-root", root,
                                          "--config-file", part_cfg,
                                          "--list"])
        listing = out.getvalue().strip().splitlines()[-len(cards):]
        require(part_rc == list_rc == 0
                and any(f"  chips=[{dev_id}]" in row for row in listing),
                f"node: partition_tpu {part_rc} {list_rc} {listing}")
        ready = os.path.join(tmp_dir, "run", "ready")
        ready_rc = runtime_ready.main(["--dev-root", root, "--once",
                                       "--expected-chips", "1",
                                       "--ready-file", ready])
        with open(ready) as f:
            stamped = f.read()
        require(ready_rc == 0 and stamped == f"{len(cards)}\n",
                f"node: runtime_ready {ready_rc} {stamped!r}")
        host_ready_rc = None
        if trouble:
            host_ready_rc = runtime_ready.main([
                "--dev-root", dev_root, "--once", "--ready-file",
                os.path.join(tmp_dir, "run", "host-ready")])
        lib = loaded_library_path()
        read = read_driver_version(os.path.dirname(lib)) if lib else None
        smi_driver = gpu_query("driver_version", card.uuid)[0]
        require(read == smi_driver == driver,
                f"node: driver version {read} from {lib}, nvidia-smi "
                f"{smi_driver}, NVML {driver}")

        # 9. SIGTERM ends the daemon and removes its socket.
        t0 = time.monotonic()
        stop_rc = plugin.stop(NODE_STOP_S)
        stop_s = time.monotonic() - t0
        log = plugin.log()
        require(stop_rc == 0 and not os.path.exists(sock),
                f"node: the daemon exited {stop_rc} in {stop_s:.2f} s, "
                f"socket left {os.path.exists(sock)}: {log[-2000:]}")
        restarts = re.findall(r"stopped after (\d+) restarts", log)
        require(restarts and int(restarts[-1]) >= 2,
                f"node: restarts {restarts}: {log[-2000:]}")
        sources = sorted(set(re.findall(r"duty cycle of card \d+ from (\w+)",
                                        log)))
    finally:
        if call is not None:
            call.cancel()
        if channel is not None:
            channel.close()
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        if plugin.alive():
            plugin.stop(NODE_STOP_S)
        kubelet.stop()
        pod_resources.stop()
        session.close()
    nri = nri_step(tmp_dir, nri_nodes or [
        os.path.join(dev_root, name)
        for name in (dev_id, "nvidiactl", "nvidia-uvm")])
    sched = scheduler_step(len(want_devices))
    result = {
        "phase": "node", "nvidia_smi": nvidia_smi_line(),
        "nvml": {"driver_version": driver,
                 "cards": {m: {"name": c.name, "uuid": c.uuid,
                               "pci_address": c.pci_address}
                           for m, c in cards.items()}},
        "nodes": nodes, "torch_card_minor": minor, "trouble": trouble,
        "dev_root": root, "chip_generation": generation,
        "registration_s": t_reg - t_start, "allocate_ms": allocate_ms,
        "preferred": preferred,
        "allocate": {"devices": specs, "mounts": mounts, "envs": envs},
        "container": ran, "metrics": {"busy": busy, "idle": idle,
                                      "duty_cycle_sources": sources},
        "flip_s": flip_s, "health_poll_s": health_poll_s,
        "socket_reregister_s": socket_reregister_s,
        "kubelet_reregister_s": kubelet_reregister_s,
        "restarts": int(restarts[-1]), "stop_s": stop_s,
        "partition_listing": listing, "runtime_ready_rc": ready_rc,
        "host_runtime_ready_rc": host_ready_rc,
        "driver_version": {"read": read, "library": lib,
                           "nvidia_smi": smi_driver},
        "nri": nri, "scheduler": sched,
        "launches": {"flash_fwd": ran["launches"]},
    }
    emit(result)
    return result


# ---------------------------------------------------------------- vision

# The demo Jobs' contracts (demo/tpu-training/mnist-tpu.yaml,
# resnet-tpu.yaml): MNIST past 0.9 after 200 steps, the tiny ResNet past
# 0.5 after 60.
MNIST_STEPS, MNIST_MIN_ACC = 200, 0.9
RESNET_TINY_STEPS, RESNET_TINY_MIN_ACC = 60, 0.5
# ResNet-50's f32 logits on the card against the CPU's on the same
# variables and images, TF32 off: within 1e-3 of the largest |logit|
# (cuDNN and the CPU sum each convolution in other orders, in f32).
RESNET_CARD_CPU_RTOL = 1e-3
# ResNet-50 v1.5 at its published size (torchvision's, MLPerf's): 224^2
# RGB, batch 256 a step (it fits the card), Adam, 2 warmup steps and 10
# timed ones on 4 batches staged on the card before the clock starts.
RESNET_BATCH, RESNET_HW = 256, 224
RESNET_WARMUP, RESNET_STEPS, RESNET_STAGED = 2, 10, 4


def resnet_forward_flops(cfg, hw: int) -> int:
    """One image's forward FLOPs (2 a multiply-add) in ResNet `cfg`'s
    convolutions and fc at hw x hw, from their shapes (BN, ReLU, pools
    and adds left out)."""
    def conv(h, k, cin, cout, stride):
        out = -(-h // stride)
        return out, 2 * out * out * k * k * cin * cout

    h, flops = conv(hw, 7 if cfg.stem_pool else 3, 3, cfg.width,
                    2 if cfg.stem_pool else 1)
    if cfg.stem_pool:
        h = -(-h // 2)
    cin = cfg.width
    for si, n_blocks in enumerate(cfg.stage_sizes):
        planes = cfg.width * 2 ** si
        cout = planes * cfg.block_expansion
        for bi in range(n_blocks):
            stride = 2 if si > 0 and bi == 0 else 1
            shapes = ([(1, cin, planes, 1), (3, planes, planes, stride),
                       (1, planes, cout, 1)] if cfg.bottleneck else
                      [(3, cin, planes, stride), (3, planes, cout, 1)])
            out = h
            for k, ci, co, st in shapes:
                out, f = conv(out, k, ci, co, st)
                flops += f
            if stride != 1 or cin != cout:
                flops += conv(h, 1, cin, cout, stride)[1]
            h, cin = out, cout
    return flops + 2 * cin * cfg.num_classes


def resnet_card_vs_cpu(torch, dev, cfg=None, batch: int = 2,
                       hw: int = RESNET_HW) -> dict:
    """resnet50() (or `cfg`) in f32 on the card and on the CPU, the same
    variables (drawn from the seed on the CPU) and images, eval and train
    mode, TF32 off: the max |diff| of the logits against the bound; and
    the card's bf16 eval logits' distance from its f32 ones."""
    import copy
    import dataclasses

    from container_engine_accelerators_tpu_torch.models import resnet

    cfg16 = cfg or resnet.resnet50()
    cfg = dataclasses.replace(cfg16, dtype=torch.float32)
    cpu_model = resnet.init_variables(torch.Generator().manual_seed(SEED),
                                      cfg, "cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    images = next(resnet.synthetic_images(cfg, batch, hw, 1, seed=SEED))[
        "images"]
    out = {"batch": batch, "hw": hw, "rtol": RESNET_CARD_CPU_RTOL}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            # The same draws in bf16 compute: its eval logits' distance
            # from the f32 ones, before a train pass moves the statistics.
            bf16 = resnet.init_variables(
                torch.Generator().manual_seed(SEED), cfg16, "cpu").to(dev)
            got16, _ = resnet.apply(bf16, images.to(dev), train=False)
            for train in (False, True):
                want, _ = resnet.apply(cpu_model, images, train=train)
                got, _ = resnet.apply(card_model, images.to(dev),
                                      train=train)
                err = (got.cpu() - want).abs().max().item()
                scale = want.abs().max().item()
                mode = "train" if train else "eval"
                require(math.isfinite(err) and err <= RESNET_CARD_CPU_RTOL
                        * scale, f"vision: resnet50 f32 {mode} logits, card "
                        f"against CPU, max |diff| {err} > "
                        f"{RESNET_CARD_CPU_RTOL} x {scale}")
                out[mode] = {"max_abs_diff": err, "max_abs_logit": scale,
                             "rel": err / scale}
                if not train:
                    out["bf16_vs_f32_eval_rel"] = (
                        (got16 - got).abs().max() / got.abs().max()).item()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    del cpu_model, card_model, bf16
    _free_card(torch)
    return out


def resnet_train_timing(torch, dev, np, cfg=None, batch: int = RESNET_BATCH,
                        hw: int = RESNET_HW, warmup: int = RESNET_WARMUP,
                        steps: int = RESNET_STEPS) -> dict:
    """ResNet-50 (or `cfg`) trained with Adam on RESNET_STAGED batches of
    synthetic_images staged on the card: each step's synchronised wall
    ms after `warmup` steps, images/s and MFU from the median, a
    torch.profiler capture of one more step (busy share, top kernels),
    peak memory, the running statistics' move, eval logits."""
    from container_engine_accelerators_tpu_torch.models import resnet

    cfg = cfg or resnet.resnet50()
    t0 = time.perf_counter()
    batches = list(resnet.synthetic_images(cfg, batch, hw, RESNET_STAGED,
                                           seed=SEED, device=dev))
    stage_s = time.perf_counter() - t0
    model = resnet.init_variables(torch.Generator(device=dev).manual_seed(
        SEED), cfg, dev)
    before = {k: v.clone() for k, v in model.named_buffers()}
    step = resnet.make_train_step(model, resnet.make_optimizer(model, 1e-3))
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        metrics = step(batches[i % len(batches)])
        loss = float(metrics["loss"])       # the step's fence
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        require(math.isfinite(loss), f"vision: resnet loss {loss} at step "
                f"{i}")
    timed = step_ms[warmup:]
    median_ms = float(np.median(timed))
    images_per_s = batch / (median_ms / 1e3)
    flops = 3 * resnet_forward_flops(cfg, hw)   # backward 2x the forward
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    profile = profile_steps(torch, lambda: step(batches[0]), steps=1,
                            top=10)
    busy = profile["busy_ms_per_step"]
    moved, finite = 0, True
    for name, buf in model.named_buffers():
        moved += int(not torch.equal(buf, before[name]))
        finite = finite and bool(torch.isfinite(buf).all())
    n_bufs = len(before)
    require(finite and moved == n_bufs, f"vision: running statistics "
            f"moved in {moved} of {n_bufs} buffers, finite {finite}")
    with torch.no_grad():
        logits, _ = resnet.apply(model, batches[1]["images"], train=False)
    require(bool(torch.isfinite(logits).all()),
            "vision: resnet eval logits not finite")
    stem = model.stem.bn
    del model, step, batches
    _free_card(torch)
    return {"batch": batch, "hw": hw, "stage_s": stage_s,
            "warmup_steps": warmup, "steps": steps, "losses": losses,
            "step_ms": timed, "median_step_ms": median_ms,
            "images_per_s": images_per_s,
            "train_flops_per_image": flops,
            "mfu": images_per_s * flops / PEAK_FLOPS["bf16"],
            "device_busy_ms_per_step": busy,
            "device_busy_share": None if busy is None else busy / median_ms,
            "top_kernels_ms_per_step": profile["top"],
            "max_memory_allocated_bytes": peak,
            "running_stats_moved": f"{moved}/{n_bufs}",
            "stem_running_mean_abs_max": stem.mean.abs().max().item(),
            "stem_running_var_mean": stem.var.mean().item(),
            "eval_logits_finite": True}


def vision_phase(torch, dev, np, cfg=None, batch: int = RESNET_BATCH,
                 hw: int = RESNET_HW) -> dict:
    """The vision training demos on the card: the two demo contracts
    (mnist.train, resnet.train on resnet_tiny), ResNet-50's f32 logits on
    the card against the CPU's, and ResNet-50 v1.5 trained at full width
    and depth (resnet_train_timing). `cfg`, `batch` and `hw` shrink the
    ResNet-50 parts for a rehearsal."""
    from container_engine_accelerators_tpu_torch.models import mnist, resnet

    out = {"phase": "vision", "nvidia_smi": nvidia_smi_line()}
    t0 = time.perf_counter()
    acc = mnist.train(steps=MNIST_STEPS, device=dev)
    require(acc > MNIST_MIN_ACC, f"vision: mnist accuracy {acc} after "
            f"{MNIST_STEPS} steps, want > {MNIST_MIN_ACC}")
    out["mnist"] = {"steps": MNIST_STEPS, "accuracy": acc,
                    "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    acc = resnet.train(steps=RESNET_TINY_STEPS, device=dev)
    require(acc > RESNET_TINY_MIN_ACC, f"vision: resnet_tiny accuracy {acc} "
            f"after {RESNET_TINY_STEPS} steps, want > {RESNET_TINY_MIN_ACC}")
    out["resnet_tiny"] = {"steps": RESNET_TINY_STEPS, "accuracy": acc,
                          "seconds": time.perf_counter() - t0}
    out["resnet50_card_vs_cpu"] = resnet_card_vs_cpu(
        torch, dev, cfg, hw=hw)
    cfg = cfg or resnet.resnet50()
    out["resnet50"] = {
        "stage_sizes": list(cfg.stage_sizes), "width": cfg.width,
        "bottleneck": cfg.bottleneck, "num_classes": cfg.num_classes,
        "dtype": str(cfg.dtype), "memory_format": "channels_last",
        **resnet_train_timing(torch, dev, np, cfg, batch, hw)}
    emit(out)
    return out


# ---------------------------------------------------------------- telemetry

# The card's sizes; the CPU rehearsal (tests/test_torch_smoke_telemetry.py)
# passes llama_tiny and gloo ones.
TELEMETRY_SIZES = {
    "preset": "8b",             # the served model: llama3_8b, full depth
    "backend": "nccl",
    "device_flags": [],
    "bench": ["-b", "1M", "-e", "512M", "-f", "2", "-w", "5",
              "--iters", "20"],
    "bench_top": 512 << 20,     # the sweep's largest size (ppermute's bound)
    # The paged engine at 8 slots on int8 weights (K2 and K3).
    "serve": ["--engine", "paged", "--max-batch", "8", "--max-len", "2048",
              "--page-size", "128", "--weight-dtype", "int8"],
    "max_batch": 8, "max_len": 2048, "weight_dtype": "int8",
    "interval_s": 0.5,          # --fabric-health-interval
    "warm_sweeps": 16,          # sweeps before the fault (>= 4 build it)
    "slow": {"factor": 8.0, "seconds": 15.0},
    "score_max": 0.2,           # fabric_health_score{dp} under the fault
    "requests": 8, "new_tokens": 16,
    "ready_timeout_s": 600.0,
    "verdict_timeout_s": 30.0,  # serve's doctor polls every 5 s
    "trainer": ["--preset", "8b", "--n-layers", "2", "--batch-size", "2",
                "--seq-len", "1024"],
    "train_steps": 6, "sweep_every": 2,
    "annotate_n": 200_000,
    "allow": (),                # incident classes the run may also name
    "fake_busbw": None,         # a constant probe busBW (the rehearsal's)
}
# What each collective returns at n = 1 (one rank): its input.
TELEMETRY_ZERO_BUS = ("all_reduce", "all_gather", "reduce_scatter",
                      "all_to_all")
TRACE_REGIONS = ("train/step", "train/fabric_sweep")
TRACE_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel")
BENCH_JSON_KEYS = ("collective", "size_bytes", "time_us", "alg_bw_gbps",
                   "bus_bw_gbps", "axis", "devices")

# cli/serve.py with random weights of the preset in argv[1] (serve's
# --tiny loads llama_tiny; the smoke serves llama3_8b at full width and
# depth without writing a checkpoint), and the process's kernel launch
# counts in its /debugz?state=1 snapshot. argv[2] "-" leaves the fabric
# monitor's probes real; a number makes them read that busBW (the CPU
# rehearsal: a loaded host's timing noise is not the fault it checks).
SERVE_WITH_PRESET = r"""
import functools, sys, torch
from container_engine_accelerators_tpu_torch import kernels
from container_engine_accelerators_tpu_torch.cli import serve
from container_engine_accelerators_tpu_torch.metrics import fabric_health
from container_engine_accelerators_tpu_torch.models import convert, llama
preset = {"8b": llama.llama3_8b, "tiny": llama.llama_tiny}[sys.argv[1]]
if sys.argv[2] != "-":
    fabric_health.FabricHealthMonitor = functools.partial(
        fabric_health.FabricHealthMonitor,
        probe_fn=lambda axis, coll, bw=float(sys.argv[2]): bw)

def load_model(checkpoint=None, seed=0, device="cuda"):
    dev = convert.resolve_device(device)
    cfg = preset()
    gen = torch.Generator(device=dev).manual_seed(seed)
    return llama.init_params(cfg, gen, dev), cfg

snapshot = serve.engine_state_snapshot

def with_launches(*args, **kw):
    return {**snapshot(*args, **kw), "kernel_launches": dict(kernels.launches)}

convert.load_model = load_model
serve.engine_state_snapshot = with_launches
sys.exit(serve.main(sys.argv[3:]))
"""

# cli/train.py, then the process's kernel launch counts as a last line.
TRAIN_WITH_LAUNCHES = r"""
import json, sys
from container_engine_accelerators_tpu_torch import kernels
from container_engine_accelerators_tpu_torch.cli import train
rc = train.main(sys.argv[1:])
print(json.dumps({"kernel_launches": dict(kernels.launches)}), flush=True)
sys.exit(rc)
"""


def collective_outputs(torch, dev, backend: str) -> dict:
    """Each collective's probe on a one-rank group in this process against
    its plain torch version on the same input: at n = 1 every collective
    gives back its input (all_reduce a sum of one, all_gather and
    reduce_scatter one shard, all_to_all and ppermute one chunk)."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.ops import collectives
    from container_engine_accelerators_tpu_torch.parallel import distributed

    out = {}
    group = distributed.default_group(backend, dev)
    try:
        x = torch.randn(1 << 20, generator=torch.Generator().manual_seed(
            SEED)).to(distributed.group_device(group))
        for name in collectives.COLLECTIVES:
            fn, n = collectives.build_probe(group, "ici", name)
            got = fn(x.clone())
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            want = x.clone()   # the plain version at n = 1
            out[name] = {"n": n, "equal": bool(torch.equal(got, want)),
                         "max_abs_err": (got - want).abs().max().item()}
            require(out[name]["equal"], f"telemetry: {name} on the "
                    f"{backend} group differs from its plain version")
    finally:
        dist.destroy_process_group()
    return out


def telemetry_bench(torch, dev, root: str, sz: dict) -> dict:
    """(a): cli/collective_bench --collective all as a process on a
    one-rank group: every line parses with JAX's keys, time_us > 0,
    busBW 0 exactly for the four factor-0 collectives; ppermute's time at
    the top size beside the copy's byte bound; the probes' outputs
    against their plain versions in this process."""
    t0 = time.perf_counter()
    proc = _run_port(root, "container_engine_accelerators_tpu_torch.cli."
                     "collective_bench", "--collective", "all",
                     *sz["bench"], "--json", "--backend", sz["backend"],
                     timeout=600)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"telemetry: collective_bench rc "
            f"{proc.returncode}: {proc.stderr[-1500:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    require(rows and all(tuple(r) == BENCH_JSON_KEYS for r in rows),
            f"telemetry: collective_bench keys {[tuple(r) for r in rows]}")
    require(all(r["time_us"] > 0 and r["devices"] == 1 for r in rows),
            "telemetry: a non-positive time or another device count")
    zero = [r for r in rows if r["collective"] in TELEMETRY_ZERO_BUS]
    require(all(r["bus_bw_gbps"] == 0.0 for r in zero)
            and all(r["bus_bw_gbps"] > 0 for r in rows
                    if r["collective"] == "ppermute"),
            "telemetry: busBW not 0 exactly where n = 1 gives factor 0")
    by = {(r["collective"], r["size_bytes"]): r for r in rows}
    top = by[("ppermute", sz["bench_top"])]
    bound_ms, bound_by = bound_ms_copy(sz["bench_top"])
    return {"seconds": seconds, "rows": len(rows),
            "collectives": sorted({r["collective"] for r in rows}),
            "time_us": {f"{c}@{s}": r["time_us"] for (c, s), r in by.items()
                        if s in (1 << 20, sz["bench_top"])},
            "ppermute_top": {"size_bytes": sz["bench_top"],
                             "ms": top["time_us"] / 1e3,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "alg_bw_gbps": top["alg_bw_gbps"]},
            "plain": collective_outputs(torch, dev, sz["backend"])}


def bound_ms_copy(n_bytes: int) -> tuple[float, str]:
    """A copy of n_bytes reads them once and writes them once."""
    return bound_ms(2 * n_bytes, 0, "bf16")


def _incidents(url: str) -> list[dict]:
    return json.loads(_get(url + "/debugz?n=0&doctor=1"))["doctor"].get(
        "incidents", [])


def _fabric_state(url: str) -> dict:
    return json.loads(_get(url + "/debugz?n=0&state=1"))["state"]


def telemetry_serve(dev, np, root: str, tmp_dir: str, sz: dict) -> dict:
    """(b): cli/serve.py as a process, the preset's model on the paged
    engine, with --fabric-health (0.5 s sweeps), --doctor, --fault-listen
    and --metrics-port. Requests answered while the baseline builds (no
    incident); `inject_fault --kind fabric-slow --axis dp --rank 0
    --factor 8 --seconds 15`: fabric_health_score{dp} <= 0.2 and
    fabric_degraded 1 on /metrics, the state's fabric block degraded 1
    with slow_rank 0, fabric_degraded once for dp (its latency from the
    command), requests answered; the window over: the verdict clears and
    slow_rank is null; then `--kind hbm-climb`: oom_precursor carries the
    plan_serving budget of this launch. The plan's total beside the
    process's peak allocation, and the NCCL group's start time and
    memory from its log."""
    from container_engine_accelerators_tpu_torch.models import llama
    from container_engine_accelerators_tpu_torch.utils.hbm_plan import (
        plan_serving,
    )

    d = os.path.join(tmp_dir, "serve")
    os.makedirs(d, exist_ok=True)
    flog, err_path = os.path.join(d, "faults.jsonl"), os.path.join(
        d, "serve.err")
    open(flog, "w").close()
    port, mport = _free_port(), _free_port()
    url, murl = f"http://127.0.0.1:{port}", f"http://127.0.0.1:{mport}"
    preset = sz["preset"]
    cfg = {"8b": llama.llama3_8b, "tiny": llama.llama_tiny}[preset]()
    args = ["--tiny", *sz["serve"], "--port", str(port), "--metrics-port",
            str(mport), "--metrics-host", "127.0.0.1", "--fabric-health",
            "--fabric-health-interval", str(sz["interval_s"]),
            "--fabric-health-history", os.path.join(d, "history.jsonl"),
            "--doctor", "--doctor-dir", os.path.join(d, "incidents"),
            "--fault-listen", flog, *sz["device_flags"]]
    prompts = _prompts(np, cfg, SEED + 30)

    def requests(n):
        reqs = [{"tokens": prompts(64), "max_new_tokens": sz["new_tokens"]}
                for _ in range(n)]
        answers, t0, t1 = burst(url, reqs)
        _check_burst(reqs, answers, cfg.vocab_size, "telemetry serve")
        return {"requests": n, "seconds": t1 - t0}

    def inject(*argv):
        proc = _run_port(root, DOCTOR_INJECT, *argv, "--fault-log", flog,
                         timeout=120)
        require(proc.returncode == 0,
                f"telemetry: inject_fault {argv}: {proc.stderr[-1500:]}")

    def gauges():
        s = _scrape(_get(murl + "/metrics"))
        return (s.get("fabric_health_score{axis=dp}"),
                s.get("fabric_degraded{axis=dp}"), s)

    out = {"preset": preset, "interval_s": sz["interval_s"]}
    t_fault = None
    with open(err_path, "w") as err:
        t_launch = time.monotonic()
        fake = sz["fake_busbw"]
        proc = _popen_port(root, None, preset,
                           "-" if fake is None else str(fake), *args,
                           stderr=err, stdout=subprocess.DEVNULL,
                           code=SERVE_WITH_PRESET)
    try:
        def ready():
            require(proc.poll() is None, f"telemetry: serve exited "
                    f"{proc.returncode}: {_tail(err_path)}")
            try:
                return healthz(url) and _fabric_state(murl).get("fabric")
            except OSError:
                return False

        _wait_for(ready, "telemetry: serve ready", sz["ready_timeout_s"])
        out["ready_s"] = time.monotonic() - t_launch
        out["warmup_requests"] = requests(sz["requests"])
        _wait_for(lambda: _fabric_state(murl)["fabric"]["sweeps"]
                  >= sz["warm_sweeps"], "telemetry: warm sweeps", 120)
        warm = _fabric_state(murl)["fabric"]
        early = [i for i in _incidents(murl) if i["class"] not in sz["allow"]]
        require(not early, f"telemetry: incidents in the clean warmup "
                f"{[(i['class'], i['subject']) for i in early]}")
        out["warm"] = {"sweeps": warm["sweeps"], "score": warm["score"],
                       "degraded": warm["degraded"]}

        slow = sz["slow"]
        t_fault = time.monotonic()
        inject("--kind", "fabric-slow", "--axis", "dp", "--rank", "0",
               "--factor", str(slow["factor"]), "--seconds",
               str(slow["seconds"]))
        _wait_for(lambda: (lambda g: g[0] is not None and g[0]
                           <= sz["score_max"] and g[1] == 1.0)(gauges()),
                  "telemetry: fabric_health_score and fabric_degraded",
                  slow["seconds"])
        out["gauges_after_fault_s"] = time.monotonic() - t_fault
        score, degraded, _ = gauges()
        fab = _fabric_state(murl)["fabric"]
        require(fab["degraded"] == 1 and fab["slow_rank"] == 0,
                f"telemetry: fabric block under the fault {fab}")
        out["under_fault"] = {"score": score, "degraded": degraded,
                              "fabric": fab,
                              **requests(sz["requests"])}
        _wait_for(lambda: any(i["class"] == "fabric_degraded"
                              for i in _incidents(murl)),
                  "telemetry: fabric_degraded", sz["verdict_timeout_s"])
        verdict = [i for i in _incidents(murl)
                   if i["class"] == "fabric_degraded"][0]
        out["fabric_degraded_after_fault_s"] = (verdict["ts_monotonic"]
                                                - t_fault)
        out["fabric_degraded_evidence"] = {
            k: verdict["evidence"].get(k)
            for k in ("axis", "fabric", "score_last", "slow_rank",
                      "localization")}
        # The window ends; the next clean sweeps clear the verdict.
        time.sleep(max(0.0, t_fault + slow["seconds"] - time.monotonic()))
        _wait_for(lambda: (lambda f: f["degraded"] == 0
                           and f["slow_rank"] is None)(
                      _fabric_state(murl)["fabric"]),
                  "telemetry: the verdict clears", 30)
        out["cleared_after_window_s"] = (time.monotonic() - t_fault
                                         - slow["seconds"])

        t_climb = time.monotonic()
        inject("--kind", "hbm-climb", "--device", "injected:0",
               "--seconds", "3", "--start-frac", "0.5", "--end-frac", "0.97")
        _wait_for(lambda: any(i["class"] == "oom_precursor"
                              for i in _incidents(murl)),
                  "telemetry: oom_precursor", sz["verdict_timeout_s"])
        oom = [i for i in _incidents(murl)
               if i["class"] == "oom_precursor"][0]
        out["oom_precursor_after_climb_s"] = oom["ts_monotonic"] - t_climb
        plan = oom["evidence"].get("hbm_plan")
        want = (plan_serving(cfg, tp=1, max_slots=sz["max_batch"],
                             max_len=sz["max_len"], pool_fraction=0.5,
                             weight_dtype=sz["weight_dtype"], device=dev)
                if dev.type == "cuda" else None)
        require(plan == want, f"telemetry: oom_precursor's hbm_plan {plan}, "
                f"plan_serving gives {want}")
        state = _fabric_state(murl)
        launches = state.get("kernel_launches", {})
        _, _, scrape = gauges()
        peak = scrape.get("tpu_hbm_peak_bytes_in_use{device=cuda:0}")
        steps = (scrape.get("serve_decode_step_seconds_sum", 0),
                 scrape.get("serve_decode_step_seconds_count", 0))
        incs = _incidents(murl)
        out["after_requests"] = requests(sz["requests"])
    except SmokeFailure as e:
        try:
            state = _fabric_state(murl).get("fabric")
        except OSError:
            state = None
        raise SmokeFailure(f"{e}; the fabric block {state}; ppermute's "
                           f"(s from the fault, GB/s, ratio) by sweep "
                           f"{_ppermute_series(d, t_fault)}; serve's log: "
                           f"{_tail(err_path, 3000)}") from None
    finally:
        _stop_procs([proc])
    out["ppermute_by_sweep"] = _ppermute_series(d, t_fault)
    got = [(i["class"], i["subject"]) for i in incs]
    require(got.count(("fabric_degraded", "dp")) == 1
            and got.count(("oom_precursor", "injected:0")) == 1
            and all(c in ("fabric_degraded", "oom_precursor", *sz["allow"])
                    for c, _ in got), f"telemetry: the doctor named {got}")
    for name in ("int8_matmul", "paged_decode_attention"):
        require(dev.type != "cuda" or launches.get(name, 0) > 0,
                f"telemetry: no {name} launch in serve ({launches})")
    group = None
    with open(err_path) as fh:
        for line in fh:
            if "fabric health group:" in line:
                group = json.loads(line.split("fabric health group:", 1)[1])
    require(group is not None or sz["fake_busbw"] is not None,
            "telemetry: no fabric group line in serve's log")
    out.update({
        "incidents": got, "plan": plan,
        "plan_total_gb": plan["total_gb"] if plan else None,
        "peak_allocated_gb": peak / 1e9 if peak is not None else None,
        "plan_minus_peak_gb": (plan["total_gb"] - peak / 1e9
                               if plan and peak is not None else None),
        "nccl_group": group,
        "decode_step_mean_ms": steps[0] / steps[1] * 1e3 if steps[1] else None,
        "launches": {k: launches.get(k, 0) for k in (
            "decode_attention", "int8_matmul", "paged_decode_attention")}})
    return out


def _ppermute_series(d: str, t_fault) -> list:
    """(seconds from the fault, GB/s, ratio to the baseline) of each
    sweep's ppermute row in serve's history."""
    path = os.path.join(d, "history.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    t0 = (time.time() - time.monotonic() + t_fault) if t_fault else 0.0
    return [(round(r["t"] - t0, 2), round(r["busbw_bytes_per_second"] / 1e9,
                                          1), r["ratio"])
            for r in rows if r["collective"] == "ppermute"]


def _tail(path: str, n: int = 1500) -> str:
    with open(path) as fh:
        return fh.read()[-n:]


def telemetry_train(dev, root: str, tmp_dir: str, sz: dict) -> dict:
    """(c): cli/train.py at the trainer's width and depth for
    sz["train_steps"] steps with --fabric-health --fabric-health-every N
    and TPU_PROFILE_DIR: sweeps at the steps maybe_sweep_step picks (N,
    2N, ...), the capture holds the train/step and train/fabric_sweep
    regions and K4-K6 by name, the flight recorder the train/* B/E spans
    and profile/start and profile/stop."""
    d = os.path.join(tmp_dir, "train")
    prof, dump = os.path.join(d, "profile"), os.path.join(d, "train.json")
    hist = os.path.join(d, "history.jsonl")
    os.makedirs(d, exist_ok=True)
    steps, every = sz["train_steps"], sz["sweep_every"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", TRAIN_WITH_LAUNCHES, *sz["trainer"],
         "--steps", str(steps), "--fabric-health", "--fabric-health-every",
         str(every), "--fabric-health-history", hist, "--trace-dump", dump,
         "--log-every", "1", *sz["device_flags"]],
        capture_output=True, text=True, timeout=900, cwd=root,
        env=dict(os.environ, PYTHONPATH=root, TPU_PROFILE_DIR=prof))
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"telemetry: train rc {proc.returncode}: "
            f"{proc.stderr[-1500:]}")
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    summary, launches = lines[-2], lines[-1]["kernel_launches"]
    want = [s for s in range(1, steps + 1) if s % every == 0]
    with open(hist) as fh:
        rows = [json.loads(line) for line in fh]
    require(summary["fabric_sweeps"] == len(want)
            and len(rows) == 3 * len(want),
            f"telemetry: {summary['fabric_sweeps']} sweeps and {len(rows)} "
            f"rows, want sweeps at steps {want}")
    traces = [os.path.join(prof, f) for f in os.listdir(prof)]
    require(len(traces) == 1, f"telemetry: profile dir {traces}")
    with open(traces[0]) as fh:
        names = [e.get("name", "") for e in json.load(fh)["traceEvents"]]
    regions = {r: names.count(r) for r in TRACE_REGIONS}
    found = {k: sum(1 for n in names if k in n) for k in TRACE_KERNELS}
    # A region is a CPU range, and on the card its device range too.
    require(all(n >= steps for n in regions.values())
            and (dev.type != "cuda" or all(found.values())),
            f"telemetry: the capture's regions {regions}, kernels {found}")
    with open(dump) as fh:
        ring = [(e.get("name"), e.get("ph"))
                for e in json.load(fh)["traceEvents"]]
    spans = {n: (ring.count((n, "B")), ring.count((n, "E")))
             for n in ("train/data_wait", "train/step",
                       "train/fabric_sweep")}
    marks = [n for n, ph in ring if n in ("profile/start", "profile/stop")]
    require(all(b == e == steps for b, e in spans.values())
            and marks == ["profile/start", "profile/stop"],
            f"telemetry: the flight recorder's spans {spans}, marks {marks}")
    return {"seconds": seconds, "steps": steps, "sweep_steps": want,
            "capture_regions": regions, "capture_kernels": found,
            "capture_bytes": os.path.getsize(traces[0]),
            "ring_spans": spans, "tokens_per_sec": summary["tokens_per_sec"],
            "launches": launches}


def nvlink_answer() -> dict:
    """NVML's answer for each card's NVLink counters, read here as the
    exporter reads them."""
    from container_engine_accelerators_tpu_torch.utils import nvml

    try:
        session = nvml.Nvml()
    except nvml.NvmlError as e:
        return {"*": str(e)}
    out = {}
    with session:
        for minor, card in sorted(session.cards().items()):
            try:
                out[f"nvidia{minor}"] = session.nvlink_errors(
                    session.handle(card.index))
            except nvml.NvmlError as e:
                out[f"nvidia{minor}"] = str(e)
    return out


def telemetry_exporter(root: str, tmp_dir: str, sz: dict) -> dict:
    """(d): metrics.fabric --health as a process, one scrape once its
    first poll is in: the NIC counters of this machine's interfaces,
    tpu_ici_error_count from NVML (or NVML's answer where it gives none)
    and the probe hook's busBW gauge."""
    port = _free_port()
    url = f"http://127.0.0.1:{port}/metrics"
    err_path = os.path.join(tmp_dir, "fabric.err")
    with open(err_path, "w") as err:
        proc = _popen_port(root, "container_engine_accelerators_tpu_torch."
                           "metrics.fabric", "--health", "--port", str(port),
                           "--interval", "1", "--health-interval", "1",
                           "--backend", sz["backend"],
                           stdout=subprocess.DEVNULL, stderr=err)
    try:
        def scraped():
            require(proc.poll() is None, "telemetry: the exporter exited: "
                    f"{_tail(err_path)}")
            try:
                s = _scrape(_get(url))
            except OSError:
                return None
            return s if any(k.startswith(
                "fabric_collective_busbw_bytes_per_second") for k in s) \
                and s.get("fabric_probe_sweeps_total", 0) >= 1 else None

        _wait_for(scraped, "telemetry: the exporter's first poll", 60)
        s = scraped()
    finally:
        _stop_procs([proc])
    nic = {k: v for k, v in s.items() if k.startswith("tpu_dcn_nic_stat")}
    ici = {k: v for k, v in s.items() if k.startswith("tpu_ici_error_count")}
    hook = {k: v for k, v in s.items()
            if k.startswith("fabric_collective_busbw_bytes_per_second")}
    net = "/sys/class/net"
    interfaces = sorted(
        n for n in (os.listdir(net) if os.path.isdir(net) else ())
        if n != "lo" and os.path.exists(os.path.join(net, n, "statistics",
                                                     "tx_bytes")))
    exported = sorted({k.split("{interface=")[1].split("}")[0] for k in nic})
    require(exported == interfaces, f"telemetry: NIC counters for "
            f"{exported}, interfaces {interfaces}")
    return {"interfaces": interfaces, "nic_samples": len(nic),
            "ici_error_count": ici, "nvlink_answer": nvlink_answer(),
            "probe_hook_busbw": hook,
            "health_score": s.get("fabric_health_score{axis=dp}")}


def annotate_cost(n: int) -> dict:
    """(e): µs a region of annotate() costs, with the bus off and on (no
    profiler), beside the empty loop's."""
    from container_engine_accelerators_tpu_torch.metrics import events
    from container_engine_accelerators_tpu_torch.utils.profiling import (
        annotate,
    )

    def loop(region):
        t0 = time.perf_counter()
        for _ in range(n):
            with region("serve/decode_tick"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    events.disable()
    empty = loop(lambda name: contextlib.nullcontext())
    off = loop(annotate)
    events.enable(capacity=1 << 12, process_name="telemetry")
    try:
        on = loop(annotate)
    finally:
        events.disable(clear=True)
    return {"regions": n, "empty_us": empty, "bus_off_us": off,
            "bus_on_us": on}


def telemetry_phase(torch, dev, np, tmp_dir: str, tick_ms: float | None = None,
                    sizes: dict | None = None) -> dict:
    """Device telemetry on the card (the module docstring's `telemetry`):
    (a) the collective bench, (b) serve with the fabric monitor, the
    doctor and the plan, (c) train with the monitor and the profiler,
    (d) the fabric exporter, (e) annotate's cost beside the paged tick.
    The card only: it fails without CUDA unless sizes name the CPU."""
    import container_engine_accelerators_tpu_torch as port

    sz = {**TELEMETRY_SIZES, **(sizes or {})}
    require(dev.type == "cuda" or sz["backend"] == "gloo",
            "telemetry: the phase runs on the card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))
    seconds, out = {}, {"phase": "telemetry"}
    for name, fn, *args in (
            ("bench", telemetry_bench, torch, dev, root, sz),
            ("serve", telemetry_serve, dev, np, root, tmp_dir, sz),
            ("train", telemetry_train, dev, root, tmp_dir, sz),
            ("exporter", telemetry_exporter, root, tmp_dir, sz),
            ("annotate", annotate_cost, sz["annotate_n"])):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
        emit({"phase": f"telemetry_{name}", **out[name]})
    ann, serve = out["annotate"], out["serve"]
    ann["paged_tick_ms_8_slots"] = tick_ms
    ann["serve_decode_step_mean_ms"] = serve["decode_step_mean_ms"]
    ann["regions_a_tick"] = 3
    launches: dict = {}
    for part in (serve, out["train"]):
        for k, v in part["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out.update(seconds=seconds, launches=launches,
               nvidia_smi=nvidia_smi_line())
    emit({"phase": "telemetry_summary", "seconds": seconds,
          "launches": launches, "annotate": ann})
    return out


def telemetry_main(torch) -> int:
    """`chip_smoke.py telemetry`: the build and the telemetry phase
    alone."""
    import numpy as np

    from container_engine_accelerators_tpu_torch import kernels

    t0 = time.perf_counter()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi_line()})
    kernels.build()
    seconds = {"build": time.perf_counter() - t0}
    try:
        with tempfile.TemporaryDirectory() as tmp_dir:
            t0 = time.perf_counter()
            telemetry_phase(torch, torch.device("cuda", 0), np, tmp_dir)
            seconds["telemetry"] = time.perf_counter() - t0
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    emit({"phase_seconds": seconds})
    return 0


# ---------------------------------------------------------------- doctor

DOCTOR_POLL_S = 0.25            # the in-process doctors' evaluation period
FLEETMON_INTERVAL_S = 0.25      # fleetmon's scrape period
FLEETMON_DOWN_AFTER_S = 1.0     # ... and its stale -> down limit
FLEETMON_DOCTOR_S = 0.5         # ... and its doctor's period
# The card's sizes; the CPU rehearsal (tests/test_torch_smoke_doctor.py)
# passes llama_tiny ones, and the thresholds that a CPU run on a loaded
# host needs: the in-process doctors' hang threshold, and fleetmon's
# SLOs ("fleet_slos", SloSpec fields; absent here, so fleetmon keeps its
# defaults).
DOCTOR_SIZES = {
    "hang_after_s": 2.0,        # engine_hang's threshold in the scenarios
    "hang_s": 5.0,              # the injected hang, well past it
    "hang_new_tokens": 128,     # loadgen streams through the hang
    "kill_new_tokens": 128,     # ... through the worker kill
    "pool_new_tokens": 48,      # ... the prefill-pool kill's mix
    "fan_new_tokens": 128,      # ... the fleet's fanned streams
    "hbm_step_bytes": 4 << 30,  # the real climb: 4 GiB a step
    "hbm_step_s": 0.5,          # ... every 0.5 s
    "fit": {"batch": 1, "seq": 1024, "steps": 8},
    "stall_s": 4.0,             # the injected data stall
    # Two cli/train processes at full width and 2 layers.
    "trainer": ["--preset", "8b", "--n-layers", "2", "--batch-size", "1",
                "--seq-len", "512"],
    "trainer_steps": (100, 2),  # rank 0 (healthy), rank 1 (slowed)
    "watchdog_s": 8.0,          # the shared heartbeat threshold
    "straggler_delay_s": 12.0,  # rank 1's sleep before every batch
    # The replicas' depth: the f32 HF export and two replicas reading it
    # into host memory must fit the host (see fleet_room); 4 of the 32
    # layers keep the export and the replicas' start short.
    "fleet_layers": 4,
    "ready_timeout_s": 600.0,
}
DOCTOR_INJECT = "container_engine_accelerators_tpu_torch.cli.inject_fault"


def _run_port(root: str, module: str, *args: str, timeout: float = 600,
              env: dict | None = None) -> subprocess.CompletedProcess:
    """`python -m <module> ARGS` from the checkout at `root`."""
    return subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, timeout=timeout, cwd=root,
        env=dict(os.environ, PYTHONPATH=root, **(env or {})))


def _popen_port(root: str, module: str, *args: str, env: dict | None = None,
                stdout=subprocess.PIPE, stderr=None, code: str | None = None):
    """`python -m <module> ARGS` (or `python -c <code> ARGS`) as a process
    of its own, in a session of its own so that _stop_procs reaches what
    it starts."""
    run = ["-c", code] if code is not None else ["-m", module]
    return subprocess.Popen(
        [sys.executable, *run, *args], cwd=root, text=True,
        stdout=stdout, stderr=stderr, start_new_session=True,
        env=dict(os.environ, PYTHONPATH=root, **(env or {})))


# cli/fleetmon.py with its doctor on the SloSpecs given as JSON in
# argv[1], the rest of argv its own flags: fleetmon has no SLO flag (nor
# has the JAX package's), so a run that needs other SLOs than the
# defaults, as the CPU rehearsal's loaded replicas do, starts it here.
FLEETMON_WITH_SLOS = r"""
import json, sys
from container_engine_accelerators_tpu_torch.cli import fleetmon
from container_engine_accelerators_tpu_torch.metrics import doctor
slos = [doctor.SloSpec(**s) for s in json.loads(sys.argv[1])]
config = doctor.DoctorConfig
doctor.DoctorConfig = lambda **kw: config(**{"slos": slos, **kw})
sys.exit(fleetmon.main(sys.argv[2:]))
"""


def _stop_procs(procs: list) -> None:
    """SIGTERM each process's session, then SIGKILL what is left."""
    for p in procs:
        if p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGTERM)
    deadline = time.monotonic() + 30
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=30)


def _json_line(stream, kind: str, timeout_s: float) -> dict:
    """The first JSON object line of `kind` on `stream`; a thread keeps
    draining the stream after it, so the writer never blocks."""
    import queue

    lines: queue.Queue = queue.Queue()

    def pump():
        for line in stream:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            raise SmokeFailure(f"no {kind} line in {timeout_s} s") from None
        require(line is not None, f"the process ended before its {kind} "
                "line")
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and rec.get("kind") == kind:
            return rec


def _loadgen(root: str, url: str, requests: int, concurrency: int,
             new_tokens: int, *flags: str, wait: bool = True):
    """cli/loadgen as a process (streamed requests); with `wait`, its
    (summary, exit code), else the process."""
    args = ["--targets" if "," in url else "--url", url,
            "--requests", str(requests), "--concurrency", str(concurrency),
            "--max-new-tokens", str(new_tokens), "--stream",
            "--timeout", "600", *flags]
    module = "container_engine_accelerators_tpu_torch.cli.loadgen"
    if not wait:
        return _popen_port(root, module, *args)
    proc = _run_port(root, module, *args)
    return _loadgen_result(proc.stdout, proc.returncode, proc.stderr)


def _loadgen_result(out: str, rc: int, err: str = "") -> tuple[dict, int]:
    lines = [line for line in (out or "").splitlines()
             if line.startswith("{")]
    require(lines, f"loadgen printed no summary (rc {rc}): "
            f"{(out or '')[-1500:]} {(err or '')[-1500:]}")
    return json.loads(lines[-1]), rc


def _wait_loadgen(proc, timeout_s: float = 600) -> tuple[dict, int]:
    out, err = proc.communicate(timeout=timeout_s)
    return _loadgen_result(out, proc.returncode, err or "")


class DoctorRun:
    """One scenario's live diagnosis in this process: a fresh flight
    recorder, a Doctor at chaos timescales (the scenario's window, a
    DOCTOR_POLL_S period, episode re-arm off, SLOs off, as the JAX
    package's chaos harness replays them) and a FaultListener on the
    scenario's own fault log. inject() runs cli/inject_fault as a
    process; finish() reads the verdicts and holds them to the
    scenario's expectation."""

    def __init__(self, root: str, tmp_dir: str, name: str, sz: dict,
                 window_s: float = 6.0, engine=None, request_recorder=None,
                 train_recorder=None, **config):
        from prometheus_client import CollectorRegistry

        from container_engine_accelerators_tpu_torch.metrics import (
            doctor,
            events,
        )

        self.root, self.name = root, name
        self.dir = os.path.join(tmp_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.fault_log = os.path.join(self.dir, "faults.jsonl")
        events.get_bus().clear()
        self.bus = events.enable(capacity=1 << 18,
                                 process_name=f"doctor-{name}")
        self.config = doctor.DoctorConfig(
            poll_interval_s=DOCTOR_POLL_S, fast_window_s=window_s,
            slow_window_s=window_s * 5, hang_after_s=sz["hang_after_s"],
            clear_after_s=1e9, slos=[], **config)
        self.doctor = doctor.Doctor(
            config=self.config, registry=CollectorRegistry(),
            request_recorder=request_recorder,
            train_recorder=train_recorder,
            out_dir=os.path.join(self.dir, "incidents"))
        self.listener = doctor.FaultListener(self.fault_log, engine=engine,
                                             interval_s=0.05)
        self.t_start = time.monotonic()
        self.t_fault: float | None = None
        self.doctor.start()
        self.listener.start()

    def inject(self, *args: str, log_flag: str = "--fault-log") -> None:
        """cli/inject_fault ARGS as a process, writing to this scenario's
        fault log (or, for the health kind, to the feed named in ARGS)."""
        if self.t_fault is None:
            self.t_fault = time.monotonic()
        argv = list(args)
        if log_flag:
            argv += [log_flag, self.fault_log]
        proc = _run_port(self.root, DOCTOR_INJECT, *argv, timeout=120)
        require(proc.returncode == 0,
                f"{self.name}: inject_fault {argv}: {proc.stderr[-1500:]}")

    def incidents(self, cls: str | None = None) -> list[dict]:
        return [i for i in list(self.doctor.incidents)
                if cls is None or i["class"] == cls]

    def wait_for(self, cls: str, timeout_s: float = 30.0) -> None:
        _wait_for(lambda: self.incidents(cls), f"{self.name}: {cls}",
                  timeout_s)

    def finish(self, expect: dict, allow: tuple = (),
               timeline: tuple = ("fault/injected",)) -> dict:
        """Stop the listener and the doctor (after two more periods, so
        the tail is evaluated) and check: each expected class exactly
        once with its subject, nothing else but `allow`, nothing before
        the first fault, and each `timeline` event on the ring."""
        from container_engine_accelerators_tpu_torch.metrics import events

        time.sleep(2 * DOCTOR_POLL_S + 0.1)
        tap = self.doctor.debugz()["tap"]
        self.listener.stop()
        self.doctor.stop()
        names = {ev[3] for ev in self.bus.snapshot() if ev is not None}
        dropped, emitted = self.bus.dropped, self.bus.emitted
        events.disable(clear=True)
        incs = self.incidents()
        t_ref = self.t_fault if self.t_fault is not None else self.t_start
        got = [(i["class"], i["subject"]) for i in incs]
        for cls, subject in expect.items():
            mine = [s for c, s in got if c == cls]
            require(len(mine) == 1 and (subject is None
                                        or mine[0] == subject),
                    f"{self.name}: want one {cls} for {subject}, got {got}")
        unexpected = [c for c, _ in got if c not in expect and c not in allow]
        require(not unexpected, f"{self.name}: unexpected incidents {got}")
        early = [(i["class"], i["ts_monotonic"] - t_ref) for i in incs
                 if i["class"] not in allow
                 and i["ts_monotonic"] < t_ref - 0.5]
        require(not early, f"{self.name}: incidents in the clean warmup "
                f"before the first fault: {early}")
        missing = [n for n in timeline if n not in names]
        require(not missing, f"{self.name}: not on the timeline: {missing}")
        return {"incidents": [
                    {"class": i["class"], "subject": i["subject"],
                     "summary": i["summary"],
                     "confidence": i["confidence"],
                     "after_fault_s": i["ts_monotonic"] - t_ref}
                    for i in incs],
                "window_s": self.config.fast_window_s,
                "clean_warmup_s": t_ref - self.t_start,
                "ring_emitted": emitted, "ring_dropped": dropped,
                "tap_received": tap["received"] if tap else None,
                "tap_dropped": tap["dropped"] if tap else None}


def hbm_poller(registry):
    """The serving exporters' memory poller (its own function so that the
    CPU rehearsal can give it a card)."""
    from container_engine_accelerators_tpu_torch.metrics.introspection import (  # noqa: E501
        HbmPoller,
    )

    return HbmPoller(registry=registry)


@contextlib.contextmanager
def _exporter(engine):
    """A ServeMetricsExporter over the engine's recorder, polling the
    card's memory every DOCTOR_POLL_S (the hbm/<device> tracks the
    oom_precursor detector reads), as `serve --metrics-port` runs it."""
    from container_engine_accelerators_tpu_torch.metrics.request_metrics import (  # noqa: E501
        ServeMetricsExporter,
    )

    exp = ServeMetricsExporter(engine.recorder, port=0, host="127.0.0.1",
                               interval=DOCTOR_POLL_S,
                               hbm_poller=hbm_poller(
                                   engine.recorder.registry))
    exp.start_background()
    try:
        yield exp
    finally:
        exp.stop()


def _slots_busy(engine) -> bool:
    return (engine.recorder.registry.get_sample_value("serve_active_slots")
            or 0) >= 1


def _gauges_at_rest(engine, what: str) -> None:
    reg = engine.recorder.registry
    _wait_for(lambda: not reg.get_sample_value("serve_active_slots")
              and not reg.get_sample_value("serve_queue_depth"),
              f"{what}: slots and queue back to 0", 60)


def doctor_hang(root, tmp_dir, model, cfg, sz) -> dict:
    """engine-hang: the continuous engine (2 slots, K1) behind make_server;
    loadgen streams 3 requests, 2 at a time, and `inject_fault --kind
    hang` wedges the worker sz["hang_s"]: engine_hang once, the streams
    resume with no error and no hung stream."""
    from container_engine_accelerators_tpu_torch.cli.serve import (
        ContinuousEngine,
    )

    engine = ContinuousEngine(model, cfg, max_slots=2, max_len=512,
                              prefill_chunk=0)
    n = sz["hang_new_tokens"]
    with serving(engine) as url, _exporter(engine):
        _loadgen(root, url, 2, 2, 8)                     # prime the shapes
        run = DoctorRun(root, tmp_dir, "engine_hang", sz, 6.0,
                        engine=engine, request_recorder=engine.recorder)
        warm, rc = _loadgen(root, url, 2, 1, 4)
        require(rc == 0, f"engine_hang: warmup {warm}")
        bg = _loadgen(root, url, 3, 2, n, "--stall-timeout-s",
                      str(sz["hang_s"] + 30), wait=False)
        _wait_for(lambda: _slots_busy(engine), "engine_hang: streams", 120)
        run.inject("--kind", "hang", "--seconds", str(sz["hang_s"]))
        run.wait_for("engine_hang", sz["hang_s"] + 10)
        summary, rc = _wait_loadgen(bg)
        require(rc == 0 and summary["requests_ok"] == 3
                and summary["errors"] == 0,
                f"engine_hang: loadgen rc {rc}: {summary}")
        _gauges_at_rest(engine, "engine_hang")
        out = run.finish({"engine_hang": "serve"})
    out.update(hang_s=sz["hang_s"], hang_after_s=sz["hang_after_s"],
               loadgen=summary, tpot_ms=summary.get("tpot_ms"))
    return out


def doctor_worker_kill(root, tmp_dir, model, cfg, sz) -> dict:
    """worker-kill: the paged engine (2 slots, K3) under EngineSupervisor;
    `inject_fault --kind worker-kill` mid-stream: structured errors, no
    hung stream, the restarted worker answers, pages back to 0, and no
    incident (a supervised recovery is not a hang)."""
    from container_engine_accelerators_tpu_torch.cli.serve import (
        EngineSupervisor,
        PagedContinuousEngine,
    )

    engine = PagedContinuousEngine(model, cfg, max_slots=2, max_len=512,
                                   page=128, prefill_chunk=0, prefix_cap=0)
    sup = EngineSupervisor(engine, backoff_base_s=0.5)
    with serving(engine) as url, _exporter(engine):
        try:
            sup.start()
            _loadgen(root, url, 2, 2, 8)
            run = DoctorRun(root, tmp_dir, "worker_kill", sz, 6.0,
                            engine=engine, request_recorder=engine.recorder)
            warm, rc = _loadgen(root, url, 2, 1, 4)
            require(rc == 0, f"worker_kill: warmup {warm}")
            bg = _loadgen(root, url, 4, 2, sz["kill_new_tokens"],
                          "--stall-timeout-s", "60", wait=False)
            _wait_for(lambda: _slots_busy(engine), "worker_kill: streams",
                      120)
            run.inject("--kind", "worker-kill")
            victims, rc = _wait_loadgen(bg)
            require(rc == 3 and victims["structured_errors"] >= 1
                    and victims["hung_streams"] == 0
                    and victims["transport_errors"] == 0,
                    f"worker_kill: loadgen rc {rc}: {victims}")
            time.sleep(2.0)
            after, rc = _loadgen(root, url, 3, 2, 8)
            require(rc == 0 and after["requests_ok"] == 3,
                    f"worker_kill: after the restart {after}")
            health = healthz(url)
            require(health["worker_alive"] and health["worker_restarts"] >= 1,
                    f"worker_kill: healthz {health}")
            _gauges_at_rest(engine, "worker_kill")
            require(engine.pages_in_use == 0,
                    f"worker_kill: {engine.pages_in_use} pages in use")
            out = run.finish({}, timeline=(
                "fault/injected", "supervisor/worker_death",
                "supervisor/worker_restart"))
        finally:
            sup.stop()
    out.update(loadgen=victims, after_restart=after,
               worker_restarts=health["worker_restarts"])
    return out


def doctor_pool_and_node(root, tmp_dir, torch, dev, model, cfg, sz) -> dict:
    """On one supervised paged engine with 2 prefill workers (page 32,
    32-token chunks, a 64-page prefix cache): prefill-pool-kill (a
    multi-tenant mix, one prefill worker killed: every request answers,
    the worker is replaced, no incident); then, the engine idle,
    hbm-exhaustion twice (`inject_fault --kind hbm-climb`'s fabricated
    track, then a real climb: this process allocating card memory in
    steps until an allocation fails) and health-storm (`--kind
    health-tail` over a feed that `inject_fault --kind health` fills)."""
    from container_engine_accelerators_tpu_torch.cli.serve import (
        EngineSupervisor,
        PagedContinuousEngine,
    )

    # The pool holds every slot's 512 tokens and a full prefix cache
    # (129 pages, 0.5 GiB at 8B, not the default 33): on the default the
    # cache's 64 pages crowd the slots out, the 4-tenant mix evicts
    # prefix pages it re-references at once, and the doctor rightly
    # names kv_thrash, which is not this scenario's fault.
    engine = PagedContinuousEngine(model, cfg, max_slots=4, max_len=512,
                                   page=32, pool_pages=4 * 512 // 32 + 65,
                                   prefill_chunk=32, prefix_cap=64,
                                   prefill_workers=2)
    sup = EngineSupervisor(engine, backoff_base_s=0.5)
    mix = ["--tenants", "4", "--tenant-prefix-len", "64", "--prompt-len",
           "96", "--long-prompt-len", "192"]
    out = {}
    with serving(engine) as url, _exporter(engine) as exp:
        try:
            sup.start()
            _wait_for(lambda: engine.prefill_workers_alive() == 2,
                      "the prefill pool")
            _loadgen(root, url, 8, 4, 4, *mix)
            run = DoctorRun(root, tmp_dir, "prefill_pool_kill", sz, 6.0,
                            engine=engine, request_recorder=engine.recorder)
            warm, rc = _loadgen(root, url, 2, 1, 4)
            require(rc == 0, f"prefill_pool_kill: warmup {warm}")
            bg = _loadgen(root, url, 16, 4, sz["pool_new_tokens"], *mix,
                          "--stall-timeout-s", "60", wait=False)
            time.sleep(0.3)
            run.inject("--kind", "prefill-kill")
            summary, rc = _wait_loadgen(bg)
            require(rc == 0 and summary["requests_ok"] == 16
                    and summary["errors"] == 0,
                    f"prefill_pool_kill: loadgen rc {rc}: {summary}")
            time.sleep(2.0)
            after, rc = _loadgen(root, url, 4, 2, 8, *mix)
            require(rc == 0 and after["requests_ok"] == 4,
                    f"prefill_pool_kill: after {after}")
            health = healthz(url)
            require(health["worker_alive"]
                    and health["prefill_worker_restarts"] >= 1
                    and health["prefill_workers_alive"] >= 2,
                    f"prefill_pool_kill: healthz {health}")
            _gauges_at_rest(engine, "prefill_pool_kill")
            require(engine.pages_in_use == engine.prefix_index.pages_held(),
                    "prefill_pool_kill: leaked pages")
            out["prefill_pool_kill"] = {
                **run.finish({}, timeline=(
                    "fault/injected", "supervisor/prefill_worker_death",
                    "supervisor/prefill_worker_restart")),
                "loadgen": summary,
                "prefill_worker_restarts": health["prefill_worker_restarts"]}

            run = DoctorRun(root, tmp_dir, "hbm_exhaustion_fabricated", sz,
                            8.0, engine=engine,
                            request_recorder=engine.recorder)
            time.sleep(1.5)
            run.inject("--kind", "hbm-climb", "--device", "injected:0",
                       "--seconds", "3", "--start-frac", "0.5",
                       "--end-frac", "0.97")
            run.wait_for("oom_precursor", 20)
            time.sleep(1.0)
            out["hbm_exhaustion_fabricated"] = run.finish(
                {"oom_precursor": "injected:0"})

            run = DoctorRun(root, tmp_dir, "hbm_exhaustion_real", sz, 8.0,
                            engine=engine, request_recorder=engine.recorder)
            time.sleep(1.5)
            climb = real_hbm_climb(torch, dev, run, exp.hbm_poller, sz)
            out["hbm_exhaustion_real"] = {
                **run.finish({"oom_precursor": climb["device"]},
                             timeline=()),
                **climb}

            feed = os.path.join(tmp_dir, "health_feed.jsonl")
            run = DoctorRun(root, tmp_dir, "health_storm", sz, 8.0,
                            engine=engine, request_recorder=engine.recorder,
                            health_storm_n=3)
            time.sleep(1.5)
            run.inject("--kind", "health-tail", "--path", feed,
                       "--seconds", "10")
            time.sleep(1.0)
            run.inject("--chip", "0", "--error-class",
                       "HBM_ECC_UNCORRECTABLE", "--repeat", "4",
                       "--interval", "0.3", "--error-log", feed,
                       log_flag="")
            run.wait_for("health_storm", 20)
            out["health_storm"] = run.finish(
                {"health_storm": "HBM_ECC_UNCORRECTABLE"},
                timeline=("fault/injected", "health/HBM_ECC_UNCORRECTABLE"))
        finally:
            sup.stop()
    return out


def card_alloc(torch, dev, n_bytes: int):
    """n_bytes of the card's memory, held until the tensor is dropped
    (cudaMalloc commits it: mem_get_info counts it at once)."""
    return torch.empty(n_bytes, dtype=torch.uint8, device=dev)


def real_hbm_climb(torch, dev, run: DoctorRun, poller, sz) -> dict:
    """While the engine idles, allocate sz["hbm_step_bytes"] of card
    memory every sz["hbm_step_s"] until an allocation fails, then free
    it all: the poller's hbm/<device> track climbs for real. Returns the
    device, the first oom_precursor's projected time to exhaustion and
    the headroom it saw, and the seconds from that verdict to the failed
    allocation (the real time to exhaustion at that rate)."""
    held, fired, t_fail = [], None, None
    run.t_fault = time.monotonic()
    try:
        while time.monotonic() - run.t_fault < 300:
            try:
                held.append(card_alloc(torch, dev, sz["hbm_step_bytes"]))
            except torch.cuda.OutOfMemoryError:
                t_fail = time.monotonic()
                break
            if fired is None:
                found = run.incidents("oom_precursor")
                if found:
                    fired = found[0]
            time.sleep(sz["hbm_step_s"])
        rows = poller.poll_once()
    finally:
        n_held = len(held)
        del held
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    require(t_fail is not None, "hbm_exhaustion_real: no allocation failed")
    if fired is None:
        _wait_for(lambda: run.incidents("oom_precursor"),
                  "hbm_exhaustion_real: oom_precursor", 10)
        fired = run.incidents("oom_precursor")[0]
    ev = fired["evidence"]
    return {"device": ev["device"], "step_bytes": sz["hbm_step_bytes"],
            "step_s": sz["hbm_step_s"], "steps_held": n_held,
            "projected_tte_s": ev["tte_s"],
            "utilization_at_verdict": ev["utilization"],
            "headroom_bytes_at_verdict": ev["bytes_limit"]
            - ev["bytes_in_use"],
            "slope_bytes_per_s": ev["slope_bytes_per_s"],
            "verdict_after_climb_start_s": fired["ts_monotonic"]
            - run.t_fault,
            "actual_tte_s": t_fail - fired["ts_monotonic"],
            "bytes_in_use_at_failure": rows[0]["bytes_in_use"] if rows
            else None}


def doctor_data_stall(root, tmp_dir, torch, dev, cfg, sz) -> dict:
    """data-stall: fit at full width and 2 layers (K4-K6) with the train
    recorder and a live doctor; after step 3's batch `inject_fault --kind
    data-stall` arms a sleep in the next fetch: the run reaches its step
    target, the stall lands in the `stalled` goodput bucket with
    `data/stall` on the timeline, and no incident."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.metrics.train_metrics import (  # noqa: E501
        TrainRecorder,
    )
    from container_engine_accelerators_tpu_torch.training import dataset
    from container_engine_accelerators_tpu_torch.training.data import (
        synthetic_batches,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        fit,
        make_optimizer,
    )

    f = sz["fit"]
    rec = TrainRecorder()
    run = DoctorRun(root, tmp_dir, "data_stall", sz, 6.0, train_recorder=rec)

    def stream():
        for i, b in enumerate(synthetic_batches(cfg.vocab_size, f["batch"],
                                                f["seq"], seed=SEED)):
            yield b
            if i == 2:
                run.inject("--kind", "data-stall", "--seconds",
                           str(sz["stall_s"]))
                _wait_for(lambda: dataset._STALL["once_s"] > 0,
                          "data_stall: the stall armed", 30)

    kernels.reset_launches()
    try:
        state, _ = fit(cfg, make_optimizer(), stream(), device=dev,
                       max_steps=f["steps"], seed=SEED, log_every=1,
                       log_fn=lambda m: None, recorder=rec)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(kernels.launches)
        summary = rec.summary()
        step = state.step
        del state
    finally:
        dataset.clear_stall()
        rec.close()
    out = run.finish({}, timeline=("fault/injected", "data/stall"))
    _free_card(torch)
    # The bucket also holds what the recorder never saw a step report
    # (fit building the model before step 1), as the JAX recorder's does;
    # the stalled step's own data wait is the stall plus the command.
    stalled = summary["goodput"]["stalled"]
    wait = max(rec.samples["data_wait"])
    require(step == f["steps"], f"data_stall: reached step {step}")
    require(stalled >= sz["stall_s"] - 1.0 and wait >= sz["stall_s"],
            f"data_stall: {stalled} s in the stalled bucket, the longest "
            f"data wait {wait} s")
    out.update(n_layers=cfg.n_layers, steps=step, stall_s=sz["stall_s"],
               stalled_s=stalled, stall_step_data_wait_s=wait,
               goodput=summary["goodput"], launches=launches)
    return out


def doctor_straggler(root, tmp_dir, sz, device_flags: list) -> dict:
    """straggler: two cli/train processes on the one card (RANK 0 and 1),
    one heartbeat dir; rank 1 listens for faults and a straggler command
    (every batch fetch sleeps sz["straggler_delay_s"]) waits in its log
    before it starts; rank 0 starts once rank 1's heartbeat exists and
    runs `--doctor`: its watchdog sees rank 1's heartbeat age past the
    threshold, and its doctor names process-1 once, never process-0.
    Both finish."""
    d = os.path.join(tmp_dir, "straggler")
    hb, flog = os.path.join(d, "hb"), os.path.join(d, "faults-rank1.jsonl")
    inc = os.path.join(d, "incidents")
    os.makedirs(d, exist_ok=True)
    delay, threshold = sz["straggler_delay_s"], sz["watchdog_s"]
    proc = _run_port(root, DOCTOR_INJECT, "--kind", "straggler", "--delay",
                     str(delay), "--seconds", "0", "--fault-log", flog,
                     timeout=120)
    require(proc.returncode == 0, f"straggler: inject {proc.stderr}")
    module = "container_engine_accelerators_tpu_torch.cli.train"
    common = [*sz["trainer"], *device_flags, "--heartbeat-dir", hb,
              "--watchdog-threshold", str(threshold), "--log-every", "10"]
    n0, n1 = sz["trainer_steps"]
    procs = []
    try:
        with open(os.path.join(d, "rank1.err"), "w") as err1, \
                open(os.path.join(d, "rank0.err"), "w") as err0:
            t1 = time.monotonic()
            procs.append(_popen_port(
                root, module, *common, "--steps", str(n1), "--fault-listen",
                flog, "--trace-dump", os.path.join(d, "train-1.json"),
                env={"RANK": "1"}, stderr=err1))
            _wait_for(lambda: os.path.exists(os.path.join(hb, "hb-1")),
                      "straggler: rank 1's heartbeat", 300)
            t0 = time.monotonic()
            procs.append(_popen_port(
                root, module, *common, "--steps", str(n0), "--doctor",
                "--doctor-dir", inc, "--trace-dump",
                os.path.join(d, "train-0.json"), env={"RANK": "0"},
                stderr=err0))
            outs = {}
            for rank, p in ((1, procs[0]), (0, procs[1])):
                out, _ = p.communicate(timeout=600)
                with open(os.path.join(d, f"rank{rank}.err")) as fh:
                    tail = fh.read()[-2000:]
                require(p.returncode == 0,
                        f"straggler: rank {rank} rc {p.returncode}: {tail}")
                outs[rank] = json.loads(out.strip().splitlines()[-1])
            t_end = time.monotonic()
    finally:
        _stop_procs(procs)
    incs = []
    for name in sorted(os.listdir(inc)) if os.path.isdir(inc) else ():
        with open(os.path.join(inc, name)) as fh:
            incs.append(json.load(fh))
    incs.sort(key=lambda i: i["seq"])
    got = [(i["class"], i["subject"]) for i in incs]
    s0, s1 = outs[0], outs[1]
    require(got.count(("straggler", "process-1")) == 1
            and ("straggler", "process-0") not in got
            and all(c in ("straggler", "recompile_storm") for c, _ in got),
            f"straggler: rank 0's doctor {got}")
    require(s0["doctor_incidents"] == len(incs),
            f"straggler: summary {s0['doctor_incidents']}, {len(incs)} "
            "bundles")
    require(s0["final_step"] == n0 and s1["final_step"] == n1,
            f"straggler: steps {s0['final_step']}, {s1['final_step']}")
    stalled = s1["goodput"]["stalled"]
    require(stalled >= n1 * delay * 0.9,
            f"straggler: rank 1's stalled bucket {stalled} s")
    strag = incs[got.index(("straggler", "process-1"))]
    return {"incidents": [{"class": i["class"], "subject": i["subject"],
                           "summary": i["summary"],
                           "after_rank0_start_s": i["ts_monotonic"] - t0}
                          for i in incs],
            "watchdog_s": threshold, "delay_s": delay,
            "heartbeat_age_at_verdict_s": strag["evidence"].get("age_s"),
            "rank1_started_before_rank0_s": t0 - t1,
            "rank0": {"final_step": s0["final_step"],
                      "tokens_per_sec": s0["tokens_per_sec"],
                      "step_ms": s0["step_ms"]},
            "rank1": {"final_step": s1["final_step"], "stalled_s": stalled},
            "both_done_after_s": t_end - t1}


def fleet_room(cfg, layers: int, shm: str) -> dict:
    """Room for the fleet's HF export at `layers` of cfg's depth: the file
    holds f32 weights (save_hf_checkpoint), and each replica reads it
    whole into host memory and copies the transposed weights once more
    before moving them to the card, so the host needs about five times
    the file while both replicas load (the file, and twice it in each)."""
    import dataclasses

    file_bytes = dataclasses.replace(cfg, n_layers=layers).num_params() * 4
    room = {"n_layers": layers, "of": cfg.n_layers, "where": shm,
            "file_bytes": file_bytes, "swept": sweep_ckpt_roots(shm),
            "shm_free_bytes": (shutil.disk_usage(shm).free
                               if os.path.isdir(shm) else 0),
            "mem_available_bytes": _mem_available_bytes()}
    require(room["shm_free_bytes"] >= file_bytes
            and room["mem_available_bytes"] >= 5 * file_bytes,
            f"replica_kill: no room for the export: {room}")
    return room


def _fleet_gauges(url: str) -> dict:
    s = _scrape(_get(url + "/metrics"))
    return {k: v for k, v in s.items() if k.startswith(
        ("fleet_replicas{", "fleet_replica_state{"))}


class FleetLaunch:
    """cli/fleet.py --replicas 2 (--keep-survivors) serving the HF export
    on the one card, each replica with --doctor, started ahead of the
    replica-kill scenario so that its replicas load while the training
    scenarios run; `ready()` gives its `fleet` line and the seconds from
    the launch to it."""

    def __init__(self, root, d: str, export_dir: str, device_flags: list,
                 sz: dict):
        self.timeout_s = sz["ready_timeout_s"] + 60
        self.t_launch = time.monotonic()
        self.proc = _popen_port(
            root, "container_engine_accelerators_tpu_torch.cli.fleet",
            "--replicas", "2", "--ready-timeout", str(sz["ready_timeout_s"]),
            "--keep-survivors", "--", "--checkpoint", export_dir,
            "--engine", "paged", "--max-batch", "2", "--max-len", "512",
            "--prefill-chunk", "0", "--prefix-cache-cap", "0", "--doctor",
            "--doctor-dir", os.path.join(d, "replica-incidents"),
            *device_flags)
        self._pool = concurrent.futures.ThreadPoolExecutor(1)
        self._line = self._pool.submit(self._wait)

    def _wait(self):
        line = _json_line(self.proc.stdout, "fleet", self.timeout_s)
        return line, time.monotonic() - self.t_launch

    def ready(self) -> tuple[dict, float]:
        try:
            return self._line.result(timeout=self.timeout_s + 10)
        finally:
            self._pool.shutdown(wait=False)


def doctor_replica_kill(root, tmp_dir, torch, launch: FleetLaunch,
                        sz) -> dict:
    """replica-kill: the fleet `launch` started (its replicas' --doctor
    on); fleetmon --doctor scrapes both; loadgen --targets fans streams
    over both and replica r1 is SIGKILLed mid-stream: replica_down once
    for r1, the fleet gauges at up 1 / down 1, the survivor answers, the
    card's memory comes back; then fleetmon's dump through `trace merge`
    and `trace doctor` gives the live verdicts."""
    d = os.path.join(tmp_dir, "replica_kill")
    os.makedirs(d, exist_ok=True)
    dump = os.path.join(d, "fleetmon.json")
    procs = [launch.proc]
    cuda = torch.cuda.is_available()

    def used():
        if not cuda:
            return None
        free, total = torch.cuda.mem_get_info()
        return total - free

    try:
        line, ready_s = launch.ready()
        reps = {r["id"]: r for r in line["replicas"]}
        require(sorted(reps) == ["r0", "r1"], f"replica_kill: {reps}")
        slos = sz.get("fleet_slos")
        fm = _popen_port(
            root, "container_engine_accelerators_tpu_torch.cli.fleetmon",
            *([json.dumps(slos)] if slos is not None else []),
            "--endpoints", ",".join(reps[r]["metrics_url"]
                                    for r in ("r0", "r1")),
            "--replica-ids", "r0,r1", "--interval",
            str(FLEETMON_INTERVAL_S), "--down-after",
            str(FLEETMON_DOWN_AFTER_S), "--timeout", "1.0", "--doctor",
            "--doctor-interval", str(FLEETMON_DOCTOR_S), "--doctor-dir",
            os.path.join(d, "fleet-incidents"), "--trace-dump", dump,
            code=FLEETMON_WITH_SLOS if slos is not None else None)
        procs.append(fm)
        fm_url = f"http://127.0.0.1:{_json_line(fm.stdout, 'fleetmon', 120)['port']}"  # noqa: E501
        targets = ",".join(reps[r]["url"] for r in ("r0", "r1"))
        # Each replica warmed at once, 2 streams each: its own TPOT.
        warming = {r: _loadgen(root, reps[r]["url"], 2, 2, 8, wait=False)
                   for r in ("r0", "r1")}
        warm = {r: _wait_loadgen(p) for r, p in warming.items()}
        require(all(rc == 0 and w["requests_ok"] == 2
                    for w, rc in warm.values()),
                f"replica_kill: warmup {warm}")
        warm = {r: w for r, (w, _) in warm.items()}
        warm_tpot = {r: {k: w["tpot_ms"][k] for k in ("p50", "p99")}
                     for r, w in warm.items()}
        _wait_for(lambda: _fleet_gauges(fm_url).get(
            "fleet_replicas{state=up}") == 2, "replica_kill: 2 up", 30)
        # Two processes time-slice the card: the stall limit follows the
        # warmup's measured TPOT, not a CPU run's.
        tpot_s = max(t["p99"] for t in warm_tpot.values()) / 1e3
        stall_s = max(5.0, 100 * tpot_s)
        used_before = used()
        fan = _loadgen(root, targets, 6, 2, sz["fan_new_tokens"],
                       "--stall-timeout-s", str(stall_s), wait=False)
        want = {"fleet_replicas{state=up}": 1.0,
                "fleet_replicas{state=down}": 1.0,
                "fleet_replica_state{replica=r0}": 2.0,
                "fleet_replica_state{replica=r1}": 0.0}
        converged: list = []

        def watch_gauges():
            # From before the kill, every 0.1 s: the first scrape of
            # fleetmon's /metrics that shows up 1 / down 1.
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if all(_fleet_gauges(fm_url).get(k) == v
                       for k, v in want.items()):
                    converged.append(time.monotonic())
                    return
                time.sleep(0.1)

        # Kill mid-stream: once the victim decodes a fanned request.
        victim = reps["r1"]["metrics_url"] + "/metrics"
        _wait_for(lambda: _scrape(_get(victim)).get("serve_active_slots",
                                                     0) >= 1,
                  "replica_kill: a stream on r1", 120)
        watcher = threading.Thread(target=watch_gauges, daemon=True)
        t_kill = time.monotonic()
        os.kill(reps["r1"]["pid"], signal.SIGKILL)
        watcher.start()
        fanned, rc = _wait_loadgen(fan)
        require(rc == 1 and fanned["requests_ok"] >= 2
                and fanned["hung_streams"] == 0
                and fanned["transport_errors"] >= 1,
                f"replica_kill: fanned loadgen rc {rc}: {fanned}")
        watcher.join(timeout=35)
        require(converged, "replica_kill: the fleet gauges never read "
                "up 1 / down 1")
        gauges_s = converged[0] - t_kill

        def verdicts(url):
            return json.loads(_get(url + "/debugz?n=0&doctor=1"))[
                "doctor"].get("incidents", [])

        _wait_for(lambda: verdicts(fm_url), "replica_kill: a verdict", 15)
        survivor, rc = _loadgen(root, reps["r0"]["url"], 3, 2, 8)
        require(rc == 0 and survivor["requests_ok"] == 3
                and survivor["errors"] == 0,
                f"replica_kill: survivor {survivor}")
        freed = None
        if used_before is not None:
            _wait_for(lambda: used() < used_before - (2 << 30),
                      "replica_kill: the victim's card memory back", 30)
            freed = used_before - used()
        replica_verdicts = verdicts(reps["r0"]["metrics_url"])
        time.sleep(2 * FLEETMON_DOCTOR_S)
        live = verdicts(fm_url)
        os.killpg(fm.pid, signal.SIGTERM)   # fleetmon dumps its ring
        fm.wait(timeout=60)
    finally:
        _stop_procs(procs)
    got = [(i["class"], i["subject"]) for i in live]
    require(got.count(("replica_down", "r1")) == 1
            and all(c in ("replica_down", "engine_hang") for c, _ in got)
            and all(s == "r1" for c, s in got if c == "replica_down"),
            f"replica_kill: fleetmon's doctor {got}; the replicas' warmup "
            f"TPOT ms {warm_tpot}, fleetmon's SLOs "
            f"{slos if slos is not None else 'the defaults'}")
    early = [i["class"] for i in live if i["ts_monotonic"] < t_kill - 0.5
             and i["class"] != "engine_hang"]
    require(not early, f"replica_kill: incidents before the kill {early}")
    merged = os.path.join(d, "merged.json")
    trace = "container_engine_accelerators_tpu_torch.cli.trace"
    proc = _run_port(root, trace, "merge", dump, "-o", merged, timeout=120)
    require(proc.returncode == 0, f"replica_kill: merge {proc.stderr}")
    proc = _run_port(root, trace, "doctor", merged, "--json", "--interval",
                     str(FLEETMON_DOCTOR_S), timeout=300)
    require(proc.returncode == 0, f"replica_kill: trace doctor "
            f"{proc.stderr[-1500:]}")
    replay = [json.loads(line) for line in proc.stdout.splitlines()
              if line.startswith("{")]
    replayed = [(i["class"], i["subject"]) for i in replay]
    require(sorted(replayed) == sorted(got),
            f"replica_kill: replay {replayed}, live {got}")
    with open(merged) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    missing = [n for n in ("fleet/scrape_error", "fleet/replica_state",
                           "doctor/replica_down") if n not in names]
    require(not missing, f"replica_kill: not in fleetmon's dump {missing}")
    down = [i for i in live if i["class"] == "replica_down"][0]
    return {"incidents": [{"class": c, "subject": s} for c, s in got],
            "replayed": [{"class": c, "subject": s} for c, s in replayed],
            "replica_down_after_kill_s": down["ts_monotonic"] - t_kill,
            "gauges_converged_after_kill_s": gauges_s,
            "fleetmon": {"interval_s": FLEETMON_INTERVAL_S,
                         "down_after_s": FLEETMON_DOWN_AFTER_S,
                         "doctor_interval_s": FLEETMON_DOCTOR_S},
            "fleet_slos": slos or "defaults",
            "replicas_ready_s": ready_s, "stall_timeout_s": stall_s,
            "warmup": warm, "warmup_tpot_ms": warm_tpot, "fanned": fanned,
            "survivor": survivor,
            "survivor_tpot_ms": [warm["r0"].get("tpot_ms"),
                                 survivor.get("tpot_ms")],
            "card_bytes_freed_by_kill": freed,
            "survivor_doctor": [{"class": i["class"],
                                 "subject": i["subject"],
                                 "summary": i["summary"]}
                                for i in replica_verdicts]}


def doctor_phase(torch, dev, np, tmp_dir: str, model=None, cfg=None,
                 sizes: dict | None = None, shm: str = CKPT_SHM) -> dict:
    """The doctor and the fleet plane on the card (the module docstring's
    `doctor`): llama3_8b at full width and depth unless a model is given,
    the scenarios in order, the model freed before the training ones."""
    import dataclasses

    import container_engine_accelerators_tpu_torch as port
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models.convert import (
        save_hf_checkpoint,
    )
    from container_engine_accelerators_tpu_torch.models.llama import (
        init_params,
        llama3_8b,
    )
    from container_engine_accelerators_tpu_torch.models.spec import (
        truncate_params,
    )

    sz = {**DOCTOR_SIZES, **(sizes or {})}
    root = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))
    device_flags = ["--device", "cpu"] if dev.type == "cpu" else []
    if model is None:
        cfg = llama3_8b()
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                            dev)
    scen, launches, seconds = {}, {}, {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        kernels.reset_launches()
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        for key, n in kernels.launches.items():
            launches[key] = launches.get(key, 0) + n
        seconds[name] = time.perf_counter() - t0
        emit({"phase": f"doctor_{name}", **{k: v for k, v in out.items()
                                            if k != "launches"}})
        return out

    scen["engine_hang"] = timed("engine_hang", doctor_hang, root, tmp_dir,
                                model, cfg, sz)
    scen["worker_kill"] = timed("worker_kill", doctor_worker_kill, root,
                                tmp_dir, model, cfg, sz)
    scen.update(timed("pool_and_node", doctor_pool_and_node, root, tmp_dir,
                      torch, dev, model, cfg, sz))
    room = fleet_room(cfg, sz["fleet_layers"], shm)
    export = tempfile.mkdtemp(
        prefix=f"{CKPT_ROOT_PREFIX}{os.getpid()}-fleet-", dir=shm)
    launch = None
    try:
        t0 = time.perf_counter()
        cut = truncate_params(model, sz["fleet_layers"])
        save_hf_checkpoint(cut, cut.cfg, export)
        room["export_s"] = time.perf_counter() - t0
        del cut, model
        _free_card(torch)
        # The replicas load while data-stall and straggler run.
        fleet_dir = os.path.join(tmp_dir, "replica_kill")
        os.makedirs(fleet_dir, exist_ok=True)
        launch = FleetLaunch(root, fleet_dir, export, device_flags, sz)
        scen["data_stall"] = timed(
            "data_stall", doctor_data_stall, root, tmp_dir, torch, dev,
            dataclasses.replace(cfg, n_layers=2), sz)
        scen["straggler"] = timed("straggler", doctor_straggler, root,
                                  tmp_dir, sz, device_flags)
        scen["replica_kill"] = timed("replica_kill", doctor_replica_kill,
                                     root, tmp_dir, torch, launch, sz)
    finally:
        if launch is not None:
            _stop_procs([launch.proc])
        shutil.rmtree(export, ignore_errors=True)
    for name in ("decode_attention", "paged_decode_attention",
                 *FLASH_REPLACES):
        require(launches.get(name, 0) > 0, f"doctor: no {name} launch")
    result = {"phase": "doctor", "model": "llama3_8b",
              "n_layers": cfg.n_layers, "fleet": room,
              "scenarios": scen, "seconds": seconds, "launches": launches,
              "launches_not_counted": "the subprocesses' (trainers and "
              "replicas)", "nvidia_smi": nvidia_smi_line()}
    emit({"phase": "doctor_summary", **doctor_summary(result)})
    return result


def doctor_summary(res: dict) -> dict:
    """The numbers PERF.md keeps: each scenario's verdicts and their
    latency, the ring's and the taps' drops, and the real climb's
    projection beside its outcome."""
    out = {}
    for name, s in res["scenarios"].items():
        out[name] = {
            "verdicts": [(i["class"], i["subject"])
                         for i in s.get("incidents", [])],
            "latency_s": [i.get("after_fault_s",
                                i.get("after_rank0_start_s"))
                          for i in s.get("incidents", [])],
            **{k: s[k] for k in ("ring_dropped", "tap_dropped",
                                 "projected_tte_s", "actual_tte_s",
                                 "headroom_bytes_at_verdict",
                                 "replica_down_after_kill_s",
                                 "gauges_converged_after_kill_s",
                                 "card_bytes_freed_by_kill",
                                 "survivor_doctor", "stalled_s",
                                 "stall_step_data_wait_s",
                                 "heartbeat_age_at_verdict_s")
               if k in s}}
    return out


def doctor_main(torch) -> int:
    """`chip_smoke.py doctor`: the build and the doctor phase alone."""
    import numpy as np

    from container_engine_accelerators_tpu_torch import kernels

    t0 = time.perf_counter()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi_line()})
    kernels.build()
    kernels.load()
    seconds = {"build": time.perf_counter() - t0}
    try:
        with tempfile.TemporaryDirectory() as tmp_dir, \
                _removed_on_sigterm():
            t0 = time.perf_counter()
            doctor_phase(torch, torch.device("cuda", 0), np, tmp_dir)
            seconds["doctor"] = time.perf_counter() - t0
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    emit({"phase_seconds": seconds})
    return 0


def time_roots(sub: str, flags: list[str], roots: list[str],
               timeout: float) -> int:
    """Run `chip_smoke.py SUB FLAGS` once for each ROOT, in order, each in
    a process of its own that imports the port from that checkout (-P:
    from PYTHONPATH, not from this file's directory); stop at the first
    that fails."""
    for root in roots:
        rc = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__), sub, *flags],
            env=dict(os.environ, PYTHONPATH=os.path.abspath(root)),
            timeout=timeout).returncode
        if rc:
            return rc
    return 0


def k4_timing(torch, dev, b: int, s: int) -> dict:
    """K4's ms beside SDPA's forward (timing only) in each k4_* case, on
    flash_phase's inputs at B x S."""
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as fa,
    )

    res = {"B": b, "S": s}
    for case, causal, seg, q, k, v, _ in _flash_cases(torch, dev, b, s):
        res[case] = device_ms(
            torch, lambda: fa.flash_fwd_cuda(q, k, v, seg, causal))
        sdpa, qt, kt, vt = _flash_sdpa(torch, q, k, v, seg, causal)
        res[f"{case}_sdpa"] = device_ms(
            torch, functools.partial(sdpa, qt.detach(), kt.detach(),
                                     vt.detach()), iters=10)
    return res


def k4_main(torch, argv: list[str]) -> int:
    """`chip_smoke.py k4`: see the module's docstring."""
    import argparse

    from container_engine_accelerators_tpu_torch import kernels

    ap = argparse.ArgumentParser(prog="chip_smoke.py k4")
    ap.add_argument("roots", nargs="*", metavar="ROOT",
                    help="a checkout to time in a process of its own")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)
    if not args.roots:
        kernels.load()
        emit({"phase": "k4_timing", "nvidia_smi": nvidia_smi_line(),
              "kernels": os.path.dirname(kernels.__file__),
              **k4_timing(torch, torch.device("cuda", 0), args.batch,
                          args.seq)})
        return 0
    return time_roots("k4", ["--batch", str(args.batch), "--seq",
                             str(args.seq)], args.roots, 600)


def bwd_timing(torch, dev, b: int, s: int) -> dict:
    """K5's and K6's ms in each k5_*/k6_* case beside SDPA's backward
    (timing only; whole, and with only q requiring grad), and K4's, on
    flash_phase's inputs at B x S; each kernel's backward inputs come from
    K4."""
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as fa,
    )

    res = {"B": b, "S": s}
    for case, causal, seg, q, k, v, do in _flash_cases(torch, dev, b, s):
        out, lse = fa.flash_fwd_cuda(q, k, v, seg, causal)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, seg, do, lse, delta.contiguous(), causal)
        ms = {"k4": device_ms(
                  torch, lambda: fa.flash_fwd_cuda(q, k, v, seg, causal)),
              "k5": device_ms(torch, lambda: fa.flash_bwd_dq_cuda(*args)),
              "k6": device_ms(torch, lambda: fa.flash_bwd_dkv_cuda(*args))}
        sdpa = _sdpa_times(torch, q, k, v, seg, causal, do)
        res[case] = {**ms, "pair": ms["k5"] + ms["k6"], **sdpa,
                     "pair_over_sdpa": ((ms["k5"] + ms["k6"])
                                        / sdpa["sdpa_backward_ms"])}
        del out, lse, delta, args
    return res


def bwd_main(torch, argv: list[str]) -> int:
    """`chip_smoke.py bwd`: see the module's docstring."""
    import argparse

    import numpy as np

    from container_engine_accelerators_tpu_torch import kernels

    ap = argparse.ArgumentParser(prog="chip_smoke.py bwd")
    ap.add_argument("roots", nargs="*", metavar="ROOT",
                    help="a checkout to time in a process of its own")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--train", action="store_true",
                    help="also the 8-layer llama3_8b train step")
    args = ap.parse_args(argv)
    if not args.roots:
        dev = torch.device("cuda", 0)
        kernels.load()
        res = {"phase": "bwd_timing", "nvidia_smi": nvidia_smi_line(),
               "kernels": os.path.dirname(kernels.__file__),
               **bwd_timing(torch, dev, args.batch, args.seq)}
        if args.train:
            gc.collect()
            torch.cuda.empty_cache()
            train = train_phase(torch, dev, np)
            res["train"] = {key: train[key] for key in (
                "median_step_ms", "step_ms_after_first",
                "device_busy_ms_per_step", "flash_ms_per_step")}
            res["train"]["flash_attention_ms_per_step"] = (
                train["device_ms_per_step_by_kind"].get("flash_attention"))
        emit(res)
        return 0
    return time_roots("bwd", ["--batch", str(args.batch), "--seq",
                              str(args.seq),
                              *(["--train"] if args.train else [])],
                      args.roots, 900)


def k2_timing(torch, dev) -> dict:
    """K2's and the library call's device ms in every k2_* case (cold
    weights, timing only: the full smoke checks them), and K7's beside
    torch.mul in turns."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    res = {}
    for name, t, d, f, kind in K2_CASES:
        x, qws = _k2_inputs(torch, dev, gen, t, d, f, kind)
        res[name] = k2_times(torch, dev, x, qws)
        del x, qws
    x = torch.randn(4096, 4096, generator=gen, device=dev)
    res["k7"] = k7_times(torch, x)
    return res


def k2_main(torch, argv: list[str]) -> int:
    """`chip_smoke.py k2`: see the module's docstring."""
    import argparse

    import numpy as np

    from container_engine_accelerators_tpu_torch import kernels

    ap = argparse.ArgumentParser(prog="chip_smoke.py k2")
    ap.add_argument("roots", nargs="*", metavar="ROOT",
                    help="a checkout to time in a process of its own")
    ap.add_argument("--int8", action="store_true",
                    help="also llama3_8b's prefill and decode step on int8 "
                         "weights, beside bf16")
    args = ap.parse_args(argv)
    flags = ["--int8"] if args.int8 else []
    if not args.roots:
        dev = torch.device("cuda", 0)
        kernels.load()
        res = {"phase": "k2_timing", "nvidia_smi": nvidia_smi_line(),
               "kernels": os.path.dirname(kernels.__file__),
               **k2_timing(torch, dev)}
        if args.int8:
            from container_engine_accelerators_tpu_torch.models.llama import (
                init_params,
                llama3_8b,
            )
            from container_engine_accelerators_tpu_torch.ops.quant import (
                quantize_llama_params,
            )

            cfg = llama3_8b()
            model = init_params(
                cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
            res["int8"] = int8_timing(
                torch, dev, model, quantize_llama_params(model), cfg,
                _int8_batch(torch, dev, np, cfg))
        emit(res)
        return 0
    return time_roots("k2", flags, args.roots, 900)


def decode_timing(torch, dev) -> dict:
    """K1's and K3's device ms in every k1_* and k3_* case and KV mode,
    on inputs from a seed (timing only: the full smoke checks them)."""
    from container_engine_accelerators_tpu_torch.ops import (
        decode_attention as da,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    res = {}
    for mode in ("bf16", *KV_MODES):
        for name, t, b, lens in K1_CASES:
            args = _k1_args(torch, dev, gen, t, b, lens, mode)
            res[f"k1_{mode}_{name}"] = device_ms(
                torch, lambda: da.decode_attention_cuda(*args))
        for name, t, lens in K3_CASES:
            args = _k3_args(torch, dev, gen, t, lens, mode)
            res[f"k3_{mode}_{name}"] = device_ms(
                torch, lambda: da.paged_decode_attention_cuda(*args))
        del args
    return res


def engine_tick(torch, np, model, cfg, new_tokens: int = 64) -> dict:
    """The paged engine's own tick at 8 slots (page 128, the default
    pool): 8 streamed requests of 128 tokens submitted together, straight
    to the engine; the gaps between a request's token events (their
    `ts`) once all 8 decode are the engine loop's wall ms a tick, host
    bookkeeping (and, where the engine has them, its recorder and phase
    clock) included. Takes only what every version of the engine has
    (no recorder argument), so a parent checkout runs it too."""
    import queue as queue_mod

    prompt = _prompts(np, cfg, SEED + 7)
    engine = paged_engine(model, cfg)
    try:
        for n in (4, new_tokens):      # a warm-up burst, then the timed one
            streams = [queue_mod.Queue() for _ in range(8)]
            for q in streams:
                engine.submit(prompt(128), n, 0.0, stream=q)
            ts = []
            for q in streams:
                events = []
                while not events or "done" not in events[-1]:
                    events.append(q.get(timeout=600))
                require("error" not in events[-1], f"engine tick {events}")
                ts.append([e["ts"] for e in events if "token" in e])
    finally:
        engine.stop()
        engine.thread.join(timeout=60)
    # Ticks after every request's first token: all 8 slots decode.
    start = max(t[0] for t in ts)
    gaps = sorted(b - a for t in ts for a, b in zip(t, t[1:]) if a >= start)
    return {"engine_tick_ms_8_slots": gaps[len(gaps) // 2] * 1e3,
            "engine_tick_ms_p90": gaps[int(len(gaps) * 0.9)] * 1e3,
            "engine_ticks_timed": len(gaps) // 8}


def tick_timing(torch, dev, np, model, cfg) -> dict:
    """paged_tick on llama3_8b at full width and depth (random weights
    from the seed): wall and device-busy ms per tick; and the paged
    engine's own tick (engine_tick)."""
    tick = paged_tick(torch, dev, np, model, cfg)
    return {**{key: tick[key] for key in (
        "paged_decode_tick_ms_8_slots", "device_busy_ms_per_tick",
        "device_idle_share", "launches_per_tick", "top_kernels_ms_per_tick")},
        **engine_tick(torch, np, model, cfg)}


# The bodies of kernels/decode_attention.cu as torch.profiler names them;
# decode_attention_kernel is the prefill body before prefill_mma_kernel,
# so that an older checkout's prefill reads the same.
K1_BODIES = ("prefill_mma_kernel", "decode_split_kernel",
             "decode_attention_kernel")


def prefill_timing(torch, dev, np, model, cfg, runs: int = 8) -> dict:
    """One llama3_8b prefill of 2 x 512 new tokens from an empty cache
    through decode_step (the window engine's prefill): wall ms,
    device-synchronised around `runs` prefills, and from torch.profiler
    the device-busy ms, K1's ms and its share of the busy time."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models import decode

    b, t = 2, 512
    prompt = _prompts(np, cfg, SEED + 6)
    tokens = torch.tensor([prompt(t) for _ in range(b)], device=dev)
    cache = decode.init_cache(cfg, b, 2048, dev)

    def prefill():
        decode.decode_step(model, cache, tokens, cfg)

    for _ in range(2):
        prefill()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(runs):
        prefill()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / runs * 1e3
    launches = {name: n / runs for name, n in kernels.launches.items()}
    profile = profile_steps(torch, prefill)
    busy = profile["busy_ms_per_step"]
    k1_ms = None if busy is None else sum(
        ms for name, ms in profile["kernels"].items()
        if any(body in name for body in K1_BODIES))
    return {"prefill_2x512_ms": wall_ms, "device_busy_ms": busy,
            "k1_ms": k1_ms, "k1_share": None if busy is None else k1_ms / busy,
            "launches_per_prefill": launches,
            "top_kernels_ms": profile["top"]}


def decode_main(torch, argv: list[str]) -> int:
    """`chip_smoke.py decode`: see the module's docstring."""
    import argparse

    import numpy as np

    from container_engine_accelerators_tpu_torch import kernels

    ap = argparse.ArgumentParser(prog="chip_smoke.py decode")
    ap.add_argument("roots", nargs="*", metavar="ROOT",
                    help="a checkout to time in a process of its own")
    ap.add_argument("--tick", action="store_true",
                    help="also the paged tick on llama3_8b")
    ap.add_argument("--prefill", action="store_true",
                    help="also a 2 x 512 prefill on llama3_8b")
    args = ap.parse_args(argv)
    flags = [f"--{name}" for name in ("tick", "prefill")
             if getattr(args, name)]
    if not args.roots:
        dev = torch.device("cuda", 0)
        kernels.load()
        res = {"phase": "decode_timing", "nvidia_smi": nvidia_smi_line(),
               "kernels": os.path.dirname(kernels.__file__),
               **decode_timing(torch, dev)}
        if flags:
            from container_engine_accelerators_tpu_torch.models.llama import (
                init_params,
                llama3_8b,
            )

            cfg = llama3_8b()
            model = init_params(
                cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
            if args.tick:
                res["tick"] = tick_timing(torch, dev, np, model, cfg)
            if args.prefill:
                res["prefill"] = prefill_timing(torch, dev, np, model, cfg)
        emit(res)
        return 0
    return time_roots("decode", flags, args.roots, 600)


def training_phases(torch, dev, np, timed) -> dict:
    """The training path's phases in order, the card's memory freed
    between them: train under 'dots' then 'dots_save_attn', train_parity,
    train_cli, ckpt, observe_train, eval and serve_ckpt on the ckpt
    phase's checkpoint."""
    from container_engine_accelerators_tpu_torch.models.llama import (
        llama3_8b,
    )

    out = {}
    for name, fn, *args in (
            ("train", train_phase, torch, dev, np),
            ("train_save_attn", functools.partial(
                train_phase, remat_policy="dots_save_attn"), torch, dev, np),
            ("train_parity", train_parity_phase, torch, dev, np),
            ("train_cli", train_cli_phase)):
        out[name] = timed(name, fn, *args)
        _free_card(torch)
    with tempfile.TemporaryDirectory() as tmp_dir, _removed_on_sigterm():
        room = ckpt_room(tmp_dir)
        root = tempfile.mkdtemp(prefix=f"{CKPT_ROOT_PREFIX}{os.getpid()}-",
                                dir=room["where"])
        try:
            out["ckpt"] = timed("ckpt", ckpt_phase, torch, dev, np, tmp_dir,
                                root, llama3_8b(n_layers=room["n_layers"]))
            out["ckpt"]["room"] = room
            ckpt_dir = out["ckpt"]["ckpt_dir"]
            for name, fn, *args in (
                    ("observe_train", observe_train_phase, torch, dev, np,
                     tmp_dir),
                    ("eval", eval_phase, torch, dev, np, ckpt_dir, tmp_dir),
                    ("serve_ckpt", serve_ckpt_phase, torch, dev, np,
                     ckpt_dir)):
                out[name] = timed(name, fn, *args)
                _free_card(torch)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        room["shm_free_bytes_after"] = shutil.disk_usage(room["where"]).free
        emit({"phase": "ckpt_room", **room})
    return out


def training_summary(tr: dict) -> dict:
    train, saved = tr["train"], tr["train_save_attn"]
    ck = tr["ckpt"]
    return {
        "median_step_ms": train["median_step_ms"],
        "tokens_per_s": train["tokens_per_s"], "mfu": train["mfu"],
        "device_busy_share": train["device_busy_share"],
        "max_memory_allocated_bytes": train["max_memory_allocated_bytes"],
        "dots_save_attn": {
            key: saved[key] for key in ("median_step_ms", "mfu",
                                        "max_memory_allocated_bytes",
                                        "launches_per_step")},
        "dots_save_attn_step_ms_over_dots":
            saved["median_step_ms"] / train["median_step_ms"],
        "dots_save_attn_extra_bytes": (saved["max_memory_allocated_bytes"]
                                       - train["max_memory_allocated_bytes"]),
        "parity_max_grad_rel_diff": tr["train_parity"]["max_grad_rel_diff"],
        "cli_tokens_per_sec": tr["train_cli"]["tokens_per_sec"],
        "ckpt_n_layers": ck["n_layers"],
        "ckpt_save_gb_per_s": ck["sync"]["save_gb_per_s"],
        "ckpt_restore_gb_per_s": ck["sync"]["restore_gb_per_s"],
        "ckpt_async_step_path_over_sync": ck["async_step_path_over_sync"],
        "resume_bit_identical": [ck["sync"]["bit_identical"],
                                 ck["async"]["bit_identical"]],
        "observe_train_mfu": [tr["observe_train"]["recorder_mfu"],
                              tr["observe_train"]["wall_clock_mfu"]],
        "eval_loss": tr["eval"]["eval_loss"],
        "serve_ckpt_tokens_equal_generate": [
            tr["serve_ckpt"]["bf16"]["tokens_equal_generate"],
            tr["serve_ckpt"]["int8"]["tokens_equal_generate"]]}


def training_main(torch, dev, np) -> int:
    """`chip_smoke.py training`: see the module's docstring."""
    from container_engine_accelerators_tpu_torch import kernels

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi_line()})
    timed("build", kernels.build)
    kernels.load()
    try:
        tr = training_phases(torch, dev, np, timed)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    emit({"phase_seconds": seconds})
    emit({"train_summary": training_summary(tr)})
    return 0


def node_main(torch) -> int:
    """`chip_smoke.py node`: the build (the container's K4 loads it) and
    the node phase alone."""
    from container_engine_accelerators_tpu_torch import kernels

    t0 = time.perf_counter()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi_line()})
    kernels.build()
    seconds = {"build": time.perf_counter() - t0}
    try:
        with tempfile.TemporaryDirectory() as tmp_dir:
            t0 = time.perf_counter()
            node_phase(torch, torch.device("cuda", 0), tmp_dir)
            seconds["node"] = time.perf_counter() - t0
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    emit({"phase_seconds": seconds})
    return 0


def vision_main(torch) -> int:
    """`chip_smoke.py vision`: the build and the vision phase alone."""
    import numpy as np

    from container_engine_accelerators_tpu_torch import kernels

    t0 = time.perf_counter()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi_line()})
    kernels.build()
    seconds = {"build": time.perf_counter() - t0}
    try:
        t0 = time.perf_counter()
        vision_phase(torch, torch.device("cuda", 0), np)
        seconds["vision"] = time.perf_counter() - t0
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    emit({"phase_seconds": seconds})
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from container_engine_accelerators_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["k4"]:
        return k4_main(torch, sys.argv[2:])
    if sys.argv[1:2] == ["bwd"]:
        return bwd_main(torch, sys.argv[2:])
    if sys.argv[1:2] == ["decode"]:
        return decode_main(torch, sys.argv[2:])
    if sys.argv[1:2] == ["k2"]:
        return k2_main(torch, sys.argv[2:])
    if sys.argv[1:2] == ["training"]:
        return training_main(torch, torch.device("cuda", 0), np)
    if sys.argv[1:2] == ["node"]:
        return node_main(torch)
    if sys.argv[1:2] == ["doctor"]:
        return doctor_main(torch)
    if sys.argv[1:2] == ["vision"]:
        return vision_main(torch)
    if sys.argv[1:2] == ["telemetry"]:
        return telemetry_main(torch)
    if sys.argv[1:2] == ["moe"]:
        return moe_main(torch)

    try:
        dev = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")

        seconds = {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            seconds[name] = time.perf_counter() - t0
            return out

        lib = timed("build", kernels.build)
        kernels.load()
        emit({"phase": "build", "seconds": seconds["build"],
              "library": os.path.basename(lib)})

        k1 = timed("k1", k1_phase, torch, dev)
        k2 = timed("k2", k2_phase, torch, dev)
        k3 = timed("k3", k3_phase, torch, dev)
        k1q = {mode: timed(f"k1_{mode}", k1_quant_phase, torch, dev, mode)
               for mode in KV_MODES}
        k3q = {mode: timed(f"k3_{mode}", k3_quant_phase, torch, dev, mode)
               for mode in KV_MODES}
        serve, model, cfg = timed("serve", serve_phase, torch, dev, np)
        int8 = timed("int8", int8_phase, torch, dev, np, model, cfg)
        paged = timed("paged", paged_phase, torch, dev, np, model, cfg)
        preempt = timed("paged_preempt", paged_preempt_phase, torch, dev,
                        np, model, cfg)
        cont = timed("continuous", continuous_phase, torch, dev, np, model,
                     cfg)
        kvq = timed("kv_quant", kv_quant_phase, torch, dev, np, model, cfg,
                    preempt)
        obs = timed("observe", observe_phase, torch, dev, np, model, cfg)
        spec = timed("spec", spec_phase, torch, dev, np, model, cfg)
        pools = timed("pools", pools_phase, torch, dev, np, model, cfg)
        sup = timed("supervise", supervise_phase, torch, dev, np, model,
                    cfg)
        del model   # the training phases need the card's memory
        gc.collect()
        torch.cuda.empty_cache()
        moe = timed("moe", moe_phase, torch, dev, np)
        flash = timed("flash", flash_phase, torch, dev)
        tr = training_phases(torch, dev, np, timed)
        with tempfile.TemporaryDirectory() as tmp_dir:
            health = timed("health", health_phase, torch, dev, tmp_dir)
        with tempfile.TemporaryDirectory() as tmp_dir:
            timed("node", node_phase, torch, dev, tmp_dir)
        timed("vision", vision_phase, torch, dev, np)
        with tempfile.TemporaryDirectory() as tmp_dir:
            tele = timed("telemetry", telemetry_phase, torch, dev, np,
                         tmp_dir, paged["paged_decode_tick_ms_8_slots"])
        with tempfile.TemporaryDirectory() as tmp_dir, \
                _removed_on_sigterm():
            doc = timed("doctor", doctor_phase, torch, dev, np, tmp_dir)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    emit({"phase_seconds": seconds})

    def launches(name):
        return sum(phase["launches"].get(name, 0)
                   for phase in (serve, int8, paged, preempt, cont, kvq,
                                 obs, spec, pools, sup, moe,
                                 tr["serve_ckpt"], tele, doc))

    def flash_launches(name):
        return sum(tr[phase]["launches"].get(name, 0)
                   for phase in ("train", "train_save_attn", "ckpt",
                                 "observe_train", "eval")) + sum(
                                     phase["launches"].get(name, 0)
                                     for phase in (moe, tele, doc))

    def prefill(case):
        """The main prefill case of K1 or K3, beside decode's."""
        return {"prefill_ms": case["ms"], "prefill_bound_ms": case["bound_ms"],
                "prefill_library_ms": case["library_ms"]}

    def verify(case):
        """The verify case of K1, K2 or K3 (T 5 at 16 slots; N 80)."""
        return {"verify_ms": case["ms"], "verify_bound_ms": case["bound_ms"],
                "verify_library_ms": case["library_ms"],
                **({"verify_decode_steps_ms": case["decode_steps_ms"]}
                   if "decode_steps_ms" in case else {})}

    def quant_entries(base, source, replaces, results, main_case,
                      prefill_case):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "bf16_kernel_ms", "library")
        return [{"name": f"{base}_{mode}", "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches(f"{base}_{mode}"),
                 "max_abs_err": max(r["max_abs_err"]
                                    for r in results[mode].values()),
                 "max_row_rel_err": max(r["max_row_rel_err"]
                                        for r in results[mode].values()),
                 **{key: results[mode][main_case][key] for key in keys},
                 **prefill(results[mode][prefill_case])}
                for mode in KV_MODES]

    k1_row, k2_row, k3_row = (k1["decode_slots"], k2["w_gate_t8"],
                              k3["decode"])
    emit({"kernels": [
        {"name": "decode_attention", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches("decode_attention"),
         "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
         "max_row_rel_err": max(r["max_row_rel_err"] for r in k1.values()),
         **{key: k1_row[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
         **prefill(k1["prefill_512"]), **verify(k1["verify_k4"])},
        {"name": "int8_matmul", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches("int8_matmul"),
         "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
         **{key: k2_row[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
         **prefill(k2["w_gate_t1024"]), **verify(k2["w_gate_t80"])},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": K3_SOURCE, "replaces": K3_REPLACES,
         "launches": launches("paged_decode_attention"),
         "max_abs_err": max(r["max_abs_err"] for r in k3.values()),
         "max_row_rel_err": max(r["max_row_rel_err"] for r in k3.values()),
         **{key: k3_row[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "k1_contiguous_ms", "library")},
         **prefill(k3["prefill_chunk_512"]), **verify(k3["verify_k4"])},
        *({"name": name, "route": "cuda", "source": FLASH_SOURCE,
           "replaces": FLASH_REPLACES[name],
           "launches": flash_launches(name),
           "max_abs_err": max(r["max_abs_err"] for r in flash[name].values()),
           "max_row_rel_err": max(r["max_row_rel_err"]
                                  for r in flash[name].values()),
           **flash[name]["main"]} for name in FLASH_REPLACES),
        *quant_entries("decode_attention", K1_SOURCE, K1_REPLACES, k1q,
                       "decode_slots", "prefill_512"),
        *quant_entries("paged_decode_attention", K3_SOURCE, K3_REPLACES, k3q,
                       "decode", "prefill_chunk_512"),
        {"name": "scale_demo", "route": "cuda", "source": K7_SOURCE,
         "replaces": K7_REPLACES,
         "launches": health["launches"].get("scale_demo", 0),
         **{key: health[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "library", "ms_runs",
                                         "library_ms_runs")}},
    ]})
    emit({"train_summary": training_summary(tr)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
