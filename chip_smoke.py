#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``paddle_tpu_torch/csrc``
with ``nvcc`` (one process per source, all at once; it fails if a
tensor-core kernel or K1's split-context pair spills registers) and holds
each kernel against its plain PyTorch version (K1 paged attention, K2
flash forward, K3 flash backward, K4 and K5 packed varlen forward and
backward, each in fp32, bf16 and fp16; K1 runs its scalar fp32 route and
its split-context bf16 and fp16 route, at serving's contexts and at the
edges of a split, twice for bit-identity; K2 to K5 run their scalar fp32
route and their tensor-core bf16 and fp16 route, and each 16-bit K2/K3
bound is held to twice the error of ``scaled_dot_product_attention``,
each 16-bit K4/K5 bound to twice that of PyTorch's varlen flash op, in
the same dtype against the same plain version, printed beside it). Then
it drives the port's main paths, each with the launch counts (in all and
by route) set to 0 just before it and read just after:

- serving: GPT-124M at full width (random weights from a seed) through
  ``ServingEngine`` with and without speculative decoding, each with the
  compile cache off (eager steps) and on (decode and verify replayed from
  CUDA graphs; the same tokens required, TPOT and tokens/s side by side),
  K1's device time per decode step from one more run under the profiler,
  and the fp32 engine's greedy tokens against the port's own ``generate``
  plus a full-width forward against the dense path;
- the serving fleet: GPT-124M in fp32 from a bundle, the port's
  ``TCPStore``, a ``ServingRouter``, replica A in this process with the
  compile cache on, and replica B spawned by ``Autoscaler.scale_out`` as
  a process through the replica CLI, finding A's cache entries; 16
  requests arrive every 50 ms, ``Autoscaler.scale_in`` drains a replica
  halfway, every request must come back ok with the tokens of one engine
  with the cache off, and K1 must launch once per layer and dispatch of
  A, graph replays counted (wall time, tokens/s, TTFT and TPOT p50,
  re-routed requests, cache hits, misses and graphs per replica);
- training: GPT-124M pretraining steps as ``bench.py`` runs them (batch
  16 x 1024 tokens, bf16 O2, AdamW at lr 1e-4) through
  ``CompiledTrainStep``, per call and through ``run_steps``; then a
  full-width, 2-layer fp32 step on the card against the same step on the
  CPU (loss and every gradient);
- eager fp16 AMP training: GPT-124M at the same widths through the
  upstream recipe (``amp.decorate`` O2 fp16, ``auto_cast``,
  ``GradScaler(2**15)``, AdamW under a warm-up/cosine schedule with a
  global-norm clip), 3 warm-up and 10 timed steps: tokens/s, the scale
  trajectory, skipped steps, the rate per step and peak memory, with K2
  and K3 launched once per layer and step on their fp16 route; then one
  2-layer fp16 O2 step against the same step in fp32 O0 on the card;
- scheduled training: GPT-124M through ``CompiledTrainStep`` at O2 bf16
  with ``examples/train_gpt.py``'s surface (cosine schedule, global-norm
  clip, ``FLAGS_check_nan_inf``, the StepMeter), per call and through
  ``run_steps`` (with the flag clear: ``run_steps`` refuses it), the
  rate each step read against the scheduler's sequence, the meter's
  tokens/s beside the host clock's, one
  ``use_rmsnorm=True`` step; then two eager fp32 steps of the recipe at
  O0 (the scaler enabled) on the card against the CPU, with LayerNorm and
  with RMSNorm;
- packed attention: ``F.flash_attn_unpadded`` forward and backward over
  16,384 packed tokens of ragged documents at GPT-124M's attention width
  (12 heads of 64), causal, bf16; then the same in fp32 against the
  per-segment plain versions;
- ERNIE-3.0-base pretraining (``ErnieForPretraining``, batch 16 x 512,
  bf16 O2, AdamW at lr 1e-4) and BERT-base finetuning
  (``BertForSequenceClassification``, batch 32 x 128, bf16 O2, AdamW at
  lr 2e-5), as ``benchmarks/matrix.py`` runs them, through
  ``CompiledTrainStep`` per call and through ``run_steps`` (K = 8 and
  16): step ms, tokens/s, sequences/s and MFU, with K2 and K3 non-causal
  once per layer and step; then each at full width and 2 layers in fp32
  on the card against the CPU (loss and every gradient; for ERNIE also a
  padded batch's forward on the dense path).

- the ``paddle.*`` eager surface: GPT-124M's eager fp16 AMP loop
  written as an upstream user writes it (``paddle.seed``,
  ``paddle.set_device("gpu")``, ``paddle.to_tensor`` batches, a loss that
  is a paddle Tensor, ``float(loss)``), bit-equal to the same steps fed
  torch tensors (losses, scales, every final parameter), with K2 and K3
  once per layer and step on their fp16 route and tokens/s both ways;
  ``paddle.grad`` through ``F.flash_attention`` on paddle Tensors at
  [16, 1024, 12, 64] bf16, bit-equal to the torch-fed call; and every
  entry of the op table on the card against the port's CPU result at its
  tolerance, with the random ops held by moments and seeded reruns;
- checkpoints and the data pipeline: GPT-124M as the scheduled path
  builds it, 8 uninterrupted steps (twice: the reruns must agree) against
  4 steps, ``paddle.save``, a model built from another seed,
  ``paddle.load`` and 4 more (losses, rates, parameters and AdamW
  moments bit-equal), the same through ``distributed.checkpoint`` with
  an asynchronous save taken while the next step runs,
  ``latest_checkpoint``, and a flipped shard byte that must fail the
  load and send ``latest_checkpoint`` to the earlier checkpoint; then
  ResNet-50 through ``Model.fit`` with ``ModelCheckpoint`` and two
  DataLoader worker processes, resumed from ``final`` in another seed's
  model, bit-equal to two uninterrupted epochs, each worker noting that
  it never initialized CUDA (save and load seconds and GB/s, the async
  save's blocked seconds, epoch-2 images/s with 0 and 2 workers);
- the data-parallel plane: this script again, as ranks under the port's
  launcher (``--nccl-world-one`` and ``--data-parallel-rank``): one rank
  that must join NCCL at world 1 and pass every collective on the card,
  then two ranks sharing the card over gloo (NCCL refuses two ranks on
  one device) that train GPT-124M under ``paddle.DataParallel`` with the
  eager fp16 recipe, 8 x 1024 tokens a rank from a
  ``DistributedBatchSampler`` (rank 1 starts from other weights; the
  parameters must be bit-equal after the wrap and after every step, K2
  and K3 once per layer and step in each rank), run a 2-layer fp32 step
  that they hold, piece by piece, to this process's one step on the
  concatenated batch (saved before they start), check
  ``no_sync``, fit ResNet-50 with ``SyncBatchNorm`` through ``Model.fit``
  (bit-equal parameters and statistics, equal metrics) and hold the sync
  batch norm at ResNet-50's first batch norm to fp64; each rank's
  launches are added to this process's counts (global tokens/s, the
  comm plane's stats, buckets and bytes all-reduced a step, and apart,
  a step under ``no_sync`` and the buckets' all-reduce alone);
- the hybrid plane: this script again as two gloo ranks sharing the card
  (``--hybrid-parallel-rank``), first at mp 2 after ``fleet.init``:
  GPT-124M at bench.py's widths under ``tensor_parallel`` (6 heads a
  rank, the global 8 x 1024, O2, AdamW, ``CompiledTrainStep``, 1 + 2
  calls and one with the mp collectives metered), the fp32 2-layer TP and
  SP steps, and ``distributed.checkpoint`` both ways (this process's
  whole checkpoint into the TP ranks, each slice bit-equal; the ranks'
  checkpoint into this process, bit-equal, and refused with a flipped
  byte); then at sharding 2: ERNIE-3.0-base under
  ``group_sharded_parallel(..., "p_g_os")`` as ``benchmarks/matrix.py:
  125-166`` runs it (16 x 512 global) and the fp32 ``os``, ``os_g`` and
  ``p_g_os`` steps. The ranks hold the five fp32 steps, piece by piece,
  to this process's one step on the same global batch (step ms of the
  slowest rank, global
  tokens/s, comm ms, peak memory and parameter + optimizer bytes a rank
  against one process's; K2/K3 once per layer and call in each rank);
- context parallelism: this script again as two gloo ranks sharing the
  card (``--context-parallel-rank``) at sep 2 after ``fleet.init``:
  GPT-124M at bench.py's widths on the global 2 x 8192 tokens
  (``benchmarks/matrix.py:306``'s seq 8192, sep 2), each rank [2, 4096],
  O2, AdamW, ``CompiledTrainStep``, with ``context_parallel`` "ring" (the
  zigzag schedule: K2 and K3 twice a layer and call) and "ulysses" (once),
  1 + 1 calls each (global tokens/s, step ms of the slowest rank, the sep
  transport's exchanges, bytes and ms a step, peak memory a rank); the
  fp32 2-layer ring and Ulysses steps on 1 x 4096 (uneven ignored
  labels), each rerun bit-identical and held on the ranks to this
  process's one-process step (the sep transport stages point to point
  through the host on
  gloo, which refuses it on CUDA tensors);
- the pipeline: this script again as two gloo ranks sharing the card
  (``--pipeline-rank``) at pp 2 after ``fleet.init``: a send to a stage
  that has not posted its receive (64 B and a 3 MB boundary tensor) must
  return at once; the fp32 steps at GPT-124M's widths and 4 layers (4 x
  1024 in 4 microbatches): each eager schedule (``1f1b``,
  ``zero_bubble``, ``gpipe``) through ``fleet.distributed_model``'s
  ``PipelineParallel`` bit-identical to ``_local_train`` in the same
  process, and ``GPTForPretrainingPipe`` at n_chunks 1 and 2 rerun
  bit-identical and held on the ranks to this process's unpipelined
  step (loss,
  gradients, parameters); then GPT-124M at bench.py's widths on the global
  16 x 1024 in 8 microbatches of [2, 1024], O2 bf16, AdamW lr 1e-4: the
  eager pipeline (a ``PipelineLayer`` of the embeddings, 12 blocks, ``ln_f``
  and an untied head, 6 blocks a stage) in each schedule, and
  ``GPTForPretrainingPipe`` through ``CompiledTrainStep`` at n_chunks 1
  (GPipe, 9 ticks) and 2 (interleaved, 17 ticks), remat off and on, 1 + 1
  steps each (step ms of the slowest rank, global tokens/s, the schedule,
  boundary messages and bytes or the pipeline's exchanges a step, peak
  memory a rank; K2 and K3 once per block and microbatch in each stage);
- the gradient's way between ranks (``grad_comm``): GPT-124M at bench.py's
  widths, O2 bf16, through ``GradientMergeOptimizer`` in this process
  (AdamW with a global-norm clip, k 4, microbatches of [4, 1024]; tokens/s,
  one inner step and K2/K3 48 times an applied step) and its fp32 2-layer
  step against one step on [16, 1024]; then this script again as two gloo
  ranks sharing the card (``--grad-comm-rank``), each on 8 x 1024:
  ``LocalSGDOptimizer`` (k 4; the parameters bit-equal after each sync,
  the fp32 master weights' largest difference between the ranks),
  ``DGCOptimizer`` (sparsity 0.999; the sends and their average counted,
  the top-k's ms), their fp32 steps (LocalSGD at k 1, DGC dense) against
  one process, the quantized data-parallel step after ``fleet.init`` with
  ``comm_quant`` (wire bytes against fp32's, comm ms, the fp32 gradients
  within two wire crossings of the exact mean), ERNIE-3.0-base's ZeRO-3
  gather at sharding 2 exact and quantized (ms and bytes; bit-equal to the
  whole state and to the codec of it), ``dcn_grad_sync`` of GPT-124M's
  gradients at dcn 2 in fp32 and int8, at once and asynchronously, and TP
  GPT-124M at mp 2 with ``ClipGradByNorm`` (step ms) with its fp32 step
  held to one process;
- the semi-auto API and the fleet executor (``auto_parallel``): this
  script again as two gloo ranks sharing the card
  (``--auto-parallel-rank``) on ``ProcessMesh([0, 1], ["mp"])``: GPT-124M
  at bench.py's widths in fp32 (the reference's ``Engine`` runs at O0),
  each block placed as ``tests/test_auto_parallel.py:142-148`` places its
  block and ``wte`` ``Shard(0)``, AdamW with ``ClipGradByGlobalNorm``, the
  global 8 x 1024 through ``shard_dataloader`` and ``Engine.fit`` (split
  over mp: [4, 1024] a rank), 1 + 2 steps (step ms, global tokens/s, the
  collectives and bytes a step, parameter bytes a rank against the
  model's, peak memory; K2 and K3 12 a step on fp32); the fp32 2-layer
  gate (3 steps; the ranks' histories bit-equal; held on the ranks to
  this process's ``Engine`` with no mesh: losses, the first step's
  gradients and
  parameters within 1e-5), ``Engine.save`` (the file bit-equal to the
  gathered state) and ``load`` (the next step bit-identical), and
  ``reshard`` of a [768, 2304] fp32 weight Shard(1) -> Replicate ->
  Shard(0) -> Shard(1) (ms and bytes a move, bit-equal); then, in this
  process, GPT-124M's bf16 forward cut by ``FleetExecutor.from_stages``
  into four stages over 8 microbatches of [2, 1024] (each output
  bit-identical to the straight forward, K2 12 a microbatch; ms both
  ways), and a stage raising on microbatch 3 reaching the caller as a
  ``RuntimeError`` naming it;
- tensor parallelism and ZeRO inside the SPMD pipeline (``pipeline_3d``):
  this script again as eight gloo ranks sharing the card
  (``--pipeline3d-rank``) at pp 2 x sharding 2 x mp 2 after
  ``fleet.init`` (rank = 4 pp + 2 sharding + mp): ``GPTForPretrainingPipe``
  with ``tensor_parallel`` at GPT-124M's widths and 4 layers in fp32
  under ``group_sharded_parallel`` (``p_g_os`` at n_chunks 1 and at 2 with
  remat, ``os`` and ``os_g`` at 1), each step held piece by piece to this
  process's unpipelined step on the same 4 x 1024 (a data rank's 2 rows in
  2 microbatches), the pp and mp ranks of a data rank on bit-equal losses
  and an mp pair's replicated leaves bit-equal; the ``p_g_os`` model
  saved through ``distributed.checkpoint`` from the mesh, loaded back into
  the mesh and whole into this process, bit-equal; then GPT-124M
  (``gpt_small``, 12 layers) at O2 bf16, AdamW lr 1e-4 with
  ``ClipGradByGlobalNorm(1.0)``, ``p_g_os``, through ``CompiledTrainStep``
  on the global 8 x 1024 (4 x 1024 a data rank in 2 microbatches of [2,
  1024], 6 heads a rank) at n_chunks 1 and 2 with remat, 1 + 1 steps, the
  mp collectives metered over the warm-up (step ms of the slowest rank,
  global tokens/s, mp collectives, bytes and ms, the pipeline's exchanges
  and bytes, the comm plane's works and ms a step, peak memory, parameter
  + AdamW bytes a rank against one process's; K2 and K3 12 a step in each
  rank, K2 24 with remat);
- the graph and deployment path (``jit_inference``): GPT-124M in fp32
  through ``jit.to_static`` at 2 x 1024 against the eager port (logits,
  one AdamW step's gradients, the logits after the step: 1e-5 of each
  one's largest entry; K2 and K3 once per layer in the step); in bf16
  through ``jit.save`` at ``InputSpec([8, 1024], "int64")`` and
  ``paddle.inference.create_predictor`` (one CUDA graph, held bit-equal
  to the uncaptured program), 10 requests of random ids through the
  handles against the eager forward within one bf16 ulp of the logits'
  largest magnitude, with the eager, ``to_static`` and predictor ``run()``
  ms (p50, p90), ``copy_to_cpu`` ms, capture, save and load seconds,
  tokens/s and K2 launches per request (12); the same weights built and
  saved on the CPU, loaded onto the card, against the predictor's
  outputs; ``Model.save(training=False)`` loaded back, likewise; GPT-124M
  fp32 on ``static.data("ids", [2, 1024], "int64")`` through
  ``static.Executor`` against the eager logits (1e-5, K2 per layer);
- context parallelism across the hybrid mesh (``context_hybrid``): this
  script again as eight gloo ranks sharing the card
  (``--context-hybrid-rank``) at sharding 2 x sep 2 x mp 2 after
  ``fleet.init`` (rank = 4 sharding + 2 sep + mp): GPT-124M's widths at 2
  layers in fp32 with ``tensor_parallel``, ``sequence_parallel`` and
  ``context_parallel`` under ``group_sharded_parallel`` (the ring and
  Ulysses at ``p_g_os``, the ring at ``os_g``) on 2 x 4096 (a row a data
  rank, uneven ignored labels over sep), each run twice bit-identical
  and held piece by piece to this process's one-process step, the sep
  and mp ranks of a data rank on bit-equal losses; the ring ``p_g_os``
  model saved through ``distributed.checkpoint`` from the mesh, loaded
  back into the mesh and whole into this process, bit-equal; GPT-124M
  (``gpt_small(max_seq_len=8192)``) at O2 bf16 with SP and the ring
  under ``p_g_os``, AdamW lr 1e-4, through ``CompiledTrainStep`` on the
  global 2 x 8192 (a row a data rank, 4096 tokens a sep rank, 6 heads a
  rank), 1 + 2 steps, the mp collectives metered over the warm-up (step
  ms of the slowest rank, global tokens/s, the sep exchanges, mp sums and
  the
  comm plane's works with their bytes and ms a step, peak memory,
  parameter + AdamW bytes a rank against one process's, the same global
  losses on every rank; K2 and K3 24 a step a rank); then ``fleet.init``
  again at pp 2 x sharding 2 x sep 2: ``GPTForPretrainingPipe`` at 2
  layers in fp32 under ``p_g_os``, every sep rank on the whole sequence,
  run twice bit-identical, the sep pair's gradients bit-equal and held
  to this process's unpipelined step;
- the elastic control plane (``elastic``): GPT-124M at bench.py's widths
  (O2 bf16, AdamW lr 1e-4, the global 16 x 1024 a step, a function of the
  step alone) under the port's elastic launcher, two agents (``--elastic
  --nnodes 2 --min_nnodes 1 --nproc_per_node 1``, agent 0 hosting the
  membership store) whose trainers are this script again
  (``--elastic-rank``), gloo ranks sharing the card, each on its rows, a
  ``distributed.checkpoint`` every 2 steps: node 0's trainer exits
  non-zero after step 5 (a planted fault), its agent restarts generation
  1 at world 2 from the step-4 checkpoint, whose step 5 must equal
  generation 0's bit for bit (each rank's loss and the global gradient
  norm); after step 6's checkpoint node 1's agent and trainer are killed,
  node 0's agent detects the stale heartbeat, bumps the generation and
  resumes at world 1, whose step 7 must equal, bit for bit (loss, norm,
  every parameter), one ``CompiledTrainStep`` in this process from the
  same checkpoint; node 0's restart count stays 1 and its agent exits 0
  (each generation's world, first step and restart counts, detection and
  restart seconds, checkpoint save seconds, step ms and tokens/s at world
  2 and 1, peak memory; K2 and K3 12 a step in every trainer).

Last, it times each kernel beside its bound, its plain version and,
where one exists, a PyTorch call that computes the same function (also
by their device time alone, which leaves out the host's launch gaps);
K1 also at a bytes-heavy shape (64 slots of 1024 tokens), K2 and K3
also at the ERNIE and BERT paths' non-causal shapes, the hybrid
path's ranks' shapes ([8, 1024, 6, 64] causal, [8, 512, 12, 64]
non-causal), the context-parallel path's blocks (``CP_ATTENTION``) and
the pipeline's microbatch ([2, 1024, 12, 64] causal, ``PP_ATTENTION``)
and GradientMerge's ([4, 1024, 12, 64] causal, ``GC_ATTENTION``), the
3D pipeline's microbatch on an mp rank's heads ([2, 1024, 6, 64] causal,
``P3_ATTENTION``), K2 and K3 on their fp32 route at the Engine ranks'
[4, 1024, 12, 64] causal (``AP_ATTENTION``) and K2 at the fleet
executor's microbatch, K2 at a predictor request ([8, 1024, 12, 64]
causal bf16) and K2 and K3 on their fp32 route at the jit gates' [2, 1024,
12, 64] (``JIT_ATTENTION``), K2 and K3 at a context_hybrid rank's ring
blocks and Ulysses' whole sequence (``CH_ATTENTION``), and each
kernel's fp16 route (K2 and K3 at the fp16 AMP path's shape); then K2
and K3 in bf16 called straight (K2's ctypes entry, the K3 wrapper) and
through their ``torch.library`` ops, in turns (``custom_op_cost``). Each
phase prints one JSON line; any failure raises and the script exits
non-zero. It needs a CUDA card: without one it exits 2 and prints no
result.

fp32 comparisons run with TF32 off in cuBLAS and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``).

The last line is ``{"ok": true, "device": {"platform": "gpu", "kind":
<torch.cuda.get_device_name(0)>, "count": <device count>}}``; the line
before it lists every kernel with its launches on the main paths, time,
bound, plain time and library time.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

_PROCESS_T0 = time.time()   # the elastic trainers' start, for their timeline

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12,
                  "float32": 67e12}   # dense, per type
F32_EPS = 2.0 ** -23


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters, warmup=3):
    """Mean ms per call from CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_time_ms(fn, iters=20):
    """Mean device ms per call: every kernel and memset the calls put on
    the card, from ``torch.profiler`` over ``iters`` calls after one
    warm-up. Unlike ``cuda_time_ms`` it leaves out the host's launch gaps,
    which dominate calls shorter than their own launch path."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# -- phase 1 ------------------------------------------------------------------
def phase_environment(torch, ck):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = ck.build_kernels()
    wall = time.perf_counter() - t0
    ptxas = {name: ptxas_instantiations(log)
             for name, (_, log) in built.items()}
    emit({"phase": "environment", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_wall_s": wall,
          "build_s": {n: s for n, (s, _) in built.items()},
          "ptxas": ptxas})
    spilled = [f"{name}: {fn}" for name, fns in ptxas.items()
               for fn, info in fns.items()
               if spill_checked(fn) and info["spill_stores"]]
    if spilled:
        raise AssertionError(f"kernels spill: {spilled}")
    return smi


_KERNEL_NAME = re.compile(r"([a-z_]+kernel(?:_tc)?)(?:I(\w+?)E+v|E)")
_TEMPLATE_ARG = re.compile(r"13__nv_bfloat16|6__half|f|Li(\d+)")


def kernel_name(mangled):
    """``flash_bwd_dq_kernel_tc<64>`` from a mangled entry function's name,
    the bare name for a kernel that is not a template (None for a name
    that is not one of the port's kernels)."""
    m = _KERNEL_NAME.search(mangled)
    if not m:
        return None
    if m[2] is None:
        return m[1]
    args = [a[1] or {"f": "float", "6__half": "fp16"}.get(a[0], "bf16")
            for a in _TEMPLATE_ARG.finditer(m[2])]
    return f"{m[1]}<{', '.join(args)}>"


def spill_checked(fn):
    """Kernels that fail the run when they spill: the tensor-core ones
    (``*_tc``) and K1's split-context pair (``paged_split_kernel``,
    ``paged_combine_kernel``)."""
    base = fn.split("<")[0]
    return base.endswith("_tc") or base in ("paged_split_kernel",
                                            "paged_combine_kernel")


def ptxas_instantiations(log):
    """{kernel<dtype, d>: {"registers", "spill_stores"}} from ``nvcc
    -Xptxas=-v`` output: each entry function's properties line, then its
    spill line, then its "Used" line."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = kernel_name(ln)
        elif fn and "spill stores" in ln:
            out[fn] = {"spill_stores": int(re.search(
                r"(\d+) bytes spill stores", ln)[1])}
        elif fn and "Used" in ln and fn in out:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 ln)[1])
            fn = None
    return out


# -- phase 2 ------------------------------------------------------------------
def paged_case(torch, ctxs, kq, dtype, h=12, d=64, page=16, seed=0,
               spare=0):
    """Pools with each slot's pages scattered through them, tables padded
    with the null page; each active slot's table also holds ``spare``
    pages of random rows past its context. q is the column slice of a
    packed [B, KQ, 3*h*d] qkv, as the serving engine hands it to K1. Row
    j of slot b sees ctxs[b] + j tokens."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = len(ctxs)
    need = [(c + kq - 1 + page - 1) // page + spare if c else 0
            for c in ctxs]
    maxp = max(max(need), 1)
    npages = 1 + sum(need)
    perm = (torch.randperm(npages - 1, generator=g) + 1).tolist()
    tables, nxt = [], 0
    for n in need:
        tables.append(perm[nxt:nxt + n] + [0] * (maxp - n))
        nxt += n
    dev = "cuda"
    qkv = torch.randn(b, kq, 3 * h * d, generator=g).to(dev, dtype)
    q = qkv[..., :h * d].reshape(b, kq, h, d)
    kp = torch.randn(npages, page, h * d, generator=g).to(dev, dtype)
    vp = torch.randn(npages, page, h * d, generator=g).to(dev, dtype)
    bt = torch.tensor(tables, dtype=torch.int32, device=dev)
    cl = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, cl


def flash_case(torch, b, sq, sk, h, kh, d, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, sq, h, d, generator=g).to("cuda", dtype)
    k = torch.randn(b, sk, kh, d, generator=g).to("cuda", dtype)
    v = torch.randn(b, sk, kh, d, generator=g).to("cuda", dtype)
    return q, k, v


# ragged contexts up to 1024 (the model length), one inactive slot
PAGED_CTXS = {1: [0, 1, 17, 130, 511, 700, 1000, 1024],
              5: [0, 1, 17, 130, 511, 700, 1000, 1020]}
# K1 at the edges of the bf16 route's 256-token splits: (label, contexts,
# KQ, spare pages per table): a context one below, at and one above a
# split's length; KQ = 5 rows whose last visible token crosses a split;
# tables holding pages past their slots' contexts; all-inactive batches
PAGED_EDGE_CASES = [
    ("split_edges", [255, 256, 257, 511, 512, 513], 1, 0),
    ("verify_crosses_split", [252, 253, 254, 256, 0, 508], 5, 0),
    ("table_past_context", [100, 300, 0, 17, 256], 1, 20),
    ("table_past_context_k5", [100, 300, 0, 17, 256], 5, 20),
    ("all_inactive", [0, 0, 0], 1, 0),
    ("all_inactive_k5", [0, 0], 5, 0),
]
# the bytes-heavy timing shape: every slot at the model length
PAGED_BYTES_CTXS = [1024] * 64
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED, TRAIN_K = 16, 3, 10, 8
# (label, b, sq, sk, h, kh, d, causal); the last is the training path's
# attention, GPT-124M at batch 16
TRAIN_ATTENTION = ("gpt124m_train", TRAIN_BATCH, 1024, 1024, 12, 12, 64,
                   True)
# the encoder paths: ERNIE-3.0-base pretraining at batch 16 x 512 and
# BERT-base finetuning at batch 32 x 128 (benchmarks/matrix.py:95-166),
# each with its K for run_steps; their attention, non-causal
ERNIE_BATCH, ERNIE_SEQ, ERNIE_K = 16, 512, 8
BERT_BATCH, BERT_SEQ, BERT_K = 32, 128, 16
ERNIE_ATTENTION = ("ernie_noncausal", ERNIE_BATCH, ERNIE_SEQ, ERNIE_SEQ, 12,
                   12, 64, False)
BERT_ATTENTION = ("bert_noncausal", BERT_BATCH, BERT_SEQ, BERT_SEQ, 12, 12,
                  64, False)
# the data-parallel path's attention (GPT-124M, causal): each rank's
# batch of 8 (fp16), and the fp32 exactness step's ranks (2 each) and its
# one-process step on their batches concatenated (4)
DP_RANKS, DP_BATCH, DP_EXACT_BATCH = 2, 8, 2
DP_ATTENTION = [
    ("dp_rank", DP_BATCH, 1024, 1024, 12, 12, 64, True),
    ("dp_exact_rank", DP_EXACT_BATCH, 1024, 1024, 12, 12, 64, True),
    ("dp_exact_one_process", DP_RANKS * DP_EXACT_BATCH, 1024, 1024, 12, 12,
     64, True),
]
# the hybrid-parallel path's attention: a TP GPT-124M rank's 6 heads at
# the global 8 x 1024 (bf16), a ZeRO-3 ERNIE rank's 8 x 512 (bf16) and the
# fp32 TP and SP steps' ranks at 4 x 1024 with 6 heads (the fp32 ZeRO
# ranks' 2 x 1024 and the one-process 4 x 1024 are DP_ATTENTION's)
HP_RANKS, HP_TP_BATCH, HP_ERNIE_BATCH, HP_EXACT_BATCH = 2, 8, 8, 4
HP_ATTENTION = [
    ("tp_gpt124m_rank", HP_TP_BATCH, 1024, 1024, 6, 6, 64, True),
    ("zero3_ernie_rank", HP_ERNIE_BATCH, 512, 512, 12, 12, 64, False),
    ("tp_exact_rank", HP_EXACT_BATCH, 1024, 1024, 6, 6, 64, True),
]
# the context-parallel path's attention: GPT-124M at the global 2 x 8192
# over sep 2 (benchmarks/matrix.py:306's seq 8192), each rank [2, 4096]:
# the zigzag ring's own pair (causal), the earlier owner's head-half kv
# against all of q and all of the later owner's kv against the tail half
# of q (both non-causal), and Ulysses' whole sequence on 12 / 2 heads
# (causal); its fp32 steps run 1 x 4096 (halves of 1024 a rank)
CP_RANKS, CP_BATCH, CP_SEQ, CP_EXACT_SEQ = 2, 2, 8192, 4096
CP_ATTENTION = [
    ("cp_own_chunk", CP_BATCH, 4096, 4096, 12, 12, 64, True),
    ("cp_earlier_owner", CP_BATCH, 4096, 2048, 12, 12, 64, False),
    ("cp_later_owner", CP_BATCH, 2048, 4096, 12, 12, 64, False),
    ("cp_ulysses", CP_BATCH, 8192, 8192, 6, 6, 64, True),
]
# the pipeline path: GPT-124M at bench.py's widths over pp 2, two gloo ranks
# sharing the card, the global 16 x 1024 in 8 microbatches of [2, 1024];
# the eager pipeline (6 blocks a stage, an untied head) in each schedule
# and the SPMD pipeline (GPTForPretrainingPipe) at n_chunks 1 and 2, remat
# off and on; the fp32 steps at 4 layers on 4 x 1024 in 4 microbatches
PP_RANKS, PP_BATCH, PP_MICRO = 2, 16, 8
PP_ATTENTION = [("pp_microbatch", PP_BATCH // PP_MICRO, 1024, 1024, 12, 12,
                 64, True)]
PP_WARMUP, PP_TIMED = 1, 1
PP_MODES = ("1f1b", "zero_bubble", "gpipe")
PP_SPMD = ((1, False), (1, True), (2, False), (2, True))
PP_EXACT_LAYERS, PP_EXACT_BATCH, PP_EXACT_MICRO = 4, 4, 4
PP_STATE_BYTES = 2 * 1024 * 768 * 2      # one microbatch's bf16 state
PP_DEVICE = "cuda"
# the grad_comm path: GradientMerge at k 4 over microbatches of [4, 1024]
# (this process), and two gloo ranks of 8 x 1024 each (the [8, 1024] rank
# shape is DP_ATTENTION's, the mp rank's HP_ATTENTION's)
GC_RANKS, GC_K, GC_MICRO, GC_RANK_BATCH = 2, 4, 4, 8
GC_ATTENTION = [("gm_microbatch", GC_MICRO, 1024, 1024, 12, 12, 64, True)]
# the pipeline_3d path: GPT-124M over build_mesh(pp=2, sharding=2, mp=2),
# eight gloo ranks sharing the card; the global 8 x 1024, 4 x 1024 a data
# rank in 2 microbatches of [2, 1024], 6 of the 12 heads an mp rank (bf16;
# at 16 x 1024 the eight ranks' fp32 losses over [8192, 50304] logits ran
# the card out of memory); the fp32 gate at PP_EXACT_LAYERS layers on 4 x
# 1024, a data rank's 2 rows in 2 microbatches of [1, 1024] (fp32)
P3_RANKS, P3_BATCH, P3_MICRO = 8, 8, 2
P3_EXACT_BATCH, P3_EXACT_MICRO = 4, 2
P3_ATTENTION = [
    ("p3d_microbatch", P3_BATCH // 2 // P3_MICRO, 1024, 1024, 6, 6, 64, True),
    ("p3d_exact_microbatch", P3_EXACT_BATCH // 2 // P3_EXACT_MICRO, 1024,
     1024, 6, 6, 64, True)]
P3_DEVICE = "cuda"
# the context_hybrid path: GPT-124M over build_mesh(sharding=2, sep=2,
# mp=2) with SP and CP, eight gloo ranks sharing the card; the global 2 x
# 8192, a row a data rank, 4096 of its tokens a sep rank on 6 of the 12
# heads: the zigzag ring's own pair (causal), the earlier owner's head-half
# kv against all of q and all of the later owner's kv against the tail half
# of q (non-causal), and Ulysses' whole sequence on 6 / 2 heads (causal);
# the fp32 gates at 2 layers on 2 x 4096, a row a data rank
CH_RANKS, CH_BATCH, CH_EXACT_BATCH = 8, 2, 2
CH_ATTENTION = [
    ("ch_own_pair", CH_BATCH // 2, 4096, 4096, 6, 6, 64, True),
    ("ch_earlier_owner", CH_BATCH // 2, 4096, 2048, 6, 6, 64, False),
    ("ch_later_owner", CH_BATCH // 2, 2048, 4096, 6, 6, 64, False),
    ("ch_ulysses", CH_BATCH // 2, 8192, 8192, 3, 3, 64, True),
]
CH_DEVICE = "cuda"
# the graph and deployment path (jit_inference): GPT-124M through
# jit.to_static, jit.save and paddle.inference's predictor at 8 x 1024 a
# request (bf16 weights); the fp32 gates at 2 x 1024
JIT_BATCH, JIT_EXACT_BATCH, JIT_REQUESTS = 8, 2, 10
JIT_ATTENTION = [("jit_request", JIT_BATCH, 1024, 1024, 12, 12, 64, True),
                 ("jit_exact_fp32", JIT_EXACT_BATCH, 1024, 1024, 12, 12, 64,
                  True)]
FLASH_CASES = [
    ("gpt124m_causal", 1, 1024, 1024, 12, 12, 64, True),
    ("gqa_causal", 2, 256, 256, 12, 4, 64, True),
    ("nonsquare_causal", 1, 128, 384, 12, 12, 64, True),
    ("d128_causal", 1, 512, 512, 8, 8, 128, True),
    ("noncausal", 1, 256, 512, 12, 12, 64, False),
    TRAIN_ATTENTION,
    # the tile edges of the tensor-core route: one 128-row sequence (two
    # 64-row q tiles on one diagonal kv tile); the smallest offset the
    # gate admits (128: lengths are multiples of 128, so every offset is a
    # multiple of the 32-, 64- and 128-row tiles) at d = 128, where K3's
    # dk/dv pass steps 32 q rows over 64-row kv tiles; d = 256, 32-row kv
    # steps
    ("single_tile_causal", 1, 128, 128, 12, 12, 64, True),
    ("offset128_d128_causal", 1, 256, 384, 8, 8, 128, True),
    ("d256_causal", 1, 512, 512, 8, 8, 256, True),
    ERNIE_ATTENTION,
    BERT_ATTENTION,
] + DP_ATTENTION + HP_ATTENTION + CP_ATTENTION + PP_ATTENTION + \
    GC_ATTENTION + P3_ATTENTION + JIT_ATTENTION + CH_ATTENTION
# K3: the forward's cases and one with an lse cotangent
FLASH_BWD_CASES = FLASH_CASES + [
    ("dlse_causal", 1, 256, 256, 12, 12, 64, True)]


def ulp16(torch, x, dtype):
    """The spacing of ``dtype`` values at magnitude x: 8 significant bits
    for bf16, 11 for fp16."""
    return 2.0 ** (math.floor(math.log2(x)) -
                   (10 if dtype == torch.float16 else 7))


def sdpa_same_function(q, k, dlse=None):
    """True where ``scaled_dot_product_attention`` computes K2's (or, with
    no lse cotangent, K3's) function: kv heads equal to q heads and
    sq == sk, since its ``is_causal`` aligns the mask top-left and K2's
    bottom-right."""
    return k.shape[2] == q.shape[2] and k.shape[1] == q.shape[1] and \
        dlse is None


def sdpa_forward(torch, q, k, v, causal):
    """PyTorch's fused attention on [b, s, h, d] tensors."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal).transpose(1, 2)


def sdpa_backward(torch, q, k, v, do, causal):
    """(dq, dk, dv) of PyTorch's fused attention for the cotangent do."""
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal)
    grads = torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))
    return tuple(g.transpose(1, 2) for g in grads)


def hold_bf16_to_library(rows):
    """Each 16-bit (bf16 or fp16) K2/K3 (or K4/K5) row's bound is its
    rounding bound, and no looser than twice the largest error of the
    library call against the same plain version at that kernel, d and
    dtype; then each row passes or fails."""
    lib = {}
    for r in rows:
        if r.get("library_max_abs_err") is not None:
            key = (r["kernel"], r["d"], r["dtype"])
            lib[key] = max(lib.get(key, 0.0), r["library_max_abs_err"])
    for r in rows:
        key = (r["kernel"], r["d"], r["dtype"])
        if key not in lib:
            raise AssertionError(f"no library error at {key} to hold the "
                                 "bf16 bound to")
        r["library_bound"] = 2 * lib[key]
        r["tol"] = min(r["rounding_tol"], r["library_bound"])
        r["pass"] = r["max_abs_err"] <= r["tol"] and r["pass"]


def paged_kernel_case(torch, ck, label, ctxs, kq, dtype, spare=0):
    """K1 against its plain version in fp32 on the same (exactly widened)
    inputs, element by element: |got - ref| <= atol + rtol * |ref|. atol
    is fp32's error over K terms (K the longest context), times the
    largest |v| for bf16 and fp16; rtol is 0 for fp32, 2^-8 for bf16 and
    2^-11 (fp16's eps) for fp16, the half ulp of rounding the output
    once. The rows of every inactive slot are
    exactly +0, and a rerun gives the same bits."""
    q, kp, vp, bt, cl = paged_case(torch, ctxs, kq, dtype, spare=spare)
    got = ck.paged_attention_verify_decode(q, kp, vp, bt, cl)
    again = ck.paged_attention_verify_decode(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    ref = ck.paged_attention_verify_reference(q.float(), kp.float(),
                                              vp.float(), bt, cl)
    atol = (max(ctxs) + kq) * F32_EPS
    rtol = 0.0
    if dtype != torch.float32:
        atol *= float(vp.float().abs().max())
        rtol = 2.0 ** -11 if dtype == torch.float16 else 2.0 ** -8
    diff = (got.float() - ref).abs()
    over = float((diff / (atol + rtol * ref.abs())).max())
    inactive = [i for i, c in enumerate(ctxs) if c == 0]
    zero_rows_exact = all(bool((got[i] == 0).all()) and
                          not bool(torch.signbit(got[i].float()).any())
                          for i in inactive)
    same = torch.equal(got, again)
    return {"kernel": "paged_attention", "case": label, "kq": kq,
            "ctxs": ctxs, "spare_pages": spare, "dtype": str(dtype)[6:],
            "splits": ck.paged_splits(bt.shape[1], kp.shape[1])[1],
            "max_abs_err": float(diff.max()), "atol": atol, "rtol": rtol,
            "err_over_limit": over,
            "inactive_rows_exact_zero": zero_rows_exact,
            "deterministic": same,
            "pass": over <= 1.0 and zero_rows_exact and same}


def phase_kernels_vs_plain(torch, ck):
    results = []
    cases = [(f"serving_kq{kq}", ctxs, kq, 0)
             for kq, ctxs in PAGED_CTXS.items()] + PAGED_EDGE_CASES
    dtypes = (torch.bfloat16, torch.float16, torch.float32)
    for dtype in dtypes:
        for label, ctxs, kq, spare in cases:
            results.append(paged_kernel_case(torch, ck, label, ctxs, kq,
                                             dtype, spare))
    for dtype in dtypes:
        rows = [flash_fwd_case(torch, ck, *case, dtype)
                for case in _distinct_shapes(FLASH_CASES)]
        rows += [flash_bwd_case(torch, ck, *case, dtype)
                 for case in _distinct_shapes(FLASH_BWD_CASES)]
        if dtype != torch.float32:
            hold_bf16_to_library(rows)
        results.extend(rows)
    for dtype in dtypes:
        rows = [row for case in VARLEN_CASES
                for row in varlen_kernel_cases(torch, ck, case, dtype)]
        if dtype != torch.float32:
            hold_bf16_to_library(rows)
        results.extend(rows)
    emit({"phase": "kernels_vs_plain", "cases": results})
    bad = [r for r in results if not r["pass"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    return results


def _distinct_shapes(cases):
    """``cases`` with each shape held once, under its labels joined by
    "/" (several paths' attention shares a shape)."""
    labels = {}
    for label, *shape in cases:
        labels.setdefault(tuple(shape), []).append(label)
    return [("/".join(names),) + shape for shape, names in labels.items()]


def flash_bwd_inputs(torch, ck, b, sq, sk, h, kh, d, causal, dtype, dlse,
                     seed=0):
    """q, k, v, o, lse, do and (for dlse) an lse cotangent on the card."""
    q, k, v = flash_case(torch, b, sq, sk, h, kh, d, dtype, seed)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    do = torch.randn(b, sq, h, d, generator=g).to("cuda", dtype)
    dl = torch.randn(b, h, sq, generator=g).to("cuda") if dlse else None
    o, lse = ck.flash_attention_with_lse(q, k, v, causal=causal)
    return q, k, v, o, lse, do, dl


def flash_fwd_case(torch, ck, label, b, sq, sk, h, kh, d, causal, dtype):
    """K2 against its plain version, twice for bit-identity. fp32: the
    JAX package's flash-forward tolerance, 2e-5. bf16 and fp16: one ulp
    at the largest |o|: the kernel rounds p to the 16-bit type before P V
    (each weight off by at most half an ulp of itself, errors that average
    out along the row) and rounds o once (half an ulp), where the library
    rounds too; ``hold_bf16_to_library`` then holds it to twice the
    library's error.
    lse (fp32 from exact 16-bit products and the fp32 p) at 1e-4."""
    q, k, v = flash_case(torch, b, sq, sk, h, kh, d, dtype)
    o, lse = ck.flash_attention_with_lse(q, k, v, causal=causal)
    o2, lse2 = ck.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ro, rlse = ck.flash_attention_reference(q, k, v, causal=causal)
    err_o, err_lse = max_err(o, ro), max_err(lse, rlse)
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    row = {"kernel": "flash_fwd", "case": label, "d": d,
           "dtype": str(dtype)[6:], "max_abs_err": err_o,
           "lse_max_abs_err": err_lse, "lse_tol": 1e-4,
           "deterministic": same}
    if dtype == torch.float32:
        row["tol"] = 2e-5
        row["pass"] = err_o <= 2e-5 and err_lse <= 1e-4 and same
        return row
    row["rounding_tol"] = ulp16(torch, float(ro.float().abs().max()), dtype)
    row["library_max_abs_err"] = max_err(
        sdpa_forward(torch, q, k, v, causal), ro) \
        if sdpa_same_function(q, k) else None
    row["pass"] = err_lse <= 1e-4 and same
    return row


def flash_bwd_case(torch, ck, label, b, sq, sk, h, kh, d, causal, dtype):
    """K3 against its plain version, twice for bit-identity. fp32: the
    JAX package's flash-backward bounds (atol 5e-5, 2e-4 where kv heads
    are shared). bf16 and fp16: one ulp at the outputs' largest magnitude:
    the kernel rounds p before P^T do and ds before dS^T q and dS K (each
    off by at most half an ulp of itself, errors that average out over
    the summed rows) and rounds dq, dk, dv once (half an ulp), where the
    library rounds too; ``hold_bf16_to_library`` then holds it to twice
    the library's error."""
    args = flash_bwd_inputs(torch, ck, b, sq, sk, h, kh, d, causal, dtype,
                            dlse=label.startswith("dlse"))
    got = ck.flash_attention_bwd(*args, causal=causal)
    again = ck.flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    ref = ck.flash_attention_bwd_reference(*args, causal=causal)
    errs = [max_err(a, r) for a, r in zip(got, ref)]
    same = all(torch.equal(a, r) for a, r in zip(got, again))
    row = {"kernel": "flash_bwd", "case": label, "d": d,
           "dtype": str(dtype)[6:], "max_abs_err": max(errs),
           "dq_dk_dv_err": errs, "deterministic": same}
    if dtype == torch.float32:
        row["tol"] = 2e-4 if kh != h else 5e-5
        row["pass"] = max(errs) <= row["tol"] and same
        return row
    q, k, v, _, _, do, dl = args
    row["rounding_tol"] = ulp16(torch, max(float(r.float().abs().max())
                                           for r in ref), dtype)
    row["library_max_abs_err"] = max(
        max_err(a, r) for a, r in
        zip(sdpa_backward(torch, q, k, v, do, causal), ref)) \
        if sdpa_same_function(q, k, dl) else None
    row["pass"] = same
    return row


# K4/K5: (label, q lengths, k lengths or None for cu_k is cu_q, d, causal),
# 12 heads; the cross-attention case has a ragged q stream (T = 4228)
# against 4 x 1024 keys; d = 256 steps 32 rows in the tensor-core K4 and
# in K5's passes; the empty k segment leaves 90 q rows that see no key
# (T = 163, so lse's rows are not 16-byte aligned)
VARLEN_CASES = [
    ("ragged_causal", [700, 1800, 300, 1296], None, 64, True),
    ("ragged_noncausal", [700, 1800, 300, 1296], None, 64, False),
    ("ragged_tail_causal", [1, 977, 2400, 850], None, 64, True),
    ("uniform_causal", [512] * 6, None, 64, True),
    ("d128_causal", [700, 1800, 300, 1296], None, 128, True),
    ("d256_causal", [700, 1800, 300, 1296], None, 256, True),
    ("cross_noncausal", [1, 977, 2400, 850], [1024] * 4, 64, False),
    ("empty_k_segment", [40, 90, 33], [50, 0, 77], 64, False),
]
PACKED_TOKENS, PACKED_HEADS, PACKED_DIM = 16384, 12, 64
PACKED_WARMUP, PACKED_TIMED = 3, 10


def packed_lengths(total=PACKED_TOKENS, seed=0):
    """Document lengths drawn from ``numpy.random.default_rng(seed)
    .integers(32, 2049)`` until they reach ``total``; the last is cut to
    fit. Ragged, not multiples of 64 or 128, so segments straddle tiles."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.integers(32, 2049)))
    lens[-1] -= sum(lens) - total
    return lens


def visible_pairs(lq, lk, causal):
    """(q, kv) pairs one head sees: L (L + 1) / 2 per segment when causal
    (cu_q == cu_k), Lq * Lk per segment otherwise."""
    if causal:
        return sum(n * (n + 1) // 2 for n in lq)
    return sum(a * b for a, b in zip(lq, lk))


def varlen_case(torch, lq, lk, h, d, dtype, seed=0):
    """q, k, v, do and int32 cu_seqlens on the card; cu_k is cu_q itself
    when ``lk`` is None."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    tk = sum(lq if lk is None else lk)
    q = torch.randn(sum(lq), h, d, generator=g).to("cuda", dtype)
    k = torch.randn(tk, h, d, generator=g).to("cuda", dtype)
    v = torch.randn(tk, h, d, generator=g).to("cuda", dtype)
    do = torch.randn(sum(lq), h, d, generator=g).to("cuda", dtype)

    def cu(lens):
        return torch.tensor([0, *itertools.accumulate(lens)],
                            dtype=torch.int32, device="cuda")

    cu_q = cu(lq)
    return q, k, v, do, cu_q, cu_q if lk is None else cu(lk)


def varlen_library_fwd(torch, q, k, v, cu_q, cu_k, max_q, max_k, causal):
    """PyTorch's varlen flash forward (``torch.ops.aten.
    _flash_attention_forward`` with cum_seq_q / cum_seq_k): (o, lse,
    philox seed, philox offset, debug mask)."""
    return torch.ops.aten._flash_attention_forward(
        q, k, v, cu_q, cu_k, max_q, max_k, 0.0, causal, False,
        scale=1.0 / math.sqrt(q.shape[-1]))


def varlen_library_bwd(torch, do, q, k, v, fwd, cu_q, cu_k, max_q, max_k,
                       causal):
    """(dq, dk, dv) of PyTorch's varlen flash op from its forward's
    outputs ``fwd``."""
    return torch.ops.aten._flash_attention_backward(
        do, q, k, v, fwd[0], fwd[1], cu_q, cu_k, max_q, max_k, 0.0, causal,
        fwd[2], fwd[3], scale=1.0 / math.sqrt(q.shape[-1]))[:3]


def varlen_library(torch, q, k, v, do, cu_q, cu_k, lq, lk, causal):
    """(o, (dq, dk, dv)) of PyTorch's varlen flash op for the cotangent
    do, or None where it does not compute K4's function: a q segment
    whose k segment is empty."""
    lk = lq if lk is None else lk
    if any(a and not b for a, b in zip(lq, lk)):
        return None
    fwd = varlen_library_fwd(torch, q, k, v, cu_q, cu_k, max(lq), max(lk),
                             causal)
    return fwd[0], varlen_library_bwd(torch, do, q, k, v, fwd, cu_q, cu_k,
                                      max(lq), max(lk), causal)


def varlen_kernel_cases(torch, ck, case, dtype):
    """K4 and K5 against their plain versions, each run twice for
    bit-identity; K5's inputs are K4's o and lse, as K3's are K2's. bf16
    rows also carry the varlen library call's error against the same
    plain versions, which ``hold_bf16_to_library`` holds them to."""
    label, lq, lk, d, causal = case
    q, k, v, do, cu_q, cu_k = varlen_case(torch, lq, lk, 12, d, dtype)
    o, lse = ck.flash_attention_varlen_fwd(q, k, v, cu_q, cu_k, causal)
    o2, lse2 = ck.flash_attention_varlen_fwd(q, k, v, cu_q, cu_k, causal)
    args = (q, k, v, o, lse, do, cu_q, cu_k, causal)
    got = ck.flash_attention_varlen_bwd(*args)
    again = ck.flash_attention_varlen_bwd(*args)
    torch.cuda.synchronize()
    ro, rlse = ck.flash_attention_varlen_reference(q, k, v, cu_q, cu_k,
                                                   causal)
    ref = ck.flash_attention_varlen_bwd_reference(*args)
    # K4 as K2: fp32 2e-5, bf16 and fp16 two ulps of an output below 2,
    # lse 1e-4; K5 as K3: fp32 5e-5, 16-bit one ulp at the outputs'
    # largest magnitude
    tol = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6,
           torch.float16: 2.0 ** -9}[dtype]
    err_o, err_lse = max_err(o, ro), max_err(lse, rlse)
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    errs = [max_err(a, r) for a, r in zip(got, ref)]
    top = max(float(r.float().abs().max()) for r in ref)
    btol = 5e-5 if dtype == torch.float32 else ulp16(torch, top, dtype)
    bsame = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(a).all()) for a in (o, *got))
    dt = str(dtype)[6:]
    fwd = {"kernel": "flash_varlen_fwd", "case": label, "d": d, "dtype": dt,
           "max_abs_err": err_o, "lse_max_abs_err": err_lse, "tol": tol,
           "lse_tol": 1e-4, "deterministic": same,
           "pass": err_o <= tol and err_lse <= 1e-4 and same and finite}
    bwd = {"kernel": "flash_varlen_bwd", "case": label, "d": d, "dtype": dt,
           "max_abs_err": max(errs), "dq_dk_dv_err": errs, "tol": btol,
           "deterministic": bsame,
           "pass": max(errs) <= btol and bsame and finite}
    if dtype != torch.float32:
        lib = varlen_library(torch, q, k, v, do, cu_q, cu_k, lq, lk, causal)
        fwd["rounding_tol"], bwd["rounding_tol"] = tol, btol
        fwd["library_max_abs_err"] = max_err(lib[0], ro) if lib else None
        bwd["library_max_abs_err"] = max(
            max_err(a, r) for a, r in zip(lib[1], ref)) if lib else None
    return [fwd, bwd]


# -- phase 3 ------------------------------------------------------------------
def serving_requests(torch, vocab, seed=0):
    """8 prompts of 64..700 tokens; 4 share a 256-token prefix."""
    from paddle_tpu_torch.inference.serving import Request
    g = torch.Generator().manual_seed(seed)
    rand = lambda n: torch.randint(1, vocab, (n,), generator=g).tolist()
    prefix = rand(256)
    lens = [64, 300, 150, 420, 500, 600, 650, 700]
    prompts = [prefix + rand(n - 256) if i % 2 else rand(n)
               for i, n in enumerate(lens)]
    return [Request(p, max_new_tokens=32) for p in prompts]


def run_engine(torch, model, requests, ck=None, eager=False, prof=None,
               **cfg):
    """Serve ``requests`` through one engine; the stats count from after
    the engine's construction (its graph capture and check), K1's
    launches in that span among them when ``ck`` is given. ``eager``
    sets the engine's decode and verify back to the eager step functions
    (the reference the graphs are held to); ``prof`` is a profiler the
    serving alone runs under."""
    import contextlib
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.inference.serving import engine as engine_mod
    from paddle_tpu_torch.observability.metrics import percentile
    eng = ServingEngine(model, ServingConfig(page_size=16, max_batch=8,
                                             **cfg), device="cuda")
    if eager:
        eng._decode = engine_mod.decode_step
        eng._verify = engine_mod.verify_step
    torch.cuda.synchronize()
    before = ck.PAGED_ATTENTION.launches if ck is not None else 0
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        for r in requests:
            # TTFT counts from the run's start, not from when the request
            # was built (before the engine and its capture)
            r.arrival_t = t0
            eng.submit(r)
        eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    new_tokens = sum(len(r.output_tokens) for r in requests)
    stats = {
        "requests": len(requests), "new_tokens": new_tokens,
        "wall_s": wall, "tokens_per_s": new_tokens / wall,
        "ttft_p50_ms": percentile([r.ttft_s * 1e3 for r in requests], 0.5),
        "tpot_p50_ms": percentile([r.tpot_s * 1e3 for r in requests
                                   if r.tpot_s is not None], 0.5),
        "dispatches": eng.decode_steps,
        "prefix_hit_requests": sum(r.prefix_hit_tokens > 0
                                   for r in requests),
    }
    if ck is not None:
        stats["paged_attention_launches"] = \
            ck.PAGED_ATTENTION.launches - before
    if eng.compile_cache is not None:
        c = eng.compile_cache
        stats["compile_cache"] = {"hits": c.hits, "misses": c.misses,
                                  "refusals": c.refusals,
                                  "graphs": c.graphs}
    return eng, stats


def phase_serving(torch, ck, smi):
    """GPT-124M bf16 serving, spec off and spec k = 4, each three ways:
    the eager steps (the reference), the engine's CUDA graphs (each
    checked at init), and the graphs with a compile cache directory (the
    spec-k4 engine finds the decode manifest the spec-off one stored).
    The same tokens every way, TPOT and tokens/s side by side, and K1
    once per layer and dispatch, replays counted. One more spec-off graph
    run under the profiler takes K1's launches and device time per
    decode step from the trace, and its launch count must equal the
    wrapper count."""
    import tempfile
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", dtype=torch.bfloat16,
                              seed=0).eval()
    # warm-up outside the measured run: cuBLAS handles, allocator
    run_engine(torch, model, [Request(list(range(1, 40)),
                                      max_new_tokens=4)])
    out = {"phase": "serving_bf16", "nvidia_smi": smi,
           "model": "gpt_small (GPT-124M), bf16, random weights seed 0"}
    launches = dispatches = 0
    tokens = {}
    ways = ("eager", "graphs", "cache_dir")
    with tempfile.TemporaryDirectory(prefix="compile_cache.") as cache_dir:
        for way in ways:
            for spec_k in (0, 4):
                spec = "spec_k4" if spec_k else "spec_off"
                label = f"{spec}_{way}"
                reqs = serving_requests(torch, cfg.vocab_size)
                torch.cuda.reset_peak_memory_stats()
                eng, stats = run_engine(
                    torch, model, reqs, ck=ck, spec_k=spec_k,
                    eager=way == "eager",
                    compile_cache_dir=cache_dir if way == "cache_dir"
                    else None)
                stats["peak_memory_bytes"] = \
                    torch.cuda.max_memory_allocated()
                if spec_k:
                    stats["verify_steps"] = eng.spec_verify_steps
                    stats["accepted_drafts"] = eng.spec_accepted_total
                out[label] = stats
                dispatches += eng.decode_steps
                launches += stats["paged_attention_launches"]
                tokens[spec, way] = [r.output_tokens for r in reqs]
                if any(len(r.output_tokens) != 32 for r in reqs):
                    raise AssertionError(f"{label}: a request did not get "
                                         "its 32 tokens")
                if stats["prefix_hit_requests"] < 1:
                    raise AssertionError(f"{label}: no prefix-cache hit")
    for metric in ("tpot_p50_ms", "tokens_per_s"):
        out[f"{metric}_eager_graphs_cache_dir"] = {
            k: [out[f"{k}_{way}"][metric] for way in ways]
            for k in ("spec_off", "spec_k4")}
    # K1 in the trace of one more spec-off graph run (its TPOT is not
    # reported: the profiler slows the host): CUPTI records the kernel
    # nodes a graph replay launches, and each K1 launch runs each of its
    # kernels once (bf16: the split-context pass, then the combine)
    reqs = serving_requests(torch, cfg.vocab_size)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    eng, stats = run_engine(torch, model, reqs, ck=ck, prof=prof)
    dispatches += eng.decode_steps
    launches += stats["paged_attention_launches"]
    k1 = {e.key: (e.count, e.self_device_time_total)
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "paged_" in e.key}
    out["paged_attention_device_ms_per_decode_step"] = \
        sum(us for _, us in k1.values()) / 1e3 / eng.decode_steps
    out["paged_attention_traced"] = {k: {"launches": n, "device_us": us}
                                     for k, (n, us) in k1.items()}
    out["profiled_decode_steps"] = eng.decode_steps
    want = cfg.num_layers * eng.decode_steps
    out["profiled_paged_attention_launches"] = {
        "wrapper": stats["paged_attention_launches"],
        "layers_x_dispatches": want}
    out["paged_attention_launches"] = launches
    out["dispatches"] = dispatches
    same = {f"{spec}_{way}": tokens[spec, way] == tokens[spec, "eager"]
            for spec, way in tokens}
    out["same_tokens_as_eager"] = same
    out["spec_on_off_same_tokens"] = \
        tokens["spec_off", "eager"] == tokens["spec_k4", "eager"]
    emit(out)
    if launches != cfg.num_layers * dispatches:
        raise AssertionError(
            f"paged attention launched {launches} times for {dispatches} "
            f"dispatches of {cfg.num_layers} layers")
    if not k1 or stats["paged_attention_launches"] != want \
            or any(n != want for n, _ in k1.values()):
        raise AssertionError(
            f"K1 in the trace {out['paged_attention_traced']}, counted "
            f"{stats['paged_attention_launches']} times, against "
            f"{want} = layers x dispatches")
    if not all(same.values()):
        raise AssertionError(f"tokens differ from the eager steps': "
                             f"{same}")


# -- phase 4 ------------------------------------------------------------------
def phase_exactness_fp32(torch, ck):
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", dtype=torch.float32,
                              seed=0).eval()
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (40, 128, 256, 333)]
    reqs = [Request(p, max_new_tokens=32) for p in prompts]
    run_engine(torch, model, reqs)
    mismatched = []
    flash_before = ck.FLASH_FWD.launches
    for r, p in zip(reqs, prompts):
        ids = torch.tensor([p], device="cuda")
        ref = model.generate(ids, max_new_tokens=32)[0, len(p):].tolist()
        if ref != r.output_tokens:
            mismatched.append(len(p))
    generate_flash = ck.FLASH_FWD.launches - flash_before
    ids = torch.randint(1, cfg.vocab_size, (1, 1024), generator=g) \
        .to("cuda")
    with torch.no_grad():
        before = ck.FLASH_FWD.launches
        logits = model(ids)
        torch.cuda.synchronize()
        forward_flash = ck.FLASH_FWD.launches - before
        # the first 1023 positions recomputed on the dense path (1023 is
        # not a multiple of 128, so the gate refuses the kernel)
        dense = model(ids[:, :1023])
    finite = bool(torch.isfinite(logits).all())
    err = max_err(logits[:, :1023], dense)
    out = {"phase": "exactness_fp32", "tf32": False,
           "engine_vs_generate_equal": not mismatched,
           "mismatched_prompt_lens": mismatched,
           "generate_flash_launches": generate_flash,
           "forward_flash_launches": forward_flash,
           "forward_shape": list(logits.shape), "forward_finite": finite,
           "forward_vs_dense_max_abs_err": err,
           "forward_vs_dense_tol": 1e-3}
    emit(out)
    if mismatched:
        raise AssertionError(f"fp32 engine tokens differ from generate for "
                             f"prompts of {mismatched} tokens")
    if forward_flash != cfg.num_layers:
        raise AssertionError(f"forward launched flash_fwd {forward_flash} "
                             f"times, not {cfg.num_layers}")
    if not finite or list(logits.shape) != [1, 1024, cfg.vocab_size]:
        raise AssertionError("forward logits not finite or mis-shaped")
    if err > 1e-3:
        raise AssertionError(f"forward disagrees with the dense path by "
                             f"{err}")


# -- phase 4b: the serving fleet ---------------------------------------------
def _first_line(proc, timeout):
    """The next stdout line of ``proc`` within ``timeout`` seconds, or
    None (the read runs on a daemon thread; a hung child cannot hang the
    caller)."""
    import queue
    import threading
    q = queue.Queue()
    threading.Thread(target=lambda: q.put(proc.stdout.readline()),
                     daemon=True).start()
    try:
        return q.get(timeout=timeout)
    except queue.Empty:
        return None


def _published_counters(client, rank, names):
    """{counter: value} from the registry snapshot ``rank`` last published
    through the membership store (``observability.metrics.publish``)."""
    from paddle_tpu_torch.observability import metrics
    try:
        raw = client.get(f"{metrics._PUBLISH_PREFIX}/r{rank}").decode()
        snap = json.loads(raw)["metrics"]
    except (KeyError, ValueError):
        return {n: None for n in names}
    return {n: sum(s["value"] for s in snap.get(n, {}).get("series", []))
            for n in names}


def _token_gap(torch, model, prompt, got, want):
    """Where two greedy continuations of ``prompt`` part: the first
    differing position and the reference model's top-2 logit gap there."""
    pos = next(i for i, (a, b) in enumerate(zip(got + [None], want + [None]))
               if a != b)
    ids = torch.tensor([prompt + want[:pos]], device="cuda")
    with torch.no_grad():
        top = model(ids)[0, -1].float().topk(2).values
    return {"position": pos, "got": got[pos:pos + 4],
            "want": want[pos:pos + 4],
            "top2_logit_gap": float(top[0] - top[1])}


def phase_serving_fleet(torch, ck, smi):
    """GPT-124M fp32 served by a fleet on the one card: the port's
    ``TCPStore`` server in this process, a ``ServingRouter``, replica A on
    a thread here with the compile cache on, and replica B, which
    ``Autoscaler.scale_out`` spawns as a real process through the replica
    CLI (``--device cuda``, the same cache through
    ``PADDLE_SERVE_COMPILE_CACHE``). 16 requests go through the router;
    after half of them complete, ``Autoscaler.scale_in`` drains the least
    loaded replica (A when the loads allow it). Every request must come
    back ok with the tokens of one in-process engine on the same weights
    with the cache off, and K1 must have launched once per layer and
    dispatch of A, its graph replays counted."""
    import os
    import shutil
    import signal
    import tempfile
    import threading
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.inference.serving import (
        Autoscaler, AutoscalerConfig, EngineHarness, ServingConfig,
        ServingEngine, ServingReplica, ServingRouter, fleet, save_bundle)
    from paddle_tpu_torch.observability.metrics import percentile
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", dtype=torch.float32,
                              seed=0).eval()
    reqs = serving_requests(torch, cfg.vocab_size, seed=0) \
        + serving_requests(torch, cfg.vocab_size, seed=1)
    prompts = [r.prompt_tokens for r in reqs]
    out = {"phase": "serving_fleet", "nvidia_smi": smi,
           "model": "gpt_small (GPT-124M), fp32, random weights seed 0",
           "tf32": False}
    # the reference: one in-process engine on the same weights, cache off,
    # at the replicas' configuration (ServingConfig's defaults)
    ref = ServingEngine(model, ServingConfig(), device="cuda")
    for r in reqs:
        ref.submit(r)
    ref.run_until_done()
    want = [r.output_tokens for r in reqs]
    del ref
    tmp = tempfile.mkdtemp(prefix="serving_fleet.")
    procs, stop_a = [], threading.Event()
    server = client = conn_a = thread_a = None
    try:
        t0 = time.perf_counter()
        bundle = os.path.join(tmp, "bundle")
        digest = save_bundle(model, bundle)
        out["bundle_save_s"] = time.perf_counter() - t0
        cache_dir = os.path.join(tmp, "compile_cache")
        server = TCPStore(port=0, is_master=True)
        client = TCPStore(port=server.port)
        fleet.publish_bundle(client, fleet.current_generation(client),
                             bundle, digest)
        router = ServingRouter(client, hb_timeout=2.0, poll=0.01)
        # replica A: in this process, its graphs captured before it
        # attaches (the capture checks each against the eager step)
        t0 = time.perf_counter()
        eng_a = ServingEngine(model, ServingConfig(
            compile_cache_dir=cache_dir), device="cuda")
        out["replica_a_engine_init_s"] = time.perf_counter() - t0
        conn_a = TCPStore(port=server.port)
        rep_a = ServingReplica(conn_a, EngineHarness(eng_a), poll=0.002,
                               hb_interval=0.2, stop=stop_a)
        rep_a.attach(bundle_sha=digest)
        rc = {}
        thread_a = threading.Thread(
            target=lambda: rc.__setitem__("a", rep_a.run()), daemon=True)
        thread_a.start()
        b_log = os.path.join(tmp, "replica_b.log")
        spawned = {}

        def spawn():
            env = dict(os.environ, PYTHONPATH=root,
                       PADDLE_SERVE_COMPILE_CACHE=cache_dir)
            t_spawn = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "paddle_tpu_torch.inference.serving.replica",
                 "--store", f"127.0.0.1:{server.port}", "--device", "cuda",
                 "--poll", "0.002", "--hb-interval", "0.2",
                 "--name", "replica_b"],
                cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=open(b_log, "w"), text=True)
            procs.append(proc)
            line = _first_line(proc, 300)
            if not line or not line.startswith("REPLICA_ID="):
                raise AssertionError(
                    f"replica B did not attach ({line!r}): "
                    f"{open(b_log).read()[-3000:]}")
            spawned["id"] = int(line.strip().split("=", 1)[1])
            spawned["attach_s"] = time.perf_counter() - t_spawn

        scaler = Autoscaler(router, spawn=spawn, config=AutoscalerConfig(
            min_replicas=1, max_replicas=2, cooldown_s=0.0))
        if not scaler.scale_out("forced"):
            raise AssertionError("the autoscaler did not spawn replica B")
        b_id = spawned["id"]
        out["replica_b_spawn_to_attach_s"] = spawned["attach_s"]
        # B publishes its registry on its first serve-loop beat and then
        # on the heartbeat cadence (and retires it if it drains): read its
        # cache counters once it has published
        names = ("serving_compile_cache_hits",
                 "serving_compile_cache_misses",
                 "serving_compile_cache_refusals",
                 "serving_compile_cache_graphs")
        deadline = time.perf_counter() + 30.0
        b_cache = _published_counters(
            client, fleet.REPLICA_RANK_BASE + b_id, names)
        while b_cache[names[0]] is None and time.perf_counter() < deadline:
            time.sleep(0.05)
            b_cache = _published_counters(
                client, fleet.REPLICA_RANK_BASE + b_id, names)
        # from here on, the launches in this process are replica A's
        k1_before = ck.PAGED_ATTENTION.launches
        steps_before = eng_a.decode_steps
        t0 = time.perf_counter()
        rids = []
        for p in prompts:
            # open loop, one arrival every 50 ms: the replicas publish
            # their occupancy between arrivals, which the router balances
            rids.append(router.submit(p, max_new_tokens=32))
            t_next = time.perf_counter() + 0.05
            while time.perf_counter() < t_next:
                router.poll()
                time.sleep(router.poll_interval)
        while sum(rid in router.results for rid in rids) < len(rids) // 2:
            router.poll()
            time.sleep(router.poll_interval)
        # halfway: wait (5 s at most) for A to rank least loaded, as the
        # autoscaler ranks replicas, then scale in
        rank = lambda v: (int(v.occ.get("running", 0))      # noqa: E731
                          + int(v.occ.get("waiting", 0)),
                          -v.free_pages, v.i)
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            views = {v.i: v for v in router._targets(router.discover())}
            if len(views) == 2 and rank(views[rep_a.replica_id]) \
                    < rank(views[b_id]):
                break
            router.poll()
            time.sleep(0.005)
        out["scaled_in_at_completed"] = sum(rid in router.results
                                            for rid in rids)
        victim = scaler.scale_in("forced")
        out["drained_replica"] = "A" if victim == rep_a.replica_id \
            else "B" if victim == b_id else victim
        res = router.await_results(rids, timeout=600)
        wall = time.perf_counter() - t0
        if victim == rep_a.replica_id:
            thread_a.join(timeout=60)
        k1 = ck.PAGED_ATTENTION.launches - k1_before
        a_steps = eng_a.decode_steps - steps_before
        statuses = {rid: r["status"] for rid, r in res.items()}
        got = [res[rid].get("tokens") for rid in rids]
        mismatched = [{"request": i, "prompt_len": len(prompts[i]),
                       "replica": res[rid].get("replica"),
                       **_token_gap(torch, model, prompts[i], got[i],
                                    want[i])}
                      for i, rid in enumerate(rids) if got[i] != want[i]]
        ttft = [res[rid]["ttft_ms"] for rid in rids
                if "ttft_ms" in res[rid]]
        tpot = []
        for rid in rids:
            r = res[rid]
            sub = json.loads(client.get(fleet.k_req(rid)).decode())
            n = len(r.get("tokens") or [])
            if n > 1 and "ttft_ms" in r:
                e2e_ms = (r["t_done_unix"] - sub["t_submit_unix"]) * 1e3
                tpot.append((e2e_ms - r["ttft_ms"]) / (n - 1))
        c = eng_a.compile_cache
        out.update({
            "requests": len(rids),
            "ok": sum(s == "ok" for s in statuses.values()),
            "statuses": sorted(set(statuses.values())),
            "tokens_equal_single_engine": not mismatched,
            "mismatched": mismatched,
            "wall_s": wall,
            "output_tokens": sum(len(g or []) for g in got),
            "tokens_per_s": sum(len(g or []) for g in got) / wall,
            "ttft_p50_ms": percentile(ttft, 0.5),
            "tpot_p50_ms": percentile(tpot, 0.5),
            "rerouted": sum(bool(router.requeues.get(rid)) for rid in rids),
            "served_by": {str(k): sum(res[rid].get("replica") == k
                                      for rid in rids)
                          for k in (rep_a.replica_id, b_id)},
            "replica_a_cache": {"hits": c.hits, "misses": c.misses,
                                "refusals": c.refusals,
                                "graphs": c.graphs},
            "replica_b_cache": {
                "hits": b_cache["serving_compile_cache_hits"],
                "misses": b_cache["serving_compile_cache_misses"],
                "refusals": b_cache["serving_compile_cache_refusals"],
                "graphs": b_cache["serving_compile_cache_graphs"]},
            "replica_a_dispatches": a_steps,
            "replica_a_graph_replays": getattr(eng_a._decode, "replays",
                                              None),
            "paged_attention_launches_replica_a": k1,
            "autoscaler": {"scale_outs": scaler.scale_outs,
                           "scale_ins": scaler.scale_ins}})
        emit(out)
        if out["ok"] != len(rids):
            raise AssertionError(f"fleet requests not all ok: {statuses}")
        if mismatched:
            raise AssertionError(f"fleet tokens differ from the single "
                                 f"engine's: {mismatched}")
        if not b_cache["serving_compile_cache_hits"]:
            raise AssertionError(f"replica B recorded no cache hit: "
                                 f"{b_cache}")
        if k1 != cfg.num_layers * a_steps or not a_steps:
            raise AssertionError(
                f"paged attention launched {k1} times for {a_steps} "
                f"dispatches of replica A ({cfg.num_layers} layers)")
        if victim not in (rep_a.replica_id, b_id):
            raise AssertionError(f"scale-in drained nothing ({victim})")
    finally:
        stop_a.set()
        if thread_a is not None:
            thread_a.join(timeout=60)   # A drains before its store closes
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        for c in (conn_a, client, server):
            if c is not None:
                c.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 5 ------------------------------------------------------------------
PEAK_BF16_FLOPS = PEAK_OPS_PER_S["bfloat16"]


def _token_batches(torch, vocab, shape, label_shape, label_range):
    """``batch(*lead)`` drawing (ids, labels) of shapes lead + ``shape``
    and lead + ``label_shape`` on the card from one
    ``numpy.random.default_rng(0)``: ids in [0, vocab), labels in [0,
    label_range)."""
    import numpy as np
    rng = np.random.default_rng(0)

    def batch(*lead):
        return tuple(torch.from_numpy(rng.integers(0, hi, lead + shp))
                     .to("cuda")
                     for hi, shp in ((vocab, shape),
                                     (label_range, label_shape)))

    return batch


def gpt124m_training(torch):
    """GPT-124M pretraining as ``bench.py`` runs it: fp32 parameters from
    seed 0, AdamW at lr 1e-4, a bf16 O2 ``CompiledTrainStep``. Returns
    (model, step, batch); ``batch(*lead)`` draws (ids, labels) of shape
    lead + (16, 1024) on the card from one ``numpy.random.default_rng(0)``.
    ``scripts/profile_torch_train_step.py`` traces this same workload."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = CompiledTrainStep(lambda ids, labels: model(ids, labels=labels)[1],
                             model, opt, amp_level="O2")
    shape = (TRAIN_BATCH, cfg.max_seq_len)
    return model, step, _token_batches(torch, cfg.vocab_size, shape, shape,
                                       cfg.vocab_size)


def ernie_config(**kw):
    """ERNIE-3.0-base as ``benchmarks/matrix.py:125-166`` builds it: vocab
    40000, hidden 768, 12 layers of 12 heads of 64, FFN 3072, 512
    positions, type vocab 4, task-type vocab 3, LayerNorm eps 1e-12, no
    dropout."""
    from paddle_tpu_torch.text.ernie import ErnieConfig
    return ErnieConfig(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0,
                       max_position_embeddings=ERNIE_SEQ, **kw)


def bert_config(**kw):
    """BERT-base as ``benchmarks/matrix.py:95-122`` builds it: vocab
    30522, hidden 768, 12 layers, FFN 3072, 512 positions, type vocab 2,
    no dropout."""
    from paddle_tpu_torch.text.bert import BertConfig
    return BertConfig(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0, **kw)


def ernie_pretraining(torch):
    """ERNIE-3.0-base pretraining as ``benchmarks/matrix.py:125-166`` runs
    it: ``ErnieForPretraining`` with fp32 parameters from seed 0, AdamW at
    lr 1e-4, a bf16 O2 ``CompiledTrainStep`` over ``lambda ids, l:
    net(ids, labels=l)[1]``; ids and labels of shape lead + (16, 512)
    drawn in [0, 40000). As there, the model and optimizer go through
    ``group_sharded_parallel(net, opt, "p_g_os")`` and the step gets the
    unwrapped net and ``getattr(opt2, "_optim", opt2)``; in one process
    the sharding degree is 1 and ZeRO changes nothing (the
    ``hybrid_parallel`` path runs it at sharding 2). Returns (model, step,
    batch) as ``gpt124m_training`` does."""
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.ernie import ErnieForPretraining
    cfg = ernie_config()
    model = ErnieForPretraining(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    net, opt2, _ = group_sharded_parallel(model, opt, "p_g_os")
    step = CompiledTrainStep(lambda ids, l: net(ids, labels=l)[1], model,
                             getattr(opt2, "_optim", opt2), amp_level="O2")
    shape = (ERNIE_BATCH, ERNIE_SEQ)
    return model, step, _token_batches(torch, cfg.vocab_size, shape, shape,
                                       cfg.vocab_size)


def bert_finetune(torch):
    """BERT-base finetuning as ``benchmarks/matrix.py:95-122`` runs it:
    ``BertForSequenceClassification`` with 2 classes, fp32 parameters
    from seed 0, AdamW at lr 2e-5, a bf16 O2 ``CompiledTrainStep``; ids of
    shape lead + (32, 128) in [0, 30522) and one class in {0, 1} per
    sequence. Returns (model, step, batch) as ``gpt124m_training`` does."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.bert import BertForSequenceClassification
    cfg = bert_config()
    model = BertForSequenceClassification(cfg, num_classes=2, device="cuda",
                                          seed=0)
    opt = AdamW(learning_rate=2e-5, parameters=model.parameters())
    step = CompiledTrainStep(lambda ids, y: model(ids, labels=y)[1], model,
                             opt, amp_level="O2")
    return model, step, _token_batches(torch, cfg.vocab_size,
                                       (BERT_BATCH, BERT_SEQ),
                                       (BERT_BATCH,), 2)


def flops_per_token(model, layers, hidden, seq):
    """6N + 12 L H S (N every parameter, the tied one once): the JAX
    package's count (``text/gpt.py`` ``flops_per_token``,
    ``benchmarks/matrix.py:159-166``), so MFU means the same in both."""
    n = sum(p.numel() for p in model.parameters())
    return 6 * n + 12 * layers * hidden * seq


# the training paths: (phase, workload, run_steps K, layers, hidden,
# description)
TRAINING_PATHS = {
    "gpt124m": ("training_bf16", gpt124m_training, TRAIN_K, 12, 768,
                "gpt_small (GPT-124M), fp32 params, O2 bf16 compute, "
                "AdamW lr 1e-4, random weights seed 0"),
    "ernie": ("ernie_pretraining_bf16", ernie_pretraining, ERNIE_K, 12, 768,
              "ErnieForPretraining, ERNIE-3.0-base (vocab 40000), fp32 "
              "params, O2 bf16 compute, AdamW lr 1e-4, random weights and "
              "tokens seed 0, no group_sharded_parallel"),
    "bert": ("bert_finetune_bf16", bert_finetune, BERT_K, 12, 768,
             "BertForSequenceClassification, BERT-base (vocab 30522), 2 "
             "classes, fp32 params, O2 bf16 compute, AdamW lr 2e-5, random "
             "weights and tokens seed 0"),
}


def phase_training_bf16(torch, ck, smi, path="gpt124m"):
    """One training path's workload: 3 warm-up steps, 10 timed calls, then
    one timed ``run_steps`` block of K; each step must launch K2 and K3
    once per layer."""
    phase, build, k, layers, hidden, describe = TRAINING_PATHS[path]
    model, step, batch = build(torch)
    ids, labels = batch()
    ids_k, labels_k = batch(k)
    b, seq = ids.shape
    tokens = b * seq
    per_token = flops_per_token(model, layers, hidden, seq)
    torch.cuda.reset_peak_memory_stats()
    before = {k_.name: k_.launches for k_ in ck.KERNELS}
    losses = [step(ids, labels) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(ids, labels) for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    per_call_s = (time.perf_counter() - t0) / TRAIN_TIMED
    t0 = time.perf_counter()
    block = step.run_steps(ids_k, labels_k)
    torch.cuda.synchronize()
    run_steps_s = (time.perf_counter() - t0) / k
    losses = [float(x) for x in losses] + block.tolist()
    launches = {k_.name: k_.launches - before[k_.name] for k_ in ck.KERNELS}
    steps = TRAIN_WARMUP + TRAIN_TIMED + k

    def rates(step_s):
        tps = tokens / step_s
        return {"step_ms": step_s * 1e3, "tokens_per_s": tps,
                "sequences_per_s": b / step_s,
                "mfu": tps * per_token / PEAK_BF16_FLOPS}

    out = {"phase": phase, "nvidia_smi": smi, "model": describe,
           "batch": b, "seq": seq,
           "num_parameters": sum(p.numel() for p in model.parameters()),
           "flops_per_token": per_token, "mfu_peak_flops": PEAK_BF16_FLOPS,
           "per_call": rates(per_call_s),
           f"run_steps_k{k}": rates(run_steps_s),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "steps": steps, "losses": losses, "launches": launches}
    emit(out)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a training loss is not finite: {losses}")
    want = layers * steps
    if launches["flash_bwd"] != want or launches["flash_fwd"] != want:
        raise AssertionError(
            f"{steps} steps of {layers} layers launched flash_fwd "
            f"{launches['flash_fwd']} and flash_bwd {launches['flash_bwd']} "
            f"times; want {want} each")


def _grads(model):
    """{name: gradient on the CPU, or None for a parameter the loss never
    reads}."""
    return {n: None if p.grad is None else p.grad.cpu()
            for n, p in model.named_parameters()}


def training_exactness_fp32(torch, ck, phase, describe, build, ids, labels,
                            mask=None):
    """One fp32 step (loss and every gradient) of a model at full width
    and 2 layers, built by ``build(device)`` from one seed: on the card
    through K2/K3 and on the CPU through their plain versions, on the same
    batch. With ``mask``, also one padded forward (the dense attention
    path) on each device. The loss within 1e-4, every gradient within 1e-4
    of its own largest entry (fp32 sums over the batch's tokens taken in
    different orders on the two devices; a gradient that is zero up to
    rounding, below 1e-6 of the largest entry, on both devices), the
    masked logits within 1e-4 of their largest entry."""
    results, models = {}, {}
    before = {k.name: k.launches for k in ck.KERNELS}
    for dev in ("cuda", "cpu"):
        models[dev] = model = build(dev)
        loss = model(ids.to(dev), labels=labels.to(dev))[1]
        loss.backward()
        results[dev] = (loss.item(), _grads(model))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {k.name: k.launches - before[k.name]
                        for k in ck.KERNELS}
    loss_err = abs(results["cuda"][0] - results["cpu"][0])
    cpu_grads = results["cpu"][1]
    unread = sorted(n for n, g in cpu_grads.items() if g is None)
    unread_cuda = sorted(n for n, g in results["cuda"][1].items()
                         if g is None)
    # a gradient that is zero in exact arithmetic (k_proj's bias: it
    # shifts each row of scores by a constant, which softmax removes) is
    # rounding noise on both devices; it is held below 1e-6 of the
    # model's largest gradient entry, every other one relative to itself
    top = max(float(g.abs().max()) for g in cpu_grads.values()
              if g is not None)
    zero = sorted(n for n, g in cpu_grads.items()
                  if g is not None and float(g.abs().max()) <= 1e-6 * top)
    zero_ok = all(float(results["cuda"][1][n].abs().max()) <= 1e-6 * top
                  for n in zero)
    grad_rel = {n: max_err(g, cpu_grads[n]) /
                float(cpu_grads[n].abs().max())
                for n, g in results["cuda"][1].items()
                if g is not None and n not in zero}
    worst = max(grad_rel, key=grad_rel.get)
    out = {"phase": phase, "tf32": False, "model": describe,
           "batch": list(ids.shape),
           "loss_cuda": results["cuda"][0], "loss_cpu": results["cpu"][0],
           "loss_abs_err": loss_err, "loss_tol": 1e-4,
           "grad_max_rel_err": grad_rel[worst], "grad_worst": worst,
           "grad_rel_tol": 1e-4, "grads_zero_up_to_rounding": zero,
           "zero_tol_of_largest_grad": 1e-6, "params": len(cpu_grads),
           "params_without_gradient": unread, "launches": launches}
    masked_rel = None
    if mask is not None:
        with torch.no_grad():
            fwd_before = ck.FLASH_FWD.launches
            logits = {dev: m(ids.to(dev), attention_mask=mask.to(dev))
                      for dev, m in models.items()}
            masked_launches = ck.FLASH_FWD.launches - fwd_before
        masked_rel = max_err(logits["cuda"].cpu(), logits["cpu"]) / \
            float(logits["cpu"].abs().max())
        out.update(masked_rel_err=masked_rel, masked_rel_tol=1e-4,
                   masked_valid_tokens=mask.sum(1).tolist(),
                   masked_flash_launches=masked_launches)
    emit(out)
    layers = 2
    if launches["flash_fwd"] != layers or launches["flash_bwd"] != layers:
        raise AssertionError(f"the fp32 step launched {launches}")
    if unread != unread_cuda:
        raise AssertionError(f"parameters without a gradient differ: card "
                             f"{unread_cuda}, CPU {unread}")
    if loss_err > 1e-4 or grad_rel[worst] > 1e-4 or not zero_ok:
        raise AssertionError(f"card step differs from the CPU step: loss "
                             f"{loss_err}, {worst} {grad_rel[worst]}, zero "
                             f"up to rounding on the CPU {zero}")
    if mask is not None and (masked_rel > 1e-4
                             or out["masked_flash_launches"]):
        raise AssertionError(f"masked forward: {masked_rel} against the CPU, "
                             f"{out['masked_flash_launches']} flash launches")


def _seeded_ids(torch, vocab, shape, seed=1):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, vocab, shape))
            for _ in range(2))


def phase_training_exactness_fp32(torch, ck):
    """GPT at GPT-124M's widths, 2 layers, batch 2 x 1024."""
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12)
    ids, labels = _seeded_ids(torch, cfg.vocab_size, (2, cfg.max_seq_len))
    training_exactness_fp32(
        torch, ck, "training_exactness_fp32",
        "GPT-124M widths, 2 layers, fp32, batch 2 x 1024",
        lambda dev: GPTForPretraining(cfg, device=dev, seed=0), ids, labels)


def phase_ernie_exactness_fp32(torch, ck):
    """ERNIE-3.0-base's widths, 2 layers, batch 2 x 512; then a padded
    batch (400 and 512 real tokens) forward on the dense path."""
    from paddle_tpu_torch.text.ernie import ErnieForPretraining
    cfg = ernie_config(num_hidden_layers=2)
    ids, labels = _seeded_ids(torch, cfg.vocab_size, (2, ERNIE_SEQ))
    mask = (torch.arange(ERNIE_SEQ)[None] <
            torch.tensor([[400], [ERNIE_SEQ]])).long()
    training_exactness_fp32(
        torch, ck, "ernie_exactness_fp32",
        "ERNIE-3.0-base widths, 2 layers, fp32, batch 2 x 512",
        lambda dev: ErnieForPretraining(cfg, device=dev, seed=0), ids,
        labels, mask)


def phase_bert_exactness_fp32(torch, ck):
    """BERT-base's widths, 2 layers, 2 classes, batch 2 x 128."""
    from paddle_tpu_torch.text.bert import BertForSequenceClassification
    cfg = bert_config(num_hidden_layers=2)
    ids, _ = _seeded_ids(torch, cfg.vocab_size, (2, BERT_SEQ))
    labels = torch.tensor([0, 1])
    training_exactness_fp32(
        torch, ck, "bert_exactness_fp32",
        "BERT-base widths, 2 layers, 2 classes, fp32, batch 2 x 128",
        lambda dev: BertForSequenceClassification(cfg, num_classes=2,
                                                  device=dev, seed=0),
        ids, labels)


# -- phase 5b: the training surface -------------------------------------------
AMP_WARMUP, AMP_TIMED = 3, 10


def amp_schedule(lr):
    """The upstream eager AMP recipe's schedule at bench.py's learning
    rate: a 100-step linear warm-up into a cosine decay over 1000 steps."""
    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, 1000), 100, 0.0,
                           1e-4)


def eager_amp_steps(torch, model, ids, labels, steps, level, dtype,
                    sched, scaler, opt, sync=True):
    """``steps`` eager steps of the upstream recipe: under ``auto_cast``,
    ``scaler.scale(loss).backward()``, ``scaler.step(opt)``,
    ``opt.clear_grad()``, ``sched.step()``. Returns per step (loss, scale
    before the step, skipped, lr used, host seconds); a step is skipped
    when its gradients were not finite, which halves the scale."""
    from paddle_tpu_torch import amp
    out = []
    for _ in range(steps):
        t0 = time.perf_counter()
        lr = opt.get_lr()
        scale = scaler._scale
        with amp.auto_cast(enable=level != "O0", level=level, dtype=dtype):
            _, loss = model(ids, labels=labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        skipped = scaler._scale < scale
        opt.clear_grad()
        sched.step()
        if sync:
            torch.cuda.synchronize()
        out.append((loss.item(), scale, skipped, lr,
                    time.perf_counter() - t0))
    return out


def gpt124m_fp16_amp(torch):
    """GPT-124M at bench.py's widths (vocab 50304, 12 layers of 12 x 64,
    batch 16 x 1024 drawn as ``gpt124m_training`` draws it) set up for the
    eager upstream AMP recipe: ``decorate(model, opt, level="O2",
    dtype="float16")``, AdamW under the warm-up/cosine schedule with
    ``ClipGradByGlobalNorm(1.0)``, ``GradScaler(init_loss_scaling=2**15)``.
    Returns (model, opt, sched, scaler, ids, labels);
    ``scripts/profile_torch_train_step.py`` traces this same workload."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    sched = amp_schedule(popt.lr)
    opt = popt.AdamW(learning_rate=sched, parameters=model.parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    ids, labels = _token_batches(torch, cfg.vocab_size,
                                 (TRAIN_BATCH, cfg.max_seq_len),
                                 (TRAIN_BATCH, cfg.max_seq_len),
                                 cfg.vocab_size)()
    return model, opt, sched, scaler, ids, labels


def phase_gpt124m_fp16_amp(torch, ck, smi):
    """``gpt124m_fp16_amp``'s recipe: 3 warm-up and 10 timed steps. Every
    step must launch K2 and K3 once per layer on their fp16 route, and
    every loss of a step the scaler did not skip must be finite."""
    model, opt, sched, scaler, ids, labels = gpt124m_fp16_amp(torch)
    layers = model.config.num_layers
    tokens = ids.numel()
    torch.cuda.reset_peak_memory_stats()
    before = {k.name: dict(k.route_launches) for k in ck.KERNELS}
    steps = eager_amp_steps(torch, model, ids, labels,
                            AMP_WARMUP + AMP_TIMED, "O2", "float16", sched,
                            scaler, opt)
    routes = {k.name: {r: n - before[k.name][r]
                       for r, n in k.route_launches.items()}
              for k in ck.KERNELS}
    timed = [s for *_, s in steps[AMP_WARMUP:]]
    step_s = sum(timed) / len(timed)
    n = len(steps)
    out = {"phase": "gpt124m_fp16_amp", "nvidia_smi": smi,
           "model": "gpt_small (GPT-124M), eager, decorate O2 float16, "
                    "auto_cast O2 float16, AdamW under LinearWarmup(Cosine"
                    "AnnealingDecay(1e-4, 1000), 100, 0, 1e-4), "
                    "ClipGradByGlobalNorm(1.0), GradScaler(2**15), random "
                    "weights seed 0",
           "batch": list(ids.shape), "steps": n,
           "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "tokens_per_s_each_step": [tokens / s for *_, s in steps],
           "losses": [l for l, *_ in steps],
           "scale": [sc for _, sc, *_ in steps] + [scaler._scale],
           "skipped_steps": [i for i, (_, _, sk, *_) in enumerate(steps)
                             if sk],
           "lr": [lr for *_, lr, _ in steps],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches_by_route": routes}
    emit(out)
    bad = [i for i, (l, _, sk, *_) in enumerate(steps)
           if not sk and not math.isfinite(l)]
    if bad:
        raise AssertionError(f"non-finite loss on steps the scaler kept: "
                             f"{bad}")
    want = layers * n
    for name in ("flash_fwd", "flash_bwd"):
        if routes[name] != {"fp32": 0, "bf16": 0, "fp16": want}:
            raise AssertionError(f"{n} steps of {layers} layers "
                                 f"launched {name} {routes[name]}; want "
                                 f"{want} on the fp16 route")
    if not all(p.dtype == torch.float16 for p in model.parameters()):
        raise AssertionError("decorate left a parameter that is not fp16")


SURFACE_WARMUP, SURFACE_TIMED = 2, 4
SURFACE_ATTENTION = (16, 1024, 12, 64)


def surface_amp_loop(torch, np_ids, np_labels, surface):
    """``gpt124m_fp16_amp``'s recipe (``eager_amp_steps``) from the same
    seed and batch. With ``surface`` it runs on the ``paddle.*`` surface
    as an upstream user writes it: ``paddle.seed(0)``,
    ``paddle.set_device("gpu")``, ids and labels from
    ``paddle.to_tensor``, so the model is called on paddle Tensors and
    its loss is one; without, the same steps are fed torch tensors.
    Returns (model, eager_amp_steps' rows, the scale after the last)."""
    import paddle_tpu_torch as paddle
    model, opt, sched, scaler, _, _ = gpt124m_fp16_amp(torch)
    if surface:
        paddle.seed(0)
        paddle.set_device("gpu")
        ids, labels = paddle.to_tensor(np_ids), paddle.to_tensor(np_labels)
    else:
        ids = torch.from_numpy(np_ids).to("cuda")
        labels = torch.from_numpy(np_labels).to("cuda")
    steps = eager_amp_steps(torch, model, ids, labels,
                            SURFACE_WARMUP + SURFACE_TIMED, "O2", "float16",
                            sched, scaler, opt)
    return model, steps, scaler._scale


def surface_flash_grad(torch, causal):
    """``paddle.grad`` through ``F.flash_attention`` on paddle Tensors at
    [16, 1024, 12, 64] bf16 against the torch-fed call on the same
    inputs: (out, dq, dk, dv) must be bit-equal."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(SURFACE_ATTENTION, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    out_t, _ = F.flash_attention(qt, kt, vt, causal=causal)
    want = (out_t, *torch.autograd.grad(out_t, (qt, kt, vt), do))
    qp, kp, vp = (paddle.to_tensor(t, stop_gradient=False)
                  for t in (q, k, v))
    out_p, _ = F.flash_attention(qp, kp, vp, causal=causal)
    grads = paddle.grad(out_p, [qp, kp, vp],
                        grad_outputs=paddle.to_tensor(do))
    got = [out_p._value] + [g._value for g in grads]
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    if not all(equal):
        raise AssertionError(f"paddle.grad through flash_attention "
                             f"(causal={causal}) is not bit-equal to the "
                             f"torch-fed call: out, dq, dk, dv equal "
                             f"{equal}")
    return equal


def phase_paddle_surface(torch, ck, smi):
    """The ``paddle.*`` eager surface on the card, three parts:

    1. GPT-124M's eager fp16 AMP loop (``surface_amp_loop``) on paddle
       Tensors and on torch tensors, from the same seed and batch: the
       losses, the scale trajectory and every final parameter must be
       bit-equal, and the surface loop must launch K2 and K3 once per
       layer and step on their fp16 route; tokens/s both ways;
    2. ``paddle.grad`` through ``F.flash_attention`` (``surface_flash_grad``),
       causal and not;
    3. the op sweep: every entry of the op table on the card against the
       port's own CPU result at the entry's tolerance (fp32, TF32 off;
       gradients in fp64 where the entry has them), and the random ops by
       their moments and seeded reruns."""
    from paddle_tpu_torch.ops import sweep
    from paddle_tpu_torch.text.gpt import gpt_small
    cfg = gpt_small()
    ids, labels = _token_batches(torch, cfg.vocab_size,
                                 (TRAIN_BATCH, cfg.max_seq_len),
                                 (TRAIN_BATCH, cfg.max_seq_len),
                                 cfg.vocab_size)()
    np_ids, np_labels = ids.cpu().numpy(), labels.cpu().numpy()
    before = {k.name: dict(k.route_launches) for k in ck.KERNELS}
    s_model, s_steps, s_last = surface_amp_loop(torch, np_ids, np_labels,
                                                surface=True)
    routes = {k.name: {r: n - before[k.name][r]
                       for r, n in k.route_launches.items()}
              for k in ck.KERNELS}
    import paddle_tpu_torch as paddle
    with paddle.no_grad():
        _, loss = s_model(paddle.to_tensor(np_ids[:1, :128]),
                          labels=paddle.to_tensor(np_labels[:1, :128]))
    if not isinstance(loss, paddle.Tensor):
        raise AssertionError(f"the model fed paddle Tensors returned a "
                             f"{type(loss)} loss, not a paddle Tensor")
    t_model, t_steps, t_last = surface_amp_loop(torch, np_ids, np_labels,
                                                surface=False)
    s_losses, t_losses = [r[0] for r in s_steps], [r[0] for r in t_steps]
    s_scales = [r[1] for r in s_steps] + [s_last]
    t_scales = [r[1] for r in t_steps] + [t_last]
    s_secs, t_secs = [r[-1] for r in s_steps], [r[-1] for r in t_steps]
    layers = s_model.config.num_layers
    steps = SURFACE_WARMUP + SURFACE_TIMED
    tokens = np_ids.size
    differing = [n for (n, a), b in zip(s_model.named_parameters(),
                                        t_model.parameters())
                 if not torch.equal(a, b)]
    del s_model, t_model
    torch.cuda.empty_cache()
    flash = {"causal": surface_flash_grad(torch, True),
             "non_causal": surface_flash_grad(torch, False)}
    t0 = time.perf_counter()
    sweep_report, sweep_failures = sweep.device_sweep("gpu")
    random_report, random_failures = sweep.random_checks("gpu")
    sweep_s = time.perf_counter() - t0
    out = {"phase": "paddle_surface", "nvidia_smi": smi,
           "model": "gpt_small (GPT-124M) at 16 x 1024, the eager fp16 "
                    "AMP recipe of gpt124m_fp16_amp, fed paddle Tensors "
                    "and torch tensors",
           "steps": steps, "timed_steps": SURFACE_TIMED,
           "tokens_per_s_surface": tokens * SURFACE_TIMED
           / sum(s_secs[SURFACE_WARMUP:]),
           "tokens_per_s_torch": tokens * SURFACE_TIMED
           / sum(t_secs[SURFACE_WARMUP:]),
           "step_ms_surface": [s * 1e3 for s in s_secs],
           "step_ms_torch": [s * 1e3 for s in t_secs],
           "losses_surface": s_losses, "losses_torch": t_losses,
           "scales": s_scales, "launches_by_route": routes,
           "params_differing": differing,
           "flash_grad_bit_equal": flash,
           "sweep_ops": sum(r["ops"] for r in sweep_report.values()),
           "sweep_worst_by_family": sweep_report,
           "sweep_failures": sweep_failures,
           "random_ops": random_report,
           "random_failures": random_failures,
           "sweep_seconds": sweep_s}
    emit(out)
    if s_losses != t_losses or s_scales != t_scales or differing:
        raise AssertionError(
            f"the surface loop is not bit-equal to the torch-fed one: "
            f"losses {s_losses} vs {t_losses}, scales {s_scales} vs "
            f"{t_scales}, parameters differing {differing[:5]}")
    want = layers * steps
    for name in ("flash_fwd", "flash_bwd"):
        if routes[name] != {"fp32": 0, "bf16": 0, "fp16": want}:
            raise AssertionError(f"the surface loop's {steps} steps of "
                                 f"{layers} layers launched {name} "
                                 f"{routes[name]}; want {want} on fp16")
    if sweep_failures or random_failures:
        raise AssertionError(f"the op sweep failed on the card: "
                             f"{sweep_failures} {random_failures}")


def gpt124m_scheduled(torch, seed=0, check_nan=True):
    """GPT-124M through ``CompiledTrainStep`` at O2 bf16 with
    ``examples/train_gpt.py``'s surface at bench.py's widths: AdamW under
    ``CosineAnnealingDecay(3e-4, 14)`` with ``ClipGradByGlobalNorm(1.0)``,
    ``FLAGS_check_nan_inf`` set before the step is built (it is read
    then; ``check_nan=False`` leaves it as it is) and
    ``set_meter_info(tokens_per_step=16384)``, weights from ``seed``.
    Returns (model, opt, sched, step, batch) with ``batch`` as
    ``gpt124m_training``'s; ``scripts/profile_torch_train_step.py`` traces
    this same workload."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    if check_nan:
        set_flags({"FLAGS_check_nan_inf": True})
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", seed=seed)
    sched = popt.lr.CosineAnnealingDecay(3e-4, TRAIN_WARMUP + TRAIN_TIMED + 1)
    opt = popt.AdamW(learning_rate=sched, parameters=model.parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        lambda i, lb: model(i, labels=lb)[1], model, opt,
        amp_level="O2").set_meter_info(
            tokens_per_step=TRAIN_BATCH * cfg.max_seq_len)
    shape = (TRAIN_BATCH, cfg.max_seq_len)
    return model, opt, sched, step, _token_batches(
        torch, cfg.vocab_size, shape, shape, cfg.vocab_size)


def phase_gpt124m_scheduled(torch, ck, smi):
    """``gpt124m_scheduled``'s workload with the StepMeter on: 3 warm-up
    and 10 timed calls with the nan check on, the scheduler stepped after
    each, then a ``run_steps`` block of 8 at the rate of the block's
    start, through a step built with the flag clear (``run_steps``
    refuses the flag, as the reference does, and the flagged step must
    raise so). The rate each step read must be the scheduler's sequence,
    and the meter must count each call and the block. Then one
    ``use_rmsnorm=True`` step at full width."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.observability import metrics, perf
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    n_calls = TRAIN_WARMUP + TRAIN_TIMED
    try:
        model, opt, sched, step, batch = gpt124m_scheduled(torch)
        read = []
        get_lr = opt.get_lr
        opt.get_lr = lambda: read.append(get_lr()) or read[-1]
        ids, labels = batch()
        ids_k, labels_k = batch(TRAIN_K)
        try:
            step.run_steps(ids_k, labels_k)
        except RuntimeError as e:
            if "FLAGS_check_nan_inf" not in str(e):
                raise
        else:
            raise AssertionError("run_steps took FLAGS_check_nan_inf")
        set_flags({"FLAGS_check_nan_inf": False})
        block_step = CompiledTrainStep(
            step.fn, model, opt, amp_level="O2").set_meter_info(
                tokens_per_step=step.meter_tokens)
        steps_total = metrics.counter("perf_steps_total")
        gauge = metrics.gauge("perf_tokens_per_sec")
        n0 = steps_total.total()
        perf.enable()
        losses, host_s, meter_tps = [], [], []
        for i in range(n_calls):
            t0 = time.perf_counter()
            losses.append(step(ids, labels).item())
            host_s.append(time.perf_counter() - t0)
            meter_tps.append(gauge.series()[()])
            sched.step()
        t0 = time.perf_counter()
        block = block_step.run_steps(ids_k, labels_k)
        block_host_s = time.perf_counter() - t0
        block_meter_tps = gauge.series()[()]
        perf.disable()
        metered = steps_total.total() - n0
        losses += block.tolist()
        fresh = popt.lr.CosineAnnealingDecay(3e-4, n_calls + 1)
        want = []
        for _ in range(n_calls + 1):
            want.append(fresh())
            fresh.step()
        timed = slice(TRAIN_WARMUP, None)
        tokens = ids.numel()
        out = {"phase": "gpt124m_scheduled", "nvidia_smi": smi,
               "model": "gpt_small (GPT-124M), CompiledTrainStep O2 bf16, "
                        "AdamW under CosineAnnealingDecay(3e-4, 14), "
                        "ClipGradByGlobalNorm(1.0), FLAGS_check_nan_inf per "
                        "call (run_steps refuses it), "
                        "StepMeter on, random weights seed 0",
               "lr_read": read, "lr_scheduler": want,
               "losses": losses,
               "metered_steps": metered,
               "per_call_tokens_per_s_host":
                   tokens * TRAIN_TIMED / sum(host_s[timed]),
               "per_call_tokens_per_s_meter":
                   sum(meter_tps[timed]) / TRAIN_TIMED,
               "per_call_tokens_per_s_meter_each": meter_tps,
               "run_steps_tokens_per_s_host":
                   tokens * TRAIN_K / block_host_s,
               "run_steps_tokens_per_s_meter": block_meter_tps}
        # one RMSNorm step at full width
        rms = GPTForPretraining(gpt_small(use_rmsnorm=True), device="cuda",
                                seed=0)
        ropt = popt.AdamW(learning_rate=1e-4, parameters=rms.parameters())
        rstep = CompiledTrainStep(lambda i, lb: rms(i, labels=lb)[1], rms,
                                  ropt, amp_level="O2")
        out["rmsnorm_loss"] = rstep(ids, labels).item()
        emit(out)
    finally:
        perf.disable()
        set_flags({"FLAGS_check_nan_inf": False})
    if read != want:
        raise AssertionError(f"the steps read {read}; the scheduler's "
                             f"sequence is {want}")
    if metered != n_calls + 1:
        raise AssertionError(f"the StepMeter counted {metered} steps of "
                             f"{n_calls} calls and one block")
    if not all(math.isfinite(x) for x in losses + [out["rmsnorm_loss"]]):
        raise AssertionError(f"a loss is not finite: {losses}, "
                             f"{out['rmsnorm_loss']}")


def eager_exactness_fp32(torch, ck, phase, describe, cfg, ids, labels):
    """Two eager O0 steps of the upstream recipe (warm-up/cosine schedule,
    global-norm clip, an enabled ``GradScaler``: outside an fp16
    ``auto_cast`` block the ambient dtype is float32, so it scales) of a
    full-width, 2-layer fp32 GPT from one seed, on the card and on the
    CPU: both losses within 1e-4, the first step's unscaled gradients
    within 1e-4 of their largest entry (one that is zero up to rounding
    below 1e-6 of the largest gradient on both), and the scales, skips and
    rates equal."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.text.gpt import GPTForPretraining
    res = {}
    for dev in ("cuda", "cpu"):
        model = GPTForPretraining(cfg, device=dev, seed=0)
        sched = popt.lr.LinearWarmup(popt.lr.CosineAnnealingDecay(1e-4, 1000),
                                     2, 1e-5, 1e-4)
        opt = popt.AdamW(learning_rate=sched, parameters=model.parameters(),
                         grad_clip=ClipGradByGlobalNorm(1.0))
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
        grads = {}
        clear = opt.clear_grad

        def keep_then_clear():
            if not grads:
                grads.update({n: p.grad.detach().cpu()
                              for n, p in model.named_parameters()})
            clear()
        opt.clear_grad = keep_then_clear
        steps = eager_amp_steps(torch, model, ids.to(dev), labels.to(dev), 2,
                                "O0", "float32", sched, scaler, opt,
                                sync=dev == "cuda")
        res[dev] = ([s[:4] for s in steps], grads)
    (card, cg), (cpu, pg) = res["cuda"], res["cpu"]
    top = max(float(g.abs().max()) for g in pg.values())
    zero = sorted(n for n, g in pg.items()
                  if float(g.abs().max()) <= 1e-6 * top)
    rel = {n: max_err(g, pg[n]) / float(pg[n].abs().max())
           for n, g in cg.items() if n not in zero}
    worst = max(rel, key=rel.get)
    loss_err = max(abs(a[0] - b[0]) for a, b in zip(card, cpu))
    out = {"phase": phase, "tf32": False, "model": describe,
           "batch": list(ids.shape), "losses_cuda": [s[0] for s in card],
           "losses_cpu": [s[0] for s in cpu], "loss_abs_err": loss_err,
           "loss_tol": 1e-4, "grad_max_rel_err": rel[worst],
           "grad_worst": worst, "grad_rel_tol": 1e-4,
           "grads_zero_up_to_rounding": zero,
           "scale_skip_lr_cuda": [s[1:] for s in card],
           "scale_skip_lr_cpu": [s[1:] for s in cpu]}
    emit(out)
    zero_ok = all(float(cg[n].abs().max()) <= 1e-6 * top for n in zero)
    if loss_err > 1e-4 or rel[worst] > 1e-4 or not zero_ok or \
            [s[1:] for s in card] != [s[1:] for s in cpu]:
        raise AssertionError(f"{phase}: card differs from the CPU: loss "
                             f"{loss_err}, {worst} {rel[worst]}")


def phase_eager_exactness_fp32(torch, ck):
    """The eager recipe at O0 in fp32, GPT-124M's widths, 2 layers, batch
    2 x 1024, with LayerNorm and with RMSNorm."""
    from paddle_tpu_torch.text.gpt import GPTConfig
    for rms in (False, True):
        cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12,
                        use_rmsnorm=rms)
        ids, labels = _seeded_ids(torch, cfg.vocab_size,
                                  (2, cfg.max_seq_len))
        eager_exactness_fp32(
            torch, ck, "eager_rmsnorm_exactness_fp32" if rms
            else "eager_exactness_fp32",
            f"GPT-124M widths, 2 layers, {'RMSNorm' if rms else 'LayerNorm'}"
            ", fp32, eager O0, warm-up/cosine, clip, GradScaler(2**15), "
            "batch 2 x 1024", cfg, ids, labels)


def _one_eager_step(torch, cfg, ids, labels, level, dtype, scale=2.0 ** 15):
    """Loss and gradients (fp32, on the CPU) of one eager step of a
    2-layer GPT from seed 0 on the card: fp32 parameters at O0, or
    ``decorate``d to ``dtype`` at O2. The loss is scaled by ``scale``
    (a power of two) before the backward and the gradients unscaled in
    fp32 after, as ``GradScaler`` does: unscaled, fp16 gradients of the
    logits (about 1/(vocab x tokens)) fall below fp16's range."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.gpt import GPTForPretraining
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    if level == "O2":
        model = amp.decorate(model, level="O2", dtype=dtype)
    with amp.auto_cast(enable=level == "O2", level=level, dtype=dtype):
        _, loss = model(ids, labels=labels)
    (loss * scale).backward()
    return loss.item(), {n: p.grad.float().cpu() / scale
                         for n, p in model.named_parameters()}


def phase_fp16_against_fp32(torch, ck):
    """One eager O2 fp16 step of GPT-124M's widths at 2 layers (batch 2 x
    1024), its loss scaled by 2^15 as the recipe's scaler does, against
    the same step in fp32 O0 on the card. The bound, from
    fp16's unit roundoff u = 2^-11: the loss within 8u of its value (a
    handful of roundings a layer of activations whose error the layer
    norms do not grow; the loss is 1-Lipschitz in the logits' max-norm),
    and every gradient's error against fp32, relative to its largest
    entry, at most half the worst one the same step shows in bf16 O2
    (fp16 keeps 3 more significant bits, so about an eighth is expected;
    gradients zero up to rounding in fp32, below 1e-6 of the largest, are
    left out)."""
    from paddle_tpu_torch.text.gpt import GPTConfig
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12)
    ids, labels = (t.to("cuda") for t in _seeded_ids(
        torch, cfg.vocab_size, (2, cfg.max_seq_len)))
    ref_loss, ref = _one_eager_step(torch, cfg, ids, labels, "O0",
                                    "float32")
    top = max(float(g.abs().max()) for g in ref.values())
    keep = [n for n, g in ref.items() if float(g.abs().max()) > 1e-6 * top]
    errs = {}
    for dtype in ("float16", "bfloat16"):
        loss, grads = _one_eager_step(torch, cfg, ids, labels, "O2", dtype)
        rel = {n: max_err(grads[n], ref[n]) / float(ref[n].abs().max())
               for n in keep}
        worst = max(rel, key=rel.get)
        errs[dtype] = (abs(loss - ref_loss), rel[worst], worst)
    loss_tol = 8 * 2.0 ** -11 * abs(ref_loss)
    grad_tol = 0.5 * errs["bfloat16"][1]
    out = {"phase": "fp16_against_fp32", "model": "GPT-124M widths, 2 "
           "layers, batch 2 x 1024, one eager step: decorate + auto_cast O2 "
           "against fp32 O0 on the card", "loss_fp32": ref_loss,
           "fp16_loss_abs_err": errs["float16"][0], "loss_tol": loss_tol,
           "fp16_grad_max_rel_err": errs["float16"][1],
           "fp16_grad_worst": errs["float16"][2],
           "bf16_loss_abs_err": errs["bfloat16"][0],
           "bf16_grad_max_rel_err": errs["bfloat16"][1],
           "grad_rel_tol": grad_tol}
    emit(out)
    if errs["float16"][0] > loss_tol or errs["float16"][1] > grad_tol:
        raise AssertionError(f"fp16 O2 step off fp32: {out}")


# -- phase 6 ------------------------------------------------------------------
def packed_attention(torch, dtype):
    """The packed-attention workload: ``packed_lengths()`` documents, 12
    heads of 64, causal, with cu_k is cu_q. Returns (lens, q, k, v, do,
    cu) with q, k, v requiring gradients."""
    lens = packed_lengths()
    q, k, v, do, cu, _ = varlen_case(torch, lens, None, PACKED_HEADS,
                                     PACKED_DIM, dtype)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    return lens, q, k, v, do, cu


def phase_packed_attention_bf16(torch, ck, smi):
    """``F.flash_attn_unpadded`` at full width: 3 warm-up forward +
    backward calls, 10 timed forwards, then 10 timed forward + backward
    calls (``torch.autograd.grad`` for dq, dk, dv against a seeded do)."""
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    lens, q, k, v, do, cu = packed_attention(torch, torch.bfloat16)
    longest = max(lens)

    def forward():
        return flash_attn_unpadded(q, k, v, cu, cu, longest, longest,
                                   causal=True)[0]

    def step():
        out = forward()
        return out, torch.autograd.grad(out, (q, k, v), do)

    torch.cuda.reset_peak_memory_stats()
    before = {k_.name: k_.launches for k_ in ck.KERNELS}
    for _ in range(PACKED_WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PACKED_TIMED):
        forward()
    torch.cuda.synchronize()
    fwd_s = (time.perf_counter() - t0) / PACKED_TIMED
    t0 = time.perf_counter()
    for _ in range(PACKED_TIMED):
        out, grads = step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / PACKED_TIMED
    launches = {k_.name: k_.launches - before[k_.name] for k_ in ck.KERNELS}
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
    pairs = visible_pairs(lens, lens, True)
    out_ = {"phase": "packed_attention_bf16", "nvidia_smi": smi,
            "workload": "flash_attn_unpadded, causal, bf16, 12 heads of 64, "
                        "random inputs seed 0",
            "tokens": PACKED_TOKENS, "segments": len(lens),
            "lengths": lens, "visible_pairs_per_head": pairs,
            "visible_pairs": pairs * PACKED_HEADS,
            "forward_ms": fwd_s * 1e3, "forward_backward_ms": step_s * 1e3,
            "forward_backward_tokens_per_s": PACKED_TOKENS / step_s,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches, "finite": finite,
            "out_shape": list(out.shape)}
    emit(out_)
    want_fwd = PACKED_WARMUP + 2 * PACKED_TIMED
    want_bwd = PACKED_WARMUP + PACKED_TIMED
    if launches["flash_varlen_fwd"] != want_fwd or \
            launches["flash_varlen_bwd"] != want_bwd:
        raise AssertionError(
            f"{want_fwd} forwards and {want_bwd} backwards launched K4 "
            f"{launches['flash_varlen_fwd']} and K5 "
            f"{launches['flash_varlen_bwd']} times")
    if not finite or list(out.shape) != [PACKED_TOKENS, PACKED_HEADS,
                                         PACKED_DIM]:
        raise AssertionError("packed attention output or a gradient is not "
                             "finite, or the output is mis-shaped")


def phase_packed_attention_exactness_fp32(torch, ck):
    """The same workload in fp32 (TF32 off): ``flash_attn_unpadded``'s o,
    dq, dk and dv on the card against the per-segment plain versions,
    each within 1e-4 of its largest entry."""
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    lens, q, k, v, do, cu = packed_attention(torch, torch.float32)
    before = {k_.name: k_.launches for k_ in ck.KERNELS}
    out = flash_attn_unpadded(q, k, v, cu, cu, max(lens), max(lens),
                              causal=True)[0]
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    launches = {k_.name: k_.launches - before[k_.name] for k_ in ck.KERNELS}
    out, q, k, v = out.detach(), q.detach(), k.detach(), v.detach()
    ro, rlse = ck.flash_attention_varlen_reference(q, k, v, cu, cu, True)
    ref = ck.flash_attention_varlen_bwd_reference(q, k, v, ro, rlse, do, cu,
                                                  cu, True)
    rel = {name: max_err(a, r) / max(float(r.abs().max()), 1e-30)
           for name, a, r in zip(("o", "dq", "dk", "dv"), (out, *grads),
                                 (ro, *ref))}
    out_ = {"phase": "packed_attention_exactness_fp32", "tf32": False,
            "workload": "packed_attention_bf16's lengths and inputs in fp32",
            "max_rel_err": rel, "rel_tol": 1e-4, "launches": launches}
    emit(out_)
    if launches["flash_varlen_fwd"] != 1 or launches["flash_varlen_bwd"] != 1:
        raise AssertionError(f"one forward and backward launched {launches}")
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"packed attention on the card differs from the "
                             f"plain versions: {rel}")


# -- phase 7 ------------------------------------------------------------------
# the vision path: ResNet-50 ImageNet training at batch 256 of 224 x 224
# (benchmarks/matrix.py:71-92) and LeNet at batch 256 of 28 x 28
# (matrix.py:49-68), each with its run_steps K; no hand-written kernel is
# on it (cuDNN convolutions and batch norms, ATen pools)
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES, RESNET_K = 256, 224, 1000, 8
RESNET_EXACT_BATCH = 2
LENET_BATCH, LENET_K = 256, 32


def _image_batches(torch, shape, classes, device="cuda"):
    """``batch(*lead)`` drawing fp32 images uniform in [0, 1) of shape
    lead + ``shape`` and int64 labels in [0, ``classes``) of shape lead +
    shape[:1], from one ``numpy.random.default_rng(0)``, as
    ``benchmarks/matrix.py`` draws them; on ``device``, or as numpy arrays
    with ``device=None``."""
    import numpy as np
    rng = np.random.default_rng(0)

    def batch(*lead):
        x = rng.uniform(0, 1, lead + shape).astype(np.float32)
        y = rng.integers(0, classes, lead + shape[:1]).astype(np.int64)
        if device is None:
            return x, y
        return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

    return batch


def resnet50_training(torch, data_format="NCHW"):
    """ResNet-50 ImageNet training as ``benchmarks/matrix.py:71-92`` runs
    it: ``resnet50(num_classes=1000)`` with fp32 parameters from seed 0,
    ``Momentum(learning_rate=0.1, momentum=0.9)``, ``nn.CrossEntropyLoss``,
    a bf16 O2 ``CompiledTrainStep`` over ``lambda x, y: loss_fn(net(x),
    y)``. Returns (model, step, batch); ``batch(*lead)`` draws images of
    shape lead + (256, 3, 224, 224) and labels on the card.
    ``scripts/profile_torch_train_step.py --workload resnet50`` traces
    this same workload."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(num_classes=RESNET_CLASSES, data_format=data_format,
                     device="cuda", seed=0)
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters())
    loss_fn = CrossEntropyLoss()
    step = CompiledTrainStep(lambda x, y: loss_fn(model(x), y), model, opt,
                             amp_level="O2")
    return model, step, _image_batches(
        torch, (RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE), RESNET_CLASSES)


def flops_per_image(torch, model, shape):
    """Training FLOPs of one image: 3 x the forward's multiply-adds x 2,
    counted from every convolution's and linear layer's shapes on one
    ``shape`` image (the batch norms, pools and adds, under 1%, are left
    out, as MFU counts are)."""
    from paddle_tpu_torch.nn import Conv2D, Linear
    counted = []

    def conv(m, inp, out):
        counted.append(2 * out.numel() * m.weight[0].numel())

    def linear(m, inp, out):
        counted.append(2 * out.numel() * m.weight.shape[0])

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv2D)
                                     else linear)
             for m in model.modules() if isinstance(m, (Conv2D, Linear))]
    was = model.training
    model.eval()
    with torch.no_grad():
        model(torch.zeros((1,) + shape, device="cuda"))
    model.train(was)
    for h in hooks:
        h.remove()
    return 3 * sum(counted)


def _rates(images, step_s, per_image):
    ips = images / step_s
    return {"step_ms": step_s * 1e3, "images_per_s": ips,
            "mfu": ips * per_image / PEAK_BF16_FLOPS}


def _timed_steps(torch, step, x, y, warmup, timed):
    """Losses of ``warmup`` then ``timed`` calls, and the mean seconds of
    the timed ones (host clock, synchronized at both ends)."""
    losses = [step(x, y) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(x, y) for _ in range(timed)]
    torch.cuda.synchronize()
    return [float(v) for v in losses], (time.perf_counter() - t0) / timed


def phase_resnet50_training_bf16(torch, smi):
    """ResNet-50 at batch 256 x 3 x 224 x 224, O2: 3 warm-up and 10 timed
    calls, then one timed ``run_steps`` block of K = 8 (the number
    ``matrix.py`` reports); the same per call channels-last (NHWC), as
    information. Returns the K block (images, labels) on the card and its
    numpy copy for the ``Model.fit`` phase."""
    model, step, _ = resnet50_training(torch)
    shape = (3, RESNET_SIZE, RESNET_SIZE)
    per_image = flops_per_image(torch, model, shape)
    # matrix.py's draw: the K block first; the per-call batch is its first
    block_np = _image_batches(torch, (RESNET_BATCH,) + shape, RESNET_CLASSES,
                              device=None)(RESNET_K)
    xk, yk = (torch.from_numpy(a).cuda() for a in block_np)
    x, y = xk[0], yk[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, per_call_s = _timed_steps(torch, step, x, y, TRAIN_WARMUP,
                                      TRAIN_TIMED)
    t0 = time.perf_counter()
    block = step.run_steps(xk, yk)
    torch.cuda.synchronize()
    run_steps_s = (time.perf_counter() - t0) / RESNET_K
    peak = torch.cuda.max_memory_allocated()
    losses += block.tolist()
    del model, step
    torch.cuda.empty_cache()
    _, nhwc_step, _ = resnet50_training(torch, "NHWC")
    _, nhwc_s = _timed_steps(torch, nhwc_step, x, y, TRAIN_WARMUP,
                             TRAIN_TIMED)
    del nhwc_step
    torch.cuda.empty_cache()
    emit({"phase": "resnet50_training_bf16", "nvidia_smi": smi,
          "model": "resnet50(num_classes=1000), fp32 params, O2 bf16 "
                   "compute, Momentum lr 0.1 momentum 0.9, random weights "
                   "seed 0, uniform images and labels seed 0, NCHW",
          "batch": RESNET_BATCH, "image": list(shape),
          "flops_per_image": per_image, "mfu_peak_flops": PEAK_BF16_FLOPS,
          "per_call": _rates(RESNET_BATCH, per_call_s, per_image),
          f"run_steps_k{RESNET_K}": _rates(RESNET_BATCH, run_steps_s,
                                           per_image),
          "nhwc_per_call": _rates(RESNET_BATCH, nhwc_s, per_image),
          "peak_memory_bytes": peak, "losses": losses})
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"a ResNet-50 loss is not finite: {losses}")
    return xk, yk, block_np


def fit_recorder(torch):
    """A ``Model.fit`` callback keeping every step's loss and each epoch's
    seconds (host clock, synchronized at both ends)."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Recorder(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.epoch_s = [], []

        def on_epoch_begin(self, epoch, logs=None):
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))

        def on_epoch_end(self, epoch, logs=None):
            torch.cuda.synchronize()
            self.epoch_s.append(time.perf_counter() - self._t0)

    return Recorder()


def phase_resnet50_fit_bf16(torch, smi, xk, yk, block_np):
    """ResNet-50 through ``paddle.Model``, the entry point
    ``BASELINE.json`` names: ``prepare(Momentum, CrossEntropyLoss,
    amp_configs="O2")``, then ``fit`` over the K block's 8 x 256 images
    (numpy, on the host: the loader's batches are copied to the card, a
    block of 8 at a time), 2 epochs, ``steps_per_execution=8``; then
    ``evaluate`` with ``Accuracy`` on the first two batches. cuDNN is
    deterministic in this phase, and fit's 16 losses are held to the same
    steps through ``run_steps`` on the card-resident block from the same
    weights within rtol 2e-2 (bf16 losses: a few ulps)."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    torch.backends.cudnn.deterministic = True
    try:
        images = block_np[0].reshape((-1,) + block_np[0].shape[2:])
        labels = block_np[1].reshape(-1)
        net = resnet50(num_classes=RESNET_CLASSES, device="cuda", seed=0)
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=net.parameters())
        model = Model(net).prepare(opt, CrossEntropyLoss(),
                                   amp_configs="O2")
        rec = fit_recorder(torch)
        torch.cuda.reset_peak_memory_stats()
        model.fit(TensorDataset([images, labels]), batch_size=RESNET_BATCH,
                  epochs=2, shuffle=False, steps_per_execution=RESNET_K,
                  verbose=0, callbacks=[rec])
        peak = torch.cuda.max_memory_allocated()
        model.prepare(opt, CrossEntropyLoss(), metrics=Accuracy(),
                      amp_configs="O2")
        two = 2 * RESNET_BATCH
        evaluated = model.evaluate(
            TensorDataset([images[:two], labels[:two]]),
            batch_size=RESNET_BATCH, verbose=0)
        del net, opt, model
        torch.cuda.empty_cache()
        _, step, _ = resnet50_training(torch)
        direct = step.run_steps(xk, yk).tolist() + \
            step.run_steps(xk, yk).tolist()
        del step
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    rel = [abs(a - b) / abs(b) for a, b in zip(rec.losses, direct)]
    epoch_s = rec.epoch_s[1]
    images_per_s = RESNET_K * RESNET_BATCH / epoch_s
    emit({"phase": "resnet50_fit_bf16", "nvidia_smi": smi,
          "entry": "Model(resnet50).prepare(Momentum(0.1, 0.9), "
                   "CrossEntropyLoss(), amp_configs='O2').fit("
                   "TensorDataset([8 x 256 images, labels]), batch_size=256, "
                   "epochs=2, shuffle=False, steps_per_execution=8)",
          "cudnn_deterministic": True,
          "epoch_s": rec.epoch_s,
          "images_per_s_epoch2": images_per_s,
          "step_ms_epoch2": epoch_s / RESNET_K * 1e3,
          "peak_memory_bytes": peak, "fit_losses": rec.losses,
          "run_steps_losses": direct, "max_rel_diff": max(rel),
          "bit_equal_steps": sum(a == b for a, b in zip(rec.losses, direct)),
          "rel_tol": 2e-2, "evaluate": evaluated})
    if len(rec.losses) != 2 * RESNET_K or max(rel) > 2e-2:
        raise AssertionError(f"fit's losses {rec.losses} differ from "
                             f"run_steps' {direct}")
    if not (math.isfinite(evaluated["loss"]) and
            0.0 <= evaluated["acc"] <= 1.0):
        raise AssertionError(f"evaluate gave {evaluated}")


def phase_resnet50_exactness_fp32(torch, ck):
    """Full-depth ResNet-50 (1000 classes) at 2 x 3 x 224 x 224, built
    from seed 0 on the card and on the CPU in fp32 (TF32 off), and on the
    CPU in fp64 as the arbiter: one training forward and backward, then,
    every model given the fp64 model's running statistics, an eval
    forward and backward. Held, card against CPU: the loss within 1e-4,
    both running statistics after the step within 1e-4 of each one's
    largest entry, the eval logits within 1e-4 of their largest entry.
    The gradients are held to fp64: fp32 does not determine them to 1e-4
    of the largest entry here (at random initialization the backward
    through the batch norms' statistics, and in eval mode through
    statistics that one step has barely moved, amplifies each rounding;
    on the CPU, fp32 against fp64: 1.3e-2 of the largest training-mode
    gradient, 8.7e-4 of the largest eval-mode one). So the card's worst
    gradient error against fp64, as a share of the largest fp64 entry,
    must stay within twice the CPU's fp32 error in eval mode and within
    four times in training mode, where the card's cuDNN and ATen kernels
    sum in other orders and the batch statistics amplify each
    difference."""
    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.vision.models import resnet50
    x, y = _image_batches(torch, (RESNET_EXACT_BATCH, 3, RESNET_SIZE,
                                  RESNET_SIZE), RESNET_CLASSES,
                          device=None)()
    loss_fn = CrossEntropyLoss()
    before = {k.name: k.launches for k in ck.KERNELS}
    runs = (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
            ("fp64", "cpu", torch.float64))
    models, out = {}, {}
    for name, dev, dt in runs:
        m = models[name] = resnet50(num_classes=RESNET_CLASSES, device=dev,
                                    seed=0).to(dt)
        xd, yd = torch.from_numpy(x).to(dev, dt), torch.from_numpy(y).to(dev)
        loss = loss_fn(m(xd), yd)
        loss.backward()
        out[name] = {"loss": loss.item(), "train_grads": _grads(m),
                     "stats": {n: b.cpu() for n, b in m.named_buffers()}}
    # eval mode, every model on the fp64 model's statistics: one function
    stats = {n: b.numpy() for n, b in out["fp64"]["stats"].items()}
    for name, dev, dt in runs:
        m = models[name]
        load_jax_state(m, stats | {n: p.detach().cpu().numpy()
                                   for n, p in m.named_parameters()})
        m.eval()
        m.zero_grad(set_to_none=True)
        xd, yd = torch.from_numpy(x).to(dev, dt), torch.from_numpy(y).to(dev)
        logits = m(xd)
        loss_fn(logits, yd).backward()
        out[name].update(logits=logits.detach().cpu(), grads=_grads(m))
    torch.cuda.synchronize()
    launches = {k.name: k.launches - before[k.name] for k in ck.KERNELS}
    card, cpu, ref = out["cuda"], out["cpu"], out["fp64"]
    loss_err = abs(card["loss"] - cpu["loss"])
    stats_rel = max(max_err(card["stats"][n], s) / float(s.abs().max())
                    for n, s in cpu["stats"].items())
    logits_rel = max_err(card["logits"], cpu["logits"]) / \
        float(cpu["logits"].abs().max())

    def against_fp64(key):
        """(worst error of the card's, of the CPU's fp32 gradients
        against fp64, each as a share of the largest fp64 entry; the
        card's worst tensor)."""
        top = max(float(g.abs().max()) for g in ref[key].values())
        errs = {dev: {n: float((g.double() - ref[key][n]).abs().max())
                      for n, g in out[dev][key].items()}
                for dev in ("cuda", "cpu")}
        worst = max(errs["cuda"], key=errs["cuda"].get)
        return (errs["cuda"][worst] / top,
                max(errs["cpu"].values()) / top, worst)

    held = {"eval_grads": (against_fp64("grads"), 2.0),
            "train_grads": (against_fp64("train_grads"), 4.0)}
    emit({"phase": "resnet50_exactness_fp32", "tf32": False,
          "model": "resnet50(num_classes=1000), seed 0, batch 2 x 3 x 224 x "
                   "224; fp32 on the card and the CPU, fp64 on the CPU",
          "loss_cuda": card["loss"], "loss_cpu": cpu["loss"],
          "loss_fp64": ref["loss"], "loss_abs_err": loss_err,
          "loss_tol": 1e-4, "running_stats_max_rel_err": stats_rel,
          "eval_logits_max_rel_err": logits_rel, "rel_tol": 1e-4,
          **{f"{key}_vs_fp64_of_largest": {
              "cuda": c, "cpu_fp32": p, "cuda_worst": w,
              "tol_times_cpu": k}
             for key, ((c, p, w), k) in held.items()},
          "params": len(card["grads"]), "launches": launches})
    if any(launches.values()):
        raise AssertionError(f"the ResNet-50 step launched {launches}")
    if loss_err > 1e-4 or stats_rel > 1e-4 or logits_rel > 1e-4:
        raise AssertionError(
            f"the card's ResNet-50 differs from the CPU's: loss {loss_err}, "
            f"running statistics {stats_rel}, eval logits {logits_rel}")
    for key, ((c, p, w), k) in held.items():
        if c > k * p:
            raise AssertionError(
                f"{key}: the card's {w} is {c} of the largest fp64 entry "
                f"away, more than {k} x the CPU's fp32 {p}")


def phase_lenet_fit(torch, smi):
    """LeNet through ``Model.fit`` as ``matrix.py:49-68`` sizes it: Adam at
    lr 1e-3, batch 256 x 1 x 28 x 28, K = 32 batches a block
    (``steps_per_execution``), O0; 2 epochs over 32 batches, the second
    timed."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet
    images, labels = _image_batches(torch, (LENET_BATCH * LENET_K, 1, 28, 28),
                                    10, device=None)()
    net = LeNet(num_classes=10, device="cuda", seed=0)
    model = Model(net).prepare(Adam(learning_rate=1e-3,
                                    parameters=net.parameters()),
                               CrossEntropyLoss())
    rec = fit_recorder(torch)
    model.fit(TensorDataset([images, labels]), batch_size=LENET_BATCH,
              epochs=2, shuffle=False, steps_per_execution=LENET_K,
              verbose=0, callbacks=[rec])
    epoch_s = rec.epoch_s[1]
    emit({"phase": "lenet_fit", "nvidia_smi": smi,
          "entry": "Model(LeNet()).prepare(Adam(1e-3), CrossEntropyLoss())"
                   ".fit(batch_size=256, epochs=2, steps_per_execution=32)",
          "epoch_s": rec.epoch_s,
          "images_per_s_epoch2": LENET_K * LENET_BATCH / epoch_s,
          "step_ms_epoch2": epoch_s / LENET_K * 1e3,
          "first_and_last_loss": [rec.losses[0], rec.losses[-1]]})
    if len(rec.losses) != 2 * LENET_K or \
            not all(math.isfinite(v) for v in rec.losses):
        raise AssertionError(f"LeNet's fit gave {rec.losses}")


def phase_vision(torch, ck, smi):
    """The vision path's phases, in order."""
    xk, yk, block_np = phase_resnet50_training_bf16(torch, smi)
    phase_resnet50_fit_bf16(torch, smi, xk, yk, block_np)
    del xk, yk, block_np
    torch.cuda.empty_cache()
    phase_resnet50_exactness_fp32(torch, ck)
    phase_lenet_fit(torch, smi)


# -- phase 8 ------------------------------------------------------------------
# -- the checkpoint_resume path -----------------------------------------------
CKPT_STEPS, CKPT_SPLIT = 8, 4


def _route_counts(ck):
    return {k.name: dict(k.route_launches) for k in ck.KERNELS}


def _launch_delta(ck, before, name, route):
    k = next(k for k in ck.KERNELS if k.name == name)
    return k.route_launches[route] - before[name][route]


def _gpt_state(model, opt):
    """Copies of every parameter and every optimizer accumulator, by
    name, on the card."""
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    accs = {f"{n}.{a}": v.detach().clone()
            for n, p in model.named_parameters()
            for a, v in opt._accumulators.get(id(p), {}).items()}
    return params, accs


def _state_diff(torch, got, want):
    """The largest absolute difference between two ``_gpt_state``s (inf
    when their names or dtypes differ)."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.keys() != b.keys():
            return math.inf
        for k in a:
            if a[k].dtype != b[k].dtype:
                return math.inf
            worst = max(worst, (a[k].double() - b[k].double()).abs()
                        .max().item())
    return worst


def _gpt_run(torch, ck, step, opt, sched, ids, labels, lo, hi):
    """Steps ``lo`` to ``hi`` over the fixed batches, the scheduler
    stepped after each: (losses, rates read, K2/K3 bf16 launches)."""
    before = _route_counts(ck)
    losses, lrs = [], []
    for i in range(lo, hi):
        lrs.append(opt.get_lr())
        losses.append(step(ids[i], labels[i]).item())
        sched.step()
    return losses, lrs, {n: _launch_delta(ck, before, n, "bf16")
                         for n in ("flash_fwd", "flash_bwd")}


def _synced(torch, fn):
    """(fn(), seconds on the host clock between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _dir_bytes(*paths):
    import os
    return sum(os.path.getsize(p) for p in paths)


def phase_checkpoint_gpt(torch, ck, smi, tmp):
    """(a) and (b) of the checkpoint path: GPT-124M as
    ``gpt124m_scheduled`` builds it (the nan check off), 8 uninterrupted
    steps (run A, twice: the reruns must agree bit for bit, or their
    difference becomes the gate), then 4 steps, ``paddle.save`` of the
    model's and the optimizer's state, a build from seed 1,
    ``paddle.load`` into both, a new ``CompiledTrainStep`` and 4 more
    steps: steps 5 to 8, the rates, every parameter and every AdamW
    moment must equal run A's. The same resume through
    ``distributed.checkpoint``: a synchronous checkpoint at step 2, an
    asynchronous one at step 4 taken while step 5 runs (its files must
    hold step 4's values), ``mark_complete``, ``latest_checkpoint``; then
    a flipped byte in the step-4 shard must fail the load and send
    ``latest_checkpoint`` back to step 2. K2 and K3 launch 12 times a step
    on the bf16 route throughout."""
    import os

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.distributed import elastic
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.text.gpt import gpt_small
    cfg = gpt_small()
    layers = cfg.num_layers
    shape = (TRAIN_BATCH, cfg.max_seq_len)
    ids, labels = _token_batches(torch, cfg.vocab_size, shape, shape,
                                 cfg.vocab_size)(CKPT_STEPS)
    launches = []

    def build(seed):
        model, opt, sched, step, _ = gpt124m_scheduled(torch, seed=seed,
                                                       check_nan=False)
        return model, opt, sched, step

    def run(parts, lo, hi):
        model, opt, sched, step = parts
        losses, lrs, n = _gpt_run(torch, ck, step, opt, sched, ids, labels,
                                  lo, hi)
        launches.append((hi - lo, n))
        return losses, lrs

    def uninterrupted():
        parts = build(0)
        losses, lrs = run(parts, 0, CKPT_STEPS)
        state = _gpt_state(parts[0], parts[1])
        del parts
        torch.cuda.empty_cache()
        return losses, lrs, state

    a_losses, a_lrs, a_state = uninterrupted()
    r_losses, r_lrs, r_state = uninterrupted()
    rerun_diff = max(_state_diff(torch, r_state, a_state),
                     max(abs(x - y) for x, y in zip(r_losses, a_losses)))
    del r_state

    ckdir = os.path.join(tmp, "elastic")
    p = os.path.join(tmp, "gpt124m")
    parts = build(0)
    b_losses, b_lrs = run(parts, 0, 2)
    model, opt = parts[0], parts[1]
    step2 = elastic.checkpoint_path(2, ckdir)
    _, sync_s = _synced(torch, lambda: dck.save_state_dict(
        {"model": model.state_dict(), "opt": opt.state_dict()}, step2))
    elastic.mark_complete(step2)
    more = run(parts, 2, CKPT_SPLIT)
    b_losses += more[0]
    b_lrs += more[1]
    _, save_s = _synced(torch, lambda: (
        paddle.save(model.state_dict(), p + ".pdparams"),
        paddle.save(opt.state_dict(), p + ".pdopt")))
    nbytes = _dir_bytes(p + ".pdparams", p + ".pdopt")
    step4 = elastic.checkpoint_path(CKPT_SPLIT, ckdir)
    t0 = time.perf_counter()
    handle = dck.save_state_dict(
        {"model": model.state_dict(), "opt": opt.state_dict()}, step4,
        async_save=True)
    blocked_s = time.perf_counter() - t0
    # one more step while the files are written: they must hold step 4
    b5 = run(parts, CKPT_SPLIT, CKPT_SPLIT + 1)[0]
    handle.wait(timeout=600)
    async_s = time.perf_counter() - t0
    elastic.mark_complete(step4)
    del parts, model, opt, handle
    torch.cuda.empty_cache()

    def resumed(load):
        parts = build(1)
        model, opt, sched, step = parts
        (missing, unexpected), load_s = _synced(torch, lambda: load(model,
                                                                    opt))
        if missing or unexpected:
            raise AssertionError(f"the load missed {missing}, found "
                                 f"{unexpected}")
        if opt._step_count != CKPT_SPLIT or sched.last_epoch != CKPT_SPLIT:
            raise AssertionError(
                f"the optimizer resumed at step {opt._step_count}, the "
                f"scheduler at {sched.last_epoch}")
        step = CompiledTrainStep(step.fn, model, opt, amp_level="O2")
        losses, lrs = run((model, opt, sched, step), CKPT_SPLIT, CKPT_STEPS)
        state = _gpt_state(model, opt)
        del parts, model, opt, sched, step
        torch.cuda.empty_cache()
        return losses, lrs, state, load_s

    def load_files(model, opt):
        got = model.set_state_dict(paddle.load(p + ".pdparams"))
        opt.set_state_dict(paddle.load(p + ".pdopt"))
        return got

    found = elastic.latest_checkpoint(ckdir)

    def load_dck(model, opt):
        for q in model.parameters():   # the skeleton's accumulators
            opt._get_accumulators(q)
        skeleton = {"model": model.state_dict(), "opt": opt.state_dict()}
        dck.load_state_dict(skeleton, found)
        opt.set_state_dict(skeleton["opt"])
        return [], []

    results = {"paddle_save": resumed(load_files),
               "distributed_checkpoint": resumed(load_dck)}
    # a flipped byte: the load refuses, latest_checkpoint falls back
    shard = os.path.join(step4, "shard_0.pkl")
    with open(shard, "r+b") as f:
        f.seek(os.path.getsize(shard) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    try:
        dck.load_state_dict({}, step4)
    except ValueError as e:
        corrupt_refused = "corrupt" in str(e)
    else:
        corrupt_refused = False
    fallback = elastic.latest_checkpoint(ckdir)

    out = {"phase": "checkpoint_resume_gpt124m", "nvidia_smi": smi,
           "model": "gpt_small (GPT-124M), CompiledTrainStep O2 bf16, AdamW "
                    "under CosineAnnealingDecay(3e-4, 14), "
                    "ClipGradByGlobalNorm(1.0), seed 0; resumed into a seed-1 "
                    "build", "dropout": 0.0,
           "steps": CKPT_STEPS, "resume_at": CKPT_SPLIT,
           "run_a_losses": a_losses, "run_a_lrs": a_lrs,
           "rerun_bit_equal": rerun_diff == 0.0, "rerun_max_diff": rerun_diff,
           "interrupted_losses_1_to_5": b_losses + b5,
           "checkpoint_bytes": nbytes, "paddle_save_s": save_s,
           "paddle_save_gb_per_s": nbytes / save_s / 1e9,
           "dck_sync_save_s": sync_s, "dck_async_blocked_s": blocked_s,
           "dck_async_write_s": async_s,
           "dck_shard_bytes": _dir_bytes(shard),
           "latest_checkpoint": found, "corrupt_load_refused":
               corrupt_refused, "fallback_checkpoint": fallback,
           "launches_bf16_per_step": [
               {"steps": n, **c} for n, c in launches]}
    failures = []
    for name, (losses, lrs, state, load_s) in results.items():
        diff = max(_state_diff(torch, state, a_state),
                   max(abs(x - y) for x, y in
                       zip(losses, a_losses[CKPT_SPLIT:])))
        out[name] = {"losses_5_to_8": losses, "lrs": lrs, "load_s": load_s,
                     "load_gb_per_s": nbytes / load_s / 1e9,
                     "max_diff_to_run_a": diff}
        if diff > rerun_diff or lrs != a_lrs[CKPT_SPLIT:]:
            failures.append(f"{name}: resumed steps differ from run A by "
                            f"{diff} (reruns: {rerun_diff})")
    emit(out)
    if b_losses + b5 != a_losses[:CKPT_SPLIT + 1] and rerun_diff == 0.0:
        failures.append("the interrupted run's first five losses differ "
                        "from run A's (the async save changed step 5?)")
    if found != step4 or not corrupt_refused or fallback != step2:
        failures.append(f"latest_checkpoint {found}, corrupt load refused "
                        f"{corrupt_refused}, fallback {fallback}")
    bad = [(n, c) for n, c in launches
           if c != {"flash_fwd": layers * n, "flash_bwd": layers * n}]
    if bad:
        failures.append(f"K2/K3 bf16 launches, not 12 a step: {bad}")
    if failures:
        raise AssertionError("; ".join(failures))


class _WorkerCudaCheck:
    """A DataLoader ``worker_init_fn`` (picklable: module level) noting in
    ``mark_dir`` whether CUDA was initialized in the worker, and failing
    the worker when it was."""

    def __init__(self, mark_dir):
        self.mark_dir = mark_dir

    def __call__(self, wid):
        import os

        import torch
        inited = torch.cuda.is_initialized()
        with open(os.path.join(self.mark_dir,
                               f"worker_{wid}_{os.getpid()}"), "w") as f:
            f.write(str(inited))
        if inited:
            raise RuntimeError(f"DataLoader worker {wid} initialized CUDA")


def phase_checkpoint_resnet50_fit(torch, smi, tmp):
    """(c) of the checkpoint path: ResNet-50 through ``Model.fit`` on
    ``phase_resnet50_fit_bf16``'s input (8 x 256 images, O2, Momentum,
    ``steps_per_execution=8``, cuDNN deterministic): 2 epochs with no
    workers; then 1 epoch with 2 worker processes and
    ``ModelCheckpoint``, which must write ``0`` and ``final``; a seed-1
    model ``load``s ``final`` and trains 1 more epoch with 2 workers. Its
    8 losses must equal the uninterrupted run's second epoch bit for bit
    (the same batches in the same order, the same state). Every worker
    notes that CUDA was not initialized in it."""
    import os

    import numpy as np

    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import ModelCheckpoint
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    class FirstBatchTimed(DataLoader):
        """Notes the seconds from the start of each pass to its first
        batch."""
        first_batch_s = None

        def __iter__(self):
            t0 = time.perf_counter()
            it = super().__iter__()
            for i, batch in enumerate(it):
                if i == 0:
                    self.first_batch_s = time.perf_counter() - t0
                yield batch

    block = _image_batches(torch, (RESNET_BATCH, 3, RESNET_SIZE,
                                   RESNET_SIZE), RESNET_CLASSES,
                           device=None)(RESNET_K)
    ds = TensorDataset([block[0].reshape((-1,) + block[0].shape[2:]),
                        block[1].reshape(-1)])
    marks = os.path.join(tmp, "worker_marks")
    os.makedirs(marks)
    save_dir = os.path.join(tmp, "resnet50_ckpt")

    def model_of(seed):
        net = resnet50(num_classes=RESNET_CLASSES, device="cuda", seed=seed)
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=net.parameters())
        return Model(net).prepare(opt, CrossEntropyLoss(), amp_configs="O2")

    def fit(model, workers, epochs, callbacks=()):
        loader = FirstBatchTimed(
            ds, batch_size=RESNET_BATCH, shuffle=False, num_workers=workers,
            worker_init_fn=_WorkerCudaCheck(marks) if workers else None,
            timeout=120)
        rec = fit_recorder(torch)
        model.fit(loader, epochs=epochs, verbose=0,
                  steps_per_execution=RESNET_K,
                  callbacks=[rec, *callbacks])
        return rec, loader

    torch.backends.cudnn.deterministic = True
    try:
        straight, l0 = fit(model_of(0), 0, 2)
        torch.cuda.empty_cache()
        first, _ = fit(model_of(0), 2, 1,
                       [ModelCheckpoint(save_dir=save_dir)])
        files = sorted(os.listdir(save_dir))
        torch.cuda.empty_cache()
        resumed_model = model_of(1)
        _, load_s = _synced(torch, lambda: resumed_model.load(
            os.path.join(save_dir, "final")))
        second, l2 = fit(resumed_model, 2, 1)
        del resumed_model
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    worker_marks = {}
    for name in os.listdir(marks):
        with open(os.path.join(marks, name)) as f:
            worker_marks[name] = f.read()
    images = RESNET_K * RESNET_BATCH
    out = {"phase": "checkpoint_resume_resnet50_fit", "nvidia_smi": smi,
           "entry": "Model(resnet50).prepare(Momentum(0.1, 0.9), "
                    "CrossEntropyLoss(), amp_configs='O2').fit(DataLoader("
                    "TensorDataset(8 x 256 images), batch_size=256, "
                    "num_workers=0 or 2), steps_per_execution=8); "
                    "ModelCheckpoint; Model.load",
           "cudnn_deterministic": True,
           "uninterrupted_losses": straight.losses,
           "interrupted_epoch1_losses": first.losses,
           "resumed_epoch2_losses": second.losses,
           "checkpoint_files": files, "model_load_s": load_s,
           "epoch2_s_workers0": straight.epoch_s[1],
           "epoch2_s_workers2": second.epoch_s[0],
           "images_per_s_epoch2_workers0": images / straight.epoch_s[1],
           "images_per_s_epoch2_workers2": images / second.epoch_s[0],
           "first_batch_s_workers0": l0.first_batch_s,
           "first_batch_s_workers2": l2.first_batch_s,
           "worker_start_s": l2.worker_start_s,
           "images_per_s_epoch2_workers2_after_first_batch":
               images / (second.epoch_s[0] - l2.first_batch_s),
           "worker_cuda_initialized": worker_marks}
    emit(out)
    want_files = ["0.pdopt", "0.pdparams", "final.pdopt", "final.pdparams"]
    if files != want_files:
        raise AssertionError(f"ModelCheckpoint wrote {files}")
    if len(straight.losses) != 2 * RESNET_K or \
            first.losses != straight.losses[:RESNET_K] or \
            second.losses != straight.losses[RESNET_K:]:
        raise AssertionError(
            f"the resumed losses {first.losses} + {second.losses} differ "
            f"from the uninterrupted {straight.losses}")
    if len(worker_marks) != 4 or set(worker_marks.values()) != {"False"}:
        raise AssertionError(f"worker CUDA marks: {worker_marks}")


def phase_checkpoint_resume(torch, ck, smi):
    """The checkpoint path: (a) and (b) on GPT-124M, (c) on ResNet-50,
    their files under one temporary directory, removed at the end."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        phase_checkpoint_gpt(torch, ck, smi, tmp)
        phase_checkpoint_resnet50_fit(torch, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- the data-parallel path ----------------------------------------------------
# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# device); a separate rank of one proves the NCCL backend on the card. The
# ranks are this script started by the port's launcher with a rank flag.
# (DP_RANKS, DP_BATCH and DP_EXACT_BATCH stand beside FLASH_CASES)
DP_WARMUP, DP_TIMED = 1, 2
DP_RESNET_BATCH, DP_RESNET_STEPS, DP_RESNET_EVAL = 64, 4, 128
DP_BN_SHAPE = (2 * DP_RESNET_BATCH, 64, 112, 112)   # ResNet-50's first bn
DP_RANK_TIMEOUT_S = 600


def _digest(tensors):
    """sha256 over the bytes of ``tensors`` (bit-equality across ranks)."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().reshape(-1).view(torch.uint8)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _state_tensors(model):
    return list(model.parameters()) + list(model.buffers())


def _same_on_ranks(dist, what, digest):
    seen = []
    dist.all_gather_object(seen, digest)
    if len(set(seen)) != 1:
        raise AssertionError(f"{what}: the ranks differ ({seen})")


def _rank_emit(rank, obj):
    emit(dict(obj, rank=rank))


_TORCH_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
    "reduce", "scatter", "gather", "reduce_scatter", "reduce_scatter_tensor",
    "reduce_scatter_single", "all_to_all", "all_to_all_single",
    "all_gather_object", "broadcast_object_list", "scatter_object_list",
    "barrier")


def _count_backend_calls(tdist):
    """Wrap ``torch.distributed``'s collectives so each call adds one to
    the returned dict's ``n``: a port collective that reached the backend
    raised it."""
    seen = {"n": 0}

    def counted(fn):
        def call(*args, **kwargs):
            seen["n"] += 1
            return fn(*args, **kwargs)
        return call

    for name in _TORCH_COLLECTIVES:
        if hasattr(tdist, name):
            setattr(tdist, name, counted(getattr(tdist, name)))
    return seen


def nccl_world_one_rank(torch):
    """One rank under ``init_parallel_env()`` with its default backend,
    which must be NCCL on the card; each collective on CUDA tensors, and
    each must reach the NCCL process group (a world of one is no
    identity: it runs its collectives through the backend)."""
    import torch.distributed as tdist

    import paddle_tpu_torch.distributed as dist
    env = dist.init_parallel_env()
    backend = dist.get_backend()
    if backend != "nccl" or env.world_size != 1:
        raise AssertionError(f"backend {backend}, world {env.world_size}")
    seen = _count_backend_calls(tdist)
    x = torch.arange(1.0, 7.0, device="cuda")
    checks = {}

    def check(name, run, ok):
        before = seen["n"]
        got = run()
        checks[name] = bool(ok(got)) and seen["n"] > before

    def reduced(op):
        t = x.clone()
        dist.all_reduce(t, op)
        return t

    for name, op in (("sum", dist.ReduceOp.SUM), ("max", dist.ReduceOp.MAX),
                     ("min", dist.ReduceOp.MIN), ("prod", dist.ReduceOp.PROD),
                     ("avg", dist.ReduceOp.AVG)):
        check(f"all_reduce_{name}", lambda op=op: reduced(op),
              lambda t: torch.equal(t, x))

    def gathered():
        rows = []
        dist.all_gather(rows, x)
        return rows

    check("all_gather", gathered,
          lambda rows: len(rows) == 1 and torch.equal(rows[0], x))

    def into(fn, start):
        def go():
            t = start()
            fn(t)
            return t
        return go

    copy, zeros = x.clone, (lambda: torch.zeros_like(x))
    for name, fn, start in (
            ("broadcast", lambda t: dist.broadcast(t, 0), copy),
            ("reduce", lambda t: dist.reduce(t, 0, dist.ReduceOp.SUM), copy),
            ("scatter", lambda t: dist.scatter(t, [x], src=0), zeros),
            ("reduce_scatter", lambda t: dist.reduce_scatter(t, [x]), zeros),
            ("alltoall_single", lambda t: dist.alltoall_single(t, x),
             zeros)):
        check(name, into(fn, start), lambda t: torch.equal(t, x))

    def alltoall():
        got = []
        dist.alltoall(got, [x])
        return got

    check("alltoall", alltoall, lambda got: torch.equal(got[0], x))

    def gathered_objects():
        objs = []
        dist.all_gather_object(objs, {"rank": 0})
        return objs

    check("all_gather_object", gathered_objects,
          lambda objs: objs == [{"rank": 0}])
    check("barrier", dist.barrier, lambda _: True)
    torch.cuda.synchronize()
    emit({"phase": "nccl_world_one", "backend": backend,
          "device": str(env.device), "backend_calls": seen["n"],
          "checks": checks})
    dist.destroy_process_group()
    if not all(checks.values()):
        raise AssertionError(f"NCCL world-1 collectives: {checks}")


def _gloo_cuda_ops(torch, dist, rank):
    """Which collectives this torch's gloo takes on CUDA tensors: every
    rank tries each, in one order; a refusal is recorded with its message
    (the port names the op and the backend)."""
    x = torch.full((4,), float(rank + 1), device="cuda")
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather([], x),
        "all_gather_object": lambda: dist.all_gather_object([], rank),
        "reduce": lambda: dist.reduce(x.clone(), 0),
        "scatter": lambda: dist.scatter(x.clone(), [x, x] if rank == 0
                                        else None, src=0),
        "reduce_scatter": lambda: dist.reduce_scatter(
            x[:2].clone(), [x[:2], x[2:]]),
        "alltoall_single": lambda: dist.alltoall_single(x.clone(), x),
        "barrier": lambda: dist.barrier(),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as e:
            out[name] = str(e).splitlines()[0][:200]
    return out


def dp_gpt124m_rank(torch, ck, dist, rank, world):
    """GPT-124M at bench.py's widths, ``gpt124m_fp16_amp``'s eager recipe
    with the model wrapped in ``paddle.DataParallel``, batch 8 x 1024 a
    rank from a ``DistributedBatchSampler`` over one seeded token set.
    Rank 1 starts from perturbed weights; the wrap must make them equal,
    and every step must end with bit-equal parameters and K2/K3 launched
    once per layer on each rank."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.distributed import comm_plane
    from paddle_tpu_torch.io import (DataLoader, DistributedBatchSampler,
                                     TensorDataset)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    if rank == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1e-2)
    sched = amp_schedule(popt.lr)
    opt = popt.AdamW(learning_rate=sched, parameters=model.parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    perturbed = _digest(model.parameters())
    dp = paddle.DataParallel(model)
    wrapped = _digest(model.parameters())
    _same_on_ranks(dist, "parameters after the wrap", wrapped)
    steps = DP_WARMUP + DP_TIMED
    seq = cfg.max_seq_len
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (world * DP_BATCH * steps,
                                            seq + 1)))
    data = TensorDataset([tokens[:, :-1], tokens[:, 1:]])
    sampler = DistributedBatchSampler(data, DP_BATCH)
    loader = DataLoader(data, batch_sampler=sampler)
    layers = cfg.num_layers
    plane = comm_plane.get_plane()
    rows = []
    torch.cuda.reset_peak_memory_stats()
    for i, (ids, labels) in enumerate(loader):
        if i == DP_WARMUP:
            plane.reset_stats()
        ids, labels = ids.to("cuda"), labels.to("cuda")
        before = {k.name: dict(k.route_launches) for k in ck.KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scale = scaler._scale
        with amp.auto_cast(level="O2", dtype="float16"):
            _, loss = dp(ids, labels=labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        sched.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fp16 = {n: k.route_launches["fp16"] - before[k.name]["fp16"]
                for n, k in ((k.name, k) for k in ck.KERNELS)}
        if fp16["flash_fwd"] != layers or fp16["flash_bwd"] != layers:
            raise AssertionError(f"step {i} launched {fp16} on fp16")
        _same_on_ranks(dist, f"parameters after step {i}",
                       _digest(model.parameters()))
        rows.append({"loss": loss.item(), "scale": scale, "s": dt,
                     "skipped": scaler._scale < scale})
    if len(rows) != steps:
        raise AssertionError(f"the sampler gave {len(rows)} batches")
    bad = [i for i, r in enumerate(rows)
           if not r["skipped"] and not math.isfinite(r["loss"])]
    if bad:
        raise AssertionError(f"non-finite loss on kept steps {bad}")
    stats = plane.stats()
    timed = [r["s"] for r in rows[DP_WARMUP:]]
    step_s = sum(timed) / len(timed)
    slab = sum(b.nelem for b in dp._buckets) * 4
    # the step's two parts apart, in this run: a step with no gradient
    # sync (under no_sync: no bucket launches; the ranks' weights part
    # after it, which nothing reads), and the buckets' AVG all-reduce alone
    # (slabs of the same sizes, launched back to back and drained)
    local_s, allreduce_s = [], []
    slabs = [torch.zeros(b.nelem, device="cuda") for b in dp._buckets]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dp.no_sync():
            with amp.auto_cast(level="O2", dtype="float16"):
                _, loss = dp(ids, labels=labels)
            scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        torch.cuda.synchronize()
        local_s.append(time.perf_counter() - t0)
        dist.barrier()
        t0 = time.perf_counter()
        for flat in slabs:
            dist.all_reduce(flat, dist.ReduceOp.AVG, sync_op=False)
        comm_plane.drain()
        torch.cuda.synchronize()
        allreduce_s.append(time.perf_counter() - t0)
    if dp._bucket_launch_count != steps * len(dp._buckets):
        raise AssertionError("a no_sync step launched a bucket")
    out = {"phase": "data_parallel_gpt124m", "world": world,
           "backend": dist.get_backend(),
           "batch_per_rank": [DP_BATCH, seq],
           "step_ms": step_s * 1e3, "step_ms_each": [r["s"] * 1e3
                                                     for r in rows],
           "rank_tokens_per_s": DP_BATCH * seq / step_s,
           "losses": [r["loss"] for r in rows],
           "scale": [r["scale"] for r in rows],
           "skipped_steps": [i for i, r in enumerate(rows) if r["skipped"]],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "comm_plane": stats, "buckets": len(dp._buckets),
           "local_step_ms_each": [t * 1e3 for t in local_s],
           "allreduce_alone_ms_each": [t * 1e3 for t in allreduce_s],
           "allreduced_bytes_per_step": slab,
           "wrap_changed_weights": perturbed != wrapped,
           "bucket_launches": dp._bucket_launch_count,
           "syncs": dp._sync_count}
    if (perturbed != wrapped) != (rank == 1):
        raise AssertionError("the wrap-time broadcast left rank 1's "
                             "perturbed weights")
    del dp, model, opt, scaler, slabs
    torch.cuda.empty_cache()
    return out


def dp_exactness_rank(torch, dist, rank, out_dir):
    """GPT-124M's widths, 2 layers, fp32: one AdamW step under
    DataParallel on this rank's 2 x 1024 tokens, held piece by piece
    (``_held_pieces``; rank 0 prints the row) to the parent's one-process
    step on the two ranks' batches concatenated (``dp_one.pt``); then
    ``no_sync``: two micro-steps under it and one outside, each bucket
    launched once."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12)
    ids, labels = _seeded_ids(torch, cfg.vocab_size,
                              (DP_EXACT_BATCH, cfg.max_seq_len),
                              seed=10 + rank)
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    dp = paddle.DataParallel(model)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    loss = dp(ids.cuda(), labels=labels.cuda())[1]
    loss.backward()
    named = list(model.named_parameters())
    grads = [p.grad.detach().clone() for _, p in named]
    opt.step()
    losses = []
    dist.all_gather_object(losses, loss.item())
    _same_on_ranks(dist, "fp32 parameters after the step",
                   _digest(model.parameters()))
    held = _held_pieces(torch, dist, sum(losses) / len(losses), named,
                        grads, torch.load(f"{out_dir}/dp_one.pt",
                                          mmap=True))
    held.update(phase="data_parallel_exactness_fp32", tf32=False,
                losses=losses,
                model="GPT-124M widths, 2 layers, fp32, AdamW lr 1e-4; "
                      "2 ranks x 2 x 1024 under DataParallel against one "
                      "process on 4 x 1024")
    if rank == 0:
        _rank_emit(rank, held)
    del grads
    opt.clear_grad()
    launches, syncs = dp._bucket_launch_count, dp._sync_count
    with dp.no_sync():
        for _ in range(2):
            dp(ids.cuda(), labels=labels.cuda())[1].backward()
    under = dp._bucket_launch_count - launches
    dp(ids.cuda(), labels=labels.cuda())[1].backward()
    out = {"phase": "data_parallel_no_sync", "buckets": len(dp._buckets),
           "launches_under_no_sync": under,
           "launches_after": dp._bucket_launch_count - launches,
           "syncs": dp._sync_count - syncs}
    _same_on_ranks(dist, "gradients after no_sync",
                   _digest(p.grad for p in model.parameters()
                           if p.grad is not None))
    if under or out["launches_after"] != len(dp._buckets) or \
            out["syncs"] != 1:
        raise AssertionError(f"no_sync: {out}")
    del dp, model, opt
    torch.cuda.empty_cache()
    return out


def dp_resnet50_fit_rank(torch, dist, rank, world):
    """``resnet50_training``'s model at O2, NCHW, after
    ``SyncBatchNorm.convert_sync_batchnorm``, through ``Model.fit``: one
    epoch of 4 batches of 64 images a rank from the same seeded set, then
    ``evaluate`` with ``Accuracy`` on 128 more images (every rank the whole
    set). Parameters and running statistics must end bit-equal, and the
    metrics equal on every rank."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss, SyncBatchNorm
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    net = resnet50(num_classes=RESNET_CLASSES, device="cuda", seed=0)
    net = SyncBatchNorm.convert_sync_batchnorm(net)
    n_sync = sum(isinstance(m, SyncBatchNorm) for m in net.modules())
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=net.parameters())
    model = Model(net).prepare(opt, CrossEntropyLoss(), metrics=Accuracy(),
                               amp_configs="O2")
    shape = (3, RESNET_SIZE, RESNET_SIZE)
    batch = _image_batches(torch, (DP_RESNET_EVAL,) + shape, RESNET_CLASSES,
                           device=None)
    images, labels = batch(world * DP_RESNET_STEPS * DP_RESNET_BATCH
                           // DP_RESNET_EVAL)
    images, labels = images.reshape((-1,) + shape), labels.reshape(-1)
    ev_images, ev_labels = batch()
    rec = fit_recorder(torch)
    torch.cuda.reset_peak_memory_stats()
    model.fit(TensorDataset([images, labels]), batch_size=DP_RESNET_BATCH,
              epochs=1, shuffle=False, verbose=0, callbacks=[rec])
    peak = torch.cuda.max_memory_allocated()
    _same_on_ranks(dist, "ResNet-50 parameters and statistics after fit",
                   _digest(_state_tensors(net)))
    evaluated = model.evaluate(TensorDataset([ev_images, ev_labels]),
                               batch_size=DP_RESNET_BATCH, verbose=0)
    _same_on_ranks(dist, "evaluate's metrics", repr(evaluated))
    out = {"phase": "data_parallel_resnet50_fit", "sync_batch_norms": n_sync,
           "images_per_rank": DP_RESNET_STEPS * DP_RESNET_BATCH,
           "losses": rec.losses, "epoch_s": rec.epoch_s,
           "rank_images_per_s": DP_RESNET_STEPS * DP_RESNET_BATCH
           / rec.epoch_s[0], "peak_memory_bytes": peak,
           "evaluate": evaluated}
    if len(rec.losses) != DP_RESNET_STEPS or \
            not all(math.isfinite(x) for x in rec.losses):
        raise AssertionError(f"fit's losses: {rec.losses}")
    del net, opt, model
    torch.cuda.empty_cache()
    return out


def dp_sync_batch_norm_rank(torch, dist, rank):
    """``SyncBatchNorm`` in fp32 at ResNet-50's first batch norm, each
    rank half of a [128, 64, 112, 112] batch, against ``BatchNorm2D`` on
    the whole batch in this process and against fp64: y, dx, dγ and dβ
    (the ranks' local dγ, dβ summed), each within 1e-5 of its largest
    fp64 entry or twice ``BatchNorm2D``'s own fp32 error where that is
    larger (fp32 does not determine all of the backward's digits); the
    running statistics within 1e-6 of BatchNorm2D's."""
    from paddle_tpu_torch.nn import BatchNorm2D, SyncBatchNorm
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(DP_BN_SHAPE, generator=gen, device="cuda") + 0.5
    dy = torch.randn(DP_BN_SHAPE, generator=gen, device="cuda")
    c = DP_BN_SHAPE[1]
    w = torch.rand(c, generator=gen, device="cuda") + 0.5
    b = torch.randn(c, generator=gen, device="cuda")
    half = slice(rank * DP_RESNET_BATCH, (rank + 1) * DP_RESNET_BATCH)

    def run(layer, xin, dyin):
        with torch.no_grad():
            layer.weight.copy_(w)
            layer.bias.copy_(b)
        xin = xin.clone().requires_grad_(True)
        y = layer(xin)
        (y * dyin).sum().backward()
        return (y.detach(), xin.grad, layer.weight.grad.clone(),
                layer.bias.grad.clone(), layer._mean, layer._variance)

    sync = run(SyncBatchNorm(c, device="cuda"), x[half], dy[half])
    dist.all_reduce(sync[2])
    dist.all_reduce(sync[3])
    full = run(BatchNorm2D(c, device="cuda"), x, dy)
    x64 = x.double().requires_grad_(True)
    w64 = w.double().requires_grad_(True)
    b64 = b.double().requires_grad_(True)
    y64 = torch.nn.functional.batch_norm(x64, None, None, w64, b64,
                                         training=True, eps=1e-5)
    (y64 * dy.double()).sum().backward()
    exact = (y64.detach()[half], x64.grad[half], w64.grad, b64.grad)
    full_half = (full[0][half], full[1][half], full[2], full[3])
    names = ("y", "dx", "dw", "db")
    err, bound = {}, {}
    for n, got, ref32, ref in zip(names, sync, full_half, exact):
        top = float(ref.abs().max())
        err[n] = float((got.double() - ref).abs().max()) / top
        aten = float((ref32.double() - ref).abs().max()) / top
        bound[n] = max(1e-5, 2 * aten)
    stats = max(float((sync[4] - full[4]).abs().max()),
                float((sync[5] - full[5]).abs().max()))
    out = {"phase": "data_parallel_sync_batch_norm_fp32",
           "shape": list(DP_BN_SHAPE), "tf32": False,
           "rel_err_vs_fp64": err, "bound": bound,
           "running_stats_abs_err": stats, "running_stats_tol": 1e-6}
    if any(err[n] > bound[n] for n in names) or stats > 1e-6:
        raise AssertionError(f"sync batch norm: {out}")
    return out


def data_parallel_rank(torch, out_dir):
    """One rank of the data-parallel path (started by the launcher): the
    GPT-124M steps, the fp32 step and no_sync, ResNet-50's fit, the sync
    batch norm against one process, then the gloo op record. Prints one
    JSON line per phase and last its launches by route."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env(timeout=DP_RANK_TIMEOUT_S)
    _wait_ready(out_dir)
    rank, world = env.rank, env.world_size
    if dist.get_backend() != "gloo" or world != DP_RANKS:
        raise AssertionError(f"backend {dist.get_backend()}, world {world}")
    ck.reset_launch_counts()
    for phase in (lambda: dp_gpt124m_rank(torch, ck, dist, rank, world),
                  lambda: dp_exactness_rank(torch, dist, rank, out_dir),
                  lambda: dp_resnet50_fit_rank(torch, dist, rank, world),
                  lambda: dp_sync_batch_norm_rank(torch, dist, rank)):
        _rank_emit(rank, phase())
    _rank_emit(rank, {"phase": "gloo_cuda_ops",
                      "ops": _gloo_cuda_ops(torch, dist, rank)})
    _rank_emit(rank, {"rank_launches": {k.name: dict(k.route_launches)
                                        for k in ck.KERNELS}})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _wait_ready(out_dir, timeout=DP_RANK_TIMEOUT_S):
    """Block a rank until the parent's ``ready`` marker is in ``out_dir``
    (``_start_ranks``: what ``prepare`` writes is there)."""
    t0 = time.monotonic()
    while not os.path.exists(os.path.join(out_dir, "ready")):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no ready marker in {out_dir}")
        time.sleep(0.05)


def _run_ranks(n, flag, out_dir, extra_env=None, prepare=None):
    """This script's ``flag`` mode on ``n`` ranks through the port's
    launcher (``prepare()`` runs here while they start); returns each
    rank's JSON lines. A rank that fails, times out or prints no launch
    record fails the path."""
    return _rank_lines(flag, *_start_ranks(n, flag, out_dir, extra_env,
                                           prepare=prepare))


def _rank_lines(flag, rc, stderr, logs):
    """Each rank's JSON lines of a finished launch, or the failure."""
    if rc != 0:
        tails = {r: text[-4000:] for r, text in logs.items()}
        raise AssertionError(f"{flag} ranks failed (rc {rc}): "
                             f"{stderr[-2000:]} {tails}")
    lines = {r: [json.loads(line) for line in text.splitlines()
                 if line.startswith("{")] for r, text in logs.items()}
    for r, rows in lines.items():
        if not rows or "rank_launches" not in rows[-1]:
            raise AssertionError(f"{flag} rank {r} printed no result")
    return lines


def _start_ranks(n, flag, out_dir, extra_env=None,
                 timeout=DP_RANK_TIMEOUT_S, prepare=None):
    """Run this script's ``flag`` mode on ``n`` ranks through the port's
    launcher: (return code, the launcher's stderr, {rank: its log}); a
    launcher still running after ``timeout`` seconds is killed (return
    code None). ``prepare()`` (the one-process steps the ranks' gates are
    held to) runs in this process while the ranks start; then the
    ``ready`` marker in ``out_dir`` lets them past ``_wait_ready``. The
    launcher and its ranks run in a session of their own, killed whole if
    they outlive the timeout or this process fails while waiting."""
    ready = os.path.join(out_dir, "ready")
    if os.path.exists(ready):
        os.remove(ready)
    proc = _spawn_ranks(n, flag, out_dir, extra_env)
    try:
        if prepare is not None:
            prepare()
        open(ready, "w").close()
    except BaseException:
        _reap_ranks(proc, n, flag, out_dir, 0)
        raise
    return _reap_ranks(proc, n, flag, out_dir, timeout)


def _spawn_ranks(n, flag, out_dir, extra_env=None):
    """This script's ``flag`` mode on ``n`` ranks through the port's
    launcher, started in a session of its own; returns the launcher."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, **(extra_env or {}))
    env.pop("PADDLE_MASTER", None)
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(n), "--log_dir",
         os.path.join(out_dir, f"logs{flag}"),
         os.path.join(root, "chip_smoke.py"), flag, out_dir],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)


def _reap_ranks(proc, n, flag, out_dir, timeout):
    """Wait up to ``timeout`` seconds for a ``_spawn_ranks`` launcher (its
    session is killed whole if it is still running or failed): (return
    code or None, its stderr, {rank: its log})."""
    import signal
    rc, stderr = None, ""
    try:
        _, stderr = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None or proc.returncode != 0:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    log_dir = os.path.join(out_dir, f"logs{flag}")
    logs = {}
    for r in range(n):
        path = os.path.join(log_dir, f"workerlog.{r}")
        logs[r] = open(path).read() if os.path.exists(path) else ""
    return rc, stderr, logs


def _dp_one_process(torch, tmp):
    """The one-process step the ranks' fp32 DataParallel step is held to
    (``_held_pieces``): GPT-124M's widths at 2 layers, AdamW lr 1e-4, on
    the two ranks' batches concatenated (4 x 1024), as ``dp_one.pt``."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12)
    pairs = [_seeded_ids(torch, cfg.vocab_size,
                         (DP_EXACT_BATCH, cfg.max_seq_len), seed=10 + r)
             for r in range(DP_RANKS)]
    ids, labels = (torch.cat(col) for col in zip(*pairs))
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    _one_process_step(torch, model, opt, ids, labels, f"{tmp}/dp_one.pt")
    del model, opt
    torch.cuda.empty_cache()


def _held_to_one_process(torch, got_loss, got_grads, got_params, loss,
                         grads, model):
    """A multi-rank fp32 step (its loss, synced gradients and updated
    parameters, whole on the host) against one step in this process from
    the same weights (``loss``, ``grads``, the updated ``model``): the loss
    within 1e-5 of itself, every gradient within 1e-5 of its largest entry
    (a gradient zero up to rounding, below 1e-6 of the model's largest, on
    both), and every entry of every updated parameter within 1e-5 of the
    tensor's largest entry once the difference that AdamW's first update
    (lr * g / (|g| + eps)) makes of the two gradients is taken out: that
    update is AdamW's own first step from a zero parameter with each
    gradient. Where |g| is near eps the update hangs on digits of g that
    fp32 leaves open; held this way no entry is left out (the count of
    entries with |g| < 1e-6, 100 x eps, is returned)."""
    from paddle_tpu_torch.optimizer import AdamW
    loss_rel = abs(got_loss - loss) / abs(loss)
    top = max(float(g.abs().max()) for g in grads.values())
    zero = sorted(n for n, g in grads.items()
                  if float(g.abs().max()) <= 1e-6 * top)
    grad_rel = {n: max_err(got_grads[n], g) / float(g.abs().max())
                for n, g in grads.items() if n not in zero}
    zero_ok = all(float(got_grads[n].abs().max()) <= 1e-6 * top
                  for n in zero)

    def first_step_from_zero(g):
        z = torch.nn.Parameter(torch.zeros_like(g, device="cuda"))
        z.grad = g.cuda()
        AdamW(learning_rate=1e-4, parameters=[z]).step()
        return z.detach().cpu().double()

    param_rel, near_eps = {}, 0
    for n, p in model.named_parameters():
        got, want = got_params[n], p.detach().cpu()
        diff = got.double() - want.double()
        g = grads.get(n)
        if g is not None:
            near_eps += int((g.abs() < 1e-6).sum())
            diff -= first_step_from_zero(got_grads[n]) - \
                first_step_from_zero(g)
        param_rel[n] = float(diff.abs().max()) / float(want.abs().max())
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_p = max(param_rel, key=param_rel.get)
    held = loss_rel <= 1e-5 and grad_rel[worst_g] <= 1e-5 and zero_ok and \
        param_rel[worst_p] <= 1e-5
    return {"loss_got": got_loss, "loss_one": loss,
            "loss_rel_err": loss_rel, "loss_rel_tol": 1e-5,
            "grad_max_rel_err": grad_rel[worst_g], "grad_worst": worst_g,
            "grads_zero_up_to_rounding": zero,
            "param_max_rel_err": param_rel[worst_p], "param_worst": worst_p,
            "param_rule": "every entry of p_got - p_one - (z(g_got) - "
                          "z(g_one)), z(g) AdamW's first step from zero",
            "entries_grad_below_1e-6": near_eps, "rel_tol": 1e-5,
            "held": held}


def _one_process_step(torch, model, opt, ids, labels, path):
    """One fp32 step of ``model`` in this process on ``ids``/``labels``,
    saved to ``path`` for ranks to hold their pieces to
    (``_held_pieces``): the loss, the gradients and the updated
    parameters, whole on the host."""
    dev = next(model.parameters()).device
    loss = model(ids.to(dev), labels=labels.to(dev))[1]
    loss.backward()
    grads = {n: p.grad.detach().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    opt.step()
    torch.save({"loss": loss.item(), "grads": grads,
                "params": {n: p.detach().cpu()
                           for n, p in model.named_parameters()}}, path)


def _held_pieces(torch, dist, got_loss, named, grads, one):
    """``_held_to_one_process``'s bounds without gathering the step: each
    rank holds the pieces it has (each synced gradient by its placement,
    the updated parameter on the same elements) to the same pieces of
    ``one`` (``_one_process_step``'s, whole, rows in this rank's stored
    order), each error over the largest entry of the whole tensor; the
    worst of each tensor is taken over the ranks, whose pieces cover
    every element. ``got_loss``: the step's loss over the data ranks.
    Every rank returns the same row."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        state_placement
    from paddle_tpu_torch.optimizer import AdamW
    loss = one["loss"]
    top = max(float(g.abs().max()) for g in one["grads"].values())
    zero = sorted(n for n, g in one["grads"].items()
                  if float(g.abs().max()) <= 1e-6 * top)

    def first_step_from_zero(g, device):
        z = torch.nn.Parameter(torch.zeros_like(g, device=device))
        z.grad = g.to(device)
        AdamW(learning_rate=1e-4, parameters=[z]).step()
        return z.detach().cpu().double()

    grad_rel, param_rel, zero_ok = {}, {}, True
    for (n, p), g in zip(named, grads):
        pl = state_placement(p, g)
        piece = (lambda full: full) if pl is None else pl.take
        g_got, g_one = g.detach().cpu(), piece(one["grads"][n])
        p_got = p.detach()
        if tuple(g.shape) != tuple(p.shape):     # ZeRO-1/2: its rows
            p_got = p_got[p._zero.lo:p._zero.hi]
        if n in zero:
            zero_ok &= float(g_got.abs().max()) <= 1e-6 * top
        else:
            grad_rel[n] = max_err(g_got, g_one) / float(
                one["grads"][n].abs().max())
        diff = p_got.cpu().double() - piece(one["params"][n]).double()
        diff -= first_step_from_zero(g_got, p.device) - \
            first_step_from_zero(g_one, p.device)
        param_rel[n] = float(diff.abs().max()) / float(
            one["params"][n].abs().max())
    seen = []
    dist.all_gather_object(seen, (grad_rel, param_rel, zero_ok))
    grad_rel = {n: max(s[0][n] for s in seen) for n in grad_rel}
    param_rel = {n: max(s[1][n] for s in seen) for n in param_rel}
    zero_ok = all(s[2] for s in seen)
    loss_rel = abs(got_loss - loss) / abs(loss)
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_p = max(param_rel, key=param_rel.get)
    held = loss_rel <= 1e-5 and grad_rel[worst_g] <= 1e-5 and zero_ok and \
        param_rel[worst_p] <= 1e-5
    return {"loss_got": got_loss, "loss_one": loss,
            "loss_rel_err": loss_rel, "loss_rel_tol": 1e-5,
            "grad_max_rel_err": grad_rel[worst_g], "grad_worst": worst_g,
            "grads_zero_up_to_rounding": zero,
            "param_max_rel_err": param_rel[worst_p], "param_worst": worst_p,
            "param_rule": "every entry of p_got - p_one - (z(g_got) - "
                          "z(g_one)), z(g) AdamW's first step from zero, "
                          "on each rank's pieces",
            "entries_grad_below_1e-6": sum(
                int((g.abs() < 1e-6).sum()) for g in one["grads"].values()),
            "rel_tol": 1e-5, "held": held}


def _spied_step(torch, net, opt, batch):
    """One ``CompiledTrainStep`` call of ``net`` with ``opt`` on
    ``batch``: (its loss, the gradients its sync returned)."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    step = CompiledTrainStep(lambda a, b: net(a, labels=b)[1], net, opt)
    real, seen = step._sync, {}
    step._sync = lambda g: seen.setdefault("grads", real(g))
    loss = step(*batch).item()
    return loss, seen["grads"]


def _twice_bit_identical(torch, build, batch, what):
    """``build()`` -> (model, net, optimizer) twice, one fp32 step of each
    (``_spied_step``): the reruns' loss, synced gradients and updated
    parameters must be bit-identical. Returns the first run's (model,
    loss, gradients)."""
    runs = []
    for _ in range(2):
        model, net, opt = build()
        runs.append((model,) + _spied_step(torch, net, opt, batch))
    (m1, l1, g1), (m2, l2, g2) = runs
    same = l1 == l2 and all(torch.equal(a, b) for a, b in zip(g1, g2)) \
        and all(torch.equal(a, b) for a, b in zip(m1.parameters(),
                                                  m2.parameters()))
    if not same:
        raise AssertionError(f"{what}: the fp32 step's rerun differs")
    del runs, m2, g2
    return m1, l1, g1


def phase_data_parallel(torch, ck, smi):
    """The data-parallel path: this process's one-process fp32 step, NCCL
    at world 1, then two gloo ranks on the card (GPT-124M's DataParallel
    steps, its fp32 step held to the one-process step and no_sync,
    ResNet-50's fit with SyncBatchNorm, the sync batch norm's exactness).
    The ranks' kernel launches are added to this process's counts."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        torch.cuda.empty_cache()
        # the NCCL rank runs beside the gloo ranks (it takes a few
        # collectives; its start is what costs)
        t0 = time.perf_counter()
        nccl_proc = _spawn_ranks(1, "--nccl-world-one", tmp)
        try:
            ranks = _run_ranks(DP_RANKS, "--data-parallel-rank", tmp,
                               {"PADDLE_DISTRI_BACKEND": "gloo"},
                               prepare=lambda: _dp_one_process(torch, tmp))
        except BaseException:
            _reap_ranks(nccl_proc, 1, "--nccl-world-one", tmp, 0)
            raise
        nccl = _rank_lines("--nccl-world-one", *_reap_ranks(
            nccl_proc, 1, "--nccl-world-one", tmp, DP_RANK_TIMEOUT_S))
        t_ranks = time.perf_counter() - t0
        for rows in list(nccl.values()) + list(ranks.values()):
            for row in rows[:-1]:
                emit(row)
            ck.add_launches(rows[-1]["rank_launches"])
        _exactness_held(ranks, "data_parallel_exactness_fp32", 1)
        gpt = [next(r for r in rows if r.get("phase") ==
                    "data_parallel_gpt124m") for rows in ranks.values()]
        step_s = max(g["step_ms"] for g in gpt) / 1e3
        tokens = sum(g["batch_per_rank"][0] * g["batch_per_rank"][1]
                     for g in gpt)
        emit({"phase": "data_parallel", "nvidia_smi": smi,
              "ranks": DP_RANKS, "backend": gpt[0]["backend"],
              "global_batch": [DP_RANKS * DP_BATCH,
                               gpt[0]["batch_per_rank"][1]],
              "global_tokens_per_s": tokens / step_s,
              "step_ms_slowest_rank": step_s * 1e3,
              "peak_memory_bytes_per_rank": [g["peak_memory_bytes"]
                                             for g in gpt],
              "comm_plane_per_rank": [g["comm_plane"] for g in gpt],
              "local_step_ms_per_rank": [g["local_step_ms_each"]
                                         for g in gpt],
              "allreduce_alone_ms_per_rank": [g["allreduce_alone_ms_each"]
                                              for g in gpt],
              "buckets": gpt[0]["buckets"],
              "allreduced_bytes_per_step": gpt[0]["allreduced_bytes_per_step"],
              "ranks_s": t_ranks})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- the hybrid-parallel path -----------------------------------------------------
# Two gloo ranks share the card, as the data-parallel path's do: first as
# mp 2 (TP GPT-124M at bench.py's widths, the fp32 TP and SP steps, the
# resharding checkpoint), then, after a second fleet.init, as sharding 2
# (ERNIE-3.0-base under ZeRO-3 as benchmarks/matrix.py:125-166 runs it,
# the fp32 ZeRO steps). (HP_RANKS and the batches stand beside FLASH_CASES)
HP_WARMUP, HP_TIMED = 1, 1
HP_ZERO_LEVELS = ("os", "os_g", "p_g_os")


def _hp_fleet(fleet, **degrees):
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict({"dp_degree": 1}, **degrees)
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group().mesh


def _whole_bytes(tensors):
    """Bytes of the global tensors behind ``tensors`` (one process holding
    the whole model and its state): (tensor, placement or None) pairs, or
    tensors whose own placement is read."""
    from paddle_tpu_torch.distributed.sharding_api import placement_of
    total = 0
    for t in tensors:
        t, pl = t if isinstance(t, tuple) else (t, placement_of(t))
        n = math.prod(pl.global_shape) if pl is not None else t.numel()
        total += n * t.element_size()
    return total


def _state_tensors_of(opt, params):
    """(state tensor, its placement) of every parameter's optimizer state:
    a TP parameter's moments are split like it, a ZeRO partition's are its
    rows."""
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        state_placement)
    return [(v, state_placement(p, v)) for p in params
            for v in opt._accumulators.get(id(p), {}).values()
            if torch.is_tensor(v)]


def _timed_training(torch, ck, step, batch, layers, route="bf16",
                    at_timed=None, warmup=None, timed=None):
    """``warmup`` + ``timed`` (HP_WARMUP + HP_TIMED) calls of
    ``step(*batch)``, each synchronized (``at_timed()`` runs before the
    first timed one); K2/K3 must launch ``layers`` times a call on
    ``route`` (once a layer, or more where a layer's attention is several
    blocks). Returns (losses, seconds per call)."""
    warmup = HP_WARMUP if warmup is None else warmup
    timed = HP_TIMED if timed is None else timed
    losses, secs = [], []
    for i in range(warmup + timed):
        if i == warmup and at_timed is not None:
            at_timed()
        before = {k.name: k.route_launches[route] for k in ck.KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = {k.name: k.route_launches[route] - before[k.name]
               for k in ck.KERNELS}
        if got["flash_fwd"] != layers or got["flash_bwd"] != layers:
            raise AssertionError(f"call {i} launched {got} on {route}")
        losses.append(loss.item())
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    return losses, secs


def hp_tp_gpt124m_rank(torch, ck, dist, rank, mesh):
    """GPT-124M at bench.py's widths under ``tensor_parallel`` at mp 2:
    each rank holds half of every split weight and 6 of the 12 heads, and
    both run the global batch of 8 x 1024 (one data rank). O2 bf16,
    AdamW lr 1e-4, ``CompiledTrainStep``; then one more call with the mp
    collectives metered (comm ms a step)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small(tensor_parallel=True)
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = CompiledTrainStep(lambda ids, labels: model(ids, labels=labels)[1],
                             model, opt, amp_level="O2")
    ids, labels = (t.cuda() for t in _seeded_ids(
        torch, cfg.vocab_size, (HP_TP_BATCH, cfg.max_seq_len), seed=20))
    torch.cuda.reset_peak_memory_stats()
    losses, secs = _timed_training(torch, ck, step, (ids, labels),
                                   cfg.num_layers)
    peak = torch.cuda.max_memory_allocated()
    mp_layers.comm_meter(on=True, reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(ids, labels)
    torch.cuda.synchronize()
    metered_s = time.perf_counter() - t0
    comm = mp_layers.comm_meter(on=False)
    seen = []
    dist.all_gather_object(seen, losses)
    if seen[0] != seen[1]:
        raise AssertionError(f"the mp ranks' losses differ: {seen}")
    params = list(model.parameters())
    states = _state_tensors_of(opt, params)
    timed = secs[HP_WARMUP:]
    out = {"phase": "hybrid_parallel_tp_gpt124m", "mp": 2,
           "batch_global": [HP_TP_BATCH, cfg.max_seq_len],
           "heads_per_rank": cfg.num_heads // 2,
           "step_ms": 1e3 * sum(timed) / len(timed),
           "step_ms_each": [1e3 * s for s in secs], "losses": losses,
           "comm_ms_per_step": comm["ms"], "comm_calls_per_step":
           comm["calls"], "comm_bytes_per_step": comm["bytes"],
           "metered_step_ms": 1e3 * metered_s,
           "peak_memory_bytes": peak,
           "param_bytes": sum(p.numel() * p.element_size() for p in params),
           "optimizer_bytes": sum(v.numel() * v.element_size()
                                  for v, _ in states),
           "one_process_param_bytes": _whole_bytes(params),
           "one_process_optimizer_bytes": _whole_bytes(states),
           "flash_launches_per_step": [cfg.num_layers, cfg.num_layers]}
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def hp_ernie_zero3_rank(torch, ck, dist, rank, mesh):
    """``ernie_pretraining``'s model under ``group_sharded_parallel(...,
    "p_g_os")`` at sharding 2, ``CompiledTrainStep`` on the unwrapped net
    and the inner optimizer, O2 bf16, the global 16 x 512 split 8 + 8."""
    from paddle_tpu_torch.distributed import comm_plane
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        group_sharded_parallel)
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.ernie import ErnieForPretraining
    cfg = ernie_config()
    model = ErnieForPretraining(cfg, device="cuda", seed=0)
    whole = _whole_bytes(model.parameters())
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    net, opt2, _ = group_sharded_parallel(model, opt, "p_g_os")
    step = CompiledTrainStep(lambda ids, l: net(ids, labels=l)[1], model,
                             getattr(opt2, "_optim", opt2), amp_level="O2")
    ids, labels = _seeded_ids(torch, cfg.vocab_size,
                              (HP_RANKS * HP_ERNIE_BATCH, ERNIE_SEQ),
                              seed=30)
    rows = slice(rank * HP_ERNIE_BATCH, (rank + 1) * HP_ERNIE_BATCH)
    batch = (ids[rows].cuda(), labels[rows].cuda())
    plane = comm_plane.get_plane()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = _timed_training(torch, ck, step, batch,
                                   cfg.num_hidden_layers,
                                   at_timed=plane.reset_stats)
    stats = plane.stats()
    params = list(model.parameters())
    states = _state_tensors_of(opt, params)
    sharded = [p for p in params if getattr(p, "_zero", None) is not None]
    timed = secs[HP_WARMUP:]
    out = {"phase": "hybrid_parallel_ernie_zero3", "sharding": 2,
           "level": "p_g_os", "batch_per_rank": [HP_ERNIE_BATCH, ERNIE_SEQ],
           "step_ms": 1e3 * sum(timed) / len(timed),
           "step_ms_each": [1e3 * s for s in secs], "losses": losses,
           "comm_plane_per_step": {k: v / HP_TIMED if k != "overlap_"
                                   "efficiency" else v
                                   for k, v in stats.items()},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "param_bytes": sum(p.numel() * p.element_size() for p in params),
           "optimizer_bytes": sum(v.numel() * v.element_size()
                                  for v, _ in states),
           "one_process_param_bytes": whole,
           "one_process_optimizer_bytes": _whole_bytes(states),
           "sharded_param_bytes": sum(p.numel() * p.element_size()
                                      for p in sharded),
           "one_process_sharded_param_bytes": _whole_bytes(sharded),
           "params_sharded": len(sharded), "params": len(params),
           "flash_launches_per_step": [cfg.num_hidden_layers] * 2}
    del model, opt, opt2, step, net
    torch.cuda.empty_cache()
    return out


def hp_exact_rank(torch, dist, rank, out_dir, mode):
    """One fp32 AdamW step (lr 1e-4) of GPT-124M's widths at 2 layers
    under ``mode`` (``tp``, ``sp`` at mp 2; a ZeRO level at sharding 2,
    each rank on half the global 4 x 1024), through ``CompiledTrainStep``,
    held piece by piece (``_held_pieces``) to the parent's one-process
    step on the global batch from the same weights (``hp_one.pt``); in
    ``tp`` mode rank 0 also saves the updated parameters, gathered whole,
    for the parent's checkpoint check. Returns (the JSON row, the model,
    its optimizer)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel
    from paddle_tpu_torch.distributed.sharding_api import gather_global
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12,
                    tensor_parallel=mode == "tp",
                    sequence_parallel=mode == "sp")
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    ids, labels = _seeded_ids(torch, cfg.vocab_size,
                              (HP_EXACT_BATCH, cfg.max_seq_len), seed=40)
    net, inner = model, opt
    if mode in HP_ZERO_LEVELS:
        net, opt2, _ = group_sharded_parallel(model, opt, mode)
        inner = getattr(opt2, "_optim", opt2)
        half = HP_EXACT_BATCH // HP_RANKS
        ids, labels = (t[rank * half:(rank + 1) * half] for t in (ids,
                                                                   labels))
    step = CompiledTrainStep(lambda a, b: net(a, labels=b)[1], model, inner)
    real, seen = step._sync, {}
    step._sync = lambda g: seen.setdefault("grads", real(g))
    losses = []
    dist.all_gather_object(losses, step(ids.cuda(), labels.cuda()).item())
    if mode in ("tp", "sp") and losses[0] != losses[1]:
        raise AssertionError(f"{mode}: the mp ranks' losses differ {losses}")
    named = list(model.named_parameters())
    out = _held_pieces(torch, dist, sum(losses) / len(losses), named,
                       seen["grads"],
                       torch.load(f"{out_dir}/hp_one.pt", mmap=True))
    if mode == "tp":
        params = {n: gather_global(p) for n, p in named}
        if rank == 0:
            torch.save({"params": params}, f"{out_dir}/hp_exact_tp.pt")
    out.update(phase=f"hybrid_parallel_exactness_fp32_{mode}", tf32=False,
               losses=losses,
               model=f"GPT-124M widths, 2 layers, fp32, AdamW lr 1e-4; "
                     f"{mode} on 2 ranks against one process on "
                     f"{HP_EXACT_BATCH} x 1024")
    return out, model, opt


def hp_reshard_rank(torch, dist, rank, out_dir, model, opt):
    """The TP ranks save the fp32 TP model and its AdamW state through
    ``distributed.checkpoint`` (rank 0 also saves the gathered moments);
    then the parent's one-process checkpoint loads into a TP model of
    another seed, each rank's slice of every parameter and moment
    bit-equal to its piece of the whole."""
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.distributed.sharding_api import (gather_global,
                                                           placement_of)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    dck.save_state_dict({"model": model.state_dict(),
                         "opt": opt.state_dict()}, f"{out_dir}/hp_ckpt_tp")
    moments = {k: gather_global(v) for k, v in opt.state_dict().items()
               if torch.is_tensor(v) and v.ndim}
    if rank == 0:
        torch.save(moments, f"{out_dir}/hp_ckpt_tp_moments.pt")
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12,
                    tensor_parallel=True)
    m2 = GPTForPretraining(cfg, device="cuda", seed=6)
    o2 = AdamW(learning_rate=1e-4, parameters=m2.named_parameters())
    for p in m2.parameters():
        o2._get_accumulators(p)
    state = {"model": m2.state_dict(), "opt": o2.state_dict()}
    dck.load_state_dict(state, f"{out_dir}/hp_whole")
    o2.set_state_dict(state["opt"])
    whole = torch.load(f"{out_dir}/hp_whole.pt")

    def piece(t, full):
        pl = placement_of(t)
        return pl.take(full) if pl is not None else full

    checked, bad = 0, []
    for (n, t), full in [((n, p), whole["model"][n])
                         for n, p in m2.named_parameters()] + \
            [((k, v), whole["opt"][k]) for k, v in o2.state_dict().items()
             if torch.is_tensor(v) and v.ndim]:
        checked += 1
        if not torch.equal(t.detach().cpu(), piece(t, full)):
            bad.append(n)
    if bad or o2._step_count != whole["step"]:
        raise AssertionError(f"1 -> mp 2: slices differ {bad}")
    return {"phase": "hybrid_parallel_reshard_rank",
            "one_process_to_mp2_bit_equal": True, "tensors": checked,
            "saved": "hp_ckpt_tp"}


def hybrid_parallel_rank(torch, out_dir):
    """One rank of the hybrid-parallel path (started by the launcher):
    mp 2 (TP GPT-124M, the fp32 TP and SP steps, the checkpoint), then
    sharding 2 (ERNIE under ZeRO-3, the fp32 ZeRO steps). Prints one JSON
    line per phase and last its launches by route."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env(timeout=DP_RANK_TIMEOUT_S)
    _wait_ready(out_dir)
    rank, world = env.rank, env.world_size
    if dist.get_backend() != "gloo" or world != HP_RANKS:
        raise AssertionError(f"backend {dist.get_backend()}, world {world}")
    ck.reset_launch_counts()
    mesh = _hp_fleet(fleet, mp_degree=2)
    _rank_emit(rank, hp_tp_gpt124m_rank(torch, ck, dist, rank, mesh))
    row, tp_model, tp_opt = hp_exact_rank(torch, dist, rank, out_dir, "tp")
    _rank_emit(rank, row)
    _rank_emit(rank, hp_exact_rank(torch, dist, rank, out_dir, "sp")[0])
    _rank_emit(rank, hp_reshard_rank(torch, dist, rank, out_dir, tp_model,
                                     tp_opt))
    del tp_model, tp_opt
    mesh = _hp_fleet(fleet, sharding_degree=2)
    _rank_emit(rank, hp_ernie_zero3_rank(torch, ck, dist, rank, mesh))
    for level in HP_ZERO_LEVELS:
        _rank_emit(rank, hp_exact_rank(torch, dist, rank, out_dir,
                                       level)[0])
    _rank_emit(rank, {"rank_launches": {k.name: dict(k.route_launches)
                                        for k in ck.KERNELS}})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _one_process_gpt2(torch, seed):
    """GPT-124M's widths at 2 layers, fp32, on the card, with AdamW lr 1e-4
    over its named parameters."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    model = GPTForPretraining(GPTConfig(hidden_size=768, num_layers=2,
                                        num_heads=12), device="cuda",
                              seed=seed)
    return model, AdamW(learning_rate=1e-4,
                        parameters=model.named_parameters())


def _hp_whole_checkpoint(torch, tmp):
    """This process's checkpoint for the ranks to reshard: the 2-layer fp32
    GPT (seed 5) and its AdamW state after one step, through
    ``distributed.checkpoint``, and the same values in a torch file."""
    from paddle_tpu_torch.distributed import checkpoint as dck
    model, opt = _one_process_gpt2(torch, 5)
    ids, labels = _seeded_ids(torch, model.config.vocab_size,
                              (2, model.config.max_seq_len), seed=50)
    model(ids.cuda(), labels=labels.cuda())[1].backward()
    opt.step()
    dck.save_state_dict({"model": model.state_dict(),
                         "opt": opt.state_dict()}, f"{tmp}/hp_whole")
    torch.save({"model": {n: p.detach().cpu()
                          for n, p in model.named_parameters()},
                "opt": {k: v.cpu() for k, v in opt.state_dict().items()
                        if torch.is_tensor(v)},
                "step": opt._step_count}, f"{tmp}/hp_whole.pt")
    del model, opt


def _hp_one_process(torch, tmp):
    """The one-process step the ranks' fp32 TP, SP and ZeRO steps are held
    to (``_held_to_one_process``'s bounds, ``_held_pieces``): GPT-124M's
    widths at 2 layers from the same weights on the global 4 x 1024, saved
    as ``hp_one.pt``."""
    model, opt = _one_process_gpt2(torch, 0)
    ids, labels = _seeded_ids(torch, model.config.vocab_size,
                              (HP_EXACT_BATCH, model.config.max_seq_len),
                              seed=40)
    _one_process_step(torch, model, opt, ids, labels, f"{tmp}/hp_one.pt")
    del model, opt
    torch.cuda.empty_cache()


def _exactness_held(ranks, prefix, count):
    """Rank 0's ``count`` rows whose phase starts with ``prefix``; raises
    unless each was held."""
    rows = [r for r in ranks[0] if r.get("phase", "").startswith(prefix)]
    bad = [r["phase"] for r in rows if not r["held"]]
    if len(rows) != count or bad:
        raise AssertionError(f"{prefix}: {len(rows)} of {count} steps, "
                             f"differing from one process: {bad}")


def phase_hybrid_parallel_reshard(torch, tmp):
    """mp 2 -> 1: the TP ranks' checkpoint loads into one process bit-equal
    to the ranks' gathered parameters and moments; then a copy with one
    byte flipped in rank 1's shard must be refused."""
    import shutil

    from paddle_tpu_torch.distributed import checkpoint as dck
    model, opt = _one_process_gpt2(torch, 7)
    for p in model.parameters():
        opt._get_accumulators(p)
    state = {"model": model.state_dict(), "opt": opt.state_dict()}
    dck.load_state_dict(state, f"{tmp}/hp_ckpt_tp")
    opt.set_state_dict(state["opt"])
    params = torch.load(f"{tmp}/hp_exact_tp.pt")["params"]
    moments = torch.load(f"{tmp}/hp_ckpt_tp_moments.pt")
    bad = [n for n, p in model.named_parameters()
           if not torch.equal(p.detach().cpu(), params[n])]
    bad += [k for k, v in opt.state_dict().items()
            if k in moments and not torch.equal(v.cpu(), moments[k])]
    flipped = f"{tmp}/hp_ckpt_tp_flipped"
    shutil.copytree(f"{tmp}/hp_ckpt_tp", flipped)
    with open(f"{flipped}/shard_1.pkl", "r+b") as f:
        f.seek(4096)
        byte = f.read(1)
        f.seek(4096)
        f.write(bytes([byte[0] ^ 0x40]))
    try:
        dck.load_state_dict({"model": model.state_dict()}, flipped)
        refused = None
    except ValueError as e:
        refused = str(e)
    out = {"phase": "hybrid_parallel_reshard",
           "mp2_to_one_process_bit_equal": not bad, "mismatched": bad,
           "tensors": len(params) + len(moments),
           "flipped_byte_refused": refused is not None and
           "corrupt" in refused, "refusal": refused}
    emit(out)
    del model, opt
    if bad or not out["flipped_byte_refused"]:
        raise AssertionError(f"resharding: {out}")


def phase_hybrid_parallel(torch, ck, smi):
    """The hybrid-parallel path: this process writes a one-process
    checkpoint and a one-process fp32 step, two gloo ranks run TP
    GPT-124M, the fp32 TP/SP/ZeRO steps (each held to that step on the
    ranks), the resharding and ERNIE under ZeRO-3, then this process loads
    their TP checkpoint. The ranks' kernel launches are added to this
    process's counts."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hp_")
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _run_ranks(HP_RANKS, "--hybrid-parallel-rank", tmp,
                           {"PADDLE_DISTRI_BACKEND": "gloo"},
                           prepare=lambda: (_hp_whole_checkpoint(torch, tmp),
                                            _hp_one_process(torch, tmp)))
        t_ranks = time.perf_counter() - t0
        for rows in ranks.values():
            for row in rows[:-1]:
                emit(row)
            ck.add_launches(rows[-1]["rank_launches"])
        _exactness_held(ranks, "hybrid_parallel_exactness_fp32_",
                        2 + len(HP_ZERO_LEVELS))
        phase_hybrid_parallel_reshard(torch, tmp)

        def rows_of(phase):
            return [next(r for r in rows if r.get("phase") == phase)
                    for rows in ranks.values()]

        tp = rows_of("hybrid_parallel_tp_gpt124m")
        er = rows_of("hybrid_parallel_ernie_zero3")
        tp_s = max(r["step_ms"] for r in tp) / 1e3
        er_s = max(r["step_ms"] for r in er) / 1e3
        emit({"phase": "hybrid_parallel", "nvidia_smi": smi,
              "ranks": HP_RANKS, "backend": "gloo",
              "tp_gpt124m": {
                  "mp": 2, "global_batch": [HP_TP_BATCH, 1024],
                  "step_ms_slowest_rank": tp_s * 1e3,
                  "global_tokens_per_s": HP_TP_BATCH * 1024 / tp_s,
                  "comm_ms_per_step": [r["comm_ms_per_step"] for r in tp],
                  "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                                 for r in tp],
                  "param_plus_optimizer_bytes_per_rank": [
                      r["param_bytes"] + r["optimizer_bytes"] for r in tp],
                  "one_process_param_plus_optimizer_bytes":
                      tp[0]["one_process_param_bytes"] +
                      tp[0]["one_process_optimizer_bytes"],
                  "flash_launches_per_step_per_rank":
                      tp[0]["flash_launches_per_step"]},
              "ernie_zero3": {
                  "sharding": 2,
                  "global_batch": [HP_RANKS * HP_ERNIE_BATCH, ERNIE_SEQ],
                  "step_ms_slowest_rank": er_s * 1e3,
                  "global_tokens_per_s":
                      HP_RANKS * HP_ERNIE_BATCH * ERNIE_SEQ / er_s,
                  "comm_plane_per_step": [r["comm_plane_per_step"]
                                          for r in er],
                  "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                                 for r in er],
                  "param_plus_optimizer_bytes_per_rank": [
                      r["param_bytes"] + r["optimizer_bytes"] for r in er],
                  "one_process_param_plus_optimizer_bytes":
                      er[0]["one_process_param_bytes"] +
                      er[0]["one_process_optimizer_bytes"],
                  "sharded_param_bytes_per_rank": [
                      r["sharded_param_bytes"] for r in er],
                  "one_process_sharded_param_bytes":
                      er[0]["one_process_sharded_param_bytes"],
                  "flash_launches_per_step_per_rank":
                      er[0]["flash_launches_per_step"]},
              "ranks_s": t_ranks})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- the context-parallel path -----------------------------------------------------
# Two gloo ranks share the card as sep 2 after fleet.init(sep_degree=2):
# GPT-124M at bench.py's widths on the global 2 x 8192 tokens
# (benchmarks/matrix.py:306, cp_longseq at seq 8192, sep 2), each rank
# [2, 4096] (sep_local_batch), O2 bf16, AdamW lr 1e-4, CompiledTrainStep,
# with the ring (zigzag schedule) and with Ulysses; then the fp32 steps at
# 2 layers on 1 x 4096, held to one process by this one. (CP_RANKS and the
# shapes stand beside FLASH_CASES)
CP_WARMUP, CP_TIMED = 1, 1
CP_MODES = ("ring", "ulysses")
# K2 and K3 launches a layer and call on a rank at sep 2: the zigzag's own
# pair and one half-shard block; Ulysses' one whole-sequence call
CP_BLOCKS_PER_LAYER = {"ring": 2, "ulysses": 1}


def cp_gpt124m_rank(torch, ck, dist, rank, mode):
    """GPT-124M at bench.py's widths (``max_seq_len`` 8192) with
    ``context_parallel=mode`` over sep 2, CP_WARMUP + CP_TIMED calls on
    this rank's [2, 4096] of the global 2 x 8192; K2/K3 launch
    ``CP_BLOCKS_PER_LAYER`` times a layer and call; the sep transport's
    exchanges, bytes and ms over the timed calls; both ranks report the
    same global losses."""
    from paddle_tpu_torch.distributed import sep_transport
    from paddle_tpu_torch.distributed.sharding_api import sep_local_batch
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small(max_seq_len=CP_SEQ, context_parallel=mode)
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = CompiledTrainStep(lambda ids, labels: model(ids, labels=labels)[1],
                             model, opt, amp_level="O2")
    ids, labels = (sep_local_batch(t).contiguous().cuda() for t in
                   _seeded_ids(torch, cfg.vocab_size, (CP_BATCH, CP_SEQ),
                               seed=60))
    per_call = CP_BLOCKS_PER_LAYER[mode] * cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = _timed_training(torch, ck, step, (ids, labels), per_call,
                                   at_timed=sep_transport.reset_stats,
                                   warmup=CP_WARMUP, timed=CP_TIMED)
    sep = sep_transport.stats()
    peak = torch.cuda.max_memory_allocated()
    seen = []
    dist.all_gather_object(seen, losses)
    if seen[0] != seen[1]:
        raise AssertionError(f"{mode}: the sep ranks' losses differ {seen}")
    timed = secs[CP_WARMUP:]
    out = {"phase": f"context_parallel_gpt124m_{mode}", "sep": CP_RANKS,
           "batch_global": [CP_BATCH, CP_SEQ],
           "batch_rank": list(ids.shape),
           "step_ms": 1e3 * sum(timed) / len(timed),
           "step_ms_each": [1e3 * s for s in secs], "losses": losses,
           "sep_exchanges_per_step": sep["exchanges"] / CP_TIMED,
           "sep_bytes_per_step": sep["bytes"] / CP_TIMED,
           "sep_ms_per_step": sep["ms"] / CP_TIMED,
           "peak_memory_bytes": peak,
           "flash_launches_per_step": per_call}
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def _cp_exact_batch(torch):
    """The fp32 steps' batch, 1 x 4096: the labels of the first 1536
    tokens ignored, so sep rank 0 keeps 512 of its 2048 and rank 1 all."""
    ids, labels = _seeded_ids(torch, 50304, (1, CP_EXACT_SEQ), seed=61)
    labels[:, :1536] = -100
    return ids, labels


def cp_exact_rank(torch, dist, rank, out_dir, mode):
    """One fp32 AdamW step (lr 1e-4) of GPT-124M's widths at 2 layers with
    ``context_parallel=mode`` on this rank's half of ``_cp_exact_batch``,
    twice from the same build (``_twice_bit_identical``), held piece by
    piece to the parent's one-process step on the whole 1 x 4096
    (``cp_one.pt``, ``_held_pieces``)."""
    from paddle_tpu_torch.distributed.sharding_api import sep_local_batch
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12,
                    max_seq_len=CP_EXACT_SEQ, context_parallel=mode)
    ids, labels = (sep_local_batch(t).contiguous().cuda()
                   for t in _cp_exact_batch(torch))

    def build():
        model = GPTForPretraining(cfg, device="cuda", seed=0)
        return model, model, AdamW(learning_rate=1e-4,
                                   parameters=model.named_parameters())

    model, loss, grads = _twice_bit_identical(torch, build, (ids, labels),
                                              mode)
    out = _held_pieces(torch, dist, loss, list(model.named_parameters()),
                       grads, torch.load(f"{out_dir}/cp_one.pt",
                                         mmap=True))
    out.update(phase=f"context_parallel_exactness_fp32_{mode}", tf32=False,
               rerun_bit_identical=True,
               model=f"GPT-124M widths, 2 layers, fp32, AdamW lr 1e-4; "
                     f"{mode} on {CP_RANKS} sep ranks against one process "
                     f"on 1 x {CP_EXACT_SEQ}, labels of the first 1536 "
                     "tokens ignored")
    del model, grads
    torch.cuda.empty_cache()
    return out


def context_parallel_rank(torch, out_dir):
    """One rank of the context-parallel path (started by the launcher):
    sep 2 after ``fleet.init``, the fp32 steps, then GPT-124M's timed
    calls, each for the ring and Ulysses. Prints one JSON line per phase
    and last its launches by route."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env(timeout=DP_RANK_TIMEOUT_S)
    _wait_ready(out_dir)
    rank, world = env.rank, env.world_size
    if dist.get_backend() != "gloo" or world != CP_RANKS:
        raise AssertionError(f"backend {dist.get_backend()}, world {world}")
    ck.reset_launch_counts()
    mesh = _hp_fleet(fleet, sep_degree=CP_RANKS)
    if mesh.shape["sep"] != CP_RANKS:
        raise AssertionError(f"mesh {mesh}")
    for mode in CP_MODES:
        _rank_emit(rank, cp_exact_rank(torch, dist, rank, out_dir, mode))
    for mode in CP_MODES:
        _rank_emit(rank, cp_gpt124m_rank(torch, ck, dist, rank, mode))
    _rank_emit(rank, {"rank_launches": {k.name: dict(k.route_launches)
                                        for k in ck.KERNELS}})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _cp_one_process(torch, tmp):
    """The one-process step the ranks' fp32 ring and Ulysses steps are held
    to: GPT-124M's widths at 2 layers from the same weights on the whole
    ``_cp_exact_batch``, as ``cp_one.pt``."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    model = GPTForPretraining(GPTConfig(hidden_size=768, num_layers=2,
                                        num_heads=12,
                                        max_seq_len=CP_EXACT_SEQ),
                              device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    _one_process_step(torch, model, opt, *_cp_exact_batch(torch),
                      f"{tmp}/cp_one.pt")
    del model, opt
    torch.cuda.empty_cache()


def phase_context_parallel(torch, ck, smi):
    """The context-parallel path: this process's one-process fp32 step,
    then two gloo ranks at sep 2 (the fp32 ring and Ulysses steps held to
    it, then GPT-124M at 2 x 8192 each way). The ranks' kernel launches
    are added to this process's counts."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cp_")
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _run_ranks(CP_RANKS, "--context-parallel-rank", tmp,
                           {"PADDLE_DISTRI_BACKEND": "gloo"},
                           prepare=lambda: _cp_one_process(torch, tmp))
        t_ranks = time.perf_counter() - t0
        for rows in ranks.values():
            for row in rows[:-1]:
                emit(row)
            ck.add_launches(rows[-1]["rank_launches"])
        _exactness_held(ranks, "context_parallel_exactness_fp32_",
                        len(CP_MODES))
        summary = {"phase": "context_parallel", "nvidia_smi": smi,
                   "ranks": CP_RANKS, "backend": "gloo",
                   "sep_transport": "point to point staged through the "
                                    "host (gloo, CUDA tensors); all-to-all "
                                    "by gloo's own CUDA path",
                   "global_batch": [CP_BATCH, CP_SEQ]}
        for mode in CP_MODES:
            got = [next(r for r in rows if r.get("phase") ==
                        f"context_parallel_gpt124m_{mode}")
                   for rows in ranks.values()]
            step_s = max(g["step_ms"] for g in got) / 1e3
            summary[mode] = {
                "step_ms_slowest_rank": step_s * 1e3,
                "global_tokens_per_s": CP_BATCH * CP_SEQ / step_s,
                "sep_bytes_per_step_per_rank": [g["sep_bytes_per_step"]
                                                for g in got],
                "sep_ms_per_step_per_rank": [g["sep_ms_per_step"]
                                             for g in got],
                "sep_exchanges_per_step": got[0]["sep_exchanges_per_step"],
                "peak_memory_bytes_per_rank": [g["peak_memory_bytes"]
                                               for g in got],
                "flash_launches_per_step_per_rank":
                    [g["flash_launches_per_step"] for g in got],
                "losses": got[0]["losses"]}
        summary.update(ranks_s=t_ranks)
        emit(summary)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class _PPHcg:
    """One process owning both stages (``PipelineParallel._local_train``)."""

    def get_pipe_parallel_world_size(self):
        return PP_RANKS

    def get_stage_id(self):
        return 0

    def get_pipe_parallel_group(self):
        from types import SimpleNamespace
        return SimpleNamespace(ranks=[0] * PP_RANKS)


def _pp_glue(torch, cfg, device):
    """The eager pipeline's first and last layers, built from the port's
    modules: the token and position embeddings (normal(0, 0.02)), and
    ``ln_f`` with an untied head; and its fp32 loss."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.layer.common import Linear
    from paddle_tpu_torch.nn.layer.layers import Layer
    from paddle_tpu_torch.nn.layer.norm import LayerNorm

    class Embed(Layer):
        def __init__(self):
            super().__init__()
            self.wte = torch.nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                          device=device)
            self.wpe = torch.nn.Embedding(cfg.max_seq_len, cfg.hidden_size,
                                          device=device)
            with torch.no_grad():
                for w in (self.wte.weight, self.wpe.weight):
                    w.copy_(torch.normal(0.0, 0.02, tuple(w.shape)))

        def forward(self, ids):
            pos = torch.arange(ids.shape[1], device=ids.device)[None]
            return F.embedding(ids, self.wte.weight) + \
                F.embedding(pos, self.wpe.weight)

    class Head(Layer):
        def __init__(self):
            super().__init__()
            self.ln_f = LayerNorm(cfg.hidden_size, device=device)
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=False, device=device)

        def forward(self, x):
            return self.lm_head(self.ln_f(x))

    def loss_fn(logits, labels):
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               labels.reshape(-1))

    return Embed, Head, loss_fn


def _pp_layer(torch, cfg, device=None, seed=0):
    """GPT as a ``PipelineLayer`` over 2 stages: the embeddings, the
    blocks (``text/gpt.py`` ``GPTBlock``), ``ln_f`` and the head; every
    rank draws the same weights from ``seed``."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)
    from paddle_tpu_torch.text.gpt import GPTBlock
    device = device or PP_DEVICE
    Embed, Head, loss_fn = _pp_glue(torch, cfg, device)
    torch.manual_seed(seed)
    descs = [LayerDesc(Embed)] + [
        LayerDesc(GPTBlock, cfg, device) for _ in range(cfg.num_layers)] + [
        LayerDesc(Head)]
    return PipelineLayer(descs, num_stages=PP_RANKS, loss_fn=loss_fn)


def _pp_strategy(fleet, mode, m):
    strategy = fleet.get_strategy()
    strategy.pipeline_configs = {"accumulate_steps": m,
                                 "micro_batch_size": PP_BATCH // m,
                                 "schedule_mode": mode}
    return strategy


def pp_send_probe(torch, mesh):
    """A send to a peer that has not posted its receive, for 64 B and for
    one microbatch's 3 MB bf16 state on the card: the seconds the send
    took to return (stage 0) while stage 1 sleeps 1 s before receiving;
    the received bits must equal the sent ones."""
    from paddle_tpu_torch.distributed import comm_plane as cp
    from paddle_tpu_torch.distributed.collective import barrier
    group = mesh.group("pp")
    stage = mesh.coord["pp"]
    out = {"phase": "pipeline_send_before_receive", "send_s": {}}
    for n in (32, PP_STATE_BYTES // 2):
        x = torch.arange(n, device=PP_DEVICE).to(torch.bfloat16)
        if stage == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = cp.pp_send(x, group.ranks[1], "fwd", 0, group=group)
            out["send_s"][str(n * 2)] = time.perf_counter() - t0
            work.wait()
        else:
            time.sleep(1.0)
            got = cp.pp_recv(group.ranks[0], "fwd", 0, group=group,
                             device=PP_DEVICE).result()
            if not torch.equal(got, x):
                raise AssertionError(f"the {n * 2} B boundary tensor changed")
        barrier()
    if stage == 0 and max(out["send_s"].values()) > 0.5:
        raise AssertionError(f"a send blocked on its receiver: {out}")
    return out


def pp_eager_exact_rank(torch, fleet, mode):
    """Two fp32 AdamW steps (lr 1e-4) of GPT-124M's widths at
    PP_EXACT_LAYERS layers through ``fleet.distributed_model``'s
    ``PipelineParallel`` in ``mode`` across the two ranks, against the
    same steps through ``_local_train`` in this process: losses and this
    stage's parameters bit-identical."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineParallel
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig
    cfg = GPTConfig(hidden_size=768, num_layers=PP_EXACT_LAYERS,
                    num_heads=12)
    strategy = _pp_strategy(fleet, mode, PP_EXACT_MICRO)
    batches = [tuple(t.to(PP_DEVICE) for t in _seeded_ids(
        torch, cfg.vocab_size, (PP_EXACT_BATCH, 1024), seed=70 + i))
        for i in range(2)]
    local = PipelineParallel(_pp_layer(torch, cfg), _PPHcg(), strategy)
    lopt = AdamW(learning_rate=1e-4, parameters=local.parameters())
    want = [local.train_batch(b, lopt) for b in batches]
    pipe = fleet.distributed_model(_pp_layer(torch, cfg))
    if not (type(pipe) is PipelineParallel and pipe._multi):
        raise AssertionError(f"distributed_model gave {type(pipe)}")
    opt = AdamW(learning_rate=1e-4, parameters=pipe.parameters())
    got = [pipe.train_batch(b, opt) for b in batches]
    stage = pipe._stage
    mine = [p for layer, _ in local._layers.get_stage_layers(stage)
            for p in layer.parameters()]
    theirs = list(pipe._layers.parameters())
    same_loss = all(torch.equal(a, b) for a, b in zip(got, want))
    same_params = len(mine) == len(theirs) and all(
        torch.equal(a, b) for a, b in zip(mine, theirs))
    if not (same_loss and same_params):
        raise AssertionError(f"{mode}: the pipeline differs from "
                             f"_local_train: losses {got} vs {want}, "
                             f"parameters equal {same_params}")
    out = {"phase": f"pipeline_eager_exact_{mode}", "stage": stage,
           "losses": [float(x) for x in got],
           "bit_identical_to_local_train": True,
           "schedule": "".join(f"{op}{k}" for op, k in pipe._last_schedule),
           "max_inflight": pipe._last_max_inflight}
    del local, pipe, lopt, opt
    torch.cuda.empty_cache()
    return out


def _pp_exact_batch(torch):
    return _seeded_ids(torch, 50304, (PP_EXACT_BATCH, 1024), seed=72)


def pp_spmd_exact_rank(torch, dist, rank, out_dir, n_chunks):
    """One fp32 AdamW step (lr 1e-4) of ``GPTForPretrainingPipe`` at
    GPT-124M's widths and PP_EXACT_LAYERS layers over pp 2 through
    ``CompiledTrainStep``, twice from the same build
    (``_twice_bit_identical``), held piece by piece to the parent's
    unpipelined step (``pp_one.pt``, in this model's row order,
    ``_held_pieces``)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretrainingPipe
    cfg = GPTConfig(hidden_size=768, num_layers=PP_EXACT_LAYERS,
                    num_heads=12)
    ids, labels = (t.to(PP_DEVICE) for t in _pp_exact_batch(torch))

    def build():
        model = GPTForPretrainingPipe(cfg, n_microbatch=PP_EXACT_MICRO,
                                      n_chunks=n_chunks, device=PP_DEVICE,
                                      seed=0)
        return model, model, AdamW(learning_rate=1e-4,
                                   parameters=model.parameters())

    model, loss, grads = _twice_bit_identical(
        torch, build, (ids, labels), f"n_chunks {n_chunks}")
    one = _p3_stored(torch, torch.load(f"{out_dir}/pp_one.pt", mmap=True),
                     n_chunks)
    out = _held_pieces(torch, dist, loss, list(model.named_parameters()),
                       grads, one)
    out.update(phase=f"pipeline_exactness_fp32_chunks{n_chunks}",
               tf32=False, rerun_bit_identical=True,
               model=f"GPT-124M widths, {PP_EXACT_LAYERS} layers, fp32, "
                     f"AdamW lr 1e-4; GPTForPretrainingPipe over pp "
                     f"{PP_RANKS} (n_chunks {n_chunks}, {PP_EXACT_MICRO} "
                     f"microbatches) against the unpipelined model on "
                     f"{PP_EXACT_BATCH} x 1024")
    del model, grads
    if PP_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def _pp_timed(torch, ck, dist, run, per_step, warmup=None, timed=None,
              meter_warmup=False):
    """``warmup`` + ``timed`` (PP_WARMUP + PP_TIMED) synchronized calls of
    ``run()``; K2 and K3 must launch ``per_step`` = (fwd, bwd) times a call
    on bf16. With ``meter_warmup`` the mp collectives' meter
    (``mp_layers.comm_meter``, which synchronizes around each collective)
    runs over the warm-up calls alone. Returns (losses, seconds of the
    timed calls, the slowest rank's mean ms, the warm-up's seconds)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
    warmup = PP_WARMUP if warmup is None else warmup
    timed = PP_TIMED if timed is None else timed
    losses, secs = [], []
    for i in range(warmup + timed):
        if i == 0 and meter_warmup:
            mp_layers.comm_meter(on=True, reset=True)
        if i == warmup:
            if meter_warmup:
                mp_layers.comm_meter(on=False)
            from paddle_tpu_torch.distributed import comm_plane as cp
            from paddle_tpu_torch.distributed import sep_transport
            from paddle_tpu_torch.distributed.fleet.meta_parallel import \
                spmd_pipeline
            cp.reset_pp_stats()
            cp.get_plane().reset_stats()
            sep_transport.reset_stats()
            spmd_pipeline.reset_stats()
            torch.cuda.reset_peak_memory_stats()
        before = {k.name: k.route_launches["bf16"] for k in ck.KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = (ck.FLASH_FWD.route_launches["bf16"] - before["flash_fwd"],
               ck.FLASH_BWD.route_launches["bf16"] - before["flash_bwd"])
        if got != per_step:
            raise AssertionError(f"call {i} launched K2/K3 {got}, "
                                 f"not {per_step}")
        losses.append(float(loss))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    timed = secs[warmup:]
    mean_ms = 1e3 * sum(timed) / len(timed)
    seen = []
    dist.all_gather_object(seen, mean_ms)
    return losses, timed, max(seen), secs[:warmup]


def pp_eager_gpt124m_rank(torch, ck, dist, fleet, mode):
    """GPT-124M at bench.py's widths as a 2-stage ``PipelineLayer`` (6
    blocks a stage, an untied head) through ``PipelineParallel.
    train_batch`` in ``mode``: bf16 under O2 (``amp.decorate``), AdamW lr
    1e-4, the global 16 x 1024 in 8 microbatches; the stage-boundary
    messages and bytes a step, the schedule, peak memory; K2/K3 once per
    block and microbatch."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import comm_plane as cp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import gpt_small
    cfg = gpt_small()
    _pp_strategy(fleet, mode, PP_MICRO)
    pipe = fleet.distributed_model(_pp_layer(torch, cfg))
    opt = AdamW(learning_rate=1e-4, parameters=pipe.parameters())
    amp.decorate(models=pipe, optimizers=opt, level="O2", dtype="bfloat16")
    batch = tuple(t.to(PP_DEVICE) for t in _seeded_ids(
        torch, cfg.vocab_size, (PP_BATCH, 1024), seed=74))
    blocks = cfg.num_layers // PP_RANKS
    per_step = (blocks * PP_MICRO, blocks * PP_MICRO)
    losses, secs, slowest, _ = _pp_timed(
        torch, ck, dist, lambda: pipe.train_batch(batch, opt), per_step)
    stats = cp.pp_stats()
    out = {"phase": f"pipeline_eager_gpt124m_{mode}", "stage": pipe._stage,
           "batch_global": [PP_BATCH, 1024], "microbatches": PP_MICRO,
           "step_ms_each": [1e3 * s for s in secs],
           "step_ms_slowest_rank": slowest,
           "global_tokens_per_s": PP_BATCH * 1024 / (slowest / 1e3),
           "losses": losses,
           "schedule": "".join(f"{op}{k}" for op, k in pipe._last_schedule),
           "max_inflight": pipe._last_max_inflight,
           "boundary_sends_per_step": stats["sends"] / PP_TIMED,
           "boundary_recvs_per_step": stats["recvs"] / PP_TIMED,
           "boundary_bytes_sent_per_step": stats["bytes_sent"] / PP_TIMED,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "flash_launches_per_step": list(per_step)}
    del pipe, opt
    torch.cuda.empty_cache()
    return out


def pp_spmd_gpt124m_rank(torch, ck, dist, n_chunks, remat):
    """GPT-124M at bench.py's widths as ``GPTForPretrainingPipe`` over pp
    2 through ``CompiledTrainStep`` (O2 bf16, AdamW lr 1e-4), the global
    16 x 1024 in 8 microbatches, ``n_chunks`` 1 (GPipe, 9 ticks) or 2
    (interleaved, 17 ticks, 3 layers a chunk), ``remat`` off or on: the
    pipeline's exchanges, bytes and ms a step, peak memory; K2 once per
    layer and microbatch (twice with remat), K3 once."""
    from paddle_tpu_torch.distributed import comm_plane as cp
    from paddle_tpu_torch.distributed import sep_transport
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        spmd_pipeline
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTForPretrainingPipe, gpt_small
    cfg = gpt_small()
    model = GPTForPretrainingPipe(cfg, n_microbatch=PP_MICRO,
                                  n_chunks=n_chunks, remat=remat,
                                  device=PP_DEVICE, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = CompiledTrainStep(lambda i, lb: model(i, labels=lb)[1], model,
                             opt, amp_level="O2")
    ids, labels = (t.to(PP_DEVICE) for t in _seeded_ids(
        torch, cfg.vocab_size, (PP_BATCH, 1024), seed=75))
    layers = cfg.num_layers // PP_RANKS * PP_MICRO
    per_step = (layers * (2 if remat else 1), layers)
    losses, secs, slowest, _ = _pp_timed(
        torch, ck, dist, lambda: step(ids, labels), per_step)
    ex = sep_transport.stats()
    bc = spmd_pipeline.stats()
    plane = cp.get_plane().stats()
    ticks = spmd_pipeline.pipeline_ticks(PP_MICRO, PP_RANKS, n_chunks)
    if ex["exchanges"] != 2 * ticks * PP_TIMED:
        raise AssertionError(f"{ex['exchanges']} exchanges in "
                             f"{PP_TIMED} steps, not 2 x {ticks} each")
    seen = []
    dist.all_gather_object(seen, losses)
    if seen[0] != seen[1]:
        raise AssertionError(f"the pp ranks' losses differ {seen}")
    out = {"phase": f"pipeline_spmd_gpt124m_chunks{n_chunks}"
                    f"{'_remat' if remat else ''}",
           "n_chunks": n_chunks, "remat": remat, "ticks": ticks,
           "batch_global": [PP_BATCH, 1024], "microbatches": PP_MICRO,
           "step_ms_each": [1e3 * s for s in secs],
           "step_ms_slowest_rank": slowest,
           "global_tokens_per_s": PP_BATCH * 1024 / (slowest / 1e3),
           "losses": losses,
           "exchanges_per_step": ex["exchanges"] / PP_TIMED,
           "exchange_bytes_per_step": ex["bytes"] / PP_TIMED,
           "exchange_ms_per_step": ex["ms"] / PP_TIMED,
           "broadcast_ms_per_step": bc["ms"] / PP_TIMED,
           "broadcasts_per_step": bc["collectives"] / PP_TIMED,
           # the gradient sum over pp of the parameters outside the
           # pipeline, bucketed through the comm plane
           "grad_sum_works_per_step":
               (plane["works"] - ex["exchanges"]) / PP_TIMED,
           "grad_sum_ms_per_step":
               (plane["comm_ms"] - ex["ms"]) / PP_TIMED,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "flash_launches_per_step": list(per_step)}
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def pipeline_rank(torch, out_dir):
    """One rank of the pipeline path (started by the launcher): pp 2
    after ``fleet.init``, the send probe, the fp32 steps (the eager
    schedules against ``_local_train``, the SPMD pipeline saved for the
    parent), then GPT-124M's timed steps through each eager schedule and
    each SPMD configuration. Prints one JSON line per phase and last its
    launches by route."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env(timeout=DP_RANK_TIMEOUT_S)
    _wait_ready(out_dir)
    rank, world = env.rank, env.world_size
    if dist.get_backend() != "gloo" or world != PP_RANKS:
        raise AssertionError(f"backend {dist.get_backend()}, world {world}")
    ck.reset_launch_counts()
    mesh = _hp_fleet(fleet, pp_degree=PP_RANKS)
    if mesh.shape["pp"] != PP_RANKS:
        raise AssertionError(f"mesh {mesh}")
    _rank_emit(rank, pp_send_probe(torch, mesh))
    for mode in PP_MODES:
        _rank_emit(rank, pp_eager_exact_rank(torch, fleet, mode))
    for n_chunks in (1, 2):
        _rank_emit(rank, pp_spmd_exact_rank(torch, dist, rank, out_dir,
                                            n_chunks))
    for mode in PP_MODES:
        _rank_emit(rank, pp_eager_gpt124m_rank(torch, ck, dist, fleet,
                                               mode))
    for n_chunks, remat in PP_SPMD:
        _rank_emit(rank, pp_spmd_gpt124m_rank(torch, ck, dist, n_chunks,
                                              remat))
    _rank_emit(rank, {"rank_launches": {k.name: dict(k.route_launches)
                                        for k in ck.KERNELS}})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _pp_one_process(torch, tmp):
    """The unpipelined fp32 step the ranks' SPMD pipeline steps are held
    to: ``GPTForPretrainingPipe`` at GPT-124M's widths and
    ``PP_EXACT_LAYERS`` layers from the same weights on the whole
    ``_pp_exact_batch``, as ``pp_one.pt``."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretrainingPipe
    model = GPTForPretrainingPipe(
        GPTConfig(hidden_size=768, num_layers=PP_EXACT_LAYERS, num_heads=12),
        device=PP_DEVICE, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    _one_process_step(torch, model, opt, *_pp_exact_batch(torch),
                      f"{tmp}/pp_one.pt")
    del model, opt
    if PP_DEVICE == "cuda":
        torch.cuda.empty_cache()


def phase_pipeline(torch, ck, smi):
    """The pipeline path: this process's unpipelined fp32 step, then two
    gloo ranks at pp 2 (the send probe, the fp32 steps, the SPMD ones held
    to that step, then GPT-124M through the eager schedules and the SPMD
    pipeline). The ranks' kernel launches are added to this process's
    counts."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _run_ranks(PP_RANKS, "--pipeline-rank", tmp,
                           {"PADDLE_DISTRI_BACKEND": "gloo"},
                           prepare=lambda: _pp_one_process(torch, tmp))
        t_ranks = time.perf_counter() - t0
        for rows in ranks.values():
            for row in rows[:-1]:
                emit(row)
            ck.add_launches(rows[-1]["rank_launches"])
        _exactness_held(ranks, "pipeline_exactness_fp32_", 2)
        summary = {"phase": "pipeline", "nvidia_smi": smi,
                   "ranks": PP_RANKS, "backend": "gloo",
                   "transport": "stage boundaries and pipeline exchanges "
                                "staged through the host (gloo, CUDA "
                                "tensors)",
                   "global_batch": [PP_BATCH, 1024],
                   "microbatches": PP_MICRO, "ranks_s": t_ranks}

        def both(phase):
            return [next(r for r in rows if r.get("phase") == phase)
                    for rows in ranks.values()]
        for mode in PP_MODES:
            got = both(f"pipeline_eager_gpt124m_{mode}")
            summary[f"eager_{mode}"] = {
                k: [g[k] for g in got] for k in (
                    "step_ms_slowest_rank", "global_tokens_per_s",
                    "schedule", "max_inflight", "boundary_sends_per_step",
                    "boundary_recvs_per_step",
                    "boundary_bytes_sent_per_step", "peak_memory_bytes",
                    "flash_launches_per_step")}
        for n_chunks, remat in PP_SPMD:
            name = f"pipeline_spmd_gpt124m_chunks{n_chunks}" \
                   f"{'_remat' if remat else ''}"
            got = both(name)
            summary[name[9:]] = {
                k: [g[k] for g in got] for k in (
                    "step_ms_slowest_rank", "global_tokens_per_s", "ticks",
                    "exchanges_per_step", "exchange_bytes_per_step",
                    "exchange_ms_per_step", "broadcasts_per_step",
                    "broadcast_ms_per_step", "grad_sum_works_per_step",
                    "grad_sum_ms_per_step", "peak_memory_bytes",
                    "flash_launches_per_step")}
        emit(summary)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- the gradient's way between ranks (grad_comm) -----------------------------
# GPT-124M at bench.py's widths, O2 bf16. GradientMerge runs in this
# process (AdamW with a global-norm clip, k 4, avg: 4 microbatches of
# [4, 1024] an applied step); then two gloo ranks share the card, each on
# its own 8 x 1024 rows: LocalSGD (the same AdamW, k 4), DGC (SGD lr 1e-4,
# momentum 0.9, sparsity 0.999, ramp-up 1), the quantized data-parallel
# step (fleet.init with comm_quant, the eager fp16 recipe), ERNIE's
# quantized ZeRO-3 gather at sharding 2, dcn_grad_sync of GPT-124M's
# gradients at dcn 2, and TP GPT-124M at mp 2 with ClipGradByNorm. Each
# has its fp32 gate at 2 layers; this process holds the ranks' ones to
# one process. (GC_ATTENTION stands beside FLASH_CASES)
GC_WARMUP, GC_TIMED = 1, 1
GC_CLIP_EXACT = 0.01        # the fp32 TP step's ClipGradByNorm


def _gc_gpt124m(torch, make_opt, seed=0):
    """GPT-124M (bench.py's widths) decorated O2 bf16 with the optimizer
    ``make_opt(parameters)``; returns (config, model, optimizer)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", seed=seed)
    model, opt = amp.decorate(model, make_opt(model.parameters()),
                              level="O2", dtype="bfloat16")
    return cfg, model, opt


def _gc_loss(model, ids, labels):
    from paddle_tpu_torch import amp
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        return model(ids, labels=labels)[1]


def _bf16_launches(ck):
    return {k.name: k.route_launches["bf16"] for k in ck.KERNELS}


def _check_launches(ck, before, n, what):
    got = {k: v - before[k] for k, v in _bf16_launches(ck).items()}
    if got["flash_fwd"] != n or got["flash_bwd"] != n:
        raise AssertionError(f"{what} launched {got} on bf16, not {n} each")


def _gpt2_fp32(torch, make_opt, seed=0, **kw):
    """GPT-124M's widths at 2 layers, fp32, on the card, with
    ``make_opt(named parameters)``."""
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    model = GPTForPretraining(GPTConfig(hidden_size=768, num_layers=2,
                                        num_heads=12, **kw), device="cuda",
                              seed=seed)
    return model, make_opt(model.named_parameters())


def _deltas_held(torch, got, before, model):
    """Updated parameters against this process's ``model``, both from the
    weights ``before``: every entry of each update (p - p0) within 1e-5
    of that update's largest entry, plus two fp32 ulps of p0 (the
    rounding of p0 + update on each side: an update far below p0, as a
    LayerNorm weight's next to its 1.0, keeps only the bits p0 leaves).
    Returns the worst error over its tolerance."""
    ratio = {}
    for n, p in model.named_parameters():
        p0 = before[n].double()
        want = p.detach().cpu().double() - p0
        have = got[n].double() - p0
        tol = 1e-5 * float(want.abs().max()) + 2 * 2.0 ** -23 * p0.abs()
        err = (have - want).abs()
        ratio[n] = float((err / tol.clamp(min=1e-30)).max())
    worst = max(ratio, key=ratio.get)
    return {"delta_max_err_over_tol": ratio[worst], "delta_worst": worst,
            "rule": "|update_got - update_one| <= 1e-5 max|update_one| + "
                    "2 ulp(p0), every entry",
            "held": ratio[worst] <= 1.0}


def gc_gradient_merge(torch, ck):
    """GradientMerge at GPT-124M's widths in this process (AdamW lr 1e-4
    with ClipGradByGlobalNorm(1.0), k 4, avg), 2 warm-up + 4 timed
    applied steps of 4 microbatches of [4, 1024]: the merge's return
    values, one inner AdamW step an applied step, K2/K3 once per layer
    and microbatch."""
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        GradientMergeOptimizer)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    cfg, model, inner = _gc_gpt124m(torch, lambda ps: AdamW(
        learning_rate=1e-4, parameters=ps,
        grad_clip=ClipGradByGlobalNorm(1.0)))
    opt = GradientMergeOptimizer(inner, k_steps=GC_K, avg=True)
    applied = [0]
    inner_step = inner.step

    def counted():
        applied[0] += 1
        return inner_step()
    inner.step = counted
    steps = GC_WARMUP + GC_TIMED
    ids, labels = (t.cuda() for t in _seeded_ids(
        torch, cfg.vocab_size, (steps, GC_K, GC_MICRO, cfg.max_seq_len),
        seed=60))
    secs, losses, flags = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        before = _bf16_launches(ck)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        micro = []
        for j in range(GC_K):
            loss = _gc_loss(model, ids[i, j], labels[i, j])
            loss.backward()
            flags.append(opt.step())
            micro.append(loss.detach())
        opt.clear_grad()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        _check_launches(ck, before, cfg.num_layers * GC_K,
                        f"applied step {i}")
        losses.append([x.item() for x in micro])
    if flags != ([False] * (GC_K - 1) + [True]) * steps:
        raise AssertionError(f"GradientMerge returned {flags}")
    if applied[0] != steps:
        raise AssertionError(f"{applied[0]} inner steps for {steps}")
    if not all(math.isfinite(x) for row in losses for x in row):
        raise AssertionError(f"non-finite losses {losses}")
    timed = secs[GC_WARMUP:]
    step_s = sum(timed) / len(timed)
    out = {"phase": "grad_comm_gradient_merge", "k_steps": GC_K,
           "microbatch": [GC_MICRO, cfg.max_seq_len],
           "applied_step_ms": step_s * 1e3,
           "applied_step_ms_each": [s * 1e3 for s in secs],
           "tokens_per_s": GC_K * GC_MICRO * cfg.max_seq_len / step_s,
           "inner_adamw_steps_per_applied_step": applied[0] / steps,
           "flash_launches_per_applied_step": [cfg.num_layers * GC_K] * 2,
           "losses": losses,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del model, inner, opt
    torch.cuda.empty_cache()
    return out


def gc_gradient_merge_exactness(torch):
    """fp32, 2 layers: GradientMerge (AdamW lr 1e-4, k 4, avg) over four
    microbatches of [4, 1024] against one AdamW step on the [16, 1024]
    batch from the same weights, by ``_held_to_one_process``."""
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        GradientMergeOptimizer)
    from paddle_tpu_torch.optimizer import AdamW
    adamw = lambda ps: AdamW(learning_rate=1e-4, parameters=ps)  # noqa: E731
    model, opt = _gpt2_fp32(torch, adamw)
    ids, labels = (t.cuda() for t in _seeded_ids(
        torch, model.config.vocab_size,
        (GC_K * GC_MICRO, model.config.max_seq_len), seed=61))
    loss = model(ids, labels=labels)[1]
    loss.backward()
    grads = {n: p.grad.detach().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    opt.step()
    gm_model, inner = _gpt2_fp32(torch, adamw)
    gm = GradientMergeOptimizer(inner, k_steps=GC_K, avg=True)
    micro = []
    for j in range(GC_K):
        rows = slice(j * GC_MICRO, (j + 1) * GC_MICRO)
        part = gm_model(ids[rows], labels=labels[rows])[1]
        part.backward()
        gm.step()
        micro.append(part.item())
    got_grads = {n: p.grad.detach().cpu()
                 for n, p in gm_model.named_parameters()
                 if p.grad is not None}
    got_params = {n: p.detach().cpu() for n, p in gm_model.named_parameters()}
    out = _held_to_one_process(torch, sum(micro) / GC_K, got_grads,
                               got_params, loss.item(), grads, model)
    out.update(phase="grad_comm_gradient_merge_exactness_fp32", tf32=False,
               model="GPT-124M widths, 2 layers, fp32, AdamW lr 1e-4; "
                     "GradientMerge k 4 over [4, 1024] microbatches "
                     "against one step on [16, 1024]")
    out["loss_merged"] = out.pop("loss_got")
    emit(out)
    del model, opt, gm_model, inner, gm
    torch.cuda.empty_cache()
    if not out["held"]:
        raise AssertionError(f"GradientMerge differs from one step: {out}")


def _ranks_max_diff(torch, dist, tensors):
    """max |a - b| over the ranks' ``tensors`` (two ranks: the elementwise
    MAX minus MIN of their values, flattened in fp32)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    hi, lo = flat.clone(), flat
    dist.all_reduce(hi, dist.ReduceOp.MAX)
    dist.all_reduce(lo, dist.ReduceOp.MIN)
    return float((hi - lo).max())


def gc_local_sgd_rank(torch, ck, dist, rank):
    """LocalSGD (AdamW lr 1e-4, ClipGradByGlobalNorm(1.0), k 4) on GPT-124M
    O2 bf16, this rank's 8 x 1024 rows, 8 steps: the parameters must be
    bit-equal across the ranks right after each sync (steps 4 and 8); the
    fp32 master weights are not averaged, and their largest difference
    between the ranks is recorded after each sync."""
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        LocalSGDOptimizer)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    cfg, model, inner = _gc_gpt124m(torch, lambda ps: AdamW(
        learning_rate=1e-4, parameters=ps,
        grad_clip=ClipGradByGlobalNorm(1.0)))
    opt = LocalSGDOptimizer(inner, k_steps=GC_K)
    ids, labels = (t.cuda() for t in _seeded_ids(
        torch, cfg.vocab_size, (GC_RANKS * GC_RANK_BATCH, cfg.max_seq_len),
        seed=70))
    rows = slice(rank * GC_RANK_BATCH, (rank + 1) * GC_RANK_BATCH)
    params = list(inner._parameter_list())
    secs, losses, master_diff = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    for i in range(2 * GC_K):
        before = _bf16_launches(ck)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _gc_loss(model, ids[rows], labels[rows])
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        _check_launches(ck, before, cfg.num_layers, f"LocalSGD step {i}")
        losses.append(loss.item())
        if (i + 1) % GC_K == 0:
            _same_on_ranks(dist, f"parameters after LocalSGD step {i + 1}",
                           _digest(params))
            master_diff[i + 1] = _ranks_max_diff(torch, dist, [
                inner._accumulators[id(p)]["master_weight"]
                for p in params])
    sync = [secs[i] for i in range(GC_WARMUP, 2 * GC_K) if (i + 1) % GC_K == 0]
    local = [secs[i] for i in range(GC_WARMUP, 2 * GC_K) if (i + 1) % GC_K]
    out = {"phase": "grad_comm_local_sgd", "k_steps": GC_K,
           "batch_per_rank": [GC_RANK_BATCH, cfg.max_seq_len],
           "step_ms_each": [s * 1e3 for s in secs],
           "sync_step_ms": 1e3 * sum(sync) / len(sync),
           "local_step_ms": 1e3 * sum(local) / len(local),
           "bytes_per_sync": 4 * sum(p.numel() for p in params),
           "master_weight_max_diff_between_ranks": master_diff,
           "losses": losses,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del model, inner, opt, params
    torch.cuda.empty_cache()
    return out


def gc_dgc_rank(torch, ck, dist, rank):
    """DGC (SGD lr 1e-4 inside momentum 0.9, sparsity 0.999, ramp-up 1) on
    GPT-124M O2 bf16, this rank's 8 x 1024 rows, 2 warm-up + 4 timed
    steps; then one metered step: each rank's sent entries and the
    averaged gradient's, per parameter against k = max(numel·0.001, 1);
    the ranks' parameters bit-equal; the masks' time (top-k and compare)
    over every parameter's v."""
    from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta
    from paddle_tpu_torch.optimizer import SGD
    cfg, model, inner = _gc_gpt124m(torch, lambda ps: SGD(
        learning_rate=1e-4, parameters=ps))
    opt = meta.DGCOptimizer(inner, momentum=0.9, sparsity=0.999,
                            rampup_begin_step=1)
    ids, labels = (t.cuda() for t in _seeded_ids(
        torch, cfg.vocab_size, (GC_RANKS * GC_RANK_BATCH, cfg.max_seq_len),
        seed=71))
    rows = slice(rank * GC_RANK_BATCH, (rank + 1) * GC_RANK_BATCH)
    params = list(inner._parameter_list())

    def one_step():
        loss = _gc_loss(model, ids[rows], labels[rows])
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    secs, losses = [], []
    for i in range(GC_WARMUP + GC_TIMED):
        before = _bf16_launches(ck)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = one_step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        _check_launches(ck, before, cfg.num_layers, f"DGC step {i}")
        losses.append(loss.item())
    # the masks' time over the current v of every parameter
    vs = [opt._v[id(p)] for p in params if id(p) in opt._v]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for v in vs:
        opt.mask(v)
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    # one metered step: the sends and their average, counted
    seen = []
    real = meta._average

    def metered(ts):
        avg = real(ts)
        seen.append(([int((t != 0).sum()) for t in ts],
                     [int((a != 0).sum()) for a in avg]))
        return avg
    meta._average = metered
    try:
        before = _bf16_launches(ck)
        one_step()
        _check_launches(ck, before, cfg.num_layers, "the metered DGC step")
    finally:
        meta._average = real
    _same_on_ranks(dist, "parameters after DGC", _digest(params))
    sent, averaged = seen[0]
    ks = [max(int(p.numel() * (1 - 0.999)), 1) for p in params]
    both = []
    dist.all_gather_object(both, sent)
    union = [a + b for a, b in zip(*both)]
    if any(s < k for s, k in zip(sent, ks)) or \
            any(a > u for a, u in zip(averaged, union)):
        raise AssertionError("DGC's sends break their bounds")
    timed = secs[GC_WARMUP:]
    out = {"phase": "grad_comm_dgc", "sparsity": 0.999, "momentum": 0.9,
           "batch_per_rank": [GC_RANK_BATCH, cfg.max_seq_len],
           "step_ms": 1e3 * sum(timed) / len(timed),
           "step_ms_each": [s * 1e3 for s in secs],
           "topk_ms_per_step": mask_s * 1e3, "topk_calls_per_step": len(vs),
           "bytes_per_step": 4 * sum(p.numel() for p in params),
           "k_total": sum(ks), "sent_total": sum(sent),
           "sent_above_k_ties": sum(s - k for s, k in zip(sent, ks)),
           "averaged_nonzero_total": sum(averaged),
           "numel_total": sum(p.numel() for p in params),
           "losses": losses}
    del model, inner, opt, params, vs
    torch.cuda.empty_cache()
    return out


def gc_meta_exact_rank(torch, dist, rank, out_dir):
    """fp32, 2 layers, this rank's 8 of the global 16 x 1024 rows: one
    LocalSGD step (k 1, SGD lr 1) and one DGC step (ramp-up 0, sparsity 0,
    momentum 0, SGD lr 1); rank 0 saves both updated parameter sets for
    the parent's one-process SGD step."""
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        DGCOptimizer, LocalSGDOptimizer)
    from paddle_tpu_torch.optimizer import SGD
    sgd = lambda ps: SGD(learning_rate=1.0, parameters=ps)  # noqa: E731
    saved = {}
    for mode, wrap in (("local_sgd", lambda o: LocalSGDOptimizer(o, 1)),
                       ("dgc", lambda o: DGCOptimizer(
                           o, momentum=0.0, sparsity=0.0,
                           rampup_begin_step=0))):
        model, opt = _gpt2_fp32(torch, sgd)
        opt = wrap(opt)
        ids, labels = _seeded_ids(torch, model.config.vocab_size,
                                  (GC_RANKS * GC_RANK_BATCH,
                                   model.config.max_seq_len), seed=80)
        rows = slice(rank * GC_RANK_BATCH, (rank + 1) * GC_RANK_BATCH)
        model(ids[rows].cuda(), labels=labels[rows].cuda())[1].backward()
        opt.step()
        saved[mode] = {n: p.detach().cpu()
                       for n, p in model.named_parameters()}
        _same_on_ranks(dist, f"{mode} fp32 parameters",
                       _digest(model.parameters()))
        del model, opt
    if rank == 0:
        torch.save(saved, f"{out_dir}/gc_meta_exact.pt")
    torch.cuda.empty_cache()
    return {"phase": "grad_comm_meta_exact_rank"}


def gc_quant_dp_rank(torch, ck, dist, fleet, rank):
    """``fleet.init`` with ``strategy.comm_quant`` (int8, blocks of 256,
    fp32 scales), ``fleet.distributed_model`` over GPT-124M in the eager
    fp16 recipe (``dp_gpt124m_rank``'s: O2 fp16, ``GradScaler(2**15)``,
    AdamW under the warm-up/cosine schedule with a global-norm clip), this
    rank's 8 x 1024 rows, 2 warm-up + 4 timed steps: every bucket synced
    through the quantized schedule; then the fp32 gate (2 layers, 2 x 1024
    a rank): the synced gradients against the fp32 all-reduce of the same
    local gradients, within two wire crossings (max |g| / 127), and
    bit-equal on both ranks."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.distributed import comm_plane
    from paddle_tpu_torch.distributed import comm_quant as cq
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": GC_RANKS}
    strategy.comm_quant = True
    fleet.init(is_collective=True, strategy=strategy)
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    sched = amp_schedule(popt.lr)
    opt = popt.AdamW(learning_rate=sched, parameters=model.parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    dp = fleet.distributed_model(model)
    ids, labels = (t.cuda() for t in _seeded_ids(
        torch, cfg.vocab_size, (GC_RANKS * GC_RANK_BATCH, cfg.max_seq_len),
        seed=72))
    rows = slice(rank * GC_RANK_BATCH, (rank + 1) * GC_RANK_BATCH)
    plane = comm_plane.get_plane()
    secs, losses = [], []
    for i in range(GC_WARMUP + GC_TIMED):
        if i == GC_WARMUP:
            plane.reset_stats()
        before = {k.name: k.route_launches["fp16"] for k in ck.KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with amp.auto_cast(level="O2", dtype="float16"):
            _, loss = dp(ids[rows], labels=labels[rows])
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        sched.step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = {k.name: k.route_launches["fp16"] - before[k.name]
               for k in ck.KERNELS}
        if got["flash_fwd"] != cfg.num_layers or \
                got["flash_bwd"] != cfg.num_layers:
            raise AssertionError(f"quantized DP step {i} launched {got}")
        losses.append(loss.item())
    stats = plane.stats()
    _same_on_ranks(dist, "parameters after the quantized DP steps",
                   _digest(model.parameters()))
    if dp._quant_sync_count != GC_WARMUP + GC_TIMED:
        raise AssertionError(f"{dp._quant_sync_count} quantized syncs")
    qcfg = cq.get_active_config()
    wire = sum(cq.wire_nbytes((b.layout(qcfg.block_size)[1],), qcfg)
               for b in dp._buckets)
    dense = 4 * sum(b.nelem for b in dp._buckets)
    timed = secs[GC_WARMUP:]
    out = {"phase": "grad_comm_quantized_dp",
           "comm_quant": {"dtype": qcfg.dtype, "block_size": qcfg.block_size,
                          "scale_dtype": qcfg.scale_dtype},
           "batch_per_rank": [GC_RANK_BATCH, cfg.max_seq_len],
           "step_ms": 1e3 * sum(timed) / len(timed),
           "step_ms_each": [s * 1e3 for s in secs], "losses": losses,
           "comm_plane_per_step": {k: v / GC_TIMED if k != "overlap_"
                                   "efficiency" else v
                                   for k, v in stats.items()},
           "wire_bytes_per_step": wire, "fp32_bytes_per_step": dense,
           "wire_over_fp32": wire / dense, "buckets": len(dp._buckets)}
    del dp, model, opt, scaler
    torch.cuda.empty_cache()
    out.update(_gc_quant_dp_exact(torch, dist, fleet, rank, cq))
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    if cq.get_active_config() is not None:
        raise AssertionError("fleet.init left the comm_quant config active")
    return out


def _gc_quant_dp_exact(torch, dist, fleet, rank, cq):
    """The quantized sync's fp32 gate: (worst error / bound, held)."""
    from paddle_tpu_torch.optimizer import AdamW
    model, _ = _gpt2_fp32(torch, lambda ps: AdamW(parameters=ps))
    ids, labels = _seeded_ids(torch, model.config.vocab_size,
                              (GC_RANKS * 2, model.config.max_seq_len),
                              seed=73)
    ids, labels = (t[rank * 2:(rank + 1) * 2].cuda() for t in (ids, labels))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    local = torch.autograd.grad(model(ids, labels=labels)[1],
                                [p for _, p in named])
    dp = fleet.distributed_model(model)
    dp(ids, labels=labels)[1].backward()
    worst, bad = 0.0, []
    for (n, p), g in zip(named, local):
        exact = g.clone()
        dist.all_reduce(exact, dist.ReduceOp.AVG)
        top = g.abs().max().reshape(1)
        dist.all_reduce(top, dist.ReduceOp.MAX)
        bound = float(top) / 127
        err = float((p.grad - exact).abs().max())
        worst = max(worst, err / bound if bound else err)
        if err > bound:
            bad.append(n)
    _same_on_ranks(dist, "the quantized fp32 gradients",
                   _digest([p.grad for _, p in named]))
    held = not bad and dp._quant_sync_count == 1
    if not held:
        raise AssertionError(f"quantized sync past its bound: {bad}")
    del model, dp
    torch.cuda.empty_cache()
    return {"fp32_gate": "2 layers, 2 x 1024 a rank: synced gradients "
                         "against the fp32 all-reduce, each element within "
                         "max |g| / 127 (two wire crossings)",
            "fp32_worst_err_over_bound": worst, "fp32_held": held}


def gc_zero3_gather_rank(torch, dist, fleet, rank):
    """ERNIE-3.0-base under ``group_sharded_parallel(..., "p_g_os")`` at
    sharding 2, as ``hp_ernie_zero3_rank`` builds it, in the reference's
    order: a config active, ``get_all_parameters(quant=False)`` (bit-equal
    to the whole state), re-shard, ``get_all_parameters()`` through the
    config (bit-equal to the codec of each whole value, so within half a
    block's scale of it, and equal on both ranks); ms and bytes of each."""
    from paddle_tpu_torch.distributed import comm_quant as cq
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        group_sharded_parallel)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.ernie import ErnieForPretraining
    _hp_fleet(fleet, sharding_degree=2)
    model = ErnieForPretraining(ernie_config(), device="cuda", seed=0)
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    net, _, _ = group_sharded_parallel(model, opt, "p_g_os")
    rows_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters()
                     if getattr(p, "_zero", None) is not None)
    cfg = cq.set_active_config(cq.QuantConfig())
    try:
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.get_all_parameters(quant=False)
        torch.cuda.synchronize()
        exact_s = time.perf_counter() - t0
        for n, p in model.named_parameters():
            if not torch.equal(p.detach(), whole[n]):
                raise AssertionError(f"the exact gather changed {n}")
        net._shard_params()
        cq.reset_stats()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.get_all_parameters()
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        sent = cq.stats()["bytes"]
    finally:
        cq.set_active_config(None)
    worst = 0.0
    for n, p in model.named_parameters():
        want = cq.quantization_roundtrip(whole[n], cfg, traced=True)
        if not torch.equal(p.detach(), want):
            raise AssertionError(f"the quantized gather of {n} is not the "
                                 "codec of the whole value")
        q, s = cq.quantize_blockwise(whole[n], cfg, traced=True)
        pad = (0, q.numel() - p.numel())
        w = torch.nn.functional.pad(whole[n].float().reshape(-1), pad)
        err = torch.nn.functional.pad(
            (p.detach().float() - whole[n].float()).abs().reshape(-1), pad)
        # half a block's scale, and the rounding of x times the scale's
        # reciprocal and of the decode's product (2^-21 of |x|)
        bound = (s.float() / 2)[:, None].expand(q.shape).reshape(-1) + \
            w.abs() * 2.0 ** -21
        worst = max(worst, float((err - bound).max()))
    if worst > 0:
        raise AssertionError(f"an element past half its scale: {worst}")
    _same_on_ranks(dist, "the quantized ZeRO-3 gather",
                   _digest(model.parameters()))
    out = {"phase": "grad_comm_zero3_gather", "sharding": 2,
           "model": "ERNIE-3.0-base, fp32",
           "exact_gather_ms": exact_s * 1e3, "quant_gather_ms": quant_s * 1e3,
           "exact_bytes_sent_per_rank": rows_bytes,
           "quant_bytes_sent_per_rank": sent,
           "quant_over_exact": sent / rows_bytes,
           "params": len(whole)}
    del model, opt, net, whole
    torch.cuda.empty_cache()
    return out


def gc_dcn_rank(torch, dist, fleet, rank):
    """``fleet.init`` at dcn 2 (``dcn_dp_degree``): GPT-124M's fp32
    gradients of this rank's 2 x 1024 rows as one flat tensor through
    ``dcn_grad_sync``: fp32 bit-equal to ``all_reduce`` AVG, int8 within
    max |g| / 127 of it, each also with ``async_op`` (bit-equal to the
    sync result); ms and bytes of each."""
    from paddle_tpu_torch.distributed import comm_quant as cq
    from paddle_tpu_torch.distributed.sharding_api import dcn_grad_sync
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    mesh = _hp_fleet(fleet, dcn_dp_degree=2)
    if mesh.shape.get("dcn") != 2 or mesh.group("dcn").nranks != 2:
        raise AssertionError(f"no dcn axis of 2 in {mesh}")
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    ids, labels = _seeded_ids(torch, cfg.vocab_size,
                              (GC_RANKS * 2, cfg.max_seq_len), seed=74)
    model(ids[rank * 2:(rank + 1) * 2].cuda(),
          labels=labels[rank * 2:(rank + 1) * 2].cuda())[1].backward()
    flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    del model
    ref = flat.clone()
    dist.all_reduce(ref, dist.ReduceOp.AVG)
    top = flat.abs().max().reshape(1)
    dist.all_reduce(top, dist.ReduceOp.MAX)
    q8 = cq.QuantConfig()
    ms, got = {}, {}
    for name, quant, async_op in (("fp32", None, False), ("int8", q8, False),
                                  ("fp32_async", None, True),
                                  ("int8_async", q8, True)):
        cq.reset_stats()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dcn_grad_sync(flat, mesh, quant=quant, async_op=async_op)
        if async_op:
            ms[name + "_launch"] = (time.perf_counter() - t0) * 1e3
            out = out.result()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        got[name] = out
        if quant is not None and not async_op:
            ms["int8_bytes_sent"] = cq.stats()["bytes"]
    err = float((got["int8"] - ref).abs().max())
    checks = {"fp32_equals_all_reduce_avg": torch.equal(got["fp32"], ref),
              "fp32_async_equals_sync": torch.equal(got["fp32_async"],
                                                    got["fp32"]),
              "int8_async_equals_sync": torch.equal(got["int8_async"],
                                                    got["int8"]),
              "int8_within_bound": err <= float(top) / 127}
    _same_on_ranks(dist, "dcn_grad_sync's int8 result",
                   _digest([got["int8"]]))
    if not all(checks.values()):
        raise AssertionError(f"dcn_grad_sync: {checks}")
    out = {"phase": "grad_comm_dcn", "dcn": 2, "elements": flat.numel(),
           "fp32_bytes": 4 * flat.numel(),
           "int8_wire_bytes": cq.wire_nbytes((flat.numel(),), q8),
           "ms": ms, "int8_max_err": err, "int8_bound": float(top) / 127,
           **checks}
    del flat, ref, got
    torch.cuda.empty_cache()
    return out


def gc_tp_clip_rank(torch, ck, dist, fleet, rank, out_dir):
    """``fleet.init`` at mp 2: TP GPT-124M (O2 bf16, AdamW lr 1e-4 with
    ClipGradByNorm(1.0), the global 8 x 1024) through
    ``CompiledTrainStep``, 2 warm-up + 4 timed calls; then the fp32 gate:
    the 2-layer TP GPT, one SGD step (lr 1, ClipGradByNorm(GC_CLIP_EXACT),
    a norm most of its gradients pass, so the clip acts) on the global
    4 x 1024, whose gathered parameters rank 0 saves."""
    from paddle_tpu_torch.distributed.sharding_api import gather_global
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByNorm
    from paddle_tpu_torch.optimizer import SGD, AdamW
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    _hp_fleet(fleet, mp_degree=2)
    cfg = gpt_small(tensor_parallel=True)
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                grad_clip=ClipGradByNorm(1.0))
    step = CompiledTrainStep(lambda ids, labels: model(ids, labels=labels)[1],
                             model, opt, amp_level="O2")
    ids, labels = (t.cuda() for t in _seeded_ids(
        torch, cfg.vocab_size, (GC_RANK_BATCH, cfg.max_seq_len), seed=75))
    losses, secs = _timed_training(torch, ck, step, (ids, labels),
                                   cfg.num_layers, warmup=GC_WARMUP,
                                   timed=GC_TIMED)
    del model, opt, step
    torch.cuda.empty_cache()
    clip = ClipGradByNorm(GC_CLIP_EXACT)
    model, opt = _gpt2_fp32(torch, lambda ps: SGD(
        learning_rate=1.0, parameters=ps, grad_clip=clip),
        tensor_parallel=True)
    ids, labels = _seeded_ids(torch, model.config.vocab_size,
                              (4, model.config.max_seq_len), seed=76)
    CompiledTrainStep(lambda a, b: model(a, labels=b)[1], model, opt)(
        ids.cuda(), labels.cuda())
    params = {n: gather_global(p) for n, p in model.named_parameters()}
    if rank == 0:
        torch.save(params, f"{out_dir}/gc_tp_clip.pt")
    timed = secs[GC_WARMUP:]
    del model, opt, params
    torch.cuda.empty_cache()
    return {"phase": "grad_comm_tp_clip_by_norm", "mp": 2,
            "batch_global": [GC_RANK_BATCH, cfg.max_seq_len],
            "step_ms": 1e3 * sum(timed) / len(timed),
            "step_ms_each": [1e3 * s for s in secs], "losses": losses,
            "flash_launches_per_step": [cfg.num_layers] * 2}


def grad_comm_rank(torch, out_dir):
    """One rank of the grad_comm path (started by the launcher): LocalSGD,
    DGC, their fp32 step, the quantized DP step, the quantized ZeRO-3
    gather, dcn_grad_sync and TP with ClipGradByNorm. Prints one JSON line
    per phase and last its launches by route."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env(timeout=DP_RANK_TIMEOUT_S)
    _wait_ready(out_dir)
    rank, world = env.rank, env.world_size
    if dist.get_backend() != "gloo" or world != GC_RANKS:
        raise AssertionError(f"backend {dist.get_backend()}, world {world}")
    ck.reset_launch_counts()
    _hp_fleet(fleet, dp_degree=GC_RANKS)
    for phase in (lambda: gc_local_sgd_rank(torch, ck, dist, rank),
                  lambda: gc_dgc_rank(torch, ck, dist, rank),
                  lambda: gc_meta_exact_rank(torch, dist, rank, out_dir),
                  lambda: gc_quant_dp_rank(torch, ck, dist, fleet, rank),
                  lambda: gc_zero3_gather_rank(torch, dist, fleet, rank),
                  lambda: gc_dcn_rank(torch, dist, fleet, rank),
                  lambda: gc_tp_clip_rank(torch, ck, dist, fleet, rank,
                                          out_dir)):
        t0 = time.perf_counter()
        row = phase()
        _rank_emit(rank, dict(row, seconds=time.perf_counter() - t0))
    _rank_emit(rank, {"rank_launches": {k.name: dict(k.route_launches)
                                        for k in ck.KERNELS}})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_grad_comm_exactness(torch, tmp):
    """The ranks' fp32 LocalSGD (k 1) and DGC (dense) steps against one SGD
    step (lr 1) on the global 16 x 1024, and their TP step with
    ClipGradByNorm against one process's on 4 x 1024, each by its update
    (``_deltas_held``)."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByNorm
    from paddle_tpu_torch.optimizer import SGD
    rows = []
    for name, seed, batch, clip in (("meta", 80, GC_RANKS * GC_RANK_BATCH,
                                     None),
                                    ("tp_clip", 76, 4,
                                     ClipGradByNorm(GC_CLIP_EXACT))):
        model, opt = _gpt2_fp32(torch, lambda ps: SGD(
            learning_rate=1.0, parameters=ps, grad_clip=clip))
        before = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        ids, labels = _seeded_ids(torch, model.config.vocab_size,
                                  (batch, model.config.max_seq_len),
                                  seed=seed)
        norms = None
        if clip is None:
            model(ids.cuda(), labels=labels.cuda())[1].backward()
            opt.step()
        else:
            step = CompiledTrainStep(lambda a, b: model(a, labels=b)[1],
                                     model, opt)
            real, seen = step._sync, {}
            step._sync = lambda g: seen.setdefault("grads", real(g))
            step(ids.cuda(), labels.cuda())
            norms = [float(g.float().norm()) for g in seen["grads"]]
        if name == "meta":
            got = torch.load(f"{tmp}/gc_meta_exact.pt")
            cases = [("local_sgd", got["local_sgd"]), ("dgc", got["dgc"])]
        else:
            cases = [("tp_clip_by_norm", torch.load(f"{tmp}/gc_tp_clip.pt"))]
        for mode, params in cases:
            out = _deltas_held(torch, params, before, model)
            out.update(phase=f"grad_comm_exactness_fp32_{mode}", tf32=False)
            if norms is not None:
                out["clip_norm"] = GC_CLIP_EXACT
                out["params_clipped"] = sum(n > GC_CLIP_EXACT
                                            for n in norms)
                out["params"] = len(norms)
            emit(out)
            rows.append(out)
        del model, opt
        torch.cuda.empty_cache()
    bad = [r["phase"] for r in rows if not r["held"]]
    if bad:
        raise AssertionError(f"grad_comm steps differ from one process: "
                             f"{bad}")


def phase_grad_comm(torch, ck, smi):
    """The grad_comm path: GradientMerge and its fp32 gate in this process,
    then two gloo ranks (LocalSGD, DGC, the quantized DP step, the
    quantized ZeRO-3 gather, dcn_grad_sync, TP with ClipGradByNorm), then
    this process's one-process steps against the ranks' fp32 steps. The
    ranks' kernel launches are added to this process's counts."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gc_")
    try:
        torch.cuda.empty_cache()
        gm = gc_gradient_merge(torch, ck)
        emit(gm)
        gc_gradient_merge_exactness(torch)
        t0 = time.perf_counter()
        ranks = _run_ranks(GC_RANKS, "--grad-comm-rank", tmp,
                           {"PADDLE_DISTRI_BACKEND": "gloo"})
        t_ranks = time.perf_counter() - t0
        for rows in ranks.values():
            for row in rows[:-1]:
                emit(row)
            ck.add_launches(rows[-1]["rank_launches"])
        phase_grad_comm_exactness(torch, tmp)

        def both(phase, *keys):
            got = [next(r for r in rows if r.get("phase") == phase)
                   for rows in ranks.values()]
            return {k: [g[k] for g in got] for k in keys}
        emit({"phase": "grad_comm", "nvidia_smi": smi, "ranks": GC_RANKS,
              "backend": "gloo",
              "gradient_merge": {k: gm[k] for k in (
                  "applied_step_ms", "tokens_per_s",
                  "inner_adamw_steps_per_applied_step",
                  "flash_launches_per_applied_step")},
              "local_sgd": both("grad_comm_local_sgd", "sync_step_ms",
                                "local_step_ms", "bytes_per_sync",
                                "master_weight_max_diff_between_ranks"),
              "dgc": both("grad_comm_dgc", "step_ms", "topk_ms_per_step",
                          "bytes_per_step", "sent_total",
                          "averaged_nonzero_total"),
              "quantized_dp": both("grad_comm_quantized_dp", "step_ms",
                                   "wire_bytes_per_step",
                                   "fp32_bytes_per_step", "wire_over_fp32",
                                   "comm_plane_per_step",
                                   "fp32_worst_err_over_bound"),
              "zero3_gather": both("grad_comm_zero3_gather",
                                   "exact_gather_ms", "quant_gather_ms",
                                   "exact_bytes_sent_per_rank",
                                   "quant_bytes_sent_per_rank"),
              "dcn": both("grad_comm_dcn", "ms", "fp32_bytes",
                          "int8_wire_bytes", "int8_max_err", "int8_bound"),
              "tp_clip_by_norm": both("grad_comm_tp_clip_by_norm",
                                      "step_ms"),
              "ranks_s": t_ranks})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the auto_parallel path: GPT-124M at bench.py's widths trained by the
# semi-auto Engine at O0 (fp32, as the reference's Engine runs) on
# ProcessMesh([0, 1], ["mp"]), two gloo ranks sharing the card; each block
# placed as tests/test_auto_parallel.py:142-148 places its one block, wte
# Shard(0); the global 8 x 1024 through shard_dataloader, split over mp
# (the mesh's first dim): each rank [4, 1024], K2/K3 on their fp32 route at
# DP_ATTENTION's dp_exact_one_process shape (held to the plain versions
# there); the fp32 gate at 2 layers, 3 steps; the fleet executor's
# GPT-124M bf16 forward in 4 stages over 8 microbatches of [2, 1024]
# (PP_ATTENTION's shape)
AP_RANKS, AP_BATCH, AP_WARMUP, AP_TIMED = 2, 8, 1, 2
AP_EXACT_LAYERS, AP_EXACT_STEPS = 2, 3
AP_MICRO, AP_MICRO_ROWS = 8, 2
AP_ATTENTION = ("ap_engine_rank", AP_BATCH // AP_RANKS, 1024, 1024, 12, 12,
                64, True)
AP_RESHARD_SHAPE = (768, 2304)
AP_DEVICE = "cuda"
AP_BLOCK_PLACEMENTS = (("attn.qkv_proj.weight", 1), ("attn.qkv_proj.bias", 0),
                       ("attn.out_proj.weight", 0), ("mlp.fc_in.weight", 1),
                       ("mlp.fc_in.bias", 0), ("mlp.fc_out.weight", 0))
assert AP_ATTENTION[1:] in [c[1:] for c in FLASH_CASES]
assert (AP_MICRO_ROWS, 1024, 1024, 12, 12, 64, True) in [
    c[1:] for c in FLASH_CASES]


def _ap_gpt(torch, layers, mesh, seed=0):
    """GPT-124M's widths at ``layers`` blocks, fp32 on the card, placed on
    ``mesh`` (None: whole) as the reference test places its block, wte
    Shard(0); AdamW lr 1e-4 with ClipGradByGlobalNorm(1.0); (model, its
    Engine)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(hidden_size=768, num_layers=layers, num_heads=12)
    model = GPTForPretraining(cfg, device=AP_DEVICE, seed=seed)
    if mesh is not None:
        params = dict(model.named_parameters())
        dist.shard_tensor(params["gpt.wte.weight"], mesh, [dist.Shard(0)])
        for i in range(layers):
            for name, d in AP_BLOCK_PLACEMENTS:
                dist.shard_tensor(params[f"gpt.blocks.{i}.{name}"], mesh,
                                  [dist.Shard(d)])
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    vocab = cfg.vocab_size

    def loss(logits, labels):
        return F.cross_entropy(logits.reshape(-1, vocab), labels.reshape(-1))

    return model, dist.Engine(model, loss=loss, optimizer=opt, mesh=mesh)


def _ap_batches(torch, vocab, n, seed):
    ids, labels = _seeded_ids(torch, vocab, (n * AP_BATCH, 1024), seed=seed)
    return [(ids[i * AP_BATCH:(i + 1) * AP_BATCH],
             labels[i * AP_BATCH:(i + 1) * AP_BATCH]) for i in range(n)]


def ap_engine_gpt124m_rank(torch, ck, dist, rank, mesh):
    """GPT-124M through ``shard_dataloader`` and ``Engine.fit``: AP_WARMUP
    steps, then AP_TIMED timed (one ``fit`` each); step ms, global
    tokens/s, collectives and bytes a step, parameter bytes against the
    whole model's, peak memory, K2/K3 launches (12 a step on fp32)."""
    import paddle_tpu_torch.distributed.auto_parallel as ap
    from paddle_tpu_torch import io
    from paddle_tpu_torch.distributed import comm_plane
    model, eng = _ap_gpt(torch, 12, mesh)
    ids, labels = _seeded_ids(torch, model.config.vocab_size,
                              ((AP_WARMUP + AP_TIMED) * AP_BATCH, 1024),
                              seed=50)

    def loader(lo, hi):
        ds = io.TensorDataset([ids[lo * AP_BATCH:hi * AP_BATCH],
                               labels[lo * AP_BATCH:hi * AP_BATCH]])
        return dist.shard_dataloader(io.DataLoader(ds, batch_size=AP_BATCH),
                                     [mesh])

    warm = eng.fit(loader(0, AP_WARMUP))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ap.reset_stats()
    plane = comm_plane.get_plane()
    plane.reset_stats()
    before = {k.name: k.route_launches["fp32"] for k in ck.KERNELS}
    t0 = time.perf_counter()
    hist = eng.fit(loader(AP_WARMUP, AP_WARMUP + AP_TIMED))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k.name: k.route_launches["fp32"] - before[k.name]
           for k in ck.KERNELS}
    if AP_DEVICE == "cuda" and (got["flash_fwd"] != 12 * AP_TIMED or
                                got["flash_bwd"] != 12 * AP_TIMED):
        raise AssertionError(f"Engine launched {got} on fp32, not "
                             f"{12 * AP_TIMED} each")
    stats = ap.stats()
    # the gather, the reduce-scatter, the replicated gradients' all-reduce
    # and the loss run through the comm plane (each waited on at once)
    comm = plane.stats()
    mine = sum(p.numel() * p.element_size() for p in model.parameters())
    whole = sum(math.prod(getattr(p, "_layout").shape if hasattr(
        p, "_layout") else p.shape) * p.element_size()
        for p in model.parameters())
    return {"phase": "auto_parallel_engine_gpt124m", "mesh": "mp 2",
            "batch": [AP_BATCH, 1024], "rank_rows": AP_BATCH // AP_RANKS,
            "steps": AP_TIMED, "step_ms": secs / AP_TIMED * 1e3,
            "tokens_per_s_global": AP_BATCH * 1024 * AP_TIMED / secs,
            # the epoch's one loss all-reduce is in the totals
            "collectives_total": stats["collectives"],
            "collectives_per_step": (stats["collectives"] - 1) / AP_TIMED,
            "bytes_per_step": stats["bytes"] / AP_TIMED,
            "comm_plane_ms_per_step": comm["comm_ms"] / AP_TIMED,
            "comm_plane_exposed_ms_per_step": comm["exposed_ms"] / AP_TIMED,
            "param_bytes_rank": mine, "param_bytes_model": whole,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "fp32_launches_per_step": {k: v / AP_TIMED
                                       for k, v in got.items()},
            "warmup_loss": warm["loss"], "loss": hist["loss"]}


def ap_exact_rank(torch, dist, rank, out_dir, mesh):
    """The fp32 gate's two-rank side: 2 layers at GPT-124M's widths, the
    first batch's synced gradients, AP_EXACT_STEPS steps (one ``fit`` of
    one global 8 x 1024 batch each, split by the Engine), the parameters
    after step 1, all gathered whole; the histories of the two ranks must
    be bit-equal. Then ``save``: the file must hold the gathered state
    bit for bit, and a model built from another seed that ``load``s it
    must take the next step bit-identically. The first step (its loss,
    the synced gradients scaled by the one-process clip, which the update
    read, and the parameters after it) is held to the parent's ``Engine``
    with no mesh (``ap_one.pt``) by ``_held_pieces`` on the gathered
    values, and every step's loss within 1e-5; rank 0 prints the row."""
    from paddle_tpu_torch.framework.io import load
    model, eng = _ap_gpt(torch, AP_EXACT_LAYERS, mesh)
    vocab = model.config.vocab_size
    batches = _ap_batches(torch, vocab, AP_EXACT_STEPS + 1, seed=51)
    eng.prepare()
    fields, split = eng._fields(list(batches[0]))
    _, grads = eng._forward_backward(fields, split)
    named = list(model.named_parameters())
    whole_g = {n: dist.unshard_dtensor(g).cpu()
               for (n, _), g in zip(named, grads)}
    hist, params1 = [], None
    for b in batches[:AP_EXACT_STEPS]:
        hist += eng.fit([list(b)])["loss"]
        if params1 is None:
            # a copy: .cpu() of a host tensor is the tensor itself
            params1 = {n: dist.unshard_dtensor(p).detach().cpu().clone()
                       for n, p in named}
    seen = []
    dist.all_gather_object(seen, hist)
    if seen[0] != seen[1]:
        raise AssertionError(f"the ranks' histories differ: {seen}")
    path = f"{out_dir}/ap_ckpt"
    t0 = time.perf_counter()
    eng.save(path)
    save_s = time.perf_counter() - t0
    state = {n: dist.unshard_dtensor(p).detach().cpu() for n, p in named}
    saved = load(path + ".pdparams", return_numpy=True)
    file_equal = all(torch.equal(v, torch.from_numpy(saved[n]))
                     for n, v in state.items())
    model2, eng2 = _ap_gpt(torch, AP_EXACT_LAYERS, mesh, seed=1)
    t0 = time.perf_counter()
    eng2.load(path)
    load_s = time.perf_counter() - t0
    nxt = [list(batches[AP_EXACT_STEPS])]
    resumed = eng.fit(nxt)["loss"] == eng2.fit(nxt)["loss"] and all(
        torch.equal(a, b) for a, b in zip(model.parameters(),
                                          model2.parameters()))
    if not (file_equal and resumed):
        raise AssertionError(f"Engine.save/load: file equal {file_equal}, "
                             f"resume bit-identical {resumed}")
    one = torch.load(f"{out_dir}/ap_one.pt", mmap=True)
    held = _held_pieces(torch, dist, hist[0], list(params1.items()),
                        [whole_g[n] * one["clip_scale"] for n in params1],
                        one)
    rel = [abs(a - b) / abs(b) for a, b in zip(hist, one["hist"])]
    held.update(phase="auto_parallel_exactness_fp32", losses_ranks=hist,
                losses_one_process=one["hist"], loss_rel_errs=rel,
                clip_scale=one["clip_scale"],
                global_grad_norm=one["global_grad_norm"])
    held["held"] = held["held"] and max(rel) <= 1e-5
    if rank == 0:
        _rank_emit(rank, held)
    return {"phase": "auto_parallel_exact_rank", "hist": hist,
            "save_s": save_s, "load_s": load_s,
            "pdparams_bytes": os.path.getsize(path + ".pdparams"),
            "pdopt_bytes": os.path.getsize(path + ".pdopt"),
            "file_equal_to_gathered_state": file_equal,
            "resume_bit_identical": resumed}


def ap_reshard_rank(torch, dist, rank, mesh):
    """A [768, 2304] fp32 weight through Shard(1) -> Replicate -> Shard(0)
    -> Shard(1) on the card (one untimed round first): each move's ms and
    bytes, each piece bit-equal to the slice of the whole value, and the
    last bit-equal to the first."""
    import paddle_tpu_torch.distributed.auto_parallel as ap
    S, R = dist.Shard, dist.Replicate
    gen = torch.Generator().manual_seed(60)
    whole = torch.randn(AP_RESHARD_SHAPE, generator=gen).to(AP_DEVICE)
    start = dist.shard_tensor(whole, mesh, [S(1)])
    plan = ([R()], [S(0)], [S(1)])
    t = start
    for pls in plan:
        t = dist.reshard(t, mesh, pls)
    moves, t = [], start
    for pls in plan:
        ap.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = dist.reshard(t, mesh, pls)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = whole[:, :] if pls == [R()] else \
            dist.shard_tensor(whole, mesh, pls)
        moves.append({"to": repr(pls), "ms": ms,
                      "collectives": ap.stats()["collectives"],
                      "bytes": ap.stats()["bytes"],
                      "bit_equal": bool(torch.equal(t, want))})
    back = bool(torch.equal(t, start))
    if not (back and all(m["bit_equal"] for m in moves)):
        raise AssertionError(f"reshard on the card: {moves}, round trip "
                             f"bit-equal {back}")
    return {"phase": "auto_parallel_reshard", "shape": AP_RESHARD_SHAPE,
            "moves": moves, "round_trip_bit_equal": back}


def auto_parallel_rank(torch, out_dir):
    """One rank of the auto_parallel path (started by the launcher): the
    Engine over GPT-124M, the fp32 gate with save/load, reshard. Prints
    one JSON line per phase and last its launches by route."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env(timeout=DP_RANK_TIMEOUT_S)
    _wait_ready(out_dir)
    rank, world = env.rank, env.world_size
    if dist.get_backend() != "gloo" or world != AP_RANKS:
        raise AssertionError(f"backend {dist.get_backend()}, world {world}")
    ck.reset_launch_counts()
    mesh = dist.ProcessMesh(list(range(AP_RANKS)), ["mp"])
    for phase in (lambda: ap_engine_gpt124m_rank(torch, ck, dist, rank,
                                                 mesh),
                  lambda: ap_exact_rank(torch, dist, rank, out_dir, mesh),
                  lambda: ap_reshard_rank(torch, dist, rank, mesh)):
        t0 = time.perf_counter()
        row = phase()
        _rank_emit(rank, dict(row, seconds=time.perf_counter() - t0))
        torch.cuda.empty_cache()
    _rank_emit(rank, {"rank_launches": {k.name: dict(k.route_launches)
                                        for k in ck.KERNELS}})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _ap_one_process(torch, tmp):
    """The one-process side of the fp32 gate: ``Engine`` with no mesh in
    this process from the same weights and batches, as ``ap_one.pt``: the
    first step's loss, its gradients scaled by the global-norm clip (which
    the update read) and the parameters after it, every step's loss, the
    clip's scale and the norm."""
    model, eng = _ap_gpt(torch, AP_EXACT_LAYERS, None)
    batches = _ap_batches(torch, model.config.vocab_size,
                          AP_EXACT_STEPS + 1, seed=51)
    eng.prepare()
    fields, split = eng._fields(list(batches[0]))
    _, grads = eng._forward_backward(fields, split)
    grads = {n: g.detach().cpu()
             for (n, _), g in zip(model.named_parameters(), grads)}
    norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                         for g in grads.values()))
    clip = min(1.0, 1.0 / norm)
    hist = eng.fit([list(batches[0])])["loss"]
    params = {n: p.detach().cpu().clone()
              for n, p in model.named_parameters()}
    for b in batches[1:AP_EXACT_STEPS]:
        hist += eng.fit([list(b)])["loss"]
    torch.save({"loss": hist[0], "hist": hist, "params": params,
                "grads": {n: g * clip for n, g in grads.items()},
                "clip_scale": clip, "global_grad_norm": norm},
               f"{tmp}/ap_one.pt")
    del model, eng
    if AP_DEVICE == "cuda":
        torch.cuda.empty_cache()


def phase_fleet_executor(torch, ck):
    """GPT-124M bf16 (eval) cut by ``FleetExecutor.from_stages`` into
    embeddings + blocks 0-3, blocks 4-7, blocks 8-11, norm + head, over
    AP_MICRO microbatches of [AP_MICRO_ROWS, 1024]: each output
    bit-identical to the model run straight on its microbatch, K2 once per
    block and microbatch, ms through the executor (twice, and once with
    a 0.1 ms thread switch interval) against straight; then
    a stage that raises on microbatch 3 must reach the caller as a
    RuntimeError naming it."""
    import threading

    from paddle_tpu_torch.distributed.fleet_executor import FleetExecutor
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.math import add
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(hidden_size=768, num_layers=12, num_heads=12)
    model = GPTForPretraining(cfg, device=AP_DEVICE, dtype=torch.bfloat16,
                              seed=0).eval()
    gpt = model.gpt

    def blocks(lo, hi):
        @torch.no_grad()
        def run(x):
            for block in gpt.blocks[lo:hi]:
                x = block(x)
            return x
        return run

    @torch.no_grad()
    def embed(ids):
        # GPTModel.forward's embedding, then blocks 0-3
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = gpt.drop(add(F.embedding(ids, gpt.wte.weight),
                         F.embedding(pos, gpt.wpe.weight)))
        return blocks(0, 4)(x)

    @torch.no_grad()
    def head(x):
        return model._logits(gpt.ln_f(x))

    ids, _ = _seeded_ids(torch, cfg.vocab_size,
                         (AP_MICRO * AP_MICRO_ROWS, 1024), seed=70)
    micro = [m.to(AP_DEVICE) for m in ids.split(AP_MICRO_ROWS)]
    ex = FleetExecutor.from_stages([embed, blocks(4, 8), blocks(8, 12),
                                    head])
    ex.run(micro[:1])
    with torch.no_grad():
        model(micro[0])

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    before = ck.FLASH_FWD.launches
    got, ex_ms = timed(lambda: ex.run(micro))
    launches = ck.FLASH_FWD.launches - before
    _, ex_ms_again = timed(lambda: ex.run(micro))
    # the same with the interpreter's thread switch interval at 0.1 ms
    # (5 ms by default: a stage woken by its message may wait that long
    # for the GIL), a record of where the executor's time goes
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        _, ex_ms_switch = timed(lambda: ex.run(micro))
    finally:
        sys.setswitchinterval(interval)
    with torch.no_grad():
        want, straight_ms = timed(lambda: [model(m) for m in micro])
    same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    calls = [0]

    def fails_on_3(x):
        i = calls[0]
        calls[0] += 1
        if i == 3:
            raise ValueError("microbatch 3")
        return blocks(4, 8)(x)

    named = None
    try:
        FleetExecutor.from_stages([embed, fails_on_3, blocks(8, 12),
                                   head]).run(micro)
    except RuntimeError as e:
        named = str(e) if "stage1" in str(e) and isinstance(
            e.__cause__, ValueError) else None
    for th in threading.enumerate():
        if th.name.startswith("interceptor:"):
            th.join(timeout=60)
    torch.cuda.synchronize()
    row = {"phase": "auto_parallel_fleet_executor", "stages": 4,
           "microbatches": AP_MICRO, "micro_shape": [AP_MICRO_ROWS, 1024],
           "dtype": "bfloat16", "executor_ms": [ex_ms, ex_ms_again],
           "executor_ms_switch_interval_0.1ms": ex_ms_switch,
           "straight_ms": straight_ms, "k2_launches": launches,
           "bit_identical": same, "failure_reported": named}
    emit(row)
    if not all(same) or named is None or (
            AP_DEVICE == "cuda" and launches != 12 * AP_MICRO):
        raise AssertionError(f"fleet executor: {row}")
    return row


def phase_auto_parallel(torch, ck, smi):
    """The auto_parallel path: this process's one-process ``Engine`` step,
    two gloo ranks (the Engine over GPT-124M, the fp32 gate held to that
    step with save/load, reshard), then the fleet executor here. The
    ranks' kernel launches are added to this process's counts."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ap_")
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _run_ranks(AP_RANKS, "--auto-parallel-rank", tmp,
                           {"PADDLE_DISTRI_BACKEND": "gloo"},
                           prepare=lambda: _ap_one_process(torch, tmp))
        t_ranks = time.perf_counter() - t0
        for rows in ranks.values():
            for row in rows[:-1]:
                emit(row)
            ck.add_launches(rows[-1]["rank_launches"])
        _exactness_held(ranks, "auto_parallel_exactness_fp32", 1)
        exact = next(r for r in ranks[0]
                     if r.get("phase") == "auto_parallel_exactness_fp32")
        ex = phase_fleet_executor(torch, ck)

        def both(phase, *keys):
            got = [next(r for r in rows if r.get("phase") == phase)
                   for rows in ranks.values()]
            return {k: [g[k] for g in got] for k in keys}
        engine = both("auto_parallel_engine_gpt124m", "step_ms",
                      "tokens_per_s_global", "collectives_per_step",
                      "bytes_per_step", "comm_plane_ms_per_step",
                      "comm_plane_exposed_ms_per_step", "param_bytes_rank",
                      "param_bytes_model", "peak_memory_bytes")
        slowest = max(engine["step_ms"])
        emit({"phase": "auto_parallel", "nvidia_smi": smi,
              "ranks": AP_RANKS, "backend": "gloo",
              "engine": dict(engine, step_ms_slowest=slowest,
                             tokens_per_s_global_slowest=AP_BATCH * 1024
                             / slowest * 1e3),
              "exact": {k: exact[k] for k in (
                  "loss_rel_err", "grad_max_rel_err", "param_max_rel_err",
                  "loss_rel_errs")},
              "save_load": both("auto_parallel_exact_rank", "save_s",
                                "load_s", "pdparams_bytes",
                                "file_equal_to_gathered_state",
                                "resume_bit_identical"),
              "reshard": both("auto_parallel_reshard", "moves"),
              "executor": {k: ex[k] for k in (
                  "executor_ms", "executor_ms_switch_interval_0.1ms",
                  "straight_ms")},
              "ranks_s": t_ranks})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- tensor parallelism and ZeRO inside the SPMD pipeline (pipeline_3d) -------
# Eight gloo ranks share the card at pp 2 x sharding 2 x mp 2 after
# fleet.init (rank = 4 pp + 2 sharding + mp): GPTForPretrainingPipe with
# tensor_parallel, placed by group_sharded_parallel. The fp32 gates at
# PP_EXACT_LAYERS layers are held on the ranks to this process's
# unpipelined step; the timed steps run GPT-124M at O2 bf16.
# (P3_RANKS and the shapes stand beside FLASH_CASES)
P3_EXACT = ((1, False, "p_g_os"), (2, True, "p_g_os"), (1, False, "os"),
            (1, False, "os_g"))
P3_SPMD = ((1, False), (2, True))


def _p3_exact_batch(torch):
    return _seeded_ids(torch, 50304, (P3_EXACT_BATCH, 1024), seed=77)


def _p3_model(torch, layers, n_micro, n_chunks, remat, level, seed=0,
              clip=None):
    """``GPTForPretrainingPipe`` with ``tensor_parallel`` at GPT-124M's
    widths and ``layers`` layers on ``P3_DEVICE``, AdamW lr 1e-4 (with
    ``clip``), placed by ``group_sharded_parallel`` at ``level``: (the
    model, its ZeRO wrapper, the inner optimizer)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretrainingPipe
    cfg = GPTConfig(hidden_size=768, num_layers=layers, num_heads=12,
                    tensor_parallel=True)
    model = GPTForPretrainingPipe(cfg, n_microbatch=n_micro,
                                  n_chunks=n_chunks, remat=remat,
                                  device=P3_DEVICE, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                grad_clip=clip)
    net, zopt, _ = group_sharded_parallel(model, opt, level)
    return model, net, getattr(zopt, "_optim", zopt)


def _data_rows(mesh, batch):
    """This data rank's rows of a global batch (the sharding axis is the
    data axis: the pp, sep and mp ranks of a data rank share them)."""
    n = batch // mesh.shape["sharding"]
    return slice(mesh.coord["sharding"] * n, (mesh.coord["sharding"] + 1) * n)


def _data_rank_losses(dist, losses, partners=(1, 4), data_ranks=(0, 2)):
    """Every rank's ``losses``; rank r and r ^ p for each p of ``partners``
    (the other ranks of its data rank: pp and mp at pp 2 x sharding 2 x mp
    2) must report bit-equal ones. Returns (all, the mean of each over
    ``data_ranks``, one rank of each data rank)."""
    seen = []
    dist.all_gather_object(seen, losses)
    for r in range(len(seen)):
        if any(seen[r] != seen[r ^ p] for p in partners):
            raise AssertionError(f"the ranks of a data rank differ: "
                                 f"{seen}")
    return seen, [sum(seen[r][i] for r in data_ranks) / len(data_ranks)
                  for i in range(len(losses))]


def _p3_stored(torch, one, n_chunks):
    """``one``'s stacked leaves in the row order a pp-2 model with
    ``n_chunks`` stores them (chunk-major)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.spmd_pipeline \
        import interleave_row_order
    if n_chunks == 1:
        return one
    order = torch.as_tensor(interleave_row_order(PP_EXACT_LAYERS, 2,
                                                 n_chunks))
    return dict(one, **{k: {n: t[order] if n.startswith("blocks.") else t
                            for n, t in one[k].items()}
                        for k in ("grads", "params")})


def _mesh_checkpoint(torch, rank, out_dir, name, model, other):
    """``model`` saved from the mesh through ``distributed.checkpoint``
    under ``{out_dir}/{name}`` (and this rank's pieces, for the parent's
    whole load), then loaded into ``other()``, a model of another seed
    placed the same: every piece bit-equal."""
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.distributed.sharding_api import placement_of
    named = list(model.named_parameters())
    t0 = time.perf_counter()
    dck.save_state_dict(model.state_dict(), f"{out_dir}/{name}")
    save_s = time.perf_counter() - t0
    torch.save({n: (placement_of(p).pieces if placement_of(p) else None,
                    p.detach().cpu()) for n, p in named},
               f"{out_dir}/{name}_pieces_{rank}.pt")
    model2 = other()
    t0 = time.perf_counter()
    dck.load_state_dict(model2.state_dict(), f"{out_dir}/{name}")
    load_s = time.perf_counter() - t0
    bad = [n for (n, a), (_, b) in zip(named, model2.named_parameters())
           if not torch.equal(a.detach(), b.detach())]
    if bad:
        raise AssertionError(f"the mesh checkpoint loaded back differs: "
                             f"{bad}")
    return {"checkpoint_mesh_round_trip_bit_equal": True,
            "checkpoint_save_s": save_s, "checkpoint_load_s": load_s}


def p3_exact_rank(torch, ck, dist, rank, mesh, out_dir, n_chunks, remat,
                  level):
    """One fp32 AdamW step (lr 1e-4) of ``_p3_model`` at
    ``PP_EXACT_LAYERS`` layers under ``level`` through
    ``CompiledTrainStep``, each data rank on its 2 of the 4 x 1024 rows in
    ``P3_EXACT_MICRO`` microbatches, held piece by piece to the parent's
    unpipelined step (``p3_one.pt``, ``_held_pieces``); an mp pair's
    leaves whole over mp must be bit-equal. The GPipe ``p_g_os`` model then
    makes the checkpoint round trip (``_mesh_checkpoint``)."""
    from paddle_tpu_torch.distributed.sharding_api import placement_of
    from paddle_tpu_torch.jit import CompiledTrainStep
    model, net, opt = _p3_model(torch, PP_EXACT_LAYERS, P3_EXACT_MICRO,
                                n_chunks, remat, level)
    step = CompiledTrainStep(lambda a, b: net(a, labels=b)[1], net, opt)
    real, seen = step._sync, {}
    step._sync = lambda g: seen.setdefault("grads", real(g))
    rows = _data_rows(mesh, P3_EXACT_BATCH)
    ids, labels = (t[rows].to(P3_DEVICE) for t in _p3_exact_batch(torch))
    before = {k.name: k.route_launches["fp32"] for k in ck.KERNELS}
    loss = step(ids, labels).item()
    launches = [ck.FLASH_FWD.route_launches["fp32"] - before["flash_fwd"],
                ck.FLASH_BWD.route_launches["fp32"] - before["flash_bwd"]]
    losses, mean = _data_rank_losses(dist, [loss])
    named = list(model.named_parameters())
    whole_over_mp = {n: _digest([p]) for n, p in named
                     if "mp" not in getattr(placement_of(p), "axes", ())}
    pairs = []
    dist.all_gather_object(pairs, whole_over_mp)
    if pairs[rank ^ 1] != whole_over_mp:
        raise AssertionError("an mp pair's replicated leaves differ")
    one = _p3_stored(torch, torch.load(f"{out_dir}/p3_one.pt", mmap=True),
                     n_chunks)
    out = _held_pieces(torch, dist, mean[0], named, seen["grads"], one)
    out.update(phase=f"pipeline_3d_exactness_fp32_{level}_chunks{n_chunks}"
                     f"{'_remat' if remat else ''}",
               tf32=False, losses=[x[0] for x in losses],
               mp_pair_replicated_bit_equal=len(whole_over_mp),
               flash_launches_fp32=launches,
               model=f"GPTForPretrainingPipe(tensor_parallel) at GPT-124M "
                     f"widths, {PP_EXACT_LAYERS} layers, fp32, AdamW lr "
                     f"1e-4, {level}, n_chunks {n_chunks}, remat {remat}; "
                     f"pp 2 x sharding 2 x mp 2 against the unpipelined "
                     f"model in one process on {P3_EXACT_BATCH} x 1024")
    if level == "p_g_os" and n_chunks == 1:
        out.update(_mesh_checkpoint(
            torch, rank, out_dir, "p3_ckpt", model,
            lambda: _p3_model(torch, PP_EXACT_LAYERS, P3_EXACT_MICRO, 1,
                              False, "p_g_os", seed=1)[0]))
    del model, net, opt, step, seen
    if P3_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def p3_gpt124m_rank(torch, ck, dist, mesh, n_chunks, remat):
    """GPT-124M (12 layers) as ``_p3_model`` under ``p_g_os``, AdamW lr 1e-4
    with ``ClipGradByGlobalNorm(1.0)``, O2 bf16 through
    ``CompiledTrainStep``, the global 8 x 1024 (4 x 1024 a data rank in
    ``P3_MICRO`` microbatches), ``n_chunks`` 1 (GPipe, 3 ticks) or 2 with
    remat (5 ticks): ``PP_WARMUP`` + ``PP_TIMED`` steps (K2 12 a step, 24
    with remat, K3 12), the mp collectives metered over the warm-up. The
    pipeline's exchanges, bytes and ms, the comm plane's other works
    (ZeRO's gathers and reduce-scatters, the sum over pp) and ms a step,
    peak memory, parameter + AdamW bytes against one process's."""
    from paddle_tpu_torch.distributed import comm_plane as cp
    from paddle_tpu_torch.distributed import sep_transport
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        mp_layers, spmd_pipeline)
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    layers = 12
    model, net, opt = _p3_model(torch, layers, P3_MICRO, n_chunks, remat,
                                "p_g_os", clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(lambda i, lb: net(i, labels=lb)[1], net, opt,
                             amp_level="O2")
    rows = _data_rows(mesh, P3_BATCH)
    ids, labels = (t[rows].to(P3_DEVICE) for t in _seeded_ids(
        torch, 50304, (P3_BATCH, 1024), seed=78))
    per = layers // 2 * P3_MICRO
    per_step = (per * (2 if remat else 1), per)
    losses, secs, slowest, (metered_s,) = _pp_timed(
        torch, ck, dist, lambda: step(ids, labels), per_step,
        meter_warmup=True)
    comm = mp_layers.comm_meter()
    peak = torch.cuda.max_memory_allocated()
    ex, bc = sep_transport.stats(), spmd_pipeline.stats()
    plane = cp.get_plane().stats()
    ticks = spmd_pipeline.pipeline_ticks(P3_MICRO, 2, n_chunks)
    if ex["exchanges"] != 2 * ticks * PP_TIMED:
        raise AssertionError(f"{ex['exchanges']} exchanges in {PP_TIMED} "
                             f"steps, not 2 x {ticks} each")
    _, data_losses = _data_rank_losses(dist, losses)
    params = list(model.parameters())
    states = _state_tensors_of(opt, params)
    pb = sum(p.numel() * p.element_size() for p in params)
    ob = sum(v.numel() * v.element_size() for v, _ in states)
    one_pb, one_ob = _whole_bytes(params), _whole_bytes(states)
    out = {"phase": f"pipeline_3d_gpt124m_chunks{n_chunks}"
                    f"{'_remat' if remat else ''}",
           "n_chunks": n_chunks, "remat": remat, "ticks": ticks,
           "batch_global": [P3_BATCH, 1024], "microbatches": P3_MICRO,
           "heads_per_rank": 12 // mesh.shape["mp"],
           "step_ms_each": [1e3 * s for s in secs],
           "step_ms_slowest_rank": slowest,
           "global_tokens_per_s": P3_BATCH * 1024 / (slowest / 1e3),
           "losses_data_ranks": data_losses,
           "mp_calls_per_step": comm["calls"],
           "mp_bytes_per_step": comm["bytes"],
           "mp_ms_per_step": comm["ms"], "metered_step_ms": 1e3 * metered_s,
           "exchanges_per_step": ex["exchanges"] / PP_TIMED,
           "exchange_bytes_per_step": ex["bytes"] / PP_TIMED,
           "exchange_ms_per_step": ex["ms"] / PP_TIMED,
           "broadcasts_per_step": bc["collectives"] / PP_TIMED,
           "broadcast_ms_per_step": bc["ms"] / PP_TIMED,
           "comm_plane_works_per_step":
               (plane["works"] - ex["exchanges"]) / PP_TIMED,
           "comm_plane_ms_per_step":
               (plane["comm_ms"] - ex["ms"]) / PP_TIMED,
           "peak_memory_bytes": peak,
           "param_elements": sum(p.numel() for p in params),
           "param_elements_one_process": one_pb // 4,
           "param_bytes": pb, "optimizer_bytes": ob,
           "one_process_param_bytes": one_pb,
           "one_process_optimizer_bytes": one_ob,
           "param_plus_adamw_ratio": (pb + ob) / (one_pb + one_ob),
           "flash_launches_per_step": list(per_step)}
    del model, net, opt, step
    torch.cuda.empty_cache()
    return out


def pipeline3d_rank(torch, out_dir):
    """One rank of the pipeline_3d path (started by the launcher): pp 2 x
    sharding 2 x mp 2 after ``fleet.init``, the fp32 gates (rank 0 prints
    their rows: every rank holds the same), then GPT-124M's timed steps in
    each configuration. Prints one JSON line per phase and last its
    launches by route."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env(timeout=DP_RANK_TIMEOUT_S)
    _wait_ready(out_dir)
    rank, world = env.rank, env.world_size
    if dist.get_backend() != "gloo" or world != P3_RANKS:
        raise AssertionError(f"backend {dist.get_backend()}, world {world}")
    ck.reset_launch_counts()
    mesh = _hp_fleet(fleet, pp_degree=2, sharding_degree=2, mp_degree=2)
    coord = [mesh.coord[a] for a in ("pp", "sharding", "mp")]
    if [mesh.shape[a] for a in ("pp", "sharding", "mp")] != [2, 2, 2] or \
            rank != 4 * coord[0] + 2 * coord[1] + coord[2]:
        raise AssertionError(f"mesh {mesh}")
    for n_chunks, remat, level in P3_EXACT:
        row = p3_exact_rank(torch, ck, dist, rank, mesh, out_dir, n_chunks,
                            remat, level)
        if rank == 0:
            _rank_emit(rank, row)
    for n_chunks, remat in P3_SPMD:
        _rank_emit(rank, p3_gpt124m_rank(torch, ck, dist, mesh, n_chunks,
                                         remat))
    _rank_emit(rank, {"rank_launches": {k.name: dict(k.route_launches)
                                        for k in ck.KERNELS}})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _p3_one_process(torch, tmp):
    """The unpipelined fp32 step the ranks' gates are held to:
    ``GPTForPretrainingPipe`` at GPT-124M's widths and ``PP_EXACT_LAYERS``
    layers from the same weights, on the whole 4 x 1024, as ``p3_one.pt``."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretrainingPipe
    model = GPTForPretrainingPipe(
        GPTConfig(hidden_size=768, num_layers=PP_EXACT_LAYERS, num_heads=12),
        device=P3_DEVICE, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    ids, labels = _p3_exact_batch(torch)
    _one_process_step(torch, model, opt, ids, labels, f"{tmp}/p3_one.pt")
    del model, opt
    if P3_DEVICE == "cuda":
        torch.cuda.empty_cache()


def _checkpoint_loaded_whole(torch, tmp, name, model, nranks, phase):
    """The ranks' checkpoint ``name`` (``_mesh_checkpoint``) loaded whole
    into ``model`` (another seed, no mesh) in this process: every rank's
    piece of every parameter bit-equal to the loaded whole."""
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.distributed.sharding_api import Placement
    t0 = time.perf_counter()
    dck.load_state_dict(model.state_dict(), f"{tmp}/{name}")
    load_s = time.perf_counter() - t0
    whole = {n: p.detach().cpu() for n, p in model.named_parameters()}
    bad, pieces = [], 0
    for r in range(nranks):
        for n, (pl, local) in torch.load(
                f"{tmp}/{name}_pieces_{r}.pt").items():
            want = Placement(whole[n].shape, pl).take(whole[n]) \
                if pl is not None else whole[n]
            pieces += 1
            if not torch.equal(local, want):
                bad.append((r, n))
    out = {"phase": phase, "mesh_to_one_process_bit_equal": not bad,
           "mismatched": bad, "rank_tensors": pieces, "load_s": load_s}
    emit(out)
    if bad:
        raise AssertionError(f"the mesh checkpoint loaded whole: {out}")
    return out


def phase_pipeline_3d(torch, ck, smi):
    """The pipeline_3d path: this process's unpipelined fp32 step, eight
    gloo ranks at pp 2 x sharding 2 x mp 2 (the fp32 gates held to it, the
    checkpoint round trip, GPT-124M's timed steps), then the ranks'
    checkpoint loaded whole here. The ranks' kernel launches are added to
    this process's counts."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p3_")
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _run_ranks(P3_RANKS, "--pipeline3d-rank", tmp,
                           {"PADDLE_DISTRI_BACKEND": "gloo",
                            "OMP_NUM_THREADS": "1"},
                           prepare=lambda: _p3_one_process(torch, tmp))
        t_ranks = time.perf_counter() - t0
        for rows in ranks.values():
            for row in rows[:-1]:
                emit(row)
            ck.add_launches(rows[-1]["rank_launches"])
        _exactness_held(ranks, "pipeline_3d_exactness_fp32_", len(P3_EXACT))
        from paddle_tpu_torch.text.gpt import (GPTConfig,
                                               GPTForPretrainingPipe)
        ckpt = _checkpoint_loaded_whole(
            torch, tmp, "p3_ckpt", GPTForPretrainingPipe(
                GPTConfig(hidden_size=768, num_layers=PP_EXACT_LAYERS,
                          num_heads=12), device=P3_DEVICE, seed=1),
            P3_RANKS, "pipeline_3d_checkpoint_whole")
        summary = {"phase": "pipeline_3d", "nvidia_smi": smi,
                   "ranks": P3_RANKS, "backend": "gloo",
                   "mesh": {"pp": 2, "sharding": 2, "mp": 2},
                   "transport": "mp sums, pipeline exchanges and ZeRO's "
                                "collectives staged through the host "
                                "(gloo, CUDA tensors)",
                   "global_batch": [P3_BATCH, 1024],
                   "microbatches": P3_MICRO, "ranks_s": t_ranks,
                   "checkpoint_whole_load_s": ckpt["load_s"]}
        for n_chunks, remat in P3_SPMD:
            name = f"pipeline_3d_gpt124m_chunks{n_chunks}" \
                   f"{'_remat' if remat else ''}"
            got = [next(r for r in rows if r.get("phase") == name)
                   for rows in ranks.values()]
            slowest = max(g["step_ms_slowest_rank"] for g in got)
            summary[name[12:]] = dict(
                {k: [g[k] for g in got] for k in (
                    "mp_calls_per_step", "mp_bytes_per_step",
                    "mp_ms_per_step", "exchanges_per_step",
                    "exchange_bytes_per_step", "exchange_ms_per_step",
                    "comm_plane_works_per_step", "comm_plane_ms_per_step",
                    "peak_memory_bytes", "param_elements", "param_bytes",
                    "optimizer_bytes", "param_plus_adamw_ratio")},
                step_ms_slowest_rank=slowest,
                global_tokens_per_s=P3_BATCH * 1024 / (slowest / 1e3),
                ticks=got[0]["ticks"],
                param_elements_one_process=got[0][
                    "param_elements_one_process"],
                losses_data_ranks=got[0]["losses_data_ranks"],
                flash_launches_per_step=got[0]["flash_launches_per_step"])
        emit(summary)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- context parallelism across the hybrid mesh (context_hybrid) -------------
# Eight gloo ranks share the card, first at sharding 2 x sep 2 x mp 2 after
# fleet.init (rank = 4 sharding + 2 sep + mp): GPTForPretraining with
# tensor_parallel, sequence_parallel and context_parallel under
# group_sharded_parallel; then at pp 2 x sharding 2 x sep 2 (rank = 4 pp +
# 2 sharding + sep): GPTForPretrainingPipe, every sep rank on the whole
# sequence. The fp32 gates are held on the ranks to this process's
# one-process steps; the timed steps run GPT-124M at O2 bf16 with the ring.
# (CH_RANKS and the shapes stand beside FLASH_CASES)
CH_EXACT = (("ring", "p_g_os"), ("ulysses", "p_g_os"), ("ring", "os_g"))
CH_PIPE_LAYERS = 2
CH_WARMUP, CH_TIMED = 1, 2


def _ch_exact_batch(torch):
    """The fp32 gates' 2 x 4096, a row a data rank: the labels of each
    row's first 1536 tokens ignored (as ``_cp_exact_batch``'s), so sep
    rank 0 keeps 512 of its 2048 and rank 1 all."""
    ids, labels = _seeded_ids(torch, 50304, (CH_EXACT_BATCH, CP_EXACT_SEQ),
                              seed=64)
    labels[:, :CP_EXACT_SEQ * 3 // 8] = -100
    return ids, labels


def _ch_model(torch, cfg, level, seed=0):
    """``GPTForPretraining(cfg)`` on ``CH_DEVICE``, AdamW lr 1e-4 over its
    named parameters, placed by ``group_sharded_parallel`` at ``level``:
    (the model, its ZeRO wrapper, the inner optimizer)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTForPretraining
    model = GPTForPretraining(cfg, device=CH_DEVICE, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    net, zopt, _ = group_sharded_parallel(model, opt, level)
    return model, net, getattr(zopt, "_optim", zopt)


def ch_exact_rank(torch, ck, dist, rank, mesh, out_dir, mode, level, one):
    """One fp32 AdamW step (lr 1e-4) of GPT-124M's widths at 2 layers with
    SP and CP ``mode`` under ZeRO ``level`` through ``CompiledTrainStep``,
    each data rank on its row of ``_ch_exact_batch`` and each sep rank on
    its 2048 tokens of it, twice from the same build
    (``_twice_bit_identical``); the sep and mp ranks of a data rank on
    bit-equal losses; held piece by piece to the parent's one-process step
    ``one`` (``ch_one.pt``, ``_held_pieces``). The ring ``p_g_os`` model
    then makes the checkpoint round trip (``_mesh_checkpoint``)."""
    from paddle_tpu_torch.distributed.sharding_api import sep_local_batch
    from paddle_tpu_torch.text.gpt import GPTConfig
    rows = _data_rows(mesh, CH_EXACT_BATCH)
    ids, labels = (sep_local_batch(t[rows]).contiguous().to(CH_DEVICE)
                   for t in _ch_exact_batch(torch))
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12,
                    max_seq_len=CP_EXACT_SEQ, tensor_parallel=True,
                    sequence_parallel=True, context_parallel=mode)
    before = {k.name: k.route_launches["fp32"] for k in ck.KERNELS}
    model, loss, grads = _twice_bit_identical(
        torch, lambda: _ch_model(torch, cfg, level), (ids, labels),
        f"{mode} {level}")
    launches = [ck.FLASH_FWD.route_launches["fp32"] - before["flash_fwd"],
                ck.FLASH_BWD.route_launches["fp32"] - before["flash_bwd"]]
    losses, mean = _data_rank_losses(dist, [loss], (1, 2), (0, 4))
    out = _held_pieces(torch, dist, mean[0], list(model.named_parameters()),
                       grads, one)
    out.update(phase=f"context_hybrid_exactness_fp32_{mode}_{level}",
               tf32=False, rerun_bit_identical=True,
               losses=[x[0] for x in losses],
               flash_launches_fp32_two_runs=launches,
               model=f"GPT-124M widths, 2 layers, fp32, AdamW lr 1e-4; "
                     f"tensor_parallel, sequence_parallel and {mode} at "
                     f"sharding 2 x sep 2 x mp 2 under {level} against one "
                     f"process on {CH_EXACT_BATCH} x {CP_EXACT_SEQ}, labels "
                     "of each row's first 1536 tokens ignored")
    if (mode, level) == ("ring", "p_g_os"):
        out.update(_mesh_checkpoint(
            torch, rank, out_dir, "ch_ckpt", model,
            lambda: _ch_model(torch, cfg, level, seed=1)[0]))
    del model, grads
    if CH_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def ch_pipe_exact_rank(torch, dist, rank, mesh, out_dir):
    """One fp32 AdamW step (lr 1e-4) of ``GPTForPretrainingPipe`` at
    GPT-124M's widths and ``CH_PIPE_LAYERS`` layers under ``p_g_os`` at pp
    2 x sharding 2 x sep 2, each data rank on its row of
    ``_ch_exact_batch`` in one microbatch and every sep rank on the whole
    sequence, twice from the same build; the pp and sep ranks of a data
    rank on bit-equal losses, the two sep ranks on bit-equal gradients (no
    sum over sep); held piece by piece to the parent's unpipelined step
    (``ch_pipe_one.pt``)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretrainingPipe
    cfg = GPTConfig(hidden_size=768, num_layers=CH_PIPE_LAYERS, num_heads=12,
                    max_seq_len=CP_EXACT_SEQ)
    rows = _data_rows(mesh, CH_EXACT_BATCH)
    ids, labels = (t[rows].to(CH_DEVICE) for t in _ch_exact_batch(torch))

    def build():
        model = GPTForPretrainingPipe(cfg, n_microbatch=1, device=CH_DEVICE,
                                      seed=0)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        net, zopt, _ = group_sharded_parallel(model, opt, "p_g_os")
        return model, net, getattr(zopt, "_optim", zopt)

    model, loss, grads = _twice_bit_identical(torch, build, (ids, labels),
                                              "pipe on pp x sep")
    losses, mean = _data_rank_losses(dist, [loss])
    digests = []
    dist.all_gather_object(digests, _digest(grads))
    if digests[rank] != digests[rank ^ 1]:
        raise AssertionError("the sep ranks' gradients differ")
    out = _held_pieces(torch, dist, mean[0], list(model.named_parameters()),
                       grads, torch.load(f"{out_dir}/ch_pipe_one.pt",
                                         mmap=True))
    out.update(phase="context_hybrid_exactness_fp32_pipe", tf32=False,
               rerun_bit_identical=True, losses=[x[0] for x in losses],
               sep_gradients_bit_equal=True,
               model=f"GPTForPretrainingPipe at GPT-124M widths, "
                     f"{CH_PIPE_LAYERS} layers, fp32, AdamW lr 1e-4, p_g_os; "
                     f"pp 2 x sharding 2 x sep 2, every sep rank on the "
                     f"whole sequence, against the unpipelined model in "
                     f"one process on {CH_EXACT_BATCH} x {CP_EXACT_SEQ}")
    del model, grads
    if CH_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def ch_gpt124m_rank(torch, ck, dist, mesh):
    """GPT-124M (``gpt_small(max_seq_len=8192)``) with ``tensor_parallel``,
    ``sequence_parallel`` and ``context_parallel="ring"`` under
    ``p_g_os``, AdamW lr 1e-4, O2 bf16 through ``CompiledTrainStep`` on the
    global 2 x 8192 (a row a data rank, 4096 tokens a sep rank, 6 heads a
    rank): ``CH_WARMUP`` + ``CH_TIMED`` steps (K2 and K3 twice a layer),
    the mp collectives metered over the warm-up. The sep exchanges, bytes and
    ms, the comm plane's other works (ZeRO-3's gathers and reduce-scatters,
    the gradient sums) and ms a step, peak memory, parameter + AdamW bytes
    against one process's; every rank reports the same global losses."""
    from paddle_tpu_torch.distributed import comm_plane as cp
    from paddle_tpu_torch.distributed import sep_transport
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
    from paddle_tpu_torch.distributed.sharding_api import sep_local_batch
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.text.gpt import gpt_small
    cfg = gpt_small(max_seq_len=CP_SEQ, tensor_parallel=True,
                    sequence_parallel=True, context_parallel="ring")
    model, net, opt = _ch_model(torch, cfg, "p_g_os")
    step = CompiledTrainStep(lambda i, lb: net(i, labels=lb)[1], net, opt,
                             amp_level="O2")
    rows = _data_rows(mesh, CH_BATCH)
    ids, labels = (sep_local_batch(t[rows]).contiguous().to(CH_DEVICE)
                   for t in _seeded_ids(torch, cfg.vocab_size,
                                        (CH_BATCH, CP_SEQ), seed=65))
    per = CP_BLOCKS_PER_LAYER["ring"] * cfg.num_layers
    losses, secs, slowest, (metered_s,) = _pp_timed(
        torch, ck, dist, lambda: step(ids, labels), (per, per),
        warmup=CH_WARMUP, timed=CH_TIMED, meter_warmup=True)
    comm = mp_layers.comm_meter()
    peak = torch.cuda.max_memory_allocated()
    ex, plane = sep_transport.stats(), cp.get_plane().stats()
    _, global_losses = _data_rank_losses(dist, losses, (1, 2), (0, 4))
    params = list(model.parameters())
    states = _state_tensors_of(opt, params)
    pb = sum(p.numel() * p.element_size() for p in params)
    ob = sum(v.numel() * v.element_size() for v, _ in states)
    one_pb, one_ob = _whole_bytes(params), _whole_bytes(states)
    out = {"phase": "context_hybrid_gpt124m_ring",
           "batch_global": [CH_BATCH, CP_SEQ], "batch_rank": list(ids.shape),
           "heads_per_rank": cfg.num_heads // mesh.shape["mp"],
           "step_ms_each": [1e3 * s for s in secs],
           "step_ms_slowest_rank": slowest,
           "global_tokens_per_s": CH_BATCH * CP_SEQ / (slowest / 1e3),
           "global_losses": global_losses,
           "sep_exchanges_per_step": ex["exchanges"] / CH_TIMED,
           "sep_bytes_per_step": ex["bytes"] / CH_TIMED,
           "sep_ms_per_step": ex["ms"] / CH_TIMED,
           "mp_calls_per_step": comm["calls"],
           "mp_bytes_per_step": comm["bytes"],
           "mp_ms_per_step": comm["ms"], "metered_step_ms": 1e3 * metered_s,
           "comm_plane_works_per_step":
               (plane["works"] - ex["exchanges"]) / CH_TIMED,
           "comm_plane_ms_per_step":
               (plane["comm_ms"] - ex["ms"]) / CH_TIMED,
           "peak_memory_bytes": peak,
           "param_bytes": pb, "optimizer_bytes": ob,
           "one_process_param_bytes": one_pb,
           "one_process_optimizer_bytes": one_ob,
           "param_plus_adamw_ratio": (pb + ob) / (one_pb + one_ob),
           "flash_launches_per_step": [per, per]}
    del model, net, opt, step
    torch.cuda.empty_cache()
    return out


def context_hybrid_rank(torch, out_dir):
    """One rank of the context_hybrid path (started by the launcher):
    sharding 2 x sep 2 x mp 2 after ``fleet.init`` (the fp32 gates, rank 0
    printing their rows, then GPT-124M's timed steps), then pp 2 x sharding
    2 x sep 2 (the pipe gate). Prints one JSON line per phase and last its
    launches by route."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env(timeout=DP_RANK_TIMEOUT_S)
    _wait_ready(out_dir)
    rank, world = env.rank, env.world_size
    if dist.get_backend() != "gloo" or world != CH_RANKS:
        raise AssertionError(f"backend {dist.get_backend()}, world {world}")
    ck.reset_launch_counts()
    mesh = _hp_fleet(fleet, sharding_degree=2, sep_degree=2, mp_degree=2)
    c = [mesh.coord[a] for a in ("sharding", "sep", "mp")]
    if rank != 4 * c[0] + 2 * c[1] + c[2]:
        raise AssertionError(f"mesh {mesh}")
    one = torch.load(f"{out_dir}/ch_one.pt", mmap=True)

    def timed(run):
        t0 = time.perf_counter()
        row = run()
        return dict(row, seconds=time.perf_counter() - t0)

    for mode, level in CH_EXACT:
        row = timed(lambda: ch_exact_rank(torch, ck, dist, rank, mesh,
                                          out_dir, mode, level, one))
        if rank == 0:
            _rank_emit(rank, row)
    del one
    _rank_emit(rank, timed(lambda: ch_gpt124m_rank(torch, ck, dist, mesh)))
    mesh = _hp_fleet(fleet, pp_degree=2, sharding_degree=2, sep_degree=2)
    c = [mesh.coord[a] for a in ("pp", "sharding", "sep")]
    if rank != 4 * c[0] + 2 * c[1] + c[2]:
        raise AssertionError(f"mesh {mesh}")
    row = timed(lambda: ch_pipe_exact_rank(torch, dist, rank, mesh, out_dir))
    if rank == 0:
        _rank_emit(rank, row)
    _rank_emit(rank, {"rank_launches": {k.name: dict(k.route_launches)
                                        for k in ck.KERNELS}})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _ch_one_process(torch, tmp):
    """The one-process fp32 steps the ranks' gates are held to, from the
    same weights on the whole ``_ch_exact_batch``: GPT-124M's widths at 2
    layers (``ch_one.pt``) and the unpipelined ``GPTForPretrainingPipe`` at
    ``CH_PIPE_LAYERS`` (``ch_pipe_one.pt``)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import (GPTConfig, GPTForPretraining,
                                           GPTForPretrainingPipe)
    ids, labels = _ch_exact_batch(torch)
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12,
                    max_seq_len=CP_EXACT_SEQ)
    model = GPTForPretraining(cfg, device=CH_DEVICE, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    _one_process_step(torch, model, opt, ids, labels, f"{tmp}/ch_one.pt")
    del model, opt
    cfg = GPTConfig(hidden_size=768, num_layers=CH_PIPE_LAYERS, num_heads=12,
                    max_seq_len=CP_EXACT_SEQ)
    model = GPTForPretrainingPipe(cfg, device=CH_DEVICE, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    _one_process_step(torch, model, opt, ids, labels,
                      f"{tmp}/ch_pipe_one.pt")
    del model, opt
    if CH_DEVICE == "cuda":
        torch.cuda.empty_cache()


def phase_context_hybrid(torch, ck, smi):
    """The context_hybrid path: this process's one-process fp32 steps,
    eight gloo ranks (the SP + CP gates under ZeRO and the checkpoint round
    trip at sharding 2 x sep 2 x mp 2, GPT-124M's timed ring steps, the
    pipe gate at pp 2 x sharding 2 x sep 2), then the ranks' checkpoint
    loaded whole here. The ranks' kernel launches are added to this
    process's counts."""
    import shutil
    import tempfile

    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ch_")
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _run_ranks(CH_RANKS, "--context-hybrid-rank", tmp,
                           {"PADDLE_DISTRI_BACKEND": "gloo",
                            "OMP_NUM_THREADS": "1"},
                           prepare=lambda: _ch_one_process(torch, tmp))
        t_ranks = time.perf_counter() - t0
        for rows in ranks.values():
            for row in rows[:-1]:
                emit(row)
            ck.add_launches(rows[-1]["rank_launches"])
        _exactness_held(ranks, "context_hybrid_exactness_fp32_",
                        len(CH_EXACT) + 1)
        ckpt = _checkpoint_loaded_whole(
            torch, tmp, "ch_ckpt", GPTForPretraining(
                GPTConfig(hidden_size=768, num_layers=2, num_heads=12,
                          max_seq_len=CP_EXACT_SEQ),
                device=CH_DEVICE, seed=1),
            CH_RANKS, "context_hybrid_checkpoint_whole")
        got = [next(r for r in rows
                    if r.get("phase") == "context_hybrid_gpt124m_ring")
               for rows in ranks.values()]
        slowest = max(g["step_ms_slowest_rank"] for g in got)
        emit(dict(
            {k: [g[k] for g in got] for k in (
                "sep_exchanges_per_step", "sep_bytes_per_step",
                "sep_ms_per_step", "mp_calls_per_step", "mp_bytes_per_step",
                "mp_ms_per_step", "comm_plane_works_per_step",
                "comm_plane_ms_per_step", "peak_memory_bytes",
                "param_bytes", "optimizer_bytes", "param_plus_adamw_ratio")},
            phase="context_hybrid", nvidia_smi=smi, ranks=CH_RANKS,
            backend="gloo", mesh={"sharding": 2, "sep": 2, "mp": 2},
            transport="sep exchanges, mp sums and ZeRO's collectives staged "
                      "through the host (gloo, CUDA tensors)",
            batch_global=[CH_BATCH, CP_SEQ], step_ms_slowest_rank=slowest,
            global_tokens_per_s=CH_BATCH * CP_SEQ / (slowest / 1e3),
            global_losses=got[0]["global_losses"],
            flash_launches_per_step=got[0]["flash_launches_per_step"],
            one_process_param_bytes=got[0]["one_process_param_bytes"],
            one_process_optimizer_bytes=got[0][
                "one_process_optimizer_bytes"],
            ranks_s=t_ranks, checkpoint_whole_load_s=ckpt["load_s"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- the elastic path -------------------------------------------------------------
# GPT-124M at bench.py's widths under the port's elastic launcher: two agents
# (--nnodes 2 --min_nnodes 1, one trainer each, gloo ranks sharing the card),
# agent 0 hosting the membership store. Generation 0 runs at world 2 until
# node 0's trainer exits after step EL_FAIL_AFTER (the planted fault: it
# consumes node 0's restart budget); generation 1 resumes at world 2 from the
# step-4 checkpoint and parks after step EL_PARK_AT's; then node 1's agent and
# trainer are killed and node 0 goes on alone at world 1 from the step-6
# checkpoint, the whole 16 x 1024 on one rank.
EL_NODES, EL_STEPS, EL_CKPT_EVERY = 2, 8, 2
EL_FAIL_AFTER, EL_PARK_AT, EL_GATE_STEP = 5, 6, 7
EL_FAIL_RC = 13
EL_TIMEOUT_S = 300
# the agents' tuning (the reference's knobs, small as its chaos tests set
# them): a heartbeat every 0.2 s, a peer dead after 1.2 s of silence, a
# round at fewer than nnodes closed 2 s after min_nnodes arrived (longer
# than the two agents' start-up can drift apart, so generation 0 forms at
# world 2)
EL_ENV = {"PADDLE_ELASTIC_HB_INTERVAL": "0.2",
          "PADDLE_ELASTIC_HB_TIMEOUT": "1.2",
          "PADDLE_ELASTIC_LAST_CALL": "2.0",
          "PADDLE_ELASTIC_RDZV_TIMEOUT": "120",
          "PADDLE_ELASTIC_GRACE": "5.0",
          "PADDLE_ELASTIC_KEEP_CKPTS": "2"}
EL_NODE_ENV = "CHIP_SMOKE_ELASTIC_NODE"


def _el_batch(torch, cfg, step, device):
    """Step ``step``'s global batch, [TRAIN_BATCH, seq] ids and labels, a
    function of the step alone."""
    ids, labels = _seeded_ids(torch, cfg.vocab_size,
                              (TRAIN_BATCH, cfg.max_seq_len),
                              seed=1000 + step)
    return ids.to(device), labels.to(device)


def _norm_probe():
    """A global-norm clip with no bound (``ClipGradByGlobalNorm(inf)``: it
    scales by exactly 1) that keeps the step's global gradient norm in
    ``.norm``."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    class Probe(ClipGradByGlobalNorm):
        def global_scale(self, grads):
            import torch
            sq = sum(torch.sum(torch.square(g.float())) for g in grads)
            self.norm = torch.sqrt(sq)
            return super().global_scale(grads)

    return Probe(math.inf)


def _el_build(torch, seed, device):
    """GPT-124M (``gpt_small``), AdamW lr 1e-4 with the norm probe, from
    ``seed``; the step is built after any load (``_el_step``)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device=device, seed=seed)
    probe = _norm_probe()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                grad_clip=probe)
    return cfg, model, opt, probe


def _el_step(model, opt):
    from paddle_tpu_torch.jit import CompiledTrainStep
    return CompiledTrainStep(lambda i, lb: model(i, labels=lb)[1], model,
                             opt, amp_level="O2")


def _el_load(model, opt, path):
    """``distributed.checkpoint`` of ``path`` into the model and the
    optimizer (the skeleton's accumulators made first)."""
    from paddle_tpu_torch.distributed import checkpoint as dck
    for q in model.parameters():
        opt._get_accumulators(q)
    skeleton = {"model": model.state_dict(), "opt": opt.state_dict()}
    dck.load_state_dict(skeleton, path)
    opt.set_state_dict(skeleton["opt"])


def _el_sync(torch, t):
    """Wait for the work queued on ``t``'s card (nothing on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def elastic_rank(torch, out_dir, device="cuda"):
    """One trainer of the elastic path, started by an agent: resumes from
    ``latest_checkpoint()`` (or step 1), keeps its rank's rows of each
    step's global batch, checkpoints every ``EL_CKPT_EVERY`` steps through
    ``distributed.checkpoint`` and ``mark_complete``. The planted faults:
    on node 0 in a process of restart 0, exit ``EL_FAIL_RC`` after step
    ``EL_FAIL_AFTER``; at world 2, park after step ``EL_PARK_AT``'s
    checkpoint until torn down. Prints one JSON line per step (loss, global
    gradient norm, ms, wall clock, its K2/K3 launches), and at world 1
    after ``EL_GATE_STEP`` the parameters' digest."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.distributed import elastic
    from paddle_tpu_torch.ops import cuda_kernels as ck
    walls = {"process": _PROCESS_T0, "main": time.time()}
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    gen = int(os.environ.get(elastic.GENERATION_ENV, "0"))
    restarts = elastic.restart_count()
    node = int(os.environ[EL_NODE_ENV])
    if world > 1:
        dist.init_parallel_env(device=device, timeout=EL_TIMEOUT_S)
    walls["group"] = time.time()
    # the newest intact checkpoint (its digests checked) is found while the
    # model builds
    found = []
    finder = threading.Thread(
        target=lambda: found.append(elastic.latest_checkpoint()))
    finder.start()
    cfg, model, opt, probe = _el_build(torch, 1, device)
    some = next(model.parameters())
    _el_sync(torch, some)
    walls["built"] = time.time()
    finder.join()
    found = found[0]
    walls["found"] = time.time()
    first = 1
    if found is not None:
        _el_load(model, opt, found)
        first = int(found.rsplit("_", 1)[1]) + 1
    _el_sync(torch, some)
    walls["loaded"] = time.time()
    step = _el_step(model, opt)
    ck.reset_launch_counts()
    rows = TRAIN_BATCH // world
    emit({"phase": "elastic_rank", "rank": rank, "world": world,
          "generation": gen, "restarts": restarts, "node": node,
          "first_step": first, "resumed_from": found, "walls": walls})
    pending = []

    def settle(row):
        """The pending checkpoints on disk on every rank (their writers
        joined, then a barrier), then marked complete by rank 0, oldest
        first."""
        if not pending:
            return
        for _, handle, _ in pending:
            handle.wait(timeout=EL_TIMEOUT_S)
        if world > 1:
            dist.barrier()
        for path, _, t0 in pending:
            if rank == 0:
                elastic.mark_complete(path)
            row.setdefault("checkpoint_done_s", []).append(
                (int(path.rsplit("_", 1)[1]), time.perf_counter() - t0))
        pending.clear()

    for s in range(first, EL_STEPS + 1):
        ids, labels = _el_batch(torch, cfg, s, device)
        ids, labels = (t[rank * rows:(rank + 1) * rows] for t in (ids, labels))
        before = _route_counts(ck)
        _el_sync(torch, ids)
        t0 = time.perf_counter()
        loss = step(ids, labels)
        _el_sync(torch, loss)
        ms = (time.perf_counter() - t0) * 1e3
        row = {"phase": "elastic_step", "rank": rank, "world": world,
               "generation": gen, "node": node, "step": s,
               "loss": loss.item(), "grad_norm": probe.norm.item(),
               "ms": ms, "wall": time.time(),
               "launches": {n: {r: c - before[n][r]
                                for r, c in routes.items()}
                            for n, routes in _route_counts(ck).items()}}
        if s % EL_CKPT_EVERY == 0 and s < EL_STEPS:
            # written while the next steps run; settled at the fault, the
            # park or the end
            path = elastic.checkpoint_path(s)
            t0 = time.perf_counter()
            handle = dck.save_state_dict(
                {"model": model.state_dict(), "opt": opt.state_dict()},
                path, async_save=True)
            row["checkpoint_blocked_s"] = time.perf_counter() - t0
            pending.append((path, handle, t0))
        if world == 1 and s == EL_GATE_STEP:
            row["params_digest"] = _digest(model.parameters())
        if loss.is_cuda:
            row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        # settled on every rank at the same steps: the fault's, the park's
        # and the last
        if s == EL_FAIL_AFTER or (world > 1 and s == EL_PARK_AT) or \
                s == EL_STEPS:
            settle(row)
        faulty = node == 0 and restarts == 0 and s == EL_FAIL_AFTER
        emit(row)
        if faulty:
            emit({"phase": "elastic_fault", "rank": rank, "step": s,
                  "wall": time.time()})
            os._exit(EL_FAIL_RC)   # the planted fault: no teardown
        if world > 1 and s == EL_PARK_AT:
            emit({"phase": "elastic_parked", "rank": rank, "step": s,
                  "wall": time.time()})
            while True:           # until the agent tears this pod down
                time.sleep(0.05)
    return 0


def _el_logs(tmp):
    """Every JSON line of every trainer's log under ``tmp``, by (node,
    generation)."""
    out = {}
    for node in range(EL_NODES):
        base = os.path.join(tmp, f"node{node}")
        if not os.path.isdir(base):
            continue
        for gdir in sorted(os.listdir(base)):
            for name in os.listdir(os.path.join(base, gdir)):
                with open(os.path.join(base, gdir, name)) as f:
                    rows = out.setdefault((node, int(gdir[3:])), [])
                    for line in f:
                        if line.startswith("{") and line.endswith("\n"):
                            try:
                                rows.append(json.loads(line))
                            except ValueError:
                                pass   # a killed trainer's torn line
    return out


def _el_wait(what, pred, deadline, procs):
    """Poll ``pred()`` until it holds; fail at ``deadline`` or when an
    agent in ``procs`` has exited."""
    while not pred():
        for i, p in procs.items():
            if p.poll() is not None:
                raise AssertionError(f"elastic: agent {i} exited rc "
                                     f"{p.returncode} waiting for {what}")
        if time.monotonic() > deadline:
            raise AssertionError(f"elastic: timed out waiting for {what}")
        time.sleep(0.02)


def _el_one_process(torch, ckdir, device):
    """Step ``EL_GATE_STEP`` in this process from the step-``EL_PARK_AT``
    checkpoint on the whole global batch: (loss, gradient norm, the
    parameters' digest)."""
    from paddle_tpu_torch.distributed import elastic
    cfg, model, opt, probe = _el_build(torch, 2, device)
    _el_load(model, opt, elastic.checkpoint_path(EL_PARK_AT, ckdir))
    loss = _el_step(model, opt)(*_el_batch(torch, cfg, EL_GATE_STEP,
                                           device))
    out = (loss.item(), probe.norm.item(), _digest(model.parameters()))
    del model, opt
    torch.cuda.empty_cache()
    return out


def phase_elastic(torch, ck, smi, script=None, device="cuda"):
    """The elastic path: two agents through ``python -m paddle_tpu_torch.
    distributed.launch --elastic`` (agent 0 hosting the store), the local
    failure and its restart, node 1 killed and the scale-in to world 1, the
    world-1 step held here to one process's step from the same checkpoint.
    The trainers' kernel launches are added to this process's counts.
    ``script`` is the trainers' program (this file by default), and
    ``device`` where this process's one-process step runs."""
    import shutil
    import signal
    import tempfile

    from paddle_tpu_torch.distributed.env import find_free_port
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.text.gpt import gpt_small
    cfg = gpt_small()
    root = os.path.dirname(os.path.abspath(__file__))
    script = script or os.path.join(root, "chip_smoke.py")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_el_")
    ckdir = os.path.join(tmp, "ckpt")
    master = f"127.0.0.1:{find_free_port()}"
    env = dict(os.environ, PYTHONPATH=root, PADDLE_DISTRI_BACKEND="gloo",
               PADDLE_ELASTIC_CKPT_DIR=ckdir, **EL_ENV)
    env.pop("PADDLE_MASTER", None)
    agents, logs = {}, []
    t0 = time.monotonic()
    wall0 = time.time()
    deadline = t0 + EL_TIMEOUT_S
    torch.cuda.empty_cache()
    try:
        # node 1 first: its store client waits for node 0's server, so both
        # join generation 0 together
        for node in (1, 0):
            log = open(os.path.join(tmp, f"agent{node}.log"), "w")
            logs.append(log)
            agents[node] = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                 "--elastic", "--nnodes", str(EL_NODES), "--min_nnodes", "1",
                 "--nproc_per_node", "1", "--max_restarts", "3",
                 "--master", master, *(["--host_store"] if node == 0 else []),
                 "--log_dir", os.path.join(tmp, f"node{node}"),
                 script, "--elastic-rank", tmp],
                cwd=root, env=dict(env, **{EL_NODE_ENV: str(node)}),
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)

        def parked():
            return sum(r.get("phase") == "elastic_parked"
                       for rows in _el_logs(tmp).values()
                       for r in rows) == EL_NODES

        _el_wait("generation 1's trainers to park", parked, deadline,
                 agents)
        host, port = master.split(":")
        store = TCPStore(host=host, port=int(port), timeout=30)
        try:
            gen_parked = int(store.get("__el/gen"))
            os.killpg(agents[1].pid, signal.SIGKILL)
            t_kill = time.time()
            agents[1].wait()
            _el_wait("the survivor's generation bump",
                     lambda: int(store.get("__el/gen")) > gen_parked,
                     deadline, {0: agents[0]})
            detect_s = time.time() - t_kill
        finally:
            store.close()
        one_loss, one_norm, one_digest = _el_one_process(torch, ckdir,
                                                         device)
        rc0 = agents[0].wait(timeout=max(1.0, deadline - time.monotonic()))
        path_s = time.monotonic() - t0
        by = _el_logs(tmp)
        agent_logs = [open(os.path.join(tmp, f"agent{n}.log")).read()
                      for n in range(EL_NODES)]
    finally:
        for p in agents.values():
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    rows = [r for rs in by.values() for r in rs]
    starts = sorted((r for r in rows if r.get("phase") == "elastic_rank"),
                    key=lambda r: (r["generation"], r["rank"]))
    steps = [r for r in rows if r.get("phase") == "elastic_step"]
    faults = [r for r in rows if r.get("phase") == "elastic_fault"]
    gens = sorted({r["generation"] for r in starts})
    per_gen = []
    for g in gens:
        mine = [r for r in starts if r["generation"] == g]
        per_gen.append({"generation": g, "world": mine[0]["world"],
                        "first_step": mine[0]["first_step"],
                        "resumed_from": mine[0]["resumed_from"] and
                        os.path.basename(mine[0]["resumed_from"]),
                        "restarts_by_node": {r["node"]: r["restarts"]
                                             for r in mine},
                        "rank_by_node": {r["node"]: r["rank"]
                                         for r in mine}})

    def at(gen, s):
        return {r["rank"]: r for r in steps
                if r["generation"] == gen and r["step"] == s}

    failures = []
    if [(g["world"], g["first_step"]) for g in per_gen] != \
            [(2, 1), (2, EL_FAIL_AFTER), (1, EL_PARK_AT + 1)]:
        failures.append(f"generations {per_gen}: not world 2 from step 1, "
                        f"world 2 from step {EL_FAIL_AFTER}, world 1 from "
                        f"step {EL_PARK_AT + 1}")
        gens = (gens + [None] * 3)[:3]
    g0, g1, g2 = gens[:3]
    before = {r: (v["loss"], v["grad_norm"])
              for r, v in at(g0, EL_FAIL_AFTER).items()}
    after = {r: (v["loss"], v["grad_norm"])
             for r, v in at(g1, EL_FAIL_AFTER).items()}
    if len(before) != EL_NODES or before != after:
        failures.append(f"step {EL_FAIL_AFTER} after the restart {after} "
                        f"!= before it {before}")
    gate = at(g2, EL_GATE_STEP).get(0)
    one = (one_loss, one_norm, one_digest)
    if gate is None or (gate["loss"], gate["grad_norm"],
                        gate["params_digest"]) != one:
        failures.append(f"world-1 step {EL_GATE_STEP} {gate} != one "
                        f"process's from the step-{EL_PARK_AT} checkpoint "
                        f"{one}")
    restarts = [g["restarts_by_node"] for g in per_gen]
    if restarts[1:] != [{0: 1, 1: 0}, {0: 1}]:
        failures.append(f"restart counts by generation and node {restarts}:"
                        " not node 0's 1 after its fault and after the "
                        "scale-in")
    if rc0 != 0:
        failures.append(f"agent 0 exited {rc0}")
    if len(faults) != 1:
        failures.append(f"planted faults {faults}")
    # K2 and K3 once per layer and step on the card; the plain versions
    # on the CPU count nothing
    n = cfg.num_layers if torch.device(device).type == "cuda" else 0
    bad = [(r["generation"], r["rank"], r["step"]) for r in steps
           if (r["launches"]["flash_fwd"]["bf16"],
               r["launches"]["flash_bwd"]["bf16"]) != (n, n)]
    if bad:
        failures.append(f"K2/K3 bf16 launches not {n} a step at "
                        f"(generation, rank, step) {bad}")
    for r in steps:
        ck.add_launches(r["launches"])

    def warm_ms(world):
        """The median over warm steps (not a process's first) of the
        slowest rank's step ms."""
        first = {g["generation"]: g["first_step"] for g in per_gen}
        by_step = {}
        for r in steps:
            if r["world"] == world and r["step"] > first[r["generation"]]:
                key = (r["generation"], r["step"])
                by_step[key] = max(by_step.get(key, 0.0), r["ms"])
        return statistics.median(by_step.values()) if by_step else None

    g1_walls = [r["wall"] for r in steps if r["generation"] == g1]
    # each trainer's start-up and steps, in seconds from the path's start
    timeline = [dict({k: round(v - wall0, 3)
                      for k, v in r["walls"].items()},
                     generation=r["generation"], rank=r["rank"],
                     steps=[(x["step"], round(x["wall"] - wall0, 3))
                            for x in steps
                            if (x["generation"], x["rank"]) ==
                            (r["generation"], r["rank"])])
                for r in starts]
    timeline.append({"kill": round(t_kill - wall0, 3),
                     "fault": faults and round(faults[0]["wall"] - wall0,
                                               3)})
    tokens = TRAIN_BATCH * cfg.max_seq_len
    ms2, ms1 = warm_ms(2), warm_ms(1)
    emit({"phase": "elastic", "nvidia_smi": smi,
          "model": "gpt_small (GPT-124M), CompiledTrainStep O2 bf16, AdamW "
                   "lr 1e-4, 16 x 1024 global a step, seed 1",
          "launcher": "--elastic --nnodes 2 --min_nnodes 1 "
                      "--nproc_per_node 1 --max_restarts 3, agent 0 "
                      "--host_store", "env": EL_ENV,
          "generations": per_gen,
          "fault": faults[0] if faults else None,
          "detection_s": detect_s,
          "restart_s": (min(g1_walls) - faults[0]["wall"]
                        if faults and g1_walls else None),
          "checkpoint_blocked_s": [(r["generation"], r["rank"], r["step"],
                                    r["checkpoint_blocked_s"])
                                   for r in steps
                                   if "checkpoint_blocked_s" in r],
          "checkpoint_done_s": [(r["generation"], r["rank"], saved, s)
                                for r in steps
                                for saved, s in r.get("checkpoint_done_s",
                                                      [])],
          "timeline_s": timeline,
          "step_ms_world2": ms2, "step_ms_world1": ms1,
          "tokens_per_s_world2": ms2 and tokens / ms2 * 1e3,
          "tokens_per_s_world1": ms1 and tokens / ms1 * 1e3,
          "peak_memory_bytes_per_rank": max(
              (r.get("peak_memory_bytes", 0) for r in steps), default=None),
          "losses": sorted((r["generation"], r["rank"], r["step"], r["loss"],
                            r["grad_norm"]) for r in steps),
          f"step_{EL_FAIL_AFTER}_before_after": [before, after],
          "world1_gate": {"trainer": gate and [gate["loss"],
                                               gate["grad_norm"]],
                          "one_process": [one_loss, one_norm],
                          "params_bit_equal": gate is not None and
                          gate.get("params_digest") == one_digest},
          "flash_launches": {k: sum(r["launches"][k]["bf16"] for r in steps)
                             for k in ("flash_fwd", "flash_bwd")},
          "trainer_steps": len(steps), "agent0_rc": rc0, "path_s": path_s})
    if failures:
        raise AssertionError("; ".join(failures) + "\nagent 0: "
                             f"{agent_logs[0][-3000:]}\nagent 1: "
                             f"{agent_logs[1][-3000:]}")


def paged_bound(torch, q, kp, bt, cl):
    """Least time for K1 on these inputs: bytes each slot's visible rows
    need (K and V once, the table entries it reads, q, lens, out) versus
    its flops, at the inputs' type."""
    b, kq, h, d = q.shape
    page = kp.shape[1]
    elt = q.element_size()
    ctxs = cl.tolist()
    toks = sum(c + kq - 1 for c in ctxs if c > 0)
    pages = sum(-(-(c + kq - 1) // page) for c in ctxs if c > 0)
    nbytes = 2 * toks * h * d * elt + 2 * q.numel() * elt + 4 * pages \
        + 4 * b
    flops = sum(4 * h * d * (c + j) for c in ctxs if c > 0
                for j in range(kq))
    return bound_of(nbytes, flops, q.dtype)


def flash_bound(q, k, causal):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    elt = q.element_size()
    nbytes = 2 * q.numel() * elt + 2 * k.numel() * elt + 4 * b * h * sq
    pairs = sum(min(sk, r + sk - sq + 1) for r in range(sq)) if causal \
        else sq * sk
    return bound_of(nbytes, 4 * b * h * d * pairs, q.dtype)


def bound_of(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S[str(dtype)[6:]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_paged(torch, ck, ctxs, kq, dtype, launches, label):
    """K1 on ``paged_case`` inputs: CUDA events over 200 calls and the
    profiler's device time (the split and combine launches) beside its
    bound and its plain version."""
    q, kp, vp, bt, cl = paged_case(torch, ctxs, kq, dtype)

    def kernel():
        return ck.paged_attention_verify_decode(q, kp, vp, bt, cl)

    ms = cuda_time_ms(kernel, 200)
    dev_ms = device_time_ms(kernel)
    plain_ms = cuda_time_ms(
        lambda: ck.paged_attention_verify_reference(q, kp, vp, bt, cl), 20)
    bound_ms, bound_by = paged_bound(torch, q, kp, bt, cl)
    err = max_err(kernel(),
                  ck.paged_attention_verify_reference(q, kp, vp, bt, cl))
    b, _, h, d = q.shape
    shown = ctxs if len(set(ctxs)) > 1 else f"{len(ctxs)} x {ctxs[0]}"
    return {"name": "paged_attention", "route": "cuda",
            "source": ck.PAGED_ATTENTION.source,
            "replaces": ck.PAGED_ATTENTION.replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": dev_ms, "case": label,
            "shape": f"B={b} KQ={kq} h={h} d={d} page={kp.shape[1]} "
                     f"ctx={shown} {str(dtype)[6:]}"}


def time_flash(torch, ck, case, dtype, launches):
    label, b, sq, sk, h, kh, d, causal = case
    q, k, v = flash_case(torch, b, sq, sk, h, kh, d, dtype)
    ms = cuda_time_ms(
        lambda: ck.flash_attention_with_lse(q, k, v, causal=causal), 100)
    dev_ms = device_time_ms(
        lambda: ck.flash_attention_with_lse(q, k, v, causal=causal))
    plain_ms = cuda_time_ms(
        lambda: ck.flash_attention_reference(q, k, v, causal=causal), 10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # with no mask the two compute the same function at any sq, sk
    same = sdpa_same_function(q, k) or (
        not causal and k.shape[2] == q.shape[2])
    library_ms = cuda_time_ms(
        lambda: sdpa(qt, kt, vt, is_causal=causal), 100) if same else None
    library_dev_ms = device_time_ms(
        lambda: sdpa(qt, kt, vt, is_causal=causal)) if same else None
    bound_ms, bound_by = flash_bound(q, k, causal)
    ref = ck.flash_attention_reference(q, k, v, causal)[0]
    err = max_err(ck.flash_attention_with_lse(q, k, v, causal)[0], ref)
    lib_err = max_err(sdpa_forward(torch, q, k, v, causal), ref) \
        if same else None
    return {"name": "flash_fwd", "route": "cuda",
            "source": ck.FLASH_FWD.source, "replaces": ck.FLASH_FWD.replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_call": "torch.nn.functional."
                            "scaled_dot_product_attention",
            "library_max_abs_err": lib_err, "device_ms": dev_ms,
            "library_device_ms": library_dev_ms,
            "shape": f"[{b}, {sq}, {h}, {d}] kv [{b}, {sk}, {kh}, {d}] "
                     f"causal={causal} {str(dtype)[6:]}"}


def flash_bwd_bound(q, k, causal):
    """Least time for K3: q, k, v, o, do read and dq, dk, dv written once,
    lse read once, against 10 * d flops per visible (q, kv) pair."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    elt = q.element_size()
    nbytes = 5 * q.numel() * elt + 3 * k.numel() * elt + 4 * b * h * sq
    pairs = sum(min(sk, r + sk - sq + 1) for r in range(sq)) if causal \
        else sq * sk
    return bound_of(nbytes, 10 * b * h * d * pairs, q.dtype)


def time_flash_bwd(torch, ck, case, dtype, launches):
    label, b, sq, sk, h, kh, d, causal = case
    args = flash_bwd_inputs(torch, ck, b, sq, sk, h, kh, d, causal, dtype,
                            dlse=False)
    q, k, v, o, lse, do, _ = args
    ms = cuda_time_ms(lambda: ck.flash_attention_bwd(*args, causal=causal),
                      20)
    # the wrapper's device time: delta = rowsum(do * o), then the two passes
    dev_ms = device_time_ms(
        lambda: ck.flash_attention_bwd(*args, causal=causal))
    plain_ms = cuda_time_ms(
        lambda: ck.flash_attention_bwd_reference(*args, causal=causal), 5,
        warmup=1)
    # yardstick: the backward alone of PyTorch's fused attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2).contiguous()
    library_ms = cuda_time_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                    retain_graph=True), 20)
    library_dev_ms = device_time_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                    retain_graph=True))
    bound_ms, bound_by = flash_bwd_bound(q, k, causal)
    ref = ck.flash_attention_bwd_reference(*args, causal=causal)
    err = max(max_err(a, r) for a, r in zip(
        ck.flash_attention_bwd(*args, causal=causal), ref))
    lib_err = max(max_err(a, r) for a, r in zip(
        sdpa_backward(torch, q, k, v, do, causal), ref))
    return {"name": "flash_bwd", "route": "cuda",
            "source": ck.FLASH_BWD.source, "replaces": ck.FLASH_BWD.replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_call": "backward of torch.nn.functional."
                            "scaled_dot_product_attention",
            "library_max_abs_err": lib_err, "device_ms": dev_ms,
            "library_device_ms": library_dev_ms,
            "shape": f"[{b}, {sq}, {h}, {d}] kv [{b}, {sk}, {kh}, {d}] "
                     f"causal={causal} {str(dtype)[6:]}"}


def packed_bound(q, k, cu, pairs, backward):
    """Least time for K4 (q, k, v, o, lse and cu moved once against
    4 * d flops per visible pair and head) or K5 (q, k, v, o, do, dq, dk,
    dv, lse, delta and cu against 10 * d)."""
    tq, h, d = q.shape
    elt = q.element_size()
    stats = 4 * h * tq
    if backward:
        nbytes = 4 * q.numel() * elt + 4 * k.numel() * elt + 2 * stats
    else:
        nbytes = 2 * q.numel() * elt + 2 * k.numel() * elt + stats
    flops = (10 if backward else 4) * d * h * pairs
    return bound_of(nbytes + 4 * cu.numel(), flops, q.dtype)


def time_packed(torch, ck, launches, dtype=None):
    """K4 and K5 at the packed-attention shape, each beside its plain
    version and the varlen flash op PyTorch ships
    (``torch.ops.aten._flash_attention_forward`` / ``_backward`` with
    cum_seq_q / cum_seq_k), which the port never calls; by CUDA events and
    by profiler device time (the library's backward reads host-bound on
    the events)."""
    dtype = dtype or torch.bfloat16
    lens, q, k, v, do, cu = packed_attention(torch, dtype)
    q, k, v = q.detach(), k.detach(), v.detach()
    tq, h, d = q.shape
    longest = max(lens)
    pairs = visible_pairs(lens, lens, True)
    plan = ck.varlen_plan(cu, cu, tq, tq, True)
    plan_ms = cuda_time_ms(lambda: ck.varlen_plan(cu, cu, tq, tq, True), 20)
    o, lse = ck.flash_attention_varlen_fwd(q, k, v, cu, cu, True, plan=plan)
    ro, rlse = ck.flash_attention_varlen_reference(q, k, v, cu, cu, True)
    bargs = (q, k, v, o, lse, do, cu, cu, True)
    dgot = ck.flash_attention_varlen_bwd(*bargs, plan=plan)
    dref = ck.flash_attention_varlen_bwd_reference(*bargs)
    lib = varlen_library_fwd(torch, q, k, v, cu, cu, longest, longest, True)

    def kernel_fwd():
        return ck.flash_attention_varlen_fwd(q, k, v, cu, cu, True,
                                             plan=plan)

    def kernel_bwd():
        return ck.flash_attention_varlen_bwd(*bargs, plan=plan)

    def library_fwd():
        return varlen_library_fwd(torch, q, k, v, cu, cu, longest, longest,
                                  True)

    def library_bwd():
        return varlen_library_bwd(torch, do, q, k, v, lib, cu, cu, longest,
                                  longest, True)

    shape = (f"T={tq} ({len(lens)} causal segments of {min(lens)} to "
             f"{longest}) h={h} d={d} {str(dtype)[6:]}")
    fwd_bound, fwd_by = packed_bound(q, k, cu, pairs, backward=False)
    bwd_bound, bwd_by = packed_bound(q, k, cu, pairs, backward=True)
    rows = [
        {"name": "flash_varlen_fwd", "route": "cuda",
         "source": ck.FLASH_VARLEN_FWD.source,
         "replaces": ck.FLASH_VARLEN_FWD.replaces,
         "launches": launches["flash_varlen_fwd"],
         "max_abs_err": max_err(o, ro),
         "ms": cuda_time_ms(kernel_fwd, 20),
         "plain_ms": cuda_time_ms(lambda: ck.flash_attention_varlen_reference(
             q, k, v, cu, cu, True), 5, warmup=1),
         "bound_ms": fwd_bound, "bound_by": fwd_by,
         "library_ms": cuda_time_ms(library_fwd, 20),
         "library_call": "torch.ops.aten._flash_attention_forward "
                         "(cum_seq_q, cum_seq_k)",
         "library_max_abs_err": max_err(lib[0], ro),
         "device_ms": device_time_ms(kernel_fwd),
         "library_device_ms": device_time_ms(library_fwd),
         "plan_ms": plan_ms, "visible_pairs_per_head": pairs,
         "shape": shape},
        {"name": "flash_varlen_bwd", "route": "cuda",
         "source": ck.FLASH_VARLEN_BWD.source,
         "replaces": ck.FLASH_VARLEN_BWD.replaces,
         "launches": launches["flash_varlen_bwd"],
         "max_abs_err": max(max_err(a, r) for a, r in zip(dgot, dref)),
         "ms": cuda_time_ms(kernel_bwd, 20),
         "plain_ms": cuda_time_ms(
             lambda: ck.flash_attention_varlen_bwd_reference(*bargs), 5,
             warmup=1),
         "bound_ms": bwd_bound, "bound_by": bwd_by,
         "library_ms": cuda_time_ms(library_bwd, 20),
         "library_call": "torch.ops.aten._flash_attention_backward "
                         "(cum_seq_q, cum_seq_k)",
         "library_max_abs_err": max(max_err(a, r)
                                    for a, r in zip(library_bwd(), dref)),
         # the wrapper's device time: delta = rowsum(do * o), then the two
         # passes; the library's its own preprocessing and passes
         "device_ms": device_time_ms(kernel_bwd),
         "library_device_ms": device_time_ms(library_bwd),
         "visible_pairs_per_head": pairs, "shape": shape}]
    return rows


# -- the graph and deployment path (jit_inference) ----------------------------
def _pcts(ms):
    s = sorted(ms)
    return {"p50": s[len(s) // 2], "p90": s[int(0.9 * (len(s) - 1))],
            "mean": sum(s) / len(s)}


def _timed_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _jit_gate_fp32(torch, ck, gpt, cfg):
    """Gate 1: GPT-124M fp32 through ``to_static`` against the eager port
    at 2 x 1024: the logits, then one AdamW step's gradients, then the
    logits after the step (the captured program reads the live weights).
    Each within 1e-5 of its own largest entry."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.optimizer import AdamW
    ids, labels = (t.cuda() for t in _seeded_ids(
        torch, cfg.vocab_size, (JIT_EXACT_BATCH, 1024), seed=3))
    eager = type(gpt).forward
    with torch.no_grad():
        logits_eager = eager(gpt, ids)
    t0 = time.perf_counter()
    paddle.jit.to_static(gpt)
    with torch.no_grad():
        logits = gpt(ids)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    rel = lambda a, b: max_err(a, b) / float(b.float().abs().max())  # noqa
    logits_rel = rel(logits, logits_eager)
    opt = AdamW(learning_rate=1e-4, parameters=gpt.parameters())
    eager(gpt, ids, labels=labels)[1].backward()
    want = {n: p.grad.clone() for n, p in gpt.named_parameters()}
    opt.clear_grad()
    before = {k.name: k.launches for k in ck.KERNELS}
    loss = gpt(ids, labels=labels)[1]
    loss.backward()
    torch.cuda.synchronize()
    launches = {k.name: k.launches - before[k.name] for k in ck.KERNELS}
    grad_rel = {n: rel(p.grad, want[n]) for n, p in gpt.named_parameters()
                if float(want[n].abs().max()) > 0}
    worst = max(grad_rel, key=grad_rel.get)
    opt.step()
    opt.clear_grad()
    with torch.no_grad():
        after_rel = rel(gpt(ids), eager(gpt, ids))
    out = {"gate": "to_static_fp32", "batch": [JIT_EXACT_BATCH, 1024],
           "capture_s": capture_s, "logits_rel_err": logits_rel,
           "grad_max_rel_err": grad_rel[worst], "grad_worst": worst,
           "after_step_logits_rel_err": after_rel, "rel_tol": 1e-5,
           "loss": float(loss), "backward_launches": launches,
           "programs": len(gpt._static_forward.programs)}
    if max(logits_rel, grad_rel[worst], after_rel) > 1e-5:
        raise AssertionError(f"to_static differs from the eager port: {out}")
    if launches["flash_fwd"] != cfg.num_layers or \
            launches["flash_bwd"] != cfg.num_layers:
        raise AssertionError(f"to_static step launched {launches}")
    return out, logits_eager


def _jit_requests(torch, cfg, n):
    import numpy as np
    rng = np.random.default_rng(11)
    return [rng.integers(0, cfg.vocab_size, (JIT_BATCH, 1024))
            for _ in range(n)]


def _jit_gate_predictor(torch, ck, gpt, cfg, tmp):
    """Gate 2: the bf16 GPT saved by ``jit.save`` at [8, 1024] int64 and
    served by ``create_predictor`` through its handles: 1 request that
    captures the CUDA graph, then ``JIT_REQUESTS`` timed ones, each held
    to the eager bf16 forward within one bf16 ulp of the logits' largest
    magnitude, the last replay bit-equal to the uncaptured program. The
    eager and ``to_static`` forwards are timed on the same requests."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference
    spec = [paddle.static.InputSpec([JIT_BATCH, 1024], "int64")]
    path = os.path.join(tmp, "gpt124m")
    t0 = time.perf_counter()
    paddle.jit.save(gpt, path, input_spec=spec)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(
        path + ".pdmodel", path + ".pdiparams"))
    load_s = time.perf_counter() - t0
    reqs = _jit_requests(torch, cfg, JIT_REQUESTS + 1)
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(reqs[0])
    _, first_ms = _timed_ms(torch, pred.run)
    out_h = pred.get_output_handle(pred.get_output_names()[0])
    run_ms, copy_ms, eager_ms, static_ms, errs, tols = [], [], [], [], [], []
    launches, outs = [], []
    eager = type(gpt).forward
    with torch.no_grad():
        gpt_static = paddle.jit.to_static(gpt)
        t0 = time.perf_counter()
        gpt_static(torch.from_numpy(reqs[0]).cuda())
        static_capture_s = time.perf_counter() - t0
        for r in reqs[1:]:
            ids = torch.from_numpy(r).cuda()
            h.copy_from_cpu(r)
            before = ck.FLASH_FWD.launches
            _, ms = _timed_ms(torch, pred.run)
            launches.append(ck.FLASH_FWD.launches - before)
            run_ms.append(ms)
            copied, ms = _timed_ms(torch, out_h.copy_to_cpu)
            copy_ms.append(ms)
            want, ms = _timed_ms(torch, lambda: eager(gpt, ids))
            eager_ms.append(ms)
            _, ms = _timed_ms(torch, lambda: gpt_static(ids))
            static_ms.append(ms)
            # held on the card: the replayed graph's output against the
            # eager forward's
            got = pred._outputs[pred.get_output_names()[0]]
            errs.append(max_err(got, want))
            tols.append(ulp16(torch, float(want.float().abs().max()),
                              torch.bfloat16))
            if len(outs) < 2:
                outs.append(got.clone())
        copy_equal = bool((copied == got.float().cpu().numpy()).all())
        replay = got.clone()
        direct = pred._layer.run(torch.from_numpy(reqs[-1]).cuda())
        replay_equal = bool(torch.equal(replay, direct))
    p50 = _pcts(run_ms)["p50"]
    out = {"gate": "predictor_bf16", "batch": [JIT_BATCH, 1024],
           "requests": JIT_REQUESTS, "jit_save_s": save_s,
           "create_predictor_s": load_s,
           "first_run_ms_with_graph_capture": first_ms,
           "to_static_capture_s": static_capture_s,
           "eager_ms": _pcts(eager_ms), "to_static_ms": _pcts(static_ms),
           "predictor_run_ms": _pcts(run_ms),
           "copy_to_cpu_ms": _pcts(copy_ms),
           "tokens_per_s_predictor_p50": JIT_BATCH * 1024 / p50 * 1e3,
           "tokens_per_s_eager_p50":
               JIT_BATCH * 1024 / _pcts(eager_ms)["p50"] * 1e3,
           "k2_launches_per_request": sorted(set(launches)),
           "max_abs_err_vs_eager": max(errs),
           "tol_one_bf16_ulp_of_max": min(tols),
           "replay_bit_equal_uncaptured": replay_equal,
           "copy_to_cpu_equals_output": copy_equal,
           "pdmodel_bytes": os.path.getsize(path + ".pdmodel"),
           "pdiparams_bytes": os.path.getsize(path + ".pdiparams")}
    if any(e > t for e, t in zip(errs, tols)) or not replay_equal or \
            not copy_equal:
        raise AssertionError(f"the predictor differs: {out}")
    if set(launches) != {cfg.num_layers}:
        raise AssertionError(f"a request launched K2 {launches} times")
    return out, reqs[1:1 + len(outs)], outs


def _jit_gate_cpu_saved(torch, ck, cfg, tmp, reqs, outs):
    """Gate 3: the same bf16 weights built and saved on the CPU, loaded
    onto the card (``move_to_device_pass`` and the node devices); its
    outputs against gate 2's within gate 2's bound (expected bit-equal),
    with K2 launched per layer."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.text.gpt import GPTForPretraining
    cpu = GPTForPretraining(cfg, device="cpu", dtype=torch.bfloat16,
                            seed=0).eval()
    path = os.path.join(tmp, "gpt124m_cpu")
    t0 = time.perf_counter()
    paddle.jit.save(cpu, path, input_spec=[
        paddle.static.InputSpec([JIT_BATCH, 1024], "int64")])
    save_s = time.perf_counter() - t0
    del cpu
    t0 = time.perf_counter()
    layer = paddle.jit.load(path)
    load_s = time.perf_counter() - t0
    before = ck.FLASH_FWD.launches
    with torch.no_grad():
        errs = [max_err(layer(torch.from_numpy(r).cuda()), o)
                for r, o in zip(reqs, outs)]
    launches = ck.FLASH_FWD.launches - before
    tol = min(ulp16(torch, float(o.float().abs().max()), torch.bfloat16)
              for o in outs)
    out = {"gate": "cpu_saved_on_card", "jit_save_cpu_s": save_s,
           "load_to_card_s": load_s, "max_abs_err_vs_predictor": max(errs),
           "tol_one_bf16_ulp_of_max": tol, "requests": len(errs),
           "k2_launches": launches}
    if max(errs) > tol or launches != cfg.num_layers * len(errs):
        raise AssertionError(f"the CPU-saved program differs: {out}")
    return out


def _jit_gate_model_save(torch, gpt, tmp, reqs, outs):
    """Gate 4: ``hapi.Model(gpt, inputs=[InputSpec([8, 1024], "int64")])
    .save(path, training=False)``, loaded back: against gate 2 within its
    bound (expected bit-equal)."""
    import paddle_tpu_torch as paddle
    path = os.path.join(tmp, "model_infer")
    paddle.Model(gpt, inputs=[paddle.static.InputSpec(
        [JIT_BATCH, 1024], "int64")]).save(path, training=False)
    layer = paddle.jit.load(path)
    with torch.no_grad():
        errs = [max_err(layer(torch.from_numpy(r).cuda()), o)
                for r, o in zip(reqs, outs)]
    tol = min(ulp16(torch, float(o.float().abs().max()), torch.bfloat16)
              for o in outs)
    out = {"gate": "model_save_inference", "max_abs_err_vs_predictor":
           max(errs), "tol_one_bf16_ulp_of_max": tol}
    if max(errs) > tol:
        raise AssertionError(f"Model.save(training=False) differs: {out}")
    return out


def _jit_gate_static(torch, ck, cfg, logits_eager):
    """Gate 5: GPT-124M fp32 (the same seed as gate 1) built on
    ``static.data("ids", [2, 1024], "int64")`` and run by
    ``static.Executor``: against gate 1's eager logits within 1e-5 of
    their largest entry, K2 launched once per layer."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.text.gpt import GPTForPretraining
    gpt = GPTForPretraining(cfg, device="cuda", seed=0).eval()
    paddle.set_device("gpu")
    t0 = time.perf_counter()
    x = paddle.static.data("ids", [JIT_EXACT_BATCH, 1024], "int64")
    with torch.no_grad():
        logits = gpt(x)
    build_s = time.perf_counter() - t0
    ids, _ = _seeded_ids(torch, cfg.vocab_size, (JIT_EXACT_BATCH, 1024),
                         seed=3)
    exe = paddle.static.Executor()
    before = ck.FLASH_FWD.launches
    got, ms = _timed_ms(torch, lambda: exe.run(feed={"ids": ids},
                                               fetch_list=[logits])[0])
    launches = ck.FLASH_FWD.launches - before
    want = logits_eager.cpu().numpy()
    rel = float(abs(got - want).max()) / float(abs(want).max())
    out = {"gate": "static_executor_fp32", "batch": [JIT_EXACT_BATCH, 1024],
           "build_s": build_s, "run_ms": ms, "logits_rel_err": rel,
           "rel_tol": 1e-5, "k2_launches": launches}
    if rel > 1e-5 or launches != cfg.num_layers:
        raise AssertionError(f"the static Executor differs: {out}")
    return out


def _custom_op_cost(torch, ck):
    """K2 and K3 called straight (K2's ctypes entry, the K3 wrapper) and
    through their ops (``paddle_tpu_torch::flash_fwd``/``flash_bwd``), in
    bf16 at a request's shape, the kernels line's K2 shape ([1, 1024, 12,
    64], launch-bound) and K3's ([16, 1024, 12, 64]): ms per call by CUDA
    events and the profiler's device ms, each pair timed in turns
    (straight, op, straight, op) and the mean of the two kept."""
    bf16 = torch.bfloat16
    rows = []
    for case in (JIT_ATTENTION[0], FLASH_CASES[0]):
        label, b, sq, sk, h, kh, d, causal = case
        qkv = flash_case(torch, b, sq, sk, h, kh, d, bf16)
        fa = (*qkv, causal, 1.0 / math.sqrt(d))
        rows.append(("flash_fwd", label,
                     lambda fa=fa: ck._flash_fwd(*fa),
                     lambda fa=fa: ck.flash_fwd_op(*fa)))
    label, b, sq, sk, h, kh, d, causal = TRAIN_ATTENTION
    ba = (*flash_bwd_inputs(torch, ck, b, sq, sk, h, kh, d, causal, bf16,
                            dlse=False), causal, 1.0 / math.sqrt(d))
    rows.append(("flash_bwd", label,
                 lambda: ck.flash_attention_bwd(*ba),
                 lambda: ck.flash_bwd_op(*ba)))
    out = []
    for name, label, direct, op in rows:
        ms = {"straight": [], "op": []}
        dev = {"straight": [], "op": []}
        for _ in range(2):
            for key, fn in (("straight", direct), ("op", op)):
                ms[key].append(cuda_time_ms(fn, 50))
                dev[key].append(device_time_ms(fn))
        out.append({"kernel": name, "case": label,
                    **{f"{key}_ms": sum(v) / 2 for key, v in ms.items()},
                    **{f"{key}_device_ms": sum(v) / 2
                       for key, v in dev.items()}})
    return out


def phase_jit_inference(torch, ck, smi):
    """The graph and deployment path on GPT-124M (module doc): gates 1 to
    5, each raising on failure."""
    import gc
    import shutil
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    tmp = tempfile.mkdtemp()
    prev_place = paddle.get_device()
    try:
        seconds, t0 = [], time.perf_counter()

        def lap():
            nonlocal t0
            seconds.append(time.perf_counter() - t0)
            t0 = time.perf_counter()

        gpt = GPTForPretraining(cfg, device="cuda", seed=0)
        g1, logits_eager = _jit_gate_fp32(torch, ck, gpt, cfg)
        del gpt
        lap()
        gpt = GPTForPretraining(cfg, device="cuda", dtype=torch.bfloat16,
                                seed=0).eval()
        g2, reqs, outs = _jit_gate_predictor(torch, ck, gpt, cfg, tmp)
        lap()
        g3 = _jit_gate_cpu_saved(torch, ck, cfg, tmp, reqs, outs)
        lap()
        g4 = _jit_gate_model_save(torch, gpt, tmp, reqs, outs)
        del gpt, outs
        lap()
        g5 = _jit_gate_static(torch, ck, cfg, logits_eager)
        lap()
        for g, sec in zip((g1, g2, g3, g4, g5), seconds):
            g["seconds"] = sec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        paddle.set_device(prev_place)
        # a to_static layer and its program refer to each other: the
        # GPT-124M copies go with the cycle collector, and their cached
        # blocks with it, before the kernels are timed
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "jit_inference", "nvidia_smi": smi,
          "model": "GPT-124M (gpt_small, 12 layers)",
          "gates": [g1, g2, g3, g4, g5]})


def phase_timing(torch, ck, launches, path_launches, routes, smi):
    """The kernels line: each kernel at its main path's shape with its
    launches over every path, then K2 and K3 at the encoder paths'
    non-causal shapes with those paths' own launches, then each kernel's
    fp16 route (K2 and K3 at the fp16 AMP path's shape) with its fp16
    launches over every path (``routes``)."""
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    main = [time_paged(torch, ck, PAGED_CTXS[1], 1, bf16,
                       launches["paged_attention"], "serving"),
            time_flash(torch, ck, FLASH_CASES[0], bf16,
                       launches["flash_fwd"]),
            time_flash_bwd(torch, ck, TRAIN_ATTENTION, bf16,
                           launches["flash_bwd"]),
            *time_packed(torch, ck, launches)]
    for case, path in ((ERNIE_ATTENTION, "ernie_pretraining"),
                       (BERT_ATTENTION, "bert_finetune"),
                       (HP_ATTENTION[0], "hybrid_parallel"),
                       (HP_ATTENTION[1], "hybrid_parallel"),
                       *((case, "context_parallel")
                         for case in CP_ATTENTION),
                       *((case, "pipeline") for case in PP_ATTENTION),
                       *((case, "grad_comm") for case in GC_ATTENTION),
                       (P3_ATTENTION[0], "pipeline_3d"),
                       *((case, "context_hybrid")
                         for case in CH_ATTENTION)):
        counts = path_launches[path]
        for row in (time_flash(torch, ck, case, bf16, counts["flash_fwd"]),
                    time_flash_bwd(torch, ck, case, bf16,
                                   counts["flash_bwd"])):
            row.update(case=case[0], launches_path=path)
            main.append(row)
    # the auto_parallel path: the Engine ranks' fp32 K2/K3, the fleet
    # executor's bf16 K2, each with that route's launches on the path
    ap = routes["auto_parallel"]
    executor = ("ap_executor_microbatch",) + PP_ATTENTION[0][1:]
    for row in (time_flash(torch, ck, AP_ATTENTION, f32,
                           ap["flash_fwd"]["fp32"]),
                time_flash_bwd(torch, ck, AP_ATTENTION, f32,
                               ap["flash_bwd"]["fp32"])):
        row.update(case=AP_ATTENTION[0], launches_path="auto_parallel",
                   route_dtype="fp32", launches_route="fp32")
        main.append(row)
    row = time_flash(torch, ck, executor, bf16, ap["flash_fwd"]["bf16"])
    row.update(case=executor[0], launches_path="auto_parallel",
               launches_route="bf16")
    main.append(row)
    # the jit_inference path: K2 at a request's shape with the path's bf16
    # launches, K2 and K3 at the fp32 gates' shape with its fp32 ones
    jit = routes["jit_inference"]
    row = time_flash(torch, ck, JIT_ATTENTION[0], bf16,
                     jit["flash_fwd"]["bf16"])
    row.update(case=JIT_ATTENTION[0][0], launches_path="jit_inference",
               launches_route="bf16")
    main.append(row)
    for row in (time_flash(torch, ck, JIT_ATTENTION[1], f32,
                           jit["flash_fwd"]["fp32"]),
                time_flash_bwd(torch, ck, JIT_ATTENTION[1], f32,
                               jit["flash_bwd"]["fp32"])):
        row.update(case=JIT_ATTENTION[1][0], launches_path="jit_inference",
                   route_dtype="fp32", launches_route="fp32")
        main.append(row)
    fp16 = {name: sum(r[name]["fp16"] for r in routes.values())
            for name in launches}
    for row in (time_paged(torch, ck, PAGED_CTXS[1], 1, f16,
                           fp16["paged_attention"], "serving_fp16"),
                time_flash(torch, ck, TRAIN_ATTENTION, f16,
                           fp16["flash_fwd"]),
                time_flash_bwd(torch, ck, TRAIN_ATTENTION, f16,
                               fp16["flash_bwd"]),
                *time_packed(torch, ck, fp16, f16)):
        row.update(route_dtype="fp16", launches_route="fp16")
        row.setdefault("case", "gpt124m_fp16_amp"
                       if row["name"] in ("flash_fwd", "flash_bwd")
                       else "packed_fp16")
        main.append(row)
    variants = [time_paged(torch, ck, PAGED_CTXS[5], 5, bf16, None,
                           "serving_verify"),
                time_paged(torch, ck, PAGED_BYTES_CTXS, 1, bf16, None,
                           "bytes_heavy"),
                time_paged(torch, ck, PAGED_CTXS[1], 1, f32, None,
                           "serving_fp32"),
                time_flash(torch, ck, FLASH_CASES[0], f32, None),
                time_flash(torch, ck, TRAIN_ATTENTION, bf16, None)]
    emit({"phase": "kernel_variants", "nvidia_smi": smi,
          "kernels": variants})
    emit({"phase": "custom_op_cost", "nvidia_smi": smi,
          "cases": _custom_op_cost(torch, ck)})
    return main


def _share_bytecode():
    """This process and every process it starts (ranks, agents, trainers,
    loader workers) keep the bytecode of what they import in the
    checkout's ``build/pycache``: the environment may forbid writing it
    beside the sources, and then each process compiles torch and the port
    again."""
    prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script measures the port on "
              "one", file=sys.stderr)
        return 2
    _share_bytecode()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the data-parallel path's ranks: this script under the port's launcher
    if sys.argv[1:2] == ["--nccl-world-one"]:
        nccl_world_one_rank(torch)
        print(json.dumps({"rank_launches": {}}), flush=True)
        return 0
    if sys.argv[1:2] == ["--data-parallel-rank"]:
        return data_parallel_rank(torch, sys.argv[2])
    if sys.argv[1:2] == ["--hybrid-parallel-rank"]:
        return hybrid_parallel_rank(torch, sys.argv[2])
    if sys.argv[1:2] == ["--context-parallel-rank"]:
        return context_parallel_rank(torch, sys.argv[2])
    if sys.argv[1:2] == ["--pipeline-rank"]:
        return pipeline_rank(torch, sys.argv[2])
    if sys.argv[1:2] == ["--grad-comm-rank"]:
        return grad_comm_rank(torch, sys.argv[2])
    if sys.argv[1:2] == ["--auto-parallel-rank"]:
        return auto_parallel_rank(torch, sys.argv[2])
    if sys.argv[1:2] == ["--pipeline3d-rank"]:
        return pipeline3d_rank(torch, sys.argv[2])
    if sys.argv[1:2] == ["--context-hybrid-rank"]:
        return context_hybrid_rank(torch, sys.argv[2])
    # the elastic path's trainers: this script under an elastic agent
    if sys.argv[1:2] == ["--elastic-rank"]:
        return elastic_rank(torch, sys.argv[2])
    from paddle_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    smi = phase_environment(torch, ck)
    t_held = time.perf_counter()
    phase_kernels_vs_plain(torch, ck)
    held_s = time.perf_counter() - t_held
    # the main paths, each counted from zero: serving (K1) with the fp32
    # model phase (K2), training (K2, K3), eager fp16 AMP training (K2, K3
    # on their fp16 route), training with the schedule, nan check and
    # StepMeter (K2, K3), packed attention (K4, K5), ERNIE pretraining and
    # BERT finetuning (K2, K3, non-causal), then ResNet-50 and LeNet
    # training (none), then the paddle.* surface (K2, K3), then the
    # checkpoint path (K2, K3 on GPT-124M's resumes; none on ResNet-50's),
    # then the data-parallel path (K2, K3 in each GPT rank), then the
    # hybrid-parallel path (K2, K3 in each TP and ZeRO-3 rank), then the
    # context-parallel path (K2, K3 on every ring block and Ulysses call),
    # then the pipeline path (K2, K3 per block and microbatch per stage),
    # then the grad_comm path (K2, K3 per layer and microbatch or step),
    # then the auto_parallel path (K2, K3 fp32 per layer and step in each
    # Engine rank; K2 per block and microbatch through the fleet executor),
    # then the pipeline_3d path (K2, K3 per layer of a stage and microbatch
    # in each of its eight ranks, on an mp rank's heads), then the
    # jit_inference path (K2 per layer of every captured or served forward,
    # K3 per layer of the to_static step), then the context_hybrid path,
    # then the elastic path (K2, K3 per layer and step in every trainer of
    # every generation)
    paths = (("serving", ("paged_attention", "flash_fwd"),
              lambda: (phase_serving(torch, ck, smi),
                       phase_exactness_fp32(torch, ck))),
             # the engine's prefill is dense in both packages: K1 is the
             # one hand-written kernel on the fleet's path
             ("serving_fleet", ("paged_attention",),
              lambda: phase_serving_fleet(torch, ck, smi)),
             ("training", ("flash_fwd", "flash_bwd"),
              lambda: (phase_training_bf16(torch, ck, smi),
                       phase_training_exactness_fp32(torch, ck))),
             ("gpt124m_fp16_amp", ("flash_fwd", "flash_bwd"),
              lambda: (phase_gpt124m_fp16_amp(torch, ck, smi),
                       phase_fp16_against_fp32(torch, ck))),
             ("gpt124m_scheduled", ("flash_fwd", "flash_bwd"),
              lambda: (phase_gpt124m_scheduled(torch, ck, smi),
                       phase_eager_exactness_fp32(torch, ck))),
             ("packed_attention", ("flash_varlen_fwd", "flash_varlen_bwd"),
              lambda: (phase_packed_attention_bf16(torch, ck, smi),
                       phase_packed_attention_exactness_fp32(torch, ck))),
             ("ernie_pretraining", ("flash_fwd", "flash_bwd"),
              lambda: (phase_training_bf16(torch, ck, smi, "ernie"),
                       phase_ernie_exactness_fp32(torch, ck))),
             ("bert_finetune", ("flash_fwd", "flash_bwd"),
              lambda: (phase_training_bf16(torch, ck, smi, "bert"),
                       phase_bert_exactness_fp32(torch, ck))),
             # no hand-written kernel on this path, as in the reference
             ("resnet50_training", (), lambda: phase_vision(torch, ck, smi)),
             ("paddle_surface", ("flash_fwd", "flash_bwd"),
              lambda: phase_paddle_surface(torch, ck, smi)),
             ("checkpoint_resume", ("flash_fwd", "flash_bwd"),
              lambda: phase_checkpoint_resume(torch, ck, smi)),
             # the ranks are processes: each reports its launches, which
             # phase_data_parallel adds to this process's counts
             ("data_parallel", ("flash_fwd", "flash_bwd"),
              lambda: phase_data_parallel(torch, ck, smi)),
             # the same for the hybrid ranks (TP and ZeRO-3)
             ("hybrid_parallel", ("flash_fwd", "flash_bwd"),
              lambda: phase_hybrid_parallel(torch, ck, smi)),
             # and for the context-parallel ranks (ring and Ulysses)
             ("context_parallel", ("flash_fwd", "flash_bwd"),
              lambda: phase_context_parallel(torch, ck, smi)),
             # and for the pipeline's stages (eager schedules, SPMD)
             ("pipeline", ("flash_fwd", "flash_bwd"),
              lambda: phase_pipeline(torch, ck, smi)),
             # GradientMerge here, then the grad_comm ranks' meta-optimizers,
             # quantized syncs and gathers, DCN and TP with ClipGradByNorm
             ("grad_comm", ("flash_fwd", "flash_bwd"),
              lambda: phase_grad_comm(torch, ck, smi)),
             # the Engine's ranks (fp32) over placed parameters, then the
             # fleet executor's stages here (K2 only)
             ("auto_parallel", ("flash_fwd", "flash_bwd"),
              lambda: phase_auto_parallel(torch, ck, smi)),
             # the eight ranks of pp 2 x sharding 2 x mp 2
             # (GPTForPretrainingPipe with tensor_parallel under ZeRO)
             ("pipeline_3d", ("flash_fwd", "flash_bwd"),
              lambda: phase_pipeline_3d(torch, ck, smi)),
             # to_static (K2, and K3 in its step), jit.save, the predictor's
             # CUDA graphs, the CPU-saved program and the static Executor
             ("jit_inference", ("flash_fwd", "flash_bwd"),
              lambda: phase_jit_inference(torch, ck, smi)),
             # the eight ranks of sharding 2 x sep 2 x mp 2 (SP + CP under
             # ZeRO: K2/K3 on every ring block), then of pp 2 x sharding 2
             # x sep 2 (the pipe GPT's fp32 gate)
             ("context_hybrid", ("flash_fwd", "flash_bwd"),
              lambda: phase_context_hybrid(torch, ck, smi)),
             # two elastic agents and their trainers: a restart after a
             # local failure, then a scale-in to world 1 (K2/K3 12 a step
             # in every trainer)
             ("elastic", ("flash_fwd", "flash_bwd"),
              lambda: phase_elastic(torch, ck, smi)))
    launches = {k.name: 0 for k in ck.KERNELS}
    path_launches, path_routes, path_seconds = {}, {}, {}
    for path, kernels, drive in paths:
        ck.reset_launch_counts()
        t_path = time.perf_counter()
        drive()
        path_seconds[path] = time.perf_counter() - t_path
        counts = {k.name: k.launches for k in ck.KERNELS}
        missing = [n for n in kernels if counts[n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {missing}")
        if not kernels and any(counts.values()):
            raise AssertionError(f"the {path} path launched {counts}")
        path_launches[path] = counts
        path_routes[path] = {k.name: dict(k.route_launches)
                             for k in ck.KERNELS}
        for name, c in counts.items():
            launches[name] += c
    emit({"phase": "path_launches", "launches": path_launches,
          "by_route": path_routes, "seconds": path_seconds})
    t_timing = time.perf_counter()
    kernels = phase_timing(torch, ck, launches, path_launches, path_routes,
                           smi)
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "kernels_vs_plain_s": held_s,
          "timing_s": time.perf_counter() - t_timing})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
