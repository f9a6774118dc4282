#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases, each printing one JSON line; any failure exits nonzero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of ``src/repro_torch/csrc`` compiled with ``nvcc``
   for ``sm_90a`` (one process per source, all started together);
3. capture: one prefill of each full-width model (qwen2.5-3b on the paged
   arena, recurrentgemma-2b and xlstm-125m on the dense state; random
   weights from ``--seed``), keeping what the kernel phases feed their
   kernels;
4. one phase per kernel, holding it against its plain PyTorch version on
   the card at the full-width shapes, with inputs taken from those
   prefills: the encoder output at the split for the boundary (both
   models' banks), the decoder output for the decode tail (qwen's LM head
   and recurrentgemma's tied embedding table; xlstm-125m's at d 768, W 192
   and its [768, 50304] head after a layernorm with a bias), the page
   arena for paged attention, the first RG-LRU layer's gates and the first
   mLSTM layer's normalizer inputs for the scan, the rmsnormed
   encoder output and each bank's own projections for the wire pair
   (``bottleneck_quant``, ``dequant_matmul``; also at the kernel bench's
   f32 shape; bits 8, 4 and 1, with a row of zeros; an f32 output, a
   depth and a width off 16-byte rows, operands off 16-byte alignment and
   N 4096; one device kernel a call, each launch's plan printed); paged
   attention in its one-range and its split form at the main path's
   decode shape and at the capture's long shape (positions up to 999),
   bf16 bit for bit against the plain version and the split-order
   mirror; the boundary on
   the rows in place, every row bit-identical alone and in its pool, and
   at most two device kernels a dispatcher call; the tail with 4 real rows
   of a 16-row block, with three heads, and with one head on the rows in
   place, at most three device kernels a call; each phase times the
   kernel, its plain version and, where one exists, the one PyTorch call
   that computes the same function (a yardstick the port never calls; for
   the wire pair, which no one call computes, ``torch.matmul`` of the GEMM
   part, labelled as such); then one RG-LRU layer prepared and not, and
   xlstm-125m's device kernels and ms of one decode tick and of one
   prefill dispatch at the main path's shapes;
5. the dense archs stablelm-3b, granite-8b and internlm2-20b, one at a
   time (captured at full width, freed after): the boundary at their (d,
   W) at 4 rows, the 64-row prefill dispatch and 512 rows, with the tile
   width the plan picked (f32 rows where no tile fits must raise); paged
   attention at their head_dim and GQA group (80 / 1, 128 / 4, 128 / 6) in
   both forms; the tail at their heads (layernorm with a bias, tied,
   d 6144) with the plan of each call;
6. reference: the continuous engine at reduced shapes in float32 on the
   card (kernels) and on the CPU (plain versions), for each arch (and
   stablelm-3b at d_model 160, head_dim 80), must decode the same tokens,
   modes and wire bytes;
7. main path, for each arch: ``repro_torch.launch.serve.main --engine
   continuous`` at full width in bf16 with the launch counters set to 0
   just before and read just after; every request must finish, every
   kernel of the path must have launched, and the launches must match the
   path's prefill dispatches and decode ticks. Each window is one replay
   of a CUDA graph (``serving/graphs.py``): the path must replay graphs
   and call the decode step only at each graph's first use and capture;
   the ticks are the step's calls less the captured ones plus the
   replayed ones (the graph tallies), equal to the engine's own decode
   ticks. On ``HOST_LOOP_ORACLE`` the tokens equal a ``host_loop=True``
   run's (no graph, logits read every tick) bit for bit;
8. profile: each main path once more under ``torch.profiler``, on the
   engine the main path built (its graphs captured), for the device busy
   time, the device kernels and host launch calls a tick, the graph
   replays' kernels, busy time and span a replayed tick (the trace must
   hold each replay's kernels) and the kernels that take the time (the
   dense archs' runs cut in depth: ``PROFILE_CUT``);
9. the same three for the synchronous engine (``--engine sync``, the
   orchestrator's policy): a reduced f32 reference under the orchestrator
   and on mode 1, the full-width path with its launches asserted (one
   decode tail a step, one scan per RG-LRU or mLSTM layer a prefill; each
   token step a graph replay, one graph a mode), a profile;
10. bench: ``repro_torch.benchmarks.bench_kernels.main --device cuda``,
    whose parity checks must hold, which must launch the wire pair, and
    whose fused boundary + tail tick must beat the unfused chain (the
    reference bench gate's ``MEGA_FLOOR``, 1.0); then the serving bench's
    loop comparison (``bench_serving.compare_engine_loops``) at the
    bench's own arguments (``LOOP_BENCH``: qwen2.5-3b, 8 slots, 24
    tokens), whose device loop must decode at least ``MIN_LOOP_SPEEDUP``
    (1.15) times the host loop's rate, the reference bench gate;
11. cascade: the paper's proof of concept at full size (the lumos5g-lstm
    config on the 70,000-sample Lumos5G twin): the first train step of
    each phase of Algorithm 1 on the card against the CPU from the same
    weights and batch (loss, every leaf's gradient, every updated leaf;
    phase 2's frozen leaves and their moments bit for bit), then
    ``repro_torch.examples.throughput_prediction.main`` at 100 steps a
    phase with the launch counters at 0 just before and read just after
    (mode 0 must learn below chance; every logged loss, information-plane
    point and ladder value finite; ms a step printed), then a profile of
    10 steps of each phase (device kernels, busy ms, idle share);
12. train: the transformer's training path and full-sequence forward. The
    first step of ``training.loop.make_train_step`` on the card against
    the CPU (reduced f32: qwen2.5-3b in modes None, 0 and 1,
    recurrentgemma-2b and xlstm-125m in mode None; loss, every gradient,
    every updated leaf); ``repro_torch.launch.train.main`` with
    ``--cascade`` at full width on qwen2.5-3b (36 layers, nothing cut),
    counters at 0 (no kernel of the six on the path), finite losses, phase
    1 learning, its checkpoint restored bit for bit and served through
    ``launch.serve --ckpt`` (the tokens of the weights in memory), ms a
    step, peak memory, a profile of each phase; the full-width eval
    forwards of recurrentgemma-2b ([1, 2048]: 18 scan launches, the train
    forward's logits bit for bit) and xlstm-125m ([4, 256]: 6 launches,
    within ``TOL["xlstm_forward"]``); ``repro_torch.examples.train_100m``
    at 3 steps of [2, 128];
13. scale-out serving at full width (qwen2.5-3b): the edge cluster (2
    replicas of 4 slots; 8 requests of 16 + 16 on mobility channels that
    cross cells mid-generation) under live migration with raw and 8-bit
    snapshots, stay and drop, telemetry on: every request finishes, the
    raw-migrated tokens equal one 4-slot engine's request by request,
    migrations equal the handovers acted on and their bytes the
    snapshots', 8-bit snapshots at most ``QUANT_SNAPSHOT_RATIO`` of the
    raw bytes, the folded telemetry blocks equal host wire accounting, the
    trace has the cluster and replica lanes with the migration events, and
    each tick launches what the continuous path does; ``launch.serve
    --engine fleet`` (64 UEs on Lumos5G trace lanes, SLO admission, the
    autoscaler) conserves requests; the three serving benches
    (``bench_serving``, ``bench_cluster``, ``bench_fleet``) run with their
    launches counted;
14. frontends: musicgen-large (4 codebooks summed at the input, one LM
    head a codebook) and llava-next-34b (a 576-token vision prefix; 69 GB
    of weights), one model on the card at a time. The kernels at their
    shapes against the plain versions: the boundary at llava's d 7168 / W
    1792 (the plan's ``mt`` 1 at 4, 64 and 512 rows) and on musicgen's
    two-head bank (W 512 and 128), every row bit-identical alone and in
    its pool; the tail at llava's [7168, 64000] head; paged attention at
    head_dim 128 / group 7 and 64 / 1 in both forms, bf16 bit for bit.
    musicgen-large's int8 rolling cache at batch 8, ``cache_len`` 1024,
    10 decode steps against bf16 (bytes under ``KV8_BYTES``, relative
    logit error under ``KV8_LOGIT_REL``, greedy agreement at least
    ``KV8_AGREE``). llava-next-34b's vision prefill on the paged arena
    (592 positions) against ``T.forward(embeddings=)`` within
    ``TOL["vision_prefill"]``, then 8 fused-tail decode steps through
    paged attention's split form; its continuous engine bank-free (a tick
    launches no boundary, one tail, one paged call a layer) and with
    ``fused_tail=False`` (no tail), whose tokens must equal the fused
    run's or part first at a near tie. The reduced f32 references (both
    engines; bank-free and unfused too), the main paths on both engines
    with their launches (musicgen-large launches no tail) and profiles.
15. mixture of experts: phi3.5-moe-42b-a6.6b (16 experts, top 2, the
    paged pool) and mixtral-8x7b (8 experts, top 2, a 4096-token window:
    the dense rolling pool) at full width, cut to 26 and 24 of their 32
    layers (``MOE_LAYERS``: 68 and 70 GB of bf16 weights), one model on
    the card at a time. The reduced f32 references of both engines, card
    against CPU, under the near-tie rule (``TOL["moe_near_tie"]``); the
    tail at [4096, 32064] (a last slab of 64 columns) and [4096, 32000]
    against its plain version (pools in place, 4 real rows of a 16-row
    block, an exact tie, the last column made the argmax), timed with its
    bound; mixtral's int8 rolling cache (batch 8, ``cache_len`` 1024, 10
    steps; relative logit error under ``KV8_LOGIT_REL_MOE``); the main
    paths on both engines through the launcher's runners on the cut
    configs, with their launches, and profiles; the memory at each
    model's peak. Then Algorithm 1's steps on phi3.5-moe at full width
    and 2 layers (``MOE_TRAIN``): finite losses, the aux within (0,
    layers * E], no kernel launched, ms a step, peak memory, a profiled
    step.
16. the serving mesh (``models/sharding.py``) on the one card: the
    kernels at the per-rank shapes (paged attention at mp 2's one KV head,
    group 8, in both forms bf16 bit for bit, timed beside its plain
    version, SDPA and the bound; the boundary on a dp rank's 2 rows of 4
    bit for bit the whole batch's rows; the tail at 2 rows), the
    continuous engine on one NCCL rank (``launch.serve --dp 1 --mp 1``),
    then two gloo ranks on cuda:0 (NCCL refuses two ranks on one device)
    through the launchers with the main path's arguments: qwen2.5-3b
    continuous at (dp, mp) = (2, 1), its unfused engine at (1, 2) against
    one device's (the same schedule, logits within
    ``TOL["mp_logit_rel"]``, a stream parting only at a near tie), the
    sync engine at (2, 1), recurrentgemma-2b at dp 2, a 2-replica cluster
    at (1, 1) each under migrate raw, and ``bench_serving --slot-scaling
    1,2`` at cut arguments under the reference gate's rules (every row
    finishes, dp 2 at least ``SHARD_FLOOR`` of dp 1's tok/s). dp runs
    decode the one-device runs' tokens (phases 7, 9 and a one-device
    cluster); each rank's launches are summed by layout.
17. training and MoE across ranks: the kernels at phi3.5-moe's (1, 2) rank
    shapes (paged attention at 4 KV heads, group 4, hd 128; the boundary and
    the tail at 4 rows), then two gloo ranks on cuda:0 (``p17_rank``): (a)
    ``launch.train --cascade --mp 2`` and (b) ``--dp 2`` on qwen2.5-3b at full
    width cut to ``P17_TRAIN_LAYERS``, each logged loss within
    ``TOL["train_mp_loss_rel"]`` of the one-device run's (a run with the update
    off must part by more), the replicated leaves bit-identical across the
    ranks, the checkpoint (gathered, written by rank 0) restored and evaluated
    on one device; (c) ``moe_apply_ep`` at ep 2 on phi3.5-moe's layer at full
    width against ``moe_apply`` (capacity 8: rows and the token path's gradient
    within ``TOL["moe_ep_row_rel"]`` / ``["moe_ep_grad_rel"]``; the default
    capacity: the drops of each rank's block as its plain routing's) and a
    train step with ``moe_ep=True``; (d) ``qtp_forward`` on granite-8b (cut to
    ``P17_QTP["layers"]``) against ``T.forward`` (``TOL["qtp"]``); (e) the pod pipeline on stablelm-3b against
    ``T.forward`` and ``split_forward`` (``TOL["pipe"]``), its gradients on
    both stages and heads, the int8 backward, the wire counter; (f) phi3.5-moe
    continuous at (1, 2), cut to ``P17_SERVE_LAYERS``, against one device (the
    mp rule, the routes pinned to one device's; a free run's routing
    differences reported) and fused, launching the boundary, the tail and paged
    attention. The training paths launch none of the six kernels. (b) runs
    FSDP (phase 18 (d)): each rank's leaves and AdamW moments have the local
    shapes of the reference's specs (``sharding.param_pspecs``) on (data 2,
    model 1), and its bytes are printed beside the layout without FSDP.
18. the recurrent mixers over mp: (k) ``rglru_scan`` at the rank shapes
    (recurrentgemma-2b's prefill at [4, 16, 1280], xlstm-125m's normalizer
    at [4, 16, 768] with h0) bit for bit, timed beside its plain version and
    its bound; then, on the card, two worlds of two gloo ranks
    (``P18_WORLDS``) and three one-device helpers, xlstm-125m's started at
    phase 16 to share its time (``P18_EARLY``): (a) recurrentgemma-2b
    (26 layers) and (b) xlstm-125m served at full width at (1, 2) on both
    engines in bf16: fused (its tokens against the main path's reported,
    launching the scan, the boundary and the tail), then taped and held to
    the helpers' one-device tapes under phase 16's mp rule (the continuous
    engine unfused, its boundary in its plain version; the sync engine
    through the logits chain), the wire's int8 codes pinned to one
    device's (``codes``, as (f) pins MoE routes); (c) ``launch.train
    --cascade --mp 2`` in bf16 on xlstm-125m at full depth and
    recurrentgemma-2b cut to ``P18_TRAIN_LAYERS``, [4, 128], two steps a
    phase, the straight-through boundary's codes pinned to one device's,
    each logged loss within
    ``TOL["train_mp_loss_rel"]`` of the helper's one-device run (which its
    ``--lr 0`` control must exceed), the whole leaves bit-identical across
    the ranks, no kernel launched.
19. the remaining entry points: (a) the dry run
    (``repro_torch.launch.dryrun``) at full width on fake ranks of the
    production meshes, CPU-only subprocesses started together right after
    the build so that they run beside the card's phases (``P19_DRYRUNS``:
    qwen2.5-3b x train_4k x 16x16, mixtral-8x7b x decode_32k x 2x16x16,
    recurrentgemma-2b x long_500k x 16x16), each passing its
    rank-coherence check, then ``bench_roofline`` and
    ``gen_experiments`` over its records (a line and a row each); (b)
    ``bench_modes.run()`` equal to the CPU's (``P19_MODES``); (c)
    ``examples/split_serving.py --device cuda`` at the reference's defaults
    with the launch counters at 0 just before and read just after (the
    boundary, the tail and paged attention by phase 7's rule), each
    request's modes and wire bytes those of the same example on the CPU;
    (d) ``examples/quickstart.py --device cuda`` (finite losses, the
    Ensure line, no kernel launched); (e) ``examples/expert_parallel_moe.py
    --device cuda``: 8 gloo ranks on the card, the example's assertions;
    (f) ``benchmarks/run.py --device cuda`` over its suite table, less
    ``kernels`` (phase 10).

The order of the run: phases 1 to 6, the check of the profile summary
(``phase_profile_summary``) and phase 10 (its fused-tick gate and the loop
comparison are timed on the host clock), alone on the card; then two
background lanes (``LANES``, ``lane``), each a process of its own on the
card, with its paths' launch counters at 0 just before and read just
after in that process: one runs phase 13, the other phase 11, phase 12's
eval forwards and ``train_100m``, phase 19's card parts (b) to (f), and
phases 6 to 9 of ``LANE_ARCHS`` (recurrentgemma-2b, xlstm-125m: a few
GB each), while this process runs phases 6 to 9 of qwen2.5-3b and the
dense archs and phase 12's first steps and launcher (their rates and
profiles then share the host and the card); this process waits for the
lanes and prints their output, then runs phases 14 to 18 (14 and 15 need
the whole card) and collects phase 19's dry runs.

Kernel times come from ``torch.profiler`` traces. A trace can lose
events: a lost one counts as its kernel's mean traced event (a call
launches the same kernels every time, so a whole trace holds a whole
number of each a call), and a trace with no device work in it, or one
that lost more than ``LOST_MAX`` of its events, is taken again; if CUPTI
still delivers no usable trace the time comes from CUDA events (the
``untraced`` line counts such measurements, the traces taken again and
the events made up).
The dispatchers' device kernels a call (boundary, tail, wire pair, the
RG-LRU step) are counted exactly, as the nodes of a captured CUDA graph.

Then the card's name and power limit, the ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Tolerances against the plain versions, and why.
TOL = {
    # mode-0 rows are copied, so they must be bit-for-bit. Quantized rows
    # may differ by the GEMM rounding of two summation orders (each output
    # within 2u * sum_j |wired_j| |up_ji| + u |y_i|, u = 2^-8 in bf16 and
    # 2^-16 in f32) plus one code step at every lane whose code sits within
    # a one-ulp change of z or of the scale of a rounding edge: there the
    # two sides' sums may land on either side.
    # Each row is computed from its own row and mode only (its sums' order
    # is fixed by d and the mode's width), so a sequence called alone must
    # give the bits it gets inside its pool.
    "boundary": "mode-0 rows bit-for-bit; other rows within the GEMM "
                "rounding envelope plus one code step at rounding-edge lanes; "
                "every sequence bit-identical alone and in its pool",
    # the logits are f32 sums in two orders: tokens must be equal except
    # where the plain top-two gap is below 1e-3 of the max logit, and there
    # the kernel's token must be one of the near-tied ones. An exact tie
    # must resolve to the lowest index.
    "tail_rel_gap": 1e-3,
    # the online softmax keeps the reference's rounding barriers, so bf16
    # outputs track it to an ulp or two of values of size ~1; f32 to 1e-5.
    # Both forms of the kernel must also be bf16 bit for bit with the plain
    # version: both sum in index order, and products of bf16 values are
    # exact in f32
    "paged_bf16_abs": 1e-2,
    "paged_f32_abs": 1e-5,
    # the scan rounds a*h and the sum separately on both sides, in the
    # same order: bit for bit
    "rglru": "bit for bit",
    # the wire GEMMs sum K in other orders than the plain version (f32 FMAs
    # in split-K slices against cuBLAS in f32, TF32 off): a code may move
    # one step where z / scale sits on a rounding edge, on under 1% of
    # lanes, and a scale (one row absmax over qmax) only by the absmax's
    # rounding; a row of exact zeros must give zero codes and the scale
    # 1e-8 / qmax exactly
    "codes_frac": 0.01,
    "scale_rtol": 1e-5,
    # dequant_matmul: each bf16 output within one bf16 ulp of the plain one
    # (its f32 sum may straddle one rounding edge), plus, for outputs so
    # small that the two f32 sums' own rounding exceeds an ulp, that
    # rounding: 2 N 2^-24 sum_k |z_k| |w_k|
    "dequant": "one bf16 ulp + 2 N 2^-24 sum_k |z_k w_k|",
    # the paper LSTM's first train step of each phase, card against CPU,
    # in f32 (TF32 off): the loss to 1e-5 (values O(1)); each leaf's
    # gradient to 1e-4 of its largest |g| (the batch and time sums run in
    # other orders); each updated element to 1e-5 of |p| + |delta| (the
    # operands of p - delta, so an element that nearly cancels is held to
    # the error of delta, not of its tiny value), except where |g| < 1e-3
    # of the leaf's largest: Adam's first update is about
    # lr * sign(g), and a rounding-level difference in g may flip that
    # sign there, moving the element by up to 2 lr. Frozen leaves, their m
    # and v: bit for bit
    # The transformer's first train step (phase 12) adds three rules: the
    # loss also within 1e-6 of its value (recurrentgemma-2b's random tied
    # head gives losses near 127, where 1e-5 is two f32 ulp), and each
    # leaf's gradient scale at least 1e-3 of the largest |g| of any leaf
    # (a leaf whose gradient cancels to rounding level, as the mLSTM's
    # input gate at the first step, where the stabiliser makes i_g = 1
    # whatever i_pre, is held to the rounding of the terms that cancel);
    # and each updated element's limit also takes the gradient's own
    # tolerance carried through Adam's first update lr g / (|g| + eps):
    # lr eps grad_limit / (|g| + eps)^2, which matters where |g| is a few
    # tens of eps (a zero-initialised bias's gradient at 5e-7 moves its
    # update by 2% of the gradient's relative error)
    "cascade": {"loss_abs": 1e-5, "grad_rel": 1e-4, "step_rel": 1e-5,
                "small_g": 1e-3, "loss_rel": 1e-6, "grad_floor": 1e-3},
    # xlstm-125m's eval forward (the decomposed mLSTM: normalizer on the
    # scan, C in the time loop) against its train forward (the fused
    # cell), bf16 at full width: the logits within 2^-7 of the largest
    # |logit|, a bf16 rounding of a block output that lands on the other
    # side of an edge carried through the later blocks (the two are bit
    # for bit on the CPU)
    "xlstm_forward": 2.0 ** -7,
    # llava-next-34b's vision prefill (T.prefill on the paged arena) against
    # T.forward(embeddings=) at the last position, bf16 at full width: the
    # layers run the same ops on the same [2, 592] shapes, but the final
    # norm reduces a [2, 1, d] and a [2, 592, d] tensor (reduction kernels
    # may sum in other orders, so a normed element may round to the next
    # bf16 value, at most 2^-7 of it) and the f32 head product has M 2
    # against 1184 (another summation order over d). Each logit j is held
    # to (2^-7 + 2 d 2^-24) sum_k |xn_k| |w_kj|, xn the forward's normed
    # row; an argmax that differs must sit at a top-two gap under
    # tail_rel_gap
    "vision_prefill": "(2^-7 + 2 d 2^-24) sum_k |xn_k w_kj| a logit",
    # MoE routing is discontinuous: a token whose k-th and (k+1)-th router
    # probabilities differ by less than this may route otherwise on f32
    # sums in another order (the card's against the CPU's). The tokens of
    # an MoE run may part from its reference only if the reference made
    # such a near-tied decision, and at most this share of its decisions
    # may be near ties; exact ties go to the lowest expert on both sides
    "moe_near_tie": 1e-6,
    "moe_near_tie_share": 0.01,
}
# the int8 KV cache against bf16 (tests/test_kv_quant.py's bounds, dense
# archs): state bytes, greatest relative logit error, greedy agreement; MoE
# routing is discontinuous (int8 noise can flip an expert choice), so the
# reference holds MoE archs to a relative logit error under 0.25
KV8_BYTES, KV8_LOGIT_REL, KV8_AGREE = 0.75, 0.05, 0.9
KV8_LOGIT_REL_MOE = 0.25
# device kernels a decode step of one RG-LRU layer issues fewer with its
# float32 forms made once: the casts of w_a's and w_x's weights and biases
# and of the conv taps (5), and -softplus(-lam) (neg, softplus, neg)
CACHED_A_LAYER = 8
# device launches a decode tick (continuous) or step (sync) of
# recurrentgemma-2b measured on the H100 while those forms were made on
# every call; the profile phase requires at least the cached forms' saving
# (CACHED_A_LAYER a layer) below them
UNCACHED_LAUNCHES = {"continuous": 2472, "sync": 2046}
# device kernels one dispatcher call may issue: the boundary's two launches;
# the one-head decode tail's three (norm, logits, reduce), no layout ops
MAX_KERNELS = {"boundary": 2, "tail": 3}
# the reference bench gate's floor on the fused tick's speedup
# (tools/check_bench.py, MEGA_FLOOR)
MEGA_FLOOR = 1.0
# the reference bench gate's floor on the device loop's decode rate over
# the host loop's, engine_comparison.decode_speedup (tools/check_bench.py:334,
# MIN_LOOP_SPEEDUP), and the serving bench's own arguments of that
# comparison (benchmarks/bench_serving.py's defaults: --compare-slots 8,
# --compare-gen 24, --prompt-len 4, max(--requests 12, 2 * 8) requests)
MIN_LOOP_SPEEDUP = 1.15
LOOP_BENCH = {"n_slots": 8, "gen": 24, "prompt_len": 4, "n_requests": 16}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the script's elapsed
    seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj, default=str), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

# measurements the profiler gave no usable trace for, by helper: those
# were taken without CUPTI (CUDA events, a captured graph's nodes); the
# traces taken again because they had lost too many events; and the lost
# events of the traces kept, each made up from its kernel's traced ones
UNTRACED = {"time_ms": 0, "device_kernels": 0, "retaken": 0,
            "events_made_up": 0}
# a trace may lose events (CUPTI drops some at random: an event or two of
# a plain version's thousands, or a share of a short kernel trace late in
# a run); a trace that lost more than this share is taken again
LOST_MAX = 0.25


def trace_counts(events, calls: int) -> dict:
    """{kernel name: (events traced, events a whole trace holds)} of a
    trace of ``calls`` identical calls: a call launches the same kernels
    every time, so a whole trace holds a multiple of ``calls`` of each;
    the traced count rounded up to one."""
    traced: dict = {}
    for name, _ in events:
        traced[name] = traced.get(name, 0) + 1
    return {k: (n, -(-n // calls) * calls) for k, n in traced.items()}


def device_events(run, calls: int, tries: int = 3) -> list:
    """The device events (kernels, copies, memsets) of ``run()`` in a
    ``torch.profiler`` trace, as (name, microseconds) pairs read from the
    profiler's raw events, as ``serve.profile_summary`` reads them (the
    ``FunctionEvent`` tree of ``prof.events()`` holds the same events and
    costs seconds of host time a trace to build; the ``profile_summary``
    phase holds the two equal). ``run()`` makes ``calls`` identical calls;
    a trace that holds none, or that lost more than ``LOST_MAX`` of its
    events (``trace_counts``), is taken again, up to ``tries`` times;
    after that [] (CUPTI delivered no usable trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [(e.name(), e.duration_ns() / 1e3)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        lost = sum(w - n for n, w in trace_counts(events, calls).values())
        if events and lost <= LOST_MAX * (len(events) + lost):
            UNTRACED["events_made_up"] += lost
            return events
        if events:
            UNTRACED["retaken"] += 1
    return []


def event_ms(fn, iters: int, flush=None) -> float:
    """Mean time of one call of ``fn`` between two CUDA events around it
    (host gaps between its launches included), ``flush`` outside."""
    import torch
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def time_ms(fn, iters: int, flush=None, by_kernel=None) -> float:
    """Mean device time of one call of ``fn``: the durations of the device
    work it launches, summed over ``iters`` calls from a ``torch.profiler``
    trace, over ``iters``. Host time between launches is not counted (a
    CUDA-event bracket would count it: at these sizes the card waits on
    the Python wrapper). ``flush`` (traced but not counted) evicts the L2
    cache before each call where the caller would find the operands cold.
    ``by_kernel``: a dict that receives ms per call of each kernel name.
    A lost kernel event must not count as a call of no time: each kernel's
    traced time is scaled to the events a whole trace holds (its mean
    traced event stands in for a lost one), and a trace that lost too
    many is taken again (``device_events``). Where the profiler gives no
    usable trace the time is ``event_ms``'s, with no split by kernel, and
    ``UNTRACED`` counts it."""
    for _ in range(2):
        fn()

    def run():
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()

    events = device_events(run, iters)
    if not events:
        UNTRACED["time_ms"] += 1
        return event_ms(fn, iters, flush)
    per, counts = {}, trace_counts(events, iters)
    for name, us in events:
        if FLUSH_OP not in name:
            per[name] = per.get(name, 0.0) + us
    per = {k: v * counts[k][1] / counts[k][0] for k, v in per.items()}
    us = sum(per.values())
    check(us > 0, "the profiler traced no device work of the timed call")
    if by_kernel is not None:
        by_kernel.update({k[:60]: v / iters / 1e3 for k, v in per.items()})
    return us / iters / 1e3


def peaks():
    """The H100 SXM's published peaks (dense), from
    ``repro_torch.launch.mesh``: HBM bytes/s, and FLOP/s by input type."""
    from repro_torch.launch import mesh
    return mesh.HBM_BW, {"bfloat16": mesh.PEAK_FLOPS_BF16,
                         "float32": mesh.PEAK_FLOPS_F32}


def bound(nbytes: float, flops: float, dt: str):
    """(least time in ms, "bytes" or "operations") on the published peaks."""
    hbm, flops_per_s = peaks()
    t_mem = nbytes / hbm * 1e3
    t_ops = flops / flops_per_s[dt] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def graph_nodes(fn) -> int:
    """Device operations of one call of ``fn``, counted as the nodes of
    the CUDA graph that captures it (read with the driver's
    ``cuGraphGetNodes``)."""
    import ctypes

    import torch
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=torch.cuda.Stream(),
                          capture_error_mode="relaxed"):
        fn()
    n = ctypes.c_size_t(0)
    get = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_size_t)]
    code = get(g.raw_cuda_graph(), None, ctypes.byref(n))
    check(code == 0, f"cuGraphGetNodes returned {code}")
    return n.value


def dispatcher_kernels(fn) -> int:
    """Device operations one call of a dispatcher issues, exactly: the
    nodes of a captured call (``graph_nodes``), after one call outside the
    capture so that plans and libraries are built (a profiler trace may
    drop device events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    return graph_nodes(fn)


def device_kernels(fn, calls: int = 3) -> float:
    """Device operations (kernels, copies, memsets) that one call of ``fn``
    issues: counted in a ``torch.profiler`` trace of ``calls`` calls after
    a warm-up call, over ``calls``. Where the profiler traces no device
    work, the nodes of a captured call (``graph_nodes``), and ``UNTRACED``
    counts it."""
    fn()

    def run():
        for _ in range(calls):
            fn()

    events = device_events(run, calls)
    if not events:
        UNTRACED["device_kernels"] += 1
        n = graph_nodes(fn)
        check(n > 0, "a captured call issued no device work")
        return float(n)
    return sum(w for _, w in trace_counts(events, calls).values()) / calls


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


FLUSH_OP = "bitwise_not"       # the flush's kernel, which nothing timed uses


def l2_flusher(dev):
    import torch
    buf = torch.zeros(128 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    return lambda: buf.bitwise_not_()


# ---------------------------------------------------------------------------
# full-width activations: one prefill through the port's model
# ---------------------------------------------------------------------------

LENS = (1000, 1, 8, 9, 100, 513, 777, 37)   # ragged, across page edges


def capture(cfg, dev, seed: int, page_len: int = 8):
    """Run one ragged prefill of the full-width model and keep what the
    kernel phases feed their kernels: the encoder output at the split, the
    decoder output before the tail, the filled page arena and the block
    table (unallocated entries point at scratch page 0)."""
    import numpy as np
    import torch

    from repro_torch.core import bottleneck
    from repro_torch.core import split as SP
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = SP.init_split_params(gen, cfg)
    stacked = bottleneck.bank_stack(params["bneck_modes"], cfg.split)
    lens = np.asarray(LENS, np.int64)
    B = len(lens)
    S = 1 << int(math.ceil(math.log2(int(lens.max()))))
    toks = torch.from_numpy(
        MarkovTokenSource(cfg, seed=7).batch(B, S)["tokens"]).to(dev)
    pages = [-(-int(n) // page_len) for n in lens]
    nb = max(pages)
    n_pages = sum(pages)
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages + 1))
    bt = np.zeros((B, nb), np.int32)
    k = 0
    for b, n in enumerate(pages):
        bt[b, :n] = perm[k:k + n]
        k += n
    arena = T.init_decode_state(cfg, n_pages + 1, page_len, device=dev)
    bt_t = torch.from_numpy(bt).to(dev)
    lens_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
    modes = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1][:B], dtype=torch.int32,
                         device=dev)
    s = cfg.split.split_at
    x = T.embed_tokens(params, toks, cfg)
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    enc_l, dec_l = SP.slice_layers(params["layers"], cfg, s)
    enc_st, dec_st = SP._split_states(arena, cfg, s)
    x_enc = T.run_layers_prefill(enc_l, x, positions, enc_st, cfg,
                                 lengths=lens_t, block_table=bt_t)
    y = bottleneck.boundary_mixed(stacked, x_enc, modes,
                                  dtype=T.model_dtype(cfg))
    x_dec = T.run_layers_prefill(dec_l, y, positions, dec_st, cfg,
                                 lengths=lens_t, block_table=bt_t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    valid = torch.arange(S, device=dev)[None, :] < lens_t[:, None]
    return {"params": params, "stacked": stacked, "x_enc": x_enc,
            "x_dec": x_dec, "arena": arena, "bt": bt_t, "lens": lens,
            "valid": valid, "page_len": page_len}


@contextlib.contextmanager
def recording(module, name: str, sink: list, limit: int = 1):
    """Record (clones of) the positional arguments of the first ``limit``
    calls of ``module.name`` while the block runs."""
    import torch
    orig = getattr(module, name)

    def rec(*args):
        if len(sink) < limit:
            sink.append(tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args))
        return orig(*args)

    setattr(module, name, rec)
    try:
        yield sink
    finally:
        setattr(module, name, orig)


RLENS = (2048, 16, 700, 1333)   # a prompt as long as the window, ragged
BENCH_SCAN = "[4, 1024, 512] kernel bench"


def capture_recurrent(cfg, dev, seed: int):
    """One ragged prefill of full-width recurrentgemma-2b on the dense
    state (rolling caches of the window's length, RG-LRU carries): the
    encoder output at the split and the decoder output before the tail,
    and the first RG-LRU layer's scan inputs at the shapes the scan phase
    checks — [4, 2048, D] (this prefill), [1, 16, D] and [4, 16, D] (the
    main path's prompts), [3, 37, D] continuing from a carried state, one
    step [3, 1, D] from it, and a width that is not a multiple of 128 —
    plus the kernel bench's [4, 1024, 512] scan (its inputs' law: a =
    sigmoid(normal), b normal, no carry; numpy-seeded)."""
    import numpy as np
    import torch

    from repro_torch.core import bottleneck
    from repro_torch.core import split as SP
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    params = SP.init_split_params(gen, cfg)
    stacked = bottleneck.bank_stack(params["bneck_modes"], cfg.split)
    lens = np.asarray(RLENS, np.int64)
    B, S = len(lens), max(RLENS)
    toks = torch.from_numpy(
        MarkovTokenSource(cfg, seed=7).batch(B, S)["tokens"]).to(dev)
    lens_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
    modes = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=dev)
    s = cfg.split.split_at
    kinds = SP._kinds(cfg)
    x = T.embed_tokens(params, toks, cfg)
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    states = T.init_decode_state(cfg, B, S, device=dev)
    enc_l, dec_l = SP.slice_layers(params["layers"], cfg, s)
    enc_st, dec_st = SP._split_states(states, cfg, s)
    with recording(ops, "rglru_scan_op", []) as long_scan:
        x_enc = T.run_layers_prefill(enc_l, x, positions, enc_st, cfg,
                                     kinds=kinds[:s], lengths=lens_t)
    y = bottleneck.boundary_mixed(stacked, x_enc, modes,
                                  dtype=T.model_dtype(cfg))
    x_dec = T.run_layers_prefill(dec_l, y, positions, dec_st, cfg,
                                 kinds=kinds[s:], lengths=lens_t)
    del states, enc_st, dec_st

    def first_layer(x_in, st, nb):
        sink = []
        with recording(ops, "rglru_scan_op", sink):
            T.run_layers_prefill(params["layers"][:1], x_in,
                                 positions[:nb, :x_in.shape[1]], st, cfg,
                                 kinds=kinds[:1])
        return sink[0]

    # a fresh prompt's carry is zero: pass none (the kernel's other branch)
    scans = {"[4, 2048] prefill, no h0": long_scan[0][:2] + (None,)}
    for nb in (1, 4):
        st = T.init_decode_state(cfg, nb, 16, device=dev)[:1]
        scans[f"[{nb}, 16] main-path prefill"] = first_layer(x[:nb, :16], st,
                                                            nb)
    carry = {k: v[:3].clone() for k, v in st[0].items()}
    a, b, h0 = first_layer(x[:3, 16:53], (carry,), 3)
    scans["[3, 37] from a carried state"] = (a, b, h0)
    scans["[3, 37, 1000] odd width"] = (a[:, :, :1000].contiguous(),
                                        b[:, :, :1000].contiguous(),
                                        h0[:, :1000].contiguous())
    scans["[3, 1] one step from a carried state"] = (
        a[:, :1].contiguous(), b[:, :1].contiguous(), h0)
    # 4-byte copies: a width that is not a multiple of 4, and rows that
    # start one float past a 16-byte boundary
    scans["[3, 37, 1001] width not a multiple of 4"] = (
        a[:, :, :1001].contiguous(), b[:, :, :1001].contiguous(),
        h0[:, :1001].contiguous())

    def off_by_one_float(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view

    scans["[3, 37, 1000] rows one float off 16-byte alignment"] = (
        off_by_one_float(a[:, :, :1000]), off_by_one_float(b[:, :, :1000]),
        h0[:, :1000].contiguous())
    rng = np.random.default_rng(seed + 20)
    scans[BENCH_SCAN] = (
        torch.sigmoid(torch.from_numpy(rng.standard_normal(
            (4, 1024, 512)).astype(np.float32)).to(dev)),
        torch.from_numpy(rng.standard_normal((4, 1024, 512)).astype(
            np.float32)).to(dev), None)
    torch.cuda.synchronize(dev)
    valid = torch.arange(S, device=dev)[None, :] < lens_t[:, None]
    return {"params": params, "stacked": stacked, "x_enc": x_enc,
            "x_dec": x_dec, "valid": valid, "scans": scans}


XLENS = (512, 16, 300, 77)   # ragged; one prompt 32 times the main path's


def capture_xlstm(cfg, dev, seed: int):
    """One ragged prefill of full-width xlstm-125m on the dense state (mLSTM
    and sLSTM carries): the encoder output at the split, the decoder output
    before the tail, and the first mLSTM layer's normalizer scan inputs —
    [4, 512, 1536] (this prefill), [4, 16, 1536] (the main path's prompts,
    from a fresh state: a zero carry passed as h0) and [3, 37, 1536]
    continuing from the carry that prefill left."""
    import numpy as np
    import torch

    from repro_torch.core import bottleneck
    from repro_torch.core import split as SP
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    params = SP.init_split_params(gen, cfg)
    stacked = bottleneck.bank_stack(params["bneck_modes"], cfg.split)
    lens = np.asarray(XLENS, np.int64)
    B, S = len(lens), max(XLENS)
    toks = torch.from_numpy(
        MarkovTokenSource(cfg, seed=7).batch(B, S)["tokens"]).to(dev)
    lens_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
    modes = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=dev)
    s = cfg.split.split_at
    kinds = SP._kinds(cfg)
    x = T.embed_tokens(params, toks, cfg)
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    states = T.init_decode_state(cfg, B, S, device=dev)
    enc_l, dec_l = SP.slice_layers(params["layers"], cfg, s)
    enc_st, dec_st = SP._split_states(states, cfg, s)
    with recording(ops, "rglru_scan_op", []) as long_scan:
        x_enc = T.run_layers_prefill(enc_l, x, positions, enc_st, cfg,
                                     kinds=kinds[:s], lengths=lens_t)
    y = bottleneck.boundary_mixed(stacked, x_enc, modes,
                                  dtype=T.model_dtype(cfg))
    x_dec = T.run_layers_prefill(dec_l, y, positions, dec_st, cfg,
                                 kinds=kinds[s:], lengths=lens_t)
    del states, enc_st, dec_st

    def first_layer(x_in, st, nb):
        sink = []
        with recording(ops, "rglru_scan_op", sink):
            T.run_layers_prefill(params["layers"][:1], x_in,
                                 positions[:nb, :x_in.shape[1]], st, cfg,
                                 kinds=kinds[:1])
        return sink[0]

    scans = {f"{cfg.name} [4, 512] prefill": long_scan[0]}
    st = T.init_decode_state(cfg, 4, 16, device=dev)[:1]
    scans[f"{cfg.name} [4, 16] main-path prefill"] = first_layer(
        x[:, :16], st, 4)
    carry = {k: v[:3].clone() for k, v in st[0].items()}
    scans[f"{cfg.name} [3, 37] from a carried state"] = first_layer(
        x[:3, 16:53], (carry,), 3)
    torch.cuda.synchronize(dev)
    valid = torch.arange(S, device=dev)[None, :] < lens_t[:, None]
    return {"params": params, "stacked": stacked, "x_enc": x_enc,
            "x_dec": x_dec, "valid": valid, "scans": scans}


def pick_rows(x, valid, n: int, seed: int):
    """``n`` real token rows of a [B, S, d] activation as [n, 1, d]."""
    import numpy as np
    import torch
    idx = torch.nonzero(valid.reshape(-1)).reshape(-1).cpu().numpy()
    sel = np.random.default_rng(seed).choice(idx, size=n, replace=False)
    return x.reshape(-1, x.shape[-1])[torch.from_numpy(np.sort(sel)).to(
        x.device)][:, None, :].contiguous()


# ---------------------------------------------------------------------------
# kernel 1: the mixed-mode boundary
# ---------------------------------------------------------------------------

# synthetic heads stacked after the model's own (width 512, 8 bits), so one
# bank covers every wire width the kernel takes
EXTRA_HEADS = ((512, 4), (384, 1), (256, 0))


def test_bank(stacked, d: int, dev, seed: int):
    """The model's bank and the synthetic heads, scaled down by wmax / 512
    where the model's own width is under 512 (xlstm-125m: 192, 144, 96)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    wmax = stacked["down_w"].shape[2]
    dt = stacked["down_w"].dtype
    widths = [min(w, w * wmax // 512) for w, _ in EXTRA_HEADS]
    downs, ups = [stacked["down_w"]], [stacked["up_w"]]
    for w in widths:
        dw = torch.randn((1, d, wmax), generator=gen, device=dev)
        uw = torch.randn((1, wmax, d), generator=gen, device=dev)
        dw, uw = dw / math.sqrt(d), uw / math.sqrt(w)
        dw[:, :, w:] = 0
        uw[:, w:, :] = 0
        downs.append(dw.to(dt))
        ups.append(uw.to(dt))
    return {
        "down_w": torch.cat(downs).contiguous(),
        "up_w": torch.cat(ups).contiguous(),
        "norm_scale": torch.cat([stacked["norm_scale"], torch.ones(
            (len(EXTRA_HEADS), d), dtype=dt, device=dev)]).contiguous(),
        "width": torch.cat([stacked["width"], torch.tensor(
            widths, dtype=torch.int32, device=dev)]),
        "bits": torch.cat([stacked["bits"], torch.tensor(
            [b for _, b in EXTRA_HEADS], dtype=torch.int32, device=dev)]),
    }


def boundary_envelope(bank, x2, rmode, yr):
    """Per-element bound on |kernel - plain| for the quantized rows (see
    ``TOL["boundary"]``), computed from the plain version's own z."""
    import torch
    dt = x2.dtype
    u = 2.0 ** -8 if dt == torch.bfloat16 else 2.0 ** -16
    M = bank["width"].shape[0]
    mode = torch.where(rmode == 0, 0, rmode.clamp(1, M))
    env = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
    for m in range(1, M + 1):
        rows = torch.nonzero(mode == m).reshape(-1)
        if rows.numel() == 0:
            continue
        hid = m - 1
        width, bits = int(bank["width"][hid]), int(bank["bits"][hid])
        xf = x2[rows].float()
        h = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
        h = (h * bank["norm_scale"][hid].float()).to(dt)
        z = (h.double() @ bank["down_w"][hid].double()).to(dt).float()
        z[:, width:] = 0
        qm = float(max((1 << (max(bits, 1) - 1)) - 1, 1))
        scale = torch.clamp(z.abs().amax(-1, keepdim=True), min=1e-8) / qm
        up = bank["up_w"][hid].float().abs()
        if bits == 0:
            wired = z
            edge = torch.zeros_like(z)
        else:
            r = z / scale
            wired = torch.clamp(torch.round(r), -qm, qm) * scale
            frac = torch.abs(r.abs() - torch.floor(r.abs()) - 0.5)
            edge = (frac <= 2 * u * (r.abs() + 1)).float() * scale
        env[rows] = (2 * u * (wired.abs() @ up) + edge @ up
                     + u * yr[rows].float().abs() + 1e-6)
    return env


def check_boundary(bank, x, modes, label):
    """The kernel on the rows in place against its plain version: mode-0
    rows bit for bit, quantized rows inside the envelope, and each sequence
    called alone bit-identical to its rows in the pool. Returns (max error,
    worst envelope ratio, the pool's plan)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.boundary_mixed import boundary_mixed_grouped
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    modes = modes.to(torch.int32)
    rmode = modes.repeat_interleave(S)
    yk = boundary_mixed_grouped(x2, modes, S, bank, dtype=x.dtype)
    plan = boundary_mixed_grouped.last_plan
    torch.cuda.synchronize()
    yr = ref.boundary_mixed_rows_ref(x2, rmode, bank, x.dtype)
    raw = rmode == 0
    check(same_bits(yk[raw], x2[raw]) and same_bits(yk[raw], yr[raw]),
          f"boundary {label}: mode-0 rows are not bit-for-bit")
    err = (yk.float() - yr.float()).abs()
    env = boundary_envelope(bank, x2, rmode, yr)
    quant = ~raw
    ratio = float((err[quant] / env[quant]).max()) if quant.any() else 0.0
    check(ratio <= 1.0 and bool(torch.isfinite(yk.float()).all()),
          f"boundary {label}: error {float(err.max())} exceeds the "
          f"envelope (worst ratio {ratio:.3f})")
    for b in range(B):
        alone = boundary_mixed_grouped(x2[b * S:(b + 1) * S], modes[b:b + 1],
                                       S, bank, dtype=x.dtype)
        check(same_bits(alone, yk[b * S:(b + 1) * S]),
              f"boundary {label}: sequence {b} alone differs from its rows "
              f"in the pool")
    return float(err.max()), ratio, plan


def boundary_cases(cap, label: str, d: int, dev, seed: int, gen):
    """Pool and prefill cases on one model's bank (+ the synthetic heads)
    and encoder output, in bf16 and f32."""
    import torch
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        bank = test_bank({k: (v.to(dt) if v.is_floating_point() else v)
                          for k, v in cap["stacked"].items()}, d, dev, seed)
        M = bank["width"].shape[0]
        for n in (1, 8, 32):
            x = pick_rows(cap["x_enc"], cap["valid"], n, seed + n).to(dt)
            modes = torch.randint(0, M + 1, (n,), generator=gen)
            if n >= M + 1:
                modes[:M + 1] = torch.arange(M + 1)
            cases.append((f"{label} {dtype_name(dt)} pool {n}", bank, x,
                          modes.to(dev)))
        x = cap["x_enc"][:, :64].to(dt).contiguous()     # [B, S, d] prefill
        modes = torch.arange(x.shape[0]) % (M + 1)
        cases.append((f"{label} {dtype_name(dt)} prefill {tuple(x.shape)}",
                      bank, x, modes.to(dev)))
    return cases


def time_boundary(cap, d: int, dev, seed: int, iters: int, seq: int = 1):
    """Device ms of the kernel and of its plain version at the main path's
    decode shape (``seq`` 1: 4 slots, one row each) or prefill dispatch
    (``seq`` 16: 4 prompts of 16 tokens, 64 rows) on the model's own bank,
    one sequence in raw mode 0; with the bound of that call, the tile the
    plan picked and the device kernels one dispatcher call issues (at most
    ``MAX_KERNELS["boundary"]``)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.boundary_mixed import boundary_mixed_grouped
    st = cap["stacked"]
    x4 = (pick_rows(cap["x_enc"], cap["valid"], 4, seed + 4) if seq == 1
          else cap["x_enc"][:4, :seq].contiguous())
    n = 4 * seq
    x2 = x4.reshape(n, d)
    modes4 = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
    flush = l2_flusher(dev)
    parts = {}
    ms = time_ms(lambda: boundary_mixed_grouped(x2, modes4, seq, st,
                                                dtype=x2.dtype), iters, flush,
                 parts)
    plan = boundary_mixed_grouped.last_plan
    plain = time_ms(lambda: ref.boundary_mixed_rows_ref(
        x2, modes4.repeat_interleave(seq), st, x2.dtype),
        max(iters // 5, 3), flush)
    kernels = dispatcher_kernels(lambda: ops.boundary_mixed_op(
        st, x4, modes4, dtype=x4.dtype))
    check(kernels <= MAX_KERNELS["boundary"],
          f"boundary: one dispatcher call issues {kernels} device kernels, "
          f"more than {MAX_KERNELS['boundary']}")
    w = int(st["width"][0])
    nq = int((modes4 > 0).sum()) * seq
    nbytes = 2 * (2 * n * d + 2 * d * w + d)
    b_ms, b_by = bound(nbytes, 2 * 2 * d * w * nq, "bfloat16")
    return {"timed_shape": {"rows": n, "d": d, "width": w,
                            "modes": [1, 1, 0, 1], "tokens_a_sequence": seq},
            "mt": plan["mt"], "smem": plan["smem"],
            "ms": ms, "ms_by_kernel": parts, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by,
            "device_kernels_per_call": kernels}


def phase_boundary(cap, rcap, xcap, cfg, rcfg, xcfg, dev, seed: int,
                   iters: int):
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cases = (boundary_cases(cap, cfg.name, cfg.d_model, dev, seed, gen)
             + boundary_cases(rcap, rcfg.name, rcfg.d_model, dev, seed, gen)
             + boundary_cases(xcap, xcfg.name, xcfg.d_model, dev, seed, gen))
    # xlstm-125m: d 768 is one K slice of 512 and one of 256; its 4-row
    # decode shape (one m-tile a block) and its prefill (four)
    x4 = pick_rows(xcap["x_enc"], xcap["valid"], 4, seed + 4)
    for dt in (torch.bfloat16, torch.float32):
        bank = {k: (v.to(dt) if v.is_floating_point() else v)
                for k, v in xcap["stacked"].items()}
        cases.append((f"{xcfg.name} {dtype_name(dt)} decode 4 rows", bank,
                      x4.to(dt), torch.tensor([1, 1, 0, 1], device=dev)))
    # the reduced config's widths (bank narrower than one 128-lane chunk)
    for dt in (torch.bfloat16, torch.float32):
        small = {"down_w": torch.randn((4, 128, 32), generator=gen),
                 "up_w": torch.randn((4, 32, 128), generator=gen),
                 "norm_scale": 1 + 0.1 * torch.randn((4, 128), generator=gen)}
        small = {k: (v / math.sqrt(v.shape[1])).to(dt).to(dev)
                 for k, v in small.items()}
        widths, bits = [32, 16, 24, 8], [8, 4, 1, 0]
        for i, w in enumerate(widths):
            small["down_w"][i, :, w:] = 0
            small["up_w"][i, w:, :] = 0
        small["width"] = torch.tensor(widths, dtype=torch.int32, device=dev)
        small["bits"] = torch.tensor(bits, dtype=torch.int32, device=dev)
        x = torch.randn((8, 1, 128), generator=gen).to(dt).to(dev)
        cases.append((f"{dtype_name(dt)} reduced bank wmax 32", small, x,
                      (torch.arange(8) % 5).to(dev)))
        x = torch.randn((32, 1, 128), generator=gen).to(dt).to(dev)
        cases.append((f"{dtype_name(dt)} reduced bank wmax 32 pool 32", small,
                      x, torch.randint(0, 5, (32,), generator=gen).to(dev)))
    worst, rows = 0.0, []
    for label, bank, x, modes in cases:
        e, r, plan = check_boundary(bank, x, modes, label)
        worst = max(worst, e)
        rows.append({"case": label, "max_abs_err": e, "envelope_ratio": r,
                     "mt": plan["mt"]})

    # timing at each main path's decode shape (qwen2.5-3b: width 512,
    # recurrentgemma-2b: width 640, xlstm-125m: width 192, all 8 bits);
    # qwen's is the headline
    timed = time_boundary(cap, cfg.d_model, dev, seed, iters)
    out = {"phase": "kernel", "name": "boundary_mixed_grouped",
           "tolerance": TOL["boundary"], "cases": rows,
           "max_abs_err": worst, **timed, "library_ms": None,
           rcfg.name: time_boundary(rcap, rcfg.d_model, dev, seed, iters),
           xcfg.name: time_boundary(xcap, xcfg.d_model, dev, seed, iters)}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# kernel 2: the fused decode tail
# ---------------------------------------------------------------------------

def check_tail(x, scale, head, label, expect=None, bias=None,
               norm_kind="rmsnorm", tied=False, head_idx=None, tokens=None):
    """Kernel tokens (through the dispatcher, or ``tokens`` [n] when given)
    against the plain logits. ``tied``: ``head`` is the [1, V, d] embedding
    table; ``head_idx``: [n] per-row head of a stacked [H, d, V]."""
    import torch
    from repro_torch.kernels import ops, ref
    tk = (ops.decode_tail_op(x, scale, bias, head, head_idx,
                             norm_kind=norm_kind, tied=tied)
          if tokens is None else tokens[:, None])
    torch.cuda.synchronize()
    tr = ref.decode_tail_ref(x, scale, bias, head, head_idx,
                             norm_kind=norm_kind, tied=tied)
    xn = ref._final_norm(x.float(), scale, bias, norm_kind).to(x.dtype)
    if head_idx is not None:
        logits = torch.einsum("nd,ndv->nv", xn.float()[:, 0],
                              head[head_idx.long()].float())
    else:
        w = head[0].float()
        logits = xn.float()[:, 0] @ (w.t() if tied else w)       # [n, V]
        del w
    lmax = logits.amax(-1)
    picked = logits.gather(1, tk[:, 0:1].long())[:, 0]
    gap = (lmax - picked) / lmax.abs().clamp(min=1e-30)
    bad = (tk[:, 0] != tr[:, 0]) & (gap > TOL["tail_rel_gap"])
    check(not bool(bad.any()),
          f"tail {label}: {int(bad.sum())} tokens differ beyond a near-tie")
    abs_gap = float((lmax - picked).max())
    if expect is not None:
        check(int(tk[0, 0]) == expect and int(tr[0, 0]) == expect,
              f"tail {label}: exact tie resolved to {int(tk[0, 0])} "
              f"(plain {int(tr[0, 0])}), expected the lowest index {expect}")
    return int((tk != tr).sum()), abs_gap


def tail_block_cases(x_dec, valid, head, scale, seed: int, rows: list,
                     tied=False):
    """4 real rows in one 16-row block of a padded layout, with a real-row
    count (``n_real``) and with a per-block count (``rows_g``): the kernel
    computes one n-tile of 8 and the rows' tokens must hold."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.boundary_mixed import decode_tail_grouped
    dev = x_dec.device
    x4 = pick_rows(x_dec, valid, 4, seed)
    dest, hid_g, P = ops.head_layout(torch.zeros(4, dtype=torch.int32,
                                                 device=dev), 1, 16)
    xp = torch.zeros((P, x4.shape[-1]), dtype=x4.dtype, device=dev)
    xp[dest] = x4[:, 0]
    bias = torch.zeros_like(scale)
    layout = "tied " if tied else ""
    for kw, how in (({"n_blocks": 1, "n_real": 4}, "n_real"),
                    ({"rows_g": torch.tensor([4, 0], dtype=torch.int32,
                                             device=dev)}, "rows_g")):
        tok = decode_tail_grouped(xp, head, scale, bias, hid_g, block_r=16,
                                  tied=tied, **kw)
        label = f"{layout}bf16 4 real rows of a 16-row block ({how})"
        diff, gap = check_tail(x4, scale, head, label, tied=tied,
                               tokens=tok[dest])
        rows.append({"case": label, "tokens_differing": diff,
                     "max_abs_err": gap})


def tail_kernels(x4, scale, head, tied=False, bias=None,
                 norm_kind="rmsnorm") -> float:
    """Device kernels of one one-head ``ops.decode_tail_op`` call as the
    main path makes it (a bias with a layernorm); at most
    ``MAX_KERNELS["tail"]``."""
    from repro_torch.kernels import ops
    n = dispatcher_kernels(lambda: ops.decode_tail_op(x4, scale, bias, head,
                                                      tied=tied,
                                                      norm_kind=norm_kind))
    check(n <= MAX_KERNELS["tail"],
          f"tail: one dispatcher call issues {n} device kernels, more than "
          f"{MAX_KERNELS['tail']}")
    return n


def phase_tail(cap, rcap, xcap, cfg, xcfg, dev, seed: int, iters: int):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.boundary_mixed import decode_tail_grouped
    params = cap["params"]
    head = params["lm_head"]["w"][None]                        # [1, d, V]
    scale = params["final_norm"]["scale"]
    V = head.shape[2]
    rows = []
    for n in (1, 3, 13, 32):
        x = pick_rows(cap["x_dec"], cap["valid"], n, seed + 100 + n)
        diff, gap = check_tail(x, scale, head, f"bf16 pool {n}")
        rows.append({"case": f"bfloat16 pool {n}", "tokens_differing": diff,
                     "max_abs_err": gap})
    # the layernorm family (+ bias) of the final norm, on the same head
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    bias = (0.1 * torch.randn(scale.shape, generator=gen, device=dev)).to(
        scale.dtype)
    x = pick_rows(cap["x_dec"], cap["valid"], 8, seed + 150)
    diff, gap = check_tail(x, scale, head, "bf16 layernorm pool 8",
                           bias=bias, norm_kind="layernorm")
    rows.append({"case": "bfloat16 layernorm pool 8",
                 "tokens_differing": diff, "max_abs_err": gap})
    # an exact tie: row 0's winning column copied to a lower index and to a
    # later vocab tile; the lowest index must win on both sides
    x = pick_rows(cap["x_dec"], cap["valid"], 8, seed + 200)
    top = int(ref.decode_tail_ref(x, scale, None, head)[0, 0])
    low = 5 if top > 5 else top
    tied = head.clone()
    tied[0, :, low] = head[0, :, top]
    tied[0, :, (top + V // 2) % V] = head[0, :, top]
    check_tail(x, scale, tied, "bf16 exact tie", expect=low)
    rows.append({"case": "bfloat16 exact tie", "expected": low})
    del tied
    tail_block_cases(cap["x_dec"], cap["valid"], head, scale, seed + 250,
                     rows)
    # three heads (column slices of the LM head): each block's real rows
    # come from the layout on the device (ops.head_rows)
    heads3 = torch.stack([head[0, :, i * 4096:(i + 1) * 4096]
                          for i in range(3)]).contiguous()
    x = pick_rows(cap["x_dec"], cap["valid"], 13, seed + 260)
    hidx = torch.tensor([0, 2, 1, 2, 2, 0, 1, 1, 2, 0, 2, 2, 1],
                        dtype=torch.int32, device=dev)
    diff, gap = check_tail(x, scale, heads3, "bf16 3 heads pool 13",
                           head_idx=hidx)
    rows.append({"case": "bfloat16 3 heads pool 13",
                 "tokens_differing": diff, "max_abs_err": gap})
    del heads3
    x32 = x.float()
    head32 = head.float()
    diff, gap = check_tail(x32, scale.float(), head32, "f32 pool 8")
    rows.append({"case": "float32 pool 8", "tokens_differing": diff,
                 "max_abs_err": gap})
    del head32

    # timing at the main path's decode shape: 4 rows in place, one head
    x4 = pick_rows(cap["x_dec"], cap["valid"], 4, seed + 300)
    parts = {}
    ms = time_ms(lambda: decode_tail_grouped(x4[:, 0], head, scale, None,
                                             block_r=16), iters,
                 by_kernel=parts)
    kernels = tail_kernels(x4, scale, head)
    plain = time_ms(lambda: ref.decode_tail_ref(x4, scale, None, head), iters)
    d = x4.shape[-1]
    b_ms, b_by = bound(2 * (V * d + 4 * d + 2 * d) + 4 * 4, 2 * 4 * d * V,
                       "bfloat16")
    tied = tail_tied(rcap, dev, seed, iters, rows)
    layernorm = tail_layernorm(xcap, xcfg, dev, seed, iters, rows)
    out = {"phase": "kernel", "name": "decode_tail_grouped",
           "tolerance": f"tokens equal except near-ties (relative top-two "
                        f"gap < {TOL['tail_rel_gap']}); exact tie -> lowest "
                        f"index", "cases": rows,
           "max_abs_err": max(r.get("max_abs_err", 0.0) for r in rows),
           "timed_shape": {"rows": 4, "d": d, "V": V},
           "ms": ms, "ms_by_kernel": parts, "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": b_by, "bound_over_ms": b_ms / ms,
           "device_kernels_per_call": kernels, "library_ms": None,
           "tied": tied, xcfg.name: layernorm}
    emit(out)
    return out


def tail_layernorm(xcap, cfg, dev, seed: int, iters: int, rows: list):
    """xlstm-125m's tail: a layernorm with a bias, then the untied [768,
    50304] head (V a multiple of 128, not of 256: 393 slabs). The model's
    norm is perturbed (scale 1 + 0.1 N, bias 0.1 N; init makes ones and
    zeros). Tokens against the plain logits at 1, 4 and 13 rows, an
    injected exact tie, and the timing and device kernels of the main
    path's 4 rows in place."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.boundary_mixed import decode_tail_grouped
    params = xcap["params"]
    head = params["lm_head"]["w"][None]                        # [1, d, V]
    fn = params["final_norm"]
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    scale = (fn["scale"].float() + 0.1 * torch.randn(
        fn["scale"].shape, generator=gen, device=dev)).to(head.dtype)
    bias = (fn["bias"].float() + 0.1 * torch.randn(
        fn["bias"].shape, generator=gen, device=dev)).to(head.dtype)
    V, d = head.shape[2], head.shape[1]
    ln = dict(bias=bias, norm_kind="layernorm")
    for n in (1, 4, 13):
        x = pick_rows(xcap["x_dec"], xcap["valid"], n, seed + 700 + n)
        diff, gap = check_tail(x, scale, head, f"{cfg.name} layernorm "
                               f"bf16 pool {n}", **ln)
        rows.append({"case": f"{cfg.name} layernorm bfloat16 pool {n}",
                     "tokens_differing": diff, "max_abs_err": gap})
    x = pick_rows(xcap["x_dec"], xcap["valid"], 8, seed + 750)
    top = int(ref.decode_tail_ref(x, scale, bias, head,
                                  norm_kind="layernorm")[0, 0])
    low = 5 if top > 5 else top
    tied = head.clone()
    tied[0, :, low] = head[0, :, top]
    tied[0, :, (top + V // 2) % V] = head[0, :, top]
    check_tail(x, scale, tied, f"{cfg.name} layernorm exact tie",
               expect=low, **ln)
    rows.append({"case": f"{cfg.name} layernorm exact tie", "expected": low})
    del tied
    x4 = pick_rows(xcap["x_dec"], xcap["valid"], 4, seed + 800)
    parts = {}
    ms = time_ms(lambda: decode_tail_grouped(x4[:, 0], head, scale, bias,
                                             block_r=16,
                                             norm_kind="layernorm"), iters,
                 by_kernel=parts)
    kernels = tail_kernels(x4, scale, head, **ln)
    plain = time_ms(lambda: ref.decode_tail_ref(x4, scale, bias, head,
                                                norm_kind="layernorm"), iters)
    b_ms, b_by = bound(2 * (V * d + 4 * d + 3 * d) + 4 * 4, 2 * 4 * d * V,
                       "bfloat16")
    return {"timed_shape": {"rows": 4, "d": d, "V": V,
                            "norm": "layernorm + bias"},
            "ms": ms, "ms_by_kernel": parts, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "bound_over_ms": b_ms / ms,
            "device_kernels_per_call": kernels}


def tail_tied(rcap, dev, seed: int, iters: int, rows: list):
    """The tied layout: recurrentgemma-2b's [V, d] embedding table (V
    256000, d 2560), read in place. Tokens against the plain logits, an
    injected exact tie, the memory one call allocates (a per-call
    transpose of the table would take 1.31 GB), and the timing at the
    main path's 4 rows."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.boundary_mixed import decode_tail_grouped
    params = rcap["params"]
    table = params["embed"]["table"]
    head = table[None]                                         # [1, V, d]
    scale = params["final_norm"]["scale"]
    V, d = table.shape
    for n in (1, 4, 13):
        x = pick_rows(rcap["x_dec"], rcap["valid"], n, seed + 400 + n)
        diff, gap = check_tail(x, scale, head, f"tied bf16 pool {n}",
                               tied=True)
        rows.append({"case": f"tied bfloat16 pool {n}",
                     "tokens_differing": diff, "max_abs_err": gap})
    x = pick_rows(rcap["x_dec"], rcap["valid"], 8, seed + 500)
    top = int(ref.decode_tail_ref(x, scale, None, head, tied=True)[0, 0])
    low = 5 if top > 5 else top
    tied = table.clone()
    tied[low] = table[top]
    tied[(top + V // 2) % V] = table[top]
    check_tail(x, scale, tied[None], "tied bf16 exact tie", expect=low,
               tied=True)
    rows.append({"case": "tied bfloat16 exact tie", "expected": low})
    del tied
    tail_block_cases(rcap["x_dec"], rcap["valid"], head, scale, seed + 550,
                     rows, tied=True)
    x4 = pick_rows(rcap["x_dec"], rcap["valid"], 4, seed + 600)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.decode_tail_op(x4, scale, None, head, tied=True)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    check(extra < 64 << 20, f"tied tail: one call allocated {extra} bytes "
                            f"(a copy of the table?)")
    parts = {}
    ms = time_ms(lambda: decode_tail_grouped(x4[:, 0], head, scale, None,
                                             block_r=16, tied=True), iters,
                 by_kernel=parts)
    kernels = tail_kernels(x4, scale, head, tied=True)
    plain = time_ms(lambda: ref.decode_tail_ref(x4, scale, None, head,
                                                tied=True),
                    max(iters // 5, 3))
    b_ms, b_by = bound(2 * (V * d + 4 * d + 2 * d) + 4 * 4, 2 * 4 * d * V,
                       "bfloat16")
    return {"timed_shape": {"rows": 4, "d": d, "V": V, "layout": "[V, d]"},
            "ms": ms, "ms_by_kernel": parts, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "bound_over_ms": b_ms / ms,
            "device_kernels_per_call": kernels,
            "call_extra_bytes": int(extra)}


# ---------------------------------------------------------------------------
# kernel 3: paged decode attention
# ---------------------------------------------------------------------------

def decode_query(cap, cfg, layer: int, pos):
    """Layer ``layer``'s rope'd query for a decode at ``pos`` [B], from the
    encoder output rows at those positions."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.layers import apply_rope, norm_apply
    p = T.layer_slice(cap["params"]["layers"], layer)
    B = pos.shape[0]
    h = cap["x_enc"][torch.arange(B, device=pos.device), pos.long()][:, None]
    q, _, _ = _project_qkv(p["mix"], norm_apply(p["norm1"], h, cfg.norm),
                           cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    return apply_rope(q, pos.reshape(B, 1), cfg.rope_theta)[:, 0].contiguous()


def sdpa_ms(q, kp, vp, bt, pos, iters, flush):
    """One ``scaled_dot_product_attention`` call on the same K/V gathered
    into logical order (the gather is done once, outside the timing)."""
    import torch
    import torch.nn.functional as F
    B, nq, hd = q.shape
    nb, plen, n_kv = bt.shape[1], kp.shape[1], kp.shape[2]
    k = kp[bt.long()].reshape(B, nb * plen, n_kv, hd).transpose(1, 2)
    v = vp[bt.long()].reshape(B, nb * plen, n_kv, hd).transpose(1, 2)
    k = k.repeat_interleave(nq // n_kv, 1).contiguous()
    v = v.repeat_interleave(nq // n_kv, 1).contiguous()
    mask = (torch.arange(nb * plen, device=q.device)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qq = q[:, :, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask), iters, flush)


def paged_bound(kp, q, bt, pos):
    """(least ms, "bytes" or "operations") of one paged call: q read and
    the output written once, the K/V rows of each sequence's live pages,
    the table and the positions; 4 nq hd flops a live row."""
    plen, n_kv, hd = kp.shape[1], kp.shape[2], kp.shape[3]
    nq, es = q.shape[1], q.element_size()
    pages = sum(int(p) // plen + 1 for p in pos)
    nbytes = (2 * q.numel() * es + pages * plen * n_kv * hd * es * 2
              + bt.numel() * 4 + pos.numel() * 4)
    flops = sum(4 * nq * hd * (int(p) + 1) for p in pos)
    return bound(nbytes, flops, dtype_name(q.dtype))


def check_paged(q, kp, vp, bt, pos, pps, label, oracle=False):
    """The kernel at ``pps`` pages a range against the plain version (and, with ``oracle``, the split-order
    mirror at the same pps): bf16 bit for bit, f32 within
    ``TOL["paged_f32_abs"]``. Returns the case's record."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    out = paged_attention(q, kp, vp, bt, pos, pages_per_split=pps)
    torch.cuda.synchronize()
    wants = [ref.paged_attention_ref(q, kp, vp, bt, pos)]
    if oracle:
        wants.append(ref.paged_attention_split_ref(
            q, kp, vp, bt, pos, pps))
    bf = q.dtype == torch.bfloat16
    tol = TOL["paged_bf16_abs"] if bf else TOL["paged_f32_abs"]
    errs, differing = [], []
    for want in wants:
        errs.append(float((out.float() - want.float()).abs().max()))
        differing.append(int((out != want).sum()))
    ok = (bool(torch.isfinite(out.float()).all()) and max(errs) <= tol
          and not (bf and any(differing)))
    check(ok, f"paged attention {label}: max error {errs}, "
              f"{differing} elements differ")
    return {"case": label, "pages_per_split": pps, "max_abs_err": max(errs),
            "elements_differing": max(differing),
            "checked_against": ["plain"] + (["split oracle"] if oracle
                                            else [])}


def phase_paged(cap, cfg, dev, seed: int, iters: int, f32_long=True):
    """The one-range and the split form at the long shape (the capture's
    positions, up to 999) and at the main path's decode shape, bf16 bit
    for bit and f32 within tolerance against the plain version and the
    split-order mirror (f32 at the long shape only with ``f32_long``); then
    times at both shapes beside SDPA on the gathered K/V and the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (pages_per_split_for,
                                                     paged_attention)
    layer = cfg.split.split_at - 1
    kp, vp = cap["arena"]["k"][layer], cap["arena"]["v"][layer]
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    # junk in scratch page 0: a masked read of it must not show
    kp[0] = torch.randn(kp[0].shape, generator=gen, device=dev).to(kp.dtype)
    vp[0] = torch.randn(vp[0].shape, generator=gen, device=dev).to(vp.dtype)
    lens = torch.from_numpy(cap["lens"]).to(dev)
    pos = (lens - 1).to(torch.int32)
    q = decode_query(cap, cfg, layer, pos)
    bt = cap["bt"]
    B, nb = bt.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    auto = pages_per_split_for(B, kp.shape[2], nb, sms)
    # the main path's decode shape: 4 slots at positions the 16-token
    # prompts reach while generating 16 tokens
    seqs = torch.tensor([0, 4, 5, 7], device=dev)
    pos4 = torch.tensor([16, 20, 24, 31], dtype=torch.int32, device=dev)
    bt4 = bt[seqs][:, :4].contiguous()
    q4 = decode_query(cap, cfg, layer, pos4)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        qd, kd, vd = q.to(dt), kp.to(dt), vp.to(dt)
        name = dtype_name(dt)
        for pps, form in ((nb, "one range"), (auto, f"split {auto}"),
                          (3, "split 3")):
            if dt == torch.float32 and not f32_long:
                break
            rows.append(check_paged(qd, kd, vd, bt, pos, pps,
                                    f"{name} long {form}",
                                    oracle=pps != 3))
        q4d = q4.to(dt)
        for pps, form in ((4, "one range"), (1, "split 1")):
            rows.append(check_paged(q4d, kd, vd, bt4, pos4, pps,
                                    f"{name} decode {form}", oracle=True))
        del kd, vd
    flush = l2_flusher(dev)
    # decode shape (the headline)
    ms = time_ms(lambda: paged_attention(q4, kp, vp, bt4, pos4), iters, flush)
    plain = time_ms(lambda: ref.paged_attention_ref(q4, kp, vp, bt4, pos4),
                    max(iters // 5, 3), flush)
    lib = sdpa_ms(q4, kp, vp, bt4, pos4, iters, flush)
    b_ms, b_by = paged_bound(kp, q4, bt4, pos4)
    # long shape: both forms, SDPA, the bound
    parts = {}
    long = {"positions": [int(p) for p in pos], "nb": nb,
            "pages_per_split": auto,
            "ms": time_ms(lambda: paged_attention(q, kp, vp, bt, pos), iters,
                          flush, parts),
            "ms_by_kernel": parts,
            "one_range_ms": time_ms(lambda: paged_attention(
                q, kp, vp, bt, pos, pages_per_split=nb), iters, flush),
            "library_ms": sdpa_ms(q, kp, vp, bt, pos, iters, flush)}
    long["bound_ms"], long["bound_by"] = paged_bound(kp, q, bt, pos)
    long["plain_ms"] = time_ms(lambda: ref.paged_attention_ref(
        q, kp, vp, bt, pos), 2, flush)
    plen, n_kv, hd, nq = kp.shape[1], kp.shape[2], kp.shape[3], q4.shape[1]
    out = {"phase": "kernel", "name": "paged_attention", "arch": cfg.name,
           "tolerance": f"bf16 bit for bit (and {TOL['paged_bf16_abs']} "
                        f"abs), f32 {TOL['paged_f32_abs']} abs",
           "cases": rows, "max_abs_err": max(r["max_abs_err"] for r in rows),
           "timed_shape": {"B": 4, "positions": [int(p) for p in pos4],
                           "nq": nq, "n_kv": n_kv, "hd": hd, "page_len": plen},
           "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib, "library_call": "scaled_dot_product_attention "
                                              "on the gathered K/V",
           "long": long}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# kernel 4: the RG-LRU scan
# ---------------------------------------------------------------------------

def phase_rglru(rcap, xcap, dev, iters: int):
    """Every captured shape bit for bit against the plain version, with
    the plan it launched (the planner takes every tile width and both copy
    widths over these cases); device ms of the kernel and of the plain
    version at the main path's prefill shape [4, 16, D], at a window-long
    prompt [4, 2048, D] and at the kernel bench's [4, 1024, 512], each
    beside its byte bound (12 bytes a step a channel, plus h0); and at
    xlstm-125m's normalizer shapes [4, 16, 1536] and [4, 512, 1536]. No
    single PyTorch call computes this recurrence, so there is no library
    time."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as RS
    rows = []
    scans = {**rcap["scans"], **xcap["scans"]}
    for label, (a, b, h0) in scans.items():
        hr = ref.rglru_scan_ref(a, b, h0)
        hk = RS.rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        err = float((hk - hr).abs().max())
        check(torch.equal(hk, hr) and bool(torch.isfinite(hk).all()),
              f"rglru_scan {label}: not bit for bit (max error {err})")
        rows.append({"case": label, "shape": list(a.shape),
                     "h0": h0 is not None, "max_abs_err": err,
                     "plan": RS.rglru_scan.last_plan._asdict()})
    for want in ({"tile": t} for t in RS.TILES):
        check(any(want.items() <= r["plan"].items() for r in rows),
              f"rglru_scan: no captured case launched {want}")
    check({r["plan"]["vec"] for r in rows} == {1, 4},
          "rglru_scan: the captured cases miss a copy width")
    flush = l2_flusher(dev)

    def timed(key, n_iters, n_plain):
        a, b, h0 = scans[key]
        B, S, D = a.shape
        ms = time_ms(lambda: RS.rglru_scan(a, b, h0), n_iters, flush)
        plain = time_ms(lambda: ref.rglru_scan_ref(a, b, h0), n_plain, flush)
        b_ms, b_by = bound(3 * B * S * D * 4 + (B * D * 4 if h0 is not None
                                                else 0),
                           2 * B * S * D, "float32")
        return {"timed_shape": [B, S, D], "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_share": b_ms / ms,
                "plan": RS.rglru_scan.last_plan._asdict()}

    head = timed("[4, 16] main-path prefill", iters, max(iters // 5, 3))
    long = timed("[4, 2048] prefill, no h0", max(iters // 5, 3), 2)
    bench = timed(BENCH_SCAN, max(iters // 5, 3), 2)
    xl = "xlstm-125m"
    xlstm = {"main_path_prefill": timed(f"{xl} [4, 16] main-path prefill",
                                        iters, max(iters // 5, 3)),
             "prompt_512": timed(f"{xl} [4, 512] prefill",
                                 max(iters // 5, 3), 2)}
    out = {"phase": "kernel", "name": "rglru_scan",
           "tolerance": TOL["rglru"], "cases": rows,
           "max_abs_err": max(r["max_abs_err"] for r in rows), **head,
           "library_ms": None,
           "window_prompt": long, "bench_shape": bench, xl: xlstm}
    emit(out)
    return out


def phase_rglru_layer(rcap, cfg, dev, iters: int):
    """The first RG-LRU layer of full-width recurrentgemma-2b on the card
    with its float32 forms made once (``rglru_prepare``, as the engines
    run it) and made on each call: a prefill of 16 steps and three decode
    steps give the same bits either way; a prepared decode step issues
    ``CACHED_A_LAYER`` fewer device kernels (the five casts of the gate
    weights, biases and conv taps, and -softplus(-lam)'s three ops),
    counted as the nodes of a captured step (``graph_nodes``); the device
    ms of one decode step each way."""
    from repro_torch.models import rglru as RG
    i = next(i for i in range(cfg.n_layers) if cfg.block_kind(i) == "rglru")
    raw = rcap["params"]["layers"][i]["mix"]
    prep = RG.rglru_prepare(raw)
    d_rnn = cfg.d_rnn or cfg.d_model
    x = rcap["x_enc"][:, :20].contiguous()
    st = {k: RG.rglru_state_init(x.shape[0], d_rnn, dtype=x.dtype,
                                 device=dev) for k in ("raw", "prep")}
    ys = {k: RG.rglru_prefill(p, x[:, :16], st[k])
          for k, p in (("raw", raw), ("prep", prep))}
    check(same_bits(ys["raw"], ys["prep"]),
          "rglru layer: the prepared prefill gives other bits")
    for t in range(16, 19):
        ys = {k: RG.rglru_step(p, x[:, t:t + 1], st[k])
              for k, p in (("raw", raw), ("prep", prep))}
        check(same_bits(ys["raw"], ys["prep"])
              and all(same_bits(st["raw"][k], st["prep"][k])
                      for k in ("h", "conv")),
              f"rglru layer: the prepared step {t} gives other bits")
    x1 = x[:, 19:20]
    # the check is exact, so the kernels are counted as the nodes of a
    # captured step: a profiler trace may drop device events
    kernels = {k: graph_nodes(lambda p=p, k=k: RG.rglru_step(p, x1, st[k]))
               for k, p in (("raw", raw), ("prep", prep))}
    check(kernels["raw"] - kernels["prep"] == CACHED_A_LAYER,
          f"rglru layer: a prepared decode step issues {kernels['prep']} "
          f"device kernels, the unprepared {kernels['raw']}; expected "
          f"{CACHED_A_LAYER} fewer")
    step_ms = {k: time_ms(lambda p=p, k=k: RG.rglru_step(p, x1, st[k]),
                          iters)
               for k, p in (("raw", raw), ("prep", prep))}
    n = sum(cfg.block_kind(j) == "rglru" for j in range(cfg.n_layers))
    emit({"phase": "rglru_layer", "arch": cfg.name, "layer": i,
          "rows": x.shape[0], "bits": "prefill and 3 steps bit for bit",
          "device_kernels_a_step": kernels, "step_ms": step_ms,
          "rglru_layers": n,
          "kernels_removed_a_model_step": n * CACHED_A_LAYER,
          "ms_removed_a_model_step": n * (step_ms["raw"] - step_ms["prep"]),
          "f32_forms_mb": sum(t.numel() * t.element_size() for t in (
              prep["f32"]["w_a"]["w"], prep["f32"]["w_a"]["b"],
              prep["f32"]["w_x"]["w"], prep["f32"]["w_x"]["b"],
              prep["f32"]["conv"], prep["f32"]["log_a"])) * n / 1e6})


def phase_xlstm_tick(xcap, cfg, dev, iters: int):
    """Full-width xlstm-125m on prepared parameters, as the engines run it:
    the device kernels (``device_kernels``) and device ms of one continuous
    decode tick on 4 slots, and of one prefill dispatch of 4 prompts of 16
    tokens (the main path's shapes). A prefill steps each layer's cell loop
    16 times (the scan carries only the mLSTM normalizer), so one dispatch
    launches about as many kernels as 16 ticks."""
    import torch
    from repro_torch.core import split as SP
    from repro_torch.models import transformer as T
    params = T.prepare_params(xcap["params"], cfg)
    stacked = xcap["stacked"]
    modes = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
    toks = (torch.arange(64, device=dev).reshape(4, 16) * 7919
            % cfg.vocab_size).to(torch.int32)
    lens = torch.full((4,), 16, dtype=torch.int32, device=dev)
    states = T.init_decode_state(cfg, 4, 16, device=dev)
    tok = toks[:, -1:].contiguous()

    def prefill():
        return SP.split_prefill_mixed(params, stacked, toks, states, cfg,
                                      modes, lengths=lens)

    def tick():
        return SP.split_decode_step_mixed(params, stacked, tok, states, lens,
                                          cfg, modes, return_tokens=True)

    out = {"phase": "xlstm_tick", "arch": cfg.name, "slots": 4,
           "prompt": 16}
    for name, fn, n in (("prefill_dispatch", prefill, 3),
                        ("decode_tick", tick, iters)):
        out[name] = {"device_kernels": device_kernels(fn, calls=2),
                     "ms": time_ms(fn, n)}
    emit(out)


# ---------------------------------------------------------------------------
# kernels 5 and 6: the wire pair, bottleneck_quant and dequant_matmul
# ---------------------------------------------------------------------------

def wire_inputs(cap, cfg, dev, seed: int):
    """The full-width wire of one model: the encoder output at the split
    rmsnormed by its bottleneck head (as ``bottleneck.encode`` does), the
    head's own down- and up-projections, bf16. Rows of the ragged prefill,
    512 of them."""
    from repro_torch.models.layers import norm_apply
    head = cap["params"]["bneck_modes"][0]
    x = pick_rows(cap["x_enc"], cap["valid"], 512, seed + 700)
    x = norm_apply(head["norm"], x, "rmsnorm")[:, 0].contiguous()
    return {"label": f"{cfg.name} wire", "x": x, "down": head["down"]["w"],
            "up": head["up"]["w"]}


def bench_inputs(dev):
    """The bench's f32 shapes, numpy-seeded: x [512, 2048], w_down
    [2048, 512], w_up [512, 2048]."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)

    def normal(shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dev)

    return {"label": "bench f32", "x": normal((512, 2048), 1.0),
            "down": normal((2048, 512), 0.02), "up": normal((512, 2048), 0.02)}


def off_alignment(x):
    """A contiguous copy of ``x`` whose storage starts one element past a
    16-byte boundary (the wire kernels' narrow copy path)."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def plan_of(fn) -> dict:
    return fn.last_plan._asdict()


def check_bq(x, w, bits: int, label: str, zero_row: bool):
    """Kernel codes and scales against the plain version (``TOL``). With
    ``zero_row`` row 0 is zeroed first: its codes must be 0 and its scale
    1e-8 / qmax exactly."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.bottleneck_quant import bottleneck_quant
    if zero_row:
        x = x.clone()
        x[0] = 0
    codes, scales = bottleneck_quant(x, w, bits=bits)
    torch.cuda.synchronize()
    cr, sr = ref.bottleneck_quant_ref(x, w, bits)
    qm = max((1 << (bits - 1)) - 1, 1)
    d = (codes.int() - cr.int()).abs()
    frac = float((d > 0).float().mean())
    srel = float(((scales - sr).abs() / sr).max())
    check(int(d.max()) <= 1 and frac < TOL["codes_frac"]
          and srel <= TOL["scale_rtol"]
          and int(codes.int().abs().max()) <= qm
          and bool(torch.isfinite(scales).all()),
          f"bottleneck_quant {label} bits {bits}: codes off by up to "
          f"{int(d.max())} on {frac:.4%} of lanes, scales by {srel:.3g}")
    if zero_row:
        want = torch.tensor(1e-8, device=x.device) / torch.tensor(
            float(qm), device=x.device)
        check(not codes[0].any() and float(scales[0, 0]) == float(want),
              f"bottleneck_quant {label} bits {bits}: the zero row gave "
              f"scale {float(scales[0, 0])} (expected {float(want)})")
    return codes, scales, {"case": f"{label} {tuple(x.shape)} x "
                                   f"{tuple(w.shape)} bits {bits}",
                           "codes_max_diff": int(d.max()),
                           "codes_frac_diff": frac, "scale_max_rel": srel,
                           "plan": plan_of(bottleneck_quant)}


def check_dq(codes, scales, w, label: str, out_dtype=None):
    """Kernel output against the plain version: bf16 within one bf16 ulp
    plus the f32 sums' rounding, f32 within that rounding alone
    (``TOL["dequant"]``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_matmul import dequant_matmul
    out_dtype = out_dtype or torch.bfloat16
    y = dequant_matmul(codes, scales, w, out_dtype=out_dtype).float()
    torch.cuda.synchronize()
    yr = ref.dequant_matmul_ref(codes, scales, w, out_dtype).float()
    mag = torch.maximum(y.abs(), yr.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    z = codes.float() * scales
    env = 2 * codes.shape[1] * 2.0 ** -24 * (z.abs() @ w.float().abs())
    err = (y - yr).abs()
    tol = ulp + env if out_dtype == torch.bfloat16 else env
    ratio = float((err / tol.clamp(min=1e-38)).max())
    check(ratio <= 1.0 and bool(torch.isfinite(y).all()),
          f"dequant_matmul {label} ({dtype_name(out_dtype)} out): error "
          f"{float(err.max())} beyond the tolerance (worst ratio "
          f"{ratio:.3f})")
    return {"case": f"{label} {tuple(codes.shape)} x {tuple(w.shape)} -> "
                    f"{dtype_name(out_dtype)}",
            "max_abs_err": float(err.max()),
            "outputs_beyond_one_ulp": int((err > ulp).sum()),
            "envelope_ratio": ratio, "plan": plan_of(dequant_matmul)}


def time_wire(inp, dev, iters: int):
    """Device ms of both kernels, their plain versions and, as a yardstick
    the port never calls, ``torch.matmul`` of the GEMM part alone (no
    PyTorch call computes either fused function), at one wire's 512 rows;
    with each call's bound and plan."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.bottleneck_quant import bottleneck_quant
    from repro_torch.kernels.dequant_matmul import dequant_matmul
    x, wd, wu = inp["x"], inp["down"], inp["up"]
    (M, K), N, D = x.shape, wd.shape[1], wu.shape[1]
    es, dt = x.element_size(), dtype_name(x.dtype)
    flush = l2_flusher(dev)
    codes, scales = bottleneck_quant(x, wd)
    z = (codes.float() * scales).to(wu.dtype)
    out = {}
    b_ms, b_by = bound(M * K * es + K * N * es + M * N + M * 4,
                       2 * M * K * N, dt)
    out["bottleneck_quant"] = {
        "timed_shape": [M, K, N], "dtype": dt,
        "ms": time_ms(lambda: bottleneck_quant(x, wd), iters, flush),
        "plain_ms": time_ms(lambda: ref.bottleneck_quant_ref(x, wd),
                            iters, flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "matmul_ms": time_ms(lambda: torch.matmul(x, wd), iters, flush),
        "plan": plan_of(bottleneck_quant)}
    # the codes are exact in bf16, so one bf16 tensor-core pass over the
    # product is the least the card needs, whatever w's dtype
    b_ms, b_by = bound(M * N + M * 4 + N * D * wu.element_size() + M * D * 2,
                       2 * M * N * D, "bfloat16")
    out["dequant_matmul"] = {
        "timed_shape": [M, N, D], "dtype": dtype_name(wu.dtype),
        "ms": time_ms(lambda: dequant_matmul(codes, scales, wu), iters,
                      flush),
        "plain_ms": time_ms(lambda: ref.dequant_matmul_ref(codes, scales,
                                                           wu), iters, flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "matmul_ms": time_ms(lambda: torch.matmul(z, wu), iters, flush),
        "plan": plan_of(dequant_matmul)}
    return out


def narrow_cases(wire, dev, seed: int):
    """The cases beyond the wires' own shapes, on one bf16 wire: a depth
    not a multiple of 8 and rows off 16-byte alignment for each kernel
    (their narrow copies), an f32 output, and N 4096 (numpy-seeded w).
    Returns (bottleneck_quant records, dequant_matmul records)."""
    import numpy as np
    import torch
    from repro_torch.kernels.bottleneck_quant import bottleneck_quant
    from repro_torch.kernels.dequant_matmul import dequant_matmul
    x, wd, wu, lab = wire["x"], wire["down"], wire["up"], wire["label"]
    bq, dq = [], []
    codes, scales, row = check_bq(x, wd, 8, f"{lab}", zero_row=True)
    bq.append(row)
    dq.append(check_dq(codes, scales, wu, lab, out_dtype=torch.float32))
    dq.append(check_dq(codes, scales, off_alignment(wu),
                       f"{lab} w off 16-byte alignment"))
    check(not dequant_matmul.last_plan.vec_b,
          "dequant_matmul: a w off alignment took 16-byte copies")
    k = x.shape[1] - 5
    bq.append(check_bq(x[:, :k].contiguous(), wd[:k].contiguous(), 8,
                       f"{lab} K {k}", zero_row=True)[2])
    check(not bottleneck_quant.last_plan.vec_a,
          f"bottleneck_quant: K {k} took 16-byte copies of x")
    bq.append(check_bq(off_alignment(x), wd, 4,
                       f"{lab} x off 16-byte alignment", zero_row=False)[2])
    check(not bottleneck_quant.last_plan.vec_a,
          "bottleneck_quant: an x off alignment took 16-byte copies")
    n = wd.shape[1] - 4                      # codes rows of 2 (N) bytes
    codes, scales, row = check_bq(x, wd[:, :n].contiguous(), 8,
                                  f"{lab} N {n}", zero_row=True)
    bq.append(row)
    dq.append(check_dq(codes, scales, wu[:n].contiguous(), f"{lab} N {n}"))
    check(not dequant_matmul.last_plan.vec_a,
          f"dequant_matmul: codes of width {n} took 16-byte copies")
    rng = np.random.default_rng(seed + 800)
    w4k = torch.from_numpy((0.02 * rng.standard_normal(
        (x.shape[1], 4096))).astype(np.float32)).to(dev, x.dtype)
    bq.append(check_bq(x, w4k, 8, f"{lab} N 4096", zero_row=True)[2])
    return bq, dq


def phase_wire(cap, rcap, cfg, rcfg, dev, seed: int, iters: int):
    """Both wire kernels against their plain versions at both full-width
    wires (bf16, the banks' own weights; 512, 37 and 1 rows) and at the
    bench's f32 shape, for bits 8, 4 and 1, plus ``narrow_cases``; each
    one device kernel a call; then their times at 512 rows. Returns one
    kernel-line record for each, headed by the bench shape (the path that
    runs them)."""
    from repro_torch.kernels.bottleneck_quant import bottleneck_quant
    from repro_torch.kernels.dequant_matmul import dequant_matmul
    wires = [bench_inputs(dev), wire_inputs(cap, cfg, dev, seed),
             wire_inputs(rcap, rcfg, dev, seed)]
    bq_rows, dq_rows = [], []
    for inp in wires:
        for m in ((512,) if inp is wires[0] else (512, 37, 1)):
            x = inp["x"][:m].contiguous()
            for bits in (8, 4, 1):
                codes, scales, row = check_bq(x, inp["down"], bits,
                                              inp["label"], zero_row=m > 1)
                bq_rows.append(row)
                dq_rows.append(check_dq(codes, scales, inp["up"],
                                        f"{inp['label']} bits {bits}"))
    bq, dq = narrow_cases(wires[2], dev, seed)
    bq_rows += bq
    dq_rows += dq
    kernels = {}
    for inp in wires:
        codes, scales = bottleneck_quant(inp["x"], inp["down"])
        kernels[inp["label"]] = {
            "bottleneck_quant": graph_nodes(
                lambda: bottleneck_quant(inp["x"], inp["down"])),
            "dequant_matmul": graph_nodes(
                lambda: dequant_matmul(codes, scales, inp["up"]))}
        for name, n in kernels[inp["label"]].items():
            check(n == 1, f"{name} {inp['label']}: one call issues {n} "
                          f"device kernels, not 1")
    timed = [time_wire(inp, dev, iters) for inp in wires]
    recs = []
    for name, rows, err in (
            ("bottleneck_quant", bq_rows,
             max(r["codes_max_diff"] for r in bq_rows)),
            ("dequant_matmul", dq_rows,
             max(r["max_abs_err"] for r in dq_rows))):
        head = timed[0][name]
        out = {"phase": "kernel", "name": name,
               "tolerance": (f"codes |diff| <= 1 on < {TOL['codes_frac']:.0%}"
                             f" of lanes, scales rtol {TOL['scale_rtol']}, "
                             f"zero row exact" if name == "bottleneck_quant"
                             else TOL["dequant"]),
               "cases": rows, "max_abs_err": err, **head,
               "device_kernels_a_call": {k: v[name]
                                         for k, v in kernels.items()},
               "library_ms": None,
               "yardstick": "torch.matmul of the GEMM part alone "
                            "(matmul_ms), never called by the port",
               "wires": {inp["label"]: t[name]
                         for inp, t in zip(wires[1:], timed[1:])}}
        emit(out)
        recs.append(out)
    return recs


# ---------------------------------------------------------------------------
# the dense archs: stablelm-3b, granite-8b, internlm2-20b
# ---------------------------------------------------------------------------

DENSE = ("stablelm-3b", "granite-8b", "internlm2-20b")
# the frontend archs of phase 14: multi-codebook audio and a vision prefix,
# both homogeneous full-attention stacks on the paged pool
FRONTENDS = ("musicgen-large", "llava-next-34b")
# the reduced stablelm-3b at the full model's proportion (head_dim 80 =
# d_model / n_heads); the reduced config keeps head_dim 80 too
HD80 = {"d_model": 160, "n_heads": 2, "n_kv_heads": 2, "head_dim": 80}
# the mixture-of-experts archs of phase 15: phi3.5-moe (full attention,
# the paged pool) and mixtral-8x7b (a 4096-token window, the dense pool)
PHI, MIXTRAL = "phi3.5-moe-42b-a6.6b", "mixtral-8x7b"
MOE = (PHI, MIXTRAL)
# the archs the continuous engine serves from the paged pool
PAGED = ("qwen2.5-3b", *DENSE, *FRONTENDS, PHI)


def free_cuda() -> None:
    """Return what the last phase freed to the card (a full-width model
    between phases)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def dense_boundary(cap, cfg, dev, seed: int, iters: int) -> dict:
    """The boundary at a dense arch's (d, W), on the model's bank and the
    synthetic heads: 4 rows of a decode tick, the 64-row prefill dispatch
    (4 prompts of 16 tokens) and 512 rows, each row bit-identical alone and
    in its pool, with the tile the plan picked; device ms at the tick and
    the dispatch on the model's bank; f32 rows, the reduced configs' type,
    where their plan fits, and where no tile fits the call raises."""
    import torch
    from repro_torch.kernels.boundary_mixed import (boundary_mixed_grouped,
                                                    boundary_plan)
    d, wmax = cfg.d_model, cfg.split.d_bottleneck
    bank = test_bank(cap["stacked"], d, dev, seed)
    M = bank["width"].shape[0]
    x4 = pick_rows(cap["x_enc"], cap["valid"], 4, seed + 4)
    cases = [("bf16 decode 4 rows", bank, x4,
              torch.tensor([1, 1, 0, 1], device=dev)),
             ("bf16 prefill 4 x 16", bank,
              cap["x_enc"][:4, :16].contiguous(),
              torch.tensor([1, 0, M, 2], device=dev)),
             ("bf16 prefill 8 x 64", bank, cap["x_enc"][:, :64].contiguous(),
              (torch.arange(8) % (M + 1)).to(dev))]
    f32 = {k: (v.float() if v.is_floating_point() else v)
           for k, v in cap["stacked"].items()}
    try:
        boundary_plan(4, d, wmax, torch.float32)
        cases.append(("f32 decode 4 rows", f32, x4.float(),
                      torch.tensor([1, 1, 0, 1], device=dev)))
    except ValueError:
        raised = False
        try:
            boundary_mixed_grouped(x4.float().reshape(4, d), torch.tensor(
                [1, 1, 0, 1], dtype=torch.int32, device=dev), 1, f32,
                dtype=torch.float32)
        except ValueError:
            raised = True
        check(raised, f"boundary {cfg.name}: f32 rows on a {wmax}-lane bank "
                      f"(no tile fits) did not raise")
    rows = []
    for label, b, x, modes in cases:
        e, r, plan = check_boundary(b, x, modes, f"{cfg.name} {label}")
        rows.append({"case": label, "rows": x.shape[0] * x.shape[1],
                     "max_abs_err": e, "envelope_ratio": r, "mt": plan["mt"],
                     "smem": plan["smem"]})
    want = boundary_plan(64, d, wmax, torch.bfloat16)[0]
    check(rows[1]["mt"] == want,
          f"boundary {cfg.name}: the prefill dispatch ran mt {rows[1]['mt']}, "
          f"the plan says {want}")
    del f32
    return {"cases": rows, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "decode": time_boundary(cap, d, dev, seed, iters),
            "prefill": time_boundary(cap, d, dev, seed, iters, seq=16)}


def dense_tail(cap, cfg, dev, seed: int, iters: int) -> dict:
    """The tail at a dense arch's head (stablelm-3b: a layernorm with a
    bias, untied [2560, 50304]; granite-8b: tied [49152, 4096], read in
    place; internlm2-20b: untied [6144, 92544]): tokens against the plain
    logits at 1, 4, 8 and 13 rows, with the plan of each call; an injected
    exact tie; the device ms, kernels and bound at the main path's 4 rows.
    The model's norm is perturbed (init makes ones and zeros)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.boundary_mixed import decode_tail_grouped
    params = cap["params"]
    tied = cfg.tie_embeddings
    head = (params["embed"]["table"] if tied else params["lm_head"]["w"])[None]
    V = head.shape[1] if tied else head.shape[2]
    d = cfg.d_model
    fn = params["final_norm"]
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    scale = (fn["scale"].float() + 0.1 * torch.randn(
        fn["scale"].shape, generator=gen, device=dev)).to(head.dtype)
    kw = {"tied": tied, "norm_kind": cfg.norm}
    if cfg.norm == "layernorm":
        kw["bias"] = (fn["bias"].float() + 0.1 * torch.randn(
            fn["bias"].shape, generator=gen, device=dev)).to(head.dtype)
    bias = kw.get("bias")
    rows = []
    for n in (1, 4, 8, 13):
        x = pick_rows(cap["x_dec"], cap["valid"], n, seed + 900 + n)
        diff, gap = check_tail(x, scale, head, f"{cfg.name} bf16 pool {n}",
                               **kw)
        rows.append({"case": f"bfloat16 pool {n}", "tokens_differing": diff,
                     "max_abs_err": gap,
                     "plan": dict(decode_tail_grouped.last_plan)})
    x = pick_rows(cap["x_dec"], cap["valid"], 8, seed + 950)
    top = int(ref.decode_tail_ref(x, scale, bias, head, tied=tied,
                                  norm_kind=cfg.norm)[0, 0])
    low = 5 if top > 5 else top
    tie = head.clone()
    if tied:
        tie[0, low] = head[0, top]
        tie[0, (top + V // 2) % V] = head[0, top]
    else:
        tie[0, :, low] = head[0, :, top]
        tie[0, :, (top + V // 2) % V] = head[0, :, top]
    check_tail(x, scale, tie, f"{cfg.name} exact tie", expect=low, **kw)
    rows.append({"case": "bfloat16 exact tie", "expected": low})
    del tie
    x4 = pick_rows(cap["x_dec"], cap["valid"], 4, seed + 960)
    parts = {}
    ms = time_ms(lambda: decode_tail_grouped(
        x4[:, 0], head, scale, bias, block_r=16, tied=tied,
        norm_kind=cfg.norm), iters, by_kernel=parts)
    plan = dict(decode_tail_grouped.last_plan)
    kernels = tail_kernels(x4, scale, head, **kw)
    plain = time_ms(lambda: ref.decode_tail_ref(x4, scale, bias, head,
                                                tied=tied,
                                                norm_kind=cfg.norm),
                    max(iters // 5, 3))
    n_vec = 3 if bias is not None else 2
    b_ms, b_by = bound(2 * (V * d + 4 * d + n_vec * d) + 4 * 4,
                       2 * 4 * d * V, "bfloat16")
    return {"cases": rows,
            "max_abs_err": max(r.get("max_abs_err", 0.0) for r in rows),
            "timed_shape": {"rows": 4, "d": d, "V": V, "tied": tied,
                            "norm": cfg.norm},
            "plan": plan, "ms": ms, "ms_by_kernel": parts,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "bound_over_ms": b_ms / ms, "device_kernels_per_call": kernels,
            "library_ms": None}


def phase_dense_kernels(cfg, dev, seed: int, iters: int) -> dict:
    """One full-width dense arch: capture its prefill (about 40 GB of
    weights for internlm2-20b, so one arch at a time, freed after), then
    the boundary, paged attention (its head_dim and GQA group: stablelm-3b
    80 and 1, granite-8b 128 and 4, internlm2-20b 128 and 6) and the tail
    at its shapes. Emits one line and returns it."""
    t0 = time.perf_counter()
    cap = capture(cfg, dev, seed)
    emit({"phase": "capture", "arch": cfg.name,
          "seconds": time.perf_counter() - t0,
          "lengths": [int(n) for n in cap["lens"]]})
    out = {"phase": "kernels_at_arch", "arch": cfg.name,
           "head_dim": cfg.head_dim, "gqa_group": cfg.n_heads // cfg.n_kv_heads,
           "boundary_mixed_grouped": dense_boundary(cap, cfg, dev, seed,
                                                    iters),
           "decode_tail_grouped": dense_tail(cap, cfg, dev, seed, iters)}
    # f32 (the reduced configs' type) at the decode shape; at the long
    # shape qwen2.5-3b's phase holds it
    paged = phase_paged(cap, cfg, dev, seed, iters, f32_long=False)
    out["paged_attention"] = {k: paged[k] for k in (
        "timed_shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "long", "max_abs_err")}
    del cap
    free_cuda()
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the serving entry point
# ---------------------------------------------------------------------------

SERVE_COMMON = ["--engine", "continuous", "--requests", "8", "--prompt-len",
                "16", "--gen", "16", "--n-slots", "4"]
SERVE = {"qwen2.5-3b": ["--arch", "qwen2.5-3b", *SERVE_COMMON],
         "recurrentgemma-2b": ["--arch", "recurrentgemma-2b", *SERVE_COMMON,
                               "--cache-len", "2048"],
         "xlstm-125m": ["--arch", "xlstm-125m", *SERVE_COMMON],
         **{a: ["--arch", a, *SERVE_COMMON] for a in DENSE + FRONTENDS + MOE}}


@contextlib.contextmanager
def serve_engine(cls=None, **kw):
    """``launch.serve``'s continuous engine is ``cls`` (default the
    engine's own class) built with ``kw`` (``fused_tail=False``) while the
    block runs."""
    import functools

    from repro_torch.launch import serve
    orig = serve.ContinuousBatchingEngine
    serve.ContinuousBatchingEngine = functools.partial(cls or orig, **kw)
    try:
        yield
    finally:
        serve.ContinuousBatchingEngine = orig


#: the launcher's name of each engine's class
ENGINE_CLASS = {"continuous": "ContinuousBatchingEngine",
                "sync": "ServingEngine"}


@contextlib.contextmanager
def keeping(engine: str, kept: dict):
    """Each ``engine`` engine the launcher builds while the block runs is
    kept in ``kept["engine"]`` (the profile phase runs on it again)."""
    from repro_torch.launch import serve
    name = ENGINE_CLASS[engine]
    orig = getattr(serve, name)

    def build(*a, **kw):
        kept["engine"] = orig(*a, **kw)
        return kept["engine"]

    setattr(serve, name, build)
    try:
        yield kept
    finally:
        setattr(serve, name, orig)


@contextlib.contextmanager
def reusing(engine: str, eng):
    """The launcher builds no ``engine`` engine while the block runs: it
    gets ``eng`` back, its counters zeroed (continuous; its warm-up then
    replays the graphs it captured) or its state reset and the run's
    orchestrator given to it (sync)."""
    from repro_torch.launch import serve
    name = ENGINE_CLASS[engine]
    orig = getattr(serve, name)

    def again(*a, **kw):
        if engine == "sync":
            eng.reset()
            eng.orch = kw.get("orchestrator")
        else:
            eng.reset_counters()
        return eng

    setattr(serve, name, again)
    try:
        yield eng
    finally:
        setattr(serve, name, orig)


def bank_free(params) -> dict:
    """A view of ``params`` without the bottleneck bank: a new top-level
    dict sharing every tensor (the engines then run the bank-free
    steps)."""
    return {k: v for k, v in params.items() if k != "bneck_modes"}


def serve_run(argv: list, cfg=None, params=None) -> dict:
    """``launch.serve.main(argv)``; with ``params``, the engine's own
    runner (``run_continuous`` / ``run_sync``) on ``cfg`` (a config cut in
    depth, which no flag of the launcher gives) and those weights, as
    ``main`` calls it."""
    from repro_torch.launch import serve
    if params is None:
        return serve.main(argv)
    args = serve.parser().parse_args(argv)
    run = {"continuous": serve.run_continuous,
           "sync": serve.run_sync}[args.engine]
    return {"arch": args.arch, **run(args, cfg, params)}


@contextlib.contextmanager
def near_ties(sink: list):
    """Count, while the block runs, the routing decisions of
    ``models.moe.route`` (one a token and layer) and those among them
    whose k-th and (k+1)-th router probabilities differ by less than
    ``TOL["moe_near_tie"]`` (exact ties resolve to the lowest index on
    both sides and are not counted): ``sink`` gets (decisions, near
    ties) a call."""
    import torch
    from repro_torch.models import moe
    orig = moe.route

    def rec(router_w, xg, k, capacity):
        out = orig(router_w, xg, k, capacity)
        top = torch.topk(out[0], k + 1, dim=-1).values
        gap = top[..., k - 1] - top[..., k]
        sink.append((gap.numel(), int(((gap > 0) & (
            gap < TOL["moe_near_tie"])).sum())))
        return out

    moe.route = rec
    try:
        yield sink
    finally:
        moe.route = orig


def check_near_ties(ties: list, equal: bool, label: str) -> dict:
    """The near-tie rule of an MoE run against its reference: tokens may
    part only where the reference saw a near tie, and near ties are at most
    ``TOL["moe_near_tie_share"]`` of its routing decisions."""
    decisions = sum(n for n, _ in ties)
    near = sum(t for _, t in ties)
    check(near <= TOL["moe_near_tie_share"] * max(decisions, 1),
          f"{label}: {near} near-tied routing decisions of {decisions}")
    check(equal or near > 0,
          f"{label}: tokens differ on the card with no near-tied routing "
          f"decision in the reference")
    return {"routing_decisions": decisions, "near_ties": near}


def phase_reference(arch: str, device: str = "cuda", variant=None,
                    forms: bool = False):
    """The serving entry point at reduced shapes in f32 on the card and on
    the CPU, on the same weights (drawn on the CPU and copied, since the
    two devices' generators draw different numbers). With every request on
    mode 0 (a fast uplink) nothing is quantized, so the tokens must be
    equal: f32 sums in two orders leave argmax ties far apart. With mixed
    modes (a slow uplink) the modes and wire bytes must be equal; the
    tokens may part where a code of the 8-bit wire sits on a rounding edge
    and the two sides' sums round it differently, so their agreement is
    reported, not required. ``variant``: config fields replaced in the
    reduced config (``HD80``). ``forms``: also the bank-free engine and
    the unfused tail (``fused_tail=False``), each on the fast uplink and
    held like mode 0."""
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.core import split as SP
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32",
                              **(variant or {}))
    cpu = SP.init_split_params(torch.Generator().manual_seed(0), cfg)
    gpu = T.tree_map(lambda t: t.to(device), cpu)
    out = {"phase": "reference", "arch": arch, "head_dim": cfg.head_dim,
           "d_model": cfg.d_model}
    runs = [("mode0", "1000", {}, False), ("mixed", "1", {}, False)]
    if forms:
        runs += [("bank-free", "1000", {}, True),
                 ("unfused", "1000", {"fused_tail": False}, False)]
    for label, mbps, kw, no_bank in runs:
        args = SERVE[arch] + ["--reduced", "--mean-mbps", mbps, "--device"]
        on = (bank_free(gpu), bank_free(cpu)) if no_bank else (gpu, cpu)
        ties: list = []
        with serve_engine(**kw):
            got = serve.run_continuous(
                serve.parser().parse_args(args + [device]), cfg, on[0])
            with near_ties(ties):
                want = serve.run_continuous(
                    serve.parser().parse_args(args + ["cpu"]), cfg, on[1])
        for k in ("mode_counts", "wire_bytes", "decode_ticks"):
            check(got[k] == want[k], f"reduced f32 {label}: {k} differs")
        toks = [(got["tokens"][r], want["tokens"][r]) for r in want["tokens"]]
        same = sum(a == b for a, b in toks)
        first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      None) for a, b in toks]
        out[label] = {"mode_counts": got["mode_counts"],
                      "wire_bytes": got["wire_bytes"],
                      "requests_with_equal_tokens": same,
                      "requests": len(toks), "first_differing_index": first}
        if label != "mixed":
            check(set(got["mode_counts"]) == {0},
                  f"reduced f32 {label}: modes {got['mode_counts']}")
            if cfg.is_moe:
                out[label].update(check_near_ties(
                    ties, same == len(toks), f"reduced f32 {label}"))
            else:
                check(same == len(toks),
                      f"reduced f32 {label}: {len(toks) - same} requests "
                      f"decode other tokens on the card (first differing "
                      f"index {first})")
    emit(out)


def kernel_fns():
    from repro_torch.kernels.boundary_mixed import (boundary_mixed_grouped,
                                                    decode_tail_grouped)
    from repro_torch.kernels.bottleneck_quant import bottleneck_quant
    from repro_torch.kernels.dequant_matmul import dequant_matmul
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    return {"boundary_mixed_grouped": boundary_mixed_grouped,
            "decode_tail_grouped": decode_tail_grouped,
            "paged_attention": paged_attention,
            "rglru_scan": rglru_scan,
            "bottleneck_quant": bottleneck_quant,
            "dequant_matmul": dequant_matmul}


def zero_counts() -> dict:
    """Set every kernel's launch counter to 0; returns the wrappers."""
    fns = kernel_fns()
    for f in fns.values():
        f.launches = 0
    return fns


@contextlib.contextmanager
def counting(module, name: str, counts: dict):
    """Count the calls of ``module.name`` while the block runs."""
    orig = getattr(module, name)

    def counted(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return orig(*args, **kw)

    setattr(module, name, counted)
    try:
        yield counts
    finally:
        setattr(module, name, orig)


def check_f32_forms(calls: dict, kinds: list, label: str) -> None:
    """The engine made each RG-LRU and sLSTM layer's float32 forms once,
    when it prepared its parameters, and no step made them again."""
    for kind, fn in (("rglru", "_f32_forms"), ("slstm", "_slstm_f32_forms")):
        n = kinds.count(kind)
        made = calls.get(fn, 0)
        check(made == n, f"{label}: the {kind} float32 forms were made "
                         f"{made} times for {n} {kind} layers (a step made "
                         f"them)")


def scan_layers(kinds: list) -> int:
    """Layers whose prefill launches the scan: RG-LRU, and mLSTM (its
    normalizer)."""
    return kinds.count("rglru") + kinds.count("mlstm")


@contextlib.contextmanager
def counting_f32_forms(calls: dict):
    """Count the float32 forms the RG-LRU and sLSTM layers make."""
    from repro_torch.models import rglru as RG
    from repro_torch.models import xlstm as XL
    with counting(RG, "_f32_forms", calls), \
            counting(XL, "_slstm_f32_forms", calls):
        yield calls


@contextlib.contextmanager
def graph_tally(calls: dict):
    """The step graphs' tallies (``StepGraphs.totals``) at 0 while the
    block runs; ``calls`` then gets them under ``graphs``."""
    from repro_torch.serving.graphs import StepGraphs
    StepGraphs.reset_totals()
    try:
        yield calls
    finally:
        calls["graphs"] = dict(StepGraphs.totals)


def graphed_steps(calls: dict, *fns: str) -> int:
    """The decode ticks (sync: token steps) a path ran: the step
    functions' calls less those made while a graph was captured (which
    ran nothing) plus the steps the graphs replayed (which call nothing);
    ``calls`` as ``graph_tally`` left it."""
    g = calls["graphs"]
    return (sum(calls.get(f, 0) for f in fns) - g["captured_steps"]
            + g["replayed_steps"])


def check_graphed(calls: dict, label: str, *fns: str) -> None:
    """A one-device path's decode steps all went through graphs: some
    replayed, and the step functions were called only at each graph's
    first use (its warm-up, the key's own work) and its capture."""
    g = calls["graphs"]
    n = sum(calls.get(f, 0) for f in fns)
    check(g["replays"] > 0 and g["eager_steps"] == g["captured_steps"]
          and n == g["eager_steps"] + g["captured_steps"],
          f"{label}: {n} eager decode-step calls against the graphs' "
          f"tallies {g} (a step ran eagerly after its capture, or no graph "
          f"replayed)")


@contextlib.contextmanager
def engine_ticks(calls: dict):
    """The decode ticks every continuous engine counted before each
    ``reset_counters`` (a warm-up's) while the block runs, summed into
    ``calls["engine_ticks"]``; a run's own ticks stay in its stats."""
    from repro_torch.serving import ContinuousBatchingEngine as E
    orig = E.reset_counters
    calls.setdefault("engine_ticks", 0)

    def reset(self):
        calls["engine_ticks"] += self.decode_ticks
        return orig(self)

    E.reset_counters = reset
    try:
        yield calls
    finally:
        E.reset_counters = orig


#: the archs whose one-device continuous main path is held bit for bit
#: against the same arguments' host loop (``host_loop=True``: eager ticks,
#: logits and argmax read every tick), the reference's equivalence oracle
HOST_LOOP_ORACLE = ("qwen2.5-3b", "recurrentgemma-2b", "xlstm-125m",
                    "musicgen-large", PHI)


def host_loop_oracle(argv: list, cfg, label: str, tokens: dict,
                     params) -> dict:
    """``serve_run(argv, cfg, params)`` on the host loop (the launcher's
    runner on the graphed run's weights): its tokens must equal
    ``tokens`` (the graphed run's, by request) bit for bit."""
    with serve_engine(host_loop=True):
        want = serve_run(argv, cfg, params)["tokens"]
    diff = first_difference(tokens, want)
    check(len(want) == len(tokens) and diff is None,
          f"{label}: the graphed window's tokens differ from the host "
          f"loop's at (request, token index) {diff}")
    out = {"phase": "host_loop_oracle", "arch": cfg.name, "path": label,
           "requests": len(want), "requests_equal": len(want)}
    emit(out)
    return out


def tails_per_step(cfg) -> int:
    """Decode tails a decode step launches: one, or none for the
    multi-codebook audio heads, which keep the norm / logits / argmax
    chain (as the reference does)."""
    return 0 if cfg.frontend == "audio" and cfg.n_codebooks > 1 else 1


def phase_main_path(cfg, smi: str, params=None, kept=None):
    """The arch's serving entry point at full width with every launch
    counter at 0 just before and read just after, prefill dispatches and
    decode ticks counted beside them (warm-up included); with ``params``,
    its runner on them and ``cfg`` (``serve_run``). Per decode tick
    the device loop launches one boundary, one tail (none for
    musicgen-large's codebook heads) and one paged attention per layer on
    the paged pool; per prefill dispatch one
    boundary and one scan per RG-LRU or mLSTM layer (none a tick: a
    decode step is one cell step). The RG-LRU and sLSTM layers' float32
    forms are made once, when the engine prepares its parameters, and
    never on a step. ``kept`` (a dict) gets the engine under
    ``engine``; the host-loop oracle runs on its weights."""
    from repro_torch.core import split as SP
    fns = zero_counts()
    calls: dict = {}
    argv = SERVE[cfg.name] + ["--device", "cuda"]
    kept = {} if kept is None else kept
    with counting(SP, "split_prefill_mixed", calls), \
            counting(SP, "split_decode_step_mixed", calls), \
            counting_f32_forms(calls), graph_tally(calls), \
            engine_ticks(calls), keeping("continuous", kept):
        summary = serve_run(argv, cfg, params)
    launches = {k: f.launches for k, f in fns.items()}
    prefills = calls.get("split_prefill_mixed", 0)
    ticks = graphed_steps(calls, "split_decode_step_mixed")
    check_graphed(calls, f"main path {cfg.name}", "split_decode_step_mixed")
    check(ticks == calls["engine_ticks"] + summary["decode_ticks"],
          f"main path {cfg.name}: {ticks} ticks by the graph tallies, "
          f"{calls['engine_ticks']} + {summary['decode_ticks']} by the "
          f"engine")
    toks = summary["tokens"]
    MAIN_RUNS[f"{cfg.name} continuous"] = toks
    check(summary["requests_finished"] == 8 and len(toks) == 8,
          f"main path: {summary['requests_finished']} of 8 requests finished")
    for rid, t in toks.items():
        check(len(t) == 16 and all(0 <= v < cfg.vocab_size for v in t),
              f"main path: request {rid} returned {len(t)} tokens")
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    check(summary["paged"] == (cfg.name in PAGED),
          f"main path {cfg.name}: paged pool {summary['paged']}")
    expect = {"boundary_mixed_grouped": ticks + prefills,
              "decode_tail_grouped": tails_per_step(cfg) * ticks,
              "paged_attention": (kinds.count("attn") * ticks
                                  if summary["paged"] else 0),
              "rglru_scan": scan_layers(kinds) * prefills,
              "bottleneck_quant": 0, "dequant_matmul": 0}
    for k, n in expect.items():
        if n:
            check(launches[k] > 0, f"main path: kernel {k} never launched")
    check(launches == expect,
          f"main path {cfg.name}: launches {launches} for {prefills} "
          f"prefill dispatches and {ticks} decode ticks, expected {expect}")
    check_f32_forms(calls, kinds, f"main path {cfg.name}")
    emit({"phase": "main_path", "engine": "continuous", "arch": cfg.name,
          "dtype": cfg.dtype, "n_layers": cfg.n_layers,
          "paged": summary["paged"],
          "requests_finished": summary["requests_finished"],
          "decode_tokens": summary["decode_tokens"],
          "decode_ticks": summary["decode_ticks"],
          "seconds": summary["seconds"],
          "decode_tok_per_s": summary["decode_tok_per_s"],
          "mode_counts": summary["mode_counts"], "launches": launches,
          "prefill_dispatches": prefills, "ticks_with_warm_up": ticks,
          "decode_step_calls": calls.get("split_decode_step_mixed", 0),
          "graphs": calls["graphs"],
          "rglru_f32_forms_made": calls.get("_f32_forms", 0),
          "slstm_f32_forms_made": calls.get("_slstm_f32_forms", 0),
          "card": smi})
    if cfg.name in HOST_LOOP_ORACLE:
        host_loop_oracle(argv, cfg, "continuous", toks,
                         kept["engine"].params)
    return launches


#: the dense (homogeneous) archs' profiles, cut in depth to fit the
#: script's time (PERF.md section 4): continuous at 4 of the main path's 8
#: requests and 4 of its 16 generated tokens, sync at 4 of 16; the recurrent
#: archs keep the main path's arguments, their launches a step are held
#: against a ceiling
PROFILE_CUT = {"continuous": ["--requests", "4", "--gen", "4"],
               "sync": ["--gen", "4"]}


def phase_profile(cfg, engine: str, eng):
    """The arch's main path on ``engine`` once more, on the engine the
    main path built (``eng``: its weights, its graphs captured), through
    the launcher's runner, traced with ``torch.profiler`` (its rate is not
    the one reported above): device busy time, idle share, device kernels
    and host launch calls per decode step and the kernels that take the
    time, summarized from the profiler's events (no Chrome trace is
    written: the script reads none, and writing a full-width trace took
    much of the phase's time). A sync run's launches per step include its
    one prefill's, a continuous run's its prefill dispatches'. ``graphed``
    splits out the graph replays (the spans ``profile_summary`` finds
    them by): their device kernels, busy time, span and host launch calls
    a replayed tick, and the rest a step; the trace must hold one span, at
    least one kernel and one graph launch for each replay the graphs
    counted."""
    from repro_torch.launch import serve
    from repro_torch.serving.graphs import StepGraphs
    argv = (SERVE if engine == "continuous" else SYNC)[cfg.name]
    if cfg.homogeneous:
        argv = argv + PROFILE_CUT[engine]
    args = serve.parser().parse_args(argv + [
        "--device", "cuda", "--profile-dir",
        str(ROOT / "build" / "profile" / engine / cfg.name)])
    export = serve.profile_extra
    serve.profile_extra = lambda args, prof, seconds: (
        {} if prof is None else {"profile": serve.profile_summary(prof,
                                                                  seconds)})
    run = {"continuous": serve.run_continuous, "sync": serve.run_sync}
    make = serve.make_profiler

    def traced(args, dev):           # the tallies count the traced run's
        StepGraphs.reset_totals()
        return make(args, dev)
    try:
        with reusing(engine, eng), patched(serve, "make_profiler", traced):
            summary = run[engine](args, cfg, eng.params)
    finally:
        serve.profile_extra = export
    prof = summary["profile"]
    steps = (summary["decode_ticks"] if engine == "continuous"
             else len(sync_rows(summary["generated"])[0]))
    per_step = prof["kernel_launches"] / max(steps, 1)
    host_calls = sum(prof["launch_calls"].values()) / max(steps, 1)
    # the graphs' part: each replayed tick's device kernels, busy time and
    # span (a replay's first kernel's start to its last kernel's end) and
    # the host's graph launches for it, and the rest of the run (prefills,
    # admission, warm-ups) a step: its kernels and eager launch calls
    g = prof["graph_replays"]
    tally = dict(StepGraphs.totals)
    replayed = max(tally["replayed_steps"], 1)
    calls = prof["launch_calls"]
    graph_calls = calls.get("cudaGraphLaunch", 0)
    graphed = {"replayed_ticks": tally["replayed_steps"],
               "replays": g["replays"],
               "kernels_per_tick": g["kernels"] / replayed,
               "busy_ms_per_tick": g["busy_s"] * 1e3 / replayed,
               "span_ms_per_tick": g["span_s"] * 1e3 / replayed,
               "idle_within_replays": 1.0 - g["busy_s"] / max(g["span_s"],
                                                              1e-12),
               "graph_launches_per_tick": graph_calls / replayed,
               "kernels_outside_per_step":
                   (prof["kernel_launches"] - g["kernels"]) / max(steps, 1),
               "launch_calls_outside_per_step":
                   (sum(calls.values()) - graph_calls) / max(steps, 1)}
    check(g["replays"] == tally["replays"] > 0 and g["kernels"] > 0,
          f"profile {engine} {cfg.name}: the trace holds the kernels of "
          f"{g['replays']} graph launches ({g['kernels']} kernels), "
          f"against {tally['replays']} graph replays")
    n_rglru = sum(cfg.block_kind(i) == "rglru" for i in range(cfg.n_layers))
    ceiling = None
    if n_rglru and prof["kernel_launches"]:
        ceiling = UNCACHED_LAUNCHES[engine] - CACHED_A_LAYER * n_rglru
        check(per_step <= ceiling,
              f"profile {engine} {cfg.name}: {per_step:.1f} device launches "
              f"a decode step, above {ceiling} (the per-step RG-LRU float32 "
              f"casts are back)")
    emit({"phase": "profile", "engine": engine, "arch": cfg.name,
          "n_layers": cfg.n_layers, "decode_steps": steps,
          "device_traced": prof["kernel_launches"] > 0,
          "launches_per_decode_step": per_step,
          "host_launch_calls_per_decode_step": host_calls,
          "graphed": graphed,
          "launches_ceiling": ceiling,
          "to_copy_ms_per_decode_step": prof["to_copy"]["device_ms"]
          / max(steps, 1), **prof})


def phase_profile_summary():
    """``serve.profile_summary``, which reads the profiler's raw events,
    against the ``FunctionEvent`` tree of the same trace (``prof.events()``
    and ``key_averages``, which it replaced: their parse took most of each
    profile phase at full width), on the continuous engine at reduced f32
    qwen2.5-3b on the card: the same kernels, device busy time and casts,
    the casts' device ms within 1e-4 relative (a cast nested in a cast
    counts twice in ``key_averages``), and the graph replays' kernels
    (the run's windows replay graphs; a replayed kernel carries its graph
    launch's id): the same replays and kernels, their busy time within
    1e-9 relative. Both summaries' host seconds are printed."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_reduced
    from repro_torch.core import split as SP
    from repro_torch.launch import serve
    cfg = dataclasses.replace(get_reduced("qwen2.5-3b"), dtype="float32")
    params = SP.init_split_params(torch.Generator(device="cuda").manual_seed(
        0), cfg)
    args = serve.parser().parse_args(SERVE[cfg.name] + ["--device", "cuda"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve.run_continuous(args, cfg, params)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = serve.profile_summary(prof, 1.0)
    t1 = time.perf_counter()
    events = prof.events()
    dev = [e for e in events if e.device_type.name == "CUDA"]
    launches = {e.id for e in events if e.name == "cudaGraphLaunch"}
    replayed = [e for e in dev if e.id in launches]
    casts = [e for e in prof.key_averages() if e.key == "aten::_to_copy"]
    t2 = time.perf_counter()
    want = {"kernel_launches": len(dev),
            "device_busy_s": sum(e.time_range.elapsed_us() for e in dev) / 1e6,
            "calls": sum(e.count for e in casts),
            "device_ms": sum(e.device_time_total for e in casts) / 1e3,
            "replays": len({e.id for e in replayed}),
            "replayed_kernels": len(replayed),
            "replayed_busy_s": sum(e.time_range.elapsed_us()
                                   for e in replayed) / 1e6}
    reps = got["graph_replays"]
    check(got["kernel_launches"] == want["kernel_launches"] > 0
          and math.isclose(got["device_busy_s"], want["device_busy_s"],
                           rel_tol=1e-9)
          and got["to_copy"]["calls"] == want["calls"]
          and math.isclose(got["to_copy"]["device_ms"], want["device_ms"],
                           rel_tol=1e-4)
          and reps["replays"] == want["replays"] > 0
          and reps["kernels"] == want["replayed_kernels"] > 0
          and math.isclose(reps["busy_s"], want["replayed_busy_s"],
                           rel_tol=1e-9),
          f"profile summary: {got} against the event tree's {want}")
    emit({"phase": "profile_summary", "raw_events_s": t1 - t0,
          "event_tree_s": t2 - t1, "summary": {
              k: got[k] for k in ("kernel_launches", "device_busy_s",
                                  "to_copy", "graph_replays")},
          "event_tree": want})


# ---------------------------------------------------------------------------
# the synchronous engine and the kernel bench
# ---------------------------------------------------------------------------

SYNC_COMMON = ["--engine", "sync", "--policy", "orchestrator", "--requests",
               "8", "--prompt-len", "16", "--gen", "16"]
SYNC = {"qwen2.5-3b": ["--arch", "qwen2.5-3b", *SYNC_COMMON],
        "recurrentgemma-2b": ["--arch", "recurrentgemma-2b", *SYNC_COMMON,
                              "--cache-len", "2048"],
        "xlstm-125m": ["--arch", "xlstm-125m", *SYNC_COMMON],
        **{a: ["--arch", a, *SYNC_COMMON] for a in DENSE + FRONTENDS + MOE}}


def phase_sync_reference(arch: str, device: str = "cuda"):
    """The sync engine at reduced shapes in f32 on the card and on the CPU,
    on the same weights, under the orchestrator and on the quantized mode
    1 (``static1``): the same tokens, wire bytes and mode counts."""
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.core import split as SP
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    cpu = SP.init_split_params(torch.Generator().manual_seed(0), cfg)
    gpu = T.tree_map(lambda t: t.to(device), cpu)
    out = {"phase": "sync_reference", "arch": arch}
    for policy in ("orchestrator", "static1"):
        argv = SYNC[arch] + ["--reduced", "--policy", policy, "--device"]
        ties: list = []
        got = serve.run_sync(serve.parser().parse_args(argv + [device]), cfg,
                             gpu)
        with near_ties(ties):
            want = serve.run_sync(serve.parser().parse_args(argv + ["cpu"]),
                                  cfg, cpu)
        for k in ("mode_counts", "wire_bytes", "tokens"):
            check(got[k] == want[k], f"sync reduced f32 {policy}: {k} "
                                     f"{got[k]} on the card, {want[k]} on "
                                     f"the CPU")
        same = [a == b for a, b in zip(got["generated"], want["generated"])]
        first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      None)
                 for a, b in zip(got["generated"], want["generated"])]
        out[policy] = {"mode_counts": got["mode_counts"],
                       "wire_bytes": got["wire_bytes"],
                       "rows_with_equal_tokens": sum(same)}
        if cfg.is_moe:
            out[policy].update(check_near_ties(
                ties, all(same), f"sync reduced f32 {policy}"))
        else:
            check(all(same), f"sync reduced f32 {policy}: rows decode other "
                             f"tokens on the card (first differing index "
                             f"{first})")
    emit(out)


def sync_rows(generated) -> list:
    """The sync engine's generated tokens as rows of tokens: [B, n] as
    given, [B, K, n] (audio) as B * K rows."""
    import numpy as np
    a = np.asarray(generated)
    return a.reshape(-1, a.shape[-1]).tolist()


def phase_sync_main_path(cfg, smi: str, params=None, kept=None):
    """The sync engine through ``serve.main`` at full width (with
    ``params``: its runner on them and ``cfg``), every launch counter at
    0 just before and read just after, prefills and decode steps counted
    beside them. Per decode step (the orchestrator's, which
    ends in the fused tail) one decode tail (none for musicgen-large's
    codebook heads); per prefill one scan per
    RG-LRU or mLSTM layer; no boundary, paged attention or wire kernel."""
    from repro_torch.core import split as SP
    from repro_torch.models import transformer as T
    fns = zero_counts()
    calls: dict = {}
    with counting(T, "prefill", calls), \
            counting(SP, "split_decode_step", calls), \
            counting(T, "decode_step", calls), \
            counting_f32_forms(calls), graph_tally(calls), \
            keeping("sync", {} if kept is None else kept):
        summary = serve_run(SYNC[cfg.name] + ["--device", "cuda"], cfg,
                            params)
    launches = {k: f.launches for k, f in fns.items()}
    prefills = calls.get("prefill", 0)
    step_fns = ("split_decode_step", "decode_step")
    steps = graphed_steps(calls, *step_fns)
    check_graphed(calls, f"sync main path {cfg.name}", *step_fns)
    gen = sync_rows(summary["generated"])
    MAIN_RUNS[f"{cfg.name} sync"] = summary["generated"]
    check(summary["tokens"] == len(gen) * 16 and len(gen) == 8 * (
              cfg.n_codebooks if tails_per_step(cfg) == 0 else 1)
          and all(len(r) == 16 and all(0 <= v < cfg.vocab_size for v in r)
                  for r in gen),
          f"sync main path {cfg.name}: {summary['tokens']} tokens")
    check(prefills == 1 and steps == 16
          and sum(summary["mode_counts"].values()) == 16,
          f"sync main path {cfg.name}: {prefills} prefills, {steps} steps")
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    expect = {k: 0 for k in fns}
    expect["decode_tail_grouped"] = tails_per_step(cfg) * steps
    expect["rglru_scan"] = scan_layers(kinds) * prefills
    for k, n in expect.items():
        if n:
            check(launches[k] > 0, f"sync main path: kernel {k} never "
                                   f"launched")
    check(launches == expect,
          f"sync main path {cfg.name}: launches {launches} for {prefills} "
          f"prefills and {steps} decode steps, expected {expect}")
    check_f32_forms(calls, kinds, f"sync main path {cfg.name}")
    emit({"phase": "main_path", "engine": "sync", "arch": cfg.name,
          "dtype": cfg.dtype, "n_layers": cfg.n_layers,
          "prefill_s": summary["prefill_s"],
          "decode_tok_per_s": summary["decode_tok_per_s"],
          "tokens": summary["tokens"], "mode_counts": summary["mode_counts"],
          "wire_bytes_per_token": summary["wire_bytes_per_token"],
          "launches": launches, "prefills": prefills, "decode_steps": steps,
          "decode_step_calls": sum(calls.get(f, 0) for f in step_fns),
          "graphs": calls["graphs"],
          "rglru_f32_forms_made": calls.get("_f32_forms", 0),
          "slstm_f32_forms_made": calls.get("_slstm_f32_forms", 0),
          "card": smi})
    return launches


def phase_bench():
    """``repro_torch.benchmarks.bench_kernels.main`` on the card, counters
    at 0 just before: its two parity checks must hold, both wire kernels
    must launch, and the fused tick must beat the unfused chain by
    ``MEGA_FLOOR`` (its timings are host-clock best-of, launches included;
    the kernel phases above give device times)."""
    from repro_torch.benchmarks import bench_kernels
    fns = zero_counts()
    try:
        out = bench_kernels.main(["--device", "cuda"])
    except AssertionError as e:
        raise SmokeFailure(f"bench: {e}") from e
    launches = {k: f.launches for k, f in fns.items()}
    for k in ("bottleneck_quant", "dequant_matmul"):
        check(launches[k] > 0, f"bench: kernel {k} never launched")
    check(out["mega_parity_ok"] and out["mega_speedup"] >= MEGA_FLOOR,
          f"bench: the fused tick's speedup {out['mega_speedup']:.3f} over "
          f"the unfused chain is below {MEGA_FLOOR} (parity "
          f"{out['mega_parity_ok']})")
    emit({"phase": "bench", **out, "launches": launches})
    return launches


def phase_loop_speedup(dev, seed: int, smi: str) -> dict:
    """The serving bench's device-loop against host-loop comparison
    (``bench_serving.compare_engine_loops``) at its own arguments
    (``LOOP_BENCH``) on full-width qwen2.5-3b: its two engines warmed, four
    interleaved runs each, the best rate of each. The device loop, whose
    windows replay graphs, must decode at least ``MIN_LOOP_SPEEDUP`` times
    the host loop's rate (the reference bench gate). Timed on the host
    clock, so it runs before the lanes share the card and the host.
    Returns the launches."""
    import torch

    from repro_torch.benchmarks import bench_serving
    from repro_torch.configs import get_config
    from repro_torch.core import split as SP
    cfg = get_config("qwen2.5-3b")
    params = SP.init_split_params(
        torch.Generator(device=dev).manual_seed(seed), cfg)
    calls: dict = {}
    t0 = time.perf_counter()
    with counted_path(calls):
        ec = bench_serving.compare_engine_loops(params, cfg, **LOOP_BENCH)
    del params
    free_cuda()
    check(calls["graphs"]["replays"] > 0,
          f"loop comparison: no window graph replayed {calls['graphs']}")
    check(ec["decode_speedup"] >= MIN_LOOP_SPEEDUP,
          f"loop comparison: the device loop decodes "
          f"{ec['device_loop']['decode_tok_per_s']} tok/s, "
          f"{ec['decode_speedup']} times the host loop's "
          f"{ec['host_loop']['decode_tok_per_s']}, below "
          f"{MIN_LOOP_SPEEDUP}")
    emit({"phase": "loop_speedup", "arch": cfg.name, **LOOP_BENCH,
          "engine_comparison": ec, "floor": MIN_LOOP_SPEEDUP,
          "seconds": time.perf_counter() - t0, "graphs": calls["graphs"],
          "decode_ticks": calls["ticks"], "launches": calls["launches"],
          "card": smi})
    return calls["launches"]


# ---------------------------------------------------------------------------
# the paper's proof of concept: Algorithm 1's cascade on the Lumos5G LSTM
# ---------------------------------------------------------------------------

CASCADE_ARGV = ["--samples", "70000", "--steps-per-phase", "100"]
# the cross-entropy of a uniform guess over the 3 throughput classes
CHANCE_LOSS = math.log(3)
# printed beside the port's numbers, never held: the JAX package's
# examples/throughput_prediction.py with CASCADE_ARGV and seed 0 on a CPU
# (its weights come from another generator, and many steps are not bit for
# bit, so near values are expected; Ensure fails there too at this seed)
CASCADE_REFERENCE = {
    "mode0": {"val_loss": 0.3303, "val_acc": 0.8471},
    "mode1": {"val_loss": 0.3226, "val_acc": 0.8502},
    "ensure_ordered": False,
    "I_XH_I_HY": {"mode1_H1": [14.69, 1.58], "mode1_H2": [6.38, 1.53],
                  "mode1_H3": [5.64, 1.12]},
    "cond_mi_ladder": [3.35, 3.29, 3.29], "cpu_wall_s": 30}
CASCADE_PROFILE_STEPS = 10


def _cascade_setup(seed: int, n_batches: int):
    """The paper's configuration, its loss and schedule as the example sets
    them, the first ``n_batches`` training batches of the 70,000-sample
    twin (host arrays) and random weights drawn on the CPU from ``seed``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lumos5g
    from repro_torch.models import lstm as LSTM
    lcfg = get_config("lumos5g-lstm")
    dcfg = lumos5g.Lumos5GConfig(n_samples=70_000, seq_len=lcfg.seq_len,
                                 seed=seed)
    train, _ = lumos5g.train_test_split(lumos5g.generate(dcfg), dcfg)
    batches = lumos5g.stacked_batches(train, lcfg.batch_size, n_batches)
    tcfg = TrainConfig(learning_rate=lcfg.learning_rate, warmup_steps=20,
                       total_steps=200, weight_decay=0.0)
    params = LSTM.init_params(torch.Generator().manual_seed(seed), lcfg)
    return (lcfg, tcfg, lambda p, b, m: LSTM.loss_fn(p, b, lcfg, m),
            batches, params)


def _on(tree, dev):
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def hold_step(label: str, p0, g_cpu, g_dev, p_cpu, p_dev, lr: float,
              floor: float = 0.0, adam_eps: float = 0.0) -> list:
    """One composed train step (the gradients and the AdamW update), card
    against CPU from the same parameters ``p0``, by ``TOL["cascade"]``'s
    rules: each leaf's gradient within ``grad_rel`` of its scale, each
    updated element within ``step_rel`` of |p| + |delta| except where |g|
    is below ``small_g`` of the scale (there 2 lr). The scale is the
    leaf's largest |g|, but at least ``floor`` times the largest |g| of
    any leaf. ``adam_eps``: the update's limit also takes the gradient's
    own tolerance carried through Adam's first update, lr g / (|g| + eps),
    whose slope in g is lr eps / (|g| + eps)^2. A leaf without a gradient
    (None on both sides: outside the loss's graph) is held as one of
    zeros. Returns one row a leaf, with its worst error and limit."""
    import numpy as np

    from repro_torch.convert import flat_from_params
    tol = TOL["cascade"]
    fc, fg = flat_from_params(g_cpu), flat_from_params(g_dev)
    check(sorted(fc) == sorted(fg),
          f"{label}: gradient leaves {sorted(fg)} on the card, "
          f"{sorted(fc)} on the CPU")
    p0 = flat_from_params(p0)
    pc, pg = flat_from_params(p_cpu), flat_from_params(p_dev)
    top = max([float(np.abs(g).max()) for g in fc.values()] + [0.0])
    leaves = []
    for k in sorted(pc):
        rec = {"leaf": k}
        g = fc.get(k)
        if g is not None:
            big = max(float(np.abs(g).max()), floor * top)
            rec["grad_err"] = float(np.abs(fg[k] - g).max())
            rec["grad_limit"] = tol["grad_rel"] * big
            check(rec["grad_err"] <= rec["grad_limit"],
                  f"{label} {k}: gradient off by {rec['grad_err']}, limit "
                  f"{rec['grad_limit']}")
            small = np.abs(g) < tol["small_g"] * big
            carried = lr * adam_eps * rec["grad_limit"] / (
                np.abs(g) + adam_eps) ** 2 if adam_eps else 0.0
        else:
            small = np.zeros(pc[k].shape, bool)
            carried = 0.0
        # relative to the operands of p - delta: an element that
        # nearly cancels keeps the error of delta, not of its value
        scale = np.abs(p0[k]) + np.abs(p0[k] - pc[k])
        limit = np.where(small, 2 * lr, tol["step_rel"] * scale + carried)
        err = np.abs(pg[k] - pc[k])
        ratio = err / np.maximum(limit, 1e-45)
        i = np.unravel_index(np.argmax(ratio), ratio.shape)
        rec["param_err"] = float(err.max())
        rec["param_err_over_limit"] = float(ratio[i])
        check(np.all(err <= limit),
              f"{label} {k}: updated leaf off by up to {rec['param_err']}; "
              f"worst against its limit at {i}: {float(ratio[i])} of it (p "
              f"{p0[k][i]}, CPU {pc[k][i]}, card {pg[k][i]}, g "
              f"{None if g is None else g[i]})")
        leaves.append(rec)
    return leaves


def cascade_first_steps(seed: int, dev) -> list:
    """The first step of phase 1 (mode 0), then of phase 2 (mode 1) from
    the CPU's phase-1 parameters and state, on the CPU and on the card from
    the same parameters and batch: the loss, every leaf's gradient and
    every updated leaf against the CPU's (``TOL["cascade"]``); on the card,
    every leaf phase 2 freezes, its m and its v bit-identical before and
    after the step, and every ``bneck`` leaf moved. Returns one row per
    phase with each leaf's worst error and its limit."""
    import torch

    from repro_torch.core import cascade as C
    from repro_torch.models import lstm as LSTM
    from repro_torch.training import optimizer as opt
    lcfg, tcfg, loss, batches, cpu = _cascade_setup(seed, 2)
    step = C.make_train_step(loss, tcfg)
    state = opt.init(cpu)
    tol = TOL["cascade"]
    rows = []
    for phase in (1, 2):
        mode = phase - 1
        batch = {k: torch.from_numpy(v[phase - 1]) for k, v in batches.items()}
        gpu = _on(cpu, dev)
        gstate = opt.AdamState(state.step.to(dev), _on(state.m, dev),
                               _on(state.v, dev))
        gbatch = _on(batch, dev)
        (lc, _), g_cpu = C.value_and_grad(loss, cpu, batch, mode)
        (lg, _), g_dev = C.value_and_grad(loss, gpu, gbatch, mode)
        cpu2, state2, mc = step(cpu, state, batch,
                                LSTM.phase_mask(cpu, phase), mode=mode)
        gmask = LSTM.phase_mask(gpu, phase)
        gpu2, gstate2, _ = step(gpu, gstate, gbatch, gmask, mode=mode)
        torch.cuda.synchronize()
        lr = float(mc["lr"])
        loss_err = abs(float(lg) - float(lc))
        check(loss_err <= tol["loss_abs"],
              f"cascade phase {phase}: loss {float(lg)} on the card, "
              f"{float(lc)} on the CPU")
        check(int(gstate2.step) == int(state2.step) == phase,
              f"cascade phase {phase}: step {int(gstate2.step)}")
        leaves = hold_step(f"cascade phase {phase}", cpu, g_cpu, g_dev,
                           cpu2, gpu2, lr)
        if phase == 2:
            trip = zip(opt.leaves(gmask), opt.leaves(gpu), opt.leaves(gpu2),
                       opt.leaves(gstate.m), opt.leaves(gstate2.m),
                       opt.leaves(gstate.v), opt.leaves(gstate2.v))
            frozen = moved = 0
            for t, p0, p1, m0, m1, v0, v1 in trip:
                if t:
                    continue
                frozen += 1
                check(same_bits(p0, p1) and same_bits(m0, m1)
                      and same_bits(v0, v1),
                      "cascade phase 2: a frozen leaf, its m or its v "
                      "changed on the card")
            for p0, p1 in zip(opt.leaves(gpu["bneck"]),
                              opt.leaves(gpu2["bneck"])):
                moved += not same_bits(p0, p1)
            check(moved == len(opt.leaves(gpu["bneck"])),
                  f"cascade phase 2: {moved} bneck leaves moved")
        rows.append({"phase": phase, "mode": mode, "lr": lr,
                     "loss_cpu": float(lc), "loss_err": loss_err,
                     "leaves": leaves,
                     **({"frozen_leaves_bit_identical": frozen,
                         "bneck_leaves_moved": moved} if phase == 2 else {})})
        cpu, state = cpu2, state2
    return rows


@contextlib.contextmanager
def timed_steps(times: dict):
    """Time every train step ``cascade.train_cascade`` makes, the device
    synchronized before and after: ``times[mode]`` gets its seconds."""
    import torch

    from repro_torch.core import cascade as C
    orig = C.make_train_step

    def make(loss_fn, tcfg, **kw):
        step = orig(loss_fn, tcfg, **kw)

        def timed(*args, mode: int, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args, mode=mode, **kw)
            torch.cuda.synchronize()
            times.setdefault(mode, []).append(time.perf_counter() - t0)
            return out
        return timed

    C.make_train_step = make
    try:
        yield times
    finally:
        C.make_train_step = orig


def cascade_profile(seed: int, dev) -> dict:
    """``CASCADE_PROFILE_STEPS`` train steps of each phase under
    ``torch.profiler``, after one untraced step of it: device kernels a
    step, device busy ms a step and the idle share, read as
    ``serve.profile_summary`` reads them (the profiler's own host cost is
    in the wall time, so the idle share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import cascade as C
    from repro_torch.launch import serve
    from repro_torch.models import lstm as LSTM
    from repro_torch.training import optimizer as opt
    n = CASCADE_PROFILE_STEPS
    _, tcfg, loss, batches, params = _cascade_setup(seed, 2 * (n + 1))
    batches = [_on({k: torch.from_numpy(v[i]) for k, v in batches.items()},
                   dev) for i in range(2 * (n + 1))]
    params = _on(params, dev)
    train_step = C.make_train_step(loss, tcfg)
    state = opt.init(params)
    out = {}
    for phase in (1, 2):
        mask = LSTM.phase_mask(params, phase)
        todo = batches[(phase - 1) * (n + 1):phase * (n + 1)]

        def steps(bs):
            nonlocal params, state
            for b in bs:
                params, state, _ = train_step(params, state, b, mask,
                                              mode=phase - 1)
            torch.cuda.synchronize()

        steps(todo[:1])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps(todo[1:])
            secs = time.perf_counter() - t0
        summ = serve.profile_summary(prof, secs)
        out[f"phase{phase}"] = {
            "steps": n, "device_traced": summ["kernel_launches"] > 0,
            "device_kernels_per_step": summ["kernel_launches"] / n,
            "device_busy_ms_per_step": summ["device_busy_s"] * 1e3 / n,
            "device_idle_share": summ["device_idle_share"],
            "profiled_wall_ms_per_step": secs * 1e3 / n,
            "top_kernels": summ["top_kernels"][:6]}
    return out


def phase_cascade(seed: int, smi: str) -> dict:
    """The paper's proof of concept at full size on the card: the first
    steps of both phases against the CPU (``cascade_first_steps``); then
    the main path, ``repro_torch.examples.throughput_prediction.main`` at
    70,000 samples and 100 steps a phase, with every kernel counter at 0
    just before and read just after (the LSTM and the optimizer are plain
    PyTorch: none of the six kernels is on this path) and every step timed
    with the device synchronized; gates: every logged loss finite, mode
    0's eval loss below chance (ln 3), every information-plane number and
    ladder value finite; Ensure, the mode table and the times are printed,
    never held. Then a profile of each phase (``cascade_profile``)."""
    import numpy as np
    import torch

    from repro_torch.examples import throughput_prediction
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    first = cascade_first_steps(seed, dev)
    parity_s = time.perf_counter() - t0
    fns = zero_counts()
    times: dict = {}
    t0 = time.perf_counter()
    with timed_steps(times):
        res = throughput_prediction.main(
            ["--device", "cuda", *CASCADE_ARGV, "--out",
             str(ROOT / "build" / "cascade" / "throughput_prediction.json")])
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in fns.items()}
    hist = res["history"]
    logged = [r["loss"] for e in hist["phases"] for r in e["log"]]
    check(logged and all(math.isfinite(v) for v in logged),
          f"cascade: a logged loss is not finite: {logged}")
    ev = [e["eval"] for e in hist["phases"]]
    check(ev[0]["loss"] < CHANCE_LOSS,
          f"cascade: mode 0's eval loss {ev[0]['loss']} is not below "
          f"chance ({CHANCE_LOSS})")
    ib = [v for p in res["info_plane"].values() for v in p.values()]
    check(all(np.isfinite(v) for v in ib + res["cond_mi_ladder"]),
          f"cascade: an information-plane or ladder value is not finite: "
          f"{res['info_plane']} {res['cond_mi_ladder']}")
    steps = {m: len(t) for m, t in times.items()}
    check(steps == {0: 100, 1: 100}, f"cascade: steps timed {steps}")
    prof = cascade_profile(seed, dev)
    emit({"phase": "cascade", "arch": "lumos5g-lstm",
          "argv": CASCADE_ARGV, "tolerance": TOL["cascade"],
          "first_steps": first, "parity_s": parity_s,
          "modes": [{"mode": m, **e} for m, e in enumerate(ev)],
          "ensure": hist["ensure"], "info_plane": res["info_plane"],
          "cond_mi_ladder": res["cond_mi_ladder"],
          "ms_per_step": {f"phase{m + 1}": 1e3 * statistics.median(t[1:])
                          for m, t in sorted(times.items())},
          "ms_first_step": {f"phase{m + 1}": 1e3 * t[0]
                            for m, t in sorted(times.items())},
          "train_and_analysis_wall_s": res["wall_s"], "wall_s": wall,
          "launches": launches, "profile": prof,
          "reference_jax_cpu": CASCADE_REFERENCE, "card": smi})
    return launches


# ---------------------------------------------------------------------------
# transformer training and the full-sequence forward
# ---------------------------------------------------------------------------

# the launcher's own path at full width: Algorithm 1 on qwen2.5-3b (36
# layers, d_model 2048, vocab 151936, nothing cut), 6 steps a phase
# (10 until the script outgrew its time on a slow host)
TRAIN_ARGV = ["--arch", "qwen2.5-3b", "--cascade", "--steps", "6",
              "--batch", "4", "--seq", "128"]
# the first step of loop.make_train_step, card against CPU, reduced f32
TRAIN_REF_CASES = (("qwen2.5-3b", None), ("qwen2.5-3b", 0),
                   ("qwen2.5-3b", 1), ("recurrentgemma-2b", None),
                   ("xlstm-125m", None))
TRAIN_PROFILE_STEPS = 2
# the serving run that must decode the same tokens from the checkpoint as
# from the launcher's weights in memory
CKPT_SERVE = ["--arch", "qwen2.5-3b", "--engine", "sync", "--policy",
              "orchestrator", "--requests", "8", "--prompt-len", "16",
              "--gen", "16"]


def train_first_steps(dev) -> list:
    """The first step of ``loop.make_train_step`` for each of
    ``TRAIN_REF_CASES`` (reduced configs in f32, a [2, 32] Markov batch),
    on the CPU and on the card from the same weights (drawn on the CPU):
    the loss, every leaf's gradient and every updated leaf by
    ``TOL["cascade"]``'s rules, the gradient scale floored at
    ``grad_floor`` of the largest and the gradient's tolerance carried
    through Adam's first update (``hold_step``); none of the six kernels
    launched on the card."""
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import cascade as C
    from repro_torch.core import split as SP
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.training import loop as L
    from repro_torch.training import optimizer as opt
    tol = TOL["cascade"]
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=100)
    rows = []
    for arch, mode in TRAIN_REF_CASES:
        label = f"train first step {arch} mode {mode}"
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        cpu = SP.init_split_params(torch.Generator().manual_seed(0), cfg)
        batch = {k: torch.from_numpy(v) for k, v in MarkovTokenSource(
            cfg, seed=0).batch(2, 32, 0).items()}
        gpu, gbatch = _on(cpu, dev), _on(batch, dev)
        loss = L.make_loss_fn(cfg, mode=mode)

        def vg(p, b):
            return C.value_and_grad(lambda q, bb, _: loss(q, bb), p, b, mode)

        fns = zero_counts()
        (lg, _), g_dev = vg(gpu, gbatch)
        step = L.make_train_step(cfg, tcfg, mode=mode, donate=False)
        gpu2, _, _ = step(gpu, opt.init(gpu), gbatch)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in fns.items()}
        check(not any(launches.values()),
              f"{label}: the training path launched {launches}")
        (lc, _), g_cpu = vg(cpu, batch)
        cpu2, _, mc = step(cpu, opt.init(cpu), batch)
        loss_err = abs(float(lg) - float(lc))
        check(loss_err <= tol["loss_abs"] + tol["loss_rel"] * abs(float(lc)),
              f"{label}: loss {float(lg)} on the card, {float(lc)} on the "
              f"CPU")
        leaves = hold_step(label, cpu, g_cpu, g_dev, cpu2, gpu2,
                           float(mc["lr"]), floor=tol["grad_floor"],
                           adam_eps=tcfg.eps)
        worst = max(leaves, key=lambda r: r["param_err_over_limit"])
        rows.append({"arch": arch, "mode": mode, "loss_cpu": float(lc),
                     "loss_err": loss_err, "leaves": len(leaves),
                     "worst_grad_err_over_limit": max(
                         r.get("grad_err", 0) / max(r.get("grad_limit", 1),
                                                    1e-45) for r in leaves),
                     "worst_update": worst})
    return rows


@contextlib.contextmanager
def capturing_saves(saved: dict):
    """Keep the tree and the seconds of each ``checkpoint.save`` call."""
    from repro_torch.training import checkpoint
    orig = checkpoint.save

    def save(path, tree, metadata=None):
        t0 = time.perf_counter()
        orig(path, tree, metadata)
        saved.update(path=path, tree=tree, seconds=time.perf_counter() - t0)

    checkpoint.save = save
    try:
        yield saved
    finally:
        checkpoint.save = orig


def train_profile(params, cfg, dev) -> dict:
    """``TRAIN_PROFILE_STEPS`` donated cascade steps of each phase on the
    full-width ``params`` (updated in place), after one untraced step:
    device kernels a step, busy ms a step and the idle share, as
    ``serve.profile_summary`` reads them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import cascade as C
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.launch import serve
    from repro_torch.training import loop as L
    from repro_torch.training import optimizer as opt
    n = TRAIN_PROFILE_STEPS
    src = MarkovTokenSource(cfg, seed=0)
    batches = [L.device_batch(src.batch(4, 128, s), dev)
               for s in range(n + 1)]
    state = opt.init(params)
    out = {}
    for phase in (1, 2):
        loss = L.make_loss_fn(cfg, mode=phase - 1)
        step = C.make_train_step(lambda p, b, _: loss(p, b), TrainConfig(),
                                 donate=True)
        mask = C.transformer_phase_mask(params, phase)

        def steps(bs):
            nonlocal params, state
            for b in bs:
                params, state, _ = step(params, state, b, mask,
                                        mode=phase - 1)
            torch.cuda.synchronize()

        steps(batches[:1])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps(batches[1:])
            secs = time.perf_counter() - t0
        summ = serve.profile_summary(prof, secs)
        out[f"phase{phase}"] = {
            "steps": n, "device_traced": summ["kernel_launches"] > 0,
            "device_kernels_per_step": summ["kernel_launches"] / n,
            "device_busy_ms_per_step": summ["device_busy_s"] * 1e3 / n,
            "device_idle_share": summ["device_idle_share"],
            "profiled_wall_ms_per_step": secs * 1e3 / n,
            "top_kernels": summ["top_kernels"][:8]}
    return out


def phase_train_launcher(dev, smi: str):
    """``repro_torch.launch.train.main(TRAIN_ARGV)`` at full width with
    every kernel counter at 0 just before and read just after (none of
    the six kernels is on the training path, as in the reference). Gates:
    every logged loss finite, phase 1's last below its first (the Markov
    stream is learnable), 0 launches; then ``checkpoint.restore`` of the
    launcher's file must give its final parameters bit for bit, and
    ``serve.main(... --ckpt)`` must decode the tokens those weights give
    in memory. Ensure is reported, never held (the reference fails it
    too). Prints ms a step of each phase, peak device memory, the
    checkpoint's bytes and its save and restore seconds, and a profile of
    each phase. The checkpoint's directory is deleted at the end. Returns
    the launches of the training path and of the ``--ckpt`` serving
    run."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_launch
    from repro_torch.training import checkpoint
    cfg = get_config("qwen2.5-3b")
    serve_argv = CKPT_SERVE + ["--device", dev.type]
    ckpt_dir = ROOT / "build" / "train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        saved: dict = {}
        fns = zero_counts()
        t0 = time.perf_counter()
        with capturing_saves(saved):
            hist = train_launch.main(TRAIN_ARGV + [
                "--ckpt-dir", str(ckpt_dir), "--device", dev.type])
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in fns.items()}
        check(not any(launches.values()),
              f"train launcher: the training path launched {launches}")
        logs = [[r["loss"] for r in p["log"]] for p in hist["phases"]]
        check(all(math.isfinite(v) for log in logs for v in log),
              f"train launcher: a logged loss is not finite: {logs}")
        check(logs[0][-1] < logs[0][0],
              f"train launcher: phase 1 did not learn: {logs[0]}")
        path = saved["path"]
        nbytes = Path(path).stat().st_size
        final = saved.pop("tree")
        t1 = time.perf_counter()
        restored = checkpoint.restore(path, final)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        from repro_torch.convert import flat_tensors
        fa, fb = flat_tensors(final), flat_tensors(restored)
        check(sorted(fa) == sorted(fb) and all(
            fa[k].dtype == fb[k].dtype and same_bits(fa[k], fb[k])
            for k in fa), "train launcher: the restored checkpoint is not "
                          "the launcher's final parameters bit for bit")
        del final, fa, fb
        free_cuda()
        fns = zero_counts()
        from_ckpt = serve.main(serve_argv + ["--ckpt", path])
        serve_launches = {k: f.launches for k, f in fns.items()}
        free_cuda()
        in_memory = serve.run_sync(serve.parser().parse_args(serve_argv),
                                   cfg, restored)
        check(from_ckpt["generated"] == in_memory["generated"],
              "serve --ckpt: other tokens than the launcher's weights in "
              "memory give")
        check(serve_launches["decode_tail_grouped"] == 16,
              f"serve --ckpt: launches {serve_launches}")
        free_cuda()
        prof = train_profile(restored, cfg, dev)
        del restored
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        free_cuda()
    emit({"phase": "train", "path": "launch.train", "argv": TRAIN_ARGV,
          "params": cfg.param_count(), "wall_s": wall,
          "ms_per_step": hist["ms_per_step"],
          "peak_memory_bytes": hist.get("peak_memory_bytes"),
          "logged_losses": logs, "ensure": hist["cascade"],
          "evals": [p.get("eval") for p in hist["phases"]],
          "checkpoint_bytes": nbytes, "save_s": saved["seconds"],
          "restore_s": restore_s, "launches": launches,
          "serve_ckpt": {"tokens": from_ckpt["tokens"],
                         "decode_tok_per_s": from_ckpt["decode_tok_per_s"],
                         "launches": serve_launches},
          "profile": prof, "card": smi})
    return launches, serve_launches


def eval_forward(cfg, tokens, seed: int, dev) -> dict:
    """``T.forward`` of ``cfg`` at full width on ``tokens`` in eval (the
    scan op: the CUDA scan) and in train (the cell scans) form, without
    autograd, on the same random bf16 weights: the logits of each, the
    kernel launches of each and its seconds."""
    import torch

    from repro_torch.models import transformer as T
    params = T.init_params(torch.Generator(device=dev).manual_seed(seed),
                           cfg)
    tok = torch.from_numpy(tokens).to(dev)
    out = {}
    with torch.no_grad():
        for train in (False, True):
            fns = zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = T.forward(params, tok, cfg, train=train)
            torch.cuda.synchronize()
            out[train] = (logits, {k: f.launches for k, f in fns.items()},
                          time.perf_counter() - t0)
    return out


def phase_eval_forwards(seed: int, dev, smi: str) -> dict:
    """The full-width eval forwards on the CUDA scan: recurrentgemma-2b at
    [1, 2048] (its 8 local-attention layers on the blocked route) must
    launch ``rglru_scan`` once a RG-LRU layer (18) and give the logits of
    the train forward (the cell scan, no launch) bit for bit: both round
    a * h and the sum separately, in the same order. xlstm-125m at
    [4, 256] once an mLSTM layer (6), its logits within
    ``TOL["xlstm_forward"]`` of the train forward's (the fused cell);
    nothing else of the six launched."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import MarkovTokenSource
    res, by_path = {}, {}
    for arch, (B, S) in (("recurrentgemma-2b", (1, 2048)),
                         ("xlstm-125m", (4, 256))):
        cfg = get_config(arch)
        tok = MarkovTokenSource(cfg, seed=seed).batch(B, S, 0)["tokens"]
        out = eval_forward(cfg, tok, seed, dev)
        (ev, le, se), (tr, lt, st) = out[False], out[True]
        layers = [cfg.block_kind(i) for i in range(cfg.n_layers)]
        want = {k: 0 for k in le}
        want["rglru_scan"] = scan_layers(layers)
        check(le == want, f"{arch} eval forward: launches {le}, expected "
                          f"{want}")
        check(not any(lt.values()), f"{arch} train forward: launches {lt}")
        check(bool(torch.isfinite(ev).all()) and ev.shape
              == (B, S, cfg.vocab_size), f"{arch} eval forward: logits")
        err = float((ev - tr).abs().max())
        big = float(tr.abs().max())
        bits = same_bits(ev, tr)
        if arch == "recurrentgemma-2b":
            check(bits, f"{arch}: eval and train forward differ by {err}")
        else:
            check(err <= TOL["xlstm_forward"] * big,
                  f"{arch}: eval and train forward differ by {err} (max "
                  f"|logit| {big})")
        res[arch] = {"shape": [B, S], "launches_eval": le,
                     "bit_identical": bits, "max_abs_err": err,
                     "max_abs_logit": big, "eval_s": se, "train_s": st}
        by_path[f"{arch} forward"] = le
        del out, ev, tr
        free_cuda()
    emit({"phase": "train", "path": "eval_forward", "tolerance":
          TOL["xlstm_forward"], **res, "card": smi})
    return by_path


# train_100m's batch: the example's, at a quarter of its default sequence
# (its eager time loops with both recomputes take ~25 s a step at 256 on
# the card, the one part of the script that grows with the sequence;
# phase 18 trains the same model at [4, 128] three times)
TRAIN_100M_ARGV = ["--steps", "2", "--batch", "2", "--seq", "64"]


def phase_train_100m(dev, smi: str) -> dict:
    """``repro_torch.examples.train_100m.main(TRAIN_100M_ARGV)`` at full
    width (xlstm-125m), counters at 0 just before and read just after:
    finite losses, no kernel of the six launched, ms a step printed."""
    import shutil

    from repro_torch.examples import train_100m
    out_dir = ROOT / "build" / "train_100m"
    fns = zero_counts()
    try:
        res = train_100m.main(TRAIN_100M_ARGV + [
            "--device", dev.type, "--save", str(out_dir / "xlstm125m.npz")])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    launches = {k: f.launches for k, f in fns.items()}
    losses = [r["loss"] for r in res["history"]]
    check(losses and all(math.isfinite(v) for v in losses),
          f"train_100m: losses {losses}")
    check(not any(launches.values()), f"train_100m: launches {launches}")
    emit({"phase": "train", "path": "train_100m", "argv": TRAIN_100M_ARGV,
          "losses": losses, "ms_per_step": res["ms_per_step"],
          "wall_s": res["wall_s"], "launches": launches, "card": smi})
    free_cuda()
    return launches


def phase_train(dev, smi: str) -> dict:
    """Phase 12's first half: the first train steps against the CPU, the
    launcher at full width. Returns the kernel launches of each path."""
    t0 = time.perf_counter()
    first = train_first_steps(dev)
    emit({"phase": "train", "path": "first_steps", "cases": first,
          "tolerance": TOL["cascade"], "seconds": time.perf_counter() - t0,
          "card": smi})
    free_cuda()
    train_l, serve_l = phase_train_launcher(dev, smi)
    return {"qwen2.5-3b train": train_l, "qwen2.5-3b serve --ckpt": serve_l}


def phase_train_small(seed: int, dev, smi: str) -> dict:
    """Phase 12's second half: the eval forwards on the CUDA scan, the
    xlstm-125m example. Returns the kernel launches of each path."""
    by_path = phase_eval_forwards(seed, dev, smi)
    by_path["xlstm-125m train_100m"] = phase_train_100m(dev, smi)
    return by_path


# ---------------------------------------------------------------------------
# scale-out serving: the edge cluster, the fleet and the serving benches
# ---------------------------------------------------------------------------

CLUSTER_REQUESTS, CLUSTER_PROMPT, CLUSTER_GEN = 8, 16, 16
#: each request's cell capacity (both cells equal, bytes/s): 40 Mbps fits
#: the raw boundary, 4 Mbps only the bottleneck, so the pool mixes modes
CLUSTER_CAPS = (40e6 / 8, 4e6 / 8)
#: the most an 8-bit snapshot may ship against the raw one
QUANT_SNAPSHOT_RATIO = 0.53
FLEET_ARGV = ["--arch", "qwen2.5-3b", "--engine", "fleet", "--requests",
              "64", "--prompt-len", "16", "--gen", "16", "--slo-ticks", "96",
              "--arrival", "poisson", "--autoscale", "--max-replicas", "4",
              "--telemetry"]
# the benches at full width with small arguments, cut to fit the phase's
# time (PERF.md section 4): the TTFT comparison at a 16-token prompt,
# 4 requests of 8 tokens a load level, the loop and telemetry A/Bs at 4 slots and 6 tokens,
# the fade A/B at 8, the handover A/B at 6, the fleet at 16 UEs and the
# autoscaler A/B at 256 on 4-slot replicas generating 4 tokens each (at
# 256 UEs the autoscaled arm scales up; at 64 it would compare two equal
# fixed fleets)
BENCH_SERVING_ARGV = ["--loads", "8", "--requests", "4", "--channel-trace",
                      "fade", "--overhead-repeats", "1",
                      "--prefill-prompt-len", "16", "--gen", "8",
                      "--compare-slots", "4", "--compare-gen", "6",
                      "--trace-gen", "8"]
BENCH_CLUSTER_ARGV = ["--gen", "6"]
BENCH_FLEET_ARGV = ["--ues", "16", "--ab-ues", "256", "--n-slots", "4",
                    "--gen", "4"]


def cluster_requests(cfg, seed: int = 0):
    """Mobility sessions as ``launch.serve --engine cluster`` makes them:
    each starts in its home cell (i % 2) and crosses into the other partway
    through its generation; ``detach_factor`` 1.0, so a session's capacity
    (and mode) at every tick does not depend on where it is served."""
    import numpy as np

    from repro_torch.core.channel import MobilityChannel
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    batch = MarkovTokenSource(cfg, seed=7).batch(
        CLUSTER_REQUESTS, CLUSTER_PROMPT)["tokens"]
    reqs = []
    for i in range(CLUSTER_REQUESTS):
        home = i % 2
        cross = int(rng.integers(2, CLUSTER_GEN - 2))
        cells = [home] * cross + [1 - home] * (CLUSTER_GEN + 8)
        cap = CLUSTER_CAPS[(i // 2) % 2]
        reqs.append(Request(rid=i, prompt=np.asarray(batch[i]),
                            max_new_tokens=CLUSTER_GEN, arrival_tick=2 * i,
                            channel=MobilityChannel(cells, [cap, cap],
                                                    detach_factor=1.0)))
    return reqs


@contextlib.contextmanager
def counted_path(calls: dict):
    """Launch counters and the graph tallies at 0, and the split prefill
    and decode-step calls counted, while the block runs; ``calls`` gets
    the launches and, under ``ticks``, the decode ticks of every engine
    (``graphed_steps``: eager ticks, and each replayed window's)."""
    from repro_torch.core import split as SP
    fns = zero_counts()
    with counting(SP, "split_prefill_mixed", calls), \
            counting(SP, "split_decode_step_mixed", calls), \
            graph_tally(calls):
        yield calls
    calls["launches"] = {k: f.launches for k, f in fns.items()}
    calls["ticks"] = graphed_steps(calls, "split_decode_step_mixed")


def check_path_launches(calls: dict, cfg, label: str,
                        exact: bool = True) -> None:
    """Per decode tick of any replica one boundary, one tail and one paged
    attention a layer; per prefill dispatch one boundary: the continuous
    path's launches. ``exact=False`` (the serving bench, whose host-loop
    ticks read logits without the tail and whose dense control engine has
    no page arena): one boundary a tick and a prefill, at most one tail a
    tick and one paged attention a layer and tick, each launched."""
    ticks = calls["ticks"]
    prefills = calls.get("split_prefill_mixed", 0)
    got = calls["launches"]
    expect = {"boundary_mixed_grouped": ticks + prefills,
              "decode_tail_grouped": ticks,
              "paged_attention": cfg.n_layers * ticks, "rglru_scan": 0,
              "bottleneck_quant": 0, "dequant_matmul": 0}
    if exact:
        ok = ticks > 0 and got == expect
    else:
        ok = (got["boundary_mixed_grouped"] == expect["boundary_mixed_grouped"]
              and all(0 < got[k] <= expect[k] for k in (
                  "decode_tail_grouped", "paged_attention"))
              and not any(got[k] for k in (
                  "rglru_scan", "bottleneck_quant", "dequant_matmul")))
    check(ok, f"{label}: launches {got} for {prefills} prefill dispatches "
              f"and {ticks} decode ticks, expected "
              f"{'' if exact else 'at most '}{expect}")


def first_difference(got: dict, want: dict):
    """(rid, token index) of the first request whose tokens differ."""
    for rid in sorted(want):
        a, b = got.get(rid, []), want[rid]
        if a != b:
            i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            return rid, i
    return None


def run_cluster_policy(params, cfg, handover: str, bits: int, dev):
    """The 2-replica cluster (4 slots each, page 8) over the mobility
    requests, telemetry on, with its launches counted. Not warmed: the
    earlier phases ran these paths on the card, and a run here serves
    only the requests."""
    from repro_torch.serving import EdgeCluster, Telemetry
    tel = Telemetry()
    calls: dict = {}
    cluster = EdgeCluster(params, cfg, n_replicas=2, n_slots=4,
                          cache_len=128, page_len=8,
                          placement="best-channel", handover=handover,
                          snapshot_bits=bits, telemetry=tel)
    reqs = cluster_requests(cfg)
    with counted_path(calls):
        t0 = time.perf_counter()
        done = cluster.run(reqs)
        sync(dev)
        seconds = time.perf_counter() - t0
    st = cluster.stats()
    dev_wire = sum(e.device_tel["wire_bytes"] for e in cluster.replicas)
    dev_ticks = sum(e.device_tel["slot_ticks"] for e in cluster.replicas)
    cluster.close()
    return {"done": {s.request.rid: s for s in done}, "stats": st,
            "tel": tel, "calls": calls, "seconds": seconds,
            "device_tel": {"wire_bytes": dev_wire, "slot_ticks": dev_ticks}}


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_cluster(cfg, dev, smi: str) -> dict:
    """The edge cluster at full width: raw-migrated tokens equal one
    engine's (no handover) request by request; every request finishes under
    migrate (raw and 8-bit snapshots), stay and drop; migrations equal the
    handovers acted on and their bytes the snapshots'; 8-bit snapshots at
    most ``QUANT_SNAPSHOT_RATIO`` of the raw bytes; the folded telemetry
    blocks equal host wire accounting; the trace has the cluster and
    replica lanes with the migration events; launches a tick as on the
    continuous path. Returns the launches of each policy's run."""
    import torch

    from repro_torch.core import split as SP
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     default_orchestrator)
    params = SP.init_split_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg)
    t0 = time.perf_counter()
    base_eng = ContinuousBatchingEngine(
        params, cfg, n_slots=4, cache_len=128, page_len=8,
        orchestrator=default_orchestrator(cfg))
    base = {s.request.rid: s for s in base_eng.run(cluster_requests(cfg))}
    base_eng.close()
    base_s = time.perf_counter() - t0
    check(len(base) == CLUSTER_REQUESTS,
          f"cluster: the single engine finished {len(base)} requests")
    runs, by_path = {}, {}
    for label, handover, bits in (("migrate", "migrate", 0),
                                  ("migrate_q8", "migrate", 8),
                                  ("stay", "stay", 0), ("drop", "drop", 0)):
        r = runs[label] = run_cluster_policy(params, cfg, handover, bits,
                                             dev)
        st, done = r["stats"], r["done"]
        check(st["requests_finished"] == CLUSTER_REQUESTS
              and all(len(s.tokens) == CLUSTER_GEN for s in done.values()),
              f"cluster {label}: {st['requests_finished']} of "
              f"{CLUSTER_REQUESTS} requests finished")
        check(st["handovers"] > 0, f"cluster {label}: no handover acted on")
        check_path_launches(r["calls"], cfg, f"cluster {label}")
        host_wire = sum(s.wire_bytes - s.prefill_wire_bytes
                        for s in done.values())
        check(r["device_tel"] == {"wire_bytes": host_wire,
                                  "slot_ticks": st["decode_tokens"]}
              and r["tel"].registry.get("engine.decode_wire_bytes").value
              == host_wire,
              f"cluster {label}: device_tel {r['device_tel']} against host "
              f"wire {host_wire} and {st['decode_tokens']} decode tokens")
        by_path[f"qwen2.5-3b cluster {label}"] = r["calls"]["launches"]
    mig, q8 = runs["migrate"]["stats"], runs["migrate_q8"]["stats"]
    got = {rid: s.tokens for rid, s in runs["migrate"]["done"].items()}
    want = {rid: s.tokens for rid, s in base.items()}
    diff = first_difference(got, want)
    check(diff is None,
          f"cluster: raw-migrated tokens differ from one engine's at "
          f"(request, token index) {diff}; modes "
          f"{runs['migrate']['done'][diff[0]].mode_trace if diff else ''} / "
          f"{base[diff[0]].mode_trace if diff else ''}")
    for label in ("migrate", "migrate_q8"):
        st, done = runs[label]["stats"], runs[label]["done"]
        snaps = [m["bytes"] for s in done.values() for m in s.migrations
                 if m["kind"] == "migrate"]
        check(st["migrations"] == st["handovers"] == len(snaps) > 0
              and st["migration_bytes"] == sum(snaps),
              f"cluster {label}: {st['migrations']} migrations of "
              f"{st['migration_bytes']} B for {st['handovers']} handovers "
              f"and snapshots {snaps}")
    ratio = q8["migration_bytes"] / max(mig["migration_bytes"], 1)
    check(q8["migrations"] == mig["migrations"]
          and ratio <= QUANT_SNAPSHOT_RATIO,
          f"cluster: 8-bit snapshots ship {ratio:.4f} of the raw bytes "
          f"(limit {QUANT_SNAPSHOT_RATIO})")
    trace = runs["migrate"]["tel"].trace.chrome_trace()["traceEvents"]
    lanes = {e["args"]["name"]: e["pid"] for e in trace if e["ph"] == "M"}
    names = {(e["name"], e["pid"]) for e in trace if e["ph"] != "M"}
    check({"cluster", "replica0", "replica1"} <= set(lanes)
          and ("migrate_send", lanes["cluster"]) in names
          and ("migrate_inject", lanes["cluster"]) in names
          and any(n == "window_dispatch" and p == lanes["replica1"]
                  for n, p in names),
          f"cluster: trace lanes {lanes}, events {sorted(names)[:20]}")
    out = {"phase": "cluster", "arch": cfg.name, "dtype": cfg.dtype,
           "replicas": 2, "n_slots": 4, "requests": CLUSTER_REQUESTS,
           "single_engine_s": base_s, "tokens_equal_single_engine": True,
           "snapshot_ratio_q8": ratio, "card": smi}
    for label, r in runs.items():
        st = r["stats"]
        dec = st["decode_tokens"]
        lat = r["tel"].registry.latency_summary(
            "engine.ttft_s", "engine.intertoken_s",
            "cluster.migration_backhaul_s")
        out[label] = {
            "seconds": r["seconds"], "decode_tok_per_s": dec / r["seconds"],
            "decode_ticks": r["calls"]["ticks"],
            "graphs": r["calls"]["graphs"],
            "prefill_dispatches": r["calls"].get("split_prefill_mixed", 0),
            "launches": r["calls"]["launches"], "latency_ms": lat,
            **{k: st[k] for k in (
                "handovers", "migrations", "migration_bytes",
                "migration_transfer_s", "replays", "replayed_tokens",
                "deadline_miss_rate", "decode_wire_bytes_per_token",
                "mean_handover_latency_ticks")},
            "device_tel": r["device_tel"],
            "bytes_per_migration": st["migration_bytes"]
            / max(st["migrations"], 1)}
    emit(out)
    del runs, base, base_eng, params
    free_cuda()
    return by_path


def phase_fleet(cfg, dev, smi: str) -> dict:
    """``launch.serve --engine fleet`` at full width: 64 UEs on one
    FleetChannel of Lumos5G traces, Poisson arrivals, SLO admission and
    the autoscaler; every submitted request is finished or rejected."""
    from repro_torch.launch import serve
    calls: dict = {}
    with counted_path(calls):
        summary = serve.main(FLEET_ARGV + ["--device", str(dev)])
    cons = summary["conservation"]
    terminal = (cons["finished"] + cons["queue_rejected_router"]
                + cons["queue_rejected_engine"] + cons["over_capacity"]
                + cons["slo_rejected"])
    check(cons["submitted"] == 64 and cons["in_flight"] == 0
          and terminal == cons["submitted"]
          and summary["requests_finished"] + summary["slo_rejected"]
          + summary["requests_rejected"] == 64,
          f"fleet: requests not conserved {cons}")
    check_path_launches(calls, cfg, "fleet")
    emit({"phase": "fleet", "arch": cfg.name, "argv": FLEET_ARGV,
          "seconds": summary["seconds"],
          "decode_tok_per_s": summary["decode_tok_per_s"],
          "requests_finished": summary["requests_finished"],
          "slo_rejected": summary["slo_rejected"],
          "admission": summary["admission"],
          "scale_events": summary["scale_events"],
          "n_replicas": summary["n_replicas"],
          "session_slo_miss_rate": summary["session_slo_miss_rate"],
          "conservation": cons, "latency_ms": summary.get("latency"),
          "decode_ticks": calls["ticks"], "graphs": calls["graphs"],
          "launches": calls["launches"], "card": smi})
    free_cuda()
    return calls["launches"]


def phase_serving_benches(cfg, dev, smi: str) -> dict:
    """The three serving benches at full width with small arguments, each
    with its launches counted; prints each one's JSON sections."""
    from repro_torch.benchmarks import bench_cluster, bench_fleet, \
        bench_serving
    trace = ROOT / "build" / "bench_serving_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    by_path = {}
    for name, main, argv in (
            ("bench_serving", bench_serving.main,
             BENCH_SERVING_ARGV + ["--trace-out", str(trace)]),
            ("bench_cluster", bench_cluster.main, BENCH_CLUSTER_ARGV),
            ("bench_fleet", bench_fleet.main, BENCH_FLEET_ARGV)):
        calls: dict = {}
        t0 = time.perf_counter()
        with counted_path(calls):
            out = main(argv + ["--device", str(dev)])
        check_path_launches(calls, cfg, name, exact=name != "bench_serving")
        if name == "bench_fleet":
            assert out["autoscale_ab"]["autoscaled"]["scale_ups"] >= 1, \
                "the autoscaler A/B never scaled up"
        by_path[name] = calls["launches"]
        emit({"phase": "serving_bench", "bench": name, "argv": argv,
              "seconds": time.perf_counter() - t0,
              "decode_ticks": calls["ticks"], "graphs": calls["graphs"],
              "launches": calls["launches"], **out, "card": smi})
        free_cuda()
    return by_path


def phase_scale_out(dev, smi: str) -> dict:
    """Phase 13: scale-out serving at full width (qwen2.5-3b): the cluster,
    the fleet, the serving benches. Returns the launches of each path."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    by_path = phase_cluster(cfg, dev, smi)
    by_path["qwen2.5-3b fleet"] = phase_fleet(cfg, dev, smi)
    by_path.update(phase_serving_benches(cfg, dev, smi))
    emit({"phase": "scale_out", "seconds": time.perf_counter() - t0})
    return by_path


# ---------------------------------------------------------------------------
# phase 14: the frontend archs, the int8 KV cache, the bank-free engine
# ---------------------------------------------------------------------------

def frontend_kernels(cap, cfg, dev, seed: int, iters: int) -> dict:
    """The kernels at a frontend arch's full-width shapes, on its capture:
    the boundary at 4 rows, the 64-row prefill dispatch and 512 rows, each
    row bit-identical alone and in its pool, with the plan's tile
    (llava-next-34b's d 7168 / W 1792 takes ``mt`` 1 at every row count;
    musicgen-large's bank has two heads, W 512 and 128, so modes 0, 1 and
    2 mix in its prefill pool); the tail at llava-next-34b's [7168, 64000]
    head (musicgen-large's codebook heads launch none); paged attention at
    head_dim 128 / GQA group 7 and 64 / 1, in both forms. Emits one line
    and returns it."""
    from repro_torch.core import bottleneck
    out = {"phase": "kernels_at_arch", "arch": cfg.name,
           "head_dim": cfg.head_dim,
           "gqa_group": cfg.n_heads // cfg.n_kv_heads,
           "bank": [list(w) for w in bottleneck.mode_widths(cfg.split)],
           "boundary_mixed_grouped": dense_boundary(cap, cfg, dev, seed,
                                                    iters)}
    if cfg.name == "llava-next-34b":
        mts = [r["mt"] for r in out["boundary_mixed_grouped"]["cases"]]
        check(mts == [1, 1, 1], f"boundary {cfg.name}: tiles {mts}, the "
                                f"plan gives mt 1 at d 7168 / W 1792")
    if tails_per_step(cfg):
        out["decode_tail_grouped"] = dense_tail(cap, cfg, dev, seed, iters)
    paged = phase_paged(cap, cfg, dev, seed, iters, f32_long=False)
    check(paged["long"]["pages_per_split"] < paged["long"]["nb"],
          f"paged {cfg.name}: the long shape ran one range")
    out["paged_attention"] = {k: paged[k] for k in (
        "timed_shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "long", "max_abs_err")}
    emit(out)
    return out


def vision_prefill(params, cfg, dev, seed: int) -> dict:
    """``T.prefill`` at full width on the paged arena with a [2, 576, d]
    bf16 vision prefix (from the seed) and 16 Markov text tokens: 592
    positions, 74 pages a row; its last-position logits against
    ``T.forward(embeddings=)``'s within ``TOL["vision_prefill"]``; then 8
    decode steps through the fused tail on the arena, whose paged
    attention runs the split form, their launches counted."""
    import torch

    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.kernels.paged_attention import pages_per_split_for
    from repro_torch.models import transformer as T
    B, text, steps, plen = 2, 16, 8, 8
    S = cfg.n_vision_tokens + text
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    emb = torch.randn((B, cfg.n_vision_tokens, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    toks = torch.from_numpy(MarkovTokenSource(cfg, seed=7).batch(
        B, text)["tokens"]).to(dev)
    nb = -(-(S + steps) // plen)            # the prompt's pages + decode's
    bt = torch.arange(1, B * nb + 1, dtype=torch.int32,
                      device=dev).reshape(B, nb)
    arena = T.init_decode_state(cfg, B * nb + 1, plen, device=dev)
    fns = zero_counts()
    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        logits, _ = T.prefill(params, toks, cfg, arena, embeddings=emb,
                              block_table=bt)
        sync(dev)
        prefill_s = time.perf_counter() - t0
        prefill_launches = {k: f.launches for k, f in fns.items()}
        seen: list = []
        with recording(T, "lm_logits", seen):
            full, _ = T.forward(params, toks, cfg, embeddings=emb)
        want = full[:, -1].clone()
        del full
        got = logits[:, 0]
        xn = seen[0][1][:, -1]              # the forward's normed last row
        del seen
        w = params["lm_head"]["w"]
        d = cfg.d_model
        env = (2.0 ** -7 + 2 * d * 2.0 ** -24) * (
            xn.abs().float() @ w.abs().float())
        err = (got - want).abs()
        ratio = float((err / env).max())
        top2 = torch.topk(want, 2, dim=-1).values
        gap = ((top2[:, 0] - top2[:, 1])
               / want.abs().amax(-1)).cpu().tolist()
        same = (got.argmax(-1) == want.argmax(-1)).cpu().tolist()
        check(ratio <= 1.0 and bool(torch.isfinite(got).all())
              and all(s or g < TOL["tail_rel_gap"]
                      for s, g in zip(same, gap)),
              f"vision prefill: logits {float(err.max())} off the forward's "
              f"(worst envelope ratio {ratio:.3f}), argmax equal {same} at "
              f"top-two gaps {gap}")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        pps = pages_per_split_for(B, cfg.n_kv_heads, nb, sms)
        check(pps < nb, f"vision decode: {nb} pages ran one range")
        tok = got.argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((B,), S, dtype=torch.int32, device=dev)
        fns = zero_counts()
        out_toks = []
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, _ = T.decode_step(params, tok, arena, pos, cfg,
                                   return_tokens=True, block_table=bt)
            out_toks.append(tok)
            pos = pos + 1
        sync(dev)
        step_ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {k: f.launches for k, f in fns.items()}
    expect = {k: 0 for k in fns}
    expect["decode_tail_grouped"] = steps
    expect["paged_attention"] = cfg.n_layers * steps
    check(launches == expect, f"vision decode: launches {launches}, "
                              f"expected {expect}")
    gen_toks = torch.cat(out_toks, dim=-1).cpu().tolist()
    check(all(0 <= v < cfg.vocab_size for r in gen_toks for v in r),
          "vision decode: tokens out of the vocabulary")
    del arena, env, xn
    out = {"phase": "vision_prefill", "arch": cfg.name,
           "shape": {"B": B, "vision": cfg.n_vision_tokens, "text": text,
                     "positions": S, "pages_a_row": -(-S // plen)},
           "tolerance": TOL["vision_prefill"],
           "logit_max_abs_err": float(err.max()),
           "envelope_ratio": ratio, "argmax_equal": same,
           "top_two_gap": gap, "prefill_s": prefill_s,
           "prefill_launches": prefill_launches,
           "decode_ms_a_step": step_ms, "decode_launches": launches,
           "pages_per_split": pps, "table_width": nb, "tokens": gen_toks}
    emit(out)
    return out


def gap_engine(gaps: dict, engines: list):
    """The continuous engine recording each decode tick's top-two logit
    gap, over the largest |logit|, by (tick, slot) into ``gaps`` (for the
    logits + argmax window, ``fused_tail=False``); each engine built is
    appended to ``engines``."""
    import torch

    from repro_torch.serving.batcher import ContinuousBatchingEngine

    class GapEngine(ContinuousBatchingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

        def _run_window(self, modes_k, width):
            self._gap_tick = self.tick
            return super()._run_window(modes_k, width)

        def _decode(self, tok, positions, modes, bt, return_tokens):
            out = super()._decode(tok, positions, modes, bt, return_tokens)
            lg = out.reshape(out.shape[0], -1).float()
            top = torch.topk(lg, 2, dim=-1).values
            g = (top[:, 0] - top[:, 1]) / lg.abs().amax(-1)
            gaps[self._gap_tick] = g.cpu().tolist()
            self._gap_tick += 1
            return out
    return GapEngine


def bank_free_runs(params, cfg, smi: str) -> dict:
    """The continuous engine at full width on a bank-free view of
    ``params`` (no copy), through ``serve.run_continuous`` with the main
    path's arguments: fused (a tick launches no boundary, one tail and one
    paged attention a layer) and with ``fused_tail=False`` (no tail: the
    logits + argmax chain), counters at 0 just before each. The unfused
    run's tokens must equal the fused run's request by request, or part
    first at a near tie (top-two gap under ``TOL["tail_rel_gap"]`` of the
    largest |logit|). The fused run's windows replay graphs, and its
    tokens equal a host loop's bit for bit (``host_loop_oracle``).
    Returns each run's launches."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    view = bank_free(params)
    args = serve.parser().parse_args(SERVE[cfg.name] + ["--device", "cuda"])
    by_path, runs, gaps, engines = {}, {}, {}, []
    for label, kw in (("fused", {}), ("unfused", {"fused_tail": False})):
        fns = zero_counts()
        calls: dict = {}
        cls = gap_engine(gaps, engines) if kw else None
        with serve_engine(cls, **kw), counting(T, "prefill", calls), \
                counting(T, "decode_step", calls), graph_tally(calls):
            summary = serve.run_continuous(args, cfg, view)
        launches = {k: f.launches for k, f in fns.items()}
        ticks = graphed_steps(calls, "decode_step")
        if label == "fused":
            check_graphed(calls, "bank-free fused", "decode_step")
        check(summary["requests_finished"] == 8
              and set(summary["mode_counts"]) == {0},
              f"bank-free {label}: {summary['requests_finished']} of 8 "
              f"finished, modes {summary['mode_counts']}")
        expect = {k: 0 for k in fns}
        expect["decode_tail_grouped"] = ticks if label == "fused" else 0
        expect["paged_attention"] = cfg.n_layers * ticks
        check(ticks > 0 and launches == expect,
              f"bank-free {label}: launches {launches} for {ticks} ticks, "
              f"expected {expect}")
        runs[label] = summary
        by_path[f"{cfg.name} bank-free {label}"] = launches
        emit({"phase": "bank_free", "arch": cfg.name, "tail": label,
              "requests_finished": summary["requests_finished"],
              "decode_ticks": summary["decode_ticks"],
              "decode_tok_per_s": summary["decode_tok_per_s"],
              "seconds": summary["seconds"], "launches": launches,
              "prefills": calls.get("prefill", 0), "decode_steps": ticks,
              "graphs": calls["graphs"], "card": smi})
    eng = engines[-1]
    slot_of = {s.request.rid: (s.admitted_tick, s.slot)
               for s in eng.finished}
    parted = {}
    for rid, want in runs["fused"]["tokens"].items():
        got = runs["unfused"]["tokens"][rid]
        i = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if i is None:
            continue
        t0, slot = slot_of[rid]
        gap = gaps[t0 + i - 1][slot] if i else None
        parted[rid] = {"index": i, "top_two_gap": gap}
        check(gap is not None and gap < TOL["tail_rel_gap"],
              f"bank-free: request {rid}'s unfused tokens part from the "
              f"fused ones at index {i}, top-two gap {gap}")
    emit({"phase": "unfused_oracle", "arch": cfg.name,
          "requests": len(runs["fused"]["tokens"]),
          "requests_equal": len(runs["fused"]["tokens"]) - len(parted),
          "parted_at_near_ties": parted})
    host_loop_oracle(SERVE[cfg.name] + ["--device", "cuda"], cfg,
                     "bank-free", runs["fused"]["tokens"], view)
    return by_path


@contextlib.contextmanager
def routes(tape: list, replay: bool = False):
    """``models.moe.route`` while the block runs: each call's result is
    appended to ``tape``, or with ``replay`` the calls return ``tape``'s
    results in order instead of routing (the recorded run's experts,
    slots and gates), each for a call on the same tokens' shape, and the
    block must make as many calls as the tape holds."""
    from repro_torch.models import moe
    orig = moe.route
    played = iter(tape) if replay else None

    def route(router_w, xg, *args):
        if played is not None:
            out = next(played, None)
            check(out is not None and out[1].shape[:2] == xg.shape[:2],
                  f"routes: a call on tokens {tuple(xg.shape[:2])} where "
                  f"the tape holds "
                  f"{None if out is None else tuple(out[1].shape[:2])}")
            return out
        out = orig(router_w, xg, *args)
        tape.append(out)
        return out

    moe.route = route
    try:
        yield tape
    finally:
        moe.route = orig
    if played is not None:
        check(next(played, None) is None,
              "routes: the block made fewer routing calls than the tape "
              "holds")


def pinned_boundary(pin):
    """``bottleneck.boundary_mixed`` in its plain version (the arithmetic
    of ``kernels.ref.boundary_mixed_ref``, every row's codes exposed) with
    the codes passed through ``pin``."""
    import torch

    from repro_torch.kernels import ref

    def boundary(stacked, x, mode_idx, *, dtype=torch.bfloat16, mesh=None):
        M = stacked["width"].shape[0]
        hid = torch.clamp(mode_idx.long() - 1, 0, M - 1)
        h = ref._rms(x.float()) * stacked["norm_scale"][hid][:, None,
                                                             :].float()
        z = torch.einsum("bsd,bdw->bsw", h.to(x.dtype),
                         stacked["down_w"][hid]).float()
        lane = torch.arange(z.shape[-1], device=x.device)
        z = torch.where(lane[None, None, :]
                        < stacked["width"][hid][:, None, None], z, 0.0)
        bits = stacked["bits"][hid][:, None, None]
        qm = torch.clamp(torch.bitwise_left_shift(
            torch.ones_like(bits), torch.clamp(bits, min=1) - 1) - 1,
            min=1).float()
        scale = torch.clamp(torch.amax(torch.abs(z), dim=-1, keepdim=True),
                            min=1e-8) / qm
        q = pin(torch.maximum(torch.minimum(torch.round(z / scale), qm),
                              -qm))
        wired = torch.where(bits == 0, z, q * scale)
        y = torch.einsum("bsw,bwd->bsd", wired.to(dtype),
                         stacked["up_w"][hid])
        return torch.where(mode_idx[:, None, None] == 0, x, y.to(x.dtype))

    return boundary


@contextlib.contextmanager
def codes(tape: list, replay: bool = False):
    """The wire's integer codes while the block runs: each code tensor the
    boundary makes (``quant.quantize``: the sync engine's wire, the
    trainer's straight-through boundary; the continuous engine's boundary
    in its plain version, ``pinned_boundary``) is appended to ``tape`` as
    int8, or with ``replay`` replaced by ``tape``'s in order, each for a
    call of the same shape, the scales staying the run's own. One
    device's codes replayed on a mesh take out the discrete step a
    reassociation flips at a rounding edge, as ``routes`` does for MoE
    routing; the block must make as many calls as the tape holds."""
    import torch

    from repro_torch.core import bottleneck, quant
    played = iter(tape) if replay else None

    def pin(q):
        if played is None:
            tape.append(q.to(torch.int8, copy=True))
            return q
        out = next(played, None)
        check(out is not None and out.shape == q.shape,
              f"codes: a call on {tuple(q.shape)} where the tape holds "
              f"{None if out is None else tuple(out.shape)}")
        return out.to(q.dtype)

    orig = quant.quantize

    def quantize(x, bits: int = 8):
        q, scale = orig(x, bits)
        return (q, scale) if bits == 0 else (pin(q), scale)

    with patched(quant, "quantize", quantize), \
            patched(bottleneck, "boundary_mixed", pinned_boundary(pin)):
        yield tape
    if played is not None:
        check(next(played, None) is None,
              "codes: the block made fewer quantizing calls than the tape "
              "holds")


def int8_cache(params, cfg, dev, seed: int) -> dict:
    """The int8 rolling cache at full width (musicgen-large: full MHA, the
    larger state a token of the two frontend archs; mixtral-8x7b, whose
    window is the reference's MoE int8 case) against bf16: batch 8,
    ``cache_len`` 1024, 10 decode steps from position 0 on the same tokens
    (bf16's greedy ones), with ``tests/test_kv_quant.py``'s bounds: state
    bytes under ``KV8_BYTES``, greatest relative logit error (the norm of
    the difference over the norm) under ``KV8_LOGIT_REL``
    (``KV8_LOGIT_REL_MOE`` for MoE), greedy agreement at least
    ``KV8_AGREE``; ms a step of each.

    MoE: int8 noise flips expert choices, and a flipped choice swaps a
    token's whole MLP output, so on random full-width weights the greedy
    agreement is the routing's, not the cache's (mixtral at 24 layers on
    an H100 80GB HBM3 at 700 W: 65 of 80). The free int8 run is held to
    the MoE bound on the logits and its agreement printed; a third run on
    the int8 cache replays the bf16 run's routes (``routes``), which takes
    the discontinuity out, and is held to the dense bounds
    (``KV8_LOGIT_REL``, ``KV8_AGREE``)."""
    import torch

    from repro_torch.models import transformer as T
    B, clen, steps = 8, 1024, 10
    runs = (0, 8, "pinned") if cfg.is_moe else (0, 8)
    st = {r: T.init_decode_state(cfg, B, clen, device=dev,
                                 kv_bits=0 if r == 0 else 8) for r in runs}
    nbytes = {bits: sum(a.numel() * a.element_size()
                        for a in T.tree_leaves(st[bits])) for bits in (0, 8)}
    ratio = nbytes[8] / nbytes[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    shape = (B, cfg.n_codebooks, 1) if tails_per_step(cfg) == 0 else (B, 1)
    tok = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev,
                        dtype=torch.int32)
    ms = {0: [], 8: []}
    rel = {r: 0.0 for r in runs[1:]}
    agree = {r: 0 for r in runs[1:]}
    total = 0
    with torch.no_grad():
        for i in range(steps):
            out, tape = {}, []
            for r in runs:
                ctx = (routes(tape, replay=r == "pinned") if cfg.is_moe
                       and r != 8 else contextlib.nullcontext())
                sync(dev)
                t0 = time.perf_counter()
                with ctx:
                    out[r], _ = T.decode_step(params, tok, st[r], i, cfg)
                sync(dev)
                if r in ms:
                    ms[r].append((time.perf_counter() - t0) * 1e3)
            lf = out[0].float()
            for r in runs[1:]:
                lq = out[r].float()
                rel[r] = max(rel[r], float(torch.linalg.vector_norm(lf - lq)
                                           / torch.linalg.vector_norm(lf)))
                agree[r] += int((lf.argmax(-1) == lq.argmax(-1)).sum())
            total += lf.argmax(-1).numel()
            tok = lf.argmax(-1).to(torch.int32).reshape(tok.shape)
    del st
    rel_max = KV8_LOGIT_REL_MOE if cfg.is_moe else KV8_LOGIT_REL
    held = "pinned" if cfg.is_moe else 8
    check(ratio < KV8_BYTES and rel[8] < rel_max and rel[held] < KV8_LOGIT_REL
          and agree[held] >= KV8_AGREE * total,
          f"int8 cache: bytes {ratio:.4f} of bf16, relative logit error "
          f"{rel}, greedy tokens agreeing {agree} of {total}")
    out = {"phase": "int8_cache", "arch": cfg.name, "batch": B,
           "cache_len": clen, "n_layers": cfg.n_layers, "steps": steps,
           "max_rel_logit_err_limit": rel_max, "state_bytes": nbytes[0],
           "state_bytes_int8": nbytes[8], "bytes_ratio": ratio,
           "max_rel_logit_err": rel[8], "greedy_agree": agree[8],
           "greedy_total": total,
           "ms_a_step": statistics.median(ms[0][1:]),
           "ms_a_step_int8": statistics.median(ms[8][1:])}
    if cfg.is_moe:
        out["routes_pinned"] = {"max_rel_logit_err": rel["pinned"],
                                "greedy_agree": agree["pinned"]}
    emit(out)
    return out


def phase_frontends(dev, seed: int, iters: int, smi: str) -> dict:
    """Phase 14: musicgen-large and llava-next-34b at full width, one model
    on the card at a time. Each: captured, its kernels at its shapes
    (``frontend_kernels``); musicgen-large's int8 cache; llava-next-34b's
    vision prefill and its bank-free engine, fused and unfused, on the
    captured weights; then freed, and the reduced f32 references (both
    engines; the bank-free and unfused continuous forms), the main paths
    on both engines through ``launch.serve.main`` and their profiles.
    Returns the launches of each path."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    by_path = {}
    for name in FRONTENDS:
        cfg = get_config(name)
        t1 = time.perf_counter()
        cap = capture(cfg, dev, seed)
        emit({"phase": "capture", "arch": name,
              "seconds": time.perf_counter() - t1,
              "lengths": [int(n) for n in cap["lens"]]})
        frontend_kernels(cap, cfg, dev, seed, iters)
        params = cap["params"]
        del cap
        free_cuda()
        if tails_per_step(cfg):
            vision_prefill(params, cfg, dev, seed)
            free_cuda()
            by_path.update(bank_free_runs(params, cfg, smi))
        else:
            int8_cache(params, cfg, dev, seed)
        del params
        free_cuda()
        phase_reference(name, forms=True)
        phase_sync_reference(name)
        for engine, main_path in (("continuous", phase_main_path),
                                  ("sync", phase_sync_main_path)):
            kept: dict = {}
            by_path[f"{name} {engine}"] = main_path(cfg, smi, kept=kept)
            phase_profile(cfg, engine, kept.pop("engine"))
            free_cuda()
    emit({"phase": "frontends", "seconds": time.perf_counter() - t0})
    return by_path


# ---------------------------------------------------------------------------
# phase 15: mixture of experts
# ---------------------------------------------------------------------------

#: layers served of each MoE arch's 32: its bf16 weights at 32 layers (83.7
#: and 93.4 GB) do not fit the 80 GB card, so the depth is cut (PERF.md
#: section 4) and every width, expert and k is kept; split_at 16 stays
MOE_LAYERS = {PHI: 26, MIXTRAL: 24}
#: the MoE train steps: phi3.5-moe at full width, 2 layers, split at 1,
#: batch [4, 128]; two steps of Algorithm 1's phase 1, one of phase 2
MOE_TRAIN = {"layers": 2, "split_at": 1, "batch": 4, "seq": 128,
             "steps": (2, 1)}


def moe_config(name: str, layers: int = 0, split_at: int = 0):
    """The arch's full config cut to ``layers`` (default ``MOE_LAYERS``),
    and its split moved to ``split_at`` when given."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, n_layers=layers or MOE_LAYERS[name])
    if split_at:
        cfg = dataclasses.replace(cfg, split=dataclasses.replace(
            cfg.split, split_at=split_at))
    return cfg


def memory_line(dev, cfg) -> dict:
    """The device memory of a model's run (its capture, kernels and
    served paths): the weights' bytes, the peak allocated and reserved
    since the last reset, and what the card had free at that reserved
    peak."""
    import torch
    total = torch.cuda.get_device_properties(dev).total_memory
    out = {"phase": "memory", "arch": cfg.name,
           "n_layers": cfg.n_layers, "params": cfg.param_count(),
           "weight_bytes": 2 * cfg.param_count(), "total_bytes": total,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev),
           "free_at_peak_bytes": total - torch.cuda.max_memory_reserved(dev)}
    emit(out)
    return out


def moe_tail(cap, cfg, dev, seed: int, iters: int) -> dict:
    """The decode tail at an MoE arch's untied head ([4096, 32064]:
    250 whole 128-column slabs and one of 64 columns, whose lanes past V
    the kernel masks; [4096, 32000]: whole slabs): ``dense_tail``'s pools
    of 1, 4, 8 and 13 rows in place, its exact tie and its timing at 4
    rows with the bound; 4 real rows of a 16-row block; and the last
    column made the argmax of a pool's first row (twice the top token's
    column), which the kernel must find in the last slab. Emits one line
    and returns it."""
    from repro_torch.kernels import ref
    params = cap["params"]
    head = params["lm_head"]["w"][None]
    V = head.shape[2]
    tail = dense_tail(cap, cfg, dev, seed, iters)
    scale = params["final_norm"]["scale"]
    tail_block_cases(cap["x_dec"], cap["valid"], head, scale, seed + 31,
                     tail["cases"])
    x = pick_rows(cap["x_dec"], cap["valid"], 8, seed + 33)
    top = int(ref.decode_tail_ref(x, scale, None, head)[0, 0])
    xn = ref._final_norm(x.float(), scale, None, cfg.norm).to(x.dtype)
    logit = float(xn[0, 0].float() @ head[0, :, top].float())
    last = head.clone()       # a power of two scales the logit exactly
    last[0, :, V - 1] = head[0, :, top] * (2.0 if logit > 0 else 0.5)
    diff, _ = check_tail(x, scale, last, f"{cfg.name} last column",
                         expect=V - 1)
    del last
    tail["cases"].append({"case": "bfloat16 last column the argmax",
                          "expected": V - 1, "tokens_differing": diff})
    out = {"phase": "kernels_at_arch", "arch": cfg.name,
           "n_layers": cfg.n_layers, "head": [cfg.d_model, V],
           "slabs": [V // 128, V % 128], "decode_tail_grouped": tail}
    emit(out)
    return out


def moe_train(dev, seed: int, smi: str) -> dict:
    """Algorithm 1's transformer steps on phi3.5-moe at full width
    (``MOE_TRAIN``): donated cascade steps of phase 1 (mode 0, the bank
    frozen) then phase 2 (mode 1, only the bank's head), every kernel
    counter at 0 just before and read just after (none of the six kernels
    is on the training path). Gates: each step's loss, lm loss and aux
    finite, the aux (the layers' summed load-balance loss) within (0,
    layers * E], no launch. The second phase-1 step is profiled (busy ms,
    idle share, the top device kernels); ms a step and the peak memory
    printed. Returns the launches."""
    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import cascade as C
    from repro_torch.core import split as SP
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.launch import serve
    from repro_torch.training import loop as L
    from repro_torch.training import optimizer as opt
    from torch.profiler import ProfilerActivity, profile
    t = MOE_TRAIN
    cfg = moe_config(PHI, t["layers"], t["split_at"])
    torch.cuda.reset_peak_memory_stats(dev)
    params = SP.init_split_params(
        torch.Generator(device=dev).manual_seed(seed), cfg)
    state = opt.init(params)
    src = MarkovTokenSource(cfg, seed=0)
    fns = zero_counts()
    steps, prof_out = [], None
    for phase, n in zip((1, 2), t["steps"]):
        loss = L.make_loss_fn(cfg, mode=phase - 1)
        step = C.make_train_step(lambda p, b, _: loss(p, b), TrainConfig(),
                                 donate=True)
        mask = C.transformer_phase_mask(params, phase)
        for i in range(n):
            batch = L.device_batch(src.batch(t["batch"], t["seq"],
                                             len(steps)), dev)
            traced = phase == 1 and i == 1
            prof = (profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
                    if traced else contextlib.nullcontext())
            sync(dev)
            t0 = time.perf_counter()
            with prof:
                params, state, m = step(params, state, batch, mask,
                                        mode=phase - 1)
                sync(dev)
            secs = time.perf_counter() - t0
            if traced:
                prof_out = serve.profile_summary(prof, secs)
            rec = {k: float(m[k]) for k in ("loss", "lm_loss", "aux_loss")}
            steps.append({"phase": phase, "ms": secs * 1e3,
                          "profiled": traced, **rec})
    launches = {k: f.launches for k, f in fns.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    del params, state
    free_cuda()
    aux_max = t["layers"] * cfg.n_experts
    check(all(math.isfinite(r[k]) for r in steps
              for k in ("loss", "lm_loss", "aux_loss")),
          f"moe train: a loss is not finite: {steps}")
    check(all(0 < r["aux_loss"] <= aux_max for r in steps),
          f"moe train: an aux loss outside (0, {aux_max}]: {steps}")
    check(not any(launches.values()),
          f"moe train: the training path launched {launches}")
    emit({"phase": "moe_train", "arch": PHI, **t,
          "params": cfg.param_count(), "n_experts": cfg.n_experts,
          "experts_per_tok": cfg.experts_per_tok, "step_records": steps,
          "peak_memory_bytes": peak, "launches": launches,
          "profile_phase1_step": prof_out, "card": smi})
    return launches


def phase_moe(dev, seed: int, iters: int, smi: str) -> dict:
    """Phase 15: phi3.5-moe-42b-a6.6b (paged pool) and mixtral-8x7b (its
    4096-token window: the dense rolling pool) at full width and cut depth
    (``MOE_LAYERS``), one model on the card at a time. Each: the reduced
    f32 references of both engines (card against CPU, under the near-tie
    rule); captured (the weights the main paths then serve); the tail at
    its [4096, V] head (``moe_tail``); mixtral's int8 rolling cache; the
    main paths on both engines through the launcher's runners, with their
    launches, and their profiles; the memory at the model's peak
    (``memory_line``); freed. Then the MoE train steps (``moe_train``).
    Returns the launches of each path."""
    import torch
    t0 = time.perf_counter()
    by_path = {}
    for name in MOE:
        phase_reference(name)
        phase_sync_reference(name)
        cfg = moe_config(name)
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        cap = capture(cfg, dev, seed)
        emit({"phase": "capture", "arch": name, "n_layers": cfg.n_layers,
              "seconds": time.perf_counter() - t1,
              "lengths": [int(n) for n in cap["lens"]]})
        moe_tail(cap, cfg, dev, seed, iters)
        params = cap["params"]
        del cap
        free_cuda()
        if name == MIXTRAL:
            int8_cache(params, cfg, dev, seed)
            free_cuda()
        for engine, main_path in (("continuous", phase_main_path),
                                  ("sync", phase_sync_main_path)):
            kept: dict = {}
            by_path[f"{name} {engine}"] = main_path(cfg, smi, params, kept)
            phase_profile(cfg, engine, kept.pop("engine"))
            free_cuda()
        memory_line(dev, cfg)
        del params
        free_cuda()
    by_path[f"{PHI} train"] = moe_train(dev, seed, smi)
    emit({"phase": "moe", "seconds": time.perf_counter() - t0})
    return by_path


# ---------------------------------------------------------------------------
# phase 16: the serving mesh
# ---------------------------------------------------------------------------

#: the one-device runs of the main paths, by path label: the continuous
#: engine's tokens by request, the sync engine's generated rows (phases 7
#: and 9); phase 16 holds its mesh runs to them
MAIN_RUNS: dict = {}
#: every rank of phase 16's gloo runs on the one card, as does its
#: one-device run of the mp check
MESH_GLOO = ["--dist-backend", "gloo", "--device", "cuda:0"]
MESH_ONE = ["--device", "cuda:0"]
MESH_CLUSTER = ["--arch", "qwen2.5-3b", "--engine", "cluster", "--replicas",
                "2", "--requests", "8", "--prompt-len", "16", "--gen", "16",
                "--n-slots", "4", "--placement", "best-channel",
                "--handover", "migrate"]
#: ``bench_serving --slot-scaling 1,2`` cut to one load level of 2
#: requests of 4 tokens and no engine or telemetry A/B
MESH_BENCH = ["--arch", "qwen2.5-3b", "--loads", "8", "--requests", "2",
              "--gen", "4", "--compare-slots", "0", "--overhead-repeats", "0",
              "--prefill-prompt-len", "16", "--slot-scaling", "1,2"]
#: the reference bench gate's floor on a dp > 1 row's tok/s over dp 1's
#: (tools/check_bench.py, SHARD_FLOOR)
SHARD_FLOOR = 0.1
#: mp (1, 2) against one device, bf16 at full width: each live row's
#: logits within this share of the row's largest |logit| (each of the 72
#: row-split outputs of qwen2.5-3b's 36 layers rounds its two bf16 partial
#: sums where one device rounds one, and the residual stream carries it:
#: a 36-layer bf16 model at d 512 showed 3.1% on the CPU, this is about
#: twice that); a token may part from one device's only where that
#: engine's top-two gap is within twice this share (both sides within it)
TOL["mp_logit_rel"] = 2.0 ** -4
#: seconds a phase 16 rank waits in a collective before it gives up
MESH_TIMEOUT = 600


def taped_engine():
    """The continuous engine recording each unfused step's live slots (by
    request) and the float32 logits of every row it decodes, and each
    request's prefill logits (``prefill``, by request), without warm-up
    (the check reads values, not times)."""
    from repro_torch.core import split as SP
    from repro_torch.serving import ContinuousBatchingEngine

    class Taped(ContinuousBatchingEngine):
        last = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.tape = []
            self.prefill = {}
            Taped.last = self

        def warm(self, prompt, gen: int = 2):
            self.reset_counters()

        def _prefill_group(self, blen, group):
            logits = []
            orig = SP.split_prefill_mixed

            def prefill(*a, **kw):
                out = orig(*a, **kw)
                logits.append(out[0])
                return out

            with patched(SP, "split_prefill_mixed", prefill):
                out = super()._prefill_group(blen, group)
            for i, item in enumerate(group):        # (request, slot, ...)
                self.prefill[item[0].rid] = logits[0][i, 0].float()
            return out

        def _decode(self, tok, positions, modes, bt, return_tokens):
            out = super()._decode(tok, positions, modes, bt, return_tokens)
            if not return_tokens:
                self.tape.append(
                    ({s: x.request.rid for s, x in self.active.items()},
                     out[:, 0].float()))
            return out

    return Taped


def mp_against_one_device(base, got) -> dict:
    """The mp rule (``TOL["mp_logit_rel"]``) on two taped engines: the
    same schedule and accounting, each request's prefill logits and each
    live row's logits within the tolerance until its request's stream
    parts, and a stream parting only at a near tie: where one device's
    top-two gap, in the logits that chose the token (the prefill's for
    the first), is within twice that share, as the sync engine's rule
    (``mp_sync_against_one_device``) reads its prefill row."""
    want = {s.request.rid: s for s in base.finished}
    have = {s.request.rid: s for s in got.finished}
    check(set(want) == set(have) and len(want) == 8,
          f"mp (1, 2): {len(have)} requests finished, one device {len(want)}")
    tol = TOL["mp_logit_rel"]
    worst, rows, gaps = 0.0, 0, []

    def near_tie(a, what: str) -> None:
        top = float(a.abs().max())
        two = a.topk(2).values
        gaps.append(float(two[0] - two[1]) / max(top, 1e-30))
        check(gaps[-1] <= 2 * tol,
              f"mp (1, 2): {what} where one device's top-two gap is "
              f"{gaps[-1]:.4g} of the largest logit (limit {2 * tol}; "
              f"the rows so far within {worst:.4g})")

    for rid in want:
        a, b = base.prefill[rid], got.prefill[rid]
        top = float(a.abs().max())
        worst = max(worst, float((a - b).abs().max()) / max(top, 1e-30))
        rows += 1
    parted, at_prefill = {}, 0
    for rid, w in want.items():
        h = have[rid]
        check((h.finished_tick, h.wire_bytes, h.mode_counts, len(h.tokens))
              == (w.finished_tick, w.wire_bytes, w.mode_counts,
                  len(w.tokens)),
              f"mp (1, 2): request {rid}'s schedule or accounting differs")
        i = next((i for i, (a, b) in enumerate(zip(h.tokens, w.tokens))
                  if a != b), None)
        if i is not None:
            if i == 0:
                near_tie(base.prefill[rid],
                         f"request {rid} parts at its prefill token")
                at_prefill += 1
            parted[rid] = w.admitted_tick + i - 1
    check(len(base.tape) == len(got.tape),
          f"mp (1, 2): {len(got.tape)} decode steps, one device "
          f"{len(base.tape)}")
    for t, ((live, a), (glive, b)) in enumerate(zip(base.tape, got.tape)):
        check(live == glive, f"mp (1, 2): step {t} decodes other slots")
        for s, rid in live.items():
            if t > parted.get(rid, t):
                continue
            top = float(a[s].abs().max())
            rel = float((a[s] - b[s]).abs().max()) / max(top, 1e-30)
            worst = max(worst, rel)
            rows += 1
            if t == parted.get(rid):
                near_tie(a[s], f"request {rid} parts at step {t}")
    check(worst <= tol, f"mp (1, 2): logits differ by {worst:.4g} of the "
                        f"row's largest |logit| (limit {tol})")
    return {"rows_compared": rows, "worst_logit_rel": worst,
            "requests_parted": len(parted),
            "parted_at_prefill_token": at_prefill,
            "parting_gaps_rel": gaps, "tolerance_rel": tol}


def mesh_runs():
    """The gloo runs of phase 16, in order: (label, function of the rank)
    on the two ranks' world (every rank on cuda:0)."""
    def serve(argv):
        from repro_torch.launch import serve as S
        return S.main(argv)

    def mp2(rank):
        import torch.distributed as dist
        Taped = taped_engine()
        argv = SERVE["qwen2.5-3b"] + ["--mp", "2", *MESH_GLOO]
        base = None
        if rank == 0:                       # one device, alone
            with serve_engine(Taped, fused_tail=False):
                serve(SERVE["qwen2.5-3b"] + MESH_ONE)
            base = Taped.last
        dist.barrier()
        zero_counts()
        with serve_engine(Taped, fused_tail=False):
            out = serve(argv)
        res = {"summary": out}
        if rank == 0:
            res["against_one_device"] = mp_against_one_device(base,
                                                              Taped.last)
        return res

    def bench(rank):
        from repro_torch.benchmarks import bench_serving
        out = bench_serving.main(MESH_BENCH + MESH_GLOO)
        return {"slot_scaling": out["slot_scaling"]}

    return (
        ("qwen2.5-3b continuous dp2", lambda r: {"summary": serve(
            SERVE["qwen2.5-3b"] + ["--dp", "2", *MESH_GLOO])}),
        ("qwen2.5-3b continuous mp2", mp2),
        ("qwen2.5-3b sync dp2", lambda r: {"summary": serve(
            SYNC["qwen2.5-3b"] + ["--dp", "2", *MESH_GLOO])}),
        ("recurrentgemma-2b continuous dp2", lambda r: {"summary": serve(
            SERVE["recurrentgemma-2b"] + ["--dp", "2", *MESH_GLOO])}),
        ("qwen2.5-3b cluster 2x(1,1)", lambda r: {"summary": serve(
            MESH_CLUSTER + ["--dp", "1", "--mp", "1", *MESH_GLOO])}),
        ("qwen2.5-3b slot-scaling", bench),
    )


def mesh_rank(rank: int, world: int, port: int, queue) -> None:
    """One gloo rank of phase 16: every run of ``mesh_runs`` with the
    launch counters at 0 just before and read just after; its results (or
    its error) to the parent."""
    import datetime
    import traceback
    out = {}
    try:
        sys.path.insert(0, str(SRC))
        import torch
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
        for label, run in mesh_runs():
            fns = zero_counts()
            t0 = time.perf_counter()
            res = run(rank)
            torch.cuda.synchronize()
            res["seconds"] = time.perf_counter() - t0
            res["launches"] = {k: f.launches for k, f in fns.items()}
            res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            s = res.get("summary")
            if s is not None:               # what the checks read
                res["summary"] = {k: s[k] for k in (
                    "tokens", "generated", "requests_finished",
                    "decode_tok_per_s", "seconds", "mode_counts",
                    "wire_bytes", "migrations", "mesh") if k in s}
            out[label] = res
            free_cuda()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def start_mesh(world: int, target=None):
    """Start ``world`` gloo ranks of ``target`` (default ``mesh_rank``);
    (processes, queue) for ``collect_mesh``."""
    import multiprocessing
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=target or mesh_rank,
                         args=(r, world, port, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, queue


def collect_mesh(procs, queue) -> dict:
    """{rank: results} of ``start_mesh``'s ranks; raises if a rank failed.
    Every rank is joined or ended."""
    from repro_torch.launch.serve import _first_result
    results = {}
    try:
        for _ in procs:
            r, res = _first_result(queue, procs)
            results[r] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for r, res in sorted(results.items()):
        check("error" not in res, f"mesh rank {r} failed:\n"
                                  f"{res.get('error')}")
    return results


def mesh_kernels(dev, seed: int, iters: int, arch: str = "qwen2.5-3b",
                 rows: int = 2) -> dict:
    """The kernels at the per-rank shapes of a mesh's main path (``arch``
    at mp 2, random inputs of its widths; qwen2.5-3b at (2, 2) for phase
    16, phi3.5-moe at (1, 2) for phase 17): paged attention with the
    rank's KV heads (n_kv / 2; qwen2.5-3b one a rank, group 8, hd 128; 4
    slots at positions 16 to 31) in both forms bf16 bit for bit against
    the plain version, timed beside it, SDPA and the bound; the boundary
    on a rank's ``rows`` of 4, bit for bit those rows of the whole batch
    (at 4 rows, the whole batch: against its plain version,
    ``check_boundary``), timed at ``rows``; the tail at ``rows`` rows
    against the plain logits, timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import bottleneck
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.boundary_mixed import (boundary_mixed_grouped,
                                                    decode_tail_grouped)
    from repro_torch.kernels.paged_attention import paged_attention
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    flush = l2_flusher(dev)
    bf = torch.bfloat16
    # paged attention at the mp-2 rank's heads
    hd, g, plen = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, 8
    kv = cfg.n_kv_heads // 2
    n_pages = 4 * 16 + 1
    kp = torch.randn((n_pages, plen, kv, hd), generator=gen,
                     device=dev).to(bf)
    vp = torch.randn((n_pages, plen, kv, hd), generator=gen,
                     device=dev).to(bf)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm[:16].reshape(4, 4).to(torch.int32).contiguous()
    pos = torch.tensor([16, 20, 24, 31], dtype=torch.int32, device=dev)
    q = torch.randn((4, kv * g, hd), generator=gen, device=dev).to(bf)
    cases = [check_paged(q, kp, vp, bt, pos, pps, f"mp2 rank {form}",
                         oracle=True)
             for pps, form in ((4, "one range"), (1, "split 1"))]
    paged = {"timed_shape": {"B": 4, "positions": [16, 20, 24, 31],
                             "nq": kv * g, "n_kv": kv, "hd": hd,
                             "page_len": plen},
             "cases": cases,
             "ms": time_ms(lambda: paged_attention(q, kp, vp, bt, pos),
                           iters, flush),
             "plain_ms": time_ms(lambda: ref.paged_attention_ref(
                 q, kp, vp, bt, pos), max(iters // 5, 3), flush),
             "library_ms": sdpa_ms(q, kp, vp, bt, pos, iters, flush)}
    paged["bound_ms"], paged["bound_by"] = paged_bound(kp, q, bt, pos)
    # the boundary on a dp rank's rows
    bank = bottleneck.bank_stack(bottleneck.bank_init(gen, cfg, dtype=bf),
                                 cfg.split)
    d, w = cfg.d_model, int(bank["width"][0])
    x = torch.randn((4, 1, d), generator=gen, device=dev).to(bf)
    modes = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
    if rows < 4:
        # a dp rank's rows alone, bit for bit those rows of the batch
        full = ops.boundary_mixed_op(bank, x, modes, dtype=bf)
        member = type("Rank", (), {"member": True})()
        for lo in range(0, 4, rows):
            part = ops.boundary_mixed_sharded(bank, x[lo:lo + rows],
                                              modes[lo:lo + rows], member,
                                              dtype=bf)
            check(same_bits(part, full[lo:lo + rows]),
                  f"boundary: rows {lo}..{lo + rows - 1} alone differ from "
                  f"their rows in the 4-row batch")
        held = {"rows_bit_identical": True}
    else:
        # the rank holds the whole batch: the kernel against its plain
        # version as the kernel phase does (mode-0 rows bit for bit,
        # quantized rows inside the envelope, each row alone as in the
        # batch)
        err, ratio, _ = check_boundary(bank, x, modes, f"{arch} rank rows")
        held = {"max_abs_err": err, "envelope_ratio": ratio}
    x2, m2 = x[4 - rows:].reshape(rows, d), modes[4 - rows:]
    boundary = {"timed_shape": {"rows": rows, "d": d, "width": w,
                                "modes": sorted(set(m2.tolist()))},
                **held,
                "ms": time_ms(lambda: boundary_mixed_grouped(
                    x2, m2, 1, bank, dtype=bf), iters, flush),
                "plain_ms": time_ms(lambda: ref.boundary_mixed_rows_ref(
                    x2, m2, bank, bf), max(iters // 5, 3), flush)}
    n_quant = int((m2 > 0).sum())        # mode-0 rows are copied
    boundary["bound_ms"], boundary["bound_by"] = bound(
        2 * (2 * rows * d + 2 * d * w + d), 4 * n_quant * d * w, "bfloat16")
    # the tail at the rank's rows, on a random head of the model's width
    head = (torch.randn((1, d, cfg.vocab_size), generator=gen, device=dev)
            / math.sqrt(d)).to(bf)
    scale = torch.ones(d, dtype=bf, device=dev)
    xt = torch.randn((rows, 1, d), generator=gen, device=dev).to(bf)
    differ, _ = check_tail(xt, scale, head, f"{rows} rows")
    V = cfg.vocab_size
    tail = {"timed_shape": {"rows": rows, "d": d, "V": V},
            "tokens_differing": differ,
            "ms": time_ms(lambda: decode_tail_grouped(
                xt[:, 0], head, scale, None, block_r=16), iters),
            "plain_ms": time_ms(lambda: ref.decode_tail_ref(
                xt, scale, None, head), iters)}
    tail["bound_ms"], tail["bound_by"] = bound(
        2 * (V * d + rows * d + d) + 4 * rows, 2 * rows * d * V, "bfloat16")
    return {"paged_attention": paged, "boundary_mixed_grouped": boundary,
            "decode_tail_grouped": tail}


#: the kernels each mesh path must launch (the tail is replicated over
#: mp and runs fused; the mp run is the unfused engine, the sync engine's
#: wire is the plain bottleneck)
MESH_KERNELS = {
    "qwen2.5-3b continuous dp2": ("boundary_mixed_grouped",
                                  "decode_tail_grouped", "paged_attention"),
    "qwen2.5-3b continuous mp2": ("boundary_mixed_grouped",
                                  "paged_attention"),
    "qwen2.5-3b sync dp2": ("decode_tail_grouped",),
    "recurrentgemma-2b continuous dp2": ("boundary_mixed_grouped",
                                         "decode_tail_grouped",
                                         "rglru_scan"),
    "qwen2.5-3b cluster 2x(1,1)": ("boundary_mixed_grouped",
                                   "decode_tail_grouped", "paged_attention"),
    "qwen2.5-3b slot-scaling": ("boundary_mixed_grouped",
                                "decode_tail_grouped", "paged_attention"),
    "qwen2.5-3b continuous nccl (1,1)": ("boundary_mixed_grouped",
                                         "decode_tail_grouped",
                                         "paged_attention"),
}


def mesh_checks(ranks: dict, one: dict):
    """Phase 16's rules on the gloo ranks' results against the one-device
    runs ``one``: every rank's summary the same, each path's kernels
    launched, dp tokens equal to one device's, the mp rule, the slot
    scaling gate. Returns (launches by path, per-run record, the mp
    check, the slot-scaling rows)."""
    runs, by_path = {}, {}
    for label, _ in mesh_runs():
        per = [ranks[r][label] for r in sorted(ranks)]
        launches = {k: sum(p["launches"][k] for p in per)
                    for k in per[0]["launches"]}
        by_path[label] = launches
        runs[label] = {"seconds": [p["seconds"] for p in per],
                       "peak_gb": [p["peak_gb"] for p in per],
                       "launches": launches}
        if per[0].get("summary") is not None:
            runs[label]["tok_per_s_by_rank"] = [
                p["summary"].get("decode_tok_per_s") for p in per]
        s = per[0].get("summary")
        if s is not None:
            runs[label].update(
                {k: s[k] for k in ("decode_tok_per_s", "requests_finished",
                                   "mode_counts", "wire_bytes", "migrations")
                 if k in s})
            same = ("tokens", "generated", "requests_finished",
                    "mode_counts", "wire_bytes", "migrations")
            check(all({k: p["summary"].get(k) for k in same}
                      == {k: s.get(k) for k in same} for p in per),
                  f"mesh {label}: the ranks' summaries differ")
        for k in MESH_KERNELS[label]:
            check(launches[k] > 0, f"mesh {label}: kernel {k} never "
                                   f"launched")
    r0 = {label: ranks[0][label] for label, _ in mesh_runs()}
    for label, ref_label in (
            ("qwen2.5-3b continuous dp2", "qwen2.5-3b continuous"),
            ("recurrentgemma-2b continuous dp2",
             "recurrentgemma-2b continuous"),
            ("qwen2.5-3b cluster 2x(1,1)", "qwen2.5-3b cluster")):
        got = r0[label]["summary"]["tokens"]
        check(got == one[ref_label],
              f"mesh {label}: tokens differ from one device's (request, "
              f"index) {first_difference(got, one[ref_label])}")
    check(sync_rows(r0["qwen2.5-3b sync dp2"]["summary"]["generated"])
          == sync_rows(one["qwen2.5-3b sync"]),
          "mesh qwen2.5-3b sync dp2: tokens differ from one device's")
    check(r0["qwen2.5-3b cluster 2x(1,1)"]["summary"]["migrations"] > 0,
          "mesh cluster: no session migrated")
    mp = r0["qwen2.5-3b continuous mp2"]["against_one_device"]
    rows = r0["qwen2.5-3b slot-scaling"]["slot_scaling"]["rows"]
    check([r["dp"] for r in rows] == [1, 2],
          f"mesh slot scaling: rows {[r['dp'] for r in rows]}")
    for r in rows:
        check(r["finished"] == r["requests"],
              f"mesh slot scaling dp {r['dp']}: {r['finished']} of "
              f"{r['requests']} requests finished")
        check(r["decode_tok_per_s"] >= SHARD_FLOOR
              * rows[0]["decode_tok_per_s"],
              f"mesh slot scaling dp {r['dp']}: {r['decode_tok_per_s']} "
              f"tok/s under {SHARD_FLOOR} x dp 1's")
    return by_path, runs, mp, rows


def phase_mesh(dev, seed: int, iters: int, smi: str) -> dict:
    """Phase 16: the serving mesh on the one card. The kernels at the
    per-rank shapes (``mesh_kernels``); the one-device cluster run; the
    continuous engine on one NCCL rank (launch.serve --dp 1 --mp 1, which
    starts it); then two gloo ranks on cuda:0 (``mesh_runs``), their
    launches summed by path. dp runs must decode the one-device tokens
    (phases 7 and 9's runs, and the cluster's), the mp run keeps the
    schedule under ``TOL["mp_logit_rel"]``, and the slot scaling rows
    finish their workloads above ``SHARD_FLOOR``. Ranks sharing one card
    measure correctness and launches, not dp or mp speed. Returns the
    launches of each path."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    kernels = mesh_kernels(dev, seed, iters)
    free_cuda()
    one = {"qwen2.5-3b continuous": MAIN_RUNS["qwen2.5-3b continuous"],
           "qwen2.5-3b sync": MAIN_RUNS["qwen2.5-3b sync"],
           "recurrentgemma-2b continuous":
               MAIN_RUNS["recurrentgemma-2b continuous"]}
    # the gloo ranks run while this process serves the one-device cluster
    # and the NCCL rank: the card and the host's cores have room for both
    # (for the script's time; the rates below then share the card)
    t_gloo = time.perf_counter()
    started = start_mesh(2)
    one["qwen2.5-3b cluster"] = serve_run(MESH_CLUSTER + ["--device",
                                                         "cuda"])["tokens"]
    free_cuda()
    t_nccl = time.perf_counter()
    nccl = serve.main(SERVE["qwen2.5-3b"] + ["--dp", "1", "--mp", "1",
                                              "--dist-backend", "nccl",
                                              "--device", "cuda"])
    t_nccl = time.perf_counter() - t_nccl
    check(nccl["tokens"] == one["qwen2.5-3b continuous"]
          and nccl["mesh"]["backend"] == "nccl",
          "mesh nccl (1, 1): tokens differ from one device's")
    ranks = collect_mesh(*started)
    t_gloo = time.perf_counter() - t_gloo
    by_path, runs, mp, rows = mesh_checks(ranks, one)
    by_path["qwen2.5-3b continuous nccl (1,1)"] = nccl["mesh"]["launches"]
    for k in MESH_KERNELS["qwen2.5-3b continuous nccl (1,1)"]:
        check(nccl["mesh"]["launches"][k] > 0,
              f"mesh nccl (1, 1): kernel {k} never launched")
    emit({"phase": "mesh", "card": smi,
          "note": "every rank on the one card: correctness and launches, "
                  "not dp or mp speed",
          "kernels_at_rank_shapes": kernels, "mp_against_one_device": mp,
          "slot_scaling": rows, "runs": runs,
          "nccl_1x1": {"seconds": t_nccl,
                       "decode_tok_per_s": nccl["decode_tok_per_s"],
                       "launches": nccl["mesh"]["launches"]},
          "gloo_ranks_seconds": t_gloo,
          "seconds": time.perf_counter() - t0})
    return by_path


# ---------------------------------------------------------------------------
# phase 17: training and MoE across ranks
# ---------------------------------------------------------------------------

#: (a) and (b): launch.train's Algorithm 1 on qwen2.5-3b at full width,
#: [4, 128], two steps a phase, cut in depth by the model axis: (a) at mp
#: 2 to 4 of 36 layers (time: each layer adds six host-staged all_reduces
#: a step and its slices to the checkpoint gathered over gloo and written
#: by rank 0, and the one-device reference and its control run at the
#: same depth; 12 layers took 63.5 s of phase 17 on a slow host, whose
#: script read 1,290 of its 1,200 s, and 8 layers 32 s); (b) at
#: dp 2 to 2 layers (time: dp 2 moves every gradient in float32 through
#: the host each step, 5.0 GB at 8 layers, 7.5 s a step, and under FSDP
#: also gathers each layer's weights twice a step as int32 buffers of the
#: whole leaf: 7.8 s a step at 4 layers; phase 18 needed the room). The
#: one-device run at the same depth and arguments is the reference (rank
#: 0, while rank 1 runs the control, before the mesh runs)
P17_TRAIN = ["--arch", "qwen2.5-3b", "--cascade", "--steps", "2", "--batch",
             "4", "--seq", "128"]
P17_TRAIN_LAYERS = {2: 4, 1: 2}
#: each logged loss of a mesh run within this share of the one-device
#: run's: the mp run rounds each row-split output's two bf16 partial
#: products where one device rounds one GEMM, and dp sums the gradients in
#: another order (on an H100 80GB HBM3 at 700 W: 1.8e-4 at mp 2, 12
#: layers; 4.4e-5 at dp 2, 4 layers). A control run on one device with the update off
#: (``--lr 0``, the state left unchanged) must part from the reference by
#: more, or the limit could not tell a run that does not train
TOL["train_mp_loss_rel"] = 1e-3
#: (c): phi3.5-moe at full width, 2 layers (split at 1), the layer-0 MoE
#: on x [2, 256, 4096]; its train step on a [4, 128] batch
P17_EP = {"layers": 2, "split_at": 1, "x": (2, 256), "train": (4, 128)}
#: moe_apply_ep against moe_apply, bf16: each output element within this
#: share of its row's largest |y| (the two sides' expert GEMMs run at
#: other row counts, so each rounds its bf16 products on its own, and ep
#: sums a token's two gate-weighted rows in bf16 where one device sums in
#: float32 and rounds once: about four bf16 roundings at the row's
#: scale); the token path's gradient within this relative L2 norm
TOL["moe_ep_row_rel"] = 2.0 ** -6
TOL["moe_ep_grad_rel"] = 2.0 ** -6
#: (d): granite-8b at full width, cut to 12 of its 36 layers (time: each
#: layer adds four host-staged collectives a forward; 36 layers took 15 s
#: of phase 17), [2, 512]; the reference test's bounds
#: (tests/test_qtp.py), bits 0's absolute bound scaled to the logits above
#: it as tests/test_torch_qtp.py does
P17_QTP = {"arch": "granite-8b", "layers": 12, "tokens": (2, 512)}
TOL["qtp"] = {"bits0_atol": 0.1, "bits0_scale": 2.0 ** -9,
              "bits8_rel": 0.05}
#: (e): stablelm-3b at full width and depth, (pod 2), [8, 128], n_micro 4;
#: the reference test's bounds (tests/test_pipeline_pods.py), scaled as
#: bits 0's above
P17_PIPE = {"arch": "stablelm-3b", "tokens": (8, 128), "n_micro": 4}
TOL["pipe"] = {"mode0_atol": 0.15, "mode1_atol": 0.25, "scale": 2.0 ** -9,
               "bwd_rel": 0.2, "wire_ratio": 0.35}
#: (f): phi3.5-moe continuous on the paged pool at (dp, mp) = (1, 2), cut
#: to this depth (each rank makes the whole model before it keeps its
#: experts' half: two models of 2.6 GB a layer on the card at once)
P17_SERVE_LAYERS = 8
#: seconds a phase 17 rank waits in a collective before it gives up
P17_TIMEOUT = 600
#: the one device every phase 17 rank runs on
P17_DEVICE = "cuda:0"


def cut_config(name: str, layers: int = 0, split_at: int = 0):
    """The arch's full config, cut to ``layers`` (0: all) with its split
    at ``split_at`` (0: as configured)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(name)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if split_at:
        cfg = dataclasses.replace(cfg, split=dataclasses.replace(
            cfg.split, split_at=split_at))
    return cfg


@contextlib.contextmanager
def patched(module, name: str, value):
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


def replicated_same(local, mesh, cfg, stages: bool = False) -> int:
    """Check that every leaf this rank holds whole (``split_axes`` None)
    has rank 0's bits on every rank (one broadcast a leaf); returns how
    many were held."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.split import param_shapes
    from repro_torch.models import sharding
    split = sharding.split_axes(local, mesh, cfg=cfg,
                                shapes=param_shapes(cfg), stages=stages)
    n, bad = 0, []
    for (path, a), (_, s) in zip(sharding._path_leaves(local),
                                 sharding._path_leaves(split)):
        if s is not None:
            continue
        mine = a.detach().contiguous()
        theirs = mine.clone()
        dist.broadcast(theirs, 0)
        if not same_bits(mine, theirs):
            bad.append(path)
        n += 1
    flag = torch.tensor([len(bad)], dtype=torch.int64)
    dist.all_reduce(flag)
    check(int(flag) == 0, f"rank {dist.get_rank()}: replicated leaves "
                          f"differ from rank 0's: {bad[:5]}")
    return n


def _tree_pairs(tree, other, prefix: str = ""):
    """(path, leaf of ``tree``, the node of ``other`` at that path), with
    ``tree`` driving the walk (a spec tree's tuples are its leaves)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_pairs(v, other[k], f"{prefix}/{k}" if prefix
                                   else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_pairs(v, other[i], f"{prefix}/{i}" if prefix
                                   else str(i))
    else:
        yield prefix, tree, other


def fsdp_layout(local, state, mesh, cfg, hist) -> dict:
    """Phase 18 (d) on phase 17 (b)'s (data 2, model 1) mesh: each leaf
    this rank holds, and its AdamW m and v, have the local shape of the
    spec the reference's rules give (``sharding.param_pspecs``, held to
    the JAX package's leaf by leaf in ``tests/test_torch_train_sharding.py``)
    on this mesh, from the whole shapes (the init on fake tensors); this
    rank's parameter and AdamW bytes, measured, against the layout the
    launcher reports (``rank_bytes``) and beside the layout without FSDP
    (weights whole over data)."""
    from repro_torch.core.split import abstract_split_params
    from repro_torch.models import sharding
    whole = abstract_split_params(cfg)
    specs = sharding.param_pspecs(whole, mesh, stacked_layers=cfg.homogeneous)
    have = {p: a for p, a in sharding._path_leaves(local)}
    ms = {p: a for p, a in sharding._path_leaves(state.m)}
    vs = {p: a for p, a in sharding._path_leaves(state.v)}
    n_split, bad = 0, []
    for path, meta, spec in _tree_pairs(whole, specs):
        want = []
        for dim, axis in zip(meta.shape, tuple(spec) + (None,) * meta.dim()):
            axes = axis if isinstance(axis, tuple) else (axis,)
            n = math.prod(mesh.shape[a] for a in axes if a is not None
                          and not (a == "model"
                                   and not path.startswith("layers/")))
            want.append(dim // n)
        got = tuple(have[path].shape)
        n_split += got != tuple(meta.shape)
        if not got == tuple(ms[path].shape) == tuple(vs[path].shape) \
                == tuple(want):
            bad.append((path, got, want))
    check(not bad, f"fsdp (2, 1): local shapes differ from the reference "
                   f"specs': {bad[:3]}")
    check(n_split > 0, "fsdp (2, 1): no leaf split over data")
    measured = {"params": sum(a.numel() * a.element_size()
                              for a in have.values()),
                "adam": sum(a.numel() * a.element_size()
                            for a in (*ms.values(), *vs.values()))}
    check(measured == hist["mesh"]["rank_bytes"],
          f"fsdp (2, 1): measured bytes {measured} != the layout's "
          f"{hist['mesh']['rank_bytes']}")
    return {"leaves": len(have), "leaves_split_over_data": n_split,
            "rank_bytes": measured,
            "rank_bytes_unsharded_data":
                hist["mesh"]["rank_bytes_unsharded_data"]}


def logged_losses(hist) -> list:
    """Each phase's logged losses of a launch.train --cascade history."""
    return [[r["loss"] for r in p["log"]] for p in hist["phases"]]


def p17_train(rank: int, mp: int) -> dict:
    """(a) at ``mp`` 2, (b) at mp 1 (data 2): ``launch.train.main`` on
    the cut config (``P17_TRAIN_LAYERS[mp]``) against the one-device run
    at that depth (rank 0 alone): each logged loss within
    ``TOL["train_mp_loss_rel"]``, which the one-device control run at
    ``--lr 0`` must exceed; the replicated leaves bit-identical across the
    ranks at the end; the checkpoint (written once, by rank 0) restored on
    one device and evaluated."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.core import split as SP
    from repro_torch.data import tokens
    from repro_torch.launch import train as TLaunch
    from repro_torch.models import sharding
    from repro_torch.training import checkpoint
    from repro_torch.training import loop as L
    from repro_torch.training import optimizer as O
    cfg = cut_config("qwen2.5-3b", P17_TRAIN_LAYERS[mp])
    dev = torch.device(P17_DEVICE)
    argv = P17_TRAIN + ["--device", P17_DEVICE, "--dist-backend", "gloo"]
    base = ROOT / "build" / "p17"
    tol = TOL["train_mp_loss_rel"]
    ref = {}
    with patched(TLaunch, "get_config", lambda name: cfg):
        # the one-device reference on rank 0 and its update-off control
        # on rank 1, at once (each alone on the card's memory it needs)
        lr = ["--lr", "0"] if rank == 1 else []
        args = TLaunch.parser().parse_args(
            argv + lr + ["--ckpt-dir", str(base / f"one{rank}")])
        with patched(checkpoint, "save", lambda *a, **kw: None):
            run = TLaunch._train(args, dev, None)
        free_cuda()
        runs = [None, None]
        dist.all_gather_object(runs, {
            "logs": logged_losses(run), "ms_per_step": run["ms_per_step"],
            "peak": run.get("peak_memory_bytes")})
        del run
        if rank == 0:
            one, lr0 = runs
            ref = {**one, "lr0_logs": lr0["logs"]}
            ref["lr0_worst_rel"] = max(
                abs(a - b) / abs(b) for la, lb in zip(ref["lr0_logs"],
                                                      ref["logs"])
                for a, b in zip(la, lb))
            check(ref["lr0_worst_rel"] > tol,
                  f"train mp {mp}: the one-device run with the update off "
                  f"parts from the reference by {ref['lr0_worst_rel']:.3g}, "
                  f"not more than the limit {tol}")
        dist.barrier()
        held: dict = {}
        orig = sharding.gather_train_params
        orig_init = O.init

        def gather(local, mesh, **kw):
            held.update(local=local, mesh=mesh)
            return orig(local, mesh, **kw)

        def init(params):
            held["state"] = orig_init(params)
            return held["state"]

        layout = ["--mp", "2"] if mp == 2 else ["--dp", "2"]
        ck_dir = base / f"mesh{mp}"
        t0 = time.perf_counter()
        with patched(sharding, "gather_train_params", gather), \
                patched(O, "init", init):
            hist = TLaunch.main(argv + layout + ["--ckpt-dir", str(ck_dir)])
        wall = time.perf_counter() - t0
    local, mesh = held.pop("local"), held.pop("mesh")
    n_rep = replicated_same(local, mesh, cfg)
    fsdp = (fsdp_layout(local, held.pop("state"), mesh, cfg, hist)
            if mp == 1 else None)
    held.clear()
    del local
    free_cuda()
    out = {"n_layers": cfg.n_layers, "wall_s": wall,
           "ms_per_step": hist["ms_per_step"],
           "peak_memory_bytes_by_rank": hist.get("peak_memory_bytes_by_rank"),
           "collectives_per_step": hist["mesh"]["collectives_per_step"],
           "collective_bytes_per_step":
               hist["mesh"]["collective_bytes_per_step"],
           "logged_losses": logged_losses(hist),
           "replicated_leaves_held": n_rep, "fsdp": fsdp}
    if rank == 0:
        got = out["logged_losses"]
        worst = max(abs(a - b) / abs(b) for la, lb in zip(got, ref["logs"])
                    for a, b in zip(la, lb))
        check([len(x) for x in got] == [len(x) for x in ref["logs"]]
              and worst <= tol,
              f"train mp {mp}: losses {got} part from one device's "
              f"{ref['logs']} (worst {worst:.3g}, limit {tol})")
        # the checkpoint on one device: restored into a template of other
        # weights, its phase-2 eval loss the mesh run's
        template = SP.init_split_params(
            torch.Generator(device=dev).manual_seed(1), cfg)
        path = ck_dir / "qwen2_5-3b.npz"
        restored = checkpoint.restore(str(path), template)
        del template
        batch = L.device_batch(tokens.MarkovTokenSource(cfg, seed=0).batch(
            4, 128, 10_001), dev)
        ev = float(L.make_eval_step(cfg, mode=1)(restored, batch)["loss"])
        want = hist["phases"][-1]["eval"]["loss"]
        check(math.isfinite(ev) and abs(ev - want) <= tol * abs(want),
              f"train mp {mp}: the checkpoint's eval loss on one device "
              f"{ev} != the mesh run's {want}")
        del restored
        out.update(one_device=ref, worst_loss_rel=worst,
                   loss_rel_limit=tol,
                   checkpoint_bytes=path.stat().st_size,
                   restored_eval_loss=ev, mesh_eval_loss=want)
        shutil.rmtree(base, ignore_errors=True)
    return out


def p17_ep(rank: int) -> dict:
    """(c): ``moe_apply_ep`` at ep 2 against the one-device ``moe_apply``
    on phi3.5-moe's layer 0 at full width: capacity 8 (forward by rows,
    the token path's gradient), the default capacity against the plain
    routing of this rank's block (the same drops), then one train step of
    the 2-layer model with ``moe_ep=True``."""
    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import split as SP
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.models import moe, moe_ep, sharding
    from repro_torch.models import transformer as T
    from repro_torch.training import loop as L
    from repro_torch.training import optimizer as opt
    cfg = cut_config(PHI, P17_EP["layers"], P17_EP["split_at"])
    dev = torch.device(P17_DEVICE)
    k = cfg.experts_per_tok
    mesh = sharding.train_mesh(2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    params = SP.init_split_params(gen, cfg)
    B, S = P17_EP["x"]
    x = torch.randn((B, S, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    p = T.layer_slice(params["layers"], 0)["mlp"]
    local = sharding.shard_train_params(params, mesh, cfg=cfg)
    pl = T.layer_slice(local["layers"], 0)["mlp"]

    def rows_rel(a, b):
        a, b = a.float().reshape(-1, a.shape[-1]), b.float().reshape(
            -1, b.shape[-1])
        scale = b.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
        return float(((a - b).abs() / scale).max())

    def run(fn, p_, cf):
        xr = x.clone().requires_grad_(True)
        y, aux = fn(p_, xr, k=k, act=cfg.act, capacity_factor=cf)
        (g,) = torch.autograd.grad(torch.sum(y.float() ** 2), xr)
        return y.detach(), float(aux.detach()), g

    y_ref, aux_ref, g_ref = run(moe.moe_apply, p, 8.0)
    y_ep, aux_ep, g_ep = run(
        lambda *a, **kw: moe_ep.moe_apply_ep(*a, mesh=mesh, **kw), pl, 8.0)
    fwd = rows_rel(y_ep, y_ref)
    grad = float((g_ep.float() - g_ref.float()).norm()
                 / g_ref.float().norm())
    check(fwd <= TOL["moe_ep_row_rel"],
          f"moe_ep: rows differ by {fwd:.4g} of their largest |y|")
    check(grad <= TOL["moe_ep_grad_rel"],
          f"moe_ep: the token path's gradient differs by {grad:.4g}")
    # the default capacity: this rank's block routed as one group
    s_loc = S // 2
    lo = mesh.coords["model"] * s_loc
    with torch.no_grad():
        y_d, _ = moe_ep.moe_apply_ep(pl, x, k=k, act=cfg.act, mesh=mesh)
        block = x[:, lo:lo + s_loc].reshape(1, B * s_loc, cfg.d_model)
        y_b, _ = moe.moe_apply(p, block, k=k, act=cfg.act)
        cap = max(int(1.25 * k * B * s_loc / cfg.n_experts), 1)
        keep = moe.route(p["router"]["w"], block, k, cap)[4]
    drops = int((~keep).sum())
    blk = rows_rel(y_d[:, lo:lo + s_loc].reshape(1, -1, cfg.d_model), y_b)
    check(blk <= TOL["moe_ep_row_rel"],
          f"moe_ep: the default capacity's rows differ from the block's "
          f"plain routing by {blk:.4g}")
    check(drops > 0, "moe_ep: no choice dropped at the default capacity")
    zero = (y_d[:, lo:lo + s_loc].reshape(-1, cfg.d_model) == 0).all(-1)
    check(torch.equal(zero.cpu(), (~keep[0].any(-1)).cpu()),
          "moe_ep: the zero rows are not the tokens that lost every choice")
    del params, p, y_ref, g_ref, y_ep, g_ep, x
    free_cuda()
    # one train step with moe_ep=True
    bt, st = P17_EP["train"]
    step = L.make_train_step(cfg, TrainConfig(), mesh=mesh, moe_ep=True)
    batch = L.device_batch(MarkovTokenSource(cfg, seed=0).batch(bt, st, 0),
                           dev)
    calls: dict = {}
    state = opt.init(local)
    sync(dev)
    t0 = time.perf_counter()
    with counting(T, "moe_apply_ep", calls):
        local, state, m = step(local, state, batch)
    sync(dev)
    step_s = time.perf_counter() - t0
    loss = float(m["loss"])
    check(math.isfinite(loss), f"moe_ep train step: loss {loss}")
    check(calls.get("moe_apply_ep") == 2 * cfg.n_layers,
          f"moe_ep train step: moe_apply_ep ran {calls}")
    n_rep = replicated_same(local, mesh, cfg)
    del local, state
    free_cuda()
    return {"x": [B, S, cfg.d_model], "forward_rows_rel": fwd,
            "grad_rel": grad, "aux": [aux_ep, aux_ref],
            "default_capacity": cap, "dropped_choices": drops,
            "block_rows_rel": blk, "train_loss": loss,
            "train_aux": float(m["aux_loss"]), "train_step_s": step_s,
            "moe_apply_ep_calls": calls.get("moe_apply_ep"),
            "replicated_leaves_held": n_rep,
            "tolerance": {"row_rel": TOL["moe_ep_row_rel"],
                          "grad_rel": TOL["moe_ep_grad_rel"]}}


def logits_err(got, want, atol: float, scale: float):
    """(max |got - want|, its limit: ``atol`` or ``scale`` of the largest
    |want|, whichever is larger)."""
    err = float((got.float() - want.float()).abs().max())
    return err, max(atol, scale * float(want.float().abs().max()))


def p17_qtp(rank: int) -> dict:
    """(d): ``qtp_forward`` at (data 1, model 2) against the one-device
    ``T.forward`` on granite-8b (rank 0 holds the reference)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import qtp
    from repro_torch.core import split as SP
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    cfg = cut_config(P17_QTP["arch"], P17_QTP["layers"])
    dev = torch.device(P17_DEVICE)
    mesh = sharding.train_mesh(2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    params = SP.init_split_params(gen, cfg)
    tok = torch.randint(0, cfg.vocab_size, P17_QTP["tokens"], generator=gen,
                        device=dev)
    check(qtp.qtp_supported(cfg, mesh, tok.shape[1]), "qtp: not supported")
    ref = None
    if rank == 0:
        with torch.no_grad():
            ref = T.forward(params, tok, cfg)[0]
    local = sharding.shard_train_params(params, mesh, cfg=cfg)
    del params
    free_cuda()
    out = {"tokens": list(tok.shape), "ms": {}}
    lg = {}
    for bits in (0, 8):
        sync(dev)
        t0 = time.perf_counter()
        lg[bits] = qtp.qtp_forward(local, tok, cfg, mesh=mesh, bits=bits)
        sync(dev)
        out["ms"][bits] = 1e3 * (time.perf_counter() - t0)
        theirs = lg[bits].clone()
        dist.broadcast(theirs, 0)
        check(same_bits(theirs, lg[bits]),
              f"qtp bits {bits}: the ranks' logits differ")
    if rank == 0:
        t = TOL["qtp"]
        err0, lim0 = logits_err(lg[0], ref, t["bits0_atol"],
                                t["bits0_scale"])
        rel8 = float((lg[8].float() - ref).norm() / ref.float().norm())
        diff = float((lg[8].float() - lg[0].float()).abs().max())
        check(err0 <= lim0, f"qtp bits 0: {err0:.4g} off (limit {lim0:.4g})")
        check(rel8 < t["bits8_rel"], f"qtp bits 8: relative {rel8:.4g}")
        check(diff > 1e-6, "qtp: bits 8 gave bits 0's logits")
        out.update(bits0_err=err0, bits0_limit=lim0, bits8_rel=rel8,
                   bits8_vs_bits0=diff,
                   max_abs_logit=float(ref.abs().max()))
    del local, lg, ref
    free_cuda()
    return out


def p17_pipeline(rank: int) -> dict:
    """(e): ``pipeline_forward`` at (pod 2) on stablelm-3b against the
    one-device ``T.forward`` (mode 0) and ``split_forward`` (mode 1), the
    mode-1 gradients (both stages, both heads; the int8 backward wire
    against the float one) and the wire counter."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import cascade as C
    from repro_torch.core import pipeline as PL
    from repro_torch.core import split as SP
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    cfg = cut_config(P17_PIPE["arch"])
    dev = torch.device(P17_DEVICE)
    mesh = sharding.train_mesh(1, pod=2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    params = SP.init_split_params(gen, cfg)
    tok = torch.randint(0, cfg.vocab_size, P17_PIPE["tokens"], generator=gen,
                        device=dev)
    refs = {}
    if rank == 0:
        with torch.no_grad():
            refs[0] = T.forward(params, tok, cfg)[0]
            refs[1] = SP.split_forward(params, tok, cfg, 1)[0]
    local = sharding.shard_train_params(params, mesh, cfg=cfg, stages=True)
    del params
    free_cuda()
    n_micro = P17_PIPE["n_micro"]
    out = {"tokens": list(tok.shape), "n_micro": n_micro, "wire": {},
           "ms": {}}
    t = TOL["pipe"]
    for mode, atol in ((0, t["mode0_atol"]), (1, t["mode1_atol"])):
        PL.reset_wire_bytes()
        sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            lg, _ = PL.pipeline_forward(local, tok, cfg, mesh=mesh,
                                        n_micro=n_micro, mode=mode)
        sync(dev)
        out["ms"][f"mode{mode}"] = 1e3 * (time.perf_counter() - t0)
        out["wire"][f"mode{mode}"] = dict(PL.WIRE_BYTES)
        if rank == 0:
            err, lim = logits_err(lg, refs[mode], atol, t["scale"])
            check(err <= lim, f"pipeline mode {mode}: {err:.4g} off "
                              f"(limit {lim:.4g})")
            out[f"mode{mode}_err"], out[f"mode{mode}_limit"] = err, lim
        del lg
    del refs
    l1 = {}
    for bwd_bits in (0, 8):
        def loss(p, b, _):
            lg, aux = PL.pipeline_forward(p, b, cfg, mesh=mesh,
                                          n_micro=n_micro, mode=1,
                                          train=True, bwd_bits=bwd_bits)
            return T.lm_loss(lg, b) + 0.01 * aux, {}
        PL.reset_wire_bytes()
        _, grads = C.value_and_grad(loss, local, tok, 1)
        head = grads["bneck_modes"][0]
        vals = torch.stack([
            sum(torch.sum(torch.abs(g.float())) for g in
                T.tree_leaves(grads["layers"])),
            torch.sum(torch.abs(head["down"]["w"].float())),
            torch.sum(torch.abs(head["up"]["w"].float()))]).cpu()
        check(bool((vals > 0).all()),
              f"pipeline bwd_bits {bwd_bits}: stage {mesh.coords['pod']}'s "
              f"gradients do not reach its layers or heads: {vals.tolist()}")
        total = vals[:1].clone()
        dist.all_reduce(total)
        l1[bwd_bits] = float(total)
        out["wire"][f"bwd_bits{bwd_bits}"] = dict(PL.WIRE_BYTES)
        del grads, head
    rel = abs(l1[0] - l1[8]) / l1[0]
    check(rel < t["bwd_rel"], f"pipeline: the int8 backward's layer "
                              f"gradient L1 is {rel:.4g} off the float one's")
    sent = torch.tensor([out["wire"]["mode0"]["fwd"],
                         out["wire"]["mode1"]["fwd"]], dtype=torch.int64)
    dist.all_reduce(sent)
    check(int(sent[1]) < t["wire_ratio"] * int(sent[0]),
          f"pipeline: mode 1 moves {int(sent[1])} bytes, mode 0 "
          f"{int(sent[0])}")
    out.update(layers_grad_l1=l1, bwd_rel=rel,
               wire_fwd_bytes={"mode0": int(sent[0]), "mode1": int(sent[1])})
    del local
    free_cuda()
    return out


def route_differences(one: list, free: list) -> dict:
    """How a free (unpinned) run's routing differs from one device's,
    call by call on ``routes`` tapes, the free run's last ``len(one)``
    calls (a launcher's run warms its engine up first): the tokens routed
    to another set of experts, and at the first call with any, one
    device's k-th minus (k+1)-th router probability of those tokens (up
    to 8). Reported, not held."""
    import torch
    n = min(len(one), len(free))
    flips, first = 0, None
    for call, (a, b) in enumerate(zip(one[:n], free[len(free) - n:])):
        if a[2].shape != b[2].shape:
            break
        ea, eb = (torch.sort(x[2], dim=-1).values for x in (a, b))
        diff = (ea != eb).any(-1)
        flips += int(diff.sum())
        if flips and first is None:
            k = a[2].shape[-1]
            top = torch.topk(a[0], k + 1, dim=-1).values
            gap = top[..., k - 1] - top[..., k]
            first = {"call": call, "one_device_gaps": gap[diff].tolist()[:8]}
    return {"calls": (len(one), len(free)), "calls_compared": n,
            "routing_decisions": sum(int(x[2][..., 0].numel())
                                     for x in one[:n]),
            "routing_differences": flips, "first_difference": first}


def p17_serve(rank: int) -> dict:
    """(f): phi3.5-moe continuous at (1, 2) against the one-device engine
    at the same depth (``P17_SERVE_LAYERS``; rank 0 alone, taped and
    unfused, its routes recorded and sent to both ranks). The mesh's
    taped unfused run replays those routes (``routes``: the router's
    discrete choice at a near tie would otherwise swap a token's whole
    MLP output) and is held to phase 16's mp rule as it stands
    (``mp_against_one_device``). The fused run, whose launches the path's
    kernels must show, routes freely; how its routes differ from one
    device's is reported (``route_differences``), not held."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import serve as S
    cfg = cut_config(PHI, P17_SERVE_LAYERS, P17_SERVE_LAYERS // 2)
    argv = SERVE[PHI]
    one, gloo = ["--device", P17_DEVICE], ["--dist-backend", "gloo",
                                           "--device", P17_DEVICE]
    dev = torch.device(P17_DEVICE)
    Taped = taped_engine()
    base, tape, free = None, [None], []
    with patched(S, "get_config", lambda name: cfg):
        if rank == 0:
            ref_routes = []
            with serve_engine(Taped, fused_tail=False), routes(ref_routes):
                S.main(argv + one)
            # keep its sessions, tape and routes, not its weights
            base = types.SimpleNamespace(finished=Taped.last.finished,
                                         tape=Taped.last.tape,
                                         prefill=Taped.last.prefill)
            Taped.last = None
            tape = [[tuple(t.cpu() for t in r) for r in ref_routes]]
            free_cuda()
        dist.broadcast_object_list(tape, src=0)
        pinned = [tuple(t.to(dev) for t in r) for r in tape[0]]
        zero_counts()
        with serve_engine(Taped, fused_tail=False), \
                routes(pinned, replay=True):
            taped = S.main(argv + ["--mp", "2", *gloo])
        got = types.SimpleNamespace(finished=Taped.last.finished,
                                    tape=Taped.last.tape,
                                    prefill=Taped.last.prefill)
        Taped.last = None
        del pinned
        free_cuda()
        with routes(free):
            fused = S.main(argv + ["--mp", "2", *gloo])
    out = {"n_layers": cfg.n_layers,
           "taped": {k: taped.get(k) for k in ("requests_finished",
                                               "decode_tok_per_s")},
           "fused": {k: fused.get(k) for k in ("requests_finished",
                                               "decode_tok_per_s",
                                               "mode_counts", "wire_bytes")},
           "launches_by_rank_sum": fused["mesh"]["launches"]}
    check(fused["requests_finished"] == 8 and taped["requests_finished"] == 8,
          f"moe serve mp 2: {fused['requests_finished']} / "
          f"{taped['requests_finished']} requests finished")
    if rank == 0:
        out["against_one_device"] = mp_against_one_device(base, got)
        out["against_one_device"]["routes_pinned"] = len(tape[0])
        out["free_run_routes"] = route_differences(
            tape[0], [tuple(t.cpu() for t in r) for r in free])
    del free
    free_cuda()
    return out


def p17_runs():
    """Phase 17's runs on the two ranks, in order: (label, function of the
    rank, the kernels its path must launch)."""
    return (
        ("train mp2 (a)", lambda r: p17_train(r, 2), ()),
        ("train dp2 (b)", lambda r: p17_train(r, 1), ()),
        ("moe ep2 (c)", p17_ep, ()),
        ("qtp mp2 (d)", p17_qtp, ()),
        ("pipeline pod2 (e)", p17_pipeline, ()),
        ("moe serve mp2 (f)", p17_serve, ("boundary_mixed_grouped",
                                          "decode_tail_grouped",
                                          "paged_attention")),
    )


def p17_rank(rank: int, world: int, port: int, queue, runs=None) -> None:
    """One gloo rank of phase 17 (or of phase 18's ``runs``) on cuda:0:
    every run of ``p17_runs`` with the launch counters at 0 just before
    and read just after, its seconds and peak memory; its results (or its
    error) to the parent."""
    import datetime
    import traceback
    out = {}
    try:
        sys.path.insert(0, str(SRC))
        import torch
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(P17_DEVICE)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=P17_TIMEOUT))
        for label, run, _ in (runs or p17_runs)():
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            fns = zero_counts()
            t0 = time.perf_counter()
            res = run(rank)
            sync(dev)
            res["seconds"] = time.perf_counter() - t0
            res["launches"] = {k: f.launches for k, f in fns.items()}
            res["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if cuda else None)
            if rank == 0:
                print(json.dumps({"mesh_run": label,
                                  "seconds": res["seconds"],
                                  "peak_gb": res["peak_gb"]}), flush=True)
            out[label] = res
            free_cuda()
            dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def phase_train_mesh(dev, seed: int, iters: int, smi: str) -> dict:
    """Phase 17: training and MoE across ranks on the one card. The
    kernels at phi3.5-moe's (1, 2) rank shapes (``mesh_kernels``); then
    two gloo ranks on cuda:0 run ``p17_runs``: (a) launch.train --cascade
    --mp 2 and (b) --dp 2 on qwen2.5-3b against one device, (c) expert
    parallelism on phi3.5-moe, (d) the quantized tensor-parallel prefill
    on granite-8b, (e) the pod pipeline on stablelm-3b, (f) phi3.5-moe
    served over mp 2. The training paths launch none of the six kernels
    (as in the reference); (f) must launch its three. Ranks sharing one
    card measure correctness, launches, collectives and memory, not mesh
    speed. Returns the launches of each path."""
    t0 = time.perf_counter()
    kernels = mesh_kernels(dev, seed, iters, arch=PHI, rows=4)
    free_cuda()
    procs, queue = start_mesh(2, target=p17_rank)
    ranks = collect_mesh(procs, queue)
    by_path, runs = {}, {}
    for label, _, need in p17_runs():
        per = [ranks[r][label] for r in sorted(ranks)]
        launches = {k: sum(p["launches"][k] for p in per)
                    for k in per[0]["launches"]}
        by_path[f"phase 17 {label}"] = launches
        for k in need:
            check(launches[k] > 0, f"phase 17 {label}: kernel {k} never "
                                   f"launched")
        if not need:
            check(not any(launches.values()),
                  f"phase 17 {label}: the training path launched "
                  f"{launches}")
        runs[label] = {"by_rank": per}
    emit({"phase": "train_mesh", "card": smi,
          "note": "two gloo ranks on the one card: correctness, launches, "
                  "collectives and memory, not mesh speed",
          "kernels_at_rank_shapes": kernels, "runs": runs,
          "seconds": time.perf_counter() - t0})
    return by_path


# ---------------------------------------------------------------------------
# phase 18: the recurrent mixers over mp, FSDP over data
# ---------------------------------------------------------------------------

RG, XL = "recurrentgemma-2b", "xlstm-125m"
P18_ARCHS = (RG, XL)
#: (k): rglru_scan at the rank shapes of (a) and (b): recurrentgemma-2b's
#: RG-LRU prefill at d_rnn / 2 (the main path's [4, 16]) and xlstm-125m's
#: mLSTM normalizer at 2 of its 4 heads (768 channels, h0 carried)
P18_SCANS = {f"{RG} mp2 prefill": ((4, 16, 1280), False),
             f"{XL} mp2 normalizer": ((4, 16, 768), True)}
#: (c): launch.train's Algorithm 1 at mp 2 with phase 17 (a)'s arguments
#: ([4, 128], two steps a phase, the launcher's learning rate), at these
#: depths (0: all). recurrentgemma-2b cut to 6 of 26 layers, two
#: of its (rglru, rglru, attn) patterns (time: the one-device reference,
#: its control and the mesh run share the card and the host with the
#: serving runs; memory: each makes the 256,000-row embedding, its AdamW
#: state and [4, 128, 256000] float32 logits)
P18_TRAIN = ["--cascade", "--steps", "2", "--batch", "4", "--seq", "128"]
P18_TRAIN_LAYERS = {RG: 6, XL: 0}
P18_GLOO = ["--dist-backend", "gloo", "--device", P17_DEVICE]
#: where the helpers leave their one-device wire codes (``codes``) for
#: the mesh runs to replay: a file a tape, "<job>.pt", or "<job>.err" if
#: the helper failed first
P18_TAPES = ROOT / "build" / "p18" / "tapes"
#: the runs on the mesh, a world of two gloo ranks each line, (arch, run)
#: in order
P18_WORLDS = (((RG, "serve"), (RG, "train")),
              ((XL, "train"), (XL, "serve")))
#: the one-device references, a helper process each line: the serving
#: runs' taped engines, the training runs and their update-off controls
P18_HELPERS = ((f"{RG} serve", f"{RG} train", f"{RG} train lr0"),
               (f"{XL} train", f"{XL} serve"), (f"{XL} train lr0",))
#: the worlds and helper lines that start at phase 16 and share its time
#: (xlstm-125m's: a few GB on the card, the script's longest host-bound
#: leg, done before phase 17's MoE runs need the card's memory)
P18_EARLY = {"worlds": (1,), "helpers": (1, 2)}
#: the kernels each arch's served runs on the mesh must launch
P18_KERNELS = ("rglru_scan", "boundary_mixed_grouped", "decode_tail_grouped")


def p18_scans(dev, seed: int, iters: int) -> dict:
    """(k): ``rglru_scan`` at ``P18_SCANS``' rank shapes (decays in (0.9,
    1), random inputs) bit for bit against its plain version, timed beside
    it and its byte bound (12 bytes a step a channel, plus h0). No single
    PyTorch call computes the recurrence: no library time."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as RS
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    flush = l2_flusher(dev)
    out = {}
    for label, ((B, S, D), with_h0) in P18_SCANS.items():
        a = 0.9 + 0.1 * torch.rand((B, S, D), generator=gen, device=dev)
        b = torch.randn((B, S, D), generator=gen, device=dev)
        h0 = (torch.randn((B, D), generator=gen, device=dev) if with_h0
              else None)
        hk = RS.rglru_scan(a, b, h0)
        hr = ref.rglru_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        err = float((hk - hr).abs().max())
        check(torch.equal(hk, hr) and bool(torch.isfinite(hk).all()),
              f"rglru_scan {label}: not bit for bit (max error {err})")
        row = {"timed_shape": [B, S, D], "h0": with_h0, "max_abs_err": err,
               "plan": RS.rglru_scan.last_plan._asdict(),
               "ms": time_ms(lambda: RS.rglru_scan(a, b, h0), iters, flush),
               "plain_ms": time_ms(lambda: ref.rglru_scan_ref(a, b, h0),
                                   max(iters // 5, 3), flush),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = bound(
            3 * B * S * D * 4 + (B * D * 4 if with_h0 else 0), 2 * B * S * D,
            "float32")
        out[label] = row
    return out


def light_sessions(finished) -> list:
    """Finished sessions as the mp rule reads them, picklable."""
    return [types.SimpleNamespace(
        request=types.SimpleNamespace(rid=s.request.rid),
        tokens=[int(t) for t in s.tokens], finished_tick=s.finished_tick,
        wire_bytes=s.wire_bytes, mode_counts=dict(s.mode_counts),
        admitted_tick=s.admitted_tick) for s in finished]


def taped_sync_engine():
    """The sync engine recording the float32 logits of its prefill and of
    every decode step, each step's tokens their argmax (the logits chain
    in place of the fused tail). The tape is Python that runs at each
    step, so its steps run eagerly (its graphs never capture: an oracle,
    as the continuous engine's unfused window is)."""
    import torch

    from repro_torch.serving import ServingEngine

    class TapedSync(ServingEngine):
        last = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.graphs.capturing = False
            self.tape = []
            TapedSync.last = self

        def prefill(self, tokens):
            logits = super().prefill(tokens)
            self.tape.append(logits[:, 0].float())
            return logits

        def _step(self, mode, return_tokens: bool = False):
            step = super()._step(mode, False)
            if not return_tokens:
                return step

            def taped(params, token, states, cur_pos):
                logits, states = step(params, token, states, cur_pos)
                self.tape.append(logits[:, 0].float())
                return torch.argmax(logits, dim=-1).to(torch.int32), states
            return taped

    return TapedSync


def put_tape(job: str, tape) -> None:
    """A helper's one-device codes for ``job`` (a list of tensors, or an
    error's text) where the mesh runs wait for them (``P18_TAPES``),
    written whole before they appear."""
    import torch
    P18_TAPES.mkdir(parents=True, exist_ok=True)
    if isinstance(tape, str):
        (P18_TAPES / f"{job}.err").write_text(tape)
        return
    tmp = P18_TAPES / f"{job}.tmp"
    torch.save([t.cpu() for t in tape], tmp)
    os.replace(tmp, P18_TAPES / f"{job}.pt")


def get_tape(job: str) -> list:
    """One device's codes for ``job`` on ``P17_DEVICE``, waiting for the
    helper that makes them (at most ``MESH_TIMEOUT`` seconds)."""
    import torch
    path = P18_TAPES / f"{job}.pt"
    end = time.monotonic() + MESH_TIMEOUT
    while not path.exists():
        err = P18_TAPES / f"{job}.err"
        check(not err.exists(), f"phase 18 {job}: the one-device run "
                                f"failed: {err.read_text() if err.exists() else ''}")
        check(time.monotonic() < end, f"phase 18 {job}: no one-device "
                                      f"codes after {MESH_TIMEOUT} s")
        time.sleep(0.2)
    return [t.to(P17_DEVICE) for t in torch.load(path)]


def wire_codes(job: str, pinned):
    """``codes`` for a held run: on one device (``pinned`` None) taped
    and left for the mesh (``put_tape``) when the block ends; on the mesh
    the helper's tape, replayed."""
    if pinned is not None:
        return codes(pinned, replay=True)

    @contextlib.contextmanager
    def taped():
        with codes([]) as tape:
            yield tape
        put_tape(job, tape)
    return taped()


def p18_taped_runs(argv_extra: list, arch: str, pinned=None) -> dict:
    """The arch's continuous engine, taped and unfused, and its sync
    engine, taped, through ``launch.serve`` with ``argv_extra``, the
    wire's codes taped on one device and replayed on the mesh
    (``wire_codes``; ``pinned``: {"continuous": tape, "sync": tape}):
    their sessions and tapes on the host (numpy: a tensor would travel to
    the parent as a shared-memory handle, which dies with its process)."""
    from repro_torch.launch import serve as S
    Taped, TapedSync = taped_engine(), taped_sync_engine()
    pinned = pinned or {}
    with serve_engine(Taped, fused_tail=False), wire_codes(
            f"{arch} serve continuous", pinned.get("continuous")):
        cont = S.main(SERVE[arch] + argv_extra)
    eng, Taped.last = Taped.last, None
    out = {"continuous": {
        "finished": light_sessions(eng.finished),
        "tape": [(live, x.cpu().numpy()) for live, x in eng.tape],
        "prefill": {rid: x.cpu().numpy() for rid, x in eng.prefill.items()}},
        "continuous_summary": {k: cont.get(k) for k in (
            "requests_finished", "decode_tok_per_s", "mode_counts",
            "wire_bytes")}}
    del eng
    free_cuda()
    with patched(S, "ServingEngine", TapedSync), wire_codes(
            f"{arch} serve sync", pinned.get("sync")):
        sync = S.main(SYNC[arch] + argv_extra)
    eng, TapedSync.last = TapedSync.last, None
    out["sync"] = {"tape": [x.cpu().numpy() for x in eng.tape],
                   "stats": (eng.stats.tokens, eng.stats.wire_bytes,
                             dict(eng.stats.mode_counts))}
    out["sync_summary"] = {k: sync.get(k) for k in (
        "decode_tok_per_s", "wire_bytes", "mode_counts")}
    del eng
    free_cuda()
    return out


def p18_serve(rank: int, arch: str) -> dict:
    """(a) / (b) on a rank of the (1, 2) mesh: the fused continuous
    engine, which launches the boundary and the tail, then the taped runs
    on one device's codes (``p18_taped_runs``; rank 0's tapes go to the
    parent)."""
    from repro_torch.launch import serve as S
    fused = S.main(SERVE[arch] + ["--mp", "2", *P18_GLOO])
    free_cuda()
    pinned = {run: get_tape(f"{arch} serve {run}")
              for run in ("continuous", "sync")}
    out = p18_taped_runs(["--mp", "2", *P18_GLOO], arch, pinned)
    del pinned
    if rank != 0:
        for k in ("continuous", "sync"):
            out[k].pop("tape")
        out["continuous"].pop("prefill")
    out["fused"] = {k: fused.get(k) for k in (
        "tokens", "requests_finished", "decode_tok_per_s", "mode_counts",
        "wire_bytes")}
    return out


def p18_launch_train(arch: str, argv_extra: list, hold=None,
                     wire=contextlib.nullcontext()) -> dict:
    """``launch.train.main`` on the arch cut to ``P18_TRAIN_LAYERS``, the
    checkpoint not written (the CPU tests restore one), inside ``wire``
    (``wire_codes``: the boundary's codes taped or replayed); ``hold``: a
    dict that gets the rank's slices and mesh (``gather_train_params``'
    arguments)."""
    from repro_torch.launch import train as TLaunch
    from repro_torch.models import sharding
    from repro_torch.training import checkpoint
    cfg = cut_config(arch, P18_TRAIN_LAYERS[arch])
    orig = sharding.gather_train_params

    def gather(local, mesh, **kw):
        if hold is not None:
            hold.update(local=local, mesh=mesh)
        return orig(local, mesh, **kw)

    t0 = time.perf_counter()
    with patched(TLaunch, "get_config", lambda name: cfg), \
            patched(sharding, "gather_train_params", gather), \
            patched(checkpoint, "save", lambda *a, **kw: None), wire:
        hist = TLaunch.main(["--arch", arch, *P18_TRAIN, *argv_extra,
                             "--ckpt-dir", str(ROOT / "build" / "p18")])
    return {"n_layers": cfg.n_layers, "wall_s": time.perf_counter() - t0,
            "logged_losses": logged_losses(hist),
            "ms_per_step": hist["ms_per_step"],
            "peak_memory_bytes": hist.get("peak_memory_bytes"),
            "mesh": hist.get("mesh")}


def p18_train(rank: int, arch: str) -> dict:
    """(c) on a rank of the (data 1, model 2) mesh: ``launch.train
    --cascade --mp 2`` on one device's boundary codes; the whole leaves
    bit-identical across the ranks at the end."""
    held: dict = {}
    out = p18_launch_train(arch, ["--mp", "2", *P18_GLOO], held,
                           wire_codes(f"{arch} train",
                                      get_tape(f"{arch} train")))
    out["replicated_leaves_held"] = replicated_same(
        held.pop("local"), held.pop("mesh"),
        cut_config(arch, P18_TRAIN_LAYERS[arch]))
    free_cuda()
    return out


def p18_runs(world: int):
    """Phase 18's runs on the two ranks of ``P18_WORLDS[world]``, in
    order: (label, function of the rank, the kernels its path must
    launch)."""
    fns = {"serve": (p18_serve, P18_KERNELS), "train": (p18_train, ())}
    return tuple((f"{arch} {run} mp2",
                  lambda r, fn=fns[run][0], arch=arch: fn(r, arch),
                  fns[run][1]) for arch, run in P18_WORLDS[world])


def p18_helper(index: int, world: int, port: int, queue,
               lines=None) -> None:
    """One process of phase 18's one-device references
    (``P18_HELPERS[lines[index]]``) on cuda:0; its results (or its error)
    to the parent."""
    import traceback
    out = {}
    line = lines[index]
    try:
        sys.path.insert(0, str(SRC))
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if torch.device(P17_DEVICE).type == "cuda":
            torch.cuda.set_device(torch.device(P17_DEVICE))
        for job in P18_HELPERS[line]:
            arch, kind = job.split(" ", 1)
            t0 = time.perf_counter()
            if kind == "serve":
                res = p18_taped_runs(["--device", P17_DEVICE], arch)
            elif kind == "train":
                res = p18_launch_train(arch, ["--device", P17_DEVICE],
                                       wire=wire_codes(job, None))
            else:
                res = p18_launch_train(arch, ["--device", P17_DEVICE,
                                              "--lr", "0"])
            res["seconds"] = time.perf_counter() - t0
            out[job] = res
            free_cuda()
        queue.put((line, out))
    except BaseException:
        err = traceback.format_exc()
        for job in P18_HELPERS[line]:       # the mesh runs waiting fail
            for run in ((" continuous", " sync") if job.endswith("serve")
                        else ("",)):
                put_tape(job + run, err)
        queue.put((line, {"error": err}))


def p18_start(early: bool) -> dict:
    """Start phase 18's worlds and helper processes, ``P18_EARLY``'s
    (``early``) or the others: {"worlds": {index: started}, "helpers":
    started} (``start_mesh``'s, for ``collect_mesh``). The early start
    clears ``P18_TAPES`` first."""
    import functools
    import shutil
    if early:
        shutil.rmtree(P18_TAPES, ignore_errors=True)
    ws = [w for w in range(len(P18_WORLDS))
          if (w in P18_EARLY["worlds"]) == early]
    hs = tuple(h for h in range(len(P18_HELPERS))
               if (h in P18_EARLY["helpers"]) == early)
    return {"worlds": {w: start_mesh(2, functools.partial(
                p17_rank, runs=functools.partial(p18_runs, w)))
                for w in ws},
            "helpers": start_mesh(len(hs), functools.partial(
                p18_helper, lines=hs))}


def p18_stop(started: dict) -> None:
    """End what is left of the processes of ``p18_start`` (none once phase
    18 collected them; all when a phase before it failed)."""
    for procs, _ in (*started["worlds"].values(), started["helpers"]):
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


def mp_sync_against_one_device(base: dict, got: dict, label: str) -> dict:
    """The mp rule on two taped sync engines (``taped_sync_engine``): the
    same accounting and steps; each row's logits within
    ``TOL["mp_logit_rel"]`` of one device's until its tokens (the tapes'
    argmax, the prefill's first) part, and parting only where one
    device's top-two gap is within twice that share."""
    tol = TOL["mp_logit_rel"]
    check(got["stats"] == base["stats"] and len(got["tape"])
          == len(base["tape"]),
          f"{label}: the accounting or the steps differ from one device's")
    a_tok = [t.argmax(-1) for t in base["tape"]]
    b_tok = [t.argmax(-1) for t in got["tape"]]
    worst, rows, gaps, parted = 0.0, 0, [], 0
    for r in range(base["tape"][0].shape[0]):
        stop = next((t for t in range(len(a_tok))
                     if a_tok[t][r] != b_tok[t][r]), None)
        parted += stop is not None
        for t in range(len(a_tok) if stop is None else stop + 1):
            a, b = base["tape"][t][r], got["tape"][t][r]
            top = float(a.abs().max())
            worst = max(worst, float((a - b).abs().max()) / max(top, 1e-30))
            rows += 1
            if t == stop:
                two = a.topk(2).values
                gaps.append(float(two[0] - two[1]) / max(top, 1e-30))
                check(gaps[-1] <= 2 * tol,
                      f"{label}: row {r} parts at step {t} where one "
                      f"device's top-two gap is {gaps[-1]:.4g} of the "
                      f"largest logit (limit {2 * tol})")
    check(worst <= tol, f"{label}: logits differ by {worst:.4g} of the "
                        f"row's largest |logit| (limit {tol})")
    return {"rows_compared": rows, "worst_logit_rel": worst,
            "rows_parted": parted, "parting_gaps_rel": gaps,
            "tolerance_rel": tol}


def loss_rule(got: list, ref: list, lr0: list, label: str) -> dict:
    """Each logged loss within ``TOL["train_mp_loss_rel"]`` of one
    device's, which the update-off control must exceed."""
    tol = TOL["train_mp_loss_rel"]

    def worst(x, y):
        check([len(p) for p in x] == [len(p) for p in y],
              f"{label}: logged {x} against {y}")
        return max(abs(a - b) / abs(b) for pa, pb in zip(x, y)
                   for a, b in zip(pa, pb))

    off, w = worst(lr0, ref), worst(got, ref)
    check(off > tol, f"{label}: the run with the update off parts by "
                     f"{off:.3g}, not more than the limit {tol}")
    check(w <= tol, f"{label}: losses {got} part from one device's {ref} "
                    f"(worst {w:.3g}, limit {tol})")
    return {"worst_loss_rel": w, "lr0_worst_rel": off, "limit": tol}


def phase_mixers_mesh(dev, seed: int, iters: int, smi: str,
                      early: dict) -> dict:
    """Phase 18: the RG-LRU and xLSTM mixers over mp, FSDP over data (its
    check (d) rides phase 17 (b)). (k) the scan at the rank shapes; then,
    at once on the one card, two worlds of two gloo ranks (``P18_WORLDS``,
    ``p18_runs``: (a)
    recurrentgemma-2b and (b) xlstm-125m served at full width on both
    engines at (1, 2), fused, then taped; (c) ``launch.train --cascade
    --mp 2``) and the one-device references in helper processes
    (``P18_HELPERS``), those of ``P18_EARLY`` started at phase 16
    (``early``, ``p18_start``), whose wire codes the mesh runs replay
    (``wire_codes``). The taped runs are held to one device's under the
    mp rule, the training losses under ``TOL["train_mp_loss_rel"]`` with
    the update-off control. Ranks, helpers and the host share the card:
    correctness, launches, collectives and memory, not mesh speed.
    Returns the launches of each path."""
    import shutil

    import torch
    t0 = time.perf_counter()
    kernels = p18_scans(dev, seed, iters)
    free_cuda()
    rest = p18_start(early=False)
    refs = {job: res for started in (early, rest)
            for part in collect_mesh(*started["helpers"]).values()
            for job, res in part.items()}
    by_label = {}                       # label: [rank 0's, rank 1's]
    need_of = {}
    worlds = {**early["worlds"], **rest["worlds"]}
    for w, started in sorted(worlds.items()):
        ranks = collect_mesh(*started)
        for label, _, need in p18_runs(w):
            by_label[label] = [ranks[r][label] for r in sorted(ranks)]
            need_of[label] = need
    shutil.rmtree(ROOT / "build" / "p18", ignore_errors=True)
    by_path, runs, failures = {}, {}, []

    def held(rule, *args):
        """A rule's record; a failure is kept for after the phase's line
        (the phase still fails)."""
        try:
            return rule(*args)
        except SmokeFailure as e:
            failures.append(str(e))
            return {"failed": str(e)}

    for label, per in by_label.items():
        launches = {k: sum(p["launches"][k] for p in per)
                    for k in per[0]["launches"]}
        by_path[f"phase 18 {label}"] = launches
        for k in need_of[label]:
            check(launches[k] > 0, f"phase 18 {label}: kernel {k} never "
                                   f"launched")
        if not need_of[label]:
            check(not any(launches.values()),
                  f"phase 18 {label}: the training path launched "
                  f"{launches}")
    for arch in P18_ARCHS:
        serves = by_label[f"{arch} serve mp2"]
        trains = by_label[f"{arch} train mp2"]
        serve0, serve1 = serves
        check(serve0["fused"] == {**serve1["fused"], "decode_tok_per_s":
                                  serve0["fused"]["decode_tok_per_s"]}
              and serve0["fused"]["requests_finished"] == 8,
              f"phase 18 {arch}: the fused run's ranks differ or a request "
              f"did not finish")
        one = refs[f"{arch} serve"]
        base, got = (types.SimpleNamespace(
            finished=r["finished"], tape=[(live, torch.from_numpy(x))
                                          for live, x in r["tape"]],
            prefill={k: torch.from_numpy(x) for k, x in r["prefill"].items()})
            for r in (one["continuous"], serve0["continuous"]))
        cont = held(mp_against_one_device, base, got)
        sync = held(mp_sync_against_one_device,
                    *({**r, "tape": [torch.from_numpy(x) for x in r["tape"]]}
                      for r in (one["sync"], serve0["sync"])),
                    f"{arch} sync mp 2")
        fused = serve0["fused"]["tokens"]
        main = MAIN_RUNS.get(f"{arch} continuous") or {}
        train0 = trains[0]
        train = held(loss_rule, train0["logged_losses"],
                     refs[f"{arch} train"]["logged_losses"],
                     refs[f"{arch} train lr0"]["logged_losses"],
                     f"{arch} train mp 2")
        runs[arch] = {
            "serve": {
                "continuous_against_one_device": cont,
                "sync_against_one_device": sync,
                "fused_requests_as_main_path": sum(
                    fused.get(rid) == t for rid, t in main.items()),
                "tok_per_s": {
                    "taped_by_rank": [p["continuous_summary"][
                        "decode_tok_per_s"] for p in serves],
                    "fused_by_rank": [p["fused"]["decode_tok_per_s"]
                                      for p in serves],
                    "one_device_taped": one["continuous_summary"][
                        "decode_tok_per_s"]},
                "seconds_by_rank": [p["seconds"] for p in serves],
                "peak_gb_by_rank": [p["peak_gb"] for p in serves]},
            "train": {**train, "n_layers": train0["n_layers"],
                      "one_device_losses": refs[f"{arch} train"][
                          "logged_losses"],
                      "lr0_losses": refs[f"{arch} train lr0"][
                          "logged_losses"],
                      "mesh_losses": train0["logged_losses"],
                      "ms_per_step": train0["ms_per_step"],
                      "one_device_ms_per_step": refs[f"{arch} train"][
                          "ms_per_step"],
                      "one_device_peak_bytes": refs[f"{arch} train"][
                          "peak_memory_bytes"],
                      "peak_gb_by_rank": [p["peak_gb"] for p in trains],
                      "collectives_per_step": train0["mesh"][
                          "collectives_per_step"],
                      "collective_bytes_per_step": train0["mesh"][
                          "collective_bytes_per_step"],
                      "rank_bytes": train0["mesh"]["rank_bytes"],
                      "replicated_leaves_held": train0[
                          "replicated_leaves_held"],
                      "seconds_by_rank": [p["seconds"] for p in trains]}}
    emit({"phase": "mixers_mesh", "card": smi,
          "note": "two worlds of two gloo ranks and three one-device "
                  "helpers on the one card (xlstm-125m's from phase 16 "
                  "on): correctness, launches, collectives and memory, not "
                  "mesh speed",
          "kernels_at_rank_shapes": kernels, "runs": runs,
          "helper_seconds": {job: res["seconds"]
                             for job, res in refs.items()},
          "failures": failures, "seconds": time.perf_counter() - t0})
    check(not failures, "phase 18: " + " | ".join(failures))
    return by_path


# ---------------------------------------------------------------------------
# phase 19: the remaining entry points
# ---------------------------------------------------------------------------

#: the dry runs at full width: (arch, shape, mesh flag)
P19_DRYRUNS = (("qwen2.5-3b", "train_4k", []),
               ("mixtral-8x7b", "decode_32k", ["--multipod"]),
               ("recurrentgemma-2b", "long_500k", []))
#: ``bench_modes.run()`` as the port computes it on the CPU (host-only,
#: deterministic: the counter-hash channel, the orchestrator, the payload
#: model of reduced granite-8b)
P19_MODES = {
    "static_z": {"bytes": 131072000, "violations": 913,
                 "mean_acc": 0.8599999999999666, "frac_mode1": 0.0},
    "static_zp": {"bytes": 17408000, "violations": 223,
                  "mean_acc": 0.8099999999999634, "frac_mode1": 1.0},
    "dynamic": {"bytes": 70375424, "violations": 343,
                "mean_acc": 0.8332999999999651, "frac_mode1": 0.534},
    "payload": {0: 65536, 1: 8704}}
#: the reference example's defaults (reduced qwen2.5-3b, 10 requests, 4
#: slots, 16 tokens)
P19_SERVE = ["--arch", "qwen2.5-3b", "--requests", "10", "--n-slots", "4",
             "--gen", "16"]
P19_QUICKSTART = ["--steps", "3"]
P19_TIMEOUT = 600


def p19_start() -> dict:
    """Start the dry runs of ``P19_DRYRUNS`` (CPU-only subprocesses that
    touch no card and launch no kernel), all together, into a temporary
    directory, so that they run beside the card's phases; ``p19_dryruns``
    collects them and ``p19_stop`` ends any left."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="dryrun_torch_")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    for arch, shape, flag in P19_DRYRUNS:
        log = open(os.path.join(out_dir, f"{arch}__{shape}.log"), "w")
        procs.append((arch, shape, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, *flag, "--results-dir",
             os.path.join(out_dir, "records")],
            env=env, stdout=log, stderr=subprocess.STDOUT)))
    return {"dir": out_dir, "procs": procs, "t0": time.perf_counter()}


def p19_stop(started: dict) -> None:
    import shutil
    for _, _, log, proc in started["procs"]:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()
    shutil.rmtree(started["dir"], ignore_errors=True)


def p19_dryruns(started: dict) -> dict:
    """The dry runs ``p19_start`` began: each must pass its
    rank-coherence check; then the port's roofline readers over the
    records (a line and a row each)."""
    from repro_torch.benchmarks import bench_roofline, gen_experiments
    t0 = time.perf_counter()
    lines = {}
    for arch, shape, log, proc in started["procs"]:
        proc.wait(timeout=P19_TIMEOUT)
        log.close()
        with open(log.name) as f:
            text = f.read()
        lines[f"{arch} {shape}"] = [ln for ln in text.splitlines()
                                    if ln.startswith("[dryrun]")]
        check(proc.returncode == 0 and any(
            "coherent over ranks" in ln for ln in lines[f"{arch} {shape}"]),
              f"phase 19: dry run {arch} x {shape} failed:\n"
              f"{text[-3000:]}")
    out_dir = os.path.join(started["dir"], "records")
    records = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            rec = json.load(f)
        records[name] = rec
        check(rec["ranks_checked"] == [0, rec["chips"] - 1],
              f"phase 19: {name} has no coherence check")
    check(len(records) == len(P19_DRYRUNS),
          f"phase 19: {len(records)} dry-run records for "
          f"{len(P19_DRYRUNS)} runs")
    roof = bench_roofline.lines(out_dir)
    table = "\n".join(gen_experiments.table(m, False, out_dir)
                      for m in ("16_16", "2_16_16"))
    rows = [ln for ln in table.splitlines()
            if ln.startswith("| ") and not ln.startswith("| arch")]
    check(len(roof) == len(records) and len(rows) == len(records),
          f"phase 19: the readers gave {len(roof)} lines and {len(rows)} "
          f"rows for {len(records)} records")
    return {"seconds_waited": time.perf_counter() - t0,
            "seconds_since_start": time.perf_counter() - started["t0"],
            "printed": lines, "roofline_lines": roof, "table_rows": rows,
            "records": {name: {
                k: rec[k] for k in ("arch", "shape", "mesh", "chips",
                                    "roofline", "useful_ratio",
                                    "memory_analysis", "collectives",
                                    "collective_events", "ranks_checked",
                                    "differences", "run_s")}
                for name, rec in records.items()}}


def p19_split_serving() -> tuple:
    """``examples/split_serving.py --device cuda`` at the reference's
    defaults, its launches counted against its ticks and prefill
    dispatches (phase 7's rule), each request's modes and wire bytes held
    to the same example on the CPU."""
    from repro_torch.configs import get_reduced
    from repro_torch.examples import split_serving
    t0 = time.perf_counter()
    calls: dict = {}
    with counted_path(calls):
        card = split_serving.main(P19_SERVE + ["--device", "cuda"])
    check_path_launches(calls, get_reduced("qwen2.5-3b"),
                        "phase 19 split_serving")
    secs = time.perf_counter() - t0
    cpu = split_serving.main(P19_SERVE + ["--device", "cpu"])
    check(len(card["requests"]) == 10, "phase 19: split_serving finished "
          f"{len(card['requests'])} of 10 requests")
    for rid, row in cpu["requests"].items():
        got = card["requests"][rid]
        check(got["mode_counts"] == row["mode_counts"]
              and got["wire_bytes"] == row["wire_bytes"],
              f"phase 19: split_serving request {rid}: card {got} against "
              f"the CPU's {row}")
    check((card["mixed_mode_ticks"], card["decode_ticks"])
          == (cpu["mixed_mode_ticks"], cpu["decode_ticks"]),
          "phase 19: split_serving's tick summary differs from the CPU's")
    same_tokens = sum(card["requests"][r]["tokens"] == row["tokens"]
                      for r, row in cpu["requests"].items())
    return calls["launches"], {
        "seconds": secs, "launches": calls["launches"],
        "prefill_dispatches": calls.get("split_prefill_mixed", 0),
        "decode_ticks": calls["ticks"], "graphs": calls["graphs"],
        "mixed_mode_ticks": card["mixed_mode_ticks"],
        "mode_counts": card["mode_counts"],
        "requests_with_the_cpu_tokens": same_tokens}


def p19_quickstart() -> dict:
    """``examples/quickstart.py --device cuda``: finite losses, the Ensure
    line, no kernel of the six launched (training launches none)."""
    import io
    from repro_torch.examples import quickstart
    t0 = time.perf_counter()
    fns = zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = quickstart.main(P19_QUICKSTART + ["--device", "cuda"])
    text = buf.getvalue()
    print(text, end="", flush=True)
    launches = {k: f.launches for k, f in fns.items()}
    hist = out["history"]
    losses = [r["loss"] for ph in hist["phases"] for r in ph["log"]]
    losses += hist["ensure"]["losses"]
    check(all(math.isfinite(x) for x in losses),
          f"phase 19: quickstart losses {losses}")
    check("'Ensure' check" in text, "phase 19: quickstart printed no "
                                    "Ensure line")
    check(not any(launches.values()),
          f"phase 19: quickstart launched {launches}")
    return {"seconds": time.perf_counter() - t0, "losses": losses,
            "ensure": hist["ensure"], "launches": launches}


def p19_expert_parallel() -> dict:
    """``examples/expert_parallel_moe.py --device cuda``: 8 gloo ranks on
    the card, the example's own assertions."""
    from repro_torch.examples import expert_parallel_moe
    t0 = time.perf_counter()
    out = expert_parallel_moe.main(["--device", "cuda"])
    return {"seconds": time.perf_counter() - t0, **out}


def p19_benches() -> dict:
    """``benchmarks/run.py --device cuda`` over its suite table, less the
    suites an earlier phase runs (phase 10: ``kernels``)."""
    from repro_torch.benchmarks import run
    t0 = time.perf_counter()
    names = [name for name, _, _ in run.SUITES if name != "kernels"]
    fns = zero_counts()
    try:
        run.main(["--device", "cuda", "--suites", ",".join(names)])
    except SystemExit as e:
        check(e.code in (0, None), f"phase 19: benchmarks/run.py exited "
                                   f"{e.code}")
    return {"seconds": time.perf_counter() - t0, "suites": names,
            "launches": {k: f.launches for k, f in fns.items()}}


def p19_card() -> dict:
    """Phase 19's parts (b) to (f), which run in a background lane
    (``LANES``): their results, and the launches of the split_serving
    path under ``launches``."""
    from repro_torch.benchmarks import bench_modes
    t0 = time.perf_counter()
    modes = bench_modes.run()
    check(modes == P19_MODES, f"phase 19: bench_modes {modes} differs from "
                              f"the CPU's {P19_MODES}")
    launches, serving = p19_split_serving()
    free_cuda()
    quick = p19_quickstart()
    free_cuda()
    ep = p19_expert_parallel()
    benches = p19_benches()
    free_cuda()
    return {"launches": launches, "bench_modes": modes,
            "split_serving": serving, "quickstart": quick,
            "expert_parallel_moe": ep, "benches": benches,
            "seconds": time.perf_counter() - t0}


def phase_entry_points(smi: str, started: dict, card: dict) -> dict:
    """Phase 19 (see the module's docstring): the dry runs ``p19_start``
    began, and ``card``, what ``p19_card`` returned in the background
    lane; returns the launches of the split_serving path."""
    t0 = time.perf_counter()
    dry = p19_dryruns(started)
    emit({"phase": "entry_points", "card": smi,
          "note": "dry-run terms are analytic, on the H100 SXM's published "
                  "peaks (repro_torch.launch.mesh), not measured",
          "dryrun": dry, **{k: v for k, v in card.items()
                            if k not in ("launches", "seconds")},
          "lane_seconds": card["seconds"],
          "seconds": time.perf_counter() - t0})
    return {"split_serving": card["launches"]}


# ---------------------------------------------------------------------------
# the background lanes: phases 11, 13, phase 12's small half, phase 19's
# card parts and the recurrent archs' phases 6 to 9 in processes of their
# own, beside the other archs' phases 6 to 9 and phase 12
# ---------------------------------------------------------------------------

#: the background lanes, each a process of its own on the card running its
#: jobs (``lane_job``) in order, beside phases 7 to 9 and phase 12's first
#: half in the main process
LANES = (("scale_out",),
         ("cascade", "train_small", "p19_card", "serving_small"))
#: the archs whose phases 6 to 9 run in a lane (a few GB each; qwen2.5-3b's
#: stay in the main process, which the lanes' other jobs outlast)
LANE_ARCHS = ("recurrentgemma-2b", "xlstm-125m")


def lane_job(name: str, seed: int, dev, smi: str) -> dict:
    """One job of a lane: the launches of its paths (``p19_card``: its
    results, the split_serving path's launches under ``launches``)."""
    if name == "scale_out":
        return phase_scale_out(dev, smi)
    if name == "cascade":
        return {"lumos5g-lstm cascade": phase_cascade(seed, smi)}
    if name == "train_small":
        return phase_train_small(seed, dev, smi)
    if name == "serving_small":
        return phase_serving(LANE_ARCHS, smi)
    return p19_card()


def lane(rank: int, world: int, port: int, queue, *, t0: float, smi: str,
         log: str, seed: int, jobs: tuple) -> None:
    """A background lane, a process of its own group on the card: its
    ``jobs`` in order (``lane_job``), each path's launch counters at 0
    just before and read just after in this process. Its standard output
    (its children's too) goes to ``log``, which the parent prints when it
    collects the lane; its phase lines keep the script's clock (``t0``).
    The group ends itself if the parent dies. Its results by job (or its
    error) to the parent."""
    import signal
    import threading
    import traceback
    global _T0
    _T0 = t0
    os.setpgrp()                # the parent ends the lane's whole group
    parent = os.getppid()

    def orphan_guard():
        while os.getppid() == parent:
            time.sleep(1)
        os.killpg(0, signal.SIGKILL)
    threading.Thread(target=orphan_guard, daemon=True).start()
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.close(fd)
    try:
        sys.path.insert(0, str(SRC))
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        done = {}
        for name in jobs:
            done[name] = lane_job(name, seed, torch.device("cuda"), smi)
            free_cuda()
        sys.stdout.flush()
        queue.put((rank, {"jobs": done, "untraced": dict(UNTRACED)}))
    except BaseException:
        sys.stdout.flush()
        queue.put((rank, {"error": traceback.format_exc()}))


def lane_start(smi: str, seed: int, jobs: tuple) -> dict:
    """Start a ``lane`` running ``jobs`` (``start_mesh``'s processes and
    queue, its log)."""
    import functools
    import tempfile
    fd, log = tempfile.mkstemp(prefix="chip_smoke_lane_", suffix=".log")
    os.close(fd)
    procs, queue = start_mesh(1, functools.partial(
        lane, t0=_T0, smi=smi, log=log, seed=seed, jobs=jobs))
    return {"procs": procs, "queue": queue, "log": log, "jobs": jobs,
            "t0": time.perf_counter()}


def lane_collect(started: dict) -> dict:
    """Wait for a lane, print its output, fold its ``UNTRACED`` counts
    into this process's; its results by job. Raises if it failed."""
    t0 = time.perf_counter()
    try:
        res = collect_mesh(started["procs"], started["queue"])[0]
    finally:
        lane_stop(started)
    for k, v in res["untraced"].items():
        UNTRACED[k] += v
    emit({"phase": "lane", "jobs": list(started["jobs"]),
          "waited_s": time.perf_counter() - t0,
          "lane_s": time.perf_counter() - started["t0"]})
    return res["jobs"]


def lane_stop(started: dict) -> None:
    """Print the lane's output once, and end what is left of its process
    group (nothing once it returned; all of it when this process failed
    first)."""
    import signal
    for p in started["procs"]:
        if p.is_alive() or p.exitcode:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(p.pid, signal.SIGKILL)
        if p.is_alive():
            p.kill()
        p.join()
    log = started.pop("log", None)
    if log:
        with open(log) as f:
            sys.stdout.write(f.read())
        sys.stdout.flush()
        os.unlink(log)


SOURCES = {
    "boundary_mixed_grouped": "src/repro_torch/csrc/boundary_mixed.cu",
    "decode_tail_grouped": "src/repro_torch/csrc/boundary_mixed.cu",
    "paged_attention": "src/repro_torch/csrc/paged_attention.cu",
    "rglru_scan": "src/repro_torch/csrc/rglru_scan.cu",
    "bottleneck_quant": "src/repro_torch/csrc/bottleneck_quant.cu",
    "dequant_matmul": "src/repro_torch/csrc/dequant_matmul.cu",
}
REPLACES = {
    "boundary_mixed_grouped": "src/repro/kernels/boundary_mixed.py:196",
    "decode_tail_grouped": "src/repro/kernels/boundary_mixed.py:143",
    "paged_attention": "src/repro/kernels/paged_attention.py:82",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:42",
    "bottleneck_quant": "src/repro/kernels/bottleneck_quant.py:48",
    "dequant_matmul": "src/repro/kernels/dequant_matmul.py:25",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random full-width weights")
    ap.add_argument("--iters", type=int, default=15,
                    help="timed launches per kernel")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs)})
    dry = p19_start()
    try:
        return run_phases(args, dev, smi, dry)
    finally:
        p19_stop(dry)


def run_phases(args, dev, smi: str, dry: dict) -> int:
    """Phases 3 to 19 and the closing lines."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("qwen2.5-3b")
    rcfg = get_config("recurrentgemma-2b")
    xcfg = get_config("xlstm-125m")
    t0 = time.perf_counter()
    cap = capture(cfg, dev, args.seed)
    emit({"phase": "capture", "arch": cfg.name,
          "seconds": time.perf_counter() - t0,
          "lengths": [int(n) for n in cap["lens"]]})
    t0 = time.perf_counter()
    rcap = capture_recurrent(rcfg, dev, args.seed)
    emit({"phase": "capture", "arch": rcfg.name,
          "seconds": time.perf_counter() - t0, "lengths": list(RLENS)})
    t0 = time.perf_counter()
    xcap = capture_xlstm(xcfg, dev, args.seed)
    emit({"phase": "capture", "arch": xcfg.name,
          "seconds": time.perf_counter() - t0, "lengths": list(XLENS)})
    results = {}
    for r in (phase_boundary(cap, rcap, xcap, cfg, rcfg, xcfg, dev,
                             args.seed, args.iters),
              phase_tail(cap, rcap, xcap, cfg, xcfg, dev, args.seed,
                         args.iters),
              phase_paged(cap, cfg, dev, args.seed, args.iters),
              phase_rglru(rcap, xcap, dev, args.iters),
              *phase_wire(cap, rcap, cfg, rcfg, dev, args.seed, args.iters)):
        results[r["name"]] = r
    phase_rglru_layer(rcap, rcfg, dev, args.iters)
    phase_xlstm_tick(xcap, xcfg, dev, args.iters)
    del cap, rcap, xcap
    free_cuda()
    # the dense archs at full width, one model on the card at a time
    dense = [get_config(a) for a in DENSE]
    for c in dense:
        phase_dense_kernels(c, dev, args.seed, args.iters)

    # the profile summary's check (the casts' device ms of two readings
    # of one trace within 1e-4) and the bench's fused-tick gate (timed on
    # the host clock) run before the lanes share the card and the host:
    # in a lane the two readings parted by 0.5%; and after the kernel
    # phases' traces: as a process's first traced run the two readings of
    # the casts parted by 1%
    phase_profile_summary()
    bench = phase_bench()
    loops = phase_loop_speedup(dev, args.seed, smi)
    lanes = []
    try:
        for jobs in LANES:
            lanes.append(lane_start(smi, args.seed, jobs))
        return phases_beside_lanes(args, dev, smi, dry, lanes,
                                   (cfg, rcfg, xcfg, *dense),
                                   {"bench": bench, "loop_speedup": loops},
                                   results)
    finally:
        for started in lanes:
            lane_stop(started)


def phase_serving(names: tuple, smi: str) -> dict:
    """Phases 6 to 9 for the archs ``names``: the continuous engine's
    references, main path and profile, then the sync engine's, one model
    on the card at a time. Returns the launches of each path under
    ``by_path`` and the main paths' tokens under ``main_runs``."""
    from repro_torch.configs import get_config
    by_path = {}
    archs = [get_config(a) for a in names]
    for c in archs:
        phase_reference(c.name)
        if c.name == "stablelm-3b":
            phase_reference(c.name, variant=HD80)
        kept: dict = {}
        by_path[f"{c.name} continuous"] = phase_main_path(c, smi, kept=kept)
        phase_profile(c, "continuous", kept.pop("engine"))
        free_cuda()
    for c in archs:
        phase_sync_reference(c.name)
        kept = {}
        by_path[f"{c.name} sync"] = phase_sync_main_path(c, smi, kept=kept)
        phase_profile(c, "sync", kept.pop("engine"))
        free_cuda()
    return {"by_path": by_path,
            "main_runs": {k: v for k, v in MAIN_RUNS.items()
                          if k.split(" ")[0] in names}}


def phases_beside_lanes(args, dev, smi: str, dry: dict, lanes: list,
                        archs: tuple, benches: dict, results: dict) -> int:
    """Phases 6 to 9 of the archs outside ``LANE_ARCHS`` and phase 12's
    first half while the lanes run theirs (``LANES``); then the lanes'
    results, phases 14 to 18, phase 19's dry runs and the closing
    lines."""
    import torch
    by_path = phase_serving(tuple(c.name for c in archs
                                  if c.name not in LANE_ARCHS),
                            smi)["by_path"]
    train = phase_train(dev, smi)
    free_cuda()
    done = {}
    for started in lanes:
        done.update(lane_collect(started))
    by_path.update(benches)
    by_path.update(done["cascade"])
    by_path.update(train)
    by_path.update(done["train_small"])
    by_path.update(done["scale_out"])
    by_path.update(done["serving_small"]["by_path"])
    MAIN_RUNS.update(done["serving_small"]["main_runs"])
    by_path.update(phase_frontends(dev, args.seed, args.iters, smi))
    free_cuda()
    by_path.update(phase_moe(dev, args.seed, args.iters, smi))
    free_cuda()
    early = p18_start(early=True)
    try:
        by_path.update(phase_mesh(dev, args.seed, args.iters, smi))
        free_cuda()
        by_path.update(phase_train_mesh(dev, args.seed, args.iters, smi))
        free_cuda()
        by_path.update(phase_mixers_mesh(dev, args.seed, args.iters, smi,
                                         early))
    finally:
        p18_stop(early)
    by_path.update(phase_entry_points(smi, dry, done["p19_card"]))

    emit({"phase": "untraced", "measurements": UNTRACED})
    print(smi, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name],
         "launches": sum(p[name] for p in by_path.values()),
         "launches_by_path": {a: p[name] for a, p in by_path.items()},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in results.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
