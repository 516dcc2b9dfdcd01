#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths once through the entry points a user calls:
FrogWild! at LiveJournal scale (n = 4,847,571, avg out-degree 14.2,
θ = 2.2, seed 0; ``repro_torch.configs.LIVEJOURNAL_FULL``), the LM
stack's dense serving path at llama3.2-1b's full width, its MoE family
at olmoe-1b-7b's full width and depth, its recurrent families at
rwkv6-3b's and zamba2-1.2b's, and its encoder-decoder and VLM families at
whisper-medium's and llava-next-mistral-7b's, and its training, with
llama3.2-1b, rwkv6-3b and zamba2-1.2b trained at full width and depth.
It checks every answer
against its guarantee:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — the CUDA kernels, compiled from ``csrc/`` with nvcc
              (one nvcc per source, all at once);
3. data     — the graph, generated on the host and moved to the card;
4. batch    — ``FrogWildService.pagerank(ε=0.1, δ=0.1, k=100)``, held to
              its Theorem 1 bound against 50 power iterations; each of its
              32 supersteps one ``frog_superstep`` launch that draws the
              reference's threefry streams itself;
5. serving  — the walk index (each of the 8 build shards one
              ``frog_segment_walk`` launch, no ``frog_hop``), 6 top-k and
              2 PPR queries through
              ``QueryHandle.result()`` and one ``query_counts`` (its 9
              rounds and their tally one ``stitch_step_rounds`` launch),
              each held to its bound;
6. plain    — the batch run and one wave again through the plain PyTorch
              versions, their draws through ``prng``'s plain version
              (``prng.draw_impl("torch")``, no draw kernel launched),
              byte-equal to the kernel path;
7. stream   — ``pagerank`` again with ``step_impl="stream"``: the slab
              layout's build time, ``E_blk`` and bytes; counts byte-equal
              to phase 4's and within the same bound;
8. sharded  — ``num_shards=8`` with ``step_impl="stream"``: the index built
              through the streamed kernel (L sorted hops a build shard and
              one ``frog_segment_masks`` pass) equals phase 5's slab
              row-padded;
              phase 5's 8 queries under ``sharded_dispatch="fused"`` and
              ``"loop"`` give phase 5's answers byte for byte, the loop
              wave's rounds one ``stitch_gather_local_rounds`` launch a
              wave; one wave with shard 3 lost is byte-equal between the
              two dispatches;
17. faults  — (runs after phase 8, which it reads) checkpoints and the
              wave supervisor: a service with ``checkpoint_dir`` builds
              and persists the dense index (time, bytes), a second loads
              it and answers phase 5's queries byte for byte; phase 8's
              blocks persisted one dir a shard, shards 2 and 5 corrupted
              and truncated by a ``FaultPlan``, quarantined and rebuilt
              through ``frog_segment_walk`` (2 launches, the blocks and their
              visited-block masks byte-equal to the originals; the
              repair's and a full build's times; the checkpoints hold the
              masks, so their bytes are logged beside the slab's);
              phase 8's queries under a transient fault and an injected
              timeout (byte-equal, two retries logged), under the loss of
              shard 3 at wave 1 through the fused and the loop wave
              (equal degraded answers, each bound Theorem 1's at the
              executed walks) and with supervision armed and no fault;
              the degraded loop wave under the profiler; its rounds' call
              over a table with shard 3's entry null under
              ``torch.cuda.set_sync_debug_mode("error")`` (no host sync),
              against its plain version, event-timed with the mask's host
              copy and without it. The checkpoints live in a temporary
              directory, removed at the end;
18. dynamic — (runs after phase 17) the reference benchmark's mutation
              batch (``benchmarks/bench_query.py``: inserts ``(v, (v·7 +
              13) mod n)`` over the block-aligned window of ``n // 100``
              vertices with the fewest in-edges) compacted into epoch 1;
              phase 5's index refreshed (``refresh_walk_index``, the stale
              rows re-walked through ``frog_segment_walk`` with their
              masks, one launch a chunk) and the 8-shard fused service's
              blocks refreshed through ``frog_hop_stream_sorted`` and
              ``frog_segment_masks``, each byte-equal (endpoints and
              masks) to a full build at epoch 1, with the refresh's and the
              full build's times and launches; phase 5's 8 queries on a
              service of their own, one wave stepped, ``apply_mutations``,
              then drained: each answer byte-equal to phase 5's and at
              epoch 0, a fresh query at epoch 1; the refreshed index
              through ``save_epoch_index`` / ``load_epoch_index`` (bytes,
              seconds); and a 100,000-vertex build and refresh on the card
              and on the CPU, resident and streamed, byte-equal masks;
19. gateway — (runs after phase 18) ``Gateway.open(g, RuntimeConfig(),
              replicas=2)``: both replicas' ``ensure_index()`` one object
              (one ``data_ptr()`` each for endpoints and masks), the
              allocator grown by less than 1.5 × one index's bytes, the
              index equal to phase 5's; phase 5's 8 queries through it
              (the first top-k live, its 5 twins joined, the PPRs live),
              each live answer byte-equal to a direct service's over the
              same index given the same requests on the same replica, each
              joined one its parent's object; the 8 again at ε = 0.33,
              which their certificates (0.3267: t = 32 caps the ε = 0.3
              plan) dominate, all from the cache with no wave, and a
              repeat at ε = 0.3 live; an in-flight join (the identical
              target the parent's object, ε = 0.5 settled no later); the
              batch estimate at ε = 0.1 live (32 ``frog_superstep``
              launches, phase 4's top-100) and at ε = 0.23 from the cache
              (none); ``serve_http`` on 127.0.0.1: a live ``/topk`` from a
              handler thread read back from the cache, a cached one equal
              to the in-process answer, ``/healthz``, ``/metrics``; on
              gateways of their own without the cache, replica 0 crashed
              at its first wave (one failover, byte-equal to the fault-free
              answer), replica 0 stalled past a 1 s heartbeat (quarantined,
              rerouted, byte-equal), overload shedding (distinct PPR
              sources past one plan's walks: 7 of 8 shed with
              ``retry_after_s`` > 0, HTTP 503 with ``Retry-After``) and
              ``drain()``; ``Gateway.apply_mutations`` of phase 18's batch
              with a query in flight on a restarted (cold) replica: one
              refresh (one ``frog_segment_walk`` a 1,024-row chunk, as
              phase 18's commit, no ``frog_hop``), both replicas on its
              index, the pinned answer byte-equal to a direct service's at
              epoch 0, a repeat live at epoch 1;
9. erasure  — the quickstart's partial-synchronization walk
              (``examples/quickstart.py``: 400,000 frogs, t =
              ``suggested_steps(μ_20(π))``, p_s = 0.7, channel erasure over
              16 shards, draw ``auto``), then the independent model and the
              cumsum draw of both; each held to Theorem 1 with p_s;
10. graphlab_pr — ``to_ell(g, K=32)``, ``power_iteration(spmv="ell")``
              against the COO iteration, the reduced-iteration baseline
              and the Figure 1 rows (ms per iteration and per superstep,
              the wire-byte models);
11. erasure_cpu — the six (model × draw) walks on a 100,000-vertex graph,
              on the card and with ``device="cpu"``: byte-equal, the card's
              draws the threefry kernels (one launch a draw, counted), the
              CPU's ``prng``'s plain version;
14. lm_prefill — llama3.2-1b at full width and depth (1.24 B parameters,
              random, ``torch.Generator`` seed 0): ``forward_train`` on
              1 × 32,768 tokens (``prefill_32k``'s length, batch cut from
              32 to 1), ``flash_attention`` launched once a layer, then
              the same forward again (without the first call's set-up); bf16
              logits within 5e-2 relative Frobenius of the plain path's;
              each of the 16 launches within ``ATTN_REL`` of the chunked
              version on its own inputs; float32 at S = 4,096: logits
              within 1e-3 of max |logits| and each layer's attention
              output within ``ATTN_REL``, which a planted fault must fail;
15. lm_serve — the serving launcher's 6 requests (``max_batch`` 4,
              ``max_len`` 256, 16 new tokens, greedy) through
              ``BatchScheduler``; ms per ``serve_step`` at B = 4; decode
              logits (relative error ≤ 1e-3) and each layer's attention
              output (``ATTN_REL``) against the forward's at 64 positions
              in float32, a gate a planted decode fault must fail;
16. lm_cpu  — the reduced llama3.2-1b's 6 requests on the card and on the
              CPU: equal tokens (a near tie, top-2 margin < 1e-4,
              printed), each decode step's logits and attention outputs
              within ``ATTN_REL`` of the CPU's, a gate a planted decode
              fault on the card must fail (the random tied-embedding
              model echoes its prompt, so its tokens alone show little);
12. kernels — each kernel at the main path's shapes against its plain
              version (byte-equal; ``flash_attention`` within 2e-2 in bf16
              and 2e-3 in float32 of ``attention_ref`` at S = 4,096 and of
              the chunked version at 32k, and within ``ATTN_REL``'s
              relative Frobenius error over all rows and the last eighth,
              a gate two planted faults must fail at 32k), with its time,
              bound and launches; the draw kernels (``frog_superstep`` and
              its streamed twin over the batch walk's 32 supersteps of
              400,000 frogs, ``frog_hop`` and its twin at one build
              shard's 9.7 M walks, and the shard's whole segment walk
              recording its visited-block masks: ``frog_segment_walk``
              (one launch), the
              per-hop resident walk it replaced (``frog_hop:masks``), the
              streamed walk with its mask pass
              (``frog_hop_stream_sorted:masks``) and the pass alone
              (``frog_segment_masks``), all under one bound)
              byte-equal to their plain versions at every step, with
              byte and operation bounds from the run's states, planted wrong streams (``k_die`` and ``k_move``
              swapped, the sorted index as counter) that the gate must
              see, and the same walk with the caller's draws
              (``prng`` outside, the caller-bits ``frog_step``); the 8
              shards' ``stitch_step_local`` summed against
              ``stitch_step``; ``stitch_gather``'s whole call on the host
              clock; ``stitch_gather_rounds`` (the wave's rounds in one
              launch) against its plain version without a mask and with
              shard 3 of 8 lost, beside the same rounds as
              ``torch.take`` + ``torch.where``; the loop wave's rounds over
              the 8 shard blocks in one launch (``stitch_gather_local_
              rounds``), also over 7 blocks each allocated apart and
              shard 3's table entry null, against its plain version and
              the fused wave's; ``query_counts``' rounds with their tally
              in one launch (``stitch_step_rounds``) beside the same
              rounds as ``torch.take`` + ``torch.where`` + ``index_add_``;
              the device time a launch of these and of ``stitch_step``
              from a trace; the stitch kernels under ``rng="device"`` (the
              wave's key as operand, ``s0`` drawn in the kernel; the rounds
              kernels as rows, the four per-round kernels as checks)
              against their caller mode on ``prng``'s ``s0``; the threefry
              draw kernels (``csrc/threefry_draw.cu``) at the main path's
              shapes — ``randint`` over the batch walk's 400,000 starts,
              ``uniform`` over a wave's 8,192 lengths, ``bernoulli`` over
              the channel coins (n, 16), ``fold_in`` over a build shard's
              605,947 rows, ``split`` into 65 step keys, ``random_bits``
              at 400,000 — byte-equal to ``prng``'s plain version, each
              first run, and a wave prologue's draws (one launch each,
              asserted), under ``torch.cuda.set_sync_debug_mode("error")``,
              with planted wrong streams (randint's streams swapped, the
              counter off by one) that must read ``caught=True``;
              ``spmv_ell_slab`` over the live lanes (``row_len``), its
              every-lane mode, and K = 40 with and without ``row_len``;
              ``flash_attention`` also with the design its bf16
              calls ran (``wgmma``; float32 runs the SIMT kernel), its
              TFLOP/s, SDPA timed beside it at 32k and at the three
              check shapes, and SDPA's own reading under the 32k gate
              (information);
13. profile — a batch run (resident and streamed), an index build (resident
              and streamed), a serving wave (dense),
              a loop wave (8 shards; one ``stitch_gather_local_rounds``
              launch, asserted), a ``query_counts`` (one
              ``stitch_step_rounds`` launch, asserted; the dense wave, the
              loop wave and ``query_counts`` one threefry launch a draw
              and no ``s0`` draw, asserted), the ELL power
              iteration, the
              quickstart's erasure run, one 32k prefill forward and one
              ``serve_step`` under torch.profiler: wall time against
              device-busy time (the idle share), the port's kernels'
              launches and device time by name, the ELL iteration's five
              costliest device operations, and ``flash_attention``'s
              share of the prefill's device time;
20. moe     — (runs last, once the llama model and the FrogWild! tensors
              are released; the allocator's bytes logged) olmoe-1b-7b at
              full width and depth (6.92 B parameters, 1.28 B active,
              random, seed 0): phase 14's prefill and gates on 1 ×
              32,768 tokens (``flash_attention`` launched 16 times at 16
              heads of 128, bf16 logits within 5e-2 of the plain path's);
              each layer's dropped (token, pick) pairs; layer 0 in float32
              over one 4,096-token routing group of its prefill input,
              ``dropped`` equal to a plain count and the output on 256
              tokens that kept every pick within 1e-4 of
              ``moe_mixture_ref``, a gate a planted router fault (each
              token's first two weights swapped) must fail; phase 15's
              launcher run and serving invariant (at capacity factor E / k,
              where nothing drops); ``flash_attention`` at its shape
              against SDPA; the prefill and one ``serve_step`` under the
              profiler, device ms split into attention, the MoE stages
              (``moe.route``, ``moe.dispatch``, ``moe.experts``,
              ``moe.combine``) and the rest; phase 16 on the reduced
              olmoe; phi3.5-moe at full width cut from 32 to 2 layers,
              phase 14's prefill and gates at S = 4,096 (32/8 GQA heads of
              128, top-2 of 16 experts at d_ff 6,400); the peak memory;
21. recurrent — (runs after phase 20 has released its models, the peak
              memory counter reset) rwkv6-3b (32 layers, 40 heads of 64)
              and zamba2-1.2b (38 Mamba-2 layers, 64 heads of 64 and a
              state of 64; the shared attention block after every 6th)
              at full width and depth, random, seed 0, each in turn:
              ``param_count`` and the tree's count; the 32k prefill, first
              call and warm (``wkv6_scan`` 32 or ``ssd_scan`` 38 launches,
              ``flash_attention`` 0 or 6, asserted); the scan against its
              plain version in float32 on layer 0's real inputs at S =
              4,096, at the next step (S = 1) and at B = 4 from a nonzero
              state, within 1e-5 relative Frobenius; the bf16 logits
              within 5e-2 of the plain path's (per-step scans and chunked
              attention) at S = 1,024; layer 0's recurrence over 2,048
              tokens as two halves with the state carried, within 1e-5 of
              one run, a gate a dropped carry must fail; phase 15's
              launcher run and serving invariant (a dropped decode state
              must fail the logits gate; zamba2's planted attention fault
              the attention gate; each of its 6 sites its own cache);
              ``init_decode_state`` at ``long_500k``'s 524,288 positions
              (the state's and the site caches' bytes against the
              analytic counts) and three ``serve_step`` there;
              ``flash_attention`` at zamba2's shape (32 heads of 64, MHA)
              against SDPA; the prefill and one ``serve_step`` under the
              profiler, device ms by stage (``rwkv.time_mix``,
              ``rwkv.scan``, ``rwkv.channel_mix``; ``mamba.proj``,
              ``mamba.conv``, ``mamba.scan``, ``mamba.out``,
              ``shared_attn``); the scan's row (ms at the prefill shape,
              its bound, the plain loop's ms at S = 4,096); phase 16 on
              the reduced model (a dropped state planted for rwkv6);
22. encdec  — (runs after phase 21 has released its models, the peak
              memory counter reset) whisper-medium at full width and
              depth (24 + 24 layers, d 1,024, 16 heads of 64, random,
              seed 0): the tree's count against ``param_count``; phase
              14's prefill and gates on 32,768 decoder tokens over 1,500
              frames (``flash_attention`` launched 72 times, counted by
              shape in that forward: 24 encoder, non-causal, 24 decoder
              self, 24 cross at 32,768 × 1,500; the float32 gate's
              planted fault the reference's K/V padded to the 64-key
              tile); the launcher's 4 requests through
              ``BatchScheduler``, its wave's ``prefill`` handed the frames
              by this script (``prefill(encoder_frames=)``; no user path
              serves whisper: the scheduler passes none and raises, as
              the reference's), 16 greedy ``serve_step``s, ms
              per ``serve_step`` at B = 4, the encoder's time in
              ``init_decode_state``, the cross caches' bytes against the
              analytic 589,824,000, and phase 15's invariant over the
              decoder's self- and cross-attention outputs (a zeroed cross
              K/V must fail it); ``flash_attention`` at the encoder, cross
              and decoder-self shapes (rows) and non-causal at 1,000 and
              1 × 1,500 (checks) against the chunked version and SDPA;
              the prefill and a ``serve_step`` profiled by stage
              (``encdec.encoder``, ``encdec.cross``, and attention inside
              each); phase 16 on the reduced whisper;
23. vlm     — (after phase 22, the peak memory counter reset)
              llava-next-mistral-7b at full width and depth (32 layers,
              32/8 heads of 128, d_ff 14,336, random, seed 0): the tree's
              count; phase 14's prefill and gates on 2,880 patch
              embeddings + 29,888 tokens (32 launches, every gate over
              the prefix positions too; float32 at 2,880 + 1,216); phase
              15's launcher run (text only) and invariant against a
              forward with an empty prefix; ``flash_attention`` at its
              shape against SDPA; the prefill and a ``serve_step``
              profiled; the peak memory (under 80 GB); phase 16 on the
              reduced llava;
24. training — (after phase 23, the peak memory counter reset) the
              ``flash_attention_bwd`` kernel against its plain version
              (``ref.attention_bwd_ref``): float32 at S = 4,096 with
              llama's heads on the SIMT route (relative Frobenius of dq,
              dk and dv ≤ 1e-5, a gate that two planted faults must
              fail: Δ left out, the GQA sum over one head of each
              group), the same in bf16 on the tensor-core route (≤ 1e-2,
              the same two faults caught), bf16 at 1 × 32,768 and at
              the training shape 2 × 4,096 (≤ 1e-2 against the plain
              backward in float32 on the same inputs),
              head dims 120, 128 and 256, a window, a soft cap,
              non-causal 1,500², cross 4,096 × 1,500 and rows with no
              live key (gradient 0); its ms (events and a trace, device
              ms and TFLOP/s by pass), bound and SDPA's backward ms at
              the 32k shape and at the training shape (2 × 4,096), and
              the forward's ms with and without the LSE; then
              llama3.2-1b trained at
              full width and depth (bf16 compute, float32 master
              weights, AdamW with weight decay 0.1, ``SyntheticTokens``
              at B = 2, S = 4,096): two runs of the first step's
              gradients byte-equal, 4 steps without ``remat`` and 2 with
              (loss, grad norm, s a step, tokens/s, peak memory, 16
              ``flash_attention`` and 16 ``flash_attention_bwd``
              launches a step, 32 forwards under ``remat``, every
              backward on the tensor-core route), the step's
              gradients through the kernels against the plain path's
              (``attn_impl="torch"``: every leaf within 5e-2 in bf16 at
              1 × 1,024; within 1e-4 in float32 at 2 layers, ``remat``
              within 1e-6 of no ``remat``), a planted fault (the
              kernel's output detached, the fault the port had before
              its backward) that the float32 gate must fail, and the
              peak memory (under 80 GB); one more step traced (device
              busy and idle share, the attention kernels' share);
25. recurrent_training — (after phase 24, the peak memory counter
              reset) the ``wkv6_scan_bwd`` and ``ssd_scan_bwd`` kernels
              against their plain twins (``ref.wkv6_scan_bwd_ref``,
              ``ref.ssd_scan_bwd_ref``) at rwkv6-3b's 40 heads of 64 and
              zamba2-1.2b's 64 heads of 64 with a state of 64: float32 at
              1 × 4,096 and 2 × 33 from a nonzero state with a nonzero
              state gradient (every gradient within 1e-5 relative
              Frobenius, a gate that the dropped state gradient — dS0 or
              dh0 zeroed — must fail), bf16 at the training shape 2 ×
              4,096 against the float32 twin on the same inputs (1e-2),
              every run repeated byte for byte; each forward without grad
              byte-equal to the launch that writes its chunk checkpoints;
              then rwkv6-3b and zamba2-1.2b, each in turn, trained at full
              width and depth (bf16 compute, float32 master weights, AdamW
              with weight decay 0.1, ``remat``, ``SyntheticTokens`` at B =
              2, S = 4,096): two runs of the first step's gradients
              byte-equal, 4 steps (loss, grad norm, s a step, tokens/s,
              peak memory under 80 GB; a step's launches asserted:
              ``wkv6_scan`` 64 and ``wkv6_scan_bwd`` 32, or ``ssd_scan``
              76, ``ssd_scan_bwd`` 38, ``flash_attention`` 12 and
              ``flash_attention_bwd`` 6 on the tensor-core route), one more
              step traced (device busy, idle share, the scan kernels'
              share, the top kernels), and, on the initial weights before
              those steps (a state no kernel under test produced), the
              step's gradients against the plain path's (the scans with
              ``impl="torch"``, ``attn_impl="torch"``: bf16 on the full
              model at 1 × 1,024,
              every leaf within 5e-2 but the named leaves whose gradient is
              a sum that nearly cancels — rwkv's ``u``, zamba2's ``w_in_B``,
              ``w_in_C`` and block norm scale — which bf16 rounding in the
              activations moves by several percent and which are held to
              0.15 instead, reported as not meeting 5e-2; the backward
              kernel on that step's first and last layers' own inputs and
              output gradients against its twin, 1e-2; float32 at 2 layers
              within 1e-4, ``remat`` within 1e-6, a planted fault — the
              scan's output detached — caught); the two
              kernels' rows (ms by events and device ms from a trace at
              the training shape and at 1 × 32,768, the bound, the plain
              twin's ms at 2 × 4,096, no library call).

Phases 14-16 run after phase 11 and before 12 and 13, which read them.
Launch counts are reset just before phase 4 and read just after phase 5
(slice 1's path), reset just before phase 7 and read just after the
queries of phase 8 (the streamed and sharded paths), reset just before
phase 9 and read just after phase 10's ELL power iteration (the erasure
walks and the GraphLab-PR baseline), reset just before the 32k forward of
phase 14 and read just after it, reset just before phase 15's
scheduler run and read just after it, in phase 17 reset just before
the repair and each degraded service's queries and read just after each,
in phase 18 reset just before each refresh and the pinned service's run
and read just after each, and in phase 19 (the gateway's path) reset just
before ``Gateway.open`` and read just after the HTTP requests, and reset
just before ``Gateway.apply_mutations`` and read just after it, and in
phase 20 reset just before each prefill forward and the launcher's run
and read just after each, and in phase 21 reset just before each
architecture's first prefill forward and the launcher's run and read just
after each, and in phases 22 and 23 reset just before the first prefill
forward and the serving run and read just after each, and in phase 24
reset just before the first of the 6 training steps and read just after
the last, and in phase 25 reset just before each architecture's first of
4 training steps and read just after the last;
phases 6, 11, 12 and 13 reset them around each run whose draw launches
they count.
The last line is ``{"ok": true, "device": {...}}``; any failed check or
launch raises and exits non-zero, as does a machine without CUDA.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")


def livejournal():
    """The LiveJournal workload's config (``repro_torch.configs.
    LIVEJOURNAL_FULL``), imported once the port is on the path."""
    from repro_torch.configs import LIVEJOURNAL_FULL
    return LIVEJOURNAL_FULL


# examples/quickstart.py: N = 400,000 frogs, p_s = 0.7, channel erasure over
# 16 destination shards, accuracy at k = 20
QUICKSTART = dict(num_frogs=400_000, p_s=0.7, shards=16, k=20)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM published memory rate
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
# integer issue rate: 132 SMs x 64 INT32 lanes x the SM clock that
# nvidia-smi reads (phase 1); a threefry-2x32 block is about 75 of them
INT32_LANES = 132 * 64
THREEFRY_OPS = 75
INT32_OPS_PER_S = [None]
REPS = 50
SHARDS = 8
# the LM stack: llama3.2-1b at full width and depth
# (src/repro_torch/configs/llama32_1b.py), random weights from seed 0;
# the prefill at prefill_32k's length with its batch cut from 32 to 1
# (the [32, 32768, 128256] bf16 logits alone would be 269 GB)
LM_ARCH = "llama3.2-1b"
LM_PREFILL = dict(batch=1, seq=32_768, gate2_seq=4_096)
# the serving launcher's workload (python -m repro_torch.launch.serve)
LM_SERVE = dict(requests=6, max_new=16, max_batch=4, invariant_seq=64)
# the MoE family (phase 20): olmoe-1b-7b at full width and depth
# (src/repro_torch/configs/olmoe_1b_7b.py), random weights from seed 0,
# the prefill at LM_PREFILL's shape; its float32 layer gate over one
# routing group of layer 0's prefill input, on the first 256 tokens that
# kept every pick, at the config's capacity factor and at 1.0 (C = 512,
# the mean load, where pairs drop); phi3.5-moe at full width with its depth cut from 32 to
# 2 layers (its 41.9 B parameters are 83.7 GB in bf16 alone), one forward
# at S = 4,096
MOE_ARCH = "olmoe-1b-7b"
MOE_LAYER_GATE = dict(seq=4_096, tokens=256, tight_factor=1.0)
MOE_PHI = dict(arch="phi3.5-moe-42b-a6.6b", layers=2, seq=4_096)
MOE_STAGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
# the recurrent families (phase 21): rwkv6-3b and zamba2-1.2b at full width
# and depth (src/repro_torch/configs/rwkv6_3b.py, zamba2_1b.py), random
# weights from seed 0, the prefill at LM_PREFILL's shape; each scan against
# its plain version on layer 0's inputs at 4,096 steps (float32); the bf16
# forward against the plain path at 1,024 tokens (its per-step loops rule
# out 32k); the state carried over two halves of 2,048 tokens; the decode
# state at long_500k's 524,288 positions
RECURRENT_ARCHS = ("rwkv6-3b", "zamba2-1.2b")
RECURRENT = dict(gate_seq=4_096, plain_seq=1_024, carry_seq=2_048,
                 long_len=524_288)
RECURRENT_STAGES = {"ssm": ("rwkv.time_mix", "rwkv.scan",
                            "rwkv.channel_mix"),
                    "hybrid": ("mamba.proj", "mamba.conv", "mamba.scan",
                               "mamba.out", "shared_attn")}
SCAN_KERNEL = {"ssm": "wkv6_scan", "hybrid": "ssd_scan"}
SCAN_SOURCE = {"wkv6_scan": "wkv6.cu", "ssd_scan": "ssd_scan.cu"}
# no TPU kernel: the reference's lax.scan each replaces
SCAN_REPLACES = {"wkv6_scan": "src/repro/models/rwkv6.py:121 (lax.scan, "
                 "no Pallas kernel)",
                 "ssd_scan": "src/repro/models/mamba2.py:110 (lax.scan, "
                 "no Pallas kernel)"}
FP32_FLOP_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12           # H100 SXM dense TF32 tensor-core peak
SSD_CHUNK = 32                     # csrc/ssd_scan.cu's chunk L
# the encoder-decoder and VLM families (phases 22, 23): whisper-medium and
# llava-next-mistral-7b at full width and depth
# (src/repro_torch/configs/whisper_medium.py, llava_next_mistral_7b.py),
# random weights from seed 0, the prefill at LM_PREFILL's shape: whisper's
# 32,768 decoder tokens over 1,500 frames, llava's 2,880 patch embeddings
# and 29,888 tokens (the reference's S − num_prefix_embeddings); their
# float32 gates at 4,096 positions (llava: 2,880 + 1,216)
ENCDEC_ARCH = "whisper-medium"
VLM_ARCH = "llava-next-mistral-7b"
ENCDEC_STAGES = ("encdec.encoder", "encdec.cross")
# flash_attention at whisper's non-causal shapes (bf16): B, Hq, Hkv, Sq,
# Skv, D; the path's (the encoder over 1,500 frames, the decoder's
# cross-attention at prefill_32k's length) and two checks: a length off
# the 64-key tile too, and one query over the frames
FA_ENCDEC = {"whisper_encoder": (1, 16, 16, 1500, 1500, 64),
             "whisper_cross": (1, 16, 16, 32_768, 1500, 64)}
FA_ENCDEC_CHECKS = {"noncausal_1000": (1, 16, 16, 1000, 1000, 64),
                    "cross_1_1500": (1, 16, 16, 1, 1500, 64)}
# those rows' device time alone (queued_ms): calls queued behind a spin of
# SPIN_CYCLES clock cycles (about 25 ms on an H100)
FA_QUEUED_CALLS = 20
SPIN_CYCLES = 50_000_000
# flash_attention against attention_ref at S = 4,096 (a 32k oracle would
# hold 137 GB of logits): B, Hq, Hkv, Sq, Skv, D, window, causal, cap,
# q_offset, dtype, max abs tolerance (tests/test_kernels.py:153's)
FA_CHECKS = {
    "llama3.2-1b": (1, 32, 8, 4096, 4096, 64, None, True, None, 0,
                    "bfloat16", 2e-2),
    "gemma3-4b_local": (1, 8, 4, 4096, 4096, 256, 1024, True, None, 0,
                        "bfloat16", 2e-2),
    "softcap_offset_ragged": (1, 8, 2, 4096, 4000, 128, None, False, 30.0,
                              96, "float32", 2e-3),
}
# relative Frobenius limits on attention outputs, over all rows and over
# the last eighth (whose outputs are the smallest, |out| ~ (i/e)^-1/2 for
# unit-normal q, k, v). Sound H100 runs read at most 1.4e-4 in bf16 (both
# sides round the same float32 value, so few elements differ) and 1.9e-6
# in float32 (reduction order); the planted faults read 0.045 and above
ATTN_REL = {"bfloat16": 1e-3, "float32": 1e-5}


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def time_ms(fn, reps: int = REPS, warmups: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events,
    after ``warmups`` warm-up calls)."""
    import torch
    for _ in range(warmups):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, calls: int = FA_QUEUED_CALLS) -> tuple:
    """``(ms, host ms, spin ms)``: the device time a call of ``fn()``
    with the host's launch path hidden. The card spins
    (``torch.cuda._sleep``) while the host queues ``calls`` calls behind
    the spin; events time the queue. The reading holds only where the
    host's queueing time is under the spin's."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    mid.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    return mid.elapsed_time(end) / calls, host, start.elapsed_time(mid)


def time_ms_auto(fn) -> tuple:
    """``(ms, reps)``: :func:`time_ms` over 50 calls, or over 5 for a call
    above 10 ms (one call timed first, after the warm-ups)."""
    one = time_ms(fn, reps=1)
    reps = REPS if one < 10.0 else 5
    return time_ms(fn, reps=reps), reps


def sectors(idx) -> int:
    """Distinct 32-byte sectors of an int32 array touched at ``idx``."""
    import torch
    return int(torch.unique(idx.long() // 8).numel())


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def ops_bound_ms(blocks: int) -> float:
    """The least time ``blocks`` threefry blocks take at the card's integer
    issue rate."""
    return blocks * THREEFRY_OPS / INT32_OPS_PER_S[0] * 1e3


def rounds_sectors(pos, q, s0, slab, q_max, lost=None, S=1, sz=0) -> int:
    """Distinct 32-byte slab sectors each of a wave's stitch rounds
    gathers, summed over the rounds: round ``j`` reads at the positions
    the plain version leaves after ``j`` rounds, for the walks with ``j <
    q`` it leaves alive."""
    import torch
    from repro_torch.kernels import ref as kref
    R = slab.shape[1]
    total = 0
    for j in range(q_max):
        p, alive = kref.stitch_gather_rounds_ref(pos, q, s0, slab, j, lost,
                                                 S, sz)
        move = (j < q) if alive is None else (j < q) & alive
        at = p.long() * R + torch.remainder(torch.abs(s0 + j), R).long()
        total += sectors(at[move])
    return total


def device_ms_per_launch(fn, kernel: str, calls: int = 20) -> tuple:
    """``(launches, device ms a launch)`` of ``kernel`` in a trace of
    ``calls`` calls of ``fn``: an event-timed call of a short kernel reads
    its launch path, the trace the kernel alone."""
    n_k, ms = device_busy_ms(lambda: [fn() for _ in range(calls)],
                             by_kernel=True)[3].get(kernel, (0, 0.0))
    return n_k, ms / n_k if n_k else "not measured"


LAUNCH_PATH_CALLS = 1000


def host_us(fn) -> float:
    """Host µs per call of ``fn`` (``time.perf_counter`` over 1,000 calls,
    after 10 warm-ups)."""
    for _ in range(10):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(LAUNCH_PATH_CALLS):
        fn()
    us = (time.perf_counter() - t0) / LAUNCH_PATH_CALLS * 1e6
    sync()
    return us


def card_name_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device():
    import torch
    smi = card_name_power()
    print(smi, flush=True)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    INT32_OPS_PER_S[0] = INT32_LANES * mhz * 1e6
    name = torch.cuda.get_device_name(0)
    log("1 device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, sm_max_mhz=mhz,
        int32_ops_per_s=INT32_OPS_PER_S[0])
    return name, smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    regs = [ln.strip() for ln in build.BUILD_INFO.get("log", "").splitlines()
            if "registers" in ln or "spill" in ln]
    log("2 build", seconds=time.perf_counter() - t0,
        built=build.BUILD_INFO.get("built"), ptxas=json.dumps(regs))


def phase_data(dev):
    from repro_torch.graph import chung_lu_powerlaw
    t0 = time.perf_counter()
    lj = livejournal()
    g = chung_lu_powerlaw(lj.n, avg_out_deg=lj.avg_out_deg, theta=lj.theta,
                          seed=lj.seed)
    t_gen = time.perf_counter() - t0
    g = g.to(dev)
    log("3 data", n=g.n, nnz=g.nnz, gen_s=t_gen,
        csr_bytes=4 * (2 * g.n + 1 + g.nnz))
    return g


def sync():
    import torch
    torch.cuda.synchronize()


def phase_batch(svc, dev):
    import torch
    from repro_torch.core import mass_captured, power_iteration
    from repro_torch.query.engine import plan_query
    eps, delta, k = 0.1, 0.1, 100
    rc = svc.config
    plan = plan_query(k, eps, delta, p_T=rc.p_T,
                      max_steps=rc.serving.max_steps)
    sync()
    t0 = time.perf_counter()
    res = svc.pagerank(epsilon=eps, delta=delta, k=k)
    sync()
    t_pr = time.perf_counter() - t0
    N = res.num_frogs
    assert (N, plan.num_steps) == (400_000, 32), (N, plan.num_steps)
    assert int(res.counts.sum()) == N, "frogs not conserved"
    assert bool(torch.isfinite(res.pi_hat).all())
    t0 = time.perf_counter()
    pi = power_iteration(svc.graph, num_iters=50, p_T=rc.p_T)
    sync()
    t_pi = time.perf_counter() - t0
    mu_hat = float(mass_captured(res.pi_hat, pi, k))
    mu_opt = float(mass_captured(pi, pi, k))
    ok = mu_hat >= mu_opt - plan.epsilon_bound
    log("4 batch", N=N, t=plan.num_steps, pagerank_s=t_pr,
        power_iter_s=t_pi, mu_hat=mu_hat,
        mu_opt=mu_opt, epsilon_bound=plan.epsilon_bound,
        ok=ok)
    assert ok, "batch estimate misses its Theorem 1 bound"
    return res, pi


def phase_serving(svc, pi, dev):
    import torch
    from repro_torch import prng
    from repro_torch.core import mass_captured
    from repro_torch.query.engine import plan_query, query_counts
    g = svc.graph
    sync()
    t0 = time.perf_counter()
    index = svc.ensure_index()
    sync()
    t_idx = time.perf_counter() - t0
    assert index.endpoints.shape == (g.n, svc.config.serving
                                     .segments_per_vertex)
    hubs = [int(v) for v in torch.argsort(g.out_deg.cpu(),
                                          stable=True)[-2:]]
    t0 = time.perf_counter()
    handles = submit_queries(svc, hubs)
    results = [h.result() for h in handles]
    t_serve = time.perf_counter() - t0
    mu_opt = float(mass_captured(pi, pi, 10))
    for h, r in zip(handles, results):
        if r.kind == "topk":
            mu = float(pi[torch.as_tensor(r.vertices, device=dev)].sum())
            assert mu >= mu_opt - r.epsilon_bound, (r.rid, mu, mu_opt,
                                                    r.epsilon_bound)
        else:
            assert int(r.vertices[0]) == h.request.source, r
            assert float(r.scores[0]) >= 0.10, r
    lat = [r.latency_s for r in results]
    waves = svc.scheduler.stats().waves_run
    log("5 serving", index_s=t_idx, queries=len(results),
        serve_s=t_serve, waves=waves,
        query_latency_s=json.dumps(lat),
        mu10=json.dumps([float(pi[torch.as_tensor(
            r.vertices, device=dev)].sum()) for r in results[:6]]),
        mu10_opt=mu_opt,
        eps_bound=results[0].epsilon_bound,
        ppr_scores=json.dumps([float(r.scores[0])
                               for r in results[6:]]))
    # the single-query path through the tallying stitch kernel
    plan = plan_query(10, 0.3, 0.1, p_T=svc.config.p_T,
                      max_steps=svc.config.serving.max_steps,
                      segments_per_vertex=index.segments_per_vertex,
                      segment_len=index.segment_len)
    sync()
    t0 = time.perf_counter()
    counts = query_counts(g, index, plan, prng.PRNGKey(7, dev),
                          p_T=svc.config.p_T)
    sync()
    t_q = time.perf_counter() - t0
    assert int(counts.sum()) == plan.num_walks
    mu = float(mass_captured(counts.float(), pi, 10))
    log("5 query_counts", walks=plan.num_walks, seconds=t_q,
        mu10=mu, ok=mu >= mu_opt - plan.epsilon_bound)
    assert mu >= mu_opt - plan.epsilon_bound
    return index, hubs, results


def submit_queries(svc, hubs):
    """Phase 5's queries: 6 top-k and 2 PPR from the hubs, in this order."""
    handles = [svc.topk(k=10, epsilon=0.3) for _ in range(6)]
    return handles + [svc.ppr(h, k=10, epsilon=0.3) for h in hubs]


def wave_inputs(n, hubs, W, Q, dev):
    """A full wave like the scheduler's: W/Q walks per query slot, six
    uniform-start rows and two rows pinned at the hubs."""
    import torch
    per = W // Q
    qid = torch.arange(W, device=dev, dtype=torch.int32) // per
    uniform = qid < Q - len(hubs)
    start = torch.zeros(W, dtype=torch.int32, device=dev)
    for i, h in enumerate(hubs):
        start[qid == Q - len(hubs) + i] = h
    t_cap = torch.full((W,), 32, dtype=torch.int32, device=dev)
    return start, uniform, qid, t_cap


def phase_plain(svc, res, index, hubs, dev):
    import dataclasses
    import torch
    from repro_torch import KernelConfig, prng
    from repro_torch.kernels import ops
    from repro_torch.query.engine import WaveSpec, build_wave_program
    plain_rc = dataclasses.replace(
        svc.config, kernel=KernelConfig(step_impl="torch",
                                        stitch_impl="torch",
                                        tally_impl="torch"))
    # the plain run draws through prng's plain version too
    with prng.draw_impl("torch"):
        res_plain = svc.pagerank(epsilon=0.1, delta=0.1, k=100,
                                 config=plain_rc)
    batch_eq = torch.equal(res.counts, res_plain.counts)
    g, sc = svc.graph, svc.config.serving
    W, Q = sc.max_walks, sc.max_queries
    outs, draws = {}, {}
    for impl in ("cuda", "torch"):
        spec = WaveSpec(n=g.n, R=index.segments_per_vertex,
                        L=index.segment_len,
                        q_max=sc.max_steps // index.segment_len, W=W, Q=Q,
                        p_T=svc.config.p_T, impl=impl, tally_impl=impl)
        ops.reset_launch_counts()
        with prng.draw_impl("auto" if impl == "cuda" else "torch"):
            outs[impl] = build_wave_program(spec)(
                index.endpoints, g.row_ptr, g.col_idx, g.out_deg,
                *wave_inputs(g.n, hubs, W, Q, dev), prng.PRNGKey(11, dev))
        draws[impl] = sum(ops.launch_counts()[k] for k in ops.DRAW_KERNELS)
    wave_eq = torch.equal(outs["cuda"], outs["torch"])
    # the kernel paths drew their bits in the kernels (the batch run's in
    # frog_superstep, the wave's s0 in its rounds kernel, every other draw
    # one threefry launch); the plain ones through prng's torch version
    log("6 plain", batch_counts_equal=batch_eq, wave_counts_equal=wave_eq,
        wave_walks=int(outs["cuda"].sum()),
        wave_draw_launches=json.dumps(draws))
    assert draws["torch"] == 0 and draws["cuda"] > 0, draws
    assert batch_eq and wave_eq


def phase_stream(g, res, pi, dev):
    """The batch estimate through the streamed superstep."""
    import torch
    from repro_torch import FrogWildService, KernelConfig, RuntimeConfig
    from repro_torch.core import mass_captured
    from repro_torch.kernels import ops
    from repro_torch.query.engine import plan_query
    svc = FrogWildService.open(g, RuntimeConfig(
        kernel=KernelConfig(step_impl="stream")))
    sync()
    t0 = time.perf_counter()
    blocked = svc.blocked_csr()
    sync()
    t_blk = time.perf_counter() - t0
    log("7 blocked_csr", seconds=t_blk, vertex_block=blocked.vertex_block,
        num_blocks=blocked.num_blocks, E_blk=blocked.e_blk,
        bytes=blocked.nbytes,
        col_in_shared_memory=4 * blocked.e_blk <= ops.STREAM_SMEM_COL_BYTES)
    sync()
    t0 = time.perf_counter()
    res_s = svc.pagerank(epsilon=0.1, delta=0.1, k=100)
    sync()
    t_pr = time.perf_counter() - t0
    plan = plan_query(100, 0.1, 0.1, p_T=svc.config.p_T,
                      max_steps=svc.config.serving.max_steps)
    equal = torch.equal(res_s.counts, res.counts)
    mu_hat = float(mass_captured(res_s.pi_hat, pi, 100))
    mu_opt = float(mass_captured(pi, pi, 100))
    ok = mu_hat >= mu_opt - plan.epsilon_bound
    log("7 stream", pagerank_s=t_pr, counts_equal_resident=equal,
        mu_hat=mu_hat, epsilon_bound=plan.epsilon_bound, ok=ok)
    assert equal, "streamed counts differ from the resident run"
    assert ok, "streamed estimate misses its Theorem 1 bound"
    return svc


def phase_sharded(g, dense_index, dense_results, hubs, dev):
    """Sharded serving, S = 8, through both single-device dispatches; the
    index built through the streamed superstep."""
    import torch
    from repro_torch import (FrogWildService, KernelConfig, RuntimeConfig,
                             ServingConfig, ShardConfig)
    services = {}
    for dispatch in ("fused", "loop"):
        svc = FrogWildService.open(g, RuntimeConfig(
            runtime=ShardConfig(num_shards=SHARDS),
            kernel=KernelConfig(step_impl="stream"),
            serving=ServingConfig(sharded_dispatch=dispatch)),
            index=services["fused"].ensure_index() if services else None)
        sync()
        t0 = time.perf_counter()
        index = svc.ensure_index()
        sync()
        t_idx = time.perf_counter() - t0
        S, sz, R = index.blocks.shape
        if dispatch == "fused":
            flat = index.blocks.view(S * sz, R)
            slab_eq = (torch.equal(flat[: g.n], dense_index.endpoints)
                       and not bool(flat[g.n:].any()))
            log("8 sharded_index", shards=S, shard_size=sz, build_s=t_idx,
                equal_dense_row_padded=slab_eq)
            assert (S, sz) == (SHARDS, -(-g.n // SHARDS)), (S, sz)
            assert slab_eq, "stream-built blocks differ from the dense slab"
        t0 = time.perf_counter()
        results = [h.result() for h in submit_queries(svc, hubs)]
        t_serve = time.perf_counter() - t0
        same = answers_equal(dense_results, results)
        log("8 sharded", dispatch=dispatch, serve_s=t_serve,
            waves=svc.scheduler.stats().waves_run,
            query_latency_s=json.dumps([r.latency_s for r in results]),
            equal_dense_answers=same)
        assert svc.scheduler.dispatch == dispatch
        assert same, f"{dispatch} answers differ from the dense service's"
        services[dispatch] = svc
    return services


def answers_equal(a, b) -> bool:
    """Two runs of the 8 queries gave the same answers, byte for byte."""
    def key(r):
        return (r.vertices.tobytes(), r.scores.tobytes(), r.num_walks,
                r.waves, r.epsilon_bound, r.degraded, r.shards_lost,
                r.walks_lost)
    return len(a) == len(b) and all(key(x) == key(y) for x, y in zip(a, b))


def phase_lost_wave(services, hubs, dev):
    """One full wave with shard 3 lost: fused and loop byte-equal."""
    import numpy as np
    import torch
    from repro_torch import prng
    g, sc = services["fused"].graph, services["fused"].config.serving
    W, Q = sc.max_walks, sc.max_queries
    lost = torch.zeros(SHARDS, dtype=torch.bool, device=dev)
    lost[3] = True
    out = {}
    for name, svc in services.items():
        out[name] = svc.scheduler._wave_for(W, Q)(
            *wave_inputs(g.n, hubs, W, Q, dev), prng.PRNGKey(13, dev), lost)
    equal = np.array_equal(out["fused"], out["loop"])
    landed = int(out["fused"].sum())
    log("8 lost_wave", lost_shard=3, walks=W, landed=landed, equal=equal)
    assert equal and landed < W, "lost-shard waves differ between dispatches"


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def fault_log_of(svc) -> list:
    return [(e.kind, e.wave, e.attempt, e.shard) for e in svc.fault_log]


def phase_faults(g, sharded, dense_results, hubs, dev):
    """Checkpoints and faults at LiveJournal scale: the dense index
    persisted and loaded; the per-shard layout persisted, two shards
    mangled and repaired through ``frog_hop``; phase 8's queries under a
    transient fault and a timeout, under a shard loss (fused and loop), and
    with supervision armed and no fault; the degraded loop wave under the
    profiler and its rounds' call under the host-sync guard. The
    checkpoints go to a temporary directory, removed at the end."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch import (FrogWildService, RuntimeConfig, ServingConfig,
                             ShardConfig)
    from repro_torch.distributed.faults import FaultPlan
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.query import index as qindex
    tmp = tempfile.mkdtemp(prefix="frogwild_ckpt_")
    try:
        # 1. the dense layout: build and persist, load, serve
        d = os.path.join(tmp, "dense")
        rc = RuntimeConfig(serving=ServingConfig(checkpoint_dir=d))
        sync()
        t0 = time.perf_counter()
        built = FrogWildService.open(g, rc).ensure_index()
        sync()
        t_persist = time.perf_counter() - t0
        written = dir_bytes(d)
        t0 = time.perf_counter()
        qindex.save_walk_index(d, built)            # replaces step 0
        t_save = time.perf_counter() - t0
        svc = FrogWildService.open(g, rc)
        sync()
        t0 = time.perf_counter()
        loaded = svc.ensure_index()
        sync()
        t_load = time.perf_counter() - t0
        index_eq = (torch.equal(loaded.endpoints, built.endpoints)
                    and torch.equal(loaded.visited_blocks.view(torch.int32),
                                    built.visited_blocks.view(torch.int32)))
        same = answers_equal(dense_results, [
            h.result() for h in submit_queries(svc, hubs)])
        svc.close()
        log("17 checkpoint_dense", build_and_persist_s=t_persist,
            save_s=t_save, bytes_written=written,
            endpoint_bytes=built.endpoints.numel() * 4,
            mask_bytes=built.visited_blocks.numel() * 4, load_s=t_load,
            index_equal=index_eq, answers_equal_phase5=same)
        assert index_eq and same, "the loaded dense index serves otherwise"

        # 2. the per-shard layout: persist, mangle two shards, repair
        ds = os.path.join(tmp, "shards")
        orig = sharded["fused"].ensure_index()
        sync()
        t0 = time.perf_counter()
        for s in range(SHARDS):
            qindex.save_walk_index_shard(
                ds, s, SHARDS, orig.n, orig.blocks[s], orig.segment_len,
                orig.seed, visited_blocks=orig.visited_blocks[s])
        t_shards = time.perf_counter() - t0
        written = dir_bytes(ds)
        svc = FrogWildService.open(g, RuntimeConfig(
            runtime=ShardConfig(num_shards=SHARDS),
            serving=ServingConfig(checkpoint_dir=ds),
            faults=FaultPlan(corrupt_ckpt_shards=(2,),
                             truncate_ckpt_shards=(5,))))
        ops.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        repaired = svc.ensure_index()
        sync()
        t_repair = time.perf_counter() - t0
        launches = ops.launch_counts()
        log("launches", path="faults_repair", **launches)
        L = svc.config.serving.segment_len
        blocks_eq = torch.equal(repaired.blocks, orig.blocks)
        masks_eq = torch.equal(repaired.visited_blocks.view(torch.int32),
                               orig.visited_blocks.view(torch.int32))
        quarantined = sorted(x for x in os.listdir(ds)
                             if x.startswith("quarantine"))
        cfg = svc.config.walk_index()
        sync()
        t0 = time.perf_counter()
        qindex.rebuild_shard_blocks(
            g, dataclasses.replace(cfg, num_shards=SHARDS), [2, 5])
        sync()
        t_rebuild = time.perf_counter() - t0
        t0 = time.perf_counter()
        qindex._build_walk_index(g, cfg)
        sync()
        t_full = time.perf_counter() - t0
        svc.close()
        log("17 checkpoint_shards", shards=SHARDS, save_s=t_shards,
            bytes_written=written, repair_s=t_repair, rebuild_2_shards_s=
            t_rebuild, full_build_s=t_full,
            frog_segment_walk=launches["frog_segment_walk"],
            frog_hop=launches["frog_hop"], blocks_equal=blocks_eq,
            masks_equal=masks_eq, quarantined=json.dumps(quarantined))
        # one segment walk a repaired shard, none of the per-hop kernels
        assert launches["frog_segment_walk"] == 2, launches
        assert launches["frog_hop"] == 0, launches
        assert launches["frog_hop_stream_sorted"] == 0, launches
        assert blocks_eq, "repaired blocks differ from the originals"
        assert masks_eq, "repaired masks differ from the originals"
        assert quarantined == ["quarantine.shard_0002",
                               "quarantine.shard_0005"], quarantined

        # 3. supervised waves over phase 8's blocks
        base = sharded["fused"].config

        def serve(plan, dispatch="fused", **serving):
            svc = FrogWildService.open(g, dataclasses.replace(
                base, faults=plan, serving=dataclasses.replace(
                    base.serving, sharded_dispatch=dispatch, **serving)),
                index=orig)
            return svc, [h.result() for h in submit_queries(svc, hubs)]

        svc, out = serve(FaultPlan(transient_faults=((0, 1),),
                                   wave_timeouts=((2, 1),)),
                         backoff_base_s=0.001, backoff_max_s=0.002)
        fl = fault_log_of(svc)
        same = answers_equal(dense_results, out)
        svc.close()
        log("17 retried", fault_log=json.dumps(fl),
            answers_equal_phase8=same)
        assert fl == [("retry", 0, 1, None), ("retry", 2, 1, None)], fl
        assert same, "a retried wave changed phase 8's answers"

        degraded = {}
        for dispatch in ("fused", "loop"):
            ops.reset_launch_counts()
            svc, out = serve(FaultPlan(shard_losses=((1, 3),)), dispatch)
            launches = ops.launch_counts()
            waves = svc.scheduler.stats().waves_run
            log("launches", path=f"faults_degraded_{dispatch}", **launches)
            sched = svc.scheduler
            bounds_ok = all(
                r.epsilon_bound == sched.anytime_bound(
                    r.num_steps, 10, 0.1, r.num_walks)   # k, δ of the 8
                for r in out)
            log("17 degraded", dispatch=dispatch, waves=waves,
                lost_shards=json.dumps(sorted(svc.lost_shards)),
                walks_lost=json.dumps([r.walks_lost for r in out]),
                epsilon_bound=json.dumps([r.epsilon_bound for r in out]),
                bounds_at_executed=bounds_ok,
                fault_log=json.dumps(fault_log_of(svc)))
            for r, want in zip(out, dense_results):
                assert r.degraded and r.shards_lost == (3,), r
                assert r.walks_lost > 0, r
                assert r.num_walks + r.walks_lost == want.num_walks, r
            assert bounds_ok, "a degraded bound is not Theorem 1's"
            rounds = ("stitch_gather_rounds" if dispatch == "fused"
                      else "stitch_gather_local_rounds")
            assert launches[rounds] == waves, launches
            assert launches["frog_count"] == (
                waves if dispatch == "fused"
                else SHARDS + (SHARDS - 1) * (waves - 1)), launches
            degraded[dispatch] = (svc, out)
        same = answers_equal(degraded["fused"][1], degraded["loop"][1])
        log("17 degraded_equal", fused_equal_loop=same)
        assert same, "the degraded dispatches differ"
        degraded["fused"][0].close()

        svc, out = serve(FaultPlan(), wave_timeout_s=60.0)
        same = answers_equal(dense_results, out) and not svc.fault_log
        svc.close()
        log("17 armed_no_fault", answers_equal_phase8=same)
        assert same, "supervision with no fault changed phase 8's answers"

        # 4. the degraded loop wave: its kernels and device time, and its
        # rounds' call with no host sync
        loop = degraded["loop"][0]
        wall, busy, kernels, by_name, _ = device_busy_ms(
            lambda: (loop.topk(k=10, epsilon=0.3), loop.step()),
            by_kernel=True)
        log("17 profile", what="degraded_loop_wave", wall_ms=wall,
            device_busy_ms=busy if kernels else "not measured",
            idle_share=1 - busy / wall if kernels else "not measured",
            kernels=kernels, port_kernels_launches_ms=json.dumps(by_name))
        assert by_name.get("stitch_gather_local_rounds_kernel",
                           (0,))[0] == 1, by_name
        sched = loop.scheduler
        table = sched._block_table()
        W, n = loop.config.serving.max_walks, g.n
        gen = torch.Generator(device=dev).manual_seed(17)
        pos = torch.randint(0, n, (W,), generator=gen, device=dev,
                            dtype=torch.int32)
        q = torch.randint(0, sched._q_max + 1, (W,), generator=gen,
                          device=dev, dtype=torch.int32)
        s0 = torch.randint(0, 2 ** 30, (W,), generator=gen, device=dev,
                           dtype=torch.int32)
        sync()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = ops.stitch_gather_local_rounds(
                pos, q, s0, table, sched._q_max, sched._lost_dev,
                lost_host=sched._lost)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = kref.stitch_gather_local_rounds_ref(
            pos, q, s0, table.blocks, sched._q_max, sched._lost_dev)
        equal = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                            want[1])
        # the call event-timed with the mask's host copy, and without it
        # (the check then reads the mask back from the card)
        ms = {how: time_ms(lambda kw=kw: ops.stitch_gather_local_rounds(
            pos, q, s0, table, sched._q_max, sched._lost_dev, **kw))
            for how, kw in (("host_copy", {"lost_host": sched._lost}),
                            ("read_back", {}))}
        log("17 local_rounds_no_sync", null_entries=json.dumps(
            [s for s, b in enumerate(table.blocks) if b is None]),
            host_sync=False, equal_plain=equal, walks=W,
            ms_host_copy=ms["host_copy"], ms_read_back=ms["read_back"])
        assert table.blocks[3] is None and equal
        loop.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mutation_window(g):
    """The reference benchmark's mutation batch
    (``benchmarks/bench_query.py``'s incremental-refresh row): inserts
    ``(v, (v·7 + 13) mod n)`` over the block-aligned window of ``n // 100``
    vertices with the fewest in-edges."""
    import numpy as np
    from repro_torch.dynamic import MutationBatch
    from repro_torch.kernels.ref import segment_mask_block_size
    n = g.n
    indeg = np.bincount(g.col_idx.cpu().numpy(), minlength=n)
    w = max(1, n // 100)
    cs = np.concatenate([[0], np.cumsum(indeg)])
    starts = np.arange(0, n - w + 1, segment_mask_block_size(n))
    lo = int(starts[np.argmin((cs[w:] - cs[:-w])[starts])])
    return lo, w, MutationBatch.edges(
        insert=[(v, (v * 7 + 13) % n) for v in range(lo, lo + w)])


def index_equal(a, b) -> bool:
    """Two walk indexes (dense or sharded) equal in endpoints and masks."""
    import torch
    ep = ("blocks" if hasattr(a, "blocks") else "endpoints")
    return (torch.equal(getattr(a, ep), getattr(b, ep))
            and torch.equal(a.visited_blocks.view(torch.int32),
                            b.visited_blocks.view(torch.int32)))


def phase_dynamic(g, index, sharded, dense_results, hubs, dev):
    """Dynamic graphs at LiveJournal scale (phase 18): the reference
    benchmark's mutation batch applied; phase 5's index and the 8-shard
    fused service's blocks refreshed, each against a full build at epoch
    1 (endpoints and masks); phase 5's 8 queries pinned across
    ``apply_mutations`` on a service of their own, against phase 5's
    answers; the refreshed index through its epoch checkpoint; the masks
    of a 100,000-vertex build and refresh on the card against the CPU's.
    Returns the launch counts of the refreshes and the service run."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch import FrogWildService, RuntimeConfig
    from repro_torch.dynamic import (apply_mutations, load_epoch_index,
                                     refresh_walk_index, save_epoch_index)
    from repro_torch.graph import chung_lu_powerlaw
    from repro_torch.kernels import ops
    from repro_torch.query.index import _build_walk_index, shard_walk_index
    lo, w, batch = mutation_window(g)
    t0 = time.perf_counter()
    g2, changed = apply_mutations(g, batch)
    sync()
    t_apply = time.perf_counter() - t0
    log("18 mutations", window_lo=lo, window=w, inserts=batch.size,
        changed=int(changed.size), nnz=g.nnz, nnz_new=g2.nnz,
        epoch=g2.epoch, apply_s=t_apply)
    assert g2.epoch == 1 and g2.nnz == g.nnz + w and changed.size == w

    ops.reset_launch_counts()
    cfg = RuntimeConfig().walk_index()
    sync()
    t0 = time.perf_counter()
    full = _build_walk_index(g2, cfg)
    sync()
    t_full = time.perf_counter() - t0
    build_walks = ops.launch_counts()["frog_segment_walk"]
    refreshed = {}
    for what, chunk in (("refresh", 4096),
                        ("refresh_shard_chunk", -(-g.n // cfg.num_shards))):
        ops.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        new, report = refresh_walk_index(index, g2, changed, chunk=chunk)
        sync()
        t_refresh = time.perf_counter() - t0
        walks = ops.launch_counts()["frog_segment_walk"]
        hops = ops.launch_counts()["frog_hop"]
        equal = index_equal(new, full)
        log("18 " + what, chunk=chunk, **dataclasses.asdict(report),
            stale_row_share=report.stale_rows / report.n,
            stale_segment_share=report.stale_segments
            / report.total_segments, refresh_s=t_refresh,
            full_build_s=t_full, frog_segment_walk=walks,
            full_build_frog_segment_walk=build_walks, frog_hop=hops,
            equal_full_build=equal)
        assert equal, "the refreshed index differs from a full build"
        # one segment walk a chunk of stale rows
        assert walks == -(-report.stale_rows // chunk) and hops == 0
        refreshed[what] = new
    new = refreshed.pop("refresh")
    del refreshed

    # the 8-shard fused service's blocks, refreshed through the streamed
    # hop kernel over the new graph's BlockedCSR
    blocks = sharded["fused"].ensure_index()
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    new_sh, report_sh = refresh_walk_index(blocks, g2, changed,
                                           step_impl="stream")
    sync()
    t_sh = time.perf_counter() - t0
    launches_sh = ops.launch_counts()
    equal = index_equal(new_sh, shard_walk_index(full, SHARDS))
    log("18 refresh_sharded", shards=new_sh.num_shards,
        stale_rows=report_sh.stale_rows, refresh_s=t_sh,
        frog_hop_stream_sorted=launches_sh["frog_hop_stream_sorted"],
        frog_segment_masks=launches_sh["frog_segment_masks"],
        equal_full_build=equal)
    assert equal and new_sh.num_shards == SHARDS, \
        "the refreshed blocks differ from a full build"
    # a chunk (4,096 rows): L sorted hops, one mask pass, no masked hop
    chunks_sh = -(-report_sh.stale_rows // 4096)
    assert launches_sh["frog_segment_masks"] == chunks_sh, launches_sh
    assert launches_sh["frog_hop_stream_sorted"] == \
        cfg.segment_len * chunks_sh, launches_sh
    del new_sh, blocks

    # phase 5's queries pinned across apply_mutations, on their own service
    ops.reset_launch_counts()
    svc = FrogWildService.open(g, RuntimeConfig(), index=index)
    handles = submit_queries(svc, hubs)
    svc.step()
    sync()
    t0 = time.perf_counter()
    report_svc = svc.apply_mutations(batch)
    sync()
    t_commit = time.perf_counter() - t0
    retiring = svc.retiring_epochs
    svc.drain()
    pinned = [h.result() for h in handles]
    fresh = svc.topk(k=10, epsilon=0.3).result()
    launches = ops.launch_counts()
    log("launches", path="dynamic", **launches)
    same = answers_equal(dense_results, pinned)
    served = svc.ensure_index()
    log("18 pinned", queries=len(pinned), apply_mutations_s=t_commit,
        stale_rows=report_svc.stale_rows, retiring_at_commit=json.dumps(
            retiring), epochs=json.dumps([r.epoch for r in pinned]),
        equal_never_mutated=same, fresh_epoch=fresh.epoch,
        retiring_after_drain=json.dumps(svc.retiring_epochs),
        served_equal_full_build=index_equal(served, full))
    assert same and all(r.epoch == 0 for r in pinned), \
        "a pinned query changed across the epoch commit"
    assert retiring == [0] and svc.retiring_epochs == []
    assert fresh.epoch == 1 and svc.graph_epoch == 1
    assert index_equal(served, full), "the committed slab is not epoch 1's"
    # the commit's refresh: one segment walk a 1,024-row chunk
    assert launches["frog_segment_walk"] == \
        -(-report_svc.stale_rows // 1024), launches
    assert launches["frog_hop"] == 0, launches
    svc.close()
    del served

    # the epoch checkpoint of the refreshed index
    tmp = tempfile.mkdtemp(prefix="frogwild_epochs_")
    try:
        sync()
        t0 = time.perf_counter()
        d = save_epoch_index(tmp, new)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_epoch_index(tmp, 1, device=dev)
        sync()
        t_load = time.perf_counter() - t0
        equal = index_equal(back, new) and back.graph_epoch == 1
        log("18 epoch_checkpoint", bytes_written=dir_bytes(d), save_s=t_save,
            load_s=t_load, round_trip_equal=equal)
        assert equal, "the epoch checkpoint does not round-trip"
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del new, full

    # the masks of a 100,000-vertex build and refresh: card against CPU
    lj = livejournal()
    small = chung_lu_powerlaw(100_000, avg_out_deg=lj.avg_out_deg,
                              theta=lj.theta, seed=2)
    _, _, sbatch = mutation_window(small)
    for step_impl in ("auto", "stream"):
        scfg = dataclasses.replace(cfg, step_impl=step_impl)
        out = {}
        for where in (dev, "cpu"):
            gs = small.to(where)
            idx = _build_walk_index(gs, scfg)
            gs2, ch = apply_mutations(gs, sbatch)
            out[str(where)] = (idx, refresh_walk_index(
                idx, gs2, ch, step_impl=step_impl)[0])
        card, cpu = out[str(dev)], out["cpu"]
        equal = all(torch.equal(a.endpoints.cpu(), b.endpoints) and
                    torch.equal(a.visited_blocks.view(torch.int32).cpu(),
                                b.visited_blocks.view(torch.int32))
                    for a, b in zip(card, cpu))
        log("18 masks_cpu", n=small.n, step_impl=step_impl,
            nonzero_words=int((cpu[0].visited_blocks.view(torch.int32)
                               != 0).sum()), byte_equal=equal)
        assert equal, f"{step_impl}: the card's masks differ from the CPU's"
    return {"frog_hop": launches["frog_hop"],
            "frog_hop_stream_sorted": launches_sh["frog_hop_stream_sorted"]}


# phase 19: the serving gateway. Wall-clock settings sized to the card's
# waves (43-64 ms at LiveJournal scale), not to the CPU's defaults
GATEWAY = dict(replicas=2, heartbeat_s=1.0, stall_s=1.5, cache_eps=0.33,
               batch_cache_eps=0.23, join_k=20, http_k=12, http_eps=0.4,
               overload_queries=8)


def index_bytes(index) -> int:
    slab = index.endpoints if hasattr(index, "endpoints") else index.blocks
    vb = index.visited_blocks
    return (slab.numel() * slab.element_size()
            + (0 if vb is None else vb.numel() * vb.element_size()))


def same_answer(a, b) -> bool:
    """Byte-equal answers: vertices, scores, bound, walks and waves."""
    return (a.vertices.tobytes() == b.vertices.tobytes()
            and a.scores.dtype == b.scores.dtype
            and a.scores.tobytes() == b.scores.tobytes()
            and a.epsilon_bound == b.epsilon_bound
            and (a.num_walks, a.waves) == (b.num_walks, b.waves))


def direct_twins(g, index, handles, dev):
    """The answers of direct services over ``index`` given, replica by
    replica and in the same order, the requests the gateway routed live:
    the cold-replica contract under continuous batching (a query's answer
    depends on the queries that share its waves)."""
    from repro_torch import FrogWildService, RuntimeConfig
    want = {}
    for ridx in sorted({h.replica for h in handles if h.source == "live"}):
        svc = FrogWildService.open(g, RuntimeConfig(), device=dev,
                                   index=index)
        mine = [h for h in handles if h.source == "live"
                and h.replica == ridx]
        twins = [svc.resubmit(h._inner.request) for h in mine]
        for h, t in zip(mine, twins):
            want[id(h)] = t.result()
        svc.close()
    return want


def http_get(url: str):
    """``(status, headers, JSON body)``; an HTTP error status is an answer
    (the 503 gate reads it), a refused connection raises."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, dict(resp.headers), json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.load(e)


def phase_gateway(g, index, res, pi, hubs, dev):
    """The serving gateway at LiveJournal scale (phase 19): two replicas
    over one walk index in device memory; phase 5's queries live, their
    repeat from the cache, an in-flight join, the cached batch estimate,
    the HTTP front end from its handler threads, a crash failover, a
    stall, overload shedding and drain on gateways of their own, and
    ``Gateway.apply_mutations`` of phase 18's batch under a pinned query.
    Returns the launch counts of the gateway's path."""
    import math
    import torch
    from repro_torch import Gateway, RuntimeConfig
    from repro_torch.core import mass_captured
    from repro_torch.gateway import serve_http
    from repro_torch.kernels import ops
    from repro_torch.query.engine import plan_query
    from repro_torch.query.scheduler import _topk_stable
    cfg = RuntimeConfig()
    R = GATEWAY["replicas"]

    # one index for the pool: a second replica adds no slab and no mask
    ops.reset_launch_counts()
    sync()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gw = Gateway.open(g, cfg, replicas=R, device=dev)
    sync()
    t_open = time.perf_counter() - t0
    grown = torch.cuda.memory_allocated() - before
    idx = gw.pool.index
    nbytes = index_bytes(idx)
    shared = all(r.ensure_index() is idx and r.graph is gw.pool.graph
                 for r in gw.pool.replicas)
    ptrs = {(r.ensure_index().endpoints.data_ptr(),
             r.ensure_index().visited_blocks.data_ptr())
            for r in gw.pool.replicas}
    log("19 shared_index", replicas=R, open_s=t_open, index_bytes=nbytes,
        allocator_growth_bytes=grown, growth_over_index=grown / nbytes,
        same_object=shared, distinct_data_ptrs=len(ptrs),
        equal_phase5_index=index_equal(idx, index))
    assert shared and len(ptrs) == 1, "the replicas do not share one index"
    assert grown < 1.5 * nbytes, (grown, nbytes)
    assert index_equal(idx, index), "the gateway built another index"

    # phase 5's 8 queries: the first top-k live, its 5 twins joined, the
    # PPRs live; each answer that of a direct service given the same
    # requests on the same replica
    sync()
    t0 = time.perf_counter()
    handles = submit_queries(gw, hubs)
    live = [h.result() for h in handles]
    sync()
    t_live = time.perf_counter() - t0
    sources = [h.source for h in handles]
    want = direct_twins(g, idx, handles, dev)
    equal = all(same_answer(r, want[id(h)]) for h, r in zip(handles, live)
                if h.source == "live")
    joined_verbatim = all(r is live[0] for h, r in zip(handles, live)
                          if h.source == "joined")
    mu_opt = float(mass_captured(pi, pi, 10))
    for h, r in zip(handles, live):
        if r.kind == "topk":
            mu = float(pi[torch.as_tensor(r.vertices, device=dev)].sum())
            assert mu >= mu_opt - r.epsilon_bound, (mu, mu_opt, r)
        else:
            assert int(r.vertices[0]) == h._inner.request.source, r
            assert float(r.scores[0]) >= 0.10, r
    log("19 live", queries=len(live), seconds=t_live,
        sources=json.dumps(sources),
        replicas=json.dumps([h.replica for h in handles]),
        waves=gw.pool.total_waves_run(),
        certificates=json.dumps([r.epsilon_bound for r in live]),
        equal_direct_service=equal, joined_verbatim=joined_verbatim)
    assert sources == ["live"] + ["joined"] * 5 + ["live", "live"], sources
    assert equal, "a live answer differs from its direct service's"
    assert joined_verbatim, "a joined answer is not its parent's object"

    # the same requests at an ε their certificates dominate: all from the
    # cache, no wave; at phase 5's ε = 0.3 the clamped plans' certificates
    # (0.3267) do not dominate, and the repeat goes live (the near miss)
    eps_c = GATEWAY["cache_eps"]
    assert all(r.epsilon_bound <= eps_c for r in live), live
    waves = gw.pool.total_waves_run()
    sync()
    t0 = time.perf_counter()
    again = [gw.topk(k=10, epsilon=eps_c) for _ in range(6)] + [
        gw.ppr(v, k=10, epsilon=eps_c) for v in hubs]
    cached = [h.result() for h in again]
    t_cache = time.perf_counter() - t0
    verbatim = all(c is r for c, r in zip(cached, live))
    new_waves = gw.pool.total_waves_run() - waves
    near = gw.topk(k=10, epsilon=0.3)
    near_source = near.source
    near.result()
    log("19 cache", queries=len(cached), seconds=t_cache, epsilon=eps_c,
        sources=json.dumps(sorted({h.source for h in again})),
        new_waves=new_waves, verbatim=verbatim,
        near_miss_epsilon=0.3, near_miss_source=near_source)
    assert all(h.source == "cache" for h in again) and verbatim
    assert new_waves == 0, "a cache hit ran a wave"
    assert near_source == "live"

    # an in-flight join: duplicates submitted before the parent's first
    # wave ride its walks; the weaker target settles no later
    k_j = GATEWAY["join_k"]
    parent = gw.topk(k=k_j, epsilon=0.3)
    same = gw.topk(k=k_j, epsilon=0.3)
    weaker = gw.topk(k=k_j, epsilon=0.5)
    waves = gw.pool.total_waves_run()
    sync()
    t0 = time.perf_counter()
    weaker_at = None
    n = 0
    while not parent.done():
        parent.poll()
        n += 1
        if weaker_at is None and weaker.done():
            weaker_at = n
    t_join = time.perf_counter() - t0
    rp, rs, rw = parent.result(), same.result(), weaker.result()
    log("19 join", k=k_j, sources=json.dumps([parent.source, same.source,
                                              weaker.source]),
        parent_waves=n, weaker_settled_at=weaker_at, seconds=t_join,
        weaker_walks=rw.num_walks, parent_walks=rp.num_walks,
        weaker_bound=rw.epsilon_bound, same_is_parent=rs is rp,
        pool_waves=gw.pool.total_waves_run() - waves)
    assert (parent.source, same.source, weaker.source) == (
        "live", "joined", "joined")
    assert rs is rp and weaker_at is not None and weaker_at <= n
    assert rw.epsilon_bound <= 0.5 and rw.num_walks <= rp.num_walks
    assert gw.pool.total_waves_run() - waves == n, "a join ran walks"

    # the batch estimate live at phase 4's ε = 0.1 (its top-100), then
    # from the cache at an ε its certificate dominates (t = 32 caps the
    # plan: the certificate is 0.2268, so a repeat at 0.1 would go live)
    eps_b, delta_b, k_b = 0.1, 0.1, 100
    counts = {}
    out = []
    for name, eps in (("live", eps_b), ("cached", GATEWAY["batch_cache_eps"])):
        before = ops.launch_counts()["frog_superstep"]
        sync()
        t0 = time.perf_counter()
        out.append(gw.pagerank(epsilon=eps, delta=delta_b, k=k_b))
        sync()
        counts[name] = (ops.launch_counts()["frog_superstep"] - before,
                        time.perf_counter() - t0)
    pi4 = res.pi_hat.cpu().numpy()
    top4 = _topk_stable(pi4, k_b)
    plan = plan_query(k_b, eps_b, delta_b, p_T=cfg.p_T,
                      max_steps=cfg.serving.max_steps)
    equal = (out[0].vertices.tobytes() == top4.tobytes()
             and out[0].scores.tobytes() == pi4[top4].tobytes())
    log("19 pagerank", frog_superstep_live=counts["live"][0],
        frog_superstep_cached=counts["cached"][0],
        cached_epsilon=GATEWAY["batch_cache_eps"],
        live_s=counts["live"][1], cached_s=counts["cached"][1],
        num_walks=out[0].num_walks, epsilon_bound=out[0].epsilon_bound,
        equal_phase4=equal, cached_verbatim=out[1] is out[0])
    assert counts["live"][0] == plan.num_steps == 32
    assert counts["cached"][0] == 0 and out[1] is out[0]
    assert equal, "the gateway's batch estimate differs from phase 4's"

    # the HTTP front end: a live top-k launched from a handler thread
    # (its certificate enters the cache, and the process reads the same
    # answer back), a cached one, /healthz and /metrics
    k_h, eps_h = GATEWAY["http_k"], GATEWAY["http_eps"]
    with serve_http(gw, port=0) as srv:
        t0 = time.perf_counter()
        code, _, body = http_get(f"{srv.url}/topk?k={k_h}&epsilon={eps_h}")
        t_http = time.perf_counter() - t0
        c_cached, _, b_cached = http_get(
            f"{srv.url}/topk?k=10&epsilon={eps_c}")
        c_health, _, health = http_get(f"{srv.url}/healthz")
        c_metrics, _, metrics = http_get(f"{srv.url}/metrics")
    mine = gw.topk(k=k_h, epsilon=eps_h)
    r_h = mine.result()
    finite = all(math.isfinite(x) for x in body.get("scores", [math.nan]))
    read_back = (body.get("vertices") == r_h.vertices.tolist()
                 and body.get("scores") == r_h.scores.tolist())
    http_equal = (b_cached.get("vertices") == live[0].vertices.tolist()
                  and b_cached.get("scores") == live[0].scores.tolist())
    log("19 http", status=code, source=body.get("source"), seconds=t_http,
        k=len(body.get("vertices", [])), finite=finite,
        epsilon_bound=body.get("epsilon_bound"),
        inprocess_source=mine.source, read_back_equal=read_back,
        cached_status=c_cached, cached_source=b_cached.get("source"),
        cached_equal=http_equal, healthz=c_health,
        healthy=health.get("healthy"), metrics=c_metrics,
        hit_rate=metrics.get("hit_rate"), join_rate=metrics.get("join_rate"))
    assert code == 200 and body["source"] == "live" and finite
    assert len(body["vertices"]) == k_h and body["epsilon_bound"] <= eps_h
    assert mine.source == "cache" and read_back, "the handler's answer"
    assert c_cached == 200 and b_cached["source"] == "cache" and http_equal
    assert c_health == 200 and health["healthy"]
    assert c_metrics == 200 and {"hit_rate", "join_rate"} <= metrics.keys()

    launches = ops.launch_counts()
    log("launches", path="gateway", **launches)
    assert launches["stitch_gather_rounds"] >= 1, launches
    assert launches["frog_count"] >= 1, launches
    assert launches["frog_superstep"] == 32, launches
    assert launches["stitch_gather"] == 0, launches
    # one index build for the pool (a build shard a launch), no hop
    assert launches["frog_segment_walk"] == cfg.serving.build_shards
    assert launches["frog_hop"] == 0, launches
    s = gw.stats()
    log("19 stats", requests=s["requests"], cache_hits=s["cache_hits"],
        joins=s["joins"], live=s["live"], hit_rate=s["hit_rate"],
        join_rate=s["join_rate"], qps=s["qps"], p50_ms=s["p50_ms"],
        p99_ms=s["p99_ms"], replica_waves=json.dumps(
            [r["waves_run"] for r in s["replicas"]]))

    phase_gateway_faults(g, cfg, dev)
    mut = phase_gateway_mutations(gw, g, idx, dev)
    gw.close()
    return launches, mut


def phase_gateway_faults(g, cfg, dev):
    """Phase 19's faults, each on a gateway of its own without the cache,
    as the reference benchmark runs them: replica 0 crashed at its first
    wave, replica 0 stalled past its heartbeat, and overload shedding
    (503 over HTTP) followed by drain."""
    import dataclasses
    from repro_torch import FrogWildService, Gateway
    from repro_torch.distributed.faults import FaultPlan
    from repro_torch.gateway import GatewayOverloadError, serve_http
    from repro_torch.query.engine import plan_query

    def fault_free(gw):
        with FrogWildService.open(g, cfg, device=dev,
                                  index=gw.pool.index) as svc:
            return svc.topk(k=10, epsilon=0.3).result()

    plan = dataclasses.replace(cfg, faults=FaultPlan(
        seed=7, replica_crashes=((0, 0),)))
    gw = Gateway.open(g, plan, replicas=2, cache=False, device=dev)
    sync()
    t0 = time.perf_counter()
    h = gw.topk(k=10, epsilon=0.3)
    r = h.result()
    sync()
    failover_s = time.perf_counter() - t0
    equal = same_answer(r, fault_free(gw))
    log("19 crash", failover_latency_s=failover_s, failovers=h.failovers,
        replica=h.replica, breaker_0=gw.pool.breaker_state(0),
        routable=json.dumps(gw.pool.routable()), equal_fault_free=equal)
    assert h.failovers == 1 and gw.metrics.failovers == 1 and h.replica == 1
    assert gw.pool.breaker_state(0) == "open" and equal
    gw.close()
    del gw

    hb, stall = GATEWAY["heartbeat_s"], GATEWAY["stall_s"]
    plan = dataclasses.replace(cfg, faults=FaultPlan(
        seed=7, replica_stalls=((0, 0, stall),)))
    gw = Gateway.open(g, plan, replicas=2, cache=False, device=dev,
                      heartbeat_timeout_s=hb)
    t0 = time.perf_counter()
    h = gw.topk(k=10, epsilon=0.3)
    r = h.result()
    sync()
    t_stall = time.perf_counter() - t0
    equal = same_answer(r, fault_free(gw))
    log("19 stall", heartbeat_s=hb, stall_s=stall, seconds=t_stall,
        replica=h.replica, breaker_0=gw.pool.breaker_state(0),
        crashed_0=gw.pool.states[0].crashed,
        routable=json.dumps(gw.pool.routable()), equal_fault_free=equal)
    assert h.replica == 1 and gw.pool.routable() == [1]
    assert gw.pool.breaker_state(0) == "open"
    assert not gw.pool.states[0].crashed and equal
    gw.close()
    del gw

    # distinct PPR sources (duplicates would join, and joins are never
    # shed) against one plan's walks of backlog
    nq = GATEWAY["overload_queries"]
    walks = plan_query(10, 0.3, 0.1, p_T=cfg.p_T,
                       max_steps=cfg.serving.max_steps,
                       segments_per_vertex=cfg.serving.segments_per_vertex,
                       segment_len=cfg.serving.segment_len).num_walks
    gw = Gateway.open(g, cfg, replicas=2, cache=False, device=dev,
                      shed_backlog_walks=walks)
    admitted, retry = [], []
    for i in range(nq):
        try:
            admitted.append(gw.ppr(17 * i + 1, k=10, epsilon=0.3))
        except GatewayOverloadError as e:
            retry.append(e.retry_after_s)
    shed_rate = len(retry) / nq
    with serve_http(gw, port=0) as srv:
        # a source no admitted query has (a duplicate would join)
        code, headers, body = http_get(
            f"{srv.url}/ppr?source=3&k=10&epsilon=0.3")
    sync()
    t0 = time.perf_counter()
    drained = gw.drain()
    sync()
    t_drain = time.perf_counter() - t0
    log("19 overload", queries=nq, admitted=len(admitted),
        shed_rate=shed_rate, retry_after_s=json.dumps(retry),
        http_status=code, retry_after_header=headers.get("Retry-After"),
        reason_code=body.get("reason_code"), drained=len(drained),
        drain_s=t_drain, closed=gw.closed)
    assert len(admitted) == 1 and len(retry) == nq - 1
    assert all(x > 0 for x in retry)
    assert code == 503 and body["reason_code"] == "overload"
    assert int(headers["Retry-After"]) >= 1
    assert [d.rid for d in drained] == [admitted[0].result().rid]
    assert gw.closed
    del gw


def phase_gateway_mutations(gw, g, idx, dev):
    """Phase 18's mutation batch through ``Gateway.apply_mutations`` with
    a query in flight on a restarted (cold) replica: one refresh, on the
    pool's index, handed to both replicas; the pinned query byte-equal to
    a direct service's at epoch 0; epoch 0's certificates orphaned."""
    from repro_torch import FrogWildService, RuntimeConfig
    from repro_torch.kernels import ops
    _, _, batch = mutation_window(g)
    # a cold replica 1, so the pinned query's epoch-0 answer is a cold
    # service's: restart over the same index, no rebuild
    fresh = gw.pool.restart_replica(1)
    assert fresh.ensure_index() is idx
    h = gw.topk(k=10, epsilon=0.3)
    assert h.source == "live" and h.replica == 1, (h.source, h.replica)
    h.poll()
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    report = gw.apply_mutations(batch)
    sync()
    t_commit = time.perf_counter() - t0
    launches = ops.launch_counts()
    log("launches", path="gateway_mutations", **launches)
    new = gw.pool.index
    one = all(r.ensure_index() is new for r in gw.pool.replicas)
    pinned = h.result()
    with FrogWildService.open(g, RuntimeConfig(), device=dev,
                              index=idx) as svc:
        want = svc.topk(k=10, epsilon=0.3).result()
    after = gw.topk(k=10, epsilon=0.3)
    r_after = after.result()
    expected = -(-report.stale_rows // 1024)
    log("19 mutations", inserts=batch.size, stale_rows=report.stale_rows,
        apply_mutations_s=t_commit, epoch=gw.epoch,
        frog_segment_walk=launches["frog_segment_walk"],
        expected_one_refresh=expected, frog_hop=launches["frog_hop"],
        replicas_share_new_index=one,
        orphaned=gw.metrics.epoch_orphaned, pinned_epoch=pinned.epoch,
        pinned_equal_epoch0=same_answer(pinned, want),
        repeat_source=after.source, repeat_epoch=r_after.epoch)
    assert gw.epoch == 1 and report.epoch == 1
    assert launches["frog_segment_walk"] == expected, launches
    assert launches["frog_hop"] == 0, launches
    assert one and new is not idx
    assert gw.metrics.epoch_orphaned >= 1
    assert pinned.epoch == 0 and same_answer(pinned, want)
    assert after.source == "live" and r_after.epoch == 1
    return launches


def erasure_config(model, draw, N, t, p_s=QUICKSTART["p_s"]):
    from repro_torch import KernelConfig, RuntimeConfig, ShardConfig
    return RuntimeConfig(num_frogs=N, num_steps=t, p_s=p_s, erasure=model,
                         kernel=KernelConfig(draw=draw),
                         runtime=ShardConfig(num_shards=QUICKSTART["shards"]))


def picked_draw(model, draw, N, nnz, p_s):
    """What ``draw_next`` runs: ``cumsum``, ``channel_enum`` (the channel
    model's probe draw) or edge rejection in its ``one_shot`` or
    ``chunked`` regime (``"auto"`` resolved as ``draw_next`` does)."""
    from repro_torch.core import blocking
    if draw == "auto":
        nc = QUICKSTART["shards"] if model == "channel" else None
        draw = ("rejection"
                if blocking.rejection_is_profitable(N, nnz, p_s, nc)
                else "cumsum")
    if draw == "cumsum":
        return draw
    if model == "channel":
        return "channel_enum"
    chunked = blocking.num_rounds_for(p_s) * N > blocking.UNROLL_PROBES
    return "rejection_chunked" if chunked else "rejection_one_shot"


def phase_erasure(g, pi):
    """The quickstart's partial-synchronization walk at LiveJournal scale,
    then the independent model and the cumsum draw of both models, each
    through ``FrogWildService.pagerank`` and held to Theorem 1 with p_s:
    μ_20(π̂) ≥ μ_20(π) − ε(p_T, t, 20, δ = 0.1, N, p_s, p_∩ bound)."""
    import torch
    from repro_torch import FrogWildService
    from repro_torch.core import (exact_identification, mass_captured,
                                  normalized_mass_captured, theory)
    k, N, p_s = QUICKSTART["k"], QUICKSTART["num_frogs"], QUICKSTART["p_s"]
    mu_opt = float(mass_captured(pi, pi, k))
    t = theory.suggested_steps(mu_opt)
    svc = FrogWildService.open(g, erasure_config("channel", "auto", N, t))
    p_T = svc.config.p_T
    eps = theory.epsilon_bound(
        p_T, t, k, 0.1, N, p_s,
        theory.p_cap_bound(g.n, t, float(pi.max()), p_T))
    log("9 erasure_plan", k=k, mu_opt=mu_opt, t=t, N=N, p_s=p_s,
        shards=QUICKSTART["shards"], epsilon_bound=eps,
        bound_vacuous=eps >= mu_opt)
    runs, peak = {}, 0
    for model, draw in (("channel", "auto"), ("independent", "auto"),
                        ("channel", "cumsum"), ("independent", "cumsum")):
        rc = erasure_config(model, draw, N, t)
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        res = svc.pagerank(seed=0, config=rc)
        sync()
        secs = time.perf_counter() - t0
        run_peak = torch.cuda.max_memory_allocated()
        peak = max(peak, run_peak)
        assert int(res.counts.sum()) == N, "frogs not conserved"
        assert bool(torch.isfinite(res.pi_hat).all())
        mu_hat = float(mass_captured(res.pi_hat, pi, k))
        ok = mu_hat >= mu_opt - eps
        log("9 erasure", model=model, draw=draw,
            runs=picked_draw(model, draw, N, g.nnz, p_s),
            seconds=secs, ms_per_superstep=secs / t * 1e3, mu_hat=mu_hat,
            mass_captured=float(normalized_mass_captured(res.pi_hat, pi, k)),
            exact_identification=float(exact_identification(res.pi_hat, pi,
                                                            k)),
            ok=ok, peak_mem_bytes=run_peak)
        assert ok, f"{model}/{draw} misses its Theorem 1 bound"
        runs[(model, draw)] = secs
    return svc, t, runs, peak


def phase_erasure_cpu():
    """The six (model × draw) walks on a 100,000-vertex graph, on the card
    and on the CPU: no kernel of the path does float work, so the card
    gives the CPU's bytes. 160,000 frogs put the independent model's edge
    rejection in its chunked regime (14 rounds · 160,000 > 2**21)."""
    import torch
    from repro_torch import FrogWildService
    from repro_torch.graph import chung_lu_powerlaw
    from repro_torch.kernels import ops
    lj = livejournal()
    g = chung_lu_powerlaw(100_000, avg_out_deg=lj.avg_out_deg,
                          theta=lj.theta, seed=1)
    N, t = 160_000, 8
    for model in ("channel", "independent"):
        for draw in ("auto", "rejection", "cumsum"):
            rc = erasure_config(model, draw, N, t)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            card = FrogWildService.open(g, rc).pagerank(seed=0)
            sync()
            t_card = time.perf_counter() - t0
            draws = {k: v for k, v in ops.launch_counts().items()
                     if k in ops.DRAW_KERNELS and v}
            t0 = time.perf_counter()
            cpu = FrogWildService.open(g, rc, device="cpu").pagerank(seed=0)
            t_cpu = time.perf_counter() - t0
            equal = (torch.equal(card.counts.cpu(), cpu.counts)
                     and torch.equal(card.pi_hat.cpu(), cpu.pi_hat))
            log("11 erasure_cpu", n=g.n, nnz=g.nnz, N=N, t=t, model=model,
                draw=draw,
                runs=picked_draw(model, draw, N, g.nnz, rc.p_s),
                card_s=t_card, cpu_s=t_cpu, byte_equal=equal,
                card_draw_launches=json.dumps(draws))
            assert equal, f"{model}/{draw}: the card's walk differs from " \
                "the CPU's"
            # the card's draws are the threefry kernels, the CPU's prng's
            # plain version: one split a superstep at least
            assert draws.get("threefry_split", 0) >= t, draws


def phase_graphlab(g, pi):
    """GraphLab-PR on the ELL SpMV kernel: the layout, and 50 power
    iterations held to the COO iteration (both float32, summed in other
    orders and with atomics: max relative difference ≤ 1e-3)."""
    import torch
    from repro_torch.core import mass_captured, power_iteration
    from repro_torch.graph import to_ell
    sync()
    t0 = time.perf_counter()
    ell = to_ell(g, K=32)
    sync()
    log("10 to_ell", seconds=time.perf_counter() - t0, K=ell.K,
        n_rows=ell.n_rows, spill_nnz=ell.spill_nnz, bytes=ell.nbytes,
        slab_lanes_valid=int(ell.valid.sum()))
    sync()
    t0 = time.perf_counter()
    pi_ell = power_iteration(g, num_iters=50, spmv="ell")
    sync()
    t_ell = time.perf_counter() - t0
    assert pi_ell.shape == (g.n,) and bool(torch.isfinite(pi_ell).all())
    rel = float(((pi_ell - pi).abs() / pi).max())
    mu = [float(mass_captured(v, pi, 100)) for v in (pi_ell, pi)]
    log("10 graphlab_pr", iters=50, seconds=t_ell, max_rel_diff_coo=rel,
        mu100_ell=mu[0], mu100_coo=mu[1], ok=rel <= 1e-3)
    assert rel <= 1e-3, "the ELL iteration strays from the COO iteration"
    return ell


def phase_figure1(g, pi, ell, erasure_runs, t):
    """The reduced-iteration baseline and the paper's Figure 1 rows: time
    per ELL and per COO iteration, per erasure superstep, and the
    wire-byte models. No speed target."""
    from repro_torch.core import (mass_captured, pagerank,
                                  reduced_iteration_baseline)
    from repro_torch.engine import frogwild_bytes_model, pagerank_bytes_model
    from repro_torch.graph.csr import transition_edges
    from repro_torch.kernels import ops
    for iters in (1, 2):
        sync()
        t0 = time.perf_counter()
        x = reduced_iteration_baseline(g, iters)
        sync()
        log("10 reduced_baseline", iters=iters,
            seconds=time.perf_counter() - t0,
            mu100=float(mass_captured(x, pi, 100)),
            mu100_opt=float(mass_captured(pi, pi, 100)))
    n, p_T = g.n, 0.15
    x = pi.clone()
    ell_ms = time_ms(lambda: (1.0 - p_T) * ops.spmv(ell, x)[:n] + p_T / n)
    src, dst, w = transition_edges(g)
    coo_ms = time_ms(lambda: pagerank._power_iter_coo(src, dst, w, n, 1,
                                                      p_T))
    N, p_s, S = QUICKSTART["num_frogs"], QUICKSTART["p_s"], QUICKSTART[
        "shards"]
    fw = frogwild_bytes_model(N, t, p_T, p_s, S)
    pr = pagerank_bytes_model(n, 2, S)
    log("10 figure1", ell_iter_ms=ell_ms, coo_iter_ms=coo_ms,
        erasure_superstep_ms=json.dumps({
            f"{m}/{d}": s / t * 1e3 for (m, d), s in erasure_runs.items()}),
        frogwild_bytes=fw.total, pagerank_2iter_bytes=pr.total,
        bytes_ratio=fw.total / pr.total)


def kernel_rows(svc, index, hubs, launches, dev, blocked, sharded, ell, pi):
    """Each kernel at the main path's shapes: kernel vs plain (byte-equal),
    times and bounds. ``launches`` maps each kernel to its count on the
    path that runs it; ``blocked`` is the graph's slab layout, ``sharded``
    the S = 8 index, ``ell`` the K = 32 ELL layout and ``pi`` a rank
    vector to multiply."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.query.engine import plan_query, wave_prep
    g, sc = svc.graph, svc.config.serving
    n = g.n
    rows = []
    want_of = {}

    def row(name, source, replaces, kern, plain, nbytes, library=None,
            blocks=0):
        a, b = kern(), plain()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        err = max((x.double() - y.double()).abs().max().item()
                  if x.is_floating_point() else
                  int((x.long() - y.long()).abs().max()) if x.numel() else 0
                  for x, y in zip(a, b))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        want_of[name] = b[0]
        by_ops = ops_bound_ms(blocks) if blocks else 0.0
        r = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches[name], max_abs_err=err,
                 ms=time_ms(kern), plain_ms=time_ms(plain),
                 bound_ms=max(bound_ms(nbytes), by_ops),
                 bound_by="operations" if by_ops > bound_ms(nbytes)
                 else "bytes",
                 library_ms=time_ms(library) if library else None)
        log("12 kernel", **{k: v for k, v in r.items()
                           if k not in ("source", "replaces", "route")},
            bytes_bound_ms=bound_ms(nbytes), ops_bound_ms=by_ops)
        rows.append(r)

    # frog_step at the batch superstep's shape (N = 400,000 frogs)
    key = prng.PRNGKey(3, dev)
    k1, k2, k3 = prng.split(key, 3)
    N = 400_000
    pos = prng.randint(k1, (N,), 0, n)
    die = prng.bernoulli(k2, 0.15, (N,)).to(torch.int32)
    bits = prng.randint(k3, (N,), 0, 1 << 30)
    d = g.out_deg[pos.long()]
    edge = (g.row_ptr[pos.long()].long()
            + torch.remainder(bits, torch.clamp_min(d, 1)).long())
    nb = 16 * N + 4 * n + 32 * (2 * sectors(pos) + sectors(edge))
    row("frog_step", "src/repro_torch/kernels/csrc/frog_step.cu",
        "src/repro/kernels/frog_step.py:84",
        lambda: ops.frog_step(pos, die, bits, g.row_ptr, g.col_idx,
                              g.out_deg, n, impl="cuda"),
        lambda: kref.frog_step_ref(pos, die, bits, g.row_ptr, g.col_idx,
                                   g.out_deg, n), nb)

    # one wave's walks after its prologue, for the stitch rounds and tally
    W, Q, R = sc.max_walks, sc.max_queries, index.segments_per_vertex
    start, uniform, qid, t_cap = wave_inputs(n, hubs, W, Q, dev)
    wpos, q, k_slot = wave_prep(g.row_ptr, g.col_idx, g.out_deg, start,
                                uniform, t_cap, prng.PRNGKey(5, dev), n=n,
                                L=index.segment_len, p_T=svc.config.p_T)
    # the caller mode's slot offsets, as the device mode draws them
    s0 = prng.randint(k_slot, (W,), 0, 1 << 30)
    slab = index.endpoints
    flat = slab.reshape(-1)
    sidx = wpos.long() * R + torch.remainder(s0, R).long()
    row("stitch_gather", "src/repro_torch/kernels/csrc/stitch.cu",
        "src/repro/kernels/stitch.py:161",
        lambda: ops.stitch_gather(wpos, s0, slab, impl="cuda"),
        lambda: kref.stitch_gather_ref(wpos, s0, slab),
        12 * W + 32 * sectors(sidx),
        library=lambda: torch.take(flat, sidx))
    log("12 launch_path", calls=LAUNCH_PATH_CALLS,
        stitch_gather_host_us=host_us(
            lambda: ops.stitch_gather(wpos, s0, slab, impl="cuda")),
        torch_take_host_us=host_us(lambda: torch.take(flat, sidx)))

    # the wave's q_max stitch rounds in one launch, at the dense wave's
    # shape over the dense slab; its yardstick is the same rounds as
    # torch.take + torch.where (the slots and masks made beforehand)
    q_max = svc.scheduler._q_max
    slots = [torch.remainder(torch.abs(s0 + j), R).long()
             for j in range(q_max)]
    moves = [j < q for j in range(q_max)]

    def take_rounds(flat_=flat):
        p = wpos
        for j in range(q_max):
            p = torch.where(moves[j], torch.take(flat_, torch.add(
                slots[j], p, alpha=R)), p)
        return p

    def rounds(lost=None, S=1, sz=0, slab_=slab, rng="caller"):
        return ops.stitch_gather_rounds(
            wpos, q, k_slot if rng == "device" else s0, slab_, q_max, lost,
            S, sz, impl="cuda", rng=rng)

    def device_row(name, source, replaces, kern, caller, plain, nbytes,
                   walks=W):
        """The rounds kernel as the service paths run it (``rng="device"``,
        the key as operand): byte-equal to its caller mode on ``prng``'s
        ``s0`` and to its plain version; bound by its bytes (the key read
        once in place of 4 B of s0 a walk) or its two threefry blocks a
        walk (``split(key, 1)`` and the bits)."""
        a, b = kern(), caller()
        a, b = (a if isinstance(a, tuple) else (a,),
                b if isinstance(b, tuple) else (b,))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        launches[name + ":device"] = launches[name]
        row(name + ":device", source, replaces, kern, plain, nbytes,
            blocks=2 * walks)

    assert torch.equal(take_rounds(), rounds()[0]), "torch.take rounds"
    row("stitch_gather_rounds", "src/repro_torch/kernels/csrc/stitch.cu",
        "src/repro/kernels/stitch.py:161",
        lambda: rounds()[0],
        lambda: kref.stitch_gather_rounds_ref(wpos, q, s0, slab, q_max)[0],
        16 * W + 32 * rounds_sectors(wpos, q, s0, slab, q_max),
        library=take_rounds)
    # an event-timed call is host-bound: the device time of a launch from
    # a trace of 20 launches
    n_k, dev_ms = device_ms_per_launch(rounds, "stitch_gather_rounds_kernel")
    log("12 stitch_gather_rounds_device", walks=W, q_max=q_max,
        launches=n_k, device_ms_per_launch=dev_ms)
    device_row("stitch_gather_rounds",
               "src/repro_torch/kernels/csrc/stitch.cu",
               "src/repro/kernels/stitch.py:47",
               lambda: rounds(rng="device")[0], lambda: rounds()[0],
               lambda: kref.stitch_gather_rounds_ref(
                   wpos, q, kref.slot_bits(k_slot, W), slab, q_max)[0],
               12 * W + 16 + 32 * rounds_sectors(wpos, q, s0, slab, q_max))
    n_k, dev_ms = device_ms_per_launch(lambda: rounds(rng="device"),
                                       "stitch_gather_rounds_kernel")
    log("12 stitch_gather_rounds_device_rng", walks=W, q_max=q_max,
        launches=n_k, device_ms_per_launch=dev_ms)
    # the fused sharded wave's: the stacked S = 8 blocks, shard 3 lost
    S8, sz8, _ = sharded.blocks.shape
    stacked = sharded.blocks.view(S8 * sz8, R)
    lost = torch.zeros(S8, dtype=torch.bool, device=dev)
    lost[3] = True
    got = rounds(lost, S8, sz8, stacked)
    want = kref.stitch_gather_rounds_ref(wpos, q, s0, stacked, q_max, lost,
                                         S8, sz8)
    equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    log("12 stitch_gather_rounds_lost", shards=S8, lost_shard=3,
        byte_equal=equal, dead=int((~got[1]).sum()),
        ms=time_ms(lambda: rounds(lost, S8, sz8, stacked)),
        bound_ms=bound_ms(17 * W + S8 + 32 * rounds_sectors(
            wpos, q, s0, stacked, q_max, lost, S8, sz8)))
    assert equal and not bool(got[1].all()), \
        "stitch_gather_rounds differs from its plain version, shard 3 lost"

    # the loop wave's q_max rounds over the 8 shard blocks in one launch,
    # each block read as a tensor of its own through the pointer table; its
    # yardstick is the same rounds as torch.take + torch.where
    table = ops.block_table(list(sharded.blocks))

    def local_rounds(lost=None, table_=table, rng="caller"):
        return ops.stitch_gather_local_rounds(
            wpos, q, k_slot if rng == "device" else s0, table_, q_max, lost,
            impl="cuda", rng=rng)

    row("stitch_gather_local_rounds",
        "src/repro_torch/kernels/csrc/stitch_local.cu",
        "src/repro/kernels/stitch.py:252",
        lambda: local_rounds()[0],
        lambda: kref.stitch_gather_local_rounds_ref(wpos, q, s0,
                                                    table.blocks, q_max)[0],
        16 * W + 8 * S8 + 32 * rounds_sectors(wpos, q, s0, stacked, q_max),
        library=lambda: take_rounds(stacked.reshape(-1)))
    n_k, dev_ms = device_ms_per_launch(local_rounds,
                                       "stitch_gather_local_rounds_kernel")
    log("12 stitch_gather_local_rounds_device", walks=W, q_max=q_max,
        shards=S8, launches=n_k, device_ms_per_launch=dev_ms)
    device_row("stitch_gather_local_rounds",
               "src/repro_torch/kernels/csrc/stitch_local.cu",
               "src/repro/kernels/stitch.py:47",
               lambda: local_rounds(rng="device")[0],
               lambda: local_rounds()[0],
               lambda: kref.stitch_gather_local_rounds_ref(
                   wpos, q, kref.slot_bits(k_slot, W), table.blocks,
                   q_max)[0],
               12 * W + 16 + 8 * S8 + 32 * rounds_sectors(wpos, q, s0,
                                                          stacked, q_max))
    # shard 3 lost, the other 7 blocks each allocated apart and shard 3's
    # table entry a null pointer: equal to the plain version and to the
    # fused wave's rounds over the stacked blocks
    own = [None if s == 3 else sharded.blocks[s].clone() for s in range(S8)]
    own_table = ops.block_table(own)
    got = local_rounds(lost, own_table)
    want = kref.stitch_gather_local_rounds_ref(wpos, q, s0, own, q_max, lost)
    fused = rounds(lost, S8, sz8, stacked)
    drawn = (local_rounds(lost, own_table, rng="device"),
             rounds(lost, S8, sz8, stacked, rng="device"))
    equal = all(torch.equal(a, b) and torch.equal(a, c)
                and torch.equal(a, d) and torch.equal(a, e)
                for a, b, c, d, e in zip(got, want, fused, *drawn))
    log("12 stitch_gather_local_rounds_lost", shards=S8, lost_shard=3,
        separate_blocks=S8 - 1, null_entry=int(own_table.ptrs[3]) == 0,
        byte_equal_plain_and_fused=equal, dead=int((~got[1]).sum()),
        ms=time_ms(lambda: local_rounds(lost, own_table)),
        bound_ms=bound_ms(17 * W + S8 + 8 * S8 + 32 * rounds_sectors(
            wpos, q, s0, stacked, q_max, lost, S8, sz8)))
    assert equal and not bool(got[1].all()), \
        "stitch_gather_local_rounds differs, shard 3 lost"
    del own, own_table

    stop = (q == 0).to(torch.int32)
    # the four per-round kernels (the TPU kernels' direct counterparts)
    # under rng="device" against their caller mode on prng's bits
    block3, base3 = sharded.blocks[3], 3 * sharded.blocks.shape[1]
    per_round = {
        "stitch_gather": lambda b, m: ops.stitch_gather(
            wpos, b, slab, impl="cuda", rng=m),
        "stitch_step": lambda b, m: ops.stitch_step(
            wpos, stop, b, slab, n, impl="cuda", rng=m),
        "stitch_gather_local": lambda b, m: ops.stitch_gather_local(
            wpos, b, block3, base3, impl="cuda", rng=m),
        "stitch_step_local": lambda b, m: ops.stitch_step_local(
            wpos, stop, b, block3, base3, impl="cuda", rng=m)}
    for name, call in per_round.items():
        a, b = call(k_slot, "device"), call(s0, "caller")
        a, b = (a if isinstance(a, tuple) else (a,),
                b if isinstance(b, tuple) else (b,))
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        log("12 device_rng", kernel=name, walks=W, byte_equal_caller=equal,
            ms=time_ms(lambda: call(k_slot, "device")),
            caller_ms=time_ms(lambda: call(s0, "caller")))
        assert equal, f"{name}: rng='device' differs from the caller mode"
    row("stitch_step", "src/repro_torch/kernels/csrc/stitch.cu",
        "src/repro/kernels/stitch.py:99",
        lambda: ops.stitch_step(wpos, stop, s0, slab, n, impl="cuda"),
        lambda: kref.stitch_step_ref(wpos, stop, s0, slab, n),
        16 * W + 4 * n + 32 * sectors(sidx))
    n_k, dev_ms = device_ms_per_launch(
        lambda: ops.stitch_step(wpos, stop, s0, slab, n, impl="cuda"),
        "stitch_step_kernel")
    log("12 stitch_step_device", walks=W, launches=n_k,
        device_ms_per_launch=dev_ms)

    # walk_wave's rounds and their stop tally in one launch, at phase 5's
    # query_counts plan (its walks after the residual steps); the yardstick
    # is the same rounds as torch.take + torch.where and one index_add_
    plan = plan_query(10, 0.3, 0.1, p_T=svc.config.p_T,
                      max_steps=sc.max_steps, segments_per_vertex=R,
                      segment_len=index.segment_len)
    Wq, nr = plan.num_walks, plan.num_rounds(index.segment_len)
    qpos, qq, qk_slot = wave_prep(
        g.row_ptr, g.col_idx, g.out_deg,
        torch.zeros(Wq, dtype=torch.int32, device=dev),
        torch.ones(Wq, dtype=torch.bool, device=dev),
        torch.full((Wq,), plan.num_steps, dtype=torch.int32, device=dev),
        prng.PRNGKey(7, dev), n=n, L=index.segment_len, p_T=svc.config.p_T)
    qs0 = prng.randint(qk_slot, (Wq,), 0, 1 << 30)
    qslots = [torch.remainder(torch.abs(qs0 + j), R).long()
              for j in range(nr + 1)]
    qmoves = [j < qq for j in range(nr + 1)]
    tallied = (qq <= nr).to(torch.int32)

    def take_step_rounds():
        p = qpos
        for j in range(nr + 1):
            p = torch.where(qmoves[j], torch.take(flat, torch.add(
                qslots[j], p, alpha=R)), p)
        return p, torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, p.long(), tallied)

    def step_rounds(rng="caller"):
        return ops.stitch_step_rounds(
            qpos, qq, qk_slot if rng == "device" else qs0, slab, n, nr,
            impl="cuda", rng=rng)

    assert all(torch.equal(a, b) for a, b in zip(take_step_rounds(),
                                                  step_rounds())), \
        "torch.take step rounds"
    row("stitch_step_rounds", "src/repro_torch/kernels/csrc/stitch.cu",
        "src/repro/kernels/stitch.py:99", step_rounds,
        lambda: kref.stitch_step_rounds_ref(qpos, qq, qs0, slab, n, nr),
        16 * Wq + 4 * n + 32 * rounds_sectors(qpos, qq, qs0, slab, nr + 1),
        library=take_step_rounds)
    n_k, dev_ms = device_ms_per_launch(step_rounds,
                                       "stitch_step_rounds_kernel")
    log("12 stitch_step_rounds_device", walks=Wq, rounds=nr + 1,
        tallied=int(tallied.sum()), launches=n_k,
        device_ms_per_launch=dev_ms)
    device_row("stitch_step_rounds", "src/repro_torch/kernels/csrc/stitch.cu",
               "src/repro/kernels/stitch.py:47",
               lambda: step_rounds("device"), step_rounds,
               lambda: kref.stitch_step_rounds_ref(
                   qpos, qq, kref.slot_bits(qk_slot, Wq), slab, n, nr),
               12 * Wq + 16 + 4 * n + 32 * rounds_sectors(qpos, qq, qs0,
                                                          slab, nr + 1),
               walks=Wq)
    n_k, dev_ms = device_ms_per_launch(lambda: step_rounds("device"),
                                       "stitch_step_rounds_kernel")
    log("12 stitch_step_rounds_device_rng", walks=Wq, launches=n_k,
        device_ms_per_launch=dev_ms)
    bins = (Q + 1) * n
    dest = wpos + qid * n
    dest_l = dest.long()
    row("frog_count", "src/repro_torch/kernels/csrc/frog_count.cu",
        "src/repro/kernels/frog_scatter.py:46",
        lambda: ops.frog_count(dest, bins, impl="cuda"),
        lambda: kref.frog_count_ref(dest, bins),
        4 * W + 4 * bins,
        library=lambda: torch.bincount(dest_l, minlength=bins))
    # frog_step at the index build's shape (R · n / build_shards frogs)
    C = -(-n // sc.build_shards) * R
    ipos = torch.randint(0, n, (C,), device=dev, dtype=torch.int32)
    ibits = torch.randint(0, 1 << 30, (C,), device=dev, dtype=torch.int32)
    zeros = torch.zeros_like(ipos)
    ms = time_ms(lambda: ops.frog_step(ipos, zeros, ibits, g.row_ptr,
                                       g.col_idx, g.out_deg, n, impl="cuda"),
                 reps=10)
    log("12 frog_step_index_shape", frogs=C, ms=ms)

    # frog_step_stream_sorted at the batch superstep's shape, frogs sorted
    bv, num_vb = blocked.vertex_block, blocked.num_blocks
    pos_s, order = torch.sort(pos, stable=True)
    seg_off = torch.searchsorted(
        pos_s, torch.arange(num_vb + 1, dtype=torch.int32, device=dev) * bv,
        out_int32=True)
    die_s, bits_s = die[order], bits[order]
    # the work items come from the wrapper's prologue: timed apart from
    # the kernel, as the sort is
    sched = ops.stream_schedule(seg_off, N)
    vb = pos_s.long() // bv
    local = pos_s.long() - vb * bv
    d = blocked.deg[vb, local]
    cidx = vb * blocked.e_blk + blocked.row_off[vb, local].long() + \
        torch.remainder(bits_s, torch.clamp_min(d, 1)).long()
    nb = (16 * N + 4 * num_vb * bv + 4 * (num_vb + 1)
          + 32 * (2 * sectors(pos_s) + sectors(cidx[d > 0])))
    row("frog_step_stream_sorted",
        "src/repro_torch/kernels/csrc/frog_step_stream.cu",
        "src/repro/kernels/frog_step_stream.py:215",
        lambda: ops.frog_step_stream_sorted(pos_s, die_s, bits_s, seg_off,
                                            sched, blocked, impl="cuda"),
        lambda: kref.frog_step_stream_sorted_ref(
            pos_s, die_s, bits_s, seg_off, blocked.row_off, blocked.deg,
            blocked.col), nb)
    # the whole streamed step (sort, kernel, unsort) at the index build's
    # shape of one build shard: R · n / build_shards frogs
    ms = time_ms(lambda: ops.frog_step(ipos, zeros, ibits, g.row_ptr,
                                       g.col_idx, g.out_deg, n,
                                       impl="stream", blocked=blocked),
                 reps=10)
    log("12 frog_step_stream_index_shape", frogs=C, ms=ms)

    draw_rows(svc, g, blocked, row, dev)
    threefry_rows(svc, g, row, dev)

    # the per-shard kernels at one wave's walks against shard 3's block
    S, sz, _ = sharded.blocks.shape
    base = 3 * sz
    block = sharded.blocks[3]
    lidx = wpos.long() - base
    owned = (lidx >= 0) & (lidx < sz)
    bidx = (lidx * R + torch.remainder(s0, R).long())[owned]
    row("stitch_gather_local", "src/repro_torch/kernels/csrc/stitch_local.cu",
        "src/repro/kernels/stitch.py:252",
        lambda: ops.stitch_gather_local(wpos, s0, block, base, impl="cuda"),
        lambda: kref.stitch_gather_local_ref(wpos, s0, block, base),
        12 * W + 32 * sectors(bidx))
    row("stitch_step_local", "src/repro_torch/kernels/csrc/stitch_local.cu",
        "src/repro/kernels/stitch.py:300",
        lambda: ops.stitch_step_local(wpos, stop, s0, block, base,
                                      impl="cuda"),
        lambda: kref.stitch_step_local_ref(wpos, stop, s0, block, base),
        16 * W + 4 * sz + 32 * sectors(bidx))
    # the 8 shards' rounds, summed, are stitch_step's round
    parts = [ops.stitch_step_local(wpos, stop, s0, sharded.blocks[s], s * sz,
                                   impl="cuda") for s in range(S)]
    whole = ops.stitch_step(wpos, stop, s0, slab, n, impl="cuda")
    composed = (torch.equal(sum(p[0] for p in parts), whole[0])
                and torch.equal(torch.cat([p[1] for p in parts])[:n],
                                whole[1]))
    log("12 stitch_step_local_sum", shards=S, equal_stitch_step=composed)
    assert composed, "per-shard stitch rounds do not sum to stitch_step"

    # the ELL slab product of one power iteration over its live lanes: 8 B
    # a live lane, row_len, x (n floats) read once, y written once; the
    # library yardstick is cuSPARSE's CSR SpMV over the slab's valid lanes
    rows_, K = ell.idx.shape
    live = int(ell.row_len.sum())
    # the live prefixes in whole 32-byte sectors (each row starts a
    # 128-byte line), idx and weight
    sector_bytes = 2 * 32 * int(((ell.row_len.long() * 4 + 31) // 32).sum())
    valid = ell.valid
    with warnings.catch_warnings():      # "beta", "invariant checks off"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(
            torch.cat([valid.new_zeros(1, dtype=torch.int64),
                       torch.cumsum(valid.sum(1), 0)]),
            ell.idx[valid].long(), ell.weight[valid], size=(rows_, n))
    x = pi.contiguous()
    row("spmv_ell_slab", "src/repro_torch/kernels/csrc/spmv_ell.cu",
        "src/repro/kernels/spmv_ell.py:49",
        lambda: ops.spmv_ell_slab(ell.idx, ell.weight, x,
                                  row_len=ell.row_len, impl="cuda"),
        lambda: kref.spmv_ref(ell.idx, ell.weight, x),
        8 * live + 4 * rows_ + 4 * n + 4 * rows_,
        library=lambda: torch.mv(csr, x))
    idx0 = torch.zeros_like(ell.idx)
    every = torch.equal(ops.spmv_ell_slab(ell.idx, ell.weight, x,
                                          impl="cuda"),
                        want_of["spmv_ell_slab"])
    log("12 spmv_ell_slab_lanes", live_lanes=live, lanes=rows_ * K,
        sector_bytes=sector_bytes,
        sector_bound_ms=bound_ms(sector_bytes + 8 * rows_ + 4 * n),
        every_lane_ms=time_ms(lambda: ops.spmv_ell_slab(
            ell.idx, ell.weight, x, impl="cuda")),
        every_lane_bound_ms=bound_ms(8 * rows_ * K + 4 * n + 4 * rows_),
        every_lane_byte_equal=every,
        # the same lanes with every id 0: the x gathers become cache hits
        # and the slab's reads are what is left
        x_cached_ms=time_ms(lambda: ops.spmv_ell_slab(
            idx0, ell.weight, x, row_len=ell.row_len, impl="cuda")))
    del idx0
    assert every, "spmv_ell_slab without row_len differs from spmv_ref"
    # a K = 40 slab (160-byte rows) over the n rows, not a multiple of 8,
    # with and without row_len
    from repro_torch.graph import to_ell
    e40 = to_ell(g, K=40)
    idx40, w40, len40 = e40.idx[:n], e40.weight[:n], e40.row_len[:n]
    want40 = kref.spmv_ref(idx40, w40, x)
    eq40 = torch.equal(ops.spmv_ell_slab(idx40, w40, x, impl="cuda"),
                       want40)
    eq40_live = torch.equal(ops.spmv_ell_slab(idx40, w40, x, row_len=len40,
                                              impl="cuda"), want40)
    log("12 spmv_ell_slab_k40", rows=n, K=40, byte_equal=eq40,
        byte_equal_row_len=eq40_live,
        ms=time_ms(lambda: ops.spmv_ell_slab(idx40, w40, x, impl="cuda")),
        bound_ms=bound_ms(8 * n * 40 + 8 * n),
        ms_row_len=time_ms(lambda: ops.spmv_ell_slab(
            idx40, w40, x, row_len=len40, impl="cuda")),
        bound_ms_row_len=bound_ms(8 * int(len40.sum()) + 12 * n))
    assert eq40 and eq40_live, "spmv_ell_slab differs from spmv_ref at K = 40"
    return rows


def walk_state(pos0, n, dev):
    """Fresh buffers for a batch walk from ``pos0``, and a reset to it."""
    import torch
    state = [pos0.clone(), torch.ones(pos0.shape[0], dtype=torch.bool,
                                      device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev)]

    def reset():
        state[0].copy_(pos0)
        state[1].fill_(True)
        state[2].zero_()
        return state
    return reset


def draw_rows(svc, g, blocked, row, dev):
    """The walker step with its own draws at the main path's shapes: the
    batch walk's t = 32 supersteps of 400,000 frogs from ``pagerank``'s
    key (one row is the whole walk, reset included), and one build
    shard's hop (R = 16 walks of each of the shard's rows), resident and
    streamed, each byte-equal to its plain version at every step. Bounds:
    the bytes each step must move and the threefry blocks the design
    computes, from this run's states. The planted wrong streams (``k_die``
    and ``k_move`` swapped; the sorted index as the counter) must differ
    from the kernels."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.query.engine import plan_query
    rc, sc = svc.config, svc.config.serving
    n, p_T = g.n, rc.p_T
    T = plan_query(100, 0.1, 0.1, p_T=p_T, max_steps=sc.max_steps).num_steps
    N = 400_000
    k_init, k_loop = prng.split(prng.PRNGKey(rc.runtime.seed, dev))
    pos0 = prng.randint(k_init, (N,), 0, n)
    step_keys = prng.split(k_loop, T)
    graph = (g.row_ptr, g.col_idx, g.out_deg, n)
    bv = blocked.vertex_block

    def sorted_runs(pos):
        return ops._sorted_runs("smoke", pos, *graph, blocked)[1:]

    def superstep_plain(state, s, stream):
        if not stream:
            return ops.frog_superstep(*state, step_keys[s], p_T, *graph,
                                      impl="torch")
        pos_s, order, seg_off, sched = sorted_runs(state[0])
        ops.frog_superstep_stream_sorted(pos_s, order, *state, step_keys[s],
                                         p_T, seg_off, sched, blocked,
                                         impl="torch")

    def superstep_kernel(state, s, stream):
        ops.frog_superstep(*state, step_keys[s], p_T, *graph,
                           impl="stream" if stream else "cuda",
                           blocked=blocked)

    def walk(step, stream, reset):
        def fn():
            state = reset()
            for s in range(T):
                step(state, s, stream)
            return tuple(state)
        return fn

    # every step byte-equal, and what each step had to move and draw
    stats = {"bytes": 0, "stream_bytes": 0, "blocks": 0, "stream_blocks": 0}
    kern, plain = walk_state(pos0, n, dev)(), walk_state(pos0, n, dev)()
    ctas = -(-N // 256)
    for s in range(T):
        pos, alive = plain[0].clone(), plain[1].clone()
        die, bits = kref.superstep_draws(step_keys[s], p_T, N)
        dying, surv = alive & die, alive & ~die
        p = pos[surv].long()
        d = g.out_deg[p]
        e = g.row_ptr[p[d > 0]].long() + torch.remainder(bits[surv][d > 0],
                                                         d[d > 0]).long()
        live, moved = int(alive.sum()), int(surv.sum())
        # alive read, pos read and written, alive written for the dying;
        # scattered: the survivors' deg, row_ptr and col_idx sectors and
        # the dying frogs' counts sectors
        stats["bytes"] += (N + 4 * live + 4 * moved + int(dying.sum())
                           + 32 * (2 * sectors(p) + sectors(e)
                                   + sectors(pos[dying])))
        # streamed: the sort (pos read, pos_s and order written), the
        # kernel's pos_s, order and alive, pos written for the survivors,
        # each visited block's row_off/deg slabs, the col and counts
        # sectors
        touched = int(torch.unique(pos.long() // bv).numel())
        stats["stream_bytes"] += (29 * N + 4 * moved + int(dying.sum())
                                  + 8 * bv * touched
                                  + 32 * (sectors(e) + sectors(pos[dying])))
        # the frogs' coins and slots, and the step keys once per CTA
        items = int((sorted_runs(pos)[3][1] < blocked.num_blocks).sum())
        stats["blocks"] += live + moved + 3 * ctas
        stats["stream_blocks"] += live + moved + 3 * items
        superstep_plain(plain, s, False)
        superstep_kernel(kern, s, False)
        assert all(torch.equal(a, b) for a, b in zip(kern, plain)), \
            f"frog_superstep differs from its plain version at step {s}"
    log("12 superstep_walk", frogs=N, steps=T, alive_at_t=int(plain[1].sum()),
        byte_equal_every_step=True)
    for name, stream in (("frog_superstep", False),
                         ("frog_superstep_stream_sorted", True)):
        reset_k, reset_p = walk_state(pos0, n, dev), walk_state(pos0, n, dev)
        key = "stream_" if stream else ""
        row(name, f"src/repro_torch/kernels/csrc/"
            f"{'frog_step_stream' if stream else 'frog_step'}.cu",
            "src/repro/kernels/frog_step_stream.py:215" if stream
            else "src/repro/kernels/frog_step.py:84",
            walk(superstep_kernel, stream, reset_k),
            walk(superstep_plain, stream, reset_p),
            # the reset: pos0 read, pos, alive and counts written
            stats[key + "bytes"] + 9 * N + 4 * n,
            blocks=stats[key + "blocks"])
    # the same walk as the caller draws it: prng's draws outside, then the
    # caller-bits frog_step (resident or streamed) on them
    def caller_step(state, s, stream):
        pos, alive, counts = state
        die, bits = kref.superstep_draws(step_keys[s], p_T, N)
        die &= alive
        nxt, dead = ops.frog_step(pos, die, bits, *graph,
                                  impl="stream" if stream else "cuda",
                                  blocked=blocked)
        counts += dead
        alive &= ~die
        pos.copy_(torch.where(alive, nxt, pos))

    caller = walk(caller_step, False, walk_state(pos0, n, dev))
    stream_caller = walk(caller_step, True, walk_state(pos0, n, dev))
    assert torch.equal(caller()[2], plain[2])
    log("12 superstep_walk_caller_draws", steps=T, ms=time_ms(caller, 10),
        stream_ms=time_ms(stream_caller, 10))

    # the planted wrong streams: k_die and k_move swapped, and the sorted
    # index as the streamed kernel's counter, each against one kernel step
    one = walk_state(pos0, n, dev)()
    superstep_kernel(one, 0, False)
    k_die, k_move = prng.split(step_keys[0])
    swapped = kref.frog_step_ref(pos0, prng.bernoulli(k_move, p_T, (N,)),
                                 prng.randint(k_die, (N,), 0, 1 << 30),
                                 *graph)[1]
    pos_s, order, seg_off, sched = sorted_runs(pos0)
    one_s = walk_state(pos0, n, dev)()
    ops.frog_superstep_stream_sorted(pos_s, order, *one_s, step_keys[0], p_T,
                                     seg_off, sched, blocked)
    die, bits = kref.superstep_draws(step_keys[0], p_T, N)
    at_sorted = kref.frog_step_stream_sorted_ref(
        pos_s, die.to(torch.int32), bits, seg_off, blocked.row_off,
        blocked.deg, blocked.col)[1][:n]
    caught = (not torch.equal(one[2], swapped),
              not torch.equal(one_s[2], at_sorted))
    log("12 superstep_wrong_stream", swapped_keys_caught=caught[0],
        sorted_counter_caught=caught[1])
    assert all(caught), "the gate does not see a wrong draw stream"

    # one build shard's hops: R walks of each of the shard's rows
    R, L = sc.segments_per_vertex, sc.segment_len
    C = -(-n // sc.build_shards)
    vertices = torch.arange(C, dtype=torch.int32, device=dev)
    row_keys = prng.fold_in(prng.PRNGKey(rc.runtime.seed, dev), vertices)
    start = torch.repeat_interleave(vertices, R)
    W = start.shape[0]
    f0 = torch.arange(0, W, 256, device=dev)
    cta_rows = ((f0 - f0 // R * R + torch.clamp_max(W - f0, 256) - 1) // R
                + 1)
    hop = {"bytes": 8 * W + 16 * C, "blocks": W + 2 * int(cta_rows.sum())}
    hop["stream_bytes"] = 32 * W + 16 * C
    kern, plain = start.clone(), start.clone()
    for step in range(L):
        if step == L - 1:       # the last hop's state is the timed one
            b = kref.hop_bits(row_keys, step, R)
            p = plain.long()
            d = g.out_deg[p]
            e = g.row_ptr[p[d > 0]].long() + torch.remainder(
                b[d > 0], d[d > 0]).long()
            hop["bytes"] += 32 * (sectors(p) + sectors(p[d > 0])
                                  + sectors(e))
            hop["stream_bytes"] += 32 * sectors(e) + 8 * bv * int(
                torch.unique(p // bv).numel())
            last = plain.clone()
        ops.frog_hop(kern, row_keys, step, R, *graph, impl="cuda")
        plain = kref.frog_hop_ref(plain, row_keys, step, R, *graph[:3])
        assert torch.equal(kern, plain), f"frog_hop differs at hop {step}"
    streamed = start.clone()
    for step in range(L):
        ops.frog_hop(streamed, row_keys, step, R, *graph, impl="stream",
                     blocked=blocked)
    assert torch.equal(streamed, plain), "frog_hop_stream_sorted differs"
    log("12 hop", rows=C, R=R, walks=W, hops=L, byte_equal_every_hop=True)
    # each timed call hops from the last hop's state: the copy into the
    # work buffer (W int32 read and written) is timed and bounded with it
    work = torch.empty_like(last)

    def hop_from_last(impl):
        work.copy_(last)
        ops.frog_hop(work, row_keys, L - 1, R, *graph, impl=impl,
                     blocked=blocked)
        return work

    for name, impl, key in (("frog_hop", "cuda", ""),
                            ("frog_hop_stream_sorted", "stream", "stream_")):
        row(name, f"src/repro_torch/kernels/csrc/"
            f"{'frog_step_stream' if key else 'frog_step'}.cu",
            "src/repro/kernels/frog_step_stream.py:215" if key
            else "src/repro/kernels/frog_step.py:84",
            lambda impl=impl: hop_from_last(impl),
            lambda: kref.frog_hop_ref(last, row_keys, L - 1, R, *graph[:3]),
            hop[key + "bytes"] + 8 * W,
            # streamed: one block a walk, and two a row for its hop key
            blocks=W + 2 * C if key else hop["blocks"])
    # what binds the streamed hop: its sort and runs, its kernel as the hop
    # runs it (writes and hop-key reads at order[f]), and the same launch
    # with order the identity (both in sorted order)
    pos_s, order, seg_off, sched = sorted_runs(last)
    hop_keys = kref.hop_keys(row_keys, L - 1, impl=None)
    identity = torch.arange(W, device=dev)

    def sorted_hop(o):
        ops.frog_hop_stream_sorted(pos_s, o, work, row_keys, L - 1, R,
                                   seg_off, sched, blocked,
                                   hop_keys=hop_keys)

    log("12 hop_stream_split", walks=W,
        sort_and_runs_ms=time_ms(lambda: sorted_runs(last)),
        kernel_ms=time_ms(lambda: sorted_hop(order)),
        kernel_sorted_order_ms=time_ms(lambda: sorted_hop(identity)))

    # the segment walk with its masks, as the build, the repair and the
    # refresh run it: the shard's L hops from the start, hops 0 … L − 2
    # recording the visited-block masks. One bound for every form, from
    # the walk's own inputs and outputs: the vertices and row keys read
    # once (20 B a row), endpoints and masks written once (36 B a walk),
    # the distinct row_ptr sectors (at p and p + 1: a degree is their
    # difference) of all L hops together, since row_ptr (19 MB) fits the
    # 50 MB L2 and need be read once, the distinct col_idx sectors of each
    # hop, since col_idx (275 MB) does not fit and a hop's random reads
    # find last hop's lines gone, and one threefry block a walk and hop and
    # two a row and hop (its key)
    bs = kref.segment_mask_block_size(n)
    seg_bytes = 20 * C + 36 * W
    row_ptr_at = []
    for step in range(L):
        p = kref.frog_segment_walk_ref(vertices, row_keys, R, step, *graph)[
            0].reshape(-1).long() if step else start.long()
        d = g.out_deg[p]
        b = kref.hop_bits(row_keys, step, R)
        e = g.row_ptr[p[d > 0]].long() + torch.remainder(
            b[d > 0], d[d > 0]).long()
        row_ptr_at += [p, p + 1]
        seg_bytes += 32 * sectors(e)
    seg_bytes += 32 * sectors(torch.cat(row_ptr_at))
    del row_ptr_at
    seg_blocks = L * W + 2 * L * C
    want = kref.frog_segment_walk_ref(vertices, row_keys, R, L, *graph)
    # the per-hop resident walk the build ran before (frog_hop with its
    # visited operand), byte-equal at every hop
    pos, vis = torch.empty_like(start), torch.empty(
        W, kref.MASK_WORDS, dtype=torch.uint32, device=dev)

    def hop_walk(upto=L):
        pos.copy_(start)
        for step in range(upto):
            ops.frog_hop(pos, row_keys, step, R, *graph, impl="cuda",
                         visited=vis, record=step < L - 1)
        return pos.view(C, R), vis.view(torch.int32).view(C, R, -1)

    plain_pos, plain_vis = start, None
    for step in range(L):
        plain_pos = kref.frog_hop_ref(plain_pos, row_keys, step, R,
                                      *graph[:3])
        plain_vis = kref.hop_visits(plain_vis, plain_pos, step, step < L - 1,
                                    bs)
        got = hop_walk(step + 1)
        assert torch.equal(got[0].reshape(-1), plain_pos) and torch.equal(
            got[1].reshape(W, -1), plain_vis), f"hop {step} with masks"
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    out = {impl: (torch.empty(C, R, dtype=torch.int32, device=dev),
                  torch.empty(C, R, kref.MASK_WORDS, dtype=torch.uint32,
                              device=dev)) for impl in ("cuda", "stream")}

    def segment_walk(impl):
        ep, vb = ops.frog_segment_walk(vertices, row_keys, R, L, *graph,
                                       impl=impl, out=out[impl],
                                       blocked=blocked)
        return ep, vb.view(torch.int32)

    log("12 segment_walk", rows=C, R=R, walks=W, hops=L, mask_block=bs,
        mask_bytes=4 * want[1].numel(),
        nonzero_words=int((want[1] != 0).sum()), bound_ms=max(
            bound_ms(seg_bytes), ops_bound_ms(seg_blocks)),
        byte_equal=True)
    for name, fn in (("frog_segment_walk", lambda: segment_walk("cuda")),
                     ("frog_hop:masks", hop_walk),
                     ("frog_hop_stream_sorted:masks",
                      lambda: segment_walk("stream"))):
        row(name, "src/repro_torch/kernels/csrc/" + (
            "frog_segment.cu" if name == "frog_segment_walk" else
            "frog_step.cu" if name == "frog_hop:masks" else
            "frog_step_stream.cu"),
            "src/repro/kernels/frog_step_stream.py:215" if "stream" in name
            else "src/repro/kernels/frog_step.py:84",
            fn, lambda: kref.frog_segment_walk_ref(vertices, row_keys, R, L,
                                                   *graph),
            seg_bytes, blocks=seg_blocks)
    # the streamed walk's mask pass alone, over the trail of hops 0 … L − 2
    # (bound: 4 (L − 1) B a walk read, 32 B written)
    trail = torch.stack([
        kref.frog_segment_walk_ref(vertices, row_keys, R, s, *graph)[0]
        .reshape(-1) for s in range(1, L)])
    masks = torch.empty(W, kref.MASK_WORDS, dtype=torch.uint32, device=dev)

    def mask_pass():
        ops.frog_segment_masks(trail, masks, bs)
        return masks.view(torch.int32)

    row("frog_segment_masks", "src/repro_torch/kernels/csrc/"
        "frog_step_stream.cu", "src/repro/kernels/frog_step_stream.py:215",
        mask_pass, lambda: kref.frog_segment_masks_ref(trail, bs),
        4 * (L - 1) * W + 32 * W)


def no_host_sync(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any read
    back to the host raises."""
    import torch
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


# what each draw kernel stands in for in the reference: its jax.random
# call, which XLA fuses into one pass (no Pallas kernel)
DRAW_REPLACES = {
    "threefry_bits": "jax.random.bits (no call site in src/repro)",
    "threefry_randint": "src/repro/core/frogwild.py:199",
    "threefry_uniform": "src/repro/query/engine.py:158",
    "threefry_bernoulli": "src/repro/core/frogwild.py:80",
    "threefry_split": "src/repro/core/frogwild.py:230",
    "threefry_fold_in": "src/repro/query/index.py:267",
}


def wave_draws(L: int, scheduled: bool = True) -> dict:
    """The draw launches of one wave (``scheduled``: the scheduler's split
    of its key, ``wave_prep``'s three splits, the start ``randint``, the
    lengths' ``uniform`` and ``L`` residual ``randint``s; the slot offsets
    are drawn in the rounds kernel) or, unscheduled, of one
    ``query_counts`` (the same draws but the scheduler's split)."""
    return {"threefry_split": 3 + int(scheduled), "threefry_randint": 1 + L,
            "threefry_uniform": 1}


def threefry_rows(svc, g, row, dev):
    """The draw kernels at the main path's shapes, each byte-equal to
    ``prng``'s plain version on the same key: ``randint`` as the batch
    walk's 400,000 starts (and a wave's 8,192), ``uniform`` as a wave's
    lengths, ``bernoulli`` as the channel model's coins over (n, 16),
    ``fold_in`` over a build shard's 605,947 rows, ``split`` as the
    erasure walk's 65 step keys, ``random_bits`` at 400,000; each first
    run under the host-sync guard, as are a wave prologue's draws. Bounds:
    the output's bytes (and fold_in's data) against the threefry blocks
    the kernel computes. Planted wrong streams (randint's two streams
    swapped, the bits' counter off by one) must differ."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import ops
    sc, n = svc.config.serving, g.n
    N, W, S = 400_000, sc.max_walks, QUICKSTART["shards"]
    C = -(-n // sc.build_shards)
    key = prng.PRNGKey(svc.config.runtime.seed, dev)
    k1, k2, k3, k4, k5 = prng.split(key, 5)
    rows_ = torch.arange(C, dtype=torch.int32, device=dev)
    cta = -(-N // 256)
    _, _, mult = prng.randint_span(0, n)
    streams = 2 if mult else 1
    # (kernel, draw, bytes, threefry blocks, the kernel's name in a trace)
    cases = [
        ("threefry_randint", lambda i: prng.randint(k1, (N,), 0, n, i),
         4 * N + 16, streams * (N + cta), "threefry_randint_kernel"),
        ("threefry_uniform", lambda i: prng.uniform(k2, (W,), i),
         4 * W + 16, W, "threefry_draw_kernel"),
        ("threefry_bernoulli", lambda i: prng.bernoulli(
            k3, QUICKSTART["p_s"], (n, S), i), n * S + 16, n * S,
         "threefry_draw_kernel"),
        ("threefry_fold_in", lambda i: prng.fold_in(key, rows_, i),
         20 * C + 16, C, "threefry_fold_in_kernel"),
        ("threefry_split", lambda i: prng.split(k4, 65, i), 16 * 65 + 16, 65,
         "threefry_split_kernel"),
        ("threefry_bits", lambda i: prng.random_bits(k5, (N,), i),
         8 * N + 16, N, "threefry_draw_kernel"),
    ]
    for name, draw, nbytes, blocks, traced in cases:
        got = no_host_sync(lambda: draw("cuda"))
        assert torch.equal(got, draw("torch")), name
        row(name, "src/repro_torch/kernels/csrc/threefry_draw.cu",
            DRAW_REPLACES[name], lambda draw=draw: draw("cuda"),
            lambda draw=draw: draw("torch"), nbytes, blocks=blocks)
        # an event-timed call of a short kernel reads its launch path: the
        # device time of a launch from a trace, and the host µs of a call
        n_k, dev_ms = device_ms_per_launch(lambda draw=draw: draw("cuda"),
                                           traced)
        log("12 threefry_device", kernel=name, launches=n_k,
            device_ms_per_launch=dev_ms,
            host_us=host_us(lambda draw=draw: draw("cuda")))
    # a wave's start randint, W walks, beside the batch walk's N
    log("12 threefry_randint_wave", walks=W,
        ms=time_ms(lambda: prng.randint(k1, (W,), 0, n)),
        plain_ms=time_ms(lambda: prng.randint(k1, (W,), 0, n,
                                              impl="torch")))

    # a wave prologue's draws in order, one launch each, no host read
    def prologue():
        k_sched, k_wave = prng.split(key)
        k_start, k_tau, k_walk = prng.split(k_wave, 3)
        out = [prng.randint(k_start, (W,), 0, n), prng.uniform(k_tau, (W,))]
        k_res, _ = prng.split(k_walk)
        out += [prng.randint(k, (W,), 0, 1 << 30)
                for k in prng.split(k_res, sc.segment_len)]
        return out

    ops.reset_launch_counts()
    no_host_sync(prologue)
    got = {k: v for k, v in ops.launch_counts().items() if v}
    log("12 wave_prologue_draws", host_sync=False, launches=json.dumps(got))
    assert got == wave_draws(sc.segment_len), got

    # planted wrong streams: randint's high and low streams swapped, and
    # the bits one counter on
    keys = prng.split(k1, impl="torch")
    span = n
    hi_b = prng.random_bits(keys[1], (N,), "torch")
    lo_b = prng.random_bits(keys[0], (N,), "torch")
    swapped = ((((hi_b % span) * mult) & 0xFFFFFFFF) + lo_b % span) \
        % span
    shifted = prng.random_bits(k5, (N + 1,), "torch")[1:]
    caught = (not torch.equal(prng.randint(k1, (N,), 0, n).long(), swapped),
              not torch.equal(prng.random_bits(k5, (N,)), shifted))
    log("12 threefry_wrong_stream", swapped_streams_caught=caught[0],
        counter_off_by_one_caught=caught[1])
    assert all(caught), "the gate does not see a wrong draw stream"


# ---------------------------------------------------------------------------
# the LM stack: llama3.2-1b's prefill forward and serving loop
# ---------------------------------------------------------------------------

def lm_model(cfg, dev):
    """Random parameters from ``torch.Generator`` seed 0 on ``dev``."""
    import torch
    from repro_torch.models import init_params
    return init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)


def rel_frobenius(a, b, dim: int = 1, start: int = 0,
                  chunk: int = 4096) -> float:
    """``‖a − b‖_F / ‖b‖_F`` over the positions ``start:`` of dimension
    ``dim`` (1 for ``[B, S, …]`` logits and hidden states, 2 for
    ``[B, H, S, D]`` attention outputs), in float64 sums of float32 slices
    of ``chunk`` positions (no float32 copy of the whole)."""
    num = den = 0.0
    n = a.shape[dim]
    for s0 in range(start, n, chunk):
        w = min(chunk, n - s0)
        x, y = a.narrow(dim, s0, w).float(), b.narrow(dim, s0, w).float()
        num += float((x - y).double().square().sum())
        den += float(y.double().square().sum())
    return (num / den) ** 0.5


def rel_rows(a, b, dim: int) -> tuple:
    """(relative Frobenius error over all positions, over the last
    eighth): a fault in late rows, whose outputs are small, shows in the
    second."""
    n = a.shape[dim]
    return (rel_frobenius(a, b, dim),
            rel_frobenius(a, b, dim, n - max(n // 8, 1)))


@contextlib.contextmanager
def patched(module, name, make):
    """``module.<name>`` replaced by ``make(original)`` inside the block
    (a tap that records, or a planted fault)."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def late_keys_dropped(orig):
    """Planted fault: the kernel with a window of S/2, so each row past
    S/2 loses its keys more than S/2 back (half of a late row's keys)."""
    def fn(q, k, v, **kw):
        return orig(q, k, v, **{**kw, "window": q.shape[2] // 2})
    return fn


def newest_keys_dropped(orig, n: int = 64):
    """Planted fault: each row loses its ``n`` newest keys (a kernel that
    skips the diagonal key tile; rows below ``n`` come out 0)."""
    import torch

    def fn(q, k, v, **kw):
        out = torch.zeros_like(q)
        out[:, :, n:] = orig(q[:, :, n:], k, v, **kw)
        return out
    return fn


def decode_newest_key_dropped(orig):
    """Planted fault in decode: attention over the cache's valid prefix
    less its newest key (the token just written)."""
    def fn(q, k, v, length, **kw):
        return orig(q, k, v, max(1, length - 1), **kw)
    return fn


def scan_state_dropped(orig):
    """Planted fault in a recurrence: the scan starts from a zero state
    instead of the carried one (its sixth operand)."""
    def fn(*a, **kw):
        return orig(*a[:5], None, **kw)
    return fn


def cross_kv_zeroed(layer: int, layers: int):
    """Planted fault in whisper's decode: decoder layer ``layer``'s cached
    cross K/V read as zeros (of ``layers`` calls a step)."""
    import torch
    calls = [0]

    def make(orig):
        def fn(params, x, k, v, cfg):
            i = calls[0] % layers
            calls[0] += 1
            if i == layer:
                k, v = torch.zeros_like(k), torch.zeros_like(v)
            return orig(params, x, k, v, cfg)
        return fn
    return make


def decode_faults(cfg) -> list:
    """``(run, patch target, fault)`` of the serving gates: the sound run,
    the decode attention fault where the model attends, whisper's zeroed
    cross K/V in its middle layer, and a dropped recurrent state where it
    has a time recurrence."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.models import transformer
    runs = [("sound", None, None)]
    if not cfg.is_attention_free:
        runs.append(("fault", (kref, "decode_attention_ref"),
                     decode_newest_key_dropped))
    if cfg.family == "encdec":
        runs.append(("cross_fault", (transformer, "_cross_decode"),
                     cross_kv_zeroed(cfg.num_layers // 2, cfg.num_layers)))
    if cfg.family in SCAN_KERNEL:
        runs.append(("state_fault", (ops, SCAN_KERNEL[cfg.family]),
                     scan_state_dropped))
    return runs


@contextlib.contextmanager
def lm_taps():
    """Record what the LM path computes: ``attn`` gets every layer's
    attention output (``attention_forward``, ``decode_attention`` and
    whisper's ``_cross_decode``, after ``wo``, in call order), ``steps``
    one ``(tokens, logits, that step's attention outputs)`` for each
    ``decode_step`` that ``prefill`` and ``serve_step`` call."""
    import importlib
    from repro_torch.models import transformer
    attn, steps = [], []

    def forward(orig):
        def fn(*a, **kw):
            out = orig(*a, **kw)
            attn.append(out)
            return out
        return fn

    def decode(orig):
        def fn(*a, **kw):
            out, cache = orig(*a, **kw)
            attn.append(out)
            return out, cache
        return fn

    def step(orig):
        def fn(params, state, tokens, cfg):
            n = len(attn)
            logits, st = orig(params, state, tokens, cfg)
            steps.append((tokens.clone(), logits, attn[n:]))
            return logits, st
        return fn

    with contextlib.ExitStack() as stack:
        for mod, name, make in (
                (transformer, "attention_forward", forward),
                (transformer, "decode_attention", decode),
                (transformer, "_cross_decode", forward),
                (importlib.import_module("repro_torch.serving.decode"),
                 "decode_step", step),
                (importlib.import_module("repro_torch.serving.prefill"),
                 "decode_step", step)):
            stack.enter_context(patched(mod, name, make))
        yield attn, steps


def max_layer_rel(got, want, dim: int = 1) -> tuple:
    """The largest (all rows, last eighth) relative Frobenius errors over
    a list of per-layer outputs."""
    pairs = [rel_rows(a, b, dim) for a, b in zip(got, want, strict=True)]
    return max(p[0] for p in pairs), max(p[1] for p in pairs)


def attention_launches(cfg) -> int:
    """``flash_attention`` launches of one forward: one a layer; whisper
    one an encoder layer and two a decoder layer (self and cross)."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def prefix_len(cfg) -> int:
    """Positions before the text: the VLM's patch embeddings."""
    return cfg.num_prefix_embeddings if cfg.family == "vlm" else 0


def lm_inputs(cfg, dev, batch: int, seq: int) -> dict:
    """A forward's batch at ``seq`` positions: ``batch × (seq − P)``
    tokens from ``randint(PRNGKey(1))`` (P: :func:`prefix_len`), and, as
    the reference's ``input_specs`` shapes them, whisper's
    ``encoder_frames [batch, encoder_seq, d]`` or llava's
    ``prefix_embeds [batch, P, d]``, float32 normals from generator
    seed 3."""
    import torch
    from repro_torch import prng
    P = prefix_len(cfg)
    out = {"tokens": prng.randint(prng.PRNGKey(1, dev), (batch, seq - P), 0,
                                  cfg.vocab_size)}
    if cfg.family == "encdec":
        out["encoder_frames"] = frames_of(cfg, batch, dev, seed=3)
    if cfg.family == "vlm":
        gen = torch.Generator(device=dev).manual_seed(3)
        out["prefix_embeds"] = torch.randn((batch, P, cfg.d_model),
                                           generator=gen, device=dev)
    return out


def lm_cut(cfg, inputs: dict, seq: int) -> dict:
    """``inputs`` at their first ``seq`` positions: the text cut, the
    prefix and the frames whole."""
    return {**inputs, "tokens": inputs["tokens"][:, :seq - prefix_len(cfg)]}


def kv_padded_to_tile(orig):
    """Planted fault, the reference's Pallas wrapper's (ROADMAP Queue 3
    item 4): K/V zero-padded to a multiple of the 64-key tile and passed
    on, so a non-causal call reads the padding as live keys."""
    import torch.nn.functional as F

    def fn(q, k, v, **kw):
        pad = -k.shape[2] % 64
        return orig(q, F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad)),
                    **kw)
    return fn


def phase_lm_prefill(cfg, dev, batch=LM_PREFILL["batch"],
                     seq=LM_PREFILL["seq"],
                     gate2_seq=LM_PREFILL["gate2_seq"], tag="14",
                     path="lm_prefill", gate2_fault=late_keys_dropped):
    """``forward_train`` at full width and depth on :func:`lm_inputs` at
    ``[batch, seq]`` through the ``flash_attention`` kernel
    (:func:`attention_launches`), then gate 1 (bf16: relative Frobenius
    error against the same forward under ``attn_impl="torch"`` ≤ 5e-2),
    gate 1b (the kernel run again on each of that plain forward's
    attention inputs against its chunked output, ``ATTN_REL``) and gate 2
    (float32 at ``gate2_seq`` positions: max abs error ≤ 1e-3 · max
    |logits|, and each attention output within ``ATTN_REL``, which the
    planted ``gate2_fault`` must fail). ``tag`` and ``path`` label its
    lines. Returns the parameters, the inputs, the first forward's kernel
    launches, its peak memory and those launches by ``(q shape, k shape,
    causal)``."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import forward_train
    t0 = time.perf_counter()
    params = lm_model(cfg, dev)
    sync()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{tag} lm_model", arch=cfg.name, layers=cfg.num_layers,
        params=n_params,
        param_bytes=sum(p.numel() * p.element_size()
                        for p in params.parameters()),
        init_s=time.perf_counter() - t0)
    inputs = lm_inputs(cfg, dev, batch, seq)
    n_attn = attention_launches(cfg)
    # the kernel's launches by (q shape, k shape, causal), each call's
    # difference in the wrapper's own count
    by_shape = {}

    def count(orig):
        def fn(q, k, v, **kw):
            n0 = ops.launch_counts()["flash_attention"]
            out = orig(q, k, v, **kw)
            key = (tuple(q.shape), tuple(k.shape), kw.get("causal", True))
            by_shape[key] = (by_shape.get(key, 0)
                             + ops.launch_counts()["flash_attention"] - n0)
            return out
        return fn

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    with patched(ops, "attention", count), torch.inference_mode():
        logits, _ = forward_train(params, inputs, cfg)
    sync()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log("launches", path=path, **launches)
    log(f"{tag} launches_by_shape", path=path,
        shapes=json.dumps(sorted([*key, n] for key, n in by_shape.items())))
    assert launches["flash_attention"] == n_attn, launches
    assert sum(by_shape.values()) == n_attn, by_shape
    assert logits.shape == (batch, seq, cfg.vocab_size), logits.shape
    assert logits.dtype == torch.bfloat16
    finite = all(bool(torch.isfinite(logits[:, s0:s0 + 4096]).all())
                 for s0 in range(0, seq, 4096))
    del logits
    # the same forward again: the first call also pays one-time set-up
    # (library handles, the kernels' first launches, the allocator)
    sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = forward_train(params, inputs, cfg)
    sync()
    warm = time.perf_counter() - t0
    log(f"{tag} lm_prefill", batch=batch, seq=seq, wall_s=wall,
        tokens_per_s=batch * seq / wall, warm_wall_s=warm,
        warm_tokens_per_s=batch * seq / warm, peak_mem_bytes=peak,
        finite=finite)
    assert finite, "non-finite prefill logits"
    # Gate 1b rides on gate 1's plain forward. The residual stream
    # (|x| ~ √d_model) rounds small attention outputs away in bf16 and the
    # tied embedding dominates the logits, so gate 1 barely sees
    # attention: each of the plain forward's attention calls also runs the
    # kernel on its own (strided) inputs, the layer's real activations,
    # held to the chunked output.
    worst = [0.0, 0.0]

    def check(orig):
        def fn(q, k, v, **kw):
            out = orig(q, k, v, **kw)
            got = orig(q, k, v, **{**kw, "impl": "cuda"})
            worst[:] = map(max, worst, rel_rows(got, out, dim=2))
            return out
        return fn

    plain = dataclasses.replace(cfg, attn_impl="torch")
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    with patched(ops, "attention", check), torch.inference_mode():
        logits_t, _ = forward_train(params, inputs, plain)
    sync()
    t_plain = time.perf_counter() - t0
    rel = rel_frobenius(logits, logits_t)
    log(f"{tag} lm_prefill_gate1", dtype=cfg.dtype,
        plain_and_gate1b_wall_s=t_plain, rel_frobenius=rel, limit=5e-2,
        ok=rel <= 5e-2)
    assert rel <= 5e-2, "bf16 prefill logits stray from the plain path"
    del logits, logits_t
    checked = ops.launch_counts()["flash_attention"]
    assert checked == n_attn, checked
    lim = ATTN_REL[cfg.dtype]
    log(f"{tag} lm_prefill_gate1b", dtype=cfg.dtype, launches=checked,
        max_rel_frobenius=worst[0], max_rel_frobenius_last_eighth=worst[1],
        limit=lim, ok=max(worst) <= lim)
    assert max(worst) <= lim, "a launch strays from the chunked version"
    # Gate 2: float32 at gate2_seq; the logits and each attention output
    # against the plain path's, then the same with a planted fault to
    # show which of the two gates sees it.
    f32 = dataclasses.replace(cfg, dtype="float32")
    short = lm_cut(cfg, inputs, gate2_seq)
    runs = {}
    for what, c, fault in (
            ("kernel", f32, None),
            ("torch", dataclasses.replace(f32, attn_impl="torch"), None),
            ("fault", f32, gate2_fault)):
        with contextlib.ExitStack() as stack:
            attn, _ = stack.enter_context(lm_taps())
            if fault is not None:
                stack.enter_context(patched(ops, "attention", fault))
            stack.enter_context(torch.inference_mode())
            lg, _ = forward_train(params, short, c)
        runs[what] = (lg, attn)
    (a, a_attn), (b, b_attn) = runs["kernel"], runs["torch"]
    scale = float(b.abs().max())
    lim = ATTN_REL["float32"]
    for what in ("kernel", "fault"):
        got, got_attn = runs[what]
        err = float((got - b).abs().max())
        att = max_layer_rel(got_attn, b_attn)
        log(f"{tag} lm_prefill_gate2", run=what, dtype="float32",
            seq=gate2_seq, fault=gate2_fault.__name__ if what == "fault"
            else None,
            max_abs_err=err, max_abs_logit=scale, ratio=err / scale,
            limit=1e-3, logits_ok=err <= 1e-3 * scale,
            attn_max_rel_frobenius=att[0],
            attn_max_rel_frobenius_last_eighth=att[1], attn_limit=lim,
            attn_ok=max(att) <= lim)
        if what == "kernel":
            assert err <= 1e-3 * scale, \
                "f32 prefill logits stray from the plain path"
            assert max(att) <= lim, \
                "f32 attention outputs stray from the plain path"
        else:
            assert max(att) > lim, "the attention gate misses a planted fault"
    del runs, a, b, a_attn, b_attn
    return params, inputs, launches["flash_attention"], peak, by_shape


def frames_of(cfg, batch: int, dev, seed: int = 5):
    """whisper's ``encoder_frames [batch, encoder_seq, d]`` (float32
    normals from generator ``seed``), or None for the other families."""
    import torch
    if cfg.family != "encdec":
        return None
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                       device=dev)


@contextlib.contextmanager
def scheduler_frames(frames):
    """whisper's ``frames`` handed to each ``BatchScheduler`` wave's
    ``prefill`` (the first B rows for a wave of B, on the wave's device):
    the scheduler passes none, as the reference's does, and whisper's
    decode needs them. Nothing changes when ``frames`` is None."""
    from repro_torch.serving import scheduler

    def make(orig):
        def fn(params, cfg, toks, max_len):
            return orig(params, cfg, toks, max_len, encoder_frames=(
                frames[:toks.shape[0]].to(toks.device)))
        return fn

    with contextlib.ExitStack() as stack:
        if frames is not None:
            stack.enter_context(patched(scheduler, "prefill", make))
        yield


def phase_lm_serve(params, cfg, dev, requests=LM_SERVE["requests"],
                   max_new=LM_SERVE["max_new"],
                   max_batch=LM_SERVE["max_batch"],
                   invariant_seq=LM_SERVE["invariant_seq"], tag="15",
                   path="lm_serve"):
    """The launcher's workload (``BatchScheduler`` over
    ``launch.serve.make_requests``, greedy), ms per ``serve_step`` at
    B = ``max_batch``, and the serving invariant in float32: decode logits
    at each of ``invariant_seq`` positions against ``forward_train``'s,
    relative error ≤ 1e-3, and each attention output within ``ATTN_REL``,
    which a planted decode fault must fail. whisper's waves get
    :func:`frames_of`'s frames through :func:`scheduler_frames`, and the
    encoder's time in ``init_decode_state`` and the cross caches' bytes
    are logged; its invariant holds the decoder's self- and
    cross-attention outputs. The VLM serves text: its invariant's forward
    has an empty prefix. An MoE forward runs the invariant at capacity
    factor E / k, whose capacity is the group's length, so no pair can
    drop (a token picks an expert once; decode, one token a group of
    capacity 8, drops none). ``tag`` and ``path`` label its lines."""
    import dataclasses
    import torch
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import MAX_LEN, make_requests
    from repro_torch.models import (decode_step, forward_train,
                                    init_decode_state)
    from repro_torch.serving import BatchScheduler, prefill, serve_step
    reqs = make_requests(cfg, requests, 0, max_new)
    frames = frames_of(cfg, max_batch, dev)
    sched = BatchScheduler(params, cfg, max_batch=max_batch, max_len=MAX_LEN)
    for r in reqs:
        sched.submit(r)
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    with scheduler_frames(frames):
        done = sched.run()
    sync()
    wall = time.perf_counter() - t0
    log("launches", path=path, **ops.launch_counts())
    total = sum(len(r.output) for r in done)
    assert len(done) == requests and all(
        r.done and 1 <= len(r.output) <= max_new for r in done)
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.output)
    # ms per serve_step at B = max_batch, from a prefilled wave; whisper's
    # encoder runs once, in init_decode_state
    extra = {}
    if frames is not None:
        sync()
        t0 = time.perf_counter()
        init_decode_state(params, cfg, max_batch, MAX_LEN,
                          encoder_frames=frames)
        sync()
        extra["init_decode_state_encoder_ms"] = (
            time.perf_counter() - t0) * 1e3
    prompts = torch.stack([torch.tensor(r.prompt[:3], device=dev)
                           for r in reqs[:max_batch]])
    logits, state = prefill(params, cfg, prompts, MAX_LEN,
                            encoder_frames=frames)
    if frames is not None:
        got = sum(t.numel() * t.element_size()
                  for kv in state.cross for t in kv)
        want = (cfg.num_layers * 2 * max_batch * cfg.num_kv_heads
                * cfg.encoder_seq * cfg.head_dim * logits.element_size())
        extra.update(cross_cache_bytes=got, analytic_cross_cache_bytes=want,
                     cross_bytes_equal=got == want)
        assert got == want, extra
    cur = torch.argmax(logits, -1).to(torch.int32)
    steps = 8
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        cur, state = serve_step(params, state, cur, cfg,
                                key=prng.fold_in(prng.PRNGKey(0, dev), i))
    sync()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    log(f"{tag} lm_serve", requests=requests, max_batch=max_batch,
        max_len=MAX_LEN, tokens=total, wall_s=wall,
        tokens_per_s=total / wall, serve_step_ms=step_ms, batch=max_batch,
        **extra, outputs=json.dumps([r.output for r in done]))
    # the serving invariant at full width, float32: the decode logits and
    # each attention output against the forward's, then the same with each
    # planted decode fault to show which of the two gates sees it
    f32 = dataclasses.replace(cfg, dtype="float32")
    if cfg.family == "moe":
        f32 = dataclasses.replace(f32, moe_capacity_factor=(
            cfg.num_experts / cfg.num_experts_per_tok))
    toks = prng.randint(prng.PRNGKey(2, dev), (1, invariant_seq), 0,
                        cfg.vocab_size)
    fr1 = frames_of(cfg, 1, dev)
    batch = {"tokens": toks}
    if fr1 is not None:
        batch["encoder_frames"] = fr1
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.zeros(1, 0, cfg.d_model, device=dev)
    with lm_taps() as (want_attn, _), torch.inference_mode():
        want, _ = forward_train(params, batch, f32)
    lim = ATTN_REL["float32"]
    for what, target, fault in decode_faults(cfg):
        with contextlib.ExitStack() as stack:
            attn, _ = stack.enter_context(lm_taps())
            if fault is not None:
                stack.enter_context(patched(*target, fault))
            st = init_decode_state(params, f32, 1, invariant_seq,
                                   encoder_frames=fr1)
            del attn[:]                    # the encoder's, in the state
            rel = 0.0
            for t in range(invariant_seq):
                got, st = decode_step(params, st, toks[:, t], f32)
                w = want[:, t]
                rel = max(rel, float((got - w).norm() / w.norm()))
        # attention outputs a step: one a layer (self, and whisper's
        # cross), a shared-block site (zamba2), or none (rwkv6); the
        # forward's last ones (whisper's encoder runs first)
        n_attn = len(attn) // invariant_seq
        per_layer = [torch.cat(attn[i::n_attn], dim=1)
                     for i in range(n_attn)]
        att = (max_layer_rel(per_layer, want_attn[len(want_attn) - n_attn:])
               if n_attn else (0.0, 0.0))
        sites = {}
        if st.shared is not None:
            # each site's attention wrote its own cache
            sites = dict(sites=len(st.shared), distinct_site_caches=len(
                {c["k"].data_ptr() for c in st.shared}) == len(st.shared)
                and all(not torch.equal(a["k"], b["k"])
                        for a, b in zip(st.shared, st.shared[1:])))
        log(f"{tag} lm_serve_invariant", run=what, dtype="float32",
            seq=invariant_seq, max_rel_err=rel, limit=1e-3,
            logits_ok=rel <= 1e-3, attn_outputs_a_step=n_attn,
            attn_max_rel_frobenius=att[0],
            attn_max_rel_frobenius_last_eighth=att[1], attn_limit=lim,
            attn_ok=max(att) <= lim if n_attn else "no attention", **sites)
        if fault is None:
            assert rel <= 1e-3, "decode logits stray from the forward's"
            assert max(att) <= lim, \
                "decode attention outputs stray from the forward's"
            assert sites.get("distinct_site_caches", True), sites
        elif what in ("fault", "cross_fault"):
            assert max(att) > lim, "the attention gate misses a planted fault"
        else:
            assert rel > 1e-3, "the logits gate misses a dropped state"
    return state, cur


def phase_lm_cpu(cfg, dev, requests=LM_SERVE["requests"],
                 max_new=LM_SERVE["max_new"],
                 max_batch=LM_SERVE["max_batch"], tag="16"):
    """The reduced config's scheduler run on the card and on the CPU, one
    set of weights: equal tokens (a differing token fails unless the CPU's
    top-2 logit margin at that step is below 1e-4, printed), and each
    decode step's logits and attention outputs within ``ATTN_REL``, which
    a planted decode fault on the card must fail. whisper's waves get
    :func:`frames_of`'s frames, made on the CPU, through
    :func:`scheduler_frames`. ``tag`` labels its lines."""
    import copy
    import torch
    from repro_torch.launch.serve import MAX_LEN, make_requests
    from repro_torch.models import init_params
    from repro_torch.serving import BatchScheduler, prefill
    cpu_params = init_params(cfg, 0, device="cpu")
    frames = frames_of(cfg, max_batch, "cpu")
    runs, steps = {}, {}
    # the attention fault where the model attends, else a dropped state
    _, target, planted = decode_faults(cfg)[1]
    for where, params, fault in (
            ("cuda", copy.deepcopy(cpu_params).to(dev), None),
            ("cpu", cpu_params, None),
            ("cuda_fault", copy.deepcopy(cpu_params).to(dev), planted)):
        sched = BatchScheduler(params, cfg, max_batch=max_batch,
                               max_len=MAX_LEN)
        for r in make_requests(cfg, requests, 0, max_new):
            sched.submit(r)
        with contextlib.ExitStack() as stack:
            _, steps[where] = stack.enter_context(lm_taps())
            stack.enter_context(scheduler_frames(frames))
            if fault is not None:
                stack.enter_context(patched(*target, fault))
            t0 = time.perf_counter()
            runs[where] = sched.run()
            sync()
        log(f"{tag} lm_cpu_run", device=where,
            seconds=time.perf_counter() - t0,
            decode_steps=len(steps[where]))
    # the decode steps' logits and attention outputs, card against CPU,
    # while both fed the same tokens
    lim = ATTN_REL["float32"]
    for what in ("cuda", "cuda_fault"):
        n = 0
        lg = att = 0.0
        for (ta, la, aa), (tb, lb, ab) in zip(steps[what], steps["cpu"]):
            if not torch.equal(ta.cpu(), tb):
                break
            n += 1
            lg = max(lg, float((la.cpu() - lb).norm() / lb.norm()))
            att = max(att, max((float((x.cpu() - y).norm() / y.norm())
                                for x, y in zip(aa, ab, strict=True)),
                               default=0.0))
        log(f"{tag} lm_cpu_steps", run=what, steps_compared=n,
            steps=len(steps["cpu"]), logits_max_rel_err=lg,
            attn_max_rel_err=att, limit=lim, logits_ok=lg <= lim,
            attn_ok=att <= lim)
        assert n >= 1, "no decode step fed the same tokens on both devices"
        if what == "cuda":
            assert lg <= lim and att <= lim, \
                "the card's decode steps stray from the CPU's"
        elif planted is decode_newest_key_dropped:
            assert att > lim, "the attention gate misses a planted fault"
        else:
            assert lg > lim, "the logits gate misses a dropped state"
    log(f"{tag} lm_cpu_fault_tokens", equal_cpu=all(
        a.output == b.output for a, b in zip(runs["cuda_fault"],
                                             runs["cpu"])))
    differ, near_ties = 0, []
    for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        if a.output == b.output:
            continue
        j = next(j for j, (x, y) in enumerate(zip(a.output, b.output))
                 if x != y)
        wave = runs["cpu"][i - i % max_batch: i - i % max_batch + max_batch]
        width = max(len(r.prompt) for r in wave)
        seq = [1] * (width - len(b.prompt)) + b.prompt + b.output[:j]
        row = None if frames is None else frames[i % max_batch][None]
        logits, _ = prefill(cpu_params, cfg, torch.tensor([seq]), MAX_LEN,
                            encoder_frames=row)
        top = torch.topk(logits[0].float(), 2).values
        margin = float(top[0] - top[1])
        log(f"{tag} lm_cpu_differ", rid=b.rid, step=j, cuda=a.output[j],
            cpu=b.output[j], cpu_top2_margin=margin)
        differ += 1
        near_ties.append(margin < 1e-4)
    log(f"{tag} lm_cpu", arch=cfg.name, requests=requests,
        tokens=sum(len(r.output) for r in runs["cpu"]),
        requests_differing=differ, equal=differ == 0)
    assert all(near_ties), "the card's tokens differ from the CPU's"


def live_pairs(sq, skv, causal, window, q_offset) -> int:
    """The (query, key) pairs attention computes: keys below ``skv``, at
    or before the query under ``causal``, within ``window`` of it."""
    import numpy as np
    qpos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, skv) if causal else np.full(sq, skv)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.clip(hi - lo, 0, None).sum())


def sdpa_call(q, k, v, causal, window, cap, q_offset):
    """One ``scaled_dot_product_attention`` call that computes what the
    kernel computes on these inputs (a boolean mask for a window or a
    query offset), or None: SDPA has no soft cap. Timed as the yardstick;
    the port never calls it."""
    import torch
    import torch.nn.functional as F
    if cap is not None:
        return None
    sq, skv = q.shape[2], k.shape[2]
    if window is None and (not causal or (q_offset == 0 and sq == skv)):
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def kernel_design(fn) -> str:
    """Which ``flash_attention`` kernel one ``fn()`` ran, read from the
    profiler's kernel names: ``wgmma`` (the bf16 tensor-core kernel),
    ``simt`` (the float32 kernel), or ``not measured`` where the trace
    holds neither."""
    by_name = device_busy_ms(fn, by_kernel=True)[3]
    if "fa_wgmma_kernel" in by_name:
        return "wgmma"
    return "simt" if "flash_attention_kernel" in by_name else "not measured"


def flash_attention_row(launches, cfg, dev, batch=LM_PREFILL["batch"],
                        seq=LM_PREFILL["seq"], checks=True, tag="12"):
    """``flash_attention`` at the slice's shape (``cfg``'s heads at S =
    32,768, bf16, random q, k and v): the kernel's ms, its bound, SDPA's ms
    and the plain chunked version's answer (max abs error ≤ 2e-2, relative
    Frobenius error over all rows and over the last eighth within
    ``ATTN_REL``, a gate two planted faults must fail); then the kernel
    against ``attention_ref`` at S = 4,096 on the three ``FA_CHECKS``
    shapes, whose first gives the plain ms, each timed beside SDPA where
    one SDPA call computes the same function. SDPA's own reading at 32k
    under the same gate is logged as information. The bf16 calls must run
    the tensor-core kernel, the float32 call the SIMT one. ``checks=False``
    leaves the three check shapes out, and the plain ms is then the
    chunked version's at 32k; ``tag`` labels the lines."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    B, S = batch, seq
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((B, h, S, D), generator=gen, device=dev,
                           dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv))
    kern = lambda: ops.attention(q, k, v, impl="cuda")      # noqa: E731
    out = kern()
    plain32k = kref.attention_chunked(q, k, v)
    err32k = float((out.float() - plain32k.float()).abs().max())
    lim = ATTN_REL["bfloat16"]
    rel32k = rel_rows(out, plain32k, dim=2)
    log(f"{tag} flash_attention_32k", max_abs_err=err32k, tolerance=2e-2,
        rel_frobenius=rel32k[0], rel_frobenius_last_eighth=rel32k[1],
        limit=lim, ok=err32k <= 2e-2 and max(rel32k) <= lim)
    assert err32k <= 2e-2 and max(rel32k) <= lim, \
        f"flash_attention strays at 32k: {err32k}, {rel32k}"
    # controls: the same gate must fail a kernel that drops half of a late
    # row's keys, or each row's newest 64 keys
    for what, fault in (("late_keys_dropped", late_keys_dropped),
                        ("newest_64_keys_dropped", newest_keys_dropped)):
        bad = fault(lambda *a, **kw: ops.attention(*a, impl="cuda", **kw))(
            q, k, v, causal=True)
        ctl = rel_rows(bad, plain32k, dim=2)
        ctl_abs = float((bad.float() - plain32k.float()).abs().max())
        del bad
        log(f"{tag} flash_attention_32k_control", fault=what,
            max_abs_err=ctl_abs, rel_frobenius=ctl[0],
            rel_frobenius_last_eighth=ctl[1], limit=lim,
            caught=max(ctl) > lim, caught_by_max_abs=ctl_abs > 2e-2)
        assert max(ctl) > lim, f"the 32k gate misses a planted fault ({what})"
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        sdpa_rel = rel_rows(sdpa(), plain32k, dim=2)
    log(f"{tag} flash_attention_32k_sdpa", rel_frobenius=sdpa_rel[0],
        rel_frobenius_last_eighth=sdpa_rel[1], limit=lim,
        within=max(sdpa_rel) <= lim,
        note="information: SDPA (FlashAttention-2 backend) under the same "
        "gate; the port never calls it")
    del plain32k
    ms, reps = time_ms_auto(kern)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        lib_ms, lib_reps = time_ms_auto(sdpa)
    design = kernel_design(kern)
    assert design in ("wgmma", "not measured"), design
    pairs = S * (S + 1) // 2
    flops = 4 * B * Hq * pairs * D
    nbytes = 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
    bound = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    errs, plain_ms, plain_reps = [], None, None
    if not checks:
        # the plain version takes 0.4-0.9 s at 32k: one call, warm
        plain_ms, plain_reps = time_ms(lambda: kref.attention_chunked(
            q, k, v), reps=1, warmups=1), 1
    for what, (b, hq, hkv, sq, skv, d, window, causal, cap, qo, dt,
               tol) in (FA_CHECKS.items() if checks else ()):
        dtype = getattr(torch, dt)
        qq, kk, vv = (torch.randn((b, h, n, d), generator=gen, device=dev,
                                  dtype=dtype)
                      for h, n in ((hq, sq), (hkv, skv), (hkv, skv)))
        kw = dict(causal=causal, window=window, q_offset=qo)
        got = ops.attention(qq, kk, vv, soft_cap=cap, impl="cuda", **kw)
        want = kref.attention_ref(qq, kk, vv, logit_soft_cap=cap, **kw)
        err = float((got.float() - want.float()).abs().max())
        rel = rel_rows(got, want, dim=2)
        ok = err <= tol and max(rel) <= ATTN_REL[dt]
        del want
        call = lambda: ops.attention(qq, kk, vv, soft_cap=cap,  # noqa: E731
                                     impl="cuda", **kw)
        c_ms, c_reps = time_ms_auto(call)
        lib = sdpa_call(qq, kk, vv, causal, window, cap, qo)
        c_design = kernel_design(call)
        assert c_design in ("wgmma" if dt == "bfloat16" else "simt",
                            "not measured"), (what, c_design)
        c_flop = 4 * b * hq * live_pairs(sq, skv, causal, window, qo) * d
        log(f"{tag} flash_attention_check", shape=what, dtype=dt, Sq=sq,
            Skv=skv, D=d, window=window, causal=causal, soft_cap=cap,
            q_offset=qo, max_abs_err=err, tolerance=tol,
            rel_frobenius=rel[0], rel_frobenius_last_eighth=rel[1],
            rel_limit=ATTN_REL[dt], ok=ok, design=c_design, ms=c_ms,
            reps=c_reps, tflop_per_s=c_flop / c_ms / 1e9,
            sdpa_ms=time_ms_auto(lib)[0] if lib else
            "none (SDPA has no soft cap)")
        assert ok, f"flash_attention strays from attention_ref ({what})"
        errs.append(err)
        if plain_ms is None:
            plain_ms, plain_reps = time_ms_auto(
                lambda: kref.attention_ref(qq, kk, vv, **kw))
    r = dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:110",
             launches=launches, max_abs_err=max([err32k] + errs), ms=ms,
             plain_ms=plain_ms, bound_ms=bound, bound_by="operations",
             library_ms=lib_ms)
    log(f"{tag} kernel", **{k: v for k, v in r.items()
                        if k not in ("source", "replaces", "route")},
        design=design, tflop_per_s=flops / ms / 1e9,
        reps=reps, library_reps=lib_reps, plain_reps=plain_reps,
        max_abs_err_32k_vs_chunked=err32k,
        plain="attention_ref at S=4096 (llama heads); at 32k it would "
        "hold 137 GB of logits" if checks else
        "attention_chunked at the row's shape",
        library="SDPA flash backend, enable_gqa", flop=flops, bytes=nbytes,
        shape=f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D}")
    return r


def phase_lm_profile(params, cfg, inputs, state, cur, tag="13", stages=()):
    """Where one 32k prefill forward (on the batch ``inputs``) and one
    ``serve_step`` at B = 4 spend their time: wall, device-busy and idle
    share, the port's kernels, ``flash_attention``'s share, the five
    costliest kernels, and the device ms split by :func:`stage_ms` into
    attention, ``stages`` (the models' ``record_function`` ranges) and the
    rest."""
    import torch
    from repro_torch.models import forward_train
    from repro_torch.serving import serve_step

    def prefill_fwd():
        with torch.inference_mode():
            forward_train(params, inputs, cfg)

    for what, fn in (("lm_prefill_32k", prefill_fwd),
                     ("lm_serve_step", lambda: serve_step(params, state, cur,
                                                          cfg))):
        wall, busy, kernels, by_name, top, split = device_busy_ms(
            fn, stages=stages)
        attn_ms = sum(by_name.get(k, (0, 0.0))[1]
                      for k in ("fa_wgmma_kernel", "flash_attention_kernel"))
        log(f"{tag} profile", what=what, wall_ms=wall,
            device_busy_ms=busy if kernels else "not measured",
            idle_share=1 - busy / wall if kernels else "not measured",
            kernels=kernels, port_kernels_launches_ms=json.dumps(by_name),
            flash_attention_share=attn_ms / busy if kernels else
            "not measured",
            stages_ms=json.dumps(split) if kernels else "not measured",
            top5_name_launches_ms=json.dumps(top))


# ---------------------------------------------------------------------------
# phase 20: the MoE family (olmoe-1b-7b at full width, phi3.5-moe cut)
# ---------------------------------------------------------------------------

def free_device_memory() -> dict:
    """Collect what nothing references and return the allocator's cache
    to the card: its bytes allocated, reserved and at peak so far."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(allocated_bytes=torch.cuda.memory_allocated(),
                reserved_bytes=torch.cuda.memory_reserved(),
                peak_mem_bytes_so_far=torch.cuda.max_memory_allocated())


def first_picks_swapped(orig):
    """Planted fault in the router: each token's first two top-k weights
    trade places (its experts keep their order)."""
    def fn(*a, **kw):
        probs, top_p, top_e = orig(*a, **kw)
        perm = [1, 0] + list(range(2, top_p.shape[-1]))
        return probs, top_p[..., perm], top_e
    return fn


def kept_pairs(top_e, num_experts: int, cap: int):
    """``bool[G, S, k]``: which (token, pick) pairs of the groups
    ``top_e [G, S, k]`` keep a slot, by a plain count: a pair's rank is
    the number of pairs of its group before it (token-major) on the same
    expert, and a rank of ``cap`` or more drops."""
    import torch
    G, S, k = top_e.shape
    flat = top_e.reshape(G, S * k)
    seen = torch.nn.functional.one_hot(flat, num_experts).cumsum(1)
    rank = seen.gather(2, flat[..., None])[..., 0] - 1
    return (rank < cap).view(G, S, k)


def phase_moe_layer(params, cfg, toks, seq=MOE_LAYER_GATE["seq"],
                    tokens=MOE_LAYER_GATE["tokens"],
                    tight=MOE_LAYER_GATE["tight_factor"]):
    """The 32k prefill's dispatch: each layer's dropped (token, pick)
    pairs, from a tap on ``moe_forward``; then layer 0 in float32 on the
    first ``seq`` tokens of its prefill input (one routing group), at the
    config's capacity factor and at ``tight``, where pairs drop:
    ``dropped`` against :func:`kept_pairs`' plain count, and the output on
    the first ``tokens`` tokens that kept every pick against
    ``moe_mixture_ref`` (relative Frobenius ≤ 1e-4), a gate a planted
    router fault (:func:`first_picks_swapped`) must fail."""
    import dataclasses
    import torch
    from repro_torch.models import forward_train, moe, transformer
    dropped, inputs = [], []

    def tap(orig):
        def fn(p, x, c, *a, **kw):
            y, aux = orig(p, x, c, *a, **kw)
            if not inputs:
                inputs.append(x)
            dropped.append(aux["dropped"])
            return y, aux
        return fn

    with patched(transformer, "moe_forward", tap), torch.inference_mode():
        forward_train(params, {"tokens": toks}, cfg)
    per_layer = [int(d) for d in dropped]
    pairs = toks.numel() * cfg.num_experts_per_tok
    group = moe.group_size(toks.shape[1])
    log("20 moe_dropped", pairs_per_layer=pairs, group=group,
        capacity=moe.capacity(cfg, group),
        per_layer=json.dumps(per_layer),
        max_share=max(per_layer) / pairs,
        mean_share=sum(per_layer) / len(per_layer) / pairs)
    assert len(per_layer) == cfg.num_layers, per_layer
    f32 = dataclasses.replace(cfg, dtype="float32")
    layer = params.blocks[0].moe
    x = inputs[0][:, :seq].float()
    del inputs
    assert moe.group_size(seq) == seq
    runs = {}
    with torch.inference_mode():
        _, _, top_e = moe.route(layer, x, f32)
        for what, factor, fault in (
                ("sound", cfg.moe_capacity_factor, None),
                ("sound_tight", tight, None),
                ("fault", cfg.moe_capacity_factor, first_picks_swapped)):
            c = dataclasses.replace(f32, moe_capacity_factor=factor)
            cap = moe.capacity(c, seq)
            kept = kept_pairs(top_e, cfg.num_experts, cap)
            idx = kept.all(-1)[0].nonzero()[:, 0][:tokens]
            want = moe.moe_mixture_ref(layer, x[:, idx], c)
            with contextlib.ExitStack() as stack:
                if fault is not None:
                    stack.enter_context(patched(moe, "route", fault))
                y, aux = moe.moe_forward(layer, x, c)
            runs[what] = r = dict(
                capacity_factor=factor, capacity=cap,
                dropped=int(aux["dropped"]),
                plain_dropped=int((~kept).sum()), tokens_compared=len(idx),
                rel_frobenius=rel_frobenius(y[:, idx], want))
            log("20 moe_layer_gate", run=what, dtype="float32", seq=seq,
                **r, limit=1e-4, ok=r["rel_frobenius"] <= 1e-4
                and r["dropped"] == r["plain_dropped"])
    for what in ("sound", "sound_tight"):
        r = runs[what]
        assert r["tokens_compared"] >= 64, (what, r)
        assert r["dropped"] == r["plain_dropped"], (what, r)
        assert r["rel_frobenius"] <= 1e-4, \
            f"moe_forward strays from the mixture ({what})"
    assert runs["sound_tight"]["dropped"] > 0, runs
    assert runs["fault"]["rel_frobenius"] > 1e-4, \
        "the MoE gate misses a planted fault"
    return per_layer


def phase_moe(dev):
    """Phase 20: olmoe-1b-7b at full width and depth (the 32k prefill and
    its gates, each layer's dropped pairs and the float32 layer gate, the
    launcher's 6 requests, ``flash_attention`` at its shape, a trace of the
    prefill and a ``serve_step``), the reduced olmoe's tokens on the card
    against the CPU's, and phi3.5-moe at full width cut to 2 layers (one
    forward at S = 4,096 against the plain attention path). Returns the
    peak device memory."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config, reduced_config
    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    log("20 moe_config", arch=cfg.name, param_count=cfg.param_count,
        active_param_count=cfg.active_param_count,
        experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
        capacity_factor=cfg.moe_capacity_factor)
    params, inputs, fa_launches, _, _ = phase_lm_prefill(
        cfg, dev, tag="20", path="moe_prefill")
    assert fa_launches == cfg.num_layers == 16, fa_launches
    toks = inputs["tokens"]
    phase_moe_layer(params, cfg, toks)
    state, cur = phase_lm_serve(params, cfg, dev, tag="20",
                                path="moe_serve")
    flash_attention_row(fa_launches, cfg, dev, checks=False, tag="20")
    phase_lm_profile(params, cfg, inputs, state, cur, tag="20",
                     stages=MOE_STAGES)
    peak = torch.cuda.max_memory_allocated()
    del params, toks, inputs, state, cur
    log("20 olmoe_done", seconds=time.perf_counter() - t0,
        peak_mem_bytes=peak, **free_device_memory())
    phase_lm_cpu(reduced_config(cfg), dev, tag="20")
    phi = dataclasses.replace(get_config(MOE_PHI["arch"]),
                              num_layers=MOE_PHI["layers"])
    params, _, launches, _, _ = phase_lm_prefill(
        phi, dev, seq=MOE_PHI["seq"], gate2_seq=MOE_PHI["seq"],
        tag="20 phi", path="moe_phi_prefill")
    assert launches == MOE_PHI["layers"], launches
    del params
    peak = max(peak, torch.cuda.max_memory_allocated())
    log("20 done", seconds=time.perf_counter() - t0, peak_mem_bytes=peak,
        **free_device_memory())
    return peak


# ---------------------------------------------------------------------------
# phase 21: the recurrent families (rwkv6-3b, zamba2-1.2b at full width)
# ---------------------------------------------------------------------------

def scan_args(kernel: str, args, seq=None, dtype=None) -> list:
    """A recorded scan call's operands, the sequence ones cut to ``seq``
    steps and the floating ones cast to ``dtype`` (each as it is when
    None); the starting state stays as recorded."""
    out = []
    for i, t in enumerate(args):
        if t is not None and i < 5:
            if seq is not None and t.dim() >= 3:
                t = t[:, :seq]
            if dtype is not None:
                t = t.to(dtype)
            t = t.contiguous()
        out.append(t)
    return out


def scan_work(kernel: str, args) -> tuple:
    """``(bytes, serial operations, chunked operations)`` one scan call
    needs: each operand read once, the output and the final state written
    once. The serial form's float32 operations: a state element costs a
    multiply and two FMAs a step (5 operations), plus the per-step row
    terms (wkv6: the bonus sum and the readout, 5D a head; ssd: Δ·x a row
    and the readout's sum, D a head). The chunked form's (ssd only, None
    for wkv6, which runs the serial form): its products over chunks of L
    steps, on the tensor cores, the causal triangles counted once — C·Bᵀ
    once a batch row (no head axis), L(L + 1)/2 · 2n a chunk; a head's
    M·x, L(L + 1)/2 · 2D; C·hᵀ and the state update's xᵀ·B, 2LnD each:
    (L + 1)·n + H·D·(L + 1 + 4n) a step."""
    def nb(t):
        return 0 if t is None else t.numel() * t.element_size()

    if kernel == "wkv6_scan":
        r, k, v, w, u, S0 = args
        B, S, H, D = r.shape
        out = r.numel() * r.element_size() + B * H * D * D * 4
        return (sum(nb(t) for t in args) + out,
                B * S * H * (5 * D * D + 5 * D), None)
    x, Bv, Cv, dt, a, h0 = args
    B, S, H, D = x.shape
    n = Bv.shape[-1]
    out = x.numel() * 4 + B * H * D * n * 4
    L = SSD_CHUNK
    return (sum(nb(t) for t in args) + out, B * S * H * D * (5 * n + 1),
            B * S * ((L + 1) * n + H * D * (L + 1 + 4 * n)))


def scan_gates(kernel: str, args, tag: str) -> float:
    """Kernel against plain version on layer 0's real inputs: first the
    call as the main path makes it (the recorded operands, bf16 at the
    prefill's full shape), then in float32 S = ``RECURRENT["gate_seq"]``
    from a zero state, the next step (S = 1) from that run's state, and
    B = 4 (the run's four quarters as rows) from it. Final states within
    1e-5 relative Frobenius error; outputs within 1e-5, or 4e-3 where
    they are written in bf16 (both sides round the same float32 values,
    in a different order of sums). Returns the largest max abs output
    error."""
    import torch
    from repro_torch.kernels import ops
    fn = getattr(ops, kernel)
    runs = [("path", *fn(*args, impl="cuda"), *fn(*args, impl="torch"))]
    n = RECURRENT["gate_seq"]
    f32 = scan_args(kernel, args, seq=n + 1, dtype=torch.float32)
    head = scan_args(kernel, f32, seq=n)
    o, st = fn(*head, impl="cuda")
    want_o, want_st = fn(*head, impl="torch")
    runs.append(("S4096", o, st, want_o, want_st))
    step = [t[:, n:n + 1] if t is not None and i < 5 and t.dim() >= 3
            else t for i, t in enumerate(f32)]
    step[5] = want_st
    runs.append(("S1", *fn(*step, impl="cuda"), *fn(*step, impl="torch")))
    w = n // 4
    batch = [torch.cat([t[:, j * w:(j + 1) * w] for j in range(4)])
             if t is not None and i < 5 and t.dim() >= 3 else t
             for i, t in enumerate(head)]
    batch[5] = want_st.expand(4, *want_st.shape[1:]).contiguous()
    runs.append(("B4", *fn(*batch, impl="cuda"), *fn(*batch, impl="torch")))
    worst = 0.0
    for what, o, st, want_o, want_st in runs:
        rel_o, rel_s = rel_frobenius(o, want_o), rel_frobenius(st, want_st)
        err = float((o.float() - want_o.float()).abs().max())
        worst = max(worst, err)
        limit = 4e-3 if o.dtype == torch.bfloat16 else 1e-5
        ok = rel_o <= limit and rel_s <= 1e-5
        log(f"{tag} scan_gate", kernel=kernel, run=what,
            dtype=str(args[0].dtype if what == "path" else torch.float32),
            out_dtype=str(o.dtype), shape=list(o.shape),
            rel_frobenius_out=rel_o, rel_frobenius_state=rel_s,
            max_abs_err=err, limit_out=limit, limit_state=1e-5, ok=ok)
        assert ok, f"{kernel} strays ({what})"
    return worst


def scan_row(kernel: str, args, launches: int, err: float, tag: str
             ) -> dict:
    """The scan's ``kernels`` row: its event-timed ms on one layer at the
    prefill's shape (layer 0's inputs as the path gives them), the bound
    from :func:`scan_work` (the bytes against the form the kernel runs:
    wkv6's serial operations at the float32 rate, ssd's chunked products
    at the TF32 tensor-core rate; the log line also gives the serial
    form's operations at the float32 rate, ``serial_ops_ms``, for both),
    and the plain version's ms at S = 4,096 (the 32k loop would be 32,768
    Python steps); no PyTorch call computes the recurrence."""
    from repro_torch.kernels import ops
    fn = getattr(ops, kernel)
    ms, reps = time_ms_auto(lambda: fn(*args, impl="cuda"))
    short = scan_args(kernel, args, seq=RECURRENT["gate_seq"])
    ms_short, _ = time_ms_auto(lambda: fn(*short, impl="cuda"))
    plain_ms = time_ms(lambda: fn(*short, impl="torch"), reps=1)
    nbytes, serial, chunked = scan_work(kernel, args)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_serial = serial / FP32_FLOP_PER_S * 1e3
    t_ops = (t_serial if chunked is None
             else chunked / TF32_FLOP_PER_S * 1e3)
    r = dict(name=kernel, route="cuda",
             source=f"src/repro_torch/kernels/csrc/{SCAN_SOURCE[kernel]}",
             replaces=SCAN_REPLACES[kernel], launches=launches,
             max_abs_err=err, ms=ms, plain_ms=plain_ms,
             bound_ms=max(t_bytes, t_ops),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             library_ms=None)
    log(f"{tag} kernel", **{k: v for k, v in r.items()
                           if k not in ("source", "replaces", "route")},
        serial_ops_ms=t_serial, reps=reps, bytes=nbytes,
        flop=chunked or serial, serial_flop=serial,
        bytes_ms=t_bytes, operations_ms=t_ops, shape=list(args[0].shape),
        dtype=str(args[0].dtype), ms_at_4096=ms_short,
        plain=f"the per-step loop at S={RECURRENT['gate_seq']}, "
        f"{args[0].dtype}", library="none (no PyTorch call computes "
        "the recurrence)")
    return r


def phase_recurrent_arch(arch: str, dev) -> dict:
    """One recurrent architecture at full width and depth: the 32k
    prefill (first call and warm, the scan launched once a layer,
    ``flash_attention`` once a shared-block site), the scan gates on layer
    0's inputs, the bf16 forward against the plain path at S = 1,024, the
    state carried over two halves of 2,048 tokens, the launcher's
    requests and the serving invariant, the reduced model on the card
    against the CPU, ``long_500k``'s state bytes and step time, zamba2's
    ``flash_attention`` shape, and traces. Returns the scan's row."""
    import dataclasses
    import torch
    from repro_torch import prng
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.kernels import ops
    from repro_torch.models import (forward_train, init_decode_state,
                                    transformer)
    from repro_torch.serving import serve_step
    t0 = time.perf_counter()
    cfg = get_config(arch)
    kernel = SCAN_KERNEL[cfg.family]
    sites = (cfg.num_layers // cfg.shared_attn_every
             if cfg.family == "hybrid" else 0)
    params = lm_model(cfg, dev)
    sync()
    log("21 config", arch=arch, family=cfg.family, layers=cfg.num_layers,
        d_model=cfg.d_model, param_count=cfg.param_count,
        tree_params=sum(p.numel() for p in params.parameters()),
        shared_attn_sites=sites, init_s=time.perf_counter() - t0)
    B, S = LM_PREFILL["batch"], LM_PREFILL["seq"]
    toks = prng.randint(prng.PRNGKey(1, dev), (B, S), 0, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sync()
    t1 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = forward_train(params, {"tokens": toks}, cfg)
    sync()
    wall = time.perf_counter() - t1
    launches = ops.launch_counts()
    log("launches", path=f"{arch}_prefill", **launches)
    assert launches[kernel] == cfg.num_layers, launches
    assert launches["flash_attention"] == sites, launches
    assert logits.shape == (B, S, cfg.vocab_size), logits.shape
    finite = all(bool(torch.isfinite(logits[:, s0:s0 + 4096]).all())
                 for s0 in range(0, S, 4096))
    del logits
    # again, warm; then once more with layer 0's inputs recorded
    sync()
    t1 = time.perf_counter()
    with torch.inference_mode():
        forward_train(params, {"tokens": toks}, cfg)
    sync()
    warm = time.perf_counter() - t1
    log("21 prefill", arch=arch, batch=B, seq=S, wall_s=wall,
        tokens_per_s=B * S / wall, warm_wall_s=warm,
        warm_tokens_per_s=B * S / warm,
        peak_mem_bytes=torch.cuda.max_memory_allocated(), finite=finite)
    assert finite, "non-finite prefill logits"
    layer_fn = {"ssm": "rwkv_time_mix", "hybrid": "mamba2_forward"}[
        cfg.family]
    seen = {}

    def first_call(key):
        def tap(orig):
            def fn(*a, **kw):
                seen.setdefault(key, a)
                return orig(*a, **kw)
            return fn
        return tap

    with patched(ops, kernel, first_call("scan")), \
            patched(transformer, layer_fn, first_call("layer")), \
            torch.inference_mode():
        forward_train(params, {"tokens": toks}, cfg)
    scan_in, layer_in = list(seen["scan"]), seen["layer"][1]
    with torch.inference_mode():
        err = scan_gates(kernel, scan_in, "21")
        # the bf16 forward against the plain path (scans and attention)
        short = {"tokens": toks[:, :RECURRENT["plain_seq"]]}
        plain = dataclasses.replace(cfg, attn_impl="torch")
        got, _ = forward_train(params, short, cfg)
        sync()
        t1 = time.perf_counter()
        with patched(ops, kernel, lambda orig: functools.partial(
                orig, impl="torch")):
            want, _ = forward_train(params, short, plain)
        sync()
        rel = rel_frobenius(got, want)
        log("21 prefill_gate", arch=arch, dtype=cfg.dtype,
            seq=RECURRENT["plain_seq"], plain_wall_s=time.perf_counter() - t1,
            rel_frobenius=rel, limit=5e-2, ok=rel <= 5e-2)
        assert rel <= 5e-2, "bf16 logits stray from the plain path"
        del got, want
        recurrent_carry(params, cfg, layer_fn, layer_in)
    state, cur = phase_lm_serve(params, cfg, dev, tag="21",
                                path=f"{arch}_serve")
    # long_500k: the decode state at 524,288 positions, and one step
    st = init_decode_state(params, cfg, 1, RECURRENT["long_len"])
    got_bytes = [sum(t.numel() * t.element_size() for t in c.values())
                 for c in st.layers]
    got_shared = sum(t.numel() * t.element_size()
                     for c in (st.shared or ()) for t in c.values())
    want_layers, want_shared = long_state_bytes(cfg)
    cur1 = cur[:1]
    step_ms = []
    for i in range(3):
        sync()
        t1 = time.perf_counter()
        cur1, st = serve_step(params, st, cur1, cfg)
        sync()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    log("21 long_500k", arch=arch, max_len=RECURRENT["long_len"],
        state_bytes=sum(got_bytes), analytic_state_bytes=want_layers,
        shared_kv_bytes=got_shared, analytic_shared_kv_bytes=want_shared,
        equal=sum(got_bytes) == want_layers and got_shared == want_shared,
        serve_step_ms=json.dumps(step_ms),
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    assert sum(got_bytes) == want_layers and got_shared == want_shared
    del st, cur1
    if sites:
        flash_attention_row(sites, cfg, dev, checks=False, tag="21")
    phase_lm_profile(params, cfg, {"tokens": toks}, state, cur, tag="21",
                     stages=RECURRENT_STAGES[cfg.family])
    # the recorded operands include parameters (rwkv's u, zamba2's a),
    # and the scans refuse autograd on the card: time them without it,
    # as the prefill runs them
    with torch.inference_mode():
        row = scan_row(kernel, scan_in, launches[kernel], err, "21")
    peak = torch.cuda.max_memory_allocated()
    del params, toks, state, cur, scan_in, layer_in, seen
    log("21 arch_done", arch=arch, seconds=time.perf_counter() - t0,
        peak_mem_bytes=peak, **free_device_memory())
    phase_lm_cpu(reduced_config(cfg), dev, tag="21")
    return row


def long_state_bytes(cfg) -> tuple:
    """(the recurrent state's bytes, the shared KV caches') at
    ``long_500k``: rwkv6 a layer two compute-dtype token-shift rows and a
    float32 ``[H, D, D]`` state; zamba2 a layer a ``[W − 1, 2d]`` conv
    buffer and a float32 ``[H, D, n]`` state, and a ``[2, Hkv, len, hd]``
    cache a site."""
    el = 2 if cfg.dtype == "bfloat16" else 4
    d, L = cfg.d_model, cfg.num_layers
    if cfg.family == "ssm":
        H, D = cfg.ssm_heads, cfg.ssm_head_dim
        return L * (2 * d * el + H * D * D * 4), 0
    d_inner, D, n = 2 * d, cfg.ssm_head_dim, cfg.ssm_state
    H = d_inner // D
    layer = (cfg.conv_width - 1) * d_inner * el + H * D * n * 4
    sites = L // cfg.shared_attn_every
    kv = 2 * RECURRENT["long_len"] * cfg.num_kv_heads * cfg.head_dim * el
    return L * layer, sites * kv


def recurrent_carry(params, cfg, layer_fn: str, x) -> None:
    """Layer 0's recurrence in float32 through the kernels on its real
    input, ``RECURRENT["carry_seq"]`` tokens as two halves with the state
    carried, against one run (the twin of the reference's
    ``tests/test_models.py`` state-carry tests): outputs and final state
    within 1e-5, a gate a dropped carry must fail."""
    import dataclasses
    import torch
    from repro_torch.models import transformer
    f32 = dataclasses.replace(cfg, dtype="float32")
    block = params.blocks[0]
    layer = block.time_mix if cfg.family == "ssm" else block.mamba
    fn = getattr(transformer, layer_fn)
    n = RECURRENT["carry_seq"]
    x = x[:, :n].float()
    full, (_, st_full) = fn(layer, x, f32)
    a, st = fn(layer, x[:, :n // 2], f32)
    for what, carry in (("sound", st), ("fault", None)):
        b, (_, st_b) = fn(layer, x[:, n // 2:], f32, state=carry)
        rel = max(rel_frobenius(torch.cat([a, b], 1), full),
                  rel_frobenius(st_b, st_full))
        log("21 state_carry", arch=cfg.name, run=what, seq=n,
            dtype="float32", max_rel_frobenius=rel, limit=1e-5,
            ok=rel <= 1e-5)
        if carry is None:
            assert rel > 1e-5, "the carry gate misses a dropped state"
        else:
            assert rel <= 1e-5, "the carried state strays from one run"


def phase_recurrent(dev) -> list:
    """Phase 21: rwkv6-3b, then zamba2-1.2b (:func:`phase_recurrent_arch`);
    returns the two scans' rows."""
    t0 = time.perf_counter()
    rows = [phase_recurrent_arch(arch, dev) for arch in RECURRENT_ARCHS]
    log("21 done", seconds=time.perf_counter() - t0, **free_device_memory())
    return rows


# ---------------------------------------------------------------------------
# phases 22 and 23: the encoder-decoder (whisper-medium) and VLM
# (llava-next-mistral-7b) families at full width and depth
# ---------------------------------------------------------------------------

def log_tree(cfg, params, tag: str) -> None:
    """The config's analytic ``param_count`` beside the module tree's
    count: the tree less its norm scales equals it."""
    total = sum(p.numel() for p in params.parameters())
    norms = sum(p.numel() for n, p in params.named_parameters()
                if n.endswith(".scale"))
    log(f"{tag} config", arch=cfg.name, family=cfg.family,
        layers=cfg.num_layers, encoder_layers=cfg.encoder_layers,
        d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, param_count=cfg.param_count,
        tree_params=total, norm_params=norms,
        equal=total - norms == cfg.param_count)
    assert total - norms == cfg.param_count


def flash_attention_shape_row(name: str, shape, launches: int, dev,
                              tag: str) -> dict:
    """``flash_attention`` non-causal at ``shape`` (B, Hq, Hkv, Sq, Skv,
    D; bf16, random q, k and v): against the chunked version (max abs
    error ≤ 2e-2; relative Frobenius over all rows and the last eighth
    within ``ATTN_REL``), a gate the reference's padding fault
    (:func:`kv_padded_to_tile`) must fail where Skv is off the 64-key
    tile; the kernel's ms, its bound (the live pairs' operations at 989
    TFLOP/s, or the bytes at 3.35 TB/s, the larger), the plain chunked
    version's ms and SDPA's, and the kernel's and SDPA's device ms alone
    (logged only). Returns its row of the ``kernels`` line."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    B, Hq, Hkv, Sq, Skv, D = shape
    gen = torch.Generator(device=dev).manual_seed(Sq + Skv)
    q, k, v = (torch.randn((B, h, n, D), generator=gen, device=dev,
                           dtype=torch.bfloat16)
               for h, n in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
    kern = lambda: ops.attention(q, k, v, causal=False,  # noqa: E731
                                 impl="cuda")
    out = kern()
    want = kref.attention_chunked(q, k, v, causal=False)
    err = float((out.float() - want.float()).abs().max())
    rel = rel_rows(out, want, dim=2)
    lim = ATTN_REL["bfloat16"]
    ok = err <= 2e-2 and max(rel) <= lim
    bad = kv_padded_to_tile(lambda *a, **kw: ops.attention(
        *a, impl="cuda", **kw))(q, k, v, causal=False)
    ctl = rel_rows(bad, want, dim=2)
    del bad, want
    ms, reps = time_ms_auto(kern)
    plain_ms, plain_reps = time_ms_auto(
        lambda: kref.attention_chunked(q, k, v, causal=False))
    lib = sdpa_call(q, k, v, False, None, None, 0)
    lib_ms, lib_reps = time_ms_auto(lib)
    # at the short shapes the events above may time the host's launch
    # path: the device time alone, each call queued behind a spin
    dev_ms, host_ms, spin_ms = queued_ms(kern)
    lib_dev_ms, lib_host_ms, lib_spin_ms = queued_ms(lib)
    design = kernel_design(kern)
    flops = 4 * B * Hq * live_pairs(Sq, Skv, False, None, 0) * D
    nbytes = 2 * (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D)
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    r = dict(name=f"flash_attention:{name}", route="cuda",
             source="src/repro_torch/kernels/csrc/fa_hopper.cuh",
             replaces="src/repro/kernels/flash_attention.py:110",
             launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
             bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             library_ms=lib_ms)
    log(f"{tag} flash_attention_shape", **{
        k: v for k, v in r.items() if k not in ("source", "replaces",
                                                "route")},
        shape=f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D} "
        "causal=False", dtype="bfloat16", design=design,
        rel_frobenius=rel[0], rel_frobenius_last_eighth=rel[1], limit=lim,
        ok=ok, padded_fault_rel_frobenius=ctl[0],
        padded_fault_caught=max(ctl) > lim, tflop_per_s=flops / ms / 1e9,
        flop=flops, bytes=nbytes, operations_ms=t_ops, bytes_ms=t_bytes,
        reps=reps, plain_reps=plain_reps, library_reps=lib_reps,
        device_ms=dev_ms, library_device_ms=lib_dev_ms,
        queue_host_ms=host_ms, library_queue_host_ms=lib_host_ms,
        spin_ms=spin_ms, spin_covers_queue=max(host_ms, lib_host_ms) < min(
            spin_ms, lib_spin_ms),
        plain="attention_chunked at the row's shape",
        library="SDPA, enable_gqa, is_causal=False")
    assert ok, f"flash_attention strays from the chunked version ({name})"
    assert design in ("wgmma", "not measured"), design
    if Skv % 64:
        assert max(ctl) > lim, f"the gate misses the padding fault ({name})"
    return r


def phase_encdec(dev) -> list:
    """Phase 22: whisper-medium at full width and depth (24 + 24 layers,
    random, seed 0): the tree's count; phase 14's prefill and gates on
    32,768 decoder tokens over 1,500 frames (72 ``flash_attention``
    launches: 24 encoder, 24 self, 24 cross; the float32 gate's planted
    fault the reference's K/V padding); phase 15 with the launcher's 4
    requests, their wave's ``prefill`` given the frames, and its
    invariant (self- and cross-attention outputs; a zeroed cross K/V
    planted);
    ``flash_attention`` at the encoder, cross and decoder-self shapes and
    two checks; a trace of the prefill and a ``serve_step`` by stage;
    phase 16 on the reduced whisper. Returns its three ``kernels``
    rows."""
    import torch
    from repro_torch.configs.registry import get_config, reduced_config
    t0 = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    params, inputs, _, _, by_shape = phase_lm_prefill(
        cfg, dev, tag="22", path="encdec_prefill",
        gate2_fault=kv_padded_to_tile)
    log_tree(cfg, params, "22")
    # each row's launches: the prefill's count at the row's shape
    B, S = LM_PREFILL["batch"], LM_PREFILL["seq"]
    shapes = {**FA_ENCDEC, "whisper_self": (B, cfg.num_heads, cfg.num_kv_heads,
                                            S, S, cfg.head_dim)}
    per = {name: by_shape.get(((b, hq, sq, d), (b, hkv, skv, d),
                               name == "whisper_self"), 0)
           for name, (b, hq, hkv, sq, skv, d) in shapes.items()}
    want = {"whisper_encoder": cfg.encoder_layers,
            "whisper_cross": cfg.num_layers, "whisper_self": cfg.num_layers}
    log("22 launches_by_row", **per, equal=per == want)
    assert per == want, per
    state, cur = phase_lm_serve(params, cfg, dev, tag="22",
                                path="encdec_serve",
                                requests=LM_SERVE["max_batch"])
    rows = [flash_attention_shape_row(name, shape, per[name], dev, "22")
            for name, shape in FA_ENCDEC.items()]
    for name, shape in FA_ENCDEC_CHECKS.items():
        flash_attention_shape_row(name, shape, 0, dev, "22")
    self_row = flash_attention_row(per["whisper_self"], cfg, dev,
                                   checks=False, tag="22")
    rows.append({**self_row, "name": "flash_attention:whisper_self"})
    phase_lm_profile(params, cfg, inputs, state, cur, tag="22",
                     stages=ENCDEC_STAGES)
    peak = torch.cuda.max_memory_allocated()
    del params, inputs, state, cur
    log("22 whisper_done", seconds=time.perf_counter() - t0,
        peak_mem_bytes=peak, **free_device_memory())
    phase_lm_cpu(reduced_config(cfg), dev, tag="22")
    log("22 done", seconds=time.perf_counter() - t0, **free_device_memory())
    return rows


def phase_vlm(dev) -> list:
    """Phase 23: llava-next-mistral-7b at full width and depth (32 layers,
    32/8 heads of 128, random, seed 0): the tree's count; phase 14's
    prefill and gates on 2,880 patch embeddings + 29,888 tokens (32
    launches, the prefix positions in every gate; float32 at 2,880 +
    1,216); phase 15's launcher run (text only) and invariant against a
    forward with an empty prefix; ``flash_attention`` at its shape
    against SDPA; a trace of the prefill and a ``serve_step``; the peak
    memory, under the card's 80 GB; phase 16 on the reduced llava.
    Returns its ``kernels`` row."""
    import torch
    from repro_torch.configs.registry import get_config, reduced_config
    t0 = time.perf_counter()
    cfg = get_config(VLM_ARCH)
    params, inputs, fa_launches, _, _ = phase_lm_prefill(
        cfg, dev, tag="23", path="vlm_prefill")
    log_tree(cfg, params, "23")
    state, cur = phase_lm_serve(params, cfg, dev, tag="23",
                                path="vlm_serve")
    row = flash_attention_row(fa_launches, cfg, dev, checks=False, tag="23")
    phase_lm_profile(params, cfg, inputs, state, cur, tag="23")
    peak = torch.cuda.max_memory_allocated()
    del params, inputs, state, cur
    log("23 llava_done", seconds=time.perf_counter() - t0,
        peak_mem_bytes=peak, under_80gb=peak < 80e9, **free_device_memory())
    assert peak < 80e9, peak
    phase_lm_cpu(reduced_config(cfg), dev, tag="23")
    log("23 done", seconds=time.perf_counter() - t0, **free_device_memory())
    return [{**row, "name": "flash_attention:llava"}]


# phase 24: training, and the attention backward kernel
TRAIN = dict(batch=2, seq=4_096, steps=4, remat_steps=2, gate_seq=1_024,
             f32_layers=2)
# the backward kernel's checks: B, Hq, Hkv, Sq, Skv, D, causal, window,
# q_offset, soft cap
FA_BWD_CHECKS = {
    "d120": (1, 8, 2, 1_000, 1_000, 120, True, None, 0, None),
    "d128_window": (1, 8, 8, 1_000, 1_000, 128, True, 256, 0, None),
    "d256_soft_cap": (1, 8, 4, 1_000, 1_000, 256, True, None, 0, 50.0),
    "window": (1, 32, 8, 2_048, 2_048, 64, True, 512, 0, None),
    "soft_cap": (1, 32, 8, 2_048, 2_048, 64, True, None, 0, 30.0),
    "noncausal_1500": (1, 16, 16, 1_500, 1_500, 64, False, None, 0, None),
    "cross_4096x1500": (1, 16, 16, 4_096, 1_500, 64, False, None, 0, None),
    "masked_rows": (1, 8, 2, 256, 200, 64, True, 16, 150, None),
}
# relative Frobenius limits of dq, dk and dv against the plain backward
FA_BWD_REL = {"float32": 1e-5, "bfloat16": 1e-2}
# a training step's gradients, every leaf against the plain path's
TRAIN_GRAD_REL = {"bfloat16": 5e-2, "float32": 1e-4, "remat": 1e-6}


def attention_bwd_inputs(shape, dtype, dev, seed: int) -> tuple:
    """Random q, k, v and dO at ``shape`` and the forward kernel's output
    and LSE on them."""
    import torch
    from repro_torch.kernels import ops
    B, Hq, Hkv, Sq, Skv, D, causal, window, qo, cap = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=gen, device=dev, dtype=dtype)
                   for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                             (B, Hkv, Skv, D), (B, Hq, Sq, D)))
    o, lse = ops._attention_kernel(q, k, v, causal, window, qo, cap,
                                   with_lse=True)
    return q, k, v, o, lse, do


def bwd_errors(got, want) -> list:
    """Relative Frobenius errors of (dq, dk, dv) against the plain ones."""
    return [rel_frobenius(a, b, dim=2) for a, b in zip(got, want)]


def attention_bwd_check(name: str, shape, dtype: str, dev) -> float:
    """The backward kernel against ``attention_bwd_ref`` (float32, on the
    same inputs, output and LSE) at ``shape``; asserts ``FA_BWD_REL`` and,
    for rows with no live key, a zero dq. Returns the worst error."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    B, Hq, Hkv, Sq, Skv, D, causal, window, qo, cap = shape
    q, k, v, o, lse, do = attention_bwd_inputs(shape, getattr(torch, dtype),
                                               dev, seed=Sq + D)
    kw = dict(causal=causal, window=window, q_offset=qo, soft_cap=cap)
    got = ops.attention_bwd(q, k, v, o, lse, do, impl="cuda", **kw)
    want = kref.attention_bwd_ref(*(t.float() for t in (q, k, v, o)), lse,
                                  do.float(), **kw)
    errs = bwd_errors(got, want)
    dead = torch.isinf(lse[0, 0])
    dead_zero = bool((got[0][:, :, dead] == 0).all()) if bool(
        dead.any()) else None
    ok = max(errs) <= FA_BWD_REL[dtype] and dead_zero in (None, True)
    log("24 flash_attention_bwd_check", shape=name, dtype=dtype, Sq=Sq,
        Skv=Skv, D=D, causal=causal, window=window, q_offset=qo,
        soft_cap=cap, rel_dq=errs[0], rel_dk=errs[1], rel_dv=errs[2],
        limit=FA_BWD_REL[dtype], rows_without_keys=int(dead.sum()),
        their_dq_zero=dead_zero, ok=ok)
    assert ok, f"flash_attention_bwd strays from its plain version ({name})"
    return max(errs)


def sdpa_backward_ms(q, k, v, do) -> tuple:
    """``(SDPA forward+backward ms, its forward ms under autograd)`` at
    llama's causal shape (flash backend, ``enable_gqa``): the yardstick
    of the backward kernel; the port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                              enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qq, kk, vv), do)

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        return time_ms_auto(fwd_bwd)[0], time_ms_auto(fwd)[0]


def flash_attention_bwd_row(launches: int, cfg, dev) -> dict:
    """The backward kernel's gates and row: float32 at S = 4,096 with
    ``cfg``'s heads (and the two planted faults), bf16 at 1 × 32,768, the
    ``FA_BWD_CHECKS`` in both types; then at the 32k shape its ms
    (events) and device ms (a trace, by kernel), its bound (operations:
    10 · B · Hq · pairs · D at 989 TFLOP/s, or bytes, the larger), the
    plain version's ms (one warm call), SDPA's backward ms (forward and
    backward less forward), and the forward's ms with the LSE and
    without."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lim = FA_BWD_REL["float32"]
    # float32 at 4,096, and the planted faults the same gate must fail
    shape = (1, Hq, Hkv, 4_096, 4_096, D, True, None, 0, None)
    q, k, v, o, lse, do = attention_bwd_inputs(shape, torch.float32, dev, 1)
    got = ops.attention_bwd(q, k, v, o, lse, do, impl="cuda")
    want = kref.attention_bwd_ref(q, k, v, o, lse, do)
    errs = bwd_errors(got, want)
    log("24 flash_attention_bwd_f32", S=4_096, rel_dq=errs[0],
        rel_dk=errs[1], rel_dv=errs[2], limit=lim, ok=max(errs) <= lim)
    assert max(errs) <= lim, f"flash_attention_bwd strays in float32: {errs}"
    # Δ left out: the kernel's Δ is rowsum(dO ∘ O), so a zero O gives it
    no_delta = ops.attention_bwd(q, k, v, torch.zeros_like(o), lse, do,
                                 impl="cuda")
    # the GQA sum over one head of each group: the kernel on the group's
    # first query heads alone
    G = Hq // Hkv
    one = ops.attention_bwd(q[:, ::G], k, v, o[:, ::G], lse[:, ::G],
                            do[:, ::G], impl="cuda")
    for what, bad in (("delta_left_out", no_delta),
                      ("gqa_sum_over_one_head", (got[0],) + one[1:])):
        e = bwd_errors(bad, want)
        log("24 flash_attention_bwd_control", fault=what, rel_dq=e[0],
            rel_dk=e[1], rel_dv=e[2], limit=lim, caught=max(e) > lim)
        assert max(e) > lim, f"the float32 gate misses a planted fault " \
            f"({what})"
    del q, k, v, o, lse, do, got, want, no_delta, one
    # the same faults on the bf16 tensor-core route, at the bf16 limit
    lim16 = FA_BWD_REL["bfloat16"]
    q, k, v, o, lse, do = attention_bwd_inputs(shape, torch.bfloat16, dev, 1)
    before = dict(ops.BWD_ROUTES)
    got = ops.attention_bwd(q, k, v, o, lse, do, impl="cuda")
    want = kref.attention_bwd_ref(*(t.float() for t in (q, k, v, o)), lse,
                                  do.float())
    errs16 = bwd_errors(got, want)
    log("24 flash_attention_bwd_bf16", S=4_096, route="wgmma",
        rel_dq=errs16[0], rel_dk=errs16[1], rel_dv=errs16[2], limit=lim16,
        ok=max(errs16) <= lim16)
    assert max(errs16) <= lim16, f"flash_attention_bwd strays in bf16: " \
        f"{errs16}"
    no_delta = ops.attention_bwd(q, k, v, torch.zeros_like(o), lse, do,
                                 impl="cuda")
    one = ops.attention_bwd(q[:, ::G], k, v, o[:, ::G], lse[:, ::G],
                            do[:, ::G], impl="cuda")
    wgmma_calls = ops.BWD_ROUTES["wgmma"] - before["wgmma"]
    for what, bad in (("delta_left_out", no_delta),
                      ("gqa_sum_over_one_head", (got[0],) + one[1:])):
        e = bwd_errors(bad, want)
        log("24 flash_attention_bwd_control", route="wgmma",
            dtype="bfloat16", fault=what, rel_dq=e[0], rel_dk=e[1],
            rel_dv=e[2], limit=lim16, caught=max(e) > lim16)
        assert max(e) > lim16, f"the bf16 gate misses a planted fault " \
            f"({what})"
    assert wgmma_calls == 3, f"the bf16 calls left the tensor-core route: " \
        f"{ops.BWD_ROUTES}"
    del q, k, v, o, lse, do, got, want, no_delta, one
    worst = max(errs)
    for name, check in FA_BWD_CHECKS.items():
        for dtype in ("float32", "bfloat16"):
            worst_dt = attention_bwd_check(name, check, dtype, dev)
            if dtype == "float32":
                worst = max(worst, worst_dt)
    # bf16 at the 32k shape: the gate, then the times
    B, S = LM_PREFILL["batch"], LM_PREFILL["seq"]
    shape = (B, Hq, Hkv, S, S, D, True, None, 0, None)
    q, k, v, o, lse, do = attention_bwd_inputs(shape, torch.bfloat16, dev, 2)
    kern = lambda: ops.attention_bwd(q, k, v, o, lse, do,  # noqa: E731
                                     impl="cuda")
    got = kern()
    plain = lambda: kref.attention_bwd_ref(  # noqa: E731
        *(t.float() for t in (q, k, v, o)), lse, do.float())
    want = plain()
    errs32k = bwd_errors(got, want)
    max_abs = max(float((a.float() - b).abs().max())
                  for a, b in zip(got, want))
    log("24 flash_attention_bwd_32k", dtype="bfloat16", S=S,
        rel_dq=errs32k[0], rel_dk=errs32k[1], rel_dv=errs32k[2],
        limit=lim16, max_abs_err=max_abs, ok=max(errs32k) <= lim16)
    assert max(errs32k) <= lim16, f"flash_attention_bwd strays at 32k: " \
        f"{errs32k}"
    del got, want
    ms, reps = time_ms_auto(kern)
    _, _, _, by_kernel, top = device_busy_ms(kern, by_kernel=True)
    # a trace may drop the ctypes launches (PERF.md §7)
    dev_ms = bwd_device_ms(by_kernel)
    plain_ms = time_ms(plain, reps=1, warmups=1)
    lib_ms, lib_fwd_ms = sdpa_backward_ms(q, k, v, do)
    fwd_lse = lambda: ops._attention_kernel(  # noqa: E731
        q, k, v, True, None, 0, None, with_lse=True)
    fwd = lambda: ops._attention_kernel(  # noqa: E731
        q, k, v, True, None, 0, None, with_lse=False)
    fwd_ms = [time_ms_auto(f)[0] for f in (fwd, fwd_lse, fwd_lse, fwd)]
    same = torch.equal(fwd()[0], fwd_lse()[0])
    pairs = live_pairs(S, S, True, None, 0)
    flops = 10 * B * Hq * pairs * D
    train = bwd_train_shape(cfg, dev)
    nbytes = 2 * (4 * B * Hq * S * D + 4 * B * Hkv * S * D) + 4 * B * Hq * S
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    r = dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:110",
             launches=launches, max_abs_err=max_abs, ms=ms,
             plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             library_ms=lib_ms - lib_fwd_ms)
    log("24 kernel", **{k: v for k, v in r.items()
                        if k not in ("source", "replaces", "route")},
        card=repr(card_name_power()),
        device_ms=dev_ms, by_kernel=json.dumps(by_kernel),
        tflop_per_s_by_pass=json.dumps(pass_tflop_per_s(by_kernel, flops)),
        top_kernels=json.dumps(top), tflop_per_s=flops / ms / 1e9,
        reps=reps, flop=flops, bytes=nbytes, worst_f32_rel=worst,
        sdpa_fwd_bwd_ms=lib_ms, sdpa_fwd_ms=lib_fwd_ms,
        forward_ms_without_lse=[fwd_ms[0], fwd_ms[3]],
        forward_ms_with_lse=[fwd_ms[1], fwd_ms[2]],
        forward_output_equal_with_lse=same,
        shape=f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} causal bf16",
        plain="attention_bwd_ref, float32, one warm call",
        library="SDPA flash backend, enable_gqa: forward+backward less "
        "forward")
    log("24 kernel_train_shape", **train, card=repr(card_name_power()))
    assert same, "the forward's output changes when it writes the LSE"
    return r


# the backward's kernels by their names in a trace: the bf16 tensor-core
# route's Δ, key-tile and query-tile passes, then the SIMT route's
BWD_KERNELS = ("bwd_prep_kernel", "dkdv_wgmma_kernel", "dq_wgmma_kernel",
               "delta_kernel", "dkdv_kernel", "dq_kernel")
# the algorithm's products a pass runs on the tensor-core route (the query
# pass recomputes S and dP)
BWD_PASS_PRODUCTS = {"dkdv_wgmma_kernel": 4, "dq_wgmma_kernel": 3}


def bwd_device_ms(by_kernel: dict):
    """The backward's device ms in a trace's ``port_kernel_times``, or
    "not measured" when the trace holds none of its kernels."""
    found = [by_kernel[n][1] for n in BWD_KERNELS if n in by_kernel]
    return sum(found) if found else "not measured"


def pass_tflop_per_s(by_kernel: dict, flops: int) -> dict:
    """Each tensor-core pass's TFLOP/s of its products over the live
    pairs (``flops`` is the algorithm's five products'), from a trace."""
    return {n: k * flops / 5 / by_kernel[n][1] / 1e9
            for n, k in BWD_PASS_PRODUCTS.items()
            if by_kernel.get(n, (0, 0.0))[1] > 0}


def bwd_train_shape(cfg, dev) -> dict:
    """The bf16 backward at the training step's shape (``TRAIN``'s batch
    and sequence, ``cfg``'s heads, causal): held against
    ``attention_bwd_ref`` at ``FA_BWD_REL`` (the only gate with B > 1 on
    the tensor-core route), then its ms (events), device ms by pass (a
    trace) and SDPA's backward on the same inputs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    B, S = TRAIN["batch"], TRAIN["seq"]
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shape = (B, Hq, Hkv, S, S, D, True, None, 0, None)
    q, k, v, o, lse, do = attention_bwd_inputs(shape, torch.bfloat16, dev, 4)
    kern = lambda: ops.attention_bwd(q, k, v, o, lse, do,  # noqa: E731
                                     impl="cuda")
    got = kern()
    want = kref.attention_bwd_ref(*(t.float() for t in (q, k, v, o)), lse,
                                  do.float())
    errs = bwd_errors(got, want)
    lim = FA_BWD_REL["bfloat16"]
    ok = max(errs) <= lim
    log("24 flash_attention_bwd_train_shape", dtype="bfloat16", B=B, S=S,
        rel_dq=errs[0], rel_dk=errs[1], rel_dv=errs[2], limit=lim, ok=ok)
    assert ok, f"flash_attention_bwd strays at the training shape: {errs}"
    del got, want
    ms, reps = time_ms_auto(kern)
    _, _, _, by_kernel, _ = device_busy_ms(kern, by_kernel=True)
    lib_ms, lib_fwd_ms = sdpa_backward_ms(q, k, v, do)
    flops = 10 * B * Hq * live_pairs(S, S, True, None, 0) * D
    return dict(shape=f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} causal bf16",
                ms=ms, reps=reps, device_ms=bwd_device_ms(by_kernel),
                by_kernel=json.dumps({n: by_kernel[n] for n in BWD_KERNELS
                                      if n in by_kernel}),
                tflop_per_s=flops / ms / 1e9,
                bound_ms=flops / BF16_FLOP_PER_S * 1e3, rel_dq=errs[0],
                rel_dk=errs[1], rel_dv=errs[2], ok=ok,
                library_ms=lib_ms - lib_fwd_ms, sdpa_fwd_bwd_ms=lib_ms,
                sdpa_fwd_ms=lib_fwd_ms, a_step_ms=ms * cfg.num_layers)


def grad_errors(got: dict, want: dict) -> dict:
    """Each leaf's relative Frobenius error of ``got`` against ``want``
    (0 where both are 0)."""
    out = {}
    for k, w in want.items():
        den = float(w.double().norm())
        num = float((got[k].double() - w.double()).norm())
        out[k] = num / den if den else num
    return out


def step_gradients(params, batch, cfg, remat: bool) -> tuple:
    """``(loss, metrics, gradients by name)`` of one training step's loss
    (``train_step``'s own function, no update)."""
    from repro_torch.training import TrainStepConfig
    from repro_torch.training.train_step import _value_and_grad
    return _value_and_grad(params, batch, cfg, TrainStepConfig(remat=remat))


def detached_output(orig):
    """Planted fault: the attention kernel's output with no autograd
    history, as ``ops.attention`` returned it on the card before its
    backward existed."""
    def fn(*a, **kw):
        return orig(*a, **kw).detach()
    return fn


def train_grad_gates(params, cfg, dev) -> None:
    """The step's gradients through the kernels against the plain path's
    (``attn_impl="torch"``): bf16 at B = 1, S = ``TRAIN["gate_seq"]`` on
    the full model, every leaf within 5e-2; float32 at
    ``TRAIN["f32_layers"]`` layers, every leaf within 1e-4, ``remat``
    within 1e-6 of none, and the detached-output fault caught."""
    import dataclasses
    import torch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import attention as mattn
    from repro_torch.models import init_params
    data = SyntheticTokens(vocab_size=cfg.vocab_size,
                           seq_len=TRAIN["gate_seq"], global_batch=1, seed=3)
    batch = data.batch(0, device=dev)
    plain_cfg = dataclasses.replace(cfg, attn_impl="torch")
    lim = TRAIN_GRAD_REL["bfloat16"]
    got = step_gradients(params, batch, cfg, False)[2]
    want = step_gradients(params, batch, plain_cfg, False)[2]
    errs = grad_errors(got, want)
    worst = max(errs, key=errs.get)
    log("24 train_grad_gate", dtype="bfloat16", S=TRAIN["gate_seq"],
        leaves=len(errs), worst_leaf=worst, worst_rel=errs[worst],
        wq_rel=errs["blocks.0.attn.wq"], limit=lim,
        ok=errs[worst] <= lim)
    assert errs[worst] <= lim, f"bf16 gradients stray: {worst} {errs[worst]}"
    del got, want
    f32 = dataclasses.replace(cfg, num_layers=TRAIN["f32_layers"],
                              dtype="float32")
    small = init_params(f32, torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    want = step_gradients(small, batch, dataclasses.replace(
        f32, attn_impl="torch"), False)[2]
    got = step_gradients(small, batch, f32, False)[2]
    remat = step_gradients(small, batch, f32, True)[2]
    errs = grad_errors(got, want)
    rerr = grad_errors(remat, got)
    with patched(mattn.kops, "attention", detached_output):
        bad = grad_errors(step_gradients(small, batch, f32, False)[2], want)
    lim32 = TRAIN_GRAD_REL["float32"]
    worst, rworst, bworst = (max(e, key=e.get) for e in (errs, rerr, bad))
    log("24 train_grad_gate", dtype="float32", layers=f32.num_layers,
        S=TRAIN["gate_seq"], worst_leaf=worst, worst_rel=errs[worst],
        limit=lim32, ok=errs[worst] <= lim32, remat_worst_leaf=rworst,
        remat_worst_rel=rerr[rworst], remat_limit=TRAIN_GRAD_REL["remat"],
        remat_ok=rerr[rworst] <= TRAIN_GRAD_REL["remat"])
    log("24 train_grad_control", fault="kernel_output_detached",
        worst_leaf=bworst, worst_rel=bad[bworst], limit=lim32,
        caught=bad[bworst] > lim32)
    assert errs[worst] <= lim32, f"f32 gradients stray: {worst}"
    assert rerr[rworst] <= TRAIN_GRAD_REL["remat"], f"remat: {rworst}"
    assert bad[bworst] > lim32, "the float32 gate misses a detached output"


def phase_training(dev) -> list:
    """Phase 24: the attention backward kernel's gates and row, then
    llama3.2-1b trained at full width and depth on the synthetic stream
    (4 steps, then 2 under ``remat``), each step's numbers, its launches,
    repeat gradients byte-equal, and the gradient gates. Returns the
    ``kernels`` row of ``flash_attention_bwd``."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.training import (AdamWConfig, TrainStepConfig,
                                      make_train_step)
    from repro_torch.training.train_step import init_train_state
    t0 = time.perf_counter()
    card = card_name_power()
    log("24 device", card=repr(card))
    cfg = get_config(LM_ARCH)
    B, S = TRAIN["batch"], TRAIN["seq"]
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=S,
                           global_batch=B, seed=0)
    first = data.batch(0, device=dev)
    # two runs of the first step's gradients: the same bytes
    g1 = step_gradients(state["params"], first, cfg, False)[2]
    g2 = step_gradients(state["params"], first, cfg, False)[2]
    equal = all(torch.equal(g1[k], g2[k]) for k in g1)
    log("24 repeat_gradients", leaves=len(g1), byte_equal=equal)
    assert equal, "the first step's gradients differ run to run"
    del g1, g2
    opt = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=100,
                      weight_decay=0.1)
    steps = [(False, make_train_step(cfg, TrainStepConfig(opt=opt,
                                                          remat=False)))
             ] * TRAIN["steps"] + [
        (True, make_train_step(cfg, TrainStepConfig(opt=opt, remat=True)))
    ] * TRAIN["remat_steps"]
    free_device_memory()
    sync()
    ops.reset_launch_counts()
    runs = []
    for i, (remat, step) in enumerate(steps):
        batch = data.batch(i, device=dev)
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        sync()
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        sec = time.perf_counter() - t1
        after = ops.launch_counts()
        n = {k: after[k] - before[k]
             for k in ("flash_attention", "flash_attention_bwd")}
        runs.append(dict(step=i, remat=remat, loss=float(metrics["loss"]),
                         grad_norm=float(metrics["grad_norm"]),
                         seconds=sec, tokens_per_s=B * S / sec,
                         peak_mem_bytes=torch.cuda.max_memory_allocated(),
                         **n))
        log("24 train_step", **runs[-1])
    launches = ops.launch_counts()
    log("launches", path="training", **launches)
    log("24 backward_routes", **ops.BWD_ROUTES)
    L = cfg.num_layers
    assert launches["flash_attention_bwd"] == L * len(steps), launches
    assert ops.BWD_ROUTES == {"wgmma": L * len(steps), "simt": 0}, \
        f"the step's backward left the tensor-core route: {ops.BWD_ROUTES}"
    for r in runs:
        assert r["flash_attention"] == L * (2 if r["remat"] else 1), r
        assert r["flash_attention_bwd"] == L, r
        assert all(map(lambda x: x == x and abs(x) < float("inf"),
                       (r["loss"], r["grad_norm"]))), r
    peak = max(r["peak_mem_bytes"] for r in runs)
    plain = [r for r in runs if not r["remat"]][1:]     # after the first
    with_remat = [r for r in runs if r["remat"]][1:]
    log("24 train_summary", card=repr(card), arch=cfg.name, batch=B, seq=S,
        params=sum(p.numel() for p in state["params"].parameters()),
        s_a_step=sum(r["seconds"] for r in plain) / len(plain),
        tokens_per_s=sum(r["tokens_per_s"] for r in plain) / len(plain),
        s_a_step_remat=with_remat[0]["seconds"],
        tokens_per_s_remat=with_remat[0]["tokens_per_s"],
        peak_mem_bytes=peak, peak_mem_bytes_remat=max(
            r["peak_mem_bytes"] for r in runs if r["remat"]),
        under_80gb=peak < 80e9,
        losses=[r["loss"] for r in runs])
    assert peak < 80e9, peak
    # one more step (no remat) under the profiler: where its time goes
    out = {}

    def traced():
        out["state"] = steps[0][1](state, data.batch(len(steps), device=dev))

    wall, busy, n_k, by_kernel, top = device_busy_ms(traced, by_kernel=True)
    state = out["state"][0]
    fwd_ms = by_kernel.get("fa_wgmma_kernel", (0, 0.0))[1]
    bwd_ms = bwd_device_ms(by_kernel)
    measured = busy and fwd_ms and bwd_ms != "not measured"
    log("24 profile", wall_ms=wall, device_busy_ms=busy,
        idle_share=1.0 - busy / wall, kernels=n_k,
        flash_attention_ms=fwd_ms if fwd_ms else "not measured",
        flash_attention_bwd_ms=bwd_ms,
        attention_share_of_busy=(fwd_ms + bwd_ms) / busy if measured else
        "not measured",
        port_kernels=json.dumps(by_kernel), top_kernels=json.dumps(top))
    train_grad_gates(state["params"], cfg, dev)
    del state, out
    free_device_memory()
    row = flash_attention_bwd_row(launches["flash_attention_bwd"], cfg, dev)
    log("24 done", seconds=time.perf_counter() - t0, **free_device_memory())
    return [row]


# ---------------------------------------------------------------------------
# phase 25: the recurrent families' training (rwkv6-3b, zamba2-1.2b at full
# width and depth), through the scans' backward kernels
# ---------------------------------------------------------------------------

# the training step's shape as phase 24's; the plain path's gradient gates
# at 1 × 1,024, the float32 ones at 2 layers; the backward kernels timed at
# the training shape and at the 32k prefill's length
RTRAIN = dict(batch=2, seq=4_096, steps=4, gate_seq=1_024, f32_layers=2,
              long_seq=32_768)
# The leaves whose bf16 step gradient is a sum over tokens (and, for
# zamba2's B and C, over 64 heads) of terms that nearly cancel: rwkv's bonus
# u (Σ r·k·(do·v)), zamba2's B and C projections and its Mamba blocks' norm
# scale. Two correct bf16 computations of the step differ in their
# activations by rounding, and that moves these leaves by 5-9% where every
# other leaf moves by under 5e-2; the backward kernels themselves match
# their twins on the step's own inputs (the path-input gate, 1e-2; du to
# 1e-7). These leaves do not meet the 5e-2 gate; they are held to 0.15.
NEAR_CANCEL = {"ssm": ("time_mix.u",),
               "hybrid": ("mamba.w_in_B", "mamba.w_in_C", "ln.scale")}
NEAR_CANCEL_REL = 0.15
# Queue 3 item 9, settled against a float32 step: the same step once in
# float32 through the kernels (same weights, same batch), and each
# NEAR_CANCEL leaf's kernel-path bf16 error against it at most this many
# times the plain path's, or TRAIN_GRAD_REL["bfloat16"], whichever is
# larger (near_cancel_gate)
NEAR_CANCEL_F32_RATIO = 1.5
# each backward kernel at its model's heads: H, D, n (0: no state size)
SCAN_BWD = {"wkv6_scan_bwd": dict(arch="rwkv6-3b", H=40, D=64, n=0,
                                  source="wkv6_bwd.cu",
                                  trace=("wkv6_bwd_dh_kernel",
                                         "wkv6_bwd_chunk_kernel")),
            "ssd_scan_bwd": dict(arch="zamba2-1.2b", H=64, D=64, n=64,
                                 source="ssd_scan_bwd.cu",
                                 trace=("ssd_bwd_dh_kernel",
                                        "ssd_bwd_chunk_kernel"))}
SCAN_BWD_GRADS = {"wkv6_scan_bwd": ("dr", "dk", "dv", "dlw", "du", "dS0"),
                  "ssd_scan_bwd": ("dx", "dB", "dC", "ddt", "da", "dh0")}
SCAN_BWD_REL = {"float32": 1e-5, "bfloat16": 1e-2}
# no TPU kernel: the reference differentiates its lax.scan through XLA
SCAN_BWD_REPLACES = {
    "wkv6_scan_bwd": "src/repro/models/rwkv6.py:134 (XLA's gradient of "
                     "chunked_scan's lax.scan, no Pallas kernel)",
    "ssd_scan_bwd": "src/repro/models/mamba2.py:122 (XLA's gradient of "
                    "chunked_scan's lax.scan, no Pallas kernel)"}
SCAN_BWD_FWD = {"wkv6_scan_bwd": "wkv6_scan", "ssd_scan_bwd": "ssd_scan"}


def scan_bwd_sums(kernel: str, B: int, S: int) -> int:
    """The short passes' launches (``scan_sum``) of one backward call at
    its model's heads: wkv6 one (du); ssd one (da) and two more (dB, dC)
    where its chunk pass has more than one head group, as at the training
    shape."""
    if kernel == "wkv6_scan_bwd":
        return 1
    from repro_torch.kernels import ops
    groups = ops.ssd_bwd_groups(B, -(-S // 32), SCAN_BWD[kernel]["H"])
    return 1 + 2 * (groups > 1)


def tensor_rel(a, b) -> float:
    """``‖a − b‖_F / ‖b‖_F`` in float64 (the norm of ``a`` where ``b`` is
    0)."""
    a, b = a.double(), b.double()
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float(a.norm())


def scan_bwd_inputs(kernel: str, B: int, S: int, dtype, dev, seed: int):
    """A backward kernel's operands at its model's heads: the forward's
    inputs (r, k, v or x, B, C in ``dtype``; realistic decays; a nonzero
    starting state), the cotangents of the output and the final state
    (nonzero) and the backward's keywords (wkv6: ``log_w``, the log-decay
    that w is exp of)."""
    import torch
    c = SCAN_BWD[kernel]
    H, D, n = c["H"], c["D"], c["n"]
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    if kernel == "wkv6_scan_bwd":
        r, k, v = (rn(B, S, H, D).to(dtype) for _ in range(3))
        lw = -torch.exp(rn(B, S, H, D) - 1)
        args = [r, k, v, torch.exp(lw), rn(H, D, scale=0.1),
                rn(B, H, D, D, scale=0.5)]
        cots = [rn(B, S, H, D).to(dtype), rn(B, H, D, D, scale=0.1)]
        return args, cots, {"log_w": lw}
    else:
        x = rn(B, S, H, D).to(dtype)
        Bv, Cv = (rn(B, S, n).to(dtype) for _ in range(2))
        dt = torch.nn.functional.softplus(rn(B, S, H) - 2)
        a = -torch.linspace(1, 16, H, device=dev)
        args = [x, Bv, Cv, dt, a, rn(B, H, D, n, scale=0.5)]
        cots = [rn(B, S, H, D), rn(B, H, D, n, scale=0.1)]
    return args, cots, {}


def scan_bwd_work(kernel: str, args, cots) -> tuple:
    """``(bytes, serial operations, chunked products, float32 operations
    beside them)`` the backward needs at these shapes: each input read
    once (the forward's inputs, its chunk checkpoints — float32 states,
    one a 32-step chunk — and the two cotangents), each gradient written
    once (the five inputs' in their dtypes, the starting state's in
    float32); the serial form's 14 float32 operations a state element and
    step (the state recomputed from its checkpoint: 3; wkv6: G's update 3
    and the products for dr, dk, dv, dlw 8; ssd: G 2, the products G·B,
    G·x, dy·h, G·h 8 and the carried decay·G 1); the chunked forms'
    tensor-core products, chunks of L = 32 (tri = L(L + 1)/2): ssd a head
    and chunk dYᵀ·C, B·dh_endᵀ, X·dh_end and dY·h_start at 2·L·D·n each,
    dY·Xᵀ and (G ∘ E)ᵀ·dY at 2·tri·D, W2ᵀ·C and W2·B at 2·tri·n, C·Bᵀ
    once a chunk; wkv6 a head and chunk (R ∘ pre)ᵀ·dO, dO·S_cᵀ, V·G_eᵀ
    and (K ∘ suf)·G_e at 2·L·D² each, dO·Vᵀ at 2·tri·D, Qᵀ·dO at
    2·L(L − 1)/2·D, and the three 16 × 16 × D cross products R̂·K̂ᵀ, M·K̂,
    Mᵀ·R̂; and wkv6's sub-chunks' pairs, formed on the SIMT units: 8
    float32 operations a pair s < t of a 16-step sub-chunk and channel."""
    def nb(t):
        return t.numel() * t.element_size()

    B, S, H, D = args[0].shape
    cols = D if kernel == "wkv6_scan_bwd" else args[1].shape[-1]
    state = B * H * D * cols * 4
    ckpt = state * -(-S // 32)
    reads = sum(nb(t) for t in (*args, *cots)) + ckpt
    writes = sum(nb(t) for t in args[:5]) + state
    L, nch = 32, -(-S // 32)
    tri = L * (L + 1) // 2
    if kernel == "ssd_scan_bwd":
        chunked = B * nch * (H * (4 * 2 * L * D * cols + 2 * tri * 2 * D
                                  + 2 * tri * 2 * cols) + 2 * tri * cols)
        simt = 0
    else:
        chunked = B * nch * H * (4 * 2 * L * D * D + 2 * tri * D
                                 + 2 * (L * (L - 1) // 2) * D
                                 + 3 * 2 * 16 * 16 * D)
        simt = B * nch * H * 2 * (16 * 15 // 2) * D * 8
    return reads + writes, 14 * B * S * H * D * cols, chunked, simt


def scan_forward(kernel: str, args, checkpoints: bool) -> tuple:
    """One launch of the backward kernel's forward on ``args``, checked as
    its wrapper checks them: ``(output, final state, chunk checkpoints or
    None)``."""
    from repro_torch.kernels import ops
    fwd = SCAN_BWD_FWD[kernel]
    if fwd == "wkv6_scan":
        return ops._wkv6_kernel(*ops._wkv6_operands(fwd, *args),
                                checkpoints=checkpoints)
    return ops._ssd_kernel(*ops._ssd_operands(fwd, *args),
                           checkpoints=checkpoints)


def scan_bwd_gate(kernel: str, B: int, S: int, dtype: str, dev,
                  seed: int) -> float:
    """The backward kernel against its plain twin (float32, on the same
    inputs) at B × S: every gradient within ``SCAN_BWD_REL``, two runs
    byte-equal, and a planted fault (the carried state's gradient dropped:
    dS0 or dh0 zeroed) that the float32 gate must fail. Returns the
    largest max abs error."""
    import torch
    from repro_torch.kernels import ops
    fn = getattr(ops, kernel)
    dt = getattr(torch, dtype)
    args, cots, kw = scan_bwd_inputs(kernel, B, S, dt, dev, seed)
    ckpt = scan_forward(kernel, args, checkpoints=True)[2]
    got = fn(*args, *cots, ckpt=ckpt, impl="cuda", **kw)
    again = fn(*args, *cots, ckpt=ckpt, impl="cuda", **kw)
    sync()
    equal = all(torch.equal(a, b) for a, b in zip(got, again))
    del again, ckpt
    want = fn(*(t.float() for t in args), *(t.float() for t in cots),
              ckpt=None, impl="torch")
    errs = [tensor_rel(a, b) for a, b in zip(got, want)]
    worst = max(float((a.float() - b).abs().max()) for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    lim = SCAN_BWD_REL[dtype]
    fault = tensor_rel(torch.zeros_like(got[5]), want[5])
    names = SCAN_BWD_GRADS[kernel]
    ok = max(errs) <= lim and equal and finite
    log("25 scan_bwd_gate", kernel=kernel, dtype=dtype, B=B, S=S,
        heads=SCAN_BWD[kernel]["H"], **{f"rel_{k}": e for k, e in
                                        zip(names, errs)},
        max_abs_err=worst, limit=lim, repeat_byte_equal=equal,
        finite=finite, ok=ok)
    if dtype == "float32":
        log("25 scan_bwd_control", kernel=kernel, S=S,
            fault=f"{names[5]}_zeroed", rel=fault, limit=lim,
            caught=fault > lim)
        assert fault > lim, f"{kernel}: the gate misses a dropped {names[5]}"
    assert ok, f"{kernel} strays from its plain twin ({dtype}, {B}x{S})"
    return worst


def scan_fwd_bytes_equal(kernel: str, dev) -> None:
    """The forward kernel without grad against the same launch writing the
    chunk checkpoints, at the training shape in bf16: the same bytes."""
    import torch
    fwd = SCAN_BWD_FWD[kernel]
    args, _, _ = scan_bwd_inputs(kernel, RTRAIN["batch"], RTRAIN["seq"],
                              torch.bfloat16, dev, seed=11)
    plain = scan_forward(kernel, args, checkpoints=False)
    with_ckpt = scan_forward(kernel, args, checkpoints=True)
    sync()
    equal = all(torch.equal(a, b) for a, b in zip(plain[:2], with_ckpt[:2]))
    log("25 forward_bytes", kernel=fwd, shape=list(args[0].shape),
        dtype="bfloat16", checkpoints=list(with_ckpt[2].shape),
        checkpoint_bytes=with_ckpt[2].numel() * 4,
        no_grad_equals_checkpointing=equal)
    assert equal, f"{fwd}: writing the checkpoints changes its output"


def traced_launches(call, per_call: dict, calls: int = 5,
                    attempts: int = 3) -> tuple:
    """``({kernel: (launches, device ms)}, complete, traces taken)`` of the
    kernels named in ``per_call`` (their launches a call) in a trace of
    ``calls`` calls of ``call``, each synchronised. A trace can drop
    ctypes launches, so up to ``attempts`` traces are taken until one holds
    every launch; otherwise the launches all the traces caught, summed."""
    want = {k: calls * n for k, n in per_call.items()}
    total = dict.fromkeys(want, (0, 0.0))
    for i in range(attempts):
        by = device_busy_ms(lambda: [(call(), sync()) for _ in range(calls)],
                            by_kernel=True)[3]
        got = {k: tuple(by.get(k, (0, 0.0))) for k in want}
        if all(got[k][0] == want[k] for k in want):
            return got, True, i + 1
        total = {k: (total[k][0] + got[k][0], total[k][1] + got[k][1])
                 for k in want}
    return total, False, attempts


def scan_bwd_row(kernel: str, launches: int, err: float, dev) -> dict:
    """The backward kernel's ``kernels`` row: ms (events) and device ms (a
    trace: the kernels and their second passes) at the training shape, the
    same at 1 × 32,768, the bound from :func:`scan_bwd_work` at the
    training shape (the bytes against the chunked form both kernels run:
    its products at the TF32 tensor-core rate or, for wkv6, its
    sub-chunks' pair terms at the float32 rate, whichever takes longer;
    the per-shape log lines also give the serial form's operations at the
    float32 rate, ``serial_ops_ms``, for both),
    and the plain twin's ms at the training shape (B = 2, S = 4,096, one
    layer, float32); no PyTorch call computes it."""
    import torch
    from repro_torch.kernels import ops
    fn = getattr(ops, kernel)
    out = {}
    for tag, B, S in (("train", RTRAIN["batch"], RTRAIN["seq"]),
                      ("long", 1, RTRAIN["long_seq"])):
        args, cots, kw = scan_bwd_inputs(kernel, B, S, torch.bfloat16, dev,
                                         12)
        ckpt = scan_forward(kernel, args, checkpoints=True)[2]

        def call():
            return fn(*args, *cots, ckpt=ckpt, impl="cuda", **kw)

        ms, reps = time_ms_auto(call)
        # device ms a launch of the kernels and their second pass
        # (scan_bwd_sums launches a call)
        names = SCAN_BWD[kernel]["trace"]
        sums = scan_bwd_sums(kernel, B, S)
        by, complete, attempts = traced_launches(
            call, {**dict.fromkeys(names, 1), "scan_sum_kernel": sums})
        mains = {k: by[k] for k in names}
        n_sum, t_sum = by["scan_sum_kernel"]
        main_ms = {k: t / n if n else "not measured"
                   for k, (n, t) in mains.items()}
        sum_ms = t_sum / n_sum if n_sum else "not measured"
        traced = all(n for n, _ in mains.values()) and n_sum
        dev_ms = (sum(main_ms.values()) + sums * sum_ms if traced
                  else "not measured")
        nbytes, flop, chunked, simt = scan_bwd_work(kernel, args, cots)
        t_serial = flop / FP32_FLOP_PER_S * 1e3
        out[tag] = dict(ms=ms, reps=reps, device_ms=dev_ms,
                        kernel_device_ms=json.dumps(main_ms),
                        traced=json.dumps({k: n for k, (n, _) in
                                           mains.items()}),
                        second_pass_device_ms=sum_ms, second_passes=sums,
                        traced_passes=n_sum, trace_complete=complete,
                        trace_attempts=attempts, bytes=nbytes, flop=flop,
                        chunked_flop=chunked, simt_flop=simt,
                        bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                        operations_ms=max(chunked / TF32_FLOP_PER_S,
                                          simt / FP32_FLOP_PER_S) * 1e3,
                        serial_ops_ms=t_serial,
                        shape=list(args[0].shape))
        if tag == "train":
            f32 = [t.float() for t in args + cots]
            out[tag]["plain_ms"] = time_ms(
                lambda: fn(*f32, ckpt=None, impl="torch"), reps=1, warmups=0)
        del args, cots, ckpt, kw
        free_device_memory()
    t = out["train"]
    bound = max(t["bytes_ms"], t["operations_ms"])
    row = dict(name=kernel, route="cuda",
               source=f"src/repro_torch/kernels/csrc/"
                      f"{SCAN_BWD[kernel]['source']}",
               replaces=SCAN_BWD_REPLACES[kernel], launches=launches,
               max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
               bound_ms=bound,
               bound_by="operations" if t["operations_ms"] >= t["bytes_ms"]
               else "bytes", library_ms=None)
    for tag, r in out.items():
        log("25 kernel", name=kernel, at=tag, **r)
    log("25 kernel_row", **{k: v for k, v in row.items()
                            if k not in ("source", "replaces", "route")},
        device_ms=t["device_ms"], share_of_bound=bound / t["ms"],
        plain=f"the plain twin at B={RTRAIN['batch']} S={RTRAIN['seq']}, "
        "float32, one layer", library="none (no PyTorch call computes the "
        "scan's gradient)")
    return row


def scan_output_detached(orig):
    """Planted fault: the scan kernel's outputs with no autograd history,
    as the scans returned them on the card before their backward existed
    (Queue 3 item 8's fault, on the recurrent path)."""
    def fn(*a, **kw):
        return tuple(t.detach() for t in orig(*a, **kw))
    return fn


def plain_scans(cfg):
    """The plain path's patch: the family's scan with ``impl="torch"``."""
    from repro_torch.kernels import ops
    return patched(ops, SCAN_KERNEL[cfg.family],
                   lambda orig: functools.partial(orig, impl="torch"))


def scan_tap(orig, taps: dict, keep):
    """The scan as it is, recording the inputs of its calls number
    ``keep`` (the layers, in the forward's order) and, through a hook, the
    gradient of their output: ``taps[i] = ({"log_w": …} or {}, r, k, v,
    w, u, S0, do)`` (or ssd's)."""
    calls = [0]

    def fn(*a, **kw):
        out = orig(*a, **kw)
        i = calls[0]
        calls[0] += 1
        if i in keep:
            extra = {k: v.detach() for k, v in kw.items() if k == "log_w"}
            taps[i] = [extra] + [t.detach() if t is not None else None
                                 for t in a[:6]]
            out[0].register_hook(lambda g: taps[i].append(g.detach()))
        return out
    return fn


def grad_errors_to(got: dict, want: dict, dev) -> dict:
    """:func:`grad_errors` of host-held ``got`` against ``want`` on the
    card, a leaf at a time on the card."""
    return {k: grad_errors({k: got[k].to(dev)}, {k: want[k]})[k]
            for k in want}


def near_cancel_leaves(cfg, names) -> list:
    """The ``NEAR_CANCEL`` leaves of ``cfg``'s family among ``names``."""
    near = NEAR_CANCEL[cfg.family]
    pat = r"blocks\.\d+\.(%s)" % "|".join(map(re.escape, near))
    return sorted(k for k in names if re.fullmatch(pat, k))


def near_cancel_gate(params, batch, cfg, dev, paths: dict) -> dict:
    """Queue 3 item 9's gate: the step's gradients once in float32 through
    the kernels (``cfg`` with ``dtype="float32"``, the same weights and
    batch), and each bf16 path's error against them on the ``NEAR_CANCEL``
    leaves (``paths``: ``{"kernel": grads, "plain": grads, ...}``, those
    leaves' bf16 gradients on the host). Each leaf's kernel-path error is
    at most ``NEAR_CANCEL_F32_RATIO`` times the plain path's, or
    ``TRAIN_GRAD_REL["bfloat16"]``, whichever is larger. Returns ``{path:
    {leaf: error}}``."""
    import dataclasses
    t0 = time.perf_counter()
    leaves = sorted(paths["kernel"])
    full = step_gradients(params, batch,
                          dataclasses.replace(cfg, dtype="float32"),
                          False)[2]
    ref = {k: full[k] for k in leaves}
    del full
    free_device_memory()
    errs = {p: grad_errors_to(g, ref, dev) for p, g in paths.items()}
    del ref
    ek, ep = errs["kernel"], errs["plain"]
    floor = TRAIN_GRAD_REL["bfloat16"]
    lim = {k: max(NEAR_CANCEL_F32_RATIO * ep[k], floor) for k in leaves}
    over = {k: [ek[k], ep[k]] for k in leaves if ek[k] > lim[k]}
    worst = max(leaves, key=lambda k: ek[k] / lim[k])
    log("25 near_cancel_f32", arch=cfg.name, S=batch["tokens"].shape[-1],
        leaves=len(leaves), ratio=NEAR_CANCEL_F32_RATIO, floor=floor,
        **{f"{p}_worst": max(e.values()) for p, e in errs.items()},
        **{f"{p}_mean": sum(e.values()) / len(e) for p, e in errs.items()},
        kernel_over_plain_leaves=sum(ek[k] > ep[k] for k in leaves),
        worst_leaf=worst, worst_kernel=ek[worst], worst_plain=ep[worst],
        its_limit=lim[worst], leaves_over=json.dumps(over),
        seconds=time.perf_counter() - t0, ok=not over)
    assert not over, f"{cfg.name}: the kernel path strays from the " \
        f"float32 step past the plain path on {sorted(over)}"
    return errs


def recurrent_grad_gates(params, cfg, dev) -> None:
    """The step's gradients through the kernels against the plain path's
    (the scan with ``impl="torch"``, ``attn_impl="torch"``): bf16 on the
    full model at 1 × ``RTRAIN["gate_seq"]``, every leaf within 5e-2 but
    the ``NEAR_CANCEL`` leaves, which are held to ``NEAR_CANCEL_REL`` and
    logged as not meeting 5e-2; the backward kernel on the first and last
    layers' own inputs and output gradients of that step against its
    plain twin (1e-2: bf16 gradients against the float32 twin); the
    ``NEAR_CANCEL`` leaves of both bf16 paths against the same step in
    float32 (:func:`near_cancel_gate`); float32
    at ``RTRAIN["f32_layers"]`` layers (zamba2 with its shared block after
    the second, so that one site runs), every leaf within 1e-4, ``remat``
    within 1e-6 of none, and the scan's detached output (planted)
    caught."""
    import dataclasses
    import torch
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    tag = "25 train_grad_gate"
    data = SyntheticTokens(vocab_size=cfg.vocab_size,
                           seq_len=RTRAIN["gate_seq"], global_batch=1, seed=3)
    batch = data.batch(0, device=dev)
    plain_cfg = dataclasses.replace(cfg, attn_impl="torch")
    lim = TRAIN_GRAD_REL["bfloat16"]
    t0 = time.perf_counter()
    taps = {}
    scan = SCAN_KERNEL[cfg.family]
    with patched(ops, scan, lambda orig: scan_tap(
            orig, taps, (0, cfg.num_layers - 1))):
        got = {k: v.cpu() for k, v in step_gradients(params, batch, cfg,
                                                     False)[2].items()}
    t1 = time.perf_counter()
    bwd = getattr(ops, scan + "_bwd")
    for layer, (kw, *args, dout) in sorted(taps.items()):
        ckpt = scan_forward(scan + "_bwd", args, checkpoints=True)[2]
        kern = bwd(*args, dout, ckpt=ckpt, impl="cuda", **kw)
        twin = bwd(*(t if t is None else t.float() for t in args),
                   dout.float(), ckpt=None, impl="torch")
        errs = [tensor_rel(a, b) for a, b in zip(kern, twin)]
        names = SCAN_BWD_GRADS[scan + "_bwd"]
        log("25 path_input_gate", arch=cfg.name, kernel=scan + "_bwd",
            layer=layer, S=RTRAIN["gate_seq"],
            **{f"rel_{k}": e for k, e in zip(names, errs)},
            limit=SCAN_BWD_REL["bfloat16"],
            ok=max(errs) <= SCAN_BWD_REL["bfloat16"])
        assert max(errs) <= SCAN_BWD_REL["bfloat16"], (layer, errs)
        del ckpt, kern, twin
    del taps
    with plain_scans(cfg):
        want = step_gradients(params, batch, plain_cfg, False)[2]
    t2 = time.perf_counter()
    errs = grad_errors_to(got, want, dev)
    near = NEAR_CANCEL[cfg.family]
    waived = set(near_cancel_leaves(cfg, errs))
    paths = {"kernel": {k: got[k] for k in waived},
             "plain": {k: want[k].cpu() for k in waived}}
    del got, want
    limits = {k: NEAR_CANCEL_REL if k in waived else lim for k in errs}
    over = {k: errs[k] for k in errs if errs[k] > lim}
    rest = [k for k in errs if k not in waived]
    worst = max(errs, key=lambda k: errs[k] / limits[k])
    rworst = max(rest, key=errs.get)
    ok = all(errs[k] <= limits[k] for k in errs)
    log(tag, arch=cfg.name, dtype="bfloat16", S=RTRAIN["gate_seq"],
        leaves=len(errs), limit=lim, every_leaf_within_limit=not over,
        leaves_over_limit=json.dumps(over),
        others_worst_leaf=rworst, others_worst_rel=errs[rworst],
        near_cancel_kinds=json.dumps(near), near_cancel_leaves=len(waived),
        near_cancel_worst=max((errs[k] for k in waived), default=0.0),
        near_cancel_limit=NEAR_CANCEL_REL, worst_leaf=worst,
        worst_rel=errs[worst], its_limit=limits[worst], ok=ok,
        kernel_s=t1 - t0, plain_s=t2 - t1)
    assert ok, f"bf16 gradients stray: {worst} {errs[worst]}"
    free_device_memory()
    near_cancel_gate(params, batch, cfg, dev, paths)
    del paths
    free_device_memory()
    extra = ({"shared_attn_every": RTRAIN["f32_layers"]}
             if cfg.family == "hybrid" else {})
    f32 = dataclasses.replace(cfg, num_layers=RTRAIN["f32_layers"],
                              dtype="float32", **extra)
    small = init_params(f32, torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    with plain_scans(f32):
        want = step_gradients(small, batch, dataclasses.replace(
            f32, attn_impl="torch"), False)[2]
    got = step_gradients(small, batch, f32, False)[2]
    remat = step_gradients(small, batch, f32, True)[2]
    errs = grad_errors(got, want)
    rerr = grad_errors(remat, got)
    with patched(ops, SCAN_KERNEL[cfg.family], scan_output_detached):
        bad = grad_errors(step_gradients(small, batch, f32, False)[2], want)
    lim32 = TRAIN_GRAD_REL["float32"]
    worst, rworst, bworst = (max(e, key=e.get) for e in (errs, rerr, bad))
    log(tag, arch=cfg.name, dtype="float32", layers=f32.num_layers,
        shared_attn_every=f32.shared_attn_every, S=RTRAIN["gate_seq"],
        worst_leaf=worst, worst_rel=errs[worst], limit=lim32,
        ok=errs[worst] <= lim32, remat_worst_leaf=rworst,
        remat_worst_rel=rerr[rworst], remat_limit=TRAIN_GRAD_REL["remat"],
        remat_ok=rerr[rworst] <= TRAIN_GRAD_REL["remat"])
    log("25 train_grad_control", arch=cfg.name,
        fault="scan_output_detached", worst_leaf=bworst,
        worst_rel=bad[bworst], limit=lim32, caught=bad[bworst] > lim32)
    assert errs[worst] <= lim32, f"f32 gradients stray: {worst}"
    assert rerr[rworst] <= TRAIN_GRAD_REL["remat"], f"remat: {rworst}"
    assert bad[bworst] > lim32, "the float32 gate misses a detached scan"


def recurrent_step_launches(cfg) -> dict:
    """The launches a ``remat`` training step makes: the scan twice a layer
    (the forward and the recompute), its backward once; zamba2's shared
    sites' attention the same way."""
    L = cfg.num_layers
    scan = SCAN_KERNEL[cfg.family]
    want = {scan: 2 * L, scan + "_bwd": L, "flash_attention": 0,
            "flash_attention_bwd": 0}
    if cfg.family == "hybrid":
        sites = L // cfg.shared_attn_every
        want.update(flash_attention=2 * sites, flash_attention_bwd=sites)
    return want


def phase_recurrent_train_arch(arch: str, dev) -> dict:
    """One recurrent architecture trained at full width and depth (bf16
    compute, float32 master weights, AdamW with weight decay 0.1,
    ``remat``, ``SyntheticTokens`` at ``RTRAIN``'s shape): the first
    step's gradients byte-equal in two runs, the gradient gates on the
    initial weights, 4 steps with their numbers and launches, one more
    step traced. Returns the backward kernel's launches over the 4
    steps."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.training import (AdamWConfig, TrainStepConfig,
                                      make_train_step)
    from repro_torch.training.train_step import init_train_state
    t0 = time.perf_counter()
    cfg = get_config(arch)
    B, S = RTRAIN["batch"], RTRAIN["seq"]
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    n_params = sum(p.numel() for p in state["params"].parameters())
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=S,
                           global_batch=B, seed=0)
    first = data.batch(0, device=dev)
    # two runs of the first step's gradients: the same bytes (the first
    # kept on the host)
    g1 = {k: v.cpu() for k, v in step_gradients(state["params"], first, cfg,
                                                True)[2].items()}
    g2 = step_gradients(state["params"], first, cfg, True)[2]
    equal = all(torch.equal(g1[k], g2[k].cpu()) for k in g1)
    log("25 repeat_gradients", arch=arch, leaves=len(g1), remat=True,
        byte_equal=equal)
    assert equal, f"{arch}: the first step's gradients differ run to run"
    del g1, g2
    # the gradient gates on these initial weights, a state that no kernel
    # under test produced: trained through the backward under test, the
    # state and the leaves that nearly cancel in it follow that kernel's
    # last bits (ROADMAP.md Queue 3 item 10)
    recurrent_grad_gates(state["params"], cfg, dev)
    free_device_memory()
    opt = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=100,
                      weight_decay=0.1)
    step = make_train_step(cfg, TrainStepConfig(opt=opt, remat=True))
    free_device_memory()
    sync()
    want = recurrent_step_launches(cfg)
    ops.reset_launch_counts()
    runs = []
    for i in range(RTRAIN["steps"]):
        batch = data.batch(i, device=dev)
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        sync()
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        sec = time.perf_counter() - t1
        after = ops.launch_counts()
        runs.append(dict(step=i, loss=float(metrics["loss"]),
                         grad_norm=float(metrics["grad_norm"]), seconds=sec,
                         tokens_per_s=B * S / sec,
                         peak_mem_bytes=torch.cuda.max_memory_allocated(),
                         **{k: after[k] - before[k] for k in want}))
        log("25 train_step", arch=arch, **runs[-1])
    launches = ops.launch_counts()
    routes = dict(ops.BWD_ROUTES)
    log("launches", path=f"recurrent_training_{arch}", **launches)
    log("25 backward_routes", arch=arch, **routes)
    for r in runs:
        assert {k: r[k] for k in want} == want, (r, want)
        assert all(map(lambda x: x == x and abs(x) < float("inf"),
                       (r["loss"], r["grad_norm"]))), r
    n = RTRAIN["steps"]
    assert routes == {"wgmma": want["flash_attention_bwd"] * n, "simt": 0}, \
        f"the attention backward left the tensor-core route: {routes}"
    peak = max(r["peak_mem_bytes"] for r in runs)
    later = runs[1:]
    log("25 train_summary", card=repr(card_name_power()), arch=arch,
        batch=B, seq=S, params=n_params, remat=True,
        s_a_step=sum(r["seconds"] for r in later) / len(later),
        tokens_per_s=sum(r["tokens_per_s"] for r in later) / len(later),
        first_step_s=runs[0]["seconds"], peak_mem_bytes=peak,
        under_80gb=peak < 80e9, losses=[r["loss"] for r in runs],
        launches_a_step=json.dumps(want))
    assert peak < 80e9, peak
    # one more step under the profiler: where its time goes
    out = {}

    def traced():
        out["state"] = step(state, data.batch(n, device=dev))

    wall, busy, n_k, by_kernel, top = device_busy_ms(traced, by_kernel=True)
    state = out["state"][0]
    del out
    scan = SCAN_KERNEL[cfg.family]
    bwd = scan + "_bwd"
    # the scans' device ms a step: each kernel's ms a traced launch times
    # its launches a step (a trace can drop a ctypes launch)
    per_step = {scan + "_kernel": want[scan],
                **dict.fromkeys(SCAN_BWD[bwd]["trace"], want[bwd]),
                "scan_sum_kernel": want[bwd] * scan_bwd_sums(bwd, B, S)}
    caught = {k: by_kernel.get(k, (0, 0.0)) for k in per_step}
    scan_ms = (sum(t / n * per_step[k] for k, (n, t) in caught.items())
               if all(n for n, _ in caught.values()) else "not measured")
    log("25 profile", arch=arch, wall_ms=wall, device_busy_ms=busy,
        idle_share=1.0 - busy / wall if wall else "not measured",
        kernels=n_k, scan_kernels_ms=scan_ms,
        scan_launches_traced=json.dumps({k: n for k, (n, _) in
                                         caught.items()}),
        scan_launches_a_step=json.dumps(per_step),
        scan_share_of_busy=(scan_ms / busy if busy and
                            not isinstance(scan_ms, str)
                            else "not measured"),
        port_kernels=json.dumps(by_kernel), top_kernels=json.dumps(top))
    del state
    log("25 arch_done", arch=arch, seconds=time.perf_counter() - t0,
        **free_device_memory())
    return {scan + "_bwd": launches[scan + "_bwd"]}


def phase_recurrent_training(dev) -> list:
    """Phase 25: the scans' backward kernels against their plain twins
    (float32 at 1 × 4,096 and 2 × 33 from a nonzero state, bf16 at the
    training shape against the float32 twin, repeats byte-equal, a planted
    dropped state gradient), the forwards' no-grad bytes against the
    checkpointing launch, then rwkv6-3b and zamba2-1.2b trained at full
    width and depth (:func:`phase_recurrent_train_arch`), and the two
    kernels' rows."""
    import torch
    t0 = time.perf_counter()
    log("25 device", card=repr(card_name_power()))
    errs = {}
    for kernel in SCAN_BWD:
        errs[kernel] = max(
            scan_bwd_gate(kernel, 1, RTRAIN["seq"], "float32", dev, seed=1),
            scan_bwd_gate(kernel, 2, 33, "float32", dev, seed=2))
        scan_bwd_gate(kernel, RTRAIN["batch"], RTRAIN["seq"], "bfloat16",
                      dev, seed=3)
        scan_fwd_bytes_equal(kernel, dev)
        free_device_memory()
    launches = {}
    for kernel, c in SCAN_BWD.items():
        torch.cuda.reset_peak_memory_stats()
        launches.update(phase_recurrent_train_arch(c["arch"], dev))
    rows = [scan_bwd_row(k, launches[k], errs[k], dev) for k in SCAN_BWD]
    log("25 done", seconds=time.perf_counter() - t0, **free_device_memory())
    return rows


# the port's CUDA kernels by their function names in a trace
PORT_KERNELS = ("fa_wgmma_kernel", "flash_attention_kernel",
                "dkdv_wgmma_kernel", "dq_wgmma_kernel", "bwd_prep_kernel",
                "dkdv_kernel", "dq_kernel", "delta_kernel",
                "frog_step_stream_kernel", "frog_step_kernel",
                "frog_superstep_stream_kernel", "frog_superstep_kernel",
                "frog_hop_stream_kernel", "frog_hop_kernel",
                "frog_segment_walk_kernel", "frog_segment_masks_kernel",
                "frog_count_kernel", "stitch_gather_local_kernel",
                "stitch_step_local_kernel", "stitch_gather_rounds_kernel",
                "stitch_gather_local_rounds_kernel",
                "stitch_step_rounds_kernel", "stitch_gather_kernel",
                "stitch_step_kernel", "spmv_ell_kernel",
                "threefry_draw_kernel", "threefry_randint_kernel",
                "threefry_split_kernel", "threefry_fold_in_kernel",
                "wkv6_scan_kernel", "ssd_scan_kernel", "wkv6_bwd_dh_kernel",
                "wkv6_bwd_chunk_kernel",
                "ssd_bwd_dh_kernel", "ssd_bwd_chunk_kernel",
                "scan_sum_kernel")


def port_kernel_times(events) -> dict:
    """``{kernel: [launches, device ms]}`` of the port's kernels among a
    trace's kernel events (the first name of ``PORT_KERNELS`` that a
    traced name contains)."""
    out = {}
    for e in events:
        name = next((k for k in PORT_KERNELS if k in e.get("name", "")),
                    None)
        if name is not None:
            n, ms = out.get(name, (0, 0.0))
            out[name] = [n + 1, ms + float(e.get("dur", 0)) / 1e3]
    return out


def top_kernels(events, k: int = 5) -> list:
    """The ``k`` kernels of a trace with the most device time:
    ``[name (cut to 90 characters), launches, device ms]``."""
    by = {}
    for e in events:
        n, ms = by.get(e.get("name", ""), (0, 0.0))
        by[e.get("name", "")] = (n + 1, ms + float(e.get("dur", 0)) / 1e3)
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:k]
    return [[name[:90], n, ms] for name, (n, ms) in top]


def device_busy_ms(fn, by_kernel: bool = False, stages=None) -> tuple:
    """``(wall ms, device-busy ms, kernels)`` of one ``fn()``: the union of
    the kernel intervals ``torch.profiler`` traced (CUPTI sees the ctypes
    launches too), against the host's clock; with ``by_kernel``, also
    :func:`port_kernel_times` and :func:`top_kernels` of the trace, and
    with ``stages`` (``record_function`` names, maybe none) those and
    :func:`stage_ms`."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if stages is not None:
        return (wall, busy / 1e3, len(spans), port_kernel_times(kernels),
                top_kernels(kernels), stage_ms(events, stages))
    if by_kernel:
        return (wall, busy / 1e3, len(spans), port_kernel_times(kernels),
                top_kernels(kernels))
    return wall, busy / 1e3, len(spans)


def stage_ms(events, stages) -> dict:
    """Device ms by stage from a trace's events: ``attention`` (the port's
    ``flash_attention`` kernels, by name), each of ``stages`` (the kernels
    whose launch, by its correlation id, lies inside a
    ``record_function`` range of that name on the launching thread; the
    innermost range wins) and ``other`` (the rest); and ``attention@s``
    for the attention kernels launched inside stage ``s``, where any
    are."""
    ranges = [(e.get("tid"), float(e["ts"]),
               float(e["ts"]) + float(e.get("dur", 0)), e["name"])
              for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in stages]
    launches = {e["args"]["correlation"]: (e.get("tid"), float(e["ts"]))
                for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = dict.fromkeys(("attention", *stages, "other"), 0.0)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ms = float(e.get("dur", 0)) / 1e3
        stage = "other"
        where = launches.get(e.get("args", {}).get("correlation"))
        if where is not None:
            inside = [r for r in ranges
                      if r[0] == where[0] and r[1] <= where[1] <= r[2]]
            if inside:
                stage = min(inside, key=lambda r: r[2] - r[1])[3]
        if any(k in e.get("name", "") for k in ("fa_wgmma_kernel",
                                                 "flash_attention_kernel")):
            out["attention"] += ms
            if stage != "other":
                key = "attention@" + stage
                out[key] = out.get(key, 0.0) + ms
            continue
        out[stage] += ms
    return out


def phase_profile(svc, stream_svc, loop_svc, erasure_svc, g):
    """Where a batch run (resident and streamed), an index build (resident
    and streamed, 8 build shards), a dense serving wave, a loop wave over 8
    shards, one ``query_counts``, the ELL power iteration and the
    quickstart's erasure run spend their time."""
    from repro_torch import prng
    from repro_torch.core import power_iteration
    from repro_torch.kernels import ops
    from repro_torch.query.engine import plan_query, query_counts
    from repro_torch.query.index import _build_walk_index
    index, sc = svc.ensure_index(), svc.config.serving
    plan = plan_query(10, 0.3, 0.1, p_T=svc.config.p_T,
                      max_steps=sc.max_steps,
                      segments_per_vertex=index.segments_per_vertex,
                      segment_len=index.segment_len)
    # one launch of each path's rounds kernel, and no per-round kernel
    rounds_kernel = {"loop_wave": ("stitch_gather_local_rounds_kernel",
                                   "stitch_gather_local_kernel"),
                     "query_counts": ("stitch_step_rounds_kernel",
                                      "stitch_step_kernel")}
    # one launch a draw, and no draw of the slot offsets
    L = index.segment_len
    draws_of = {"wave": wave_draws(L), "loop_wave": wave_draws(L),
                "query_counts": wave_draws(L, scheduled=False)}
    for what, fn in (
            ("pagerank", lambda: svc.pagerank(epsilon=0.1, delta=0.1,
                                              k=100)),
            ("pagerank_stream", lambda: stream_svc.pagerank(
                epsilon=0.1, delta=0.1, k=100)),
            ("index_build", lambda: _build_walk_index(
                g, svc.config.walk_index())),
            ("index_build_stream", lambda: _build_walk_index(
                g, stream_svc.config.walk_index(),
                blocked=stream_svc.blocked_csr())),
            ("wave", lambda: (svc.topk(k=10, epsilon=0.3), svc.step())),
            ("loop_wave", lambda: (loop_svc.topk(k=10, epsilon=0.3),
                                   loop_svc.step())),
            ("query_counts", lambda: query_counts(
                g, index, plan, prng.PRNGKey(7, g.device),
                p_T=svc.config.p_T)),
            ("power_iteration_ell", lambda: power_iteration(
                g, num_iters=50, spmv="ell")),
            ("erasure_quickstart", lambda: erasure_svc.pagerank(seed=0))):
        ops.reset_launch_counts()
        wall, busy, kernels, by_name, top = device_busy_ms(fn,
                                                           by_kernel=True)
        draws = {k: v for k, v in ops.launch_counts().items()
                 if k in ops.DRAW_KERNELS and v}
        log("13 profile", what=what, wall_ms=wall,
            device_busy_ms=busy if kernels else "not measured",
            idle_share=1 - busy / wall if kernels else "not measured",
            kernels=kernels, port_kernels_launches_ms=json.dumps(by_name),
            draw_launches=json.dumps(draws))
        if what in draws_of:
            assert draws == draws_of[what], (what, draws)
        if what == "power_iteration_ell":
            log("13 profile_top", what=what,
                top5_name_launches_ms=json.dumps(top))
        if what in rounds_kernel:
            one, per_round = rounds_kernel[what]
            assert by_name.get(one, (0,))[0] == 1 and per_round not in \
                by_name, (what, by_name)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(SRC, "repro_torch", "__init__.py")):
        print(f"chip_smoke: the port is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    # float32 products in full float32 (the LM gates compare float32
    # logits at 1e-3); both defaults stated, not assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import FrogWildService, RuntimeConfig
    from repro_torch.kernels import ops

    t_all = time.perf_counter()
    name, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    g = phase_data(dev)
    svc = FrogWildService.open(g, RuntimeConfig())
    # slice 1's path: batch estimate, walk index, serving
    ops.reset_launch_counts()
    res, pi = phase_batch(svc, dev)
    index, hubs, results = phase_serving(svc, pi, dev)
    launches = ops.launch_counts()
    log("launches", path="dense", **launches)
    missing = [k for k in ("frog_superstep", "frog_segment_walk",
                           "frog_count",
                           "stitch_gather_rounds", "stitch_step_rounds",
                           "threefry_randint", "threefry_uniform",
                           "threefry_split", "threefry_fold_in")
               if launches[k] < 1]
    assert not missing, f"kernels never launched on the main path: {missing}"
    # query_counts' rounds and their tally in one launch, none a round
    assert launches["stitch_step_rounds"] == 1, launches
    assert launches["stitch_step"] == 0, launches
    # one launch a superstep (t = 32) and a segment walk of each build
    # shard, its L hops in it
    sc = svc.config.serving
    assert launches["frog_superstep"] == 32, launches
    assert launches["frog_segment_walk"] == sc.build_shards, launches
    assert launches["frog_hop"] == 0, launches
    phase_plain(svc, res, index, hubs, dev)
    # the streamed batch estimate and sharded serving
    ops.reset_launch_counts()
    stream_svc = phase_stream(g, res, pi, dev)
    sharded = phase_sharded(g, index, results, hubs, dev)
    launches2 = ops.launch_counts()
    log("launches", path="stream_sharded", **launches2)
    missing = [k for k in ("frog_superstep_stream_sorted",
                           "frog_hop_stream_sorted", "frog_segment_masks",
                           "stitch_gather_local_rounds",
                           "stitch_gather_rounds", "frog_count")
               if launches2[k] < 1]
    assert not missing, f"kernels never launched on the path: {missing}"
    # the loop wave's rounds in one launch a wave, none a shard and round
    assert launches2["stitch_gather_local_rounds"] == \
        sharded["loop"].scheduler.stats().waves_run, launches2
    assert launches2["stitch_gather_local"] == 0, launches2
    # one launch a streamed superstep (t = 32) and a hop of each build shard
    ssc = sharded["fused"].config.serving
    assert launches2["frog_superstep_stream_sorted"] == 32, launches2
    assert launches2["frog_hop_stream_sorted"] == \
        ssc.build_shards * ssc.segment_len, launches2
    # the hops write no mask row: one mask pass a build shard
    assert launches2["frog_segment_masks"] == ssc.build_shards, launches2
    phase_lost_wave(sharded, hubs, dev)
    phase_faults(g, sharded, results, hubs, dev)
    log("17 peak", peak_mem_bytes_so_far=torch.cuda.max_memory_allocated())
    # dynamic graphs: mutations, refresh and the epoch commit
    dyn_launches = phase_dynamic(g, index, sharded, results, hubs, dev)
    log("18 peak", peak_mem_bytes_so_far=torch.cuda.max_memory_allocated())
    # the serving gateway over phase 5's graph
    t0 = time.perf_counter()
    phase_gateway(g, index, res, pi, hubs, dev)
    held = torch.cuda.memory_allocated()
    # a parent handle and its joiners reference each other, and through
    # their schedulers the closed gateways' indexes: collect them now
    # rather than at the next full collection, inside the LM phases
    gc.collect()
    log("19 done", seconds=time.perf_counter() - t0,
        allocated_before_collect=held,
        allocated_after_collect=torch.cuda.memory_allocated(),
        peak_mem_bytes_so_far=torch.cuda.max_memory_allocated())
    for k, v in dyn_launches.items():
        launches[k + ":masks"] = v
    for k in ("frog_step_stream_sorted", "frog_superstep_stream_sorted",
              "frog_hop_stream_sorted", "frog_segment_masks",
              "stitch_gather_local",
              "stitch_gather_local_rounds", "stitch_step_local"):
        launches[k] = launches2[k]
    peak = torch.cuda.max_memory_allocated()
    # the quickstart's erasure walks and the GraphLab-PR baseline
    ops.reset_launch_counts()
    erasure_svc, t, erasure_runs, erasure_peak = phase_erasure(g, pi)
    ell = phase_graphlab(g, pi)
    launches3 = ops.launch_counts()
    log("launches", path="erasure_graphlab_pr", **launches3)
    assert launches3["spmv_ell_slab"] == 50, launches3
    assert launches3["frog_count"] >= 1, launches3
    assert launches3["threefry_bernoulli"] >= 1, launches3
    launches["spmv_ell_slab"] = launches3["spmv_ell_slab"]
    # a draw kernel's launches: its count over the three paths' runs
    for k in ops.DRAW_KERNELS:
        launches[k] += launches2[k] + launches3[k]
    phase_figure1(g, pi, ell, erasure_runs, t)
    phase_erasure_cpu()
    # the LM stack: llama3.2-1b's 32k prefill forward, its serving loop,
    # and the reduced model's tokens against the CPU's
    from repro_torch.configs.registry import get_config, reduced_config
    lm_cfg = get_config(LM_ARCH)
    params, inputs, fa_launches, lm_peak, _ = phase_lm_prefill(lm_cfg, dev)
    state, cur = phase_lm_serve(params, lm_cfg, dev)
    phase_lm_cpu(reduced_config(lm_cfg), dev)
    rows = kernel_rows(svc, index, hubs, launches, dev,
                       stream_svc.blocked_csr(),
                       sharded["fused"].ensure_index(), ell, pi)
    rows.append(flash_attention_row(fa_launches, lm_cfg, dev))
    phase_profile(svc, stream_svc, sharded["loop"], erasure_svc, g)
    phase_lm_profile(params, lm_cfg, inputs, state, cur)
    for s in (svc, stream_svc, erasure_svc, *sharded.values()):
        s.close()
    # the MoE family, once the llama model and the FrogWild! tensors are
    # gone
    peak = max(peak, erasure_peak, lm_peak, torch.cuda.max_memory_allocated())
    del (params, inputs, state, cur, svc, stream_svc, erasure_svc, sharded,
         index, res, pi, results, hubs, ell, erasure_runs, g, s)
    log("20 released", **free_device_memory())
    torch.cuda.reset_peak_memory_stats()
    moe_peak = phase_moe(dev)
    # the recurrent families, once the MoE models are gone
    torch.cuda.reset_peak_memory_stats()
    rows.extend(phase_recurrent(dev))
    peak = max(peak, moe_peak, torch.cuda.max_memory_allocated())
    # the encoder-decoder and VLM families, once the recurrent models are
    # gone
    torch.cuda.reset_peak_memory_stats()
    rows.extend(phase_encdec(dev))
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    rows.extend(phase_vlm(dev))
    # training, once the VLM is gone
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    rows.extend(phase_training(dev))
    # the recurrent families' training, once llama is gone
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    rows.extend(phase_recurrent_training(dev))
    log("done", seconds=time.perf_counter() - t_all,
        peak_mem_bytes=max(peak, torch.cuda.max_memory_allocated()))
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
