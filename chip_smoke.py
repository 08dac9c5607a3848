#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):

  1. device and build: the card's name and power limit, then the seven CUDA
     sources built from ``src/repro_torch/kernels/csrc`` (one nvcc each, in
     parallel, into the gitignored ``build/`` directory), and the registers,
     spills and shared memory of the tensor-core flash kernels (the forward
     and the backward pair) per head-dim class (no spills allowed at d = 64)
     and of every fused top-k, pair-tile and hybrid-distance kernel (no
     spills allowed), with the pair tiles' blocks an SM;
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main path's shapes (Dd = 1024, the corpus caps, B x C of
     NN-Descent and refinement chunks and inits, search rounds, and the
     fp32 served rounds over a 2^18-row segment) plus edge cases (all-PAD
     rows, k > live, planted ties); the int8 variants over an int8 segment
     of 2^18 rows at the shapes a served bucket of 32 requests over a group
     of four segments gives them (128 rows, one search) and at a
     large shape, with a zero row and a row at +-127 among the candidates;
     max-abs-error, agreement up to ties, two launches bit-identical, times
     (CUDA events, and the kernels' device time with the host out of the
     timed span, which a host-bound call's event timing hides) and bounds;
     the hybrid distance also at a per-path norm launch (B 65,536, C 1) and
     the fp32 served shapes; the pair tiles bounded at the TF32 rate (3
     products per fp32 product, the 3xTF32 route); then each kernel at the
     write path's shapes, caught from a real insert of 64 docs into a grow
     segment of 192 (the probe's entry scoring, rounds and re-score,
     NN-Descent among the new nodes, self scores B 64 C 1, the 64-node prune
     chunk's re-ranks and pair tiles at K = knn.k);
  3. small end-to-end: N = 4096 docs with the KG, built and searched once
     through the kernels and once through the plain versions;
  4. full width: make_corpus at N = 2^20, d_dense = 1024, build_index with
     the default BuildConfig (no KG: the dense (E, E) entity adjacency would
     be ~1 TB), its fused top-k launches by build stage, search 1024 queries
     under six fusion specs, QPS and recall; then one descent round chunk
     and one refinement round chunk as the build hands them to the fused
     top-k (built by knn_graph._descent_round_chunk from this graph), their
     live pairs and unique rows, checked and timed beside phase 2's uniform
     ids; the first prune chunk's pair tiles (knn_ids[0:1024], clamped) with
     its unique rows and bounds; and the build's first 16 prune chunks
     (pruning._prune_chunk, caught during the build) replayed, bare and under
     torch.profiler: wall time, device busy time and pairwise_tile's share;
  5. serving at full width: the same corpus as four sealed segments of 2^18
     (build_pool_segment + append_segment, one fp32 group) and its int8
     twin, each served through HybridSearchService (default ServiceConfig)
     under three-path, RRF and keyword-constrained specs: QPS, p50/p99
     request latency, recall@10 against brute force over all 2^20 docs,
     nDCG@10, the index-bytes gauges, compiles, and the launches of every
     kernel variant while each pool served (each pool must run its own
     variants and not the other's); then int8 storage against fp32 apart
     from the graph: brute-force top-10 overlap and the score gap against
     the gap the format allows, with planted faults that must fail;
  13. the index side over a device mesh of one card (run after phase 5,
     before phase 8): an NCCL process group of world 1 in this process
     (an in-process store; the NCCL version printed), a (1, 1, 1)
     ("pod", "data", "model") mesh; over phase 5's fp32 group and its int8
     twin, under phase 5's three-path, RRF and keyword specs: (a) the
     sharded search (make_distributed_search_padded on the rank's block)
     against the local pass (make_local_group_search) on 1,024 queries,
     ids and expanded equal, scores and path scores within 1e-6; (b) a
     mesh-fronted HybridSearchService over the SegmentedIndex answering
     phase 5's requests with the ids of phase 5's pool service, both QPS
     printed beside the card; (c) build_index_sharded over the first 2^18
     docs as 4 segments against build_segmented_index with the same seeds,
     every array bit-equal, both times printed; (d) one
     make_distributed_descent_round over a 2^16 segment against
     _descent_round_chunk, bit-equal; (e) two planted faults (one
     segment's global ids rotated, one segment's results dropped before
     the merge) that must each fail (a)'s comparison; the refusals (a
     mesh of another world size, a cpu mesh on the nccl group, a cpu
     tensor in a cuda collective); (f) the launches of each kernel on
     these paths, each > 0, added to the kernels line; the group is
     destroyed at the end;
  8. the write path at full width (run after phase 5, before phase 6):
     phase 5's int8 pool served with a SegmentRouter attached (default
     RouterConfig), a writer thread upserting 2048 sealed docs in 32 batches
     of 64 (delete by global id, re-insert the fp32 vectors under a fresh id)
     with 8 batches of further deletes between them, and reader threads
     submitting phase 5's queries through the pump: insert docs/s and p50 /
     p99 per call, delete p50, compactions and merges with their seconds,
     the groups at the end, QPS and p50 / p99 under writes, the sealed key's
     survival, build_rows against the rows inserted, compacted and merged,
     launches by variant, recall@10 against brute force over the live docs;
     gates: read-your-writes after each insert and after the merges (at
     least 0.90 of all re-inserted docs reached from their segment's entry
     points in its graph, a breadth-first walk no search computes, where
     the reference's own graphs reach 0.92-0.96; at least
     0.99 of the docs their segments' own search finds returned by the
     service under the new id, never the old one; the service's share of
     all printed by holding capacity beside a control of untouched sealed
     docs), no deleted id in a result of a request submitted after its
     delete returned, save_pool -> load_pool giving the same ids and scores
     bitwise, and three planted faults (no grow merge, an insert without
     back-links, no sealed tombstones) that must each fail one of them;
  6. RAG at full width: llama3.2-1b (16 layers, d_model 2048, bf16, random
     weights from a seed) with flash attention behind RagPipeline, retrieving
     through HybridSearchService over phase 4's 2^20-doc index: 64 requests
     of 4 retrieved docs x 256 context tokens + a 64-token prompt (prefill
     L = 1088), 64 tokens generated greedily. First the flash kernel against
     its plain version at the RAG shape (bf16 through the tensor-core route,
     two launches bit-identical, and fp32 on 4 rows) and at edge shapes, with
     its time, bound and the scaled_dot_product_attention call's time; then
     the main path (retrieval, prefill and decode times, 16 flash launches
     per prefill), retrieval through the service against direct search,
     finite prefill logits, and flash prefill against naive prefill on 8
     rows, with two planted faults that must fail that check;
  7. training at full width: llama3.2-1b (16 layers, d_model 2048, bf16,
     remat full, random weights from a seed) with flash attention through
     make_train_step, on TokenPipeline batches of 8 x 2048 tokens, AdamW
     (lr 3e-4, 2 warm-up steps): first the forward kernel at the training
     shape (bf16, checked on 2 rows, timed beside its plain version on 2
     rows, the scaled_dot_product_attention forward and its bound), then the
     two backward kernels against their plain version there (bf16, the
     tensor-core route: timed beside the plain version and the
     scaled_dot_product_attention backward, whose kernels are named;
     repeated launches bit-identical; fp32 on 2 rows, timed on the CUDA-core
     route) and at edge shapes; then one warm-up step, profiled inside an
     idle frame of 0.25 s on each side (32 launches of the tensor-core
     forward and 16 of each tensor-core backward kernel by symbol, none of
     the CUDA-core ones; one more step profiled without the frame is
     printed beside it), and 8 timed steps
     (seconds, tokens/s, loss, grad norm, lr, peak memory, and exactly 32 /
     16 / 16 forward / dQ / dK-dV launches per step), a first loss near
     ln(vocab) and a last one below it; then the loss gradients through
     flash against naive on 2 rows, with three planted faults in the
     backward that must each fail that check;
  10. the dense and moe configs at full width (run after phase 6, while
     phase 4's index lives; everything freed before phase 7), random
     weights from a seed: qwen2-1.5b whole (QKV bias) through RagPipeline at
     phase 6's batch; deepseek-v3-671b cut to 4 layers (3 dense MLA layers,
     1 MoE layer of 256 experts, the MTP head) and kimi-k2-1t-a32b cut to 2
     (1 dense, 1 MoE layer of 384 experts, GQA 64 / 8 at head_dim 112)
     through RagPipeline over phase 4's index at 16 requests; deepseek-7b
     and starcoder2-15b whole, one prefill of 8 x 1088 and 16 decode steps:
     parameter bytes, peak memory, retrieval / prefill / decode seconds and
     tokens/s, per MoE layer of the prefill the assignments dropped, the
     largest and mean expert load and the aux loss, flash launches; gates,
     each with a planted fault that must fail it: (a) prefill logits through
     flash against naive on 8 rows (fault: MLA at scale hd ** -0.5), (b)
     greedy decode against the full forward over the first 4 generated
     tokens at a capacity that drops nothing (fault: decode without RoPE),
     (c) the MoE dispatch against a per-token loop on 256 tokens (fault:
     gates not renormalised), (d) the first flash-forward call of each
     model's prefill, caught on the path, against the plain version on 8
     rows (out by max |diff| / max |out|, the LSE by max |diff|; faults:
     the last keys dropped, a non-causal call made causal), bit-identical
     twice, timed and recorded among the kernel's checks; then one
     training step of the deepseek-v3 and kimi-k2 smoke configs (bf16,
     flash, AdamW) with its flash launches;
  11. the recurrent families at full width (after phase 10, while phase 4's
     index lives), random weights from a seed: rwkv6-7b (32 RWKV6 layers,
     d_model 4096, 64 WKV heads of 64) and zamba2-1.2b (38 Mamba2 layers,
     the shared attention block after every 6) whole through RagPipeline at
     phase 6's batch (L = 1088, 17 chunks of 64): parameter bytes, retrieval
     / prefill / decode seconds and tokens/s, peak memory, the recurrent
     state's bytes, the chunked scan's share of the prefill (the first
     layer's scan call caught and timed alone); the first flash call of
     zamba2's prefill against the plain version, timed and recorded among
     the kernel's checks; gates, each with a planted fault that must fail
     it: (d) the state's bytes equal after the prefill, after 64 decode
     steps and at two max_lens, written in place (fault: a state kept per
     position); on fp32 copies of the weights, the bf16 readings printed
     beside: (a) each recurrent block of a forward over 2 rows, chunked
     scan against the per-step recurrence on the same input (fault: the
     carry across chunks dropped), (b) a prefill of 1088 and 64 decode
     steps against one prefill of 1152 (fault: the token-shift / conv
     state zeroed between steps), (c) zamba2's flash prefill against naive
     on 8 rows (phase 6's two faults); then one
     training step of zamba2 at full width (4 x 2048 tokens, remat full:
     12 / 6 / 6 flash forward / dQ / dK-dV launches) and of each recurrent
     smoke config;
  12. the vlm and audio families at full width (after phase 4's index is
     freed, before phase 7), random weights and stub frontends
     (normal(0, 0.02)) from a seed: llama-3.2-vision-90b cut to 4 of its 20
     groups (16 self + 4 cross-attention layers, 19.2 B parameters) at 8
     prompts of 1,088 tokens over 1,600 patch embeddings each and 16 decode
     steps; whisper-large-v3 whole (32 + 32 layers) at 64 requests of 1,500
     frames, a 4-token prompt and 64 greedy tokens; both through
     ServingEngine.generate(..., frontend=): encoder / prefill / decode
     seconds, the cross cache's bytes, peak memory, flash launches (20 and
     96 a prefill); gates, each with a planted fault that must fail it:
     (a) every attention call of a prefill on 8 rows, flash against naive,
     read call by call (the vlm's unnormalised frontend moves its logits by
     ~1e-4; faults in the cross calls: made causal, the last 64 keys
     dropped), (b) a prefill and 16 teacher-forced decode steps against one
     forward, logits and each cross-attention output (fault: decode reads
     the next layer's cross cache), and decode leaving the cross cache as
     the prefill wrote it, (c) the cross cache's bytes against its shapes
     (the fault checks the measurement), (d) the first flash call of each
     kind against the plain version as in phase 10 (in bf16, the only gate
     that can see a wrong tail at whisper's S = 1,500), timed beside SDPA
     and recorded among the kernel's checks; (a) and (b) held in bf16 for the vlm, on fp32
     copies for whisper; then one training step of whisper at full width (8
     x 448 decoder tokens over 1,500 frames, remat full: 192 / 96 / 96
     flash forward / dQ / dK-dV launches, the first backward of each kind
     held against the plain version) and of each vlm / audio smoke config;
  9. the text path and the replica tier (run last; ROADMAP Queue 3 says
     why not after phase 8):
     65,536 SynCorpus docs (fig14's 100,000 cut to fit the script's
     time) through IngestPipeline (d_dense 1024, fit on
     a strided 2,048), sharded by the consistent-hash ring (512 virtual
     nodes) into R = 4 replicas and into R = 1, each shard sealed every 256
     rows into pooled segments with the KG, each replica a
     HybridSearchService and a SegmentRouter behind a ReplicaRouter
     (benchmarks/fig14_scale.py's build_tier): ingest and build seconds,
     isolated, model and tier QPS with p50 / p99, scaling efficiency,
     recall@10 against brute force, one batch under adaptive fusion with the
     KG on; the path's launches read by part (builds, reads, the KG read,
     streamed inserts; each zeroed just before it); gates, each with a
     planted fault that must fail it: (1)
     placement against a ring the script computes with hashlib, (2) the
     merge against the script's own merge of the replicas' results, (3) a
     tier and one service over the first 512 docs, searched exhaustively,
     equal up to ties, (4) degraded reads (mark_down, down_replicas, the
     counter, fail_on_partial, bit-identical after mark_up), (5) 2,048
     further docs streamed through stream_into in 8 batches of 256 (ids
     contiguous, each on its home's grow segment, read-your-writes as in
     phase 8) and 1,024 deletes, (6) save_pool with the fitted pipeline and
     load_ingest bit for bit, (7) every kernel call caught on the main path
     (the first segment build's stages, one read at R = 4 and at R = 1, one
     KG read) against its plain version, with error, two launches
     bit-identical, times and bound, and the fp32 kernels launched in each
     part (a tier reading through the plain versions fails), the int8 ones
     in none, (8) the bundled text corpus: hybrid recall@10 no lower than
     dense-only and retrieve_text equal to a direct search;
  then the kernels line: launches on each variant's path (phases 4, 6, 8,
     9, 10, 11 and 13 plus the fp32 pool's serving for the fp32 variants,
     phases 4, 8, 9 and 13 for pairwise_tile, the int8 pool's serving and
     phases 8 and 13 for the int8 variants, phases 6, 7, 10, 11 and 12 for flash_attention_fwd,
     phases 7, 10, 11 and 12 for the backward kernels), errors, times and
     bounds at the shape the path runs most (the flash kernels with their
     route by dtype as ``variant``, and phases 10-12's shapes under
     ``checks``);
  and the last line: {"ok": true, "device": {...}}.

``--phases 1,4,11`` runs a subset, for finding faults: no kernels line and
no last line. Imports nothing of JAX. Needs one CUDA card; exits nonzero
without one.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import inspect
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32, outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16, tensor cores, dense
TF32_FLOP_PER_S = 495e12  # H100 SXM tf32, tensor cores, dense
TOL = 1e-4  # fp32 sums of ~1000 products in another order than the plain version
N_FULL = 2**20
N_QUERIES = 1024
N_SEGMENT = 2**18  # phase 5: the 2^20 corpus as four sealed segments
# rows of a served launch: a bucket of 32 requests, repeated for each of the
# group's four segments (core/distributed.py searches a group as one index)
SERVE_ROWS = 32 * (N_FULL // N_SEGMENT)
PROFILED_CHUNKS = 16  # phase 4: prune chunks replayed under torch.profiler
MESH_TOL = 1e-6  # phase 13 (a): sharded vs local scores and path scores
MESH_TIMEOUT_S = 300.0  # phase 13: its process group's collectives
MESH_BUILD_DOCS = 2**18  # phase 13 (c): the first 2^18 docs as 4 segments of 2^16
MESH_BUILD_SEGMENTS = 4
MESH_SEED = 200
MESH_BUILD = None  # BuildConfig() (patched small for a CPU rehearsal)
RECALL_GAP = 0.02  # int8 three-path recall@10 must stay within this of fp32 (ROADMAP Queue 1)
# int8-stored brute-force top-10 overlap with fp32's: sound 0.9996, planted
# scale faults 0.0009 and 0.9769 on an H100 at 2^20 (PERF.md, Findings PR 12)
INT8_OVERLAP = 0.99
# phase 8: the write path (serving_bench.py --streaming at full width)
# 2048 upserts, 8 further delete batches between them (32 batches: cut from
# 64 to keep the script inside its time limit once phase 9 joined it)
WRITE_BATCH, WRITE_BATCHES = 64, 32
RYW_SHARE = 0.99  # read-your-writes: least share returned of the re-inserted docs search finds
# least share of re-inserted docs reached from their segment's entry points:
# at this width the reference's builds of 256-1024 docs reach 0.9248-0.9570
# of them, the port's 0.9131-0.9453, both packages' inserts 0.9531-1.0 of a
# batch (tests/segment_reach.py on the CPU)
REACH_FLOOR = 0.90
# phase 9: SynCorpus text through the ingest pipeline into a replica tier
# (benchmarks/fig14_scale.py's build_tier layout). At 65,536 docs phase 9
# takes 391.9-483.2 s of a 750.6-1,045.1 s script on an H100 (PERF.md, §4),
# most of it host work that grows with the docs, so fig14's largest size,
# 100,000, would bring the script to the edge of its time limit
TEXT_DOCS, TEXT_QUERIES, TEXT_FIT, TEXT_DENSE = 65_536, 64, 2048, 1024
TEXT_ENCODE_BATCH, TEXT_SEGMENT, TEXT_VNODES, TEXT_REPLICAS = 1024, 256, 512, 4
TEXT_REQUESTS, TEXT_BATCH = 256, 32  # per QPS reading: closed-loop batches of 32
# gate 5 streams TEXT_STREAM docs, each batch of 256 probed through every
# replica and the tier; cut from 4,096 to 2,048 after a whole run took
# 1,194.2 s of the 1,200 s limit on an H100 (the probes 319.4 s of it)
TEXT_STREAM, TEXT_STREAM_BATCH, TEXT_DELETES = 2048, 256, 1024
TEXT_CONTRACT_DOCS = 512  # gate 3: a tier and one service over the first 512 docs
TEXT_BUILD = None  # BuildConfig() (patched small for a CPU rehearsal)
# phase 6: RAG at llama3.2-1b's full width
RAG_REQUESTS, RAG_PROMPT, RAG_GEN = 64, 64, 64
PROFILE_PAD_S = 0.25  # phase 7: idle card before and after the profiled step, inside the trace
RAG_TOP_K, RAG_CTX = 4, 256  # prefill L = 4 * 256 + 64 = 1088
RAG_MAX_LEN = 1152
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_flash_attention.py:40
# the caught flash calls (gate (d) of phases 10-12), read beside FLASH_TOL's
# elementwise check, which cannot fail a wrong tail: its atol is about a
# typical |out| where an output averages ~1,000 keys (whisper's, ~0.03), and
# its LSE limit (~0.17 at an LSE of 7) is four times what dropping 64 of
# 1,500 keys moves it (~0.04). So out is read as max |diff| / max |plain out|
# and the fp32 LSE as max |diff|, and two planted faults must read above
# one of the two limits at every caught shape: the kernel on keys without
# their last FRONTEND_DROP (at most a quarter of S), and, for a non-causal
# call, the kernel made causal
CAUGHT_OUT_GAP = {"float32": 1e-5, "bfloat16": 2e-2}
CAUGHT_LSE_GAP = 1e-3
# flash vs naive prefill, bf16, max |last-position logit difference| over 8
# rows (logits reach ~4.4). CPU rehearsal (examples/torch_flash_vs_naive.py,
# batch 2, L = 1088): sound 0.039 / 0.050 / 0.055 / 0.084 at 1 / 2 / 4 / 8
# layers; planted faults at 2-8 layers 1.39-4.36 (last key tile dropped,
# causal mask off). On an H100 at 16 layers: sound 0.0898, faults 1.543
# (tile dropped) and 5.812 (causal off) (PERF.md, Findings); phase 6 reads
# both faults against the limit in every run
PREFILL_GAP = 0.25
# phase 10: the dense and moe configs at full width. deepseek-v3 and kimi-k2
# are cut in depth only (first_dense_layers kept, one MoE layer): 31.6 and
# 39.9 GB of bf16 weights. Their RAG batch is 16 requests: the dispatch's
# (N k, D) gathers at phase 6's 64 x 1088 tokens (~8 GB each) and its
# (E, C, D) buffer (~10 GB) would not fit beside kimi's weights and phase
# 4's index
MOE_DEPTH = {"deepseek-v3-671b": 4, "kimi-k2-1t-a32b": 2}
MOE_REQUESTS = 16
DENSE_ROWS, DENSE_STEPS = 8, 16  # deepseek-7b, starcoder2-15b: one prefill, 16 decode steps
GATE_ROWS = 8  # gate (a): flash vs naive prefill on the first 8 rows of the batch
DECODE_CHECK = 4  # gate (b): the first 4 generated tokens
DISPATCH_TOKENS = 256  # gate (c)
MODEL_PREFILL_GAP = 0.25  # gate (a), max |logit difference|
DECODE_GAP = 0.25  # gate (b), max |logit difference|
DISPATCH_GAP = 2e-2  # gate (c), max |difference| / max |output|
# phase 11: rwkv6-7b and zamba2-1.2b whole at full width, RAG at phase 6's
# batch (L = 1088 = 17 chunks of 64: prefill takes the chunked scan). Gates
# (a), chunked vs per-step scan, and (b), a prefill of L and 64 decode steps
# vs one prefill of L + 64 (1152, chunked), run on 2 rows: the per-step form
# is a loop of ~12 launches a step a layer
SCAN_ROWS, CARRY_STEPS = 2, 64
# gates (a)-(c) are held on fp32 copies of the weights: in bf16 the logit
# readings reach 0.52-4.64 at full width on an H100, as large as the planted
# faults' 0.72-8.22 (PERF.md, Findings), because a random-init model turns
# rounding into O(1) logit gaps; (b) and (c) are printed in bf16 beside.
# Even in fp32 rwkv6-7b's logits from the chunked and the per-step scan part
# by 3.89 at some position (0.117 at the last; zamba2's 0.0026), from block
# outputs ~1e-6 of their size apart, and repro's own two scans part the same
# way (tests/rwkv6_drift.py), so gate (a) reads block by block, which holds
# in bf16 too: it is gated in both. In fp32, gate (c)'s flash runs the
# CUDA-core kernel; the served bf16 tensor-core kernel is held by the caught
# call (check_caught_flash)
SCAN_GAP = 1e-3  # gate (a): max over blocks of |chunked - per-step| / max |output|
# gate (a) in bf16, on the served weights: sound 0.007634 (rwkv6-7b) and
# 0.006289 (zamba2) on an H100; planted in fp32 0.7487-1.153 (PERF.md)
SCAN_GAP_BF16 = 0.05
# gate (b): max |last-position logit difference|; on an H100 in fp32 sound
# 0.1011 (rwkv6-7b) and 0.000775 (zamba2), planted 6.524 and 5.882
CARRY_GAP = 0.5
# gate (c): max |last-position logit difference|, fp32; sound 7.1e-5,
# planted 0.1563 (causal mask off) and 0.4248 (last key tile dropped)
HYBRID_FLASH_GAP = 0.05
# zamba2's training step at full width: 1.2 B parameters, bf16, with fp32
# AdamW moments (~15 GB of state); rwkv6-7b's (~91 GB) does not fit one card
TRAIN_RECURRENT = (4, 2048)
# phase 12: the vlm and audio families at full width. llama-3.2-vision-90b
# is cut to 4 of its 20 groups (16 self + 4 cross layers: 19.2 B parameters,
# 38.4 GB of bf16; the whole model's ~175 GB does not fit one card) and
# served at phase 10's dense rows; whisper-large-v3 whole (2.02 B) at 64
# requests of 1,500 frames (its 30 s window), a 4-token prompt (its
# start-of-transcript prefix) and 64 greedy tokens, then trained one step at
# 8 x 448 decoder tokens (its decoder context) over 1,500 frames each
VLM_GROUPS = 4
WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_GEN = 64, 4, 64
WHISPER_TRAIN = (8, 448)
FRONTEND_SCALE = 0.02  # the stub frontend: normal(0, 0.02), as repro's launchers draw it
# gates (a) and (b) read each attention call's output, not the logits: the
# vlm's frontend enters its cross-attention unnormalised at 0.02, so the
# cross layers move its logits by ~1e-4 of their size, under bf16's
# rounding, and a planted fault there would not show. Gate (a): max over
# the prefill's attention calls of |flash - naive| / max |naive| on
# GATE_ROWS rows; planted faults in the cross calls only: made causal, and
# the last FRONTEND_DROP keys dropped. Gate (b): FRONTEND_STEPS decode steps
# after a prefill on FRONTEND_ROWS rows against one teacher-forced forward:
# the logits (limit DECODE_GAP) and each cross-attention output, max |diff|
# / max |forward's| (planted: decode reads the next layer's cross cache).
# The vlm is read in bf16 (fp32 copies of 19 B parameters would not fit),
# whisper on fp32 copies of its weights (its bf16 readings printed beside).
# On an H100: sound 0.0072-0.0075 (vlm, bf16) and 2.9e-7-2.1e-6 (whisper,
# fp32); planted 0.2148-46.83 and 0.003825-1.693 (PERF.md). In bf16
# whisper's dropped keys (0.4% of its cross output) sit under the rounding;
# there the caught calls' LSE (gate (d), CAUGHT_LSE_GAP) holds the tail
FRONTEND_DROP = 64
FRONTEND_ROWS, FRONTEND_STEPS = 2, 16
FRONTEND_GAP = {"bfloat16": 0.05, "float32": 1e-3}
# phase 7: training at llama3.2-1b's full width
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED = 8, 2048, 8  # one warm-up step, then 8 timed
# backward kernels vs the plain version, elementwise |g - w| <= atol + rtol |w|
# as (atol, rtol): fp32 at tests/test_flash_attention.py:64's gradient
# tolerance; bf16 within one bf16 ulp of each value (2^-7 |w|; both sides sum
# in fp32 and round once) plus 2e-4 for the fp32 cancellation in dP - Delta,
# as tests/test_torch_gpu.py holds them (readings in PERF.md, Findings)
GRAD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-4, 2.0**-7)}
# flash vs naive loss gradients at full width on 2 x 2048 tokens, fp32 copies
# of the trained parameters: max over parameters of |g_flash - g_naive| /
# |g_naive|. CPU rehearsal (examples/torch_flash_vs_naive.py --grads --dtype
# float32): sound 4.3e-7 / 7.3e-7 at 1 / 2 layers; planted faults 0.87-0.90
# (dK/dV from the first head of each group), 0.20-2.17 (Delta = 0), 0.0109-
# 0.0114 (last key tile's dS dropped). In bf16 the two paths drift apart by
# 0.0087 at one layer (they round at different places), above the last-tile
# fault's own share, so the gate reads fp32 and bf16 is printed beside it (at
# 16 layers on an H100, flash reads 0.48 from fp32 naive, 0.11 with Delta
# taken from an fp32 O, as naive's own 0.11: PERF.md, Findings)
GRAD_GAP = 1e-3


class SmokeFailure(Exception):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int = 20, hold_s: float = 0.02) -> float:
    """Device milliseconds per call with the host out of the timed span, which
    the event timing of a host-bound call is not: the calls are enqueued
    behind a sleep kernel of ~``hold_s`` (torch.cuda._sleep), so the card runs
    them back to back. It needs no torch.profiler session before the phases
    that time the host (4 and 5)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * 2e9))  # cycles; the H100's SM clock peaks below 2 GHz
    t = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    enqueue_s = time.perf_counter() - t
    torch.cuda.synchronize()
    need(enqueue_s < hold_s / 2, f"device_ms: enqueueing took {enqueue_s:.4f} s, past the hold")
    return a.elapsed_time(b) / reps


def row_bytes(f) -> int:
    """Bytes of one stored row: fp32 dense + 8 B per ELL slot, or int8 dense
    + a 4-byte scale + 6 B per ELL slot (int32 id, fp16 value)."""
    slots = f.learned.idx.shape[1] + f.lexical.idx.shape[1]
    if hasattr(f, "dense_q"):
        return f.dense_q.shape[1] + 4 + slots * 6
    return f.dense.shape[1] * 4 + slots * 8


def bound(bytes_moved: float, flops: float, flop_rate: float = FP32_FLOP_PER_S
          ) -> tuple[float, str]:
    tb, tf = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def scoring_work(q, corpus, ids, out_bytes: int, extra_in: int = 0):
    """Bytes each input read once (unique live corpus rows, query rows, ids),
    output once; flops of the live (query, row) pairs' dense products."""
    import torch

    live = ids[ids >= 0]
    uniq = int(torch.unique(live).numel())
    nbytes = uniq * row_bytes(corpus) + q.n * row_bytes(q) + ids.numel() * 4 + out_bytes + extra_in
    flops = 2.0 * q.dense.shape[1] * int(live.numel())
    return nbytes, flops


def tile_work(corpus, ids):
    """Bytes of a pair-tile launch (each unique row read once, the ids, the
    (C, K, K) output) and its fp32 flops (2 K^2 Dd a node; the tensor-core
    route issues each product three times, 3xTF32)."""
    import torch

    c, k = ids.shape
    uniq = int(torch.unique(ids).numel())
    nbytes = uniq * row_bytes(corpus) + ids.numel() * 4 + c * k * k * 4
    return nbytes, 2.0 * corpus.dense.shape[1] * c * k * k


# ---------------------------------------------------------------------------
# agreement checks
# ---------------------------------------------------------------------------


def topk_agree(ks, kp, ps, pp, full_plain, tol: float) -> float:
    """Kernel top-k (ks, kp) vs plain (ps, pp), up to ties: the same slots are
    empty, scores agree per rank, and every kernel pick has, under the plain
    scores, the score of the plain pick at that rank. Returns max |ks - ps|."""
    import torch

    need(torch.equal(kp < 0, pp < 0), "top-k: empty slots differ")
    live = pp >= 0
    err = float((ks - ps).abs()[live].max().item()) if live.any() else 0.0
    need(err <= tol, f"top-k: score error {err} > {tol}")
    need(bool((ks[~live] == ps[~live]).all()), "top-k: sentinel scores differ")
    picked = torch.gather(full_plain, 1, kp.clamp(min=0).long())
    gap = (picked - ps).abs()[live]
    need(gap.numel() == 0 or float(gap.max().item()) <= tol, "top-k: picks differ beyond ties")
    srt = torch.sort(kp.masked_fill(kp < 0, -1), dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    need(not bool(dup.any()), "top-k: a position picked twice")
    return err


def ids_agree(ids_a, s_a, ids_b, s_b, tol: float) -> None:
    """Search results agree up to ties: same empty slots, scores per rank
    within tol, and where ids differ the scores at that rank are tied."""
    import torch

    need(torch.equal(ids_a < 0, ids_b < 0), "search: empty slots differ")
    live = ids_a >= 0
    if live.any():
        err = float((s_a - s_b).abs()[live].max().item())
        need(err <= tol, f"search: score error {err}")
    differ = (ids_a != ids_b) & live
    frac = float(differ.float().mean().item())
    need(frac <= 0.01, f"search: {frac:.4f} of result slots differ")


def row_set_agreement(a, b) -> float:
    """Fraction of rows whose live ids are equal as sets."""
    import torch

    sa = torch.sort(a.masked_fill(a < 0, 2**30), dim=1).values
    sb = torch.sort(b.masked_fill(b < 0, 2**30), dim=1).values
    return float((sa == sb).all(dim=1).float().mean().item())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    need(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"phase 1 device: {card}")
    say(f"phase 1 torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in strict fp32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t = time.perf_counter()
    lib = _build.library()
    log = _build.build_log()
    used = [ln.strip() for ln in log.splitlines() if "Used" in ln]
    say(f"phase 1 build: {time.perf_counter() - t:.1f} s; ptxas: " + " | ".join(used))
    # ptxas's performance advisories (C75xx: serialised wgmma, setmaxnreg
    # ignored, ...) per tensor-core kernel and head-dim class
    kernel_class = re.compile(r"(flash_(?:fwd|bwd)_tc_\w*?kernel)ILi(\d+)E")
    advisories = sorted({f"{ln.split('(')[1].split(')')[0]} {m[1]}<{m[2]}>"
                         for ln in log.splitlines() if "(C75" in ln
                         for m in [kernel_class.search(ln)] if m})
    say("phase 1 ptxas advisories: " + (", ".join(advisories) or "none"))
    for r in ptxas_resources(log):
        if "flash_bwd_tc_" not in r["name"] and "flash_fwd_tc_" not in r["name"]:
            continue
        d = int(r["name"].split("ILi")[1].split("E")[0])  # the head-dim class
        smem_bytes = (lib.flash_attention_smem_bytes if r["kernel"] == "flash_fwd_tc_kernel"
                      else lib.flash_attention_bwd_smem_bytes)
        smem = smem_bytes(d, d, 1)
        say(f"phase 1 ptxas {r['kernel']}<{d}>: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} B, spill loads {r['spill_loads']} B, stack {r['stack']} B; "
            f"dynamic shared memory at dk = dv = {d}: {smem} B")
        if d == 64:  # the training shape's class
            need(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                 f"{r['kernel']}<64> spills registers")
    # the fused top-k kernels, both storage views: the one-pass form's dynamic
    # shared memory at the serving (B 32, C 24) and refinement (B 2048, C
    # 152) shapes, Dd 1024 and the corpus's 32 / 16 ELL slots
    smem = {f"B={b} C={c}": lib.fused_topk_smem_bytes(b, 1024, 32, 16, c)
            for b, c in ((32, 24), (2048, 152))}
    for r in ptxas_resources(log):
        m = re.search(r"(fused_topk_[a-z_]*kernel)(?:IN2rt(\d+)(CorpusView\w*?)E)?", r["name"])
        if m is None:
            continue
        view = f"<{m[3][:int(m[2])]}>" if m[2] else ""
        say(f"phase 1 ptxas {m[1]}{view}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} B, spill loads {r['spill_loads']} B, stack {r['stack']} B, "
            f"static shared memory {r.get('smem', 0)} B"
            + (f"; dynamic shared memory {smem}" if m[1] == "fused_topk_kernel" else ""))
        need(r["spill_stores"] == 0 and r["spill_loads"] == 0, f"{m[1]}{view} spills registers")
    # the pair tiles (T: 8-column blocks a warp, 2 for K <= 32, 8 for K <= 64)
    # and both forms of the distance kernel over both storage views
    per_sm = lib.pairwise_tile_blocks_per_sm(32, 1024, 32, 16, 0)
    need(per_sm > 0, "pairwise_tile: no block fits an SM")
    for r in ptxas_resources(log):
        m = (re.search(r"(pairwise_tile_kernel)ILi(\d+)E", r["name"])
             or re.search(r"(hybrid_distance_(?:warp_)?kernel)IN2rt(\d+)(CorpusView\w*?)E",
                          r["name"]))
        if m is None:
            continue
        what = (f"{m[1]}<{m[2]}>" if m[1] == "pairwise_tile_kernel"
                else f"{m[1]}<{m[3][:int(m[2])]}>")
        extra = ""
        if m[1] == "pairwise_tile_kernel" and m[2] == "2":
            extra = (f"; dynamic shared memory at K = 32, Dd 1024, 32 / 16 slots "
                     f"{lib.pairwise_tile_smem_bytes(32, 1024, 32, 16)} B, {per_sm} blocks an SM")
        say(f"phase 1 ptxas {what}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} B, spill loads {r['spill_loads']} B, stack {r['stack']} B, "
            f"static shared memory "
            f"{r.get('smem', 0)} B{extra}")
        need(r["spill_stores"] == 0 and r["spill_loads"] == 0, f"{what} spills registers")
    return card


def ptxas_resources(log: str) -> list[dict]:
    """Per entry function of an ``nvcc -Xptxas -v`` log: its mangled name,
    the kernel's plain name, registers, spill bytes and stack frame."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            kernel = next((w for w in ("flash_fwd_tc_kernel", "flash_bwd_tc_dq_kernel",
                                       "flash_bwd_tc_dkv_kernel") if w in name), name)
            cur = dict(name=name, kernel=kernel)
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            cur.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(ln.split("Used")[1].split()[0])
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(m[1]) if m else 0
    return [r for r in out if "registers" in r and "spill_stores" in r]


def cuda_kernels(prof) -> dict:
    """{kernel name: (launches, device ms)} over a ``torch.profiler`` run."""
    import torch

    out = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.count > 0:
            n, ms = out.get(evt.key, (0, 0.0))
            out[evt.key] = (n + evt.count, ms + t / 1e3)
    return out


def profiled_step(step, pad_s: float, cpu: bool = False):
    """``step()`` under torch.profiler (CUDA activity, and CPU activity with
    ``cpu``). With ``pad_s`` > 0 the
    step is framed inside the trace by a spin-kernel marker and ``pad_s`` of
    idle card on each side; without, it is preceded by one small kernel and
    a sync. Returns (step's result, its seconds, {kernel: (launches, ms)},
    the trace's flash kernels in time order as a string, F the forward, Q
    dQ, K dK/dV, and the names of its first and last two device records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
        if pad_s:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pad_s)
        else:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if pad_s:
            time.sleep(pad_s)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    dev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    sym = {"flash_fwd_tc_kernel": "F", "flash_bwd_tc_dq_kernel": "Q", "flash_bwd_tc_dkv_kernel": "K"}
    order = "".join(next((c for k, c in sym.items() if k in e.name), "") for e in dev)
    ends = [e.name[:48] for e in dev[:2] + dev[-2:]]
    return out, dt, cuda_kernels(prof), order, ends


def random_ids(n: int, b: int, c: int, pad_frac: float, gen):
    import torch

    ids = torch.randint(0, n, (b, c), generator=gen, device="cuda", dtype=torch.int32)
    pad = torch.rand((b, c), generator=gen, device="cuda") < pad_frac
    return ids.masked_fill(pad, -1)


def real_descent_chunk(corpus, knn_ids, k: int, weights=None, start: int = 0, seed: int = 17):
    """The (queries, ids) one NN-Descent round hands ``fused_topk`` for the
    node chunk at ``start`` of graph ``knn_ids``, built by
    ``knn_graph._descent_round_chunk`` itself (two-hop ids plus
    ``extra_random`` random ids, deduped, self and current neighbours
    removed): its call is caught on the way in. k = 32 and no weights give a
    descent round's chunk; k = 12 with single-path weights a refinement
    round's (``build_pipeline._path_refinement``)."""
    import torch

    from repro_torch.core import knn_graph
    from repro_torch.core.knn_graph import KnnConfig
    from repro_torch.core.usms import weighted_query
    from repro_torch.kernels import ops

    cfg = KnnConfig(k=k)
    e = min(start + cfg.node_chunk, corpus.n)
    dev = knn_ids.device
    nbr = knn_ids[:, :k].contiguous()
    q = corpus[start:e] if weights is None else weighted_query(corpus[start:e], weights)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = torch.randint(0, corpus.n, (e - start, cfg.extra_random), generator=gen, device=dev,
                         dtype=torch.int32)
    node_ids = torch.arange(start, e, dtype=torch.int32, device=dev)
    seen, sound = {}, ops.fused_topk_vs_ids

    def catch(q_, corpus_, ids, k_, **kw):
        seen["ids"] = ids.to(torch.int32).contiguous()
        return sound(q_, corpus_, ids, k_, **kw)

    ops.fused_topk_vs_ids = catch
    try:
        knn_graph._descent_round_chunk(corpus, nbr, q, node_ids, nbr[start:e],
                                       torch.zeros(nbr[start:e].shape, device=dev), rand, cfg)
    finally:
        ops.fused_topk_vs_ids = sound
    return q, seen["ids"]


def pair_stats(ids, n: int) -> tuple[int, int]:
    """(live pairs, unique rows) of an id matrix: what a launch must read."""
    import torch

    live = ids[(ids >= 0) & (ids < n)]
    return int(live.numel()), int(torch.unique(live).numel())


def record_check(results: dict, phase: str, name: str, shape: str, err: float, ms: float,
                 plain_ms: float, nbytes: float, flops: float, dev_ms=None,
                 flop_rate: float = FP32_FLOP_PER_S) -> None:
    """A kernel's reading at one shape into ``results`` and the log."""
    b_ms, b_by = bound(nbytes, flops, flop_rate)
    results.setdefault(name, {"launches": 0, "max_abs_err": 0.0, "checks": []})
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    results[name]["checks"].append(dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                        bound_by=b_by, device_ms=dev_ms))
    say(f"{phase} {name} {shape}: max_abs_err {err:.3g} ms {ms:.4f}"
        + ("" if dev_ms is None else f" device_ms {dev_ms:.4f}")
        + f" plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")


def plant_edges(ids, n: int):
    """Edge rows of a (B >= 4, C) id matrix: 0 all PAD, 1 three live ids (k >
    live), 2 one id everywhere (ties: lowest position first), 3 one id at
    even positions (ties among live ids)."""
    import torch

    ids[0] = -1
    ids[1, :3] = torch.tensor([11, 22, 33], dtype=torch.int32, device=ids.device)
    ids[1, 3:] = -1
    ids[2] = 12345 % n
    ids[3, ::2] = 777 % n
    return ids


def check_edges(p_k, s_k, k: int, what: str) -> None:
    """The kernel's picks on plant_edges' rows (bias 0 on rows 2 and 3)."""
    import torch

    from repro_torch.kernels.ref import NEG

    need(bool((p_k[0] == -1).all()) and bool((s_k[0] == NEG).all()), f"{what}: all-PAD row")
    need(bool((p_k[1, 3:] == -1).all()) and bool((p_k[1, :3] >= 0).all()), f"{what}: k > live")
    need(torch.equal(p_k[2], torch.arange(k, device=p_k.device, dtype=torch.int32)),
         f"{what}: planted ties, lowest position first")
    tied = p_k[3][p_k[3] % 2 == 0]  # the repeated id sits at even positions
    need(torch.equal(tied, torch.sort(tied).values), f"{what}: planted ties, order")


def phase_kernels(corpus, queries, results: dict):
    """Each kernel vs its plain version on the card."""
    import torch

    from repro_torch.core.index import BuildConfig
    from repro_torch.core.search import SearchParams
    from repro_torch.core.usms import FusedVectors, PathWeights, SparseVec, weighted_query
    from repro_torch.kernels.fused_topk import fused_topk, fused_topk_plain
    from repro_torch.kernels.hybrid_distance import hybrid_distance, hybrid_distance_plain
    from repro_torch.kernels.pairwise_tile import pairwise_tile, pairwise_tile_plain
    from repro_torch.kernels.ref import NEG

    gen = torch.Generator(device="cuda").manual_seed(7)
    n = corpus.n
    qw = weighted_query(queries, PathWeights.three_path())
    rows = lambda s, e: FusedVectors(
        corpus.dense[s:e], SparseVec(corpus.learned.idx[s:e], corpus.learned.val[s:e]),
        SparseVec(corpus.lexical.idx[s:e], corpus.lexical.val[s:e]))

    def record(name, shape, err, ms, plain_ms, nbytes, flops, dev_ms=None):
        record_check(results, "phase 2", name, shape, err, ms, plain_ms, nbytes, flops, dev_ms)

    # --- fused_topk: descent chunk and init, refinement round and init, search
    # round, served rounds (+ edges) -------------------------------------------
    from repro_torch.core.build_pipeline import SINGLE_PATH_WEIGHTS

    sp = SearchParams()
    seg = rows(0, N_SEGMENT)  # a served segment's rows
    serve_c = sp.expand * (BuildConfig().prune.degree + BuildConfig().prune.keyword_degree)
    refine_q = weighted_query(rows(0, 2048), SINGLE_PATH_WEIGHTS[0])
    rand = lambda b, c: torch.rand((b, c), generator=gen, device="cuda")
    cases = [  # label, queries, corpus, ids, k, bias
        ("descent_chunk", rows(0, 2048), corpus, random_ids(n, 2048, 32 * 32 + 8, 0.3, gen), 32,
         None),
        ("descent_init", rows(0, 2048), corpus, random_ids(n, 2048, 32, 0.0, gen), 32, None),
        ("refine_round", refine_q, corpus, random_ids(n, 2048, 12 * 12 + 8, 0.15, gen), 12, None),
        ("refine_init", refine_q, corpus, random_ids(n, 2048, 12, 0.0, gen), 12, None),
        ("search_round", qw, corpus, random_ids(n, N_QUERIES, 16, 0.2, gen), 16,
         rand(N_QUERIES, 16)),
        ("serve_round", qw[0:SERVE_ROWS], seg, random_ids(N_SEGMENT, SERVE_ROWS, serve_c, 0.2,
                                                            gen),
         min(sp.pool_size, serve_c), rand(SERVE_ROWS, serve_c)),
        ("serve_twin", qw[0:SERVE_ROWS], seg, random_ids(N_SEGMENT, SERVE_ROWS, serve_c, 0.5,
                                                           gen),
         min(sp.kw_pool_size, serve_c), rand(SERVE_ROWS, serve_c)),
    ]
    for label, q, cor, ids, k, bias in cases:
        b = ids.shape[0]
        edges = bias is not None  # the search and serving rounds carry the edge rows
        if edges:
            plant_edges(ids, cor.n)
            bias[2:4] = 0.0
        s_k, p_k = fused_topk(q, cor, ids, k, bias)
        s_p, p_p = fused_topk_plain(q, cor, ids, k, bias)
        full = hybrid_distance_plain(q, cor, ids)
        if bias is not None:
            full = full + bias
        full = torch.where(ids >= 0, full, torch.full_like(full, NEG))
        err = topk_agree(s_k, p_k, s_p, p_p, full, TOL)
        again = fused_topk(q, cor, ids, k, bias)
        need(torch.equal(again[0], s_k) and torch.equal(again[1], p_k),
             f"fused_topk {label}: two launches differ")
        if edges:
            check_edges(p_k, s_k, k, f"fused_topk {label}")
        reps = 5 if b * ids.shape[1] > 2**20 else 20
        ms = time_ms(lambda: fused_topk(q, cor, ids, k, bias), reps)
        dev = device_ms(lambda: fused_topk(q, cor, ids, k, bias), reps)
        plain_ms = time_ms(lambda: fused_topk_plain(q, cor, ids, k, bias), 2, warm=1)
        nbytes, flops = scoring_work(q, cor, ids, b * k * 8,
                                     0 if bias is None else bias.numel() * 4)
        record("fused_topk", f"{label} B={b} C={ids.shape[1]} k={k}"
               f"{' bias' if bias is not None else ''}", err, ms, plain_ms, nbytes, flops, dev)
        torch.cuda.empty_cache()

    # --- hybrid_distance: self scores over N, entry scoring, final re-score ---
    self_ids = torch.arange(n, dtype=torch.int32, device="cuda")[:, None]
    stack3 = lambda q: FusedVectors(  # the final re-score's three query blocks
        torch.cat([q.dense] * 3),
        *(SparseVec(torch.cat([sv.idx] * 3), torch.cat([sv.val] * 3))
          for sv in (q.learned, q.lexical)))
    rescore_q = stack3(qw)
    norm_rows = 65536  # build_pipeline._NORM_CHUNK: one of the build's 48 per-path norm launches
    cases = [
        ("self_scores", corpus, self_ids),
        ("path_norm", weighted_query(rows(0, norm_rows), SINGLE_PATH_WEIGHTS[0]),
         self_ids[:norm_rows].contiguous()),
        ("entry_scoring", qw, random_ids(n, N_QUERIES, 16, 0.0, gen)),
        ("final_rescore", rescore_q, random_ids(n, 3 * N_QUERIES, sp.pool_size + sp.kw_pool_size,
                                                0.3, gen)),
        ("serve_entry", qw[0:SERVE_ROWS], random_ids(N_SEGMENT, SERVE_ROWS,
                                                     BuildConfig().n_entry, 0.0, gen)),
        ("serve_rescore", stack3(qw[0:SERVE_ROWS]), random_ids(N_SEGMENT, 3 * SERVE_ROWS,
                                                               sp.pool_size
                                                       + sp.kw_pool_size, 0.3, gen)),
    ]
    for label, q, ids in cases:
        cor = seg if label.startswith("serve") else corpus
        out_k = hybrid_distance(q, cor, ids)
        out_p = torch.cat([hybrid_distance_plain(q[s:s + 65536], cor, ids[s:s + 65536])
                           for s in range(0, ids.shape[0], 65536)])
        need(torch.equal(torch.isinf(out_k), ids < 0), f"hybrid_distance {label}: -inf mask")
        need(torch.equal(hybrid_distance(q, cor, ids), out_k),
             f"hybrid_distance {label}: two launches differ")
        live = ids >= 0
        err = float((out_k - out_p).abs()[live].max().item())
        need(err <= TOL, f"hybrid_distance {label}: error {err}")
        reps = 5 if label == "self_scores" else 20
        ms = time_ms(lambda: hybrid_distance(q, cor, ids), reps)
        dev = device_ms(lambda: hybrid_distance(q, cor, ids), reps)
        plain_ms = time_ms(lambda: hybrid_distance_plain(q, cor, ids), 2, warm=1)
        nbytes, flops = scoring_work(q, cor, ids, ids.numel() * 4)
        if label == "self_scores":  # query rows are the corpus rows: read once
            nbytes -= q.n * row_bytes(q)
        record("hybrid_distance", f"{label} B={ids.shape[0]} C={ids.shape[1]}", err, ms,
               plain_ms, nbytes, flops, dev)
        torch.cuda.empty_cache()

    # --- pairwise_tile: one RNG-IP prune chunk -----------------------------
    ids = torch.randint(0, n, (1024, 32), generator=gen, device="cuda", dtype=torch.int32)
    ids[0, 5] = ids[0, 6]  # planted identical rows
    out_k = pairwise_tile(corpus, ids)
    out_p = pairwise_tile_plain(corpus, ids)
    err = float((out_k - out_p).abs().max().item())
    need(err <= TOL, f"pairwise_tile: error {err}")
    need(torch.equal(out_k[0, 5], out_k[0, 6]), "pairwise_tile: identical rows differ")
    need(torch.equal(pairwise_tile(corpus, ids), out_k), "pairwise_tile: two launches differ")
    ms = time_ms(lambda: pairwise_tile(corpus, ids), 10)
    dev = device_ms(lambda: pairwise_tile(corpus, ids), 10)
    plain_ms = time_ms(lambda: pairwise_tile_plain(corpus, ids), 2, warm=1)
    nbytes, flops = tile_work(corpus, ids)
    record_check(results, "phase 2", "pairwise_tile", "prune_chunk C=1024 K=32", err, ms,
                 plain_ms, nbytes, 3 * flops, dev, TF32_FLOP_PER_S)
    torch.cuda.empty_cache()

    # --- int8 variants over one sealed segment's storage ---------------------
    from repro_torch.core.usms import quantize_corpus
    from repro_torch.kernels.fused_topk import fused_topk_int8, fused_topk_int8_plain
    from repro_torch.kernels.hybrid_distance import (
        hybrid_distance_int8,
        hybrid_distance_int8_plain,
    )

    seg = rows(0, N_SEGMENT)
    dense = seg.dense.clone()
    dense[0] = 0.0  # a zero row: scale 1.0, all-zero int8
    dense[1, 0::2], dense[1, 1::2] = 1.0, -1.0  # a row at +-127
    cq = quantize_corpus(FusedVectors(dense, seg.learned, seg.lexical))
    del dense
    need(float(cq.dense_scale[0]) == 1.0 and not bool(cq.dense_q[0].any()), "int8: zero row")
    need(bool((cq.dense_q[1].abs() == 127).all()), "int8: +-127 row")
    nq = cq.n
    big_q = rows(N_SEGMENT, N_SEGMENT + 2048)  # rows of another segment as queries

    def plant(ids):
        """Edge rows: all PAD, k > live, planted ties, the zero and +-127 rows."""
        plant_edges(ids, nq)
        ids[4, :2] = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
        return ids

    # serving shapes: a 32-row bucket over a group of four segments (B =
    # 128 rows) with keywords on expands one node per round into 16 semantic
    # + 8 keyword edges (C = 24), picks the round's top 24 and the twin
    # pool's top 16; entry scoring takes the 16 entry points; the final
    # re-score stacks the three single-path queries (B = 384) over the 64 +
    # 16 pooled ids (C = 80)
    sb = SERVE_ROWS
    bias_for = lambda b, c: torch.rand((b, c), generator=gen, device="cuda")
    cases = [
        ("serve_round", qw[0:sb], plant(random_ids(nq, sb, serve_c, 0.2, gen)),
         min(sp.pool_size, serve_c), bias_for(sb, serve_c)),
        ("serve_twin", qw[0:sb], plant(random_ids(nq, sb, serve_c, 0.5, gen)),
         min(sp.kw_pool_size, serve_c), bias_for(sb, serve_c)),
        ("search_round", qw[0:64], plant(random_ids(nq, 64, 16, 0.2, gen)), 16,
         bias_for(64, 16)),
        ("large", big_q, random_ids(nq, 2048, 32 * 32 + 8, 0.3, gen), 32, None),
    ]
    for label, q, ids, k, bias in cases:
        b = ids.shape[0]
        if bias is not None:
            bias[2:4] = 0.0
        s_k, p_k = fused_topk_int8(q, cq, ids, k, bias)
        s_p, p_p = fused_topk_int8_plain(q, cq, ids, k, bias)
        full = hybrid_distance_int8_plain(q, cq, ids)
        if bias is not None:
            full = full + bias
        full = torch.where(ids >= 0, full, torch.full_like(full, NEG))
        err = topk_agree(s_k, p_k, s_p, p_p, full, TOL)
        if label != "large":
            check_edges(p_k, s_k, k, f"fused_topk_int8 {label}")
        reps = 5 if b > 256 else 20
        ms = time_ms(lambda: fused_topk_int8(q, cq, ids, k, bias), reps)
        dev = device_ms(lambda: fused_topk_int8(q, cq, ids, k, bias), reps)
        plain_ms = time_ms(lambda: fused_topk_int8_plain(q, cq, ids, k, bias), 2, warm=1)
        nbytes, flops = scoring_work(q, cq, ids, b * k * 8,
                                     0 if bias is None else bias.numel() * 4)
        record("fused_topk_int8", f"{label} B={b} C={ids.shape[1]} k={k}"
               f"{' bias' if bias is not None else ''}", err, ms, plain_ms, nbytes, flops, dev)
        torch.cuda.empty_cache()

    cases = [
        ("serve_entry", qw[0:sb], plant(random_ids(nq, sb, BuildConfig().n_entry, 0.0, gen))),
        ("serve_rescore", stack3(qw[0:sb]), plant(random_ids(nq, 3 * sb, sp.pool_size + sp.kw_pool_size,
                                                0.3, gen))),
        ("final_rescore", qw[0:64], plant(random_ids(nq, 64, sp.pool_size + sp.kw_pool_size,
                                                     0.3, gen))),
        ("large", big_q, random_ids(nq, 2048, 32 * 32 + 8, 0.3, gen)),
    ]
    for label, q, ids in cases:
        out_k = hybrid_distance_int8(q, cq, ids)
        out_p = hybrid_distance_int8_plain(q, cq, ids)
        need(torch.equal(torch.isinf(out_k), ids < 0), f"hybrid_distance_int8 {label}: -inf mask")
        need(torch.equal(hybrid_distance_int8(q, cq, ids), out_k),
             f"hybrid_distance_int8 {label}: two launches differ")
        live = ids >= 0
        err = float((out_k - out_p).abs()[live].max().item())
        need(err <= TOL, f"hybrid_distance_int8 {label}: error {err}")
        reps = 5 if ids.shape[0] > 256 else 20
        ms = time_ms(lambda: hybrid_distance_int8(q, cq, ids), reps)
        dev = device_ms(lambda: hybrid_distance_int8(q, cq, ids), reps)
        plain_ms = time_ms(lambda: hybrid_distance_int8_plain(q, cq, ids), 2, warm=1)
        nbytes, flops = scoring_work(q, cq, ids, ids.numel() * 4)
        record("hybrid_distance_int8", f"{label} B={ids.shape[0]} C={ids.shape[1]}", err, ms,
               plain_ms, nbytes, flops, dev)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def kernel_calls(stages=(), label: str = "?"):
    """{(stage, op, shape): (args, kwargs)} of the three kernel ops called
    inside the block, the first call of each shape per stage (the calls
    themselves run as they are). ``stages``: (module, name, stage label) of
    functions that name the stage of the calls made within them; other calls
    get ``label``. Calls from several threads are caught under ``label``."""
    from repro_torch.kernels import ops

    stage, seen = [label], {}

    def catch(op, fn, ids_at):
        def run(*a, **kw):
            seen.setdefault((stage[0], op, tuple(a[ids_at].shape)), (a, kw))
            return fn(*a, **kw)
        return run

    def staged(name, fn):
        def run(*a, **kw):
            prev, stage[0] = stage[0], name
            try:
                return fn(*a, **kw)
            finally:
                stage[0] = prev
        return run

    patches = [(ops, "fused_topk_vs_ids", catch("fused_topk", ops.fused_topk_vs_ids, 2)),
               (ops, "hybrid_scores_vs_ids", catch("hybrid_distance", ops.hybrid_scores_vs_ids,
                                                   2)),
               (ops, "pairwise_tile_scores_vs_ids",
                catch("pairwise_tile", ops.pairwise_tile_scores_vs_ids, 1))]
    patches += [(m, name, staged(st, getattr(m, name))) for m, name, st in stages]
    sound = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, fn in patches:
        setattr(m, name, fn)
    try:
        yield seen
    finally:
        for m, name, fn in sound:
            setattr(m, name, fn)


def build_stages(probe: bool = False) -> list:
    """kernel_calls' stages of a build (and an insert's probe search)."""
    from repro_torch.core import build_pipeline as bp
    from repro_torch.core import pruning

    return ([(bp, "search", "probe")] if probe else []) + [
        (bp, "nn_descent", "descent"), (bp, "_nn_descent", "descent"),
        (bp, "_path_refinement", "refine"),
        (pruning, "self_scores", "self_scores"), (pruning, "_prune_chunk", "prune")]


def insert_calls(docs, n_grow: int = 192, n_new: int = 64) -> dict:
    """The kernel calls one insert makes, as the write path makes them: a
    grow segment of ``n_grow`` docs is built (default BuildConfig) and
    ``n_new`` more are inserted, while the op entry points are caught on the
    way in (kernel_calls): the probe's search (entry scoring, rounds, final
    re-score), NN-Descent among the new nodes (init, rounds), the self
    scores, and the prune chunk (per-path re-ranks, pair tiles)."""
    import torch

    from repro_torch.core import build_pipeline as bp
    from repro_torch.core.index import BuildConfig

    grow = bp.build_index(docs[0:n_grow], BuildConfig(),
                          generator=torch.Generator("cuda").manual_seed(5))
    with kernel_calls(build_stages(probe=True)) as seen:
        bp.insert(grow, docs[n_grow:n_grow + n_new], BuildConfig(),
                  generator=torch.Generator("cuda").manual_seed(6))
    return seen


def check_calls(calls: dict, results: dict, phase: str, prefix: str, reps: int = 20,
                device: str = "cuda") -> int:
    """Each caught kernel call (kernel_calls) against its plain version on
    the same operands: max error (fused_topk: agreement up to ties), two
    launches bit-identical, times and bound into ``results`` under
    ``{prefix}_{stage}``. On the CPU (a rehearsal) the wrappers run their
    plain versions and nothing is timed. Returns the calls checked."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.hybrid_distance import hybrid_distance_plain
    from repro_torch.kernels.ref import NEG

    for (st, op, shape), (a, kw) in sorted(calls.items()):
        kw = {k: v for k, v in kw.items() if k != "use_kernel"}
        if op == "pairwise_tile":
            corpus, ids = a[0], a[1]
            fn = lambda use: ops.pairwise_tile_scores_vs_ids(corpus, ids, use_kernel=use)
            out_k, out_p = fn(None), fn(False)
            err = float((out_k - out_p).abs().max().item())
            label = f"{prefix}_{st} C={shape[0]} K={shape[1]}"
            nbytes, flops = tile_work(corpus, ids.clamp(0, corpus.n - 1))
            rate, flops = TF32_FLOP_PER_S, 3 * flops
        elif op == "hybrid_distance":
            q, corpus, ids = a[:3]
            fn = lambda use: ops.hybrid_scores_vs_ids(q, corpus, ids, use_kernel=use)
            out_k, out_p = fn(None), fn(False)
            live = ids >= 0
            need(torch.equal(torch.isinf(out_k), ~live), f"{prefix} {st} hybrid_distance: mask")
            err = float((out_k - out_p).abs()[live].max().item()) if live.any() else 0.0
            label = f"{prefix}_{st} B={shape[0]} C={shape[1]}"
            nbytes, flops = scoring_work(q, corpus, ids, ids.numel() * 4)
            rate = FP32_FLOP_PER_S
        else:
            q, corpus, ids, k = a[:4]
            bias = kw.get("bias")
            fn = lambda use: ops.fused_topk_vs_ids(q, corpus, ids, k, bias=bias, use_kernel=use)
            out_k, out_p = fn(None), fn(False)
            full = hybrid_distance_plain(q, corpus, ids.to(torch.int32))
            if bias is not None:
                full = full + bias
            full = torch.where(ids >= 0, full, torch.full_like(full, NEG))
            err = topk_agree(out_k[0], out_k[1], out_p[0], out_p[1], full, TOL)
            label = (f"{prefix}_{st} B={shape[0]} C={shape[1]} k={k}"
                     + ("" if bias is None else " bias"))
            nbytes, flops = scoring_work(q, corpus, ids, shape[0] * k * 8)
            rate = FP32_FLOP_PER_S
        need(err <= TOL, f"{op} {label}: error {err}")
        again = fn(None)
        same = (torch.equal(again, out_k) if op != "fused_topk"
                else torch.equal(again[0], out_k[0]) and torch.equal(again[1], out_k[1]))
        need(same, f"{op} {label}: two launches differ")
        if device == "cuda":
            ms = time_ms(lambda: fn(None), reps)
            dev = device_ms(lambda: fn(None), reps)
            plain_ms = time_ms(lambda: fn(False), 3, warm=1)
            record_check(results, phase, op, label, err, ms, plain_ms, nbytes, flops, dev, rate)
        del out_k, out_p, again
    if device == "cuda":
        torch.cuda.empty_cache()
    return len(calls)


def phase_insert_kernels(docs, results: dict):
    """Each kernel of the write path against its plain version at the shapes
    an insert of 64 docs into a grow segment of 192 gives it (caught from a
    real insert), with error, two launches bit-identical, times and bound."""
    calls = insert_calls(docs)
    need({op for _, op, _ in calls} == {"fused_topk", "hybrid_distance", "pairwise_tile"},
         f"insert: kernels caught {sorted({op for _, op, _ in calls})}")
    need({st for st, _, _ in calls} >= {"probe", "descent", "self_scores", "prune"},
         f"insert: stages caught {sorted({st for st, _, _ in calls})}")
    check_calls(calls, results, "phase 2", "insert")


@contextlib.contextmanager
def stage_counter(wrapper):
    """{stage (C of its launches): launches of ``wrapper``} over the build
    inside the block: the build pipeline's descent init and round functions
    are wrapped to count, refinement apart from the descent."""
    from repro_torch.core import build_pipeline as bp

    counts: dict = {}
    inside: list = []
    sound = {name: getattr(bp, name) for name in ("_descent_init", "_descent_rounds",
                                                   "_path_refinement")}

    def counted(name, fn):
        def run(corpus, weights, nbr_ids, *args, **kw):
            before = wrapper.launches
            try:
                return fn(corpus, weights, nbr_ids, *args, **kw)
            finally:
                cfg = args[1] if name == "_descent_rounds" else None  # (scores, cfg, rounds)
                c = nbr_ids.shape[1] if cfg is None else cfg.k * cfg.k + cfg.extra_random
                key = f"{'refinement' if inside else 'descent'} {name.split('_')[-1]} (C={c})"
                counts[key] = counts.get(key, 0) + wrapper.launches - before
        return run

    def refinement(*args, **kw):
        inside.append(True)
        try:
            return sound["_path_refinement"](*args, **kw)
        finally:
            inside.pop()

    bp._descent_init = counted("_descent_init", sound["_descent_init"])
    bp._descent_rounds = counted("_descent_rounds", sound["_descent_rounds"])
    bp._path_refinement = refinement
    try:
        yield counts
    finally:
        for name, fn in sound.items():
            setattr(bp, name, fn)


@contextlib.contextmanager
def prune_chunks_caught(count: int):
    """The arguments of the first ``count`` ``pruning._prune_chunk`` calls
    the build inside the block makes (``prune_all``'s node chunks, in
    order), to replay them later; the calls themselves run as they are."""
    from repro_torch.core import pruning

    caught: list = []
    sound = pruning._prune_chunk

    def catch(*args, **kw):
        if len(caught) < count:
            caught.append((args, kw))
        return sound(*args, **kw)

    pruning._prune_chunk = catch
    try:
        yield caught
    finally:
        pruning._prune_chunk = sound


def phase_small_e2e():
    """N = 4096 with the KG: kernels vs plain versions for build and search."""
    import dataclasses

    import torch

    from repro_torch.core.build_pipeline import build_index
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.search import SearchParams, search
    from repro_torch.data.corpus import CorpusConfig, make_corpus

    c = make_corpus(CorpusConfig(n_docs=4096, n_queries=64, n_topics=64, d_dense=1024,
                                 seed=3))
    cfg_k = BuildConfig()
    cfg_p = dataclasses.replace(
        cfg_k, knn=dataclasses.replace(cfg_k.knn, use_kernel=False),
        prune=dataclasses.replace(cfg_k.prune, use_kernel=False))
    kg = dict(kg_triplets=c.kg.triplets, doc_entities=c.doc_entities,
              n_entities=c.kg.n_entities)
    t = time.perf_counter()
    ik = build_index(c.docs, cfg_k, generator=torch.Generator("cuda").manual_seed(1), **kg)
    torch.cuda.synchronize()
    tk = time.perf_counter() - t
    t = time.perf_counter()
    ip = build_index(c.docs, cfg_p, generator=torch.Generator("cuda").manual_seed(1), **kg)
    torch.cuda.synchronize()
    tp = time.perf_counter() - t
    sem = row_set_agreement(ik.semantic_edges, ip.semantic_edges)
    kw = row_set_agreement(ik.keyword_edges, ip.keyword_edges)
    need(sem >= 0.99 and kw >= 0.99, f"small build: row agreement sem {sem} kw {kw}")
    kwds = torch.as_tensor(c.query_keywords)
    ents = torch.as_tensor(c.query_entities)
    for name, spec, params in [
        ("three_path+kw+kg", FusionSpec.weighted(1, 1, 1, kg=30.0),
         SearchParams(use_keywords=True, use_kg=True)),
        ("rrf", FusionSpec.rrf(), SearchParams()),
    ]:
        rk = search(ik, c.queries, spec, params, keywords=kwds, entities=ents)
        rp = search(ik, c.queries, spec, dataclasses.replace(params, use_kernel=False),
                    keywords=kwds, entities=ents)
        ids_agree(rk.ids, rk.scores, rp.ids, rp.scores, TOL)
    say(f"phase 3 small e2e N=4096 Dd=1024 KG on: build kernels {tk:.1f} s plain {tp:.1f} s; "
        f"semantic rows equal {sem:.4f} keyword rows equal {kw:.4f}; search ids agree up to ties")

    # the host-driven legacy stages (repro.core's build_knn_graph and
    # rng_ip_prune), through the kernels and the plain versions, from the
    # same init_ids and round draws, then the same kNN graph
    from repro_torch.core import knn_graph, pruning

    n, kc, pc = c.docs.n, cfg_k.knn, cfg_k.prune
    gen = torch.Generator("cuda").manual_seed(2)
    init = knn_graph._init_graph(n, kc.k, gen, "cuda")
    rounds = [torch.randint(0, n, (n, kc.extra_random), generator=gen, device="cuda",
                            dtype=torch.int32) for _ in range(kc.iters)]
    graphs = [knn_graph.build_knn_graph(c.docs, cfg.knn, gen, init_ids=init, rounds=rounds)
              for cfg in (cfg_k, cfg_p)]
    ids_agree(*graphs[0], *graphs[1], TOL)
    edges = [pruning.rng_ip_prune(c.docs, *graphs[0], cfg.prune) for cfg in (cfg_k, cfg_p)]
    sem = row_set_agreement(edges[0][0], edges[1][0])
    kw = row_set_agreement(edges[0][1], edges[1][1])
    same = float((edges[0][0] == edges[1][0]).all(1).float().mean())
    say(f"phase 3 build_knn_graph (k {kc.k}, {kc.iters} rounds) through the kernels vs the plain "
        f"versions from the same init_ids: ids agree up to ties, scores within {TOL}; "
        f"rng_ip_prune (degree {pc.degree}) on that graph: semantic rows equal {sem:.4f} "
        f"(in order {same:.4f}), keyword rows equal {kw:.4f}")
    need(sem >= 0.99 and kw >= 0.99, f"rng_ip_prune: row agreement sem {sem} kw {kw}")


def phase_full(corpus_bundle, results: dict):
    import dataclasses

    import torch

    from repro_torch.core.build_pipeline import build_index
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.search import SearchParams, search
    from repro_torch.core.usms import weighted_query
    from repro_torch.data.corpus import ndcg_at_k, recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import fused_topk
    from repro_torch.kernels.hybrid_distance import hybrid_distance
    from repro_torch.kernels.pairwise_tile import pairwise_tile

    c = corpus_bundle
    n = c.docs.n
    wrappers = {"hybrid_distance": hybrid_distance, "fused_topk": fused_topk,
                "pairwise_tile": pairwise_tile}
    specs = [
        ("dense_only", FusionSpec.weighted(1, 0, 0), SearchParams()),
        ("three_path", FusionSpec.three_path(), SearchParams()),
        ("minmax", FusionSpec.minmax(), SearchParams()),
        ("zscore", FusionSpec.zscore(), SearchParams()),
        ("rrf", FusionSpec.rrf(), SearchParams()),
        ("keyword", FusionSpec.three_path(), SearchParams(use_keywords=True)),
    ]
    kwds = torch.as_tensor(c.query_keywords)

    # ---- the main path: counts zeroed just before, read just after --------
    for w in wrappers.values():
        w.launches = 0
    report = {}
    t = time.perf_counter()
    with stage_counter(fused_topk) as by_stage, prune_chunks_caught(PROFILED_CHUNKS) as chunks:
        index = build_index(c.docs, report=report)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    build_launches = {k: w.launches for k, w in wrappers.items()}
    search(index, c.queries[0:64], FusionSpec.three_path(), SearchParams())  # warm-up
    runs = {}
    for name, spec, params in specs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = search(index, c.queries, spec, params, keywords=kwds)
        torch.cuda.synchronize()
        runs[name] = (res, time.perf_counter() - t)
    launches = {k: w.launches for k, w in wrappers.items()}
    for k, v in launches.items():
        results[k]["launches"] = v
        need(v > 0, f"{k} was not launched on the main path")

    st = report["stage_seconds"]
    say("phase 4 build N=%d Dd=%d: %.2f s total; " % (n, c.docs.dense.shape[1], build_s)
        + " ".join(f"{k} {v:.2f} s" for k, v in st.items()))
    say(f"phase 4 main-path launches: {json.dumps(launches)} (build "
        f"{json.dumps(build_launches)}, then 7 searches: a 64-query warm-up and six "
        f"1024-query specs)")
    say(f"phase 4 fused_topk launches by build stage (C of each launch): {json.dumps(by_stage)}")
    need(sum(by_stage.values()) == build_launches["fused_topk"],
         "fused_topk: the build's launches by stage do not add up")

    # ---- the build's own fused_topk launches: one descent round chunk and
    # one refinement round chunk of this graph, beside phase 2's uniform ids
    from repro_torch.core.build_pipeline import SINGLE_PATH_WEIGHTS
    from repro_torch.kernels.fused_topk import fused_topk_plain
    from repro_torch.kernels.hybrid_distance import hybrid_distance_plain
    from repro_torch.kernels.ref import NEG

    for label, k, w in (("real_descent_chunk", 32, None),
                        ("real_refine_round", 12, SINGLE_PATH_WEIGHTS[0])):
        q, ids = real_descent_chunk(c.docs, report["knn_ids"], k, w)
        live, uniq = pair_stats(ids, n)
        s_k, p_k = fused_topk(q, c.docs, ids, k)
        s_p, p_p = fused_topk_plain(q, c.docs, ids, k)
        full = hybrid_distance_plain(q, c.docs, ids)
        full = torch.where(ids >= 0, full, torch.full_like(full, NEG))
        err = topk_agree(s_k, p_k, s_p, p_p, full, TOL)
        del full
        ms = time_ms(lambda: fused_topk(q, c.docs, ids, k), 5)
        dev = device_ms(lambda: fused_topk(q, c.docs, ids, k), 5)
        plain_ms = time_ms(lambda: fused_topk_plain(q, c.docs, ids, k), 2, warm=1)
        nbytes, flops = scoring_work(q, c.docs, ids, ids.shape[0] * k * 8)
        say(f"phase 4 {label}: live pairs {live}, unique rows {uniq}, pairs per unique row "
            f"{live / max(uniq, 1):.3f}")
        record_check(results, "phase 4", "fused_topk",
                     f"{label} B={ids.shape[0]} C={ids.shape[1]} k={k}", err, ms, plain_ms,
                     nbytes, flops, dev)
        torch.cuda.empty_cache()

    # ---- the build's own pairwise_tile launches: its first prune chunk,
    # beside phase 2's uniform ids; then 16 consecutive prune chunks replayed
    # under torch.profiler: is the kernel on the prune stage's critical path?
    from repro_torch.core import pruning
    from repro_torch.kernels.pairwise_tile import pairwise_tile_plain

    ids = report["knn_ids"][0:1024].clamp(0, n - 1).to(torch.int32).contiguous()  # ops.py's clamp
    live, uniq = pair_stats(ids, n)
    out_k = pairwise_tile(c.docs, ids)
    err = float((out_k - pairwise_tile_plain(c.docs, ids)).abs().max().item())
    need(err <= TOL, f"pairwise_tile real prune chunk: error {err}")
    need(torch.equal(pairwise_tile(c.docs, ids), out_k), "pairwise_tile real prune chunk: two "
         "launches differ")
    ms = time_ms(lambda: pairwise_tile(c.docs, ids), 10)
    dev = device_ms(lambda: pairwise_tile(c.docs, ids), 10)
    plain_ms = time_ms(lambda: pairwise_tile_plain(c.docs, ids), 2, warm=1)
    nbytes, flops = tile_work(c.docs, ids)
    say(f"phase 4 real_prune_chunk: {live} slots, unique rows {uniq}, slots per unique row "
        f"{live / max(uniq, 1):.3f}; bound by bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
        f"by fp32 operations {flops / FP32_FLOP_PER_S * 1e3:.4f} ms, by 3xTF32 operations "
        f"{3 * flops / TF32_FLOP_PER_S * 1e3:.4f} ms")
    record_check(results, "phase 4", "pairwise_tile", "real_prune_chunk C=1024 K=32", err, ms,
                 plain_ms, nbytes, 3 * flops, dev, TF32_FLOP_PER_S)
    need(len(chunks) == PROFILED_CHUNKS, f"caught {len(chunks)} prune chunks")

    def replay():
        for args, kw in chunks:
            pruning._prune_chunk(*args, **kw)

    replay()  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    replay()
    torch.cuda.synchronize()
    bare_s = time.perf_counter() - t
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t
    kern = cuda_kernels(prof)
    busy = sum(ms for _, ms in kern.values())
    tiles = [v for k, v in kern.items() if "pairwise_tile" in k]
    need(len(tiles) > 0 and busy > 0, "phase 4: the profile shows no pairwise_tile kernel")
    tile_n, tile_ms = sum(v[0] for v in tiles), sum(v[1] for v in tiles)
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:4]
    say(f"phase 4 prune chunks, {PROFILED_CHUNKS} consecutive replayed: wall {bare_s * 1e3:.2f} ms "
        f"({bare_s * 1e3 / PROFILED_CHUNKS:.3f} a chunk; the build's prune stage "
        f"{st['prune'] * 1e3 / -(-n // 1024):.3f} a chunk), {prof_s * 1e3:.2f} ms profiled; device "
        f"busy {busy:.3f} ms ({busy / (prof_s * 1e3):.3f} of the profiled wall, "
        f"{sum(v[0] for v in kern.values())} launches); pairwise_tile {tile_n} launches "
        f"{tile_ms:.3f} ms = {tile_ms / busy:.3f} of busy; top kernels: "
        + "; ".join(f"{k[:48]} {v[0]}x {v[1]:.3f} ms" for k, v in top))
    del chunks[:]
    torch.cuda.empty_cache()

    # ---- structure ---------------------------------------------------------
    sem = index.semantic_edges
    live = sem >= 0
    need(bool(((sem >= -1) & (sem < n)).all()), "edges out of range")
    own = torch.arange(n, device=sem.device)[:, None]
    need(not bool((live & (sem == own)).any()), "self-edges")
    srt = torch.sort(sem.masked_fill(~live, -1), dim=1).values
    need(not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()), "duplicate edges")
    need(bool(live.any(dim=1).all()), "a node without edges")
    kwe = index.keyword_edges
    need(bool(((kwe >= -1) & (kwe < n)).all()), "keyword edges out of range")
    say(f"phase 4 structure: semantic edges (N, {sem.shape[1]}) in range, no self-edges, "
        f"no duplicates, every row non-empty (mean live {live.sum(1).float().mean():.2f}); "
        f"keyword edges mean live {(kwe >= 0).sum(1).float().mean():.2f}")

    # ---- kNN recall@32 on 256 sampled nodes --------------------------------
    gen = torch.Generator(device="cuda").manual_seed(11)
    sample = torch.randperm(n, generator=gen, device="cuda")[:256]
    knn = report["knn_ids"][sample]
    scores = ops.pairwise_scores_chunked(c.docs[sample], c.docs, chunk=32768)
    scores[torch.arange(256, device="cuda"), sample] = float("-inf")
    truth = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :32]
    hits = (knn[:, :, None].long() == truth[:, None, :]).any(-1).sum().item()
    say(f"phase 4 kNN recall@32 (256 sampled nodes vs brute force): {hits / (256 * 32):.4f}")
    del scores

    # ---- search quality and throughput --------------------------------------
    for name, spec, params in specs:
        res, secs = runs[name]
        need(res.ids.shape == (N_QUERIES, params.k), f"{name}: ids shape")
        ok = res.ids >= 0
        need(bool(torch.isfinite(res.scores[ok]).all()), f"{name}: non-finite scores")
        need(bool(ok[:, 0].all()), f"{name}: a query without results")
        truth = ops.topk_hybrid(weighted_query(c.queries, spec.weights), c.docs, 10,
                                chunk=8192)[1]
        rec = recall_at_k(res.ids, truth)
        nd = ndcg_at_k(res.ids, c.query_relevant, 10)
        say(f"phase 4 search {name}: {N_QUERIES} queries {secs:.3f} s QPS "
            f"{N_QUERIES / secs:.1f} vector recall@10 {rec:.4f} nDCG@10 {nd:.4f} "
            f"mean expanded {res.expanded.float().mean():.1f}")

    # ---- 64 queries through the plain versions -------------------------------
    q64 = c.queries[0:64]
    for name in ("three_path", "keyword"):
        _, spec, params = next(s for s in specs if s[0] == name)
        rk = runs[name][0]
        rp = search(index, q64, spec, dataclasses.replace(params, use_kernel=False),
                    keywords=kwds[:64])
        ids_agree(rk.ids[:64], rk.scores[:64], rp.ids, rp.scores, TOL)
    say("phase 4 plain check: 64 queries through the plain versions agree up to ties")
    return index


def phase_serving(corpus_bundle, results: dict, device: str = "cuda", keep=None):
    """Four sealed segments of 2^18 docs, fp32 and int8, served through
    HybridSearchService. (``device`` lets the phase be rehearsed on the CPU
    at a tiny size.) ``keep`` (a dict), when given, receives the two pools,
    the request specs and what each pool's service returned, for phase 13."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.distributed import SegmentedIndex
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.search import SearchParams
    from repro_torch.core.segment_pool import (
        SegmentPool,
        alive_docs_pool,
        append_segment,
        build_pool_segment,
    )
    from repro_torch.core.usms import SparseVec, quantize_corpus, weighted_query
    from repro_torch.data.corpus import ndcg_at_k, recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import fused_topk, fused_topk_int8
    from repro_torch.kernels.hybrid_distance import hybrid_distance, hybrid_distance_int8
    from repro_torch.kernels.pairwise_tile import pairwise_tile
    from repro_torch.obs.metrics import GLOBAL
    from repro_torch.serving.hybrid_service import HybridSearchService

    c = corpus_bundle
    n = c.docs.n
    wrappers = {"hybrid_distance": hybrid_distance, "hybrid_distance_int8": hybrid_distance_int8,
                "fused_topk": fused_topk, "fused_topk_int8": fused_topk_int8,
                "pairwise_tile": pairwise_tile}

    # ---- build: four sealed fp32 segments, then the int8 twin --------------
    t = time.perf_counter()
    pool = SegmentPool(groups=[])
    for s in range(n // N_SEGMENT):
        lo, hi = s * N_SEGMENT, (s + 1) * N_SEGMENT
        seg = build_pool_segment(c.docs[lo:hi], np.arange(lo, hi), BuildConfig(),
                                 generator=torch.Generator(device).manual_seed(100 + s),
                                 device=device)
        pool, g = append_segment(pool, seg)
        need(g == 0, "equal-capacity segments must share one group")
        del seg
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    pool_q = SegmentPool(groups=[SegmentedIndex(dataclasses.replace(
        g.index, corpus=quantize_corpus(g.index.corpus)), g.global_ids) for g in pool.groups])
    sync()
    quant_s = time.perf_counter() - t
    torch.cuda.empty_cache()
    say(f"phase 5 pool: {pool.n_segments} segments of {N_SEGMENT} in {pool.n_groups} group, "
        f"built in {build_s:.2f} s; int8 twin quantized in {quant_s:.3f} s")

    kwds = np.asarray(torch.as_tensor(c.query_keywords).cpu())
    specs = [("three_path", FusionSpec.three_path(), None),
             ("rrf", FusionSpec.rrf(), None),
             ("keyword", FusionSpec.three_path(), kwds)]
    truth_cache: dict = {}

    def truth(spec):
        key = tuple(float(torch.as_tensor(getattr(spec.weights, f)))
                    for f in ("dense", "sparse", "full"))
        if key not in truth_cache:
            truth_cache[key] = ops.topk_hybrid(weighted_query(c.queries, spec.weights), c.docs,
                                               10, chunk=8192)[1]
        return truth_cache[key]

    out, launches = {}, {}
    index_bytes = GLOBAL.get("allanpoe_index_bytes_total")
    for dtype, p in (("float32", pool), ("int8", pool_q)):
        index_bytes.reset()  # only this service's labels
        svc = HybridSearchService(p, SearchParams(use_keywords=True, corpus_dtype=dtype))
        gauges = {f"{leaf}/{dt}": int(v) for (leaf, dt), v in index_bytes.values().items()}
        _ = svc.path_stats  # corpus stats once, before the timed requests
        hist = svc.metrics.get("allanpoe_serving_request_latency_seconds")
        for w in wrappers.values():  # each pool's path: counts zeroed just before
            w.launches = 0
        rows = {}
        for name, spec, kw in specs:
            before = hist.snapshot()
            sync()
            t = time.perf_counter()
            res = svc.search(c.queries, spec, keywords=kw)
            secs = time.perf_counter() - t
            lat = hist.snapshot().minus(before)
            ids = res.ids.to(device)
            need(res.ids.shape == (N_QUERIES, 10), f"phase 5 {dtype} {name}: ids shape")
            ok = res.ids >= 0
            need(bool(torch.isfinite(res.scores[ok]).all()), f"phase 5 {dtype} {name}: scores")
            need(bool(ok[:, 0].all()), f"phase 5 {dtype} {name}: a query without results")
            rec = recall_at_k(ids, truth(spec))
            nd = ndcg_at_k(ids, c.query_relevant, 10)
            rows[name] = dict(qps=N_QUERIES / secs, p50_ms=lat.quantile(0.5) * 1e3,
                              p99_ms=lat.quantile(0.99) * 1e3, recall=rec, ndcg=nd, res=res)
            say(f"phase 5 serve {dtype} {name}: {N_QUERIES} queries {secs:.3f} s QPS "
                f"{N_QUERIES / secs:.1f} p50 {lat.quantile(0.5) * 1e3:.2f} ms p99 "
                f"{lat.quantile(0.99) * 1e3:.2f} ms vector recall@10 {rec:.4f} nDCG@10 {nd:.4f}")
        launches[dtype] = {k: w.launches for k, w in wrappers.items()}  # read just after
        buckets = svc.metrics.get("allanpoe_serving_batches_total").values()
        need(svc.stats.compiles == len(buckets),
             f"phase 5 {dtype}: {svc.stats.compiles} compiles for {len(buckets)} bucket shapes")
        say(f"phase 5 {dtype} index bytes: {json.dumps(gauges)}; compiles {svc.stats.compiles} "
            f"for bucket shapes {sorted(b[0] for b in buckets)} over "
            f"{svc.stats.batches} batches")
        # 64 queries through the plain versions: the same ids up to ties
        plain = HybridSearchService(p, SearchParams(use_keywords=True, corpus_dtype=dtype,
                                                    use_kernel=False))
        for name, spec, kw in specs[::2]:
            rp = plain.search(c.queries[0:64], spec, keywords=None if kw is None else kw[:64])
            rk = rows[name]["res"]
            ids_agree(rk.ids[:64], rk.scores[:64], rp.ids, rp.scores, TOL)
        say(f"phase 5 {dtype} plain check: 64 queries through the plain versions agree up to "
            "ties (three_path, keyword)")
        out[dtype] = dict(rows=rows, dense=gauges.get(f"dense/{dtype}", 0))
        del svc, plain
        torch.cuda.empty_cache()

    for dtype, other in (("float32", "int8"), ("int8", "float32")):
        say(f"phase 5 launches while the {dtype} pool served: {json.dumps(launches[dtype])}")
        for k in ("hybrid_distance", "fused_topk"):
            mine, theirs = (k, k + "_int8") if dtype == "float32" else (k + "_int8", k)
            need(launches[dtype][mine] > 0, f"{mine} was not launched while the {dtype} pool "
                 "served")
            need(launches[dtype][theirs] == 0, f"{theirs} launched while the {dtype} pool served")
    for k in ("hybrid_distance", "fused_topk"):  # fp32: phase 4's path plus this one
        results[k]["launches"] += launches["float32"][k]
        results[k + "_int8"]["launches"] = launches["int8"][k + "_int8"]
    ratio = out["int8"]["dense"] / out["float32"]["dense"]
    need(ratio <= 0.26, f"int8 dense bytes are {ratio:.4f} of fp32")
    gap = out["float32"]["rows"]["three_path"]["recall"] - out["int8"]["rows"]["three_path"][
        "recall"]
    need(abs(gap) <= RECALL_GAP, f"int8 three-path recall@10 differs from fp32 by {gap:.4f}")
    served = recall_at_k(out["int8"]["rows"]["three_path"]["res"].ids,
                         out["float32"]["rows"]["three_path"]["res"].ids)
    say(f"phase 5 int8 vs fp32: dense bytes ratio {ratio:.4f}; three-path recall@10 gap "
        f"{gap:.4f} (limit {RECALL_GAP}); served top-10 overlap {served:.4f}")

    # ---- int8 storage against fp32, independent of the graph ---------------
    # brute force over the rows a pool stores vs brute force over the fp32
    # corpus, three-path weights: top-10 overlap, and per (query, true top-10
    # doc) the score gap against what the format allows, half a quantization
    # step per dense term plus fp16 rounding (2^-11) of each sparse product
    # (vals are >= 0, so the sparse part of the score is their sum). Planted
    # faults must fail one of the two checks.
    spec3 = FusionSpec.three_path()
    qw3 = weighted_query(c.queries, spec3.weights)
    want = truth(spec3).long()
    need(all(bool((v >= 0).all()) for f in (c.docs, qw3) for v in (f.learned.val, f.lexical.val)),
         "negative sparse values: the fp16 bound below needs vals >= 0")
    s_fp32 = ops.hybrid_scores_vs_ids(qw3, c.docs, want.int())
    dense_part = torch.einsum("bd,bkd->bk", qw3.dense, c.docs.dense[want])
    q_l1 = qw3.dense.abs().sum(1, keepdim=True)

    def stored_vs_fp32(p):
        """(top-10 overlap, max score gap / allowed gap) of pool p's storage."""
        docs, gids, _ = alive_docs_pool(p)
        gids = torch.as_tensor(gids, dtype=torch.long, device=device)
        top = gids[ops.topk_hybrid(qw3, docs, 10, chunk=8192)[1].long()]
        at = torch.empty(n, dtype=torch.long, device=device)
        at[gids] = torch.arange(gids.numel(), device=device)
        scale = torch.empty(n, device=device)
        for g in p.groups:
            gid = g.global_ids.reshape(-1).long()
            scale[gid[gid >= 0]] = g.index.corpus.dense_scale.reshape(-1)[gid >= 0]
        s_stored = ops.hybrid_scores_vs_ids(qw3, docs, at[want].int())
        allowed = 0.5 * scale[want] * q_l1 + 2.0**-11 * (s_fp32 - dense_part).abs() + TOL
        return recall_at_k(top, want), float(((s_stored - s_fp32).abs() / allowed).max().item())

    def planted(fn):
        return SegmentPool(groups=[SegmentedIndex(dataclasses.replace(
            g.index, corpus=fn(g.index.corpus)), g.global_ids) for g in pool_q.groups])

    bf16 = lambda sv: SparseVec(sv.idx, sv.val.to(torch.bfloat16).to(torch.float16))
    faults = {
        "scale=1": lambda q: dataclasses.replace(q, dense_scale=torch.ones_like(q.dense_scale)),
        "scale x2": lambda q: dataclasses.replace(q, dense_scale=2 * q.dense_scale),
        "vals via bf16": lambda q: dataclasses.replace(q, learned=bf16(q.learned),
                                                       lexical=bf16(q.lexical)),
    }
    overlap, gap_ratio = stored_vs_fp32(pool_q)
    readings = {k: stored_vs_fp32(planted(fn)) for k, fn in faults.items()}
    say(f"phase 5 int8 vs fp32 brute force (three-path, top-10 of {n}): overlap {overlap:.4f} "
        f"(limit {INT8_OVERLAP}), max score gap {gap_ratio:.4f} of the allowed gap; planted "
        "faults: " + ", ".join(f"{k} overlap {ov:.4f} gap {r:.4g}x allowed"
                               for k, (ov, r) in readings.items()))
    need(overlap >= INT8_OVERLAP, f"int8 brute-force top-10 overlap {overlap:.4f}")
    need(gap_ratio <= 1.0, f"int8 score gap {gap_ratio:.4f} of the allowed gap")
    for k, (ov, r) in readings.items():
        need(ov < INT8_OVERLAP or r > 1.0, f"planted fault {k} passes the int8 checks")
    if keep is not None:
        keep.update(pools={"float32": pool, "int8": pool_q}, specs=specs, served=out)
    return pool_q, out["int8"]["rows"]["three_path"]["recall"]


def phase_mesh(corpus_bundle, served: dict, results: dict, card: str = "not a card",
               device: str = "cuda") -> None:
    """Phase 13: the index side over a device mesh of one card. An NCCL
    process group of world 1 in this process (an in-process store), a (1, 1,
    1) ("pod", "data", "model") mesh; phase 5's fp32 group and its int8 twin
    searched through the sharded search against the local pass, served by
    the mesh-fronted service, a sharded build against the sequential one, a
    descent round, planted faults, refusals and the launches of each kernel
    on these paths. (``device="cpu"`` rehearses it under gloo.)"""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as tdist
    from repro_torch.core.build_pipeline import _descent_init
    from repro_torch.core.distributed import SegmentedIndex
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.knn_graph import _descent_round_chunk, _init_graph
    from repro_torch.core.search import SearchParams
    from repro_torch.kernels.fused_topk import fused_topk, fused_topk_int8
    from repro_torch.kernels.hybrid_distance import hybrid_distance, hybrid_distance_int8
    from repro_torch.kernels.pairwise_tile import pairwise_tile
    from repro_torch.launch.mesh import all_gather_cat, axis_group, make_mesh
    from repro_torch.serving.hybrid_service import HybridSearchService

    c, t_phase = corpus_bundle, time.perf_counter()
    wrappers = {"hybrid_distance": hybrid_distance, "hybrid_distance_int8": hybrid_distance_int8,
                "fused_topk": fused_topk, "fused_topk_int8": fused_topk_int8,
                "pairwise_tile": pairwise_tile}
    counted = {k: 0 for k in wrappers}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def on_path(fn):
        """Run a main-path call with the launch counts zeroed just before and
        read just after; returns its result."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        sync()
        for k, w in wrappers.items():
            counted[k] += w.launches
        return out

    if device == "cuda":
        v = torch.cuda.nccl.version()
        say(f"phase 13 NCCL {'.'.join(map(str, v)) if isinstance(v, tuple) else v}, torch "
            f"{torch.__version__}")
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"),
                     device_type="cuda" if device == "cuda" else "cpu", store=dist.HashStore(),
                     rank=0, world_size=1, timeout_s=MESH_TIMEOUT_S)
    try:
        say(f"phase 13 mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
            f"{mesh.device_type} ({dist.get_backend()}), {tdist.mesh_segment_count(mesh)} "
            "segment device")
        kwds = served["specs"]
        n_q = c.queries.n
        pad = torch.full((n_q, 1), -1, dtype=torch.int32, device=device)

        def compare(got, want) -> list[str]:
            """(a)'s comparison: what differs, empty when it holds."""
            bad = []
            if not torch.equal(got.ids, want.ids):
                bad.append(f"ids differ in {int((got.ids != want.ids).any(1).sum())} rows")
            for f in ("scores", "path_scores"):
                gap = float((getattr(got, f) - getattr(want, f)).abs().max())
                if not gap <= MESH_TOL:
                    bad.append(f"{f} differ by {gap:.3g}")
            if not torch.equal(got.expanded, want.expanded):
                bad.append(f"expanded {int(got.expanded[0])} != {int(want.expanded[0])}")
            return bad

        # ---- (a) the sharded search against the local pass ------------------
        planted: dict = {}
        for dtype, pool in served["pools"].items():
            group = pool.groups[0]
            params = SearchParams(use_keywords=True, corpus_dtype=dtype)
            block = tdist.place_segmented_index(group, mesh)
            dist_fn = tdist.make_distributed_search_padded(mesh, params)
            local_fn = tdist.make_local_group_search(params)
            for name, spec, kw in kwds:
                kwt = pad if kw is None else torch.as_tensor(kw, device=device)
                t = time.perf_counter()
                got = on_path(lambda: dist_fn(block, c.queries, spec, kwt, pad))
                d_s = time.perf_counter() - t
                t = time.perf_counter()
                want = local_fn(group, c.queries, spec, kwt, pad)
                sync()
                l_s = time.perf_counter() - t
                bad = compare(got, want)
                say(f"phase 13 (a) {dtype} {name}: sharded {d_s:.3f} s, local {l_s:.3f} s, "
                    f"{n_q} queries: " + ("; ".join(bad) or "ids equal, scores and path scores "
                                          f"within {MESH_TOL}, expanded {int(got.expanded[0])}"))
                need(not bad, f"phase 13 (a) {dtype} {name}: {bad}")
                if dtype == "float32" and name == "three_path":
                    planted["want"], planted["args"] = want, (block, spec, kwt)

        # ---- (e) planted faults: each must fail (a)'s comparison -----------
        block, spec, kwt = planted["args"]
        dist_fn = tdist.make_distributed_search_padded(
            mesh, SearchParams(use_keywords=True, corpus_dtype="float32"))
        gids = block.global_ids.clone()
        gids[0] = torch.roll(gids[0], 1)
        rotated = SegmentedIndex(block.index, gids)
        search_segments = tdist._search_segments

        def dropping(*a, **k):
            g, sc, ps, total = search_segments(*a, **k)
            g, sc = g.clone(), sc.clone()
            g[1], sc[1] = -1, float("-inf")  # segment 1's results never reach the merge
            return g, sc, ps, total

        faults = {"segment 0's global ids rotated": lambda: dist_fn(rotated, c.queries, spec, kwt,
                                                                    pad)}
        readings = {name: compare(fn(), planted["want"]) for name, fn in faults.items()}
        tdist._search_segments = dropping
        try:
            readings["segment 1's results dropped before the merge"] = compare(
                dist_fn(block, c.queries, spec, kwt, pad), planted["want"])
        finally:
            tdist._search_segments = search_segments
        for name, bad in readings.items():
            say(f"phase 13 (e) planted {name}: " + ("; ".join(bad) or "passes"))
            need(bool(bad), f"phase 13 (e) planted fault passes (a): {name}")

        # ---- (b) the mesh-fronted service over the SegmentedIndex ----------
        for dtype, pool in served["pools"].items():
            group = pool.groups[0]
            with HybridSearchService(group, SearchParams(use_keywords=True, corpus_dtype=dtype),
                                     mesh=mesh) as svc:
                _ = svc.path_stats
                for name, spec, kw in kwds:
                    sync()
                    t = time.perf_counter()
                    res = on_path(lambda: svc.search(c.queries, spec, keywords=kw))
                    secs = time.perf_counter() - t
                    row = served["served"][dtype]["rows"][name]
                    same = torch.equal(res.ids, row["res"].ids)
                    say(f"phase 13 (b) {dtype} {name}: mesh-fronted service QPS "
                        f"{n_q / secs:.1f}, phase 5's pool service QPS {row['qps']:.1f} "
                        f"({card}); ids {'equal' if same else 'DIFFER'}")
                    need(same, f"phase 13 (b) {dtype} {name}: ids differ from phase 5's")
                say(f"phase 13 (b) {dtype}: {svc.stats.batches} batches, "
                    f"{svc.stats.compiles} compiles")

        # ---- (c) the sharded build against the sequential one --------------
        docs = c.docs[0:MESH_BUILD_DOCS]
        cfg = MESH_BUILD or BuildConfig()
        sync()
        t = time.perf_counter()
        sharded = on_path(lambda: tdist.build_index_sharded(docs, MESH_BUILD_SEGMENTS, cfg,
                                                            mesh=mesh, seed=MESH_SEED))
        sharded_s = time.perf_counter() - t
        t = time.perf_counter()
        seq = tdist.build_segmented_index(docs, MESH_BUILD_SEGMENTS, cfg, seed=MESH_SEED,
                                          device=device)
        sync()
        seq_s = time.perf_counter() - t
        names = [f"corpus[{i}]" for i in range(5)] + [
            "semantic_edges", "keyword_edges", "logical_edges", "doc_entities", "entity_to_docs",
            "entity_adj", "entry_points", "alive", "self_ip", "global_ids"]
        differ = [n for n, a, b in zip(names, sharded.leaves(), seq.leaves()) if not torch.equal(a, b)]
        say(f"phase 13 (c) build of {MESH_BUILD_DOCS} docs as {MESH_BUILD_SEGMENTS} segments: "
            f"sharded {sharded_s:.2f} s, sequential {seq_s:.2f} s; every array "
            + ("bit-equal" if not differ else f"but {differ} bit-equal"))
        need(not differ, f"phase 13 (c): {differ} differ from the sequential build")

        # ---- (d) one descent round on one segment --------------------------
        knn = cfg.knn
        seg0 = docs[0:MESH_BUILD_DOCS // MESH_BUILD_SEGMENTS]
        n0 = seg0.n
        gen = torch.Generator(device=device).manual_seed(MESH_SEED)
        nbr, sc = _descent_init(seg0, None, _init_graph(n0, knn.k, gen, device), knn)
        rand = torch.randint(0, n0, (n0, knn.extra_random), generator=gen, device=device,
                             dtype=torch.int32)
        stack1 = lambda t: t[None]
        round_fn = tdist.make_distributed_descent_round(mesh, knn)
        t = time.perf_counter()
        ids_d, sc_d = on_path(lambda: round_fn(tdist.map_corpus(seg0, stack1), nbr[None],
                                               sc[None], rand[None]))
        d_s = time.perf_counter() - t
        node_ids = torch.arange(n0, dtype=torch.int32, device=device)
        ids_r, sc_r = _descent_round_chunk(seg0, nbr, seg0, node_ids, nbr, sc, rand, knn)
        same = torch.equal(ids_d[0], ids_r) and torch.equal(sc_d[0], sc_r)
        say(f"phase 13 (d) descent round over {n0} nodes (k {knn.k}): {d_s:.3f} s, "
            + ("bit-equal to _descent_round_chunk" if same else "DIFFERS"))
        need(same, "phase 13 (d): the descent round differs from _descent_round_chunk")

        # ---- refusals: nothing falls back -----------------------------------
        tries = {
            "a mesh of 2 on a world of 1": lambda: make_mesh((2, 1, 1), ("pod", "data", "model"),
                                                             device_type=mesh.device_type),
            "a cpu mesh on the nccl group": lambda: make_mesh((1,), ("data",), device_type="cpu"),
            "a cpu tensor in a cuda collective": lambda: all_gather_cat(
                mesh, torch.zeros(2), axis_group(mesh, ("data",))),
        }
        if device != "cuda":
            tries.pop("a cpu mesh on the nccl group")
            tries.pop("a cpu tensor in a cuda collective")
        refused = {}
        for name, fn in tries.items():
            try:
                fn()
                refused[name] = "passed"
            except (RuntimeError, ValueError) as e:
                refused[name] = f"raised {type(e).__name__}"
        say("phase 13 refusals: " + "; ".join(f"{k}: {v}" for k, v in refused.items()))
        need(all(v != "passed" for v in refused.values()), f"phase 13: a fallback {refused}")
    finally:
        dist.destroy_process_group()

    # ---- (f) launches on the phase's paths ---------------------------------
    say(f"phase 13 (f) launches on the mesh paths: {json.dumps(counted)}")
    for k, n in counted.items():
        if device == "cuda":
            need(n > 0, f"phase 13: {k} was not launched on the mesh paths")
        results[k]["launches"] += n
    say(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


def graph_reach(idx):
    """Per row of one index: alive and reached from its entry points along
    semantic edges, by a breadth-first walk over every node, dead ones
    included, as a search expands them (host bool array). The witness of
    read-your-writes that no search computes."""
    import torch

    sem = idx.semantic_edges
    seen = torch.zeros(sem.shape[0], dtype=torch.bool, device=sem.device)
    front = idx.entry_points[idx.entry_points >= 0].long()
    seen[front] = True
    while front.numel():
        nb = sem[front].reshape(-1).long()
        nb = nb[(nb >= 0) & (nb < sem.shape[0])]
        front = nb[~seen[nb]].unique()
        seen[front] = True
    return (seen & idx.alive).cpu().numpy()


def widen_ell(f, learned: int, lexical: int):
    """Rows of ``f`` with their ELL widths padded (PAD ids, zero values) to
    (learned, lexical): doc rows and query rows then share one bucket."""
    import torch

    from repro_torch.core.usms import FusedVectors, SparseVec

    def pad(sv, w):
        extra = w - sv.idx.shape[1]
        if extra <= 0:
            return sv
        n = sv.idx.shape[0]
        return SparseVec(
            torch.cat([sv.idx, sv.idx.new_full((n, extra), -1)], 1),
            torch.cat([sv.val, sv.val.new_zeros((n, extra))], 1))

    return FusedVectors(f.dense, pad(f.learned, learned), pad(f.lexical, lexical))


def phase_write(corpus_bundle, pool_q, results: dict, int8_recall: float, device: str = "cuda"):
    """The write path at full width: phase 5's int8 pool served with a
    SegmentRouter attached (default RouterConfig: seal at 256 live grow
    docs, incremental compaction, pow2 seals, tier fanout 4, background
    merges), while a writer thread upserts WRITE_BATCHES x WRITE_BATCH
    sealed docs (delete by global id, re-insert the fp32 vectors under a
    fresh id) with 64 further deletes after every fourth batch, and reader
    threads submit
    phase 5's queries through the pump. Gates: read-your-writes (the index
    and the service), deletes, persistence, and three planted faults. (``device`` lets the phase be
    rehearsed on the CPU at a tiny size.)"""
    import tempfile
    import threading

    import numpy as np
    import torch

    from repro_torch.checkpoint import load_pool, save_pool
    from repro_torch.core import build_pipeline as bp
    from repro_torch.core.distributed import make_local_group_search
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.search import SearchParams, search_padded
    from repro_torch.core.segment_pool import group_shape_key, live_counts
    from repro_torch.core.usms import weighted_query
    from repro_torch.data.corpus import recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import fused_topk, fused_topk_int8
    from repro_torch.kernels.hybrid_distance import hybrid_distance, hybrid_distance_int8
    from repro_torch.kernels.pairwise_tile import pairwise_tile
    from repro_torch.runtime import dispatch
    from repro_torch.serving import segment_router as sr
    from repro_torch.serving.batcher import SearchRequest
    from repro_torch.serving.hybrid_service import HybridSearchService

    c = corpus_bundle
    n = c.docs.n
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    wrappers = {"hybrid_distance": hybrid_distance, "hybrid_distance_int8": hybrid_distance_int8,
                "fused_topk": fused_topk, "fused_topk_int8": fused_topk_int8,
                "pairwise_tile": pairwise_tile}
    batch, n_batches = WRITE_BATCH, WRITE_BATCHES
    rng = np.random.default_rng(8)
    order = rng.permutation(n)
    picks = order[: batch * n_batches]  # upserted: deleted, then re-inserted
    spare = iter(order[batch * n_batches:])  # sealed ids for the further deletes and faults
    widths = (c.docs.learned.idx.shape[1], c.docs.lexical.idx.shape[1])
    qpad = widen_ell(c.queries, *widths)
    kwds = np.asarray(torch.as_tensor(c.query_keywords).cpu())
    specs = [("three_path", FusionSpec.three_path(), None), ("rrf", FusionSpec.rrf(), None),
             ("keyword", FusionSpec.three_path(), kwds)]
    dense_only = FusionSpec.weighted(1.0, 0.0, 0.0)
    params = SearchParams(use_keywords=True, corpus_dtype="int8")

    svc = HybridSearchService(pool_q, params)
    router = sr.SegmentRouter(svc, BuildConfig())
    sealed_key = group_shape_key(pool_q.groups[0])

    # compactions and merges, timed where the router calls them
    comps, merges = [], []
    sound_compact, sound_merge = router.compact_incremental, router._merge_segments_locked

    def timed_compact(**kw):
        live = router.live_grow_size
        t = time.perf_counter()
        v = sound_compact(**kw)
        sync()
        comps.append((time.perf_counter() - t, live))
        return v

    def timed_merge(a, b, **kw):
        live = {(g, s): lv for g, s, _, lv in live_counts(router.pool)}
        t = time.perf_counter()
        v = sound_merge(a, b, **kw)
        sync()
        merges.append((time.perf_counter() - t, live[a] + live[b]))
        return v

    router.compact_incremental, router._merge_segments_locked = timed_compact, timed_merge

    del_time: dict = {}  # global id -> perf_counter when its delete returned
    seen: list = []  # (submit time, ids) of every result in the phase
    seen_lock = threading.Lock()

    def delete(ids):
        t = time.perf_counter()
        svc.mark_deleted(np.asarray(ids))
        done = time.perf_counter()
        for i in ids:
            del_time[int(i)] = done
        return done - t

    local_search = make_local_group_search(params)

    def findable(snap, q, new_ids) -> np.ndarray:
        """Per doc: does a search of the segments that can hold it (the grow
        segment and the groups sealed during this phase), on the same
        snapshot and params, find its new id in the top 10?"""
        pad = torch.full((q.n, 1), -1, dtype=torch.int32, device=device)
        found = [np.zeros((q.n, 0), np.int64)]
        if snap.grow is not None:
            r = search_padded(snap.grow, q, dense_only, pad, pad, params)
            gmap = snap.grow_gids.cpu().numpy()
            loc = r.ids.cpu().numpy()
            found.append(np.where(loc >= 0, gmap[np.clip(loc, 0, gmap.size - 1)], -1))
        for g in snap.index.groups:
            if g.global_ids.shape[1] < N_SEGMENT:
                found.append(local_search(g, q, dense_only, pad, pad).ids.cpu().numpy())
        found = np.concatenate(found, axis=1)
        return np.asarray([nid in row for row, nid in zip(found, new_ids)])

    def reached(snap, new_ids) -> tuple[np.ndarray, np.ndarray]:
        """The index witness, independent of any search: per doc, is it
        alive under its new id in a segment whose entry points reach it
        along semantic edges (a breadth-first walk over every node, dead
        ones included, as a search expands them)? A search whose pool
        covers the segment expands every such node, and a doc's own unit
        vector scores highest against itself. Also the holding segment's
        capacity (0: held nowhere)."""
        ok = np.zeros(new_ids.size, bool)
        cap = np.zeros(new_ids.size, np.int64)
        segs = [] if snap.grow is None else [(snap.grow, snap.grow_gids.cpu().numpy())]
        for g in snap.index.groups:
            if g.global_ids.shape[1] < N_SEGMENT:
                gids = g.global_ids.cpu().numpy()
                segs += [(g.segment(s), gids[s]) for s in range(gids.shape[0])]
        for idx, gids in segs:
            rows = {int(gid): r for r, gid in enumerate(gids) if gid >= 0}
            at = [(i, rows[int(nid)]) for i, nid in enumerate(new_ids) if int(nid) in rows]
            if not at:
                continue
            live = graph_reach(idx)
            for i, r in at:
                ok[i], cap[i] = bool(live[r]), idx.n
        return ok, cap

    def probe(src_rows, new_ids, old_ids):
        """Own-vector queries under dense-only weights through the service,
        on a snapshot no publish changed during the call: per doc, (new id
        returned and old id not, found by its segments' own search, reached
        in its segment's graph, that segment's capacity)."""
        q = widen_ell(c.docs[torch.as_tensor(src_rows, device=device)], *widths)
        t0 = time.perf_counter()
        for _ in range(5):
            v0 = svc.snapshot_version
            t = time.perf_counter()
            res = svc.search(q, dense_only, k=10)
            snap = svc._snap
            if snap.version == v0:
                break
        t1 = time.perf_counter()
        ids = res.ids.numpy()
        with seen_lock:
            seen.extend((t, row) for row in ids)
        served = np.asarray([(nid in row) and (oid not in row)
                             for row, nid, oid in zip(ids, new_ids, old_ids)])
        found = findable(snap, q, new_ids)
        clock["probe"] += t1 - t0
        clock["findable"] += time.perf_counter() - t1
        return (served, found) + reached(snap, new_ids)

    # warm-up: every spec once, so the sealed group's key is seen
    for _, spec, kw in specs:
        svc.search(qpad[0:32], spec, keywords=None if kw is None else kw[:32])
    need(sealed_key in {k[0] for k in svc.executable_cache}, "phase 8: sealed key not seen")
    # control: the same own-vector probe over sealed docs the write path
    # leaves alone, read beside the re-inserted docs' share
    ctrl = order[batch * n_batches:][-256:]
    got = svc.search(widen_ell(c.docs[torch.as_tensor(ctrl, device=device)], *widths),
                     dense_only, k=10).ids.numpy()
    say(f"phase 8 control: the service returns {sum(d in r for r, d in zip(got, ctrl))}/"
        f"{ctrl.size} sealed docs the write path leaves alone for their own vectors "
        f"(dense-only, top 10, segments of {N_SEGMENT})")
    svc.start_pump(0.002)
    hist = svc.metrics.get("allanpoe_serving_request_latency_seconds")
    before = hist.snapshot()
    rows0 = dispatch.build_rows()
    errors: list = []
    # the readers' chunks of 32 queries are spread over the stream: chunk j
    # goes out once the writer has finished j / n_chunks of its batches
    n_chunks = c.queries.n // 32
    progress, cv = [0], threading.Condition()
    busy: list = []  # (first submit, last result) of every reader chunk

    def reader(r: int):
        try:
            for j in range(r, n_chunks, 2):
                with cv:
                    cv.wait_for(lambda: progress[0] >= j * n_batches // n_chunks)
                name, spec, kw = specs[j % len(specs)]
                pend = []
                for q in range(32 * j, 32 * j + 32):
                    kws = None if kw is None else kw[q][kw[q] >= 0]
                    t = time.perf_counter()
                    pend.append((t, svc.submit(SearchRequest(
                        query=qpad[q], fusion=spec, k=10,
                        keywords=kws if kws is not None and len(kws) else None))))
                for t, p in pend:
                    ids, _ = p.result()
                    with seen_lock:
                        seen.append((t, ids))
                busy.append((pend[0][0], time.perf_counter()))
        except Exception as e:  # noqa: BLE001 - reported by the gate below
            errors.append(e)

    ins_s, del_s, ryw1 = [], [], []
    clock = {"probe": 0.0, "findable": 0.0}
    reinserted = np.empty(0, np.int64)
    new_of = {}  # re-inserted global id -> source row in c.docs
    stable = True

    def writer():
        nonlocal reinserted, stable
        try:
            for b in range(n_batches):
                src = picks[b * batch:(b + 1) * batch]
                del_s.append(delete(src))
                first = router._next_gid
                t = time.perf_counter()
                svc.insert(c.docs[torch.as_tensor(src, device=device)])
                ins_s.append(time.perf_counter() - t)
                new = np.arange(first, first + batch)
                need(router._next_gid == first + batch, "phase 8: ids not allocated in order")
                stable &= sealed_key in {k[0] for k in svc.executable_cache}
                new_of.update(zip(new.tolist(), src.tolist()))
                reinserted = np.concatenate([reinserted, new])
                ryw1.append((new, src) + probe(src, new, src))
                if b % 4 == 3:
                    # further deletes: half sealed ids the readers were just
                    # returned (so a missed tombstone would show), half
                    # re-inserted ids
                    with seen_lock:
                        recent = np.concatenate([ids for _, ids in seen[-4096:]])
                    recent = np.setdiff1d(recent[(recent >= 0) & (recent < n)], picks)
                    recent = np.asarray([i for i in recent if int(i) not in del_time])
                    sealed_v = rng.choice(recent, min(batch // 2, recent.size), replace=False)
                    sealed_v = np.concatenate([sealed_v, [next(spare) for _ in
                                                          range(batch // 2 - sealed_v.size)]])
                    live_new = np.asarray([g for g in reinserted if g not in del_time])
                    victims = np.concatenate([sealed_v,
                                              rng.choice(live_new, batch // 2, replace=False)])
                    del_s.append(delete(victims.astype(np.int64)))
                with cv:
                    progress[0] = b + 1
                    cv.notify_all()
        except Exception as e:  # noqa: BLE001 - reported by the gate below
            errors.append(e)
        finally:
            with cv:
                progress[0] = n_batches
                cv.notify_all()

    batches0, requests0 = svc.stats.batches, svc.stats.requests
    for w in wrappers.values():  # the phase's main path: counts zeroed just before
        w.launches = 0
    readers = [threading.Thread(target=reader, args=(r,)) for r in range(2)]
    wt = threading.Thread(target=writer)
    t0 = time.perf_counter()
    for th in readers + [wt]:
        th.start()
    wt.join()
    for th in readers:
        th.join()
    sync()
    wall = time.perf_counter() - t0
    lat = hist.snapshot().minus(before)
    launches = {k: w.launches for k, w in wrappers.items()}  # read just after
    need(not errors, f"phase 8: {errors[:1]}")
    router.wait_merges()
    if svc.grow_index is not None:  # deletes of grow docs can leave a short grow segment
        router.compact()
        router.wait_merges()
    svc.stop_pump()
    router.compact_incremental, router._merge_segments_locked = sound_compact, sound_merge

    n_ins = batch * n_batches
    pct = lambda xs, q: float(np.quantile(np.asarray(xs), q))
    say(f"phase 8 write path: {n_ins} docs upserted in {n_batches} batches of {batch}, "
        f"{len(del_s)} delete calls ({len(del_time)} ids), {32 * len(busy)} reader requests, "
        f"wall {wall:.2f} s")
    say(f"phase 8 insert: {n_ins / sum(ins_s):.1f} docs/s, p50 {pct(ins_s, 0.5):.4f} s p99 "
        f"{pct(ins_s, 0.99):.4f} s per call of {batch}; delete p50 {pct(del_s, 0.5):.4f} s per "
        "call")
    n_b, n_r = svc.stats.batches - batches0, svc.stats.requests - requests0
    say(f"phase 8 writer's time: inserts {sum(ins_s):.2f} s, deletes {sum(del_s):.2f} s, "
        f"read-your-writes probes through the service {clock['probe']:.2f} s, the holding "
        f"segments' own searches {clock['findable']:.2f} s; the service ran {n_b} batches for "
        f"{n_r} requests ({n_r / max(n_b, 1):.1f} a batch)")
    say(f"phase 8 compactions: {len(comps)} ({sum(x for x, _ in comps):.3f} s, each "
        f"{', '.join(f'{x:.3f}' for x, _ in comps)}); merges: {len(merges)} "
        f"({sum(x for x, _ in merges):.3f} s, each {', '.join(f'{x:.3f}' for x, _ in merges)})")
    pool = router.pool
    say(f"phase 8 end: {pool.n_groups} groups, {pool.n_segments} segments, capacities "
        f"{list(pool.capacities)}; router {router.stats}")
    # QPS over the time some reader had requests in flight
    union, end = 0.0, 0.0
    for a, b in sorted(busy):
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    say(f"phase 8 search under writes: {32 * len(busy) / union:.1f} QPS while reads were in "
        f"flight ({union:.2f} s), p50 "
        f"{lat.quantile(0.5) * 1e3:.2f} ms p99 {lat.quantile(0.99) * 1e3:.2f} ms per request; "
        f"sealed_cache_stable {stable}; grow shape keys {len(svc.grow_shape_keys)}")
    built = dispatch.build_rows() - rows0
    want_rows = n_ins + sum(lv for _, lv in comps) + sum(lv for _, lv in merges)
    say(f"phase 8 build_rows {built}: inserted {n_ins} + compacted "
        f"{sum(lv for _, lv in comps)} + merged {sum(lv for _, lv in merges)} = {want_rows}")
    say(f"phase 8 launches during the stream: {json.dumps(launches)}")
    need(stable, "phase 8: an insert evicted the sealed group's key")
    need(built == want_rows, f"phase 8: build_rows {built} != {want_rows}")
    need(len(comps) >= n_ins // sr.RouterConfig().seal_threshold - 1,
         f"phase 8: {len(comps)} compactions")
    for k, v in launches.items():
        need(v > 0 or device != "cuda", f"phase 8: {k} was not launched on the write path")
        results[k]["launches"] += v

    # ---- read-your-writes, twice ------------------------------------------
    def share(parts, when):
        """The gates, on every re-inserted doc probed: (index) at least
        REACH_FLOOR of them reached in their segment's graph, an absolute
        share held against a witness no search computes; (service) at least
        RYW_SHARE of those their segments' own search finds returned under
        the new id, never the old one. Also the share the service returned
        of all, by the capacity of the holding segment."""
        new, old, served, found, ok, cap = (np.concatenate([p[i] for p in parts])
                                            for i in range(6))
        h, f = int((served & found).sum()), int(found.sum())
        miss = [(int(o), int(nw)) for o, nw, sv, fd in zip(old, new, served, found)
                if fd and not sv]
        lost = [(int(o), int(nw), int(cp)) for o, nw, r, cp in zip(old, new, ok, cap) if not r]
        by_cap = {int(cp): f"{int(served[cap == cp].sum())}/{int(found[cap == cp].sum())}/"
                           f"{int((cap == cp).sum())}" for cp in np.unique(cap)}
        say(f"phase 8 read-your-writes {when}: reached in the holding segment's graph "
            f"{int(ok.sum())}/{new.size} = {ok.mean():.4f} (not reached, as (old, new, "
            f"capacity): {lost[:8]}); returned {h}/{f} = {h / max(f, 1):.4f} of the docs their "
            f"segments' own search finds (misses as (old, new) id: {miss[:8]}); returned "
            f"{int(served.sum())}/{new.size} = {served.mean():.4f} of all; by holding capacity "
            f"returned/found/docs {by_cap}")
        need(ok.mean() >= REACH_FLOOR, f"phase 8 read-your-writes {when}: reached "
             f"{int(ok.sum())}/{new.size}")
        need(f > 0 and h / f >= RYW_SHARE, f"phase 8 read-your-writes {when}: {h}/{f}")

    share(ryw1, "after each insert")
    alive_new = np.asarray([g for g in reinserted if g not in del_time])
    ryw2 = []
    for s in range(0, alive_new.size, 256):
        ids = alive_new[s:s + 256]
        src = np.asarray([new_of[int(g)] for g in ids])
        ryw2.append((ids, src) + probe(src, ids, src))
    share(ryw2, "after wait_merges")

    # ---- deletes: no deleted id after its delete returned -------------------
    def violations():
        bad = 0
        for t, ids in seen:
            bad += sum(1 for i in ids if i >= 0 and del_time.get(int(i), np.inf) < t)
        return bad

    bad = violations()
    say(f"phase 8 deletes: {bad} deleted ids in {len(seen)} results returned for requests "
        f"submitted after the delete returned")
    need(bad == 0, f"phase 8: {bad} deleted ids returned")

    # ---- recall@10 against brute force over the live docs ------------------
    live_sealed = np.setdiff1d(np.arange(n), np.fromiter(del_time, np.int64))
    live_ids = np.concatenate([live_sealed, alive_new])
    src_rows = np.concatenate([live_sealed, [new_of[int(g)] for g in alive_new]])
    live_docs = c.docs[torch.as_tensor(src_rows, device=device)]
    qw3 = weighted_query(c.queries, FusionSpec.three_path().weights)
    truth = torch.as_tensor(live_ids, device=device)[
        ops.topk_hybrid(qw3, live_docs, 10, chunk=8192)[1].long()]
    del live_docs
    final = svc.search(qpad, FusionSpec.three_path())
    rec = recall_at_k(final.ids, truth)
    say(f"phase 8 recall@10 (three-path, brute force over {live_ids.size} live docs): "
        f"{rec:.4f}; phase 5 int8 {int8_recall:.4f}")

    # ---- persistence: save_pool -> load_pool -> the same results, bitwise ---
    pool = router.pool
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pool_") as d:
        t = time.perf_counter()
        save_pool(d, pool)
        save_s = time.perf_counter() - t
        nbytes = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
        manifest = json.loads(next(Path(d).glob("step_*/manifest.json")).read_text())
        t = time.perf_counter()
        loaded = load_pool(d, device=device)
        sync()
        load_s = time.perf_counter() - t
    a = HybridSearchService(pool, params).search(qpad, FusionSpec.three_path())
    b = HybridSearchService(loaded, params).search(qpad, FusionSpec.three_path())
    same = torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    say(f"phase 8 persistence: {nbytes} bytes on disk, save {save_s:.3f} s, load {load_s:.3f} s; "
        f"pool_groups {manifest['pool_groups']}, quantization "
        f"{json.dumps(manifest['quantization'])}; loaded pool gives the same ids and scores "
        f"bitwise for {c.queries.n} queries: {same}")
    need(same, "phase 8: the loaded pool answers differently")
    del loaded

    # ---- planted faults: each must fail a gate above ------------------------
    src = np.asarray([next(spare) for _ in range(batch)])
    delete(src)
    first = router._next_gid
    svc._merge_grow = lambda snap, args, ids, scores, ps, expanded, phases: (
        ids, scores, ps, expanded)  # a service that skips the grow merge
    try:
        svc.insert(c.docs[torch.as_tensor(src, device=device)])
        new = np.arange(first, first + batch)
        share([(new, src) + probe(src, new, src)], "with planted fault no grow merge")
        caught = False
    except SmokeFailure:
        caught = True  # a gate failed, as it must
    finally:
        del svc._merge_grow
    need(caught, "planted fault (no grow merge) passes read-your-writes")
    # an insert that skips the back-link pass: no row before the batch links
    # to it, so the index gate must fail
    need(svc.grow_index is not None, "phase 8: no grow segment for the back-link fault")
    src = np.asarray([next(spare) for _ in range(batch)])
    delete(src)
    first = router._next_gid
    sound_link = bp._back_link
    bp._back_link = lambda sem_old, merged_ids, n_old, k: sem_old.clone()
    try:
        svc.insert(c.docs[torch.as_tensor(src, device=device)])
    finally:
        bp._back_link = sound_link
    new = np.arange(first, first + batch)
    part = (new, src) + probe(src, new, src)
    try:
        share([part], "with planted fault no back-links")
    except SmokeFailure:
        pass
    need(part[4].mean() < REACH_FLOOR, "planted fault (no back-links) passes the index gate")
    # sealed docs the final search returned, deleted, then the same queries
    # asked again: a router that never tombstones sealed ids returns them
    fin = final.ids.numpy()
    rows, victims = [], []
    for r, row in enumerate(fin):
        v = [int(i) for i in row if 0 <= i < n and int(i) not in del_time and i not in victims]
        if v and len(victims) < batch:
            rows.append(r)
            victims.append(v[0])
    sound_mark = sr.mark_deleted_pool
    sr.mark_deleted_pool = lambda pool, ids, resolved=None: pool  # sealed ids never tombstoned
    try:
        seen.clear()
        delete(victims)
        t = time.perf_counter()
        again = svc.search(qpad[torch.as_tensor(rows, device=device)],
                           FusionSpec.three_path()).ids.numpy()
        seen.extend((t, row) for row in again)
    finally:
        sr.mark_deleted_pool = sound_mark
    bad = violations()
    say(f"phase 8 planted fault no sealed tombstones: {bad} deleted ids returned")
    need(bad > 0, "planted fault (no sealed tombstones) passes the delete gate")
    router.stop_merge_worker()


def ring_witness(names, vnodes: int, ids):
    """Home replica index per id by BLAKE2b consistent hashing, computed here
    with hashlib apart from the program (each replica's ``{name}#{v}``
    virtual nodes on a sorted ring; an id's 8 big-endian bytes go to their
    hash's successor)."""
    import hashlib

    import numpy as np

    h = lambda b: int.from_bytes(hashlib.blake2b(b, digest_size=8).digest(), "big")
    ring = sorted((h(f"{n}#{v}".encode()), i) for i, n in enumerate(names) for v in range(vnodes))
    keys = np.asarray([k for k, _ in ring], np.uint64)
    owner = np.asarray([o for _, o in ring])
    hs = np.asarray([h(int(g).to_bytes(8, "big")) for g in ids], np.uint64)
    return owner[np.searchsorted(keys, hs, side="right") % len(keys)]


def stack_segments(segs):
    """A pool of sealed one-segment indexes: equal capacities concatenated
    into one group each (one copy, where appending them one by one copies
    the group again per segment), groups in the order of first appearance."""
    import torch

    from repro_torch.core.segment_pool import SegmentPool, append_segment

    by_cap: dict = {}
    for seg in segs:
        by_cap.setdefault(int(seg.global_ids.shape[1]), []).append(seg)
    pool = SegmentPool(groups=[])
    for same in by_cap.values():
        cat = iter([torch.cat(col) for col in zip(*(seg.leaves() for seg in same))])
        pool, _ = append_segment(pool, same[0].map(lambda t: next(cat)))
    return pool


def same_up_to_ties(a_ids, a_scores, b_ids, b_scores, decimals=None) -> bool:
    """The same scores in the same order and, per equal-score group, the same
    ids (host arrays, rows of equal length). ``decimals``: scores compared
    rounded to that many places (two searches that summed a doc's score in
    another order), else bit for bit."""
    import numpy as np

    a_ids, b_ids = np.asarray(a_ids), np.asarray(b_ids)
    a_scores, b_scores = np.asarray(a_scores), np.asarray(b_scores)
    if decimals is not None:
        a_scores, b_scores = np.round(a_scores, decimals), np.round(b_scores, decimals)
    if a_ids.shape != b_ids.shape or not np.array_equal(a_scores, b_scores):
        return False
    for ai, bi, sc in zip(a_ids, b_ids, a_scores):
        for v in np.unique(sc):
            if set(ai[sc == v].tolist()) != set(bi[sc == v].tolist()):
                return False
    return True


def phase_text(results: dict, device: str = "cuda"):
    """SynCorpus text through the ingest pipeline into a replica tier
    (benchmarks/fig14_scale.py's build_tier, at TEXT_DOCS = 65,536 of its
    largest 100,000): fit on a strided sample, encode every doc, shard by
    the consistent-hash ring into R = 4 replicas and R = 1, each shard
    sealed every 256 rows into pooled segments with the KG, every replica a
    HybridSearchService and a SegmentRouter behind a ReplicaRouter;
    isolated, model and tier QPS, scaling efficiency, recall@10, a batch
    under adaptive fusion with the KG on; the kernels at the shapes this
    path gave them and its launches by part (builds, reads, the KG read,
    streamed inserts); then eight gates, each with a planted fault that
    must fail it. (``device`` lets the phase be rehearsed on the CPU at a
    tiny size.)"""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import load_ingest, load_pool, save_pool
    from repro_torch.core.fusion import FUSION_MODE_NAMES, FusionSpec
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.knn_graph import KnnConfig
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.core.search import SearchParams, search
    from repro_torch.core.segment_pool import SegmentPool, build_pool_segment
    from repro_torch.core.usms import cat_fused, weighted_query
    from repro_torch.data.corpus import recall_at_k
    from repro_torch.data.syncorpus import SynCorpus, SynCorpusConfig
    from repro_torch.data.textcorpus import load_bundled_corpus, topic_truth
    from repro_torch.ingest import IngestConfig, IngestPipeline, adaptive_fusion_for
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import fused_topk, fused_topk_int8
    from repro_torch.kernels.hybrid_distance import hybrid_distance, hybrid_distance_int8
    from repro_torch.kernels.pairwise_tile import pairwise_tile
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serving.batcher import BatcherConfig, _next_pow2
    from repro_torch.serving.hybrid_service import HybridSearchService, ServiceConfig
    from repro_torch.serving.rag import RagConfig, RagPipeline
    from repro_torch.serving.replica_router import (
        Replica,
        ReplicaRouter,
        ReplicaTierConfig,
        build_ring,
        ring_homes,
    )
    from repro_torch.serving.segment_router import RouterConfig, SegmentRouter

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    wrappers = {"hybrid_distance": hybrid_distance, "hybrid_distance_int8": hybrid_distance_int8,
                "fused_topk": fused_topk, "fused_topk_int8": fused_topk_int8,
                "pairwise_tile": pairwise_tile}
    build_cfg = TEXT_BUILD or BuildConfig()
    W = FusionSpec.three_path()
    params = SearchParams(k=10, iters=32, pool_size=64)  # fig14's
    batcher = BatcherConfig(flush_size=32, max_batch=32, flush_deadline_s=0.05)
    names = lambda r: [f"replica{i}" for i in range(r)]
    laps: dict = {}  # seconds by part of the phase, each ended by a device sync
    mark = [time.perf_counter()]

    def lap(name: str) -> None:
        sync()
        now = time.perf_counter()
        laps[name] = laps.get(name, 0.0) + now - mark[0]
        mark[0] = now

    # ---- ingest ---------------------------------------------------------------
    gen = SynCorpus(SynCorpusConfig(n_docs=TEXT_DOCS, n_queries=TEXT_QUERIES, seed=0))
    pipe = IngestPipeline(IngestConfig(d_dense=TEXT_DENSE), device=device)
    t = time.perf_counter()
    fit = pipe.fit(gen.fit_sample(TEXT_FIT))
    fit_s = time.perf_counter() - t
    need(pipe.n_triplets > 0, "phase 9: the fit produced no triplets")
    kg = dict(kg_triplets=fit.kg.triplets, n_entities=fit.kg.n_entities)
    parts, ents, topics = [], [], []
    gen_s = enc_s = 0.0
    for lo in range(0, TEXT_DOCS, TEXT_ENCODE_BATCH):
        t = time.perf_counter()
        batch = [gen.doc(i) for i in range(lo, min(lo + TEXT_ENCODE_BATCH, TEXT_DOCS))]
        t1 = time.perf_counter()
        docs_b, ents_b = pipe.encode_docs([d.text for d in batch])
        enc_s += time.perf_counter() - t1
        gen_s += t1 - t
        parts.append(docs_b)
        ents.append(ents_b)
        topics += [d.topic for d in batch]
    corpus, ents, topics = cat_fused(parts), np.concatenate(ents), np.asarray(topics)
    del parts
    qs = gen.queries()
    enc = pipe.encode_queries([q.text for q in qs])
    q_topics = np.asarray([q.topic for q in qs])
    say(f"phase 9 ingest: fit on {TEXT_FIT} of {TEXT_DOCS} SynCorpus docs (d_dense "
        f"{TEXT_DENSE}) {fit_s:.2f} s, {pipe.n_triplets} triplets over "
        f"{len(pipe.entity_vocab)} entities; {TEXT_DOCS} docs generated in {gen_s:.2f} s "
        f"({TEXT_DOCS / gen_s:.0f} docs/s), encoded in {enc_s:.2f} s "
        f"({TEXT_DOCS / enc_s:.0f} docs/s, batches of {TEXT_ENCODE_BATCH}); "
        f"{sum(int((e >= 0).any()) for e in ents)} docs carry entities")
    lap("ingest")

    def make_tier(n_rep, docs, doc_ents, n, seg_docs, cfg, svc_params, salt, catch=None):
        """fig14's build_tier: each doc to its ring home, a shard sealed
        every ``seg_docs`` rows into a pooled segment at pow2 capacity with
        the KG, a service and a router per replica. ``catch``: a dict that
        takes the kernel calls of the first segment's build (kernel_calls)."""
        homes = ring_homes(build_ring(names(n_rep), TEXT_VNODES), np.arange(n))
        reps, seg_no = [], 0
        for i in range(n_rep):
            rows = np.flatnonzero(homes == i)
            need(rows.size > 0, f"phase 9: replica {i} of {n_rep} received no docs")
            segs = []
            for s in range(0, rows.size, seg_docs):
                part = rows[s:s + seg_docs]
                first = catch is not None and seg_no == 0
                grab = kernel_calls(build_stages(), "build") if first else contextlib.nullcontext()
                with grab as got:
                    segs.append(build_pool_segment(
                        docs.take(torch.as_tensor(part, device=device)), part, cfg,
                        capacity=_next_pow2(part.size), doc_entities=doc_ents[part],
                        device=device, generator=torch.Generator(device).manual_seed(salt + seg_no),
                        **kg))
                if first:
                    catch.update(got)
                seg_no += 1
            pool = stack_segments(segs)
            del segs
            svc = HybridSearchService(pool, svc_params, ServiceConfig(batcher=batcher))
            router = SegmentRouter(svc, cfg, RouterConfig(seal_threshold=10**9), **kg)
            reps.append(Replica(svc, router, name=names(n_rep)[i]))
        return ReplicaRouter(reps, ReplicaTierConfig(virtual_nodes=TEXT_VNODES))

    q_batches = [enc.vectors[lo:lo + TEXT_BATCH]
                 for lo in range(0, TEXT_QUERIES - TEXT_BATCH + 1, TEXT_BATCH)]

    def measure(fn):
        """Closed-loop batches (fig14's _measure): a warm-up batch, then
        TEXT_REQUESTS requests; QPS and per-batch p50 / p99 (ms)."""
        fn(q_batches[0])
        hist = MetricsRegistry().histogram("phase9_batch_seconds", "per-batch wall time")
        done, i = 0, 0
        t0 = time.perf_counter()
        while done < TEXT_REQUESTS:
            t1 = time.perf_counter()
            fn(q_batches[i % len(q_batches)])
            hist.observe(time.perf_counter() - t1)
            done += TEXT_BATCH
            i += 1
        snap = hist.snapshot()
        return done / (time.perf_counter() - t0), snap.quantile(0.5) * 1e3, snap.quantile(0.99) * 1e3

    # The phase's main path, its launches read by part: each part's counts
    # are zeroed just before it and read just after (the gates' own searches
    # and builds count nowhere)
    launched: dict = {}

    @contextlib.contextmanager
    def counted(part: str):
        for w in wrappers.values():
            w.launches = 0
        try:
            yield
        finally:
            into = launched.setdefault(part, dict.fromkeys(wrappers, 0))
            for k, w in wrappers.items():
                into[k] += w.launches
                w.launches = 0

    # kernel calls caught on the main path, held against the plain versions
    # after it: the first segment build, one read at R = 4 and at R = 1, one
    # read with the KG on (a segment at a time, entity candidates)
    caught: dict = {"build": {}}  # stages: descent, refine, self_scores, prune, build

    # ---- build and read: R = 4, then R = 1 ---------------------------------------
    tiers, reads = {}, {}
    for n_rep in (TEXT_REPLICAS, 1):
        sync()
        t = time.perf_counter()
        with counted("builds"):
            tier = make_tier(n_rep, corpus, ents, TEXT_DOCS, TEXT_SEGMENT, build_cfg, params, 41,
                             catch=caught["build"] if n_rep == TEXT_REPLICAS else None)
            sync()
        build_s = time.perf_counter() - t
        lap(f"build R={n_rep}")
        ran = lambda: sum(r.service.stats.batches for r in tier.replicas)
        b0 = ran()
        with counted("reads"):
            iso = [measure(lambda q, s=r.service: s.search(q, W, k=10))[0]
                   for r in tier.replicas]
            b1 = ran()
            tier_qps, p50, p99 = measure(lambda q: tier.search(q, W, k=10))
            b2 = ran()
            with kernel_calls(label=f"read_R{n_rep}") as got:
                tier.search(q_batches[0], W, k=10)
            caught[f"read_R{n_rep}"] = got
        reads[n_rep] = dict(iso=iso, model=min(iso), tier=tier_qps)
        say(f"phase 9 R={n_rep}: built {TEXT_DOCS} docs in {build_s:.2f} s "
            f"({TEXT_DOCS / build_s:.0f} docs/s); shard docs {tier.shard_sizes()}, segments "
            f"per replica {[r.router.pool.n_segments for r in tier.replicas]}, groups "
            f"{[r.router.pool.n_groups for r in tier.replicas]}; isolated QPS "
            f"{', '.join(f'{x:.1f}' for x in iso)}, model_qps {min(iso):.1f}; tier QPS "
            f"{tier_qps:.1f}, p50 {p50:.2f} ms p99 {p99:.2f} ms a batch of {TEXT_BATCH} "
            f"(three-path, use_kg=False, {TEXT_REQUESTS} requests); the replicas ran {b1 - b0} "
            f"service batches for the isolated readings, {b2 - b1} for the tier's "
            f"({TEXT_REQUESTS + TEXT_BATCH} requests a replica each, the warm-up batch with them)")
        tiers[n_rep] = tier
        lap(f"reads R={n_rep}")
    eff = reads[TEXT_REPLICAS]["model"] / (TEXT_REPLICAS * reads[1]["model"])
    say(f"phase 9 scaling_efficiency = model_qps@{TEXT_REPLICAS} / ({TEXT_REPLICAS} x "
        f"model_qps@1) = {reads[TEXT_REPLICAS]['model']:.1f} / ({TEXT_REPLICAS} x "
        f"{reads[1]['model']:.1f}) = {eff:.4f}")
    tiers.pop(1).close()
    tier = tiers.pop(TEXT_REPLICAS)
    reps = tier.replicas
    R = len(reps)

    # recall@10 against brute force over every doc, and the topic share
    qw = weighted_query(enc.vectors, W.weights)
    truth = ops.topk_hybrid(qw, corpus, 10, chunk=8192)[1]
    with counted("reads"):
        got = tier.search(enc.vectors, W, k=10)
    rec = recall_at_k(got.ids, truth)
    ids = got.ids.numpy()
    share = float(np.mean([(topics[i[i >= 0]] == qt).mean() for i, qt in zip(ids, q_topics)]))
    say(f"phase 9 R={R} recall@10 {rec:.4f} (three-path, brute force over {TEXT_DOCS} docs); "
        f"share of the top 10 in the query's topic {share:.4f}")
    lap("recall")

    # one batch under adaptive fusion with the KG on (one segment at a time)
    kg_params = dataclasses.replace(params, use_kg=True)
    kg_tier = ReplicaRouter([Replica(HybridSearchService(r.service.index, kg_params,
                                                         ServiceConfig(batcher=batcher)),
                                     name=r.name) for r in reps],
                            ReplicaTierConfig(virtual_nodes=TEXT_VNODES))
    qa = enc.vectors[0:TEXT_BATCH]
    spec = adaptive_fusion_for(dataclasses.replace(
        enc, vectors=qa, keywords=enc.keywords[:TEXT_BATCH], entities=enc.entities[:TEXT_BATCH]),
        stats=tier.path_stats())
    modes = [FUSION_MODE_NAMES[int(m)] for m in spec.mode]
    t = time.perf_counter()
    with counted("kg_read"), kernel_calls(label="read_kg") as got:
        kg_res = kg_tier.search(qa, spec, entities=enc.entities[:TEXT_BATCH], k=10)
    caught["read_kg"] = got
    kg_s = time.perf_counter() - t
    t = time.perf_counter()
    with counted("reads"):
        tier.search(qa, spec, k=10)
    flat_s = time.perf_counter() - t
    need(bool((kg_res.ids[:, 0] >= 0).all()), "phase 9: an adaptive KG query without results")
    say(f"phase 9 adaptive batch of {TEXT_BATCH}: modes "
        f"{ {m: modes.count(m) for m in sorted(set(modes))} }, "
        f"{int((enc.entities[:TEXT_BATCH] >= 0).any(1).sum())} rows with entities; use_kg=True "
        f"{kg_s:.3f} s ({TEXT_BATCH / kg_s:.1f} QPS, one segment at a time over "
        f"{[r.router.pool.n_segments for r in reps]} segments); the same batch at "
        f"use_kg=False {flat_s:.3f} s ({TEXT_BATCH / flat_s:.1f} QPS)")
    kg_tier.close()
    lap("adaptive batch")

    # ---- gate 7: the kernels at the main path's shapes and its launches --------------
    n_checked = 0
    for part, calls in caught.items():
        need({op for _, op, _ in calls} >= ({"fused_topk", "hybrid_distance", "pairwise_tile"}
                                            if part == "build" else
                                            {"fused_topk", "hybrid_distance"}),
             f"phase 9 {part}: kernels caught {sorted({op for _, op, _ in calls})}")
        n_checked += check_calls(calls, results, "phase 9", "text", reps=10, device=device)
    say(f"phase 9 gate 7 kernels vs plain versions at the main path's shapes: {n_checked} "
        f"calls ({', '.join(f'{p} {len(c)}' for p, c in caught.items())}; stages of the "
        f"build {sorted({st for st, _, _ in caught['build']})}), each within {TOL} and two "
        f"launches bit-identical")
    del caught
    lap("kernel checks")

    # ---- gate 1: placement against the script's own ring ------------------------
    home = ring_witness(names(R), TEXT_VNODES, np.arange(TEXT_DOCS))

    def placement_ok(homes) -> bool:
        for i, r in enumerate(reps):
            held = np.sort(np.concatenate([g.global_ids.cpu().numpy().ravel()
                                           for g in r.router.pool.groups]))
            if not np.array_equal(held[held >= 0], np.flatnonzero(homes == i)):
                return False
        return True

    ok1 = placement_ok(home)
    planted1 = placement_ok(ring_witness(names(R), 64, np.arange(TEXT_DOCS)))
    say(f"phase 9 gate 1 placement: every replica holds exactly the ids the script's ring "
        f"({TEXT_VNODES} virtual nodes) homes to it: {ok1}; planted 64-node ring: {planted1}")
    need(ok1, "phase 9 gate 1: a replica holds ids its ring home is not")
    need(not planted1, "planted fault (64-node ring) passes the placement gate")
    lap("gate 1")

    # ---- gate 2: the merge against the script's own merge ------------------------
    def script_merge(parts, ordered=True):
        all_ids = np.concatenate([p.ids.numpy() for p in parts], axis=1)
        all_sc = np.concatenate([np.where(p.ids.numpy() >= 0, p.scores.numpy(), -np.inf)
                                 for p in parts], axis=1)
        order = (np.argsort(-all_sc, axis=1, kind="stable") if ordered
                 else np.broadcast_to(np.arange(all_ids.shape[1]), all_ids.shape))[:, :10]
        ids_, sc_ = np.take_along_axis(all_ids, order, 1), np.take_along_axis(all_sc, order, 1)
        ok_ = np.isfinite(sc_)  # a row short of 10 results: PAD as the service gives it
        return np.where(ok_, ids_, -1), np.where(ok_, sc_, -1e30).astype(np.float32)

    merged = [tier.search(q, W, k=10) for q in q_batches]
    direct = [[r.service.search(q, W, k=10) for r in reps] for q in q_batches]
    ok2 = all(same_up_to_ties(m.ids, m.scores, *script_merge(d)) for m, d in zip(merged, direct))
    planted2 = all(same_up_to_ties(m.ids, m.scores, *script_merge(d, ordered=False))
                   for m, d in zip(merged, direct))
    say(f"phase 9 gate 2 merge: the tier equals the script's merge of the {R} services' own "
        f"results up to equal-score ties for {TEXT_QUERIES} queries: {ok2}; planted merge in "
        f"replica order: {planted2}")
    need(ok2, "phase 9 gate 2: the tier's merge differs from the services' own results")
    need(not planted2, "planted fault (merge in replica order) passes the merge gate")
    lap("gate 2")

    # ---- gate 3: the tier against one service (DESIGN.md §9) ----------------------
    # saturating: every row is an entry point and the pool covers a segment
    # plus the entity entries, so both searches score every live doc
    # exactly, whatever their graphs reach (a pool smaller than that misses
    # the docs no entry point reaches, ROADMAP Queue 3)
    n_c = TEXT_CONTRACT_DOCS

    def exhaustive(seg):
        cap = int(seg.global_ids.shape[1])
        every = torch.arange(cap, dtype=torch.int32, device=seg.global_ids.device)[None]
        return dataclasses.replace(seg, index=dataclasses.replace(seg.index, entry_points=every))

    sat = SearchParams(k=10, iters=8, pool_size=_next_pow2(n_c) + 64, use_kg=True)
    c_homes = ring_homes(build_ring(names(R), TEXT_VNODES), np.arange(n_c))
    c_reps = []
    for i in range(R):
        rows = np.flatnonzero(c_homes == i)
        seg = exhaustive(build_pool_segment(
            corpus.take(torch.as_tensor(rows, device=device)), rows, build_cfg,
            capacity=_next_pow2(rows.size), doc_entities=ents[rows], device=device,
            generator=torch.Generator(device).manual_seed(900 + i), **kg))
        c_reps.append(Replica(HybridSearchService(SegmentPool.from_segmented(seg), sat,
                                                  ServiceConfig(batcher=batcher)),
                              name=names(R)[i]))
    c_tier = ReplicaRouter(c_reps, ReplicaTierConfig(virtual_nodes=TEXT_VNODES))
    mono = HybridSearchService(SegmentPool.from_segmented(exhaustive(build_pool_segment(
        corpus[0:n_c], np.arange(n_c), build_cfg, capacity=_next_pow2(n_c),
        doc_entities=ents[:n_c], device=device,
        generator=torch.Generator(device).manual_seed(999), **kg))), sat,
        ServiceConfig(batcher=batcher))
    q_ent = enc.entities

    def contract(t_):
        a = [t_.search(q, W, entities=q_ent[lo:lo + TEXT_BATCH], k=10)
             for lo, q in zip(range(0, TEXT_QUERIES, TEXT_BATCH), q_batches)]
        b = [mono.search(q, W, entities=q_ent[lo:lo + TEXT_BATCH], k=10)
             for lo, q in zip(range(0, TEXT_QUERIES, TEXT_BATCH), q_batches)]
        return all(same_up_to_ties(x.ids, x.scores, y.ids, y.scores, decimals=5)
                   for x, y in zip(a, b))

    ok3 = contract(c_tier)
    c_tier.mark_down(0)
    planted3 = contract(c_tier)
    c_tier.mark_up(0)
    say(f"phase 9 gate 3 contract: a tier of {R} over the first {n_c} docs (segments of "
        f"{[int(r.service.index.groups[0].global_ids.shape[1]) for r in c_reps]}) and one "
        f"service over one pool of them, saturating ({sat}), entities on, return the same "
        f"results up to equal-score ties: {ok3}; planted tier with replica0 down: {planted3}")
    need(ok3, "phase 9 gate 3: the tier differs from one service over the same docs")
    need(not planted3, "planted fault (a replica's shard missing) passes the contract gate")
    c_tier.close()
    mono.stop_pump()
    del c_tier, mono, c_reps
    lap("gate 3")

    # ---- gate 4: degraded reads ---------------------------------------------------
    qb = q_batches[0]
    before = tier.search(qb, W, k=10)
    deg0 = tier.stats.degraded_reads("replica1")

    def degraded_ok(res) -> bool:
        got_ids = res.ids.numpy()
        got_ids = got_ids[got_ids >= 0]
        return bool((home[got_ids] != 1).all()) and res.down_replicas == ("replica1",)

    tier.mark_down(1)
    res = tier.search(qb, W, k=10)
    deg1 = tier.stats.degraded_reads("replica1")
    ok4 = degraded_ok(res) and deg1 == deg0 + 1
    tier.config = dataclasses.replace(tier.config, fail_on_partial=True)
    try:
        tier.search(qb, W, k=10)
        raised = False
    except RuntimeError:
        raised = True
    finally:
        tier.config = dataclasses.replace(tier.config, fail_on_partial=False)
    sound_up = tier._up
    tier._up = lambda: list(range(R))  # a router that searches down replicas too
    try:
        planted4 = degraded_ok(tier.search(qb, W, k=10))
    finally:
        tier._up = sound_up
    tier.mark_up(1)
    after = tier.search(qb, W, k=10)
    same4 = torch.equal(after.ids, before.ids) and torch.equal(after.scores, before.scores)
    say(f"phase 9 gate 4 degraded reads: after mark_down(1) no result id homed on replica1 and "
        f"down_replicas {res.down_replicas}, degraded counter {deg0} -> {deg1}: {ok4}; fail_on_partial raises: {raised}; "
        f"after mark_up bit-identical to before: {same4}; planted router searching down "
        f"replicas: {planted4}")
    need(ok4 and raised and same4, "phase 9 gate 4: degraded reads")
    need(not planted4, "planted fault (down replicas searched) passes the degraded-read gate")
    lap("gate 4")

    # ---- gate 5: streamed writes, deletes, read-your-writes -----------------------
    ext = SynCorpus(SynCorpusConfig(n_docs=TEXT_DOCS + TEXT_STREAM, n_queries=TEXT_QUERIES,
                                    seed=0))
    ins_s, ryw = [], []  # ryw: (new ids, reached, found by home, returned by tier)
    seen: list = []  # (time the search was made, ids) of every result from here on
    for lo in range(TEXT_DOCS, TEXT_DOCS + TEXT_STREAM, TEXT_STREAM_BATCH):
        texts = ext.texts(lo, lo + TEXT_STREAM_BATCH)
        t = time.perf_counter()
        with counted("stream"):
            gids = pipe.stream_into(tier, texts)
        ins_s.append(time.perf_counter() - t)
        lap("stream_into")
        need(np.array_equal(gids, np.arange(lo, lo + len(texts))),
             f"phase 9: ids {gids[:3]}... not contiguous from {lo}")
        new_home = ring_witness(names(R), TEXT_VNODES, gids)
        q = pipe.encode_queries(texts).vectors
        found = np.zeros(gids.size, bool)
        reached = np.zeros(gids.size, bool)
        for i, r in enumerate(reps):
            snap = r.service._snap
            grow_gids = snap.grow_gids.cpu().numpy()
            need(np.array_equal(np.sort(grow_gids[grow_gids >= lo]), gids[new_home == i]),
                 f"phase 9: replica{i}'s grow segment does not hold its new ids")
            live = graph_reach(snap.grow)
            row_of = {int(g): k for k, g in enumerate(grow_gids)}
            rows = np.flatnonzero(new_home == i)
            reached[rows] = [live[row_of[int(g)]] for g in gids[rows]]
            own = r.service.search(q[torch.as_tensor(rows, device=device)], W, k=10).ids.numpy()
            found[rows] = [g in row for g, row in zip(gids[rows], own)]
        t = time.perf_counter()
        tier_ids = tier.search(q, W, k=10).ids.numpy()
        seen.extend((t, row) for row in tier_ids)
        ryw.append((gids, reached, found, np.asarray([g in row for g, row in zip(gids, tier_ids)])))
        lap("read-your-writes probes")
    new_ids, reached, found, returned = (np.concatenate([x[i] for x in ryw]) for i in range(4))
    h, f = int((found & returned).sum()), int(found.sum())
    say(f"phase 9 stream: {TEXT_STREAM} docs (ids {TEXT_DOCS}-{TEXT_DOCS + TEXT_STREAM - 1}) in "
        f"{len(ins_s)} stream_into calls of {TEXT_STREAM_BATCH}: {TEXT_STREAM / sum(ins_s):.1f} "
        f"docs/s (encode + route + insert), p50 {np.quantile(ins_s, 0.5):.3f} s p99 "
        f"{np.quantile(ins_s, 0.99):.3f} s a call; grow segments "
        f"{[r.router.grow_size for r in reps]}")
    say(f"phase 9 gate 5 read-your-writes: reached from the grow segment's entry points "
        f"{int(reached.sum())}/{new_ids.size} = {reached.mean():.4f} (floor {REACH_FLOOR}); the "
        f"tier returned {h}/{f} = {h / max(f, 1):.4f} of what the home replica's own search "
        f"finds for each new doc's text (floor {RYW_SHARE}); of all {returned.mean():.4f}")
    need(reached.mean() >= REACH_FLOOR, f"phase 9 gate 5: reached {reached.mean():.4f}")
    need(f > 0 and h / f >= RYW_SHARE, f"phase 9 gate 5: returned {h}/{f}")

    # deletes: half new, half sealed ids the tier was just returning
    rng = np.random.default_rng(9)
    half = TEXT_DELETES // 2
    t = time.perf_counter()
    answered = tier.search(enc.vectors, W, k=10).ids.numpy()
    seen.extend((t, row) for row in answered)
    recent = np.unique(answered[(answered >= 0) & (answered < TEXT_DOCS)])
    sealed_v = rng.choice(recent, min(half, recent.size), replace=False)
    rest = np.setdiff1d(np.arange(TEXT_DOCS), sealed_v)
    sealed_v = np.concatenate([sealed_v, rng.choice(rest, half - sealed_v.size, replace=False)])
    victims = np.concatenate([rng.choice(new_ids, half, replace=False), sealed_v])
    del_time: dict = {}
    del_s = []
    for s in range(0, victims.size, TEXT_STREAM_BATCH):
        chunk = victims[s:s + TEXT_STREAM_BATCH]
        t = time.perf_counter()
        tier.delete(chunk)
        done = time.perf_counter()
        del_s.append(done - t)
        del_time.update((int(g), done) for g in chunk)

    def violations(after: float) -> tuple[int, int]:
        """Deleted ids in results of searches made after their delete
        returned, and the results read."""
        bad = n_res = 0
        for t_, row in seen:
            if t_ < after:
                continue
            n_res += 1
            bad += sum(1 for g in row if g >= 0 and del_time.get(int(g), np.inf) < t_)
        return bad, n_res

    t_del = time.perf_counter()
    new_v = victims[:half]
    own_text = pipe.encode_queries([ext.doc(int(g)).text for g in new_v[:2 * TEXT_BATCH]])
    for qv in (enc.vectors, own_text.vectors):
        t = time.perf_counter()
        seen.extend((t, row) for row in tier.search(qv, W, k=10).ids.numpy())
    bad, n_res = violations(t_del)
    say(f"phase 9 gate 5 deletes: {victims.size} ids ({half} new, {half} sealed, "
        f"{min(half, recent.size)} of them just returned) in {len(del_s)} calls, p50 "
        f"{np.quantile(del_s, 0.5):.4f} s; {bad} deleted ids in {n_res} results of searches "
        f"made after the delete returned")
    need(bad == 0, f"phase 9 gate 5: {bad} deleted ids returned")
    # planted: a tier that never forwards deletes
    last = tier.search(enc.vectors, W, k=10).ids.numpy()
    more = np.unique(last[last >= 0])[:64]
    sound_delete = tier.delete
    tier.delete = lambda ids: int(np.asarray(ids).size)
    try:
        t = time.perf_counter()
        tier.delete(more)
        done = time.perf_counter()
        del_time.update((int(g), done) for g in more)
        t = time.perf_counter()
        seen.extend((t, row) for row in tier.search(enc.vectors, W, k=10).ids.numpy())
    finally:
        tier.delete = sound_delete
    planted5, _ = violations(done)
    say(f"phase 9 gate 5 planted tier that never forwards deletes: {planted5} deleted ids "
        "returned")
    need(planted5 > 0, "planted fault (deletes never forwarded) passes the delete gate")
    lap("deletes")

    # ---- gate 7 (continued): the main path's launches, by part ---------------------
    # builds and streamed inserts run all three fp32 kernels, every read
    # (with the KG on too) the fused top-k and the distance; no int8 variant
    need_ops = {"builds": ("hybrid_distance", "fused_topk", "pairwise_tile"),
                "reads": ("hybrid_distance", "fused_topk"),
                "kg_read": ("hybrid_distance", "fused_topk"),
                "stream": ("hybrid_distance", "fused_topk", "pairwise_tile")}

    def launches_ok(part: str, counts: dict) -> bool:
        return (all(counts[k] > 0 for k in need_ops[part])
                and counts["hybrid_distance_int8"] == 0 and counts["fused_topk_int8"] == 0)

    say(f"phase 9 launches of the main path by part: {json.dumps(launched)}")
    for part in need_ops:
        need(launches_ok(part, launched[part]) or device != "cuda",
             f"phase 9 gate 7: {part} launched {launched[part]}")
        for k in ("hybrid_distance", "fused_topk", "pairwise_tile"):
            results[k]["launches"] += launched[part][k]
    # planted: a tier whose replicas search through the plain versions
    plain_tier = ReplicaRouter([Replica(HybridSearchService(
        r.service.index, dataclasses.replace(params, use_kernel=False),
        ServiceConfig(batcher=batcher)), name=r.name) for r in reps],
        ReplicaTierConfig(virtual_nodes=TEXT_VNODES))
    with counted("planted"):
        plain_tier.search(qb, W, k=10)
    plain_tier.close()
    planted7 = launches_ok("reads", launched.pop("planted"))
    say(f"phase 9 gate 7 planted tier reading through the plain versions passes the read "
        f"launch gate: {planted7}")
    need(not planted7, "planted fault (plain versions) passes the launch gate")
    lap("gate 7")

    # ---- gate 6: persistence --------------------------------------------------------
    pool0 = reps[0].router.pool
    texts_q = [q.text for q in qs]
    other = IngestPipeline(IngestConfig(d_dense=TEXT_DENSE), device=device)
    other.fit(gen.fit_sample(TEXT_FIT // 4))

    def same_enc(a, b) -> bool:
        fa, fb = a.vectors, b.vectors
        return (all(torch.equal(x, y) for x, y in zip(
            (fa.dense, fa.learned.idx, fa.learned.val, fa.lexical.idx, fa.lexical.val),
            (fb.dense, fb.learned.idx, fb.learned.val, fb.lexical.idx, fb.lexical.val)))
            and np.array_equal(a.keywords, b.keywords) and np.array_equal(a.entities, b.entities))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_text_") as d:
        t = time.perf_counter()
        save_pool(d, pool0, ingest=pipe)
        save_s = time.perf_counter() - t
        nbytes = sum(f_.stat().st_size for f_ in Path(d).rglob("*") if f_.is_file())
        t = time.perf_counter()
        loaded_pool = load_pool(d, device=device)
        loaded_pipe = load_ingest(d, device=device)
        sync()
        load_s = time.perf_counter() - t
    ok6a = same_enc(loaded_pipe.encode_queries(texts_q), pipe.encode_queries(texts_q))
    a6 = HybridSearchService(pool0, params).search(enc.vectors, W, k=10)
    b6 = HybridSearchService(loaded_pool, params).search(enc.vectors, W, k=10)
    ok6b = torch.equal(a6.ids, b6.ids) and torch.equal(a6.scores, b6.scores)
    swapped = IngestPipeline.from_state(
        dataclasses.asdict(pipe.config), n_docs=other.stats.n_docs, avg_dl=other.stats.avg_dl,
        df_learned=other.stats.df_learned, df_lexical=other.stats.df_lexical,
        entity_names=pipe.entity_vocab.names, n_triplets=pipe.n_triplets, device=device)
    planted6 = same_enc(swapped.encode_queries(texts_q), pipe.encode_queries(texts_q))
    say(f"phase 9 gate 6 persistence: replica0's pool ({pool0.n_segments} segments) with the "
        f"fitted pipeline, {nbytes} bytes, save {save_s:.3f} s, load {load_s:.3f} s; loaded "
        f"pipeline encodes the {TEXT_QUERIES} queries bit for bit: {ok6a}; loaded pool answers "
        f"with the same ids and scores bitwise: {ok6b}; planted pipeline with another fit's "
        f"stats encodes the same: {planted6}")
    need(ok6a and ok6b, "phase 9 gate 6: persistence")
    need(not planted6, "planted fault (another fit's stats) passes the persistence gate")
    del loaded_pool
    lap("gate 6")

    # ---- gate 8: real text (the bundled corpus, ingest_bench.py's gate) -------------
    bc = load_bundled_corpus()
    bpipe = IngestPipeline(IngestConfig(d_dense=64), device=device)
    bfit = bpipe.fit(bc.texts)
    bindex = bpipe.build(bfit, BuildConfig(
        knn=KnnConfig(k=16, iters=4, node_chunk=128),
        prune=PruneConfig(degree=16, keyword_degree=4, node_chunk=128), path_refine_iters=1),
        generator=torch.Generator(device).manual_seed(0))
    benc = bpipe.encode_queries(bc.query_texts)
    btruth = topic_truth(bc.query_topics, bc.topics)
    bparams = SearchParams(k=10, iters=48, pool_size=64)
    brec = {name: recall_at_k(search(bindex, benc.vectors, spec, bparams, device=device).ids,
                              btruth)
            for name, spec in (("dense_only", FusionSpec.weighted(1, 0, 0)), ("hybrid", W))}
    rag = RagPipeline(None, bindex, torch.zeros((bc.n_docs, 1), dtype=torch.int32),
                      RagConfig(top_k=10, search=bparams), ingest=bpipe)
    direct8 = search(bindex, benc.vectors, W, bparams, keywords=benc.keywords,
                     entities=benc.entities, device=device)
    via = rag.retrieve_text(bc.query_texts)
    ok8 = torch.equal(via.ids, direct8.ids) and torch.equal(via.scores, direct8.scores)
    rag.ingest = IngestPipeline.from_state(
        dataclasses.asdict(bpipe.config), n_docs=bpipe.stats.n_docs, avg_dl=bpipe.stats.avg_dl,
        df_learned=np.roll(bpipe.stats.df_learned, 1), df_lexical=bpipe.stats.df_lexical,
        entity_names=bpipe.entity_vocab.names, n_triplets=bpipe.n_triplets, device=device)
    off = rag.retrieve_text(bc.query_texts)
    planted8 = torch.equal(off.ids, direct8.ids) and torch.equal(off.scores, direct8.scores)
    say(f"phase 9 gate 8 real text: bundled corpus ({bc.n_docs} paragraphs, "
        f"{len(bc.query_texts)} queries, {bpipe.n_triplets} triplets) built and searched on "
        f"{device}: recall@10 hybrid {brec['hybrid']:.4f} >= dense-only {brec['dense_only']:.4f}: "
        f"{brec['hybrid'] >= brec['dense_only']}; retrieve_text equals a direct search of "
        f"encode_queries: {ok8}; planted pipeline with shifted df: {planted8}")
    need(brec["hybrid"] >= brec["dense_only"], "phase 9 gate 8: hybrid recall below dense-only")
    need(ok8, "phase 9 gate 8: retrieve_text differs from a direct search")
    need(not planted8, "planted fault (another fit's df) passes the retrieve_text gate")
    tier.close()
    lap("gate 8")
    say(f"phase 9 seconds by part: {json.dumps({k: round(v, 3) for k, v in laps.items()})}; "
        f"total {sum(laps.values()):.1f} s")


def flash_work(q, k, v, causal: bool) -> tuple[float, float, float]:
    """(bytes, flops, peak flop rate) of one attention forward: q, k, v read
    once, out and the fp32 LSE written once; 4 d flop per (row, col) pair the
    mask keeps (QK^T and PV), counted for this shape."""
    import torch

    b, h, l, dk = q.shape
    s, dv = k.shape[2], v.shape[3]
    pairs = sum(min(r + 1, s) for r in range(l)) if causal else l * s
    esz = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + b * h * l * dv) * esz + b * h * l * 4
    flops = 2.0 * b * h * pairs * (dk + dv)
    return nbytes, flops, BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S


def check_flash_fwd(results: dict, label: str, q, k, v, causal: bool, rows=None,
                    scale=None) -> float:
    """The forward kernel vs its plain version on ``rows`` batch rows (all by
    default), out and LSE within FLASH_TOL; returns the max |error|."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain

    tol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    out, lse = flash_attention_fwd(q, k, v, causal, scale)
    sl = slice(None) if rows is None else slice(0, rows)
    want_out, want_lse = flash_attention_plain(q[sl], k[sl], v[sl], causal, scale)
    if q.is_cuda:
        torch.cuda.synchronize()
    err = 0.0
    for got, want in ((out[sl].float(), want_out.float()), (lse[sl], want_lse)):
        need(bool(torch.isfinite(got).all()), f"flash {label}: non-finite output")
        diff = (got - want).abs()
        need(bool((diff <= tol + tol * want.abs()).all()),
             f"flash {label}: error {float(diff.max()):.3g} beyond {tol} + {tol}|x|")
        err = max(err, float(diff.max()))
    r = results.setdefault("flash_attention_fwd", {"launches": 0, "max_abs_err": 0.0,
                                                   "checks": []})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    return err


def phase_flash(cfg, results: dict):
    """The flash kernel against its plain version on the card: at the RAG
    prefill shape (bf16, the tensor-core route: timed beside the plain
    version and SDPA, two launches bit-identical; fp32 on 4 rows) and at edge
    shapes in fp32 and bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(13)

    def qkv(b, h, kv, l, s, dk, dv, dtype):
        """Random q, k, v in the model's (B, L, H, d) memory, (B, H, L, d) views."""
        mk = lambda n, heads, d: torch.randn((b, n, heads, d), generator=gen, device="cuda",
                                             dtype=torch.float32).to(dtype).transpose(1, 2)
        return mk(l, h, dk), mk(s, kv, dk), mk(s, kv, dv)

    edges = [
        # label, (B, H, KV, L, S, dk, dv), causal
        ("tail L=S=333 g=4", (2, 8, 2, 333, 333, 64, 64), True),
        ("L=S=1", (4, 8, 2, 1, 1, 64, 64), True),
        ("dk=48 dv=32", (2, 4, 2, 130, 130, 48, 32), True),
        ("non-causal L=100 S=300 g=1", (2, 4, 4, 100, 300, 64, 64), False),
        ("top-left causal L=96 S=160", (2, 8, 2, 96, 160, 64, 64), True),
        # the tensor-core route's head-dim classes 128 and 256, MLA's dims,
        # and rows of 40 bytes (TMA takes the wrapper's padded copy)
        ("dk=dv=128 L=S=200", (1, 4, 2, 200, 200, 128, 128), True),
        ("dk=dv=256 L=S=150", (1, 2, 1, 150, 150, 256, 256), True),
        ("dk=192 dv=128 L=S=130", (2, 4, 1, 130, 130, 192, 128), True),
        ("dk=dv=20 L=S=70", (2, 4, 2, 70, 70, 20, 20), True),
        # phase 12's kinds: cross-attention (S > L, S off the tile, GQA 8)
        # and whisper's encoder (non-causal, L = S off the tile)
        ("non-causal L=136 S=200 g=8 d=128", (2, 16, 2, 136, 200, 128, 128), False),
        ("non-causal L=S=333 d=64", (2, 4, 4, 333, 333, 64, 64), False),
    ]
    for label, shape, causal in edges:
        for dtype in (torch.float32, torch.bfloat16):
            err = check_flash_fwd(results, label, *qkv(*shape, dtype), causal)
            say(f"phase 6 flash {label} {str(dtype)[6:]}: max_abs_err {err:.3g} "
                f"(tol {FLASH_TOL[str(dtype)[6:]]})")

    # the RAG prefill shape: every layer of a prefill launches this
    b, h, kv, d = RAG_REQUESTS, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    l = RAG_TOP_K * RAG_CTX + RAG_PROMPT
    q, k, v = qkv(b, h, kv, l, l, d, d, torch.bfloat16)
    err = check_flash_fwd(results, "rag", q, k, v, True, rows=8)
    # no atomics: a second launch gives the same bits
    first, again = flash_attention_fwd(q, k, v, True), flash_attention_fwd(q, k, v, True)
    same = [bool(torch.equal(a, b_)) for a, b_ in zip(first, again)]
    need(all(same), f"flash: repeated bf16 launches differ (out, lse equal: {same})")
    say("phase 6 flash rag bf16: two launches give bit-identical out and lse")
    del first, again
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, True), 10)
    plain_ms = time_ms(lambda: [flash_attention_plain(q[i:i + 8], k[i:i + 8], v[i:i + 8], True,
                                                      d**-0.5) for i in range(0, b, 8)], 2, warm=1)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    lib_out = sdpa()
    need(bool(torch.isfinite(lib_out).all()), "SDPA: non-finite output")
    library_ms = time_ms(sdpa, 10)
    nbytes, flops, rate = flash_work(q, k, v, True)
    b_ms, b_by = bound(nbytes, flops, rate)
    shape = f"rag_prefill B={b} H={h} KV={kv} L=S={l} d={d} causal bf16"
    results["flash_attention_fwd"]["checks"].append(dict(
        shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms))
    say(f"phase 6 flash {shape}: max_abs_err (8 rows) {err:.3g} ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}: {nbytes / 1e9:.3f} GB, "
        f"{flops / 1e9:.1f} GFLOP) sdpa_ms {library_ms:.4f}")
    del q, k, v, lib_out
    # the same shape in fp32 on 4 rows, where 1e-5 leaves a wrong tile loop,
    # causal skip or stride no room
    err = check_flash_fwd(results, "rag fp32", *qkv(4, h, kv, l, l, d, d, torch.float32), True)
    say(f"phase 6 flash rag B=4 H={h} KV={kv} L=S={l} d={d} causal float32: max_abs_err "
        f"{err:.3g} (tol {FLASH_TOL['float32']})")
    torch.cuda.empty_cache()


def planted_flash(kernel, planted_causal: bool, drop: int):
    """A faulty stand-in for ``models.attention._flash`` that still runs the
    kernel: the causal mask off, or the last ``drop`` keys left out. The
    caller's ``causal`` is overridden by ``planted_causal``."""

    def flash(q, k, v, scale=None, causal=True):  # as _flash takes them
        s = k.shape[1] - drop
        out, _ = kernel(q.transpose(1, 2), k[:, :s].transpose(1, 2), v[:, :s].transpose(1, 2),
                        planted_causal, scale)
        return out.transpose(1, 2)

    return flash


def phase_rag(corpus_bundle, index, results: dict):
    """Retrieval-augmented generation at llama3.2-1b's full width."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.search import search
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_topk import fused_topk
    from repro_torch.kernels.hybrid_distance import hybrid_distance
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.obs.tracer import TraceContext
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.hybrid_service import HybridSearchService
    from repro_torch.serving.rag import RagConfig, RagPipeline

    c = corpus_bundle
    cfg = dataclasses.replace(get_config("llama3.2-1b"), attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = time.perf_counter()
    params = tfm.init_params(cfg, gen)
    doc_tokens = torch.randint(0, cfg.vocab, (c.docs.n, RAG_CTX), generator=gen, device="cuda",
                               dtype=torch.int32)
    prompts = torch.randint(0, cfg.vocab, (RAG_REQUESTS, RAG_PROMPT), generator=gen,
                            device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say(f"phase 6 setup: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} {cfg.dtype}, "
        f"{n_params} parameters (config n_params {cfg.n_params}, without the norms); doc_tokens "
        f"{tuple(doc_tokens.shape)}; {time.perf_counter() - t:.1f} s")

    phase_flash(cfg, results)

    rag_cfg = RagConfig(top_k=RAG_TOP_K, ctx_tokens_per_doc=RAG_CTX)
    service = HybridSearchService(index, dataclasses.replace(rag_cfg.search, k=RAG_TOP_K))
    engine = ServingEngine(cfg, params, ServeConfig(max_len=RAG_MAX_LEN))
    rag = RagPipeline(engine, index, doc_tokens, rag_cfg, service=service)
    queries = c.queries[0:RAG_REQUESTS]
    rag.answer(c.queries[0:8], prompts[:8], 2)  # warm-up: library handles, allocator

    # ---- the main path: counts zeroed just before, read just after --------
    wrappers = {"flash_attention_fwd": flash_attention_fwd, "hybrid_distance": hybrid_distance,
                "fused_topk": fused_topk}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trace = TraceContext("rag")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, res = rag.answer(queries, prompts, RAG_GEN, trace=trace)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    span = lambda name: trace.find(name)[0]
    retrieval_s = span("context_assembly").t0 - t0
    prefill_s = span("prefill").t1 - span("prefill").t0
    decode_s = span("decode").t1 - span("decode").t0
    l = RAG_TOP_K * RAG_CTX + RAG_PROMPT
    say(f"phase 6 RAG {RAG_REQUESTS} requests, top-{RAG_TOP_K} x {RAG_CTX} context + "
        f"{RAG_PROMPT} prompt (L = {l}), {RAG_GEN} tokens greedy: retrieval {retrieval_s:.3f} s, "
        f"prefill {prefill_s:.3f} s ({RAG_REQUESTS * l / prefill_s:.1f} tokens/s), decode "
        f"{decode_s:.3f} s ({RAG_REQUESTS * (RAG_GEN - 1) / decode_s:.1f} tokens/s over "
        f"{RAG_GEN - 1} steps), end to end {e2e:.3f} s per batch; peak memory {peak_gb:.2f} GB")
    say(f"phase 6 main-path launches: {json.dumps(launches)} (one answer: retrieval through "
        f"the service, one prefill of {cfg.n_layers} layers)")
    need(launches["flash_attention_fwd"] == cfg.n_layers,
         f"flash launches {launches['flash_attention_fwd']} != {cfg.n_layers} per prefill")
    for k in ("hybrid_distance", "fused_topk"):
        need(launches[k] > 0, f"{k} was not launched while RAG retrieved")
        results[k]["launches"] += launches[k]
    results["flash_attention_fwd"]["launches"] = launches["flash_attention_fwd"]

    # ---- what came out ------------------------------------------------------
    full = torch.cat([rag.build_context(res), prompts], dim=1)
    need(tuple(out.shape) == (RAG_REQUESTS, l + RAG_GEN), f"output shape {tuple(out.shape)}")
    need(torch.equal(out[:, :l], full), "the output does not start with [context ; prompt]")
    need(bool(((out >= 0) & (out < cfg.vocab)).all()), "generated tokens out of range")
    need(bool((res.ids[:, :RAG_TOP_K] >= 0).all()), "a request retrieved fewer than top_k docs")
    direct = search(index, queries, FusionSpec.three_path(),
                    dataclasses.replace(rag_cfg.search, k=RAG_TOP_K), device="cuda")
    ids_agree(res.ids.cuda(), res.scores.cuda(), direct.ids, direct.scores, TOL)
    say("phase 6 retrieval: the service's top-4 agree with direct search up to ties")

    logits, _ = tfm.make_prefill(cfg, RAG_MAX_LEN)(params, full)
    need(bool(torch.isfinite(logits.float()).all()), f"non-finite prefill logits at L = {l}")
    naive_cfg = dataclasses.replace(cfg, attn_impl="naive")
    naive, _ = tfm.make_prefill(naive_cfg, RAG_MAX_LEN)(params, full[:8])
    gap = float((logits[:8].float() - naive.float()).abs().max())
    agree = float((logits[:8].argmax(-1) == naive.argmax(-1)).float().mean())
    say(f"phase 6 prefill logits at L = {l}: finite for all {RAG_REQUESTS} rows; flash vs naive "
        f"on 8 rows: max |diff| {gap:.4g} (limit {PREFILL_GAP}), argmax agreement {agree:.3f}")
    need(gap <= PREFILL_GAP, f"flash prefill differs from naive by {gap:.4g}")

    # planted faults in the flash path, still through the kernel: each must
    # read above the limit
    sound = attention._flash
    try:
        for label, causal, drop in (("causal mask off", False, 0),
                                    ("last key tile dropped", True, 64)):
            attention._flash = planted_flash(flash_attention_fwd, causal, drop)
            bad, _ = tfm.make_prefill(cfg, RAG_MAX_LEN)(params, full[:8])
            fgap = float((bad.float() - naive.float()).abs().max())
            fagree = float((bad.argmax(-1) == naive.argmax(-1)).float().mean())
            say(f"phase 6 planted fault {label}: flash vs naive max |diff| {fgap:.4g}, argmax "
                f"agreement {fagree:.3f}")
            need(fgap > PREFILL_GAP, f"planted fault {label} passes the prefill check")
    finally:
        attention._flash = sound
    del params, doc_tokens, service, engine, rag
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# phase 10: the dense and moe configs served at full width
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def first_calls(module, name: str, key, keep: bool = False):
    """``{key(args, kwargs): (args, kwargs)}`` of the first call of
    ``module.name`` made inside the block for each key (``(args, kwargs,
    result)`` with ``keep``); every call runs as it is. A kernel wrapper
    counts its launches through its module's name, which names the catcher
    inside the block, so its ``launches`` count is handed to the catcher
    and back."""
    sound, caught = getattr(module, name), {}

    def catch(*args, **kwargs):
        result = sound(*args, **kwargs)
        k = key(args, kwargs)
        if k not in caught:
            caught[k] = (args, kwargs, result) if keep else (args, kwargs)
        return result

    counted = hasattr(sound, "launches")
    if counted:
        catch.launches = sound.launches
    setattr(module, name, catch)
    try:
        yield caught
    finally:
        setattr(module, name, sound)
        if counted:
            sound.launches = catch.launches


@contextlib.contextmanager
def first_call(module, name: str, keep: bool = False):
    """``[(args, kwargs)]`` of the first call of ``module.name`` made inside
    the block (``first_calls`` under one key), filled when the block ends."""
    caught: list = []
    with first_calls(module, name, lambda args, kwargs: None, keep) as by_key:
        yield caught
    caught.extend(by_key.values())


def bound_args(fn, call) -> list:
    """The arguments of a call caught by ``first_call``, defaults filled in,
    in ``fn``'s order."""
    ba = inspect.signature(fn).bind(*call[0], **call[1])
    ba.apply_defaults()
    return list(ba.arguments.values())


@contextlib.contextmanager
def moe_prefill_stats(n_tokens: int):
    """Per MoE layer call over ``n_tokens`` tokens inside the block (a
    prefill's): assignments dropped, the most and the mean assignments an
    expert took, its capacity, and the aux loss the layer returned."""
    import torch

    from repro_torch.models import moe

    sound, stats = moe.apply_moe, []

    def run(p, cfg, x):
        y, aux = sound(p, cfg, x)
        n = x.shape[0] * x.shape[1]
        if n == n_tokens:
            _, _, ids = moe.route(p, cfg, x.reshape(n, -1))
            c = moe.capacity(n, cfg)
            load = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
            stats.append(dict(dropped=int((moe.expert_slots(ids, c) >= c).sum()),
                              assignments=ids.numel(), capacity=c, max_load=int(load.max()),
                              mean_load=float(load.float().mean()), aux=float(aux)))
        return y, aux

    moe.apply_moe = run
    try:
        yield stats
    finally:
        moe.apply_moe = sound


@contextlib.contextmanager
def pinned_routing(picks: list, record: bool = False):
    """MoE routing inside the block: with ``record``, each MoE layer call's
    expert ids are appended to ``picks``; without, the calls take those ids
    in the same order, with gates from their own router's probabilities
    (renormalised), and the block yields, per call, how many of their own
    router's choices that replaced."""
    import torch

    from repro_torch.models import moe

    sound, calls, moved = moe.route, iter(list(picks)), []

    def route(p, cfg, xf):
        probs, gate, top = sound(p, cfg, xf)
        if record:
            picks.append(top)
            return probs, gate, top
        pinned = next(calls)
        moved.append(int((~(top[:, :, None] == pinned[:, None, :]).any(-1)).sum()))
        g = torch.gather(probs, -1, pinned)
        return probs, g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), pinned

    moe.route = route
    try:
        yield moved
    finally:
        moe.route = sound


@contextlib.contextmanager
def rope_off():
    """Planted fault (b): attention without RoPE inside the block (the
    decode step's q and new key; the prefill's cache entries keep theirs)."""
    from repro_torch.models import attention

    sound = attention.apply_rope
    attention.apply_rope = lambda x, positions, theta: x
    try:
        yield
    finally:
        attention.apply_rope = sound


def greedy_logits(cfg, params, prompt, steps: int, planted: bool = False):
    """Prefill ``prompt`` then ``steps`` greedy decode steps: ((B, steps + 1,
    V) logits, the prefill's first, (B, steps) tokens)."""
    import torch

    from repro_torch.models import transformer as tfm

    l = prompt.shape[1]
    logits, cache = tfm.make_prefill(cfg, RAG_MAX_LEN)(params, prompt)
    decode = tfm.make_decode_step(cfg)
    out, toks = [logits], []
    for i in range(steps):
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
        with rope_off() if planted else contextlib.nullcontext():
            logits, cache = decode(params, toks[-1], cache, l + i)
        out.append(logits)
    return torch.stack(out, dim=1), torch.stack(toks, dim=1)


def moe_loop(p, cfg, xf):
    """The script's own MoE on (N, D) tokens, one token at a time: the fp32
    router's softmax, the top k by a stable descending sort, the gates
    renormalised, Σ_j gate_j expert_j(x) in fp32, plus the shared expert."""
    import torch
    import torch.nn.functional as F

    probs = torch.softmax(xf.float() @ p.router, dim=-1)
    g, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    g, ids = g[:, :cfg.experts_per_token], ids[:, :cfg.experts_per_token]
    g = g / g.sum(-1, keepdim=True)
    rows = []
    for t in range(xf.shape[0]):
        x = xf[t].expand(len(ids[t]), 1, -1)  # (k, 1, D)
        h = torch.bmm(F.silu(torch.bmm(x, p.w_gate[ids[t]])) * torch.bmm(x, p.w_up[ids[t]]),
                      p.w_down[ids[t]])
        rows.append((h[:, 0].float() * g[t, :, None]).sum(0))
    y = torch.stack(rows).to(xf.dtype)
    if cfg.n_shared_experts:
        s = p.shared
        y = y + (F.silu(xf @ s.w_gate) * (xf @ s.w_up)) @ s.w_down
    return y


def gate_dispatch(name: str, cfg, params, check, device: str = "cuda") -> None:
    """Gate (c): the first MoE layer's dispatch on DISPATCH_TOKENS random
    tokens at a capacity that drops none, against the per-token loop; the
    planted fault (gates not renormalised) must read above the limit."""
    import dataclasses

    import torch

    from repro_torch.models import moe

    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    p = params.layers[0].moe
    gen = torch.Generator(device=device).manual_seed(3)
    xf = torch.randn((DISPATCH_TOKENS, cfg.d_model), generator=gen, device=device).to(
        params.embed.tok.dtype)
    with torch.inference_mode():
        _, _, ids = moe.route(p, cfg, xf)
        c = moe.capacity(DISPATCH_TOKENS, cfg)
        dropped = int((moe.expert_slots(ids, c) >= c).sum())
        want = moe_loop(p, cfg, xf).float()
        scale = float(want.abs().max())
        got = moe.apply_moe(p, cfg, xf[None])[0][0].float()
        gap = float((got - want).abs().max()) / scale
        sound = moe.route

        def raw_gates(p_, cfg_, x_):  # the top-k probabilities, not renormalised
            probs, _, top = sound(p_, cfg_, x_)
            return probs, torch.gather(probs, -1, top), top

        try:
            moe.route = raw_gates
            bad = moe.apply_moe(p, cfg, xf[None])[0][0].float()
        finally:
            moe.route = sound
        fgap = float((bad - want).abs().max()) / scale
    say(f"phase 10 {name} gate (c) dispatch vs per-token loop, {DISPATCH_TOKENS} tokens, C = {c}, "
        f"{dropped} dropped: max |diff| / max |y| {gap:.4g} (limit {DISPATCH_GAP}); planted "
        f"fault gates not renormalised {fgap:.4g}")
    check(dropped == 0, f"{name} gate (c): {dropped} assignments dropped at no-drop capacity")
    check(gap <= DISPATCH_GAP, f"{name} gate (c): dispatch differs from the loop by {gap:.4g}")
    check(fgap > DISPATCH_GAP, f"{name} gate (c): planted fault passes ({fgap:.4g})")


def lengths(l: int, s: int) -> str:
    return f"L=S={l}" if l == s else f"L={l} S={s}"


def caught_gaps(out, lse, want_out, want_lse) -> tuple[float, float]:
    """Gate (d)'s readings of a flash forward against the plain version's:
    max |out - want| / max |want out|, and the LSE's max |difference|."""
    gap = lambda a, b: float((a.float() - b.float()).abs().max())
    return gap(out, want_out) / float(want_out.float().abs().max()), gap(lse, want_lse)


def check_caught_flash(results: dict, name: str, call, device: str = "cuda",
                       phase: str = "phase 10", gate: str = "gate (d)",
                       part: str = "prefill") -> float:
    """The first flash-forward call of a model's prefill (or ``part``),
    caught on the path by ``first_call`` (phase 10's gate (d)), against the
    plain version (8 rows): elementwise within FLASH_TOL, and out and LSE
    within CAUGHT_OUT_GAP / CAUGHT_LSE_GAP, which its planted faults (the
    last keys dropped; a non-causal call made causal) must each exceed; two
    launches bit-identical; timed beside the plain version and
    scaled_dot_product_attention, and recorded among the kernel's checks
    under ``phase``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain

    q, k, v, causal, scale = bound_args(flash_attention_fwd, call)
    q, k, v = (t.detach() for t in (q, k, v))  # a training step's carry autograd's flags
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    b, h, l, dk = q.shape
    kvh, s, dv = k.shape[1], k.shape[2], v.shape[3]
    err = check_flash_fwd(results, f"{name} {part}", q, k, v, causal, rows=8, scale=scale)
    first, again = flash_attention_fwd(q, k, v, causal, scale), flash_attention_fwd(
        q, k, v, causal, scale)
    same = all(bool(torch.equal(a, b_)) for a, b_ in zip(first, again))
    need(same, f"flash {name}: repeated launches differ")
    rows, drop = slice(0, 8), min(FRONTEND_DROP, max(1, s // 4))
    qr, kr, vr = q[rows], k[rows], v[rows]
    want = flash_attention_plain(qr, kr, vr, causal, scale)
    out_lim = CAUGHT_OUT_GAP[str(q.dtype).removeprefix("torch.")]
    readings = {"sound": caught_gaps(first[0][rows], first[1][rows], *want)}
    del first, again
    readings[f"planted: last {drop} keys dropped"] = caught_gaps(*flash_attention_fwd(
        qr, kr[:, :, :s - drop], vr[:, :, :s - drop], causal, scale), *want)
    if not causal:
        readings["planted: made causal"] = caught_gaps(
            *flash_attention_fwd(qr, kr, vr, True, scale), *want)
    del want
    share = lambda o, g: max(o / out_lim, g / CAUGHT_LSE_GAP)
    gaps = "; ".join(f"{label} out {o:.4g} LSE {g:.4g}" for label, (o, g) in readings.items())
    for label, (o, g) in readings.items():
        planted = label != "sound"
        need(share(o, g) > 1 if planted else share(o, g) <= 1,
             f"flash {name} {part} {gate}: {label} out {o:.4g} LSE {g:.4g} "
             f"{'within' if planted else 'beyond'} the limits {out_lim} / {CAUGHT_LSE_GAP}")
    if device != "cuda":  # a CPU rehearsal: the plain version against itself, nothing timed
        return err
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal, scale), 5)
    plain_ms = time_ms(lambda: [flash_attention_plain(q[i:i + 8], k[i:i + 8], v[i:i + 8], causal,
                                                      scale) for i in range(0, b, 8)], 1, warm=1)
    try:
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=scale,
                                                      enable_gqa=kvh != h)
        sdpa()
        library_ms = time_ms(sdpa, 5)
    except RuntimeError as e:  # no SDPA backend for the shape: reported, not timed
        say(f"{phase} flash {name}: scaled_dot_product_attention refused the shape: "
            f"{str(e).splitlines()[0][:120]}")
        library_ms = None
    torch.cuda.empty_cache()
    nbytes, flops, rate = flash_work(q, k, v, causal)
    b_ms, b_by = bound(nbytes, flops, rate)
    shape = (f"{name}_{part} B={b} H={h} KV={kvh} {lengths(l, s)} dk={dk} dv={dv} "
             f"scale={scale:.6g} {'causal' if causal else 'non-causal'} {str(q.dtype)[6:]}")
    out_gap, lse_gap = readings["sound"]
    results["flash_attention_fwd"]["checks"].append(dict(
        shape=shape, max_abs_err=err, out_gap=out_gap, lse_gap=lse_gap, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, phase=phase))
    say(f"{phase} {gate} flash {shape}, caught on the path: max_abs_err (8 rows) {err:.3g}; "
        f"{gaps} (limits out {out_lim}, LSE {CAUGHT_LSE_GAP}); two launches bit-identical; "
        f"ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) "
        f"sdpa_ms {library_ms if library_ms is None else round(library_ms, 4)}")
    return err


def check_caught_bwd(results: dict, name: str, call, device: str = "cuda",
                     phase: str = "phase 11", rows: int = 2) -> dict:
    """The first flash backward of a training step, caught on the path by
    ``first_call(fa, "flash_attention_bwd", keep=True)``: the dQ and dK-dV
    kernels launched again on its operands give the step's gradients bit
    for bit, and, on its dO scaled by a power of two to unit size, agree
    with ``flash_attention_bwd_plain`` on ``rows`` batch rows within
    GRAD_TOL; timed beside the plain version and the SDPA
    backward, and recorded among each kernel's checks under ``phase``.
    Returns {kernel: (max |error|, max |error| / its limit)}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        _delta,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
    )

    q, k, v, out, lse, do, causal, scale = bound_args(flash_attention_bwd, call)
    q, k, v, out, lse, do = (t.detach() for t in (q, k, v, out, lse, do))
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    step_dq, step_dk, step_dv = call[2]
    atol, rtol = GRAD_TOL[str(q.dtype).removeprefix("torch.")]
    delta = _delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    same = all(bool(torch.equal(a, b_)) for a, b_ in
               ((dq, step_dq), (dk, step_dk), (dv, step_dv)))
    need(same, f"flash bwd {name}: the kernels launched again differ from the step's gradients")
    # a step's dO is the mean loss's (~1e-7 a value), where GRAD_TOL's atol
    # would pass any error; the kernels are linear in dO, so they are held
    # against the plain version on dO scaled by a power of two to max |dO| in
    # [1, 2), which rounds nothing, as phase 7 holds them on unit-scale dO
    top = float(do.abs().max())
    need(top > 0, f"flash bwd {name}: the caught dO is zero")
    pow2 = 2.0 ** -math.floor(math.log2(top))
    do_s = do * pow2
    delta_s = _delta(out, do_s)
    dq = flash_attention_bwd_dq(q, k, v, do_s, lse, delta_s, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do_s, lse, delta_s, causal, scale)
    want = flash_attention_bwd_plain(q[:rows], k[:rows], v[:rows], out[:rows], lse[:rows],
                                     do_s[:rows], causal, scale)
    worst: dict = {}
    size = collections.Counter()
    for kname, got, w in (("flash_attention_bwd_dq", dq[:rows], want[0]),
                          ("flash_attention_bwd_dkv", dk[:rows], want[1]),
                          ("flash_attention_bwd_dkv", dv[:rows], want[2])):
        got, w = got.float(), w.float()
        size[kname] = max(size[kname], float(w.abs().max()))
        need(bool(torch.isfinite(got).all()), f"flash bwd {name}: non-finite {kname}")
        diff = (got - w).abs()
        reading = float((diff / (atol + rtol * w.abs())).max())
        need(reading <= 1, f"flash bwd {name} {kname}: error {float(diff.max()):.3g}, "
             f"{reading:.3g} of its limit {atol:.3g} + {rtol:.3g} |w|")
        err, rd = worst.get(kname, (0.0, 0.0))
        worst[kname] = (max(err, float(diff.max())), max(rd, reading))
    del want, do_s, delta_s, dq, dk, dv
    b, h, l, d = q.shape
    kvh = k.shape[1]
    shape = (f"{name} B={b} H={h} KV={kvh} {lengths(l, k.shape[2])} d={d} "
             f"{'causal' if causal else 'non-causal'} {str(q.dtype)[6:]}")
    times = dict.fromkeys(worst)
    plain_ms = library_ms = None
    if device == "cuda":
        times = {"flash_attention_bwd_dq": time_ms(
            lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale), 5),
            "flash_attention_bwd_dkv": time_ms(
            lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale), 5)}
        plain_ms = time_ms(lambda: [flash_attention_bwd_plain(
            q[i:i + rows], k[i:i + rows], v[i:i + rows], out[i:i + rows], lse[i:i + rows],
            do[i:i + rows], causal, scale) for i in range(0, b, rows)], 2, warm=1)
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, scale=scale,
                                                 enable_gqa=kvh != h)
        library_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                                         retain_graph=True), 5)
        del qs, ks, vs, lib_out
        torch.cuda.empty_cache()
    for kname, (err, rd) in worst.items():
        results[kname]["max_abs_err"] = max(results[kname]["max_abs_err"], err)
        part = kname.removeprefix("flash_attention_bwd_")
        nbytes, flops, rate = bwd_work(q, k, v, causal, part)
        b_ms, b_by = bound(nbytes, flops, rate)
        results[kname]["checks"].append(dict(
            shape=shape, max_abs_err=err, ms=times[kname], plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms, phase=phase))
        say(f"{phase} {kname} {shape}, caught on the path: the step's gradients again bit for "
            f"bit; on dO x {pow2:.6g} (max |dO| {top:.4g}; max |w| {size[kname]:.4g}): "
            f"max_abs_err ({rows} rows) {err:.3g}, reading {rd:.3g} of the limit "
            f"{atol:.3g} + {rtol:.3g} |w|; ms {times[kname]} bound_ms {b_ms:.4f} ({b_by}) plain_ms "
            f"(dQ, dK and dV in {rows}-row calls) {plain_ms} sdpa_bwd_ms (dQ, dK and dV) "
            f"{library_ms}")
    return worst


def serve_model(name: str, depth, requests: int, corpus_bundle, index, doc_tokens,
                results: dict, check, device: str = "cuda") -> None:
    """One config of phase 10 at full width (depth cut to ``depth`` layers
    where given): random weights from a seed, served through its entry
    points (RagPipeline over phase 4's index, or the engine alone), then
    gates (a), (b), (d) and, for a moe config, (c)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_topk import fused_topk
    from repro_torch.kernels.hybrid_distance import hybrid_distance
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.obs.tracer import TraceContext
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.hybrid_service import HybridSearchService
    from repro_torch.serving.rag import RagConfig, RagPipeline

    t_model = time.perf_counter()
    cfg = dataclasses.replace(get_config(name), attn_impl="flash")
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    moe = cfg.family == "moe"
    cuda = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = tfm.init_params(cfg, gen, device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    n_params = sum(p.numel() for p in params.parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    l = RAG_TOP_K * RAG_CTX + RAG_PROMPT
    say(f"phase 10 {name}: {cfg.n_layers} layers"
        + (f" ({cfg.first_dense_layers} dense, {cfg.n_layers - cfg.first_dense_layers} MoE of "
           f"{cfg.n_experts} experts top-{cfg.experts_per_token}"
           + (", the MTP head" if cfg.mtp else "") + ")" if moe else "")
        + f", d_model {cfg.d_model}, {cfg.n_heads} heads"
        + (f" MLA (q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, rope {cfg.rope_head_dim})"
           if cfg.use_mla else f" / {cfg.n_kv_heads} kv, head_dim {cfg.head_dim}")
        + f", vocab {cfg.vocab}, {cfg.dtype}: {n_params} parameters, {p_bytes / 1e9:.2f} GB "
        f"(config n_params {cfg.n_params}), drawn in {time.perf_counter() - t:.1f} s")

    engine = ServingEngine(cfg, params, ServeConfig(max_len=RAG_MAX_LEN))
    prompts = torch.randint(0, cfg.vocab, (requests, RAG_PROMPT), generator=gen, device=device,
                            dtype=torch.int32)
    c = corpus_bundle
    rag = None
    if doc_tokens is not None:
        rag_cfg = RagConfig(top_k=RAG_TOP_K, ctx_tokens_per_doc=RAG_CTX)
        service = HybridSearchService(index, dataclasses.replace(rag_cfg.search, k=RAG_TOP_K))
        rag = RagPipeline(engine, index, doc_tokens, rag_cfg, service=service)
        rag.answer(c.queries[0:2], prompts[:2], 2)  # warm-up: library handles, allocator
        inputs = None
    else:
        inputs = torch.randint(0, cfg.vocab, (requests, l), generator=gen, device=device,
                               dtype=torch.int32)
        engine.generate(inputs[:2, :64], 2)

    # ---- the main path: counts zeroed just before, read just after --------
    wrappers = {"flash_attention_fwd": flash_attention_fwd, "hybrid_distance": hybrid_distance,
                "fused_topk": fused_topk}
    for w in wrappers.values():
        w.launches = 0
    trace = TraceContext(name)
    steps = RAG_GEN if rag else DENSE_STEPS + 1
    with (first_call(fa, "flash_attention_fwd") as caught,
          moe_prefill_stats(requests * l) as stats):
        sync()
        t0 = time.perf_counter()
        if rag:
            out, res = rag.answer(c.queries[0:requests], prompts, steps, trace=trace)
        else:
            out = engine.generate(inputs, steps, trace=trace)
        sync()
        e2e = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    span = lambda s: trace.find(s)[0]
    prefill_s = span("prefill").t1 - span("prefill").t0
    decode_s = span("decode").t1 - span("decode").t0
    retrieval = (f"retrieval {span('context_assembly').t0 - t0:.3f} s, " if rag else "")
    say(f"phase 10 {name} {'RAG ' if rag else ''}{requests} requests, L = {l}, {steps} tokens "
        f"greedy: {retrieval}prefill {prefill_s:.3f} s ({requests * l / prefill_s:.1f} tokens/s), "
        f"decode {decode_s:.3f} s ({requests * (steps - 1) / decode_s:.1f} tokens/s over "
        f"{steps - 1} steps), {'RAG batch' if rag else 'end to end'} {e2e:.3f} s; parameters "
        f"{p_bytes / 1e9:.2f} GB, peak memory {peak_gb:.2f} GB; launches {json.dumps(launches)}")
    for i, st in enumerate(stats):
        say(f"phase 10 {name} prefill MoE layer {i}: {st['dropped']} of {st['assignments']} "
            f"assignments dropped at capacity {st['capacity']}; an expert took at most "
            f"{st['max_load']}, on average {st['mean_load']:.1f}; aux loss {st['aux']:.6f}")
    check(len(stats) == (cfg.n_layers - cfg.first_dense_layers if moe else 0),
          f"{name}: {len(stats)} MoE layers seen in the prefill")
    check(launches["flash_attention_fwd"] == (cfg.n_layers if cuda else 0),
          f"{name}: {launches['flash_attention_fwd']} flash launches, not {cfg.n_layers}")
    for k in launches:
        results[k]["launches"] += launches[k]
    if rag:
        for k in ("hybrid_distance", "fused_topk"):
            check(launches[k] > 0 or not cuda, f"{name}: {k} was not launched while RAG "
                  "retrieved")
        full = torch.cat([rag.build_context(res), prompts], dim=1)
        check(bool((res.ids[:, :RAG_TOP_K] >= 0).all()), f"{name}: a request retrieved less")
    else:
        full = inputs
    check(tuple(out.shape) == (requests, l + steps), f"{name}: output shape {tuple(out.shape)}")
    check(torch.equal(out[:, :l], full), f"{name}: the output does not start with its prompt")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), f"{name}: tokens out of range")

    check(len(caught) == 1, f"{name}: no flash-forward call caught in the prefill")
    check_caught_flash(results, name, caught[0], device)  # gate (d)
    del caught

    # ---- gate (a): flash vs naive prefill on the same rows -----------------
    # in a moe config the naive pass takes the flash pass's expert choices:
    # the two attention paths round apart, and a token whose k-th and
    # (k+1)-th experts nearly tie changes expert, which moves its logits by
    # far more than the rounding (kimi-k2: 0.37 on an H100, PERF.md)
    rows = full[:GATE_ROWS]
    naive_cfg = dataclasses.replace(cfg, attn_impl="naive")
    picks: list = []
    with pinned_routing(picks, record=True):
        flash, _ = tfm.make_prefill(cfg, RAG_MAX_LEN)(params, rows)
    need(bool(torch.isfinite(flash.float()).all()), f"{name}: non-finite prefill logits")
    with pinned_routing(picks) as moved:
        naive, _ = tfm.make_prefill(naive_cfg, RAG_MAX_LEN)(params, rows)
    gap = float((flash.float() - naive.float()).abs().max())
    agree = float((flash.argmax(-1) == naive.argmax(-1)).float().mean())
    planted = ""
    if cfg.use_mla:  # planted: MLA through the kernel at hd ** -0.5, not (hd + rh) ** -0.5
        sound = attention._flash
        try:
            attention._flash = lambda q, k, v, scale=None: sound(q, k, v, cfg.head_dim ** -0.5)
            with pinned_routing(picks):
                bad, _ = tfm.make_prefill(cfg, RAG_MAX_LEN)(params, rows)
        finally:
            attention._flash = sound
        fgap = float((bad.float() - naive.float()).abs().max())
        planted = f"; planted fault scale hd ** -0.5: {fgap:.4g}"
        check(fgap > MODEL_PREFILL_GAP, f"{name} gate (a): planted fault passes ({fgap:.4g})")
    say(f"phase 10 {name} gate (a) prefill logits flash vs naive on {GATE_ROWS} rows: max |diff| "
        f"{gap:.4g} (limit {MODEL_PREFILL_GAP}), argmax agreement {agree:.3f}{planted}"
        + (f"; expert choices of the naive pass's own router that the flash pass's "
           f"replaced, per MoE layer: {moved} of {rows.numel() * cfg.experts_per_token}"
           if moe else ""))
    check(gap <= MODEL_PREFILL_GAP, f"{name} gate (a): flash differs from naive by {gap:.4g}")
    del flash, naive

    # ---- gate (b): greedy decode vs the full forward -----------------------
    r = 1 if moe else 2
    dcfg = (dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
            if moe else cfg)  # no drops: a single-token decode never drops
    got, toks = greedy_logits(dcfg, params, full[:r], DECODE_CHECK)
    with torch.inference_mode():
        fwd, _, _ = tfm.make_forward(dcfg)(params, torch.cat([full[:r], toks], dim=1))
    want = fwd[:, l - 1:].float()
    del fwd
    bgap = float((got.float() - want).abs().max())
    bad, _ = greedy_logits(dcfg, params, full[:r], DECODE_CHECK, planted=True)
    fgap = float((bad.float() - want).abs().max())
    say(f"phase 10 {name} gate (b) greedy decode vs forward, {r} row(s), the prefill's and "
        f"{DECODE_CHECK} decode steps' logits: max |diff| {bgap:.4g} (limit {DECODE_GAP}); "
        f"planted fault decode without RoPE {fgap:.4g}")
    check(bgap <= DECODE_GAP, f"{name} gate (b): decode differs from forward by {bgap:.4g}")
    check(fgap > DECODE_GAP, f"{name} gate (b): planted fault passes ({fgap:.4g})")
    del got, bad, want

    if moe:
        gate_dispatch(name, cfg, params, check, device)
    del params, engine, rag
    if cuda:
        torch.cuda.empty_cache()
    say(f"phase 10 {name}: {time.perf_counter() - t_model:.1f} s")


def train_smoke(results: dict, check, device: str = "cuda") -> None:
    """One training step of the deepseek-v3 and kimi-k2 smoke configs on the
    card (bf16, flash, AdamW): the MoE backward through the dispatch and the
    flash backward at the smoke configs' head dims (MLA: dk 48, dv 32)."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_state, make_train_step

    for name in ("deepseek-v3-671b", "kimi-k2-1t-a32b"):
        cfg = dataclasses.replace(get_smoke_config(name), attn_impl="flash")
        tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=1, total_steps=10))
        state = make_train_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0),
                                 device)
        batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8, seed=0),
                              device=device).batch(0)
        wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
        before = [w.launches for w in wrappers]
        t = time.perf_counter()
        state, metrics = make_train_step(cfg, tcfg)(state, batch)
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = [w.launches - b for w, b in zip(wrappers, before)]
        n_attn = cfg.n_layers + int(cfg.mtp)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        finite = all(bool(torch.isfinite(p).all()) for p in state["params"].parameters())
        say(f"phase 10 train {name} smoke ({cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_experts} experts, {cfg.dtype}, flash, 8 x 128 tokens): one step "
            f"{dt:.3f} s, loss {loss:.6f} (ln V = {math.log(cfg.vocab):.4f}), grad norm "
            f"{gnorm:.6f}; flash forward / dQ / dK-dV launches {counts}")
        check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0 and finite,
              f"train {name}: loss {loss}, grad norm {gnorm}, parameters finite {finite}")
        want = [n_attn if device == "cuda" else 0] * 3
        check(counts == want, f"train {name}: flash launches {counts} != {want}")
        for w, n in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"), counts):
            results[w]["launches"] += n
        del state


def phase_models(corpus_bundle, index, results: dict, device: str = "cuda") -> None:
    """Phase 10: every dense and moe config but llama3.2-1b at full width,
    random weights from a seed: qwen2-1.5b whole through RagPipeline at
    phase 6's batch; deepseek-v3 (depth cut to 4: 3 dense MLA layers, 1 MoE
    layer, the MTP head) and kimi-k2 (cut to 2: 1 dense, 1 MoE) through
    RagPipeline at MOE_REQUESTS; deepseek-7b and starcoder2-15b whole, one
    prefill of DENSE_ROWS and DENSE_STEPS decode steps; then a training step
    of each moe smoke config. Every gate's reading is printed; the phase
    fails at its end if any gate did. (``device`` lets the phase be
    rehearsed on the CPU, with smaller configs patched in.)"""
    import torch

    t = time.perf_counter()
    fails: list = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            fails.append(msg)
            say(f"phase 10 FAILED: {msg}")

    from repro_torch.configs import get_config

    served = (("qwen2-1.5b", None, RAG_REQUESTS, True),
              ("deepseek-v3-671b", MOE_DEPTH["deepseek-v3-671b"], MOE_REQUESTS, True),
              ("kimi-k2-1t-a32b", MOE_DEPTH["kimi-k2-1t-a32b"], MOE_REQUESTS, True),
              ("deepseek-7b", None, DENSE_ROWS, False),
              ("starcoder2-15b", None, DENSE_ROWS, False))
    vocab = min(get_config(name).vocab for name, _, _, rag in served if rag)
    gen = torch.Generator(device=device).manual_seed(1)
    doc_tokens = torch.randint(0, vocab, (corpus_bundle.docs.n, RAG_CTX), generator=gen,
                               device=device, dtype=torch.int32)
    for name, depth, requests, rag in served:
        serve_model(name, depth, requests, corpus_bundle, index, doc_tokens if rag else None,
                    results, check, device)
    del doc_tokens
    train_smoke(results, check, device)
    say(f"phase 10: {time.perf_counter() - t:.1f} s")
    need(not fails, f"phase 10: {len(fails)} gate(s) failed: {fails}")


# ---------------------------------------------------------------------------
# phase 11: the recurrent families (ssm and hybrid) at full width
# ---------------------------------------------------------------------------


def recurrent_modules(cfg):
    """(the scan's module, its chunked form's name, the state group of the
    cache, the state leaf gate (b)'s planted fault zeroes)."""
    from repro_torch.models import mamba2, rwkv6

    if cfg.family == "ssm":
        return rwkv6, "wkv6_chunked", "layers", "tm_x"
    return mamba2, "ssd_chunked", "mamba", "conv"


def state_bytes(cache: dict, group: str) -> int:
    """Bytes of the recurrent state the cache holds (the shared block's KV
    of a hybrid model left out)."""
    return sum(t.numel() * t.element_size() for t in cache[group].values())


@contextlib.contextmanager
def carry_dropped(module):
    """Planted fault (a): the chunked scan without the carry across chunks
    (every chunk starts from a zero state; the final state is kept)."""
    import torch

    sound = module._chunk_states

    def dropped(decay, chunk_state, s0):
        before, s_fin = sound(decay, chunk_state, s0)
        return torch.zeros_like(before), s_fin

    module._chunk_states = dropped
    try:
        yield
    finally:
        module._chunk_states = sound


def recurrent_readings(cfg, params, full, out, plant: str, scan_gap: float) -> list:
    """Phase 11's gates (a)-(c) on ``params`` at ``cfg``'s dtype, as
    (label, reading, limit, kind) with kind "sound", "planted" (must read
    above the limit) or "info" (printed): (a) each recurrent block of a
    forward over SCAN_ROWS rows, chunked scan against the per-step
    recurrence on the same input, max |difference| / max |output| over the
    blocks, limit ``scan_gap`` (block by block: a random-init rwkv6-7b turns
    fp32 rounding at one block into logit gaps of 3.9 by the last,
    PERF.md); (b) the
    last logits of a prefill of L and CARRY_STEPS decode steps against one
    prefill of L + CARRY_STEPS, and the state; (c) for a hybrid model, flash
    against naive prefill on GATE_ROWS rows. The gates named in ``plant``
    read their planted faults too: (a) the carry across chunks dropped, (b) the
    token-shift / conv state zeroed between steps, (c) phase 6's two faults
    in the flash path."""
    import dataclasses

    import torch

    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm

    module, _, group, zeroed = recurrent_modules(cfg)
    apply_name = "apply_rwkv6_block" if cfg.family == "ssm" else "apply_mamba2_block"
    gap = lambda a, b: float((a.float() - b.float()).abs().max())
    l = full.shape[1]
    rows = full[:SCAN_ROWS]
    r = []

    sound_apply, gaps = getattr(module, apply_name), []

    def both_forms(p, cfg_, x, state, chunked=True):
        y, s = sound_apply(p, cfg_, x, state, chunked=chunked)
        y_bad = None
        if "a" in plant:
            with carry_dropped(module):
                y_bad = sound_apply(p, cfg_, x, state)[0]
        stepped = sound_apply(p, cfg_, x, state, chunked=False)[0]
        scale = float(stepped.float().abs().max())
        gaps.append((gap(y, stepped) / scale, None if y_bad is None else gap(y_bad, stepped) / scale))
        return y, s

    setattr(module, apply_name, both_forms)
    try:
        with torch.inference_mode():
            tfm.make_forward(cfg)(params, rows)
    finally:
        setattr(module, apply_name, sound_apply)
    r.append(("(a) max over blocks of |chunked - per-step| / max |out|",
              max(g for g, _ in gaps), scan_gap, "sound"))
    if "a" in plant:
        r.append(("(a) planted: carry dropped", max(b for _, b in gaps), scan_gap, "planted"))

    prefill = tfm.make_prefill(cfg, RAG_MAX_LEN)
    decode = tfm.make_decode_step(cfg)
    want, want_cache = prefill(params, out[:SCAN_ROWS, :l + CARRY_STEPS])
    for fault in (False, True) if "b" in plant else (False,):
        logits, cache = prefill(params, rows)
        for i in range(CARRY_STEPS):
            logits, cache = decode(params, out[:SCAN_ROWS, l + i], cache, l + i)
            if fault:
                with torch.inference_mode():
                    cache[group][zeroed].zero_()
        if fault:
            r.append((f"(b) planted: {zeroed} zeroed", gap(logits, want), CARRY_GAP, "planted"))
        else:
            r.append(("(b) prefill + decode vs one prefill", gap(logits, want), CARRY_GAP,
                      "sound"))
            r.append(("(b) the state, max |difference| / max |value|", max(
                gap(cache[group][k], want_cache[group][k])
                / float(want_cache[group][k].float().abs().max()) for k in cache[group]),
                None, "info"))
    del want, want_cache, cache

    if cfg.family == "hybrid":
        rows8 = full[:GATE_ROWS]
        naive, _ = tfm.make_prefill(dataclasses.replace(cfg, attn_impl="naive"), RAG_MAX_LEN)(
            params, rows8)
        r.append(("(c) flash vs naive", gap(prefill(params, rows8)[0], naive), HYBRID_FLASH_GAP,
                  "sound"))
        sound = attention._flash
        try:
            for label, causal, drop in ((("causal mask off", False, 0),
                                         ("last key tile dropped", True, 64)) if "c" in plant
                                        else ()):
                attention._flash = planted_flash(flash_attention_fwd, causal, drop)
                r.append((f"(c) planted: {label}", gap(prefill(params, rows8)[0], naive),
                          HYBRID_FLASH_GAP, "planted"))
        finally:
            attention._flash = sound
    return r

def serve_recurrent(name: str, corpus_bundle, index, doc_tokens, results: dict, check,
                    device: str = "cuda") -> None:
    """One recurrent config at full width and depth, random weights from a
    seed, through RagPipeline over phase 4's index at phase 6's batch; the
    chunked scan's share of the prefill; the first flash-forward call of a
    hybrid model's prefill against the plain version; gate (d), the state's
    bytes; then gates (a)-(c) (``recurrent_readings``): (a) held on the
    served bf16 weights and on fp32 copies of them, (b) and (c) held on the
    fp32 copies and printed in bf16, each held gate with its planted
    faults."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_topk import fused_topk
    from repro_torch.kernels.hybrid_distance import hybrid_distance
    from repro_torch.models import transformer as tfm
    from repro_torch.obs.tracer import TraceContext
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.hybrid_service import HybridSearchService
    from repro_torch.serving.rag import RagConfig, RagPipeline

    t_model = time.perf_counter()
    cfg = dataclasses.replace(get_config(name), attn_impl="flash")
    hybrid = cfg.family == "hybrid"
    n_groups = cfg.n_layers // cfg.attn_every if hybrid else 0
    module, scan_name, group, _ = recurrent_modules(cfg)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(0)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = tfm.init_params(cfg, gen, device)
    sync()
    n_params = sum(p.numel() for p in params.parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    l = RAG_TOP_K * RAG_CTX + RAG_PROMPT
    say(f"phase 11 {name}: {cfg.n_layers} "
        + (f"Mamba2 layers (d_inner {2 * cfg.d_model}, {2 * cfg.d_model // cfg.ssm_head_dim} "
           f"heads of {cfg.ssm_head_dim}, ssm_state {cfg.ssm_state}), the shared attention "
           f"block ({cfg.n_heads} heads / {cfg.n_kv_heads} kv, head_dim {cfg.head_dim}, d_ff "
           f"{cfg.d_ff}) after every {cfg.attn_every}: {n_groups} applications"
           if hybrid else
           f"RWKV6 layers ({cfg.d_model // cfg.ssm_head_dim} WKV heads of {cfg.ssm_head_dim}, "
           f"channel mix {int(3.5 * cfg.d_model)}, decay LoRA {cfg.wkv_lora})")
        + f", d_model {cfg.d_model}, vocab {cfg.vocab}, ssm_chunk {cfg.ssm_chunk}, {cfg.dtype}: "
        f"{n_params} parameters, {p_bytes / 1e9:.2f} GB (config n_params {cfg.n_params}), drawn "
        f"in {time.perf_counter() - t:.1f} s")

    c = corpus_bundle
    engine = ServingEngine(cfg, params, ServeConfig(max_len=RAG_MAX_LEN))
    prompts = torch.randint(0, cfg.vocab, (RAG_REQUESTS, RAG_PROMPT), generator=gen,
                            device=device, dtype=torch.int32)
    rag_cfg = RagConfig(top_k=RAG_TOP_K, ctx_tokens_per_doc=RAG_CTX)
    service = HybridSearchService(index, dataclasses.replace(rag_cfg.search, k=RAG_TOP_K))
    rag = RagPipeline(engine, index, doc_tokens, rag_cfg, service=service)
    rag.answer(c.queries[0:2], prompts[:2], 2)  # warm-up: library handles, allocator

    # ---- the main path: counts zeroed just before, read just after --------
    wrappers = {"flash_attention_fwd": flash_attention_fwd, "hybrid_distance": hybrid_distance,
                "fused_topk": fused_topk}
    for w in wrappers.values():
        w.launches = 0
    trace = TraceContext(name)
    with (first_call(fa, "flash_attention_fwd") as caught,
          first_call(module, scan_name) as scans):
        sync()
        t0 = time.perf_counter()
        out, res = rag.answer(c.queries[0:RAG_REQUESTS], prompts, RAG_GEN, trace=trace)
        sync()
        e2e = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    span = lambda s: trace.find(s)[0]
    retrieval_s = span("context_assembly").t0 - t0
    prefill_s = span("prefill").t1 - span("prefill").t0
    decode_s = span("decode").t1 - span("decode").t0
    shapes = tfm.cache_shape(cfg, RAG_REQUESTS, RAG_MAX_LEN)
    nbytes = lambda tree: sum(math.prod(s.shape) * s.dtype.itemsize for s in tree.values())
    say(f"phase 11 {name} RAG {RAG_REQUESTS} requests, L = {l}, {RAG_GEN} tokens greedy: "
        f"retrieval {retrieval_s:.3f} s, prefill {prefill_s:.3f} s "
        f"({RAG_REQUESTS * l / prefill_s:.1f} tokens/s), decode {decode_s:.3f} s "
        f"({RAG_REQUESTS * (RAG_GEN - 1) / decode_s:.1f} tokens/s over {RAG_GEN - 1} steps), "
        f"RAG batch {e2e:.3f} s; parameters {p_bytes / 1e9:.2f} GB, peak memory {peak_gb:.2f} GB; "
        f"recurrent state {nbytes(shapes[group]) / 1e6:.1f} MB for the batch"
        + (f", the shared block's KV {nbytes(shapes['shared']) / 1e6:.1f} MB at max_len "
           f"{RAG_MAX_LEN}" if hybrid else "")
        + f"; launches {json.dumps(launches)}")
    want_flash = n_groups if cuda else 0
    check(launches["flash_attention_fwd"] == want_flash,
          f"{name}: {launches['flash_attention_fwd']} flash launches, not {want_flash}")
    for k in launches:
        results[k]["launches"] += launches[k]
    for k in ("hybrid_distance", "fused_topk"):
        check(launches[k] > 0 or not cuda, f"{name}: {k} was not launched while RAG retrieved")
    full = torch.cat([rag.build_context(res), prompts], dim=1)
    check(bool((res.ids[:, :RAG_TOP_K] >= 0).all()), f"{name}: a request retrieved less")
    check(tuple(out.shape) == (RAG_REQUESTS, l + RAG_GEN), f"{name}: output shape "
          f"{tuple(out.shape)}")
    check(torch.equal(out[:, :l], full), f"{name}: the output does not start with its prompt")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), f"{name}: tokens out of range")

    # ---- the chunked scan's share of the prefill ----------------------------
    check(len(scans) == 1, f"{name}: no chunked {scan_name} call caught in the prefill")
    args, kwargs = scans[0]
    del scans
    sound_scan = getattr(module, scan_name)
    if cuda:
        scan_ms = time_ms(lambda: sound_scan(*args, **kwargs), 3, warm=1)
        dims = ", ".join(str(tuple(a.shape)) for a in args if hasattr(a, "shape"))
        say(f"phase 11 {name} {scan_name} at the prefill's shapes ({dims}): {scan_ms:.3f} ms a "
            f"layer, x {cfg.n_layers} layers = "
            f"{scan_ms * cfg.n_layers / 1e3:.3f} s, {scan_ms * cfg.n_layers / 1e3 / prefill_s:.3f} "
            f"of the prefill's {prefill_s:.3f} s")
    del args, kwargs
    if cuda:
        torch.cuda.empty_cache()

    if hybrid:
        check(len(caught) == 1, f"{name}: no flash-forward call caught in the prefill")
        if caught:
            check_caught_flash(results, name, caught[0], device, phase="phase 11",
                               gate="kernel check")
    del caught

    # ---- gate (d): the state does not grow, and is written in place --------
    prefill = tfm.make_prefill(cfg, RAG_MAX_LEN)
    decode = tfm.make_decode_step(cfg)
    rows = full[:SCAN_ROWS]
    _, cache = prefill(params, rows)
    b_prefill = state_bytes(cache, group)
    ptrs = [t.data_ptr() for t in cache[group].values()]
    for i in range(CARRY_STEPS):
        _, cache = decode(params, out[:SCAN_ROWS, l + i], cache, l + i)
    b_decode = state_bytes(cache, group)
    in_place = ptrs == [t.data_ptr() for t in cache[group].values()]
    _, long_cache = tfm.make_prefill(cfg, 2 * RAG_MAX_LEN)(params, rows)
    b_long = state_bytes(long_cache, group)

    # planted fault (d), a check of the measurement (state_bytes), not of the
    # program: a per-position tensor, as a KV cache keeps, added to the cache
    def per_position(max_len):
        cache_ = tfm.make_prefill(cfg, max_len)(params, rows)[1]
        cache_[group]["history"] = torch.zeros(
            (cfg.n_layers, SCAN_ROWS, max_len, cfg.d_model), dtype=params.embed.tok.dtype,
            device=rows.device)
        return state_bytes(cache_, group)

    planted = [per_position(m) for m in (RAG_MAX_LEN, 2 * RAG_MAX_LEN)]
    say(f"phase 11 {name} gate (d) recurrent state bytes for {SCAN_ROWS} rows: after the prefill "
        f"{b_prefill}, after {CARRY_STEPS} decode steps {b_decode} (written in place: "
        f"{in_place}), at max_len {2 * RAG_MAX_LEN} {b_long}"
        + (f"; the shared block's KV {state_bytes(cache, 'shared')} at max_len {RAG_MAX_LEN}, "
           f"{state_bytes(long_cache, 'shared')} at {2 * RAG_MAX_LEN}" if hybrid else "")
        + f"; planted fault state kept per position {planted[0]} / {planted[1]}")
    check(b_prefill == b_decode == b_long and in_place,
          f"{name} gate (d): state bytes {b_prefill} / {b_decode} / {b_long}, in place {in_place}")
    check(planted[0] != planted[1], f"{name} gate (d): planted fault passes ({planted})")
    del cache, long_cache

    # ---- gates (a)-(c): (a) held in bf16, all three on fp32 copies ----------
    # a random-init model at full width turns bf16's rounding into O(1)
    # logit gaps between any two orders of the same sums (PERF.md), as
    # phase 7's gradients do, so (b) and (c) are only printed in bf16; gate
    # (a) reads block by block, where bf16's sound readings stay small
    bf16 = recurrent_readings(cfg, params, full, out, plant="a", scan_gap=SCAN_GAP_BF16)
    del engine, rag, service
    params.float()  # in place: the fp32 gates read copies of the same weights
    if cuda:
        torch.cuda.empty_cache()
    fp32 = recurrent_readings(dataclasses.replace(cfg, dtype="float32"), params, full, out,
                              plant="abc", scan_gap=SCAN_GAP)
    for dtype, readings in (("bf16", bf16), ("fp32", fp32)):
        gated = lambda label, kind, dtype=dtype: kind != "info" and (
            dtype == "fp32" or label.startswith("(a)"))
        say(f"phase 11 {name} gates (a)-(c) in {dtype}: " + "; ".join(
            f"{label} {v:.4g}" + (f" (limit {lim})" if gated(label, kind) else " (printed)")
            for label, v, lim, kind in readings))
        for label, v, lim, kind in readings:
            if gated(label, kind):
                ok = v > lim if kind == "planted" else v <= lim
                check(ok, f"{name} {dtype} {label}: {v:.4g} "
                      f"{'<=' if kind == 'planted' else '>'} {lim}")

    del params
    if cuda:
        torch.cuda.empty_cache()
    say(f"phase 11 {name}: {time.perf_counter() - t_model:.1f} s")


def train_recurrent(results: dict, check, device: str = "cuda") -> None:
    """One training step of zamba2-1.2b at full width and depth (bf16,
    flash, remat full, AdamW with fp32 moments) and one of each recurrent
    smoke config, with their flash launches against what remat predicts:
    under remat "full" each shared-block application's forward runs twice.
    The full-width step's first flash forward and first flash backward are
    caught on the path and held against the plain versions on 2 rows
    (``check_caught_flash``, ``check_caught_bwd``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_state, make_train_step

    cuda = device == "cuda"
    runs = (("zamba2-1.2b", get_config("zamba2-1.2b"), TRAIN_RECURRENT, True),
            ("rwkv6-7b smoke", get_smoke_config("rwkv6-7b"), (8, 128), False),
            ("zamba2-1.2b smoke", get_smoke_config("zamba2-1.2b"), (8, 128), False))
    for label, cfg, (batch, seq), catch in runs:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
        tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=1, total_steps=10))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        state = make_train_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0),
                                 device)
        data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0),
                             device=device).batch(0)
        wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
        before = [w.launches for w in wrappers]
        step = make_train_step(cfg, tcfg)
        with (first_call(fa, "flash_attention_fwd") as fwd_calls,
              first_call(fa, "flash_attention_bwd", keep=True) as bwd_calls):
            t = time.perf_counter()
            state, metrics = step(state, data)
            if cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t
        counts = [w.launches - b for w, b in zip(wrappers, before)]
        n_apply = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
        # remat full: the forward again in the backward, once per application
        want = [(2 if cfg.remat == "full" else 1) * n_apply, n_apply, n_apply]
        want = want if cuda else [0, 0, 0]
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        finite = all(bool(torch.isfinite(p).all()) for p in state["params"].parameters())
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
        say(f"phase 11 train {label} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}, "
            f"remat {cfg.remat}, {batch} x {seq} tokens): one step {dt:.3f} s, loss {loss:.6f} "
            f"(ln V = {math.log(cfg.vocab):.4f}), grad norm {gnorm:.6f}, peak memory {peak:.2f} GB; "
            f"flash forward / dQ / dK-dV launches {counts} (remat predicts {want})")
        check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0 and finite,
              f"train {label}: loss {loss}, grad norm {gnorm}, parameters finite {finite}")
        check(counts == want, f"train {label}: flash launches {counts} != {want}")
        for w, n in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"), counts):
            results[w]["launches"] += n
        del state, data
        if catch:
            check(len(fwd_calls) == len(bwd_calls) == 1,
                  f"train {label}: no flash forward or backward caught in the step")
            if cuda:
                torch.cuda.empty_cache()
            if fwd_calls:
                check_caught_flash(results, label, fwd_calls[0], device, phase="phase 11",
                                   gate="kernel check", part="train")
            if bwd_calls:
                check_caught_bwd(results, f"{label}_train", bwd_calls[0], device)
        del fwd_calls, bwd_calls
        if cuda:
            torch.cuda.empty_cache()


def phase_recurrent(corpus_bundle, index, results: dict, device: str = "cuda") -> None:
    """Phase 11: rwkv6-7b and zamba2-1.2b whole at full width, random
    weights from a seed, each through RagPipeline over phase 4's index at
    phase 6's batch, with gates (a)-(d); then one training step of zamba2 at
    full width and one of each recurrent smoke config. Every gate's reading
    is printed; the phase fails at its end if any gate did. (``device`` lets
    the phase be rehearsed on the CPU, with smaller configs patched in.)"""
    import torch

    from repro_torch.configs import get_config

    t = time.perf_counter()
    fails: list = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            fails.append(msg)
            say(f"phase 11 FAILED: {msg}")

    vocab = min(get_config(name).vocab for name in ("rwkv6-7b", "zamba2-1.2b"))
    gen = torch.Generator(device=device).manual_seed(2)
    doc_tokens = torch.randint(0, vocab, (corpus_bundle.docs.n, RAG_CTX), generator=gen,
                               device=device, dtype=torch.int32)
    for name in ("rwkv6-7b", "zamba2-1.2b"):
        serve_recurrent(name, corpus_bundle, index, doc_tokens, results, check, device)
    del doc_tokens
    train_recurrent(results, check, device)
    say(f"phase 11: {time.perf_counter() - t:.1f} s")
    need(not fails, f"phase 11: {len(fails)} gate(s) failed: {fails}")


# ---------------------------------------------------------------------------
# phase 12: the vlm and audio families (cross-attention) at full width
# ---------------------------------------------------------------------------


def call_kind(fn):
    """A ``first_calls`` key for flash calls: (causal, L, S) of the call's
    q, k and causal flag, bound as ``fn`` takes them."""
    sig = inspect.signature(fn)

    def key(args, kwargs):
        a = sig.bind(*args, **kwargs)
        a.apply_defaults()
        return bool(a.arguments["causal"]), a.arguments["q"].shape[2], a.arguments["k"].shape[2]

    return key


def attn_kind(key) -> str:
    """The attention a flash call of (causal, L, S) serves: causal self-
    attention, cross-attention (L != S), or whisper's encoder."""
    causal, l, s = key
    return "self" if causal else ("cross" if l != s else "encoder")


@contextlib.contextmanager
def timed_calls(module, name: str, sync):
    """Seconds of each call of ``module.name`` inside the block, the device
    synchronised before and after it."""
    sound, spent = getattr(module, name), []

    def run(*args, **kwargs):
        sync()
        t = time.perf_counter()
        out = sound(*args, **kwargs)
        sync()
        spent.append(time.perf_counter() - t)
        return out

    setattr(module, name, run)
    try:
        yield spent
    finally:
        setattr(module, name, sound)


def frontend_readings(cfg, params, out, frontend, l: int):
    """Phase 12's gates (a) and (b) on ``params`` at their dtype, as
    (label, reading, limit, kind) with kind "sound", "planted" (must read
    above the limit) or "info" (printed), and whether decode left the cross
    cache as the prefill wrote it. (a): a flash prefill of GATE_ROWS rows
    in which every attention call also runs through naive attention and,
    if it is a cross-attention call, through two planted faults (the call
    made causal; its last FRONTEND_DROP keys dropped) on the same input: max
    |difference| / max |naive output| over the calls of each kind. (b): a
    prefill of FRONTEND_ROWS rows and FRONTEND_STEPS teacher-forced decode
    steps against one forward over the same tokens: the logits, and each
    cross-attention output of each step against the forward's at that
    position, max |difference| / max |forward's| over the layers; planted:
    decode's cross-attention reads the next layer's cross cache."""
    import dataclasses

    import torch

    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm

    lim = FRONTEND_GAP[str(params.embed.tok.dtype).removeprefix("torch.")]
    gap = lambda a, b: float((a.float() - b.float()).abs().max())
    naive_cfg = dataclasses.replace(cfg, attn_impl="naive")
    max_len = l + FRONTEND_STEPS
    sound_apply, sound_flash, sound_dec = (attention.apply_attention, attention._flash,
                                           attention.apply_cross_attention_decode)
    r = []

    # ---- gate (a): every attention call, flash against naive --------------
    faults = (("made causal", lambda q, k, v, scale=None, causal=True:
               sound_flash(q, k, v, scale, True)),
              (f"last {FRONTEND_DROP} keys dropped", lambda q, k, v, scale=None, causal=True:
               sound_flash(q, k[:, :-FRONTEND_DROP], v[:, :-FRONTEND_DROP], scale, causal)))
    gaps = collections.defaultdict(float)

    def both(p, cfg_, x, positions, *, causal=True, kv_src=None):
        y, c = sound_apply(p, cfg_, x, positions, causal=causal, kv_src=kv_src)
        want = sound_apply(p, naive_cfg, x, positions, causal=causal, kv_src=kv_src)[0]
        scale = float(want.float().abs().max())
        kind = "cross" if kv_src is not None else ("self" if causal else "encoder")
        gaps[kind] = max(gaps[kind], gap(y, want) / scale)
        for label, fault in faults if kv_src is not None else ():
            attention._flash = fault
            try:
                bad = sound_apply(p, cfg_, x, positions, causal=causal, kv_src=kv_src)[0]
            finally:
                attention._flash = sound_flash
            gaps[label] = max(gaps[label], gap(bad, want) / scale)
        return y, c

    rows, fe = out[:GATE_ROWS, :l], frontend[:GATE_ROWS]
    attention.apply_attention = both
    try:
        flash = tfm.make_prefill(cfg, max_len)(params, rows, fe)[0]
    finally:
        attention.apply_attention = sound_apply
    for kind in ("encoder", "self", "cross"):
        if kind in gaps:
            r.append((f"(a) {kind}-attention calls, flash vs naive", gaps[kind], lim, "sound"))
    for label, _ in faults:
        r.append((f"(a) planted: cross {label}", gaps[label], lim, "planted"))
    naive = tfm.make_prefill(naive_cfg, max_len)(params, rows, fe)[0]
    r.append(("(a) prefill logits, flash vs naive", gap(flash, naive), None, "info"))
    del flash, naive

    # ---- gate (b): prefill + decode against one teacher-forced forward ----
    toks, fe = out[:FRONTEND_ROWS, :max_len], frontend[:FRONTEND_ROWS]
    fwd_cross = []

    def record(p, cfg_, x, positions, *, causal=True, kv_src=None):
        y, c = sound_apply(p, cfg_, x, positions, causal=causal, kv_src=kv_src)
        if kv_src is not None:
            fwd_cross.append(y[:, l:])
        return y, c

    attention.apply_attention = record
    try:
        with torch.inference_mode():
            want = tfm.make_forward(cfg)(params, toks, fe)[0][:, l - 1:]
    finally:
        attention.apply_attention = sound_apply
    n = len(fwd_cross)
    decode = tfm.make_decode_step(cfg)

    def prefill_decode(plant: bool):
        logits, cache = tfm.make_prefill(cfg, max_len)(params, toks[:, :l], fe)
        before = {k: (t.data_ptr(), t.clone()) for k, t in cache["cross"].items()}
        dec_cross = []

        def dec(p, cfg_, x, ctx):
            if plant:  # the next layer's (or group's) cross cache
                ctx = {k: t[(len(dec_cross) + 1) % n] for k, t in cache["cross"].items()}
            dec_cross.append(sound_dec(p, cfg_, x, ctx))
            return dec_cross[-1]

        got = [logits]
        attention.apply_cross_attention_decode = dec
        try:
            for i in range(FRONTEND_STEPS):
                logits, cache = decode(params, toks[:, l + i], cache, l + i)
                got.append(logits)
        finally:
            attention.apply_cross_attention_decode = sound_dec
        kept = all(cache["cross"][k].data_ptr() == ptr and torch.equal(cache["cross"][k], t)
                   for k, (ptr, t) in before.items())
        worst = 0.0
        for g, ref in enumerate(fwd_cross):
            ys = torch.cat([dec_cross[i * n + g] for i in range(FRONTEND_STEPS)], dim=1)
            worst = max(worst, gap(ys, ref) / float(ref.float().abs().max()))
        return gap(torch.stack(got, dim=1), want), worst, kept

    logit_gap, cross_gap, kept = prefill_decode(False)
    bad_logits, bad_cross, _ = prefill_decode(True)
    r += [("(b) logits, prefill + decode vs forward", logit_gap, DECODE_GAP, "sound"),
          ("(b) cross-attention outputs, decode vs forward", cross_gap, lim, "sound"),
          ("(b) planted: next layer's cross cache, cross outputs", bad_cross, lim, "planted"),
          ("(b) planted: next layer's cross cache, logits", bad_logits, None, "info")]
    del want, fwd_cross
    return r, kept


def serve_frontend(name: str, results: dict, check, device: str = "cuda") -> None:
    """One vlm or audio config at full width (the vlm cut to VLM_GROUPS
    groups), random weights and stub frontend from a seed, served through
    ``ServingEngine.generate(..., frontend=)``: encoder, prefill and decode
    seconds, the cross cache's bytes, peak memory, flash launches; gate
    (c), the cross cache's bytes against its shapes; (d), the first flash
    call of each kind in the prefill against the plain version; then (a)
    and (b) (``frontend_readings``), held in bf16 for the vlm and on fp32
    copies of the weights for whisper, its bf16 readings printed."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tfm
    from repro_torch.obs.tracer import TraceContext
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    t_model = time.perf_counter()
    whole = get_config(name)
    cfg = dataclasses.replace(whole, attn_impl="flash")
    vlm = cfg.family == "vlm"
    if vlm:
        cfg = dataclasses.replace(cfg, n_layers=VLM_GROUPS * cfg.cross_attn_every)
        requests, l, steps = DENSE_ROWS, RAG_TOP_K * RAG_CTX + RAG_PROMPT, DENSE_STEPS + 1
        n_cross = VLM_GROUPS
        n_flash = cfg.n_layers
    else:
        requests, l, steps = WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_GEN
        n_cross = cfg.n_layers
        n_flash = cfg.encoder_layers + 2 * cfg.n_layers
    t_len = cfg.n_frontend_tokens
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(0)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = tfm.init_params(cfg, gen, device)
    sync()
    n_params = sum(p.numel() for p in params.parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    say(f"phase 12 {name}: "
        + (f"{VLM_GROUPS} of {whole.n_layers // whole.cross_attn_every} groups "
           f"({cfg.n_layers - n_cross} self + {n_cross} cross-attention layers)" if vlm else
           f"{cfg.encoder_layers} encoder + {cfg.n_layers} decoder layers")
        + f", d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {t_len} frontend tokens, "
        f"{cfg.dtype}: {n_params} parameters in the tree, {p_bytes / 1e9:.2f} GB (config n_params "
        f"{cfg.n_params}" + (f", the whole model's {whole.n_params}" if vlm else "")
        + f"), drawn in {time.perf_counter() - t:.1f} s")

    dt = params.embed.tok.dtype
    engine = ServingEngine(cfg, params, ServeConfig(max_len=l + steps))
    prompts = torch.randint(0, cfg.vocab, (requests, l), generator=gen, device=device,
                            dtype=torch.int32)
    frontend = (torch.randn((requests, t_len, cfg.d_model), generator=gen, device=device)
                * FRONTEND_SCALE).to(dt)
    engine.generate(prompts[:2], 2, frontend=frontend[:2])  # warm-up: library handles, allocator

    # ---- the main path: counts zeroed just before, read just after --------
    # the served prefill's cross cache: its bytes, and those of a planted
    # cache that also kept the frames, measured the same way
    measured = []
    sound_prefill = engine._prefill
    cross_bytes_of = lambda cache: sum(t.numel() * t.element_size()
                                       for t in cache["cross"].values())

    def prefill(params_, tokens, frames):
        logits, cache = sound_prefill(params_, tokens, frames)
        planted = dict(cache, cross=dict(cache["cross"], frames=frames))
        measured.append((cross_bytes_of(cache), cross_bytes_of(planted)))
        return logits, cache

    engine._prefill = prefill
    fa.flash_attention_fwd.launches = 0
    trace = TraceContext(name)
    with (first_calls(fa, "flash_attention_fwd", call_kind(fa.flash_attention_fwd)) as caught,
          timed_calls(tfm, "_encode_audio", sync) as encoder_s):
        sync()
        t0 = time.perf_counter()
        out = engine.generate(prompts, steps, frontend=frontend, trace=trace)
        sync()
        e2e = time.perf_counter() - t0
    engine._prefill = sound_prefill
    launches = fa.flash_attention_fwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    span = lambda s: trace.find(s)[0]
    prefill_s = span("prefill").t1 - span("prefill").t0
    decode_s = span("decode").t1 - span("decode").t0
    spec = tfm.cache_shape(cfg, requests, l + steps)["self"]
    self_bytes = sum(math.prod(s.shape) * s.dtype.itemsize for s in spec.values())
    want_bytes = 2 * n_cross * requests * t_len * cfg.n_kv_heads * cfg.head_dim * dt.itemsize
    cross_bytes, planted_bytes = measured[0]
    say(f"phase 12 {name} {requests} requests, prompt {l}, {t_len} frontend tokens each, "
        f"{steps} tokens greedy: "
        + (f"encoder {encoder_s[0]:.3f} s of " if encoder_s else "")
        + f"prefill {prefill_s:.3f} s ({requests * l / prefill_s:.1f} prompt tokens/s), decode "
        f"{decode_s:.3f} s ({requests * (steps - 1) / decode_s:.1f} tokens/s over {steps - 1} "
        f"steps), end to end {e2e:.3f} s; cross cache {cross_bytes / 1e9:.4f} GB "
        f"({cross_bytes / n_cross / 1e6:.1f} MB a cross layer), self cache "
        f"{self_bytes / 1e9:.4f} GB at max_len {l + steps}; parameters {p_bytes / 1e9:.2f} GB, "
        f"peak memory {peak_gb:.2f} GB; flash launches {launches} ({n_flash} attention layers)")
    check(launches == (n_flash if cuda else 0),
          f"{name}: {launches} flash launches in the prefill, not {n_flash}")
    results["flash_attention_fwd"]["launches"] += launches
    check(tuple(out.shape) == (requests, l + steps), f"{name}: output shape {tuple(out.shape)}")
    check(torch.equal(out[:, :l], prompts), f"{name}: the output does not start with its prompt")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), f"{name}: tokens out of range")

    # ---- gate (c): the cross cache's bytes against its shapes --------------
    # planted, a check of the measurement: it must see a cache's extra leaf
    say(f"phase 12 {name} gate (c) cross cache bytes: measured {cross_bytes}, from the shapes "
        f"2 x {n_cross} layers x {requests} x {t_len} x {cfg.n_kv_heads} x {cfg.head_dim} x "
        f"{dt.itemsize} B = {want_bytes}; planted fault the frames kept too {planted_bytes}")
    check(cross_bytes == want_bytes, f"{name} gate (c): cross cache {cross_bytes} B, the shapes "
          f"give {want_bytes}")
    check(planted_bytes != want_bytes, f"{name} gate (c): planted fault passes")

    # ---- gate (d): the first flash call of each kind, held and timed ------
    kinds = sorted(attn_kind(k) for k in caught)
    check(len(caught) == (2 if vlm else 3), f"{name}: flash calls caught in the prefill: {kinds}")
    for key, call in caught.items():
        check_caught_flash(results, f"{name} {attn_kind(key)}", call, device, phase="phase 12")
    del caught
    if cuda:
        torch.cuda.empty_cache()

    # ---- gates (a) and (b) --------------------------------------------------
    readings = [("bf16", *frontend_readings(cfg, params, out, frontend, l))]
    if not vlm:  # held on fp32 copies of the weights, the bf16 readings printed
        del engine
        params.float()  # in place
        if cuda:
            torch.cuda.empty_cache()
        readings.append(("fp32", *frontend_readings(
            dataclasses.replace(cfg, dtype="float32"), params, out, frontend.float(), l)))
    for dtype, rs, kept in readings:
        gated = lambda kind, dtype=dtype: kind != "info" and (vlm or dtype == "fp32")
        say(f"phase 12 {name} gates (a)-(b) in {dtype}: " + "; ".join(
            f"{label} {v:.4g}" + (f" (limit {lim})" if gated(kind) else " (printed)")
            for label, v, lim, kind in rs) + f"; decode left the cross cache as the prefill "
            f"wrote it: {kept}")
        check(kept, f"{name} {dtype}: decode wrote the cross cache")
        for label, v, lim, kind in rs:
            if gated(kind):
                ok = v > lim if kind == "planted" else v <= lim
                check(ok, f"{name} {dtype} {label}: {v:.4g} "
                      f"{'<=' if kind == 'planted' else '>'} {lim}")
    del params, out, frontend
    if cuda:
        torch.cuda.empty_cache()
    say(f"phase 12 {name}: {time.perf_counter() - t_model:.1f} s")


def train_frontend(results: dict, check, device: str = "cuda") -> None:
    """One training step of whisper-large-v3 at full width and depth (bf16,
    flash, remat full, AdamW with fp32 moments) on WHISPER_TRAIN decoder
    tokens over its 1,500 frames, and one of each vlm / audio smoke config,
    with their flash launches against what remat predicts (remat full runs
    each attention's forward twice). The full-width step's first flash
    backward of each kind (encoder, decoder self, cross) is caught on the
    path and held against the plain version (``check_caught_bwd``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_state, make_train_step

    cuda = device == "cuda"
    runs = (("whisper-large-v3", dataclasses.replace(get_config("whisper-large-v3"),
                                                     remat="full"), WHISPER_TRAIN, True),
            ("llama-3.2-vision-90b smoke", get_smoke_config("llama-3.2-vision-90b"), (8, 128),
             False),
            ("whisper-large-v3 smoke", get_smoke_config("whisper-large-v3"), (8, 128), False))
    for label, cfg, (batch, seq), catch in runs:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
        tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=1, total_steps=10))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        state = make_train_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0),
                                 device)
        data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0,
                                        frontend_tokens=cfg.n_frontend_tokens,
                                        d_model=cfg.d_model), device=device).batch(0)
        wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
        before = [w.launches for w in wrappers]
        step = make_train_step(cfg, tcfg)
        with first_calls(fa, "flash_attention_bwd", call_kind(fa.flash_attention_bwd),
                         keep=True) as bwd_calls:
            t = time.perf_counter()
            state, metrics = step(state, data)
            if cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t
        counts = [w.launches - b for w, b in zip(wrappers, before)]
        n_attn = (cfg.n_layers if cfg.family == "vlm"
                  else cfg.encoder_layers + 2 * cfg.n_layers)
        want = [(2 if cfg.remat == "full" else 1) * n_attn, n_attn, n_attn] if cuda else [0] * 3
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        finite = all(bool(torch.isfinite(p).all()) for p in state["params"].parameters())
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
        again = ""
        if catch:  # the first step carries the process's first use of these shapes
            t = time.perf_counter()
            step(state, data)
            if cuda:
                torch.cuda.synchronize()
            again = f" (a second step {time.perf_counter() - t:.3f} s)"
        say(f"phase 12 train {label} ({cfg.n_layers} layers"
            + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
            + f", d_model {cfg.d_model}, {cfg.dtype}, remat {cfg.remat}, {batch} x {seq} tokens "
            f"over {cfg.n_frontend_tokens} frontend tokens): one step {dt:.3f} s{again}, loss "
            f"{loss:.6f} (ln V = {math.log(cfg.vocab):.4f}), grad norm {gnorm:.6f}, peak memory "
            f"{peak:.2f} GB; flash forward / dQ / dK-dV launches {counts} (remat predicts "
            f"{want})")
        check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0 and finite,
              f"train {label}: loss {loss}, grad norm {gnorm}, parameters finite {finite}")
        check(counts == want, f"train {label}: flash launches {counts} != {want}")
        for w, n in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"), counts):
            results[w]["launches"] += n
        del state, data
        if catch:
            kinds = sorted(attn_kind(k) for k in bwd_calls)
            check(kinds == ["cross", "encoder", "self"],
                  f"train {label}: flash backward calls caught: {kinds}")
            if cuda:
                torch.cuda.empty_cache()
            for key, call in bwd_calls.items():
                check_caught_bwd(results, f"{label} {attn_kind(key)}_train", call, device,
                                 phase="phase 12")
        del bwd_calls
        if cuda:
            torch.cuda.empty_cache()


def phase_frontend(results: dict, device: str = "cuda") -> None:
    """Phase 12: llama-3.2-vision-90b (VLM_GROUPS of its groups) and
    whisper-large-v3 (whole) at full width, random weights and stub
    frontends from a seed, served through the engine with gates (a)-(d);
    then one training step of whisper at full width and one of each vlm /
    audio smoke config. Every gate's reading is printed; the phase fails at
    its end if any gate did. (``device`` lets the phase be rehearsed on the
    CPU, with smaller configs patched in.)"""
    t = time.perf_counter()
    fails: list = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            fails.append(msg)
            say(f"phase 12 FAILED: {msg}")

    for name in ("llama-3.2-vision-90b", "whisper-large-v3"):
        serve_frontend(name, results, check, device)
    train_frontend(results, check, device)
    say(f"phase 12: {time.perf_counter() - t:.1f} s")
    need(not fails, f"phase 12: {len(fails)} gate(s) failed: {fails}")


def bwd_work(q, k, v, causal: bool, kernel: str) -> tuple[float, float, float]:
    """(bytes, flops, peak rate) of one backward kernel: q, k, v, dO, LSE and
    Delta read once, the gradients it writes written once; 2 flop per
    multiply-add of the products over the (row, col) pairs the mask keeps:
    dQ runs QK^T, dO V^T and dS K (3 products at d = 64); dK/dV runs those
    first two, P^T dO and dS^T Q (4)."""
    import torch

    b, h, l, dk = q.shape
    s, dv = k.shape[2], v.shape[3]
    pairs = sum(min(r + 1, s) for r in range(l)) if causal else l * s
    esz = q.element_size()
    ins = (q.numel() + k.numel() + v.numel() + b * h * l * dv) * esz + 2 * b * h * l * 4
    if kernel == "dq":
        outs, width = q.numel() * esz, 2 * dk + dv
    else:
        outs, width = (k.numel() + v.numel()) * esz, 2 * dk + 2 * dv
    flops = 2.0 * b * h * pairs * width
    return ins + outs, flops, BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S


def phase_flash_bwd(cfg, results: dict):
    """The two backward kernels against the plain version on the card: at
    the training shape (bf16 through the tensor-core kernels, timed beside
    the plain version, the SDPA backward and the fp32 CUDA-core route on 2
    rows; repeated launches bit-identical; fp32 on 2 rows) and at edge shapes
    in fp32 and bf16."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import (
        _delta,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(14)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        results.setdefault(name, {"max_abs_err": 0.0, "checks": []})

    def inputs(b, h, kv, l, s, dk, dv, dtype):
        """q, k, v in the model's (B, L, H, d) memory and dO in memory of its
        own (L, B, H, dv), as (B, H, L, d) views; out and LSE from the
        forward kernel."""
        mk = lambda n, heads, d: torch.randn((b, n, heads, d), generator=gen, device="cuda",
                                             dtype=torch.float32).to(dtype).transpose(1, 2)
        q, k, v = mk(l, h, dk), mk(s, kv, dk), mk(s, kv, dv)
        do = torch.randn((l, b, h, dv), generator=gen, device="cuda").to(dtype).permute(1, 2, 0, 3)
        return q, k, v, do

    def check(label, q, k, v, do, causal, rows=None):
        """Both kernels vs the plain version on ``rows`` batch rows (all by
        default). Returns, per kernel, (max |err|, max |err| / (atol + rtol
        |w|)), the second at most 1."""
        atol, rtol = GRAD_TOL[str(q.dtype).removeprefix("torch.")]
        out, lse = flash_attention_fwd(q, k, v, causal)
        delta = _delta(out, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
        sl = slice(None) if rows is None else slice(0, rows)
        want = flash_attention_bwd_plain(q[sl], k[sl], v[sl], out[sl], lse[sl], do[sl], causal,
                                         q.shape[-1] ** -0.5)
        torch.cuda.synchronize()
        worst = {}
        for name, got, w in (("flash_attention_bwd_dq", dq[sl], want[0]),
                             ("flash_attention_bwd_dkv", dk[sl], want[1]),
                             ("flash_attention_bwd_dkv", dv[sl], want[2])):
            got, w = got.float(), w.float()
            need(bool(torch.isfinite(got).all()), f"flash bwd {label}: non-finite {name}")
            diff = (got - w).abs()
            reading = float((diff / (atol + rtol * w.abs())).max())
            need(reading <= 1, f"flash bwd {label} {name}: error {float(diff.max()):.3g}, "
                 f"{reading:.3g} of its limit {atol:.3g} + {rtol:.3g} |w|")
            err, rd = worst.get(name, (0.0, 0.0))
            worst[name] = (max(err, float(diff.max())), max(rd, reading))
        for name, (err, _) in worst.items():
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        return worst

    def say_check(label, dtype, worst):
        atol, rtol = GRAD_TOL[str(dtype).removeprefix("torch.")]
        say(f"phase 7 flash bwd {label} {str(dtype)[6:]}: " + ", ".join(
            f"{n.removeprefix('flash_attention_bwd_')} max_abs_err {e:.3g} reading {r:.3g}"
            for n, (e, r) in worst.items()) + f" (of the limit {atol:.3g} + {rtol:.3g} |w|)")

    edges = [
        # label, (B, H, KV, L, S, dk, dv), causal
        ("tail L=S=333 g=4", (2, 8, 2, 333, 333, 64, 64), True),
        ("L=S=1", (4, 8, 2, 1, 1, 64, 64), True),
        ("non-causal L=100 S=300 g=1", (2, 4, 4, 100, 300, 64, 64), False),
        ("g=1 L=S=200", (2, 4, 4, 200, 200, 64, 64), True),
        ("dk=192 dv=128 L=S=130", (2, 4, 1, 130, 130, 192, 128), True),
        # bf16 rows of 40 bytes: 8-byte copies, columns padded to 32
        ("dk=dv=20 L=S=70", (2, 4, 2, 70, 70, 20, 20), True),
        ("dk=dv=128 L=S=130", (2, 4, 2, 130, 130, 128, 128), True),
        ("non-causal L=136 S=200 g=8 d=128", (2, 16, 2, 136, 200, 128, 128), False),
        ("non-causal L=S=333 d=64", (2, 4, 4, 333, 333, 64, 64), False),
    ]
    for label, shape, causal in edges:
        for dtype in (torch.float32, torch.bfloat16):
            say_check(label, dtype, check(label, *inputs(*shape, dtype), causal))

    # the training shape: every layer of a training step launches both kernels
    b, h, kv, d, l = TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, TRAIN_SEQ
    q, k, v, do = inputs(b, h, kv, l, l, d, d, torch.bfloat16)
    # first the forward there: every layer of a step runs it twice (remat)
    err = check_flash_fwd(results, "train", q, k, v, True, rows=2)
    fwd_ms = time_ms(lambda: flash_attention_fwd(q, k, v, True), 10)
    fwd_plain_ms = time_ms(lambda: [flash_attention_plain(
        q[i:i + 2], k[i:i + 2], v[i:i + 2], True, d**-0.5) for i in range(0, b, 2)], 2, warm=1)
    sdpa_fwd = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    need(bool(torch.isfinite(sdpa_fwd()).all()), "SDPA: non-finite output")
    sdpa_fwd_ms = time_ms(sdpa_fwd, 10)
    nbytes, flops, rate = flash_work(q, k, v, True)
    b_ms, b_by = bound(nbytes, flops, rate)
    shape = f"train B={b} H={h} KV={kv} L=S={l} d={d} causal bf16"
    results["flash_attention_fwd"]["checks"].append(dict(
        shape=shape, ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=sdpa_fwd_ms))
    say(f"phase 7 flash_attention_fwd {shape}: max_abs_err (2 rows) {err:.3g} ms {fwd_ms:.4f} "
        f"plain_ms (2-row calls) {fwd_plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}: "
        f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP; {flops / fwd_ms / 1e9:.1f} TFLOP/s) "
        f"sdpa_ms {sdpa_fwd_ms:.4f}")
    worst = check("train", q, k, v, do, True, rows=2)
    say_check(f"train B={b} (2 rows checked)", torch.bfloat16, worst)
    out, lse = flash_attention_fwd(q, k, v, True)
    delta = _delta(out, do)
    # no atomics: a second launch gives the same bits
    first = (flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
             *flash_attention_bwd_dkv(q, k, v, do, lse, delta, True))
    again = (flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
             *flash_attention_bwd_dkv(q, k, v, do, lse, delta, True))
    same = [bool(torch.equal(a, b_)) for a, b_ in zip(first, again)]
    need(all(same), f"flash bwd: repeated bf16 launches differ (dq, dk, dv equal: {same})")
    say("phase 7 flash bwd train bf16: two launches give bit-identical dq, dk and dv")
    del first, again
    times = {"flash_attention_bwd_dq": time_ms(
        lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, True), 5),
        "flash_attention_bwd_dkv": time_ms(
        lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, True), 5)}
    plain_ms = time_ms(lambda: [flash_attention_bwd_plain(
        q[i:i + 2], k[i:i + 2], v[i:i + 2], out[i:i + 2], lse[i:i + 2], do[i:i + 2], True,
        d**-0.5) for i in range(0, b, 2)], 2, warm=1)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    lib_grads = torch.autograd.grad(lib_out, (qs, ks, vs), do, retain_graph=True)
    need(all(bool(torch.isfinite(g).all()) for g in lib_grads), "SDPA backward: non-finite")
    library_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                                     retain_graph=True), 5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(lib_out, (qs, ks, vs), do, retain_graph=True)
        torch.cuda.synchronize()
    sdpa_kernels = sorted(cuda_kernels(prof).items(), key=lambda kv_: -kv_[1][1])
    say("phase 7 sdpa backward kernels (name: launches, ms): " + "; ".join(
        f"{n[:120]}: {c}, {ms:.4f}" for n, (c, ms) in sdpa_kernels))
    shape = f"train B={b} H={h} KV={kv} L=S={l} d={d} causal bf16"
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        nbytes, flops, rate = bwd_work(q, k, v, True, name.removeprefix("flash_attention_bwd_"))
        b_ms, b_by = bound(nbytes, flops, rate)
        results[name]["checks"].append(dict(
            shape=shape, ms=times[name], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms))
        say(f"phase 7 {name} {shape}: ms {times[name]:.4f} bound_ms {b_ms:.4f} ({b_by}: "
            f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP; {flops / times[name] / 1e9:.1f} "
            f"TFLOP/s) plain_ms (dQ, dK and dV in 2-row calls) {plain_ms:.4f} sdpa_bwd_ms "
            f"(dQ, dK and dV) {library_ms:.4f}")
    say(f"phase 7 flash bwd train bf16 pair: {sum(times.values()):.4f} ms (dQ + dK/dV) against "
        f"sdpa_bwd_ms {library_ms:.4f}")
    del q, k, v, do, out, lse, delta, qs, ks, vs, lib_out, lib_grads
    torch.cuda.empty_cache()
    # the same shape in fp32 on 2 rows, where 2e-4 leaves a wrong tile loop,
    # causal skip, stride or head sum no room; then the fp32 (CUDA-core)
    # route's time there
    q, k, v, do = inputs(2, h, kv, l, l, d, d, torch.float32)
    say_check("train B=2 fp32", torch.float32, check("train fp32", q, k, v, do, True))
    out, lse = flash_attention_fwd(q, k, v, True)
    delta = _delta(out, do)
    for name, fn in (("flash_attention_bwd_dq", flash_attention_bwd_dq),
                     ("flash_attention_bwd_dkv", flash_attention_bwd_dkv)):
        nbytes, flops, rate = bwd_work(q, k, v, True, name.removeprefix("flash_attention_bwd_"))
        b_ms, b_by = bound(nbytes, flops, rate)
        ms = time_ms(lambda: fn(q, k, v, do, lse, delta, True), 3)
        say(f"phase 7 {name} train B=2 H={h} KV={kv} L=S={l} d={d} causal fp32 (CUDA-core "
            f"route): ms {ms:.4f} bound_ms {b_ms:.4f} ({b_by}; {flops / ms / 1e9:.1f} TFLOP/s); "
            f"bf16 tensor-core route at B={b} {times[name]:.4f} ms, sdpa_bwd_ms {library_ms:.4f}")
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()


def planted_bwd(kind: str):
    """A stand-in for ``flash_attention_bwd`` that still runs the kernels.
    Faults: dK/dV summed over only the first query head of each group
    (``first_head``), Delta taken as 0 (``delta``), or the last key tile's
    dS dropped (``last_tile``: dQ without its share, dK zero there). Not a
    fault: Delta from O recomputed in fp32 by the plain forward instead of
    the forward's output in its own dtype (``fp32_delta``), which tells how
    much of the bf16 gradients' drift is O's rounding."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    def bwd(q, k, v, out, lse, dout, causal=True, sm_scale=None):
        delta = fa._delta(out, dout)
        if kind == "delta":
            delta = torch.zeros_like(delta)
        elif kind == "fp32_delta":
            scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
            out32, _ = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal, scale)
            delta = fa._delta(out32, dout)
        dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal, sm_scale)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal, sm_scale)
        if kind == "first_head":
            g = q.shape[1] // k.shape[1]
            dk, dv = fa.flash_attention_bwd_dkv(q[:, ::g], k, v, dout[:, ::g], lse[:, ::g],
                                                delta[:, ::g], causal, sm_scale)
        elif kind == "last_tile":
            s = k.shape[2] - 64
            dq = fa.flash_attention_bwd_dq(q, k[:, :, :s], v[:, :, :s], dout, lse, delta, causal,
                                           sm_scale)
            dk = dk.clone()
            dk[:, :, s:] = 0
        return dq, dk, dv

    return bwd


def loss_grads(cfg, params, tokens):
    """(names, gradients) of ``make_loss_fn(cfg)`` on ``tokens``."""
    import torch

    from repro_torch.models import transformer as tfm

    names, leaves = zip(*params.named_parameters())
    loss = tfm.make_loss_fn(cfg)(params, {"tokens": tokens})
    return names, torch.autograd.grad(loss, leaves)


def rel_gap(names, got, want) -> tuple[float, str]:
    """Max over parameters of |got - want| / |want| (Frobenius norms), and
    that parameter's name."""
    gaps = [float((g.float() - w.float()).norm() / w.float().norm().clamp(min=1e-30))
            for g, w in zip(got, want)]
    i = max(range(len(gaps)), key=gaps.__getitem__)
    return gaps[i], names[i]


def bf16_readings(cfg, params, tokens):
    """``rel_gap`` readings of the bf16 loss gradients: flash against naive,
    and flash, flash with Delta from an fp32 O (``planted_bwd("fp32_delta")``)
    and naive each against naive at fp32 copies of the same parameters.
    Turns ``params`` to float32 in place; returns (readings, parameter
    names, the fp32 naive gradients)."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa

    grads, sound = {}, fa.flash_attention_bwd
    for label, impl, bwd in (("flash", "flash", sound),
                             ("flash with Delta from fp32 O", "flash", planted_bwd("fp32_delta")),
                             ("naive", "naive", sound)):
        fa.flash_attention_bwd = bwd
        try:
            names, grads[label] = loss_grads(dataclasses.replace(cfg, attn_impl=impl), params,
                                             tokens)
        finally:
            fa.flash_attention_bwd = sound
    params.float()
    naive32 = loss_grads(dataclasses.replace(cfg, dtype="float32", attn_impl="naive"), params,
                         tokens)[1]
    readings = {"bf16 flash vs bf16 naive": rel_gap(names, grads["flash"], grads["naive"])}
    readings.update({f"bf16 {k} vs fp32 naive": rel_gap(names, g, naive32)
                     for k, g in grads.items()})
    return readings, names, naive32


def grad_gap(cfg, params, tokens) -> tuple[float, str]:
    """``rel_gap`` of the loss gradients through flash against naive."""
    import dataclasses

    names, flash = loss_grads(dataclasses.replace(cfg, attn_impl="flash"), params, tokens)
    _, naive = loss_grads(dataclasses.replace(cfg, attn_impl="naive"), params, tokens)
    return rel_gap(names, flash, naive)


def phase_train(cfg, results: dict):
    """Training ``cfg`` (llama3.2-1b at full width and depth): one warm-up
    step, then the timed steps of make_train_step; then its gradients
    through flash against naive attention, with planted faults in the
    backward."""
    import dataclasses
    import math

    import torch

    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_state, make_train_step

    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=2, total_steps=10))
    t = time.perf_counter()
    state = make_train_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0), device="cuda")
    batches = [pipe.batch(s) for s in range(1 + TRAIN_TIMED)]
    step_fn = make_train_step(cfg, tcfg, None, None)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    say(f"phase 7 setup: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} {cfg.dtype} "
        f"remat {cfg.remat} attn {cfg.attn_impl}, {n_params} parameters, AdamW fp32 moments; "
        f"{1 + TRAIN_TIMED} batches of {TRAIN_BATCH} x {TRAIN_SEQ} tokens; "
        f"{time.perf_counter() - t:.1f} s")

    # ---- the main path: counts zeroed just before, read after every step ----
    wrappers = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rows, seen = [], {k: 0 for k in wrappers}
    for s, batch in enumerate(batches):
        if s == 0:  # the warm-up step runs under the profiler: which kernels a step runs
            (state, metrics), dt, step_kernels, order, ends = profiled_step(
                lambda: step_fn(state, batch), PROFILE_PAD_S)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        counts = {k: w.launches - seen[k] for k, w in wrappers.items()}
        seen = {k: w.launches for k, w in wrappers.items()}
        row = dict(step=s, seconds=dt, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / dt,
                   loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                   lr=float(metrics["lr"]), launches=counts)
        rows.append(row)
        say(f"phase 7 step {s}{' (warm-up)' if s == 0 else ''}: {dt:.4f} s "
            f"({row['tokens_per_s']:.1f} tokens/s) loss {row['loss']:.6f} grad_norm "
            f"{row['grad_norm']:.6f} lr {row['lr']:.6g} launches {json.dumps(counts)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(r["seconds"] for r in rows[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say(f"phase 7 training: median step {med:.4f} s over {TRAIN_TIMED} timed steps "
        f"({tokens / med:.1f} tokens/s; {6 * n_params * tokens / med / 1e12:.1f} TFLOP/s of "
        f"6 N D), peak memory {peak_gb:.2f} GB")
    want = {"flash_attention_fwd": 2 * cfg.n_layers, "flash_attention_bwd_dq": cfg.n_layers,
            "flash_attention_bwd_dkv": cfg.n_layers}
    for r in rows:
        need(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
             f"step {r['step']}: non-finite loss or grad norm")
        need(r["launches"] == want, f"step {r['step']}: launches {r['launches']} != {want}")
    first, last = rows[0]["loss"], rows[-1]["loss"]
    need(abs(first - math.log(cfg.vocab)) <= 0.5,
         f"first loss {first:.4f} is not within 0.5 of ln({cfg.vocab}) = {math.log(cfg.vocab):.4f}")
    need(last < first, f"the loss did not go down: {first:.4f} -> {last:.4f}")
    # by symbol: bf16 steps launch the tensor-core kernels, never the CUDA-core ones
    want_sym = {"flash_fwd_tc_kernel": 2 * cfg.n_layers, "flash_bwd_tc_dq_kernel": cfg.n_layers,
                "flash_bwd_tc_dkv_kernel": cfg.n_layers, "flash_fwd_kernel": 0,
                "flash_bwd_dq_kernel": 0, "flash_bwd_dkv_kernel": 0}
    by_symbol = {sym: sum(c for n, (c, _) in step_kernels.items() if sym in n)
                 for sym in want_sym}
    # one more step traced without the idle frame, printed beside it: after
    # phase 9 both traces lost the backward's first forward record, so the
    # frame is no cure and the fault stays open (ROADMAP Queue 3)
    (state, _), _, bare_kernels, bare_order, bare_ends = profiled_step(
        lambda: step_fn(state, batches[0]), 0.0)
    bare = {sym: sum(c for n, (c, _) in bare_kernels.items() if sym in n) for sym in want_sym}
    say(f"phase 7 profiled steps: framed by {PROFILE_PAD_S} s of idle card: flash records in "
        f"time order {order}, first and last records {ends}; unframed (printed, not gated): "
        f"{json.dumps(bare)}, in time order {bare_order}, first and last records {bare_ends}")
    say(f"phase 7 profiled warm-up step: kernel launches by symbol {json.dumps(by_symbol)}")
    need(by_symbol == want_sym, f"profiled step: launches by symbol {by_symbol} != {want_sym}")
    say(f"phase 7 checks: losses and grad norms finite; first loss {first:.4f} (ln V = "
        f"{math.log(cfg.vocab):.4f}), last {last:.4f}; every step launched "
        f"{json.dumps(rows[-1]['launches'])}")
    for k in wrappers:
        results.setdefault(k, {"launches": 0})
        results[k]["launches"] = results[k].get("launches", 0) + seen[k]

    # ---- gradients through flash against naive, on 2 rows ------------------
    params = state["params"]
    del state, batches
    torch.cuda.empty_cache()
    tokens2 = pipe.batch(0)["tokens"][:2]
    readings, names, naive32 = bf16_readings(cfg, params, tokens2)  # params now fp32: the gate
    say(f"phase 7 gradients, 2 x {TRAIN_SEQ} tokens, max over parameters of |g - g_ref| / "
        "|g_ref| (printed, not gated): " + "; ".join(f"{k} {g:.4g} ({n})"
                                                      for k, (g, n) in readings.items()))
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gap, where = rel_gap(names, loss_grads(cfg32, params, tokens2)[1], naive32)
    say(f"phase 7 gradients in fp32: flash vs naive {gap:.4g} ({where}; limit {GRAD_GAP})")
    need(gap <= GRAD_GAP, f"flash gradients differ from naive by {gap:.4g}")
    torch.cuda.empty_cache()
    sound = fa.flash_attention_bwd
    try:
        for kind in ("first_head", "delta", "last_tile"):
            fa.flash_attention_bwd = planted_bwd(kind)
            fgap, fwhere = rel_gap(names, loss_grads(cfg32, params, tokens2)[1], naive32)
            say(f"phase 7 planted fault {kind}: flash vs naive in fp32 {fgap:.4g} ({fwhere})")
            need(fgap > GRAD_GAP, f"planted fault {kind} passes the gradient check")
    finally:
        fa.flash_attention_bwd = sound
    del params, naive32
    torch.cuda.empty_cache()


PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13)


def parse_phases(argv) -> set:
    """``--phases 1,4,11``: a partial run, for finding faults (phase 1 always
    runs; 8 and 13 need 5, and 6, 10 and 11 need 4; 12 needs nothing). It
    prints no kernels line and no last line. Without the flag, every phase."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(map(str, PHASES)))
    chosen = {1} | {int(x) for x in ap.parse_args(argv).phases.split(",")}
    if not chosen <= set(PHASES) or (chosen & {8, 13} and 5 not in chosen) or (
            chosen & {6, 10, 11} and 4 not in chosen):
        raise SystemExit(f"chip_smoke: bad --phases {sorted(chosen)}")
    return chosen


def main(argv=None) -> int:
    phases = parse_phases(argv)
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    try:
        from repro_torch.data.corpus import CorpusConfig, make_corpus

        card = phase_device()
        t = time.perf_counter()
        full = make_corpus(CorpusConfig(
            n_docs=N_FULL, n_queries=N_QUERIES, n_topics=1024, d_dense=1024, seed=0))
        torch.cuda.synchronize()
        say(f"phase 4 corpus: {N_FULL} docs x 1024 dense + 32/16 ELL, {N_QUERIES} queries "
            f"in {time.perf_counter() - t:.1f} s")
        # each kernel's readings: launches on the paths, max error, checks by shape
        results: dict = collections.defaultdict(
            lambda: {"launches": 0, "max_abs_err": 0.0, "checks": []})
        if 2 in phases:
            phase_kernels(full.docs, full.queries, results)
            phase_insert_kernels(full.docs, results)
        if 3 in phases:
            phase_small_e2e()
        index = phase_full(full, results) if 4 in phases else None
        torch.cuda.empty_cache()
        if 5 in phases:
            served: dict = {}
            pool_q, int8_recall = phase_serving(full, results, keep=served)
            torch.cuda.empty_cache()
            if 13 in phases:  # phase 5's pools and requests, before phase 8's writes
                phase_mesh(full, served, results, card)
            served.clear()
            torch.cuda.empty_cache()
            if 8 in phases:
                phase_write(full, pool_q, results, int8_recall)
            del pool_q
            torch.cuda.empty_cache()
        if 6 in phases:
            phase_rag(full, index, results)
        if 10 in phases:  # while phase 4's index lives; all of it freed before phase 7
            phase_models(full, index, results)
        if 11 in phases:  # likewise
            phase_recurrent(full, index, results)
        del full, index
        torch.cuda.empty_cache()
        if 12 in phases:  # after phase 4's index is freed; all of it freed before phase 7
            phase_frontend(results)
            torch.cuda.empty_cache()
        from repro_torch.configs import get_config

        if 7 in phases:
            train_cfg = dataclasses.replace(get_config("llama3.2-1b"), attn_impl="flash")
            phase_flash_bwd(train_cfg, results)
            phase_train(train_cfg, results)
            torch.cuda.empty_cache()
        # last, not after phase 8: run before phase 7, phase 9 leaves phase
        # 7's profiled step one flash-forward record short (the first one
        # of the backward) while the wrapper counts all 32 and the step's
        # loss and grad norm equal those of a run with all 32 recorded: a
        # fault of the trace, not yet explained (ROADMAP Queue 3)
        if 9 in phases:
            phase_text(results)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    if phases != set(PHASES):
        say(f"chip_smoke: phases {sorted(phases)} passed (a partial run: no kernels line)")
        return 0

    src = {
        "hybrid_distance": ("src/repro_torch/kernels/csrc/hybrid_distance.cu",
                            "src/repro/kernels/hybrid_distance.py:95", "self_scores"),
        "hybrid_distance_int8": ("src/repro_torch/kernels/csrc/hybrid_distance.cu",
                                 "src/repro/kernels/hybrid_distance.py:38", "serve_rescore"),
        "fused_topk": ("src/repro_torch/kernels/csrc/fused_topk.cu",
                       "src/repro/kernels/fused_topk.py:160", "descent_chunk"),
        "fused_topk_int8": ("src/repro_torch/kernels/csrc/fused_topk.cu",
                            "src/repro/kernels/fused_topk.py:124", "serve_round"),
        "pairwise_tile": ("src/repro_torch/kernels/csrc/pairwise_tile.cu",
                          "src/repro/kernels/pairwise_tile.py:77", "prune_chunk"),
        "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                                "src/repro/kernels/flash_attention.py:107", "rag_prefill"),
        "flash_attention_bwd_dq": ("src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
                                   "src/repro/kernels/flash_attention.py:261", "train"),
        "flash_attention_bwd_dkv": ("src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
                                    "src/repro/kernels/flash_attention.py:294", "train"),
    }
    # the flash kernels' route by dtype; their numbers are the bf16 (main-path) route's
    variants = {
        "flash_attention_fwd": "bf16: tensor cores, wgmma fed by TMA with P split hi/lo "
                               "(flash_attention_tc.cu); fp32: CUDA cores (flash_attention.cu)",
        "flash_attention_bwd_dq": "bf16: tensor cores, mma.sync with P and dS split hi/lo "
                                  "(flash_attention_bwd_tc.cu); fp32: CUDA cores "
                                  "(flash_attention_bwd.cu)"}
    variants["flash_attention_bwd_dkv"] = variants["flash_attention_bwd_dq"]
    kernels = []
    for name, (path, replaces, headline) in src.items():
        r = results[name]
        chk = next(ch for ch in r["checks"] if ch["shape"].startswith(headline))
        kernels.append(dict(
            name=name, route="cuda", source=path, replaces=replaces,
            launches=r["launches"], max_abs_err=r["max_abs_err"], ms=chk["ms"],
            plain_ms=chk["plain_ms"], bound_ms=chk["bound_ms"], bound_by=chk["bound_by"],
            library_ms=chk.get("library_ms"), shape=chk["shape"]))
        if name in variants:
            kernels[-1]["variant"] = variants[name]
        if chk.get("device_ms") is not None:  # host-bound shapes: the kernels' own time
            kernels[-1]["device_ms"] = chk["device_ms"]
        extra = [ch for ch in r["checks"]
                 if ch.get("phase") in ("phase 10", "phase 11", "phase 12")]
        if extra:  # the shapes phases 10-12's models gave the kernel, caught on their paths
            kernels[-1]["checks"] = extra
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)  # name, power limit: as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
