#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spt_proto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card's name and power limit (nvidia-smi), build the CUDA
   kernels from spt_proto_tpu_torch/csrc and print the build time (two
   more processes build at the same time, as the ranks of a world on a
   fresh checkout do, and must load the same library), and
   beside the build compile the tensor-core kernels' sources once more
   with -Xptxas -v to print their registers and spills (the int8_matmul
   wgmma and weight-stream kernels, the FFN-tail streams, the bf16 decode
   front's norm / stream / tail, both split attentions and the bf16
   block-sparse forward and backward must spill nothing);
2. hold each kernel against its plain PyTorch twin on the same CUDA tensors,
   at the serving shapes (OPT-125M, B=8, context 2048) in bf16 and f32, on
   the route its wrapper's rule names (asserted): the decode front (with
   and without int8 KV quantization, with the stacked fp and the packed
   int8 QKV weight; and LLaMA's RMSNorm + RoPE forms: the stack and packed
   int8 at LLaMA-7B width, B=4, and the GQA triple and triple_int8 at
   Llama-3-8B width, B=8; and its edges: B = 1, 3, 9, 16, a slot with no
   full tile, planted equal tile scores, packed int8 at D 640 (K blocks of
   128), a biased GQA triple, one kv head), each beside the cuBLAS product
   of its projection, decode attention over a bf16/f32 cache (dense tables
   at max_len 2176, dense supertiles of 4 at max_len 2048, sparse tables)
   and over an int8 cache (sparse tables, and dense supertiles of 4 through
   one table row; and both at Llama-3-8B's G = 4; and the edges of both:
   -1 entries and entries past n_tiles, the new token at lane 0 and lane
   127, grouped table rows (int8), supertiles of 4 at G = 4, G = 1 and G
   = 8 at d_head 128; for the bf16 cache also G = 1 at d_head 64, a row
   of 400 tiles whose scores go to the global buffer, and the row's max
   in a chunk past the first and in the new token),
   the lm_head argmax (fp, and int8 at OPT-125M and OPT-1.3B widths; both
   at d 4096 over 128,256 and 32,000 tokens; and both at LLaMA-13B's d
   5120 over OPT's ragged 50,272 tokens at B 1, 4, 8, 13 and 40, on
   random inputs and on integer-valued ones whose planted winners and ties
   -- across CTA tiles, warps, lanes and one thread's columns, in the
   ragged last tile, in the last true column against larger int8 pad
   columns -- the ids must match exactly), block-sparse prefill
   attention (d_head 64 and 128, at S=2048 and with off-diagonal and -1
   entries at S=4096, sparse_coeff 4; and its edges: block_q 128 and 256,
   the clamp on and off, -1 entries amid a list and a tile after the q
   tile's rows, the lse form), the fused FFN tail (fp and int8) at
   OPT-125M and OPT-1.3B widths, the gated tails (fp and int8) at LLaMA-7B
   and Llama-3-8B widths, m = 4 and 8, and in bf16 the four tails at m =
   1, 9, 17, 64, 65 and 256 and the int8 forms' padded strides, and the
   int8 matmul at the decode shapes (o and qkv of OPT-125M and OPT-1.3B; o
   and k / v of LLaMA) and two prefill shapes (m = 16,384: fc1 of
   OPT-125M, Llama-3-8B's gate), plus edges (m 63 / 64 / 65 / 130 / 1,000,
   q wider than the scale and off the 128-column tile, K off the k-step,
   and the CUDA-core kernels' cases: K % 8, an unaligned x), each case on
   the kernel its wrapper's rule names (asserted),
   the speculative block verify (OPT-125M and Llama-3-8B, union and
   dense tables at max_len 2304, one block across a tile boundary), the
   paged-attention kernel (OPT-125M and Llama-3-8B's G = 4 at B=8, context
   2041-2048, pages of 64 tokens, fp and int8 pages, a released lane's -1
   table row read through the sink page), the tile-pool decode attention
   (OPT-125M, 96 rows of 17 tiles) and both tile-table decode attention
   kernels over a dense Llama-3-8B table of 96 tiles (12,288 tokens: the
   two-pass walk); the int8_base backward's int8_matmul_t (dx at LLaMA-7B's
   q/o, gate/side and down, m 2,048, and OPT-125M's fc1 / fc2, m 4,096),
   gmm (the eight grouped products a layer of routed_ffn_lora_gmm runs,
   forward and dlhs, at OPT-125M's tune shape: 8,192 sorted rows in 4
   groups, one empty, LoRA rank 16, each on the kernel and tile shape the
   wrapper's rule picks, plus off-path shapes for every tile shape, rows
   past the groups and the CUDA-core kernel) and tgmm (the two LoRA
   factors' gradients, w1's full-width gradient, off-path shapes), and the verify
   kernel at K = 30, G = 4 (120 rows: split across CTAs); the flash-attention
   forward (o, l, m), dq and dk/dv kernels at OPT-125M's training shape
   ([8, 12, 512, 64], f32 and bf16), at S 2048 (bf16), at LLaMA-7B's
   width ([4, 32, 512, 128], f32 and bf16) and at S 128 and 384 at both
   widths (bf16), from the layer's strided q, k, v and do, with each
   kernel's TFLOP/s and the backward pair beside its bound and SDPA's;
   time kernel, twin and the one-call library equivalent where there is
   one (SDPA for flash attention, checked against the twins first; for the
   block-sparse backward, SDPA's dense causal backward over the same rows,
   another function, timed only);
3. slice parity at full width: OPT-125M (random weights from a seed) in f32,
   B=2, prompt 512, 8 greedy steps, on the card through the kernels and on
   the CPU through the plain twins, in six decode modes (sparse int8-KV,
   dense f32-KV, sparse f32-KV, the unfused l1 front over int8 KV, and with
   int8 weights (w8, built staged on the card) sparse int8-KV and dense
   f32-KV), and Llama-3-8B at full width cut to 2 layers and a 32,000-token
   vocabulary in three (sparse int8-KV through the triple front, dense
   f32-KV, and w8 sparse int8-KV through the triple_int8 front and the
   gated int8 tail); the greedy tokens must agree (the w8 modes are held
   stepwise from the twins' state, codes and tables, each decision within
   one bf16 step of theirs); then, for both models, one speculative verify
   block against K sequential decode steps on the card and against the CPU
   twins (the card's PQ codes taken from the twins', CodeTap), and greedy
   generate_speculative (n-gram, and at OPT-125M the model as its own
   draft) against greedy generate() on the card;
4. the serving runs, OPT-125M in bf16, B=8, prompt 2048, max_len 2176, in
   bench.py's three decode modes (dense bf16-KV, sparse bf16-KV, sparse
   int8-KV), sparse int8-KV with the fused FFN tail, and with int8 weights
   (bench_serving.py's int8 mode) sparse int8-KV and dense bf16-KV: prefill
   + 32 greedy steps each, with the kernel launch counters zeroed before
   and read after each run and checked exactly, prefill / decode tokens per
   second from CUDA events (the decode window starts after a sync), and a
   profiled 4-step decode window per mode (after a sync too); a bf16 run
   (here and in phases 5-6) fails if its steps launch decode_front's fused
   kernel, the int8-KV attention's one-pass or int8 walk kernel or the
   bf16-KV attention's one-pass or walk kernel, or its profiled sparse
   prefill the CUDA-core block-sparse forward;
5. bench.py's OPT-1.3B rung: dense bf16-KV vs sparse int8-KV, and sparse
   int8-KV w8 (the round-4 ladder's "sparse w8"), B=8, prompt 2048, max_len
   2176, 32 steps, with tokens per second and peak memory;
6. LLaMA serving at full width, 16 of 32 layers, in bf16, prompt 2048, max_len
   2176, 32 steps, with exact launch counts, decode ms/step, tokens per
   second, prefill ms and peak memory: Llama-3-8B at B=8 dense bf16-KV,
   sparse int8-KV, sparse int8-KV with the fused gated tail and sparse
   int8-KV w8, then LLaMA-7B sparse int8-KV w8 at B=4 (bench_ladder.py's
   llama-7b rung; in both w8 runs the first int8_matmul call on each kernel,
   wgmma in the prefill and the weight stream in the steps, and the first
   gated int8 tail are held against their twins on their own tensors at
   the bf16 bound), each model freed before the next is built; and, while
   Llama-3-8B is loaded, its speculative serving run (as in phase 7) and
   a paged dense bf16-KV serving run through the continuous batching
   engine on phase 8's traffic;
7. speculative serving in bf16, bench_serving.py's workload (a 16-token
   phrase tiled through a 2048-token prompt, B=8, k=4, 64 new tokens,
   max_len 2304): OPT-125M with n-gram drafts over a bf16 KV cache (the
   verify kernel) and over an int8 one (the plain verify path), OPT-1.3B
   with OPT-125M as its draft; each prints acceptance, verify-step and
   decode-step ms, tok/s by bench_serving's formula, its token agreement
   with greedy generate() and its exact launch counts;
8. the serving stack: OPT-125M in bf16 through ContinuousBatchingEngine,
   16 requests over 8 slots, prompts of 128-1920 tokens (numpy seed 3),
   64 new tokens each, max_len 2176, in seven modes: contiguous sparse
   int8-KV; contiguous dense bf16-KV with prefill_chunk 512 and the
   prefix cache (every other request shares a pinned 1,024-token prefix);
   paged dense bf16-KV and int8-KV (pages of 64, the paged-attention
   kernel); paged sparse int8-KV; paged dense with a pool of 60% of the
   need (preemption); contiguous sparse bf16-KV speculative=4. Each prints
   its tokens, wall time, tok/s, engine steps, mean step ms (CUDA events),
   preemptions, prefix hits, acceptance and peak memory, with exact launch
   counts. Then an f32 parity step (6 requests, 3 slots, 16 tokens; each
   engine and the HTTP server against its reference, >= 0.995 of the
   tokens: see serving_parity);
9. SPT fine-tuning (the routed-FFN + LoRA + PQ train step, whose sparse
   attention runs the block-sparse forward with log-sum-exp and the dq and
   dk/dv kernels, which phase 2 holds against their twins at OPT-125M's
   training shape and with off-diagonal and -1 tables at S 2048 and 4096,
   d_head 64 and 128, on the route bwd_route names (asserted: the
   tensor-core pair in bf16), plus block_q 64 (the CUDA-core pair in bf16
   too) and a table that leaves a key tile unselected (its dk / dv exact
   zeros)): f32 parity of 3 train steps on the card against the
   CPU twins, stepwise and free-running, with the kernels checked on the
   steps' own tensors, at OPT-125M width (2 layers, B=2, S=2048,
   sparse_coeff 4) and Llama-3-8B width (1 layer, vocabulary 32,000, B=1,
   S=1024, sparse_coeff 2); then cli.tune.main at OPT-125M full depth, the
   tune defaults (B=8, S=512) in f32 and bf16 and S=2048 in bf16: 2 warm-up
   steps, 8 timed (CUDA events, exact launch counts: 1 lse forward, 1 dq,
   1 dk/dv a layer a step), 2 profiled; step ms, tok/s, peak memory,
   device busy, kernel time in situ and the losses; a profiled bf16 tune
   window (here and in phases 10-11) fails if it shows the CUDA-core
   block-sparse backward (NOT_BF16_TRAIN);
10. int8-base (QLoRA shape) and grouped-matmul training: f32 parity of 3
   train steps on the card against the CPU twins (int8_base at OPT-125M
   width, 2 layers, B=2, S=2048, and LLaMA-7B width, 2 layers, B=1,
   S=1024; ffn_impl='gmm' at OPT-125M width, also against the masked form
   on the card), the int8 and grouped kernels held on the steps' own
   tensors and the plain twins on the card shown to part from the CPU as
   the kernels do; cli.tune.main at LLaMA-7B full depth, bf16, B=4, S=512
   (lr 1e-3, --remat) with and without --int8_base, and at OPT-125M's tune
   defaults with ffn_impl='gmm' (exact launch counts: int8_matmul and
   int8_matmul_t a frozen kernel a layer, twice the forward's under remat;
   gmm 8 and tgmm 2 a layer; every gmm / tgmm call of the gmm run's first
   warm-up step held against its twin at phase 2's bf16 bound, and its
   profile showing only the tensor-core gmm / tgmm kernels; the int8_base
   run's first int8_matmul call, the wgmma kernel, held likewise); step
   ms, tok/s, peak memory, busy, the kernels' time in situ; then w8
   serving of a tuned (routed + LoRA) OPT-125M checkpoint against the CPU
   twins by phase 3's w8 rule;
11. dense and LoRA-stage training and forward (dense causal attention
   through the flash-attention kernels): f32 parity of 3 train steps on the
   card against the CPU twins by phase 9's rules (OPT-125M width, 2 layers,
   B=2, S=2048 at stages lora,ffn,mha_v1 and at lora; Llama-3-8B width, 1
   layer, vocabulary 32,000, B=1, S=1024, GQA, at lora,ffn,mha_v1), with
   step 0 repeated under remat 'full' and 'dots' (gradients equal to the
   no-remat ones, forwards counted twice); tuning.evaluate (f32 parity of
   ppl and answers at 2 layers, then the card alone at full depth, bf16,
   exact launch counts, tok/s); cli.tune.main at OPT-125M full depth, bf16,
   B=8, S=512, stages lora,ffn,mha_v1, with and without --remat (exact
   launch counts: 1 flash forward, 1 dq, 1 dk/dv a layer a step, forwards
   twice under remat, no block-sparse launch); cli.profile.main at S 2048,
   B=8, bf16: dense forward, and the dense, lora and sparse train steps
   (step ms, tok/s, peak memory, exact launch counts);
12. the command line and the data path, OPT-125M at full width (seeded
   random weights saved with the port's save_checkpoint: the dense base
   and its sparse mha_v2 upgrade, bf16 compute): cli.generate.main with
   --ckpt and --prompt_ids (four 512-token prompts, 32 new tokens, greedy)
   plain over int8 KV, --int8, --speculative --spec_k 4 and --continuous
   --prefix_cache, each run's tokens equal to the engine called directly on
   the same card weights and its launches exact; cli.bench_serving.main
   --config opt-125m at its defaults (B 8, prompt 512, max_len 1024, 32
   steps) in the dense, sparse, int8 and paged modes (exact launches) and
   --spec_k 4 (its kernels counted); a synthetic MMLU + FLAN-mini corpus
   (numpy seed) and cli.tune.main --data_root (bf16, B 8, S 512, 1 warm-up
   + 3 steps, exact launches, finite losses, batches equal to the CPU's
   mmlu_flan_mixture); cli.dump_delta.main of its output;
   cli.evaluate.main with and without --spt_ckpt (4 batches of 8 x 512,
   equal to tuning.evaluate on the same weights and batches, exact
   launches); cli.model_info.main --serving and cli.svd_rank.main
   --activations; no transformers (a character tokenizer defined here);
13. tensor- and data-parallel serving (spt_proto_tpu_torch/parallel):
   ranks spawned on this one card over gloo (the device and the backend
   passed explicitly; NCCL needs a GPU a rank, so it is not run here), each
   serving its shard, beside the same calls unsharded in this process:
   OPT-125M at full width and depth on a world of 4 at (data 2, model 2),
   greedy generate() B=8, prompt 512, 16 new tokens, sparse int8-KV and
   dense, in f32 and in bf16 (reported), then the batching engine
   on phase 8's traffic cut to 16 tokens a request (f32): contiguous
   sparse int8-KV, contiguous dense with prefill_chunk 512 and the prefix
   cache, paged dense and speculative=4; Llama-3-8B width (2 layers, vocabulary
   32,000) on a world of 2 at (1, 2), generate() sparse int8-KV in f32
   and with int8 weights, and cli.generate under --mesh_model 2; the f32
   free-running tokens are pooled a world (>= 0.995), and the sparse and
   w8 runs are also held by phase 3's stepwise rule from the unsharded
   reference's state (mesh_stepwise); every rank's launches equal the
   single-rank run's;
   each run prints its world, the transport of each collective, its
   seconds and its ms a step (ranks sharing one card: a parity run, not a
   speed); phase 2 holds the heads' value output (value=True) at OPT-125M,
   Llama width and the shard widths;
14. print the per-kernel JSON line, then the contract line
   {"ok": true, "device": {...}} last.

It needs the rest of the repository beside it and a CUDA device; without
either it exits non-zero before printing any result.
"""
from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# dense bf16 / f32 (no tensor core) / int8 (the int8 KV attention's int8
# inputs); the int8 weight kernels multiply in bf16 and count at bf16's rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
            torch.int8: 1979e12}
SEED = 0
DEV = 'cuda'
L2_FLUSH_BYTES = 128 << 20          # > the 50 MB L2: launches start cold
SPIN_CYCLES = 10_000_000            # ~5 ms at the H100's clock

# serving shapes (bench.py's decode headline, OPT-125M)
B, PROMPT, MAX_LEN, STEPS = 8, 2048, 2176, 32
D, HEADS, LAYERS, VOCAB, FF = 768, 12, 12, 50272, 3072
DH, N_SUB, N_CODE, TILE = 64, 8, 16, 128
NT = -(-MAX_LEN // TILE)                      # 17 tiles per layer
NSEL = min(NT, max(1, NT // 8) + 1)           # sparse_coeff 8 -> 3
D_13B, FF_13B = 2048, 8192                    # OPT-1.3B widths
# (m, K, N) of int8_matmul on the w8 paths: decode (m = B) o and qkv of
# OPT-125M and OPT-1.3B, prefill (m = B x PROMPT) fc1 of OPT-125M; the
# first is the one the kernel line reports (o runs every layer and step).
# LLaMA's are added below its widths.
INT8_MATMUL_SHAPES = {
    'decode o 125m': (B, D, D), 'decode qkv 125m': (B, D, 3 * D),
    'decode o 1.3b': (B, D_13B, D_13B),
    'decode qkv 1.3b': (B, D_13B, 3 * D_13B),
    'prefill fc1 125m': (B * PROMPT, D, FF)}
# LLaMA (llama_config '7b' and '3-8b'): d_model 4096, 32 query heads of
# d_head 128 (16 PQ subspaces, so the code width is 16); d_ff 11008 and
# 14336; Llama-3-8B has 8 kv heads (groups of 4). LLaMA-7B serves at B=4
# (bench_ladder.py's llama-7b rung), Llama-3-8B at B=8.
D_LL, HEADS_LL, DH_LL, N_SUB_LL = 4096, 32, 128, 16
FF_7B, FF_38B, KV_38B, B_7B = 11008, 14336, 8, 4
VOCAB_38B, VOCAB_7B = 128256, 32000
# int8_matmul on LLaMA's w8 paths: per decode step o (Llama-3-8B at B=8,
# LLaMA-7B at B=4); q and k / v where the front is unfused; per prefill
# (m = B x PROMPT) every projection, the widest being the gate and side
INT8_MATMUL_SHAPES.update({
    'decode o llama-3-8b': (B, D_LL, D_LL),
    'decode k/v llama-3-8b': (B, D_LL, KV_38B * DH_LL),
    'decode o llama-7b': (B_7B, D_LL, D_LL),
    'prefill gate llama-3-8b': (B * PROMPT, D_LL, FF_38B)})
# speculative decoding (bench_serving.py's speculative workload): a 16-token
# random phrase tiled through a 2048-token prompt, k = 4 proposals, a verify
# block of K = 5 columns, 64 new tokens, max_len 2304 (18 tiles a layer)
SPEC_K, SPEC_NEW, SPEC_MAX_LEN, SPEC_PERIOD = 4, 64, 2304, 16
KK = SPEC_K + 1
NT_SPEC = SPEC_MAX_LEN // TILE


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def start_ptxas(source: str):
    """nvcc -Xptxas -v on one kernel source (started beside the build)."""
    from spt_proto_tpu_torch import _build
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
         '-Xptxas', '-v', '-c', str(_build.CSRC / source), '-o', os.devnull],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def log_ptxas(proc, pattern: str, no_spills: bool = False) -> list[str]:
    """Wait for start_ptxas' nvcc; log the stack, spill and register lines
    of the entry functions whose mangled names match `pattern` (groups:
    the kernel's name, then its template arguments). Returns the names of
    the matched kernels that spill, which no_spills makes an error."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        log(f'  nvcc -Xptxas -v failed:\n{out[-2000:]}')
        require(not no_spills, 'nvcc -Xptxas -v failed')
        return []
    name, spilled = None, []
    for line in out.splitlines():
        if 'Compiling entry function' in line:
            m = re.search(pattern, line)
            name = m and f'{m[1]}<{", ".join(a for a in m.groups()[1:] if a)}>'
        elif name and ('spill' in line or 'registers' in line):
            log(f'  ptxas {name}: {line.split(":")[-1].strip()}')
            if re.search(r'[1-9]\d* bytes spill', line):
                spilled.append(name)
    require(not (no_spills and spilled), f'kernels spill: {spilled}')
    return spilled


# sources and mangled-name patterns of the kernels whose registers phase 1
# logs: flash_*_kernel_tc<D, tile, ...>, int8_matmul_t_kernel<T> (f: f32,
# 13__nv_bfloat16: bf16), lm_head_tc_kernel<W, NG> (a: int8) and
# gmm_tc_kernel<Tile, KMAJ> / tgmm_tc_kernel<Tile>; and, required to spill
# nothing, int8_matmul_wgmma_kernel<BN>, int8_matmul_stream_kernel<NG, S>,
# ffn_up_kernel<W, GATED, NG, S>, ffn_down_kernel<W, NG, S>, the bf16
# decode front's decode_front_norm_kernel<T>, decode_front_stream_kernel<W,
# NG, S> and decode_front_tail_kernel<T, INT8>, the split walks
# decode_attention_q_split_kernel<D> (int8 KV),
# decode_attention_split_kernel<D> (bf16 KV), verify_attention_split_kernel<D>
# and paged_attention_split_kernel<D, Q>, and the bf16 block-sparse
# forward block_sparse_fwd_kernel_tc<D, W> and backward
# block_sparse_dq_kernel_tc<D, N> / block_sparse_dkv_kernel_tc<D, R>
PTXAS_KERNELS = (
    ('flash_attention.cu', r'(flash_\w+_tc)ILi(\d+)ELi(\d+)E(?:Li(\d+)E)?',
     False),
    ('int8_matmul.cu', r'(int8_matmul_t_kernel)I(f|13__nv_bfloat16)E', False),
    ('lm_head.cu', r'(lm_head_tc_kernel)I(a|13__nv_bfloat16)Li(\d)E', False),
    ('gmm.cu', r'(t?gmm_tc_kernel)INS_\d+([A-Za-z0-9]+?)E(?:Lb([01])E)?',
     False),
    ('int8_matmul.cu', r'(int8_matmul_(?:wgmma|stream)_kernel)ILi(\d+)E'
     r'(?:Li(\d)E)?', True),
    ('ffn_tail.cu', r'(ffn_(?:up|down)_kernel)I(a|13__nv_bfloat16)'
     r'(?:Lb([01])E)?Li(\d)ELi(\d)E', True),
    ('decode_front.cu', r'(decode_front_(?:norm|stream|tail)_kernel)'
     r'I(a|13__nv_bfloat16)(?:Lb([01])E)?(?:Li(\d)ELi(\d)E)?', True),
    ('decode_attention.cu',
     r'((?:decode_attention_(?:q_)?|verify_attention_)split_kernel)'
     r'ILi(\d+)E', True),
    ('paged_attention.cu',
     r'(paged_attention_split_kernel)ILi(\d+)ELb([01])E', True),
    ('block_sparse_attention.cu',
     r'(block_sparse_(?:fwd|dq|dkv)_kernel_tc)ILi(\d+)ELi(\d+)E', True))


class Timer:
    """Median device time of one call, each launch starting with a cold L2
    (a 128 MB buffer is rewritten outside the timed window). A spin kernel
    holds the stream while the host enqueues the call, so the window holds
    device time, not the wrappers' Python."""

    def __init__(self):
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device=DEV)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        times.sort()
        return times[len(times) // 2]


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    """Least time for the work: bytes over HBM rate vs ops over peak."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_b, 'bytes') if t_b >= t_o else (t_o, 'operations')


def nbytes(*ts) -> int:
    """Bytes of the tensors (int8 weight dicts count q and scale)."""
    return sum(nbytes(*t.values()) if isinstance(t, dict)
               else t.numel() * t.element_size() for t in ts if t is not None)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def tolerance(dtype) -> tuple[float, float]:
    """(atol, rtol): f32 1e-5 / 1e-5; bf16 2e-2 and one bf16 step (2^-7)
    relative, since kernel and twin round to bf16 at different places."""
    return (1e-5, 1e-5) if dtype == torch.float32 else (2e-2, 2 ** -7)


def output_tolerance(want, dtype) -> tuple[float, float]:
    """(atol, rtol) for an attention output: f32 as `tolerance`; bf16 one
    bf16 step of the largest output (2^-7 max|want|) plus one step
    relative, in place of the fixed 2e-2, which is 2-19 bf16 steps of the
    outputs phase 2 checks with it (max |o| 0.14-1.24)."""
    atol, rtol = tolerance(dtype)
    if dtype != torch.float32:
        atol = rtol * want.float().abs().max().item()
    return atol, rtol


def tight_tolerance(want, dtype) -> tuple[float, float]:
    """(atol, rtol) for the bf16-KV decode attention's and the block-sparse
    forward's outputs: the tighter of `tolerance` (the fixed 2e-2 their
    contract states) and `output_tolerance` (one bf16 step of the largest
    output), so that neither a small nor a large output loosens the check."""
    atol, rtol = output_tolerance(want, dtype)
    return min(atol, tolerance(dtype)[0]), rtol


def close(got, want, dtype, tol=None) -> bool:
    atol, rtol = tol or tolerance(dtype)
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * want.float().abs()).all())


def tol_str(dtype, tol=None) -> str:
    atol, rtol = tol or tolerance(dtype)
    return f'tol {atol:g} + {rtol:g}|x|'


def mismatch(a, b) -> float:
    return (a != b).float().mean().item()


def sync() -> None:
    if DEV == 'cuda':
        torch.cuda.synchronize()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def gen(seed: int, dev=None) -> torch.Generator:
    g = torch.Generator(device=dev or DEV)
    g.manual_seed(seed)
    return g


def randn(g, shape, dtype, dev=None, std=1.0):
    return (torch.randn(shape, generator=g, device=dev or DEV)
            * std).to(dtype)


def log_times(res) -> None:
    """One line with a timed check's device times and bound."""
    extra = (f', unfused torch {res["unfused_ms"] * 1e3:.1f} us'
             if 'unfused_ms' in res else '')
    lib = (f', library {res["library_ms"] * 1e3:.1f} us'
           if res.get('library_ms') is not None else '')
    log(f'      {res["ms"] * 1e3:.1f} us (cold L2), bound '
        f'{res["bound_ms"] * 1e3:.2f} us ({res["bound_by"]}), plain '
        f'{res["plain_ms"] * 1e3:.1f} us{lib}{extra}')


def covered_tokens(tables, n_tiles, pos, tile_base, tps, kv) -> int:
    """(slot, head, token) triples the tables cover, masked as in the
    kernels: full tiles below the write tile, the write tile up to the new
    token; -1 entries and entries at or past n_tiles are empty."""
    rows = tables.repeat_interleave(kv // tables.shape[1], dim=1).long()
    t_max = rows.shape[2]
    gt = rows[..., None] + torch.arange(tps, device=rows.device)
    ok = (rows >= 0) & (torch.arange(t_max, device=rows.device)
                        < n_tiles[:, None, None])
    wt = (tile_base + pos // TILE).long()[:, None, None, None]
    per = torch.where(gt == wt, (pos % TILE + 1).long()[:, None, None, None],
                      torch.where(gt < wt, TILE, 0))
    return int((per * ok[..., None]).sum())


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain twin
# ---------------------------------------------------------------------------

def front_inputs(dtype, g, b=B, d=D, heads=HEADS, kv=HEADS, n_sub=N_SUB,
                 llama=False, triple=False, layers=LAYERS, nt=NT):
    """decode_front inputs at a serving shape, slots at positions
    (nt-1)*TILE + slot: x, norm scale / bias (None for LLaMA), the QKV
    weight (a [3, D, D] stack, or the (wq, wk, wv) triple), the QKV bias
    (None for LLaMA), bd / cbn, the code cache, pos, then cos / sin (None
    for OPT)."""
    dev = DEV
    from spt_proto_tpu_torch.layers.common import rope_cos_sin
    from spt_proto_tpu_torch.ops.decode_front import build_pq_bd
    dh = d // heads
    x = randn(g, (b, d), dtype, dev)
    nsc = (1 + randn(g, (d,), torch.float32, dev, 0.1)).to(dtype)
    nbi = None if llama else randn(g, (d,), dtype, dev, 0.1)
    if triple:
        w = tuple(randn(g, (d, n), dtype, dev, d ** -0.5)
                  for n in (heads * dh, kv * dh, kv * dh))
    else:
        w = randn(g, (3, d, d), dtype, dev, d ** -0.5)
    bq = None if llama else randn(g, (3, d), dtype, dev, 0.1)
    bd, cbn = build_pq_bd(randn(g, (n_sub, N_CODE, dh // n_sub),
                                torch.float32, dev))
    cc = torch.randint(0, N_CODE, (b, kv, layers * nt, n_sub, TILE),
                       generator=g, device=dev, dtype=torch.int32)
    pos = (nt - 1) * TILE + torch.arange(b, device=dev, dtype=torch.int32)
    cos = sin = None
    if llama:
        cos, sin = rope_cos_sin(pos, dh, base=10000.0)
    return [x, nsc, nbi, w, bq, bd, cbn, cc, pos, cos, sin]


# (label, front_inputs geometry) of the LLaMA front checks: LLaMA-7B's MHA
# forms at B=4, Llama-3-8B's GQA triples at B=8
LLAMA_FRONTS = {
    'llama-7b': dict(b=B_7B, d=D_LL, heads=HEADS_LL, kv=HEADS_LL,
                     n_sub=N_SUB_LL, llama=True),
    'llama-3-8b': dict(b=B, d=D_LL, heads=HEADS_LL, kv=KV_38B,
                       n_sub=N_SUB_LL, llama=True, triple=True)}


def int8_weight(g, k, n, dtype):
    """A [k, n] weight in `dtype` (std k^-1/2) through the int8 build's
    quantizer: {'q': [k, n_pad] int8, 'scale': [1, n] f32}."""
    from spt_proto_tpu_torch.inference.weights import quantize_int8
    return quantize_int8(randn(g, (k, n), dtype, std=k ** -0.5))


def dequant(wq, dtype):
    """The true-width [k, n] weight in `dtype` (for the library yardstick:
    it reads twice the bytes of the int8 weight)."""
    n = wq['scale'].numel()
    return (wq['q'][:, :n].float() * wq['scale'].reshape(1, n)).to(dtype)


def front_case(label, dtype, args, cos_sin, base, kw, timer=None,
               tdt=None):
    """decode_front vs decode_front_ref on one set of inputs (front_inputs'
    first nine, then cos / sin), on the kernels front_plan names (asserted:
    bf16 the stream, f32 the fused kernel); tdt the dtype whose bounds hold
    (the int8 forms: bf16). Timed with the cuBLAS product of the normed
    rows and the concatenated q / k / v weights (dequantized for the int8
    forms) beside it when timer is given."""
    from spt_proto_tpu_torch.ops import decode_front as m
    tdt = tdt or dtype
    quantized = kw['quantized']
    x, nsc, nbi, w, bq, bd, cbn, cc = args[:8]
    route = m.call_plan(x, nsc, nbi, w, bd, cbn, cc, *cos_sin,
                        kw['n_sub'])['route']
    require(route == ('stream' if dtype == torch.bfloat16 else 'fused'),
            f'{label} {dtype}: route {route}')
    got = m.decode_front(*args, base, *cos_sin, **kw)
    want = m.decode_front_ref(*args, base, *cos_sin, **kw)
    sync()
    require(len(got) == len(want) == (9 if quantized else 5),
            f'decode_front returned {len(got)} outputs')
    q_err = max(max_err(g_, w_) for g_, w_ in zip(got[:3], want[:3]))
    # exact expected; the kernel and torch sum the projection in different
    # orders, so a projection one rounding step apart can move a value
    # across an argmin or int8 boundary. Codes and tables: none in f32, at
    # most one flipped entry each in bf16 (a wrong selection on a head
    # shows as more). k8/v8: a few values one int8 step apart. The int8
    # forms round the kernel's own f32 norm output to bf16 in both serving
    # dtypes, so an f32 ulp between its norm sums and the twin's can become
    # a whole bf16 step of one operand: they are held to the bf16 bounds in
    # f32 too.
    sel_flips = max(int((got[i] != want[i]).sum()) for i in (3, 4))
    sel_tol = 0 if tdt == torch.float32 else 1
    qkv_ok = all(close(g_, w_, tdt) for g_, w_ in zip(got[:3], want[:3]))
    if quantized:
        kv_flips = max(mismatch(got[i], want[i]) for i in (5, 6))
        kv_tol = 1e-3 if tdt == torch.float32 else 1e-2
        step = max(max_err(got[i], want[i]) for i in (5, 6))
        s_err = max(((got[i] - want[i]).abs() / want[i]).max().item()
                    for i in (7, 8))
        s_tol = 1e-5 if tdt == torch.float32 else 1e-2
        kv_ok = kv_flips <= kv_tol and step <= 1 and s_err <= s_tol
        kv_msg = (f'; k8/v8 mismatch {kv_flips:.3g} (tol {kv_tol}), int8 '
                  f'step {step}, scale rel err {s_err:.3g}')
    else:
        kv_ok, kv_msg = True, ''
    require(qkv_ok and sel_flips <= sel_tol and kv_ok,
            f'{label} {dtype}: qkv err {q_err}, code/table flips '
            f'{sel_flips} (tol {sel_tol}){kv_msg}')
    log(f'  {label:45s} {str(dtype):15s} qkv max err {q_err:.3g} '
        f'({tol_str(tdt)}); code/table entries flipped {sel_flips} '
        f'(tol {sel_tol}){kv_msg}')
    res = dict(max_abs_err=q_err, route=route)
    if timer is not None:
        x, nsc, nbi, w, bq, bd, cbn, cc, pos = args
        res['ms'] = timer.ms(lambda: m.decode_front(*args, base, *cos_sin,
                                                    **kw))
        res['plain_ms'] = timer.ms(lambda: m.decode_front_ref(
            *args, base, *cos_sin, **kw), reps=5)
        b = x.shape[0]
        n_sub = kw['n_sub']
        cur = pos // TILE
        n_full = int(cur.clamp(max=kw['nt']).sum())
        kv = cc.shape[1]
        slab = kv * n_full * n_sub * TILE * 4          # code slab it scans
        w_ts = [w] if not isinstance(w, tuple) else list(w)
        io = nbytes(x, nsc, nbi, *w_ts, bq, bd, cbn, pos, *cos_sin, *got)
        n_q, n_k = got[0].shape[1], got[1].shape[1]
        ops = 2 * b * x.shape[1] * (n_q + 2 * n_k) \
            + 2 * b * (n_q + n_k) * bd.shape[1]        # projection, encode
        res['bound_ms'], res['bound_by'] = bound_ms(io + slab, ops, dtype)
        # no one PyTorch call computes the front; its projection alone is
        # one product, timed as a yardstick for the stream
        if isinstance(w, torch.Tensor):
            wcat = torch.cat(list(w), 1)
        elif isinstance(w, dict):
            wcat = dequant(w, dtype)
        elif isinstance(w[0], dict):
            wcat = torch.cat([dequant(t, dtype) for t in w], 1)
        else:
            wcat = torch.cat(list(w), 1)
        hn = randn(gen(SEED), (b, x.shape[1]), dtype)
        res['projection_library_ms'] = timer.ms(lambda: hn @ wcat)
        del wcat
        res['library_ms'] = None
        log_times(res)
        log(f'      projection beside it: cuBLAS hn @ [wq | wk | wv] '
            f'{res["projection_library_ms"] * 1e3:.1f} us')
    return res, got


def check_front(dtype, timer=None, quantized=True, packed=False,
                model=None):
    """decode_front vs decode_front_ref at the serving shape (the middle
    layer's slab), with int8 KV quantization (sparse int8-KV decode) or
    without (sparse bf16-KV decode), with the fp weight or the int8 one
    (packed=True: int8 weight-only serving). model None: OPT-125M, the
    stacked QKV (int8: packed); else a LLAMA_FRONTS entry: LLaMA-7B's stack
    (int8: packed) or Llama-3-8B's GQA triple (int8: triple_int8), with
    RMSNorm and RoPE."""
    from spt_proto_tpu_torch.ops import decode_front as m
    from spt_proto_tpu_torch.inference.weights import quantize_int8
    geo = LLAMA_FRONTS[model] if model else {}
    n_sub = geo.get('n_sub', N_SUB)
    layers = geo.get('layers', LAYERS)
    args = front_inputs(dtype, gen(SEED + 1), **geo)
    cos_sin = args[9:]
    args = args[:9]
    if packed and isinstance(args[3], tuple):
        args[3] = tuple(quantize_int8(w) for w in args[3])
    elif packed:
        args[3] = quantize_int8(torch.cat(list(args[3]), dim=-1))
    llama = model is not None
    kw = dict(nt=NT, nsel=NSEL, n_sub=n_sub, ps=TILE, quantized=quantized,
              eps=1e-6 if llama else 1e-5, arch='llama' if llama else 'opt')
    base = layers // 2 * NT
    form = m.weight_form(args[3])
    label = (f'decode_front {form}{" " + model if model else ""} '
             f'{"int8-KV" if quantized else "bf16-KV"}')
    return front_case(label, dtype, args, cos_sin, base, kw, timer,
                      torch.bfloat16 if packed else dtype)


def check_front_edges(dtype, timer=None):
    """decode_front's edges, each vs its twin on the route front_plan
    names (and timed when timer is given): B = 1, 3, 9 and 16 (OPT-125M's
    stack and Llama-3-8B's triple_int8); a slot whose position has no full
    tile yet (every score empty: -1 entries before the current tile);
    equal tile scores planted (every full tile of slot 0's slab the same:
    the lowest tiles win); the packed int8 form at D = 640 (D % 256 != 0:
    K blocks of 128); a biased GQA triple (OPT's LayerNorm and biases, 12
    query heads over 4 kv heads); one kv head for 8 query heads (LLaMA's
    RMSNorm and RoPE, d_head 128)."""
    from spt_proto_tpu_torch.inference.weights import quantize_int8
    opt = dict(nt=NT, nsel=NSEL, n_sub=N_SUB, ps=TILE, quantized=True,
               eps=1e-5, arch='opt')
    llama = dict(opt, n_sub=N_SUB_LL, eps=1e-6, arch='llama')
    base = LAYERS // 2 * NT
    res = {}

    def case(name, kw, geo, int8=False, edit=None):
        args = front_inputs(dtype, gen(SEED + 21), **geo)
        cos_sin, args = args[9:], args[:9]
        if int8:
            args[3] = (tuple(quantize_int8(w) for w in args[3])
                       if isinstance(args[3], tuple)
                       else quantize_int8(torch.cat(list(args[3]), -1)))
        if edit is not None:
            edit(args)
        geo_layers = geo.get('layers', LAYERS)
        res[name] = front_case(
            f'decode_front edge {name}', dtype, args, cos_sin,
            geo_layers // 2 * NT if geo_layers != LAYERS else base, kw,
            timer, torch.bfloat16 if int8 else dtype)[0]

    ll38 = dict(LLAMA_FRONTS['llama-3-8b'], layers=4)
    for b in (1, 3, 9, 16):
        case(f'stack B={b}', opt, dict(b=b))
        case(f'triple_int8 llama-3-8b B={b}', llama, dict(ll38, b=b),
             int8=True)

    def no_full_tile(args):
        args[8][0] = 5                       # the first tile, 6 tokens in
        args[8][1] = TILE - 1

    def equal_scores(args):
        cc = args[7]
        sl = cc[0, :, base:base + NT - 1]
        sl.copy_(sl[:, :1].clone().expand_as(sl))   # slot 0: tiles alike
    case('no full tile', opt, {}, edit=no_full_tile)
    case('equal tile scores', opt, {}, edit=equal_scores)
    case('packed_int8 D=640 (BK 128)', opt, dict(d=640, heads=10, kv=10),
         int8=True)

    def biased(args):
        wq, wk, wv = args[3]
        b_ = randn(gen(SEED + 22), (3, wq.shape[1]), dtype, std=0.1)
        b_[1:, wk.shape[1]:] = 0             # k / v biases zero-padded
        args[4] = b_
    case('biased triple (G=3)', opt, dict(heads=12, kv=4, triple=True),
         edit=biased)
    case('triple KV=1 (G=8)', llama,
         dict(b=B, d=1024, heads=8, kv=1, n_sub=N_SUB_LL, llama=True,
              triple=True, layers=4))
    return res


def attention_inputs(dtype, front_out, g):
    """int8 caches at the serving shape; tables and the new token from the
    decode_front outputs (their contract: entry n_tiles-1 is the write
    tile)."""
    q, k, v, c_new, tables, k8, v8, ks, vs = front_out
    n_all = LAYERS * NT
    kc = torch.randint(-127, 128, (B, HEADS, n_all, DH, TILE), generator=g,
                       device=DEV, dtype=torch.int8)
    vc = torch.randint(-127, 128, kc.shape, generator=g, device=DEV,
                       dtype=torch.int8)
    cc = torch.randint(0, N_CODE, (B, HEADS, n_all, N_SUB, TILE), generator=g,
                       device=DEV, dtype=torch.int32)
    kvp = -(-HEADS // 8) * 8
    ksc = torch.rand((B, n_all, kvp, TILE), generator=g, device=DEV) * 0.05
    vsc = torch.rand(ksc.shape, generator=g, device=DEV) * 0.05
    ksc[:, :, HEADS:] = vsc[:, :, HEADS:] = 0.0
    pos = (NT - 1) * TILE + torch.arange(B, device=DEV, dtype=torch.int32)
    base = torch.full((B,), LAYERS // 2 * NT, device=DEV, dtype=torch.int32)
    n_tiles = torch.full((B,), tables.shape[2], device=DEV,
                         dtype=torch.int32)
    return [q.reshape(B, HEADS, 1, DH), kc, vc, cc, ksc, vsc, tables, n_tiles,
            pos, k8.reshape(B, HEADS, DH), v8.reshape(B, HEADS, DH), c_new,
            ks, vs, base]


def dense_tables(pos, nt, tps, base):
    """One table row for all heads: supertile starts e * tps (+ base) for
    e <= (pos // TILE) // tps, -1 past them; the JAX engine's dense form."""
    cur = (pos // TILE).long()
    e = torch.arange(-(-nt // tps), device=pos.device)
    n_sup = cur // tps + 1
    tables = torch.where(e[None] < n_sup[:, None], e * tps + base, -1)
    return tables[:, None].to(torch.int32), n_sup.to(torch.int32)


def attention_q_dense_inputs(g):
    """int8 caches at max_len 2048 (16 tiles a layer) read as dense
    supertiles of 4 through one table row, slots at positions 2040-2047."""
    nt, tps = PROMPT // TILE, 4
    n_all = LAYERS * nt
    base = LAYERS // 2 * nt
    kc = torch.randint(-127, 128, (B, HEADS, n_all, DH, TILE), generator=g,
                       device=DEV, dtype=torch.int8)
    vc = torch.randint(-127, 128, kc.shape, generator=g, device=DEV,
                       dtype=torch.int8)
    cc = torch.zeros((B, HEADS, n_all, 1, TILE), device=DEV,
                     dtype=torch.int32)
    kvp = -(-HEADS // 8) * 8
    ksc = torch.rand((B, n_all, kvp, TILE), generator=g, device=DEV) * 0.05
    vsc = torch.rand(ksc.shape, generator=g, device=DEV) * 0.05
    ksc[:, :, HEADS:] = vsc[:, :, HEADS:] = 0.0
    pos = PROMPT - B + torch.arange(B, device=DEV, dtype=torch.int32)
    tables, n_tiles = dense_tables(pos, nt, tps, base)
    kn = torch.randint(-127, 128, (B, HEADS, DH), generator=g, device=DEV,
                       dtype=torch.int8)
    vn = torch.randint(-127, 128, kn.shape, generator=g, device=DEV,
                       dtype=torch.int8)
    ksn = torch.rand((B, HEADS), generator=g, device=DEV) * 0.05
    vsn = torch.rand((B, HEADS), generator=g, device=DEV) * 0.05
    return [None, kc, vc, cc, ksc, vsc, tables, n_tiles, pos, kn, vn,
            torch.zeros((B, HEADS, 1), device=DEV, dtype=torch.int32), ksn,
            vsn, torch.full((B,), base, device=DEV, dtype=torch.int32)], tps


def check_attention(dtype, front_out, timer=None, dense=False):
    """decode_attention_rows_q vs its twin: sparse tables from the front at
    the serving shape, or (dense=True) dense supertiles of 4 through one
    table row, as dense decode over the int8 cache sends them."""
    from spt_proto_tpu_torch.ops import decode_attention as m
    g = gen(SEED + 2)
    if dense:
        args, tps = attention_q_dense_inputs(g)
        args[0] = randn(g, (B, HEADS, 1, DH), dtype)
        label = 'int8 dense tps 4'
    else:
        args, tps = attention_inputs(dtype, front_out, g), 1
        label = 'int8 sparse'
    kw = dict(ps=TILE, tps=tps, scale=DH ** -0.5,
              clamp=0.0 if dense else 10.0)
    route = m.q_route(dtype, 1, DH, TILE, args[6].shape[2] * tps)
    require((route == 'split') == (dtype == torch.bfloat16),
            f'int8 {label} {dtype}: route {route}')
    ref_args = [a.clone() for a in args]
    got = m.decode_attention_rows_q(*args, **kw)
    want = m.decode_attention_rows_q_ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    caches_equal = all(torch.equal(g_, w_) for g_, w_ in zip(got[1:],
                                                             want[1:]))
    require(close(got[0], want[0], dtype) and caches_equal,
            f'decode_attention_rows_q {label} {dtype}: o err {err}, appended '
            f'caches equal: {caches_equal}')
    log(f'  decode_attention_rows_q {label} {str(dtype):14s} o max err '
        f'{err:.3g} ({tol_str(dtype)}); appended caches exact')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.decode_attention_rows_q(*args, **kw))
        res['plain_ms'] = timer.ms(
            lambda: m.decode_attention_rows_q_ref(*ref_args, **kw), reps=5)
        q, tables, n_tiles, pos, tb = args[0], args[6], args[7], args[8], \
            args[14]
        tokens = covered_tokens(tables, n_tiles, pos, tb, tps, HEADS)
        moved = tokens * (2 * DH + 2 * 4)           # K, V int8 + 2 scales
        io = nbytes(q, *args[6:15], got[0])
        ops = tokens * 2 * 2 * DH
        res['bound_ms'], res['bound_by'] = bound_ms(moved + io, ops,
                                                    torch.int8)
        res['library_ms'] = None
        log_times(res)
    return res


def rows_inputs(dtype, mode, front_out, g):
    """bf16/f32 caches at the serving shape for decode_attention_rows.
    'dense': max_len 2176 (17 tiles a layer), tps 1, one table row of 17
    entries, slots at 2048-2055; 'dense-tps4': max_len 2048, supertiles of
    4, slots at 2040-2047; 'sparse': the bf16-KV front's tables and new
    token (3 tiles a head)."""
    nt = PROMPT // TILE if mode == 'dense-tps4' else NT
    n_all = LAYERS * nt
    base = LAYERS // 2 * nt
    kc = randn(g, (B, HEADS, n_all, DH, TILE), dtype)
    vc = randn(g, kc.shape, dtype)
    if mode == 'sparse':
        q, k, v, c_new, tables = front_out[:5]
        q4, kn, vn = (q.reshape(B, HEADS, 1, DH), k.reshape(B, HEADS, DH),
                      v.reshape(B, HEADS, DH))
        cc = torch.randint(0, N_CODE, (B, HEADS, n_all, N_SUB, TILE),
                           generator=g, device=DEV, dtype=torch.int32)
        pos = (NT - 1) * TILE + torch.arange(B, device=DEV, dtype=torch.int32)
        n_tiles = torch.full((B,), NSEL, device=DEV, dtype=torch.int32)
        tps = 1
    else:
        tps = 4 if mode == 'dense-tps4' else 1
        q4 = randn(g, (B, HEADS, 1, DH), dtype)
        kn, vn = randn(g, (B, HEADS, DH), dtype), randn(g, (B, HEADS, DH),
                                                       dtype)
        cc = torch.zeros((B, HEADS, n_all, 1, TILE), device=DEV,
                         dtype=torch.int32)
        c_new = torch.zeros((B, HEADS, 1), device=DEV, dtype=torch.int32)
        first = PROMPT - B if mode == 'dense-tps4' else PROMPT
        pos = first + torch.arange(B, device=DEV, dtype=torch.int32)
        tables, n_tiles = dense_tables(pos, nt, tps, base)
    tile_base = torch.full((B,), base, device=DEV, dtype=torch.int32)
    return [q4, kc, vc, cc, tables, n_tiles, pos, kn, vn, c_new,
            tile_base], tps


def check_rows(dtype, mode, front_out, timer=None):
    """decode_attention_rows (bf16/f32 cache) vs its twin. The kernel rounds
    the unnormalised exp to the cache dtype before PV, the twin the
    normalised probabilities (the TPU kernel vs its oracle): held to
    tight_tolerance, 1e-5 in f32."""
    from spt_proto_tpu_torch.ops import decode_attention as m
    args, tps = rows_inputs(dtype, mode, front_out, gen(SEED + 5))
    kw = dict(ps=TILE, tps=tps, scale=DH ** -0.5,
              clamp=10.0 if mode == 'sparse' else 0.0)
    route = m.rows_route(dtype, 1, DH, TILE, args[4].shape[2] * tps)
    require((route == 'split') == (dtype == torch.bfloat16),
            f'decode_attention_rows {mode} {dtype}: route {route}')
    ref_args = [a.clone() for a in args]
    got = m.decode_attention_rows(*args, **kw)
    want = m.decode_attention_rows_ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    caches_equal = all(torch.equal(g_, w_) for g_, w_ in zip(got[1:],
                                                             want[1:]))
    t_max = args[4].shape[2]
    tol = tight_tolerance(want[0], dtype)
    require(close(got[0], want[0], dtype, tol) and caches_equal
            and bool(torch.isfinite(got[0]).all()),
            f'decode_attention_rows {mode} {dtype}: o err {err}, appended '
            f'caches equal: {caches_equal}')
    log(f'  decode_attention_rows {mode:10s} (T={t_max}, tps {tps}, '
        f'{route}) {str(dtype):14s} o max err {err:.3g} '
        f'({tol_str(dtype, tol)}); appended caches exact')
    res = dict(max_abs_err=err, walk=route)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.decode_attention_rows(*args, **kw))
        res['plain_ms'] = timer.ms(
            lambda: m.decode_attention_rows_ref(*ref_args, **kw), reps=5)
        q, tables, n_tiles, pos, tb = args[0], args[4], args[5], args[6], \
            args[10]
        tokens = covered_tokens(tables, n_tiles, pos, tb, tps, HEADS)
        moved = tokens * 2 * DH * q.element_size()          # K and V
        io = nbytes(q, *args[4:11], got[0])
        ops = tokens * 2 * 2 * DH
        res['bound_ms'], res['bound_by'] = bound_ms(moved + io, ops, dtype)
        # no one PyTorch call computes a tile-table gather + in-place
        # append + attention over this token-minor layout
        res['library_ms'] = None
        log_times(res)
    return res


def unaligned(t):
    """A contiguous copy of t whose data starts one element past a 16-byte
    boundary (a view into a larger buffer)."""
    u = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return u.view(t.shape).copy_(t)


def rows_case(label, dtype, grp, dh, kv, pos, tables, n_tiles, tps=1,
              nt=NT, layers=2, width=N_SUB_LL, clamp=10.0, plant=None,
              timer=None, seed=SEED + 14, off_rule=None):
    """decode_attention_rows vs its twin on bf16/f32 caches of `layers` x nt
    tiles (the middle layer's at base), slots at `pos`, the given PHYSICAL
    tables [B, N_TAB, T] and n_tiles, on the kernel rows_route names
    (asserted: bf16 the split walk; off_rule names the kernel a bf16 call
    off the rule takes, 'one-pass' or 'two-pass', with q unaligned when
    d_head is 64 or 128). The output is held to tight_tolerance. plant:
    'chunk' puts a key whose score
    is each row's max (~0.75 sqrt(dh) against ~N(0, 1) elsewhere) at lane
    50 of the table's entry T - 7 (a chunk past the first), 'new' makes the
    new token's key that max: both hold the max the split walk exchanges
    between its chunks. Timed when timer is given."""
    from spt_proto_tpu_torch.ops import decode_attention as m
    g = gen(seed)
    b = pos.shape[0]
    n_all, base = layers * nt, layers // 2 * nt
    q = randn(g, (b, kv, grp, dh), dtype)
    kc, vc = (randn(g, (b, kv, n_all, dh, TILE), dtype) for _ in range(2))
    cc = torch.randint(0, N_CODE if width > 1 else 1,
                       (b, kv, n_all, width, TILE), generator=g, device=DEV,
                       dtype=torch.int32)
    c_new = torch.randint(0, N_CODE if width > 1 else 1, (b, kv, width),
                          generator=g, device=DEV, dtype=torch.int32)
    kn, vn = (randn(g, (b, kv, dh), dtype) for _ in range(2))
    top = (q.float().mean(2) * (0.75 * grp)).to(dtype)        # [b, kv, dh]
    tables = tables.to(torch.int32)
    if plant == 'chunk':
        rows = tables.repeat_interleave(kv // tables.shape[1], dim=1)
        at = rows[..., tables.shape[2] - 7].long()              # [b, kv]
        bi = torch.arange(b, device=DEV)[:, None]
        hi = torch.arange(kv, device=DEV)[None]
        kc[bi, hi, at, :, 50] = top
    elif plant == 'new':
        kn = top
    tb = torch.full((b,), base, device=DEV, dtype=torch.int32)
    aligned = off_rule is None or dh not in (64, 128)
    if not aligned:
        q = unaligned(q)
    args = [q, kc, vc, cc, tables, n_tiles.to(torch.int32),
            pos.to(torch.int32), kn, vn, c_new, tb]
    kw = dict(ps=TILE, tps=tps, scale=dh ** -0.5, clamp=clamp)
    route = m.rows_route(dtype, grp, dh, TILE, tables.shape[2] * tps,
                         aligned)
    require(route == off_rule if off_rule else
            (route == 'split') == (dtype == torch.bfloat16),
            f'{label}: route {route}')
    ref_args = [a.clone() for a in args]
    got = m.decode_attention_rows(*args, **kw)
    want = m.decode_attention_rows_ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    caches_equal = all(torch.equal(g_, w_) for g_, w_ in zip(got[1:],
                                                             want[1:]))
    tol = tight_tolerance(want[0], dtype)
    require(close(got[0], want[0], dtype, tol) and caches_equal
            and bool(torch.isfinite(got[0]).all()),
            f'{label} {dtype}: o err {err}, appended caches equal: '
            f'{caches_equal}')
    plan = (m.rows_split_plan(tables.shape[2] * tps) if route == 'split'
            else None)
    log(f'  decode_attention_rows {label} ({route}'
        + (f', {plan[0]} chunks of {plan[1]}' if plan else '')
        + f') {str(dtype):14s} o max err {err:.3g} ({tol_str(dtype, tol)}); '
        f'appended caches exact')
    res = dict(max_abs_err=err, walk=route)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.decode_attention_rows(*args, **kw))
        res['plain_ms'] = timer.ms(
            lambda: m.decode_attention_rows_ref(*ref_args, **kw), reps=5)
        tokens = covered_tokens(tables, args[5], args[6], tb, tps, kv)
        io = nbytes(q, tables, args[5], args[6], c_new, tb, got[0], kn, vn)
        res['bound_ms'], res['bound_by'] = bound_ms(
            tokens * 2 * dh * q.element_size() + io,
            tokens * 2 * 2 * dh * grp, dtype)
        res['library_ms'] = None
        log_times(res)
    return res


def check_rows_edges(dtype, timer=None):
    """decode_attention_rows' edges, each vs its twin on the route
    rows_route names: -1 entries and entries past n_tiles; the new token at
    lane 0 and at lane PS - 1; dense supertiles of 4 through one table row;
    G = 1, 4 and 8 (d_head 128, and 64 at G = 1); a row of 400 tiles whose
    scores go to the global buffer; the row's max in a chunk past the
    first, and in the new token (dense T = 17 at G = 4: 3 chunks of 6
    entries, so both lie in another chunk than the first). In bf16, the
    calls off the rule too: d_head 80 (OPT-2.7B's) and an unaligned q
    take the one-pass kernel, an unaligned q over a dense table of 96
    tiles the two-pass walk."""
    g = gen(SEED + 15)
    base = NT
    pos = PROMPT + torch.arange(B, device=DEV, dtype=torch.int32)
    n3 = torch.full((B,), NSEL, device=DEV, dtype=torch.int32)
    res = {}
    t5 = sparse_rows(pos, KV_38B, 4, base, g)
    tables = torch.stack([t5[..., 0], torch.full_like(t5[..., 0], -1),
                          t5[..., 1], t5[..., 3], t5[..., 2]], -1)
    res['-1 and past n_tiles'] = rows_case(
        '-1 / past-n_tiles entries G=4', dtype, 4, DH_LL, KV_38B, pos,
        tables, torch.full((B,), 4, device=DEV, dtype=torch.int32),
        timer=timer)
    for lane in (0, TILE - 1):
        p_ = 15 * TILE + lane + 0 * pos
        res[f'new token lane {lane}'] = rows_case(
            f'new token at lane {lane} G=4', dtype, 4, DH_LL, KV_38B, p_,
            sparse_rows(p_, KV_38B, NSEL, base, g), n3, timer=timer)
    p4 = PROMPT - B + torch.arange(B, device=DEV, dtype=torch.int32)
    t4, n4 = dense_tables(p4, PROMPT // TILE, 4, PROMPT // TILE)
    res['dense tps 4 G=4'] = rows_case(
        'dense supertiles of 4 G=4', dtype, 4, DH_LL, KV_38B, p4, t4, n4,
        tps=4, nt=PROMPT // TILE, width=1, clamp=0.0, timer=timer)
    res['G=1'] = rows_case(
        'G=1 d_head 128', dtype, 1, DH_LL, 32, pos[:4],
        sparse_rows(pos[:4], 32, NSEL, base, g), n3[:4], timer=timer)
    res['G=1 d_head 64'] = rows_case(
        'G=1 d_head 64', dtype, 1, DH, HEADS, pos,
        sparse_rows(pos, HEADS, NSEL, base, g), n3, width=N_SUB,
        timer=timer)
    res['G=8'] = rows_case(
        'G=8', dtype, 8, DH_LL, 4, pos, sparse_rows(pos, 4, NSEL, base, g),
        n3, timer=timer)
    # a row of 400 tiles at G = 8: its chunks' scores outgrow shared
    # memory and go to the global buffer (rows_split_plan)
    pl = 400 * TILE - 3 + torch.arange(2, device=DEV, dtype=torch.int32)
    tl, nl = dense_tables(pl, 401, 1, 401)
    res['long row, global scores G=8'] = rows_case(
        'dense T=400 G=8 (scores in the global buffer)', dtype, 8, DH_LL, 1,
        pl, tl, nl, nt=401, width=1, clamp=0.0, timer=timer)
    td, nd = dense_tables(pos, NT, 1, base)
    for plant in ('chunk', 'new'):
        res[f'max in {plant}'] = rows_case(
            'dense T=17 G=4, max ' + ('in the new token' if plant == 'new'
                                      else 'in a chunk past the first'),
            dtype, 4,
            DH_LL, KV_38B, pos, td, nd, width=1, clamp=0.0, plant=plant,
            timer=timer)
    if dtype == torch.bfloat16:
        res['off rule d_head 80'] = rows_case(
            'off rule: G=1 d_head 80 (OPT-2.7B)', dtype, 1, 80, 32, pos[:4],
            sparse_rows(pos[:4], 32, NSEL, base, g), n3[:4], width=N_SUB,
            off_rule='one-pass')
        res['off rule unaligned q'] = rows_case(
            'off rule: unaligned q G=4', dtype, 4, DH_LL, KV_38B, pos,
            sparse_rows(pos, KV_38B, NSEL, base, g), n3, off_rule='one-pass')
        p96 = 96 * TILE - 2 + torch.arange(2, device=DEV, dtype=torch.int32)
        t96, n96 = dense_tables(p96, 97, 1, 97)
        res['off rule unaligned q T=96'] = rows_case(
            'off rule: unaligned q dense T=96 G=4', dtype, 4, DH_LL, KV_38B,
            p96, t96, n96, nt=97, width=1, clamp=0.0, off_rule='two-pass')
    return res


def check_ffn(dtype, d, f, timer=None, int8=False, gated=False, m_rows=B):
    """ffn_tail / ffn_tail_int8, or (gated=True, LLaMA) ffn_tail_gated /
    ffn_tail_gated_int8, vs its twin at (m_rows, d, d_ff), on the kernels
    the wrapper's rule names (ffn_tail_plan: bf16 the tensor-core streams,
    f32 the CUDA-core pair); the engine's unfused torch sequence (over
    dequantized weights for int8) is timed beside it for reference (no
    single PyTorch call computes the function)."""
    from spt_proto_tpu_torch.ops import ffn_tail as m
    g = gen(SEED + (9 if int8 else 6) + (10 if gated else 0))
    x, res_ = randn(g, (m_rows, d), dtype), randn(g, (m_rows, d), dtype)
    if gated:
        shapes = ((d, f), (d, f), (f, d))
        if int8:
            ws = [int8_weight(g, k, n, dtype) for k, n in shapes]
            fn, ref = m.ffn_tail_gated_int8, m.ffn_tail_gated_int8_ref
        else:
            ws = [randn(g, (k, n), dtype, std=k ** -0.5) for k, n in shapes]
            fn, ref = m.ffn_tail_gated, m.ffn_tail_gated_ref
        args = [x, res_, *ws]
        n_w = 3
    else:
        if int8:
            w1, w2 = int8_weight(g, d, f, dtype), int8_weight(g, f, d, dtype)
            fn, ref = m.ffn_tail_int8, m.ffn_tail_int8_ref
        else:
            w1 = randn(g, (d, f), dtype, std=d ** -0.5)
            w2 = randn(g, (f, d), dtype, std=f ** -0.5)
            fn, ref = m.ffn_tail, m.ffn_tail_ref
        b1 = randn(g, (f,), dtype, std=0.1)
        b2 = randn(g, (d,), dtype, std=0.1)
        args = [x, res_, w1, b1, w2, b2]
        ws = [w1, w2]
        n_w = 2
    name = fn.__name__
    route = m.ffn_tail_plan(m_rows, d, f, dtype, gated=gated,
                            int8=int8)['route']
    require(route == ('tc' if dtype == torch.bfloat16 else 'cuda_core'),
            f'{name} m={m_rows} d={d} f={f} {dtype}: route {route}')
    got = fn(*args)
    want = ref(*args)
    sync()
    err = max_err(got, want)
    require(close(got, want, dtype) and bool(torch.isfinite(got).all()),
            f'{name} m={m_rows} d={d} f={f} {dtype}: err {err}')
    log(f'  {name} m={m_rows} d={d} f={f} {str(dtype):14s} [{route}] max '
        f'err {err:.3g} ({tol_str(dtype)})')
    res = dict(max_abs_err=err, route=route)
    if timer is not None:
        res['ms'] = timer.ms(lambda: fn(*args))
        res['plain_ms'] = timer.ms(lambda: ref(*args))
        wf = [dequant(w, dtype) for w in ws] if int8 else ws
        if gated:
            res['unfused_ms'] = timer.ms(lambda: res_ + (
                torch.nn.functional.silu(x @ wf[0]) * (x @ wf[1])) @ wf[2])
        else:
            res['unfused_ms'] = timer.ms(
                lambda: res_ + (torch.relu(x @ wf[0] + b1) @ wf[1] + b2))
        del wf
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(*args, got), n_w * 2 * m_rows * d * f, dtype)
        res['library_ms'] = None
        log_times(res)
    return res


# untimed bf16 tail edges: m from one row past the row groups of a warp
# (9, 17), around the tile rules (64, 65) to MAX_ROWS (256), for each form
# at OPT-125M's and LLaMA-7B's widths, and the int8 forms' padded strides
# (D 640 and d_ff 2,944: q1 [640, 3072], q2 [2944, 768])
FFN_EDGE_ROWS = (1, 9, 17, 64, 65, 256)


def check_ffn_edges(dtype):
    res = {}
    for gated, d, f in ((False, D, FF), (True, D_LL, FF_7B)):
        for int8 in (False, True):
            for m_rows in FFN_EDGE_ROWS:
                res[int8, gated, f'edge d={d} m={m_rows}'] = check_ffn(
                    dtype, d, f, int8=int8, gated=gated, m_rows=m_rows)
            if int8:
                res[int8, gated, 'edge padded d=640 f=2944'] = check_ffn(
                    dtype, 640, 2944, int8=True, gated=gated)
    return res


def check_attention_gqa(dtype, int8, dense, timer=None, nt=NT, pos0=PROMPT,
                        layers=4):
    """decode_attention_rows_q (int8 cache) or decode_attention_rows
    (bf16/f32 cache) vs its twin at Llama-3-8B's decode shape: B=8, 8 kv
    heads with G = 4 query rows each, d_head 128, 17 tiles a layer (max_len
    2176), slots at 2048-2055; dense tables (one row, tps 1) or sparse ones
    (per kv head: two random full tiles, then the write tile). With nt 97
    and slots at 12,280-12,287 the dense table has 96 tiles (12,288
    tokens): past the one-pass kernel's shared memory, the two-pass walk.
    The bf16/f32 cache's output is held to tight_tolerance."""
    from spt_proto_tpu_torch.ops import decode_attention as m
    g = gen(SEED + 11)
    b, kv, grp, dh = B, KV_38B, HEADS_LL // KV_38B, DH_LL
    n_all, base = layers * nt, layers // 2 * nt
    pos = pos0 + torch.arange(b, device=DEV, dtype=torch.int32)
    cur = (pos // TILE).long()
    if dense:
        tables, n_tiles = dense_tables(pos, nt, 1, base)
        width = 1
    else:
        full = torch.rand((b, kv, NT), generator=g, device=DEV)
        full = full.masked_fill(torch.arange(NT, device=DEV) >= cur[:, None,
                                                                   None], 2)
        pick = full.argsort(-1)[..., :NSEL - 1]
        tables = torch.cat([pick, cur[:, None, None].expand(b, kv, 1)],
                           -1).to(torch.int32) + base
        n_tiles = torch.full((b,), NSEL, device=DEV, dtype=torch.int32)
        width = N_SUB_LL
    q = randn(g, (b, kv, grp, dh), dtype)
    # a dense cache keeps one zero code column, which the kernels leave be
    cc = torch.randint(0, N_CODE if width > 1 else 1,
                       (b, kv, n_all, width, TILE), generator=g, device=DEV,
                       dtype=torch.int32)
    c_new = torch.randint(0, N_CODE if width > 1 else 1, (b, kv, width),
                          generator=g, device=DEV, dtype=torch.int32)
    tb = torch.full((b,), base, device=DEV, dtype=torch.int32)
    kw = dict(ps=TILE, tps=1, scale=dh ** -0.5, clamp=0.0 if dense else 10.0)
    if int8:
        kc, vc = (torch.randint(-127, 128, (b, kv, n_all, dh, TILE),
                                generator=g, device=DEV, dtype=torch.int8)
                  for _ in range(2))
        kvp = -(-kv // 8) * 8
        ksc, vsc = (torch.rand((b, n_all, kvp, TILE), generator=g,
                               device=DEV) * 0.05 for _ in range(2))
        kn, vn = (torch.randint(-127, 128, (b, kv, dh), generator=g,
                                device=DEV, dtype=torch.int8)
                  for _ in range(2))
        ksn, vsn = (torch.rand((b, kv), generator=g, device=DEV) * 0.05
                    for _ in range(2))
        args = [q, kc, vc, cc, ksc, vsc, tables, n_tiles, pos, kn, vn, c_new,
                ksn, vsn, tb]
        fn, ref = m.decode_attention_rows_q, m.decode_attention_rows_q_ref
        per_token = 2 * dh + 2 * 4                  # K, V int8 + 2 scales
    else:
        kc, vc = (randn(g, (b, kv, n_all, dh, TILE), dtype)
                  for _ in range(2))
        kn, vn = (randn(g, (b, kv, dh), dtype) for _ in range(2))
        args = [q, kc, vc, cc, tables, n_tiles, pos, kn, vn, c_new, tb]
        fn, ref = m.decode_attention_rows, m.decode_attention_rows_ref
        per_token = 2 * dh * q.element_size()
    ref_args = [a.clone() for a in args]
    got = fn(*args, **kw)
    want = ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    caches_equal = all(torch.equal(g_, w_) for g_, w_ in zip(got[1:],
                                                             want[1:]))
    walk = (m.q_route if int8 else m.rows_route)(dtype, grp, dh, TILE,
                                                  tables.shape[2])
    require((walk == 'split') == (dtype == torch.bfloat16),
            f'{"int8" if int8 else "bf16/f32"} cache G={grp} {dtype}: '
            f'route {walk}')
    label = (f'{fn.__name__} G={grp} {"dense" if dense else "sparse"} '
             f'(T={int(n_tiles.max())}, {walk})')
    tol = None if int8 else tight_tolerance(want[0], dtype)
    require(close(got[0], want[0], dtype, tol) and caches_equal
            and bool(torch.isfinite(got[0]).all()),
            f'{label} {dtype}: o err {err}, appended caches equal: '
            f'{caches_equal}')
    log(f'  {label} {str(dtype):14s} o max err {err:.3g} '
        f'({tol_str(dtype, tol)}); appended caches exact')
    res = dict(max_abs_err=err, walk=walk)
    if timer is not None:
        res['ms'] = timer.ms(lambda: fn(*args, **kw))
        res['plain_ms'] = timer.ms(lambda: ref(*ref_args, **kw), reps=5)
        tokens = covered_tokens(tables, n_tiles, pos, tb, 1, kv)
        new = [kn, vn] + ([ksn, vsn] if int8 else [])
        io = nbytes(q, tables, n_tiles, pos, c_new, tb, got[0], *new)
        res['bound_ms'], res['bound_by'] = bound_ms(
            tokens * per_token + io, tokens * 2 * 2 * dh * grp,
            torch.int8 if int8 else dtype)
        res['library_ms'] = None
        log_times(res)
    return res


def attention_q_case(label, dtype, grp, dh, kv, pos, tables, n_tiles,
                     tps=1, nt=NT, layers=2, width=N_SUB_LL, timer=None,
                     seed=SEED + 12):
    """decode_attention_rows_q vs its twin on int8 caches of `layers` x nt
    tiles (the middle layer's tiles at base), slots at `pos`, the given
    PHYSICAL tables [B, N_TAB, T] and n_tiles, on the kernel q_route names
    (asserted: bf16 the split walk); timed when timer is given."""
    from spt_proto_tpu_torch.ops import decode_attention as m
    g = gen(seed)
    b = pos.shape[0]
    n_all, base = layers * nt, layers // 2 * nt
    q = randn(g, (b, kv, grp, dh), dtype)
    kc, vc = (torch.randint(-127, 128, (b, kv, n_all, dh, TILE), generator=g,
                            device=DEV, dtype=torch.int8) for _ in range(2))
    kvp = -(-kv // 8) * 8
    ksc, vsc = (torch.rand((b, n_all, kvp, TILE), generator=g, device=DEV)
                * 0.05 for _ in range(2))
    ksc[:, :, kv:] = vsc[:, :, kv:] = 0.0
    cc = torch.randint(0, N_CODE if width > 1 else 1,
                       (b, kv, n_all, width, TILE), generator=g, device=DEV,
                       dtype=torch.int32)
    c_new = torch.randint(0, N_CODE if width > 1 else 1, (b, kv, width),
                          generator=g, device=DEV, dtype=torch.int32)
    kn, vn = (torch.randint(-127, 128, (b, kv, dh), generator=g, device=DEV,
                            dtype=torch.int8) for _ in range(2))
    ksn, vsn = (torch.rand((b, kv), generator=g, device=DEV) * 0.05
                for _ in range(2))
    tb = torch.full((b,), base, device=DEV, dtype=torch.int32)
    tables = tables.to(torch.int32)
    args = [q, kc, vc, cc, ksc, vsc, tables, n_tiles.to(torch.int32),
            pos.to(torch.int32), kn, vn, c_new, ksn, vsn, tb]
    kw = dict(ps=TILE, tps=tps, scale=dh ** -0.5, clamp=10.0)
    route = m.q_route(dtype, grp, dh, TILE, tables.shape[2] * tps)
    require(route == ('split' if dtype == torch.bfloat16
                      else m.rows_walk(grp, dh, TILE, tables.shape[2] * tps,
                                       1)), f'{label}: route {route}')
    ref_args = [a.clone() for a in args]
    got = m.decode_attention_rows_q(*args, **kw)
    want = m.decode_attention_rows_q_ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    caches_equal = all(torch.equal(g_, w_) for g_, w_ in zip(got[1:],
                                                             want[1:]))
    require(close(got[0], want[0], dtype, output_tolerance(want[0], dtype))
            and caches_equal and bool(torch.isfinite(got[0]).all()),
            f'{label} {dtype}: o err {err}, appended caches equal: '
            f'{caches_equal}')
    log(f'  decode_attention_rows_q {label} ({route}) {str(dtype):14s} o '
        f'max err {err:.3g} '
        f'({tol_str(dtype, output_tolerance(want[0], dtype))}); appended '
        f'caches exact')
    res = dict(max_abs_err=err, walk=route)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.decode_attention_rows_q(*args, **kw))
        res['plain_ms'] = timer.ms(
            lambda: m.decode_attention_rows_q_ref(*ref_args, **kw), reps=5)
        tokens = covered_tokens(tables, args[7], args[8], tb, tps, kv)
        io = nbytes(q, tables, args[7], args[8], c_new, tb, got[0], kn, vn,
                    ksn, vsn)
        res['bound_ms'], res['bound_by'] = bound_ms(
            tokens * (2 * dh + 2 * 4) + io, tokens * 2 * 2 * dh * grp,
            torch.int8)
        res['library_ms'] = None
        log_times(res)
    return res


def sparse_rows(pos, kv, n_sel, base, g, n_tab=None):
    """Per table row (kv, or n_tab rows): n_sel - 1 distinct random full
    tiles, then the write tile; physical ids from base."""
    b = pos.shape[0]
    rows = n_tab or kv
    cur = (pos // TILE).long()
    full = torch.rand((b, rows, NT), generator=g, device=DEV)
    full = full.masked_fill(torch.arange(NT, device=DEV)
                            >= cur[:, None, None], 2)
    pick = full.argsort(-1)[..., :n_sel - 1]
    return torch.cat([pick, cur[:, None, None].expand(b, rows, 1)],
                     -1) + base


def check_attention_edges(dtype, timer=None):
    """decode_attention_rows_q's edges, each vs its twin on the route
    q_route names (and timed when timer is given), at d_head 128 unless
    said: -1 entries and entries past n_tiles; the new token at lane 0 and
    at lane PS - 1; grouped table rows (one row for two kv heads); dense
    supertiles of 4 through one table row at G = 4; G = 1 and G = 8."""
    g = gen(SEED + 13)
    base = NT                                  # layers=2: the second layer
    pos = PROMPT + torch.arange(B, device=DEV, dtype=torch.int32)
    n3 = torch.full((B,), NSEL, device=DEV, dtype=torch.int32)
    res = {}
    # -1 entries and one past n_tiles: [t, -1, t', write tile, t'']
    t5 = sparse_rows(pos, KV_38B, 4, base, g)
    tables = torch.stack([t5[..., 0], torch.full_like(t5[..., 0], -1),
                          t5[..., 1], t5[..., 3], t5[..., 2]], -1)
    res['-1 and past n_tiles'] = attention_q_case(
        '-1 / past-n_tiles entries G=4', dtype, 4, DH_LL, KV_38B, pos, tables,
        torch.full((B,), 4, device=DEV, dtype=torch.int32), timer=timer)
    for lane in (0, TILE - 1):
        p_ = 15 * TILE + lane + 0 * pos
        res[f'new token lane {lane}'] = attention_q_case(
            f'new token at lane {lane} G=4', dtype, 4, DH_LL, KV_38B, p_,
            sparse_rows(p_, KV_38B, NSEL, base, g), n3, timer=timer)
    res['grouped rows'] = attention_q_case(
        'grouped rows (N_TAB = KV / 2) G=4', dtype, 4, DH_LL, KV_38B, pos,
        sparse_rows(pos, KV_38B, NSEL, base, g, n_tab=KV_38B // 2), n3,
        timer=timer)
    p4 = PROMPT - B + torch.arange(B, device=DEV, dtype=torch.int32)
    t4, n4 = dense_tables(p4, PROMPT // TILE, 4, PROMPT // TILE)
    res['dense tps 4 G=4'] = attention_q_case(
        'dense supertiles of 4 G=4', dtype, 4, DH_LL, KV_38B, p4, t4, n4,
        tps=4, nt=PROMPT // TILE, width=1, timer=timer)
    res['G=1'] = attention_q_case(
        'G=1 d_head 128', dtype, 1, DH_LL, 32, pos[:4],
        sparse_rows(pos[:4], 32, NSEL, base, g), n3[:4], timer=timer)
    res['G=8'] = attention_q_case(
        'G=8', dtype, 8, DH_LL, 4, pos, sparse_rows(pos, 4, NSEL, base, g),
        n3, timer=timer)
    return res


def verify_inputs(dtype, model, dense, g, kk=KK):
    """verify_attention_rows inputs at the speculative serving shape: B=8
    slots at positions 2046 + 3 x slot (slot 0's block of K = 5 crosses the
    tile boundary at 2048, so its two write tiles differ; the others repeat
    one), 2 layers of 18 tiles (max_len 2304) with the second addressed.
    Tables and bits come from the engine's own table code over a random
    decode selection per block position (2 full tiles below its own, then
    its own: sparse_coeff 8 at 18 tiles), or dense."""
    kv, grp, dh, n_sub = ((HEADS, 1, DH, N_SUB) if model == 'opt-125m' else
                          (KV_38B, HEADS_LL // KV_38B, DH_LL, N_SUB_LL))
    pos = PROMPT - 2 + 3 * torch.arange(B, device=DEV, dtype=torch.int32)
    return verify_case_inputs(dtype, grp, dh, kv, kk, pos, NT_SPEC, dense,
                              n_sub, g)


def verify_case_inputs(dtype, grp, dh, kv, kk, pos, nt, dense, n_sub, g,
                       ps=TILE, zero_bits=False, plant=False):
    """verify_attention_rows inputs over 2 layers of nt tiles of ps tokens
    (the second addressed), slots at `pos`: the engine's own tables and
    bits (_Block) over a random decode selection per block position, or
    dense; at ps != TILE (the engine's tile), dense tables made here.
    zero_bits: one selected entry of every row keeps its tile but gets
    sel_mask 0; plant: each row's first query group's max key at lane 50
    of its table's first entry (a chunk other than the write tiles')."""
    from spt_proto_tpu_torch.inference.engine import _Block
    b, base = pos.shape[0], nt
    nsel = min(nt, max(1, nt // 8) + 1)
    if ps == TILE:
        keep = None
        if not dense:
            ar = torch.arange(nt, device=DEV)
            own = (pos.long()[:, None] + torch.arange(kk, device=DEV)) // ps
            r = torch.rand((b, kv, kk, nt), generator=g, device=DEV)
            r = r.masked_fill(ar >= own[:, None, :, None], 2.0)
            keep = torch.zeros(r.shape, dtype=torch.bool, device=DEV)
            keep.scatter_(-1, r.argsort(-1)[..., :nsel - 1], True)
            keep |= ar == own[:, None, :, None]
        tables, bits = _Block(pos, kk, nt, kv, nsel).tables(keep, base)
    else:
        w0, w1 = pos.long() // ps, (pos.long() + kk - 1) // ps
        ar = torch.arange(nt, device=DEV)
        ent = torch.where(ar < w0[:, None], ar + base, -1)
        tables = torch.cat([ent, (w0 + base)[:, None], (w1 + base)[:, None]],
                           -1)[:, None].expand(b, kv, -1).contiguous()
        bits = torch.full(tables.shape, (1 << kk) - 1, device=DEV)
        bits[..., -2] = torch.where(w0 == w1, 0, (1 << kk) - 1)[:, None]
        tables, bits = tables.to(torch.int32), bits.to(torch.int32)
    if zero_bits:
        bits = bits.clone()
        bits[..., 0] = torch.where(tables[..., 0] >= 0, 0, bits[..., 0])
    width = 1 if dense else n_sub
    q = randn(g, (b, kv, grp * kk, dh), dtype)
    kc, vc = (randn(g, (b, kv, 2 * nt, dh, ps), dtype) for _ in range(2))
    if plant:
        top = (q.float()[:, :, :kk].mean(2) * (0.75 * kk)).to(dtype)
        at = tables[..., 0].long().clamp(min=0)
        bi = torch.arange(b, device=DEV)[:, None]
        hi = torch.arange(kv, device=DEV)[None]
        kc[bi, hi, at, :, 50] = top
    cc = torch.randint(0, N_CODE if width > 1 else 1,
                       (b, kv, 2 * nt, width, ps), generator=g, device=DEV,
                       dtype=torch.int32)
    kn, vn = (randn(g, (b, kv, dh, kk), dtype) for _ in range(2))
    cn = torch.randint(0, N_CODE if width > 1 else 1, (b, kv, width, kk),
                       generator=g, device=DEV, dtype=torch.int32)
    tb = torch.full((b,), base, device=DEV, dtype=torch.int32)
    return [q, kc, vc, cc, tables, bits, pos, kn, vn, cn, tb]


def verify_work(args):
    """(entries read, visible (row, lane) pairs) of one verify launch: an
    entry is read when its tile id is valid and some block position sees
    it; row r (position j = r % K) sees a lane of it when bit j is set and
    the lane's position is <= pos + j."""
    q, tables, bits, pos, tb = args[0], args[4], args[5], args[6], args[10]
    n_all, ps = args[1].shape[2], args[1].shape[4]
    j = torch.arange(q.shape[2], device=q.device) % args[7].shape[3]
    valid = (tables >= 0) & (tables < n_all) & (bits != 0)
    seen = ((bits[:, :, None, :] >> j[:, None]) & 1).bool() \
        & valid[:, :, None]                                  # [B,KV,GK,T]
    first = (tables.long() - tb.long()[:, None, None]) * ps  # [B, KV, T]
    lanes = (pos.long()[:, None, None, None] + j[:, None] - first[:, :, None]
             + 1).clamp(0, ps)
    return int(valid.sum()), int((lanes * seen).sum())


def verify_case(label, dtype, args, clamp, timer=None, off_rule=False):
    """verify_attention_rows vs its twin on the kernel verify_route names
    (asserted: bf16 the split walk, or with off_rule the walk kernel; f32
    the walk kernel). Kernel and twin round e at the same place (the TPU
    kernel's numerics): f32 to 1e-5, bf16 to tight_tolerance; the appended
    caches and codes must be exact. The launch is repeated with its rows in
    groups of 8 (the split walk's VERIFY_ROWS, the walk kernel's
    verify_rows_per_cta), which must give the same output and caches bit
    for bit (each row's arithmetic does not depend on its CTA's other
    rows). Timed when timer is given, beside dense SDPA of the same query
    rows over as many contiguous tokens as the fullest row reads, the K
    block positions' causal offsets as its mask."""
    from spt_proto_tpu_torch.ops import decode_attention as m
    q, kn = args[0], args[7]
    gk, d, kk = q.shape[2], q.shape[3], kn.shape[3]
    ps = args[1].shape[4]
    kw = dict(ps=ps, scale=d ** -0.5, clamp=clamp)
    aligned = all(a.data_ptr() % 16 == 0 for a in args[1:3])
    route = m.verify_route(dtype, gk // kk, d, ps, kk, aligned)
    require(route == ('split' if dtype == torch.bfloat16 and not off_rule
                      else 'walk'), f'{label}: route {route}')
    split_args = [a.clone() for a in args]
    ref_args = [a.clone() for a in args]
    m.verify_attention_rows.launches = 0
    got = m.verify_attention_rows(*args, **kw)
    require(m.verify_attention_rows.launches == 1, f'{label}: launches')
    want = m.verify_attention_rows_ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    caches_equal = all(torch.equal(g_, w_) for g_, w_ in zip(got[1:],
                                                             want[1:]))
    tables = args[4]
    t_max = tables.shape[2]
    if route == 'split':
        groups, rows, chunks, e = m.verify_split_plan(gk, t_max, d)
        how = (f'{groups} group(s) of {rows} rows, {chunks} chunk(s) of {e} '
               f'entries')
    else:
        rows = m.verify_rows_per_cta(gk, d, ps, t_max, q.element_size())
        how = f'{-(-gk // rows)} chunk(s) of {rows} rows'
    label = f'verify_attention_rows {label} (GK={gk}, T={t_max}, {how})'
    tol = tight_tolerance(want[0], dtype)
    require(close(got[0], want[0], dtype, tol) and caches_equal
            and bool(torch.isfinite(got[0]).all()),
            f'{label} {dtype}: o err {err}, appended caches equal: '
            f'{caches_equal}')
    if route == 'split':
        orig = m.VERIFY_ROWS
        m.VERIFY_ROWS = 8
        m.verify_split_plan.cache_clear()
    else:
        orig = m.verify_rows_per_cta
        m.verify_rows_per_cta = lambda *a: 8
    try:
        split = m.verify_attention_rows(*split_args, **kw)
    finally:
        if route == 'split':
            m.VERIFY_ROWS = orig
            m.verify_split_plan.cache_clear()
        else:
            m.verify_rows_per_cta = orig
    sync()
    require(all(torch.equal(a, b_) for a, b_ in zip(split, got)),
            f'{label} {dtype}: rows in groups of 8 differ from the launch')
    log(f'  {label} {str(dtype):14s} o max err {err:.3g} '
        f'({tol_str(dtype, tol)}); appended caches exact; rows in groups '
        f'of 8: bit-identical')
    res = dict(max_abs_err=err, route=route, rows_per_cta=rows)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.verify_attention_rows(*args, **kw))
        res['plain_ms'] = timer.ms(
            lambda: m.verify_attention_rows_ref(*ref_args, **kw), reps=5)
        entries, pairs = verify_work(args)
        kv_bytes = entries * 2 * d * ps * q.element_size()
        new = [args[7], args[8]] + ([args[9]] if args[3].shape[3] > 1 else [])
        io = nbytes(q, *args[4:7], args[10], got[0], *new)
        res['bound_ms'], res['bound_by'] = bound_ms(
            kv_bytes + io, pairs * 2 * 2 * d, dtype)
        # the fullest row's tokens, the block's query columns as SDPA's
        # query positions (G K rows -> G heads x K positions)
        b, kv = tables.shape[:2]
        valid = (tables >= 0) & (tables < args[1].shape[2]) & (args[5] != 0)
        s_k = int(valid.sum(-1).max()) * ps
        q4 = q.reshape(b, kv * (gk // kk), kk, d)
        mask = (torch.arange(s_k, device=DEV)[None]
                <= s_k - kk + torch.arange(kk, device=DEV)[:, None])
        res['library_ms'] = sdpa_yardstick(timer, q4, kv, s_k, mask)
        res['library'] = ('SDPA, contiguous K/V, causal offsets (no table '
                          'gather)')
        res.update(entries_read=entries, visible_pairs=pairs)
        log_times(res)
    return res


def check_verify(dtype, model, dense, timer=None, kk=KK):
    """verify_attention_rows vs its twin at the speculative serving shape
    (verify_inputs): OPT-125M (12 heads, d_head 64) or Llama-3-8B (8 kv
    heads of G = 4, d_head 128), union or dense tables, a block of kk
    columns (slot 0's across a tile boundary, its two write tiles
    differing), verify_case's route and bounds."""
    args = verify_inputs(dtype, model, dense, gen(SEED + 12), kk)
    tables = args[4]
    require(bool((tables[:, 0, -2] != tables[:, 0, -1]).any()),
            'a block across a tile boundary')
    return verify_case(f'{model} {"dense" if dense else "union"}', dtype,
                       args, 0.0 if dense else 10.0, timer)


def check_verify_edges(dtype):
    """verify_attention_rows' edges, each vs its twin on the route
    verify_route names: K = 1 and K = 30 at G = 8 (240 rows: 4 row groups),
    d_head 64 and 128, clamp on and off, an entry with sel_mask 0 in every
    row, a dense T = 96 table, each row's max planted in its first entry's
    chunk; in bf16, the call off the rule too: tiles of 64 tokens take the
    walk kernel."""
    g = gen(SEED + 42)
    res = {}
    pos = PROMPT - 2 + 3 * torch.arange(4, device=DEV, dtype=torch.int32)
    for kk, grp, dh, kv, dense, clamp in (
            (1, 8, DH_LL, 2, False, 10.0), (30, 8, DH_LL, 2, False, 0.0),
            (30, 8, DH, 2, True, 10.0), (5, 4, DH_LL, 2, False, 0.0),
            (1, 1, DH, 3, True, 0.0)):
        name = (f'K={kk} G={grp} d {dh} {"dense" if dense else "union"} '
                f'clamp {clamp:g}, a sel_mask-0 entry, max planted')
        args = verify_case_inputs(dtype, grp, dh, kv, kk, pos, NT_SPEC,
                                  dense, N_SUB_LL, g, zero_bits=not dense,
                                  plant=True)
        res[name] = verify_case(name, dtype, args, clamp)
    p96 = 96 * TILE - 2 + torch.arange(2, device=DEV, dtype=torch.int32)
    args = verify_case_inputs(dtype, 4, DH_LL, 2, KK, p96, 97, True,
                              N_SUB_LL, g)
    res['dense T=96'] = verify_case('dense T=96 G=4', dtype, args, 0.0)
    if dtype == torch.bfloat16:
        args = verify_case_inputs(dtype, 4, DH_LL, 2, KK, pos, 2 * NT_SPEC,
                                  True, N_SUB_LL, g, ps=64)
        res['off rule ps 64'] = verify_case(
            'off rule: tiles of 64 tokens G=4', dtype, args, 0.0,
            off_rule=True)
    return res


PAGED_PS = 64                                  # the engine's page size


def paged_inputs(dtype, model, int8, g):
    """paged_attention inputs at the serving shape: B=8 slots at lengths
    2041-2048 over pages of 64 tokens (34 a slot, max_len 2176), OPT-125M
    (12 heads of d_head 64) or Llama-3-8B (8 kv heads of G = 4, d_head
    128); pools of one layer's pages plus the sink page, each slot's pages
    a random disjoint set; slot 0 is a released lane (its whole table -1,
    read through the sink as the engine builds it). int8 pages come from
    the engine's own quantization of random values."""
    kv, grp, dh = ((HEADS, 1, DH) if model == 'opt-125m' else
                   (KV_38B, HEADS_LL // KV_38B, DH_LL))
    lengths = PROMPT - B + 1 + torch.arange(B, device=DEV, dtype=torch.int32)
    return paged_case_inputs(dtype, grp, dh, kv, PAGED_PS, int8, lengths,
                             -(-MAX_LEN // PAGED_PS), g, sink_slot=True)


def paged_case_inputs(dtype, grp, dh, kv, ps, int8, lengths, pps, g,
                      sink_slot=False, neg_ids=0, plant=False):
    """paged_attention inputs: q [B, kv * grp, dh], pools of B * pps pages
    of ps tokens plus a sink page, each slot's table a random disjoint set
    of pages (sink_slot: slot 0's whole table the sink, a released lane;
    neg_ids: that many of slot 1's pages inside its length -1, read as page
    0); plant: each slot's key at its position length - 2 (in its last
    chunk) made each row's max (~0.75 sqrt(dh) against ~N(0, 1)); int8
    pages from the engine's own quantization of random f32 values.
    Returns (args, scales kw)."""
    from spt_proto_tpu_torch.inference.paged import _quantize_pages
    b = lengths.shape[0]
    n_pages = b * pps + 1
    sink = n_pages - 1
    q = randn(g, (b, kv * grp, dh), dtype)
    k, v = (randn(g, (kv, n_pages, ps, dh), torch.float32)
            for _ in range(2))
    tables = torch.randperm(b * pps, generator=g, device=DEV).reshape(
        b, pps).to(torch.int32)
    if plant:
        at = (lengths.long() - 2).clamp(min=0)
        page = tables.gather(1, (at // ps)[:, None])[:, 0].long()
        top = q.float().reshape(b, kv, grp, dh).mean(2) * (0.75 * grp)
        for i in range(b):
            k[:, page[i], int(at[i]) % ps] = top[i]
    if sink_slot:
        tables[0] = sink
    if neg_ids:
        n_in = max(1, int(lengths[1]) // ps)
        tables[1, :min(neg_ids, n_in)] = -1
    if int8:
        (k, ks), (v, vs) = _quantize_pages(k), _quantize_pages(v)
        return [q, k, v, lengths, tables], dict(k_scales=ks, v_scales=vs)
    return [q, k.to(dtype), v.to(dtype), lengths, tables], {}


def sdpa_yardstick(timer, q4, kv_heads, s_k, mask=None):
    """The library yardstick of a decode attention kernel: dense SDPA of
    the same query rows q4 [B, H, s_q, d] over s_k contiguous tokens of
    random K / V (the kv heads repeated to H outside the timed call; mask:
    a boolean [s_q, s_k]). Not the same function: no one call does the
    page or table gather."""
    b, h, _, d = q4.shape
    g = gen(SEED + 40)
    k, v = (randn(g, (b, kv_heads, s_k, d), q4.dtype)
            .repeat_interleave(h // kv_heads, 1) for _ in range(2))
    return timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask))


def paged_case(label, dtype, args, sc, timer=None):
    """paged_attention vs its plain twin (the JAX oracle, int8 pages read
    back as (x h) / 127.5 in q's dtype) on the kernel paged_route names
    (asserted: bf16 the split walk, with paged_split_plan's chunks; f32 the
    two-pass walk): f32 to 1e-5, int8 pages too (kernel and twin round the
    same dequantized values to f32; only the sums run in another order);
    bf16, fp or int8 pages, to tight_tolerance. Timed when timer is given,
    beside dense SDPA of the same query rows over the longest slot's
    tokens."""
    from spt_proto_tpu_torch.ops import paged_attention as m
    q, k = args[0], args[1]
    kv, ps, dh = k.shape[0], k.shape[2], k.shape[3]
    pps = args[4].shape[1]
    scale = dh ** -0.5
    route = m.paged_route(dtype)
    require(route == ('split' if dtype == torch.bfloat16 else 'walk'),
            f'{label}: route {route}')
    m.paged_attention.launches = 0
    got = m.paged_attention(*args, scale=scale, **sc)
    require(m.paged_attention.launches == 1, f'{label}: launches')

    def plain():
        return m.paged_attention_ref(*args, scale=scale, **sc)
    want = plain()
    sync()
    err = max_err(got, want)
    tol = tight_tolerance(want, dtype)
    plan = (m.paged_split_plan(pps, ps, k.dtype == torch.int8)
            if route == 'split' else None)
    label = (f'paged_attention {label} ({route}'
             + (f', {plan[0]} chunks of {plan[1] * m.PAGED_STEP} positions'
                if plan else '') + ')')
    require(close(got, want, dtype, tol) and bool(torch.isfinite(got).all()),
            f'{label} {dtype}: o err {err}')
    log(f'  {label} {str(dtype):14s} o max err {err:.3g} '
        f'({tol_str(dtype, tol)})')
    res = dict(max_abs_err=err, route=route)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.paged_attention(*args, scale=scale,
                                                       **sc))
        res['plain_ms'] = timer.ms(plain, reps=5)
        # each valid token's k and v (and int8 scales) read once
        tokens = int(args[3].clamp(max=pps * ps).sum())
        int8 = k.dtype == torch.int8
        per_token = kv * (2 * dh * k.element_size() + (8 if int8 else 0))
        io = nbytes(q, args[3], args[4], got)
        res['bound_ms'], res['bound_by'] = bound_ms(
            tokens * per_token + io, tokens * q.shape[1] * 2 * 2 * dh,
            torch.int8 if int8 else dtype)
        res['library_ms'] = sdpa_yardstick(
            timer, q[:, :, None], kv, int(args[3].max()))
        res['library'] = 'SDPA, contiguous K/V (no page gather)'
        log_times(res)
    return res


def check_paged(dtype, model, int8, timer=None):
    """paged_attention (the stock paged-attention kernel's port) vs its
    plain twin at the serving shape (paged_inputs), paged_case's route and
    bounds."""
    args, sc = paged_inputs(dtype, model, int8, gen(SEED + 13))
    q, k = args[0], args[1]
    return paged_case(f'{model} {"int8" if int8 else "fp"} pages '
                      f'(G={q.shape[1] // k.shape[0]}, ps {PAGED_PS}, a '
                      f'released slot)', dtype, args, sc, timer)


def check_paged_edges(dtype):
    """paged_attention's edges, each vs its twin on the route paged_route
    names: pages of 16 and 128 tokens, d_head 64 and 128, G = 1, 4 and 8,
    fp and int8 pages; lengths of 1 and not a multiple of the page size;
    -1 page ids inside a slot's length; a released slot read through the
    sink; 16,384 positions (8 chunks of 2,048) and 49,152 at G = 8 (the
    chunks' scores in the global buffer); each slot's max planted in its
    last chunk."""
    g = gen(SEED + 41)
    res = {}
    ln = torch.tensor([1, 63, 64, 65, 1000, 2047], device=DEV,
                      dtype=torch.int32)
    for ps, grp, dh, kv in ((16, 1, DH, 4), (128, 4, DH_LL, 2),
                            (16, 8, DH_LL, 1), (128, 8, DH, 2),
                            (64, 4, DH, 3)):
        for int8 in (False, True):
            name = (f'ps {ps} G={grp} d {dh} {"int8" if int8 else "fp"} '
                    f'lengths 1-2047, -1 ids, sink, max in the last chunk')
            args, sc = paged_case_inputs(
                dtype, grp, dh, kv, ps, int8, ln, -(-2048 // ps), g,
                sink_slot=True, neg_ids=2, plant=True)
            res[name] = paged_case(name, dtype, args, sc)
    for n, grp, ps in ((16384, 4, 64), (49152, 8, 128)):
        lens = n - torch.arange(2, device=DEV, dtype=torch.int32)
        for int8 in (False, True):
            name = f'{n} positions G={grp} ps {ps} {"int8" if int8 else "fp"}'
            args, sc = paged_case_inputs(dtype, grp, DH_LL, 1, ps, int8, lens,
                                         n // ps, g, plant=True)
            res[name] = paged_case(name, dtype, args, sc)
    return res


def check_tile_pool(dtype, timer=None):
    """decode_attention (the tile-pool kernel of decode_attention.py:156)
    vs its plain twin at the OPT-125M decode shape: BK = 96 (slot, head)
    rows of G = 1, d_head 64, tiles of 128 tokens, context 2041-2048 (17
    tiles a row, disjoint; row 1's first entry -1, read as the pool's last
    tile as the twin wraps it), the new token appended at the last entry;
    the appended pools must be exact. bf16 o to one bf16 step of the
    output (output_tolerance)."""
    from spt_proto_tpu_torch.ops import decode_attention as m
    g = gen(SEED + 14)
    bk, grp, dh, t_max = B * HEADS, 1, DH, NT
    n_pool = bk * t_max
    q = randn(g, (bk, grp, dh), dtype)
    kp, vp = (randn(g, (n_pool, dh, TILE), dtype) for _ in range(2))
    cp = torch.randint(0, N_CODE, (n_pool, N_SUB, TILE), generator=g,
                       device=DEV, dtype=torch.int32)
    tables = torch.randperm(n_pool, generator=g, device=DEV).reshape(
        bk, t_max).to(torch.int32)
    # row 1's first entry -1, read as tile n_pool - 1 (the twin's wrap):
    # that tile leaves the tables, so no row appends to it in this launch
    at = (tables == n_pool - 1).nonzero()[0]
    tables[at[0], at[1]] = tables[1, 0].clone()
    tables[1, 0] = -1
    pos = (PROMPT - B + torch.arange(B, device=DEV)).repeat_interleave(HEADS)
    n_tiles = (pos // TILE + 1).to(torch.int32)
    last = (pos % TILE + 1).to(torch.int32)
    wt = tables.gather(1, n_tiles.long()[:, None] - 1)[:, 0].contiguous()
    kn, vn = (randn(g, (bk, dh), dtype) for _ in range(2))
    cn = torch.randint(0, N_CODE, (bk, N_SUB), generator=g, device=DEV,
                       dtype=torch.int32)
    args = [q, kp, vp, cp, tables, n_tiles, last, kn, vn, cn, wt, last - 1]
    kw = dict(ps=TILE, scale=dh ** -0.5, clamp=10.0)
    ref_args = [a.clone() for a in args]
    got = m.decode_attention(*args, **kw)
    want = m.decode_attention_ref(*ref_args, **kw)
    sync()
    err = max_err(got[0], want[0])
    tol = output_tolerance(want[0], dtype)
    pools_equal = all(torch.equal(a, b_) for a, b_ in zip(got[1:], want[1:]))
    label = (f'decode_attention tile pool (BK {bk}, G {grp}, T {t_max}, '
             f'a -1 entry)')
    require(close(got[0], want[0], dtype, tol) and pools_equal
            and bool(torch.isfinite(got[0]).all()),
            f'{label} {dtype}: o err {err}, appended pools equal: '
            f'{pools_equal}')
    log(f'  {label} {str(dtype):14s} o max err {err:.3g} '
        f'({tol_str(dtype, tol)}); appended pools exact')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.decode_attention(*args, **kw))
        res['plain_ms'] = timer.ms(lambda: m.decode_attention_ref(
            *ref_args, **kw), reps=5)
        tokens = int(((n_tiles.long() - 1) * TILE + last).sum())
        io = nbytes(q, tables, n_tiles, last, kn, vn, cn, wt, got[0])
        res['bound_ms'], res['bound_by'] = bound_ms(
            tokens * 2 * dh * q.element_size() + io,
            tokens * grp * 2 * 2 * dh, dtype)
        res['library_ms'] = None     # no one call does the table gather
        log_times(res)
    return res


def chosen_logit_gap(logits, ids, dtype):
    """How far below the maximum the chosen logit lies, per row, and the
    bound it is held to: exact expected, but where a kernel's f32 sum rounds
    a logit to the other side of a serving-dtype step a tie can resolve
    differently, so the chosen logit must lie within one step of the
    maximum. Returns (gap, bound, relative step)."""
    gap = (logits.max(-1).values
           - logits.gather(1, ids.long()[:, None])[:, 0]).abs()
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    return gap, logits.abs().max(-1).values * rel, rel


def head_rate(res, n_bytes) -> None:
    """The bytes a timed head call must move over its time: GB/s, and the
    share of the 3.35 TB/s line; logged."""
    res['gb_s'] = n_bytes / res['ms'] / 1e6
    res['hbm_share'] = res['gb_s'] * 1e9 / HBM_BYTES_PER_S
    log(f'      {res["gb_s"]:.0f} GB/s = {res["hbm_share"]:.3f} of '
        f'{HBM_BYTES_PER_S / 1e12:g} TB/s')


def check_lm_head(dtype, timer=None, d=D, vocab=VOCAB, b=B):
    """lm_head_argmax vs its twin: x [b, d] @ w [d, vocab] (OPT-125M's head,
    or LLaMA's at d 4096 with the 128,256 or the 32,000 vocabulary)."""
    from spt_proto_tpu_torch.ops import lm_head as m
    g = gen(SEED + 3)
    x = randn(g, (b, d), dtype)
    w = randn(g, (d, vocab), dtype, std=d ** -0.5)
    got = m.lm_head_argmax(x, w)
    want = m.lm_head_argmax_ref(x, w)
    sync()
    logits = (x.float() @ w.float()).to(dtype).float()
    gap, step, rel = chosen_logit_gap(logits, got, dtype)
    err = gap.max().item()
    label = f'lm_head_argmax B={b} d={d} V={vocab}'
    require(bool((gap <= step).all()) and got.dtype == torch.int32,
            f'{label} {dtype}: ids {got.tolist()} vs {want.tolist()}')
    log(f'  {label} {str(dtype):14s} ids equal: '
        f'{torch.equal(got, want)}; chosen-logit gap {err:.3g} (tol '
        f'{rel:g}|max logit|)')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.lm_head_argmax(x, w))
        res['plain_ms'] = timer.ms(lambda: m.lm_head_argmax_ref(x, w))
        res['library_ms'] = timer.ms(lambda: torch.argmax(x @ w, -1))
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(x, w, got), 2 * b * d * vocab, dtype)
        log_times(res)
        head_rate(res, nbytes(x, w, got))
    return res


# the heads' edge cases: LLaMA-13B's d_model (config.py, the widest the
# repo configures) over OPT's vocabulary (50,272: the last 128-column tile
# is ragged), at B 1, 4, 8, 13 (a ragged n8 group) and 40 (row groups of 16)
HEAD_EDGE_D, HEAD_EDGE_B = 5120, (1, 4, 8, 13, 40)


def head_edge_inputs(dtype, int8):
    """Integer-valued x [40, d] and head [d, V] (int8: {'q' [d, V padded to
    256], 'scale' [1, V] of powers of two}) with planted winners, so that
    every logit is exact and planted ties are real ties. Returns (x, w,
    {row: the id that must win})."""
    v = VOCAB
    g = gen(SEED + 12)
    x = torch.randint(-3, 4, (max(HEAD_EDGE_B), HEAD_EDGE_D), generator=g,
                      device=DEV).float()
    v_pad = -(-v // 256) * 256 if int8 else v
    w = torch.randint(-3, 4, (HEAD_EDGE_D, v_pad), generator=g,
                      device=DEV).float()
    plant = {0: (300, 700),        # a tie across two CTA tiles
             1: (v - 1,),          # the last true column (ragged tile)
             2: (1030, 1100),      # a tie inside one tile, two warps
             3: (2049, 2057),      # one fragment: a thread's rows g, g + 8
             4: (2050, 2051),      # one fragment: int8's columns 2c, 2c + 1
             9: (40000, 45000),    # the second n8 group, across tiles
             12: (50200, 50201),   # the ragged last tile, one fragment
             35: (600, 601)}       # the third row group of 16
    for r, cols in plant.items():
        for c in cols:
            w[:, c] = 20 * x[r]
    want = {r: min(cols) for r, cols in plant.items()}
    x = x.to(dtype)
    if not int8:
        return x, w.to(dtype), want
    w[:, v:] = 40 * x[1].float()[:, None]   # pad columns: row 1 wins if read
    scale = 2.0 ** torch.randint(-7, -4, (1, v), generator=g, device=DEV)
    for cols in plant.values():
        scale[0, list(cols)] = 2.0 ** -6
    return x, {'q': w.to(torch.int8), 'scale': scale.float()}, want


def check_lm_head_edges(dtype):
    """Both heads on head_edge_inputs at every HEAD_EDGE_B: the ids must
    equal the twin's and the planted winners exactly; then random inputs
    at the same shapes by the chosen-logit rule (untimed). Returns, by
    head, the planted rows and the random inputs' largest chosen-logit
    gap."""
    from spt_proto_tpu_torch.ops import lm_head as m
    res = {}
    for int8 in (False, True):
        fn, ref = ((m.lm_head_argmax_int8, m.lm_head_argmax_int8_ref) if int8
                   else (m.lm_head_argmax, m.lm_head_argmax_ref))
        x, w, plant = head_edge_inputs(dtype, int8)
        for b in HEAD_EDGE_B:
            got = fn(x[:b].contiguous(), w)
            want = ref(x[:b].contiguous(), w)
            sync()
            planted = {r: got[r].item() for r in plant if r < b}
            require(torch.equal(got, want) and all(
                planted[r] == plant[r] for r in planted),
                f'{fn.__name__} {dtype} B={b} planted ties: ids '
                f'{got.tolist()} vs twin {want.tolist()}; planted rows '
                f'{planted} vs {plant}')
        log(f'  {fn.__name__} {str(dtype):14s} planted ties / ragged tile '
            f'/ pad columns, d={HEAD_EDGE_D} V={VOCAB}, B '
            f'{list(HEAD_EDGE_B)}: ids equal to the twin and the plants')
        del x, w
        errs = [(check_lm_head_int8(dtype, HEAD_EDGE_D, b=b) if int8
                 else check_lm_head(dtype, d=HEAD_EDGE_D, b=b))['max_abs_err']
                for b in HEAD_EDGE_B]
        res[fn.__name__] = {f'edges d={HEAD_EDGE_D} V={VOCAB}': dict(
            batch_sizes=list(HEAD_EDGE_B), planted=plant,
            random_max_abs_err=max(errs))}
    return res


# the heads' value output at the serving widths and at the shard widths of
# phase 13 (a vocabulary split over 'model' = 2): (d, V)
HEAD_VALUE_SHAPES = ((D, VOCAB), (D, VOCAB // 2), (D_LL, VOCAB_7B),
                     (D_LL, VOCAB_7B // 2))


def check_head_values(dtype):
    """Both heads with value=True, the logit each row chose (what a
    vocab-parallel head's ranks compare, engine._greedy_head), at
    HEAD_VALUE_SHAPES, B=8: the ids by the chosen-logit rule and the value
    within one step of the twin's value of the kernel's id, which is the
    dtype-rounded logit there (f32: within the f32 bound). Returns, by
    head, the largest value error."""
    from spt_proto_tpu_torch.ops import lm_head as m
    res = {}
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    for int8 in (False, True):
        name = 'lm_head_argmax_int8' if int8 else 'lm_head_argmax'
        worst = 0.0
        for d, v in HEAD_VALUE_SHAPES:
            g = gen(SEED + 14)
            x = randn(g, (B, d), dtype)
            if int8:
                w = int8_weight(g, d, v, dtype)
                ids, val = m.lm_head_argmax_int8(x, w, value=True)
                logits = m.int8_head_logits(x, w['q'], w['scale'])
                r_ids, r_val = m.lm_head_argmax_int8_ref(x, w, value=True)
            else:
                w = randn(g, (d, v), dtype, std=d ** -0.5)
                ids, val = m.lm_head_argmax(x, w, value=True)
                logits = (x.float() @ w.float()).to(dtype).float()
                r_ids, r_val = m.lm_head_argmax_ref(x, w, value=True)
            sync()
            gap, step, _ = chosen_logit_gap(logits, ids, dtype)
            at = logits.gather(1, ids.long()[:, None])[:, 0]
            err = (val - at).abs()
            # f32: the f32 bound (the kernel sums in its own order); bf16:
            # one step of the largest logit (the rounding can land a step
            # apart)
            val_ok = (close(val, at, dtype) if dtype == torch.float32
                      else bool((err <= step).all()))
            require(val.dtype == torch.float32 and bool((gap <= step).all())
                    and val_ok,
                    f'{name} value=True {dtype} d={d} V={v}: ids '
                    f'{ids.tolist()} (twin {r_ids.tolist()}), values '
                    f'{val.tolist()} vs the logits there {at.tolist()}')
            worst = max(worst, err.max().item())
            log(f'  {name} value=True B={B} d={d} V={v} {str(dtype):14s} '
                f'ids equal the twin: {torch.equal(ids, r_ids)}; value err '
                f'{err.max().item():.3g} (tol '
                f'{tol_str(dtype) if dtype == torch.float32 else f"{rel:g}|max logit|"}'
                f'), twin values err {(val - r_val).abs().max().item():.3g}')
            del w
        res[name] = {'value output': dict(
            shapes=[list(s_) for s_ in HEAD_VALUE_SHAPES],
            max_abs_err=worst)}
    return res


def int8_route(x, q):
    """The kernel int8_matmul runs for these operands (its wrapper's rule,
    ops/int8_matmul.py int8_matmul_plan)."""
    from spt_proto_tpu_torch.ops import int8_matmul as mm
    k = x.shape[-1]
    return mm.int8_matmul_plan(x.numel() // k, k, q.shape[-1], x.dtype,
                               x.data_ptr() % 16 == 0)['route']


def check_int8_matmul(dtype, m, k, n, timer=None, route=None, n_pad=None,
                      offset=0):
    """int8_matmul vs its twin: x [m, k] @ an int8 [k, n] weight. bf16 takes
    the tensor-core kernels (m < 64: the weight stream, m >= 64: wgmma),
    f32 the CUDA-core ones; `route` asserts the wrapper's choice. n_pad
    (a multiple of 16) cuts the quantized weight to q [k, n_pad] and its
    scale to n (off the quantizer's 256 padding); offset > 0 hands the
    kernel an x whose data starts `offset` elements into its buffer
    (unaligned)."""
    from spt_proto_tpu_torch.ops import int8_matmul as mm
    g = gen(SEED + 7)
    if n_pad is None:
        wq = int8_weight(g, k, n, dtype)
    else:   # the quantizer's weight cut to [k, n_pad], its scale to n
        wq = int8_weight(g, k, n_pad, dtype)
        wq = dict(q=wq['q'][:, :n_pad].contiguous(),
                  scale=wq['scale'][:, :n].contiguous())
    buf = randn(g, (m * k + offset,), dtype)
    x = buf[offset:].view(m, k)
    got_route = int8_route(x, wq['q'])
    require(route is None or got_route == route,
            f'int8_matmul m={m} k={k} n={n}: route {got_route}, expected '
            f'{route}')
    got = mm.int8_matmul(x, wq['q'], wq['scale'])
    want = mm.int8_matmul_ref(x, wq['q'], wq['scale'])
    sync()
    err = max_err(got, want)
    require(close(got, want, dtype) and bool(torch.isfinite(got).all()),
            f'int8_matmul m={m} k={k} n={n} {dtype}: err {err}')
    log(f'  int8_matmul m={m} k={k} n={n}{f" np={n_pad}" if n_pad else ""}'
        f'{f" x+{offset}" if offset else ""} {str(dtype):14s} '
        f'[{got_route}] max err {err:.3g} ({tol_str(dtype)})')
    res = dict(max_abs_err=err, route=got_route)
    if timer is not None:
        res['ms'] = timer.ms(lambda: mm.int8_matmul(x, wq['q'], wq['scale']))
        res['plain_ms'] = timer.ms(
            lambda: mm.int8_matmul_ref(x, wq['q'], wq['scale']), reps=5)
        w_dq = dequant(wq, dtype)
        res['library_ms'] = timer.ms(lambda: x @ w_dq)
        del w_dq
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(x, wq, got), 2 * m * k * n, torch.bfloat16)
        log_times(res)
    return res


# untimed int8_matmul shapes across the kernels' rules and tiles: m either
# side of SKINNY_M (63 / 64) and past the wgmma CTA's rows (65, 130, 1,000),
# q's width past the scale's (N < NP) and off the 128-column CTA tile, K off
# the 64-row k-step, and the CUDA-core kernels' cases: K % 8 != 0 and x
# unaligned (bf16), f32. (name: (m, k, n, n_pad, x offset, bf16 route);
# n_pad None: q at the quantizer's own 256-column padding)
INT8_MATMUL_EDGES = {
    'edge m63': (63, 1000, 700, 768, 0, 'stream'),
    'edge m64': (64, 1000, 700, 768, 0, 'wgmma'),
    'edge m65 np272': (65, 256, 260, 272, 0, 'wgmma'),
    'edge m130 k200': (130, 200, 300, 400, 0, 'wgmma'),
    'edge m1000 k4104': (1000, 4104, 1000, 1024, 0, 'wgmma'),
    'edge m1000 k4104 n1000': (1000, 4104, 1000, None, 0, 'wgmma'),
    'edge m9 np272 k200': (9, 200, 260, 272, 0, 'stream'),
    'edge m1 k4104': (1, 4104, 4096, 4096, 0, 'stream'),
    'edge k100 (K % 8)': (70, 100, 256, 256, 0, 'cuda_core'),
    'edge m8 k100 (K % 8)': (8, 100, 256, 256, 0, 'cuda_core'),
    'edge x unaligned': (96, 256, 256, 256, 1, 'cuda_core'),
    'edge m8 x unaligned': (8, 256, 256, 256, 1, 'cuda_core')}


def check_int8_matmul_edges(dtype):
    """INT8_MATMUL_EDGES against the twin, each on the route the rule
    states (f32: always the CUDA-core kernels)."""
    return {name: check_int8_matmul(
        dtype, m_, k_, n_, n_pad=np_, offset=off,
        route=route if dtype == torch.bfloat16 else 'cuda_core')
        for name, (m_, k_, n_, np_, off, route) in INT8_MATMUL_EDGES.items()}


# (m, K, N) of int8_matmul_t on the int8_base training path: dx = g [m, N]
# @ q [K, N]^T of each frozen kernel [K, N]: LLaMA-7B at B=4 x S=512 (q / o
# [4096 x 4096], gate / side [4096 x 11008], down [11008 x 4096]) and
# OPT-125M at B=8 x S=512 (fc1 [768 x 3072], fc2 [3072 x 768]); the first
# is the one the kernel line reports.
INT8_T_SHAPES = {
    'llama-7b gate/side dx': (2048, D_LL, FF_7B),
    'llama-7b q/o dx': (2048, D_LL, D_LL),
    'llama-7b down dx': (2048, FF_7B, D_LL),
    'opt-125m fc1 dx': (4096, D, FF),
    'opt-125m fc2 dx': (4096, FF, D)}
# untimed edge shapes across the kernel's tiles (128 rows of g, 256 rows of
# q in bf16 and 128 in f32) and its 64 / 32-column steps: m and K past a
# tile edge, N past a step and a 256 chunk, K whose rows of out are not
# 16-byte runs
INT8_T_EDGES = {'edge m130 k200 n264': (130, 200, 264),
                'edge m37 k300 n200': (37, 300, 200)}


def check_int8_matmul_t(dtype, m, k, n, timer=None):
    """int8_matmul_t vs its twin: dx = g [m, n] @ dequant(q [k, n])^T, q
    read in its stored layout; the library yardstick is cuBLAS on the
    dequantized weight (g @ w_dq^T)."""
    from spt_proto_tpu_torch.ops import int8_matmul as mm
    g_ = gen(SEED + 13)
    wq = int8_weight(g_, k, n, dtype)
    g = randn(g_, (m, n), dtype)
    got = mm.int8_matmul_t(g, wq['q'], wq['scale'])
    want = mm.int8_matmul_t_ref(g, wq['q'], wq['scale'])
    sync()
    err = max_err(got, want)
    require(close(got, want, dtype) and bool(torch.isfinite(got).all()),
            f'int8_matmul_t m={m} k={k} n={n} {dtype}: err {err}')
    log(f'  int8_matmul_t m={m} k={k} n={n} {str(dtype):14s} max err '
        f'{err:.3g} ({tol_str(dtype)})')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: mm.int8_matmul_t(g, wq['q'],
                                                      wq['scale']))
        res['plain_ms'] = timer.ms(
            lambda: mm.int8_matmul_t_ref(g, wq['q'], wq['scale']), reps=5)
        w_dq = dequant(wq, dtype)
        res['library_ms'] = timer.ms(lambda: g @ w_dq.T)
        del w_dq
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(g, wq, got), 2 * m * k * n, torch.bfloat16)
        log_times(res)
    return res


# gmm / tgmm at OPT-125M's tune shape (ffn_impl='gmm'): B=8 x S=512 tokens
# x top 2 of 4 blocks = 8,192 sorted rows, d_model 768, blocks of 768, LoRA
# rank 16; group sizes with an empty group and boundaries (3000, 5900)
# inside a row tile of every kernel (gmm_boundaries_inside_tiles)
GMM_SIZES = (3000, 0, 2900, 2292)
GMM_R = 16
# an edge case's groups: rows 890-999 lie past every group (zeros)
GMM_SIZES_SHORT, GMM_M_SHORT = (300, 0, 400, 190), 1000


def grouped_mm_library(a, b, sizes, want, one_group):
    """(label, fn) of one PyTorch call computing a grouped product where the
    card's torch has it: torch._grouped_mm(a, b, offs) with offs the
    groups' ends (bf16), if it takes the shape and agrees with the twin's
    `want`; else a per-group loop of one_group(a, b, lo, hi, g)."""
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    if hasattr(torch, '_grouped_mm') and a.dtype == torch.bfloat16:
        try:
            fn = lambda: torch._grouped_mm(a, b, offs=offs)
            got = fn()
            if got.shape == want.shape and close(got.float(), want.float(),
                                                 torch.bfloat16):
                return 'torch._grouped_mm', fn
            log(f'    torch._grouped_mm gave {tuple(got.shape)}, max err '
                f'{max_err(got.float(), want.float()):.3g}; timing a '
                'per-group torch.matmul loop instead')
        except (RuntimeError, TypeError, ValueError) as e:
            log(f'    torch._grouped_mm refused this shape ({e}); timing a '
                'per-group torch.matmul loop instead')
    bounds = torch.cat([offs.new_zeros(1), offs]).tolist()

    def loop():
        for g in range(len(bounds) - 1):
            one_group(a, b, bounds[g], bounds[g + 1], g)
    return 'per-group torch.matmul loop', loop


def gmm_operands(dtype, g_):
    """The tune shape's operands: rows sorted by group, w1 as the block
    view of the dense fc1 kernel [768, 3072] (strided, as the layer passes
    it), w2 [4, 768, 768], the LoRA factors lora_right1 [4, 768, 16]
    (taken transposed) and lora_left2 [4, 768, 16]."""
    m = sum(GMM_SIZES)
    n_blk = len(GMM_SIZES)
    sizes = torch.tensor(GMM_SIZES, dtype=torch.int32, device=DEV)
    fc1 = randn(g_, (D, n_blk * D), dtype, std=D ** -0.5)
    return dict(
        sizes=sizes, x=randn(g_, (m, D), dtype),
        w1=fc1.reshape(D, n_blk, D).permute(1, 0, 2),
        w2=randn(g_, (n_blk, D, D), dtype, std=D ** -0.5),
        xl=randn(g_, (m, GMM_R), dtype),
        lr1=randn(g_, (n_blk, D, GMM_R), dtype, std=GMM_R ** -0.5),
        ll2=randn(g_, (n_blk, D, GMM_R), dtype, std=D ** -0.5),
        g=randn(g_, (m, D), dtype), g_r=randn(g_, (m, GMM_R), dtype))


def gmm_edge_operands(dtype, g_):
    """Shapes off the main path, one for each tile shape and rhs layout
    the main path does not take, a ragged one, rows past every group, and
    one the wrapper sends to the CUDA-core kernel: {name: (lhs, rhs,
    transpose_rhs, sizes)}."""
    m, n_blk = sum(GMM_SIZES), len(GMM_SIZES)
    sizes = torch.tensor(GMM_SIZES, dtype=torch.int32, device=DEV)
    short = torch.tensor(GMM_SIZES_SHORT, dtype=torch.int32, device=DEV)
    x_short = randn(g_, (GMM_M_SHORT, D), dtype)
    return {
        'n 32 k-major': (randn(g_, (m, D), dtype),
                         randn(g_, (n_blk, 32, D), dtype, std=D ** -0.5),
                         True, sizes),
        'k 16 n-major': (randn(g_, (m, GMM_R), dtype),
                         randn(g_, (n_blk, GMM_R, D), dtype), False, sizes),
        'ragged k 200 n 136': (randn(g_, (m, 200), dtype),
                               randn(g_, (n_blk, 200, 136), dtype,
                                     std=200 ** -0.5), False, sizes),
        'rows past the groups (wide)': (
            x_short, randn(g_, (n_blk, D, D), dtype, std=D ** -0.5), False,
            short),
        'rows past the groups (n 16)': (
            x_short, randn(g_, (n_blk, D, GMM_R), dtype, std=D ** -0.5),
            False, short),
        'k 100 (cuda-core)': (randn(g_, (m, 100), dtype),
                              randn(g_, (n_blk, 100, 200), dtype,
                                    std=0.1), False, sizes)}


def gmm_boundaries_inside_tiles():
    """GMM_SIZES' group boundaries lie inside a row tile of every kernel
    (gmm's BM: 64 narrow, 96 wide, 128 thin, csrc/gmm.cu; tgmm's R at the
    tune shape), so that the checks take the straddling-tile path."""
    from spt_proto_tpu_torch.ops import gmm as mm
    ends = np.cumsum(GMM_SIZES)[:-1]
    m = sum(GMM_SIZES)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = [64, 96, 128] + [mm.tgmm_plan(m, D, n, len(GMM_SIZES), n_sm)[1]
                        for n in (GMM_R, 32)]
    require(all(e % r for e in ends for r in rows),
            f'group ends {ends} must lie inside row tiles of {rows}')


def check_gmm(dtype, timer=None):
    """gmm vs its twin at the tune shape: the eight products a layer of
    routed_ffn_lora_gmm runs (x @ w1 through the strided block view, h @
    w2, xl @ lora_right1^T with transpose_rhs, h @ lora_left2, and the
    backward's four dlhs), each on the kernel the wrapper's rule picks
    (bf16: the tensor-core tiles; f32: the CUDA-core kernel), timed; then
    gmm_edge_operands, untimed. The kernel line reports x @ w1. f32 to
    1e-5, bf16 one bf16 step."""
    from spt_proto_tpu_torch.ops import gmm as mm
    gmm_boundaries_inside_tiles()
    o = gmm_operands(dtype, gen(SEED + 14))
    sizes = o['sizes']
    bf = dtype == torch.bfloat16
    cases = {
        'x @ w1 (block view)': (o['x'], o['w1'], False, 'wide'),
        'h @ w2': (o['x'], o['w2'], False, 'wide'),
        'xl @ lora_right1^T (r 16)': (o['xl'], o['lr1'], True,
                                      'thin k-major'),
        'h @ lora_left2 (n 16)': (o['x'], o['ll2'], False, 'narrow16'),
        'dlhs g @ w1^T': (o['g'], o['w1'], True, 'wide k-major'),
        'dlhs g @ w2^T': (o['g'], o['w2'], True, 'wide k-major'),
        # lora_right1's layout [4, 768, 16], with the 768^-0.5 scale of
        # the other 768-deep products' right operands (lr1's 16^-0.5 puts
        # its f32 outputs at ~7, past the f32 bound's 1e-5 absolute part)
        'dlhs g_h @ lora_right1 (n 16)': (o['g'], o['ll2'], False,
                                          'narrow16'),
        'dlhs g_hl @ lora_left2^T (k 16)': (o['g_r'], o['ll2'], True,
                                            'thin k-major')}
    edges = gmm_edge_operands(dtype, gen(SEED + 18))
    edge_routes = {'n 32 k-major': 'narrow32 k-major', 'k 16 n-major': 'thin',
                   'ragged k 200 n 136': 'wide',
                   'rows past the groups (wide)': 'wide',
                   'rows past the groups (n 16)': 'narrow16',
                   'k 100 (cuda-core)': 'cuda-core'}
    runs = [(name, lhs, rhs, t, sizes, route, True)
            for name, (lhs, rhs, t, route) in cases.items()]
    runs += [(name, lhs, rhs, t, sz, edge_routes[name], False)
             for name, (lhs, rhs, t, sz) in edges.items()]
    res = {}
    for name, lhs, rhs, t, sz, route, timed in runs:
        route = route if bf else 'cuda-core'
        got_route = mm.gmm_route(lhs, rhs, transpose_rhs=t)
        require(got_route == route,
                f'gmm {name} {dtype}: route {got_route}, expected {route}')
        got = mm.gmm(lhs, rhs, sz, transpose_rhs=t)
        want = mm.gmm_ref(lhs, rhs, sz, transpose_rhs=t)
        sync()
        err = max_err(got, want)
        require(close(got, want, dtype) and bool(torch.isfinite(got).all()),
                f'gmm {name} {dtype}: err {err}')
        log(f'  gmm {name} {tuple(lhs.shape)} x {tuple(rhs.shape)} '
            f'{str(dtype):14s} [{route}] max err {err:.3g} '
            f'({tol_str(dtype)}); groups {tuple(sz.tolist())}')
        r = dict(max_abs_err=err, route=route)
        if timer is not None and timed:
            r['ms'] = timer.ms(lambda: mm.gmm(lhs, rhs, sz,
                                              transpose_rhs=t))
            r['plain_ms'] = timer.ms(lambda: mm.gmm_ref(
                lhs, rhs, sz, transpose_rhs=t), reps=5)
            lib, fn = grouped_mm_library(
                lhs, rhs.transpose(1, 2) if t else rhs, sz, want,
                lambda a, b, lo, hi, g: a[lo:hi] @ b[g])
            r['library_ms'], r['library'] = timer.ms(fn), lib
            n = got.shape[1]
            r['bound_ms'], r['bound_by'] = bound_ms(
                nbytes(lhs, rhs, sz, got),
                2 * lhs.shape[0] * lhs.shape[1] * n, dtype)
            log_times(r)
            log(f'      library: {lib}')
        res[name] = r
        del got, want
    return dict(res['x @ w1 (block view)'], **res)


def tgmm_route(lhs, rhs, sizes) -> str:
    """The kernels tgmm launches: 'wide' / 'narrow16' / 'narrow32' with
    the row tile R ('whole groups' when R >= m), or 'cuda-core'."""
    from spt_proto_tpu_torch.ops import gmm as mm
    if not mm.tgmm_takes_tc(lhs, rhs):
        return 'cuda-core'
    m = lhs.shape[0]
    tile, rows, _, _ = mm.tgmm_plan(
        m, lhs.shape[1], rhs.shape[1], sizes.shape[0],
        torch.cuda.get_device_properties(0).multi_processor_count)
    return (f'{mm.TILE_NAMES[tile]} '
            + ('whole groups' if rows >= m else f'R {rows}'))


def check_tgmm(dtype, timer=None):
    """tgmm vs its twin at the tune shape: the two LoRA factors' gradients
    of routed_ffn_lora_gmm, lora_left2's tgmm(h, g_hl) [4, 768, 16] (the
    kernel line's) and lora_right1's tgmm(g_h, xl) [4, 768, 16], and w1's
    full-width gradient tgmm(x, g_h) [4, 768, 768] (a trained base),
    timed; then, untimed, n 32, rows past every group and k 100 (the
    CUDA-core kernel). The empty group must come out zero. The library
    yardstick is torch._grouped_mm with the offsets along the contraction
    (lhs^T [k, m] x rhs [m, n]), else a per-group torch.matmul loop
    (lhs[rows]^T @ rhs[rows]), labelled as such. Each output sums ~3,000
    rows, in another order than the twin's: entries near 0 carry the
    rounding of the largest, so f32 is held to 1e-5 of the output's
    largest entry (+ 1e-5 relative); bf16 inputs as `tolerance`."""
    from spt_proto_tpu_torch.ops import gmm as mm
    o = gmm_operands(dtype, gen(SEED + 15))
    sizes = o['sizes']
    g_ = gen(SEED + 19)
    m = sum(GMM_SIZES)
    short = torch.tensor(GMM_SIZES_SHORT, dtype=torch.int32, device=DEV)
    runs = [('lora_left2 grad tgmm(h, g_hl)', o['x'], o['g_r'], sizes, True),
            ('lora_right1 grad tgmm(g_h, xl)', o['g'], o['xl'], sizes, True),
            ('w1 grad (full width) tgmm(x, g_h)', o['x'], o['g'], sizes,
             True),
            ('n 32', o['x'], randn(g_, (m, 32), dtype), sizes, False),
            ('rows past the groups', randn(g_, (GMM_M_SHORT, D), dtype),
             randn(g_, (GMM_M_SHORT, GMM_R), dtype), short, False),
            ('k 100 (cuda-core)', randn(g_, (m, 100), dtype), o['g_r'],
             sizes, False)]
    res = {}
    for name, lhs, rhs, sz, timed in runs:
        route = tgmm_route(lhs, rhs, sz)
        require((route == 'cuda-core')
                == (dtype == torch.float32 or name.endswith('(cuda-core)')),
                f'tgmm {name} {dtype}: route {route}')
        got = mm.tgmm(lhs, rhs, sz)
        want = mm.tgmm_ref(lhs, rhs, sz)
        sync()
        err = max_err(got, want)
        tol = ((1e-5 * want.abs().max().item(), 1e-5)
               if dtype == torch.float32 else tolerance(dtype))
        require(close(got, want, dtype, tol) and not bool(got[1].any()),
                f'tgmm {name} {dtype}: err {err}, empty group zero: '
                f'{not bool(got[1].any())}')
        log(f'  tgmm {name} {tuple(lhs.shape)} x {tuple(rhs.shape)} '
            f'{str(dtype):14s} [{route}] max err {err:.3g} '
            f'({tol_str(dtype, tol)}); empty group zero')
        r = dict(max_abs_err=err, route=route)
        if timer is not None and timed:
            r['ms'] = timer.ms(lambda: mm.tgmm(lhs, rhs, sz))
            r['plain_ms'] = timer.ms(lambda: mm.tgmm_ref(lhs, rhs, sz),
                                     reps=5)
            lib, fn = grouped_mm_library(
                lhs.T, rhs, sz, want,
                lambda a, b, lo, hi, g: a[:, lo:hi] @ b[lo:hi])
            r['library_ms'], r['library'] = timer.ms(fn), lib
            r['bound_ms'], r['bound_by'] = bound_ms(
                nbytes(lhs, rhs, sz, got),
                2 * lhs.shape[0] * lhs.shape[1] * rhs.shape[1], dtype)
            log_times(r)
            log(f'      library: {lib}')
        res[name] = r
        del got, want
    return dict(res['lora_left2 grad tgmm(h, g_hl)'], **res)


def check_lm_head_int8(dtype, d, timer=None, vocab=VOCAB, b=B):
    """lm_head_argmax_int8 vs its twin over the int8 head [d, vocab padded
    to 256] with the true vocab (OPT's 50,272, or LLaMA's 128,256 and
    32,000)."""
    from spt_proto_tpu_torch.ops import lm_head as m
    g = gen(SEED + 8)
    x = randn(g, (b, d), dtype)
    wq = int8_weight(g, d, vocab, dtype)
    got = m.lm_head_argmax_int8(x, wq)
    want = m.lm_head_argmax_int8_ref(x, wq)
    sync()
    logits = m.int8_head_logits(x, wq['q'], wq['scale'])
    gap, step, rel = chosen_logit_gap(logits, got, dtype)
    err = gap.max().item()
    label = f'lm_head_argmax_int8 B={b} d={d} V={vocab}'
    require(bool((gap <= step).all()) and got.dtype == torch.int32
            and bool((got < vocab).all()),
            f'{label} {dtype}: ids {got.tolist()} vs {want.tolist()}')
    log(f'  {label} {str(dtype):14s} ids equal: '
        f'{torch.equal(got, want)}; chosen-logit gap {err:.3g} (tol '
        f'{rel:g}|max logit|)')
    res = dict(max_abs_err=err)
    if timer is not None:
        res['ms'] = timer.ms(lambda: m.lm_head_argmax_int8(x, wq))
        res['plain_ms'] = timer.ms(lambda: m.lm_head_argmax_int8_ref(x, wq),
                                   reps=5)
        w_dq = dequant(wq, dtype)
        res['library_ms'] = timer.ms(lambda: torch.argmax(x @ w_dq, -1))
        del w_dq
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(x, wq['q'][:, :vocab], wq['scale'], got),
            2 * b * d * vocab, torch.bfloat16)
        log_times(res)
        head_rate(res, nbytes(x, wq['q'][:, :vocab], wq['scale'], got))
    return res


def sparse_sel(s, n_sel, bh, block_q, g, n_sub=N_SUB):
    """Selection from random PQ codes, as prefill builds it."""
    from spt_proto_tpu_torch.ops.block_sparse import (pq_tile_scores,
                                                      select_tiles)
    qc = torch.randint(0, N_CODE, (bh, s, n_sub), generator=g, device=DEV,
                       dtype=torch.int32)
    kc = torch.randint(0, N_CODE, (bh, s, n_sub), generator=g, device=DEV,
                       dtype=torch.int32)
    ts = pq_tile_scores(qc, kc, n_codewords=N_CODE, block_q=block_q,
                        block_k=128)
    return select_tiles(ts, n_sel, block_ratio=block_q // 128)


def causal_pairs(sel, block_q, block_k=128) -> int:
    """(query row, key column) pairs with col <= row in the selected tiles."""
    n_qt = sel.shape[1]
    r = (torch.arange(n_qt, device=sel.device)[:, None] * block_q
         + torch.arange(block_q, device=sel.device)[None])     # [nq, bq]
    c0 = sel.clamp(min=0).long() * block_k                     # [bh, nq, ns]
    per = (r[None, :, None, :] - c0[..., None] + 1).clamp(0, block_k)
    return int((per * (sel >= 0)[..., None]).sum())


def check_block_sparse(dtype, s, coeff, timer=None, bh=B * HEADS, dh=DH,
                       n_sub=N_SUB, block_q=256, clamp=10.0, edit_sel=None,
                       lse=False, off_rule=False):
    """block_sparse_attention (or, lse=True, block_sparse_attention_lse)
    vs its twin over bh (slot, head) rows of s tokens and d_head dh
    (OPT-125M's 64, or LLaMA's 128, a kernel of its own), selection from
    random codes of n_sub subspaces (edit_sel may change it), on the
    kernel fwd_route names (asserted: bf16 the tensor-core kernel; with
    off_rule, q unaligned, the CUDA-core kernel). o is held to
    tight_tolerance, lse to the f32 bound. Timed beside dense SDPA's
    causal forward on the same q, k, v (library_ms) when timer is given."""
    from spt_proto_tpu_torch.ops.block_sparse import block_sparse_attention_ref
    from spt_proto_tpu_torch.ops import block_sparse_attention as m
    g = gen(SEED + 4)
    n_sel = max(block_q // 128, (s // 128) // coeff)
    sel = sparse_sel(s, n_sel, bh, block_q, g, n_sub)
    if edit_sel is not None:
        sel = edit_sel(sel)
    q = randn(g, (bh, s, dh), dtype, std=2.0)
    k = randn(g, (bh, s, dh), dtype)
    v = randn(g, (bh, s, dh), dtype)
    if off_rule:
        q = unaligned(q)
    kw = dict(block_q=block_q, block_k=128, scale=dh ** -0.5, clamp=clamp)
    route = m.fwd_route(dtype, dh, block_q, 128, not off_rule)
    require((route == 'tc') == (dtype == torch.bfloat16 and not off_rule),
            f'block_sparse_attention {dtype} d {dh}: route {route}')
    if lse:
        fn = m.block_sparse_attention_lse
        got, got_lse = fn(q, k, v, sel, **kw)
        want, want_lse = m.block_sparse_attention_lse_ref(q, k, v, sel, **kw)
    else:
        fn = m.block_sparse_attention
        got = fn(q, k, v, sel, **kw)
        want = block_sparse_attention_ref(q, k, v, sel, **kw)
    sync()
    err = max_err(got, want)
    diag = (torch.arange(sel.shape[1], device=DEV)
            * (block_q // 128))[None, :, None]
    off_diag = bool(((sel >= 0) & (sel < diag)).any())
    invalid = bool((sel < 0).any())
    tol = tight_tolerance(want, dtype)
    ok = close(got, want, dtype, tol) and bool(torch.isfinite(got).all())
    lse_err = None
    if lse:
        lse_err = max_err(got_lse, want_lse)
        ok = ok and close(got_lse, want_lse, torch.float32) and bool(
            torch.isfinite(got_lse).all())
    require(ok, f'block_sparse_attention{"_lse" if lse else ""} {dtype} '
            f'S={s} d {dh} block_q {block_q} clamp {clamp}: err {err}, lse '
            f'err {lse_err}')
    if n_sel > block_q // 128 and edit_sel is None:
        require(off_diag and invalid, f'sel at S={s} lacks off-diagonal or '
                f'-1 entries')
    log(f'  block_sparse{"_lse" if lse else ""} S={s} d_head {dh} block_q '
        f'{block_q} clamp {clamp} n_sel={sel.shape[2]} ({route}'
        f'{", unaligned q" if off_rule else ""}) '
        f'{str(dtype):14s} max err {err:.3g} ({tol_str(dtype, tol)})'
        + (f', lse {lse_err:.3g} ({tol_str(torch.float32)})' if lse else '')
        + f'; off-diagonal tiles {off_diag}, -1 entries {invalid}')
    res = dict(max_abs_err=err, route=route)
    if timer is not None:
        res['ms'] = timer.ms(lambda: fn(q, k, v, sel, **kw))
        res['plain_ms'] = timer.ms(
            lambda: block_sparse_attention_ref(q, k, v, sel, **kw), reps=5)
        # K/V bytes of the tiles some query tile selects, q read, o written
        used = sum(int(torch.unique(sel[i][sel[i] >= 0]).numel())
                   for i in range(bh))
        kv_bytes = used * 128 * dh * 2 * q.element_size()
        res['bound_ms'], res['bound_by'] = bound_ms(
            nbytes(q, sel, got) + kv_bytes,
            4 * dh * causal_pairs(sel, block_q), dtype)
        # no one PyTorch call takes per-tile selection lists; dense causal
        # SDPA over the same rows is the yardstick the sparse path must beat
        res['library_ms'] = None
        q4, k4, v4 = (t[None] for t in (q, k, v))
        res['sdpa_causal_ms'] = timer.ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True))
        log_times(res)
        log(f'      dense causal SDPA over the same rows '
            f'{res["sdpa_causal_ms"] * 1e3:.1f} us')
    return res


def check_block_sparse_edges(dtype):
    """The block-sparse forward's edges, each vs its twin on the kernel
    fwd_route names: d_head 64 and 128 at block_q 128 and 256; the clamp on
    and off; -1 entries amid a q tile's list and a tile wholly after the q
    tile's rows (an entry the kernel skips and the twin masks); the lse
    form at both block sizes. In bf16, the calls off the rule too: an
    unaligned q takes the CUDA-core kernel, with and without lse."""
    def holes(block_q):
        def edit(sel):
            # a -1 entry after every list's first; every q tile but the
            # last: the next q tile's first key tile appended (after its
            # rows)
            n_qt = sel.shape[1]
            qt = torch.arange(n_qt, device=sel.device)
            nxt = torch.where(qt < n_qt - 1, (qt + 1) * (block_q // 128), -1)
            hole = torch.full_like(sel[..., :1], -1)
            return torch.cat([sel[..., :1], hole, sel[..., 1:], nxt[
                None, :, None].expand(sel.shape[0], -1, 1).to(sel.dtype)],
                -1).contiguous()
        return edit
    res = {}
    for dh, bh, n_sub in ((DH, 16, N_SUB), (DH_LL, 8, N_SUB_LL)):
        for block_q in (128, 256):
            for clamp in (10.0, None):
                res[f'd {dh} block_q {block_q} clamp {clamp}'] = \
                    check_block_sparse(dtype, PROMPT, 4, None, bh, dh, n_sub,
                                       block_q, clamp, holes(block_q))
            res[f'lse d {dh} block_q {block_q}'] = check_block_sparse(
                dtype, PROMPT, 4, None, bh, dh, n_sub, block_q, 10.0,
                holes(block_q), lse=True)
        if dtype == torch.bfloat16:
            for lse in (False, True):
                res[f'off rule unaligned q d {dh}{" lse" if lse else ""}'] \
                    = check_block_sparse(dtype, PROMPT, 4, None, bh, dh,
                                         n_sub, 256 if lse else 128, 10.0,
                                         holes(256 if lse else 128), lse=lse,
                                         off_rule=True)
    return res





def check_block_sparse_train(dtype, bh, s, dh, coeff, timer=None,
                             n_sub=N_SUB, block_q=256, drop_tile=False):
    """The training kernels of block-sparse attention against their twins:
    the forward with log-sum-exp (block_sparse_attention_lse), dq and dk/dv
    (block_sparse_attention_dq / _dkv) against block_sparse_attention_lse_ref
    and block_sparse_attention_bwd_ref, on bh (batch, head) rows of s tokens
    and d_head dh, n_sel = max(2, (s / 128) / coeff) tiles from random PQ
    codes (block_q 64: each 64-row q tile takes its 128-row parent's list);
    g the output gradient; the backward's route asserted (bwd_route: bf16 at
    block_q 256 / 128 the tensor-core pair, block_q 64 and f32 the CUDA-core
    one). drop_tile (n_sel 2, block_q 256): q tile 0 drops key tile 1, which
    no other q tile then selects, and dk / dv of its keys must come out
    exact zeros. Outputs held to output_tolerance, lse to the f32 bound.
    With a timer: each kernel's cold-L2 time beside its bound and, for dq
    and dk/dv, SDPA's dense causal backward over the same rows (timed only:
    it computes another function, every causal pair and no clip)."""
    import torch.nn.functional as F
    from spt_proto_tpu_torch.ops import block_sparse_attention as m
    g_ = gen(SEED + 9)
    n_sel = max(2, (s // 128) // coeff)
    if block_q % 128:
        sel = sparse_sel(s, n_sel, bh, 128, g_, n_sub).repeat_interleave(
            128 // block_q, 1).contiguous()
    else:
        sel = sparse_sel(s, n_sel, bh, block_q, g_, n_sub)
    if drop_tile:
        require(n_sel == 2 and block_q == 256, 'drop_tile takes the '
                'diagonal pair at block_q 256')
        sel[:, 0, 1] = -1
    q = randn(g_, (bh, s, dh), dtype, std=2.0)
    k = randn(g_, (bh, s, dh), dtype, std=2.0)
    v = randn(g_, (bh, s, dh), dtype)
    g = randn(g_, (bh, s, dh), dtype)
    kw = dict(block_q=block_q, block_k=128, scale=dh ** -0.5, clamp=10.0)
    o, lse = m.block_sparse_attention_lse(q, k, v, sel, **kw)
    o_w, lse_w = m.block_sparse_attention_lse_ref(q, k, v, sel, **kw)
    dd = (g.float() * o.float()).sum(-1)
    rsel = m.reverse_table(sel, s // 128)
    route = m.bwd_route(dtype, dh, block_q, 128, all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, g, lse, dd)))
    require(route == ('tc' if dtype == torch.bfloat16 and block_q % 128 == 0
                      else 'cuda_core'),
            f'block-sparse backward {dtype} d {dh} block_q {block_q}: route '
            f'{route}')
    dq = m.block_sparse_attention_dq(q, k, v, sel, g, lse, dd, **kw)
    dk, dv = m.block_sparse_attention_dkv(q, k, v, sel, rsel, g, lse, dd,
                                          **kw)
    want = m.block_sparse_attention_bwd_ref(q, k, v, sel, o, lse, g, **kw)
    sync()
    require(all(w.float().abs().max().item() > 0 for w in want),
            'a zero twin gradient')
    if drop_tile:
        require(bool((rsel[:, 1] < 0).all()), 'key tile 1 is still selected')
        require(bool((dk[:, 128:256] == 0).all())
                and bool((dv[:, 128:256] == 0).all()),
                f'block-sparse training {dtype}: the unselected key tile\'s '
                f'dk / dv are not zeros')
    diag = (torch.arange(sel.shape[1], device=DEV)
            * (block_q // 128))[None, :, None]
    off_diag = bool(((sel >= 0) & (sel < diag)).any())
    invalid = bool((sel < 0).any())
    if n_sel > 2 and block_q == 256:    # more tiles than the forced pair
        require(off_diag and invalid, f'sel at S={s} lacks off-diagonal or '
                f'-1 entries')
    errs = {}
    for name, got, w in (('o', o, o_w), ('dq', dq, want[0]),
                         ('dk', dk, want[1]), ('dv', dv, want[2]),
                         ('lse', lse, lse_w)):
        tol = (tolerance(torch.float32) if name == 'lse'
               else output_tolerance(w, dtype))
        errs[name] = max_err(got, w)
        require(close(got, w, dtype, tol) and bool(torch.isfinite(got).all()),
                f'block-sparse training {name} {dtype} S={s} d {dh} block_q '
                f'{block_q}: err {errs[name]} ({tol_str(dtype, tol)})')
    log(f'  block_sparse train BH={bh} S={s} d_head {dh} block_q {block_q} '
        f'n_sel={n_sel} backward {route}'
        f'{", key tile 1 dropped" if drop_tile else ""} '
        f'{str(dtype):14s} max err ' + ', '.join(
            f'{k_} {v_:.3g}' for k_, v_ in errs.items())
        + f' (bf16: 2^-7 max|want|); off-diagonal {off_diag}, -1 {invalid}')
    res = {}
    if timer is not None:
        plain_fwd = timer.ms(lambda: m.block_sparse_attention_lse_ref(
            q, k, v, sel, **kw), reps=5)
        plain_bwd = timer.ms(lambda: m.block_sparse_attention_bwd_ref(
            q, k, v, sel, o, lse, g, **kw), reps=5)
        # the yardstick: SDPA's dense causal backward over the same rows
        leaves = [t[None].detach().clone().requires_grad_()
                  for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                 scale=kw['scale'])
        g4 = g[None]
        lib_bwd = timer.ms(lambda: torch.autograd.grad(
            lib_out, leaves, g4, retain_graph=True))
        del lib_out, leaves
        used = sum(int(torch.unique(sel[i][sel[i] >= 0]).numel())
                   for i in range(bh))
        kv_bytes = used * 128 * dh * 2 * q.element_size()
        pairs = causal_pairs(sel, block_q)
        lib = ('scaled_dot_product_attention backward (dq, dk, dv), dense '
               'causal over the same rows: not the same function')
        rows = dict(
            block_sparse_attention_lse=(
                lambda: m.block_sparse_attention_lse(q, k, v, sel, **kw),
                'o', nbytes(q, sel, o, lse) + kv_bytes, 4 * dh * pairs,
                plain_fwd, None),
            block_sparse_attention_dq=(
                lambda: m.block_sparse_attention_dq(q, k, v, sel, g, lse, dd,
                                                    **kw),
                'dq', nbytes(q, g, lse, dd, sel, dq) + kv_bytes,
                6 * dh * pairs, plain_bwd, lib_bwd),
            block_sparse_attention_dkv=(
                lambda: m.block_sparse_attention_dkv(q, k, v, sel, rsel, g,
                                                     lse, dd, **kw),
                'dk', nbytes(q, g, lse, dd, rsel, dk, dv) + kv_bytes,
                8 * dh * pairs, plain_bwd, lib_bwd))
        for name, (fn, out, n_b, n_o, plain, lib_ms) in rows.items():
            r = dict(max_abs_err=max(errs[out], errs['dv'])
                     if name.endswith('dkv') else errs[out],
                     ms=timer.ms(fn), plain_ms=plain, library_ms=lib_ms,
                     route=route if name != 'block_sparse_attention_lse'
                     else m.fwd_route(dtype, dh, block_q, 128))
            if lib_ms is not None:
                r['library'] = lib
            r['bound_ms'], r['bound_by'] = bound_ms(n_b, n_o, dtype)
            log(f'    {name}:')
            log_times(r)
            res[name] = r
    return res


FLASH_KERNELS = ('flash_attention', 'flash_attention_dq',
                 'flash_attention_dkv')
# (B, H, S, d) of the flash-attention checks: OPT-125M's training shape (the
# tune runs', B=8 x 12 heads, S 512), its S 2048 (the profile runs'), and
# LLaMA-7B's width (32 heads of d 128) at B=4, S 512; then bf16 edge shapes
# at both widths: S 128 (one 128-row diagonal tile) and S 384 (an odd count
# of 128-row tiles)
FLASH_SHAPES = {'opt-125m S=512': (B, HEADS, 512, DH),
                'opt-125m S=2048': (B, HEADS, PROMPT, DH),
                'llama-7b S=512': (B_7B, HEADS_LL, 512, DH_LL),
                'opt-125m S=128': (B, HEADS, 128, DH),
                'opt-125m S=384': (B, HEADS, 384, DH),
                'llama-7b S=128': (B_7B, HEADS_LL, 128, DH_LL),
                'llama-7b S=384': (B_7B, HEADS_LL, 384, DH_LL)}
# SDPA, the library yardstick, against the twins: it rounds p and ds to
# bf16 at other places than the stock kernel's numerics the twins follow,
# so it is held to four bf16 steps of the largest entry (1e-5 in f32)
SDPA_TOL = {torch.bfloat16: 2 ** -5, torch.float32: 1e-5}


def check_flash(dtype, shape, timer=None):
    """The flash-attention forward (o, l, m), dq and dk/dv kernels against
    their twins on [B, H, S, d] causal, sm_scale d**-0.5, q, k, v and do
    given as the layer gives them ([B, S, H, d] tensors transposed: the
    bf16 kernels read them in place, and the forward writes o in that
    layout): o, dq, dk, dv to output_tolerance, l and m to the f32 bound;
    the backward twin from the kernel's own o, l, m. With a timer: cold-L2 µs of each kernel and its achieved TFLOP/s,
    its plain twin's µs, SDPA's (forward alone, and its backward through
    torch.autograd.grad: the library yardstick, checked against the twins
    first) and the bound: the causal forward needs 2 B H S^2 d FLOPs; dq's
    function 3 B H S^2 d and dk/dv's 4 (S and dP computed in both: the pair
    3.5x the forward, a fused backward 2.5x); bytes of q, k, v, o, l, m
    (forward) and of q, k, v, do, l, m, di and the kernel's outputs (dq; dk
    and dv)."""
    from spt_proto_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F
    b, h, s, d = shape
    g = gen(SEED + 20)
    q, k, v, do = (randn(g, (b, s, h, d), dtype, std=std).transpose(1, 2)
                   for std in (2.0, 2.0, 1.0, 1.0))
    kw = dict(causal=True, sm_scale=d ** -0.5)
    o, l, m = fa.flash_attention_fwd(q, k, v, **kw)
    o_w, l_w, m_w = fa.flash_attention_fwd_ref(q, k, v, **kw)
    # bf16: o written in the layer's [B, S, H, d] layout, read in place
    require(dtype != torch.bfloat16 or o.transpose(1, 2).is_contiguous(),
            f'flash attention {shape}: o strides {o.stride()}')
    di = (o.float() * do.float()).sum(-1)
    dq = fa.flash_attention_dq(q, k, v, l, m, do, di, **kw)
    dk, dv = fa.flash_attention_dkv(q, k, v, l, m, do, di, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, o, l, m, do, **kw)
    sync()
    errs = {}
    for name, got, w in (('o', o, o_w), ('l', l, l_w), ('m', m, m_w),
                         ('dq', dq, want[0]), ('dk', dk, want[1]),
                         ('dv', dv, want[2])):
        tol = (tolerance(torch.float32) if name in ('l', 'm')
               else output_tolerance(w, dtype))
        errs[name] = max_err(got, w)
        require(close(got, w, dtype, tol) and bool(torch.isfinite(got).all()),
                f'flash attention {name} {dtype} {shape}: err {errs[name]} '
                f'({tol_str(dtype, tol)})')
    log(f'  flash {shape} {str(dtype):14s} max err ' + ', '.join(
        f'{k_} {v_:.3g}' for k_, v_ in errs.items())
        + ' (bf16: 2^-7 max|want|; l, m f32 bound)')
    del o_w, l_w, m_w
    res = {}
    if timer is not None:
        plain_fwd = timer.ms(lambda: fa.flash_attention_fwd_ref(q, k, v,
                                                                **kw), reps=5)
        plain_bwd = timer.ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, o, l, m, do, **kw), reps=5)
        # the library yardstick: SDPA forward, and its backward alone
        lo = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                            scale=kw['sm_scale'])
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                 scale=kw['sm_scale'])
        lib_grads = torch.autograd.grad(lib_out, leaves, do,
                                        retain_graph=True)
        lib_err = [max_err(a, w) / w.float().abs().max().item()
                   for a, w in zip((lo, *lib_grads), (o, *want))]
        require(max(lib_err) <= SDPA_TOL[dtype], f'SDPA vs the twins '
                f'{shape} {dtype}: rel errs {lib_err}')
        lib_fwd = timer.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=kw['sm_scale']))
        lib_bwd = timer.ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True))
        del lo, lib_out, lib_grads, leaves
        flops = 2 * b * h * s * s * d
        rows = dict(
            flash_attention=(
                lambda: fa.flash_attention_fwd(q, k, v, **kw),
                max(errs['o'], errs['l'], errs['m']), nbytes(q, k, v, o, l, m),
                flops, plain_fwd, lib_fwd),
            flash_attention_dq=(
                lambda: fa.flash_attention_dq(q, k, v, l, m, do, di, **kw),
                errs['dq'], nbytes(q, k, v, do, l, m, di, dq), 1.5 * flops,
                plain_bwd, lib_bwd),
            flash_attention_dkv=(
                lambda: fa.flash_attention_dkv(q, k, v, l, m, do, di, **kw),
                max(errs['dk'], errs['dv']),
                nbytes(q, k, v, do, l, m, di, dk, dv), 2 * flops, plain_bwd,
                lib_bwd))
        for name, (fn, err, n_b, n_o, plain, lib) in rows.items():
            r = dict(max_abs_err=err, ms=timer.ms(fn), plain_ms=plain,
                     library_ms=lib, library='scaled_dot_product_attention'
                     + ('' if name == 'flash_attention'
                        else ' backward (dq, dk, dv)'),
                     library_rel_err=lib_err)
            r['bound_ms'], r['bound_by'] = bound_ms(n_b, n_o, dtype)
            r['tflops'] = n_o / r['ms'] / 1e9
            log(f'    {name}: {r["tflops"]:.1f} TFLOP/s')
            log_times(r)
            res[name] = r
        both = sum(res[n]['ms'] for n in FLASH_KERNELS[1:])
        pair = sum(res[n]['bound_ms'] for n in FLASH_KERNELS[1:])
        fused = bound_ms(nbytes(q, k, v, do, l, m, di, dq, dk, dv),
                         2.5 * flops, dtype)[0]
        log(f'    backward pair {shape}: dq + dk/dv {both * 1e3:.1f} us, '
            f'bound {pair * 1e3:.2f} us (3.5x the forward\'s FLOPs; a '
            f'fused backward {fused * 1e3:.2f} us at 2.5x), SDPA backward '
            f'{lib_bwd * 1e3:.1f} us ({both / lib_bwd:.2f}x)')
        # the forward from contiguous inputs: what the layer's strided
        # views cost (in bf16 no copy; f32 copies them)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        r = res['flash_attention']
        r['contiguous_inputs_ms'] = timer.ms(
            lambda: fa.flash_attention_fwd(qc, kc, vc, **kw))
        log(f'    flash_attention from contiguous inputs (no copies): '
            f'{r["contiguous_inputs_ms"] * 1e3:.1f} us')
    return res


def phase_kernels(timer):
    """Phase 2; returns the bf16 (serving dtype) results by kernel."""
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = timer if dtype == torch.bfloat16 else None
        r_front, front_out = check_front(dtype, t)
        r_front_bf, front_bf = check_front(dtype, t, quantized=False)
        r_attn = check_attention(dtype, front_out, t)
        r_attn_d = check_attention(dtype, None, t, dense=True)
        r_rows = check_rows(dtype, 'dense', None, t)
        r_rows4 = check_rows(dtype, 'dense-tps4', None, t)
        r_rows_s = check_rows(dtype, 'sparse', front_bf, t)
        r_ffn = check_ffn(dtype, D, FF, t)
        r_ffn13 = check_ffn(dtype, D_13B, FF_13B, t)
        r_head = check_lm_head(dtype, t)
        r_bsa = check_block_sparse(dtype, PROMPT, 8, t)
        check_block_sparse(dtype, 2 * PROMPT, 4)
        # the training kernels: OPT-125M's training shape (B=8 x 12 heads,
        # S 512, the diagonal tiles), then off-diagonal and -1 tables at
        # sparse_coeff 4: S 2048 and 4096 at d_head 64 (96 rows) and 128
        # (32 rows)
        r_train = check_block_sparse_train(dtype, B * HEADS, 512, DH, 8, t)
        for s_, bh_, dh_ in ((PROMPT, B * HEADS, DH),
                             (2 * PROMPT, B * HEADS, DH),
                             (PROMPT, HEADS_LL, DH_LL),
                             (2 * PROMPT, HEADS_LL, DH_LL)):
            check_block_sparse_train(dtype, bh_, s_, dh_, 4,
                                     n_sub=dh_ // 8)
        # block_q 64, off the tensor-core rule (the CUDA-core pair in bf16
        # too), and a table that leaves key tile 1 unselected (its dk / dv
        # exact zeros)
        check_block_sparse_train(dtype, B * HEADS, 512, DH, 8, block_q=64)
        check_block_sparse_train(dtype, B * HEADS, 512, DH, 8,
                                 drop_tile=True)
        # int8 weight-only serving (w8)
        r_front8, _ = check_front(dtype, t, packed=True)
        r_front8_bf, _ = check_front(dtype, t, quantized=False, packed=True)
        r_mm = {name: check_int8_matmul(
            dtype, m_, k_, n_, t, route='cuda_core' if dtype == torch.float32
            else 'stream' if m_ < 64 else 'wgmma')
            for name, (m_, k_, n_) in INT8_MATMUL_SHAPES.items()}
        r_mm.update(check_int8_matmul_edges(dtype))
        # the int8_base and grouped-matmul training kernels
        r_mmt = {name: check_int8_matmul_t(dtype, m_, k_, n_, t)
                 for name, (m_, k_, n_) in INT8_T_SHAPES.items()}
        r_mmt.update({name: check_int8_matmul_t(dtype, m_, k_, n_)
                      for name, (m_, k_, n_) in INT8_T_EDGES.items()})
        r_gmm = check_gmm(dtype, t)
        r_tgmm = check_tgmm(dtype, t)
        # the flash-attention kernels (dense / LoRA-stage training and
        # forward): OPT-125M's training shape and LLaMA-7B's width in f32
        # and bf16, S 2048 (the profile runs') in bf16
        r_flash = {name: check_flash(dtype, shape, t)
                   for name, shape in FLASH_SHAPES.items()
                   if dtype == torch.bfloat16 or shape[2] == 512}
        r_head8 = check_lm_head_int8(dtype, D, t)
        r_head8_13 = check_lm_head_int8(dtype, D_13B, t)
        r_ffn8 = check_ffn(dtype, D, FF, t, int8=True)
        r_ffn8_13 = check_ffn(dtype, D_13B, FF_13B, t, int8=True)
        # LLaMA: the front's RMSNorm + RoPE and GQA forms, the gated tails
        r_fl = {f'{"int8 " if packed else ""}{model} '
                f'{"int8-KV" if quantized else "bf16-KV"}': check_front(
                    dtype, t, quantized=quantized, packed=packed,
                    model=model)[0]
                for model in LLAMA_FRONTS for packed in (False, True)
                for quantized in (True, False)}
        r_gated = {}
        for int8 in (False, True):
            for f, name in ((FF_38B, 'llama-3-8b'), (FF_7B, 'llama-7b')):
                for m_rows in (B, B_7B):
                    r_gated[int8, f'{name} m={m_rows}'] = check_ffn(
                        dtype, D_LL, f, t, int8=int8, gated=True,
                        m_rows=m_rows)
        r_ffn_edges = (check_ffn_edges(dtype) if dtype == torch.bfloat16
                       else {})
        for (int8, gated_, name), r in r_ffn_edges.items():
            if gated_:
                r_gated[int8, name] = r
        r_ffn8_edges = {name: r for (int8, gated_, name), r
                        in r_ffn_edges.items() if int8 and not gated_}
        r_ffn_fp_edges = {name: r for (int8, gated_, name), r
                          in r_ffn_edges.items() if not int8 and not gated_}
        gated = {n: {k[1]: r for k, r in r_gated.items() if k[0] == int8}
                 for n, int8 in (('ffn_tail_gated', False),
                                 ('ffn_tail_gated_int8', True))}
        # both attention kernels at G = 4 (Llama-3-8B's groups)
        r_gqa = {(int8, dense): check_attention_gqa(dtype, int8, dense, t)
                 for int8 in (True, False) for dense in (False, True)}
        # the lm_head kernels at d 4096 over Llama-3-8B's vocabulary and the
        # 32,000 of LLaMA-7B (and of phase 3's cut), and block-sparse prefill
        # at d_head 128: B=8 x 32 heads at S 2048 (the serving shape), and
        # one slot's 32 heads at S 4096, sparse_coeff 4 (off-diagonal tiles)
        r_head_ll = {f'llama d={D_LL} V={v}': check_lm_head(
            dtype, t, D_LL, v) for v in (VOCAB_38B, VOCAB_7B)}
        r_head8_ll = {f'llama d={D_LL} V={v}': check_lm_head_int8(
            dtype, D_LL, t, v) for v in (VOCAB_38B, VOCAB_7B)}
        r_edges = check_lm_head_edges(dtype)
        r_values = check_head_values(dtype)
        r_bsa_ll = check_block_sparse(dtype, PROMPT, 8, t, B * HEADS_LL,
                                      DH_LL, N_SUB_LL)
        check_block_sparse(dtype, 2 * PROMPT, 4, None, HEADS_LL, DH_LL,
                           N_SUB_LL)
        # the speculative block verify (OPT-125M and Llama-3-8B, union and
        # dense tables at max_len 2304)
        r_ver = {f'{model} {"dense" if dense else "union"}': check_verify(
            dtype, model, dense, t) for model in ('opt-125m', 'llama-3-8b')
            for dense in (False, True)}
        # K = 30 (k = 29, the int32 selection bitfield's limit) at G = 4:
        # 120 query rows, past one CTA's shared memory: the split launch
        r_ver['llama-3-8b union K=30'] = check_verify(
            dtype, 'llama-3-8b', False, t, kk=30)
        # the paged-attention kernel (OPT-125M and Llama-3-8B, fp and int8
        # pages), the tile-pool kernel, and both decode attention kernels
        # over a dense Llama-3-8B table of 96 tiles (the two-pass walk)
        r_paged = {f'{model} {"int8" if int8 else "fp"}': check_paged(
            dtype, model, int8, t) for model in ('opt-125m', 'llama-3-8b')
            for int8 in (False, True)}
        r_paged_edges = check_paged_edges(dtype)
        r_ver_edges = check_verify_edges(dtype)
        r_pool = check_tile_pool(dtype, t)
        r_walk = {int8: check_attention_gqa(dtype, int8, True, t, nt=97,
                                            pos0=96 * TILE - B, layers=2)
                  for int8 in (False, True)}
        # past the one-pass kernel's shared memory: the two-pass walk in
        # f32; in bf16 the split walks, which serve any table
        require(all(r['walk'] == ('split' if dtype == torch.bfloat16
                                  else 'two-pass')
                    for int8, r in r_walk.items()),
                f'the 96-tile table takes the two-pass walk or the split '
                f'one: {[r["walk"] for r in r_walk.values()]}')
        # the decode front's and the int8 attention's edges
        r_front_edges = check_front_edges(dtype, t)
        r_attn_edges = check_attention_edges(dtype, t)
        # the bf16-KV attention's and the block-sparse forward's edges
        r_rows_edges = check_rows_edges(dtype, t)
        r_bsa_edges = check_block_sparse_edges(dtype)
        if t is not None:
            res = dict(
                decode_front=dict(r_front, bf16_kv=r_front_bf,
                                  packed_int8=r_front8,
                                  packed_int8_bf16_kv=r_front8_bf,
                                  **r_fl, **{f'edge {k}': v for k, v
                                             in r_front_edges.items()}),
                decode_attention_rows_q=dict(
                    r_attn, dense_tps4=r_attn_d,
                    gqa_llama_3_8b_sparse=r_gqa[True, False],
                    gqa_llama_3_8b_dense=r_gqa[True, True],
                    gqa_llama_3_8b_dense_96_tiles=r_walk[True],
                    **{f'edge {k}': v for k, v in r_attn_edges.items()}),
                paged_attention=dict(r_paged['opt-125m fp'], **r_paged,
                                     **{f'edge {k}': v for k, v
                                        in r_paged_edges.items()}),
                decode_attention=r_pool,
                lm_head_argmax=dict(r_head, **r_head_ll,
                                    **r_edges['lm_head_argmax'],
                                    **r_values['lm_head_argmax']),
                block_sparse_attention=dict(
                    r_bsa, llama_d_head_128=r_bsa_ll,
                    **{f'edge {k}': v for k, v in r_bsa_edges.items()}),
                **r_train,
                decode_attention_rows=dict(
                    r_rows, dense_tps4=r_rows4, sparse=r_rows_s,
                    gqa_llama_3_8b_sparse=r_gqa[False, False],
                    gqa_llama_3_8b_dense=r_gqa[False, True],
                    gqa_llama_3_8b_dense_96_tiles=r_walk[False],
                    **{f'edge {k}': v for k, v in r_rows_edges.items()}),
                ffn_tail=dict(r_ffn, opt_1p3b=r_ffn13, **r_ffn_fp_edges),
                int8_matmul=dict(r_mm['decode o 125m'], **{
                    k: v for k, v in r_mm.items() if k != 'decode o 125m'}),
                int8_matmul_t=dict(r_mmt['llama-7b gate/side dx'], **r_mmt),
                gmm=r_gmm, tgmm=r_tgmm,
                **{n: dict(r_flash['opt-125m S=512'][n], **{
                    shape: r[n] for shape, r in r_flash.items()})
                   for n in FLASH_KERNELS},
                lm_head_argmax_int8=dict(r_head8, opt_1p3b=r_head8_13,
                                         **r_head8_ll,
                                         **r_edges['lm_head_argmax_int8'],
                                         **r_values['lm_head_argmax_int8']),
                ffn_tail_int8=dict(r_ffn8, opt_1p3b=r_ffn8_13,
                                   **r_ffn8_edges),
                verify_attention_rows=dict(r_ver['opt-125m union'],
                                           **r_ver,
                                           **{f'edge {k}': v for k, v
                                              in r_ver_edges.items()}),
                # the kernel line reports Llama-3-8B at m = 8 (its run)
                **{n: dict(r[f'llama-3-8b m={B}'], **r)
                   for n, r in gated.items()})
        del front_out, front_bf
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 3, 4 and 5: the main paths through the engine
# ---------------------------------------------------------------------------

def opt_cfg(name, max_length, dtype, dense=False, **kw):
    from spt_proto_tpu_torch.config import opt_config
    return opt_config(name, max_length=max_length, dtype=dtype,
                      param_dtype=dtype,
                      attention='dense' if dense else 'sparse_v2',
                      pq_metric='l2', attn_impl='pallas', **kw)


def llama_cfg(name, max_length, dtype, dense=False, **kw):
    from spt_proto_tpu_torch.config import llama_config
    return llama_config(name, max_length=max_length, dtype=dtype,
                        param_dtype=dtype,
                        attention='dense' if dense else 'sparse_v2',
                        pq_metric='l2', attn_impl='pallas', **kw)


def dense_params(params):
    """The same weights without the PQ codebook (bench.py's dense model is
    the sparse one before its PQ upgrade)."""
    mha = {k: v for k, v in params['blocks']['mha'].items()
           if k != 'quantizer'}
    return {**params, 'blocks': {**params['blocks'], 'mha': mha}}


def greedy(iw, tokens, max_len, steps, dev, quantized):
    from spt_proto_tpu_torch.inference import engine
    cache = engine.KVCache.create(iw.cfg, tokens.shape[0], max_len,
                                  dtype=iw.cfg.dtype, quantized=quantized,
                                  device=dev)
    logits, cache = engine.prefill(iw, tokens, cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    out = []
    for _ in range(steps):
        tok, cache = engine.decode_step_greedy(iw, tok, cache)
        out.append(tok)
    return logits, torch.stack(out, 1)


class SelectionTap:
    """Gives each card decode step the CPU twins' PQ codes and tile tables
    (stepwise w8 parity). Inside `with tap:` the engine's decode_front is
    wrapped. A call on CPU tensors (the twins' step, taken first) runs the
    twin and is recorded, layer by layer. A call on CUDA tensors (the
    card's step from the same state) launches the kernel, is held against
    the record of the same layer, and passes on the twins' new key codes
    and tables in place of its own; its q / k / v / int8 k and v are the
    card's. Where the card's codes or tables differ from the twins', the
    difference must be one the gap between the card's and the twins'
    vectors can make: for z = the twins' k (or a query row), z' = the
    card's and codeword c, the score |c|^2 - 2 z.c moves by at most
    2 |z' - z|_sub |c - c'| between two codewords c, c' of a subspace, so
    a flipped key code c must lie within that of the twins' best code's
    score (+ 1e-4 of the scale for the f32 sums), and a table row may
    differ only where some query row of its group has a code that close
    to its best. Anything else raises."""

    def __init__(self):
        self.rec = collections.deque()
        self.stats = dict(fronts=0, key_codes=0, key_code_flips=0,
                          table_rows=0, table_row_flips=0)

    def __enter__(self):
        from spt_proto_tpu_torch.inference import engine
        self.engine, self.orig = engine, engine.decode_front
        engine.decode_front = self
        return self

    def __exit__(self, *exc):
        self.engine.decode_front = self.orig

    def __call__(self, *args, **kw):
        out = self.orig(*args, **kw)
        if args[0].device.type == 'cpu':
            self.rec.append((args, kw, out))
            return out
        t_args, t_kw, twin = self.rec.popleft()
        self.compare(t_args[5], t_args[6], t_kw['n_sub'], twin,
                     [o.cpu() for o in out[:5]])
        return tuple(out[:3]) + tuple(o.to(DEV) for o in twin[3:5]) \
            + tuple(out[5:])

    def room(self, bd, cbn, n_sub, z_t, z_c, best):
        """[N, n_sub, n_code]: how far each codeword's score (the twins' z)
        lies above the best code's, less what the card's z can move it;
        <= 0 where the card may pick that codeword."""
        bd, cbn = bd.float(), cbn.float().reshape(-1)
        n, n_code = z_t.shape[0], bd.shape[1] // n_sub
        sc = (cbn - 2 * z_t @ bd).reshape(n, n_sub, n_code)
        gap = sc - sc.gather(-1, best.long()[..., None])
        dist = (cbn[:, None] + cbn[None, :] - 2 * bd.T @ bd).clamp(
            min=0).sqrt().reshape(n_sub, n_code, n_sub, n_code).diagonal(
            dim1=0, dim2=2).permute(2, 0, 1)          # [n_sub, code, code]
        d_best = dist[torch.arange(n_sub)[None], best.long()]
        dz = (z_c - z_t).reshape(n, n_sub, -1).norm(dim=-1)
        zn = z_t.reshape(n, n_sub, -1).norm(dim=-1)
        cb = cbn.reshape(n_sub, n_code).max(-1).values
        eps = 1e-4 * (1 + zn * cb.sqrt() + cb)
        return gap - 2 * dz[..., None] * d_best - eps[..., None]

    def compare(self, bd, cbn, n_sub, twin, card):
        q_t, k_t, _, cn_t, tb_t = twin[:5]
        q_c, k_c, _, cn_c, tb_c = card
        b, kv, _ = cn_t.shape
        dh = bd.shape[0]
        n_code = bd.shape[1] // n_sub
        zk_t, zk_c = (z.float().reshape(b * kv, dh) for z in (k_t, k_c))
        best_k = cn_t[..., :n_sub].reshape(b * kv, n_sub)
        got_k = cn_c[..., :n_sub].reshape(b * kv, n_sub)
        room_k = self.room(bd, cbn, n_sub, zk_t, zk_c, best_k)
        flip_k = got_k != best_k
        bad_k = flip_k & (room_k.gather(
            -1, got_k.long().clamp(0, n_code - 1)[..., None])[..., 0] > 0)
        zq_t, zq_c = (z.float().reshape(-1, dh) for z in (q_t, q_c))
        sc_q = (cbn.float().reshape(-1) - 2 * zq_t @ bd.float()).reshape(
            zq_t.shape[0], n_sub, n_code)
        best_q = sc_q.argmin(-1)
        near = (self.room(bd, cbn, n_sub, zq_t, zq_c, best_q) <= 0).sum(-1) > 1
        may_flip = near.reshape(b, kv, -1).any(-1)    # [B, KV]
        flip_row = (tb_c != tb_t).any(-1)
        bad_rows = flip_row & ~may_flip
        pads_equal = torch.equal(cn_c[..., n_sub:], cn_t[..., n_sub:])
        st = self.stats
        st['fronts'] += 1
        st['key_codes'] += flip_k.numel()
        st['key_code_flips'] += int(flip_k.sum())
        st['table_rows'] += flip_row.numel()
        st['table_row_flips'] += int(flip_row.sum())
        require(not bool(bad_k.any()) and not bool(bad_rows.any())
                and pads_equal,
                f'decode_front in the engine: {int(bad_k.sum())} key codes '
                f'and {int(bad_rows.sum())} table rows differ from the '
                f'twins\' where the card\'s k / q cannot explain it (pad '
                f'columns equal: {pads_equal}); tables {tb_c.tolist()} vs '
                f'{tb_t.tolist()}')

    def step_done(self):
        require(not self.rec, f'{len(self.rec)} twin front calls unmatched')


class RouterTap:
    """Records the routed FFN's top-k choices (router_gates' masks) and the
    router probabilities of every call made inside `with tap:`, in call
    order: one call a layer of a prefill. With `replay` (the CPU twins'
    tap of the same prefill) each call also returns the twins' choices in
    place of its own, as SelectionTap does for the PQ codes, and a choice
    that differs must be a near-tie the drift can cross: the twins' margin
    between their k-th and (k+1)-th probability at most twice the largest
    gap between the card's and the twins' probabilities of that token."""

    def __init__(self, replay=None):
        self.calls, self.replay = [], replay
        self.flips, self.unexplained, self.max_margin = 0, 0, 0.0

    def __enter__(self):
        from spt_proto_tpu_torch.ops import routed_ffn
        self.mod, self.orig = routed_ffn, routed_ffn.router_gates
        routed_ffn.router_gates = self
        return self

    def __exit__(self, *exc):
        self.mod.router_gates = self.orig

    def __call__(self, probs, top_k):
        gates = self.orig(probs, top_k)
        n = gates.shape[-1]
        self.calls.append((gates.cpu().reshape(-1, n),
                           probs.float().cpu().reshape(-1, n), top_k))
        if self.replay is None:
            return gates
        g_t, p_t, _ = self.replay[len(self.calls) - 1]
        g_c, p_c, _ = self.calls[-1]
        diff = (g_t != g_c).any(-1)
        if diff.any():
            top = p_t[diff].sort(-1, descending=True).values
            margin = top[:, top_k - 1] - top[:, top_k]
            drift = (p_c[diff] - p_t[diff]).abs().amax(-1)
            self.flips += int(diff.sum())
            self.unexplained += int((margin > 2 * drift + 1e-6).sum())
            self.max_margin = max(self.max_margin, margin.max().item())
        return g_t.to(gates.device).reshape(gates.shape)


def routed_prefill(iw_cpu, iw_gpu, tokens, create):
    """The w8 prefill of a routed FFN, card vs CPU twins. Free-running, the
    card's routing may part from the twins' at a router near-tie, and a
    token routed to other blocks gets another FFN output; through causal
    attention that reaches the later tokens of its row only. So: (a) the
    card's free prefill, its (layer, token) top-k flips against the twins',
    the flipped tokens, and its logits split at each row's first flipped
    position (the tokens before it must sit within W8_LOGIT_BOUND, and so
    must every token past the bound lie at or after it); (b) the card's
    prefill with the twins' routing (RouterTap's replay), whose logits are
    held to W8_LOGIT_BOUND on every token and whose flips must each be a
    near-tie. Returns (the twins' logits and cache, (b)'s logits, the
    counts, ok)."""
    from spt_proto_tpu_torch.inference import engine
    with RouterTap() as twins:
        lg_pre, cache = engine.prefill(iw_cpu, tokens, create('cpu'))
    if not twins.calls:
        lg_g, _ = engine.prefill(iw_gpu, tokens.to(DEV), create(DEV))
        return lg_pre, cache, lg_g, None, True
    b, s = tokens.shape
    with RouterTap() as free:
        lg_free, _ = engine.prefill(iw_gpu, tokens.to(DEV), create(DEV))
    with RouterTap(replay=twins.calls) as card:
        lg_g, _ = engine.prefill(iw_gpu, tokens.to(DEV), create(DEV))
    require(len(free.calls) == len(twins.calls) == len(card.calls),
            f'router calls: {len(twins.calls)} on the CPU, '
            f'{len(free.calls)} / {len(card.calls)} on the card')
    flipped = torch.zeros(b, s, dtype=torch.bool)
    pairs = 0
    for (g_t, _, _), (g_c, _, _) in zip(twins.calls, free.calls):
        diff = (g_t != g_c).any(-1).reshape(b, s)
        flipped |= diff
        pairs += int(diff.sum())
    pos = torch.arange(s)
    first = torch.where(flipped, pos, s).amin(-1)          # [B]
    before = pos[None] < first[:, None]
    tok_err = (lg_free.cpu() - lg_pre).abs().amax(-1)      # [B, S]
    big = tok_err > W8_LOGIT_BOUND
    replay_err = max_err(lg_g.cpu(), lg_pre)
    counts = dict(
        layers=len(twins.calls), tokens=b * s, layer_token_flips=pairs,
        flipped_tokens=int(flipped.sum()), first_flip=first.tolist(),
        err_before_first_flip=tok_err[before].max().item()
        if before.any() else 0.0,
        err_flipped=tok_err[flipped].max().item() if flipped.any() else 0.0,
        tokens_past_bound=int(big.sum()),
        tokens_past_bound_before_first_flip=int((big & before).sum()),
        replay_flips=card.flips, replay_unexplained=card.unexplained,
        replay_max_margin=card.max_margin, replay_logits_err=replay_err)
    ok = (counts['err_before_first_flip'] <= W8_LOGIT_BOUND
          and not counts['tokens_past_bound_before_first_flip']
          and not card.unexplained and replay_err <= W8_LOGIT_BOUND)
    return lg_pre, cache, lg_g, counts, ok


def stepwise(iw_cpu, iw_gpu, tokens, max_len, steps, quantized):
    """Greedy decisions of the card from the CPU twins' state: both
    prefill; then before each step the card gets a copy of the twins'
    cache and their token, the twins take their step, and the card takes
    its greedy step through its kernels with the twins' codes and tables
    (SelectionTap); a routed FFN's card prefill takes the twins' routing
    (routed_prefill). Returns the prefill logits of both, the twins' logits
    at each decision [B, 1 + steps, V], the card's choices [B, 1 + steps],
    the tap's counts and, for a routed FFN, routed_prefill's counts and
    verdict."""
    from spt_proto_tpu_torch.inference import engine

    def create(dev):
        return engine.KVCache.create(iw_cpu.cfg, tokens.shape[0], max_len,
                                     dtype=iw_cpu.cfg.dtype,
                                     quantized=quantized, device=dev)
    lg_pre, cache, lg_pre_g, routing, routing_ok = routed_prefill(
        iw_cpu, iw_gpu, tokens, create)
    logits = [lg_pre[:, -1]]
    chosen = [torch.argmax(lg_pre_g[:, -1], -1).to(torch.int32).cpu()]
    tok = torch.argmax(lg_pre[:, -1], -1).to(torch.int32)
    with SelectionTap() as tap:
        for _ in range(steps):
            card = engine.KVCache(**{
                f: None if getattr(cache, f) is None
                else getattr(cache, f).to(DEV)
                for f in ('k', 'v', 'codes', 'length', 'k_scale',
                          'v_scale')})
            lg, cache = engine.decode_step(iw_cpu, tok, cache)
            t_g, _ = engine.decode_step_greedy(iw_gpu, tok.to(DEV), card)
            tap.step_done()
            logits.append(lg)
            chosen.append(t_g.cpu())
            tok = torch.argmax(lg, -1).to(torch.int32)
    return (lg_pre, lg_pre_g, torch.stack(logits, 1), torch.stack(chosen, 1),
            tap.stats, (routing, routing_ok))


PARITY_B, PARITY_PROMPT, PARITY_STEPS = 2, 512, 8
# the standing bound of w8 logits against a reference (the port's tests and
# verify_parity over int8 weights)
W8_LOGIT_BOUND = 2e-2
PARITY_MAX_LEN = PARITY_PROMPT + TILE


def phase_parity():
    """f32 OPT-125M at full width: kernels on the card vs twins on the CPU,
    in six decode modes (two with int8 weights, built staged on the card
    from the CPU tree)."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    max_len = PARITY_MAX_LEN
    sparse = opt_cfg('125m', max_len, torch.float32)
    params = init_params(sparse, SEED, device='cpu')
    tokens = torch.randint(1, VOCAB, (PARITY_B, PARITY_PROMPT),
                           generator=gen(SEED, 'cpu'))
    dense = opt_cfg('125m', max_len, torch.float32, dense=True)
    modes = parity_modes('OPT-125M', tokens, [
        ('sparse int8-KV', sparse, params, True, None),
        ('dense f32-KV', dense, dense_params(params), False, None),
        ('sparse f32-KV', sparse, params, False, None),
        ('sparse l1 unfused front int8-KV', sparse.replace(pq_metric='l1'),
         params, True, None),
        ('w8 sparse int8-KV', sparse, params, True, 'int8'),
        ('w8 dense f32-KV', dense, dense_params(params), False, 'int8')])
    verify = verify_parity('OPT-125M', tokens, [
        ('sparse f32-KV', sparse, params, False),
        ('dense f32-KV', dense, dense_params(params), False),
        ('sparse int8-KV', sparse, params, True)])
    spec = speculative_parity('OPT-125M', sparse, params, True)
    return dict(modes=modes, verify=verify, speculative=spec)


def phase_parity_llama():
    """f32 Llama-3-8B at full width (d_model 4096, 32 query heads over 8 kv
    heads, d_ff 14336) cut to 2 layers and a 32,000-token vocabulary (the
    CPU twins' time): sparse int8-KV through the triple front and dense
    f32-KV free-running, and with int8 weights sparse int8-KV (the
    triple_int8 front, the gated int8 tail) stepwise."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    max_len = PARITY_MAX_LEN
    sparse = llama_cfg('3-8b', max_len, torch.float32, n_layers=2,
                       vocab_size=32000)
    params = init_params(sparse, SEED, device='cpu')
    tokens = torch.randint(1, 32000, (PARITY_B, PARITY_PROMPT),
                           generator=gen(SEED, 'cpu'))
    dense = llama_cfg('3-8b', max_len, torch.float32, dense=True,
                      n_layers=2, vocab_size=32000)
    modes = parity_modes('Llama-3-8B 2-layer', tokens, [
        ('sparse int8-KV', sparse, params, True, None),
        ('dense f32-KV', dense, dense_params(params), False, None),
        ('w8 sparse int8-KV', sparse, params, True, 'int8')])
    verify = verify_parity('Llama-3-8B 2-layer', tokens, [
        ('sparse f32-KV', sparse, params, False),
        ('dense f32-KV', dense, dense_params(params), False)])
    spec = speculative_parity('Llama-3-8B 2-layer', sparse, params, False)
    return dict(modes=modes, verify=verify, speculative=spec)


def parity_modes(model, tokens, modes):
    """Each (label, cfg, params, int8 KV, weight quantization) mode at f32:
    the card's kernels against the CPU twins on the same prompts."""
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    b, steps, max_len = PARITY_B, PARITY_STEPS, PARITY_MAX_LEN
    prompt = tokens.shape[1]
    out = {}
    for label, cfg, p, quantized, quant in modes:
        iw_cpu = InferenceWeights.from_params(cfg, p, quant=quant)
        iw_gpu = InferenceWeights.from_params(cfg, p, quant=quant, device=DEV)
        t0 = time.perf_counter()
        if quant is None:
            lg_gpu, tok_gpu = greedy(iw_gpu, tokens.to(DEV), max_len, steps,
                                     DEV, quantized)
            lg_cpu, tok_cpu = greedy(iw_cpu, tokens, max_len, steps, 'cpu',
                                     quantized)
            agree = (tok_gpu.cpu() == tok_cpu).float().mean().item()
            lg_err = max_err(lg_gpu.cpu(), lg_cpu)
            res = dict(agreement=agree, logits_max_err=lg_err)
            msg = f'greedy token agreement {agree} over {b}x{steps}'
            ok = agree >= 0.995
        else:
            # int8 weights round every projection's input to bf16: an f32
            # ulp between the card's and the CPU's plain ops (norm sums)
            # becomes a bf16 step of that operand where it sits on a
            # rounding boundary; the logits of one step drift by ~5e-3,
            # and a PQ code at a near-tie can flip and select other tiles,
            # so two free-running greedy runs part. Each card decision is
            # taken from the twins' own state (prefill, then their cache,
            # token, codes and tables before every step: SelectionTap,
            # which fails on a code or table the drift cannot explain) and
            # must agree with theirs, or lie within one bf16 step (2^-7
            # |max logit|) of their maximum.
            lg_cpu_pre, lg_gpu, lg_cpu, chosen, tap, routing = stepwise(
                iw_cpu, iw_gpu, tokens, max_len, steps, quantized)
            top = lg_cpu.max(-1).values
            gap = top - lg_cpu.gather(2, chosen.long()[..., None])[..., 0]
            tol = 2.0 ** -7 * lg_cpu.abs().max(-1).values
            agree = (torch.argmax(lg_cpu, -1) == chosen).float().mean().item()
            lg_err = max_err(lg_gpu.cpu(), lg_cpu_pre)
            res = dict(agreement=agree, max_gap=gap.max().item(),
                       logits_max_err=lg_err, selection=tap)
            msg = (f'stepwise greedy agreement {agree} over {b}x{steps + 1}, '
                   f'max chosen-logit gap {gap.max().item():.3g} (tol 2^-7 '
                   f'|max logit| >= {tol.min().item():.3g}); card front vs '
                   f'twins: {tap["key_code_flips"]} of {tap["key_codes"]} '
                   f'key codes and {tap["table_row_flips"]} of '
                   f'{tap["table_rows"]} table rows differ, each within '
                   f'the drift')
            ok = bool((gap <= tol).all())
            counts, routing_ok = routing
            if counts is not None:
                res['routing'] = counts
                msg += (f'; routed prefill, free-running: '
                        f'{counts["layer_token_flips"]} (layer, token) '
                        f'top-k flips over {counts["layers"]} layers x '
                        f'{counts["tokens"]} tokens, on '
                        f'{counts["flipped_tokens"]} tokens, the rows\' first '
                        f'at {counts["first_flip"]}; logits max err '
                        f'{counts["err_before_first_flip"]:.3g} before it '
                        f'(bound {W8_LOGIT_BOUND}), '
                        f'{counts["err_flipped"]:.3g} on flipped tokens, '
                        f'{counts["tokens_past_bound"]} tokens past the '
                        f'bound ({counts["tokens_past_bound_before_first_flip"]}'
                        f' before a flip); with the twins\' routing: '
                        f'{counts["replay_flips"]} flips, margins <= '
                        f'{counts["replay_max_margin"]:.3g}, '
                        f'{counts["replay_unexplained"]} past the drift, '
                        f'logits max err {counts["replay_logits_err"]:.3g} '
                        f'(bound {W8_LOGIT_BOUND})')
                ok = ok and routing_ok
            tok_gpu = chosen
        t2 = time.perf_counter()
        log(f'  {label:32s} f32 {model} B={b} prompt {prompt}: prefill '
            f'logits max err {lg_err:.3g}; {msg} ({t2 - t0:.1f} s)')
        require(ok, f'{label}: {msg}: {tok_gpu.tolist()}')
        out[label] = res
        del iw_gpu
    torch.cuda.empty_cache()
    return out


class CodeTap:
    """Gives the card's run the CPU twins' PQ codes. Inside `with tap:` the
    engine's _encode_codes is wrapped: a call on CPU tensors (the twins'
    run, taken first) records its codes; a call on CUDA tensors (the card's
    run of the same calls, in the same order) computes its own, counts
    where they differ from the record, and passes the twins' codes on, so
    the card's tile selection and tables are the twins' too."""

    def __init__(self):
        self.rec = collections.deque()
        self.codes = self.flips = 0

    def __enter__(self):
        from spt_proto_tpu_torch.inference import engine
        self.engine, self.orig = engine, engine._encode_codes
        engine._encode_codes = self
        return self

    def __exit__(self, *exc):
        self.engine._encode_codes = self.orig

    def __call__(self, cfg, quantizer, x, bd=None):
        out = self.orig(cfg, quantizer, x, bd=bd)
        if x.device.type == 'cpu':
            self.rec.append(out)
            return out
        twin = self.rec.popleft()
        require(twin.shape == out.shape, f'codes {tuple(out.shape)} vs the '
                f'twins\' {tuple(twin.shape)}')
        self.codes += out.numel()
        self.flips += int((out.cpu() != twin).sum())
        return twin.to(out.device)

    def done(self):
        require(not self.rec, f'{len(self.rec)} twin encode calls unmatched')


CACHE_FIELDS = ('k', 'v', 'codes', 'length', 'k_scale', 'v_scale')


def copy_cache(cache, dev):
    """A copy of a KVCache's tensors on `dev`."""
    from spt_proto_tpu_torch.inference import engine
    return engine.KVCache(**{
        f: None if getattr(cache, f) is None
        else getattr(cache, f).to(dev, copy=True) for f in CACHE_FIELDS})


def verify_parity(model, tokens, modes):
    """f32 at full width, B=2, prompt 512, max_len 640, a block of K = 5
    random tokens: (a) on the card, from one prefilled cache, one
    verify_step against K sequential decode_step calls (the kernels of
    each: the verify kernel, or the plain path over an int8 cache, against
    the decode front and decode attention kernels); (b) the card's
    verify_step against the CPU twins', each from its own prefill, with the
    card's PQ codes taken from the twins' (CodeTap: a code an ulp of k or q
    flips would select other tiles and part the logits by far more than
    rounding; the card's own codes may differ from the twins' in <= 1e-3
    of them, counted). Bounds:
    logits within 2e-3 (f32 sums of full-width rows in other orders; the
    JAX tests hold a tiny model to 5e-4 - 1e-3) or 2e-2 over an int8 cache
    (a new column whose projections differ by an ulp can land one int8 step
    away), greedy decisions agreeing at >= 0.995 of the positions; the
    caches of (a): f32 entries to 1e-4, int8 entries within one step in <=
    1e-3 of them, scales to 1e-5 relative, codes flipped in <= 1e-3 of the
    block's code entries (an ulp at an argmin near-tie)."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    b, max_len = PARITY_B, PARITY_MAX_LEN
    out = {}
    for label, cfg, p, quantized in modes:
        block = torch.randint(1, cfg.vocab_size, (b, KK),
                              generator=gen(SEED + 13, 'cpu'))
        iw_cpu = InferenceWeights.from_params(cfg, p)
        iw_gpu = InferenceWeights.from_params(cfg, p, device=DEV)

        def prefilled(iw, dev):
            cache = engine.KVCache.create(cfg, b, max_len, dtype=cfg.dtype,
                                          quantized=quantized, device=dev)
            return engine.prefill(iw, tokens.to(dev), cache)[1]
        t0 = time.perf_counter()
        card = prefilled(iw_gpu, DEV)
        seq_cache = copy_cache(card, DEV)
        seq = []
        for j in range(KK):
            lg, seq_cache = engine.decode_step(iw_gpu, block[:, j].to(DEV),
                                               seq_cache)
            seq.append(lg)
        seq = torch.stack(seq, 1).cpu()
        blk, card = engine.verify_step(iw_gpu, block.to(DEV), card)
        blk = blk.cpu()
        tap = CodeTap()
        with tap:
            blk_cpu, _ = engine.verify_step(iw_cpu, block,
                                            prefilled(iw_cpu, 'cpu'))
            blk_tap, _ = engine.verify_step(iw_gpu, block.to(DEV),
                                            prefilled(iw_gpu, DEV))
        tap.done()
        blk_tap = blk_tap.cpu()
        sync()
        bound = 2e-2 if quantized else 2e-3
        err_seq, err_cpu = max_err(blk, seq), max_err(blk_tap, blk_cpu)
        agree_seq = mismatch(blk.argmax(-1), seq.argmax(-1))
        agree_cpu = mismatch(blk_tap.argmax(-1), blk_cpu.argmax(-1))
        agree_seq, agree_cpu = 1 - agree_seq, 1 - agree_cpu
        cache_msg, cache_ok = [], True
        for f in ('k', 'v'):
            a, c = getattr(card, f), getattr(seq_cache, f)
            if quantized:
                d = (a.int() - c.int()).abs()
                ok = int(d.max()) <= 1 and mismatch(a, c) <= 1e-3
                cache_msg.append(f'{f} int8 steps {int(d.max())} in '
                                 f'{mismatch(a, c):.2g}')
            else:
                ok = max_err(a, c) <= 1e-4
                cache_msg.append(f'{f} err {max_err(a, c):.3g}')
            cache_ok &= ok
        if quantized:
            s_err = max(((getattr(card, f) - getattr(seq_cache, f)).abs()
                         / getattr(seq_cache, f).abs().clamp(min=1e-30)
                         ).max().item() for f in ('k_scale', 'v_scale'))
            cache_ok &= s_err <= 1e-5
            cache_msg.append(f'scales rel err {s_err:.2g}')
        flips = int((card.codes != seq_cache.codes).sum())
        n_new = b * cfg.kv_heads * KK * cfg.n_layers * card.codes.shape[3]
        cache_ok &= flips <= 1e-3 * n_new and torch.equal(card.length,
                                                          seq_cache.length)
        cache_msg.append(f'codes flipped {flips} of {n_new}')
        cache_ok &= tap.flips <= 1e-3 * max(tap.codes, 1)
        msg = (f'verify vs {KK} decode steps: logits err {err_seq:.3g}, '
               f'decisions {agree_seq}; card vs CPU twins (the twins\' '
               f'codes; the card\'s own differ in {tap.flips} of '
               f'{tap.codes}): logits err {err_cpu:.3g}, decisions '
               f'{agree_cpu} (bound {bound:g}, >= 0.995); caches '
               f'{", ".join(cache_msg)}')
        log(f'  {label:16s} f32 {model} verify K={KK}: {msg} '
            f'({time.perf_counter() - t0:.1f} s)')
        require(err_seq <= bound and err_cpu <= bound and agree_seq >= 0.995
                and agree_cpu >= 0.995 and cache_ok, f'{label}: {msg}')
        out[label] = dict(logits_err_vs_decode=err_seq,
                          logits_err_vs_cpu=err_cpu,
                          agreement_vs_decode=agree_seq,
                          agreement_vs_cpu=agree_cpu, code_flips=flips,
                          card_code_flips_vs_cpu=tap.flips)
        del iw_gpu, card, seq_cache
    torch.cuda.empty_cache()
    return out


def spec_workload(vocab, b=B, prompt=PROMPT):
    """bench_serving.py's speculative prompts: a 16-token random phrase
    (numpy seed 7), shifted by the row index, tiled through the prompt."""
    import numpy as np
    phrase = np.random.RandomState(7).randint(1, vocab, size=SPEC_PERIOD)
    rows = [np.tile(phrase + i, prompt // SPEC_PERIOD + 1)[:prompt] % vocab
            for i in range(b)]
    return torch.tensor(np.stack(rows), dtype=torch.int64, device=DEV)


SPEC_PARITY_NEW = 16


def speculative_parity(model, cfg, params, self_draft):
    """f32 at full width, B=2, prompt 512 (the speculative workload's
    phrase), max_len 640: greedy generate_speculative (n-gram, and the
    model as its own draft) against greedy generate() on the card, 16 new
    tokens, held to the fp policy (>= 0.995 token agreement)."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.speculative import \
        generate_speculative
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    iw = InferenceWeights.from_params(cfg, params, device=DEV)
    prompts = spec_workload(cfg.vocab_size, PARITY_B, PARITY_PROMPT)
    ref = engine.generate(iw, prompts, SPEC_PARITY_NEW,
                          max_len=PARITY_MAX_LEN)
    out = {}
    for name, draft in (('n-gram', None),) + (
            (('self-draft', iw),) if self_draft else ()):
        got, st = generate_speculative(iw, prompts, SPEC_PARITY_NEW,
                                       draft=draft, k=SPEC_K,
                                       max_len=PARITY_MAX_LEN)
        agree = (got[:, PARITY_PROMPT:] == ref[:, PARITY_PROMPT:]
                 ).float().mean().item()
        log(f'  speculative {name:10s} f32 {model}: token agreement with '
            f'generate() {agree} over {PARITY_B}x{SPEC_PARITY_NEW}, '
            f'acceptance {st["acceptance"]:.3f} in {st["rounds"]} rounds')
        require(got.shape == ref.shape and agree >= 0.995,
                f'speculative {name} {model}: agreement {agree}: '
                f'{got.tolist()} vs {ref.tolist()}')
        out[name] = dict(agreement=agree, **st)
    del iw
    torch.cuda.empty_cache()
    return out


def wrappers():
    from spt_proto_tpu_torch.ops.block_sparse_attention import (
        block_sparse_attention, block_sparse_attention_dkv,
        block_sparse_attention_dq, block_sparse_attention_lse)
    from spt_proto_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_rows, decode_attention_rows_q,
        verify_attention_rows)
    from spt_proto_tpu_torch.ops.decode_front import decode_front
    from spt_proto_tpu_torch.ops.ffn_tail import (ffn_tail, ffn_tail_gated,
                                                  ffn_tail_gated_int8,
                                                  ffn_tail_int8)
    from spt_proto_tpu_torch.ops.flash_attention import (
        flash_attention_dkv, flash_attention_dq, flash_attention_fwd)
    from spt_proto_tpu_torch.ops.gmm import gmm, tgmm
    from spt_proto_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_t
    from spt_proto_tpu_torch.ops.lm_head import (lm_head_argmax,
                                                 lm_head_argmax_int8)
    from spt_proto_tpu_torch.ops.paged_attention import paged_attention
    return dict(decode_front=decode_front,
                decode_attention_rows_q=decode_attention_rows_q,
                lm_head_argmax=lm_head_argmax,
                block_sparse_attention=block_sparse_attention,
                decode_attention_rows=decode_attention_rows,
                ffn_tail=ffn_tail, int8_matmul=int8_matmul,
                lm_head_argmax_int8=lm_head_argmax_int8,
                ffn_tail_int8=ffn_tail_int8, ffn_tail_gated=ffn_tail_gated,
                ffn_tail_gated_int8=ffn_tail_gated_int8,
                verify_attention_rows=verify_attention_rows,
                paged_attention=paged_attention,
                decode_attention=decode_attention,
                block_sparse_attention_lse=block_sparse_attention_lse,
                block_sparse_attention_dq=block_sparse_attention_dq,
                block_sparse_attention_dkv=block_sparse_attention_dkv,
                int8_matmul_t=int8_matmul_t, gmm=gmm, tgmm=tgmm,
                flash_attention=flash_attention_fwd,
                flash_attention_dq=flash_attention_dq,
                flash_attention_dkv=flash_attention_dkv)


def expected_launches(iw, quantized):
    """Launches per prefill and per decode step on each mode's path. With
    int8 weights (w8) every projection outside the fused kernels is one
    int8_matmul: per prefill the q/k/v projection (one packed kernel for
    MHA, three for GQA), o, the FFN's fc1 and fc2 (LLaMA: gate, side, down)
    a layer and the lm_head; per step o, plus q/k/v where the front is
    unfused, plus the FFN's where the tail is (the tail is fused by default
    for int8 weights)."""
    from spt_proto_tpu_torch.inference.engine import _uses_fused_front
    cfg = iw.cfg
    layers = cfg.n_layers
    sparse = cfg.attention == 'sparse_v2'
    front = _uses_fused_front(cfg, iw.params['blocks']['mha'])
    w8 = iw.quant == 'int8'
    fused_ffn = w8 if cfg.decode_fused_ffn is None else cfg.decode_fused_ffn
    n_qkv = 1 if 'qkv' in iw.params['blocks']['mha'] else 3
    n_ffn = 3 if cfg.ffn_gated else 2
    tail = ('ffn_tail_gated' if cfg.ffn_gated else 'ffn_tail') \
        + ('_int8' if w8 else '')
    prefill = dict.fromkeys(wrappers(), 0)
    step = dict.fromkeys(wrappers(), 0)
    prefill['block_sparse_attention'] = layers if sparse else 0
    step['decode_front'] = layers if front else 0
    step['decode_attention_rows_q' if quantized
         else 'decode_attention_rows'] = layers
    step[tail] = layers if fused_ffn else 0
    step['lm_head_argmax_int8' if w8 else 'lm_head_argmax'] = 1
    if w8:
        prefill['int8_matmul'] = (n_qkv + 1 + n_ffn) * layers + 1
        step['int8_matmul'] = layers * (1 + (0 if front else n_qkv)
                                        + (0 if fused_ffn else n_ffn))
    return prefill, step


# kernels a bf16 decode step never launches: decode_front's fused kernel,
# the int8-KV attention's one-pass and int8 walk kernels, the bf16-KV
# attention's one-pass and walk kernels, the paged walk and the verify walk
# in bf16; every bf16 call takes the weight stream and the split walks
# (front_plan, q_route, rows_route, paged_route, verify_route). Profiled
# bf16 decode steps, paged engine steps and verify steps are held to it.
NOT_BF16_DECODE = ('decode_front_kernel<', 'decode_attention_q_kernel<',
                   'decode_attention_walk_kernel<__nv_bfloat16, signed char>',
                   'decode_attention_kernel<__nv_bfloat16>',
                   'decode_attention_walk_kernel<__nv_bfloat16, '
                   '__nv_bfloat16>', 'paged_attention_kernel<__nv_bfloat16',
                   'verify_attention_kernel<__nv_bfloat16>')


def require_new_kernels(label, prof) -> None:
    """Fail a profiled bf16 window that shows a kernel of NOT_BF16_DECODE."""
    old = sorted(k for k in prof['by_kernel']
                 if any(name in k for name in NOT_BF16_DECODE))
    require(not old, f'{label}: bf16 steps launched {old}')
# the kernel a bf16 prefill never launches: the CUDA-core block-sparse
# forward (every bf16 prefill takes block_sparse_fwd_kernel_tc, fwd_route)
NOT_BF16_PREFILL = ('block_sparse_fwd_kernel<__nv_bfloat16',)


def serving_run(label, iw, tokens, max_len, steps, quantized, profile=True,
                check_first=()):
    """Prefill + `steps` greedy steps: the launch counters are zeroed just
    before the timed run and read after its prefill and after its decode
    loop, and must equal the mode's expected counts exactly. The decode
    window and the profiled one each start after a sync, so a host-bound
    step reads at the host's rate. A bf16 run
    fails when a profiled window of its steps (4, or 1 without `profile`)
    shows a kernel of NOT_BF16_DECODE, or a profiled bf16 sparse prefill
    one of NOT_BF16_PREFILL. check_first
    names wrappers (of WRAPPER_TWINS) whose first call of each form in the
    warm-up run (prefill and two steps) is held against its twin on that
    call's own tensors at the bf16 output bound (check_recorded_kernels)."""
    from spt_proto_tpu_torch.inference import engine
    cfg = iw.cfg
    b = tokens.shape[0]
    ws = wrappers()

    def counts():
        return {n: w.launches for n, w in ws.items()}

    def run(n_steps, events=None):
        cache = engine.KVCache.create(cfg, b, max_len, dtype=cfg.dtype,
                                      quantized=quantized, device=DEV)
        if events:
            events[0].record()
        logits, cache = engine.prefill(iw, tokens, cache)
        if events:
            events[1].record()
            # the steps start from an idle card: behind an unsynced prefill
            # the host queues steps during it, and a host-bound step would
            # read short by that head start
            sync()
        at_prefill = counts()
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        out = []
        for _ in range(n_steps):
            tok, cache = engine.decode_step_greedy(iw, tok, cache)
            out.append(tok)
        if events:
            events[2].record()
        return logits, torch.stack(out, 1), cache, at_prefill

    records = []
    undo = record_wrappers(check_first, records, first_only=True,
                           modules=(engine,))
    try:
        run(2)                               # warm-up
    finally:
        undo()
    first_check = (dict(forms=[r[1][1] for r in records],
                        worst=check_recorded_kernels(label, records,
                                                     BF16_OUTPUT_TOL))
                   if check_first else None)
    del records
    sync()
    torch.cuda.reset_peak_memory_stats()
    for w in ws.values():
        w.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    logits, toks, cache, prefill_counts = run(steps, ev)
    sync()
    total = counts()
    decode_counts = {n: total[n] - prefill_counts[n] for n in total}
    per_prefill, per_step = expected_launches(iw, quantized)
    want_decode = {n: c * steps for n, c in per_step.items()}
    require(prefill_counts == per_prefill and decode_counts == want_decode,
            f'{label} launch counts: prefill {prefill_counts} (expected '
            f'{per_prefill}), {steps} decode steps {decode_counts} '
            f'(expected {want_decode})')
    require(bool(torch.isfinite(logits.float()).all()), 'NaN/inf logits')
    require(toks.shape == (b, steps) and bool(((toks >= 0)
                                               & (toks < cfg.vocab_size)
                                               ).all()),
            f'token ids outside the vocabulary: {toks.tolist()}')
    require(cache.length.tolist() == [tokens.shape[1] + steps] * b,
            'cache length')
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = ev[1].elapsed_time(ev[2])
    res = dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
               prefill_tok_s=b * tokens.shape[1] / prefill_ms * 1e3,
               decode_tok_s=b * steps / decode_ms * 1e3,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=total, launches_per_prefill=prefill_counts,
               launches_per_step={n: c / steps
                                  for n, c in decode_counts.items()},
               first_call_check=first_check)
    log(f'  [{label}] launches: prefill {prefill_counts}; {steps} decode '
        f'steps {decode_counts}')
    log(f'  [{label}] prefill {prefill_ms:.2f} ms = '
        f'{res["prefill_tok_s"]:.0f} tok/s; {steps} decode steps '
        f'{decode_ms:.2f} ms = {res["decode_tok_s"]:.0f} tok/s '
        f'({decode_ms / steps:.3f} ms/step); peak memory '
        f'{res["peak_mem_gb"]:.2f} GB')
    bf16 = cfg.dtype == torch.bfloat16
    if profile or bf16:
        cache = engine.KVCache.create(cfg, b, max_len, dtype=cfg.dtype,
                                      quantized=quantized, device=DEV)
        if bf16 and cfg.attention == 'sparse_v2':
            box = {}

            def prefill():
                box['cache'] = engine.prefill(iw, tokens, cache)[1]
            prof = device_profile(f'{label}: prefill', prefill, top=3)
            old = sorted(k for k in prof['by_kernel']
                         if any(name in k for name in NOT_BF16_PREFILL))
            require(not old, f'{label}: the bf16 prefill launched {old}')
            cache = box['cache']
        else:
            _, cache = engine.prefill(iw, tokens, cache)
        tok = toks[:, -1].contiguous()
        n_prof = 4 if profile else 1
        sync()              # else the window shows steps queued during it

        def steps_n():
            t = tok
            for _ in range(n_prof):
                t, _ = engine.decode_step_greedy(iw, t, cache)
        prof = device_profile(f'{label}: {n_prof} decode steps', steps_n)
        if profile:
            res['decode_profile'] = prof
        if bf16:
            require_new_kernels(label, prof)
    return res


def phase_serving():
    """bf16 OPT-125M, B=8, prompt 2048, max_len 2176: bench.py's three
    decode modes, the fused FFN tail on the int8-KV mode, and int8 weights
    (w8) in the sparse int8-KV and dense bf16-KV modes."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    sparse = opt_cfg('125m', MAX_LEN, torch.bfloat16)
    params = init_params(sparse, SEED, device=DEV)
    tokens = torch.randint(1, VOCAB, (B, PROMPT), generator=gen(SEED),
                           device=DEV)
    iw = InferenceWeights.from_params(sparse, params)
    runs = {}
    runs['dense bf16-KV'] = serving_run(
        'dense bf16-KV', InferenceWeights.from_params(
            opt_cfg('125m', MAX_LEN, torch.bfloat16, dense=True),
            dense_params(params)), tokens, MAX_LEN, STEPS, False)
    runs['sparse bf16-KV'] = serving_run('sparse bf16-KV', iw, tokens,
                                         MAX_LEN, STEPS, False)
    runs['sparse int8-KV'] = serving_run('sparse int8-KV', iw, tokens,
                                         MAX_LEN, STEPS, True)
    runs['sparse int8-KV fused FFN tail'] = serving_run(
        'sparse int8-KV fused FFN tail', InferenceWeights.from_params(
            sparse.replace(decode_fused_ffn=True), params), tokens, MAX_LEN,
        STEPS, True)
    runs['sparse int8-KV w8'] = serving_run(
        'sparse int8-KV w8', InferenceWeights.from_params(
            sparse, params, quant='int8'), tokens, MAX_LEN, STEPS, True)
    runs['dense bf16-KV w8'] = serving_run(
        'dense bf16-KV w8', InferenceWeights.from_params(
            opt_cfg('125m', MAX_LEN, torch.bfloat16, dense=True),
            dense_params(params), quant='int8'), tokens, MAX_LEN, STEPS,
        False)
    cache = engine.KVCache.create(sparse, B, MAX_LEN, dtype=sparse.dtype,
                                  quantized=True, device=DEV)
    runs['sparse int8-KV']['prefill_profile'] = device_profile(
        'sparse int8-KV: prefill', lambda: engine.prefill(iw, tokens, cache))
    dense_tps = runs['dense bf16-KV']['decode_tok_s']
    ratios = {k: r['decode_tok_s'] / dense_tps for k, r in runs.items()}
    best = max(runs['sparse int8-KV']['decode_tok_s'],
               runs['sparse bf16-KV']['decode_tok_s'])
    log(f'  decode tok/s over dense bf16-KV: '
        + ', '.join(f'{k} {v:.3f}' for k, v in ratios.items())
        + f"; bench.py's vs_baseline (best sparse / dense) "
          f'{best / dense_tps:.3f}')
    return dict(runs=runs, vs_dense=ratios, vs_baseline=best / dense_tps)


def phase_1p3b():
    """bench.py's OPT-1.3B rung: dense bf16-KV vs sparse int8-KV, and sparse
    int8-KV with int8 weights (w8), B=8, prompt 2048, max_len 2176, 32
    steps, random weights made on the card."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    sparse = opt_cfg('1.3b', MAX_LEN, torch.bfloat16)
    params = init_params(sparse, SEED, device=DEV)
    tokens = torch.randint(1, VOCAB, (B, PROMPT), generator=gen(SEED),
                           device=DEV)
    runs = {}
    runs['dense bf16-KV'] = serving_run(
        '1.3B dense bf16-KV', InferenceWeights.from_params(
            opt_cfg('1.3b', MAX_LEN, torch.bfloat16, dense=True),
            dense_params(params)), tokens, MAX_LEN, STEPS, False,
        profile=False)
    runs['sparse int8-KV'] = serving_run(
        '1.3B sparse int8-KV', InferenceWeights.from_params(sparse, params),
        tokens, MAX_LEN, STEPS, True, profile=False)
    runs['sparse int8-KV w8'] = serving_run(
        '1.3B sparse int8-KV w8', InferenceWeights.from_params(
            sparse, params, quant='int8'), tokens, MAX_LEN, STEPS, True,
        profile=False)
    ratio = runs['sparse int8-KV']['decode_tok_s'] \
        / runs['dense bf16-KV']['decode_tok_s']
    log(f'  1.3B sparse int8-KV / dense bf16-KV decode tok/s {ratio:.3f}')
    log('  1.3B peak memory GB: ' + ', '.join(
        f'{k} {r["peak_mem_gb"]:.2f}' for k, r in runs.items()))
    del params
    torch.cuda.empty_cache()
    return dict(runs=runs, sparse_vs_dense=ratio)


def spec_expected(iw, draft, quantized, rounds):
    """Launches of one generate_speculative run: (the prefills', the whole
    run's). The prefill(s) as in expected_launches; per round one
    verify_attention_rows a target layer (none over an int8 cache: its
    plain path) and, with a draft model, K draft decode_steps (their
    per-step kernels but the fused lm_head: decode_step's head is a plain
    matmul for the sampled logits)."""
    prefill, _ = expected_launches(iw, quantized)
    per_round = dict.fromkeys(prefill, 0)
    if draft is not None:
        d_pre, d_step = expected_launches(draft, quantized)
        for n in prefill:
            prefill[n] += d_pre[n]
            per_round[n] = 0 if n.startswith('lm_head') else KK * d_step[n]
    if not quantized:
        per_round['verify_attention_rows'] = iw.cfg.n_layers
    return prefill, {n: prefill[n] + rounds * per_round[n] for n in prefill}


def step_costs(iw, prompts, quantized, steps=16):
    """bench_serving.py's step costs at the workload's batch and context:
    ms per decode_step (+ argmax) and per verify_step of a K-column block
    rolled back by k (+1 token a step), each timed with CUDA events over
    `steps` steps after 2 warm-up steps, from one prefilled cache; and the
    share of the decode steps' greedy decisions at a near-tie."""
    from spt_proto_tpu_torch.inference import engine
    import dataclasses
    cfg = iw.cfg
    cache = engine.KVCache.create(cfg, prompts.shape[0], SPEC_MAX_LEN,
                                  dtype=cfg.dtype, quantized=quantized,
                                  device=DEV)
    logits, cache = engine.prefill(iw, prompts, cache)
    tok0 = torch.argmax(logits[:, -1], -1).to(torch.int32)
    del logits

    gaps = []

    def dec(tok, c):
        lg, c = engine.decode_step(iw, tok, c)
        gaps.append(lg.float().topk(2, -1).values)       # [B, 2]
        return torch.argmax(lg, -1).to(torch.int32), c

    def ver(tok, c):
        blk = tok[:, None].expand(-1, KK).contiguous()
        lg, c = engine.verify_step(iw, blk, c)
        c = dataclasses.replace(c, length=c.length - SPEC_K)
        return torch.argmax(lg[:, -1], -1).to(torch.int32), c

    out = {}
    for name, fn in (('decode', dec), ('verify', ver)):
        c, tok = copy_cache(cache, DEV), tok0
        for _ in range(2):
            tok, c = fn(tok, c)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(steps):
            tok, c = fn(tok, c)
        ev[1].record()
        sync()
        out[name] = ev[0].elapsed_time(ev[1]) / steps
        del c
    # greedy decisions whose two best logits lie within one bf16 step
    # (2^-7 |max logit|): where rounding in another order can pick the other
    top2 = torch.stack(gaps)
    out['near_ties'] = ((top2[..., 0] - top2[..., 1])
                        <= 2.0 ** -7 * top2[..., 0].abs()).float().mean().item()
    return out, cache, tok0


def spec_run(label, iw, prompts, quantized, draft=None, profile=True):
    """One speculative serving run, bench_serving.py's workload: greedy
    generate_speculative (k = 4, 64 new tokens, max_len 2304), the launch
    counters zeroed just before it and read just after, held exactly to
    spec_expected; its wall time (CUDA events); the token agreement with
    greedy generate() on the same prompts; the verify and decode step
    costs; tok/s by bench_serving's formula B (1 + acceptance k) / t_verify
    beside plain decode's B / t_decode; and a profiled window of 4 verify
    steps."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.speculative import \
        generate_speculative
    import dataclasses
    b = prompts.shape[0]
    ws = wrappers()
    kw = dict(draft=draft, k=SPEC_K, max_len=SPEC_MAX_LEN,
              quantized_kv=quantized)
    generate_speculative(iw, prompts, 2, **kw)              # warm-up
    sync()
    for w in ws.values():
        w.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out, st = generate_speculative(iw, prompts, SPEC_NEW, **kw)
    ev[1].record()
    sync()
    counts = {n: w.launches for n, w in ws.items()}
    rounds = st['rounds']
    per_prefill, want = spec_expected(iw, draft, quantized, rounds)
    require(counts == want, f'{label} launch counts {counts} (expected '
            f'{want}, {rounds} rounds)')
    require(out.shape == (b, prompts.shape[1] + SPEC_NEW)
            and bool(((out >= 0) & (out < iw.cfg.vocab_size)).all()),
            f'{label}: tokens {out.shape}')
    wall_ms = ev[0].elapsed_time(ev[1])
    ref = engine.generate(iw, prompts, SPEC_NEW, max_len=SPEC_MAX_LEN,
                          quantized_kv=quantized)
    s0 = prompts.shape[1]
    same = out[:, s0:] == ref[:, s0:]
    agree = same.float().mean().item()
    # each row's first generated token that differs (SPEC_NEW: none)
    first_div = torch.where(same.all(1), SPEC_NEW,
                            (~same).int().argmax(1)).tolist()
    costs, cache, tok0 = step_costs(iw, prompts, quantized)
    acc = st['acceptance']
    res = dict(st, wall_ms=wall_ms, wall_tok_s=b * SPEC_NEW / wall_ms * 1e3,
               agreement_with_generate=agree, near_ties=costs['near_ties'],
               first_divergence=first_div, verify_ms=costs['verify'],
               decode_ms=costs['decode'],
               verify_over_decode=costs['verify'] / costs['decode'],
               spec_tok_s=b * (1 + acc * SPEC_K) / costs['verify'] * 1e3,
               plain_tok_s=b / costs['decode'] * 1e3,
               launches=counts, launches_per_prefill=per_prefill,
               launches_per_step={n: (c - per_prefill[n]) / rounds
                                  for n, c in counts.items()})
    log(f'  [{label}] launches in {rounds} rounds: {counts}')
    log(f'  [{label}] acceptance {acc:.3f} ({st["accepted"]} of '
        f'{st["proposed"]}); verify step {costs["verify"]:.3f} ms, decode '
        f'step {costs["decode"]:.3f} ms (ratio '
        f'{res["verify_over_decode"]:.3f}); B(1 + acc k) / t_verify = '
        f'{res["spec_tok_s"]:.0f} tok/s vs plain decode {res["plain_tok_s"]:.0f}'
        f' tok/s; whole run {wall_ms:.1f} ms = {res["wall_tok_s"]:.0f} tok/s; '
        f'token agreement with generate() {agree:.4f} (rows part at tokens '
        f'{first_div}; {costs["near_ties"]:.3f} of the decode steps\' '
        f'decisions lie at a bf16 near-tie)')
    if profile:
        def steps4():
            c, tok = cache, tok0
            for _ in range(4):
                blk = tok[:, None].expand(-1, KK).contiguous()
                lg, c = engine.verify_step(iw, blk, c)
                c = dataclasses.replace(c, length=c.length - SPEC_K)
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)
        res['verify_profile'] = device_profile(f'{label}: 4 verify steps',
                                               steps4)
        if iw.cfg.dtype == torch.bfloat16:
            require_new_kernels(label, res['verify_profile'])
    del cache
    torch.cuda.empty_cache()
    return res


def phase_speculative():
    """bf16 speculative serving, bench_serving.py's workload (B=8, prompt
    2048, k = 4, 64 new tokens, max_len 2304): OPT-125M with n-gram drafts
    over a bf16 KV cache (the verify kernel) and over an int8 one (the
    plain verify path), and OPT-1.3B with OPT-125M as the draft model, both
    with random weights from a seed."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    from spt_proto_tpu_torch.cli.bench_serving import spec_prompts
    cfg = opt_cfg('125m', SPEC_MAX_LEN, torch.bfloat16)
    small = InferenceWeights.from_params(cfg, init_params(cfg, SEED,
                                                          device=DEV))
    # the workload is bench_serving's own (spec_prompts), held to the
    # script's spec_workload first
    prompts = torch.as_tensor(spec_prompts(cfg.vocab_size, B, PROMPT),
                              device=DEV)
    require(torch.equal(prompts, spec_workload(cfg.vocab_size)),
            'bench_serving.spec_prompts differs from spec_workload')
    runs = {}
    runs['spec 125M n-gram bf16-KV'] = spec_run(
        'spec 125M n-gram bf16-KV', small, prompts, False)
    runs['spec 125M n-gram int8-KV'] = spec_run(
        'spec 125M n-gram int8-KV', small, prompts, True, profile=False)
    cfg13 = opt_cfg('1.3b', SPEC_MAX_LEN, torch.bfloat16)
    big = InferenceWeights.from_params(cfg13, init_params(cfg13, SEED,
                                                          device=DEV))
    runs['spec 1.3B draft 125M bf16-KV'] = spec_run(
        'spec 1.3B draft 125M bf16-KV', big, prompts, False, draft=small)
    del big, small
    torch.cuda.empty_cache()
    return dict(runs=runs)


LLAMA_PROMPT, LLAMA_STEPS = 2048, 32
# half of the 32 layers: the script's time grew with phase 10
LLAMA_LAYERS = 16


W8_FIRST_CHECK = ('int8_matmul', 'ffn_tail_gated_int8')


def phase_llama():
    """bf16 LLaMA at full width and LLAMA_LAYERS deep, prompt 2048, max_len
    2176, 32 steps, random weights made on the card: Llama-3-8B at B=8 dense
    bf16-KV (the baseline), sparse int8-KV, the same with the fused gated
    tail, and sparse int8-KV w8; LLaMA-7B sparse int8-KV w8 at B=4
    (bench_ladder.py's llama-7b rung). Each model is freed before the next
    is built."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    runs = {}

    def run(label, cfg, params, tokens, quantized, quant=None):
        iw = InferenceWeights.from_params(cfg, params, quant=quant)
        # w8: the first int8_matmul of each kernel (wgmma in the prefill,
        # the weight stream in the steps) and the first gated int8 tail on
        # their own tensors
        check = W8_FIRST_CHECK if quant == 'int8' else ()
        runs[label] = r = serving_run(label, iw, tokens, MAX_LEN,
                                      LLAMA_STEPS, quantized,
                                      check_first=check)
        if check:
            forms = r['first_call_check']['forms']
            require(sum('wgmma' in f for f in forms) == 1
                    and sum('stream' in f for f in forms) == 1
                    and sum("'tc'" in f for f in forms) == 1,
                    f'{label}: first calls checked {forms}')
        del iw
        torch.cuda.empty_cache()

    sparse = llama_cfg('3-8b', MAX_LEN, torch.bfloat16, n_layers=LLAMA_LAYERS)
    params = init_params(sparse, SEED, device=DEV)
    tokens = torch.randint(1, sparse.vocab_size, (B, LLAMA_PROMPT),
                           generator=gen(SEED), device=DEV)
    run('3-8B dense bf16-KV', llama_cfg('3-8b', MAX_LEN, torch.bfloat16,
                                        dense=True, n_layers=LLAMA_LAYERS),
        dense_params(params), tokens, False)
    run('3-8B sparse int8-KV', sparse, params, tokens, True)
    run('3-8B sparse int8-KV fused FFN tail',
        sparse.replace(decode_fused_ffn=True), params, tokens, True)
    run('3-8B sparse int8-KV w8', sparse, params, tokens, True, 'int8')
    # speculative serving while the model is loaded: n-gram drafts over a
    # bf16 KV cache (the device-bound case for the verify / decode ratio)
    iw = InferenceWeights.from_params(sparse, params)
    runs['spec 3-8B n-gram bf16-KV'] = spec_run(
        'spec 3-8B n-gram bf16-KV', iw, spec_workload(sparse.vocab_size),
        False)
    del iw
    torch.cuda.empty_cache()
    # the serving stack at Llama-3-8B width: the paged dense bf16-KV engine
    # (the paged-attention kernel at G = 4) on phase 8's traffic
    iw = InferenceWeights.from_params(
        llama_cfg('3-8b', MAX_LEN, torch.bfloat16, dense=True,
                  n_layers=LLAMA_LAYERS), dense_params(params))
    runs['serve 3-8B paged dense bf16-KV'] = engine_run(
        'serve 3-8B paged dense bf16-KV', iw,
        serve_traffic(sparse.vocab_size)[0], paged=True,
        page_size=PAGED_PS, profile=True)
    del iw, params
    torch.cuda.empty_cache()
    sparse = llama_cfg('7b', MAX_LEN, torch.bfloat16, n_layers=LLAMA_LAYERS)
    params = init_params(sparse, SEED, device=DEV)
    tokens = torch.randint(1, sparse.vocab_size, (B_7B, LLAMA_PROMPT),
                           generator=gen(SEED), device=DEV)
    run('7B sparse int8-KV w8 B=4', sparse, params, tokens, True, 'int8')
    del params
    torch.cuda.empty_cache()
    log('  LLaMA decode ms/step: ' + ', '.join(
        f'{k} {r["decode_ms"] / LLAMA_STEPS:.3f}' for k, r in runs.items()
        if not k.startswith(('spec', 'serve'))))
    log('  LLaMA peak memory GB: ' + ', '.join(
        f'{k} {r["peak_mem_gb"]:.2f}' for k, r in runs.items()
        if not k.startswith('spec')))
    return dict(runs=runs)


# ---------------------------------------------------------------------------
# phase 8: the serving stack (continuous batching, paged cache, HTTP server)
# ---------------------------------------------------------------------------

SERVE_REQS, SERVE_SLOTS, SERVE_NEW = 16, 8, 64
SERVE_BUCKET = 256          # prompts pad to multiples of 256: every sparse
                            # prefill runs the block-sparse kernel
SERVE_PREFIX = 1024


def serve_traffic(vocab):
    """16 prompts of lengths drawn from numpy seed 3 in 128-1920 (random
    tokens from the same seed), and the same traffic with every other
    request made of a shared 1,024-token prefix and a tail (its length
    past 1,024, or half its length): (prompts, prefixed, shared)."""
    rs = np.random.RandomState(3)
    lens = rs.randint(128, 1921, size=SERVE_REQS)
    prompts = [[int(x) for x in rs.randint(1, vocab, size=n)] for n in lens]
    shared = [int(x) for x in rs.randint(1, vocab, size=SERVE_PREFIX)]
    prefixed = [shared + p[:n - SERVE_PREFIX if n > SERVE_PREFIX + 16
                           else n // 2] if i % 2 == 0 else p
                for i, (p, n) in enumerate(zip(prompts, lens))]
    return prompts, prefixed, shared


def prefill_launches(cfg, s):
    """block_sparse_attention launches of one prefill of s tokens: a layer
    each when the config is sparse and s takes the kernel's tile path
    (engine._sparse_prefill_attention), else none."""
    if cfg.attention != 'sparse_v2':
        return 0
    blk_q = 256 if s % 256 == 0 else 128
    return cfg.n_layers if s % blk_q == 0 and s >= 256 else 0


def engine_run(label, iw, prompts, pin=None, n_new=SERVE_NEW, profile=False,
               **kw):
    """Serve every prompt through a ContinuousBatchingEngine (8 slots,
    max_len 2176) after a 2-request warm-up of the same mode: the launch
    counters zeroed just before the timed run and read after it, held
    exactly to the run's own prefill calls, decode steps and verify rounds
    (a paged decode step: one paged_attention a layer over a dense config;
    a contiguous step: decode_step_greedy's kernels, as phase 4 counts
    them; a verify round: one verify_attention_rows a layer over a bf16
    cache; each prefill: a block_sparse_attention a layer where its length
    takes the kernel; chunked and prefix-tail prefill are plain PyTorch, as
    in the JAX engine). With `profile`, a fresh engine of the same mode
    then takes the first 8 requests and, once they decode, 4 engine steps
    are profiled. Returns the mode's numbers."""
    from spt_proto_tpu_torch.inference import batching, paged
    cfg = iw.cfg
    ws = wrappers()
    kw = {**dict(n_slots=SERVE_SLOTS, max_len=MAX_LEN,
                 prefill_bucket=SERVE_BUCKET), **kw}
    warm = batching.ContinuousBatchingEngine(iw, **kw)
    for p in prompts[:2]:
        warm.submit(p[:300], max_new_tokens=2)
    warm.run_until_done()
    del warm
    eng = batching.ContinuousBatchingEngine(iw, **kw)
    sizes, decodes = [], []
    orig = batching.prefill, paged.prefill

    def counted_prefill(iw_, tokens, cache):
        sizes.append(tokens.shape[1])
        return orig[0](iw_, tokens, cache)

    decode_fn = eng._decode_fn

    def counted_decode(*a, **k):
        decodes.append(1)
        return decode_fn(*a, **k)

    eng._decode_fn = counted_decode
    batching.prefill = paged.prefill = counted_prefill
    sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in ws.values():
        w.launches = 0
    try:
        t0 = time.perf_counter()
        if pin is not None:
            eng.cache_prefix(pin)
        rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        ev, pure = [], []
        while eng.num_active or eng.queue_depth:
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            n_pre = len(sizes)
            e[0].record()
            eng.step()
            e[1].record()
            ev.append(e)
            # a step that prefilled nothing (no admission, no chunk)
            pure.append(len(sizes) == n_pre
                        and eng.last_step_prefill_tokens == 0)
        sync()
        wall = time.perf_counter() - t0
    finally:
        batching.prefill, paged.prefill = orig
    counts = {n: w.launches for n, w in ws.items()}
    step_ms = [a.elapsed_time(b_) for a, b_ in ev]
    dec_ms = [t_ for t_, p_ in zip(step_ms, pure) if p_]
    per_step = dict.fromkeys(ws, 0)
    if eng.paged:
        per_step['paged_attention'] = (cfg.n_layers if cfg.attention
                                       == 'dense' else 0)
    elif not eng.spec_k:
        per_step = expected_launches(iw, eng.quantized_kv)[1]
    rounds = eng.spec_stats['rounds']
    want = {n: c * len(decodes) for n, c in per_step.items()}
    want['block_sparse_attention'] += sum(prefill_launches(cfg, n)
                                          for n in sizes)
    if eng.spec_k and not eng.quantized_kv:
        want['verify_attention_rows'] += cfg.n_layers * rounds
    require(counts == want, f'{label} launch counts {counts} (expected '
            f'{want}: {len(sizes)} prefills, {len(decodes)} decode steps, '
            f'{rounds} verify rounds)')
    done = {c.request_id: c.tokens for c in eng.completions}
    require(sorted(done) == sorted(rids)
            and all(len(t) == n_new and all(0 <= x < cfg.vocab_size
                                            for x in t)
                    for t in done.values()),
            f'{label}: completions {[len(t) for t in done.values()]}')
    n_tok = sum(len(t) for t in done.values())
    st = eng.spec_stats
    res = dict(
        tokens=n_tok, wall_s=wall, tok_s=n_tok / wall, steps=len(ev),
        decode_steps=len(decodes), mean_step_ms=sum(step_ms) / len(ev),
        decode_only_step_ms=sum(dec_ms) / max(1, len(dec_ms)),
        preemptions=eng.n_preemptions, prefix_hits=eng.prefix_hits,
        acceptance=(st['accepted'] / max(1, st['proposed'])
                    if eng.spec_k else None),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        prefills=len(sizes), launches=counts,
        launches_per_step=per_step,
        launches_per_prefill={n: 0 for n in ws})
    res['launches_per_prefill']['block_sparse_attention'] = \
        prefill_launches(cfg, kw['prefill_bucket'])
    log(f'  [{label}] {n_tok} tokens in {wall:.2f} s = {res["tok_s"]:.0f} '
        f'tok/s; {len(ev)} engine steps ({len(decodes)} decode, {rounds} '
        f'verify rounds), mean step {res["mean_step_ms"]:.3f} ms '
        f'({res["decode_only_step_ms"]:.3f} ms over the {len(dec_ms)} '
        f'steps without prefill work); '
        f'preemptions {eng.n_preemptions}, prefix hits {eng.prefix_hits}, '
        f'acceptance {res["acceptance"]}; peak {res["peak_mem_gb"]:.2f} GB')
    log(f'  [{label}] launches: {counts}')
    del eng
    if profile:
        eng = batching.ContinuousBatchingEngine(iw, **kw)
        for p in prompts[:SERVE_SLOTS]:
            eng.submit(p, max_new_tokens=8)
        eng.step()
        eng.step()
        res['step_profile'] = device_profile(
            f'{label}: 4 engine steps of {SERVE_SLOTS} decoding slots',
            lambda: [eng.step() for _ in range(4)])
        if cfg.dtype == torch.bfloat16:
            require_new_kernels(label, res['step_profile'])
        del eng
    torch.cuda.empty_cache()
    return res


def agreement(got, want) -> float:
    """Share of equal tokens over completions of equal lengths."""
    pairs = [(a, b_) for g_, w_ in zip(got, want) for a, b_ in zip(g_, w_)]
    require(all(len(g_) == len(w_) for g_, w_ in zip(got, want)),
            'completion lengths differ')
    return sum(a == b_ for a, b_ in pairs) / len(pairs)


def serve_all(iw, prompts, n_new, **kw):
    from spt_proto_tpu_torch.inference.batching import \
        ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(iw, **kw)
    pin = kw.get('prefix_cache') and eng.cache_prefix(prompts[0][:256])
    rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    done = {c.request_id: c.tokens for c in eng.run_until_done()}
    return [done[r] for r in rids], eng, pin


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


PSERVE_N, PSERVE_SLOTS, PSERVE_NEW, PSERVE_MAX_LEN = 6, 3, 16, 640


def post_completions(url, prompts, n_new):
    """POST every prompt to /v1/completions at once (a thread each)."""
    import threading
    import urllib.request
    out = [None] * len(prompts)

    def worker(i):
        req = urllib.request.Request(
            url + '/v1/completions', data=json.dumps(
                {'prompt': prompts[i], 'max_tokens': n_new}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=600) as r:
            out[i] = json.loads(r.read())['tokens']

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    require(all(o is not None for o in out), 'a completion did not return')
    return out


def serving_parity():
    """f32 OPT-125M at full width, 6 requests over 3 slots, 16 tokens: the
    engines' completions against their references, each >= 0.995 of the
    tokens. Dense config (prompts of 128-512 tokens from numpy seed 3, the
    first three made of a shared 256-token prefix and a tail): the
    contiguous f32-KV engine, the paged f32-KV engine (the paged-attention
    kernel) and the engine with prefill_chunk 128 and the prefix pinned,
    each against greedy generate() of every request on the card; then the
    HTTP server (make_server, port 0, 6 concurrent POSTs) over the
    contiguous engine. Sparse config (six 512-token prompts: the padded
    prompt is the prompt, and the decode tables' size is generate()'s):
    the contiguous int8-KV engine against generate(quantized_kv=True). The
    paged int8-KV engine against the same engine on the CPU through the
    plain twins (its pages quantize per token at 127.5, unlike the
    contiguous int8 cache, so generate() is no reference for it)."""
    import threading
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.batching import \
        ContinuousBatchingEngine
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.server import make_server
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    ml, n_new = PSERVE_MAX_LEN, PSERVE_NEW
    sparse = opt_cfg('125m', ml, torch.float32)
    dense = opt_cfg('125m', ml, torch.float32, dense=True)
    params = init_params(sparse, SEED, device=DEV)
    iw = InferenceWeights.from_params(dense, dense_params(params))
    rs = np.random.RandomState(3)
    shared = [int(x) for x in rs.randint(1, VOCAB, size=256)]
    prompts = []
    for i in range(PSERVE_N):
        n = int(rs.randint(128, 513))
        p = [int(x) for x in rs.randint(1, VOCAB, size=n)]
        prompts.append(shared + p[:n // 2] if i < 3 else p)

    def refs(iw_, ps, **kw):
        return [engine.generate(iw_, torch.tensor([p], device=DEV), n_new,
                                max_len=ml, **kw)[0, len(p):].tolist()
                for p in ps]

    want = refs(iw, prompts)
    base = dict(n_slots=PSERVE_SLOTS, max_len=ml, prefill_bucket=128)
    out = {}
    for label, kw in (('contiguous f32-KV', {}),
                      ('paged f32-KV', dict(paged=True,
                                            page_size=PAGED_PS)),
                      ('prefill_chunk 128 + prefix cache',
                       dict(prefill_chunk=128, prefix_cache=True))):
        paged_before = wrappers()['paged_attention'].launches
        got, eng, pin = serve_all(iw, prompts, n_new, **base, **kw)
        agree = agreement(got, want)
        extra = ''
        if kw.get('paged'):
            n = wrappers()['paged_attention'].launches - paged_before
            require(n > 0, 'the paged engine launched no paged_attention')
            extra = f', {n} paged_attention launches'
        if pin:
            require(eng.prefix_hits >= 3, f'prefix hits {eng.prefix_hits}')
            extra = f', prefix hits {eng.prefix_hits}'
        log(f'  {label:34s} f32: agreement with generate() {agree:.4f} '
            f'over {PSERVE_N}x{n_new}{extra}')
        require(agree >= 0.995, f'{label}: {got} vs {want}')
        out[label] = agree
    # the HTTP server over the contiguous engine
    server, frontend = make_server(ContinuousBatchingEngine(iw, **base),
                                   port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        host, port = server.server_address[:2]
        got = post_completions(f'http://{host}:{port}', prompts, n_new)
    finally:
        server.shutdown()
        frontend.shutdown()
        th.join(timeout=60)
    agree = agreement(got, want)
    log(f'  {"HTTP server, 6 concurrent POSTs":34s} f32: agreement with '
        f'generate() {agree:.4f}')
    require(agree >= 0.995, f'HTTP server: {got} vs {want}')
    out['http server'] = agree
    # sparse int8-KV
    iw_s = InferenceWeights.from_params(sparse, params)
    prompts_s = [[int(x) for x in rs.randint(1, VOCAB, size=512)]
                 for _ in range(PSERVE_N)]
    want_s = refs(iw_s, prompts_s, quantized_kv=True)
    got, _, _ = serve_all(iw_s, prompts_s, n_new, quantized_kv=True, **base)
    agree = agreement(got, want_s)
    log(f'  {"sparse contiguous int8-KV":34s} f32: agreement with '
        f'generate(quantized_kv=True) {agree:.4f}')
    require(agree >= 0.995, f'sparse int8-KV engine: {got} vs {want_s}')
    out['sparse contiguous int8-KV'] = agree
    del iw_s
    # paged int8-KV: the card against the CPU twins
    iw_cpu = InferenceWeights.from_params(
        dense, to_device(dense_params(params), 'cpu'))
    kw = dict(base, paged=True, page_size=PAGED_PS, quantized_kv=True)
    t0 = time.perf_counter()
    got, _, _ = serve_all(iw, prompts, n_new, **kw)
    cpu, _, _ = serve_all(iw_cpu, prompts, n_new, **kw)
    agree = agreement(got, cpu)
    log(f'  {"paged int8-KV":34s} f32: agreement with the same engine on '
        f'the CPU twins {agree:.4f} ({time.perf_counter() - t0:.1f} s)')
    require(agree >= 0.995, f'paged int8-KV engine: {got} vs {cpu}')
    out['paged int8-KV vs CPU twins'] = agree
    del iw, iw_cpu, params
    torch.cuda.empty_cache()
    return out


def phase_serving_stack():
    """bf16 OPT-125M at full width, random weights from seed 0, through the
    continuous batching engine: 16 requests over 8 slots, prompts of
    128-1920 tokens (numpy seed 3), 64 new tokens each, max_len 2176, in
    seven modes (module docstring); then the f32 parity step."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    sparse = opt_cfg('125m', MAX_LEN, torch.bfloat16)
    dense = opt_cfg('125m', MAX_LEN, torch.bfloat16, dense=True)
    params = init_params(sparse, SEED, device=DEV)
    iw_s = InferenceWeights.from_params(sparse, params)
    iw_d = InferenceWeights.from_params(dense, dense_params(params))
    prompts, prefixed, shared = serve_traffic(VOCAB)
    # the pages the first wave of requests (one a slot) holds at its final
    # length; prompts pad to 64 tokens there, so that growth needs pages
    need = sum(-(-(len(p) + SERVE_NEW) // PAGED_PS)
               for p in prompts[:SERVE_SLOTS])
    runs = {}
    for label, iw, kw in (
            ('contiguous sparse int8-KV', iw_s, dict(quantized_kv=True)),
            ('contiguous dense bf16-KV + prefill_chunk 512 + prefix cache',
             iw_d, dict(prefill_chunk=512, prefix_cache=True,
                        pin=shared, profile=True)),
            ('paged dense bf16-KV', iw_d, dict(paged=True,
                                               page_size=PAGED_PS,
                                               profile=True)),
            ('paged dense int8-KV', iw_d, dict(paged=True,
                                               page_size=PAGED_PS,
                                               quantized_kv=True)),
            ('paged sparse int8-KV', iw_s, dict(paged=True,
                                                page_size=PAGED_PS,
                                                quantized_kv=True)),
            ('paged dense bf16-KV, pool 60%', iw_d, dict(
                paged=True, page_size=PAGED_PS, n_pages=int(0.6 * need),
                prefill_bucket=PAGED_PS)),
            ('contiguous sparse bf16-KV speculative=4', iw_s,
             dict(speculative=SPEC_K))):
        traffic = prefixed if 'prefix' in label else prompts
        runs[label] = engine_run(label, iw, traffic, **kw)
    require(runs['paged dense bf16-KV, pool 60%']['preemptions'] >= 1,
            'the 60% pool preempted no request')
    require(runs['contiguous dense bf16-KV + prefill_chunk 512 + prefix '
                 'cache']['prefix_hits'] >= SERVE_REQS // 2,
            'the shared prefix was not reused')
    del iw_s, iw_d, params
    torch.cuda.empty_cache()
    return dict(runs=runs, parity=serving_parity())


def device_profile(label, fn, top=8):
    """Device busy share of a window and its device time by kernel, from
    torch.profiler (CUPTI) over one call of fn, bracketed by CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        fn()
        ev[1].record()
        sync()
    return profile_summary(label, prof, ev[0].elapsed_time(ev[1]) * 1e3, top)


def profile_summary(label, prof, window_us, top=8):
    """Busy share and the top kernels of a finished profile whose window,
    bracketed by CUDA events, took window_us."""
    from torch.autograd import DeviceType
    by_kernel = {}
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:      # kernels, copies, memsets
            t, n = by_kernel.get(a.key, (0.0, 0))
            by_kernel[a.key] = (t + a.device_time_total, n + a.count)
    busy_us = sum(t for t, _ in by_kernel.values())
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    out = dict(window_us=window_us, device_busy_us=busy_us,
               busy_share=busy_us / window_us if by_kernel else None,
               top=[(k[:90], t, n) for k, (t, n) in rows],
               by_kernel=by_kernel)
    log(f'  profile {label}: window {window_us:.0f} us, device busy '
        f'{busy_us:.0f} us ({out["busy_share"]})')
    for k, t, n in out['top']:
        log(f'    {t:9.1f} us {n:5d} calls  {k}')
    return out


# ---------------------------------------------------------------------------
# phase 9: SPT fine-tuning (DecoderLM, the routed-FFN + LoRA + PQ train step,
# the tune CLI) through the lse forward, dq and dk/dv kernels
# ---------------------------------------------------------------------------

TRAIN_KERNELS = ('block_sparse_attention_lse', 'block_sparse_attention_dq',
                 'block_sparse_attention_dkv')
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_PROFILED = 2, 8, 2


def to_dev(tree, dev):
    """A copy of the tree on `dev` (training updates it in place)."""
    from spt_proto_tpu_torch.utils.tree import flatten, unflatten
    return unflatten({k: v.to(dev, copy=True)
                      for k, v in flatten(tree).items()})


def capture_grads(state, grads):
    """Make the next optimizer step of `state` first copy the trainable
    leaves' gradients (before clipping) into `grads`, by flax path."""
    from spt_proto_tpu_torch.utils.tree import flatten
    opt = state.opt_state
    step = opt.step

    def capturing(norm):
        grads.update({k: p.grad.detach().cpu().clone() for k, p in
                      flatten(state.params).items() if p.grad is not None})
        opt.step = step
        step(norm)
    opt.step = capturing


# A trainable leaf's gradient, card against CPU, relative to its largest
# entry. Not 1e-4: the plain PyTorch path alone (attn_impl 'block', no
# kernel) differs by 1.8e-2 of the max in OPT-125M's fc1 LoRA right factor
# between the card and the CPU (measured on an H100 80GB HBM3 at 700 W:
# ReLU pre-activations within an ulp of 0 take the other side of the kink
# when cuBLAS and the CPU sum in other orders, and each such flip moves
# that hidden unit's gradient by a whole term; the leaves below it follow
# at ~1e-3). The kernels are held
# at f32 tightness on the run's own tensors instead (KERNEL_TOL).
GRAD_REL_BOUND = 5e-2
KERNEL_TOL = (1e-5, 1e-5)
# Free-running losses after 1-2 steps, card against CPU. Not 1e-4: Adam
# moves each weight by about lr * sign(g) on its first steps, so gradient
# entries near 0 that differ in sign part the two runs' weights by 2 lr,
# and the LoRA factors' gain (left factors are normal(1.0)) turns that
# into 1.3e-4 and 3.2e-4 of the loss at steps 1 and 2 at OPT-125M width,
# 5.2e-4 and 1.3e-3 at Llama-3-8B width (the same card). The stepwise
# steps hold the same steps to 1e-5.
FREE_REL_BOUND = 5e-3


def record_attention(records):
    """Patch the lse forward and the backward of ops.block_sparse_attention
    and the forward and backward of ops.flash_attention to keep each call's
    inputs and outputs (the autograd Functions look both up in their
    modules); returns the function that undoes it. A forward wrapper counts
    its launches on the name it is reached by, the recorder while patched:
    undo hands that count back."""
    from spt_proto_tpu_torch.ops import block_sparse_attention as m
    from spt_proto_tpu_torch.ops import flash_attention as fa
    patched = []
    for mod, fwd_name, bwd_name, kind in (
            (m, 'block_sparse_attention_lse', 'block_sparse_attention_bwd',
             ''),
            (fa, 'flash_attention_fwd', 'flash_attention_bwd', 'flash_')):
        fwd, bwd = getattr(mod, fwd_name), getattr(mod, bwd_name)

        def fwd_rec(q, k, v, *a, _fwd=fwd, _kind=kind, **kw):
            out = _fwd(q, k, v, *a, **kw)
            records.append((_kind + 'fwd', (q, k, v, *a), kw, out))
            return out

        def bwd_rec(*a, _bwd=bwd, _kind=kind, **kw):
            out = _bwd(*a, **kw)
            records.append((_kind + 'bwd', a, kw, out))
            return out
        fwd_rec.launches = 0
        setattr(mod, fwd_name, fwd_rec)
        setattr(mod, bwd_name, bwd_rec)
        patched.append((mod, fwd_name, bwd_name, fwd, bwd, fwd_rec))

    def undo():
        for mod, fwd_name, bwd_name, fwd, bwd, fwd_rec in patched:
            setattr(mod, fwd_name, fwd)
            setattr(mod, bwd_name, bwd)
            fwd.launches += fwd_rec.launches
    return undo


# kernel wrapper -> (its module, its plain twin)
WRAPPER_TWINS = {
    'int8_matmul': ('spt_proto_tpu_torch.ops.int8_matmul', 'int8_matmul_ref'),
    'int8_matmul_t': ('spt_proto_tpu_torch.ops.int8_matmul',
                      'int8_matmul_t_ref'),
    'gmm': ('spt_proto_tpu_torch.ops.gmm', 'gmm_ref'),
    'tgmm': ('spt_proto_tpu_torch.ops.gmm', 'tgmm_ref'),
    'ffn_tail_int8': ('spt_proto_tpu_torch.ops.ffn_tail',
                      'ffn_tail_int8_ref'),
    'ffn_tail_gated_int8': ('spt_proto_tpu_torch.ops.ffn_tail',
                            'ffn_tail_gated_int8_ref')}


def call_form(name, args, by_shape=False):
    """A wrapper call's form: its name and the kernels its rule picks for
    these operands (int8_matmul_plan, ffn_tail_plan; by_shape: and the
    operands' shapes), or for other wrappers its operands' shapes."""
    from spt_proto_tpu_torch.ops import ffn_tail, int8_matmul as mm
    x, plan = args[0], None
    if name == 'int8_matmul':
        k = x.shape[-1]
        plan = mm.int8_matmul_plan(x.numel() // k, k, args[1].shape[-1],
                                   x.dtype, x.data_ptr() % 16 == 0)
    elif name.startswith('ffn_tail'):
        w = args[2]
        f = w['scale'].numel() if isinstance(w, dict) else w.shape[1]
        plan = ffn_tail.ffn_tail_plan(x.shape[0], x.shape[1], f, x.dtype,
                                      gated='gated' in name,
                                      int8=name.endswith('int8'))
    if by_shape or plan is None:
        shapes = tuple(tuple(a.shape) if torch.is_tensor(a) else a
                       for a in args if not isinstance(a, dict))
        plan = shapes if plan is None else (plan, shapes)
    return name, repr(plan)


def record_wrappers(names, records, first_only=False, modules=(),
                    by_shape=False):
    """Patch the named wrappers in their modules (and under the same names in
    `modules`, which imported them: the engine) to hold each call's output
    against the twin on the same tensors at once (autograd may accumulate into
    a gradient buffer later), keeping (name, form, None, (output, twin's)) in
    records (call_form: the wrapper and the kernels its rule picks, by_shape:
    and the operands' shapes); first_only holds only the first
    call of each form. Returns the function that undoes it. A
    wrapper counts its launches on the name it is reached by, the recorder
    while patched: undo hands that count back."""
    import importlib
    patched, seen = [], set()
    for name in names:
        mod_name, twin = WRAPPER_TWINS[name]
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, name)

        def rec(*a, _orig=orig, _name=name, _twin=getattr(mod, twin), **kw):
            out = _orig(*a, **kw)
            form = None
            form = call_form(_name, a, by_shape)
            if first_only:
                if form in seen:
                    return out
                seen.add(form)
            records.append((_name, form, None, (out, _twin(*a, **kw))))
            return out
        rec.launches = 0
        for m in (mod, *modules):
            if getattr(m, name, None) is orig:
                setattr(m, name, rec)
                patched.append((m, name, orig))
        patched.append((None, name, orig, rec))

    def undo():
        for entry in patched:
            if entry[0] is None:
                _, name, orig, rec = entry
                orig.launches += rec.launches
            else:
                m, name, orig = entry
                setattr(m, name, orig)
    return undo


def train_launches(cfg, variant=None, remat=False, flash=False):
    """Kernel launches a layer a training step: the block-sparse lse
    forward, dq and dk/dv (flash: the flash-attention forward, dq and dk/dv,
    the dense stages' attention); int8_base one int8_matmul (forward) and
    one int8_matmul_t (dx) per frozen kernel (q/k/v/o and the FFN's 2 or 3);
    gmm 4 forward products of routed_ffn_lora_gmm and their 4 dlhs, and 2
    tgmm (the two LoRA factors' gradients; the frozen w1 / w2 get none).
    remat runs each block's forward twice: its launches count twice."""
    fwd = 2 if remat else 1
    attn = FLASH_KERNELS if flash else TRAIN_KERNELS
    out = dict(zip(attn, (fwd, 1, 1)))
    if variant == 'int8_base':
        n = 4 + (3 if cfg.ffn_gated else 2)
        out.update(int8_matmul=n * fwd, int8_matmul_t=n)
    elif variant == 'gmm':
        out.update(gmm=4 * fwd + 4, tgmm=2)
    return out


def plain_card_step0(label, state_on, run, before, m_cpu, grads_c,
                     per_layer):
    """The stepwise card run with the variant's kernel wrappers swapped for
    their plain twins (on the CUDA tensors): step 0's loss and worst
    gradient against the CPU twins'."""
    import importlib
    names = [n for n in per_layer if n in WRAPPER_TWINS]
    saved = []
    for n in names:
        mod_name, twin = WRAPPER_TWINS[n]
        mod = importlib.import_module(mod_name)
        saved.append((mod, n, getattr(mod, n)))
        setattr(mod, n, getattr(mod, twin))
    grads = {}
    try:
        m, _ = run(state_on(DEV), stepwise_from=before,
                   on_first=lambda st: capture_grads(st, grads))
    finally:
        for mod, n, orig in saved:
            setattr(mod, n, orig)
    loss_rel = abs(m[0]['loss'] - m_cpu[0]['loss']) / abs(m_cpu[0]['loss'])
    worst = max((grads[k] - w).abs().max().item()
                / max(w.abs().max().item(), 1e-30) for k, w in grads_c.items())
    log(f'  [{label}] plain twins on the card (no {"/".join(names)} kernel)'
        f' vs the CPU: step-0 loss rel {loss_rel:.3g}, worst grad '
        f'{worst:.3g} of its max')
    return dict(loss_rel=loss_rel, worst_grad_rel=worst)


def gmm_vs_masked(label, cfg, params, batch, m_gmm, grads_gmm):
    """Step 0 of the masked FFN on the card from the same weights against
    the gmm one (the same function): loss to 1e-5 relative, gradients to
    GRAD_REL_BOUND of each leaf's largest (ReLU kinks, as card vs CPU)."""
    from spt_proto_tpu_torch.tuning import trainer
    grads = {}
    st = trainer.create_train_state(cfg.replace(ffn_impl='masked'),
                                    to_dev(params, DEV))
    capture_grads(st, grads)
    _, m = trainer.make_train_step(cfg)(st, batch)
    e_loss = abs(m['loss'].item() - m_gmm['loss']) / abs(m_gmm['loss'])
    worst = max((grads[k] - w).abs().max().item()
                / max(w.abs().max().item(), 1e-30)
                for k, w in grads_gmm.items())
    require(e_loss <= 1e-5 and worst <= GRAD_REL_BOUND,
            f'{label}: gmm vs masked on the card: loss rel {e_loss}, worst '
            f'grad {worst}')
    log(f'  [{label}] gmm vs masked on the card: loss rel {e_loss:.3g}, '
        f'worst grad {worst:.3g} of its max')
    return dict(loss_rel=e_loss, worst_grad_rel=worst)


# phase 2's bf16 bound for outputs (output_tolerance): one bf16 step of the
# call's largest output + one step relative
BF16_OUTPUT_TOL = (2 ** -7, 2 ** -7)


def check_recorded_kernels(label, records, wrapper_tol=KERNEL_TOL):
    """The kernels' outputs of a training pass against their twins on the
    same CUDA tensors (the run's own q, k, v, selection and output
    gradient), f32: KERNEL_TOL, for the int8 and grouped matmuls (and
    bf16 runs' grouped matmuls, wrapper_tol BF16_OUTPUT_TOL) with its
    absolute part scaled by the call's largest output. Returns the worst
    error by output."""
    from spt_proto_tpu_torch.ops import block_sparse_attention as m
    from spt_proto_tpu_torch.ops import flash_attention as fa
    worst = {}
    for kind, args, kw, got in records:
        tol = KERNEL_TOL
        if kind in WRAPPER_TWINS:           # (kernel, twin) at the call
            got, want, names = got[:1], got[1:], (kind,)
            # f32 sums whose terms cancel (the LoRA left factors are
            # normal(1.0)): an entry near 0 carries the rounding of the
            # largest terms, so the bound scales with the call's largest
            tol = (wrapper_tol[0] * want[0].float().abs().max().item(),
                   wrapper_tol[1])
        elif kind == 'fwd':
            want = m.block_sparse_attention_lse_ref(*args, **kw)
            names = ('o', 'lse')
        elif kind == 'flash_fwd':
            want = fa.flash_attention_fwd_ref(*args, **kw)
            names = ('flash o', 'flash l', 'flash m')
        elif kind == 'flash_bwd':
            want = fa.flash_attention_bwd_ref(*args, **kw)
            names = ('flash dq', 'flash dk', 'flash dv')
        else:
            want = m.block_sparse_attention_bwd_ref(*args, **kw)
            names = ('dq', 'dk', 'dv')
        for name, a, w in zip(names, got, want):
            err = max_err(a, w)
            worst[name] = max(worst.get(name, 0.0), err)
            require(close(a, w, torch.float32, tol),
                    f'{label}: kernel {name} on the training tensors: err '
                    f'{err} ({tol_str(torch.float32, tol)})')
    log(f'  [{label}] kernels vs twins on the training tensors '
        f'({len(records)} calls): max err ' + ', '.join(
            f'{k} {v:.3g}' for k, v in worst.items()))
    return worst


# remat recomputes each block's forward in the backward ('full'), or all but
# its matmul outputs ('dots'): the same operations on the same inputs, so
# the gradients should equal the no-remat run's up to what a recomputed
# kernel's summation order can change (none: every kernel and cuBLAS call
# of the step is deterministic for fixed shapes)
REMAT_REL_BOUND = 1e-6


def remat_step0(label, cfg, params, batch, policy, grads_ref, variant, flash):
    """Step 0 on the card under remat=True, remat_policy=policy from the
    parity run's weights: the trainable gradients against grads_ref (the
    card's no-remat step 0) to REMAT_REL_BOUND of each leaf's largest, the
    launches of one step exactly (forwards twice a layer)."""
    from spt_proto_tpu_torch.tuning import trainer
    rcfg = cfg.replace(remat=True, remat_policy=policy)
    grads = {}
    state = trainer.create_train_state(rcfg, to_dev(params, DEV))
    capture_grads(state, grads)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    trainer.make_train_step(rcfg)(state, batch)
    sync()
    per_layer = train_launches(cfg, variant, remat=True, flash=flash)
    counts = {n: w.launches for n, w in ws.items()}
    want = {n: cfg.n_layers * per_layer.get(n, 0) for n in ws}
    require(counts == want, f'{label} remat {policy} launches {counts} '
            f'(expected {want})')
    worst = max((grads[k] - w).abs().max().item()
                / max(w.abs().max().item(), 1e-30)
                for k, w in grads_ref.items())
    require(worst <= REMAT_REL_BOUND, f'{label} remat {policy}: worst grad '
            f'{worst} of its max vs no remat (bound {REMAT_REL_BOUND})')
    log(f'  [{label}] remat {policy!r} step 0 vs no remat on the card: worst '
        f'grad {worst:.3g} of its max; launches a layer '
        f'{ {n: c // cfg.n_layers for n, c in counts.items() if c} }')
    del state
    return dict(worst_grad_rel=worst, launches=counts)


def train_parity(label, cfg, b, s, variant=None, step_rel=1e-5,
                 grad_rel=GRAD_REL_BOUND, free_rel=FREE_REL_BOUND,
                 plain_too=False, stages=None, remat_policies=()):
    """f32 training on the card through the kernels against the CPU
    through the twins, from the same weights (the port's init_params, seed
    0, then the upgrade stages: all four, or `stages`, stage i drawing from
    seed 1 + i; variant 'int8_base' then splits the base kernels into
    frozen8, 'gmm' sets ffn_impl='gmm') and batches (numpy seed 0), 3 train
    steps each:
    - stepwise: each card step starts from the CPU run's weights before
      that step; loss, ce and pq_loss to step_rel relative, step 0's
      grad_norm too, and step 0's gradients (before clipping) to grad_rel
      of each trainable leaf's largest entry;
    - the kernels: per layer a step 1 lse forward, 1 dq and 1 dk/dv, and
      the variant's (int8_base: 1 int8_matmul and 1 int8_matmul_t a frozen
      kernel; gmm: 8 gmm and 2 tgmm); all their outputs against the twins
      on the steps' own CUDA tensors (KERNEL_TOL);
    - free-running on the card from the same start: losses to free_rel of
      the CPU's;
    - plain_too: the stepwise run once more with the variant's wrappers
      replaced by their twins on the card (no kernel of theirs), whose
      step-0 loss and gradients against the CPU's show how much of the
      card-vs-CPU gap the kernels own (reported);
    - remat_policies: step 0 once more on the card under remat=True with
      each policy ('full', 'dots'), its gradients held to the card's
      no-remat ones (REMAT_REL_BOUND of each leaf's largest) and its
      forward launches counted twice a layer.
    Before the mha_v2 stage the attention is dense: the flash-attention
    kernels in place of the block-sparse ones."""
    from spt_proto_tpu_torch.tuning import surgery, trainer
    from spt_proto_tpu_torch.utils.tree import flatten
    t0 = time.perf_counter()
    params = surgery.init_params(cfg, SEED, 'cpu')
    if stages is None:
        cfg, params = surgery.full_upgrade(cfg, params, SEED + 1)
    else:
        for i, stage in enumerate(stages):
            cfg, params = surgery.upgrade(cfg, params, stage, SEED + 1 + i)
    cfg = cfg.replace(attn_impl='pallas', dtype=torch.float32)
    frozen8 = None
    flash = cfg.attention != 'sparse_v2'
    per_layer = train_launches(cfg, variant, flash=flash)
    if variant == 'gmm':
        cfg = cfg.replace(ffn_impl='gmm')
    elif variant == 'int8_base':
        cfg, params, frozen8 = surgery.split_int8_base(cfg, params)
    state_on = lambda dev: trainer.create_train_state(
        cfg, to_dev(params, dev),
        frozen8=None if frozen8 is None else to_dev(frozen8, dev))
    r = np.random.RandomState(SEED)
    batches = []
    for _ in range(3):
        x = r.randint(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
        batches.append({'inputs': x[:, :-1], 'targets': x[:, 1:]})
    ws = wrappers()
    # pq_loss is 0 on both sides before the mha_v1 stage
    rel = lambda a, b_: abs(a - b_) / abs(b_) if b_ else abs(a - b_)
    step = trainer.make_train_step(cfg)

    def run(state, stepwise_from=None, on_first=None, keep=False):
        """3 steps: (metrics, the weights before each step if keep); with
        stepwise_from, each step starts from those weights."""
        metrics, before = [], []
        for i, batch in enumerate(batches):
            if stepwise_from is not None:
                with torch.no_grad():
                    for k, v in flatten(state.params).items():
                        v.copy_(stepwise_from[i][k])
            if keep:
                before.append({k: v.detach().clone()
                               for k, v in flatten(state.params).items()})
            if i == 0 and on_first is not None:
                on_first(state)
            state, m = step(state, batch)
            metrics.append({k: v.item() for k, v in m.items()})
        return metrics, before

    grads_c, grads_g, records = {}, {}, []
    m_cpu, before = run(state_on('cpu'),
                        on_first=lambda st: capture_grads(st, grads_c),
                        keep=True)
    log(f'  [{label}] cpu: {time.perf_counter() - t0:.1f} s')
    for w in ws.values():
        w.launches = 0
    undo = []

    def first_card_step(st):
        capture_grads(st, grads_g)
        undo.append(record_attention(records))
        undo.append(record_wrappers(
            [n for n in per_layer if n in WRAPPER_TWINS], records))
    card = state_on(DEV)
    try:
        m_step, _ = run(card, stepwise_from=before, on_first=first_card_step)
    finally:
        for u in undo:
            u()
    del card
    counts = {n: w.launches for n, w in ws.items()}
    want = {n: 3 * cfg.n_layers * per_layer.get(n, 0) for n in ws}
    require(counts == want, f'{label} launches in 3 steps {counts} '
            f'(expected {want})')
    kernel_err = check_recorded_kernels(label, records)
    del records
    plain = None
    if plain_too:
        plain = plain_card_step0(label, state_on, run, before, m_cpu,
                                 grads_c, per_layer)
    remat = {policy: remat_step0(label, cfg, params, batches[0], policy,
                                 grads_g, variant, flash)
             for policy in remat_policies}
    step_worst = 0.0
    for i in range(3):
        for name in ('loss', 'ce', 'pq_loss') + (('grad_norm',) if i == 0
                                                 else ()):
            e = rel(m_step[i][name], m_cpu[i][name])
            step_worst = max(step_worst, e)
            require(e <= step_rel,
                    f'{label} stepwise step {i} {name} {m_step[i][name]} vs '
                    f'{m_cpu[i][name]} (rel {e}, bound {step_rel})')
    worst = {}
    for k, w in grads_c.items():
        scale = w.abs().max().item()
        err = (grads_g[k] - w).abs().max().item()
        worst[k] = err / scale if scale > 0 else err
        require(err <= grad_rel * scale, f'{label} grad {k}: err '
                f'{err} vs {grad_rel} x {scale}')
    m_free, _ = run(state_on(DEV))
    free_rel_ = [rel(a['loss'], b_['loss']) for a, b_ in zip(m_free, m_cpu)]
    require(max(free_rel_) <= free_rel, f'{label} free-running losses '
            f'{[m["loss"] for m in m_free]} vs '
            f'{[m["loss"] for m in m_cpu]} (bound {free_rel})')
    free_rel = free_rel_
    vs_masked = None
    if variant == 'gmm':
        vs_masked = gmm_vs_masked(label, cfg, params, batches[0], m_step[0],
                                  grads_g)
    terms_g, terms_c = m_step[0], m_cpu[0]
    worst_leaf = max(worst, key=worst.get)
    m_free = [m['loss'] for m in m_free]
    out = dict(loss_card=terms_g['loss'], loss_cpu=terms_c['loss'],
               grad_norm_card=m_step[0]['grad_norm'],
               grad_norm_cpu=m_cpu[0]['grad_norm'],
               stepwise_losses_card=[m['loss'] for m in m_step],
               losses_cpu=[m['loss'] for m in m_cpu],
               free_losses_card=m_free, free_rel=free_rel,
               grad_rel_by_leaf=worst, kernel_max_err=kernel_err,
               stepwise_max_rel=step_worst, launches=counts,
               vs_masked=vs_masked, plain_on_card=plain, remat=remat,
               seconds=time.perf_counter() - t0)
    log(f'  [{label}] loss {terms_g["loss"]:.7f} vs {terms_c["loss"]:.7f}; '
        f'grad_norm {m_step[0]["grad_norm"]:.6f} vs '
        f'{m_cpu[0]["grad_norm"]:.6f}; worst grad {worst[worst_leaf]:.3g} of '
        f'its max ({worst_leaf}); stepwise losses {out["stepwise_losses_card"]}'
        f' vs {out["losses_cpu"]} (worst metric rel {step_worst:.3g}); '
        f'free-running {m_free} (rel {free_rel}); {out["seconds"]:.1f} s')
    log('    grad rel by leaf: ' + ', '.join(
        f'{k} {v:.2g}' for k, v in sorted(worst.items(),
                                         key=lambda kv: -kv[1])))
    return out


# profiler kernel names of the training kernels (in situ µs): a wrapper's
# kernels, timed together, a call counted once (tgmm: the kernel and its
# reduce, counted by the first)
IN_SITU = {
    'block_sparse_attention_lse': lambda k: 'block_sparse_fwd_kernel' in k,
    'block_sparse_attention_dq': lambda k: 'block_sparse_dq_kernel' in k,
    'block_sparse_attention_dkv': lambda k: 'block_sparse_dkv_kernel' in k,
    'int8_matmul': lambda k: ('int8_matmul_' in k
                              and 'int8_matmul_t_kernel' not in k),
    'int8_matmul_t': lambda k: 'int8_matmul_t_kernel' in k,
    'gmm': lambda k: 'gmm_' in k and 'tgmm_' not in k,
    'tgmm': lambda k: 'tgmm_' in k,
    'flash_attention': lambda k: 'flash_fwd_kernel' in k,
    'flash_attention_dq': lambda k: 'flash_dq_kernel' in k,
    'flash_attention_dkv': lambda k: 'flash_dkv_kernel' in k}
# the kernels a bf16 training step never launches: the CUDA-core
# block-sparse backward (every bf16 training call takes the tensor-core
# pair, bwd_route); a profiled bf16 tune window is held to it
NOT_BF16_TRAIN = ('block_sparse_dq_kernel<__nv_bfloat16',
                  'block_sparse_dkv_kernel<__nv_bfloat16')
# kernels of IN_SITU that are not counted as calls
IN_SITU_UNCOUNTED = ('tgmm_reduce_kernel', 'int8_matmul_reduce_kernel')
# the bf16 training kernels of the grouped matmuls (phase 10's gmm run
# must launch no other)
GMM_TC_KERNELS = {'gmm': ('gmm_tc_kernel',),
                  'tgmm': ('tgmm_tc_kernel', 'tgmm_reduce_kernel')}


class _StopRun(Exception):
    """Ends a measured tune run after its last profiled step (a 7B run's
    checkpoint writes are not what it measures)."""


def train_run(label, argv, b, s, n_layers, per_layer=None, timed=TRAIN_TIMED,
              cfg_patch=None, stop_after=False, check_first=(),
              first_only=False, loss_slack=0.0):
    """cli.tune.main(argv) on the card, TRAIN_WARMUP + `timed` +
    TRAIN_PROFILED steps: each step bracketed by CUDA events, the launch
    counters zeroed after the warm-up and held exactly after the timed
    steps (per_layer launches a layer a step, by default 1 lse forward, 1
    dq and 1 dk/dv, nothing else), peak memory over the timed steps, then
    the profiled steps. cfg_patch changes the config the CLI hands its
    training loop (ffn_impl='gmm': the CLI has no flag for it, as JAX's
    has none); stop_after ends the run after the profiled steps, before
    the CLI writes its checkpoints; check_first names wrappers (of
    WRAPPER_TWINS) whose every call in the first warm-up step (first_only:
    the first call of each kernel and operand shape, call_form) is held
    against its twin on the same tensors (check_recorded_kernels at
    BF16_OUTPUT_TOL); the last loss must come out below the first plus
    loss_slack."""
    from torch.profiler import ProfilerActivity, profile
    from spt_proto_tpu_torch.cli import tune
    from spt_proto_tpu_torch.tuning import trainer
    import tempfile
    per_layer = per_layer or dict.fromkeys(TRAIN_KERNELS, 1)
    ws = wrappers()
    rec = dict(events=[], losses=[])
    make, loop = trainer.make_train_step, trainer.train_loop
    first_profiled = TRAIN_WARMUP + timed
    n_steps = first_profiled + TRAIN_PROFILED

    def instrumented(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            i = state.step
            if i == TRAIN_WARMUP:
                sync()
                torch.cuda.reset_peak_memory_stats()
                for w in ws.values():
                    w.launches = 0
            if i == first_profiled:
                sync()
                rec['counts'] = {n: w.launches for n, w in ws.items()}
                rec['peak'] = torch.cuda.max_memory_allocated()
                rec['prof'] = profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
                rec['prof'].__enter__()
                rec['window'] = [torch.cuda.Event(enable_timing=True)
                                 for _ in range(2)]
                rec['window'][0].record()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            if i == 0 and check_first:
                records = []
                undo = record_wrappers(check_first, records, first_only,
                                       by_shape=first_only)
                try:
                    state, m = step(state, batch)
                finally:
                    undo()
                rec['first_step_check'] = dict(
                    calls=dict(collections.Counter(r[0] for r in records)),
                    forms=[r[1][1] for r in records if r[1]],
                    worst=check_recorded_kernels(label, records,
                                                 BF16_OUTPUT_TOL))
                del records
            else:
                state, m = step(state, batch)
            ev[1].record()
            rec['events'].append(ev)
            rec['losses'].append(m['loss'].detach())
            if i == n_steps - 1:
                rec['window'][1].record()
                sync()
                rec['prof'].__exit__(None, None, None)
                if stop_after:
                    raise _StopRun
            return state, m
        return run

    trainer.make_train_step = instrumented
    if cfg_patch is not None:
        trainer.train_loop = lambda cfg, *a, **kw: loop(cfg_patch(cfg), *a,
                                                        **kw)
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            tune.main(argv + ['--steps', str(n_steps), '--out',
                              out_dir + '/tuned'])
    except _StopRun:
        pass
    finally:
        trainer.make_train_step, trainer.train_loop = make, loop
    timed_ev = rec['events'][TRAIN_WARMUP:first_profiled]
    step_ms = sum(e[0].elapsed_time(e[1]) for e in timed_ev) / len(timed_ev)
    losses = [x.item() for x in rec['losses']]
    want = {n: timed * n_layers * per_layer.get(n, 0) for n in ws}
    require(rec['counts'] == want,
            f'{label} launches in {timed} steps: {rec["counts"]} '
            f'(expected {want})')
    require(all(np.isfinite(losses)) and losses[-1] < losses[0] + loss_slack,
            f'{label} losses {losses} (slack {loss_slack})')
    prof = profile_summary(label, rec['prof'], rec['window'][0].elapsed_time(
        rec['window'][1]) * 1e3)
    if 'bfloat16' in argv:
        old = sorted(k for k in prof['by_kernel']
                     if any(name in k for name in NOT_BF16_TRAIN))
        require(not old, f'{label}: the bf16 training steps launched {old}')
    in_situ, in_situ_names = {}, {}
    for n in per_layer:
        hits = [(k, t, c) for k, (t, c) in prof['by_kernel'].items()
                if IN_SITU[n](k)]
        calls = sum(c for k, _, c in hits
                    if not any(u in k for u in IN_SITU_UNCOUNTED))
        in_situ[n] = sum(t for _, t, _ in hits) / max(1, calls)
        in_situ_names[n] = {k: dict(us=t / c, calls=c) for k, t, c in hits}
    res = dict(step_ms=step_ms, tok_s=b * s / step_ms * 1e3,
               peak_mem_gb=rec['peak'] / 1e9,
               busy_share=prof['busy_share'],
               top=prof['top'], kernel_us_in_situ=in_situ,
               kernel_names_in_situ=in_situ_names, losses=losses,
               first_step_check=rec.get('first_step_check'),
               launches=rec['counts'],
               launches_per_step={n: c / timed
                                  for n, c in rec['counts'].items()},
               launches_per_prefill=dict.fromkeys(ws, 0))
    log(f'  [{label}] {step_ms:.2f} ms/step = {res["tok_s"]:.0f} tok/s, '
        f'peak {res["peak_mem_gb"]:.2f} GB, busy {prof["busy_share"]}, '
        f'kernels in situ (us) {in_situ}; losses {losses}')
    return res


def phase_training():
    from spt_proto_tpu_torch.config import llama_config, opt_config
    parity = dict(
        opt_125m=train_parity(
            'parity OPT-125M 2 layers B=2 S=2048',
            opt_config('125m', n_layers=2, sparse_coeff=4), 2, 2048),
        # 1 layer: the script's time grew with phase 10
        llama_3_8b=train_parity(
            'parity Llama-3-8B width 1 layer V=32000 B=1 S=1024',
            llama_config('3-8b', n_layers=1, vocab_size=32000,
                         sparse_coeff=2), 1, 1024))
    base = ['--device', DEV, '--config', 'opt-125m', '--batch_size', str(B)]
    runs = {
        'train 125M f32 B=8 S=512': train_run(
            'train 125M f32 B=8 S=512', base, B, 512, LAYERS),
        'train 125M bf16 B=8 S=512': train_run(
            'train 125M bf16 B=8 S=512', base + ['--dtype', 'bfloat16'], B,
            512, LAYERS),
        'train 125M bf16 B=8 S=2048': train_run(
            'train 125M bf16 B=8 S=2048',
            base + ['--dtype', 'bfloat16', '--seq_length', '2049'], B, 2048,
            LAYERS)}
    torch.cuda.empty_cache()
    return dict(parity=parity, runs=runs)


# ---------------------------------------------------------------------------
# phase 10: int8-base (QLoRA-shape) and grouped-matmul routed-FFN training
# ---------------------------------------------------------------------------

def w8_routed_parity():
    """w8 serving of a tuned checkpoint (the int8 build keeps the routed
    FFN's block views and router fp, LoRA separate): OPT-125M at full width
    after the four stages (d_lora 16, 4 blocks), LoRA right factors from a
    seed, f32, sparse int8-KV, by phase 3's w8 rule (stepwise from the CPU
    twins' state, each decision within one bf16 step of theirs)."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.tuning import surgery
    from spt_proto_tpu_torch.utils.tree import flatten, unflatten
    cfg = opt_cfg('125m', PARITY_MAX_LEN, torch.float32)
    cfg, params = surgery.full_upgrade(
        cfg, init_params(cfg, SEED, device='cpu'), SEED + 1)
    g = gen(SEED + 16, 'cpu')
    params = unflatten({
        k: torch.randn(v.shape, generator=g) * 2e-3 if 'lora_right' in k
        else v for k, v in flatten(params).items()})
    tokens = torch.randint(1, VOCAB, (PARITY_B, PARITY_PROMPT),
                           generator=gen(SEED + 17, 'cpu'))
    return parity_modes('OPT-125M tuned', tokens, [
        ('w8 routed+LoRA sparse int8-KV', cfg, params, True, 'int8')])


# int8_base parity, card (kernels) vs CPU (twins), f32. Not phase 9's 1e-5
# / 5e-2: the int8 forward rounds every projection input to bf16, so an f32
# ulp between the card's and the CPU's plain ops becomes a whole bf16 step
# of an operand on a rounding boundary. Measured on an H100 80GB HBM3 at
# 700 W: step-0 loss 3.6e-5 / 1.4e-4 relative (OPT-125M / LLaMA-7B width),
# grad_norm 1.1e-3, gradients 0.10 / 0.13 of a leaf's largest; the plain
# twins on the card (no int8 kernel) against the CPU show the same: loss
# 4.8e-5 / 6.6e-5, gradients 0.13 / 0.04. So the stepwise metrics are held
# to 5e-3, the gradients to 0.25 of each leaf's largest, free-running
# losses to FREE_REL_BOUND (measured 6.1e-4), and the kernels on the
# steps' own tensors at f32 tightness (check_recorded_kernels).
INT8_STEP_REL = 5e-3
INT8_GRAD_REL = 0.25
INT8_FREE_REL = FREE_REL_BOUND
# The LLaMA-7B int8_base tune run (bf16, lr 1e-3) first rises for ~5 steps
# and then falls, and whether its 10th loss comes out below its first
# depends on the order of int8_matmul's f32 sums. Measured on an H100 80GB
# HBM3 at 700 W (kernel_ab.py --int8-losses), 10th minus 1st loss on the
# synthetic data of numpy seeds 0 / 1 / 2: the wgmma kernel +0.021 /
# -0.195 / -0.296, the CUDA-core kernels -0.296 / -0.049 / -0.072, the
# plain twin -0.117 / +0.025 / -0.301; on one seed the three 10th losses
# span up to 0.29 (seed 0: 11.501 / 11.669 / 11.791), and every
# int8_matmul call of steps 0, 5 and 9 stayed within the bf16 bound of the
# twin. So the run's last loss is held below its first plus that spread: a
# run that diverges fails, one whose summation order moves it does not.
INT8_BASE_LOSS_SPREAD = 0.3


def phase_int8_gmm():
    """Phase 10: f32 parity of int8_base (OPT-125M and LLaMA-7B width) and
    ffn_impl='gmm' (OPT-125M width, also against the masked form on the
    card); full-width bf16 tune runs (LLaMA-7B full depth with and without
    --int8_base, B=4 S=512, --remat; OPT-125M gmm at the tune defaults);
    w8 serving of a routed checkpoint."""
    from spt_proto_tpu_torch.config import llama_config, opt_config
    parity = dict(
        int8_opt_125m=train_parity(
            'int8_base parity OPT-125M 2 layers B=2 S=2048',
            opt_config('125m', n_layers=2, sparse_coeff=4), 2, 2048,
            variant='int8_base', step_rel=INT8_STEP_REL,
            grad_rel=INT8_GRAD_REL, free_rel=INT8_FREE_REL, plain_too=True),
        int8_llama_7b=train_parity(
            'int8_base parity LLaMA-7B width 2 layers B=1 S=1024',
            llama_config('7b', n_layers=2, sparse_coeff=2), 1, 1024,
            variant='int8_base', step_rel=INT8_STEP_REL,
            grad_rel=INT8_GRAD_REL, free_rel=INT8_FREE_REL, plain_too=True),
        gmm_opt_125m=train_parity(
            'gmm parity OPT-125M 2 layers B=2 S=2048',
            opt_config('125m', n_layers=2, sparse_coeff=4), 2, 2048,
            variant='gmm'))
    torch.cuda.empty_cache()
    from spt_proto_tpu_torch.config import llama_config as llc
    ll = llc('7b')
    # lr 1e-3 (the tune default is 1e-4): at 1e-4, 8 steps of random tokens
    # moved LLaMA-7B's loss by less than its batch-to-batch noise (measured
    # 11.797 -> 11.831 on the card), so "the last below the first" could
    # not show training; the step's time does not depend on the rate.
    # --remat: without it the PQ aux loss's saved l1 distances (~1.07 GB a
    # layer at B=4 S=512) put the int8_base run at 81.27 GB and the bf16
    # base out of the card's memory (measured on an H100 80GB HBM3, 700 W)
    b7 = ['--device', DEV, '--config', 'llama-7b', '--dtype', 'bfloat16',
          '--batch_size', str(B_7B), '--lr', '1e-3', '--remat']
    runs = {}
    # every int8_matmul call of the first step (the wgmma kernel: q/k/v/o,
    # gate/side, down, and the --remat recompute) held against its twin on
    # its own tensors; the last of the 10 losses held below the first plus
    # INT8_BASE_LOSS_SPREAD
    per_layer = train_launches(ll, 'int8_base', remat=True)
    i8 = runs['train llama-7b int8_base bf16 B=4 S=512'] = train_run(
        'train llama-7b int8_base bf16 B=4 S=512', b7 + ['--int8_base'],
        B_7B, 512, ll.n_layers, per_layer, timed=6, stop_after=True,
        check_first=('int8_matmul',), loss_slack=INT8_BASE_LOSS_SPREAD)
    check = i8['first_step_check']
    require(check['calls'] == {'int8_matmul': ll.n_layers
                               * per_layer['int8_matmul']}
            and all('wgmma' in f for f in check['forms']),
            f'int8_base first step: calls checked {check["calls"]}, forms '
            f'{sorted(set(check["forms"]))}')
    torch.cuda.empty_cache()
    runs['train llama-7b bf16 B=4 S=512'] = train_run(
        'train llama-7b bf16 B=4 S=512', b7, B_7B, 512, ll.n_layers,
        train_launches(ll, remat=True), timed=6, stop_after=True)
    torch.cuda.empty_cache()
    base = ['--device', DEV, '--config', 'opt-125m', '--batch_size', str(B),
            '--dtype', 'bfloat16']
    per_layer = train_launches(opt_config('125m'), 'gmm')
    gmm_run = runs['train 125M gmm bf16 B=8 S=512'] = train_run(
        'train 125M gmm bf16 B=8 S=512', base, B, 512, LAYERS, per_layer,
        cfg_patch=lambda c: c.replace(ffn_impl='gmm'),
        check_first=('gmm', 'tgmm'))
    calls = {n: LAYERS * per_layer[n] for n in GMM_TC_KERNELS}
    checked = gmm_run['first_step_check']['calls']
    require(checked == calls, f'first step checked {checked} calls '
            f'(expected {calls})')
    for n, kernels in GMM_TC_KERNELS.items():
        names = sorted(gmm_run['kernel_names_in_situ'][n])
        require(names and all(any(k in name for k in kernels)
                              for name in names),
                f'bf16 {n} launched {names}: only {kernels} expected')
    i8, fp = (runs['train llama-7b int8_base bf16 B=4 S=512'],
              runs['train llama-7b bf16 B=4 S=512'])
    log(f'  LLaMA-7B int8_base vs bf16 base: {i8["step_ms"]:.2f} vs '
        f'{fp["step_ms"]:.2f} ms/step, peak {i8["peak_mem_gb"]:.2f} vs '
        f'{fp["peak_mem_gb"]:.2f} GB')
    torch.cuda.empty_cache()
    serving = w8_routed_parity()
    return dict(parity=parity, runs=runs, w8_routed=serving)


# ---------------------------------------------------------------------------
# phase 11: dense and LoRA-stage training and forward (the flash-attention
# kernels), the evaluate loop and the profile CLI
# ---------------------------------------------------------------------------

DENSE_STAGES = ('lora', 'ffn', 'mha_v1')
EVAL_B, EVAL_S = 8, 512
PROFILE_ITERS = 5


def mmlu_batches(vocab, n, b, s, seed):
    """Synthetic batches shaped as data/datamodule.py gives them (numpy
    seed): rows of random tokens, the mask 0 past a random length."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        row = r.randint(0, vocab, size=(b, s + 1)).astype(np.int32)
        lengths = r.randint(3, s + 1, size=b).astype(np.int32)
        mask = (np.arange(s)[None] < lengths[:, None] - 1).astype(np.int32)
        out.append({'inputs': row[:, :-1], 'targets': row[:, 1:],
                    'mask': mask, 'lengths': lengths})
    return out


def dense_stage_model(cfg, dtype, dev):
    """cfg's seeded weights (seed 0) through the dense stages on `dev`."""
    from spt_proto_tpu_torch.tuning import surgery
    params = surgery.init_params(cfg, SEED, dev)
    for i, stage in enumerate(DENSE_STAGES):
        cfg, params = surgery.upgrade(cfg, params, stage, SEED + 1 + i)
    return cfg.replace(attn_impl='pallas', dtype=dtype), params


def evaluate_parity():
    """tuning.evaluate at OPT-125M width, 2 layers, f32, stages
    lora,ffn,mha_v1, 2 MMLU-shaped batches of B=4, S=512: the card
    (flash kernels) against the CPU twins from the same weights: ppl to
    1e-4 relative; the answers equal, or each differing one a near-tie
    (the CPU's answer within 2^-7 max|logit| of the card's best, phase 3's
    rule)."""
    from spt_proto_tpu_torch.config import opt_config
    from spt_proto_tpu_torch.tuning import evaluate
    t0 = time.perf_counter()
    cfg, params = dense_stage_model(opt_config('125m', n_layers=2),
                                    torch.float32, 'cpu')
    batches = mmlu_batches(cfg.vocab_size, 2, 4, EVAL_S, SEED + 21)
    card_params = to_dev(params, DEV)
    got = evaluate.evaluate(cfg, card_params, batches)
    want = evaluate.evaluate(cfg, params, batches)
    fwd_c = evaluate.make_forward(cfg, card_params)
    fwd_t = evaluate.make_forward(cfg, params)
    differ, worst_gap = 0, 0.0
    for batch in batches:
        pos = batch['lengths'].astype(np.int64) - 2
        rows = np.arange(len(pos))
        lc = fwd_c(batch['inputs'])[rows, pos].float().cpu()
        lt = fwd_t(batch['inputs'])[rows, pos].float()
        pc, pt = lc.argmax(-1), lt.argmax(-1)
        for r in np.nonzero((pc != pt).numpy())[0]:
            gap = (lc[r, pc[r]] - lc[r, pt[r]]).item()
            differ += 1
            worst_gap = max(worst_gap, gap / lc[r].abs().max().item())
    rel = abs(got['ppl'] - want['ppl']) / want['ppl']
    log(f'  [evaluate OPT-125M 2 layers f32] card ppl {got["ppl"]:.6f} vs '
        f'CPU {want["ppl"]:.6f} (rel {rel:.3g}); accuracy {got["accuracy"]}'
        f' vs {want["accuracy"]} over {got["n_examples"]}; differing '
        f'answers {differ} (worst gap {worst_gap:.3g} of max|logit|); '
        f'{time.perf_counter() - t0:.1f} s')
    require(rel <= 1e-4 and got['n_examples'] == want['n_examples']
            and worst_gap <= 2 ** -7
            and (differ or got['accuracy'] == want['accuracy']),
            f'evaluate parity: {got} vs {want}, {differ} differing answers, '
            f'worst gap {worst_gap}')
    del card_params, fwd_c
    torch.cuda.empty_cache()
    return dict(card=got, cpu=want, ppl_rel=rel, differing_answers=differ,
                worst_gap=worst_gap)


def evaluate_run():
    """tuning.evaluate on the card at OPT-125M full depth, bf16, stages
    lora,ffn,mha_v1, 4 batches of B=8, S=512: exactly one flash forward a
    layer a batch (no backward kernel, no block-sparse one), tokens/s over
    the loop (host clock, ending in a sync)."""
    from spt_proto_tpu_torch.config import opt_config
    from spt_proto_tpu_torch.tuning import evaluate
    cfg, params = dense_stage_model(opt_config('125m'), torch.bfloat16, DEV)
    batches = mmlu_batches(cfg.vocab_size, 4, EVAL_B, EVAL_S, SEED + 22)
    evaluate.evaluate(cfg, params, batches[:1])           # warm-up
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    sync()
    t0 = time.perf_counter()
    res = evaluate.evaluate(cfg, params, batches)
    sync()
    dt = time.perf_counter() - t0
    counts = {n: w.launches for n, w in ws.items()}
    want = {n: (len(batches) * cfg.n_layers if n == 'flash_attention'
                else 0) for n in ws}
    require(counts == want and np.isfinite(res['ppl']),
            f'evaluate run: launches {counts} (expected {want}), {res}')
    tok_s = len(batches) * EVAL_B * EVAL_S / dt
    log(f'  [evaluate OPT-125M bf16 B={EVAL_B} S={EVAL_S}] {len(batches)} '
        f'batches in {dt * 1e3:.1f} ms = {tok_s:.0f} tok/s; {res}; flash '
        f'forwards {counts["flash_attention"]}')
    del params
    torch.cuda.empty_cache()
    return dict(seconds=dt, tok_s=tok_s, result=res, launches=counts)


def profile_run(label, argv, per_iter, trace=False):
    """cli.profile.main(argv) on the card (OPT-125M full depth, bf16, B=8,
    S 2048, PROFILE_ITERS timed after one warm-up): its JSON line, and the
    kernel launches of the whole run held exactly to per_iter (launches a
    layer an iteration) x layers x (1 + iters). With trace: --trace_dir
    (a temporary directory) traces PROFILE_ITERS more iterations, whose
    top device operations are logged."""
    from spt_proto_tpu_torch.cli import profile
    import tempfile
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    iters = (1 + PROFILE_ITERS * (2 if trace else 1))
    with tempfile.TemporaryDirectory() as trace_dir:
        out = profile.main(
            ['--device', DEV, '--config', 'opt-125m', '--dtype', 'bfloat16',
             '--batch_size', str(B), '--seq_length', str(PROMPT), '--iters',
             str(PROFILE_ITERS)] + argv
            + (['--trace_dir', trace_dir] if trace else []))
    sync()
    counts = {n: w.launches for n, w in ws.items()}
    want = {n: per_iter.get(n, 0) * LAYERS * iters for n in ws}
    require(counts == want, f'{label} launches {counts} (expected {want})')
    peak = out['memory']['peak_bytes_in_use'] / 1e9
    runs = LAYERS * iters
    if trace:
        log(f'  [{label}] top device operations, µs and calls an '
            f'iteration ({PROFILE_ITERS} traced):')
        for name, us, calls in out['trace_top']:
            log(f'    {us:10.1f} us {calls:7.1f}  {name}')
    log(f'  [{label}] {out["step_ms"]:.3f} ms/iter = '
        f'{out["tokens_per_s"]:.0f} tok/s, peak {peak:.2f} GB, warm-up '
        f'{out["compile_s"]} s; launches a layer an iteration '
        f'{ {n: c // runs for n, c in counts.items() if c} }')
    torch.cuda.empty_cache()
    return dict(out, peak_gb=peak, launches=counts)


def phase_dense():
    """Phase 11: f32 parity of the dense-stage train step (flash kernels)
    against the CPU twins (OPT-125M width at lora,ffn,mha_v1 and at lora,
    Llama-3-8B width at lora,ffn,mha_v1), remat 'full' and 'dots' on the
    first; tuning.evaluate (parity, then a full-depth bf16 run); cli.tune
    at OPT-125M full depth, lora,ffn,mha_v1, bf16, with and without
    --remat; cli.profile at S 2048: dense forward, dense / lora / sparse
    train step."""
    from spt_proto_tpu_torch.config import llama_config, opt_config
    parity = dict(
        opt_125m=train_parity(
            'dense parity OPT-125M 2 layers B=2 S=2048 lora,ffn,mha_v1',
            opt_config('125m', n_layers=2), 2, 2048, stages=DENSE_STAGES,
            remat_policies=('full', 'dots')),
        opt_125m_lora=train_parity(
            'dense parity OPT-125M 2 layers B=2 S=2048 lora',
            opt_config('125m', n_layers=2), 2, 2048, stages=('lora',)),
        llama_3_8b=train_parity(
            'dense parity Llama-3-8B width 1 layer V=32000 B=1 S=1024 '
            'lora,ffn,mha_v1',
            llama_config('3-8b', n_layers=1, vocab_size=32000), 1, 1024,
            stages=DENSE_STAGES))
    torch.cuda.empty_cache()
    ev = dict(parity=evaluate_parity(), run=evaluate_run())
    cfg = opt_config('125m')
    base = ['--device', DEV, '--config', 'opt-125m', '--batch_size', str(B),
            '--dtype', 'bfloat16', '--stages', ','.join(DENSE_STAGES)]
    runs = {
        'train 125M dense stages bf16 B=8 S=512': train_run(
            'train 125M dense stages bf16 B=8 S=512', base, B, 512, LAYERS,
            train_launches(cfg, flash=True)),
        'train 125M dense stages bf16 B=8 S=512 remat': train_run(
            'train 125M dense stages bf16 B=8 S=512 remat',
            base + ['--remat'], B, 512, LAYERS,
            train_launches(cfg, remat=True, flash=True))}
    torch.cuda.empty_cache()
    fwd = dict.fromkeys(FLASH_KERNELS[:1], 1)
    step = dict.fromkeys(FLASH_KERNELS, 1)
    profiles = {
        'dense forward': profile_run('profile dense forward S=2048',
                                     ['--tuning', 'dense'], fwd),
        'dense backward': profile_run(
            'profile dense backward S=2048',
            ['--tuning', 'dense', '--backward'], step, trace=True),
        'lora backward': profile_run(
            'profile lora backward S=2048',
            ['--tuning', 'lora', '--backward'], step),
        'sparse backward': profile_run(
            'profile sparse backward S=2048',
            ['--tuning', 'sparse', '--backward'],
            dict.fromkeys(TRAIN_KERNELS, 1))}
    return dict(parity=parity, evaluate=ev, runs=runs, profiles=profiles)


# ---------------------------------------------------------------------------
# phase 12: the command line and the data path (the CLIs' main functions on
# the card: generate, bench_serving, tune --data_root, dump_delta, evaluate,
# model_info, svd_rank), OPT-125M at full width
# ---------------------------------------------------------------------------

CLI_B, CLI_PROMPT, CLI_NEW, CLI_SHARED = 4, 512, 32, 256
CLI_TUNE_STEPS, CLI_EVAL_BATCHES = 3, 4
MMLU_SUBJECTS = ('abstract_algebra', 'college_physics', 'world_religions')


def char_tokenizer(text):
    """A character-level tokenizer: each character's code point mod 250,
    plus 3 (ids 3-252, inside every vocabulary here)."""
    return [ord(c) % 250 + 3 for c in text]


def write_corpus(root, seed):
    """A synthetic MMLU tree (mmlu/{dev,test,auxiliary_train}/<subject>_
    <split>.csv, six columns: question, A-D, answer) and FLAN-mini text
    (flan-mini/*.jsonl, input / output) under root, from a numpy seed."""
    import csv
    r = np.random.RandomState(seed)
    words = ['alpha', 'beta', 'gamma', 'delta', 'field', 'group', 'ring',
             'mass', 'force', 'energy', 'faith', 'temple', 'ritual']

    def phrase(n):
        return ' '.join(r.choice(words, size=n))
    for split, n in (('dev', 6), ('test', 16), ('auxiliary_train', 40)):
        os.makedirs(os.path.join(root, 'mmlu', split))
        for subject in MMLU_SUBJECTS:
            path = os.path.join(root, 'mmlu', split,
                                f'{subject}_{split}.csv')
            with open(path, 'w', newline='') as f:
                w = csv.writer(f)
                for _ in range(n):
                    w.writerow([phrase(12) + '?'] + [phrase(3)
                                                     for _ in range(4)]
                               + ['ABCD'[r.randint(4)]])
    os.makedirs(os.path.join(root, 'flan-mini'))
    with open(os.path.join(root, 'flan-mini', 'part0.jsonl'), 'w') as f:
        for _ in range(200):
            f.write(json.dumps({'input': phrase(r.randint(10, 60)),
                                'output': phrase(r.randint(5, 40))}) + '\n')


def cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def cli_counts(fn):
    """(fn()'s result, the kernel launches it made): the counters zeroed
    just before and read just after."""
    ws = wrappers()
    sync()
    for w in ws.values():
        w.launches = 0
    out = fn()
    sync()
    return out, {n: w.launches for n, w in ws.items()}


def cli_generate(ckpt, prompts):
    """cli.generate.main with --ckpt and --prompt_ids (four prompts of 512
    tokens sharing a 256-token head, 32 new tokens, greedy), plain over an
    int8 KV cache, with int8 weights, speculative (n-gram, k 4) and through
    the continuous batching engine with the prefix cache: the tokens equal
    the engine's called directly on the same card weights, and the
    launches the same calls make (exact per the engine's counts: the
    prefill's and each step's, spec_expected for the speculative run)."""
    from spt_proto_tpu_torch.cli import generate as gen_cli
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.inference.batching import \
        ContinuousBatchingEngine
    from spt_proto_tpu_torch.inference.speculative import \
        generate_speculative
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    from spt_proto_tpu_torch.utils import checkpoint as ckpt_io
    # the references' weights, built as the CLI builds them on the card
    cfg, params = ckpt_io.load_checkpoint(ckpt, DEV)
    cfg = cfg.replace(dtype=torch.bfloat16, attn_impl='pallas')
    ref_iw = {q: InferenceWeights.from_params(cfg, params, quant=q)
              for q in (None, 'int8')}
    del params
    ids = [','.join(map(str, row)) for row in prompts.tolist()]
    argv = ['--device', DEV, '--ckpt', ckpt, '--dtype', 'bfloat16',
            '--max_new_tokens', str(CLI_NEW)]
    for row in ids:
        argv += ['--prompt_ids', row]
    batch = prompts.to(torch.int32)
    lengths = torch.full((CLI_B,), CLI_PROMPT, dtype=torch.int32)
    out, runs = {}, {}
    for name, flags in (('plain', ['--quantized_kv']), ('int8', ['--int8']),
                        ('speculative', ['--speculative', '--spec_k',
                                         str(SPEC_K)]),
                        ('continuous', ['--continuous', '--prefix_cache'])):
        t0 = time.perf_counter()
        got, counts = cli_counts(lambda: gen_cli.main(argv + flags))
        dt = time.perf_counter() - t0
        iw = ref_iw['int8' if name == 'int8' else None]
        quantized = name == 'plain'
        if name == 'continuous':
            def direct():
                eng = ContinuousBatchingEngine(
                    iw, n_slots=CLI_B, max_len=CLI_PROMPT + CLI_NEW,
                    prefix_cache=True)
                rids = [eng.submit(row, CLI_NEW) for row in prompts.tolist()]
                done = {c.request_id: c.tokens for c in eng.run_until_done()}
                return [list(map(int, done[r])) for r in rids]
            want, want_counts = cli_counts(direct)
            rule = 'the direct engine run\'s'
        elif name == 'speculative':
            (ref, st), want_counts = cli_counts(
                lambda: generate_speculative(iw, batch, CLI_NEW, k=SPEC_K,
                                             lengths=lengths))
            want = ref[:, CLI_PROMPT:].tolist()
            _, spec_want = spec_expected(iw, None, False, st['rounds'])
            require(want_counts == spec_want,
                    f'generate speculative: direct launches {want_counts} '
                    f'(expected {spec_want})')
            rule = f'spec_expected over {st["rounds"]} rounds'
        else:
            ref = engine.generate(iw, batch, CLI_NEW, lengths=lengths,
                                  quantized_kv=quantized)
            want = ref[:, CLI_PROMPT:].tolist()
            pre, step = expected_launches(iw, quantized)
            want_counts = {n: pre[n] + (CLI_NEW - 1) * step[n] for n in pre}
            rule = f'the prefill + {CLI_NEW - 1} greedy steps'
        require(got == want, f'cli generate {name}: tokens {got} differ '
                f'from the engine\'s {want}')
        require(counts == want_counts,
                f'cli generate {name}: launches {counts} (expected '
                f'{want_counts}, {rule})')
        log(f'  [cli generate {name}] {CLI_B} x {CLI_NEW} tokens equal the '
            f'engine\'s; {dt:.2f} s with the checkpoint load; launches '
            f'{ {n: c for n, c in counts.items() if c} } ({rule})')
        runs[f'cli generate {name}'] = dict(seconds=dt, launches=counts)
        out[name] = got
    del ref_iw, iw
    torch.cuda.empty_cache()
    return runs


def bench_expected(iw, steps, runs=2):
    """bench_serving's launches in one contiguous mode: `runs` (warm-up and
    timed) prefills + `steps` decode_steps, each step's logits from the
    plain head (an int8_matmul with int8 weights, no argmax kernel)."""
    pre, step = expected_launches(iw, False)
    step = dict(step, lm_head_argmax=0, lm_head_argmax_int8=0)
    if iw.quant == 'int8':
        step['int8_matmul'] += 1
    return {n: runs * (pre[n] + steps * step[n]) for n in pre}


def cli_bench_serving():
    """cli.bench_serving.main --config opt-125m at its defaults (B 8,
    prompt 512, max_len 1024, 32 steps) in all four modes and --spec_k 4:
    each mode's launches held exactly (bench_expected; paged: one
    paged_attention a layer a step), the speculative run's verify, front,
    attention and prefill kernels counted, not zero; its JSON lines
    parsed."""
    import contextlib
    import io
    from spt_proto_tpu_torch.cli import bench_serving as bs
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    counts, built = {}, []
    mode_fn, spec_fn = bs.bench_mode, bs._bench_speculative
    build = InferenceWeights.from_params

    def record(*a, **kw):
        iw = build(*a, **kw)
        built.append(iw)
        return iw

    def counted_mode(args, mode, *a):
        res, counts[mode] = cli_counts(lambda: mode_fn(args, mode, *a))
        return res

    def counted_spec(*a):
        res, counts['speculative'] = cli_counts(lambda: spec_fn(*a))
        return res
    bs.bench_mode, bs._bench_speculative = counted_mode, counted_spec
    InferenceWeights.from_params = staticmethod(record)
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            summary = bs.main(['--device', DEV, '--config', 'opt-125m',
                               '--mode', 'dense', 'sparse', 'int8', 'paged',
                               '--spec_k', str(SPEC_K)])
    finally:
        bs.bench_mode, bs._bench_speculative = mode_fn, spec_fn
        InferenceWeights.from_params = staticmethod(build)
    dt = time.perf_counter() - t0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    require(lines[-1] == summary and len(lines) == 6,
            f'bench_serving lines {lines}')
    res = summary['decode_throughput']
    steps = 32
    runs = {}
    for mode, iw in zip(('dense', 'sparse', 'int8', 'paged'), built):
        if mode == 'paged':
            want = {n: 2 * steps * LAYERS if n == 'paged_attention' else 0
                    for n in counts[mode]}
        else:
            want = bench_expected(iw, steps)
        require(counts[mode] == want and res[mode]['tokens_per_s'] > 0,
                f'bench_serving {mode}: launches {counts[mode]} (expected '
                f'{want}), {res[mode]}')
        log(f'  [cli bench_serving {mode}] {res[mode]["tokens_per_s"]} '
            f'tok/s, {res[mode]["ms_per_step"]} ms/step (B=8, prompt 512, '
            f'32 steps; host time included), compile_s '
            f'{res[mode]["compile_s"]}; launches '
            f'{ {n: c for n, c in counts[mode].items() if c} }')
        runs[f'cli bench_serving {mode}'] = dict(res[mode],
                                                 launches=counts[mode])
    spec = counts['speculative']
    need = ('block_sparse_attention', 'decode_front', 'decode_attention_rows',
            'verify_attention_rows')
    require(all(spec[n] > 0 for n in need)
            and 0 <= res['speculative']['acceptance'] <= 1,
            f'bench_serving speculative: launches {spec}, '
            f'{res["speculative"]}')
    log(f'  [cli bench_serving speculative] {res["speculative"]}; launches '
        f'{ {n: c for n, c in spec.items() if c} }; whole CLI {dt:.1f} s')
    runs['cli bench_serving speculative'] = dict(res['speculative'],
                                                 launches=spec)
    del built
    torch.cuda.empty_cache()
    return runs


def cli_tune(base, corpus, out_dir):
    """cli.tune.main --ckpt base --data_root corpus (the four stages, bf16,
    B 8, S 512) with the character tokenizer: 1 warm-up step, then
    CLI_TUNE_STEPS timed (CUDA events) with exact launches (1 lse
    forward, 1 dq, 1 dk/dv a layer a step); finite losses; the batches it
    trained on equal those mmlu_flan_mixture builds on the CPU."""
    import contextlib
    import io
    from spt_proto_tpu_torch.cli import tune
    from spt_proto_tpu_torch.data.datamodule import mmlu_flan_mixture
    from spt_proto_tpu_torch.tuning import trainer
    from spt_proto_tpu_torch.tuning.partition import count_trainable
    ws = wrappers()
    rec = dict(events=[], losses=[], batches=[])
    make, loop = trainer.make_train_step, trainer.train_loop

    def instrumented(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            if state.step == 1:
                sync()
                for w in ws.values():
                    w.launches = 0
            rec['batches'].append({k: np.array(v) for k, v in batch.items()})
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, m = step(state, batch)
            ev[1].record()
            rec['events'].append(ev)
            rec['losses'].append(m['loss'].detach())
            return state, m
        return run
    trainer.make_train_step = instrumented
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            params, _ = tune.main(
                ['--device', DEV, '--ckpt', base, '--dtype', 'bfloat16',
                 '--data_root', corpus, '--batch_size', str(B), '--steps',
                 str(1 + CLI_TUNE_STEPS), '--out', out_dir],
                tokenizer=char_tokenizer)
    finally:
        trainer.make_train_step, trainer.train_loop = make, loop
    seconds = time.perf_counter() - t0
    saved = json.loads(printed.getvalue().splitlines()[-1])
    n_train = count_trainable(params)[0]
    del params
    sync()
    counts = {n: w.launches for n, w in ws.items()}
    want = {n: CLI_TUNE_STEPS * LAYERS if n in TRAIN_KERNELS else 0
            for n in ws}
    losses = [x.item() for x in rec['losses']]
    cpu = mmlu_flan_mixture(corpus, char_tokenizer, seq_length=513,
                            batch_size=B)
    same = all(sorted(got) == sorted(want_b) and all(
        np.array_equal(got[k], want_b[k]) for k in got)
        for got, want_b in zip(rec['batches'], cpu))
    require(counts == want and all(np.isfinite(losses)) and same
            and saved['delta_params'] == n_train
            and len(rec['batches']) == 1 + CLI_TUNE_STEPS
            and rec['batches'][0]['inputs'].shape == (B, 512),
            f'cli tune --data_root: launches {counts} (expected {want}), '
            f'losses {losses}, batches equal to the CPU\'s: {same}')
    step_ms = [e[0].elapsed_time(e[1]) for e in rec['events'][1:]]
    log(f'  [cli tune --data_root bf16 B={B} S=512] steps '
        f'{[round(t, 2) for t in step_ms]} ms after 1 warm-up; losses '
        f'{losses}; the {len(rec["batches"])} batches equal the CPU\'s '
        f'mmlu_flan_mixture; launches a layer a step '
        f'{ {n: c // (LAYERS * CLI_TUNE_STEPS) for n, c in counts.items() if c} }'
        f'; delta {saved["delta_params"]} parameters (every trainable '
        f'leaf); {seconds:.1f} s with the checkpoint load and writes')
    return dict(step_ms=step_ms, losses=losses, launches=counts,
                delta_params=saved['delta_params'], seconds=seconds)


def cli_evaluate(base, delta, corpus):
    """cli.evaluate.main on the base checkpoint (dense: the flash forward)
    and with --spt_ckpt (the four stages and the delta: the block-sparse
    forward), bf16, 4 batches of 8 x 512, 5 shots: ppl and accuracy equal
    tuning.evaluate on the same weights and batches, launches exact (one
    forward a layer a batch)."""
    from spt_proto_tpu_torch.cli import evaluate as eval_cli
    from spt_proto_tpu_torch.data.datamodule import mmlu_batches
    from spt_proto_tpu_torch.tuning import evaluate, surgery
    from spt_proto_tpu_torch.utils import checkpoint as ckpt_io
    argv = ['--device', DEV, '--ckpt', base, '--dtype', 'bfloat16',
            '--data_root', corpus, '--batch_size', str(B), '--max_batches',
            str(CLI_EVAL_BATCHES)]
    runs = {}
    base_cfg, base_params = ckpt_io.load_checkpoint(base, DEV)
    for name, flags, kernel in (
            ('dense', [], 'flash_attention'),
            ('spt', ['--spt_ckpt', delta], 'block_sparse_attention')):
        t0 = time.perf_counter()
        got, counts = cli_counts(lambda: eval_cli.main(
            argv + flags, tokenizer=char_tokenizer))
        dt = time.perf_counter() - t0
        cfg, params = base_cfg.replace(dtype=torch.bfloat16), base_params
        if flags:
            cfg, params = surgery.full_upgrade(cfg, params, 0)
            cfg_l, params = ckpt_io.load_delta_checkpoint(delta, params, DEV)
            cfg = cfg_l.replace(dtype=torch.bfloat16)
        cfg = cfg.replace(attn_impl='pallas')
        want = evaluate.evaluate(
            cfg, params, mmlu_batches(corpus, char_tokenizer, n_shots=5,
                                      seq_length=513, batch_size=B),
            max_batches=CLI_EVAL_BATCHES)
        want_counts = {n: CLI_EVAL_BATCHES * LAYERS if n == kernel else 0
                       for n in counts}
        require(got == want and counts == want_counts
                and got['n_examples'] == B * CLI_EVAL_BATCHES
                and np.isfinite(got['ppl']),
                f'cli evaluate {name}: {got} vs tuning.evaluate {want}; '
                f'launches {counts} (expected {want_counts})')
        log(f'  [cli evaluate {name}] {got} equals tuning.evaluate; '
            f'{dt:.2f} s with the checkpoint load; {kernel} '
            f'{counts[kernel]}')
        runs[f'cli evaluate {name}'] = dict(got, seconds=dt, launches=counts)
        del params
    del base_params
    torch.cuda.empty_cache()
    return runs


def phase_cli():
    """Phase 12: the port's command line and data path on the card, OPT-125M
    at full width (seeded random weights): checkpoints of the dense base
    and of its sparse (mha_v1 -> mha_v2) upgrade, bf16 compute, f32 params
    (the port's save_checkpoint); generate in four forms; bench_serving in
    all modes; a synthetic MMLU + FLAN-mini corpus; tune --data_root,
    dump_delta of its output, evaluate with and without the delta;
    model_info --serving and svd_rank --activations. No transformers: the
    tokenizer is char_tokenizer."""
    import tempfile
    from spt_proto_tpu_torch.cli import bench_serving as bs
    from spt_proto_tpu_torch.cli import dump_delta, model_info, svd_rank
    from spt_proto_tpu_torch.config import opt_config
    from spt_proto_tpu_torch.tuning import surgery
    from spt_proto_tpu_torch.utils import checkpoint as ckpt_io
    t0 = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        base, sparse = os.path.join(tmp, 'base'), os.path.join(tmp, 'sparse')
        cfg = opt_config('125m', dtype=torch.bfloat16, pq_metric='l2')
        params = surgery.init_params(cfg, SEED, DEV)
        ckpt_io.save_checkpoint(base, cfg, params)
        scfg, sp = surgery.upgrade(cfg, params, 'mha_v1', SEED + 1)
        scfg, sp = surgery.upgrade(scfg, sp, 'mha_v2', SEED + 2)
        # the serving checkpoint holds bf16 leaves (half the bytes to load)
        ckpt_io.save_checkpoint(sparse,
                                scfg.replace(param_dtype=torch.bfloat16),
                                cast_tree(sp, torch.bfloat16))
        del params, sp
        log(f'  checkpoints written in {time.perf_counter() - t0:.1f} s')
        prompts = torch.as_tensor(bs.random_prompts(cfg.vocab_size, CLI_B,
                                                    CLI_PROMPT))
        prompts[:, :CLI_SHARED] = prompts[0, :CLI_SHARED]
        runs.update(cli_generate(sparse, prompts))
        log(f'  ({time.perf_counter() - t0:.1f} s)')
        runs.update(cli_bench_serving())
        log(f'  ({time.perf_counter() - t0:.1f} s)')
        corpus = os.path.join(tmp, 'text')
        write_corpus(corpus, SEED + 31)
        tuned = os.path.join(tmp, 'tuned')
        runs['cli tune --data_root'] = tune_run = cli_tune(base, corpus,
                                                           tuned)
        t1 = time.perf_counter()
        dd = dump_delta.main(['--device', DEV, '--base', base, '--tuned',
                              tuned, '--out', os.path.join(tmp, 'dd')])
        require(dd['delta_params'] == tune_run['delta_params'],
                f'dump_delta: {dd} (tune wrote a delta of '
                f'{tune_run["delta_params"]})')
        log(f'  [cli dump_delta] {dd["delta_params"]} parameters, the tune '
            f'run\'s delta (every trainable leaf, nothing frozen moved), in '
            f'{time.perf_counter() - t1:.2f} s')
        runs.update(cli_evaluate(base, tuned + '-delta', corpus))
        log(f'  ({time.perf_counter() - t0:.1f} s)')
    info, info_counts = cli_counts(lambda: model_info.main(
        ['--device', DEV, '--config', 'opt-125m', '--tuning', 'sparse',
         '--serving']))
    card_gb = torch.cuda.get_device_properties(0).total_memory / 2**30
    require(info['hbm_gb'] == card_gb and info['trainable_params'] > 0
            and info['max_seqs_at_ctx_int8'] > info['max_seqs_at_ctx_bf16']
            > 0 and not any(info_counts.values()),
            f'cli model_info: {info}')
    log(f'  [cli model_info --serving] {info}')
    ranks, svd_counts = cli_counts(lambda: svd_rank.main(
        ['--device', DEV, '--config', 'opt-125m', '--activations']))
    want = {n: LAYERS if n == 'flash_attention' else 0 for n in svd_counts}
    require(len(ranks) == 5 and svd_counts == want
            and all(0 < r['rank@95%'] for r in ranks.values()),
            f'cli svd_rank: {ranks}, launches {svd_counts}')
    log(f'  [cli svd_rank --activations] ranks@90% '
        f'{ {k: r["rank@90%"] for k, r in ranks.items()} }; flash forwards '
        f'{svd_counts["flash_attention"]}')
    runs['cli svd_rank'] = dict(launches=svd_counts)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f'  phase 12: {seconds:.1f} s')
    return dict(runs=runs, model_info=info, svd_rank=ranks, seconds=seconds)


# ---------------------------------------------------------------------------

# (name, source, TPU kernel it replaces, others it also replaces, the
# phase-4 or phase-6 run whose launch counts the kernel line reports)
# ---------------------------------------------------------------------------
# phase 13: tensor- and data-parallel serving over torch.distributed
# ---------------------------------------------------------------------------
# A world of ranks shares the one card over gloo (NCCL needs a GPU a rank):
# each rank serves its shard, the parent process runs the same calls
# unsharded. The ms a step are those of ranks sharing one card: a parity
# run, not a speed of tensor-parallel serving.
MESH_B, MESH_PROMPT, MESH_NEW = 8, 512, 16
MESH_MAX_LEN = MESH_PROMPT + TILE
MESH_WORLDS = {'opt': (2, 2), 'llama': (1, 2)}
MESH_DEVICE = 'cuda:0'          # every rank's, given explicitly
# label -> (model, dtype, dense, int8 KV, weight quant); the sparse runs
# are also held stepwise (mesh_stepwise; the bf16 one reported)
MESH_GEN = {
    'opt': {'f32 sparse int8-KV': ('opt', torch.float32, False, True, None),
            'f32 dense f32-KV': ('opt', torch.float32, True, False, None),
            'bf16 sparse int8-KV': ('opt', torch.bfloat16, False, True,
                                    None),
            'bf16 dense bf16-KV': ('opt', torch.bfloat16, True, False,
                                   None)},
    'llama': {'f32 sparse int8-KV': ('llama', torch.float32, False, True,
                                     None),
              'w8 f32 sparse int8-KV': ('llama', torch.float32, False, True,
                                        'int8')}}
MESH_ENGINES = {   # label -> (dense, engine kwargs): phase 8's traffic
    'engine contiguous sparse int8-KV': (False, dict(quantized_kv=True)),
    # the chunked prefill (a slot's owner runs it, its last logits are
    # broadcast over 'data') and the prefix cache (spliced into the owner),
    # dense: a sparse chunk selects per row by integer PQ match counts, and
    # an f32 ulp of the row-parallel sums that flips one code moves a row
    # past the k-th count (its sharded tokens agreed 0.918 with one rank's
    # in f32 on the card; PERF.md §6)
    'engine contiguous dense f32-KV prefill_chunk 512 + prefix cache': (
        True, dict(prefill_chunk=512, prefix_cache=True)),
    'engine paged dense f32-KV': (True, dict(paged=True,
                                             page_size=PAGED_PS)),
    'engine speculative=4 sparse f32-KV': (False,
                                           dict(speculative=SPEC_K))}
MESH_ENGINE_NEW = 16
MESH_CLI = ['--config', 'opt-125m', '--dtype', 'float32',
            '--max_new_tokens', str(MESH_NEW)]


def mesh_model(model, dtype, dense, quant, max_len):
    """The runs' weights: OPT-125M at full width and depth, or Llama-3-8B
    width cut to 2 layers and a 32,000-token vocabulary; random, from
    SEED, made on the card (the same numbers in every process)."""
    from spt_proto_tpu_torch.inference.bridge import init_params
    from spt_proto_tpu_torch.inference.weights import InferenceWeights
    if model == 'opt':
        cfg = opt_cfg('125m', max_len, dtype)
    else:
        cfg = llama_cfg('3-8b', max_len, dtype, n_layers=2,
                        vocab_size=VOCAB_7B)
    params = init_params(cfg, SEED, device=DEV)
    if dense:
        cfg, params = cfg.replace(attention='dense'), dense_params(params)
    return InferenceWeights.from_params(cfg, params, quant=quant)


def mesh_counted(fn):
    """(fn()'s result, seconds, kernel launches, collective calls): the
    counters zeroed just before and read just after."""
    from spt_proto_tpu_torch.parallel import comm
    ws = wrappers()
    sync()
    for w in ws.values():
        w.launches = 0
    comm.CALLS.clear()
    t0 = time.perf_counter()
    out = fn()
    sync()
    dt = time.perf_counter() - t0
    return out, dt, {n: w.launches for n, w in ws.items()}, dict(comm.CALLS)


def mesh_cases(which, mesh=None):
    """Every run of one world, sharded on `mesh` or (None) on one rank:
    greedy generate() (B=8, prompt 512, 16 new tokens; after a warm-up,
    the seconds of a 1-token run, its prefill, give the ms a step of the
    16-token run,
    whose launches and collectives are counted); for OPT-125M the batching
    engine on phase 8's traffic cut to 16 tokens a request; for Llama-3-8B
    the w8 stepwise rule; and cli.generate under the mesh flags. Returns
    {label: numbers and tokens}."""
    from spt_proto_tpu_torch.inference import engine
    out = {}
    vocab = VOCAB if which == 'opt' else VOCAB_7B
    tokens = torch.randint(1, vocab, (MESH_B, MESH_PROMPT),
                           generator=gen(SEED + 13, 'cpu')).to(DEV)
    for label, (model, dtype, dense, kv8, quant) in MESH_GEN[which].items():
        t_case = time.perf_counter()
        full = mesh_model(model, dtype, dense, quant, MESH_MAX_LEN)
        iw = engine.mesh_weights(full, mesh) if mesh is not None else full

        def run(n):
            return engine.generate(iw, tokens, n, max_len=MESH_MAX_LEN,
                                   quantized_kv=kv8, mesh=mesh)
        run(1)                                   # warm-up
        _, t1, _, _ = mesh_counted(lambda: run(1))
        got, dt, launches, calls = mesh_counted(lambda: run(MESH_NEW))
        out[label] = dict(tokens=got[:, MESH_PROMPT:].cpu(), seconds=dt,
                          ms_step=(dt - t1) / (MESH_NEW - 1) * 1e3,
                          launches=launches, collectives=calls)
        if not dense and mesh is not None:
            out[label]['stepwise'] = mesh_stepwise(full, iw, tokens, mesh,
                                                   kv8)
        out[label]['case_seconds'] = time.perf_counter() - t_case
        del iw, full
    if which == 'opt':
        prompts = serve_traffic(VOCAB)[0]
        for label, (dense, kw) in MESH_ENGINES.items():
            t_case = time.perf_counter()
            iw = mesh_model('opt', torch.float32, dense, None, MAX_LEN)
            (done, steps, stats), dt, launches, calls = mesh_counted(
                lambda: mesh_serve(iw, prompts, mesh, kw))
            out[label] = dict(tokens=done, seconds=dt, launches=launches,
                              collectives=calls, ms_step=dt / steps * 1e3,
                              spec_stats=stats,
                              case_seconds=time.perf_counter() - t_case)
            del iw
    else:
        from spt_proto_tpu_torch.cli import generate as gen_cli
        argv = MESH_CLI + ['--device', str(mesh.device if mesh else DEV)]
        for row in tokens[:4, :128].tolist():
            argv += ['--prompt_ids', ','.join(map(str, row))]
        if mesh is not None:
            argv += ['--mesh_model', str(mesh.shape['model'])]
        t_case = time.perf_counter()
        got, dt, launches, calls = mesh_counted(lambda: gen_cli.main(argv))
        out['cli generate'] = dict(tokens=got, seconds=dt, launches=launches,
                                   collectives=calls,
                                   case_seconds=time.perf_counter() - t_case)
    torch.cuda.empty_cache()
    return out


def mesh_serve(iw, prompts, mesh, kw):
    """Phase 8's traffic (16 new tokens a request) through the batching
    engine: (completions in request order, engine steps, speculative
    stats)."""
    from spt_proto_tpu_torch.inference.batching import \
        ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(iw, n_slots=SERVE_SLOTS, max_len=MAX_LEN,
                                   prefill_bucket=SERVE_BUCKET, mesh=mesh,
                                   **kw)
    rids = [eng.submit(p, max_new_tokens=MESH_ENGINE_NEW) for p in prompts]
    steps = 0
    while eng.num_active or eng.queue_depth:
        eng.step()
        steps += 1
    done = {c.request_id: c.tokens for c in eng.completions}
    return [list(map(int, done[r])) for r in rids], steps, \
        dict(eng.spec_stats)


def mesh_margins(which, label, want, got):
    """Where a free-running f32 generate run parts from the single-rank
    one: the single-rank logits along its own tokens (prefill, then
    decode_step teacher-forced), and at each row's first differing step
    how far the sharded token's logit lies below the maximum, over |max
    logit|. Returns [(row, step, gap / |max|)]."""
    from spt_proto_tpu_torch.inference import engine
    model, dtype, dense, kv8, quant = MESH_GEN[which][label]
    iw = mesh_model(model, dtype, dense, quant, MESH_MAX_LEN)
    vocab = VOCAB if which == 'opt' else VOCAB_7B
    tokens = torch.randint(1, vocab, (MESH_B, MESH_PROMPT),
                           generator=gen(SEED + 13, 'cpu')).to(DEV)
    want_t = torch.as_tensor(want, dtype=torch.int32, device=DEV)
    cache = engine.new_cache(iw, MESH_B, MESH_MAX_LEN, quantized=kv8)
    lg, cache = engine.prefill(iw, tokens, cache)
    logits = [lg[:, -1].float()]
    for t in range(MESH_NEW - 1):
        lg, cache = engine.decode_step(iw, want_t[:, t], cache)
        logits.append(lg.float())
    out = []
    for r in range(MESH_B):
        diff = [t for t in range(MESH_NEW) if got[r][t] != want[r][t]]
        if diff:
            t = diff[0]
            row = logits[t][r]
            gap = (row.max() - row[got[r][t]]).item()
            out.append((r, t, gap / row.abs().max().item()))
    del iw
    torch.cuda.empty_cache()
    return out


class MeshFrontTap:
    """In mesh_stepwise: the unsharded reference's decode_front calls (all
    slots and kv heads) are recorded, layer by layer, and the sharded
    step's calls (the rank's slots `rows` and kv heads from h0) take the
    reference's key codes and tables of those slots and heads in place of
    their own, as phase 3's SelectionTap gives the card the twins' (the
    flips are counted)."""

    def __init__(self, full_kv, rows, h0, kv):
        self.full_kv, self.rows, self.h0, self.kv = full_kv, rows, h0, kv
        self.rec = collections.deque()
        self.stats = dict(fronts=0, key_codes=0, key_code_flips=0,
                          table_rows=0, table_row_flips=0)

    def __enter__(self):
        from spt_proto_tpu_torch.inference import engine
        self.engine, self.orig = engine, engine.decode_front
        engine.decode_front = self
        return self

    def __exit__(self, *exc):
        self.engine.decode_front = self.orig

    def __call__(self, *args, **kw):
        out = self.orig(*args, **kw)
        if args[7].shape[1] == self.full_kv \
                and args[7].shape[0] == MESH_B:          # the reference's
            self.rec.append(out)
            return out
        ref = self.rec.popleft()
        hs = slice(self.h0, self.h0 + self.kv)
        codes, tables = ref[3][self.rows][:, hs], ref[4][self.rows][:, hs]
        st = self.stats
        st['fronts'] += 1
        st['key_codes'] += codes.numel()
        st['key_code_flips'] += int((codes != out[3]).sum())
        st['table_rows'] += tables.shape[0] * tables.shape[1]
        st['table_row_flips'] += int((tables != out[4]).any(-1).sum())
        return tuple(out[:3]) + (codes.contiguous(), tables.contiguous()) \
            + tuple(out[5:])


def mesh_stepwise(full, iw, tokens, mesh, kv8):
    """Phase 3's stepwise rule for a sharded run: before each step the
    rank's shard takes the unsharded reference's cache (shard_cache: its
    slots and kv heads), its tokens and, through MeshFrontTap, its key
    codes and tables; the reference takes its step (decode_step: the
    logits) and the shard its greedy step. A sharded decision that is not
    the reference's argmax must lie within one bf16 step (2^-7 |max
    logit|) of its maximum: max_gap_over_tol <= 1 (phase_mesh holds it)."""
    from spt_proto_tpu_torch.inference import engine
    from spt_proto_tpu_torch.parallel.infer_sharding import (data_rows,
                                                             shard_cache)
    rows = data_rows(mesh, MESH_B)[0]
    ref = engine.new_cache(full, MESH_B, MESH_MAX_LEN, quantized=kv8)
    lg, ref = engine.prefill(full, tokens, ref)
    tok = torch.argmax(lg[:, -1], -1).to(torch.int32)
    s = iw.shard
    tap = MeshFrontTap(full.cfg.kv_heads, rows, mesh.coords['model']
                       * s.kv_heads if s.attn else 0, s.kv_heads)
    agree, worst = [], 0.0
    with tap:
        for _ in range(MESH_NEW - 1):
            card = shard_cache(mesh, ref, iw=iw)
            lg_all, ref = engine.decode_step(full, tok, ref)
            chosen, _ = engine.decode_step_greedy(iw, tok[rows].contiguous(),
                                                  card)
            tok = torch.argmax(lg_all, -1).to(torch.int32)
            lg = lg_all[rows].float()
            gap = lg.max(-1).values - lg.gather(
                1, chosen.long()[:, None])[:, 0]
            tol = 2.0 ** -7 * lg.abs().max(-1).values
            worst = max(worst, (gap / tol).max().item())
            agree.append((chosen == tok[rows]).float().mean().item())
    return dict(agreement=sum(agree) / len(agree), max_gap_over_tol=worst,
                selection=tap.stats)


def mesh_rank(rank, which):
    """A rank of phase 13's world `which` on the one card (gloo)."""
    from spt_proto_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*MESH_WORLDS[which], device=MESH_DEVICE)
    return dict(backend=mesh.backend, coords=mesh.coords,
                runs=mesh_cases(which, mesh))


def phase_mesh():
    """Phase 13: the sharded serving of parallel/ on ranks sharing the one
    card over gloo (the device and the backend passed explicitly; NCCL
    needs a GPU a rank). OPT-125M (full width and depth) on a world of 4
    at (data 2, model 2) and Llama-3-8B width (2 layers, vocabulary
    32,000) on a world of 2 at (1, 2), each beside the same calls
    unsharded in this process (mesh_cases). Every rank must return the
    same tokens and launch each kernel as often as the single-rank run;
    the free-running f32 runs of a world (generate, the engines, the CLI)
    must equal the single-rank runs for >= 0.995 of their tokens pooled
    (each run's share printed; where a row parts, the single rank's logit
    gap there is printed too); the sparse runs, and w8, are held by phase
    3's stepwise rule (mesh_stepwise; bf16 reported); bf16 free-running
    agreement is reported. Prints, a run, the world, the transport of each
    collective, the seconds and the ms a step."""
    from spt_proto_tpu_torch.parallel import comm, launch
    t_phase = time.perf_counter()
    out, failed = {}, []
    for which, (nd, nm) in MESH_WORLDS.items():
        pool = [0, 0]         # equal tokens, tokens of the pooled f32 runs
        t0 = time.perf_counter()
        world = launch.start(mesh_rank, nd * nm, (which,), backend='gloo',
                             device=MESH_DEVICE, timeout=600)
        ref = mesh_cases(which)
        t_ref = time.perf_counter() - t0
        ranks = world.join()
        wall = time.perf_counter() - t0
        backend = ranks[0]['backend']
        log(f'  world {which}: {nd * nm} ranks at (data {nd}, model {nm}) '
            f'on one card over {backend}, {wall:.1f} s with the spawn (the '
            f'single-rank runs here {t_ref:.1f} s beside them)')
        for label, want in ref.items():
            got = [r['runs'][label] for r in ranks]
            tok = [g['tokens'] for g in got]
            want_tok = want['tokens']
            if isinstance(want_tok, torch.Tensor):
                tok = [t.tolist() for t in tok]
                want_tok = want_tok.tolist()
            agree = min(agreement(t, want_tok) for t in tok)
            n_tok = sum(len(r_) for r_ in want_tok)
            same = all(t == tok[0] for t in tok)
            # the free-running f32 runs are pooled (w8 is held stepwise)
            pooled = 'bf16' not in label and not label.startswith('w8')
            gated = 'bf16' not in label
            if pooled:
                pool[0] += round(agree * n_tok)
                pool[1] += n_tok
            res = dict(world=[nd, nm], backend=backend, agreement=agree,
                       tokens=n_tok, gated=gated,
                       seconds=max(g['seconds'] for g in got),
                       single_rank_seconds=want['seconds'],
                       case_seconds=max(g['case_seconds'] for g in got),
                       launches={n: c for n, c in want['launches'].items()
                                 if c})
            ok = same and all(g['launches'] == want['launches']
                              for g in got)
            if gated and agree < 1.0 and label in MESH_GEN[which]:
                # where a free-running row parts from the single-rank run:
                # the single rank's logits there (teacher-forced), how far
                # below its maximum the sharded token lies
                res['first_divergences'] = mesh_margins(which, label,
                                                        want_tok, tok[0])
            if gated and 'stepwise' in got[0]:
                ok = ok and all(g['stepwise']['max_gap_over_tol'] <= 1.0
                                for g in got)
            calls = got[0]['collectives']
            ways = {op: comm.transport(backend, 'cuda', op) for op in calls}
            res.update(collectives=calls, transport=ways)
            msg = ''
            if 'ms_step' in want:
                res['ms_step_sharing_one_card'] = max(
                    g['ms_step'] for g in got)
                res['single_rank_ms_step'] = want['ms_step']
                kind = 'a step' if label in MESH_GEN[which] \
                    else 'an engine step'
                msg = (f'; {res["ms_step_sharing_one_card"]:.2f} ms {kind} '
                       f'with {nd * nm} ranks sharing one card (a parity '
                       f'run, not a speed of tensor-parallel serving; one '
                       f'rank {want["ms_step"]:.2f} ms)')
            if 'first_divergences' in res:
                msg += (f'; rows part at (row, step, gap / |max logit|) '
                        f'{res["first_divergences"]}')
            if 'stepwise' in got[0]:
                res['stepwise'] = [g['stepwise'] for g in got]
                sw = res['stepwise']
                msg += (f'; stepwise ({"gated" if gated else "reported"}): '
                        f'agreement '
                        f'{min(x["agreement"] for x in sw):.3f}, max gap '
                        f'{max(x["max_gap_over_tol"] for x in sw):.3g} x '
                        f'2^-7 |max logit|, key-code flips '
                        f'{sum(x["selection"]["key_code_flips"] for x in sw)}'
                        f', table-row flips '
                        f'{sum(x["selection"]["table_row_flips"] for x in sw)}')
            if 'spec_stats' in want:
                res['spec_stats'] = [want['spec_stats'], got[0]['spec_stats']]
            log(f'  [{which} {label}] tokens agree {agree:.4f} '
                f'({"pooled" if pooled else "reported"}), ranks equal '
                f'{same}; '
                f'launches equal the single rank\'s on every rank: '
                f'{all(g["launches"] == want["launches"] for g in got)}; '
                f'collectives {calls} '
                f'({", ".join(f"{k} {v}" for k, v in ways.items())}); '
                f'{res["seconds"]:.2f} s timed, {res["case_seconds"]:.1f} s '
                f'with its build (one rank {want["seconds"]:.2f} s){msg}')
            out[f'{which} {label}'] = res
            if not ok:
                failed.append(f'{which} {label}')
        share = pool[0] / pool[1]
        log(f'  [{which}] f32 free-running runs pooled: {pool[0]} of '
            f'{pool[1]} tokens equal the single-rank runs\' = {share:.4f} '
            f'(>= 0.995)')
        out[f'{which} f32 pooled agreement'] = dict(equal=pool[0],
                                                     tokens=pool[1],
                                                     share=share)
        if share < 0.995:
            failed.append(f'{which} f32 pooled agreement {share}')
    seconds = time.perf_counter() - t_phase
    log(f'  phase 13: {seconds:.1f} s')
    require(not failed, f'phase 13: {failed} (tokens, launches or ranks '
            f'unequal; the lines above)')
    return dict(runs=out, seconds=seconds,
                nccl='not run: NCCL needs a GPU a rank, the machine has one')


KERNELS = [
    ('decode_front', 'spt_proto_tpu_torch/csrc/decode_front.cu',
     'spt_proto_tpu/ops/pallas/decode_front.py:359', [], 'sparse int8-KV'),
    ('decode_attention_rows_q', 'spt_proto_tpu_torch/csrc/decode_attention.cu',
     'spt_proto_tpu/ops/pallas/decode_attention.py:1627',
     ['spt_proto_tpu/ops/pallas/decode_attention.py:1275'], 'sparse int8-KV'),
    ('lm_head_argmax', 'spt_proto_tpu_torch/csrc/lm_head.cu',
     'spt_proto_tpu/ops/pallas/lm_head.py:69', [], 'sparse int8-KV'),
    ('block_sparse_attention',
     'spt_proto_tpu_torch/csrc/block_sparse_attention.cu',
     'spt_proto_tpu/ops/pallas/block_sparse_attention.py:373',
     ['spt_proto_tpu/ops/pallas/block_sparse_attention.py:108',
      'spt_proto_tpu/ops/pallas/block_sparse_attention.py:241'],
     'sparse int8-KV'),
    ('decode_attention_rows', 'spt_proto_tpu_torch/csrc/decode_attention.cu',
     'spt_proto_tpu/ops/pallas/decode_attention.py:883',
     ['spt_proto_tpu/ops/pallas/decode_attention.py:571'], 'dense bf16-KV'),
    ('ffn_tail', 'spt_proto_tpu_torch/csrc/ffn_tail.cu',
     'spt_proto_tpu/ops/pallas/ffn_tail.py:99', [],
     'sparse int8-KV fused FFN tail'),
    ('int8_matmul', 'spt_proto_tpu_torch/csrc/int8_matmul.cu',
     'spt_proto_tpu/ops/pallas/int8_matmul.py:49', [], 'sparse int8-KV w8'),
    ('lm_head_argmax_int8', 'spt_proto_tpu_torch/csrc/lm_head.cu',
     'spt_proto_tpu/ops/pallas/lm_head.py:129', [], 'sparse int8-KV w8'),
    ('ffn_tail_int8', 'spt_proto_tpu_torch/csrc/ffn_tail.cu',
     'spt_proto_tpu/ops/pallas/ffn_tail.py:231', [], 'sparse int8-KV w8'),
    ('ffn_tail_gated', 'spt_proto_tpu_torch/csrc/ffn_tail.cu',
     'spt_proto_tpu/ops/pallas/ffn_tail.py:137', [],
     '3-8B sparse int8-KV fused FFN tail'),
    ('ffn_tail_gated_int8', 'spt_proto_tpu_torch/csrc/ffn_tail.cu',
     'spt_proto_tpu/ops/pallas/ffn_tail.py:278', [],
     '3-8B sparse int8-KV w8'),
    ('verify_attention_rows', 'spt_proto_tpu_torch/csrc/decode_attention.cu',
     'spt_proto_tpu/ops/pallas/decode_attention.py:2002', [],
     'spec 125M n-gram bf16-KV'),
    ('paged_attention', 'spt_proto_tpu_torch/csrc/paged_attention.cu',
     'spt_proto_tpu/inference/paged.py:209', [
         'spt_proto_tpu/inference/paged.py:198'], 'paged dense bf16-KV'),
    # the tile-pool kernel serves no engine path (as in the JAX package):
    # its launches in the serving run are 0
    ('decode_attention', 'spt_proto_tpu_torch/csrc/paged_attention.cu',
     'spt_proto_tpu/ops/pallas/decode_attention.py:156', [],
     'paged dense bf16-KV'),
    # phase 9: the training kernels, counted in the f32 tune run
    ('block_sparse_attention_lse',
     'spt_proto_tpu_torch/csrc/block_sparse_attention.cu',
     'spt_proto_tpu/ops/pallas/block_sparse_attention.py:102',
     ['spt_proto_tpu/ops/pallas/block_sparse_attention.py:108',
      'spt_proto_tpu/ops/pallas/block_sparse_attention.py:373'],
     'train 125M f32 B=8 S=512'),
    # the backward pair, counted in the bf16 run (the tensor-core kernels)
    ('block_sparse_attention_dq',
     'spt_proto_tpu_torch/csrc/block_sparse_attention.cu',
     'spt_proto_tpu/ops/pallas/block_sparse_attention.py:416',
     ['spt_proto_tpu/ops/pallas/block_sparse_attention.py:626'],
     'train 125M bf16 B=8 S=512'),
    ('block_sparse_attention_dkv',
     'spt_proto_tpu_torch/csrc/block_sparse_attention.cu',
     'spt_proto_tpu/ops/pallas/block_sparse_attention.py:463',
     ['spt_proto_tpu/ops/pallas/block_sparse_attention.py:672'],
     'train 125M bf16 B=8 S=512'),
    # phase 10: the int8_base and grouped-matmul training kernels
    ('int8_matmul_t', 'spt_proto_tpu_torch/csrc/int8_matmul.cu',
     'spt_proto_tpu/ops/pallas/int8_matmul.py:134',
     ['spt_proto_tpu/ops/pallas/int8_matmul.py:182'],
     'train llama-7b int8_base bf16 B=4 S=512'),
    ('gmm', 'spt_proto_tpu_torch/csrc/gmm.cu',
     'jax/experimental/pallas/ops/tpu/megablox/gmm.py:314',
     ['spt_proto_tpu/ops/routed_ffn.py:176'],
     'train 125M gmm bf16 B=8 S=512'),
    ('tgmm', 'spt_proto_tpu_torch/csrc/gmm.cu',
     'jax/experimental/pallas/ops/tpu/megablox/gmm.py:573',
     ['jax/experimental/pallas/ops/tpu/megablox/ops.py:90'],
     'train 125M gmm bf16 B=8 S=512'),
    # phase 11: the stock flash-attention kernel (dense causal attention
    # under attn_impl='pallas', spt_proto_tpu/layers/attention.py:75)
    ('flash_attention', 'spt_proto_tpu_torch/csrc/flash_attention.cu',
     'jax/experimental/pallas/ops/tpu/flash_attention.py:758',
     ['spt_proto_tpu/layers/attention.py:75',
      'jax/experimental/pallas/ops/tpu/flash_attention.py:331'],
     'train 125M dense stages bf16 B=8 S=512'),
    ('flash_attention_dq', 'spt_proto_tpu_torch/csrc/flash_attention.cu',
     'jax/experimental/pallas/ops/tpu/flash_attention.py:1456',
     ['jax/experimental/pallas/ops/tpu/flash_attention.py:1146'],
     'train 125M dense stages bf16 B=8 S=512'),
    ('flash_attention_dkv', 'spt_proto_tpu_torch/csrc/flash_attention.cu',
     'jax/experimental/pallas/ops/tpu/flash_attention.py:1121',
     ['jax/experimental/pallas/ops/tpu/flash_attention.py:796'],
     'train 125M dense stages bf16 B=8 S=512'),
]
OFF_MAIN_PATH = ('decode_attention',)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from spt_proto_tpu_torch import _build
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32 here
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f'torch {torch.__version__} cuda {torch.version.cuda}; '
        f'{torch.cuda.get_device_name(0)}')

    log('phase 1: build')
    # registers and spills of the tensor-core kernels (the bf16 flash
    # forward and backward, int8_matmul_t, the bf16 heads, gmm / tgmm, and
    # the int8_matmul and FFN-tail kernels, which must not spill), compiled
    # once more with -Xptxas -v beside the build
    ptxas = [(start_ptxas(src), pattern, no_spills)
             for src, pattern, no_spills in PTXAS_KERNELS]
    # two more processes build at the same time (the ranks of a world on a
    # fresh checkout): one compiles under the build's file lock, the others
    # wait for it and load its library
    build_procs = [subprocess.Popen(
        [sys.executable, '-c', 'from spt_proto_tpu_torch import _build; '
         'print(_build.build())'], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    try:
        log(f'  kernels built and loaded in {_build.build_timed():.1f} s')
        lib_path = str(_build.build())
        for proc in build_procs:
            out = proc.communicate(timeout=900)[0]
            require(proc.returncode == 0 and lib_path in out,
                    f'a concurrent build failed: {out[-2000:]}')
        log(f'  two more processes built at once: the same library, '
            f'{lib_path.split("/_build/")[-1]}')
    finally:
        for proc in build_procs:
            if proc.poll() is None:
                proc.kill()
        for proc, pattern, no_spills in ptxas:
            log_ptxas(proc, pattern, no_spills)

    log('phase 2: kernels vs plain twins')
    res = phase_kernels(Timer())
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 3: f32 slice parity, card kernels vs CPU twins')
    parity = phase_parity()
    parity_llama = phase_parity_llama()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 4: bf16 serving runs, OPT-125M B=8 prompt 2048')
    serving = phase_serving()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 5: OPT-1.3B rung, B=8 prompt 2048')
    big = phase_1p3b()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 6: bf16 LLaMA serving runs, prompt 2048, 16 layers')
    llama = phase_llama()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 7: bf16 speculative serving, B=8 prompt 2048, k=4')
    spec = phase_speculative()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 8: the serving stack, OPT-125M, 16 requests over 8 slots')
    stack = phase_serving_stack()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 9: SPT fine-tuning, f32 parity and OPT-125M tune runs')
    training = phase_training()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 10: int8-base and grouped-matmul training')
    int8_gmm = phase_int8_gmm()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 11: dense and LoRA-stage training and forward (flash '
        'attention), evaluate, profile')
    t11 = time.perf_counter()
    dense = phase_dense()
    log(f'  ({time.perf_counter() - t_start:.0f} s; phase 11 '
        f'{time.perf_counter() - t11:.0f} s)')

    log('phase 12: command line and data (generate, bench_serving, tune '
        '--data_root, dump_delta, evaluate, model_info, svd_rank)')
    cli = phase_cli()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    log('phase 13: tensor- and data-parallel serving, ranks sharing the '
        'card over gloo')
    mesh = phase_mesh()
    log(f'  ({time.perf_counter() - t_start:.0f} s)')

    all_runs = {**serving['runs'], **llama['runs'], **spec['runs'],
                **stack['runs'], **training['runs'], **int8_gmm['runs'],
                **dense['runs'], **cli['runs']}
    rows = []
    for name, src, replaces, also, run in KERNELS:
        r = res[name]
        sv = all_runs[run]
        rows.append(dict(
            name=name, route='cuda', source=src, replaces=replaces,
            also_replaces=also, launches=sv['launches'][name],
            launches_run=run, on_main_path=name not in OFF_MAIN_PATH,
            launches_per_step=sv['launches_per_step'][name],
            launches_per_prefill=sv['launches_per_prefill'][name],
            launches_by_run={k: s['launches'][name]
                             for k, s in all_runs.items()},
            max_abs_err=r['max_abs_err'], ms=r['ms'], plain_ms=r['plain_ms'],
            bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            library_ms=r['library_ms'],
            **{k: v for k, v in r.items() if isinstance(v, dict)
               or k in ('unfused_ms', 'sdpa_causal_ms', 'library')}))

    for row in rows:
        require(row['launches'] > 0 or not row['on_main_path'],
                f'{row["name"]} was not launched in {row["launches_run"]}')

    def brief(run):
        return {k: v for k, v in run.items() if not k.startswith('launches')}
    log(json.dumps(dict(
        device=smi, parity=parity, parity_llama=parity_llama,
        serving=dict(serving, runs={k: brief(r)
                                    for k, r in serving['runs'].items()}),
        opt_1p3b=dict(big, runs={k: brief(r) for k, r in big['runs'].items()}),
        llama=dict(runs={k: brief(r) for k, r in llama['runs'].items()}),
        speculative=dict(runs={k: brief(r) for k, r in spec['runs'].items()}),
        serving_stack=dict(stack, runs={k: brief(r) for k, r
                                        in stack['runs'].items()}),
        training=dict(training, runs={k: brief(r) for k, r
                                      in training['runs'].items()}),
        int8_gmm_training=dict(int8_gmm, runs={k: brief(r) for k, r
                                               in int8_gmm['runs'].items()}),
        dense_training=dict(dense, runs={k: brief(r) for k, r
                                         in dense['runs'].items()},
                            profiles={k: brief(r) for k, r
                                      in dense['profiles'].items()}),
        command_line=dict(cli, runs={k: brief(r) for k, r
                                     in cli['runs'].items()}),
        mesh=mesh,
        seconds=time.perf_counter() - t_start)))
    log(json.dumps({'kernels': rows}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
