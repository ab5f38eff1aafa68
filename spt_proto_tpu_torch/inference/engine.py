"""Inference engine: prefill + single-token decode with a tile-major KV
cache (port of spt_proto_tpu/inference/engine.py, serving path).

This port serves OPT and LLaMA (MHA and GQA: RMSNorm, RoPE, the gated
FFN) with fp or int8 weight-only ("w8") weights and greedy decoding in
every decode mode the JAX package's bench.py measures: dense attention, and
PQ-sparse attention (sparse_v2, l1 or l2 metric) through the fused front or
the unfused front, each over a bf16/f32 KV cache or an int8 one, optionally
with the fused FFN tail (fp or int8, plain or gated). GQA keeps kv_heads in
the cache and pools each kv head's tile selection over its query group.
Per decode layer the step launches the tile attention kernel with in-place
append (ops/decode_attention.py: `decode_attention_rows` over a bf16/f32
cache, `decode_attention_rows_q` over an int8 one), after the fused front
kernel (ops/decode_front.py) when the config takes it (l2 metric, per-head
selection), and the fused FFN tail
(ops/ffn_tail.py) when the config asks for it or, by default, for int8
weights; per step one fused lm_head argmax (ops/lm_head.py). With int8
weights every other projection (prefill's, the unfused front's QKV, the
o-projection, the unfused FFN, prefill's lm_head) is one int8_matmul
launch (ops/int8_matmul.py). Sparse prefill runs the block-sparse attention
kernel (ops/block_sparse_attention.py) once per layer. Everything else,
dense prefill and the unfused front among it, is plain PyTorch that
mirrors the JAX engine op for op, as the JAX package leaves it to XLA.

Speculative decoding's block verify, `verify_step`, runs K tokens a slot
through one forward: per layer one launch of the block-verify kernel
(ops/decode_attention.py `verify_attention_rows`) over a bf16/f32 cache, or
plain PyTorch attention over an int8 one (the JAX package has no kernel
there either). `generate` decodes greedily through decode_step_greedy or
samples through decode_step + `sample`, with ragged prompt lengths, an eos
id, an int8 KV cache and bucketed cache growth; inference/speculative.py
drafts and verifies on top of these.

`prefill_chunk` (with its halves `prefill_chunk_past` and
`prefill_chunk_compute`) prefills one slot's prompt a chunk at a time over
the context already cached, in plain PyTorch as the JAX engine writes it in
jnp; the continuous-batching engine (inference/batching.py) splits long
prompts and extends cached prefixes with it.

A routed FFN (a checkpoint the SPT tuning made) runs the training layer's
forms (layers/feedforward.py) on fp block views, w8 included (the int8
builds keep a routed FFN's kernels fp, as JAX's do): the mask dispatch, or
with ffn_impl='gmm' the grouped-matmul kernels (ops/gmm.py) once a call
has at least 128 rows, as in the JAX engine, so a long prefill runs gmm and
a decode step of a few slots the masked form; 'gather' serves masked, as
the JAX engine does. Out of this port so far, and raising
NotImplementedError with the slice that brings it: ffn_impl='ep' (expert
parallelism) and tp_overlap under a mesh (the overlap slice).

Tensor parallelism (generate(mesh=...), the batching engine's mesh): each
rank runs these functions on its shard (iw.shard, parallel/
infer_sharding.py) with plain local tensors, reading its own widths
(`heads`, shard.d_ff, shard.vocab) and calling the collectives of
parallel/comm.py at the seams: the embedding's rows summed over 'model',
the o-projection's and the FFN's row-parallel products summed over 'model'
with the replicated bias (and a fused tail's residual and bias) added
once, and the head's vocabulary shards gathered (logits) or its (value,
index) pairs gathered for the global first maximum (greedy). The kernels
run unchanged at the shard's shapes.

Unlike the JAX engine, which returns new caches, prefill and decode update
the cache tensors in place and return a KVCache over the same tensors.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch

from spt_proto_tpu_torch.config import (ATTN_SPARSE_V2, FFN_ROUTED,
                                        ModelConfig)
from spt_proto_tpu_torch.inference.bridge import PE_OFFSET, resolve_device
from spt_proto_tpu_torch.inference.weights import InferenceWeights
from spt_proto_tpu_torch.layers.common import rope_cos_sin, rotate_half
from spt_proto_tpu_torch.layers.transformer import make_ffn
from spt_proto_tpu_torch.ops import pq as pq_ops
from spt_proto_tpu_torch.ops.block_sparse import pq_tile_scores, select_tiles
from spt_proto_tpu_torch.ops.block_sparse_attention import \
    block_sparse_attention
from spt_proto_tpu_torch.ops.decode_attention import (decode_attention_rows,
                                                      decode_attention_rows_q,
                                                      split_entries,
                                                      split_writer,
                                                      verify_attention_rows)
from spt_proto_tpu_torch.ops.decode_front import decode_front
from spt_proto_tpu_torch.ops.ffn_tail import (MAX_ROWS, ffn_tail,
                                              ffn_tail_gated,
                                              ffn_tail_gated_int8,
                                              ffn_tail_int8, int8_tile)
from spt_proto_tpu_torch.ops.int8_matmul import int8_matmul
from spt_proto_tpu_torch.ops.lm_head import (lm_head_argmax,
                                             lm_head_argmax_int8)
from spt_proto_tpu_torch.ops.lookup import pq_match_scores, pq_topk_indices
from spt_proto_tpu_torch.ops.sparse_attention import sparse_attention

NEG_INF = -1e30
TILE = 128   # tokens per cache tile


@dataclasses.dataclass
class KVCache:
    """Layer-folded tile-major KV cache (the JAX engine's layout).

    k/v [B, KV, L*NT, D, TILE] (int8 when quantized), codes
    [B, KV, L*NT, w, TILE] int32, length [B] int32, and in int8 mode
    per-token scales k_scale/v_scale [B, L*NT, KV_pad, TILE] f32 (KV_pad =
    kv heads rounded up to 8). Tiles of layer l sit at [l*NT, (l+1)*NT)."""
    k: torch.Tensor
    v: torch.Tensor
    codes: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def create(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, quantized: bool = False,
               device='cuda', kv_heads: Optional[int] = None) -> 'KVCache':
        """kv_heads: the heads a rank holds under a mesh (default all)."""
        dev = resolve_device(device)
        l, h, d = cfg.n_layers, kv_heads or cfg.kv_heads, cfg.d_head
        n_sub = code_width(cfg)
        nt = -(-max_len // TILE)
        kv_dtype = torch.int8 if quantized else dtype
        scales = dict()
        if quantized:
            hp = -(-h // 8) * 8
            scales = dict(
                k_scale=torch.zeros((batch, l * nt, hp, TILE),
                                    dtype=torch.float32, device=dev),
                v_scale=torch.zeros((batch, l * nt, hp, TILE),
                                    dtype=torch.float32, device=dev))
        return KVCache(
            k=torch.zeros((batch, h, l * nt, d, TILE), dtype=kv_dtype,
                          device=dev),
            v=torch.zeros((batch, h, l * nt, d, TILE), dtype=kv_dtype,
                          device=dev),
            codes=torch.zeros((batch, h, l * nt, n_sub, TILE),
                              dtype=torch.int32, device=dev),
            length=torch.zeros((batch,), dtype=torch.int32, device=dev),
            **scales)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def tiles_per_layer(self, n_layers: int) -> int:
        return self.k.shape[2] // n_layers


# ---------------------------------------------------------------------------
# primitive helpers (mirror the JAX engine's math)
# ---------------------------------------------------------------------------

def code_width(cfg: ModelConfig) -> int:
    """Stored width of the PQ-code columns: 1 when dense; n_subspaces when
    <= 8; else rounded up to a multiple of 8."""
    if cfg.attention != ATTN_SPARSE_V2:
        return 1
    n = cfg.n_subspaces
    return n if n <= 8 else -(-n // 8) * 8


def _fit_codes(codes: torch.Tensor, w: int) -> torch.Tensor:
    """Pad (with -2: never matches a real code) or slice the code dim."""
    n = codes.shape[-1]
    if n == w:
        return codes
    if n > w:
        return codes[..., :w]
    return torch.nn.functional.pad(codes, (0, w - n), value=-2)


def _qkv_proj(mha: dict, x: torch.Tensor):
    """q/k/v projections of x [B, S, D]: one einsum over the fused
    [3, D, D] stack that InferenceWeights builds for MHA, or one int8_matmul
    over the packed int8 [D, 3D] kernel (columns [q|k|v]); three
    projections (fp or int8) for GQA's separate q / k / v."""
    if 'qkv' not in mha:
        return _dense(mha['q'], x), _dense(mha['k'], x), _dense(mha['v'], x)
    w = mha['qkv']
    kern = w['kernel']
    if isinstance(kern, dict):
        d3 = kern['scale'].shape[-1]
        y = int8_matmul(x, kern['q'], kern['scale'])[..., :d3]
        y = y.reshape(*x.shape[:-1], 3, d3 // 3).movedim(-2, 0)
    else:
        y = torch.einsum('bsd,tdo->tbso', x, kern)
    if 'bias' in w:
        y = y + w['bias'][:, None, None, :]
    return y[0], y[1], y[2]


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    kern = p['kernel']
    if isinstance(kern, dict):       # int8: q is N-padded, scale true-width
        y = int8_matmul(x, kern['q'], kern['scale'])[
            ..., :kern['scale'].shape[-1]]
    else:
        y = x @ kern
    if 'bias' in p:
        y = y + p['bias']
    return y


def _layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics, affine in the serving dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y.to(x.dtype) * p['scale'] + p['bias']).to(x.dtype)


def _rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 statistics, scale in the serving dtype (LLaMA)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (p['scale'] * y.to(x.dtype)).to(x.dtype)


def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return _rmsnorm(p, x) if cfg.arch == 'llama' else _layernorm(p, x)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in f32: x [B, H, T, D], cos/sin [B, 1, T, D] f32
    (the JAX engine's _apply_rope_1 with its tables computed once)."""
    xf = x.float()
    return (cos * xf + sin * rotate_half(xf)).to(x.dtype)


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin [B, 1, T, d_head] f32 at positions [B, T]."""
    cos, sin = rope_cos_sin(positions.reshape(-1), cfg.d_head,
                            base=cfg.rope_base)
    shape = (*positions.shape, cfg.d_head)
    return cos.reshape(shape)[:, None], sin.reshape(shape)[:, None]


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor,
         shard=None) -> torch.Tensor:
    """Dense FFN: ReLU (OPT) or gated SiLU, down(silu(gate x) * side x)
    (LLaMA), in the serving dtype; a routed FFN runs the training layer's
    forms, masked or (ffn_impl='gmm', >= 128 rows) grouped-matmul (routed +
    LoRA keeps its factors: the 2 * prob coeff scales only the frozen
    path). Under a mesh that splits d_ff (shard.ffn) fc1 / gate / side are
    a rank's columns and fc2 / down its rows, summed over 'model'."""
    split = shard is not None and shard.ffn
    if cfg.ffn == FFN_ROUTED:
        if cfg.ffn_impl == 'gather':      # the JAX engine serves it masked
            cfg = cfg.replace(ffn_impl='masked')
        return make_ffn(cfg, deterministic=True)(p, x)
    lead = x.shape[:-1]
    xf = x.reshape(-1, cfg.d_model)
    if cfg.ffn_gated:
        y = _row(p['down'], torch.nn.functional.silu(_dense(p['gate'], xf))
                 * _dense(p['side'], xf), shard, split)
    else:
        y = _row(p['fc2'], torch.relu(_dense(p['fc1'], xf)), shard, split)
    return y.reshape(*lead, cfg.d_model)


def _ffn_residual(cfg: ModelConfig, p: dict, pn: dict,
                  x: torch.Tensor, shard=None) -> torch.Tensor:
    """x + ffn(norm2(x)); through the fused tail kernel when the config
    asks for it (decode_fused_ffn=True; None means "for int8 weights only",
    as in the JAX engine) and the shape is eligible: <= 256 rows, d_model
    and d_ff multiples of 128, and for int8 weights a d_ff tile of >= 128
    dividing d_ff (the rank's d_ff under a mesh). A split tail (shard.ffn)
    gives each rank's partial product: the residual and fc2's bias go in on
    the first model rank only (zeros on the others), and the ranks' outputs
    are summed over 'model'."""
    xn = _norm(cfg, pn, x)
    if cfg.ffn == FFN_ROUTED:             # the fused tails are dense only
        return x + _ffn(cfg, p, xn, shard)
    split = shard is not None and shard.ffn
    d_ff = shard.d_ff if shard is not None else cfg.d_feedforward
    rows = x.numel() // cfg.d_model
    names = ('gate', 'side', 'down') if cfg.ffn_gated else ('fc1', 'fc2')
    quant = [isinstance(p[n]['kernel'], dict) for n in names]
    use_fused = cfg.decode_fused_ffn
    if use_fused is None:
        use_fused = all(quant)
    eligible = (use_fused and rows <= MAX_ROWS and cfg.d_model % 128 == 0
                and d_ff % 128 == 0 and (all(quant) or not any(quant)))
    if eligible and all(quant):
        eligible = int8_tile(d_ff) >= 128
    if not eligible:
        return x + _ffn(cfg, p, xn, shard)
    res = x.reshape(rows, cfg.d_model)
    first = not split or shard.model_rank == 0
    if not first:
        res = torch.zeros_like(res)
    xs = (xn.reshape(rows, cfg.d_model), res)
    if cfg.ffn_gated:
        tail = ffn_tail_gated_int8 if all(quant) else ffn_tail_gated
        y = tail(*xs, *(p[n]['kernel'] for n in names))
    else:
        tail = ffn_tail_int8 if all(quant) else ffn_tail
        b2 = p['fc2']['bias']
        y = tail(*xs, p['fc1']['kernel'], p['fc1']['bias'],
                 p['fc2']['kernel'], b2 if first else torch.zeros_like(b2))
    if split:
        from spt_proto_tpu_torch.parallel import comm
        y = comm.sum_(shard.mesh, y)
    return y.reshape(x.shape)


def _encode_codes(cfg: ModelConfig, quantizer: dict, x: torch.Tensor,
                  bd: Optional[dict] = None) -> torch.Tensor:
    """x [..., D] -> PQ codes [..., n_sub]; with the block-diagonal encode
    matrices the l2 encode is one [., d_head] @ [d_head, ns*nc] dot, the
    same shape the decode-front kernel computes."""
    if bd is not None and cfg.pq_metric == 'l2':
        ns = cfg.n_subspaces
        nc = bd['bd'].shape[-1] // ns
        dots = x.float() @ bd['bd']
        score = (bd['cbn'] - 2.0 * dots).reshape(*x.shape[:-1], ns, nc)
        return torch.argmin(score, dim=-1).to(torch.int32)
    return pq_ops.pq_encode(x, quantizer['codebook'], cfg.pq_metric)


def _bd_of(mha: dict) -> Optional[dict]:
    if 'quantizer_bd' in mha:
        return {'bd': mha['quantizer_bd'], 'cbn': mha['quantizer_cbn']}
    return None


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token int8: x [..., D] -> (int8 [..., D], scale [...])."""
    xf = x.float()
    s = xf.abs().amax(-1).clamp(min=1e-8) / 127.0
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# tensor parallelism: a rank's widths and the collectives at the layer seams
# (iw.shard is None for the whole model on one device, parallel/
# infer_sharding.py otherwise)
# ---------------------------------------------------------------------------

def heads(iw: InferenceWeights) -> Tuple[int, int, int, int]:
    """(query heads, kv heads, group size, d_head) of the weights a rank
    holds."""
    cfg, s = iw.cfg, iw.shard
    h, kv = (cfg.n_heads, cfg.kv_heads) if s is None else (s.n_heads,
                                                            s.kv_heads)
    return h, kv, cfg.kv_groups, cfg.d_head


def new_cache(iw: InferenceWeights, batch: int, max_len: int, *,
              quantized: bool = False, device=None) -> KVCache:
    """An empty cache for `batch` slots at the rank's kv heads, on the
    weights' device unless `device` is given."""
    return KVCache.create(iw.cfg, batch, max_len, dtype=iw.cfg.dtype,
                          quantized=quantized,
                          device=device or weights_device(iw),
                          kv_heads=heads(iw)[1])


def _embed(iw: InferenceWeights, tokens: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    """Token embeddings (+ OPT's learned positions) in the serving dtype.
    Vocab-parallel under a mesh: each rank looks up the ids in its rows
    (zeros for the others) and the ranks' rows are summed over 'model'."""
    p, s = iw.params, iw.shard
    emb = p['embedding']['embedding']
    tok = tokens.long()
    if s is not None and s.head:
        from spt_proto_tpu_torch.parallel import comm
        local = tok - s.vocab_lo
        inside = (local >= 0) & (local < s.vocab)
        h_tok = torch.where(inside[..., None],
                            emb[local.clamp(0, s.vocab - 1)], 0)
        h_tok = comm.sum_(s.mesh, h_tok)
    else:
        h_tok = emb[tok]
    if iw.cfg.arch == 'opt':
        h_tok = h_tok + p['learned_pe']['embedding'][pos + PE_OFFSET]
    return h_tok.to(iw.cfg.dtype)


def _row(p: dict, x: torch.Tensor, shard, split: bool) -> torch.Tensor:
    """A row-parallel dense (o, fc2 / down): under a mesh that splits its
    input dim, the ranks' partial products summed over 'model', the bias
    added once after the sum; else _dense."""
    if shard is None or not split:
        return _dense(p, x)
    from spt_proto_tpu_torch.parallel import comm
    y = comm.sum_(shard.mesh, _dense({'kernel': p['kernel']}, x))
    return y + p['bias'] if 'bias' in p else y


def _o_proj(iw: InferenceWeights, p: dict, o: torch.Tensor) -> torch.Tensor:
    return _row(p, o, iw.shard, iw.shard is not None and iw.shard.attn)


def _lm_logits(iw: InferenceWeights, x: torch.Tensor) -> torch.Tensor:
    """Full-vocabulary logits: a vocab-parallel head gathers its ranks'
    columns over 'model'."""
    y = _dense(iw.params['lm_head'], x)
    s = iw.shard
    if s is not None and s.head:
        from spt_proto_tpu_torch.parallel import comm
        y = comm.gather(s.mesh, y, 'model', dim=-1)
    return y


def first_max(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """vals, ids [R, B] (each rank's chosen logit and its GLOBAL id) -> ids
    [B] int32 of the largest value, the lowest id on ties: the unsharded
    argmax's first-maximum rule."""
    best = vals.max(0, keepdim=True).values
    cand = torch.where(vals == best, ids.to(torch.int64),
                       torch.iinfo(torch.int64).max)
    return cand.min(0).values.to(torch.int32)


def _greedy_head(iw: InferenceWeights, x: torch.Tensor) -> torch.Tensor:
    """The fused lm_head argmax; vocab-parallel under a mesh: each rank's
    kernel gives (its first maximum, the logit it compared), the pairs are
    gathered over 'model' and the global first maximum taken."""
    kern = iw.params['lm_head']['kernel']
    head = lm_head_argmax_int8 if isinstance(kern, dict) else lm_head_argmax
    s = iw.shard
    if s is None or not s.head:
        return head(x, kern)
    from spt_proto_tpu_torch.parallel import comm
    ids, val = head(x, kern, value=True)
    # one gather of both: the f32 values' bits beside the int32 ids
    pairs = comm.gather(s.mesh, torch.stack(
        [val.view(torch.int32), ids + s.vocab_lo])[None], 'model', dim=0)
    return first_max(pairs[:, 0].view(torch.float32), pairs[:, 1])


def _require_slice(iw: InferenceWeights, cache: KVCache) -> None:
    cfg = iw.cfg
    if cache.k.device.type == 'cuda' and cfg.attn_impl != 'pallas':
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r}: on the GPU the port attends only "
            f"through its kernels (attn_impl='pallas'); the plain twins run "
            f"on CPU tensors")


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(iw: InferenceWeights, tokens: torch.Tensor,
            cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Teacher-forced pass over prompts; fills the cache (in place) and
    returns the full-sequence logits. tokens [B, S] (left-aligned)."""
    _require_slice(iw, cache)
    cfg = iw.cfg
    p = iw.params
    b, s = tokens.shape
    dev = tokens.device
    tokens = tokens.long()
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    x = _embed(iw, tokens, pos)
    h, kv, g, dh = heads(iw)
    nt = cache.tiles_per_layer(cfg.n_layers)
    nt_m = -(-s // TILE)
    scale = dh ** -0.5
    sparse = cfg.attention == ATTN_SPARSE_V2
    rope = _rope_tables(cfg, pos) if cfg.arch == 'llama' else None

    def to_tiles(x_std):            # [B, KV, S, w] -> [B, KV, NTm, w, T]
        xp = torch.nn.functional.pad(x_std, (0, 0, 0, nt_m * TILE - s))
        return xp.reshape(b, kv, nt_m, TILE, -1).transpose(3, 4)

    def sc_tiles(x_std):            # [B, KV, S] -> [B, NTm, KV, T]
        xp = torch.nn.functional.pad(x_std, (0, nt_m * TILE - s))
        return xp.reshape(b, kv, nt_m, TILE).transpose(1, 2)

    for li in range(cfg.n_layers):
        bp = _layer(p['blocks'], li)
        q, k, v = _qkv_proj(bp['mha'], _norm(cfg, bp['norm1'], x))
        q = q.reshape(b, s, h, dh).transpose(1, 2)          # [B, H, S, dh]
        k, v = (t.reshape(b, s, kv, dh).transpose(1, 2)     # [B, KV, S, dh]
                for t in (k, v))
        if rope is not None:
            q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        # the cache keeps kv_heads; attention repeats them per query group
        k_kv, v_kv = k, v
        if g > 1:
            k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
        if sparse:
            o, codes_k = _sparse_prefill_attention(cfg, bp['mha'], q, k, v,
                                                   scale)
            if g > 1:
                codes_k = _encode_codes(cfg, bp['mha']['quantizer'], k_kv,
                                        bd=_bd_of(bp['mha']))
        else:
            # causal f32 scores; the softmax rounds to the serving dtype
            # before the PV product (the JAX engine's dense branch)
            scores = (q.float() @ k.float().transpose(-1, -2)) * scale
            causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
            scores = torch.where(causal, scores, NEG_INF)
            o = torch.softmax(scores, dim=-1).to(q.dtype) @ v
            codes_k = torch.zeros((b, kv, s, 1), dtype=torch.int32,
                                  device=dev)
        o = o.reshape(b, h, s, dh).transpose(1, 2).reshape(b, s, h * dh)
        x = x + _o_proj(iw, bp['mha']['o'], o)
        x = x + _ffn(cfg, bp['ffn'], _norm(cfg, bp['norm2'], x), iw.shard)

        # write this layer's tiles (from the unrepeated k/v) into the cache,
        # in place
        t0, t1 = li * nt, li * nt + nt_m
        cache.codes[:, :, t0:t1] = to_tiles(_fit_codes(
            codes_k.reshape(b, kv, s, -1), cache.codes.shape[3]))
        if cache.quantized:
            k_kv, ksc = _quantize_kv(k_kv)
            v_kv, vsc = _quantize_kv(v_kv)
            cache.k_scale[:, t0:t1, :kv] = sc_tiles(ksc)
            cache.v_scale[:, t0:t1, :kv] = sc_tiles(vsc)
        cache.k[:, :, t0:t1] = to_tiles(k_kv).to(cache.k.dtype)
        cache.v[:, :, t0:t1] = to_tiles(v_kv).to(cache.v.dtype)
    cache = dataclasses.replace(cache, length=torch.full_like(cache.length, s))
    return _lm_logits(iw, _norm(cfg, p['final_norm'], x)), cache


def _sparse_prefill_attention(cfg: ModelConfig, mha: dict, q, k, v,
                              scale: float):
    """PQ-sparse prefill attention of one layer: q/k/v [B, H, S, dh] ->
    (o [B*H, S, dh], key codes [B*H, S, n_sub])."""
    bh, s, dh = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    # the kernel takes contiguous tensors; for one slot (the batching
    # engine's prefill) the reshape of the transposed q/k/v is a strided
    # view
    qz, kz, vz = (t.reshape(bh, s, dh).contiguous() for t in (q, k, v))
    bd_m = _bd_of(mha)
    codes_q = _encode_codes(cfg, mha['quantizer'], qz, bd=bd_m)
    codes_k = _encode_codes(cfg, mha['quantizer'], kz, bd=bd_m)
    blk_k = 128
    blk_q = 256 if s % 256 == 0 else 128
    if s % blk_q == 0 and s >= 2 * blk_k:
        ratio = blk_q // blk_k
        n_sel = max(ratio, (s // blk_k) // cfg.sparse_coeff)
        ts = pq_tile_scores(codes_q, codes_k, n_codewords=cfg.n_codewords,
                            block_q=blk_q, block_k=blk_k)
        sel = select_tiles(ts, n_sel, block_ratio=ratio)
        o = block_sparse_attention(qz, kz, vz, sel, block_q=blk_q,
                                   block_k=blk_k, scale=scale,
                                   clamp=cfg.score_clamp)
    else:
        if s > 1024:
            warnings.warn(
                f'sparse prefill at S={s} (not a tile multiple) falls back '
                f'to the O(S^2) per-row oracle — pad prompts to a multiple '
                f'of {blk_q}', stacklevel=3)
        idx = pq_topk_indices(codes_q, codes_k,
                              top_k=max(1, s // cfg.sparse_coeff),
                              n_codewords=cfg.n_codewords)
        o = sparse_attention(qz, kz, vz, idx, scale=scale,
                             clamp=cfg.score_clamp)
    return o, codes_k


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def prefill_chunk_past(iw: InferenceWeights, cache: KVCache, slot: int,
                       offset: int):
    """A slot's cached context [0, offset) for chunked prefill, read back
    once: token-major K/V [L, 1, KV, offset, D] (an int8 cache dequantized
    to the serving dtype here) and codes [L, 1, KV, offset, w]."""
    cfg = iw.cfg
    l, kv = cfg.n_layers, heads(iw)[1]
    nt = cache.tiles_per_layer(l)
    t0s = max(offset // TILE, 1)

    def slot_past(big):             # [B, KV, L*NT, w, T] -> token-major
        w = big.shape[3]
        row = big[slot].reshape(kv, l, nt, w, TILE)[:, :, :t0s]
        tok = row.permute(1, 0, 2, 4, 3).reshape(l, 1, kv, t0s * TILE, w)
        return tok[:, :, :, :offset]

    if cache.quantized:
        def slot_past_sc(big):      # [B, L*NT, hp, T] -> [L, 1, KV, offset]
            hp = big.shape[2]
            row = big[slot].reshape(l, nt, hp, TILE)[:, :t0s]
            tok = row.permute(0, 2, 1, 3).reshape(l, 1, hp, t0s * TILE)
            return tok[:, :, :kv, :offset]

        past_k = (slot_past(cache.k).float()
                  * slot_past_sc(cache.k_scale)[..., None]).to(cfg.dtype)
        past_v = (slot_past(cache.v).float()
                  * slot_past_sc(cache.v_scale)[..., None]).to(cfg.dtype)
    else:
        past_k, past_v = slot_past(cache.k), slot_past(cache.v)
    return past_k, past_v, slot_past(cache.codes)


def prefill_chunk(iw: InferenceWeights, tokens: torch.Tensor, cache: KVCache,
                  slot: int, offset: int) -> Tuple[torch.Tensor, KVCache]:
    """Chunked prefill: tokens [1, C] of one batch slot at positions
    [offset, offset + C), attending over the slot's cached context [0,
    offset) plus causal self-attention within the chunk. Appends the chunk's
    K/V (+PQ codes) to the slot's cache tiles in place, sets the slot's
    length to offset + C, and returns the chunk logits [1, C, V]. C and
    offset are multiples of TILE.

    Dense configs equal one-shot prefill() up to summation order. Sparse
    configs select per row over [past + chunk] with top_k = (offset + C) //
    sparse_coeff (pq_match_scores), the per-row selection contract of the
    JAX engine's chunked prefill; the tile pattern may differ from one-shot
    prefill's block-sparse kernel."""
    past = prefill_chunk_past(iw, cache, slot, offset)
    return prefill_chunk_compute(iw, tokens, cache, past, slot, offset)


def prefill_chunk_compute(iw: InferenceWeights, tokens: torch.Tensor,
                          cache: KVCache, past, slot: int,
                          offset: int) -> Tuple[torch.Tensor, KVCache]:
    """The compute/write half of prefill_chunk, given the past that
    prefill_chunk_past read."""
    _require_slice(iw, cache)
    cfg = iw.cfg
    p = iw.params
    b, c = tokens.shape
    if b != 1:
        raise ValueError('prefill_chunk serves one slot at a time')
    if c % TILE or offset % TILE:
        raise ValueError(f'chunk ({c}) and offset ({offset}) must be '
                         f'multiples of {TILE}')
    dev = tokens.device
    l, nt = cfg.n_layers, cache.tiles_per_layer(cfg.n_layers)
    nt_c, t0 = c // TILE, offset // TILE
    h, kv, g, dh = heads(iw)
    pos = offset + torch.arange(c, device=dev)[None]           # [1, C]
    x = _embed(iw, tokens, pos)
    sparse = cfg.attention == ATTN_SPARSE_V2
    scale = dh ** -0.5
    s_tot = offset + c
    k_sel = max(1, s_tot // cfg.sparse_coeff) if sparse else 0
    past_k, past_v, past_c = past
    rope = _rope_tables(cfg, pos) if cfg.arch == 'llama' else None
    causal = (torch.arange(s_tot, device=dev)[None, :]
              <= offset + torch.arange(c, device=dev)[:, None])  # [C, S]

    def write(big, chunk, base):    # chunk [KV, C, w] -> tiles, in place
        tiles = chunk.reshape(kv, nt_c, TILE, -1).transpose(2, 3)
        big[slot, :, base:base + nt_c] = tiles.to(big.dtype)

    for li in range(l):
        bp = _layer(p['blocks'], li)
        mha = bp['mha']
        q, k, v = _qkv_proj(mha, _norm(cfg, bp['norm1'], x))
        q = q.reshape(b, c, h, dh).transpose(1, 2)              # [1, H, C, D]
        k_new, v_new = (t.reshape(b, c, kv, dh).transpose(1, 2)
                        for t in (k, v))                      # [1, KV, C, D]
        if rope is not None:
            q, k_new = _apply_rope(q, *rope), _apply_rope(k_new, *rope)
        k_all = torch.cat([past_k[li].to(k_new.dtype), k_new], dim=2)
        v_all = torch.cat([past_v[li].to(v_new.dtype), v_new], dim=2)
        if g > 1:
            k_all, v_all = (t.repeat_interleave(g, dim=1)
                            for t in (k_all, v_all))
        scores = (q.float() @ k_all.float().transpose(-1, -2)) * scale
        if sparse:
            bd_m = _bd_of(mha)
            codes_q = _encode_codes(cfg, mha['quantizer'],
                                    q.reshape(h, c, dh), bd=bd_m)
            c_new = _encode_codes(cfg, mha['quantizer'],
                                  k_new.reshape(kv, c, dh), bd=bd_m)
            # past codes arrive at the stored width (maybe padded): match
            # over the true subspaces only
            codes_k = torch.cat([past_c[li][0][..., :cfg.n_subspaces],
                                 c_new], dim=1).repeat_interleave(g, dim=0)
            match = pq_match_scores(codes_q, codes_k, cfg.n_codewords)
            match = torch.where(causal[None], match, -1.0)   # [H, C, S]
            kth = torch.sort(match, dim=-1).values[..., -k_sel][..., None]
            keep = causal[None] & (match >= kth.clamp(min=0.0))
            scores = scores.clamp(-cfg.score_clamp, cfg.score_clamp)
            scores = torch.where(keep[None], scores, NEG_INF)
        else:
            c_new = torch.zeros((kv, c, cache.codes.shape[3]),
                                dtype=torch.int32, device=dev)
            scores = torch.where(causal[None, None], scores, NEG_INF)
        scores = scores - scores.amax(-1, keepdim=True)
        o = torch.softmax(scores, dim=-1).to(q.dtype) @ v_all
        o = o.transpose(1, 2).reshape(b, c, h * dh)
        x = x + _o_proj(iw, mha['o'], o)
        x = _ffn_residual(cfg, bp['ffn'], bp['norm2'], x, iw.shard)

        # append the chunk's tiles in place at [offset, offset + C)
        base = li * nt + t0
        if cache.quantized:
            k_w, ksc_w = _quantize_kv(k_new[0])    # [KV, C, D] + [KV, C]
            v_w, vsc_w = _quantize_kv(v_new[0])
            for big, sc in ((cache.k_scale, ksc_w), (cache.v_scale, vsc_w)):
                big[slot, base:base + nt_c, :kv] = sc.reshape(
                    kv, nt_c, TILE).transpose(0, 1)
        else:
            k_w, v_w = k_new[0], v_new[0]
        write(cache.k, k_w, base)
        write(cache.v, v_w, base)
        write(cache.codes, _fit_codes(c_new, cache.codes.shape[3]), base)
    cache.length[slot] = s_tot
    logits = _lm_logits(iw, _norm(cfg, p['final_norm'], x))
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(iw: InferenceWeights, tokens: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One token per active slot -> (logits [B, V], cache)."""
    x, cache = _decode_hidden(iw, tokens, cache)
    return _lm_logits(iw, x), cache


def _uses_fused_front(cfg: ModelConfig, mha: dict) -> bool:
    """The JAX engine's envelope of the fused decode front: sparse_v2, l2
    metric, per-head selection, d_model a multiple of 128, and q/k/v in one
    of its weight forms (the fused 'qkv' or GQA's separate 'q'/'k'/'v')."""
    return (cfg.attention == ATTN_SPARSE_V2 and cfg.decode_fused_front
            and cfg.sparse_select_heads == 1 and cfg.pq_metric == 'l2'
            and cfg.d_model % 128 == 0 and 'quantizer_bd' in mha
            and ('qkv' in mha or 'q' in mha))


def _front_weights(mha: dict):
    """(weights, bias) of the decode front: the fused 'qkv' kernel (stack
    or packed int8) with its [3, D] bias, or the GQA triple (fp tensors or
    int8 dicts) with its biases zero-padded to one ragged [3, max width]
    stack (None when bias-free)."""
    if 'qkv' in mha:
        return mha['qkv']['kernel'], mha['qkv'].get('bias')
    w = tuple(mha[n]['kernel'] for n in ('q', 'k', 'v'))
    if 'bias' not in mha['q']:
        return w, None
    bs = [mha[n]['bias'] for n in ('q', 'k', 'v')]
    wmax = max(t.shape[-1] for t in bs)
    return w, torch.stack([torch.nn.functional.pad(t, (0, wmax - t.shape[-1]))
                           for t in bs])


def _sparse_tables(cfg: ModelConfig, mha: dict, q4, k_new, codes, base: int,
                   nt: int, nsel: int, cur):
    """The unfused sparse front's selection: the new key's codes
    [B, KV, w] and the layer-relative tables [B, KV / sparse_select_heads,
    nsel] (-1 = empty): the top nsel-1 FULL tiles by mean PQ match (pooled
    over the group's heads and query rows), in lax.top_k order, then the
    current tile."""
    b, kv, g, dh = q4.shape
    bd_m = _bd_of(mha)
    codes_q = _encode_codes(cfg, mha['quantizer'], q4.reshape(b, kv * g, dh),
                            bd=bd_m).reshape(b, kv, g, -1)
    c_new = _fit_codes(_encode_codes(cfg, mha['quantizer'], k_new, bd=bd_m),
                       codes.shape[3])
    # match over the TRUE subspaces only (the stored width may be padded)
    c_l = codes[:, :, base:base + nt, :cfg.n_subspaces]    # [B,KV,NT,ns,T]
    match = (c_l[:, :, None] == codes_q[:, :, :, None, :, None]
             ).float().sum(4)                              # [B,KV,G,NT,T]
    tscore = match.mean(dim=(2, 4))                        # [B, KV, NT]
    gsel = cfg.sparse_select_heads
    if gsel > 1:
        tscore = tscore.reshape(b, kv // gsel, gsel, nt).mean(2)
    full = torch.arange(nt, device=q4.device)[None, :] < cur[:, None]
    tscore = torch.where(full[:, None, :], tscore, float('-inf'))
    # lax.top_k order: descending, the lowest index first on ties
    svals, sidx = torch.sort(tscore, dim=-1, descending=True, stable=True)
    svals, sidx = svals[..., :nsel - 1], sidx[..., :nsel - 1]
    rel = torch.where(svals > float('-inf'), sidx, -1)
    cur_col = cur[:, None, None].expand(b, rel.shape[1], 1)
    return c_new, torch.cat([rel, cur_col], dim=-1)


def _decode_hidden(iw: InferenceWeights, tokens: torch.Tensor,
                   cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One token per active slot: per layer the front (fused kernel, or
    plain QKV + PQ selection, or dense tables), then the tile attention
    kernel for the cache's dtype. tokens [B]; positions come from
    cache.length. Returns (final-normed hidden [B, D], cache)."""
    _require_slice(iw, cache)
    cfg = iw.cfg
    p = iw.params
    b = tokens.shape[0]
    nt = cache.tiles_per_layer(cfg.n_layers)
    pos = cache.length
    dev = pos.device
    x = _embed(iw, tokens, pos.long())[:, None]             # [B, 1, D]
    _, kv, g, dh = heads(iw)
    scale = dh ** -0.5
    cur = (pos // TILE).long()                              # [B]
    sparse = cfg.attention == ATTN_SPARSE_V2
    if sparse:
        nsel = min(nt, max(1, nt // cfg.sparse_coeff) + 1)
        n_tiles = torch.full((b,), nsel, dtype=torch.int32, device=dev)
        tps, clamp = 1, cfg.score_clamp
    else:
        # dense tables cover [0, cur] in tps-wide supertiles: ONE row for
        # all heads, entries e * tps for e <= cur // tps, -1 past them
        tps = 4 if nt % 4 == 0 and nt >= 8 else 1
        e = torch.arange(-(-nt // tps), device=dev)
        n_sup = cur // tps + 1
        dense_rel = torch.where(e[None] < n_sup[:, None], e * tps,
                                -1)[:, None]                # [B, 1, n_sup]
        n_tiles = n_sup.to(torch.int32)
        clamp = 0.0
    use_front = _uses_fused_front(cfg, p['blocks']['mha'])
    llama = cfg.arch == 'llama'
    if llama:
        # RoPE tables at each slot's position, once a step for every layer
        cos_b, sin_b = rope_cos_sin(pos, dh, base=cfg.rope_base)
    for li in range(cfg.n_layers):
        bp = _layer(p['blocks'], li)
        mha = bp['mha']
        base = li * nt
        kv_quant = None
        if use_front:
            w_in, b_in = _front_weights(mha)
            rope = (cos_b, sin_b) if llama else ()
            out = decode_front(
                x[:, 0], bp['norm1']['scale'], bp['norm1'].get('bias'), w_in,
                b_in, mha['quantizer_bd'], mha['quantizer_cbn'], cache.codes,
                pos, base, *rope, nt=nt, nsel=nsel, n_sub=cfg.n_subspaces,
                ps=TILE, eps=1e-6 if llama else 1e-5, arch=cfg.arch,
                quantized=cache.quantized)
            q, k_new, v_new, c_new, tables = out[:5]
            kv_quant = out[5:]
        else:
            q, k_new, v_new = _qkv_proj(mha, _norm(cfg, bp['norm1'], x))
            if llama:
                rope = (cos_b[:, None, None], sin_b[:, None, None])
                q = _apply_rope(q.reshape(b, kv * g, 1, dh),
                                *rope).reshape(b, 1, kv * g * dh)
                k_new = _apply_rope(k_new.reshape(b, kv, 1, dh),
                                    *rope).reshape(b, 1, kv * dh)
            if sparse:
                c_new, rel = _sparse_tables(
                    cfg, mha, q.reshape(b, kv, g, dh),
                    k_new.reshape(b, kv, dh), cache.codes, base, nt, nsel,
                    cur)
            else:
                c_new = torch.zeros((b, kv, cache.codes.shape[3]),
                                    dtype=torch.int32, device=dev)
                rel = dense_rel
            tables = torch.where(rel < 0, -1, rel + base).to(torch.int32)
        # the kernels take contiguous tensors; _qkv_proj's einsum may
        # return strided views
        q4 = q.reshape(b, kv, g, dh).contiguous()
        k_new = k_new.reshape(b, kv, dh).contiguous()
        v_new = v_new.reshape(b, kv, dh).contiguous()
        base_t = torch.full((b,), base, dtype=torch.int32, device=dev)
        if li == 0:
            # the bf16 split walks' appending chunk (split_writer), once a
            # step: every layer's tables hold the write tile at the same
            # entry (dense: the same relative table; sparse: the last entry,
            # behind full tiles), so the first layer's serves them all
            writer = (split_writer(
                tables, n_tiles, pos, base_t, ps=TILE, tps=tps,
                e=split_entries(cache.quantized, b * kv,
                                tables.shape[2] * tps))
                if q4.is_cuda and q4.dtype == torch.bfloat16 else None)
        kw = dict(ps=TILE, tps=tps, scale=scale, clamp=clamp, writer=writer)
        if cache.quantized:
            if kv_quant:
                k8, v8, ks_new, vs_new = kv_quant
            else:
                k8, ks_new = _quantize_kv(k_new)
                v8, vs_new = _quantize_kv(v_new)
            o = decode_attention_rows_q(
                q4, cache.k, cache.v, cache.codes, cache.k_scale,
                cache.v_scale, tables, n_tiles, pos, k8.reshape(b, kv, dh),
                v8.reshape(b, kv, dh), c_new, ks_new, vs_new, base_t,
                **kw)[0]
        else:
            o = decode_attention_rows(
                q4, cache.k, cache.v, cache.codes, tables, n_tiles, pos,
                k_new, v_new, c_new, base_t, **kw)[0]
        x = x + _o_proj(iw, mha['o'], o.reshape(b, 1, kv * g * dh))
        x = _ffn_residual(cfg, bp['ffn'], bp['norm2'], x, iw.shard)
    cache = dataclasses.replace(cache, length=cache.length + 1)
    return _norm(cfg, p['final_norm'], x)[:, 0], cache


def decode_step_greedy(iw: InferenceWeights, tokens: torch.Tensor,
                       cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """decode_step with the lm_head matmul and the argmax fused into one
    kernel: returns (next_token [B] int32, cache), token-identical to
    argmax(decode_step(...)[0])."""
    if not iw.cfg.decode_fused_head and cache.k.device.type == 'cuda':
        raise NotImplementedError(
            'decode_fused_head=False: on the GPU the port takes the greedy '
            'token only through its fused lm_head kernel')
    x, cache = _decode_hidden(iw, tokens, cache)
    return _greedy_head(iw, x), cache


# ---------------------------------------------------------------------------
# block verify (speculative decoding)
# ---------------------------------------------------------------------------

def _insert_cols(sl: torch.Tensor, new: torch.Tensor, blk: '_Block'
                 ) -> None:
    """In place: sl [B, KV, NT, w, T] (a layer's slice of a cache), new
    [B, KV, K, w]; column i of slot b lands at its position pos0[b] + i,
    and a column past the slice is dropped, as the JAX engine's scatter
    drops it (_Block.write_at; no host sync)."""
    vals = new.transpose(1, 2).to(sl.dtype)                 # [B, K, KV, w]
    old = sl[blk.slot[:, 0], :, -1, :, -1]                  # [B, KV, w]
    sl[blk.slot, :, blk.tile_w, :, blk.col_w] = blk.write_vals(vals, old)


class _Block:
    """The index tensors of a verify block (K columns a slot at positions
    pos0 + [0, K), over NT tiles a layer), made once a step and shared by
    every layer."""

    def __init__(self, pos0: torch.Tensor, kk: int, nt: int, kv: int,
                 nsel: int):
        dev = pos0.device
        b = pos0.shape[0]
        self.kk, self.nt, self.kv, self.nsel = kk, nt, kv, nsel
        self.wpos = pos0.long()[:, None] + torch.arange(kk, device=dev)
        self.tile_r, self.col_r = self.wpos // TILE, self.wpos % TILE
        self.slot = torch.arange(b, device=dev)[:, None].expand(b, kk)
        self.write_at(nt)
        ar = torch.arange(nt, device=dev)
        self.own = ar == self.tile_r[..., None]             # [B, K, NT]
        self.not_full = ar >= self.tile_r[..., None]        # [B, K, NT]
        w0, w1 = self.tile_r[:, 0], self.tile_r[:, -1]      # the write tiles
        self.wcols = torch.stack([w0, w1], -1)[:, None].expand(b, kv, 2)
        self.not_w = ~(self.own[:, 0] | self.own[:, -1])[:, None]  # [B,1,NT]
        self.dup = (w0 == w1)[:, None]                      # [B, 1]
        self.jbit = 1 << torch.arange(kk, device=dev, dtype=torch.int32)
        self._dense = None

    def write_at(self, nt: int) -> None:
        """Where the block's columns are written in a layer of nt tiles:
        a column past the layer (a lane whose length sits within K of the
        cache's end) is dropped. Without a host sync: a dropped column is
        sent to the block's first column with that column's value when the
        first lands, else to the slot's last lane with the value already
        there, so that every write to one place carries one value."""
        inside = self.tile_r < nt                            # [B, K]
        self.keep, self.keep0 = inside, inside[:, :1]
        self.tile_w = torch.where(inside, self.tile_r, torch.where(
            self.keep0, self.tile_r[:, :1], nt - 1))
        self.col_w = torch.where(inside, self.col_r, torch.where(
            self.keep0, self.col_r[:, :1], TILE - 1))

    def write_vals(self, vals: torch.Tensor, old: torch.Tensor
                   ) -> torch.Tensor:
        """vals [B, K, ...] the columns' values, old [B, ...] the value at
        the slot's last lane -> the values to write at (tile_w, col_w)."""
        pad = (None,) * (vals.dim() - 2)
        fill = torch.where(self.keep0[:, 0][(...,) + pad], vals[:, 0], old)
        return torch.where(self.keep[(...,) + pad], vals, fill[:, None])

    def select(self, cfg: ModelConfig, c_l: torch.Tensor,
               codes_q: torch.Tensor) -> torch.Tensor:
        """Each block position's decode tile selection over the layer's
        codes c_l [B, KV, NT, w, T] (the block's new codes already in
        them): keep [B, N_TAB, K, NT] bool, the position's own tile and
        the top nsel-1 FULL tiles (below its own) by group-pooled mean PQ
        match, in lax.top_k order (descending, the lowest index first on
        ties), as decode_step selects for that position. codes_q [B, KV,
        G, K, n_sub]. The match counts come from each tile's code
        histogram: sum over the group, the lanes and the subspaces of
        [code == query code], an integer, then / (G * T), the f32 mean of
        integer-valued terms that JAX takes in any order."""
        b, kv, g, kk, ns = codes_q.shape
        nt, nc = self.nt, cfg.n_codewords
        codes = c_l[:, :, :, :ns].long()                    # [B,KV,NT,ns,T]
        hist = torch.zeros((b, kv, nt, ns, nc), dtype=torch.int32,
                           device=c_l.device)
        hist.scatter_add_(-1, codes, torch.ones_like(codes, dtype=torch.int32))
        cnt = hist[:, :, None, None].expand(b, kv, g, kk, nt, ns, nc).gather(
            -1, codes_q.long()[:, :, :, :, None, :, None].expand(
                b, kv, g, kk, nt, ns, 1))
        tsc = cnt.sum((2, 5, 6)).float() / (g * TILE)       # [B, KV, K, NT]
        gsel = cfg.sparse_select_heads
        if gsel > 1:
            tsc = tsc.reshape(b, kv // gsel, gsel, kk, nt).mean(2)
        tsc = tsc.masked_fill(self.not_full[:, None], float('-inf'))
        keep = torch.zeros(tsc.shape, dtype=torch.bool, device=c_l.device)
        if self.nsel > 1:
            svals, sidx = torch.sort(tsc, dim=-1, descending=True,
                                     stable=True)
            keep.scatter_(-1, sidx[..., :self.nsel - 1],
                          svals[..., :self.nsel - 1] > float('-inf'))
        return keep | self.own[:, None]

    def tables(self, keep: Optional[torch.Tensor], base: int):
        """The block-verify kernel's per-head table and visibility bits for
        the layer whose tiles start at `base`: the union of every
        position's full selected tiles (t_sel = min(nt, (nsel-1) K) entries
        in lax.top_k order, -1 when empty), or every tile below the first
        write tile when keep is None (dense), then the two write tiles;
        bit j of an entry's mask is set where block position j selected it
        (dense: all K bits). The first write entry's bits are zeroed when
        it repeats the second. Returns (tables [B, KV, T] int32 physical
        ids, bits [B, KV, T] int32)."""
        if keep is None:
            if self._dense is None:        # the same for every layer
                ar = torch.arange(self.nt, device=self.wpos.device)
                ent = torch.where(ar < self.tile_r[:, :1], ar, -1)
                ent = ent[:, None].expand(-1, self.kv, -1)
                bits = torch.full(ent.shape, (1 << self.kk) - 1,
                                  dtype=torch.int32, device=ent.device)
                self._dense = self._entries(ent, bits)
            ent, ebits = self._dense
        else:
            if keep.shape[1] != self.kv:
                keep = keep.repeat_interleave(self.kv // keep.shape[1], dim=1)
            bits = (keep * self.jbit[:, None]).sum(2, dtype=torch.int32)
            union = keep.any(2) & self.not_w                # [B, KV, NT]
            t_sel = min(self.nt, (self.nsel - 1) * self.kk)
            vals, idx = torch.sort(union.to(torch.uint8), dim=-1,
                                   descending=True, stable=True)
            ent, ebits = self._entries(
                torch.where(vals[..., :t_sel] > 0, idx[..., :t_sel], -1), bits)
        return torch.where(ent >= 0, ent + base, -1).to(torch.int32), ebits

    def _entries(self, ent: torch.Tensor, bits: torch.Tensor):
        """ent [B, KV, T-2] the table's other entries (-1 = empty), bits
        [B, KV, NT] each tile's visibility bits: the whole table, the write
        tiles appended, and each entry's bits."""
        ent = torch.cat([ent, self.wcols], dim=-1)
        ebits = torch.where(ent >= 0, bits.gather(-1, ent.clamp(min=0)), 0)
        ebits[..., -2].masked_fill_(self.dup, 0)
        return ent, ebits


def verify_step(iw: InferenceWeights, tokens: torch.Tensor, cache: KVCache,
                impl: Optional[str] = None) -> Tuple[torch.Tensor, KVCache]:
    """Speculative-decoding block verify: K tokens a slot in one forward.
    tokens [B, K] at positions cache.length[b] + [0, K); returns (logits
    [B, K, V], cache with the K columns appended, in place, and length +=
    K). The caller rolls back by lowering cache.length: rejected columns
    stay in the tiles, every attention path masks by position, and the
    next append overwrites them.

    Attention mirrors decode_step exactly for each block position j: dense
    is causal over positions <= pos + j; sparse attends each kv head's
    decode selection for position j (group-pooled PQ match means over FULL
    tiles, < (pos + j) // TILE, the top nsel-1 in lax.top_k order, plus its
    own tile), scores clamped to +-score_clamp before masking. The new
    codes / k / v are inserted up front: a later column i > j lands in a
    tile >= j's own tile, which the full-tile cutoff and the position mask
    hide from j.

    impl (None = by cache): 'kernel', the default for a bf16/f32 cache,
    launches the block-verify kernel (ops/decode_attention.py
    verify_attention_rows) once a layer over the union of every position's
    tiles, with a per-entry K-bit visibility mask, appending the K columns
    in place; 'jnp', the default and the only path for an int8 cache (the
    JAX package has no kernel for it either), computes the same attention
    in plain PyTorch over the layer's cache slice. On the GPU a bf16/f32
    cache verifies only through the kernel."""
    _require_slice(iw, cache)
    quantized = cache.quantized
    impl = impl or ('jnp' if quantized else 'kernel')
    if impl not in ('kernel', 'jnp'):
        raise ValueError(f"impl must be 'kernel' or 'jnp', got {impl!r}")
    use_kernel = impl == 'kernel'
    if use_kernel and quantized:
        raise ValueError('the int8 cache verifies via impl=jnp')
    if not use_kernel and not quantized and cache.k.device.type == 'cuda':
        raise NotImplementedError(
            "impl='jnp' over a bf16/f32 cache would run plain PyTorch "
            "attention on the GPU: there the port verifies through its "
            "kernel (impl='kernel'); the plain twins run on CPU tensors")
    cfg = iw.cfg
    p = iw.params
    b, kk = tokens.shape
    nt = cache.tiles_per_layer(cfg.n_layers)
    _, kv, g, dh = heads(iw)
    pos0 = cache.length
    dev = pos0.device
    sparse = cfg.attention == ATTN_SPARSE_V2
    nsel = min(nt, max(1, nt // cfg.sparse_coeff) + 1) if sparse else 0
    blk = _Block(pos0, kk, nt, kv, nsel)
    x = _embed(iw, tokens, blk.wpos)                         # [B, K, D]
    scale = dh ** -0.5
    rope = _rope_tables(cfg, blk.wpos) if cfg.arch == 'llama' else None
    if use_kernel:
        # each layer's first tile, and the dense caches' one code column
        bases = (torch.arange(cfg.n_layers, device=dev, dtype=torch.int32)
                 * nt)[:, None].expand(-1, b).contiguous()
        cn_dense = torch.zeros((b, kv, cache.codes.shape[3], kk),
                               dtype=torch.int32, device=dev)
    for li in range(cfg.n_layers):
        bp = _layer(p['blocks'], li)
        mha = bp['mha']
        base = li * nt
        q3, k3, v3 = _qkv_proj(mha, _norm(cfg, bp['norm1'], x))
        q = q3.reshape(b, kk, kv * g, dh).transpose(1, 2)    # [B, H, K, D]
        k_new = k3.reshape(b, kk, kv, dh).transpose(1, 2)   # [B, KV, K, D]
        v_new = v3.reshape(b, kk, kv, dh).transpose(1, 2)
        if rope is not None:
            q, k_new = _apply_rope(q, *rope), _apply_rope(k_new, *rope)
        keep = None
        if sparse:
            bd_m = _bd_of(mha)
            codes_q = _encode_codes(cfg, mha['quantizer'],
                                    q.reshape(b, kv, g, kk, dh), bd=bd_m)
            c_new = _fit_codes(_encode_codes(cfg, mha['quantizer'], k_new,
                                             bd=bd_m), cache.codes.shape[3])
            # the block's codes go in first (on the kernel path the kernel
            # then writes the same values): a position past a tile
            # boundary selects over the tile the block's earlier columns
            # filled
            c_l = cache.codes[:, :, base:base + nt]          # a view
            _insert_cols(c_l, c_new, blk)
            keep = blk.select(cfg, c_l, codes_q)
        if use_kernel:
            tables, bits = blk.tables(keep, base)
            cn = c_new.transpose(2, 3) if sparse else cn_dense
            o = verify_attention_rows(
                q.reshape(b, kv, g * kk, dh).contiguous(), cache.k, cache.v,
                cache.codes, tables, bits, pos0,
                k_new.transpose(2, 3).to(cache.k.dtype).contiguous(),
                v_new.transpose(2, 3).to(cache.v.dtype).contiguous(),
                cn.to(torch.int32).contiguous(), bases[li], ps=TILE,
                scale=scale, clamp=cfg.score_clamp if sparse else 0.0)[0]
            o = o.reshape(b, kv, g, kk, dh).permute(0, 3, 1, 2, 4).reshape(
                b, kk, kv * g * dh)
        else:
            o = _verify_plain(cfg, cache, base, blk, q, k_new, v_new, keep,
                              scale)
        x = x + _o_proj(iw, mha['o'], o)
        x = _ffn_residual(cfg, bp['ffn'], bp['norm2'], x, iw.shard)
    cache = dataclasses.replace(cache, length=pos0 + kk)
    logits = _lm_logits(iw, _norm(cfg, p['final_norm'], x))
    return logits, cache


def _verify_plain(cfg: ModelConfig, cache: KVCache, base: int, blk: _Block,
                  q, k_new, v_new, keep, scale: float):
    """verify_step's plain path for one layer: insert the K columns into the
    layer's cache slice (int8 caches: quantized, scales beside them, the
    pad heads' scale lanes zeroed as the JAX engine writes them), then
    attention over the whole slice with each position's mask. Returns o
    [B, K, d_model]."""
    b, kv, kk, dh = k_new.shape
    g, nt = cfg.kv_groups, blk.nt
    sl = slice(base, base + nt)
    k_l, v_l = cache.k[:, :, sl], cache.v[:, :, sl]          # views
    if cache.quantized:
        k8, ks_new = _quantize_kv(k_new)                     # [B,KV,K,D]
        v8, vs_new = _quantize_kv(v_new)
        _insert_cols(k_l, k8, blk)
        _insert_cols(v_l, v8, blk)
        ksc_l, vsc_l = cache.k_scale[:, sl], cache.v_scale[:, sl]
        hp = ksc_l.shape[2]
        for sc_l, s_new in ((ksc_l, ks_new), (vsc_l, vs_new)):
            s_pad = torch.nn.functional.pad(s_new, (0, 0, 0, hp - kv))
            sc_l[blk.slot, blk.tile_w, :, blk.col_w] = blk.write_vals(
                s_pad.transpose(1, 2), sc_l[blk.slot[:, 0], -1, :, -1])
        # dequantized operands (the kernels' scores x kscale and
        # probabilities x vscale)
        kf = (k_l.float() * ksc_l[:, :, :kv].permute(0, 2, 1, 3)[:, :, :,
                                                                  None]
              ).to(cfg.dtype)
        vf = (v_l.float() * vsc_l[:, :, :kv].permute(0, 2, 1, 3)[:, :, :,
                                                                  None]
              ).to(cfg.dtype)
    else:
        _insert_cols(k_l, k_new, blk)
        _insert_cols(v_l, v_new, blk)
        kf, vf = k_l, v_l
    s_all = nt * TILE
    k_tok = kf.transpose(3, 4).reshape(b, kv, s_all, dh)
    v_tok = vf.transpose(3, 4).reshape(b, kv, s_all, dh)
    if g > 1:
        k_tok = k_tok.repeat_interleave(g, dim=1)
        v_tok = v_tok.repeat_interleave(g, dim=1)
    scores = (q.float() @ k_tok.float().transpose(-1, -2)) * scale  # [B,H,K,S]
    causal = torch.arange(s_all, device=q.device) <= blk.wpos[..., None]
    if keep is not None:
        scores = scores.clamp(-cfg.score_clamp, cfg.score_clamp)
        keep_s = keep.repeat_interleave(q.shape[1] // keep.shape[1], dim=1)
        allowed = keep_s.repeat_interleave(TILE, dim=3) & causal[:, None]
    else:
        allowed = causal[:, None]
    scores = torch.where(allowed, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_tok.dtype)
    o = (probs.float() @ v_tok.float()).to(cfg.dtype)       # [B, H, K, D]
    return o.transpose(1, 2).reshape(b, kk, -1)


# ---------------------------------------------------------------------------
# cache growth (length bucketing), sampling, generate
# ---------------------------------------------------------------------------

DECODE_BUCKET = 256   # a multiple of the tile size


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def grow_cache(cache: KVCache, new_len: int, n_layers: int) -> KVCache:
    """A cache of new_len tokens a layer holding `cache`'s tiles: each
    layer's block of tiles is padded with zero tiles, so decode cost tracks
    the current bucket instead of the final max_len. Returns new tensors;
    the old ones free when the caller drops them."""
    nt_old = cache.tiles_per_layer(n_layers)
    nt_new = -(-new_len // TILE)

    def grow(big, t_axis):          # t_axis: the folded layer-tile axis
        lead = big.shape[:t_axis]
        tail = big.shape[t_axis + 1:]
        out = big.new_zeros((*lead, n_layers, nt_new, *tail))
        out.narrow(t_axis + 1, 0, nt_old).copy_(
            big.reshape(*lead, n_layers, nt_old, *tail))
        return out.reshape(*lead, n_layers * nt_new, *tail)

    scales = {}
    if cache.quantized:
        scales = dict(k_scale=grow(cache.k_scale, 1),
                      v_scale=grow(cache.v_scale, 1))
    return KVCache(k=grow(cache.k, 2), v=grow(cache.v, 2),
                   codes=grow(cache.codes, 2), length=cache.length, **scales)


def warp_logits(logits: torch.Tensor, *, temperature: float,
                top_k: Optional[int] = None,
                top_p: Optional[float] = None) -> torch.Tensor:
    """Temperature / top-k / nucleus warping (f32 logits out, NEG_INF where
    cut). The warped softmax is the sampling distribution; speculative
    rejection sampling (inference/speculative.py) warps draft and target
    the same way."""
    logits = logits.float() / temperature
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits >= kth, logits, NEG_INF)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = torch.where(logits >= cutoff, logits, NEG_INF)
    return logits


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           *, temperature: float = 0.0, top_k: Optional[int] = None,
           top_p: Optional[float] = None) -> torch.Tensor:
    """Greedy (temperature 0: argmax, the lowest index on ties) or a draw
    from the warped softmax with `generator` (on the logits' device). The
    JAX package draws with jax.random; the two cannot give the same
    numbers, only the same distribution."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(warp_logits(logits, temperature=temperature,
                                      top_k=top_k, top_p=top_p), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=generator)
    return tok.reshape(probs.shape[:-1]).to(torch.int32)


def weights_device(iw: InferenceWeights) -> torch.device:
    """The device the weights live on (the entry points below run there)."""
    return iw.params['embedding']['embedding'].device


def generate(iw: InferenceWeights, prompts: torch.Tensor,
             max_new_tokens: int, *, max_len: Optional[int] = None,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             eos_id: Optional[int] = None,
             lengths: Optional[torch.Tensor] = None,
             quantized_kv: bool = False, mesh=None) -> torch.Tensor:
    """Batch generate on the weights' device. prompts [B, S_prompt] ->
    int32 [B, S_prompt + max_new_tokens] (fewer columns when every row hit
    eos_id early).

    Greedy without eos_id decodes through decode_step_greedy (the fused
    lm_head argmax); otherwise decode_step + sample, drawing with
    `generator` (default: one seeded with 0; JAX's random draws cannot be
    reproduced). quantized_kv keeps the KV cache in int8 with per-token
    scales. The cache starts at the smallest DECODE_BUCKET multiple that
    fits the prompt and grows as decoding proceeds (up to max_len).

    Ragged batches: right-pad the prompts and pass the true per-row
    `lengths [B]`: the cache length is set per row and the first token is
    sampled at each row's last prompt token; generated tokens still land at
    out[:, S_prompt + i].

    mesh (parallel.mesh.Mesh; every rank of the world calls generate with
    the same arguments): tensor-parallel serving. The weights are sharded
    on 'model' (parallel/infer_sharding.py; weights already sharded are
    taken as they are), the prompts' rows split over 'data' when B divides
    (else every data rank runs them all), and each rank's cache holds its
    rows and kv heads. Greedy takes the global first maximum of the ranks'
    fused heads; sampling gathers the logits over 'model' and 'data' and
    draws every row on every rank from the same generator, so the draws
    are the unsharded run's. Every rank returns the whole [B, S] array."""
    rows = slice(None)
    split = False
    if mesh is not None:
        from spt_proto_tpu_torch.parallel.infer_sharding import data_rows
        iw = mesh_weights(iw, mesh)
        rows, split = data_rows(mesh, prompts.shape[0])
    dev = weights_device(iw)
    prompts = prompts.to(dev)
    b, s0 = prompts.shape
    limit = max_len or (s0 + max_new_tokens)
    cap = min(max(s0, round_up(s0 + 1, DECODE_BUCKET)), max(limit, s0))
    mine = prompts[rows]
    cache = new_cache(iw, mine.shape[0], cap, quantized=quantized_kv)
    greedy = temperature == 0.0 and eos_id is None
    logits, cache = prefill(iw, mine, cache)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
        max_pos = int(lengths.max())
        lengths = lengths[rows]
        cache = dataclasses.replace(cache, length=lengths.clone())
        last = logits[torch.arange(mine.shape[0], device=dev),
                      lengths.long() - 1]
    else:
        max_pos = s0
        last = logits[:, -1]

    def all_rows(t):           # every row's values, on every rank
        if not split:
            return t
        from spt_proto_tpu_torch.parallel import comm
        return comm.gather(mesh, t, 'data', dim=0)

    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    warps = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    out = [mine.to(torch.int32)]
    tok = (sample(last, generator, **warps) if greedy
           else sample(all_rows(last), generator, **warps)[rows])
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        out.append(tok[:, None])
        if eos_id is not None:
            done = done | (all_rows(tok) == eos_id)
            if bool(done.all()):
                break
        if i == max_new_tokens - 1:
            break
        if max_pos + 1 > cap and cap < limit:
            cap = min(round_up(max_pos + 1, DECODE_BUCKET), limit)
            cache = grow_cache(cache, cap, iw.cfg.n_layers)
        if greedy:
            tok, cache = decode_step_greedy(iw, tok, cache)
        else:
            logits, cache = decode_step(iw, tok, cache)
            tok = sample(all_rows(logits), generator, **warps)[rows]
        max_pos += 1
    return all_rows(torch.cat(out, dim=1))


def mesh_weights(iw: InferenceWeights, mesh) -> InferenceWeights:
    """The rank's shard of the serving weights (iw itself when already
    sharded). tp_overlap's overlapped collective matmuls are not ported."""
    if iw.cfg.tp_overlap:
        raise NotImplementedError(
            'tp_overlap=True under a mesh: the overlapped collective '
            'matmuls (parallel/overlap.py) come with the overlap slice')
    if iw.shard is not None:
        return iw
    from spt_proto_tpu_torch.parallel.infer_sharding import \
        shard_inference_weights
    return shard_inference_weights(mesh, iw)
