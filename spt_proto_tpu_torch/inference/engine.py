"""Inference engine: prefill + single-token decode with a tile-major KV
cache (port of spt_proto_tpu/inference/engine.py, serving path).

This port serves OPT with fp or int8 weight-only ("w8") weights and greedy
decoding in every decode mode the JAX package's bench.py measures: dense
attention, and PQ-sparse attention (sparse_v2, l1 or l2 metric) through the
fused front or the unfused front, each over a bf16/f32 KV cache or an int8
one, optionally with the fused FFN tail. Per decode layer the step launches
the tile attention kernel with in-place append (ops/decode_attention.py:
`decode_attention_rows` over a bf16/f32 cache, `decode_attention_rows_q`
over an int8 one), after the fused front kernel (ops/decode_front.py) when
the config takes it (l2 metric, per-head selection), and the fused FFN tail
(ops/ffn_tail.py) when the config asks for it or, by default, for int8
weights; per step one fused lm_head argmax (ops/lm_head.py). With int8
weights every other projection (prefill's, the unfused front's QKV, the
o-projection, the unfused FFN, prefill's lm_head) is one int8_matmul
launch (ops/int8_matmul.py). Sparse prefill runs the block-sparse attention
kernel (ops/block_sparse_attention.py) once per layer. Everything else,
dense prefill and the unfused front among it, is plain PyTorch that
mirrors the JAX engine op for op, as the JAX package leaves it to XLA.

Out of this port so far, and raising NotImplementedError with the slice
that brings them: LLaMA and GQA (LLaMA slice), routed FFN (training
slice).

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
from spt_proto_tpu_torch.ops import pq as pq_ops
from spt_proto_tpu_torch.ops.block_sparse import pq_tile_scores, select_tiles
from spt_proto_tpu_torch.ops.block_sparse_attention import \
    block_sparse_attention
from spt_proto_tpu_torch.ops.decode_attention import (decode_attention_rows,
                                                      decode_attention_rows_q)
from spt_proto_tpu_torch.ops.decode_front import decode_front
from spt_proto_tpu_torch.ops.ffn_tail import (MAX_ROWS, ffn_tail,
                                              ffn_tail_int8, int8_tile)
from spt_proto_tpu_torch.ops.int8_matmul import int8_matmul
from spt_proto_tpu_torch.ops.lm_head import (lm_head_argmax,
                                             lm_head_argmax_int8)
from spt_proto_tpu_torch.ops.lookup import pq_topk_indices
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
               device='cuda') -> 'KVCache':
        dev = resolve_device(device)
        l, h, d = cfg.n_layers, cfg.kv_heads, cfg.d_head
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
    over the packed int8 [D, 3D] kernel (columns [q|k|v])."""
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


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense OPT FFN (ReLU)."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, cfg.d_model)
    y = _dense(p['fc2'], torch.relu(_dense(p['fc1'], xf)))
    return y.reshape(*lead, cfg.d_model)


def _ffn_residual(cfg: ModelConfig, p: dict, pn: dict,
                  x: torch.Tensor) -> torch.Tensor:
    """x + ffn(norm2(x)); through the fused tail kernel when the config
    asks for it (decode_fused_ffn=True; None means "for int8 weights only",
    as in the JAX engine) and the shape is eligible: <= 256 rows, d_model
    and d_ff multiples of 128, and for int8 weights a d_ff tile of >= 128
    dividing d_ff."""
    xn = _layernorm(pn, x)
    rows = x.numel() // cfg.d_model
    quant = [isinstance(p[n]['kernel'], dict) for n in ('fc1', 'fc2')]
    use_fused = cfg.decode_fused_ffn
    if use_fused is None:
        use_fused = all(quant)
    eligible = (use_fused and rows <= MAX_ROWS and cfg.d_model % 128 == 0
                and cfg.d_feedforward % 128 == 0
                and (all(quant) or not any(quant)))
    if eligible and all(quant):
        eligible = int8_tile(cfg.d_feedforward) >= 128
    if not eligible:
        return x + _ffn(cfg, p, xn)
    tail = ffn_tail_int8 if all(quant) else ffn_tail
    y = tail(xn.reshape(rows, cfg.d_model), x.reshape(rows, cfg.d_model),
             p['fc1']['kernel'], p['fc1']['bias'], p['fc2']['kernel'],
             p['fc2']['bias'])
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


def _require_slice(iw: InferenceWeights, cache: KVCache) -> None:
    cfg = iw.cfg
    if cfg.arch != 'opt' or cfg.kv_heads != cfg.n_heads:
        raise NotImplementedError(
            'LLaMA and GQA serving (RMSNorm, RoPE, the gated FFN tail) come '
            'with the LLaMA slice')
    if cfg.ffn == FFN_ROUTED:
        raise NotImplementedError('routed FFN comes with the training slice')
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
    h_tok = p['embedding']['embedding'][tokens] \
        + p['learned_pe']['embedding'][pos + PE_OFFSET]
    x = h_tok.to(cfg.dtype)
    h, dh = cfg.n_heads, cfg.d_head
    nt = cache.tiles_per_layer(cfg.n_layers)
    nt_m = -(-s // TILE)
    scale = dh ** -0.5
    sparse = cfg.attention == ATTN_SPARSE_V2

    def to_tiles(x_std):            # [B, H, S, w] -> [B, H, NTm, w, T]
        xp = torch.nn.functional.pad(x_std, (0, 0, 0, nt_m * TILE - s))
        return xp.reshape(b, h, nt_m, TILE, -1).transpose(3, 4)

    def sc_tiles(x_std):            # [B, H, S] -> [B, NTm, H, T]
        xp = torch.nn.functional.pad(x_std, (0, nt_m * TILE - s))
        return xp.reshape(b, h, nt_m, TILE).transpose(1, 2)

    for li in range(cfg.n_layers):
        bp = _layer(p['blocks'], li)
        q, k, v = _qkv_proj(bp['mha'], _layernorm(bp['norm1'], x))
        q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2)    # [B, H, S, dh]
                   for t in (q, k, v))
        if sparse:
            o, codes_k = _sparse_prefill_attention(cfg, bp['mha'], q, k, v,
                                                   scale)
        else:
            # causal f32 scores; the softmax rounds to the serving dtype
            # before the PV product (the JAX engine's dense branch)
            scores = (q.float() @ k.float().transpose(-1, -2)) * scale
            causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
            scores = torch.where(causal, scores, NEG_INF)
            o = torch.softmax(scores, dim=-1).to(q.dtype) @ v
            codes_k = torch.zeros((b, h, s, 1), dtype=torch.int32,
                                  device=dev)
        o = o.reshape(b, h, s, dh).transpose(1, 2).reshape(b, s, cfg.d_model)
        x = x + _dense(bp['mha']['o'], o)
        x = x + _ffn(cfg, bp['ffn'], _layernorm(bp['norm2'], x))

        # write this layer's tiles into the cache, in place
        t0, t1 = li * nt, li * nt + nt_m
        cache.codes[:, :, t0:t1] = to_tiles(_fit_codes(
            codes_k.reshape(b, h, s, -1), cache.codes.shape[3]))
        if cache.quantized:
            k, ksc = _quantize_kv(k)
            v, vsc = _quantize_kv(v)
            cache.k_scale[:, t0:t1, :h] = sc_tiles(ksc)
            cache.v_scale[:, t0:t1, :h] = sc_tiles(vsc)
        cache.k[:, :, t0:t1] = to_tiles(k).to(cache.k.dtype)
        cache.v[:, :, t0:t1] = to_tiles(v).to(cache.v.dtype)
    cache = dataclasses.replace(cache, length=torch.full_like(cache.length, s))
    return _dense(p['lm_head'], _layernorm(p['final_norm'], x)), cache


def _sparse_prefill_attention(cfg: ModelConfig, mha: dict, q, k, v,
                              scale: float):
    """PQ-sparse prefill attention of one layer: q/k/v [B, H, S, dh] ->
    (o [B*H, S, dh], key codes [B*H, S, n_sub])."""
    bh, s, dh = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    qz, kz, vz = (t.reshape(bh, s, dh) for t in (q, k, v))
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
# decode
# ---------------------------------------------------------------------------

def decode_step(iw: InferenceWeights, tokens: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One token per active slot -> (logits [B, V], cache)."""
    x, cache = _decode_hidden(iw, tokens, cache)
    return _dense(iw.params['lm_head'], x), cache


def _uses_fused_front(cfg: ModelConfig, mha: dict) -> bool:
    """The JAX engine's envelope of the fused decode front: sparse_v2, l2
    metric, per-head selection, d_model a multiple of 128."""
    return (cfg.attention == ATTN_SPARSE_V2 and cfg.decode_fused_front
            and cfg.sparse_select_heads == 1 and cfg.pq_metric == 'l2'
            and cfg.d_model % 128 == 0 and 'quantizer_bd' in mha)


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
    h_tok = p['embedding']['embedding'][tokens.long()] \
        + p['learned_pe']['embedding'][pos.long() + PE_OFFSET]
    x = h_tok[:, None].to(cfg.dtype)                        # [B, 1, D]
    kv, g, dh = cfg.kv_heads, cfg.kv_groups, cfg.d_head
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
    for li in range(cfg.n_layers):
        bp = _layer(p['blocks'], li)
        mha = bp['mha']
        base = li * nt
        kv_quant = None
        if use_front:
            out = decode_front(
                x[:, 0], bp['norm1']['scale'], bp['norm1']['bias'],
                mha['qkv']['kernel'], mha['qkv']['bias'],
                mha['quantizer_bd'], mha['quantizer_cbn'], cache.codes, pos,
                base, nt=nt, nsel=nsel, n_sub=cfg.n_subspaces, ps=TILE,
                eps=1e-5, arch=cfg.arch, quantized=cache.quantized)
            q, k_new, v_new, c_new, tables = out[:5]
            kv_quant = out[5:]
        else:
            q, k_new, v_new = _qkv_proj(mha, _layernorm(bp['norm1'], x))
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
        kw = dict(ps=TILE, tps=tps, scale=scale, clamp=clamp)
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
        x = x + _dense(mha['o'], o.reshape(b, 1, cfg.d_model))
        x = _ffn_residual(cfg, bp['ffn'], bp['norm2'], x)
    cache = dataclasses.replace(cache, length=cache.length + 1)
    return _layernorm(p['final_norm'], x)[:, 0], cache


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
    kern = iw.params['lm_head']['kernel']
    if isinstance(kern, dict):           # int8 weight-only lm_head
        return lm_head_argmax_int8(x, kern), cache
    return lm_head_argmax(x, kern), cache
