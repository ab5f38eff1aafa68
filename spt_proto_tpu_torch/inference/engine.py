"""Inference engine: prefill + single-token decode with a PQ-coded KV cache
(port of spt_proto_tpu/inference/engine.py, main path).

This slice serves the flagship configuration: OPT, PQ-sparse attention
(sparse_v2, l2 metric, per-head selection), an int8 KV cache, fp weights,
greedy decoding. Per decode layer the step is two kernel launches, the
fused front (ops/decode_front.py) and the int8 tile attention with in-place
append (ops/decode_attention.py), and per step one fused lm_head argmax
(ops/lm_head.py); prefill runs the block-sparse attention kernel
(ops/block_sparse_attention.py) once per layer. Everything else is plain
PyTorch that mirrors the JAX engine op for op.

Out of this slice, and raising NotImplementedError with the slice that
brings them: dense attention, a bf16 KV cache and the l1 metric at decode
(bf16-KV / dense decode slice), LLaMA and GQA (LLaMA slice), int8 weights
(int8-weight slice), routed FFN (training slice), the fused FFN tail.

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
from spt_proto_tpu_torch.ops.decode_attention import decode_attention_rows_q
from spt_proto_tpu_torch.ops.decode_front import decode_front
from spt_proto_tpu_torch.ops.lm_head import lm_head_argmax
from spt_proto_tpu_torch.ops.lookup import pq_topk_indices
from spt_proto_tpu_torch.ops.sparse_attention import sparse_attention

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
    """q/k/v projections: one einsum over the fused [3, D, D] stack that
    InferenceWeights builds for MHA."""
    w = mha['qkv']
    y = torch.einsum('bsd,tdo->tbso', x, w['kernel'])
    if 'bias' in w:
        y = y + w['bias'][:, None, None, :]
    return y[0], y[1], y[2]


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p['kernel']
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
    """x + ffn(norm2(x)) (the unfused branch, the default for fp weights)."""
    if cfg.decode_fused_ffn:
        raise NotImplementedError(
            'the fused decode FFN tail kernel comes with the int8-weight '
            'slice')
    return x + _ffn(cfg, p, _layernorm(pn, x))


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


def _require_slice(iw: InferenceWeights, cache: KVCache,
                   decode: bool) -> None:
    cfg = iw.cfg
    if cfg.arch != 'opt' or cfg.kv_heads != cfg.n_heads:
        raise NotImplementedError(
            'LLaMA and GQA serving come with the LLaMA slice')
    if cfg.attention != ATTN_SPARSE_V2:
        raise NotImplementedError(
            'dense attention serving comes with the bf16-KV / dense decode '
            'slice')
    if cfg.ffn == FFN_ROUTED:
        raise NotImplementedError('routed FFN comes with the training slice')
    if iw.quant is not None:
        raise NotImplementedError(
            'int8 weight-only serving comes with the int8-weight slice')
    if cache.k.device.type == 'cuda' and cfg.attn_impl != 'pallas':
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r}: on the GPU the port attends only "
            f"through its kernels (attn_impl='pallas'); the plain twins run "
            f"on CPU tensors")
    if not decode:
        return
    if not cache.quantized:
        raise NotImplementedError(
            'decode over a bf16 KV cache comes with the bf16-KV / dense '
            'decode slice')
    if not (cfg.decode_fused_front and cfg.pq_metric == 'l2'
            and cfg.sparse_select_heads == 1 and cfg.d_model % 128 == 0
            and 'quantizer_bd' in iw.params['blocks']['mha']):
        raise NotImplementedError(
            'this slice decodes through the fused front only (l2 metric, '
            'per-head selection, d_model a multiple of 128); the unfused '
            'decode front comes with the bf16-KV / dense decode slice')


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(iw: InferenceWeights, tokens: torch.Tensor,
            cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Teacher-forced pass over prompts; fills the cache (in place) and
    returns the full-sequence logits. tokens [B, S] (left-aligned)."""
    _require_slice(iw, cache, decode=False)
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
        qz, kz, vz = (t.reshape(b * h, s, dh) for t in (q, k, v))
        quantizer = bp['mha']['quantizer']
        bd_m = _bd_of(bp['mha'])
        codes_q = _encode_codes(cfg, quantizer, qz, bd=bd_m)
        codes_k = _encode_codes(cfg, quantizer, kz, bd=bd_m)
        blk_k = 128
        blk_q = 256 if s % 256 == 0 else 128
        if s % blk_q == 0 and s >= 2 * blk_k:
            ratio = blk_q // blk_k
            n_sel = max(ratio, (s // blk_k) // cfg.sparse_coeff)
            ts = pq_tile_scores(codes_q, codes_k,
                                n_codewords=cfg.n_codewords,
                                block_q=blk_q, block_k=blk_k)
            sel = select_tiles(ts, n_sel, block_ratio=ratio)
            o = block_sparse_attention(qz, kz, vz, sel, block_q=blk_q,
                                       block_k=blk_k, scale=scale,
                                       clamp=cfg.score_clamp)
        else:
            if s > 1024:
                warnings.warn(
                    f'sparse prefill at S={s} (not a tile multiple) falls '
                    f'back to the O(S^2) per-row oracle — pad prompts to a '
                    f'multiple of {blk_q}', stacklevel=2)
            idx = pq_topk_indices(codes_q, codes_k,
                                  top_k=max(1, s // cfg.sparse_coeff),
                                  n_codewords=cfg.n_codewords)
            o = sparse_attention(qz, kz, vz, idx, scale=scale,
                                 clamp=cfg.score_clamp)
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


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(iw: InferenceWeights, tokens: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One token per active slot -> (logits [B, V], cache)."""
    x, cache = _decode_hidden(iw, tokens, cache)
    return _dense(iw.params['lm_head'], x), cache


def _decode_hidden(iw: InferenceWeights, tokens: torch.Tensor,
                   cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One token per active slot through the fused front + int8 tile
    attention, two launches per layer. tokens [B]; positions come from
    cache.length. Returns (final-normed hidden [B, D], cache)."""
    _require_slice(iw, cache, decode=True)
    cfg = iw.cfg
    p = iw.params
    b = tokens.shape[0]
    nt = cache.tiles_per_layer(cfg.n_layers)
    pos = cache.length
    h_tok = p['embedding']['embedding'][tokens.long()] \
        + p['learned_pe']['embedding'][pos.long() + PE_OFFSET]
    x = h_tok[:, None].to(cfg.dtype)                        # [B, 1, D]
    h, dh = cfg.n_heads, cfg.d_head
    nsel = min(nt, max(1, nt // cfg.sparse_coeff) + 1)
    n_tiles = torch.full((b,), nsel, dtype=torch.int32, device=pos.device)
    for li in range(cfg.n_layers):
        bp = _layer(p['blocks'], li)
        mha = bp['mha']
        (q, _, _, c_new, tables, k8, v8, ks_new, vs_new) = decode_front(
            x[:, 0], bp['norm1']['scale'], bp['norm1']['bias'],
            mha['qkv']['kernel'], mha['qkv']['bias'], mha['quantizer_bd'],
            mha['quantizer_cbn'], cache.codes, pos, li * nt, nt=nt,
            nsel=nsel, n_sub=cfg.n_subspaces, ps=TILE, eps=1e-5,
            arch=cfg.arch, quantized=True)
        base = torch.full((b,), li * nt, dtype=torch.int32,
                          device=pos.device)
        o = decode_attention_rows_q(
            q.reshape(b, h, 1, dh), cache.k, cache.v, cache.codes,
            cache.k_scale, cache.v_scale, tables, n_tiles, pos,
            k8.reshape(b, h, dh), v8.reshape(b, h, dh), c_new, ks_new,
            vs_new, base, ps=TILE, scale=dh ** -0.5,
            clamp=cfg.score_clamp)[0]
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
    return lm_head_argmax(x, iw.params['lm_head']['kernel']), cache
