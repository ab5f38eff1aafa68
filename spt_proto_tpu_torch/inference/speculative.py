"""Speculative decoding (port of spt_proto_tpu/inference/speculative.py):
draft k tokens cheaply, verify them with ONE target block forward
(engine.verify_step), keep the longest accepted prefix plus one
correction / bonus token, and roll both caches back by lowering their
lengths.

The block verify mirrors decode_step at each block position, so greedy
speculative output equals greedy generate() token for token (for the same
max_len: the cache bucket takes part in sparse tile selection). Rollback is
free: every attention path masks the tile-major cache by position, so
rejecting tokens is `length -= n_rejected`, and the next append overwrites
the stale columns.

Two draft sources: a smaller draft model (its own KVCache, stepped with
decode_step), or prompt lookup (n-gram): the continuation of the most
recent earlier occurrence of the stream's suffix, host-side numpy between
rounds.

Two acceptance rules: temperature 0 accepts by exact token match;
temperature > 0 runs the standard draft / target rejection sampling
(spec_accept) over equally warped distributions, so emitted tokens are
distributed as sampling from the warped target. The draws come from a
torch.Generator: they cannot reproduce the JAX package's jax.random draws,
only their distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from spt_proto_tpu_torch.inference.engine import (
    DECODE_BUCKET, KVCache, decode_step, grow_cache, prefill, round_up,
    sample, verify_step, warp_logits, weights_device)
from spt_proto_tpu_torch.inference.weights import InferenceWeights


def spec_accept(p_logits: torch.Tensor, q_logits: Optional[torch.Tensor],
                props: torch.Tensor, generator: Optional[torch.Generator],
                *, temperature: float, top_k: Optional[int] = None,
                top_p: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic speculative acceptance: proposal x_i ~ q_i is accepted
    with probability min(1, p_i(x_i) / q_i(x_i)); the first rejection
    resamples from norm(max(p_i - q_i, 0)); when all k are accepted the
    extra token is a plain sample from p_k. The emitted sequence is then
    distributed as ancestral sampling from the (warped) target.

    p_logits [B, k+1, V] target block logits; q_logits [B, k, V] draft
    logits, or None for point-mass proposals (n-gram lookup): the rule then
    accepts with probability p_i(x_i) and zeroes the proposal in the
    residual. Both sides are warped alike. Returns (n_acc [B] int64,
    correction token [B] int32)."""
    b, k = props.shape
    props = props.long()
    warps = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    p = torch.softmax(warp_logits(p_logits, **warps), dim=-1)
    if q_logits is None:
        q = torch.nn.functional.one_hot(props, p.shape[-1]).float()
    else:
        q = torch.softmax(warp_logits(q_logits, **warps), dim=-1)
    p_i = p[:, :k].gather(-1, props[..., None])[..., 0]
    q_i = q.gather(-1, props[..., None])[..., 0]
    u = torch.rand((b, k), generator=generator, device=p.device)
    acc = u < torch.clamp(p_i / q_i.clamp(min=1e-20), max=1.0)
    n_acc = torch.cumprod(acc.long(), dim=1).sum(1)
    # the correction at position n_acc: the residual after a rejection, a
    # plain target sample for the all-accepted bonus (q's row k is zero)
    q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    rows = torch.arange(b, device=p.device)
    p_star, q_star = p[rows, n_acc], q_pad[rows, n_acc]
    resid = (p_star - q_star).clamp(min=0.0)
    s = resid.sum(-1, keepdim=True)
    resid = torch.where(s > 1e-12, resid / s, p_star)
    tok = torch.multinomial(resid.clamp(min=1e-38), 1, generator=generator)
    return n_acc, tok[:, 0].to(torch.int32)


def ngram_propose(stream: np.ndarray, lens: np.ndarray, k: int,
                  max_n: int = 3) -> np.ndarray:
    """Prompt-lookup drafting: for each row, find the most recent earlier
    occurrence of the longest suffix n-gram (n = max_n..1) of
    stream[i, :lens[i]] and propose the k tokens that followed it. Rows
    with no match repeat the last token (an empty row proposes zeros).
    Proposals are host-side guesses: verification makes any one safe."""
    b = stream.shape[0]
    out = np.zeros((b, k), np.int64)
    for i in range(b):
        s = stream[i, :lens[i]]
        if len(s) == 0:
            continue
        got = False
        for n in range(min(max_n, len(s) - 1), 0, -1):
            tail = s[-n:]
            # the most recent occurrence strictly before the suffix itself:
            # windows of width n over s[:-1], so a continuation exists
            win = np.lib.stride_tricks.sliding_window_view(s[:-1], n)
            hits = np.nonzero((win == tail).all(axis=1))[0]
            if len(hits):
                j = int(hits[-1])
                cont = s[j + n:j + n + k]
                out[i, :len(cont)] = cont
                if len(cont) < k:
                    out[i, len(cont):] = s[-1]
                got = True
                break
        if not got:
            out[i] = s[-1]
    return out


def generate_speculative(
        iw: InferenceWeights, prompts: torch.Tensor, max_new_tokens: int, *,
        draft: Optional[InferenceWeights] = None, k: int = 4,
        max_len: Optional[int] = None, eos_id: Optional[int] = None,
        lengths: Optional[torch.Tensor] = None, quantized_kv: bool = False,
        ngram_max_n: int = 3, temperature: float = 0.0,
        top_k: Optional[int] = None, top_p: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, dict]:
    """Speculative generate on the target weights' device. prompts [B, S0]
    -> (int32 tokens [B, S0 + max_new_tokens], stats).

    draft=None drafts by prompt lookup (n-gram); otherwise `draft` is a
    (smaller) model of the same vocabulary whose continuations propose
    the block. temperature 0: the output is greedy generate()'s for the
    same max_len. temperature > 0: draft proposals are sampled with the
    same warps and accepted by spec_accept, drawing with `generator`
    (default: one seeded with 0).

    stats: {'rounds', 'proposed', 'accepted', 'acceptance'}; acceptance
    is accepted / proposed over live rows."""
    if k < 1:
        raise ValueError(f'k = {k}: speculation needs at least one proposal')
    dev = weights_device(iw)
    prompts = prompts.to(dev)
    stochastic = temperature > 0.0
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    warps = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    b, s0 = prompts.shape
    kk = k + 1
    # room for a full verify block past the last committed token
    limit = max_len or round_up(s0 + max_new_tokens + kk, DECODE_BUCKET)
    if limit < s0 + max_new_tokens:
        raise ValueError(f'max_len {limit} < prompt {s0} + {max_new_tokens} '
                         f'new tokens')
    cap = min(max(s0, round_up(s0 + kk, DECODE_BUCKET)), max(limit, s0))
    cache = KVCache.create(iw.cfg, b, cap, dtype=iw.cfg.dtype,
                           quantized=quantized_kv, device=dev)
    logits, cache = prefill(iw, prompts, cache)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
        cache = dataclasses.replace(cache, length=lengths.clone())
        last = logits[torch.arange(b, device=dev), lengths.long() - 1]
        np_lens = lengths.cpu().numpy().astype(np.int64)
    else:
        last = logits[:, -1]
        np_lens = np.full((b,), s0, np.int64)
    if draft is not None:
        dcap = cap
        dcache = KVCache.create(draft.cfg, b, dcap, dtype=draft.cfg.dtype,
                                quantized=quantized_kv, device=dev)
        _, dcache = prefill(draft, prompts, dcache)
        if lengths is not None:
            dcache = dataclasses.replace(dcache, length=lengths.clone())

    pending = sample(last, generator, **warps)              # [B]
    # host-side stream: prompt + emitted tokens (drives n-gram drafting and
    # the output; emission counts differ per row)
    total = s0 + max_new_tokens
    stream = np.zeros((b, total + kk), np.int64)
    stream[:, :s0] = prompts.cpu().numpy()
    cursor = np_lens.copy()                 # next write index per row
    done = np.zeros((b,), bool)
    stats = dict(rounds=0, proposed=0, accepted=0)

    def emit(i: int, toks: np.ndarray) -> None:
        for t in toks:
            if done[i] or cursor[i] >= np_lens[i] + max_new_tokens:
                return
            stream[i, cursor[i]] = t
            cursor[i] += 1
            if eos_id is not None and t == eos_id:
                done[i] = True

    np_pending = pending.cpu().numpy()
    for i in range(b):
        emit(i, np_pending[i:i + 1])        # the prefill-sampled token

    while True:
        live = ~done & (cursor < np_lens + max_new_tokens)
        if not live.any():
            break
        stats['rounds'] += 1
        max_pos = int(cache.length.max())
        # near max_len the block shrinks so writes never pass the capacity
        # (a width-1 block is a plain decode step through verify_step)
        kk_r = min(kk, limit - max_pos)
        k_r = kk_r - 1
        if max_pos + kk_r > cap and cap < limit:
            cap = min(round_up(max_pos + kk_r, DECODE_BUCKET), limit)
            cache = grow_cache(cache, cap, iw.cfg.n_layers)
        # ---- draft k_r proposals
        d_logits = None
        if draft is not None and k_r > 0:
            if max_pos + kk_r > dcap:
                dcap = min(round_up(max_pos + kk_r, DECODE_BUCKET), limit)
                dcache = grow_cache(dcache, dcap, draft.cfg.n_layers)
            d_toks, dls = [pending], []
            for _ in range(k_r):
                dl, dcache = decode_step(draft, d_toks[-1], dcache)
                dls.append(dl)
                d_toks.append(sample(dl, generator, **warps))
            # one more append so the draft cache also covers p_k (its
            # logits are unused); the rollback below re-aligns both caches
            _, dcache = decode_step(draft, d_toks[-1], dcache)
            props = torch.stack(d_toks[1:], dim=1)             # [B, k_r]
            if stochastic:
                d_logits = torch.stack(dls, dim=1)             # [B, k_r, V]
        elif k_r > 0:
            props = torch.from_numpy(ngram_propose(
                stream, cursor, k_r, max_n=ngram_max_n)).to(
                device=dev, dtype=torch.int32)
        else:
            props = torch.zeros((b, 0), dtype=torch.int32, device=dev)
        # ---- one block verify on [pending, p_1 .. p_k]
        block = torch.cat([pending[:, None], props], dim=1)
        len0 = cache.length
        vlogits, cache = verify_step(iw, block, cache)
        if stochastic:
            n_acc, corr = spec_accept(vlogits, d_logits, props, generator,
                                      **warps)
        else:
            t_hat = torch.argmax(vlogits, dim=-1).to(torch.int32)  # [B, K]
            match = (t_hat[:, :k_r] == props).long()
            n_acc = torch.cumprod(match, dim=1).sum(1)         # [B] in [0, k]
            corr = t_hat[torch.arange(b, device=dev), n_acc]
        # ---- rollback: committed = old + pending + accepted; finished
        # rows roll back fully so their lengths never grow
        live_t = torch.from_numpy(live).to(dev)
        new_len = torch.where(live_t, len0 + 1 + n_acc, len0).to(torch.int32)
        cache = dataclasses.replace(cache, length=new_len)
        if draft is not None:
            dcache = dataclasses.replace(dcache, length=new_len.clone())
        # ---- emit the accepted prefix and the correction / bonus token
        np_props = props.cpu().numpy()
        np_corr = corr.cpu().numpy()
        np_acc = n_acc.cpu().numpy()
        for i in range(b):
            if not live[i]:
                continue
            emit(i, np.concatenate([np_props[i, :np_acc[i]],
                                    np_corr[i:i + 1]]))
            stats['proposed'] += k_r
            stats['accepted'] += int(np_acc[i])
        pending = corr
    stats['acceptance'] = (stats['accepted'] / stats['proposed']
                           if stats['proposed'] else 0.0)
    # the output contract of generate(): the prompts at [:, :s0] (padded as
    # given), generated token j at [:, s0 + j] for every row
    out = np.zeros((b, total), np.int64)
    out[:, :s0] = prompts.cpu().numpy()
    for i in range(b):
        n_emit = cursor[i] - np_lens[i]
        out[i, s0:s0 + n_emit] = stream[i, np_lens[i]:cursor[i]]
        if eos_id is not None and n_emit and done[i]:
            out[i, s0 + n_emit:] = eos_id      # pad finished rows
    return torch.from_numpy(out).to(device=dev, dtype=torch.int32), stats
