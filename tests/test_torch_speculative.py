"""PyTorch port vs the JAX package: speculative decoding on the CPU.

The block-verify twin against the JAX Pallas kernel (interpret mode, called
directly), verify_step against JAX's plain verify path (impl='jnp', which
avoids an interpret-mode kernel inside the engine) and against K sequential
port decode steps, generate() and generate_speculative() against JAX's
greedy generate(), warp_logits, spec_accept's distributions and
ngram_propose. Tiny models (tiny_config: d_model 64, 4 heads, 2 layers);
the verify blocks start at position 250 so that sparse selection has full
tiles to choose from and a block crosses the tile boundary at 256.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu.config import tiny_config
from spt_proto_tpu.inference import engine as jeng
from spt_proto_tpu.inference import speculative as jspec
from spt_proto_tpu.inference.weights import InferenceWeights as JIW
from spt_proto_tpu.ops.pallas.decode_attention import \
    verify_attention_rows as j_verify
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference import engine as teng
from spt_proto_tpu_torch.inference import speculative as tspec
from spt_proto_tpu_torch.inference.weights import InferenceWeights as TIW
from spt_proto_tpu_torch.ops import decode_attention as tattn
from test_torch_engine import port_config

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)

SPARSE = dict(attention='sparse_v2', d_codeword=4, n_codewords=8,
              sparse_coeff=4)
MAX_LEN = 512          # 4 tiles a layer


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the kernel's twin
# ---------------------------------------------------------------------------

def _verify_inputs(seed, g, width, pos, ps=32, kk=4, kv=2, d=16, nt=6,
                   t_sel=3):
    """Random verify inputs on the engine's contract: caches of 2 layers of
    nt tiles (the second layer's tiles addressed), per head up to t_sel
    full tiles below the first write tile with random visibility bits,
    then the two write tiles (the first one's bits 0 when it repeats the
    second)."""
    rs = np.random.RandomState(seed)
    b, n_all, base = len(pos), 2 * nt, nt
    q = rs.randn(b, kv, g * kk, d).astype(np.float32)
    kc, vc = (rs.randn(b, kv, n_all, d, ps).astype(np.float32)
              for _ in range(2))
    cc = rs.randint(0, 8, size=(b, kv, n_all, width, ps)).astype(np.int32)
    kn, vn = (rs.randn(b, kv, d, kk).astype(np.float32) for _ in range(2))
    cn = rs.randint(0, 8, size=(b, kv, width, kk)).astype(np.int32)
    pos = np.asarray(pos, np.int32)
    tables = np.full((b, kv, t_sel + 2), -1, np.int32)
    bits = np.zeros((b, kv, t_sel + 2), np.int32)
    for i in range(b):
        w0, w1 = pos[i] // ps, (pos[i] + kk - 1) // ps
        for h in range(kv):
            full = rs.permutation(w0)[:t_sel]
            tables[i, h, :len(full)] = full + base
            bits[i, h, :len(full)] = rs.randint(1, 1 << kk, size=len(full))
            tables[i, h, -2:] = (w0 + base, w1 + base)
            bits[i, h, -2:] = rs.randint(1, 1 << kk, size=2)
            if w0 == w1:
                bits[i, h, -2] = 0
    tile_base = np.full((b,), base, np.int32)
    return [q, kc, vc, cc, tables, bits, pos, kn, vn, cn, tile_base]


@pytest.mark.parametrize('g,width,pos,clamp', [
    (1, 1, [70, 40], 0.0),       # a dense cache (one code column)
    (1, 4, [94, 61], 3.0),       # codes; slot 0's block crosses a tile
    (2, 4, [93, 70], 3.0),       # G = 2 query heads a kv head
], ids=['dense', 'sparse-tile-boundary', 'g2'])
def test_verify_twin_matches_jax_kernel(g, width, pos, clamp):
    """verify_attention_rows' twin vs the JAX kernel (interpret mode) on
    random inputs: o to 1e-5 in f32, the appended caches and codes
    exact."""
    arrays = _verify_inputs(len(pos) + g + width, g, width, pos)
    kw = dict(ps=32, scale=0.25, clamp=clamp)
    want = j_verify(*(jnp.asarray(a) for a in arrays), **kw, interpret=True)
    got = tattn.verify_attention_rows(*(t(a) for a in arrays), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=0)
    for name, g_, w_, before in zip(('k', 'v', 'codes'), got[1:], want[1:],
                                    arrays[1:4]):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_),
                                      err_msg=name)
        if name != 'codes' or width > 1:
            assert (np.asarray(w_) != before).any(), name   # appended


# ---------------------------------------------------------------------------
# verify_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def models():
    """{name: (JAX cfg, params as numpy)}: tiny OPT dense and sparse and a
    tiny LLaMA GQA sparse model (2 kv heads), max_length 512, f32. The
    weights come from the port's seeded init_params, which makes the JAX
    package's tree (paths, shapes, init scales: test_torch_engine.py holds
    it to surgery's), and both packages take them as numpy."""
    out = {}
    for name, arch, kw in (('opt-dense', 'opt', {}),
                           ('opt-sparse', 'opt', SPARSE),
                           ('llama-gqa-sparse', 'llama',
                            dict(n_kv_heads=2, **SPARSE))):
        cfg = tiny_config(arch, max_length=MAX_LEN, **kw).replace(
            dtype=jnp.float32)
        params = bridge.init_params(port_config(cfg), 0, device='cpu')
        out[name] = (cfg, jax.tree.map(lambda a: a.numpy(), params))
    return out


def _weights(models, name, quant=None):
    """(JAX weights, port weights) of one model, the port's built from the
    same numpy tree (JAX's eager int8 build, as the port's)."""
    cfg, params = models[name]
    j_iw = JIW.from_params(cfg, jax.tree.map(jnp.asarray, params),
                           dtype=jnp.float32, quant=quant)
    t_iw = TIW.from_params(port_config(cfg),
                           bridge.params_from_numpy(params, device='cpu'),
                           quant=quant)
    return j_iw, t_iw


def _prefilled(iw, prompts, quantized, port):
    if port:
        cache = teng.KVCache.create(iw.cfg, prompts.shape[0], MAX_LEN,
                                    dtype=torch.float32, quantized=quantized,
                                    device='cpu')
        return teng.prefill(iw, t(prompts), cache)[1]
    cache = jeng.KVCache.create(iw.cfg, prompts.shape[0], MAX_LEN,
                                dtype=jnp.float32, quantized=quantized)
    return jax.jit(jeng.prefill)(iw, jnp.asarray(prompts), cache)[1]


def _prompts_block(vocab, s0=250, kk=10, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, size=(2, s0)).astype(np.int32),
            rs.randint(0, vocab, size=(2, kk)).astype(np.int32))


CACHE_NAMES = ('k', 'v', 'codes', 'length')


@pytest.mark.parametrize('name,quantized,quant', [
    ('opt-dense', False, None),
    ('opt-sparse', False, None),
    ('llama-gqa-sparse', False, None),
    ('opt-sparse', True, None),
    ('opt-sparse', False, 'int8'),
], ids=['opt-dense', 'opt-sparse', 'llama-gqa-sparse', 'opt-sparse-int8kv',
        'opt-sparse-w8'])
def test_verify_step_matches_jax(models, name, quantized, quant):
    """The port's verify_step (its default path: the kernel's twin over an
    f32 cache, the plain path over an int8 one) vs JAX's plain path, a
    10-column block from position 250 across the tile boundary at 256:
    logits to 1e-5 (w8 2e-2, int8 KV 1e-4), codes and lengths exact, f32
    caches to 1e-5 (w8 2e-2), int8 entries within one step in < 1e-4 of
    them and scales to 1e-5 relative (test_torch_engine_modes.py's bounds).

    Over an int8 cache both start from JAX's prefilled cache: the two
    prefills quantize projections an ulp apart, which puts a few entries
    one int8 step apart (ROADMAP Queue 3) and moves these logits by
    ~8e-4. The block's own new columns can still land one step apart the
    same way (one value in this block), hence 1e-4 there."""
    j_iw, t_iw = _weights(models, name, quant)
    prompts, block = _prompts_block(j_iw.cfg.vocab_size)
    j_cache = _prefilled(j_iw, prompts, quantized, False)
    if quantized:
        t_cache = teng.KVCache(**{c: t(getattr(j_cache, c)) for c in (
            CACHE_NAMES + ('k_scale', 'v_scale'))})
    else:
        t_cache = _prefilled(t_iw, prompts, quantized, True)
    j_logits, j_cache = jax.jit(jeng.verify_step, static_argnames=('impl',))(
        j_iw, jnp.asarray(block), j_cache, impl='jnp')
    t_logits, t_cache = teng.verify_step(t_iw, t(block), t_cache)
    tol = 2e-2 if quant else 1e-4 if quantized else 1e-5
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=tol, rtol=0)
    for c in CACHE_NAMES + (('k_scale', 'v_scale') if quantized else ()):
        got, want = getattr(t_cache, c).numpy(), np.asarray(getattr(j_cache,
                                                                    c))
        if c in ('codes', 'length'):
            np.testing.assert_array_equal(got, want, err_msg=c)
        elif c in ('k_scale', 'v_scale'):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                       err_msg=c)
        elif quantized:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-4, c
        else:
            np.testing.assert_allclose(got, want, atol=2e-2 if quant else
                                       1e-5, rtol=1e-5, err_msg=c)
    assert t_cache.length.tolist() == [260, 260]


@pytest.mark.parametrize('name,quantized,impl,s0,kk,atol', [
    ('opt-dense', False, 'kernel', 8, 4, 5e-4),
    ('opt-sparse', False, 'kernel', 250, 10, 1e-3),
    ('opt-sparse', False, 'jnp', 250, 10, 1e-3),
    ('llama-gqa-sparse', False, 'kernel', 250, 10, 1e-3),
    ('opt-sparse', True, 'jnp', 8, 3, 2e-3),
], ids=['opt-dense', 'opt-sparse-tile-boundary', 'opt-sparse-plain',
        'llama-gqa-sparse-tile-boundary', 'opt-sparse-int8kv'])
def test_verify_step_matches_sequential_decode(models, name, quantized, impl,
                                               s0, kk, atol):
    """One K-column verify block reproduces K sequential port decode_step
    calls, with tests/test_speculative.py's bounds: logits to 5e-4 (1e-3
    across a tile boundary, 2e-3 over an int8 cache) with the same argmax;
    f32 caches to 5e-5, codes and lengths exact; over an int8 cache the
    scales to 1e-6 and the entries within one int8 step (the block's and
    the step's projections are an ulp apart)."""
    _, iw = _weights(models, name)
    prompts, block = _prompts_block(iw.cfg.vocab_size, s0, kk, seed=2)
    cache_a = _prefilled(iw, prompts, quantized, True)
    seq = []
    for j in range(kk):
        lg, cache_a = teng.decode_step(iw, t(block[:, j]), cache_a)
        seq.append(lg)
    seq = torch.stack(seq, 1)
    cache_b = _prefilled(iw, prompts, quantized, True)
    blk, cache_b = teng.verify_step(iw, t(block), cache_b, impl=impl)
    np.testing.assert_allclose(blk.numpy(), seq.numpy(), atol=atol, rtol=0)
    assert torch.equal(blk.argmax(-1), seq.argmax(-1))
    for c in CACHE_NAMES + (('k_scale', 'v_scale') if quantized else ()):
        got, want = getattr(cache_b, c).numpy(), getattr(cache_a, c).numpy()
        if c in ('codes', 'length'):
            np.testing.assert_array_equal(got, want, err_msg=c)
        elif quantized and c in ('k', 'v'):
            assert np.abs(got.astype(np.int32) - want).max() <= 1, c
        else:
            np.testing.assert_allclose(got, want, atol=1e-6 if quantized
                                       else 5e-5, rtol=0, err_msg=c)


# ---------------------------------------------------------------------------
# generate and generate_speculative
# ---------------------------------------------------------------------------

def _gen_cases(vocab):
    """(prompts, lengths, max_new_tokens) of the generate checks: random
    prompts, a repetitive prompt (n-gram drafts get accepted), a ragged
    batch."""
    rs = np.random.RandomState(7)
    ragged = np.zeros((2, 6), np.int32)
    ragged[0] = rs.randint(0, vocab, size=6)
    ragged[1, :3] = rs.randint(0, vocab, size=3)
    return {'random': (rs.randint(0, vocab, size=(2, 6)).astype(np.int32),
                       None, 12),
            'repetitive': (np.tile(np.arange(5, dtype=np.int32),
                                   (2, 3))[:, :12], None, 10),
            'ragged': (ragged, np.array([6, 3], np.int32), 8)}


@pytest.fixture(scope='module')
def generated(models):
    """JAX's greedy generate() (max_len 64) on the sparse OPT model for each
    case, and with an eos id (row 0's first generated token on the ragged
    batch); the port's weights of the same model."""
    j_iw, t_iw = _weights(models, 'opt-sparse')
    out = {}
    for case, (prompts, lengths, n) in _gen_cases(
            j_iw.cfg.vocab_size).items():
        out[case] = np.asarray(jeng.generate(
            j_iw, jnp.asarray(prompts), n, max_len=64,
            lengths=None if lengths is None else jnp.asarray(lengths)))
    prompts, lengths, n = _gen_cases(j_iw.cfg.vocab_size)['ragged']
    eos = int(out['ragged'][0, prompts.shape[1]])
    out['eos'] = eos, np.asarray(jeng.generate(
        j_iw, jnp.asarray(prompts), n, max_len=64,
        lengths=jnp.asarray(lengths), eos_id=eos))
    return t_iw, out


def test_generate_matches_jax(generated):
    """Greedy generate(): the port's tokens equal JAX's exactly, with
    random, repetitive and ragged prompts, and with an eos id (decode_step
    + sample; every row padded or cut as JAX does)."""
    iw, want = generated
    cases = _gen_cases(iw.cfg.vocab_size)
    for case, (prompts, lengths, n) in cases.items():
        got = teng.generate(iw, t(prompts), n, max_len=64,
                            lengths=None if lengths is None else t(lengths))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want[case], err_msg=case)
    eos, want_eos = want['eos']
    prompts, lengths, n = cases['ragged']
    got = teng.generate(iw, t(prompts), n, max_len=64, lengths=t(lengths),
                        eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want_eos)


@pytest.mark.parametrize('draft', ['ngram', 'self'])
def test_speculative_greedy_matches_generate(generated, draft):
    """Greedy generate_speculative, n-gram drafting (k = 3) and self-draft
    (k = 4: every proposal accepted), equals the port's and JAX's greedy
    generate() token for token on every case."""
    iw, want = generated
    for case, (prompts, lengths, n) in _gen_cases(iw.cfg.vocab_size).items():
        lengths = None if lengths is None else t(lengths)
        kw = dict(max_len=64, lengths=lengths)
        ref = teng.generate(iw, t(prompts), n, **kw)
        got, stats = tspec.generate_speculative(
            iw, t(prompts), n, draft=iw if draft == 'self' else None,
            k=4 if draft == 'self' else 3, **kw)
        np.testing.assert_array_equal(got.numpy(), ref.numpy(),
                                      err_msg=case)
        np.testing.assert_array_equal(got.numpy(), want[case], err_msg=case)
        assert stats['rounds'] >= 1
        if draft == 'self':
            assert stats['acceptance'] > 0.99, stats


def test_speculative_sampled_runs_are_seeded(generated):
    """temperature > 0: the same generator seed gives the same tokens, for
    a draft model and for n-gram drafting, and every token lies in the
    vocabulary."""
    iw, _ = generated
    prompts = t(_gen_cases(iw.cfg.vocab_size)['random'][0])

    def run(draft, seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return tspec.generate_speculative(
            iw, prompts, 8, draft=draft, k=3, max_len=64, temperature=0.8,
            top_k=10, generator=g)
    for draft in (iw, None):
        a, stats = run(draft, 7)
        b, _ = run(draft, 7)
        assert torch.equal(a, b) and a.shape == (2, 14)
        assert int(a.min()) >= 0 and int(a.max()) < iw.cfg.vocab_size
        assert stats['proposed'] > 0


# ---------------------------------------------------------------------------
# sampling pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('top_k,top_p', [(5, None), (None, 0.7), (3, 0.9)])
def test_warp_logits_matches_jax(top_k, top_p):
    """The same warped logits and the same NEG_INF mask as JAX's."""
    logits = np.random.RandomState(11).randn(4, 64).astype(np.float32) * 3
    kw = dict(temperature=0.7, top_k=top_k, top_p=top_p)
    want = np.asarray(jeng.warp_logits(jnp.asarray(logits), **kw))
    got = teng.warp_logits(t(logits), **kw).numpy()
    np.testing.assert_array_equal(got <= jeng.NEG_INF, want <= jeng.NEG_INF)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _draws(logits, n, seed, temperature):
    """n draws from the warped logits [V] with a seeded generator."""
    g = torch.Generator()
    g.manual_seed(seed)
    probs = torch.softmax(teng.warp_logits(logits, temperature=temperature),
                          -1)
    return torch.multinomial(probs.expand(n, -1), 1, replacement=True,
                             generator=g)[:, 0]


def _within_4_sigma(toks, target):
    emp = np.bincount(toks.numpy(), minlength=target.size) / toks.numel()
    tol = 4 * np.sqrt(target * (1 - target) / toks.numel()) + 1e-3
    assert (np.abs(emp - target) < tol).all(), (emp, target)


def test_spec_accept_first_token_distribution():
    """The first token a round emits (the accepted proposal, or the
    rejection's resample) is distributed as the warped target p_0, for a
    draft model's q and for point-mass (n-gram) proposals: 30,000 rows in
    one call, 4-sigma binomial bounds per token."""
    v, k, n, temp = 8, 2, 30000, 0.9
    rs = np.random.RandomState(3)
    p_logits = t(rs.randn(1, k + 1, v).astype(np.float32) * 2)
    q_logits = t(rs.randn(1, k, v).astype(np.float32) * 2)
    props = torch.stack([_draws(q_logits[0, j], n, 10 + j, temp)
                         for j in range(k)], 1)
    target = torch.softmax(teng.warp_logits(p_logits[0, 0],
                                            temperature=temp), -1).numpy()
    for q in (q_logits.expand(n, -1, -1), None):
        g = torch.Generator()
        g.manual_seed(4)
        n_acc, corr = tspec.spec_accept(p_logits.expand(n, -1, -1), q, props,
                                        g, temperature=temp)
        _within_4_sigma(torch.where(n_acc > 0, props[:, 0], corr.long()),
                        target)


def test_spec_accept_all_accepted_bonus_distribution():
    """With q == p every proposal is accepted, and the correction is the
    bonus token, distributed as p_k."""
    v, k, n, temp = 8, 2, 30000, 1.0
    p_logits = t(np.random.RandomState(5).randn(1, k + 1, v).astype(
        np.float32) * 2)
    props = torch.stack([_draws(p_logits[0, j], n, 20 + j, temp)
                         for j in range(k)], 1)
    g = torch.Generator()
    g.manual_seed(6)
    p = p_logits.expand(n, -1, -1)
    n_acc, corr = tspec.spec_accept(p, p[:, :k], props, g, temperature=temp)
    assert bool((n_acc == k).all())
    target = torch.softmax(teng.warp_logits(p_logits[0, k],
                                            temperature=temp), -1).numpy()
    _within_4_sigma(corr.long(), target)


def test_ngram_propose_matches_jax():
    """The port's copy of ngram_propose equals JAX's on
    tests/test_speculative.py's cases (a suffix seen before, a run of one
    token) and on an empty row and a row without a match."""
    stream = np.zeros((4, 16), np.int64)
    stream[0, :9] = [1, 2, 3, 4, 5, 1, 2, 3, 4]
    stream[1, :4] = [7, 7, 7, 7]
    stream[3, :5] = [9, 8, 6, 5, 4]
    lens = np.array([9, 4, 0, 5])
    for k, max_n in ((3, 3), (5, 2)):
        got = tspec.ngram_propose(stream, lens, k, max_n)
        np.testing.assert_array_equal(
            got, jspec.ngram_propose(stream, lens, k, max_n))
    np.testing.assert_array_equal(got[:2, :3], [[5, 1, 2], [7, 7, 7]])
