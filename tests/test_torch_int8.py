"""PyTorch port vs the JAX package: int8 weight-only serving on the CPU.

The per-channel quantizer, the int8 weight tree (unstaged and staged), and
the plain twins of the int8 matmul, the int8 greedy lm_head and the int8
fused FFN tail against the JAX Pallas kernels (interpret mode, as the JAX
package's own tests run them). Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_proto_tpu import config as jcfg
from spt_proto_tpu.inference import weights as jw
from spt_proto_tpu.ops.pallas import ffn_tail as jffn
from spt_proto_tpu.ops.pallas import int8_matmul as jmm
from spt_proto_tpu.ops.pallas import lm_head as jlm
from spt_proto_tpu_torch.inference import bridge
from spt_proto_tpu_torch.inference import weights as tw
from spt_proto_tpu_torch.ops import ffn_tail as tffn
from spt_proto_tpu_torch.ops import int8_matmul as tmm
from spt_proto_tpu_torch.ops import lm_head as tlm
from test_torch_engine import port_config

# the suite runs in several xdist workers on a few cores, and these
# tensors are small: one torch thread per worker
torch.set_num_threads(1)

DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def to_torch(a, dtype):
    """A JAX array (any float dtype) -> a torch tensor of `dtype`, exact."""
    return t(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(dtype)


def as_np(a):
    """Port tensor or JAX array -> numpy, bf16 widened to f32 exactly."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == 'bfloat16' else a


def flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f'{prefix}/{k}'))
        return out
    return {prefix: tree}


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('stacked', [False, True])
def test_quantize_int8_matches_jax(dtype, stacked):
    """q and scale bit-equal to JAX's eager build, N = 200 padded to 256,
    in f32 and in bf16 (where the scale and the division run in bf16)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    shape = (3, 64, 200) if stacked else (64, 200)
    w = (rng.randn(*shape) * rng.rand(200) * 3).astype(np.float32)
    w[..., 7] = 0.0                       # an all-zero column: scale 1e-8
    wj = jnp.asarray(w).astype(jdt)
    want = jw.quantize_int8(wj)
    got = tw.quantize_int8(to_torch(wj, tdt))
    assert got['q'].dtype == torch.int8 and got['q'].shape[-1] == 256
    assert got['scale'].dtype == torch.float32
    assert got['scale'].shape == tuple(want['scale'].shape) == \
        shape[:-2] + (1, 200)
    np.testing.assert_array_equal(got['q'].numpy(), np.asarray(want['q']))
    np.testing.assert_array_equal(got['scale'].numpy(),
                                  np.asarray(want['scale']))


@pytest.mark.parametrize('m', [8, 96])
@pytest.mark.parametrize('k', [128, 256, 96])
def test_int8_matmul_twin_matches_jax_kernel(m, k):
    """The twin (bf16-rounded x, block_k chunk sums) vs the Pallas kernel:
    f32 output to 1e-5, bf16 output within one bf16 step; the padded
    columns come out 0, and the wrapper on CPU tensors launches nothing."""
    rng = np.random.RandomState(m + k)
    w = (rng.randn(k, 200) / np.sqrt(k)).astype(np.float32)
    wq = jw.quantize_int8(jnp.asarray(w))
    x = rng.randn(m, k).astype(np.float32)
    q_t, s_t = t(wq['q']), t(wq['scale'])
    for jdt, tdt in DTYPES.values():
        xj = jnp.asarray(x).astype(jdt)
        want = as_np(jmm.int8_matmul(xj, wq['q'], wq['scale'],
                                     interpret=True))
        got = tmm.int8_matmul_ref(to_torch(xj, tdt), q_t, s_t)
        assert got.dtype == tdt and got.shape == (m, 256)
        if tdt == torch.float32:
            np.testing.assert_allclose(as_np(got), want, atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_allclose(as_np(got), want, atol=1e-2,
                                       rtol=2 ** -7)
        assert not as_np(got)[:, 200:].any()
    n0 = tmm.int8_matmul.launches
    xt = t(x).reshape(2, m // 2, k)                  # leading dims kept
    assert torch.equal(tmm.int8_matmul(xt, q_t, s_t),
                       tmm.int8_matmul_ref(xt, q_t, s_t))
    assert tmm.int8_matmul.launches == n0 == 0


def test_lm_head_argmax_int8_matches_jax():
    """The same ids as the JAX kernel: ties (equal columns) go to the lowest
    index, a winner in the ragged last tile is found, and when every true
    logit is negative no padded lane (logit 0) past the true vocab wins."""
    rng = np.random.RandomState(5)
    b, d, v = 4, 256, 1000                           # q padded to 1024
    x = rng.randn(b, d).astype(np.float32)
    w = rng.randn(d, v).astype(np.float32) * 0.05
    w[:, 300] = w[:, 700] = 3 * x[0]                 # row 0: tie across tiles
    w[:, 990] = 3 * x[1]                             # row 1: ragged last tile
    w[:, 5] = w[:, 6] = 3 * x[2]                     # row 2: tie in a tile
    negative = (np.abs(x), -np.abs(w) - 0.01)        # every logit < 0
    for case, (xc, wc) in enumerate(((x, w), negative)):
        for jdt, tdt in DTYPES.values():
            wq = jw.quantize_int8(jnp.asarray(wc).astype(jdt))
            xj = jnp.asarray(xc).astype(jdt)
            want = np.asarray(jlm.lm_head_argmax_int8(xj, wq, interpret=True))
            wq_t = {'q': t(wq['q']), 'scale': t(wq['scale'])}
            got = tlm.lm_head_argmax_int8_ref(to_torch(xj, tdt), wq_t)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
            assert (want < v).all()
            if case == 0 and tdt == torch.float32:
                assert want.tolist()[:3] == [300, 990, 5]
            n0 = tlm.lm_head_argmax_int8.launches
            assert torch.equal(
                tlm.lm_head_argmax_int8(to_torch(xj, tdt), wq_t), got)
            assert tlm.lm_head_argmax_int8.launches == n0 == 0


def test_ffn_tail_int8_matches_jax_kernel():
    """D = 128 (w2q padded to 256, so d_out_pad != D) and d_ff 384 (three
    tiles of 128): 1e-5 in f32."""
    rng = np.random.RandomState(7)
    m, d, f = 5, 128, 384
    x, res = (rng.randn(m, d).astype(np.float32) for _ in range(2))
    w1 = (rng.randn(d, f) * 0.05).astype(np.float32)
    w2 = (rng.randn(f, d) * 0.05).astype(np.float32)
    b1, b2 = rng.randn(f).astype(np.float32), rng.randn(d).astype(np.float32)
    w1q, w2q = jw.quantize_int8(jnp.asarray(w1)), jw.quantize_int8(
        jnp.asarray(w2))
    assert w2q['q'].shape == (f, 256)
    want = np.asarray(jffn.ffn_tail_int8(
        jnp.asarray(x), jnp.asarray(res), w1q, jnp.asarray(b1), w2q,
        jnp.asarray(b2), interpret=True))
    args = [t(x), t(res), {k: t(a) for k, a in w1q.items()}, t(b1),
            {k: t(a) for k, a in w2q.items()}, t(b2)]
    got = tffn.ffn_tail_int8_ref(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    n0 = tffn.ffn_tail_int8.launches
    assert torch.equal(tffn.ffn_tail_int8(*args), got)
    assert tffn.ffn_tail_int8.launches == n0 == 0


@pytest.fixture(scope='module')
def sparse_params():
    """A tiny PQ-sparse OPT (d_model 128, two heads, two layers), seeded f32
    params with the JAX tree's paths, as numpy arrays."""
    cfg = jcfg.tiny_config('opt', d_model=128, n_heads=2, d_feedforward=256,
                           vocab_size=256, max_length=512,
                           attention='sparse_v2').replace(dtype=jnp.float32)
    tree = bridge.init_params(port_config(cfg), seed=0, device='cpu')
    return cfg, jax.tree.map(lambda a: a.numpy(), tree)


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_int8_weight_tree_matches_jax(sparse_params, dtype):
    """from_params(quant='int8') gives JAX's tree leaf by leaf: the same
    paths, shapes and dtypes, int8 leaves and scales bit-equal to JAX's
    unstaged (eager) build, fp leaves equal (bd/cbn to f32 rounding); the
    port's staged build equals its unstaged one exactly. JAX's staged build
    (its default for a host tree) runs jitted, where XLA turns / 127 into
    * (1 / 127): its f32 scales may sit one ulp away, its q is the same."""
    jdt, tdt = DTYPES[dtype]
    cfg, params = sparse_params
    jparams = jax.tree.map(jnp.asarray, params)
    want = flat(jw.InferenceWeights.from_params(
        cfg, jparams, quant='int8', dtype=jdt, staged=False).params)
    pcfg = port_config(cfg)
    tparams = bridge.params_from_numpy(params, device='cpu')
    iw = tw.InferenceWeights.from_params(pcfg, tparams, quant='int8',
                                         dtype=tdt)
    got = flat(iw.params)
    assert iw.quant == 'int8' and sorted(got) == sorted(want)
    assert want['/blocks/mha/qkv/kernel/q'].shape == (2, 128, 512)
    for path, w_ in want.items():
        g_ = got[path]
        assert tuple(g_.shape) == tuple(w_.shape), path
        if g_.dtype == torch.int8:
            assert w_.dtype == np.int8, path
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_),
                                          err_msg=path)
        elif path.endswith(('quantizer_bd', 'quantizer_cbn')):
            np.testing.assert_allclose(as_np(g_), as_np(w_), rtol=1e-6,
                                       err_msg=path)
        else:
            assert str(g_.dtype).split('.')[-1] == str(w_.dtype), path
            np.testing.assert_array_equal(as_np(g_), as_np(w_), err_msg=path)
    j_staged = flat(jw.InferenceWeights.from_params(
        cfg, params, quant='int8', dtype=jdt, staged=True).params) \
        if tdt == torch.float32 else {}
    for path, w_ in j_staged.items():
        if path.endswith('/scale'):
            np.testing.assert_allclose(as_np(got[path]), as_np(w_),
                                       rtol=2 ** -23, atol=0, err_msg=path)
        elif w_.dtype == np.int8:
            np.testing.assert_array_equal(got[path].numpy(), np.asarray(w_),
                                          err_msg=path)
    staged = flat(tw.InferenceWeights.from_params(
        pcfg, tparams, quant='int8', dtype=tdt, staged=True,
        device='cpu').params)
    assert sorted(staged) == sorted(got)
    for path, g_ in got.items():
        assert staged[path].dtype == g_.dtype, path
        assert torch.equal(staged[path], g_), path


# The wrapper's choice of int8_matmul kernel (int8_matmul_plan), pure
# Python: the w8 serving shapes and the int8_base forward take the tensor
# cores in bf16 (the weight stream below SKINNY_M rows, wgmma from it), f32
# and the shapes off the rule (K % 8, an unaligned x) the CUDA-core
# kernels; the stream's K slices are whole 64-row stages and keep every
# K row, its tile holds every row of x.
@pytest.mark.parametrize('m,k,n_pad,dtype,aligned,route', [
    (8, 4096, 4096, torch.bfloat16, True, 'stream'),        # Llama-3-8B o
    (4, 4096, 4096, torch.bfloat16, True, 'stream'),        # LLaMA-7B o B=4
    (8, 768, 2304, torch.bfloat16, True, 'stream'),         # OPT-125M qkv
    (63, 4096, 1024, torch.bfloat16, True, 'stream'),       # SKINNY_M - 1
    (64, 4096, 1024, torch.bfloat16, True, 'wgmma'),        # SKINNY_M
    (2048, 4096, 11008, torch.bfloat16, True, 'wgmma'),     # int8_base fwd
    (16384, 4096, 14336, torch.bfloat16, True, 'wgmma'),    # 3-8B prefill
    (16384, 4104, 512, torch.bfloat16, True, 'wgmma'),      # K off 64
    (8, 4096, 4096, torch.float32, True, 'cuda_core'),      # f32
    (16384, 768, 3072, torch.float32, True, 'cuda_core'),
    (8, 100, 256, torch.bfloat16, True, 'cuda_core'),       # K % 8
    (96, 100, 256, torch.bfloat16, True, 'cuda_core'),
    (8, 256, 256, torch.bfloat16, False, 'cuda_core'),      # unaligned x
    (96, 256, 256, torch.bfloat16, False, 'cuda_core')], ids=str)
def test_int8_matmul_plan(m, k, n_pad, dtype, aligned, route):
    plan = tmm.int8_matmul_plan(m, k, n_pad, dtype, aligned)
    assert plan['route'] == route
    assert (route == 'stream') == (dtype == torch.bfloat16 and aligned
                                   and k % 8 == 0 and m < tmm.SKINNY_M)
    if route == 'wgmma':
        assert plan['bn'] == (256 if m >= tmm.WGMMA_WIDE_M else 128)
    if route == 'stream':
        cw, ng, kslice = plan['cw'], plan['ng'], plan['kslice']
        assert cw in (1, 2, 4, 8) and ng in (1, 2, 4)
        assert (8 // cw) * ng * 8 >= m                # every row of x held
        assert kslice % 64 == 0 and plan['slices'] * kslice >= k
        assert (plan['slices'] - 1) * kslice < k      # no empty slice
        ctas = plan['slices'] * -(-n_pad // (16 * cw))
        assert ctas <= tmm.STREAM_CTAS or plan['slices'] == 1
        assert plan['stages'] == 4            # the kernel's one depth
