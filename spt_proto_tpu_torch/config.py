"""Model / layer configuration (PyTorch port of spt_proto_tpu/config.py).

Same fields, defaults and properties as the JAX package's ModelConfig, so a
configuration reads the same in both packages; dtypes are torch dtypes. The
comments on each field live with the JAX original; here only what differs
is noted.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

ATTN_DENSE = 'dense'
ATTN_SPARSE_V1 = 'sparse_v1'
ATTN_SPARSE_V2 = 'sparse_v2'

FFN_DENSE = 'dense'
FFN_ROUTED = 'routed'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture + upgrade-stage configuration for OPT/LLaMA models."""
    arch: str                       # 'opt' | 'llama'
    d_model: int
    n_heads: int
    n_layers: int
    max_length: int
    vocab_size: int
    d_feedforward: int
    p_dropout: float = 0.0
    n_kv_heads: Optional[int] = None
    rope_base: float = 10000.0

    d_lora: Optional[int] = None
    attention: str = ATTN_DENSE
    ffn: str = FFN_DENSE
    d_codeword: int = 8
    n_codewords: int = 16
    sparse_coeff: int = 8
    score_clamp: float = 10.0
    pq_metric: str = 'l1'
    sparse_decode: str = 'tiles'
    sparse_select_heads: int = 1
    decode_multislot: bool = True
    decode_scan_unroll: int = 0
    decode_fused_ffn: Optional[bool] = None
    decode_fused_head: bool = True
    decode_fused_front: bool = True
    tp_overlap: bool = False
    ffn_block_size: Optional[int] = None
    ffn_top_k: Optional[int] = None

    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    # kept so a configuration reads the same in both packages; the port
    # picks kernel or plain twin by the tensors' device, and its engine
    # raises on the GPU unless this is 'pallas' (the kernel)
    attn_impl: str = 'ref'
    ffn_impl: str = 'masked'
    remat: bool = False
    int8_base: bool = False
    remat_policy: str = 'full'
    context_parallel: bool = False
    cp_axis: str = 'sp'

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def kv_groups(self) -> int:
        assert self.n_heads % self.kv_heads == 0
        return self.n_heads // self.kv_heads

    @property
    def n_subspaces(self) -> int:
        return self.d_head // self.d_codeword

    @property
    def attn_bias(self) -> bool:
        return self.arch == 'opt'

    @property
    def ffn_gated(self) -> bool:
        return self.arch == 'llama'

    @property
    def n_ffn_blocks(self) -> int:
        assert self.ffn_block_size is not None
        return self.d_feedforward // self.ffn_block_size

    @property
    def ffn_active_blocks(self) -> int:
        if self.ffn_top_k is not None:
            return self.ffn_top_k
        return max(1, self.n_ffn_blocks // 2)

    def replace(self, **kw) -> 'ModelConfig':
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.arch in ('opt', 'llama')
        assert self.d_model % self.n_heads == 0
        if self.attention != ATTN_DENSE:
            assert self.d_head % self.d_codeword == 0, \
                f'd_head {self.d_head} must divide into d_codeword ' \
                f'{self.d_codeword} subspaces'
        if self.ffn == FFN_ROUTED:
            assert self.ffn_block_size is not None
            assert self.d_feedforward % self.ffn_block_size == 0
        if self.attention == ATTN_SPARSE_V2:
            assert self.kv_heads % self.sparse_select_heads == 0, \
                (self.kv_heads, self.sparse_select_heads)


def opt_config(name: str = '125m', **kw) -> ModelConfig:
    menu = {
        '125m': dict(d_model=768, n_heads=12, n_layers=12, d_feedforward=3072),
        '350m': dict(d_model=1024, n_heads=16, n_layers=24, d_feedforward=4096),
        '1.3b': dict(d_model=2048, n_heads=32, n_layers=24, d_feedforward=8192),
        '2.7b': dict(d_model=2560, n_heads=32, n_layers=32, d_feedforward=10240),
    }
    base = dict(arch='opt', max_length=2048, vocab_size=50272, **menu[name])
    base.update(kw)
    return ModelConfig(**base)


def llama_config(name: str = '7b', **kw) -> ModelConfig:
    menu = {
        'sheared-2.7b': dict(d_model=2560, n_heads=20, n_layers=32,
                             d_feedforward=6912),
        '7b': dict(d_model=4096, n_heads=32, n_layers=32, d_feedforward=11008),
        '13b': dict(d_model=5120, n_heads=40, n_layers=40, d_feedforward=13824),
        '3-8b': dict(d_model=4096, n_heads=32, n_kv_heads=8, n_layers=32,
                     d_feedforward=14336, vocab_size=128256,
                     max_length=8192, rope_base=500000.0),
    }
    base = dict(arch='llama', max_length=2048, vocab_size=32000)
    base.update(menu[name])
    base.update(kw)
    return ModelConfig(**base)


def tiny_config(arch: str = 'opt', **kw) -> ModelConfig:
    """Small config for tests."""
    base = dict(arch=arch, d_model=64, n_heads=4, n_layers=2, max_length=128,
                vocab_size=256, d_feedforward=128)
    base.update(kw)
    return ModelConfig(**base)
