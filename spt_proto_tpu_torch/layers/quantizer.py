"""PQ quantizer (port of spt_proto_tpu/layers/quantizer.py): params
{'codebook' [n_subspaces, n_codewords, d_codeword]}, normal(1.0) at init."""
from __future__ import annotations

from torch import nn

from spt_proto_tpu_torch.ops import pq


class PQQuantizer(nn.Module):
    def __init__(self, metric: str = 'l1'):
        super().__init__()
        self.metric = metric

    def encode(self, p: dict, z):
        return pq.pq_encode(z, p['codebook'], self.metric)

    def decode(self, p: dict, codes):
        return pq.pq_decode(codes, p['codebook'])

    def quantize(self, p: dict, z):
        return pq.pq_quantize(z, p['codebook'], self.metric)

    def train_loss(self, p: dict, z):
        """(z_q, aux_loss): the codebook's training mode."""
        return pq.pq_train(z, p['codebook'], self.metric)

    def forward(self, p: dict, z):
        return self.encode(p, z)
