"""Evaluation: perplexity and MMLU answer-position accuracy (port of
spt_proto_tpu/tuning/evaluate.py).

ppl is exp of the masked next-token cross entropy (trainer.lm_loss) over
all batches, weighted by each batch's mask count; the MMLU accuracy reads
the answer at each row's length: prediction = argmax(logits[b, length - 2]),
answer = targets[b, length - 2]. Batches are dicts of numpy arrays
('inputs', 'targets', 'mask', 'lengths'), as data/datamodule.py gives
them. The forward runs on the params' device without gradients: on CUDA
tensors under attn_impl='pallas' a dense or warm-up model attends through
the flash-attention kernel, a sparse one through the block-sparse kernel.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np
import torch

from spt_proto_tpu_torch.config import ModelConfig
from spt_proto_tpu_torch.models.decoder import DecoderLM
from spt_proto_tpu_torch.tuning.trainer import lm_loss


def make_forward(cfg: ModelConfig, params: Any):
    """forward(inputs [B, S]) -> logits [B, S, V], no grad, on the params'
    device (inputs may be numpy)."""
    model = DecoderLM(cfg, params, deterministic=True, train_quantizer=False)
    dev = next(model.parameters()).device

    def forward(inputs):
        with torch.no_grad():
            return model(torch.as_tensor(inputs).to(dev))['logits']

    return forward


def evaluate(cfg: ModelConfig, params: Any, batches: Iterable[dict], *,
             max_batches: Optional[int] = None) -> dict:
    """ppl and MMLU accuracy over `batches` (at most max_batches of them):
    {'ppl', 'accuracy', 'n_examples'}."""
    forward = make_forward(cfg, params)
    total_ce, total_tok = 0.0, 0.0
    correct, count = 0, 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        logits = forward(batch['inputs'])
        dev = logits.device
        ce = lm_loss(logits, torch.as_tensor(batch['targets']).to(dev),
                     torch.as_tensor(batch['mask']).to(dev))
        ntok = float(np.sum(batch['mask']))
        total_ce += float(ce) * ntok
        total_tok += ntok
        pos = np.asarray(batch['lengths']).astype(np.int64) - 2
        rows = np.nonzero((pos >= 0) & (pos < logits.shape[1]))[0]
        if rows.size:
            pred = logits[torch.as_tensor(rows, device=dev),
                          torch.as_tensor(pos[rows], device=dev)].argmax(-1)
            tg = np.asarray(batch['targets'])[rows, pos[rows]]
            correct += int((pred.cpu().numpy() == tg).sum())
            count += int(rows.size)
    ppl = float(np.exp(total_ce / max(total_tok, 1.0)))
    return {'ppl': ppl, 'accuracy': correct / max(count, 1),
            'n_examples': count}
