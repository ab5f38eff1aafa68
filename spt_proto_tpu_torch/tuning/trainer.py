"""SPT fine-tuning step and loop, single device (port of the single-device
part of spt_proto_tpu/tuning/trainer.py).

AdamW (lr 1e-4, weight decay 0.1, betas 0.9 / 0.999, eps 1e-8, decoupled
decay) over the trainable leaves only (LoRA factors, routers, PQ codebooks:
`tuning.partition`), after clipping the gradients to a global norm of 1.0
in optax's form (g unchanged when norm < clip, else g / norm * clip);
frozen leaves require no grad, so they get no update and no decay, as
optax.multi_transform with set_to_zero gives. Loss = mean f32 cross
entropy + 1e-2 * the PQ aux loss. The step updates the parameters in place
(the model owns them), so `train_loop` trains the caller's tree itself.

Under cfg.int8_base the frozen int8 base kernels (frozen8, from
tuning.surgery.split_int8_base) ride beside the params: the model holds
them as buffers, and they are no leaf of the optimizer, the grad norm or
the saved train state, as the JAX package passes them to the step as a
separate argument.

Not in this slice, and raising with the slice that brings it: a training
mesh, FSDP and pipeline (pp_micro) (the training-mesh slice) and context
parallelism (the context-parallelism slice).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Iterable, Optional

import torch
import torch.nn.functional as F

from spt_proto_tpu_torch.config import ModelConfig
from spt_proto_tpu_torch.models.decoder import DecoderLM
from spt_proto_tpu_torch.tuning.partition import is_trainable_path
from spt_proto_tpu_torch.utils.tree import flatten, unflatten

AUX_LOSS_COEFF = 1e-2


def _unported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(f'{what} comes with the {slice_} slice')


class Optimizer:
    """optax.chain(clip_by_global_norm(clip), adamw(lr, weight_decay))
    over the leaves of `params` that `trainable(path)` picks."""

    def __init__(self, params: Any, *, lr: float = 1e-4,
                 weight_decay: float = 0.1, clip: float = 1.0,
                 trainable: Callable[[str], bool] = is_trainable_path):
        self.leaves = [v for p, v in flatten(params).items() if trainable(p)]
        self.clip = clip
        self.adamw = torch.optim.AdamW(self.leaves, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    def global_norm(self) -> torch.Tensor:
        """sqrt of the sum of squares of the leaves' gradients (f32)."""
        sq = [g.float().square().sum() for g in
              (p.grad for p in self.leaves) if g is not None]
        if not sq:
            return torch.zeros(())
        return torch.stack(sq).sum().sqrt()

    def step(self, norm: torch.Tensor) -> None:
        """Clip by `norm` (the gradients' global norm) and apply AdamW. A
        trainable leaf without a gradient (e.g. the codebook on a step that
        does not train the quantizer) takes a zero one, as optax sees it:
        its moments still decay and its weight decay still applies."""
        for p in self.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad = torch.where(norm < self.clip, p.grad,
                                     p.grad / norm.to(p.grad.dtype)
                                     * self.clip)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)


def make_optimizer(params: Any, *, lr: float = 1e-4,
                   weight_decay: float = 0.1, clip: float = 1.0,
                   freeze_base: bool = True) -> Optimizer:
    """AdamW with clipping over `params` (the tensors it updates in place);
    freeze_base=False trains every leaf."""
    return Optimizer(params, lr=lr, weight_decay=weight_decay, clip=clip,
                     trainable=is_trainable_path if freeze_base
                     else (lambda path: True))


@dataclasses.dataclass
class TrainState:
    model: DecoderLM          # owns the params, updated in place
    opt_state: Optimizer
    step: int = 0

    @property
    def params(self) -> Any:
        return self.model.tree()


def create_train_state(cfg: ModelConfig, params: Any, *, lr: float = 1e-4,
                       weight_decay: float = 0.1, clip: float = 1.0,
                       freeze_base: bool = True,
                       frozen8: Optional[Any] = None) -> TrainState:
    """A DecoderLM over `params` (whose trainable leaves require grad) and
    `frozen8` (int8_base), and its optimizer."""
    trainable = is_trainable_path if freeze_base else (lambda path: True)
    model = DecoderLM(cfg, params, frozen8=frozen8,
                      deterministic=cfg.p_dropout == 0.0,
                      trainable=trainable)
    tx = make_optimizer(model.tree(), lr=lr, weight_decay=weight_decay,
                        clip=clip, freeze_base=freeze_base)
    return TrainState(model, tx)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in f32. logits [B, S, V], targets
    [B, S]; with a mask, the masked mean (denominator at least 1)."""
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         targets.reshape(-1).long(), reduction='none')
    ce = ce.reshape(targets.shape)
    if mask is None:
        return ce.mean()
    mask = mask.float()
    return (ce * mask).sum() / mask.sum().clamp(min=1.0)


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, *, train_quantizer: bool = True,
                    aux_coeff: float = AUX_LOSS_COEFF,
                    dropout_seed: int = 0, accumulate: int = 1):
    """train_step(state, batch) -> (state, metrics): one optimizer update
    from batch = {'inputs' [B, S], 'targets' [B, S], optional 'mask'}
    (numpy or tensors). Gradients reach the trainable leaves only; the int8
    base kernels (int8_base) are the ones the state's model holds.
    accumulate=A splits the batch into A micro-batches along dim 0 and
    applies one update with their mean gradient. metrics: 'ce', 'pq_loss',
    'loss' and 'grad_norm' (before clipping), 0-d f32 tensors. With
    p_dropout > 0 the masks draw from a generator seeded with
    dropout_seed + step."""
    use_dropout = cfg.p_dropout > 0.0

    def train_step(state: TrainState, batch: dict):
        model = state.model
        model.train_quantizer = train_quantizer
        dev = next(model.parameters()).device
        batch = _to_device(batch, dev)
        gen = None
        if use_dropout:
            gen = torch.Generator(device=dev)
            gen.manual_seed(dropout_seed + state.step)
        n = batch['inputs'].shape[0]
        if n % accumulate:
            raise ValueError(f'batch of {n} rows does not split into '
                             f'{accumulate} micro-batches')
        sums = torch.zeros(3, dtype=torch.float32, device=dev)
        for a in range(accumulate):
            rows = slice(a * n // accumulate, (a + 1) * n // accumulate)
            out = model(batch['inputs'][rows], generator=gen)
            mask = batch.get('mask')
            ce = lm_loss(out['logits'], batch['targets'][rows],
                         None if mask is None else mask[rows])
            loss = ce + aux_coeff * out['pq_loss']
            (loss / accumulate).backward()
            sums += torch.stack([ce.detach(), out['pq_loss'].detach(),
                                 loss.detach()])
        ce, pq_loss, loss = sums / accumulate
        norm = state.opt_state.global_norm().to(dev)
        state.opt_state.step(norm)
        state.step += 1
        return state, {'ce': ce, 'pq_loss': pq_loss, 'loss': loss,
                       'grad_norm': norm}

    return train_step


def make_eval_step(cfg: ModelConfig):
    """eval_step(params, batch) -> {'ce', 'ppl', 'logits'} (no grad)."""
    def eval_step(params, batch):
        model = DecoderLM(cfg, params)
        batch = _to_device(batch, next(model.parameters()).device)
        with torch.no_grad():
            out = model(batch['inputs'])
            ce = lm_loss(out['logits'], batch['targets'], batch.get('mask'))
        return {'ce': ce, 'ppl': torch.exp(ce), 'logits': out['logits']}
    return eval_step


TRAIN_STATE_FILE = 'train_state.pt'


def save_train_state(path: str, state: TrainState) -> None:
    """Params, optimizer state and step in one torch file (the port's own
    format; the params alone go through utils/checkpoint.py)."""
    os.makedirs(path, exist_ok=True)
    torch.save({'params': {k: v.detach() for k, v in
                           flatten(state.params).items()},
                'adamw': state.opt_state.adamw.state_dict(),
                'step': state.step},
               os.path.join(path, TRAIN_STATE_FILE))


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Restore into a state of the same config and optimizer (in place)."""
    sd = torch.load(os.path.join(path, TRAIN_STATE_FILE),
                    map_location=next(template.model.parameters()).device,
                    weights_only=True)
    flat = flatten(template.params)
    if set(flat) != set(sd['params']):
        raise KeyError('train state does not match the model\'s params')
    with torch.no_grad():
        for k, v in sd['params'].items():
            flat[k].copy_(v)
    template.opt_state.adamw.load_state_dict(sd['adamw'])
    template.step = sd['step']
    return template


def train_loop(cfg: ModelConfig, params: Any, batches: Iterable[dict], *,
               lr: float = 1e-4, weight_decay: float = 0.1,
               max_steps: Optional[int] = None, log_every: int = 10,
               log_fn: Optional[Callable[[int, dict], None]] = None,
               freeze_base: bool = True, pq_train_every: int = 1,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 500, resume: bool = False,
               mesh=None, fsdp: bool = False,
               pp_micro: Optional[int] = None, accumulate: int = 1,
               frozen8: Optional[Any] = None) -> tuple[Any, list]:
    """Train on `batches` on the params' device; returns (params, history
    of (step, metrics as floats) every log_every steps). The loop trains
    the caller's tensors in place (clone them first to keep them); frozen8
    (int8_base) is never trained. pq_train_every=K arms the PQ aux loss on
    every K-th step only. The train state goes to
    checkpoint_dir every checkpoint_every steps and at the end; resume
    restores it from there first."""
    if mesh is not None or fsdp or pp_micro is not None:
        raise _unported('a training mesh (FSDP, pipeline)', 'training-mesh')
    if cfg.context_parallel:
        raise _unported('context parallelism', 'context-parallelism')
    state = create_train_state(cfg, params, lr=lr, weight_decay=weight_decay,
                               freeze_base=freeze_base, frozen8=frozen8)
    if resume and checkpoint_dir is not None and os.path.exists(
            os.path.join(checkpoint_dir, TRAIN_STATE_FILE)):
        state = load_train_state(checkpoint_dir, state)
    step_pq = make_train_step(cfg, train_quantizer=True,
                              accumulate=accumulate)
    step_fast = step_pq if pq_train_every == 1 else make_train_step(
        cfg, train_quantizer=False, accumulate=accumulate)
    history = []
    for i, batch in enumerate(batches):
        if max_steps is not None and i >= max_steps:
            break
        fn = step_pq if i % pq_train_every == 0 else step_fast
        state, metrics = fn(state, batch)
        if i % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append((i, m))
            if log_fn:
                log_fn(i, m)
        if checkpoint_dir is not None and (i + 1) % checkpoint_every == 0:
            save_train_state(checkpoint_dir, state)
    if checkpoint_dir is not None:
        save_train_state(checkpoint_dir, state)
    return unflatten({k: v.detach() for k, v in
                      flatten(state.params).items()}), history
