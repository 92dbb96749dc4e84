"""OPA (LoRA-SFT) engine, stage 3: port of ``opadpo_tpu/engine/sft.py``.

Cross-entropy on the ``IGNORE_INDEX``-masked labels of the spliced
sequence (the causal shift: position t predicts label t + 1), read out of
the lm_head in one ``chunked_logprobs`` pass.  Optionally the
entropy-maximisation loss on image-masked inputs (the reference's
``opa_trainer.py:58-125``, off in the shipped recipe): a second forward on
masked images (``random``, ``blockwise``) or with patches masked out of
the attention (``attention``), whose per-position entropies minus the
unmasked ones, averaged over each row's labelled positions, are added with
``entropy_loss_coef``.  The masks are drawn from a ``torch.Generator``
through ``ops/image_ops``; their stream differs from ``jax.random``'s.

``sft_train_step`` differentiates the loss with respect to the adapter
(vision tower and projector parts included when present) and applies the
AdamW of ``engine/train_state`` (ZeRO-1 over a data group).

Over a data group (``model.mesh``) each rank holds its rows of the global
batch.  The cross-entropy is a token mean over all ranks' rows: each rank
divides its sum by the global count over the group's size (the count
``all_reduce``d, detached), so the mean of the ranks' losses and
gradients is the global batch's even when ranks hold different token
counts; the logged stats are those means.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from opadpo_torch.constants import IGNORE_INDEX
from opadpo_torch.engine.train_state import AdamW, TrainState
from opadpo_torch.models import llava as llava_model
from opadpo_torch.models.llava import Llava
from opadpo_torch.models.lora import named_leaves, tree_get
from opadpo_torch.ops import image_ops
from opadpo_torch.ops.logprobs import chunked_logprobs
from opadpo_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class SftConfig:
    """OPA recipe (run/train_opa.sh:31-50, llava_training_base.yaml)."""

    entropy_loss: bool = False
    entropy_mask_method: str = "random"   # random | blockwise | attention
    entropy_mask_ratio: float = 0.3
    entropy_loss_coef: float = 0.0
    lora_scaling: float = 2.0             # alpha 512 / r 256


def _readout(model: Llava, sft: SftConfig, lora, hidden, sp_labels,
             with_entropy: bool):
    """(logprobs [B, S-1], entropies [B, S] or None, shifted labels
    [B, S-1]): position t scored against label t + 1, the last position
    against ``IGNORE_INDEX``."""
    shifted = F.pad(sp_labels[:, 1:], (0, 1), value=IGNORE_INDEX)
    lp, ent = chunked_logprobs(
        hidden, model.llama.lm_head.weight, shifted, IGNORE_INDEX,
        with_entropy=with_entropy,
        head_lora=tree_get(lora, "llama", "lm_head"),
        lora_scaling=sft.lora_scaling, tp=model.llama.tp)
    return lp[:, :-1], ent, shifted[:, :-1]


def _masked_ce(lp, valid, mesh=None):
    count = valid.sum()
    if mesh is not None and mesh.data > 1:
        count = comm.all_reduce_(count.detach().clone(),
                                 mesh.data_group) / mesh.data
    return -(lp * valid).sum() / torch.clamp(count, min=1e-9)


def sft_loss(lora, model: Llava, sft: SftConfig,
             batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: input_ids [B, L] (the templated conversation with one image
    token), labels [B, L] (``IGNORE_INDEX`` outside the assistant turns),
    attention_mask [B, L], images [B, H, W, 3].  -> (loss, stats with
    ``loss/base_sft``, ``loss/total`` and, with the entropy branch,
    ``loss/mask_sft`` and ``loss/entropy``)."""
    ids, labels = batch["input_ids"], batch["labels"]
    mask, images = batch["attention_mask"], batch["images"]
    scaling = sft.lora_scaling
    mesh = getattr(model, "mesh", None)
    out = llava_model.forward(model, ids, mask, images, lora=lora,
                              lora_scaling=scaling, labels=labels,
                              return_hidden=True)
    sp_labels = out["labels"]
    lp, entropies, shift_labels = _readout(model, sft, lora, out["hidden"],
                                           sp_labels, sft.entropy_loss)
    valid = (shift_labels != IGNORE_INDEX).float()
    ce_loss = _masked_ce(lp, valid, mesh)
    stats = {"loss/base_sft": ce_loss}
    loss = ce_loss

    if sft.entropy_loss:
        method, ratio = sft.entropy_mask_method, sft.entropy_mask_ratio
        masked, img_key_mask = images, None
        if method == "attention":
            img_key_mask = image_ops.mask_patches_per_row(
                generator, ids.shape[0], model.cfg.num_patches, ratio,
                device=images.device)
        elif method == "random":
            masked = image_ops.mask_images_random(generator, images, ratio)
        elif method == "blockwise":
            masked = image_ops.mask_images_blockwise(generator, images, ratio)
        else:
            raise NotImplementedError(method)
        new_out = llava_model.forward(
            model, ids, mask, masked, lora=lora, lora_scaling=scaling,
            labels=labels, image_key_mask=img_key_mask, return_hidden=True)
        mlp, new_entropies, _ = _readout(model, sft, lora, new_out["hidden"],
                                         sp_labels, True)
        emask = (sp_labels != IGNORE_INDEX).float()
        ent_loss = (-((new_entropies - entropies) * emask).sum(-1)
                    / torch.clamp(emask.sum(-1), min=1e-9)).mean()
        loss = loss + ent_loss * sft.entropy_loss_coef
        stats["loss/mask_sft"] = _masked_ce(mlp, valid, mesh)
        stats["loss/entropy"] = ent_loss

    stats["loss/total"] = loss
    return loss, comm.global_stats(
        {k: (v, torch.ones_like(v)) for k, v in stats.items()}, mesh)


def sft_train_step(state: TrainState, model: Llava, batch: dict,
                   optimizer: AdamW, sft: SftConfig,
                   generator: Optional[torch.Generator] = None):
    """One gradient step over the adapter ``state.params``, updated in
    place -> (state, stats with ``loss/grad_norm``)."""
    leaves = [t for _, t in named_leaves(state.params)]
    loss, stats = sft_loss(state.params, model, sft, batch, generator)
    grads = list(torch.autograd.grad(loss, leaves))
    state = optimizer.apply_gradients(state, grads)
    stats["loss/grad_norm"] = optimizer.last_grad_norm
    return state, stats
