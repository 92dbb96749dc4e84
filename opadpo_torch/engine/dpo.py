"""OPA-DPO engine: port of ``opadpo_tpu/engine/dpo.py``.

Token-weighted multi-pair DPO with CoPO and AncPO, on the reference's
numerics:

- per-token logprobs over the response positions of temperature-scaled
  logits, zero at pad positions;
- ``dpo_loss``: sigmoid DPO on per-token logratios, optionally weighted by
  per-token chosen / rejected scores;
- four pairs: GT > generated, AI-corrected > generated (score-weighted),
  and unmasked > masked image for both (CoPO), plus the AncPO/mDPO anchor;
- total = l1 std_coef + l2 AI_coef + (l3 std_coef + l4 AI_coef) CoPO_coef
  + AncPO Anchor_coef.

``rollout_score`` scores the batch under the frozen reference adapter (no
gradients) and draws the CoPO masks; ``dpo_train_step`` differentiates the
loss with respect to the policy adapter and applies AdamW.  Images are
encoded once per forward and the K response types share one (query +
image) prefix (``shared_prefix``), as in the JAX package.

A batch is a dict of tensors on the model's device with the JAX package's
keys; the rollout adds its outputs under the JAX package's keys too.

Over a data group (``model.mesh``) each rank holds its rows of the global
batch, all ranks the same number: the loss is a mean over rows, so the
mean of the ranks' gradients (taken by the optimizer) is the global
batch's, and every stat is taken over the global batch (a masked mean as
the sum over all ranks' tokens over their count, a row mean as the mean
of the ranks' means), with one ``all_reduce``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from opadpo_torch.engine.train_state import AdamW, TrainState
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models import llava as llava_model
from opadpo_torch.models.llava import Llava
from opadpo_torch.models.lora import named_leaves, tree_get
from opadpo_torch.ops import image_ops
from opadpo_torch.ops.logprobs import chunked_logprobs
from opadpo_torch.parallel import comm
from opadpo_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class DpoConfig:
    """Production recipe defaults (the reference's train_opa_dpo.sh)."""

    beta: float = 0.1
    label_smoothing: float = 0.0
    temperature: float = 1.0
    reference_free: bool = False
    f_divergence_type: str = "reverse_kl"     # "reverse_kl" | "js_divergence"
    standard_pair_coef: float = 1.0
    AI_pair_coef: float = 1.0
    CoPO: bool = True
    CoPO_method: str = "random"               # random | blockwise | attention
    CoPO_mask_ratio: float = 0.3
    CoPO_coef: float = 0.2
    AncPO: bool = True
    mDPO_anchor: bool = True
    Anchor_value: float = 0.0
    Anchor_coef: float = 1.0
    detailed_report: bool = True
    response_score: bool = True
    response_image_relation: bool = True
    response_len: int = 896
    query_len: int = 128
    pad_token_id: int = 0
    lora_scaling: float = 2.0                 # alpha 512 / r 256
    shared_prefix: bool = True


RESPONSE_KEYS = ("standard_response", "original_generate_response",
                 "AI_pseudo_response")


# ---------------------------------------------------------------------------
# Multi-response scoring forward
# ---------------------------------------------------------------------------

def score_responses(model: Llava, dpo: DpoConfig, queries, query_mask,
                    images, responses: tuple, response_masks: tuple,
                    lora=None, image_key_mask=None, remat: bool = True,
                    with_entropy: bool = False) -> dict:
    """One decoder forward over K response types, the images encoded once.
    queries [B, Lq] left-padded with one image token each; responses and
    masks K x [B, R].  Returns dict(logprobs=K x [B, R], and entropies=K x
    [B, R] when ``with_entropy``), zero at pad positions."""
    fn = _score_shared if dpo.shared_prefix else _score_stacked
    return fn(model, dpo, queries, query_mask, images, responses,
              response_masks, lora, image_key_mask, remat, with_entropy)


def _readout(model: Llava, dpo: DpoConfig, hidden, labels, lora,
             with_entropy: bool):
    llama_lora = tree_get(lora, "llama")
    return chunked_logprobs(
        hidden, model.llama.lm_head.weight, labels, dpo.pad_token_id,
        temperature=dpo.temperature, with_entropy=with_entropy,
        head_lora=tree_get(llama_lora, "lm_head"),
        lora_scaling=dpo.lora_scaling, tp=model.llama.tp)


def _score_stacked(model, dpo, queries, query_mask, images, responses,
                   response_masks, lora, image_key_mask, remat,
                   with_entropy):
    """The K responses stacked on the batch axis (type-major), each row
    carrying its own copy of the prefix."""
    b = queries.shape[0]
    k = len(responses)
    r = responses[0].shape[1]
    scaling = dpo.lora_scaling
    feats = llava_model.encode_images(model, images, lora, scaling)
    ids = torch.cat([torch.cat([queries, x], dim=1) for x in responses])
    text_mask = torch.cat([torch.cat([query_mask, m], dim=1)
                           for m in response_masks])
    img_mask = None if image_key_mask is None else image_key_mask.repeat(k, 1)
    text_embeds = llama_model.embed_tokens(model.llama, ids)
    embeds, key_mask = llava_model.splice_sequence(
        text_embeds, feats.repeat(k, 1, 1).to(text_embeds.dtype), text_mask,
        llava_model.splice_positions(ids), image_mask=img_mask)
    hidden = llama_model.forward(
        model.llama, embeds, key_mask, llava_model.spliced_positions(key_mask),
        lora=tree_get(lora, "llama"), lora_scaling=scaling, remat=remat,
        return_hidden=True)
    lp, ent = _readout(model, dpo, hidden[:, -r - 1:-1], ids[:, -r:], lora,
                       with_entropy)
    resp_mask = torch.cat(response_masks).float()
    out = {"logprobs": tuple((lp * resp_mask).split(b))}
    if with_entropy:
        out["entropies"] = tuple((ent * resp_mask).split(b))
    return out


def _score_shared(model, dpo, queries, query_mask, images, responses,
                  response_masks, lora, image_key_mask, remat, with_entropy):
    """The (query + image) prefix once per example; the K responses
    stacked B-major (row b*K + t) attend to it."""
    b = queries.shape[0]
    k = len(responses)
    r = responses[0].shape[1]
    scaling = dpo.lora_scaling
    feats = llava_model.encode_images(model, images, lora, scaling)
    text_embeds = llama_model.embed_tokens(model.llama, queries)
    prefix_embeds, prefix_mask = llava_model.splice_sequence(
        text_embeds, feats.to(text_embeds.dtype), query_mask,
        llava_model.splice_positions(queries), image_mask=image_key_mask)
    prefix_positions = llava_model.spliced_positions(prefix_mask)

    ids_r = torch.stack(responses, dim=1).reshape(b * k, r)
    mask_r = torch.stack(response_masks, dim=1).reshape(b * k, r).long()
    resp_embeds = llama_model.embed_tokens(model.llama, ids_r)
    prefix_valid = prefix_mask.sum(dim=1).repeat_interleave(k)
    resp_positions = torch.clamp(
        prefix_valid[:, None] + torch.cumsum(mask_r, dim=1) - 1, min=0)

    hp, hr = llama_model.forward_shared_prefix(
        model.llama, prefix_embeds, prefix_mask, prefix_positions,
        resp_embeds, mask_r, resp_positions, lora=tree_get(lora, "llama"),
        lora_scaling=scaling, remat=remat)
    # the positions that predict response token j: the prefix's last slot
    # (valid: queries are left-padded), then response slots 0..R-2
    hidden = torch.cat([hp[:, -1:].repeat_interleave(k, dim=0), hr[:, :-1]],
                       dim=1)
    lp, ent = _readout(model, dpo, hidden, ids_r, lora, with_entropy)
    lp = (lp * mask_r).reshape(b, k, r)
    out = {"logprobs": tuple(lp.unbind(1))}
    if with_entropy:
        out["entropies"] = tuple((ent * mask_r).reshape(b, k, r).unbind(1))
    return out


# ---------------------------------------------------------------------------
# DPO loss
# ---------------------------------------------------------------------------

def dpo_loss(policy_chosen_logps, policy_rejected_logps,
             reference_chosen_logps, reference_rejected_logps,
             dpo: DpoConfig, chosen_scores=None, rejected_scores=None):
    """Per-token sigmoid DPO -> (losses, chosen_rewards, rejected_rewards)."""
    ref_coef = 0.0 if dpo.reference_free else 1.0
    chosen_lr = policy_chosen_logps - ref_coef * reference_chosen_logps
    rejected_lr = policy_rejected_logps - ref_coef * reference_rejected_logps
    cs = 1.0 if chosen_scores is None else chosen_scores
    rs = 1.0 if rejected_scores is None else rejected_scores
    logits = cs * chosen_lr - rs * rejected_lr
    if dpo.f_divergence_type == "js_divergence":
        logits = logits - (F.softplus(chosen_lr) - F.softplus(rejected_lr))
    ls = dpo.label_smoothing
    losses = (-F.logsigmoid(dpo.beta * logits) * (1 - ls)
              - F.logsigmoid(-dpo.beta * logits) * ls)
    return losses, dpo.beta * chosen_lr, dpo.beta * rejected_lr


# ---------------------------------------------------------------------------
# Rollout: frozen-reference scoring and the CoPO masks
# ---------------------------------------------------------------------------

def _responses(batch):
    return (tuple(batch[k] for k in RESPONSE_KEYS),
            tuple(batch[k + "_attention_mask"] for k in RESPONSE_KEYS))


@torch.no_grad()
def rollout_score(model: Llava, dpo: DpoConfig, ref_lora, batch: dict,
                  generator: torch.Generator) -> dict:
    """Reference-policy pass over a rollout batch: the three response
    types' logprobs and entropies, and with CoPO the masked inputs (drawn
    from ``generator``) and the two masked-image logprobs.  Returns the
    tensors the policy step reads, under the JAX package's keys."""
    with trace.span("dpo.score"):
        return _rollout_score(model, dpo, ref_lora, batch, generator)


def _rollout_score(model, dpo, ref_lora, batch, generator):
    queries, q_mask = batch["queries"], batch["queries_attention_mask"]
    images = batch["images"]
    resp, rmask = _responses(batch)
    out = score_responses(model, dpo, queries, q_mask, images, resp, rmask,
                          lora=ref_lora, remat=False, with_entropy=True)
    result = {}
    for i, key in enumerate(RESPONSE_KEYS):
        result[f"ref_base_{key}_logprobs"] = out["logprobs"][i]
        result[f"ref_base_{key}_entropies"] = out["entropies"][i]
    if dpo.CoPO:
        img_key_mask = None
        masked_images = images
        if dpo.CoPO_method == "random":
            masked_images = image_ops.mask_images_random(
                generator, images, dpo.CoPO_mask_ratio)
        elif dpo.CoPO_method == "blockwise":
            masked_images = image_ops.mask_images_blockwise(
                generator, images, dpo.CoPO_mask_ratio)
        elif dpo.CoPO_method == "attention":
            img_key_mask = image_ops.mask_patches_per_row(
                generator, queries.shape[0], model.cfg.num_patches,
                dpo.CoPO_mask_ratio, device=images.device)
        else:
            raise NotImplementedError(dpo.CoPO_method)
        mask_out = score_responses(
            model, dpo, queries, q_mask, masked_images, (resp[0], resp[2]),
            (rmask[0], rmask[2]), lora=ref_lora, image_key_mask=img_key_mask,
            remat=False)
        result["ref_mask_standard_response_logprobs"] = mask_out["logprobs"][0]
        result["ref_mask_AI_pseudo_response_logprobs"] = mask_out["logprobs"][1]
        if dpo.CoPO_method == "attention":
            result["masked_image_key_mask"] = img_key_mask
        else:
            result["masked_images"] = masked_images
    return result


# ---------------------------------------------------------------------------
# Policy loss and train step
# ---------------------------------------------------------------------------

def _masked_sum(x, mask):
    """(sum of x over mask, the mask's count): a masked mean's parts."""
    m = mask.float()
    return (x * m).sum(), m.sum()


def _mean(x):
    return x.mean(), torch.ones((), dtype=x.dtype, device=x.device)


def _masked_min_rowwise(x, mask):
    return _mean((x * mask + (1 - mask) * 1e9).amin(dim=1))


def _masked_max_rowwise(x, mask):
    return _mean((x * mask + (1 - mask) * -1e9).amax(dim=1))


def dpo_loss_and_stats(lora, model: Llava, dpo: DpoConfig,
                       batch: dict) -> Tuple[torch.Tensor, Dict]:
    """The loss over one minibatch of cached rollouts, and its stats (the
    reference's compute_policy_loss)."""
    queries, q_mask = batch["queries"], batch["queries_attention_mask"]
    images = batch["images"]
    resp, rmask = _responses(batch)
    ref_std = batch["ref_base_standard_response_logprobs"]
    ref_orig = batch["ref_base_original_generate_response_logprobs"]
    ref_ai = batch["ref_base_AI_pseudo_response_logprobs"]
    use_scores = dpo.detailed_report and dpo.response_score
    use_relations = dpo.detailed_report and dpo.response_image_relation
    ai_scores = batch.get("AI_pseudo_response_scores")
    orig_scores = batch.get("original_generate_response_scores")
    ai_relations = batch.get("AI_pseudo_response_image_relations")

    std_lp, orig_lp, ai_lp = score_responses(
        model, dpo, queries, q_mask, images, resp, rmask,
        lora=lora)["logprobs"]
    # pair 1: standard (GT) > original generate
    losses1, cr1, rr1 = dpo_loss(std_lp, orig_lp, ref_std, ref_orig, dpo)
    # pair 2: AI pseudo > original generate, score-weighted
    losses2, cr2, rr2 = dpo_loss(
        ai_lp, orig_lp, ref_ai, ref_orig, dpo,
        chosen_scores=ai_scores if use_scores else None,
        rejected_scores=orig_scores if use_scores else None)
    loss = (losses1.mean() * dpo.standard_pair_coef
            + losses2.mean() * dpo.AI_pair_coef)

    if dpo.CoPO:
        if dpo.CoPO_method == "attention":
            mask_images, img_key_mask = images, batch["masked_image_key_mask"]
        else:
            mask_images, img_key_mask = batch["masked_images"], None
        mask_std_lp, mask_ai_lp = score_responses(
            model, dpo, queries, q_mask, mask_images, (resp[0], resp[2]),
            (rmask[0], rmask[2]), lora=lora,
            image_key_mask=img_key_mask)["logprobs"]
        # pair 3: standard unmasked > standard masked
        losses3, cr3, rr3 = dpo_loss(
            std_lp, mask_std_lp, ref_std,
            batch["ref_mask_standard_response_logprobs"], dpo)
        # pair 4: AI unmasked > AI masked, image-relation weighted both sides
        losses4, cr4, rr4 = dpo_loss(
            ai_lp, mask_ai_lp, ref_ai,
            batch["ref_mask_AI_pseudo_response_logprobs"], dpo,
            chosen_scores=ai_relations if use_relations else None,
            rejected_scores=ai_relations if use_relations else None)
        loss = loss + (losses3.mean() * dpo.standard_pair_coef
                       + losses4.mean() * dpo.AI_pair_coef) * dpo.CoPO_coef
    else:
        zeros = torch.zeros_like(loss)
        losses3 = losses4 = cr3 = rr3 = cr4 = rr4 = zeros
        mask_std_lp = mask_ai_lp = torch.zeros_like(std_lp)

    if dpo.AncPO:
        a = dpo.Anchor_value
        if dpo.mDPO_anchor:
            anc = (-F.logsigmoid(cr1 - a) - F.logsigmoid(-cr2 + a)
                   - F.logsigmoid(cr3 - a) - F.logsigmoid(-cr4 + a))
        else:
            anc = ((cr1 - a) ** 2 + (cr2 - a) ** 2 + (cr3 - a) ** 2
                   + (cr4 - a) ** 2)
        anc_loss = anc.mean()
        loss = loss + anc_loss * dpo.Anchor_coef
    else:
        anc_loss = torch.zeros_like(loss)

    pad = dpo.pad_token_id
    m1c, m1r, m2c = ((x != pad).float() for x in (ref_std, ref_orig, ref_ai))
    std_m, orig_m, ai_m = ((x != 0.0).float()
                           for x in (std_lp, orig_lp, ai_lp))

    parts = {
        "loss/stand_gen": _mean(losses1),
        "loss/AI_gen": _mean(losses2),
        "loss/stand_mask": _mean(losses3),
        "loss/AI_mask": _mean(losses4),
        "loss/AncPO": _mean(anc_loss),
        "policy/stand_gen_chosen_mean": _masked_sum(cr1, m1c),
        "policy/stand_gen_reject_mean": _masked_sum(rr1, m1r),
        "policy/AI_gen_chosen_mean": _masked_sum(cr2, m2c),
        "policy/AI_gen_reject_mean": _masked_sum(rr2, m1r),
        "policy/stand_mask_chosen_mean": _masked_sum(cr3, m1c),
        "policy/stand_mask_reject_mean": _masked_sum(rr3, m1c),
        "policy/AI_mask_chosen_mean": _masked_sum(cr4, m2c),
        "policy/AI_mask_reject_mean": _masked_sum(rr4, m2c),
        "logprobs/standard_logprobs": _masked_sum(std_lp, std_m),
        "logprobs/original_logprobs": _masked_sum(orig_lp, orig_m),
        "logprobs/AI_logprobs": _masked_sum(ai_lp, ai_m),
        "logprobs/standard_mask_logprobs": _masked_sum(mask_std_lp, std_m),
        "logprobs/AI_mask_logprobs": _masked_sum(mask_ai_lp, ai_m),
        "logprobs/standard_logprobs_min": _masked_min_rowwise(std_lp, std_m),
        "logprobs/original_logprobs_min": _masked_min_rowwise(orig_lp,
                                                              orig_m),
        "logprobs/AI_logprobs_min": _masked_min_rowwise(ai_lp, ai_m),
        "logprobs/standard_logprobs_max": _masked_max_rowwise(std_lp, std_m),
        "logprobs/original_logprobs_max": _masked_max_rowwise(orig_lp,
                                                              orig_m),
        "logprobs/AI_logprobs_max": _masked_max_rowwise(ai_lp, ai_m),
    }
    stats = comm.global_stats(parts, getattr(model, "mesh", None))
    for name, (c, r) in (("stand_gen", ("stand_gen_chosen",
                                        "stand_gen_reject")),
                         ("AI_gen", ("AI_gen_chosen", "AI_gen_reject"))):
        stats[f"policy/{name}_gap_mean"] = (stats[f"policy/{c}_mean"]
                                            - stats[f"policy/{r}_mean"])
    return loss, stats


def loss_and_grads(state: TrainState, model: Llava, dpo: DpoConfig,
                   batch: dict):
    """(loss, stats, gradients in ``named_leaves`` order) of the policy
    adapter ``state.params``."""
    leaves = [t for _, t in named_leaves(state.params)]
    with trace.span("dpo.forward"):
        loss, stats = dpo_loss_and_stats(state.params, model, dpo, batch)
    with trace.span("dpo.backward"):
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), stats, list(grads)


def dpo_train_step(state: TrainState, model: Llava, batch: dict,
                   optimizer: AdamW, dpo: DpoConfig):
    """One gradient step over the policy adapter, updated in place ->
    (state, stats with "loss/total" and "loss/grad_norm")."""
    with trace.span("dpo.step"):
        loss, stats, grads = loss_and_grads(state, model, dpo, batch)
        stats["loss/total"] = comm.global_stats(
            {"l": _mean(loss)}, getattr(model, "mesh", None))["l"]
        state = optimizer.apply_gradients(state, grads)
        stats["loss/grad_norm"] = optimizer.last_grad_norm
    return state, stats
