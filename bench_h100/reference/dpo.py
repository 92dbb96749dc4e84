"""The OPA-DPO step in plain PyTorch: the frozen adapter's scoring pass, the
policy's four token-weighted sigmoid-DPO pairs with CoPO and the AncPO
anchor, the global-norm clip and AdamW.  Follows the OPA-DPO paper's
training code (its ``compute_policy_loss``) and optax's ``adamw``.

- pair 1: ground truth over the original response;
- pair 2: the AI-corrected response over the original, each token weighted
  by its sentence's score;
- pair 3: ground truth with the image over ground truth with the masked
  image (CoPO);
- pair 4: the AI-corrected response likewise, weighted by the image
  relation on both sides;
- each pair's loss is ``-log sigmoid(beta * logits)`` averaged over every
  position of [B, R], pads included;
- total = pair 1 + pair 2 + 0.2 (pair 3 + pair 4) + the mean of the mDPO
  anchor terms on the four chosen rewards.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference.llava import Llava

KEYS = ("standard_response", "original_generate_response",
        "AI_pseudo_response")


def masked_images(images, generator, ratio: float):
    """int(H W ratio) pixels of each image, the smallest of one uniform draw
    per pixel from ``generator``, set to the image's mean."""
    b, h, w, _ = images.shape
    noise = torch.rand((b, h * w), generator=generator,
                       device=generator.device).to(images.device)
    count = int(h * w * ratio)
    kth = torch.kthvalue(noise, count, dim=1, keepdim=True).values
    m = (noise <= kth).view(b, h, w, 1)
    return torch.where(m, images.mean(dim=(1, 2, 3), keepdim=True), images)


def logprobs(model: Llava, batch: dict, images, keys, lora, scaling):
    feats = model.vision_features(images)
    return model.response_logprobs(
        batch["queries"], batch["queries_attention_mask"], feats,
        tuple(batch[k] for k in keys),
        tuple(batch[k + "_attention_mask"] for k in keys), lora,
        scaling).unbind(1)


def pair_loss(beta, chosen, rejected, cs=1.0, rs=1.0):
    return -F.logsigmoid(beta * (cs * chosen - rs * rejected)).mean()


def loss(model: Llava, batch: dict, masked, ref: dict, lora, tp: dict,
         scaling: float):
    beta = tp["beta"]
    std, orig, ai = logprobs(model, batch, batch["images"], KEYS, lora,
                             scaling)
    mstd, mai = logprobs(model, batch, masked, (KEYS[0], KEYS[2]), lora,
                         scaling)
    r_std, r_orig, r_ai = (lp - ref[k] for lp, k in
                           ((std, "std"), (orig, "orig"), (ai, "ai")))
    r_mstd, r_mai = mstd - ref["mstd"], mai - ref["mai"]
    ai_s = batch["AI_pseudo_response_scores"]
    orig_s = batch["original_generate_response_scores"]
    rel = batch["AI_pseudo_response_image_relations"]
    total = (pair_loss(beta, r_std, r_orig)
             + pair_loss(beta, r_ai, r_orig, ai_s, orig_s)
             + tp["CoPO_coef"] * (pair_loss(beta, r_std, r_mstd)
                                  + pair_loss(beta, r_ai, r_mai, rel, rel)))
    c_std, c_ai = beta * r_std, beta * r_ai
    anchor = (-F.logsigmoid(c_std) - F.logsigmoid(-c_ai)
              - F.logsigmoid(c_std) - F.logsigmoid(-c_ai)).mean()
    return total + anchor


@torch.no_grad()
def score(model: Llava, batch: dict, masked, ref_lora, scaling) -> dict:
    std, orig, ai = logprobs(model, batch, batch["images"], KEYS, ref_lora,
                             scaling)
    mstd, mai = logprobs(model, batch, masked, (KEYS[0], KEYS[2]), ref_lora,
                         scaling)
    return {"std": std, "orig": orig, "ai": ai, "mstd": mstd, "mai": mai}


def leaves(lora: list) -> list:
    """(name, tensor) of the adapter, ``layers.<i>.<linear>.<a|b>``."""
    return [(f"layers.{i}.{n}.{ab}", e[ab])
            for i, layer in enumerate(lora) for n, e in sorted(layer.items())
            for ab in ("a", "b")]
