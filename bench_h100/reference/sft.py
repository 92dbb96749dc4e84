"""The OPA LoRA-SFT step in plain PyTorch: the mean cross-entropy of every
labelled next token of the spliced sequence (position t scored against
label t + 1, the image patches and the prompt unlabelled), under the
adapter on the decoder, the vision tower and the projector."""

from __future__ import annotations

from bench_h100.reference.llava import Llava


def loss(model: Llava, batch: dict, lora: dict, scaling: float):
    feats = model.vision_features(batch["images"],
                                  (lora["vision"], lora["projector"]),
                                  scaling)
    lp = model.sft_logprobs(batch["input_ids"], batch["attention_mask"],
                            batch["labels"], feats, lora["llama"], scaling)
    return -lp.mean()


def leaves(lora: dict) -> list:
    """(name, tensor) of the adapter: ``layers.<i>.<linear>.<a|b>``,
    ``vision.layers.<i>.<linear>.<a|b>``, ``projector.<linear>.<a|b>``."""
    out = [(f"layers.{i}.{n}.{ab}", e[ab])
           for i, layer in enumerate(lora["llama"])
           for n, e in sorted(layer.items()) for ab in ("a", "b")]
    out += [(f"vision.layers.{i}.{n}.{ab}", e[ab])
            for i, block in enumerate(lora["vision"])
            for n, e in sorted(block.items()) for ab in ("a", "b")]
    out += [(f"projector.{n}.{ab}", e[ab])
            for n, e in sorted(lora["projector"].items()) for ab in ("a", "b")]
    return out
