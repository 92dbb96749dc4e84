"""The work a step needs, counted from its shapes alone: operations by the
precision the configuration states, and the bytes the device has to move
at least.  Whatever kernel or library call does the work, the count is the
same, so ``mfu.*`` and ``roofline.*`` keep their meaning when an
implementation changes.

Conventions:

- a product of [m, k] and [k, n] is 2 m k n operations;
- attention counts only the query-key pairs the mask allows (the causal
  half, the valid keys): 4 d operations a pair forward (QK^T and PV over
  all heads), twice that backward (dQ, dK, dV, dP; no recompute);
- only valid tokens count, never padding;
- the frozen base needs no weight gradient: its backward is the dx
  product alone; an adapter's backward is its dx and its dA, dB;
- recompute under remat is not counted;
- the base's block linears count at int8 where the configuration runs
  w8a8 (int8 weights and activations), else at bf16; every other product
  (adapters, the head, attention, patch embedding, projector) at bf16,
  f32 accumulation included;
- bytes: each weight read once per forward pass and once per backward
  pass, the adapter's parameters, gradients and moments read and written
  once per update; activations are left out, so the byte count is a floor.

Peaks: NVIDIA's data sheet for the H100 SXM, dense: 989 TFLOP/s bf16,
1,979 TOP/s int8, 3.35 TB/s HBM3.
"""

from __future__ import annotations

PEAK = {"bf16": 989e12, "int8": 1979e12, "hbm": 3.35e12}


def decoder_linears(cfg: dict) -> list:
    """(in, out) of the decoder's seven block linears."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hd = d // cfg["num_attention_heads"]
    nq = cfg["num_attention_heads"] * hd
    nkv = cfg["num_key_value_heads"] * hd
    return [(d, nq), (d, nkv), (d, nkv), (nq, d), (d, f), (d, f), (f, d)]


def clip_linears(cfg: dict) -> list:
    v = cfg["vision"]
    vd, vi = v["hidden_size"], v["intermediate_size"]
    return [(vd, vd)] * 4 + [(vd, vi), (vi, vd)]


def w8a8(precision: dict) -> bool:
    return precision["bits"] == 8 and precision["act_bits"] == 8


def weight_bytes(precision: dict) -> float:
    return {16: 2.0, 8: 1.0, 4: 0.5}[precision["bits"]]


def causal_pairs(prefix: int, responses) -> tuple:
    """(pairs within the prefix, pairs of the responses) of one example:
    the prefix causal over itself, each response over the prefix and
    causally over itself."""
    pp = prefix * (prefix + 1) // 2
    pr = sum(r * prefix + r * (r + 1) // 2 for r in responses)
    return pp, pr


class Count:
    """Operations by class and precision, and bytes."""

    def __init__(self):
        self.c = {"bf16": 0.0, "int8": 0.0, "bytes": 0.0,
                  "attention.flops": 0.0, "attention.bytes": 0.0,
                  "quant_mm.flops": 0.0, "quant_mm.bytes": 0.0}

    def add(self, key: str, v: float) -> None:
        self.c[key] += v


def vision_pass(cnt: Count, cfg: dict, precision: dict, images: int,
                backward: bool = False, lora_r: int = 0) -> None:
    """The CLIP tower's active blocks and the projector over ``images``;
    with ``backward`` also the gradient pass the adapters of rank
    ``lora_r`` on the blocks' six linears and the projector's two need."""
    v = cfg["vision"]
    vd, p = v["hidden_size"], v["patch_size"]
    n = (v["image_size"] // p) ** 2
    s = n + 1
    layers = v["num_hidden_layers"] + v["mm_vision_select_layer"] + 1
    mult = 2 if backward else 1
    lin = sum(2 * i * o for i, o in clip_linears(cfg)) * s * layers * images
    cnt.add("int8" if w8a8(precision) else "bf16", lin * mult)
    if w8a8(precision):
        cnt.add("quant_mm.flops", lin * mult)
        cnt.add("quant_mm.bytes", mult * images * layers * sum(
            i * o + s * i + 2 * s * o for i, o in clip_linears(cfg)))
    att = 4 * vd * s * s * layers * images
    pin, pout = cfg["projector"]["in_features"], \
        cfg["projector"]["out_features"]
    lora = 0
    if lora_r:
        lora = images * (sum(2 * lora_r * (i + o) for i, o in
                             clip_linears(cfg)) * s * layers
                         + 2 * lora_r * n * (pin + 3 * pout))
    cnt.add("bf16", att * (3 if backward else 1) + lora * (3 if backward
                                                           else 1))
    cnt.add("attention.flops", att * (3 if backward else 1))
    cnt.add("attention.bytes", (4 + (8 if backward else 0)) * s * vd * 2
            * layers * images)
    cnt.add("bf16", images * (2 * n * 3 * p * p * vd
                              + mult * 2 * n * (pin * pout + pout * pout)))
    cnt.add("bytes", mult * (layers * sum(i * o for i, o in
                                          clip_linears(cfg))
                             * weight_bytes(precision)
                             + 2 * (pin * pout + pout * pout))
            + 2 * 3 * p * p * vd)


def decoder_pass(cfg: dict, precision: dict, lora_r: int, tokens: int,
                 pairs: int, head_rows: int, backward: bool,
                 cnt: Count) -> None:
    """One pass of the decoder over ``tokens`` valid positions with
    ``pairs`` allowed attention pairs and ``head_rows`` rows of the head;
    with ``backward`` also its gradient pass."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    layers = cfg["num_hidden_layers"]
    lins = decoder_linears(cfg)
    base = sum(2 * i * o for i, o in lins) * tokens * layers
    lora = sum(2 * lora_r * (i + o) for i, o in lins) * tokens * layers
    att = 4 * d * pairs * layers
    head = 2 * d * v * head_rows
    mult = 2 if backward else 1                 # base and head: dx only
    q8 = w8a8(precision)
    cnt.add("int8" if q8 else "bf16", base * mult)
    if q8:
        cnt.add("quant_mm.flops", base * mult)
        cnt.add("quant_mm.bytes", mult * layers * sum(
            i * o + tokens * i + 2 * tokens * o for i, o in lins))
    cnt.add("bf16", lora * (3 if backward else 1) + head * mult
            + att * (3 if backward else 1))
    cnt.add("attention.flops", att * (3 if backward else 1))
    cnt.add("attention.bytes", (4 + (8 if backward else 0)) * tokens * d * 2
            * layers)
    wb = (sum(i * o for i, o in lins) * layers * weight_bytes(precision)
          + 2 * v * d)
    cnt.add("bytes", wb * mult)


def dpo_step(cfg: dict, precision: dict, prefix: list,
             responses: list) -> dict:
    """One OPA-DPO step: the frozen adapter's scoring of the three
    responses with the image and of two with the masked image, and the
    policy's forward and backward over the same.  ``prefix`` [B] valid
    prefix positions (query and patches), ``responses`` [B][3] valid
    response lengths (ground truth, original, AI-corrected)."""
    cnt = Count()
    r = cfg["training"]["lora_r"]
    vision_pass(cnt, cfg, precision, 2 * len(prefix))
    for backward in (False, True):
        for types in ((0, 1, 2), (0, 2)):
            tokens = pairs = rows = 0
            for p, rs in zip(prefix, responses):
                sel = [rs[t] for t in types]
                pp, pr = causal_pairs(p, sel)
                tokens += p + sum(sel)
                pairs += pp + pr
                rows += sum(sel)
            decoder_pass(cfg, precision, r, tokens, pairs, rows, backward,
                         cnt)
    n_lora = sum(r * (i + o) for i, o in decoder_linears(cfg)) \
        * cfg["num_hidden_layers"]
    cnt.add("bytes", n_lora * 4 * 7)
    return dict(cnt.c)


def least_seconds(work: dict) -> float:
    """The least time the card could take for ``work``: its operations at
    the peak of their precision, or its bytes at the HBM rate, whichever
    is longer."""
    return max(work["bf16"] / PEAK["bf16"] + work["int8"] / PEAK["int8"],
               work["bytes"] / PEAK["hbm"])


def least_seconds_of(work: dict, cls: str, precision: str) -> float:
    """The same for one class of kernels (``attention`` at bf16,
    ``quant_mm`` at int8)."""
    return max(work[cls + ".flops"] / PEAK[precision],
               work[cls + ".bytes"] / PEAK["hbm"])


def sft_step(cfg: dict, precision: dict, lengths: list,
             labelled: list) -> dict:
    """One OPA-SFT micro-step: forward and backward through the vision
    tower, the projector and the decoder, all three under adapters.
    ``lengths`` [B] valid spliced positions of each row (right-padded, so
    causal over a valid prefix), ``labelled`` [B] positions scored."""
    cnt = Count()
    r = cfg["training"]["lora_r"]
    vision_pass(cnt, cfg, precision, len(lengths), True, r)
    decoder_pass(cfg, precision, r, sum(lengths),
                 sum(s * (s + 1) // 2 for s in lengths), sum(labelled),
                 True, cnt)
    v = cfg["vision"]
    vd, vi = v["hidden_size"], v["intermediate_size"]
    layers = v["num_hidden_layers"] + v["mm_vision_select_layer"] + 1
    pin, pout = cfg["projector"]["in_features"], \
        cfg["projector"]["out_features"]
    n_lora = r * (sum(i + o for i, o in decoder_linears(cfg))
                  * cfg["num_hidden_layers"]
                  + (4 * 2 * vd + 2 * (vd + vi)) * layers
                  + pin + 3 * pout)
    cnt.add("bytes", n_lora * 4 * 7)
    return dict(cnt.c)
