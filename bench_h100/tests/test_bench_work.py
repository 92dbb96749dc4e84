"""``work.py`` against counts worked out by hand."""

import pytest

from bench_h100 import work

TOY = {"hidden_size": 8, "intermediate_size": 16, "num_attention_heads": 2,
       "num_key_value_heads": 2, "num_hidden_layers": 1, "vocab_size": 10,
       "vision": {"hidden_size": 4, "intermediate_size": 8, "patch_size": 2,
                  "image_size": 4, "num_hidden_layers": 2,
                  "mm_vision_select_layer": -2},
       "projector": {"in_features": 4, "out_features": 8},
       "training": {"lora_r": 2}}
BF16 = {"bits": 16, "act_bits": 16, "act_bwd_int8": False}
W8A8 = {"bits": 8, "act_bits": 8, "act_bwd_int8": True}


def test_causal_pairs():
    # prefix of 3: 1 + 2 + 3 pairs; a response of 2 after it: 4 + 5
    assert work.causal_pairs(3, [2]) == (6, 9)
    assert work.causal_pairs(3, [2, 1]) == (6, 9 + 4)


def test_decoder_pass_forward_by_hand():
    cnt = work.Count()
    work.decoder_pass(TOY, BF16, lora_r=2, tokens=5, pairs=9, head_rows=2,
                      backward=False, cnt=cnt)
    base = 2 * (4 * 8 * 8 + 3 * 8 * 16) * 5          # seven linears
    lora = 2 * 2 * (4 * 16 + 3 * 24) * 5             # r (in + out) each
    att = 4 * 8 * 9
    head = 2 * 8 * 10 * 2
    assert cnt.c["bf16"] == base + lora + att + head
    assert cnt.c["attention.flops"] == att
    assert cnt.c["int8"] == 0


def test_backward_counts_dx_of_the_base_and_twice_the_adapter():
    fwd, both = work.Count(), work.Count()
    work.decoder_pass(TOY, BF16, 2, 5, 9, 2, False, fwd)
    work.decoder_pass(TOY, BF16, 2, 5, 9, 2, True, both)
    base = 2 * (4 * 8 * 8 + 3 * 8 * 16) * 5
    lora = 2 * 2 * (4 * 16 + 3 * 24) * 5
    att, head = 4 * 8 * 9, 2 * 8 * 10 * 2
    assert both.c["bf16"] == 2 * base + 3 * lora + 3 * att + 2 * head
    assert both.c["bytes"] == 2 * fwd.c["bytes"]


def test_w8a8_moves_the_base_to_int8_only():
    cnt = work.Count()
    work.decoder_pass(TOY, W8A8, 2, 5, 9, 2, False, cnt)
    base = 2 * (4 * 8 * 8 + 3 * 8 * 16) * 5
    assert cnt.c["int8"] == cnt.c["quant_mm.flops"] == base
    assert cnt.c["bf16"] == 2 * 2 * (4 * 16 + 3 * 24) * 5 + 4 * 8 * 9 \
        + 2 * 8 * 10 * 2


def test_vision_forward_by_hand():
    cnt = work.Count()
    work.vision_pass(cnt, TOY, BF16, images=1)
    s = 4 + 1                                  # 2 x 2 patches and the CLS
    lin = 2 * (4 * 4 * 4 + 2 * 4 * 8) * s      # one active block
    att = 4 * 4 * s * s
    patch = 2 * 4 * 3 * 2 * 2 * 4
    proj = 2 * 4 * (4 * 8 + 8 * 8)
    assert cnt.c["bf16"] == lin + att + patch + proj


def test_dpo_step_is_its_passes():
    got = work.dpo_step(TOY, BF16, [3, 4], [[2, 1, 3], [1, 1, 1]])
    cnt = work.Count()
    work.vision_pass(cnt, TOY, BF16, 4)
    for backward in (False, True):
        for types in ((0, 1, 2), (0, 2)):
            tokens = pairs = rows = 0
            for p, rs in zip([3, 4], [[2, 1, 3], [1, 1, 1]]):
                sel = [rs[t] for t in types]
                pp, pr = work.causal_pairs(p, sel)
                tokens, pairs, rows = tokens + p + sum(sel), \
                    pairs + pp + pr, rows + sum(sel)
            work.decoder_pass(TOY, BF16, 2, tokens, pairs, rows, backward,
                              cnt)
    n_lora = 2 * (4 * 16 + 3 * 24)
    assert got["bf16"] == cnt.c["bf16"]
    assert got["bytes"] == pytest.approx(cnt.c["bytes"] + n_lora * 28)


def test_least_seconds_takes_the_longer_bound():
    w = {"bf16": 989e12, "int8": 1979e12, "bytes": 3.35e12}
    assert work.least_seconds(w) == pytest.approx(2.0)
    w["bytes"] = 3.35e13
    assert work.least_seconds(w) == pytest.approx(10.0)
