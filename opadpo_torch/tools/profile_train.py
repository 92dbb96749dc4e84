"""Where the OPA-DPO training step's time goes: ``torch.profiler`` over one
``rollout_score`` and one ``dpo_train_step`` on LLaVA-1.5-7B (or
``--model 13b``) at full width (random weights and a random OPA-like
adapter from a seed), K = 3 response types of 896 tokens after a 128-token
query: the shapes of ``chip_smoke.py``'s training phases, which build
their batches and adapters with ``make_batch`` and ``make_adapters``.
With bf16 weights it runs the reference recipe (per-device batch 2, LoRA
r 256); with ``--bits 8`` the single-chip recipe
(``configs/llava_dpo_singlechip.yaml``: an int8 base, w8a8 with the int8
backward, LoRA r 64) and with ``--bits 4`` the int4 one
(``llava_dpo_13b_singlechip.yaml``, LoRA r 64), both at batch 1.

    python -m opadpo_torch.tools.profile_train [--model 7b|13b]
        [--bits 16|8|4] [--json PATH]

For each phase it prints the host time (ending in a device synchronise)
with and without the profiler, the device's busy time and share, and the
device time by kernel group and by kernel.  ``--device cpu`` rehearses the
control flow on the tiny model on the CPU, where there are no device
times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from opadpo_torch.constants import IMAGE_TOKEN_INDEX
from opadpo_torch.device import resolve_device
from opadpo_torch.engine import dpo as dpo_engine
from opadpo_torch.engine.train_state import AdamW, OptimizerConfig, TrainState
from opadpo_torch.models import llava
from opadpo_torch.models.lora import LoraConfig, make_trainable
from opadpo_torch.ops.quant import QuantMode
from opadpo_torch.tools.profile_serving import make_model, summarise

# the reference recipe (configs/llava_dpo.yaml, llava_training_base.yaml)
RECIPE_LORA = LoraConfig(rank=256, alpha=512.0)
RECIPE_OPT = OptimizerConfig(learning_rate=1e-6, lr_scheduler_type="cosine",
                             warmup_steps=5, total_steps=500,
                             max_grad_norm=1.0)
# the single-chip recipes on a quantized base (llava_dpo_singlechip.yaml,
# llava_dpo_13b_singlechip.yaml)
SINGLE_CHIP_LORA = LoraConfig(rank=64, alpha=128.0)


def make_batch(cfg: llava.LlavaConfig, dpo: dpo_engine.DpoConfig, batch: int,
               generator: torch.Generator) -> dict:
    """A random DPO batch on the generator's device: queries of
    ``dpo.query_len`` tokens, left-padded by 0, Lq/6, 2 Lq/6, ... tokens,
    BOS then the image token first; three response types of
    ``dpo.response_len`` tokens with pad tails of different lengths;
    response scores and image relations in [1, 2.5]; normalised-scale
    random images."""
    dev = generator.device
    lq, r, v = dpo.query_len, dpo.response_len, cfg.llama.vocab_size

    def ids(n, length):
        return torch.randint(3, v, (n, length), generator=generator,
                             device=dev)

    pad = torch.arange(batch, device=dev) * (lq // 6)
    q_mask = (torch.arange(lq, device=dev)[None] >= pad[:, None]).long()
    queries = torch.where(q_mask != 0, ids(batch, lq), 0)
    queries[torch.arange(batch, device=dev), pad] = 1
    queries[torch.arange(batch, device=dev), pad + 1] = IMAGE_TOKEN_INDEX
    sz = cfg.vision.image_size
    out = {"queries": queries, "queries_attention_mask": q_mask,
           "images": torch.randn(batch, sz, sz, 3, generator=generator,
                                 device=dev)}
    for i, key in enumerate(dpo_engine.RESPONSE_KEYS):
        length = r - (torch.arange(batch, device=dev) * 97 + 31 * i) % (r // 2)
        mask = (torch.arange(r, device=dev)[None] < length[:, None]).long()
        out[key] = torch.where(mask != 0, ids(batch, r), 0)
        out[key + "_attention_mask"] = mask
    mask = out["AI_pseudo_response_attention_mask"]
    scores = 1.0 + 1.5 * torch.rand(batch, r, generator=generator, device=dev)
    out["AI_pseudo_response_scores"] = scores * mask
    out["original_generate_response_scores"] = scores.flip(1) * mask
    out["AI_pseudo_response_image_relations"] = (scores * 0.5 + 0.5) * mask
    return out


def make_adapters(cfg: llava.LlavaConfig, lora_cfg: LoraConfig,
                  generator: torch.Generator, b_std: float = 2e-3):
    """(frozen reference adapter, trainable policy adapter): an OPA-like
    adapter (Kaiming A, B drawn N(0, b_std)) and a copy of it to train, as
    stage 4 starts the policy from the OPA adapter."""
    ref = llava.init_lora(cfg, lora_cfg, generator)
    for layer in ref["llama"]["layers"]:
        for entry in layer.values():
            entry["b"] = (torch.randn(entry["b"].shape, generator=generator,
                                      device=generator.device)
                          * b_std).to(lora_cfg.dtype)
    return ref, make_trainable(ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cpu runs the tiny model instead of the 7B / 13B")
    ap.add_argument("--model", choices=("7b", "13b"), default="7b")
    ap.add_argument("--bits", type=int, choices=(16, 8, 4), default=16,
                    help="the base's block linears: bf16, int8 or int4")
    ap.add_argument("--json", help="also write the summary here")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mode = QuantMode(act_bits=8, bwd_int8=True) if args.bits == 8 else None
    cfg, model, gen = make_model(args.model, args.bits, dev, cuda, mode=mode)
    b = 2 if args.bits == 16 else 1
    if cuda:
        dpo = dpo_engine.DpoConfig()
        lcfg = RECIPE_LORA if args.bits == 16 else SINGLE_CHIP_LORA
    else:
        dpo = dpo_engine.DpoConfig(response_len=8, query_len=6)
        lcfg = LoraConfig(rank=4, alpha=8.0)
    ref, policy = make_adapters(cfg, lcfg, gen)
    batch = make_batch(cfg, dpo, b, gen)
    opt = AdamW(RECIPE_OPT)
    state = TrainState.create(policy, opt.cfg)

    def rollout():
        return dpo_engine.rollout_score(model, dpo, ref, batch, gen)

    def step(full):
        return dpo_engine.dpo_train_step(state, model, full, opt, dpo)

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        return out, time.perf_counter() - t0

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0] if cuda else "cpu"
    result = {"card": card,
              "model": f"llava_{args.model}" if cuda else "tiny",
              "bits": args.bits, "batch": b, "query_len": dpo.query_len,
              "response_len": dpo.response_len, "lora_rank": lcfg.rank}
    full = {**batch, **rollout()}                       # warm-up
    step(full)
    phases = {}
    for name, fn, a in (("rollout_score", rollout, ()),
                        ("dpo_train_step", step, (full,))):
        _, plain_s = timed(fn, *a)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with profile(activities=acts) as prof:
            _, host_s = timed(fn, *a)
        kernels = [(e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA]
        if cuda and not kernels:
            raise RuntimeError("the profiler recorded no device events")
        summary = summarise(kernels, host_s, top=16)
        summary["device_busy_share_unprofiled"] = \
            summary["device_busy_ms"] / (plain_s * 1e3)
        if cuda:
            summary["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        phases[name] = {"unprofiled_ms": plain_s * 1e3, **summary}
    result["phases"] = phases
    print(json.dumps(result, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
