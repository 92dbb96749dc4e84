"""The one constructor of the serving sampling configuration and of the
continuous engine: port of ``opadpo_tpu/engine/serving_config.py``
(``make_serving_sampling``, ``ENGINE_GEOMETRY``,
``make_continuous_engine``).  The serve CLI, the rollout's slot pool and
the eval drivers build their engines here, so they share one geometry."""

from __future__ import annotations

from typing import Optional

from opadpo_torch.engine.sampling import SamplingConfig

# Rollout sampling recipe (reference run/online_generate.sh:75-77,115-116),
# also the serving default.
SERVING_TEMPERATURE = 1.0
SERVING_TOP_K = 30
SERVING_TOP_P = 0.95

# ContinuousEngine geometry: the cache length, segment and admission groups
ENGINE_GEOMETRY = dict(
    qlen=128,           # prompt bucket (left-pad / left-truncate)
    seg_len=64,         # scheduling quantum
    su_bucket=256,      # watermark bucket of the decode reads
    max_admit_group=4,  # admission prefill groups of 1, 2 or 4
)


def make_serving_sampling(
    *,
    max_new_tokens: int = 512,
    eos_token_id: int = 2,
    pad_token_id: int = 0,
    temperature: float = SERVING_TEMPERATURE,
    top_k: int = SERVING_TOP_K,
    top_p: float = SERVING_TOP_P,
    greedy: bool = False,
    topk_impl: str = "sort",
) -> SamplingConfig:
    return SamplingConfig(
        temperature=temperature, top_k=top_k, top_p=top_p, greedy=greedy,
        topk_impl=topk_impl, eos_token_id=eos_token_id,
        pad_token_id=pad_token_id, max_new_tokens=max_new_tokens)


def make_continuous_engine(
    model,
    sampling: SamplingConfig,
    *,
    lora=None,
    lora_scaling: float = 1.0,
    slots: int = 16,
    kv_bits: int = 8,
    seg_len: Optional[int] = None,
    qlen: Optional[int] = None,
    max_admit_group: Optional[int] = None,
    generator=None,
    spec_k: int = 0,
    spec_draft: str = "ngram",
    collect_spec_stats: bool = False,
    head_bits: int = 16,
):
    """A ``ContinuousEngine`` at ``ENGINE_GEOMETRY``, with the overrides
    given (a large model caps ``max_admit_group`` at 1 or 2), over
    ``model`` as it is: one process's, or a rank's tensor-parallel shard
    (then every rank of its model group builds one, seeded alike)."""
    from opadpo_torch.engine.continuous import ContinuousEngine

    geo = dict(ENGINE_GEOMETRY)
    for name, value in (("seg_len", seg_len), ("qlen", qlen),
                        ("max_admit_group", max_admit_group)):
        if value is not None:
            geo[name] = value
    return ContinuousEngine(
        model, sampling, lora=lora, lora_scaling=lora_scaling,
        max_batch=slots, kv_bits=kv_bits, generator=generator, spec_k=spec_k,
        spec_draft=spec_draft, collect_spec_stats=collect_spec_stats,
        head_bits=head_bits, **geo)
