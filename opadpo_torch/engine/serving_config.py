"""The one constructor of the serving sampling configuration: port of
``opadpo_tpu/engine/serving_config.make_serving_sampling``."""

from __future__ import annotations

from opadpo_torch.engine.sampling import SamplingConfig

# Rollout sampling recipe (reference run/online_generate.sh:75-77,115-116),
# also the serving default.
SERVING_TEMPERATURE = 1.0
SERVING_TOP_K = 30
SERVING_TOP_P = 0.95


def make_serving_sampling(
    *,
    max_new_tokens: int = 512,
    eos_token_id: int = 2,
    pad_token_id: int = 0,
    temperature: float = SERVING_TEMPERATURE,
    top_k: int = SERVING_TOP_K,
    top_p: float = SERVING_TOP_P,
    greedy: bool = False,
) -> SamplingConfig:
    return SamplingConfig(
        temperature=temperature, top_k=top_k, top_p=top_p, greedy=greedy,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id,
        max_new_tokens=max_new_tokens)
