"""The scoring pass's (``rollout_score``) share of the DPO window."""

from bench_h100 import readers

read = readers.span_share("dpo", "rollout_score")
