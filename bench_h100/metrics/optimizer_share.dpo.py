"""AdamW's (span ``adamw.apply``: the global norm, the clip's host read,
the per-leaf update) share of the DPO window."""

from bench_h100 import program_spans

read = program_spans.span_share("dpo", ("adamw.apply",))
