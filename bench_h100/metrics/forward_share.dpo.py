"""The policy forwards' (span ``dpo.forward``) share of the DPO window."""

from bench_h100 import program_spans

read = program_spans.span_share("dpo", ("dpo.forward",))
