"""The policy backward's (span ``dpo.backward``, with its recompute) share
of the DPO window."""

from bench_h100 import program_spans

read = program_spans.span_share("dpo", ("dpo.backward",))
