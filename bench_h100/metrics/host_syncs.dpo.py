"""Host reads of a device value on the DPO step's path (counter
``host_syncs``) per step (span ``dpo.step``)."""

from bench_h100 import program_spans

read = program_spans.per_span("dpo", "host_syncs", "dpo.step")
