"""The device's idle share of the DPO window inside the program's steps
(the host intervals of the spans ``dpo.score`` and ``dpo.step``); the rest
of ``idle_share.dpo`` is the harness between steps."""

from bench_h100 import program_spans

read = program_spans.idle_within("dpo", ("dpo.score", "dpo.step"))
