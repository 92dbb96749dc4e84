"""Remat's recompute inside the backward (spans ``remat.layer``: decoder
layers, ``remat.head``: the f32 readout chunks) as a share of the DPO
window."""

from bench_h100 import program_spans

read = program_spans.span_share("dpo", ("remat.layer", "remat.head"))
