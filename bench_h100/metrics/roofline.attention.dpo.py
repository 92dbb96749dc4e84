"""Attention's share of its roofline in the DPO window (kernels #1-#5 or a
library's)."""

from bench_h100 import readers

read = readers.roofline("dpo", "attention", "bf16")
