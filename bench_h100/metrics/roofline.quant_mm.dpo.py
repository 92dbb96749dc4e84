"""The int8 products' share of their roofline in the DPO window (w8a8
forward and the int8 dx: #9, #10, int8 GEMMs)."""

from bench_h100 import readers

read = readers.roofline("dpo", "quant_mm", "int8")
