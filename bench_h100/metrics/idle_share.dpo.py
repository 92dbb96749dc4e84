"""The device's idle share of the DPO window."""

from bench_h100 import readers

read = readers.idle_share("dpo")
