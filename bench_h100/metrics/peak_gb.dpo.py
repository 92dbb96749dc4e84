"""The program's peak device memory through the DPO steps."""

from bench_h100 import readers

read = readers.peak_gb("dpo")
