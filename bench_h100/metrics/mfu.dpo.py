"""The DPO step's share of the card's peak."""

from bench_h100 import readers

read = readers.mfu("dpo")
