"""The port's benchmark on the H100: ``python3 -m bench_h100.run``."""
