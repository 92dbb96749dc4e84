"""Traffic modules, one per ``generator`` that traffic files name."""
