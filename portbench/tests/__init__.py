"""CPU tests of the benchmark (and its controls, on a card)."""
