"""CPU tests of the benchmark (python -m pytest gpbench/tests)."""
