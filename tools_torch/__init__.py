"""Command-line tools of the PyTorch/H100 port (htd_tpu_torch), after the
JAX package's `tools/`: train, test, offline evaluation, error analysis,
publishing, config and log inspection. Each tool's `main(argv=None)`
returns what it printed, so that tests and `chip_smoke.py` call it in
process."""
