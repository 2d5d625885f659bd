"""The port's command-line tools, one module per JAX `tools/` CLI; each runs
as `python -m yololite_tpu_torch.tools.<name>` and exposes `main(argv=None)`."""
