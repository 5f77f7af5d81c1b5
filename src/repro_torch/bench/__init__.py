"""The launcher benches of the port: the twins of the reference's
`benchmarks/kernel_bench.py` and `benchmarks/serve_bench.py`, timed on the
card (`timing`), run as `python -m repro_torch.bench.<name>`."""
