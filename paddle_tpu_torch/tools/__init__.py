"""Scripts that measure or stress the port's kernels on the card; each
runs as ``python -m paddle_tpu_torch.tools.<name>``."""
