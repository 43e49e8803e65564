from vega_tpu_torch.parallel.batch import BatchedLikelihood  # noqa: F401
