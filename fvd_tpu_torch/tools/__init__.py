"""Command-line tools of the port, run as ``python -m fvd_tpu_torch.tools.<name>``
(the counterparts of the JAX package's ``tools/*.py``)."""
