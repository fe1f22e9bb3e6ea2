"""Pluggable providers, the counterpart of ``fvd_tpu/providers/``.  So far it
holds only the program coalescer (``coalesce.py``); the ``Providers`` bundle
comes with its first user, the V1 node."""
