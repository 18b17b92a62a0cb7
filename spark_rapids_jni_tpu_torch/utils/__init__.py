"""Shared utilities of the port: the flag plane (``config``) and the
metrics counters (``metrics``)."""
