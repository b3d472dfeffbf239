"""Offline statistical analysis (reblocking, extraction): the port's copy
of ``pauxy_tpu/analysis``."""
